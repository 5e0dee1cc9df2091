"""Static-offset sub-grid add and cut-out with wrap-around.

Counterpart of the static forms in
ska_sdp_func_tpu.grid_data.gridder_utils (gridder_utils.py:167-220;
reference sdp_gridder_utils.cpp:603-650). Offsets are plan constants
(Python ints), so the wrap-around decomposes into at most four
contiguous slice copies per call.
"""

import torch


def _wrap_runs(start: int, size: int, n: int):
    """Contiguous runs covering indices (start + arange(size)) mod n.

    Returns (grid_start, sub_start, length) triples — at most two when
    size <= n.
    """
    start %= n
    runs = []
    pos = 0
    while pos < size:
        s = (start + pos) % n
        length = min(n - s, size - pos)
        runs.append((s, pos, length))
        pos += length
    return runs


def subgrid_add_static(grid: torch.Tensor, offset_u: int, offset_v: int,
                       subgrid: torch.Tensor, factor=1.0) -> torch.Tensor:
    """Add ``subgrid * factor`` into ``grid`` centred at
    (-offset_u, -offset_v) relative to the grid centre, with wrap-around.

    JAX's functional ``.at[].add`` becomes an in-place slice ``+=`` on
    ``grid``, which is also returned; callers pass a tensor they own
    (the packed driver's freshly zeroed per-plane grids).
    """
    su, sv = subgrid.shape
    gu, gv = grid.shape
    contrib = (subgrid * factor).to(grid.dtype)
    runs_u = _wrap_runs(gu // 2 - su // 2 - int(offset_u), su, gu)
    runs_v = _wrap_runs(gv // 2 - sv // 2 - int(offset_v), sv, gv)
    for gs_u, ss_u, lu in runs_u:
        for gs_v, ss_v, lv in runs_v:
            grid[gs_u:gs_u + lu, gs_v:gs_v + lv] += \
                contrib[ss_u:ss_u + lu, ss_v:ss_v + lv]
    return grid


def subgrid_cut_out_static(grid: torch.Tensor, offset_u: int, offset_v: int,
                           subgrid_size: int) -> torch.Tensor:
    """The ``subgrid_size``-square block centred at (+offset_u,
    +offset_v) relative to the grid centre, with wrap-around."""
    gu, gv = grid.shape
    su = sv = subgrid_size
    runs_u = _wrap_runs(gu // 2 - su // 2 + int(offset_u), su, gu)
    runs_v = _wrap_runs(gv // 2 - sv // 2 + int(offset_v), sv, gv)
    rows = torch.cat([grid[gs:gs + lu, :] for gs, _, lu in runs_u], dim=0)
    return torch.cat([rows[:, gs:gs + lv] for gs, _, lv in runs_v], dim=1)
