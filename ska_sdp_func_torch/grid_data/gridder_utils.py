"""Gridder helpers: the w-tower stack shift, sub-grid add and cut-out
with wrap-around, and scaled uvw bounds.

Counterpart of ska_sdp_func_tpu.grid_data.gridder_utils
(gridder_utils.py:110-274; reference sdp_gridder_utils.cpp:529-720).
The offset forms :func:`subgrid_add` / :func:`subgrid_cut_out` return
new tensors, as in the JAX package; the static forms take plan
constants (Python ints), decompose the wrap-around into at most four
contiguous slice copies, and :func:`subgrid_add_static` adds in place.
"""

import torch

from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError, SdpShapeError


def shift_subgrids(subgrids: torch.Tensor) -> torch.Tensor:
    """Shift the w-tower stack down one plane: ``out[:-1] = in[1:]``,
    the last plane left as it was (`sdp_gridder_shift_subgrids`,
    sdp_gridder_utils.cpp:529-550). Returns a new tensor."""
    return torch.cat([subgrids[1:], subgrids[-1:]], dim=0)


def _wrap_index(sub: int, n: int, offset: int, device) -> torch.Tensor:
    return (torch.arange(sub, device=device) + n // 2 - sub // 2
            + int(offset)) % n


def subgrid_add(grid: torch.Tensor, offset_u: int, offset_v: int,
                subgrid: torch.Tensor, factor=1.0) -> torch.Tensor:
    """``grid`` plus ``subgrid * factor`` with wrap-around indexing
    (`sdp_gridder_subgrid_add`, sdp_gridder_utils.cpp:553-600): sub-grid
    pixel (i, j) lands on grid pixel ``(i + G/2 - S/2 - offset_u) mod G``
    (the minus is the reverse of :func:`subgrid_cut_out`). Returns a new
    tensor."""
    if grid.ndim != 2 or subgrid.ndim != 2:
        raise SdpShapeError("subgrid_add: grid and subgrid must be 2D")
    if subgrid.shape[0] > grid.shape[0] or subgrid.shape[1] > grid.shape[1]:
        raise SdpShapeError(
            f"subgrid_add: subgrid {tuple(subgrid.shape)} larger than grid "
            f"{tuple(grid.shape)}")
    iu = _wrap_index(subgrid.shape[0], grid.shape[0], -int(offset_u),
                     grid.device)
    iv = _wrap_index(subgrid.shape[1], grid.shape[1], -int(offset_v),
                     grid.device)
    contrib = (subgrid * factor).to(grid.dtype)
    return grid.index_put((iu[:, None], iv[None, :]), contrib,
                          accumulate=True)


def subgrid_cut_out(grid: torch.Tensor, offset_u: int, offset_v: int,
                    subgrid_size: int) -> torch.Tensor:
    """The ``subgrid_size``-square block centred at (+offset_u,
    +offset_v) relative to the grid centre, with wrap-around
    (`sdp_gridder_subgrid_cut_out`, sdp_gridder_utils.cpp:603-650)."""
    if grid.ndim != 2:
        raise SdpShapeError("subgrid_cut_out: grid must be 2D")
    if subgrid_size > min(grid.shape):
        raise SdpShapeError(
            f"subgrid_cut_out: subgrid_size {subgrid_size} larger than "
            f"grid {tuple(grid.shape)}")
    iu = _wrap_index(subgrid_size, grid.shape[0], offset_u, grid.device)
    iv = _wrap_index(subgrid_size, grid.shape[1], offset_v, grid.device)
    return grid[iu[:, None], iv[None, :]]


def uvw_bounds_all(uvws, freq0_hz, dfreq_hz, start_chs, end_chs):
    """Scaled (u, v, w) min/max over all rows and selected channels
    (`sdp_gridder_uvw_bounds_all`, sdp_gridder_utils.cpp:682-720): per
    row the channel end points bound the range; rows with an empty range
    are skipped. Returns ``(uvw_min [3], uvw_max [3])`` (+inf / -inf
    where no row is selected)."""
    uvws = torch.as_tensor(uvws)
    if uvws.ndim != 2 or uvws.shape[-1] != 3:
        raise SdpShapeError(
            f"uvw_bounds_all: uvws must be [n, 3]; got {tuple(uvws.shape)}")
    if not uvws.is_floating_point():
        raise SdpInvalidArgumentError(
            f"uvw_bounds_all: uvws must be float; got {uvws.dtype}")
    dtype = torch.promote_types(uvws.dtype, torch.float32)
    uvw = uvws.to(dtype)
    start_chs = torch.as_tensor(start_chs, device=uvw.device)
    end_chs = torch.as_tensor(end_chs, device=uvw.device)
    u0 = freq0_hz * uvw / C_0
    du = dfreq_hz * uvw / C_0
    at_start = u0 + start_chs.to(dtype)[:, None] * du
    at_end = u0 + (end_chs.to(dtype)[:, None] - 1.0) * du
    lo = torch.where(uvw >= 0, at_start, at_end)
    hi = torch.where(uvw >= 0, at_end, at_start)
    active = (start_chs < end_chs)[:, None]
    inf = torch.tensor(float("inf"), dtype=dtype, device=uvw.device)
    lo = torch.where(active, lo, inf)
    hi = torch.where(active, hi, -inf)
    return lo.min(dim=0).values, hi.max(dim=0).values


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
