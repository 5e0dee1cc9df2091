"""Imaging weights: uniform and Briggs (robust).

Counterpart of ska_sdp_func_tpu.visibility.weighting (reference
visibility/sdp_weighting.{h,cpp,cu}). Two passes over a uv grid of
accumulated input weights:

1. grid write: ``grid[idx_u, idx_v, pol] += input_weight`` with
   ``idx = floor(u * inv_wavelength / max_abs_uv * half_grid) + half_grid``
   (weights_grid_write, sdp_weighting.cpp:19-76), one ``index_add_``;
2. read-back: uniform ``w = 1 / grid_cell``
   (uniform_weights_grid_read, :149-207); Briggs
   ``w = w_in / (1 + robustness * grid_cell)`` with
   ``robustness = (5 * 10^-R)^2 / (sum grid^2 / sum grid)``, the sums over
   *visits* (per visibility sample), not unique cells (sum_weights_calc
   :79-135, robustness_calc :138-147), accumulated in f64 on every device.

The grid write is a float scatter-add: on the card its order, and so the
last bits of a cell, may change from run to run. The entry points run on
``device`` (None: the CUDA card) and move their inputs there.
"""

from typing import Tuple

import torch

from ..utility.constants import C_0
from ..utility.data_model import check_uvw, check_weights
from ..utility.errors import SdpShapeError
from ..utility.tensors import divide, on_device, times_inverse


def get_uv_range(uvw, freq_hz) -> float:
    """Max absolute u coordinate in wavelengths at the top frequency (the
    reference's Python helper, weighting.py:41-60). Only |u| is read, as
    there. Computed where ``uvw`` lies (NumPy: the host)."""
    uvw = torch.as_tensor(uvw)
    if uvw.ndim != 3 or uvw.shape[-1] != 3:
        raise SdpShapeError(
            f"get_uv_range: uvw must be [time, baseline, 3]; got "
            f"{tuple(uvw.shape)}")
    max_abs_uv = float(uvw[:, :, 0:1].abs().max())
    return max_abs_uv * float(freq_hz[-1]) / C_0


def _grid_indices(uvw, freq_hz, max_abs_uv: float, grid_size: int):
    """idx_u / idx_v [T, B, C] and their validity mask, in the JAX
    package's arithmetic (its ``jit`` multiplies by 1 / C_0 and divides by
    the traced ``max_abs_uv``), so the card and the CPU pick the same
    cells."""
    half = grid_size // 2
    inv_wave = times_inverse(freq_hz, C_0)       # [C]
    gu = uvw[:, :, 0:1] * inv_wave[None, None, :]
    gv = uvw[:, :, 1:2] * inv_wave[None, None, :]
    idx_u = torch.floor(divide(gu, max_abs_uv) * half).to(torch.int32) + half
    idx_v = torch.floor(divide(gv, max_abs_uv) * half).to(torch.int32) + half
    ok = ((idx_u >= 0) & (idx_u < grid_size)
          & (idx_v >= 0) & (idx_v < grid_size))
    return idx_u, idx_v, ok


def _grid_write(uvw, freq_hz, max_abs_uv, input_weights, grid_size: int):
    """The weight grid ``[grid, grid, pols]`` and the samples' cells
    ``[T, B, C, pols]`` (zero where a sample falls off the grid)."""
    num_pols = input_weights.shape[3]
    idx_u, idx_v, ok = _grid_indices(uvw, freq_hz, max_abs_uv, grid_size)
    zero = torch.zeros((), dtype=input_weights.dtype,
                       device=input_weights.device)
    contrib = torch.where(ok[..., None], input_weights, zero)
    cell = (torch.where(ok, idx_u, 0).to(torch.int64) * grid_size
            + torch.where(ok, idx_v, 0))                 # [T, B, C]
    grid = torch.zeros((grid_size * grid_size, num_pols),
                       dtype=input_weights.dtype,
                       device=input_weights.device)
    grid.index_add_(0, cell.reshape(-1), contrib.reshape(-1, num_pols))
    cells = grid[cell]
    return grid.reshape(grid_size, grid_size, num_pols), cells, ok, zero


def _prepare(uvw, freq_hz, input_weights, max_abs_uv, grid_size, device):
    uvw, freq_hz, input_weights = on_device(uvw, freq_hz, input_weights,
                                            device=device)
    check_uvw(uvw)
    check_weights(input_weights)
    if grid_size is None:
        grid_size = int(2 * (int(max_abs_uv) + 1))
    return uvw, freq_hz, input_weights, int(grid_size)


def uniform_weights(uvw, freq_hz, max_abs_uv: float, input_weights,
                    grid_size: int = None,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform weighting: weight = 1 / (uv-cell hit weight).

    `sdp_weighting_uniform` (sdp_weighting.h:59-70); returns
    ``(weights_grid_uv [grid, grid, pols], output_weights)``.
    ``grid_size`` defaults to 2 * ceil(max_abs_uv), as in the JAX package;
    pass it explicitly for parity tests.
    """
    uvw, freq_hz, input_weights, grid_size = _prepare(
        uvw, freq_hz, input_weights, max_abs_uv, grid_size, device)
    grid, cells, ok, zero = _grid_write(uvw, freq_hz, float(max_abs_uv),
                                        input_weights, grid_size)
    return grid, torch.where(ok[..., None], 1.0 / cells, zero)


def briggs_weights(uvw, freq_hz, max_abs_uv: float, robust_param: float,
                   input_weights, grid_size: int = None,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Briggs / robust weighting, `sdp_weighting_briggs`
    (sdp_weighting.h:72-78): ``w = w_in / (1 + robustness * grid_cell)``.
    Returns ``(weights_grid_uv, output_weights)``."""
    uvw, freq_hz, input_weights, grid_size = _prepare(
        uvw, freq_hz, input_weights, max_abs_uv, grid_size, device)
    grid, cells, ok, zero = _grid_write(uvw, freq_hz, float(max_abs_uv),
                                        input_weights, grid_size)
    visited = torch.where(ok[..., None], cells, zero).to(torch.float64)
    sumweight = torch.sum(visited)
    sumweight2 = torch.sum(visited * visited)
    numerator = (5.0 * 10.0 ** (-float(robust_param))) ** 2
    robustness = (numerator / (sumweight2 / sumweight)).to(cells.dtype)
    out = torch.where(ok[..., None],
                      input_weights / (1.0 + robustness * cells), zero)
    return grid, out
