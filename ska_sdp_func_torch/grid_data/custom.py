"""Legacy custom degridder from a 5-D grid with supplied kernels.

Counterpart of ska_sdp_func_tpu.grid_data.custom (reference
grid_data/sdp_degrid_uvw_custom.{h,cpp,cu}): degrids
``vis[time, baseline, chan, pol]`` from a grid ``[chan, w, v, u, pol]``
with caller-supplied oversampled uv and w kernels, snapping coordinates
as `calculate_coordinates` does (sdp_degrid_uvw_custom.cpp:22-63): the
kernel row is mirrored (``oversample - 1 - (i % oversample)``) and the w
coordinate is offset by one wstep. Rounding is half to even and integer
division floors, as in the JAX package.

The JAX version gathers every tap ``[T, B, C, Z, ks, ks, P]`` at once
(8.6 GB of complex64 at 64 x 256 x 64 samples, 4 w planes, support 8, 4
pols). Here the taps are gathered one (v, u) pair at a time, as rows of
the grid laid out ``[C, V, U, W * P]``, and contracted into the sum as
they come, over rows in chunks: every visibility sees the same
operations in the same order whatever the chunk.
"""

import torch

from ..utility.constants import C_0
from ..utility.data_model import check_uvw
from ..utility.errors import SdpShapeError
from ..utility.tensors import divide, on_device, times_inverse

# Visibilities (time x baseline x channel) a chunk: with 4 w planes and 4
# pols a gathered tap row is 16 complex values, so at 2^21 points each of
# a chunk's four live [points, w, pol] tensors (a gathered tap, a product
# and the two partial sums) takes 256 MiB of complex64: about 1 GiB in
# all, whatever the grid's size.
_POINTS_PER_CHUNK = 1 << 21


def _snap(coord, size: int, oversample: int, theta: float):
    """(home cell, mirrored kernel row) of a uv coordinate."""
    i = torch.round(theta * coord * oversample).to(torch.int64) \
        + (size // 2 + 1) * oversample - 1
    home = torch.div(i, oversample, rounding_mode="floor")
    return home, oversample - 1 - torch.remainder(i, oversample)


def _degrid_rows(grid_rows, shape, uvw, uv_kernel, w_kernel, theta, wstep,
                 channel_start_hz, channel_step_hz):
    """Visibilities ``[rows, C, P]`` of ``uvw [rows, 3]`` from the grid's
    tap rows ``[C * V * U, Z * P]``."""
    num_chan, z_size, y_size, x_size, num_pols = shape
    uv_os, uv_k_size = uv_kernel.shape
    w_os = w_kernel.shape[0]
    half = uv_k_size // 2
    chan = torch.arange(num_chan, dtype=uvw.dtype, device=uvw.device)
    inv_wave = times_inverse(channel_start_hz + chan * channel_step_hz, C_0)
    u = uvw[:, 0:1] * inv_wave                      # [rows, C]
    v = uvw[:, 1:2] * inv_wave
    w = uvw[:, 2:3] * inv_wave
    home_x, frac_x = _snap(u, x_size, uv_os, theta)
    home_y, frac_y = _snap(v, y_size, uv_os, theta)
    ioz = torch.round((1.0 + divide(w, wstep)) * w_os).to(torch.int64) \
        + w_os - 1
    frac_z = w_os - 1 - torch.remainder(ioz, w_os)
    ok = ((home_x > half) & (home_x < x_size - half)
          & (home_y > half) & (home_y < y_size - half))
    hx = home_x.clamp(half, x_size - half - 1) - half
    hy = home_y.clamp(half, y_size - half - 1) - half
    dtype = grid_rows.dtype
    ku = uv_kernel[frac_x].to(dtype)                # [rows, C, ks]
    kv = uv_kernel[frac_y].to(dtype)
    kw = w_kernel[frac_z].to(dtype)                 # [rows, C, Z]
    cells = torch.arange(num_chan, device=uvw.device) * y_size
    vis_z = None
    for ky in range(uv_k_size):
        row = (cells + hy + ky) * x_size + hx       # [rows, C]
        acc = None
        for kx in range(uv_k_size):
            taps = grid_rows[(row + kx).reshape(-1)].reshape(
                row.shape + (z_size, num_pols))
            term = ku[..., kx, None, None] * taps
            acc = term if acc is None else acc + term
        term = kv[..., ky, None, None] * acc
        vis_z = term if vis_z is None else vis_z + term
    vis = None
    for z in range(z_size):
        term = kw[..., z, None] * vis_z[..., z, :]
        vis = term if vis is None else vis + term
    return torch.where(ok[..., None], vis, torch.zeros((), dtype=dtype,
                                                        device=vis.device))


def degrid_uvw_custom(grid, uvw, uv_kernel, w_kernel, theta: float,
                      wstep: float, channel_start_hz: float,
                      channel_step_hz: float, conjugate: bool = False,
                      device=None) -> torch.Tensor:
    """Degrid visibilities from a 5-D grid with custom kernels, on
    ``device`` (``None``: the CUDA card; CPU runs pass ``device="cpu"``).

    Equivalent of `sdp_degrid_uvw_custom` (sdp_degrid_uvw_custom.h:15-44).

    :param grid: ``complex[chan, w, v, u, pol]``.
    :param uvw: ``float[time, baseline, 3]`` in metres.
    :param uv_kernel: ``float[oversampling, support]``.
    :param w_kernel: ``float[w_oversampling, w_support]``, ``w_support``
        equal to the grid's w planes.
    :returns: ``complex[time, baseline, chan, pol]``, the grid's dtype.
    """
    grid, uvw, uv_kernel, w_kernel = on_device(grid, uvw, uv_kernel,
                                               w_kernel, device=device)
    check_uvw(uvw)
    if grid.ndim != 5:
        raise SdpShapeError("grid must be 5D [chan, w, v, u, pol]")
    if uv_kernel.ndim != 2 or w_kernel.ndim != 2:
        raise SdpShapeError(
            "kernels must be 2D [oversampling, support]")
    num_chan, z_size, _, _, num_pols = grid.shape
    if w_kernel.shape[1] != z_size:
        raise SdpShapeError(
            f"w_kernel support {w_kernel.shape[1]} != grid w planes "
            f"{z_size}")
    num_times, num_baselines = uvw.shape[:2]
    grid_rows = grid.permute(0, 2, 3, 1, 4).reshape(-1, z_size * num_pols)
    rows = uvw.reshape(-1, 3)
    step = max(1, _POINTS_PER_CHUNK // max(1, num_chan))
    vis = torch.cat([
        _degrid_rows(grid_rows, grid.shape, rows[r:r + step], uv_kernel,
                     w_kernel, float(theta), float(wstep),
                     float(channel_start_hz), float(channel_step_hz))
        for r in range(0, max(rows.shape[0], 1), step)])
    vis = vis.reshape(num_times, num_baselines, num_chan, num_pols)
    return vis.conj().resolve_conj() if conjugate else vis
