"""Gridder helpers: elementwise array algebra, the w-tower stack shift,
sub-grid add and cut-out with wrap-around, scaled uvw bounds, image <->
component lists, the w-step choice and the direct Fourier transforms.

Counterpart of ska_sdp_func_tpu.grid_data.gridder_utils (reference
sdp_gridder_utils.{h,cpp}). The array helpers and the offset forms
:func:`subgrid_add` / :func:`subgrid_cut_out` return new tensors, as in
the JAX package, and take NumPy input as it does: copied to ``device``
(None: the CUDA card), while a tensor keeps its device
(:func:`..utility.tensors.as_tensors`); the static forms take plan
constants (Python ints), decompose the wrap-around into at most four
contiguous slice copies, and :func:`subgrid_add_static` adds in place.
:func:`image_lmn`, :func:`dft` and :func:`idft` run on ``device`` (None:
the CUDA card) and move their inputs there; :func:`image_to_flmn`,
:func:`count_nonzero_pixels` and :func:`determine_w_step` work on the
host, where the output's size depends on the data.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError, SdpShapeError
from ..utility.tensors import as_tensors, on_device, times_inverse
from .kernels import lm_to_n


def _check_uvw_rows(uvws, fn: str) -> None:
    """Row-form uvw contract ``float[n, 3]`` (the sub-grid helpers take
    flattened rows, not the [time, baseline, 3] data-model form)."""
    if uvws.ndim != 2 or uvws.shape[-1] != 3:
        raise SdpShapeError(
            f"{fn}: uvws must be [n, 3]; got {tuple(uvws.shape)}")
    if not uvws.is_floating_point():
        raise SdpInvalidArgumentError(
            f"{fn}: uvws must be float; got {uvws.dtype}")


def _pow_int(base: torch.Tensor, exponent):
    """``base ** exponent`` with the reference's 0/1 fast paths
    (sdp_gridder_utils.h:22-46); an integer power by repeated squaring,
    as XLA expands ``integer_pow``."""
    if not isinstance(exponent, int):
        return base ** exponent
    if exponent == 0:
        return torch.ones_like(base)
    n, x, acc = abs(exponent), base, None
    while n:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc if exponent > 0 else 1 / acc


def accumulate_scaled_arrays(out, in1, in2=None, exponent=0,
                             device=None) -> torch.Tensor:
    """``out + in1 * in2 ** exponent``; ``in2`` is ignored at exponent 0
    (`sdp_gridder_accumulate_scaled_arrays`, sdp_gridder_utils.h:40-46).
    A real ``out`` takes the real part of a complex product (the
    reference's complex -> real store)."""
    out, in1 = as_tensors(out, in1, device=device)
    if in2 is None or (isinstance(exponent, int) and exponent == 0):
        term = in1
    else:
        (in2,) = as_tensors(in2, device=out.device)
        term = in1 * _pow_int(in2, exponent)
    if not out.is_complex() and term.is_complex():
        term = term.real
    return out + term.to(out.dtype)


def scale_inv_array(in1, in2, exponent=1, device=None) -> torch.Tensor:
    """``in1 / in2 ** exponent`` (`sdp_gridder_scale_inv_array`,
    sdp_gridder_utils.h:296-302)."""
    in1, in2 = as_tensors(in1, in2, device=device)
    return in1 / _pow_int(in2, exponent)


def _same_shape(a, b) -> None:
    if tuple(a.shape) != tuple(b.shape):
        raise SdpShapeError(
            f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")


def residual(a, b, device=None) -> torch.Tensor:
    """Elementwise ``a - b`` (`sdp_gridder_residual`)."""
    a, b = as_tensors(a, b, device=device)
    _same_shape(a, b)
    return a - b


def rms_diff(a, b, device=None) -> torch.Tensor:
    """RMS of ``a - b`` (`sdp_gridder_rms_diff`)."""
    a, b = as_tensors(a, b, device=device)
    _same_shape(a, b)
    return torch.sqrt(torch.mean((a - b).abs() ** 2))


def sum_diff(a, b, start_row: int = 0, end_row: Optional[int] = None,
             device=None) -> torch.Tensor:
    """``sum(a - b)`` over rows [start_row, end_row) in int64
    (`sdp_gridder_sum_diff`, sdp_gridder_utils.h:358-365)."""
    a, b = as_tensors(a, b, device=device)
    if end_row is None:
        end_row = a.shape[0]
    return torch.sum(a[start_row:end_row].to(torch.int64)
                     - b[start_row:end_row].to(torch.int64))


def shift_subgrids(subgrids, device=None) -> torch.Tensor:
    """Shift the w-tower stack down one plane: ``out[:-1] = in[1:]``,
    the last plane left as it was (`sdp_gridder_shift_subgrids`,
    sdp_gridder_utils.cpp:529-550). Returns a new tensor."""
    (subgrids,) = as_tensors(subgrids, device=device)
    return torch.cat([subgrids[1:], subgrids[-1:]], dim=0)


def _wrap_index(sub: int, n: int, offset: int, device) -> torch.Tensor:
    return (torch.arange(sub, device=device) + n // 2 - sub // 2
            + int(offset)) % n


def subgrid_add(grid, offset_u: int, offset_v: int, subgrid, factor=1.0,
                device=None) -> torch.Tensor:
    """``grid`` plus ``subgrid * factor`` with wrap-around indexing
    (`sdp_gridder_subgrid_add`, sdp_gridder_utils.cpp:553-600): sub-grid
    pixel (i, j) lands on grid pixel ``(i + G/2 - S/2 - offset_u) mod G``
    (the minus is the reverse of :func:`subgrid_cut_out`). Returns a new
    tensor."""
    grid, subgrid = as_tensors(grid, subgrid, device=device)
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


def subgrid_cut_out(grid, offset_u: int, offset_v: int,
                    subgrid_size: int, device=None) -> torch.Tensor:
    """The ``subgrid_size``-square block centred at (+offset_u,
    +offset_v) relative to the grid centre, with wrap-around
    (`sdp_gridder_subgrid_cut_out`, sdp_gridder_utils.cpp:603-650)."""
    (grid,) = as_tensors(grid, device=device)
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
    _check_uvw_rows(uvws, "uvw_bounds_all")
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


# ---------------------------------------------------------------------------
# Image <-> component list
# ---------------------------------------------------------------------------

def image_lmn(image_shape: Tuple[int, int], theta: float,
              shear_u: float = 0.0, shear_v: float = 0.0,
              device=None) -> torch.Tensor:
    """(l, m, n) of every pixel, row-major, ``[size_l * size_m, 3]`` f64
    on ``device`` (the full-image form of `sdp_gridder_image_to_flmn`,
    sdp_gridder_utils.cpp:317-382): ``l = (il - size_l//2) * theta /
    size_l``."""
    size_l, size_m = image_shape
    (il, im) = on_device(np.arange(size_l) - size_l // 2,
                         np.arange(size_m) - size_m // 2, device=device)
    l = il.to(torch.float64) * (theta / size_l)
    m = im.to(torch.float64) * (theta / size_m)
    ll, mm = torch.meshgrid(l, m, indexing="ij")
    nn = lm_to_n(ll, mm, shear_u, shear_v)
    return torch.stack([ll.reshape(-1), mm.reshape(-1), nn.reshape(-1)],
                       dim=-1)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def count_nonzero_pixels(image) -> int:
    """Number of non-zero pixels (`sdp_gridder_count_nonzero_pixels`)."""
    return int(np.count_nonzero(_host(image)))


def image_to_flmn(image, theta: float, shear_u: float = 0.0,
                  shear_v: float = 0.0, image_taper_1d=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(flux, lmn) of every non-zero pixel, on the host (dynamic size):
    `sdp_gridder_image_to_flmn` with flux output
    (sdp_gridder_utils.cpp:317-382). Returns NumPy ``(flux[k], lmn[k,
    3])``; the flux includes the separable taper when one is given."""
    img = _host(image)
    size_l, size_m = img.shape
    il, im = np.nonzero(img)
    l = (il - size_l // 2) * theta / size_l
    m = (im - size_m // 2) * theta / size_m
    flux = np.real(img[il, im])
    if image_taper_1d is not None:
        taper = _host(image_taper_1d)
        flux = flux * taper[il] * taper[im]
    n = np.asarray(lm_to_n(l, m, shear_u, shear_v))
    return flux, np.stack([l, m, n], axis=-1)


def determine_w_step(theta: float, fov: float, shear_u: float = 0.0,
                     shear_v: float = 0.0, x0: float = 0.0) -> float:
    """The w-plane spacing (`sdp_gridder_determine_w_step`,
    sdp_gridder_utils.cpp:1016-1040): 1 / theta_n, theta_n the image's
    extent along n scaled by x0 (default fov / theta)."""
    if x0 == 0.0:
        x0 = fov / theta
    corners = [lm_to_n(sl * fov / 2.0, sm * fov / 2.0, shear_u, shear_v)
               for sl, sm in ((-1, -1), (1, -1), (-1, 1), (1, 1))]
    fov_n = 2.0 * -min(corners)
    return 1.0 / (fov_n / x0)


# ---------------------------------------------------------------------------
# Direct Fourier transforms (accuracy oracles and predict primitives)
# ---------------------------------------------------------------------------

def _offsets_and_active(uvws, start_chs, end_chs, subgrid_offset_u,
                        subgrid_offset_v, subgrid_offset_w, theta, w_step,
                        active_dtype):
    du = dv = dw = 0.0
    if theta > 0:
        du = subgrid_offset_u / theta
        dv = subgrid_offset_v / theta
        dw = subgrid_offset_w * w_step
    dtype = torch.promote_types(uvws.dtype, torch.float32)
    offsets = torch.tensor([du, dv, dw], dtype=dtype, device=uvws.device)
    if start_chs is None or end_chs is None:
        active = torch.ones((uvws.shape[0],), dtype=active_dtype,
                            device=uvws.device)
    else:
        start_chs, end_chs = on_device(start_chs, end_chs,
                                       device=uvws.device)
        active = (start_chs < end_chs).to(active_dtype)
    return dtype, offsets, active


# The direct transforms materialise a [rows, channels, components] phase
# and phasor. They take rows in chunks of at most _DFT_CHUNK elements:
# 2^24 elements hold the complex128 phasor in 256 MiB, and its f64 phase,
# cosine and sine in as much again, so a chunk needs about 0.8 GiB. At the
# bench task's width (a 64^2 sub-grid's 4096 pixels x 64 channels) that is
# 64 rows a chunk: few enough launches that the card stays busy, far
# below the gigabytes a whole task's rows would take at once.
_DFT_CHUNK = 1 << 24


def _row_chunks(num_rows: int, per_row: int):
    """Row slices of at most ``_DFT_CHUNK`` elements (at least one row,
    and one empty slice for no rows)."""
    step = max(1, _DFT_CHUNK // max(1, per_row))
    for start in range(0, max(num_rows, 1), step):
        yield slice(start, start + step)


def _uvw_scaled(uvws, offsets, freq0_hz, dfreq_hz, num_chan, dtype):
    """``uvw[r, k] * inv_wave[c] - offsets[k]``, ``[rows, chan, 3]``."""
    chan = torch.arange(num_chan, dtype=dtype, device=uvws.device)
    inv_wave = times_inverse(freq0_hz + dfreq_hz * chan, C_0)
    return (uvws.to(dtype)[:, None, :] * inv_wave[None, :, None]
            - offsets[None, None, :])


def dft(uvws, flux, lmn, start_chs=None, end_chs=None,
        subgrid_offset_u: int = 0, subgrid_offset_v: int = 0,
        subgrid_offset_w: int = 0, theta: float = 0.0, w_step: float = 0.0,
        freq0_hz: float = C_0, dfreq_hz: float = 0.0,
        num_chan: int = 1, vis=None, device=None) -> torch.Tensor:
    """Point-source DFT prediction on ``device`` (None: the CUDA card;
    `sdp_gridder_dft`, sdp_gridder_utils.cpp:126-211):

        vis[r, c] += sum_s flux[s] exp(-2 pi i (l u + m v + n w))

    with u = uvw[r, 0] * (freq_c / C0) - subgrid_offset_u / theta, etc.
    Rows whose channel range is empty contribute zero. Returns the
    visibilities (``vis + contribution`` when ``vis`` is given).
    """
    uvws, flux, lmn, vis = on_device(uvws, flux, lmn, vis, device=device)
    _check_uvw_rows(uvws, "dft")
    if lmn.ndim != 2 or lmn.shape[-1] != 3:
        raise SdpShapeError(
            f"dft: lmn must be [sources, 3]; got {tuple(lmn.shape)}")
    if flux.shape[0] != lmn.shape[0]:
        raise SdpShapeError(
            f"dft: flux ({flux.shape[0]}) and lmn ({lmn.shape[0]}) "
            "source counts differ")
    if vis is not None:
        num_chan = vis.shape[1]
    dtype, offsets, active = _offsets_and_active(
        uvws, start_chs, end_chs, subgrid_offset_u, subgrid_offset_v,
        subgrid_offset_w, theta, w_step,
        torch.promote_types(uvws.dtype, torch.float32))
    lmn = lmn.to(dtype)
    parts = []
    for rows in _row_chunks(uvws.shape[0], int(num_chan) * lmn.shape[0]):
        uvw_scaled = _uvw_scaled(uvws[rows], offsets, freq0_hz, dfreq_hz,
                                 int(num_chan), dtype)
        phase = -2.0 * math.pi * torch.einsum("rck,sk->rcs", uvw_scaled,
                                              lmn)
        phasor = torch.complex(torch.cos(phase), torch.sin(phase))
        parts.append((phasor @ flux.to(phasor.dtype))
                     * active[rows, None])
    contribution = torch.cat(parts) if len(parts) > 1 else parts[0]
    if vis is not None:
        return vis + contribution.to(vis.dtype)
    return contribution


def idft(uvws, vis, lmn, start_chs=None, end_chs=None, image_taper_1d=None,
         subgrid_offset_u: int = 0, subgrid_offset_v: int = 0,
         subgrid_offset_w: int = 0, theta: float = 0.0, w_step: float = 0.0,
         freq0_hz: float = C_0, dfreq_hz: float = 0.0, image=None,
         image_shape: Optional[Tuple[int, int]] = None,
         device=None) -> torch.Tensor:
    """Direct-Fourier imaging on ``device`` (None: the CUDA card;
    `sdp_gridder_idft`, sdp_gridder_utils.cpp:215-314):

        image[p] += taper(p) * sum_{r,c} vis[r, c] exp(+2 pi i lmn_p . uvw)

    ``lmn`` holds one row per pixel (row-major; see :func:`image_lmn`).
    Returns the image (``image + result`` when ``image`` is given).
    """
    uvws, vis, lmn, image, image_taper_1d = on_device(
        uvws, vis, lmn, image, image_taper_1d, device=device)
    if image is not None:
        image_shape = tuple(image.shape)
    if image_shape is None:
        raise SdpInvalidArgumentError("image or image_shape required")
    dtype, offsets, active = _offsets_and_active(
        uvws, start_chs, end_chs, subgrid_offset_u, subgrid_offset_v,
        subgrid_offset_w, theta, w_step, vis.dtype)
    masked_vis = vis * active[:, None]
    lmn = lmn.to(dtype)
    flat = None
    for rows in _row_chunks(uvws.shape[0], vis.shape[1] * lmn.shape[0]):
        uvw_scaled = _uvw_scaled(uvws[rows], offsets, freq0_hz, dfreq_hz,
                                 vis.shape[1], dtype)
        phase = 2.0 * math.pi * torch.einsum("sk,rck->src", lmn,
                                             uvw_scaled)
        phasor = torch.complex(torch.cos(phase), torch.sin(phase))
        part = torch.einsum("src,rc->s", phasor, masked_vis[rows].to(
            torch.promote_types(phasor.dtype, vis.dtype)))
        flat = part if flat is None else flat + part
    result = flat.reshape(image_shape)
    if image_taper_1d is not None:
        result = result * image_taper_1d[:, None] * image_taper_1d[None, :]
    if image is not None:
        if image.is_complex():
            return image + result.to(image.dtype)
        return image + result.real.to(image.dtype)
    return result
