"""W-towers sub-grid (de)gridder.

Counterpart of ska_sdp_func_tpu.grid_data.wtower (reference:
grid_data/sdp_gridder_wtower_uvw.{h,cpp,cu}). The plan
(:class:`GridderWtowerUVW`) holds the oversampled PSWF uv/w kernels and
the complex w-pattern; ``degrid_subgrid`` / ``grid_subgrid`` process one
sub-grid, with the reference's corrections and counters.

Two drivers per direction, chosen as the JAX package chooses them
(``_use_pallas``, wtower.py:56-60, with "CUDA" in place of "TPU"):

- complex64 on a CUDA device: the fused absolute-layer drivers
  (``_grid_all_planes_fused`` / ``_degrid_all_planes_fused``): one
  launch of the all-layer kernels (:func:`~..kernels.tower_tap.
  grid_all_layers`, :func:`~..kernels.tower_tap.degrid_all_layers`)
  over every visibility and tower layer, drained by one batched FFT and
  a w-pattern power ladder;
- otherwise the per-plane drivers (``_grid_all_planes`` /
  ``_degrid_all_planes``): a loop over w-planes with the rolling
  ``[w_support, N, N]`` tower stack (the reference's plane loop,
  sdp_gridder_wtower_uvw.cpp:854-899, 1023-1100). Each plane runs the
  per-plane kernels (:func:`~..kernels.tower_tap.grid_plane`,
  :func:`~..kernels.tower_tap.degrid_plane`) for complex64 on CUDA, and
  the dense banded products (:mod:`..kernels.dense_tap`) otherwise:
  complex128 anywhere, and every dtype on the CPU.

The fused drivers read the JAX package's switch
``SKA_SDP_FUNC_TPU_FAST_MXU`` at each call (wtower.py:684-687): when it
is set, the all-layer kernels run in their bf16 mode (``fast=True``), so
a pipeline that sets it gets the same mode in either package. The
per-plane drivers never take that mode, as in the JAX package.

All integer snapping follows the C (round half away from zero, floor
division of non-negative values). The dtype of the visibilities sets
the arithmetic. Each entry point takes ``device`` (``None``: the CUDA
card; CPU runs pass ``device="cpu"``) and moves its inputs there.
"""

import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..fourier_transforms.fft import fft_shifted, ifft_shifted
from ..kernels import tower_tap
from ..kernels.dense_tap import degrid_plane_dense, grid_plane_dense
from ..utility.constants import C_0
from ..utility.errors import (
    SdpDataTypeError,
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ..utility.tensors import resolve_device
from .clamp_channels import clamp_channels_inline
from .grid_correct import grid_correct_pswf, grid_correct_w_stack
from .gridder_utils import shift_subgrids, uvw_bounds_all
from .kernels import (
    eval_kernel_taps,
    kernel_tap_coeffs,
    make_pswf_kernel,
    make_w_pattern,
)


def _use_kernels(vis_dtype, device) -> bool:
    """The CUDA kernels run for complex64 data on a CUDA device."""
    return vis_dtype == torch.complex64 and torch.device(device).type == \
        "cuda"


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C round(): halves away from zero (torch.round is half-to-even)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def _complex_dtype(dtype):
    return torch.promote_types(dtype, torch.complex64)


def _tensor(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class GridderWtowerUVW:
    """Plan for w-towers / w-stacking uvw (de)gridding: the oversampled
    PSWF uv/w kernels (host f64), the complex w-pattern (host c128) and
    the processed-plane counters. Mirrors `sdp_gridder_wtower_uvw_create`
    (sdp_gridder_wtower_uvw.h:59-100)."""

    def __init__(self, image_size: int, subgrid_size: int, theta: float,
                 w_step: float, shear_u: float, shear_v: float,
                 support: int, oversampling: int, w_support: int,
                 w_oversampling: int):
        if subgrid_size % 2 != 0:
            # An odd sub-grid breaks the FFT shift
            # (sdp_gridder_wtower_uvw.cpp:674-682).
            raise SdpInvalidArgumentError(
                f"Subgrid size must be even (value given was {subgrid_size})."
            )
        self.image_size = int(image_size)
        self.subgrid_size = int(subgrid_size)
        self.theta = float(theta)
        self.w_step = float(w_step)
        self.shear_u = float(shear_u)
        self.shear_v = float(shear_v)
        self.support = int(support)
        self.oversampling = int(oversampling)
        self.w_support = int(w_support)
        self.w_oversampling = int(w_oversampling)
        self._num_w_planes = [0, 0]  # [degridding, gridding] counters

        self.uv_kernel = np.ascontiguousarray(
            make_pswf_kernel(self.support, self.support, self.oversampling))
        self.w_kernel = np.ascontiguousarray(
            make_pswf_kernel(self.w_support, self.w_support,
                             self.w_oversampling))
        # iDFT of a sole visibility at (0, 0, w_step).
        self.w_pattern = np.ascontiguousarray(
            make_w_pattern(self.subgrid_size, self.theta, self.shear_u,
                           self.shear_v, self.w_step))
        self._device_tables = {}

    def num_w_planes(self, gridding: int) -> int:
        """Processed w-plane counter (0: degridding, 1: gridding)."""
        if gridding in (0, 1):
            return self._num_w_planes[gridding]
        return 0

    def tables(self, dtype, device):
        """(uv_kernel, w_kernel, w_pattern) on ``device``: the kernels in
        the real precision of ``dtype`` (real or complex), the w-pattern
        complex128 (cached)."""
        real_dtype = torch.empty((), dtype=dtype).real.dtype
        key = (real_dtype, str(device))
        tabs = self._device_tables.get(key)
        if tabs is None:
            tabs = (torch.as_tensor(self.uv_kernel, device=device).to(
                        real_dtype),
                    torch.as_tensor(self.w_kernel, device=device).to(
                        real_dtype),
                    torch.as_tensor(self.w_pattern, device=device))
            self._device_tables[key] = tabs
        return tabs

    # -- geometry ---------------------------------------------------------
    def _w_plane_range(self, uvws, start_chs, end_chs, freq0_hz, dfreq_hz,
                       subgrid_offset_w: int) -> Tuple[int, int]:
        """[first_w_plane, last_w_plane] from the data bounds
        (sdp_gridder_wtower_uvw.cpp:780-800), one device->host read."""
        uvw_min, uvw_max = uvw_bounds_all(uvws, freq0_hz, dfreq_hz,
                                          start_chs, end_chs)
        bounds = torch.stack([uvw_min[2], uvw_max[2]]).cpu().double()
        c_min, c_max = float(bounds[0]), float(bounds[1])
        eta = 1e-5
        if not np.isfinite(c_min) or not np.isfinite(c_max):
            # No selected visibilities: a single (empty) plane.
            return -subgrid_offset_w, 1 - subgrid_offset_w
        first = int(np.floor(c_min / self.w_step - eta)) - subgrid_offset_w
        last = int(np.ceil(c_max / self.w_step + eta)) - subgrid_offset_w + 1
        return first, last

    def degrid_num_planes(self, uvws, start_chs, end_chs, freq0_hz,
                          dfreq_hz, subgrid_offset_w: int = 0,
                          device=None) -> int:
        device = resolve_device(device)
        first, last = self._w_plane_range(
            _tensor(uvws, device), _tensor(start_chs, device),
            _tensor(end_chs, device), freq0_hz, dfreq_hz or 10.0,
            subgrid_offset_w)
        return 1 + last - first

    grid_num_planes = degrid_num_planes

    def _check_inputs(self, uvws, subgrid_image=None, vis=None,
                      vis_required: bool = False) -> None:
        """Input contracts of the (de)gridding entry points
        (sdp_gridder_wtower_uvw.cpp:743-770)."""
        if uvws.ndim != 2 or uvws.shape[-1] != 3:
            raise SdpShapeError(
                f"uvws must be [num_rows, 3]; got {tuple(uvws.shape)}")
        if not uvws.is_floating_point():
            raise SdpDataTypeError(
                f"uvws must be real floating; got {uvws.dtype}")
        if subgrid_image is not None:
            shape = tuple(subgrid_image.shape)
            if shape != (self.subgrid_size, self.subgrid_size):
                raise SdpShapeError(
                    "subgrid image must be "
                    f"[{self.subgrid_size}, {self.subgrid_size}]; "
                    f"got {shape}")
        if vis_required and vis is not None and not vis.is_complex():
            raise SdpDataTypeError(f"vis must be complex; got {vis.dtype}")
        if vis is not None and vis.dtype == torch.complex128 \
                and uvws.dtype == torch.float32:
            # The reference supports (cf64, f64), (cf32, f64) and
            # (cf32, f32) (sdp_gridder_wtower_uvw.cpp:201-230).
            raise SdpDataTypeError(
                "complex128 vis with float32 uvws is unsupported "
                "(mixed-precision combos follow "
                "sdp_gridder_wtower_uvw.cpp:201-230)")

    # -- degrid -------------------------------------------------------------
    def degrid(self, subgrid_image, subgrid_offset_u: int,
               subgrid_offset_v: int, subgrid_offset_w: int,
               freq0_hz: float, dfreq_hz: float, uvws, start_chs, end_chs,
               vis, start_row: int = -1, end_row: int = -1, device=None):
        """Deprecated pre-1.2 signature; forwards to
        :meth:`degrid_subgrid` and returns the visibilities."""
        return self.degrid_subgrid(
            subgrid_image,
            (subgrid_offset_u, subgrid_offset_v, subgrid_offset_w),
            vis.shape[1], freq0_hz, dfreq_hz, uvws, start_chs, end_chs,
            vis, start_row, end_row, device=device)

    def degrid_subgrid(self, subgrid_image,
                       subgrid_offset: Tuple[int, int, int],
                       ch_count: int, freq0_hz: float, dfreq_hz: float,
                       uvws, start_chs, end_chs, vis=None,
                       start_row: int = -1, end_row: int = -1,
                       w_plane_range: Optional[Tuple[int, int]] = None,
                       device=None) -> torch.Tensor:
        """Degrid visibilities from one sub-grid image
        (`sdp_gridder_wtower_uvw_degrid`, sdp_gridder_wtower_uvw.cpp:
        726-909) on ``device`` (``None``: the CUDA card). Returns the
        visibilities (``vis +`` contribution when ``vis`` is given).
        ``w_plane_range`` (first, last) skips the bounds readback when
        the caller planned the tower already."""
        if dfreq_hz == 0.0:
            dfreq_hz = 10.0  # Prevent divide-by-zero (reference :744).
        off_u, off_v, off_w = (int(o) for o in subgrid_offset)
        device = resolve_device(device)
        uvws = _tensor(uvws, device)
        subgrid_image = _tensor(subgrid_image, device)
        vis = None if vis is None else _tensor(vis, device)
        self._check_inputs(uvws, subgrid_image=subgrid_image, vis=vis)
        start_chs = _tensor(start_chs, device)
        end_chs = _tensor(end_chs, device)
        if vis is None:
            vis = torch.zeros((uvws.shape[0], ch_count),
                              dtype=_complex_dtype(uvws.dtype),
                              device=device)
        num_rows = uvws.shape[0]
        if start_row < 0 or end_row < 0:
            start_row, end_row = 0, num_rows
        if w_plane_range is None:
            first, last = self._w_plane_range(
                uvws, start_chs, end_chs, freq0_hz, dfreq_hz, off_w)
        else:
            first, last = (int(w_plane_range[0]), int(w_plane_range[1]))
        num_planes = 1 + last - first
        self._num_w_planes[0] += num_planes
        uv_kernel, w_kernel, w_pattern = self.tables(vis.dtype, device)
        driver = (_degrid_all_planes_fused
                  if _use_kernels(vis.dtype, device) else _degrid_all_planes)
        return driver(
            subgrid_image.to(vis.dtype), w_pattern.to(vis.dtype), uv_kernel,
            w_kernel, uvws, start_chs, end_chs, vis, off_u, off_v, off_w,
            first, freq0_hz, dfreq_hz, num_planes, self.theta, self.w_step,
            self.support, self.oversampling, self.w_support,
            self.w_oversampling, self.subgrid_size, int(start_row),
            int(end_row))

    # -- grid ---------------------------------------------------------------
    def grid(self, vis, uvw, start_chs, end_chs, freq0_hz: float,
             dfreq_hz: float, subgrid_image, subgrid_offset_u: int,
             subgrid_offset_v: int, subgrid_offset_w: int,
             start_row: int = -1, end_row: int = -1, device=None):
        """Deprecated pre-1.2 signature; forwards to :meth:`grid_subgrid`
        and returns ``subgrid_image + contribution``."""
        return self.grid_subgrid(
            vis, uvw, start_chs, end_chs, vis.shape[1], freq0_hz, dfreq_hz,
            subgrid_image,
            (subgrid_offset_u, subgrid_offset_v, subgrid_offset_w),
            start_row, end_row, device=device)

    def grid_subgrid(self, vis, uvws, start_chs, end_chs, ch_count: int,
                     freq0_hz: float, dfreq_hz: float, subgrid_image,
                     subgrid_offset: Tuple[int, int, int],
                     start_row: int = -1, end_row: int = -1,
                     w_plane_range: Optional[Tuple[int, int]] = None,
                     device=None) -> torch.Tensor:
        """Grid visibilities onto one sub-grid image, the adjoint of
        :meth:`degrid_subgrid` (`sdp_gridder_wtower_uvw_grid`,
        sdp_gridder_wtower_uvw.cpp:935-1123), on ``device`` (``None``:
        the CUDA card). Returns ``subgrid_image + contribution``."""
        if dfreq_hz == 0.0:
            dfreq_hz = 10.0
        if ch_count and vis.shape[1] != ch_count:
            raise SdpInvalidArgumentError("Inconsistent channel dimensions")
        off_u, off_v, off_w = (int(o) for o in subgrid_offset)
        device = resolve_device(device)
        vis = _tensor(vis, device)
        uvws = _tensor(uvws, device)
        subgrid_image = _tensor(subgrid_image, device)
        self._check_inputs(uvws, subgrid_image=subgrid_image, vis=vis,
                           vis_required=True)
        start_chs = _tensor(start_chs, device)
        end_chs = _tensor(end_chs, device)
        num_rows = uvws.shape[0]
        if start_row < 0 or end_row < 0:
            start_row, end_row = 0, num_rows
        if w_plane_range is None:
            first, last = self._w_plane_range(
                uvws, start_chs, end_chs, freq0_hz, dfreq_hz, off_w)
        else:
            first, last = (int(w_plane_range[0]), int(w_plane_range[1]))
        num_planes = 1 + last - first
        self._num_w_planes[1] += num_planes
        # The running w image is complex double, as in the reference
        # (sdp_gridder_wtower_uvw.cpp:1008).
        uv_kernel, w_kernel, w_pattern = self.tables(vis.dtype, device)
        driver = (_grid_all_planes_fused
                  if _use_kernels(vis.dtype, device) else _grid_all_planes)
        return driver(
            vis, w_pattern, uv_kernel, w_kernel, uvws, start_chs, end_chs,
            subgrid_image, off_u, off_v, off_w, first, freq0_hz, dfreq_hz,
            num_planes, self.theta, self.w_step, self.support,
            self.oversampling, self.w_support, self.w_oversampling,
            self.subgrid_size, int(start_row), int(end_row))

    # -- corrections ---------------------------------------------------------
    def degrid_correct(self, facet: torch.Tensor, facet_offset_l: int = 0,
                       facet_offset_m: int = 0, w_offset: int = 0,
                       device=None) -> torch.Tensor:
        """Degrid correction (sdp_gridder_wtower_uvw_degrid_correct,
        sdp_gridder_wtower_uvw.cpp:912-932) on ``device`` (``None``: the
        CUDA card)."""
        facet = grid_correct_pswf(
            self.image_size, self.theta, self.w_step, self.shear_u,
            self.shear_v, self.support, self.w_support,
            _tensor(facet, resolve_device(device)), facet_offset_l,
            facet_offset_m)
        if facet.is_complex():
            facet = grid_correct_w_stack(
                self.image_size, self.theta, self.w_step, self.shear_u,
                self.shear_v, facet, facet_offset_l, facet_offset_m,
                w_offset, inverse=False)
        return facet

    def grid_correct(self, facet: torch.Tensor, facet_offset_l: int = 0,
                     facet_offset_m: int = 0, w_offset: int = 0,
                     device=None) -> torch.Tensor:
        """Grid correction (sdp_gridder_wtower_uvw_grid_correct,
        sdp_gridder_wtower_uvw.cpp:1126-1146) on ``device`` (``None``: the
        CUDA card)."""
        facet = grid_correct_pswf(
            self.image_size, self.theta, self.w_step, self.shear_u,
            self.shear_v, self.support, self.w_support,
            _tensor(facet, resolve_device(device)), facet_offset_l,
            facet_offset_m)
        if facet.is_complex():
            facet = grid_correct_w_stack(
                self.image_size, self.theta, self.w_step, self.shear_u,
                self.shear_v, facet, facet_offset_l, facet_offset_m,
                w_offset, inverse=True)
        return facet


@lru_cache(maxsize=16)
def _tap_coeffs_cached(support: int, oversampling: int):
    return kernel_tap_coeffs(support, support, oversampling)


# ---------------------------------------------------------------------------
# Per-plane geometry and drivers
# ---------------------------------------------------------------------------

def _scalar(x, dtype, device) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype, device=device)


def _plane_geometry(uvws, start_chs, end_chs, w_plane: int, off_u: int,
                    off_v: int, off_w: int, freq0_hz, dfreq_hz,
                    num_chan: int, theta: float, w_step: float,
                    support: int, oversampling: int, w_support: int,
                    w_oversampling: int, subgrid_size: int, start_row: int,
                    end_row: int):
    """Shared degrid/grid addressing (sdp_gridder_wtower_uvw.cpp:86-142).

    Returns (mask, iu0, iv0, u_row, v_row, w_row), each [R, C], with the
    indices clipped in bounds (masked entries carry mask False).
    """
    fdtype = uvws.dtype
    dev = uvws.device
    half_subgrid = subgrid_size // 2
    theta_ov = theta * oversampling
    w_step_ov = (1.0 / w_step) * w_oversampling
    half_sg_size_ov = (half_subgrid - support // 2 + 1) * oversampling

    w_coord = uvws[:, 2]
    min_w = _scalar(w_plane + off_w - 1, fdtype, dev) * w_step
    max_w = _scalar(w_plane + off_w, fdtype, dev) * w_step
    start_ch, end_ch = clamp_channels_inline(
        w_coord, freq0_hz, dfreq_hz, start_chs, end_chs, min_w, max_w)

    row_ids = torch.arange(uvws.shape[0], device=dev)
    row_active = ((row_ids >= start_row) & (row_ids < end_row)
                  & (start_ch < end_ch))

    uvw0 = uvws * (freq0_hz / C_0)
    duvw = uvws * (dfreq_hz / C_0)
    uvw0 = uvw0 - torch.stack([
        _scalar(off_u, fdtype, dev) / theta,
        _scalar(off_v, fdtype, dev) / theta,
        _scalar(off_w + w_plane - 1, fdtype, dev) * w_step])[None, :]

    # Row bounds check (reference :112-121).
    start_f = start_ch.to(fdtype)
    end1_f = (end_ch - 1).to(fdtype)
    u_min = torch.floor(theta * (uvw0[:, 0] + start_f * duvw[:, 0]))
    u_max = torch.ceil(theta * (uvw0[:, 0] + end1_f * duvw[:, 0]))
    v_min = torch.floor(theta * (uvw0[:, 1] + start_f * duvw[:, 1]))
    v_max = torch.ceil(theta * (uvw0[:, 1] + end1_f * duvw[:, 1]))
    row_active = row_active & ((u_min >= -half_subgrid)
                               & (u_max < half_subgrid)
                               & (v_min >= -half_subgrid)
                               & (v_max < half_subgrid))

    chan = torch.arange(num_chan, device=dev)
    mask = (row_active[:, None] & (chan[None, :] >= start_ch[:, None])
            & (chan[None, :] < end_ch[:, None]))

    chan_f = chan.to(fdtype)
    u = uvw0[:, 0:1] + chan_f[None, :] * duvw[:, 0:1]
    v = uvw0[:, 1:2] + chan_f[None, :] * duvw[:, 1:2]
    w = uvw0[:, 2:3] + chan_f[None, :] * duvw[:, 2:3]

    iu0_ov = _round_half_away(u * theta_ov).to(torch.int32) + half_sg_size_ov
    iv0_ov = _round_half_away(v * theta_ov).to(torch.int32) + half_sg_size_ov
    iw0_ov = _round_half_away(w * w_step_ov).to(torch.int32)

    iu0 = torch.div(iu0_ov, oversampling, rounding_mode="floor").clamp(
        0, subgrid_size - support)
    iv0 = torch.div(iv0_ov, oversampling, rounding_mode="floor").clamp(
        0, subgrid_size - support)
    return (mask, iu0, iv0, torch.remainder(iu0_ov, oversampling),
            torch.remainder(iv0_ov, oversampling),
            torch.remainder(iw0_ov, w_oversampling))


def _degrid_all_planes(subgrid_image, w_pattern, uv_kernel, w_kernel, uvws,
                       start_chs, end_chs, vis, off_u, off_v, off_w,
                       first_w_plane: int, freq0_hz, dfreq_hz,
                       num_planes: int, theta: float, w_step: float,
                       support: int, oversampling: int, w_support: int,
                       w_oversampling: int, subgrid_size: int,
                       start_row: int, end_row: int) -> torch.Tensor:
    """Per-plane degrid loop with the rolling tower stack."""
    num_chan = vis.shape[1]
    kernels = _use_kernels(subgrid_image.dtype, subgrid_image.device)

    # w_img = subgrid_image / w_pattern**(first - w_support // 2)
    w_img = subgrid_image / w_pattern ** float(first_w_plane
                                               - w_support // 2)
    layers = []
    for _ in range(w_support):
        layers.append(fft_shifted(w_img))
        w_img = w_img / w_pattern
    subgrids = torch.stack(layers)

    def plane_contrib(subgrids, w_plane):
        geom = _plane_geometry(
            uvws, start_chs, end_chs, w_plane, off_u, off_v, off_w,
            freq0_hz, dfreq_hz, num_chan, theta, w_step, support,
            oversampling, w_support, w_oversampling, subgrid_size,
            start_row, end_row)
        if kernels:
            return tower_tap.degrid_plane(subgrids, uv_kernel, w_kernel,
                                          geom, support, w_support)
        return degrid_plane_dense(subgrids, uv_kernel, w_kernel, geom,
                                  support, w_support)

    vis_acc = vis + plane_contrib(subgrids, first_w_plane).to(vis.dtype)
    for p in range(1, num_planes):
        subgrids = torch.cat([subgrids[1:], fft_shifted(w_img)[None]])
        w_img = w_img / w_pattern
        vis_acc = vis_acc + plane_contrib(subgrids,
                                          first_w_plane + p).to(vis.dtype)
    return vis_acc


def _grid_all_planes(vis, w_pattern, uv_kernel, w_kernel, uvws, start_chs,
                     end_chs, subgrid_image, off_u, off_v, off_w,
                     first_w_plane: int, freq0_hz, dfreq_hz,
                     num_planes: int, theta: float, w_step: float,
                     support: int, oversampling: int, w_support: int,
                     w_oversampling: int, subgrid_size: int, start_row: int,
                     end_row: int) -> torch.Tensor:
    """Per-plane grid loop with the rolling tower stack and the complex
    double running w image; returns ``subgrid_image + contribution``."""
    num_chan = vis.shape[1]
    dev = vis.device
    kernels = _use_kernels(vis.dtype, dev)
    w_img = torch.zeros((subgrid_size, subgrid_size), dtype=w_pattern.dtype,
                        device=dev)
    subgrids = torch.zeros((w_support, subgrid_size, subgrid_size),
                           dtype=vis.dtype, device=dev)

    def plane_scatter(subgrids, w_plane):
        geom = _plane_geometry(
            uvws, start_chs, end_chs, w_plane, off_u, off_v, off_w,
            freq0_hz, dfreq_hz, num_chan, theta, w_step, support,
            oversampling, w_support, w_oversampling, subgrid_size,
            start_row, end_row)
        if kernels:
            return tower_tap.grid_plane(subgrids, vis, uv_kernel, w_kernel,
                                        geom, support, w_support)
        return grid_plane_dense(subgrids, vis, uv_kernel, w_kernel, geom,
                                support, w_support)

    subgrids = plane_scatter(subgrids, first_w_plane)
    for p in range(1, num_planes):
        # Accumulate the bottom layer, shift, clear the top
        # (reference :1029-1059).
        w_img = w_img / w_pattern + ifft_shifted(subgrids[0]).to(
            w_img.dtype)
        subgrids = shift_subgrids(subgrids)
        subgrids[-1] = 0
        subgrids = plane_scatter(subgrids, first_w_plane + p)

    # Drain the remaining tower layers (reference :1077-1100).
    for layer in subgrids:
        w_img = w_img / w_pattern + ifft_shifted(layer).to(w_img.dtype)

    # The iFFT already carries the subgrid_size**2 factor
    # (reference :1102-1113).
    last_w_plane = first_w_plane + num_planes - 1
    contribution = w_img * w_pattern ** float(last_w_plane
                                              + w_support // 2 - 1)
    return subgrid_image + _like(contribution, subgrid_image)


def _like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` in ``ref``'s dtype (the real part for a real ``ref``)."""
    if x.is_complex() and not ref.is_complex():
        x = x.real
    return x.to(ref.dtype)


# ---------------------------------------------------------------------------
# Fused absolute-layer drivers (the all-layer kernels)
#
# A visibility is selected by exactly one w-slab j (the slabs tile w), and
# its tap touches absolute tower layers k = j .. j + w_support - 1 with
# weight w_kernel[w_row, k - j]. The whole tower reduces to one kernel pass
# producing K = num_planes + w_support - 1 layers, drained by one batched
# FFT and a w-pattern power ladder: algebraically the per-plane loop with
# the w_img recurrence telescoped.
# ---------------------------------------------------------------------------

def _fused_tap_data(uvws, start_chs, end_chs, off_u: int, off_v: int,
                    off_w: int, first_w_plane: int, freq0_hz, dfreq_hz,
                    num_chan: int, num_planes: int, theta: float,
                    w_step: float, support: int, oversampling: int,
                    w_support: int, w_oversampling: int, subgrid_size: int,
                    start_row: int, end_row: int):
    """Plane-resolved flat taps for the all-layer kernels: (mask [V],
    iu0 [V] int32, iv0 [V] int32, uk [V, S], vk [V, S], weights [V, K])
    (f32 taps from the Chebyshev fits) and K. Same addressing as
    :func:`_plane_geometry`, with the plane-invariant parts hoisted out
    of the plane loop."""
    num_k = num_planes + w_support - 1
    fdtype = uvws.dtype
    dev = uvws.device
    half_subgrid = subgrid_size // 2
    theta_ov = theta * oversampling
    w_step_ov = (1.0 / w_step) * w_oversampling
    half_sg_size_ov = (half_subgrid - support // 2 + 1) * oversampling

    uvw_s = uvws * (freq0_hz / C_0)
    duvw = uvws * (dfreq_hz / C_0)
    u0 = uvw_s[:, 0] - _scalar(off_u, fdtype, dev) / theta
    v0 = uvw_s[:, 1] - _scalar(off_v, fdtype, dev) / theta
    w0 = uvw_s[:, 2]

    chan = torch.arange(num_chan, device=dev)
    chan_f = chan.to(fdtype)
    u = u0[:, None] + chan_f[None, :] * duvw[:, 0:1]
    v = v0[:, None] + chan_f[None, :] * duvw[:, 1:2]
    iu0_ov = _round_half_away(u * theta_ov).to(torch.int32) + half_sg_size_ov
    iv0_ov = _round_half_away(v * theta_ov).to(torch.int32) + half_sg_size_ov
    iu0 = torch.div(iu0_ov, oversampling, rounding_mode="floor").clamp(
        0, subgrid_size - support)
    iv0 = torch.div(iv0_ov, oversampling, rounding_mode="floor").clamp(
        0, subgrid_size - support)

    row_ids = torch.arange(uvws.shape[0], device=dev)
    row_sel = (row_ids >= start_row) & (row_ids < end_row)
    w_coord = uvws[:, 2]

    mask_any = j_idx = w_row_sel = None
    for p in range(num_planes):
        w_plane = first_w_plane + p
        min_w = _scalar(w_plane + off_w - 1, fdtype, dev) * w_step
        max_w = _scalar(w_plane + off_w, fdtype, dev) * w_step
        start_ch, end_ch = clamp_channels_inline(
            w_coord, freq0_hz, dfreq_hz, start_chs, end_chs, min_w, max_w)
        # Row bounds check over the plane's clamped channel range
        # (reference :112-121).
        start_f = start_ch.to(fdtype)
        end1_f = (end_ch - 1).to(fdtype)
        u_min = torch.floor(theta * (u0 + start_f * duvw[:, 0]))
        u_max = torch.ceil(theta * (u0 + end1_f * duvw[:, 0]))
        v_min = torch.floor(theta * (v0 + start_f * duvw[:, 1]))
        v_max = torch.ceil(theta * (v0 + end1_f * duvw[:, 1]))
        row_active = (row_sel & (start_ch < end_ch)
                      & (u_min >= -half_subgrid) & (u_max < half_subgrid)
                      & (v_min >= -half_subgrid) & (v_max < half_subgrid))
        mask_p = (row_active[:, None]
                  & (chan[None, :] >= start_ch[:, None])
                  & (chan[None, :] < end_ch[:, None]))
        # The w kernel row for this plane's shift (the operation order of
        # _plane_geometry: shift w0 per row, then the channel ramp).
        w0_p = w0 - _scalar(off_w + w_plane - 1, fdtype, dev) * w_step
        w_p = w0_p[:, None] + chan_f[None, :] * duvw[:, 2:3]
        w_row_p = torch.remainder(
            _round_half_away(w_p * w_step_ov).to(torch.int32),
            w_oversampling)
        if mask_any is None:
            mask_any = mask_p
            j_idx = torch.where(mask_p, p, 0)
            w_row_sel = torch.where(mask_p, w_row_p, 0)
        else:
            mask_any = mask_any | mask_p
            j_idx = torch.where(mask_p, p, j_idx)
            w_row_sel = torch.where(mask_p, w_row_p, w_row_sel)

    mask_f = mask_any.reshape(-1)
    j_f = j_idx.reshape(-1)
    uv_c = _tap_coeffs_cached(support, oversampling)
    w_c = _tap_coeffs_cached(w_support, w_oversampling)
    uk = eval_kernel_taps(torch.remainder(iu0_ov, oversampling).reshape(-1),
                          uv_c, oversampling)
    vk = eval_kernel_taps(torch.remainder(iv0_ov, oversampling).reshape(-1),
                          uv_c, oversampling)
    wk = eval_kernel_taps(w_row_sel.reshape(-1), w_c, w_oversampling)
    weights = _slab_weights(wk, j_f, mask_f, num_k)
    return (mask_f, iu0.reshape(-1).to(torch.int32).contiguous(),
            iv0.reshape(-1).to(torch.int32).contiguous(), uk.contiguous(),
            vk.contiguous(), weights, num_k)


def _slab_weights(wk: torch.Tensor, j: torch.Tensor, keep: torch.Tensor,
                  num_k: int) -> torch.Tensor:
    """``weights[v, k] = wk[v, k - j[v]]`` inside the slab window
    ``[j, j + Sw)``, zero elsewhere and where ``keep`` is False."""
    w_support = wk.shape[1]
    k_ids = torch.arange(num_k, device=wk.device)[None, :]
    weights = torch.zeros((wk.shape[0], num_k), dtype=wk.dtype,
                          device=wk.device)
    for layer in range(w_support):
        weights = weights + torch.where(
            k_ids == (j[:, None] + layer), wk[:, layer:layer + 1],
            torch.zeros((), dtype=wk.dtype, device=wk.device))
    return torch.where(keep[:, None], weights,
                       torch.zeros((), dtype=wk.dtype,
                                   device=wk.device)).contiguous()


def _fast_mxu() -> bool:
    """The bf16 mode of the all-layer kernels, opted into with the JAX
    package's environment switch ``SKA_SDP_FUNC_TPU_FAST_MXU`` (any
    non-empty value), read at call time."""
    return bool(os.environ.get("SKA_SDP_FUNC_TPU_FAST_MXU"))


def _grid_all_planes_fused(vis, w_pattern, uv_kernel, w_kernel, uvws,
                           start_chs, end_chs, subgrid_image, off_u, off_v,
                           off_w, first_w_plane: int, freq0_hz, dfreq_hz,
                           num_planes: int, theta: float, w_step: float,
                           support: int, oversampling: int, w_support: int,
                           w_oversampling: int, subgrid_size: int,
                           start_row: int, end_row: int) -> torch.Tensor:
    """One all-layer grid pass and the telescoped tower drain."""
    mask_f, iu0, iv0, uk, vk, weights, num_k = _fused_tap_data(
        uvws, start_chs, end_chs, off_u, off_v, off_w, first_w_plane,
        freq0_hz, dfreq_hz, vis.shape[1], num_planes, theta, w_step,
        support, oversampling, w_support, w_oversampling, subgrid_size,
        start_row, end_row)
    vis_f = vis.reshape(-1)
    vis_re = torch.where(mask_f, vis_f.real, 0.0).to(torch.float32)
    vis_im = torch.where(mask_f, vis_f.imag, 0.0).to(torch.float32)
    acc = tower_tap.grid_all_layers(
        vis_re.contiguous(), vis_im.contiguous(), iu0, iv0, uk, vk, weights,
        num_k, subgrid_size, support, fast=_fast_mxu())  # [K, N, N] c64

    # The w_img recurrence (reference :1029-1113) collapses to
    # sum_k ifft(acc_k) * w_pattern^(first + Sw//2 - Sw + k).
    cdtype = (subgrid_image.dtype if subgrid_image.is_complex()
              else _complex_dtype(subgrid_image.dtype))
    layers = ifft_shifted(acc.to(cdtype))
    exps = (first_w_plane + w_support // 2 - w_support
            + torch.arange(num_k, device=vis.device)).to(
                w_pattern.real.dtype)
    ladder = w_pattern[None] ** exps[:, None, None]
    contribution = (layers * ladder.to(layers.dtype)).sum(dim=0)
    return subgrid_image + _like(contribution, subgrid_image)


def _degrid_all_planes_fused(subgrid_image, w_pattern, uv_kernel, w_kernel,
                             uvws, start_chs, end_chs, vis, off_u, off_v,
                             off_w, first_w_plane: int, freq0_hz, dfreq_hz,
                             num_planes: int, theta: float, w_step: float,
                             support: int, oversampling: int,
                             w_support: int, w_oversampling: int,
                             subgrid_size: int, start_row: int,
                             end_row: int) -> torch.Tensor:
    """FFT every tower layer at once, then one all-layer degrid pass."""
    mask_f, iu0, iv0, uk, vk, weights, num_k = _fused_tap_data(
        uvws, start_chs, end_chs, off_u, off_v, off_w, first_w_plane,
        freq0_hz, dfreq_hz, vis.shape[1], num_planes, theta, w_step,
        support, oversampling, w_support, w_oversampling, subgrid_size,
        start_row, end_row)
    # Absolute layer k holds fft(image / w_pattern^(first - Sw//2 + k))
    # (the fill/step recurrence of reference :803-899, telescoped).
    exps = (first_w_plane - w_support // 2
            + torch.arange(num_k, device=vis.device)).to(
                w_pattern.real.dtype)
    ladder = w_pattern[None] ** (-exps[:, None, None])
    layers = fft_shifted(subgrid_image[None].to(vis.dtype)
                         * ladder.to(vis.dtype))
    vis_flat = tower_tap.degrid_all_layers(layers, iu0, iv0, uk, vk,
                                           weights, support,
                                           fast=_fast_mxu())
    contribution = torch.where(mask_f, vis_flat.to(vis.dtype),
                               torch.zeros((), dtype=vis.dtype,
                                           device=vis.device))
    return vis + contribution.reshape(vis.shape)
