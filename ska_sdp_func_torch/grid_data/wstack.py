"""W-stacking drivers: whole image <-> full visibility set.

Counterpart of ska_sdp_func_tpu.grid_data.wstack (reference:
grid_data/sdp_grid_wstack_wtower.{h,cpp}). The image is cut into
w-stacking planes (spacing ``w_tower_height * w_step``) and uv sub-grids
(effective size ``floor(subgrid_size * subgrid_frac)``); visibilities
are routed to (plane, sub-grid) boxes by channel clamping, run through
the w-towers gridder (:class:`~.wtower.GridderWtowerUVW`) and reduced
back (grid side: sub-grid FFT and wrap-around add scaled by
``(image_size / subgrid_size)^2``; degrid side: cut-out and normalised
iFFT). The processed-visibility cross-check (reference :442-448) raises
:class:`SdpRuntimeError`.

``engine="packed"`` routes through the packed whole-image path
(:mod:`..parallel.packed`); ``"auto"`` takes it for single-precision
templates where the geometry allows. Both drivers run on ``device``
(``None``: the CUDA card; CPU runs pass ``device="cpu"``) and move their
inputs there.
"""

import math

import numpy as np
import torch

from ..fourier_transforms.fft import fft_shifted, ifft_shifted_norm
from ..utility.errors import SdpInvalidArgumentError, SdpRuntimeError
from ..utility.logging import log_info
from ..utility.tensors import resolve_device
from ..utility.timers import Timers
from .clamp_channels import clamp_channels_single, clamp_channels_uv
from .gridder_utils import subgrid_add, subgrid_cut_out, uvw_bounds_all
from .wtower import GridderWtowerUVW, _tensor

_SINGLE = ("complex64", "float32")


def _plane_and_subgrid_ranges(uvw, freq0_hz, dfreq_hz, start_ch, end_ch,
                              eff_sg_dist, w_stack_dist):
    """Sub-grid and w-plane index ranges (reference :316-330)."""
    eta = 1e-5
    uvw_min, uvw_max = uvw_bounds_all(uvw, freq0_hz, dfreq_hz, start_ch,
                                      end_ch)
    lo = uvw_min.cpu().double().numpy()
    hi = uvw_max.cpu().double().numpy()
    return (int(math.floor(lo[0] / eff_sg_dist + 0.5 - eta)),
            int(math.floor(hi[0] / eff_sg_dist + 0.5 + eta)),
            int(math.floor(lo[1] / eff_sg_dist + 0.5 - eta)),
            int(math.floor(hi[1] / eff_sg_dist + 0.5 + eta)),
            int(math.floor(lo[2] / w_stack_dist + 0.5 - eta)),
            int(math.floor(hi[2] / w_stack_dist + 0.5 + eta)))


def _check_args(vis, uvw, w_tower_height):
    if vis.ndim != 2 or uvw.ndim != 2:
        raise SdpInvalidArgumentError(
            "Visibilities and (u,v,w)-coordinates must be 2D")
    if w_tower_height == 0.0:
        raise SdpInvalidArgumentError(
            "Automatic w-tower height not yet implemented")


def _resolve_engine(engine: str, template, subgrid_size: int, support: int,
                    w_support: int, subgrid_frac: float) -> str:
    """Pick the driver engine (see :func:`wstack_wtower_degrid_all`)."""
    if engine == "reference":
        return "reference"
    from ..parallel.packed import packed_geometry_ok

    compatible = packed_geometry_ok(subgrid_size, support, w_support,
                                    subgrid_frac)
    if engine == "packed":
        if not compatible:
            raise SdpInvalidArgumentError(
                "packed engine requires subgrid_size % 128 == 0, "
                "support <= 8, w_support <= 4 and "
                "eff_sg_size + support <= subgrid_size")
        return "packed"
    if engine == "auto":
        dt = getattr(template, "dtype", None)
        single = dt is not None and str(dt).replace("torch.", "") in _SINGLE
        return "packed" if (compatible and single) else "reference"
    raise SdpInvalidArgumentError(f"unknown engine {engine!r}")


def _host_uvw(uvw) -> np.ndarray:
    if isinstance(uvw, torch.Tensor):
        uvw = uvw.detach().cpu().numpy()
    return np.ascontiguousarray(uvw, np.float64)


def _packed_gridder(uvw, freq0_hz, dfreq_hz, num_chan, image_size,
                    subgrid_size, theta, w_step, shear_u, shear_v, support,
                    oversampling, w_support, w_oversampling, subgrid_frac,
                    w_tower_height, device):
    from ..parallel.packed import packed_gridder, plan_packed
    from ..parallel.wstack import plan_wstack

    uvw_np = _host_uvw(uvw)
    plan = plan_wstack(
        uvw_np, freq0_hz, dfreq_hz, num_chan, image_size, subgrid_size,
        theta, w_step, shear_u, shear_v, support, oversampling, w_support,
        w_oversampling, subgrid_frac or (2.0 / 3.0), w_tower_height)
    return packed_gridder(plan_packed(plan, uvw_np), device=device)


def wstack_wtower_degrid_all(image, freq0_hz: float, dfreq_hz: float, uvw,
                             subgrid_size: int, theta: float, w_step: float,
                             shear_u: float, shear_v: float, support: int,
                             oversampling: int, w_support: int,
                             w_oversampling: int, subgrid_frac: float,
                             w_tower_height: float, verbosity: int = 0,
                             vis=None, num_threads: int = 0,
                             engine: str = "reference",
                             device=None) -> torch.Tensor:
    """Degrid a whole image into visibilities (forward operator;
    `sdp_grid_wstack_wtower_degrid_all`, sdp_grid_wstack_wtower.h:44-76)
    on ``device`` (``None``: the CUDA card). ``vis`` is required and
    gives only shape and dtype.

    ``engine``: "reference" (default) runs the reference per-task loop
    at the template's precision; "packed" the packed whole-image path
    (f32 taps; raises SdpInvalidArgumentError on a geometry it cannot
    express); "auto" packed for single-precision templates where the
    geometry allows, else the reference loop.
    """
    if vis is None:
        raise SdpInvalidArgumentError(
            "vis template required (shape [num_rows, num_chan])")
    device = resolve_device(device)
    eng = _resolve_engine(engine, vis, subgrid_size, support, w_support,
                          subgrid_frac)
    image = _tensor(image, device)
    uvw = _tensor(uvw, device)
    vis = torch.zeros_like(_tensor(vis, device))
    _check_args(vis, uvw, w_tower_height)
    if eng == "packed":
        gridder = _packed_gridder(
            uvw, freq0_hz, dfreq_hz, vis.shape[1], int(image.shape[0]),
            subgrid_size, theta, w_step, shear_u, shear_v, support,
            oversampling, w_support, w_oversampling, subgrid_frac,
            w_tower_height, device)
        return gridder.degrid(image.to(torch.complex64)).to(vis.dtype)
    if subgrid_frac == 0.0:
        subgrid_frac = 2.0 / 3.0
    num_rows, num_chan = vis.shape
    image_size = image.shape[0]

    timers = Timers("Degridding")
    kernel = GridderWtowerUVW(image_size, subgrid_size, theta, w_step,
                              shear_u, shear_v, support, oversampling,
                              w_support, w_oversampling)
    start_ch = torch.zeros((num_rows,), dtype=torch.int32, device=device)
    end_ch = torch.full((num_rows,), num_chan, dtype=torch.int32,
                        device=device)
    eff_sg_size = int(math.floor(subgrid_size * subgrid_frac))
    eff_sg_dist = eff_sg_size / theta
    w_stack_dist = w_tower_height * w_step

    min_iu, max_iu, min_iv, max_iv, min_iw, max_iw = \
        _plane_and_subgrid_ranges(uvw, freq0_hz, dfreq_hz, start_ch, end_ch,
                                  eff_sg_dist, w_stack_dist)
    if verbosity > 0:
        log_info("using %d w-planes and %d sub-grids", 1 + max_iw - min_iw,
                 (1 + max_iu - min_iu) * (1 + max_iv - min_iv))

    for iw in range(min_iw, max_iw + 1):
        min_w = iw * w_stack_dist - w_stack_dist / 2
        max_w = (iw + 1) * w_stack_dist - w_stack_dist / 2
        start_ch_w, end_ch_w = clamp_channels_single(
            uvw, 2, freq0_hz, dfreq_hz, start_ch, end_ch, min_w, max_w)
        num_vis = int((end_ch_w - start_ch_w).sum())
        if num_vis == 0:
            continue

        # Image correction / w-stacking, then FFT to the full grid.
        timers.push("Degrid correct")
        grid = kernel.degrid_correct(image.to(vis.dtype), 0, 0,
                                     int(iw * w_tower_height), device=device)
        timers.pop_push("FFT(grid)")
        grid = fft_shifted(grid)
        timers.pop()

        vis_count_check = 0
        timers.push("Process sub-grid stack")
        for iu in range(min_iu, max_iu + 1):
            for iv in range(min_iv, max_iv + 1):
                min_u = iu * eff_sg_dist - eff_sg_dist / 2
                max_u = (iu + 1) * eff_sg_dist - eff_sg_dist / 2
                min_v = iv * eff_sg_dist - eff_sg_dist / 2
                max_v = (iv + 1) * eff_sg_dist - eff_sg_dist / 2
                s_uv, e_uv = clamp_channels_uv(
                    uvw, freq0_hz, dfreq_hz, start_ch_w, end_ch_w,
                    min_u, max_u, min_v, max_v)
                n_sub = int((e_uv - s_uv).sum())
                if n_sub == 0:
                    continue
                vis_count_check += n_sub
                subgrid = ifft_shifted_norm(subgrid_cut_out(
                    grid, iu * eff_sg_size, iv * eff_sg_size, subgrid_size))
                vis = kernel.degrid_subgrid(
                    subgrid, (iu * eff_sg_size, iv * eff_sg_size,
                              int(iw * w_tower_height)),
                    num_chan, freq0_hz, dfreq_hz, uvw, s_uv, e_uv, vis,
                    device=device)
        timers.pop()
        if vis_count_check != num_vis:
            raise SdpRuntimeError(
                f"Processed {vis_count_check} but expected {num_vis} "
                f"visibilities")
    if verbosity > 0:
        timers.report(log_info)
    return vis


def wstack_wtower_grid_all(vis, freq0_hz: float, dfreq_hz: float, uvw,
                           subgrid_size: int, theta: float, w_step: float,
                           shear_u: float, shear_v: float, support: int,
                           oversampling: int, w_support: int,
                           w_oversampling: int, subgrid_frac: float,
                           w_tower_height: float, verbosity: int = 0,
                           image=None, num_threads: int = 0,
                           engine: str = "reference",
                           device=None) -> torch.Tensor:
    """Grid all visibilities into a whole image (adjoint operator;
    `sdp_grid_wstack_wtower_grid_all`, sdp_grid_wstack_wtower.h:78-109)
    on ``device`` (``None``: the CUDA card). ``image`` gives shape and
    dtype (real or complex); the output is freshly accumulated.
    ``engine`` as for :func:`wstack_wtower_degrid_all`."""
    if image is None:
        raise SdpInvalidArgumentError("image template required")
    device = resolve_device(device)
    eng = _resolve_engine(engine, image, subgrid_size, support, w_support,
                          subgrid_frac)
    vis = _tensor(vis, device)
    uvw = _tensor(uvw, device)
    image = torch.zeros_like(_tensor(image, device))
    _check_args(vis, uvw, w_tower_height)
    if eng == "packed":
        gridder = _packed_gridder(
            uvw, freq0_hz, dfreq_hz, vis.shape[1], int(image.shape[0]),
            subgrid_size, theta, w_step, shear_u, shear_v, support,
            oversampling, w_support, w_oversampling, subgrid_frac,
            w_tower_height, device)
        return gridder.grid(vis).to(image.dtype)
    if subgrid_frac == 0.0:
        subgrid_frac = 2.0 / 3.0
    num_rows, num_chan = vis.shape
    image_size = image.shape[0]

    timers = Timers("Gridding")
    kernel = GridderWtowerUVW(image_size, subgrid_size, theta, w_step,
                              shear_u, shear_v, support, oversampling,
                              w_support, w_oversampling)
    start_ch = torch.zeros((num_rows,), dtype=torch.int32, device=device)
    end_ch = torch.full((num_rows,), num_chan, dtype=torch.int32,
                        device=device)
    eff_sg_size = int(math.floor(subgrid_size * subgrid_frac))
    eff_sg_dist = eff_sg_size / theta
    w_stack_dist = w_tower_height * w_step
    sg_factor = (image_size / subgrid_size) ** 2

    min_iu, max_iu, min_iv, max_iv, min_iw, max_iw = \
        _plane_and_subgrid_ranges(uvw, freq0_hz, dfreq_hz, start_ch, end_ch,
                                  eff_sg_dist, w_stack_dist)
    if verbosity > 0:
        log_info("using %d w-planes and %d sub-grids", 1 + max_iw - min_iw,
                 (1 + max_iu - min_iu) * (1 + max_iv - min_iv))

    for iw in range(min_iw, max_iw + 1):
        min_w = iw * w_stack_dist - w_stack_dist / 2
        max_w = (iw + 1) * w_stack_dist - w_stack_dist / 2
        start_ch_w, end_ch_w = clamp_channels_single(
            uvw, 2, freq0_hz, dfreq_hz, start_ch, end_ch, min_w, max_w)
        num_vis = int((end_ch_w - start_ch_w).sum())
        if num_vis == 0:
            continue
        grid = torch.zeros((image_size, image_size), dtype=vis.dtype,
                           device=device)

        vis_count_check = 0
        timers.push("Process sub-grid stack")
        for iu in range(min_iu, max_iu + 1):
            for iv in range(min_iv, max_iv + 1):
                min_u = iu * eff_sg_dist - eff_sg_dist / 2
                max_u = (iu + 1) * eff_sg_dist - eff_sg_dist / 2
                min_v = iv * eff_sg_dist - eff_sg_dist / 2
                max_v = (iv + 1) * eff_sg_dist - eff_sg_dist / 2
                s_uv, e_uv = clamp_channels_uv(
                    uvw, freq0_hz, dfreq_hz, start_ch_w, end_ch_w,
                    min_u, max_u, min_v, max_v)
                n_sub = int((e_uv - s_uv).sum())
                if n_sub == 0:
                    continue
                vis_count_check += n_sub
                subgrid = kernel.grid_subgrid(
                    vis, uvw, s_uv, e_uv, num_chan, freq0_hz, dfreq_hz,
                    torch.zeros((subgrid_size, subgrid_size),
                                dtype=vis.dtype, device=device),
                    (iu * eff_sg_size, iv * eff_sg_size,
                     int(iw * w_tower_height)), device=device)
                grid = subgrid_add(grid, -iu * eff_sg_size,
                                   -iv * eff_sg_size, fft_shifted(subgrid),
                                   sg_factor)
        timers.pop()
        if vis_count_check != num_vis:
            raise SdpRuntimeError(
                f"Processed {vis_count_check} but expected {num_vis} "
                f"visibilities")

        # image += grid_correct(ifft(grid), 0, 0, iw * w_tower_height)
        timers.push("FFT(grid)")
        grid = ifft_shifted_norm(grid)
        timers.pop_push("Grid correct")
        grid = kernel.grid_correct(grid, 0, 0, int(iw * w_tower_height),
                                   device=device)
        timers.pop()
        if image.is_complex():
            image = image + grid.to(image.dtype)
        else:
            image = image + grid.real.to(image.dtype)
    if verbosity > 0:
        timers.report(log_info)
    return image
