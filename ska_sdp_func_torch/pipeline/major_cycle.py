"""Major-cycle CLEAN imaging solver (single device).

Counterpart of ska_sdp_func_tpu.pipeline.major_cycle
(major_cycle.py:99-487) on one device:

    psf    = normalise(grid(1))                     (once, 2N)
    repeat n_major times:
        residual_vis = vis - degrid(model)          (sorted stream)
        dirty        = normalise(grid(residual_vis))
        delta, res   = hogbom_minor_cycle(dirty, psf)
        model       += delta
    restored = model * cbeam + res

Three operator paths, chosen as the JAX package chooses them:

- ``bucketed=False`` (the default): the per-task drivers
  (:func:`~..parallel.wstack.grid_all_tasks` /
  :func:`~..parallel.wstack.degrid_all_tasks`; the ``grid_plane`` /
  ``degrid_plane`` kernels for complex64 on CUDA), O(tasks x V);
- ``bucketed=True`` on a geometry the packed path can express: the
  packed whole-image gridder (:mod:`..parallel.packed`) in the plan's
  sorted stream;
- ``bucketed=True`` on any other geometry (a sub-grid that is not a
  multiple of 128, say): the bucketed per-task fallback
  (:mod:`..parallel.bucketed`; the all-layer kernels), O(V).

Branches that are not ported (``mesh``, msclean, checkpointing) raise
``NotImplementedError`` naming their ROADMAP item; none is silently
rerouted.
"""

from dataclasses import dataclass
from typing import List, Optional

import torch

from ..clean.hogbom import _minor_cycle, create_cbeam
from ..numeric_functions.fft_convolution import fft_convolution
from ..parallel.bucketed import (
    degrid_all_bucketed,
    grid_all_bucketed,
    inverse_index_of,
    plan_bucketed,
)
from ..parallel.packed import packed_gridder, plan_packed
from ..parallel.wstack import (
    WStackPlan,
    degrid_all_tasks,
    grid_all_tasks,
    plan_wstack,
)
from ..utility.errors import SdpInvalidArgumentError
from ..utility.logging import log_info
from ..utility.tensors import host_uvw, resolve_device, to_device
from ..utility.timers import Timers, TimerType


@dataclass
class ImagingResult:
    """Solver outputs: CLEAN component model, final residual image,
    restored image, and per-major-cycle peak-residual history."""

    model: torch.Tensor
    residual: torch.Tensor
    restored: torch.Tensor
    peak_history: List[float]


def make_psf_plan(plan: WStackPlan, uvw) -> WStackPlan:
    """PSF plan at twice the image size / field of view (same uv cell),
    re-planned from uvw (clean/sdp_hogbom_clean.cpp:217-240)."""
    return plan_wstack(
        uvw, plan.freq0_hz, plan.dfreq_hz, plan.num_chan,
        2 * plan.image_size, plan.subgrid_size, 2 * plan.theta,
        plan.w_step, plan.shear_u, plan.shear_v, plan.support,
        plan.oversampling, plan.w_support, plan.w_oversampling,
        plan.subgrid_frac, plan.w_tower_height)


def _channel_ranges(plan: WStackPlan, uvw: torch.Tensor):
    num_rows = uvw.shape[0]
    return (torch.zeros((num_rows,), dtype=torch.int32, device=uvw.device),
            torch.full((num_rows,), plan.num_chan, dtype=torch.int32,
                       device=uvw.device))


def _grid(plan: WStackPlan, vis: torch.Tensor,
          uvw: torch.Tensor) -> torch.Tensor:
    """Task-driver dirty image (real part, vis's real precision)."""
    return grid_all_tasks(plan, plan.kernel(), vis, uvw,
                          *_channel_ranges(plan, uvw), device=vis.device).real


def _degrid(plan: WStackPlan, image: torch.Tensor, uvw: torch.Tensor,
            vis_dtype) -> torch.Tensor:
    return degrid_all_tasks(plan, plan.kernel(), image, uvw,
                            *_channel_ranges(plan, uvw), vis_dtype,
                            device=image.device)


def _stop_level(dirty, threshold, mgain):
    return torch.maximum(threshold, (1.0 - mgain) * dirty.abs().max())


def _norm_mask(image: torch.Tensor, peak, margin: int) -> torch.Tensor:
    """Normalise by the PSF peak and zero the border margin."""
    return _mask_border(image / peak.to(image.dtype), margin)


def _mask_border(image: torch.Tensor, margin: int) -> torch.Tensor:
    """Zero a border margin: the 1/PSWF grid correction diverges at the
    image edge (test_gridder_wtower_uvw.py:2188-2193), and without a
    CLEAN window the minor-cycle argmax would lock onto it."""
    if margin <= 0:
        return image
    out = torch.zeros_like(image)
    out[margin:-margin, margin:-margin] = image[margin:-margin,
                                                margin:-margin]
    return out


def _packed_residual(vre, vim, pred, w_sorted):
    """Sorted-stream residual (re, im): V - W * (A model)."""
    pre, pim = pred.real, pred.imag
    if w_sorted is not None:
        pre = pre * w_sorted
        pim = pim * w_sorted
    return vre - pre, vim - pim


def _restore(model, cbeam, residual_img):
    convolved = fft_convolution(model, cbeam)
    return convolved.real.to(model.dtype) + residual_img


def major_cycle_imager(plan: WStackPlan, vis, uvw, n_major: int = 3,
                       loop_gain: float = 0.1, threshold: float = 1e-3,
                       cycle_limit: int = 1000,
                       cbeam_details=(2.0, 2.0, 1.0, 128.0),
                       mesh=None, border: Optional[int] = None,
                       mgain: float = 0.8,
                       checkpoint_path: Optional[str] = None,
                       checkpointer=None, weights=None,
                       clean_algorithm: str = "hogbom",
                       bucketed: bool = False, fast: bool = False,
                       verbosity: int = 0, device=None) -> ImagingResult:
    """Run the major/minor-cycle imaging solve on ``device`` (``None``:
    the CUDA card; CPU runs pass ``device="cpu"``).

    ``vis`` [rows, chan] complex and ``weights`` [rows, chan] are NumPy
    arrays or tensors; ``uvw`` [rows, 3] is NumPy or a tensor on any
    device (the planners run on the host, and the device drivers take it
    in f64).
    ``bucketed`` picks the operator path (module docstring). ``mgain``
    bounds each minor cycle at ``max(threshold, (1 - mgain) *
    dirty_peak)``; ``fast=True`` runs the packed kernels on bf16 bands.
    ``verbosity > 0`` logs a per-stage timing report after the solve
    (the reference driver's report_timing,
    sdp_grid_wstack_wtower.cpp:169-213), timed with CUDA events on a
    CUDA device.
    """
    if mesh is not None:
        raise NotImplementedError(
            "multi-device solves are not ported yet: ROADMAP Queue 1 "
            "item 15")
    if checkpoint_path is not None or checkpointer is not None:
        raise NotImplementedError(
            "solver checkpointing is not ported yet: ROADMAP Queue 1 "
            "item 13")
    if clean_algorithm == "msclean":
        raise NotImplementedError(
            "clean_algorithm='msclean' is not ported yet (ROADMAP Queue 1 "
            "item 13)")
    if clean_algorithm != "hogbom":
        raise ValueError("unknown clean_algorithm")

    image_size = plan.image_size
    uvw = host_uvw(uvw)
    vis = to_device(vis, resolve_device(device))
    dev = vis.device
    rdtype = vis.real.dtype
    timers = (Timers("major_cycle_imager", TimerType.DEVICE, device=dev)
              if verbosity > 0 else None)
    psf_plan = make_psf_plan(plan, uvw)
    if border is None:
        border = image_size // 16
    if timers:
        timers.push("planning")
    packed = bucket = None
    if bucketed:
        # The packed ingest where the geometry allows it; otherwise the
        # bucketed per-task fallback.
        try:
            packed = (packed_gridder(plan_packed(plan, uvw), fast=fast,
                                     device=dev),
                      packed_gridder(plan_packed(psf_plan, uvw), fast=fast,
                                     device=dev))
        except SdpInvalidArgumentError:
            bplan, sort_index, valid = plan_bucketed(plan, uvw)
            psf_bplan, psf_sort, psf_valid = plan_bucketed(psf_plan, uvw)
            bucket = dict(
                bplan=bplan, sort=sort_index, valid=valid,
                inv=inverse_index_of(sort_index, valid, vis.numel()),
                psf_bplan=psf_bplan, psf_sort=psf_sort, psf_valid=psf_valid)
    uvw_dev = torch.as_tensor(uvw, device=dev)

    psf_vis = None
    if weights is None:
        psf_vis_grid = torch.ones_like(vis)
    else:
        # The PSF uses the weights, the data the weighted visibilities;
        # the PSF-peak normalisation keeps the scale consistent.
        psf_vis = to_device(weights, dev).to(vis.dtype)
        psf_vis_grid = psf_vis
        vis = vis * psf_vis
    if timers:
        timers.pop_push("psf grid + sort")
    if packed is not None:
        gri, psf_gri = packed
        psf = psf_gri.grid(psf_vis_grid)
        vre, vim = gri.sort(vis)
        w_sorted = None if psf_vis is None else gri.sort(psf_vis)[0]
    elif bucket is not None:
        psf = grid_all_bucketed(bucket["psf_bplan"], psf_vis_grid, uvw_dev,
                                bucket["psf_sort"], bucket["psf_valid"],
                                device=dev)
    else:
        psf = _grid(psf_plan, psf_vis_grid, uvw_dev)
    peak = psf[image_size, image_size]  # centre of the 2N PSF
    psf = _norm_mask(psf, peak, 2 * border)
    if timers:
        timers.pop()

    model = torch.zeros((image_size, image_size), dtype=rdtype, device=dev)
    residual_img = torch.zeros_like(model)
    peak_history: List[float] = []
    threshold_t = torch.as_tensor(threshold, dtype=rdtype, device=dev)
    mgain_t = torch.as_tensor(mgain, dtype=rdtype, device=dev)
    for _cycle in range(n_major):
        if timers:
            timers.push("degrid predict")
        if packed is not None:
            pred = gri.degrid_sorted(model)
            res_re, res_im = _packed_residual(vre, vim, pred, w_sorted)
            if timers:
                timers.pop_push("grid residual")
            raw = gri.grid_sorted(res_re, res_im)
        else:
            if bucket is not None:
                pred = degrid_all_bucketed(
                    bucket["bplan"], model, uvw_dev, bucket["sort"],
                    bucket["valid"], bucket["inv"], device=dev).to(vis.dtype)
            else:
                pred = _degrid(plan, model, uvw_dev, vis.dtype)
            if psf_vis is not None:
                # dirty = A^T W (V - A model): weight the prediction too.
                pred = pred * psf_vis
            res_vis = vis - pred
            if timers:
                timers.pop_push("grid residual")
            if bucket is not None:
                raw = grid_all_bucketed(bucket["bplan"], res_vis, uvw_dev,
                                        bucket["sort"], bucket["valid"],
                                        device=dev)
            else:
                raw = _grid(plan, res_vis, uvw_dev)
        dirty = _norm_mask(raw, peak, border)
        if timers:
            timers.pop_push("minor cycle")
        stop = _stop_level(dirty, threshold_t, mgain_t)
        delta, residual_img = _minor_cycle(dirty, psf, float(loop_gain),
                                           stop, int(cycle_limit))
        model = model + delta
        peak_history.append(float(residual_img.abs().max()))
        if timers:
            timers.pop()
        if peak_history[-1] < threshold:
            break

    if timers:
        timers.push("restore")
    cbeam = create_cbeam(
        torch.as_tensor(cbeam_details, dtype=rdtype, device=dev),
        int(cbeam_details[3]))
    restored = _restore(model, cbeam, residual_img)
    if timers:
        timers.pop()
        timers.report(print_fn=lambda text: [
            log_info("%s", line) for line in text.splitlines()])
    return ImagingResult(model=model, residual=residual_img,
                         restored=restored, peak_history=peak_history)
