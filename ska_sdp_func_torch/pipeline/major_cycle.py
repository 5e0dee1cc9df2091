"""Major-cycle CLEAN imaging solver (single device).

Counterpart of ska_sdp_func_tpu.pipeline.major_cycle
(major_cycle.py:99-487) on one device:

    psf    = normalise(grid(1))                     (once, 2N)
    repeat n_major times:
        residual_vis = vis - degrid(model)          (sorted stream)
        dirty        = normalise(grid(residual_vis))
        delta, res   = minor_cycle(dirty, psf)     (Hogbom or MS-CLEAN)
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

The minor cycle is Hogbom (:mod:`..clean.hogbom`) or, with
``clean_algorithm="msclean"``, multi-scale CLEAN over ``scale_list``
(:func:`_make_msclean_minor`). ``checkpoint_path`` / ``checkpointer``
persist the solver state after every major cycle and resume from it
(:mod:`.checkpoint`).

With ``mesh`` (a process mesh, one rank a card) every rank takes the
whole ``vis`` and ``uvw`` (the host planners need all of uvw) and works
on its own block: the task drivers on its block of rows
(:func:`~..parallel.wstack.wstack_grid_all_sharded`), the packed path on
its block of the sorted stream (the plans padded to a multiple of the
rank count; :meth:`~..parallel.packed.PackedGridder.grid_sorted_sharded`).
The grids are summed over the ranks, so every rank holds the same image
bits, takes the same minor-cycle decisions and returns the same result.
"""

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..clean.hogbom import _minor_cycle, create_cbeam
from ..clean.ms_clean import (
    _make_scale_kernels,
    _ms_minor_cycle,
    _scaled_psfs,
    _scaled_residuals,
)
from ..numeric_functions.fft_convolution import fft_convolution
from ..parallel.bucketed import (
    degrid_all_bucketed,
    grid_all_bucketed,
    inverse_index_of,
    plan_bucketed,
)
from ..parallel.mesh import local_rows, mesh_axis, mesh_device, pad_rows
from ..parallel.packed import _MeshDrivers, packed_gridder, plan_packed
from ..parallel.wstack import (
    WStackPlan,
    degrid_all_tasks,
    grid_all_tasks,
    plan_wstack,
    wstack_degrid_all_sharded,
    wstack_grid_all_sharded,
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


def _grid(plan: WStackPlan, vis: torch.Tensor, uvw: torch.Tensor,
          shard=None) -> torch.Tensor:
    """Task-driver dirty image (real part, vis's real precision).
    ``shard`` ``(mesh, start_chs, end_chs)``: ``vis`` and ``uvw`` are the
    rank's block of rows (:func:`_row_block`), and the image is the sum
    over the ranks."""
    if shard is not None:
        mesh, start_chs, end_chs = shard
        return wstack_grid_all_sharded(
            plan, vis, uvw, mesh, image_dtype=vis.real.dtype,
            start_chs=start_chs, end_chs=end_chs)
    return grid_all_tasks(plan, plan.kernel(), vis, uvw,
                          *_channel_ranges(plan, uvw), device=vis.device).real


def _degrid(plan: WStackPlan, image: torch.Tensor, uvw: torch.Tensor,
            vis_dtype, shard=None) -> torch.Tensor:
    """Task-driver prediction of ``uvw``'s rows (``shard`` as in
    :func:`_grid`: the rank's block)."""
    if shard is not None:
        mesh, start_chs, end_chs = shard
        return wstack_degrid_all_sharded(
            plan, image, uvw, mesh, vis_dtype=vis_dtype,
            start_chs=start_chs, end_chs=end_chs)
    return degrid_all_tasks(plan, plan.kernel(), image, uvw,
                            *_channel_ranges(plan, uvw), vis_dtype,
                            device=image.device)


def _row_block(plan: WStackPlan, mesh, uvw: torch.Tensor, *arrays):
    """The task drivers' shard of a mesh (JAX major_cycle.py:139-160):
    ``(shard, uvw, *arrays)`` with the rows of ``uvw`` and of each [rows,
    ...] array (``None`` stays ``None``) padded to a multiple of the rank
    count and cut to this rank's block; ``shard`` is :func:`_grid`'s
    argument, whose channel ranges select nothing on the pad rows."""
    pad = pad_rows(uvw.shape[0], mesh_axis(mesh)[0])[1]

    def padded(x):
        if x is None or not pad:
            return x
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    uvw, start_chs, end_chs, *blocks = local_rows(mesh, *(
        padded(x) for x in (uvw, *_channel_ranges(plan, uvw), *arrays)))
    return ((mesh, start_chs, end_chs), uvw, *blocks)


def _solver_device(mesh, device) -> torch.device:
    """Where a solve runs: ``device``, else the mesh's card, else the
    CUDA card."""
    if device is None and mesh is not None:
        return mesh_device(mesh)
    return resolve_device(device)


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


def dirty_and_psf(plan: WStackPlan, vis, uvw, mesh=None,
                  psf_plan: Optional[WStackPlan] = None,
                  border: Optional[int] = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid the dirty image (N) and the PSF (2N) with the task drivers on
    ``device`` (``None``: the CUDA card, or the mesh's), both normalised so
    the PSF peak is 1 (flux units), with a border margin (default size //
    16) zeroed on both: the CLEAN window. With ``mesh`` each rank grids
    its block of the rows of the whole ``vis`` and ``uvw``, and every rank
    returns the summed images."""
    uvw = host_uvw(uvw)
    if psf_plan is None:
        psf_plan = make_psf_plan(plan, uvw)
    if border is None:
        border = plan.image_size // 16
    vis = to_device(vis, _solver_device(mesh, device))
    uvw_dev = torch.as_tensor(uvw, device=vis.device)
    shard = None
    if mesh is not None:
        shard, uvw_dev, vis = _row_block(plan, mesh, uvw_dev, vis)
    dirty = _grid(plan, vis, uvw_dev, shard)
    psf = _grid(psf_plan, torch.ones_like(vis), uvw_dev, shard)
    peak = psf[psf.shape[0] // 2, psf.shape[1] // 2]
    return _norm_mask(dirty, peak, border), _norm_mask(psf, peak, 2 * border)


def _make_msclean_minor(psf: torch.Tensor, scales: Tuple[int, ...],
                        loop_gain: float, cycle_limit: int,
                        scale_bias: float = 0.0):
    """Multi-scale minor cycle closure: the scale kernels, doubly
    convolved PSFs and coupling matrix once per (psf, scales); per major
    cycle only the dirty image's scale convolutions and the minor loop
    run. The selection bias vector (Cornwell 2008, ``1 - bias * s /
    s_max``) exists only for a non-zero bias."""
    kernels = _make_scale_kernels(np.asarray(scales, np.int64),
                                  psf.shape[0], psf.dtype, psf.device)
    s_arr = np.asarray(scales, np.float64)
    s_max = s_arr.max() if s_arr.max() > 0 else 1.0
    bias_vec = (np.asarray(1.0 - scale_bias * s_arr / s_max, np.float64)
                if scale_bias else None)

    def conv(a, b):
        # The even-size 'same' convolution shifts its result by +1 pixel
        # per axis; unshift it so the scale-convolved PSFs register with
        # the raw kernel windows the model is built from, which the exact
        # degrid re-prediction needs to cancel the subtracted components.
        return torch.roll(fft_convolution(a, b), (-1, -1), dims=(-2, -1))

    scaled_psfs, coupling = _scaled_psfs(psf, kernels, conv)

    def minor(dirty, stop):
        residuals, model = _ms_minor_cycle(
            _scaled_residuals(dirty, kernels, conv), scaled_psfs, kernels,
            coupling, loop_gain, stop, cycle_limit, scale_bias=bias_vec)
        return model, residuals[0]

    return minor


def major_cycle_imager(plan: WStackPlan, vis, uvw, n_major: int = 3,
                       loop_gain: float = 0.1, threshold: float = 1e-3,
                       cycle_limit: int = 1000,
                       cbeam_details=(2.0, 2.0, 1.0, 128.0),
                       mesh=None, border: Optional[int] = None,
                       mgain: float = 0.8,
                       checkpoint_path: Optional[str] = None,
                       checkpointer=None, weights=None,
                       clean_algorithm: str = "hogbom",
                       scale_list: Tuple[int, ...] = (0, 8, 16),
                       ms_scale_bias: float = 0.0,
                       bucketed: bool = False, fast: bool = False,
                       verbosity: int = 0, device=None) -> ImagingResult:
    """Run the major/minor-cycle imaging solve on ``device`` (``None``:
    the CUDA card, or the mesh's; CPU runs pass ``device="cpu"``).

    ``vis`` [rows, chan] complex and ``weights`` [rows, chan] are NumPy
    arrays or tensors; ``uvw`` [rows, 3] is NumPy or a tensor on any
    device (the planners run on the host, and the device drivers take it
    in f64).
    ``bucketed`` picks the operator path (module docstring). ``mgain``
    bounds each minor cycle at ``max(threshold, (1 - mgain) *
    dirty_peak)``; ``fast=True`` runs the packed kernels on bf16 bands.
    ``clean_algorithm`` is "hogbom" or "msclean" (multi-scale minor cycles
    over ``scale_list``, with the small-scale selection bias
    ``ms_scale_bias``; 0 is the reference's unbiased selection).
    ``checkpoint_path`` (a single ``.npz``) or ``checkpointer`` (a
    :class:`~.checkpoint.SolverCheckpointer`; pass at most one) saves the
    solver state after every major cycle and resumes from it on a
    restart.
    ``verbosity > 0`` logs a per-stage timing report after the solve
    (the reference driver's report_timing,
    sdp_grid_wstack_wtower.cpp:169-213), timed with CUDA events on a
    CUDA device.
    ``mesh``: every rank of the process mesh passes the whole ``vis``,
    ``uvw`` and ``weights`` and gets the same result (module docstring);
    ``bucketed=True`` on a mesh needs a geometry the packed path can
    express.
    """
    if clean_algorithm not in ("hogbom", "msclean"):
        raise ValueError(f"unknown clean_algorithm {clean_algorithm!r}")
    if checkpoint_path is not None and checkpointer is not None:
        raise ValueError(
            "pass at most one of checkpoint_path / checkpointer")

    image_size = plan.image_size
    uvw = host_uvw(uvw)
    vis = to_device(vis, _solver_device(mesh, device))
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
        # bucketed per-task fallback (one device only). On a mesh the
        # block stream pads to a multiple of the rank count.
        pad_to = 1 if mesh is None else mesh_axis(mesh)[0]
        try:
            packed = tuple(
                packed_gridder(plan_packed(p, uvw, pad_blocks_to=pad_to),
                               fast=fast, device=dev)
                for p in (plan, psf_plan))
        except SdpInvalidArgumentError:
            if mesh is not None:
                raise ValueError(
                    "bucketed=True with mesh requires a packed-compatible "
                    "geometry (subgrid_size % 128 == 0, support <= 8)")
            bplan, sort_index, valid = plan_bucketed(plan, uvw)
            psf_bplan, psf_sort, psf_valid = plan_bucketed(psf_plan, uvw)
            bucket = dict(
                bplan=bplan, sort=sort_index, valid=valid,
                inv=inverse_index_of(sort_index, valid, vis.numel()),
                psf_bplan=psf_bplan, psf_sort=psf_sort, psf_valid=psf_valid)
    uvw_dev = torch.as_tensor(uvw, device=dev)
    shard = None
    if mesh is not None and packed is None:
        shard, uvw_dev, vis, weights = _row_block(
            plan, mesh, uvw_dev, vis,
            None if weights is None else to_device(weights, dev))

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
        if mesh is not None:
            # Each rank's block of the sorted stream; the residuals stay
            # there.
            gri, psf_gri = (_MeshDrivers(g, mesh) for g in packed)
        psf = psf_gri.grid(psf_vis_grid)
        vre, vim = gri.sort(vis)
        w_sorted = None if psf_vis is None else gri.sort(psf_vis)[0]
    elif bucket is not None:
        psf = grid_all_bucketed(bucket["psf_bplan"], psf_vis_grid, uvw_dev,
                                bucket["psf_sort"], bucket["psf_valid"],
                                device=dev)
    else:
        psf = _grid(psf_plan, psf_vis_grid, uvw_dev, shard)
    peak = psf[image_size, image_size]  # centre of the 2N PSF
    psf = _norm_mask(psf, peak, 2 * border)
    if timers:
        timers.pop()

    if clean_algorithm == "msclean":
        minor = _make_msclean_minor(psf, tuple(int(s) for s in scale_list),
                                    float(loop_gain), int(cycle_limit),
                                    float(ms_scale_bias))
    else:
        def minor(dirty, stop):
            return _minor_cycle(dirty, psf, float(loop_gain), stop,
                                int(cycle_limit))

    model = torch.zeros((image_size, image_size), dtype=rdtype, device=dev)
    residual_img = torch.zeros_like(model)
    peak_history: List[float] = []
    start_cycle = 0
    state = None
    if checkpoint_path is not None:
        # .checkpoint imports this module (ImagingResult).
        from .checkpoint import load_state, save_state

        if os.path.exists(checkpoint_path):
            state = load_state(checkpoint_path, device=dev)
    elif checkpointer is not None and checkpointer.latest_step() is not None:
        state = checkpointer.restore(
            template={"model": model, "residual": residual_img})
    if state is not None:
        model, residual_img, start_cycle, peak_history, _ = state
        model, residual_img = model.to(rdtype), residual_img.to(rdtype)
    threshold_t = torch.as_tensor(threshold, dtype=rdtype, device=dev)
    mgain_t = torch.as_tensor(mgain, dtype=rdtype, device=dev)
    for cycle in range(start_cycle, n_major):
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
                pred = _degrid(plan, model, uvw_dev, vis.dtype, shard)
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
                raw = _grid(plan, res_vis, uvw_dev, shard)
        dirty = _norm_mask(raw, peak, border)
        if timers:
            timers.pop_push("minor cycle")
        stop = _stop_level(dirty, threshold_t, mgain_t)
        delta, residual_img = minor(dirty, stop)
        model = model + delta
        peak_history.append(float(residual_img.abs().max()))
        if timers:
            timers.pop()
        if checkpoint_path is not None:
            save_state(checkpoint_path, model, residual_img, cycle + 1,
                       peak_history)
        elif checkpointer is not None:
            checkpointer.save(cycle + 1, model, residual_img, peak_history)
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
