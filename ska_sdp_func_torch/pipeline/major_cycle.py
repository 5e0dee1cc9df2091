"""Major-cycle CLEAN imaging solver (packed single-device path).

Counterpart of ska_sdp_func_tpu.pipeline.major_cycle for its
single-device ``bucketed=True`` packed branch (major_cycle.py:226-487):

    psf    = normalise(grid(1))                     (once, 2N)
    repeat n_major times:
        residual_vis = vis - degrid(model)          (sorted stream)
        dirty        = normalise(grid(residual_vis))
        delta, res   = hogbom_minor_cycle(dirty, psf)
        model       += delta
    restored = model * cbeam + res

Branches that are not ported raise ``NotImplementedError`` naming their
ROADMAP item; none is silently rerouted.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..clean.hogbom import _minor_cycle, create_cbeam
from ..numeric_functions.fft_convolution import fft_convolution
from ..parallel.packed import packed_gridder, plan_packed
from ..parallel.wstack import WStackPlan, plan_wstack
from ..utility.errors import SdpInvalidArgumentError
from ..utility.tensors import to_device


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
                       device="cpu") -> ImagingResult:
    """Run the major/minor-cycle imaging solve on ``device``.

    ``vis`` [rows, chan] complex and ``weights`` [rows, chan] are NumPy
    arrays or tensors; ``uvw`` [rows, 3] is NumPy or a CPU tensor (the
    planners run on the host). Only ``bucketed=True`` on one device with
    a packed-compatible geometry is ported. ``mgain`` bounds each minor
    cycle at ``max(threshold, (1 - mgain) * dirty_peak)``; ``fast=True``
    runs the kernels on bf16 bands.
    """
    if not bucketed:
        raise NotImplementedError(
            "bucketed=False (the per-task drivers, kernels K16/K17) is not "
            "ported yet: ROADMAP Queue 1 item 10")
    if mesh is not None:
        raise NotImplementedError(
            "multi-device solves are not ported yet: ROADMAP Queue 1 "
            "item 15")
    if checkpoint_path is not None or checkpointer is not None:
        raise NotImplementedError(
            "solver checkpointing is not ported yet: ROADMAP Queue 1 "
            "item 13")
    if clean_algorithm != "hogbom":
        raise NotImplementedError(
            f"clean_algorithm={clean_algorithm!r} is not ported yet "
            "(msclean: ROADMAP Queue 1 item 13)")

    image_size = plan.image_size
    uvw = np.asarray(uvw, np.float64)
    vis = to_device(vis, device)
    rdtype = vis.real.dtype
    psf_plan = make_psf_plan(plan, uvw)
    if border is None:
        border = image_size // 16
    try:
        pplan = plan_packed(plan, uvw)
        psf_pplan = plan_packed(psf_plan, uvw)
    except SdpInvalidArgumentError as exc:
        raise NotImplementedError(
            "this geometry needs the per-task bucketed fallback, which is "
            "not ported yet: ROADMAP Queue 1 item 16") from exc
    gri = packed_gridder(pplan, fast=fast, device=device)
    psf_gri = packed_gridder(psf_pplan, fast=fast, device=device)

    if weights is None:
        psf_vis = torch.ones_like(vis)
        w_sorted = None
    else:
        # The PSF uses the weights, the data the weighted visibilities;
        # the PSF-peak normalisation keeps the scale consistent.
        psf_vis = to_device(weights, device).to(vis.dtype)
        vis = vis * psf_vis
        w_sorted = gri.sort(psf_vis)[0]
    psf = psf_gri.grid(psf_vis)
    vre, vim = gri.sort(vis)
    peak = psf[image_size, image_size]  # centre of the 2N PSF
    psf = _norm_mask(psf, peak, 2 * border)

    model = torch.zeros((image_size, image_size), dtype=rdtype,
                        device=vis.device)
    residual_img = torch.zeros_like(model)
    peak_history: List[float] = []
    threshold_t = torch.as_tensor(threshold, dtype=rdtype, device=vis.device)
    mgain_t = torch.as_tensor(mgain, dtype=rdtype, device=vis.device)
    for _cycle in range(n_major):
        pred = gri.degrid_sorted(model)
        res_re, res_im = _packed_residual(vre, vim, pred, w_sorted)
        dirty = _norm_mask(gri.grid_sorted(res_re, res_im), peak, border)
        stop = _stop_level(dirty, threshold_t, mgain_t)
        delta, residual_img = _minor_cycle(dirty, psf, float(loop_gain),
                                           stop, int(cycle_limit))
        model = model + delta
        peak_history.append(float(residual_img.abs().max()))
        if peak_history[-1] < threshold:
            break

    cbeam = create_cbeam(
        torch.as_tensor(cbeam_details, dtype=rdtype, device=vis.device),
        int(cbeam_details[3]))
    restored = _restore(model, cbeam, residual_img)
    return ImagingResult(model=model, residual=residual_img,
                         restored=restored, peak_history=peak_history)
