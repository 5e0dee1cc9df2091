"""Multi-scale CLEAN (Cornwell).

Counterpart of ska_sdp_func_tpu.clean.ms_clean (reference
clean/sdp_ms_clean_cornwell.{h,cpp}). Setup: Gaussian scale kernels
(sigma = 3/16 * scale, normalised 1/(2 pi sigma^2); a delta for scale 0;
sdp_create_scale_kern, sdp_ms_clean_cornwell.cpp:112-166), built in
NumPy f64 and cast; scale-convolved PSFs (each scale pair, two FFT
convolutions) and residuals; the coupling matrix, the max of each scaled
PSF (:518-549). Minor loop (:557-704): per-scale peak (strict ``> 0``
against a 0 start, else peak 0 at index 0), the scale chosen by
``argmax((peak / diag) * bias)``, the loop stopped when that scale's
RAW peak falls below the threshold, the gain taken on ``peak / diag``;
the scale-kernel window is added to the component model and the scaled
PSF cross-subtracted from every scale's residual. Finish: components
convolved with the clean beam + scale-0 residual.

Minor-cycle design: as :mod:`.hogbom`, the stop test is a device-side
``active`` flag that zeroes each step's update once it fails, read by the
host every ``_CHECK_EVERY`` steps; no host read per component.
``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does.
"""

from typing import Sequence, Tuple

import numpy as np
import torch

from ..numeric_functions.fft_convolution import fft_convolution
from ..utility.errors import SdpShapeError
from ..utility.tensors import as_tensors
from .hogbom import _CHECK_EVERY, create_cbeam


def _make_scale_kernels(scales, length: int, dtype,
                        device) -> torch.Tensor:
    """Gaussian scale kernels [num_scales, length, length] (NumPy f64,
    then cast to ``dtype`` on ``device``)."""
    kerns = []
    centre = length // 2
    x = np.arange(length) - centre
    dist2 = x[:, None] ** 2 + x[None, :] ** 2
    for scale in scales:
        if scale == 0:
            kern = np.zeros((length, length))
            kern[centre, centre] = 1.0
        else:
            sigma = (3.0 / 16.0) * scale
            two_sigma_sq = 2.0 * sigma * sigma
            kern = np.exp(-dist2 / two_sigma_sq) / (np.pi * two_sigma_sq)
        kerns.append(kern)
    return torch.as_tensor(np.stack(kerns), device=device).to(dtype)


def _ms_minor_cycle(scaled_residuals: torch.Tensor,
                    scaled_psfs: torch.Tensor,
                    scale_kernels: torch.Tensor, coupling: torch.Tensor,
                    loop_gain, threshold, cycle_limit: int,
                    scale_bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-scale minor cycle on the tensors' device.

    scaled_residuals: [S, N, N] real; scaled_psfs: [S, S, P, P] real
    (indexed [target_scale, peak_scale]); scale_kernels: [S, P, P] real.
    ``scale_bias`` (optional [S] vector) multiplies the per-scale
    selection score only; the subtracted gain stays the unbiased
    coupling-corrected peak. Returns (scaled_residuals,
    clean_components).
    """
    num_scales, size, _ = scaled_residuals.shape
    dtype, dev = scaled_residuals.dtype, scaled_residuals.device
    loop_gain = torch.as_tensor(loop_gain, dtype=dtype, device=dev)
    threshold = torch.as_tensor(threshold, dtype=dtype, device=dev)
    diag = torch.diagonal(coupling)
    sel_bias = (torch.ones((num_scales,), dtype=dtype, device=dev)
                if scale_bias is None
                else torch.as_tensor(np.asarray(scale_bias), device=dev).to(
                    dtype))
    residuals = scaled_residuals.clone()
    flat = residuals.view(num_scales, -1)
    model = torch.zeros((size, size), dtype=dtype, device=dev)
    offs = torch.arange(size, device=dev)
    active = torch.ones((1,), dtype=torch.bool, device=dev)
    for cycle in range(int(cycle_limit)):
        if cycle and cycle % _CHECK_EVERY == 0 and not bool(active):
            break
        idx = torch.argmax(flat, dim=1)
        peak = flat.gather(1, idx[:, None])[:, 0]
        pos = peak > 0
        peak = torch.where(pos, peak, torch.zeros_like(peak))
        idx = torch.where(pos, idx, torch.zeros_like(idx))
        biased = peak / diag
        scale = torch.argmax(biased * sel_bias).reshape(1)
        # The stop test reads the chosen scale's raw peak.
        active = active & (peak.gather(0, scale) >= threshold)
        gain = loop_gain * biased.gather(0, scale) * active.to(dtype)
        flat_idx = idx.gather(0, scale)
        # Windows [N - x : 2N - x, N - y : 2N - y] of the P-sized kernel
        # and scaled PSFs, gathered without a host read.
        rows = (size - flat_idx // size + offs)[:, None]
        cols = (size - flat_idx % size + offs)[None, :]
        kern = scale_kernels.index_select(0, scale)[0]
        model += gain * kern[rows, cols]
        psf_col = scaled_psfs.index_select(1, scale)[:, 0]
        residuals -= gain * psf_col[:, rows, cols]
    return residuals, model


def _scaled_psfs(psf: torch.Tensor, scale_kernels: torch.Tensor, conv):
    """psf (*) kern_s (*) kern_p for each scale pair, [S, S, P, P] real in
    psf's dtype, and the coupling matrix (the max of each)."""
    cdtype = torch.promote_types(psf.dtype, torch.complex64)
    num_scales = scale_kernels.shape[0]
    once = [conv(psf.to(cdtype), scale_kernels[s].to(cdtype))
            for s in range(num_scales)]
    scaled = torch.stack([
        torch.stack([conv(once[s], scale_kernels[p].to(cdtype)).real
                     for p in range(num_scales)])
        for s in range(num_scales)]).to(psf.dtype)
    coupling = scaled.reshape(num_scales, num_scales, -1).max(dim=-1).values
    return scaled, coupling


def _scaled_residuals(dirty: torch.Tensor, scale_kernels: torch.Tensor,
                      conv) -> torch.Tensor:
    """dirty (*) kern_s for each scale, [S, N, N] real in dirty's dtype."""
    cdtype = torch.promote_types(dirty.dtype, torch.complex64)
    return torch.stack([conv(dirty.to(cdtype), k.to(cdtype)).real
                        for k in scale_kernels]).to(dirty.dtype)


def ms_clean_cornwell(dirty_img, psf, cbeam_details,
                      scale_list: Sequence[int], loop_gain: float,
                      threshold: float, cycle_limit: int, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-scale CLEAN; returns ``(clean_model, residual, skymodel)``
    (sdp_ms_clean_cornwell.h:41-53). NumPy images go to the first
    tensor's device, or to ``device`` (None: the CUDA card) when neither
    is a tensor. Keeps the reference's raw even-size convolution
    alignment (the solver's minor cycle re-registers it)."""
    dirty_img, psf = as_tensors(dirty_img, psf, device=device)
    if dirty_img.ndim != 2:
        raise SdpShapeError("dirty image must be 2D")
    size = int(dirty_img.shape[0])
    psf_dim = int(psf.shape[0])
    if psf_dim < 2 * size:
        raise SdpShapeError(
            f"psf (size {psf_dim}) must be at least twice the dirty image "
            f"size ({size})")
    psf = psf.to(dirty_img.dtype)
    scale_kernels = _make_scale_kernels(np.asarray(scale_list, np.int64),
                                        psf_dim, dirty_img.dtype,
                                        dirty_img.device)
    scaled_psfs, coupling = _scaled_psfs(psf, scale_kernels,
                                         fft_convolution)
    residuals, model = _ms_minor_cycle(
        _scaled_residuals(dirty_img, scale_kernels, fft_convolution),
        scaled_psfs, scale_kernels, coupling, float(loop_gain),
        float(threshold), int(cycle_limit))

    details = np.asarray(cbeam_details, dtype=np.float64)
    cbeam = create_cbeam(torch.as_tensor(details, dtype=dirty_img.dtype,
                                         device=dirty_img.device), psf_dim)
    convolved = fft_convolution(model, cbeam)
    residual_out = residuals[0]
    skymodel = convolved.real.to(dirty_img.dtype) + residual_out
    return model, residual_out, skymodel
