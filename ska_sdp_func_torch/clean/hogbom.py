"""Hogbom CLEAN.

Counterpart of ska_sdp_func_tpu.clean.hogbom (reference
clean/sdp_hogbom_clean.cpp:33-280): find the residual peak, record
``loop_gain * peak`` as a component, subtract the shifted scaled PSF,
repeat until the threshold or the cycle limit; the restore convolves the
model with an elliptical-Gaussian clean beam.

Minor-cycle design. JAX runs the loop as one on-device ``while_loop``.
A torch loop that tested the stop condition with ``.item()`` would wait
for the device on every component. Here each step instead multiplies its
update by a device-side ``active`` flag, ``active &= peak >= threshold``:
once the residual peak falls below the threshold the step adds exactly
zero, the residual stops changing and the flag stays false, so running
further steps gives the JAX loop's result. The host reads the flag only
every ``_CHECK_EVERY`` steps to cut the tail, so a minor cycle waits for
the device at most ``cycle_limit / _CHECK_EVERY`` times. The peak is
taken with ``torch.argmax``, which like ``jnp.argmax`` returns the first
maximum, so components come in the same order.
"""

from typing import Tuple

import numpy as np
import torch

from ..numeric_functions.fft_convolution import fft_convolution
from ..utility.errors import SdpShapeError


def create_cbeam(cbeam_details, size: int) -> torch.Tensor:
    """Elliptical Gaussian clean beam [size, size] (sdp_create_cbeam,
    sdp_hogbom_clean.cpp:33-80); details = [bmaj, bmin, theta_deg, ...],
    computed in the details' dtype on their device."""
    details = torch.as_tensor(cbeam_details)
    if details.ndim != 1 or details.shape[0] < 3:
        raise SdpShapeError(
            "create_cbeam: cbeam_details must be a vector "
            f"[bmaj, bmin, theta_deg, ...]; got {tuple(details.shape)}")
    sigma_x = details[0]
    sigma_y = details[1]
    theta = (np.pi / 180.0) * details[2]
    a = (torch.cos(theta) ** 2 / (2 * sigma_x ** 2)
         + torch.sin(theta) ** 2 / (2 * sigma_y ** 2))
    b = (torch.sin(2 * theta) / (4 * sigma_x ** 2)
         - torch.sin(2 * theta) / (4 * sigma_y ** 2))
    c = (torch.sin(theta) ** 2 / (2 * sigma_x ** 2)
         + torch.cos(theta) ** 2 / (2 * sigma_y ** 2))
    x = torch.arange(int(size), dtype=details.dtype,
                     device=details.device) - int(size) // 2
    xx, yy = torch.meshgrid(x, x, indexing="ij")
    return torch.exp(-(a * xx ** 2 + 2 * b * xx * yy + c * yy ** 2))


# Steps between host reads of the device-side stop flag.
_CHECK_EVERY = 32


def _minor_cycle(dirty: torch.Tensor, psf: torch.Tensor, loop_gain,
                 threshold, cycle_limit: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hogbom minor cycle on the tensors' device; returns
    (clean_model, residual). See the module docstring for the stop
    test."""
    size = dirty.shape[0]
    dtype, dev = dirty.dtype, dirty.device
    loop_gain = torch.as_tensor(loop_gain, dtype=dtype, device=dev)
    threshold = torch.as_tensor(threshold, dtype=dtype, device=dev)
    residual = dirty.clone()
    model = torch.zeros_like(dirty)
    flat_res = residual.view(-1)
    flat_model = model.view(-1)
    offs = torch.arange(size, device=dev)
    active = torch.ones((1,), dtype=torch.bool, device=dev)
    for cycle in range(int(cycle_limit)):
        if cycle and cycle % _CHECK_EVERY == 0 and not bool(active):
            break
        flat_idx = torch.argmax(residual).reshape(1)
        peak = flat_res.index_select(0, flat_idx)
        active = active & (peak >= threshold)
        gain = loop_gain * peak * active.to(dtype)
        flat_model.index_add_(0, flat_idx, gain)
        # PSF window psf[N - x : 2N - x, N - y : 2N - y] of the 2N PSF
        # (sdp_hogbom_clean.cpp:217-240), gathered without a host read.
        x = flat_idx // size
        y = flat_idx % size
        window = psf[(size - x + offs)[:, None], (size - y + offs)[None, :]]
        residual -= gain * window
    return model, residual


def hogbom_clean(dirty_img: torch.Tensor, psf: torch.Tensor, cbeam_details,
                 loop_gain: float, threshold: float, cycle_limit: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run Hogbom CLEAN; returns ``(clean_model, residual, skymodel)``
    (sdp_hogbom_clean.h:36-47). ``cbeam_details`` is
    ``[bmaj, bmin, theta_deg, size]``."""
    if dirty_img.ndim != 2:
        raise SdpShapeError("dirty image must be 2D")
    if psf.shape[0] < 2 * dirty_img.shape[0]:
        raise SdpShapeError(
            f"psf (size {psf.shape[0]}) must be at least twice the dirty "
            f"image size ({dirty_img.shape[0]})")
    details = np.asarray(cbeam_details, dtype=np.float64)
    model, residual = _minor_cycle(dirty_img, psf, float(loop_gain),
                                   float(threshold), int(cycle_limit))
    cbeam = create_cbeam(
        torch.as_tensor(details, dtype=dirty_img.dtype,
                        device=dirty_img.device), int(details[3]))
    convolved = fft_convolution(model, cbeam)
    skymodel = convolved.real.to(dirty_img.dtype) + residual
    return model, residual, skymodel
