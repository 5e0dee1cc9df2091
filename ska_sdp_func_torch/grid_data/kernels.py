"""Gridding-kernel construction: window -> oversampled Fourier kernel.

Counterpart of ska_sdp_func_tpu.grid_data.kernels (reference:
sdp_gridder_utils.cpp:385-425, 1329-1381). Kernel tables, their
Chebyshev fits and the w-pattern are plan-time NumPy f64;
:func:`eval_kernel_taps` is the device-side tap evaluation in torch f32.
"""

import numpy as np
import torch

from ..fourier_transforms.pswf import generate_pswf
from ..utility.errors import SdpInvalidArgumentError


def make_kernel(window: np.ndarray, oversampling: int) -> np.ndarray:
    """Convert an image-space window to an oversampled uv-space kernel.

    Output shape ``(oversampling + 1, support)``; row ``i`` holds the
    kernel for fractional offset du = (i - oversampling)/oversampling,
    column ``s`` the tap at u = (s - support//2) - du:
    ``kernel[i, s] = (1/S) sum_k window[k] cos(2 pi u l_k)``,
    ``l_k = (k - S//2) / S``.
    """
    window = np.asarray(window, dtype=np.float64)
    if window.ndim != 1:
        raise SdpInvalidArgumentError("window must be 1D")
    support = window.shape[0]
    half_support = support // 2
    du = np.arange(oversampling + 1, dtype=np.float64) - oversampling
    s_out = np.arange(support, dtype=np.float64) - half_support
    u = s_out[None, :] - du[:, None] / oversampling
    l = (np.arange(support, dtype=np.float64) - half_support) / support
    phases = 2.0 * np.pi * u[:, :, None] * l[None, None, :]
    return np.cos(phases) @ window / support


def make_pswf_kernel(support: int, vr_size: int,
                     oversampling: int) -> np.ndarray:
    """Oversampled kernel from a PSWF window with c = support*pi/2
    (first sample 1e-15 for even ``vr_size``). Shape
    ``(oversampling + 1, vr_size)``."""
    window = generate_pswf(0, support * (np.pi / 2), vr_size,
                           end_correction=True)
    return make_kernel(window, oversampling)


def kernel_tap_coeffs(support: int, vr_size: int, oversampling: int,
                      degree: int = 11) -> np.ndarray:
    """Chebyshev coefficients ``[degree+1, support]`` (f64) of each
    kernel tap as a function of the fractional offset row in [0, 1]."""
    table = make_pswf_kernel(support, vr_size, oversampling)
    x = 2.0 * (np.arange(oversampling + 1) / oversampling) - 1.0
    return np.polynomial.chebyshev.chebfit(x, table, degree)


def eval_kernel_taps(row: torch.Tensor, coeffs,
                     oversampling: int) -> torch.Tensor:
    """f32 Clenshaw evaluation of the tap polynomials.

    row: integer tensor [V] (oversampled kernel row, 0..oversampling);
    coeffs: NumPy or tensor [degree+1, support], rounded to f32. Returns
    f32 [V, support] on row's device, with the same f32 operation order
    as the JAX version.
    """
    x = (2.0 / oversampling) * row.to(torch.float32) - 1.0
    x = x[:, None]
    c = torch.as_tensor(coeffs).to(device=row.device, dtype=torch.float32)
    b1 = torch.zeros((x.shape[0], c.shape[1]), dtype=torch.float32,
                     device=row.device)
    b2 = torch.zeros_like(b1)
    for k in range(c.shape[0] - 1, 0, -1):
        b1, b2 = c[k] + 2.0 * x * b1 - b2, b1
    return c[0] + x * b1 - b2


def lm_to_n(l, m, shear_u: float, shear_v: float):
    """(l, m) -> n direction cosine, allowing for shear (elementwise on
    NumPy arrays; sdp_gridder_utils.h:397-412)."""
    if shear_u == 0.0 and shear_v == 0.0:
        return (1 - l * l - m * m) ** 0.5 - 1
    hul_hvm_1 = shear_u * l + shear_v * m - 1
    hu2_hv2_1 = shear_u * shear_u + shear_v * shear_v + 1
    return (
        (hul_hvm_1 * hul_hvm_1 - hu2_hv2_1 * (l * l + m * m)) ** 0.5
        + hul_hvm_1
    ) / hu2_hv2_1


def make_w_pattern(subgrid_size: int, theta: float, shear_u: float,
                   shear_v: float, w_step: float) -> np.ndarray:
    """``exp(+2 pi i w_step n(l, m))`` over the sub-grid, complex128
    (sdp_gridder_utils.cpp:1353-1381)."""
    half = subgrid_size // 2
    l = (np.arange(subgrid_size) - half) * theta / subgrid_size
    ll, mm = np.meshgrid(l, l, indexing="ij")
    n = lm_to_n(ll, mm, shear_u, shear_v)
    return np.exp(2j * np.pi * w_step * n)
