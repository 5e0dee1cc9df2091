"""Element beams: analytic dipole and spherical-wave (HARP) patterns.

Counterpart of ska_sdp_func_tpu.station_beam.element (reference
station_beam/sdp_element_dipole.{h,cpp,cu} and
sdp_element_spherical_wave_harp.{h,cpp}). The reference writes into
strided slots of a caller's array; these return an updated copy, keeping
the stride / offset API. They run on ``device`` (None: the CUDA card) and
move their inputs there.
"""

import math
from typing import Tuple

import torch

from ..utility.constants import C_0
from ..utility.data_model import is_complex
from ..utility.errors import SdpDataTypeError
from ..utility.tensors import on_device


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.complex64)


def _dipole_e(kl, cos_kl, phi, sin_theta, cos_theta):
    """E_theta, E_phi of a dipole (sdp_dipole,
    sdp_element_dipole.cpp:16-41), real."""
    cos_phi = torch.cos(phi)
    denom = 1.0 + cos_phi * cos_phi * (cos_theta * cos_theta - 1.0)
    zero = denom == 0
    temp = (torch.cos(kl * cos_phi * sin_theta) - cos_kl) \
        / torch.where(zero, 1.0, denom)
    e_theta = torch.where(zero, 0.0, -cos_phi * cos_theta * temp)
    e_phi = torch.where(zero, 0.0, torch.sin(phi) * temp)
    return e_theta, e_phi


def _kl(freq_hz: float, dipole_length_m: float):
    kl = dipole_length_m * (math.pi * freq_hz / C_0)
    return kl, math.cos(kl)


def dipole_pattern(theta_rad, phi_rad, freq_hz: float,
                   dipole_length_m: float,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polarised dipole response: complex (E_theta, E_phi) per point
    (sdp_dipole_pattern, sdp_element_dipole.cpp:44-66)."""
    theta, phi = on_device(theta_rad, phi_rad, device=device)
    kl, cos_kl = _kl(freq_hz, dipole_length_m)
    e_theta, e_phi = _dipole_e(kl, cos_kl, phi, torch.sin(theta),
                               torch.cos(theta))
    cdtype = _complex_of(theta.dtype)
    return e_theta.to(cdtype), e_phi.to(cdtype)


def dipole_pattern_scalar(theta_rad, phi_rad, freq_hz: float,
                          dipole_length_m: float,
                          device=None) -> torch.Tensor:
    """Unpolarised dipole amplitude: the RMS over two crossed dipoles
    (sdp_dipole_pattern_scalar, sdp_element_dipole.cpp:69-98)."""
    theta, phi = on_device(theta_rad, phi_rad, device=device)
    kl, cos_kl = _kl(freq_hz, dipole_length_m)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    x_th, x_ph = _dipole_e(kl, cos_kl, phi, sin_t, cos_t)
    y_th, y_ph = _dipole_e(kl, cos_kl, phi + math.pi / 2, sin_t, cos_t)
    amp = torch.sqrt((x_th ** 2 + x_ph ** 2 + y_th ** 2 + y_ph ** 2) / 2.0)
    return amp.to(_complex_of(theta.dtype))


def dipole(theta_rad, phi_rad, freq_hz: float, dipole_length_m: float,
           stride_element_beam: int, index_offset_element_beam: int,
           element_beam, device=None) -> torch.Tensor:
    """A dipole element beam written into a strided copy of
    ``element_beam`` (`sdp_element_beam_dipole`, sdp_element_dipole.h;
    impl :101-240): a 4-pol output (stride 4) takes (E_theta, E_phi) at
    ``index_offset_element_beam`` and ``+1``; a scalar one (stride 1) the
    RMS amplitude. Returns the updated array."""
    if not is_complex(element_beam.dtype):
        raise SdpDataTypeError("element_beam must be complex")
    theta, phi, element_beam = on_device(theta_rad, phi_rad, element_beam,
                                         device=device)
    flat = element_beam.reshape(-1).clone()
    pos = torch.arange(theta.shape[0], device=flat.device) \
        * stride_element_beam + index_offset_element_beam
    if stride_element_beam == 4 or (element_beam.ndim == 2
                                    and element_beam.shape[-1] == 4):
        e_theta, e_phi = dipole_pattern(theta, phi, freq_hz,
                                        dipole_length_m, device=flat.device)
        flat[pos] = e_theta.to(flat.dtype)
        flat[pos + 1] = e_phi.to(flat.dtype)
    else:
        flat[pos] = dipole_pattern_scalar(
            theta, phi, freq_hz, dipole_length_m,
            device=flat.device).to(flat.dtype)
    return flat.reshape(element_beam.shape)


def _legendre2(l: int, m: int, cos_t, sin_t):
    """P_l^m(cos), P/sin and dP*sin (`sdp_legendre2`,
    math/sdp_legendre_polynomial.h:10-57); l, m static. The three-term
    recurrence from p0 = P_m^m ascends to P_l^m, keeping P_{l+1}^m for
    the derivative."""
    p0 = torch.ones_like(cos_t)
    if m > 0:
        fact = 1.0
        for _ in range(m):
            p0 = p0 * (-fact) * sin_t
            fact += 2.0
    p1 = cos_t * (2 * m + 1) * p0  # P_{m+1}^m
    for i in range(m + 2, l + 2):
        p0, p1 = p1, ((2 * i - 1) * cos_t * p1 - (i + m - 1) * p0) / (i - m)
    # Now p0 = P_l^m and p1 = P_{l+1}^m (for l == m the loop is empty).
    nonzero = sin_t != 0
    safe = torch.where(nonzero, sin_t, 1.0)
    out1 = torch.where(nonzero, p0 / safe, 0.0)
    out2 = torch.where(
        nonzero, (cos_t * p0 * (l + 1) - p1 * (l - m + 1)) / safe, 0.0)
    return p0, out1, out2


def spherical_wave_harp(theta_rad, phi_x_rad, phi_y_rad, l_max: int,
                        coeffs, index_offset_element_beam: int = 0,
                        element_beam=None, device=None) -> torch.Tensor:
    """Spherical-wave (HARP) element beam
    (`sdp_element_beam_spherical_wave_harp`,
    sdp_element_spherical_wave_harp.cpp:128-233, algorithm :29-125): the
    TE/TM spherical harmonics up to order ``l_max`` summed for the X and
    Y antennas. ``coeffs`` is complex, 4 entries (te_x, tm_x, te_y, tm_y)
    a (l, m) mode, flat length ``4 * ((l_max + 1)^2 - 1)``.

    Returns ``complex[num_points, 4]`` ordered (x_phi, x_theta, y_phi,
    y_theta), the reference's component reversal, written into a copy of
    ``element_beam`` at ``index_offset_element_beam`` if one is given. A
    NaN ``phi_x`` makes the point's four components NaN.
    """
    theta, phi_x, phi_y, alpha, element_beam = on_device(
        theta_rad, phi_x_rad, phi_y_rad, coeffs, element_beam,
        device=device)
    alpha = alpha.reshape(-1)
    cdtype = _complex_of(theta.dtype)

    theta = torch.clamp(theta, min=1e-5)  # divide-by-zero guard (:48)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    zeros = torch.zeros(theta.shape, dtype=cdtype, device=theta.device)
    x_theta, x_phi, y_theta, y_phi = zeros, zeros, zeros, zeros

    def harp_term(m_signed, a_te, a_tm, c_theta, c_phi, cos_p, sin_p, pds,
                  dpms):
        qq = torch.complex(-cos_p * dpms, -sin_p * dpms).to(cdtype)
        dd = torch.complex(-sin_p * pds * m_signed,
                           cos_p * pds * m_signed).to(cdtype)
        return c_theta + dd * a_tm + qq * a_te, c_phi + qq * a_tm - dd * a_te

    for l in range(1, l_max + 1):
        ind0 = l * l - 1 + l
        f_ = (2 * l + 1) / (4.0 * math.pi * l * (l + 1))
        for abs_m in range(l, -1, -1):
            _, pds, dpms = _legendre2(l, abs_m, cos_t, sin_t)
            if abs_m == 0:
                cos_p = torch.full_like(sin_t, math.sqrt(f_))
                sin_p = torch.zeros_like(sin_t)
                x_theta, x_phi = harp_term(
                    0.0, alpha[4 * ind0], alpha[4 * ind0 + 1], x_theta,
                    x_phi, cos_p, sin_p, pds, dpms)
                y_theta, y_phi = harp_term(
                    0.0, alpha[4 * ind0 + 2], alpha[4 * ind0 + 3], y_theta,
                    y_phi, cos_p, sin_p, pds, dpms)
                continue
            nf = math.sqrt(f_ * math.factorial(l - abs_m)
                           / math.factorial(l + abs_m))
            ind_m = 4 * (ind0 - abs_m)
            ind_p = 4 * (ind0 + abs_m)
            for ant, phi in ((0, phi_x), (2, phi_y)):
                p = -abs_m * phi
                sin_p = torch.sin(p) * nf
                cos_p = torch.cos(p) * nf
                c_theta, c_phi = (x_theta, x_phi) if ant == 0 \
                    else (y_theta, y_phi)
                c_theta, c_phi = harp_term(
                    -float(abs_m), alpha[ind_m + ant], alpha[ind_m + ant + 1],
                    c_theta, c_phi, cos_p, sin_p, pds, dpms)
                c_theta, c_phi = harp_term(
                    float(abs_m), alpha[ind_p + ant], alpha[ind_p + ant + 1],
                    c_theta, c_phi, cos_p, -sin_p, pds, dpms)
                if ant == 0:
                    x_theta, x_phi = c_theta, c_phi
                else:
                    y_theta, y_phi = c_theta, c_phi

    # NaN propagation from phi_x (reference :51-56).
    nan_mask = torch.isnan(phi_x)
    nan_val = torch.complex(phi_x, phi_x).to(cdtype)
    comps = [torch.where(nan_mask, nan_val, c)
             for c in (x_phi, x_theta, y_phi, y_theta)]
    # Theta / phi components reversed on output (reference :119-124).
    pattern = torch.stack(comps, dim=-1)
    if element_beam is None:
        return pattern
    flat = element_beam.reshape(-1, 4).clone()
    start = index_offset_element_beam
    flat[start:start + pattern.shape[0]] = pattern.to(flat.dtype)
    return flat.reshape(element_beam.shape)
