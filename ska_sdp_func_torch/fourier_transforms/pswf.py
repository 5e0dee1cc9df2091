"""Prolate spheroidal wave functions (PSWF).

Counterpart of ska_sdp_func_tpu.fourier_transforms.pswf. Two paths:

- host (plan time, NumPy f64): `scipy.special.pro_ang1`, bit-matching
  the reference's specfun numerics (sdp_pswf.cpp:569-601); the kernels
  and grid corrections consume the sampled tables;
- device: the Legendre expansion S_00(c, x) = sum_r d_r P_r(x), its
  coefficients from the Bouwkamp three-term recurrence eigenproblem
  (Flammer 1957, eq. 3.1.4; :func:`pswf_coefficients`, on the host) and
  the sum evaluated by the Legendre recurrence on tensors
  (:func:`pswf_evaluate`, one elementwise step a term).
"""

from functools import lru_cache

import numpy as np
import torch

from ..utility.errors import SdpInvalidArgumentError
from ..utility.tensors import on_device


def _pro_ang1(m: int, n: int, c: float, x):
    """scipy prolate angular function of the first kind, elementwise;
    zero outside |x| < 1 (sdp_pswf.cpp:680-685)."""
    from scipy.special import pro_ang1

    x = np.asarray(x, dtype=np.float64)
    inside = np.abs(x) < 1.0
    safe = np.where(inside, x, 0.0)
    vals = pro_ang1(m, n, c, safe)[0]
    return np.where(inside, vals, 0.0)


def generate_pswf(m: int, c: float, size: int,
                  end_correction: bool = False) -> np.ndarray:
    """Sample the PSWF over ``size`` points, x_k = 2*(k - size//2)/size.

    The first sample (x = -1 for even size) is zero, or 1e-15 when
    ``end_correction`` is set (sdp_gridder_utils.cpp:1329-1350).
    """
    if size < 1:
        raise SdpInvalidArgumentError(f"size must be >= 1; got {size}")
    k = np.arange(size)
    x = 2.0 * (k - size // 2) / size
    out = _pro_ang1(m, m, c, x)
    if size % 2 == 0:
        out[0] = 1e-15 if end_correction else 0.0
    return out


def pswf_evaluate_host(m: int, c: float, x) -> np.ndarray:
    """Pointwise host evaluation; zero outside |x| < 1."""
    return _pro_ang1(m, m, c, x)


@lru_cache(maxsize=64)
def _coefficients_cached(c: float, num_terms: int) -> tuple:
    from scipy.linalg import eigh_tridiagonal
    from scipy.special import gammaln

    r = np.arange(0, 2 * num_terms, 2).astype(np.float64)
    c2 = c * c
    # Bouwkamp recurrence coefficients for m = 0, even r (of d_{r+2}, the
    # diagonal term and d_{r-2}).
    upper = (r + 2) * (r + 1) * c2 / ((2 * r + 3) * (2 * r + 5))
    diag = r * (r + 1) + (2 * r * (r + 1) - 1) * c2 / (
        (2 * r - 1) * (2 * r + 3))
    lower = r * (r - 1) * c2 / ((2 * r - 3) * (2 * r - 1))
    # Symmetrise (the products upper[k] * lower[k+1] are positive).
    off = np.sqrt(upper[:-1] * lower[1:])
    _, vecs = eigh_tridiagonal(diag, off, select="i", select_range=(0, 0))
    v = vecs[:, 0]
    scale = np.ones(num_terms)
    scale[1:] = np.cumprod(np.sqrt(lower[1:] / upper[:-1]))
    d = v * scale
    # Flammer normalisation for n = m = 0: S(0) = P_0(0) = 1.
    log_fac = gammaln(r + 1) - r * np.log(2.0) - 2 * gammaln(r / 2 + 1)
    fac = ((-1.0) ** (r / 2)) * np.exp(log_fac)
    d = d / np.dot(fac, d)
    return tuple(d)


def pswf_coefficients(c: float, num_terms: int = 150) -> np.ndarray:
    """Legendre expansion coefficients d_r (even r) of S_00(c, x)."""
    return np.asarray(_coefficients_cached(float(c), int(num_terms)))


def _legendre_even_sum(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """sum_k d[k] P_{2k}(x) by the Legendre three-term recurrence (JAX's
    ``lax.scan`` over the terms, here a loop)."""
    def step(p_prev, p_curr, n):
        """(P_n, P_{n+1}) from (P_{n-1}, P_n)."""
        return p_curr, ((2.0 * n + 1.0) * x * p_curr - n * p_prev) / (n + 1.0)

    p_prev, p_curr = torch.ones_like(x), x          # P_0, P_1
    acc = d[0] * p_prev
    for k in range(1, d.shape[0]):
        p_prev, p_curr = step(p_prev, p_curr, 2 * k - 1)
        acc = acc + d[k] * p_curr                   # d_k P_{2k}
        p_prev, p_curr = step(p_prev, p_curr, 2 * k)
    return acc


def pswf_evaluate(x, coefficients, device=None) -> torch.Tensor:
    """PSWF from its Legendre coefficients on ``device`` (None: the CUDA
    card), in ``x``'s dtype; 0 for |x| >= 1."""
    (x,) = on_device(x, device=device)
    d = torch.as_tensor(coefficients).to(device=x.device, dtype=x.dtype)
    inside = x.abs() < 1.0
    vals = _legendre_even_sum(torch.where(inside, x, torch.zeros_like(x)), d)
    return torch.where(inside, vals, torch.zeros_like(vals))


class Pswf:
    """PSWF plan: caches samples and expansion coefficients.

    Mirrors `sdp_Pswf` (sdp_pswf.h:62-97): made from (m, c), it emits
    sampled values (:meth:`values`, host) and evaluates pointwise
    (:meth:`evaluate`, host); :attr:`coefficients` and
    :meth:`evaluate_device` are the device path (m = 0 only).
    """

    def __init__(self, m: int, c: float):
        self.m = int(m)
        self.c = float(c)
        self._values = {}

    def values(self, size: int, end_correction: bool = False) -> np.ndarray:
        key = (size, end_correction)
        if key not in self._values:
            self._values[key] = generate_pswf(
                self.m, self.c, size, end_correction)
        return self._values[key]

    def evaluate(self, x) -> np.ndarray:
        return pswf_evaluate_host(self.m, self.c, x)

    @property
    def coefficients(self) -> np.ndarray:
        if self.m != 0:
            raise SdpInvalidArgumentError(
                "device-path coefficients only implemented for m = 0")
        return pswf_coefficients(self.c)

    def evaluate_device(self, x, device=None) -> torch.Tensor:
        return pswf_evaluate(x, self.coefficients, device=device)
