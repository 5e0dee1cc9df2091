"""Batched FFTs (planned and shifted), FFT size padding and the PSWF
(host sampler and device Legendre evaluation)."""

from .fft import (
    Fft,
    fft_norm,
    fft_phase,
    fft_shifted,
    ifft_shifted,
    ifft_shifted_norm,
    padded_fft_size,
)
from .pswf import (
    Pswf,
    generate_pswf,
    pswf_coefficients,
    pswf_evaluate,
    pswf_evaluate_host,
)

__all__ = [
    "Fft",
    "Pswf",
    "fft_norm",
    "fft_phase",
    "fft_shifted",
    "generate_pswf",
    "ifft_shifted",
    "ifft_shifted_norm",
    "padded_fft_size",
    "pswf_coefficients",
    "pswf_evaluate",
    "pswf_evaluate_host",
]
