"""Shifted FFTs, FFT size padding and the host PSWF sampler."""

from .fft import (
    fft_phase,
    fft_shifted,
    ifft_shifted,
    ifft_shifted_norm,
    padded_fft_size,
)
from .pswf import generate_pswf, pswf_evaluate_host

__all__ = [
    "fft_phase",
    "fft_shifted",
    "generate_pswf",
    "ifft_shifted",
    "ifft_shifted_norm",
    "padded_fft_size",
    "pswf_evaluate_host",
]
