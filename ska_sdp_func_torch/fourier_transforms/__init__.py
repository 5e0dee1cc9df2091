"""Batched FFTs (planned and shifted), FFT size padding, the PSWF
(host sampler and device Legendre evaluation) and SwiFTly."""

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
    # lazy (PEP 562) export resolves in __getattr__ below
    "Swiftly",
]


def __getattr__(name):
    if name == "Swiftly":
        from .swiftly import Swiftly

        return Swiftly
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
