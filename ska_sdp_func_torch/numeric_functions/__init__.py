"""Numeric helpers."""

from .fft_convolution import fft_convolution

__all__ = ["fft_convolution"]
