"""FFT-based 2-D convolution, `same`-size output.

Counterpart of ska_sdp_func_tpu.numeric_functions.fft_convolution
(reference sdp_fft_convolution.cpp:84-107): pad both square inputs to the
next power of two >= n1 + n2 - 1, FFT, multiply, normalised inverse FFT,
fftshift, crop to in1's size with the reference's (extra - 1) offset.
"""

import torch

from ..utility.errors import SdpShapeError


def _next_pow2(n: int) -> int:
    while n & (n - 1):
        n += 1
    return n


def fft_convolution(in1: torch.Tensor, in2: torch.Tensor) -> torch.Tensor:
    """Convolve two square 2-D tensors; the output has in1's shape
    (scipy.signal.convolve 'same' semantics)."""
    if in1.ndim != 2 or in1.shape[0] != in1.shape[1]:
        raise SdpShapeError("in1 must be square 2D")
    if in2.ndim != 2 or in2.shape[0] != in2.shape[1]:
        raise SdpShapeError("in2 must be square 2D")
    if not in1.is_complex():
        in1 = in1.to(torch.complex128 if in1.dtype == torch.float64
                      else torch.complex64)
    in2 = in2.to(device=in1.device, dtype=in1.dtype)
    n1, n2 = int(in1.shape[0]), int(in2.shape[0])
    pad = _next_pow2(n1 + n2 - 1)
    extra1 = (pad - n1) // 2
    extra2 = (pad - n2) // 2
    p1 = in1.new_zeros((pad, pad))
    p1[extra1:extra1 + n1, extra1:extra1 + n1] = in1
    p2 = in1.new_zeros((pad, pad))
    p2[extra2:extra2 + n2, extra2:extra2 + n2] = in2
    result = torch.fft.ifft2(torch.fft.fft2(p1) * torch.fft.fft2(p2))
    result = torch.fft.fftshift(result)
    # The crop start is clamped into range, as jax.lax.dynamic_slice does.
    lo = min(max(extra1 - 1, 0), pad - n1)
    return result[lo:lo + n1, lo:lo + n1]
