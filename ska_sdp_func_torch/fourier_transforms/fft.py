"""Batched shifted complex FFTs on ``torch.fft``.

Counterpart of ska_sdp_func_tpu.fourier_transforms.fft, with the
reference's conventions (sdp_fft.h:119-128, sdp_fft.cpp:640-666):

- transforms are UNNORMALISED in both directions, so the inverse is
  ``torch.fft.ifftn(..., norm="forward")`` (== N^d * numpy ifftn);
- the fftshift is multiplicative: a (-1)^(i+j) checkerboard before and
  after the transform (exact, and for even sizes equal to
  ``fftshift(fft(ifftshift(x)))``).

:class:`Fft` is the planned form (`sdp_Fft`, sdp_fft.h:22-66): on one
backend the plan is the transform's rank, direction and template shape.
"""

import torch

from ..utility.data_model import is_complex
from ..utility.errors import SdpDataTypeError, SdpInvalidArgumentError
from ..utility.tensors import as_tensors


def _check_complex(data) -> None:
    if not is_complex(data.dtype):
        raise SdpDataTypeError(f"FFT input must be complex; got {data.dtype}")


def _fft_nd(data: torch.Tensor, num_dims_fft: int,
            forward: bool) -> torch.Tensor:
    dims = tuple(range(data.ndim - num_dims_fft, data.ndim))
    if forward:
        return torch.fft.fftn(data, dim=dims)
    return torch.fft.ifftn(data, dim=dims, norm="forward")


def fft_phase(data: torch.Tensor) -> torch.Tensor:
    """Multiply by a (-1)^(i+j) checkerboard over the last two dims (the
    last dim for 1-D data); leading dims are batch (sdp_fft_phase)."""
    _check_complex(data)
    ndim = min(data.ndim, 2)
    parity = torch.zeros((), dtype=torch.int64, device=data.device)
    for axis, extent in enumerate(data.shape[-ndim:]):
        idx = torch.arange(extent, device=data.device)
        parity = parity + idx.reshape((-1,) + (1,) * (ndim - 1 - axis))
    real_dtype = data.real.dtype
    sign = 1.0 - 2.0 * (parity % 2).to(real_dtype)
    return data * sign


def fft_norm(data, device=None) -> torch.Tensor:
    """Divide by the product of the final two dimensions (the last one
    for 1-D data; sdp_fft_norm). Input as :func:`fft_shifted`."""
    _check_complex(data)
    (data,) = as_tensors(data, device=device)
    num = data.shape[-1] * (data.shape[-2] if data.ndim >= 2 else 1)
    return data / num


class Fft:
    """Planned batched C2C FFT over the last ``num_dims_fft`` dimensions.

    Mirrors `sdp_Fft` (sdp_fft.h:22-66): made from a template array, a
    transform rank and a direction; ``exec`` applies the (unnormalised)
    transform to data of the template's shape, ``exec_shift`` wraps it in
    the multiplicative shift and an optional normalisation
    (sdp_fft.h:99-117). Data given as NumPy goes to ``device`` (None: the
    CUDA card); a tensor stays where it is.
    """

    def __init__(self, template, num_dims_fft: int, forward: bool = True,
                 device=None):
        _check_complex(template)
        if not 1 <= num_dims_fft <= template.ndim:
            raise SdpInvalidArgumentError(
                f"num_dims_fft must be in [1, {template.ndim}]; "
                f"got {num_dims_fft}")
        self.num_dims_fft = int(num_dims_fft)
        self.forward = bool(forward)
        self.shape = tuple(template.shape)
        self.dtype = template.dtype
        self.device = device

    def exec(self, data) -> torch.Tensor:
        _check_complex(data)
        if tuple(data.shape) != self.shape:
            raise SdpInvalidArgumentError(
                f"data shape {tuple(data.shape)} does not match the "
                f"plan template {self.shape}")
        (data,) = as_tensors(data, device=self.device)
        return _fft_nd(data, self.num_dims_fft, self.forward)

    def exec_shift(self, data, norm: bool = False) -> torch.Tensor:
        (data,) = as_tensors(data, device=self.device)
        out = fft_phase(self.exec(fft_phase(data)))
        return fft_norm(out) if norm else out

    def __call__(self, data) -> torch.Tensor:
        return self.exec(data)


def fft_shifted(data, num_dims_fft: int = 2, device=None) -> torch.Tensor:
    """phase -> unnormalised FFT -> phase. NumPy input is copied to
    ``device`` (None: the CUDA card); a tensor stays where it is."""
    (data,) = as_tensors(data, device=device)
    return fft_phase(_fft_nd(fft_phase(data), num_dims_fft, True))


def ifft_shifted(data, num_dims_fft: int = 2, device=None) -> torch.Tensor:
    """phase -> unnormalised iFFT -> phase (no 1/N^d factor, like the
    reference's backward PocketFFT/cuFFT calls); input as
    :func:`fft_shifted`."""
    (data,) = as_tensors(data, device=device)
    return fft_phase(_fft_nd(fft_phase(data), num_dims_fft, False))


def padded_fft_size(size: int, padding_factor: float = 1.0) -> int:
    """Next even number >= size*padding_factor whose prime factors are
    all in {2, 3, 5, 7, 11} (reference: sdp_fft_padded_size.h:20)."""
    candidate = max(2, int(size * padding_factor + 0.5))
    if candidate % 2:
        candidate += 1
    while True:
        n = candidate
        for p in (2, 3, 5, 7, 11):
            while n % p == 0:
                n //= p
        if n == 1:
            return candidate
        candidate += 2


def ifft_shifted_norm(data: torch.Tensor,
                      num_dims_fft: int = 2) -> torch.Tensor:
    """phase -> normalised (1/N^d) iFFT -> phase."""
    out = ifft_shifted(data, num_dims_fft)
    num = 1
    for extent in data.shape[-num_dims_fft:]:
        num *= extent
    return out / num
