"""The plain reference: direct Fourier transforms in float64.

Plain PyTorch, on any device, computed in blocks of rows so that it fits
beside what a run keeps. It imports nothing of the program and takes
nothing the program made: only the inputs the benchmark generated.

Conventions (those of the SKA processing functions' ``dft`` / ``idft``):
pixel ``(il, im)`` of an ``N``-pixel image of width ``theta`` sits at
``l = (il - N // 2) * theta / N``, ``m = (im - N // 2) * theta / N``,
``n = sqrt(1 - l^2 - m^2) - 1``; a visibility of row ``r`` and channel
``c`` has ``(u, v, w) = uvw[r] * freq[c] / C_0``;

    predict: vis[r, c] = sum_p image[p] exp(-2 pi i (u l + v m + w n))
    dirty:   image[p] = Re sum_{r,c} vis[r, c] exp(2 pi i (u l + v m + w n))
"""

import math

import torch

C_0 = 299792458.0
# Elements of one block's [rows, channels, points] phase (f64): 2^24
# take 128 MiB, and the phasor twice that.
BLOCK_ELEMENTS = 1 << 24


def frequencies(config: dict, device) -> torch.Tensor:
    """Channel frequencies [C] float64 in Hz."""
    return (config["freq0_hz"] + config["dfreq_hz"] * torch.arange(
        config["num_chan"], dtype=torch.float64, device=device))


def pixel_lmn(il, im, image_size: int, theta: float) -> torch.Tensor:
    """Direction cosines [P, 3] float64 of pixels ``(il, im)``."""
    l = (il.to(torch.float64) - image_size // 2) * theta / image_size
    m = (im.to(torch.float64) - image_size // 2) * theta / image_size
    n = torch.sqrt(1 - l * l - m * m) - 1
    return torch.stack([l, m, n], dim=1)


def _blocks(rows: int, per_row: int):
    step = max(1, BLOCK_ELEMENTS // max(1, per_row))
    for start in range(0, rows, step):
        yield slice(start, min(rows, start + step))


def _phase(uvw, freqs, lmn):
    """[rows, C, P] float64 phase ``2 pi (u l + v m + w n)``."""
    proj = uvw.to(torch.float64) @ lmn.T                     # [rows, P]
    return (2 * math.pi / C_0) * proj[:, None, :] * freqs[None, :, None]


def predict(uvw, freqs, image, theta: float) -> torch.Tensor:
    """Visibilities [rows, C] complex128 of a model ``image`` [N, N]."""
    n = image.shape[0]
    il, im = torch.nonzero(image, as_tuple=True)
    flux = image[il, im].to(torch.float64)
    lmn = pixel_lmn(il, im, n, theta)
    rows = uvw.shape[0]
    out = torch.empty((rows, freqs.shape[0]), dtype=torch.complex128,
                      device=uvw.device)
    for blk in _blocks(rows, freqs.shape[0] * max(1, flux.shape[0])):
        ph = _phase(uvw[blk], freqs, lmn)
        out[blk] = torch.complex(torch.cos(ph) @ flux,
                                 -(torch.sin(ph) @ flux))
    return out


def predict_at(uvw, freq, image, theta: float) -> torch.Tensor:
    """Visibilities [S] complex128 of ``image`` at samples of their own
    row ``uvw`` [S, 3] and frequency ``freq`` [S]."""
    scaled = uvw.to(torch.float64) * (freq / C_0)[:, None]
    one = torch.full((1,), C_0, dtype=torch.float64, device=uvw.device)
    return predict(scaled, one, image, theta)[:, 0]


def dirty(uvw, freqs, vis, il, im, image_size: int,
          theta: float) -> torch.Tensor:
    """Dirty-image values [P] float64 at pixels ``(il, im)`` of
    visibilities ``vis`` [rows, C]."""
    lmn = pixel_lmn(il, im, image_size, theta)
    rows = uvw.shape[0]
    out = torch.zeros(lmn.shape[0], dtype=torch.float64, device=uvw.device)
    for blk in _blocks(rows, freqs.shape[0] * lmn.shape[0]):
        ph = _phase(uvw[blk], freqs, lmn)
        v = vis[blk].to(torch.complex128)
        # Re(v e^{i ph}) = re cos - im sin, summed over rows and channels.
        out += torch.einsum("rcp,rc->p", torch.cos(ph), v.real)
        out -= torch.einsum("rcp,rc->p", torch.sin(ph), v.imag)
    return out


def relative_error(got, want) -> float:
    """``max |got - want| / max |want|`` (float64)."""
    got = got.to(want.dtype) if not want.is_complex() else \
        got.to(torch.complex128)
    scale = want.abs().max()
    return float((got - want).abs().max() / scale)
