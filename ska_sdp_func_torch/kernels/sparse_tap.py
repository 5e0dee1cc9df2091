"""Sparse all-layer w-towers gridding: CUDA kernel and plain twin.

Counterpart of ska_sdp_func_tpu.kernels.sparse_tap. Its Pallas kernel
``grid_all_layers_sparse`` (K20) is the sparse twin of
``grid_all_layers_pallas`` (K16): each visibility carries its first
layer ``k0`` [V] and its ``Sw`` w taps ``wk`` [V, Sw] in place of a dense
``weights`` [V, K] row, and adds ``uk[a] * vk[b] * (wk[l] * vis)`` to
layer ``k0 + l``, cell ``(iu0 + a, iv0 + b)``. ``k0`` is clipped to ``[0,
K - Sw]``, as the Pallas wrapper clips it; entries with zero ``wk`` add
nothing. Here :func:`grid_all_layers_sparse` launches
``sparse_grid_kernel`` (``csrc/tower_tap.cu``, built by :mod:`._build`):
one CTA per (block of ``block_v`` visibilities, output plane), which
reads the sparse form directly: plane ``k`` of a visibility takes ``wk[v,
k - k0[v]]`` inside its window and 0 outside, so a CTA skips a plane no
visibility of its block touches and accumulates the bounding box of its
taps, and no ``[V, K]`` array is made.

Taps outside the ``[N, N]`` sub-grid are dropped, as K16 drops them. The
Pallas kernel writes rows ``iu0 + a`` past its padded plane into the next
layer's rows (sparse_tap.py:65-74); that is not copied. ``fast=True`` is
the bf16 mode of :mod:`.tower_tap` (``bf16(uk[a] * s) * bf16(vk[b])``).

On a CUDA tensor the wrapper launches its kernel or raises; on a CPU
tensor it runs its plain PyTorch version
(:func:`grid_all_layers_sparse_reference`). It counts its launches in
``.launches``.
"""

import torch

from ..utility.errors import SdpInvalidArgumentError, SdpShapeError
from .tower_tap import _check_taps, _device, grid_all_layers_reference


def _check_window(num_layers: int, w_support: int) -> None:
    if not 1 <= w_support <= num_layers:
        raise SdpInvalidArgumentError(
            f"need 1 <= w_support <= num_layers (got {w_support}, "
            f"{num_layers})")


def _launch_sparse(vis_re, vis_im, iu0, iv0, k0, uk, vk, wk,
                   num_layers: int, size: int, block_v: int,
                   fast: bool) -> torch.Tensor:
    """``sparse_grid_kernel`` -> f32 ``[2K, size, size]`` (re layers,
    then im layers)."""
    from . import _build

    _check_taps(iu0, iv0, uk, vk, wk)
    total, w_support = wk.shape
    for name, t, dtype in (("k0", k0, torch.int32),
                           ("vis_re", vis_re, torch.float32),
                           ("vis_im", vis_im, torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != (total,) \
                or not t.is_contiguous():
            raise SdpInvalidArgumentError(
                f"{name} must be contiguous {dtype} [{total}]")
    if size <= 0 or size % 2 or block_v <= 0:
        raise SdpInvalidArgumentError(
            f"need an even size and block_v > 0 (got {size}, {block_v})")
    lib = _build.load()
    out = torch.zeros((2 * num_layers, size, size), dtype=torch.float32,
                      device=uk.device)
    with torch.cuda.device(uk.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_tower_grid_sparse(
            vis_re.data_ptr(), vis_im.data_ptr(), iu0.data_ptr(),
            iv0.data_ptr(), k0.data_ptr(), uk.data_ptr(), vk.data_ptr(),
            wk.data_ptr(), total, uk.shape[1], w_support, num_layers, size,
            block_v, int(fast), out.data_ptr(), stream)
    _build.check(lib, err, "sparse_grid_kernel")
    return out


def grid_all_layers_sparse_reference(vis_re, vis_im, iu0, iv0, k0, uk, vk,
                                     wk, num_layers: int, size: int,
                                     support: int, w_support: int,
                                     block_v: int = 512,
                                     fast: bool = False) -> torch.Tensor:
    """Plain version of :func:`grid_all_layers_sparse`: each visibility's
    ``wk`` placed on layers ``k0 .. k0 + Sw - 1`` of a dense weight row,
    then K16's plain version."""
    _check_window(num_layers, w_support)
    first = k0.to(torch.int64).clamp(0, num_layers - w_support)
    weights = torch.zeros((wk.shape[0], num_layers), dtype=torch.float32,
                          device=wk.device)
    weights.scatter_(1, first[:, None] + torch.arange(
        w_support, device=wk.device), wk.to(torch.float32))
    return grid_all_layers_reference(vis_re, vis_im, iu0, iv0, uk, vk,
                                     weights, num_layers, size, support,
                                     block_v, fast)


def grid_all_layers_sparse(vis_re, vis_im, iu0, iv0, k0, uk, vk, wk,
                           num_layers: int, size: int, support: int,
                           w_support: int, block_v: int = 512,
                           fast: bool = False) -> torch.Tensor:
    """All-layer gridding of flat taps with sparse w taps (``k0`` [V]
    int32, ``wk`` [V, Sw] f32) into ``[K, size, size]`` complex64;
    ``fast``: the bf16 mode."""
    dev = _device(vis_re, vis_im, iu0, iv0, k0, uk, vk, wk)
    if wk.ndim != 2 or wk.shape[-1] != w_support:
        raise SdpShapeError(
            f"wk has shape {tuple(wk.shape)}, expected [V, {w_support}]")
    _check_window(num_layers, w_support)
    if dev.type == "cpu":
        return grid_all_layers_sparse_reference(
            vis_re, vis_im, iu0, iv0, k0, uk, vk, wk, num_layers, size,
            support, w_support, block_v, fast)
    out = _launch_sparse(vis_re, vis_im, iu0, iv0, k0, uk, vk, wk,
                         num_layers, size, block_v, fast)
    grid_all_layers_sparse.launches += 1
    return torch.complex(out[:num_layers], out[num_layers:])


grid_all_layers_sparse.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {"grid_all_layers_sparse": grid_all_layers_sparse.launches}


def reset_launch_counts() -> None:
    grid_all_layers_sparse.launches = 0
