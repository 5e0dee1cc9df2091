"""Sparse all-layer w-towers gridding: CUDA kernel and plain twin.

Counterpart of ska_sdp_func_tpu.kernels.sparse_tap. Its Pallas kernel
``grid_all_layers_sparse`` (K20) is the sparse twin of
``grid_all_layers_pallas`` (K16): each visibility carries its first
layer ``k0`` [V] and its ``Sw`` w taps ``wk`` [V, Sw] in place of a dense
``weights`` [V, K] row, and adds ``uk[a] * vk[b] * (wk[l] * vis)`` to
layer ``k0 + l``, cell ``(iu0 + a, iv0 + b)``. ``k0`` is clipped to ``[0,
K - Sw]``, as the Pallas wrapper clips it; entries with zero ``wk`` add
nothing. Here :func:`grid_all_layers_sparse` launches the ``SPARSE``
instantiation of ``tower_grid_kernel`` (``csrc/tower_tap.cu``, built by
:mod:`._build`), which reads the sparse form directly: plane ``k`` of a
visibility takes ``wk[v, k - k0[v]]`` inside its window and 0 outside,
so K16's per-(block, plane) skip test and tap bounding box work
unchanged, and no ``[V, K]`` array is made.

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
from .tower_tap import _device, _launch_grid, grid_all_layers_reference


def _check_window(num_layers: int, w_support: int) -> None:
    if not 1 <= w_support <= num_layers:
        raise SdpInvalidArgumentError(
            f"need 1 <= w_support <= num_layers (got {w_support}, "
            f"{num_layers})")


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
    out = _launch_grid(vis_re, vis_im, iu0, iv0, uk, vk, wk, size, block_v,
                       fast, k0=k0, num_layers=num_layers)
    grid_all_layers_sparse.launches += 1
    return torch.complex(out[:num_layers], out[num_layers:])


grid_all_layers_sparse.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {"grid_all_layers_sparse": grid_all_layers_sparse.launches}


def reset_launch_counts() -> None:
    grid_all_layers_sparse.launches = 0
