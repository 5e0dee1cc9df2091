"""Bucket-window fold of the streaming engine's non-packable branch.

Counterpart of two Pallas kernels of ska_sdp_func_tpu.kernels.packed_tap
and of the JAX driver that composes them (ska_sdp_func_tpu.parallel.packed
``_fold_windows``):

- :func:`fold_groups_reference` is ``fold_groups_pallas``: each (task,
  slab) group's octet windows ``[2 Sw, G O, 16, L]`` summed at their 8-row
  offsets into ``[2 Sw, G, 8 O, L]``; unvisited buckets are skipped and
  the last octet's straddle half is clipped;
- :func:`fold_layers_reference` is ``fold_layers_pallas``: each task's
  slabs folded onto absolute layers, ``out[ri, t, s + l] += part[ri Sw + l,
  t S + s]``, into ``[2, T, K, 8 O, L]``;
- :func:`fold_windows` does both and returns complex64 ``[T, K, 8 O, L]``.

On a CUDA tensor :func:`fold_windows` launches one hand-written gather
kernel (``csrc/fold.cu``: a CTA an (octet, layer, task), its visited flags
read once, float4 rows) that does both folds in one pass, with no
intermediate and no atomics, or raises; on a CPU tensor it runs the two
plain versions composed. It counts its launches in ``.launches``. Both
add in the Pallas kernels' order, so they agree bit for bit. A window
whose bucket is unvisited is never read: it may hold anything, NaN
included.
"""

import torch

from ..utility.errors import SdpInvalidArgumentError, SdpMemLocationError, \
    SdpShapeError
from .packed_tap import WIN_ROWS, _check


def fold_groups_reference(wins, visited, num_groups: int,
                          num_octets: int) -> torch.Tensor:
    """Plain PyTorch version of ``fold_groups_pallas``: ``[2 Sw, G O, 16,
    L]`` windows and ``visited`` [G O] -> ``[2 Sw, G, 8 O, L]``, octets
    added in ascending order."""
    num_p, _, _, lanes = wins.shape
    w = wins.reshape(num_p, num_groups, num_octets, WIN_ROWS, lanes)
    keep = visited.reshape(1, num_groups, num_octets, 1, 1)
    w = torch.where(keep, w, torch.zeros((), dtype=w.dtype, device=w.device))
    out = torch.zeros((num_p, num_groups, 8 * num_octets + 8, lanes),
                      dtype=wins.dtype, device=wins.device)
    for g in range(num_octets):
        out[:, :, 8 * g:8 * g + WIN_ROWS] += w[:, :, g]
    return out[:, :, :8 * num_octets]


def fold_layers_reference(part, num_tasks: int, num_slabs: int,
                          w_support: int, num_layers: int) -> torch.Tensor:
    """Plain PyTorch version of ``fold_layers_pallas``: ``[2 Sw, T S,
    size, L]`` -> ``[2, T, K, size, L]``, window planes added in ascending
    order."""
    num_p, _, size, lanes = part.shape
    p = part.reshape(num_p, num_tasks, num_slabs, size, lanes)
    out = torch.zeros((2, num_tasks, num_layers, size, lanes),
                      dtype=part.dtype, device=part.device)
    for ri in range(2):
        for layer in range(w_support):
            out[ri, :, layer:layer + num_slabs] += p[ri * w_support + layer]
    return out


def fold_windows_reference(wins, visited, num_tasks: int, num_slabs: int,
                           num_octets: int, w_support: int,
                           num_layers: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fold_windows`: the two folds
    composed."""
    part = fold_groups_reference(wins, visited, num_tasks * num_slabs,
                                 num_octets)
    out = fold_layers_reference(part, num_tasks, num_slabs, w_support,
                                num_layers)
    return torch.complex(out[0], out[1])


def fold_windows(wins, visited, num_tasks: int, num_slabs: int,
                 num_octets: int, w_support: int,
                 num_layers: int) -> torch.Tensor:
    """Bucket windows -> complex64 tower layers.

    ``wins`` f32 ``[2 Sw, T S O, 16, L]`` (re planes, then im), bucket
    ``(t S + s) O + g``; ``visited`` bool [T S O]. Returns ``[T, K,
    8 O, L]`` complex64, ``K = S + Sw - 1``.
    """
    dev = wins.device
    num_buckets = num_tasks * num_slabs * num_octets
    if wins.ndim != 4 or tuple(wins.shape[:3]) != (2 * w_support,
                                                    num_buckets, WIN_ROWS):
        raise SdpShapeError(
            f"wins must be [{2 * w_support}, {num_buckets}, {WIN_ROWS}, L]")
    if num_layers != num_slabs + w_support - 1:
        raise SdpInvalidArgumentError(
            "num_layers must be num_slabs + w_support - 1")
    _check(dev, [("wins", wins)], torch.float32)
    _check(dev, [("visited", visited)], torch.bool, (num_buckets,))
    if dev.type == "cpu":
        return fold_windows_reference(wins, visited, num_tasks, num_slabs,
                                      num_octets, w_support, num_layers)
    if dev.type != "cuda":
        raise SdpMemLocationError(f"unsupported device {dev}")
    from . import _build

    lib = _build.load()
    lanes = wins.shape[3]
    out = torch.empty((num_tasks, num_layers, 8 * num_octets, lanes),
                      dtype=torch.complex64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_fold_windows(
            wins.data_ptr(), visited.data_ptr(), num_tasks, num_slabs,
            num_octets, w_support, num_layers, lanes, out.data_ptr(), stream)
    _build.check(lib, err, "fold_windows")
    fold_windows.launches += 1
    return out


fold_windows.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"fold_windows": fold_windows.launches}


def reset_launch_counts() -> None:
    fold_windows.launches = 0
