"""Padded-stream placement (gap insertion) of key-sorted payloads.

Counterpart of ska_sdp_func_tpu.kernels.place: :func:`place_stream`
replaces the Pallas kernel ``place_stream_pallas``. Output block ``i`` of
``bv`` slots copies ``vcnt[i]`` consecutive entries of each sorted payload
starting at ``src0[i]`` and zero-fills the rest::

    placed[i * bv + r] = sorted[src0[i] + r]   if r < vcnt[i] else 0

``src0`` may be anything where ``vcnt[i] <= 0`` (filler blocks, an
overflowed plan); reads past the end of the payload give 0, as the JAX
kernel's zero padding does. The JAX kernel's 1024-element alignment and
its rotates are Mosaic constraints; on CUDA this is one launch of a
persistent copy kernel (``csrc/place.cu``) for up to 8 payloads, written
as 16-byte vectors from 4-byte source loads at any ``src0`` (word by
word where ``bv % 4 != 0``). On a CUDA tensor :func:`place_stream`
launches the kernel or raises; on a CPU tensor it runs
:func:`place_stream_reference`. It counts its kernel launches in
``.launches``.
"""

import torch

from ..utility.errors import (
    SdpDataTypeError,
    SdpInvalidArgumentError,
    SdpMemLocationError,
    SdpShapeError,
)
from .packed_tap import _check

_MAX_OPS = 8   # payloads per launch (csrc/place.cu kMaxOps)


def place_stream_reference(src0, vcnt, ops, bv: int, cap: int):
    """Plain PyTorch version of :func:`place_stream` (one gather with a
    mask per payload)."""
    n = ops[0].shape[0]
    r = torch.arange(bv, device=src0.device)
    idx = src0.to(torch.int64)[:, None] + r[None, :]
    keep = (r[None, :] < vcnt[:, None]) & (idx >= 0) & (idx < n)
    idx = torch.where(keep, idx, 0).reshape(-1)
    keep = keep.reshape(-1)
    return tuple(torch.where(keep, o[idx], torch.zeros((), dtype=o.dtype,
                                                         device=o.device))
                 if n else torch.zeros(cap, dtype=o.dtype, device=o.device)
                 for o in ops)


def place_stream(src0, vcnt, ops, bv: int, cap: int):
    """Materialise the placed (padded) stream of each payload.

    src0, vcnt: [cap // bv] int32 per output block; ops: sequence of 1-D
    payloads of one length N, each int32 or float32 (mixed freely).
    Returns a tuple of ``[cap]`` tensors, one per payload, dtypes kept.
    """
    ops = tuple(ops)
    if not ops:
        raise SdpInvalidArgumentError("place_stream needs a payload")
    if bv <= 0 or cap % bv:
        raise SdpInvalidArgumentError(
            f"cap={cap} must be a multiple of bv={bv}")
    dev = src0.device
    _check(dev, [("src0", src0), ("vcnt", vcnt)], torch.int32,
           (cap // bv,))
    n = ops[0].shape[0]
    for i, o in enumerate(ops):
        if o.ndim != 1 or o.shape[0] != n:
            raise SdpShapeError(f"payload {i} must be 1-D of length {n}")
        if o.dtype not in (torch.int32, torch.float32):
            raise SdpDataTypeError(
                f"payload {i} must be int32 or float32, got {o.dtype}")
        _check(dev, [(f"payload {i}", o)], o.dtype)
    if dev.type == "cpu":
        return place_stream_reference(src0, vcnt, ops, bv, cap)
    if dev.type != "cuda":
        raise SdpMemLocationError(f"unsupported device {dev}")
    import ctypes

    from . import _build

    lib = _build.load()
    outs = tuple(torch.empty(cap, dtype=o.dtype, device=dev) for o in ops)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for lo in range(0, len(ops), _MAX_OPS):
            part = range(lo, min(lo + _MAX_OPS, len(ops)))
            srcs = (ctypes.c_void_p * len(part))(
                *(ops[i].data_ptr() for i in part))
            dsts = (ctypes.c_void_p * len(part))(
                *(outs[i].data_ptr() for i in part))
            err = lib.sdp_torch_place_stream(
                src0.data_ptr(), vcnt.data_ptr(), srcs, dsts, len(part), n,
                bv, cap // bv, stream)
            _build.check(lib, err, "place_stream")
            place_stream.launches += 1
    return outs


place_stream.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"place_stream": place_stream.launches}


def reset_launch_counts() -> None:
    place_stream.launches = 0
