"""Multi-stream device-memory read probe.

Counterpart of the Pallas kernel of bench.py's roofline probe
(``_measure_rooflines.stream_loop``, body ``_read_kernel``):
:func:`read_streams` reads ``n`` f32 streams ``[R, C]`` in ``(br, bc)``
blocks and returns the TPU kernel's output::

    out[8 i + r, 128 j + l] = s sum_k sum_{rows of block i} x_k[row, bc j + l]

for ``r < 8``, ``l < 128`` (``[8 R / br, 128 C / bc]``), and the sums of
every column it was made from, ``sums[i, c]`` ``[R / br, C]``. The TPU
output reads only the first 128 of each block's ``bc`` columns; the CUDA
kernel (``csrc/read_probe.cu``) sums every column, so that each byte it
counts is read, and the wrapper slices the output from the sums.

On a CUDA tensor :func:`read_streams` launches the kernel or raises; on a
CPU tensor it runs :func:`read_streams_reference`. It counts its kernel
launches in ``.launches``.
"""

import torch

from ..utility.errors import SdpInvalidArgumentError, SdpMemLocationError, \
    SdpShapeError
from .packed_tap import _check

_MAX_STREAMS = 8      # csrc/read_probe.cu kMaxStreams
_COLS = 128           # columns per CTA, and the TPU block's read width


def _tpu_layout(sums, block_cols: int):
    """The TPU kernel's ``[8 R / br, 128 C / bc]`` output from the column
    sums."""
    gi, cols = sums.shape
    gc = cols // block_cols
    head = sums.reshape(gi, 1, gc, block_cols)[..., :_COLS]
    return head.expand(gi, 8, gc, _COLS).reshape(8 * gi, _COLS * gc)


def read_streams_reference(xs, scale: float, block_rows: int,
                           block_cols: int):
    """Plain PyTorch version of :func:`read_streams`."""
    rows, cols = xs[0].shape
    sums = sum((x * scale).reshape(rows // block_rows, block_rows, cols)
               .sum(1) for x in xs)
    return _tpu_layout(sums, block_cols), sums


def read_streams(xs, scale: float, block_rows: int, block_cols: int):
    """``(out, sums)`` of the streams ``xs`` (1 to 8 f32 ``[R, C]``
    tensors of one shape); ``R`` a multiple of ``block_rows``, ``C`` of
    ``block_cols``, ``block_cols`` at least 128 (on the card ``C`` a
    multiple of 128)."""
    xs = tuple(xs)
    if not 1 <= len(xs) <= _MAX_STREAMS:
        raise SdpInvalidArgumentError(
            f"read_streams takes 1 to {_MAX_STREAMS} streams")
    if xs[0].ndim != 2:
        raise SdpShapeError("each stream must be [R, C]")
    rows, cols = xs[0].shape
    if block_rows < 1 or rows % block_rows or block_cols < _COLS \
            or cols % block_cols:
        raise SdpInvalidArgumentError(
            f"[{rows}, {cols}] does not split into ({block_rows}, "
            f"{block_cols}) blocks of at least {_COLS} columns")
    dev = xs[0].device
    _check(dev, [(f"stream {k}", x) for k, x in enumerate(xs)],
           torch.float32, (rows, cols))
    if dev.type == "cpu":
        return read_streams_reference(xs, scale, block_rows, block_cols)
    if dev.type != "cuda":
        raise SdpMemLocationError(f"unsupported device {dev}")
    if cols % _COLS:
        raise SdpInvalidArgumentError(
            f"the CUDA kernel needs C % {_COLS} == 0 (got {cols})")
    import ctypes

    from . import _build

    lib = _build.load()
    sums = torch.empty((rows // block_rows, cols), dtype=torch.float32,
                       device=dev)
    ptrs = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    with torch.cuda.device(dev):
        err = lib.sdp_torch_read_streams(
            ptrs, len(xs), rows, cols, block_rows, float(scale),
            sums.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "read_streams")
    read_streams.launches += 1
    return _tpu_layout(sums, block_cols), sums


read_streams.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"read_streams": read_streams.launches}


def reset_launch_counts() -> None:
    read_streams.launches = 0
