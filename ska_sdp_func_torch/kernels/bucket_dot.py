"""Per-bucket sums of block band products: the band product's A/B family.

Counterpart of the Pallas kernels of experiments/exp_dot.py (``_call``
with ``_k_prod``, ``_k_lhs_stream``, ``_k_ksplit``, ``_k_nodot``;
``_call_npair`` with ``_k_npair``) and experiments/exp_parity.py
(``grid_packed_parity``), one templated CUDA kernel
(``csrc/bucket_dot.cu``). Per block ``b`` of ``block_v`` slots::

    U_b = concat_j(ubase[:, blk] * scales[j, blk])  [128, B]  (or uall[:, blk])
    out[bucket_ids[b]] += U_b @ vband[blk]           [128, 128]

The blocks of a bucket are contiguous. :func:`bucket_dot` returns exp_dot's
``[num_buckets * 128, 128]`` (``npair``: ``[num_buckets * 128, 256]``,
block ``2 s`` in columns 0-127 and ``2 s + 1`` in 128-255 of bucket
``bucket_ids[2 s]``); :func:`grid_parity` exp_parity's ``[2 Sw,
num_buckets, 16, lanes]`` with ``slots`` split accumulators. Buckets no
block visits are zero (the TPU kernels leave them undefined).

Forms (:data:`FORMS`): ``prod`` (U built from ``ubase`` and ``scales``),
``lhs_stream`` (U read from ``uall``), ``ksplit2``/``ksplit4`` (2 or 4
accumulator chains over the block's K range), ``npair``, ``nodot`` (no
product: ``sum_c U_b[:, 128 c:128 c + 128] + vband[bB]``) and
``prod_simt`` (``prod`` on the CUDA cores). A bf16 ``vband`` selects the
bf16 mode (U rounded to bf16, f32 sums), as the TPU bodies do; f32
operands take three TF32 tensor-core products (hi/lo splits) for the
TPU's ``Precision.HIGHEST``; ``prod_simt`` and ``nodot`` take f32 only.

On a CUDA tensor each wrapper launches the kernel or raises; on a CPU
tensor it runs its plain version (``*_reference``, true f32 products).
Both count their kernel launches in ``.launches``. The tensor-core forms
walk the bucket runs of :func:`dot_runs` (one persistent CTA an SM, a
unit a whole run): pass ``runs=`` to build the table once; without it
each call builds it on the device (no host sync). The plain versions and
the CUDA-core forms (``prod_simt``, ``nodot``) ignore it. The tensor-core
kernel zeroes the buckets no block visits itself (a small kernel before it
flags the visited ones), so their output is not filled first.
"""

import torch

from ..utility.errors import SdpDataTypeError, SdpInvalidArgumentError, \
    SdpMemLocationError, SdpShapeError
from .packed_tap import WIN_ROWS, _check, _full_f32_matmul, \
    check_runs, run_table

NUM_P = 8
M = NUM_P * WIN_ROWS              # 128 rows of U
LANES = 128
FORMS = ("prod", "prod_simt", "lhs_stream", "ksplit2", "ksplit4", "npair",
         "nodot")
# csrc/bucket_dot.cu variant codes, by (form, bf16).
_CODES = {("prod", False): 0, ("prod", True): 1, ("prod_simt", False): 2,
          ("lhs_stream", False): 3, ("lhs_stream", True): 4,
          ("ksplit2", False): 5, ("ksplit4", False): 6,
          ("ksplit2", True): 7, ("ksplit4", True): 8,
          ("npair", False): 9, ("npair", True): 10, ("nodot", False): 11,
          ("slots1", False): 0, ("slots2", False): 12,
          ("slots4", False): 13}
_CORE_CODES = (2, 11)  # the CUDA-core forms: no run table
_REF_BLOCKS = 256      # blocks per step of the plain versions


def dot_runs(bucket_ids, pair: bool = False) -> torch.Tensor:
    """The tensor-core kernels' work units: :func:`run_table` of the
    blocks' buckets, int32 ``[NB, 2]`` rows (first block, block count),
    longest first, then (0, 0) rows; torch ops of fixed shape on the ids'
    device, no host sync. ``pair`` (npair): runs of block pairs, block
    ``b`` keyed by ``bucket_ids[b & ~1]``, over the even count of blocks."""
    ids = bucket_ids
    if pair:
        nb = ids.shape[0] - ids.shape[0] % 2
        ids = ids[torch.arange(nb, device=ids.device) & ~1]
    return run_table((ids,))


def _contribs(form, ins, lo, hi, block_v, bf16):
    """Per-block contributions ``[hi - lo, 128, 128]`` of blocks lo..hi in
    the TPU body's arithmetic (true f32 products; bf16 operands upcast, so
    every product is exact)."""
    n = hi - lo
    sl = slice(lo * block_v, hi * block_v)
    if form == "lhs_stream":
        uall, vband = ins
        u = uall[:, sl].float()
    else:
        ubase, vband, scales = ins
        u = (ubase[None, :, sl] * scales[:, None, sl]).reshape(M, -1)
        if bf16:
            u = u.to(torch.bfloat16).float()
    u = u.reshape(M, n, block_v).permute(1, 0, 2)           # [n, M, B]
    v = vband[sl].float().reshape(n, block_v, LANES)
    if form == "nodot":
        return u.reshape(n, M, block_v // LANES, LANES).sum(2) + v[:, :1]
    splits = int(form[-1]) if form.startswith("ksplit") else 1
    step = block_v // splits
    with _full_f32_matmul():
        parts = [torch.bmm(u[:, :, i * step:(i + 1) * step],
                           v[:, i * step:(i + 1) * step])
                 for i in range(splits)]
    contrib = parts[0]
    for p in parts[1:]:
        contrib = contrib + p
    return contrib


def _sums(form, bucket_ids, ins, num_buckets, block_v, slots, bf16):
    """``acc [slots, num_buckets, 128, 128]``: block b into slot
    ``b % slots`` (npair: bucket ``ids[b & ~1]``, slot ``b & 1``)."""
    nb = bucket_ids.shape[0]
    dev = bucket_ids.device
    pair = form == "npair"
    if pair:
        nb -= nb % 2
    b = torch.arange(nb, device=dev)
    ids = bucket_ids.to(torch.int64)[(b & ~1) if pair else b]
    acc = torch.zeros((slots * num_buckets, M, LANES), dtype=torch.float32,
                      device=dev)
    for lo in range(0, nb, _REF_BLOCKS):
        hi = min(nb, lo + _REF_BLOCKS)
        acc.index_add_(0, (b[lo:hi] % slots) * num_buckets + ids[lo:hi],
                       _contribs(form, ins, lo, hi, block_v, bf16))
    return acc.reshape(slots, num_buckets, M, LANES)


def bucket_dot_reference(form: str, bucket_ids, ins, num_buckets: int,
                         block_v: int):
    """Plain PyTorch version of :func:`bucket_dot`."""
    bf16 = ins[1].dtype == torch.bfloat16
    if form == "npair":
        acc = _sums(form, bucket_ids, ins, num_buckets, block_v, 2, bf16)
        return acc.permute(1, 2, 0, 3).reshape(num_buckets * M, 2 * LANES)
    acc = _sums(form, bucket_ids, ins, num_buckets, block_v, 1, bf16)
    return acc[0].reshape(num_buckets * M, LANES)


def grid_parity_reference(bucket_ids, ubase, vband, scales,
                          num_buckets: int, lanes: int, w_support: int,
                          block_v: int, slots: int):
    """Plain PyTorch version of :func:`grid_parity`: the slots summed in
    slot order."""
    acc = _sums("prod", bucket_ids, (ubase, vband, scales), num_buckets,
                block_v, slots, False)
    total = acc[0]
    for s in range(1, slots):
        total = total + acc[s]
    return total.reshape(num_buckets, NUM_P, WIN_ROWS, lanes).permute(
        1, 0, 2, 3).contiguous()


def _check_ins(form, bucket_ids, ins, block_v):
    if form not in FORMS:
        raise SdpInvalidArgumentError(f"unknown form {form!r}")
    ins = tuple(ins)
    if len(ins) != (2 if form == "lhs_stream" else 3):
        raise SdpInvalidArgumentError(
            f"{form} takes (uall, vband)" if form == "lhs_stream" else
            f"{form} takes (ubase, vband, scales)")
    vband = ins[1]
    dev = vband.device
    if vband.ndim != 2 or vband.shape[1] != LANES:
        raise SdpShapeError(f"vband must be [V, {LANES}]")
    total = vband.shape[0]
    if block_v < LANES or block_v % LANES or total % block_v:
        raise SdpInvalidArgumentError(
            f"block_v={block_v} must be a multiple of {LANES} dividing V="
            f"{total}")
    bf16 = vband.dtype == torch.bfloat16
    if bf16 and form in ("prod_simt", "nodot"):
        raise SdpDataTypeError(f"{form} takes an f32 vband")
    _check(dev, [("vband", vband)],
           torch.bfloat16 if bf16 else torch.float32)
    if form == "lhs_stream":
        _check(dev, [("uall", ins[0])], vband.dtype, (M, total))
    else:
        _check(dev, [("ubase", ins[0])], torch.float32, (WIN_ROWS, total))
        _check(dev, [("scales", ins[2])], torch.float32, (NUM_P, total))
    _check(dev, [("bucket_ids", bucket_ids)], torch.int32,
           (total // block_v,))
    if dev.type not in ("cpu", "cuda"):
        raise SdpMemLocationError(f"unsupported device {dev}")
    return ins, dev, total, bf16


def _launch(code, bucket_ids, runs, ins, form, total, nb, block_v, shape,
            num_buckets, strides):
    """The output of one launch: the tensor-core forms write every bucket
    (those no block visits as zero), the CUDA-core forms the visited ones
    of a zeroed output."""
    from . import _build

    lib = _build.load()
    if form == "lhs_stream":
        uall, vband = ins
        ubase = scales = None
    else:
        ubase, vband, scales = ins
        uall = None
    dev = vband.device
    if code in _CORE_CODES:
        runs = work = None
        out = torch.zeros(shape, dtype=torch.float32, device=dev)
    else:
        if runs is None:
            runs = dot_runs(bucket_ids, pair=form == "npair")
        # The kernel's scratch: its unit counter and a flag a visited
        # bucket, set on the device before it runs.
        work = torch.empty(1 + num_buckets, dtype=torch.int32, device=dev)
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.sdp_torch_bucket_dot(
            code, bucket_ids.data_ptr(), ptr(runs),
            0 if runs is None else runs.shape[0], ptr(work), num_buckets,
            ptr(ubase), ptr(scales), ptr(uall), vband.data_ptr(), total, nb,
            block_v, out.data_ptr(), *strides,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "bucket_dot")
    return out


def bucket_dot(form: str, bucket_ids, ins, num_buckets: int, block_v: int,
               runs=None):
    """exp_dot's per-bucket sums of ``form``: ``ins`` is ``(ubase [16, V],
    vband [V, 128], scales [8, V])`` (``lhs_stream``: ``(uall [128, V],
    vband)``), f32, or bf16 ``vband`` (and ``uall``) for the bf16 mode;
    ``bucket_ids`` [V / block_v] int32; ``runs`` :func:`dot_runs` of the
    ids (``npair``: with ``pair=True``), or None. Returns
    ``[num_buckets * 128, 128]`` f32 (``npair``: 256 columns)."""
    ins, dev, total, bf16 = _check_ins(form, bucket_ids, ins, block_v)
    runs = check_runs(runs, dev)
    if dev.type == "cpu":
        return bucket_dot_reference(form, bucket_ids, ins, num_buckets,
                                    block_v)
    cols = 2 * LANES if form == "npair" else LANES
    nb = total // block_v
    out = _launch(_CODES[(form, bf16)], bucket_ids, runs, ins, form, total,
                  nb - nb % 2 if form == "npair" else nb, block_v,
                  (num_buckets * M, cols), num_buckets,
                  (WIN_ROWS * cols, cols, M * cols))
    bucket_dot.launches += 1
    return out


bucket_dot.launches = 0


def grid_parity(bucket_ids, ubase, vband, scales, num_buckets: int,
                lanes: int, w_support: int, block_v: int, slots: int,
                runs=None):
    """exp_parity's dense-band grid (``grid_packed_pallas``'s function)
    with ``slots`` (1, 2 or 4) split accumulators: ``[2 Sw, num_buckets,
    16, lanes]`` f32 from ``ubase [16, V]``, ``vband [V, lanes]`` and
    ``scales [2 Sw, V]`` f32 (lanes 128, Sw 4); ``runs`` :func:`dot_runs`
    of the ids, or None."""
    if slots not in (1, 2, 4):
        raise SdpInvalidArgumentError("slots must be 1, 2 or 4")
    if lanes != LANES or 2 * w_support != NUM_P:
        raise SdpInvalidArgumentError(
            f"grid_parity takes lanes {LANES} and w_support {NUM_P // 2}")
    if vband.dtype != torch.float32:
        raise SdpDataTypeError("grid_parity takes an f32 vband")
    ins, dev, total, _ = _check_ins("prod", bucket_ids,
                                    (ubase, vband, scales), block_v)
    runs = check_runs(runs, dev)
    if dev.type == "cpu":
        return grid_parity_reference(bucket_ids, ubase, vband, scales,
                                     num_buckets, lanes, w_support, block_v,
                                     slots)
    out = _launch(_CODES[(f"slots{slots}", False)], bucket_ids, runs, ins,
                  "prod", total, total // block_v, block_v,
                  (NUM_P, num_buckets, WIN_ROWS, lanes), num_buckets,
                  (num_buckets * WIN_ROWS * lanes, lanes, WIN_ROWS * lanes))
    grid_parity.launches += 1
    return out


grid_parity.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {"bucket_dot": bucket_dot.launches,
            "grid_parity": grid_parity.launches}


def reset_launch_counts() -> None:
    bucket_dot.launches = 0
    grid_parity.launches = 0
