"""Band-engine packed gridding / degridding: CUDA kernels and plain twins.

Counterpart of the main-path half of ska_sdp_func_tpu.kernels.packed_tap:

- :func:`split_bf16` and :func:`build_bands` are torch ops (XLA glue in
  the JAX package);
- :func:`run_table` cuts the plan blocks into runs of one window (torch
  ops of fixed shape, no host sync): :func:`bucket_runs` gives the
  plan's maximal runs; :func:`band_runs` K1/K2's work units, the runs in
  parts of :func:`band_part_blocks` blocks; :func:`degrid_runs` the
  window kernels' parts of :func:`unit_blocks` blocks (the window-gather
  degrid kernels K4, K11, K13, K19 and the window-scatter grid kernels
  K3, K8, K12, K18, whose shared-memory layout :func:`scatter_layout`
  mirrors). Parts listed longest first give each CTA of a kernel's
  static stride the same number of blocks (:func:`stride_balance`), where
  a maximal run of a dense uv core would leave one SM gridding it alone;
- :func:`grid_packed_stack` replaces the Pallas kernel
  ``grid_packed_stack_pallas`` and :func:`degrid_stack` replaces
  ``degrid_stack_pallas``. On a CUDA tensor each launches its
  hand-written kernel (built by :mod:`._build`) or raises: "high" and
  "bf16" on the tensor cores (``csrc/packed_wgmma.cu``, one CTA an SM
  walking the parts of :func:`band_runs`), "highest" on the CUDA cores
  (``csrc/packed_tap.cu``). On a CPU tensor it runs its plain PyTorch
  version (``*_reference``). Each counts its kernel launches in
  ``.launches``.

Stream layout (see packed_tap.cu): the sorted stream of ``V`` slots is
cut into blocks of ``block_v`` slots, block ``b`` belonging to bucket
(t_idx[b], k_idx[b], g_idx[b]) = (task, w-slab, u-octet). Window row
``(h * w_support + j) * 16 + r`` is re (h = 0) / im (h = 1) of layer
``k0 + j`` at sub-grid row ``8 g + r``. Stacks are f32
``[T, 2, K * (lanes + 8), lanes]``.

Precision is chosen by the band operand, as in the JAX wrappers: a
(hi, lo) bf16 tuple means "high" (three bf16 products, f32 sums), a bf16
tensor means "bf16" (fast), an f32 tensor means "highest".
"""

import contextlib

import numpy as np
import torch

from ..utility.errors import (
    SdpDataTypeError,
    SdpInvalidArgumentError,
    SdpMemLocationError,
    SdpShapeError,
)

WIN_ROWS = 16             # 8-aligned octet base + support (<= 8)
_TILE = 128               # the CUDA kernels' lane tile
# The fewest slots of a K1/K2 run part: enough ring stages (64 slots each)
# to hide a part's fixed costs, K1's flush of its 64 KB window and K2's
# load and split of it. On an H100, parts of 1024 slots ran K1/K2 7-23 %
# faster than parts of 512 or 2048 on a plan of 2283 blocks of 512.
BAND_PART_SLOTS = 1024
_MODES = {"highest": 0, "high": 1, "bf16": 2}


def split_bf16(x: torch.Tensor):
    """bf16 hi/lo decomposition with bit-level rounding.

    The upper 16 bits are rounded to nearest-even explicitly (the naive
    ``x - f32(bf16(x))`` can be folded to zero by a compiler; the JAX
    package guards the same thing). The arithmetic runs in int64 on the
    f32 bit pattern, masked to 32 bits, because torch's uint32 support
    is incomplete and int32 ``u + 0x7FFF`` overflows for negative floats.
    """
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    rounded = torch.where(rounded >= 2 ** 31, rounded - 2 ** 32, rounded)
    hi_f = rounded.to(torch.int32).view(torch.float32)
    lo = x - hi_f
    return hi_f.to(torch.bfloat16), lo.to(torch.bfloat16)


def build_bands(u_off: torch.Tensor, iv0: torch.Tensor, uk: torch.Tensor,
                vk: torch.Tensor, lanes: int):
    """Static per-plan tap bands, f32 on the inputs' device.

    u_off: [V] int in [0, 8); iv0: [V] int; uk/vk: [V, support].
    Returns (ubase [16, V], vband [V, lanes], vband_t [lanes, V]) with
    ``ubase[u_off[p] + s, p] = uk[p, s]`` and
    ``vband[p, iv0[p] + s] = vk[p, s]``, zero elsewhere; taps at lanes
    ``>= lanes`` are dropped, as the JAX version's selects drop them. Each
    entry receives at most one tap, so the scatters equal the JAX
    version's sum of masked selects exactly.
    """
    support = uk.shape[1]
    total = u_off.shape[0]
    dev = uk.device
    s = torch.arange(support, device=dev)
    # One extra column takes the dropped taps.
    wide = torch.zeros((total, lanes + 1), dtype=torch.float32, device=dev)
    wide.scatter_(1, (iv0.to(torch.int64)[:, None] + s[None, :]).clamp(
        max=lanes), vk.to(torch.float32))
    vband = wide[:, :lanes].contiguous()
    ubase = torch.zeros((WIN_ROWS, total), dtype=torch.float32, device=dev)
    ubase.scatter_(0, u_off.to(torch.int64)[None, :] + s[:, None],
                   uk.to(torch.float32).T)
    return ubase, vband, vband.T.contiguous()


def run_table(keys, max_blocks: int = 0) -> torch.Tensor:
    """The run table of the plan blocks' window keys, without a host sync.

    ``keys``: per-block int tensors [NB] on one device (the window of block
    ``b`` is the tuple of ``keys[i][b]``). A run is a maximal sequence of
    consecutive blocks with one key; with ``max_blocks`` > 0 each run is
    cut into parts of ``max_blocks`` blocks from its start (the last part
    shorter). Returns int32 ``[NB, 2]`` rows (first block, block count):
    the runs (or parts), longest first, ties in block order, then rows
    (0, 0) up to NB. Every block lies in exactly one row of count > 0.
    Torch ops of fixed shape on the keys' device: the count of runs stays
    there."""
    nb = keys[0].shape[0]
    dev = keys[0].device
    if nb == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=dev)
    idx = torch.arange(nb, device=dev)
    starts = idx == 0
    for k in keys:
        starts[1:] |= k[1:] != k[:-1]
    if max_blocks > 0:
        run0 = torch.cummax(torch.where(starts, idx, 0), dim=0).values
        starts |= (idx - run0) % max_blocks == 0
    first = torch.sort(torch.where(starts, idx, nb)).values
    count = torch.diff(first, append=first.new_full((1,), nb))
    order = torch.argsort(-count, stable=True)
    first, count = first[order], count[order]
    return torch.stack([torch.where(count > 0, first, 0), count], dim=1).to(
        torch.int32).contiguous()


def bucket_runs(t_idx: torch.Tensor, k_idx: torch.Tensor,
                g_idx: torch.Tensor) -> torch.Tensor:
    """The plan's bucket runs: int32 ``[R, 2]`` rows (first block, block
    count), one per maximal sequence of consecutive blocks of one bucket
    (t, k0, g), longest first (ties in block order). Every block lies in
    exactly one run. :func:`run_table` cut to its R runs (one host
    sync)."""
    return live_runs(run_table((t_idx, k_idx, g_idx)))


def live_runs(table: torch.Tensor) -> torch.Tensor:
    """The rows of count > 0 of a :func:`run_table` (one host sync)."""
    return table[:int((table[:, 1] > 0).sum())].contiguous()


def sm_count(device) -> int:
    """The SMs of ``device``'s card, 132 (an H100's) off the card."""
    dev = torch.device(device)
    return (torch.cuda.get_device_properties(dev).multi_processor_count
            if dev.type == "cuda" else 132)


def unit_blocks(num_blocks: int, device) -> int:
    """Blocks of a run part for the window-gather degrid kernels (K4, K11,
    K13, K19): about 16 parts for each of the card's SMs
    (:func:`sm_count`), so that the grid's static stride over the
    longest-first table balances."""
    return max(1, -(-num_blocks // (16 * sm_count(device))))


def degrid_runs(keys) -> torch.Tensor:
    """The run table of the window-gather degrid kernels: :func:`run_table`
    of ``keys`` in parts of :func:`unit_blocks` (no host sync)."""
    return run_table(keys, unit_blocks(keys[0].shape[0], keys[0].device))


def band_part_blocks(num_blocks: int, block_v: int, device) -> int:
    """Blocks of a K1/K2 run part: :func:`unit_blocks`, but at least
    :data:`BAND_PART_SLOTS` slots."""
    return max(unit_blocks(num_blocks, device),
               -(-BAND_PART_SLOTS // block_v))


def band_runs(t_idx: torch.Tensor, k_idx: torch.Tensor,
              g_idx: torch.Tensor, block_v: int) -> torch.Tensor:
    """K1/K2's run table: :func:`run_table` of the blocks' buckets in
    parts of :func:`band_part_blocks` (no host sync; rows (0, 0) follow
    the parts, :func:`live_runs` drops them)."""
    return run_table((t_idx, k_idx, g_idx), band_part_blocks(
        t_idx.shape[0], block_v, t_idx.device))


def stride_balance(counts, lanes: int, sms: int) -> float:
    """The heaviest CTA's blocks over the mean when K1/K2 walk a run table
    of these rows' block counts (host, rows of count > 0) over ``lanes``
    lanes: ``min(units, sms)`` CTAs take the units (row ``u // tiles``,
    128-lane tile ``u % tiles``) with a stride of the grid."""
    counts = np.asarray(counts, np.int64)
    tiles = -(-lanes // _TILE)
    units = counts.shape[0] * tiles
    if units == 0 or counts.sum() == 0:
        return 1.0
    ctas = min(units, sms)
    u = np.arange(units)
    load = np.bincount(u % ctas, weights=counts[u // tiles], minlength=ctas)
    return float(load.max() / load.mean())


def _checked(runs, device):
    if runs.ndim != 2 or runs.shape[1] != 2:
        raise SdpShapeError(f"runs must be [R, 2], got {tuple(runs.shape)}")
    _check(device, [("runs", runs)], torch.int32)
    return runs


def _runs_for(runs, t_idx, k_idx, g_idx, block_v):
    """The caller's run table (checked), or the blocks' :func:`band_runs`
    (one host sync)."""
    if runs is None:
        return live_runs(band_runs(t_idx, k_idx, g_idx, block_v))
    return _checked(runs, t_idx.device)


def degrid_table(runs, keys):
    """The window kernels' table (the window-gather degrid and the
    window-scatter grid kernels): the caller's (checked; any run table
    whose rows of count > 0 hold every block once), or :func:`degrid_runs`
    of the block keys."""
    if runs is None:
        return degrid_runs(keys)
    return _checked(runs, keys[0].device)


def check_runs(runs, device):
    """A caller's run table checked for shape ``[R, 2]``, int32 and
    ``device`` (None passes): the window-scatter wrappers check it before
    they choose the kernel or the plain version, so a malformed table
    raises on the CPU too."""
    return None if runs is None else _checked(runs, torch.device(device))


# The window-scatter kernels' shared memory (csrc/window_scatter.cu): two
# staged tiles of 128 slots (and one spare record) of 42 words each plus 4
# warp counts, and the word forms' fits (16 x 8 x 2 f32), in bytes, beside
# 227 KiB a block.
_SCATTER_FIXED = 2 * (129 * 42 * 4 + 4 * 4) + 4 * 16 * 8 * 2
_SMEM_MAX = 227 * 1024
_TILE_LPAD = 8


def _window_stride(width: int) -> int:
    """window.cuh's shared row stride: 8 banks mod 32, 8 spare columns."""
    return -(-width // 32) * 32 + 8


def scatter_layout(w_support: int, lanes: int) -> dict:
    """The window-scatter kernels' layout of a window of ``w_support``
    w-planes, each a real and an imaginary plane of 16 rows of ``lanes``
    columns, as ``plan_layout`` in ``csrc/window_scatter.cu`` chooses it:
    every w-plane in shared memory when they fit beside the staged tiles,
    else balanced groups of ``w_planes`` w-planes (``planes`` = 2
    ``w_planes`` a group, ``plane_groups`` passes over a unit's slots); a
    w-plane wider than shared memory in ``tiles`` column tiles of
    ``tile_w`` columns with ``lpad`` spare columns on the left. The window
    is held once (``window_buffers``; a consumer warp flushes its own
    planes while the others work), the staged tile twice
    (``tile_buffers``: the producer warps fill one while the consumers
    read the other); ``smem``: the block's shared bytes (at most 227
    KiB)."""
    if not 1 <= w_support <= 8 or lanes <= 0:
        raise SdpInvalidArgumentError(
            f"w_support must be in [1, 8] and lanes > 0 (got {w_support}, "
            f"{lanes})")
    avail = _SMEM_MAX - _SCATTER_FIXED
    pair_bytes = 2 * 4 * WIN_ROWS          # a column of both halves
    lpad, tile_w, tiles = 0, lanes, 1
    stride = _window_stride(lanes)
    if pair_bytes * stride > avail:
        lpad = _TILE_LPAD
        max_w = (avail // pair_bytes - _window_stride(lpad)) // 32 * 32
        tiles = -(-lanes // max_w)
        tile_w = -(-(-(-lanes // tiles)) // 32) * 32
        stride = _window_stride(lpad + tile_w)
    fit = avail // (pair_bytes * stride)
    jn = min(fit, w_support)
    groups = -(-w_support // jn)
    jn = -(-w_support // groups)
    return dict(stride=stride, lpad=lpad, w_planes=jn, planes=2 * jn,
                plane_groups=groups, tile_w=tile_w, tiles=tiles,
                window_buffers=1, tile_buffers=2,
                smem=_SCATTER_FIXED + pair_bytes * stride * jn,
                fixed=_SCATTER_FIXED)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it on a 16-byte boundary (TMA's need)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mode(band) -> str:
    if isinstance(band, (tuple, list)):
        hi, lo = band
        if hi.dtype != torch.bfloat16 or lo.dtype != torch.bfloat16:
            raise SdpDataTypeError("'high' bands must be a bf16 (hi, lo) pair")
        return "high"
    if band.dtype == torch.bfloat16:
        return "bf16"
    if band.dtype == torch.float32:
        return "highest"
    raise SdpDataTypeError(f"unsupported band dtype {band.dtype}")


def _parts(band):
    return tuple(band) if isinstance(band, (tuple, list)) else (band,)


def _check(device, named, dtype, shape=None):
    for name, t in named:
        if t.device != device:
            raise SdpMemLocationError(
                f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise SdpDataTypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise SdpShapeError(
                f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise SdpInvalidArgumentError(f"{name} must be contiguous")


def _check_common(t_idx, k_idx, g_idx, ubase, wk_t, w_support, block_v,
                  lanes):
    dev = ubase.device
    total = ubase.shape[1]
    if ubase.ndim != 2 or ubase.shape[0] != WIN_ROWS:
        raise SdpShapeError(f"ubase must be [{WIN_ROWS}, V]")
    if block_v <= 0 or total % block_v:
        raise SdpInvalidArgumentError(
            f"stream length {total} is not a multiple of block_v={block_v}")
    if not 1 <= w_support <= _TILE // (2 * WIN_ROWS):
        raise SdpInvalidArgumentError(
            f"w_support must be in [1, {_TILE // (2 * WIN_ROWS)}]")
    nb = total // block_v
    _check(dev, [("t_idx", t_idx), ("k_idx", k_idx), ("g_idx", g_idx)],
           torch.int32, (nb,))
    _check(dev, [("ubase", ubase)], torch.float32)
    _check(dev, [("wk_t", wk_t)], torch.float32, (w_support, total))
    if dev.type == "cuda" and lanes % _TILE:
        raise SdpInvalidArgumentError(
            f"the CUDA kernels need lanes % {_TILE} == 0 (got {lanes})")
    return dev, total, nb


@contextlib.contextmanager
def _full_f32_matmul():
    """True-f32 products on the card (no TF32) for the plain versions."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _products(a: torch.Tensor, band, mode: str) -> torch.Tensor:
    """Batched ``a @ band`` in the mode's arithmetic: f32; bf16-rounded
    a against bf16 band; or hi*hi + (hi*lo + lo*hi) on upcast halves
    (each product exact in f32, same association as the JAX kernels)."""
    with _full_f32_matmul():
        if mode == "highest":
            return torch.bmm(a, band)
        if mode == "bf16":
            return torch.bmm(a.to(torch.bfloat16).float(), band.float())
        a_hi, a_lo = (h.float() for h in split_bf16(a))
        b_hi, b_lo = (h.float() for h in band)
        return torch.bmm(a_hi, b_hi) + (torch.bmm(a_hi, b_lo)
                                        + torch.bmm(a_lo, b_hi))


def _window_rows(t_idx, k_idx, g_idx, w_support, num_layers, lanes):
    """[NB, 2 * w_support * 16] flat stack row of every window row."""
    dev = t_idx.device
    sub_pad = lanes + 8
    h = torch.arange(2, device=dev).reshape(1, 2, 1, 1)
    j = torch.arange(w_support, device=dev).reshape(1, 1, -1, 1)
    r = torch.arange(WIN_ROWS, device=dev).reshape(1, 1, 1, -1)
    t = t_idx.to(torch.int64).reshape(-1, 1, 1, 1)
    k0 = k_idx.to(torch.int64).reshape(-1, 1, 1, 1)
    g8 = 8 * g_idx.to(torch.int64).reshape(-1, 1, 1, 1)
    rows = ((2 * t + h) * (num_layers * sub_pad)
            + (k0 + j) * sub_pad + g8 + r)
    return rows.reshape(t_idx.shape[0], -1)


def _per_block(x: torch.Tensor, nb: int, block_v: int) -> torch.Tensor:
    """[R, V] -> [NB, R, block_v] view."""
    return x.reshape(x.shape[0], nb, block_v).permute(1, 0, 2)


def grid_packed_stack_reference(t_idx, k_idx, g_idx, ubase, vband, scales,
                                num_tasks: int, num_layers: int,
                                lanes: int, w_support: int,
                                block_v: int = 128,
                                runs: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`grid_packed_stack`: gather the
    scale stack per block, one batched product with the block's bands,
    ``index_add_`` into the flattened stack rows (it works per block, so
    ``runs`` is taken and not needed)."""
    wk_t, vre, vim = scales
    mode = _mode(vband)
    total = ubase.shape[1]
    nb = total // block_v
    wk = _per_block(wk_t, nb, block_v)                     # [NB, Sw, B]
    s_all = torch.cat([wk * vre.reshape(nb, 1, block_v),
                       wk * vim.reshape(nb, 1, block_v)], dim=1)
    u_all = (_per_block(ubase, nb, block_v)[:, None, :, :]
             * s_all[:, :, None, :]).reshape(nb, -1, block_v)
    band = tuple(b.reshape(nb, block_v, lanes) for b in vband) \
        if mode == "high" else vband.reshape(nb, block_v, lanes)
    contrib = _products(u_all, band, mode)                 # [NB, M, G]
    out = torch.zeros((num_tasks * 2 * num_layers * (lanes + 8), lanes),
                      dtype=torch.float32, device=ubase.device)
    rows = _window_rows(t_idx, k_idx, g_idx, w_support, num_layers, lanes)
    out.index_add_(0, rows.reshape(-1), contrib.reshape(-1, lanes))
    return out.reshape(num_tasks, 2, num_layers * (lanes + 8), lanes)


def grid_packed_stack(t_idx, k_idx, g_idx, ubase, vband, scales,
                      num_tasks: int, num_layers: int, lanes: int,
                      w_support: int, block_v: int = 128,
                      runs: torch.Tensor = None) -> torch.Tensor:
    """Band-stream packed gridding into per-task tower stacks.

    ``scales`` is ``(wk_t [Sw, V], vre [V], vim [V])`` f32; ``vband`` is
    [V, lanes] f32 / bf16 or a bf16 (hi, lo) pair. Returns the zero-based
    stack f32 ``[num_tasks, 2, num_layers * (lanes + 8), lanes]``
    (rows ``[lanes, lanes + 8)`` of each layer hold the last octet's
    overhang and are cropped by the driver). ``runs``: the kernel's work
    units, rows (first block, block count) inside one bucket that hold
    every block once; the blocks' :func:`band_runs` when not given (the
    tensor-core modes on the card use it; any block order is right).
    """
    wk_t, vre, vim = scales
    mode = _mode(vband)
    dev, total, nb = _check_common(t_idx, k_idx, g_idx, ubase, wk_t,
                                   w_support, block_v, lanes)
    _check(dev, [("vre", vre), ("vim", vim)], torch.float32, (total,))
    for part in _parts(vband):
        _check(dev, [("vband", part)], part.dtype, (total, lanes))
    if dev.type == "cpu":
        return grid_packed_stack_reference(
            t_idx, k_idx, g_idx, ubase, vband, scales, num_tasks,
            num_layers, lanes, w_support, block_v)
    if dev.type != "cuda":
        raise SdpMemLocationError(f"unsupported device {dev}")
    from . import _build

    lib = _build.load()
    out = torch.zeros((num_tasks, 2, num_layers * (lanes + 8), lanes),
                      dtype=torch.float32, device=dev)
    parts = _parts(vband)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if mode == "highest":
            err = lib.sdp_torch_grid_packed_stack(
                t_idx.data_ptr(), k_idx.data_ptr(), g_idx.data_ptr(), nb,
                ubase.data_ptr(), vband.data_ptr(), wk_t.data_ptr(),
                vre.data_ptr(), vim.data_ptr(), total, block_v, w_support,
                lanes, num_layers, out.data_ptr(), stream)
        else:
            runs = _runs_for(runs, t_idx, k_idx, g_idx, block_v)
            ubase, wk_t, vre, vim = (_aligned(x) for x in (ubase, wk_t, vre,
                                                           vim))
            parts = [_aligned(x) for x in parts]
            err = lib.sdp_torch_grid_packed_runs(
                runs.data_ptr(), runs.shape[0], t_idx.data_ptr(),
                k_idx.data_ptr(), g_idx.data_ptr(), ubase.data_ptr(),
                parts[0].data_ptr(), parts[-1].data_ptr(), _MODES[mode],
                wk_t.data_ptr(), vre.data_ptr(), vim.data_ptr(), total,
                block_v, w_support, lanes, num_layers, out.data_ptr(),
                stream)
    _build.check(lib, err, "grid_packed_stack")
    grid_packed_stack.launches += 1
    return out


grid_packed_stack.launches = 0


def degrid_stack_reference(stack, t_idx, k_idx, g_idx, ubase, vband_t,
                           wk_t, w_support: int, block_v: int = 128,
                           runs: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`degrid_stack`: advanced-index the
    windows, one batched product with the block's transposed bands, scale
    by the u-tap x w-tap stack and sum each half's rows (per block:
    ``runs`` is taken and not needed)."""
    mode = _mode(vband_t)
    num_tasks, _, ksp, lanes = stack.shape
    num_layers = ksp // (lanes + 8)
    total = ubase.shape[1]
    nb = total // block_v
    rows = _window_rows(t_idx, k_idx, g_idx, w_support, num_layers, lanes)
    win = stack.reshape(-1, lanes)[rows.reshape(-1)].reshape(nb, -1, lanes)
    band = tuple(_per_block(b, nb, block_v) for b in vband_t) \
        if mode == "high" else _per_block(vband_t, nb, block_v)
    t_T = _products(win, band, mode)                       # [NB, M, B]
    uwh = (_per_block(ubase, nb, block_v)[:, None, :, :]
           * _per_block(wk_t, nb, block_v)[:, :, None, :]
           ).reshape(nb, -1, block_v)                      # [NB, M/2, B]
    half = uwh.shape[1]
    prod = torch.cat([uwh, uwh], dim=1) * t_T
    return torch.complex(prod[:, :half].sum(dim=1).reshape(-1),
                         prod[:, half:].sum(dim=1).reshape(-1))


def degrid_stack(stack, t_idx, k_idx, g_idx, ubase, vband_t, wk_t,
                 w_support: int, block_v: int = 128,
                 runs: torch.Tensor = None) -> torch.Tensor:
    """Band-stream degridding from per-task tower stacks.

    ``stack``: f32 [T, 2, K * (lanes + 8), lanes] (the layout
    :func:`grid_packed_stack` produces); ``vband_t``: [lanes, V] f32 /
    bf16 or a bf16 (hi, lo) pair. Returns complex64 [V] in sorted order.
    ``runs`` as in :func:`grid_packed_stack`.
    """
    mode = _mode(vband_t)
    if stack.ndim != 4 or stack.shape[1] != 2:
        raise SdpShapeError("stack must be [T, 2, K * (lanes + 8), lanes]")
    num_tasks, _, ksp, lanes = stack.shape
    if ksp % (lanes + 8):
        raise SdpShapeError("stack rows must be K * (lanes + 8)")
    num_layers = ksp // (lanes + 8)
    dev, total, nb = _check_common(t_idx, k_idx, g_idx, ubase, wk_t,
                                   w_support, block_v, lanes)
    _check(dev, [("stack", stack)], torch.float32)
    for part in _parts(vband_t):
        _check(dev, [("vband_t", part)], part.dtype, (lanes, total))
    if dev.type == "cpu":
        return degrid_stack_reference(stack, t_idx, k_idx, g_idx, ubase,
                                      vband_t, wk_t, w_support, block_v)
    if dev.type != "cuda":
        raise SdpMemLocationError(f"unsupported device {dev}")
    from . import _build

    lib = _build.load()
    parts = _parts(vband_t)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if mode == "highest":
            out = torch.empty((2, total), dtype=torch.float32, device=dev)
            err = lib.sdp_torch_degrid_stack(
                stack.data_ptr(), t_idx.data_ptr(), k_idx.data_ptr(),
                g_idx.data_ptr(), nb, ubase.data_ptr(), vband_t.data_ptr(),
                wk_t.data_ptr(), total, block_v, w_support, lanes,
                num_layers, out.data_ptr(), stream)
        else:
            runs = _runs_for(runs, t_idx, k_idx, g_idx, block_v)
            # Lane tiles past the first add into the result.
            out = (torch.zeros if lanes > _TILE else torch.empty)(
                (2, total), dtype=torch.float32, device=dev)
            stack, ubase, wk_t = (_aligned(x) for x in (stack, ubase, wk_t))
            parts = [_aligned(x) for x in parts]
            err = lib.sdp_torch_degrid_runs(
                stack.data_ptr(), runs.data_ptr(), runs.shape[0],
                t_idx.data_ptr(), k_idx.data_ptr(), g_idx.data_ptr(),
                ubase.data_ptr(), parts[0].data_ptr(), parts[-1].data_ptr(),
                _MODES[mode], wk_t.data_ptr(), total, block_v, w_support,
                lanes, num_layers, out.data_ptr(), stream)
    _build.check(lib, err, "degrid_stack")
    degrid_stack.launches += 1
    return torch.complex(out[0], out[1])


degrid_stack.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {"grid_packed_stack": grid_packed_stack.launches,
            "degrid_stack": degrid_stack.launches}


def reset_launch_counts() -> None:
    grid_packed_stack.launches = 0
    degrid_stack.launches = 0
