"""Band-engine packed gridding / degridding: CUDA kernels and plain twins.

Counterpart of the main-path half of ska_sdp_func_tpu.kernels.packed_tap:

- :func:`split_bf16` and :func:`build_bands` are torch ops (XLA glue in
  the JAX package);
- :func:`grid_packed_stack` replaces the Pallas kernel
  ``grid_packed_stack_pallas`` and :func:`degrid_stack` replaces
  ``degrid_stack_pallas``. On a CUDA tensor each launches its
  hand-written kernel (``csrc/packed_tap.cu``, built by :mod:`._build`)
  or raises; on a CPU tensor it runs its plain PyTorch version
  (``*_reference``). Each counts its kernel launches in ``.launches``.

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

import torch

from ..utility.errors import (
    SdpDataTypeError,
    SdpInvalidArgumentError,
    SdpMemLocationError,
    SdpShapeError,
)

WIN_ROWS = 16             # 8-aligned octet base + support (<= 8)
_TILE = 128               # the CUDA kernels' lane tile
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
    ``vband[p, iv0[p] + s] = vk[p, s]``, zero elsewhere. Each entry
    receives at most one tap, so the scatters equal the JAX version's
    sum of masked selects exactly.
    """
    support = uk.shape[1]
    total = u_off.shape[0]
    dev = uk.device
    s = torch.arange(support, device=dev)
    vband = torch.zeros((total, lanes), dtype=torch.float32, device=dev)
    vband.scatter_(1, iv0.to(torch.int64)[:, None] + s[None, :],
                   vk.to(torch.float32))
    ubase = torch.zeros((WIN_ROWS, total), dtype=torch.float32, device=dev)
    ubase.scatter_(0, u_off.to(torch.int64)[None, :] + s[:, None],
                   uk.to(torch.float32).T)
    return ubase, vband, vband.T.contiguous()


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
                                block_v: int = 128) -> torch.Tensor:
    """Plain PyTorch version of :func:`grid_packed_stack`: gather the
    scale stack per block, one batched product with the block's bands,
    ``index_add_`` into the flattened stack rows."""
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
                      w_support: int, block_v: int = 128) -> torch.Tensor:
    """Band-stream packed gridding into per-task tower stacks.

    ``scales`` is ``(wk_t [Sw, V], vre [V], vim [V])`` f32; ``vband`` is
    [V, lanes] f32 / bf16 or a bf16 (hi, lo) pair. Returns the zero-based
    stack f32 ``[num_tasks, 2, num_layers * (lanes + 8), lanes]``
    (rows ``[lanes, lanes + 8)`` of each layer hold the last octet's
    overhang and are cropped by the driver).
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
    vb1 = parts[1].data_ptr() if mode == "high" else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_grid_packed_stack(
            t_idx.data_ptr(), k_idx.data_ptr(), g_idx.data_ptr(), nb,
            ubase.data_ptr(), parts[0].data_ptr(), vb1, _MODES[mode],
            wk_t.data_ptr(), vre.data_ptr(), vim.data_ptr(), total,
            block_v, w_support, lanes, num_layers, out.data_ptr(), stream)
    _build.check(lib, err, "grid_packed_stack")
    grid_packed_stack.launches += 1
    return out


grid_packed_stack.launches = 0


def degrid_stack_reference(stack, t_idx, k_idx, g_idx, ubase, vband_t,
                           wk_t, w_support: int,
                           block_v: int = 128) -> torch.Tensor:
    """Plain PyTorch version of :func:`degrid_stack`: advanced-index the
    windows, one batched product with the block's transposed bands, scale
    by the u-tap x w-tap stack and sum each half's rows."""
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
                 w_support: int, block_v: int = 128) -> torch.Tensor:
    """Band-stream degridding from per-task tower stacks.

    ``stack``: f32 [T, 2, K * (lanes + 8), lanes] (the layout
    :func:`grid_packed_stack` produces); ``vband_t``: [lanes, V] f32 /
    bf16 or a bf16 (hi, lo) pair. Returns complex64 [V] in sorted order.
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
    out = torch.empty((2, total), dtype=torch.float32, device=dev)
    parts = _parts(vband_t)
    vb1 = parts[1].data_ptr() if mode == "high" else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_degrid_stack(
            stack.data_ptr(), t_idx.data_ptr(), k_idx.data_ptr(),
            g_idx.data_ptr(), nb, ubase.data_ptr(), parts[0].data_ptr(),
            vb1, _MODES[mode], wk_t.data_ptr(), total, block_v,
            w_support, lanes, num_layers, out.data_ptr(), stream)
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
