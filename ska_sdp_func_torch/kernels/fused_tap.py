"""Fused and compact packed gridding / degridding into per-task stacks.

Counterpart of ska_sdp_func_tpu.kernels.fused_tap (the stack forms the
streaming engine and the packed ``engine="fused"``/``"compact"`` run):

- :func:`grid_fused_stack` replaces the Pallas kernel
  ``grid_fused_stack_pallas`` and :func:`degrid_fused2_stack` replaces
  ``degrid_fused2_stack_pallas``: taps evaluated in the kernel;
- :func:`grid_compact` replaces ``grid_compact_pallas`` and
  :func:`degrid_compact` replaces ``degrid_compact_pallas``: taps
  pre-evaluated once per plan (``uk_t``/``vk_t`` [S, V], ``wk_t`` [Sw, V]
  f32, ``wk_t`` zero on padding and invalid slots) and read per slot with
  the plan word ``pa``;
- :func:`pack_plan_words` / :func:`unpack_plan_words` and the tap
  evaluation :func:`cheb_taps` are torch (and NumPy) ops.

On a CUDA tensor each kernel wrapper launches its hand-written kernel
(``csrc/fused_tap.cu``) or raises; on a CPU tensor it runs its plain
PyTorch version (``*_reference``). Each counts its kernel launches in
``.launches``.

Plan words (bit for bit the JAX layout):

* ``pa = iv0 << 20 | u_off << 17 | w_row``;
* ``pb = valid << 30 | u_frac << 15 | v_frac``.

Each slot's taps are Chebyshev sums ``tap[s] = sum_d c[d, s] T_d(x)``,
``x = (2 / ov) * frac - 1``, with ``T_d`` from the three-term recurrence.
The plain versions and the CUDA kernels round every operation of the
evaluation on its own, in the same order, so both see identical taps;
they differ from each other only in the order of the sums over slots.

A slot's contribution to its bucket window (``WIN_ROWS``-row u band,
``lanes``-wide v band, the row layout of :mod:`.packed_tap`) is

    grid:   win[h, j, u_off + su, iv0 + sv] += P(uk[su] * (wk[j] * v_h), vk[sv])
    degrid: v_h = sum_{j, su} (uk[su] * wk[j] * valid)
                  * sum_sv P(win[h, j, u_off + su, iv0 + sv], vk[sv])

with ``P`` the mode's product: f32 ("highest"); bf16 hi/lo halves
``hi*hi + (hi*lo + lo*hi)`` ("high"); bf16-rounded factors ("bf16").
Taps at v columns ``>= lanes`` are dropped, as the Pallas band build
drops them.
"""

import numpy as np
import torch

from .packed_tap import WIN_ROWS, _check, split_bf16
from ..utility.errors import (
    SdpInvalidArgumentError,
    SdpMemLocationError,
    SdpShapeError,
)

# Packed-word field limits (the JAX package's).
MAX_IV0 = 2047
MAX_OVERSAMPLING = 32768
MAX_W_OVERSAMPLING = 131072

_MODES = {"highest": 0, "high": 1, "bf16": 2}
_MAX_SUPPORT = 8
_MAX_W_SUPPORT = 4
_MAX_COEFFS = 16
# Slots per chunk of the plain versions: bounds their [n, 2, Sw, S, S]
# temporaries (~2 KB per slot each) on the card at streaming widths.
_REF_CHUNK = 65536


def fused_geometry_ok(subgrid_size: int, support: int, oversampling: int,
                      w_oversampling: int) -> bool:
    """True when the plan fields fit the packed int32 words."""
    return (subgrid_size - support <= MAX_IV0
            and oversampling <= MAX_OVERSAMPLING
            and w_oversampling <= MAX_W_OVERSAMPLING)


def pack_plan_words(iv0, u_off, w_row, u_frac, v_frac, valid):
    """Bit-pack the per-slot plan fields into two int32 words (NumPy
    arrays or torch tensors; ``valid`` bool or {0, 1} int)."""
    if isinstance(iv0, np.ndarray):
        def i32(x):
            return np.asarray(x).astype(np.int32)
    else:
        def i32(x):
            return x.to(torch.int32)
    pa = (i32(iv0) << 20) | (i32(u_off) << 17) | i32(w_row)
    pb = (i32(valid) << 30) | (i32(u_frac) << 15) | i32(v_frac)
    return pa, pb


def unpack_plan_words(pa, pb):
    """(iv0, u_off, w_row, u_frac, v_frac, valid) of int32 words."""
    return (pa >> 20, (pa >> 17) & 7, pa & (MAX_W_OVERSAMPLING - 1),
            (pb >> 15) & (MAX_OVERSAMPLING - 1),
            pb & (MAX_OVERSAMPLING - 1), pb >> 30)


def _inv2(oversampling: int) -> float:
    """2 / ov rounded to f32 (the scale of the Chebyshev argument)."""
    return float(np.float32(2.0 / oversampling))


def cheb_taps(frac: torch.Tensor, coeffs: torch.Tensor,
              oversampling: int) -> torch.Tensor:
    """Kernel taps [n, S] f32 of integer rows ``frac`` [n].

    ``coeffs``: f32 [degree + 1, S] Chebyshev coefficients. The basis
    ``T_0..T_degree`` of ``x = (2 / ov) * frac - 1`` comes from the
    recurrence ``T_{d+1} = (2x) T_d - T_{d-1}`` and the taps are summed in
    order d = 0..degree, each operation rounded on its own (the CUDA
    kernels' order).
    """
    x = _inv2(oversampling) * frac.to(torch.float32) - 1.0
    two_x = 2.0 * x
    t_prev, t = torch.ones_like(x), x
    acc = coeffs[0][None, :] * t_prev[:, None]
    for d in range(1, coeffs.shape[0]):
        if d > 1:
            t_prev, t = t, two_x * t - t_prev
        acc = acc + coeffs[d][None, :] * t[:, None]
    return acc


def _split(x: torch.Tensor):
    hi, lo = split_bf16(x)
    return hi.float(), lo.float()


def _prod(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """Elementwise product in the mode's arithmetic (module docstring)."""
    if mode == "highest":
        return a * b
    if mode == "bf16":
        return a.to(torch.bfloat16).float() * b.to(torch.bfloat16).float()
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return a_hi * b_hi + (a_hi * b_lo + a_lo * b_hi)


def _slot_taps(pa, pb, uv_coeffs, w_coeffs, oversampling, w_oversampling):
    iv0, u_off, w_row, u_frac, v_frac, valid = unpack_plan_words(pa, pb)
    uk = cheb_taps(u_frac, uv_coeffs, oversampling)
    vk = cheb_taps(v_frac, uv_coeffs, oversampling)
    wk = cheb_taps(w_row, w_coeffs, w_oversampling)
    return iv0, u_off, valid, uk, vk, wk


def _compact_taps(p, pa, uk_t, vk_t, wk_t):
    """The fields of slots ``p`` in the compact form (``wk_t`` carries
    the valid mask)."""
    a = pa[p]
    return (a >> 20, (a >> 17) & 7, torch.ones_like(a), uk_t[:, p].T,
            vk_t[:, p].T, wk_t[:, p].T)


def _window_index(t, k0, g, u_off, iv0, num_layers, lanes, support,
                  w_support):
    """Flat stack index [n, 2, Sw, S, S] of each slot's window taps and
    the mask of taps inside the ``lanes`` columns."""
    dev = t.device
    sub_pad = lanes + 8
    h = torch.arange(2, device=dev).reshape(1, 2, 1, 1, 1)
    j = torch.arange(w_support, device=dev).reshape(1, 1, -1, 1, 1)
    su = torch.arange(support, device=dev).reshape(1, 1, 1, -1, 1)
    sv = torch.arange(support, device=dev).reshape(1, 1, 1, 1, -1)

    def col(x):
        return x.to(torch.int64).reshape(-1, 1, 1, 1, 1)

    rows = ((2 * col(t) + h) * num_layers + col(k0) + j) * sub_pad \
        + 8 * col(g) + col(u_off) + su
    cols = col(iv0) + sv
    inside = cols < lanes
    return rows * lanes + torch.where(inside, cols, 0), inside


def _occupied_slots(nonempty, num_blocks, block_v, device):
    """Slot indices of the blocks ``nonempty`` marks occupied."""
    blocks = torch.arange(num_blocks, device=device)
    if nonempty is not None:
        blocks = blocks[nonempty != 0]
    return (blocks[:, None] * block_v
            + torch.arange(block_v, device=device)[None, :]).reshape(-1)


def _grid_reference(taps_of, t_idx, k_idx, g_idx, vre, vim, num_tasks,
                    num_layers, lanes, support, w_support, block_v,
                    precision, nonempty):
    """Per slot, the ``2 x Sw x S x S`` window taps of ``taps_of(p)``,
    ``index_add_`` into the flat stack (chunked over slots)."""
    dev = vre.device
    total = vre.shape[0]
    out = torch.zeros(num_tasks * 2 * num_layers * (lanes + 8) * lanes,
                      dtype=torch.float32, device=dev)
    slots = _occupied_slots(nonempty, total // block_v, block_v, dev)
    for lo in range(0, slots.shape[0], _REF_CHUNK):
        p = slots[lo:lo + _REF_CHUNK]
        b = p // block_v
        iv0, u_off, _, uk, vk, wk = taps_of(p)
        v = torch.stack([vre[p], vim[p]], dim=1)               # [n, 2]
        a = uk[:, None, None, :] * (wk[:, None, :, None]
                                    * v[:, :, None, None])    # [n,2,Sw,S]
        val = _prod(a[..., None], vk[:, None, None, None, :], precision)
        idx, inside = _window_index(t_idx[b], k_idx[b], g_idx[b], u_off,
                                    iv0, num_layers, lanes, support,
                                    w_support)
        out.index_add_(0, idx.reshape(-1),
                       torch.where(inside, val, 0.0).reshape(-1))
    return out.reshape(num_tasks, 2, num_layers * (lanes + 8), lanes)


def grid_fused_stack_reference(t_idx, k_idx, g_idx, pa, pb, vre, vim,
                               uv_coeffs, w_coeffs, num_tasks: int,
                               num_layers: int, lanes: int, support: int,
                               w_support: int, oversampling: int,
                               w_oversampling: int, block_v: int = 1024,
                               precision: str = "highest",
                               nonempty=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`grid_fused_stack`."""
    return _grid_reference(
        lambda p: _slot_taps(pa[p], pb[p], uv_coeffs, w_coeffs,
                             oversampling, w_oversampling),
        t_idx, k_idx, g_idx, vre, vim, num_tasks, num_layers, lanes,
        support, w_support, block_v, precision, nonempty)


def grid_compact_reference(t_idx, k_idx, g_idx, pa, uk_t, vk_t, wk_t, vre,
                           vim, num_tasks: int, num_layers: int, lanes: int,
                           support: int, w_support: int, block_v: int = 1024,
                           precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch version of :func:`grid_compact`."""
    return _grid_reference(
        lambda p: _compact_taps(p, pa, uk_t, vk_t, wk_t), t_idx, k_idx,
        g_idx, vre, vim, num_tasks, num_layers, lanes, support, w_support,
        block_v, precision, None)


def _degrid_reference(taps_of, stack, t_idx, k_idx, g_idx, total, support,
                      w_support, block_v, precision, nonempty):
    """Per slot, gather the ``2 x Sw x S x S`` window taps and contract
    them with the v, u and w taps of ``taps_of(p)`` (chunked over
    slots)."""
    dev = stack.device
    num_tasks, _, ksp, lanes = stack.shape
    num_layers = ksp // (lanes + 8)
    flat = stack.reshape(-1)
    out = torch.zeros(total, dtype=torch.complex64, device=dev)
    slots = _occupied_slots(nonempty, total // block_v, block_v, dev)
    for lo in range(0, slots.shape[0], _REF_CHUNK):
        p = slots[lo:lo + _REF_CHUNK]
        b = p // block_v
        iv0, u_off, valid, uk, vk, wk = taps_of(p)
        idx, inside = _window_index(t_idx[b], k_idx[b], g_idx[b], u_off,
                                    iv0, num_layers, lanes, support,
                                    w_support)
        win = torch.where(inside, flat[idx], 0.0)             # [n,2,Sw,S,S]
        t = _prod(win, vk[:, None, None, None, :], precision).sum(dim=-1)
        wkv = wk * valid.to(torch.float32)[:, None]
        uw = uk[:, None, :] * wkv[:, :, None]                 # [n, Sw, S]
        re = (uw * t[:, 0]).sum(dim=(1, 2))
        im = (uw * t[:, 1]).sum(dim=(1, 2))
        out[p] = torch.complex(re, im)
    return out


def degrid_fused2_stack_reference(stack, t_idx, k_idx, g_idx, pa, pb,
                                  uv_coeffs, w_coeffs, support: int,
                                  w_support: int, oversampling: int,
                                  w_oversampling: int, block_v: int = 1024,
                                  precision: str = "highest",
                                  nonempty=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`degrid_fused2_stack`."""
    return _degrid_reference(
        lambda p: _slot_taps(pa[p], pb[p], uv_coeffs, w_coeffs,
                             oversampling, w_oversampling),
        stack, t_idx, k_idx, g_idx, pa.shape[0], support, w_support,
        block_v, precision, nonempty)


def degrid_compact_reference(stack, t_idx, k_idx, g_idx, pa, uk_t, vk_t,
                             wk_t, support: int, w_support: int,
                             block_v: int = 512,
                             precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch version of :func:`degrid_compact`."""
    return _degrid_reference(
        lambda p: _compact_taps(p, pa, uk_t, vk_t, wk_t), stack, t_idx,
        k_idx, g_idx, pa.shape[0], support, w_support, block_v, precision,
        None)


def _check_blocks(t_idx, k_idx, g_idx, pa, support, w_support, block_v,
                  lanes, precision, nonempty=None):
    """Checks shared by the fused and compact wrappers."""
    dev = pa.device
    if precision not in _MODES:
        raise SdpInvalidArgumentError(f"unknown precision {precision!r}")
    if pa.ndim != 1:
        raise SdpShapeError("pa must be 1-D [V]")
    total = pa.shape[0]
    if block_v <= 0 or total % block_v:
        raise SdpInvalidArgumentError(
            f"stream length {total} is not a multiple of block_v={block_v}")
    if not (1 <= support <= _MAX_SUPPORT
            and 1 <= w_support <= _MAX_W_SUPPORT):
        raise SdpInvalidArgumentError(
            f"support must be in [1, {_MAX_SUPPORT}] and w_support in "
            f"[1, {_MAX_W_SUPPORT}]")
    nb = total // block_v
    named = [("t_idx", t_idx), ("k_idx", k_idx), ("g_idx", g_idx)]
    if nonempty is not None:
        named.append(("nonempty", nonempty))
    _check(dev, named, torch.int32, (nb,))
    _check(dev, [("pa", pa)], torch.int32, (total,))
    if dev.type not in ("cpu", "cuda"):
        raise SdpMemLocationError(f"unsupported device {dev}")
    if dev.type == "cuda" and lanes % 8:
        raise SdpInvalidArgumentError(
            f"the CUDA kernels need lanes % 8 == 0 (got {lanes})")
    return dev, total, nb


def _check_fused(t_idx, k_idx, g_idx, pa, pb, uv_coeffs, w_coeffs,
                 support, w_support, block_v, lanes, precision, nonempty):
    dev, total, nb = _check_blocks(t_idx, k_idx, g_idx, pa, support,
                                   w_support, block_v, lanes, precision,
                                   nonempty)
    _check(dev, [("pb", pb)], torch.int32, (total,))
    ncoef = uv_coeffs.shape[0]
    if not 1 <= ncoef <= _MAX_COEFFS:
        raise SdpInvalidArgumentError(
            f"tap fits must have 1..{_MAX_COEFFS} coefficients")
    _check(dev, [("uv_coeffs", uv_coeffs)], torch.float32, (ncoef, support))
    _check(dev, [("w_coeffs", w_coeffs)], torch.float32,
           (ncoef, w_support))
    return dev, total, nb, ncoef


def _check_compact(t_idx, k_idx, g_idx, pa, uk_t, vk_t, wk_t, support,
                   w_support, block_v, lanes, precision):
    dev, total, nb = _check_blocks(t_idx, k_idx, g_idx, pa, support,
                                   w_support, block_v, lanes, precision)
    _check(dev, [("uk_t", uk_t), ("vk_t", vk_t)], torch.float32,
           (support, total))
    _check(dev, [("wk_t", wk_t)], torch.float32, (w_support, total))
    return dev, total, nb


def grid_fused_stack(t_idx, k_idx, g_idx, pa, pb, vre, vim, uv_coeffs,
                     w_coeffs, num_tasks: int, num_layers: int, lanes: int,
                     support: int, w_support: int, oversampling: int,
                     w_oversampling: int, block_v: int = 1024,
                     precision: str = "highest",
                     nonempty=None) -> torch.Tensor:
    """Fused gridding of the placed stream into per-task tower stacks.

    t_idx/k_idx/g_idx: [NB] int32 per-block (task, w-slab, u-octet);
    pa/pb: [V] int32 plan words; vre/vim: [V] f32 (zero on padding
    slots); uv_coeffs/w_coeffs: f32 Chebyshev fits on the same device;
    ``nonempty``: optional [NB] int32, 0-marked blocks are skipped.
    Returns the zero-based stack f32 ``[num_tasks, 2, num_layers *
    (lanes + 8), lanes]``; tasks no block visits stay zero.
    """
    dev, total, nb, ncoef = _check_fused(
        t_idx, k_idx, g_idx, pa, pb, uv_coeffs, w_coeffs, support,
        w_support, block_v, lanes, precision, nonempty)
    _check(dev, [("vre", vre), ("vim", vim)], torch.float32, (total,))
    if dev.type == "cpu":
        return grid_fused_stack_reference(
            t_idx, k_idx, g_idx, pa, pb, vre, vim, uv_coeffs, w_coeffs,
            num_tasks, num_layers, lanes, support, w_support, oversampling,
            w_oversampling, block_v, precision, nonempty)
    from . import _build

    lib = _build.load()
    out = torch.zeros((num_tasks, 2, num_layers * (lanes + 8), lanes),
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_fused_grid_stack(
            t_idx.data_ptr(), k_idx.data_ptr(), g_idx.data_ptr(),
            None if nonempty is None else nonempty.data_ptr(),
            pa.data_ptr(), pb.data_ptr(), vre.data_ptr(), vim.data_ptr(),
            uv_coeffs.data_ptr(), w_coeffs.data_ptr(), None, None, None,
            ncoef, _inv2(oversampling), _inv2(w_oversampling), nb, block_v,
            support, w_support, lanes, num_layers, _MODES[precision],
            out.data_ptr(), stream)
    _build.check(lib, err, "grid_fused_stack")
    grid_fused_stack.launches += 1
    return out


grid_fused_stack.launches = 0


def degrid_fused2_stack(stack, t_idx, k_idx, g_idx, pa, pb, uv_coeffs,
                        w_coeffs, support: int, w_support: int,
                        oversampling: int, w_oversampling: int,
                        block_v: int = 1024, precision: str = "highest",
                        nonempty=None) -> torch.Tensor:
    """Fused degridding from per-task tower stacks.

    ``stack``: f32 [T, 2, K * (lanes + 8), lanes] (the layout
    :func:`grid_fused_stack` produces); other operands as there (the
    ``valid`` bit of ``pb`` zeroes padding slots). Returns complex64 [V]
    in stream order; 0-marked blocks predict zero.
    """
    if stack.ndim != 4 or stack.shape[1] != 2:
        raise SdpShapeError("stack must be [T, 2, K * (lanes + 8), lanes]")
    lanes = stack.shape[3]
    if stack.shape[2] % (lanes + 8):
        raise SdpShapeError("stack rows must be K * (lanes + 8)")
    num_layers = stack.shape[2] // (lanes + 8)
    dev, total, nb, ncoef = _check_fused(
        t_idx, k_idx, g_idx, pa, pb, uv_coeffs, w_coeffs, support,
        w_support, block_v, lanes, precision, nonempty)
    _check(dev, [("stack", stack)], torch.float32)
    if dev.type == "cpu":
        return degrid_fused2_stack_reference(
            stack, t_idx, k_idx, g_idx, pa, pb, uv_coeffs, w_coeffs,
            support, w_support, oversampling, w_oversampling, block_v,
            precision, nonempty)
    from . import _build

    lib = _build.load()
    out = torch.empty((2, total), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_fused_degrid_stack(
            stack.data_ptr(), t_idx.data_ptr(), k_idx.data_ptr(),
            g_idx.data_ptr(),
            None if nonempty is None else nonempty.data_ptr(),
            pa.data_ptr(), pb.data_ptr(), uv_coeffs.data_ptr(),
            w_coeffs.data_ptr(), None, None, None, ncoef,
            _inv2(oversampling), _inv2(w_oversampling), total, block_v,
            support, w_support, lanes, num_layers, _MODES[precision],
            out.data_ptr(), stream)
    _build.check(lib, err, "degrid_fused2_stack")
    degrid_fused2_stack.launches += 1
    return torch.complex(out[0], out[1])


degrid_fused2_stack.launches = 0


def grid_compact(t_idx, k_idx, g_idx, pa, uk_t, vk_t, wk_t, vre, vim,
                 num_tasks: int, num_layers: int, lanes: int, support: int,
                 w_support: int, block_v: int = 1024,
                 precision: str = "highest") -> torch.Tensor:
    """Compact-tap gridding of the sorted stream into per-task stacks.

    t_idx/k_idx/g_idx: [NB] int32 per-block (task, w-slab, u-octet);
    ``pa`` [V] int32 plan words (``iv0``, ``u_off``); ``uk_t``/``vk_t``
    [S, V] and ``wk_t`` [Sw, V] f32 pre-evaluated taps; vre/vim [V] f32
    (zero on padding slots). Returns the zero-based stack f32
    ``[num_tasks, 2, num_layers * (lanes + 8), lanes]``.
    """
    dev, total, nb = _check_compact(t_idx, k_idx, g_idx, pa, uk_t, vk_t,
                                    wk_t, support, w_support, block_v, lanes,
                                    precision)
    _check(dev, [("vre", vre), ("vim", vim)], torch.float32, (total,))
    if dev.type == "cpu":
        return grid_compact_reference(
            t_idx, k_idx, g_idx, pa, uk_t, vk_t, wk_t, vre, vim, num_tasks,
            num_layers, lanes, support, w_support, block_v, precision)
    from . import _build

    lib = _build.load()
    out = torch.zeros((num_tasks, 2, num_layers * (lanes + 8), lanes),
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_fused_grid_stack(
            t_idx.data_ptr(), k_idx.data_ptr(), g_idx.data_ptr(), None,
            pa.data_ptr(), None, vre.data_ptr(), vim.data_ptr(), None, None,
            uk_t.data_ptr(), vk_t.data_ptr(), wk_t.data_ptr(), 0, 0.0, 0.0,
            nb, block_v, support, w_support, lanes, num_layers,
            _MODES[precision], out.data_ptr(), stream)
    _build.check(lib, err, "grid_compact")
    grid_compact.launches += 1
    return out


grid_compact.launches = 0


def degrid_compact(stack, t_idx, k_idx, g_idx, pa, uk_t, vk_t, wk_t,
                   support: int, w_support: int, block_v: int = 512,
                   precision: str = "highest") -> torch.Tensor:
    """Compact-tap degridding from per-task tower stacks.

    ``stack``: f32 [T, 2, K * (lanes + 8), lanes]; other operands as in
    :func:`grid_compact` (``wk_t`` zero on padding and invalid slots).
    Returns complex64 [V] in stream order.
    """
    if stack.ndim != 4 or stack.shape[1] != 2:
        raise SdpShapeError("stack must be [T, 2, K * (lanes + 8), lanes]")
    lanes = stack.shape[3]
    if stack.shape[2] % (lanes + 8):
        raise SdpShapeError("stack rows must be K * (lanes + 8)")
    num_layers = stack.shape[2] // (lanes + 8)
    dev, total, nb = _check_compact(t_idx, k_idx, g_idx, pa, uk_t, vk_t,
                                    wk_t, support, w_support, block_v, lanes,
                                    precision)
    _check(dev, [("stack", stack)], torch.float32)
    if dev.type == "cpu":
        return degrid_compact_reference(
            stack, t_idx, k_idx, g_idx, pa, uk_t, vk_t, wk_t, support,
            w_support, block_v, precision)
    from . import _build

    lib = _build.load()
    out = torch.empty((2, total), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_fused_degrid_stack(
            stack.data_ptr(), t_idx.data_ptr(), k_idx.data_ptr(),
            g_idx.data_ptr(), None, pa.data_ptr(), None, None, None,
            uk_t.data_ptr(), vk_t.data_ptr(), wk_t.data_ptr(), 0, 0.0, 0.0,
            total, block_v, support, w_support, lanes, num_layers,
            _MODES[precision], out.data_ptr(), stream)
    _build.check(lib, err, "degrid_compact")
    degrid_compact.launches += 1
    return torch.complex(out[0], out[1])


degrid_compact.launches = 0

_WRAPPERS = (grid_fused_stack, degrid_fused2_stack, grid_compact,
             degrid_compact)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def reset_launch_counts() -> None:
    for f in _WRAPPERS:
        f.launches = 0
