"""Packed (bucket-sorted) execution of the ES-FFT gridder: the card's path
behind :class:`~ska_sdp_func_torch.grid_data.es_fft.GridderUvwEsFft`.

Counterpart of ska_sdp_func_tpu.grid_data.es_fft_packed. The ES gridder
has the w-towers tap structure (separable ``support^2`` uv taps times a
``support``-plane exp-semicircle w window), so it runs the bucket-window
kernels of :mod:`..kernels.band_tap`:

- the "subgrid" is the whole padded uv grid, so the v axis is bucketed
  too: buckets are (w-slab k0, u-octet, v-128-block) and windows are
  ``[2 * support * 16, 256]`` (an aligned 128-lane block and its
  straddle);
- gridding runs :func:`~..kernels.band_tap.grid_packed` once per w-slab
  over the slab's contiguous block range into slab-local windows, which
  :func:`_fold_slab` adds onto the padded planes;
- degridding runs :func:`~..kernels.band_tap.degrid_fused` once over all
  blocks, each window read straight from the padded plane stack;
- visibilities with w < 0 are flipped (conjugated) as the reference
  kernel does (sdp_gridder_uvw_es_fft_kernels.cu:127-277); the flip sign
  rides the plan.

The host plan is built once from the plan's uvw/freq (f64 NumPy, arrays
identical to the JAX package's); executing with other uvw than the plan
was built from is undefined, as in the reference. Visibilities whose uv
footprint leaves the padded grid are dropped (counted in
``num_clipped``). The kernels take the compact per-slot taps (``u_off``,
``iv0_local``, ``uk``/``vk`` [V, S]): 72 B per slot on the device where
the JAX package keeps the dense bands (1 KiB per slot each way).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..fourier_transforms.fft import fft_shifted, ifft_shifted
from ..kernels.band_tap import degrid_fused, grid_packed
from ..kernels.packed_tap import WIN_ROWS
from ..utility.constants import C_0

_LANES = 256          # aligned 128-lane block + straddle


def _es_np(beta, x):
    inside = np.abs(x) <= 1.0
    safe = np.where(inside, x, 0.0)
    return np.where(inside,
                    np.exp(beta * (np.sqrt(1.0 - safe * safe) - 1.0)),
                    0.0)


@dataclass
class EsPackedPlan:
    """Host bucketing (``arrays``, f64 NumPy as in the JAX package) and,
    after :func:`attach`, its tensors on the plan's device (``dev``)."""

    total: int
    num_blocks: int
    block_v: int
    num_w_grids: int
    w_support: int           # ES w-window = uv support (1 in 2D)
    num_slabs: int
    gu: int                  # u octet blocks
    gv: int                  # v 128-lane blocks
    rows_pad: int
    lanes_pad: int
    slab_blocks: List[Tuple[int, int]]      # per-slab block ranges
    num_clipped: int
    arrays: Dict[str, np.ndarray] = field(repr=False, default=None)
    dev: dict = field(repr=False, default=None)


def build_es_packed_plan(plan, uvw: np.ndarray, freq: np.ndarray,
                         block_v: int = 128):
    """Host bucketing for a GridderUvwEsFft plan (f64 NumPy), attached to
    the plan's device. Returns None when the geometry cannot use the
    packed path (support > 8, which only double-precision plans pick)."""
    support = plan.support
    if support > 8:
        return None
    G = plan.grid_size
    hs = support / 2.0
    sw = support if plan.do_wstacking else 1
    K = plan.num_total_w_grids
    num_slabs = max(K - sw + 1, 1)

    uvw = np.asarray(uvw, np.float64)
    freq = np.asarray(freq, np.float64)
    R, C = uvw.shape[0], freq.shape[0]
    flip = np.where(uvw[:, 2] < 0, -1.0, 1.0) if plan.do_wstacking \
        else np.ones(R)
    inv_wave = flip[:, None] * freq[None, :] / C_0            # [R, C]
    pos_u = uvw[:, 0:1] * inv_wave * plan.uv_scale
    pos_v = uvw[:, 1:2] * inv_wave * plan.uv_scale
    if plan.do_wstacking:
        pos_w = (uvw[:, 2:3] * inv_wave - plan.min_plane_w) * plan.w_scale
    else:
        pos_w = np.zeros_like(pos_u)

    u0 = np.ceil(pos_u - hs).astype(np.int64)
    v0 = np.ceil(pos_v - hs).astype(np.int64)
    iu0 = (u0 + G // 2).ravel()
    iv0 = (v0 + G // 2).ravel()
    ok = ((iu0 >= 0) & (iu0 <= G - support)
          & (iv0 >= 0) & (iv0 <= G - support))
    num_clipped = int((~ok).sum())
    iu0c = np.clip(iu0, 0, G - support)
    iv0c = np.clip(iv0, 0, G - support)

    k = np.arange(support)
    uk = _es_np(plan.beta,
                ((u0[..., None] + k) - pos_u[..., None]) / hs) \
        .reshape(-1, support).astype(np.float32)
    vk = _es_np(plan.beta,
                ((v0[..., None] + k) - pos_v[..., None]) / hs) \
        .reshape(-1, support).astype(np.float32)
    if plan.do_wstacking:
        k0 = np.clip(np.ceil(pos_w - hs).astype(np.int64), 0,
                     K - sw).ravel()
        kw = _es_np(plan.beta,
                    ((k0.reshape(R, C)[..., None] + np.arange(sw))
                     - pos_w[..., None]) / hs) \
            .reshape(-1, sw).astype(np.float32)
    else:
        k0 = np.zeros(R * C, np.int64)
        kw = np.ones((R * C, 1), np.float32)

    gu_blocks = -(-G // 8)
    gv_blocks = -(-G // 128)
    rows_pad = 8 * gu_blocks + 8
    lanes_pad = 128 * gv_blocks + 128
    gu = iu0c >> 3
    hv = iv0c >> 7
    u_off = (iu0c & 7).astype(np.int32)
    iv0_local = (iv0c & 127).astype(np.int32)

    slab_sz = gu_blocks * gv_blocks
    bucket = (k0 * slab_sz + gu * gv_blocks + hv)
    num_buckets = num_slabs * slab_sz

    counts = np.bincount(bucket, minlength=num_buckets)
    padded = -(-counts // block_v) * block_v
    pad_off = np.zeros(num_buckets + 1, np.int64)
    np.cumsum(padded, out=pad_off[1:])
    total = int(pad_off[-1])
    num_blocks = total // block_v

    order = np.argsort(bucket, kind="stable")
    sstart = np.zeros(num_buckets, np.int64)
    np.cumsum(counts[:-1], out=sstart[1:])
    rank = np.arange(R * C) - sstart[bucket[order]]
    dest = pad_off[bucket[order]] + rank

    sort_index = np.zeros(total, np.int64)
    valid = np.zeros(total, bool)
    sort_index[dest] = order
    valid[dest] = True
    valid[dest[~ok[order]]] = False          # clipped vis dropped

    def scatter(x):
        out = np.zeros((total,) + x.shape[1:], x.dtype)
        out[dest] = x[order]
        return out

    from ..parallel.bucketed import inverse_index_of

    arrays = dict(
        sort_index=sort_index, valid=valid,
        inv_index=inverse_index_of(sort_index, valid, R * C),
        u_off=scatter(u_off), iv0_local=scatter(iv0_local),
        uk=scatter(uk), vk=scatter(vk),
        kw=np.where(valid[:, None], scatter(kw), 0.0).astype(np.float32),
        flip=scatter(flip.repeat(C).astype(np.float32)),
    )

    nonzero = np.nonzero(padded)[0]
    block_bucket_g = np.repeat(nonzero, padded[nonzero] // block_v)
    # Slab-local bucket ids for the per-slab grid calls.
    arrays["block_bucket"] = (block_bucket_g % slab_sz).astype(np.int32)
    # Per-block (w-slab, u-octet, v-128-block) coordinates of the degrid
    # kernel's windows.
    arrays["k_idx"] = (block_bucket_g // slab_sz).astype(np.int32)
    arrays["g_idx"] = ((block_bucket_g % slab_sz)
                       // gv_blocks).astype(np.int32)
    arrays["hv_idx"] = (block_bucket_g % gv_blocks).astype(np.int32)
    visited = np.zeros((num_slabs, slab_sz), bool)
    visited[np.nonzero(counts)[0] // slab_sz,
            np.nonzero(counts)[0] % slab_sz] = True
    arrays["visited"] = visited

    slab_of_block = block_bucket_g // slab_sz
    slab_blocks = []
    for s in range(num_slabs):
        sel = np.nonzero(slab_of_block == s)[0]
        if sel.size:
            slab_blocks.append((int(sel[0]), int(sel[-1] + 1)))
        else:
            slab_blocks.append((0, 0))

    ep = EsPackedPlan(
        total=total, num_blocks=num_blocks, block_v=block_v,
        num_w_grids=K, w_support=sw, num_slabs=num_slabs,
        gu=gu_blocks, gv=gv_blocks, rows_pad=rows_pad,
        lanes_pad=lanes_pad, slab_blocks=slab_blocks,
        num_clipped=num_clipped, arrays=arrays)
    return attach(plan, ep)


def _build_screens(plan, sign: float) -> torch.Tensor:
    """[K, size, size] complex64 stack of exp(sign 2 pi i w (n-1)) / n,
    static per plan (rebuilt per call it would cost ~2M transcendentals
    per w-plane)."""
    return torch.stack([
        plan._image_screens(iw * plan.inv_w_scale + plan.min_plane_w,
                            sign).to(torch.complex64)
        for iw in range(plan.num_total_w_grids)])


def attach(plan, ep: EsPackedPlan) -> EsPackedPlan:
    """Upload the plan's stream, taps and per-block coordinates to
    ``plan.device`` and build the screens and the correction there, once
    per plan."""
    a = ep.arrays
    dev = plan.device

    def put(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(dev)

    ep.dev = dict(
        sort_index=put(a["sort_index"], torch.int64),
        valid=put(a["valid"]),
        flip=put(a["flip"]),
        kw_t=put(a["kw"].T),
        u_off=put(a["u_off"], torch.int32),
        iv0=put(a["iv0_local"], torch.int32),
        uk=put(a["uk"]), vk=put(a["vk"]),
        block_bucket=put(a["block_bucket"]),
        inv_index=put(a["inv_index"], torch.int64),
        k_idx=put(a["k_idx"]), g_idx=put(a["g_idx"]),
        hv_idx=put(a["hv_idx"]),
        visited=put(a["visited"]),
        screens_grid=_build_screens(plan, -1.0),
        screens_degrid=_build_screens(plan, 1.0),
        correction=plan._correction(torch.float32))
    return ep


# ---------------------------------------------------------------------------
# Window fold on the (u-octet, v-128-block) bucket grid
# ---------------------------------------------------------------------------


def _fold_slab(wins, visited_s, gu, gv, sw, rows_pad, lanes_pad):
    """[2*sw, gu*gv, 16, 256] windows -> [2, sw, rows_pad, lanes_pad]."""
    w = torch.where(visited_s[None, :, None, None], wins, 0.0)
    w = w.reshape(2, sw, gu, gv, WIN_ROWS, 2, 128)
    # u axis: rows >= 8 belong to octet gu + 1.
    out_u = w.new_zeros((2, sw, gu + 1, gv, 8, 2, 128))
    out_u[:, :, :gu] += w[:, :, :, :, :8]
    out_u[:, :, 1:] += w[:, :, :, :, 8:]
    # v axis: lane half >= 128 belongs to block hv + 1.
    out = w.new_zeros((2, sw, gu + 1, gv + 1, 8, 128))
    out[:, :, :, :gv] += out_u[..., 0, :]
    out[:, :, :, 1:] += out_u[..., 1, :]
    return out.permute(0, 1, 2, 4, 3, 5).reshape(2, sw, rows_pad, lanes_pad)


# ---------------------------------------------------------------------------
# Drivers (called from GridderUvwEsFft)
# ---------------------------------------------------------------------------


def grid_es_packed(plan, ep: EsPackedPlan, vis, weight,
                   dirty_image) -> torch.Tensor:
    """Packed twin of GridderUvwEsFft.grid_uvw_es_fft (complex64 ``vis``;
    every tensor on the plan's device)."""
    d = ep.dev
    G = plan.grid_size
    size = plan.image_size
    sw = ep.w_support
    lo = G // 2 - size // 2

    vis_s = (vis * weight.to(vis.dtype)).reshape(-1)[d["sort_index"]]
    vre = torch.where(d["valid"], vis_s.real, 0.0).to(torch.float32)
    vim = torch.where(d["valid"], vis_s.imag * d["flip"], 0.0) \
        .to(torch.float32)

    acc = torch.zeros((2, ep.num_w_grids, ep.rows_pad, ep.lanes_pad),
                      dtype=torch.float32, device=vis.device)
    bv = ep.block_v
    for s, (b0, b1) in enumerate(ep.slab_blocks):
        if b1 == b0:
            continue
        sl = slice(b0 * bv, b1 * bv)
        wins = grid_packed(
            d["block_bucket"][b0:b1], d["u_off"][sl], d["iv0"][sl],
            d["uk"][sl], d["vk"][sl],
            (d["kw_t"][:, sl].contiguous(), vre[sl], vim[sl]),
            ep.gu * ep.gv, _LANES, sw, block_v=bv)
        acc[:, s:s + sw] += _fold_slab(wins, d["visited"][s], ep.gu, ep.gv,
                                       sw, ep.rows_pad, ep.lanes_pad)

    layers = ifft_shifted(torch.complex(acc[0, :, :G, :G], acc[1, :, :G, :G]))
    crops = layers[:, lo:lo + size, lo:lo + size]
    dirty = (crops * d["screens_grid"]).real.sum(dim=0) * d["correction"]
    return dirty_image + dirty.to(dirty_image.dtype)


def degrid_es_packed(plan, ep: EsPackedPlan, vis,
                     dirty_image) -> torch.Tensor:
    """Packed twin of GridderUvwEsFft.ifft_degrid_uvw_es_fft (complex64
    ``vis``; every tensor on the plan's device)."""
    d = ep.dev
    G = plan.grid_size
    size = plan.image_size
    lo = G // 2 - size // 2

    corrected = dirty_image.to(torch.float32) * d["correction"]
    # Per-plane screened layers -> forward FFT -> padded (u, v) layout.
    layer = torch.zeros((ep.num_w_grids, G, G), dtype=torch.complex64,
                        device=vis.device)
    layer[:, lo:lo + size, lo:lo + size] = \
        corrected[None] * d["screens_degrid"]
    grids = fft_shifted(layer)
    padded = torch.zeros((2, ep.num_w_grids, ep.rows_pad, ep.lanes_pad),
                         dtype=torch.float32, device=vis.device)
    padded[0, :, :G, :G] = grids.real
    padded[1, :, :G, :G] = grids.imag

    out = degrid_fused(padded, d["k_idx"], d["g_idx"], d["hv_idx"],
                       d["u_off"], d["iv0"], d["uk"], d["vk"], d["kw_t"],
                       ep.w_support, _LANES, block_v=ep.block_v)
    # Undo the w < 0 flip, unsort through the inverse permutation; dropped
    # entries read the appended zero slot.
    out = torch.where(d["flip"] < 0, out.conj(), out)
    flat = torch.cat([out, out.new_zeros(1)])[d["inv_index"]]
    return vis + flat.reshape(vis.shape).to(vis.dtype)
