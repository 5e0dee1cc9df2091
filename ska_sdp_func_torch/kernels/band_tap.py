"""Bucket-window band gridding and plane-stack degridding.

Counterpart of two Pallas kernels of ska_sdp_func_tpu.kernels.packed_tap
that the ES-FFT gridder runs (:mod:`..grid_data.es_fft_packed`):

- :func:`grid_packed` replaces ``grid_packed_pallas``: bucket-sorted
  slots -> per-bucket windows ``[2 * Sw, num_buckets, 16, lanes]``;
- :func:`degrid_fused` replaces ``degrid_fused_pallas``: a padded plane
  stack ``[2, P, rows_pad, lanes_pad]`` -> sorted visibilities.

On a CUDA tensor each launches its hand-written kernel
(``csrc/band_tap.cu``, built by :mod:`._build`) or raises; on a CPU tensor
it runs its plain PyTorch version (``*_reference``). Each counts its
kernel launches in ``.launches``. Both run in full f32 (the Pallas
kernels' "highest").

Taps come in the compact per-slot form, 72 B per slot: ``u_off`` [V]
int32 (the u row of tap 0 inside the 16-row window), ``iv0`` [V] int32
(the lane of tap 0 inside the ``lanes``-wide window) and ``uk``/``vk``
[V, S] f32. The Pallas kernels stream the dense bands built from them
(``ubase`` [16, V] and ``vband`` [V, lanes], 1 KiB per slot at 256 lanes);
the plain versions build those bands with :func:`.packed_tap.build_bands`
and compute the Pallas kernels' dense products. Slot ``p``'s taps in
window row ``(h * Sw + j) * 16 + u_off + su``, lane ``iv0 + sv``:

    grid:   win[h, j, u_off + su, iv0 + sv] += (uk[su] * s_hj) * vk[sv]
    degrid: v_h = sum_{j, su} (uk[su] * wk[j])
                  * sum_sv plane[h, p_idx + j, 8 g + u_off + su,
                                 128 hv + iv0 + sv] * vk[sv]

with ``s_hj`` the scale stack row ``h * Sw + j``: given as ``[2 Sw, V]``,
or split as ``wk_t[j] * vre`` (h = 0) / ``wk_t[j] * vim`` (h = 1).
Lanes ``>= lanes`` are dropped, as the Pallas band build drops them.
"""

import torch

from .packed_tap import WIN_ROWS, _check, _full_f32_matmul, build_bands
from ..utility.errors import (
    SdpInvalidArgumentError,
    SdpMemLocationError,
    SdpShapeError,
)

_MAX_SUPPORT = 8
_MAX_W_SUPPORT = 8
# Plan blocks per chunk of the plain versions: bounds their dense band
# and window temporaries (~0.3 GB at 256 lanes) on the card.
_REF_BLOCKS = 512


def _check_taps(u_off, iv0, uk, vk, block_v, w_support):
    dev = uk.device
    if uk.ndim != 2 or not 1 <= uk.shape[1] <= _MAX_SUPPORT:
        raise SdpShapeError(f"uk must be [V, S] with S <= {_MAX_SUPPORT}")
    total, support = uk.shape
    if block_v <= 0 or total % block_v:
        raise SdpInvalidArgumentError(
            f"stream length {total} is not a multiple of block_v={block_v}")
    if not 1 <= w_support <= _MAX_W_SUPPORT:
        raise SdpInvalidArgumentError(
            f"w_support must be in [1, {_MAX_W_SUPPORT}]")
    _check(dev, [("u_off", u_off), ("iv0", iv0)], torch.int32, (total,))
    _check(dev, [("uk", uk), ("vk", vk)], torch.float32, (total, support))
    if dev.type not in ("cpu", "cuda"):
        raise SdpMemLocationError(f"unsupported device {dev}")
    return dev, total, support, total // block_v


def _scale_rows(scales, sl):
    """[2 Sw, n] scale stack of the slots ``sl`` (either form)."""
    if isinstance(scales, (tuple, list)):
        wk_t, vre, vim = scales
        wk = wk_t[:, sl]
        return torch.cat([wk * vre[sl][None, :], wk * vim[sl][None, :]])
    return scales[:, sl]


def grid_packed_reference(bucket_ids, u_off, iv0, uk, vk, scales,
                          num_buckets: int, lanes: int, w_support: int,
                          block_v: int = 128) -> torch.Tensor:
    """Plain PyTorch version of :func:`grid_packed`: the bands of each
    chunk of blocks, the Pallas kernel's ``[2 Sw 16, B] @ [B, lanes]``
    product per block, ``index_add_`` into the bucket windows."""
    num_p = 2 * w_support
    total = uk.shape[0]
    nb = total // block_v
    out = torch.zeros((num_p, num_buckets, WIN_ROWS, lanes),
                      dtype=torch.float32, device=uk.device)
    ids = bucket_ids.to(torch.int64)
    for b0 in range(0, nb, _REF_BLOCKS):
        b1 = min(nb, b0 + _REF_BLOCKS)
        n = b1 - b0
        sl = slice(b0 * block_v, b1 * block_v)
        ubase, vband, _ = build_bands(u_off[sl], iv0[sl], uk[sl], vk[sl],
                                      lanes)
        u_all = ubase[None] * _scale_rows(scales, sl)[:, None, :]
        u_all = u_all.reshape(num_p * WIN_ROWS, n, block_v).permute(1, 0, 2)
        with _full_f32_matmul():
            contrib = torch.bmm(u_all, vband.reshape(n, block_v, lanes))
        out.index_add_(1, ids[b0:b1], contrib.reshape(
            n, num_p, WIN_ROWS, lanes).permute(1, 0, 2, 3))
    return out


def grid_packed(bucket_ids, u_off, iv0, uk, vk, scales, num_buckets: int,
                lanes: int, w_support: int,
                block_v: int = 128) -> torch.Tensor:
    """Band gridding of a bucket-sorted stream into bucket windows.

    ``bucket_ids`` [NB] int32: block ``b`` (``block_v`` slots) belongs to
    bucket ``bucket_ids[b]``. ``scales``: the ``[2 Sw, V]`` f32 stack or
    the split form ``(wk_t [Sw, V], vre [V], vim [V])`` f32 (zero on
    padding and invalid slots). Returns the zero-based windows f32
    ``[2 Sw, num_buckets, 16, lanes]``; buckets no block visits stay zero.
    """
    dev, total, support, nb = _check_taps(u_off, iv0, uk, vk, block_v,
                                          w_support)
    num_p = 2 * w_support
    _check(dev, [("bucket_ids", bucket_ids)], torch.int32, (nb,))
    split = isinstance(scales, (tuple, list))
    if split:
        wk_t, vre, vim = scales
        _check(dev, [("wk_t", wk_t)], torch.float32, (w_support, total))
        _check(dev, [("vre", vre), ("vim", vim)], torch.float32, (total,))
    else:
        _check(dev, [("scales", scales)], torch.float32, (num_p, total))
    if dev.type == "cpu":
        return grid_packed_reference(bucket_ids, u_off, iv0, uk, vk, scales,
                                     num_buckets, lanes, w_support, block_v)
    from . import _build

    lib = _build.load()
    out = torch.zeros((num_p, num_buckets, WIN_ROWS, lanes),
                      dtype=torch.float32, device=dev)
    ptrs = ((wk_t.data_ptr(), vre.data_ptr(), vim.data_ptr(), None) if split
            else (None, None, None, scales.data_ptr()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_band_grid(
            bucket_ids.data_ptr(), u_off.data_ptr(), iv0.data_ptr(),
            uk.data_ptr(), vk.data_ptr(), *ptrs, nb, block_v, support,
            w_support, lanes, num_buckets, out.data_ptr(), stream)
    _build.check(lib, err, "grid_packed")
    grid_packed.launches += 1
    return out


grid_packed.launches = 0


def _window_index(p_idx, g_idx, hv_idx, planes_shape, w_support,
                  lanes_win):
    """Flat ``planes`` index [n, 2 Sw 16, lanes_win] of each block's
    window (rows re-layers then im-layers, as the Pallas kernel's)."""
    _, num_planes, rows_pad, lanes_pad = planes_shape
    dev = p_idx.device
    h = torch.arange(2, device=dev).reshape(1, 2, 1, 1, 1)
    j = torch.arange(w_support, device=dev).reshape(1, 1, -1, 1, 1)
    r = torch.arange(WIN_ROWS, device=dev).reshape(1, 1, 1, -1, 1)
    c = torch.arange(lanes_win, device=dev).reshape(1, 1, 1, 1, -1)

    def col(x):
        return x.to(torch.int64).reshape(-1, 1, 1, 1, 1)

    rows = (h * num_planes + col(p_idx) + j) * rows_pad + 8 * col(g_idx) + r
    idx = rows * lanes_pad + 128 * col(hv_idx) + c
    return idx.reshape(p_idx.shape[0], -1, lanes_win)


def degrid_fused_reference(planes, p_idx, g_idx, hv_idx, u_off, iv0, uk, vk,
                           wk_t, w_support: int, lanes_win: int,
                           block_v: int = 128,
                           raw: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`degrid_fused`: gather each chunk's
    windows, the Pallas kernel's window x transposed-band product, scale
    by the u-tap x w-tap stack and sum each half's rows."""
    total = uk.shape[0]
    nb = total // block_v
    out = torch.zeros((8, total), dtype=torch.float32, device=uk.device)
    flat = planes.reshape(-1)
    half = w_support * WIN_ROWS
    for b0 in range(0, nb, _REF_BLOCKS):
        b1 = min(nb, b0 + _REF_BLOCKS)
        n = b1 - b0
        sl = slice(b0 * block_v, b1 * block_v)
        ubase, _, vband_t = build_bands(u_off[sl], iv0[sl], uk[sl], vk[sl],
                                        lanes_win)
        win = flat[_window_index(p_idx[b0:b1], g_idx[b0:b1], hv_idx[b0:b1],
                                 planes.shape, w_support, lanes_win)]
        with _full_f32_matmul():
            t_t = torch.bmm(win, vband_t.reshape(lanes_win, n, block_v)
                            .permute(1, 0, 2))               # [n, 2 half, B]
        uwh = (ubase[None] * wk_t[:, sl][:, None, :]).reshape(
            half, n, block_v).permute(1, 0, 2)               # [n, half, B]
        prod = torch.cat([uwh, uwh], dim=1) * t_t
        out[0, sl] = prod[:, :half].sum(dim=1).reshape(-1)
        out[1, sl] = prod[:, half:].sum(dim=1).reshape(-1)
    return out if raw else torch.complex(out[0], out[1])


def degrid_fused(planes, p_idx, g_idx, hv_idx, u_off, iv0, uk, vk, wk_t,
                 w_support: int, lanes_win: int, block_v: int = 128,
                 raw: bool = False) -> torch.Tensor:
    """Degridding from a padded plane stack.

    ``planes`` f32 [2, P, rows_pad, lanes_pad] (re/im planes;
    ``rows_pad % 8 == 0``, ``lanes_pad % 128 == 0``); ``p_idx``,
    ``g_idx``, ``hv_idx`` [NB] int32: each block's first plane, u octet
    and 128-lane v block; its window is rows ``[8 g, 8 g + 16)`` and lanes
    ``[128 hv, 128 hv + lanes_win)`` of planes ``p_idx + j``. ``wk_t``
    [Sw, V] f32 (zero on padding and invalid slots). Returns complex64
    [V] in sorted order, or with ``raw`` the f32 ``[8, V]`` pair (row 0
    re, row 1 im, the rest zero).
    """
    if planes.ndim != 4 or planes.shape[0] != 2:
        raise SdpShapeError("planes must be [2, P, rows_pad, lanes_pad]")
    _, num_planes, rows_pad, lanes_pad = planes.shape
    if rows_pad % 8 or lanes_pad % 128 or lanes_win % 128 \
            or lanes_win > lanes_pad:
        raise SdpShapeError(
            "planes need rows_pad % 8 == 0 and lanes_pad % 128 == 0, and "
            "lanes_win a multiple of 128 no wider than lanes_pad")
    dev, total, support, nb = _check_taps(u_off, iv0, uk, vk, block_v,
                                          w_support)
    _check(dev, [("planes", planes)], torch.float32)
    _check(dev, [("p_idx", p_idx), ("g_idx", g_idx), ("hv_idx", hv_idx)],
           torch.int32, (nb,))
    _check(dev, [("wk_t", wk_t)], torch.float32, (w_support, total))
    if dev.type == "cpu":
        out = degrid_fused_reference(planes, p_idx, g_idx, hv_idx, u_off,
                                     iv0, uk, vk, wk_t, w_support, lanes_win,
                                     block_v, raw=True)
    else:
        from . import _build

        lib = _build.load()
        out = torch.zeros((8, total), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.sdp_torch_band_degrid(
                planes.data_ptr(), p_idx.data_ptr(), g_idx.data_ptr(),
                hv_idx.data_ptr(), u_off.data_ptr(), iv0.data_ptr(),
                uk.data_ptr(), vk.data_ptr(), wk_t.data_ptr(), num_planes,
                rows_pad, lanes_pad, total, block_v, support, w_support,
                lanes_win, out.data_ptr(), stream)
        _build.check(lib, err, "degrid_fused")
        degrid_fused.launches += 1
    if raw:
        return out
    return torch.complex(out[0], out[1])


degrid_fused.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {"grid_packed": grid_packed.launches,
            "degrid_fused": degrid_fused.launches}


def reset_launch_counts() -> None:
    grid_packed.launches = 0
    degrid_fused.launches = 0
