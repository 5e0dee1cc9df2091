"""Bucket-window band gridding and plane-stack degridding.

Counterpart of four Pallas kernels of the JAX package, two of
ska_sdp_func_tpu.kernels.packed_tap that the ES-FFT gridder
(:mod:`..grid_data.es_fft_packed`) and the streaming engine's
non-packable branch run, and their twins of
ska_sdp_func_tpu.kernels.fused_tap that evaluate the taps from the two
plan words:

- :func:`grid_packed` replaces ``grid_packed_pallas`` (K8): bucket-sorted
  slots -> per-bucket windows ``[2 * Sw, num_buckets, 16, lanes]``;
- :func:`degrid_fused` replaces ``degrid_fused_pallas`` (K11): a padded
  plane stack ``[2, P, rows_pad, lanes_pad]`` -> sorted visibilities;
- :func:`grid_fused` replaces ``grid_fused_pallas`` (K18) and
  :func:`degrid_fused2` replaces ``degrid_fused2_pallas`` (K19): the same
  from the plan words ``pa``/``pb`` (:mod:`.fused_tap`), in the three
  precision modes "highest", "high" and "bf16".

On a CUDA tensor each launches its hand-written kernel over the blocks'
run table ``runs`` (work units of one bucket window; built by
:mod:`._build`) or raises: ``csrc/window_scatter.cu`` to grid (a unit's
window held in shared memory, each plane owned by one warp, added to the
bucket windows once by bulk reduce-adds), ``csrc/window_gather.cu`` to
degrid (the unit's window read into shared memory once). On a CPU tensor
it runs its plain PyTorch version (``*_reference``, which takes ``runs``
and does not need it). Each counts its kernel launches in
``.launches``. K8 and K11 run in full f32 (the Pallas
kernels' "highest"), or in their bf16 mode when ``vk`` is bf16 (the
streaming engine's fast mode, whose prep rounds the v taps once; JAX
switches on the band's dtype the same way, packed_tap.py:135, :374):
each product is then ``bf16(a) * vk`` with ``a`` the scaled u tap
(grid) or the window cell (degrid), summed in f32.

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
K18/K19 unpack ``iv0``, ``u_off``, ``w_row``, ``u_frac``, ``v_frac`` and
``valid`` from the words and evaluate ``uk``, ``vk`` and ``wk`` with
:func:`.fused_tap.cheb_taps` (each operation rounded on its own, so the
kernel and its plain version see identical taps); the grid's scale is
``wk[j] * v_h``, the degrid's w tap ``wk[j] * valid``. The products are
those of :mod:`.fused_tap`: f32, bf16 hi/lo halves, or bf16 factors.
"""

import torch

from .fused_tap import _MODES, _check_fused, _inv2, _slot_taps
from .packed_tap import (
    WIN_ROWS,
    _aligned,
    _check,
    _products,
    build_bands,
    check_runs,
    degrid_table,
    split_bf16,
)
from ..utility.errors import (
    SdpDataTypeError,
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
    """Checks of the compact taps; also returns the mode ``vk``'s dtype
    selects ("bf16" for a bf16 ``vk``, else "highest")."""
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
    _check(dev, [("uk", uk)], torch.float32, (total, support))
    if vk.dtype not in (torch.float32, torch.bfloat16):
        raise SdpDataTypeError(f"vk must be float32 or bfloat16, got "
                               f"{vk.dtype}")
    _check(dev, [("vk", vk)], vk.dtype, (total, support))
    if dev.type not in ("cpu", "cuda"):
        raise SdpMemLocationError(f"unsupported device {dev}")
    mode = "bf16" if vk.dtype == torch.bfloat16 else "highest"
    return dev, total, support, total // block_v, mode


def _band(vband, mode):
    """A dense band in the operand form of the mode (``_products``)."""
    if mode == "bf16":
        return vband.to(torch.bfloat16)
    if mode == "high":
        return split_bf16(vband)
    return vband


def _occupied(nonempty, block_v):
    """[V] bool: the slots of the blocks ``nonempty`` marks occupied."""
    return (nonempty != 0).repeat_interleave(block_v)


def _scale_rows(scales, sl):
    """[2 Sw, n] scale stack of the slots ``sl`` (either form)."""
    if isinstance(scales, (tuple, list)):
        wk_t, vre, vim = scales
        wk = wk_t[:, sl]
        return torch.cat([wk * vre[sl][None, :], wk * vim[sl][None, :]])
    return scales[:, sl]


def grid_packed_reference(bucket_ids, u_off, iv0, uk, vk, scales,
                          num_buckets: int, lanes: int, w_support: int,
                          block_v: int = 128, precision: str = None,
                          runs=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`grid_packed`: the bands of each
    chunk of blocks, the Pallas kernel's ``[2 Sw 16, B] @ [B, lanes]``
    product per block in the mode's arithmetic (``precision``, by default
    the one ``vk``'s dtype selects), ``index_add_`` into the bucket
    windows (per block: ``runs`` is taken and not needed)."""
    if precision is None:
        precision = "bf16" if vk.dtype == torch.bfloat16 else "highest"
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
        contrib = _products(u_all, _band(vband.reshape(n, block_v, lanes),
                                         precision), precision)
        out.index_add_(1, ids[b0:b1], contrib.reshape(
            n, num_p, WIN_ROWS, lanes).permute(1, 0, 2, 3))
    return out


def grid_packed(bucket_ids, u_off, iv0, uk, vk, scales, num_buckets: int,
                lanes: int, w_support: int, block_v: int = 128,
                runs=None) -> torch.Tensor:
    """Band gridding of a bucket-sorted stream into bucket windows.

    ``bucket_ids`` [NB] int32: block ``b`` (``block_v`` slots) belongs to
    bucket ``bucket_ids[b]``. ``scales``: the ``[2 Sw, V]`` f32 stack or
    the split form ``(wk_t [Sw, V], vre [V], vim [V])`` f32 (zero on
    padding and invalid slots). A bf16 ``vk`` selects the bf16 mode.
    ``runs``: the blocks' run table (:func:`.packed_tap.degrid_runs` of
    ``(bucket_ids,)``, built here when not given; any run table whose rows
    hold every block once is right). Returns the zero-based windows f32
    ``[2 Sw, num_buckets, 16, lanes]``; buckets no block visits stay
    zero.
    """
    dev, total, support, nb, mode = _check_taps(u_off, iv0, uk, vk, block_v,
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
    runs = check_runs(runs, dev)
    if dev.type == "cpu":
        return grid_packed_reference(bucket_ids, u_off, iv0, uk, vk, scales,
                                     num_buckets, lanes, w_support, block_v)
    if lanes % 8:
        raise SdpInvalidArgumentError(
            f"the CUDA kernels need lanes % 8 == 0 (got {lanes})")
    from . import _build

    lib = _build.load()
    runs = degrid_table(runs, (bucket_ids,))
    out = torch.zeros((num_p, num_buckets, WIN_ROWS, lanes),
                      dtype=torch.float32, device=dev)
    ptrs = ((wk_t.data_ptr(), vre.data_ptr(), vim.data_ptr(), None) if split
            else (None, None, None, scales.data_ptr()))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_scatter_band(
            runs.data_ptr(), runs.shape[0], bucket_ids.data_ptr(),
            u_off.data_ptr(), iv0.data_ptr(), uk.data_ptr(), vk.data_ptr(),
            *ptrs, total, block_v, support, w_support, lanes, num_buckets,
            _MODES[mode], out.data_ptr(), stream)
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


def _plane_dims(planes, lanes_win):
    """(P, rows_pad, lanes_pad) of a plane stack the degrid kernels take."""
    if planes.ndim != 4 or planes.shape[0] != 2:
        raise SdpShapeError("planes must be [2, P, rows_pad, lanes_pad]")
    _, num_planes, rows_pad, lanes_pad = planes.shape
    if rows_pad % 8 or lanes_pad % 128 or lanes_win % 128 \
            or lanes_win > lanes_pad:
        raise SdpShapeError(
            "planes need rows_pad % 8 == 0 and lanes_pad % 128 == 0, and "
            "lanes_win a multiple of 128 no wider than lanes_pad")
    return num_planes, rows_pad, lanes_pad


def degrid_fused_reference(planes, p_idx, g_idx, hv_idx, u_off, iv0, uk, vk,
                           wk_t, w_support: int, lanes_win: int,
                           block_v: int = 128, raw: bool = False,
                           precision: str = None,
                           runs=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`degrid_fused`: gather each chunk's
    windows, the Pallas kernel's window x transposed-band product in the
    mode's arithmetic (``precision``, by default the one ``vk``'s dtype
    selects), scale by the u-tap x w-tap stack and sum each half's rows
    (per block: ``runs`` is taken and not needed)."""
    if precision is None:
        precision = "bf16" if vk.dtype == torch.bfloat16 else "highest"
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
        t_t = _products(win, _band(vband_t.reshape(lanes_win, n, block_v)
                                   .permute(1, 0, 2), precision),
                        precision)                           # [n, 2 half, B]
        uwh = (ubase[None] * wk_t[:, sl][:, None, :]).reshape(
            half, n, block_v).permute(1, 0, 2)               # [n, half, B]
        prod = torch.cat([uwh, uwh], dim=1) * t_t
        out[0, sl] = prod[:, :half].sum(dim=1).reshape(-1)
        out[1, sl] = prod[:, half:].sum(dim=1).reshape(-1)
    return out if raw else torch.complex(out[0], out[1])


def degrid_fused(planes, p_idx, g_idx, hv_idx, u_off, iv0, uk, vk, wk_t,
                 w_support: int, lanes_win: int, block_v: int = 128,
                 raw: bool = False, runs=None) -> torch.Tensor:
    """Degridding from a padded plane stack.

    ``planes`` f32 [2, P, rows_pad, lanes_pad] (re/im planes;
    ``rows_pad % 8 == 0``, ``lanes_pad % 128 == 0``); ``p_idx``,
    ``g_idx``, ``hv_idx`` [NB] int32: each block's first plane, u octet
    and 128-lane v block; its window is rows ``[8 g, 8 g + 16)`` and lanes
    ``[128 hv, 128 hv + lanes_win)`` of planes ``p_idx + j``. ``wk_t``
    [Sw, V] f32 (zero on padding and invalid slots). ``runs``: the
    blocks' run table (:func:`.packed_tap.degrid_runs` of ``(p_idx,
    g_idx, hv_idx)``, built here when not given; any block order is
    right). Returns complex64 [V] in sorted order, or with ``raw`` the f32
    ``[8, V]`` pair (row 0 re, row 1 im, the rest zero). A bf16 ``vk``
    selects the bf16 mode.
    """
    num_planes, rows_pad, lanes_pad = _plane_dims(planes, lanes_win)
    dev, total, support, nb, mode = _check_taps(u_off, iv0, uk, vk, block_v,
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
        runs = degrid_table(runs, (p_idx, g_idx, hv_idx))
        planes = _aligned(planes)
        out = torch.zeros((8, total), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.sdp_torch_band_degrid(
                planes.data_ptr(), runs.data_ptr(), runs.shape[0],
                p_idx.data_ptr(), g_idx.data_ptr(), hv_idx.data_ptr(),
                u_off.data_ptr(), iv0.data_ptr(), uk.data_ptr(),
                vk.data_ptr(), wk_t.data_ptr(), num_planes, rows_pad,
                lanes_pad, total, block_v, support, w_support, lanes_win,
                _MODES[mode], out.data_ptr(), stream)
        _build.check(lib, err, "degrid_fused")
        degrid_fused.launches += 1
    if raw:
        return out
    return torch.complex(out[0], out[1])


degrid_fused.launches = 0


def grid_fused_reference(bucket_ids, pa, pb, vre, vim, uv_coeffs, w_coeffs,
                         num_buckets: int, lanes: int, support: int,
                         w_support: int, oversampling: int,
                         w_oversampling: int, block_v: int = 1024,
                         precision: str = "highest", nonempty=None,
                         runs=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`grid_fused`: the words' taps
    (:func:`.fused_tap._slot_taps`) through K8's plain version in the
    mode's arithmetic; the visibilities of the blocks ``nonempty`` marks 0
    are left out (``runs`` taken and not needed)."""
    iv0, u_off, _, uk, vk, wk = _slot_taps(pa, pb, uv_coeffs, w_coeffs,
                                           oversampling, w_oversampling)
    if nonempty is not None:
        occ = _occupied(nonempty, block_v)
        vre, vim = torch.where(occ, vre, 0.0), torch.where(occ, vim, 0.0)
    return grid_packed_reference(bucket_ids, u_off, iv0, uk, vk,
                                 (wk.T.contiguous(), vre, vim), num_buckets,
                                 lanes, w_support, block_v, precision)


def grid_fused(bucket_ids, pa, pb, vre, vim, uv_coeffs, w_coeffs,
               num_buckets: int, lanes: int, support: int, w_support: int,
               oversampling: int, w_oversampling: int, block_v: int = 1024,
               precision: str = "highest", nonempty=None,
               runs=None) -> torch.Tensor:
    """Fused gridding of a bucket-sorted stream of plan words into bucket
    windows (JAX ``grid_fused_pallas``, whose ``sub_v`` and ``band_form``
    are TPU layout choices with the same function).

    ``bucket_ids`` [NB] int32 as :func:`grid_packed`; ``pa``/``pb`` [V]
    int32 plan words (:func:`.fused_tap.pack_plan_words`); ``vre``/``vim``
    [V] f32 (zero on padding and invalid slots); ``uv_coeffs`` [degree +
    1, S] and ``w_coeffs`` [degree + 1, Sw] f32 Chebyshev fits;
    ``precision`` "highest", "high" or "bf16"; ``nonempty`` optional [NB]
    int32, 0-marked blocks are skipped; ``runs`` as :func:`grid_packed`.
    Returns the zero-based windows f32 ``[2 Sw, num_buckets, 16,
    lanes]``; buckets no block visits stay zero (JAX leaves them
    unwritten).
    """
    dev, total, nb, ncoef = _check_fused(
        [("bucket_ids", bucket_ids)], pa, pb, uv_coeffs, w_coeffs, support,
        w_support, block_v, lanes, precision, nonempty)
    _check(dev, [("vre", vre), ("vim", vim)], torch.float32, (total,))
    runs = check_runs(runs, dev)
    if dev.type == "cpu":
        return grid_fused_reference(
            bucket_ids, pa, pb, vre, vim, uv_coeffs, w_coeffs, num_buckets,
            lanes, support, w_support, oversampling, w_oversampling,
            block_v, precision, nonempty)
    from . import _build

    lib = _build.load()
    runs = degrid_table(runs, (bucket_ids,))
    out = torch.zeros((2 * w_support, num_buckets, WIN_ROWS, lanes),
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_scatter_band_fused(
            runs.data_ptr(), runs.shape[0], bucket_ids.data_ptr(),
            None if nonempty is None else nonempty.data_ptr(),
            pa.data_ptr(), pb.data_ptr(), vre.data_ptr(), vim.data_ptr(),
            uv_coeffs.data_ptr(), w_coeffs.data_ptr(), ncoef,
            _inv2(oversampling), _inv2(w_oversampling), total, block_v,
            support, w_support, lanes, num_buckets, _MODES[precision],
            out.data_ptr(), stream)
    _build.check(lib, err, "grid_fused")
    grid_fused.launches += 1
    return out


grid_fused.launches = 0


def degrid_fused2_reference(planes, p_idx, g_idx, hv_idx, pa, pb, uv_coeffs,
                            w_coeffs, lanes: int, support: int,
                            w_support: int, oversampling: int,
                            w_oversampling: int, block_v: int = 1024,
                            precision: str = "highest", nonempty=None,
                            raw: bool = False, runs=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`degrid_fused2`: the words' taps
    (w taps times ``valid``) through K11's plain version in the mode's
    arithmetic; the blocks ``nonempty`` marks 0 predict zero (``runs``
    taken and not needed)."""
    iv0, u_off, valid, uk, vk, wk = _slot_taps(pa, pb, uv_coeffs, w_coeffs,
                                               oversampling, w_oversampling)
    wk_t = (wk * valid.to(torch.float32)[:, None]).T.contiguous()
    out = degrid_fused_reference(planes, p_idx, g_idx, hv_idx, u_off, iv0,
                                 uk, vk, wk_t, w_support, lanes, block_v,
                                 raw=True, precision=precision)
    if nonempty is not None:
        out = torch.where(_occupied(nonempty, block_v)[None, :], out, 0.0)
    return out if raw else torch.complex(out[0], out[1])


def degrid_fused2(planes, p_idx, g_idx, hv_idx, pa, pb, uv_coeffs,
                  w_coeffs, lanes: int, support: int, w_support: int,
                  oversampling: int, w_oversampling: int,
                  block_v: int = 1024, precision: str = "highest",
                  nonempty=None, raw: bool = False,
                  runs=None) -> torch.Tensor:
    """Fused degridding from a padded plane stack with the taps evaluated
    from the plan words (JAX ``degrid_fused2_pallas``, without its TPU
    ``sub_v``).

    ``planes``, ``p_idx``, ``g_idx``, ``hv_idx`` and ``runs`` as
    :func:`degrid_fused`, ``lanes`` the window lane width; ``pa``/``pb``
    [V] int32 plan words (the ``valid`` bit of ``pb`` zeroes padding
    slots); fits, ``precision`` and ``nonempty`` as :func:`grid_fused`
    (0-marked blocks predict zero). Returns complex64 [V] in sorted order,
    or with ``raw`` the f32 ``[8, V]`` pair (row 0 re, row 1 im, the rest
    zero).
    """
    num_planes, rows_pad, lanes_pad = _plane_dims(planes, lanes)
    dev, total, nb, ncoef = _check_fused(
        [("p_idx", p_idx), ("g_idx", g_idx), ("hv_idx", hv_idx)], pa, pb,
        uv_coeffs, w_coeffs, support, w_support, block_v, lanes, precision,
        nonempty)
    _check(dev, [("planes", planes)], torch.float32)
    if dev.type == "cpu":
        out = degrid_fused2_reference(
            planes, p_idx, g_idx, hv_idx, pa, pb, uv_coeffs, w_coeffs,
            lanes, support, w_support, oversampling, w_oversampling,
            block_v, precision, nonempty, raw=True)
    else:
        from . import _build

        lib = _build.load()
        runs = degrid_table(runs, (p_idx, g_idx, hv_idx))
        planes = _aligned(planes)
        out = torch.zeros((8, total), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.sdp_torch_band_degrid_fused(
                planes.data_ptr(), runs.data_ptr(), runs.shape[0],
                p_idx.data_ptr(), g_idx.data_ptr(), hv_idx.data_ptr(),
                None if nonempty is None else nonempty.data_ptr(),
                pa.data_ptr(), pb.data_ptr(), uv_coeffs.data_ptr(),
                w_coeffs.data_ptr(), ncoef, _inv2(oversampling),
                _inv2(w_oversampling), num_planes, rows_pad, lanes_pad,
                total, block_v, support, w_support, lanes,
                _MODES[precision], out.data_ptr(), stream)
        _build.check(lib, err, "degrid_fused2")
        degrid_fused2.launches += 1
    if raw:
        return out
    return torch.complex(out[0], out[1])


degrid_fused2.launches = 0

_WRAPPERS = (grid_packed, degrid_fused, grid_fused, degrid_fused2)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def reset_launch_counts() -> None:
    for f in _WRAPPERS:
        f.launches = 0
