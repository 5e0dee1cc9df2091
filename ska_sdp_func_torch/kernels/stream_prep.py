"""Per-chunk tap preparation of the streaming engine's non-packable branch.

Counterpart of two Pallas kernels of ska_sdp_func_tpu.kernels.packed_tap:
:func:`stream_prep_grid` replaces ``stream_prep_grid_pallas`` and
:func:`stream_prep_degrid` replaces ``stream_prep_degrid_pallas``. From the
placed plan fields of a chunk (``u_frac``, ``v_frac``, ``w_row`` [V]
int32) each evaluates the Chebyshev kernel taps by Clenshaw's recurrence
(:func:`..grid_data.kernels.eval_kernel_taps`):

- grid: ``uk``, ``vk`` [V, S] and the scale stack ``scales`` [2 Sw, V]
  f32, rows ``wk[j] * vre`` then ``wk[j] * vim``;
- degrid: ``uk``, ``vk`` and ``wk_t`` [Sw, V] ``= wk * valid_f``.

With ``fast`` (the streaming engine's bf16 mode) ``vk`` comes back as a
``torch.bfloat16`` [V, S] tensor: the same taps, each rounded once to
nearest even, as the Pallas kernels store their v-band in bf16
(packed_tap.py:521, :639); ``uk`` and the scales stay f32, as in JAX.

The Pallas kernels place the taps into dense bands (``ubase`` [16, V],
``vband`` [V, lanes] or ``vband_t`` [lanes, V], 1 KiB per slot at 256
lanes). The port keeps them compact: its window kernels read them as
they are, K8 (:func:`.band_tap.grid_packed`, ``csrc/window_scatter.cu``)
and K11 (:func:`.band_tap.degrid_fused`, ``csrc/window_gather.cu``), each
taking its bf16 mode from ``vk``'s dtype. (:func:`.packed_tap.build_bands`
turns ``(u_off, iv0, uk, vk)`` into the Pallas kernels' bands, for the
tests that hold the two packages' preparations against each other.)

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/stream_prep.cu``) or raises; on a CPU tensor it runs its plain
PyTorch version (``*_reference``). Each counts its launches in
``.launches``. Both round every operation on its own, in the same order,
so they evaluate identical taps, bit for bit.

The kernel is bound by its bytes (20 in and 96 out a slot at S 8, Sw 4)
and by instruction issue; it is laid out for full-sector stores. A thread
a (slot, tap) evaluates ``uk`` and ``vk``, so a warp stores 4 slots' taps
as one 128 B run; a thread a (slot, w tap) evaluates ``wk`` into shared
memory, and each scale row is written as one contiguous
run of a 256-slot tile. Its unrolled instance (:func:`instance`) holds
the coefficient columns in registers and unrolls the chains at the
streaming paths' fits (ncoef 12, S 8, Sw a power of two); the generic
instance takes the rest of the range (ncoef <= 16, S <= 8, Sw <= 8).
"""

import numpy as np
import torch

from ..grid_data.kernels import eval_kernel_taps
from ..utility.errors import SdpInvalidArgumentError, SdpMemLocationError, \
    SdpShapeError
from .packed_tap import _check

_MAX_SUPPORT = 8
_MAX_W_SUPPORT = 8
_MAX_COEFFS = 16


def _taps(u_frac, v_frac, w_row, uv_coeffs, w_coeffs, oversampling,
          w_oversampling, fast):
    vk = eval_kernel_taps(v_frac, uv_coeffs, oversampling)
    return (eval_kernel_taps(u_frac, uv_coeffs, oversampling),
            vk.to(torch.bfloat16) if fast else vk,
            eval_kernel_taps(w_row, w_coeffs, w_oversampling).T.contiguous())


def stream_prep_grid_reference(u_frac, v_frac, w_row, vre, vim, uv_coeffs,
                               w_coeffs, oversampling: int,
                               w_oversampling: int, fast: bool = False):
    """Plain PyTorch version of :func:`stream_prep_grid`."""
    uk, vk, wk_t = _taps(u_frac, v_frac, w_row, uv_coeffs, w_coeffs,
                         oversampling, w_oversampling, fast)
    return uk, vk, torch.cat([wk_t * vre[None, :], wk_t * vim[None, :]])


def stream_prep_degrid_reference(u_frac, v_frac, w_row, valid_f, uv_coeffs,
                                 w_coeffs, oversampling: int,
                                 w_oversampling: int, fast: bool = False):
    """Plain PyTorch version of :func:`stream_prep_degrid`."""
    uk, vk, wk_t = _taps(u_frac, v_frac, w_row, uv_coeffs, w_coeffs,
                         oversampling, w_oversampling, fast)
    return uk, vk, wk_t * valid_f[None, :]


# The fits (ncoef, S) the unrolled instance takes, with a w support that
# is a power of two; the kernel's sdp_torch_stream_prep_unrolled answers
# the same.
_UNROLLED = ((12, 8),)


def instance(grid: bool, fast: bool, ncoef: int, support: int,
             w_support: int) -> str:
    """The kernel template instance a launch on fits of ``ncoef`` rows,
    ``support`` uv taps and ``w_support`` w taps takes:
    ``stream_prep_kernel<GRID, BF16, 12, 8>`` (unrolled) or ``<GRID,
    BF16, 0, 0>`` (generic)."""
    pow2 = w_support & (w_support - 1) == 0
    fits = (ncoef, support) if (ncoef, support) in _UNROLLED and pow2 \
        else (0, 0)
    return (f"stream_prep_kernel<{str(grid).lower()}, {str(fast).lower()}, "
            f"{fits[0]}, {fits[1]}>")


def _check_prep(u_frac, v_frac, w_row, extra, uv_coeffs, w_coeffs):
    dev = u_frac.device
    if dev.type not in ("cpu", "cuda"):
        raise SdpMemLocationError(f"unsupported device {dev}")
    if u_frac.ndim != 1:
        raise SdpShapeError("u_frac must be [V]")
    total = u_frac.shape[0]
    _check(dev, [("u_frac", u_frac), ("v_frac", v_frac), ("w_row", w_row)],
           torch.int32, (total,))
    _check(dev, extra, torch.float32, (total,))
    for name, c, most in (("uv_coeffs", uv_coeffs, _MAX_SUPPORT),
                          ("w_coeffs", w_coeffs, _MAX_W_SUPPORT)):
        if c.ndim != 2 or not 1 <= c.shape[0] <= _MAX_COEFFS \
                or not 1 <= c.shape[1] <= most:
            raise SdpInvalidArgumentError(
                f"{name} must be [degree + 1 <= {_MAX_COEFFS}, taps <= "
                f"{most}]")
        _check(dev, [(name, c)], torch.float32)
    if uv_coeffs.shape[0] != w_coeffs.shape[0]:
        raise SdpInvalidArgumentError(
            "uv_coeffs and w_coeffs must have the same degree")
    return dev, total


def _launch(dev, total, fields, vis, valid, uv_coeffs, w_coeffs,
            oversampling, w_oversampling, wk_rows, fast):
    from . import _build

    lib = _build.load()
    support, w_support = uv_coeffs.shape[1], w_coeffs.shape[1]
    uk = torch.empty((total, support), dtype=torch.float32, device=dev)
    vk = torch.empty((total, support), device=dev,
                     dtype=torch.bfloat16 if fast else torch.float32)
    wk = torch.empty((wk_rows * w_support, total), dtype=torch.float32,
                     device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_stream_prep(
            *(f.data_ptr() for f in fields),
            *((v.data_ptr() for v in vis) if vis else (None, None)),
            None if valid is None else valid.data_ptr(),
            uv_coeffs.data_ptr(), w_coeffs.data_ptr(), uv_coeffs.shape[0],
            support, w_support, float(np.float32(2.0 / oversampling)),
            float(np.float32(2.0 / w_oversampling)), total, uk.data_ptr(),
            vk.data_ptr(), wk.data_ptr(), int(fast), stream)
    _build.check(lib, err, "stream_prep")
    return uk, vk, wk


def stream_prep_grid(u_frac, v_frac, w_row, vre, vim, uv_coeffs, w_coeffs,
                     oversampling: int, w_oversampling: int,
                     fast: bool = False):
    """Grid prep of a placed chunk: ``(uk [V, S], vk [V, S], scales
    [2 Sw, V])`` f32 (``vk`` bf16 with ``fast``) from the int32 fields
    ``u_frac``, ``v_frac``, ``w_row`` and the f32 visibilities ``vre``,
    ``vim`` [V] (zero on padding and invalid slots). ``uv_coeffs``
    [degree + 1, S] and ``w_coeffs`` [degree + 1, Sw] are the f32
    Chebyshev fits."""
    dev, total = _check_prep(u_frac, v_frac, w_row,
                             [("vre", vre), ("vim", vim)], uv_coeffs,
                             w_coeffs)
    if dev.type == "cpu":
        return stream_prep_grid_reference(u_frac, v_frac, w_row, vre, vim,
                                          uv_coeffs, w_coeffs, oversampling,
                                          w_oversampling, fast)
    out = _launch(dev, total, (u_frac, v_frac, w_row), (vre, vim), None,
                  uv_coeffs, w_coeffs, oversampling, w_oversampling, 2, fast)
    stream_prep_grid.launches += 1
    return out


stream_prep_grid.launches = 0


def stream_prep_degrid(u_frac, v_frac, w_row, valid_f, uv_coeffs, w_coeffs,
                       oversampling: int, w_oversampling: int,
                       fast: bool = False):
    """Degrid prep of a placed chunk: ``(uk [V, S], vk [V, S], wk_t
    [Sw, V])`` f32 (``vk`` bf16 with ``fast``), ``wk_t`` the w taps times
    ``valid_f`` [V] f32 (1 on valid slots, 0 elsewhere); arguments as
    :func:`stream_prep_grid`."""
    dev, total = _check_prep(u_frac, v_frac, w_row, [("valid_f", valid_f)],
                             uv_coeffs, w_coeffs)
    if dev.type == "cpu":
        return stream_prep_degrid_reference(u_frac, v_frac, w_row, valid_f,
                                            uv_coeffs, w_coeffs,
                                            oversampling, w_oversampling,
                                            fast)
    out = _launch(dev, total, (u_frac, v_frac, w_row), None, valid_f,
                  uv_coeffs, w_coeffs, oversampling, w_oversampling, 1, fast)
    stream_prep_degrid.launches += 1
    return out


stream_prep_degrid.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {"stream_prep_grid": stream_prep_grid.launches,
            "stream_prep_degrid": stream_prep_degrid.launches}


def reset_launch_counts() -> None:
    stream_prep_grid.launches = 0
    stream_prep_degrid.launches = 0
