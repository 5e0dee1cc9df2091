"""Stage sweep of the streaming tap preparation (the K6/K7 A/B kernel).

Counterpart of the Pallas kernel of experiments/exp_prep.py
(``variant(mode)``, body ``kern``). :func:`prep_variant` evaluates, over
``cap`` slots, the tap preparation's three outputs from the plan fields
``u_off``, ``u_frac``, ``w_row``, ``iv0``, ``v_frac`` ([cap] int32) and
``vre``, ``vim`` ([cap] f32), with S = 8 uv taps and Sw = 4 w taps::

    ub [16, cap]:    ub[u_off[p] + s, p] = uk[p, s]     (zero elsewhere)
    vb [cap, 128]:   vb[p, iv0[p] + s]   = vk[p, s]     (zero elsewhere)
    sc [2 Sw, cap]:  rows wk[:, j] * vre, then wk[:, j] * vim

Taps at rows or columns outside the band are dropped, as the TPU kernel's
selects drop them. ``mode`` picks the stages (:data:`MODES`): ``full``;
``novband`` (ub and sc); ``vbonly`` (vb); ``vbnochb`` (vb with every tap
``float(v_frac)``, no Clenshaw); ``ubonly`` (ub). Every mode returns all
three outputs, zeros where it skips a stage, as the TPU kernel writes them.

The taps are :func:`..grid_data.kernels.eval_kernel_taps` (Clenshaw's
recurrence, each operation rounded on its own in K6's order), so the CUDA
kernel (``csrc/prep_variants.cu``) and the plain version agree bit for
bit. On a CUDA tensor :func:`prep_variant` launches the kernel or raises;
on a CPU tensor it runs :func:`prep_variant_reference`. It counts its
kernel launches in ``.launches``.
"""

import numpy as np
import torch

from ..grid_data.kernels import eval_kernel_taps
from ..utility.errors import SdpInvalidArgumentError, SdpMemLocationError, \
    SdpShapeError
from .packed_tap import WIN_ROWS, _check

MODES = ("full", "novband", "vbonly", "vbnochb", "ubonly")
SUPPORT = 8
W_SUPPORT = 4
LANES = 128
_MAX_COEFFS = 16


def stages(mode: str):
    """(ub, sc, vb) computed by ``mode``."""
    return (mode in ("full", "novband", "ubonly"),
            mode in ("full", "novband"),
            mode in ("full", "vbonly", "vbnochb"))


def _scatter(n_out: int, idx, taps, dim: int, shape):
    """Zeros of ``shape`` with ``taps`` at ``idx`` along ``dim``; an index
    outside ``[0, n_out)`` drops its tap (into a spill row, then cut)."""
    idx = idx.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < n_out), idx, n_out)
    wide = list(shape)
    wide[dim] += 1
    out = torch.zeros(wide, dtype=torch.float32, device=taps.device)
    out.scatter_(dim, idx, taps)
    return out.narrow(dim, 0, n_out).contiguous()


def prep_variant_reference(mode: str, u_off, u_frac, w_row, vre, vim, iv0,
                           v_frac, uv_coeffs, w_coeffs, oversampling: int,
                           w_oversampling: int):
    """Plain PyTorch version of :func:`prep_variant`."""
    cap = u_off.shape[0]
    dev = u_off.device
    do_ub, do_sc, do_vb = stages(mode)
    s = torch.arange(SUPPORT, device=dev)
    if do_ub:
        uk = eval_kernel_taps(u_frac, uv_coeffs, oversampling)
        ub = _scatter(WIN_ROWS, u_off[None, :] + s[:, None], uk.T, 0,
                      (WIN_ROWS, cap))
    else:
        ub = torch.zeros((WIN_ROWS, cap), dtype=torch.float32, device=dev)
    if do_sc:
        wk_t = eval_kernel_taps(w_row, w_coeffs, w_oversampling).T
        sc = torch.cat([wk_t * vre[None, :], wk_t * vim[None, :]])
    else:
        sc = torch.zeros((2 * W_SUPPORT, cap), dtype=torch.float32,
                         device=dev)
    if do_vb:
        if mode == "vbnochb":
            vk = v_frac.to(torch.float32)[:, None].expand(cap, SUPPORT)
        else:
            vk = eval_kernel_taps(v_frac, uv_coeffs, oversampling)
        vb = _scatter(LANES, iv0[:, None] + s[None, :], vk.contiguous(), 1,
                      (cap, LANES))
    else:
        vb = torch.zeros((cap, LANES), dtype=torch.float32, device=dev)
    return ub, vb, sc


def prep_variant(mode: str, u_off, u_frac, w_row, vre, vim, iv0, v_frac,
                 uv_coeffs, w_coeffs, oversampling: int,
                 w_oversampling: int):
    """``(ub [16, cap], vb [cap, 128], sc [8, cap])`` f32 of ``mode``;
    ``uv_coeffs`` [degree + 1, 8] and ``w_coeffs`` [degree + 1, 4] are the
    f32 Chebyshev fits of the uv and w kernels."""
    if mode not in MODES:
        raise SdpInvalidArgumentError(f"unknown mode {mode!r}")
    dev = u_off.device
    if u_off.ndim != 1:
        raise SdpShapeError("u_off must be [cap]")
    cap = u_off.shape[0]
    _check(dev, [("u_off", u_off), ("u_frac", u_frac), ("w_row", w_row),
                 ("iv0", iv0), ("v_frac", v_frac)], torch.int32, (cap,))
    _check(dev, [("vre", vre), ("vim", vim)], torch.float32, (cap,))
    for name, c, taps in (("uv_coeffs", uv_coeffs, SUPPORT),
                          ("w_coeffs", w_coeffs, W_SUPPORT)):
        if c.ndim != 2 or c.shape[1] != taps \
                or not 1 <= c.shape[0] <= _MAX_COEFFS:
            raise SdpInvalidArgumentError(
                f"{name} must be [degree + 1 <= {_MAX_COEFFS}, {taps}]")
        _check(dev, [(name, c)], torch.float32)
    if uv_coeffs.shape[0] != w_coeffs.shape[0]:
        raise SdpInvalidArgumentError(
            "uv_coeffs and w_coeffs must have the same degree")
    if dev.type == "cpu":
        return prep_variant_reference(mode, u_off, u_frac, w_row, vre, vim,
                                      iv0, v_frac, uv_coeffs, w_coeffs,
                                      oversampling, w_oversampling)
    if dev.type != "cuda":
        raise SdpMemLocationError(f"unsupported device {dev}")
    from . import _build

    lib = _build.load()
    ub = torch.empty((WIN_ROWS, cap), dtype=torch.float32, device=dev)
    vb = torch.empty((cap, LANES), dtype=torch.float32, device=dev)
    sc = torch.empty((2 * W_SUPPORT, cap), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.sdp_torch_prep_variant(
            MODES.index(mode), u_off.data_ptr(), u_frac.data_ptr(),
            w_row.data_ptr(), vre.data_ptr(), vim.data_ptr(), iv0.data_ptr(),
            v_frac.data_ptr(), uv_coeffs.data_ptr(), w_coeffs.data_ptr(),
            uv_coeffs.shape[0], float(np.float32(2.0 / oversampling)),
            float(np.float32(2.0 / w_oversampling)), cap, ub.data_ptr(),
            vb.data_ptr(), sc.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "prep_variant")
    prep_variant.launches += 1
    return ub, vb, sc


prep_variant.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset."""
    return {"prep_variant": prep_variant.launches}


def reset_launch_counts() -> None:
    prep_variant.launches = 0
