"""Channel-range clamping: the visibility-selection primitive.

Counterpart of ska_sdp_func_tpu.grid_data.clamp_channels (reference:
`sdp_gridder_clamp_channels_inline`, sdp_gridder_clamp_channels.h:
116-172): restrict per-row channel ranges so the scaled u/v/w
coordinate falls inside ``[min_u, max_u)``, as one elementwise pass
over all rows, with the reference's interval arithmetic (overflow guard
``eta``, empty ranges normalised to (0, 0)).
"""

import torch

from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError, SdpShapeError

_INT_GUARD = 2147483645.0


def _as_tensor(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def _clamp_1d(u, freq0_hz, dfreq_hz, start_ch, end_ch, min_u, max_u):
    """Clamp (start_ch, end_ch) so ``min_u <= ch * du + u0 < max_u``.

    ``u``, ``start_ch`` and ``end_ch`` are tensors; ``min_u``/``max_u``
    are scalars or tensors broadcastable against ``u``. The arithmetic
    runs in ``u``'s precision (at least f32), as in the JAX version.
    """
    u = torch.as_tensor(u)
    dtype = torch.promote_types(u.dtype, torch.float32)
    u = u.to(dtype)
    start_ch = torch.as_tensor(start_ch, device=u.device)
    end_ch = torch.as_tensor(end_ch, device=u.device)
    u0 = freq0_hz * u / C_0
    du = dfreq_hz * u / C_0
    min_u = _as_tensor(min_u, dtype, u.device)
    max_u = _as_tensor(max_u, dtype, u.device)

    eta = torch.maximum((min_u - u0).abs(), (max_u - u0).abs()) / _INT_GUARD
    safe_du = torch.where(du.abs() > eta, du, torch.ones_like(du))
    lo = torch.ceil((min_u - u0) / safe_du)
    hi = torch.ceil((max_u - u0) / safe_du)

    # Clip in f64, where the int32 limits are exact, then convert.
    info = torch.iinfo(start_ch.dtype)
    lo_i = lo.double().clamp(info.min, info.max).to(start_ch.dtype)
    hi_i = hi.double().clamp(info.min, info.max).to(start_ch.dtype)

    pos = du > eta
    neg = du < -eta
    new_start = torch.where(
        pos, torch.maximum(start_ch, lo_i),
        torch.where(neg, torch.maximum(start_ch, hi_i), start_ch))
    new_end = torch.where(
        pos, torch.minimum(end_ch, hi_i),
        torch.where(neg, torch.minimum(end_ch, lo_i), end_ch))

    # du ~ 0: binary in/out decision on u0.
    outside = ~pos & ~neg & ((min_u > u0) | (max_u <= u0))
    zero = torch.zeros_like(new_start)
    new_start = torch.where(outside, zero, new_start)
    new_end = torch.where(outside, zero, new_end)

    empty = new_end <= new_start
    return torch.where(empty, zero, new_start), torch.where(empty, zero,
                                                            new_end)


def _check_uvws(uvws, fn: str) -> torch.Tensor:
    uvws = torch.as_tensor(uvws)
    if uvws.ndim != 2 or uvws.shape[-1] != 3:
        raise SdpShapeError(f"{fn}: uvws must be [n, 3]; got "
                            f"{tuple(uvws.shape)}")
    return uvws


def clamp_channels_single(uvws, dim: int, freq0_hz, dfreq_hz, start_chs,
                          end_chs, min_u, max_u):
    """Clamp channel ranges on one uvw dimension
    (`sdp_gridder_clamp_channels_single`,
    sdp_gridder_clamp_channels.h:42-56); returns new
    ``(start_chs, end_chs)``."""
    uvws = _check_uvws(uvws, "clamp_channels_single")
    if dim not in (0, 1, 2):
        raise SdpInvalidArgumentError(
            f"clamp_channels_single: dim must be 0, 1 or 2; got {dim}")
    return _clamp_1d(uvws[:, dim], freq0_hz, dfreq_hz, start_chs, end_chs,
                     min_u, max_u)


def clamp_channels_uv(uvws, freq0_hz, dfreq_hz, start_chs, end_chs,
                      min_u, max_u, min_v, max_v):
    """Clamp channel ranges to a (u, v) box
    (`sdp_gridder_clamp_channels_uv`, sdp_gridder_clamp_channels.h:
    79-94)."""
    uvws = _check_uvws(uvws, "clamp_channels_uv")
    start_chs, end_chs = _clamp_1d(uvws[:, 0], freq0_hz, dfreq_hz,
                                   start_chs, end_chs, min_u, max_u)
    return _clamp_1d(uvws[:, 1], freq0_hz, dfreq_hz, start_chs, end_chs,
                     min_v, max_v)


def clamp_channels_inline(u, freq0_hz, dfreq_hz, start_ch, end_ch,
                          min_u, max_u):
    """Broadcast variant (`sdp_gridder_clamp_channels_inline`)."""
    return _clamp_1d(u, freq0_hz, dfreq_hz, start_ch, end_ch, min_u, max_u)
