"""Point-source direct-Fourier-transform visibility prediction.

Counterpart of ska_sdp_func_tpu.visibility.dft (reference
visibility/sdp_dft.{h,cpp,cu}):

- v00 (`sdp_dft_point_v00`, sdp_dft.h:53-72): uvw already in wavelengths,
  per channel: ``uvw_lambda[time, baseline, chan, 3]``;
- v01 (`sdp_dft_point_v01`, sdp_dft.h:74-97): uvw in metres
  ``[time, baseline, 3]`` plus a channel frequency ramp.

Both: ``vis[t,b,c,p] = sum_comp flux[comp,c,p] *
exp(-2 pi i (l u + m v + n w))``, a product of the phasors with the
fluxes over the components, per channel. They run on ``device`` (None:
the CUDA card) and move their inputs there.
"""

import math

import torch

from ..utility.constants import C_0
from ..utility.data_model import check_uvw
from ..utility.errors import SdpShapeError
from ..utility.tensors import divide, on_device


def _dft_from_phase(phase: torch.Tensor,
                    fluxes: torch.Tensor) -> torch.Tensor:
    """phase [T, B, C, S] -> vis [T, B, C, P] = phasor @ flux per
    channel."""
    phasor = torch.complex(torch.cos(phase), torch.sin(phase))
    return torch.einsum("tbcs,scp->tbcp", phasor.to(fluxes.dtype), fluxes)


def _check_fluxes(source_fluxes) -> None:
    if source_fluxes.ndim != 3:
        raise SdpShapeError("fluxes must be [component, channel, pol]")


def dft_point_v00(source_directions, source_fluxes, uvw_lambda,
                  device=None) -> torch.Tensor:
    """DFT prediction with uvw in wavelengths per channel.

    :param source_directions: ``[num_components, 3]`` (l, m, n-1) cosines.
    :param source_fluxes: ``complex[num_components, num_channels, num_pols]``.
    :param uvw_lambda: ``[num_times, num_baselines, num_channels, 3]``.
    :returns: ``complex[num_times, num_baselines, num_channels, num_pols]``.
    """
    source_directions, source_fluxes, uvw_lambda = on_device(
        source_directions, source_fluxes, uvw_lambda, device=device)
    if uvw_lambda.ndim != 4 or uvw_lambda.shape[-1] != 3:
        raise SdpShapeError("uvw_lambda must be [time, baseline, chan, 3]")
    _check_fluxes(source_fluxes)
    if source_fluxes.shape[2] not in (1, 4):
        raise SdpShapeError("num_pols must be 1 or 4")
    dtype = torch.promote_types(uvw_lambda.dtype, source_directions.dtype)
    phase = -2.0 * math.pi * torch.einsum(
        "tbck,sk->tbcs", uvw_lambda.to(dtype), source_directions.to(dtype))
    return _dft_from_phase(phase, source_fluxes)


def dft_point_v01(source_directions, source_fluxes, uvw_metres,
                  channel_start_hz: float, channel_step_hz: float,
                  num_channels: int = None, device=None) -> torch.Tensor:
    """DFT prediction with uvw in metres and a channel frequency ramp.

    :param source_directions: ``[num_components, 3]`` (l, m, n-1) cosines.
    :param source_fluxes: ``complex[num_components, num_channels, num_pols]``.
    :param uvw_metres: ``[num_times, num_baselines, 3]``.
    :returns: ``complex[num_times, num_baselines, num_channels, num_pols]``.
    """
    source_directions, source_fluxes, uvw_metres = on_device(
        source_directions, source_fluxes, uvw_metres, device=device)
    check_uvw(uvw_metres)
    _check_fluxes(source_fluxes)
    num_chan = source_fluxes.shape[1] if num_channels is None \
        else int(num_channels)
    fdtype = uvw_metres.dtype
    inv_wave = divide(channel_start_hz + channel_step_hz * torch.arange(
        num_chan, dtype=fdtype, device=uvw_metres.device), C_0)
    dtype = torch.promote_types(fdtype, source_directions.dtype)
    dot = torch.einsum("tbk,sk->tbs", uvw_metres.to(dtype),
                       source_directions.to(dtype))
    phase = -2.0 * math.pi * dot[:, :, None, :] \
        * inv_wave[None, None, :, None]
    return _dft_from_phase(phase, source_fluxes)
