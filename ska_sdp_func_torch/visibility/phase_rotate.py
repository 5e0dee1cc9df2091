"""Phase rotation of uvw coordinates and visibilities to a new phase centre.

Counterpart of ska_sdp_func_tpu.visibility.phase_rotate (reference
visibility/sdp_phase_rotate.{h,cpp,cu}):

- `sdp_phase_rotate_uvw` (sdp_phase_rotate.h:41-60): rotate uvw by
  -delta_ra about v, then +delta_dec about u (the matrix of
  sdp_phase_rotate.cpp:120-135, built on the host in f64);
- `sdp_phase_rotate_vis` (sdp_phase_rotate.h:62-84): multiply each
  visibility by ``exp(+2 pi i (u dl + v dm + w dn) f_c / c)``, (dl, dm,
  dn) the tangent-plane offset of the old centre from the new
  (sdp_phase_rotate.cpp:259-275).

Both run on ``device`` (None: the CUDA card) and move their inputs there.
"""

import math

import numpy as np
import torch

from ..utility.constants import C_0
from ..utility.data_model import check_uvw, check_vis
from ..utility.sky_coord import SkyCoord
from ..utility.tensors import divide, on_device


def _rotation_matrix(orig: SkyCoord, new: SkyCoord) -> np.ndarray:
    d_a = -(new.ra - orig.ra)
    d_d = new.dec - orig.dec
    sin_d_a, cos_d_a = np.sin(d_a), np.cos(d_a)
    sin_d_d, cos_d_d = np.sin(d_d), np.cos(d_d)
    return np.array([
        [cos_d_a, 0.0, sin_d_a],
        [sin_d_a * sin_d_d, cos_d_d, -cos_d_a * sin_d_d],
        [-sin_d_a * cos_d_d, sin_d_d, cos_d_a * cos_d_d],
    ])


def phase_rotate_uvw(phase_centre_orig: SkyCoord,
                     phase_centre_new: SkyCoord, uvw_in,
                     device=None) -> torch.Tensor:
    """Rotate ``[time, baseline, 3]`` uvw coordinates to a new centre."""
    (uvw_in,) = on_device(uvw_in, device=device)
    check_uvw(uvw_in)
    matrix = torch.as_tensor(
        _rotation_matrix(phase_centre_orig, phase_centre_new),
        dtype=uvw_in.dtype, device=uvw_in.device)
    return torch.einsum("ij,tbj->tbi", matrix, uvw_in)


def _delta_lmn(orig: SkyCoord, new: SkyCoord):
    d_a = -(new.ra - orig.ra)
    sin_d_a, cos_d_a = np.sin(d_a), np.cos(d_a)
    sin_dec0, cos_dec0 = np.sin(orig.dec), np.cos(orig.dec)
    sin_dec, cos_dec = np.sin(new.dec), np.cos(new.dec)
    l1 = cos_dec * -sin_d_a
    m1 = cos_dec0 * sin_dec - sin_dec0 * cos_dec * cos_d_a
    n1 = sin_dec0 * sin_dec + cos_dec0 * cos_dec * cos_d_a
    return float(-l1), float(-m1), float(1.0 - n1)


def phase_rotate_vis(phase_centre_orig: SkyCoord,
                     phase_centre_new: SkyCoord, channel_start_hz: float,
                     channel_step_hz: float, uvw, vis_in,
                     device=None) -> torch.Tensor:
    """Rotate visibilities ``[time, baseline, chan, pol]`` to a new centre.

    The uvw coordinates are those of the ORIGINAL phase centre (metres).
    """
    uvw, vis_in = on_device(uvw, vis_in, device=device)
    check_uvw(uvw)
    check_vis(vis_in)
    delta_l, delta_m, delta_n = _delta_lmn(
        phase_centre_orig, phase_centre_new)
    num_chan = vis_in.shape[2]
    inv_wave = divide(channel_start_hz + channel_step_hz * torch.arange(
        num_chan, dtype=uvw.dtype, device=uvw.device), C_0)
    dot = (uvw[..., 0] * delta_l + uvw[..., 1] * delta_m
           + uvw[..., 2] * delta_n)
    phase = 2.0 * math.pi * dot[:, :, None] * inv_wave[None, None, :]
    phasor = torch.complex(torch.cos(phase), torch.sin(phase))
    return vis_in * phasor[..., None].to(vis_in.dtype)
