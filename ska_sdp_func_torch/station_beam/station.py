"""Aperture-array station beam: beamforming DFT over elements.

Counterpart of ska_sdp_func_tpu.station_beam.station (reference
station_beam/sdp_station.{h,cpp,cu}):

    beam[p] = norm * sum_i w_i * exp(i k (x_i px + y_i py + z_i pz))
                  * element_response_i(p)

with optional per-element beam data indexed by element type
(`sdp_station_beam_aperture_array`, sdp_station.h:121-140). Scalar
(1-pol) or fully polarised (4-pol, the Jones 2x2 flattened) outputs.

The element sum is a product over the ``[points, elements]`` phasor
matrix, taken in chunks of points so a chunk's phasors and element
responses stay under ``_CHUNK_ENTRIES`` entries each (65,536 points x 256
elements would be 134 MB of complex64 at once). Runs on ``device`` (None: the CUDA card).
"""

from typing import Optional

import torch

from ..utility.data_model import is_complex
from ..utility.errors import SdpDataTypeError, SdpShapeError
from ..utility.tensors import on_device

# Phasor entries a chunk of points: 2^22 complex64 entries is 32 MB.
_CHUNK_ENTRIES = 1 << 22


def aperture_array(wavenumber: float, element_weights, element_x,
                   element_y, element_z, point_x, point_y, point_z=None,
                   element_beam_index=None, element_beam=None,
                   normalise: bool = True, eval_x: bool = True,
                   eval_y: bool = True, num_pols: int = 1,
                   device=None) -> torch.Tensor:
    """Evaluate a station beam by direct Fourier transform over elements.

    :param wavenumber: 2 pi / lambda.
    :param element_weights: ``complex[num_elements]`` beamforming weights.
    :param element_x/y/z: ``float[num_elements]`` coordinates (metres).
    :param point_x/y/z: ``float[num_points]`` direction cosines
        (z may be None, treated as 0, as in the reference).
    :param element_beam_index: optional ``int[num_elements]`` row index
        into ``element_beam`` (defaults to the element index).
    :param element_beam: optional ``complex[num_beams, num_points]``
        (scalar) or ``complex[num_beams, num_points, 4]`` (polarised)
        element responses.
    :param normalise: divide by the number of elements.
    :returns: ``complex[num_points]`` (scalar) or
        ``complex[num_points, 4]`` when polarised.
    """
    if not is_complex(element_weights.dtype):
        raise SdpDataTypeError("element_weights must be complex")
    if element_beam is not None and not is_complex(element_beam.dtype):
        raise SdpDataTypeError("element_beam must be complex")
    (weights, ex, ey, ez, px, py, pz, index, beam) = on_device(
        element_weights, element_x, element_y, element_z, point_x,
        point_y, point_z, element_beam_index, element_beam, device=device)
    num_elements = ex.shape[0]
    num_points = px.shape[0]
    k = torch.tensor(wavenumber, dtype=ex.dtype, device=ex.device)
    norm = (1.0 / num_elements) if normalise else 1.0
    if beam is not None:
        if beam.ndim not in (2, 3) or (beam.ndim == 3
                                       and beam.shape[-1] != 4):
            raise SdpShapeError(
                "element_beam must be [beams, points] or "
                "[beams, points, 4]")
        index = torch.arange(num_elements, device=ex.device) \
            if index is None else index.to(torch.int64)
    chunk = max(1, _CHUNK_ENTRIES // max(num_elements, 1))
    parts = []
    for p0 in range(0, num_points, chunk):
        sl = slice(p0, p0 + chunk)
        # phase[p, i] = k * (px_p x_i + py_p y_i + pz_p z_i)
        phase = k * (px[sl, None] * ex[None, :] + py[sl, None] * ey[None, :])
        if pz is not None:
            phase = phase + k * pz[sl, None] * ez[None, :]
        phasor = torch.complex(torch.cos(phase), torch.sin(phase))
        weighted = phasor.to(weights.dtype) * weights[None, :]   # [P, I]
        if beam is None:
            parts.append(weighted.sum(dim=1))
            continue
        responses = beam[:, sl][index]                    # [I, P(, 4)]
        parts.append(torch.einsum("pi,ip->p" if beam.ndim == 2
                                  else "pi,ipk->pk", weighted, responses))
    out = torch.cat(parts) * norm
    if beam is None and num_pols == 4:
        out = out[:, None].expand(num_points, 4)
    if out.ndim == 1:
        return out
    mask = torch.tensor([eval_x, eval_x, eval_y, eval_y], device=out.device)
    return torch.where(mask[None, :], out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))
