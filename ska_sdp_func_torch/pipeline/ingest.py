"""Visibility ingest: RFI flagging and imaging weights.

Counterpart of ska_sdp_func_tpu.pipeline.ingest (BASELINE.md config #4:
RFI flagging and the station-beam DFT in the visibility ingest path):
the FluctuFlagger over the canonical [time, baseline, chan, pol] stream,
the imaging weights of flagged samples zeroed, optionally divided by the
station-beam power in the target direction, and the flat
[rows, chan] visibilities and weights the solver takes. Everything runs
on ``device`` (None: the CUDA card); the inputs move there.
"""

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import ROW_AXIS, mesh_axis, mesh_device
from ..station_beam.station import aperture_array
from ..utility.tensors import on_device
from ..visibility.flagger import flagger_dynamic_threshold


def ingest_flag_and_weight(vis4d, weights4d, alpha: float = 0.5,
                           threshold_magnitudes: float = 3.5,
                           threshold_variations: float = 3.5,
                           threshold_broadband: float = 3.5,
                           sampling_step: int = 1, window: int = 0,
                           window_median_history: int = 10,
                           device=None) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """Flag RFI and zero the affected weights.

    vis4d / weights4d: canonical [time, baseline, chan, pol]. Returns
    (flags4d int32, weights4d with the flagged samples zeroed, the
    flagged fraction as a 0-d f32 tensor).
    """
    vis4d, weights4d = on_device(vis4d, weights4d, device=device)
    flags = flagger_dynamic_threshold(
        vis4d, alpha=alpha, threshold_magnitudes=threshold_magnitudes,
        threshold_variations=threshold_variations,
        threshold_broadband=threshold_broadband,
        sampling_step=sampling_step, window=window,
        window_median_history=window_median_history,
        device=vis4d.device)
    clean_w = torch.where(flags == 0, weights4d,
                          torch.zeros((), dtype=weights4d.dtype,
                                      device=weights4d.device))
    return flags, clean_w, flags.to(torch.float32).mean()


def ingest_to_solver(vis4d, weights4d, beam_gain=None, device=None,
                     **flagger_kwargs) -> Tuple[torch.Tensor, torch.Tensor,
                                                float]:
    """Full ingest: flag -> weight -> (optional beam normalisation) ->
    flatten to the solver's [rows, chan] layout (pol 0).

    ``beam_gain``: a [time, baseline, chan] power gain in the imaging
    direction (e.g. a product of |aperture_array beam|^2); the weights are
    divided by it where it is positive, zeroed elsewhere (primary-beam
    weighting). Returns (vis [rows, chan], weights [rows, chan], flagged
    fraction).
    """
    vis4d, weights4d, beam_gain = on_device(vis4d, weights4d, beam_gain,
                                            device=device)
    _, w, frac = ingest_flag_and_weight(vis4d, weights4d,
                                        device=vis4d.device,
                                        **flagger_kwargs)
    t, b, c, _ = vis4d.shape
    vis = vis4d[..., 0].reshape(t * b, c)
    wgt = w[..., 0].reshape(t * b, c)
    if beam_gain is not None:
        g = beam_gain.reshape(t * b, c)
        wgt = torch.where(g > 0, wgt / g.to(wgt.dtype),
                          torch.zeros((), dtype=wgt.dtype,
                                      device=wgt.device))
    return vis, wgt, float(frac)


def ingest_flag_and_weight_sharded(vis4d, weights4d, mesh,
                                   axis_name: str = ROW_AXIS, device=None,
                                   **flagger_kwargs
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Mesh-sharded ingest (JAX ingest.py:77-119): the baselines shard
    over the mesh's ``axis_name`` (n ranks), on ``device`` (``None``: the
    mesh's, :func:`~..parallel.mesh.mesh_device`).

    The flagger's statistics are per (baseline, channel, pol) sample
    stream, so each rank flags its own block of baselines of the whole
    ``vis4d`` / ``weights4d`` [time, baseline, chan, pol] through
    :func:`ingest_flag_and_weight`, and only the flagged count is summed
    over the ranks. The baselines are padded to a multiple of n (zero
    visibilities and weights). Returns the rank's block of (flags4d,
    weights4d) [time, padded baselines / n, chan, pol], pad baselines
    included, and the flagged fraction of the whole stream on every rank;
    ``gather_rows`` of the blocks moved to axis 0 (``x.transpose(0, 1)``)
    gives the whole, in rank order.
    """
    n, rank, group = mesh_axis(mesh, axis_name)
    dev = mesh_device(mesh) if device is None else device
    t, b, c, p = vis4d.shape
    block = -(-b // n)
    lo, hi = min(rank * block, b), min((rank + 1) * block, b)
    vis, wgt = on_device(vis4d[:, lo:hi], weights4d[:, lo:hi], device=dev)
    pad = block - (hi - lo)
    if pad:
        vis = torch.cat([vis, vis.new_zeros((t, pad, c, p))], dim=1)
        wgt = torch.cat([wgt, wgt.new_zeros((t, pad, c, p))], dim=1)
    flags, clean_w, _ = ingest_flag_and_weight(vis, wgt, device=dev,
                                               **flagger_kwargs)
    flagged = flags.to(torch.float32).sum()
    dist.all_reduce(flagged, group=group)
    return flags, clean_w, flagged / float(t * b * c * p)


def station_beam_power(element_x, element_y, element_z, weights,
                       pointing_lmn, freq_hz: float,
                       device=None) -> torch.Tensor:
    """|station beam|^2 towards (l, m, n) directions ``[points, 3]``: the
    gain for primary-beam weighting (the aperture_array DFT,
    station_beam/sdp_station.h:121-140)."""
    (lmn,) = on_device(pointing_lmn, device=device)
    beam = aperture_array(
        2.0 * math.pi * freq_hz / 299792458.0, weights, element_x,
        element_y, element_z, lmn[:, 0], lmn[:, 1], lmn[:, 2],
        device=lmn.device)
    return beam.abs() ** 2
