"""Full production pipeline: ingest -> weights -> bucketed solve
(examples/full_pipeline_demo.py on the port).

Simulates a sky and two broadband RFI bursts, runs the flagging and
weighting ingest, Briggs-weights the surviving samples and solves with
the major-cycle imager on 32^2 sub-grids, a geometry the packed path
cannot take: the bucketed fallback, whose all-layer kernels are K16/K17.

    python -m ska_sdp_func_torch.examples.full_pipeline_demo

The oracle: every RFI sample flagged, and each source's recovered flux
(the model summed over 5 x 5 pixels about it) within ``FLUX_TOL`` of
the sky's.
"""

import sys

import numpy as np
import torch

from ..grid_data import dft, image_to_flmn
from ..parallel import plan_wstack
from ..pipeline import ingest_to_solver, major_cycle_imager
from ..utility.constants import C_0
from ..visibility import briggs_weights, get_uv_range
from . import _device, _finish, _flux_errors, _oracle

# (row, column) offsets from the image centre and fluxes.
SOURCES = ((12, -9, 1.0), (-20, 15, 0.4))
# (time, baseline, value) of the broadband RFI.
RFI = ((9, 11, 120.0 - 80.0j), (13, 33, -90.0 + 60.0j))
FLUX_TOL = 0.05


def run(device=None, image_size: int = 128, times: int = 16,
        baselines: int = 40, num_chan: int = 2, n_major: int = 4,
        seed: int = 2) -> dict:
    """The demo on ``device``; returns the flagged fraction, the residual
    peak history, the recovered fluxes and the oracle's check."""
    dev = _device(device)
    rng = np.random.default_rng(seed)
    theta = 0.002
    num_rows = times * baselines
    c = image_size // 2
    sources = tuple((c + di, c + dj, f) for (di, dj, f) in SOURCES)

    sky = np.zeros((image_size, image_size))
    for (i, j, f) in sources:
        sky[i, j] = f
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.3 * image_size / 2 / theta
    uvw[:, 2] *= 250.0
    freq0, dfreq = C_0, C_0 / 100

    flux, lmn = image_to_flmn(sky, theta)
    vis = dft(uvw, flux.astype(complex), lmn, freq0_hz=freq0,
              dfreq_hz=dfreq, num_chan=num_chan, device=dev)

    # Corrupt two samples with broadband RFI, then ingest. (The
    # flagger's recursive statistics need a few time samples of history
    # before a transient stands out: reference behaviour.)
    vis4d = vis.reshape(times, baselines, num_chan, 1).clone()
    for (t, b, v) in RFI:
        vis4d[t, b, :, 0] += v
    w4d = torch.ones(vis4d.shape, dtype=torch.float64, device=dev)
    vis_flat, w_flat, frac = ingest_to_solver(vis4d, w4d, device=dev)

    # Briggs robust weighting on the surviving samples.
    freqs = freq0 + dfreq * np.arange(num_chan)
    uvw4 = uvw.reshape(times, baselines, 3)
    max_uv = get_uv_range(uvw4, freqs)
    _, bw = briggs_weights(uvw4, freqs, max_uv, 0.5, w4d, 64, device=dev)
    weights = bw[..., 0].reshape(num_rows, num_chan) * w_flat

    plan = plan_wstack(uvw, freq0, dfreq, num_chan, image_size,
                       subgrid_size=32, theta=theta, w_step=50.0,
                       support=8, oversampling=16384, w_support=4,
                       w_oversampling=16384, w_tower_height=4.0)
    result = major_cycle_imager(
        plan, vis_flat.to(torch.complex64), uvw.astype(np.float32),
        n_major=n_major, loop_gain=0.2, threshold=1e-3, cycle_limit=300,
        weights=weights.to(torch.float32), bucketed=True, device=dev)

    model = result.model
    fluxes = [float(model[i - 2:i + 3, j - 2:j + 3].sum())
              for (i, j, _) in sources]
    unflagged = sum(int((w_flat[t * baselines + b] != 0).sum())
                    for (t, b, _) in RFI)
    return dict(
        flagged=frac, peak_history=[float(p) for p in result.peak_history],
        sources=sources, fluxes=fluxes,
        oracle=_oracle(("RFI samples left unflagged", unflagged, 0),
                       ("largest recovered flux error, of each source's",
                        _flux_errors(fluxes, [f for *_, f in sources]),
                        FLUX_TOL)))


def main(device=None, **sizes) -> int:
    r = run(device, **sizes)
    print(f"ingest: flagged fraction {r['flagged']:.4f}")
    print("residual history:", [f"{p:.4f}" for p in r["peak_history"]])
    print("recovered fluxes:", *r["fluxes"])
    return _finish(r)


if __name__ == "__main__":
    sys.exit(main())
