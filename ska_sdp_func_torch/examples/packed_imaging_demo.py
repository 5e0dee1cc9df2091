"""Packed whole-image imaging demo (examples/packed_imaging_demo.py on
the port).

Runs the packed path end to end on synthetic data:

  plan_wstack -> plan_packed (host bucket sort + tap tables)
  -> PackedGridder (device bands built once; K1/K2 on the card)
  -> sorted-stream major-cycle iterations (degrid -> residual -> grid
     -> Hogbom minor cycle)
  -> per-stage report of one grid pass (``report_timing``)

    python -m ska_sdp_func_torch.examples.packed_imaging_demo

The oracle: each source's recovered flux within ``FLUX_TOL`` of the
sky's.
"""

import sys

import numpy as np
import torch

from ..clean.hogbom import _minor_cycle
from ..parallel import degrid_all_tasks, packed_gridder, plan_packed, \
    plan_wstack
from ..pipeline.major_cycle import _norm_mask, _stop_level, make_psf_plan
from ..utility.constants import C_0
from . import _device, _finish, _flux_errors, _oracle

# (row, column) offsets from the image centre and fluxes: the script's
# (100, 120) and (170, 90) at its 256^2.
SOURCES = ((-28, -8, 1.0), (42, -38, 0.6))
FLUX_TOL = 0.05


def run(device=None, image_size: int = 256, subgrid: int = 128,
        rows: int = 600, chans: int = 4, cycles: int = 4, seed: int = 7,
        timing_iters: int = 3) -> dict:
    """The demo on ``device``; returns the plan's numbers, the residual
    peak of each cycle, the sources' recovered fluxes, the stage report
    (``stages``: seconds, ``report``: its text) and the oracle's
    check."""
    dev = _device(device)
    theta, w_step, height = 0.002, 100.0, 4.0
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.35 * image_size / 2 / theta
    uvw[:, 2] *= 1.2 * w_step * height
    freq0, dfreq = C_0, C_0 / 100

    # Synthetic sky + exact prediction through the oracle task driver.
    sources = tuple((image_size // 2 + di, image_size // 2 + dj, f)
                    for (di, dj, f) in SOURCES)
    sky = np.zeros((image_size, image_size))
    for (i, j, f) in sources:
        sky[i, j] = f
    plan = plan_wstack(uvw, freq0, dfreq, chans, image_size, subgrid,
                       theta, w_step, support=8, w_support=4,
                       w_tower_height=height)
    st = np.zeros(rows, np.int32)
    en = np.full(rows, chans, np.int32)
    vis = degrid_all_tasks(plan, plan.kernel(), sky.astype(np.complex64),
                           uvw, st, en, torch.complex64, device=dev)

    # Packed ingest: one plan per uvw distribution.
    pplan = plan_packed(plan, uvw)
    gridder = packed_gridder(pplan, device=dev)
    psf_gridder = packed_gridder(plan_packed(make_psf_plan(plan, uvw), uvw),
                                 device=dev)
    psf = psf_gridder.grid(torch.ones_like(vis))
    peak = psf[image_size, image_size]
    # Exclude the 1/PSWF-divergent border ring from the CLEAN window.
    border = image_size // 8
    psf = _norm_mask(psf, peak, 2 * border)

    vre, vim = gridder.sort(vis)
    model = torch.zeros((image_size, image_size), dtype=torch.float32,
                        device=dev)
    peaks = []
    for _ in range(cycles):
        pred = gridder.degrid_sorted(model)
        raw = gridder.grid_sorted(vre - pred.real, vim - pred.imag)
        dirty = _norm_mask(raw, peak, border)
        # mgain guard: stop each minor cycle above the sidelobe level
        # (over-cleaning sparse uv coverage diverges the major loop).
        stop = _stop_level(dirty, torch.tensor(1e-3, device=dev),
                           torch.tensor(0.8, device=dev))
        delta, resid = _minor_cycle(dirty, psf, 0.1, stop, 300)
        model = model + delta
        peaks.append(float(resid.abs().max()))

    fluxes = [float(model[i, j]) for (i, j, _) in sources]
    report = []
    stages = gridder.report_timing(vre, vim, iters=timing_iters,
                                   print_fn=report.append)
    return dict(
        tasks=len(pplan.tasks), layers=pplan.num_layers,
        buckets=pplan.num_buckets, stream=pplan.total,
        padding=pplan.total / (rows * chans), residual_peaks=peaks,
        sources=sources, fluxes=fluxes, stages=stages,
        report="\n".join(report),
        oracle=_oracle(("largest recovered flux error, of each source's",
                        _flux_errors(fluxes, [f for *_, f in sources]),
                        FLUX_TOL)))


def main(device=None, **sizes) -> int:
    r = run(device, **sizes)
    print(f"packed plan: {r['tasks']} tasks, {r['layers']} tower layers, "
          f"{r['buckets']} buckets, stream {r['stream']} "
          f"({r['padding']:.2f}x padding)")
    for cycle, p in enumerate(r["residual_peaks"]):
        print(f"cycle {cycle}: residual peak {p:.2e}")
    for (i, j, f), got in zip(r["sources"], r["fluxes"]):
        print(f"source ({i},{j}) flux {f}: recovered {got:.4f}")
    print("\nPer-stage device time (one grid pass):")
    print(r["report"])
    return _finish(r)


if __name__ == "__main__":
    sys.exit(main())
