"""Streaming ingest demo: planning on the device
(examples/streaming_ingest_demo.py on the port).

Simulates an observation arriving in time chunks and grids it into a
dirty image with no host planning in the loop:

  stream_tasks (one host pre-scan of the uvw metadata)
  -> plan_stream (static task geometry, once per observation)
  -> StreamingGridder.accumulate per chunk: the per-visibility plan
     (quantised geometry, bucket sort, padded placement by K5) and the
     window-scatter grid (K3) run on the device
  -> finalize() checks the processed-visibility count invariant
  -> StreamingDegridder predicts model visibilities chunk by chunk (K4;
     the selfcal direction)

    python -m ska_sdp_func_torch.examples.streaming_ingest_demo

The oracle: the prediction against the task driver's, max relative error
within ``PREDICT_TOL``; each source's dirty peak within ``PEAK_TOL`` of
its flux.
"""

import sys

import numpy as np
import torch

from ..parallel import (
    StreamingDegridder,
    StreamingGridder,
    degrid_all_tasks,
    plan_stream,
    plan_wstack,
    stream_tasks,
)
from ..utility.constants import C_0
from . import _device, _finish, _flux_errors, _oracle

SOURCES = (((100, 120), 1.0), ((170, 90), 0.6))
PREDICT_TOL = 1e-4
PEAK_TOL = 0.05


def run(device=None, image: int = 256, subgrid: int = 128,
        theta: float = 0.002, rows: int = 384, chans: int = 2,
        chunk_rows: int = 128, seed: int = 8) -> dict:
    """The demo on ``device``; returns the stream's numbers, the
    counters, the dirty peaks at the sources, the prediction's error and
    the oracle's check."""
    dev = _device(device)
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.3 * image / 2 / theta
    uvw[:, 2] *= 200.0

    # Sky: two point sources; exact prediction through the task driver
    # (reference-faithful conventions).
    sky = np.zeros((image, image), np.float32)
    for (px, py), f in SOURCES:
        sky[px, py] = f
    plan = plan_wstack(uvw, C_0, C_0 / 100, chans, image, subgrid, theta,
                       50.0, support=8, w_support=4, w_tower_height=4.0)
    st = np.zeros(rows, np.int32)
    en = np.full(rows, chans, np.int32)
    vis = degrid_all_tasks(plan, plan.kernel(), sky.astype(np.complex64),
                           uvw, st, en, torch.complex64, device=dev)

    boxes = stream_tasks(plan, uvw)        # host pre-scan, once
    sp = plan_stream(plan, boxes, chunk_rows=chunk_rows, block_v=128,
                     cap_slots=40960)

    # Dirty image + PSF (unit visibilities) in the same chunked pass
    # structure; the PSF peak normalises the dirty image.
    sg = StreamingGridder(sp, device=dev)
    sg_psf = StreamingGridder(sp, device=dev)
    chunks = []
    for lo in range(0, rows, chunk_rows):
        hi = min(rows, lo + chunk_rows)
        sg.accumulate(uvw[lo:hi], vis[lo:hi])
        sg_psf.accumulate(uvw[lo:hi], torch.ones_like(vis[lo:hi]))
        chunks.append((lo, hi))
    dirty = sg.finalize()                  # raises if any vis dropped
    psf = sg_psf.finalize()
    dirty = dirty / psf[image // 2, image // 2]
    counters = [int(x) for x in sg.counters()]
    peaks = [float(dirty[px, py]) for (px, py), _ in SOURCES]

    # Predict direction (model -> visibilities), chunk by chunk.
    sd = StreamingDegridder(sp, device=dev).set_model(sky)
    pred = torch.cat([sd.predict(uvw[lo:hi]) for lo, hi in chunks])
    sd.check()
    err = float((pred - vis).abs().max() / vis.abs().max())
    return dict(
        task_boxes=len(sp.tasks), buckets=sp.num_buckets, capacity=sp.cap,
        chunks=chunks, counters=counters, sources=SOURCES, peaks=peaks,
        predict_err=err,
        oracle=_oracle(
            ("prediction vs the task driver's, max rel err", err,
             PREDICT_TOL),
            ("largest dirty peak error, of each source's flux",
             _flux_errors(peaks, [f for _, f in SOURCES]), PEAK_TOL)))


def main(device=None, **sizes) -> int:
    r = run(device, **sizes)
    print(f"stream: {r['task_boxes']} task boxes, {r['buckets']} buckets, "
          f"capacity {r['capacity']} slots")
    for lo, hi in r["chunks"]:
        print(f"  chunk rows [{lo}, {hi}) accumulated")
    p, d, v = r["counters"]
    print(f"gridded {p} visibilities (dropped {d}, voided chunks {v})")
    for ((px, py), f), peak in zip(r["sources"], r["peaks"]):
        print(f"  source at ({px},{py}) flux {f}: dirty peak {peak:.4f}")
    print(f"predicted visibilities vs oracle degridder: max rel err "
          f"{r['predict_err']:.2e}")
    return _finish(r)


if __name__ == "__main__":
    sys.exit(main())
