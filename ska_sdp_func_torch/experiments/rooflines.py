"""The card's measured device-memory read rate (bench.py's read probe).

Counterpart of bench.py's ``_measure_rooflines`` multi-stream probe
(``stream_loop``, the Pallas kernel ``_read_kernel``): 6 f32 streams of
[4096, 8192] read in 512 x 1024 blocks by :func:`..kernels.read_probe.
read_streams`, the scale multiplied by 1.000001 from call to call as the
TPU loop carries it. Each launch reads 805 MB; the rate is those bytes
over the kernel's CUDA-event time. Beside it: one stream of the same size,
and ATen's ``x.view(8, 512, 8192).sum(1)`` on each of the 6 streams (the
library's time for the same reads). A rate above the published 3.35 TB/s
by more than 5 % means the probe read fewer bytes than it counts, and
raises.

    python -m ska_sdp_func_torch.experiments.rooflines [--check]
"""

import numpy as np
import torch

from ..kernels import read_probe
from ..utility.tensors import resolve_device
from ._common import HBM_BYTES_S, abs_err, bound, card_name, chained_ms, \
    main, nbytes, rel_err

NAME = "rooflines"
# (streams, rows, cols, block rows, block cols): bench.py's probe, and the
# check scale.
SHAPE = (6, 4096, 8192, 512, 1024)
CHECK_SHAPE = (6, 64, 2048, 16, 512)
SCALE = 1.0
TOL = 1e-5            # f32 sum order, of max|plain|
MAX_RATE = 1.05 * HBM_BYTES_S


def operands(device="cuda", check: bool = False) -> dict:
    n, rows, cols, br, bc = CHECK_SHAPE if check else SHAPE
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal((rows, cols), np.float32),
                          device=dev) for _ in range(n)]
    return dict(xs=xs, block_rows=br, block_cols=bc)


def _streams(ops):
    return {"6 streams": ops["xs"], "1 stream": ops["xs"][:1]}


def launch(ops) -> dict:
    """One launch of the probe on the 6 streams and one on the first."""
    return {variant: read_probe.read_streams(xs, SCALE, ops["block_rows"],
                                             ops["block_cols"])
            for variant, xs in _streams(ops).items()}


def _row(ops, xs, got, iters):
    br, bc = ops["block_rows"], ops["block_cols"]
    plain = read_probe.read_streams_reference(xs, SCALE, br, bc)
    moved = nbytes(*xs, got[1])
    row = dict(max_abs_err=max(abs_err(g, w) for g, w in zip(got, plain)),
               rel_err=max(rel_err(g, w) for g, w in zip(got, plain)),
               bytes=moved)
    row["bound_ms"], row["bound_by"] = bound(moved)
    if row["rel_err"] > TOL:
        raise RuntimeError(f"read_streams ({len(xs)} streams) vs plain: "
                           f"{row['rel_err']:.3g} > {TOL}")
    if xs[0].device.type != "cuda":
        return row

    scale = [SCALE]

    def call():
        out = read_probe.read_streams(xs, scale[0], br, bc)
        scale[0] *= 1.000001
        return out

    row["ms"] = chained_ms(call, lambda out: None, iters)
    row["plain_ms"] = chained_ms(
        lambda: read_probe.read_streams_reference(xs, SCALE, br, bc),
        lambda out: None, 3, warmup=1)
    rows = xs[0].shape[0]
    row["library_ms"] = chained_ms(
        lambda: [x.view(rows // br, br, -1).sum(1) for x in xs],
        lambda out: None, iters)
    row["read_gb_s"] = nbytes(*xs) / row["ms"] / 1e6
    row["library_read_gb_s"] = nbytes(*xs) / row["library_ms"] / 1e6
    if row["read_gb_s"] * 1e9 > MAX_RATE:
        raise RuntimeError(
            f"read_streams reads {row['read_gb_s']:.1f} GB/s, above 1.05 x "
            f"the card's 3.35 TB/s: it reads fewer bytes than it counts")
    return row


def measure(ops, outs) -> list:
    """Each launch of :func:`launch` against its plain version, then the
    probe timed on 6 streams and on 1 (CUDA events, 20 chained calls)."""
    return [dict(variant=variant, **_row(ops, xs, outs[variant], 20))
            for variant, xs in _streams(ops).items()]


def run(device="cuda", check: bool = False) -> dict:
    ops = operands(device, check)
    rows = measure(ops, launch(ops))
    return dict(experiment=NAME, device=card_name(ops["xs"][0].device),
                rows=rows)


def measure_read_bandwidth(device="cuda") -> float:
    """The card's read rate in GB/s over bench.py's 6 streams (CUDA events;
    raises on a CPU device)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the read rate is measured on a CUDA card")
    return run(dev)["rows"][0]["read_gb_s"]


if __name__ == "__main__":
    main(run, __doc__)
