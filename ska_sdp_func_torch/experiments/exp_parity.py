"""Split accumulators for the dense-band grid: does splitting a bucket's
accumulator into parity slots help?

Counterpart of experiments/exp_parity.py: :func:`..kernels.bucket_dot.
grid_parity` (``grid_packed_pallas``'s dense-band function, block b into
slot b % slots, the slots added at the bucket's end) at slots 1, 2 and 4,
on the experiment's scenario: 16384 rows x 256 channels at image 512,
seed 1 (check: 256 rows x 4 channels at image 256), planned by the port's
``plan_wstack`` -> ``plan_packed(block_v=256)`` and banded by a
``PackedGridder`` at ``precision="highest"`` (f32 ``vband [V, lanes]``;
the experiment's own script calls ``packed_gridder(pplan)``, whose default
"high" splits the band into bf16 halves that ``grid_packed_pallas`` cannot
take). The scales are ``concat(wk_t * vre, wk_t * vim)`` of the sorted
visibilities. Each slot count is held against its plain version at 1e-5 of
max and, on the card, timed by CUDA events, the scales chained from the
output.

    python -m ska_sdp_func_torch.experiments.exp_parity [--check]
"""

import numpy as np
import torch

from ..kernels import bucket_dot as bd
from ..parallel import PackedGridder, plan_packed, plan_wstack
from ..utility.tensors import resolve_device
from ._common import TF32_OPS_S, abs_err, bound, card_name, chained_ms, \
    main, nbytes, rel_err

NAME = "exp_parity"
C_0 = 299792458.0
SLOTS = (1, 2, 4)
# (rows, channels, image): the experiment's scenario and its check.
SCENARIO = (16384, 256, 512)
CHECK_SCENARIO = (256, 4, 256)
BLOCK_V = 256
TOL = 1e-5


def scenario(rows: int, chans: int, image: int = 512):
    """The experiment's ``_scenario`` (exp_parity.py:124-135) on the port's
    planner: ``(plan, uvw, vis)``."""
    rng = np.random.default_rng(1)
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.45 * image / 2 / 0.002
    uvw[:, 2] *= 1.5 * 100.0 * 4.0
    vis = (rng.standard_normal((rows, chans))
           + 1j * rng.standard_normal((rows, chans))).astype(np.complex64)
    plan = plan_wstack(uvw, C_0, C_0 / (100 * chans), chans, image, 128,
                       0.002, 100.0, support=8, w_support=4,
                       w_tower_height=4.0)
    return plan, uvw, vis


def operands(device="cuda", check: bool = False) -> dict:
    dev = resolve_device(device)
    plan, uvw, vis = scenario(*(CHECK_SCENARIO if check else SCENARIO))
    pplan = plan_packed(plan, uvw, block_v=BLOCK_V)
    g = PackedGridder(pplan, precision="highest", device=dev)
    vre, vim = g.sort(vis)
    sl = g.slots
    scales = torch.cat([sl.wk_t * vre[None, :], sl.wk_t * vim[None, :]])
    ids = torch.as_tensor(pplan.arrays["block_bucket"], dtype=torch.int32,
                          device=dev)
    return dict(ids=ids, ubase=sl.ubase, vband=sl.vband, scales=scales,
                num_buckets=pplan.num_buckets, lanes=plan.subgrid_size,
                w_support=plan.w_support, block_v=pplan.block_v,
                visited=torch.as_tensor(pplan.arrays["visited"], device=dev),
                num_vis=vis.size, runs=bd.dot_runs(ids))


def args(ops):
    return (ops["ids"], ops["ubase"], ops["vband"], ops["scales"],
            ops["num_buckets"], ops["lanes"], ops["w_support"],
            ops["block_v"])


def call(ops, slots):
    """One launch at ``slots``, over the run table built once."""
    return bd.grid_parity(*args(ops), slots=slots, runs=ops["runs"])


def launch(ops) -> dict:
    """One launch a slot count."""
    return {f"slots{s}": call(ops, s) for s in SLOTS}


def measure(ops, outs) -> list:
    """Each slot count against its plain version on the visited buckets
    (unvisited ones are zero in both) and against slots 1; on the card,
    its time (10 chained calls) and the plain version's."""
    total = ops["vband"].shape[0]
    rows = []
    base = outs["slots1"]
    for s in SLOTS:
        got = outs[f"slots{s}"]
        want = bd.grid_parity_reference(*args(ops), slots=s)
        row = dict(variant=f"slots{s}",
                   max_abs_err=abs_err(got, want),
                   rel_err=rel_err(got, want),
                   vs_slots1=rel_err(got, base), slots=total,
                   visited_buckets=int(ops["visited"].sum()))
        if row["rel_err"] > TOL or row["vs_slots1"] > TOL:
            raise RuntimeError(f"grid_parity slots={s}: {row}")
        row["bytes"] = nbytes(ops["ids"], ops["ubase"], ops["vband"],
                              ops["scales"], got)
        row["bound_ms"], row["bound_by"] = bound(
            row["bytes"], 2 * 128 * 128 * total, TF32_OPS_S, passes=3)
        if ops["ids"].device.type == "cuda":
            fed = ops["scales"]

            def feed(out):
                fed.view(-1)[:1].add_(out.view(-1)[:1] * 0)

            row["ms"] = chained_ms(lambda: call(ops, s), feed, 10)
            row["plain_ms"] = chained_ms(lambda: bd.grid_parity_reference(
                *args(ops), slots=s), feed, 2, warmup=1)
            row["mvis_s"] = ops["num_vis"] / row["ms"] / 1e3
        rows.append(row)
    return rows


def run(device="cuda", check: bool = False) -> dict:
    ops = operands(device, check)
    rows = measure(ops, launch(ops))
    return dict(experiment=NAME, device=card_name(ops["ids"].device),
                rows=rows)


if __name__ == "__main__":
    main(run, __doc__)
