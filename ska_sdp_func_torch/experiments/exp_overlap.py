"""Do tap builds on the CUDA cores overlap tensor-core products?

Counterpart of experiments/exp_overlap.py: :func:`..kernels.overlap.
overlap` in its four variants (dot, vpu, both, both2) over the
experiment's TOTAL = 4M slots in blocks of 1024, chunks of 512, a
degree-11 fit, seed 0 (check: 4 blocks). If t(both) is near max(t(vpu),
t(dot)) the units overlap and a fused kernel can beat the sum of its
build and its product; near t(vpu) + t(dot) they serialise. Each variant
is held against its plain version (the last block's acc and every
block's sum |acc|, at 1e-5 of max) and, on the card, timed by CUDA
events, ``pa`` chained from the output.

    python -m ska_sdp_func_torch.experiments.exp_overlap [--check]
"""

import numpy as np
import torch

from ..kernels import overlap as ov
from ..utility.tensors import resolve_device
from ._common import F32_OPS_S, TF32_OPS_S, abs_err, bound, card_name, \
    chained_ms, main, nbytes, rel_err

NAME = "exp_overlap"
BLOCK, SUB, DEG = 1024, 512, 11
TOTAL = 4 * 1024 * 1024
CHECK_TOTAL = 4 * BLOCK
TOL = 1e-5


def operands(device="cuda", check: bool = False) -> dict:
    total = CHECK_TOTAL if check else TOTAL
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    pa = rng.integers(0, 2 ** 22, (1, total), np.int32)
    pb = rng.integers(0, 2 ** 22, (1, total), np.int32)
    c = rng.standard_normal((DEG + 1, ov.SUPPORT)).astype(np.float32)
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return dict(pa=put(pa[0]), pb=put(pb[0]), c=put(c))


def launch(ops) -> dict:
    """One launch a variant."""
    return {v: ov.overlap(v, ops["pa"], ops["pb"], ops["c"], BLOCK, SUB)
            for v in ov.VARIANTS}


def _ops(variant: str, total: int, ncoef: int):
    """(tensor-core operations, CUDA-core f32 operations) of a call: the
    product's 2 x 128 x 128 a slot; the build's three 8-tap Clenshaw
    evaluations (3 a term, 3 for x) and its 64 products a slot."""
    mma = 0 if variant == "vpu" else 2 * 128 * 128 * total
    build = 0 if variant == "dot" else \
        total * (3 * ov.SUPPORT * (3 * (ncoef - 1) + 3) + 64)
    if variant == "vpu":
        build += 2 * 128 * 128 * total // SUB
    return mma, build


def measure(ops, outs) -> list:
    """Each variant against its plain version; on the card its time (10
    chained calls) and the plain version's."""
    total = ops["pa"].shape[0]
    rows = []
    for variant in ov.VARIANTS:
        out, sums = outs[variant]
        want_out, want_sums = ov.overlap_reference(variant, ops["pa"],
                                                   ops["pb"], ops["c"],
                                                   BLOCK, SUB)
        row = dict(variant=variant,
                   max_abs_err=max(abs_err(out, want_out),
                                   abs_err(sums, want_sums)),
                   rel_err=rel_err(out, want_out),
                   block_sums_rel_err=rel_err(sums, want_sums),
                   blocks=int(sums.numel()))
        if row["rel_err"] > TOL or row["block_sums_rel_err"] > TOL:
            raise RuntimeError(f"overlap {variant}: {row}")
        mma, build = _ops(variant, total, ops["c"].shape[0])
        moved = row["bytes"] = nbytes(ops["pa"], ops["pb"], ops["c"], out,
                                      sums)
        t_mma = bound(moved, mma, TF32_OPS_S, passes=3)
        t_build = bound(moved, build, F32_OPS_S)
        row["bound_ms"], row["bound_by"] = max(t_mma, t_build)
        if ops["pa"].device.type == "cuda":
            pa = ops["pa"]

            def feed(res):
                pa[:1].bitwise_xor_((res[1][:1] > -1).to(torch.int32) * 0)

            row["ms"] = chained_ms(lambda: ov.overlap(
                variant, pa, ops["pb"], ops["c"], BLOCK, SUB), feed, 10)
            row["plain_ms"] = chained_ms(lambda: ov.overlap_reference(
                variant, pa, ops["pb"], ops["c"], BLOCK, SUB), feed, 1,
                warmup=1)
        rows.append(row)
    return rows


def overlap_fraction(rows) -> float:
    """(t(vpu) + t(dot) - t(both)) / (t(vpu) + t(dot) - max): 1 when the
    build and the product overlap fully, 0 when they serialise."""
    t = {r["variant"]: r["ms"] for r in rows}
    s = t["vpu"] + t["dot"]
    return (s - t["both"]) / max(s - max(t["vpu"], t["dot"]), 1e-9)


def run(device="cuda", check: bool = False) -> dict:
    ops = operands(device, check)
    rows = measure(ops, launch(ops))
    result = dict(experiment=NAME, device=card_name(ops["pa"].device),
                  rows=rows)
    if "ms" in rows[0]:
        result["overlap_fraction"] = overlap_fraction(rows)
    return result


if __name__ == "__main__":
    main(run, __doc__)
