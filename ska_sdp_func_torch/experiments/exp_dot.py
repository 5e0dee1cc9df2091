"""The packed grid kernel's band product in its formulations, on the
tensor cores and on the CUDA cores.

Counterpart of experiments/exp_dot.py: per block of B slots, ``[128, B] @
[B, 128]`` summed per bucket (:func:`..kernels.bucket_dot.bucket_dot`), at
the experiment's scale (block_v 1024, 2048 blocks, 8 a bucket: 2,097,152
slots, 6.87e10 FLOP a call; seed 0) or its check scale (128, 8, 2). The
variants are exp_dot's (prod, lhs_stream, ksplit2/4, npair, nodot, each
f32 and bf16 where it has both) and ``prod_simt``, prod with f32 FMAs on
the CUDA cores as K1 and K8 compute today. Every variant is held against
its plain version at 1e-5 of max (bf16 against the bf16 plain version;
and against f32 prod at exp_dot's 5e-2), npair with its halves folded
against prod. On the card each is timed by CUDA events, the inputs chained
from the outputs, and ``torch.bmm`` on lhs_stream's operands, viewed as
[buckets, 128, 8 B] @ [buckets, 8 B, 128], is the library's time (TF32
off for f32).

    python -m ska_sdp_func_torch.experiments.exp_dot [--check]
"""

import numpy as np
import torch

from ..kernels import bucket_dot as bd
from ..utility.tensors import resolve_device
from ._common import BF16_OPS_S, F32_OPS_S, TF32_OPS_S, abs_err, bound, \
    card_name, chained_ms, main, nbytes, rel_err

NAME = "exp_dot"
# (block_v, blocks, blocks a bucket): the experiment's scale and its check.
SCALE = (1024, 2048, 8)
CHECK_SCALE = (128, 8, 2)
# Variant: (form, bf16), in the experiment's order, and prod_simt.
VARIANTS = {"prod": ("prod", False), "prod_bf16": ("prod", True),
            "prod_simt": ("prod_simt", False),
            "lhs_stream": ("lhs_stream", False),
            "lhs_stream_bf16": ("lhs_stream", True),
            "ksplit2": ("ksplit2", False), "ksplit2_bf16": ("ksplit2", True),
            "ksplit4": ("ksplit4", False), "ksplit4_bf16": ("ksplit4", True),
            "npair": ("npair", False), "npair_bf16": ("npair", True),
            "nodot": ("nodot", False)}
TOL = 1e-5        # of max|plain|: f32 sum order (and the TF32 hi/lo split)
BF16_TOL = 5e-2   # bf16 against f32 prod (exp_dot's CPU check)


def operands(device="cuda", check: bool = False) -> dict:
    block_v, nb, per = CHECK_SCALE if check else SCALE
    dev = resolve_device(device)
    total = block_v * nb
    rng = np.random.default_rng(0)
    put = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    ubase = put(rng.standard_normal((16, total)))
    vband = put(rng.standard_normal((total, 128)))
    scales = put(rng.standard_normal((8, total)))
    ids = torch.as_tensor(np.arange(nb) // per, dtype=torch.int32, device=dev)
    uall = (ubase[None] * scales[:, None]).reshape(128, total)
    return dict(ids=ids, ubase=ubase, vband=vband, scales=scales, uall=uall,
                uall16=uall.bfloat16(), vband16=vband.bfloat16(),
                block_v=block_v, num_buckets=nb // per)


def inputs(ops, variant: str):
    """The variant's ``(form, ins)``."""
    form, bf16 = VARIANTS[variant]
    vband = ops["vband16"] if bf16 else ops["vband"]
    if form == "lhs_stream":
        return form, (ops["uall16"] if bf16 else ops["uall"], vband)
    return form, (ops["ubase"], vband, ops["scales"])


def launch(ops, variants=None) -> dict:
    """One launch a variant (of ``variants``, by default all)."""
    outs = {}
    for variant in variants or VARIANTS:
        form, ins = inputs(ops, variant)
        outs[variant] = bd.bucket_dot(form, ops["ids"], ins,
                                      ops["num_buckets"], ops["block_v"])
    return outs


def _bound(variant, ins, out):
    """Bytes of the inputs read once and the output written once; the
    product's 2 x 128 x 128 operations a slot over the unit's peak (TF32:
    three passes of the published dense rate; nodot: its adds and
    multiplies on the CUDA cores)."""
    form, bf16 = VARIANTS[variant]
    total = ins[1].shape[0]
    moved = nbytes(*ins, out)
    if form == "nodot":
        return bound(moved, 2 * 128 * total)
    ops = 2 * 128 * 128 * total
    if form == "prod_simt":
        return bound(moved, ops, F32_OPS_S)
    if bf16:
        return bound(moved, ops, BF16_OPS_S)
    return bound(moved, ops, TF32_OPS_S, passes=3)


def _library(ops, variant):
    """``torch.bmm`` on lhs_stream's operands, one product a bucket."""
    _, (uall, vband) = inputs(ops, variant)
    nbk = ops["num_buckets"]
    a = uall.view(128, nbk, -1).permute(1, 0, 2)
    b = vband.view(nbk, -1, 128)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return chained_ms(lambda: torch.bmm(a, b), lambda out: None, 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def measure(ops, outs) -> list:
    """Each launched variant against its plain version (and bf16 against
    f32 prod, npair folded against prod); on the card, its time (10
    chained calls), the plain version's, and the library's for
    lhs_stream."""
    form, ins = inputs(ops, "prod")
    base = bd.bucket_dot_reference(form, ops["ids"], ins, ops["num_buckets"],
                                   ops["block_v"])
    on_card = ops["ids"].device.type == "cuda"
    rows = []
    for variant in outs:
        form, bf16 = VARIANTS[variant]
        _, ins = inputs(ops, variant)
        got = outs[variant]
        want = bd.bucket_dot_reference(form, ops["ids"], ins,
                                       ops["num_buckets"], ops["block_v"])
        row = dict(variant=variant, max_abs_err=abs_err(got, want),
                   rel_err=rel_err(got, want))
        if form == "npair":
            row["vs_prod"] = rel_err(got[:, :128] + got[:, 128:], base)
        elif form != "nodot":
            row["vs_prod"] = rel_err(got, base)
        limit = BF16_TOL if bf16 else TOL
        if row["rel_err"] > TOL or row.get("vs_prod", 0.0) > limit:
            raise RuntimeError(f"bucket_dot {variant}: {row}")
        row["bytes"] = nbytes(*ins, got)
        row["bound_ms"], row["bound_by"] = _bound(variant, ins, got)
        if on_card:
            fed = ins[0] if form == "lhs_stream" else ins[2]

            def feed(out):
                fed.view(-1)[:1].add_((out.view(-1)[:1] * 0).to(fed.dtype))

            call = lambda: bd.bucket_dot(  # noqa: E731
                form, ops["ids"], ins, ops["num_buckets"], ops["block_v"])
            row["ms"] = chained_ms(call, feed, 10)
            row["plain_ms"] = chained_ms(lambda: bd.bucket_dot_reference(
                form, ops["ids"], ins, ops["num_buckets"], ops["block_v"]),
                feed, 2, warmup=1)
            row["tflop_s"] = 2 * 128 * 128 * ins[1].shape[0] / row["ms"] / 1e9
            if form == "lhs_stream":
                row["library_ms"] = _library(ops, variant)
        rows.append(row)
    return rows


def run(device="cuda", check: bool = False) -> dict:
    ops = operands(device, check)
    rows = measure(ops, launch(ops))
    return dict(experiment=NAME, device=card_name(ops["ids"].device),
                rows=rows)


if __name__ == "__main__":
    main(run, __doc__)
