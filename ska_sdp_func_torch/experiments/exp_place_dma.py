"""Gap-insertion placement (K5) against the placement sort.

Counterpart of experiments/exp_place_dma.py: its Pallas kernel
``place_dma`` computes K5's function (every ``bv``-slot block of the
padded stream is one contiguous range of the key-sorted stream), so this
driver runs the port's K5, :func:`..kernels.place.place_stream`, on the
experiment's synthetic layout: N entries over ``nbuck`` buckets (Dirichlet
counts, seed 2), each bucket's region padded to a multiple of ``bv``, 4
payloads (2 int32, 2 f32), ``src0``/``vcnt`` from the bucket tables. It is
held bit for bit against the experiment's NumPy oracle and timed beside
the placement it was written against: one sort of the N + cap keys with
the 4 zero-padded payloads gathered by the sort's order (``sort_ms``).
On the card it also reports K5's device time and device operations a
call (``device_ms``, ``device_ops``, by ``torch.profiler``).

    python -m ska_sdp_func_torch.experiments.exp_place_dma [--check]
"""

import numpy as np
import torch

from ..kernels import place
from ..utility.tensors import resolve_device
from ._common import bound, card_name, chained_ms, device_ms, main

NAME = "exp_place_dma"
# (N, cap, bv, buckets): the experiment's scale, and its check scale.
SCALE = (4194304, 5872640, 512, 5760)
CHECK_SCALE = (3000, 4096, 128, 17)


def layout(n: int, cap: int, bv: int, nbuck: int):
    """The experiment's synthetic layout (exp_place_dma.py:103-125):
    ``(counts, edges, pad_off, src0, vcnt, payloads)`` as NumPy arrays,
    with the generator after the payloads."""
    rng = np.random.default_rng(2)
    raw = rng.dirichlet(np.ones(nbuck)) * n
    counts = np.maximum(raw.astype(np.int64), 0)
    counts[-1] += n - counts.sum()
    edges = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    padded = -(-counts // bv) * bv
    pad_off = np.concatenate([[0], np.cumsum(padded)]).astype(np.int64)
    if pad_off[-1] > cap:
        raise ValueError(f"the padded stream ({pad_off[-1]}) exceeds cap")
    nb = cap // bv
    block_bucket = np.clip(
        np.searchsorted(pad_off[1:], np.arange(nb) * bv, side="right"),
        0, nbuck - 1)
    off_in_bucket = np.arange(nb) * bv - pad_off[block_bucket]
    src0 = (edges[block_bucket] + off_in_bucket).astype(np.int32)
    vcnt = np.clip(counts[block_bucket] - off_in_bucket, 0,
                   bv).astype(np.int32)
    src0 = np.clip(src0, 0, max(n - 1, 0)).astype(np.int32)
    payloads = (rng.integers(0, 1 << 30, n, dtype=np.int32),
                rng.integers(0, 1 << 30, n, dtype=np.int32),
                rng.standard_normal(n).astype(np.float32),
                rng.standard_normal(n).astype(np.float32))
    return counts, edges, pad_off, src0, vcnt, payloads, rng


def oracle(counts, edges, pad_off, payloads, cap: int):
    """The experiment's NumPy oracle (exp_place_dma.py:141-148)."""
    out = []
    for x in payloads:
        o = np.zeros(cap, x.dtype)
        for bkt in range(len(counts)):
            n_b = int(counts[bkt])
            o[pad_off[bkt]:pad_off[bkt] + n_b] = x[edges[bkt]:edges[bkt] + n_b]
        out.append(o)
    return out


def operands(device="cuda", check: bool = False) -> dict:
    n, cap, bv, nbuck = CHECK_SCALE if check else SCALE
    dev = resolve_device(device)
    counts, edges, pad_off, src0, vcnt, payloads, rng = layout(n, cap, bv,
                                                               nbuck)
    put = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    # The sort placement's keys: N sorted random positions, then cap
    # filler keys past them (exp_place_dma.py:182-185).
    keys = np.concatenate([np.sort(rng.integers(0, cap, n).astype(np.int32)),
                           (cap + np.arange(cap)).astype(np.int32)])
    return dict(src0=put(src0), vcnt=put(vcnt),
                payloads=tuple(put(x) for x in payloads), bv=bv, cap=cap,
                keys=put(keys), host=(counts, edges, pad_off, payloads))


def launch(ops) -> dict:
    """One K5 launch placing the 4 payloads."""
    return {"place": place.place_stream(ops["src0"], ops["vcnt"],
                                        ops["payloads"], ops["bv"],
                                        ops["cap"])}


def _sort_place(keys, payloads, n, cap):
    order = torch.sort(keys).indices
    return tuple(torch.cat([x[:n], x.new_zeros(cap)])[order]
                 for x in payloads)


def measure(ops, outs) -> list:
    """K5's placement against the NumPy oracle (bit for bit) and its plain
    version; on the card its time beside the plain version's and the
    placement sort's."""
    counts, edges, pad_off, payloads = ops["host"]
    cap, bv = ops["cap"], ops["bv"]
    want = oracle(counts, edges, pad_off, payloads, cap)
    got = outs["place"]
    plain = place.place_stream_reference(ops["src0"], ops["vcnt"],
                                         ops["payloads"], bv, cap)
    bad = [i for i, (g, w, p) in enumerate(zip(got, want, plain))
           if not (np.array_equal(g.cpu().numpy().view(np.int32),
                                  w.view(np.int32))
                   and torch.equal(g, p))]
    if bad:
        raise RuntimeError(f"placement differs from the oracle in payloads "
                           f"{bad}")
    n = payloads[0].shape[0]
    # Each payload: its N valid entries read once, cap slots written; the
    # block tables read once.
    moved = 4 * 4 * (n + cap) + 4 * 2 * ops["src0"].numel()
    row = dict(variant="4 payloads", max_abs_err=0.0, rel_err=0.0,
               bytes=moved, entries=n, slots=cap)
    row["bound_ms"], row["bound_by"] = bound(moved)
    if ops["src0"].device.type == "cuda":
        src0, vcnt, pays = ops["src0"], ops["vcnt"], ops["payloads"]
        fed = pays[2]

        def feed(out):
            fed[:1].add_(out[2][:1] * 0)

        row["ms"] = chained_ms(lambda: place.place_stream(
            src0, vcnt, pays, bv, cap), feed, 20)
        row["plain_ms"] = chained_ms(lambda: place.place_stream_reference(
            src0, vcnt, pays, bv, cap), feed, 5)
        row["sort_ms"] = chained_ms(lambda: _sort_place(
            ops["keys"], pays, n, cap), feed, 5)
        row["device_ms"], row["device_ops"], _ = device_ms(
            lambda: place.place_stream(src0, vcnt, pays, bv, cap))
    return [row]


def run(device="cuda", check: bool = False) -> dict:
    ops = operands(device, check)
    rows = measure(ops, launch(ops))
    return dict(experiment=NAME, device=card_name(ops["src0"].device),
                rows=rows)


if __name__ == "__main__":
    main(run, __doc__)
