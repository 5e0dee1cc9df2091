"""The bucket-run table of the packed band kernels (K1/K2 on the card).

``packed_tap.bucket_runs`` cuts a plan's blocks into maximal runs of
consecutive blocks of one bucket (t, k0, g), longest first: the tensor-
core kernels' work units. Held here, on the CPU, against a NumPy
reference: every block in exactly one run, no run crossing a bucket, each
run maximal, in order. On bench.py's plan it gives the 1237 runs of 1-5
blocks the kernels are sized for; the test plan, its blocks shuffled
(runs of length 1), one bucket and long runs are handled. The wrappers'
CPU path ignores ``runs``; the packed gridder builds the table once.
"""

import numpy as np
import pytest
import torch

from _torch_scenario import BENCH, DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, \
    PARAMS, bench_uvw, make_inputs
from ska_sdp_func_torch.kernels import packed_tap as tk
from ska_sdp_func_torch.parallel import PackedGridder, plan_packed, \
    plan_wstack

C_0 = 299792458.0


def runs_numpy(t, k, g):
    """Reference: walk the blocks, cut where the bucket changes, sort by
    length (descending), then first block."""
    key = np.stack([t, k, g], axis=1)
    runs, start = [], 0
    for b in range(1, len(t) + 1):
        if b == len(t) or (key[b] != key[b - 1]).any():
            runs.append((start, b - start))
            start = b
    runs.sort(key=lambda r: (-r[1], r[0]))
    return np.asarray(runs, np.int32).reshape(-1, 2)


def _indices(pplan):
    bb = pplan.arrays["block_bucket"].astype(np.int64)
    g = bb % pplan.num_octets
    k = (bb // pplan.num_octets) % pplan.num_slabs
    t = bb // (pplan.num_octets * pplan.num_slabs)
    return t, k, g


def _test_plan():
    uvw, _ = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    return plan_packed(plan, uvw, block_v=128)


def _case(name):
    rng = np.random.default_rng(7)
    if name == "test_plan":
        return _indices(_test_plan())
    if name == "shuffled":
        t, k, g = _indices(_test_plan())
        perm = rng.permutation(len(t))
        return t[perm], k[perm], g[perm]
    if name == "one_bucket":
        n = 13
        return (np.full(n, 2), np.full(n, 1), np.full(n, 5))
    if name == "long_runs":
        # Runs of 1-12 blocks over a few buckets; a bucket may recur
        # after another one (two runs of one bucket).
        lengths = rng.integers(1, 13, 40)
        buckets = rng.integers(0, 6, 40)
        bb = np.repeat(buckets, lengths)
        return bb // 4, (bb // 2) % 2, bb % 2
    raise ValueError(name)


def _as_torch(*xs):
    return [torch.as_tensor(np.asarray(x, np.int32)) for x in xs]


def _check_runs(runs, t, k, g):
    """Coverage, bucket purity, maximality and order of a run table."""
    nb = len(t)
    key = np.stack([t, k, g], axis=1)
    seen = np.zeros(nb, np.int64)
    for first, count in runs:
        assert count >= 1
        seen[first:first + count] += 1
        assert (key[first:first + count] == key[first]).all()
        if first > 0:
            assert (key[first - 1] != key[first]).any()
        if first + count < nb:
            assert (key[first + count] != key[first]).any()
    assert (seen == 1).all()
    order = [(-c, f) for f, c in runs]
    assert order == sorted(order)


@pytest.mark.parametrize("case", ["test_plan", "shuffled", "one_bucket",
                                  "long_runs"])
def test_runs_match_numpy_reference(case):
    t, k, g = _case(case)
    got = tk.bucket_runs(*_as_torch(t, k, g))
    assert got.dtype == torch.int32 and tuple(got.shape[1:]) == (2,)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), runs_numpy(t, k, g))
    _check_runs(got.numpy(), t, k, g)
    lengths = got[:, 1].numpy()
    if case == "shuffled":
        assert (lengths == 1).mean() > 0.5
    if case == "one_bucket":
        np.testing.assert_array_equal(got.numpy(), [[0, 13]])
    if case == "long_runs":
        assert lengths.max() >= 8


def test_runs_of_no_blocks():
    got = tk.bucket_runs(*_as_torch([], [], []))
    assert tuple(got.shape) == (0, 2) and got.dtype == torch.int32


def test_bench_plan_runs():
    """bench.py's plan (auto block size): 2724 blocks of 512 in 1237 runs
    of 1-5 blocks (223 / 572 / 412 / 29 / 1), every bucket one run."""
    b = BENCH
    uvw = bench_uvw()
    plan = plan_wstack(uvw, C_0, C_0 / (100 * b["chans"]), b["chans"],
                       b["image"], b["subgrid"], b["theta"], b["w_step"],
                       support=8, w_support=4, w_tower_height=b["height"])
    pplan = plan_packed(plan, uvw)
    t, k, g = _indices(pplan)
    assert (pplan.block_v, pplan.num_blocks) == (512, 2724)
    runs = tk.bucket_runs(*_as_torch(t, k, g)).numpy()
    _check_runs(runs, t, k, g)
    np.testing.assert_array_equal(runs, runs_numpy(t, k, g))
    assert runs.shape[0] == 1237
    np.testing.assert_array_equal(np.bincount(runs[:, 1]),
                                  [0, 223, 572, 412, 29, 1])
    buckets = (t * pplan.num_slabs + k) * pplan.num_octets + g
    assert len(np.unique(buckets)) == runs.shape[0]


@pytest.mark.parametrize("mode", ["highest", "high", "bf16"])
def test_gridder_runs_and_cpu_wrappers(mode):
    """The packed gridder builds the run table once; on the CPU the
    wrappers take ``runs`` and return their plain versions' results,
    bit for bit."""
    pplan = _test_plan()
    kw = dict(fast=True) if mode == "bf16" else dict(precision=mode)
    gr = PackedGridder(pplan, device="cpu", **kw)
    t, k, g = _indices(pplan)
    np.testing.assert_array_equal(gr.runs.numpy(), runs_numpy(t, k, g))
    rng = np.random.default_rng(3)
    vre, vim = (torch.as_tensor(rng.standard_normal(pplan.total),
                                dtype=torch.float32) for _ in range(2))
    args = (gr.t_idx, gr.k_idx, gr.g_idx, gr.ubase, gr.vband,
            (gr.wk_t, vre, vim), len(pplan.tasks), pplan.num_layers, 128, 4)
    stack = tk.grid_packed_stack(*args, block_v=128, runs=gr.runs)
    assert torch.equal(stack, tk.grid_packed_stack_reference(
        *args, block_v=128))
    dargs = (stack, gr.t_idx, gr.k_idx, gr.g_idx, gr.ubase, gr.vband_t,
             gr.wk_t, 4)
    assert torch.equal(tk.degrid_stack(*dargs, block_v=128, runs=gr.runs),
                       tk.degrid_stack_reference(*dargs, block_v=128))
