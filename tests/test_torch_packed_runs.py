"""The run tables of the packed band kernels (K1/K2 on the card).

``packed_tap.bucket_runs`` cuts a plan's blocks into maximal runs of
consecutive blocks of one bucket (t, k0, g), longest first. Held here, on
the CPU, against a NumPy reference: every block in exactly one run, no
run crossing a bucket, each run maximal, in order. On bench.py's plan it
gives 1237 runs of 1-5 blocks; the test plan, its blocks shuffled (runs of
length 1), one bucket and long runs are handled.

The tensor-core kernels' work units are ``packed_tap.band_runs``: those
runs in parts of ``band_part_blocks`` blocks, longest first, so that the
kernels' static stride over one CTA an SM gives each SM about the same
blocks. On a core-heavy plan drawn like the SKA-Low AA4 array, whose
maximal runs leave the heaviest CTA over 5x the mean, the parts bring it
under 1.1x at each part floor. The wrappers' CPU path ignores ``runs``;
the packed gridder builds the table once and records ``runs_cut`` and
``unit_balance``.
"""

import math

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


def parts_numpy(t, k, g, part):
    """Reference band table: the maximal runs cut into parts of ``part``
    blocks from each run's start, longest first, then first block."""
    parts = []
    for first, count in runs_numpy(t, k, g):
        parts += [(b, min(part, first + count - b))
                  for b in range(first, first + count, part)]
    parts.sort(key=lambda r: (-r[1], r[0]))
    return np.asarray(parts, np.int32).reshape(-1, 2)


def balance_numpy(counts, ctas):
    """The heaviest CTA's blocks over the mean, CTA ``c`` taking rows
    ``c, c + ctas, ...`` (one 128-lane tile)."""
    ctas = min(ctas, len(counts))
    load = [sum(counts[c::ctas]) for c in range(ctas)]
    return max(load) / (sum(load) / ctas)


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


def clustered_uvw(core, outer, dumps, seed=5):
    """uvw [dumps * B, 3] of a core-heavy array drawn like SKA-Low's AA4:
    ``core`` stations in a 500 m disc, ``outer`` ones from 1.5 to 45 km out
    (log-uniform), a field at dec -27 deg seen from hour angle -1 h at
    latitude -26.8 deg, one dump after another."""
    rng = np.random.default_rng(seed)
    r = np.r_[500 * np.sqrt(rng.random(core)),
              1500 * 30.0 ** rng.random(outer)]
    ang = 2 * np.pi * rng.random(core + outer)
    i, j = np.triu_indices(core + outer, 1)
    east = (r * np.cos(ang))[j] - (r * np.cos(ang))[i]
    north = (r * np.sin(ang))[j] - (r * np.sin(ang))[i]
    lat, dec = math.radians(-26.8), math.radians(-27.0)
    x, y, z = -math.sin(lat) * north, east, math.cos(lat) * north
    sd, cd = math.sin(dec), math.cos(dec)
    out = []
    for d in range(dumps):
        ha = -math.pi / 12 + d * 1e-3
        sh, ch = math.sin(ha), math.cos(ha)
        out.append(np.stack([sh * x + ch * y,
                             -sd * ch * x + sd * sh * y + cd * z,
                             cd * ch * x - cd * sh * y + sd * z], axis=1))
    return np.concatenate(out)


def clustered_plan(core, outer, dumps, num_chan, block_v=128):
    """The packed plan of :func:`clustered_uvw` on a 512^2 facet (θ 0.002,
    sub-grid 128, w_step 100, support 8, w_support 4), 5.4 kHz channels
    from 299.79 MHz."""
    uvw = clustered_uvw(core, outer, dumps)
    plan = plan_wstack(uvw, C_0, C_0 / 55258.0, num_chan, 512, 128, 0.002,
                       100.0, support=8, w_support=4, w_tower_height=4.0)
    return plan_packed(plan, uvw, block_v=block_v)


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
    """The packed gridder builds the band table once; on the CPU the
    wrappers take ``runs`` and return their plain versions' results,
    bit for bit."""
    pplan = _test_plan()
    kw = dict(fast=True) if mode == "bf16" else dict(precision=mode)
    gr = PackedGridder(pplan, device="cpu", **kw).slots
    t, k, g = _indices(pplan)
    np.testing.assert_array_equal(gr.runs.numpy(), parts_numpy(
        t, k, g, tk.band_part_blocks(pplan.num_blocks, 128, "cpu")))
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


@pytest.fixture(scope="module")
def core_plan():
    """Four dumps of 96 stations (48 in the core) x 128 channels: 2.3M
    visibilities in 18,442 blocks of 128, the longest run 1925 blocks."""
    return clustered_plan(48, 48, 4, 128)


@pytest.mark.parametrize("floor", [512, 1024, 2048])
def test_band_runs_balance_a_core_heavy_plan(monkeypatch, core_plan, floor):
    """At each part floor (slots) the band table holds every block in one
    row of count > 0 inside one bucket, no row over its part size, longest
    first, equal to the NumPy reference; under the kernels' stride over
    132 CTAs the heaviest CTA has over 5x the mean's blocks with the
    maximal runs and under 1.1x with the parts."""
    monkeypatch.setattr(tk, "BAND_PART_SLOTS", floor)
    pplan = core_plan
    t, k, g = _indices(pplan)
    part = tk.band_part_blocks(pplan.num_blocks, pplan.block_v, "cpu")
    assert part == max(-(-pplan.num_blocks // (16 * 132)),
                       -(-floor // pplan.block_v))
    table = tk.band_runs(*_as_torch(t, k, g), pplan.block_v)
    assert tuple(table.shape) == (pplan.num_blocks, 2)
    runs = tk.live_runs(table).numpy()
    assert (table[runs.shape[0]:].numpy() == 0).all()
    np.testing.assert_array_equal(runs, parts_numpy(t, k, g, part))
    key = np.stack([t, k, g], axis=1)
    seen = np.zeros(pplan.num_blocks, np.int64)
    for first, count in runs:
        assert 1 <= count <= part
        assert (key[first:first + count] == key[first]).all()
        seen[first:first + count] += 1
    assert (seen == 1).all()
    assert (np.diff(runs[:, 1]) <= 0).all()
    maximal = runs_numpy(t, k, g)[:, 1]
    assert balance_numpy(maximal, 132) > 5
    assert balance_numpy(runs[:, 1], 132) < 1.1
    for counts in (maximal, runs[:, 1]):
        assert tk.stride_balance(counts, 128, 132) == pytest.approx(
            balance_numpy(counts, 132), rel=1e-12)


def test_stride_balance_counts_lane_tiles():
    """Units are (row, 128-lane tile): at 256 lanes a row's blocks go to
    two CTAs; fewer units than SMs take one CTA each."""
    assert tk.stride_balance([4, 2, 2], 256, 3) == pytest.approx(
        max(4 + 2, 4 + 2, 2 + 2) / (16 / 3))
    assert tk.stride_balance([4, 2], 128, 132) == pytest.approx(4 / 3)
    assert tk.stride_balance([], 128, 132) == 1.0


@pytest.mark.parametrize("floor", [256, 4096])
def test_gridder_records_runs_cut_and_balance(monkeypatch, floor):
    """The band engine's slots carry the table's ``runs_cut`` (bucket runs
    longer than a part) and ``unit_balance`` (under the stride of
    ``min(rows, 132)`` CTAs off the card), as a NumPy recount of its plan
    gives them; the other engines carry None."""
    monkeypatch.setattr(tk, "BAND_PART_SLOTS", floor)
    pplan = clustered_plan(24, 24, 1, 24)
    s = PackedGridder(pplan, device="cpu").slots
    t, k, g = _indices(pplan)
    part = max(-(-pplan.num_blocks // (16 * 132)), -(-floor // 128))
    np.testing.assert_array_equal(s.runs.numpy(), parts_numpy(t, k, g, part))
    lengths = runs_numpy(t, k, g)[:, 1]
    assert s.runs_cut == int((lengths > part).sum())
    assert (s.runs_cut > 0) == (floor == 256)
    assert s.unit_balance == pytest.approx(
        balance_numpy(s.runs[:, 1].numpy(), 132), rel=1e-12)
    fused = PackedGridder(pplan, device="cpu", engine="fused").slots
    assert fused.runs_cut is None and fused.unit_balance is None
