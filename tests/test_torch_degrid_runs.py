"""The run tables of the window-gather degrid kernels (K4, K11, K13, K19).

``packed_tap.run_table`` cuts a plan's blocks into maximal runs of
consecutive blocks with one window key, optionally into parts of at most
``max_blocks`` blocks, longest first, padded with (0, 0) rows to one row
a block: fixed shapes, so the streaming engine builds a chunk's table on
the device without a host sync. The window keys are (t, k0, g) for the
stack forms (K4, K13), (p, g, hv) for the plane forms (K11, K19), and the
block's bucket in the streaming engine (the same windows). Held here, on
the CPU, against a NumPy walk on the ES-FFT test plans (2-D and 3-D),
the streaming test plan (its empty ``nonempty`` blocks included), the
packed test plan with its blocks shuffled (runs of one block), one bucket
and long runs: every block in exactly one row of count > 0, each run (or
part) maximal, longest first. The engines build the tables once (ES, the
packed engines) or once a chunk (streaming) and pass them; the wrappers'
CPU path takes ``runs`` and returns its plain version's result.
"""

import numpy as np
import pytest
import torch

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    es_scenario, make_inputs, two_point_image
from ska_sdp_func_torch.grid_data import GridderUvwEsFft
from ska_sdp_func_torch.kernels import band_tap as tb
from ska_sdp_func_torch.kernels import fused_tap as tf
from ska_sdp_func_torch.kernels import packed_tap as tk
from ska_sdp_func_torch.parallel import PackedGridder, StreamingDegridder, \
    plan_packed, plan_stream, plan_wstack, stream_tasks
from ska_sdp_func_torch.parallel import streaming


def table_numpy(keys, max_blocks=0):
    """Reference: walk the blocks, cut where the key changes (and every
    ``max_blocks`` blocks into a run), sort by length (descending), then
    first block; pad with (0, 0) rows to one row a block."""
    key = np.stack(keys, axis=1)
    nb = key.shape[0]
    rows, start, run0 = [], 0, 0
    for b in range(1, nb + 1):
        new_run = b == nb or (key[b] != key[b - 1]).any()
        if new_run or (max_blocks and (b - run0) % max_blocks == 0):
            rows.append((start, b - start))
            start = b
        if new_run:
            run0 = b
    rows.sort(key=lambda r: (-r[1], r[0]))
    rows += [(0, 0)] * (nb - len(rows))
    return np.asarray(rows, np.int32).reshape(-1, 2)


def check_table(table, keys, max_blocks=0):
    """Coverage, key purity, maximality (within ``max_blocks``) and order
    of a run table."""
    key = np.stack(keys, axis=1)
    nb = key.shape[0]
    assert table.shape == (nb, 2)
    seen = np.zeros(nb, np.int64)
    live = table[table[:, 1] > 0]
    assert (table[len(live):] == 0).all()
    for first, count in live:
        seen[first:first + count] += 1
        assert (key[first:first + count] == key[first]).all()
        if max_blocks:
            assert count <= max_blocks
        # A part starts a run or follows a full part of the same run.
        if first > 0 and (key[first - 1] == key[first]).all():
            assert max_blocks and (table[:, 0] == first - max_blocks).any()
        if first + count < nb and (key[first + count] == key[first]).all():
            assert max_blocks and count == max_blocks
    assert (seen == 1).all()
    order = [(-c, f) for f, c in live]
    assert order == sorted(order)


def _es_keys(ws):
    d = es_scenario()
    plan = GridderUvwEsFft(
        d["uvw"], d["freq"], d["vis"].astype(np.complex64), d["weight"],
        np.zeros((d["image_size"],) * 2, np.float32), d["pixel_size"],
        d["pixel_size"], 1e-5,
        *GridderUvwEsFft.get_w_range(d["uvw"], d["freq"]), ws, device="cpu")
    a = plan._packed.arrays
    return plan, (a["k_idx"], a["g_idx"], a["hv_idx"])


def _stream_plan(**kw):
    uvw, vis = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE,
                       **{**PARAMS, **kw})
    return plan_stream(plan, stream_tasks(plan, uvw), chunk_rows=64,
                       block_v=128, cap_slots=20480), uvw, vis


def _stream_keys():
    """The streaming test plan's first chunk: block -> bucket, and the
    blocks its ``nonempty`` marks 0 (the tail after the last bucket)."""
    sp, uvw, _ = _stream_plan()
    eng = streaming._stream_engine(sp, False, torch.device("cpu"))
    _, uvw32, mask = streaming._padded_chunk(sp, uvw[:64], "cpu")
    arrays, _, bb, *_ = eng._plan_chunk(uvw32, mask)
    return bb.numpy(), arrays["nonempty"].numpy()


def _packed_keys():
    uvw, _ = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    a = plan_packed(plan, uvw, block_v=128).arrays
    return a["block_bucket"].astype(np.int64)


def _case(name):
    rng = np.random.default_rng(9)
    if name in ("es_2d", "es_3d"):
        return _es_keys(name == "es_3d")[1]
    if name == "stream":
        bb, nonempty = _stream_keys()
        assert (nonempty == 0).any() and (nonempty != 0).any()
        return (bb,)
    if name == "shuffled":
        return (rng.permutation(_packed_keys()),)
    if name == "one_bucket":
        return (np.full(13, 4), np.full(13, 1), np.zeros(13))
    if name == "long_runs":
        lengths = rng.integers(1, 13, 40)
        bb = np.repeat(rng.integers(0, 6, 40), lengths)
        return (bb // 4, bb % 4)
    raise ValueError(name)


CASES = ["es_2d", "es_3d", "stream", "shuffled", "one_bucket", "long_runs"]


@pytest.mark.parametrize("max_blocks", [0, 1, 3])
@pytest.mark.parametrize("case", CASES)
def test_run_table_matches_numpy(case, max_blocks):
    keys = [np.asarray(k, np.int64) for k in _case(case)]
    got = tk.run_table([torch.as_tensor(k, dtype=torch.int32) for k in keys],
                       max_blocks)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), table_numpy(keys, max_blocks))
    check_table(got.numpy(), keys, max_blocks)
    live = got[got[:, 1] > 0].numpy()
    if case == "shuffled" and not max_blocks:
        assert (live[:, 1] == 1).mean() > 0.5
    if case == "one_bucket" and not max_blocks:
        np.testing.assert_array_equal(live, [[0, 13]])
    if case == "long_runs" and not max_blocks:
        assert live[:, 1].max() >= 8


def test_run_table_of_no_blocks():
    got = tk.run_table([torch.zeros(0, dtype=torch.int32)])
    assert tuple(got.shape) == (0, 2) and got.dtype == torch.int32
    assert tuple(tk.degrid_runs([torch.zeros(0, dtype=torch.int32)]).shape) \
        == (0, 2)


@pytest.mark.parametrize("nb,want", [(1, 1), (2112, 1), (2113, 2),
                                     (5735, 3), (8284, 4)])
def test_unit_blocks(nb, want):
    """About 16 parts an SM of an H100 (132 SMs off the card): the dense
    stream's 5735 blocks in parts of 3, the ES bench plan's 8284 in 4."""
    assert tk.unit_blocks(nb, "cpu") == want


def test_bucket_runs_is_the_trimmed_table():
    t, k = (torch.as_tensor(x, dtype=torch.int32)
            for x in _case("long_runs"))
    keys = (t, k, torch.zeros_like(t))
    table = tk.run_table(keys)
    runs = tk.bucket_runs(*keys)
    np.testing.assert_array_equal(runs.numpy(),
                                  table[:runs.shape[0]].numpy())
    assert (table[runs.shape[0]:, 1] == 0).all()


@pytest.mark.parametrize("ws", [False, True], ids=["2d", "3d"])
def test_es_plan_builds_degrid_runs_once(ws):
    """The ES plan attaches its degrid table once (parts of
    ``unit_blocks``); the CPU wrapper takes it and returns its plain
    version's result bit for bit."""
    plan, keys = _es_keys(ws)
    d = plan._packed.dev
    nb = keys[0].shape[0]
    np.testing.assert_array_equal(
        d["runs"].numpy(), table_numpy(keys, tk.unit_blocks(nb, "cpu")))
    ep = plan._packed
    planes = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, ep.num_w_grids, ep.rows_pad, ep.lanes_pad)), dtype=torch.float32)
    args = (planes, d["k_idx"], d["g_idx"], d["hv_idx"], d["u_off"],
            d["iv0"], d["uk"], d["vk"], d["kw_t"], ep.w_support, 256)
    got = tb.degrid_fused(*args, block_v=ep.block_v, raw=True,
                          runs=d["runs"])
    assert torch.equal(got, tb.degrid_fused_reference(
        *args, block_v=ep.block_v, raw=True))


@pytest.mark.parametrize("engine", ["fused", "compact"])
def test_packed_engines_build_degrid_runs_once(engine):
    uvw, _ = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    pplan = plan_packed(plan, uvw, block_v=128)
    g = PackedGridder(pplan, engine=engine, device="cpu")
    keys = (g.t_idx.numpy(), g.k_idx.numpy(), g.g_idx.numpy())
    np.testing.assert_array_equal(
        g.runs.numpy(),
        table_numpy(keys, tk.unit_blocks(pplan.num_blocks, "cpu")))
    check_table(g.runs.numpy(), keys,
                tk.unit_blocks(pplan.num_blocks, "cpu"))
    st = g._model_stack(torch.as_tensor(two_point_image()))
    want = g._dstage_kernel(st)
    if engine == "fused":
        got = tf.degrid_fused2_stack_reference(
            st, g.t_idx, g.k_idx, g.g_idx, g.pa, g.pb, g.uv_coeffs,
            g.w_coeffs, 8, 4, plan.oversampling, plan.w_oversampling,
            block_v=128, precision=g.precision, runs=g.runs)
    else:
        got = tf.degrid_compact_reference(
            st, g.t_idx, g.k_idx, g.g_idx, g.pa, g.uk_t, g.vk_t, g.wk_t, 8,
            4, block_v=128, runs=g.runs)
    assert torch.equal(got, want)


@pytest.mark.parametrize("geom", ["packable", "non_packable"])
def test_stream_predict_passes_chunk_runs(monkeypatch, geom):
    """Each predicted chunk hands its degrid kernel (K4, or K11 on the
    non-packable branch) the table of its block -> bucket map, built on
    the device: every block in one part, parts within one bucket."""
    kw = {} if geom == "packable" else dict(oversampling=65536)
    sp, uvw, _ = _stream_plan(**kw)
    mod, name = ((tf, "degrid_fused2_stack") if geom == "packable"
                 else (tb, "degrid_fused"))
    seen = []
    real = getattr(mod, name)

    def record(*args, **kwargs):
        seen.append((args, kwargs["runs"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(mod, name, record)
    sd = StreamingDegridder(sp, device="cpu").set_model(two_point_image())
    assert sd._engine.packable == (geom == "packable")
    for lo in range(0, uvw.shape[0], 64):
        sd.predict(uvw[lo:lo + 64])
    assert len(seen) == -(-uvw.shape[0] // 64)
    for args, runs in seen:
        if geom == "packable":
            t, k, g = (a.numpy().astype(np.int64) for a in args[1:4])
            bb = (t * sp.num_slabs + k) * sp.num_octets + g
        else:
            p, g = (a.numpy().astype(np.int64) for a in args[1:3])
            bb = p * sp.num_octets + g
        parts = tk.unit_blocks(sp.num_blocks, "cpu")
        np.testing.assert_array_equal(runs.numpy(),
                                      table_numpy((bb,), parts))
        check_table(runs.numpy(), (bb,), parts)
