"""The port's device-planned streaming gridder/degridder against the JAX
package's, on the small scenario of tests/test_streaming.py (150 rows x 2
channels, 256^2 image, block_v 128, 20480-slot capacity).

Both packages plan the geometry in f32. XLA may contract a multiply-add
into one rounding where torch rounds each step, so a tap word (u_frac,
v_frac, w_row) may differ by one oversample bin: the plan test holds
task/bucket assignment, block tables, occupancy, counters and the
unsort map exactly equal and allows tap-word differences of one bin on
at most 5 % of the placed slots. Images and predictions compare at the
JAX streaming suite's envelope, 2e-4 of the interior peak (margin 32).

The non-packable branch (K6-K11) runs on two geometries, oversampling
65536 and 64-slot blocks, each held against the JAX engine's same
branch: plan fields, image (interior and taper-weighted), predictions
and counters.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    make_inputs, taper  # noqa: E402
from ska_sdp_func_torch.kernels import fused_tap as tf  # noqa: E402
from ska_sdp_func_torch.parallel import (  # noqa: E402
    StreamingDegridder,
    StreamingGridder,
    from_jax_plan,
    from_jax_stream_plan,
    packed_gridder,
    plan_packed,
    plan_stream,
    plan_wstack,
    stream_tasks,
)
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
    SdpRuntimeError,
)
from ska_sdp_func_tpu.parallel import (  # noqa: E402
    StreamingDegridder as JStreamingDegridder,
    StreamingGridder as JStreamingGridder,
    plan_stream as j_plan_stream,
    plan_wstack as j_plan_wstack,
    stream_tasks as j_stream_tasks,
)

CHUNK, CAP, M = 64, 20480, 32


def _model():
    """Bounded random model, border ring zeroed (test_streaming.py:230)."""
    model = np.random.default_rng(11).standard_normal(
        (IMAGE_SIZE, IMAGE_SIZE)).astype(np.float32)
    model[:M], model[-M:], model[:, :M], model[:, -M:] = 0, 0, 0, 0
    return model


def _chunks(rows):
    return [(lo, min(rows, lo + CHUNK)) for lo in range(0, rows, CHUNK)]


@pytest.fixture(scope="module")
def scenario():
    uvw, vis = make_inputs()
    jplan = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    jboxes = j_stream_tasks(jplan, uvw)
    jsp = j_plan_stream(jplan, jboxes, chunk_rows=CHUNK, block_v=128,
                        cap_slots=CAP)
    plan = from_jax_plan(jplan)
    sp = plan_stream(plan, stream_tasks(plan, uvw), chunk_rows=CHUNK,
                     block_v=128, cap_slots=CAP)
    rows = uvw.shape[0]
    jsg = JStreamingGridder(jsp)
    for lo, hi in _chunks(rows):
        jsg.accumulate(uvw[lo:hi], vis[lo:hi])
    jsd = JStreamingDegridder(jsp).set_model(_model())
    j_pred = np.concatenate([np.asarray(jsd.predict(uvw[lo:hi]))
                             for lo, hi in _chunks(rows)])
    return dict(uvw=uvw, vis=vis, jplan=jplan, jboxes=jboxes, jsp=jsp,
                plan=plan, sp=sp, rows=rows,
                j_img=np.asarray(jsg.finalize()), j_pred=j_pred,
                j_counts=[int(x) for x in jsg.counters()])


def _interior_err(got, want):
    g, w = got[M:-M, M:-M], want[M:-M, M:-M]
    return np.abs(g - w).max() / np.abs(w).max()


def _grid(sp, uvw, vis, chunks, weights=None):
    sg = StreamingGridder(sp, device="cpu")
    for lo, hi in chunks:
        sg.accumulate(uvw[lo:hi], vis[lo:hi],
                      None if weights is None else weights[lo:hi])
    return sg


def test_stream_tasks_matches_jax(scenario):
    np.testing.assert_array_equal(
        stream_tasks(scenario["plan"], scenario["uvw"]), scenario["jboxes"])


def test_plan_stream_matches_jax(scenario):
    sp, jsp = scenario["sp"], scenario["jsp"]
    carried = from_jax_stream_plan(jsp)
    assert sp == carried and hash(sp) == hash(carried)
    for name in ("chunk_rows", "block_v", "cap", "num_layers", "num_slabs",
                 "num_octets", "num_buckets", "num_blocks"):
        assert getattr(sp, name) == getattr(jsp, name), name
    assert [tuple(vars(t).values()) for t in sp.tasks] == \
        [tuple(vars(t).values()) for t in jsp.tasks]
    assert set(sp.consts) == set(jsp.consts)
    for name, want in jsp.consts.items():
        for got in (sp.consts[name], carried.consts[name]):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    # Default capacity: rounded to lcm(block_v, 1024) as in JAX.
    a = plan_stream(scenario["plan"], scenario["jboxes"],
                    chunk_rows=100, block_v=384, cap_factor=1.3)
    b = j_plan_stream(scenario["jplan"], scenario["jboxes"],
                      chunk_rows=100, block_v=384, cap_factor=1.3)
    assert a.cap == b.cap


@pytest.mark.parametrize("lo,hi", [(0, 64), (128, 150)])
def test_device_plan_matches_jax(scenario, lo, hi):
    """The per-chunk device plan: identical assignment, tables, counters
    and unsort map; tap words within one bin on <= 5 % of slots."""
    s = scenario
    uvw32 = np.zeros((CHUNK, 3), np.float32)
    uvw32[:hi - lo] = s["uvw"][lo:hi]
    mask = np.arange(CHUNK) < hi - lo
    vis = np.zeros((CHUNK, NUM_CHAN), np.complex64)
    vis[:hi - lo] = s["vis"][lo:hi]
    vre, vim = vis.real.copy(), vis.imag.copy()
    jeng = JStreamingGridder(s["jsp"])._engine
    (ja, jdest, jbb, jvis, jproc, jdrop, jover) = jeng._plan_chunk(
        jnp.asarray(uvw32), jnp.asarray(mask), jnp.asarray(vre),
        jnp.asarray(vim))
    eng = StreamingGridder(s["sp"], device="cpu")._engine
    (ta, tdest, tbb, tvis, tproc, tdrop, tover) = eng._plan_chunk(
        torch.as_tensor(uvw32), torch.as_tensor(mask),
        torch.as_tensor(vre), torch.as_tensor(vim))
    np.testing.assert_array_equal(tbb.numpy(), np.asarray(jbb))
    np.testing.assert_array_equal(ta["nonempty"].numpy(),
                                  np.asarray(ja["nonempty"]))
    np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    assert (int(tproc), int(tdrop), bool(tover)) == \
        (int(jproc), int(jdrop), bool(jover))
    assert int(tproc) == (hi - lo) * NUM_CHAN and not bool(tover)
    for name in ("vre", "vim"):
        np.testing.assert_array_equal(ta[name].numpy(), np.asarray(ja[name]))
    got = tf.unpack_plan_words(ta["packed_a"], ta["packed_b"])
    want = tf.unpack_plan_words(torch.as_tensor(np.array(ja["packed_a"])),
                                torch.as_tensor(np.array(ja["packed_b"])))
    fields = ("iv0", "u_off", "w_row", "u_frac", "v_frac", "valid")
    for name, g, w in zip(fields, got, want):
        if name in ("iv0", "u_off", "valid"):
            assert torch.equal(g, w), name
        else:
            diff = (g - w).abs()
            assert int(diff.max()) <= 1, name
            assert int((diff > 0).sum()) <= 0.05 * int(got[5].sum()), name


def test_streaming_gridder_matches_jax(scenario):
    s = scenario
    sg = _grid(s["sp"], s["uvw"], s["vis"], _chunks(s["rows"]))
    img = sg.finalize()
    assert img.dtype == torch.float32 and img.shape == (IMAGE_SIZE,
                                                         IMAGE_SIZE)
    assert _interior_err(img.numpy(), s["j_img"]) < 2e-4
    # With identical tap words here, also taper-weighted at 1e-5.
    t = taper(s["jplan"])
    assert np.abs((img.numpy() - s["j_img"]) * t).max() \
        <= 1e-5 * np.abs(s["j_img"] * t).max()
    assert [int(x) for x in sg.counters()] == s["j_counts"] == [
        s["rows"] * NUM_CHAN, 0, 0]


def test_streaming_matches_packed_interior(scenario):
    """Device-planned streaming == the port's host-planned packed path
    at "highest" on the interior (test_streaming.py:74-100)."""
    s = scenario
    g = packed_gridder(plan_packed(s["plan"], s["uvw"], block_v=128),
                       precision="highest", device="cpu")
    img_ref = g.grid(s["vis"]).numpy()
    img = _grid(s["sp"], s["uvw"], s["vis"],
                _chunks(s["rows"])).finalize().numpy()
    assert _interior_err(img, img_ref) < 2e-4


def test_streaming_chunking_invariance(scenario):
    """One chunk == three chunks (gridding is linear)."""
    s = scenario
    rows = s["rows"]
    sp1 = plan_stream(s["plan"], s["jboxes"],
                      chunk_rows=rows, block_v=128, cap_slots=40960)
    img1 = _grid(sp1, s["uvw"], s["vis"], [(0, rows)]).finalize().numpy()
    img3 = _grid(s["sp"], s["uvw"], s["vis"],
                 _chunks(rows)).finalize().numpy()
    assert _interior_err(img3, img1) < 2e-4


def test_streaming_weights(scenario):
    s = scenario
    rows = 8
    wgt = np.full((rows, NUM_CHAN), 0.5, np.float32)
    img_w = _grid(s["sp"], s["uvw"], s["vis"], [(0, rows)],
                  weights=wgt).finalize().numpy()
    img = _grid(s["sp"], s["uvw"], 0.5 * s["vis"],
                [(0, rows)]).finalize().numpy()
    np.testing.assert_allclose(img_w, img, rtol=0,
                               atol=1e-6 * max(np.abs(img).max(), 1e-9))


def test_streaming_counts_dropped_and_raises(scenario):
    s = scenario
    sg = StreamingGridder(s["sp"], device="cpu")
    uvw_bad = s["uvw"][:8].copy()
    uvw_bad[0, 0] *= 50.0     # far outside the task boxes
    sg.accumulate(uvw_bad, s["vis"][:8])
    assert int(sg.counters()[1]) == NUM_CHAN
    with pytest.raises(SdpRuntimeError, match="outside the task set"):
        sg.finalize()


def test_streaming_overflow_voids_chunk(scenario):
    """A chunk beyond the capacity contributes nothing and finalize
    raises; never a truncated image."""
    s = scenario
    rows = s["rows"]
    sp = plan_stream(s["plan"], s["jboxes"], chunk_rows=rows, block_v=128,
                     cap_slots=256)
    assert sp.cap == 1024
    sg = StreamingGridder(sp, device="cpu")
    sg.accumulate(s["uvw"], s["vis"])
    processed, dropped, voided = (int(x) for x in sg.counters())
    assert (processed, dropped, voided) == (0, 0, 1)
    assert float(sg.image.abs().max()) == 0.0
    with pytest.raises(SdpRuntimeError, match="capacity"):
        sg.finalize()
    sd = StreamingDegridder(sp, device="cpu").set_model(_model())
    assert not sd.predict(s["uvw"]).abs().max() > 0
    with pytest.raises(SdpRuntimeError, match="capacity"):
        sd.check()


def test_streaming_rejects_bad_shapes(scenario):
    s = scenario
    sp = plan_stream(s["plan"], s["jboxes"], chunk_rows=16, block_v=128,
                     cap_slots=20000)
    sg = StreamingGridder(sp, device="cpu")
    with pytest.raises(SdpInvalidArgumentError):
        sg.accumulate(s["uvw"][:32], s["vis"][:32])     # > chunk_rows
    with pytest.raises(SdpInvalidArgumentError):
        sg.accumulate(s["uvw"][:8, :2], s["vis"][:8])   # uvw not [R, 3]
    with pytest.raises(SdpInvalidArgumentError):
        sg.accumulate(s["uvw"][:8], s["vis"][:7])       # row mismatch
    with pytest.raises(SdpInvalidArgumentError):
        plan_stream(s["plan"], np.zeros((0, 3)), chunk_rows=16)
    with pytest.raises(SdpInvalidArgumentError):
        plan_stream(s["plan"], s["jboxes"], chunk_rows=0)
    with pytest.raises(SdpInvalidArgumentError):
        StreamingDegridder(sp, device="cpu").set_model(
            np.zeros((8, 8), np.float32))
    sg.finalize(check=False)
    with pytest.raises(SdpRuntimeError, match="finalized"):
        sg.accumulate(s["uvw"][:8], s["vis"][:8])


def test_streaming_degridder_matches_jax(scenario):
    s = scenario
    sd = StreamingDegridder(s["sp"], device="cpu").set_model(_model())
    pred = torch.cat([sd.predict(s["uvw"][lo:hi])
                      for lo, hi in _chunks(s["rows"])]).numpy()
    sd.check()
    assert pred.dtype == np.complex64
    assert pred.shape == (s["rows"], NUM_CHAN)
    np.testing.assert_allclose(pred, s["j_pred"],
                               atol=2e-4 * np.abs(s["j_pred"]).max())
    # And the port's own host-planned packed degrid.
    g = packed_gridder(plan_packed(s["plan"], s["uvw"], block_v=128),
                       precision="highest", device="cpu")
    ref = g.degrid(_model()).numpy()
    np.testing.assert_allclose(pred, ref, atol=2e-4 * np.abs(ref).max())


def test_streaming_predict_dropped_raises(scenario):
    s = scenario
    sd = StreamingDegridder(s["sp"], device="cpu").set_model(
        np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32))
    uvw_bad = s["uvw"][:4].copy()
    uvw_bad[1, 1] *= 50.0
    assert tuple(sd.predict(uvw_bad).shape) == (4, NUM_CHAN)
    with pytest.raises(SdpRuntimeError, match="outside the task set"):
        sd.check()
    with pytest.raises(SdpRuntimeError, match="set_model"):
        StreamingDegridder(s["sp"], device="cpu").predict(s["uvw"][:4])


def test_box_membership_fma_hull():
    """Visibilities within a few ulps of a box edge land in a planned box
    (test_streaming.py:391-434): finalize raises on any drop."""
    probe = plan_wstack(np.asarray([[1.0, 1.0, 1.0]]), FREQ0, 10.0, 1,
                        IMAGE_SIZE, **PARAMS)
    d = float(probe.eff_sg_dist)
    us = []
    for k in (-2, -1, 0, 1, 2):
        lo = hi = edge = np.float32((k - 0.5) * d)
        us.append(edge)
        for _ in range(8):
            lo = np.nextafter(lo, np.float32(-np.inf))
            hi = np.nextafter(hi, np.float32(np.inf))
            us.extend((lo, hi))
    us = np.asarray(us, np.float64)
    uvw = np.zeros((us.shape[0], 3))
    uvw[:, 0], uvw[:, 1] = us, us[::-1]
    plan = plan_wstack(uvw, FREQ0, 10.0, 1, IMAGE_SIZE, **PARAMS)
    sp = plan_stream(plan, stream_tasks(plan, uvw), chunk_rows=len(us),
                     block_v=128, cap_slots=81920)
    sg = StreamingGridder(sp, device="cpu")
    sg.accumulate(uvw, np.ones((len(us), 1), np.complex64))
    sg.finalize(check=True)
    assert [int(x) for x in sg.counters()] == [len(us), 0, 0]


@pytest.mark.parametrize("case", ["mesh", "oversampling", "block_v"])
def test_unported_options_raise(scenario, case):
    """What the port does not run raises, naming its ROADMAP item:
    ``mesh=`` (item 15). ``fast=True`` on a non-packable plan (an
    oversampling beyond the plan words, or a block_v that is not a
    multiple of 128) builds the non-packable engine in its bf16 mode
    (held against JAX in tests/test_torch_streaming_fast.py); without
    ``fast`` those plans take the same branch in f32 (the
    ``non_packable`` tests below)."""
    s = scenario
    if case == "mesh":
        with pytest.raises(NotImplementedError, match="item 15"):
            StreamingGridder(s["sp"], mesh=object(), device="cpu")
        with pytest.raises(NotImplementedError, match="item 15"):
            StreamingDegridder(s["sp"], mesh=object(),
                               device="cpu")
        return
    plan = s["plan"]
    if case == "oversampling":
        plan = plan_wstack(s["uvw"], FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE,
                           **{**PARAMS, "oversampling": 65536})
    sp = plan_stream(plan, s["jboxes"], chunk_rows=CHUNK,
                     block_v=64 if case == "block_v" else 128,
                     cap_slots=CAP)
    for cls in (StreamingGridder, StreamingDegridder):
        assert not cls(sp, device="cpu")._engine.packable
        eng = cls(sp, fast=True, device="cpu")._engine
        assert not eng.packable and eng.precision == "bf16"
    assert StreamingGridder(s["sp"], fast=True, device="cpu")._engine.packable


# -- the non-packable branch (K6, K7, K8, K9/K10 fold, K11) -------------------

# Geometry -> (oversampling, block_v): plan fields beyond the packed words
# (the JAX suite's case, tests/test_streaming.py:437-470), and 64-slot
# blocks.
NON_PACKABLE = {"oversampling": (65536, 128), "block_v": (16384, 64)}


@pytest.fixture(scope="module", params=list(NON_PACKABLE))
def non_packable(request, scenario):
    """The JAX engine's non-packable branch on the scenario, once per
    geometry: three grid chunks and three predict chunks."""
    s = scenario
    ov, bv = NON_PACKABLE[request.param]
    jplan = s["jplan"]
    if ov != PARAMS["oversampling"]:
        jplan = j_plan_wstack(s["uvw"], FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE,
                              **{**PARAMS, "oversampling": ov})
    jsp = j_plan_stream(jplan, s["jboxes"], chunk_rows=CHUNK, block_v=bv,
                        cap_slots=CAP)
    plan = from_jax_plan(jplan)
    sp = plan_stream(plan, s["jboxes"], chunk_rows=CHUNK, block_v=bv,
                     cap_slots=CAP)
    jsg = JStreamingGridder(jsp)
    assert not jsg._engine._pack
    for lo, hi in _chunks(s["rows"]):
        jsg.accumulate(s["uvw"][lo:hi], s["vis"][lo:hi])
    jsd = JStreamingDegridder(jsp).set_model(_model())
    j_pred = np.concatenate([np.asarray(jsd.predict(s["uvw"][lo:hi]))
                             for lo, hi in _chunks(s["rows"])])
    return dict(jplan=jplan, jsp=jsp, plan=plan, sp=sp,
                j_img=np.asarray(jsg.finalize()), j_pred=j_pred,
                j_counts=[int(x) for x in jsg.counters()],
                jd_counts=[int(x) for x in jsd.counters()])


@pytest.mark.parametrize("lo,hi", [(0, 64), (128, 150)])
def test_non_packable_device_plan_matches_jax(scenario, non_packable, lo,
                                              hi):
    """The placed fields, slot mask, tables, counters and unsort map of
    the non-packable plan equal JAX's; tap fields within one bin on <= 5 %
    of the valid slots."""
    s, n = scenario, non_packable
    uvw32 = np.zeros((CHUNK, 3), np.float32)
    uvw32[:hi - lo] = s["uvw"][lo:hi]
    mask = np.arange(CHUNK) < hi - lo
    vis = np.zeros((CHUNK, NUM_CHAN), np.complex64)
    vis[:hi - lo] = s["vis"][lo:hi]
    vre, vim = vis.real.copy(), vis.imag.copy()
    (ja, jdest, jbb, jvis, jproc, jdrop, jover) = JStreamingGridder(
        n["jsp"])._engine._plan_chunk(jnp.asarray(uvw32), jnp.asarray(mask),
                                      jnp.asarray(vre), jnp.asarray(vim))
    (ta, tdest, tbb, tvis, tproc, tdrop, tover) = StreamingGridder(
        n["sp"], device="cpu")._engine._plan_chunk(
            torch.as_tensor(uvw32), torch.as_tensor(mask),
            torch.as_tensor(vre), torch.as_tensor(vim))
    np.testing.assert_array_equal(tbb.numpy(), np.asarray(jbb))
    np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    assert (int(tproc), int(tdrop), bool(tover)) == \
        (int(jproc), int(jdrop), bool(jover))
    assert int(tproc) == (hi - lo) * NUM_CHAN and not bool(tover)
    valid = ta["valid"].numpy()
    assert int(valid.sum()) == int(tproc)
    for name in ("valid", "u_off", "iv0", "vre", "vim"):
        np.testing.assert_array_equal(ta[name].numpy(), np.asarray(ja[name]),
                                      err_msg=name)
    for name in ("u_frac", "v_frac", "w_row"):
        diff = np.abs(ta[name].numpy() - np.asarray(ja[name]))
        assert diff.max() <= 1, name
        assert (diff > 0).sum() <= 0.05 * valid.sum(), name


def test_non_packable_gridder_matches_jax(scenario, non_packable):
    s, n = scenario, non_packable
    sg = _grid(n["sp"], s["uvw"], s["vis"], _chunks(s["rows"]))
    assert not sg._engine.packable
    img = sg.finalize().numpy()
    assert img.dtype == np.float32 and img.shape == (IMAGE_SIZE, IMAGE_SIZE)
    assert _interior_err(img, n["j_img"]) < 2e-4
    t = taper(n["jplan"])
    assert np.abs((img - n["j_img"]) * t).max() \
        <= 1e-5 * np.abs(n["j_img"] * t).max()
    assert [int(x) for x in sg.counters()] == n["j_counts"] == [
        s["rows"] * NUM_CHAN, 0, 0]


def test_non_packable_degridder_matches_jax(scenario, non_packable):
    s, n = scenario, non_packable
    sd = StreamingDegridder(n["sp"], device="cpu").set_model(_model())
    pred = torch.cat([sd.predict(s["uvw"][lo:hi])
                      for lo, hi in _chunks(s["rows"])]).numpy()
    sd.check()
    assert pred.dtype == np.complex64 and pred.shape == (s["rows"], NUM_CHAN)
    np.testing.assert_allclose(pred, n["j_pred"],
                               atol=2e-4 * np.abs(n["j_pred"]).max())
    assert [int(x) for x in sd.counters()] == n["jd_counts"] == [
        s["rows"] * NUM_CHAN, 0, 0]


def test_non_packable_matches_packed_interior(scenario, non_packable):
    """The non-packable stream against the port's host-planned packed
    path at "highest" on the same plan (test_streaming.py:437-470): image
    interior at 2e-4, predictions at 2e-4 of their peak."""
    s, n = scenario, non_packable
    g = packed_gridder(plan_packed(n["plan"], s["uvw"], block_v=128),
                       precision="highest", device="cpu")
    img = _grid(n["sp"], s["uvw"], s["vis"],
                _chunks(s["rows"])).finalize().numpy()
    assert _interior_err(img, g.grid(s["vis"]).numpy()) < 2e-4
    sd = StreamingDegridder(n["sp"], device="cpu").set_model(_model())
    pred = sd.predict(s["uvw"][:CHUNK]).numpy()
    ref = g.degrid(_model()).numpy()[:CHUNK]
    np.testing.assert_allclose(pred, ref, atol=2e-4 * np.abs(ref).max())


def test_non_packable_overflow_voids_chunk(scenario):
    """An overflowed non-packable chunk places nothing, contributes
    nothing, and finalize/check raise."""
    s = scenario
    rows = s["rows"]
    sp = plan_stream(s["plan"], s["jboxes"], chunk_rows=rows, block_v=64,
                     cap_slots=256)
    sg = StreamingGridder(sp, device="cpu")
    eng = sg._engine
    assert not eng.packable
    uvw32, mask = torch.as_tensor(s["uvw"], dtype=torch.float32), \
        torch.ones(rows, dtype=torch.bool)
    arrays, *_, overflow = eng._plan_chunk(uvw32, mask)
    assert bool(overflow) and not bool(arrays["valid"].any())
    assert all(not bool(arrays[k].any())
               for k in ("u_off", "iv0", "u_frac", "v_frac", "w_row"))
    sg.accumulate(s["uvw"], s["vis"])
    assert [int(x) for x in sg.counters()] == [0, 0, 1]
    assert float(sg.image.abs().max()) == 0.0
    with pytest.raises(SdpRuntimeError, match="capacity"):
        sg.finalize()
    sd = StreamingDegridder(sp, device="cpu").set_model(_model())
    assert not sd.predict(s["uvw"]).abs().max() > 0
    with pytest.raises(SdpRuntimeError, match="capacity"):
        sd.check()
