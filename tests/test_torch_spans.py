"""The port's program spans (``utility.profiling.annotate`` / ``spans``),
where the drivers, the tower stages and the planners open them, and the
benchmark's reading of them on a device trace's clock
(``port_bench/metrics/_spans.py``), on the CPU at tiny sizes.
"""

import itertools
import json
import threading
import tracemalloc

import pytest
import torch

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    make_inputs, two_point_image
from port_bench.metrics import _spans
from ska_sdp_func_torch.grid_data import wstack as tws
from ska_sdp_func_torch.parallel import plan_packed, plan_wstack
from ska_sdp_func_torch.parallel import streaming as tstream
from ska_sdp_func_torch.parallel.packed import PackedGridder
from ska_sdp_func_torch.utility import profiling
from ska_sdp_func_torch.utility.profiling import (
    SpanRecord,
    annotate,
    annotated,
    self_ns,
    spans,
)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the drivers' many small CPU operations slow
    down under several threads a worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(records):
    """[(name, parent's name, root's name)] in the order the spans
    opened."""
    by_id = {r.id: r for r in records}
    return [(r.name, by_id[r.parent].name if r.parent is not None else None,
             by_id[r.root].name) for r in records]


# -- the facility ------------------------------------------------------------

def test_spans_off_share_one_null_object_and_record_nothing():
    a, b = annotate("a"), annotate("b", vis=3)
    assert a is b is profiling._NULL
    with a as got:
        assert got is None
    with spans() as rec:
        pass
    assert rec.records == [] and profiling._recorder is None


def test_spans_off_read_no_clock_allocate_nothing_and_open_no_region(
        monkeypatch):
    def refuse(*_):
        raise AssertionError("called while spans are off")

    monkeypatch.setattr(profiling, "_clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    vis = 12_345_678

    def peak(count):
        """Bytes allocated at most while ``count`` spans open and
        close."""
        loop = itertools.repeat(None, count)
        tracemalloc.start()
        try:
            base = tracemalloc.get_traced_memory()[0]
            for _ in loop:
                with annotate("stream.accumulate", vis=vis):
                    pass
            return tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()

    # Nothing a span: two thousand spans peak no higher than ten.
    assert peak(2_000) <= peak(10) < 1024
    # Under a profiler, an off span leaves no event.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("off-region"):
            pass
    assert not [e for e in prof.events() if e.name == "off-region"]


def test_spans_on_nest_with_parent_root_and_self_time(monkeypatch):
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    with spans() as rec:
        with annotate("a"):
            with annotate("b"):
                pass
            with annotate("c", vis=7) as c:
                with annotate("d"):
                    pass
        with annotate("e"):
            pass
    assert annotate("after") is profiling._NULL
    assert _tree(rec.records) == [("a", None, "a"), ("b", "a", "a"),
                                  ("c", "a", "a"), ("d", "c", "a"),
                                  ("e", None, "e")]
    assert [r.id for r in rec.records] == [0, 1, 2, 3, 4]
    assert c is rec.records[2] and c.vis == 7
    dur = {r.name: r.duration_ns for r in rec.records}
    assert dur == {"a": 70, "b": 10, "c": 30, "d": 10, "e": 10}
    own = self_ns(rec.records)
    assert own == {0: 70 - 10 - 30, 1: 10, 2: 30 - 10, 3: 10, 4: 10}
    # Self time among a subset counts only the children it holds.
    assert self_ns(rec.records[2:3]) == {2: 30}


def test_annotated_off_calls_through_and_on_records_the_call(monkeypatch):
    """The decorator form: off, the function runs with nothing read or
    opened; on, each call is one span whose ``vis`` is counted from the
    call's arguments after it returns, and a raising call still closes
    its span and counts nothing."""
    counted = []

    def count(x, y=0):
        counted.append((x, y))
        return 10 * x

    @annotated("outer", vis=count)
    def outer(x, y=0):
        """Doc."""
        with annotate("inner"):
            if x < 0:
                raise ValueError("negative")
        return x + y

    assert outer.__name__ == "outer" and outer.__doc__ == "Doc."

    def refuse(*_):
        raise AssertionError("called while spans are off")

    with monkeypatch.context() as m:
        m.setattr(profiling, "_clock", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        assert outer(2, y=3) == 5
    assert counted == []
    with spans() as rec:
        assert outer(4, y=1) == 5
        with pytest.raises(ValueError):
            outer(-1)
    assert _tree(rec.records) == [("outer", None, "outer"),
                                  ("inner", "outer", "outer"),
                                  ("outer", None, "outer"),
                                  ("inner", "outer", "outer")]
    assert counted == [(4, 1)]
    assert [r.vis for r in rec.records] == [40, None, None, None]
    assert all(r.end_ns >= r.start_ns > 0 for r in rec.records)


def test_spans_record_only_the_opening_thread_and_nested_blocks():
    with spans() as outer:
        seen = []
        t = threading.Thread(target=lambda: seen.append(annotate("x")))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen[0] is profiling._NULL
        with annotate("outer"):
            with spans() as inner:
                with annotate("inner"):
                    pass
        with annotate("again"):
            pass
    assert [r.name for r in outer.records] == ["outer", "again"]
    assert [(r.name, r.parent) for r in inner.records] == [("inner", None)]


def test_trace_region_is_a_span(tmp_path):
    """trace() turns spans on: an annotated region is a record_function
    event in the Chrome trace."""
    with profiling.trace(str(tmp_path)):
        assert profiling._recorder is not None
        with annotate("port-span"):
            torch.ones(8).sum()
    assert profiling._recorder is None
    (name,) = list(tmp_path.iterdir())
    events = json.loads(name.read_text())["traceEvents"]
    assert any(e.get("name") == "port-span" for e in events)


# -- where the port opens them ---------------------------------------------

@pytest.fixture(scope="module")
def scenario():
    uvw, vis = make_inputs()
    return uvw, vis


def test_packed_flow_span_tree(scenario):
    uvw, vis = scenario
    with spans() as rec:
        plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE,
                           **PARAMS)
        g = PackedGridder(plan_packed(plan, uvw), device="cpu")
        vre, vim = g.sort(vis)
        g.grid_sorted(vre, vim)
        g.degrid_sorted(two_point_image())
    assert _tree(rec.records) == [
        ("plan.wstack", None, "plan.wstack"),
        ("plan.packed", None, "plan.packed"),
        ("packed.build", None, "packed.build"),
        ("packed.sort", None, "packed.sort"),
        ("packed.build", "packed.sort", "packed.sort"),
        ("packed.grid_sorted", None, "packed.grid_sorted"),
        ("packed.grid_kernel", "packed.grid_sorted", "packed.grid_sorted"),
        ("tower.layers", "packed.grid_sorted", "packed.grid_sorted"),
        ("tower.ladder", "packed.grid_sorted", "packed.grid_sorted"),
        ("tower.planes", "packed.grid_sorted", "packed.grid_sorted"),
        ("tower.image", "packed.grid_sorted", "packed.grid_sorted"),
        ("packed.degrid_sorted", None, "packed.degrid_sorted"),
        ("tower.dplanes", "packed.degrid_sorted", "packed.degrid_sorted"),
        ("tower.dlayers", "packed.degrid_sorted", "packed.degrid_sorted"),
        ("packed.degrid_kernel", "packed.degrid_sorted",
         "packed.degrid_sorted")]
    grid, degrid = (r for r in rec.records if r.vis is not None)
    assert grid.vis == degrid.vis == uvw.shape[0] * NUM_CHAN


def test_stream_flow_span_tree(scenario):
    uvw, vis = scenario
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    tstream._stream_engine.cache_clear()
    with spans() as rec:
        sp = tstream.plan_stream(plan, tstream.stream_tasks(plan, uvw),
                                 chunk_rows=64, block_v=128, cap_factor=64)
        sg = tstream.StreamingGridder(sp, device="cpu")
        sg.accumulate(uvw[:50], vis[:50])
        sg.finalize()
        sd = tstream.StreamingDegridder(sp, device="cpu")
        sd.set_model(two_point_image())
        sd.predict(uvw[:50])
        sd.check()
    acc, pred = "stream.accumulate", "stream.predict"
    assert _tree(rec.records) == [
        ("plan.stream_tasks", None, "plan.stream_tasks"),
        ("plan.stream", None, "plan.stream"),
        ("stream.engine", None, "stream.engine"),
        (acc, None, acc),
        ("stream.plan", acc, acc),
        ("stream.grid", acc, acc),
        ("tower.layers", acc, acc),
        ("tower.ladder", acc, acc),
        ("tower.planes", acc, acc),
        ("tower.image", acc, acc),
        ("stream.finalize", None, "stream.finalize"),
        ("stream.set_model", None, "stream.set_model"),
        ("tower.dplanes", "stream.set_model", "stream.set_model"),
        ("tower.dlayers", "stream.set_model", "stream.set_model"),
        (pred, None, pred),
        ("stream.plan", pred, pred),
        ("stream.degrid", pred, pred),
        ("stream.check", None, "stream.check")]
    assert [r.vis for r in rec.records if r.vis is not None] == \
        [50 * NUM_CHAN] * 2


@pytest.mark.parametrize("direction", ["grid", "degrid"])
def test_wstack_reference_timers_only_when_verbose(scenario, monkeypatch,
                                                    direction):
    """The reference w-stacking drivers build their Timers only at
    verbosity > 0, and then report the same stages."""
    uvw, vis = scenario
    args = dict(freq0_hz=FREQ0, dfreq_hz=DFREQ, uvw=torch.tensor(uvw),
                **PARAMS, device="cpu")
    if direction == "grid":
        def call(verbosity):
            return tws.wstack_wtower_grid_all(
                torch.tensor(vis), image=torch.zeros(
                    (IMAGE_SIZE, IMAGE_SIZE), dtype=torch.complex64),
                verbosity=verbosity, **args)
        stages = ["Gridding", "Process sub-grid stack", "FFT(grid)",
                  "Grid correct"]
    else:
        def call(verbosity):
            return tws.wstack_wtower_degrid_all(
                torch.tensor(two_point_image()), vis=torch.zeros(
                    vis.shape, dtype=torch.complex64),
                verbosity=verbosity, **args)
        stages = ["Degridding", "Degrid correct", "FFT(grid)",
                  "Process sub-grid stack"]
    timers = tws.Timers
    lines = []
    monkeypatch.setattr(tws, "log_info",
                        lambda msg, *a: lines.append(msg % a if a else msg))

    def refuse(*_):
        raise AssertionError("Timers built at verbosity 0")

    monkeypatch.setattr(tws, "Timers", refuse)
    quiet = call(0)
    assert lines == []
    monkeypatch.setattr(tws, "Timers", timers)
    loud = call(1)
    assert torch.equal(quiet, loud)
    report = lines[-1]
    for name in stages:
        assert name in report


# -- the benchmark's reading, on a synthetic Chrome trace ------------------

def _record(name, rid, parent, root, start_us, end_us, vis=None):
    return SpanRecord(name, rid, parent, root, int(start_us * 1e3),
                      int(end_us * 1e3), vis)


def _synthetic(tmp_path, offset_us=5_000_000.0, delta_us=3.0):
    """Two steps on the host clock (ns; steps at 1000 us and 3000 us), a
    trace on a clock ``offset_us`` ahead, each step's synchronise entered
    ``delta_us`` after t1 and left ``delta_us`` before t2, and one more
    synchronise after the last step."""
    o = offset_us
    rows = [(1.000e-3, 1.400e-3, 2.000e-3), (3.000e-3, 3.400e-3, 4.000e-3)]
    records, events, corr = [], [], itertools.count(1)
    for k, (t0, _, _) in enumerate(rows):
        b = t0 * 1e6                     # host us of the step's start
        n = len(records)
        records += [
            _record("stream.accumulate", n, None, n, b + 10, b + 390,
                    vis=1000),
            _record("stream.plan", n + 1, n, n, b + 20, b + 100),
            _record("stream.grid", n + 2, n, n, b + 120, b + 200),
            _record("tower.ladder", n + 3, n, n, b + 220, b + 300)]
        launches = [("elementwise_kernel", b + 30, 100.0, 40.0),
                    ("void place_stream_kernel<true>", b + 60, 150.0, 30.0),
                    ("void window_scatter_kernel<0, 0>", b + 130, 300.0,
                     200.0),
                    ("fft_kernel", b + 230, 520.0, 60.0),
                    ("residual_kernel", b + 395, 600.0, 20.0)]
        for name, host_us, dev_us, dur in launches:
            c = next(corr)
            events.append(dict(ph="X", cat="cuda_runtime",
                               name="cudaLaunchKernel", ts=host_us + o,
                               dur=4.0, args=dict(correlation=c)))
            events.append(dict(ph="X", cat="kernel", name=name,
                               ts=b + dev_us + o, dur=dur,
                               args=dict(correlation=c)))
        _, t1, t2 = rows[k]
        events.append(dict(ph="X", cat="cuda_runtime",
                           name="cudaDeviceSynchronize",
                           ts=t1 * 1e6 + delta_us + o,
                           dur=(t2 - t1) * 1e6 - 2 * delta_us, args={}))
    # The profiler's own synchronise when it stops.
    events.append(dict(ph="X", cat="cuda_runtime",
                       name="cudaDeviceSynchronize",
                       ts=rows[-1][2] * 1e6 + 50 + o, dur=13.0, args={}))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=events)))
    return path, records, rows


def test_spans_on_a_synthetic_trace(tmp_path):
    path, records, rows = _synthetic(tmp_path)
    ev = _spans.read_events(str(path))
    assert len(ev.device) == 10 and len(ev.calls) == 10
    assert len(ev.syncs) == 3
    offset, spread = _spans.clock_offset(ev.syncs, rows)
    assert offset == pytest.approx(5_000_000.0, abs=1e-3)
    assert spread == pytest.approx(0.0, abs=1e-3)
    out = _spans.summary(ev, records, rows)
    # Each kernel by its launch's correlation id, to the innermost span
    # open at the launch, though the kernel ran after the span closed.
    assert out["kernels"] == {"place_stream_kernel": (2, 2),
                              "window_scatter_kernel": (2, 2)}
    table = out["table"]
    assert table["stream.plan"]["ops"] == 2
    assert table["stream.plan"]["device_ms"] == pytest.approx(0.070)
    assert table["stream.grid"]["device_ms"] == pytest.approx(0.200)
    assert table["tower.ladder"]["device_ms"] == pytest.approx(0.060)
    assert table[_spans.OUTSIDE]["device_ms"] == pytest.approx(0.020)
    assert table["stream.accumulate"]["host_self_ms"] == pytest.approx(
        (380 - 80 - 80 - 80) / 1e3)
    assert out["device_ms.stream_plan"] == pytest.approx(0.070)
    assert out["host_ms.stream_plan"] == pytest.approx(0.080)
    assert out["device_ms.tower"] == pytest.approx(0.060)
    assert out["device_ops.tower"] == 1
    assert out["host_ms.tower"] == pytest.approx(0.080)
    assert out["outside_pct"] == pytest.approx(100 * 20 / 350)
    # Gaps a step: 140-150 and 180-300 (the host inside stream.grid),
    # 500-520 and 580-600 (after stream.accumulate: outside), and 1480
    # us between the steps (outside).
    assert out["idle_ms.in_program"] == pytest.approx((10 + 120) / 1e3)
    assert out["gaps"][:2] == [(_spans.OUTSIDE, pytest.approx(1.480)),
                               ("stream.grid", pytest.approx(0.120))]
    assert out["clock_spread_us"] == pytest.approx(0.0, abs=1e-3)
    # The driver call: the visibilities its span counted, over its host
    # span and over the device time of every record its root's spans
    # launched (not the residual, launched after it returned).
    (name, row), = out["drivers"].items()
    assert name == "stream.accumulate"
    assert row == dict(calls=1.0, vis=1000.0, host_ms=pytest.approx(0.380),
                       device_ms=pytest.approx(0.330),
                       host_mvis_s=pytest.approx(1000 / 0.380 / 1e3),
                       device_mvis_s=pytest.approx(1000 / 0.330 / 1e3))


def test_spans_clock_offset_cancels_the_calls_own_cost(tmp_path):
    """The anchor's offset is the same whatever the host spends entering
    and leaving the synchronise, as long as the two match, and the
    profiler's own synchronise is paired with no step."""
    for delta in (0.0, 3.0, 25.0):
        path, _, rows = _synthetic(tmp_path, offset_us=-123.5,
                                   delta_us=delta)
        ev = _spans.read_events(str(path))
        offset, _ = _spans.clock_offset(ev.syncs, rows)
        assert offset == pytest.approx(-123.5, abs=1e-3)


def test_spans_without_spans_or_anchor_give_none(tmp_path):
    path, _, rows = _synthetic(tmp_path)
    ev = _spans.read_events(str(path))
    out = _spans.summary(ev, [], rows)
    for key in ("host_ms.stream_plan", "device_ms.stream_plan",
                "host_ms.tower", "device_ms.tower", "device_ops.tower"):
        assert out[key] is None
    assert _spans.plan_s([]) is None
    ev.syncs = []
    assert _spans.summary(ev, [], rows)["idle_ms.in_program"] is None


def test_plan_s_sums_the_outermost_planner_spans():
    recs = [_record("plan.wstack", 0, None, 0, 0, 1000),
            _record("plan.packed", 1, None, 1, 1000, 3000),
            _record("plan.stream", 2, 1, 1, 1500, 2000),
            _record("packed.build", 3, None, 3, 3000, 9000)]
    assert _spans.plan_s(recs) == pytest.approx(3e-3)
