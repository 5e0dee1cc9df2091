"""The roofline's operation and byte counts against hand counts at tiny
shapes, and the share the readers make of a trace."""

import pytest

from port_bench.harness import Trace
from port_bench.metrics import _roofline as rl

SHAPES = dict(vis=10, rows=5, stack=3 * 2 * 16, support=2, w_support=3,
              mode="highest")


def test_grid_and_degrid_counts():
    for kind in ("grid", "degrid"):
        flops, nbytes = rl.work(dict(SHAPES, kind=kind))
        # 10 visibilities x 2*2*3 complex multiply-adds x 8 flops.
        assert flops == 10 * 12 * 8
        # 10 values x 8 B, 5 rows x 12 B, 96 stack cells x 8 B.
        assert nbytes == 80 + 60 + 768


def test_place_counts():
    assert rl.work(dict(SHAPES, kind="place", values=True)) == (0.0, 220.0)
    assert rl.work(dict(SHAPES, kind="place", values=False)) == (0.0, 60.0)


def test_counts_ignore_kernel_arguments():
    """Only problem shapes enter: extra keys (padding, slots) change
    nothing."""
    a = rl.work(dict(SHAPES, kind="grid"))
    b = rl.work(dict(SHAPES, kind="grid", slots=10 ** 9, block_v=1024))
    assert a == b


PEAK = {"hbm_bytes_per_s": 1000.0,
        "flops_per_s": {"f32": 100.0, "bf16": 3000.0},
        "modes": {"highest": {"unit": "f32", "passes": 1},
                  "high": {"unit": "bf16", "passes": 3},
                  "bf16": {"unit": "bf16", "passes": 1}}}


@pytest.mark.parametrize("mode,expect", [
    ("highest", (960 / 100.0, "operations")),
    ("high", (960 * 3 / 3000.0, "operations")),
    ("bf16", (908 / 1000.0, "bytes")),
])
def test_least_seconds_picks_the_larger_bound(mode, expect):
    got = rl.least_seconds(dict(SHAPES, kind="grid", mode=mode), PEAK)
    assert got[1] == expect[1]
    assert got[0] == pytest.approx(expect[0])


def test_published_peaks():
    p = rl.peaks()
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["flops_per_s"] == {"f32": 67e12, "tf32": 495e12,
                                "bf16": 989e12}


def test_share_of_traced_launches():
    k = dict(SHAPES, kind="grid", name="grid_runs_kernel")
    least, _ = rl.least_seconds(k)
    trace = Trace(steps=2, records=[
        ("void (anonymous namespace)::grid_runs_kernel<1>(Maps)", 0.0, 4.0),
        ("void grid_runs_kernel<1>(Maps, RunArgs)", 10.0, 6.0),
        ("void (anonymous namespace)::degrid_runs_kernel<1>(Maps)", 20.0,
         50.0),
        ("other", 5.0, 1.0)])
    ctx = {"kernels": {"K1": k}, "trace": trace}
    assert rl.share(ctx, "K1") == pytest.approx(100 * least / 5e-6)
    assert rl.share(ctx, "K2") is None
    assert rl.share(dict(ctx, trace=Trace(steps=1, records=[])),
                    "K1") is None
    assert rl.share(dict(ctx, trace=None), "K1") is None


def test_trace_busy_idle_and_gaps():
    t = Trace(steps=1, records=[("a", 0.0, 10.0), ("b", 5.0, 10.0),
                                ("c", 30.0, 10.0)],
              host=[("step", 0.0, 50.0), ("sync", 14.0, 2.0)])
    assert t.busy_s == pytest.approx(25e-6)
    assert t.window_s == pytest.approx(40e-6)
    assert t.idle_gaps() == [("sync", pytest.approx(15e-6))]
    assert t.top_ops()[0] == ("a", pytest.approx(10e-6))
