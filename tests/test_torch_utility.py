"""The port's utility layer beside the JAX package's: the four other log
levels, the package-level exports, and trace capture on the CPU."""

import io
import json
import logging
import os

import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import ska_sdp_func_torch.utility as tutil  # noqa: E402
import ska_sdp_func_tpu.utility as jutil  # noqa: E402
from ska_sdp_func_torch.utility import logging as tlog  # noqa: E402


@pytest.mark.parametrize("fn, severity, level", [
    ("log_debug", "DEBUG", logging.DEBUG),
    ("log_warning", "WARNING", logging.WARNING),
    ("log_error", "ERROR", logging.ERROR),
    ("log_critical", "CRITICAL", logging.CRITICAL),
])
def test_log_levels(fn, severity, level):
    """Each writes the SKA pipe format at its severity, as the JAX
    package's (utility/logging.py:101-117) does, naming its caller."""
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    handler.setFormatter(tlog._SkaFormatter())
    logger = tlog.get_logger()
    saved = logger.level
    logger.setLevel(logging.DEBUG)
    logger.addHandler(handler)
    try:
        getattr(tutil, fn)("%d tasks in %s", 3, "plan")
    finally:
        logger.removeHandler(handler)
        logger.setLevel(saved)
    fields = stream.getvalue().strip().split("|")
    assert fields[2] == severity and fields[4] == "test_log_levels"
    assert fields[6:] == ["ska-sdp-func-torch", "3 tasks in plan"]
    assert callable(getattr(jutil, fn))
    assert tlog._SEVERITY[level] == severity


def test_utility_exports_match_jax():
    """The logging, timer and profiling names the JAX package exports
    from its utility package (utility/__init__.py:26-29) are exported by
    the port's too."""
    names = {"get_logger", "log_debug", "log_info", "log_warning",
             "log_error", "log_critical", "annotate", "trace", "Timer",
             "Timers", "TimerType"}
    assert names <= set(jutil.__all__)
    assert names <= set(tutil.__all__)
    for name in names:
        assert callable(getattr(tutil, name))


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace() records the block with torch.profiler and writes a Chrome
    trace into log_dir; annotate() names a region in it."""
    log_dir = str(tmp_path / "trace")
    with tutil.trace(log_dir) as where:
        assert where == log_dir
        with tutil.annotate("port-region"):
            torch.ones(64).cumsum(0)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port-region" for e in events)


def test_trace_dir_from_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("SKA_SDP_FUNC_TORCH_TRACE_DIR", str(tmp_path / "env"))
    with tutil.trace() as where:
        torch.zeros(4).sum()
    assert where == str(tmp_path / "env") and os.listdir(where)


def _timer_tree(timers, clocked=()):
    """{name: (seconds, children)} of a Timers tree, either package's; the
    host-clocked nodes named in ``clocked`` without their seconds."""
    def walk(node):
        return {name: (None if name in clocked
                       else child.timer.elapsed(), walk(child))
                for name, child in node.children.items()}
    return walk(timers._root)


def test_timers_record_and_section_match_jax():
    """record() adds seconds under the current node, section() pushes in
    a with-block and pops on leaving it: the same tree as the JAX
    package's Timers from the same calls."""
    from ska_sdp_func_tpu.utility.timers import Timers as JTimers
    from ska_sdp_func_tpu.utility.timers import TimerType as JTimerType

    trees = []
    for T, kind in ((tutil.Timers, tutil.TimerType.DEVICE),
                    (JTimers, JTimerType.DEVICE)):
        timers = T("stages", kind)
        timers.record("kernel", 0.25)
        timers.record("kernel", 0.5)
        with timers.section("fft") as same:
            assert same is timers
            timers.record("plane", 0.125)
        timers.record("drain", 1.0)
        assert len(timers._stack) == 1
        assert timers._root.children["fft"].timer.elapsed() > 0
        trees.append(_timer_tree(timers, clocked=("fft",)))
    assert trees[0] == trees[1]
    assert trees[0]["kernel"][0] == 0.75
    assert trees[0]["fft"][1] == {"plane": (0.125, {})}


def test_section_pops_on_an_exception():
    timers = tutil.Timers("t")
    with pytest.raises(ValueError):
        with timers.section("a"):
            raise ValueError("inside")
    assert len(timers._stack) == 1 and "a" in timers._root.children


def test_timer_reset():
    t = tutil.Timer()
    t.start()
    t.pause()
    t.start()
    t.reset()
    assert t.elapsed() == 0.0 and t._start is None
    # A CUDA-event timer drops its pending event and its intervals (the
    # events are stand-ins here: no card).
    c = tutil.Timer(tutil.TimerType.DEVICE, cuda=True)
    c._event, c._intervals, c._elapsed = object(), [(None, None)], 2.0
    c.reset()
    assert c._event is None and c._intervals == [] and c.elapsed() == 0.0


def test_kernel_geometry_key_matches_jax():
    from ska_sdp_func_torch.grid_data import GridderWtowerUVW
    from ska_sdp_func_torch.parallel.wstack import kernel_geometry_key
    from ska_sdp_func_tpu.grid_data import GridderWtowerUVW as JGridder
    from ska_sdp_func_tpu.parallel.wstack import \
        kernel_geometry_key as j_key

    args = (256, 64, 0.002, 100.0, 0.1, -0.15, 8, 16384, 4, 8192)
    key = kernel_geometry_key(GridderWtowerUVW(*args))
    assert key == j_key(JGridder(*args)) == args
    other = kernel_geometry_key(GridderWtowerUVW(*args[:-1], 16384))
    assert other != key
