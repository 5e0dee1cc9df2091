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
