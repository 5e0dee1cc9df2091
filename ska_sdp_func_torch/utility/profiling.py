"""Profiling: device trace capture and named trace regions.

Counterpart of ska_sdp_func_tpu.utility.profiling (which wraps
``jax.profiler``). :func:`trace` records the enclosed block with
``torch.profiler`` (CPU activity, and the CUDA card's kernels where one
is present) and writes a Chrome trace (viewable in Perfetto or
chrome://tracing) into ``log_dir`` when the block exits; :func:`annotate`
labels a named region inside it, the ``SDP_TMR_PUSH/POP`` analogue on the
trace timeline. The named timer tree is :mod:`.timers`.
"""

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a trace of the enclosed block.

    Yields the directory the trace is written to: ``log_dir``, else
    ``$SKA_SDP_FUNC_TORCH_TRACE_DIR``, else ``ska_sdp_func_torch_trace``
    in the temporary directory (``/tmp`` by default). The file is
    ``trace_<pid>_<time_ns>.json``.
    """
    log_dir = log_dir or os.environ.get(
        "SKA_SDP_FUNC_TORCH_TRACE_DIR",
        os.path.join(tempfile.gettempdir(), "ska_sdp_func_torch_trace"))
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region on the trace timeline (and a Python context
    manager)."""
    return torch.profiler.record_function(name)


__all__ = ["annotate", "trace"]
