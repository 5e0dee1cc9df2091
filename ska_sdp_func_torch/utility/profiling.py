"""Profiling: program spans and device trace capture.

Counterpart of ska_sdp_func_tpu.utility.profiling (which wraps
``jax.profiler``). :func:`annotate` is the port's span: a named interval
at a layer boundary of the program (a driver call, a stage of the tower
imaging, a planner), the ``SDP_TMR_PUSH/POP`` analogue. Spans are off by
default, and then cost one test of a module-level variable;
:func:`annotated` makes a whole function's call a span. :func:`spans`
turns them on for a block and returns their records, kept in memory;
:func:`trace` records its block with ``torch.profiler`` (CPU activity,
and the CUDA card's kernels where one is present) and writes a Chrome
trace (viewable in Perfetto or chrome://tracing) into ``log_dir`` when
the block exits, with spans on, so that each span is also a region on
the trace's timeline. The named timer tree is :mod:`.timers`.
"""

import contextlib
import functools
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# What annotate() returns while spans are off: one shared object.
_NULL = contextlib.nullcontext()
# The recorder of the open spans() block; None while spans are off.
_recorder: Optional["Spans"] = None
_clock = time.perf_counter_ns


@dataclass(eq=False, slots=True)
class SpanRecord:
    """One span: ``id`` is its index in :attr:`Spans.records`, ``parent``
    the id of the span it was opened in (None at the top), ``root`` the
    id of the top-level span of the call it belongs to; ``start_ns`` and
    ``end_ns`` read ``time.perf_counter_ns``; ``vis`` the visibilities
    the call took or gave, where the caller counted them."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int = 0
    end_ns: int = 0
    vis: Optional[int] = None

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class Spans:
    """The spans of one :func:`spans` block, in the order they opened,
    from the thread that opened the block."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self._open: List[SpanRecord] = []
        self._thread = threading.get_ident()


def self_ns(records) -> Dict[int, int]:
    """The self time of each of ``records`` by id: its duration less the
    durations of its child spans among them."""
    own = {r.id: r.duration_ns for r in records}
    for r in records:
        if r.parent in own:
            own[r.parent] -= r.duration_ns
    return own


class _Span:
    """An open span's context manager (spans on)."""

    __slots__ = ("_spans", "_name", "_vis", "_region")

    def __init__(self, spans: Spans, name: str, vis: Optional[int]):
        self._spans, self._name, self._vis = spans, name, vis
        self._region = None

    def __enter__(self) -> SpanRecord:
        sp = self._spans
        parent = sp._open[-1] if sp._open else None
        rid = len(sp.records)
        rec = SpanRecord(self._name, rid, parent.id if parent else None,
                         parent.root if parent else rid, vis=self._vis)
        sp.records.append(rec)
        sp._open.append(rec)
        if getattr(_autograd_profiler, "_is_profiler_enabled", True):
            self._region = torch.profiler.record_function(self._name)
            self._region.__enter__()
        rec.start_ns = _clock()
        return rec

    def __exit__(self, *exc) -> bool:
        end = _clock()
        if self._region is not None:
            self._region.__exit__(*exc)
        self._spans._open.pop().end_ns = end
        return False


def annotate(name: str, vis: Optional[int] = None):
    """The span ``name`` around the enclosed block (a context manager).

    While spans are off (the default) this returns one shared null
    context manager: no clock read, no allocation, no profiler region,
    no device work. Inside a :func:`spans` block, on the thread that
    opened it, the span is recorded there (a :class:`SpanRecord`: name,
    id, parent, root, start and end on the host's ``perf_counter_ns``,
    and ``vis``, the visibilities a driver call took or gave), and while
    a ``torch.profiler`` profile is active it is also a
    ``record_function`` region on the trace's timeline. A span adds no
    device operation either way."""
    rec = _recorder
    if rec is None:
        return _NULL
    if threading.get_ident() != rec._thread:
        return _NULL
    return _Span(rec, name, vis)


def annotated(name: str, vis: Optional[Callable[..., int]] = None):
    """Decorator: each call of the function is the span ``name``, as if
    its body were inside ``with annotate(name):``. ``vis``, when given,
    is called with the call's arguments once the call has returned (and
    only while spans are on); its result is the span's ``vis``. While
    spans are off a call costs one test of a module-level variable more
    than the undecorated function."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _recorder is None:
                return fn(*args, **kwargs)
            with annotate(name) as span:
                out = fn(*args, **kwargs)
                if span is not None and vis is not None:
                    span.vis = vis(*args, **kwargs)
                return out
        return call
    return wrap


@contextlib.contextmanager
def spans() -> Iterator[Spans]:
    """Turn spans on for the enclosed block; yields the :class:`Spans`
    that records them. A nested block records its own spans only; the
    outer block's recording resumes when it exits."""
    global _recorder
    outer, rec = _recorder, Spans()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = outer


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a trace of the enclosed block, with spans on (each span
    is a region on the trace's timeline).

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
        with spans():
            yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


__all__ = ["SpanRecord", "Spans", "annotate", "annotated", "self_ns", "spans",
           "trace"]
