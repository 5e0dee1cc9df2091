"""Hierarchical named timers.

Counterpart of ska_sdp_func_tpu.utility.timers (reference:
utility/sdp_timer.{h,cpp}, a named timer tree with push/pop and a
percentage report over wall-clock or CUDA-event backends). Here the
``DEVICE`` backend is the reference's own: a pair of
``torch.cuda.Event`` per timed interval, recorded on the current stream,
so a section measures device time without synchronising the host. On a
CPU device the work runs on the host, and ``DEVICE`` reads the host
clock.
"""

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


class TimerType(enum.Enum):
    """Timer backend (reference: SDP_TIMER_NATIVE / SDP_TIMER_CUDA)."""

    NATIVE = "native"
    DEVICE = "device"


class Timer:
    """Stopwatch accumulating elapsed seconds across start/pause cycles;
    with ``cuda=True`` each interval is a pair of CUDA events."""

    def __init__(self, timer_type: TimerType = TimerType.NATIVE,
                 cuda: bool = False):
        self.timer_type = timer_type
        self.cuda = bool(cuda) and timer_type is TimerType.DEVICE
        self._elapsed = 0.0
        self._start: Optional[float] = None
        self._event = None
        self._intervals: List = []

    def start(self) -> None:
        if self.cuda:
            if self._event is None:
                self._event = torch.cuda.Event(enable_timing=True)
                self._event.record()
        elif self._start is None:
            self._start = time.perf_counter()

    def pause(self) -> None:
        if self.cuda:
            if self._event is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._intervals.append((self._event, end))
                self._event = None
        elif self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None

    def reset(self) -> None:
        """Back to zero and stopped: the accumulated seconds, and a CUDA
        timer's pending start event and recorded intervals, are
        dropped."""
        self._elapsed = 0.0
        self._start = None
        self._event = None
        self._intervals = []

    def elapsed(self) -> float:
        total = self._elapsed
        if self.cuda:
            pending = self._event is not None
            if pending:
                self.pause()
            for begin, end in self._intervals:
                end.synchronize()
                total += begin.elapsed_time(end) / 1e3
            if pending:
                self.start()
        elif self._start is not None:
            total += time.perf_counter() - self._start
        return total


@dataclass
class _TimerNode:
    name: str
    timer: Timer
    children: Dict[str, "_TimerNode"] = field(default_factory=dict)


class Timers:
    """Named timer tree with push/pop scoping and a percentage report
    (`sdp_Timers`, sdp_timer.h:43-148). ``device`` selects the DEVICE
    backend's clock: CUDA events on a CUDA device, the host clock
    otherwise."""

    def __init__(self, name: str = "Timing report",
                 timer_type: TimerType = TimerType.NATIVE, device=None):
        self.timer_type = timer_type
        self._cuda = (timer_type is TimerType.DEVICE and device is not None
                      and torch.device(device).type == "cuda")
        self._root = _TimerNode(name, self._new_timer())
        self._stack: List[_TimerNode] = [self._root]
        self._root.timer.start()

    def _new_timer(self) -> Timer:
        return Timer(self.timer_type, cuda=self._cuda)

    def sync(self, *values) -> None:
        """Kept for the JAX API: the CUDA events are ordered on the
        stream with the work they bracket, so nothing needs blocking."""

    def _child(self, name: str) -> _TimerNode:
        """The current node's child ``name``, made on first use."""
        parent = self._stack[-1]
        node = parent.children.get(name)
        if node is None:
            node = _TimerNode(name, self._new_timer())
            parent.children[name] = node
        return node

    def push(self, name: str) -> "Timers":
        node = self._child(name)
        node.timer.start()
        self._stack.append(node)
        return self

    def pop(self) -> None:
        if len(self._stack) <= 1:
            return
        node = self._stack.pop()
        node.timer.pause()

    def pop_push(self, name: str) -> "Timers":
        self.pop()
        return self.push(name)

    def record(self, name: str, seconds: float) -> None:
        """Add seconds measured elsewhere (stage times a driver took
        itself) under the child ``name`` of the current node, as the JAX
        package's ``Timers.record`` does; on a CUDA-event timer they add
        to its events' intervals."""
        self._child(name).timer._elapsed += float(seconds)

    def section(self, name: str) -> "Timers":
        """``with timers.section("fft"): ...`` pushes ``name`` and pops it
        on leaving the block."""
        return self.push(name)

    def __enter__(self) -> "Timers":
        return self

    def __exit__(self, *exc) -> bool:
        self.pop()
        return False

    def report(self, print_fn=print) -> str:
        total = self._root.timer.elapsed()
        lines = [f"{self._root.name} ({total:.3f} s total)"]

        def _walk(node: _TimerNode, indent: int):
            timed = 0.0
            for child in node.children.values():
                elapsed = child.timer.elapsed()
                timed += elapsed
                pct = 100.0 * elapsed / total if total > 0 else 0.0
                lines.append(f"{'  ' * indent}+- {child.name}: "
                             f"{elapsed:.3f} s ({pct:.1f}%)")
                _walk(child, indent + 1)
            if node.children:
                parent_elapsed = node.timer.elapsed()
                unaccounted = parent_elapsed - timed
                if unaccounted > 1e-4 and parent_elapsed > 0:
                    pct = 100.0 * unaccounted / total if total > 0 else 0.0
                    lines.append(f"{'  ' * indent}+- (unaccounted): "
                                 f"{unaccounted:.3f} s ({pct:.1f}%)")

        _walk(self._root, 0)
        text = "\n".join(lines)
        if print_fn is not None:
            print_fn(text)
        return text
