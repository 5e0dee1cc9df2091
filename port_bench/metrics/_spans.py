"""The program's spans (``ska_sdp_func_torch.utility.profiling``) on the
device trace's clock, and the device records and idle gaps each span
caused.

- :func:`read_events`: from a ``torch.profiler`` Chrome trace, the device
  records with their correlation ids, the CUDA runtime and driver calls
  by correlation id, and the ``cudaDeviceSynchronize`` calls.
- :func:`clock_offset`: the spans' ``perf_counter_ns`` mapped onto the
  trace's microseconds by the harness's own synchronises. Step j's
  synchronise starts just after the host time ``t1`` that
  ``harness.Timer`` takes before it, and ends just before ``t2``; the
  offset is the median over the steps of the mean of (start - t1) and
  (end - t2), so the host's cost of entering and leaving the call cancels.
  Its spread (max - min) says how far to trust it.
- :func:`attribute`: each device record to the innermost span whose host
  interval holds the start of the runtime call that launched it (matched
  by correlation id); each idle gap to the innermost span open on the
  host when it began. None: the harness's or the cell's own code.
- :func:`plan_s` and :func:`summary`: the per-layer numbers (set-up's,
  and a step's), a table by span, and one by driver: the spans that share
  a top-level span's ``root`` are one driver call, whose device time is
  that of every record they launched and whose rate is the ``vis`` the
  call counted over that time.
"""

import bisect
import json
import re
import statistics
from dataclasses import dataclass, field

from ska_sdp_func_torch.utility.profiling import self_ns

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALL_CATEGORIES = ("cuda_runtime", "cuda_driver")
SYNC = "cudaDeviceSynchronize"
# The name of device time and gaps no span caused.
OUTSIDE = "(outside)"
# The port's stack kernels and the span that launches each.
KERNEL_SPANS = {"grid_runs_kernel": "packed.grid_kernel",
                "degrid_runs_kernel": "packed.degrid_kernel",
                "window_scatter_kernel": "stream.grid",
                "window_gather_kernel": "stream.degrid",
                "place_stream_kernel": "stream.plan"}


@dataclass
class Events:
    """``device``: ``(name, start_us, duration_us, correlation)``;
    ``calls``: correlation -> start_us of the runtime or driver call that
    launched it; ``syncs``: ``(start_us, end_us)`` of each
    ``cudaDeviceSynchronize``, in order."""

    device: list = field(default_factory=list)
    calls: dict = field(default_factory=dict)
    syncs: list = field(default_factory=list)


@dataclass
class Span:
    """A span mapped onto the trace's clock (microseconds)."""

    name: str
    id: int
    parent: object
    root: int
    vis: object
    start: float
    end: float


def read_events(path: str) -> Events:
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    out = Events()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        start, dur = float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATEGORIES:
            out.device.append((e.get("name", ""), start, dur,
                               args.get("correlation")))
        elif cat in HOST_CALL_CATEGORIES:
            if "correlation" in args:
                out.calls[args["correlation"]] = start
            if e.get("name") == SYNC:
                out.syncs.append((start, start + dur))
    out.device.sort(key=lambda r: r[1])
    out.syncs.sort()
    return out


def clock_offset(syncs, rows):
    """(offset_us, spread_us): trace microseconds = host ns / 1000 +
    offset. ``rows``: the profiled steps' ``(t0, t1, t2)`` host seconds
    (``time.perf_counter``). ``syncs`` holds each step's synchronise and
    may hold others (the profiler's own when it stops): each step is
    paired with the synchronise that fits it under the offset that fits
    the steps best. None where there are none."""
    if not syncs or not len(rows):
        return None, None
    host = [(t1 * 1e6, t2 * 1e6) for _, t1, t2 in rows]

    def fit(offset):
        """Each step's synchronise under ``offset`` and its misfit."""
        pairs = [min(syncs, key=lambda se: abs(se[0] - t1 - offset)
                     + abs(se[1] - t2 - offset)) for t1, t2 in host]
        return pairs, sum(abs(s - t1 - offset) + abs(e - t2 - offset)
                          for (s, e), (t1, t2) in zip(pairs, host))

    pairs, _ = min((fit(s - t1) for s, _ in syncs for t1, _ in host),
                   key=lambda f: f[1])
    offsets = [((s - t1) + (e - t2)) / 2
               for (s, e), (t1, t2) in zip(pairs, host)]
    return statistics.median(offsets), max(offsets) - min(offsets)


def mapped(records, offset_us: float):
    """Span records (``profiling.SpanRecord``) on the trace's clock."""
    return [Span(r.name, r.id, r.parent, r.root, r.vis,
                 r.start_ns / 1e3 + offset_us, r.end_ns / 1e3 + offset_us)
            for r in records]


def innermost(spans, starts, t: float):
    """The innermost of ``spans`` (in start order, ``starts`` their
    starts) open at ``t``, or None."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[j].end >= t:
            return spans[j]
    return None


def gaps(device):
    """Device idle gaps ``(start_us, length_us)`` between the first
    record and the last (records in start order)."""
    out, end = [], None
    for _, s, d, _ in device:
        if end is not None and s > end:
            out.append((end, s - end))
        end = s + d if end is None else max(end, s + d)
    return out


def attribute(events: Events, spans):
    """([(device record, span or None)], [(gap start, length, span or
    None)]). A record without its runtime call is given to None."""
    spans = sorted(spans, key=lambda s: s.start)
    starts = [s.start for s in spans]
    recs = []
    for rec in events.device:
        call = events.calls.get(rec[3])
        recs.append((rec, None if call is None
                     else innermost(spans, starts, call)))
    named = [(s, n, innermost(spans, starts, s))
             for s, n in gaps(events.device)]
    return recs, named


def _named(name: str, names) -> bool:
    """Whether ``name`` is one of ``names``, or starts with one that ends
    in '.'."""
    return any(name == n or (n.endswith(".") and name.startswith(n))
               for n in names)


def _within(span, by_id, names) -> bool:
    """Whether ``span`` or one of its ancestors is one of ``names``."""
    while span is not None:
        if _named(span.name, names):
            return True
        span = by_id.get(span.parent)
    return False


def plan_s(setup_records):
    """Seconds in the host planners (``plan.*`` spans not inside
    another) of set-up's span records, or None."""
    by_id = {r.id: r for r in setup_records}
    top = [r for r in setup_records if r.name.startswith("plan.")
           and not _within(by_id.get(r.parent), by_id, ("plan.",))]
    return sum(r.duration_ns for r in top) / 1e9 if top else None


def drivers(spans, recs, steps: int):
    """By top-level span that counted visibilities (a driver call): calls,
    visibilities, host ms and device ms a step (the device records that
    any span of the call's ``root`` launched), and the Mvis/s of each."""
    by_id = {s.id: s for s in spans}
    table = {}
    for s in spans:
        if s.parent is None and s.vis is not None:
            row = table.setdefault(s.name, [0, 0, 0.0, 0.0])
            row[0] += 1
            row[1] += s.vis
            row[2] += (s.end - s.start) / 1e3
    for r, s in recs:
        top = by_id.get(s.root) if s is not None else None
        if top is not None and top.name in table and top.vis is not None:
            table[top.name][3] += r[2] / 1e3
    return {k: dict(calls=c / steps, vis=v / steps, host_ms=h / steps,
                    device_ms=d / steps,
                    host_mvis_s=v / h / 1e3 if h else None,
                    device_mvis_s=v / d / 1e3 if d else None)
            for k, (c, v, h, d) in table.items()}


def summary(events: Events, run_records, rows):
    """The per-layer numbers a step of the profiled steps ``rows`` (whose
    spans are among ``run_records``), and a table by span. Device
    numbers are None without a clock anchor or device records."""
    steps = len(rows)
    lo, hi = int(rows[0][0] * 1e9), int(rows[-1][2] * 1e9)
    host = [r for r in run_records if r.start_ns >= lo and r.end_ns <= hi]
    names = {r.name for r in host}

    def host_ms(prefixes):
        got = [r.duration_ns for r in host if _named(r.name, prefixes)]
        return sum(got) / 1e6 / steps if got else None

    offset, spread = clock_offset(events.syncs, rows)
    out = {"host_ms.stream_plan": host_ms(("stream.plan",)),
           "host_ms.tower": host_ms(("tower.",)),
           "device_ms.stream_plan": None, "device_ms.tower": None,
           "device_ops.tower": None, "idle_ms.in_program": None,
           "clock_spread_us": spread, "outside_pct": None, "table": {},
           "drivers": {}, "gaps": [], "kernels": {}}
    if offset is None or not events.device:
        return out
    spans = mapped(host, offset)
    by_id = {s.id: s for s in spans}
    recs, named = attribute(events, spans)

    def device(prefixes):
        got = [r for r, s in recs if _within(s, by_id, prefixes)]
        return sum(r[2] for r in got) / 1e3 / steps, len(got) / steps

    if "stream.plan" in names:
        out["device_ms.stream_plan"] = device(("stream.plan",))[0]
    if any(_named(n, ("tower.",)) for n in names):
        out["device_ms.tower"], out["device_ops.tower"] = device(
            ("tower.",))
    out["idle_ms.in_program"] = sum(
        n for _, n, s in named if s is not None) / 1e3 / steps
    busy = sum(r[2] for r, _ in recs)
    if busy:
        out["outside_pct"] = 100.0 * sum(
            r[2] for r, s in recs if s is None) / busy
    own = self_ns(host)
    table = {}
    for r in host:
        row = table.setdefault(r.name, [0, 0.0, 0.0, 0])
        row[0] += 1
        row[1] += own[r.id] / 1e6
    for r, s in recs:
        row = table.setdefault(s.name if s else OUTSIDE, [0, 0.0, 0.0, 0])
        row[2] += r[2] / 1e3
        row[3] += 1
    out["table"] = {k: dict(calls=c / steps, host_self_ms=h / steps,
                            device_ms=d / steps, ops=n / steps)
                    for k, (c, h, d, n) in table.items()}
    out["drivers"] = drivers(spans, recs, steps)
    out["gaps"] = [(s.name if s else OUTSIDE, n / 1e3) for _, n, s in
                   sorted(named, key=lambda g: -g[1])[:5]]
    for kernel, want in KERNEL_SPANS.items():
        pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(kernel)
                         + r"(?![A-Za-z0-9_])")
        mine = [s for r, s in recs if pat.search(r[0])]
        if mine:
            out["kernels"][kernel] = (
                sum(1 for s in mine if s is not None and s.name == want),
                len(mine))
    return out
