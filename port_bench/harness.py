"""The benchmark's general part: find a cell's files by name, time its
window, read the trace, compute the metrics, judge the outputs.

Nothing here knows a configuration, a traffic mix, a step kind or a
metric: ``BENCHMARK.json`` names them, and each is a file of its own
under ``base`` (the ``port_bench`` directory):

- configuration: the ``file`` its ``configs`` entry gives;
- traffic mix: ``traffic/<traffic>.json``; its ``step`` key names the
  step kind, ``steps/<step>.py``;
- metric: ``metrics/<name>.py``, whose ``read(ctx)`` returns a number or
  None (the metric is then left out of the line).
"""

import gc
import importlib
import importlib.util
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# Top-level module names the benchmark's process may never hold: the JAX
# package the port was made from, JAX itself, and the older benchmark's
# scripts.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ska_sdp_func_tpu", "bench",
                     "chip_smoke")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Device operations' names in the breakdown are cut to this length.
NAME_CHARS = 200


@dataclass
class CellSpec:
    name: str
    chips: int
    config: dict
    traffic: dict
    step_module: object
    end_to_end: list
    per_layer: list
    base: str = HERE


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def step_module(base: str, kind: str):
    """The step kind's module: the file ``<base>/steps/<kind>.py`` where
    ``base`` is another directory and has it, else
    ``port_bench.steps.<kind>``."""
    path = os.path.join(base, "steps", f"{kind}.py")
    if os.path.samefile(base, HERE) or not os.path.exists(path):
        return importlib.import_module(f"port_bench.steps.{kind}")
    return _load_file(path, f"port_bench_step_{kind}")


def metric_reader(base: str, name: str):
    path = os.path.join(base, "metrics", f"{name}.py")
    return _load_file(path, "port_bench_metric_" + name.replace(".", "_"))


def _applies(metric: dict, workload: str) -> bool:
    """Whether ``metric`` belongs to cell ``workload``: listed under its
    ``workloads``; an end-to-end metric without the key belongs to every
    cell. A per-layer metric has to name its cells."""
    return workload in metric.get("workloads", (workload,))


def load_cell(bench_path: str, workload: str, base: str = HERE) -> CellSpec:
    """The cell ``workload`` of the benchmark file ``bench_path``, its
    files taken from ``base`` (configurations from the root of
    ``bench_path`` by their ``file``)."""
    bench = load_json(bench_path)
    root = os.path.dirname(os.path.abspath(bench_path))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path} "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(base, "traffic",
                                     f"{cell['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']!r} names no "
                           "workloads")
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return CellSpec(name=workload, chips=cell["chips"], config=config,
                    traffic=traffic,
                    step_module=step_module(base, traffic["step"]),
                    end_to_end=e2e, per_layer=per_layer, base=base)


# ---------------------------------------------------------------------------
# The profiler's trace
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """Device records of the profiler's active steps: ``records`` are
    ``(name, start_us, duration_us)``; ``host`` the host's operations
    ``(name, start_us, duration_us)``."""

    steps: int
    records: list
    host: list = field(default_factory=list)

    def durations(self, kernel: str):
        """Seconds of each record whose name holds the identifier
        ``kernel`` whole (``grid_runs_kernel`` is not in
        ``degrid_runs_kernel``)."""
        pat = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(kernel)
                         + r"(?![A-Za-z0-9_])")
        return [d * 1e-6 for n, _, d in self.records if pat.search(n)]

    @property
    def busy_s(self) -> float:
        end, busy = None, 0.0
        for _, s, d in sorted(self.records, key=lambda r: r[1]):
            e = s + d
            if end is None or s >= end:
                busy += d
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-6

    @property
    def window_s(self) -> float:
        if not self.records:
            return 0.0
        start = min(s for _, s, _ in self.records)
        end = max(s + d for _, s, d in self.records)
        return (end - start) * 1e-6

    def top_ops(self, count: int = 10):
        total = {}
        for n, _, d in self.records:
            total[n] = total.get(n, 0.0) + d * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])[:count]

    def idle_gaps(self, count: int = 10):
        """The longest device idle gaps, each named by the innermost host
        operation running when it began, or else by the device operation
        that ended it."""
        recs = sorted(self.records, key=lambda r: r[1])
        gaps, end = [], None
        for _, s, d in recs:
            if end is not None and s > end:
                gaps.append((end, s - end))
            end = s + d if end is None else max(end, s + d)
        gaps.sort(key=lambda g: -g[1])
        out = []
        for start, length in gaps[:count]:
            inside = [(d, n) for n, s, d in self.host
                      if s <= start <= s + d]
            if inside:
                name = min(inside)[1]
            else:
                after = min((r for r in recs if r[1] >= start + length),
                            key=lambda r: r[1])
                name = "host, before " + after[0]
            out.append((name, length * 1e-6))
        return out


def read_chrome_trace(path: str, steps: int) -> Trace:
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) \
        if isinstance(events, dict) else events
    records, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        item = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)))
        if cat in DEVICE_CATEGORIES:
            records.append(item)
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                     "python_function"):
            host.append(item)
    return Trace(steps=steps, records=records, host=host)


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

def _launch_counts():
    from ska_sdp_func_torch.kernels import launch_counts
    return launch_counts()


class Timer:
    """Host times ``(first call, calls returned, synchronised)`` of each
    step."""

    def __init__(self, cell, device):
        self.cell, self.device = cell, device
        self.rows = []

    def step(self, i):
        t0 = time.perf_counter()
        self.cell.step(i)
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self.rows.append((t0, t1, t2))
        return t2


def _profile(timer, warmup: int, active: int, kernels, log) -> Trace:
    """Run the window's first steps under ``torch.profiler``: ``warmup``
    steps with the profiler on and its records dropped (they absorb the
    records a fresh profile loses), then ``active`` recorded ones."""
    from torch.profiler import ProfilerActivity, profile, schedule

    sched = schedule(wait=0, warmup=warmup, active=active, repeat=1)
    # On a card, the device's activity and the CUDA runtime calls that
    # come with it: idle gaps are named by those calls or by the device
    # operation that ends them.
    acts = [ProfilerActivity.CUDA] if timer.device.type == "cuda" else \
        [ProfilerActivity.CPU]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=acts, schedule=sched) as prof:
            for j in range(warmup + active):
                if j == warmup:
                    before = _launch_counts()
                timer.step(j)
                prof.step()
            after = _launch_counts()
        prof.export_chrome_trace(path)
        trace = read_chrome_trace(path, active)
    finally:
        os.remove(path)
    launched = {k: after[k] - before.get(k, 0) for k in after
                if after[k] - before.get(k, 0)}
    seen = {k: len(trace.durations(v["name"])) for k, v in kernels.items()}
    log(f"profiler: {len(trace.records)} device records in {active} "
        f"steps; port kernel records seen {seen} against launches counted "
        f"{launched}: {sum(launched.values()) - sum(seen.values())} lost")
    return trace


def run_cell(spec: CellSpec, seed: int, seconds: float, trace: bool,
             device, t_start: float, log, fast: bool = False):
    """Set up, measure and judge one run of a cell. Returns the result's
    dict (without ``device``) and the checks ``[(name, value, limit)]``."""
    cell = spec.step_module.Cell(spec.config, spec.traffic, seed, device,
                                 fast=fast)
    cell.setup()
    log(cell.describe())
    log(cell.phases.line())
    timer = Timer(cell, device)
    steps_before = 0
    profiled = None
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    i = 0
    if trace:
        tr = spec.traffic["trace"]
        profiled = _profile(timer, tr["warmup_steps"], tr["active_steps"],
                            cell.kernels(), log)
        i = steps_before = tr["warmup_steps"] + tr["active_steps"]
    # The window of untraced steps: the whole window, or in a traced run
    # a window as long after the profiled steps, whose host times no
    # metric uses.
    t_steps = time.perf_counter()
    while True:
        t2 = timer.step(i)
        i += 1
        if t2 >= t_steps + seconds:
            break
    window_s = t2 - t_steps
    steps = np.asarray(timer.rows[steps_before:], np.float64)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    cell.after_window()
    spans = cell.spans() if trace else {}
    cell.collect()
    kernels = cell.kernels()
    cell.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = cell.check()
    ref_s = time.perf_counter() - t_ref
    for note in cell.notes:
        log(note)
    log(f"steps in the window: {i}; untraced steps timed: {len(steps)}; "
        f"step_p95_ms samples: {len(steps)} "
        f"({max(0, len(steps) - int(np.ceil(0.95 * len(steps))))} beyond "
        f"the 95th percentile); window {window_s:.3f} s; reference "
        f"{ref_s:.3f} s")
    if len(steps) >= 8:
        quarters = np.array_split(steps, 4)
        log("steps a second by quarter of the window: " + ", ".join(
            f"{len(q) / (q[-1, 2] - q[0, 0]):.3f}" for q in quarters))
    ctx = dict(steps=steps, window_s=window_s,
               vis_per_step=cell.vis_per_step, setup_s=setup_s,
               kernels=kernels, spans=spans,
               trace=profiled)
    wanted = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for m in wanted:
        value = metric_reader(spec.base, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = sum(1 for _, v, lim in checks
                 if not (np.isfinite(v) and v <= lim))
    result = dict(correct=failed == 0, attempted=int(i), failed=failed,
                  metrics=metrics)
    extra = {}
    if profiled:
        t = profiled
        extra = dict(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in t.top_ops()],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in t.idle_gaps()]}
    return result, checks, dict(memory_peak_bytes=int(peak), **extra)


def forbidden_modules(modules) -> list:
    """Names in ``modules`` whose top-level package is forbidden (the
    whole top-level name compared)."""
    return sorted(m for m in modules
                  if m.split(".")[0] in FORBIDDEN_MODULES)
