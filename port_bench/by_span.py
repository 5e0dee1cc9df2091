"""Where a cell's time goes, by the program's own spans, on the card.

    python3 -m port_bench.by_span --workload <cell> --seed <n> --seconds <s>

It sets the cell up with spans on
(``ska_sdp_func_torch.utility.profiling.spans``), runs the traffic's
trace stretch under ``torch.profiler`` as a ``--trace 1`` run does (the
card's activity, warm-up steps first) with spans on, then times
``--seconds`` of untraced steps with spans off. It maps the spans onto
the trace's clock by the steps' synchronises and gives each device record
and idle gap to the span that caused it (``metrics/_spans.py``). Standard
error gets the set-up phases, the clock anchor's spread, a line a span
(calls, host self time, device time and operations a step), a line a
driver (the visibilities its spans counted, over its host span and over
the device time its call launched, beside the untraced window's
``mvis_s``), the longest idle gaps and the kernels' attribution; the last
line of standard output is one JSON object with the per-layer numbers.
It judges no output.

``port_bench.run`` keeps spans off: these numbers are not the
benchmark's metrics. This tool stands in for a ``--trace 1`` run that
reads the spans itself, and goes when ``harness.run_cell`` does.
"""

import argparse
import json
import os
import sys
import tempfile
import time


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _profiled(timer, warmup: int, active: int, path: str) -> None:
    """``warmup`` then ``active`` steps under ``torch.profiler`` (the
    harness's schedule and activities), the trace exported to ``path``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] if timer.device.type == "cuda" else \
        [ProfilerActivity.CPU]
    sched = schedule(wait=0, warmup=warmup, active=active, repeat=1)
    with profile(activities=acts, schedule=sched) as prof:
        for j in range(warmup + active):
            timer.step(j)
            prof.step()
    prof.export_chrome_trace(path)


def traced(spec, seed: int, seconds: float, device) -> dict:
    """Set up, profile and time one cell as the docstring says; returns
    the numbers (the per-layer ones under ``metrics``)."""
    import numpy as np

    from ska_sdp_func_torch.utility.profiling import spans

    from . import harness
    from .metrics import _spans

    cell = spec.step_module.Cell(spec.config, spec.traffic, seed, device)
    with spans() as setup:
        cell.setup()
    log(cell.phases.line())
    timer = harness.Timer(cell, device)
    tr = spec.traffic["trace"]
    warmup, active = tr["warmup_steps"], tr["active_steps"]
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with spans() as run:
            _profiled(timer, warmup, active, path)
        events = _spans.read_events(path)
    finally:
        os.remove(path)
    rows = timer.rows[warmup:]
    i = warmup + active
    t_end = time.perf_counter() + seconds
    while timer.step(i) < t_end:
        i += 1
    window = np.asarray(timer.rows[warmup + active:])
    cell.free()
    out = _spans.summary(events, run.records, rows)
    lo, hi = int(rows[0][0] * 1e9), int(rows[-1][2] * 1e9)
    roots = [r.duration_ns for r in run.records
             if r.parent is None and r.start_ns >= lo and r.end_ns <= hi]
    metric_names = ("host_ms.stream_plan", "device_ms.stream_plan",
                    "host_ms.tower", "device_ms.tower", "device_ops.tower",
                    "idle_ms.in_program")
    metrics = {"plan_s": _spans.plan_s(setup.records)}
    metrics.update((k, out.pop(k)) for k in metric_names)
    return dict(
        metrics={k: v for k, v in metrics.items() if v is not None},
        device_ops_per_step=len(events.device) / len(rows),
        driver_host_ms=sum(roots) / 1e6 / len(rows),
        host_enqueue_ms=float((window[:, 1] - window[:, 0]).mean() * 1e3),
        mvis_s=len(window) * cell.vis_per_step
        / (window[-1, 2] - window[0, 0]) / 1e6,
        untraced_steps=len(window), **out)


def report(result: dict) -> None:
    """The traced run's lines for standard error."""
    log(f"clock anchor spread {result['clock_spread_us']} us; "
        f"{result['device_ops_per_step']:.2f} device operations a step; "
        f"device time outside any span {result['outside_pct']} %")
    log(f"driver spans' host ms a step (profiled) "
        f"{result['driver_host_ms']:.3f} against host_enqueue_ms "
        f"{result['host_enqueue_ms']:.3f} (untraced, "
        f"{result['untraced_steps']} steps)")
    for name, row in sorted(result["table"].items(),
                            key=lambda kv: -kv[1]["device_ms"]):
        log(f"span {name}: calls {row['calls']:.2f}, host self "
            f"{row['host_self_ms']:.3f} ms, device {row['device_ms']:.3f} "
            f"ms in {row['ops']:.2f} operations a step")
    for name, row in result["drivers"].items():
        log(f"driver {name}: {row['calls']:.2f} calls, {row['vis']:.0f} "
            f"visibilities, host {row['host_ms']:.3f} ms, device "
            f"{row['device_ms']:.3f} ms a step: {row['host_mvis_s']} Mvis/s "
            f"over its host span, {row['device_mvis_s']} over its device "
            f"time (untraced window: mvis_s {result['mvis_s']:.2f})")
    log("longest idle gaps by span (ms): " + ", ".join(
        f"{n} {ms:.4f}" for n, ms in result["gaps"]))
    log("kernel records attributed to their span: " + ", ".join(
        f"{k} {a}/{n}" for k, (a, n) in result["kernels"].items()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch

    from . import harness

    spec = harness.load_cell("BENCHMARK.json", args.workload)
    if not torch.cuda.is_available():
        log("no CUDA card: no result")
        return 2
    device = torch.device("cuda", 0)
    result = traced(spec, args.seed, args.seconds, device)
    report(result)
    print(json.dumps(dict(workload=args.workload, seed=args.seed,
                          card=torch.cuda.get_device_name(0),
                          **result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
