"""Helpers shared by the experiment drivers: timing, errors, bounds, output.

Times come only from a CUDA card (CUDA events); a run on the CPU checks
the plain versions and reports no time.
"""

import argparse
import json
import time

import torch

# The H100 SXM's published peaks (NVIDIA H100 datasheet; dense tensor-core
# rates, without sparsity).
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12          # f32 outside the tensor cores
TF32_OPS_S = 495e12        # a TF32 tensor-core pass
BF16_OPS_S = 989e12


def card_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def abs_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def rel_err(got, want) -> float:
    """Largest difference over max|want|."""
    return abs_err(got, want) / max(float(want.float().abs().max()), 1e-30)


def chained_ms(fn, feed, iters: int, warmup: int = 2):
    """Mean ms per call of ``fn`` by CUDA events over ``iters`` calls, each
    call's output fed by ``feed`` into the next call's inputs (a
    one-element update, so the feed costs a few microseconds)."""
    for _ in range(warmup):
        feed(fn())
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        feed(fn())
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# torch.profiler keeps only the device records whose times, converted to
# the host's clock, fall inside its window, and the conversion drifts as
# the process ages: late in a long process it drops the first calls'
# kernels. A profile whose launches lack device records is taken again
# with an idle lead of host time before the first call, growing 4x from
# TRACE_LEAD up to TRACE_LEAD_MAX.
TRACE_LEAD, TRACE_LEAD_MAX = 0.005, 0.32
_LAUNCH_APIS = ("Launch", "Memcpy", "Memset")


def _lost_records(prof, DeviceType) -> int:
    """Launches in a profile (kernels, copies, fills) whose device record
    is missing."""
    raw = list(prof.profiler.kineto_results.events())
    done = {e.correlation_id() for e in raw
            if e.device_type() == DeviceType.CUDA}
    return sum(1 for e in raw if e.device_type() == DeviceType.CPU
               and any(k in e.name() for k in _LAUNCH_APIS)
               and e.correlation_id() not in done)


def device_ms(fn, iters: int = 20):
    """(device ms a call, device operations a call, kernel names) of
    ``fn`` by ``torch.profiler`` over ``iters`` calls after one warm-up:
    the card's own kernels, memsets and copies, summed over the calls and
    divided by ``iters``; (None, 0, []) where the trace holds no device
    time. A profile that lost device records is taken again with a longer
    idle lead (TRACE_LEAD)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    lead = TRACE_LEAD
    while True:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(lead)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        if not _lost_records(prof, DeviceType) or lead >= TRACE_LEAD_MAX:
            break
        lead *= 4
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in rows) / iters / 1e3
    count = sum(e.count for e in rows) / iters
    return (total or None), count, sorted(e.key for e in rows)


def bound(nbytes: float, ops: float = 0.0, ops_per_s: float = F32_OPS_S,
          passes: int = 1):
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the
    card's memory rate and ``passes`` x ``ops`` over ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = passes * ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main(run, doc: str) -> None:
    """``python -m ...``: run the driver, print one JSON line a variant."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--check", action="store_true",
                        help="the small check scale")
    args = parser.parse_args()
    result = run(device=args.device, check=args.check)
    for row in result["rows"]:
        print(json.dumps({"experiment": result["experiment"],
                          "device": result["device"], **row}), flush=True)
