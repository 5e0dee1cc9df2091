"""Readings that set a cell's limits: the checked numbers of sound runs
and of the control, many seeds in one process.

    python3 -m port_bench.control --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3

Each seed is one whole run of the cell (set-up, a window of
``--seconds`` at the cell's own size and load, the check), as the
benchmark makes it; the control runs are the same with the port's bf16
mode (``fast=True``), the precision below the configuration's. One JSON
line a seed on standard output. The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
import time

import torch

from port_bench import harness


def _free_program_caches():
    from ska_sdp_func_torch.parallel import streaming

    streaming._stream_engine.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.load_cell("BENCHMARK.json", args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, fast in runs:
        t0 = time.perf_counter()
        result, checks, dev = harness.run_cell(
            spec, seed, args.seconds, False, device, t0,
            lambda m: print(m, file=sys.stderr, flush=True), fast=fast)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, fast=fast,
            correct=result["correct"], attempted=result["attempted"],
            checks={n: v for n, v, _ in checks},
            limits={n: lim for n, _, lim in checks},
            metrics={k: m["value"] for k, m in result["metrics"].items()},
            memory_peak_bytes=dev["memory_peak_bytes"],
            seconds=time.perf_counter() - t0)), flush=True)
        _free_program_caches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
