"""One run of one benchmark cell on the CUDA card it is started on.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout (``BENCHMARK.json`` there). Sets the cell
up, measures it for ``--seconds`` (``--trace 1``: the profiler over a
short stretch first, and the per-layer metrics), judges what the window
produced against the plain reference, and prints the result as the last
line of standard output, the numbers compared beside their limits as the
last lines of standard error. Without a card, or with fewer than the
cell asks for, it exits 2 and prints no result; with JAX or the JAX
package loaded, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        out = f"nvidia-smi not available ({exc})"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from port_bench import harness

    spec = harness.load_cell("BENCHMARK.json", args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        log(f"no CUDA card for {args.workload} (needs {spec.chips}, "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0})"
            ": no result")
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(f"card: {name}; nvidia-smi name, power.limit: {card_line()}")
    result, checks, dev = harness.run_cell(
        spec, args.seed, args.seconds, bool(args.trace), device, T_START,
        log)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        log(f"forbidden modules loaded in this process: {bad}: no result")
        return 3
    result["device"] = dict(platform="gpu", kind=name, count=spec.chips,
                            **dev)
    result["checks"] = {n: {"value": _number(v), "limit": lim}
                        for n, v, lim in checks}
    for n, v, lim in checks:
        log(f"check {n}: {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
