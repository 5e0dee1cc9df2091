"""The shape of a run's result, the look for a card, and the modules the
benchmark's process may hold."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from _tiny import BENCH, ROOT, tiny_spec
from port_bench import harness

KEYS = ["correct", "attempted", "failed", "metrics"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_shape(trace):
    spec = tiny_spec("packed_cycle")
    result, checks, dev = harness.run_cell(
        spec, 99, 0.2, trace, torch.device("cpu"), time.perf_counter(),
        lambda m: None)
    assert list(result)[:4] == KEYS
    assert isinstance(result["correct"], bool)
    assert result["attempted"] >= 1 and result["failed"] == 0
    wanted = spec.per_layer if trace else spec.end_to_end
    names = {m["name"]: m["unit"] for m in wanted}
    for name, m in result["metrics"].items():
        assert m == {"value": m["value"], "unit": names[name]}
        assert isinstance(m["value"], float)
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(dev)
    else:
        assert set(result["metrics"]) == set(names)
    assert "memory_peak_bytes" in dev
    assert [c[0] for c in checks] == ["degrid_err", "grid_err"]
    json.dumps(result)


def _run_module(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "stream_predict", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0", *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_no_card_no_result():
    out = _run_module(ROOT)
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's own
    files (no program) exits non-zero with no result."""
    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_module(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("modules,bad", [
    (["jax", "numpy"], ["jax"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax.numpy", "jaxlib.xla_client"]),
    (["ska_sdp_func_tpu.parallel"], ["ska_sdp_func_tpu.parallel"]),
    (["ska_sdp_func_torch", "ska_sdp_func_torch.parallel"], []),
    (["jaxtyping", "benchmark", "chip_smoke_x", "flax"], ["flax"]),
    (["bench", "chip_smoke"], ["bench", "chip_smoke"]),
])
def test_forbidden_modules_compare_whole_names(modules, bad):
    assert harness.forbidden_modules(modules) == bad


def test_benchmark_imports_no_jax():
    """Every module the benchmark's process imports (the run, the
    harness, each step kind and metric reader, and the program they
    drive), top-level names compared whole."""
    code = (
        "import sys, glob, os\n"
        "import port_bench.run\n"
        "from port_bench import harness\n"
        "for w in ('packed_cycle', 'stream_ingest', 'stream_predict'):\n"
        "    spec = harness.load_cell('BENCHMARK.json', w)\n"
        "    for m in spec.end_to_end + spec.per_layer:\n"
        "        harness.metric_reader(spec.base, m['name'])\n"
        "import ska_sdp_func_torch.kernels\n"
        "print(harness.forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\nimport port_bench.reference\n"
            "import port_bench.metrics._roofline\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('ska_sdp_func')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
