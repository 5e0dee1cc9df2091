"""A configuration, a traffic mix and a per-layer metric added as new
files, with new BENCHMARK.json entries only, are found and run."""

import json
import os
import shutil
import time

import pytest
import torch

from _tiny import BENCH, TINY_CONFIG
from port_bench import harness


def _new_cell(tmp_path):
    base = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "metrics"):
        (base / sub).mkdir(parents=True)
    bench = json.load(open(BENCH))
    root = os.path.dirname(BENCH)
    cfg = json.load(open(os.path.join(root, "port_bench/configs/"
                                      "packed_low.json")))
    cfg.update(TINY_CONFIG["packed_low"], name="packed_tiny")
    (base / "configs" / "packed_tiny.json").write_text(json.dumps(cfg))
    traffic = json.load(open(os.path.join(root, "port_bench/traffic/"
                                          "packed_cycle.json")))
    traffic["check"]["pixels"] = 32
    traffic["trace"] = {"warmup_steps": 1, "active_steps": 1}
    (base / "traffic" / "cycle_tiny.json").write_text(json.dumps(traffic))
    (base / "metrics" / "answer.tiny.py").write_text(
        "def read(ctx):\n    return 42.0 + len(ctx['steps']) * 0\n")
    (base / "metrics" / "silent.py").write_text(
        "def read(ctx):\n    return None\n")
    for sub in ("metrics", "traffic", "configs"):
        for name in os.listdir(os.path.join(root, "port_bench", sub)):
            if name.endswith((".py", ".json")):
                shutil.copy(os.path.join(root, "port_bench", sub, name),
                            base / sub / name)
    bench["configs"].append(dict(
        name="packed_tiny", source="a test", reduced=[], why="a test",
        file="port_bench/configs/packed_tiny.json"))
    bench["workloads"].append(dict(
        name="packed_tiny.cycle", config="packed_tiny", traffic="cycle_tiny",
        chips=1, why="a test"))
    bench["per_layer"] += [
        dict(name="answer.tiny", unit="ops", better="higher",
             source="program_counter", layer="drivers", moves="mvis_s",
             workloads=["packed_tiny.cycle"]),
        dict(name="silent", unit="ops", better="higher",
             source="program_counter", layer="drivers", moves="mvis_s",
             workloads=["packed_tiny.cycle"])]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return str(path), str(base)


def test_new_files_are_found(tmp_path):
    path, base = _new_cell(tmp_path)
    spec = harness.load_cell(path, "packed_tiny.cycle", base=base)
    assert spec.config["image_size"] == 256
    assert spec.traffic["check"]["pixels"] == 32
    assert spec.step_module.__name__ == "port_bench.steps.packed_cycle"
    names = [m["name"] for m in spec.per_layer]
    assert "answer.tiny" in names and "silent" in names
    assert "K3_roofline" not in names          # another cell's
    assert [m["name"] for m in spec.end_to_end] == [
        "mvis_s", "step_p95_ms", "setup_s"]


def test_new_cell_runs_and_reports_its_metric(tmp_path):
    path, base = _new_cell(tmp_path)
    spec = harness.load_cell(path, "packed_tiny.cycle", base=base)
    result, checks, dev = harness.run_cell(
        spec, 7, 0.2, True, torch.device("cpu"), time.perf_counter(),
        lambda msg: None)
    assert result["correct"], checks
    assert result["metrics"]["answer.tiny"] == {"value": 42.0,
                                                "unit": "ops"}
    assert "silent" not in result["metrics"]


def test_existing_cells_unchanged_by_the_new_entries(tmp_path):
    path, base = _new_cell(tmp_path)
    for w in ("packed_cycle", "stream_ingest", "stream_predict"):
        a = harness.load_cell(BENCH, w)
        b = harness.load_cell(path, w, base=base)
        assert a.config == b.config
        assert [m["name"] for m in a.per_layer] == \
            [m["name"] for m in b.per_layer if m["name"] != "silent"]


def test_per_layer_metric_without_workloads_is_refused(tmp_path):
    path, base = _new_cell(tmp_path)
    bench = json.load(open(path))
    del bench["per_layer"][-1]["workloads"]
    with open(path, "w") as f:
        json.dump(bench, f)
    with pytest.raises(KeyError, match="silent"):
        harness.load_cell(path, "packed_tiny.cycle", base=base)
