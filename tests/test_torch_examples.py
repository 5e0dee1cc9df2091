"""The port's Quick-start demos (``ska_sdp_func_torch.examples``), each
run on the CPU and held to the oracle it prints.

The demos' modules are held against the JAX package in the other
``tests/test_torch_*.py`` files; the JAX scripts themselves take 7 s to
over 100 s on an 8-core CPU host, so only the cheapest,
``subgrid_gridding``, is also held against the JAX script's own
printout. Cuts in size, each to
keep the file within seconds:

- ``packed_imaging_demo``: 128^2 image (the script: 256^2; the sources
  sit at the same offsets from the centre), 300 rows (600), 3 major
  cycles (4), one timed pass of the stage report (3);
- ``streaming_ingest_demo``: 256 rows in 2 chunks (384 in 3);
- ``full_pipeline_demo``: 3 major cycles (4);
- ``subgrid_gridding``: none;
- ``imaging_demo`` (tests/test_torch_examples_mesh.py, a file of its
  own so that it runs beside this one): 200 rows (600), 3 major cycles
  (5), one gloo rank.

Tolerances: the demos' own (``FLUX_TOL`` 5 % of each source's flux;
``PREDICT_TOL`` 1e-4 and ``PEAK_TOL`` 5 % for the stream;
``ADJOINT_TOL`` 1e-5).
"""

import importlib
import importlib.util
import os
import re

import pytest
import torch
import torch.distributed as dist

from ska_sdp_func_torch import examples
from ska_sdp_func_torch.examples import (
    full_pipeline_demo,
    packed_imaging_demo,
    streaming_ingest_demo,
    subgrid_gridding,
)
from ska_sdp_func_torch.parallel.packed import GRID_STAGES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the demos make many small tensor operations,
    which several threads a worker slow down under the suite's parallel
    workers (the full pipeline demo, on an 8-core CPU host: 220 s under
    six workers against 4 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _met(result):
    for check in result["oracle"]["checks"]:
        assert check["ok"], check
    assert result["oracle"]["ok"]


def test_packed_imaging_demo():
    r = packed_imaging_demo.run(device="cpu", image_size=128, rows=300,
                                cycles=3, timing_iters=1)
    _met(r)
    assert len(r["residual_peaks"]) == 3
    assert r["residual_peaks"] == sorted(r["residual_peaks"], reverse=True)
    for (_, _, flux), got in zip(r["sources"], r["fluxes"]):
        assert abs(got - flux) <= packed_imaging_demo.FLUX_TOL * flux
    assert tuple(r["stages"]) == GRID_STAGES
    assert all(v >= 0 for v in r["stages"].values())
    assert r["report"].startswith("# image 128^2, subgrid 128")


def test_streaming_ingest_demo():
    r = streaming_ingest_demo.run(device="cpu", rows=256)
    _met(r)
    assert r["counters"] == [256 * 2, 0, 0]
    assert len(r["chunks"]) == 2
    assert r["predict_err"] <= streaming_ingest_demo.PREDICT_TOL
    for ((_, flux), peak) in zip(r["sources"], r["peaks"]):
        assert abs(peak - flux) <= streaming_ingest_demo.PEAK_TOL * flux


def test_full_pipeline_demo():
    r = full_pipeline_demo.run(device="cpu", n_major=3)
    _met(r)
    assert 0 < r["flagged"] < 0.05
    assert len(r["peak_history"]) == 3
    for (_, _, flux), got in zip(r["sources"], r["fluxes"]):
        assert abs(got - flux) <= full_pipeline_demo.FLUX_TOL * flux


def _jax_script_printout(capsys):
    """examples/subgrid_gridding.py's own printout, run in this process
    (the JAX package on the CPU)."""
    spec = importlib.util.spec_from_file_location(
        "jax_subgrid_gridding",
        os.path.join(REPO, "examples", "subgrid_gridding.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    capsys.readouterr()
    script.main()
    return capsys.readouterr().out


def test_subgrid_gridding_against_the_jax_script(capsys):
    """The adjoint identity, and both of its sides and the w-plane
    counters against the JAX script's printout on the same seeded
    inputs (its complex64 sums printed to 6 decimals: 1e-5 relative)."""
    pytest.importorskip("jax")
    r = subgrid_gridding.run(device="cpu")
    _met(r)
    out = _jax_script_printout(capsys)
    lhs, rhs = (complex(m) for m in re.findall(
        r"= ([-+]?[0-9.]+[-+][0-9.]+j)", out))
    assert abs(r["lhs"] - lhs) <= 1e-5 * abs(lhs)
    assert abs(r["rhs"] - rhs) <= 1e-5 * abs(rhs)
    planes = re.search(r"\(degrid, grid\): (\d+), (\d+)", out).groups()
    assert r["w_planes"] == tuple(int(p) for p in planes)


def test_subgrid_gridding_main_prints_as_the_script(capsys):
    assert subgrid_gridding.main(device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("adjointness: <y, Ax> = ")
    assert lines[1].startswith("w-planes processed (degrid, grid): ")
    assert lines[2].startswith("oracle: adjointness, rel ")
    assert lines[2].endswith(": ok")


@pytest.mark.parametrize("name", examples.DEMOS)
def test_demos_default_to_the_card(name):
    """``device=None`` is the CUDA card: on a host without one every
    demo raises before it plans anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default works")
    demo = importlib.import_module(f"ska_sdp_func_torch.examples.{name}")
    with pytest.raises((RuntimeError, AssertionError)):
        demo.run()
    assert not dist.is_initialized()


def test_demos_are_listed():
    found = sorted(f[:-3] for f in os.listdir(os.path.dirname(
        examples.__file__)) if f.endswith(".py") and f != "__init__.py")
    assert found == sorted(examples.DEMOS)
    assert sorted(examples.DEMOS) == sorted(
        f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
        if f.endswith(".py"))
    assert all(callable(importlib.import_module(
        f"ska_sdp_func_torch.examples.{n}").main) for n in examples.DEMOS)
