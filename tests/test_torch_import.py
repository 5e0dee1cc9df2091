"""The PyTorch port imports neither jax nor the JAX package.

Runs in a subprocess: this test process already imported jax through
conftest.py.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Fails when jax, jaxlib, the JAX package or the JAX harnesses (bench.py,
# experiments/) were imported.
CHECK = (
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
    "             ('jax', 'jaxlib', 'ska_sdp_func_tpu', 'bench',\n"
    "              'experiments'))\n"
    "assert not bad, bad\n")

MODULES = [
    "ska_sdp_func_torch",
    "ska_sdp_func_torch.clean",
    "ska_sdp_func_torch.examples",
    "ska_sdp_func_torch.examples.full_pipeline_demo",
    "ska_sdp_func_torch.examples.imaging_demo",
    "ska_sdp_func_torch.examples.packed_imaging_demo",
    "ska_sdp_func_torch.examples.streaming_ingest_demo",
    "ska_sdp_func_torch.examples.subgrid_gridding",
    "ska_sdp_func_torch.experiments",
    "ska_sdp_func_torch.experiments._common",
    "ska_sdp_func_torch.experiments.exp_dot",
    "ska_sdp_func_torch.experiments.exp_overlap",
    "ska_sdp_func_torch.experiments.exp_parity",
    "ska_sdp_func_torch.experiments.exp_place_dma",
    "ska_sdp_func_torch.experiments.exp_prep",
    "ska_sdp_func_torch.experiments.rooflines",
    "ska_sdp_func_torch.clean.hogbom",
    "ska_sdp_func_torch.clean.ms_clean",
    "ska_sdp_func_torch.fourier_transforms",
    "ska_sdp_func_torch.fourier_transforms.fft",
    "ska_sdp_func_torch.fourier_transforms.pswf",
    "ska_sdp_func_torch.fourier_transforms.swiftly",
    "ska_sdp_func_torch.station_beam",
    "ska_sdp_func_torch.station_beam.element",
    "ska_sdp_func_torch.station_beam.station",
    "ska_sdp_func_torch.grid_data",
    "ska_sdp_func_torch.grid_data.custom",
    "ska_sdp_func_torch.grid_data.direct",
    "ska_sdp_func_torch.grid_data.es_fft",
    "ska_sdp_func_torch.grid_data.es_fft_packed",
    "ska_sdp_func_torch.grid_data.es_params",
    "ska_sdp_func_torch.grid_data.grid_correct",
    "ska_sdp_func_torch.grid_data.gridder_utils",
    "ska_sdp_func_torch.grid_data.kernels",
    "ska_sdp_func_torch.grid_data.wtower",
    "ska_sdp_func_torch.grid_data.wtower_height",
    "ska_sdp_func_torch.kernels",
    "ska_sdp_func_torch.kernels._build",
    "ska_sdp_func_torch.kernels.band_tap",
    "ska_sdp_func_torch.kernels.bucket_dot",
    "ska_sdp_func_torch.kernels.fold",
    "ska_sdp_func_torch.kernels.fused_tap",
    "ska_sdp_func_torch.kernels.overlap",
    "ska_sdp_func_torch.kernels.packed_tap",
    "ska_sdp_func_torch.kernels.place",
    "ska_sdp_func_torch.kernels.prep_variants",
    "ska_sdp_func_torch.kernels.read_probe",
    "ska_sdp_func_torch.kernels.sparse_tap",
    "ska_sdp_func_torch.kernels.stream_prep",
    "ska_sdp_func_torch.kernels.tower_tap",
    "ska_sdp_func_torch.kernels.dense_tap",
    "ska_sdp_func_torch.native",
    "ska_sdp_func_torch.numeric_functions",
    "ska_sdp_func_torch.numeric_functions.fft_convolution",
    "ska_sdp_func_torch.parallel",
    "ska_sdp_func_torch.parallel.bucketed",
    "ska_sdp_func_torch.parallel.convert",
    "ska_sdp_func_torch.parallel.mesh",
    "ska_sdp_func_torch.parallel.packed",
    "ska_sdp_func_torch.parallel.streaming",
    "ska_sdp_func_torch.parallel.swiftly_dist",
    "ska_sdp_func_torch.parallel.wstack",
    "ska_sdp_func_torch.pipeline",
    "ska_sdp_func_torch.pipeline.checkpoint",
    "ska_sdp_func_torch.pipeline.fista",
    "ska_sdp_func_torch.pipeline.ingest",
    "ska_sdp_func_torch.pipeline.major_cycle",
    "ska_sdp_func_torch.utility",
    "ska_sdp_func_torch.utility.constants",
    "ska_sdp_func_torch.utility.data_model",
    "ska_sdp_func_torch.utility.errors",
    "ska_sdp_func_torch.utility.logging",
    "ska_sdp_func_torch.utility.profiling",
    "ska_sdp_func_torch.utility.sky_coord",
    "ska_sdp_func_torch.utility.tensors",
    "ska_sdp_func_torch.utility.timers",
    "ska_sdp_func_torch.visibility",
    "ska_sdp_func_torch.visibility.dft",
    "ska_sdp_func_torch.visibility.flagger",
    "ska_sdp_func_torch.visibility.opt_weighting",
    "ska_sdp_func_torch.visibility.phase_rotate",
    "ska_sdp_func_torch.visibility.tiled_functions",
    "ska_sdp_func_torch.visibility.weighting",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"{CHECK}"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_planning_imports_no_jax():
    """Planning drives the native host runtime; it must not pull the JAX
    package in either."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from ska_sdp_func_torch.parallel import plan_packed, plan_wstack\n"
        "rng = np.random.default_rng(1)\n"
        "uvw = rng.uniform(-1, 1, (64, 3)) * [30000.0, 30000.0, 200.0]\n"
        "p = plan_wstack(uvw, 3e8, 3e6, 2, 256, 128, 0.002, 50.0)\n"
        "pp = plan_packed(p, uvw)\n"
        "assert pp.arrays['valid'].sum() == 128\n"
        f"{CHECK}"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names neither jax nor the JAX package in any import,
    and without a CUDA device it exits non-zero before printing a result,
    having imported neither."""
    import ast

    path = os.path.join(REPO, "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "ska_sdp_func_torch" in roots
    assert not roots & {"jax", "jaxlib", "ska_sdp_func_tpu", "bench",
                        "experiments"}
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run")
    code = (
        "import runpy, sys\n"
        "try:\n"
        f"    runpy.run_path({path!r}, run_name='__main__')\n"
        "    code = 0\n"
        "except SystemExit as e:\n"
        "    code = e.code\n"
        f"{CHECK}"
        "print('exit', code)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "exit 1"
    assert "no CUDA device" in proc.stderr


def test_sharded_entry_points_import_no_jax(tmp_path):
    """The sharded entry points (ROADMAP Queue 1 item 15b) import and run
    without the JAX package: a one-rank gloo group grids and degrids
    through the block-sharded packed drivers."""
    store = str(tmp_path / "store")
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch.distributed as dist\n"
        "from ska_sdp_func_torch.parallel import (\n"
        "    StreamingDegridder, StreamingGridder,\n"
        "    degrid_all_packed_sharded, grid_all_bucketed_sharded,\n"
        "    grid_all_packed_sharded, make_mesh, plan_packed, plan_wstack)\n"
        "from ska_sdp_func_torch.pipeline import (\n"
        "    SolverCheckpointer, dirty_and_psf, fista_imager,\n"
        "    ingest_flag_and_weight_sharded, major_cycle_imager)\n"
        "rng = np.random.default_rng(1)\n"
        "uvw = rng.uniform(-1, 1, (64, 3)) * [30000.0, 30000.0, 200.0]\n"
        "vis = (rng.standard_normal((64, 2))\n"
        "       + 1j * rng.standard_normal((64, 2))).astype(np.complex64)\n"
        "p = plan_wstack(uvw, 3e8, 3e6, 2, 256, 128, 0.002, 50.0)\n"
        "pp = plan_packed(p, uvw)\n"
        f"mesh = make_mesh(1, device='cpu', rank=0,\n"
        f"                 init_method='file://' + {store!r})\n"
        "img = grid_all_packed_sharded(pp, vis, mesh, device='cpu')\n"
        "pred = degrid_all_packed_sharded(pp, img, mesh, device='cpu')\n"
        "dist.destroy_process_group()\n"
        "assert tuple(img.shape) == (256, 256)\n"
        "assert tuple(pred.shape) == (64, 2)\n"
        f"{CHECK}"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
