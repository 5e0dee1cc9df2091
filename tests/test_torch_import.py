"""The PyTorch port imports neither jax nor the JAX package.

Runs in a subprocess: this test process already imported jax through
conftest.py.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Fails when jax, jaxlib or the JAX package was imported.
CHECK = (
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
    "             ('jax', 'jaxlib', 'ska_sdp_func_tpu'))\n"
    "assert not bad, bad\n")

MODULES = [
    "ska_sdp_func_torch",
    "ska_sdp_func_torch.clean",
    "ska_sdp_func_torch.clean.hogbom",
    "ska_sdp_func_torch.fourier_transforms",
    "ska_sdp_func_torch.fourier_transforms.fft",
    "ska_sdp_func_torch.fourier_transforms.pswf",
    "ska_sdp_func_torch.grid_data",
    "ska_sdp_func_torch.grid_data.es_fft",
    "ska_sdp_func_torch.grid_data.es_fft_packed",
    "ska_sdp_func_torch.grid_data.es_params",
    "ska_sdp_func_torch.grid_data.grid_correct",
    "ska_sdp_func_torch.grid_data.gridder_utils",
    "ska_sdp_func_torch.grid_data.kernels",
    "ska_sdp_func_torch.grid_data.wtower",
    "ska_sdp_func_torch.kernels",
    "ska_sdp_func_torch.kernels._build",
    "ska_sdp_func_torch.kernels.band_tap",
    "ska_sdp_func_torch.kernels.fold",
    "ska_sdp_func_torch.kernels.fused_tap",
    "ska_sdp_func_torch.kernels.packed_tap",
    "ska_sdp_func_torch.kernels.place",
    "ska_sdp_func_torch.kernels.stream_prep",
    "ska_sdp_func_torch.kernels.tower_tap",
    "ska_sdp_func_torch.kernels.dense_tap",
    "ska_sdp_func_torch.native",
    "ska_sdp_func_torch.numeric_functions",
    "ska_sdp_func_torch.numeric_functions.fft_convolution",
    "ska_sdp_func_torch.parallel",
    "ska_sdp_func_torch.parallel.bucketed",
    "ska_sdp_func_torch.parallel.convert",
    "ska_sdp_func_torch.parallel.packed",
    "ska_sdp_func_torch.parallel.streaming",
    "ska_sdp_func_torch.parallel.wstack",
    "ska_sdp_func_torch.pipeline",
    "ska_sdp_func_torch.pipeline.major_cycle",
    "ska_sdp_func_torch.utility",
    "ska_sdp_func_torch.utility.constants",
    "ska_sdp_func_torch.utility.errors",
    "ska_sdp_func_torch.utility.tensors",
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
