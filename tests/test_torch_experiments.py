"""The experiment drivers (``ska_sdp_func_torch.experiments``) at their
check scale on the CPU, and exp_place_dma (P2f) against its own Pallas
kernel.

experiments/exp_place_dma.py's ``place_dma`` runs in interpret mode at its
``EXP_CHECK`` scale (N 3000, cap 4096, bv 128, 17 buckets, seed 2) on the
port driver's layout (its sources padded by ``bv``, as the experiment pads
them); K5's plain version must equal it, and the experiment's NumPy
oracle, bit for bit. Every driver's ``run(device="cpu", check=True)``
holds each variant against its plain version and reports no time.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from ska_sdp_func_torch import experiments  # noqa: E402
from ska_sdp_func_torch.experiments import exp_place_dma  # noqa: E402
from ska_sdp_func_torch.kernels import place  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_place_dma():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "_experiment_exp_place_dma",
        os.path.join(REPO, "experiments", "exp_place_dma.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.place_dma


def test_place_matches_exp_place_dma(jax_place_dma):
    ops = exp_place_dma.operands("cpu", check=True)
    bv, cap = ops["bv"], ops["cap"]
    assert (cap, bv) == exp_place_dma.CHECK_SCALE[1:3]
    pad = lambda x: np.concatenate([x, np.zeros(bv, x.dtype)])  # noqa: E731
    want = jax_place_dma(jnp.asarray(ops["src0"].numpy()),
                         jnp.asarray(ops["vcnt"].numpy()),
                         *(jnp.asarray(pad(p.numpy()))
                           for p in ops["payloads"]), bv, cap,
                         interpret=True)
    got = place.place_stream(ops["src0"], ops["vcnt"], ops["payloads"], bv,
                             cap)
    counts, edges, pad_off, payloads = ops["host"]
    oracle = exp_place_dma.oracle(counts, edges, pad_off, payloads, cap)
    for g, w, o in zip(got, want, oracle):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      o.view(np.int32))


@pytest.mark.parametrize("driver", experiments.drivers(),
                         ids=experiments.NAMES)
def test_driver_check_scale_on_cpu(driver):
    result = driver.run(device="cpu", check=True)
    assert result["experiment"] == driver.NAME
    assert result["device"] == "cpu"
    assert result["rows"]
    for row in result["rows"]:
        assert row["rel_err"] <= 1e-5, row
        assert row["bound_ms"] > 0 and row["bound_by"] in ("bytes",
                                                           "operations")
        assert "ms" not in row and "plain_ms" not in row
