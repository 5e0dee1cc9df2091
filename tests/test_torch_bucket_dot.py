"""The band product's A/B family (P2c, P2d, P2e) against the experiments'
own Pallas kernels in interpret mode.

experiments/exp_dot.py's ``_call`` (bodies ``_k_prod``, ``_k_lhs_stream``,
``_k_ksplit``, ``_k_nodot``) and ``_call_npair`` run at the experiment's
``EXP_CHECK`` shapes (block_v 128, 8 blocks, 2 a bucket, seed 0), and
experiments/exp_parity.py's ``grid_packed_parity`` at slots 1 and 2; each
module is loaded from its file with the repository root on ``sys.path``.
They are held against :mod:`ska_sdp_func_torch.kernels.bucket_dot` (its
plain versions on CPU tensors) on the same NumPy arrays: f32 at 1e-5 of
max|JAX| (another f32 sum order), the bf16 variants at 1e-3 of max|JAX's
bf16| (each side rounds U to bf16 once; the products are exact in f32).

exp_parity's own script is stale against the JAX package: it calls
``packed_gridder(pplan)``, whose default precision ("high") gives a split
bf16 ``vband`` that ``grid_packed_pallas`` cannot take. Its scenario is
built here with ``precision="highest"``, and the port's driver does the
same; the two drivers' outputs meet on the visited buckets (the TPU
kernel leaves the others undefined).
"""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.experiments import (  # noqa: E402
    exp_parity as port_parity,
)
from ska_sdp_func_torch.kernels import bucket_dot as bd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
BF16_TOL = 1e-3
BLOCK_V, NB, PER = 128, 8, 2


def _load(name):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        f"_experiment_{name}", os.path.join(REPO, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exp_dot():
    return _load("exp_dot")


@pytest.fixture(scope="module")
def exp_parity():
    return _load("exp_parity")


def _dot_inputs():
    """exp_dot.py:236-246 at the check shapes."""
    total = BLOCK_V * NB
    rng = np.random.default_rng(0)
    ubase = rng.standard_normal((16, total)).astype(np.float32)
    vband = rng.standard_normal((total, 128)).astype(np.float32)
    scales = rng.standard_normal((8, total)).astype(np.float32)
    ids = (np.arange(NB) // PER).astype(np.int32)
    uall = np.concatenate([ubase * scales[j:j + 1] for j in range(8)])
    return ids, ubase, vband, scales, uall


# Port variant -> (exp_dot body, its keyword, lhs streamed, bf16).
_VARIANTS = {
    "prod": ("_k_prod", None, False, False),
    "prod_bf16": ("_k_prod", None, False, True),
    "prod_simt": ("_k_prod", None, False, False),
    "lhs_stream": ("_k_lhs_stream", None, True, False),
    "lhs_stream_bf16": ("_k_lhs_stream", None, True, True),
    "ksplit2": ("_k_ksplit", 2, False, False),
    "ksplit2_bf16": ("_k_ksplit", 2, False, True),
    "ksplit4": ("_k_ksplit", 4, False, False),
    "ksplit4_bf16": ("_k_ksplit", 4, False, True),
    "nodot": ("_k_nodot", None, False, False),
    "npair": (None, None, False, False),
    "npair_bf16": (None, None, False, True),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_bucket_dot_matches_exp_dot(exp_dot, variant):
    body, splits, streamed, bf16 = _VARIANTS[variant]
    ids, ubase, vband, scales, uall = _dot_inputs()
    nbk = NB // PER
    jv = jnp.asarray(vband).astype(jnp.bfloat16) if bf16 \
        else jnp.asarray(vband)
    if streamed:
        ju = jnp.asarray(uall).astype(jnp.bfloat16) if bf16 \
            else jnp.asarray(uall)
        jins = (ju, jv)
    else:
        jins = (jnp.asarray(ubase), jv, jnp.asarray(scales))
    if body is None:
        want = exp_dot._call_npair(jnp.asarray(ids), jins, BLOCK_V, nbk, True)
    else:
        kern = getattr(exp_dot, body)
        if splits:
            kern = functools.partial(kern, splits=splits)
        want = exp_dot._call(kern, jnp.asarray(ids), jins, BLOCK_V, nbk,
                             streamed, True)
    want = np.asarray(want)
    tv = torch.as_tensor(vband)
    if bf16:
        tv = tv.bfloat16()
    if streamed:
        tu = torch.as_tensor(uall)
        ins = (tu.bfloat16() if bf16 else tu, tv)
    else:
        ins = (torch.as_tensor(ubase), tv, torch.as_tensor(scales))
    form = variant.replace("_bf16", "")
    before = bd.bucket_dot.launches
    got = bd.bucket_dot(form, torch.as_tensor(ids), ins, nbk, BLOCK_V)
    assert bd.bucket_dot.launches == before
    assert got.shape == want.shape
    tol = BF16_TOL if bf16 else TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def _parity_case(slots_case):
    """Synthetic bands with runs of 1-4 blocks a bucket (block_v 128) and
    unvisited buckets between them."""
    rng = np.random.default_rng(slots_case)
    ids = np.array([0, 0, 0, 2, 2, 3, 5, 5, 5, 5], np.int32)
    total = 128 * ids.size
    return (ids, rng.standard_normal((16, total)).astype(np.float32),
            rng.standard_normal((total, 128)).astype(np.float32),
            rng.standard_normal((8, total)).astype(np.float32), 6,
            np.isin(np.arange(6), ids))


def _parity_check(exp_parity, args_np, visited, block_v, slots):
    ids, ubase, vband, scales, nbk = args_np
    want = np.asarray(exp_parity.grid_packed_parity(
        jnp.asarray(ids), jnp.asarray(ubase), jnp.asarray(vband),
        jnp.asarray(scales), nbk, 128, 4, block_v=block_v, slots=slots,
        interpret=True))[:, visited]
    got = bd.grid_parity(*(torch.as_tensor(a) for a in args_np[:4]), nbk,
                         128, 4, block_v, slots).numpy()
    assert not got[:, ~visited].any()
    np.testing.assert_allclose(got[:, visited], want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("slots", [1, 2])
def test_grid_parity_matches_exp_parity(exp_parity, slots):
    ids, ubase, vband, scales, nbk, visited = _parity_case(slots)
    _parity_check(exp_parity, (ids, ubase, vband, scales, nbk), visited, 128,
                  slots)


@pytest.fixture(scope="module")
def parity_scene(exp_parity):
    """exp_parity's check scenario on both packages, at "highest"."""
    from ska_sdp_func_tpu.parallel.packed import packed_gridder, plan_packed

    plan, uvw, vis = exp_parity._scenario(256, 4, image=256)
    pplan = plan_packed(plan, uvw, block_v=256)
    g = packed_gridder(pplan, precision="highest")
    vre, vim = g.sort(jnp.asarray(vis))
    scales = jnp.concatenate([g.wk_t * vre[None, :], g.wk_t * vim[None, :]])
    jax_ops = tuple(np.asarray(a) for a in (g.block_bucket, g.ubase,
                                            g.vband, scales))
    port_ops = port_parity.operands("cpu", check=True)
    return (jax_ops + (pplan.num_buckets,), np.asarray(g.visited).astype(bool),
            port_ops)


@pytest.mark.parametrize("slots", [1, 2])
def test_grid_parity_matches_exp_parity_scenario(exp_parity, parity_scene,
                                                 slots):
    """The experiment's function on its own (check) scenario, and the
    port's driver operands against JAX's."""
    jax_args, visited, port_ops = parity_scene
    _parity_check(exp_parity, jax_args, visited, 256, slots)
    for name, a in zip(("ids", "ubase", "vband", "scales"), jax_args[:4]):
        b = port_ops[name].numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-6 * max(np.abs(a).max(), 1),
                                   err_msg=name)
    np.testing.assert_array_equal(port_ops["visited"].numpy(), visited)
