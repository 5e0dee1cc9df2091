"""The FISTA solver (ska_sdp_func_torch.pipeline.fista) against JAX on
the small packed scenario: a two-point sky predicted with JAX's packed
degrid, solved by both packages.

Tolerances: model within 1e-4 of max|model| and each iteration's
residual norm within 1e-4 relative (the packed grid/degrid at f32
reassociation level, and the soft threshold's support, feed every
iteration); the power iteration's operator norm within 1e-5 relative
(both packages draw its start vector from ``np.random.default_rng(0)``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_dist_workers import AxisMesh  # noqa: E402

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    make_inputs, two_point_image  # noqa: E402
from ska_sdp_func_torch.parallel import packed_gridder, plan_packed  # noqa
from ska_sdp_func_torch.parallel import plan_wstack as t_plan_wstack  # noqa
from ska_sdp_func_torch.pipeline import fista as tf  # noqa: E402
from ska_sdp_func_torch.pipeline import fista_imager  # noqa: E402
from ska_sdp_func_torch.pipeline.major_cycle import _mask_border  # noqa
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
)
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack  # noqa
from ska_sdp_func_tpu.parallel.packed import (  # noqa: E402
    packed_gridder as j_gridder,
    plan_packed as j_plan_packed,
)
from ska_sdp_func_tpu.pipeline import fista as jf  # noqa: E402
from ska_sdp_func_tpu.pipeline.major_cycle import \
    _mask_border as j_mask  # noqa: E402


@pytest.fixture(scope="module")
def scene():
    uvw, _ = make_inputs()
    jplan = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    vis = np.asarray(j_gridder(j_plan_packed(jplan, uvw)).degrid(
        jnp.asarray(two_point_image())))
    tplan = t_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    weights = np.random.default_rng(9).uniform(0.5, 1.5, vis.shape)
    return dict(uvw=uvw, vis=vis, jplan=jplan, tplan=tplan, weights=weights)


def test_operator_norm_matches_jax(scene):
    n = IMAGE_SIZE
    jg = j_gridder(j_plan_packed(scene["jplan"], scene["uvw"]))
    tg = packed_gridder(plan_packed(scene["tplan"], scene["uvw"]),
                        device="cpu")
    want = jf._operator_norm(jg, j_mask(jnp.ones((n, n), jnp.float32), 32),
                             n, n_iter=3)
    got = tf._operator_norm(tg, _mask_border(torch.ones((n, n)), 32), n,
                            n_iter=3)
    assert abs(got - want) <= 1e-5 * want


def test_soft_threshold_matches_jax():
    x = np.random.default_rng(3).standard_normal((16, 16)).astype(np.float32)
    want = np.asarray(jf._soft_threshold(jnp.asarray(x), 0.5))
    got = tf._soft_threshold(torch.as_tensor(x), 0.5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_fista_matches_jax(scene, weighted):
    w = scene["weights"] if weighted else None
    kw = dict(n_iter=4, lam_frac=2e-3)
    jres = jf.fista_imager(scene["jplan"], jnp.asarray(scene["vis"]),
                           jnp.asarray(scene["uvw"]),
                           weights=None if w is None else jnp.asarray(w),
                           **kw)
    tres = fista_imager(scene["tplan"], scene["vis"], scene["uvw"],
                        weights=w, device="cpu", **kw)
    j_model = np.asarray(jres.model)
    t_model = tres.model.numpy()
    assert t_model.dtype == np.float32 and t_model.shape == j_model.shape
    assert np.abs(t_model - j_model).max() <= 1e-4 * np.abs(j_model).max()
    np.testing.assert_allclose(tres.residual_norm, jres.residual_norm,
                               rtol=1e-4)
    assert tres.residual_norm[-1] < tres.residual_norm[0]


def test_fista_mesh_raises(scene):
    """The block-sharded operators FISTA runs on a mesh split the plan's
    blocks evenly over the ranks: a plan not padded for the mesh raises
    JAX's SdpInvalidArgumentError (packed.py:1174-1183), and a mesh
    without the rows axis raises before any collective."""
    pplan = plan_packed(scene["tplan"], scene["uvw"])
    size = next(k for k in range(2, 64) if pplan.num_blocks % k)
    g = packed_gridder(pplan, device="cpu")
    vre, vim = g.sort(scene["vis"])
    with pytest.raises(SdpInvalidArgumentError,
                       match=f"pad_blocks_to={size}"):
        g.grid_sorted_sharded(vre, vim, AxisMesh(size))
    with pytest.raises(SdpInvalidArgumentError, match="not divisible"):
        g.degrid_sorted_sharded(two_point_image(), AxisMesh(size))
    with pytest.raises(SdpInvalidArgumentError, match="no axis 'rows'"):
        fista_imager(scene["tplan"], scene["vis"], scene["uvw"], n_iter=1,
                     mesh=AxisMesh(2, axis_name="cols"), device="cpu")
