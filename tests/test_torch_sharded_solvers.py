"""The port's packed-path solver and the multi-process checkpointer on
gloo process groups of 2 and 4 ranks: ``major_cycle_imager(
bucketed=True, mesh=)`` (each rank passes the whole ``vis`` and ``uvw``)
against JAX's single-device solve and the port's, and the
``SolverCheckpointer`` in a process group.

Scenario: the first 148 rows of tests/test_packed_driver.py's scenario,
the visibilities of tests/test_torch_major_cycle.py's one-source sky (the
port's packed degrid), weights from seed 8; the plans padded for 2 and 4
ranks end in pad blocks and a task straddles two ranks. The ranks run in
tests/_torch_dist_workers.py; the JAX reference runs here while they do.

Tolerance: the model at atol 2e-4 of JAX's and the port's single-device
solves. Every rank returns the same bits.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import _torch_dist_workers as workers  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ska_sdp_func_torch.pipeline import major_cycle_imager  # noqa: E402
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack  # noqa
from ska_sdp_func_tpu.pipeline import major_cycle as jmc  # noqa: E402

GROUP_LIMIT = 110.0
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    g = workers.Groups(tmp_path_factory.mktemp("sharded_solvers"),
                       {w: ("packed_solve", "checkpoint") for w in WORLDS},
                       GROUP_LIMIT)
    yield g
    g.close()


def _results(groups, world):
    try:
        return groups.results(world)
    except RuntimeError as err:
        pytest.fail(str(err))


@pytest.fixture(scope="module")
def models(groups):
    """JAX's and the port's single-device models (computed while the
    ranks run)."""
    uvw, vis, weights, plan = workers.solver_case()
    sc = workers.scenario
    jplan = j_plan_wstack(uvw, sc.FREQ0, sc.DFREQ, sc.NUM_CHAN,
                          sc.IMAGE_SIZE, **sc.PARAMS)
    jres = jmc.major_cycle_imager(jplan, jnp.asarray(vis), jnp.asarray(uvw),
                                  weights=jnp.asarray(weights),
                                  **workers.SOLVE)
    tres = major_cycle_imager(plan, vis, uvw, weights=weights, device="cpu",
                              **workers.SOLVE)
    return [np.asarray(jres.model), tres.model.numpy()]


def same_on_every_rank(results, key):
    for r in results:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0][key]


@pytest.mark.parametrize("world", WORLDS)
def test_packed_solve_sharded(groups, models, world):
    """major_cycle_imager(bucketed=True, mesh=): the model at atol 2e-4 of
    JAX's and the port's single-device solves, the same bits on every
    rank (the reduced images are, so every rank's minor cycle takes the
    same components)."""
    results = _results(groups, world)
    model = same_on_every_rank(results, "solve_packed_model")
    same_on_every_rank(results, "solve_packed_residual")
    same_on_every_rank(results, "solve_packed_history")
    assert np.abs(model).max() > 0.5
    for want in models:
        np.testing.assert_allclose(model, want, atol=2e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_checkpointer_multi_rank(groups, world):
    """Every rank saves steps 1-3 (its own rank in the meta): rank 0 alone
    writes, pruning keeps max_to_keep = 2 steps, and every rank restores
    the latest step's bits (rank 0's meta)."""
    base = np.arange(16, dtype=np.float32).reshape(4, 4)
    for r in _results(groups, world):
        np.testing.assert_array_equal(r["ckpt_steps"], [2, 3])
        assert int(r["ckpt_meta_rank"]) == 0
        assert int(r["ckpt_cycle"]) == 3
        np.testing.assert_array_equal(r["ckpt_model"], 3 * base)
        np.testing.assert_array_equal(r["ckpt_residual"], -3 * base)
