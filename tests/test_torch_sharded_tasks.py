"""The port's task-driver solver on gloo process groups of 2 and 4
ranks: ``major_cycle_imager(mesh=)`` (``bucketed=False``, the default)
and ``dirty_and_psf(mesh=)``, each rank passing the whole ``vis`` and
``uvw`` and working on its padded block of rows, against JAX's
single-device solve and the port's.

Scenario: tests/test_parallel.py's (128^2, 32^2 sub-grids, 2 channels,
complex128), its first 98 rows (4 ranks pad them by 2). The ranks run
in tests/_torch_dist_workers.py; the JAX reference runs here while they
do.

Tolerances: JAX's sharded test (tests/test_pipeline.py:123-137): model
and residual at atol 1e-6 of JAX's and the port's single-device solves;
``dirty_and_psf``'s images at atol 1e-6 of the port's (held against
JAX's in tests/test_torch_major_cycle.py). Every rank returns the same
bits.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import _torch_dist_workers as workers  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_sharded_solvers import same_on_every_rank  # noqa: E402

from ska_sdp_func_torch.pipeline import (  # noqa: E402
    dirty_and_psf,
    major_cycle_imager,
)
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack  # noqa
from ska_sdp_func_tpu.pipeline import major_cycle as jmc  # noqa: E402

GROUP_LIMIT = 110.0
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    g = workers.Groups(tmp_path_factory.mktemp("sharded_tasks"),
                       {w: ("task_solve",) for w in WORLDS}, GROUP_LIMIT)
    yield g
    g.close()


def _results(groups, world):
    try:
        return groups.results(world)
    except RuntimeError as err:
        pytest.fail(str(err))


@pytest.fixture(scope="module")
def refs(groups):
    """JAX's and the port's single-device solves (computed while the
    ranks run)."""
    c = workers.wstack_case()
    vis, uvw = c["vis"][:workers.PAD_ROWS], c["uvw"][:workers.PAD_ROWS]
    jplan = j_plan_wstack(c["uvw"], c["freq0"], c["dfreq"], c["num_chan"],
                          workers.IMAGE_SIZE, **workers.WSTACK)
    jres = jmc.major_cycle_imager(jplan, jnp.asarray(vis), jnp.asarray(uvw),
                                  **workers.TASK_SOLVE)
    plan = workers.wstack_plan(c)
    tres = major_cycle_imager(plan, vis, uvw, device="cpu",
                              **workers.TASK_SOLVE)
    dirty, psf = dirty_and_psf(plan, vis, uvw, device="cpu")
    return dict(solves=[(np.asarray(jres.model), np.asarray(jres.residual)),
                        (tres.model.numpy(), tres.residual.numpy())],
                dirty=dirty.numpy(), psf=psf.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_task_solve_sharded(groups, refs, world):
    """major_cycle_imager(bucketed=False, mesh=) on the rank's padded
    block of rows: model and residual at atol 1e-6 of JAX's and the
    port's single-device solves."""
    results = _results(groups, world)
    model = same_on_every_rank(results, "solve_tasks_model")
    residual = same_on_every_rank(results, "solve_tasks_residual")
    assert model.dtype == np.float64 and np.abs(model).max() > 0
    for want_model, want_residual in refs["solves"]:
        np.testing.assert_allclose(model, want_model, atol=1e-6)
        np.testing.assert_allclose(residual, want_residual, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_dirty_and_psf_sharded(groups, refs, world):
    """dirty_and_psf(mesh=): both images at atol 1e-6 of the port's
    single-device ones; the PSF peak is 1."""
    results = _results(groups, world)
    dirty = same_on_every_rank(results, "solve_dirty")
    psf = same_on_every_rank(results, "solve_psf")
    n = psf.shape[0] // 2
    np.testing.assert_allclose(psf[n, n], 1.0, rtol=1e-10)
    np.testing.assert_allclose(dirty, refs["dirty"], atol=1e-6)
    np.testing.assert_allclose(psf, refs["psf"], atol=1e-6)
