"""The port's FISTA solver on gloo process groups of 2 and 4 ranks
(``fista_imager(mesh=)``: each rank passes the whole ``vis`` and
``uvw``, runs the block-sharded packed operators on its block of the
sorted stream, and sums the residual norm over the ranks), against
JAX's single-device FISTA and the port's.

Scenario: the packed solve's of tests/test_torch_sharded_solvers.py
(148 rows: the plans padded for 2 and 4 ranks end in pad blocks, and a
task straddles two ranks), 4 iterations. The ranks run in
tests/_torch_dist_workers.py; the JAX reference runs here while they do.

Tolerances: JAX's sharded test (tests/test_pipeline.py:424-438): the
model at 2e-3 of max|model| against JAX's and the port's single-device
solves; each iteration's residual norm at rtol 1e-4 (as
tests/test_torch_fista.py holds the single-device solves). Every rank
returns the same bits.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import _torch_dist_workers as workers  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ska_sdp_func_torch.pipeline import fista_imager  # noqa: E402
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack  # noqa
from ska_sdp_func_tpu.pipeline import fista as jf  # noqa: E402

GROUP_LIMIT = 110.0
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    g = workers.Groups(tmp_path_factory.mktemp("sharded_fista"),
                       {w: ("fista",) for w in WORLDS}, GROUP_LIMIT)
    yield g
    g.close()


@pytest.fixture(scope="module")
def refs(groups):
    """JAX's and the port's single-device FISTA (computed while the ranks
    run)."""
    uvw, vis, _, plan = workers.solver_case()
    sc = workers.scenario
    jplan = j_plan_wstack(uvw, sc.FREQ0, sc.DFREQ, sc.NUM_CHAN,
                          sc.IMAGE_SIZE, **sc.PARAMS)
    jres = jf.fista_imager(jplan, jnp.asarray(vis), jnp.asarray(uvw),
                           **workers.FISTA)
    tres = fista_imager(plan, vis, uvw, device="cpu", **workers.FISTA)
    return [(np.asarray(jres.model), jres.residual_norm),
            (tres.model.numpy(), tres.residual_norm)]


@pytest.mark.parametrize("world", WORLDS)
def test_fista_sharded(groups, refs, world):
    try:
        results = groups.results(world)
    except RuntimeError as err:
        pytest.fail(str(err))
    model = results[0]["fista_model"]
    for r in results:
        np.testing.assert_array_equal(r["fista_model"], model)
        np.testing.assert_array_equal(r["fista_history"],
                                      results[0]["fista_history"])
    assert model.dtype == np.float32
    for want, history in refs:
        np.testing.assert_allclose(model, want,
                                   atol=2e-3 * np.abs(want).max())
        np.testing.assert_allclose(results[0]["fista_history"], history,
                                   rtol=1e-4)
    assert results[0]["fista_history"][-1] < results[0]["fista_history"][0]
