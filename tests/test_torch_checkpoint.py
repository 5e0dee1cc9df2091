"""Solver checkpointing (ska_sdp_func_torch.pipeline.checkpoint) and the
solver's ``checkpoint_path=`` / ``checkpointer=`` against the JAX
package: round trips, files that cross between the packages, and resumed
solves.

Tolerances: a resumed port solve equals the uninterrupted one bit for
bit (the state is saved exactly and the same f32 arithmetic repeats); a
solve resumed across packages meets the other package's uninterrupted
solve within 1e-4 of max|model| (the whole-solve tolerance of
test_torch_major_cycle.py).
"""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    make_inputs  # noqa: E402
from ska_sdp_func_torch.parallel import plan_wstack as t_plan_wstack  # noqa
from ska_sdp_func_torch.pipeline import (  # noqa: E402
    ImagingResult,
    SolverCheckpointer,
    load_result,
    load_state,
    major_cycle_imager,
    save_result,
    save_state,
)
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack  # noqa
from ska_sdp_func_tpu.parallel.packed import (  # noqa: E402
    packed_gridder as j_gridder,
    plan_packed as j_plan_packed,
)
from ska_sdp_func_tpu.pipeline import checkpoint as jck  # noqa: E402
from ska_sdp_func_tpu.pipeline import major_cycle as jmc  # noqa: E402

SRC = (IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9)
KW = dict(bucketed=True, cycle_limit=60)


@pytest.fixture(scope="module")
def scene():
    """One point source (flux 1) predicted with JAX's packed degrid, and
    both packages' uninterrupted three-cycle solves."""
    uvw, _ = make_inputs()
    jplan = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    img[SRC] = 1.0
    vis = np.asarray(j_gridder(j_plan_packed(jplan, uvw)).degrid(
        jnp.asarray(img)))
    tplan = t_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    s = dict(uvw=uvw, vis=vis, jplan=jplan, tplan=tplan)
    s["j3"] = _jax_solve(s, 3)
    s["t3"] = _port_solve(s, 3)
    return s


def _jax_solve(s, n, **kw):
    return jmc.major_cycle_imager(s["jplan"], jnp.asarray(s["vis"]),
                                  jnp.asarray(s["uvw"]), n_major=n, **KW,
                                  **kw)


def _port_solve(s, n, **kw):
    return major_cycle_imager(s["tplan"], s["vis"], s["uvw"], n_major=n,
                              device="cpu", **KW, **kw)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_state_round_trip(tmp_path):
    path = str(tmp_path / "sub" / "state.npz")
    model = torch.arange(12.0).reshape(3, 4)
    save_state(path, model, -model, 5, [0.5, 0.25], {"tag": "x"})
    assert sorted(os.listdir(tmp_path / "sub")) == ["state.npz"]
    m, r, cycle, hist, meta = load_state(path, device="cpu")
    assert torch.equal(m, model) and torch.equal(r, -model)
    assert (cycle, hist, meta) == (5, [0.5, 0.25], {"tag": "x"})


def test_result_round_trip(tmp_path):
    path = str(tmp_path / "result.npz")
    res = ImagingResult(model=torch.ones(4, 4), residual=torch.zeros(4, 4),
                        restored=2 * torch.ones(4, 4), peak_history=[1.0])
    save_result(path, res, {"k": 1})
    back = load_result(path, device="cpu")
    for name in ("model", "residual", "restored"):
        assert torch.equal(getattr(back, name), getattr(res, name))
    assert back.peak_history == [1.0]
    # The JAX package reads the same file.
    jres = jck.load_result(path)
    np.testing.assert_array_equal(np.asarray(jres.restored),
                                  res.restored.numpy())


def test_state_files_cross_packages(tmp_path):
    model = np.random.default_rng(1).standard_normal((8, 8)).astype(
        np.float32)
    jck.save_state(str(tmp_path / "j.npz"), jnp.asarray(model),
                   jnp.asarray(2 * model), 3, [1.0, 0.5], {"from": "jax"})
    m, r, cycle, hist, meta = load_state(str(tmp_path / "j.npz"),
                                         device="cpu")
    np.testing.assert_array_equal(m.numpy(), model)
    np.testing.assert_array_equal(r.numpy(), 2 * model)
    assert (cycle, hist, meta) == (3, [1.0, 0.5], {"from": "jax"})
    save_state(str(tmp_path / "t.npz"), torch.as_tensor(model),
               torch.as_tensor(-model), 4, [2.0], {"from": "torch"})
    m, r, cycle, hist, meta = jck.load_state(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(r), -model)
    assert (cycle, list(hist), meta) == (4, [2.0], {"from": "torch"})


def test_resume_equals_uninterrupted(scene, tmp_path):
    path = str(tmp_path / "solve.npz")
    first = _port_solve(scene, 2, checkpoint_path=path)
    assert load_state(path, device="cpu")[2] == 2
    resumed = _port_solve(scene, 3, checkpoint_path=path)
    assert torch.equal(resumed.model, scene["t3"].model)
    assert torch.equal(resumed.residual, scene["t3"].residual)
    assert resumed.peak_history == scene["t3"].peak_history
    assert resumed.peak_history[:2] == first.peak_history


def test_jax_checkpoint_resumes_port_solver(scene, tmp_path):
    path = str(tmp_path / "jax.npz")
    _jax_solve(scene, 2, checkpoint_path=path)
    resumed = _port_solve(scene, 3, checkpoint_path=path)
    _close(resumed.model, scene["j3"].model)
    assert len(resumed.peak_history) == len(scene["j3"].peak_history)


def test_port_checkpoint_resumes_jax_solver(scene, tmp_path):
    path = str(tmp_path / "port.npz")
    _port_solve(scene, 2, checkpoint_path=path)
    resumed = _jax_solve(scene, 3, checkpoint_path=path)
    _close(resumed.model, scene["t3"].model.numpy())


def test_checkpointer_retention(tmp_path):
    with SolverCheckpointer(str(tmp_path / "ck"), max_to_keep=2,
                            device="cpu") as ck:
        assert ck.latest_step() is None
        with pytest.raises(FileNotFoundError):
            ck.restore()
        for step in range(1, 6):
            ck.save(step, torch.full((4, 4), float(step)),
                    torch.zeros(4, 4), [float(step)], {"s": step})
        ck.wait()
        assert ck.steps() == [4, 5] and ck.latest_step() == 5
        m, _, cycle, hist, meta = ck.restore()
        assert (float(m[0, 0]), cycle, hist, meta) == (5.0, 5, [5.0],
                                                       {"s": 5})
        template = {"model": torch.zeros(4, 4, dtype=torch.float64),
                    "residual": torch.zeros(4, 4, dtype=torch.float64)}
        m, r, cycle, _, _ = ck.restore(step=4, template=template)
        assert m.dtype == r.dtype == torch.float64 and cycle == 4
        assert float(m[0, 0]) == 4.0


def test_checkpointer_resumes_solver(scene, tmp_path):
    ck = SolverCheckpointer(str(tmp_path / "steps"), device="cpu")
    _port_solve(scene, 2, checkpointer=ck)
    assert ck.steps() == [1, 2]
    resumed = _port_solve(scene, 3, checkpointer=ck)
    assert ck.steps() == [1, 2, 3]
    assert torch.equal(resumed.model, scene["t3"].model)


def test_both_checkpoint_forms_raise(scene, tmp_path):
    ck = SolverCheckpointer(str(tmp_path / "ck"), device="cpu")
    with pytest.raises(ValueError, match="at most one"):
        _port_solve(scene, 1, checkpoint_path=str(tmp_path / "a.npz"),
                    checkpointer=ck)
    shutil.rmtree(tmp_path / "ck")
