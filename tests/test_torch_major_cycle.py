"""Hogbom minor cycle and the major-cycle solver against JAX: the packed
path (``bucketed=True``), the task drivers (``bucketed=False``, the
default) and the bucketed fallback (``bucketed=True`` on a 32^2
sub-grid, which the packed path cannot take).

Tolerances: minor-cycle model 1e-5 of the dirty peak (same f32 update
arithmetic and first-maximum argmax, so the same components in the same
order); whole solve 1e-4 of the model peak (major cycles of grid/degrid
at f32 reassociation level feeding the argmax).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    make_inputs  # noqa: E402
from ska_sdp_func_torch.clean import hogbom as thog  # noqa: E402
from ska_sdp_func_torch.parallel import plan_wstack as t_plan_wstack  # noqa
from ska_sdp_func_torch.pipeline import major_cycle as tmc  # noqa: E402
from ska_sdp_func_tpu.clean import hogbom as jhog  # noqa: E402
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack  # noqa
from ska_sdp_func_tpu.parallel import wstack as jpw  # noqa: E402
from ska_sdp_func_tpu.parallel.packed import (  # noqa: E402
    packed_gridder as j_gridder,
    plan_packed as j_plan_packed,
)
from ska_sdp_func_tpu.pipeline import major_cycle as jmc  # noqa: E402

SRC = (IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9)


def _dirty_and_psf(n=64, seed=3):
    """A 2N PSF with sidelobes and a dirty image of three point sources
    plus noise (NumPy seed)."""
    rng = np.random.default_rng(seed)
    x = np.arange(2 * n) - n
    xx, yy = np.meshgrid(x, x, indexing="ij")
    r = np.hypot(xx, yy * 1.3) / 3.0
    psf = (np.sinc(r) * np.exp(-r / 20.0)).astype(np.float32)
    dirty = 0.01 * rng.standard_normal((n, n))
    for (px, py), flux in zip([(20, 30), (40, 12), (33, 45)],
                              [1.0, 0.6, 0.35]):
        dirty += flux * psf[n - px:2 * n - px, n - py:2 * n - py]
    return dirty.astype(np.float32), psf


@pytest.mark.parametrize("threshold, limit", [(0.05, 500), (0.0, 40)])
def test_minor_cycle_matches_jax(threshold, limit):
    dirty, psf = _dirty_and_psf()
    j_model, j_res = jhog._minor_cycle(jnp.asarray(dirty), jnp.asarray(psf),
                                       0.1, threshold, limit)
    t_model, t_res = thog._minor_cycle(torch.as_tensor(dirty),
                                       torch.as_tensor(psf), 0.1,
                                       threshold, limit)
    j_model, j_res = np.asarray(j_model), np.asarray(j_res)
    peak = np.abs(dirty).max()
    np.testing.assert_array_equal(np.flatnonzero(t_model.numpy()),
                                  np.flatnonzero(j_model))
    assert np.abs(t_model.numpy() - j_model).max() <= 1e-5 * peak
    assert np.abs(t_res.numpy() - j_res).max() <= 1e-5 * peak


def test_hogbom_clean_matches_jax():
    dirty, psf = _dirty_and_psf(seed=4)
    details = [2.0, 2.0, 1.0, 64.0]
    got = thog.hogbom_clean(torch.as_tensor(dirty), torch.as_tensor(psf),
                            details, 0.1, 0.05, 300)
    want = jhog.hogbom_clean(jnp.asarray(dirty), jnp.asarray(psf), details,
                             0.1, 0.05, 300)
    peak = np.abs(dirty).max()
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5 * peak


@pytest.fixture(scope="module")
def solves():
    """JAX and port solves of one point source (flux 1) predicted with
    JAX's packed degrid."""
    uvw, _ = make_inputs()
    jplan = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    img[SRC] = 1.0
    vis = np.asarray(j_gridder(j_plan_packed(jplan, uvw)).degrid(
        jnp.asarray(img)))
    kw = dict(n_major=3, bucketed=True)
    jres = jmc.major_cycle_imager(jplan, jnp.asarray(vis), jnp.asarray(uvw),
                                  **kw)
    tplan = t_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    tres = tmc.major_cycle_imager(tplan, vis, uvw, device="cpu", **kw)
    return jres, tres


def test_major_cycle_model_matches_jax(solves):
    jres, tres = solves
    j_model = np.asarray(jres.model)
    t_model = tres.model.numpy()
    assert t_model.dtype == np.float32
    assert np.abs(t_model - j_model).max() <= 1e-4 * np.abs(j_model).max()
    scale = np.abs(np.asarray(jres.restored)).max()
    assert np.abs(tres.restored.numpy()
                  - np.asarray(jres.restored)).max() <= 1e-4 * scale


def test_major_cycle_recovers_flux(solves):
    _, tres = solves
    assert abs(float(tres.model[SRC]) - 1.0) < 0.05
    hist = tres.peak_history
    assert len(hist) >= 2
    assert all(b < a for a, b in zip(hist, hist[1:]))


def test_major_cycle_weights_match_jax():
    uvw, _ = make_inputs()
    jplan = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    img[SRC] = 1.0
    vis = np.asarray(j_gridder(j_plan_packed(jplan, uvw)).degrid(
        jnp.asarray(img)))
    weights = np.random.default_rng(8).uniform(0.5, 1.5, vis.shape)
    kw = dict(n_major=1, bucketed=True, cycle_limit=50)
    jres = jmc.major_cycle_imager(jplan, jnp.asarray(vis), jnp.asarray(uvw),
                                  weights=jnp.asarray(weights), **kw)
    tplan = t_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    tres = tmc.major_cycle_imager(tplan, vis, uvw, weights=weights,
                                  device="cpu", **kw)
    j_model = np.asarray(jres.model)
    assert np.abs(tres.model.numpy() - j_model).max() \
        <= 1e-4 * np.abs(j_model).max()


@pytest.mark.parametrize("kwargs, item", [
    (dict(bucketed=True, mesh=object()), "item 15"),
    (dict(bucketed=True, clean_algorithm="msclean"), "item 13"),
    (dict(bucketed=True, checkpoint_path="x.npz"), "item 13"),
])
def test_unported_branches_raise(kwargs, item):
    uvw, vis = make_inputs()
    tplan = t_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    with pytest.raises(NotImplementedError, match=item):
        tmc.major_cycle_imager(tplan, vis, uvw, device="cpu", **kwargs)


def test_unknown_clean_algorithm_raises():
    """An unknown name raises ValueError("unknown clean_algorithm"), as the
    JAX solver does (pipeline/major_cycle.py:392-393)."""
    uvw, vis = make_inputs()
    jplan = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    with pytest.raises(ValueError, match="unknown clean_algorithm"):
        jmc.major_cycle_imager(jplan, jnp.asarray(vis), jnp.asarray(uvw),
                               clean_algorithm="foo")
    tplan = t_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    with pytest.raises(ValueError, match="unknown clean_algorithm"):
        tmc.major_cycle_imager(tplan, vis, uvw, clean_algorithm="foo",
                               device="cpu")


def test_hogbom_clean_takes_numpy_like_jax():
    """NumPy images (a 16^2 dirty image, a 32^2 PSF; seed 0) go where
    ``device`` says and meet JAX's result on the same arrays."""
    n = 16
    x = np.arange(2 * n) - n
    r = np.hypot(*np.meshgrid(x, 1.3 * x, indexing="ij")) / 3.0
    psf = (np.sinc(r) * np.exp(-r / 20.0)).astype(np.float32)
    dirty = 0.01 * np.random.default_rng(0).standard_normal((n, n))
    for (px, py), flux in zip([(5, 7), (10, 3)], [1.0, 0.5]):
        dirty += flux * psf[n - px:2 * n - px, n - py:2 * n - py]
    dirty = dirty.astype(np.float32)
    details = [2.0, 2.0, 1.0, 16.0]
    got = thog.hogbom_clean(dirty, psf, details, 0.1, 0.05, 100,
                            device="cpu")
    want = jhog.hogbom_clean(jnp.asarray(dirty), jnp.asarray(psf), details,
                             0.1, 0.05, 100)
    peak = np.abs(dirty).max()
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5 * peak


def test_solver_takes_uvw_tensor():
    """uvw as a tensor (on the card there; here on the CPU) plans as the
    NumPy array does: the same solve."""
    uvw, vis = make_inputs()
    tplan = t_plan_wstack(torch.as_tensor(uvw), FREQ0, DFREQ, NUM_CHAN,
                          IMAGE_SIZE, **PARAMS)
    ref = t_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    assert tplan.tasks == ref.tasks
    kw = dict(n_major=1, bucketed=True, device="cpu")
    a = tmc.major_cycle_imager(tplan, vis, torch.as_tensor(uvw), **kw)
    b = tmc.major_cycle_imager(ref, vis, uvw, **kw)
    assert torch.equal(a.model, b.model)


# A 32^2 sub-grid scenario (test_torch_wstack_drivers.py's geometry).
SMALL_PARAMS = dict(PARAMS, subgrid_size=32)
SMALL_IMAGE, SMALL_ROWS = 64, 60
SMALL_SRC = (SMALL_IMAGE // 2 + 6, SMALL_IMAGE // 2 - 5)


@pytest.fixture(scope="module")
def small():
    """A point source (flux 1) predicted with JAX's task drivers."""
    rng = np.random.default_rng(5)
    uvw = rng.uniform(-1, 1, (SMALL_ROWS, 3))
    uvw[:, :2] *= 0.3 * SMALL_IMAGE / 2 / PARAMS["theta"]
    uvw[:, 2] *= PARAMS["w_step"] * PARAMS["w_tower_height"]
    jplan = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, SMALL_IMAGE,
                          **SMALL_PARAMS)
    img = np.zeros((SMALL_IMAGE, SMALL_IMAGE), np.complex64)
    img[SMALL_SRC] = 1.0
    st = jnp.zeros((SMALL_ROWS,), jnp.int32)
    en = jnp.full((SMALL_ROWS,), NUM_CHAN, jnp.int32)
    vis = np.asarray(jpw.degrid_all_tasks(
        jplan, jplan.kernel(), jnp.asarray(img), jnp.asarray(uvw), st, en,
        jnp.complex64))
    tplan = t_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, SMALL_IMAGE,
                          **SMALL_PARAMS)
    weights = np.random.default_rng(8).uniform(0.5, 1.5, vis.shape)
    return dict(uvw=uvw, vis=vis, jplan=jplan, tplan=tplan, weights=weights)


def _solve_pair(small, **kw):
    kw = dict(n_major=2, cycle_limit=200, **kw)
    w = kw.pop("weights", None)
    jres = jmc.major_cycle_imager(
        small["jplan"], jnp.asarray(small["vis"]), jnp.asarray(small["uvw"]),
        weights=None if w is None else jnp.asarray(w), **kw)
    tres = tmc.major_cycle_imager(small["tplan"], small["vis"],
                                  small["uvw"], weights=w, device="cpu", **kw)
    return np.asarray(jres.model), tres


@pytest.mark.parametrize("weighted", [False, True])
def test_major_cycle_task_drivers_match_jax(small, weighted):
    """bucketed=False (the default): the per-task drivers."""
    j_model, tres = _solve_pair(
        small, weights=small["weights"] if weighted else None)
    t_model = tres.model.numpy()
    assert t_model.dtype == np.float32
    assert np.abs(t_model - j_model).max() <= 1e-4 * np.abs(j_model).max()
    assert t_model[SMALL_SRC] > 0.5


def test_major_cycle_bucketed_fallback_matches_jax(small):
    """bucketed=True on a 32^2 sub-grid takes the bucketed per-task
    fallback in both packages."""
    j_model, tres = _solve_pair(small, bucketed=True)
    t_model = tres.model.numpy()
    assert np.abs(t_model - j_model).max() <= 1e-4 * np.abs(j_model).max()
    assert tres.model.abs().argmax() == np.abs(j_model).argmax()


def test_major_cycle_stage_report(small, monkeypatch):
    """verbosity=1 logs the solver's stage report, one line each."""
    lines = []
    monkeypatch.setattr(tmc, "log_info",
                        lambda fmt, *args: lines.append(fmt % args))
    tmc.major_cycle_imager(small["tplan"], small["vis"], small["uvw"],
                           n_major=1, bucketed=True, cycle_limit=20,
                           verbosity=1, device="cpu")
    assert lines[0].startswith("major_cycle_imager (")
    for stage in ("planning", "psf grid + sort", "degrid predict",
                  "grid residual", "minor cycle", "restore"):
        assert any(f"+- {stage}:" in line for line in lines)
