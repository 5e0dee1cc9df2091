"""The w-towers sub-grid gridder (GridderWtowerUVW) against JAX.

Tolerances: complex128 at the oracle tolerances of test_wtower.py
(degrid atol 1e-14 / rtol 1e-13, grid max-abs 1e-10: the same f64
arithmetic); complex64 at 1e-5 of max|output| (the f32 tap products in
another summation order); the corrections at 1e-12 (f64 screens).
complex64 data runs on f64 uvw (a combination the reference supports):
from f32 uvw both packages snap a few taps to a neighbouring kernel row,
each at ~1e-4 of the output from the f64 truth, but not the same taps,
since XLA fuses the f32 coordinate arithmetic differently.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import C_0, WTOWER_PARAMS, wtower_scenario  # noqa
from ska_sdp_func_torch.grid_data import wtower as tw  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpDataTypeError,
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ska_sdp_func_tpu.grid_data import wtower as jw  # noqa: E402

OFFSETS = [(0, 0, 0), (10, -6, 1)]
FREQ0, DFREQ = C_0, C_0 / 100


@pytest.fixture(scope="module")
def setup():
    uvw, ch_count, image = wtower_scenario()
    rows = uvw.shape[0]
    return dict(
        jplan=jw.GridderWtowerUVW(**WTOWER_PARAMS),
        tplan=tw.GridderWtowerUVW(**WTOWER_PARAMS),
        uvw=uvw, ch=ch_count, image=image,
        start=np.zeros(rows, np.int32),
        end=np.full(rows, ch_count, np.int32))


def _array(mod):
    return jnp.asarray if mod is jnp else (
        lambda a: torch.tensor(np.asarray(a)))


def _cpu(mod):
    """The port's entry points run on the card unless asked otherwise."""
    return {} if mod is jnp else dict(device="cpu")


def _degrid(plan, s, image, offsets, vis_dtype, mod):
    arr = _array(mod)
    uvw = s["uvw"]
    vis = np.zeros((uvw.shape[0], s["ch"]), vis_dtype)
    return np.asarray(plan.degrid_subgrid(
        arr(image), offsets, s["ch"], FREQ0, DFREQ, arr(uvw),
        arr(s["start"]), arr(s["end"]), arr(vis), **_cpu(mod)))


def _grid(plan, s, vis, offsets, mod):
    arr = _array(mod)
    uvw = s["uvw"]
    sub = np.zeros(s["image"].shape, vis.dtype)
    return np.asarray(plan.grid_subgrid(
        arr(vis), arr(uvw), arr(s["start"]), arr(s["end"]), s["ch"], FREQ0,
        DFREQ, arr(sub), offsets, **_cpu(mod)))


def test_plan_tables_match_jax(setup):
    j, t = setup["jplan"], setup["tplan"]
    for name in ("uv_kernel", "w_kernel", "w_pattern"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)))
    assert t.num_w_planes(0) == 0 and t.num_w_planes(2) == 0


@pytest.mark.parametrize("offsets", OFFSETS)
def test_degrid_c128_matches_jax(setup, offsets):
    s = setup
    want = _degrid(s["jplan"], s, s["image"], offsets, np.complex128, jnp)
    got = _degrid(s["tplan"], s, s["image"], offsets, np.complex128, torch)
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, atol=1e-14, rtol=1e-13)


@pytest.mark.parametrize("offsets", OFFSETS)
def test_grid_c128_matches_jax(setup, offsets):
    s = setup
    vis = _degrid(s["jplan"], s, s["image"], offsets, np.complex128, jnp)
    want = _grid(s["jplan"], s, vis, offsets, jnp)
    got = _grid(s["tplan"], s, vis, offsets, torch)
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() < 1e-10


def test_grid_degrid_adjoint_c128(setup):
    """<vis, A x> == <A^T vis, x> for the port's c128 operators."""
    s = setup
    rng = np.random.default_rng(1)
    x = rng.standard_normal(s["image"].shape) \
        + 1j * rng.standard_normal(s["image"].shape)
    vis = rng.standard_normal((s["uvw"].shape[0], s["ch"])) \
        + 1j * rng.standard_normal((s["uvw"].shape[0], s["ch"]))
    ax = _degrid(s["tplan"], s, x, OFFSETS[1], np.complex128, torch)
    atv = _grid(s["tplan"], s, vis, OFFSETS[1], torch)
    lhs, rhs = np.vdot(vis, ax), np.vdot(atv, x)
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("offsets", OFFSETS)
def test_c64_per_plane_matches_jax(setup, offsets):
    """complex64 on the CPU: the per-plane drivers with the dense
    products in both packages."""
    s = setup
    want = _degrid(s["jplan"], s, s["image"], offsets, np.complex64, jnp)
    got = _degrid(s["tplan"], s, s["image"], offsets, np.complex64, torch)
    assert got.dtype == np.complex64
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    gwant = _grid(s["jplan"], s, want, offsets, jnp)
    ggot = _grid(s["tplan"], s, want, offsets, torch)
    assert np.abs(ggot - gwant).max() <= 1e-5 * np.abs(gwant).max()


def _fused_args(s, offsets, vis, mod):
    """The fused drivers' positional arguments (f64 uvw, c64 data)."""
    arr = jnp.asarray if mod is jnp else torch.as_tensor
    plan = s["tplan"]
    uvw = s["uvw"]
    first, last = plan._w_plane_range(
        torch.as_tensor(uvw), torch.as_tensor(s["start"]),
        torch.as_tensor(s["end"]), FREQ0, DFREQ, offsets[2])
    rdt = np.float32
    off = tuple(jnp.asarray(o) for o in offsets) if mod is jnp else offsets
    first_a = jnp.asarray(first) if mod is jnp else first
    return (arr(uvw), arr(s["start"]), arr(s["end"])), dict(
        tables=(arr(plan.uv_kernel.astype(rdt)),
                arr(plan.w_kernel.astype(rdt))),
        tail=(*off, first_a, FREQ0, DFREQ, 1 + last - first, plan.theta,
              plan.w_step, plan.support, plan.oversampling, plan.w_support,
              plan.w_oversampling, plan.subgrid_size, 0, uvw.shape[0]))


@pytest.mark.parametrize("offsets", OFFSETS)
def test_fused_c64_drivers_match_jax(setup, offsets):
    """The all-layer drivers (CUDA kernels K16/K17 on the card; their
    plain versions here) against JAX's fused drivers with the Pallas
    kernels in interpret mode."""
    s = setup
    pattern = s["tplan"].w_pattern
    img = s["image"].astype(np.complex64)
    vis0 = np.zeros((s["uvw"].shape[0], s["ch"]), np.complex64)
    out = {}
    for mod, fns in ((jnp, jw), (torch, tw)):
        arr = jnp.asarray if mod is jnp else torch.as_tensor
        (uvw, st, en), a = _fused_args(s, offsets, vis0, mod)
        vis = np.asarray(fns._degrid_all_planes_fused(
            arr(img), arr(pattern.astype(np.complex64)), *a["tables"], uvw,
            st, en, arr(vis0), *a["tail"]))
        sub = np.asarray(fns._grid_all_planes_fused(
            arr(vis), arr(pattern), *a["tables"], uvw, st, en,
            arr(np.zeros_like(img)), *a["tail"]))
        out[mod] = vis, sub
    (jv, js), (tv, ts) = out[jnp], out[torch]
    assert np.abs(jv).max() > 0.01
    assert np.abs(tv - jv).max() <= 1e-5 * np.abs(jv).max()
    assert np.abs(ts - js).max() <= 1e-5 * np.abs(js).max()


def test_fused_matches_per_plane_c64(setup):
    """The fused (all-layer) and per-plane forms are the same operator."""
    s = setup
    (uvw, st, en), a = _fused_args(s, OFFSETS[1], None, torch)
    img = torch.as_tensor(s["image"].astype(np.complex64))
    pattern = torch.as_tensor(s["tplan"].w_pattern)
    vis0 = torch.zeros((uvw.shape[0], s["ch"]), dtype=torch.complex64)
    fused = tw._degrid_all_planes_fused(
        img, pattern.to(torch.complex64), *a["tables"], uvw, st, en, vis0,
        *a["tail"])
    plane = tw._degrid_all_planes(
        img, pattern.to(torch.complex64), *a["tables"], uvw, st, en, vis0,
        *a["tail"])
    assert float((fused - plane).abs().max()) <= 1e-5 * float(
        plane.abs().max())
    sub0 = torch.zeros_like(img)
    fused = tw._grid_all_planes_fused(plane, pattern, *a["tables"], uvw,
                                      st, en, sub0, *a["tail"])
    per = tw._grid_all_planes(plane, pattern, *a["tables"], uvw, st, en,
                              sub0, *a["tail"])
    assert float((fused - per).abs().max()) <= 1e-5 * float(
        per.abs().max())


def test_corrections_match_jax(setup):
    rng = np.random.default_rng(7)
    n = WTOWER_PARAMS["image_size"]
    facet = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    j, t = setup["jplan"], setup["tplan"]
    for name in ("degrid_correct", "grid_correct"):
        want = np.asarray(getattr(j, name)(jnp.asarray(facet), 0, 0, 2))
        got = getattr(t, name)(torch.as_tensor(facet), 0, 0, 2,
                               device="cpu").numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        want = np.asarray(getattr(j, name)(jnp.asarray(facet.real)))
        got = getattr(t, name)(torch.as_tensor(facet.real),
                               device="cpu").numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_counters_and_plane_counts_match_jax(setup):
    s = setup
    jplan = jw.GridderWtowerUVW(**WTOWER_PARAMS)
    tplan = tw.GridderWtowerUVW(**WTOWER_PARAMS)
    for off_w in (0, 1):
        assert tplan.degrid_num_planes(
            s["uvw"], s["start"], s["end"], FREQ0, DFREQ, off_w,
            device="cpu") == \
            jplan.degrid_num_planes(jnp.asarray(s["uvw"]), s["start"],
                                    s["end"], FREQ0, DFREQ, off_w)
    _degrid(tplan, s, s["image"], (0, 0, 0), np.complex128, torch)
    _degrid(jplan, s, s["image"], (0, 0, 0), np.complex128, jnp)
    assert tplan.num_w_planes(0) == jplan.num_w_planes(0) > 0
    assert tplan.num_w_planes(1) == 0


def test_deprecated_forms_forward(setup):
    s = setup
    t = s["tplan"]
    img = torch.as_tensor(s["image"])
    uvw = torch.as_tensor(s["uvw"])
    st, en = torch.as_tensor(s["start"]), torch.as_tensor(s["end"])
    vis0 = torch.zeros((uvw.shape[0], s["ch"]), dtype=torch.complex128)
    vis = t.degrid(img, 10, -6, 1, FREQ0, DFREQ, uvw, st, en, vis0,
                   device="cpu")
    want = t.degrid_subgrid(img, (10, -6, 1), s["ch"], FREQ0, DFREQ, uvw,
                            st, en, vis0, device="cpu")
    torch.testing.assert_close(vis, want, rtol=0, atol=0)
    sub0 = torch.zeros_like(img, dtype=torch.complex128)
    got = t.grid(vis, uvw, st, en, FREQ0, DFREQ, sub0, 10, -6, 1,
                 device="cpu")
    want = t.grid_subgrid(vis, uvw, st, en, s["ch"], FREQ0, DFREQ, sub0,
                          (10, -6, 1), device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_input_contracts(setup):
    s = setup
    t = s["tplan"]
    uvw = torch.as_tensor(s["uvw"])
    st, en = torch.as_tensor(s["start"]), torch.as_tensor(s["end"])
    bad = dict(WTOWER_PARAMS, subgrid_size=63)
    with pytest.raises(SdpInvalidArgumentError):
        tw.GridderWtowerUVW(**bad)
    with pytest.raises(SdpShapeError):
        t.degrid_subgrid(torch.zeros(8, 8), (0, 0, 0), s["ch"], FREQ0,
                         DFREQ, uvw, st, en, device="cpu")
    vis = torch.zeros((uvw.shape[0], s["ch"]), dtype=torch.complex128)
    with pytest.raises(SdpDataTypeError):
        t.grid_subgrid(vis, uvw.float(), st, en, s["ch"], FREQ0, DFREQ,
                       torch.zeros((64, 64), dtype=torch.complex128),
                       (0, 0, 0), device="cpu")
    with pytest.raises(SdpInvalidArgumentError):
        t.grid_subgrid(vis, uvw, st, en, s["ch"] + 1, FREQ0, DFREQ,
                       torch.zeros((64, 64), dtype=torch.complex128),
                       (0, 0, 0), device="cpu")
