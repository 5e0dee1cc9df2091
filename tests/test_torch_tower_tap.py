"""W-towers tap kernels' plain versions and the dense products against
JAX (ska_sdp_func_tpu.kernels.pallas_tap in interpret mode, and
kernels.dense_tap).

Tolerances: the plain versions at 1e-5 of max|output| (the same f32
products as the Pallas kernels at Precision.HIGHEST, summed in another
order); the dense products on complex128 at 1e-12 of max|output| (the
same banded algebra in f64). The per-plane pair on the compaction cases
of their CUDA kernels (``_torch_scenario.plane_case``): f32 at 1e-5,
an all-masked plane exactly zero, and the bf16 mode against JAX's
``fast`` (f32 on the CPU) within the rounding of its terms, 2^-7 (1 +
2^-9) of the sum of |terms| of each output: JAX's 4e-3 of max|output|
holds for sums of many terms, but these planes' cells sum a few (the
clustered grid reads 4.6e-3).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import PLANE_CASES, plane_case  # noqa: E402

from ska_sdp_func_torch.kernels import dense_tap as tdense  # noqa: E402
from ska_sdp_func_torch.kernels import tower_tap as tt  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpMemLocationError,
    SdpShapeError,
)
from ska_sdp_func_tpu.grid_data.kernels import make_pswf_kernel  # noqa
from ska_sdp_func_tpu.kernels import dense_tap as jdense  # noqa: E402
from ska_sdp_func_tpu.kernels import pallas_tap as jp  # noqa: E402

SUPPORT, W_SUPPORT, OV = 8, 4, 64
TOL = 1e-5


def _tables():
    return (make_pswf_kernel(SUPPORT, SUPPORT, OV),
            make_pswf_kernel(W_SUPPORT, W_SUPPORT, OV))


def _geom(rng, rows, chans, size):
    """Random [R, C] plane geometry: mask, cells (some at the sub-grid
    edge) and kernel rows."""
    shape = (rows, chans)
    iu0 = rng.integers(0, size - SUPPORT + 1, shape)
    iv0 = rng.integers(0, size - SUPPORT + 1, shape)
    iu0[0, 0], iv0[0, 0] = size - SUPPORT, size - SUPPORT
    return (rng.random(shape) < 0.8, iu0.astype(np.int32),
            iv0.astype(np.int32), rng.integers(0, OV + 1, shape),
            rng.integers(0, OV + 1, shape), rng.integers(0, OV + 1, shape))


def _cplx(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _flat(rng, total, size, num_layers):
    """Flat taps as the fused drivers make them: each visibility weighted
    on a window of W_SUPPORT consecutive layers."""
    iu0 = rng.integers(0, size - SUPPORT + 1, total).astype(np.int32)
    iv0 = rng.integers(0, size - SUPPORT + 1, total).astype(np.int32)
    uk = rng.standard_normal((total, SUPPORT)).astype(np.float32)
    vk = rng.standard_normal((total, SUPPORT)).astype(np.float32)
    j = rng.integers(0, num_layers - W_SUPPORT + 1, total)
    weights = np.zeros((total, num_layers), np.float32)
    for layer in range(W_SUPPORT):
        weights[np.arange(total), j + layer] = rng.uniform(0.1, 1, total)
    weights[rng.random(total) < 0.1] = 0.0
    return iu0, iv0, uk, vk, weights


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("size, rows", [(32, 700), (64, 1100)])
def test_grid_plane_plain_matches_pallas(size, rows):
    rng = np.random.default_rng(size)
    uv_k, w_k = _tables()
    geom = _geom(rng, rows, 3, size)
    vis = _cplx(rng, (rows, 3))
    sub = _cplx(rng, (W_SUPPORT, size, size))
    want = jp.grid_plane_pallas(
        jnp.asarray(sub), jnp.asarray(vis), jnp.asarray(uv_k),
        jnp.asarray(w_k), tuple(jnp.asarray(g) for g in geom), SUPPORT,
        W_SUPPORT, block_v=1024, interpret=True)
    got = tt.grid_plane(
        torch.as_tensor(sub), torch.as_tensor(vis), torch.as_tensor(uv_k),
        torch.as_tensor(w_k), tuple(torch.as_tensor(g) for g in geom),
        SUPPORT, W_SUPPORT, block_v=1024)
    assert got.dtype == torch.complex64
    _close(got.numpy() - sub, np.asarray(want) - sub)


@pytest.mark.parametrize("size, rows", [(32, 700), (64, 1100)])
def test_degrid_plane_plain_matches_pallas(size, rows):
    rng = np.random.default_rng(size + 1)
    uv_k, w_k = _tables()
    geom = _geom(rng, rows, 3, size)
    sub = _cplx(rng, (W_SUPPORT, size, size))
    want = jp.degrid_plane_pallas(
        jnp.asarray(sub), jnp.asarray(uv_k), jnp.asarray(w_k),
        tuple(jnp.asarray(g) for g in geom), SUPPORT, W_SUPPORT,
        block_v=1024, interpret=True)
    got = tt.degrid_plane(
        torch.as_tensor(sub), torch.as_tensor(uv_k), torch.as_tensor(w_k),
        tuple(torch.as_tensor(g) for g in geom), SUPPORT, W_SUPPORT)
    _close(got.numpy(), want)
    assert not got.numpy()[~geom[0]].any()


@pytest.mark.parametrize("size, num_layers", [(32, 6), (64, 9)])
def test_grid_all_layers_plain_matches_pallas(size, num_layers):
    rng = np.random.default_rng(3 * size)
    total = 2500
    iu0, iv0, uk, vk, weights = _flat(rng, total, size, num_layers)
    vre = rng.standard_normal(total).astype(np.float32)
    vim = rng.standard_normal(total).astype(np.float32)
    want = jp.grid_all_layers_pallas(
        *(jnp.asarray(a) for a in (vre, vim, iu0, iv0, uk, vk, weights)),
        num_layers, size, SUPPORT, block_v=1024, interpret=True)
    got = tt.grid_all_layers(
        *(torch.as_tensor(a) for a in (vre, vim, iu0, iv0, uk, vk,
                                       weights)),
        num_layers, size, SUPPORT, block_v=1024)
    assert tuple(got.shape) == (num_layers, size, size)
    _close(got.numpy(), want)


@pytest.mark.parametrize("size, num_layers", [(32, 6), (64, 9)])
def test_degrid_all_layers_plain_matches_pallas(size, num_layers):
    rng = np.random.default_rng(5 * size)
    total = 2500
    iu0, iv0, uk, vk, weights = _flat(rng, total, size, num_layers)
    layers = _cplx(rng, (num_layers, size, size))
    want = jp.degrid_all_layers_pallas(
        *(jnp.asarray(a) for a in (layers, iu0, iv0, uk, vk, weights)),
        SUPPORT, block_v=1024, interpret=True)
    got = tt.degrid_all_layers(
        *(torch.as_tensor(a) for a in (layers, iu0, iv0, uk, vk, weights)),
        SUPPORT)
    _close(got.numpy(), want)


def test_dense_c128_matches_jax():
    rng = np.random.default_rng(9)
    size, rows = 32, 300
    uv_k, w_k = _tables()
    geom = _geom(rng, rows, 2, size)
    vis = _cplx(rng, (rows, 2), np.complex128)
    sub = _cplx(rng, (W_SUPPORT, size, size), np.complex128)
    jgeom = tuple(jnp.asarray(g) for g in geom)
    tgeom = tuple(torch.as_tensor(g) for g in geom)
    want = np.asarray(jdense.grid_plane_dense(
        jnp.asarray(sub), jnp.asarray(vis), jnp.asarray(uv_k),
        jnp.asarray(w_k), jgeom, SUPPORT, W_SUPPORT))
    got = tdense.grid_plane_dense(
        torch.as_tensor(sub), torch.as_tensor(vis), torch.as_tensor(uv_k),
        torch.as_tensor(w_k), tgeom, SUPPORT, W_SUPPORT).numpy()
    assert got.dtype == np.complex128
    _close(got, want, 1e-12)
    want = np.asarray(jdense.degrid_plane_dense(
        jnp.asarray(sub), jnp.asarray(uv_k), jnp.asarray(w_k), jgeom,
        SUPPORT, W_SUPPORT))
    got = tdense.degrid_plane_dense(
        torch.as_tensor(sub), torch.as_tensor(uv_k), torch.as_tensor(w_k),
        tgeom, SUPPORT, W_SUPPORT).numpy()
    _close(got, want, 1e-12)


def test_band_matrix_drops_out_of_range_taps():
    taps = torch.arange(1.0, 9.0).reshape(2, 4)
    band = tdense.band_matrix(torch.tensor([-2, 6]), taps, 8)
    np.testing.assert_array_equal(
        band.numpy(), [[3, 4, 0, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0, 5, 6]])


def test_cpu_wrappers_count_no_launches():
    rng = np.random.default_rng(2)
    tt.reset_launch_counts()
    iu0, iv0, uk, vk, weights = _flat(rng, 300, 32, 5)
    args = [torch.as_tensor(a) for a in (iu0, iv0, uk, vk, weights)]
    vre = torch.ones(300)
    tt.grid_all_layers(vre, vre, *args, 5, 32, SUPPORT)
    tt.degrid_all_layers(torch.zeros((5, 32, 32), dtype=torch.complex64),
                         *args, SUPPORT)
    assert set(tt.launch_counts().values()) == {0}


def test_wrappers_reject_bad_operands():
    rng = np.random.default_rng(4)
    iu0, iv0, uk, vk, weights = (torch.as_tensor(a)
                                 for a in _flat(rng, 100, 32, 5))
    vre = torch.ones(100)
    with pytest.raises(SdpShapeError):
        tt.grid_all_layers(vre, vre, iu0, iv0, uk, vk, weights, 4, 32,
                           SUPPORT)
    with pytest.raises(SdpMemLocationError):
        tt.grid_all_layers(vre.to("meta"), vre, iu0, iv0, uk, vk, weights,
                           5, 32, SUPPORT)


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("op", ["grid", "degrid"])
@pytest.mark.parametrize("case", PLANE_CASES)
def test_plane_cases_match_pallas(case, op, fast):
    """grid_plane / degrid_plane on the geometries their kernels' active-
    entry compaction must get right, against the Pallas kernels."""
    geom, uv_k, w_k, vis, sub = plane_case(case, 32, seed=len(case))
    jgeom = tuple(jnp.asarray(g) for g in geom)
    tgeom = tuple(torch.as_tensor(g) for g in geom)
    if op == "grid":
        want = np.asarray(jp.grid_plane_pallas(
            jnp.asarray(sub), jnp.asarray(vis), jnp.asarray(uv_k),
            jnp.asarray(w_k), jgeom, SUPPORT, W_SUPPORT, block_v=128,
            fast=fast, interpret=True)) - sub
        got = tt.grid_plane(
            torch.as_tensor(sub), torch.as_tensor(vis), torch.as_tensor(uv_k),
            torch.as_tensor(w_k), tgeom, SUPPORT, W_SUPPORT, block_v=128,
            fast=fast).numpy() - sub
    else:
        want = np.asarray(jp.degrid_plane_pallas(
            jnp.asarray(sub), jnp.asarray(uv_k), jnp.asarray(w_k), jgeom,
            SUPPORT, W_SUPPORT, block_v=128, fast=fast, interpret=True))
        got = tt.degrid_plane(
            torch.as_tensor(sub), torch.as_tensor(uv_k), torch.as_tensor(w_k),
            tgeom, SUPPORT, W_SUPPORT, fast=fast).numpy()
        assert not got[~geom[0]].any()
    if not geom[0].any():
        assert not got.any() and not want.any()
    elif not fast:
        _close(got, want)
    else:
        # Per output, the sum of |terms|: the f32 plain version on
        # |operands|.
        def parts(x):
            return (np.abs(x.real) + 1j * np.abs(x.imag)).astype(x.dtype)

        t_abs = [torch.as_tensor(np.abs(t)) for t in (uv_k, w_k)]
        if op == "grid":
            terms = tt.grid_plane_reference(
                torch.zeros(sub.shape, dtype=torch.complex64),
                torch.as_tensor(parts(vis)), *t_abs, tgeom, SUPPORT,
                W_SUPPORT).numpy()
        else:
            terms = tt.degrid_plane_reference(
                torch.as_tensor(parts(sub)), *t_abs, tgeom, SUPPORT,
                W_SUPPORT).numpy()
        slack = 2 ** -7 * (1 + 2 ** -9)
        for part in (np.real, np.imag):
            assert (np.abs(part(got) - part(want))
                    <= slack * part(terms)
                    + 1e-6 * np.abs(part(want)).max()).all()
        assert not np.array_equal(got, want)
