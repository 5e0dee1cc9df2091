"""The port's visibility functions and data-model checks against the JAX
package on the same NumPy-seeded inputs (the sizes of
tests/test_visibility.py and the visibility cases of
tests/test_negative_paths.py), on the CPU (``device="cpu"``).

Tolerances: flags exact; f64 elementwise results (DFT phasors against a
component sum, phase rotation) 1e-12 of max|JAX|; the weight grids and
read-backs, scatter sums, 1e-10 relative.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch import utility as tu  # noqa: E402
from ska_sdp_func_torch import visibility as tv  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpDataTypeError,
    SdpShapeError,
)
from ska_sdp_func_torch.visibility import flagger as tflag  # noqa: E402
from ska_sdp_func_tpu import utility as ju  # noqa: E402
from ska_sdp_func_tpu import visibility as jv  # noqa: E402
from ska_sdp_func_tpu.utility import errors as jerr  # noqa: E402

CPU = "cpu"


def close(got, want, tol):
    """max|got - want| <= tol * max|want| (NaN where JAX has NaN)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    scale = np.abs(want[ok]).max() if ok.any() else 1.0
    assert np.abs(got[ok] - want[ok]).max(initial=0.0) <= tol * scale


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# ---------------------------------------------------------------------------
# DFT and phase rotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_pols", [1, 4])
def test_dft_point_matches_jax(num_pols):
    rng = np.random.default_rng(1)
    t, b, c, s = 3, 10, 2, 5
    uvw = rng.uniform(-100, 100, (t, b, 3))
    directions = rng.uniform(-0.01, 0.01, (s, 3))
    fluxes = _complex(rng, (s, c, num_pols))
    f0, df = 1e9, 1e7
    want = jv.dft_point_v01(jnp.asarray(directions), jnp.asarray(fluxes),
                            jnp.asarray(uvw), f0, df)
    got = tv.dft_point_v01(directions, fluxes, uvw, f0, df, device=CPU)
    close(got, want, 1e-12)
    inv_wave = (f0 + df * np.arange(c)) / 299792458.0
    uvw_lambda = uvw[:, :, None, :] * inv_wave[None, None, :, None]
    want = jv.dft_point_v00(jnp.asarray(directions), jnp.asarray(fluxes),
                            jnp.asarray(uvw_lambda))
    got = tv.dft_point_v00(directions, fluxes, uvw_lambda, device=CPU)
    close(got, want, 1e-12)


def test_phase_rotation_matches_jax():
    rng = np.random.default_rng(3)
    uvw = rng.uniform(-1000, 1000, (4, 20, 3))
    orig = (np.radians(20.0), np.radians(-30.0))
    new = (np.radians(20.5), np.radians(-29.5))
    want = jv.phase_rotate_uvw(ju.SkyCoord("icrs", *orig),
                               ju.SkyCoord("icrs", *new), jnp.asarray(uvw))
    got = tv.phase_rotate_uvw(tu.SkyCoord("icrs", *orig),
                              tu.SkyCoord("icrs", *new), uvw, device=CPU)
    close(got, want, 1e-12)
    vis = _complex(rng, (4, 20, 3, 2))
    want = jv.phase_rotate_vis(ju.SkyCoord("icrs", *orig),
                               ju.SkyCoord("icrs", *new), 1e9, 1e7,
                               jnp.asarray(uvw), jnp.asarray(vis))
    got = tv.phase_rotate_vis(tu.SkyCoord("icrs", *orig),
                              tu.SkyCoord("icrs", *new), 1e9, 1e7, uvw, vis,
                              device=CPU)
    close(got, want, 1e-12)


def test_sky_coord_fields():
    c = tu.SkyCoord("icrs", 0.1, -0.2, 0.3)
    assert (c.ra, c.dec, c.value(2), c.epoch) == (0.1, -0.2, 0.3, 2000.0)
    assert c == tu.SkyCoord("icrs", 0.1, -0.2, 0.3)


# ---------------------------------------------------------------------------
# Weighting
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weighting_data():
    rng = np.random.default_rng(7)
    uvw = rng.uniform(-800, 800, (4, 30, 3))
    freq = np.array([1.0e9, 1.1e9, 1.2e9])
    in_w = rng.uniform(0.5, 2.0, (4, 30, 3, 2))
    return uvw, freq, in_w


def test_get_uv_range_matches_jax(weighting_data):
    uvw, freq, _ = weighting_data
    want = jv.get_uv_range(jnp.asarray(uvw), jnp.asarray(freq))
    assert tv.get_uv_range(uvw, freq) == want
    assert tv.get_uv_range(torch.as_tensor(uvw), freq) == want


@pytest.mark.parametrize("kind, robust, grid_size", [
    ("uniform", None, 32), ("uniform", None, None),
    ("briggs", 0.5, 32), ("briggs", -1.0, 16), ("briggs", 2.0, None)])
def test_weights_match_jax(weighting_data, kind, robust, grid_size):
    """Grid and read-back, f64, 1e-10 relative (scatter sums); a
    sample off the grid (grid_size 16 cuts the uv range) is weighted
    zero in both. The default grid (2 * max|u| + 2 cells a side) on uvw
    scaled down 100-fold, a 66^2 grid."""
    uvw, freq, in_w = weighting_data
    if grid_size is None:
        uvw = uvw / 100.0
    max_uv = jv.get_uv_range(jnp.asarray(uvw), jnp.asarray(freq))
    args = (max_uv,) if robust is None else (max_uv, robust)
    jf = jv.uniform_weights if kind == "uniform" else jv.briggs_weights
    tf = tv.uniform_weights if kind == "uniform" else tv.briggs_weights
    j_grid, j_out = jf(jnp.asarray(uvw), jnp.asarray(freq), *args,
                       jnp.asarray(in_w), grid_size)
    t_grid, t_out = tf(uvw, freq, *args, in_w, grid_size, device=CPU)
    close(t_grid, j_grid, 1e-10)
    close(t_out, j_out, 1e-10)


def test_briggs_weights_f32_match_jax(weighting_data):
    """f32 weights on f64 uvw: the same cells, the robustness sums in f64
    in both packages."""
    uvw, freq, in_w = weighting_data
    max_uv = jv.get_uv_range(jnp.asarray(uvw), jnp.asarray(freq))
    w32 = in_w.astype(np.float32)
    _, j_out = jv.briggs_weights(jnp.asarray(uvw), jnp.asarray(freq),
                                 max_uv, 0.5, jnp.asarray(w32), 64)
    _, t_out = tv.briggs_weights(uvw, freq, max_uv, 0.5, w32, 64,
                                 device=CPU)
    assert t_out.dtype == torch.float32
    close(t_out, j_out, 1e-6)


# ---------------------------------------------------------------------------
# FluctuFlagger
# ---------------------------------------------------------------------------

def _flagger_vis(seed, t, b, c, p):
    rng = np.random.default_rng(seed)
    vis = _complex(rng, (t, b, c, p))
    vis[min(3, t - 1), 1, min(10, c - 1), 0] += 50.0
    vis[min(5, t - 1), 0, :, p - 1] += 30.0
    return vis


@pytest.mark.parametrize("shape, kw", [
    ((8, 3, 32, 2), dict(alpha=0.4, sampling_step=2, window=0,
                         window_median_history=4)),
    ((8, 3, 32, 2), dict(alpha=0.4, sampling_step=2, window=2,
                         window_median_history=4)),
    ((12, 4, 31, 1), dict(alpha=0.3, sampling_step=1, window=1,
                          window_median_history=10)),
    ((6, 2, 16, 4), dict(sampling_step=3, window=3,
                         window_median_history=1)),
    ((1, 2, 8, 1), dict()),
])
def test_flagger_matches_jax(shape, kw):
    """Exact flags: even and odd channel counts (the upper middle of an
    even sample set), sampling steps, dilation windows, a history of one
    time step and a single time step (no fluctuation method)."""
    vis = _flagger_vis(11, *shape)
    want = np.asarray(jv.flagger_dynamic_threshold(jnp.asarray(vis), **kw))
    got = tv.flagger_dynamic_threshold(vis, device=CPU, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if shape[0] > 1:
        assert want.sum() > 0


def test_flagger_mad_zero_sentinel_matches_jax():
    """Constant magnitudes across channels make the MAD 0: z is 0 where
    val == median and 1e7 elsewhere. Complex64 input as on the card."""
    vis = np.ones((6, 2, 16, 1), np.complex64)
    vis[2, 0, 5, 0] = 4.0
    vis[4, 1, :, 0] = 3.0
    want = np.asarray(jv.flagger_dynamic_threshold(jnp.asarray(vis)))
    got = tv.flagger_dynamic_threshold(vis, device=CPU).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2, 0, 5, 0] == 1


def test_flagger_scores_name_the_triggers():
    """The scores ``_flag_planes`` returns reproduce its flags."""
    vis = _flagger_vis(11, 8, 3, 32, 2)
    planes = torch.as_tensor(np.abs(vis)).permute(1, 3, 0, 2)
    flags, z = tflag._flag_planes(planes, 0.5, 3.5, 3.5, 3.5, 1, 0, 10,
                                  scores=True)
    trig = (z["z_mag"].abs() > 3.5) | (
        (z["z_med"].abs() > 3.5)
        & (torch.arange(8) != 0))[..., None]
    var = z["z_var"].abs() > 3.5
    trig[..., 1:, :] |= var
    trig[..., :-1, :] |= var
    assert torch.equal(trig, flags)


# ---------------------------------------------------------------------------
# Data-model checks and error paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn, args", [
    ("check_uvw", [np.zeros((4, 3))]),
    ("check_uvw", [np.zeros((4, 5, 2))]),
    ("check_uvw", [np.zeros((4, 5, 3), np.int32)]),
    ("check_uvw", [np.zeros((4, 5, 3)), 3]),
    ("check_uvw", [np.zeros((4, 5, 3)), None, 4]),
    ("check_vis", [np.zeros((2, 5, 2, 1))]),
    ("check_vis", [np.zeros((2, 5, 2, 3), complex)]),
    ("check_vis", [np.zeros((2, 5, 2), complex)]),
    ("check_weights", [np.zeros((2, 5, 2, 1)),
                       np.zeros((2, 5, 3, 1), complex)]),
    ("check_weights", [np.zeros((2, 5, 2, 1), complex)]),
    ("check_weights", [np.zeros((2, 5, 2))]),
])
def test_data_model_errors_match_jax(fn, args):
    """The same error class as JAX on NumPy and on tensor inputs."""
    with pytest.raises(jerr.SdpError) as want:
        getattr(ju, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                          else a for a in args])
    error = getattr(tu, type(want.value).__name__)
    for conv in (lambda a: a, torch.as_tensor):
        with pytest.raises(error):
            getattr(tu, fn)(*[conv(a) if isinstance(a, np.ndarray) else a
                              for a in args])


def test_metadata_matches_jax():
    uvw = np.zeros((4, 5, 3))
    vis = np.zeros((4, 5, 6, 4), np.complex64)
    assert tu.get_uvw_metadata(torch.as_tensor(uvw)) == tuple(
        ju.get_uvw_metadata(jnp.asarray(uvw)))
    assert tu.get_vis_metadata(vis) == tuple(
        ju.get_vis_metadata(jnp.asarray(vis)))
    tu.check_weights(np.zeros((4, 5, 6, 4)), vis)


@pytest.mark.parametrize("call, error", [
    (lambda: tv.dft_point_v00(np.zeros((2, 3)), np.zeros((2, 1, 1), complex),
                              np.zeros((4, 2, 3)), device=CPU),
     SdpShapeError),
    (lambda: tv.dft_point_v00(np.zeros((2, 3)), np.zeros((2, 1, 2), complex),
                              np.zeros((4, 2, 1, 3)), device=CPU),
     SdpShapeError),
    (lambda: tv.dft_point_v01(np.zeros((2, 3)), np.zeros((2, 1), complex),
                              np.zeros((4, 2, 3)), 1e9, 1e6, device=CPU),
     SdpShapeError),
    (lambda: tv.flagger_dynamic_threshold(np.zeros((4, 8), complex),
                                          device=CPU), SdpShapeError),
    (lambda: tv.flagger_dynamic_threshold(np.zeros((4, 2, 8, 1)),
                                          device=CPU), SdpDataTypeError),
    (lambda: tv.briggs_weights(np.zeros((4, 3)), np.asarray([1e9]), 100.0,
                               0.5, np.ones((4, 3, 1, 1)), device=CPU),
     SdpShapeError),
    (lambda: tv.uniform_weights(np.zeros((2, 3, 2)), np.asarray([1e9]),
                                10.0, np.ones((2, 3, 1, 1)), device=CPU),
     SdpShapeError),
    (lambda: tv.uniform_weights(np.zeros((2, 3, 3)), np.asarray([1e9]),
                                10.0, np.ones((2, 3, 1, 1), complex),
                                device=CPU), SdpDataTypeError),
    (lambda: tv.phase_rotate_vis(tu.SkyCoord("icrs", 0.0),
                                 tu.SkyCoord("icrs", 0.1), 1e9, 1e6,
                                 np.zeros((2, 3, 3)),
                                 np.zeros((2, 3, 4), complex), device=CPU),
     SdpShapeError),
    (lambda: tv.get_uv_range(np.zeros((4, 3)), np.asarray([1e9])),
     SdpShapeError),
])
def test_visibility_error_paths(call, error):
    with pytest.raises(error):
        call()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_division_forms_match_jax(dtype):
    """The index arithmetic's two division forms, bit for bit: inside
    ``jit`` XLA multiplies by the constant's inverse (``times_inverse``),
    outside it JAX divides (``divide``); both are the same on every
    device, where a CUDA division by a host scalar is not."""
    import jax

    from ska_sdp_func_torch.utility.tensors import divide, times_inverse

    c = 299792458.0
    x = np.random.default_rng(0).uniform(1e8, 2e9, 4096).astype(dtype)
    jit = np.asarray(jax.jit(lambda v: v / dtype(c))(jnp.asarray(x)))
    eager = np.asarray(jnp.asarray(x) / dtype(c))
    np.testing.assert_array_equal(
        times_inverse(torch.as_tensor(x), c).numpy(), jit)
    np.testing.assert_array_equal(divide(torch.as_tensor(x), c).numpy(),
                                  eager)
    assert (jit != eager).any()
