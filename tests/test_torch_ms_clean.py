"""Multi-scale CLEAN (ska_sdp_func_torch.clean.ms_clean) against JAX.

``ms_clean_cornwell`` on tests/test_clean.py's data (a few point sources
imaged with the JAX package's DFT, f64) at ``decimal=6`` as the JAX
suite holds its oracle; the solver's multi-scale minor cycle
(``_make_msclean_minor``, with its re-registered scale convolutions) with
the selection bias 0 and 0.6 at 1e-9 of the dirty peak in f64 (the same
f64 arithmetic and first-maximum argmax, so the same components in the
same order), and in f32 at 1e-5.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.clean import ms_clean_cornwell  # noqa: E402
from ska_sdp_func_torch.clean import ms_clean as tms  # noqa: E402
from ska_sdp_func_torch.pipeline import major_cycle as tmc  # noqa: E402
from ska_sdp_func_tpu.clean import hogbom as jhog  # noqa: E402
from ska_sdp_func_tpu.clean import ms_clean as jms  # noqa: E402
from ska_sdp_func_tpu.grid_data import dft, idft, image_lmn, \
    image_to_flmn  # noqa: E402
from ska_sdp_func_tpu.pipeline import major_cycle as jmc  # noqa: E402

C_0 = 299792458.0
CBEAM = [2.0, 2.0, 1.0, 128.0]


@pytest.fixture(scope="module")
def clean_data():
    """tests/test_clean.py's ``clean_data``: six point sources in a 64^2
    image, 300 rows x 2 channels, dirty image and 2N PSF by DFT."""
    rng = np.random.default_rng(123)
    size, theta = 64, 0.002
    freq0, dfreq = C_0, C_0 / 100
    num_rows, num_chan = 300, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3)) * np.array([7000.0, 7000.0, 0.0])
    sky = np.zeros((size, size))
    for _ in range(6):
        sky[rng.integers(8, size - 8), rng.integers(8, size - 8)] = \
            rng.uniform(0.3, 1.0)
    flux, lmn = image_to_flmn(sky, theta)
    vis = dft(jnp.asarray(uvw), jnp.asarray(flux), jnp.asarray(lmn),
              None, None, 0, 0, 0, theta, 0.0, freq0, dfreq, num_chan)
    nvis = num_rows * num_chan
    dirty = np.asarray(idft(jnp.asarray(uvw), vis,
                            image_lmn((size, size), theta), None, None,
                            None, 0, 0, 0, theta, 0.0, freq0, dfreq,
                            image_shape=(size, size))).real / nvis
    psf = np.asarray(idft(jnp.asarray(uvw), jnp.ones_like(vis),
                          image_lmn((2 * size, 2 * size), 2 * theta), None,
                          None, None, 0, 0, 0, 2 * theta, 0.0, freq0, dfreq,
                          image_shape=(2 * size, 2 * size))).real / nvis
    return dict(dirty=dirty, psf=psf)


def test_ms_clean_cornwell_matches_jax(clean_data):
    dirty, psf = clean_data["dirty"], clean_data["psf"]
    args = (CBEAM, [0, 2, 4], 0.1, 1e-3, 300)
    want = jms.ms_clean_cornwell(jnp.asarray(dirty), jnp.asarray(psf), *args)
    got = ms_clean_cornwell(dirty, psf, *args, device="cpu")
    assert np.abs(np.asarray(want[0])).max() > 0
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float64
        np.testing.assert_array_almost_equal(g.numpy(), np.asarray(w),
                                             decimal=6)


def test_ms_clean_stops_at_threshold(clean_data):
    """A threshold above every scale's raw peak: nothing is cleaned."""
    dirty, psf = clean_data["dirty"], clean_data["psf"]
    model, residual, _ = ms_clean_cornwell(dirty, psf, CBEAM, [0, 2], 0.1,
                                           1e9, 50, device="cpu")
    assert float(model.abs().max()) == 0.0
    scaled = tms._scaled_residuals(torch.as_tensor(dirty),
                                   tms._make_scale_kernels([0], 128,
                                                           torch.float64,
                                                           "cpu"),
                                   tmc.fft_convolution)
    assert torch.equal(residual, scaled[0])


def test_scale_kernels_match_jax():
    want = np.asarray(jms._make_scale_kernels(np.array([0, 3, 8]), 32,
                                              jnp.float64))
    got = tms._make_scale_kernels(np.array([0, 3, 8]), 32, torch.float64,
                                  "cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _point_psf(size, dtype):
    """The JAX suite's biased-selection case: a 2N Gaussian PSF (clean
    beam 3 px) and the dirty image of one point at (70, 58)."""
    psf = np.asarray(jhog.create_cbeam(
        jnp.asarray([3.0, 3.0, 0.0, 2 * size], jnp.float64), 2 * size))
    psf = (psf / psf.max()).astype(dtype)
    x0, y0 = 70 * size // 128, 58 * size // 128
    dirty = psf[size - x0:2 * size - x0, size - y0:2 * size - y0].copy()
    dirty += 0.3 * psf[size - 20:2 * size - 20, size - 40:2 * size - 40]
    return psf, dirty


@pytest.mark.parametrize("bias", [0.0, 0.6])
@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-9),
                                        (np.float32, 1e-5)])
def test_msclean_minor_matches_jax(bias, dtype, tol):
    size = 64
    psf, dirty = _point_psf(size, dtype)
    scales, stop = (0, 4, 16), 0.05
    j_model, j_res = jmc._make_msclean_minor(
        jnp.asarray(psf), scales, 0.1, 150, bias)(jnp.asarray(dirty),
                                                  jnp.asarray(stop, dtype))
    minor = tmc._make_msclean_minor(torch.as_tensor(psf), scales, 0.1, 150,
                                    bias)
    t_model, t_res = minor(torch.as_tensor(dirty),
                           torch.as_tensor(stop, dtype=torch.as_tensor(
                               dirty).dtype))
    j_model, j_res = np.asarray(j_model), np.asarray(j_res)
    peak = np.abs(dirty).max()
    assert np.abs(j_model).max() > 0.1
    assert np.abs(t_model.numpy() - j_model).max() <= tol * peak
    assert np.abs(t_res.numpy() - j_res).max() <= tol * peak
