"""The port's station and element beams against the JAX package on the
same NumPy-seeded inputs (tests/test_station_beam.py's sizes and the beam
cases of tests/test_negative_paths.py), on the CPU (``device="cpu"``).

Tolerances: the f64 elementwise patterns (dipole, HARP terms) 1e-12 of
max|JAX|; the element sums of the aperture array (a reduction) 1e-10.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch import station_beam as tsb  # noqa: E402
from ska_sdp_func_torch.station_beam import element as tel  # noqa: E402
from ska_sdp_func_torch.station_beam import station as tst  # noqa: E402
from ska_sdp_func_torch.utility.errors import SdpDataTypeError  # noqa
from ska_sdp_func_torch.utility.errors import SdpShapeError  # noqa: E402
from ska_sdp_func_tpu import station_beam as jsb  # noqa: E402
from ska_sdp_func_tpu.station_beam import element as jel  # noqa: E402

CPU = "cpu"


def close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.abs(got[ok] - want[ok]).max(initial=0.0) \
        <= tol * np.abs(want[ok]).max()


def _station(seed, num_e, num_p):
    rng = np.random.default_rng(seed)
    ex, ey, ez = (rng.uniform(-10, 10, num_e) for _ in range(3))
    px, py = (rng.uniform(-0.5, 0.5, num_p) for _ in range(2))
    pz = np.sqrt(1 - px ** 2 - py ** 2)
    w = rng.standard_normal(num_e) + 1j * rng.standard_normal(num_e)
    return rng, (ex, ey, ez, px, py, pz), w


def _both(k, w, coords, **kw):
    jkw = {n: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for n, v in kw.items()}
    want = jsb.aperture_array(k, jnp.asarray(w),
                              *[jnp.asarray(c) for c in coords], **jkw)
    got = tsb.aperture_array(k, w, *coords, device=CPU, **kw)
    return got, want


@pytest.mark.parametrize("case", ["scalar", "no_z", "types", "polarised",
                                  "pols4", "unnormalised"])
def test_aperture_array_matches_jax(case):
    """16 elements x 25 points: scalar, without z, with 3 element types,
    polarised with the y dipoles off, 4-pol output without an element
    beam (x off), unnormalised."""
    rng, coords, w = _station(1, 16, 25)
    k = 2 * np.pi / 0.21
    kw = {}
    if case == "no_z":
        coords = coords[:5]
    elif case == "types":
        beam = (rng.standard_normal((3, 25))
                + 1j * rng.standard_normal((3, 25)))
        kw = dict(element_beam_index=rng.integers(0, 3, 16).astype(np.int32),
                  element_beam=beam)
    elif case == "polarised":
        beam = (rng.standard_normal((16, 25, 4))
                + 1j * rng.standard_normal((16, 25, 4)))
        kw = dict(element_beam=beam, eval_y=False)
    elif case == "pols4":
        kw = dict(num_pols=4, eval_x=False)
    elif case == "unnormalised":
        kw = dict(normalise=False)
    got, want = _both(k, w, coords, **kw)
    close(got, want, 1e-10)


def test_aperture_array_chunks_points(monkeypatch):
    """A phasor bound of 64 entries splits 25 points over 16 elements
    into chunks of 4: the same beam, scalar and with element beams."""
    rng, coords, w = _station(2, 16, 25)
    beam = rng.standard_normal((16, 25, 4)) + 0j
    whole = [tsb.aperture_array(3.0, w, *coords, device=CPU),
             tsb.aperture_array(3.0, w, *coords, element_beam=beam,
                                device=CPU)]
    monkeypatch.setattr(tst, "_CHUNK_ENTRIES", 64)
    got, want = _both(3.0, w, coords)
    close(got, want, 1e-10)
    np.testing.assert_array_equal(got.numpy(), whole[0].numpy())
    got, want = _both(3.0, w, coords, element_beam=beam)
    close(got, want, 1e-10)
    np.testing.assert_allclose(got.numpy(), whole[1].numpy(), rtol=0,
                               atol=1e-13 * np.abs(whole[1].numpy()).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dipole_patterns_match_jax(dtype):
    rng = np.random.default_rng(4)
    theta = rng.uniform(0.1, 1.4, 20).astype(dtype)
    phi = rng.uniform(0, 2 * np.pi, 20).astype(dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-6
    for jf, tf in ((jel.dipole_pattern, tel.dipole_pattern),
                   (jel.dipole_pattern_scalar, tel.dipole_pattern_scalar)):
        want = jf(jnp.asarray(theta), jnp.asarray(phi), 1e8, 1.5)
        got = tf(theta, phi, 1e8, 1.5, device=CPU)
        for g, wv in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            close(g, wv, tol)


@pytest.mark.parametrize("stride, offset, shape", [
    (4, 0, (20, 4)), (4, 2, (20, 4)), (1, 0, (20,)), (2, 1, (41,))])
def test_dipole_strided_write_matches_jax(stride, offset, shape):
    rng = np.random.default_rng(6)
    theta = rng.uniform(0.1, 1.4, 20)
    phi = rng.uniform(0, 2 * np.pi, 20)
    beam = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    if stride == 4 and offset == 2:
        theta, phi = theta[:19], phi[:19]   # the last slot ends the array
    want = jel.dipole(jnp.asarray(theta), jnp.asarray(phi), 1e8, 1.5,
                      stride, offset, jnp.asarray(beam))
    got = tel.dipole(theta, phi, 1e8, 1.5, stride, offset, beam,
                     device=CPU)
    close(got, want, 1e-12)


@pytest.mark.parametrize("l_max", [1, 3, 5])
def test_spherical_wave_harp_matches_jax(l_max):
    rng = np.random.default_rng(5)
    num = 12
    theta = rng.uniform(0.0, 1.5, num)
    theta[0] = 0.0                      # the divide-by-zero guard
    phi_x = rng.uniform(0, 2 * np.pi, num)
    phi_y = phi_x + np.pi / 2
    n = 4 * ((l_max + 1) ** 2 - 1)
    alpha = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = jsb.spherical_wave_harp(jnp.asarray(theta), jnp.asarray(phi_x),
                                   jnp.asarray(phi_y), l_max,
                                   jnp.asarray(alpha))
    got = tsb.spherical_wave_harp(theta, phi_x, phi_y, l_max, alpha,
                                  device=CPU)
    close(got, want, 1e-12)


def test_spherical_wave_harp_nan_and_write_match_jax():
    """A NaN phi_x makes its point NaN; the pattern written at an offset
    into a [num_points + 3, 4] element beam."""
    theta = np.array([0.5, 0.7, 0.2])
    phi_x = np.array([np.nan, 0.3, 1.0])
    phi_y = np.array([0.2, 0.4, 0.1])
    alpha = np.arange(4 * 8) * (0.1 + 0.05j)
    beam = np.full((6, 4), 2.0 + 1.0j)
    want = jsb.spherical_wave_harp(jnp.asarray(theta), jnp.asarray(phi_x),
                                   jnp.asarray(phi_y), 2, jnp.asarray(alpha),
                                   2, jnp.asarray(beam))
    got = tsb.spherical_wave_harp(theta, phi_x, phi_y, 2, alpha, 2, beam,
                                  device=CPU)
    close(got, want, 1e-12)
    assert np.isnan(got.numpy()[2]).all() and np.isfinite(got.numpy()[3]).all()


@pytest.mark.parametrize("call", [
    lambda: tsb.aperture_array(1.0, np.ones(4), *[np.zeros(4)] * 3,
                               np.zeros(2), np.zeros(2), device=CPU),
    lambda: tsb.aperture_array(1.0, np.ones(4, complex), *[np.zeros(4)] * 3,
                               np.zeros(2), np.zeros(2),
                               element_beam=np.ones((4, 2)), device=CPU),
    lambda: tsb.dipole(np.zeros(2), np.zeros(2), 1e8, 1.5, 1, 0,
                       np.zeros(2), device=CPU),
])
def test_beams_reject_real_dtypes(call):
    with pytest.raises(SdpDataTypeError):
        call()


def test_aperture_array_rejects_bad_beam_shape():
    with pytest.raises(SdpShapeError):
        tsb.aperture_array(1.0, np.ones(4, complex), *[np.zeros(4)] * 3,
                           np.zeros(2), np.zeros(2),
                           element_beam=np.ones((4, 2, 3), complex),
                           device=CPU)


def test_beams_return_tensors_on_the_device():
    got = tsb.dipole(torch.zeros(3), torch.ones(3), 1e8, 1.5, 1, 0,
                     torch.zeros(3, dtype=torch.complex64), device=CPU)
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
