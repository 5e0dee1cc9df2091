"""The port's planned FFT, ``fft_norm`` and the PSWF's device path against
the JAX package on the same NumPy-seeded inputs (the sizes of
tests/test_fft.py, tests/test_pswf.py and the ``Fft`` / ``Pswf`` cases of
tests/test_negative_paths.py), on the CPU.

Tolerances: the host coefficients exact (the same NumPy code);
``fft_norm`` (a division) 1e-12 of max|JAX|; the transforms and the
Legendre sum (reductions) 1e-10 of max|JAX|.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch import fourier_transforms as tf  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpDataTypeError,
    SdpInvalidArgumentError,
)
from ska_sdp_func_tpu import fourier_transforms as jf  # noqa: E402

CPU = "cpu"


def close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _data(shape, dtype, seed=123):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("shape", [(16,), (16, 16), (3, 8, 12)])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_fft_norm_matches_jax(shape, dtype):
    x = _data(shape, dtype)
    tol = 1e-12 if dtype == np.complex128 else 1e-6
    close(tf.fft_norm(x, device=CPU), jf.fft_norm(jnp.asarray(x)), tol)


@pytest.mark.parametrize("shape, dims", [((32,), 1), ((16, 16), 2),
                                         ((4, 8, 8), 2), ((2, 4, 6, 8), 3),
                                         ((4, 8, 8), 1)])
@pytest.mark.parametrize("forward", [True, False])
def test_planned_fft_matches_jax(shape, dims, forward):
    """exec, exec_shift with and without norm, and the call form."""
    x = _data(shape, np.complex128, seed=len(shape) + dims)
    jplan = jf.Fft(jnp.asarray(x), dims, forward)
    tplan = tf.Fft(x, dims, forward, device=CPU)
    assert tplan.shape == jplan.shape and tplan.num_dims_fft == dims
    close(tplan.exec(x), jplan.exec(jnp.asarray(x)), 1e-10)
    close(tplan(torch.as_tensor(x)), jplan(jnp.asarray(x)), 1e-10)
    for norm in (False, True):
        close(tplan.exec_shift(x, norm=norm),
              jplan.exec_shift(jnp.asarray(x), norm=norm), 1e-10)


@pytest.mark.parametrize("call, error", [
    (lambda: tf.Fft(np.zeros((8, 8)), 2, True), SdpDataTypeError),
    (lambda: tf.Fft(np.zeros((8, 8), complex), 3), SdpInvalidArgumentError),
    (lambda: tf.Fft(np.zeros((8, 8), complex), 0), SdpInvalidArgumentError),
    (lambda: tf.Fft(np.zeros((8, 8), complex), 2, device=CPU).exec(
        np.zeros((8, 4), complex)), SdpInvalidArgumentError),
    (lambda: tf.Fft(np.zeros((8, 8), complex), 2, device=CPU).exec(
        np.zeros((8, 8))), SdpDataTypeError),
    (lambda: tf.fft_norm(np.zeros((8, 8)), device=CPU), SdpDataTypeError),
])
def test_fft_error_paths(call, error):
    with pytest.raises(error):
        call()


@pytest.mark.parametrize("support", [4, 8, 10, 14])
def test_pswf_device_path_matches_jax(support):
    """The coefficients bit for bit; the Legendre sum over the domain and
    outside it (zero) against JAX's, in f64 and f32."""
    c = support * np.pi / 2
    coeffs = tf.pswf_coefficients(c)
    np.testing.assert_array_equal(coeffs, jf.pswf_coefficients(c))
    np.testing.assert_array_equal(tf.pswf_coefficients(c, 40),
                                  jf.pswf_coefficients(c, 40))
    x = np.concatenate([np.linspace(-0.999, 0.999, 101), [-1.0, 1.0, 2.0]])
    for dtype, tol in ((np.float64, 1e-10), (np.float32, 1e-5)):
        xs = x.astype(dtype)
        want = jf.pswf_evaluate(jnp.asarray(xs), coeffs)
        got = tf.pswf_evaluate(xs, coeffs, device=CPU)
        close(got, want, tol)
        assert (got[-3:] == 0).all()


def test_pswf_plan_matches_jax():
    c = 5 * np.pi / 2
    tplan, jplan = tf.Pswf(0, c), jf.Pswf(0, c)
    v = tplan.values(64)
    assert tplan.values(64) is v
    np.testing.assert_array_equal(v, jplan.values(64))
    np.testing.assert_array_equal(tplan.values(10, True),
                                  jplan.values(10, True))
    np.testing.assert_array_equal(tplan.evaluate(0.5), jplan.evaluate(0.5))
    np.testing.assert_array_equal(tplan.coefficients, jplan.coefficients)
    x = np.linspace(-0.9, 0.9, 7)
    close(tplan.evaluate_device(x, device=CPU),
          jplan.evaluate_device(jnp.asarray(x)), 1e-10)
    with pytest.raises(SdpInvalidArgumentError):
        tf.Pswf(1, c).coefficients
