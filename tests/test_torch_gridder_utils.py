"""The port's gridder helpers (array algebra, image <-> component lists,
the w-step choice, the direct Fourier transforms) and the kernels'
dense exports against the JAX package on the same NumPy-seeded inputs
(tests/test_gridder_utils.py's sizes and the gridder-helper cases of
tests/test_negative_paths.py), on the CPU.

Tolerances: counts, component lists' positions and scalars exact or
1e-12 relative; f64 elementwise results (the algebra, lmn) 1e-12 of
max|JAX|; the sums of the DFT / iDFT and ``rms_diff`` (reductions) 1e-10
of max|JAX|; ``sum_diff`` (int64) exact.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch import grid_data as tg  # noqa: E402
from ska_sdp_func_torch import kernels as tk  # noqa: E402
from ska_sdp_func_torch.kernels import dense_tap  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ska_sdp_func_tpu import grid_data as jg  # noqa: E402

CPU = "cpu"


def close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max(initial=0.0) \
        <= tol * np.abs(want).max(initial=0.0)


def _complex(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("exponent", [0, 1, 2, 3, -2, 0.5])
def test_array_algebra_matches_jax(exponent):
    rng = np.random.default_rng(19)
    a = _complex(rng, (8, 8))
    b = np.exp(1j * rng.standard_normal((8, 8)))
    out = _complex(rng, (8, 8))
    for o in (out, out.real.copy()):
        close(tg.accumulate_scaled_arrays(o, a, b, exponent, device=CPU),
              jg.accumulate_scaled_arrays(jnp.asarray(o), jnp.asarray(a),
                                          jnp.asarray(b), exponent), 1e-12)
    close(tg.accumulate_scaled_arrays(out, a, None, exponent, device=CPU),
          jg.accumulate_scaled_arrays(jnp.asarray(out), jnp.asarray(a),
                                      None, exponent), 1e-12)
    if exponent != 0:
        close(tg.scale_inv_array(a, b, exponent, device=CPU),
              jg.scale_inv_array(jnp.asarray(a), jnp.asarray(b), exponent),
              1e-12)


def test_differences_match_jax():
    rng = np.random.default_rng(21)
    a, b = _complex(rng, (6, 5)), _complex(rng, (6, 5))
    close(tg.residual(a, b, device=CPU),
          jg.residual(jnp.asarray(a), jnp.asarray(b)), 1e-12)
    close(tg.rms_diff(a, b, device=CPU),
          jg.rms_diff(jnp.asarray(a), jnp.asarray(b)), 1e-10)
    ia = rng.integers(-50, 50, (6, 5))
    ib = rng.integers(-50, 50, (6, 5))
    for rows in ((0, None), (2, 5)):
        want = jg.sum_diff(jnp.asarray(ia), jnp.asarray(ib), *rows)
        got = tg.sum_diff(ia, ib, *rows, device=CPU)
        assert got.dtype == torch.int64 and int(got) == int(want)
    with pytest.raises(SdpShapeError):
        tg.residual(a, b[:5], device=CPU)
    with pytest.raises(SdpShapeError):
        tg.rms_diff(a, b[:, :4], device=CPU)


@pytest.mark.parametrize("shear", [(0.0, 0.0), (0.1, -0.05)])
def test_image_components_match_jax(shear):
    """image_lmn over every pixel; image_to_flmn of the non-zero pixels,
    with and without a taper; the non-zero count; from NumPy and from a
    tensor."""
    theta = 0.01
    rng = np.random.default_rng(31)
    image = np.zeros((8, 10))
    image[rng.integers(0, 8, 6), rng.integers(0, 10, 6)] = \
        rng.standard_normal(6)
    close(tg.image_lmn((8, 10), theta, *shear, device=CPU),
          jg.image_lmn((8, 10), theta, *shear), 1e-12)
    taper = rng.uniform(0.5, 1.0, 10)
    for kw in ({}, {"image_taper_1d": taper[:8]}):
        jflux, jlmn = jg.image_to_flmn(image[:, :8], theta, *shear, **kw)
        for img in (image[:, :8], torch.as_tensor(image[:, :8])):
            flux, lmn = tg.image_to_flmn(img, theta, *shear, **kw)
            np.testing.assert_array_equal(flux, jflux)
            close(lmn, jlmn, 1e-12)
    assert tg.count_nonzero_pixels(torch.as_tensor(image)) == \
        jg.count_nonzero_pixels(jnp.asarray(image)) > 0


@pytest.mark.parametrize("args", [(0.02, 0.01), (0.02, 0.01, 0.1, 0.2),
                                  (0.05, 0.03, 0.0, 0.0, 0.4)])
def test_determine_w_step_matches_jax(args):
    assert tg.determine_w_step(*args) == pytest.approx(
        jg.determine_w_step(*args), rel=1e-12)


@pytest.fixture(scope="module")
def dft_case():
    rng = np.random.default_rng(23)
    num_rows, num_src = 20, 4
    uvws = rng.uniform(-50, 50, (num_rows, 3))
    flux = rng.random(num_src)
    lmn = np.column_stack([rng.uniform(-0.01, 0.01, num_src),
                           rng.uniform(-0.01, 0.01, num_src),
                           np.zeros(num_src)])
    lmn[:, 2] = np.sqrt(1 - lmn[:, 0] ** 2 - lmn[:, 1] ** 2) - 1
    start = np.zeros(num_rows, np.int32)
    end = np.full(num_rows, 3, np.int32)
    end[3] = 0  # one empty row
    return dict(uvws=uvws, flux=flux, lmn=lmn, start=start, end=end,
                vis=_complex(rng, (num_rows, 3)))


@pytest.mark.parametrize("form", ["offsets", "plain", "accumulate", "f32"])
def test_dft_matches_jax(dft_case, form):
    d = dft_case
    j = {k: jnp.asarray(v) for k, v in d.items()}
    args = ()
    kw = dict(freq0_hz=1e9, dfreq_hz=1e7, num_chan=3)
    if form == "offsets":
        args = (d["start"], d["end"], 2, -1, 1, 0.01, 100.0)
    tol = 1e-10
    uvws = d["uvws"]
    if form == "f32":
        uvws, tol = uvws.astype(np.float32), 1e-5
    want = jg.dft(jnp.asarray(uvws), j["flux"], j["lmn"],
                  *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                    for a in args],
                  vis=j["vis"] if form == "accumulate" else None, **kw)
    got = tg.dft(uvws, d["flux"], d["lmn"], *args,
                 vis=d["vis"] if form == "accumulate" else None,
                 device=CPU, **kw)
    close(got, want, tol)


@pytest.mark.parametrize("form", ["shape", "taper", "complex_image",
                                  "real_image", "offsets"])
def test_idft_matches_jax(dft_case, form):
    d = dft_case
    size, theta = 4, 0.01
    lmn = np.asarray(jg.image_lmn((size, size), theta))
    rng = np.random.default_rng(29)
    kw = dict(freq0_hz=1e9, dfreq_hz=1e7)
    args = [None, None, None]
    if form == "taper":
        args[2] = rng.uniform(0.5, 1.0, size)
    if form == "offsets":
        args = [d["start"], d["end"], None, 1, 2, -1, theta, 50.0]
    if form == "complex_image":
        kw["image"] = _complex(rng, (size, size))
    elif form == "real_image":
        kw["image"] = rng.standard_normal((size, size))
    else:
        kw["image_shape"] = (size, size)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = jg.idft(jnp.asarray(d["uvws"]), jnp.asarray(d["vis"]),
                   jnp.asarray(lmn),
                   *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                     for a in args], **jkw)
    got = tg.idft(d["uvws"], d["vis"], lmn, *args, device=CPU, **kw)
    close(got, want, 1e-10)


def test_dft_idft_adjoint():
    """vdot(vis, DFT(image)) == vdot(iDFT(vis), image) on the port."""
    rng = np.random.default_rng(29)
    uvws = rng.uniform(-100, 100, (30, 3))
    vis = _complex(rng, (30, 2))
    image = rng.standard_normal((8, 8))
    lmn = tg.image_lmn((8, 8), 0.01, device=CPU)
    predicted = tg.dft(uvws, image.ravel(), lmn, None, None, 0, 0, 0, 0.01,
                       0.0, 1e9, 1e7, 2, device=CPU)
    dirty = tg.idft(uvws, vis, lmn, None, None, None, 0, 0, 0, 0.01, 0.0,
                    1e9, 1e7, image_shape=(8, 8), device=CPU)
    np.testing.assert_allclose(np.vdot(vis, predicted.numpy()),
                               np.vdot(dirty.numpy(), image), rtol=1e-12)


@pytest.mark.parametrize("call, error", [
    (lambda: tg.dft(np.zeros((4, 3)), np.ones(2), np.zeros((3, 3)),
                    device=CPU), SdpShapeError),
    (lambda: tg.dft(np.zeros((4, 3)), np.ones(2), np.zeros((2, 2)),
                    device=CPU), SdpShapeError),
    (lambda: tg.dft(np.zeros((4, 2)), np.ones(2), np.zeros((2, 3)),
                    device=CPU), SdpShapeError),
    (lambda: tg.dft(np.zeros((4, 3), np.int32), np.ones(2),
                    np.zeros((2, 3)), device=CPU), SdpInvalidArgumentError),
    (lambda: tg.idft(np.zeros((4, 3)), np.zeros((4, 1), complex),
                     np.zeros((4, 3)), device=CPU), SdpInvalidArgumentError),
])
def test_gridder_helper_error_paths(call, error):
    with pytest.raises(error):
        call()


def test_dense_kernels_exported():
    """kernels exports the dense banded products as the JAX package's
    kernels/__init__.py does."""
    assert tk.grid_plane_dense is dense_tap.grid_plane_dense
    assert tk.degrid_plane_dense is dense_tap.degrid_plane_dense
    assert {"grid_plane_dense", "degrid_plane_dense"} <= set(tk.__all__)
