"""SwiFTly in the port against the JAX package and the analytic
point-source oracles of tests/test_swiftly.py.

Tolerances: the plan's tables bit for bit; every method against JAX at
1e-12 of the largest magnitude (f64 data, the same operations in another
library's FFTs); the oracles at the JAX tests' bounds (decimal 15 for the
constant subgrid, decimal 8 for the 1-D and 2-D point-source DFTs,
decimal 11 for the reverse chain, 1e-12 for the prepare/finish inverse,
1e-14 for the batch against one call).
"""

import itertools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.fourier_transforms import Swiftly  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ska_sdp_func_tpu.fourier_transforms import (  # noqa: E402
    Swiftly as JSwiftly,
)

PARAMS = dict(W=13.5625, N=1024, yB_size=416, yN_size=512, xA_size=228,
              xM_size=256)
TOL = 1e-12


@pytest.fixture(scope="module")
def plans():
    p = PARAMS
    return (Swiftly(p["N"], p["yN_size"], p["xM_size"], p["W"],
                    device="cpu"),
            JSwiftly(p["N"], p["yN_size"], p["xM_size"], p["W"]))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def facet_from_sources(sources, image_size, facet_size, facet_offset):
    facet = np.zeros(facet_size, complex)
    for intensity, x in sources:
        pos = (x - facet_offset + facet_size // 2) % image_size
        if 0 <= pos < facet_size:
            facet[pos] += intensity
    return facet


def subgrid_from_sources(sources, image_size, subgrid_size, subgrid_offset):
    us = np.arange(subgrid_offset - subgrid_size // 2,
                   subgrid_offset + (subgrid_size + 1) // 2)
    subgrid = np.zeros(subgrid_size, complex)
    for intensity, x in sources:
        subgrid += (intensity / image_size) * np.exp(
            2j * np.pi * us * x / image_size)
    return subgrid


def facet_to_subgrid(sw, facet, facet_off, sg_off, xA_size, zeros):
    prepped = sw.prepare_facet(facet, facet_off)
    contrib = sw.extract_from_facet(prepped, sg_off)
    acc = sw.add_to_subgrid(contrib, zeros(sw.xM_size), facet_off)
    return _np(sw.finish_subgrid(acc, xA_size, sg_off))


def _zeros_t(*shape):
    return torch.zeros(shape, dtype=torch.complex128)


def _zeros_j(*shape):
    return jnp.zeros(shape, complex)


def test_tables_bit_equal(plans):
    """The port samples Fn and Fb as JAX does, bit for bit
    (tests/test_torch_plan.py carries a JAX plan's tables across)."""
    sw, jsw = plans
    np.testing.assert_array_equal(sw.Fn.numpy(), np.asarray(jsw.Fn))
    np.testing.assert_array_equal(sw.Fb.numpy(), np.asarray(jsw.Fb))
    assert sw.Fn.dtype == torch.float64 and sw.device.type == "cpu"
    assert sw.xM_yN_size == jsw.xM_yN_size


def test_facet_to_subgrid_constant(plans):
    """A unit source at the image centre gives a constant val/N over the
    whole subgrid, for any facet/subgrid offsets."""
    sw, _ = plans
    p = PARAMS
    Nx = p["N"] // p["yN_size"]
    Ny = p["N"] // p["xM_size"]
    for val, facet_off in itertools.product(
            [1.0, 0.1], np.arange(-5 * Ny, 5 * Ny // 2, Ny)):
        facet = np.zeros(p["yB_size"], complex)
        facet[p["yB_size"] // 2 - facet_off] = val
        for sg_off in np.arange(0, 10 * Nx, Nx):
            subgrid = facet_to_subgrid(sw, facet, int(facet_off),
                                       int(sg_off), p["xA_size"], _zeros_t)
            np.testing.assert_array_almost_equal(
                subgrid, val / p["N"], decimal=15)


@pytest.mark.parametrize("xA_size", [PARAMS["xA_size"],
                                     PARAMS["xA_size"] - 1])
@pytest.mark.parametrize("yB_size", [PARAMS["yB_size"],
                                     PARAMS["yB_size"] - 1])
def test_facet_to_subgrid_dft_1d(plans, xA_size, yB_size):
    """The 1-D forward chain against the DFT oracle (decimal 8) and the
    JAX chain (1e-12), odd and even facet and subgrid sizes."""
    sw, jsw = plans
    p = PARAMS
    Nx = p["N"] // p["yN_size"]
    Ny = p["N"] // p["xM_size"]
    source_sets = [
        [(1, 0)], [(2, 1)], [(1, -3)], [(-0.1, 5)],
        [(1 / 8, 20), (2 / 8, 5), (3 / 8, -4)],
        [(1 / 16, i) for i in range(-10, 10)],
    ]
    for n, (sources, facet_off) in enumerate(itertools.product(
            source_sets, np.arange(-50 * Ny, 50 * Ny, 20 * Ny))):
        facet_off = int(facet_off)
        min_x = -(yB_size - 1) // 2 + facet_off
        max_x = min_x + yB_size - 1
        sources = [(i, min(max(x, min_x), max_x)) for i, x in sources]
        facet = facet_from_sources(sources, p["N"], yB_size, facet_off)
        for sg_off in [0, Nx, -Nx, p["N"]]:
            subgrid = facet_to_subgrid(sw, facet, facet_off, int(sg_off),
                                       xA_size, _zeros_t)
            expected = subgrid_from_sources(sources, p["N"], xA_size,
                                            int(sg_off))
            np.testing.assert_array_almost_equal(subgrid, expected,
                                                 decimal=8)
            if n % 5 == 0:
                _close(subgrid, facet_to_subgrid(
                    jsw, jnp.asarray(facet), facet_off, int(sg_off),
                    xA_size, _zeros_j))


def _chain_2d(sw, facet, zeros, f0, f1, s0, s1):
    prepped0 = sw.prepare_facet(facet.T, f0).T
    prepped = sw.prepare_facet(prepped0, f1)
    contrib0 = sw.extract_from_facet(prepped.T, s0).T
    contrib = sw.extract_from_facet(contrib0, s1)
    acc = sw.add_to_subgrid_2d(contrib, zeros(sw.xM_size, sw.xM_size),
                               f0, f1)
    return sw.finish_subgrid_inplace_2d(acc, s0, s1)


def test_facet_to_subgrid_dft_2d(plans):
    sw, jsw = plans
    p = PARAMS
    yB, xA = p["yB_size"], p["xA_size"]
    sources = [(1.0, 2, 3), (0.5, -10, 5)]
    f0, f1, s0, s1 = 0, 4, 4, 0
    facet = np.zeros((yB, yB), complex)
    for inten, x0, x1 in sources:
        facet[(x0 - f0 + yB // 2) % p["N"],
              (x1 - f1 + yB // 2) % p["N"]] += inten
    full = _chain_2d(sw, torch.as_tensor(facet), _zeros_t, f0, f1, s0, s1)
    _close(full, _chain_2d(jsw, jnp.asarray(facet), _zeros_j, f0, f1, s0,
                           s1))
    lo = sw.xM_size // 2 - xA // 2
    subgrid = full.numpy()[lo:lo + xA, lo:lo + xA]
    u0 = np.arange(s0 - xA // 2, s0 + (xA + 1) // 2)
    u1 = np.arange(s1 - xA // 2, s1 + (xA + 1) // 2)
    expected = np.zeros((xA, xA), complex)
    for inten, x0, x1 in sources:
        expected += (inten / p["N"] ** 2) * np.exp(
            2j * np.pi * (u0[:, None] * x0 + u1[None, :] * x1) / p["N"])
    np.testing.assert_array_almost_equal(subgrid, expected, decimal=8)


def test_subgrid_to_facet_dft(plans):
    """Reverse chain: a partially-filled (xA-sized, scaled) subgrid
    reproduces the facet's source pixels (decimal 11), as JAX's chain
    does (1e-12)."""
    sw, jsw = plans
    p = PARAMS
    Nx = p["N"] // p["yN_size"]
    Ny = p["N"] // p["xM_size"]
    yB, xM, xA = p["yB_size"], p["xM_size"], p["xA_size"]
    source_lists = [[(1.0, 0)], [(2.0, 1)], [(1.0, -3)], [(-0.1, 5)]]
    for sources, sg_off in itertools.product(
            source_lists, Nx * np.arange(-9, 8, 4)):
        sg_off = int(sg_off)
        subgrid = subgrid_from_sources(sources, p["N"], xA, sg_off) \
            / xA * p["N"]
        lo = xM // 2 - xA // 2
        padded = np.zeros(xM, complex)
        padded[lo:lo + xA] = subgrid
        prep_sg = sw.prepare_subgrid_inplace(padded, sg_off)
        j_prep = jsw.prepare_subgrid_inplace(jnp.asarray(padded), sg_off)
        for facet_off in (Ny * np.arange(-9, 8, 4)).tolist():
            contrib = sw.extract_from_subgrid(prep_sg, int(facet_off))
            prepped = sw.add_to_facet(contrib, _zeros_t(p["yN_size"]),
                                      sg_off)
            facet = sw.finish_facet(prepped, yB, int(facet_off)).numpy()
            expected = facet_from_sources(sources, p["N"], yB,
                                          int(facet_off))
            nz = expected != 0
            np.testing.assert_array_almost_equal(
                facet[nz], expected[nz], decimal=11)
            if sources[0][0] > 0:
                np.testing.assert_array_less(facet[~nz].real,
                                             np.max(expected.real))
        j_contrib = jsw.extract_from_subgrid(j_prep, int(facet_off))
        j_facet = jsw.finish_facet(jsw.add_to_facet(
            j_contrib, _zeros_j(p["yN_size"]), sg_off), yB, int(facet_off))
        _close(facet, j_facet)


def test_prepare_finish_subgrid_inverse(plans):
    sw, _ = plans
    p = PARAMS
    rng = np.random.default_rng(0)
    data = rng.standard_normal(p["xM_size"]) \
        + 1j * rng.standard_normal(p["xM_size"])
    for off in [0, 4, -8, 100]:
        back = sw.finish_subgrid_inplace(
            sw.prepare_subgrid_inplace(data, off), off).numpy()
        np.testing.assert_allclose(back, data, atol=1e-12)
    data2 = rng.standard_normal((p["xM_size"], p["xM_size"])) + 0j
    back2 = sw.finish_subgrid_inplace_2d(
        sw.prepare_subgrid_inplace_2d(data2, 4, -8), 4, -8).numpy()
    np.testing.assert_allclose(back2, data2, atol=1e-12)


def test_batched_broadcast(plans):
    """Leading axes broadcast: a batch is one call, equal to its rows'
    single calls."""
    sw, _ = plans
    p = PARAMS
    rng = np.random.default_rng(1)
    batch = rng.standard_normal((3, p["yB_size"])) + 0j
    prepped = sw.prepare_facet(batch, 0)
    assert prepped.shape == (3, p["yN_size"])
    single = sw.prepare_facet(batch[1], 0)
    np.testing.assert_allclose(prepped[1].numpy(), single.numpy(),
                               atol=1e-14)
    contrib = sw.extract_from_facet(prepped, 12)
    acc = sw.add_to_subgrid(contrib, _zeros_t(3, p["xM_size"]), 4)
    one = sw.add_to_subgrid(sw.extract_from_facet(single, 12),
                            _zeros_t(p["xM_size"]), 4)
    np.testing.assert_allclose(acc[1].numpy(), one.numpy(), atol=1e-14)


def _random(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("method", [
    "prepare_facet", "extract_from_facet", "add_to_subgrid",
    "add_to_subgrid_2d", "finish_subgrid_inplace", "finish_subgrid",
    "finish_subgrid_inplace_2d", "prepare_subgrid_inplace",
    "prepare_subgrid_inplace_2d", "extract_from_subgrid",
    "extract_from_subgrid_2d", "add_to_facet", "finish_facet"])
def test_method_matches_jax(plans, method):
    """Each method on batched random f64 data at negative, positive and
    wrapping offsets, against JAX's at 1e-12; complex64 input keeps its
    dtype as JAX's does."""
    sw, jsw = plans
    p = PARAMS
    rng = np.random.default_rng(11)
    m, xM, yN = sw.xM_yN_size, p["xM_size"], p["yN_size"]
    cases = {
        "prepare_facet": lambda o: (_random(rng, 2, p["yB_size"]), o),
        "extract_from_facet": lambda o: (_random(rng, 2, yN), o),
        "add_to_subgrid": lambda o: (_random(rng, 2, m),
                                     _random(rng, 2, xM), o),
        "add_to_subgrid_2d": lambda o: (_random(rng, 2, m, m),
                                        _random(rng, 2, xM, xM), o, -o),
        "finish_subgrid_inplace": lambda o: (_random(rng, 2, xM), o),
        "finish_subgrid": lambda o: (_random(rng, 2, xM), p["xA_size"], o),
        "finish_subgrid_inplace_2d": lambda o: (_random(rng, 2, xM, xM), o,
                                                3 - o),
        "prepare_subgrid_inplace": lambda o: (_random(rng, 2, xM), o),
        "prepare_subgrid_inplace_2d": lambda o: (_random(rng, 2, xM, xM),
                                                 -o, o),
        "extract_from_subgrid": lambda o: (_random(rng, 2, xM), o),
        "extract_from_subgrid_2d": lambda o: (_random(rng, 2, xM, xM), o,
                                              2 * o),
        "add_to_facet": lambda o: (_random(rng, 2, m), _random(rng, 2, yN),
                                   o),
        "finish_facet": lambda o: (_random(rng, 2, yN), p["yB_size"], o),
    }
    for off in (-1100, -12, 0, 8, 260, 1030):
        args = cases[method](off)
        got = getattr(sw, method)(*args)
        want = getattr(jsw, method)(*(
            jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args))
        _close(got, want)
    args64 = [a.astype(np.complex64) if isinstance(a, np.ndarray) else a
              for a in cases[method](16)]
    got = getattr(sw, method)(*args64)
    want = getattr(jsw, method)(*(
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args64))
    _close(got, want, 1e-5)


def test_swiftly_validation():
    with pytest.raises(SdpInvalidArgumentError):
        Swiftly(1024, 500, 256, 13.0, device="cpu")   # N % yN != 0
    with pytest.raises(SdpInvalidArgumentError):
        Swiftly(1024, 512, 255, 13.0, device="cpu")   # odd xM
    with pytest.raises(SdpInvalidArgumentError):
        Swiftly(1024, 512, 0, 13.0, device="cpu")
    sw = Swiftly(1024, 512, 256, 13.5625, device="cpu")
    assert sw.get_image_size() == 1024
    assert sw.get_facet_size() == 512
    assert sw.get_subgrid_size() == 256
    assert sw.get_contribution_size() == 128
    with pytest.raises(SdpShapeError):
        sw.prepare_facet(np.zeros(513, complex), 0)
    with pytest.raises(SdpShapeError):
        sw.extract_from_facet(np.zeros(500, complex), 0)
    with pytest.raises(SdpShapeError):
        sw.finish_subgrid(np.zeros(256, complex), 257, 0)
    with pytest.raises(SdpShapeError):
        sw.finish_facet(np.zeros(512, complex), 513, 0)
