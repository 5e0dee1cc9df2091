"""Port helpers against the JAX package on identical NumPy inputs.

Tolerances: shifted FFTs 1e-6 of max|out| (f32 transforms, different FFT
libraries); Clenshaw taps 1e-6 (same f32 operation order); host f64
tables exact; corrections 1e-6 (f32 rounding of the same f64 scale);
sub-grid placement exact (pure copies and one f32 add per element).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import ska_sdp_func_torch.fourier_transforms.fft as tfft  # noqa: E402
import ska_sdp_func_tpu.fourier_transforms.fft as jfft  # noqa: E402
from ska_sdp_func_torch.clean.hogbom import \
    create_cbeam as t_cbeam  # noqa: E402
from ska_sdp_func_torch.grid_data import (  # noqa: E402
    eval_kernel_taps as t_taps,
    grid_correct_pswf as t_gc,
    kernel_tap_coeffs as t_coeffs,
    make_w_pattern as t_wpat,
    subgrid_add_static as t_add,
    subgrid_cut_out_static as t_cut,
    w_screen_stack as t_screens,
)
from ska_sdp_func_torch.grid_data.wtower import \
    GridderWtowerUVW as TGridder  # noqa: E402
from ska_sdp_func_torch.numeric_functions import \
    fft_convolution as t_conv  # noqa: E402
from ska_sdp_func_tpu.clean.hogbom import \
    create_cbeam as j_cbeam  # noqa: E402
from ska_sdp_func_tpu.grid_data.grid_correct import (  # noqa: E402
    grid_correct_pswf as j_gc,
    w_screen_stack as j_screens,
)
from ska_sdp_func_tpu.grid_data.gridder_utils import (  # noqa: E402
    subgrid_add_static as j_add,
    subgrid_cut_out_static as j_cut,
)
from ska_sdp_func_tpu.grid_data.kernels import (  # noqa: E402
    eval_kernel_taps as j_taps,
    kernel_tap_coeffs as j_coeffs,
    make_w_pattern as j_wpat,
)
from ska_sdp_func_tpu.grid_data.wtower import \
    GridderWtowerUVW as JGridder  # noqa: E402
from ska_sdp_func_tpu.numeric_functions import \
    fft_convolution as j_conv  # noqa: E402

GEOM = (256, 0.002, 50.0, 0.0, 0.0, 8, 4)   # N, theta, w_step, shears, S, Sw


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("name", ["fft_shifted", "ifft_shifted",
                                  "ifft_shifted_norm"])
@pytest.mark.parametrize("shape", [(3, 64, 64), (32, 16)])
def test_shifted_ffts_match_jax(name, shape):
    x = _cplx(np.random.default_rng(1), shape)
    got = getattr(tfft, name)(torch.as_tensor(x)).numpy()
    want = np.asarray(getattr(jfft, name)(jnp.asarray(x)))
    assert got.dtype == np.complex64
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_fft_phase_rejects_real():
    from ska_sdp_func_torch.utility.errors import SdpDataTypeError

    with pytest.raises(SdpDataTypeError):
        tfft.fft_shifted(torch.zeros(4, 4))


@pytest.mark.parametrize("support, ov", [(8, 16384), (4, 16384)])
def test_kernel_tap_coeffs_exact(support, ov):
    np.testing.assert_array_equal(t_coeffs(support, support, ov),
                                  j_coeffs(support, support, ov))


@pytest.mark.parametrize("support", [8, 4])
def test_eval_kernel_taps_match_jax(support):
    ov = 16384
    coeffs = j_coeffs(support, support, ov)
    rows = np.random.default_rng(2).integers(0, ov + 1, 4096).astype(
        np.int32)
    got = t_taps(torch.as_tensor(rows), coeffs, ov).numpy()
    want = np.asarray(j_taps(jnp.asarray(rows), coeffs, ov))
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("shear", [(0.0, 0.0), (0.1, -0.05)])
def test_make_w_pattern_exact(shear):
    np.testing.assert_array_equal(t_wpat(128, 0.002, *shear, 50.0),
                                  j_wpat(128, 0.002, *shear, 50.0))


def test_gridder_plan_tables_exact():
    args = (256, 128, 0.002, 50.0, 0.0, 0.0, 8, 16384, 4, 16384)
    t, j = TGridder(*args), JGridder(*args)
    for name in ("uv_kernel", "w_kernel", "w_pattern"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.num_w_planes(0) == j.num_w_planes(0) == 0


@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
def test_grid_correct_pswf_matches_jax(dtype):
    rng = np.random.default_rng(3)
    n = GEOM[0]
    facet = _cplx(rng, (n, n))
    if dtype == np.float32:
        facet = facet.real.copy()
    got = t_gc(*GEOM, torch.as_tensor(facet)).numpy()
    want = np.asarray(j_gc(*GEOM, jnp.asarray(facet)))
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_w_screen_stack_matches_jax():
    offs = np.asarray([-8.0, 0.0, 4.0, 12.0])
    got = t_screens(*GEOM[:5], offs, dtype=torch.complex64).numpy()
    want = np.asarray(j_screens(*GEOM[:5], offs, dtype=jnp.complex64))
    assert got.shape == (4, GEOM[0], GEOM[0])
    assert np.abs(got - want).max() <= 1e-6


# Offsets chosen so the 64-square sub-grid wraps the 128 grid's edge on
# one axis, both axes, or neither.
OFFSETS = [(0, 0), (50, -3), (-60, 61), (127, 64)]


@pytest.mark.parametrize("off_u, off_v", OFFSETS)
def test_subgrid_add_static_exact(off_u, off_v):
    rng = np.random.default_rng(4)
    grid = _cplx(rng, (128, 128))
    sub = _cplx(rng, (64, 64))
    got = t_add(torch.as_tensor(grid.copy()), off_u, off_v,
                torch.as_tensor(sub), 4.0).numpy()
    want = np.asarray(j_add(jnp.asarray(grid), off_u, off_v,
                            jnp.asarray(sub), 4.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("off_u, off_v", OFFSETS)
def test_subgrid_cut_out_static_exact(off_u, off_v):
    grid = _cplx(np.random.default_rng(5), (128, 128))
    got = t_cut(torch.as_tensor(grid), off_u, off_v, 64).numpy()
    want = np.asarray(j_cut(jnp.asarray(grid), off_u, off_v, 64))
    np.testing.assert_array_equal(got, want)


def test_create_cbeam_matches_jax():
    details = np.asarray([2.0, 3.0, 30.0, 64.0], np.float32)
    got = t_cbeam(torch.as_tensor(details), 64).numpy()
    want = np.asarray(j_cbeam(jnp.asarray(details), 64))
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("n1, n2", [(64, 16), (32, 33)])
def test_fft_convolution_matches_jax(n1, n2):
    rng = np.random.default_rng(6)
    a = _cplx(rng, (n1, n1))
    b = rng.standard_normal((n2, n2)).astype(np.float32)
    got = t_conv(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(j_conv(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (n1, n1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
