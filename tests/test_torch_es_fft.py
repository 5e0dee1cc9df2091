"""The ES-FFT gridder (GridderUvwEsFft) and its kernels against JAX.

Data: tests/test_es_fft.py's (150 rows x 2 channels, 64^2 image, seed
42), 2-D and 3-D (w-stacking). Tolerances:

- es_params selections and the packed plan's host arrays: equal (the
  same NumPy arithmetic);
- the kernels' plain versions against the interpret-mode Pallas kernels
  (``grid_packed_pallas`` on visited windows, ``degrid_fused_pallas``):
  1e-6 of max|JAX output| (identical products, another f32 summation
  order);
- the complex64 packed path against JAX's: 5e-6 of peak, the envelope of
  tests/test_es_fft.py:136-143 (f32 reordering scaled by the kernel
  width);
- the complex128 oracle against JAX's: 1e-12 of peak (f64 arithmetic);
- adjointness on the port: 1e-5 single, 1e-12 double
  (tests/test_es_fft.py:71-102).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import es_scenario  # noqa: E402
from ska_sdp_func_torch.grid_data import GridderUvwEsFft  # noqa: E402
from ska_sdp_func_torch.grid_data import es_params as tparams  # noqa: E402
from ska_sdp_func_torch.kernels import band_tap as tb  # noqa: E402
from ska_sdp_func_torch.parallel import from_jax_es_plan  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ska_sdp_func_tpu.grid_data import es_params as jparams  # noqa: E402
from ska_sdp_func_tpu.grid_data.es_fft import (  # noqa: E402
    GridderUvwEsFft as JGridder,
)
from ska_sdp_func_tpu.kernels import packed_tap as jpt  # noqa: E402

LAYOUTS = {"2d": False, "3d": True}


@pytest.fixture(scope="module")
def data():
    return es_scenario()


def _plans(d, do_wstacking, dtype, epsilon=1e-5):
    """(JAX plan, port plan on the CPU, zero dirty image)."""
    vis = d["vis"].astype(dtype)
    dirty = np.zeros((d["image_size"],) * 2, np.real(vis).dtype)
    w_range = JGridder.get_w_range(d["uvw"], d["freq"])
    args = (d["pixel_size"], d["pixel_size"], epsilon, *w_range,
            do_wstacking)
    jplan = JGridder(jnp.asarray(d["uvw"]), jnp.asarray(d["freq"]),
                     jnp.asarray(vis), jnp.asarray(d["weight"]),
                     jnp.asarray(dirty), *args)
    tplan = GridderUvwEsFft(d["uvw"], d["freq"], vis, d["weight"], dirty,
                            *args, device="cpu")
    return jplan, tplan, dirty


def _images(plan, d, dtype, dirty, model):
    """(dirty image, predicted visibilities) of one plan, as NumPy."""
    vis = d["vis"].astype(dtype)
    rdtype = np.real(vis).dtype
    uvw, freq = d["uvw"].astype(rdtype), d["freq"].astype(rdtype)
    weight = d["weight"].astype(rdtype)
    if isinstance(plan, JGridder):
        uvw, freq, vis, weight, dirty, model = (
            jnp.asarray(x) for x in (uvw, freq, vis, weight, dirty, model))
    img = plan.grid_uvw_es_fft(uvw, freq, vis, weight, dirty)
    pred = plan.ifft_degrid_uvw_es_fft(uvw, freq, vis * 0, weight, model)
    return np.asarray(img), np.asarray(pred)


def _model(d, dtype):
    rng = np.random.default_rng(3)
    return rng.standard_normal((d["image_size"],) * 2).astype(
        np.real(np.zeros(1, dtype)).dtype)


# -- parameters and plans ---------------------------------------------------

@pytest.mark.parametrize("sigma", [None, 1.25, 2.0], ids=["auto", "s1.25",
                                                          "s2.0"])
@pytest.mark.parametrize("single", [True, False], ids=["sp", "dp"])
@pytest.mark.parametrize("epsilon", [1e-3, 1e-4, 1e-5])
def test_es_params_match_jax(epsilon, single, sigma):
    """calculate_params_from_epsilon: the same kernel, or the same
    refusal (ValueError), as the JAX package."""
    def pick(mod):
        try:
            return mod.calculate_params_from_epsilon(epsilon, 512, single,
                                                     sigma=sigma)
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert pick(tparams) == pick(jparams)


@pytest.mark.parametrize("size", [1, 7, 100, 513, 769, 1000, 2049])
def test_padded_fft_size_matches_jax(size):
    from ska_sdp_func_torch.fourier_transforms import padded_fft_size
    from ska_sdp_func_tpu.fourier_transforms.fft import padded_fft_size as j

    for factor in (1.0, 1.25, 2.0):
        assert padded_fft_size(size, factor) == j(size, factor)


def test_es_params_single_precision_floor():
    with pytest.raises(ValueError, match="single-precision floor"):
        tparams.calculate_params_from_epsilon(1e-6, 64, True)
    assert tparams.tune_beta(6, 1.5) == jparams.tune_beta(6, 1.5)
    assert tparams.alias_error(8, 2.0, 17.0) == jparams.alias_error(
        8, 2.0, 17.0)
    assert tparams.corr_range(8, 2.0, 17.0) == jparams.corr_range(
        8, 2.0, 17.0)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_es_packed_plan_arrays_identical(data, layout):
    jplan, tplan, _ = _plans(data, LAYOUTS[layout], np.complex64)
    jp, tp = jplan._packed, tplan._packed
    for name in ("total", "num_blocks", "block_v", "num_w_grids",
                 "w_support", "num_slabs", "gu", "gv", "rows_pad",
                 "lanes_pad", "slab_blocks", "num_clipped"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert set(tp.arrays) == set(jp.arrays)
    for name, want in jp.arrays.items():
        got = tp.arrays[name]
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("grid_size", "support", "beta", "sigma",
                 "num_total_w_grids", "w_scale", "min_plane_w",
                 "conv_corr_norm_factor"):
        assert getattr(tplan, name) == getattr(jplan, name), name
    np.testing.assert_array_equal(tplan.conv_corr_kernel,
                                  jplan.conv_corr_kernel)


def test_es_plan_path_by_rule(data):
    """complex64 plans take the packed path; complex128 plans (support 8
    at 1e-5, more at 1e-12) run the oracle."""
    _, sp, _ = _plans(data, True, np.complex64)
    _, dp, _ = _plans(data, True, np.complex128)
    _, dp12, _ = _plans(data, True, np.complex128, epsilon=1e-12)
    assert sp._packed is not None and sp._packed.num_clipped == 0
    assert dp._packed is None and dp12._packed is None
    assert dp12.support > 8


def test_es_plan_checks(data):
    d = data
    with pytest.raises(SdpInvalidArgumentError):
        GridderUvwEsFft(d["uvw"], d["freq"], d["vis"], d["weight"],
                        np.zeros((64, 64)), 1e-4, 2e-4, 1e-5, 0.0, 1.0,
                        False, device="cpu")
    want = JGridder.get_w_range(d["uvw"], d["freq"])
    assert GridderUvwEsFft.get_w_range(torch.as_tensor(d["uvw"]),
                                       d["freq"]) == want
    assert GridderUvwEsFft.ifft_grid_uvw_es is \
        GridderUvwEsFft.ifft_degrid_uvw_es_fft


def test_es_plan_default_device_is_the_card(data):
    """Without ``device`` the plan is the CUDA card's: on a host with no
    card it raises at the first tensor it moves there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default works")
    d = data
    vis = d["vis"].astype(np.complex64)
    with pytest.raises((RuntimeError, AssertionError)):
        GridderUvwEsFft(d["uvw"], d["freq"], vis, d["weight"],
                        np.zeros((64, 64), np.float32), d["pixel_size"],
                        d["pixel_size"], 1e-5,
                        *GridderUvwEsFft.get_w_range(d["uvw"], d["freq"]),
                        True)


# -- the kernels' plain versions against Pallas ------------------------------

def _kernel_operands(ep):
    a = ep.arrays
    t = dict(u_off=torch.as_tensor(a["u_off"]),
             iv0=torch.as_tensor(a["iv0_local"]),
             uk=torch.as_tensor(a["uk"]), vk=torch.as_tensor(a["vk"]),
             kw_t=torch.as_tensor(np.ascontiguousarray(a["kw"].T)))
    return a, t


@pytest.mark.parametrize("form", ["split", "stack"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grid_packed_reference_matches_pallas(data, layout, form):
    """K8's plain version on the ES plan's first slab, both scale forms,
    against ``grid_packed_pallas`` on bands built from the same taps;
    visited windows (JAX leaves the others unwritten)."""
    _, tplan, _ = _plans(data, LAYOUTS[layout], np.complex64)
    ep = tplan._packed
    a, t = _kernel_operands(ep)
    b0, b1 = ep.slab_blocks[0]
    sl = slice(b0 * ep.block_v, b1 * ep.block_v)
    rng = np.random.default_rng(5)
    vre = np.where(a["valid"], rng.standard_normal(ep.total), 0.0
                   ).astype(np.float32)
    vim = np.where(a["valid"], rng.standard_normal(ep.total), 0.0
                   ).astype(np.float32)
    kw_t = np.ascontiguousarray(a["kw"].T)
    if form == "split":
        j_scales = (jnp.asarray(kw_t[:, sl]), jnp.asarray(vre[sl]),
                    jnp.asarray(vim[sl]))
        t_scales = (torch.as_tensor(np.ascontiguousarray(kw_t[:, sl])),
                    torch.as_tensor(vre[sl]), torch.as_tensor(vim[sl]))
    else:
        stack = np.concatenate([kw_t * vre, kw_t * vim])[:, sl]
        j_scales = jnp.asarray(stack)
        t_scales = torch.as_tensor(np.ascontiguousarray(stack))
    ubase, vband, _ = jpt.build_bands(
        jnp.asarray(a["u_off"][sl]), jnp.asarray(a["iv0_local"][sl]),
        jnp.asarray(a["uk"][sl]), jnp.asarray(a["vk"][sl]), 256)
    nbk = ep.gu * ep.gv
    ids = a["block_bucket"][b0:b1]
    want = np.asarray(jpt.grid_packed_pallas(
        jnp.asarray(ids), ubase, vband, j_scales, nbk, 256, ep.w_support,
        block_v=ep.block_v, interpret=True))
    args = (torch.as_tensor(ids), t["u_off"][sl], t["iv0"][sl], t["uk"][sl],
            t["vk"][sl], t_scales, nbk, 256, ep.w_support)
    got = tb.grid_packed_reference(*args, block_v=ep.block_v)
    assert got.shape == want.shape and got.dtype == torch.float32
    visited = a["visited"][0]
    got, want = got.numpy(), want[:, visited]
    assert np.abs(got[:, visited] - want).max() <= 1e-6 * np.abs(want).max()
    assert not got[:, ~visited].any()
    # The CPU wrapper runs the plain version and counts no launch.
    before = tb.grid_packed.launches
    assert np.array_equal(tb.grid_packed(*args, block_v=ep.block_v).numpy(),
                          got)
    assert tb.grid_packed.launches == before


@pytest.mark.parametrize("n_vq", [1, 2])
def test_degrid_fused_reference_matches_pallas(data, n_vq):
    """K11's plain version against ``degrid_fused_pallas`` on random
    padded planes at the 3-D ES plan's block coordinates: windows of
    n_vq 128-lane blocks (2 for ES, 1 for the w-towers shape)."""
    _, tplan, _ = _plans(data, True, np.complex64)
    ep = tplan._packed
    a, t = _kernel_operands(ep)
    lanes_win = 128 * n_vq
    rng = np.random.default_rng(9)
    planes = rng.standard_normal(
        (2, ep.num_w_grids, ep.rows_pad, ep.lanes_pad)).astype(np.float32)
    ubase, _, vband_t = jpt.build_bands(
        jnp.asarray(a["u_off"]), jnp.asarray(a["iv0_local"]),
        jnp.asarray(a["uk"]), jnp.asarray(a["vk"]), lanes_win)
    idx = [a[k] for k in ("k_idx", "g_idx", "hv_idx")]
    kw_t = np.ascontiguousarray(a["kw"].T)
    want = np.asarray(jpt.degrid_fused_pallas(
        jnp.asarray(planes), *(jnp.asarray(x) for x in idx), ubase, vband_t,
        jnp.asarray(kw_t), ep.w_support, block_v=ep.block_v,
        interpret=True, raw=True))
    args = (torch.as_tensor(planes), *(torch.as_tensor(x) for x in idx),
            t["u_off"], t["iv0"], t["uk"], t["vk"], t["kw_t"],
            ep.w_support, lanes_win)
    got = tb.degrid_fused_reference(*args, block_v=ep.block_v, raw=True)
    assert got.shape == want.shape == (8, ep.total)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert not got[2:].any()
    before = tb.degrid_fused.launches
    vis = tb.degrid_fused(*args, block_v=ep.block_v)
    assert vis.dtype == torch.complex64
    assert torch.equal(vis, torch.complex(got[0], got[1]))
    assert tb.degrid_fused.launches == before


def test_band_wrappers_reject_bad_operands(data):
    _, tplan, _ = _plans(data, True, np.complex64)
    ep = tplan._packed
    _, t = _kernel_operands(ep)
    n = ep.total
    ids = torch.zeros(ep.num_blocks, dtype=torch.int32)
    vre = torch.zeros(n)
    with pytest.raises(SdpInvalidArgumentError):
        tb.grid_packed(ids, t["u_off"], t["iv0"], t["uk"], t["vk"],
                       (t["kw_t"], vre, vre), 4, 256, ep.w_support,
                       block_v=100)
    with pytest.raises(SdpShapeError):
        tb.degrid_fused(torch.zeros((2, 1, 12, 128)), ids, ids, ids,
                        t["u_off"], t["iv0"], t["uk"], t["vk"], t["kw_t"],
                        ep.w_support, 128, block_v=ep.block_v)


# -- the whole gridder -------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_es_packed_path_matches_jax(data, layout):
    """complex64: the port's packed path (K8/K11 plain versions) against
    JAX's packed path (the interpret-mode Pallas kernels), and
    from_jax_es_plan against the port's own plan."""
    jplan, tplan, dirty = _plans(data, LAYOUTS[layout], np.complex64)
    model = _model(data, np.complex64)
    j_img, j_vis = _images(jplan, data, np.complex64, dirty, model)
    t_img, t_vis = _images(tplan, data, np.complex64, dirty, model)
    assert t_img.dtype == np.float32 and t_vis.dtype == np.complex64
    assert np.abs(t_img - j_img).max() <= 5e-6 * np.abs(j_img).max()
    assert np.abs(t_vis - j_vis).max() <= 5e-6 * np.abs(j_vis).max()
    c_img, c_vis = _images(from_jax_es_plan(jplan, device="cpu"), data,
                           np.complex64, dirty, model)
    np.testing.assert_array_equal(c_img, t_img)
    np.testing.assert_array_equal(c_vis, t_vis)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_es_oracle_matches_jax(data, layout):
    """complex128: the plain torch oracle against JAX's, f64."""
    jplan, tplan, dirty = _plans(data, LAYOUTS[layout], np.complex128)
    model = _model(data, np.complex128)
    j_img, j_vis = _images(jplan, data, np.complex128, dirty, model)
    t_img, t_vis = _images(tplan, data, np.complex128, dirty, model)
    assert t_img.dtype == np.float64 and t_vis.dtype == np.complex128
    assert np.abs(t_img - j_img).max() <= 1e-12 * np.abs(j_img).max()
    assert np.abs(t_vis - j_vis).max() <= 1e-12 * np.abs(j_vis).max()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_es_packed_path_matches_oracle(data, layout):
    """complex64: the packed path against the port's own oracle on the
    same plan (tests/test_es_fft.py:105-143), 5e-6 of peak."""
    _, tplan, dirty = _plans(data, LAYOUTS[layout], np.complex64)
    model = _model(data, np.complex64)
    p_img, p_vis = _images(tplan, data, np.complex64, dirty, model)
    packed, tplan._packed = tplan._packed, None
    o_img, o_vis = _images(tplan, data, np.complex64, dirty, model)
    tplan._packed = packed
    assert np.abs(p_img - o_img).max() <= 5e-6 * np.abs(o_img).max()
    assert np.abs(p_vis - o_vis).max() <= 5e-6 * np.abs(o_vis).max()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("single", [True, False], ids=["sp", "dp"])
def test_es_adjointness(data, single, layout):
    """vdot(grid(vis), image) == vdot(vis, degrid(image)) on the port
    (tests/test_es_fft.py:71-102's matrix)."""
    epsilon = 1e-5 if single else 1e-12
    dtype = np.complex64 if single else np.complex128
    _, tplan, dirty = _plans(data, LAYOUTS[layout], dtype, epsilon)
    rng = np.random.default_rng(40)
    image = rng.standard_normal(dirty.shape).astype(dirty.dtype)
    gridded, predicted = _images(tplan, data, dtype, dirty, image)
    vis = data["vis"].astype(dtype)
    adj1 = np.vdot(gridded, image)
    adj2 = np.vdot(vis * data["weight"], predicted).real
    assert abs(adj1 - adj2) / max(abs(adj1), abs(adj2)) < epsilon
