"""The direct gridder, the custom degridder and the w-tower height search
in the port, against the JAX package and the oracles of
tests/test_gridders_misc.py.

Tolerances: the PSWF taper bit for bit; f64 data against JAX at 1e-12
of the largest magnitude (the same operations, summed in another
order); the JAX tests' own bounds for the oracles (the w-towers degrid
within 5e-4 of the direct one's peak, the direct adjoint at rtol 1e-10,
the custom degrid's loop oracle at atol 1e-12, its conjugate at atol
1e-14); complex64 custom degrids against JAX at 1e-5 of max; results
that must not depend on a chunk size, bit for bit (the custom degrid:
elementwise operations only) or at 1e-12 (the direct transforms' matrix
products).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.fourier_transforms import fft as tfft  # noqa: E402
from ska_sdp_func_torch.grid_data import (  # noqa: E402
    GridderDirect,
    GridderWtowerUVW,
    degrid_uvw_custom,
    determine_max_w_tower_height,
    find_max_w_tower_height,
    worst_case_image,
)
from ska_sdp_func_torch.grid_data import custom as tcustom  # noqa: E402
from ska_sdp_func_torch.grid_data import gridder_utils as tgu  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ska_sdp_func_tpu import grid_data as jgd  # noqa: E402

C_0 = 299792458.0
CPU = dict(device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-12):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture(scope="module")
def oracle_case():
    """tests/test_gridders_misc.py:19-49's scenario."""
    rng = np.random.default_rng(1)
    size, theta, w_step = 64, 0.002, 100.0
    num_rows, num_chan = 100, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3)) * np.array([7000.0, 7000.0,
                                                        150.0])
    start = np.zeros(num_rows, np.int32)
    end = np.full(num_rows, num_chan, np.int32)
    image = np.zeros((size, size))
    image[size // 3, size // 4] = 1.0
    image[2 * size // 3, size // 2] = 0.7
    return dict(size=size, theta=theta, w_step=w_step, num_chan=num_chan,
                uvw=uvw, start=start, end=end, image=image)


def test_direct_pswf_bit_equal():
    for size, support in ((64, 8), (32, 8), (48, 6)):
        t = GridderDirect(size, size, 0.002, 100.0, 0.0, 0.0, support)
        j = jgd.GridderDirect(size, size, 0.002, 100.0, 0.0, 0.0, support)
        np.testing.assert_array_equal(t.pswf_sg, np.asarray(j.pswf_sg))
        assert t.pswf_sg[0] == 1e-15


def test_direct_gridder_is_oracle_for_wtower(oracle_case):
    """The w-towers degridder approximates the direct (DFT) one within
    5e-4 of its peak (the reference's accuracy-oracle relationship), and
    the port's direct degrid is JAX's at 1e-12."""
    s = oracle_case
    size, theta, w_step = s["size"], s["theta"], s["w_step"]
    args = (s["num_chan"], C_0, C_0 / 100, s["uvw"], s["start"], s["end"])
    direct = GridderDirect(size, size, theta, w_step, 0.0, 0.0, 8)
    wtower = GridderWtowerUVW(size, size, theta, w_step, 0.0, 0.0, 8,
                              16 * 1024, 4, 16 * 1024)
    img = s["image"].astype(complex)
    img_direct = direct.degrid_correct(img, **CPU)
    img_wtower = wtower.degrid_correct(img, **CPU)
    vis_direct = direct.degrid_subgrid(img_direct, (0, 0, 0), *args, **CPU)
    vis_wtower = wtower.degrid_subgrid(img_wtower, (0, 0, 0), *args, **CPU)
    got, expected = vis_wtower.numpy(), vis_direct.numpy()
    mask = np.abs(got) > 0
    assert mask.sum() > 0.8 * mask.size
    err = np.abs(got[mask] - expected[mask]).max()
    assert err < 5e-4 * np.abs(expected[mask]).max()

    jdirect = jgd.GridderDirect(size, size, theta, w_step, 0.0, 0.0, 8)
    j_img = jdirect.degrid_correct(jnp.asarray(img))
    _close(img_direct, j_img)
    _close(vis_direct, jdirect.degrid_subgrid(
        j_img, (0, 0, 0), s["num_chan"], C_0, C_0 / 100,
        jnp.asarray(s["uvw"]), jnp.asarray(s["start"]),
        jnp.asarray(s["end"])))


@pytest.mark.parametrize("offset", [(0, 0, 0), (3, -5, 2)])
def test_direct_gridder_grid_adjoint(offset):
    """<vis, A x> == <A^T vis, x> at rtol 1e-10, the taper on both sides;
    both directions against JAX at 1e-12, at a sub-grid offset too."""
    rng = np.random.default_rng(2)
    size, theta, w_step = 32, 0.002, 100.0
    num_rows, num_chan = 50, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3)) * np.array([3000.0, 3000.0,
                                                        100.0])
    start = np.zeros(num_rows, np.int32)
    end = np.full(num_rows, num_chan, np.int32)
    end[::7] = 0
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan)))
    image = rng.standard_normal((size, size))
    direct = GridderDirect(size, size, theta, w_step, 0.0, 0.0, 8)
    predicted = direct.degrid_subgrid(
        image.astype(complex), offset, num_chan, C_0, C_0 / 100, uvw,
        start, end, **CPU)
    gridded = direct.grid_subgrid(
        vis, uvw, start, end, num_chan, C_0, C_0 / 100,
        np.zeros((size, size), complex), offset, **CPU)
    lhs = np.vdot(vis, predicted.numpy())
    rhs = np.vdot(gridded.numpy(), image)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)

    jdirect = jgd.GridderDirect(size, size, theta, w_step, 0.0, 0.0, 8)
    _close(predicted, jdirect.degrid_subgrid(
        jnp.asarray(image, dtype=complex), offset, num_chan, C_0,
        C_0 / 100, jnp.asarray(uvw), jnp.asarray(start), jnp.asarray(end)))
    _close(gridded, jdirect.grid_subgrid(
        jnp.asarray(vis), jnp.asarray(uvw), jnp.asarray(start),
        jnp.asarray(end), num_chan, C_0, C_0 / 100,
        jnp.zeros((size, size), complex), offset))


@pytest.mark.parametrize("w_offset", [0, 3])
def test_direct_corrections_match_jax(w_offset):
    rng = np.random.default_rng(6)
    size = 32
    facet = rng.standard_normal((size, size))
    t = GridderDirect(128, size, 0.002, 100.0, 0.0, 0.0, 8)
    j = jgd.GridderDirect(128, size, 0.002, 100.0, 0.0, 0.0, 8)
    for data in (facet, facet + 1j * rng.standard_normal((size, size))):
        for name in ("degrid_correct", "grid_correct"):
            got = getattr(t, name)(data, 4, -6, w_offset, **CPU)
            want = getattr(j, name)(jnp.asarray(data), 4, -6, w_offset)
            assert got.dtype == (torch.complex128 if np.iscomplexobj(data)
                                 else torch.float64)
            _close(got, want)


@pytest.mark.parametrize("chunk", [None, 3 * 32 * 2, 1])
def test_direct_transforms_chunked(chunk, monkeypatch):
    """dft / idft over rows in chunks (a chunk of whole rows, of one row):
    at 1e-12 of the unchunked result (a matrix product over fewer rows
    may sum in another order), and JAX's at 1e-12."""
    rng = np.random.default_rng(8)
    rows, chans, size = 40, 3, 8
    uvw = rng.uniform(-1, 1, (rows, 3)) * np.array([2000.0, 2000.0, 80.0])
    start = np.zeros(rows, np.int32)
    end = np.full(rows, chans, np.int32)
    end[5] = 0
    flux = rng.standard_normal(5)
    lmn = rng.uniform(-0.01, 0.01, (5, 3))
    vis = rng.standard_normal((rows, chans)) \
        + 1j * rng.standard_normal((rows, chans))
    lmn_img = tgu.image_lmn((size, size), 0.002, **CPU)
    base = (tgu.dft(uvw, flux, lmn, start, end, 2, -1, 1, 0.002, 50.0,
                    C_0, C_0 / 100, chans, **CPU),
            tgu.idft(uvw, vis, lmn_img, start, end, None, 2, -1, 1, 0.002,
                     50.0, C_0, C_0 / 100, image_shape=(size, size), **CPU))
    if chunk is not None:
        monkeypatch.setattr(tgu, "_DFT_CHUNK", chunk)
    got_v = tgu.dft(uvw, flux, lmn, start, end, 2, -1, 1, 0.002, 50.0,
                    C_0, C_0 / 100, chans, **CPU)
    got_i = tgu.idft(uvw, vis, lmn_img, start, end, None, 2, -1, 1, 0.002,
                     50.0, C_0, C_0 / 100, image_shape=(size, size), **CPU)
    _close(got_v, base[0])
    _close(got_i, base[1])
    from ska_sdp_func_tpu.grid_data import gridder_utils as jgu
    _close(got_v, jgu.dft(jnp.asarray(uvw), jnp.asarray(flux),
                          jnp.asarray(lmn), jnp.asarray(start),
                          jnp.asarray(end), 2, -1, 1, 0.002, 50.0, C_0,
                          C_0 / 100, chans))
    _close(got_i, jgu.idft(jnp.asarray(uvw), jnp.asarray(vis),
                           jnp.asarray(lmn_img.numpy()), jnp.asarray(start),
                           jnp.asarray(end), None, 2, -1, 1, 0.002, 50.0,
                           C_0, C_0 / 100, image_shape=(size, size)))


def _custom_oracle(grid, uvw, uv_kernel, w_kernel, theta, wstep, f0, df):
    """The numpy loop of tests/test_gridders_misc.py:102-133."""
    num_chan, _, y_size, x_size, num_pols = grid.shape
    T, B = uvw.shape[:2]
    uv_os, uv_ks = uv_kernel.shape
    w_os, w_ks = w_kernel.shape
    expected = np.zeros((T, B, num_chan, num_pols), complex)
    half = uv_ks // 2
    for t in range(T):
        for b in range(B):
            for c in range(num_chan):
                inv_wave = (f0 + c * df) / C_0
                u, v, w = uvw[t, b] * inv_wave
                iox = int(round(theta * u * uv_os)) \
                    + (x_size // 2 + 1) * uv_os - 1
                home_x, frac_x = iox // uv_os, uv_os - 1 - iox % uv_os
                ioy = int(round(theta * v * uv_os)) \
                    + (y_size // 2 + 1) * uv_os - 1
                home_y, frac_y = ioy // uv_os, uv_os - 1 - ioy % uv_os
                ioz = int(round((1 + w / wstep) * w_os)) + w_os - 1
                frac_z = w_os - 1 - ioz % w_os
                if not (half < home_x < x_size - half
                        and half < home_y < y_size - half):
                    continue
                for p in range(num_pols):
                    acc = 0j
                    for z in range(w_ks):
                        for y in range(uv_ks):
                            for x in range(uv_ks):
                                acc += (w_kernel[frac_z, z]
                                        * uv_kernel[frac_y, y]
                                        * uv_kernel[frac_x, x]
                                        * grid[c, z, home_y + y - half,
                                               home_x + x - half, p])
                    expected[t, b, c, p] = acc
    return expected


def _custom_case(seed, num_pols=1, T=2, B=8):
    rng = np.random.default_rng(seed)
    shape = (2, 4, 32, 32, num_pols)
    grid = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    uv_kernel = rng.random((8, 4))
    w_kernel = rng.random((4, 4))
    uvw = rng.uniform(-1, 1, (T, B, 3)) * np.array([800.0, 800.0, 100.0])
    return grid, uvw, uv_kernel, w_kernel, 0.01, 200.0, C_0, C_0 / 100


def test_degrid_uvw_custom_single_point():
    """tests/test_gridders_misc.py:78-133: the loop oracle at atol 1e-12,
    and JAX's degrid at 1e-12."""
    case = _custom_case(3)
    got = degrid_uvw_custom(*case, **CPU).numpy()
    expected = _custom_oracle(*case)
    np.testing.assert_allclose(got, expected, atol=1e-12)
    assert np.abs(expected).max() > 0
    _close(got, jgd.degrid_uvw_custom(*(
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in case)))


def test_degrid_uvw_custom_conjugate():
    rng = np.random.default_rng(5)
    grid = (rng.standard_normal((1, 2, 16, 16, 1))
            + 1j * rng.standard_normal((1, 2, 16, 16, 1)))
    uvw = rng.uniform(-1, 1, (1, 4, 3)) * 200.0
    uv_k = rng.random((4, 4))
    w_k = rng.random((4, 2))
    a = degrid_uvw_custom(grid, uvw, uv_k, w_k, 0.01, 100.0, C_0, 0.0,
                          conjugate=False, **CPU)
    b = degrid_uvw_custom(grid, uvw, uv_k, w_k, 0.01, 100.0, C_0, 0.0,
                          conjugate=True, **CPU)
    np.testing.assert_allclose(b.numpy(), np.conj(a.numpy()), atol=1e-14)
    _close(b, jgd.degrid_uvw_custom(
        jnp.asarray(grid), jnp.asarray(uvw), jnp.asarray(uv_k),
        jnp.asarray(w_k), 0.01, 100.0, C_0, 0.0, conjugate=True))


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_degrid_uvw_custom_chunks_and_pols(dtype, monkeypatch):
    """Four pols and several times: JAX's degrid (f64 at 1e-12,
    complex64 at 1e-5 of max), the same bits whatever the chunk."""
    grid, uvw, uv_k, w_k, *rest = _custom_case(9, num_pols=4, T=5, B=6)
    grid = grid.astype(dtype)
    whole = degrid_uvw_custom(grid, uvw, uv_k, w_k, *rest, **CPU)
    assert whole.dtype == torch.from_numpy(grid).dtype
    monkeypatch.setattr(tcustom, "_POINTS_PER_CHUNK", 7)
    chunked = degrid_uvw_custom(grid, uvw, uv_k, w_k, *rest, **CPU)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    want = jgd.degrid_uvw_custom(jnp.asarray(grid), jnp.asarray(uvw),
                                 jnp.asarray(uv_k), jnp.asarray(w_k), *rest)
    _close(whole, want, 1e-12 if dtype == np.complex128 else 1e-5)


def test_degrid_uvw_custom_validation():
    grid, uvw, uv_k, w_k, *rest = _custom_case(4)
    with pytest.raises(SdpShapeError):
        degrid_uvw_custom(grid[0], uvw, uv_k, w_k, *rest, **CPU)
    with pytest.raises(SdpShapeError):
        degrid_uvw_custom(grid, uvw, uv_k.ravel(), w_k, *rest, **CPU)
    with pytest.raises(SdpShapeError):
        degrid_uvw_custom(grid, uvw.reshape(-1, 3), uv_k, w_k, *rest, **CPU)


def test_worst_case_image():
    image = worst_case_image(0.002, 0.001, 128)
    nz = np.transpose(np.nonzero(image))
    assert len(nz) == 4
    assert not np.allclose(image, image[::-1, ::-1])
    for args in ((0.002, 0.001, 128), (0.002, 0.001, 512),
                 (0.01, 0.004, 96)):
        np.testing.assert_array_equal(worst_case_image(*args),
                                      jgd.worst_case_image(*args))


@pytest.mark.filterwarnings("ignore")
def test_determine_max_w_tower_height_matches_jax():
    """tests/test_gridders_misc.py:160-168's search: an even height of at
    least 2, JAX's height, and the alias is the same function."""
    kw = dict(image_size=128, subgrid_size=32, theta=0.002, w_step=100.0,
              support=8, oversampling=16 * 1024, w_support=4,
              w_oversampling=16 * 1024, fov=0.001)
    height = determine_max_w_tower_height(**kw, **CPU)
    assert height >= 2 and height % 2 == 0
    assert height == jgd.determine_max_w_tower_height(**kw)
    assert find_max_w_tower_height is determine_max_w_tower_height
    with pytest.raises(SdpInvalidArgumentError):
        determine_max_w_tower_height(128, 32, 0.002, 100.0, **CPU)


def test_deprecated_grid_degrid_signatures_match_subgrid_forms():
    """The pre-1.2 grid/degrid signatures forward to the *_subgrid forms
    (tests/test_gridders_misc.py:171-203)."""
    rng = np.random.default_rng(4)
    size, theta, w_step = 64, 0.002, 100.0
    num_rows, num_chan = 50, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3)) * np.array([6000.0, 6000.0,
                                                        120.0])
    start = np.zeros(num_rows, np.int32)
    end = np.full(num_rows, num_chan, np.int32)
    freq0, dfreq = C_0, C_0 / 100
    kern = GridderWtowerUVW(size, size, theta, w_step, 0.0, 0.0, 8,
                            16 * 1024, 4, 16 * 1024)
    img = np.zeros((size, size))
    img[20, 24] = 1.0
    facet = kern.degrid_correct(img.astype(complex), **CPU)
    sub = tfft.ifft_shifted_norm(tfft.fft_shifted(facet))
    vis_t = torch.zeros((num_rows, num_chan), dtype=torch.complex128)
    old = kern.degrid(sub, 0, 0, 0, freq0, dfreq, uvw, start, end, vis_t,
                      **CPU)
    new = kern.degrid_subgrid(sub, (0, 0, 0), num_chan, freq0, dfreq, uvw,
                              start, end, vis_t, **CPU)
    np.testing.assert_array_equal(old.numpy(), new.numpy())
    sg0 = torch.zeros((size, size), dtype=torch.complex128)
    g_old = kern.grid(old, uvw, start, end, freq0, dfreq, sg0, 0, 0, 0,
                      **CPU)
    g_new = kern.grid_subgrid(old, uvw, start, end, num_chan, freq0, dfreq,
                              sg0, (0, 0, 0), **CPU)
    np.testing.assert_array_equal(g_old.numpy(), g_new.numpy())
