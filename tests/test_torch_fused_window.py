"""The word-fed bucket-window kernels K18 (``grid_fused``) and K19
(``degrid_fused2``) of ska_sdp_func_torch.kernels.band_tap against the
Pallas kernels ``grid_fused_pallas`` / ``degrid_fused2_pallas`` (interpret
mode), on the 120-row scenario of tests/test_fused_kernels.py (256² image,
128² sub-grids, block_v 128; its JAX packed plan and fused gridder give
the words, the sorted visibilities and the block tables).

Tolerances, of max|JAX output|: K18 windows over the visited buckets 1e-6
at "highest" (JAX's own bound between the fused and band kernels,
test_fused_kernels.py:151-154), 1e-5 at "high", 2e-3 at "bf16" (an f32 ulp
between the two tap evaluations can move a bf16 rounding); K19 1e-5 at
"highest" and "high", 2e-3 at "bf16", from a plane-major stack
``[2, T K, G + 8, G]`` of a two-point model (the task-major stack of the
JAX packed gridder, re-laid as the streaming engine lays it). A few
blocks are marked empty in ``nonempty``: both packages skip them.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.kernels import band_tap as bt  # noqa: E402
from ska_sdp_func_torch.kernels import fused_tap as tf  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ska_sdp_func_tpu.grid_data.wtower import _tap_coeffs_cached  # noqa
from ska_sdp_func_tpu.kernels.fused_tap import (  # noqa: E402
    degrid_fused2_pallas,
    grid_fused_pallas,
)
from ska_sdp_func_tpu.parallel.packed import packed_gridder, \
    plan_packed  # noqa: E402
from ska_sdp_func_tpu.parallel.wstack import plan_wstack  # noqa: E402

C_0 = 299792458.0
IMAGE, SUBGRID = 256, 128
THETA, W_STEP, HEIGHT = 0.002, 100.0, 4.0
GRID_TOL = {"highest": 1e-6, "high": 1e-5, "bf16": 2e-3}
DEGRID_TOL = {"highest": 1e-5, "high": 1e-5, "bf16": 2e-3}


@pytest.fixture(scope="module")
def setup():
    """test_fused_kernels.py's scenario (seed 7), with every fifth block
    marked empty, and the plane-major stack of a two-point model."""
    rng = np.random.default_rng(7)
    num_rows, num_chan = 120, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.45 * IMAGE / 2 / THETA
    uvw[:, 2] *= 1.5 * W_STEP * HEIGHT
    wplan = plan_wstack(
        uvw, C_0, C_0 / (100 * num_chan), num_chan, IMAGE, SUBGRID,
        THETA, W_STEP, support=8, oversampling=16384, w_support=4,
        w_oversampling=16384, w_tower_height=HEIGHT)
    pplan = plan_packed(wplan, uvw, block_v=128)
    g = packed_gridder(pplan, engine="fused")
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan))
           ).astype(np.complex64)
    vre, vim = g.sort(jnp.asarray(vis))
    nb = pplan.num_blocks
    nonempty = np.ones(nb, np.int32)
    nonempty[::5] = 0
    image = np.zeros((IMAGE, IMAGE), np.float32)
    image[IMAGE // 2 + 12, IMAGE // 2 - 9] = 1.0
    image[IMAGE // 2 - 20, IMAGE // 2 + 15] = 0.5
    st = np.asarray(jax.jit(lambda im: g._dstage_layers(
        g._dstage_planes(im), g.ladder_degrid, g.pref_degrid))(
            jnp.asarray(image)))
    num_tasks, num_layers = len(pplan.tasks), pplan.num_layers
    planes = np.ascontiguousarray(st.reshape(
        num_tasks, 2, num_layers, SUBGRID + 8, SUBGRID).transpose(
            1, 0, 2, 3, 4).reshape(2, num_tasks * num_layers, SUBGRID + 8,
                                   SUBGRID))
    t_idx, k_idx, g_idx = (np.asarray(x) for x in g._degrid_indices())
    n = dict(bucket_ids=np.asarray(g.block_bucket), pa=np.asarray(g.pa),
             pb=np.asarray(g.pb), vre=np.asarray(vre), vim=np.asarray(vim),
             nonempty=nonempty, planes=planes,
             p_idx=(t_idx * num_layers + k_idx).astype(np.int32),
             g_idx=g_idx.astype(np.int32),
             hv_idx=np.zeros(nb, np.int32))
    uv_c = _tap_coeffs_cached(wplan.support, wplan.oversampling)
    w_c = _tap_coeffs_cached(wplan.w_support, wplan.w_oversampling)
    dims = dict(support=wplan.support, w_support=wplan.w_support,
                oversampling=wplan.oversampling,
                w_oversampling=wplan.w_oversampling, block_v=pplan.block_v)
    return dict(np=n, t={k: torch.tensor(v) for k, v in n.items()},
                uv_c=uv_c, w_c=w_c,
                tuv=torch.as_tensor(uv_c, dtype=torch.float32),
                tw=torch.as_tensor(w_c, dtype=torch.float32), dims=dims,
                num_buckets=pplan.num_buckets,
                visited=np.asarray(pplan.arrays["visited"]))


def _grid_args(s, lib):
    """Positional arguments of K18 in the package ``lib`` ("jax" or
    "torch")."""
    a = s["np"] if lib == "jax" else s["t"]
    conv = jnp.asarray if lib == "jax" else (lambda x: x)
    coeffs = (s["uv_c"], s["w_c"]) if lib == "jax" else (s["tuv"], s["tw"])
    return (*(conv(a[k]) for k in ("bucket_ids", "pa", "pb", "vre", "vim")),
            *coeffs, s["num_buckets"], SUBGRID)


@pytest.mark.parametrize("precision", list(GRID_TOL))
def test_grid_fused_matches_jax(setup, precision):
    s = setup
    want = np.asarray(grid_fused_pallas(
        *_grid_args(s, "jax"), **s["dims"], precision=precision,
        nonempty=jnp.asarray(s["np"]["nonempty"]), interpret=True))
    got = bt.grid_fused(*_grid_args(s, "torch"), **s["dims"],
                        precision=precision, nonempty=s["t"]["nonempty"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    v = s["visited"]
    got, want = got.numpy()[:, v], want[:, v]
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= GRID_TOL[precision] * np.abs(
        want).max()
    # Buckets no block visits stay zero.
    assert not np.abs(bt.grid_fused(
        *_grid_args(s, "torch"), **s["dims"]).numpy()[:, ~v]).max() > 0


def test_grid_fused_matches_band_plain(setup):
    """K18's plain version against K8's fed ``cheb_taps`` taps of the
    same slots ("highest")."""
    s = setup
    t, d = s["t"], s["dims"]
    got = bt.grid_fused_reference(*_grid_args(s, "torch"), **d)
    iv0, u_off, w_row, u_frac, v_frac, _ = tf.unpack_plan_words(t["pa"],
                                                                t["pb"])
    uk = tf.cheb_taps(u_frac, s["tuv"], d["oversampling"])
    vk = tf.cheb_taps(v_frac, s["tuv"], d["oversampling"])
    wk_t = tf.cheb_taps(w_row, s["tw"], d["w_oversampling"]).T.contiguous()
    want = bt.grid_packed(t["bucket_ids"], u_off, iv0, uk, vk,
                          (wk_t, t["vre"], t["vim"]), s["num_buckets"],
                          SUBGRID, d["w_support"], block_v=d["block_v"])
    assert np.abs((got - want).numpy()).max() <= 1e-6 * float(
        want.abs().max())


def _degrid_args(s, lib):
    a = s["np"] if lib == "jax" else s["t"]
    conv = jnp.asarray if lib == "jax" else (lambda x: x)
    coeffs = (s["uv_c"], s["w_c"]) if lib == "jax" else (s["tuv"], s["tw"])
    return (*(conv(a[k]) for k in ("planes", "p_idx", "g_idx", "hv_idx",
                                   "pa", "pb")), *coeffs, SUBGRID)


@pytest.mark.parametrize("precision", list(DEGRID_TOL))
def test_degrid_fused2_matches_jax(setup, precision):
    s = setup
    want = np.asarray(degrid_fused2_pallas(
        *_degrid_args(s, "jax"), **s["dims"], precision=precision,
        nonempty=jnp.asarray(s["np"]["nonempty"]), interpret=True,
        raw=True))
    got = bt.degrid_fused2(*_degrid_args(s, "torch"), **s["dims"],
                           precision=precision,
                           nonempty=s["t"]["nonempty"], raw=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    assert np.abs(want[:2]).max() > 0 and not np.abs(got[2:]).max() > 0
    assert np.abs(got - want).max() <= DEGRID_TOL[precision] * np.abs(
        want).max()
    # Empty blocks predict zero; complex64 without ``raw``.
    empty = np.repeat(s["np"]["nonempty"] == 0, s["dims"]["block_v"])
    assert not np.abs(got[:, empty]).max() > 0
    c = bt.degrid_fused2(*_degrid_args(s, "torch"), **s["dims"],
                         precision=precision, nonempty=s["t"]["nonempty"])
    assert c.dtype == torch.complex64
    np.testing.assert_array_equal(c.real.numpy(), got[0])


def test_fused_window_rejects_bad_inputs(setup):
    s = setup
    args, d = _grid_args(s, "torch"), s["dims"]
    with pytest.raises(SdpInvalidArgumentError, match="precision"):
        bt.grid_fused(*args, **d, precision="fast")
    with pytest.raises(SdpInvalidArgumentError):
        bt.grid_fused(*args, **{**d, "w_support": 8})
    with pytest.raises(SdpShapeError):
        bt.grid_fused(args[0][:-1], *args[1:], **d)
    dargs = _degrid_args(s, "torch")
    with pytest.raises(SdpShapeError):
        bt.degrid_fused2(dargs[0][:, :, :-1], *dargs[1:], **d)
