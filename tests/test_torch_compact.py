"""The compact engine (K12/K13) against the JAX package.

Kernel twins: ``grid_compact_reference`` / ``degrid_compact_reference``
against ``grid_compact_pallas`` / ``degrid_compact_pallas`` in interpret
mode on identical NumPy-made words, taps, visibilities and stacks, at
1e-6 of max|JAX output| (identical products, another f32 summation
order; "bf16" rounds the same two f32 factors on both sides). The JAX
degrid kernel's fast mode is the TPU's single-pass bf16 product, which
XLA's CPU backend computes in f32, so its twin is held to the band
engine's fast mode instead (below).

Whole engine: ``PackedGridder(engine="compact")`` against the JAX
package's compact engine and against the port's band engine on the
scenario of tests/test_fused_kernels.py:212-247 (400 rows x 3 channels,
256^2), at 2e-6 of scale in "highest"; the fast (bf16) mode against the
band engine's fast mode at 1e-5 (both round the same factors to bf16 and
sum in another f32 order). Images compare taper-weighted: the JAX test's
raw interior at margin 16 holds there because XLA computes both engines
with bit-identical sums, while the port's sparse scatter (K12) and dense
band product (K1) sum in different orders, and next to the border the
1/PSWF correction lifts that f32 noise to ~2e-3 of peak at margin 16
(4e-5 at 32, 6e-7 at 64; the port's band engine against JAX's shows
the same).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import FUSED, fused_kernel_operands, taper  # noqa
from ska_sdp_func_torch.grid_data.wtower import _tap_coeffs_cached  # noqa
from ska_sdp_func_torch.kernels import fused_tap as tf  # noqa: E402
from ska_sdp_func_torch.parallel import packed as tpacked  # noqa: E402
from ska_sdp_func_torch.parallel import from_jax_plan  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpDataTypeError,
    SdpInvalidArgumentError,
)
from ska_sdp_func_tpu.kernels import fused_tap as jf  # noqa: E402
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack  # noqa
from ska_sdp_func_tpu.parallel.packed import (  # noqa: E402
    packed_gridder as j_gridder,
    plan_packed as j_plan_packed,
)

C_0 = 299792458.0
LANES, S, SW = FUSED["lanes"], FUSED["support"], FUSED["w_support"]
OV, WOV = FUSED["oversampling"], FUSED["w_oversampling"]
TASKS, LAYERS, BV = FUSED["tasks"], FUSED["layers"], FUSED["block_v"]


@pytest.fixture(scope="module")
def ops():
    """The fused kernels' operands with their taps pre-evaluated (the
    compact streams: uk_t/vk_t [S, V], wk_t [Sw, V] zero on invalid
    slots)."""
    fields, o = fused_kernel_operands()
    uv_c = torch.as_tensor(_tap_coeffs_cached(S, OV), dtype=torch.float32)
    w_c = torch.as_tensor(_tap_coeffs_cached(SW, WOV), dtype=torch.float32)
    valid = torch.as_tensor(fields["valid"].astype(bool))
    taps = dict(
        uk_t=tf.cheb_taps(torch.as_tensor(fields["u_frac"]), uv_c, OV).T,
        vk_t=tf.cheb_taps(torch.as_tensor(fields["v_frac"]), uv_c, OV).T,
        wk_t=torch.where(valid[:, None], tf.cheb_taps(
            torch.as_tensor(fields["w_row"]), w_c, WOV), 0.0).T)
    o.update({k: np.ascontiguousarray(v.numpy()) for k, v in taps.items()})
    return dict(np=o, t={k: torch.as_tensor(v) for k, v in o.items()})


def _stream(src, names):
    return tuple(src[k] for k in names)


GRID_NAMES = ("t", "k", "g", "pa", "uk_t", "vk_t", "wk_t", "vre", "vim")
DEGRID_NAMES = ("stack", "t", "k", "g", "pa", "uk_t", "vk_t", "wk_t")


@pytest.mark.parametrize("mode", ["highest", "bf16"])
def test_grid_compact_reference_matches_pallas(ops, mode):
    o, t = ops["np"], ops["t"]
    dims = (TASKS, LAYERS, LANES, S, SW)
    want = np.asarray(jf.grid_compact_pallas(
        *(jnp.asarray(x) for x in _stream(o, GRID_NAMES)), *dims,
        block_v=BV, precision=mode, interpret=True))
    args = _stream(t, GRID_NAMES) + dims
    got = tf.grid_compact_reference(*args, block_v=BV, precision=mode)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # The CPU wrapper runs the plain version and counts no launch.
    before = tf.grid_compact.launches
    assert torch.equal(tf.grid_compact(*args, block_v=BV, precision=mode),
                       got)
    assert tf.grid_compact.launches == before


def test_degrid_compact_reference_matches_pallas(ops):
    o, t = ops["np"], ops["t"]
    want = np.asarray(jf.degrid_compact_pallas(
        *(jnp.asarray(x) for x in _stream(o, DEGRID_NAMES)), S, SW,
        block_v=BV, interpret=True))
    args = _stream(t, DEGRID_NAMES) + (S, SW)
    got = tf.degrid_compact_reference(*args, block_v=BV)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # Invalid slots carry wk = 0 and predict exactly zero.
    assert not got.numpy()[~o["wk_t"].any(axis=0)].any()
    before = tf.degrid_compact.launches
    assert torch.equal(tf.degrid_compact(*args, block_v=BV), got)
    assert tf.degrid_compact.launches == before


def test_compact_wrappers_reject_bad_operands(ops):
    t = ops["t"]
    dims = (TASKS, LAYERS, LANES, S, SW)
    with pytest.raises(SdpDataTypeError):
        tf.grid_compact(*_stream(t, GRID_NAMES[:4]), t["uk_t"].double(),
                        *_stream(t, GRID_NAMES[5:]), *dims, block_v=BV)
    with pytest.raises(SdpInvalidArgumentError):
        tf.grid_compact(*_stream(t, GRID_NAMES), *dims, block_v=BV,
                        precision="half")
    with pytest.raises(SdpInvalidArgumentError):
        tf.degrid_compact(*_stream(t, DEGRID_NAMES), S, SW, block_v=100)


# -- the engine -----------------------------------------------------------

def _fused_kernels_scenario(oversampling=16384):
    """tests/test_fused_kernels.py:212-247's data and plans."""
    rng = np.random.default_rng(11)
    rows, chans, image, subgrid = 400, 3, 256, 128
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.4 * image / 2 / 0.002
    uvw[:, 2] *= 1.2 * 100.0 * 4.0
    vis = (rng.standard_normal((rows, chans))
           + 1j * rng.standard_normal((rows, chans))).astype(np.complex64)
    plan = j_plan_wstack(uvw, C_0, C_0 / 300, chans, image, subgrid,
                         0.002, 100.0, support=8, w_support=4,
                         oversampling=oversampling, w_tower_height=4.0)
    jpp = j_plan_packed(plan, uvw, block_v=128)
    model = np.zeros((image, image), np.float32)
    model[150, 100] = 1.0
    return dict(vis=vis, jpp=jpp, tpp=from_jax_plan(jpp), model=model,
                taper=taper(plan))


@pytest.fixture(scope="module")
def scenario():
    return _fused_kernels_scenario()


def _outputs(g, s, direction):
    """The taper-weighted dirty image, or the sorted-stream degrid."""
    if direction == "grid":
        return np.asarray(g.grid(s["vis"])) * s["taper"]
    return np.asarray(g.degrid_sorted(s["model"]))


@pytest.mark.parametrize("direction", ["grid", "degrid"])
def test_compact_engine_matches_jax_and_bands(scenario, direction):
    s = scenario
    jc = j_gridder(s["jpp"], engine="compact", precision="highest")
    tc = tpacked.PackedGridder(s["tpp"], engine="compact",
                               precision="highest", device="cpu")
    tb = tpacked.PackedGridder(s["tpp"], engine="bands",
                               precision="highest", device="cpu")
    assert jc._compact and tc.engine == "compact" and tc.slots.vband is None
    want = np.asarray(_outputs(jc, dict(s, model=jnp.asarray(s["model"]),
                                        vis=jnp.asarray(s["vis"])),
                               direction))
    got = _outputs(tc, s, direction)
    band = _outputs(tb, s, direction)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-6 * scale
    assert np.abs(got - band).max() <= 2e-6 * scale


@pytest.mark.parametrize("direction", ["grid", "degrid"])
def test_compact_fast_mode_matches_band_fast_mode(scenario, direction):
    s = scenario
    tc = tpacked.PackedGridder(s["tpp"], engine="compact", fast=True,
                               device="cpu")
    tb = tpacked.PackedGridder(s["tpp"], engine="bands", fast=True,
                               device="cpu")
    assert tc.precision == "bf16"
    got, want = _outputs(tc, s, direction), _outputs(tb, s, direction)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_compact_engine_needs_packable_plan():
    """A plan whose fields overflow the plan words takes the band engine
    at the requested precision, as in the JAX package."""
    s = _fused_kernels_scenario(oversampling=65536)
    assert not tf.fused_geometry_ok(128, 8, 65536, 16384)
    jg = j_gridder(s["jpp"], engine="compact")
    tg = tpacked.PackedGridder(s["tpp"], engine="compact", device="cpu")
    assert not jg._compact and tg.engine == "bands"
    assert tg.precision == jg.precision == "high"


def test_gridder_cache_keys_on_engine(scenario):
    p = scenario["tpp"]
    band = tpacked.packed_gridder(p, device="cpu")
    compact = tpacked.packed_gridder(p, engine="compact", device="cpu")
    assert compact is not band and compact.engine == "compact"
    assert tpacked.packed_gridder(p, engine="compact",
                                  device="cpu") is compact
