"""Plain versions of the fused kernels (K3, K4) against the Pallas kernels.

The JAX side runs ``grid_fused_stack_pallas`` / ``degrid_fused2_stack_pallas``
in interpret mode (as the JAX package's own CPU tests do) on identical
NumPy-made plan words, visibilities and stacks. Tolerances: 1e-5 of
max|JAX output| in "highest" and "high" (the taps agree to f32 rounding
and only the f32 summation order differs); 2e-3 in "bf16", the fast
mode's kernel envelope (an f32 ulp between the two tap evaluations can
move a bf16 rounding).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import FUSED, fused_kernel_operands  # noqa: E402
from ska_sdp_func_torch.grid_data.wtower import _tap_coeffs_cached  # noqa
from ska_sdp_func_torch.kernels import fused_tap as tf  # noqa: E402
from ska_sdp_func_tpu.kernels import fused_tap as jf  # noqa: E402

LANES, S, SW = FUSED["lanes"], FUSED["support"], FUSED["w_support"]
OV, WOV = FUSED["oversampling"], FUSED["w_oversampling"]
TASKS, LAYERS, BV = FUSED["tasks"], FUSED["layers"], FUSED["block_v"]
MODES = {"highest": 1e-5, "high": 1e-5, "bf16": 2e-3}


@pytest.fixture(scope="module")
def ops():
    fields, np_ops = fused_kernel_operands()
    uv_c = _tap_coeffs_cached(S, OV)
    w_c = _tap_coeffs_cached(SW, WOV)
    return dict(np=np_ops, fields=fields, uv_c=uv_c, w_c=w_c,
                t={k: torch.as_tensor(v) for k, v in np_ops.items()},
                tuv=torch.as_tensor(uv_c, dtype=torch.float32),
                tw=torch.as_tensor(w_c, dtype=torch.float32))


def test_pack_plan_words_bit_identical(ops):
    f = ops["fields"]
    names = ("iv0", "u_off", "w_row", "u_frac", "v_frac", "valid")
    want = jf.pack_plan_words(*(f[k] for k in names))
    for x, y, z in zip(tf.pack_plan_words(*(f[k] for k in names)), want,
                       (ops["np"]["pa"], ops["np"]["pb"])):
        assert x.dtype == np.int32
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    t = tf.pack_plan_words(*(torch.as_tensor(f[k]) for k in (
        "iv0", "u_off", "w_row", "u_frac", "v_frac", "valid")))
    np.testing.assert_array_equal(t[0].numpy(), ops["np"]["pa"])
    np.testing.assert_array_equal(t[1].numpy(), ops["np"]["pb"])
    back = tf.unpack_plan_words(ops["t"]["pa"], ops["t"]["pb"])
    for name, got in zip(("iv0", "u_off", "w_row", "u_frac", "v_frac",
                          "valid"), back):
        np.testing.assert_array_equal(got.numpy(), f[name])


@pytest.mark.parametrize("args", [(128, 8, 16384, 16384),
                                  (2048, 8, 16384, 16384),
                                  (128, 8, 65536, 16384),
                                  (128, 8, 16384, 262144)])
def test_fused_geometry_ok(args):
    assert tf.fused_geometry_ok(*args) == jf.fused_geometry_ok(*args)


def test_taps_match_prep_common(ops):
    n = ops["np"]["pa"]
    ub, wk, vk, iv0, valid = jf._prep_common(
        jnp.asarray(n), jnp.asarray(ops["np"]["pb"]),
        jnp.asarray(ops["uv_c"], jnp.float32),
        jnp.asarray(ops["w_c"], jnp.float32), np.float32(2.0 / OV),
        np.float32(2.0 / WOV), S)
    f = ops["fields"]
    t = ops["t"]
    _, _, w_row, u_frac, v_frac, _ = tf.unpack_plan_words(t["pa"], t["pb"])
    uk_t = tf.cheb_taps(u_frac, ops["tuv"], OV).numpy()
    vk_t = tf.cheb_taps(v_frac, ops["tuv"], OV).numpy()
    wk_t = tf.cheb_taps(w_row, ops["tw"], WOV).numpy()
    np.testing.assert_allclose(vk_t, np.asarray(vk).T, rtol=0, atol=1e-6)
    np.testing.assert_allclose(wk_t, np.asarray(wk).T, rtol=0, atol=1e-6)
    ub = np.asarray(ub)
    cols = np.arange(len(n))
    for s in range(S):
        np.testing.assert_allclose(uk_t[:, s], ub[f["u_off"] + s, cols],
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(iv0), f["iv0"])
    np.testing.assert_array_equal(np.asarray(valid), f["valid"])


@pytest.mark.parametrize("mode", list(MODES))
def test_grid_reference_matches_pallas(ops, mode):
    o, t = ops["np"], ops["t"]
    dims = (TASKS, LAYERS, LANES, S, SW, OV, WOV)
    want = np.asarray(jf.grid_fused_stack_pallas(
        *(jnp.asarray(o[k]) for k in ("t", "k", "g", "pa", "pb", "vre",
                                      "vim")),
        ops["uv_c"], ops["w_c"], *dims, block_v=BV, precision=mode,
        nonempty=jnp.asarray(o["nonempty"]), interpret=True))
    args = (t["t"], t["k"], t["g"], t["pa"], t["pb"], t["vre"], t["vim"],
            ops["tuv"], ops["tw"], *dims)
    got = tf.grid_fused_stack_reference(*args, block_v=BV, precision=mode,
                                        nonempty=t["nonempty"])
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= MODES[mode] * np.abs(
        want).max()
    # The CPU wrapper runs the plain version and counts no launch.
    before = tf.grid_fused_stack.launches
    again = tf.grid_fused_stack(*args, block_v=BV, precision=mode,
                                nonempty=t["nonempty"])
    assert torch.equal(again, got)
    assert tf.grid_fused_stack.launches == before


@pytest.mark.parametrize("mode", list(MODES))
def test_degrid_reference_matches_pallas(ops, mode):
    o, t = ops["np"], ops["t"]
    dims = (S, SW, OV, WOV)
    want = np.asarray(jf.degrid_fused2_stack_pallas(
        *(jnp.asarray(o[k]) for k in ("stack", "t", "k", "g", "pa", "pb")),
        ops["uv_c"], ops["w_c"], LANES, *dims, block_v=BV, precision=mode,
        nonempty=jnp.asarray(o["nonempty"]), interpret=True))
    args = (t["stack"], t["t"], t["k"], t["g"], t["pa"], t["pb"],
            ops["tuv"], ops["tw"], *dims)
    got = tf.degrid_fused2_stack_reference(*args, block_v=BV,
                                           precision=mode,
                                           nonempty=t["nonempty"])
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= MODES[mode] * np.abs(
        want).max()
    # Empty blocks and invalid slots predict exactly zero.
    empty = np.repeat(o["nonempty"] == 0, BV)
    assert not got.numpy()[empty].any()
    assert not got.numpy()[~ops["fields"]["valid"].astype(bool)].any()
    before = tf.degrid_fused2_stack.launches
    again = tf.degrid_fused2_stack(*args, block_v=BV, precision=mode,
                                   nonempty=t["nonempty"])
    assert torch.equal(again, got)
    assert tf.degrid_fused2_stack.launches == before


def test_wrappers_reject_bad_operands(ops):
    from ska_sdp_func_torch.utility.errors import (
        SdpDataTypeError,
        SdpInvalidArgumentError,
    )

    t = ops["t"]
    dims = (TASKS, LAYERS, LANES, S, SW, OV, WOV)
    with pytest.raises(SdpDataTypeError):
        tf.grid_fused_stack(t["t"].long(), t["k"], t["g"], t["pa"], t["pb"],
                            t["vre"], t["vim"], ops["tuv"], ops["tw"],
                            *dims, block_v=BV)
    with pytest.raises(SdpInvalidArgumentError):
        tf.grid_fused_stack(t["t"], t["k"], t["g"], t["pa"], t["pb"],
                            t["vre"], t["vim"], ops["tuv"], ops["tw"],
                            *dims, block_v=BV, precision="half")
    with pytest.raises(SdpInvalidArgumentError):
        tf.degrid_fused2_stack(t["stack"], t["t"], t["k"], t["g"], t["pa"],
                               t["pb"], ops["tuv"], ops["tw"], S, SW, OV,
                               WOV, block_v=100)
