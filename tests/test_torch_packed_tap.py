"""Plain versions of the port's two CUDA kernels against the Pallas kernels.

The JAX side runs ``grid_packed_stack_pallas`` / ``degrid_stack_pallas``
in interpret mode (as the JAX package's own CPU tests do) on the same
operands. Tolerance 1e-5 of max|JAX output|: both sides form the same
products (bf16 halves upcast exactly to f32), so only the f32 summation
order differs.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    make_inputs  # noqa: E402
from ska_sdp_func_torch.kernels import packed_tap as tk  # noqa: E402
from ska_sdp_func_torch.parallel import packed_gridder, plan_packed, \
    plan_wstack  # noqa: E402
from ska_sdp_func_tpu.kernels import packed_tap as jk  # noqa: E402

MODES = ["highest", "high", "bf16"]


def _to_jax(x):
    """torch tensor (f32/bf16/int32) or (hi, lo) pair -> jax array(s)."""
    if isinstance(x, tuple):
        return tuple(_to_jax(p) for p in x)
    if x.dtype == torch.bfloat16:
        bits = jnp.asarray(x.view(torch.int16).numpy())
        return jax.lax.bitcast_convert_type(bits, jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _bits(x):
    """bf16 jax array / torch tensor -> int16 bit pattern (NumPy)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.int16))


@pytest.fixture(scope="module")
def gridders():
    uvw, vis = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    pplan = plan_packed(plan, uvw, block_v=128)
    fast = {"highest": False, "high": False, "bf16": True}
    gs = {m: packed_gridder(pplan, fast=fast[m], device="cpu",
                            precision=None if m == "bf16" else m)
          for m in MODES}
    rng = np.random.default_rng(11)
    total = pplan.total
    return dict(
        pplan=pplan, gs=gs, vis=vis,
        vre=torch.as_tensor(rng.standard_normal(total).astype(np.float32)),
        vim=torch.as_tensor(rng.standard_normal(total).astype(np.float32)),
        stack=torch.as_tensor(rng.standard_normal(
            (len(pplan.tasks), 2, pplan.num_layers * (128 + 8), 128)
        ).astype(np.float32)))


def test_split_bf16_bit_identical():
    rng = np.random.default_rng(0)
    # Exact ties in the dropped low half (0x8000), with the kept lowest
    # bit even and odd, exercise the round-to-nearest-even rule.
    ties = np.asarray([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,
                       0x47FE8000, 0xC7FF8000], np.uint32).view(np.float32)
    x = np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-20, 20, 4096),
        [0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38, 1e-30, -1e-30], ties]
    ).astype(np.float32)
    t_hi, t_lo = tk.split_bf16(torch.as_tensor(x))
    j_hi, j_lo = jk.split_bf16(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(t_hi), _bits(j_hi))
    np.testing.assert_array_equal(_bits(t_lo), _bits(j_lo))
    # (Denormals are left out: XLA's CPU backend flushes them to zero.)
    # The lo half must survive (the c8902b2 guard): hi + lo recovers x
    # to ~2^-16 relative, far better than bf16 alone.
    lo = t_lo.float().numpy()
    assert np.count_nonzero(lo) > len(x) // 2
    finite = np.abs(x) < 1e38
    rec = t_hi.float().numpy() + lo
    rel = np.abs(rec - x)[finite] / np.maximum(np.abs(x[finite]), 1e-30)
    assert rel.max() < 2.0 ** -15


def test_build_bands_exact():
    rng = np.random.default_rng(1)
    v, lanes, s = 1000, 128, 8
    u_off = rng.integers(0, 8, v).astype(np.int32)
    iv0 = rng.integers(0, lanes - s + 1, v).astype(np.int32)
    uk = rng.standard_normal((v, s)).astype(np.float32)
    vk = rng.standard_normal((v, s)).astype(np.float32)
    got = tk.build_bands(torch.as_tensor(u_off), torch.as_tensor(iv0),
                         torch.as_tensor(uk), torch.as_tensor(vk), lanes)
    want = jk.build_bands(jnp.asarray(u_off), jnp.asarray(iv0),
                          jnp.asarray(uk), jnp.asarray(vk), lanes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", MODES)
def test_gridder_band_operands_match_mode(gridders, mode):
    g = gridders["gs"][mode].slots
    if mode == "high":
        assert isinstance(g.vband, tuple)
        assert g.vband[0].dtype == g.vband[1].dtype == torch.bfloat16
    else:
        want = torch.bfloat16 if mode == "bf16" else torch.float32
        assert g.vband.dtype == g.vband_t.dtype == want


@pytest.mark.parametrize("mode", MODES)
def test_grid_reference_matches_pallas(gridders, mode):
    s = gridders
    g, pplan = s["gs"][mode].slots, s["pplan"]
    args = (len(pplan.tasks), pplan.num_layers, 128, 4)
    got = tk.grid_packed_stack_reference(
        g.t_idx, g.k_idx, g.g_idx, g.ubase, g.vband,
        (g.wk_t, s["vre"], s["vim"]), *args, block_v=pplan.block_v)
    want = np.asarray(jk.grid_packed_stack_pallas(
        *_to_jax((g.t_idx, g.k_idx, g.g_idx, g.ubase)), _to_jax(g.vband),
        _to_jax((g.wk_t, s["vre"], s["vim"])), *args,
        block_v=pplan.block_v, fast=mode == "bf16", interpret=True))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # The CPU wrapper dispatches to the plain version and counts no launch.
    before = tk.grid_packed_stack.launches
    again = tk.grid_packed_stack(
        g.t_idx, g.k_idx, g.g_idx, g.ubase, g.vband,
        (g.wk_t, s["vre"], s["vim"]), *args, block_v=pplan.block_v)
    assert torch.equal(again, got)
    assert tk.grid_packed_stack.launches == before


@pytest.mark.parametrize("mode", MODES)
def test_degrid_reference_matches_pallas(gridders, mode):
    s = gridders
    g, pplan = s["gs"][mode].slots, s["pplan"]
    got = tk.degrid_stack_reference(
        s["stack"], g.t_idx, g.k_idx, g.g_idx, g.ubase, g.vband_t, g.wk_t,
        4, block_v=pplan.block_v)
    want = np.asarray(jk.degrid_stack_pallas(
        *_to_jax((s["stack"], g.t_idx, g.k_idx, g.g_idx, g.ubase)),
        _to_jax(g.vband_t), _to_jax(g.wk_t), 4, block_v=pplan.block_v,
        fast=mode == "bf16", interpret=True))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    before = tk.degrid_stack.launches
    again = tk.degrid_stack(s["stack"], g.t_idx, g.k_idx, g.g_idx, g.ubase,
                            g.vband_t, g.wk_t, 4, block_v=pplan.block_v)
    assert torch.equal(again, got)
    assert tk.degrid_stack.launches == before


def test_wrappers_reject_bad_operands(gridders):
    from ska_sdp_func_torch.utility.errors import (
        SdpDataTypeError,
        SdpShapeError,
    )

    s = gridders
    g, pplan = s["gs"]["highest"].slots, s["pplan"]
    args = (len(pplan.tasks), pplan.num_layers, 128, 4)
    with pytest.raises(SdpDataTypeError):
        tk.grid_packed_stack(
            g.t_idx.long(), g.k_idx, g.g_idx, g.ubase, g.vband,
            (g.wk_t, s["vre"], s["vim"]), *args, block_v=pplan.block_v)
    with pytest.raises(SdpShapeError):
        tk.degrid_stack(s["stack"], g.t_idx, g.k_idx, g.g_idx, g.ubase,
                        g.vband, g.wk_t, 4, block_v=pplan.block_v)
