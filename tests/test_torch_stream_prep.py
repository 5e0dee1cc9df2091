"""The streaming engine's tap preparation (K6, K7) against the JAX package.

The plain versions of :mod:`ska_sdp_func_torch.kernels.stream_prep` hold
the Pallas kernels ``stream_prep_grid_pallas`` / ``stream_prep_degrid_pallas``
(interpret mode) on seeded placed fields of 2048 slots, at oversampling
16384 and 65536 and 128 and 256 lanes. The port returns compact taps; the
Pallas kernels dense bands. ``build_bands`` turns the port's taps into the
bands, which must equal JAX's ``ubase``/``vband``/``vband_t`` at 1e-6 of
their largest entry, as must the scale stack / masked w taps: both
evaluate Clenshaw's recurrence in f32 in the same order (XLA may contract
a multiply-add where torch rounds twice; the measured gap is at most
1.7e-7 of the largest entry).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.grid_data.wtower import _tap_coeffs_cached  # noqa: E402
from ska_sdp_func_torch.kernels import build_bands  # noqa: E402
from ska_sdp_func_torch.kernels import stream_prep as sp  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpDataTypeError,
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ska_sdp_func_tpu.kernels.packed_tap import (  # noqa: E402
    stream_prep_degrid_pallas,
    stream_prep_grid_pallas,
)

CAP, S, SW, BLOCK_V = 2048, 8, 4, 128
TOL = 1e-6


def _fields(oversampling, lanes, seed=3):
    """Placed fields of a chunk: about a tenth of the slots invalid
    (zero fields and visibilities, as the placement leaves them)."""
    rng = np.random.default_rng(seed)
    valid = rng.random(CAP) < 0.9
    f = dict(
        u_off=rng.integers(0, 8, CAP),
        iv0=rng.integers(0, lanes - S + 1, CAP),
        u_frac=rng.integers(0, oversampling + 1, CAP),
        v_frac=rng.integers(0, oversampling + 1, CAP),
        w_row=rng.integers(0, oversampling + 1, CAP))
    f = {k: np.where(valid, v, 0).astype(np.int32) for k, v in f.items()}
    f["vre"] = np.where(valid, rng.standard_normal(CAP), 0).astype(np.float32)
    f["vim"] = np.where(valid, rng.standard_normal(CAP), 0).astype(np.float32)
    f["valid_f"] = valid.astype(np.float32)
    return f


def _coeffs(oversampling):
    return (_tap_coeffs_cached(S, oversampling),
            _tap_coeffs_cached(SW, oversampling))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


CASES = [(ov, lanes) for ov in (16384, 65536) for lanes in (128, 256)]


@pytest.mark.parametrize("ov,lanes", CASES)
def test_stream_prep_grid_matches_jax(ov, lanes):
    f = _fields(ov, lanes)
    c_uv, c_w = _coeffs(ov)
    ubase, vband, scales = stream_prep_grid_pallas(
        *(jnp.asarray(f[k]) for k in ("u_off", "u_frac", "v_frac", "w_row",
                                      "vre", "vim", "iv0")),
        c_uv, c_w, ov, ov, S, SW, lanes, BLOCK_V, interpret=True)
    t = {k: torch.as_tensor(v) for k, v in f.items()}
    uk, vk, t_scales = sp.stream_prep_grid(
        t["u_frac"], t["v_frac"], t["w_row"], t["vre"], t["vim"],
        torch.as_tensor(c_uv, dtype=torch.float32),
        torch.as_tensor(c_w, dtype=torch.float32), ov, ov)
    assert uk.shape == vk.shape == (CAP, S) and t_scales.shape == (2 * SW,
                                                                   CAP)
    t_ubase, t_vband, _ = build_bands(t["u_off"], t["iv0"], uk, vk, lanes)
    _close(t_ubase, ubase)
    _close(t_vband, vband)
    _close(t_scales, scales)


@pytest.mark.parametrize("ov,lanes", CASES)
def test_stream_prep_degrid_matches_jax(ov, lanes):
    f = _fields(ov, lanes, seed=4)
    c_uv, c_w = _coeffs(ov)
    ubase, vband_t, wk_t = stream_prep_degrid_pallas(
        *(jnp.asarray(f[k]) for k in ("u_off", "u_frac", "v_frac", "w_row",
                                      "valid_f", "iv0")),
        c_uv, c_w, ov, ov, S, SW, lanes, BLOCK_V, interpret=True)
    t = {k: torch.as_tensor(v) for k, v in f.items()}
    uk, vk, t_wk = sp.stream_prep_degrid(
        t["u_frac"], t["v_frac"], t["w_row"], t["valid_f"],
        torch.as_tensor(c_uv, dtype=torch.float32),
        torch.as_tensor(c_w, dtype=torch.float32), ov, ov)
    t_ubase, _, t_vband_t = build_bands(t["u_off"], t["iv0"], uk, vk, lanes)
    _close(t_ubase, ubase)
    _close(t_vband_t, vband_t)
    _close(t_wk, wk_t)
    assert not bool(t_wk[:, ~t["valid_f"].bool()].abs().max() > 0)


def test_stream_prep_rejects_bad_inputs():
    f = {k: torch.as_tensor(v) for k, v in _fields(16384, 128).items()}
    c_uv, c_w = (torch.as_tensor(c, dtype=torch.float32)
                 for c in _coeffs(16384))
    args = (f["u_frac"], f["v_frac"], f["w_row"], f["vre"], f["vim"], c_uv,
            c_w, 16384, 16384)
    with pytest.raises(SdpDataTypeError):
        sp.stream_prep_grid(f["u_frac"].long(), *args[1:])
    with pytest.raises(SdpShapeError):
        sp.stream_prep_grid(*args[:3], f["vre"][:-1], *args[4:])
    with pytest.raises(SdpInvalidArgumentError):
        sp.stream_prep_grid(*args[:5], c_uv, c_w[:-1], 16384, 16384)
    with pytest.raises(SdpInvalidArgumentError):
        sp.stream_prep_degrid(*args[:3], f["valid_f"], c_uv[:, :0], c_w,
                              16384, 16384)


@pytest.mark.parametrize("direction", ["grid", "degrid"])
@pytest.mark.parametrize("ov,lanes", CASES)
def test_stream_prep_fast_matches_jax(ov, lanes, direction):
    """The bf16 mode (``fast``): ``vk`` comes back bf16, each tap of the
    f32 mode rounded once, ``uk`` and the scales / w taps as the f32 mode;
    through ``build_bands`` its v band equals the Pallas kernel's bf16 band
    bit for bit wherever the two f32 bands are equal."""
    f = _fields(ov, lanes, seed=5)
    c_uv, c_w = _coeffs(ov)
    t = {k: torch.as_tensor(v) for k, v in f.items()}
    tc = (torch.as_tensor(c_uv, dtype=torch.float32),
          torch.as_tensor(c_w, dtype=torch.float32), ov, ov)
    if direction == "grid":
        j_names = ("u_off", "u_frac", "v_frac", "w_row", "vre", "vim", "iv0")
        band = 1

        def port(fast):
            return sp.stream_prep_grid(t["u_frac"], t["v_frac"], t["w_row"],
                                       t["vre"], t["vim"], *tc, fast=fast)

        def jax(fast):
            return stream_prep_grid_pallas(
                *(jnp.asarray(f[k]) for k in j_names), c_uv, c_w, ov, ov, S,
                SW, lanes, BLOCK_V, fast=fast, interpret=True)
    else:
        j_names = ("u_off", "u_frac", "v_frac", "w_row", "valid_f", "iv0")
        band = 2

        def port(fast):
            return sp.stream_prep_degrid(t["u_frac"], t["v_frac"],
                                         t["w_row"], t["valid_f"], *tc,
                                         fast=fast)

        def jax(fast):
            return stream_prep_degrid_pallas(
                *(jnp.asarray(f[k]) for k in j_names), c_uv, c_w, ov, ov, S,
                SW, lanes, BLOCK_V, fast=fast, interpret=True)
    uk, vk, wk = port(False)
    uk_f, vk_f, wk_f = port(True)
    assert vk_f.dtype == torch.bfloat16 and vk_f.shape == (CAP, S)
    assert torch.equal(uk_f, uk) and torch.equal(wk_f, wk)
    assert torch.equal(vk_f, vk.to(torch.bfloat16))
    j_exact = np.asarray(jax(False)[1])
    j_fast = np.asarray(jax(True)[1]).astype(np.float32)
    p_exact = build_bands(t["u_off"], t["iv0"], uk, vk, lanes)[band].numpy()
    p_fast = build_bands(t["u_off"], t["iv0"], uk, vk_f.float(),
                         lanes)[band].numpy()
    same = p_exact == j_exact
    taps = j_exact != 0
    assert (same & taps).sum() >= 0.5 * taps.sum()
    np.testing.assert_array_equal(p_fast[same], j_fast[same])
