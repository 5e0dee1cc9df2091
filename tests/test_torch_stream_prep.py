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
    _clenshaw_rows,
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


# The kernel's whole range, ragged totals: (total, S, Sw, ncoef).
RANGE_CASES = [(1, 1, 1, 1), (31, 1, 8, 12), (33, 5, 4, 12),
               (4099, 8, 4, 12), (4099, 5, 1, 16), (300, 8, 8, 16)]


@pytest.mark.parametrize("total,s_,sw,ncoef", RANGE_CASES)
def test_stream_prep_over_the_kernel_range_matches_jax(total, s_, sw, ncoef):
    """The plain versions, which the kernel's two instances must equal bit
    for bit on the card, over the range the wrapper takes (S <= 8, Sw <=
    8, ncoef <= 16) against the JAX kernels' Clenshaw rows on seeded random
    fits, at 1e-6 of max (XLA may contract a multiply-add)."""
    rng = np.random.default_rng(total + 10 * s_ + sw + ncoef)
    ov, wov = 65536, 16384
    rows = [rng.integers(0, top + 1, total).astype(np.int32)
            for top in (ov, ov, wov)]
    vre, vim, valid = (rng.standard_normal(total).astype(np.float32)
                       for _ in range(3))
    valid = (valid > -1.0).astype(np.float32)
    c_uv = rng.standard_normal((ncoef, s_)).astype(np.float32)
    c_w = rng.standard_normal((ncoef, sw)).astype(np.float32)

    def j_taps(row, c, over):
        x = np.float32(2.0 / over) * jnp.asarray(row, jnp.float32) - 1.0
        return np.asarray(_clenshaw_rows(x, jnp.asarray(c)))   # [n, total]

    uk_j, vk_j = (j_taps(r, c_uv, ov).T for r in rows[:2])
    wk_j = j_taps(rows[2], c_w, wov)
    t = [torch.as_tensor(r) for r in rows]
    tc = (torch.as_tensor(c_uv), torch.as_tensor(c_w), ov, wov)
    uk, vk, scales = sp.stream_prep_grid(*t, torch.as_tensor(vre),
                                         torch.as_tensor(vim), *tc)
    _close(uk, uk_j)
    _close(vk, vk_j)
    _close(scales, np.concatenate([wk_j * vre, wk_j * vim]))
    uk_d, vk_d, wk_t = sp.stream_prep_degrid(*t, torch.as_tensor(valid),
                                             *tc, fast=True)
    assert torch.equal(uk_d, uk) and torch.equal(vk_d,
                                                 vk.to(torch.bfloat16))
    _close(wk_t, wk_j * valid)


@pytest.mark.parametrize("grid,fast,ncoef,s_,sw,want", [
    (True, False, 12, 8, 4, "stream_prep_kernel<true, false, 12, 8>"),
    (False, True, 12, 8, 8, "stream_prep_kernel<false, true, 12, 8>"),
    (True, True, 16, 8, 4, "stream_prep_kernel<true, true, 0, 0>"),
    (False, False, 12, 5, 4, "stream_prep_kernel<false, false, 0, 0>"),
    (True, False, 12, 8, 3, "stream_prep_kernel<true, false, 0, 0>"),
])
def test_stream_prep_instance(grid, fast, ncoef, s_, sw, want):
    """The instance a launch takes: unrolled at the streaming paths' fits
    (degree 11, support 8, a w support that is a power of two), generic
    elsewhere."""
    assert sp.instance(grid, fast, ncoef, s_, sw) == want
