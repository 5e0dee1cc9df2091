"""The bf16 mode (``fast=True``) of the w-towers tap kernels' plain
versions (K14-K17, ska_sdp_func_torch.kernels.tower_tap) against JAX's
``fast=True`` Pallas kernels in interpret mode, against the port's own
f32 plain versions, and through the sub-grid gridder's environment
switch ``SKA_SDP_FUNC_TPU_FAST_MXU``.

On the CPU, JAX's ``fast`` (``Precision.DEFAULT``) computes in f32, so
both comparisons hold the bf16 rounding to JAX's stated envelope of
4e-3 of max|output| (wtower.py:685). The bf16 plain versions must
differ from the f32 ones: the rounding happens.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import C_0, WTOWER_PARAMS, wtower_scenario  # noqa
from ska_sdp_func_torch.grid_data import wtower as tw  # noqa: E402
from ska_sdp_func_torch.kernels import tower_tap as tt  # noqa: E402
from ska_sdp_func_tpu.grid_data.kernels import make_pswf_kernel  # noqa
from ska_sdp_func_tpu.kernels import pallas_tap as jp  # noqa: E402

SUPPORT, W_SUPPORT, OV = 8, 4, 64
FAST_TOL = 4e-3


def _err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _plane_ops(rng, rows, size):
    geom = (rng.random((rows, 3)) < 0.8,
            rng.integers(0, size - SUPPORT + 1, (rows, 3)).astype(np.int32),
            rng.integers(0, size - SUPPORT + 1, (rows, 3)).astype(np.int32),
            rng.integers(0, OV + 1, (rows, 3)),
            rng.integers(0, OV + 1, (rows, 3)),
            rng.integers(0, OV + 1, (rows, 3)))
    return (make_pswf_kernel(SUPPORT, SUPPORT, OV),
            make_pswf_kernel(W_SUPPORT, W_SUPPORT, OV), geom)


def _flat(rng, total, size, num_layers):
    iu0 = rng.integers(0, size - SUPPORT + 1, total).astype(np.int32)
    iv0 = rng.integers(0, size - SUPPORT + 1, total).astype(np.int32)
    uk = rng.standard_normal((total, SUPPORT)).astype(np.float32)
    vk = rng.standard_normal((total, SUPPORT)).astype(np.float32)
    j = rng.integers(0, num_layers - W_SUPPORT + 1, total)
    weights = np.zeros((total, num_layers), np.float32)
    for layer in range(W_SUPPORT):
        weights[np.arange(total), j + layer] = rng.uniform(0.1, 1, total)
    return iu0, iv0, uk, vk, weights


def _three(jax_fn, port_fn):
    """(JAX fast, port bf16, port f32) outputs as NumPy."""
    return (np.asarray(jax_fn()), port_fn(True).numpy(),
            port_fn(False).numpy())


def _check(want, fast, f32):
    assert _err(fast, want) <= FAST_TOL
    assert _err(fast, f32) <= FAST_TOL
    assert not np.array_equal(fast, f32)


def test_grid_plane_fast():
    rng = np.random.default_rng(14)
    size, rows = 32, 500
    uv_k, w_k, geom = _plane_ops(rng, rows, size)
    vis = _cplx(rng, (rows, 3))
    sub = np.zeros((W_SUPPORT, size, size), np.complex64)
    want, fast, f32 = _three(
        lambda: jp.grid_plane_pallas(
            jnp.asarray(sub), jnp.asarray(vis), jnp.asarray(uv_k),
            jnp.asarray(w_k), tuple(jnp.asarray(g) for g in geom), SUPPORT,
            W_SUPPORT, fast=True, interpret=True),
        lambda f: tt.grid_plane(
            torch.as_tensor(sub), torch.as_tensor(vis),
            torch.as_tensor(uv_k), torch.as_tensor(w_k),
            tuple(torch.as_tensor(g) for g in geom), SUPPORT, W_SUPPORT,
            fast=f))
    _check(want, fast, f32)


def test_degrid_plane_fast():
    rng = np.random.default_rng(15)
    size, rows = 32, 500
    uv_k, w_k, geom = _plane_ops(rng, rows, size)
    sub = _cplx(rng, (W_SUPPORT, size, size))
    want, fast, f32 = _three(
        lambda: jp.degrid_plane_pallas(
            jnp.asarray(sub), jnp.asarray(uv_k), jnp.asarray(w_k),
            tuple(jnp.asarray(g) for g in geom), SUPPORT, W_SUPPORT,
            fast=True, interpret=True),
        lambda f: tt.degrid_plane(
            torch.as_tensor(sub), torch.as_tensor(uv_k),
            torch.as_tensor(w_k), tuple(torch.as_tensor(g) for g in geom),
            SUPPORT, W_SUPPORT, fast=f))
    _check(want, fast, f32)
    assert not fast[~geom[0]].any()


@pytest.mark.parametrize("size, num_layers", [(32, 6), (64, 9)])
def test_grid_all_layers_fast(size, num_layers):
    rng = np.random.default_rng(16 + size)
    total = 2000
    flat = _flat(rng, total, size, num_layers)
    vre = rng.standard_normal(total).astype(np.float32)
    vim = rng.standard_normal(total).astype(np.float32)
    ops = (vre, vim) + flat
    want, fast, f32 = _three(
        lambda: jp.grid_all_layers_pallas(
            *(jnp.asarray(a) for a in ops), num_layers, size, SUPPORT,
            fast=True, interpret=True),
        lambda f: tt.grid_all_layers(
            *(torch.as_tensor(a) for a in ops), num_layers, size, SUPPORT,
            fast=f))
    _check(want, fast, f32)


@pytest.mark.parametrize("size, num_layers", [(32, 6), (64, 9)])
def test_degrid_all_layers_fast(size, num_layers):
    rng = np.random.default_rng(17 + size)
    flat = _flat(rng, 2000, size, num_layers)
    ops = (_cplx(rng, (num_layers, size, size)),) + flat
    want, fast, f32 = _three(
        lambda: jp.degrid_all_layers_pallas(
            *(jnp.asarray(a) for a in ops), SUPPORT, fast=True,
            interpret=True),
        lambda f: tt.degrid_all_layers(
            *(torch.as_tensor(a) for a in ops), SUPPORT, fast=f))
    _check(want, fast, f32)


def test_bf16_rounds_only_the_dot_operands():
    """One visibility, one tap: the grid term is bf16(uk * s) * bf16(vk)
    and the degrid term (bf16(uk) * bf16(cell)) * vk * w, with vk and w
    left in f32."""
    uk = torch.zeros((1, SUPPORT))
    vk = torch.zeros((1, SUPPORT))
    uk[0, 0], vk[0, 0] = 1.0 + 2 ** -12, 1.0 + 2 ** -11
    w = torch.tensor([[1.0 + 2 ** -13]])
    one = torch.zeros(1, dtype=torch.int32)
    s = torch.tensor([3.0])
    got = tt.grid_all_layers(s, s, one, one, uk, vk, w, 1, 16, SUPPORT,
                             fast=True)
    prod = (uk[0, 0] * (w[0, 0] * s[0])).to(torch.bfloat16).float()
    want = prod * vk[0, 0].to(torch.bfloat16).float()
    assert float(got[0, 0, 0].real) == float(want)
    layers = torch.zeros((1, 16, 16), dtype=torch.complex64)
    layers[0, 0, 0] = 1.0 + 2 ** -10
    got = tt.degrid_all_layers(layers, one, one, uk, vk, w, SUPPORT,
                               fast=True)
    cell = torch.tensor(1.0 + 2 ** -10).to(torch.bfloat16).float()
    term = uk[0, 0].to(torch.bfloat16).float() * cell * vk[0, 0]
    assert float(got[0].real) == float(w[0, 0] * term)


def bf16_bound(name, args):
    """Per output, the sum of |terms| of an all-layer call: the bf16 mode
    moves each term by at most 2^-7 (1 + 2^-9) of it (two operands
    rounded to 8 significant bits; ``u = 2^-8``)."""
    if name == "grid_all_layers":
        vre, vim, iu0, iv0, uk, vk, w = args[:7]
        return tt.grid_all_layers_reference(
            vre.abs(), vim.abs(), iu0, iv0, uk.abs(), vk.abs(), w.abs(),
            *args[7:])
    layers, iu0, iv0, uk, vk, w = args[:6]
    return tt.degrid_all_layers_reference(
        torch.complex(layers.real.abs(), layers.imag.abs()), iu0, iv0,
        uk.abs(), vk.abs(), w.abs(), *args[6:])


def within_bf16_bound(fast, f32, bound) -> bool:
    slack = 2 ** -7 * (1 + 2 ** -9)
    for part in (torch.real, torch.imag):
        err = (part(fast) - part(f32)).abs()
        if bool((err > slack * part(bound)
                 + 1e-6 * part(f32).abs().max()).any()):
            return False
    return True


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The sub-grid gridder's fused all-layer drivers on the CPU (their
    wrappers run the plain versions there), with each wrapper call's
    name, arguments and ``fast`` recorded."""
    seen = []
    monkeypatch.setattr(tw, "_use_kernels", lambda *a: True)
    for name in ("grid_all_layers", "degrid_all_layers"):
        fn = getattr(tt, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            seen.append((_name, args, kw.get("fast")))
            return _fn(*args, **kw)
        monkeypatch.setattr(tt, name, spy)
    return seen


def _subgrid_pair():
    uvw, ch, image = wtower_scenario()
    rows = uvw.shape[0]
    args = [torch.as_tensor(a) for a in (uvw, np.zeros(rows, np.int32),
                                         np.full(rows, ch, np.int32))]
    plan = tw.GridderWtowerUVW(**WTOWER_PARAMS)
    vis = plan.degrid_subgrid(
        torch.as_tensor(image, dtype=torch.complex64), (10, -6, 1), ch,
        C_0, C_0 / 100, *args, torch.zeros((rows, ch), dtype=torch.complex64),
        device="cpu")
    sub = plan.grid_subgrid(vis, *args, ch, C_0, C_0 / 100,
                            torch.zeros((64, 64), dtype=torch.complex64),
                            (10, -6, 1), device="cpu")
    return vis.numpy(), sub.numpy()


# The sub-grid gridder's outputs in bf16 against f32, of max|f32|: its
# tap sums cancel (a point source's phase turns by pi/2 per cell across
# the 8 x 8 support, and the w layers sum with the w-pattern ladder), so
# the per-term rounding of the kernels (<= 2^-7, held exactly above)
# reads as 2.1e-2 of the predicted visibilities and 3.8e-2 of the raw
# sub-grid image on this scenario, above the kernels' 4e-3 envelope.
CHAIN_TOL = 5e-2


def test_fast_mxu_switch_reaches_fused_drivers(fused_on_cpu, monkeypatch):
    """``SKA_SDP_FUNC_TPU_FAST_MXU`` set: the fused drivers pass
    ``fast=True`` to both all-layer wrappers; each call moves by no more
    than the bf16 rounding of its terms from its f32 twin, and the
    gridder's outputs differ from the f32 ones within CHAIN_TOL."""
    monkeypatch.delenv("SKA_SDP_FUNC_TPU_FAST_MXU", raising=False)
    f32 = _subgrid_pair()
    assert {(n, f) for n, _, f in fused_on_cpu} == {
        ("degrid_all_layers", False), ("grid_all_layers", False)}
    fused_on_cpu.clear()
    monkeypatch.setenv("SKA_SDP_FUNC_TPU_FAST_MXU", "1")
    fast = _subgrid_pair()
    assert {(n, f) for n, _, f in fused_on_cpu} == {
        ("degrid_all_layers", True), ("grid_all_layers", True)}
    for name, args, _ in fused_on_cpu:
        ref = getattr(tt, name + "_reference")
        assert within_bf16_bound(ref(*args, fast=True), ref(*args),
                                 bf16_bound(name, args))
    for a, b in zip(fast, f32):
        assert _err(a, b) <= CHAIN_TOL
        assert not np.array_equal(a, b)
