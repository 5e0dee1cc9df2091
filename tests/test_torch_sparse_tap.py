"""The sparse all-layer grid kernel's plain version (K20,
ska_sdp_func_torch.kernels.sparse_tap) against JAX
(ska_sdp_func_tpu.kernels.sparse_tap in interpret mode), against the
dense all-layer kernel's plain version (K16) on the densified taps, and
on the bucketed fallback's own sparse taps.

The JAX kernel unrolls its block statically (sparse_tap.py:51-54), so
its interpret runs stay at ``block_v=8`` and V <= 64. Rows stay inside
the sub-grid (``iu0 <= size - S``): the JAX kernel runs rows past its
padded plane into the next layer, which the port does not copy.

Tolerances: against JAX 1e-6 of max|output| (the same f32 products,
``uk * s * vk`` in another order and other sums); against K16's plain
version on the same taps bit-equal (the same weights reach the same
products).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import task_taps  # noqa: E402
from ska_sdp_func_torch.grid_data.wtower import _slab_weights  # noqa: E402
from ska_sdp_func_torch.kernels import sparse_tap as ts  # noqa: E402
from ska_sdp_func_torch.kernels import tower_tap as tt  # noqa: E402
from ska_sdp_func_torch.parallel import bucketed as tbk  # noqa: E402
from ska_sdp_func_torch.parallel import plan_bucketed, plan_wstack  # noqa
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ska_sdp_func_tpu.kernels import sparse_tap as js  # noqa: E402

SUPPORT, W_SUPPORT = 8, 4


def _sparse(rng, total, size, num_layers, spread=0, w_support=W_SUPPORT,
            edges="cols"):
    """Sparse taps: cells inside the sub-grid by rows, columns a few
    past either edge (``edges="both"``: rows too); first layers in range
    (``spread`` > 0: also up to ``spread`` outside it, which the clip
    brings back); a tenth of the visibilities masked (zero w taps, any
    first layer)."""
    lo, hi = (-SUPPORT + 1, size) if edges == "both" else \
        (0, size - SUPPORT + 1)
    iu0 = rng.integers(lo, hi, total).astype(np.int32)
    iv0 = rng.integers(-3, size - 2, total).astype(np.int32)
    uk = rng.standard_normal((total, SUPPORT)).astype(np.float32)
    vk = rng.standard_normal((total, SUPPORT)).astype(np.float32)
    k0 = rng.integers(-spread, num_layers - w_support + 1 + spread,
                      total).astype(np.int32)
    wk = rng.uniform(0.1, 1, (total, w_support)).astype(np.float32)
    masked = rng.random(total) < 0.1
    wk[masked] = 0.0
    k0[masked] = rng.integers(-50, 50, int(masked.sum()))
    vre = rng.standard_normal(total).astype(np.float32)
    vim = rng.standard_normal(total).astype(np.float32)
    return vre, vim, iu0, iv0, k0, uk, vk, wk


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# (size, layers, slots, w_support, case): "zero block", one 8-slot block
# whose every w tap is 0 (its first layers garbage); "off edge", columns
# off both edges of the sub-grid (and, at N = 32, every slot's first
# column at -7 or N - 1, one tap inside); Sw = K; N = 128 and 256.
SPARSE_CASES = [(32, 6, 64, 4, ""), (64, 9, 56, 4, ""),
                (32, 4, 48, 4, "Sw = K"), (32, 6, 40, 4, "zero block"),
                (32, 5, 40, 4, "off edge"), (128, 5, 40, 4, ""),
                (256, 4, 24, 4, "")]


@pytest.mark.parametrize("size, num_layers, total, w_support, case",
                         SPARSE_CASES, ids=[f"N{c[0]}-K{c[1]}-{c[4]}"
                                            for c in SPARSE_CASES])
def test_sparse_plain_matches_pallas(size, num_layers, total, w_support,
                                     case):
    rng = np.random.default_rng(size + num_layers)
    ops = _sparse(rng, total, size, num_layers, w_support=w_support)
    if case == "zero block":
        ops[7][8:16] = 0.0
        ops[4][8:16] = rng.integers(-9, 9 + num_layers, 8)
    if case == "off edge":
        ops[3][:] = np.where(rng.random(total) < 0.5, -SUPPORT + 1,
                             size - 1)
    want = js.grid_all_layers_sparse(
        *(jnp.asarray(a) for a in ops), num_layers, size, SUPPORT,
        w_support, block_v=8, interpret=True)
    got = ts.grid_all_layers_sparse(
        *(torch.as_tensor(a) for a in ops), num_layers, size, SUPPORT,
        w_support, block_v=8)
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == (num_layers, size, size)
    _close(got.numpy(), want, 1e-6)
    if case == "zero block":
        # The zero block alone adds nothing: the other slots give the same.
        keep = np.r_[0:8, 16:total]
        rest = ts.grid_all_layers_sparse(
            *(torch.as_tensor(np.ascontiguousarray(a[keep])) for a in ops),
            num_layers, size, SUPPORT, w_support, block_v=8)
        _close(got.numpy(), rest.numpy(), 1e-6)


def test_sparse_plain_clips_first_layer_like_pallas():
    """First layers past either end are clipped to [0, K - Sw]."""
    rng = np.random.default_rng(7)
    size, num_layers = 32, 6
    ops = list(_sparse(rng, 40, size, num_layers, spread=3))
    k0 = ops[4]
    assert (k0 < 0).any() and (k0 > num_layers - W_SUPPORT).any()
    want = js.grid_all_layers_sparse(
        *(jnp.asarray(a) for a in ops), num_layers, size, SUPPORT,
        W_SUPPORT, block_v=8, interpret=True)
    got = ts.grid_all_layers_sparse(
        *(torch.as_tensor(a) for a in ops), num_layers, size, SUPPORT,
        W_SUPPORT, block_v=8)
    _close(got.numpy(), want, 1e-6)
    # The clip, written out: the same as the in-range first layers.
    ops[4] = np.clip(k0, 0, num_layers - W_SUPPORT)
    clipped = ts.grid_all_layers_sparse(
        *(torch.as_tensor(a) for a in ops), num_layers, size, SUPPORT,
        W_SUPPORT)
    assert torch.equal(got, clipped)


@pytest.mark.parametrize("edges", ["cols", "both"])
@pytest.mark.parametrize("fast", [False, True])
def test_sparse_plain_matches_dense_plain(fast, edges):
    """K20's plain version equals K16's on ``_slab_weights`` of the same
    taps, in both modes; with ``edges="both"`` rows fall off the top and
    bottom of the sub-grid too (the Pallas kernel runs those rows into
    the neighbouring layer, so this holds against K16 only)."""
    rng = np.random.default_rng(11)
    size, num_layers = 32, 7
    vre, vim, iu0, iv0, k0, uk, vk, wk = (
        torch.as_tensor(a) for a in _sparse(rng, 3000, size, num_layers,
                                            edges=edges))
    keep = (wk != 0).any(dim=1)
    weights = _slab_weights(wk, k0, keep, num_layers)
    got = ts.grid_all_layers_sparse(vre, vim, iu0, iv0, k0, uk, vk, wk,
                                    num_layers, size, SUPPORT, W_SUPPORT,
                                    fast=fast)
    want = tt.grid_all_layers(vre, vim, iu0, iv0, uk, vk, weights,
                              num_layers, size, SUPPORT, fast=fast)
    assert torch.equal(got, want)


def test_sparse_on_fallback_taps_matches_dense():
    """The bucketed fallback's sparse taps (``_stream_sparse_taps``, the
    form before ``_slab_weights`` densifies it) through K20's plain
    version equal its dense taps through K16's, task by task."""
    rng = np.random.default_rng(5)
    rows, image = 60, 64
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.3 * image / 2 / 0.002
    uvw[:, 2] *= 200.0
    plan = plan_wstack(uvw, 3e8, 3e6, 2, image, 32, 0.002, 50.0)
    bplan, sort_index, valid = plan_bucketed(plan, uvw, block_v=64)
    uvw_s, chan, _, vld = tbk._sorted_inputs(bplan, torch.as_tensor(uvw),
                                             sort_index, valid)
    terms = tbk._device_constants(bplan, torch.device("cpu"))["terms"]
    args = (bplan, terms, uvw_s, chan, vld, plan.freq0_hz, plan.dfreq_hz)
    iu0, iv0, uk, vk, j, wk, keep = tbk._stream_sparse_taps(*args)
    dense = tbk._stream_taps(*args)
    vre = torch.as_tensor(rng.standard_normal(bplan.total),
                          dtype=torch.float32)
    vim = torch.as_tensor(rng.standard_normal(bplan.total),
                          dtype=torch.float32)
    wk = torch.where(keep[:, None], wk, 0.0).to(torch.float32)
    assert bool(keep.any())
    for task in bplan.tasks:
        sl = slice(task.start, task.start + task.size)
        got = ts.grid_all_layers_sparse(
            vre[sl], vim[sl], iu0[sl], iv0[sl], j[sl], uk[sl].float(),
            vk[sl].float(), wk[sl], task.num_layers, 32, SUPPORT,
            plan.w_support)
        d = task_taps(dense, task)
        want = tt.grid_all_layers(vre[sl], vim[sl], d[0], d[1],
                                  d[2].float(), d[3].float(),
                                  d[4].float(), task.num_layers, 32,
                                  SUPPORT)
        assert torch.equal(got, want)


@pytest.mark.parametrize("fast", [False, True])
def test_sparse_wrapper_gives_complex_layers(fast):
    """Both modes return the complex64 ``[K, N, N]`` stack, the plain
    version's own."""
    rng = np.random.default_rng(3)
    ops = [torch.as_tensor(a) for a in _sparse(rng, 70, 64, 5)]
    got = ts.grid_all_layers_sparse(*ops, 5, 64, SUPPORT, W_SUPPORT,
                                    fast=fast)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (5, 64, 64)
    want = ts.grid_all_layers_sparse_reference(*ops, 5, 64, SUPPORT,
                                               W_SUPPORT, fast=fast)
    assert torch.equal(got, want)


def test_sparse_wrapper_checks_and_counts():
    rng = np.random.default_rng(2)
    ops = [torch.as_tensor(a) for a in _sparse(rng, 50, 32, 6)]
    ts.reset_launch_counts()
    ts.grid_all_layers_sparse(*ops, 6, 32, SUPPORT, W_SUPPORT)
    assert ts.launch_counts() == {"grid_all_layers_sparse": 0}
    with pytest.raises(SdpShapeError):
        ts.grid_all_layers_sparse(*ops, 6, 32, SUPPORT, 3)
    with pytest.raises(SdpInvalidArgumentError):
        ts.grid_all_layers_sparse(*ops[:-1], torch.zeros((50, 8)), 6, 32,
                                  SUPPORT, 8)
