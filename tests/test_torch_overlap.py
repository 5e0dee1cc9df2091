"""exp_overlap's build / product probe (P2b) against a jnp transcription.

experiments/exp_overlap.py's kernel is a closure inside ``measure_one``,
so its ``clenshaw`` and ``build`` are copied here and its body transcribed
in jnp, block by block as its grid runs it, at TOTAL = 4 x BLOCK (seed 0).
The TPU kernel's output is the last block's ``acc``; the port also returns
each block's ``sum |acc|``, checked here against the transcription's, so
that every block's work is held to it. f32 at 1e-5 of max|JAX| (HIGHEST
products; another f32 sum order).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.kernels import overlap as ov  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
)

BLOCK, SUB, LANES, DEG, SUPPORT = 1024, 512, 128, 11, 8
TOTAL = 4 * BLOCK
TOL = 1e-5
HIGHEST = jax.lax.Precision.HIGHEST


def clenshaw(x, c):
    """exp_overlap.py:57-62 (degree DEG there; the fit's own here)."""
    b1 = jnp.zeros((SUPPORT,) + x.shape[-1:], jnp.float32)
    b2 = jnp.zeros_like(b1)
    for k in range(c.shape[0] - 1, 0, -1):
        b1, b2 = c[k][:, None] + 2.0 * x * b1 - b2, b1
    return c[0][:, None] + x * b1 - b2


def build(pa, pb, c):
    """exp_overlap.py:64-83."""
    n = pa.shape[0]
    xu = pa.astype(jnp.float32) * np.float32(1e-7) - 0.5
    uk = clenshaw(xu, c)
    xv = pb.astype(jnp.float32) * np.float32(1e-7) - 0.5
    vk = clenshaw(xv, c)
    xw = (pa ^ pb).astype(jnp.float32) * np.float32(1e-7) - 0.5
    wk = clenshaw(xw, c)
    iv = (pa & 120).reshape(n, 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (n, LANES), 1)
    vb = jnp.zeros((n, LANES), jnp.float32)
    vkt = vk.T
    for s in range(SUPPORT):
        vb = jnp.where(col == iv + s, vkt[:, s:s + 1], vb)
    row = jax.lax.broadcasted_iota(jnp.int32, (16, n), 0)
    uo = pb & 7
    ub = jnp.zeros((16, n), jnp.float32)
    for s in range(SUPPORT):
        ub = jnp.where(row == uo + s, uk[s], ub)
    u_all = jnp.concatenate([ub * wk[j % 4] for j in range(8)], axis=0)
    return u_all, vb


def kernel_jnp(variant, pa, pb, c, block=BLOCK, sub=SUB):
    """exp_overlap.py:85-123 for each block: (the last block's acc, sum
    |acc| of every block)."""
    sums = []
    for b in range(pa.shape[0] // block):
        acc = jnp.zeros((LANES, LANES), jnp.float32)
        chunks = [(pa[b * block + i * sub:b * block + (i + 1) * sub],
                   pb[b * block + i * sub:b * block + (i + 1) * sub])
                  for i in range(block // sub)]
        for ca, cb in chunks:
            if variant == "dot":
                u_all = jnp.broadcast_to(
                    ca.astype(jnp.float32).reshape(1, sub)
                    * jnp.float32(1e-9), (LANES, sub))
                vb = jnp.broadcast_to(cb.astype(jnp.float32).reshape(sub, 1)
                                      * jnp.float32(1e-9), (sub, LANES))
                acc = acc + jnp.dot(u_all, vb, precision=HIGHEST,
                                    preferred_element_type=jnp.float32)
            elif variant == "vpu":
                u_all, vb = build(ca, cb, c)
                acc = acc + u_all[:, :1] * vb[:1, :]
            else:       # both, both2: the same sums
                u_all, vb = build(ca, cb, c)
                acc = acc + jnp.dot(u_all, vb, precision=HIGHEST,
                                    preferred_element_type=jnp.float32)
        sums.append(float(jnp.sum(jnp.abs(acc))))
    return np.asarray(acc), np.asarray(sums, np.float32)


def _inputs():
    """exp_overlap.py:131-135 at TOTAL slots."""
    rng = np.random.default_rng(0)
    pa = rng.integers(0, 2 ** 22, (1, TOTAL), np.int32)[0]
    pb = rng.integers(0, 2 ** 22, (1, TOTAL), np.int32)[0]
    c = rng.standard_normal((DEG + 1, SUPPORT)).astype(np.float32)
    return pa, pb, c


@pytest.mark.parametrize("variant", ov.VARIANTS)
def test_overlap_matches_jnp(variant):
    pa, pb, c = _inputs()
    want, want_sums = kernel_jnp(variant, jnp.asarray(pa), jnp.asarray(pb),
                                 jnp.asarray(c))
    before = ov.overlap.launches
    got, sums = ov.overlap(variant, torch.as_tensor(pa), torch.as_tensor(pb),
                           torch.as_tensor(c), BLOCK, SUB)
    assert ov.overlap.launches == before
    assert sums.shape == (TOTAL // BLOCK,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    np.testing.assert_allclose(sums.numpy(), want_sums, rtol=TOL)


# The card tests' other shapes (tests/test_torch_cuda_kernels.py
# OVERLAP_CASES): blocks of 32 (a chunk a 32-slot stage), 96 (three stages
# and chunks), 128 (two chunks a 64-slot stage) and 2048 slots, one block,
# fits of 2 and 16 coefficients; (num_blocks, block, sub, ncoef).
SHAPES = [(1, 1024, 512, 12), (3, 32, 32, 12), (3, 96, 32, 2),
          (3, 128, 32, 12), (2, 2048, 512, 2), (2, 1024, 512, 16)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("variant", ov.VARIANTS)
def test_overlap_shapes_match_jnp(variant, shape):
    """The plain version, which the card holds the kernel to at these
    shapes, against the transcription."""
    num_blocks, block, sub, ncoef = shape
    rng = np.random.default_rng(num_blocks + block + ncoef)
    pa, pb = (rng.integers(0, 2 ** 22, num_blocks * block, np.int32)
              for _ in range(2))
    c = rng.standard_normal((ncoef, SUPPORT)).astype(np.float32)
    want, want_sums = kernel_jnp(variant, jnp.asarray(pa), jnp.asarray(pb),
                                 jnp.asarray(c), block, sub)
    got, sums = ov.overlap(variant, torch.as_tensor(pa), torch.as_tensor(pb),
                           torch.as_tensor(c), block, sub)
    assert sums.shape == (num_blocks,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    np.testing.assert_allclose(sums.numpy(), want_sums, rtol=TOL)


def test_overlap_rejects_bad_operands():
    pa, pb, c = (torch.as_tensor(a) for a in _inputs())
    with pytest.raises(SdpInvalidArgumentError):
        ov.overlap("mxu", pa, pb, c)
    with pytest.raises(SdpInvalidArgumentError):
        ov.overlap("dot", pa, pb, c, block=1000, sub=500)
    with pytest.raises(SdpInvalidArgumentError):
        ov.overlap("dot", pa, pb, c[:, :4])
