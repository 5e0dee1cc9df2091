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
    """exp_overlap.py:57-62."""
    b1 = jnp.zeros((SUPPORT,) + x.shape[-1:], jnp.float32)
    b2 = jnp.zeros_like(b1)
    for k in range(DEG, 0, -1):
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


def kernel_jnp(variant, pa, pb, c):
    """exp_overlap.py:85-123 for each block: (the last block's acc, sum
    |acc| of every block)."""
    sums = []
    for b in range(pa.shape[0] // BLOCK):
        acc = jnp.zeros((LANES, LANES), jnp.float32)
        chunks = [(pa[b * BLOCK + i * SUB:b * BLOCK + (i + 1) * SUB],
                   pb[b * BLOCK + i * SUB:b * BLOCK + (i + 1) * SUB])
                  for i in range(BLOCK // SUB)]
        for ca, cb in chunks:
            if variant == "dot":
                u_all = jnp.broadcast_to(
                    ca.astype(jnp.float32).reshape(1, SUB)
                    * jnp.float32(1e-9), (LANES, SUB))
                vb = jnp.broadcast_to(cb.astype(jnp.float32).reshape(SUB, 1)
                                      * jnp.float32(1e-9), (SUB, LANES))
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


def test_overlap_rejects_bad_operands():
    pa, pb, c = (torch.as_tensor(a) for a in _inputs())
    with pytest.raises(SdpInvalidArgumentError):
        ov.overlap("mxu", pa, pb, c)
    with pytest.raises(SdpInvalidArgumentError):
        ov.overlap("dot", pa, pb, c, block=1000, sub=500)
    with pytest.raises(SdpInvalidArgumentError):
        ov.overlap("dot", pa, pb, c[:, :4])
