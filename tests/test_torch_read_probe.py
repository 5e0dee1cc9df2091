"""bench.py's device-memory read probe (P1) against a jnp transcription.

bench.py's ``_read_kernel`` is a closure inside ``_measure_rooflines``, so
its body is transcribed here in jnp, block by block as its grid runs it,
and held against :func:`ska_sdp_func_torch.kernels.read_probe.read_streams`
(its plain version on CPU tensors) on the same NumPy-seeded streams at
1e-5 of max|JAX| (f32 sums in another order). The port also returns the
sums of every column, which the TPU layout is sliced from: they must equal
NumPy's block sums at the same tolerance.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.kernels import read_probe as rp  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
    SdpShapeError,
)

TOL = 1e-5


def _read_kernel_jnp(xs, s, br, bc):
    """bench.py:155-163 on each (i, j) block of its grid."""
    rows, cols = xs[0].shape
    out = np.zeros((rows // br * 8, cols // bc * 128), np.float32)
    for i in range(rows // br):
        for j in range(cols // bc):
            acc = jnp.zeros((8, 128), jnp.float32)
            for x in xs:
                xr = x[i * br:(i + 1) * br, j * bc:(j + 1) * bc]
                acc = acc + jnp.broadcast_to(
                    jnp.sum(xr * s, axis=0, keepdims=True)[:, :128], (8, 128))
            out[8 * i:8 * i + 8, 128 * j:128 * j + 128] = np.asarray(acc)
    return out


@pytest.mark.parametrize("n,shape,br,bc", [(6, (64, 2048), 16, 512),
                                           (1, (64, 1024), 64, 1024),
                                           (3, (32, 512), 8, 128)])
def test_read_streams_matches_jnp(n, shape, br, bc):
    rng = np.random.default_rng(n)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    s = np.float32(1.000001)
    want = _read_kernel_jnp([jnp.asarray(x) for x in xs], s, br, bc)
    before = rp.read_streams.launches
    out, sums = rp.read_streams([torch.as_tensor(x) for x in xs], float(s),
                                br, bc)
    assert rp.read_streams.launches == before
    assert out.shape == want.shape
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    full = sum(x * s for x in xs).reshape(shape[0] // br, br, -1).sum(1)
    np.testing.assert_allclose(sums.numpy(), full, rtol=0,
                               atol=TOL * np.abs(full).max())


def test_read_streams_rejects_bad_operands():
    x = torch.zeros((64, 1024))
    with pytest.raises(SdpInvalidArgumentError):
        rp.read_streams([x], 1.0, 48, 1024)          # rows % block rows
    with pytest.raises(SdpInvalidArgumentError):
        rp.read_streams([x], 1.0, 16, 64)            # block under 128 cols
    with pytest.raises(SdpInvalidArgumentError):
        rp.read_streams([x] * 9, 1.0, 16, 1024)      # too many streams
    with pytest.raises(SdpShapeError):
        rp.read_streams([x[0]], 1.0, 16, 1024)
