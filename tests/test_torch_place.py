"""The plain version of the placement kernel (K5) against the Pallas kernel.

``place_stream_pallas`` runs in interpret mode (as the JAX package's own
CPU tests run it). A copy is exact, so outputs compare bit for bit, on
int32 and float32 payloads in one call, with filler blocks, garbage
``src0`` where ``vcnt <= 0`` and blocks that read past the payload end.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.kernels import place as tp  # noqa: E402
from ska_sdp_func_tpu.kernels.place import place_stream_pallas  # noqa: E402


def _case(seed, n, bv, nblocks):
    rng = np.random.default_rng(seed)
    vcnt = rng.integers(-3, bv + 1, nblocks)
    vcnt[::4] = 0                                 # filler blocks
    src0 = rng.integers(0, n + 1, nblocks)        # garbage where vcnt <= 0
    src0[1] = n - 5                               # reads past the end
    vcnt[1] = bv
    ops = (rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64
                        ).astype(np.int32),
           rng.standard_normal(n).astype(np.float32),
           rng.integers(0, 7, n).astype(np.int32))
    return src0.astype(np.int32), vcnt.astype(np.int32), ops


@pytest.mark.parametrize("n,bv,nblocks", [(1000, 128, 12), (5000, 256, 24),
                                          (300, 1024, 3)])
def test_place_reference_matches_pallas(n, bv, nblocks):
    src0, vcnt, ops = _case(n, n, bv, nblocks)
    cap = bv * nblocks
    want = place_stream_pallas(jnp.asarray(src0), jnp.asarray(vcnt),
                               tuple(jnp.asarray(o) for o in ops), bv, cap,
                               interpret=True)
    args = (torch.as_tensor(src0), torch.as_tensor(vcnt),
            tuple(torch.as_tensor(o) for o in ops), bv, cap)
    got = tp.place_stream_reference(*args)
    assert len(got) == len(ops)
    for g, w, o in zip(got, want, ops):
        assert g.dtype == torch.as_tensor(o).dtype and g.shape == (cap,)
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))
    before = tp.place_stream.launches
    again = tp.place_stream(*args)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert tp.place_stream.launches == before


def test_place_semantics():
    src0 = torch.tensor([2, 99, 0], dtype=torch.int32)
    vcnt = torch.tensor([3, 0, 5], dtype=torch.int32)
    x = torch.arange(1, 7, dtype=torch.int32)            # N = 6
    (got,) = tp.place_stream(src0, vcnt, (x,), 4, 12)
    assert got.tolist() == [3, 4, 5, 0, 0, 0, 0, 0, 1, 2, 3, 4]


def test_place_rejects_bad_operands():
    from ska_sdp_func_torch.utility.errors import (
        SdpDataTypeError,
        SdpInvalidArgumentError,
        SdpShapeError,
    )

    s = torch.zeros(3, dtype=torch.int32)
    x = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(SdpInvalidArgumentError):
        tp.place_stream(s, s, (x,), 4, 10)                # cap % bv
    with pytest.raises(SdpDataTypeError):
        tp.place_stream(s, s, (x.double(),), 4, 12)
    with pytest.raises(SdpShapeError):
        tp.place_stream(s, s, (x, x[:5]), 4, 12)
    with pytest.raises(SdpDataTypeError):
        tp.place_stream(s.long(), s, (x,), 4, 12)
