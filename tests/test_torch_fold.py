"""The streaming engine's window fold (K9, K10) against the JAX package.

The plain versions of :mod:`ska_sdp_func_torch.kernels.fold` hold the
Pallas kernels ``fold_groups_pallas`` and ``fold_layers_pallas``
(interpret mode), and ``fold_windows`` the JAX driver ``_fold_windows``,
on seeded windows whose unvisited buckets are NaN (so a read of one would
show) and whose last octet's straddle half is not zero (so the clip
shows). Both add in the same order: the results are equal bit for bit.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.kernels import fold  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpDataTypeError,
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ska_sdp_func_tpu.kernels.packed_tap import (  # noqa: E402
    fold_groups_pallas,
    fold_layers_pallas,
)
from ska_sdp_func_tpu.parallel.packed import (  # noqa: E402
    _fold_windows as j_fold_windows,
)

# (tasks, slabs, octets, w_support, lanes): the small scenario's geometry
# (3 tasks, 8 slabs, 128^2 sub-grids, w_support 4) and a narrower one.
GEOMS = [(3, 8, 16, 4, 128), (2, 3, 4, 2, 32)]


def _windows(tasks, slabs, octets, w_support, lanes, seed=9):
    rng = np.random.default_rng(seed)
    nb = tasks * slabs * octets
    visited = rng.random(nb) < 0.5
    visited[0] = visited[octets - 1] = True        # a first and last octet
    wins = rng.standard_normal((2 * w_support, nb, 16, lanes)).astype(
        np.float32)
    wins[:, ~visited] = np.nan
    return wins, visited


@pytest.mark.parametrize("geom", GEOMS)
def test_fold_groups_matches_jax(geom):
    tasks, slabs, octets, sw, lanes = geom
    wins, visited = _windows(*geom)
    want = np.asarray(fold_groups_pallas(
        jnp.asarray(wins), jnp.asarray(visited.astype(np.int32)),
        tasks * slabs, octets, interpret=True))
    got = fold.fold_groups_reference(torch.as_tensor(wins),
                                     torch.as_tensor(visited),
                                     tasks * slabs, octets).numpy()
    assert got.shape == (2 * sw, tasks * slabs, 8 * octets, lanes)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", GEOMS)
def test_fold_layers_matches_jax(geom):
    tasks, slabs, octets, sw, lanes = geom
    rng = np.random.default_rng(10)
    part = rng.standard_normal((2 * sw, tasks * slabs, 8 * octets,
                                lanes)).astype(np.float32)
    layers = slabs + sw - 1
    want = np.asarray(fold_layers_pallas(jnp.asarray(part), tasks, slabs, sw,
                                         layers, interpret=True))
    got = fold.fold_layers_reference(torch.as_tensor(part), tasks, slabs, sw,
                                     layers).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", GEOMS)
def test_fold_windows_matches_jax(geom):
    tasks, slabs, octets, sw, lanes = geom
    wins, visited = _windows(*geom, seed=11)
    layers = slabs + sw - 1
    want = np.asarray(j_fold_windows(
        jnp.asarray(wins), jnp.asarray(visited), tasks, slabs, octets, sw,
        layers, True))
    got = fold.fold_windows(torch.as_tensor(wins), torch.as_tensor(visited),
                            tasks, slabs, octets, sw, layers)
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == (tasks, layers, 8 * octets, lanes)
    np.testing.assert_array_equal(got.numpy(), want)


# The card tests' edge geometries (tests/test_torch_cuda_kernels.py
# FOLD_CASES): L 1, 3, 60, 130, Sw 1 and 8, one slab, one octet, none and
# all buckets visited; (tasks, slabs, octets, w_support, lanes, share).
EDGES = [(2, 1, 3, 4, 3, 0.5), (2, 3, 1, 2, 60, 0.5), (1, 2, 2, 8, 130, 0.5),
         (2, 3, 4, 1, 1, 0.5), (2, 3, 4, 2, 64, 0.0), (2, 3, 4, 2, 64, 1.0)]


@pytest.mark.parametrize("edge", EDGES, ids=str)
def test_fold_windows_edges_match_jax(edge):
    tasks, slabs, octets, sw, lanes, share = edge
    rng = np.random.default_rng(12)
    nb = tasks * slabs * octets
    visited = rng.random(nb) < share
    wins = rng.standard_normal((2 * sw, nb, 16, lanes)).astype(np.float32)
    wins[:, ~visited] = np.nan
    layers = slabs + sw - 1
    want = np.asarray(j_fold_windows(
        jnp.asarray(wins), jnp.asarray(visited), tasks, slabs, octets, sw,
        layers, True))
    got = fold.fold_windows(torch.as_tensor(wins), torch.as_tensor(visited),
                            tasks, slabs, octets, sw, layers)
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_fold_windows_rejects_bad_inputs():
    tasks, slabs, octets, sw, lanes = GEOMS[1]
    wins, visited = (torch.as_tensor(a) for a in _windows(*GEOMS[1]))
    layers = slabs + sw - 1
    with pytest.raises(SdpShapeError):
        fold.fold_windows(wins[:, 1:], visited, tasks, slabs, octets, sw,
                          layers)
    with pytest.raises(SdpDataTypeError):
        fold.fold_windows(wins, visited.int(), tasks, slabs, octets, sw,
                          layers)
    with pytest.raises(SdpInvalidArgumentError):
        fold.fold_windows(wins, visited, tasks, slabs, octets, sw, layers + 1)
