"""The port's uv-tile binning and tiled Briggs weighting against the JAX
package on the same NumPy-seeded inputs (tests/test_tiled_functions.py's
scenario), on the CPU (``device="cpu"``).

Tolerances: offsets, counts, skipped counts, tile keys, record orders and
visibility indices exact; the sorted positions (f64 products) exact, as
the same operations in the same order; the weights (scatter and segment
sums) 1e-10 relative.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.utility.errors import SdpShapeError  # noqa: E402
from ska_sdp_func_torch.visibility import opt_weighting as tw  # noqa: E402
from ska_sdp_func_torch.visibility import tiled_functions as tt  # noqa
from ska_sdp_func_tpu.visibility import opt_weighting as jw  # noqa: E402
from ska_sdp_func_tpu.visibility import tiled_functions as jt  # noqa: E402

C_0 = 299792458.0
CPU = "cpu"


@pytest.fixture(scope="module")
def tile_data():
    """tests/test_tiled_functions.py's scenario, plus samples near the
    grid's edge (some skipped) and a second pol."""
    rng = np.random.default_rng(3)
    t, b, c = 3, 20, 2
    grid_size, cell = 64, 1e-4
    max_u = (grid_size / 2 - 8) / (grid_size * cell) * C_0 / (1.1 * C_0)
    uvw = rng.uniform(-1, 1, (t, b, 3)) * max_u * 0.8
    uvw[0, :4, :2] *= 2.5
    freqs = np.array([C_0, 1.1 * C_0])
    vis = rng.standard_normal((t, b, c, 2)) \
        + 1j * rng.standard_normal((t, b, c, 2))
    weights = rng.uniform(0.5, 2.0, (t, b, c, 2))
    return dict(uvw=uvw, freqs=freqs, vis=vis, weights=weights,
                grid_size=grid_size, cell=cell)


def exact(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def near(got, want, tol=1e-10):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.abs(got[ok] - want[ok]).max(initial=0.0) \
        <= tol * np.abs(want[ok]).max()


GEOMETRIES = [(16, 16, 3), (16, 8, 0), (8, 16, 5), (32, 32, 8)]


@pytest.mark.parametrize("tile_u, tile_v, support", GEOMETRIES)
def test_count_and_prefix_sum_matches_jax(tile_data, tile_u, tile_v,
                                          support):
    d = tile_data
    args = (d["grid_size"], tile_u, tile_v, d["cell"], support)
    want = jt.count_and_prefix_sum(jnp.asarray(d["uvw"]),
                                   jnp.asarray(d["freqs"]), *args)
    got = tt.count_and_prefix_sum(d["uvw"], d["freqs"], *args, device=CPU)
    for g, w in zip(got[:3], want[:3]):
        exact(g, w)
    assert got[3] == want[3] > 0
    assert int(got[2][0]) > 0


@pytest.mark.parametrize("tile_u, tile_v, support", GEOMETRIES)
def test_bucket_sort_and_indexing_match_jax(tile_data, tile_u, tile_v,
                                            support):
    """The stable sort's record order, bit for bit."""
    d = tile_data
    args = (d["grid_size"], tile_u, tile_v, d["cell"], support)
    want = jt.bucket_sort(jnp.asarray(d["uvw"]), jnp.asarray(d["freqs"]),
                          jnp.asarray(d["vis"]), jnp.asarray(d["weights"]),
                          *args)
    got = tt.bucket_sort(d["uvw"], d["freqs"], d["vis"], d["weights"],
                         *args, device=CPU)
    for g, w in zip(got, want):
        exact(g, w)
    want = jt.tiled_indexing(jnp.asarray(d["uvw"]), jnp.asarray(d["freqs"]),
                             *args)
    got = tt.tiled_indexing(d["uvw"], d["freqs"], *args, device=CPU)
    for g, w in zip(got, want):
        exact(g, w)


def test_tile_ranges_use_f32_arithmetic():
    """The tile range of rel = 20, support 0, tile 7: f32 21 * f32(1/7)
    rounds to 3.0000002, so the range ends before tile 4, not 3 (an exact
    division would say 3)."""
    rel = torch.tensor([20], dtype=torch.int64)
    lo, hi = tt._tile_range(rel, 0, 7)
    assert np.float32(21) * np.float32(1 / 7) > 3
    assert (int(lo[0]), int(hi[0])) == (2, 4)


@pytest.mark.parametrize("robust", [0.5, 0.0, -2.0])
@pytest.mark.parametrize("tile_u, tile_v, support", GEOMETRIES)
def test_tiled_weighting_matches_jax(tile_data, robust, tile_u, tile_v,
                                     support):
    """Both variants; with support > 0 a visibility spans several tiles
    and the indexed variant keeps the last record's weight, as JAX's
    serial scatter does."""
    d = tile_data
    args = (robust, d["grid_size"], d["cell"], support, tile_u, tile_v)
    j_tile, j_out = jw.optimized_weighting(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freqs"]),
        jnp.asarray(d["vis"]), jnp.asarray(d["weights"]), *args)
    t_tile, t_out = tw.optimized_weighting(
        d["uvw"], d["freqs"], d["vis"], d["weights"], *args, device=CPU)
    exact(t_tile, j_tile)
    near(t_out, j_out)
    j_idx, j_out = jw.optimised_indexed_weighting(
        jnp.asarray(d["uvw"]), jnp.asarray(d["freqs"]),
        jnp.asarray(d["vis"]), jnp.asarray(d["weights"]), *args)
    t_idx, t_out = tw.optimised_indexed_weighting(
        d["uvw"], d["freqs"], d["vis"], d["weights"], *args, device=CPU)
    exact(t_idx, j_idx)
    near(t_out, j_out)
    assert t_out.shape == d["weights"].shape
    if support:
        counts = np.bincount(np.asarray(j_idx))
        assert counts.max() > 1


def test_indexed_weighting_last_record_wins(tile_data):
    """A visibility in several tiles takes the weight of its LAST record
    in sorted order: the indexed output against the sorted weights of
    ``optimized_weighting`` (the same records in the same order), pol 0's
    weights broadcast over the pols."""
    d = tile_data
    args = (0.5, d["grid_size"], d["cell"], 8, 16, 16)
    idx, out = tw.optimised_indexed_weighting(
        d["uvw"], d["freqs"], d["vis"], d["weights"], *args, device=CPU)
    _, out_sorted = tw.optimized_weighting(
        d["uvw"], d["freqs"], d["vis"], d["weights"], *args, device=CPU)
    idx, out_sorted = idx.numpy(), out_sorted.numpy()
    want = np.zeros(d["weights"].shape[:3]).reshape(-1)
    for pos, v in enumerate(idx):
        want[v] = out_sorted[pos]
    assert np.bincount(idx).max() > 1
    for p in range(d["weights"].shape[3]):
        np.testing.assert_array_equal(out.numpy()[..., p].reshape(-1), want)


@pytest.mark.parametrize("fn", ["count_and_prefix_sum", "tiled_indexing",
                                "bucket_sort", "optimized_weighting",
                                "optimised_indexed_weighting"])
def test_tiled_functions_reject_row_uvw(fn):
    uvw = np.zeros((10, 3))
    freqs = np.asarray([C_0])
    data = np.zeros((10, 1, 1, 1), complex)
    w = np.ones((10, 1, 1, 1))
    args = {"count_and_prefix_sum": (uvw, freqs, 64, 16, 16, 1e-4, 3),
            "tiled_indexing": (uvw, freqs, 64, 16, 16, 1e-4, 3),
            "bucket_sort": (uvw, freqs, data, w, 64, 16, 16, 1e-4, 3),
            "optimized_weighting": (uvw, freqs, data, w, 0.5, 64, 1e-4, 3),
            "optimised_indexed_weighting": (uvw, freqs, data, w, 0.5, 64,
                                            1e-4, 3)}[fn]
    mod = tt if hasattr(tt, fn) else tw
    with pytest.raises(SdpShapeError):
        getattr(mod, fn)(*args, device=CPU)
