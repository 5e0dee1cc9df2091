"""The port's multi-process layer on gloo process groups: distributed
SwiFTly against JAX's SwiftlyDistributed, and the sharded w-stacking
drivers against the single-device task drivers.

One process group a world size (8 ranks: SwiFTly on
tests/test_swiftly_dist.py's arrays; 1 rank: SwiFTly against the local
chain and the sharded drivers; 2 and 4 ranks: the sharded drivers),
spawned once for the module from tests/_torch_dist_workers.py (torch and
the port only; set up through a file store, 60 s for each collective,
one thread a rank). The parent joins a group's ranks within
GROUP_LIMIT seconds, then ends them and fails.

Tolerances: JAX's (tests/test_swiftly_dist.py): the chains against
SwiftlyDistributed and the local chain at atol 1e-12, the analytic
subgrids at decimal 6, the 2-D point sources at atol 2e-6; the sharded
drivers against grid_all_tasks / degrid_all_tasks over all rows at atol
1e-10 in the interior (border 8: the 1/PSWF correction amplifies the
reordered sums there) and atol 1e-12 (tests/test_parallel.py:69-108).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import _torch_dist_workers as workers  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.fourier_transforms import Swiftly  # noqa: E402
from ska_sdp_func_torch.parallel import (  # noqa: E402
    degrid_all_tasks,
    grid_all_tasks,
    pad_rows,
    pad_rows_arrays,
)
from ska_sdp_func_tpu.fourier_transforms import (  # noqa: E402
    Swiftly as JSwiftly,
)
from ska_sdp_func_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from ska_sdp_func_tpu.parallel.swiftly_dist import (  # noqa: E402
    SwiftlyDistributed as JSwiftlyDistributed,
)

GROUP_LIMIT = 110.0
JOBS = {8: ("swiftly",), 1: ("swiftly", "wstack"), 2: ("wstack",),
        4: ("wstack",)}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """``group(world)``: every rank's results, one process group a world
    size for the module."""
    done = {}

    def get(world):
        if world not in done:
            done[world] = _spawn(tmp_path_factory.mktemp(f"world{world}"),
                                 world)
        return done[world]

    return get


def _spawn(out, world):
    try:
        return workers.spawn(out, world, JOBS[world], GROUP_LIMIT)
    except RuntimeError as err:
        pytest.fail(str(err))


def _stack(results, key):
    return np.concatenate([r[key] for r in results])


@pytest.fixture(scope="module")
def jax_dist8():
    c = workers.swiftly_case(8)
    p = workers.SWIFTLY
    sw = JSwiftly(p["N"], p["yN_size"], p["xM_size"], p["W"])
    dist = JSwiftlyDistributed(sw, jmake_mesh(8))
    return dict(
        c=c,
        f2s=np.asarray(dist.facets_to_subgrids(
            jnp.asarray(c["facets"]), c["offs"], c["offs"], c["xA"])),
        s2f=np.asarray(dist.subgrids_to_facets(
            jnp.asarray(c["subgrids"]), c["offs"], c["offs"], c["yB"])),
        f2s_2d=np.asarray(dist.facets_to_subgrids_2d(
            jnp.asarray(c["facets2d"]), c["offs2"], c["offs2"], c["xA"])),
        s2f_2d=np.asarray(dist.subgrids_to_facets_2d(
            jnp.asarray(c["subgrids2d"]), c["offs2"], c["offs2"],
            c["yB"])))


@pytest.mark.parametrize("chain", ["f2s", "s2f", "f2s_2d", "s2f_2d"])
def test_swiftly_dist8_matches_jax(group, jax_dist8, chain):
    """Each chain at world size 8, every rank's block in rank order,
    against JAX's SwiftlyDistributed on the 8-device mesh."""
    got = _stack(group(8), "swiftly_" + chain)
    want = jax_dist8[chain]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_swiftly_dist8_analytic(group, jax_dist8):
    """The forward chain reproduces the sources' DFT (decimal 6), the 2-D
    reverse chain the point sources' intensities (atol 2e-6) where a
    facet holds one (none does at these offsets, as in
    tests/test_swiftly_dist.py; world size 1 holds its point)."""
    c = jax_dist8["c"]
    results = group(8)
    N = workers.SWIFTLY["N"]
    got = _stack(results, "swiftly_f2s")
    for m, sg_off in enumerate(c["offs"]):
        want = workers.subgrid_from_sources(c["sources"], N, c["xA"],
                                            sg_off)
        np.testing.assert_array_almost_equal(got[m], want, decimal=6)
    facets = _stack(results, "swiftly_s2f_2d")
    yB = c["yB"]
    for d, (o0, o1) in enumerate(c["offs2"]):
        for a, x, y in c["points2"]:
            p0 = (x - o0 + yB // 2) % N
            p1 = (y - o1 + yB // 2) % N
            if 0 <= p0 < yB and 0 <= p1 < yB:
                np.testing.assert_allclose(facets[d, p0, p1], a, atol=2e-6)


def test_swiftly_dist8_gather_and_checks(group):
    """gather_rows gives every rank the blocks in rank order; offsets
    that do not match the mesh raise."""
    results = group(8)
    stacked = _stack(results, "swiftly_f2s")
    for r in results:
        np.testing.assert_array_equal(r["swiftly_f2s_gathered"], stacked)
        assert bool(r["swiftly_bad_offsets_raise"])


def test_swiftly_dist1_matches_local_chain(group):
    """World size 1: the distributed chains are the local static-offset
    chains of the port (and JAX's), at atol 1e-12."""
    (r,) = group(1)
    c = workers.swiftly_case(1)
    p = workers.SWIFTLY
    (off,), ((o0, o1),) = c["offs"], c["offs2"]
    xM, yN, xA, yB = p["xM_size"], p["yN_size"], c["xA"], c["yB"]
    for sw in (Swiftly(p["N"], yN, xM, p["W"], device="cpu"),
               JSwiftly(p["N"], yN, xM, p["W"])):
        as_in = torch.as_tensor if isinstance(sw, Swiftly) else jnp.asarray
        zeros = (lambda *s: torch.zeros(s, dtype=torch.complex128)) \
            if isinstance(sw, Swiftly) else (lambda *s: jnp.zeros(s, complex))
        prep = sw.prepare_facet(as_in(c["facets"][0]), off)
        acc = sw.add_to_subgrid(sw.extract_from_facet(prep, off), zeros(xM),
                                off)
        np.testing.assert_allclose(r["swiftly_f2s"][0], np.asarray(
            sw.finish_subgrid(acc, xA, off)), atol=1e-12)
        prep = sw.prepare_subgrid_inplace(as_in(c["subgrids"][0]), off)
        acc = sw.add_to_facet(sw.extract_from_subgrid(prep, off),
                              zeros(yN), off)
        np.testing.assert_allclose(r["swiftly_s2f"][0], np.asarray(
            sw.finish_facet(acc, yB, off)), atol=1e-12)
        f = sw.prepare_facet(as_in(c["facets2d"][0]), o1)
        f = sw.prepare_facet(f.transpose(1, 0) if isinstance(sw, Swiftly)
                             else f.T, o0)
        f = f.transpose(1, 0) if isinstance(sw, Swiftly) else f.T
        g = sw.extract_from_facet(f, o1)
        g = sw.extract_from_facet(g.transpose(1, 0) if isinstance(
            sw, Swiftly) else g.T, o0)
        g = g.transpose(1, 0) if isinstance(sw, Swiftly) else g.T
        acc = sw.add_to_subgrid_2d(g, zeros(xM, xM), o0, o1)
        lo = xM // 2 - xA // 2
        full = np.asarray(sw.finish_subgrid_inplace_2d(acc, o0, o1))
        np.testing.assert_allclose(r["swiftly_f2s_2d"][0],
                                   full[lo:lo + xA, lo:lo + xA], atol=1e-12)


def test_swiftly_dist1_reverse_2d_point_sources(group):
    """World size 1, 2-D reverse chain: the point sources' intensities
    at their pixels (atol 2e-6)."""
    (r,) = group(1)
    c = workers.swiftly_case(1)
    N, yB = workers.SWIFTLY["N"], c["yB"]
    (o0, o1), = c["offs2"]
    for a, x, y in c["points2"]:
        p0 = (x - o0 + yB // 2) % N
        p1 = (y - o1 + yB // 2) % N
        np.testing.assert_allclose(r["swiftly_s2f_2d"][0, p0, p1], a,
                                   atol=2e-6)


@pytest.fixture(scope="module")
def wstack_single():
    """The single-device task drivers over all rows (and over the first
    PAD_ROWS rows)."""
    c = workers.wstack_case()
    plan = workers.wstack_plan(c)
    kern = plan.kernel()
    out = {}
    for tag, n in (("", c["uvw"].shape[0]), ("pad_", workers.PAD_ROWS)):
        st = np.zeros(n, np.int32)
        en = np.full(n, c["num_chan"], np.int32)
        out[tag + "image"] = grid_all_tasks(
            plan, kern, c["vis"][:n], c["uvw"][:n], st, en,
            device="cpu").real.numpy()
        out[tag + "vis"] = degrid_all_tasks(
            plan, kern, c["image"].astype(complex), c["uvw"][:n], st, en,
            device="cpu").numpy()
    return out


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_grid_matches_single_device(group, wstack_single, world):
    """Every rank holds the summed image: grid_all_tasks over all rows,
    at atol 1e-10 in the interior (border 8)."""
    b = 8
    for tag in ("", "pad_"):
        want = wstack_single[tag + "image"]
        for r in group(world):
            got = r["wstack_" + tag + "image"]
            assert got.shape == want.shape and got.dtype == np.float64
            np.testing.assert_allclose(got[b:-b, b:-b], want[b:-b, b:-b],
                                       atol=1e-10)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_degrid_matches_single_device(group, wstack_single, world):
    """Each rank degrids its own rows; gathered in rank order and trimmed
    they are degrid_all_tasks' visibilities at atol 1e-12."""
    for tag, n in (("", 100), ("pad_", workers.PAD_ROWS)):
        want = wstack_single[tag + "vis"]
        for r in group(world):
            got = r["wstack_" + tag + "vis"]
            assert got.shape == (n, 2)
            assert np.any(got != 0)
            np.testing.assert_allclose(got, want, atol=1e-12)
            assert int(r["wstack_" + tag + "local_rows"]) \
                == pad_rows(n, world)[0] // world


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_placement(group, world):
    """row_sharding is the row placement [Shard(0)] on every rank."""
    for r in group(world):
        np.testing.assert_array_equal(r["wstack_placement"], [0])


def test_pad_rows():
    """100 rows over 8 ranks need 4 pad rows (tests/test_parallel.py:109);
    pad rows select no channel and carry zeros."""
    assert pad_rows(100, 8) == (104, 4)
    assert pad_rows(100, 4) == (100, 0)
    assert pad_rows(98, 4) == (100, 2)
    uvw = torch.ones((100, 3), dtype=torch.float64)
    vis = torch.ones((100, 2), dtype=torch.complex64)
    st = torch.zeros(100, dtype=torch.int32)
    en = torch.full((100,), 2, dtype=torch.int32)
    u, v, s, e = pad_rows_arrays(uvw, vis, st, en, 8)
    assert u.shape == (104, 3) and v.shape == (104, 2)
    assert v.dtype == torch.complex64 and e.dtype == torch.int32
    assert not u[100:].any() and not v[100:].any()
    assert not s[100:].any() and not e[100:].any()
    assert torch.equal(e[:100], en)
    u, v, s, e = pad_rows_arrays(uvw, None, st, en, 8)
    assert v is None and u.shape[0] == 104
    same = pad_rows_arrays(uvw, vis, st, en, 4)
    assert all(a is b for a, b in zip(same, (uvw, vis, st, en)))
