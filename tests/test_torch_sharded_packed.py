"""The port's block-sharded packed gridder and sharded bucketed grid on
gloo process groups of 2 and 4 ranks, against JAX's single-device
drivers and the port's own.

Scenario: the first 148 rows of tests/test_packed_driver.py's (256^2,
128^2 sub-grids, 2 channels; 71 blocks of 128 slots, so both plans,
padded for 2 and 4 ranks, end in a pad block, and a task straddles two
ranks), and tests/test_bucketed.py's for the bucketed grid (128^2, 32^2
sub-grids, 100 rows; block_v 96, so a task straddles the ranks' chunks
of a multiple of 1024 slots). The ranks run in
tests/_torch_dist_workers.py (the ``packed`` and ``bucketed`` jobs);
the JAX references run here while they do.

Tolerances: JAX's own sharded tests (tests/test_packed_driver.py:
124-148, :425-460; tests/test_bucketed.py:109-132): the packed images
at 1e-3 of the interior maximum (border 24; the ranks drain a straddled
task in two halves), the packed visibilities at 1e-4 of max|vis|, the
bucketed image at 1e-4 of the interior maximum, each against JAX's
single-device driver of the same precision ("highest" for the fused
and compact engines; "bf16" is ``fast=True``'s bf16 bands) and the
port's single-device driver of the same engine and precision. Every
rank's image is bit-equal to every other rank's.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import _torch_dist_workers as workers  # noqa: E402
import _torch_scenario as sc  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ska_sdp_func_torch.parallel import (  # noqa: E402
    grid_all_bucketed,
    packed_gridder,
    plan_packed,
)
from ska_sdp_func_torch.parallel.packed import shard_plan  # noqa: E402
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack  # noqa
from ska_sdp_func_tpu.parallel.bucketed import (  # noqa: E402
    grid_all_bucketed as j_grid_all_bucketed,
    plan_bucketed as j_plan_bucketed,
)
from ska_sdp_func_tpu.parallel.packed import (  # noqa: E402
    packed_gridder as j_gridder,
    plan_packed as j_plan_packed,
)

GROUP_LIMIT = 110.0
WORLDS = (2, 4)
BORDER = 24
MODES = [m[0] for m in workers.PACKED_MODES]
PRECISION = {m[0]: m[2] for m in workers.PACKED_MODES}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    g = workers.Groups(tmp_path_factory.mktemp("sharded_packed"),
                       {w: ("packed", "bucketed") for w in WORLDS},
                       GROUP_LIMIT)
    yield g
    g.close()


def _results(groups, world):
    try:
        return groups.results(world)
    except RuntimeError as err:
        pytest.fail(str(err))


@pytest.fixture(scope="module")
def refs(groups):
    """JAX's single-device references (computed while the ranks run)."""
    uvw, vis = sc.make_inputs()
    uvw, vis = uvw[:workers.PACKED_ROWS], vis[:workers.PACKED_ROWS]
    jplan = j_plan_wstack(uvw, sc.FREQ0, sc.DFREQ, sc.NUM_CHAN,
                          sc.IMAGE_SIZE, **sc.PARAMS)
    jpp = j_plan_packed(jplan, uvw, block_v=128)
    out = {}
    for precision in ("high", "highest", "bf16"):
        jg = j_gridder(jpp, precision=precision, fast=precision == "bf16")
        out[precision] = dict(
            image=np.asarray(jg.grid(jnp.asarray(vis))),
            vis=np.asarray(jg.degrid(jnp.asarray(sc.two_point_image()))))
    buvw, bvis, bplan, _, _, _ = workers.bucketed_case()
    c = workers.wstack_case()
    jbplan = j_plan_wstack(c["uvw"], c["freq0"], c["dfreq"], c["num_chan"],
                           workers.IMAGE_SIZE, **workers.WSTACK)
    jb, sort_index, valid = j_plan_bucketed(jbplan, c["uvw"],
                                            block_v=workers.BUCKET_BLOCK)
    out["bucketed"] = np.asarray(j_grid_all_bucketed(
        jb, jnp.asarray(bvis), jnp.asarray(buvw), jnp.asarray(sort_index),
        jnp.asarray(valid)))
    return out


@pytest.fixture(scope="module")
def single():
    """The port's single-device drivers on the unpadded plans."""
    uvw, vis, plan = workers.packed_case()
    pplan = plan_packed(plan, uvw, block_v=128)
    out = {}
    for tag in MODES:
        g = packed_gridder(pplan, device="cpu", **workers.packed_options(tag))
        out[tag] = dict(image=g.grid(vis).numpy(),
                        vis=g.degrid(sc.two_point_image()).numpy())
    buvw, bvis, _, bplan, sort_index, valid = workers.bucketed_case()
    out["bucketed"] = grid_all_bucketed(bplan, bvis, buvw, sort_index,
                                        valid, device="cpu").numpy()
    return out


def _interior_err(got, want, b=BORDER):
    return (np.abs(got[b:-b, b:-b] - want[b:-b, b:-b]).max()
            / np.abs(want[b:-b, b:-b]).max())


def _bit_equal(results, key):
    return all(np.array_equal(r[key], results[0][key]) for r in results)


@pytest.mark.parametrize("world", WORLDS)
def test_case_straddles_and_pads(world):
    """The plan padded for ``world`` ranks ends in pad blocks, and a task
    has blocks on two ranks (so the all_reduce sums its halves)."""
    unpadded = workers.packed_plan(1).num_blocks
    pplan = workers.packed_plan(world)
    assert pplan.num_blocks > unpadded
    assert pplan.num_blocks % world == 0
    shards = [shard_plan(pplan, world, r) for r in range(world)]
    firsts = [s.tasks[0] for s in shards]
    lasts = [s.tasks[-1] for s in shards]
    assert any(lasts[r] == firsts[r + 1] for r in range(world - 1))
    # The last shard's trailing blocks hold no valid slot.
    valid = shards[-1].arrays["valid"].reshape(-1, pplan.block_v)
    assert not valid[-(pplan.num_blocks - unpadded):].any()
    # A shard keeps the whole plan's w-planes.
    assert all(s.w_plane_ids == pplan.w_plane_ids for s in shards)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", MODES)
def test_packed_grid_sharded(groups, refs, single, world, mode):
    """Every rank's image (sorted block and natural layout) meets JAX's
    single-device "highest" image and the port's single-device image at
    1e-3 of the interior maximum, bit-equal across the ranks."""
    results = _results(groups, world)
    for key in ("image", "natural_image"):
        key = f"packed_{mode}_{key}"
        assert _bit_equal(results, key)
        got = results[0][key]
        assert got.dtype == np.float32
        assert _interior_err(got, refs[PRECISION[mode]]["image"]) < 1e-3
        assert _interior_err(got, single[mode]["image"]) < 1e-3
    np.testing.assert_array_equal(results[0][f"packed_{mode}_image"],
                                  results[0][f"packed_{mode}_natural_image"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", MODES)
def test_packed_degrid_sharded(groups, refs, single, world, mode):
    """Each rank degrids its block of the sorted stream; gathered and
    unsorted they meet JAX's and the port's single-device visibilities
    at 1e-4 of max|vis|."""
    results = _results(groups, world)
    pplan = workers.packed_plan(world)
    for r in results:
        assert int(r[f"packed_{mode}_local_slots"]) == pplan.total // world
    got = results[0][f"packed_{mode}_vis"]
    assert _bit_equal(results, f"packed_{mode}_vis")
    for want in (refs[PRECISION[mode]]["vis"], single[mode]["vis"]):
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 * np.abs(want).max())
    # The gathered sorted blocks are the padded plan's stream.
    sorted_vis = results[0][f"packed_{mode}_sorted"]
    assert sorted_vis.shape == (pplan.total,)
    assert not sorted_vis[~pplan.arrays["valid"]].any()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", MODES)
def test_packed_shards_hold_their_own_slots(groups, world, mode):
    """A rank's gridder holds only its own slots: each rank's per-slot
    tensors are 1/world of the single-device gridder's (of the same
    padded plan), and the gridder that drove the shards built none."""
    results = _results(groups, world)
    want = workers.slot_sizes(packed_gridder(
        workers.packed_plan(world), device="cpu",
        **workers.packed_options(mode))).numpy()
    assert (want > 0).any()
    for r in results:
        np.testing.assert_array_equal(r[f"packed_{mode}_slots"] * world,
                                      want)
        assert not bool(r[f"packed_{mode}_parent_built"])


@pytest.mark.parametrize("world", WORLDS)
def test_packed_functional_forms(groups, refs, world):
    """grid_all_packed_sharded / degrid_all_packed_sharded (the default
    "high" bands) meet JAX's single-device drivers."""
    results = _results(groups, world)
    assert _bit_equal(results, "packed_fn_image")
    want = refs["high"]
    assert _interior_err(results[0]["packed_fn_image"], want["image"]) < 1e-3
    np.testing.assert_allclose(results[0]["packed_fn_vis"], want["vis"],
                               atol=1e-4 * np.abs(want["vis"]).max())


@pytest.mark.parametrize("world", WORLDS)
def test_bucketed_grid_sharded(groups, refs, single, world):
    """grid_all_bucketed_sharded: every rank holds JAX's and the port's
    single-device bucketed image at 1e-4 of the interior maximum, bit-equal
    across the ranks; a task's slots straddle two ranks' chunks."""
    results = _results(groups, world)
    assert _bit_equal(results, "bucketed_image")
    got = results[0]["bucketed_image"]
    assert got.dtype == np.float32
    assert _interior_err(got, refs["bucketed"]) < 1e-4
    assert _interior_err(got, single["bucketed"]) < 1e-4
    bplan = workers.bucketed_case()[3]
    per = -(-bplan.total // (world * 1024)) * 1024
    assert any(t.start // per != (t.start + t.size - 1) // per
               for t in bplan.tasks)
