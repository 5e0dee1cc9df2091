"""The port's row-sharded streaming steps and sharded ingest on gloo
process groups (2 and 4 ranks; 8 ranks for the ingest and a 4 x 2
mesh), against JAX's drivers and the port's single-device ones.

Streaming: tests/test_streaming.py's scenario (150 rows, 2 channels,
256^2, 128^2 sub-grids), chunks of 64 rows at 4 x 20480 slots, fed as
rows 0-63, 64-127 and the short 128-149 (each rank passes its block of
each chunk: 32 or 16 rows, fewer or none in the short chunk); the
packable branch (block_v 128) and the non-packable one (block_v 64).
Ingest: tests/test_pipeline.py:375's stream (21 baselines over 8 ranks:
padded). The ranks run in tests/_torch_dist_workers.py; the JAX
references run here while they do.

Tolerances: JAX's sharded tests (tests/test_streaming.py:270-311,
:366-388): image 2e-4 of the interior maximum (margin 32), prediction
1e-5 of max|vis|, against JAX's single-device StreamingGridder /
StreamingDegridder and the port's single-device ones, on both branches
(JAX's single-device stream takes the non-packable branch at block_v
64 too). Ingest (tests/test_pipeline.py:
375-400): flags and weights equal to JAX's sharded ingest on the
8-device mesh, the fraction at rtol 1e-6. Counters are exact; every
rank's image is bit-equal to every other rank's.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import _torch_dist_workers as workers  # noqa: E402
import _torch_scenario as sc  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ska_sdp_func_torch.parallel import (  # noqa: E402
    StreamingDegridder,
    StreamingGridder,
)
from ska_sdp_func_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from ska_sdp_func_tpu.parallel import (  # noqa: E402
    StreamingDegridder as JStreamingDegridder,
    StreamingGridder as JStreamingGridder,
    plan_stream as j_plan_stream,
    plan_wstack as j_plan_wstack,
    stream_tasks as j_stream_tasks,
)
from ska_sdp_func_tpu.pipeline.ingest import (  # noqa: E402
    ingest_flag_and_weight_sharded as j_ingest_sharded,
)

GROUP_LIMIT = 110.0
MARGIN = 32
BRANCHES = ("packable", "split")


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    g = workers.Groups(tmp_path_factory.mktemp("sharded_stream"),
                       {2: ("streaming",), 4: ("streaming",),
                        8: ("ingest", "streaming2d")}, GROUP_LIMIT)
    yield g
    g.close()


def _results(groups, world):
    try:
        return groups.results(world)
    except RuntimeError as err:
        pytest.fail(str(err))


def _run(gridder_cls, degridder_cls, sp, uvw, vis):
    sg = gridder_cls(sp)
    for lo, hi in workers.STREAM_CHUNKS:
        sg.accumulate(uvw[lo:hi], vis[lo:hi])
    sd = degridder_cls(sp).set_model(sc.two_point_image())
    return dict(image=np.asarray(sg.finalize()),
                counters=[int(x) for x in sg.counters()],
                predict=np.asarray(sd.predict(uvw[:64])))


@pytest.fixture(scope="module")
def refs(groups):
    """JAX's single-device stream, both branches, and its sharded ingest
    (computed while the ranks run)."""
    uvw, vis = sc.make_inputs()
    jplan = j_plan_wstack(uvw, sc.FREQ0, sc.DFREQ, sc.NUM_CHAN,
                          sc.IMAGE_SIZE, **sc.PARAMS)
    boxes = j_stream_tasks(jplan, uvw)
    out = {branch: _run(JStreamingGridder, JStreamingDegridder,
                        j_plan_stream(jplan, boxes, chunk_rows=64,
                                      block_v=bv, cap_slots=4 * 20480),
                        uvw, vis)
           for branch, bv in (("packable", 128), ("split", 64))}
    vis4d, w4d = workers.ingest_case()
    flags, w, frac = j_ingest_sharded(jnp.asarray(vis4d), jnp.asarray(w4d),
                                      j_make_mesh(8))
    out["ingest"] = (np.asarray(flags), np.asarray(w), float(frac))
    return out


@pytest.fixture(scope="module")
def single():
    """The port's single-device stream, both branches."""
    uvw, vis, _, _, plans = workers.stream_case()
    return {branch: _run(lambda p: StreamingGridder(p, device="cpu"),
                         lambda p: StreamingDegridder(p, device="cpu"),
                         sp, uvw, vis)
            for branch, sp in plans.items()}


def _interior_err(got, want, m=MARGIN):
    return (np.abs(got[m:-m, m:-m] - want[m:-m, m:-m]).max()
            / np.abs(want[m:-m, m:-m]).max())


def _check_stream(results, prefix, wants):
    image = results[0][prefix + "image"]
    assert image.dtype == np.float32
    for r in results:
        np.testing.assert_array_equal(r[prefix + "image"], image)
        np.testing.assert_array_equal(r[prefix + "counters"],
                                      [300, 0, 0])
    for want in wants:
        assert _interior_err(image, want["image"]) < 2e-4
        np.testing.assert_allclose(
            results[0][prefix + "predict"], want["predict"],
            atol=1e-5 * np.abs(want["predict"]).max())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("branch", BRANCHES)
def test_streaming_sharded_matches_single(groups, refs, single, world,
                                          branch):
    """Row-sharded chunk steps == the single-device stream: image,
    counters (summed over the ranks) and the gathered prediction."""
    assert single[branch]["counters"] == [300, 0, 0]
    assert refs[branch]["counters"] == [300, 0, 0]
    _check_stream(_results(groups, world), f"stream_{branch}_",
                  [single[branch], refs[branch]])


@pytest.mark.parametrize("world", [2, 4])
def test_streaming_sharded_overflow_voids_every_rank(groups, world):
    """A chunk only rank 0 holds overflows its shard's 1024 slots: the
    overflow is reduced before the placement, so every rank voids the
    chunk (zero image, voided 1, nothing processed) and finalize raises
    on every rank."""
    for r in _results(groups, world):
        assert not r["stream_void_image"].any()
        np.testing.assert_array_equal(r["stream_void_counters"], [0, 0, 1])
        assert bool(r["stream_void_raises"])


def test_streaming_sharded_multi_axis_mesh(groups, refs, single):
    """On a 4 x 2 mesh ("rows", "cols") only "rows" shards the rows
    (4 shards at cap / 4): every rank, both columns, holds the
    single-device image."""
    _check_stream(_results(groups, 8), "stream2d_",
                  [single["packable"], refs["packable"]])


def test_ingest_sharded_matches_jax(groups, refs):
    """Each of 8 ranks flags its block of the 21 baselines (padded to 24):
    gathered, the flags and weights equal JAX's sharded ingest; the
    flagged fraction is the whole stream's on every rank."""
    flags, w, frac = refs["ingest"]
    assert frac > 0
    for r in _results(groups, 8):
        np.testing.assert_array_equal(r["ingest_flags"], flags)
        np.testing.assert_array_equal(r["ingest_weights"], w)
        np.testing.assert_allclose(float(r["ingest_frac"]), frac, rtol=1e-6)
        np.testing.assert_array_equal(r["ingest_local"], [8, 3, 16, 2])
