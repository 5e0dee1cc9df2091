"""Worker processes of tests/test_torch_dist.py and
tests/test_torch_sharded_*.py, the scenarios they share with them, and
:func:`spawn`, which runs one process group of them.

A spawned child imports its target's module afresh, so this module
imports torch, NumPy and the port only (tests/conftest.py imports jax).
Each rank joins a gloo process group through a file store, runs its
jobs on its own block of the scenario's data, and saves what it computed
to ``rank<r>.npz`` in the output directory (a failure's traceback to
``rank<r>.err``).
"""

import multiprocessing
import os
import time
import traceback

import numpy as np
import torch

import _torch_scenario as scenario

C_0 = 299792458.0

# tests/test_swiftly_dist.py's plan; world size 8 takes its arrays (D 8,
# YB = XA = 128), world size 1 tests/test_swiftly.py's sizes.
SWIFTLY = dict(W=13.5625, N=1024, yN_size=512, xM_size=256)

# tests/test_parallel.py's w-stacking scenario.
WSTACK = dict(subgrid_size=32, theta=0.002, w_step=50.0, shear_u=0.0,
              shear_v=0.0, support=8, oversampling=16 * 1024, w_support=4,
              w_oversampling=16 * 1024, subgrid_frac=2.0 / 3.0,
              w_tower_height=4.0)
IMAGE_SIZE = 128
# A row count that 4 ranks pad (by 2 rows) and 2 ranks do not.
PAD_ROWS = 98


class AxisMesh:
    """A stand-in for a ``DeviceMesh`` of ``size`` ranks along
    ``axis_name`` (this process rank 0, no process group): enough for the
    sharded drivers' argument checks, which run before any collective."""

    def __init__(self, size: int, axis_name: str = "rows",
                 device_type: str = "cpu"):
        self.mesh_dim_names = (axis_name,)
        self.device_type = device_type
        self._size = size

    def size(self, dim: int = 0) -> int:
        return self._size

    def get_local_rank(self, axis_name=None) -> int:
        return 0

    def get_group(self, axis_name=None):
        return None


def facet_from_sources(sources, image_size, facet_size, facet_offset):
    facet = np.zeros(facet_size, complex)
    for intensity, x in sources:
        pos = (x - facet_offset + facet_size // 2) % image_size
        if 0 <= pos < facet_size:
            facet[pos] += intensity
    return facet


def subgrid_from_sources(sources, image_size, subgrid_size, subgrid_offset):
    us = np.arange(subgrid_offset - subgrid_size // 2,
                   subgrid_offset + (subgrid_size + 1) // 2)
    subgrid = np.zeros(subgrid_size, complex)
    for intensity, x in sources:
        subgrid += (intensity / image_size) * np.exp(
            2j * np.pi * us * x / image_size)
    return subgrid


def subgrid2d_from_sources(sources, image_size, subgrid_size, off0, off1):
    u0 = np.arange(off0 - subgrid_size // 2, off0 + subgrid_size // 2)
    u1 = np.arange(off1 - subgrid_size // 2, off1 + subgrid_size // 2)
    sg = np.zeros((subgrid_size, subgrid_size), complex)
    for a, x, y in sources:
        sg += (a / image_size / image_size) * np.exp(
            2j * np.pi * (u0[:, None] * x + u1[None, :] * y) / image_size)
    return sg


def swiftly_case(world):
    """Facets and subgrids (1-D and 2-D) of tests/test_swiftly_dist.py
    for ``world`` ranks: one facet and one subgrid a rank."""
    N, xM = SWIFTLY["N"], SWIFTLY["xM_size"]
    if world == 8:
        yB = xA = 128
        offs = [(d - world // 2) * 128 + 64 for d in range(world)]
        offs2 = [((r - 1) * 256 + 128, (c - 2) * 256 + 128)
                 for r in range(2) for c in range(4)]
    else:
        yB, xA = 416, 228
        offs = [64 * d + 32 for d in range(world)]
        offs2 = [(-8 - 64 * d, 8 + 32 * d) for d in range(world)]
    rng = np.random.default_rng(7)
    sources = [(float(rng.standard_normal()), int(x))
               for x in rng.integers(-N // 2, N // 2 - 1, 12)]
    rng = np.random.default_rng(3)
    sources2 = [(float(rng.standard_normal()), int(x), int(y))
                for x, y in zip(rng.integers(-300, 300, 8),
                                rng.integers(-300, 300, 8))]
    facets2d = np.zeros((world, yB, yB), complex)
    for d, (o0, o1) in enumerate(offs2):
        for a, x, y in sources2:
            p0 = (x - o0 + yB // 2) % N
            p1 = (y - o1 + yB // 2) % N
            if 0 <= p0 < yB and 0 <= p1 < yB:
                facets2d[d, p0, p1] += a
    # One rank, one subgrid: the window's sidelobes from a second point
    # would reach the first, so it takes the first point alone.
    points2 = [(1.0, 40, -30), (0.5, -200, 150)][:1 if world == 1 else 2]
    subgrids2d = np.stack([subgrid2d_from_sources(points2, N, xM, o0, o1)
                           for o0, o1 in offs2])
    if world == 1:
        # One subgrid fills only its usable xA window of the grid: keep
        # that window, scaled by (N / xA)^2, so the reverse chain gives
        # the points' intensities (tests/test_swiftly.py:341-395's 1-D
        # pattern, on both axes).
        lo = xM // 2 - xA // 2
        window = np.zeros_like(subgrids2d)
        window[:, lo:lo + xA, lo:lo + xA] = \
            subgrids2d[:, lo:lo + xA, lo:lo + xA] * (N / xA) ** 2
        subgrids2d = window
    return dict(
        yB=yB, xA=xA, offs=offs, offs2=offs2, sources=sources,
        points2=points2, facets2d=facets2d,
        facets=np.stack([facet_from_sources(sources, N, yB, off)
                         for off in offs]),
        subgrids=np.stack([subgrid_from_sources(sources, N, xM, off)
                           for off in offs]),
        subgrids2d=subgrids2d)


def wstack_case():
    rng = np.random.default_rng(5)
    num_rows, num_chan = 100, 2
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.3 * IMAGE_SIZE / 2 / WSTACK["theta"]
    uvw[:, 2] *= 2.0 * WSTACK["w_step"] * WSTACK["w_tower_height"] / 2
    image = np.zeros((IMAGE_SIZE, IMAGE_SIZE))
    image[IMAGE_SIZE // 3, IMAGE_SIZE // 3] = 1.0
    image[3 * IMAGE_SIZE // 4, IMAGE_SIZE // 2] = 0.5
    vis = (rng.standard_normal((num_rows, num_chan))
           + 1j * rng.standard_normal((num_rows, num_chan)))
    return dict(uvw=uvw, vis=vis, image=image, num_chan=num_chan,
                freq0=C_0, dfreq=C_0 / 100)


def wstack_plan(case):
    from ska_sdp_func_torch.parallel import plan_wstack

    return plan_wstack(case["uvw"], case["freq0"], case["dfreq"],
                       case["num_chan"], IMAGE_SIZE, **WSTACK)


def _swiftly_job(mesh, rank, world):
    from ska_sdp_func_torch.fourier_transforms import Swiftly
    from ska_sdp_func_torch.parallel import SwiftlyDistributed, gather_rows
    from ska_sdp_func_torch.utility.errors import SdpInvalidArgumentError

    c = swiftly_case(world)
    sw = Swiftly(SWIFTLY["N"], SWIFTLY["yN_size"], SWIFTLY["xM_size"],
                 SWIFTLY["W"], device="cpu")
    dsw = SwiftlyDistributed(sw, mesh)
    blk = slice(rank, rank + 1)
    out = {
        "f2s": dsw.facets_to_subgrids(c["facets"][blk], c["offs"],
                                      c["offs"], c["xA"]),
        "s2f": dsw.subgrids_to_facets(c["subgrids"][blk], c["offs"],
                                      c["offs"], c["yB"]),
        "f2s_2d": dsw.facets_to_subgrids_2d(
            torch.as_tensor(c["facets2d"][blk]), c["offs2"], c["offs2"],
            c["xA"]),
        "s2f_2d": dsw.subgrids_to_facets_2d(c["subgrids2d"][blk],
                                            c["offs2"], c["offs2"],
                                            c["yB"]),
    }
    out["f2s_gathered"] = gather_rows(out["f2s"], mesh)
    try:
        dsw.facets_to_subgrids(c["facets"][blk], c["offs"] + [0],
                               c["offs"], c["xA"])
        out["bad_offsets_raise"] = torch.tensor(False)
    except SdpInvalidArgumentError:
        out["bad_offsets_raise"] = torch.tensor(True)
    return {f"swiftly_{k}": v for k, v in out.items()}


def _wstack_job(mesh, rank, world):
    from ska_sdp_func_torch.parallel import (
        gather_rows,
        local_rows,
        pad_rows_arrays,
        row_sharding,
        wstack_degrid_all_sharded,
        wstack_grid_all_sharded,
    )

    c = wstack_case()
    plan = wstack_plan(c)
    out = {"placement": torch.tensor(
        [p.dim for p in row_sharding(mesh)])}
    for tag, rows in (("", c["uvw"].shape[0]), ("pad_", PAD_ROWS)):
        n = rows
        uvw, vis, st, en = pad_rows_arrays(
            torch.as_tensor(c["uvw"][:n]), torch.as_tensor(c["vis"][:n]),
            torch.zeros(n, dtype=torch.int32),
            torch.full((n,), c["num_chan"], dtype=torch.int32), world)
        uvw_l, vis_l, st_l, en_l = local_rows(mesh, uvw, vis, st, en)
        image = wstack_grid_all_sharded(plan, vis_l, uvw_l, mesh,
                                        image_dtype=torch.float64,
                                        start_chs=st_l, end_chs=en_l)
        local = wstack_degrid_all_sharded(
            plan, torch.as_tensor(c["image"], dtype=torch.complex128), uvw_l,
            mesh, start_chs=st_l, end_chs=en_l)
        out[tag + "image"] = image
        out[tag + "local_rows"] = torch.tensor(local.shape[0])
        out[tag + "vis"] = gather_rows(local, mesh, n)
    return {f"wstack_{k}": v for k, v in out.items()}


# -- the sharded packed, bucketed, streaming, ingest and solver drivers --

# The packed gridder's (tag, engine, precision) cases; "bf16" is the bf16
# bands of fast=True.
PACKED_MODES = (("high", "bands", "high"), ("highest", "bands", "highest"),
                ("bf16", "bands", "bf16"), ("fused", "fused", "highest"),
                ("compact", "compact", "highest"))


def packed_options(tag):
    """packed_gridder's keyword arguments of a :data:`PACKED_MODES` tag."""
    _, engine, precision = {m[0]: m for m in PACKED_MODES}[tag]
    return dict(engine=engine, precision=precision, fast=tag == "bf16")
# The first 148 rows of tests/test_packed_driver.py's scenario: 71 blocks
# of 128 slots, so the plans padded for 2 and 4 ranks hold a pad block.
PACKED_ROWS = 148
# Every per-slot tensor a packed gridder can hold.
SLOT_TENSORS = ("sort_index", "valid", "pa", "pb", "ubase", "vband",
                "vband_t", "uk_t", "vk_t", "wk_t")


def packed_case():
    """(uvw, vis, plan) of the packed scenario (port plan)."""
    from ska_sdp_func_torch.parallel import plan_wstack

    uvw, vis = scenario.make_inputs()
    uvw, vis = uvw[:PACKED_ROWS], vis[:PACKED_ROWS]
    plan = plan_wstack(uvw, scenario.FREQ0, scenario.DFREQ,
                       scenario.NUM_CHAN, scenario.IMAGE_SIZE,
                       **scenario.PARAMS)
    return uvw, vis, plan


def packed_plan(world):
    from ska_sdp_func_torch.parallel import plan_packed

    uvw, vis, plan = packed_case()
    return plan_packed(plan, uvw, block_v=128, pad_blocks_to=world)


def slot_sizes(gridder):
    """The element counts of a gridder's per-slot tensors (0 where it
    holds none; a bf16 hi/lo pair counts both halves), in
    :data:`SLOT_TENSORS` order."""
    def numel(x):
        if x is None:
            return 0
        return sum(t.numel() for t in x) if isinstance(x, tuple) \
            else x.numel()

    return torch.tensor([numel(getattr(gridder.slots, name))
                         for name in SLOT_TENSORS])


def _packed_job(mesh, rank, world):
    from ska_sdp_func_torch.parallel import (
        degrid_all_packed_sharded,
        gather_rows,
        grid_all_packed_sharded,
        packed_gridder,
    )

    _, vis, _ = packed_case()
    pplan = packed_plan(world)
    model = scenario.two_point_image()
    out = {}
    for tag, _, _ in PACKED_MODES:
        g = packed_gridder(pplan, device="cpu", **packed_options(tag))
        vre, vim = g.sort_sharded(vis, mesh)
        out[tag + "_image"] = g.grid_sorted_sharded(vre, vim, mesh)
        out[tag + "_natural_image"] = g.grid_sharded(vis, mesh)
        local = g.degrid_sorted_sharded(model, mesh)
        out[tag + "_sorted"] = gather_rows(local, mesh)
        out[tag + "_vis"] = g.degrid_sharded(model, mesh)
        out[tag + "_slots"] = slot_sizes(g._shard(world, rank))
        out[tag + "_local_slots"] = torch.tensor(local.shape[0])
        # The gridder drove only its shard: its own tensors stay unbuilt.
        out[tag + "_parent_built"] = torch.tensor("slots" in vars(g))
    out["fn_image"] = grid_all_packed_sharded(pplan, vis, mesh, device="cpu")
    out["fn_vis"] = degrid_all_packed_sharded(pplan, model, mesh,
                                              device="cpu")
    return {f"packed_{k}": v for k, v in out.items()}


# The bucketed grid's block size: tests/test_bucketed.py's 128 divides the
# ranks' 1024-slot chunk quantum, and with it no task would straddle two
# ranks' chunks.
BUCKET_BLOCK = 96


def bucketed_case():
    """tests/test_bucketed.py's scenario: (uvw f32, vis, plan, bplan,
    sort_index, valid) at block_v :data:`BUCKET_BLOCK` (port plans)."""
    from ska_sdp_func_torch.parallel import plan_bucketed

    c = wstack_case()
    plan = wstack_plan(c)
    bplan, sort_index, valid = plan_bucketed(plan, c["uvw"],
                                             block_v=BUCKET_BLOCK)
    return (c["uvw"].astype(np.float32), c["vis"].astype(np.complex64),
            plan, bplan, sort_index, valid)


def _bucketed_job(mesh, rank, world):
    from ska_sdp_func_torch.parallel import grid_all_bucketed_sharded

    uvw, vis, _, bplan, sort_index, valid = bucketed_case()
    return {"bucketed_image": grid_all_bucketed_sharded(
        bplan, vis, uvw, sort_index, valid, mesh, device="cpu")}


# tests/test_streaming.py's scenario (the packed scenario's 150 rows):
# chunks of 64 rows at 4 x 20480 slots, the packable branch at block_v
# 128 and the non-packable one at block_v 64; the chunks cover rows
# 0-63, 64-127 and the short 128-149.
STREAM_CHUNKS = ((0, 64), (64, 128), (128, 150))


def stream_case():
    """(uvw, vis, plan, boxes, {branch: StreamPlan}) (port plans)."""
    from ska_sdp_func_torch.parallel import (
        plan_stream,
        plan_wstack,
        stream_tasks,
    )

    uvw, vis = scenario.make_inputs()
    plan = plan_wstack(uvw, scenario.FREQ0, scenario.DFREQ,
                       scenario.NUM_CHAN, scenario.IMAGE_SIZE,
                       **scenario.PARAMS)
    boxes = stream_tasks(plan, uvw)
    plans = {branch: plan_stream(plan, boxes, chunk_rows=64, block_v=bv,
                                 cap_slots=4 * 20480)
             for branch, bv in (("packable", 128), ("split", 64))}
    return uvw, vis, plan, boxes, plans


def _block(x, lo, hi, rank, size):
    """A rank's block of the chunk ``x[lo:hi]`` of ``(hi - lo)`` rows of a
    chunk of 64 (fewer, or none, in a short chunk)."""
    b = 64 // size
    return x[lo + min(rank * b, hi - lo):lo + min((rank + 1) * b, hi - lo)]


def _stream_run(mesh, sp, uvw, vis, axis_name="rows"):
    from ska_sdp_func_torch.parallel import (
        StreamingDegridder,
        StreamingGridder,
        gather_rows,
    )
    from ska_sdp_func_torch.parallel.mesh import mesh_axis

    size, rank, _ = mesh_axis(mesh, axis_name)
    sg = StreamingGridder(sp, mesh=mesh, axis_name=axis_name, device="cpu")
    for lo, hi in STREAM_CHUNKS:
        sg.accumulate(_block(uvw, lo, hi, rank, size),
                      _block(vis, lo, hi, rank, size))
    out = {"image": sg.finalize(),
           "counters": torch.stack(list(sg.counters()))}
    sd = StreamingDegridder(sp, mesh=mesh, axis_name=axis_name,
                            device="cpu").set_model(scenario.two_point_image())
    local = sd.predict(_block(uvw, 0, 64, rank, size))
    sd.check()
    out["predict"] = gather_rows(local, mesh, axis_name=axis_name)
    return out


def _streaming_job(mesh, rank, world):
    from ska_sdp_func_torch.parallel import StreamingGridder, plan_stream
    from ska_sdp_func_torch.utility.errors import SdpRuntimeError

    uvw, vis, plan, boxes, plans = stream_case()
    out = {}
    for branch, sp in plans.items():
        out.update({f"{branch}_{k}": v for k, v in
                    _stream_run(mesh, sp, uvw, vis).items()})
    # A chunk only rank 0 holds overflows its 1024 slots: every rank voids
    # it together.
    tiny = plan_stream(plan, boxes, chunk_rows=64, block_v=128,
                       cap_slots=world * 1024)
    sg = StreamingGridder(tiny, mesh=mesh, device="cpu")
    b = 64 // world
    sg.accumulate(_block(uvw, 0, b, rank, world),
                  _block(vis, 0, b, rank, world))
    out["void_image"] = sg.finalize(check=False)
    out["void_counters"] = torch.stack(list(sg.counters()))
    try:
        sg.finalize()
        out["void_raises"] = torch.tensor(False)
    except SdpRuntimeError:
        out["void_raises"] = torch.tensor(True)
    return {f"stream_{k}": v for k, v in out.items()}


def _streaming2d_job(mesh, rank, world):
    from torch.distributed.device_mesh import init_device_mesh

    uvw, vis, _, _, plans = stream_case()
    mesh2 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("rows", "cols"))
    out = _stream_run(mesh2, plans["packable"], uvw, vis)
    return {f"stream2d_{k}": v for k, v in out.items()}


def ingest_case():
    """tests/test_pipeline.py:375's stream: 8 x 21 x 16 x 2 samples (21
    baselines: 8 ranks pad them), broadband RFI at one (time,
    baseline)."""
    rng = np.random.default_rng(3)
    t, b, c, p = 8, 21, 16, 2
    vis4d = (rng.standard_normal((t, b, c, p))
             + 1j * rng.standard_normal((t, b, c, p)))
    vis4d[2, 5, :, 0] += 180.0
    return vis4d, np.ones(vis4d.shape)


def _ingest_job(mesh, rank, world):
    from ska_sdp_func_torch.parallel import gather_rows
    from ska_sdp_func_torch.pipeline import ingest_flag_and_weight_sharded

    vis4d, w4d = ingest_case()
    b = vis4d.shape[1]
    flags, w, frac = ingest_flag_and_weight_sharded(vis4d, w4d, mesh,
                                                    device="cpu")

    def whole(x):
        return gather_rows(x.transpose(0, 1), mesh, b).transpose(0, 1)

    return {"ingest_flags": whole(flags), "ingest_weights": whole(w),
            "ingest_frac": frac, "ingest_local": torch.tensor(flags.shape)}


def solver_case():
    """The packed solve's scenario: the packed scenario's 148 rows, the
    visibilities of tests/test_torch_major_cycle.py's one-source sky
    (the port's packed degrid on the unpadded plan), weights from seed
    8 (port plan)."""
    from ska_sdp_func_torch.parallel import packed_gridder, plan_packed

    uvw, _, plan = packed_case()
    img = np.zeros((scenario.IMAGE_SIZE, scenario.IMAGE_SIZE), np.float32)
    img[scenario.IMAGE_SIZE // 2 + 12, scenario.IMAGE_SIZE // 2 - 9] = 1.0
    vis = packed_gridder(plan_packed(plan, uvw), device="cpu").degrid(
        img).numpy()
    weights = np.random.default_rng(8).uniform(0.5, 1.5, vis.shape)
    return uvw, vis, weights, plan


SOLVE = dict(n_major=1, bucketed=True, cycle_limit=50)
TASK_SOLVE = dict(n_major=1, cycle_limit=20)
FISTA = dict(n_iter=4, lam_frac=2e-3)


def _fista_job(mesh, rank, world):
    from ska_sdp_func_torch.pipeline import fista_imager

    uvw, vis, _, plan = solver_case()
    res = fista_imager(plan, vis, uvw, mesh=mesh, device="cpu", **FISTA)
    return {"fista_model": res.model,
            "fista_history": torch.tensor(res.residual_norm)}


def _packed_solve_job(mesh, rank, world):
    from ska_sdp_func_torch.pipeline import major_cycle_imager

    uvw, vis, weights, plan = solver_case()
    res = major_cycle_imager(plan, vis, uvw, weights=weights, mesh=mesh,
                             device="cpu", **SOLVE)
    return {"solve_packed_model": res.model,
            "solve_packed_residual": res.residual,
            "solve_packed_history": torch.tensor(res.peak_history)}


def _task_solve_job(mesh, rank, world):
    from ska_sdp_func_torch.pipeline import dirty_and_psf, major_cycle_imager

    c = wstack_case()
    plan = wstack_plan(c)
    vis, uvw = c["vis"][:PAD_ROWS], c["uvw"][:PAD_ROWS]
    res = major_cycle_imager(plan, vis, uvw, mesh=mesh, device="cpu",
                             **TASK_SOLVE)
    dirty, psf = dirty_and_psf(plan, vis, uvw, mesh=mesh, device="cpu")
    return {"solve_tasks_model": res.model,
            "solve_tasks_residual": res.residual, "solve_dirty": dirty,
            "solve_psf": psf}


def _checkpoint_job(mesh, rank, world, out_dir):
    from ska_sdp_func_torch.pipeline import SolverCheckpointer

    ck = SolverCheckpointer(os.path.join(out_dir, "ckpt"), max_to_keep=2,
                            device="cpu")
    base = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    for step in (1, 2, 3):
        # Every rank saves the same state but its own rank in the meta:
        # only rank 0's write lands.
        ck.save(step, base * step, -base * step, [float(step)],
                meta={"rank": rank})
    model, residual, cycle, history, meta = ck.restore()
    return {"ckpt_steps": torch.tensor(ck.steps()), "ckpt_model": model,
            "ckpt_residual": residual, "ckpt_cycle": torch.tensor(cycle),
            "ckpt_meta_rank": torch.tensor(meta["rank"])}


JOBS = {"swiftly": _swiftly_job, "wstack": _wstack_job,
        "packed": _packed_job, "bucketed": _bucketed_job,
        "streaming": _streaming_job, "streaming2d": _streaming2d_job,
        "ingest": _ingest_job, "packed_solve": _packed_solve_job,
        "task_solve": _task_solve_job, "fista": _fista_job}


def run(rank: int, world: int, store: str, out_dir: str, jobs) -> None:
    """One rank: a gloo group of ``world`` ranks through the file store
    ``store`` (60 s for each collective), then ``jobs`` in order."""
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from ska_sdp_func_torch.parallel import make_mesh

        mesh = make_mesh(world, device="cpu", rank=rank,
                         init_method="file://" + store, timeout=60.0)
        try:
            results = {}
            for job in jobs:
                if job == "checkpoint":
                    results.update(_checkpoint_job(mesh, rank, world,
                                                   out_dir))
                else:
                    results.update(JOBS[job](mesh, rank, world))
        finally:
            dist.destroy_process_group()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: v.numpy() for k, v in results.items()})
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class Groups:
    """Process groups of ``{world: jobs}`` under the directory ``out`` (a
    ``pathlib.Path``), all started at once (spawned, one thread a rank),
    so a test can compute its references while they run.
    :meth:`results` joins one group; a group's ranks still running
    ``limit`` seconds after the start are ended."""

    def __init__(self, out, jobs_by_world, limit: float):
        ctx = multiprocessing.get_context("spawn")
        self.limit = limit
        self.deadline = time.monotonic() + limit
        self.procs, self.dirs, self.done = {}, {}, {}
        for world, jobs in jobs_by_world.items():
            d = out / f"world{world}"
            d.mkdir(parents=True, exist_ok=True)
            self.dirs[world] = d
            self.procs[world] = [
                ctx.Process(target=run, args=(rank, world, str(d / "store"),
                                              str(d), tuple(jobs)),
                            daemon=True)
                for rank in range(world)]
            for p in self.procs[world]:
                p.start()

    def results(self, world: int):
        """Every rank's results of the group of ``world`` ranks, in rank
        order; a hung rank, a rank's traceback or a non-zero exit raises
        ``RuntimeError`` with the tracebacks."""
        if world not in self.done:
            self.done[world] = self._join(world)
        return self.done[world]

    def _join(self, world):
        procs, out = self.procs[world], self.dirs[world]
        for p in procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        _end(procs)
        errors = [(out / f"rank{r}.err").read_text() for r in range(world)
                  if (out / f"rank{r}.err").exists()]
        codes = [p.exitcode for p in procs]
        if hung or errors or any(codes):
            raise RuntimeError(
                f"world {world}: ranks {hung} still running after "
                f"{self.limit} s, exit codes {codes}\n" + "\n".join(errors))
        return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]

    def close(self):
        """End every rank still running."""
        for procs in self.procs.values():
            _end(procs)


def _end(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)


def spawn(out, world: int, jobs, limit: float):
    """Run ``jobs`` in one process group of ``world`` ranks
    (:class:`Groups`) and return every rank's results."""
    groups = Groups(out, {world: jobs}, limit)
    try:
        return groups.results(world)
    finally:
        groups.close()
