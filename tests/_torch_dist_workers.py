"""Worker processes of tests/test_torch_dist.py, and the scenarios they
share with it.

A spawned child imports its target's module afresh, so this module
imports torch, NumPy and the port only (tests/conftest.py imports jax).
Each rank joins a gloo process group through a file store, runs its
jobs on its own block of the scenario's data, and saves what it computed
to ``rank<r>.npz`` in the output directory (a failure's traceback to
``rank<r>.err``).
"""

import os
import traceback

import numpy as np
import torch

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


JOBS = {"swiftly": _swiftly_job, "wstack": _wstack_job}


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
                results.update(JOBS[job](mesh, rank, world))
        finally:
            dist.destroy_process_group()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: v.numpy() for k, v in results.items()})
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
