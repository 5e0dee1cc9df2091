"""End-to-end imaging demo: simulate -> plan -> solve -> restore, over a
process mesh (examples/imaging_demo.py on the port).

The counterpart of the reference's CLEAN integration pipeline
(tests/clean/test_hogbom_clean.py:18-140: DFT predict -> gridder ->
dirty image -> CLEAN), with the gridding and the solve sharded over the
ranks of a process mesh: the task drivers (complex64 on the card: the
per-plane kernels K14/K15) on each rank's block of rows, the images
summed over the ranks.

    python -m ska_sdp_func_torch.examples.imaging_demo
    torchrun --nproc-per-node N -m ska_sdp_func_torch.examples.imaging_demo

Without ``WORLD_SIZE`` in the environment it starts a one-rank group
(NCCL on the card, gloo on the CPU) at a file store in a temporary
directory; under ``torchrun`` each rank takes its own card and every
rank gets the same result. It destroys the group it started (a group
already started is used and left). Rank 0 saves the result with
``save_result``.

The oracle: each source's recovered flux (the model summed over 5 x 5
pixels about it) within ``FLUX_TOL`` of the sky's.
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..grid_data import dft, image_to_flmn
from ..parallel import make_mesh, plan_wstack
from ..parallel.mesh import mesh_device
from ..pipeline import major_cycle_imager, save_result
from ..utility.constants import C_0
from . import _device, _finish, _flux_errors, _oracle

# (row, column) offsets from the image centre and fluxes.
SOURCES = ((12, -9, 1.0), (-20, 15, 0.4), (30, 28, 0.2))
FLUX_TOL = 0.05
RESULT_FILE = "ska_sdp_func_torch_demo_result.npz"


def _mesh(dev):
    """(mesh, whether this call started the process group, the temporary
    store to remove or None): the ranks of ``torchrun`` (``WORLD_SIZE``
    set), or of a group already started, else a one-rank group at a file
    store of its own."""
    started = not dist.is_initialized()
    if "WORLD_SIZE" in os.environ or not started:
        return (make_mesh(device=None if dev.type == "cuda" else dev),
                started, None)
    store = tempfile.mkdtemp(prefix="ska_sdp_func_torch_demo_")
    return (make_mesh(1, device=dev, rank=0,
                      init_method="file://" + os.path.join(store, "pg")),
            True, store)


def _solve(mesh, image_size, num_rows, num_chan, n_major, seed):
    """The script's simulation and solve on the mesh's device: (result,
    plan, sources)."""
    dev = mesh_device(mesh)
    rng = np.random.default_rng(seed)
    theta = 0.002
    c = image_size // 2
    sources = tuple((c + di, c + dj, f) for (di, dj, f) in SOURCES)

    # Sky: three point sources.
    sky = np.zeros((image_size, image_size))
    for (i, j, f) in sources:
        sky[i, j] = f

    # Array: random snapshot uvw coverage.
    uvw = rng.uniform(-1, 1, (num_rows, 3))
    uvw[:, :2] *= 0.3 * image_size / 2 / theta
    uvw[:, 2] *= 300.0
    freq0, dfreq = C_0, C_0 / 100

    # Exact visibilities (the accuracy oracle), complex64: the kernels'
    # precision on the card.
    flux, lmn = image_to_flmn(sky, theta)
    vis = dft(uvw, flux.astype(complex), lmn, freq0_hz=freq0,
              dfreq_hz=dfreq, num_chan=num_chan,
              device=dev).to(torch.complex64)

    # Static task plan (native host runtime).
    plan = plan_wstack(uvw, freq0, dfreq, num_chan, image_size,
                       subgrid_size=32, theta=theta, w_step=50.0,
                       support=8, oversampling=16384, w_support=4,
                       w_oversampling=16384, w_tower_height=4.0)
    result = major_cycle_imager(plan, vis, uvw, n_major=n_major,
                                loop_gain=0.2, threshold=1e-3,
                                cycle_limit=300, mesh=mesh)
    return result, plan, sources


def run(device=None, image_size: int = 128, num_rows: int = 600,
        num_chan: int = 2, n_major: int = 5, seed: int = 1,
        result_path: str = None) -> dict:
    """The demo on ``device`` (under ``torchrun``, each rank's card);
    returns the mesh's size, the plan's numbers, the residual peak of
    each major cycle, the recovered fluxes, the result's path and the
    oracle's check. ``result_path`` (None: the file ``RESULT_FILE`` in
    the temporary directory) is where rank 0 saves the result."""
    dev = _device(device)
    if result_path is None:
        result_path = os.path.join(tempfile.gettempdir(), RESULT_FILE)
    mesh, started, store = _mesh(dev)
    try:
        result, plan, sources = _solve(mesh, image_size, num_rows,
                                       num_chan, n_major, seed)
        size, rank = dist.get_world_size(), dist.get_rank()
    finally:
        if started:
            dist.destroy_process_group()
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)
    if rank == 0:
        save_result(result_path, result)
    model = result.model
    fluxes = [float(model[i - 2:i + 3, j - 2:j + 3].sum())
              for (i, j, _) in sources]
    return dict(
        devices=size, rank=rank, tasks=len(plan.tasks),
        w_planes=tuple(plan.w_plane_ids),
        peak_history=[float(p) for p in result.peak_history],
        sources=sources, fluxes=fluxes, result_path=result_path,
        oracle=_oracle(("largest recovered flux error, of each source's",
                        _flux_errors(fluxes, [f for *_, f in sources]),
                        FLUX_TOL)))


def main(device=None, **sizes) -> int:
    r = run(device, **sizes)
    print(f"devices: {r['devices']}, tasks: {r['tasks']}, "
          f"w-planes: {r['w_planes']}")
    print("residual peak per major cycle:",
          [f"{p:.4f}" for p in r["peak_history"]])
    print("recovered fluxes:", *r["fluxes"])
    if r["rank"] == 0:
        print(f"saved {r['result_path']}")
    return _finish(r)


if __name__ == "__main__":
    sys.exit(main())
