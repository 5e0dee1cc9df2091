"""W-stacking task plan and the single-device task drivers.

Counterpart of ska_sdp_func_tpu.parallel.wstack (wstack.py:55-294;
reference sdp_grid_wstack_wtower.cpp:24-165, 310-330):

1. **Plan** (host, once per uvw distribution): enumerate the non-empty
   (w-plane, sub-grid) boxes and their static w-tower plane ranges.
2. **Execute** (device): :func:`grid_all_tasks` / :func:`degrid_all_tasks`
   run the static task list over all visibilities; per-task channel
   clamping selects the rows and channels in each box, as the reference
   routes rows to tasks, and each task runs the per-plane w-towers
   drivers (the ``grid_plane`` / ``degrid_plane`` kernels on complex64
   CUDA data). Every task streams every visibility: O(tasks x V). The
   drivers run on ``device`` (``None``: the CUDA card; CPU runs pass
   ``device="cpu"``) and move their inputs there.

3. **Shard** (:func:`wstack_grid_all_sharded`,
   :func:`wstack_degrid_all_sharded`): each rank of a process mesh
   (:func:`.mesh.make_mesh`) runs the task drivers on its own block of
   rows; the grid sums the ranks' images with one ``all_reduce``, the
   degrid needs no collective and returns the rank's rows
   (:func:`.mesh.gather_rows` puts them back in order).
"""

import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..fourier_transforms.fft import fft_shifted, ifft_shifted_norm
from ..grid_data.clamp_channels import (
    clamp_channels_single,
    clamp_channels_uv,
)
from ..grid_data.gridder_utils import (
    subgrid_add_static,
    subgrid_cut_out_static,
)
from ..grid_data.wtower import (
    GridderWtowerUVW,
    _degrid_all_planes,
    _grid_all_planes,
)
from ..utility.profiling import annotated
from ..utility.tensors import host_uvw, resolve_device, to_device
from .mesh import ROW_AXIS, mesh_device

_KERNEL_CACHE: dict = {}


@dataclass(frozen=True)
class WStackTask:
    """One static (w-plane, sub-grid) box (the reference's
    sdp_SubgridTask, sdp_grid_wstack_wtower.cpp:24-38) with its w-tower
    plane range resolved at plan time."""

    iu: int
    iv: int
    iw: int
    first_w_plane: int  # relative to the tower's w offset
    num_planes: int


@dataclass(frozen=True)
class WStackPlan:
    """Static geometry for a w-stacking grid/degrid pass."""

    image_size: int
    subgrid_size: int
    theta: float
    w_step: float
    shear_u: float
    shear_v: float
    support: int
    oversampling: int
    w_support: int
    w_oversampling: int
    subgrid_frac: float
    w_tower_height: float
    freq0_hz: float
    dfreq_hz: float
    num_chan: int
    eff_sg_size: int
    w_plane_ids: Tuple[int, ...]
    tasks: Tuple[WStackTask, ...] = field(default=())

    @property
    def eff_sg_dist(self) -> float:
        return self.eff_sg_size / self.theta

    @property
    def w_stack_dist(self) -> float:
        return self.w_tower_height * self.w_step

    def kernel(self) -> GridderWtowerUVW:
        """Gridder plan for this geometry, cached by value so repeated
        calls share one kernel object."""
        key = (self.image_size, self.subgrid_size, self.theta,
               self.w_step, self.shear_u, self.shear_v, self.support,
               self.oversampling, self.w_support, self.w_oversampling)
        kern = _KERNEL_CACHE.get(key)
        if kern is None:
            kern = GridderWtowerUVW(*key)
            _KERNEL_CACHE[key] = kern
        return kern


@annotated("plan.wstack")
def plan_wstack(uvw, freq0_hz: float, dfreq_hz: float, num_chan: int,
                image_size: int, subgrid_size: int, theta: float,
                w_step: float, shear_u: float = 0.0, shear_v: float = 0.0,
                support: int = 8, oversampling: int = 16384,
                w_support: int = 4, w_oversampling: int = 16384,
                subgrid_frac: float = 2.0 / 3.0,
                w_tower_height: float = 4.0) -> WStackPlan:
    """Build the static task list from the full uvw distribution.

    ``uvw`` is a NumPy array or a tensor [rows, 3] on any device; all
    planning is host f64 through :mod:`..native`.
    """
    uvw_np = host_uvw(uvw)
    num_rows = uvw_np.shape[0]
    if subgrid_frac == 0.0:
        subgrid_frac = 2.0 / 3.0
    if dfreq_hz == 0.0:
        dfreq_hz = 10.0
    eff_sg_size = int(math.floor(subgrid_size * subgrid_frac))
    eff_sg_dist = eff_sg_size / theta
    w_stack_dist = w_tower_height * w_step

    start_ch = np.zeros((num_rows,), np.int32)
    end_ch = np.full((num_rows,), num_chan, np.int32)
    uvw_min, uvw_max = native.uvw_bounds(uvw_np, freq0_hz, dfreq_hz,
                                         start_ch, end_ch)
    eta = 1e-5
    min_iu = int(math.floor(uvw_min[0] / eff_sg_dist + 0.5 - eta))
    max_iu = int(math.floor(uvw_max[0] / eff_sg_dist + 0.5 + eta))
    min_iv = int(math.floor(uvw_min[1] / eff_sg_dist + 0.5 - eta))
    max_iv = int(math.floor(uvw_max[1] / eff_sg_dist + 0.5 + eta))
    min_iw = int(math.floor(uvw_min[2] / w_stack_dist + 0.5 - eta))
    max_iw = int(math.floor(uvw_max[2] / w_stack_dist + 0.5 + eta))

    counts, wmin, wmax = native.plan_wstack_boxes(
        uvw_np, freq0_hz, dfreq_hz, num_chan, eff_sg_dist, w_stack_dist,
        (min_iu, max_iu), (min_iv, max_iv), (min_iw, max_iw))

    tasks = []
    w_plane_ids = []
    for jw in range(counts.shape[0]):
        iw = min_iw + jw
        plane_has_tasks = False
        for ju in range(counts.shape[1]):
            for jv in range(counts.shape[2]):
                if counts[jw, ju, jv] == 0:
                    continue
                # W-tower plane range from the global data bounds
                # (sdp_gridder_wtower_uvw.cpp:780-800).
                off_w = int(iw * w_tower_height)
                first = int(np.floor(wmin[jw, ju, jv] / w_step - eta)) \
                    - off_w
                last = int(np.ceil(wmax[jw, ju, jv] / w_step + eta)) \
                    - off_w + 1
                tasks.append(WStackTask(min_iu + ju, min_iv + jv, iw,
                                        first, 1 + last - first))
                plane_has_tasks = True
        if plane_has_tasks:
            w_plane_ids.append(iw)

    return WStackPlan(
        image_size=int(image_size), subgrid_size=int(subgrid_size),
        theta=float(theta), w_step=float(w_step), shear_u=float(shear_u),
        shear_v=float(shear_v), support=int(support),
        oversampling=int(oversampling), w_support=int(w_support),
        w_oversampling=int(w_oversampling), subgrid_frac=float(subgrid_frac),
        w_tower_height=float(w_tower_height), freq0_hz=float(freq0_hz),
        dfreq_hz=float(dfreq_hz), num_chan=int(num_chan),
        eff_sg_size=eff_sg_size, w_plane_ids=tuple(w_plane_ids),
        tasks=tuple(tasks))


# ---------------------------------------------------------------------------
# Single-device task drivers
# ---------------------------------------------------------------------------

def _box_bounds(plan: WStackPlan, task: WStackTask):
    d = plan.eff_sg_dist
    return (task.iu * d - d / 2, (task.iu + 1) * d - d / 2,
            task.iv * d - d / 2, (task.iv + 1) * d - d / 2)


def _wslab_bounds(plan: WStackPlan, iw: int):
    d = plan.w_stack_dist
    return iw * d - d / 2, (iw + 1) * d - d / 2


def _task_offsets(plan: WStackPlan, task: WStackTask):
    return (task.iu * plan.eff_sg_size, task.iv * plan.eff_sg_size,
            int(task.iw * plan.w_tower_height))


def _plane_tasks(plan: WStackPlan, uvw, start_chs, end_chs):
    """Per w-plane, each task with its clamped channel ranges."""
    for iw in plan.w_plane_ids:
        min_w, max_w = _wslab_bounds(plan, iw)
        s_w, e_w = clamp_channels_single(
            uvw, 2, plan.freq0_hz, plan.dfreq_hz, start_chs, end_chs,
            min_w, max_w)
        tasks = []
        for task in plan.tasks:
            if task.iw != iw:
                continue
            s_uv, e_uv = clamp_channels_uv(
                uvw, plan.freq0_hz, plan.dfreq_hz, s_w, e_w,
                *_box_bounds(plan, task))
            tasks.append((task, s_uv, e_uv))
        yield iw, tasks


def grid_all_tasks(plan: WStackPlan, kernel: GridderWtowerUVW, vis, uvw,
                   start_chs, end_chs, device=None) -> torch.Tensor:
    """Grid all visibilities over the static task list into a complex
    image of ``vis``'s dtype, on ``device``."""
    image_size = plan.image_size
    dev = resolve_device(device)
    vis, uvw, start_chs, end_chs = (
        to_device(x, dev) for x in (vis, uvw, start_chs, end_chs))
    sg_factor = (image_size / plan.subgrid_size) ** 2
    uv_kernel, w_kernel, w_pattern = kernel.tables(vis.dtype, dev)
    image = torch.zeros((image_size, image_size), dtype=vis.dtype,
                        device=dev)
    for iw, tasks in _plane_tasks(plan, uvw, start_chs, end_chs):
        grid = torch.zeros((image_size, image_size), dtype=vis.dtype,
                           device=dev)
        for task, s_uv, e_uv in tasks:
            off = _task_offsets(plan, task)
            subgrid = _grid_all_planes(
                vis, w_pattern, uv_kernel, w_kernel, uvw, s_uv, e_uv,
                torch.zeros((plan.subgrid_size, plan.subgrid_size),
                            dtype=vis.dtype, device=dev),
                *off, task.first_w_plane, plan.freq0_hz, plan.dfreq_hz,
                task.num_planes, plan.theta, plan.w_step, plan.support,
                plan.oversampling, plan.w_support, plan.w_oversampling,
                plan.subgrid_size, 0, uvw.shape[0])
            subgrid_add_static(grid, -off[0], -off[1],
                               fft_shifted(subgrid), sg_factor)
        grid = kernel.grid_correct(ifft_shifted_norm(grid), 0, 0,
                                   int(iw * plan.w_tower_height), device=dev)
        image = image + grid.to(image.dtype)
    return image


def degrid_all_tasks(plan: WStackPlan, kernel: GridderWtowerUVW, image, uvw,
                     start_chs, end_chs, vis_dtype=torch.complex128,
                     device=None) -> torch.Tensor:
    """Degrid an image over the static task list into
    ``[rows, num_chan]`` visibilities of ``vis_dtype``, on ``device``."""
    dev = resolve_device(device)
    image, uvw, start_chs, end_chs = (
        to_device(x, dev) for x in (image, uvw, start_chs, end_chs))
    vis = torch.zeros((uvw.shape[0], plan.num_chan), dtype=vis_dtype,
                      device=dev)
    uv_kernel, w_kernel, w_pattern = kernel.tables(vis_dtype, dev)
    w_pattern = w_pattern.to(vis_dtype)
    for iw, tasks in _plane_tasks(plan, uvw, start_chs, end_chs):
        grid = fft_shifted(kernel.degrid_correct(
            image.to(vis_dtype), 0, 0, int(iw * plan.w_tower_height),
            device=dev))
        for task, s_uv, e_uv in tasks:
            off = _task_offsets(plan, task)
            subgrid = ifft_shifted_norm(subgrid_cut_out_static(
                grid, off[0], off[1], plan.subgrid_size))
            vis = _degrid_all_planes(
                subgrid.to(vis_dtype), w_pattern, uv_kernel, w_kernel, uvw,
                s_uv, e_uv, vis, *off, task.first_w_plane, plan.freq0_hz,
                plan.dfreq_hz, task.num_planes, plan.theta, plan.w_step,
                plan.support, plan.oversampling, plan.w_support,
                plan.w_oversampling, plan.subgrid_size, 0, uvw.shape[0])
    return vis


# ---------------------------------------------------------------------------
# Mesh-sharded drivers
# ---------------------------------------------------------------------------

def kernel_geometry_key(kernel: GridderWtowerUVW) -> tuple:
    """The values that define a gridder kernel plan (JAX wstack.py:309),
    as a cache key: a cache keyed on ``id(kernel)`` can hand a new
    kernel whose id was recycled the tables of a collected one."""
    return (kernel.image_size, kernel.subgrid_size, kernel.theta,
            kernel.w_step, kernel.shear_u, kernel.shear_v,
            kernel.support, kernel.oversampling, kernel.w_support,
            kernel.w_oversampling)


def _local_channels(plan: WStackPlan, num_rows: int, start_chs, end_chs,
                    device):
    """A rank's channel ranges: the caller's, or every channel."""
    if start_chs is None:
        start_chs = torch.zeros((num_rows,), dtype=torch.int32,
                                device=device)
    if end_chs is None:
        end_chs = torch.full((num_rows,), plan.num_chan, dtype=torch.int32,
                             device=device)
    return start_chs, end_chs


def wstack_grid_all_sharded(plan: WStackPlan, vis, uvw, mesh,
                            kernel: GridderWtowerUVW = None,
                            axis_name: str = ROW_AXIS, image_dtype=None,
                            start_chs=None,
                            end_chs=None) -> torch.Tensor:
    """Grid the mesh's visibilities into one image, on every rank.

    ``vis`` ``[rows, num_chan]`` and ``uvw`` ``[rows, 3]`` are this rank's
    block of rows (the rank's :func:`.mesh.local_rows` of the arrays
    :func:`.mesh.pad_rows_arrays` padded), with its channel ranges
    (``None``: every channel; pad rows have ``end_ch = 0``). Each rank
    grids its rows through the static task list on its device
    (:func:`.mesh.mesh_device`) and one ``all_reduce`` sums the images:
    the single-device :func:`grid_all_tasks` over all rows, up to the
    order of the sum. Returns the image as ``image_dtype`` (``None``:
    ``vis``'s dtype; a real dtype takes the real part)."""
    if kernel is None:
        kernel = plan.kernel()
    dev = mesh_device(mesh)
    vis, uvw = to_device(vis, dev), to_device(uvw, dev)
    start_chs, end_chs = _local_channels(plan, uvw.shape[0], start_chs,
                                         end_chs, dev)
    image = grid_all_tasks(plan, kernel, vis, uvw, start_chs, end_chs,
                           device=dev)
    dist.all_reduce(torch.view_as_real(image),
                    group=mesh.get_group(axis_name))
    image_dtype = vis.dtype if image_dtype is None else image_dtype
    if not image_dtype.is_complex:
        image = image.real
    return image.to(image_dtype)


def wstack_degrid_all_sharded(plan: WStackPlan, image, uvw, mesh,
                              kernel: GridderWtowerUVW = None,
                              axis_name: str = ROW_AXIS,
                              vis_dtype=torch.complex128, start_chs=None,
                              end_chs=None) -> torch.Tensor:
    """Degrid a replicated image into this rank's visibilities
    ``[rows, num_chan]``: ``uvw`` and the channel ranges as in
    :func:`wstack_grid_all_sharded`. The forward operator is
    row-separable, so no collective runs; :func:`.mesh.gather_rows`
    collects the ranks' rows in order."""
    if kernel is None:
        kernel = plan.kernel()
    dev = mesh_device(mesh)
    uvw = to_device(uvw, dev)
    start_chs, end_chs = _local_channels(plan, uvw.shape[0], start_chs,
                                         end_chs, dev)
    return degrid_all_tasks(plan, kernel, image, uvw, start_chs, end_chs,
                            vis_dtype, device=dev)
