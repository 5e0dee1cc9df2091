"""Bucketed w-stacking drivers: sort visibilities by task, grid slices.

Counterpart of ska_sdp_func_tpu.parallel.bucketed for one device
(bucketed.py:37-333). The task drivers in :mod:`.wstack` stream every
visibility through every (w-plane, sub-grid) task: O(tasks x V). Every
(row, channel) visibility belongs to exactly one task box (the boxes
tile (u, v, w) space), so a host bucket sort (:func:`plan_bucketed`,
the same NumPy arithmetic as the JAX package, so its arrays are
identical) makes each task's visibilities one contiguous slice, and a
whole pass is O(V): per task one launch of the all-layer kernels
(:func:`~..kernels.tower_tap.grid_all_layers`,
:func:`~..kernels.tower_tap.degrid_all_layers`) over its own slice.
This is the f32 fallback of the solver for geometries the packed path
cannot express (a sub-grid that is not a multiple of 128, say).

Box membership is decided per (row, channel) in f64 on the host; the
reference's row-level bounds rejection (sdp_gridder_wtower_uvw.cpp:
112-121) is replaced by the guarantee that a box plus the kernel
support fits inside the sub-grid. The drivers run on ``device``
(``None``: the CUDA card; CPU runs pass ``device="cpu"``) and move their
inputs there. The mesh-sharded driver is not ported yet (ROADMAP Queue
1 item 15).
"""

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..fourier_transforms.fft import fft_shifted, ifft_shifted, \
    ifft_shifted_norm
from ..grid_data.gridder_utils import (
    subgrid_add_static,
    subgrid_cut_out_static,
)
from ..grid_data.kernels import eval_kernel_taps
from ..grid_data.wtower import _round_half_away, _slab_weights, \
    _tap_coeffs_cached
from ..kernels.tower_tap import degrid_all_layers, grid_all_layers
from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError
from ..utility.tensors import host_uvw, resolve_device, to_device
from .wstack import WStackPlan


@dataclass(frozen=True)
class BucketedTask:
    iu: int
    iv: int
    iw: int
    first_w_plane: int
    num_layers: int          # num_planes + w_support - 1
    start: int               # slice start in the sorted/padded arrays
    size: int                # padded slice size (multiple of block_v)


@dataclass(frozen=True)
class BucketedPlan:
    plan: WStackPlan
    tasks: Tuple[BucketedTask, ...]
    total: int               # padded total length

    @property
    def w_plane_ids(self):
        return tuple(sorted({t.iw for t in self.tasks}))


def plan_bucketed(plan: WStackPlan, uvw, block_v: int = 1024
                  ) -> Tuple[BucketedPlan, np.ndarray, np.ndarray]:
    """Assign each (row, channel) to its task box, bucket-sort, pad.

    Returns (bucketed_plan, sort_index [Vp], valid [Vp]), both host
    NumPy: ``sort_index`` gathers the flattened (row, channel) stream
    into task order (padded entries point at 0 with ``valid`` False).
    ``uvw`` is a NumPy array or a tensor on any device.
    """
    uvw = host_uvw(uvw)
    if plan.eff_sg_size + plan.support > plan.subgrid_size:
        raise SdpInvalidArgumentError(
            "bucketed path requires eff_sg_size + support <= subgrid_size "
            f"({plan.eff_sg_size} + {plan.support} > {plan.subgrid_size}); "
            "lower subgrid_frac")
    num_chan = plan.num_chan
    freqs = plan.freq0_hz + plan.dfreq_hz * np.arange(num_chan)
    scale = freqs / C_0                                   # [C]
    u = uvw[:, 0:1] * scale[None, :]                      # [R, C]
    v = uvw[:, 1:2] * scale[None, :]
    w = uvw[:, 2:3] * scale[None, :]

    d = plan.eff_sg_dist
    wd = plan.w_stack_dist
    iu = np.floor(u / d + 0.5).astype(np.int64)
    iv = np.floor(v / d + 0.5).astype(np.int64)
    iw = np.floor(w / wd + 0.5).astype(np.int64)

    # Map to the planned task list; out-of-plan boxes (sub-ulp boundary
    # ties only) are dropped.
    keys = np.stack([iw.ravel(), iu.ravel(), iv.ravel()], axis=1)
    task_id = np.full(keys.shape[0], -1, np.int64)
    for k, t in enumerate(plan.tasks):
        sel = ((keys[:, 0] == t.iw) & (keys[:, 1] == t.iu)
               & (keys[:, 2] == t.iv))
        task_id[sel] = k

    order = np.argsort(task_id, kind="stable")
    order = order[task_id[order] >= 0]
    sorted_ids = task_id[order]

    tasks = []
    sort_index = []
    valid = []
    start = 0
    for k, t in enumerate(plan.tasks):
        sel = order[sorted_ids == k]
        n = sel.shape[0]
        size = max(n + (-n) % block_v, block_v)
        pad = size - n
        sort_index.append(sel)
        sort_index.append(np.zeros(pad, np.int64))
        valid.append(np.ones(n, bool))
        valid.append(np.zeros(pad, bool))
        tasks.append(BucketedTask(t.iu, t.iv, t.iw, t.first_w_plane,
                                  t.num_planes + plan.w_support - 1, start,
                                  size))
        start += size

    return (BucketedPlan(plan=plan, tasks=tuple(tasks), total=start),
            np.concatenate(sort_index), np.concatenate(valid))


def _stream_taps(bplan: BucketedPlan, terms, uvw_s, chan_s, valid_s,
                 freq0: float, dfreq: float):
    """Tap geometry of every sorted/padded slot at once: (iu0, iv0 [V]
    int32, uk, vk [V, S] f32, weights [V, Kmax] f32), in ``uvw_s``'s
    precision.

    The JAX package's ``_slice_taps`` (bucketed.py:127) evaluates the
    same elementwise arithmetic per task slice; here ``terms`` (from
    :func:`_device_constants`) carries each slot's task constants, so
    one pass of a few hundred launches serves every task. Slot ``p`` of
    task ``t`` sees the values ``_slice_taps`` computes for ``t``, and
    its weights are zero beyond ``t``'s own layers.
    """
    plan = bplan.plan
    fdt = uvw_s.dtype
    theta, w_step = plan.theta, plan.w_step
    ov, w_ov = plan.oversampling, plan.w_oversampling
    support, w_support = plan.support, plan.w_support
    sgs = plan.subgrid_size
    half_ov = (sgs // 2 - support // 2 + 1) * ov
    # Per slot: off_u / theta, off_v / theta and off_w * w_step (f64,
    # rounded to uvw's precision as the JAX scalars are), the task's
    # first w-plane and layer count.
    u_shift, v_shift, w_shift, first, layers = terms

    sc = (freq0 + dfreq * chan_s.to(fdt)) / C_0
    u = uvw_s[:, 0] * sc - u_shift.to(fdt)
    v = uvw_s[:, 1] * sc - v_shift.to(fdt)
    w = uvw_s[:, 2] * sc - w_shift.to(fdt)

    iu0_ov = _round_half_away(u * (theta * ov)).to(torch.int32) + half_ov
    iv0_ov = _round_half_away(v * (theta * ov)).to(torch.int32) + half_ov
    iu0 = torch.div(iu0_ov, ov, rounding_mode="floor").clamp(
        0, sgs - support)
    iv0 = torch.div(iv0_ov, ov, rounding_mode="floor").clamp(
        0, sgs - support)
    uv_c = _tap_coeffs_cached(support, ov)
    uk = eval_kernel_taps(torch.remainder(iu0_ov, ov), uv_c, ov)
    vk = eval_kernel_taps(torch.remainder(iv0_ov, ov), uv_c, ov)

    # Plane index within the tower and the w kernel row (the clamp's
    # interval convention: plane p covers [(p-1) w_step, p w_step)).
    j = torch.floor(w / w_step).to(torch.int32) + 1 - first
    w_rel = w - (first + j - 1).to(fdt) * w_step
    w_row = torch.remainder(
        _round_half_away(w_rel * (w_ov / w_step)).to(torch.int32), w_ov)
    wk = eval_kernel_taps(w_row, _tap_coeffs_cached(w_support, w_ov), w_ov)

    in_plan = (j >= 0) & (j < layers - w_support + 1)
    weights = _slab_weights(wk, j, valid_s & in_plan,
                            max(t.num_layers for t in bplan.tasks))
    return (iu0.to(torch.int32).contiguous(),
            iv0.to(torch.int32).contiguous(), uk.contiguous(),
            vk.contiguous(), weights)


def _task_taps(taps, task: BucketedTask):
    """One task's slice of :func:`_stream_taps`' arrays (its weights
    cut to its own layers)."""
    sl = slice(task.start, task.start + task.size)
    iu0, iv0, uk, vk, weights = taps
    return (iu0[sl], iv0[sl], uk[sl], vk[sl],
            weights[sl, :task.num_layers].contiguous())


@lru_cache(maxsize=4)
def _device_constants(bplan: BucketedPlan, device: torch.device):
    """Per-plan constants on ``device`` (cached, as the JAX package's
    traced constants are): the per-slot task terms of
    :func:`_stream_taps`, and per task the w-pattern power ladders of
    its tower drain (``w_pattern ** (first + Sw//2 - Sw + k)``) and fill
    (``w_pattern ** -(first - Sw//2 + k)``), computed on the host in
    complex128 as in the JAX package and kept as complex64."""
    plan = bplan.plan
    sizes = [t.size for t in bplan.tasks]

    def per_slot(values, dtype):
        return torch.as_tensor(np.repeat(np.asarray(values, dtype), sizes),
                               device=device)

    terms = (
        per_slot([t.iu * plan.eff_sg_size / plan.theta
                  for t in bplan.tasks], np.float64),
        per_slot([t.iv * plan.eff_sg_size / plan.theta
                  for t in bplan.tasks], np.float64),
        per_slot([int(t.iw * plan.w_tower_height) * plan.w_step
                  for t in bplan.tasks], np.float64),
        per_slot([t.first_w_plane for t in bplan.tasks], np.int32),
        per_slot([t.num_layers for t in bplan.tasks], np.int32))
    pattern = plan.kernel().w_pattern[None]
    sw = plan.w_support
    grid_ladders, degrid_ladders = [], []
    for task in bplan.tasks:
        k = np.arange(task.num_layers)
        exps = (task.first_w_plane + sw // 2 - sw + k).astype(np.float32)
        grid_ladders.append(torch.as_tensor(
            (pattern ** exps[:, None, None]).astype(np.complex64),
            device=device))
        exps = (task.first_w_plane - sw // 2 + k).astype(np.float32)
        degrid_ladders.append(torch.as_tensor(
            (pattern ** (-exps[:, None, None])).astype(np.complex64),
            device=device))
    return dict(terms=terms, grid_ladders=grid_ladders,
                degrid_ladders=degrid_ladders)


def _sorted_inputs(bplan: BucketedPlan, uvw, sort_index, valid):
    """uvw and channel index of every sorted/padded slot, on uvw's
    device."""
    dev = uvw.device
    sort_index = torch.as_tensor(sort_index, device=dev)
    valid = torch.as_tensor(valid, device=dev)
    num_chan = bplan.plan.num_chan
    row_idx = torch.div(sort_index, num_chan, rounding_mode="floor")
    chan_idx = torch.remainder(sort_index, num_chan).to(torch.int32)
    return uvw[row_idx], chan_idx, sort_index, valid


def grid_all_bucketed(bplan: BucketedPlan, vis, uvw, sort_index, valid,
                      image_dtype=torch.float32, device=None) -> torch.Tensor:
    """Grid all visibilities on ``device``, one all-layer kernel launch
    per task over its own slice: O(V) work. ``vis`` [rows, chan] and
    ``uvw`` [rows, 3] (whose precision sets the geometry's); returns the
    dirty image (real unless ``image_dtype`` is complex)."""
    plan = bplan.plan
    kernel = plan.kernel()
    dev = resolve_device(device)
    vis, uvw = to_device(vis, dev), to_device(uvw, dev)
    sgs = plan.subgrid_size
    image_size = plan.image_size
    sg_factor = (image_size / sgs) ** 2
    freq0, dfreq = plan.freq0_hz, (plan.dfreq_hz or 10.0)

    uvw_s, chan_idx, sort_index, valid = _sorted_inputs(bplan, uvw,
                                                        sort_index, valid)
    vis_s = vis.reshape(-1)[sort_index]
    vis_re = torch.where(valid, vis_s.real, 0.0).to(torch.float32)
    vis_im = torch.where(valid, vis_s.imag, 0.0).to(torch.float32)
    consts = _device_constants(bplan, dev)
    taps = _stream_taps(bplan, consts["terms"], uvw_s, chan_idx, valid,
                        freq0, dfreq)

    image = torch.zeros((image_size, image_size), dtype=torch.complex64,
                        device=dev)
    per_plane_grid = {}
    for task, ladder in zip(bplan.tasks, consts["grid_ladders"]):
        sl = slice(task.start, task.start + task.size)
        acc = grid_all_layers(vis_re[sl], vis_im[sl], *_task_taps(taps, task),
                              task.num_layers, sgs, plan.support)
        # Tower drain: batched iFFT and the w-pattern ladder.
        subgrid = fft_shifted((ifft_shifted(acc) * ladder).sum(dim=0))
        g = per_plane_grid.get(task.iw)
        if g is None:
            g = torch.zeros((image_size, image_size), dtype=torch.complex64,
                            device=dev)
            per_plane_grid[task.iw] = g
        # In place on the driver's own plane grid (the offsets are plan
        # constants): at most four slice adds.
        subgrid_add_static(g, -task.iu * plan.eff_sg_size,
                           -task.iv * plan.eff_sg_size, subgrid, sg_factor)

    for iw, g in per_plane_grid.items():
        g = kernel.grid_correct(ifft_shifted_norm(g), 0, 0,
                                int(iw * plan.w_tower_height), device=dev)
        image = image + g.to(image.dtype)
    if not image_dtype.is_complex:
        return image.real.to(image_dtype)
    return image.to(image_dtype)


def degrid_all_bucketed(bplan: BucketedPlan, image, uvw, sort_index, valid,
                        inverse_index, device=None) -> torch.Tensor:
    """Degrid an image into all [rows, chan] visibilities (complex64)
    through the bucketed path on ``device``. ``inverse_index`` maps each
    flattened (row, channel) output to its sorted position
    (:func:`inverse_index_of`); entries the plan never assigned read a
    slot that stays zero."""
    plan = bplan.plan
    kernel = plan.kernel()
    dev = resolve_device(device)
    image, uvw = to_device(image, dev), to_device(uvw, dev)
    sgs = plan.subgrid_size
    num_chan = plan.num_chan
    freq0, dfreq = plan.freq0_hz, (plan.dfreq_hz or 10.0)

    uvw_s, chan_idx, _, valid = _sorted_inputs(bplan, uvw, sort_index,
                                               valid)
    consts = _device_constants(bplan, dev)
    taps = _stream_taps(bplan, consts["terms"], uvw_s, chan_idx, valid,
                        freq0, dfreq)
    # Per w-plane FFT'd full grid, shared by the plane's tasks.
    plane_grids = {
        iw: fft_shifted(kernel.degrid_correct(
            image.to(torch.complex64), 0, 0, int(iw * plan.w_tower_height),
            device=dev))
        for iw in bplan.w_plane_ids}

    out_sorted = torch.zeros((bplan.total + 1,), dtype=torch.complex64,
                             device=dev)
    for task, ladder in zip(bplan.tasks, consts["degrid_ladders"]):
        subgrid = ifft_shifted_norm(subgrid_cut_out_static(
            plane_grids[task.iw], task.iu * plan.eff_sg_size,
            task.iv * plan.eff_sg_size, sgs)).to(torch.complex64)
        layers = fft_shifted(subgrid[None] * ladder)
        out_sorted[task.start:task.start + task.size] = degrid_all_layers(
            layers, *_task_taps(taps, task), plan.support)

    inverse_index = torch.as_tensor(inverse_index, device=dev)
    return out_sorted[inverse_index].reshape(uvw.shape[0], num_chan)


def inverse_index_of(sort_index: np.ndarray, valid: np.ndarray,
                     num_vis: int) -> np.ndarray:
    """Host inverse permutation: flattened (row, channel) -> sorted
    position. Entries the plan never assigned point one past the end,
    which :func:`degrid_all_bucketed` keeps zero."""
    inv = np.full(num_vis, sort_index.shape[0], np.int64)
    pos = np.arange(sort_index.shape[0])
    inv[sort_index[valid]] = pos[valid]
    return inv


def task_id_stream(bplan: BucketedPlan) -> np.ndarray:
    """Host [total] array: which task owns each sorted/padded position."""
    ids = np.full(bplan.total, -1, np.int64)
    for k, t in enumerate(bplan.tasks):
        ids[t.start:t.start + t.size] = k
    return ids
