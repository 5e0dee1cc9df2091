"""Bucketed w-stacking drivers: sort visibilities by task, grid slices.

Counterpart of ska_sdp_func_tpu.parallel.bucketed for one device
(bucketed.py:37-333). The task drivers in :mod:`.wstack` stream every
visibility through every (w-plane, sub-grid) task: O(tasks x V). Every
(row, channel) visibility belongs to exactly one task box (the boxes
tile (u, v, w) space), so a host bucket sort (:func:`plan_bucketed`,
the same NumPy arithmetic as the JAX package, so its arrays are
identical) makes each task's visibilities one contiguous slice, and a
whole pass is O(V). The JAX package loops over the tasks, one all-layer
kernel and one tower drain each; XLA compiles that loop away, but on the
card each of its ~90 launches a task is a host call. So here one launch
of the all-layer kernels (:func:`~..kernels.tower_tap.
grid_all_layers_tasks`, :func:`~..kernels.tower_tap.
degrid_all_layers_tasks`) takes the whole sorted stream, and the tower
drain around it runs batched over the tasks: the FFTs over every layer
at once, the w-pattern ladders per group of tasks with equal layer
counts, and the sub-grids added into (or cut out of) the w-plane grids
with one ``index_add_`` (one gather) on plan-constant indices. This is
the f32 fallback of the solver for geometries the packed path cannot
express (a sub-grid that is not a multiple of 128, say).

Box membership is decided per (row, channel) in f64 on the host; the
reference's row-level bounds rejection (sdp_gridder_wtower_uvw.cpp:
112-121) is replaced by the guarantee that a box plus the kernel
support fits inside the sub-grid. The drivers run on ``device``
(``None``: the CUDA card; CPU runs pass ``device="cpu"``) and move their
inputs there. :func:`grid_all_bucketed_sharded` splits the sorted stream
into one contiguous chunk a rank of a process mesh: each rank grids its
chunk in one launch and drains every task's tower, and one
``all_reduce`` sums the w-plane grids before the image stages.
"""

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..fourier_transforms.fft import fft_shifted, ifft_shifted, \
    ifft_shifted_norm
from ..grid_data.kernels import eval_kernel_taps
from ..grid_data.wtower import _round_half_away, _slab_weights, \
    _tap_coeffs_cached
from ..kernels.tower_tap import degrid_all_layers_tasks, \
    grid_all_layers_tasks, task_table
from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError
from ..utility.tensors import host_uvw, resolve_device, to_device
from .mesh import ROW_AXIS, mesh_axis, mesh_device
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


def _stream_sparse_taps(bplan: BucketedPlan, terms, uvw_s, chan_s,
                        valid_s, freq0: float, dfreq: float):
    """Tap geometry of every sorted/padded slot at once, with the w taps
    in their sparse form: (iu0, iv0 [V] int32, uk, vk [V, S], j [V]
    int32, wk [V, Sw], keep [V] bool), in ``uvw_s``'s precision. Slot
    ``v`` touches its task's layers ``j[v] .. j[v] + Sw - 1`` with the
    weights ``wk[v]`` where ``keep[v]`` (valid and inside its task's
    planes), and nothing elsewhere.

    The JAX package's ``_slice_taps`` (bucketed.py:127) evaluates the
    same elementwise arithmetic per task slice; here ``terms`` (from
    :func:`_device_constants`) carries each slot's task constants, so
    one pass of a few hundred launches serves every task. Slot ``p`` of
    task ``t`` sees the values ``_slice_taps`` computes for ``t``.
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
    return (iu0.to(torch.int32).contiguous(),
            iv0.to(torch.int32).contiguous(), uk.contiguous(),
            vk.contiguous(), j.to(torch.int32), wk, valid_s & in_plan)


def _stream_taps(bplan: BucketedPlan, terms, uvw_s, chan_s, valid_s,
                 freq0: float, dfreq: float):
    """:func:`_stream_sparse_taps` with the w taps densified for the
    all-layer kernels: (iu0, iv0, uk, vk, weights [V, Kmax] f32), each
    slot's weights zero beyond its task's own layers."""
    iu0, iv0, uk, vk, j, wk, keep = _stream_sparse_taps(
        bplan, terms, uvw_s, chan_s, valid_s, freq0, dfreq)
    weights = _slab_weights(wk, j, keep,
                            max(t.num_layers for t in bplan.tasks))
    return iu0, iv0, uk, vk, weights


def _subgrid_index(plan: WStackPlan, tasks, plane_ids) -> np.ndarray:
    """Host int64 [T, N, N]: for each of ``tasks`` (in order) the flat
    index into a ``[len(plane_ids), G, G]`` stack of w-plane grids of each
    cell of its sub-grid, with wrap-around: the cells
    ``subgrid_add_static(grid, -iu E, -iv E, ...)`` adds into and
    ``subgrid_cut_out_static(grid, iu E, iv E, N)`` cuts out (E the
    effective sub-grid size), on the plane of the task's ``iw``."""
    g, n, eff = plan.image_size, plan.subgrid_size, plan.eff_sg_size
    plane_of = {iw: p for p, iw in enumerate(plane_ids)}
    cells = np.arange(n)
    out = np.empty((len(tasks), n, n), np.int64)
    for i, t in enumerate(tasks):
        rows = (g // 2 - n // 2 + t.iu * eff + cells) % g
        cols = (g // 2 - n // 2 + t.iv * eff + cells) % g
        out[i] = plane_of[t.iw] * g * g + rows[:, None] * g + cols[None, :]
    return out


@lru_cache(maxsize=4)
def _device_constants(bplan: BucketedPlan, device: torch.device):
    """Per-plan constants on ``device`` (cached, as the JAX package's
    traced constants are): ``terms``, the per-slot task terms of
    :func:`_stream_taps` (:func:`_slot_terms` of the whole stream), and
    :func:`_task_constants`."""
    return dict(terms=_slot_terms(bplan, device, 0, bplan.total),
                **_task_constants(bplan, device))


@lru_cache(maxsize=4)
def _task_constants(bplan: BucketedPlan, device: torch.device):
    """The per-task constants on ``device`` (cached).

    ``groups``: the tasks by layer count K, each ``(K, first, last,
    plane, grid_ladder, degrid_ladder)``: the group holds tasks ``first``
    to ``last - 1`` of the group order, and their planes of the layer
    stack run from ``plane`` in the same order, K each; the ladders are
    [T_g, K, N, N] complex64, per task the w-pattern powers of its tower
    drain (``w_pattern ** (first_w + Sw//2 - Sw + k)``) and fill
    (``w_pattern ** -(first_w - Sw//2 + k)``), computed on the host in
    complex128 as in the JAX package. ``tasks``: the
    :class:`~..kernels.tower_tap.TaskTable` of the stream (task order),
    its planes in group order. ``index``: the sub-grid cells of the tasks
    in group order (:func:`_subgrid_index`), flat [T N N].
    """
    plan = bplan.plan
    tasks = bplan.tasks
    pattern = plan.kernel().w_pattern[None]
    sw = plan.w_support

    def ladders(idx, sign, shift):
        k = np.arange(tasks[idx[0]].num_layers)
        exps = np.stack([tasks[i].first_w_plane + shift + k
                         for i in idx]).astype(np.float32)
        return torch.as_tensor(
            (pattern[None] ** (sign * exps[:, :, None, None])).astype(
                np.complex64), device=device)

    order, groups, base, planes = [], [], {}, 0
    for num_k in sorted({t.num_layers for t in tasks}):
        idx = [i for i, t in enumerate(tasks) if t.num_layers == num_k]
        first = len(order)
        for i in idx:
            base[i] = planes
            planes += num_k
        order += idx
        groups.append((num_k, first, len(order), base[idx[0]],
                       ladders(idx, 1, sw // 2 - sw),
                       ladders(idx, -1, -(sw // 2))))
    table = task_table([(t.start, t.size, t.num_layers, base[i])
                        for i, t in enumerate(tasks)], device)
    index = _subgrid_index(plan, [tasks[i] for i in order],
                           bplan.w_plane_ids)
    return dict(groups=groups, tasks=table,
                index=torch.as_tensor(index.reshape(-1), device=device))


@lru_cache(maxsize=4)
def _slot_terms(bplan: BucketedPlan, device: torch.device, lo: int,
                hi: int):
    """The task terms of :func:`_stream_taps` for the sorted slots
    ``[lo, hi)``: per slot ``off_u / theta``, ``off_v / theta``,
    ``off_w * w_step`` (f64), the task's first w-plane and layer count
    (int32); padding past the stream's end takes zeros."""
    plan = bplan.plan
    tasks = bplan.tasks
    sizes = [max(0, min(t.start + t.size, hi) - max(t.start, lo))
             for t in tasks]
    tail = max(0, hi - max(lo, bplan.total))

    def per_slot(values, dtype):
        return torch.as_tensor(np.concatenate([
            np.repeat(np.asarray(values, dtype), sizes),
            np.zeros(tail, dtype)]), device=device)

    return (
        per_slot([t.iu * plan.eff_sg_size / plan.theta
                  for t in tasks], np.float64),
        per_slot([t.iv * plan.eff_sg_size / plan.theta
                  for t in tasks], np.float64),
        per_slot([int(t.iw * plan.w_tower_height) * plan.w_step
                  for t in tasks], np.float64),
        per_slot([t.first_w_plane for t in tasks], np.int32),
        per_slot([t.num_layers for t in tasks], np.int32))


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
    """Grid all visibilities on ``device``: one all-layer kernel launch
    over every task's slots, then the batched tower drain: O(V) work.
    ``vis`` [rows, chan] and ``uvw`` [rows, 3] (whose precision sets the
    geometry's); returns the dirty image (real unless ``image_dtype`` is
    complex)."""
    plan = bplan.plan
    dev = resolve_device(device)
    vis, uvw = to_device(vis, dev), to_device(uvw, dev)
    uvw_s, chan_idx, sort_index, valid = _sorted_inputs(bplan, uvw,
                                                        sort_index, valid)
    vis_s = vis.reshape(-1)[sort_index]
    vis_re = torch.where(valid, vis_s.real, 0.0).to(torch.float32)
    vis_im = torch.where(valid, vis_s.imag, 0.0).to(torch.float32)
    consts = _device_constants(bplan, dev)
    taps = _stream_taps(bplan, consts["terms"], uvw_s, chan_idx, valid,
                        plan.freq0_hz, plan.dfreq_hz or 10.0)
    acc = grid_all_layers_tasks(vis_re, vis_im, *taps, consts["tasks"],
                                plan.subgrid_size, plan.support)
    return _grids_to_image(bplan, _drain_to_grids(bplan, consts, acc),
                           image_dtype)


def _drain_to_grids(bplan: BucketedPlan, consts, acc) -> torch.Tensor:
    """The batched tower drain of the all-layer stack ``acc`` -> the
    w-plane grids [P, N, N] complex64: the iFFT of every layer, the
    w-pattern ladder and the sum over each task's layers (per group of
    equal layer count), the FFT of every sub-grid, and every sub-grid
    added into its w-plane grid at once (the adds of subgrid_add_static,
    wrap-around included)."""
    plan = bplan.plan
    sgs, image_size = plan.subgrid_size, plan.image_size
    layers = ifft_shifted(acc)
    subgrids = fft_shifted(torch.cat([
        (layers[p0:p0 + (last - first) * num_k].reshape(
            last - first, num_k, sgs, sgs) * ladder).sum(dim=1)
        for num_k, first, last, p0, ladder, _ in consts["groups"]]))
    grids = torch.zeros((len(bplan.w_plane_ids), image_size, image_size),
                        dtype=torch.complex64, device=acc.device)
    torch.view_as_real(grids).reshape(-1, 2).index_add_(
        0, consts["index"], torch.view_as_real(subgrids).reshape(-1, 2),
        alpha=(image_size / sgs) ** 2)
    return grids


def _grids_to_image(bplan: BucketedPlan, grids, image_dtype):
    """Per w-plane the iFFT and grid correction, summed into the dirty
    image (real unless ``image_dtype`` is complex)."""
    plan = bplan.plan
    kernel = plan.kernel()
    dev = grids.device
    grids = ifft_shifted_norm(grids)
    image = torch.zeros((plan.image_size, plan.image_size),
                        dtype=torch.complex64, device=dev)
    for g, iw in zip(grids, bplan.w_plane_ids):
        image = image + kernel.grid_correct(
            g, 0, 0, int(iw * plan.w_tower_height), device=dev).to(
                image.dtype)
    if not image_dtype.is_complex:
        return image.real.to(image_dtype)
    return image.to(image_dtype)


def grid_all_bucketed_sharded(bplan: BucketedPlan, vis, uvw, sort_index,
                              valid, mesh, axis_name: str = ROW_AXIS,
                              image_dtype=torch.float32,
                              device=None) -> torch.Tensor:
    """Mesh-sharded bucketed gridding (JAX bucketed.py:336-419) on
    ``device`` (``None``: the mesh's, :func:`.mesh.mesh_device`): the
    sorted stream, padded to a multiple of ``n * 1024`` slots (n the size
    of the mesh's ``axis_name``), splits into one contiguous chunk a rank.
    Each rank gathers only its chunk's slots from the whole ``vis``
    [rows, chan] and ``uvw`` [rows, 3], grids them in one launch over
    every task (each task's slots clipped to the chunk; a task outside it
    counts none) and drains every task's tower; one ``all_reduce`` sums
    the w-plane grids, and every rank returns the same image."""
    plan = bplan.plan
    n, rank, group = mesh_axis(mesh, axis_name)
    dev = mesh_device(mesh) if device is None else resolve_device(device)
    vis, uvw = to_device(vis, dev), to_device(uvw, dev)
    per = -(-bplan.total // (n * 1024)) * 1024
    lo, hi = rank * per, (rank + 1) * per
    sort_index = _host(sort_index)[lo:hi]
    valid = _host(valid)[lo:hi]
    pad = per - sort_index.shape[0]
    if pad:
        sort_index = np.concatenate([sort_index, np.zeros(pad, np.int64)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    uvw_s, chan_idx, sort_index, valid = _sorted_inputs(bplan, uvw,
                                                        sort_index, valid)
    vis_s = vis.reshape(-1)[sort_index]
    vis_re = torch.where(valid, vis_s.real, 0.0).to(torch.float32)
    vis_im = torch.where(valid, vis_s.imag, 0.0).to(torch.float32)
    consts = _task_constants(bplan, dev)
    taps = _stream_taps(bplan, _slot_terms(bplan, dev, lo, hi), uvw_s,
                        chan_idx, valid, plan.freq0_hz,
                        plan.dfreq_hz or 10.0)
    acc = grid_all_layers_tasks(vis_re, vis_im, *taps,
                                _chunk_table(bplan, lo, hi, dev),
                                plan.subgrid_size, plan.support)
    grids = _drain_to_grids(bplan, consts, acc)
    dist.all_reduce(torch.view_as_real(grids), group=group)
    return _grids_to_image(bplan, grids, image_dtype)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@lru_cache(maxsize=8)
def _chunk_table(bplan: BucketedPlan, lo: int, hi: int, device):
    """The :class:`~..kernels.tower_tap.TaskTable` of the sorted slots
    ``[lo, hi)``: every task, its slots clipped to the chunk and counted
    from ``lo`` (none for a task outside it), its planes where
    :func:`_task_constants`' table has them."""
    full = _task_constants(bplan, device)["tasks"].rows
    rows = []
    for start, count, num_layers, base in full:
        a = min(max(start, lo), hi)
        b = max(min(start + count, hi), a)
        rows.append((a - lo, b - a, num_layers, base))
    return task_table(rows, device)


def degrid_all_bucketed(bplan: BucketedPlan, image, uvw, sort_index, valid,
                        inverse_index, device=None) -> torch.Tensor:
    """Degrid an image into all [rows, chan] visibilities (complex64)
    through the bucketed path on ``device``: the batched tower fill, then
    one all-layer kernel launch over every task's slots.
    ``inverse_index`` maps each flattened (row, channel) output to its
    sorted position (:func:`inverse_index_of`); entries the plan never
    assigned read a slot that stays zero."""
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
    # Per w-plane FFT'd full grid, shared by the plane's tasks; every
    # task's sub-grid cut out at once (subgrid_cut_out_static's cells).
    grids = fft_shifted(torch.stack([
        kernel.degrid_correct(image.to(torch.complex64), 0, 0,
                              int(iw * plan.w_tower_height), device=dev)
        for iw in bplan.w_plane_ids]))
    subgrids = ifft_shifted_norm(
        grids.reshape(-1)[consts["index"]].reshape(-1, sgs, sgs)).to(
            torch.complex64)
    # Tower fill, batched: each task's sub-grid times its ladder (per
    # group of equal layer count), then the FFT of every layer.
    layers = fft_shifted(torch.cat([
        (subgrids[first:last, None] * ladder).reshape(-1, sgs, sgs)
        for _, first, last, _, _, ladder in consts["groups"]]))
    out_sorted = degrid_all_layers_tasks(layers, *taps, consts["tasks"],
                                         plan.support)
    out_sorted = torch.cat([out_sorted, out_sorted.new_zeros(1)])
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
