"""Chunked whole-survey gridding with the per-visibility plan made on the
device.

Counterpart of ska_sdp_func_tpu.parallel.streaming (streaming.py:103-1348)
on one device, or row-sharded over a process mesh (``mesh=``):

1. **Static stream geometry** (host, once per observation):
   :func:`stream_tasks` finds the task boxes from uvw metadata in f32
   with the device planner's formula, dilated at box edges, and
   :func:`plan_stream` fixes per-task tower ranges from the box
   w-intervals, the padded stream capacity and the box -> task lookup.
2. **Device plan** (per chunk, torch on the chunk's device): the f32
   quantised geometry of ``plan_packed``, one stable sort of the bucket
   keys with the payloads gathered by its permutation, bucket edges and
   padding by ``searchsorted``/``cumsum``, and K5 (``place_stream``)
   for the gap insertion into the padded stream.
3. **Grid** or **predict**, by one of two branches, then the packed
   path's tower drain (:class:`.packed._TowerImaging`):

   - *packable* plans (the fields fit the fused kernels' two int32
     words and ``block_v % 128 == 0``, every production block size): K3
     (``grid_fused_stack``) or K4 (``degrid_fused2_stack``) evaluate the
     taps from the placed plan words;
   - *non-packable* plans (``oversampling`` > 32768, ``w_oversampling``
     > 131072, ``subgrid_size - support`` > 2047, or a ``block_v`` that
     is not a multiple of 128): the five fields are placed separately;
     K6 (``stream_prep_grid``) evaluates the compact taps and the scale
     stack, K8 (``grid_packed``) grids them into bucket windows and one
     kernel folds those onto the tower layers (K9 and K10,
     ``fold_windows``); predict runs K7 (``stream_prep_degrid``) and K11
     (``degrid_fused``) on a plane-major model stack.

   ``fast=True`` is JAX's bf16 mode on both branches: K3/K4 run
   ``precision="bf16"``; K6/K7 return the v taps as bf16, and that dtype
   selects the bf16 mode of K8/K11 (each product ``bf16(a) * vk``, summed
   in f32), as the JAX engine's bf16 v-band selects it.
4. **Accumulation**: the image and the processed/dropped/voided counters
   stay on the device; :meth:`StreamingGridder.finalize` reads them once.
   A chunk whose bucket padding exceeds the capacity contributes nothing
   and is counted as voided; finalize then raises.
5. **Mesh**: each rank plans and grids (or predicts) its own block of
   each chunk's rows at ``cap / n`` slots; the overflow is reduced over
   the ranks before the placement (a chunk voids on all of them), the
   w-plane grids and the counters are summed.

The TPU plan carried every payload through its sorts because TPU
gathers are slow; on the card one sort and gathers do the same.
Geometry is f32, each operation rounded on its own; XLA may contract a
multiply-add into one rounding, so a few tap words can differ by one
oversample bin between the packages (box membership is protected by the
hull dilation of :func:`stream_tasks`).
"""

import functools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..grid_data.wtower import _round_half_away, _tap_coeffs_cached
from ..kernels import band_tap, fold, fused_tap, place, stream_prep
from ..kernels.packed_tap import degrid_runs
from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError, SdpRuntimeError
from ..utility.tensors import host_uvw, resolve_device
from .mesh import ROW_AXIS, mesh_axis, mesh_device
from .packed import (
    PackedTask,
    _TowerImaging,
    packed_geometry_ok,
)
from .wstack import WStackPlan

_ETA = 1e-5   # tower-range guard, mirrors plan_packed / plan_wstack
# The capacity quantum's second factor: the JAX package's stream-prep
# granule, kept so both packages plan the same capacity.
_PREP_G = 1024


def stream_tasks(wplan: WStackPlan, uvw) -> np.ndarray:
    """Pre-scan uvw metadata for the occupied task boxes (host).

    Returns ``[T, 3]`` int64 ``(biw, biu, biv)`` boxes. The quantisation
    runs in f32 with the device planner's formula, and every entry whose
    coordinate lands within a few ulps of a box edge admits both
    neighbouring boxes (a backend may contract ``x * inv + 0.5`` into one
    rounding), so the set holds every box the device can assign.
    """
    uvw = host_uvw(uvw).astype(np.float32)
    # Reciprocal multiplies, not divisions: a backend's f32 divide may
    # differ by more than the one-ulp contraction neighbourhood.
    inv_d = np.float32(1.0 / wplan.eff_sg_dist)
    inv_wd = np.float32(1.0 / wplan.w_stack_dist)
    scale = ((wplan.freq0_hz + (wplan.dfreq_hz or 10.0)
              * np.arange(wplan.num_chan)) / C_0).astype(np.float32)
    u = (uvw[:, 0:1] * scale[None, :]).ravel()
    v = (uvw[:, 1:2] * scale[None, :]).ravel()
    w = (uvw[:, 2:3] * scale[None, :]).ravel()

    def candidates(x):
        """Box index candidates of f32 coordinate+0.5 values: (floor,
        floor) normally; (rint-1, rint) within the edge ulp
        neighbourhood."""
        lo = np.floor(x).astype(np.int64)
        r = np.rint(x)
        near = np.abs(x - r) <= 8 * np.spacing(
            np.maximum(np.abs(x), np.float32(0.5)))
        ri = r.astype(np.int64)
        return (np.where(near, ri - 1, lo), np.where(near, ri, lo))

    cu = candidates(u * inv_d + np.float32(0.5))
    cv = candidates(v * inv_d + np.float32(0.5))
    cw = candidates(w * inv_wd + np.float32(0.5))
    span = 1 << 20
    keys = np.unique(np.concatenate([
        ((biw + span // 2) * span + (biu + span // 2)) * span
        + (biv + span // 2)
        for biw in cw for biu in cu for biv in cv]))
    return np.stack([keys // (span * span) - span // 2,
                     (keys // span) % span - span // 2,
                     keys % span - span // 2], axis=1)


@dataclass(frozen=True)
class StreamPlan:
    """Static geometry of a visibility stream (fixed task set); two
    StreamPlans are equal iff their geometry is."""

    wplan: WStackPlan
    tasks: Tuple[PackedTask, ...]
    chunk_rows: int
    block_v: int
    cap: int                 # padded stream capacity (slots)
    num_layers: int          # Kmax: uniform padded tower depth
    num_slabs: int
    num_octets: int
    num_buckets: int
    # Lookup tables derived from `tasks` (excluded from eq/hash).
    consts: Dict[str, np.ndarray] = field(compare=False, hash=False,
                                          repr=False, default=None)

    @property
    def w_plane_ids(self):
        return tuple(sorted({t.iw for t in self.tasks}))

    @property
    def num_blocks(self):
        return self.cap // self.block_v


def plan_stream(wplan: WStackPlan, boxes, chunk_rows: int,
                block_v: int = 256, cap_factor: float = 1.5,
                cap_slots: Optional[int] = None) -> StreamPlan:
    """Fix the stream geometry for a task-box set (host, once).

    ``boxes``: ``[T, 3]`` int ``(biw, biu, biv)`` task boxes (from
    :func:`stream_tasks` or chosen a priori). Each task's w-tower covers
    its box's full w-interval, so any visibility mapping to the box fits
    its tower. The capacity is ``ceil(chunk_rows * num_chan *
    cap_factor)`` slots (or ``cap_slots``), rounded up to a common
    multiple of ``block_v`` and 1024.
    """
    if not packed_geometry_ok(wplan.subgrid_size, wplan.support,
                              wplan.w_support, wplan.subgrid_frac):
        raise SdpInvalidArgumentError(
            "streaming uses the packed formulation: support <= 8, "
            "2*w_support*16 <= 128, subgrid_size % 128 == 0 and "
            "eff_sg_size + support <= subgrid_size required")
    boxes = np.asarray(boxes, np.int64)
    if boxes.ndim != 2 or boxes.shape[1] != 3 or boxes.shape[0] == 0:
        raise SdpInvalidArgumentError(
            f"boxes must be [T, 3] (biw, biu, biv), got {boxes.shape}")
    # Duplicate boxes would make task ids ambiguous: dedupe (ascending).
    boxes = np.unique(boxes, axis=0)
    if chunk_rows <= 0:
        raise SdpInvalidArgumentError("chunk_rows must be positive")
    w_step, height = wplan.w_step, wplan.w_tower_height
    wd = wplan.w_stack_dist

    biw = boxes[:, 0]
    off_w_t = np.trunc(biw * height).astype(np.int64)
    wmin_box = biw * wd - wd / 2
    wmax_box = biw * wd + wd / 2
    first_t = (np.floor(wmin_box / w_step - _ETA).astype(np.int64)
               - off_w_t)
    last_t = (np.ceil(wmax_box / w_step + _ETA).astype(np.int64)
              - off_w_t + 1)
    num_planes_t = 1 + last_t - first_t
    num_layers = int((num_planes_t + wplan.w_support - 1).max())
    num_slabs = num_layers - wplan.w_support + 1
    num_octets = wplan.subgrid_size // 8
    num_tasks = boxes.shape[0]
    num_buckets = num_tasks * num_slabs * num_octets

    # Dense box -> task lookup over the boxes' bounding lattice (-1: no
    # task there, the visibility is counted as dropped).
    b0 = boxes.min(axis=0)
    nb3 = boxes.max(axis=0) - b0 + 1
    if int(np.prod(nb3)) > (1 << 24):
        raise SdpInvalidArgumentError(
            f"task-box bounding lattice {tuple(nb3)} too large for a "
            "dense lookup — filter outlier uvw rows before "
            "stream_tasks, or restrict the box set")
    lut = np.full(int(np.prod(nb3)), -1, np.int32)
    flat = ((boxes[:, 0] - b0[0]) * nb3[1]
            + (boxes[:, 1] - b0[1])) * nb3[2] + (boxes[:, 2] - b0[2])
    lut[flat] = np.arange(num_tasks, dtype=np.int32)
    # Row-fused lookup [L, 8] (task, first_t, num_planes, off_w) as the
    # JAX plan carries it, so the two packages' plans are identical.
    lut2 = None
    if int(np.prod(nb3)) <= (1 << 21):
        lut2 = np.zeros((lut.shape[0], 8), np.int32)
        lut2[:, 0] = lut
        lut2[flat, 1] = first_t.astype(np.int32)
        lut2[flat, 2] = num_planes_t.astype(np.int32)
        lut2[flat, 3] = off_w_t.astype(np.int32)

    num_vis = chunk_rows * wplan.num_chan
    cap = cap_slots if cap_slots is not None else \
        int(math.ceil(num_vis * cap_factor / block_v)) * block_v
    quantum = block_v * _PREP_G // math.gcd(block_v, _PREP_G)
    cap = -(-int(cap) // quantum) * quantum
    # The device plan's bucket tables and words are int32; the worst
    # padding case is every bucket padded.
    if 3 * cap + num_vis >= 2 ** 31 or \
            num_vis + num_buckets * (block_v - 1) >= 2 ** 31:
        raise SdpInvalidArgumentError(
            "stream capacity / worst-case bucket padding too large "
            "for int32 device indexing — reduce chunk_rows, block_v "
            "or the task-box count")

    tasks = tuple(
        PackedTask(int(boxes[t, 1]), int(boxes[t, 2]),
                   int(boxes[t, 0]), int(first_t[t]))
        for t in range(num_tasks))
    consts = dict(
        lut=lut, lut2=lut2, b0=b0.astype(np.int32),
        nb3=nb3.astype(np.int32),
        flat_sorted=flat.astype(np.int32),
        first_t=first_t.astype(np.int32),
        off_w=off_w_t.astype(np.float32),
        num_planes_t=num_planes_t.astype(np.int32))
    return StreamPlan(
        wplan=wplan, tasks=tasks, chunk_rows=int(chunk_rows),
        block_v=int(block_v), cap=cap, num_layers=num_layers,
        num_slabs=num_slabs, num_octets=num_octets,
        num_buckets=num_buckets, consts=consts)


def _f32(x) -> float:
    """A Python float holding the f32 rounding of ``x`` (the JAX plan's
    np.float32 constants)."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=4)
def _stream_engine(splan: StreamPlan, fast: bool,
                   device: torch.device) -> "_StreamEngine":
    """Per-(plan, fast, device) engine: its device constants are built
    once and shared by every gridder and degridder of the stream. The
    plan's geometry picks the branch once, by the JAX engine's ``_pack``
    test (streaming.py:376-378)."""
    plan = splan.wplan
    if fused_tap.fused_geometry_ok(plan.subgrid_size, plan.support,
                                   plan.oversampling, plan.w_oversampling) \
            and splan.block_v % 128 == 0:
        return _StreamEngine(splan, fast, device)
    return _SplitStreamEngine(splan, fast, device)


class _StreamEngine(_TowerImaging):
    """Device constants of a stream and its chunk steps. This class is
    the packable branch (K3/K4 evaluate the taps from two placed plan
    words per slot); :class:`_SplitStreamEngine` is the non-packable one.
    """

    packable = True
    # The placed plan fields, in the order of :meth:`_plan_fields`.
    fields = ("packed_a", "packed_b")

    def __init__(self, splan: StreamPlan, fast: bool, device: torch.device):
        plan = splan.wplan
        self.splan = self.pplan = splan
        self.fast = bool(fast)
        # The JAX streaming engine runs "highest" (or "bf16" when fast);
        # the non-packable branch's bf16 mode follows from K6/K7's bf16 vk.
        self.precision = "bf16" if fast else "highest"
        self.device = device
        c = splan.consts

        def put(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=dtype).to(device)

        self._lut = put(c["lut"])
        self._first_t = put(c["first_t"])
        self._num_planes_t = put(c["num_planes_t"])
        self._off_w = put(c["off_w"])
        self._b0 = [int(x) for x in c["b0"]]
        self._nb3 = [int(x) for x in c["nb3"]]
        scale = (plan.freq0_hz + (plan.dfreq_hz or 10.0)
                 * np.arange(plan.num_chan)) / C_0
        self._scale = put(scale.astype(np.float32))
        self.uv_coeffs = put(_tap_coeffs_cached(
            plan.support, plan.oversampling), torch.float32)
        self.w_coeffs = put(_tap_coeffs_cached(
            plan.w_support, plan.w_oversampling), torch.float32)
        self._init_imaging()

    # -- device plan ----------------------------------------------------

    def _plan_fields(self, iv0, u_off, w_row, u_frac, v_frac, ok):
        """Per-entry fields to place: the two packed words, with the valid
        bit set on ``ok`` entries (the placement zero-fills padding)."""
        return fused_tap.pack_plan_words(iv0, u_off, w_row, u_frac, v_frac,
                                         ok)

    def _occupancy(self, vcnt, overflow):
        """(block valid counts to place, slot-side arrays): every block is
        placed, and ``nonempty`` [num_blocks] lets K3/K4 skip the empty
        ones (an overflowed chunk's result is discarded by the step)."""
        return vcnt, dict(nonempty=(vcnt > 0).to(torch.int32))

    def _plan_chunk(self, uvw, row_mask, vre=None, vim=None,
                    need_unsort: bool = True, cap: Optional[int] = None,
                    num_blocks: Optional[int] = None, group=None):
        """Per-chunk device plan (uvw [R, 3] f32, row_mask [R] bool,
        optional vre/vim [R, C] f32), the JAX engine's ``_plan_chunk``, at
        ``cap`` slots in ``num_blocks`` blocks (``None``: the plan's). With
        a process ``group`` the overflow is the ranks' (a MAX
        ``all_reduce`` before the placement), so a chunk voids on every
        rank together.

        Returns (arrays, dest_by_orig, block_bucket, visited, processed,
        dropped, overflow): ``arrays`` holds the placed ``fields``, the
        branch's :meth:`_occupancy` arrays and ``vre``/``vim`` when given;
        ``dest_by_orig`` [R * C] maps each entry to its slot (``cap`` when
        it was not placed); counters are 0-d device tensors.
        """
        splan = self.splan
        plan = splan.wplan
        cap = splan.cap if cap is None else cap
        num_blocks = splan.num_blocks if num_blocks is None else num_blocks
        bv, nb = splan.block_v, splan.num_buckets
        dev = uvw.device
        i32 = torch.int32
        ov, sgs, support = plan.oversampling, plan.subgrid_size, plan.support
        d = _f32(plan.eff_sg_dist)
        theta_ov = _f32(plan.theta * plan.oversampling)
        w_step = _f32(plan.w_step)
        w_ov_scale = _f32(plan.w_oversampling / plan.w_step)
        half_ov = (sgs // 2 - support // 2 + 1) * ov

        def rha(x):
            return _round_half_away(x).to(i32)

        scale = self._scale[None, :]
        u = (uvw[:, 0:1] * scale).reshape(-1)
        v = (uvw[:, 1:2] * scale).reshape(-1)
        w = (uvw[:, 2:3] * scale).reshape(-1)
        mask = row_mask[:, None].expand(-1, plan.num_chan).reshape(-1)

        inv_d = _f32(1.0 / plan.eff_sg_dist)
        inv_wd = _f32(1.0 / plan.w_stack_dist)
        biu = torch.floor(u * inv_d + 0.5).to(i32)
        biv = torch.floor(v * inv_d + 0.5).to(i32)
        biw = torch.floor(w * inv_wd + 0.5).to(i32)
        (b00, b01, b02), (n0, n1, n2) = self._b0, self._nb3
        i0, i1, i2 = biw - b00, biu - b01, biv - b02
        inb = ((i0 >= 0) & (i0 < n0) & (i1 >= 0) & (i1 < n1)
               & (i2 >= 0) & (i2 < n2))
        li = ((i0.long() * n1 + i1) * n2 + i2).clamp(
            0, self._lut.shape[0] - 1)
        task = torch.where(inb, self._lut[li], -1)
        tsafe = task.clamp(min=0)
        first_e = self._first_t[tsafe.long()]
        nplanes_e = self._num_planes_t[tsafe.long()]
        off_w_e = self._off_w[tsafe.long()]

        iu0_ov = rha((u - biu.float() * d) * theta_ov) + half_ov
        iv0_ov = rha((v - biv.float() * d) * theta_ov) + half_ov
        iu0 = torch.div(iu0_ov, ov, rounding_mode="floor").clamp(
            0, sgs - support)
        iv0 = torch.div(iv0_ov, ov, rounding_mode="floor").clamp(
            0, sgs - support)
        u_frac = torch.remainder(iu0_ov, ov)
        v_frac = torch.remainder(iv0_ov, ov)
        w_rel = w - off_w_e * w_step
        j = torch.floor(w_rel / w_step).to(i32) + 1 - first_e
        w_rel2 = w_rel - (first_e + j - 1).float() * w_step
        w_row = torch.remainder(rha(w_rel2 * w_ov_scale),
                                plan.w_oversampling)
        ok = mask & (task >= 0) & (j >= 0) & (j < nplanes_e)
        bucket = torch.where(
            ok, (tsafe * splan.num_slabs + j) * splan.num_octets
            + (iu0 >> 3), nb)
        fields = self._plan_fields(iv0, iu0 & 7, w_row, u_frac, v_frac, ok)

        # One stable sort of the keys; payloads follow by gathers.
        b_s, order = torch.sort(bucket, stable=True)
        payloads = [f[order] for f in fields]
        if vre is not None:
            payloads += [vre.reshape(-1)[order], vim.reshape(-1)[order]]

        # Bucket tables (edge e = first sorted position with key >= e).
        n = bucket.shape[0]
        edges = torch.searchsorted(
            b_s, torch.arange(nb + 1, dtype=i32, device=dev))
        counts = edges[1:] - edges[:-1]
        pad_off = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
        pad_off[1:] = torch.cumsum((counts + bv - 1) // bv * bv, dim=0)
        overflow = pad_off[-1] > cap
        if group is not None:
            over = overflow.to(i32)
            dist.all_reduce(over, op=dist.ReduceOp.MAX, group=group)
            overflow = over > 0

        # Block side: block -> bucket, first sorted entry, valid count.
        slots = torch.arange(num_blocks, device=dev) * bv
        block_bucket = torch.searchsorted(pad_off[1:], slots,
                                          right=True).clamp(0, nb - 1)
        off_in_b = slots - pad_off[block_bucket]
        src0 = (edges[block_bucket] + off_in_b).clamp(0, n).to(i32)
        vcnt = (counts[block_bucket] - off_in_b).clamp(0, bv).to(i32)
        vcnt, occupancy = self._occupancy(vcnt, overflow)
        # One launch: at most 5 fields and 2 visibility planes.
        placed = place.place_stream(src0, vcnt, payloads, bv, cap)

        arrays = dict(zip(self.fields, placed), **occupancy)
        if vre is not None:
            arrays["vre"], arrays["vim"] = placed[len(self.fields):]
        not_over = ~overflow
        visited = (counts > 0) & not_over
        processed = torch.sum(ok & not_over, dtype=i32)
        dropped = torch.sum(mask & ~ok, dtype=i32)
        dest_by_orig = None
        if need_unsort:
            # Sorted entry k of bucket b lands at pad_off[b] + k - edges[b];
            # unplaced entries point at the guaranteed-zero slot `cap`.
            b_l = b_s.long()
            dest = (pad_off[b_l] - edges[b_l]
                    + torch.arange(n, device=dev)).clamp(max=cap)
            dest = torch.where(b_s < nb, dest, cap)
            dest_by_orig = torch.empty_like(dest).scatter_(0, order, dest)
        return (arrays, dest_by_orig, block_bucket.to(i32), visited,
                processed, dropped, overflow)

    def _block_coords(self, block_bucket):
        """Per-block (task, w-slab, u-octet) of the block -> bucket map."""
        no, ns = self.splan.num_octets, self.splan.num_slabs
        return block_bucket // (no * ns), (block_bucket // no) % ns, \
            block_bucket % no

    def _kernel_dims(self):
        plan = self.splan.wplan
        return dict(support=plan.support, w_support=plan.w_support,
                    oversampling=plan.oversampling,
                    w_oversampling=plan.w_oversampling,
                    block_v=self.splan.block_v, precision=self.precision)

    # -- branch stages --------------------------------------------------

    def _chunk_planes(self, arrays, block_bucket, visited):
        """Placed chunk -> its w-plane grids: K3 tower stacks over the
        chunk's window runs (as the predict's: a bucket's blocks, built on
        the device, no host sync), then the drain of the tasks a block
        visited (none of an overflowed chunk)."""
        splan = self.splan
        num_tasks = len(splan.tasks)
        stack = fused_tap.grid_fused_stack(
            *self._block_coords(block_bucket), arrays["packed_a"],
            arrays["packed_b"], arrays["vre"], arrays["vim"],
            self.uv_coeffs, self.w_coeffs, num_tasks, splan.num_layers,
            splan.wplan.subgrid_size, nonempty=arrays["nonempty"],
            runs=degrid_runs((block_bucket,)), **self._kernel_dims())
        tvis = visited.reshape(num_tasks, -1).any(dim=1)
        return self._stack_to_planes(stack, tvis)

    def _predict(self, st, arrays, block_bucket, dest):
        """Placed chunk and task-major model stack -> visibilities [R * C]
        in entry order: K4 over the chunk's window runs (the blocks are
        bucket-sorted: a run is a bucket's blocks; built on the device,
        no host sync), then the unsort (unplaced entries read the zero
        slot ``cap``)."""
        out = fused_tap.degrid_fused2_stack(
            st, *self._block_coords(block_bucket), arrays["packed_a"],
            arrays["packed_b"], self.uv_coeffs, self.w_coeffs,
            nonempty=arrays["nonempty"], runs=degrid_runs((block_bucket,)),
            **self._kernel_dims())
        return torch.cat([out, out.new_zeros(1)])[dest]

    # -- chunk steps ----------------------------------------------------

    def step(self, image, counters, uvw, row_mask, vre, vim, shard=None):
        """Grid one padded chunk: returns the new image and counters
        (processed, dropped, voided). ``shard`` ``(cap, num_blocks,
        group)`` (JAX streaming.py:914-978): the chunk is this rank's
        block, planned at the shard's capacity; the overflow, the w-plane
        grids and the counters are the sums over the ranks of ``group``."""
        cap, num_blocks, group = shard or (None, None, None)
        (arrays, _, bb, visited, processed, dropped,
         overflow) = self._plan_chunk(uvw, row_mask, vre, vim,
                                      need_unsort=False, cap=cap,
                                      num_blocks=num_blocks, group=group)
        planes = self._chunk_planes(arrays, bb, visited)
        if group is not None:
            dist.all_reduce(torch.view_as_real(planes), group=group)
            processed, dropped = _sum_counts(group, processed, dropped)
        chunk_img = self._planes_to_image(planes)
        # An overflow voids the whole chunk, never a truncated image.
        gain = (~overflow).to(torch.float32)
        p_acc, d_acc, v_acc = counters
        return image + gain * chunk_img, (
            p_acc + processed, d_acc + torch.where(overflow, 0, dropped),
            v_acc + overflow.to(torch.int32))

    def dstep(self, counters, uvw, row_mask, st, shard=None):
        """Predict one padded chunk from the model stack ``st``: returns
        the visibilities [R, C] and the counters. ``shard`` as in
        :meth:`step` (JAX streaming.py:980-1030): the rank's rows predict
        without a collective on the data; only the overflow and the
        counters are reduced."""
        cap, num_blocks, group = shard or (None, None, None)
        (arrays, dest, bb, _, processed, dropped,
         overflow) = self._plan_chunk(uvw, row_mask, cap=cap,
                                      num_blocks=num_blocks, group=group)
        if group is not None:
            processed, dropped = _sum_counts(group, processed, dropped)
        vis = self._predict(st, arrays, bb, dest).reshape(
            uvw.shape[0], self.splan.wplan.num_chan)
        vis = torch.where(overflow, 0, vis)
        p_acc, d_acc, v_acc = counters
        return vis, (p_acc + processed,
                     d_acc + torch.where(overflow, 0, dropped),
                     v_acc + overflow.to(torch.int32))


class _SplitStreamEngine(_StreamEngine):
    """The non-packable branch (JAX streaming.py:855-873, :1110-1123):
    the plan fields placed one by one. Grid: K6 taps and scale stack, K8
    bucket windows, the K9/K10 fold, the drain. Predict: K7 taps, K11 on
    a plane-major model stack, the unsort. Each stage is a method of its
    own, and the steps compose them."""

    packable = False
    fields = ("u_off", "iv0", "u_frac", "v_frac", "w_row")

    def _plan_fields(self, iv0, u_off, w_row, u_frac, v_frac, ok):
        return u_off, iv0, u_frac, v_frac, w_row

    def _occupancy(self, vcnt, overflow):
        """JAX masks every placed field with slot_ok, which is false on an
        overflowed chunk: place nothing there. ``valid`` [cap] is the slot
        mask."""
        vcnt = torch.where(overflow, 0, vcnt)
        lane = torch.arange(self.splan.block_v, device=vcnt.device)
        return vcnt, dict(valid=(lane[None, :] < vcnt[:, None]).reshape(-1))

    def _model_stack(self, image):
        """Image -> the plane-major [2, T K, G + 8, G] stack K11 reads
        (JAX streaming.py:1066-1070), from the task-major one."""
        st = super()._model_stack(image)
        g = self.splan.wplan.subgrid_size
        num_planes = len(self.splan.tasks) * self.splan.num_layers
        return st.reshape(-1, 2, self.splan.num_layers, g + 8, g).transpose(
            0, 1).reshape(2, num_planes, g + 8, g)

    # -- grid stages ----------------------------------------------------

    def _prep_grid(self, arrays):
        """K6: compact taps ``uk``, ``vk`` [cap, S] (``vk`` bf16 when fast)
        and the scale stack [2 Sw, cap]."""
        plan = self.splan.wplan
        return stream_prep.stream_prep_grid(
            arrays["u_frac"], arrays["v_frac"], arrays["w_row"],
            arrays["vre"], arrays["vim"], self.uv_coeffs, self.w_coeffs,
            plan.oversampling, plan.w_oversampling, fast=self.fast)

    def _grid_windows(self, arrays, block_bucket, uk, vk, scales):
        """K8: bucket windows [2 Sw, num_buckets, 16, G] (bf16 mode for a
        bf16 ``vk``), over the chunk's window runs (no host sync)."""
        splan = self.splan
        plan = splan.wplan
        return band_tap.grid_packed(
            block_bucket, arrays["u_off"], arrays["iv0"], uk, vk, scales,
            splan.num_buckets, plan.subgrid_size, plan.w_support,
            block_v=splan.block_v, runs=degrid_runs((block_bucket,)))

    def _fold_windows(self, wins, visited):
        """The JAX driver's ``_fold_windows`` (packed.py:478-492): K9 and
        K10 in one kernel, bucket windows -> complex64 tower layers [T, K,
        G, G]. Unvisited buckets, and every bucket of an overflowed chunk,
        read as zero."""
        splan = self.splan
        return fold.fold_windows(wins, visited, len(splan.tasks),
                                 splan.num_slabs, splan.num_octets,
                                 splan.wplan.w_support, splan.num_layers)

    def _drain_planes(self, layers):
        """Tower layers -> the chunk's w-plane grids."""
        return self._stage_planes(self._stage_drain(
            layers, self.ladder_grid, self.pref_grid))

    def _drain(self, layers):
        """Tower layers -> the chunk's dirty image."""
        return self._planes_to_image(self._drain_planes(layers))

    def _chunk_planes(self, arrays, block_bucket, visited):
        wins = self._grid_windows(arrays, block_bucket,
                                  *self._prep_grid(arrays))
        return self._drain_planes(self._fold_windows(wins, visited))

    # -- predict stages -------------------------------------------------

    def _prep_degrid(self, arrays):
        """K7: compact taps ``uk``, ``vk`` (bf16 when fast) and ``wk_t``
        [Sw, cap] masked by the slot mask."""
        plan = self.splan.wplan
        return stream_prep.stream_prep_degrid(
            arrays["u_frac"], arrays["v_frac"], arrays["w_row"],
            arrays["valid"].to(torch.float32), self.uv_coeffs, self.w_coeffs,
            plan.oversampling, plan.w_oversampling, fast=self.fast)

    def _degrid_windows(self, st, arrays, block_bucket, uk, vk, wk_t):
        """K11: f32 [8, cap] sorted predictions (rows 0/1 re/im), gathered
        from plane ``task * K + slab``, rows of octet ``g`` (bf16 mode for
        a bf16 ``vk``), over the chunk's window runs (a bucket's blocks,
        no host sync)."""
        splan = self.splan
        plan = splan.wplan
        task, slab, octet = self._block_coords(block_bucket)
        return band_tap.degrid_fused(
            st, task * splan.num_layers + slab, octet,
            torch.zeros_like(octet), arrays["u_off"], arrays["iv0"], uk, vk,
            wk_t, plan.w_support, plan.subgrid_size, block_v=splan.block_v,
            raw=True, runs=degrid_runs((block_bucket,)))

    @staticmethod
    def _unsort(raw, dest):
        """Sorted predictions -> visibilities [R * C] in entry order: one
        gather of the re/im rows; unplaced entries read the zero column
        ``cap``."""
        rows = torch.cat([raw[:2], raw.new_zeros((2, 1))], dim=1)[:, dest]
        return torch.complex(rows[0], rows[1])

    def _predict(self, st, arrays, block_bucket, dest):
        raw = self._degrid_windows(st, arrays, block_bucket,
                                   *self._prep_degrid(arrays))
        return self._unsort(raw, dest)


def _zero_counters(device):
    return tuple(torch.zeros((), dtype=torch.int32, device=device)
                 for _ in range(3))


def _sum_counts(group, processed, dropped):
    """(processed, dropped) summed over the ranks of ``group``."""
    counts = torch.stack([processed, dropped])
    dist.all_reduce(counts, group=group)
    return counts[0], counts[1]


def _sum_expected(expected: int, shard, device) -> int:
    """The visibilities the ranks of the shard's group were given."""
    if shard is None:
        return expected
    total = torch.tensor(expected, dtype=torch.int64, device=device)
    dist.all_reduce(total, group=shard[2])
    return int(total)


def _stream_shard(splan: StreamPlan, mesh, axis_name: str):
    """(rows of a chunk block, the steps' ``shard`` argument) for a
    ``mesh`` (``None``: one device, the whole chunk). The rows shard over
    the mesh's ``axis_name`` alone; each shard plans at ``cap / n`` slots
    (JAX streaming.py:926-956)."""
    if mesh is None:
        return splan.chunk_rows, None
    n, _, group = mesh_axis(mesh, axis_name)
    if splan.chunk_rows % n or splan.cap % (n * splan.block_v) \
            or (splan.cap // n) % _PREP_G:
        raise SdpInvalidArgumentError(
            f"chunk_rows ({splan.chunk_rows}) must divide by the "
            f"row-shard count ({n}) and cap ({splan.cap}) by "
            f"n*block_v with a per-shard cap that is a multiple "
            f"of the prep granule ({_PREP_G}); adjust cap_slots")
    cap_s = splan.cap // n
    return splan.chunk_rows // n, (cap_s, cap_s // splan.block_v, group)


def _padded_chunk(splan: StreamPlan, uvw, device,
                  chunk_rows: Optional[int] = None):
    """uvw [R, 3] (NumPy or tensor) -> (rows, uvw [chunk_rows, 3] f32,
    row_mask [chunk_rows]) on ``device``, zero-padded and masked
    (``chunk_rows`` None: the plan's)."""
    if chunk_rows is None:
        chunk_rows = splan.chunk_rows
    uvw = torch.as_tensor(uvw)
    if uvw.ndim != 2 or uvw.shape[1] != 3:
        raise SdpInvalidArgumentError(
            f"uvw must be [rows, 3], got {tuple(uvw.shape)}")
    rows = uvw.shape[0]
    if rows > chunk_rows:
        raise SdpInvalidArgumentError(
            f"chunk has {rows} rows > chunk_rows={chunk_rows}")
    uvw32 = torch.zeros((chunk_rows, 3), dtype=torch.float32,
                        device=device)
    uvw32[:rows] = uvw.to(device)
    row_mask = torch.zeros(chunk_rows, dtype=torch.bool, device=device)
    row_mask[:rows] = True
    return rows, uvw32, row_mask


class StreamingGridder:
    """Accumulates a dirty image over visibility chunks, planning on the
    device (module docstring). Engines are shared across instances of the
    same (plan, fast, device). ``device=None`` is the CUDA card (on a
    mesh, the mesh's: :func:`.mesh.mesh_device`); CPU runs pass
    ``device="cpu"``.

    With ``mesh=`` the chunk's rows shard over the mesh's ``axis_name``
    (n ranks; ``chunk_rows`` and ``cap`` must divide by n, JAX
    streaming.py:914-978): each rank passes :meth:`accumulate` its own
    block of each chunk, the chunk's rows ``[r B, (r + 1) B)`` with ``B =
    chunk_rows / n`` (fewer, or none, in a short chunk), planned at
    ``cap / n`` slots; the w-plane grids and the counters are summed
    over the ranks, and every rank holds the same image.

    >>> sg = StreamingGridder(plan_stream(wplan, stream_tasks(wplan,
    ...                                   uvw_meta), chunk_rows=4096),
    ...                       device="cuda")
    >>> for uvw_c, vis_c, wgt_c in chunks:
    ...     sg.accumulate(uvw_c, vis_c, wgt_c)
    >>> image = sg.finalize()
    """

    def __init__(self, splan: StreamPlan, fast: bool = False, mesh=None,
                 axis_name: str = ROW_AXIS, device=None):
        self._rows, self._shard = _stream_shard(splan, mesh, axis_name)
        self.splan = splan
        self.fast = bool(fast)
        if device is None and mesh is not None:
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        self._engine = _stream_engine(splan, self.fast, self.device)
        n = splan.wplan.image_size
        self._image = torch.zeros((n, n), dtype=torch.float32,
                                  device=self.device)
        # Device counters (int32: fine to ~2e9 visibilities/stream).
        self._counters = _zero_counters(self.device)
        self._expected = 0                         # host-side
        self._finalized = None

    def accumulate(self, uvw, vis, weights=None):
        """Grid one chunk: uvw [R, 3], vis [R, num_chan] complex
        (R <= chunk_rows, or the rank's block on a mesh; short chunks are
        padded and masked); optional weights [R, num_chan] scale the
        visibilities."""
        if self._finalized is not None:
            raise SdpRuntimeError("stream already finalized")
        num_chan = self.splan.wplan.num_chan
        rows, uvw32, row_mask = _padded_chunk(self.splan, uvw, self.device,
                                              self._rows)
        vis = torch.as_tensor(vis)
        if vis.ndim != 2 or vis.shape[0] != rows \
                or vis.shape[1] != num_chan:
            raise SdpInvalidArgumentError(
                f"vis must be [{rows}, {num_chan}], got "
                f"{tuple(vis.shape)}")
        vis = vis.to(self.device)
        if not vis.is_complex():
            vis = vis.to(torch.complex64)
        vre = vis.real.to(torch.float32)
        vim = vis.imag.to(torch.float32)
        if weights is not None:
            wgt = torch.as_tensor(weights).to(self.device, torch.float32)
            vre, vim = vre * wgt, vim * wgt
        pad = self._rows - rows
        if pad:
            zeros = vre.new_zeros((pad, num_chan))
            vre, vim = torch.cat([vre, zeros]), torch.cat([vim, zeros])
        self._image, self._counters = self._engine.step(
            self._image, self._counters, uvw32, row_mask, vre, vim,
            self._shard)
        self._expected += rows * num_chan

    @property
    def image(self) -> torch.Tensor:
        """Current accumulated dirty image (no host sync)."""
        return self._image

    def counters(self):
        """(processed, dropped, voided_chunks) device scalars (over every
        rank on a mesh)."""
        return self._counters

    def finalize(self, check: bool = True) -> torch.Tensor:
        """Return the accumulated image; with ``check`` (default),
        enforce the processed-visibility invariant
        (sdp_grid_wstack_wtower.cpp:442-448) with one host readback (and,
        on a mesh, one sum of the ranks' visibility counts)."""
        if self._finalized is None:
            self._finalized = self._image
        if check:
            expected = _sum_expected(self._expected, self._shard,
                                     self.device)
            processed, dropped, voided = (int(x) for x in self._counters)
            if voided:
                raise SdpRuntimeError(
                    f"{voided} chunk(s) exceeded the padded stream "
                    f"capacity ({self.splan.cap} slots) and were "
                    "voided; raise cap_factor or shrink chunks")
            # Nothing dropped and nothing voided imply processed ==
            # expected; the cross-check only applies while the int32
            # device counter cannot have wrapped.
            if dropped or (expected < 2 ** 31 and processed != expected):
                raise SdpRuntimeError(
                    f"stream processed {processed} of "
                    f"{expected} visibilities ({dropped} "
                    "outside the task set / tower ranges)")
        return self._finalized


class StreamingDegridder:
    """Predict (degrid) visibilities for a model image chunk by chunk,
    planning on the device: the predict half of a streaming selfcal
    loop. The model's stack is built once per :meth:`set_model`.
    Visibilities outside the task set predict zero and are counted;
    :meth:`check` raises on them. ``mesh=`` shards the chunk's rows as
    :class:`StreamingGridder`'s does: each rank passes :meth:`predict` its
    block of the chunk and gets back its rows' visibilities (JAX
    streaming.py:980-1030)."""

    def __init__(self, splan: StreamPlan, fast: bool = False, mesh=None,
                 axis_name: str = ROW_AXIS, device=None):
        self._rows, self._shard = _stream_shard(splan, mesh, axis_name)
        self.splan = splan
        self.fast = bool(fast)
        if device is None and mesh is not None:
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        self._engine = _stream_engine(splan, self.fast, self.device)
        self._st = None
        self._counters = _zero_counters(self.device)
        self._expected = 0

    def set_model(self, image):
        """Set (or replace) the model image; returns self."""
        n = self.splan.wplan.image_size
        image = torch.as_tensor(image)
        if tuple(image.shape) != (n, n):
            raise SdpInvalidArgumentError(
                f"model must be [{n}, {n}], got {tuple(image.shape)}")
        self._st = self._engine._model_stack(image.to(self.device))
        return self

    def predict(self, uvw) -> torch.Tensor:
        """uvw [R, 3] -> predicted visibilities [R, num_chan] complex64
        (R <= chunk_rows, or the rank's block on a mesh; short chunks
        padded and masked)."""
        if self._st is None:
            raise SdpRuntimeError("call set_model(image) first")
        rows, uvw32, row_mask = _padded_chunk(self.splan, uvw, self.device,
                                              self._rows)
        vis, self._counters = self._engine.dstep(
            self._counters, uvw32, row_mask, self._st, self._shard)
        self._expected += rows * self.splan.wplan.num_chan
        return vis[:rows]

    def counters(self):
        """(processed, dropped, voided_chunks) device scalars (over every
        rank on a mesh)."""
        return self._counters

    def check(self):
        """Raise if any visibility predicted zero because it fell outside
        the task set or the capacity (one host readback)."""
        expected = _sum_expected(self._expected, self._shard, self.device)
        processed, dropped, voided = (int(x) for x in self._counters)
        if voided:
            raise SdpRuntimeError(
                f"{voided} predict chunk(s) exceeded the padded "
                f"stream capacity ({self.splan.cap} slots) and "
                "returned zeros; raise cap_factor or shrink chunks")
        if dropped or (expected < 2 ** 31 and processed != expected):
            raise SdpRuntimeError(
                f"predicted {processed} of {expected} "
                f"visibilities ({dropped} outside the task set / "
                "tower ranges returned zeros)")
