"""Chunked whole-survey gridding with the per-visibility plan made on the
device.

Counterpart of ska_sdp_func_tpu.parallel.streaming (streaming.py:103-1348)
on one device, for packable geometries (the plan fields fit the fused
kernels' two int32 words and ``block_v % 128 == 0``, which covers every
production block size):

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
3. **Grid** (K3, ``grid_fused_stack``) or **predict** (K4,
   ``degrid_fused2_stack``) with the taps evaluated in the kernels from
   the placed plan words, then the packed path's tower drain
   (:class:`.packed._TowerImaging`).
4. **Accumulation**: the image and the processed/dropped/voided counters
   stay on the device; :meth:`StreamingGridder.finalize` reads them once.
   A chunk whose bucket padding exceeds the capacity contributes nothing
   and is counted as voided; finalize then raises.

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

from ..grid_data.wtower import _round_half_away, _tap_coeffs_cached
from ..kernels import fused_tap, place
from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError, SdpRuntimeError
from ..utility.tensors import resolve_device
from .packed import (
    PackedTask,
    _TowerImaging,
    _host_uvw,
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
    uvw = _host_uvw(uvw).astype(np.float32)
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
    once and shared by every gridder and degridder of the stream."""
    return _StreamEngine(splan, fast, device)


class _StreamEngine(_TowerImaging):
    """Device constants of a stream and its chunk steps."""

    def __init__(self, splan: StreamPlan, fast: bool, device: torch.device):
        plan = splan.wplan
        if not (fused_tap.fused_geometry_ok(
                plan.subgrid_size, plan.support, plan.oversampling,
                plan.w_oversampling) and splan.block_v % 128 == 0):
            raise NotImplementedError(
                "this stream plan is not packable (plan fields beyond the "
                "fused kernels' int32 words, or block_v % 128 != 0); its "
                "prep/band/fold kernels K6-K11 are not ported yet (ROADMAP "
                "Queue 1 item 11)")
        self.splan = self.pplan = splan
        self.fast = bool(fast)
        # The JAX streaming engine runs "highest" (or "bf16" when fast).
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

    def _plan_chunk(self, uvw, row_mask, vre=None, vim=None,
                    need_unsort: bool = True):
        """Per-chunk device plan (uvw [R, 3] f32, row_mask [R] bool,
        optional vre/vim [R, C] f32), the JAX engine's ``_plan_chunk``.

        Returns (arrays, dest_by_orig, block_bucket, visited, processed,
        dropped, overflow): ``arrays`` holds the placed ``packed_a``,
        ``packed_b`` (and ``vre``/``vim``) [cap] and ``nonempty``
        [num_blocks]; ``dest_by_orig`` [R * C] maps each entry to its slot
        (``cap`` when it was not placed); counters are 0-d device
        tensors.
        """
        splan = self.splan
        plan = splan.wplan
        cap, bv, nb = splan.cap, splan.block_v, splan.num_buckets
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
        # The valid bit is set on ok entries (the placement zero-fills
        # padding slots).
        pa, pb = fused_tap.pack_plan_words(iv0, iu0 & 7, w_row, u_frac,
                                           v_frac, ok)

        # One stable sort of the keys; payloads follow by gathers.
        b_s, order = torch.sort(bucket, stable=True)
        payloads = [pa[order], pb[order]]
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

        # Block side: block -> bucket, first sorted entry, valid count.
        slots = torch.arange(splan.num_blocks, device=dev) * bv
        block_bucket = torch.searchsorted(pad_off[1:], slots,
                                          right=True).clamp(0, nb - 1)
        off_in_b = slots - pad_off[block_bucket]
        src0 = (edges[block_bucket] + off_in_b).clamp(0, n).to(i32)
        vcnt = (counts[block_bucket] - off_in_b).clamp(0, bv).to(i32)
        nonempty = (vcnt > 0).to(i32)
        placed = place.place_stream(src0, vcnt, payloads, bv, cap)

        arrays = dict(packed_a=placed[0], packed_b=placed[1],
                      nonempty=nonempty)
        if vre is not None:
            arrays["vre"], arrays["vim"] = placed[2], placed[3]
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

    # -- chunk steps ----------------------------------------------------

    def step(self, image, counters, uvw, row_mask, vre, vim):
        """Grid one padded chunk: returns the new image and counters
        (processed, dropped, voided)."""
        splan = self.splan
        (arrays, _, bb, visited, processed, dropped,
         overflow) = self._plan_chunk(uvw, row_mask, vre, vim,
                                      need_unsort=False)
        num_tasks = len(splan.tasks)
        stack = fused_tap.grid_fused_stack(
            *self._block_coords(bb), arrays["packed_a"], arrays["packed_b"],
            arrays["vre"], arrays["vim"], self.uv_coeffs, self.w_coeffs,
            num_tasks, splan.num_layers, splan.wplan.subgrid_size,
            nonempty=arrays["nonempty"], **self._kernel_dims())
        # Tasks no block visited (or every task of an overflowed chunk).
        tvis = visited.reshape(num_tasks, -1).any(dim=1)
        chunk_img = self._image_from_stack(stack, tvis)
        # An overflow voids the whole chunk, never a truncated image.
        gain = (~overflow).to(torch.float32)
        p_acc, d_acc, v_acc = counters
        return image + gain * chunk_img, (
            p_acc + processed, d_acc + torch.where(overflow, 0, dropped),
            v_acc + overflow.to(torch.int32))

    def dstep(self, counters, uvw, row_mask, st):
        """Predict one padded chunk from the model stack ``st``: returns
        the visibilities [R, C] and the counters."""
        splan = self.splan
        (arrays, dest, bb, _, processed, dropped,
         overflow) = self._plan_chunk(uvw, row_mask)
        out = fused_tap.degrid_fused2_stack(
            st, *self._block_coords(bb), arrays["packed_a"],
            arrays["packed_b"], self.uv_coeffs, self.w_coeffs,
            nonempty=arrays["nonempty"], **self._kernel_dims())
        padded = torch.cat([out, out.new_zeros(1)])
        vis = padded[dest].reshape(uvw.shape[0], splan.wplan.num_chan)
        vis = torch.where(overflow, 0, vis)
        p_acc, d_acc, v_acc = counters
        return vis, (p_acc + processed,
                     d_acc + torch.where(overflow, 0, dropped),
                     v_acc + overflow.to(torch.int32))


def _zero_counters(device):
    return tuple(torch.zeros((), dtype=torch.int32, device=device)
                 for _ in range(3))


def _padded_chunk(splan: StreamPlan, uvw, device):
    """uvw [R, 3] (NumPy or tensor) -> (rows, uvw [chunk_rows, 3] f32,
    row_mask [chunk_rows]) on ``device``, zero-padded and masked."""
    uvw = torch.as_tensor(uvw)
    if uvw.ndim != 2 or uvw.shape[1] != 3:
        raise SdpInvalidArgumentError(
            f"uvw must be [rows, 3], got {tuple(uvw.shape)}")
    rows = uvw.shape[0]
    if rows > splan.chunk_rows:
        raise SdpInvalidArgumentError(
            f"chunk has {rows} rows > chunk_rows={splan.chunk_rows}")
    uvw32 = torch.zeros((splan.chunk_rows, 3), dtype=torch.float32,
                        device=device)
    uvw32[:rows] = uvw.to(device)
    row_mask = torch.zeros(splan.chunk_rows, dtype=torch.bool,
                           device=device)
    row_mask[:rows] = True
    return rows, uvw32, row_mask


def _check_single_device(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded streaming is not ported yet (ROADMAP Queue 1 "
            "item 15)")


class StreamingGridder:
    """Accumulates a dirty image over visibility chunks, planning on the
    device (module docstring). Engines are shared across instances of the
    same (plan, fast, device). ``device=None`` is the CUDA card; CPU runs
    pass ``device="cpu"``.

    >>> sg = StreamingGridder(plan_stream(wplan, stream_tasks(wplan,
    ...                                   uvw_meta), chunk_rows=4096),
    ...                       device="cuda")
    >>> for uvw_c, vis_c, wgt_c in chunks:
    ...     sg.accumulate(uvw_c, vis_c, wgt_c)
    >>> image = sg.finalize()
    """

    def __init__(self, splan: StreamPlan, fast: bool = False, mesh=None,
                 device=None):
        _check_single_device(mesh)
        self.splan = splan
        self.fast = bool(fast)
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
        (R <= chunk_rows; short chunks are padded and masked); optional
        weights [R, num_chan] scale the visibilities."""
        if self._finalized is not None:
            raise SdpRuntimeError("stream already finalized")
        splan = self.splan
        num_chan = splan.wplan.num_chan
        rows, uvw32, row_mask = _padded_chunk(splan, uvw, self.device)
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
        pad = splan.chunk_rows - rows
        if pad:
            zeros = vre.new_zeros((pad, num_chan))
            vre, vim = torch.cat([vre, zeros]), torch.cat([vim, zeros])
        self._image, self._counters = self._engine.step(
            self._image, self._counters, uvw32, row_mask, vre, vim)
        self._expected += rows * num_chan

    @property
    def image(self) -> torch.Tensor:
        """Current accumulated dirty image (no host sync)."""
        return self._image

    def counters(self):
        """(processed, dropped, voided_chunks) device scalars."""
        return self._counters

    def finalize(self, check: bool = True) -> torch.Tensor:
        """Return the accumulated image; with ``check`` (default),
        enforce the processed-visibility invariant
        (sdp_grid_wstack_wtower.cpp:442-448) with one host readback."""
        if self._finalized is None:
            self._finalized = self._image
        if check:
            processed, dropped, voided = (int(x) for x in self._counters)
            if voided:
                raise SdpRuntimeError(
                    f"{voided} chunk(s) exceeded the padded stream "
                    f"capacity ({self.splan.cap} slots) and were "
                    "voided; raise cap_factor or shrink chunks")
            # Nothing dropped and nothing voided imply processed ==
            # expected; the cross-check only applies while the int32
            # device counter cannot have wrapped.
            if dropped or (self._expected < 2 ** 31
                           and processed != self._expected):
                raise SdpRuntimeError(
                    f"stream processed {processed} of "
                    f"{self._expected} visibilities ({dropped} "
                    "outside the task set / tower ranges)")
        return self._finalized


class StreamingDegridder:
    """Predict (degrid) visibilities for a model image chunk by chunk,
    planning on the device: the predict half of a streaming selfcal
    loop. The model's task-major stack is built once per
    :meth:`set_model`. Visibilities outside the task set predict zero and
    are counted; :meth:`check` raises on them."""

    def __init__(self, splan: StreamPlan, fast: bool = False, mesh=None,
                 device=None):
        _check_single_device(mesh)
        self.splan = splan
        self.fast = bool(fast)
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
        (R <= chunk_rows; short chunks padded and masked)."""
        if self._st is None:
            raise SdpRuntimeError("call set_model(image) first")
        rows, uvw32, row_mask = _padded_chunk(self.splan, uvw, self.device)
        vis, self._counters = self._engine.dstep(
            self._counters, uvw32, row_mask, self._st)
        self._expected += rows * self.splan.wplan.num_chan
        return vis[:rows]

    def counters(self):
        """(processed, dropped, voided_chunks) device scalars."""
        return self._counters

    def check(self):
        """Raise if any visibility predicted zero because it fell outside
        the task set or the capacity (one host readback)."""
        processed, dropped, voided = (int(x) for x in self._counters)
        if voided:
            raise SdpRuntimeError(
                f"{voided} predict chunk(s) exceeded the padded "
                f"stream capacity ({self.splan.cap} slots) and "
                "returned zeros; raise cap_factor or shrink chunks")
        if dropped or (self._expected < 2 ** 31
                       and processed != self._expected):
            raise SdpRuntimeError(
                f"predicted {processed} of {self._expected} "
                f"visibilities ({dropped} outside the task set / "
                "tower ranges returned zeros)")
