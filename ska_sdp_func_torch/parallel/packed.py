"""Packed w-stacking whole-image drivers (single device).

Counterpart of ska_sdp_func_tpu.parallel.packed (packed.py:76-1001):

1. **Plan** (host, once per uvw distribution): every (row, channel)
   visibility is assigned to its (w-plane, sub-grid) task, w-slab ``k0``
   and u-octet ``g``; the stream is bucket-sorted by (task, slab, octet)
   and each bucket padded to a block multiple (:func:`plan_packed`, the
   same C++ planner as the JAX package, so plans are byte-identical).
2. **Bands** (device, once per plan): taps evaluated from the plan's
   integer rows, placed into the u/v bands (:class:`PackedGridder`).
3. **Grid** (device, per call): the CUDA stack kernel accumulates
   per-task tower stacks -> batched iFFT -> shared w-pattern ladder
   contraction -> FFT -> wrap-around sub-grid adds per w-plane -> plane
   iFFTs, w-screens and the PSWF correction. Degrid mirrors it.

The band engine (K1/K2), ``engine="fused"`` (K3/K4: taps evaluated in
the kernel from two packed words per slot) and ``engine="compact"``
(K12/K13) run on one device or block-sharded over a process mesh
(JAX packed.py:1160-1512): the plan's blocks split contiguously over the
ranks (:func:`shard_plan`; build the plan with ``pad_blocks_to`` the
rank count), each rank runs the single-device gridder of its own
sub-plan, and one ``all_reduce`` sums the w-plane grids before the
image stages. :meth:`PackedGridder.report_timing` and
:meth:`~PackedGridder.report_timing_degrid` report one pass by JAX's
stages, timed inside the pass (:func:`_stage_times`). The stages around
the stack kernels (:class:`_TowerImaging`) are shared with the streaming
engine (:mod:`.streaming`).
"""

import dataclasses
import functools
import math
import time
import types
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..fourier_transforms.fft import fft_shifted, ifft_shifted, \
    ifft_shifted_norm
from ..grid_data.grid_correct import grid_correct_pswf, w_screen_stack
from ..grid_data.gridder_utils import (
    subgrid_add_static,
    subgrid_cut_out_static,
)
from ..grid_data.kernels import eval_kernel_taps
from ..grid_data.wtower import _tap_coeffs_cached
from ..kernels import fused_tap
from ..kernels.packed_tap import (
    WIN_ROWS,
    bucket_runs,
    build_bands,
    degrid_runs,
    degrid_stack,
    grid_packed_stack,
    split_bf16,
)
from ..utility.errors import SdpInvalidArgumentError, SdpRuntimeError
from ..utility.tensors import host_uvw, resolve_device, to_device
from ..utility.timers import Timers, TimerType
from .mesh import ROW_AXIS, gather_rows, mesh_axis, mesh_device
from .wstack import WStackPlan


@dataclass(frozen=True)
class PackedTask:
    iu: int
    iv: int
    iw: int
    first_w_plane: int


@dataclass(frozen=True)
class PackedPlan:
    """Static packed-ingest geometry + host index/tap arrays.

    Equality and hash cover the geometry and a content digest of the
    index arrays, so value-equal plans share gridders while plans with
    different permutations never collide.
    """

    wplan: WStackPlan
    tasks: Tuple[PackedTask, ...]
    num_rows: int
    num_layers: int          # Kmax: uniform padded tower depth
    num_slabs: int           # Kmax - w_support + 1
    num_octets: int
    block_v: int
    total: int               # padded sorted-stream length
    num_blocks: int
    num_buckets: int
    digest: str
    arrays: Dict[str, np.ndarray] = field(compare=False, hash=False,
                                          repr=False, default=None)

    @property
    def w_plane_ids(self):
        return tuple(sorted({t.iw for t in self.tasks}))


@dataclass(frozen=True)
class _ShardPlan(PackedPlan):
    """A rank's sub-plan (:func:`shard_plan`): it keeps the whole plan's
    w-planes, so the ranks' planes line up for their sum."""

    plane_ids: Tuple[int, ...] = ()

    @property
    def w_plane_ids(self):
        return self.plane_ids


# Block-size auto-selection: minimise padded slots plus a per-block cost
# in visibility-equivalents. The constants are the JAX package's, so both
# packages choose the same block size and build identical plans; they
# were tuned on the TPU and are not an H100 measurement.
_BLOCK_OVERHEAD_VIS = 150
_BLOCK_CANDIDATES = (128, 256, 512, 1024)


def _auto_block_v(counts: np.ndarray) -> int:
    best, best_cost = _BLOCK_CANDIDATES[0], None
    for bv in _BLOCK_CANDIDATES:
        padded = int((-(-counts // bv) * bv).sum())
        cost = padded + _BLOCK_OVERHEAD_VIS * (padded // bv)
        if best_cost is None or cost < best_cost:
            best, best_cost = bv, cost
    return best


def packed_geometry_ok(subgrid_size: int, support: int, w_support: int,
                       subgrid_frac: float) -> bool:
    """True when the packed formulation can express the geometry: octet
    window (support <= 8), window rows (2 * w_support * 16 <= 128),
    128-lane sub-grids and the in-window tap invariant."""
    eff = int(math.floor(subgrid_size * (subgrid_frac or 2.0 / 3.0)))
    return (support <= 8 and 2 * w_support * WIN_ROWS <= 128
            and subgrid_size % 128 == 0
            and eff + support <= subgrid_size)


def inverse_index_of(sort_index: np.ndarray, valid: np.ndarray,
                     num_vis: int) -> np.ndarray:
    """Host inverse permutation: flattened (row, channel) -> sorted
    position; entries the plan never assigned point one past the end."""
    inv = np.full(num_vis, sort_index.shape[0], np.int64)
    pos = np.arange(sort_index.shape[0])
    inv[sort_index[valid]] = pos[valid]
    return inv


def plan_packed(wplan: WStackPlan, uvw, block_v=None,
                pad_blocks_to: int = 1) -> PackedPlan:
    """Build the packed ingest plan on the host (f64).

    Same arithmetic and C++ planner as the JAX package's ``plan_packed``:
    task enumeration, bucket sort by (task, w-slab, u-octet), padding
    to ``block_v`` (auto-selected when None) and tap-table lookups.
    ``uvw`` is a NumPy array or a tensor on any device.
    """
    support, w_support = wplan.support, wplan.w_support
    sgs = wplan.subgrid_size
    if not packed_geometry_ok(sgs, support, w_support, wplan.subgrid_frac):
        raise SdpInvalidArgumentError(
            "packed path requires support <= 8 (octet window), "
            "w_support <= 4 (window rows), subgrid_size % 128 == 0 "
            "and eff_sg_size + support <= subgrid_size (got "
            f"support={support}, w_support={w_support}, "
            f"subgrid_size={sgs}, eff_sg_size={wplan.eff_sg_size})")

    uvw = host_uvw(uvw)
    num_rows = uvw.shape[0]
    num_chan = wplan.num_chan
    freq0 = wplan.freq0_hz
    dfreq = wplan.dfreq_hz or 10.0
    theta, w_step = wplan.theta, wplan.w_step
    ov, w_ov = wplan.oversampling, wplan.w_oversampling
    d = wplan.eff_sg_dist
    height = wplan.w_tower_height
    if num_rows * num_chan == 0:
        raise SdpInvalidArgumentError(
            "packed plan needs at least one (row, channel) visibility "
            f"(got {num_rows} rows x {num_chan} channels)")

    task_id, boxes, wmin_t, wmax_t = native.packed_tasks(
        uvw, freq0, dfreq, num_chan, d, wplan.w_stack_dist)
    num_tasks = boxes.shape[0]

    # Per-task w bounds -> tower plane range (plan_wstack geometry,
    # sdp_grid_wstack_wtower.cpp:310-330).
    eta = 1e-5
    off_w_t = np.trunc(boxes[:, 0] * height).astype(np.int64)
    first_t = (np.floor(wmin_t / w_step - eta).astype(np.int64)
               - off_w_t)
    last_t = (np.ceil(wmax_t / w_step + eta).astype(np.int64)
              - off_w_t + 1)
    num_planes_t = 1 + last_t - first_t
    num_layers = int((num_planes_t + w_support - 1).max())
    num_slabs = num_layers - w_support + 1
    num_octets = sgs // 8
    num_buckets = num_tasks * num_slabs * num_octets
    kernel = wplan.kernel()

    arrays = native.packed_plan_arrays(
        uvw, freq0, dfreq, num_chan, d, theta, w_step, height, ov, w_ov,
        sgs, support, w_support, task_id, first_t, off_w_t, num_planes_t,
        num_slabs, num_octets, block_v, kernel.uv_kernel, kernel.w_kernel)
    counts, padded = arrays.pop("counts"), arrays.pop("padded")
    total, block_v = arrays.pop("total"), arrays.pop("block_v")
    num_blocks = total // block_v

    nonzero = np.nonzero(padded)[0]
    block_bucket = np.repeat(nonzero,
                             (padded[nonzero] // block_v)).astype(np.int32)
    visited = counts > 0

    # Optional trailing pad blocks re-visiting the last bucket with
    # all-zero taps (a device-count multiple for sharded drivers).
    extra = (-num_blocks) % pad_blocks_to
    if extra:
        block_bucket = np.concatenate(
            [block_bucket, np.full(extra, block_bucket[-1], np.int32)])
        pad_n = extra * block_v
        for name, a in arrays.items():
            arrays[name] = np.concatenate(
                [a, np.zeros((pad_n,) + a.shape[1:], a.dtype)])
        total += pad_n
        num_blocks += extra

    tasks = tuple(
        PackedTask(int(boxes[t, 1]), int(boxes[t, 2]), int(boxes[t, 0]),
                   int(first_t[t]))
        for t in range(num_tasks))
    arrays.update(block_bucket=block_bucket, visited=visited)
    # Every array the gridder consumes is covered, so plans differing
    # only in sub-cell fractions never alias in the gridder cache.
    digest_names = ("sort_index", "valid", "u_off", "iv0",
                    "u_frac", "v_frac", "w_row",
                    "block_bucket", "visited")
    task_bytes = "".join(repr(t) for t in tasks).encode()
    digest = native.hash_arrays(
        [arrays[n] for n in digest_names]
        + [np.frombuffer(task_bytes, np.uint8)])

    return PackedPlan(
        wplan=wplan, tasks=tasks, num_rows=num_rows,
        num_layers=num_layers, num_slabs=num_slabs, num_octets=num_octets,
        block_v=block_v, total=total, num_blocks=num_blocks,
        num_buckets=num_buckets, digest=digest, arrays=arrays)


@functools.lru_cache(maxsize=8)
def shard_plan(pplan: PackedPlan, num_shards: int, rank: int) -> PackedPlan:
    """Rank ``rank``'s sub-plan of ``num_shards`` (host, JAX packed.py:
    1185-1253): its contiguous range of ``num_blocks / num_shards``
    blocks, contiguous copies of those blocks' slots of every per-slot
    array, the tasks its blocks touch and the block -> bucket map
    re-based to the first of them. Blocks are bucket-sorted task-major,
    so a shard's blocks touch one contiguous task range; a task split
    between two shards is in both sub-plans, and the sum over the ranks
    adds its halves. The sub-plan keeps the whole plan's w-planes.
    Cached: a rank's drivers ask for it on every call."""
    nb = pplan.num_blocks
    if nb % num_shards:
        raise SdpInvalidArgumentError(
            f"num_blocks ({nb}) not divisible by {num_shards} devices — "
            f"build the plan with pad_blocks_to={num_shards}")
    if not 0 <= rank < num_shards:
        raise SdpInvalidArgumentError(
            f"rank {rank} outside [0, {num_shards})")
    bps = nb // num_shards
    per_task = pplan.num_slabs * pplan.num_octets
    bb = pplan.arrays["block_bucket"][rank * bps:(rank + 1) * bps].astype(
        np.int64)
    t0, t1 = int(bb[0] // per_task), int(bb[-1] // per_task)
    lo, hi = rank * bps * pplan.block_v, (rank + 1) * bps * pplan.block_v
    arrays = {name: np.ascontiguousarray(a[lo:hi])
              for name, a in pplan.arrays.items()
              if name not in ("block_bucket", "visited")}
    arrays["block_bucket"] = (bb - t0 * per_task).astype(np.int32)
    arrays["visited"] = pplan.arrays["visited"][
        t0 * per_task:(t1 + 1) * per_task].copy()
    whole = {f.name: getattr(pplan, f.name)
             for f in dataclasses.fields(PackedPlan)}
    return _ShardPlan(**{
        **whole, "tasks": pplan.tasks[t0:t1 + 1], "total": hi - lo,
        "num_blocks": bps, "num_buckets": (t1 - t0 + 1) * per_task,
        "digest": f"{pplan.digest}/{rank}of{num_shards}", "arrays": arrays,
        "plane_ids": pplan.w_plane_ids})


# ---------------------------------------------------------------------------
# Stage timing
# ---------------------------------------------------------------------------

# The stages of the timing reports: JAX's names, in JAX's order (JAX
# packed.py:1053-1054, :1128-1129).
GRID_STAGES = ("stack kernel", "stack -> layers", "ifft + w ladder + fft",
               "subgrid adds + correction")
DEGRID_STAGES = ("plane FFTs + screens", "cut-outs + ladder + layer fft",
                 "fused degrid kernel")
# The spin that holds the stream before a timed pass covers this many
# times the host's enqueue of one pass, and doubles at most this often.
_SPIN_MARGIN = 2.0
_SPIN_DOUBLINGS = 8


def _stage_times(stages, x, iters: int, device):
    """Time one pass through ``stages`` (each a function of the previous
    one's output, the first of ``x``): one warm-up pass, then ``iters``
    timed ones. Returns (seconds of each stage ``[iters, len(stages)]``,
    seconds of each whole pass ``[iters]``, the last pass's output).

    On a CUDA device the stages are device time: a ``torch.cuda.Event``
    before the first stage and one after each. The passes are host-bound
    (launch gaps between short kernels), so each is enqueued behind a
    spin (``torch.cuda._sleep``) of twice the host's measured enqueue time
    of one pass: the whole pass is queued before the card reaches its
    first event, and the events bracket device work only. A pass whose
    first event has fired by the end of its enqueue is taken again behind
    a spin twice as long; a stage that waits for the card so defeats
    every spin, and raises. Either way the stages add up to the pass by
    construction. On the CPU the same structure reads the host clock."""
    if iters < 1:
        raise SdpInvalidArgumentError(f"iters must be >= 1 (got {iters})")

    def one_pass(mark):
        out = x
        mark(0)
        for i, stage in enumerate(stages):
            out = stage(out)
            mark(i + 1)
        return out

    def ignore(_):
        pass

    out = one_pass(ignore)                                  # warm-up
    if device.type != "cuda":
        clocks = np.zeros((iters, len(stages) + 1))
        for row in clocks:
            def mark(i, row=row):
                row[i] = time.perf_counter()
            out = one_pass(mark)
        return np.diff(clocks, axis=1), clocks[:, -1] - clocks[:, 0], out

    with torch.cuda.device(device):
        # The host's enqueue of one pass, and the spin's cycles a second.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_pass(ignore)
        enqueue = time.perf_counter() - t0
        torch.cuda._sleep(1000)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        begin.record()
        torch.cuda._sleep(1 << 20)
        end.record()
        end.synchronize()
        spin = int(_SPIN_MARGIN * enqueue * (1 << 20) * 1e3
                   / begin.elapsed_time(end)) + 1
        passes = []
        for _ in range(iters):
            for _attempt in range(_SPIN_DOUBLINGS + 1):
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(len(stages) + 1)]
                torch.cuda.synchronize()
                torch.cuda._sleep(spin)
                out = one_pass(lambda i: events[i].record())
                if not events[0].query():
                    break
                spin *= 2
            else:
                raise SdpRuntimeError(
                    "stage timing: the pass's first event fired before "
                    "its last stage was enqueued behind a spin of "
                    f"{spin // 2} cycles: a stage waits for the card")
            passes.append(events)
        torch.cuda.synchronize()
    stage_s = np.asarray([[a.elapsed_time(b) / 1e3
                           for a, b in zip(ev, ev[1:])] for ev in passes])
    pass_s = np.asarray([ev[0].elapsed_time(ev[-1]) / 1e3 for ev in passes])
    return stage_s.reshape(iters, len(stages)), pass_s, out


# ---------------------------------------------------------------------------
# Device driver
# ---------------------------------------------------------------------------

# Bounded LRU: each gridder pins GB-scale band tensors on its device.
_GRIDDER_CACHE: dict = {}
_GRIDDER_CACHE_MAX = 4

# Defaults as in the JAX package: bf16 hi/lo "high" precision, band
# engine.
_DEFAULT_PRECISION = "high"
_DEFAULT_ENGINE = "auto"


def packed_gridder(pplan: PackedPlan, fast: bool = False,
                   precision: str = None, engine: str = None,
                   device=None) -> "PackedGridder":
    """Per-plan device driver, LRU-cached by (plan, resolved options,
    device). ``device=None`` is the CUDA card; CPU runs pass
    ``device="cpu"``."""
    # Resolve defaults BEFORE keying: packed_gridder(p) and
    # packed_gridder(p, precision="high") share one entry.
    if engine is None:
        engine = _DEFAULT_ENGINE
    if precision is None:
        precision = "bf16" if fast else _DEFAULT_PRECISION
    device = resolve_device(device)
    key = (pplan, bool(fast), precision, engine, str(device))
    g = _GRIDDER_CACHE.pop(key, None)
    if g is None:
        g = PackedGridder(pplan, fast=fast, precision=precision,
                          engine=engine, device=device)
    _GRIDDER_CACHE[key] = g          # re-insert: most-recently-used
    while len(_GRIDDER_CACHE) > _GRIDDER_CACHE_MAX:
        _GRIDDER_CACHE.pop(next(iter(_GRIDDER_CACHE)))
    return g


def _planes_to_image(planes, screens, correction):
    """Per-w-plane uv grids [P, N, N] -> corrected real image: one
    batched iFFT, the stacked screens and the shared PSWF correction."""
    stack = ifft_shifted_norm(planes)
    image = torch.einsum("puv,puv->uv", screens, stack)
    return (image * correction).real.to(torch.float32)


def _image_to_plane_stack(image, screens, correction):
    """Real image -> per-w-plane degrid-corrected uv grids [P, N, N]: the
    shared PSWF scale, the stacked conjugate screens and one batched
    FFT (the mirror of :func:`_planes_to_image`)."""
    base = image.to(torch.complex64) * correction
    return fft_shifted(base[None] * screens)


class _TowerImaging:
    """The stages around the stack kernels, on one device.

    ``self.pplan`` is a :class:`PackedPlan` or a streaming ``StreamPlan``
    (anything with ``wplan``, ``tasks``, ``num_layers`` and
    ``w_plane_ids``). :meth:`_init_imaging` builds the per-plan
    constants: the w-pattern ladders and per-task prefactors, the PSWF
    correction and the per-plane w-screens.
    """

    def _init_imaging(self):
        pplan = self.pplan
        plan = pplan.wplan
        kernel = plan.kernel()
        dev = self.device

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

        # Shared w-pattern ladders + per-task prefactors (host c128).
        w_pattern = kernel.w_pattern
        sw = plan.w_support
        karange = np.arange(pplan.num_layers)
        ladder_g = w_pattern[None] ** karange[:, None, None]
        ladder_d = w_pattern[None] ** (-karange[:, None, None])
        e0_g = np.asarray([t.first_w_plane + sw // 2 - sw
                           for t in pplan.tasks])
        e0_d = np.asarray([sw // 2 - t.first_w_plane
                           for t in pplan.tasks])
        pref_g = w_pattern[None] ** e0_g[:, None, None]
        pref_d = w_pattern[None] ** e0_d[:, None, None]
        self.ladder_grid = put(ladder_g.astype(np.complex64))
        self.ladder_degrid = put(ladder_d.astype(np.complex64))
        self.pref_grid = put(pref_g.astype(np.complex64))
        self.pref_degrid = put(pref_d.astype(np.complex64))

        # The PSWF correction as an f32 scale on the device, once per
        # plan: applying it through a per-call host->device copy would
        # stall the stream on every call.
        n = kernel.image_size
        self.correction = grid_correct_pswf(
            n, kernel.theta, kernel.w_step, kernel.shear_u, kernel.shear_v,
            kernel.support, kernel.w_support,
            torch.ones((n, n), dtype=torch.float32, device=dev))
        # Per-plane w-screens, static per plan: exp(+i ...) for the grid
        # correction, the conjugate for degridding.
        offs = np.asarray(self._plane_offsets(), np.float64)
        self.screens_grid = w_screen_stack(
            kernel.image_size, kernel.theta, kernel.w_step, kernel.shear_u,
            kernel.shear_v, offs, dtype=torch.complex64, device=dev)
        self.screens_degrid = w_screen_stack(
            kernel.image_size, kernel.theta, kernel.w_step, kernel.shear_u,
            kernel.shear_v, -offs, dtype=torch.complex64, device=dev)

    def _plane_offsets(self):
        plan = self.pplan.wplan
        return [int(np.trunc(iw * plan.w_tower_height))
                for iw in self.pplan.w_plane_ids]

    # -- grid ----------------------------------------------------------

    def _stage_drain(self, layers, ladder, pref):
        layers = ifft_shifted(layers)
        subgrids = torch.einsum("tkuv,kuv->tuv", layers, ladder) * pref
        return fft_shifted(subgrids)

    def _stage_planes(self, subgrids):
        """Task sub-grids -> per-w-plane uv grids [P, N, N] (before the
        image stages, where a sharded driver sums the ranks' planes)."""
        pplan = self.pplan
        plan = pplan.wplan
        n = plan.image_size
        sg_factor = (n / plan.subgrid_size) ** 2
        planes = torch.zeros((len(pplan.w_plane_ids), n, n),
                             dtype=torch.complex64, device=self.device)
        pos = {iw: i for i, iw in enumerate(pplan.w_plane_ids)}
        for t, task in enumerate(pplan.tasks):
            subgrid_add_static(
                planes[pos[task.iw]], -task.iu * plan.eff_sg_size,
                -task.iv * plan.eff_sg_size, subgrids[t], sg_factor)
        return planes

    def _planes_to_image(self, planes):
        return _planes_to_image(planes, self.screens_grid, self.correction)

    def _stack_to_layers(self, stack):
        """[T, 2, K*(G+8), G] stack -> [T, K, G, G] complex layers (the
        8-row octet overhang cropped)."""
        pplan = self.pplan
        g = pplan.wplan.subgrid_size
        st = stack.reshape(stack.shape[0], 2, pplan.num_layers,
                           g + 8, g)[:, :, :, :g, :]
        return torch.complex(st[:, 0], st[:, 1])

    def _layers_to_stack(self, layers):
        """[T, K, G, G] complex layers -> [T, 2, K*(G+8), G] f32 stack
        (zero 8-row u-pad per layer)."""
        pplan = self.pplan
        g = pplan.wplan.subgrid_size
        st = torch.stack([layers.real.to(torch.float32),
                          layers.imag.to(torch.float32)], dim=1)
        st = torch.nn.functional.pad(st, (0, 0, 0, 8))
        return st.reshape(layers.shape[0], 2, pplan.num_layers * (g + 8), g)

    def _stack_to_planes(self, stack, visited=None):
        """The grid stages after the kernel up to the w-plane grids: stack
        -> layers -> drain -> per-plane adds. ``visited`` ([T] bool)
        zeroes the layers of tasks no block visited."""
        layers = self._stack_to_layers(stack)
        if visited is not None:
            layers = torch.where(visited[:, None, None, None], layers, 0)
        subgrids = self._stage_drain(layers, self.ladder_grid,
                                     self.pref_grid)
        return self._stage_planes(subgrids)

    def _image_from_stack(self, stack, visited=None):
        """The grid stages after the kernel: :meth:`_stack_to_planes`,
        then the corrected image."""
        return self._planes_to_image(self._stack_to_planes(stack, visited))

    # -- degrid ---------------------------------------------------------

    def _dstage_planes(self, image):
        """Real image -> per-w-plane degrid-corrected uv grids [P, N, N]."""
        return _image_to_plane_stack(image, self.screens_degrid,
                                     self.correction)

    def _dstage_layers(self, plane_stack, ladder, pref):
        pplan = self.pplan
        plan = pplan.wplan
        pos = {iw: i for i, iw in enumerate(pplan.w_plane_ids)}
        subgrids = torch.stack([
            subgrid_cut_out_static(
                plane_stack[pos[task.iw]], task.iu * plan.eff_sg_size,
                task.iv * plan.eff_sg_size, plan.subgrid_size)
            for task in pplan.tasks]).to(torch.complex64)
        subgrids = ifft_shifted_norm(subgrids)
        layers = fft_shifted((subgrids * pref)[:, None, :, :] * ladder[None])
        return self._layers_to_stack(layers)

    def _model_stack(self, image):
        """Image on the device -> the task-major stack the degrid kernels
        read."""
        planes = self._dstage_planes(image)
        return self._dstage_layers(planes, self.ladder_degrid,
                                   self.pref_degrid)


class PackedGridder(_TowerImaging):
    """Per-plan device tensors and the whole-image grid/degrid drivers.

    ``grid``/``degrid`` take/return visibilities in the natural
    ``[rows, chan]`` layout; ``grid_sorted``/``degrid_sorted`` work on
    the plan's sorted stream (the major-cycle solver keeps residuals in
    sorted form). ``engine="bands"``/``"auto"`` stream pre-built tap
    bands through K1/K2; ``engine="fused"`` streams two packed int32 plan
    words per slot through K3/K4; ``engine="compact"`` streams the word
    ``pa`` and taps evaluated once per plan (92 B per slot to grid, 84 B
    to degrid) through K12/K13. The fused and compact engines take plans
    whose fields fit the words; others take the band engine, as in the
    JAX package. Compact runs "high" as "highest" (no pre-split
    streams) and degrids in bf16 only with ``fast``, as the JAX package
    does. ``device=None`` is the CUDA card; CPU runs pass
    ``device="cpu"``.
    """

    def __init__(self, pplan: PackedPlan, fast: bool = False,
                 precision: str = None, engine: str = None,
                 device=None):
        if engine is None:
            engine = _DEFAULT_ENGINE
        if engine not in ("auto", "bands", "fused", "compact"):
            raise SdpInvalidArgumentError(f"unknown engine {engine!r}")
        if precision is None:
            precision = "bf16" if fast else _DEFAULT_PRECISION
        self.pplan = pplan
        self.fast = bool(fast)
        self.precision = precision
        self.device = resolve_device(device)
        plan = pplan.wplan
        arrays = pplan.arrays
        if arrays is None:
            raise SdpInvalidArgumentError("plan has no host arrays")
        if pplan.total >= 2 ** 31 or arrays["sort_index"].max(
                initial=0) >= 2 ** 31:
            raise SdpInvalidArgumentError(
                "packed stream too large for int32 indexing")
        packable = fused_tap.fused_geometry_ok(
            plan.subgrid_size, plan.support, plan.oversampling,
            plan.w_oversampling)
        self.engine = engine if engine in ("fused", "compact") \
            and packable else "bands"
        if self.engine == "compact" and self.precision == "high":
            self.precision = "highest"
        # The imaging constants (image-sized, and the tasks'
        # prefactors) now; the per-slot device tensors on first use
        # (:attr:`slots`): a gridder that only drives its mesh shards
        # holds none of them, only its shards' own.
        self._init_imaging()

    @functools.cached_property
    def inv_index(self):
        pplan = self.pplan
        return torch.as_tensor(inverse_index_of(
            pplan.arrays["sort_index"], pplan.arrays["valid"],
            pplan.num_rows * pplan.wplan.num_chan)).to(self.device)

    @functools.cached_property
    def slots(self) -> types.SimpleNamespace:
        """The per-slot device tensors, built on first use: the sort
        (``sort_index``, ``valid``), the per-block (task, w-slab,
        u-octet) (``t_idx``, ``k_idx``, ``g_idx``) and the tasks they
        visit, and the engine's slot streams and run table (``pa``,
        ``pb``, ``ubase``, ``vband``, ``vband_t``, ``uk_t``, ``vk_t``,
        ``wk_t``, ``runs``, ``uv_coeffs``, ``w_coeffs``; None where the
        engine has none)."""
        pplan = self.pplan
        plan = pplan.wplan
        arrays = pplan.arrays
        dev = self.device
        s = types.SimpleNamespace()

        def put(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=dtype).to(dev)

        s.sort_index = put(arrays["sort_index"], torch.int64)
        s.valid = put(arrays["valid"])
        # Per-block (task, w-slab, u-octet) for the stack kernels.
        bb = arrays["block_bucket"].astype(np.int64)
        s.g_idx = put(bb % pplan.num_octets, torch.int32)
        s.k_idx = put((bb // pplan.num_octets) % pplan.num_slabs,
                      torch.int32)
        task = bb // (pplan.num_octets * pplan.num_slabs)
        s.t_idx = put(task, torch.int32)
        # The tasks a block visits (all of a whole plan's; a shard's
        # sub-plan masks the others' stacks, JAX packed.py:1325-1327).
        visited = np.zeros(len(pplan.tasks), bool)
        visited[task] = True
        s.task_visited = put(visited)

        uv_c = _tap_coeffs_cached(plan.support, plan.oversampling)
        w_c = _tap_coeffs_cached(plan.w_support, plan.w_oversampling)
        s.pa = s.pb = s.ubase = s.vband = s.vband_t = None
        s.uk_t = s.vk_t = s.wk_t = s.runs = None
        s.uv_coeffs = s.w_coeffs = None
        if self.engine != "bands":
            # The window kernels' work units (K3/K4, K12/K13), once per
            # plan: the blocks' window runs in parts (the band engine's are
            # K1/K2's maximal runs).
            s.runs = degrid_runs((s.t_idx, s.k_idx, s.g_idx))
        if self.engine == "compact":
            # The word pa and the taps, evaluated once on the device.
            pa, _ = fused_tap.pack_plan_words(
                arrays["iv0"], arrays["u_off"], arrays["w_row"],
                arrays["u_frac"], arrays["v_frac"], arrays["valid"])
            s.pa = put(pa)
            s.uk_t = eval_kernel_taps(put(arrays["u_frac"]), uv_c,
                                      plan.oversampling).T.contiguous()
            s.vk_t = eval_kernel_taps(put(arrays["v_frac"]), uv_c,
                                      plan.oversampling).T.contiguous()
            s.wk_t = torch.where(
                s.valid[:, None],
                eval_kernel_taps(put(arrays["w_row"]), w_c,
                                 plan.w_oversampling), 0.0).T.contiguous()
        elif self.engine == "fused":
            # Two plan words per slot; the kernels evaluate the taps.
            pa, pb = fused_tap.pack_plan_words(
                arrays["iv0"], arrays["u_off"], arrays["w_row"],
                arrays["u_frac"], arrays["v_frac"], arrays["valid"])
            s.pa, s.pb = put(pa), put(pb)
            s.uv_coeffs = put(uv_c, torch.float32)
            s.w_coeffs = put(w_c, torch.float32)
        else:
            self._init_bands(s, arrays, put, uv_c, w_c)
        return s

    def _init_bands(self, s, arrays, put, uv_c, w_c):
        """Taps evaluated on the device from the plan's integer kernel
        rows (Chebyshev fits, ~1e-13 of the f64 tables), then placed into
        the bands once per plan."""
        plan = self.pplan.wplan
        uk = eval_kernel_taps(put(arrays["u_frac"]), uv_c,
                              plan.oversampling)
        vk = eval_kernel_taps(put(arrays["v_frac"]), uv_c,
                              plan.oversampling)
        wk = torch.where(
            s.valid[:, None],
            eval_kernel_taps(put(arrays["w_row"]), w_c,
                             plan.w_oversampling), 0.0)
        s.ubase, vband, vband_t = build_bands(
            put(arrays["u_off"]), put(arrays["iv0"]), uk, vk,
            plan.subgrid_size)
        del uk, vk
        if self.precision == "high":
            # bf16 hi/lo halves (same bytes as f32): three bf16
            # products with f32 sums in the kernels.
            vband = split_bf16(vband)
            vband_t = split_bf16(vband_t)
        elif self.fast:
            vband = vband.to(torch.bfloat16)
            vband_t = vband_t.to(torch.bfloat16)
        s.vband, s.vband_t = vband, vband_t
        s.wk_t = wk.T.contiguous()                          # [Sw, V]
        # K1/K2's work units: the plan's bucket runs, once per plan.
        s.runs = bucket_runs(s.t_idx, s.k_idx, s.g_idx)

    # -- sorted-stream transforms ------------------------------------

    def sort(self, vis):
        """[rows, chan] visibilities -> sorted-stream (re, im) f32."""
        s = self.slots
        vis_s = to_device(vis, self.device).reshape(-1)[s.sort_index]
        if not vis_s.is_complex():
            vis_s = vis_s.to(torch.complex64)
        vre = torch.where(s.valid, vis_s.real, 0.0).to(torch.float32)
        vim = torch.where(s.valid, vis_s.imag, 0.0).to(torch.float32)
        return vre, vim

    def unsort(self, vis_sorted: torch.Tensor) -> torch.Tensor:
        """Sorted-stream complex vis -> [rows, chan]; unassigned entries
        read the appended zero slot."""
        out_padded = torch.cat([vis_sorted, vis_sorted.new_zeros(1)])
        return out_padded[self.inv_index].reshape(
            self.pplan.num_rows, self.pplan.wplan.num_chan)

    # -- grid ----------------------------------------------------------

    def _stage_kernel(self, vre, vim):
        s = self.slots
        pplan = self.pplan
        plan = pplan.wplan
        if self.engine == "compact":
            return fused_tap.grid_compact(
                s.t_idx, s.k_idx, s.g_idx, s.pa, s.uk_t,
                s.vk_t, s.wk_t, vre, vim, len(pplan.tasks),
                pplan.num_layers, plan.subgrid_size, plan.support,
                plan.w_support, block_v=pplan.block_v,
                precision=self.precision, runs=s.runs)
        if self.engine == "fused":
            return fused_tap.grid_fused_stack(
                s.t_idx, s.k_idx, s.g_idx, s.pa, s.pb, vre,
                vim, s.uv_coeffs, s.w_coeffs, len(pplan.tasks),
                pplan.num_layers, plan.subgrid_size, plan.support,
                plan.w_support, plan.oversampling, plan.w_oversampling,
                block_v=pplan.block_v, precision=self.precision,
                runs=s.runs)
        return grid_packed_stack(
            s.t_idx, s.k_idx, s.g_idx, s.ubase, s.vband,
            (s.wk_t, vre, vim), len(pplan.tasks), pplan.num_layers,
            plan.subgrid_size, plan.w_support, block_v=pplan.block_v,
            runs=s.runs)

    def grid_sorted(self, vre: torch.Tensor,
                    vim: torch.Tensor) -> torch.Tensor:
        """Sorted-stream (re, im) f32 -> real dirty image (f32). Every
        packed task has at least one visibility, so every task's stack
        is accumulated by the kernel."""
        return self._image_from_stack(self._stage_kernel(vre, vim))

    def grid(self, vis) -> torch.Tensor:
        """[rows, chan] visibilities -> real dirty image."""
        vre, vim = self.sort(vis)
        return self.grid_sorted(vre, vim)

    # -- degrid ---------------------------------------------------------

    def _dstage_kernel(self, st):
        s = self.slots
        pplan = self.pplan
        plan = pplan.wplan
        if self.engine == "compact":
            return fused_tap.degrid_compact(
                st, s.t_idx, s.k_idx, s.g_idx, s.pa, s.uk_t,
                s.vk_t, s.wk_t, plan.support, plan.w_support,
                block_v=pplan.block_v,
                precision="bf16" if self.fast else "highest", runs=s.runs)
        if self.engine == "fused":
            return fused_tap.degrid_fused2_stack(
                st, s.t_idx, s.k_idx, s.g_idx, s.pa, s.pb,
                s.uv_coeffs, s.w_coeffs, plan.support, plan.w_support,
                plan.oversampling, plan.w_oversampling,
                block_v=pplan.block_v, precision=self.precision,
                runs=s.runs)
        return degrid_stack(
            st, s.t_idx, s.k_idx, s.g_idx, s.ubase,
            s.vband_t, s.wk_t, plan.w_support, block_v=pplan.block_v,
            runs=s.runs)

    def degrid_sorted(self, image) -> torch.Tensor:
        """Real/complex image -> sorted-stream complex64 visibilities."""
        return self._dstage_kernel(
            self._model_stack(to_device(image, self.device)))

    def degrid(self, image) -> torch.Tensor:
        """Image -> [rows, chan] complex64 visibilities."""
        return self.unsort(self.degrid_sorted(image))

    # -- stage timing reports (JAX packed.py:1005-1158) -----------------

    def _grid_stages(self):
        """:data:`GRID_STAGES` as functions of the previous stage's
        output, the first of ``(vre, vim)``: what :meth:`grid_sorted`
        runs."""
        return (lambda v: self._stage_kernel(*v),
                self._stack_to_layers,
                lambda layers: self._stage_drain(layers, self.ladder_grid,
                                                 self.pref_grid),
                lambda subgrids: self._planes_to_image(
                    self._stage_planes(subgrids)))

    def _degrid_stages(self):
        """:data:`DEGRID_STAGES` as functions, the first of the image on
        the device: what :meth:`degrid_sorted` runs."""
        return (self._dstage_planes,
                lambda planes: self._dstage_layers(
                    planes, self.ladder_degrid, self.pref_degrid),
                self._dstage_kernel)

    def _report(self, what, names, seconds, print_fn):
        clock = "device" if self.device.type == "cuda" else "host"
        timers = Timers(f"{what} (packed) {clock} time / call",
                        TimerType.DEVICE, device=self.device)
        for name, sec in zip(names, seconds):
            timers.record(name, sec)
        root = timers._root.timer
        root.reset()
        root._elapsed = float(np.sum(seconds))
        if print_fn is not None:
            pplan = self.pplan
            plan = pplan.wplan
            print_fn(
                f"# image {plan.image_size}^2, subgrid "
                f"{plan.subgrid_size}, {len(pplan.tasks)} tasks, "
                f"{len(pplan.w_plane_ids)} w-planes, "
                f"{pplan.num_layers} tower layers, {pplan.total} stream "
                f"slots ({pplan.num_blocks} blocks), w_step "
                f"{plan.w_step}, tower height {plan.w_tower_height}")
        timers.report(print_fn)
        return dict(zip(names, (float(sec) for sec in seconds)))

    def report_timing(self, vre, vim, iters: int = 10,
                      print_fn=print) -> Dict[str, float]:
        """Per-stage report of one grid pass (the reference's per-run
        report, sdp_grid_wstack_wtower.cpp:169-213): the seconds of each
        of :data:`GRID_STAGES`, each the mean over ``iters`` passes after
        a warm-up, recorded into a :class:`Timers` tree whose root is
        their sum, printed after a line of the plan's geometry, and
        returned as a dict. The stages run what :meth:`grid_sorted` runs.
        On a CUDA device they are device time, taken by CUDA events
        inside each pass behind a spin that covers the host's enqueue
        (:func:`_stage_times`); on the CPU, host time. Unlike JAX's report
        (differences of separately timed prefixes), the stages add up to
        the pass."""
        v = (to_device(vre, self.device), to_device(vim, self.device))
        stage_s, _, _ = _stage_times(self._grid_stages(), v, iters,
                                     self.device)
        return self._report("grid_all", GRID_STAGES, stage_s.mean(0),
                            print_fn)

    def report_timing_degrid(self, image, iters: int = 10,
                             print_fn=print) -> Dict[str, float]:
        """The mirror of :meth:`report_timing` for one degrid pass
        (:data:`DEGRID_STAGES`, what :meth:`degrid_sorted` runs)."""
        stage_s, _, _ = _stage_times(self._degrid_stages(),
                                     to_device(image, self.device), iters,
                                     self.device)
        return self._report("degrid_all", DEGRID_STAGES, stage_s.mean(0),
                            print_fn)


    # -- mesh-sharded drivers (JAX packed.py:1160-1473) -----------------
    #
    # Each rank passes and gets back its own block of the sorted stream
    # (``num_blocks / n`` blocks of ``block_v`` slots, n the size of the
    # mesh's ``axis_name``), runs this gridder's engine on its shard's
    # sub-plan (:func:`shard_plan`) on its own device, and the grid sums
    # the ranks' w-plane grids with one ``all_reduce`` before the image
    # stages, so every rank returns the same bits.

    def _shard(self, num_shards: int, rank: int) -> "PackedGridder":
        """The gridder of rank ``rank``'s sub-plan of ``num_shards``
        (from :func:`packed_gridder`'s cache): this gridder's engine and
        precision on its device, holding only that rank's slots."""
        return packed_gridder(shard_plan(self.pplan, num_shards, rank),
                              fast=self.fast, precision=self.precision,
                              engine=self.engine, device=self.device)

    def _mesh_shard(self, mesh, axis_name):
        n, rank, group = mesh_axis(mesh, axis_name)
        return self._shard(n, rank), group

    def sort_sharded(self, vis, mesh, axis_name: str = ROW_AXIS):
        """[rows, chan] visibilities (the whole array) -> this rank's
        block of the sorted stream (re, im) f32."""
        return self._mesh_shard(mesh, axis_name)[0].sort(vis)

    def grid_sorted_sharded(self, vre: torch.Tensor, vim: torch.Tensor,
                            mesh, axis_name: str = ROW_AXIS) -> torch.Tensor:
        """This rank's block of the sorted stream (re, im) f32 -> the real
        dirty image of the whole stream, on every rank."""
        shard, group = self._mesh_shard(mesh, axis_name)
        planes = shard._stack_to_planes(shard._stage_kernel(vre, vim),
                                        shard.slots.task_visited)
        dist.all_reduce(torch.view_as_real(planes), group=group)
        return shard._planes_to_image(planes)

    def grid_sharded(self, vis, mesh,
                     axis_name: str = ROW_AXIS) -> torch.Tensor:
        """[rows, chan] visibilities (the whole array) -> the real dirty
        image, on every rank; each rank grids its own block."""
        vre, vim = self.sort_sharded(vis, mesh, axis_name)
        return self.grid_sorted_sharded(vre, vim, mesh, axis_name)

    def degrid_sorted_sharded(self, image, mesh,
                              axis_name: str = ROW_AXIS) -> torch.Tensor:
        """The replicated image -> this rank's block of the sorted-stream
        complex64 visibilities (no collective)."""
        shard, _ = self._mesh_shard(mesh, axis_name)
        return shard.degrid_sorted(image)

    def degrid_sharded(self, image, mesh,
                       axis_name: str = ROW_AXIS) -> torch.Tensor:
        """The replicated image -> [rows, chan] complex64 visibilities, on
        every rank: the ranks' blocks, gathered in rank order, unsorted."""
        local = self.degrid_sorted_sharded(image, mesh, axis_name)
        return self.unsort(gather_rows(local, mesh, axis_name=axis_name))

class _MeshDrivers:
    """A gridder's mesh-sharded drivers under the single-device names
    (``sort``, ``grid``, ``grid_sorted``, ``degrid_sorted``), so code
    written against one device runs each rank's block unchanged."""

    def __init__(self, gridder: PackedGridder, mesh,
                 axis_name: str = ROW_AXIS):
        self.gridder, self.mesh, self.axis_name = gridder, mesh, axis_name

    def sort(self, vis):
        return self.gridder.sort_sharded(vis, self.mesh, self.axis_name)

    def grid(self, vis):
        return self.gridder.grid_sharded(vis, self.mesh, self.axis_name)

    def grid_sorted(self, vre, vim):
        return self.gridder.grid_sorted_sharded(vre, vim, self.mesh,
                                                self.axis_name)

    def degrid_sorted(self, image):
        return self.gridder.degrid_sorted_sharded(image, self.mesh,
                                                  self.axis_name)

# ---------------------------------------------------------------------------
# Functional API (JAX parallel/packed.py:1480-1496)
# ---------------------------------------------------------------------------

def grid_all_packed(pplan: PackedPlan, vis, fast: bool = False,
                    precision: str = None, device=None) -> torch.Tensor:
    """Whole-image gridding through the packed path on ``device``
    (``None``: the CUDA card). Returns the real dirty image (f32)."""
    return packed_gridder(pplan, fast, precision=precision,
                          device=device).grid(vis)


def degrid_all_packed(pplan: PackedPlan, image, fast: bool = False,
                      precision: str = None, device=None) -> torch.Tensor:
    """Whole-image degridding through the packed path on ``device``
    (``None``: the CUDA card). Returns [rows, chan] complex64
    visibilities."""
    return packed_gridder(pplan, fast, precision=precision,
                          device=device).degrid(image)


def grid_all_packed_sharded(pplan: PackedPlan, vis, mesh,
                            axis_name: str = ROW_AXIS, fast: bool = False,
                            device=None) -> torch.Tensor:
    """Mesh-sharded packed gridding (blocks sharded, w-plane grids summed
    over the ranks) on ``device`` (``None``: the mesh's,
    :func:`.mesh.mesh_device`). ``vis`` is the whole [rows, chan] array;
    every rank returns the image. The plan must be built with
    ``pad_blocks_to`` the size of the mesh's ``axis_name``."""
    device = mesh_device(mesh) if device is None else device
    return packed_gridder(pplan, fast, device=device).grid_sharded(
        vis, mesh, axis_name)


def degrid_all_packed_sharded(pplan: PackedPlan, image, mesh,
                              axis_name: str = ROW_AXIS, fast: bool = False,
                              device=None) -> torch.Tensor:
    """Mesh-sharded packed degridding of the replicated image: each rank
    degrids its blocks, and every rank returns the [rows, chan]
    complex64 visibilities."""
    device = mesh_device(mesh) if device is None else device
    return packed_gridder(pplan, fast, device=device).degrid_sharded(
        image, mesh, axis_name)
