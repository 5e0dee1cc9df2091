"""W-towers tap gridding / degridding: CUDA kernels and plain twins.

Counterpart of ska_sdp_func_tpu.kernels.pallas_tap. Its four Pallas
entry points share two kernel bodies (``_grid_kernel``,
``_degrid_kernel``); here the per-plane pair and the all-layer pair have
hand-written CUDA kernels of their own (built by :mod:`._build`):

- :func:`grid_plane` replaces ``grid_plane_pallas`` (K14) and
  :func:`degrid_plane` replaces ``degrid_plane_pallas`` (K15): the task
  drivers' kernels in ``csrc/plane_tap.cu``. They read the plane
  geometry and the kernel tables directly, compact the plane's active
  entries on the device (no host sync) and touch only those: the grid
  kernel accumulates into a shared-memory stack and adds it into a copy
  of the complex64 input stack, the degrid kernel zeroes the [R, C]
  result and writes one value per active entry.
- :func:`grid_all_layers_tasks` replaces ``grid_all_layers_pallas``
  (K16) and :func:`degrid_all_layers_tasks` replaces
  ``degrid_all_layers_pallas`` (K17) for a whole stream of tasks at once:
  ``tower_grid_tasks_kernel`` and ``tower_degrid_tasks_kernel`` in
  ``csrc/tower_tap.cu``, on flat per-slot taps: ``iu0``/``iv0`` [V] int32
  sub-grid cells, ``uk``/``vk`` [V, S] f32 kernel taps and ``weights``
  [V, Kw] f32, the w-kernel value of each slot for each layer of its task
  (zero outside its layers), with a :class:`TaskTable` that gives each
  task its slots, its layer count and its planes in one complex64 stack.
  The JAX package launches one Pallas kernel per task; on the card one
  launch takes every task of a call. :func:`grid_all_layers` and
  :func:`degrid_all_layers` (one task, the JAX signatures) launch the
  same two kernels with a one-task table.

Taps that fall outside the ``[N, N]`` sub-grid are dropped. Arithmetic
is f32 throughout, the Pallas kernels' ``Precision.HIGHEST``; only the
order of the sums differs (and, for the grid kernels' atomics, varies
from run to run).

``fast=True`` is the bf16 mode, the Pallas kernels' ``fast`` (one bf16
pass per dot, ``Precision.DEFAULT``): exactly the operands of their dots
are rounded to bf16, and products and sums stay f32. Grid: each term is
``bf16(uk[a] * s) * bf16(vk[b])`` with ``s = weight * vis`` and ``uk[a] *
s`` rounded once in f32 first; degrid: ``(bf16(uk[a]) * bf16(cell)) *
vk[b]``, weighted by the f32 ``weight`` (``vk`` and the weights are not
rounded). The plain versions round the same operands with
``torch.bfloat16``.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain PyTorch version (``*_reference``). Each counts
its own kernel launches in ``.launches``. ``block_v`` (the Pallas block
size) is accepted for the JAX signatures; the kernels ignore it (the
plain versions of the per-plane pair pass it on).
"""

from typing import NamedTuple

import torch

from ..utility.errors import (
    SdpDataTypeError,
    SdpInvalidArgumentError,
    SdpMemLocationError,
    SdpShapeError,
)
from .dense_tap import band_matrix, degrid_plane_dense, flatten_geom, \
    grid_plane_dense
from .packed_tap import _full_f32_matmul


def _plane_taps(uv_kernel, w_kernel, geom):
    """Flat f32 taps of one plane; ``wk`` zeroed on masked entries."""
    mask, iu0, iv0, uk, vk, wk = flatten_geom(geom, uv_kernel, w_kernel)
    wk = torch.where(mask[:, None], wk.to(torch.float32), 0.0)
    return (mask, iu0.to(torch.int32).contiguous(),
            iv0.to(torch.int32).contiguous(),
            uk.to(torch.float32).contiguous(),
            vk.to(torch.float32).contiguous(), wk.contiguous())


def _device(*tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise SdpMemLocationError(
                f"operands on {t.device} and {dev}: all must share a device")
    if dev.type not in ("cpu", "cuda"):
        raise SdpMemLocationError(f"unsupported device {dev}")
    return dev


def _check_taps(iu0, iv0, uk, vk, weights):
    total = iu0.shape[0]
    support = uk.shape[1] if uk.ndim == 2 else -1
    for name, t, dtype, shape in (
            ("iu0", iu0, torch.int32, (total,)),
            ("iv0", iv0, torch.int32, (total,)),
            ("uk", uk, torch.float32, (total, support)),
            ("vk", vk, torch.float32, (total, support)),
            ("weights", weights, torch.float32,
             (total, weights.shape[-1]))):
        if t.dtype != dtype:
            raise SdpDataTypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise SdpShapeError(
                f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise SdpInvalidArgumentError(f"{name} must be contiguous")
    if weights.ndim != 2 or support < 1:
        raise SdpShapeError("uk/vk must be [V, S] and weights [V, K]")


# ---------------------------------------------------------------------------
# Per-plane entry points (K14, K15)
# ---------------------------------------------------------------------------

def _masked_vis(vis, mask):
    """One plane's visibilities as f32 (re, im) [V], zero where masked."""
    vis_f = vis.reshape(-1)
    return (torch.where(mask, vis_f.real, 0.0).to(torch.float32).contiguous(),
            torch.where(mask, vis_f.imag, 0.0).to(torch.float32).contiguous())


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` contiguous in ``dtype``: itself where it already is (the task
    drivers' geometry and tables), so that the wrappers copy nothing."""
    if t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


def _launch_plane(entry: str, data, uv_kernel, w_kernel, geom, support: int,
                  w_support: int, size: int, fast: bool, out) -> None:
    """``plane_grid_kernel`` / ``plane_degrid_kernel`` (after the shared
    compaction) via ``entry``: ``data`` is the visibilities (grid) or the
    stack (degrid), complex64 and contiguous; ``out`` the complex64
    stack to add into (grid) or the [V] result (degrid)."""
    from . import _build

    total = geom[0].numel()
    mask = _as(geom[0], torch.bool)
    idx = [_as(g, torch.int32) for g in geom[1:]]
    for name, g in zip(("iu0", "iv0", "u_row", "v_row", "w_row"), idx):
        if g.numel() != total:
            raise SdpShapeError(
                f"{name} has {g.numel()} entries, the mask {total}")
    uv_kernel = _as(uv_kernel, torch.float32)
    w_kernel = _as(w_kernel, torch.float32)
    if uv_kernel.ndim != 2 or uv_kernel.shape[1] != support \
            or w_kernel.ndim != 2 or w_kernel.shape[1] != w_support:
        raise SdpShapeError(
            f"tables {tuple(uv_kernel.shape)}, {tuple(w_kernel.shape)}: "
            f"expected [rows, {support}] and [rows, {w_support}]")
    lib = _build.load()
    work = torch.empty(total + 1, dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            mask.data_ptr(), *(g.data_ptr() for g in idx), data.data_ptr(),
            uv_kernel.data_ptr(), uv_kernel.shape[0], w_kernel.data_ptr(),
            w_kernel.shape[0], total, support, w_support, size, int(fast),
            work.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, err, entry)


def grid_plane_reference(subgrids, vis, uv_kernel, w_kernel, geom,
                         support: int, w_support: int, block_v: int = 2048,
                         fast: bool = False) -> torch.Tensor:
    """Plain version of :func:`grid_plane`: the dense banded products
    on f32 tables and complex64 visibilities; with ``fast``, the bf16
    plain version of :func:`grid_all_layers` on the plane's flat taps (the
    kernel's own operands)."""
    if fast:
        mask, iu0, iv0, uk, vk, wk = _plane_taps(uv_kernel, w_kernel, geom)
        out = grid_all_layers_reference(
            *_masked_vis(vis, mask), iu0, iv0, uk, vk, wk, w_support,
            subgrids.shape[-1], support, block_v, fast=True)
        return subgrids + out.to(subgrids.dtype)
    with _full_f32_matmul():
        out = grid_plane_dense(
            torch.zeros_like(subgrids, dtype=torch.complex64),
            vis.to(torch.complex64), uv_kernel.to(torch.float32),
            w_kernel.to(torch.float32), geom, support, w_support)
    return subgrids + out.to(subgrids.dtype)


def grid_plane(subgrids, vis, uv_kernel, w_kernel, geom, support: int,
               w_support: int, block_v: int = 2048,
               fast: bool = False) -> torch.Tensor:
    """Grid one w-plane's [R, C] visibilities into the ``[Sw, N, N]``
    tower stack (f32 compute, or the bf16 mode with ``fast``); returns
    ``subgrids + contribution``. The kernel ignores ``block_v``."""
    dev = _device(subgrids, vis, uv_kernel, w_kernel, *geom)
    if dev.type == "cpu":
        return grid_plane_reference(subgrids, vis, uv_kernel, w_kernel,
                                    geom, support, w_support, block_v, fast)
    size = subgrids.shape[-1]
    if tuple(subgrids.shape) != (w_support, size, size) \
            or vis.numel() != geom[0].numel():
        raise SdpShapeError(
            f"stack {tuple(subgrids.shape)} and {vis.numel()} visibilities "
            f"for a [{w_support}, N, N] stack and {geom[0].numel()} entries")
    c64 = subgrids.dtype == torch.complex64
    # The kernel adds into a copy of the stack (or, for another dtype, into
    # zeros that are added after).
    out = subgrids.clone(memory_format=torch.contiguous_format) if c64 \
        else torch.zeros(subgrids.shape, dtype=torch.complex64, device=dev)
    _launch_plane("sdp_torch_plane_grid", _as(vis, torch.complex64),
                  uv_kernel, w_kernel, geom, support, w_support, size, fast,
                  out)
    grid_plane.launches += 1
    return out if c64 else subgrids + out.to(subgrids.dtype)


grid_plane.launches = 0


def degrid_plane_reference(subgrids, uv_kernel, w_kernel, geom,
                           support: int, w_support: int, block_v: int = 1024,
                           fast: bool = False) -> torch.Tensor:
    """Plain version of :func:`degrid_plane`: the dense banded products
    on f32 tables and a complex64 stack; with ``fast``, the bf16 plain
    version of :func:`degrid_all_layers` on the plane's flat taps."""
    if fast:
        mask, iu0, iv0, uk, vk, wk = _plane_taps(uv_kernel, w_kernel, geom)
        vis = degrid_all_layers_reference(subgrids, iu0, iv0, uk, vk, wk,
                                          support, block_v, fast=True)
        vis = torch.where(mask, vis, torch.zeros((), dtype=vis.dtype,
                                                 device=vis.device))
        return vis.to(subgrids.dtype).reshape(geom[0].shape)
    with _full_f32_matmul():
        vis = degrid_plane_dense(
            subgrids.to(torch.complex64), uv_kernel.to(torch.float32),
            w_kernel.to(torch.float32), geom, support, w_support)
    return vis.to(subgrids.dtype)


def degrid_plane(subgrids, uv_kernel, w_kernel, geom, support: int,
                 w_support: int, block_v: int = 1024,
                 fast: bool = False) -> torch.Tensor:
    """Degrid one w-plane's [R, C] visibilities from the ``[Sw, N, N]``
    tower stack (f32 compute, or the bf16 mode with ``fast``); masked
    entries are zero. The kernel ignores ``block_v``."""
    dev = _device(subgrids, uv_kernel, w_kernel, *geom)
    if dev.type == "cpu":
        return degrid_plane_reference(subgrids, uv_kernel, w_kernel, geom,
                                      support, w_support, block_v, fast)
    size = subgrids.shape[-1]
    if tuple(subgrids.shape) != (w_support, size, size):
        raise SdpShapeError(f"stack {tuple(subgrids.shape)}, expected "
                            f"[{w_support}, N, N]")
    out = torch.empty(geom[0].shape, dtype=torch.complex64, device=dev)
    _launch_plane("sdp_torch_plane_degrid", _as(subgrids, torch.complex64),
                  uv_kernel, w_kernel, geom, support, w_support, size, fast,
                  out)
    degrid_plane.launches += 1
    return out if subgrids.dtype == torch.complex64 \
        else out.to(subgrids.dtype)


degrid_plane.launches = 0


# ---------------------------------------------------------------------------
# All-layer entry points (K16, K17)
# ---------------------------------------------------------------------------

class TaskTable(NamedTuple):
    """The tasks of one all-layer call (built by :func:`task_table`).

    ``rows``: per task, in slot order, ``(start, count, num_layers,
    base)`` on the host: its slots ``[start, start + count)`` of the
    stream and its planes ``[base, base + num_layers)`` of the stack.
    ``table``: the rows as int32 [T, 4]; ``layer_map``: int32 [planes, 2],
    the (row, layer) of each grid CTA, the largest tasks first; both on
    the device the kernels run on. ``planes``: the stack's layer count.
    """
    rows: tuple
    table: torch.Tensor
    layer_map: torch.Tensor
    planes: int


def task_table(rows, device=None) -> TaskTable:
    """A :class:`TaskTable` of ``rows`` ``(start, count, num_layers,
    base)`` in slot order, its tensors on ``device``: the slot ranges must
    not overlap, and the plane ranges must tile ``[0, sum num_layers)``."""
    rows = tuple(tuple(int(x) for x in r) for r in rows)
    if not rows or any(len(r) != 4 for r in rows):
        raise SdpInvalidArgumentError(
            "a task table needs (start, count, num_layers, base) rows")
    end = 0
    for start, count, num_layers, _ in rows:
        if start < end or count < 0 or num_layers < 1:
            raise SdpInvalidArgumentError(
                f"task ({start}, {count}, {num_layers}): starts must "
                f"ascend past the previous task's slots, counts be >= 0 "
                f"and layer counts >= 1")
        end = start + count
    if end > 2 ** 31 - 1:
        raise SdpInvalidArgumentError(f"{end} slots exceed int32")
    planes = 0
    for base, num_layers in sorted((r[3], r[2]) for r in rows):
        if base != planes:
            raise SdpInvalidArgumentError(
                "the tasks' plane ranges must tile the stack")
        planes += num_layers
    order = sorted(range(len(rows)), key=lambda t: -rows[t][1])
    layer_map = [(t, k) for t in order for k in range(rows[t][2])]
    return TaskTable(
        rows, torch.tensor(rows, dtype=torch.int32, device=device),
        torch.tensor(layer_map, dtype=torch.int32, device=device), planes)


def _check_tasks(tasks: TaskTable, weights) -> None:
    total, w_cols = weights.shape
    last = tasks.rows[-1]
    if last[0] + last[1] > total or max(r[2] for r in tasks.rows) > w_cols:
        raise SdpShapeError(
            f"the task table needs {last[0] + last[1]} slots and "
            f"{max(r[2] for r in tasks.rows)} weight columns; the taps have "
            f"{total} and {w_cols}")


def _launch_grid_tasks(vis_re, vis_im, iu0, iv0, uk, vk, weights,
                       tasks, planes: int, size: int,
                       fast: bool) -> torch.Tensor:
    """``tower_grid_tasks_kernel`` -> complex64 ``[planes, size, size]``;
    ``tasks`` None is one task over every slot."""
    from . import _build

    _check_taps(iu0, iv0, uk, vk, weights)
    total, w_cols = weights.shape
    for name, t in (("vis_re", vis_re), ("vis_im", vis_im)):
        if t.dtype != torch.float32 or tuple(t.shape) != (total,) \
                or not t.is_contiguous():
            raise SdpInvalidArgumentError(
                f"{name} must be contiguous f32 [{total}]")
    if size <= 0:
        raise SdpInvalidArgumentError(f"need a size > 0 (got {size})")
    lib = _build.load()
    out = torch.empty((planes, size, size), dtype=torch.complex64,
                      device=uk.device)
    with torch.cuda.device(uk.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_tower_grid_tasks(
            vis_re.data_ptr(), vis_im.data_ptr(), iu0.data_ptr(),
            iv0.data_ptr(), uk.data_ptr(), vk.data_ptr(), weights.data_ptr(),
            None if tasks is None else tasks.table.data_ptr(),
            None if tasks is None else tasks.layer_map.data_ptr(), planes,
            total, uk.shape[1], w_cols, size, int(fast), out.data_ptr(),
            stream)
    _build.check(lib, err, "tower_grid_tasks_kernel")
    return out


def _launch_degrid_tasks(layers, iu0, iv0, uk, vk, weights, tasks,
                         fast: bool) -> torch.Tensor:
    """``tower_degrid_tasks_kernel`` on complex64 ``[planes, N, N]``
    layers -> complex64 [V]; ``tasks`` None is one task over every
    slot."""
    from . import _build

    _check_taps(iu0, iv0, uk, vk, weights)
    total, w_cols = weights.shape
    planes = w_cols if tasks is None else tasks.planes
    if layers.dtype != torch.complex64 or layers.ndim != 3 \
            or layers.shape[0] != planes \
            or layers.shape[1] != layers.shape[2] \
            or not layers.is_contiguous():
        raise SdpInvalidArgumentError(
            f"layers must be contiguous complex64 [{planes}, N, N]")
    lib = _build.load()
    out = torch.empty((total,), dtype=torch.complex64, device=uk.device)
    with torch.cuda.device(uk.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_tower_degrid_tasks(
            layers.data_ptr(), iu0.data_ptr(), iv0.data_ptr(), uk.data_ptr(),
            vk.data_ptr(), weights.data_ptr(),
            None if tasks is None else tasks.table.data_ptr(),
            0 if tasks is None else len(tasks.rows), total, uk.shape[1],
            w_cols, layers.shape[-1], int(fast), out.data_ptr(), stream)
    _build.check(lib, err, "tower_degrid_tasks_kernel")
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even), back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def grid_all_layers_reference(vis_re, vis_im, iu0, iv0, uk, vk, weights,
                              num_layers: int, size: int, support: int,
                              block_v: int = 1024,
                              fast: bool = False) -> torch.Tensor:
    """Plain version of :func:`grid_all_layers`: per layer and half,
    ``(A_u * scale)^T @ A_v`` on f32 bands (with ``fast``, both factors
    rounded to bf16 first)."""
    a_u = band_matrix(iu0, uk.to(torch.float32), size)
    a_v = band_matrix(iv0, vk.to(torch.float32), size)
    if fast:
        a_v = _bf16(a_v)
    weights = weights.to(torch.float32)
    out = torch.empty((2, num_layers, size, size), dtype=torch.float32,
                      device=a_u.device)
    with _full_f32_matmul():
        for k in range(num_layers):
            for h, vals in enumerate((vis_re, vis_im)):
                scale = weights[:, k] * vals.to(torch.float32)
                a_s = a_u * scale[:, None]
                out[h, k] = (_bf16(a_s) if fast else a_s).T @ a_v
    return torch.complex(out[0], out[1])


def grid_all_layers(vis_re, vis_im, iu0, iv0, uk, vk, weights,
                    num_layers: int, size: int, support: int,
                    block_v: int = 1024, fast: bool = False) -> torch.Tensor:
    """All-layer gridding of flat taps into ``[K, size, size]``
    complex64 (``weights`` [V, K]; ``fast``: the bf16 mode): one task of
    :func:`grid_all_layers_tasks`."""
    dev = _device(vis_re, vis_im, iu0, iv0, uk, vk, weights)
    if weights.shape[-1] != num_layers:
        raise SdpShapeError(
            f"weights have {weights.shape[-1]} layers, expected {num_layers}")
    if dev.type == "cpu":
        return grid_all_layers_reference(vis_re, vis_im, iu0, iv0, uk, vk,
                                         weights, num_layers, size, support,
                                         block_v, fast)
    out = _launch_grid_tasks(vis_re, vis_im, iu0, iv0, uk, vk, weights,
                             None, num_layers, size, fast)
    grid_all_layers.launches += 1
    return out


grid_all_layers.launches = 0


def degrid_all_layers_reference(layers, iu0, iv0, uk, vk, weights,
                                support: int, block_v: int = 1024,
                                fast: bool = False) -> torch.Tensor:
    """Plain version of :func:`degrid_all_layers`: per layer,
    ``rowsum((A_u @ layer) * A_v)`` on f32 bands, weighted (with
    ``fast``, ``A_u`` and the layer rounded to bf16 for the product)."""
    size = layers.shape[-1]
    a_u = band_matrix(iu0, uk.to(torch.float32), size)
    a_v = band_matrix(iv0, vk.to(torch.float32), size)
    rnd = _bf16 if fast else (lambda x: x)
    a_u = rnd(a_u)
    weights = weights.to(torch.float32)
    re = torch.zeros(iu0.shape[0], dtype=torch.float32, device=a_u.device)
    im = torch.zeros_like(re)
    with _full_f32_matmul():
        for k in range(layers.shape[0]):
            layer = layers[k]
            re += weights[:, k] * (
                (a_u @ rnd(layer.real.to(torch.float32))) * a_v).sum(dim=1)
            im += weights[:, k] * (
                (a_u @ rnd(layer.imag.to(torch.float32))) * a_v).sum(dim=1)
    return torch.complex(re, im)


def degrid_all_layers(layers, iu0, iv0, uk, vk, weights, support: int,
                      block_v: int = 1024, fast: bool = False) -> torch.Tensor:
    """All-layer degridding: ``[K, N, N]`` complex layers -> [V]
    complex64 (``fast``: the bf16 mode): one task of
    :func:`degrid_all_layers_tasks`."""
    dev = _device(layers, iu0, iv0, uk, vk, weights)
    if weights.shape[-1] != layers.shape[0]:
        raise SdpShapeError(
            f"weights have {weights.shape[-1]} layers, expected "
            f"{layers.shape[0]}")
    if dev.type == "cpu":
        return degrid_all_layers_reference(layers, iu0, iv0, uk, vk,
                                           weights, support, block_v, fast)
    out = _launch_degrid_tasks(_as(layers, torch.complex64), iu0, iv0, uk,
                               vk, weights, None, fast)
    degrid_all_layers.launches += 1
    return out


degrid_all_layers.launches = 0


def grid_all_layers_tasks_reference(vis_re, vis_im, iu0, iv0, uk, vk,
                                    weights, tasks: TaskTable, size: int,
                                    support: int,
                                    fast: bool = False) -> torch.Tensor:
    """Plain version of :func:`grid_all_layers_tasks`: each task's slots
    through :func:`grid_all_layers_reference` into its planes."""
    out = torch.zeros((tasks.planes, size, size), dtype=torch.complex64,
                      device=uk.device)
    for start, count, num_layers, base in tasks.rows:
        sl = slice(start, start + count)
        out[base:base + num_layers] = grid_all_layers_reference(
            vis_re[sl], vis_im[sl], iu0[sl], iv0[sl], uk[sl], vk[sl],
            weights[sl, :num_layers], num_layers, size, support, fast=fast)
    return out


def grid_all_layers_tasks(vis_re, vis_im, iu0, iv0, uk, vk, weights,
                          tasks: TaskTable, size: int, support: int,
                          fast: bool = False) -> torch.Tensor:
    """All-layer gridding of a whole sorted stream of tasks (``weights``
    [V, Kw], each task's layers its first columns) into one complex64
    ``[tasks.planes, size, size]`` stack, in one launch (``fast``: the
    bf16 mode)."""
    dev = _device(vis_re, vis_im, iu0, iv0, uk, vk, weights, tasks.table,
                  tasks.layer_map)
    _check_tasks(tasks, weights)
    if dev.type == "cpu":
        return grid_all_layers_tasks_reference(
            vis_re, vis_im, iu0, iv0, uk, vk, weights, tasks, size, support,
            fast)
    out = _launch_grid_tasks(vis_re, vis_im, iu0, iv0, uk, vk, weights,
                             tasks, tasks.planes, size, fast)
    grid_all_layers_tasks.launches += 1
    return out


grid_all_layers_tasks.launches = 0


def degrid_all_layers_tasks_reference(layers, iu0, iv0, uk, vk, weights,
                                      tasks: TaskTable, support: int,
                                      fast: bool = False) -> torch.Tensor:
    """Plain version of :func:`degrid_all_layers_tasks`: each task's slots
    through :func:`degrid_all_layers_reference` from its planes."""
    out = torch.zeros((iu0.shape[0],), dtype=torch.complex64,
                      device=uk.device)
    for start, count, num_layers, base in tasks.rows:
        sl = slice(start, start + count)
        out[sl] = degrid_all_layers_reference(
            layers[base:base + num_layers], iu0[sl], iv0[sl], uk[sl],
            vk[sl], weights[sl, :num_layers], support, fast=fast)
    return out


def degrid_all_layers_tasks(layers, iu0, iv0, uk, vk, weights,
                            tasks: TaskTable, support: int,
                            fast: bool = False) -> torch.Tensor:
    """All-layer degridding of a whole sorted stream of tasks from the
    complex64 ``[tasks.planes, N, N]`` stack -> [V] complex64 in slot
    order (zero on slots no task holds), in one launch (``fast``: the bf16
    mode)."""
    dev = _device(layers, iu0, iv0, uk, vk, weights, tasks.table)
    _check_tasks(tasks, weights)
    if layers.shape[0] != tasks.planes:
        raise SdpShapeError(f"{layers.shape[0]} layers for a table of "
                            f"{tasks.planes} planes")
    if dev.type == "cpu":
        return degrid_all_layers_tasks_reference(
            layers, iu0, iv0, uk, vk, weights, tasks, support, fast)
    out = _launch_degrid_tasks(layers, iu0, iv0, uk, vk, weights, tasks,
                               fast)
    degrid_all_layers_tasks.launches += 1
    return out


degrid_all_layers_tasks.launches = 0

_WRAPPERS = (grid_plane, degrid_plane, grid_all_layers, degrid_all_layers,
             grid_all_layers_tasks, degrid_all_layers_tasks)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
