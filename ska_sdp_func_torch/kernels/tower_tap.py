"""W-towers tap gridding / degridding: CUDA kernels and plain twins.

Counterpart of ska_sdp_func_tpu.kernels.pallas_tap. Its four Pallas
entry points share two kernel bodies (``_grid_kernel``,
``_degrid_kernel``); here they share two hand-written CUDA kernels
(``csrc/tower_tap.cu``, built by :mod:`._build`):

- :func:`grid_plane` replaces ``grid_plane_pallas`` (K14) and
  :func:`grid_all_layers` replaces ``grid_all_layers_pallas`` (K16):
  both launch ``tower_grid_kernel``;
- :func:`degrid_plane` replaces ``degrid_plane_pallas`` (K15) and
  :func:`degrid_all_layers` replaces ``degrid_all_layers_pallas`` (K17):
  both launch ``tower_degrid_kernel``.

Both kernels take flat per-visibility taps: ``iu0``/``iv0`` [V] int32
sub-grid cells, ``uk``/``vk`` [V, S] f32 kernel taps and ``weights``
[V, K] f32, the w-kernel value of each visibility for each layer (zero
outside its layers). The per-plane wrappers gather those from the
kernel tables and the plane geometry first, as the Pallas wrappers do.
Taps that fall outside the ``[N, N]`` sub-grid are dropped. Arithmetic
is f32 throughout, the Pallas kernels' ``Precision.HIGHEST``; only the
order of the sums differs (and, for the grid kernel's atomics, varies
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
its own kernel launches in ``.launches``. ``block_v`` is the number of
visibilities one grid CTA accumulates (the Pallas block size); the
degrid kernel takes one warp per visibility and ignores it.
"""

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


def _launch_grid(vis_re, vis_im, iu0, iv0, uk, vk, weights, size: int,
                 block_v: int, fast: bool = False, k0=None,
                 num_layers: int = None) -> torch.Tensor:
    """``tower_grid_kernel`` -> f32 ``[2K, size, size]`` (re layers,
    then im layers). Dense: ``weights`` [V, K]; sparse (``k0`` given):
    ``weights`` is ``wk`` [V, Sw] and ``num_layers`` is K."""
    from . import _build

    _check_taps(iu0, iv0, uk, vk, weights)
    total, w_cols = weights.shape
    if k0 is None:
        num_layers = w_cols
    elif k0.dtype != torch.int32 or tuple(k0.shape) != (total,) \
            or not k0.is_contiguous():
        raise SdpInvalidArgumentError(f"k0 must be contiguous int32 [{total}]")
    for name, t in (("vis_re", vis_re), ("vis_im", vis_im)):
        if t.dtype != torch.float32 or tuple(t.shape) != (total,) \
                or not t.is_contiguous():
            raise SdpInvalidArgumentError(
                f"{name} must be contiguous f32 [{total}]")
    if size <= 0 or size % 2 or block_v <= 0:
        raise SdpInvalidArgumentError(
            f"need an even size and block_v > 0 (got {size}, {block_v})")
    lib = _build.load()
    out = torch.zeros((2 * num_layers, size, size), dtype=torch.float32,
                      device=uk.device)
    with torch.cuda.device(uk.device):
        stream = torch.cuda.current_stream().cuda_stream
        if k0 is None:
            err = lib.sdp_torch_tower_grid(
                vis_re.data_ptr(), vis_im.data_ptr(), iu0.data_ptr(),
                iv0.data_ptr(), uk.data_ptr(), vk.data_ptr(),
                weights.data_ptr(), total, uk.shape[1], num_layers, size,
                block_v, int(fast), out.data_ptr(), stream)
        else:
            err = lib.sdp_torch_tower_grid_sparse(
                vis_re.data_ptr(), vis_im.data_ptr(), iu0.data_ptr(),
                iv0.data_ptr(), k0.data_ptr(), uk.data_ptr(), vk.data_ptr(),
                weights.data_ptr(), total, uk.shape[1], w_cols, num_layers,
                size, block_v, int(fast), out.data_ptr(), stream)
    _build.check(lib, err, "tower_grid_kernel")
    return out


def _launch_degrid(planes, iu0, iv0, uk, vk, weights,
                   fast: bool = False) -> torch.Tensor:
    """``tower_degrid_kernel`` on f32 ``[2K, N, N]`` planes -> f32
    ``[2, V]`` (re, im)."""
    from . import _build

    _check_taps(iu0, iv0, uk, vk, weights)
    total, num_layers = weights.shape
    if planes.dtype != torch.float32 or planes.ndim != 3 \
            or planes.shape[0] != 2 * num_layers \
            or planes.shape[1] != planes.shape[2] \
            or not planes.is_contiguous():
        raise SdpInvalidArgumentError(
            f"planes must be contiguous f32 [{2 * num_layers}, N, N]")
    lib = _build.load()
    out = torch.empty((2, total), dtype=torch.float32, device=uk.device)
    with torch.cuda.device(uk.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdp_torch_tower_degrid(
            planes.data_ptr(), iu0.data_ptr(), iv0.data_ptr(),
            uk.data_ptr(), vk.data_ptr(), weights.data_ptr(), total,
            uk.shape[1], num_layers, planes.shape[-1], int(fast),
            out.data_ptr(), stream)
    _build.check(lib, err, "tower_degrid_kernel")
    return out


def _split_planes(layers: torch.Tensor) -> torch.Tensor:
    """[K, N, N] complex -> contiguous f32 [2K, N, N] (re, then im)."""
    return torch.cat([layers.real.to(torch.float32),
                      layers.imag.to(torch.float32)]).contiguous()


# ---------------------------------------------------------------------------
# Per-plane entry points (K14, K15)
# ---------------------------------------------------------------------------

def _masked_vis(vis, mask):
    """One plane's visibilities as f32 (re, im) [V], zero where masked."""
    vis_f = vis.reshape(-1)
    return (torch.where(mask, vis_f.real, 0.0).to(torch.float32).contiguous(),
            torch.where(mask, vis_f.imag, 0.0).to(torch.float32).contiguous())


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
    ``subgrids + contribution``."""
    dev = _device(subgrids, vis, uv_kernel, w_kernel, *geom)
    if dev.type == "cpu":
        return grid_plane_reference(subgrids, vis, uv_kernel, w_kernel,
                                    geom, support, w_support, block_v, fast)
    mask, iu0, iv0, uk, vk, wk = _plane_taps(uv_kernel, w_kernel, geom)
    out = _launch_grid(*_masked_vis(vis, mask), iu0, iv0, uk, vk, wk,
                       subgrids.shape[-1], block_v, fast)
    grid_plane.launches += 1
    contrib = torch.complex(out[:w_support], out[w_support:])
    return subgrids + contrib.to(subgrids.dtype)


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
    entries are zero."""
    dev = _device(subgrids, uv_kernel, w_kernel, *geom)
    if dev.type == "cpu":
        return degrid_plane_reference(subgrids, uv_kernel, w_kernel, geom,
                                      support, w_support, block_v, fast)
    mask, iu0, iv0, uk, vk, wk = _plane_taps(uv_kernel, w_kernel, geom)
    out = _launch_degrid(_split_planes(subgrids), iu0, iv0, uk, vk, wk,
                         fast)
    degrid_plane.launches += 1
    vis = torch.complex(out[0], out[1]).to(subgrids.dtype)
    vis = torch.where(mask, vis, torch.zeros((), dtype=vis.dtype,
                                             device=dev))
    return vis.reshape(geom[0].shape)


degrid_plane.launches = 0


# ---------------------------------------------------------------------------
# All-layer entry points (K16, K17)
# ---------------------------------------------------------------------------

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
    complex64 (``weights`` [V, K]; ``fast``: the bf16 mode)."""
    dev = _device(vis_re, vis_im, iu0, iv0, uk, vk, weights)
    if weights.shape[-1] != num_layers:
        raise SdpShapeError(
            f"weights have {weights.shape[-1]} layers, expected {num_layers}")
    if dev.type == "cpu":
        return grid_all_layers_reference(vis_re, vis_im, iu0, iv0, uk, vk,
                                         weights, num_layers, size, support,
                                         block_v, fast)
    out = _launch_grid(vis_re, vis_im, iu0, iv0, uk, vk, weights, size,
                       block_v, fast)
    grid_all_layers.launches += 1
    return torch.complex(out[:num_layers], out[num_layers:])


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
    complex64 (``fast``: the bf16 mode)."""
    dev = _device(layers, iu0, iv0, uk, vk, weights)
    if weights.shape[-1] != layers.shape[0]:
        raise SdpShapeError(
            f"weights have {weights.shape[-1]} layers, expected "
            f"{layers.shape[0]}")
    if dev.type == "cpu":
        return degrid_all_layers_reference(layers, iu0, iv0, uk, vk,
                                           weights, support, block_v, fast)
    out = _launch_degrid(_split_planes(layers), iu0, iv0, uk, vk, weights,
                         fast)
    degrid_all_layers.launches += 1
    return torch.complex(out[0], out[1])


degrid_all_layers.launches = 0

_WRAPPERS = (grid_plane, degrid_plane, grid_all_layers, degrid_all_layers)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
