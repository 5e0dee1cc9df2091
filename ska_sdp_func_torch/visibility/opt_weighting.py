"""Tiled (bucket-sorted) Briggs weighting.

Counterpart of ska_sdp_func_tpu.visibility.opt_weighting (reference
visibility/sdp_opt_weighting.{h,cpp,cu}): for each tile of bucket-sorted
records, a tile-local weight grid, a PER-TILE robustness from the
per-visit sums, and the read-back ``w = w_in / (1 + robustness * cell)``
(`sdp_opt_briggs_bucket_gpu`). The indexed variant writes through the
sorted visibility indices into the original layout.

As in the JAX package, each tile uses its own record range (the
reference's per-tile loops bound ``i_vis < total_vis`` instead, which
truncates every tile after the first). Tiles are a segment dimension: one
``index_add_`` into a [num_tiles, tile_u, tile_v] stack, segment sums for
the per-tile robustness, one gather for the read-back.

A visibility spanning several tiles gets a weight from each of them; the
indexed variant keeps the LAST record in sorted order (JAX's serial
scatter on the host), chosen explicitly by the largest record position
each visibility has (``scatter_reduce`` amax), so the card and the CPU
agree. The entry points run on ``device`` (None: the CUDA card).
"""

from typing import Tuple

import torch

from ..utility.tensors import on_device
from .tiled_functions import (
    _TILE_KEY_STRIDE,
    _geometry,
    _pol0_flat,
    _read_index,
    _update_index,
    bucket_sort,
    tiled_indexing,
)


def _segment_sum(values, seg, keep, num):
    """``jax.ops.segment_sum``: ids outside [0, num) (``keep`` false)
    dropped."""
    out = torch.zeros((num,), dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg, torch.where(keep, values, 0.0))


def _tile_local_weights(sorted_uu, sorted_vv, sorted_tile, weights,
                        grid_size, tile_size_u, tile_size_v, geom,
                        robust_param):
    """Per-record Briggs weights with a per-tile robustness."""
    grid_centre = grid_size // 2
    pu = sorted_tile % _TILE_KEY_STRIDE
    pv = sorted_tile // _TILE_KEY_STRIDE
    seg = (pu + pv * geom.num_tiles_u).to(torch.int64)
    num_tiles = geom.num_tiles_u * geom.num_tiles_v

    grid_u = torch.round(sorted_uu).to(torch.int64) + grid_centre
    grid_v = torch.round(sorted_vv).to(torch.int64) + grid_centre
    lu = grid_u - (pu * tile_size_u + geom.top_left_u)
    lv = grid_v - (pv * tile_size_v + geom.top_left_v)
    inside = ((lu >= 0) & (lu < tile_size_u)
              & (lv >= 0) & (lv < tile_size_v))
    lu = lu.clamp(0, tile_size_u - 1)
    lv = lv.clamp(0, tile_size_v - 1)

    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    # The tile stack's write (a tile past num_tiles is dropped, a negative
    # one wraps) and read (clamped), as JAX's .at[seg, lu, lv] and gather.
    put, keep = _update_index(seg, num_tiles)
    stack = _segment_sum(torch.where(inside, weights, zero),
                         (put * tile_size_u + lu) * tile_size_v + lv, keep,
                         num_tiles * tile_size_u * tile_size_v)
    got = _read_index(seg, num_tiles)
    cell = stack[(got * tile_size_u + lu) * tile_size_v + lv]
    # Per-visit sums a tile -> a per-tile robustness
    # (robustness_calc, sdp_weighting.cpp:138-147, applied per tile),
    # accumulated in f64 as weighting.py's Briggs sums are (JAX sums in
    # the weights' dtype; the same for f64 weights), so f32 sums of ~1e5
    # visits do not follow the card's atomic order.
    in_range = (seg >= 0) & (seg < num_tiles)
    sid = seg.clamp(0, num_tiles - 1)
    visit = torch.where(inside, cell, zero).to(torch.float64)
    sw = _segment_sum(visit, sid, in_range, num_tiles)[got]
    sw2 = _segment_sum(visit * visit, sid, in_range, num_tiles)[got]
    numerator = (5.0 * 10.0 ** (-robust_param)) ** 2
    robustness = (numerator / (sw2 / torch.where(sw == 0, 1.0, sw))).to(
        weights.dtype)
    out = weights / (1.0 + robustness * cell)
    return torch.where(inside, out, zero)


def optimized_weighting(uvw, freqs, vis, weights, robust_param: float,
                        grid_size: int, cell_size_rad: float, support: int,
                        tile_size_u: int = 32, tile_size_v: int = 32,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Briggs weighting over bucket-sorted uv tiles
    (`sdp_optimized_weighting`, sdp_opt_weighting.h:80): bucket-sorts the
    visibilities and weights every sorted record with its tile's
    robustness. Returns ``(sorted_tile, output_weights)`` in sorted
    order."""
    sorted_uu, sorted_vv, sorted_w, sorted_tile, _ = bucket_sort(
        uvw, freqs, vis, weights, grid_size, tile_size_u, tile_size_v,
        cell_size_rad, support, device=device)
    geom = _geometry(grid_size, tile_size_u, tile_size_v, support)
    out = _tile_local_weights(
        sorted_uu, sorted_vv, sorted_tile, sorted_w, grid_size,
        tile_size_u, tile_size_v, geom, float(robust_param))
    return sorted_tile, out


def optimised_indexed_weighting(uvw, freqs, vis, weights,
                                robust_param: float, grid_size: int,
                                cell_size_rad: float, support: int,
                                tile_size_u: int = 32,
                                tile_size_v: int = 32, device=None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indexed variant (`sdp_optimised_indexed_weighting`,
    sdp_opt_weighting.h:153): the sorted records' weights written back
    through their visibility indices into the original
    ``[time, baseline, chan, pol]`` layout, the last record in sorted
    order winning for a duplicated visibility. Returns
    ``(sorted_vis_index, output_weights)``."""
    (weights,) = on_device(weights, device=device)
    sorted_uu, sorted_vv, sorted_idx, sorted_tile = tiled_indexing(
        uvw, freqs, grid_size, tile_size_u, tile_size_v, cell_size_rad,
        support, device=weights.device)
    w_flat = _pol0_flat(weights)
    idx = sorted_idx.to(torch.int64)
    geom = _geometry(grid_size, tile_size_u, tile_size_v, support)
    out_sorted = _tile_local_weights(
        sorted_uu, sorted_vv, sorted_tile, w_flat[idx], grid_size,
        tile_size_u, tile_size_v, geom, float(robust_param))
    position = torch.arange(idx.numel(), device=idx.device)
    last = torch.full(w_flat.shape, -1, dtype=torch.int64,
                      device=idx.device)
    last.scatter_reduce_(0, idx, position, "amax")
    written = last >= 0
    out = torch.where(written, out_sorted[last.clamp(min=0)],
                      torch.zeros_like(w_flat)) \
        if out_sorted.numel() else torch.zeros_like(w_flat)
    if weights.ndim == 4:
        out = out.reshape(weights.shape[:3] + (1,)).expand(
            weights.shape).contiguous()
    else:
        out = out.reshape(weights.shape)
    return sorted_idx, out
