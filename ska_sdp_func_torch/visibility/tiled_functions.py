"""UV-tile binning: count + prefix sum, bucket sort, index-only variant.

Counterpart of ska_sdp_func_tpu.visibility.tiled_functions (reference
visibility/sdp_tiled_functions.{h,cpp,cu}): per-tile visibility counts
with an exclusive prefix sum, then a bucket sort of (u, v, vis, weight)
records into tile order (a visibility is DUPLICATED into every tile its
support box overlaps), or an index-only variant.

Geometry (sdp_opt_weighting.cpp:58-64): ``num_tiles_u =
ceil(grid_size / tile_size_u)``; the tile lattice's top-left is
``grid_centre - (grid_centre / tile_u) * tile_u - tile_u / 2``. A
visibility at grid position (round(pos) + centre) covering +-support
cells touches tiles ``floor((rel - support) / tile) ..
ceil((rel + support + 1) / tile)``, computed in f32 exactly as the
reference does (an f64 or integer form moves the edge records). Points
whose support box leaves the grid are skipped (``num_skipped``).

Records are made for a static bound of candidate tiles a visibility and
ordered by a STABLE sort of the key ``pv * 32768 + pu``: tile-contiguous
buckets in a fixed order on every device. Grid positions and record
indices are int64. The lattice starts up to half a tile before the grid,
so a record's tile can lie past ``num_tiles``: as in the JAX package, a
write there is dropped and a read clamps to the last tile (JAX's
``.at[]`` update and gather semantics, :func:`_update_index`,
:func:`_read_index`). The entry points run on ``device`` (None: the CUDA
card) and move their inputs there.
"""

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utility.constants import C_0
from ..utility.errors import SdpShapeError
from ..utility.tensors import divide, on_device

_TILE_KEY_STRIDE = 32768  # sorted_tile = pv * 32768 + pu (reference)


class TileGeometry(NamedTuple):
    num_tiles_u: int
    num_tiles_v: int
    top_left_u: int
    top_left_v: int
    max_tiles_spanned: int


def _geometry(grid_size: int, tile_size_u: int, tile_size_v: int,
              support: int) -> TileGeometry:
    grid_centre = grid_size // 2
    num_tiles_u = (grid_size + tile_size_u - 1) // tile_size_u
    num_tiles_v = (grid_size + tile_size_v - 1) // tile_size_v
    ctile_u = grid_centre // tile_size_u
    ctile_v = grid_centre // tile_size_v
    top_left_u = grid_centre - ctile_u * tile_size_u - tile_size_u // 2
    top_left_v = grid_centre - ctile_v * tile_size_v - tile_size_v // 2
    # Static bound on the tiles a support box can span on each axis.
    span_u = int(math.ceil((2 * support + 1) / tile_size_u)) + 2
    span_v = int(math.ceil((2 * support + 1) / tile_size_v)) + 2
    return TileGeometry(num_tiles_u, num_tiles_v, top_left_u, top_left_v,
                        max(span_u, span_v))


def _update_index(idx, n: int):
    """(index, keep) of a JAX ``.at[idx]`` update on an axis of ``n``: a
    negative index wraps once, one still outside [0, n) is dropped."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)


def _read_index(idx, n: int):
    """The element a JAX gather ``x[idx]`` reads on an axis of ``n``: a
    negative index wraps once, then clamps into [0, n)."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _tile_range(rel, support: int, tile: int):
    """[first, end) tile on one axis, in the reference's f32 arithmetic."""
    inv = np.float32(1.0 / tile)
    lo = torch.floor((rel - support).to(torch.float32) * inv)
    hi = torch.ceil((rel + support + 1).to(torch.float32) * inv)
    return lo.to(torch.int32), hi.to(torch.int32)


def _candidates(uvw, freqs, grid_size, tile_size_u, tile_size_v,
                cell_size_rad, support, geom):
    """Flattened candidate records, one a (sample, candidate tile):
    (valid, tile key, pos_u, pos_v, flat sample index), and the samples'
    in-grid mask [T, B, C]."""
    grid_centre = grid_size // 2
    grid_scale = grid_size * cell_size_rad
    inv_wave = divide(freqs, C_0)
    pos_u = uvw[..., 0:1] * inv_wave * grid_scale           # [T, B, C]
    pos_v = uvw[..., 1:2] * inv_wave * grid_scale
    grid_u = torch.round(pos_u).to(torch.int64) + grid_centre
    grid_v = torch.round(pos_v).to(torch.int64) + grid_centre
    ok = ((grid_u + support < grid_size) & (grid_u - support >= 0)
          & (grid_v + support < grid_size) & (grid_v - support >= 0))
    tu_min, tu_max = _tile_range(grid_u - geom.top_left_u, support,
                                 tile_size_u)
    tv_min, tv_max = _tile_range(grid_v - geom.top_left_v, support,
                                 tile_size_v)
    steps = torch.arange(geom.max_tiles_spanned, device=uvw.device)
    pu = tu_min[..., None, None] + steps[None, :, None]  # [T, B, C, s, 1]
    pv = tv_min[..., None, None] + steps[None, None, :]  # [T, B, C, 1, s]
    valid = (ok[..., None, None]
             & (pu < tu_max[..., None, None])
             & (pv < tv_max[..., None, None]))
    tile_key = pv * _TILE_KEY_STRIDE + pu
    flat_index = torch.arange(pos_u.numel(),
                              device=uvw.device).reshape(pos_u.shape)
    shape = valid.shape

    def spread(x):
        return x[..., None, None].expand(shape).reshape(-1)

    return (valid.reshape(-1), tile_key.expand(shape).reshape(-1),
            spread(pos_u), spread(pos_v), spread(flat_index), ok)


def _check_tiled_uvw(uvw) -> None:
    """The tiled trio's uvw contract: ``[time, baseline, 3]`` (the
    reference validates it on every entry)."""
    if uvw.ndim != 3 or uvw.shape[-1] != 3:
        raise SdpShapeError(
            f"uvw must be [time, baseline, 3]; got {tuple(uvw.shape)}")


def count_and_prefix_sum(uvw, freqs, grid_size: int, tile_size_u: int,
                         tile_size_v: int, cell_size_rad: float,
                         support: int, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, int]:
    """Count visibilities per uv tile and build exclusive prefix sums
    (`sdp_count_and_prefix_sum`, sdp_tiled_functions.h:62): returns
    ``(tile_offsets [num_tiles+1], num_points_in_tiles [num_tiles],
    num_skipped [1], num_visibilities)``, the record count as a value."""
    uvw, freqs = on_device(uvw, freqs, device=device)
    _check_tiled_uvw(uvw)
    geom = _geometry(grid_size, tile_size_u, tile_size_v, support)
    valid, tile_key, _, _, _, ok = _candidates(
        uvw, freqs, grid_size, tile_size_u, tile_size_v, cell_size_rad,
        support, geom)
    num_tiles = geom.num_tiles_u * geom.num_tiles_v
    # Keys are pv * 32768 + pu; counts are stored pu + pv * num_tiles_u.
    pu = tile_key % _TILE_KEY_STRIDE
    pv = tile_key // _TILE_KEY_STRIDE
    lin, keep = _update_index(
        torch.where(valid, pu + pv * geom.num_tiles_u, 0), num_tiles)
    counts = torch.zeros((num_tiles,), dtype=torch.int32, device=uvw.device)
    counts.index_add_(0, lin, (valid & keep).to(torch.int32))
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                     device=uvw.device),
                         torch.cumsum(counts, 0).to(torch.int32)])
    num_skipped = torch.sum(~ok).to(torch.int32)[None]
    return offsets, counts, num_skipped, int(offsets[-1])


def _sorted_records(uvw, freqs, grid_size, tile_size_u, tile_size_v,
                    cell_size_rad, support):
    _check_tiled_uvw(uvw)
    geom = _geometry(grid_size, tile_size_u, tile_size_v, support)
    valid, tile_key, pos_u, pos_v, vis_idx, _ = _candidates(
        uvw, freqs, grid_size, tile_size_u, tile_size_v, cell_size_rad,
        support, geom)
    big = torch.iinfo(torch.int32).max
    order = torch.argsort(torch.where(valid, tile_key, big), stable=True)
    sel = order[:int(valid.sum())]
    return (tile_key[sel].to(torch.int32), pos_u[sel], pos_v[sel],
            vis_idx[sel], geom)


def _pol0_flat(x) -> torch.Tensor:
    return x[..., 0].reshape(-1) if x.ndim == 4 else x.reshape(-1)


def bucket_sort(uvw, freqs, vis, weights, grid_size: int, tile_size_u: int,
                tile_size_v: int, cell_size_rad: float, support: int,
                device=None):
    """Bucket-sort visibilities into tile order, duplicating overlaps
    (`sdp_bucket_sort`, sdp_tiled_functions.h:136); returns
    ``(sorted_uu, sorted_vv, sorted_weight, sorted_tile, sorted_vis)``.
    Order within a tile is the stable sort's, not the reference's atomic
    arrival order."""
    uvw, freqs, vis, weights = on_device(uvw, freqs, vis, weights,
                                         device=device)
    tile, uu, vv, idx, _ = _sorted_records(
        uvw, freqs, grid_size, tile_size_u, tile_size_v, cell_size_rad,
        support)
    return uu, vv, _pol0_flat(weights)[idx], tile, _pol0_flat(vis)[idx]


def tiled_indexing(uvw, freqs, grid_size: int, tile_size_u: int,
                   tile_size_v: int, cell_size_rad: float, support: int,
                   device=None):
    """Index-only bucket sort (`sdp_tiled_indexing`,
    sdp_tiled_functions.h:200): returns
    ``(sorted_uu, sorted_vv, sorted_vis_index, sorted_tile)``."""
    uvw, freqs = on_device(uvw, freqs, device=device)
    tile, uu, vv, idx, _ = _sorted_records(
        uvw, freqs, grid_size, tile_size_u, tile_size_v, cell_size_rad,
        support)
    return uu, vv, idx.to(torch.int32), tile
