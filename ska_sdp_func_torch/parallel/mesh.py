"""Process meshes for sharding visibility rows.

Counterpart of ska_sdp_func_tpu.parallel.mesh on ``torch.distributed``.
The canonical layout shards the visibility **row** axis (time x
baseline) over the ranks of a process group, one card (or one CPU
process) each: the reference's ``start_row/end_row`` process-sharding
hooks (grid_data/sdp_gridder_wtower_uvw.h:91-93). The counterpart of a
JAX global array sharded by rows is each rank's own block of rows: pad
the rows with :func:`pad_rows_arrays`, take a rank's block with
:func:`local_rows`, and gather blocks back in rank order with
:func:`gather_rows`.
"""

import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utility.errors import SdpInvalidArgumentError
from ..utility.tensors import as_tensors, resolve_device

ROW_AXIS = "rows"


def make_mesh(num_devices: Optional[int] = None, axis_name: str = ROW_AXIS,
              device=None, rank: Optional[int] = None,
              init_method: Optional[str] = None,
              timeout: float = 300.0):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over the process group's
    ranks, on ``device``'s type (``None``: CUDA; ``"cpu"``: CPU).

    Without a process group this starts one: NCCL for CUDA, gloo for the
    CPU, meeting at ``init_method`` (a ``file://`` path that every rank
    names; ``None``: ``torch.distributed``'s ``env://``) with
    ``num_devices`` ranks (``None``: ``WORLD_SIZE``), ``rank`` being this
    process (``None``: ``RANK``), and ``timeout`` seconds for each
    collective. A CUDA rank with no card index given takes card
    ``LOCAL_RANK`` (or its rank) modulo the cards present. With a process
    group already started, ``num_devices`` must be its size.
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device("cuda" if device is None else device)
    if not dist.is_initialized():
        kwargs = dict(backend="nccl" if dev.type == "cuda" else "gloo",
                      init_method=init_method or "env://",
                      timeout=timedelta(seconds=timeout))
        if num_devices is not None:
            kwargs["world_size"] = int(num_devices)
        if rank is not None:
            kwargs["rank"] = int(rank)
        if dev.type == "cuda":
            if dev.index is None:
                local = int(os.environ.get(
                    "LOCAL_RANK", rank if rank is not None
                    else os.environ.get("RANK", 0)))
                dev = torch.device("cuda",
                                   local % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(**kwargs)
    world = dist.get_world_size()
    if num_devices is not None and int(num_devices) != world:
        raise ValueError(f"Requested {num_devices} devices but the process "
                         f"group has {world} ranks")
    return init_device_mesh(dev.type, (world,),
                            mesh_dim_names=(axis_name,))


def row_sharding(mesh, axis_name: str = ROW_AXIS):
    """The placement that splits the leading (row) axis over the mesh's
    ``axis_name`` dimension: ``[Shard(0)]``."""
    from torch.distributed.tensor.placement_types import Shard

    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis_name!r}")
    return [Shard(0)]


def mesh_axis(mesh, axis_name: str = ROW_AXIS):
    """(size, this rank's index, process group) of the mesh's
    ``axis_name`` dimension: the rows shard over that dimension alone,
    and the mesh's other dimensions see the same rows."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise SdpInvalidArgumentError(
            f"mesh has no axis {axis_name!r} (axes: {names})")
    return (mesh.size(names.index(axis_name)),
            mesh.get_local_rank(axis_name), mesh.get_group(axis_name))


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` computes on (its current card, for a
    CUDA mesh)."""
    return resolve_device(mesh.device_type)


def pad_rows(num_rows: int, num_shards: int) -> Tuple[int, int]:
    """Return (padded_rows, pad) so padded_rows % num_shards == 0.

    Padded rows are masked out via ``end_ch = 0`` channel ranges (the same
    no-op selection the channel clamping produces for out-of-box rows), so
    they contribute nothing to any operator.
    """
    rem = num_rows % num_shards
    pad = 0 if rem == 0 else num_shards - rem
    return num_rows + pad, pad


def pad_rows_arrays(uvw, vis, start_chs, end_chs, num_shards: int,
                    device=None):
    """Pad row-axis arrays to a multiple of ``num_shards`` (tensors keep
    their device; NumPy input goes to the first tensor's device, or to
    ``device``: :func:`..utility.tensors.as_tensors`).

    Pad rows get ``start_ch = end_ch = 0`` so they select no channels.
    ``vis`` may be None.
    """
    arrays = [x for x in (uvw, vis, start_chs, end_chs) if x is not None]
    arrays = iter(as_tensors(*arrays, device=device))
    uvw, vis, start_chs, end_chs = (None if x is None else next(arrays)
                                    for x in (uvw, vis, start_chs, end_chs))
    _, pad = pad_rows(uvw.shape[0], num_shards)
    if pad == 0:
        return uvw, vis, start_chs, end_chs

    def padded(x):
        if x is None:
            return None
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    return tuple(padded(x) for x in (uvw, vis, start_chs, end_chs))


def local_rows(mesh, *arrays, axis_name: str = ROW_AXIS):
    """This rank's block of each row-padded array (rows a multiple of the
    mesh's size, as :func:`pad_rows_arrays` makes them): the rows of
    ``Shard(0)`` on this rank. ``None`` stays ``None``. Returns a
    tuple."""
    size, rank, _ = mesh_axis(mesh, axis_name)
    out = []
    for x in arrays:
        if x is None:
            out.append(None)
            continue
        if x.shape[0] % size:
            raise ValueError(f"{x.shape[0]} rows do not split into "
                             f"{size} shards: pad them first")
        block = x.shape[0] // size
        out.append(x[rank * block:(rank + 1) * block])
    return tuple(out)


def gather_rows(local, mesh, num_rows: Optional[int] = None,
                axis_name: str = ROW_AXIS) -> torch.Tensor:
    """Every rank's block of rows, in rank order (``all_gather``; blocks
    of equal size), trimmed to the first ``num_rows`` rows (the rows
    before padding)."""
    group = mesh.get_group(axis_name)
    local = local.contiguous()
    blocks = [torch.empty_like(local)
              for _ in range(dist.get_world_size(group))]
    real = torch.view_as_real if local.is_complex() else (lambda x: x)
    dist.all_gather([real(b) for b in blocks], real(local), group=group)
    rows = torch.cat(blocks)
    return rows if num_rows is None else rows[:num_rows]
