"""Distributed SwiFTly: the facet <-> subgrid exchange over a process
mesh.

Counterpart of ska_sdp_func_tpu.parallel.swiftly_dist. The reference
documents the SwiFTly contribution as the compact form "to be used for
distribution" but ships no transport (sdp_swiftly.h:104-126). Here rank
d of a 1-D mesh holds facet d and is responsible for subgrid d; the
``xM * yN / N``-sized contributions move with ONE ``all_to_all_single``
per direction, and no rank ever holds the whole image.

Each rank runs its own Python with its own integer offsets, so it calls
the :class:`~..fourier_transforms.swiftly.Swiftly` methods directly (the
JAX package re-derives them with traced offsets, because ``shard_map``
traces one program for every device). A rank adds the contributions it
receives in rank order, so its sums are the same on every run.
"""

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..fourier_transforms.swiftly import Swiftly
from ..utility.errors import SdpInvalidArgumentError
from ..utility.tensors import to_device
from .mesh import ROW_AXIS


class SwiftlyDistributed:
    """1-D SwiFTly over a process mesh (:func:`.mesh.make_mesh`): rank d
    holds facet d and subgrid d, as a block ``[1, ...]`` of the global
    ``[D, ...]`` array sharded by rows; D is the mesh's size. The plan
    ``swiftly`` lives on the rank's device."""

    def __init__(self, swiftly: Swiftly, mesh, axis_name: str = ROW_AXIS):
        self.sw = swiftly
        self.mesh = mesh
        self.axis_name = axis_name
        self.group = mesh.get_group(axis_name)
        self.num = dist.get_world_size(self.group)
        self.rank = mesh.get_local_rank(axis_name)

    def _offsets(self, offsets, pairs: bool):
        offs = np.asarray(offsets.cpu() if isinstance(offsets, torch.Tensor)
                          else offsets, np.int64)
        if offs.shape != ((self.num, 2) if pairs else (self.num,)):
            raise SdpInvalidArgumentError(
                f"expected {self.num} offsets"
                + (" (l, m) pairs" if pairs else "")
                + f", got shape {offs.shape}")
        return offs.tolist()

    def _exchange(self, contribs: torch.Tensor) -> torch.Tensor:
        """Row d of ``contribs`` goes to rank d; row d of the result came
        from rank d."""
        contribs = contribs.contiguous()
        received = torch.empty_like(contribs)
        dist.all_to_all_single(torch.view_as_real(received),
                               torch.view_as_real(contribs),
                               group=self.group)
        return received

    def facets_to_subgrids(self, facets, facet_offsets: Sequence[int],
                           subgrid_offsets: Sequence[int],
                           xA_size: int) -> torch.Tensor:
        """This rank's ``[1, yB]`` facet -> its ``[1, xA]`` subgrid."""
        sw = self.sw
        f_offs = self._offsets(facet_offsets, False)
        s_offs = self._offsets(subgrid_offsets, False)
        facet = to_device(facets, sw.device)[0]
        prep = sw.prepare_facet(facet, f_offs[self.rank])
        received = self._exchange(torch.stack(
            [sw.extract_from_facet(prep, so) for so in s_offs]))
        acc = torch.zeros(sw.xM_size, dtype=prep.dtype, device=sw.device)
        for contrib, f_off in zip(received, f_offs):
            acc = sw.add_to_subgrid(contrib, acc, f_off)
        return sw.finish_subgrid(acc, xA_size, s_offs[self.rank])[None]

    def subgrids_to_facets(self, subgrids, subgrid_offsets: Sequence[int],
                           facet_offsets: Sequence[int],
                           yB_size: int) -> torch.Tensor:
        """This rank's ``[1, xM]`` subgrid -> its ``[1, yB]`` facet."""
        sw = self.sw
        f_offs = self._offsets(facet_offsets, False)
        s_offs = self._offsets(subgrid_offsets, False)
        subgrid = to_device(subgrids, sw.device)[0]
        prep = sw.prepare_subgrid_inplace(subgrid, s_offs[self.rank])
        received = self._exchange(torch.stack(
            [sw.extract_from_subgrid(prep, fo) for fo in f_offs]))
        acc = torch.zeros(sw.yN_size, dtype=prep.dtype, device=sw.device)
        for contrib, s_off in zip(received, s_offs):
            acc = sw.add_to_facet(contrib, acc, s_off)
        return sw.finish_facet(acc, yB_size, f_offs[self.rank])[None]

    # -- 2-D chains (offsets are (l, m) pairs) ------------------------------

    def facets_to_subgrids_2d(self, facets, facet_offsets, subgrid_offsets,
                              xA_size: int) -> torch.Tensor:
        """This rank's ``[1, yB, yB]`` facet -> its ``[1, xA, xA]``
        subgrid (the central ``xA`` window of the finished subgrid)."""
        sw = self.sw
        f_offs = self._offsets(facet_offsets, True)
        s_offs = self._offsets(subgrid_offsets, True)
        f0, f1 = f_offs[self.rank]
        prep = sw.prepare_facet(to_device(facets, sw.device)[0], f1)
        prep = sw.prepare_facet(prep.transpose(-1, -2),
                                f0).transpose(-1, -2)
        contribs = []
        for s0, s1 in s_offs:
            c = sw.extract_from_facet(prep, s1)
            contribs.append(sw.extract_from_facet(
                c.transpose(-1, -2), s0).transpose(-1, -2))
        received = self._exchange(torch.stack(contribs))
        xM = sw.xM_size
        acc = torch.zeros((xM, xM), dtype=prep.dtype, device=sw.device)
        for contrib, (g0, g1) in zip(received, f_offs):
            acc = sw.add_to_subgrid_2d(contrib, acc, g0, g1)
        lo = xM // 2 - xA_size // 2
        full = sw.finish_subgrid_inplace_2d(acc, *s_offs[self.rank])
        return full[lo:lo + xA_size, lo:lo + xA_size][None]

    def subgrids_to_facets_2d(self, subgrids, subgrid_offsets, facet_offsets,
                              yB_size: int) -> torch.Tensor:
        """This rank's ``[1, xM, xM]`` subgrid -> its ``[1, yB, yB]``
        facet."""
        sw = self.sw
        f_offs = self._offsets(facet_offsets, True)
        s_offs = self._offsets(subgrid_offsets, True)
        subgrid = to_device(subgrids, sw.device)[0]
        prep = sw.prepare_subgrid_inplace_2d(subgrid, *s_offs[self.rank])
        received = self._exchange(torch.stack(
            [sw.extract_from_subgrid_2d(prep, g0, g1) for g0, g1 in f_offs]))
        m, yN = sw.xM_yN_size, sw.yN_size
        acc = torch.zeros((yN, yN), dtype=prep.dtype, device=sw.device)
        for contrib, (s0, s1) in zip(received, s_offs):
            rows = sw.add_to_facet(
                contrib, torch.zeros((m, yN), dtype=acc.dtype,
                                     device=sw.device), s1)
            acc = sw.add_to_facet(rows.transpose(-1, -2),
                                  acc.transpose(-1, -2),
                                  s0).transpose(-1, -2)
        f0, f1 = f_offs[self.rank]
        out = sw.finish_facet(acc, yB_size, f1)
        return sw.finish_facet(out.transpose(-1, -2), yB_size,
                               f0).transpose(-1, -2)[None]
