"""SwiFTly: the facet <-> subgrid contribution algebra of the streaming
widefield Fourier transform, for a distributed FFT.

Counterpart of ska_sdp_func_tpu.fourier_transforms.swiftly (reference
fourier_transforms/sdp_swiftly.{h,cpp}). Facet workers and subgrid
workers exchange compact contributions of ``xM_yN = xM * yN / N``
elements along each axis (sdp_swiftly.h:104-126). Constraint:
``xA <= xM - W * N / yN``.

Forward chain (facet -> subgrid):
    prepare_facet (x Fb, iFFT) -> extract_from_facet -> add_to_subgrid[_2d]
    (x Fn, accumulate) -> finish_subgrid[_inplace][_2d] (FFT + offsets)
Reverse chain (subgrid -> facet):
    prepare_subgrid_inplace[_2d] -> extract_from_subgrid[_2d]
    -> add_to_facet -> finish_facet

Every method works on the last axis (the ``_2d`` forms on the last two);
leading axes broadcast, so a batch of facets or subgrids that share their
offsets is one set of launches. The offsets are Python ints, so the index
maps are built on the host and copied to the plan's device, where the
methods run and return new tensors (the JAX package's functional
updates). FFT normalisation follows PocketFFT: the inverse transforms
scale by 1/n, the forward ones do not. The subgrid preparation uses the
roll-before-FFT form, the exact inverse of ``finish_subgrid_inplace``
(the reference's phase ramp, sdp_swiftly.cpp:758-776, accumulates
rounding).
"""

import numpy as np
import torch

from ..utility.errors import SdpInvalidArgumentError, SdpShapeError
from ..utility.tensors import resolve_device, to_device
from .pswf import generate_pswf


def _c_div(a: int, b: int) -> int:
    """C-style integer division (truncation toward zero)."""
    return int(np.trunc(a / b)) if (a < 0) != (b < 0) else a // b


class Swiftly:
    """SwiFTly plan (`sdp_swiftly_create`, sdp_swiftly.h:47-53) on
    ``device`` (None: the CUDA card): the PSWF tables ``Fn`` and ``Fb``,
    sampled once on the host in f64.

    :param image_size: size N of the entire (virtual) image in pixels.
    :param yN_size: internal padded facet size.
    :param xM_size: internal padded subgrid size.
    :param W: PSWF parameter.
    """

    def __init__(self, image_size: int, yN_size: int, xM_size: int,
                 W: float, device=None):
        if image_size <= 0 or xM_size <= 0 or yN_size <= 0:
            raise SdpInvalidArgumentError("sizes must be positive")
        if image_size % xM_size:
            raise SdpInvalidArgumentError(
                "image size not divisible by subgrid size")
        if image_size % yN_size:
            raise SdpInvalidArgumentError(
                "image size not divisible by facet size")
        if (xM_size * yN_size) % image_size:
            raise SdpInvalidArgumentError("contribution size not integer")
        if xM_size % 2 or yN_size % 2:
            raise SdpInvalidArgumentError(
                "subgrid and facet sizes must be even")
        self.image_size = int(image_size)
        self.yN_size = int(yN_size)
        self.xM_size = int(xM_size)
        self.W = float(W)
        self.xM_yN_size = (self.xM_size * self.yN_size) // self.image_size
        self.device = resolve_device(device)

        pswf = generate_pswf(0, W * (np.pi / 2), self.yN_size)
        xM_step = self.image_size // self.xM_size
        fn_offset = (self.yN_size // 2) % xM_step
        fb = pswf.copy()
        fb[1:] = 1.0 / fb[1:]
        self._set_tables(
            pswf[fn_offset:fn_offset + self.xM_yN_size * xM_step:xM_step],
            fb)

    def _set_tables(self, fn, fb) -> None:
        self.Fn = torch.tensor(np.asarray(fn, np.float64),
                               device=self.device)
        self.Fb = torch.tensor(np.asarray(fb, np.float64),
                               device=self.device)

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64),
                               device=self.device)

    def _tensor(self, x) -> torch.Tensor:
        return to_device(x, self.device)

    # -- queries (sdp_swiftly_get_*) ----------------------------------------
    def get_image_size(self) -> int:
        return self.image_size

    def get_facet_size(self) -> int:
        return self.yN_size

    def get_subgrid_size(self) -> int:
        return self.xM_size

    def get_contribution_size(self) -> int:
        return self.xM_yN_size

    # -- index maps -----------------------------------------------------------
    def _facet_positions(self, size: int, facet_offset: int):
        """Facet data positions in the padded facet and the Fb samples
        that weight them."""
        yN = self.yN_size
        j = np.arange(size)
        start = (int(facet_offset) - size // 2) % yN
        return (self._index((start + j) % yN),
                self._index(j + yN // 2 - size // 2))

    def _facet_contribution_index(self, subgrid_offset: int):
        """Positions of a subgrid's contribution in the padded facet."""
        m = self.xM_yN_size
        yN = self.yN_size
        sg_offs = _c_div(int(subgrid_offset),
                         self.image_size // self.yN_size)
        aliased = (sg_offs - m // 2) % m
        offs = sg_offs - aliased - m // 2
        i = np.arange(m)
        return self._index(np.where(i < aliased, (i + offs + m) % yN,
                                    (i + offs) % yN))

    def _subgrid_indices(self, facet_offset: int, use_mod: bool):
        """Target/source index maps for add_to/extract_from subgrid, as
        host arrays."""
        m = self.xM_yN_size
        xM = self.xM_size
        step = self.image_size // xM
        if use_mod:
            fct_offs = (int(facet_offset) % self.image_size) // step
        else:
            fct_offs = _c_div(int(facet_offset), step)
        offs = (-(m // 2) + xM // 2 + fct_offs) % xM
        i = np.arange(m)
        tgt = (i + offs) % xM
        src = (i + fct_offs + m // 2) % m
        return i, tgt, src

    def _extract_indices(self, facet_offset: int):
        """(subgrid positions, Fn) of each contribution element, in
        contribution order: the inverse permutation of the source map."""
        i, tgt, src = self._subgrid_indices(facet_offset, use_mod=False)
        inv = np.empty(self.xM_yN_size, np.int64)
        inv[src] = i
        return self._index(tgt[inv]), self.Fn[self._index(inv)]

    # -- facet -> subgrid chain ---------------------------------------------
    def prepare_facet(self, facet, facet_offset: int) -> torch.Tensor:
        """Multiply by Fb and inverse-Fourier transform
        (`sdp_swiftly_prepare_facet`, sdp_swiftly.cpp:173-267).

        ``facet`` has the true facet data (size <= yN) on its LAST axis;
        leading axes broadcast. Returns the prepared facet [..., yN].
        """
        facet = self._tensor(facet)
        xA = facet.shape[-1]
        yN = self.yN_size
        if xA > yN:
            raise SdpShapeError(f"Facet data too large ({xA}>{yN})!")
        positions, fb_idx = self._facet_positions(xA, facet_offset)
        out = torch.zeros(facet.shape[:-1] + (yN,),
                          dtype=torch.promote_types(facet.dtype,
                                                    torch.complex64),
                          device=self.device)
        out[..., positions] = (facet * self.Fb[fb_idx].to(facet.dtype)).to(
            out.dtype)
        return torch.fft.ifft(out, dim=-1)

    def extract_from_facet(self, prep_facet,
                           subgrid_offset: int) -> torch.Tensor:
        """Extract a compact subgrid contribution [..., xM_yN]
        (`sdp_swiftly_extract_from_facet`, sdp_swiftly.cpp:270-343)."""
        prep_facet = self._tensor(prep_facet)
        if prep_facet.shape[-1] != self.yN_size:
            raise SdpShapeError("prepared facet must have yN size")
        src = self._facet_contribution_index(subgrid_offset)
        return torch.fft.fft(prep_facet[..., src], dim=-1)

    def add_to_subgrid(self, contribution, subgrid_image,
                       facet_offset: int) -> torch.Tensor:
        """Accumulate a facet contribution into a subgrid image
        (`sdp_swiftly_add_to_subgrid`, sdp_swiftly.cpp:346-396)."""
        contribution = self._tensor(contribution)
        subgrid_image = self._tensor(subgrid_image)
        _, tgt, src = self._subgrid_indices(facet_offset, use_mod=True)
        tgt = self._index(tgt)
        vals = self.Fn.to(contribution.dtype) \
            * contribution[..., self._index(src)]
        out = subgrid_image.clone()
        out[..., tgt] = out[..., tgt] + vals.to(out.dtype)
        return out

    def add_to_subgrid_2d(self, contribution, subgrid_image,
                          facet_offset0: int,
                          facet_offset1: int) -> torch.Tensor:
        """2-D accumulate over the last two axes
        (`sdp_swiftly_add_to_subgrid_2d`, sdp_swiftly.cpp:399-478).
        NB: unlike the 1-D variant, offsets are NOT wrapped modulo the
        image size (matching the reference)."""
        contribution = self._tensor(contribution)
        subgrid_image = self._tensor(subgrid_image)
        _, tgt0, src0 = self._subgrid_indices(facet_offset0, use_mod=False)
        _, tgt1, src1 = self._subgrid_indices(facet_offset1, use_mod=False)
        tgt0, tgt1, src0, src1 = (self._index(x)
                                  for x in (tgt0, tgt1, src0, src1))
        fn = (self.Fn[:, None] * self.Fn[None, :]).to(contribution.dtype)
        vals = fn * contribution[..., src0[:, None], src1[None, :]]
        out = subgrid_image.clone()
        rows, cols = tgt0[:, None], tgt1[None, :]
        out[..., rows, cols] = out[..., rows, cols] + vals.to(out.dtype)
        return out

    def finish_subgrid_inplace(self, subgrid,
                               subgrid_offset: int) -> torch.Tensor:
        """Final iFFT + offset application
        (`sdp_swiftly_finish_subgrid_inplace`, sdp_swiftly.cpp:481-546)."""
        subgrid = self._tensor(subgrid)
        xM = self.xM_size
        tmp = torch.fft.ifft(torch.roll(subgrid, xM // 2, dims=-1), dim=-1)
        return torch.roll(tmp, -(int(subgrid_offset) + xM // 2), dims=-1)

    def finish_subgrid(self, subgrid_image, xA_size: int,
                       subgrid_offset: int) -> torch.Tensor:
        """Finish into a (possibly smaller) output of size xA
        (`sdp_swiftly_finish_subgrid`, sdp_swiftly.cpp:549-619)."""
        subgrid_image = self._tensor(subgrid_image)
        xM = self.xM_size
        if xA_size > xM:
            raise SdpShapeError(f"Subgrid data too large ({xA_size}>{xM})!")
        buf = torch.fft.ifft(torch.roll(subgrid_image, xM // 2, dims=-1),
                             dim=-1)
        i = np.arange(xA_size)
        return buf[..., self._index(
            (i - xA_size // 2 + int(subgrid_offset) + xM) % xM)]

    def finish_subgrid_inplace_2d(self, subgrid, subgrid_offset0: int,
                                  subgrid_offset1: int) -> torch.Tensor:
        """2-D finish over the last two axes
        (`sdp_swiftly_finish_subgrid_inplace_2d`,
        sdp_swiftly.cpp:622-723)."""
        subgrid = self._tensor(subgrid)
        xM = self.xM_size
        rolled = torch.roll(subgrid, (xM // 2, xM // 2), dims=(-2, -1))
        tmp = torch.fft.ifft2(rolled, dim=(-2, -1))
        return torch.roll(tmp, (-(int(subgrid_offset0) + xM // 2),
                                -(int(subgrid_offset1) + xM // 2)),
                          dims=(-2, -1))

    # -- subgrid -> facet chain ---------------------------------------------
    def prepare_subgrid_inplace(self, subgrid,
                                subgrid_offset: int) -> torch.Tensor:
        """Exact inverse of :meth:`finish_subgrid_inplace`
        (`sdp_swiftly_prepare_subgrid_inplace`, sdp_swiftly.cpp:726-777;
        roll-form instead of the reference's in-place phase ramp)."""
        subgrid = self._tensor(subgrid)
        xM = self.xM_size
        u = torch.roll(subgrid, int(subgrid_offset) + xM // 2, dims=-1)
        return torch.roll(torch.fft.fft(u, dim=-1), -(xM // 2), dims=-1)

    def prepare_subgrid_inplace_2d(self, subgrid, subgrid_offset0: int,
                                   subgrid_offset1: int) -> torch.Tensor:
        """Exact inverse of :meth:`finish_subgrid_inplace_2d`
        (`sdp_swiftly_prepare_subgrid_inplace_2d`,
        sdp_swiftly.cpp:780-845)."""
        subgrid = self._tensor(subgrid)
        xM = self.xM_size
        u = torch.roll(subgrid, (int(subgrid_offset0) + xM // 2,
                                 int(subgrid_offset1) + xM // 2),
                       dims=(-2, -1))
        return torch.roll(torch.fft.fft2(u, dim=(-2, -1)),
                          (-(xM // 2), -(xM // 2)), dims=(-2, -1))

    def extract_from_subgrid(self, subgrid_image,
                             facet_offset: int) -> torch.Tensor:
        """Extract a facet contribution from a prepared subgrid
        (`sdp_swiftly_extract_from_subgrid`, sdp_swiftly.cpp:851-914)."""
        subgrid_image = self._tensor(subgrid_image)
        pos, fn = self._extract_indices(facet_offset)
        vals = subgrid_image[..., pos] * fn.to(subgrid_image.dtype)
        return torch.fft.ifft(vals, dim=-1)

    def extract_from_subgrid_2d(self, subgrid_image, facet_offset0: int,
                                facet_offset1: int) -> torch.Tensor:
        """2-D extract (`sdp_swiftly_extract_from_subgrid_2d`,
        sdp_swiftly.cpp:917-1010)."""
        subgrid_image = self._tensor(subgrid_image)
        pos0, fn0 = self._extract_indices(facet_offset0)
        pos1, fn1 = self._extract_indices(facet_offset1)
        fn = (fn0[:, None] * fn1[None, :]).to(subgrid_image.dtype)
        vals = fn * subgrid_image[..., pos0[:, None], pos1[None, :]]
        return torch.fft.ifft2(vals, dim=(-2, -1))

    def add_to_facet(self, contribution, prep_facet,
                     subgrid_offset: int) -> torch.Tensor:
        """Accumulate a subgrid contribution into a prepared facet
        (`sdp_swiftly_add_to_facet`, sdp_swiftly.cpp:1016-1076)."""
        contribution = self._tensor(contribution)
        prep_facet = self._tensor(prep_facet)
        tgt = self._facet_contribution_index(subgrid_offset)
        out = prep_facet.clone()
        out[..., tgt] = out[..., tgt] + contribution.to(out.dtype)
        return out

    def finish_facet(self, prep_facet, xA_size: int,
                     facet_offset: int) -> torch.Tensor:
        """FFT and multiply by Fb to recover the facet
        (`sdp_swiftly_finish_facet`, sdp_swiftly.cpp:1079-1157)."""
        prep_facet = self._tensor(prep_facet)
        yN = self.yN_size
        if xA_size > yN:
            raise SdpShapeError(f"Facet data too large ({xA_size}>{yN})!")
        transformed = torch.fft.fft(prep_facet, dim=-1)
        positions, fb_idx = self._facet_positions(xA_size, facet_offset)
        return transformed[..., positions] \
            * self.Fb[fb_idx].to(transformed.dtype)
