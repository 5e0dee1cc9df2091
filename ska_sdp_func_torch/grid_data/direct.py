"""Direct (DFT) sub-grid (de)gridder: the exact accuracy oracle of the
w-towers gridder.

Counterpart of ska_sdp_func_tpu.grid_data.direct (reference
grid_data/sdp_gridder_direct.{h,cpp}). The same plan and API as
:class:`~.wtower.GridderWtowerUVW` without the w-kernels: degrid turns
the non-zero pixels into (flux, lmn) components on the host and runs the
exact DFT; grid runs the exact iDFT over every pixel. Both apply the
PSWF taper sampled over the sub-grid (first sample forced to 1e-15,
sdp_gridder_direct.cpp:50-55). Each method runs on ``device`` (``None``:
the CUDA card; CPU runs pass ``device="cpu"``) and moves its inputs
there.
"""

from typing import Tuple

import numpy as np

from ..fourier_transforms.pswf import generate_pswf
from ..utility.tensors import on_device
from .grid_correct import grid_correct_pswf, grid_correct_w_stack
from .gridder_utils import dft, idft, image_lmn, image_to_flmn


class GridderDirect:
    """Plan for direct (de)gridding using a DFT
    (`sdp_gridder_direct_create`, sdp_gridder_direct.h:57-76)."""

    def __init__(self, image_size: int, subgrid_size: int, theta: float,
                 w_step: float, shear_u: float, shear_v: float,
                 support: int):
        self.image_size = int(image_size)
        self.subgrid_size = int(subgrid_size)
        self.theta = float(theta)
        self.w_step = float(w_step)
        self.shear_u = float(shear_u)
        self.shear_v = float(shear_v)
        self.support = int(support)
        pswf = generate_pswf(0, support * (np.pi / 2), self.subgrid_size)
        pswf[0] = 1e-15
        self.pswf_sg = pswf

    def degrid_subgrid(self, subgrid_image,
                       subgrid_offset: Tuple[int, int, int], ch_count: int,
                       freq0_hz: float, dfreq_hz: float, uvws, start_chs,
                       end_chs, vis=None, device=None):
        """Degrid via DFT over the non-zero, PSWF-tapered pixels
        (`sdp_gridder_direct_degrid`, sdp_gridder_direct.cpp:60-101)."""
        off_u, off_v, off_w = (int(o) for o in subgrid_offset)
        flux, lmn = image_to_flmn(subgrid_image, self.theta, self.shear_u,
                                  self.shear_v, self.pswf_sg)
        return dft(uvws, flux, lmn, start_chs, end_chs, off_u, off_v, off_w,
                   self.theta, self.w_step, freq0_hz, dfreq_hz, ch_count,
                   vis, device=device)

    def grid_subgrid(self, vis, uvws, start_chs, end_chs, ch_count: int,
                     freq0_hz: float, dfreq_hz: float, subgrid_image,
                     subgrid_offset: Tuple[int, int, int], device=None):
        """Grid via iDFT over all pixels, PSWF-tapered
        (`sdp_gridder_direct_grid`, sdp_gridder_direct.cpp:127-166).
        Returns ``subgrid_image + contribution``."""
        off_u, off_v, off_w = (int(o) for o in subgrid_offset)
        (subgrid_image,) = on_device(subgrid_image, device=device)
        lmn = image_lmn(tuple(subgrid_image.shape), self.theta,
                        self.shear_u, self.shear_v, device=device)
        return idft(uvws, vis, lmn, start_chs, end_chs, self.pswf_sg,
                    off_u, off_v, off_w, self.theta, self.w_step, freq0_hz,
                    dfreq_hz, image=subgrid_image, device=device)

    def _correct(self, facet, facet_offset_l, facet_offset_m, w_offset,
                 inverse, device):
        facet = grid_correct_pswf(self.image_size, self.theta, self.w_step,
                                  self.shear_u, self.shear_v, self.support,
                                  0, facet, facet_offset_l, facet_offset_m,
                                  device=device)
        if facet.is_complex():
            facet = grid_correct_w_stack(
                self.image_size, self.theta, self.w_step, self.shear_u,
                self.shear_v, facet, facet_offset_l, facet_offset_m,
                w_offset, inverse=inverse)
        return facet

    def degrid_correct(self, facet, facet_offset_l: int = 0,
                       facet_offset_m: int = 0, w_offset: int = 0,
                       device=None):
        """PSWF image correction without a w-kernel term
        (`sdp_gridder_direct_degrid_correct`), on ``device``."""
        (facet,) = on_device(facet, device=device)
        return self._correct(facet, facet_offset_l, facet_offset_m,
                             w_offset, False, device)

    def grid_correct(self, facet, facet_offset_l: int = 0,
                     facet_offset_m: int = 0, w_offset: int = 0,
                     device=None):
        """The grid-side correction (`sdp_gridder_direct_grid_correct`),
        on ``device``."""
        (facet,) = on_device(facet, device=device)
        return self._correct(facet, facet_offset_l, facet_offset_m,
                             w_offset, True, device)
