"""W-towers gridder plan (kernels and w-pattern only).

Counterpart of the plan half of ska_sdp_func_tpu.grid_data.wtower
(`GridderWtowerUVW`, wtower.py:72-131, and `_tap_coeffs_cached`,
:675; reference sdp_gridder_wtower_uvw.cpp:660-723). The per-subgrid
grid/degrid methods are not ported yet (ROADMAP Queue 1 item 10); the
packed whole-image driver only needs the plan's tables.
"""

from functools import lru_cache

import numpy as np

from ..utility.errors import SdpInvalidArgumentError
from .kernels import kernel_tap_coeffs, make_pswf_kernel, make_w_pattern


class GridderWtowerUVW:
    """Plan for w-towers / w-stacking uvw (de)gridding: the oversampled
    PSWF uv/w kernels (host f64) and the complex w-pattern (host c128).
    Mirrors `sdp_gridder_wtower_uvw_create`
    (sdp_gridder_wtower_uvw.h:59-100)."""

    def __init__(self, image_size: int, subgrid_size: int, theta: float,
                 w_step: float, shear_u: float, shear_v: float,
                 support: int, oversampling: int, w_support: int,
                 w_oversampling: int):
        if subgrid_size % 2 != 0:
            # An odd sub-grid breaks the FFT shift
            # (sdp_gridder_wtower_uvw.cpp:674-682).
            raise SdpInvalidArgumentError(
                f"Subgrid size must be even (value given was {subgrid_size})."
            )
        self.image_size = int(image_size)
        self.subgrid_size = int(subgrid_size)
        self.theta = float(theta)
        self.w_step = float(w_step)
        self.shear_u = float(shear_u)
        self.shear_v = float(shear_v)
        self.support = int(support)
        self.oversampling = int(oversampling)
        self.w_support = int(w_support)
        self.w_oversampling = int(w_oversampling)
        self._num_w_planes = [0, 0]  # [degridding, gridding] counters

        self.uv_kernel = np.ascontiguousarray(
            make_pswf_kernel(self.support, self.support, self.oversampling))
        self.w_kernel = np.ascontiguousarray(
            make_pswf_kernel(self.w_support, self.w_support,
                             self.w_oversampling))
        # iDFT of a sole visibility at (0, 0, w_step).
        self.w_pattern = np.ascontiguousarray(
            make_w_pattern(self.subgrid_size, self.theta, self.shear_u,
                           self.shear_v, self.w_step))

    def num_w_planes(self, gridding: int) -> int:
        """Processed w-plane counter (0: degridding, 1: gridding)."""
        if gridding in (0, 1):
            return self._num_w_planes[gridding]
        return 0


@lru_cache(maxsize=16)
def _tap_coeffs_cached(support: int, oversampling: int):
    return kernel_tap_coeffs(support, support, oversampling)
