"""W-tower height optimiser: find the tallest tower that meets an error
target.

Counterpart of ska_sdp_func_tpu.grid_data.wtower_height (reference
grid_data/sdp_gridder_wtower_height.{h,cpp}): degrid a worst-case image
(sources in the fov corners, off the grid lattice) at increasing w
offsets, measure the RMS error against the exact DFT, and binary-search
the largest height (`sdp_gridder_determine_max_w_tower_height`,
sdp_gridder_wtower_height.h:42-58; `sdp_gridder_worst_case_image`
:70-75). The image is complex128, so the sub-grid gridder takes its
plain (dense) path on every device; the search runs on ``device``
(``None``: the CUDA card; CPU runs pass ``device="cpu"``).
"""

import numpy as np

from ..fourier_transforms.fft import fft_shifted, ifft_shifted_norm
from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError
from ..utility.tensors import on_device
from .gridder_utils import dft, image_to_flmn, rms_diff, subgrid_cut_out
from .wtower import GridderWtowerUVW


def worst_case_image(theta: float, fov: float, image_size: int,
                     dtype=np.complex128) -> np.ndarray:
    """Worst-case test image (NumPy): sources in the fov corners, placed
    so they do not divide the grid evenly (`sdp_gridder_worst_case_image`,
    sdp_gridder_wtower_height.cpp:275-316)."""
    fov_edge = int(image_size / theta * fov / 2)
    while image_size % fov_edge == 0:
        fov_edge -= 1
    image = np.zeros((image_size, image_size), dtype)
    half = image_size // 2
    image[half + fov_edge, half + fov_edge] = 0.3
    image[half - fov_edge, half - fov_edge] = 0.2
    image[half + fov_edge, half - fov_edge - 1] = 0.3
    image[half - fov_edge - 1, half + fov_edge] = 0.2
    return image


def _find_gridder_accuracy(kernel: GridderWtowerUVW, fov: float,
                           subgrid_frac: float, num_samples: int,
                           w: float, device) -> float:
    """RMS degrid error at w offset (find_gridder_accuracy,
    sdp_gridder_wtower_height.cpp:19-185)."""
    if num_samples == 0:
        num_samples = 3
    image_size = kernel.image_size
    subgrid_size = kernel.subgrid_size
    theta = kernel.theta

    image = worst_case_image(theta, fov, image_size)
    flux, lmn = image_to_flmn(image, theta, kernel.shear_u, kernel.shear_v)

    # Apply the correction, then extract the central sub-grid:
    # subgrid = ifft(subgrid_cut_out(fft(image), subgrid_size)).
    corrected = kernel.degrid_correct(image, 0, 0, 0, device=device)
    grid = fft_shifted(corrected)
    subgrid = ifft_shifted_norm(subgrid_cut_out(grid, 0, 0, subgrid_size))

    # Sample points with |u|, |v| within the effective sub-grid radius.
    if subgrid_frac == 0.0:
        subgrid_frac = 2.0 / 3.0
    start = -subgrid_size * subgrid_frac / theta / 2
    end = subgrid_size * subgrid_frac / theta / 2
    step = (end - start) / (num_samples - 1)
    uvws = np.zeros((num_samples * num_samples, 3))
    for i in range(num_samples):
        for j in range(num_samples):
            uvws[i * num_samples + j] = [start + j * step,
                                         start + i * step, w]
    num_rows = uvws.shape[0]
    uvws, start_chs, end_chs = on_device(
        uvws, np.zeros(num_rows, np.int32), np.ones(num_rows, np.int32),
        device=device)

    vis_test = kernel.degrid_subgrid(subgrid, (0, 0, 0), 1, C_0, C_0, uvws,
                                     start_chs, end_chs, device=device)
    # The exact DFT (uvw already in wavelengths here: freq0 = C_0).
    vis_ref = dft(uvws, flux, lmn, None, None, 0, 0, 0, 0.0, 0.0, C_0, C_0,
                  1, device=device)
    return float(rms_diff(vis_test, vis_ref))


def determine_max_w_tower_height(image_size: int, subgrid_size: int,
                                 theta: float, w_step: float,
                                 shear_u: float = 0.0, shear_v: float = 0.0,
                                 support: int = 8, oversampling: int = 16384,
                                 w_support: int = 8,
                                 w_oversampling: int = 16384,
                                 fov: float = 0.0,
                                 subgrid_frac: float = 0.0,
                                 num_samples: int = 0,
                                 target_err: float = 0.0,
                                 device=None) -> float:
    """Binary-search the maximum w-tower height for an error target.

    Equivalent of `sdp_gridder_determine_max_w_tower_height`
    (sdp_gridder_wtower_height.cpp:188-272). If ``target_err`` is 0 it
    defaults to twice the error at w = 0. Returns the height in w-planes
    (an even number, like the reference's ``2 * iw`` convention).
    """
    if fov == 0.0:
        raise SdpInvalidArgumentError("fov must be specified")
    kernel = GridderWtowerUVW(image_size, subgrid_size, theta, w_step,
                              shear_u, shear_v, support, oversampling,
                              w_support, w_oversampling)
    if target_err == 0.0:
        target_err = 2 * _find_gridder_accuracy(
            kernel, fov, subgrid_frac, num_samples, 0.0, device)

    iw, diw = 1, 1
    accelerate = True
    while True:
        err = _find_gridder_accuracy(
            kernel, fov, subgrid_frac, num_samples, iw * w_step, device)
        if err < target_err:
            if accelerate:
                diw *= 2
            elif diw > 1:
                diw //= 2
            else:
                return float(2 * iw)
            iw += diw
        elif diw > 1:
            diw //= 2
            iw -= diw
            accelerate = False
        else:
            return float(2 * (iw - 1))


# Alias matching the reference's Python helper name
# (src/ska_sdp_func/grid_data/gridder_utils.py:206).
find_max_w_tower_height = determine_max_w_tower_height
