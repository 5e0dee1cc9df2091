"""Gridding helpers and drivers: kernel tables, grid correction, channel
clamping, sub-grid placement, array algebra, image <-> component lists,
the direct Fourier transforms, the w-towers gridder, the w-stacking
whole-image drivers, the ES-FFT gridder, and (lazily) the direct
gridder, the custom degridder and the w-tower height search."""

from .clamp_channels import (
    clamp_channels_inline,
    clamp_channels_single,
    clamp_channels_uv,
)
from .es_fft import GridderUvwEsFft
from .es_params import calculate_params_from_epsilon
from .grid_correct import (
    grid_correct_pswf,
    grid_correct_w_stack,
    w_screen_stack,
)
from .gridder_utils import (
    accumulate_scaled_arrays,
    count_nonzero_pixels,
    determine_w_step,
    dft,
    idft,
    image_lmn,
    image_to_flmn,
    residual,
    rms_diff,
    scale_inv_array,
    shift_subgrids,
    subgrid_add,
    subgrid_add_static,
    subgrid_cut_out,
    subgrid_cut_out_static,
    sum_diff,
    uvw_bounds_all,
)
from .kernels import (
    eval_kernel_taps,
    kernel_tap_coeffs,
    lm_to_n,
    make_kernel,
    make_pswf_kernel,
    make_w_pattern,
)
from .wstack import wstack_wtower_degrid_all, wstack_wtower_grid_all
from .wtower import GridderWtowerUVW

__all__ = [
    # lazy (PEP 562) exports resolve in __getattr__ below
    "GridderDirect",
    "degrid_uvw_custom",
    "determine_max_w_tower_height",
    "find_max_w_tower_height",
    "worst_case_image",
    "GridderUvwEsFft",
    "GridderWtowerUVW",
    "accumulate_scaled_arrays",
    "calculate_params_from_epsilon",
    "clamp_channels_inline",
    "clamp_channels_single",
    "clamp_channels_uv",
    "count_nonzero_pixels",
    "determine_w_step",
    "dft",
    "eval_kernel_taps",
    "grid_correct_pswf",
    "grid_correct_w_stack",
    "idft",
    "image_lmn",
    "image_to_flmn",
    "kernel_tap_coeffs",
    "lm_to_n",
    "make_kernel",
    "make_pswf_kernel",
    "make_w_pattern",
    "residual",
    "rms_diff",
    "scale_inv_array",
    "shift_subgrids",
    "subgrid_add",
    "subgrid_add_static",
    "subgrid_cut_out",
    "subgrid_cut_out_static",
    "sum_diff",
    "uvw_bounds_all",
    "w_screen_stack",
    "wstack_wtower_degrid_all",
    "wstack_wtower_grid_all",
]


_LAZY = {
    "GridderDirect": ".direct",
    "degrid_uvw_custom": ".custom",
    "determine_max_w_tower_height": ".wtower_height",
    "find_max_w_tower_height": ".wtower_height",
    "worst_case_image": ".wtower_height",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
