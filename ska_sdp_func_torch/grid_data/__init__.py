"""Gridding helpers: kernel tables, grid correction, sub-grid placement
and the w-towers plan object."""

from .grid_correct import grid_correct_pswf, w_screen_stack
from .gridder_utils import subgrid_add_static, subgrid_cut_out_static
from .kernels import (
    eval_kernel_taps,
    kernel_tap_coeffs,
    lm_to_n,
    make_kernel,
    make_pswf_kernel,
    make_w_pattern,
)
from .wtower import GridderWtowerUVW

__all__ = [
    "GridderWtowerUVW",
    "eval_kernel_taps",
    "grid_correct_pswf",
    "kernel_tap_coeffs",
    "lm_to_n",
    "make_kernel",
    "make_pswf_kernel",
    "make_w_pattern",
    "subgrid_add_static",
    "subgrid_cut_out_static",
    "w_screen_stack",
]
