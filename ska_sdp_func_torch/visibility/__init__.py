"""Visibility-domain functions: point-source DFT prediction, phase
rotation, imaging weights (uniform, Briggs, tiled Briggs), uv-tile
binning and the FluctuFlagger (reference src/ska_sdp_func/visibility)."""

from .dft import dft_point_v00, dft_point_v01
from .phase_rotate import phase_rotate_uvw, phase_rotate_vis

__all__ = [
    "dft_point_v00",
    "dft_point_v01",
    "phase_rotate_uvw",
    "phase_rotate_vis",
    # lazy (PEP 562) exports resolve in __getattr__ below
    "briggs_weights",
    "bucket_sort",
    "count_and_prefix_sum",
    "flagger_dynamic_threshold",
    "get_uv_range",
    "optimised_indexed_weighting",
    "optimized_weighting",
    "tiled_indexing",
    "uniform_weights",
]


def __getattr__(name):
    lazy = {
        "flagger_dynamic_threshold": ".flagger",
        "briggs_weights": ".weighting",
        "uniform_weights": ".weighting",
        "get_uv_range": ".weighting",
        "optimized_weighting": ".opt_weighting",
        "optimised_indexed_weighting": ".opt_weighting",
        "count_and_prefix_sum": ".tiled_functions",
        "bucket_sort": ".tiled_functions",
        "tiled_indexing": ".tiled_functions",
    }
    if name in lazy:
        import importlib

        module = importlib.import_module(lazy[name], __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
