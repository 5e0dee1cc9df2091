"""Imaging pipeline: the major-cycle CLEAN solver (Hogbom or multi-scale
minor cycles), the FISTA solver and solver checkpointing."""

from .checkpoint import (
    SolverCheckpointer,
    load_result,
    load_state,
    save_result,
    save_state,
)
from .fista import FistaResult, fista_imager
from .major_cycle import (
    ImagingResult,
    dirty_and_psf,
    major_cycle_imager,
    make_psf_plan,
)

__all__ = [
    "FistaResult",
    "ImagingResult",
    "SolverCheckpointer",
    "dirty_and_psf",
    "fista_imager",
    "load_result",
    "load_state",
    "major_cycle_imager",
    "make_psf_plan",
    "save_result",
    "save_state",
]
