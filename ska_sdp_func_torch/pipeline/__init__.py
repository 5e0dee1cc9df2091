"""Imaging pipeline: the visibility ingest (RFI flagging, imaging and
primary-beam weights), the major-cycle CLEAN solver (Hogbom or
multi-scale minor cycles), the FISTA solver and solver checkpointing."""

from .checkpoint import (
    SolverCheckpointer,
    load_result,
    load_state,
    save_result,
    save_state,
)
from .fista import FistaResult, fista_imager
from .ingest import (
    ingest_flag_and_weight,
    ingest_flag_and_weight_sharded,
    ingest_to_solver,
    station_beam_power,
)
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
    "ingest_flag_and_weight",
    "ingest_flag_and_weight_sharded",
    "ingest_to_solver",
    "load_result",
    "load_state",
    "major_cycle_imager",
    "make_psf_plan",
    "save_result",
    "save_state",
    "station_beam_power",
]
