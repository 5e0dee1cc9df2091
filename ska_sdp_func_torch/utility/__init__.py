"""Errors and constants shared by the port's modules, the data-model
checks (:mod:`.data_model`), the sky coordinate (:mod:`.sky_coord`),
SKA-format logging (:mod:`.logging`), the named timer tree
(:mod:`.timers`) and trace capture (:mod:`.profiling`)."""

from .constants import C_0
from .data_model import (
    check_uvw,
    check_vis,
    check_weights,
    get_uvw_metadata,
    get_vis_metadata,
)
from .errors import (
    CError,
    SdpDataTypeError,
    SdpError,
    SdpInvalidArgumentError,
    SdpMemLocationError,
    SdpRuntimeError,
    SdpShapeError,
)
from .logging import (
    get_logger,
    log_critical,
    log_debug,
    log_error,
    log_info,
    log_warning,
)
from .profiling import annotate, annotated, spans, trace
from .sky_coord import SkyCoord
from .timers import Timer, Timers, TimerType

__all__ = [
    "C_0",
    "CError",
    "SdpDataTypeError",
    "SdpError",
    "SdpInvalidArgumentError",
    "SdpMemLocationError",
    "SdpRuntimeError",
    "SdpShapeError",
    "SkyCoord",
    "Timer",
    "TimerType",
    "Timers",
    "annotate",
    "annotated",
    "check_uvw",
    "check_vis",
    "check_weights",
    "get_logger",
    "get_uvw_metadata",
    "get_vis_metadata",
    "log_critical",
    "log_debug",
    "log_error",
    "log_info",
    "log_warning",
    "spans",
    "trace",
]
