"""Errors and constants shared by the port's modules, SKA-format logging
(:mod:`.logging`), the named timer tree (:mod:`.timers`) and trace
capture (:mod:`.profiling`)."""

from .constants import C_0
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
from .profiling import annotate, trace
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
    "Timer",
    "TimerType",
    "Timers",
    "annotate",
    "get_logger",
    "log_critical",
    "log_debug",
    "log_error",
    "log_info",
    "log_warning",
    "trace",
]
