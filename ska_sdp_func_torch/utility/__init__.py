"""Errors and constants shared by the port's modules, SKA-format logging
(:mod:`.logging`) and the named timer tree (:mod:`.timers`)."""

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

__all__ = [
    "C_0",
    "CError",
    "SdpDataTypeError",
    "SdpError",
    "SdpInvalidArgumentError",
    "SdpMemLocationError",
    "SdpRuntimeError",
    "SdpShapeError",
]
