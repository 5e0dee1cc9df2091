"""Error model (counterpart of ska_sdp_func_tpu.utility.errors).

The reference threads an `sdp_Error*` status through every call
(utility/sdp_errors.h:13-35); here, as in the JAX package, each status
is an exception raised where the reference's check macros would fire.
"""


class SdpError(RuntimeError):
    """Base class for all framework errors (maps sdp_Error != SDP_SUCCESS)."""


class SdpRuntimeError(SdpError):
    """Generic runtime failure (SDP_ERR_RUNTIME)."""


class SdpInvalidArgumentError(SdpError, ValueError):
    """Invalid function argument (SDP_ERR_INVALID_ARGUMENT)."""


class SdpDataTypeError(SdpError, TypeError):
    """Unsupported data type (SDP_ERR_DATA_TYPE)."""


class SdpMemLocationError(SdpError):
    """Unsupported device placement (SDP_ERR_MEM_LOCATION): a tensor
    lies on another device than the operation requires."""


# The reference Python package's exception name
# (utility/error_checking.py:30-46).
CError = SdpError


class SdpShapeError(SdpInvalidArgumentError):
    """Array has the wrong number of dimensions or extent."""
