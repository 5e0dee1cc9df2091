"""Canonical SKA data-model validation.

Counterpart of ska_sdp_func_tpu.utility.data_model (reference
utility/sdp_data_model_checks.{h,c}, sdp_data_model_checks.h:38-304):
uvw ``[time, baseline, 3]``, visibilities ``[time, baseline, chan, pol]``
and weights matching them, each check raising :class:`SdpShapeError` or
:class:`SdpDataTypeError`; and the metadata getters. The helpers take
tensors or NumPy arrays (anything with ``ndim``, ``shape`` and ``dtype``).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from .errors import SdpDataTypeError, SdpShapeError


def is_floating(dtype) -> bool:
    """Real floating dtype, torch or NumPy."""
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return np.issubdtype(dtype, np.floating)


def is_complex(dtype) -> bool:
    """Complex dtype, torch or NumPy."""
    if isinstance(dtype, torch.dtype):
        return dtype.is_complex
    return np.issubdtype(dtype, np.complexfloating)


def check_uvw(uvw, expected_num_times: Optional[int] = None,
              expected_num_baselines: Optional[int] = None) -> None:
    """Validate uvw coordinates shaped ``[num_times, num_baselines, 3]``."""
    if uvw.ndim != 3:
        raise SdpShapeError(
            f"uvw must be 3D [time, baseline, 3]; got {uvw.ndim}D")
    if uvw.shape[-1] != 3:
        raise SdpShapeError(
            f"last uvw dimension must be 3; got {uvw.shape[-1]}")
    if not is_floating(uvw.dtype):
        raise SdpDataTypeError(f"uvw must be real floating; got {uvw.dtype}")
    if expected_num_times is not None and uvw.shape[0] != expected_num_times:
        raise SdpShapeError(
            f"uvw num_times {uvw.shape[0]} != expected {expected_num_times}")
    if (expected_num_baselines is not None
            and uvw.shape[1] != expected_num_baselines):
        raise SdpShapeError(
            f"uvw num_baselines {uvw.shape[1]} != "
            f"expected {expected_num_baselines}")


def check_vis(vis) -> None:
    """Validate visibilities shaped ``[time, baseline, chan, pol]``."""
    if vis.ndim != 4:
        raise SdpShapeError(
            f"vis must be 4D [time, baseline, chan, pol]; got {vis.ndim}D")
    if not is_complex(vis.dtype):
        raise SdpDataTypeError(f"vis must be complex; got {vis.dtype}")
    num_pols = vis.shape[3]
    if num_pols not in (1, 2, 4):
        raise SdpShapeError(f"num_pols must be 1, 2 or 4; got {num_pols}")


def check_weights(weights, vis=None) -> None:
    """Validate weights; if ``vis`` is given, the shapes must match."""
    if weights.ndim != 4:
        raise SdpShapeError(
            f"weights must be 4D [time, baseline, chan, pol]; "
            f"got {weights.ndim}D")
    if not is_floating(weights.dtype):
        raise SdpDataTypeError(
            f"weights must be real floating; got {weights.dtype}")
    if vis is not None and tuple(weights.shape) != tuple(vis.shape):
        raise SdpShapeError(
            f"weights shape {tuple(weights.shape)} != "
            f"vis shape {tuple(vis.shape)}")


class UvwMetadata(NamedTuple):
    num_times: int
    num_baselines: int


class VisMetadata(NamedTuple):
    num_times: int
    num_baselines: int
    num_channels: int
    num_pols: int


def get_uvw_metadata(uvw) -> UvwMetadata:
    check_uvw(uvw)
    return UvwMetadata(int(uvw.shape[0]), int(uvw.shape[1]))


def get_vis_metadata(vis) -> VisMetadata:
    check_vis(vis)
    return VisMetadata(*(int(s) for s in vis.shape))
