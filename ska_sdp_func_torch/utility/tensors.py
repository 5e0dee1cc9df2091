"""Moving caller data onto a device."""

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``None`` is the CUDA card (never
    the CPU by default; on a host without one the first tensor move
    raises); a bare ``"cuda"`` gets the current card's index."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None \
            and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def to_device(x, device) -> torch.Tensor:
    """A tensor on ``device``: tensors move (no copy when already there);
    NumPy arrays and sequences are copied, so read-only arrays are safe."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def as_tensors(*xs, device=None):
    """Caller data as tensors on one device, where the JAX package's public
    helpers take it with ``jnp.asarray``: tensors keep their device, and
    NumPy arrays or sequences are copied to the first tensor's device, or
    to ``device`` when none is a tensor (None: the CUDA card,
    :func:`resolve_device`). Returns a tuple."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    dev = resolve_device(device) if dev is None else dev
    return tuple(to_device(x, dev) for x in xs)


def host_uvw(uvw) -> np.ndarray:
    """uvw as a host f64 NumPy array, from NumPy data or a tensor on any
    device (one copy to the host)."""
    if isinstance(uvw, torch.Tensor):
        uvw = uvw.detach().cpu().numpy()
    return np.ascontiguousarray(uvw, dtype=np.float64)


def on_device(*xs, device=None):
    """Caller data as tensors on ``device`` (None: the CUDA card,
    :func:`resolve_device`), where the port's entry points take it:
    tensors move (no copy when already there), NumPy arrays and sequences
    are copied, and ``None`` stays ``None``. Returns a tuple."""
    dev = resolve_device(device)
    return tuple(None if x is None else to_device(x, dev) for x in xs)


def divide(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as an elementwise division on every device, as JAX
    divides outside ``jit``. (CUDA divides by a host scalar by multiplying
    with its reciprocal, which can move a ``floor`` or ``round`` by one
    against the CPU.)"""
    return x / torch.tensor(value, dtype=x.dtype, device=x.device)


def times_inverse(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x * (1 / value)``, the inverse rounded to ``x``'s dtype: what XLA
    makes of a division by a constant inside ``jit``, the same on every
    device."""
    one = torch.tensor(1.0, dtype=x.dtype)
    return x * (one / torch.tensor(value, dtype=x.dtype))
