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
