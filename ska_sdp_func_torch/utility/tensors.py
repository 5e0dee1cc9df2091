"""Moving caller data onto a device."""

import numpy as np
import torch


def to_device(x, device) -> torch.Tensor:
    """A tensor on ``device``: tensors move (no copy when already there);
    NumPy arrays and sequences are copied, so read-only arrays are safe."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)
