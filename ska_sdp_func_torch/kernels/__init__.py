"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

:mod:`.packed_tap` holds the packed whole-image path's two kernels (the
ports of the Pallas kernels ``grid_packed_stack_pallas`` and
``degrid_stack_pallas``); :mod:`._build` compiles ``csrc/`` with nvcc at
first use.
"""

from .packed_tap import (
    build_bands,
    degrid_stack,
    degrid_stack_reference,
    grid_packed_stack,
    grid_packed_stack_reference,
    launch_counts,
    reset_launch_counts,
    split_bf16,
)

__all__ = [
    "build_bands",
    "degrid_stack",
    "degrid_stack_reference",
    "grid_packed_stack",
    "grid_packed_stack_reference",
    "launch_counts",
    "reset_launch_counts",
    "split_bf16",
]
