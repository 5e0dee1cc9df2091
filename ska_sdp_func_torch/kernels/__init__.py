"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

:mod:`.packed_tap` holds the packed whole-image path's two kernels (the
ports of the Pallas kernels ``grid_packed_stack_pallas`` and
``degrid_stack_pallas``); :mod:`.tower_tap` the w-towers tap kernels
(the ports of ``grid_plane_pallas``, ``degrid_plane_pallas``,
``grid_all_layers_pallas`` and ``degrid_all_layers_pallas``);
:mod:`.dense_tap` the dense banded products of any dtype; :mod:`._build`
compiles ``csrc/`` with nvcc at first use.
"""

from . import tower_tap
from .packed_tap import (
    build_bands,
    degrid_stack,
    degrid_stack_reference,
    grid_packed_stack,
    grid_packed_stack_reference,
    split_bf16,
)


def launch_counts() -> dict:
    """Kernel launches per wrapper, every kernel of the package."""
    from . import packed_tap

    return {**packed_tap.launch_counts(), **tower_tap.launch_counts()}


def reset_launch_counts() -> None:
    from . import packed_tap

    packed_tap.reset_launch_counts()
    tower_tap.reset_launch_counts()


__all__ = [
    "build_bands",
    "degrid_stack",
    "degrid_stack_reference",
    "grid_packed_stack",
    "grid_packed_stack_reference",
    "launch_counts",
    "reset_launch_counts",
    "split_bf16",
    "tower_tap",
]
