"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

:mod:`.packed_tap` holds the packed whole-image path's band kernels (the
ports of the Pallas kernels ``grid_packed_stack_pallas`` and
``degrid_stack_pallas``); :mod:`.fused_tap` the fused kernels that
evaluate the taps themselves (``grid_fused_stack_pallas``,
``degrid_fused2_stack_pallas``) and the compact ones that read
pre-evaluated taps (``grid_compact_pallas``, ``degrid_compact_pallas``);
:mod:`.band_tap` the bucket-window kernels of the ES-FFT gridder and the
streaming engine's non-packable branch (``grid_packed_pallas``,
``degrid_fused_pallas``, with their bf16 mode) and their twins that
evaluate the taps from the plan words (``grid_fused_pallas``,
``degrid_fused2_pallas``); :mod:`.stream_prep` that branch's tap
preparation (``stream_prep_grid_pallas``, ``stream_prep_degrid_pallas``)
and :mod:`.fold` its window fold (``fold_groups_pallas`` with
``fold_layers_pallas``); :mod:`.place` the streaming plan's placement
(``place_stream_pallas``); :mod:`.tower_tap` the w-towers tap
kernels (the ports of ``grid_plane_pallas``, ``degrid_plane_pallas``,
``grid_all_layers_pallas`` and ``degrid_all_layers_pallas``, with
their bf16 mode) and :mod:`.sparse_tap` their sparse all-layer twin
(``grid_all_layers_sparse``); :mod:`.dense_tap` the dense banded
products of any dtype; :mod:`._build` compiles ``csrc/`` with nvcc at
first use.

The A/B kernels of the experiments (no entry point runs them; the
drivers in :mod:`ska_sdp_func_torch.experiments` do): :mod:`.read_probe`
bench.py's device-memory read probe; :mod:`.prep_variants` exp_prep's
stage sweep of the tap preparation; :mod:`.bucket_dot` exp_dot's and
exp_parity's per-bucket band products on the tensor cores;
:mod:`.overlap` exp_overlap's build / product overlap probe.
"""

from . import band_tap, bucket_dot, fold, fused_tap, overlap, packed_tap, \
    place, prep_variants, read_probe, sparse_tap, stream_prep, tower_tap
from .dense_tap import degrid_plane_dense, grid_plane_dense
from .packed_tap import (
    build_bands,
    degrid_stack,
    degrid_stack_reference,
    grid_packed_stack,
    grid_packed_stack_reference,
    split_bf16,
)

_COUNTED = (packed_tap, fused_tap, place, tower_tap, sparse_tap, band_tap,
            stream_prep, fold, read_probe, prep_variants, bucket_dot,
            overlap)


def launch_counts() -> dict:
    """Kernel launches per wrapper, every kernel of the package."""
    counts = {}
    for mod in _COUNTED:
        counts.update(mod.launch_counts())
    return counts


def reset_launch_counts() -> None:
    for mod in _COUNTED:
        mod.reset_launch_counts()


__all__ = [
    "band_tap",
    "bucket_dot",
    "build_bands",
    "degrid_plane_dense",
    "degrid_stack",
    "degrid_stack_reference",
    "fold",
    "fused_tap",
    "grid_plane_dense",
    "grid_packed_stack",
    "grid_packed_stack_reference",
    "launch_counts",
    "overlap",
    "packed_tap",
    "place",
    "prep_variants",
    "read_probe",
    "reset_launch_counts",
    "sparse_tap",
    "split_bf16",
    "stream_prep",
    "tower_tap",
]
