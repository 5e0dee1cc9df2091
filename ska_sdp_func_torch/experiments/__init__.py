"""A/B drivers of the experiments' kernels, on the card.

Each module is the counterpart of one of the repository's TPU harnesses
(``experiments/<name>.py``, and bench.py's read probe for
:mod:`.rooflines`) and asks its question of the Hopper kernel that a
production kernel would be redesigned into:

- :mod:`.rooflines`: the card's measured device-memory read rate
  (``measure_read_bandwidth``; kernel :mod:`..kernels.read_probe`);
- :mod:`.exp_place_dma`: K5's gap-insertion placement against the
  placement sort (kernel :mod:`..kernels.place`);
- :mod:`.exp_prep`: which stage of the tap preparation (K6/K7) costs the
  time (kernel :mod:`..kernels.prep_variants`);
- :mod:`.exp_dot`: the band product on the tensor cores (TF32 x 3, bf16)
  and on the CUDA cores, in exp_dot's formulations;
  :mod:`.exp_parity`: split accumulators for the dense-band grid (both on
  kernel :mod:`..kernels.bucket_dot`);
- :mod:`.exp_overlap`: whether tap builds on the CUDA cores overlap
  tensor-core products (kernel :mod:`..kernels.overlap`).

Each has ``operands(device, check)`` (the experiment's inputs from its
seed, at its own scale or, with ``check``, a small one), ``launch(ops)``
(one kernel launch a variant), ``measure(ops, outs)`` (each variant held
against its plain version and, on a CUDA card, timed by CUDA events) and
``run(device="cuda", check=False) -> dict``; ``python -m
ska_sdp_func_torch.experiments.<name> [--check] [--device cpu]`` prints
one JSON line a variant. On the CPU the kernels' plain versions run and
no time is reported. No entry point of the package runs these kernels.
"""

import importlib

# The drivers, in chip_smoke.py's window-p order. They are imported on
# demand, so that ``python -m`` runs a driver the package has not
# imported yet.
NAMES = ("rooflines", "exp_place_dma", "exp_prep", "exp_dot", "exp_parity",
         "exp_overlap")


def drivers() -> tuple:
    """The driver modules, in the order of :data:`NAMES`."""
    return tuple(importlib.import_module(f"{__name__}.{name}")
                 for name in NAMES)


__all__ = ["NAMES", "drivers"]
