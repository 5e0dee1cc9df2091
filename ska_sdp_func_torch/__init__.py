"""ska_sdp_func_torch — the PyTorch / CUDA port of ska_sdp_func_tpu.

A second package beside the JAX one, written for one NVIDIA H100
(Hopper, sm_90a). Module paths mirror :mod:`ska_sdp_func_tpu` so each
counterpart is easy to find; the JAX package stays the reference the
port is tested against. Plain tensor code is PyTorch, host planning is
NumPy (plus the shared C++ host runtime, :mod:`.native`), and every
Pallas kernel on the ported path is a hand-written CUDA kernel
(:mod:`.kernels`).

Ported so far (on one device: the packed whole-image path, the per-task
and bucketed w-towers paths, streaming, ES-FFT, the solvers, and the
ingest in front of them):

- :mod:`.parallel` — ``plan_wstack``, ``plan_packed``, ``packed_gridder``
  and :class:`~.parallel.packed.PackedGridder`; the task drivers
  ``grid_all_tasks`` / ``degrid_all_tasks``; the bucketed drivers
  ``plan_bucketed``, ``grid_all_bucketed``, ``degrid_all_bucketed``
- :mod:`.grid_data` — the sub-grid gridder ``GridderWtowerUVW`` and the
  whole-image drivers ``wstack_wtower_{grid,degrid}_all``
- :mod:`.pipeline` — the ingest (``ingest_to_solver``,
  ``ingest_flag_and_weight``, ``station_beam_power``),
  ``major_cycle_imager`` (``bucketed=False`` and ``True``; Hogbom or
  multi-scale minor cycles), ``fista_imager``, ``dirty_and_psf`` and
  solver checkpointing
- :mod:`.visibility` — DFT predict, phase rotation, the FluctuFlagger,
  uniform / Briggs / tiled Briggs weights, uv tiling
- :mod:`.station_beam` — aperture-array and element (dipole, HARP) beams
- :mod:`.clean` — Hogbom and multi-scale (Cornwell) CLEAN
- :mod:`.fourier_transforms` (planned and shifted FFTs, the PSWF),
  :mod:`.numeric_functions`, :mod:`.utility` (with the data-model
  checks and ``SkyCoord``) — the helpers those paths use

The package imports ``torch`` and never ``jax``.
"""

__all__ = [
    "clean",
    "fourier_transforms",
    "grid_data",
    "kernels",
    "native",
    "numeric_functions",
    "parallel",
    "pipeline",
    "station_beam",
    "utility",
    "visibility",
]


def __getattr__(name):
    # Lazy subpackage import keeps `import ska_sdp_func_torch` light.
    if name in __all__:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
