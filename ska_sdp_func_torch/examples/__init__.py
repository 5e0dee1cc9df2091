"""The Quick-start demos of the README, on the port.

Each module is the counterpart of the script of the same name in the
repository's ``examples/`` and runs as

    python -m ska_sdp_func_torch.examples.packed_imaging_demo
    python -m ska_sdp_func_torch.examples.streaming_ingest_demo
    python -m ska_sdp_func_torch.examples.full_pipeline_demo
    python -m ska_sdp_func_torch.examples.subgrid_gridding
    python -m ska_sdp_func_torch.examples.imaging_demo

Each has ``run(device=None, **sizes) -> dict``, which returns the
quantities the script prints and the checks of its result against its
oracle (``"oracle"``: ``checks``, each what is compared, its value and
limit and ``ok``, and ``ok`` for all of them), and ``main(device=None,
**sizes)``, which prints them as the script does and returns non-zero
when a check fails (the exit code of ``python -m``). The defaults are the
script's sizes and seeds. ``device=None`` is the CUDA card; on a host
without one ``run`` raises before it plans anything. CPU runs pass
``device="cpu"``.
"""

import numpy as np
import torch

from ..utility.tensors import resolve_device

DEMOS = ("packed_imaging_demo", "streaming_ingest_demo",
         "full_pipeline_demo", "subgrid_gridding", "imaging_demo")


def _device(device) -> torch.device:
    """``device`` resolved as the entry points resolve it; a host with no
    card raises here, before any planning."""
    dev = resolve_device(device)
    torch.empty(0, device=dev)
    return dev


def _oracle(*checks) -> dict:
    """Checks ``(what, value, limit)``, each met where ``value <=
    limit``."""
    out = [dict(what=what, value=float(value), limit=float(limit),
                ok=bool(np.isfinite(value) and value <= limit))
           for what, value, limit in checks]
    return dict(checks=out, ok=all(c["ok"] for c in out))


def _flux_errors(got, want) -> float:
    """The largest error of the recovered fluxes, relative to each
    source's flux."""
    return float(max(abs(g - w) / w for g, w in zip(got, want)))


def _finish(result: dict) -> int:
    """``main``'s last lines: the oracle's checks; the exit code."""
    for c in result["oracle"]["checks"]:
        print(f"oracle: {c['what']} {c['value']:.3e} (limit "
              f"{c['limit']:g}): {'ok' if c['ok'] else 'FAILED'}")
    return 0 if result["oracle"]["ok"] else 1
