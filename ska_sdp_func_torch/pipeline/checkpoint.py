"""Checkpoint/resume for the major-cycle solver state.

Counterpart of ska_sdp_func_tpu.pipeline.checkpoint. The solver's state
(model image, residual, cycle index, peak history, free-form metadata) is
persisted after each major cycle and read back on a restart. Two forms:

- :func:`save_state` / :func:`load_state`: one ``.npz`` file, written
  under a temporary name and renamed into place (atomic on one host).
  The keys (``model``, ``residual``, ``cycle``, ``peak_history``,
  ``meta`` as JSON) are the JAX package's, so a file written by either
  package loads in the other. :func:`save_result` / :func:`load_result`
  do the same for a finished :class:`~.major_cycle.ImagingResult`.
- :class:`SolverCheckpointer`: a directory of one such ``.npz`` per step
  with ``max_to_keep`` retention. The JAX package wraps orbax here
  (JAX-only); this is the equivalent with the same methods. The solver's
  model and residual are replicated images, so in a process group (a
  mesh-sharded solve) rank 0 alone writes and prunes, every rank waits
  for the write, and every rank restores onto its own device.

Tensors come back on the caller's ``device`` (``None``: the CUDA card).
"""

import json
import os
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utility.tensors import resolve_device
from .major_cycle import ImagingResult


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _savez_atomic(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    np.savez(tmp, **arrays)
    # np.savez appends ".npz" to a name without it.
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def save_state(path: str, model, residual, cycle: int,
               peak_history=None, meta: Optional[dict] = None) -> None:
    """Persist solver state; atomic single-host write."""
    _savez_atomic(path, model=_host(model), residual=_host(residual),
                  cycle=np.asarray(cycle, np.int64),
                  peak_history=np.asarray(peak_history or [], np.float64),
                  meta=json.dumps(meta or {}))


def load_state(path: str, device=None):
    """Restore solver state -> (model, residual, cycle, peak_history,
    meta), the images as tensors on ``device``."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        model = torch.as_tensor(data["model"], device=dev)
        residual = torch.as_tensor(data["residual"], device=dev)
        cycle = int(data["cycle"])
        peak_history = [float(p) for p in data["peak_history"]]
        meta = json.loads(str(data["meta"]))
    return model, residual, cycle, peak_history, meta


def save_result(path: str, result: ImagingResult,
                meta: Optional[dict] = None) -> None:
    """Persist a finished ImagingResult (model/residual/restored)."""
    _savez_atomic(path, model=_host(result.model),
                  residual=_host(result.residual),
                  restored=_host(result.restored),
                  peak_history=np.asarray(result.peak_history, np.float64),
                  meta=json.dumps(meta or {}))


def load_result(path: str, device=None) -> ImagingResult:
    """A saved ImagingResult, its images as tensors on ``device``."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        return ImagingResult(
            model=torch.as_tensor(data["model"], device=dev),
            residual=torch.as_tensor(data["residual"], device=dev),
            restored=torch.as_tensor(data["restored"], device=dev),
            peak_history=[float(p) for p in data["peak_history"]])


class SolverCheckpointer:
    """Step checkpointing for the major-cycle solver: a directory of one
    ``step_<n>.npz`` per saved step (the :func:`save_state` format),
    keeping the newest ``max_to_keep``.

    Accepted by ``major_cycle_imager(checkpointer=...)`` in place of
    ``checkpoint_path``. Writes are synchronous, so :meth:`wait` and
    :meth:`close` have nothing to flush. :meth:`restore` puts the images
    on the device and in the dtype of ``template``'s tensors, else on
    ``device`` (``None``: the CUDA card).

    With a ``torch.distributed`` process group started, every rank calls
    :meth:`save` with the same (replicated) state: rank 0 writes the step
    and prunes the old ones, and :meth:`save` ends in a barrier, so no
    rank reads a step before it is whole. The directory must be one that
    every rank sees.
    """

    _NAME = re.compile(r"^step_(\d+)\.npz$")

    def __init__(self, directory: str, max_to_keep: int = 3, device=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.device = device
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.npz")

    def steps(self):
        """Saved steps, oldest first."""
        found = (self._NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model, residual, peak_history=None,
             meta: Optional[dict] = None) -> None:
        group = dist.is_available() and dist.is_initialized()
        if not group or dist.get_rank() == 0:
            save_state(self._path(step), model, residual, int(step),
                       peak_history, meta)
            steps = self.steps()
            for old in steps[:max(len(steps) - self.max_to_keep, 0)]:
                os.remove(self._path(old))
        if group:
            dist.barrier()

    def restore(self, step: Optional[int] = None, template=None):
        """Restore ``(model, residual, cycle, peak_history, meta)`` of
        ``step`` (default: the latest). ``template``: optional
        ``{"model": ..., "residual": ...}`` tensors whose device and dtype
        the images take."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint steps in {self.directory}")
        if template is None:
            return load_state(self._path(step), device=self.device)
        model, residual, cycle, history, meta = load_state(
            self._path(step), device=template["model"].device)
        return (model.to(template["model"].dtype),
                residual.to(device=template["residual"].device,
                            dtype=template["residual"].dtype),
                cycle, history, meta)

    def wait(self) -> None:
        """Writes are synchronous: nothing is pending."""

    def close(self) -> None:
        """Nothing to release."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
