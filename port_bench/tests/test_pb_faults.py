"""The checks that decide ``correct``, with the timed path broken
underneath: each fault a cell can have makes ``correct`` false, a sound
run makes it true, and so does the control (the port's bf16 mode,
``fast=True``) make it false. The runs skip the look for a card and run
on the CPU at a tiny size."""

import time

import pytest
import torch

from _tiny import tiny_spec
from port_bench import harness
from ska_sdp_func_torch.parallel import packed, streaming

CPU = torch.device("cpu")


def _run(workload, fast=False, seed=20240611):
    spec = tiny_spec(workload)
    result, checks, _ = harness.run_cell(
        spec, seed, 0.3, False, CPU, time.perf_counter(), lambda m: None,
        fast=fast)
    return result, checks


def _wrap(monkeypatch, cls, name, after):
    """Patch ``cls.name`` so its result passes through ``after(self, out,
    *args)``."""
    orig = getattr(cls, name)

    def patched(self, *args, **kw):
        return after(self, orig(self, *args, **kw), *args)
    monkeypatch.setattr(cls, name, patched)


def _half(x):
    """Half of a batch left out, the mean taken over the rest."""
    y = x.clone()
    y[y.shape[0] // 2:] = 0
    return 2 * y


@pytest.mark.parametrize("workload", ["packed_cycle", "stream_ingest",
                                      "stream_predict"])
def test_sound_run_is_correct(workload):
    result, checks = _run(workload)
    assert result["correct"], checks
    assert result["failed"] == 0


@pytest.mark.parametrize("workload", ["packed_cycle", "stream_ingest",
                                      "stream_predict"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails(workload, seed):
    result, checks = _run(workload, fast=True, seed=seed)
    assert not result["correct"], checks


def _packed_unchanged(monkeypatch):
    _wrap(monkeypatch, packed.PackedGridder, "grid_sorted",
          lambda self, out, *a: torch.zeros_like(out))


def _packed_half(monkeypatch):
    orig = packed.PackedGridder.grid_sorted
    monkeypatch.setattr(packed.PackedGridder, "grid_sorted",
                        lambda self, vre, vim: orig(self, _half(vre),
                                                    _half(vim)))


def _packed_altered(monkeypatch):
    def alter(self, out, *a):
        out = out.clone()
        out[self.slots.valid.nonzero()[3, 0]] += 1.0
        return out
    _wrap(monkeypatch, packed.PackedGridder, "degrid_sorted", alter)


def _ingest_unchanged(monkeypatch):
    monkeypatch.setattr(streaming.StreamingGridder, "accumulate",
                        lambda self, uvw, vis, weights=None: None)


def _ingest_half(monkeypatch):
    orig = streaming.StreamingGridder.accumulate
    monkeypatch.setattr(
        streaming.StreamingGridder, "accumulate",
        lambda self, uvw, vis, weights=None: orig(self, uvw, _half(vis)))


def _ingest_altered(monkeypatch):
    _wrap(monkeypatch, streaming.StreamingGridder, "finalize",
          lambda self, out, *a: out * 1.01)


def _predict_unchanged(monkeypatch):
    first = {}

    def stale(self, out, *a):
        return first.setdefault(id(self), out)
    _wrap(monkeypatch, streaming.StreamingDegridder, "predict", stale)


def _predict_half(monkeypatch):
    _wrap(monkeypatch, streaming.StreamingDegridder, "predict",
          lambda self, out, *a: _half(out))


def _predict_altered(monkeypatch):
    _wrap(monkeypatch, streaming.StreamingDegridder, "predict",
          lambda self, out, *a: out * 1.01)


FAULTS = {
    "packed_cycle": [_packed_unchanged, _packed_half, _packed_altered],
    "stream_ingest": [_ingest_unchanged, _ingest_half, _ingest_altered],
    "stream_predict": [_predict_unchanged, _predict_half,
                       _predict_altered],
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, faults in FAULTS.items() for f in faults],
    ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_fault_fails(monkeypatch, workload, fault):
    fault(monkeypatch)
    result, checks = _run(workload)
    assert not result["correct"], checks
    assert result["failed"] >= 1
