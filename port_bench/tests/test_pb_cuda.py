"""The checks on the card at a tiny size: a sound run is correct and the
control (``fast=True``, the port's bf16 mode) is not, on three seeds.
Run on the card with ``python -m pytest port_bench/tests -m cuda``."""

import time

import pytest

from _tiny import tiny_spec
from port_bench import harness

CELLS = ["packed_cycle", "stream_ingest", "stream_predict"]


def _run(card, workload, seed, fast):
    spec = tiny_spec(workload)
    return harness.run_cell(spec, seed, 0.5, False, card,
                            time.perf_counter(), lambda m: None, fast=fast)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_on_the_card(card, workload):
    result, checks, dev = _run(card, workload, 5, False)
    assert result["correct"], checks
    assert dev["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_on_the_card(card, workload, seed):
    result, checks, _ = _run(card, workload, seed, True)
    assert not result["correct"], checks
