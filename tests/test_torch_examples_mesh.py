"""The port's ``imaging_demo`` (``ska_sdp_func_torch.examples``) on one
gloo rank on the CPU, held to the oracle it prints: each source's
recovered flux within ``FLUX_TOL`` (5 %) of the sky's. Cut in size to
keep the file within seconds (the task drivers' plain versions grid
every row through every task on the CPU): 200 rows (the script: 600), 3
major cycles (5). The demo starts its one-rank group and destroys it
when it is done; the test destroys it too should the demo fail, so that
later files on the same worker find none.
"""

import pytest
import torch
import torch.distributed as dist

from ska_sdp_func_torch.examples import imaging_demo
from ska_sdp_func_torch.pipeline import load_result


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the demos make many small tensor operations,
    which several threads a worker slow down under the suite's parallel
    workers (the full pipeline demo, on an 8-core CPU host: 220 s under
    six workers against 4 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_imaging_demo_one_gloo_rank(tmp_path):
    path = str(tmp_path / "result.npz")
    try:
        r = imaging_demo.run(device="cpu", num_rows=200, n_major=3,
                             result_path=path)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for check in r["oracle"]["checks"]:
        assert check["ok"], check
    assert (r["devices"], r["rank"]) == (1, 0)
    assert not dist.is_initialized()
    for (_, _, flux), got in zip(r["sources"], r["fluxes"]):
        assert abs(got - flux) <= imaging_demo.FLUX_TOL * flux
    saved = load_result(path, device="cpu")
    assert saved.peak_history == pytest.approx(r["peak_history"])
    assert saved.model.shape == (128, 128)
