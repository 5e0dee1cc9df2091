"""The port's stage-timing reports, ``PackedGridder.report_timing`` and
``report_timing_degrid``, on the CPU.

The stage names and their order are JAX's (read from the JAX methods'
source: calling them compiles four interpreted prefixes, about 10 s on
this scenario). JAX's seconds are no oracle: its stages are differences
of separately timed prefixes, clamped at 0, and need not add up to the
pass. Here each stage is >= 0, the stages add up to the report's root
(within 1e-9 s: the host clock's seconds, summed), and the composed
stages give ``grid_sorted``'s image and ``degrid_sorted``'s prediction
bit for bit, in every engine and precision mode.
"""

import ast
import inspect
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    make_inputs, two_point_image  # noqa: E402
from ska_sdp_func_torch.parallel import packed as tpacked  # noqa: E402
from ska_sdp_func_torch.parallel import plan_packed, plan_wstack  # noqa
from ska_sdp_func_torch.utility.errors import \
    SdpInvalidArgumentError  # noqa: E402
from ska_sdp_func_tpu.parallel.packed import PackedGridder as \
    JPackedGridder  # noqa: E402

MODES = {"high": dict(), "highest": dict(precision="highest"),
         "fast": dict(fast=True), "fused": dict(engine="fused"),
         "compact": dict(engine="compact")}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the stages' plain versions make many small
    tensor operations, which several threads a worker slow down under the
    suite's parallel workers (this file, on an 8-core CPU host: 122 s
    under six workers against 11 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_names(method) -> tuple:
    """The ``names`` tuple in the source of a JAX report method."""
    src = inspect.getsource(method)
    found = re.search(r"names = (\(.*?\))\n", src, re.S).group(1)
    return ast.literal_eval(found)


@pytest.fixture(scope="module")
def scenario():
    uvw, vis = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    return dict(pplan=plan_packed(plan, uvw, block_v=128), vis=vis)


@pytest.fixture(scope="module", params=list(MODES))
def gridder(request, scenario):
    return tpacked.packed_gridder(scenario["pplan"], device="cpu",
                                  **MODES[request.param])


class _Recorded(tpacked.Timers):
    """Keeps every report's Timers tree."""

    made = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.made.append(self)


def test_stage_names_are_jax():
    assert tpacked.GRID_STAGES == _jax_names(JPackedGridder.report_timing)
    assert tpacked.DEGRID_STAGES == _jax_names(
        JPackedGridder.report_timing_degrid)


@pytest.mark.parametrize("which", ["grid", "degrid"])
def test_report(gridder, scenario, which, monkeypatch):
    """JAX's stage names in JAX's order, each >= 0, adding up to the
    root of the Timers tree; the header line and the tree printed."""
    monkeypatch.setattr(tpacked, "Timers", _Recorded)
    _Recorded.made.clear()
    printed = []
    if which == "grid":
        vre, vim = gridder.sort(scenario["vis"])
        out = gridder.report_timing(vre, vim, iters=2,
                                    print_fn=printed.append)
        names, title = tpacked.GRID_STAGES, "grid_all"
    else:
        out = gridder.report_timing_degrid(two_point_image(), iters=2,
                                           print_fn=printed.append)
        names, title = tpacked.DEGRID_STAGES, "degrid_all"
    assert tuple(out) == names
    assert all(isinstance(v, float) and v >= 0 for v in out.values())
    (timers,) = _Recorded.made
    root = timers._root
    assert tuple(root.children) == names
    for name in names:
        assert root.children[name].timer.elapsed() == out[name]
    assert abs(root.timer.elapsed() - sum(out.values())) <= 1e-9
    pplan = scenario["pplan"]
    assert printed[0] == (
        f"# image {IMAGE_SIZE}^2, subgrid {PARAMS['subgrid_size']}, "
        f"{len(pplan.tasks)} tasks, {len(pplan.w_plane_ids)} w-planes, "
        f"{pplan.num_layers} tower layers, {pplan.total} stream slots "
        f"({pplan.num_blocks} blocks), w_step {PARAMS['w_step']}, tower "
        f"height {PARAMS['w_tower_height']}")
    assert printed[1].startswith(f"{title} (packed) host time / call (")
    assert all(f"+- {name}: " in printed[1] for name in names)


def test_composed_stages_are_grid_sorted(gridder, scenario):
    """The composed grid stages give grid_sorted's image bit for bit, and
    the stages add up to each pass."""
    vre, vim = gridder.sort(scenario["vis"])
    stage_s, pass_s, image = tpacked._stage_times(
        gridder._grid_stages(), (vre, vim), 2, gridder.device)
    assert torch.equal(image, gridder.grid_sorted(vre, vim))
    assert stage_s.shape == (2, len(tpacked.GRID_STAGES))
    assert np.all(stage_s >= 0)
    np.testing.assert_allclose(stage_s.sum(1), pass_s, rtol=0, atol=1e-9)


def test_composed_stages_are_degrid_sorted(gridder):
    model = two_point_image()
    stage_s, pass_s, vis = tpacked._stage_times(
        gridder._degrid_stages(), torch.as_tensor(model), 1, gridder.device)
    assert torch.equal(vis, gridder.degrid_sorted(model))
    assert stage_s.shape == (1, len(tpacked.DEGRID_STAGES))
    np.testing.assert_allclose(stage_s.sum(1), pass_s, rtol=0, atol=1e-9)


def test_report_needs_a_pass(scenario):
    g = tpacked.packed_gridder(scenario["pplan"], device="cpu")
    with pytest.raises(SdpInvalidArgumentError):
        g.report_timing(*g.sort(scenario["vis"]), iters=0)
