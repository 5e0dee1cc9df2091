"""The batched all-layer kernels (K16/K17 over every task of a call) and
the batched tower drain of the bucketed fallback, on the CPU.

The plain versions of ``tower_tap.grid_all_layers_tasks`` /
``degrid_all_layers_tasks`` (what the wrappers run on CPU tensors) are
held against a per-task loop of the one-task plain versions and against
JAX's ``grid_all_layers_pallas`` / ``degrid_all_layers_pallas`` run per
task in interpret mode, on ragged task streams
(``_torch_scenario.task_stream``: layer counts 6-10, a single-block task,
an all-padding task, an empty task, slots no task holds) at N = 32 and
64, at 1e-5 of max|output| (f32: only the order of the sums differs).
The bucketed driver's plan-constant sub-grid indices reproduce
``subgrid_add_static`` / ``subgrid_cut_out_static`` exactly, wrap-around
included, and its batched drain meets the per-task drain it replaced.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import PADDING_TASK, TASK_SPECS, task_stream  # noqa
from ska_sdp_func_torch.fourier_transforms.fft import (  # noqa: E402
    fft_shifted,
    ifft_shifted,
    ifft_shifted_norm,
)
from ska_sdp_func_torch.grid_data.gridder_utils import (  # noqa: E402
    subgrid_add_static,
    subgrid_cut_out_static,
)
from ska_sdp_func_torch.kernels import tower_tap as tt  # noqa: E402
from ska_sdp_func_torch.parallel import bucketed as tb  # noqa: E402
from ska_sdp_func_torch.parallel import wstack as tpw  # noqa: E402
from ska_sdp_func_torch.utility.constants import C_0  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
    SdpShapeError,
)
from ska_sdp_func_tpu.kernels import pallas_tap as jp  # noqa: E402

SUPPORT = 8
TOL = 1e-5


def _stream(size, seed, support=SUPPORT):
    *arrays, rows = task_stream(size, seed, support)
    return [torch.as_tensor(a) for a in arrays], tt.task_table(rows)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("size", [32, 64])
def test_grid_tasks_plain_matches_per_task_loop_and_pallas(size):
    (vre, vim, iu0, iv0, uk, vk, w), tasks = _stream(size, seed=size)
    got = tt.grid_all_layers_tasks(vre, vim, iu0, iv0, uk, vk, w, tasks,
                                   size, SUPPORT).numpy()
    assert got.shape == (tasks.planes, size, size)
    assert got.dtype == np.complex64
    loop = np.zeros_like(got)
    jax_out = np.zeros_like(got)
    for start, count, k, base in tasks.rows:
        sl = slice(start, start + count)
        args = [a[sl] for a in (vre, vim, iu0, iv0, uk, vk)] + [w[sl, :k]]
        loop[base:base + k] = tt.grid_all_layers_reference(
            *args, k, size, SUPPORT).numpy()
        if count:
            jax_out[base:base + k] = np.asarray(jp.grid_all_layers_pallas(
                *(jnp.asarray(a.numpy()) for a in args), k, size, SUPPORT,
                block_v=128, interpret=True))
    assert _rel(got, loop) <= TOL
    assert _rel(got, jax_out) <= TOL
    # The empty and the all-padding tasks grid nothing.
    for t in (PADDING_TASK, TASK_SPECS.index((0, 7))):
        _, _, k, base = tasks.rows[t]
        assert not got[base:base + k].any()


@pytest.mark.parametrize("size", [32, 64])
def test_degrid_tasks_plain_matches_per_task_loop_and_pallas(size):
    (_, _, iu0, iv0, uk, vk, w), tasks = _stream(size, seed=size + 1)
    rng = np.random.default_rng(size)
    layers = torch.as_tensor(
        (rng.standard_normal((tasks.planes, size, size))
         + 1j * rng.standard_normal((tasks.planes, size, size))).astype(
             np.complex64))
    got = tt.degrid_all_layers_tasks(layers, iu0, iv0, uk, vk, w, tasks,
                                     SUPPORT).numpy()
    assert got.shape == (iu0.shape[0],) and got.dtype == np.complex64
    loop = np.zeros_like(got)
    jax_out = np.zeros_like(got)
    for start, count, k, base in tasks.rows:
        sl = slice(start, start + count)
        args = [layers[base:base + k]] + [
            a[sl] for a in (iu0, iv0, uk, vk)] + [w[sl, :k]]
        loop[sl] = tt.degrid_all_layers_reference(*args, SUPPORT).numpy()
        if count:
            jax_out[sl] = np.asarray(jp.degrid_all_layers_pallas(
                *(jnp.asarray(a.numpy()) for a in args), SUPPORT,
                block_v=128, interpret=True))
    assert _rel(got, loop) <= TOL
    assert _rel(got, jax_out) <= TOL
    # Slots that no task holds, and the all-padding task's, read zero.
    held = np.zeros(got.shape, bool)
    for start, count, _, _ in tasks.rows:
        held[start:start + count] = True
    start, count, _, _ = tasks.rows[PADDING_TASK]
    assert not got[~held].any() and not got[start:start + count].any()


# The card kernels' wider bodies: 12 (16 taps a row) and 20 (past 16).
@pytest.mark.parametrize("support", [12, 20])
def test_tasks_plain_wide_support_matches_pallas(support):
    """At the supports past 8, the batched plain K16/K17 (what the card
    kernels are held to) meet JAX's kernels run per task."""
    size = 32
    (vre, vim, iu0, iv0, uk, vk, w), tasks = _stream(size, support + 3,
                                                     support)
    layers = torch.as_tensor(np.random.default_rng(support).standard_normal(
        (tasks.planes, size, size)).astype(np.complex64))
    got_g = tt.grid_all_layers_tasks(vre, vim, iu0, iv0, uk, vk, w, tasks,
                                     size, support).numpy()
    got_d = tt.degrid_all_layers_tasks(layers, iu0, iv0, uk, vk, w, tasks,
                                       support).numpy()
    jax_g = np.zeros_like(got_g)
    jax_d = np.zeros_like(got_d)
    for start, count, k, base in tasks.rows:
        if not count:
            continue
        sl = slice(start, start + count)
        taps = [jnp.asarray(a[sl].numpy()) for a in (iu0, iv0, uk, vk)] + [
            jnp.asarray(w[sl, :k].numpy())]
        jax_g[base:base + k] = np.asarray(jp.grid_all_layers_pallas(
            jnp.asarray(vre[sl].numpy()), jnp.asarray(vim[sl].numpy()),
            *taps, k, size, support, block_v=128, interpret=True))
        jax_d[sl] = np.asarray(jp.degrid_all_layers_pallas(
            jnp.asarray(layers[base:base + k].numpy()), *taps, support,
            block_v=128, interpret=True))
    assert _rel(got_g, jax_g) <= TOL
    assert _rel(got_d, jax_d) <= TOL


@pytest.mark.parametrize("op", ["grid", "degrid"])
def test_tasks_bf16_plain_matches_per_task_loop(op):
    """The bf16 mode of the batched plain versions is the one-task bf16
    mode per task."""
    size = 32
    (vre, vim, iu0, iv0, uk, vk, w), tasks = _stream(size, seed=7)
    layers = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (tasks.planes, size, size)).astype(np.complex64))
    if op == "grid":
        got = tt.grid_all_layers_tasks(vre, vim, iu0, iv0, uk, vk, w, tasks,
                                       size, SUPPORT, fast=True)
    else:
        got = tt.degrid_all_layers_tasks(layers, iu0, iv0, uk, vk, w, tasks,
                                         SUPPORT, fast=True)
    for start, count, k, base in tasks.rows:
        sl = slice(start, start + count)
        if op == "grid":
            want = tt.grid_all_layers_reference(
                vre[sl], vim[sl], iu0[sl], iv0[sl], uk[sl], vk[sl],
                w[sl, :k], k, size, SUPPORT, fast=True)
            assert torch.equal(got[base:base + k], want)
        else:
            want = tt.degrid_all_layers_reference(
                layers[base:base + k], iu0[sl], iv0[sl], uk[sl], vk[sl],
                w[sl, :k], SUPPORT, fast=True)
            assert torch.equal(got[sl], want)


def test_task_table_orders_and_checks():
    rows = ((0, 100, 6, 10), (100, 300, 10, 0), (400, 0, 4, 16))
    tasks = tt.task_table(rows)
    assert tasks.rows == rows and tasks.planes == 20
    assert tasks.table.dtype == torch.int32
    assert tasks.table.tolist() == [list(r) for r in rows]
    # Grid CTAs: the largest task's planes first, each task's in order.
    assert tasks.layer_map.tolist() == (
        [[1, k] for k in range(10)] + [[0, k] for k in range(6)]
        + [[2, k] for k in range(4)])
    for bad in (((0, 100, 6, 0), (50, 10, 4, 6)),      # slots overlap
                ((0, 100, 6, 0), (100, 10, 4, 7)),     # planes leave a gap
                ((0, 100, 6, 0), (100, 10, 4, 3)),     # planes overlap
                ((0, 100, 0, 0),),                     # no layers
                ((0, -1, 4, 0),), ()):
        with pytest.raises(SdpInvalidArgumentError):
            tt.task_table(bad)
    (vre, vim, iu0, iv0, uk, vk, w), _ = _stream(32, seed=0)
    short = tt.task_table(((0, iu0.shape[0] + 1, 6, 0),))
    wide = tt.task_table(((0, 10, w.shape[1] + 1, 0),))
    for table in (short, wide):
        with pytest.raises(SdpShapeError):
            tt.grid_all_layers_tasks(vre, vim, iu0, iv0, uk, vk, w, table,
                                     32, SUPPORT)
        with pytest.raises(SdpShapeError):
            tt.degrid_all_layers_tasks(
                torch.zeros((table.planes, 32, 32), dtype=torch.complex64),
                iu0, iv0, uk, vk, w, table, SUPPORT)
    with pytest.raises(SdpShapeError):
        tt.degrid_all_layers_tasks(
            torch.zeros((5, 32, 32), dtype=torch.complex64), iu0, iv0, uk,
            vk, w, tt.task_table(((0, 10, 6, 0),)), SUPPORT)


def _tower_plan(image=64, subgrid=32):
    uvw = np.zeros((1, 3))
    return tpw.plan_wstack(uvw, C_0, C_0 / 100, 1, image, subgrid, 0.002,
                           50.0, support=SUPPORT, w_support=4,
                           w_tower_height=4.0)


def test_subgrid_index_matches_static_add_and_cut_out():
    """The plan-constant indices are the cells subgrid_add_static adds
    into and subgrid_cut_out_static cuts out, on the task's w-plane,
    including boxes that wrap around either edge of the grid."""
    plan = _tower_plan()
    g, n, eff = plan.image_size, plan.subgrid_size, plan.eff_sg_size
    assert g // 2 - n // 2 + eff + n > g      # iu = 1 wraps past the end
    tasks = [tb.BucketedTask(iu, iv, iw, 0, 6, 0, 128)
             for iu, iv, iw in ((0, 0, -1), (1, -1, 0), (-2, 2, 1),
                                (2, 1, -1), (-1, -2, 0))]
    plane_ids = (-1, 0, 1)
    index = tb._subgrid_index(plan, tasks, plane_ids)
    assert index.shape == (len(tasks), n, n)
    rng = np.random.default_rng(0)
    grids = torch.as_tensor((rng.standard_normal((3, g, g))
                             + 1j * rng.standard_normal((3, g, g))).astype(
                                 np.complex64))
    for t, idx in zip(tasks, index):
        p = plane_ids.index(t.iw)
        cut = grids.reshape(-1)[torch.as_tensor(idx.reshape(-1))]
        assert torch.equal(cut.reshape(n, n), subgrid_cut_out_static(
            grids[p], t.iu * eff, t.iv * eff, n))
        sub = grids[0, :n, :n] * (1 + 2j)
        want = torch.zeros_like(grids)
        subgrid_add_static(want[p], -t.iu * eff, -t.iv * eff, sub, 3.0)
        got = torch.zeros_like(grids)
        torch.view_as_real(got).reshape(-1, 2).index_add_(
            0, torch.as_tensor(idx.reshape(-1)),
            torch.view_as_real(sub).reshape(-1, 2), alpha=3.0)
        assert torch.equal(got, want)
        # Each cell once: no two cells of a sub-grid share an index.
        assert np.unique(idx).size == n * n


@pytest.fixture(scope="module")
def bucketed_scene():
    """A small fallback scenario (32^2 sub-grids on a 64^2 image, 60 rows
    x 2 channels, test_torch_wstack_drivers.py's geometry) whose tasks
    have several layer counts."""
    rng = np.random.default_rng(5)
    uvw = rng.uniform(-1, 1, (60, 3))
    uvw[:, :2] *= 0.3 * 64 / 2 / 0.002
    uvw[:, 2] *= 50.0 * 4.0
    vis = (rng.standard_normal((60, 2))
           + 1j * rng.standard_normal((60, 2))).astype(np.complex64)
    plan = tpw.plan_wstack(uvw, C_0, C_0 / 100, 2, 64, 32, 0.002, 50.0,
                           support=SUPPORT, w_support=4, w_tower_height=4.0)
    bplan, sort_index, valid = tb.plan_bucketed(plan, uvw, block_v=128)
    return plan, bplan, sort_index, valid, torch.as_tensor(uvw), vis


def test_bucketed_constants_group_tasks(bucketed_scene):
    _, bplan, *_ = bucketed_scene
    consts = tb._device_constants(bplan, torch.device("cpu"))
    tasks = consts["tasks"]
    layer_counts = [t.num_layers for t in bplan.tasks]
    assert len(set(layer_counts)) > 1          # the scene is ragged
    assert tasks.planes == sum(layer_counts)
    assert [r[:3] for r in tasks.rows] == [
        (t.start, t.size, t.num_layers) for t in bplan.tasks]
    seen, plane = [], 0
    for num_k, first, last, p0, g_ladder, d_ladder in consts["groups"]:
        members = [i for i, t in enumerate(bplan.tasks)
                   if t.num_layers == num_k]
        assert last - first == len(members) and p0 == plane
        assert [tasks.rows[i][3] for i in members] == list(
            range(p0, p0 + num_k * len(members), num_k))
        for ladder in (g_ladder, d_ladder):
            assert tuple(ladder.shape) == (len(members), num_k, 32, 32)
        seen += members
        plane += num_k * len(members)
    assert sorted(seen) == list(range(len(bplan.tasks)))
    assert consts["index"].numel() == len(bplan.tasks) * 32 * 32


def test_batched_drain_matches_per_task_drain(bucketed_scene):
    """grid_all_bucketed / degrid_all_bucketed against the per-task loop
    they replaced (one all-layer call, one drain and one sub-grid add or
    cut-out per task), both in f32 on the CPU."""
    plan, bplan, sort_index, valid, uvw, vis = bucketed_scene
    kernel = plan.kernel()
    n, g = plan.subgrid_size, plan.image_size
    eff = plan.eff_sg_size
    dev = torch.device("cpu")
    uvw_s, chan, sidx, vld = tb._sorted_inputs(bplan, uvw, sort_index,
                                               valid)
    consts = tb._device_constants(bplan, dev)
    taps = tb._stream_taps(bplan, consts["terms"], uvw_s, chan, vld,
                           plan.freq0_hz, plan.dfreq_hz)
    vis_s = torch.as_tensor(vis).reshape(-1)[sidx]
    vre = torch.where(vld, vis_s.real, 0.0).to(torch.float32)
    vim = torch.where(vld, vis_s.imag, 0.0).to(torch.float32)
    pattern = kernel.w_pattern
    sw = plan.w_support

    def task_slices(t):
        sl = slice(t.start, t.start + t.size)
        iu0, iv0, uk, vk, w = taps
        return iu0[sl], iv0[sl], uk[sl], vk[sl], w[sl, :t.num_layers]

    def ladder(t, shift, sign):
        exps = (t.first_w_plane + shift + np.arange(t.num_layers)).astype(
            np.float32)
        return torch.as_tensor((pattern[None] ** (
            sign * exps[:, None, None])).astype(np.complex64))

    grids = {iw: torch.zeros((g, g), dtype=torch.complex64)
             for iw in bplan.w_plane_ids}
    for t in bplan.tasks:
        sl = slice(t.start, t.start + t.size)
        acc = tt.grid_all_layers_reference(vre[sl], vim[sl], *task_slices(t),
                                           t.num_layers, n, SUPPORT)
        sub = fft_shifted((ifft_shifted(acc) * ladder(t, sw // 2 - sw, 1))
                          .sum(dim=0))
        subgrid_add_static(grids[t.iw], -t.iu * eff, -t.iv * eff, sub,
                           (g / n) ** 2)
    image = sum(kernel.grid_correct(ifft_shifted_norm(grid), 0, 0,
                                    int(iw * plan.w_tower_height),
                                    device=dev)
                for iw, grid in grids.items()).real
    got = tb.grid_all_bucketed(bplan, vis, uvw, sort_index, valid,
                               device="cpu")
    taper = 1.0 / kernel.grid_correct(torch.ones((g, g)), 0, 0, 0,
                                      device=dev).real
    assert _rel(got * taper, image * taper) <= TOL

    model = torch.zeros((g, g))
    model[g // 2 + 6, g // 2 - 5] = 1.0
    planes = {iw: fft_shifted(kernel.degrid_correct(
        model.to(torch.complex64), 0, 0, int(iw * plan.w_tower_height),
        device=dev)) for iw in bplan.w_plane_ids}
    out = torch.zeros(bplan.total + 1, dtype=torch.complex64)
    for t in bplan.tasks:
        sub = ifft_shifted_norm(subgrid_cut_out_static(
            planes[t.iw], t.iu * eff, t.iv * eff, n)).to(torch.complex64)
        layers = fft_shifted(sub[None] * ladder(t, -(sw // 2), -1))
        out[t.start:t.start + t.size] = tt.degrid_all_layers_reference(
            layers, *task_slices(t), SUPPORT)
    inv = tb.inverse_index_of(sort_index, valid, vis.size)
    want = out[torch.as_tensor(inv)].reshape(vis.shape)
    got = tb.degrid_all_bucketed(bplan, model, uvw, sort_index, valid, inv,
                                 device="cpu")
    assert _rel(got, want) <= TOL
