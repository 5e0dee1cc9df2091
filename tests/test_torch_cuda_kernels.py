"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where no CUDA device is present (decided inside
the fixture, never at import). Run on a machine with a card, where jax
is absent, with::

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

Tolerances: the grid stack at 1e-5 of max|stack| (f32 atomics reorder
the sums); degridded visibilities at 1e-5 of max|vis| (same products,
other summation order). K1/K2 ("high" and "bf16" on the tensor cores
over bucket runs, "highest" on the CUDA cores) also meet their plain
versions at w_support 1-4, block_v 96-1024 (96 and 200: not a multiple
of the 64-slot stage), lanes 128 and 256, with runs of one block, of
8-12 blocks and with the blocks shuffled, the run
table given and built by the wrapper, one launch a call. The same holds
for the w-towers tap kernels
(``tower_tap``: grid_plane, degrid_plane, grid_all_layers,
degrid_all_layers), the fused and compact kernels (``fused_tap``) and
the ES-FFT band kernels (``band_tap``: K8 and K11 in f32 and bf16, the
word-fed K18 and K19 in all three modes), the streaming tap preparation
(``stream_prep``, f32 and bf16: bit for bit, over ragged tiles, unaligned
scale rows and both kernel instances, ``-k stream_prep``) and the window
fold (``fold``) against their plain versions; the placement kernel (``place``) is a copy and
compares bit for bit. The sparse all-layer grid (``sparse_tap``, K20)
meets its plain version and the dense K16 on the same taps at 1e-5, in
both modes; the bf16 mode of K14-K17 meets its bf16 plain versions at
1e-5 and the f32 kernels within JAX's 4e-3 envelope. The per-plane
kernels (K14/K15) also meet their plain versions on the compaction cases
(``_torch_scenario.plane_case``) at N = 64 (the whole stack in shared
memory) and N = 128 (one layer at a time), in both modes, each call
counted once and made with no host sync. K16/K17 over a whole ragged
stream of tasks (``_torch_scenario.task_stream``) meet their plain
versions at 1e-5 in both modes at N = 32, 64 and 192 (the grid kernel's
global-atomic path) and supports 8, 12, 20, 56 and 72 (each at the sizes
wider than it; past 54 the grid kernel reads its tap rows from memory;
bf16 also against f32
within each output's rounding bound), one launch each and no host sync,
the empty and all-padding tasks' planes and the slots no task holds
exactly zero; the bucketed fallback on the card launches each once a call
and meets the CPU port at 1e-5, at supports 8, 12 and 20. The host planners
and the solver take a uvw tensor on the card, and the msclean and FISTA
solves on the card meet the CPU port at 1e-4 of max|model|. The
experiments' kernels: the read probe (``read_probe``) and the tensor-core
band products (``bucket_dot``, three TF32 passes or bf16, and its CUDA-core
form) and overlap probe (``overlap``, every block's sum |acc| too) at
1e-5 of max|plain|; the tap-preparation sweep (``prep_variants``) bit for
bit. The overlap probe's redesign (one CTA an SM, 64- or 32-slot stages,
wgmma) also over 1, 131, 133 and 529 blocks, blocks of 32, 96, 1024 and
2048 slots and fits of 2, 12 and 16 coefficients, each block's sum too,
vpu's acc bit for bit (``-k overlap``); the window fold's (a CTA an octet,
layer and task) bit for bit at L 1-130, Sw 1-8, one slab, one octet, none,
some and all buckets visited, NaN in the unvisited windows, and with
windows off a 16-byte boundary (``-k fold``). The band products' tensor-core forms (every variant code: one CTA an
SM over the bucket runs, a TMA ring, wgmma) also over runs of 1, 2, 3 and
9 blocks at block_v 128, 256 and 1024 (runs longer than the ring, and runs
of fewer stages than it holds), with unvisited buckets left zero, an odd
block count for npair, slots 1, 2 and 4 (passes with no block among
them), the table passed and built by the wrapper; the read probe at one
to six streams with row blocks that leave a part step (``-k "bucket_dot
or grid_parity or read_probe"``). The window-gather degrid kernels (K4,
K13, K11, K19: one CTA a bucket run, each run's window read into shared
memory once) also meet
their plain versions at 1e-5 of max over S 1-8, Sw 1 to its maximum,
windows of 64-4096 lanes (the ES-FFT's 8 x 256, larger than shared
memory, included), block_v 64-1024, runs of one and of 8-12 blocks,
shuffled blocks, one bucket and empty blocks, one launch a call and no
host sync (``-k window_gather``). The window-scatter grid kernels (K3,
K12, K8, K18: work units of the same run tables, each unit's window in
shared memory, added once by bulk reduce-adds) meet their plain versions
at 1e-5 of max in every mode over S 1-8, Sw 1, 2, 3, 4, 6 and 8, windows
of 64-4096 lanes (8 x 256 in two groups of planes, 3072 and 4096 in
column tiles), block_v 64-1024, with the run table built, of maximal
runs, in parts, shuffled, and of one block a row (one window added by
several CTAs), slots past the right edge, zero-visibility and empty
blocks, one launch a call and no host sync (``-k window_scatter``); the
layout mirror ``packed_tap.scatter_layout`` gives the kernel's own; the
ingests through them return the CPU port's image at 1e-5
taper-weighted.
"""

import numpy as np
import pytest
import torch

from _torch_scenario import C_0, DFREQ, FREQ0, FUSED, IMAGE_SIZE, \
    NUM_CHAN, PADDING_TASK, PARAMS, PLANE_CASES, TASK_SPECS, WTOWER_PARAMS, \
    es_scenario, fused_kernel_operands, make_inputs, plane_case, \
    task_stream, two_point_image, wtower_scenario
from ska_sdp_func_torch import kernels
from ska_sdp_func_torch.experiments._common import device_ms
from ska_sdp_func_torch.grid_data import GridderUvwEsFft, grid_correct_pswf
from ska_sdp_func_torch.grid_data import wtower as tw
from ska_sdp_func_torch.kernels import band_tap as tb
from ska_sdp_func_torch.kernels import fused_tap as tf
from ska_sdp_func_torch.kernels import packed_tap as tk
from ska_sdp_func_torch.kernels import place as tp
from ska_sdp_func_torch.kernels import tower_tap as tt
from ska_sdp_func_torch.parallel import PackedGridder, StreamingDegridder, \
    StreamingGridder, degrid_all_bucketed, degrid_all_tasks, \
    grid_all_bucketed, grid_all_tasks, inverse_index_of, plan_bucketed, \
    plan_packed, plan_stream, plan_wstack, stream_tasks
from ska_sdp_func_torch.utility.errors import SdpMemLocationError

pytestmark = pytest.mark.cuda

MODES = {"highest": dict(precision="highest"),
         "high": dict(precision="high"),
         "bf16": dict(fast=True)}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def setup(device):
    uvw, vis = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    pplan = plan_packed(plan, uvw, block_v=128)
    rng = np.random.default_rng(11)
    shape = (len(pplan.tasks), 2, pplan.num_layers * (128 + 8), 128)
    return dict(
        pplan=pplan, vis=vis,
        gs={m: PackedGridder(pplan, device=device, **kw)
            for m, kw in MODES.items()},
        cpu={m: PackedGridder(pplan, device="cpu", **kw)
             for m, kw in MODES.items()},
        vre=torch.as_tensor(rng.standard_normal(pplan.total),
                            dtype=torch.float32, device=device),
        vim=torch.as_tensor(rng.standard_normal(pplan.total),
                            dtype=torch.float32, device=device),
        stack=torch.as_tensor(rng.standard_normal(shape),
                              dtype=torch.float32, device=device))


@pytest.mark.parametrize("mode", list(MODES))
def test_grid_kernel_matches_plain(setup, mode):
    s = setup
    g, pplan = s["gs"][mode].slots, s["pplan"]
    args = (g.t_idx, g.k_idx, g.g_idx, g.ubase, g.vband,
            (g.wk_t, s["vre"], s["vim"]), len(pplan.tasks),
            pplan.num_layers, 128, 4)
    before = tk.grid_packed_stack.launches
    got = tk.grid_packed_stack(*args, block_v=pplan.block_v)
    torch.cuda.synchronize()
    assert tk.grid_packed_stack.launches == before + 1
    want = tk.grid_packed_stack_reference(*args, block_v=pplan.block_v)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("mode", list(MODES))
def test_degrid_kernel_matches_plain(setup, mode):
    s = setup
    g, pplan = s["gs"][mode].slots, s["pplan"]
    args = (s["stack"], g.t_idx, g.k_idx, g.g_idx, g.ubase, g.vband_t,
            g.wk_t, 4)
    before = tk.degrid_stack.launches
    got = tk.degrid_stack(*args, block_v=pplan.block_v)
    torch.cuda.synchronize()
    assert tk.degrid_stack.launches == before + 1
    want = tk.degrid_stack_reference(*args, block_v=pplan.block_v)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("mode", list(MODES))
def test_whole_image_matches_cpu(setup, mode):
    """The card's whole-image grid/degrid agree with the CPU port
    (plain versions) at 1e-5 of peak."""
    s = setup
    g, c = s["gs"][mode], s["cpu"][mode]
    img = g.grid(s["vis"]).cpu().numpy()
    ref = c.grid(s["vis"]).numpy()
    # Taper-weighted: the 1/PSWF-corrected border is ill-conditioned.
    k = s["pplan"].wplan
    taper = 1.0 / grid_correct_pswf(
        k.image_size, k.theta, k.w_step, k.shear_u, k.shear_v, k.support,
        k.w_support, torch.ones(k.image_size, k.image_size)).numpy()
    assert np.abs((img - ref) * taper).max() \
        <= 1e-5 * np.abs(ref * taper).max()
    model = two_point_image()
    vis = g.degrid(model).cpu().numpy()
    vref = c.degrid(model).numpy()
    assert np.abs(vis - vref).max() <= 1e-5 * np.abs(vref).max()


def test_wrappers_reject_mixed_devices(setup):
    s = setup
    g, pplan = s["gs"]["highest"].slots, s["pplan"]
    with pytest.raises(SdpMemLocationError):
        tk.grid_packed_stack(g.t_idx.cpu(), g.k_idx, g.g_idx, g.ubase,
                             g.vband, (g.wk_t, s["vre"], s["vim"]),
                             len(pplan.tasks), pplan.num_layers, 128, 4,
                             block_v=pplan.block_v)


# -- K1/K2 over bucket runs (tensor cores for "high" and "bf16") -------------

# (w_support, block_v, lanes, block order): runs of one block (each block's
# bucket differs from its neighbours'), runs of 8-12 blocks, and such runs
# with the blocks shuffled (any block order must grid right); block sizes
# that are not a multiple of the kernels' 64-slot stage (a run's last
# stage is masked).
BAND_GEOMS = [(1, 128, 128, "ones"), (2, 256, 256, "long"),
              (3, 512, 128, "long"), (4, 1024, 256, "ones"),
              (4, 128, 128, "shuffled"), (3, 256, 256, "shuffled"),
              (2, 512, 128, "ones"), (1, 1024, 256, "long"),
              (4, 512, 128, "long"), (4, 96, 128, "long"),
              (3, 200, 256, "ones")]


def _band_operands(device, w_support, block_v, lanes, order, mode,
                   seed=0, tasks=3, layers=6):
    """Random K1/K2 operands on ``device``: per-block buckets in the given
    order, bands built from random taps, a tenth of the slots padding."""
    rng = np.random.default_rng(seed)
    octets = lanes // 8
    if order == "ones":
        buckets = [int(rng.integers(0, 50))]
        while len(buckets) < 24:
            b = int(rng.integers(0, 50))
            if b != buckets[-1]:
                buckets.append(b)
    else:
        buckets = []
        while len(buckets) < 40:
            buckets += [int(rng.integers(0, 50))] * int(rng.integers(8, 13))
        if order == "shuffled":
            buckets = list(rng.permutation(buckets))
    bb = np.asarray(buckets)
    t = bb % tasks
    k = (bb // tasks) % (layers - w_support + 1)
    g = (bb * 7) % octets
    total = len(bb) * block_v
    as_dev = (lambda a, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(a), dtype=dt, device=device))
    valid = rng.random(total) >= 0.1
    ubase, vband, vband_t = tk.build_bands(
        as_dev(rng.integers(0, 8, total), torch.int32),
        as_dev(rng.integers(0, lanes - 7, total), torch.int32),
        as_dev(rng.standard_normal((total, 8))),
        as_dev(rng.standard_normal((total, 8))), lanes)
    if mode == "high":
        vband, vband_t = tk.split_bf16(vband), tk.split_bf16(vband_t)
    elif mode == "bf16":
        vband, vband_t = vband.to(torch.bfloat16), vband_t.to(torch.bfloat16)
    wk_t = as_dev(rng.uniform(0.1, 1, (w_support, total)) * valid)
    vre, vim = (as_dev(rng.standard_normal(total) * valid)
                for _ in range(2))
    stack = as_dev(rng.standard_normal(
        (tasks, 2, layers * (lanes + 8), lanes)))
    idx = [as_dev(x, torch.int32) for x in (t, k, g)]
    grid_args = (*idx, ubase, vband, (wk_t, vre, vim), tasks, layers, lanes,
                 w_support)
    degrid_args = (stack, *idx, ubase, vband_t, wk_t, w_support)
    return grid_args, degrid_args


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("geom", BAND_GEOMS,
                         ids=["-".join(map(str, g)) for g in BAND_GEOMS])
def test_band_kernels_over_runs_match_plain(device, geom, mode):
    """K1/K2 at w_support 1-4, block_v 96-1024, lanes 128 and 256, runs
    of one and of 8-12 blocks and shuffled blocks, against their plain
    versions at 1e-5 of max, one launch a call, with the run table given
    and built by the wrapper."""
    w_support, block_v, lanes, order = geom
    grid_args, degrid_args = _band_operands(device, w_support, block_v,
                                            lanes, order, mode)
    runs = tk.bucket_runs(*grid_args[:3])
    if order == "long":
        assert int(runs[:, 1].min()) >= 8
    if order == "ones":
        assert int(runs[:, 1].max()) == 1
    want_g = tk.grid_packed_stack_reference(*grid_args, block_v=block_v)
    want_d = tk.degrid_stack_reference(*degrid_args, block_v=block_v)
    for given in (runs, None):
        before = tk.launch_counts()
        got_g = tk.grid_packed_stack(*grid_args, block_v=block_v, runs=given)
        got_d = tk.degrid_stack(*degrid_args, block_v=block_v, runs=given)
        torch.cuda.synchronize()
        after = tk.launch_counts()
        assert all(after[n] == before[n] + 1 for n in after)
        assert _rel(got_g, want_g) <= 1e-5
        assert _rel(got_d, want_d) <= 1e-5


# -- window-gather degrid kernels (K4, K13, K11, K19) over bucket runs --------

# (form, S, Sw, width, block_v, order): widths 64-4096 (1024: one plane of
# both halves a group, the units cut to 1024 slots; 2048: one slab a
# group; 4096: a slab in two column tiles), block_v not a multiple of the
# 32-slot tile, runs of one block and of 8-12, shuffled, one bucket;
# "band_taps" 8 x 8 x 256 is the ES-FFT window (256 KiB, four groups of
# two planes).
GATHER_GEOMS = [
    ("stack_words", 8, 4, 128, 1024, "long"),
    ("stack_words", 8, 4, 128, 96, "ones"),
    ("stack_words", 3, 2, 256, 200, "shuffled"),
    ("stack_words", 1, 1, 64, 128, "single"),
    ("stack_words", 5, 3, 1024, 72, "long"),
    ("stack_taps", 8, 4, 128, 512, "long"),
    ("stack_taps", 2, 4, 1024, 96, "shuffled"),
    ("band_taps", 8, 8, 256, 128, "long"),
    ("band_taps", 8, 4, 128, 1024, "long"),
    ("band_taps", 4, 1, 128, 72, "ones"),
    ("band_taps", 7, 6, 384, 200, "shuffled"),
    ("band_taps", 8, 8, 256, 128, "single"),
    ("band_taps", 8, 2, 2048, 128, "long"),
    ("band_taps", 5, 1, 4096, 64, "shuffled"),
    ("band_words", 8, 4, 128, 1024, "long"),
    ("band_words", 6, 3, 256, 96, "shuffled"),
    ("band_words", 2, 1, 128, 64, "ones"),
]
GATHER_OV, GATHER_WOV, GATHER_NCOEF = 16384, 16384, 10


def _gather_keys(rng, order, num_keys):
    """Block -> window key index in the given order."""
    if order == "single":
        return np.zeros(20, np.int64)
    if order == "ones":
        keys = [int(rng.integers(0, num_keys))]
        while len(keys) < 30:
            k = int(rng.integers(0, num_keys))
            if k != keys[-1]:
                keys.append(k)
        return np.asarray(keys)
    keys = []
    while len(keys) < 40:
        keys += [int(rng.integers(0, num_keys))] * int(rng.integers(8, 13))
    keys = np.asarray(keys)
    return rng.permutation(keys) if order == "shuffled" else keys


def _gather_operands(device, form, support, w_support, width, block_v,
                     order, seed=0):
    """Random operands of one window-gather wrapper: (function, plain
    version, arguments, keywords, block keys). Stack forms: 3 tasks of
    Sw + 3 layers; plane forms: Sw + 4 planes of 72 rows, two 128-lane
    blocks wider than the window. Slots at every lane of the window, some
    past its edge (dropped), a tenth invalid; the word forms with a
    fifth of the blocks empty."""
    rng = np.random.default_rng(seed)
    stack_form = form.startswith("stack")
    if stack_form:
        tasks, layers = 3, w_support + 3
        keyspace = [(t, k, g) for t in range(tasks)
                    for k in range(layers - w_support + 1)
                    for g in range(width // 8)]
    else:
        planes_n, rows_pad, lanes_pad = w_support + 4, 72, width + 256
        keyspace = [(p, g, hv) for p in range(planes_n - w_support + 1)
                    for g in range(8) for hv in range(3)]
    kidx = _gather_keys(rng, order, len(keyspace))
    key = np.asarray([keyspace[i] for i in kidx], np.int32)
    nb = key.shape[0]
    total = nb * block_v
    as_dev = (lambda a, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(a), dtype=dt, device=device))
    iv0 = rng.integers(0, width, total)
    iv0[::7] = width - 1 - rng.integers(0, support, total)[::7]
    u_off = rng.integers(0, 8, total)
    valid = rng.random(total) >= 0.1
    idx = [as_dev(key[:, i], torch.int32) for i in range(3)]
    if stack_form:
        base = as_dev(rng.standard_normal(
            (tasks, 2, layers * (width + 8), width)))
    else:
        base = as_dev(rng.standard_normal((2, planes_n, rows_pad,
                                           lanes_pad)))
    dims = dict(block_v=block_v)
    if form.endswith("words"):
        iv0 = np.minimum(iv0, 2047)
        pa, pb = tf.pack_plan_words(
            iv0, u_off, rng.integers(0, GATHER_WOV, total),
            rng.integers(0, GATHER_OV, total),
            rng.integers(0, GATHER_OV, total), valid)
        nonempty = (rng.random(nb) >= 0.2).astype(np.int32)
        coeffs = (as_dev(rng.standard_normal((GATHER_NCOEF, support)) * 0.3),
                  as_dev(rng.standard_normal((GATHER_NCOEF, w_support))
                         * 0.3))
        dims.update(support=support, w_support=w_support,
                    oversampling=GATHER_OV, w_oversampling=GATHER_WOV,
                    nonempty=as_dev(nonempty, torch.int32))
        words = (as_dev(pa, torch.int32), as_dev(pb, torch.int32))
        if stack_form:
            return (tf.degrid_fused2_stack, tf.degrid_fused2_stack_reference,
                    (base, *idx, *words, *coeffs), dims, key)
        return (tb.degrid_fused2, tb.degrid_fused2_reference,
                (base, *idx, *words, *coeffs, width), dict(dims, raw=True),
                key)
    uk = rng.standard_normal((total, support))
    vk = rng.standard_normal((total, support))
    wk_t = as_dev(rng.uniform(0.1, 1, (w_support, total)) * valid)
    if stack_form:
        pa, _ = tf.pack_plan_words(iv0, u_off, 0, 0, 0, 1)
        return (tf.degrid_compact, tf.degrid_compact_reference,
                (base, *idx, as_dev(pa, torch.int32), as_dev(uk.T),
                 as_dev(vk.T), wk_t, support, w_support), dims, key)
    return (tb.degrid_fused, tb.degrid_fused_reference,
            (base, *idx, as_dev(u_off, torch.int32),
             as_dev(iv0, torch.int32), as_dev(uk), as_dev(vk), wk_t,
             w_support, width), dict(dims, raw=True), key)


def _gather_modes(form):
    return ["highest", "bf16"] if form == "band_taps" else list(MODES)


GATHER_CASES = [(g, m) for g in GATHER_GEOMS for m in _gather_modes(g[0])]


@pytest.mark.parametrize("geom,mode", GATHER_CASES, ids=[
    "-".join(map(str, g)) + f"-{m}" for g, m in GATHER_CASES])
def test_window_gather_kernels_match_plain(device, geom, mode):
    """K4 (``stack_words``), K13 (``stack_taps``), K11 (``band_taps``, f32
    and bf16 ``vk``) and K19 (``band_words``) against their plain versions
    at 1e-5 of max|output|: S 1-8, Sw 1 to its maximum, windows of 64-4096
    lanes (the ES window of 8 x 256 included), block_v 64-1024, runs of
    one and 8-12 blocks, shuffled and one bucket; empty blocks predict
    exactly zero. One launch a call, with the run table given (maximal
    runs, or the kernels' parts) or built by the wrapper, and no host
    sync."""
    form, support, w_support, width, block_v, order = geom
    fn, ref, args, kw, key = _gather_operands(
        device, form, support, w_support, width, block_v, order)
    if form == "band_taps" and mode == "bf16":
        args = (*args[:7], args[7].to(torch.bfloat16), *args[8:])
    elif form != "band_taps":
        kw = dict(kw, precision=mode)
    want = ref(*args, **kw)
    keys = args[1:4]
    tables = [None, tk.bucket_runs(*keys), tk.degrid_runs(keys)]
    if order == "ones":
        assert int(tables[1][:, 1].max()) == 1
    if order == "long":
        assert int(tables[1][:, 1].min()) >= 8
    for runs in tables:
        before = fn.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(*args, **kw, runs=runs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert _rel(got, want) <= 1e-5
        if "nonempty" in kw:
            empty = torch.repeat_interleave(kw["nonempty"] == 0, block_v)
            got_e = got[..., empty] if got.ndim == 1 else got[:2, empty]
            assert not bool(got_e.abs().max() > 0)
        if got.ndim == 2:
            assert not bool(got[2:].abs().max() > 0)


# -- w-towers tap kernels ----------------------------------------------------

def _tower_operands(device, size, num_layers=7, total=5000, seed=0):
    """Flat taps (each visibility on W consecutive layers, a tenth of
    them inactive) and a plane geometry at sub-grid size ``size``."""
    rng = np.random.default_rng(seed)
    s_, w_ = 8, 4
    iu0 = rng.integers(0, size - s_ + 1, total)
    iv0 = rng.integers(0, size - s_ + 1, total)
    j = rng.integers(0, num_layers - w_ + 1, total)
    weights = np.zeros((total, num_layers), np.float32)
    for layer in range(w_):
        weights[np.arange(total), j + layer] = rng.uniform(0.1, 1, total)
    weights[rng.random(total) < 0.1] = 0.0

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    flat = dict(
        iu0=put(iu0, torch.int32), iv0=put(iv0, torch.int32),
        uk=put(rng.standard_normal((total, s_)), torch.float32),
        vk=put(rng.standard_normal((total, s_)), torch.float32),
        weights=put(weights, torch.float32),
        vre=put(rng.standard_normal(total), torch.float32),
        vim=put(rng.standard_normal(total), torch.float32),
        layers=put(rng.standard_normal((num_layers, size, size))
                   + 1j * rng.standard_normal((num_layers, size, size)),
                   torch.complex64))
    rows = total // 2
    ov = 64
    tables = (put(rng.uniform(0, 1, (ov + 1, s_)), torch.float32),
              put(rng.uniform(0, 1, (ov + 1, w_)), torch.float32))
    geom = (put(rng.random((rows, 2)) < 0.8, torch.bool),
            put(iu0[:2 * rows].reshape(rows, 2), torch.int32),
            put(iv0[:2 * rows].reshape(rows, 2), torch.int32),
            put(rng.integers(0, ov + 1, (rows, 2)), torch.int64),
            put(rng.integers(0, ov + 1, (rows, 2)), torch.int64),
            put(rng.integers(0, ov + 1, (rows, 2)), torch.int64))
    vis = put(rng.standard_normal((rows, 2))
              + 1j * rng.standard_normal((rows, 2)), torch.complex64)
    sub = put(rng.standard_normal((w_, size, size))
              + 1j * rng.standard_normal((w_, size, size)), torch.complex64)
    return flat, tables, geom, vis, sub


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


# 256 takes the kernel's global-atomic path (no shared-memory plane).
@pytest.mark.parametrize("size", [32, 64, 128, 256])
def test_tower_grid_kernels_match_plain(device, size):
    f, tables, geom, vis, sub = _tower_operands(device, size)
    k = f["weights"].shape[1]
    args = (f["vre"], f["vim"], f["iu0"], f["iv0"], f["uk"], f["vk"],
            f["weights"], k, size, 8)
    before = tt.launch_counts()
    got = tt.grid_all_layers(*args)
    want = tt.grid_all_layers_reference(*args)
    assert _rel(got, want) <= 1e-5
    got = tt.grid_plane(sub, vis, *tables, geom, 8, 4)
    want = tt.grid_plane_reference(sub, vis, *tables, geom, 8, 4)
    torch.cuda.synchronize()
    assert _rel(got - sub, want - sub) <= 1e-5
    after = tt.launch_counts()
    assert after["grid_all_layers"] == before["grid_all_layers"] + 1
    assert after["grid_plane"] == before["grid_plane"] + 1


@pytest.mark.parametrize("size", [32, 64, 128, 256])
def test_tower_degrid_kernels_match_plain(device, size):
    f, tables, geom, _, sub = _tower_operands(device, size, seed=1)
    args = (f["layers"], f["iu0"], f["iv0"], f["uk"], f["vk"],
            f["weights"], 8)
    before = tt.launch_counts()
    assert _rel(tt.degrid_all_layers(*args),
                tt.degrid_all_layers_reference(*args)) <= 1e-5
    got = tt.degrid_plane(sub, *tables, geom, 8, 4)
    want = tt.degrid_plane_reference(sub, *tables, geom, 8, 4)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5
    after = tt.launch_counts()
    assert after["degrid_all_layers"] == before["degrid_all_layers"] + 1
    assert after["degrid_plane"] == before["degrid_plane"] + 1


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("case", PLANE_CASES)
def test_plane_kernels_on_compaction_cases(device, case, size, fast):
    """K14/K15 against their plain versions (an all-masked plane exactly
    zero), one launch each, and no host sync inside either wrapper."""
    geom, uv_k, w_k, vis, sub = plane_case(case, size, rows=300, chans=16,
                                           seed=size)
    geom = tuple(torch.as_tensor(g, device=device) for g in geom)
    uv_k, w_k, vis, sub = (torch.as_tensor(a, device=device)
                           for a in (uv_k, w_k, vis, sub))
    before = tt.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_g = tt.grid_plane(sub, vis, uv_k, w_k, geom, 8, 4, fast=fast)
        got_d = tt.degrid_plane(sub, uv_k, w_k, geom, 8, 4, fast=fast)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = tt.launch_counts()
    assert after["grid_plane"] == before["grid_plane"] + 1
    assert after["degrid_plane"] == before["degrid_plane"] + 1
    want_g = tt.grid_plane_reference(sub, vis, uv_k, w_k, geom, 8, 4,
                                     fast=fast)
    want_d = tt.degrid_plane_reference(sub, uv_k, w_k, geom, 8, 4,
                                       fast=fast)
    torch.cuda.synchronize()
    for got, want in ((got_g - sub, want_g - sub), (got_d, want_d)):
        if not bool(geom[0].any()):
            assert not bool(got.any()) and not bool(want.any())
        else:
            assert _rel(got, want) <= 1e-5
    assert not bool(got_d[~geom[0]].any())


# 192 takes the grid kernel's global-atomic path (a plane pair of 307 KB
# does not fit in shared memory). Support 12 takes the grid kernel's
# 16-tap body in one pass, 20 in two passes; both take the degrid
# kernel's any-support body (tap rows read from memory). Supports 56 and
# 72 (13 and 21 passes) take the grid kernel's body that reads its tap
# rows from memory too: past 54 the staged rows do not fit in shared
# memory. Each support runs at the sizes wider than it.
TASK_GEOMS = [(s, n) for s in (8, 12, 20, 56, 72) for n in (32, 64, 192)
              if n > s]


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("support,size", TASK_GEOMS)
def test_tower_task_kernels_match_plain(device, support, size, fast):
    """K16/K17 over a ragged stream of tasks against their plain versions,
    one launch each and no host sync; every plane and slot written."""
    *arrays, rows = task_stream(size, seed=size, support=support)
    vre, vim, iu0, iv0, uk, vk, w = (torch.as_tensor(a, device=device)
                                     for a in arrays)
    tasks = tt.task_table(rows, device)
    rng = np.random.default_rng(size)
    layers = torch.as_tensor(
        (rng.standard_normal((tasks.planes, size, size))
         + 1j * rng.standard_normal((tasks.planes, size, size))).astype(
             np.complex64), device=device)
    grid_args = (vre, vim, iu0, iv0, uk, vk, w, tasks, size, support)
    degrid_args = (layers, iu0, iv0, uk, vk, w, tasks, support)
    before = tt.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_g = tt.grid_all_layers_tasks(*grid_args, fast=fast)
        got_d = tt.degrid_all_layers_tasks(*degrid_args, fast=fast)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = tt.launch_counts()
    for name in ("grid_all_layers_tasks", "degrid_all_layers_tasks"):
        assert after[name] == before[name] + 1
    want_g = tt.grid_all_layers_tasks_reference(*grid_args, fast=fast)
    want_d = tt.degrid_all_layers_tasks_reference(*degrid_args, fast=fast)
    torch.cuda.synchronize()
    assert _rel(got_g, want_g) <= 1e-5
    assert _rel(got_d, want_d) <= 1e-5
    held = torch.zeros(iu0.shape[0], dtype=torch.bool, device=device)
    for start, count, _, _ in rows:
        held[start:start + count] = True
    assert not bool(got_d[~held].any())
    for t in (PADDING_TASK, TASK_SPECS.index((0, 7))):
        start, count, k, base = rows[t]
        assert not bool(got_g[base:base + k].any())
        assert not bool(got_d[start:start + count].any())
    if fast:
        # Against the f32 kernels, per output: within the rounding of its
        # terms' bf16 operands, 2^-7 (1 + 2^-9) of the sum of |terms| (a
        # cell of a sparse task sums few terms, so 4e-3 of max|output|,
        # the envelope of random dense operands, does not hold there).
        sums_g = tt.grid_all_layers_tasks_reference(
            vre.abs(), vim.abs(), iu0, iv0, uk.abs(), vk.abs(), w.abs(),
            tasks, size, support)
        sums_d = tt.degrid_all_layers_tasks_reference(
            torch.complex(layers.real.abs(), layers.imag.abs()), iu0, iv0,
            uk.abs(), vk.abs(), w.abs(), tasks, support)
        for got, f32, sums in (
                (got_g, tt.grid_all_layers_tasks(*grid_args), sums_g),
                (got_d, tt.degrid_all_layers_tasks(*degrid_args), sums_d)):
            assert 0 < _rel(got, f32)
            for part in (torch.real, torch.imag):
                err = (part(got) - part(f32)).abs()
                assert not bool((err > 2 ** -7 * (1 + 2 ** -9) * part(sums)
                                 + 1e-6 * part(f32).abs().max()).any())


# Supports 12 and 20 are geometries the packed path rejects (the
# fallback's reason to exist).
@pytest.mark.parametrize("support", [8, 12, 20])
def test_bucketed_on_card_launches_task_kernels_once(device, support):
    """The bucketed fallback on the card: one K16 launch a grid call and
    one K17 launch a degrid call (and no other tower kernel), against the
    CPU port at 1e-5 (the image taper-weighted)."""
    uvw, vis = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE,
                       **dict(PARAMS, subgrid_size=64, support=support))
    bplan, sort_index, valid = plan_bucketed(plan, uvw, block_v=128)
    inv = inverse_index_of(sort_index, valid, vis.size)
    model = torch.as_tensor(two_point_image())
    out = {}
    for dev in ("cpu", device):
        u, v = torch.as_tensor(uvw, device=dev), torch.as_tensor(vis,
                                                                 device=dev)
        tt.reset_launch_counts()
        img = grid_all_bucketed(bplan, v, u, sort_index, valid, device=dev)
        grid_counts = tt.launch_counts()
        tt.reset_launch_counts()
        pred = degrid_all_bucketed(bplan, model, u, sort_index, valid, inv,
                                   device=dev)
        out[str(dev)] = img.cpu(), pred.cpu(), grid_counts, \
            tt.launch_counts()
    (i0, p0, _, _), (i1, p1, gc, dc) = out["cpu"], out[str(device)]
    assert gc == dict.fromkeys(gc, 0) | {"grid_all_layers_tasks": 1}
    assert dc == dict.fromkeys(dc, 0) | {"degrid_all_layers_tasks": 1}
    k = plan.kernel()
    taper = 1.0 / grid_correct_pswf(
        k.image_size, k.theta, k.w_step, k.shear_u, k.shear_v, k.support,
        k.w_support, torch.ones(k.image_size, k.image_size))
    assert _rel(i1 * taper, i0 * taper) <= 1e-5
    assert _rel(p1, p0) <= 1e-5


def test_wtower_c64_on_card_takes_fused_kernels(device):
    """GridderWtowerUVW on complex64 CUDA data launches the all-layer
    kernels and agrees with the CPU port, which runs the per-plane form
    of the same operator."""
    uvw, ch, image = wtower_scenario()
    rows = uvw.shape[0]
    st, en = np.zeros(rows, np.int32), np.full(rows, ch, np.int32)
    out = {}
    for dev in ("cpu", device):
        plan = tw.GridderWtowerUVW(**WTOWER_PARAMS)
        args = [torch.as_tensor(a, device=dev) for a in (uvw, st, en)]
        before = tt.launch_counts()
        vis = plan.degrid_subgrid(
            torch.as_tensor(image, dtype=torch.complex64, device=dev),
            (10, -6, 1), ch, C_0, C_0 / 100, *args,
            torch.zeros((rows, ch), dtype=torch.complex64, device=dev),
            device=dev)
        sub = plan.grid_subgrid(
            vis, *args, ch, C_0, C_0 / 100,
            torch.zeros((64, 64), dtype=torch.complex64, device=dev),
            (10, -6, 1), device=dev)
        out[str(dev)] = vis.cpu(), sub.cpu(), before, tt.launch_counts()
    (v0, s0, _, _), (v1, s1, b1, a1) = out["cpu"], out[str(device)]
    assert _rel(v1, v0) <= 1e-5 and _rel(s1, s0) <= 1e-5
    assert a1["degrid_all_layers"] == b1["degrid_all_layers"] + 1
    assert a1["grid_all_layers"] == b1["grid_all_layers"] + 1


def test_task_drivers_on_card_launch_plane_kernels(device):
    uvw, vis = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    st = torch.zeros(uvw.shape[0], dtype=torch.int32)
    en = torch.full((uvw.shape[0],), NUM_CHAN, dtype=torch.int32)
    out = {}
    for dev in ("cpu", device):
        u = torch.as_tensor(uvw, device=dev)
        tt.reset_launch_counts()
        img = grid_all_tasks(plan, plan.kernel(),
                             torch.as_tensor(vis, device=dev), u,
                             st.to(dev), en.to(dev), device=dev).real
        # A bounded model: degridding the raw dirty image would read its
        # 1/PSWF-amplified border.
        pred = degrid_all_tasks(
            plan, plan.kernel(),
            torch.as_tensor(two_point_image(), dtype=torch.complex64,
                            device=dev), u, st.to(dev), en.to(dev),
            torch.complex64, device=dev)
        out[str(dev)] = img.cpu(), pred.cpu(), tt.launch_counts()
    (i0, p0, c0), (i1, p1, c1) = out["cpu"], out[str(device)]
    assert set(c0.values()) == {0}
    assert c1["grid_plane"] > 0 and c1["degrid_plane"] > 0
    k = plan.kernel()
    taper = 1.0 / grid_correct_pswf(
        k.image_size, k.theta, k.w_step, k.shear_u, k.shear_v, k.support,
        k.w_support, torch.ones(k.image_size, k.image_size))
    assert _rel(i1 * taper, i0 * taper) <= 1e-5
    assert _rel(p1, p0) <= 1e-5


# -- fused kernels (K3, K4) and placement (K5) ---------------------------------

@pytest.fixture(scope="module")
def fused(device):
    from ska_sdp_func_torch.grid_data.wtower import _tap_coeffs_cached

    f = FUSED
    _, ops = fused_kernel_operands()
    t = {k: torch.as_tensor(v, device=device) for k, v in ops.items()}
    t["uv"] = torch.as_tensor(_tap_coeffs_cached(
        f["support"], f["oversampling"]), dtype=torch.float32, device=device)
    t["w"] = torch.as_tensor(_tap_coeffs_cached(
        f["w_support"], f["w_oversampling"]), dtype=torch.float32,
        device=device)
    return t


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_grid_kernel_matches_plain(fused, mode):
    f, t = FUSED, fused
    args = (t["t"], t["k"], t["g"], t["pa"], t["pb"], t["vre"], t["vim"],
            t["uv"], t["w"], f["tasks"], f["layers"], f["lanes"],
            f["support"], f["w_support"], f["oversampling"],
            f["w_oversampling"])
    kw = dict(block_v=f["block_v"], precision=mode, nonempty=t["nonempty"])
    before = tf.grid_fused_stack.launches
    got = tf.grid_fused_stack(*args, **kw)
    torch.cuda.synchronize()
    assert tf.grid_fused_stack.launches == before + 1
    want = tf.grid_fused_stack_reference(*args, **kw)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_degrid_kernel_matches_plain(fused, mode):
    f, t = FUSED, fused
    args = (t["stack"], t["t"], t["k"], t["g"], t["pa"], t["pb"], t["uv"],
            t["w"], f["support"], f["w_support"], f["oversampling"],
            f["w_oversampling"])
    kw = dict(block_v=f["block_v"], precision=mode, nonempty=t["nonempty"])
    before = tf.degrid_fused2_stack.launches
    got = tf.degrid_fused2_stack(*args, **kw)
    torch.cuda.synchronize()
    assert tf.degrid_fused2_stack.launches == before + 1
    want = tf.degrid_fused2_stack_reference(*args, **kw)
    assert _rel(got, want) <= 1e-5
    empty = torch.repeat_interleave(t["nonempty"] == 0, f["block_v"])
    assert not bool(got[empty].abs().max() > 0)


@pytest.mark.parametrize("bv", [64, 100, 128, 512, 1024])
def test_place_kernel_matches_plain(device, bv):
    rng = np.random.default_rng(bv)
    n, nblocks = 20000, 40
    vcnt = rng.integers(-3, bv + 1, nblocks)
    vcnt[::4] = 0
    src0 = rng.integers(0, n + 1, nblocks)
    src0[1], vcnt[1] = n - 5, bv          # reads past the end
    ops = [torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, n,
                                        dtype=np.int64).astype(np.int32),
                           device=device),
           torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                           device=device)] * 5   # 10 payloads, 2 launches
    args = (torch.as_tensor(src0, dtype=torch.int32, device=device),
            torch.as_tensor(vcnt, dtype=torch.int32, device=device), ops,
            bv, bv * nblocks)
    before = tp.place_stream.launches
    got = tp.place_stream(*args)
    torch.cuda.synchronize()
    assert tp.place_stream.launches == before + 2
    for g, w in zip(got, tp.place_stream_reference(*args)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


# (case, bv, payloads): src0 at every residue mod 4 with blocks past the
# end and filler blocks; payload views at element offsets 1-3; 8 payloads
# in one launch, 9 in two; bv off the 16-byte vector.
PLACE_CASES = [("residues", 512, 4), ("views", 128, 4),
               ("8 payloads", 64, 8), ("9 payloads", 1024, 9),
               ("views", 100, 3)]


@pytest.mark.parametrize("case,bv,count", PLACE_CASES,
                         ids=[f"{c[0].replace(' ', '')}-{c[1]}"
                              for c in PLACE_CASES])
def test_place_kernel_cases(device, case, bv, count):
    """K5 bit-equal to its plain version, one launch per 8 payloads."""
    rng = np.random.default_rng(bv + count)
    n, nblocks = 30011, 53
    src0 = rng.integers(-5, n + 5, nblocks)
    src0 = src0 - src0 % 4 + np.arange(nblocks) % 4
    vcnt = rng.integers(-2, bv + 1, nblocks)
    vcnt[1::5] = bv
    src0[-2:], vcnt[-2:] = (n - 7, n - bv // 2), bv     # past the end
    src0[3], vcnt[3] = -3, bv                           # before the start
    whole = [torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, n + 3,
                                          dtype=np.int64).astype(np.int32),
                             device=device) if j % 2 == 0
             else torch.as_tensor(rng.standard_normal(n + 3),
                                  dtype=torch.float32, device=device)
             for j in range(count)]
    off = [1 + j % 3 if case == "views" else 0 for j in range(count)]
    ops = [w[o:o + n] for w, o in zip(whole, off)]
    args = (torch.as_tensor(src0, dtype=torch.int32, device=device),
            torch.as_tensor(vcnt, dtype=torch.int32, device=device), ops,
            bv, bv * nblocks)
    before = tp.place_stream.launches
    got = tp.place_stream(*args)
    torch.cuda.synchronize()
    assert tp.place_stream.launches == before + (count + 7) // 8
    for g, w, o in zip(got, tp.place_stream_reference(*args), ops):
        assert g.dtype == o.dtype and tuple(g.shape) == (bv * nblocks,)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _stream_on_card(device, params, block_v, names, fast=False):
    """StreamingGridder/StreamingDegridder (``fast`` as given) on the card
    and on the CPU: only the kernels ``names`` launch on the card, and the
    image (taper-weighted) and predictions agree with the CPU port."""
    uvw, vis = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **params)
    sp = plan_stream(plan, stream_tasks(plan, uvw), chunk_rows=64,
                     block_v=block_v, cap_slots=20480)
    model = two_point_image()
    out = {}
    for dev in ("cpu", device):
        kernels.reset_launch_counts()
        sg = StreamingGridder(sp, fast=fast, device=dev)
        sd = StreamingDegridder(sp, fast=fast, device=dev).set_model(model)
        preds = []
        for lo in range(0, uvw.shape[0], 64):
            sg.accumulate(uvw[lo:lo + 64], vis[lo:lo + 64])
            preds.append(sd.predict(uvw[lo:lo + 64]))
        img = sg.finalize()
        sd.check()
        out[str(dev)] = (img.cpu(), torch.cat(preds).cpu(),
                         kernels.launch_counts())
    (i0, p0, c0), (i1, p1, c1) = out["cpu"], out[str(device)]
    assert set(c0.values()) == {0}
    assert all(c1[n] > 0 for n in names)
    assert all(v == 0 for n, v in c1.items() if n not in names)
    k = plan.kernel()
    taper = 1.0 / grid_correct_pswf(
        k.image_size, k.theta, k.w_step, k.shear_u, k.shear_v, k.support,
        k.w_support, torch.ones(k.image_size, k.image_size))
    assert _rel(i1 * taper, i0 * taper) <= 1e-5
    assert _rel(p1, p0) <= 1e-5


def test_streaming_on_card_launches_fused_kernels(device):
    """A packable stream on the card launches K3, K4 and K5 only."""
    _stream_on_card(device, PARAMS, 128,
                    {"grid_fused_stack", "degrid_fused2_stack", "place_stream"})


@pytest.mark.parametrize("geom", ["oversampling", "block_v"])
def test_non_packable_streaming_on_card(device, geom):
    """A non-packable stream (oversampling 65536, or 64-slot blocks) on the
    card launches K5, K6, K7, K8, K11 and the fold kernel only."""
    params = {**PARAMS, "oversampling": 65536} if geom == "oversampling" \
        else PARAMS
    _stream_on_card(device, params, 128 if geom == "oversampling" else 64,
                    {"place_stream", "stream_prep_grid", "stream_prep_degrid",
                     "grid_packed", "fold_windows", "degrid_fused"})


@pytest.mark.parametrize("geom", ["oversampling", "block_v"])
def test_non_packable_fast_streaming_on_card(device, geom):
    """The same streams with ``fast=True``: the bf16 modes of K6, K7, K8
    and K11, and no other kernel."""
    params = {**PARAMS, "oversampling": 65536} if geom == "oversampling" \
        else PARAMS
    _stream_on_card(device, params, 128 if geom == "oversampling" else 64,
                    {"place_stream", "stream_prep_grid", "stream_prep_degrid",
                     "grid_packed", "fold_windows", "degrid_fused"},
                    fast=True)


@pytest.mark.parametrize("bv", [64, 1024])
def test_stream_prep_and_fold_kernels_match_plain(device, bv):
    """K6, K7 and the fold kernel (K9 + K10) against their plain versions
    on 24 plan blocks of ``bv`` slots at oversampling 65536 over 3 tasks x
    8 slabs x 16 octets; the fold reads the windows K8 grids from K6's
    output, NaN in the unvisited buckets. Same operations in the same
    order: equal to 1e-5 (expected bit for bit)."""
    from ska_sdp_func_torch.grid_data.wtower import _tap_coeffs_cached
    from ska_sdp_func_torch.kernels import fold
    from ska_sdp_func_torch.kernels import stream_prep as tsp

    rng = np.random.default_rng(bv)
    ov, wov, s_, sw, lanes = 65536, 16384, 8, 4, 128
    tasks, slabs, octets = 3, 8, 16
    nb, total = tasks * slabs * octets, 24 * bv
    valid = rng.random(total) < 0.9

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    f = {k: put(np.where(valid, v, 0), torch.int32) for k, v in dict(
        u_off=rng.integers(0, 8, total),
        iv0=rng.integers(0, lanes - s_ + 1, total),
        u_frac=rng.integers(0, ov + 1, total),
        v_frac=rng.integers(0, ov + 1, total),
        w_row=rng.integers(0, wov + 1, total)).items()}
    vre, vim = (put(np.where(valid, rng.standard_normal(total), 0),
                    torch.float32) for _ in range(2))
    uv = put(_tap_coeffs_cached(s_, ov), torch.float32)
    w = put(_tap_coeffs_cached(sw, wov), torch.float32)
    fields = (f["u_frac"], f["v_frac"], f["w_row"])
    before = kernels.launch_counts()
    taps = tsp.stream_prep_grid(*fields, vre, vim, uv, w, ov, wov)
    want = tsp.stream_prep_grid_reference(*fields, vre, vim, uv, w, ov, wov)
    assert all(_rel(a, b) <= 1e-5 for a, b in zip(taps, want))
    # The bf16 mode: bit for bit, vk bf16.
    for prep, extra in ((tsp.stream_prep_grid, (vre, vim)),
                        (tsp.stream_prep_degrid,
                         (put(valid, torch.float32),))):
        got = prep(*fields, *extra, uv, w, ov, wov, fast=True)
        ref = getattr(tsp, prep.__name__ + "_reference")(
            *fields, *extra, uv, w, ov, wov, fast=True)
        assert got[1].dtype == torch.bfloat16
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    got = tsp.stream_prep_degrid(*fields, put(valid, torch.float32), uv, w,
                                 ov, wov)
    want = tsp.stream_prep_degrid_reference(*fields, put(valid, torch.float32),
                                            uv, w, ov, wov)
    assert all(_rel(a, b) <= 1e-5 for a, b in zip(got, want))
    bb = np.sort(rng.choice(nb, 24, replace=False))
    wins = tb.grid_packed(put(bb, torch.int32), f["u_off"], f["iv0"], *taps,
                          nb, lanes, sw, block_v=bv)
    visited = torch.zeros(nb, dtype=torch.bool, device=device)
    visited[put(bb, torch.int64)] = True
    wins[:, ~visited] = float("nan")
    args = (wins, visited, tasks, slabs, octets, sw, slabs + sw - 1)
    got = fold.fold_windows(*args)
    torch.cuda.synchronize()
    want = fold.fold_windows_reference(*args)
    assert bool(torch.isfinite(got).all()) and _rel(got, want) <= 1e-5
    after = kernels.launch_counts()
    for name, n in (("stream_prep_grid", 2), ("stream_prep_degrid", 2),
                    ("fold_windows", 1), ("grid_packed", 1)):
        assert after[name] == before[name] + n, name


# Redesigned K6/K7 (a thread a (slot, tap), w taps and scale rows through
# shared memory): totals that leave ragged 256-slot tiles and scale rows
# that start unaligned (1, 31, 33, 4099, 24 x 1024), the unrolled instance
# (ncoef 12, S 8, Sw 1, 2, 4, 8) and the generic one (S 1, 5, 8; Sw 1, 3,
# 4, 8; ncoef 1, 12, 16) as (total, S, Sw, ncoef).
PREP_CASES = [
    (1, 8, 4, 12), (31, 8, 4, 12), (33, 8, 4, 12), (4099, 8, 4, 12),
    (24 * 1024, 8, 4, 12), (4099, 8, 1, 12), (33, 8, 8, 12),
    (4099, 8, 2, 12), (4099, 8, 3, 12),
    (4099, 8, 4, 16), (1, 1, 1, 1), (31, 1, 8, 12), (4099, 5, 4, 12),
    (33, 5, 1, 16), (24 * 1024, 5, 8, 16), (4099, 1, 4, 16),
    (4099, 8, 8, 1),
]


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("total,s_,sw,ncoef", PREP_CASES,
                         ids=[f"V{v}-S{s}-Sw{w}-n{n}"
                              for v, s, w, n in PREP_CASES])
def test_stream_prep_kernels_bit_equal(device, total, s_, sw, ncoef, fast):
    """K6 and K7 against their plain versions on the card, bit for bit
    (the same operations in the same order, each rounded on its own),
    through the instance the fits select (``stream_prep.instance``,
    checked against the kernel's own choice); one launch a call."""
    from ska_sdp_func_torch.kernels import _build
    from ska_sdp_func_torch.kernels import stream_prep as tsp

    rng = np.random.default_rng(total * 7 + s_ * 3 + sw + ncoef)
    ov, wov = 65536, 16384
    valid = rng.random(total) < 0.9

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    fields = [put(np.where(valid, rng.integers(0, top + 1, total), 0),
                  torch.int32) for top in (ov, ov, wov)]
    vre, vim = (put(np.where(valid, rng.standard_normal(total), 0),
                    torch.float32) for _ in range(2))
    uv = put(rng.standard_normal((ncoef, s_)), torch.float32)
    w = put(rng.standard_normal((ncoef, sw)), torch.float32)
    unrolled = _build.load().sdp_torch_stream_prep_unrolled(ncoef, s_, sw)
    assert tsp.instance(True, fast, ncoef, s_, sw).endswith(
        "12, 8>" if unrolled else "0, 0>")
    for prep, extra in ((tsp.stream_prep_grid, (vre, vim)),
                        (tsp.stream_prep_degrid,
                         (put(valid, torch.float32),))):
        before = prep.launches
        got = prep(*fields, *extra, uv, w, ov, wov, fast=fast)
        torch.cuda.synchronize()
        assert prep.launches == before + 1
        want = getattr(tsp, prep.__name__ + "_reference")(
            *fields, *extra, uv, w, ov, wov, fast=fast)
        assert got[1].dtype == (torch.bfloat16 if fast else torch.float32)
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b), prep.__name__


# -- compact kernels (K12, K13) and the compact engine -------------------------

@pytest.fixture(scope="module")
def compact(fused):
    """The fused kernels' operands with the compact taps (uk_t/vk_t
    [S, V], wk_t [Sw, V] zero on invalid slots) evaluated on the card."""
    f = FUSED
    fields, _ = fused_kernel_operands()
    dev = fused["pa"].device

    def taps(name, coeffs, ov):
        return tf.cheb_taps(torch.as_tensor(fields[name], device=dev),
                            coeffs, ov)

    valid = torch.as_tensor(fields["valid"].astype(bool), device=dev)
    t = dict(fused)
    t["uk_t"] = taps("u_frac", fused["uv"], f["oversampling"]).T.contiguous()
    t["vk_t"] = taps("v_frac", fused["uv"], f["oversampling"]).T.contiguous()
    t["wk_t"] = torch.where(valid[:, None], taps(
        "w_row", fused["w"], f["w_oversampling"]), 0.0).T.contiguous()
    return t


def _shuffled(runs, seed=2):
    """A run table's rows in a random order (any order is right)."""
    perm = torch.randperm(runs.shape[0], generator=torch.Generator(
        ).manual_seed(seed)).to(runs.device)
    return runs[perm].contiguous()


@pytest.mark.parametrize("mode", list(MODES))
def test_compact_grid_kernel_matches_plain(compact, mode):
    """K12 (window_scatter_kernel<M, kStackTaps>) in each mode, with the
    run table built by the wrapper and given in shuffled row order."""
    f, t = FUSED, compact
    args = tuple(t[k] for k in ("t", "k", "g", "pa", "uk_t", "vk_t", "wk_t",
                                "vre", "vim")) + (
        f["tasks"], f["layers"], f["lanes"], f["support"], f["w_support"])
    kw = dict(block_v=f["block_v"], precision=mode)
    want = tf.grid_compact_reference(*args, **kw)
    for runs in (None, _shuffled(tk.degrid_runs((t["t"], t["k"], t["g"])))):
        before = tf.grid_compact.launches
        got = tf.grid_compact(*args, **kw, runs=runs)
        torch.cuda.synchronize()
        assert tf.grid_compact.launches == before + 1
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("mode", ["highest", "bf16"])
def test_compact_degrid_kernel_matches_plain(compact, mode):
    f, t = FUSED, compact
    args = tuple(t[k] for k in ("stack", "t", "k", "g", "pa", "uk_t",
                                "vk_t", "wk_t")) + (f["support"],
                                                    f["w_support"])
    kw = dict(block_v=f["block_v"], precision=mode)
    before = tf.degrid_compact.launches
    got = tf.degrid_compact(*args, **kw)
    torch.cuda.synchronize()
    assert tf.degrid_compact.launches == before + 1
    assert _rel(got, tf.degrid_compact_reference(*args, **kw)) <= 1e-5


def test_compact_engine_on_card_launches_compact_kernels(setup):
    """PackedGridder(engine="compact") on the card: only K12/K13 launch,
    and the image (taper-weighted) and degrid agree with the CPU port."""
    pplan, dev = setup["pplan"], setup["vre"].device
    out = {}
    for d in ("cpu", dev):
        g = PackedGridder(pplan, engine="compact", device=d)
        kernels.reset_launch_counts()
        img = g.grid(setup["vis"])
        pred = g.degrid_sorted(two_point_image())
        torch.cuda.synchronize()
        out[str(d)] = (img.cpu(), pred.cpu(), kernels.launch_counts())
    (i0, p0, c0), (i1, p1, c1) = out["cpu"], out[str(dev)]
    assert set(c0.values()) == {0}
    names = {"grid_compact", "degrid_compact"}
    assert all(c1[n] == 1 for n in names)
    assert all(v == 0 for n, v in c1.items() if n not in names)
    k = pplan.wplan.kernel()
    taper = 1.0 / grid_correct_pswf(
        k.image_size, k.theta, k.w_step, k.shear_u, k.shear_v, k.support,
        k.w_support, torch.ones(k.image_size, k.image_size))
    assert _rel(i1 * taper, i0 * taper) <= 1e-5
    assert _rel(p1, p0) <= 1e-5


# -- ES-FFT band kernels (K8, K11) and the ES-FFT gridder ---------------------

def _es_plan(d, do_wstacking, device):
    vis = d["vis"].astype(np.complex64)
    return GridderUvwEsFft(
        d["uvw"], d["freq"], vis, d["weight"],
        np.zeros((d["image_size"],) * 2, np.float32), d["pixel_size"],
        d["pixel_size"], 1e-5,
        *GridderUvwEsFft.get_w_range(d["uvw"], d["freq"]), do_wstacking,
        device=device)


@pytest.fixture(scope="module")
def es(device):
    d = es_scenario()
    return d, {ws: _es_plan(d, ws, device) for ws in (False, True)}


@pytest.mark.parametrize("form", ["split", "stack"])
@pytest.mark.parametrize("ws", [False, True], ids=["2d", "3d"])
def test_band_grid_kernel_matches_plain(es, ws, form):
    ep = es[1][ws]._packed
    dd = ep.dev
    gen = torch.Generator(device=dd["uk"].device).manual_seed(4)
    vre, vim = (torch.randn(ep.total, generator=gen, device=dd["uk"].device)
                * dd["valid"] for _ in range(2))
    scales = ((dd["kw_t"], vre, vim) if form == "split"
              else torch.cat([dd["kw_t"] * vre, dd["kw_t"] * vim]))
    args = (dd["block_bucket"], dd["u_off"], dd["iv0"], dd["uk"], dd["vk"],
            scales, ep.num_slabs * ep.gu * ep.gv, 256, ep.w_support)
    want = tb.grid_packed_reference(*args, block_v=ep.block_v)
    for runs in (None, _shuffled(tk.degrid_runs((dd["block_bucket"],)))):
        before = tb.grid_packed.launches
        got = tb.grid_packed(*args, block_v=ep.block_v, runs=runs)
        torch.cuda.synchronize()
        assert tb.grid_packed.launches == before + 1
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("n_vq", [1, 2])
def test_band_degrid_kernel_matches_plain(es, n_vq):
    ep = es[1][True]._packed
    dd = ep.dev
    gen = torch.Generator(device=dd["uk"].device).manual_seed(5)
    planes = torch.randn((2, ep.num_w_grids, ep.rows_pad, ep.lanes_pad),
                         generator=gen, device=dd["uk"].device)
    args = (planes, dd["k_idx"], dd["g_idx"], dd["hv_idx"], dd["u_off"],
            dd["iv0"], dd["uk"], dd["vk"], dd["kw_t"], ep.w_support,
            128 * n_vq)
    before = tb.degrid_fused.launches
    got = tb.degrid_fused(*args, block_v=ep.block_v, raw=True)
    torch.cuda.synchronize()
    assert tb.degrid_fused.launches == before + 1
    want = tb.degrid_fused_reference(*args, block_v=ep.block_v, raw=True)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("ws", [False, True], ids=["2d", "3d"])
def test_es_gridder_on_card_launches_band_kernels(es, ws):
    """GridderUvwEsFft (complex64) on the card: only K8/K11 launch, and
    the image and predictions agree with the CPU port at 1e-5."""
    d, plans = es
    dev = plans[ws].device
    vis = d["vis"].astype(np.complex64)
    model = np.random.default_rng(3).standard_normal(
        (d["image_size"],) * 2).astype(np.float32)
    out = {}
    for plan in (_es_plan(d, ws, "cpu"), plans[ws]):
        kernels.reset_launch_counts()
        img = plan.grid_uvw_es_fft(d["uvw"], d["freq"], vis, d["weight"],
                                   np.zeros_like(model))
        pred = plan.ifft_degrid_uvw_es_fft(d["uvw"], d["freq"], vis * 0,
                                           d["weight"], model)
        torch.cuda.synchronize()
        out[str(plan.device)] = (img.cpu(), pred.cpu(),
                                 kernels.launch_counts())
    (i0, p0, c0), (i1, p1, c1) = out["cpu"], out[str(dev)]
    assert set(c0.values()) == {0}
    names = {"grid_packed", "degrid_fused"}
    assert all(c1[n] >= 1 for n in names)
    assert all(v == 0 for n, v in c1.items() if n not in names)
    assert _rel(i1, i0) <= 1e-5
    assert _rel(p1, p0) <= 1e-5


def test_band_kernels_bf16_match_plain(es):
    """K8 and K11 in their bf16 mode (a bf16 ``vk``) against their plain
    versions on the ES-FFT 3-D plan."""
    ep = es[1][True]._packed
    dd = ep.dev
    dev = dd["uk"].device
    gen = torch.Generator(device=dev).manual_seed(6)
    vk = dd["vk"].to(torch.bfloat16)
    vre, vim = (torch.randn(ep.total, generator=gen, device=dev)
                * dd["valid"] for _ in range(2))
    args = (dd["block_bucket"], dd["u_off"], dd["iv0"], dd["uk"], vk,
            (dd["kw_t"], vre, vim), ep.num_slabs * ep.gu * ep.gv, 256,
            ep.w_support)
    got = tb.grid_packed(*args, block_v=ep.block_v)
    torch.cuda.synchronize()
    want = tb.grid_packed_reference(*args, block_v=ep.block_v)
    assert _rel(got, want) <= 1e-5
    # Another result than f32: the mode rounds.
    assert _rel(got, tb.grid_packed(*args[:4], dd["vk"], *args[5:],
                                    block_v=ep.block_v)) > 1e-6
    planes = torch.randn((2, ep.num_w_grids, ep.rows_pad, ep.lanes_pad),
                         generator=gen, device=dev)
    args = (planes, dd["k_idx"], dd["g_idx"], dd["hv_idx"], dd["u_off"],
            dd["iv0"], dd["uk"], vk, dd["kw_t"], ep.w_support, 256)
    got = tb.degrid_fused(*args, block_v=ep.block_v, raw=True)
    torch.cuda.synchronize()
    want = tb.degrid_fused_reference(*args, block_v=ep.block_v, raw=True)
    assert _rel(got, want) <= 1e-5


# -- word-fed bucket-window kernels (K18, K19) ---------------------------------

def _window_operands(fused):
    """K18's bucket ids and K19's plane-major stack and tile indices from
    the fused kernels' operands (bucket = (task, slab, octet))."""
    f = FUSED
    octets, layers = f["lanes"] // 8, f["layers"]
    slabs = layers - f["w_support"] + 1
    t, k, g = fused["t"], fused["k"], fused["g"]
    bucket_ids = ((t * slabs + k) * octets + g).to(torch.int32)
    planes = fused["stack"].reshape(
        f["tasks"], 2, layers, f["lanes"] + 8, f["lanes"]).transpose(
            0, 1).reshape(2, f["tasks"] * layers, f["lanes"] + 8,
                          f["lanes"]).contiguous()
    return (bucket_ids, f["tasks"] * slabs * octets, planes,
            (t * layers + k).to(torch.int32), g, torch.zeros_like(g))


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_window_kernels_match_plain(fused, mode):
    """K18 and K19 against their plain versions in each mode, empty blocks
    skipped; at "highest" also against K8/K11 fed ``cheb_taps`` taps."""
    f, t = FUSED, fused
    bucket_ids, num_buckets, planes, p_idx, g_idx, hv_idx = \
        _window_operands(t)
    dims = dict(support=f["support"], w_support=f["w_support"],
                oversampling=f["oversampling"],
                w_oversampling=f["w_oversampling"], block_v=f["block_v"],
                precision=mode, nonempty=t["nonempty"])
    g_args = (bucket_ids, t["pa"], t["pb"], t["vre"], t["vim"], t["uv"],
              t["w"], num_buckets, f["lanes"])
    # K18 with its run table given in shuffled row order, then built.
    runs = _shuffled(tk.degrid_runs((bucket_ids,)))
    assert _rel(tb.grid_fused(*g_args, **dims, runs=runs),
                tb.grid_fused_reference(*g_args, **dims)) <= 1e-5
    before = kernels.launch_counts()
    got = tb.grid_fused(*g_args, **dims)
    torch.cuda.synchronize()
    assert _rel(got, tb.grid_fused_reference(*g_args, **dims)) <= 1e-5
    d_args = (planes, p_idx, g_idx, hv_idx, t["pa"], t["pb"], t["uv"],
              t["w"], f["lanes"])
    pred = tb.degrid_fused2(*d_args, **dims, raw=True)
    torch.cuda.synchronize()
    assert _rel(pred, tb.degrid_fused2_reference(*d_args, **dims,
                                                 raw=True)) <= 1e-5
    empty = torch.repeat_interleave(t["nonempty"] == 0, f["block_v"])
    assert not bool(pred[:, empty].abs().max() > 0)
    after = kernels.launch_counts()
    assert after["grid_fused"] == before["grid_fused"] + 1
    assert after["degrid_fused2"] == before["degrid_fused2"] + 1
    if mode != "highest":
        return
    occ = ~empty
    iv0, u_off, w_row, u_frac, v_frac, valid = tf.unpack_plan_words(
        t["pa"], t["pb"])
    uk = tf.cheb_taps(u_frac, t["uv"], f["oversampling"])
    vk = tf.cheb_taps(v_frac, t["uv"], f["oversampling"])
    wk_t = tf.cheb_taps(w_row, t["w"], f["w_oversampling"]).T.contiguous()
    band = tb.grid_packed(bucket_ids, u_off, iv0, uk, vk,
                          (wk_t, t["vre"] * occ, t["vim"] * occ),
                          num_buckets, f["lanes"], f["w_support"],
                          block_v=f["block_v"])
    assert _rel(got, band) <= 1e-5
    band = tb.degrid_fused(planes, p_idx, g_idx, hv_idx, u_off, iv0, uk, vk,
                           (wk_t * valid * occ).contiguous(), f["w_support"],
                           f["lanes"], block_v=f["block_v"], raw=True)
    assert _rel(pred, band) <= 1e-5


# -- window-scatter grid kernels (K3, K12, K8, K18) ----------------------------

# (form, S, Sw, width, block_v, order): Sw 1, 4 and 8 at 128 and 256
# lanes (8 x 256: the ES-FFT window, two groups of 4 w-planes; 8 x 128: 8
# w-planes, two a consumer warp), widths past the column-tile limit (3072,
# 4096: one w-plane a group in column tiles), block_v not a multiple of
# the 128-slot tile, runs of one and of 8-12 blocks, shuffled (a bucket
# over non-adjacent runs), one bucket.
SCATTER_GEOMS = [
    ("stack_words", 8, 4, 128, 1024, "long"),
    ("stack_words", 8, 4, 128, 96, "ones"),
    ("stack_words", 3, 2, 256, 200, "shuffled"),
    ("stack_words", 1, 1, 64, 128, "single"),
    ("stack_taps", 8, 4, 128, 512, "long"),
    ("stack_taps", 2, 4, 256, 96, "shuffled"),
    ("band_taps", 8, 8, 256, 128, "long"),
    ("band_taps", 8, 8, 128, 128, "shuffled"),
    ("band_taps", 8, 4, 128, 1024, "long"),
    ("band_taps", 4, 1, 128, 72, "ones"),
    ("band_taps", 8, 1, 256, 128, "shuffled"),
    ("band_taps", 7, 6, 384, 200, "shuffled"),
    ("band_taps", 8, 8, 256, 128, "single"),
    ("band_taps", 8, 2, 3072, 128, "long"),
    ("band_taps", 5, 1, 4096, 64, "shuffled"),
    ("band_words", 8, 4, 128, 1024, "long"),
    ("band_words", 6, 3, 256, 96, "shuffled"),
    ("band_words", 2, 1, 128, 64, "ones"),
]
SCATTER_BUCKETS = 24


def _scatter_operands(device, form, support, w_support, width, block_v,
                      order, seed=0):
    """Random operands of one window-scatter wrapper: (function, plain
    version, arguments, keywords, block keys). Stack forms: 3 tasks of
    Sw + 3 layers; band forms: SCATTER_BUCKETS buckets. Slots at every
    lane of the window, some past its right edge (dropped), a tenth
    invalid (zero visibility or w taps), two blocks of zero visibilities;
    the word forms with a fifth of the blocks empty; the band form's scale
    stack for shuffled blocks, its split form otherwise."""
    rng = np.random.default_rng(seed)
    stack_form = form.startswith("stack")
    if stack_form:
        tasks, layers = 3, w_support + 3
        keyspace = [(t, k, g) for t in range(tasks)
                    for k in range(layers - w_support + 1)
                    for g in range(width // 8)]
    else:
        keyspace = [(b,) for b in range(SCATTER_BUCKETS)]
    kidx = _gather_keys(rng, order, len(keyspace))
    key = np.asarray([keyspace[i] for i in kidx], np.int32)
    nb = key.shape[0]
    total = nb * block_v
    as_dev = (lambda a, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(a), dtype=dt, device=device))
    iv0 = rng.integers(0, width, total)
    iv0[::7] = width - 1 - rng.integers(0, support, total)[::7]
    u_off = rng.integers(0, min(8, 16 - support) + 1, total)
    valid = rng.random(total) >= 0.1
    vre, vim = (rng.standard_normal(total) * valid for _ in range(2))
    for b in rng.choice(nb, size=2, replace=False):
        vre[b * block_v:(b + 1) * block_v] = 0.0
        vim[b * block_v:(b + 1) * block_v] = 0.0
    idx = tuple(as_dev(key[:, i], torch.int32) for i in range(key.shape[1]))
    vis = (as_dev(vre), as_dev(vim))
    dims = dict(block_v=block_v)
    if form.endswith("words"):
        u_off = np.minimum(u_off, 7)
        pa, pb = tf.pack_plan_words(
            np.minimum(iv0, 2047), u_off, rng.integers(0, GATHER_WOV, total),
            rng.integers(0, GATHER_OV, total),
            rng.integers(0, GATHER_OV, total), valid)
        nonempty = (rng.random(nb) >= 0.2).astype(np.int32)
        coeffs = (as_dev(rng.standard_normal((GATHER_NCOEF, support)) * 0.3),
                  as_dev(rng.standard_normal((GATHER_NCOEF, w_support))
                         * 0.3))
        dims.update(support=support, w_support=w_support,
                    oversampling=GATHER_OV, w_oversampling=GATHER_WOV,
                    nonempty=as_dev(nonempty, torch.int32))
        words = (as_dev(pa, torch.int32), as_dev(pb, torch.int32))
        if stack_form:
            return (tf.grid_fused_stack, tf.grid_fused_stack_reference,
                    (*idx, *words, *vis, *coeffs, tasks, layers, width),
                    dims, idx)
        return (tb.grid_fused, tb.grid_fused_reference,
                (*idx, *words, *vis, *coeffs, SCATTER_BUCKETS, width), dims,
                idx)
    uk = rng.standard_normal((total, support))
    vk = rng.standard_normal((total, support))
    wk_t = rng.uniform(0.1, 1, (w_support, total)) * valid
    if stack_form:
        pa, _ = tf.pack_plan_words(iv0, u_off, 0, 0, 0, 1)
        return (tf.grid_compact, tf.grid_compact_reference,
                (*idx, as_dev(pa, torch.int32), as_dev(uk.T), as_dev(vk.T),
                 as_dev(wk_t), *vis, tasks, layers, width, support,
                 w_support), dims, idx)
    if order == "shuffled":
        scales = as_dev(np.concatenate([wk_t * vre, wk_t * vim]))
    else:
        scales = (as_dev(wk_t), *vis)
    return (tb.grid_packed, tb.grid_packed_reference,
            (*idx, as_dev(u_off, torch.int32), as_dev(iv0, torch.int32),
             as_dev(uk), as_dev(vk), scales, SCATTER_BUCKETS, width,
             w_support), dims, idx)


SCATTER_CASES = [(g, m) for g in SCATTER_GEOMS for m in _gather_modes(g[0])]


@pytest.mark.parametrize("geom,mode", SCATTER_CASES, ids=[
    "-".join(map(str, g)) + f"-{m}" for g, m in SCATTER_CASES])
def test_window_scatter_kernels_match_plain(device, geom, mode):
    """K3 (``stack_words``), K12 (``stack_taps``), K8 (``band_taps``, f32
    and bf16 ``vk``) and K18 (``band_words``) against their plain versions
    at 1e-5 of max|output| in every mode (the bf16 modes round the same
    factors as their plain versions), with the run table built by the
    wrapper, of maximal runs, in the kernels' parts, in shuffled row order,
    and of one block a row (a window added by several CTAs); one launch a
    call, no host sync; buckets no block visits stay exactly zero."""
    form, support, w_support, width, block_v, order = geom
    fn, ref, args, kw, keys = _scatter_operands(
        device, form, support, w_support, width, block_v, order)
    if form == "band_taps" and mode == "bf16":
        args = (*args[:4], args[4].to(torch.bfloat16), *args[5:])
    elif form != "band_taps":
        kw = dict(kw, precision=mode)
    want = ref(*args, **kw)
    assert want.abs().max() > 0
    parts = tk.degrid_runs(keys)
    perm = torch.randperm(parts.shape[0], generator=torch.Generator(
        ).manual_seed(1)).to(parts.device)
    tables = [None, tk.run_table(keys), parts, parts[perm].contiguous(),
              tk.run_table(keys, 1)]
    if order == "long":
        assert int(tables[1][:, 1].max()) >= 8
    for runs in tables:
        before = fn.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(*args, **kw, runs=runs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-5
        if not form.startswith("stack"):
            unvisited = torch.ones(SCATTER_BUCKETS, dtype=torch.bool,
                                   device=got.device)
            unvisited[keys[0].long()] = False
            assert not bool(got[:, unvisited].abs().max() > 0)


def test_scatter_layout_matches_kernel(device):
    """packed_tap.scatter_layout, the Python mirror, gives the layout the
    kernel's own plan_layout gives, over Sw 1-8 and lanes 8-4096."""
    import ctypes

    from ska_sdp_func_torch.kernels import _build

    lib = _build.load()
    buf = (ctypes.c_int64 * 8)()
    for w_support in range(1, 9):
        for lanes in range(8, 4097, 8):
            assert lib.sdp_torch_scatter_layout(
                w_support, lanes, ctypes.addressof(buf)) == 0
            lay = tk.scatter_layout(w_support, lanes)
            assert list(buf) == [lay[k] for k in (
                "stride", "lpad", "w_planes", "plane_groups", "tile_w",
                "tiles", "smem", "fixed")], (w_support, lanes)


def _ingest_images(device, kind):
    """The ingest ``kind`` on ``device``: its dirty image, the kernels it
    launched, and the plan's taper."""
    from ska_sdp_func_torch.parallel import packed_gridder

    uvw, vis = make_inputs()
    params = {**PARAMS, "oversampling": 65536} if kind.startswith("np") \
        else PARAMS
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **params)
    kernels.reset_launch_counts()
    if kind in ("fused", "compact"):
        g = packed_gridder(plan_packed(plan, uvw, block_v=128), engine=kind,
                           precision="highest", device=device)
        img = g.grid(vis)
    else:
        rows = uvw.shape[0]
        sp = plan_stream(plan, stream_tasks(plan, uvw), chunk_rows=rows,
                         block_v=128, cap_slots=40960)
        sg = StreamingGridder(sp, fast=kind == "np fast", device=device)
        sg.accumulate(uvw, vis)
        sg.accumulate(uvw[: rows // 2], vis[: rows // 2])
        img = sg.finalize()
    torch.cuda.synchronize()
    k = plan.kernel()
    taper = 1.0 / grid_correct_pswf(
        k.image_size, k.theta, k.w_step, k.shear_u, k.shear_v, k.support,
        k.w_support, torch.ones(k.image_size, k.image_size))
    return img.cpu(), kernels.launch_counts(), taper


@pytest.mark.parametrize("kind", ["stream", "np", "np fast", "fused",
                                  "compact"])
def test_ingests_on_card_match_cpu_image(device, kind):
    """The ingests that grid through the window-scatter kernels (the
    packable stream, K3; the non-packable one in f32 and fast, K8; the
    packed fused and compact engines, K3 and K12), each bucket over
    several blocks, return the CPU port's image (the plain versions) at
    1e-5 taper-weighted."""
    grid = {"stream": "grid_fused_stack", "np": "grid_packed",
            "np fast": "grid_packed", "fused": "grid_fused_stack",
            "compact": "grid_compact"}[kind]
    i0, c0, taper = _ingest_images("cpu", kind)
    i1, c1, _ = _ingest_images(device, kind)
    assert set(c0.values()) == {0} and c1[grid] >= 1
    assert _rel(i1 * taper, i0 * taper) <= 1e-5


def test_planners_take_uvw_on_card(device):
    """A uvw tensor on the card plans as its NumPy copy does: plan_wstack,
    plan_packed, stream_tasks, the whole-image driver's packed engine and
    the solver copy it to the host in f64."""
    from ska_sdp_func_torch.grid_data import wstack_wtower_grid_all
    from ska_sdp_func_torch.pipeline import major_cycle_imager

    uvw, vis = make_inputs()
    uvw_d = torch.as_tensor(uvw, device=device)
    plan = plan_wstack(uvw_d, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    ref = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    assert plan.tasks == ref.tasks
    assert plan_packed(plan, uvw_d).digest == plan_packed(ref, uvw).digest
    np.testing.assert_array_equal(stream_tasks(plan, uvw_d),
                                  stream_tasks(ref, uvw))
    img = torch.zeros((IMAGE_SIZE, IMAGE_SIZE), device=device)
    a, b = (wstack_wtower_grid_all(
        torch.as_tensor(vis, device=device), FREQ0, DFREQ, u, **PARAMS,
        image=img, engine="packed", device=device) for u in (uvw_d, uvw))
    # f32 atomics reorder the sums: compare taper-weighted.
    k = plan.kernel()
    taper = 1.0 / grid_correct_pswf(
        k.image_size, k.theta, k.w_step, k.shear_u, k.shear_v, k.support,
        k.w_support, torch.ones(k.image_size, k.image_size, device=device))
    assert _rel(a * taper, b * taper) <= 1e-5
    res = major_cycle_imager(plan, vis, uvw_d, n_major=1, bucketed=True,
                             device=device)
    assert res.model.shape == (IMAGE_SIZE, IMAGE_SIZE)
    assert bool(torch.isfinite(res.model).all())


# -- the sparse all-layer grid (K20) and the bf16 mode of K14-K17 ------------

def _sparse_operands(f, num_layers, seed=3):
    """K20's operands from the dense flat taps of ``_tower_operands``:
    each visibility's first active layer and its Sw weights (zero rows
    keep a random first layer)."""
    w = f["weights"]
    active = w != 0
    k0 = torch.where(active.any(dim=1), active.int().argmax(dim=1),
                     torch.randint(-2, num_layers + 2, (w.shape[0],),
                                   generator=torch.Generator().manual_seed(
                                       seed)).to(w.device))
    idx = k0.clamp(0, num_layers - 4)[:, None] + torch.arange(
        4, device=w.device)
    return k0.to(torch.int32).contiguous(), w.gather(1, idx).contiguous()


@pytest.mark.parametrize("size", [32, 64, 128, 256])
def test_sparse_grid_kernel_matches_plain_and_dense(device, size):
    from ska_sdp_func_torch.kernels import sparse_tap as ts

    f, *_ = _tower_operands(device, size, seed=4)
    k = f["weights"].shape[1]
    k0, wk = _sparse_operands(f, k)
    for fast in (False, True):
        args = (f["vre"], f["vim"], f["iu0"], f["iv0"], k0, f["uk"],
                f["vk"], wk, k, size, 8, 4)
        before = ts.launch_counts()["grid_all_layers_sparse"]
        got = ts.grid_all_layers_sparse(*args, fast=fast)
        want = ts.grid_all_layers_sparse_reference(*args, fast=fast)
        dense = tt.grid_all_layers(f["vre"], f["vim"], f["iu0"], f["iv0"],
                                   f["uk"], f["vk"], f["weights"], k, size,
                                   8, fast=fast)
        torch.cuda.synchronize()
        assert ts.launch_counts()["grid_all_layers_sparse"] == before + 1
        assert _rel(got, want) <= 1e-5
        assert _rel(got, dense) <= 1e-5


# (case, layers, w_support): Sw = K; one 512-slot block with every w tap 0
# (first layers anywhere); taps off every edge of the sub-grid.
SPARSE_CASES = [("window", 7, 4), ("Sw = K", 4, 4), ("zero block", 9, 4),
                ("edges", 6, 3)]


def _sparse_case(device, seed, total, support, num_layers, w_support,
                 size, edges=False, zero_block=False):
    """K20's operands: ``total`` random slots (rows and columns off every
    edge where ``edges``), a tenth of their w taps 0, first layers a few
    past either end of the window's range (``zero_block``: slots 512-1023
    with every w tap 0 and first layers anywhere)."""
    rng = np.random.default_rng(seed)
    lo, hi = (-support + 1, size) if edges else (0, max(size - support, 0) + 1)

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    k0 = rng.integers(-2, num_layers - w_support + 3, total)
    wk = rng.uniform(0.1, 1, (total, w_support))
    wk[rng.random(total) < 0.1] = 0.0
    if zero_block:
        wk[512:1024] = 0.0
        k0[512:1024] = rng.integers(-40, 40, 512)
    return (put(rng.standard_normal(total), torch.float32),
            put(rng.standard_normal(total), torch.float32),
            put(rng.integers(lo, hi, total), torch.int32),
            put(rng.integers(lo, hi, total), torch.int32),
            put(k0, torch.int32),
            put(rng.standard_normal((total, support)), torch.float32),
            put(rng.standard_normal((total, support)), torch.float32),
            put(wk, torch.float32), num_layers, size, support, w_support)


def _check_sparse_kernel(args, fast):
    """K20 at 1e-5 of max against its plain version and against K16 on
    ``_slab_weights`` of the same taps; one launch and one device
    operation a call (no zero fill, no interleave pass), two calls
    bit-equal."""
    from ska_sdp_func_torch.kernels import sparse_tap as ts

    num_layers, size, support, w_support = args[8:]
    before = ts.launch_counts()["grid_all_layers_sparse"]
    got = ts.grid_all_layers_sparse(*args, fast=fast)
    again = ts.grid_all_layers_sparse(*args, fast=fast)
    want = ts.grid_all_layers_sparse_reference(*args, fast=fast)
    keep = args[7].ne(0).any(dim=1)
    first = args[4].clamp(0, num_layers - w_support)
    dense = tt.grid_all_layers(*args[:4], *args[5:7], tw._slab_weights(
        args[7], first, keep, num_layers), num_layers, size, support,
        fast=fast)
    torch.cuda.synchronize()
    assert ts.launch_counts()["grid_all_layers_sparse"] == before + 2
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == (num_layers, size, size)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(again))
    assert _rel(got, want) <= 1e-5
    assert _rel(got, dense) <= 1e-5
    _, ops, names = device_ms(lambda: ts.grid_all_layers_sparse(
        *args, fast=fast), iters=5)
    assert 0 < ops <= 1
    assert all("sparse_grid_kernel" in n for n in names)


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("size", [32, 64, 128, 256])
@pytest.mark.parametrize("case,num_layers,w_support", SPARSE_CASES,
                         ids=[c[0].replace(" ", "") for c in SPARSE_CASES])
def test_sparse_grid_kernel_cases(device, case, num_layers, w_support,
                                  size, fast):
    """K20 on the cases above at N 32-256 (:func:`_check_sparse_kernel`)."""
    _check_sparse_kernel(_sparse_case(
        device, size + num_layers, 3000, 8, num_layers, w_support, size,
        edges=case == "edges", zero_block=case == "zero block"), fast)


# (case, support, w_support, layers, size): two passes over the S x Sw
# pairs; K past 255; planes wider than one CTA's tile (column tiles); an
# odd N with S x Sw = 25; the smallest shape.
SPARSE_RANGE = [("S 16", 16, 3, 5, 64), ("K 300", 6, 2, 300, 32),
                ("N 1024", 8, 4, 9, 1024), ("N 63", 5, 5, 5, 63),
                ("N 2", 1, 1, 2, 2)]


@pytest.mark.parametrize("fast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case,support,w_support,num_layers,size",
                         SPARSE_RANGE,
                         ids=[c[0].replace(" ", "") for c in SPARSE_RANGE])
def test_sparse_grid_kernel_range(device, case, support, w_support,
                                  num_layers, size, fast):
    """K20 across its range of shapes (:func:`_check_sparse_kernel`), and
    a call with no slots writes zeros."""
    from ska_sdp_func_torch.kernels import sparse_tap as ts

    args = _sparse_case(device, size + num_layers, 3000, support,
                        num_layers, w_support, size, edges=True)
    _check_sparse_kernel(args, fast)
    none = tuple(a[:0] if torch.is_tensor(a) else a for a in args)
    got = ts.grid_all_layers_sparse(*none, fast=fast)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (num_layers, size, size)
    assert not bool(got.abs().max() > 0)


@pytest.mark.parametrize("size", [32, 64, 128, 256])
def test_tower_kernels_bf16_match_plain(device, size):
    """K14-K17 with ``fast=True`` against their bf16 plain versions at
    1e-5, and against their f32 kernels within 4e-3 (not equal)."""
    f, tables, geom, vis, sub = _tower_operands(device, size, seed=5)
    k = f["weights"].shape[1]
    calls = {
        "grid_all_layers": ((f["vre"], f["vim"], f["iu0"], f["iv0"],
                             f["uk"], f["vk"], f["weights"], k, size, 8),
                            None),
        "degrid_all_layers": ((f["layers"], f["iu0"], f["iv0"], f["uk"],
                               f["vk"], f["weights"], 8), None),
        "grid_plane": ((sub, vis, *tables, geom, 8, 4), sub),
        "degrid_plane": ((sub, *tables, geom, 8, 4), None),
    }
    for name, (args, base) in calls.items():
        kern = getattr(tt, name)
        got = kern(*args, fast=True)
        want = getattr(tt, name + "_reference")(*args, fast=True)
        f32 = kern(*args)
        torch.cuda.synchronize()
        if base is not None:
            got, want, f32 = got - base, want - base, f32 - base
        assert _rel(got, want) <= 1e-5, name
        assert 0 < _rel(got, f32) <= 4e-3, name


def _point_and_blob():
    x = np.arange(IMAGE_SIZE) - IMAGE_SIZE // 2
    img = np.exp(-((x[:, None] + 20) ** 2 + (x[None, :] - 15) ** 2) / 18.0)
    img = (0.5 * img).astype(np.float32)
    img[IMAGE_SIZE // 2 + 12, IMAGE_SIZE // 2 - 9] = 1.0
    return img


@pytest.fixture(scope="module")
def solver_scene(device):
    uvw, _ = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    vis = PackedGridder(plan_packed(plan, uvw), device="cpu").degrid(
        _point_and_blob()).numpy()
    return plan, uvw, vis


def test_msclean_solve_on_card_matches_cpu(solver_scene, device):
    from ska_sdp_func_torch.pipeline import major_cycle_imager

    plan, uvw, vis = solver_scene
    kw = dict(n_major=2, bucketed=True, cycle_limit=100,
              clean_algorithm="msclean", scale_list=(0, 4, 8))
    kernels.reset_launch_counts()
    card = major_cycle_imager(plan, vis, uvw, device=device, **kw)
    counts = kernels.launch_counts()
    cpu = major_cycle_imager(plan, vis, uvw, device="cpu", **kw)
    assert counts["grid_packed_stack"] > 0 and counts["degrid_stack"] > 0
    assert _rel(card.model.cpu(), cpu.model) <= 1e-4
    np.testing.assert_allclose(card.peak_history, cpu.peak_history,
                               rtol=1e-4)


def test_fista_solve_on_card_matches_cpu(solver_scene, device):
    from ska_sdp_func_torch.pipeline import fista_imager

    plan, uvw, vis = solver_scene
    card = fista_imager(plan, vis, uvw, n_iter=6, device=device)
    cpu = fista_imager(plan, vis, uvw, n_iter=6, device="cpu")
    assert card.model.device.type == "cuda"
    assert _rel(card.model.cpu(), cpu.model) <= 1e-4
    # The norms of V - A y, against the data norm (the first entry): the
    # error of the difference scales with V, not with the shrinking norm.
    np.testing.assert_allclose(card.residual_norm, cpu.residual_norm,
                               rtol=0, atol=1e-4 * cpu.residual_norm[0])


# -- the experiments' A/B kernels (P1, P2) -----------------------------------

def test_read_probe_kernel_matches_plain(device):
    """bench.py's read probe: the column sums of every row block over the
    streams at 1e-5 (f32 sum order), the TPU layout sliced from them."""
    from ska_sdp_func_torch.kernels import read_probe as rp

    rng = np.random.default_rng(1)
    for n, shape, br, bc in ((6, (64, 2048), 16, 512), (1, (512, 1024), 512,
                                                        1024)):
        xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                              device=device) for _ in range(n)]
        before = rp.read_streams.launches
        out, sums = rp.read_streams(xs, 1.25, br, bc)
        want_out, want_sums = rp.read_streams_reference(xs, 1.25, br, bc)
        torch.cuda.synchronize()
        assert rp.read_streams.launches == before + 1
        assert out.shape == (8 * shape[0] // br, 128 * shape[1] // bc)
        assert _rel(sums, want_sums) <= 1e-5
        assert _rel(out, want_out) <= 1e-5


def _prep_fields(device, cap, seed):
    from ska_sdp_func_torch.grid_data.wtower import _tap_coeffs_cached

    rng = np.random.default_rng(seed)
    ints = lambda hi: torch.as_tensor(  # noqa: E731
        rng.integers(0, hi, cap).astype(np.int32), device=device)
    f32 = lambda: torch.as_tensor(  # noqa: E731
        rng.standard_normal(cap).astype(np.float32), device=device)
    coeffs = [torch.as_tensor(np.asarray(_tap_coeffs_cached(s, 16384),
                                         np.float32), device=device)
              for s in (8, 4)]
    return (ints(9), ints(16384), ints(16384), f32(), f32(), ints(124),
            ints(16384), *coeffs, 16384, 16384)


def test_prep_variant_kernel_matches_plain(device):
    """exp_prep's five modes, bit for bit: the taps round op by op in K6's
    order; the zero outputs and placements are copies. A ragged cap, u_off
    up to 8 and iv0 up to 123 (taps past the band dropped)."""
    from ska_sdp_func_torch.kernels import prep_variants as pv

    args = _prep_fields(device, 2 * 1024 + 77, seed=3)
    for mode in pv.MODES:
        before = pv.prep_variant.launches
        got = pv.prep_variant(mode, *args)
        want = pv.prep_variant_reference(mode, *args)
        torch.cuda.synchronize()
        assert pv.prep_variant.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), mode


def _dot_operands(device, block_v, nb, per_bucket, seed):
    rng = np.random.default_rng(seed)
    total = block_v * nb
    put = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device=device)
    ubase = put(rng.standard_normal((16, total)))
    vband = put(rng.standard_normal((total, 128)))
    scales = put(rng.standard_normal((8, total)))
    ids = torch.as_tensor(np.arange(nb) // per_bucket, dtype=torch.int32,
                          device=device)
    uall = (ubase[None] * scales[:, None]).reshape(128, total)
    return ids, ubase, vband, scales, uall


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", ["prod", "prod_simt", "lhs_stream",
                                  "ksplit2", "ksplit4", "npair", "nodot"])
def test_bucket_dot_kernel_matches_plain(device, form, bf16):
    """exp_dot's forms on the tensor cores (three TF32 products for f32,
    bf16 with f32 sums) and the CUDA cores at 1e-5 of max|plain| (f32 sum
    order; the TF32 hi/lo split keeps ~2^-22 of each product)."""
    from ska_sdp_func_torch.kernels import bucket_dot as bd

    if bf16 and form in ("prod_simt", "nodot"):
        pytest.skip(f"{form} has no bf16 mode")
    for block_v, nb, per in ((128, 8, 2), (256, 10, 5)):
        ids, ubase, vband, scales, uall = _dot_operands(device, block_v, nb,
                                                        per, seed=block_v)
        if bf16:
            vband, uall = vband.bfloat16(), uall.bfloat16()
        ins = (uall, vband) if form == "lhs_stream" else (ubase, vband,
                                                          scales)
        before = bd.bucket_dot.launches
        got = bd.bucket_dot(form, ids, ins, nb // per, block_v)
        want = bd.bucket_dot_reference(form, ids, ins, nb // per, block_v)
        torch.cuda.synchronize()
        assert bd.bucket_dot.launches == before + 1
        assert _rel(got, want) <= 1e-5, (form, block_v)


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_grid_parity_kernel_matches_plain(device, slots):
    """exp_parity's split accumulators at 1e-5 of max|plain|; buckets no
    block visits stay zero."""
    from ska_sdp_func_torch.kernels import bucket_dot as bd

    _, ubase, vband, scales, _ = _dot_operands(device, 256, 9, 1, seed=7)
    ids = torch.tensor([0, 0, 0, 2, 2, 5, 5, 5, 5], dtype=torch.int32,
                       device=device)
    args = (ids, ubase, vband, scales, 7, 128, 4, 256, slots)
    before = bd.grid_parity.launches
    got = bd.grid_parity(*args)
    want = bd.grid_parity_reference(*args)
    torch.cuda.synchronize()
    assert bd.grid_parity.launches == before + 1
    assert _rel(got, want) <= 1e-5
    assert not got[:, [1, 3, 4, 6]].any()


# Runs of 3, 1, 9 and 2 blocks; buckets 1, 4 and 6 unvisited; 15 blocks
# (npair takes 14, its pairs keyed by the even block's bucket). At
# block_v 1024 the 9-block run is 144 stages of 64 slots, longer than the
# ring; at 128 a 1-block run is 2 stages, fewer than the ring holds.
DOT_IDS = (0, 0, 0, 2, 3, 3, 3, 3, 3, 3, 3, 3, 3, 5, 5)
DOT_BUCKETS = 7
DOT_FORMS = [(form, bf16) for form in ("prod", "lhs_stream", "ksplit2",
                                       "ksplit4", "npair")
             for bf16 in (False, True)]


def _ragged_dot(device, block_v, seed):
    _, ubase, vband, scales, uall = _dot_operands(device, block_v,
                                                  len(DOT_IDS), 1, seed)
    ids = torch.tensor(DOT_IDS, dtype=torch.int32, device=device)
    return ids, ubase, vband, scales, uall


@pytest.mark.parametrize("block_v", [128, 256, 1024])
@pytest.mark.parametrize("form,bf16", DOT_FORMS, ids=[
    f"{f}-{'bf16' if b else 'f32'}" for f, b in DOT_FORMS])
def test_bucket_dot_tensor_cores_over_ragged_runs(device, form, bf16,
                                                  block_v):
    """Every tensor-core form over ragged runs at 1e-5 of max|plain| (bf16
    against the bf16 plain version); buckets no block visits stay zero;
    a table built once (as the experiment drivers build it) and the
    wrapper's own give the same bits (stores in a fixed order, no
    atomics); one launch a call."""
    from ska_sdp_func_torch.kernels import bucket_dot as bd

    ids, ubase, vband, scales, uall = _ragged_dot(device, block_v, block_v)
    if bf16:
        vband, uall = vband.bfloat16(), uall.bfloat16()
    ins = (uall, vband) if form == "lhs_stream" else (ubase, vband, scales)
    runs = bd.dot_runs(ids, pair=form == "npair")
    before = bd.bucket_dot.launches
    got = bd.bucket_dot(form, ids, ins, DOT_BUCKETS, block_v, runs=runs)
    again = bd.bucket_dot(form, ids, ins, DOT_BUCKETS, block_v)
    want = bd.bucket_dot_reference(form, ids, ins, DOT_BUCKETS, block_v)
    torch.cuda.synchronize()
    assert bd.bucket_dot.launches == before + 2
    assert _rel(got, want) <= 1e-5, (form, bf16, block_v)
    assert torch.equal(got, again)
    keys = DOT_IDS[:len(DOT_IDS) // 2 * 2:2] if form == "npair" else DOT_IDS
    unvisited = sorted(set(range(DOT_BUCKETS)) - set(keys))
    assert not got.view(DOT_BUCKETS, 128, -1)[unvisited].any()


@pytest.mark.parametrize("block_v", [128, 256, 1024])
@pytest.mark.parametrize("slots", [1, 2, 4])
def test_grid_parity_over_ragged_runs(device, slots, block_v):
    """exp_parity's split accumulators over ragged runs at 1e-5 of
    max|plain|; at slots 4 the 1-block run's blocks fall in its last pass
    only (the earlier passes hold no block), which adds to the zeroed
    output; unvisited buckets stay zero."""
    from ska_sdp_func_torch.kernels import bucket_dot as bd

    ids, ubase, vband, scales, _ = _ragged_dot(device, block_v, 7 + slots)
    args = (ids, ubase, vband, scales, DOT_BUCKETS, 128, 4, block_v, slots)
    before = bd.grid_parity.launches
    got = bd.grid_parity(*args, runs=bd.dot_runs(ids))
    want = bd.grid_parity_reference(*args)
    torch.cuda.synchronize()
    assert bd.grid_parity.launches == before + 1
    assert _rel(got, want) <= 1e-5
    assert not got[:, [1, 4, 6]].any()


@pytest.mark.parametrize("n,shape,br,bc", [
    (1, (312, 1024), 104, 1024),     # 64-row steps and a part step
    (1, (48, 512), 24, 256),         # no whole step
    (2, (120, 512), 40, 512),
    (3, (80, 256), 40, 128),
    (6, (64, 2048), 16, 512)])
def test_read_probe_row_steps_match_plain(device, n, shape, br, bc):
    """The read probe's row steps (4 rows a thread at one stream, 2 at two
    or three, 1 from four up) with row blocks that are no multiple of a
    step: the sums at 1e-5 of max|plain|, one launch."""
    from ska_sdp_func_torch.kernels import read_probe as rp

    rng = np.random.default_rng(n)
    xs = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                          device=device) for _ in range(n)]
    before = rp.read_streams.launches
    out, sums = rp.read_streams(xs, 1.5, br, bc)
    want_out, want_sums = rp.read_streams_reference(xs, 1.5, br, bc)
    torch.cuda.synchronize()
    assert rp.read_streams.launches == before + 1
    assert _rel(sums, want_sums) <= 1e-5
    assert _rel(out, want_out) <= 1e-5


@pytest.mark.parametrize("variant", ["dot", "vpu", "both", "both2"])
def test_overlap_kernel_matches_plain(device, variant):
    """exp_overlap's variants: the last block's acc and every block's
    sum |acc| at 1e-5 of max|plain| (vpu's f32 sums are bit-equal)."""
    from ska_sdp_func_torch.kernels import overlap as ov

    rng = np.random.default_rng(0)
    pa, pb = (torch.as_tensor(rng.integers(0, 2 ** 22, 4 * 1024, np.int32),
                              device=device) for _ in range(2))
    c = torch.as_tensor(rng.standard_normal((12, 8)), dtype=torch.float32,
                        device=device)
    before = ov.overlap.launches
    out, sums = ov.overlap(variant, pa, pb, c)
    want_out, want_sums = ov.overlap_reference(variant, pa, pb, c, 1024, 512)
    torch.cuda.synchronize()
    assert ov.overlap.launches == before + 1
    assert sums.shape == (4,)
    assert _rel(out, want_out) <= 1e-5
    assert _rel(sums, want_sums) <= 1e-5


# Redesigned P2b (one CTA an SM over the blocks, 64-slot stages, or 32
# where a block is no multiple of 64; wgmma TF32 x 3): every variant over
# grids that leave the last wave of blocks part full on a 132-SM card (1,
# 131, 133 and 529 blocks), blocks of 32 slots (a chunk a stage), 96 (three
# 32-slot stages, three chunks), 128 (two chunks a 64-slot stage) and 2048,
# and fits of 2, 12 and 16 coefficients: (num_blocks, block, sub, ncoef).
OVERLAP_CASES = [
    (1, 1024, 512, 12), (131, 1024, 512, 12), (133, 1024, 512, 12),
    (529, 1024, 512, 12), (133, 32, 32, 12), (131, 32, 32, 16),
    (133, 96, 32, 2), (133, 128, 32, 12), (133, 2048, 512, 2),
    (7, 2048, 512, 16), (133, 1024, 512, 16)]


@pytest.mark.parametrize("case", OVERLAP_CASES, ids=str)
@pytest.mark.parametrize("variant", ["dot", "vpu", "both", "both2"])
def test_overlap_kernel_over_grids(device, variant, case):
    """The last block's acc and every block's sum |acc| at 1e-5 of
    max|plain|, one launch a call; vpu's acc (f32 products and adds in the
    plain version's order) bit for bit."""
    from ska_sdp_func_torch.kernels import overlap as ov

    num_blocks, block, sub, ncoef = case
    rng = np.random.default_rng(num_blocks + block + ncoef)
    pa, pb = (torch.as_tensor(
        rng.integers(0, 2 ** 22, num_blocks * block, np.int32),
        device=device) for _ in range(2))
    c = torch.as_tensor(rng.standard_normal((ncoef, 8)), dtype=torch.float32,
                        device=device)
    before = ov.overlap.launches
    out, sums = ov.overlap(variant, pa, pb, c, block, sub)
    want_out, want_sums = ov.overlap_reference(variant, pa, pb, c, block,
                                               sub)
    torch.cuda.synchronize()
    assert ov.overlap.launches == before + 1
    assert sums.shape == (num_blocks,)
    assert _rel(out, want_out) <= 1e-5
    assert _rel(sums, want_sums) <= 1e-5
    assert float((sums - want_sums).abs().div(want_sums).max()) <= 1e-5
    if variant == "vpu":
        assert torch.equal(out, want_out)


# Redesigned K9/K10 (a CTA an (octet, layer, task), its flags read once,
# float4 rows where L % 4 == 0 and single lanes elsewhere): bit for bit
# against the plain version with NaN in every unvisited window, at L 1, 3,
# 60, 64, 128 and 130, Sw 1-8, one slab, one octet, and none, some and all
# buckets visited: (tasks, slabs, octets, w_support, lanes, visited share).
FOLD_CASES = [
    (3, 8, 16, 4, 128, 0.2), (2, 3, 4, 2, 1, 0.5), (2, 3, 4, 3, 3, 0.5),
    (3, 5, 6, 5, 60, 0.5), (2, 4, 5, 6, 64, 0.5), (2, 2, 3, 8, 130, 0.5),
    (4, 1, 3, 4, 128, 0.5), (3, 4, 1, 4, 128, 0.5), (2, 6, 4, 1, 64, 0.5),
    (2, 3, 4, 7, 128, 0.5), (3, 8, 16, 4, 128, 0.0),
    (3, 8, 16, 4, 128, 1.0)]


def _fold_case(device, case, offset=0):
    tasks, slabs, octets, sw, lanes, share = case
    rng = np.random.default_rng(tasks + 10 * slabs + 100 * sw + lanes)
    nb = tasks * slabs * octets
    visited = rng.random(nb) < share
    wins = rng.standard_normal((2 * sw, nb, 16, lanes)).astype(np.float32)
    wins[:, ~visited] = np.nan
    # offset > 0: the windows start offset floats into their buffer.
    buf = torch.empty(wins.size + offset, dtype=torch.float32, device=device)
    w = buf[offset:].view(wins.shape)
    w.copy_(torch.as_tensor(wins))
    return (w, torch.as_tensor(visited, device=device), tasks, slabs, octets,
            sw, slabs + sw - 1)


@pytest.mark.parametrize("case", FOLD_CASES, ids=str)
def test_fold_kernel_bit_equal(device, case):
    """One launch a call, equal to the plain version bit for bit."""
    from ska_sdp_func_torch.kernels import fold

    args = _fold_case(device, case)
    before = fold.fold_windows.launches
    got = fold.fold_windows(*args)
    want = fold.fold_windows_reference(*args)
    torch.cuda.synchronize()
    assert fold.fold_windows.launches == before + 1
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [1, 2])
def test_fold_kernel_unaligned_windows(device, offset):
    """Windows that start off a 16-byte boundary take the single-lane
    path at L 128: still bit for bit."""
    from ska_sdp_func_torch.kernels import fold

    args = _fold_case(device, (3, 4, 5, 4, 128, 0.5), offset)
    assert args[0].data_ptr() % 16
    got = fold.fold_windows(*args)
    want = fold.fold_windows_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
