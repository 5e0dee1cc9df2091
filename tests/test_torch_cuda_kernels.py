"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where no CUDA device is present (decided inside
the fixture, never at import). Run on a machine with a card, where jax
is absent, with::

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

Tolerances: the grid stack at 1e-5 of max|stack| (f32 atomics reorder
the sums); degridded visibilities at 1e-5 of max|vis| (same products,
other summation order). The same holds for the w-towers tap kernels
(``tower_tap``: grid_plane, degrid_plane, grid_all_layers,
degrid_all_layers), the fused and compact kernels (``fused_tap``) and
the ES-FFT band kernels (``band_tap``: K8 and K11 in f32 and bf16, the
word-fed K18 and K19 in all three modes), the streaming tap preparation
(``stream_prep``, f32 and bf16) and the window fold (``fold``) against
their plain versions; the placement kernel (``place``) is a copy and
compares bit for bit. The sparse all-layer grid (``sparse_tap``, K20)
meets its plain version and the dense K16 on the same taps at 1e-5, in
both modes; the bf16 mode of K14-K17 meets its bf16 plain versions at
1e-5 and the f32 kernels within JAX's 4e-3 envelope. The host planners
and the solver take a uvw tensor on the card, and the msclean and FISTA
solves on the card meet the CPU port at 1e-4 of max|model|. The
experiments' kernels: the read probe (``read_probe``) and the tensor-core
band products (``bucket_dot``, three TF32 passes or bf16, and its CUDA-core
form) and overlap probe (``overlap``, every block's sum |acc| too) at
1e-5 of max|plain|; the tap-preparation sweep (``prep_variants``) bit for
bit.
"""

import numpy as np
import pytest
import torch

from _torch_scenario import C_0, DFREQ, FREQ0, FUSED, IMAGE_SIZE, \
    NUM_CHAN, PARAMS, WTOWER_PARAMS, es_scenario, fused_kernel_operands, \
    make_inputs, two_point_image, wtower_scenario
from ska_sdp_func_torch import kernels
from ska_sdp_func_torch.grid_data import GridderUvwEsFft, grid_correct_pswf
from ska_sdp_func_torch.grid_data import wtower as tw
from ska_sdp_func_torch.kernels import band_tap as tb
from ska_sdp_func_torch.kernels import fused_tap as tf
from ska_sdp_func_torch.kernels import packed_tap as tk
from ska_sdp_func_torch.kernels import place as tp
from ska_sdp_func_torch.kernels import tower_tap as tt
from ska_sdp_func_torch.parallel import PackedGridder, StreamingDegridder, \
    StreamingGridder, degrid_all_tasks, grid_all_tasks, plan_packed, \
    plan_stream, plan_wstack, stream_tasks
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
    g, pplan = s["gs"][mode], s["pplan"]
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
    g, pplan = s["gs"][mode], s["pplan"]
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
    g, pplan = s["gs"]["highest"], s["pplan"]
    with pytest.raises(SdpMemLocationError):
        tk.grid_packed_stack(g.t_idx.cpu(), g.k_idx, g.g_idx, g.ubase,
                             g.vband, (g.wk_t, s["vre"], s["vim"]),
                             len(pplan.tasks), pplan.num_layers, 128, 4,
                             block_v=pplan.block_v)


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


@pytest.mark.parametrize("bv", [64, 128, 1024])
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


@pytest.mark.parametrize("mode", ["highest", "bf16"])
def test_compact_grid_kernel_matches_plain(compact, mode):
    f, t = FUSED, compact
    args = tuple(t[k] for k in ("t", "k", "g", "pa", "uk_t", "vk_t", "wk_t",
                                "vre", "vim")) + (
        f["tasks"], f["layers"], f["lanes"], f["support"], f["w_support"])
    kw = dict(block_v=f["block_v"], precision=mode)
    before = tf.grid_compact.launches
    got = tf.grid_compact(*args, **kw)
    torch.cuda.synchronize()
    assert tf.grid_compact.launches == before + 1
    assert _rel(got, tf.grid_compact_reference(*args, **kw)) <= 1e-5


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
    before = tb.grid_packed.launches
    got = tb.grid_packed(*args, block_v=ep.block_v)
    torch.cuda.synchronize()
    assert tb.grid_packed.launches == before + 1
    assert _rel(got, tb.grid_packed_reference(*args, block_v=ep.block_v)) \
        <= 1e-5


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
    before = kernels.launch_counts()
    g_args = (bucket_ids, t["pa"], t["pb"], t["vre"], t["vim"], t["uv"],
              t["w"], num_buckets, f["lanes"])
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
