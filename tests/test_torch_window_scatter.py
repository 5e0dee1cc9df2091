"""The window-scatter grid kernels (K3, K8, K12, K18) on the CPU.

Three parts:

- the layout the kernels choose for a window (``csrc/window_scatter.cu``
  ``plan_layout``), mirrored by :func:`packed_tap.scatter_layout`: cases
  computed by hand, and over Sw 1-8 and lanes 8-4096 the invariants the
  kernel relies on (every plane and column covered, the 8-bank row stride
  with room for the 7 columns past a tile, at most 227 KiB of shared
  memory). The card tests hold the mirror against the kernel's own
  answer;
- the grid wrappers' ``runs=`` is checked (shape, dtype, device,
  contiguity) before they choose the kernel or the plain version, so a
  malformed table raises here too;
- the plain versions, which take ``runs`` and do not need it, still meet
  the interpret-mode Pallas kernels on the inputs of
  tests/test_torch_fused_tap.py (K3, K12, K18: the ``FUSED`` operands) and
  tests/test_torch_es_fft.py (K8: the 3-D ES plan's first slab), with a
  run table in shuffled row order given: 1e-5 of max|JAX output| (K18:
  over the buckets a block visits, JAX leaves the others unwritten), and
  bit for bit what they return without a table.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import FUSED, es_scenario, \
    fused_kernel_operands  # noqa: E402
from ska_sdp_func_torch.grid_data import GridderUvwEsFft  # noqa: E402
from ska_sdp_func_torch.grid_data.wtower import _tap_coeffs_cached  # noqa
from ska_sdp_func_torch.kernels import band_tap as tb  # noqa: E402
from ska_sdp_func_torch.kernels import fused_tap as tf  # noqa: E402
from ska_sdp_func_torch.kernels import packed_tap as tk  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpDataTypeError,
    SdpInvalidArgumentError,
    SdpMemLocationError,
    SdpShapeError,
)
from ska_sdp_func_tpu.kernels import fused_tap as jf  # noqa: E402
from ska_sdp_func_tpu.kernels import packed_tap as jpt  # noqa: E402

LANES, S, SW = FUSED["lanes"], FUSED["support"], FUSED["w_support"]
OV, WOV = FUSED["oversampling"], FUSED["w_oversampling"]
TASKS, LAYERS, BV = FUSED["tasks"], FUSED["layers"], FUSED["block_v"]
TOL = 1e-5
SMEM = 227 * 1024

# -- the layout ----------------------------------------------------------------

# Two staged tiles of 128 slots and a spare record, 42 words a slot, and 4
# warp counts each (2 x 21,688 bytes), then the word forms' fits (16 x 8 x
# 2 f32, 1,024): 44,400 bytes. Of 232,448, 188,048 are left for the window,
# at 128 bytes a column of a w-plane's two planes of 16 rows.
FIXED = 44400
LAYOUT_CASES = [
    # (Sw, lanes): stride, lpad, w-planes a group, groups, tile_w, tiles
    # The dense stream: 4 w-planes of 136 (128 rounded up to 32, + 8).
    ((4, 128), (136, 0, 4, 1, 128, 1)),
    # The ES-FFT 3-D window: 5 w-planes of 264 fit, 8 in 2 groups of 4.
    ((8, 256), (264, 0, 4, 2, 256, 1)),
    # The ES-FFT 2-D window.
    ((1, 256), (264, 0, 1, 1, 256, 1)),
    # 10 w-planes of 136 fit (17,408 bytes each): all 8.
    ((8, 128), (136, 0, 8, 1, 128, 1)),
    # 2 w-planes of 520 fit: 4 in 2 groups of 2.
    ((4, 512), (520, 0, 2, 2, 512, 1)),
    # The widest window taken whole: 1448 x 128 = 185,344 bytes.
    ((1, 1440), (1448, 0, 1, 1, 1440, 1)),
    # 8 columns more: 1480 x 128 > 188,048, so tiles of at most
    # 1469 - 40 -> 1408 columns; two of 736 (724 rounded up to 32),
    # stride 8 + 736 -> 768 + 8.
    ((1, 1448), (776, 8, 1, 1, 736, 2)),
    # 3008 lanes: three tiles of 1024 (1003 rounded up).
    ((1, 3008), (1064, 8, 1, 1, 1024, 3)),
    # 4096 lanes: three tiles of 1376 (1366 rounded up), one w-plane a
    # group (181,248 bytes).
    ((2, 4096), (1416, 8, 1, 2, 1376, 3)),
    # 8 lanes: stride 40, all 8 w-planes.
    ((8, 8), (40, 0, 8, 1, 8, 1)),
]


@pytest.mark.parametrize("case,want", LAYOUT_CASES,
                         ids=[f"sw{c[0]}-l{c[1]}" for c, _ in LAYOUT_CASES])
def test_scatter_layout_hand_cases(case, want):
    got = tk.scatter_layout(*case)
    keys = ("stride", "lpad", "w_planes", "plane_groups", "tile_w", "tiles")
    assert tuple(got[k] for k in keys) == want
    assert got["planes"] == 2 * want[2]
    assert got["fixed"] == FIXED
    assert (got["window_buffers"], got["tile_buffers"]) == (1, 2)
    assert got["smem"] == FIXED + 128 * want[0] * want[2] <= SMEM


@pytest.mark.parametrize("w_support", range(1, 9))
def test_scatter_layout_invariants(w_support):
    """Over lanes 8-4096 (multiples of 8): every w-plane in some group,
    the groups balanced, every column in some tile, the 8-bank stride with
    room for a tile's left pad and the 7 columns past its right edge, and
    at most 227 KiB."""
    for lanes in range(8, 4097, 8):
        lay = tk.scatter_layout(w_support, lanes)
        jn, groups = lay["w_planes"], lay["plane_groups"]
        assert 1 <= jn <= w_support and groups == -(-w_support // jn)
        assert jn * (groups - 1) < w_support
        assert lay["tile_w"] * lay["tiles"] >= lanes
        assert lay["tile_w"] * (lay["tiles"] - 1) < lanes
        assert lay["stride"] % 32 == 8
        assert lay["stride"] >= lay["lpad"] + lay["tile_w"] + 7
        assert lay["smem"] <= SMEM
        if lay["tiles"] > 1:
            assert lay["lpad"] == 8 and lay["tile_w"] % 32 == 0
        else:
            assert lay["lpad"] == 0 and lay["tile_w"] == lanes
        # No fewer groups would fit.
        if groups > 1:
            fewer = -(-w_support // (groups - 1))
            assert FIXED + 128 * lay["stride"] * fewer > SMEM


def test_scatter_layout_rejects_bad_sizes():
    with pytest.raises(SdpInvalidArgumentError):
        tk.scatter_layout(9, 128)
    with pytest.raises(SdpInvalidArgumentError):
        tk.scatter_layout(4, 0)


# -- operands ------------------------------------------------------------------

@pytest.fixture(scope="module")
def ops():
    """tests/test_torch_fused_tap.py's operands (``FUSED``), with the
    compact taps of tests/test_torch_compact.py and K18's bucket ids."""
    fields, o = fused_kernel_operands()
    uv_c = _tap_coeffs_cached(S, OV)
    w_c = _tap_coeffs_cached(SW, WOV)
    tuv = torch.as_tensor(uv_c, dtype=torch.float32)
    tw = torch.as_tensor(w_c, dtype=torch.float32)
    valid = torch.as_tensor(fields["valid"].astype(bool))
    taps = dict(
        uk_t=tf.cheb_taps(torch.as_tensor(fields["u_frac"]), tuv, OV).T,
        vk_t=tf.cheb_taps(torch.as_tensor(fields["v_frac"]), tuv, OV).T,
        wk_t=torch.where(valid[:, None], tf.cheb_taps(
            torch.as_tensor(fields["w_row"]), tw, WOV), 0.0).T)
    o.update({k: np.ascontiguousarray(v.numpy()) for k, v in taps.items()})
    octets, slabs = LANES // 8, LAYERS - SW + 1
    o["bucket_ids"] = ((o["t"] * slabs + o["k"]) * octets
                       + o["g"]).astype(np.int32)
    t = {k: torch.as_tensor(v) for k, v in o.items()}
    return dict(np=o, t=t, uv_c=uv_c, w_c=w_c, tuv=tuv, tw=tw,
                num_buckets=TASKS * slabs * octets)


def _shuffled_runs(keys, seed=3):
    """The kernels' run table of the block keys, its rows in a random
    order (any order is right)."""
    runs = tk.degrid_runs(keys)
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(
        runs.shape[0]))
    return runs[perm].contiguous()


def _grid_calls(s):
    """(name, wrapper, positional args, keywords, block keys) of the four
    grid wrappers on the ``FUSED`` operands."""
    t = s["t"]
    words = dict(support=S, w_support=SW, oversampling=OV,
                 w_oversampling=WOV, block_v=BV, nonempty=t["nonempty"])
    tkg = (t["t"], t["k"], t["g"])
    ids = t["bucket_ids"]
    scales = (torch.as_tensor(s["np"]["wk_t"]), t["vre"], t["vim"])
    iv0, u_off, *_ = tf.unpack_plan_words(t["pa"], t["pb"])
    return [
        ("grid_fused_stack", tf.grid_fused_stack,
         (*tkg, t["pa"], t["pb"], t["vre"], t["vim"], s["tuv"], s["tw"],
          TASKS, LAYERS, LANES, S, SW, OV, WOV),
         dict(block_v=BV, nonempty=t["nonempty"]), tkg),
        ("grid_compact", tf.grid_compact,
         (*tkg, t["pa"], t["uk_t"], t["vk_t"], t["wk_t"], t["vre"],
          t["vim"], TASKS, LAYERS, LANES, S, SW), dict(block_v=BV), tkg),
        ("grid_packed", tb.grid_packed,
         (ids, u_off.contiguous(), iv0.contiguous(),
          t["uk_t"].T.contiguous(), t["vk_t"].T.contiguous(), scales,
          s["num_buckets"], LANES, SW), dict(block_v=BV), (ids,)),
        ("grid_fused", tb.grid_fused,
         (ids, t["pa"], t["pb"], t["vre"], t["vim"], s["tuv"], s["tw"],
          s["num_buckets"], LANES), words, (ids,)),
    ]


GRID_NAMES = ["grid_fused_stack", "grid_compact", "grid_packed",
              "grid_fused"]

# -- runs= is checked before dispatch --------------------------------------------

BAD_RUNS = {
    "1-D": (lambda r: r.reshape(-1), SdpShapeError),
    "three columns": (lambda r: torch.zeros((r.shape[0], 3), dtype=torch.int32),
                      SdpShapeError),
    "int64": (lambda r: r.long(), SdpDataTypeError),
    "float": (lambda r: r.float(), SdpDataTypeError),
    "another device": (lambda r: torch.empty(tuple(r.shape),
                                             dtype=torch.int32,
                                             device="meta"),
                       SdpMemLocationError),
    "not contiguous": (lambda r: torch.stack([r[:, 0], r[:, 1]], dim=1)
                       .T.contiguous().T, SdpInvalidArgumentError),
}


@pytest.mark.parametrize("bad", list(BAD_RUNS))
@pytest.mark.parametrize("name", GRID_NAMES)
def test_grid_wrappers_check_runs_on_cpu(ops, name, bad):
    """A malformed run table raises on the CPU (where the plain version,
    which does not read it, would run), and counts no launch."""
    call = {c[0]: c for c in _grid_calls(ops)}[name]
    _, fn, args, kw, keys = call
    make, err = BAD_RUNS[bad]
    runs = make(tk.degrid_runs(keys))
    before = fn.launches
    with pytest.raises(err):
        fn(*args, **kw, runs=runs)
    assert fn.launches == before


# -- the plain versions against the Pallas kernels ------------------------------

def _jax_grid(s, name, precision):
    """The interpret-mode Pallas kernel of ``name`` on the same operands."""
    o = s["np"]
    j = {k: jnp.asarray(v) for k, v in o.items()}
    if name == "grid_fused_stack":
        return np.asarray(jf.grid_fused_stack_pallas(
            j["t"], j["k"], j["g"], j["pa"], j["pb"], j["vre"], j["vim"],
            s["uv_c"], s["w_c"], TASKS, LAYERS, LANES, S, SW, OV, WOV,
            block_v=BV, precision=precision, nonempty=j["nonempty"],
            interpret=True))
    if name == "grid_compact":
        return np.asarray(jf.grid_compact_pallas(
            j["t"], j["k"], j["g"], j["pa"], j["uk_t"], j["vk_t"],
            j["wk_t"], j["vre"], j["vim"], TASKS, LAYERS, LANES, S, SW,
            block_v=BV, precision=precision, interpret=True))
    assert name == "grid_fused"
    return np.asarray(jf.grid_fused_pallas(
        j["bucket_ids"], j["pa"], j["pb"], j["vre"], j["vim"], s["uv_c"],
        s["w_c"], s["num_buckets"], LANES, support=S, w_support=SW,
        oversampling=OV, w_oversampling=WOV, block_v=BV,
        precision=precision, nonempty=j["nonempty"], interpret=True))


@pytest.mark.parametrize("name", ["grid_fused_stack", "grid_compact",
                                  "grid_fused"])
def test_word_and_compact_plain_versions_match_pallas(ops, name):
    """K3, K12 and K18's plain versions ("highest") with a shuffled run
    table against the interpret-mode Pallas kernels, and bit for bit the
    same without one."""
    call = {c[0]: c for c in _grid_calls(ops)}[name]
    _, fn, args, kw, keys = call
    runs = _shuffled_runs(keys)
    got = fn(*args, **kw, runs=runs)
    assert torch.equal(got, fn(*args, **kw))
    want = _jax_grid(ops, name, "highest")
    assert got.shape == want.shape and got.dtype == torch.float32
    got = got.numpy()
    if name == "grid_fused":
        visited = np.zeros(ops["num_buckets"], bool)
        visited[ops["np"]["bucket_ids"][ops["np"]["nonempty"] != 0]] = True
        got, want = got[:, visited], want[:, visited]
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.fixture(scope="module")
def es3d():
    """tests/test_torch_es_fft.py's 3-D ES plan on the CPU."""
    d = es_scenario()
    vis = d["vis"].astype(np.complex64)
    plan = GridderUvwEsFft(
        d["uvw"], d["freq"], vis, d["weight"],
        np.zeros((d["image_size"],) * 2, np.float32), d["pixel_size"],
        d["pixel_size"], 1e-5, *GridderUvwEsFft.get_w_range(d["uvw"],
                                                           d["freq"]),
        True, device="cpu")
    return plan._packed


@pytest.mark.parametrize("form", ["split", "stack"])
def test_band_plain_version_matches_pallas(es3d, form):
    """K8's plain version on the 3-D ES plan's first slab (both scale
    forms), with the slab's shuffled run table, against
    ``grid_packed_pallas`` on bands of the same taps (visited windows)."""
    ep = es3d
    a = ep.arrays
    b0, b1 = ep.slab_blocks[0]
    sl = slice(b0 * ep.block_v, b1 * ep.block_v)
    rng = np.random.default_rng(5)
    vre, vim = (np.where(a["valid"], rng.standard_normal(ep.total), 0.0)
                .astype(np.float32) for _ in range(2))
    kw_t = np.ascontiguousarray(a["kw"].T)
    if form == "split":
        j_scales = tuple(jnp.asarray(x) for x in (kw_t[:, sl], vre[sl],
                                                  vim[sl]))
        t_scales = tuple(torch.as_tensor(np.ascontiguousarray(x))
                         for x in (kw_t[:, sl], vre[sl], vim[sl]))
    else:
        stack = np.ascontiguousarray(
            np.concatenate([kw_t * vre, kw_t * vim])[:, sl])
        j_scales, t_scales = jnp.asarray(stack), torch.as_tensor(stack)
    ubase, vband, _ = jpt.build_bands(
        jnp.asarray(a["u_off"][sl]), jnp.asarray(a["iv0_local"][sl]),
        jnp.asarray(a["uk"][sl]), jnp.asarray(a["vk"][sl]), 256)
    nbk = ep.gu * ep.gv
    ids = np.ascontiguousarray(a["block_bucket"][b0:b1])
    want = np.asarray(jpt.grid_packed_pallas(
        jnp.asarray(ids), ubase, vband, j_scales, nbk, 256, ep.w_support,
        block_v=ep.block_v, interpret=True))
    t_ids = torch.as_tensor(ids)
    args = (t_ids, *(torch.as_tensor(np.ascontiguousarray(a[k][sl]))
                     for k in ("u_off", "iv0_local", "uk", "vk")),
            t_scales, nbk, 256, ep.w_support)
    got = tb.grid_packed(*args, block_v=ep.block_v,
                         runs=_shuffled_runs((t_ids,)))
    assert torch.equal(got, tb.grid_packed_reference(*args,
                                                     block_v=ep.block_v))
    visited = a["visited"][0]
    got, want = got.numpy(), want[:, visited]
    assert np.abs(got[:, visited] - want).max() <= TOL * np.abs(want).max()
    assert not got[:, ~visited].any()
