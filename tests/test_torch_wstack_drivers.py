"""Driver helpers, the w-stacking whole-image drivers, the task drivers
and the bucketed drivers against JAX.

Tolerances: the helpers exactly, or at 1e-12 where f64 screens differ
in the last bits; the reference engine on complex128 at 1e-10 of peak
(the same f64 operators, summed in another order; the grid in the
interior, as the 1/PSWF border ring is ill-conditioned); complex64 task
drivers at 1e-5 of the (taper-weighted) peak (f32 tap products
reordered); the packed engine
at 1e-4 of the taper-weighted peak (the port's packed kernels against
JAX's, both f32); the bucketed drivers against JAX's task drivers at
1e-4 of the interior peak (test_bucketed.py:77-81, 102-104: two
formulations of the same f32 operator).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import C_0  # noqa: E402
from _torch_scenario import DFREQ as P_DFREQ  # noqa: E402
from _torch_scenario import FREQ0 as P_FREQ0  # noqa: E402
from _torch_scenario import IMAGE_SIZE as P_IMAGE  # noqa: E402
from _torch_scenario import NUM_CHAN as P_CHAN  # noqa: E402
from _torch_scenario import PARAMS as P_PARAMS  # noqa: E402
from _torch_scenario import make_inputs, taper  # noqa: E402
from ska_sdp_func_torch.grid_data import clamp_channels as tcc  # noqa
from ska_sdp_func_torch.grid_data import grid_correct as tgc  # noqa: E402
from ska_sdp_func_torch.grid_data import gridder_utils as tgu  # noqa: E402
from ska_sdp_func_torch.grid_data import wstack as tws  # noqa: E402
from ska_sdp_func_torch.parallel import bucketed as tb  # noqa: E402
from ska_sdp_func_torch.parallel import wstack as tpw  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
)
from ska_sdp_func_tpu.grid_data import clamp_channels as jcc  # noqa: E402
from ska_sdp_func_tpu.grid_data import grid_correct as jgc  # noqa: E402
from ska_sdp_func_tpu.grid_data import gridder_utils as jgu  # noqa: E402
from ska_sdp_func_tpu.grid_data import wstack as jws  # noqa: E402
from ska_sdp_func_tpu.parallel import bucketed as jb  # noqa: E402
from ska_sdp_func_tpu.parallel import wstack as jpw  # noqa: E402

# A small w-stacking scenario with a 32^2 sub-grid (test_bucketed.py /
# test_wstack.py geometry, fewer rows): a geometry the packed engine
# cannot take.
PARAMS = dict(subgrid_size=32, theta=0.002, w_step=50.0, shear_u=0.0,
              shear_v=0.0, support=8, oversampling=16 * 1024, w_support=4,
              w_oversampling=16 * 1024, subgrid_frac=2.0 / 3.0,
              w_tower_height=4.0)
IMAGE, ROWS, CHANS = 64, 60, 2
FREQ0, DFREQ = C_0, C_0 / 100


@pytest.fixture(scope="module")
def scn():
    rng = np.random.default_rng(5)
    uvw = rng.uniform(-1, 1, (ROWS, 3))
    uvw[:, :2] *= 0.3 * IMAGE / 2 / PARAMS["theta"]
    uvw[:, 2] *= PARAMS["w_step"] * PARAMS["w_tower_height"]
    vis = (rng.standard_normal((ROWS, CHANS))
           + 1j * rng.standard_normal((ROWS, CHANS))).astype(np.complex64)
    image = np.zeros((IMAGE, IMAGE), np.float32)
    image[IMAGE // 2 + 6, IMAGE // 2 - 5] = 1.0
    image[IMAGE // 2 - 9, IMAGE // 2 + 7] = 0.5
    jplan = jpw.plan_wstack(uvw, FREQ0, DFREQ, CHANS, IMAGE, **PARAMS)
    tplan = tpw.plan_wstack(uvw, FREQ0, DFREQ, CHANS, IMAGE, **PARAMS)
    st = np.zeros(ROWS, np.int32)
    en = np.full(ROWS, CHANS, np.int32)
    return dict(uvw=uvw, vis=vis, image=image, jplan=jplan, tplan=tplan,
                st=st, en=en)


def _rel(got, want, interior=0, weight=1.0):
    got, want = np.asarray(got) * weight, np.asarray(want) * weight
    if interior:
        got = got[interior:-interior, interior:-interior]
        want = want[interior:-interior, interior:-interior]
    return np.abs(got - want).max() / np.abs(want).max()


# -- helpers -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_clamp_channels_match_jax(dtype):
    rng = np.random.default_rng(3)
    uvw = (rng.uniform(-1, 1, (400, 3)) * 3000).astype(dtype)
    uvw[:5, 0] = 0.0                        # du ~ 0: in/out decision
    st = rng.integers(0, 4, 400).astype(np.int32)
    en = (st + rng.integers(0, 60, 400)).astype(np.int32)
    args = (FREQ0, DFREQ)
    for dim in (0, 2):
        want = jcc.clamp_channels_single(jnp.asarray(uvw), dim, *args,
                                         jnp.asarray(st), jnp.asarray(en),
                                         -150.0, 420.0)
        got = tcc.clamp_channels_single(torch.as_tensor(uvw), dim, *args,
                                        torch.as_tensor(st),
                                        torch.as_tensor(en), -150.0, 420.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jcc.clamp_channels_uv(jnp.asarray(uvw), *args, jnp.asarray(st),
                                 jnp.asarray(en), -500.0, 200.0, 0.0, 900.0)
    got = tcc.clamp_channels_uv(torch.as_tensor(uvw), *args,
                                torch.as_tensor(st), torch.as_tensor(en),
                                -500.0, 200.0, 0.0, 900.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_uvw_bounds_match_jax():
    rng = np.random.default_rng(4)
    uvw = rng.uniform(-1, 1, (300, 3)) * 5000
    st = rng.integers(0, 3, 300).astype(np.int32)
    en = (st + rng.integers(0, 5, 300)).astype(np.int32)
    want = jgu.uvw_bounds_all(jnp.asarray(uvw), FREQ0, DFREQ,
                              jnp.asarray(st), jnp.asarray(en))
    got = tgu.uvw_bounds_all(torch.as_tensor(uvw), FREQ0, DFREQ,
                             torch.as_tensor(st), torch.as_tensor(en))
    for g, w in zip(got, want):      # XLA may fuse a multiply-add
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15)
    got = tgu.uvw_bounds_all(torch.as_tensor(uvw), FREQ0, DFREQ,
                             torch.as_tensor(en), torch.as_tensor(en))
    assert np.isinf(got[0].numpy()).all() and np.isinf(got[1].numpy()).all()


@pytest.mark.parametrize("offset", [(0, 0), (5, -3), (40, 37)])
def test_subgrid_add_cut_out_shift_match_jax(offset):
    rng = np.random.default_rng(6)
    grid = rng.standard_normal((48, 48)) + 1j * rng.standard_normal((48, 48))
    sub = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    want = jgu.subgrid_add(jnp.asarray(grid), *offset, jnp.asarray(sub), 2.5)
    got = tgu.subgrid_add(torch.as_tensor(grid), *offset,
                          torch.as_tensor(sub), 2.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jgu.subgrid_cut_out(jnp.asarray(grid), *offset, 16)
    got = tgu.subgrid_cut_out(torch.as_tensor(grid), *offset, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stack = rng.standard_normal((4, 8, 8))
    np.testing.assert_array_equal(
        tgu.shift_subgrids(torch.as_tensor(stack)).numpy(),
        np.asarray(jgu.shift_subgrids(jnp.asarray(stack))))


@pytest.mark.parametrize("name", ["shift_subgrids", "subgrid_add",
                                  "subgrid_cut_out", "grid_correct_w_stack"])
def test_gridder_utils_take_numpy_like_jax(name):
    """NumPy input (seed 1: 16^2 complex64 grids, a 64^2 facet) is copied
    to ``device``; the results are tensors equal to JAX's on the same
    arrays (the w-screen at 1e-6 of its peak, in complex64)."""
    rng = np.random.default_rng(1)

    def cplx(shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    grid, sub, facet = cplx((16, 16)), cplx((8, 8)), cplx((64, 64))
    stack = cplx((3, 16, 16))
    w_args = (128, 0.002, 100.0, 0.1, -0.15)
    calls = {
        "shift_subgrids": (tgu.shift_subgrids, jgu.shift_subgrids,
                           (stack,), ()),
        "subgrid_add": (tgu.subgrid_add, jgu.subgrid_add,
                        (grid, 3, -2, sub), (2.5,)),
        "subgrid_cut_out": (tgu.subgrid_cut_out, jgu.subgrid_cut_out,
                            (grid, 3, -2), (8,)),
        "grid_correct_w_stack": (
            lambda f, *a, **kw: tgc.grid_correct_w_stack(*w_args, f, *a,
                                                         **kw),
            lambda f, *a: jgc.grid_correct_w_stack(*w_args, f, *a),
            (facet,), (4, -2, 3, False))}
    t_fn, j_fn, arrays, extra = calls[name]
    got = t_fn(*arrays, *extra, device="cpu")
    want = np.asarray(j_fn(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                             else a for a in arrays), *extra))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    tol = 1e-6 if name == "grid_correct_w_stack" else 0.0
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("inverse", [False, True])
def test_grid_correct_w_stack_matches_jax(inverse):
    rng = np.random.default_rng(8)
    facet = rng.standard_normal((40, 40)) + 1j * rng.standard_normal(
        (40, 40))
    args = (128, 0.002, 100.0, 0.1, -0.15)
    for w_offset in (0, 3):
        want = np.asarray(jgc.grid_correct_w_stack(
            *args, jnp.asarray(facet), 4, -2, w_offset, inverse))
        got = tgc.grid_correct_w_stack(*args, torch.as_tensor(facet), 4, -2,
                                       w_offset, inverse).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# -- reference-API whole-image drivers -----------------------------------------

def _wstack_call(fn, data, scn, mod, template, verbosity=0):
    arr = jnp.asarray if mod is jnp else (
        lambda a: torch.tensor(np.asarray(a)))
    key = "vis" if fn.__name__.endswith("degrid_all") else "image"
    cpu = {} if mod is jnp else dict(device="cpu")
    return np.asarray(fn(arr(data), FREQ0, DFREQ, arr(scn["uvw"]),
                         **PARAMS, **{key: arr(template)},
                         verbosity=verbosity, **cpu))


def test_wstack_reference_engine_matches_jax(scn):
    """engine="reference" on complex128: degrid a two-point sky, grid the
    result back, against JAX's loop."""
    vis_t = np.zeros((ROWS, CHANS), np.complex128)
    want = _wstack_call(jws.wstack_wtower_degrid_all, scn["image"], scn,
                        jnp, vis_t)
    got = _wstack_call(tws.wstack_wtower_degrid_all, scn["image"], scn,
                       torch, vis_t, verbosity=1)
    assert np.abs(want).max() > 0.1 and _rel(got, want) <= 1e-10
    img_t = np.zeros((IMAGE, IMAGE), np.complex128)
    gwant = _wstack_call(jws.wstack_wtower_grid_all, want, scn, jnp, img_t)
    ggot = _wstack_call(tws.wstack_wtower_grid_all, want, scn, torch, img_t)
    # The 1/PSWF correction reaches 1e15 in the border ring.
    assert _rel(ggot, gwant, interior=IMAGE // 8) <= 1e-10


def test_wstack_packed_and_auto_engines_match_jax():
    """engine="packed" (the port's packed kernels' plain versions here)
    and "auto" against JAX's packed engine, on a 128-multiple sub-grid."""
    uvw, vis = make_inputs()
    geom = dict(P_PARAMS)
    tmpl = np.zeros((P_IMAGE, P_IMAGE), np.float32)
    args = (vis, P_FREQ0, P_DFREQ)
    want = np.asarray(jws.wstack_wtower_grid_all(
        jnp.asarray(vis), *args[1:], jnp.asarray(uvw), **geom, image=tmpl,
        engine="packed"))
    wt = taper(jpw.plan_wstack(uvw, P_FREQ0, P_DFREQ, P_CHAN, P_IMAGE,
                               **geom))
    for engine in ("packed", "auto"):
        got = tws.wstack_wtower_grid_all(
            torch.as_tensor(vis), *args[1:], torch.as_tensor(uvw), **geom,
            image=torch.as_tensor(tmpl), engine=engine,
            device="cpu").numpy()
        assert got.dtype == np.float32
        assert _rel(got * wt, want * wt) <= 1e-4
    sky = np.zeros((P_IMAGE, P_IMAGE), np.float32)
    sky[130, 140] = 1.0
    vwant = np.asarray(jws.wstack_wtower_degrid_all(
        jnp.asarray(sky), *args[1:], jnp.asarray(uvw), **geom, vis=vis,
        engine="packed"))
    vgot = tws.wstack_wtower_degrid_all(
        torch.as_tensor(sky), *args[1:], torch.as_tensor(uvw), **geom,
        vis=torch.as_tensor(vis), engine="packed", device="cpu").numpy()
    assert _rel(vgot, vwant) <= 1e-4
    with pytest.raises(SdpInvalidArgumentError):
        tws.wstack_wtower_grid_all(
            torch.as_tensor(vis), *args[1:], torch.as_tensor(uvw),
            **dict(geom, subgrid_size=96), image=torch.as_tensor(tmpl),
            engine="packed", device="cpu")


def test_wstack_engine_routing(scn):
    assert tws._resolve_engine("auto", torch.zeros(2, dtype=torch.complex64),
                               128, 8, 4, 2 / 3) == "packed"
    assert tws._resolve_engine("auto", np.zeros(2, np.complex128), 128, 8,
                               4, 2 / 3) == "reference"
    assert tws._resolve_engine("auto", np.zeros(2, np.float32), 32, 8, 4,
                               2 / 3) == "reference"
    with pytest.raises(SdpInvalidArgumentError):
        tws._resolve_engine("bogus", None, 128, 8, 4, 2 / 3)
    with pytest.raises(SdpInvalidArgumentError):
        tws.wstack_wtower_grid_all(torch.as_tensor(scn["vis"]), FREQ0,
                                   DFREQ, torch.as_tensor(scn["uvw"]),
                                   **dict(PARAMS, w_tower_height=0.0),
                                   image=torch.zeros(IMAGE, IMAGE),
                                   device="cpu")


# -- task drivers and bucketed drivers -----------------------------------------

def _task_grid(scn, mod, vis):
    p = scn["jplan"] if mod is jnp else scn["tplan"]
    fn = jpw.grid_all_tasks if mod is jnp else tpw.grid_all_tasks
    arr = jnp.asarray if mod is jnp else torch.as_tensor
    cpu = {} if mod is jnp else dict(device="cpu")
    return np.asarray(fn(p, p.kernel(), arr(vis), arr(scn["uvw"]),
                         arr(scn["st"]), arr(scn["en"]), **cpu).real)


def _task_degrid(scn, mod, image):
    p = scn["jplan"] if mod is jnp else scn["tplan"]
    fn = jpw.degrid_all_tasks if mod is jnp else tpw.degrid_all_tasks
    arr = jnp.asarray if mod is jnp else torch.as_tensor
    dt = jnp.complex64 if mod is jnp else torch.complex64
    cpu = {} if mod is jnp else dict(device="cpu")
    return np.asarray(fn(p, p.kernel(), arr(image.astype(np.complex64)),
                         arr(scn["uvw"]), arr(scn["st"]), arr(scn["en"]),
                         dt, **cpu))


@pytest.fixture(scope="module")
def jax_tasks(scn):
    """JAX's task-driver dirty image and prediction (complex64 data on
    f64 uvw, as major_cycle_imager runs them)."""
    return dict(img=_task_grid(scn, jnp, scn["vis"]),
                vis=_task_degrid(scn, jnp, scn["image"]))


def test_task_drivers_match_jax(scn, jax_tasks):
    img = _task_grid(scn, torch, scn["vis"])
    assert img.dtype == np.float32
    # Taper-weighted: the 1/PSWF-corrected border amplifies f32 noise.
    assert _rel(img, jax_tasks["img"], weight=taper(scn["jplan"])) <= 1e-5
    vis = _task_degrid(scn, torch, scn["image"])
    assert vis.dtype == np.complex64
    assert _rel(vis, jax_tasks["vis"]) <= 1e-5


def test_plan_bucketed_matches_jax(scn):
    jp, js, jv = jb.plan_bucketed(scn["jplan"], scn["uvw"], block_v=128)
    tp, ts, tv = tb.plan_bucketed(scn["tplan"], scn["uvw"], block_v=128)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tv, jv)
    assert tp.total == jp.total
    assert [tuple(vars(t).values()) for t in tp.tasks] == \
        [tuple(vars(t).values()) for t in jp.tasks]
    assert tp.w_plane_ids == jp.w_plane_ids
    np.testing.assert_array_equal(tb.task_id_stream(tp),
                                  jb.task_id_stream(jp))
    inv = tb.inverse_index_of(ts, tv, ROWS * CHANS)
    np.testing.assert_array_equal(
        inv, jb.inverse_index_of(js, jv, ROWS * CHANS))
    assert int(tv.sum()) == ROWS * CHANS


def test_bucketed_matches_jax_task_drivers(scn, jax_tasks):
    bplan, sort_index, valid = tb.plan_bucketed(scn["tplan"], scn["uvw"],
                                                block_v=128)
    uvw = torch.as_tensor(scn["uvw"])
    img = tb.grid_all_bucketed(bplan, torch.as_tensor(scn["vis"]), uvw,
                               sort_index, valid, device="cpu").numpy()
    assert img.dtype == np.float32
    b = IMAGE // 8      # the 1/PSWF correction amplifies f32 noise
    assert _rel(img, jax_tasks["img"], interior=b) <= 1e-4
    inv = tb.inverse_index_of(sort_index, valid, ROWS * CHANS)
    vis = tb.degrid_all_bucketed(bplan, torch.as_tensor(scn["image"]), uvw,
                                 sort_index, valid, inv,
                                 device="cpu").numpy()
    assert vis.shape == (ROWS, CHANS) and vis.dtype == np.complex64
    assert _rel(vis, jax_tasks["vis"]) <= 1e-4


def test_plan_bucketed_rejects_oversized_boxes(scn):
    plan = tpw.plan_wstack(scn["uvw"], FREQ0, DFREQ, CHANS, IMAGE,
                           **dict(PARAMS, subgrid_frac=0.9))
    with pytest.raises(SdpInvalidArgumentError):
        tb.plan_bucketed(plan, scn["uvw"])


def test_log_info_and_timers_report():
    """log_info writes the SKA pipe format; a Timers tree reports each
    section with its share of the total."""
    import io
    import logging

    from ska_sdp_func_torch.utility import logging as tlog
    from ska_sdp_func_torch.utility.timers import Timers, TimerType

    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    handler.setFormatter(tlog._SkaFormatter())
    logger = tlog.get_logger()
    logger.addHandler(handler)
    try:
        tlog.log_info("using %d w-planes", 3)
    finally:
        logger.removeHandler(handler)
    fields = stream.getvalue().strip().split("|")
    assert fields[0] == "1" and fields[2] == "INFO"
    assert fields[4] == "test_log_info_and_timers_report"
    assert fields[6:] == ["ska-sdp-func-torch", "using 3 w-planes"]

    timers = Timers("Gridding", TimerType.DEVICE, device="cpu")
    timers.push("FFT(grid)")
    timers.pop_push("Grid correct")
    timers.pop()
    text = timers.report(print_fn=None).splitlines()
    assert text[0].startswith("Gridding (")
    assert [t.split(":")[0] for t in text[1:3]] == ["+- FFT(grid)",
                                                    "+- Grid correct"]
