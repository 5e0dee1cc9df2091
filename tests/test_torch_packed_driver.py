"""The port's PackedGridder against the JAX package's, whole image.

Both sides run on identical plans (the port's planner is byte-identical,
test_torch_plan.py) and identical visibilities. Images compare
taper-weighted at 1e-5 of peak (the 1/PSWF-corrected border is
ill-conditioned, test_packed_driver.py:350-368); visibilities at 1e-5
of max|vis|. Both bounds allow f32 reassociation only.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, NUM_ROWS, \
    PARAMS, make_inputs, taper, two_point_image  # noqa: E402
from ska_sdp_func_torch.parallel import packed as tpacked  # noqa: E402
from ska_sdp_func_torch.parallel import from_jax_plan  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
)
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack  # noqa
from ska_sdp_func_tpu.parallel.packed import (  # noqa: E402
    packed_gridder as j_gridder,
    plan_packed as j_plan_packed,
)

PRECISIONS = ["high", "highest"]


@pytest.fixture(scope="module")
def scenario():
    uvw, vis = make_inputs()
    jplan = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    jpp = j_plan_packed(jplan, uvw, block_v=128)
    return dict(uvw=uvw, vis=vis, jplan=jplan, jpp=jpp,
                tpp=from_jax_plan(jpp), taper=taper(jplan))


@pytest.fixture(scope="module")
def images(scenario):
    """Dirty images and two-point degrids per precision, both sides."""
    s = scenario
    out = {}
    for prec in PRECISIONS:
        jg = j_gridder(s["jpp"], precision=prec)
        tg = tpacked.packed_gridder(s["tpp"], precision=prec,
                                    device="cpu")
        vre, vim = jg.sort(jnp.asarray(s["vis"]))
        model = two_point_image()
        out[prec] = dict(
            j_img=np.asarray(jg.grid_sorted(vre, vim)),
            t_img=tg.grid_sorted(*tg.sort(s["vis"])).numpy(),
            j_vis=np.asarray(jg.degrid_sorted(jnp.asarray(model))),
            t_vis=tg.degrid_sorted(model).numpy(),
            j_nat=np.asarray(jg.degrid(jnp.asarray(model))),
            t_nat=tg.degrid(model).numpy(),
            j_grid=np.asarray(jg.grid(jnp.asarray(s["vis"]))),
            t_grid=tg.grid(torch.as_tensor(s["vis"])).numpy())
    return out


def test_sort_unsort_roundtrip(scenario):
    g = tpacked.packed_gridder(scenario["tpp"], device="cpu")
    vre, vim = g.sort(scenario["vis"])
    back = g.unsort(torch.complex(vre, vim)).numpy()
    np.testing.assert_array_equal(back, scenario["vis"])


def test_sort_matches_jax(scenario):
    jg = j_gridder(scenario["jpp"])
    tg = tpacked.packed_gridder(scenario["tpp"], device="cpu")
    for got, want in zip(tg.sort(scenario["vis"]),
                         jg.sort(jnp.asarray(scenario["vis"]))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _taper_err(scenario, got, want):
    t = scenario["taper"]
    return np.abs((got - want) * t).max() / np.abs(want * t).max()


@pytest.mark.parametrize("prec", PRECISIONS)
def test_grid_sorted_matches_jax(scenario, images, prec):
    im = images[prec]
    assert im["t_img"].dtype == np.float32
    assert im["t_img"].shape == (IMAGE_SIZE, IMAGE_SIZE)
    assert _taper_err(scenario, im["t_img"], im["j_img"]) < 1e-5


@pytest.mark.parametrize("prec", PRECISIONS)
def test_grid_natural_order_matches_jax(scenario, images, prec):
    im = images[prec]
    assert _taper_err(scenario, im["t_grid"], im["j_grid"]) < 1e-5


@pytest.mark.parametrize("prec", PRECISIONS)
def test_degrid_sorted_matches_jax(images, prec):
    im = images[prec]
    assert im["t_vis"].dtype == np.complex64
    vscale = np.abs(im["j_vis"]).max()
    np.testing.assert_allclose(im["t_vis"], im["j_vis"], atol=1e-5 * vscale)


@pytest.mark.parametrize("prec", PRECISIONS)
def test_degrid_natural_order_matches_jax(images, prec):
    im = images[prec]
    assert im["t_nat"].shape == (NUM_ROWS, NUM_CHAN)
    vscale = np.abs(im["j_nat"]).max()
    np.testing.assert_allclose(im["t_nat"], im["j_nat"], atol=1e-5 * vscale)


def test_fast_mode_matches_jax(scenario):
    """fast=True (bf16 bands) runs the same arithmetic on both sides."""
    s = scenario
    jg = j_gridder(s["jpp"], fast=True)
    tg = tpacked.packed_gridder(s["tpp"], fast=True, device="cpu")
    vre, vim = jg.sort(jnp.asarray(s["vis"]))
    j_img = np.asarray(jg.grid_sorted(vre, vim))
    t_img = tg.grid_sorted(*tg.sort(s["vis"])).numpy()
    assert _taper_err(s, t_img, j_img) < 1e-5


def test_gridder_cache_keys_on_resolved_defaults(scenario):
    p = scenario["tpp"]
    g = tpacked.packed_gridder(p, device="cpu")
    assert tpacked.packed_gridder(p, precision="high",
                                  device="cpu") is g
    assert tpacked.packed_gridder(p, engine="auto", device="cpu") is g
    assert tpacked.packed_gridder(p, precision="highest",
                                  device="cpu") is not g
    fast = tpacked.packed_gridder(p, fast=True, device="cpu")
    assert fast.precision == "bf16"
    assert tpacked.packed_gridder(p, fast=True, precision="bf16",
                                  device="cpu") is fast
    assert len(tpacked._GRIDDER_CACHE) <= tpacked._GRIDDER_CACHE_MAX


@pytest.mark.parametrize("engine", ["compact"])
def test_unported_engines_raise(scenario, engine):
    """Every engine of the JAX package runs in the port, and only those:
    engine="compact" (K12/K13) against the JAX package's compact engine
    at its default precision ("high", run as "highest" by both), image
    taper-weighted and sorted-stream degrid at 1e-5; an unknown engine
    raises."""
    s = scenario
    jg = j_gridder(s["jpp"], engine=engine)
    tg = tpacked.PackedGridder(s["tpp"], engine=engine, device="cpu")
    assert jg._compact and tg.engine == engine and tg.vband is None
    assert tg.precision == jg.precision == "highest"
    vre, vim = jg.sort(jnp.asarray(s["vis"]))
    j_img = np.asarray(jg.grid_sorted(vre, vim))
    t_img = tg.grid_sorted(*tg.sort(s["vis"])).numpy()
    assert _taper_err(s, t_img, j_img) < 1e-5
    model = two_point_image()
    j_vis = np.asarray(jg.degrid_sorted(jnp.asarray(model)))
    t_vis = tg.degrid_sorted(model).numpy()
    np.testing.assert_allclose(t_vis, j_vis,
                               atol=1e-5 * np.abs(j_vis).max())
    with pytest.raises(SdpInvalidArgumentError, match="engine"):
        tpacked.PackedGridder(s["tpp"], engine="dense", device="cpu")


@pytest.mark.parametrize("prec", PRECISIONS)
def test_fused_engine_matches_jax(scenario, prec):
    """engine="fused" (taps evaluated in K3/K4 from the packed plan
    words) against the JAX package's fused engine: the same image and
    sorted-stream degrid at 1e-5."""
    s = scenario
    jg = j_gridder(s["jpp"], precision=prec, engine="fused")
    tg = tpacked.PackedGridder(s["tpp"], precision=prec, engine="fused",
                               device="cpu")
    assert jg._fused and tg.engine == "fused" and tg.vband is None
    vre, vim = jg.sort(jnp.asarray(s["vis"]))
    j_img = np.asarray(jg.grid_sorted(vre, vim))
    t_img = tg.grid_sorted(*tg.sort(s["vis"])).numpy()
    assert _taper_err(s, t_img, j_img) < 1e-5
    model = two_point_image()
    j_vis = np.asarray(jg.degrid_sorted(jnp.asarray(model)))
    t_vis = tg.degrid_sorted(model).numpy()
    np.testing.assert_allclose(t_vis, j_vis,
                               atol=1e-5 * np.abs(j_vis).max())
    # The plan words are the JAX engine's, bit for bit.
    np.testing.assert_array_equal(tg.pa.numpy(), np.asarray(jg.pa))
    np.testing.assert_array_equal(tg.pb.numpy(), np.asarray(jg.pb))


@pytest.mark.parametrize("entry", [
    "packed_gridder", "PackedGridder", "StreamingGridder",
    "StreamingDegridder", "major_cycle_imager", "wstack_wtower_grid_all",
    "wstack_wtower_degrid_all", "GridderWtowerUVW.grid_subgrid",
    "GridderWtowerUVW.degrid_subgrid", "GridderWtowerUVW.grid_correct",
    "grid_all_tasks", "degrid_all_tasks", "grid_all_bucketed",
    "degrid_all_bucketed", "w_screen_stack", "fft_shifted",
    "fft_convolution", "subgrid_add", "grid_correct_pswf", "hogbom_clean"])
def test_entry_points_default_to_the_card(scenario, entry):
    """Without ``device`` every entry point runs on the CUDA card, never
    the CPU, even for NumPy or CPU-tensor inputs: on a host with no card
    it raises at its first tensor move."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default works")
    from ska_sdp_func_torch.clean import hogbom_clean
    from ska_sdp_func_torch.fourier_transforms import fft_shifted
    from ska_sdp_func_torch.grid_data import grid_correct_pswf, \
        subgrid_add, w_screen_stack
    from ska_sdp_func_torch.numeric_functions import fft_convolution
    from ska_sdp_func_torch.grid_data import wstack as tws
    from ska_sdp_func_torch.parallel import bucketed as tb
    from ska_sdp_func_torch.parallel import streaming as tstream
    from ska_sdp_func_torch.parallel import wstack as tpw
    from ska_sdp_func_torch.pipeline import major_cycle as tmc

    s = scenario
    tplan = s["tpp"].wplan
    kern = tplan.kernel()

    def kern_gc(facet):
        return grid_correct_pswf(IMAGE_SIZE, PARAMS["theta"],
                                 PARAMS["w_step"], 0.0, 0.0,
                                 PARAMS["support"], PARAMS["w_support"],
                                 facet)
    uvw, vis = s["uvw"], torch.as_tensor(s["vis"])
    img = np.zeros((IMAGE_SIZE, IMAGE_SIZE), np.float32)
    sub = np.zeros((PARAMS["subgrid_size"],) * 2, np.complex64)
    st = np.zeros(NUM_ROWS, np.int32)
    en = np.full(NUM_ROWS, NUM_CHAN, np.int32)

    def bucketed(fn, data, *extra):
        bplan, sort_index, valid = tb.plan_bucketed(tplan, uvw)
        return fn(bplan, data, uvw, sort_index, valid, *extra)

    calls = {
        "packed_gridder": lambda: tpacked.packed_gridder(s["tpp"]),
        "PackedGridder": lambda: tpacked.PackedGridder(s["tpp"]),
        "major_cycle_imager": lambda: tmc.major_cycle_imager(
            tplan, s["vis"], uvw, bucketed=True),
        "wstack_wtower_grid_all": lambda: tws.wstack_wtower_grid_all(
            vis, FREQ0, DFREQ, uvw, **PARAMS, image=img),
        "wstack_wtower_degrid_all": lambda: tws.wstack_wtower_degrid_all(
            img, FREQ0, DFREQ, uvw, **PARAMS, vis=s["vis"]),
        "GridderWtowerUVW.grid_subgrid": lambda: kern.grid_subgrid(
            vis, uvw, st, en, NUM_CHAN, FREQ0, DFREQ, sub, (0, 0, 0)),
        "GridderWtowerUVW.degrid_subgrid": lambda: kern.degrid_subgrid(
            sub, (0, 0, 0), NUM_CHAN, FREQ0, DFREQ, uvw, st, en, vis),
        "GridderWtowerUVW.grid_correct": lambda: kern.grid_correct(
            torch.ones(IMAGE_SIZE, IMAGE_SIZE)),
        "grid_all_tasks": lambda: tpw.grid_all_tasks(
            tplan, kern, vis, uvw, st, en),
        "degrid_all_tasks": lambda: tpw.degrid_all_tasks(
            tplan, kern, img, uvw, st, en, torch.complex64),
        "grid_all_bucketed": lambda: bucketed(tb.grid_all_bucketed, vis),
        "degrid_all_bucketed": lambda: bucketed(
            tb.degrid_all_bucketed, img,
            np.zeros(NUM_ROWS * NUM_CHAN, np.int64)),
        "w_screen_stack": lambda: w_screen_stack(
            IMAGE_SIZE, PARAMS["theta"], PARAMS["w_step"], 0.0, 0.0,
            [0.0, 1.0]),
        # The tensor helpers on NumPy input.
        "fft_shifted": lambda: fft_shifted(sub),
        "fft_convolution": lambda: fft_convolution(sub, sub.real),
        "subgrid_add": lambda: subgrid_add(sub, 1, 2, sub[:8, :8]),
        "grid_correct_pswf": lambda: kern_gc(img),
        "hogbom_clean": lambda: hogbom_clean(
            img[:8, :8], img[:16, :16], [2.0, 2.0, 1.0, 8.0], 0.1, 0.0, 1),
    }
    for name in ("StreamingGridder", "StreamingDegridder"):
        sp = tstream.plan_stream(tplan, tstream.stream_tasks(tplan, s["uvw"]),
                                 chunk_rows=64, block_v=128, cap_slots=20480)
        calls[name] = (lambda cls: lambda: cls(sp))(getattr(tstream, name))
    with pytest.raises((RuntimeError, AssertionError)):
        calls[entry]()
