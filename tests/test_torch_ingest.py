"""The port's visibility ingest (pipeline/ingest.py) against the JAX
package on the same NumPy-seeded inputs, and the whole slice: ingest ->
Briggs weights -> the weighted bucketed solve, at the size of
examples/full_pipeline_demo.py (tests/test_pipeline.py:305-343's
cases), on the CPU.

Tolerances: flags and ingest weights exact (a select of the same
weights; the beam division 1e-12 relative); the flagged fraction (an f32
mean, which JAX rounds one ulp off the exact quotient) 1e-6 relative;
the beam power (an element sum) 1e-10; Briggs weights 1e-10; the solve
1e-4 of the model peak (tests/test_torch_major_cycle.py's
``_solve_pair``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from _torch_dist_workers import AxisMesh  # noqa: E402

from test_torch_major_cycle import _solve_pair  # noqa: E402

from ska_sdp_func_torch import grid_data as tg  # noqa: E402
from ska_sdp_func_torch import pipeline as tp  # noqa: E402
from ska_sdp_func_torch import visibility as tv  # noqa: E402
from ska_sdp_func_torch.parallel import plan_wstack as t_plan  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
)
from ska_sdp_func_tpu import grid_data as jg  # noqa: E402
from ska_sdp_func_tpu import visibility as jv  # noqa: E402
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan  # noqa: E402
from ska_sdp_func_tpu.pipeline import ingest as ji  # noqa: E402

C_0 = 299792458.0
CPU = "cpu"


def _rfi_stream(seed=4, times=8, baselines=30, chans=16, pols=2):
    rng = np.random.default_rng(seed)
    shape = (times, baselines, chans, pols)
    vis = 1.0 + 0.1 * (rng.standard_normal(shape)
                       + 1j * rng.standard_normal(shape))
    vis[3, 7, :, :] += 200.0 + 150.0j             # broadband
    vis[2:6, 11, 5, 0] += 80.0                    # narrowband
    weights = rng.uniform(0.5, 2.0, shape)
    return vis, weights


@pytest.mark.parametrize("kw", [dict(), dict(window=1, sampling_step=2,
                                             alpha=0.3)])
def test_ingest_flag_and_weight_matches_jax(kw):
    vis, w = _rfi_stream()
    jf, jw, jfrac = ji.ingest_flag_and_weight(jnp.asarray(vis),
                                              jnp.asarray(w), **kw)
    tf, tw, tfrac = tp.ingest_flag_and_weight(vis, w, device=CPU, **kw)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tfrac.dtype == torch.float32
    assert float(tfrac) == pytest.approx(float(jfrac), rel=1e-6)
    assert tf[3, 7].all() and tf[2:6, 11, 5, 0].all()


@pytest.mark.parametrize("gain", [False, True])
def test_ingest_to_solver_matches_jax(gain):
    """With a [time, baseline, chan] beam gain that is zero in places."""
    vis, w = _rfi_stream(seed=5, pols=1)
    g = None
    if gain:
        g = np.random.default_rng(6).uniform(0.2, 1.0, vis.shape[:3])
        g[0, :3] = 0.0
    jv_, jw_, jfrac = ji.ingest_to_solver(
        jnp.asarray(vis), jnp.asarray(w),
        None if g is None else jnp.asarray(g))
    tv_, tw_, tfrac = tp.ingest_to_solver(vis, w, g, device=CPU)
    np.testing.assert_array_equal(tv_.numpy(), np.asarray(jv_))
    want = np.asarray(jw_)
    assert np.abs(tw_.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    assert tfrac == pytest.approx(jfrac, rel=1e-6) and 0 < tfrac < 0.05


def test_station_beam_power_matches_jax():
    """tests/test_pipeline.py's boresight case, and a steered beam over
    ten directions in f32 (the card's dtype)."""
    rng = np.random.default_rng(0)
    ex, ey = rng.uniform(-20, 20, (2, 64))
    ez = np.zeros(64)
    w = np.exp(-2j * np.pi * (0.03 * ex - 0.01 * ey))
    lmn = np.zeros((10, 3))
    lmn[:, :2] = rng.uniform(-0.1, 0.1, (10, 2))
    lmn[:, 2] = np.sqrt(1 - (lmn[:, :2] ** 2).sum(1))
    lmn[0] = [0.0, 0.0, 1.0]
    for dt, tol in ((np.float64, 1e-10), (np.float32, 1e-5)):
        want = np.asarray(ji.station_beam_power(
            ex.astype(dt), ey.astype(dt), ez.astype(dt),
            w.astype(np.complex64 if dt == np.float32 else complex),
            lmn.astype(dt), 1.0e8))
        got = tp.station_beam_power(
            ex.astype(dt), ey.astype(dt), ez.astype(dt),
            w.astype(np.complex64 if dt == np.float32 else complex),
            lmn.astype(dt), 1.0e8, device=CPU).numpy()
        assert got.dtype == want.dtype
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_sharded_ingest_is_item_15(tmp_path):
    """The baseline-sharded ingest (ROADMAP Queue 1 item 15; JAX
    ingest.py:77-119) in a one-rank gloo group of this process: the
    rank's block is the whole stream, flags and weights equal the
    single-device ingest's and JAX's sharded ingest on the 8-device mesh,
    the fraction at rtol 1e-6 (tests/test_pipeline.py:375-400). The
    group ends with the test. Several ranks: test_torch_sharded_stream.py.
    A mesh without the rows axis raises before any collective."""
    import torch.distributed as dist

    from ska_sdp_func_torch.parallel import make_mesh
    from ska_sdp_func_tpu.parallel import make_mesh as j_make_mesh

    vis, w = _rfi_stream()
    with pytest.raises(SdpInvalidArgumentError, match="no axis 'rows'"):
        tp.ingest_flag_and_weight_sharded(vis, w, AxisMesh(2, "cols"))
    j_flags, j_w, j_frac = ji.ingest_flag_and_weight_sharded(
        jnp.asarray(vis), jnp.asarray(w), j_make_mesh(8))
    flags0, w0, frac0 = tp.ingest_flag_and_weight(vis, w, device=CPU)
    mesh = make_mesh(1, device="cpu", rank=0,
                     init_method="file://" + str(tmp_path / "store"),
                     timeout=60.0)
    try:
        flags, wgt, frac = tp.ingest_flag_and_weight_sharded(
            vis, w, mesh, device=CPU)
    finally:
        dist.destroy_process_group()
    for got, want in ((flags, np.asarray(j_flags)), (wgt, np.asarray(j_w)),
                      (flags, flags0.numpy()), (wgt, w0.numpy())):
        np.testing.assert_array_equal(got.numpy(), want)
    assert float(frac) > 0
    np.testing.assert_allclose(float(frac), float(j_frac), rtol=1e-6)
    np.testing.assert_allclose(float(frac), float(frac0), rtol=1e-6)


def test_ingest_weights_solve_slice_matches_jax():
    """examples/full_pipeline_demo.py's scenario (16 times x 40 baselines
    x 2 channels, two point sources, broadband RFI at two (time,
    baseline) pairs, seed 2) on a 64^2 image instead of 128^2 (JAX's
    bucketed solve compiles for 110 s at 128^2 on the CPU, 27 s at 64^2):
    JAX's ingest_to_solver -> briggs_weights against the port's chain,
    then the weighted bucketed solve on 32^2 sub-grids against JAX's."""
    rng = np.random.default_rng(2)
    size, times, baselines, chans, theta = 64, 16, 40, 2, 0.002
    rows = times * baselines
    sky = np.zeros((size, size))
    src = [(size // 2 + 12, size // 2 - 9), (size // 2 - 20, size // 2 + 15)]
    sky[src[0]], sky[src[1]] = 1.0, 0.4
    uvw = rng.uniform(-1, 1, (rows, 3))
    uvw[:, :2] *= 0.3 * size / 2 / theta
    uvw[:, 2] *= 250.0
    freq0, dfreq = C_0, C_0 / 100
    flux, lmn = jg.image_to_flmn(jnp.asarray(sky), theta)
    vis = np.asarray(jg.dft(jnp.asarray(uvw), jnp.asarray(flux, complex),
                            jnp.asarray(lmn), freq0_hz=freq0,
                            dfreq_hz=dfreq, num_chan=chans))
    t_vis = tg.dft(uvw, flux.astype(complex), lmn, freq0_hz=freq0,
                   dfreq_hz=dfreq, num_chan=chans, device=CPU).numpy()
    assert np.abs(t_vis - vis).max() <= 1e-10 * np.abs(vis).max()
    vis4d = vis.reshape(times, baselines, chans, 1).copy()
    vis4d[9, 11, :, 0] += 120.0 - 80.0j
    vis4d[13, 33, :, 0] += -90.0 + 60.0j
    w4d = np.ones(vis4d.shape)

    j_vis, j_w, j_frac = ji.ingest_to_solver(jnp.asarray(vis4d),
                                             jnp.asarray(w4d))
    t_vis, t_w, t_frac = tp.ingest_to_solver(vis4d, w4d, device=CPU)
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    assert t_frac == pytest.approx(j_frac, rel=1e-6)
    assert t_w[9 * baselines + 11].max() == 0
    assert t_w[13 * baselines + 33].max() == 0

    freqs = freq0 + dfreq * np.arange(chans)
    uvw4 = uvw.reshape(times, baselines, 3)
    max_uv = jv.get_uv_range(jnp.asarray(uvw4), jnp.asarray(freqs))
    assert tv.get_uv_range(uvw4, freqs) == max_uv
    _, j_bw = jv.briggs_weights(jnp.asarray(uvw4), jnp.asarray(freqs),
                                max_uv, 0.5, jnp.asarray(w4d), 64)
    _, t_bw = tv.briggs_weights(uvw4, freqs, max_uv, 0.5, w4d, 64,
                                device=CPU)
    j_bw = np.asarray(j_bw)
    assert np.abs(t_bw.numpy() - j_bw).max() <= 1e-10 * np.abs(j_bw).max()
    weights = (t_bw.numpy()[..., 0].reshape(rows, chans)
               * t_w.numpy()).astype(np.float32)

    params = dict(subgrid_size=32, theta=theta, w_step=50.0, support=8,
                  oversampling=16384, w_support=4, w_oversampling=16384,
                  w_tower_height=4.0)
    case = dict(uvw=uvw, vis=t_vis.numpy().astype(np.complex64),
                jplan=j_plan(uvw, freq0, dfreq, chans, size, **params),
                tplan=t_plan(uvw, freq0, dfreq, chans, size, **params))
    j_model, tres = _solve_pair(case, weights=weights, bucketed=True,
                                loop_gain=0.2, threshold=1e-3)
    t_model = tres.model.numpy()
    assert np.abs(t_model - j_model).max() <= 1e-4 * np.abs(j_model).max()
    fluxes = [t_model[y - 2:y + 3, x - 2:x + 3].sum() for y, x in src]
    assert abs(fluxes[0] - 1.0) < 0.1 and abs(fluxes[1] - 0.4) < 0.1
