"""The streaming engine's non-packable branch in its fast (bf16) mode.

``StreamingGridder``/``StreamingDegridder(fast=True)`` on a plan whose
fields do not fit the fused kernels' words run K6/K7 with a bf16 ``vk``,
whose dtype selects the bf16 mode of K8/K11. Held against the JAX engine's
same branch with ``fast=True`` (its Pallas kernels in interpret mode) on
the small scenario of tests/test_torch_streaming.py at oversampling 65536,
three grid and three predict chunks:

- image, both fast, taper-weighted: 2e-4 of peak. The f32 plans' tap
  fields may differ by one bin on <= 5 % of the slots (the device-plan
  test there), and the f32 sums come in another order;
- predictions of the two-point model, both fast: 5e-4 of peak;
- counters equal.

And the port's fast mode against its exact one, on both non-packable
geometries (oversampling 65536; 64-slot blocks), image taper-weighted and
two-point prediction: 5e-3 of peak, the JAX package's bf16 envelope
(tests/test_packed_driver.py:311-347).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    make_inputs, taper, two_point_image  # noqa: E402
from ska_sdp_func_torch.parallel import (  # noqa: E402
    StreamingDegridder,
    StreamingGridder,
    from_jax_plan,
    plan_stream,
)
from ska_sdp_func_tpu.parallel import (  # noqa: E402
    StreamingDegridder as JStreamingDegridder,
    StreamingGridder as JStreamingGridder,
    plan_stream as j_plan_stream,
    plan_wstack as j_plan_wstack,
    stream_tasks as j_stream_tasks,
)

CHUNK, CAP = 64, 20480
# Geometry -> (oversampling, block_v), as tests/test_torch_streaming.py.
NON_PACKABLE = {"oversampling": (65536, 128), "block_v": (16384, 64)}


def _chunks(rows):
    return [(lo, min(rows, lo + CHUNK)) for lo in range(0, rows, CHUNK)]


def _rel(got, want, weight=1.0):
    return np.abs((got - want) * weight).max() / np.abs(want * weight).max()


@pytest.fixture(scope="module")
def inputs():
    """The scenario and, per geometry, (JAX plan, JAX stream plan, port
    stream plan) on the base plan's task boxes."""
    uvw, vis = make_inputs()
    boxes = j_stream_tasks(j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN,
                                         IMAGE_SIZE, **PARAMS), uvw)
    plans = {}
    for geometry, (ov, bv) in NON_PACKABLE.items():
        jplan = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE,
                              **{**PARAMS, "oversampling": ov})
        plans[geometry] = (
            jplan, j_plan_stream(jplan, boxes, chunk_rows=CHUNK,
                                 block_v=bv, cap_slots=CAP),
            plan_stream(from_jax_plan(jplan), boxes, chunk_rows=CHUNK,
                        block_v=bv, cap_slots=CAP))
    return dict(uvw=uvw, vis=vis, rows=uvw.shape[0], plans=plans)


def _port_run(inputs, sp, fast):
    """(image, predictions of the two-point model, grid counters, predict
    counters) of the port on the CPU."""
    sg = StreamingGridder(sp, fast=fast, device="cpu")
    for lo, hi in _chunks(inputs["rows"]):
        sg.accumulate(inputs["uvw"][lo:hi], inputs["vis"][lo:hi])
    sd = StreamingDegridder(sp, fast=fast, device="cpu").set_model(
        two_point_image())
    pred = torch.cat([sd.predict(inputs["uvw"][lo:hi])
                      for lo, hi in _chunks(inputs["rows"])]).numpy()
    sd.check()
    return (sg.finalize().numpy(), pred, [int(x) for x in sg.counters()],
            [int(x) for x in sd.counters()])


@pytest.fixture(scope="module")
def non_packable_fast(inputs):
    """The JAX engine's non-packable branch with ``fast=True`` at
    oversampling 65536, and the port's same run."""
    jplan, jsp, sp = inputs["plans"]["oversampling"]
    jsg = JStreamingGridder(jsp, fast=True)
    assert not jsg._engine._pack
    for lo, hi in _chunks(inputs["rows"]):
        jsg.accumulate(inputs["uvw"][lo:hi], inputs["vis"][lo:hi])
    jsd = JStreamingDegridder(jsp, fast=True).set_model(two_point_image())
    j_pred = np.concatenate([np.asarray(jsd.predict(inputs["uvw"][lo:hi]))
                             for lo, hi in _chunks(inputs["rows"])])
    return dict(jplan=jplan, j_img=np.asarray(jsg.finalize()), j_pred=j_pred,
                j_counts=[int(x) for x in jsg.counters()],
                jd_counts=[int(x) for x in jsd.counters()],
                port=_port_run(inputs, sp, fast=True))


def test_non_packable_fast_gridder_matches_jax(inputs, non_packable_fast):
    n = non_packable_fast
    img, _, counts, _ = n["port"]
    assert img.dtype == np.float32 and img.shape == (IMAGE_SIZE, IMAGE_SIZE)
    assert _rel(img, n["j_img"], taper(n["jplan"])) <= 2e-4
    assert counts == n["j_counts"] == [inputs["rows"] * NUM_CHAN, 0, 0]


def test_non_packable_fast_degridder_matches_jax(inputs, non_packable_fast):
    n = non_packable_fast
    _, pred, _, counts = n["port"]
    assert pred.dtype == np.complex64
    assert pred.shape == (inputs["rows"], NUM_CHAN)
    np.testing.assert_allclose(pred, n["j_pred"],
                               atol=5e-4 * np.abs(n["j_pred"]).max())
    assert counts == n["jd_counts"] == [inputs["rows"] * NUM_CHAN, 0, 0]


@pytest.mark.parametrize("geometry", list(NON_PACKABLE))
def test_non_packable_fast_matches_exact(inputs, geometry):
    """bf16 against f32 on the same plan: the JAX package's 5e-3 bf16
    envelope, image taper-weighted and two-point prediction."""
    jplan, _, sp = inputs["plans"][geometry]
    f_img, f_pred, f_cnt, fd_cnt = _port_run(inputs, sp, fast=True)
    e_img, e_pred, e_cnt, ed_cnt = _port_run(inputs, sp, fast=False)
    assert _rel(f_img, e_img, taper(jplan)) <= 5e-3
    assert _rel(f_pred, e_pred) <= 5e-3
    # The modes differ: bf16 rounds the taps.
    assert np.abs(f_img - e_img).max() > 0
    assert f_cnt == e_cnt and fd_cnt == ed_cnt
