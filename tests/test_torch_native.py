"""The port's host runtime is its own copy of the JAX package's source.

``ska_sdp_func_torch.native`` compiles ``src/host_runtime.cpp`` beside
it; the copy must stay byte-identical to the JAX package's
``native/src/host_runtime.cpp`` so that both packages build the same
plans (the plan-digest tests in test_torch_plan.py hold the plans
themselves).
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ska_sdp_func_torch")


def test_host_runtime_copy_is_byte_identical():
    with open(os.path.join(REPO, "ska_sdp_func_tpu", "native", "src",
                           "host_runtime.cpp"), "rb") as f:
        reference = f.read()
    with open(os.path.join(PORT, "native", "src", "host_runtime.cpp"),
              "rb") as f:
        copy = f.read()
    assert copy == reference


def test_native_builds_from_the_port():
    from ska_sdp_func_torch import native

    src = os.path.realpath(native._SRC)
    assert src.startswith(os.path.realpath(PORT) + os.sep)
    assert os.path.isfile(src)


# ---------------------------------------------------------------------------
# The helpers against the JAX package's native module on the same inputs
# (JAX tests/test_native.py:51 is the oracle of the sort and the sum).
# ---------------------------------------------------------------------------

def _jax_native():
    import pytest

    pytest.importorskip("jax")
    from ska_sdp_func_tpu import native

    return native


def _uvw(seed=42, rows=500):
    import numpy as np

    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-1, 1, (rows, 3)) * [[8000.0, 8000.0, 400.0]]
    uvw[::7, 2] = uvw[3, 2]          # ties: the sort must keep row order
    return uvw


def test_available():
    from ska_sdp_func_torch import native

    assert native.available() is True
    assert {"available", "packed_plan_arrays", "prefix_sum",
            "sort_rows_by_w"} <= set(native.__all__)
    assert set(native.__all__) == set(_jax_native().__all__)


def test_sort_rows_by_w_matches_jax():
    import numpy as np

    from ska_sdp_func_torch import native

    uvw = _uvw()
    perm = native.sort_rows_by_w(uvw)
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(perm, _jax_native().sort_rows_by_w(uvw))
    np.testing.assert_array_equal(perm,
                                  np.argsort(uvw[:, 2], kind="stable"))
    assert native.sort_rows_by_w(np.zeros((0, 3))).shape == (0,)


def test_prefix_sum_matches_jax():
    import numpy as np

    from ska_sdp_func_torch import native

    out = native.prefix_sum(np.asarray([3, 0, 5, 2], np.int64))
    assert out.dtype == np.int64
    np.testing.assert_array_equal(out, [0, 3, 3, 8, 10])
    counts = np.random.default_rng(3).integers(0, 1 << 40, 1000)
    np.testing.assert_array_equal(native.prefix_sum(counts),
                                  _jax_native().prefix_sum(counts))
    np.testing.assert_array_equal(native.prefix_sum([]), [0])


def _planner_inputs(block_v):
    """The arguments ``plan_packed`` hands the planner, on the packed
    scenario of tests/test_torch_packed_driver.py."""
    import numpy as np

    from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, \
        PARAMS, make_inputs
    from ska_sdp_func_torch import native
    from ska_sdp_func_torch.parallel import plan_wstack

    uvw, _ = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    d, height, w_step = plan.eff_sg_dist, plan.w_tower_height, plan.w_step
    task_id, boxes, wmin_t, wmax_t = native.packed_tasks(
        uvw, FREQ0, DFREQ, NUM_CHAN, d, plan.w_stack_dist)
    off_w_t = np.trunc(boxes[:, 0] * height).astype(np.int64)
    first_t = np.floor(wmin_t / w_step - 1e-5).astype(np.int64) - off_w_t
    last_t = np.ceil(wmax_t / w_step + 1e-5).astype(np.int64) - off_w_t + 1
    num_planes_t = 1 + last_t - first_t
    num_slabs = int((num_planes_t + plan.w_support - 1).max()) \
        - plan.w_support + 1
    kernel = plan.kernel()
    return [uvw, FREQ0, DFREQ, NUM_CHAN, d, plan.theta, w_step, height,
            plan.oversampling, plan.w_oversampling, plan.subgrid_size,
            plan.support, plan.w_support, task_id, first_t, off_w_t,
            num_planes_t, num_slabs, plan.subgrid_size // 8, block_v,
            kernel.uv_kernel, kernel.w_kernel]


KEYS = ("sort_index", "valid", "u_off", "iv0", "uk", "vk", "wk", "u_frac",
        "v_frac", "w_row", "counts", "padded", "total", "block_v")


def test_packed_plan_arrays_matches_jax():
    """Array by array, with the block size chosen (None) and given."""
    import numpy as np

    from ska_sdp_func_torch import native

    for block_v in (None, 128):
        args = _planner_inputs(block_v)
        got = native.packed_plan_arrays(*args)
        want = _jax_native().packed_plan_arrays(*args)
        assert tuple(got) == KEYS == tuple(want)
        assert got["valid"].dtype == bool
        for key in KEYS:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
        assert got["total"] == int(got["padded"].sum())


def test_packed_plan_arrays_raises_on_the_invariant():
    """A visibility outside its task's w-tower range raises, as in JAX."""
    import pytest

    from ska_sdp_func_torch import native
    from ska_sdp_func_torch.utility.errors import SdpRuntimeError

    args = _planner_inputs(128)
    args[16] = args[16] * 0                  # no task has a w-plane
    with pytest.raises(SdpRuntimeError, match="outside their task"):
        native.packed_plan_arrays(*args)
    with pytest.raises(Exception, match="outside their task"):
        _jax_native().packed_plan_arrays(*args)


def test_plan_packed_goes_through_packed_plan_arrays(monkeypatch):
    """One planner call a plan, and the plan's digest is the JAX
    package's."""
    from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, \
        PARAMS, make_inputs
    from ska_sdp_func_torch import native
    from ska_sdp_func_torch.parallel import plan_packed, plan_wstack

    _jax_native()
    from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack
    from ska_sdp_func_tpu.parallel.packed import plan_packed as j_plan_packed

    calls = []
    real = native.packed_plan_arrays
    monkeypatch.setattr(native, "packed_plan_arrays",
                        lambda *a: calls.append(a) or real(*a))
    uvw, _ = make_inputs()
    plan = plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    pplan = plan_packed(plan, uvw, block_v=128)
    assert len(calls) == 1
    jplan = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    assert pplan.digest == j_plan_packed(jplan, uvw, block_v=128).digest
    assert not set(pplan.arrays) & {"counts", "padded", "total", "block_v"}
