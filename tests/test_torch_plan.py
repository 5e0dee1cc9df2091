"""The port's host planners build the JAX package's plans exactly.

Same uvw in, byte-identical arrays, the same digest and the same tasks
out (tolerance: none — both sides run the same f64 host arithmetic).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    make_inputs  # noqa: E402
from ska_sdp_func_torch.parallel import from_jax_plan  # noqa: E402
from ska_sdp_func_torch.parallel import plan_packed as t_plan_packed  # noqa
from ska_sdp_func_torch.parallel import plan_wstack as t_plan_wstack  # noqa
from ska_sdp_func_torch.pipeline import make_psf_plan as t_psf  # noqa: E402
from ska_sdp_func_torch.utility.errors import \
    SdpInvalidArgumentError  # noqa: E402
from ska_sdp_func_tpu.parallel import plan_wstack as j_plan_wstack  # noqa
from ska_sdp_func_tpu.parallel.packed import \
    plan_packed as j_plan_packed  # noqa: E402
from ska_sdp_func_tpu.pipeline.major_cycle import \
    make_psf_plan as j_psf  # noqa: E402


@pytest.fixture(scope="module")
def plans():
    uvw, _ = make_inputs()
    jp = j_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    tp = t_plan_wstack(uvw, FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE, **PARAMS)
    return dict(uvw=uvw, jax=jp, torch=tp,
                jax_psf=j_psf(jp, uvw), torch_psf=t_psf(tp, uvw))


def _fields(obj):
    """Dataclass fields as plain tuples (task objects flattened)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "tasks":
            v = tuple(dataclasses.astuple(t) for t in v)
        elif f.name == "wplan":
            v = _fields(v)
        elif f.name == "arrays":
            continue
        out[f.name] = v
    return out


def _assert_same_packed(jpp, tpp):
    assert _fields(tpp) == _fields(jpp)
    assert tpp.digest == jpp.digest
    assert list(tpp.arrays) == list(jpp.arrays)
    for name, a in jpp.arrays.items():
        b = tpp.arrays[name]
        assert b.dtype == a.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("which", ["main", "psf"])
def test_plan_wstack_matches_jax(plans, which):
    key = "" if which == "main" else "_psf"
    jp, tp = plans["jax" + key], plans["torch" + key]
    assert _fields(tp) == _fields(jp)
    assert len(tp.tasks) > 0


@pytest.mark.parametrize("which", ["main", "psf"])
@pytest.mark.parametrize("block_v, pad_to", [(None, 1), (128, 1), (128, 8)])
def test_plan_packed_matches_jax(plans, which, block_v, pad_to):
    key = "" if which == "main" else "_psf"
    jpp = j_plan_packed(plans["jax" + key], plans["uvw"], block_v=block_v,
                        pad_blocks_to=pad_to)
    tpp = t_plan_packed(plans["torch" + key], plans["uvw"], block_v=block_v,
                        pad_blocks_to=pad_to)
    _assert_same_packed(jpp, tpp)
    assert tpp.num_blocks % pad_to == 0


def test_plan_packed_takes_cpu_tensor(plans):
    import torch

    a = t_plan_packed(plans["torch"], plans["uvw"], block_v=128)
    b = t_plan_packed(plans["torch"], torch.as_tensor(plans["uvw"]),
                      block_v=128)
    assert a == b and a.digest == b.digest


def test_from_jax_plan_round_trip(plans):
    jpp = j_plan_packed(plans["jax"], plans["uvw"], block_v=128)
    tpp = t_plan_packed(plans["torch"], plans["uvw"], block_v=128)
    conv = from_jax_plan(jpp)
    assert conv == tpp
    assert hash(conv) == hash(tpp)
    _assert_same_packed(jpp, conv)
    assert from_jax_plan(plans["jax"]) == plans["torch"]


def test_from_jax_swiftly_round_trip():
    """A JAX SwiFTly plan carried across: the geometry, and Fn / Fb bit
    for bit, on the device asked for."""
    from ska_sdp_func_torch.parallel import from_jax_swiftly
    from ska_sdp_func_tpu.fourier_transforms import Swiftly

    for geometry in ((1024, 512, 256, 13.5625), (2048, 1024, 512, 12.0)):
        jsw = Swiftly(*geometry)
        conv = from_jax_swiftly(jsw, device="cpu")
        assert (conv.image_size, conv.yN_size, conv.xM_size, conv.W) \
            == geometry
        assert conv.get_contribution_size() == jsw.get_contribution_size()
        np.testing.assert_array_equal(conv.Fn.numpy(), np.asarray(jsw.Fn))
        np.testing.assert_array_equal(conv.Fb.numpy(), np.asarray(jsw.Fb))
        assert conv.Fn.device.type == "cpu"


def test_plan_packed_rejects_unsupported_geometry(plans):
    bad = t_plan_wstack(plans["uvw"], FREQ0, DFREQ, NUM_CHAN, IMAGE_SIZE,
                        **{**PARAMS, "subgrid_size": 96})
    with pytest.raises(SdpInvalidArgumentError):
        t_plan_packed(bad, plans["uvw"])
