"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where no CUDA device is present (decided inside
the fixture, never at import). Run on a machine with a card, where jax
is absent, with::

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

Tolerances: the grid stack at 1e-5 of max|stack| (f32 atomics reorder
the sums); degridded visibilities at 1e-5 of max|vis| (same products,
other summation order).
"""

import numpy as np
import pytest
import torch

from _torch_scenario import DFREQ, FREQ0, IMAGE_SIZE, NUM_CHAN, PARAMS, \
    make_inputs, two_point_image
from ska_sdp_func_torch.grid_data import grid_correct_pswf
from ska_sdp_func_torch.kernels import packed_tap as tk
from ska_sdp_func_torch.parallel import PackedGridder, plan_packed, \
    plan_wstack
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
        cpu={m: PackedGridder(pplan, **kw) for m, kw in MODES.items()},
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
