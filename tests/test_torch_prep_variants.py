"""exp_prep's stage sweep (P2a) against a jnp transcription.

experiments/exp_prep.py runs its whole sweep on the chip when it is
imported, so its kernel body (``variant(mode)``'s ``kern``) is transcribed
here in jnp over all slots at once, with the JAX package's own helpers
(``_clenshaw_rows``, ``_clenshaw_cols`` and ``_tap_coeffs_cached``), and
held against :func:`ska_sdp_func_torch.kernels.prep_variants.prep_variant`
(its plain version on CPU tensors) on the experiment's seeded fields at
CAP = 2 x 1024: the tap outputs at 1e-5 of max|JAX| (XLA may contract a
multiply-add where the port rounds twice), the zero outputs of each mode
bit for bit.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ska_sdp_func_torch.grid_data.wtower import (  # noqa: E402
    _tap_coeffs_cached as port_coeffs,
)
from ska_sdp_func_torch.kernels import prep_variants as pv  # noqa: E402
from ska_sdp_func_torch.utility.errors import (  # noqa: E402
    SdpInvalidArgumentError,
)
from ska_sdp_func_tpu.grid_data.wtower import _tap_coeffs_cached  # noqa: E402
from ska_sdp_func_tpu.kernels.packed_tap import (  # noqa: E402
    WIN_ROWS,
    _clenshaw_cols,
    _clenshaw_rows,
)

CAP, LANES, S, SW = 2 * 1024, 128, 8, 4
OV = WOV = 16 * 1024
TOL = 1e-5


def _fields():
    """exp_prep.py:44-53, at CAP slots."""
    rng = np.random.default_rng(3)
    ints = lambda hi: rng.integers(0, hi, CAP).astype(np.int32)  # noqa: E731
    u_off, u_frac, v_frac, w_row, iv0 = (ints(8), ints(OV), ints(OV),
                                         ints(WOV), ints(120))
    vre = rng.standard_normal(CAP).astype(np.float32)
    vim = rng.standard_normal(CAP).astype(np.float32)
    return u_off, u_frac, v_frac, w_row, iv0, vre, vim


def _kern_jnp(mode, u_off, u_frac, v_frac, w_row, iv0, vre, vim):
    """exp_prep.py:72-111 on all slots: (ub [16, CAP], vb [CAP, 128],
    sc [8, CAP])."""
    cu = jnp.asarray(np.asarray(_tap_coeffs_cached(S, OV), np.float32))
    cw = jnp.asarray(np.asarray(_tap_coeffs_cached(SW, WOV), np.float32))
    g = u_off.shape[0]
    if mode in ("full", "novband", "ubonly"):
        xu = np.float32(2.0 / OV) * u_frac.astype(jnp.float32) - 1.0
        uk = _clenshaw_rows(xu, cu)
        row16 = jax.lax.broadcasted_iota(jnp.int32, (WIN_ROWS, g), 0)
        ub = jnp.zeros((WIN_ROWS, g), jnp.float32)
        for s in range(S):
            ub = jnp.where(row16 == u_off + s, uk[s], ub)
    else:
        ub = jnp.zeros((WIN_ROWS, g), jnp.float32)
    if mode in ("full", "novband"):
        xw = np.float32(2.0 / WOV) * w_row.astype(jnp.float32) - 1.0
        wk = _clenshaw_rows(xw, cw)
        sc = jnp.concatenate([wk * vre, wk * vim], axis=0)
    else:
        sc = jnp.zeros((2 * SW, g), jnp.float32)
    if mode in ("full", "vbonly", "vbnochb"):
        iv = iv0.reshape(g, 1)
        vfc = v_frac.reshape(g, 1)
        if mode == "vbnochb":
            vk = vfc.astype(jnp.float32) * jnp.ones((1, S), jnp.float32)
        else:
            xv = np.float32(2.0 / OV) * vfc.astype(jnp.float32) - 1.0
            vk = _clenshaw_cols(xv, cu)
        col = jax.lax.broadcasted_iota(jnp.int32, (g, LANES), 1)
        vb = jnp.zeros((g, LANES), jnp.float32)
        for s in range(S):
            vb = jnp.where(col == iv + s, vk[:, s:s + 1], vb)
    else:
        vb = jnp.zeros((g, LANES), jnp.float32)
    return tuple(np.asarray(a) for a in (ub, vb, sc))


@pytest.mark.parametrize("mode", pv.MODES)
def test_prep_variant_matches_jnp(mode):
    f = _fields()
    want = _kern_jnp(mode, *(jnp.asarray(a) for a in f))
    u_off, u_frac, v_frac, w_row, iv0, vre, vim = (torch.as_tensor(a)
                                                   for a in f)
    coeffs = [torch.as_tensor(np.asarray(port_coeffs(s, OV), np.float32))
              for s in (S, SW)]
    before = pv.prep_variant.launches
    got = pv.prep_variant(mode, u_off, u_frac, w_row, vre, vim, iv0, v_frac,
                          *coeffs, OV, WOV)
    assert pv.prep_variant.launches == before
    do = dict(zip(("ub", "sc", "vb"), pv.stages(mode)))
    for name, g, w in zip(("ub", "vb", "sc"), got, want):
        assert g.shape == w.shape, name
        if do[name]:
            assert np.abs(w).max() > 0, name
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=TOL * np.abs(w).max(),
                                       err_msg=name)
            # Each placement is a copy: the zeros of the band agree exactly.
            np.testing.assert_array_equal(g.numpy() == 0, w == 0,
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          w.view(np.int32), err_msg=name)


def test_prep_variant_rejects_bad_operands():
    f = [torch.as_tensor(a) for a in _fields()]
    coeffs = [torch.as_tensor(np.asarray(port_coeffs(s, OV), np.float32))
              for s in (S, SW)]
    args = (f[0], f[1], f[3], f[5], f[6], f[4], f[2])
    with pytest.raises(SdpInvalidArgumentError):
        pv.prep_variant("half", *args, *coeffs, OV, WOV)
    with pytest.raises(SdpInvalidArgumentError):
        pv.prep_variant("full", *args, coeffs[0], coeffs[0], OV, WOV)
