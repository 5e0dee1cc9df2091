"""Prolate spheroidal wave functions (PSWF), host side.

Counterpart of the host path of ska_sdp_func_tpu.fourier_transforms.pswf:
`scipy.special.pro_ang1`, bit-matching the reference's specfun numerics
(sdp_pswf.cpp:569-601). Everything here runs at plan time in NumPy f64;
the kernels and grid corrections consume the sampled tables.
"""

import numpy as np

from ..utility.errors import SdpInvalidArgumentError


def _pro_ang1(m: int, n: int, c: float, x):
    """scipy prolate angular function of the first kind, elementwise;
    zero outside |x| < 1 (sdp_pswf.cpp:680-685)."""
    from scipy.special import pro_ang1

    x = np.asarray(x, dtype=np.float64)
    inside = np.abs(x) < 1.0
    safe = np.where(inside, x, 0.0)
    vals = pro_ang1(m, n, c, safe)[0]
    return np.where(inside, vals, 0.0)


def generate_pswf(m: int, c: float, size: int,
                  end_correction: bool = False) -> np.ndarray:
    """Sample the PSWF over ``size`` points, x_k = 2*(k - size//2)/size.

    The first sample (x = -1 for even size) is zero, or 1e-15 when
    ``end_correction`` is set (sdp_gridder_utils.cpp:1329-1350).
    """
    if size < 1:
        raise SdpInvalidArgumentError(f"size must be >= 1; got {size}")
    k = np.arange(size)
    x = 2.0 * (k - size // 2) / size
    out = _pro_ang1(m, m, c, x)
    if size % 2 == 0:
        out[0] = 1e-15 if end_correction else 0.0
    return out


def pswf_evaluate_host(m: int, c: float, x) -> np.ndarray:
    """Pointwise host evaluation; zero outside |x| < 1."""
    return _pro_ang1(m, m, c, x)
