"""ES-kernel parameter selection over the (support, sigma, beta) space.

The port's own copy of ska_sdp_func_tpu.grid_data.es_params (pure NumPy;
the same arithmetic, so both packages pick identical kernels).

Role match: ``sdp_calculate_params_from_epsilon`` (ska-sdp-func
grid_data/sdp_gridder_uvw_es_fft_utils.cpp:225-537), which picks
(support, oversampling sigma, beta) from a 244-entry tuned database so
a requested accuracy ``epsilon`` is met with the smallest padded grid —
the grid-memory-vs-support trade SKA pipelines tune (sigma 1.15..2.5).

This implementation derives the same trade space analytically instead
of shipping a measured table: for each (support w, sigma) it computes
the NUFFT aliasing error of the exponential-of-semicircle kernel from
its continuous Fourier transform and optimises beta over a dense scan.
With the kernel viewed in grid coordinates, ``psi(u) = es(u / (w/2))``
on |u| <= w/2, its transform at frequency ``s`` (cycles per grid cell)
is

    psi_hat(s) = w * int_0^1 es(x) cos(pi s w x) dx

(the exact quadrature form the conv-correction uses, es_fft.py
``_conv_corr``). Sampling at integer grid cells aliases ``s +- m``;
image pixels live in the band |s| <= 1/(2 sigma), so the relative
aliasing error at s is

    E(s) = sqrt(sum_{m>=1} psi_hat(m - s)^2 + psi_hat(m + s)^2)
           / psi_hat(s)

and the kernel's achievable epsilon is ``max_s E(s)`` over the band
(worst at the band edge). This is the standard windowed-NUFFT error
estimate (Barnett et al. 2019); the resulting (support, sigma) ->
epsilon map reproduces the shape of the reference's measured DB and is
slightly conservative (max-over-band vs measured RMS).

Selection mirrors the reference's objective: among all (support <=
max_support, sigma in the DB's 1.15..2.5 range) meeting epsilon, keep
per-support the smallest sigma (found by bisection — both the aliasing
error and the correction dynamic range improve monotonically with
sigma at optimal beta), then pick the candidate minimising the padded
grid size; the conv-correction dynamic range is capped at 10 like the
reference's ``K_corr_range`` cut.
"""

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from ..fourier_transforms.fft import padded_fft_size

# The reference DB's oversampling grid (sigma axis).
SIGMA_MIN, SIGMA_MAX, SIGMA_STEP = 1.15, 2.50, 0.05
_N_QUAD = 512            # GL order; integrand oscillates up to ~pi*s*w
_N_ALIAS = 8             # aliases summed (psi_hat decays fast beyond)
_N_BAND = 17             # band sample points for the max-over-band
_CORR_RANGE_MAX = 10.0   # reference feasibility cut (K_corr_range)


@lru_cache(maxsize=None)
def _gl_nodes():
    nodes, weights = np.polynomial.legendre.leggauss(2 * _N_QUAD)
    pos = nodes > 0
    return nodes[pos], weights[pos]


def _psi_hat_multi(support: int, betas: np.ndarray,
                   s: np.ndarray) -> np.ndarray:
    """[n_beta, n_s] of w * int_0^1 es(x) cos(pi s w x) dx."""
    x, wq = _gl_nodes()
    ker = np.exp(np.asarray(betas, np.float64)[:, None]
                 * (np.sqrt(1.0 - x * x) - 1.0)) * wq    # [nb, nq]
    phases = np.cos(np.pi * np.asarray(s, np.float64)[:, None]
                    * support * x)                        # [ns, nq]
    return support * (ker @ phases.T)


def _band_errors(support: int, sigma: float,
                 betas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(eps [n_beta], corr_range [n_beta]) at the given betas."""
    s = np.linspace(0.0, 0.5 / sigma, _N_BAND)
    m = np.arange(1, _N_ALIAS + 1, dtype=np.float64)
    s_all = np.concatenate([s, (m[:, None] - s[None, :]).ravel(),
                            (m[:, None] + s[None, :]).ravel()])
    psi = _psi_hat_multi(support, betas, s_all)          # [nb, ns_all]
    main = psi[:, :_N_BAND]
    tails = (psi[:, _N_BAND:_N_BAND * (1 + _N_ALIAS)] ** 2
             + psi[:, _N_BAND * (1 + _N_ALIAS):] ** 2)
    tails = tails.reshape(len(betas), _N_ALIAS, _N_BAND).sum(axis=1)
    eps = np.max(np.sqrt(tails) / np.abs(main), axis=1)
    corr = main[:, 0] / np.maximum(main[:, -1], 1e-300)
    return eps, corr


def alias_error(support: int, sigma: float, beta: float) -> float:
    """max over the image band of the relative aliasing error E(s)."""
    return float(_band_errors(support, sigma,
                              np.array([beta]))[0][0])


def corr_range(support: int, sigma: float, beta: float) -> float:
    """Conv-correction dynamic range C(0)/C(band edge)."""
    return float(_band_errors(support, sigma,
                              np.array([beta]))[1][0])


@lru_cache(maxsize=None)
def tune_beta(support: int, sigma: float) -> Tuple[float, float, float]:
    """(beta, epsilon, corr_range) minimising the aliasing error.

    Two vectorised scans over beta in [0.8, 2.8] * support — E(beta)
    has a clear global basin (small beta: mainlobe aliases; large
    beta: truncation at |x|=1) with small secondary wiggles, so a
    coarse scan plus a fine scan around the coarse minimum nails it.
    """
    bs = np.linspace(0.8 * support, 2.8 * support, 61)
    eps, _ = _band_errors(support, sigma, bs)
    k = int(np.argmin(eps))
    lo, hi = bs[max(k - 1, 0)], bs[min(k + 1, len(bs) - 1)]
    bs2 = np.linspace(lo, hi, 33)
    eps2, corr2 = _band_errors(support, sigma, bs2)
    k2 = int(np.argmin(eps2))
    return float(bs2[k2]), float(eps2[k2]), float(corr2[k2])


def _sigma_grid():
    n = int(round((SIGMA_MAX - SIGMA_MIN) / SIGMA_STEP)) + 1
    return [round(SIGMA_MIN + i * SIGMA_STEP, 2) for i in range(n)]


def _feasible(support: int, sigma: float, epsilon: float) -> bool:
    _, eps, corr = tune_beta(support, sigma)
    return eps <= epsilon and corr <= _CORR_RANGE_MAX


def calculate_params_from_epsilon(
        epsilon: float, image_size: int, single_precision: bool,
        sigma: Optional[float] = None,
) -> Tuple[int, int, float, float]:
    """(grid_size, support, beta, sigma_eff) meeting ``epsilon``.

    ``sigma=None`` searches the DB's 1.15..2.5 range and picks the
    candidate minimising the padded grid size (the reference's
    objective); a numeric ``sigma`` pins the oversampling factor (the
    grid-memory budget) and selects the smallest feasible support.
    Raises ValueError when no (support <= max) kernel meets epsilon —
    same failure mode as the reference's epsilon bounds check
    (sdp_gridder_uvw_es_fft.cpp:316-323 limits epsilon >= 1e-12
    double / 1e-5 float; infeasible combinations surface here).
    """
    # The reference rejects epsilons below what each precision's
    # execution can deliver (sdp_gridder_uvw_es_fft.cpp:316-323):
    # >= 1e-5 single, >= 1e-12 double. Without this cut the analytic
    # search can return kernels promising accuracies the f32 pipeline
    # cannot meet.
    eps_floor = 1e-5 if single_precision else 1e-12
    if not epsilon >= eps_floor:
        raise ValueError(
            f"epsilon={epsilon:g} below the "
            f"{'single' if single_precision else 'double'}-precision "
            f"floor {eps_floor:g} (reference bound, "
            "sdp_gridder_uvw_es_fft.cpp:316-323)")
    max_support = 8 if single_precision else 16
    best = None  # (grid_size, support, sigma)
    if sigma is None:
        grid = _sigma_grid()
        for w in range(4, max_support + 1):
            # Smallest feasible sigma by bisection: feasibility is
            # monotone in sigma (larger sigma -> smaller aliasing
            # error and smaller correction range at optimal beta).
            if not _feasible(w, grid[-1], epsilon):
                continue
            lo, hi = 0, len(grid) - 1
            while lo < hi:
                mid = (lo + hi) // 2
                if _feasible(w, grid[mid], epsilon):
                    hi = mid
                else:
                    lo = mid + 1
            sg = grid[lo]
            gs = padded_fft_size(int(math.ceil(image_size * sg)))
            if best is None or gs < best[0] \
                    or (gs == best[0] and w < best[1]):
                best = (gs, w, sg)
    else:
        for w in range(4, max_support + 1):
            if _feasible(w, float(sigma), epsilon):
                gs = padded_fft_size(int(math.ceil(image_size * sigma)))
                best = (gs, w, float(sigma))
                break
    if best is None:
        lo = sigma if sigma is not None else SIGMA_MIN
        hi = sigma if sigma is not None else SIGMA_MAX
        raise ValueError(
            f"no ES kernel (support <= {max_support}, sigma in "
            f"{lo}..{hi}) reaches epsilon={epsilon:g}")
    gs, w, sg = best
    # Rounding the grid up raises the effective oversampling; retune
    # beta there — strictly more accurate for the same cost.
    sigma_eff = gs / float(image_size)
    beta, _, _ = tune_beta(w, round(sigma_eff, 6))
    return gs, w, beta, sigma_eff
