"""Grid correction: PSWF image-response division and w-stacking screens
(:func:`grid_correct_pswf`, :func:`w_screen_stack`,
:func:`grid_correct_w_stack`).

Counterpart of ska_sdp_func_tpu.grid_data.grid_correct (reference:
sdp_gridder_grid_correct.cpp:19-115). Both corrections depend only on
static plan parameters, so they are computed on the host in f64 (the
PSWF scale is cached) and applied on the tensor's device.
"""

from functools import lru_cache

import numpy as np
import torch

from ..fourier_transforms.pswf import generate_pswf, pswf_evaluate_host
from ..utility.tensors import as_tensors, resolve_device
from .kernels import lm_to_n


@lru_cache(maxsize=32)
def _pswf_correction_host(image_size: int, theta: float, w_step: float,
                          shear_u: float, shear_v: float, support: int,
                          w_support: int, num_l: int, num_m: int,
                          facet_offset_l: int, facet_offset_m: int
                          ) -> np.ndarray:
    """1 / (pswf_l * pswf_m * pswf_n) over the facet, float64."""
    pswf_lm = generate_pswf(0, support * (np.pi / 2), image_size,
                            end_correction=True)
    pl = np.arange(num_l) - num_l // 2 + facet_offset_l
    pm = np.arange(num_m) - num_m // 2 + facet_offset_m
    pswf_l = pswf_lm[pl + image_size // 2]
    pswf_m = pswf_lm[pm + image_size // 2]
    if w_support > 0:
        l = pl * theta / image_size
        m = pm * theta / image_size
        ll, mm = np.meshgrid(l, m, indexing="ij")
        n = lm_to_n(ll, mm, shear_u, shear_v)
        n_x = np.abs(n * 2.0 * w_step)
        pswf_n = np.where(n_x < 1.0,
                          pswf_evaluate_host(0, w_support * (np.pi / 2),
                                             np.minimum(n_x, 1.0 - 1e-15)),
                          1.0)
    else:
        # No w-kernel: skip the pswf_n term (the reference's
        # pswf_n_c > 0 guard, sdp_gridder_grid_correct.cpp:61).
        pswf_n = 1.0
    return 1.0 / (pswf_l[:, None] * pswf_m[None, :] * pswf_n)


def grid_correct_pswf(image_size: int, theta: float, w_step: float,
                      shear_u: float, shear_v: float, support: int,
                      w_support: int, facet, facet_offset_l: int = 0,
                      facet_offset_m: int = 0, device=None) -> torch.Tensor:
    """Divide the facet by the PSWF image responses (returns a new
    tensor). The f64 scale is cast to the facet's real precision before
    the multiply, as in the JAX version. A NumPy facet is copied to
    ``device`` (None: the CUDA card); a tensor keeps its device."""
    (facet,) = as_tensors(facet, device=device)
    num_l, num_m = facet.shape
    scale = _pswf_correction_host(
        int(image_size), float(theta), float(w_step), float(shear_u),
        float(shear_v), int(support), int(w_support), int(num_l),
        int(num_m), int(facet_offset_l), int(facet_offset_m))
    real_dtype = facet.real.dtype if facet.is_complex() else (
        facet.dtype if facet.is_floating_point() else torch.float32)
    return facet * torch.as_tensor(scale, dtype=real_dtype,
                                   device=facet.device)


def w_screen_stack(image_size: int, theta: float, w_step: float,
                   shear_u: float, shear_v: float, w_offsets,
                   facet_offset_l: int = 0, facet_offset_m: int = 0,
                   num_l: int = None, num_m: int = None,
                   dtype=torch.complex128, device=None) -> torch.Tensor:
    """Stacked w-stacking screens ``exp(+i 2 pi w_step w_offset n)``,
    ``[P] -> [P, num_l, num_m]`` (grid_corr_w_stack,
    sdp_gridder_grid_correct.cpp:77-115), built in f64 on the host and
    returned as ``dtype`` on ``device`` (``None``: the CUDA card; CPU runs
    pass ``device="cpu"``)."""
    num_l = image_size if num_l is None else num_l
    num_m = image_size if num_m is None else num_m
    pl = np.arange(num_l) - num_l // 2 + facet_offset_l
    pm = np.arange(num_m) - num_m // 2 + facet_offset_m
    l = pl * (theta / image_size)
    m = pm * (theta / image_size)
    ll, mm = np.meshgrid(l, m, indexing="ij")
    n = lm_to_n(ll, mm, shear_u, shear_v)
    ang = (2.0 * np.pi * w_step) * n
    offs = np.asarray(w_offsets, np.float64)
    ang = ang[None] * offs[:, None, None]
    screens = np.cos(ang) + 1j * np.sin(ang)
    return torch.as_tensor(screens).to(device=resolve_device(device),
                                       dtype=dtype)


def grid_correct_w_stack(image_size: int, theta: float, w_step: float,
                         shear_u: float, shear_v: float, facet,
                         facet_offset_l: int = 0, facet_offset_m: int = 0,
                         w_offset: int = 0, inverse: bool = False,
                         device=None) -> torch.Tensor:
    """Apply the w-stacking screen ``exp(2 pi i w_step n w_offset)``
    (grid_corr_w_stack, sdp_gridder_grid_correct.cpp:77-115): divide
    when ``inverse`` is False, multiply when True, as the JAX version
    does. A no-op for ``w_offset == 0``; the facet must be complex. The
    facet is taken as in :func:`grid_correct_pswf`."""
    (facet,) = as_tensors(facet, device=device)
    if w_offset == 0:
        return facet
    num_l, num_m = facet.shape
    screen = torch.as_tensor(_w_screen_host(
        int(image_size), float(theta), float(w_step), float(shear_u),
        float(shear_v), int(w_offset), int(facet_offset_l),
        int(facet_offset_m), int(num_l), int(num_m))).to(
            device=facet.device, dtype=facet.dtype)
    return facet * screen if inverse else facet / screen


@lru_cache(maxsize=64)
def _w_screen_host(image_size, theta, w_step, shear_u, shear_v, w_offset,
                   facet_offset_l, facet_offset_m, num_l, num_m):
    """One w-screen, host complex128 (cached: the drivers apply the same
    per-plane screens on every call)."""
    return w_screen_stack(image_size, theta, w_step, shear_u, shear_v,
                          [w_offset], facet_offset_l, facet_offset_m, num_l,
                          num_m, device="cpu")[0].numpy()
