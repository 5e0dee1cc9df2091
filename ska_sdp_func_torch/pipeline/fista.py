"""FISTA sparse imaging solver on the packed measurement operators.

Counterpart of ska_sdp_func_tpu.pipeline.fista. Beside the CLEAN solver
(:mod:`.major_cycle`) it solves the same inverse problem

    min_x  0.5 * || V - A x ||^2  +  lam * || x ||_1

with FISTA (Beck & Teboulle 2009): proximal gradient steps through the
exact forward/adjoint pair (``A`` = packed degrid, ``A^T`` = packed
grid; the K2 and K1 kernels on a CUDA device) with Nesterov momentum.
Every iteration is one packed degrid and one packed grid plus O(N^2)
elementwise work on the device, and one host read (the residual norm).

The step size is 1/L with L = ||M A^T A M|| estimated by power iteration
through the same operators (M: the CLEAN-window border mask). The power
iteration starts from ``np.random.default_rng(seed)``, as the JAX
package's does, so both packages start from the same vector.

With ``mesh`` (JAX fista.py:79-108) every rank passes the whole ``vis``
and ``uvw``, holds its block of the sorted stream (the plan padded to a
multiple of the rank count) and runs the block-sharded operators
(:meth:`~..parallel.packed.PackedGridder.grid_sorted_sharded`, whose
images are summed over the ranks); the residual norm is summed over the
ranks too, so every rank returns the same model.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import mesh_axis
from ..parallel.packed import _MeshDrivers, packed_gridder, plan_packed
from ..parallel.wstack import WStackPlan
from ..utility.tensors import host_uvw, to_device
from .major_cycle import _mask_border, _packed_residual, _solver_device


@dataclass
class FistaResult:
    """Solver outputs: sparse model image and objective history."""

    model: torch.Tensor
    residual_norm: List[float]


def _soft_threshold(x: torch.Tensor, lam) -> torch.Tensor:
    return torch.sign(x) * torch.clamp_min(x.abs() - lam, 0.0)


def _norm(*xs, group=None) -> torch.Tensor:
    """sqrt(sum of squares) over the tensors, on their device; with a
    process ``group``, over every rank's tensors."""
    squares = sum((x * x).sum() for x in xs)
    if group is not None:
        dist.all_reduce(squares, group=group)
    return torch.sqrt(squares)


def _operator_norm(gridder, mask: torch.Tensor, image_size: int,
                   n_iter: int = 8, seed: int = 0) -> float:
    """||M A^T A M|| by power iteration through the packed operators
    (``gridder.grid_sorted`` / ``degrid_sorted``; M = the CLEAN-window
    border mask: the 1/PSWF grid corrections diverge in the border ring,
    so the solve, like CLEAN's minor cycle, runs in the windowed
    interior)."""
    rng = np.random.default_rng(seed)
    x = mask * torch.as_tensor(rng.standard_normal((image_size, image_size)),
                               dtype=torch.float32, device=mask.device)
    sigma = 1.0
    for _ in range(n_iter):
        x = x / _norm(x)
        pred = gridder.degrid_sorted(x)
        x = mask * gridder.grid_sorted(pred.real.contiguous(),
                                       pred.imag.contiguous())
        sigma = float(_norm(x))
    return sigma


def fista_imager(plan: WStackPlan, vis, uvw, n_iter: int = 50,
                 lam_frac: float = 1e-3, weights=None,
                 border: Optional[int] = None, mesh=None,
                 device=None) -> FistaResult:
    """Run the FISTA sparse solve through the packed operators on
    ``device`` (``None``: the CUDA card, or the mesh's; CPU runs pass
    ``device="cpu"``).

    ``lam_frac``: the L1 weight as a fraction of the peak of the
    (normalised) dirty image, the peak-relative scaling CLEAN thresholds
    use. ``border`` (default image_size // 8) is the CLEAN-window margin:
    the model is solved on the interior, where the 1/PSWF grid
    corrections are well conditioned. ``vis``/``weights`` [rows, chan]
    and ``uvw`` [rows, 3] are NumPy arrays or tensors on any device.
    """
    uvw = host_uvw(uvw)
    vis = to_device(vis, _solver_device(mesh, device))
    dev = vis.device
    if mesh is None:
        g, group = packed_gridder(plan_packed(plan, uvw), device=dev), None
    else:
        n, _, group = mesh_axis(mesh)
        g = _MeshDrivers(packed_gridder(
            plan_packed(plan, uvw, pad_blocks_to=n), device=dev), mesh)
    w_sorted = None
    if weights is not None:
        w = to_device(weights, dev).to(vis.dtype)
        vis = vis * w
        w_sorted = g.sort(w)[0]
    vre, vim = g.sort(vis)

    n = plan.image_size
    if border is None:
        border = n // 8
    mask = _mask_border(torch.ones((n, n), dtype=torch.float32, device=dev),
                        int(border))

    def grid(re, im):
        return mask * g.grid_sorted(re, im)

    sigma = _operator_norm(g, mask, n)
    f32 = dict(dtype=torch.float32, device=dev)
    step = torch.tensor(1.0 / sigma, **f32)
    lam = torch.tensor(lam_frac, **f32) * grid(vre, vim).abs().max() / sigma

    x = torch.zeros((n, n), **f32)
    y = x
    t = torch.tensor(1.0, **f32)
    thresh = step * lam * sigma
    history: List[float] = []
    for _ in range(int(n_iter)):
        x, y, t, res_re, res_im = _fista_step(g, grid, vre, vim, w_sorted,
                                              step, thresh, x, y, t)
        history.append(float(_norm(res_re, res_im, group=group)))
    return FistaResult(model=x, residual_norm=history)


def _fista_step(g, grid, vre, vim, w_sorted, step, thresh, x_prev, y,
                t_prev):
    """One FISTA iteration on the device: the residual of ``y``'s
    prediction, its gradient image, the proximal step and the momentum.
    Returns (x, y_next, t, res_re, res_im)."""
    res_re, res_im = _packed_residual(vre, vim, g.degrid_sorted(y), w_sorted)
    x = _soft_threshold(y + step * grid(res_re, res_im), thresh)
    t = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t_prev * t_prev))
    y_next = x + ((t_prev - 1.0) / t) * (x - x_prev)
    return x, y_next, t, res_re, res_im
