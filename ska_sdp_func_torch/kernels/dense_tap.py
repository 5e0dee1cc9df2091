"""Gridding / degridding of one w-plane as dense banded products.

Counterpart of ska_sdp_func_tpu.kernels.dense_tap (reference
sdp_gridder_wtower_uvw.cpp:124-173 degrid, :429-481 grid). With
``A_u[v, u] = uv_kernel[u_row_v, u - iu0_v]`` (zero outside the support
band, and outside the sub-grid) and ``A_v`` likewise, one w-plane's
scatter into layer ``l`` of the tower stack is

    subgrid_l += A_u^T @ diag(vis * w_kernel[w_row, l]) @ A_v

and degridding is its adjoint, ``vis_l = w_l * rowsum((A_u @ sub_l) *
A_v)``. Torch ops of any dtype: this is the complex128 path of the
per-plane drivers, where no CUDA kernel exists for f64, and at
complex64 the plain version of the ``grid_plane`` / ``degrid_plane``
kernels (:mod:`.tower_tap`).
"""

import torch


def band_matrix(i0: torch.Tensor, taps: torch.Tensor,
                size: int) -> torch.Tensor:
    """``A[v, u] = taps[v, u - i0[v]]`` for ``u`` in ``[i0, i0 + S)``
    inside ``[0, size)``, zero elsewhere. Each entry receives at most one
    tap, so the scatter equals the JAX version's sum of selects."""
    num_v, support = taps.shape
    cols = i0.to(torch.int64)[:, None] + torch.arange(support,
                                                      device=taps.device)
    inside = (cols >= 0) & (cols < size)
    band = torch.zeros((num_v, size), dtype=taps.dtype, device=taps.device)
    band.scatter_add_(1, cols.clamp(0, size - 1),
                      torch.where(inside, taps, torch.zeros_like(taps)))
    return band


def flatten_geom(geom, uv_kernel: torch.Tensor, w_kernel: torch.Tensor):
    """[R, C] geometry -> flat [V] arrays and the gathered kernel rows
    ``uk``/``vk`` [V, S], ``wk`` [V, Sw]."""
    mask, iu0, iv0, u_row, v_row, w_row = geom
    return (mask.reshape(-1), iu0.reshape(-1), iv0.reshape(-1),
            uv_kernel[u_row.reshape(-1).to(torch.int64)],
            uv_kernel[v_row.reshape(-1).to(torch.int64)],
            w_kernel[w_row.reshape(-1).to(torch.int64)])


def grid_plane_dense(subgrids: torch.Tensor, vis: torch.Tensor,
                     uv_kernel: torch.Tensor, w_kernel: torch.Tensor,
                     geom, support: int, w_support: int) -> torch.Tensor:
    """Scatter one w-plane's (row, channel) taps into the ``[Sw, N, N]``
    stack; returns ``subgrids + contribution``."""
    size = subgrids.shape[-1]
    mask, iu0, iv0, uk, vk, wk = flatten_geom(geom, uv_kernel, w_kernel)
    vis_flat = torch.where(mask, vis.reshape(-1),
                           torch.zeros((), dtype=vis.dtype,
                                       device=vis.device))
    a_u = band_matrix(iu0, uk, size).to(vis.dtype)          # [V, N]
    a_v = band_matrix(iv0, vk, size).to(vis.dtype)          # [V, N]
    wk = wk.to(vis.dtype)
    out = [(a_u * (vis_flat * wk[:, layer])[:, None]).T @ a_v
           for layer in range(w_support)]
    return subgrids + torch.stack(out)


def degrid_plane_dense(subgrids: torch.Tensor, uv_kernel: torch.Tensor,
                       w_kernel: torch.Tensor, geom, support: int,
                       w_support: int) -> torch.Tensor:
    """Gather one w-plane's visibilities from the ``[Sw, N, N]`` stack;
    returns ``[R, C]`` (masked entries zero)."""
    shape_rc = geom[0].shape
    size = subgrids.shape[-1]
    cdtype = subgrids.dtype
    mask, iu0, iv0, uk, vk, wk = flatten_geom(geom, uv_kernel, w_kernel)
    a_u = band_matrix(iu0, uk, size).to(cdtype)
    a_v = band_matrix(iv0, vk, size).to(cdtype)
    acc = None
    for layer in range(w_support):
        contrib = ((a_u @ subgrids[layer]) * a_v).sum(dim=1)
        term = wk[:, layer].to(cdtype) * contrib
        acc = term if acc is None else acc + term
    acc = torch.where(mask, acc, torch.zeros((), dtype=cdtype,
                                             device=acc.device))
    return acc.reshape(shape_rc)
