"""ES-FFT gridder ("nifty"/ducc0-style, exponential-of-semicircle kernel).

Counterpart of ska_sdp_func_tpu.grid_data.es_fft (reference:
grid_data/sdp_gridder_uvw_es_fft.{h,cpp}, _utils.cpp, _kernels.cu).

Algorithm (kernels at sdp_gridder_uvw_es_fft_kernels.cu):

- gridding (`sdp_cuda_nifty_gridder_gridding_3d`, :127): per (row, chan),
  flip uvw so w >= 0 (conjugating the visibility), scatter
  ``weight * vis * es(u) es(v) es(w)`` onto a w-plane uv grid with the
  fft-shift checkerboard; per plane: unnormalised inverse FFT, then
  accumulate ``Re(layer * exp(-2 pi i w (n-1)) / n)`` into the dirty image
  (`apply_w_screen_and_sum`, :430); finally divide by the separable
  Gauss-Legendre convolution correction (`conv_corr_and_scaling`, :691);
- degridding mirrors it (`reverse_w_screen_to_stack`, :555; forward FFT;
  tap gathers), conv-correcting the image first;
- es kernel: ``exp(beta (sqrt(1 - x^2) - 1))``, |x| <= 1; correction
  C(k) = support * sum_i kern_i w_i cos(pi k support x_i) over the
  positive Gauss-Legendre nodes of order 2p, p = int(1.5 support + 2)
  (sdp_generate_gauss_legendre_conv_kernel, _utils.cpp:122-175).

Kernel parameters come from :mod:`.es_params` (the same analytic search as
the JAX package, so both pick identical kernels).

Two execution paths, chosen by rule when the plan is built:

- complex64 plans (support <= 8 by construction) build the packed plan
  of :mod:`.es_fft_packed` and run the bucket-window kernels on the
  plan's device (the packed path; a fault there raises, it does not fall
  back);
- complex128 plans (and any plan with support > 8) run the plain torch
  oracle below, on any dtype: per w-plane scatter, FFT and screen.

The plan lives on ``device`` (``None``: the CUDA card; CPU runs pass
``device="cpu"``); inputs are moved there and results stay there.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..fourier_transforms.fft import fft_shifted, ifft_shifted
from ..utility.constants import C_0
from ..utility.errors import SdpInvalidArgumentError
from ..utility.tensors import resolve_device, to_device
from .es_params import calculate_params_from_epsilon


def _es_kernel(beta, x: torch.Tensor) -> torch.Tensor:
    """exp(beta (sqrt(1-x^2) - 1)) for |x| <= 1, else 0."""
    inside = x.abs() <= 1.0
    safe = torch.where(inside, x, 0.0)
    return torch.where(inside,
                       torch.exp(beta * (torch.sqrt(1.0 - safe * safe) - 1.0)),
                       0.0)


def _is_complex64(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.complex64
    return np.dtype(getattr(x, "dtype", np.complex128)) == np.complex64


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


class GridderUvwEsFft:
    """Plan for the ES-FFT (de)gridder
    (`sdp_gridder_uvw_es_fft_create_plan`, sdp_gridder_uvw_es_fft.h:42-55).

    Template arrays fix shapes and dtypes; ``min_abs_w``/``max_abs_w``
    come from :meth:`get_w_range`. A complex64 ``vis`` template builds the
    packed plan from ``uvw``/``freq_hz``.

    >>> plan = GridderUvwEsFft(uvw, freq, vis, weight, dirty, pix, pix,
    ...                        1e-5, *GridderUvwEsFft.get_w_range(uvw, freq),
    ...                        True, device="cpu")
    >>> img = plan.grid_uvw_es_fft(uvw, freq, vis, weight, dirty)
    """

    def __init__(self, uvw, freq_hz, vis, weight, dirty_image,
                 pixsize_x_rad: float, pixsize_y_rad: float,
                 epsilon: float, min_abs_w: float, max_abs_w: float,
                 do_wstacking: bool, sigma: Optional[float] = None,
                 device=None):
        if pixsize_x_rad != pixsize_y_rad:
            raise SdpInvalidArgumentError(
                "Only square images supported (pixsize_x_rad must equal "
                "pixsize_y_rad)")
        self.device = resolve_device(device)
        self.pixsize_x_rad = float(pixsize_x_rad)
        self.pixsize_y_rad = float(pixsize_y_rad)
        self.pixel_size = float(pixsize_x_rad)
        self.epsilon = float(epsilon)
        self.do_wstacking = bool(do_wstacking)
        self.num_rows = int(vis.shape[0])
        self.num_chan = int(vis.shape[1])
        self.image_size = int(dirty_image.shape[0])
        single = _is_complex64(vis)

        grid_size, support, beta, sigma_eff = calculate_params_from_epsilon(
            self.epsilon, self.image_size, single, sigma=sigma)
        self.grid_size = grid_size
        self.support = support
        self.beta = beta
        self.sigma = sigma_eff
        self.uv_scale = self.grid_size * self.pixel_size

        if self.do_wstacking:
            # W-plane count and spacing (reference :345-373).
            x0 = -0.5 * self.image_size * self.pixel_size
            y0 = x0
            arg = 1.0 - x0 * x0 - y0 * y0
            nmin = math.sqrt(max(arg, 0.0)) - 1.0
            if x0 * x0 + y0 * y0 > 1.0:
                nmin = -math.sqrt(abs(arg)) - 1.0
            w_scale = 0.25 / abs(nmin)
            num_total_w_grids = int((max_abs_w - min_abs_w) / w_scale + 2)
            w_scale = 1.0 / ((1.0 + 1e-13) * (max_abs_w - min_abs_w)
                             / (num_total_w_grids - 1))
            self.min_plane_w = min_abs_w - (0.5 * support - 1.0) / w_scale
            self.max_plane_w = max_abs_w + (0.5 * support - 1.0) / w_scale
            self.num_total_w_grids = num_total_w_grids + support - 2
            self.w_scale = w_scale
            self.inv_w_range = self.max_plane_w - self.min_plane_w
        else:
            self.min_plane_w = self.max_plane_w = 0.0
            self.num_total_w_grids = 1
            self.w_scale = 1.0
            self.inv_w_range = 1.0
        self.min_abs_w = float(min_abs_w)
        self.max_abs_w = float(max_abs_w)
        self.inv_w_scale = 1.0 / self.w_scale
        self._init_quadrature()

        # The packed plan, bound to the plan's own uvw/freq like the
        # reference plan. By rule: complex64 plans (support <= 8) take the
        # packed path; the rest run the oracle.
        self._packed = None
        if single:
            from .es_fft_packed import build_es_packed_plan

            self._packed = build_es_packed_plan(
                self, _host_f64(uvw), _host_f64(freq_hz))

    def _init_quadrature(self):
        """Gauss-Legendre quadrature for the convolution correction."""
        p = int(1.5 * self.support + 2.0)
        nodes, weights = np.polynomial.legendre.leggauss(2 * p)
        pos = nodes > 0
        self._quad_nodes = nodes[pos]
        self._quad_weights = weights[pos]
        self._quad_kernel = np.exp(
            self.beta * (np.sqrt(1.0 - self._quad_nodes ** 2) - 1.0))
        self.conv_corr_norm_factor = float(
            self.support * np.sum(self._quad_kernel * self._quad_weights))
        # Precalculated half-kernel for (l, m): C(l)/norm.
        l_norm = np.arange(self.image_size // 2 + 1) / self.grid_size
        self.conv_corr_kernel = self._conv_corr(l_norm) \
            / self.conv_corr_norm_factor

    def _conv_corr(self, k):
        """C(k) = support * sum_i kern_i w_i cos(pi k support x_i)."""
        k = np.asarray(k, np.float64)
        phases = np.pi * k[..., None] * self.support * self._quad_nodes
        return self.support * np.sum(
            self._quad_kernel * self._quad_weights * np.cos(phases),
            axis=-1)

    @staticmethod
    def get_w_range(uvw, freq_hz) -> Tuple[float, float]:
        """(min, max) |w| in wavelengths (reference Python helper,
        gridder_uvw_es_fft.py:91-106)."""
        w = np.abs(_host_f64(uvw)[:, 2])
        freq = _host_f64(freq_hz)
        return (float(w.min() * freq[0] / C_0),
                float(w.max() * freq[-1] / C_0))

    # -- geometry shared by grid/degrid --------------------------------------
    def _taps(self, uvw, freq_hz):
        """The oracle's per-(row, chan) geometry in uvw's dtype: flip
        sign, w position, clipped tap indices [R, C, S] and u/v taps."""
        fdtype = uvw.dtype
        dev = uvw.device
        support = self.support
        half_support = support / 2.0
        flip = torch.where(uvw[:, 2] < 0, -1.0, 1.0).to(fdtype) \
            if self.do_wstacking else torch.ones(uvw.shape[0], dtype=fdtype,
                                                 device=dev)
        inv_wave = flip[:, None] * freq_hz[None, :] / C_0        # [R, C]
        pos_u = uvw[:, 0:1] * inv_wave * self.uv_scale
        pos_v = uvw[:, 1:2] * inv_wave * self.uv_scale
        if self.do_wstacking:
            pos_w = (uvw[:, 2:3] * inv_wave - self.min_plane_w) \
                * self.w_scale
        else:
            pos_w = torch.zeros_like(pos_u)
        u0 = torch.ceil(pos_u - half_support).to(torch.int32)
        v0 = torch.ceil(pos_v - half_support).to(torch.int32)
        k = torch.arange(support, dtype=torch.int32, device=dev)
        ku = _es_kernel(self.beta, ((u0[..., None] + k) - pos_u[..., None])
                        / half_support)                           # [R,C,S]
        kv = _es_kernel(self.beta, ((v0[..., None] + k) - pos_v[..., None])
                        / half_support)
        iu = (u0[..., None] + k + self.grid_size // 2).to(torch.int64)
        iv = (v0[..., None] + k + self.grid_size // 2).to(torch.int64)
        ku = torch.where((iu >= 0) & (iu < self.grid_size), ku, 0.0)
        kv = torch.where((iv >= 0) & (iv < self.grid_size), kv, 0.0)
        iu = iu.clamp(0, self.grid_size - 1)
        iv = iv.clamp(0, self.grid_size - 1)
        return flip, pos_w, iu, iv, ku, kv

    def _image_screens(self, plane_w: float, sign: float) -> torch.Tensor:
        """exp(sign 2 pi i w (n-1)) / n over image pixels (f64, on the
        plan's device; ones without w-stacking)."""
        size = self.image_size
        if not self.do_wstacking:
            return torch.ones((size, size), dtype=torch.complex128,
                              device=self.device)
        lin = (torch.arange(size, dtype=torch.float64, device=self.device)
               - size // 2) * self.pixel_size
        sos = lin[:, None] ** 2 + lin[None, :] ** 2
        nm1 = (-sos) / (torch.sqrt(1.0 - sos) + 1.0)
        xn = 1.0 / (nm1 + 1.0)
        x = 2.0 * math.pi * plane_w * nm1
        return torch.complex(torch.cos(sign * x), torch.sin(sign * x)) * xn

    def _correction(self, dtype) -> torch.Tensor:
        """1 / (separable conv correction x w correction) as ``dtype`` on
        the plan's device (host f64)."""
        size = self.image_size
        idx = np.abs(np.arange(size) - size // 2)
        lc = self.conv_corr_kernel[idx]
        corr_lm = lc[:, None] * lc[None, :]
        if self.do_wstacking:
            lin = (np.arange(size) - size // 2) * self.pixel_size
            ll, mm = np.meshgrid(lin, lin, indexing="ij")
            n = np.sqrt(1.0 - ll * ll - mm * mm) - 1.0
            n_conv = self._conv_corr(n * self.inv_w_scale) \
                * self.conv_corr_norm_factor ** 2
            corr = corr_lm * n_conv
        else:
            corr = corr_lm * self.conv_corr_norm_factor ** 2
        return torch.as_tensor(1.0 / corr, dtype=dtype, device=self.device)

    def _inputs(self, *xs):
        return [to_device(x, self.device) for x in xs]

    # -- public operations ----------------------------------------------------
    def grid_uvw_es_fft(self, uvw, freq_hz, vis, weight,
                        dirty_image) -> torch.Tensor:
        """Grid visibilities into a dirty image
        (`sdp_grid_uvw_es_fft`, sdp_gridder_uvw_es_fft.h:71); returns
        ``dirty_image`` plus the contribution."""
        uvw, freq_hz, vis, weight, dirty_image = self._inputs(
            uvw, freq_hz, vis, weight, dirty_image)
        if self._packed is not None and vis.dtype == torch.complex64:
            from .es_fft_packed import grid_es_packed

            return grid_es_packed(self, self._packed, vis, weight,
                                  dirty_image)
        flip, pos_w, iu, iv, ku, kv = self._taps(uvw, freq_hz)
        vis_w = torch.where((flip < 0)[:, None], vis.conj(), vis) \
            * weight.to(vis.dtype)
        size = self.image_size
        G = self.grid_size
        lo = G // 2 - size // 2
        rdtype = vis.real.dtype
        dirty = torch.zeros((size, size), dtype=rdtype, device=self.device)
        half_support = self.support / 2.0
        shape = iu.shape + (self.support,)
        flat = (iu[..., :, None] * G + iv[..., None, :]).expand(shape) \
            .reshape(-1)
        for iw in range(self.num_total_w_grids):
            kw = _es_kernel(self.beta, (iw - pos_w) / half_support)  # [R,C]
            vals = (vis_w * kw.to(vis.dtype))[..., None, None] \
                * (ku[..., :, None] * kv[..., None, :]).to(vis.dtype)
            grid = torch.zeros((G * G, 2), dtype=rdtype, device=self.device)
            grid.index_add_(0, flat, torch.view_as_real(vals.reshape(-1)))
            layer = ifft_shifted(torch.view_as_complex(grid).reshape(G, G))
            plane_w = iw * self.inv_w_scale + self.min_plane_w
            screen = self._image_screens(plane_w, -1.0)
            crop = layer[lo:lo + size, lo:lo + size]
            dirty = dirty + (crop * screen.to(crop.dtype)).real.to(rdtype)
        dirty = dirty * self._correction(rdtype)
        return dirty_image + dirty.to(dirty_image.dtype)

    def ifft_degrid_uvw_es_fft(self, uvw, freq_hz, vis, weight,
                               dirty_image) -> torch.Tensor:
        """Degrid visibilities from a dirty image
        (`sdp_ifft_degrid_uvw_es_fft`, sdp_gridder_uvw_es_fft.h:95).
        Returns the accumulated visibilities (vis + contribution);
        ``weight`` is not applied, as in the reference."""
        uvw, freq_hz, vis, dirty_image = self._inputs(
            uvw, freq_hz, vis, dirty_image)
        if self._packed is not None and vis.dtype == torch.complex64:
            from .es_fft_packed import degrid_es_packed

            return degrid_es_packed(self, self._packed, vis, dirty_image)
        flip, pos_w, iu, iv, ku, kv = self._taps(uvw, freq_hz)
        size = self.image_size
        G = self.grid_size
        lo = G // 2 - size // 2
        half_support = self.support / 2.0
        cdtype = vis.dtype
        rdtype = vis.real.dtype
        corrected = dirty_image.to(rdtype) * self._correction(rdtype)
        acc = torch.zeros_like(vis)
        for iw in range(self.num_total_w_grids):
            plane_w = iw * self.inv_w_scale + self.min_plane_w
            screen = self._image_screens(plane_w, 1.0)
            layer = torch.zeros((G, G), dtype=cdtype, device=self.device)
            layer[lo:lo + size, lo:lo + size] = (corrected * screen).to(cdtype)
            grid = fft_shifted(layer)
            taps = grid[iu[..., :, None], iv[..., None, :]]     # [R,C,S,S]
            kw = _es_kernel(self.beta, (iw - pos_w) / half_support)
            contrib = torch.einsum("rcu,rcv,rcuv->rc", ku.to(cdtype),
                                   kv.to(cdtype), taps) * kw.to(cdtype)
            acc = acc + contrib
        acc = torch.where((flip < 0)[:, None], acc.conj(), acc)
        return vis + acc

    # Reference Python method name (gridder_uvw_es_fft.py:128) — the C
    # symbol is sdp_ifft_degrid_uvw_es_fft, the Python wrapper shipped
    # as ifft_grid_uvw_es; keep both spellings for drop-in use.
    ifft_grid_uvw_es = ifft_degrid_uvw_es_fft
