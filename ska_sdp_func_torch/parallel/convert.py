"""Carry plans across from the JAX package.

This system has no learned weights: the state both packages must share
is the plan (sort order, taps, task layout). :func:`from_jax_plan` turns
a ``ska_sdp_func_tpu`` ``WStackPlan`` or ``PackedPlan`` into the port's,
:func:`from_jax_stream_plan` a ``StreamPlan``, :func:`from_jax_es_plan`
a ``GridderUvwEsFft`` and :func:`from_jax_swiftly` a ``Swiftly``, by
reading dataclass fields, task tuples, scalars
and the NumPy ``arrays``/``consts`` by attribute, so they need no jax
import and both packages compute on identical plans. Images and models
are plain arrays: NumPy in, tensors out.
"""

from dataclasses import fields

from ..fourier_transforms.swiftly import Swiftly
from ..grid_data.es_fft import GridderUvwEsFft
from ..grid_data.es_fft_packed import EsPackedPlan, attach
from ..utility.tensors import resolve_device
from .packed import PackedPlan, PackedTask
from .streaming import StreamPlan
from .wstack import WStackPlan, WStackTask


def _copy(cls, obj, **override):
    return cls(**{f.name: override[f.name] if f.name in override
                  else getattr(obj, f.name) for f in fields(cls)})


def from_jax_plan(plan):
    """Port of a JAX ``WStackPlan`` or ``PackedPlan`` (duck-typed: a
    packed plan is one with ``arrays``); the NumPy arrays are shared,
    not copied."""
    if hasattr(plan, "arrays"):
        return _copy(PackedPlan, plan,
                     wplan=from_jax_plan(plan.wplan),
                     tasks=tuple(_copy(PackedTask, t) for t in plan.tasks),
                     arrays=dict(plan.arrays))
    return _copy(WStackPlan, plan,
                 tasks=tuple(_copy(WStackTask, t) for t in plan.tasks))


def from_jax_stream_plan(splan):
    """Port of a JAX ``StreamPlan`` (geometry, tasks and the ``consts``
    lookup tables; the NumPy arrays are shared, not copied)."""
    return _copy(StreamPlan, splan, wplan=from_jax_plan(splan.wplan),
                 tasks=tuple(_copy(PackedTask, t) for t in splan.tasks),
                 consts=dict(splan.consts))


# The ES-FFT plan's state: scalars and its host quadrature arrays.
_ES_FIELDS = (
    "pixsize_x_rad", "pixsize_y_rad", "pixel_size", "epsilon",
    "do_wstacking", "num_rows", "num_chan", "image_size", "grid_size",
    "support", "beta", "sigma", "uv_scale", "min_plane_w", "max_plane_w",
    "num_total_w_grids", "w_scale", "inv_w_range", "min_abs_w",
    "max_abs_w", "inv_w_scale", "_quad_nodes", "_quad_weights",
    "_quad_kernel", "conv_corr_norm_factor", "conv_corr_kernel")


def from_jax_es_plan(jplan, device=None) -> GridderUvwEsFft:
    """Port of a JAX ``GridderUvwEsFft`` on ``device`` (``None``: the CUDA
    card): its scalars, quadrature and packed plan's host arrays (shared,
    not copied); the packed plan's tensors are built on ``device``."""
    plan = GridderUvwEsFft.__new__(GridderUvwEsFft)
    for name in _ES_FIELDS:
        setattr(plan, name, getattr(jplan, name))
    plan.device = resolve_device(device)
    plan._packed = None
    jp = jplan._packed
    if jp is not None:
        ep = _copy(EsPackedPlan, jp, arrays=dict(jp.arrays), dev=None)
        plan._packed = attach(plan, ep)
    return plan


def from_jax_swiftly(sw, device=None) -> Swiftly:
    """Port of a JAX ``Swiftly`` plan on ``device`` (``None``: the CUDA
    card): its geometry, and its ``Fn`` / ``Fb`` tables copied as they
    are."""
    plan = Swiftly(sw.image_size, sw.yN_size, sw.xM_size, sw.W,
                   device=device)
    plan._set_tables(sw.Fn, sw.Fb)
    return plan
