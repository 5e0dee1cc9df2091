"""Carry plans across from the JAX package.

This system has no learned weights: the state both packages must share
is the plan (sort order, taps, task layout). :func:`from_jax_plan` turns
a ``ska_sdp_func_tpu`` ``WStackPlan`` or ``PackedPlan`` into the port's,
and :func:`from_jax_stream_plan` a ``StreamPlan``, by reading dataclass
fields, task tuples and the NumPy ``arrays``/``consts`` by attribute, so
they need no jax import and both packages compute on identical plans. Images and models are plain arrays: NumPy in, tensors
out.
"""

from dataclasses import fields

from .packed import PackedPlan, PackedTask
from .streaming import StreamPlan
from .wstack import WStackPlan, WStackTask


def _copy(cls, obj, **override):
    return cls(**{f.name: override.get(f.name, getattr(obj, f.name))
                  for f in fields(cls)})


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
