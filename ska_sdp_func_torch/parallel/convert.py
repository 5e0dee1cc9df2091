"""Carry plans across from the JAX package.

This system has no learned weights: the state both packages must share
is the plan (sort order, taps, task layout). :func:`from_jax_plan` turns
a ``ska_sdp_func_tpu`` ``WStackPlan`` or ``PackedPlan`` into the port's
by reading dataclass fields, task tuples and the NumPy ``arrays`` by
attribute, so it needs no jax import and both packages compute on
identical plans. Images and models are plain arrays: NumPy in, tensors
out.
"""

from dataclasses import fields

from .packed import PackedPlan, PackedTask
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
