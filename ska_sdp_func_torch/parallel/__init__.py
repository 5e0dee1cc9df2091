"""Plans and whole-image drivers: the w-stacking task plan, the packed
ingest plan and :class:`~.packed.PackedGridder`."""

from .convert import from_jax_plan
from .packed import (
    PackedGridder,
    PackedPlan,
    PackedTask,
    packed_geometry_ok,
    packed_gridder,
    plan_packed,
)
from .wstack import WStackPlan, WStackTask, plan_wstack

__all__ = [
    "PackedGridder",
    "PackedPlan",
    "PackedTask",
    "WStackPlan",
    "WStackTask",
    "from_jax_plan",
    "packed_geometry_ok",
    "packed_gridder",
    "plan_packed",
    "plan_wstack",
]
