"""Plans and whole-image drivers: the w-stacking task plan and task
drivers, the bucketed per-task drivers, the packed ingest plan and
:class:`~.packed.PackedGridder`, and the device-planned streaming
gridder and degridder."""

from .bucketed import (
    BucketedPlan,
    BucketedTask,
    degrid_all_bucketed,
    grid_all_bucketed,
    inverse_index_of,
    plan_bucketed,
    task_id_stream,
)
from .convert import from_jax_es_plan, from_jax_plan, from_jax_stream_plan
from .packed import (
    PackedGridder,
    PackedPlan,
    PackedTask,
    degrid_all_packed,
    grid_all_packed,
    packed_geometry_ok,
    packed_gridder,
    plan_packed,
)
from .streaming import (
    StreamingDegridder,
    StreamingGridder,
    StreamPlan,
    plan_stream,
    stream_tasks,
)
from .wstack import (
    WStackPlan,
    WStackTask,
    degrid_all_tasks,
    grid_all_tasks,
    plan_wstack,
)

__all__ = [
    "BucketedPlan",
    "BucketedTask",
    "PackedGridder",
    "PackedPlan",
    "PackedTask",
    "StreamPlan",
    "StreamingDegridder",
    "StreamingGridder",
    "WStackPlan",
    "WStackTask",
    "degrid_all_bucketed",
    "degrid_all_packed",
    "degrid_all_tasks",
    "from_jax_es_plan",
    "from_jax_plan",
    "from_jax_stream_plan",
    "grid_all_bucketed",
    "grid_all_packed",
    "grid_all_tasks",
    "inverse_index_of",
    "packed_geometry_ok",
    "packed_gridder",
    "plan_bucketed",
    "plan_packed",
    "plan_stream",
    "plan_wstack",
    "stream_tasks",
    "task_id_stream",
]
