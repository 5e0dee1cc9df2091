"""Plans and whole-image drivers: the w-stacking task plan and task
drivers, the bucketed per-task drivers, the packed ingest plan and
:class:`~.packed.PackedGridder`, the device-planned streaming gridder
and degridder, and the multi-process layer on ``torch.distributed``:
process meshes (:mod:`.mesh`), distributed SwiFTly, and the sharded
w-stacking, packed, bucketed and streaming drivers (each rank passes
and gets back its own block)."""

from .bucketed import (
    BucketedPlan,
    BucketedTask,
    degrid_all_bucketed,
    grid_all_bucketed,
    grid_all_bucketed_sharded,
    inverse_index_of,
    plan_bucketed,
    task_id_stream,
)
from .convert import (
    from_jax_es_plan,
    from_jax_plan,
    from_jax_stream_plan,
    from_jax_swiftly,
)
from .mesh import (
    ROW_AXIS,
    gather_rows,
    local_rows,
    make_mesh,
    pad_rows,
    pad_rows_arrays,
    row_sharding,
)
from .packed import (
    PackedGridder,
    PackedPlan,
    PackedTask,
    degrid_all_packed,
    degrid_all_packed_sharded,
    grid_all_packed,
    grid_all_packed_sharded,
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
from .swiftly_dist import SwiftlyDistributed
from .wstack import (
    WStackPlan,
    WStackTask,
    degrid_all_tasks,
    grid_all_tasks,
    plan_wstack,
    wstack_degrid_all_sharded,
    wstack_grid_all_sharded,
)

__all__ = [
    "ROW_AXIS",
    "BucketedPlan",
    "BucketedTask",
    "PackedGridder",
    "PackedPlan",
    "PackedTask",
    "StreamPlan",
    "StreamingDegridder",
    "StreamingGridder",
    "SwiftlyDistributed",
    "WStackPlan",
    "WStackTask",
    "degrid_all_bucketed",
    "degrid_all_packed",
    "degrid_all_packed_sharded",
    "degrid_all_tasks",
    "from_jax_es_plan",
    "from_jax_plan",
    "from_jax_stream_plan",
    "from_jax_swiftly",
    "gather_rows",
    "grid_all_bucketed",
    "grid_all_bucketed_sharded",
    "grid_all_packed",
    "grid_all_packed_sharded",
    "grid_all_tasks",
    "inverse_index_of",
    "local_rows",
    "make_mesh",
    "packed_geometry_ok",
    "packed_gridder",
    "pad_rows",
    "pad_rows_arrays",
    "plan_bucketed",
    "plan_packed",
    "plan_stream",
    "plan_wstack",
    "row_sharding",
    "stream_tasks",
    "task_id_stream",
    "wstack_degrid_all_sharded",
    "wstack_grid_all_sharded",
]
