"""Schedules: host planners mapping layouts onto device work
(reference: include/loops/schedule.hxx + schedule/*.hxx)."""
from loops_tpu.schedule.plans import (  # noqa: F401
    SCHEDULES,
    FlatBlockPlan,
    GroupMappedPlan,
    RowMappedPlan,
    make_plan,
)
