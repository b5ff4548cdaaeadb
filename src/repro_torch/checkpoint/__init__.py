"""Erasure-coded, JLCM-planned checkpointing (fault tolerance plane), with
every encode and degraded decode on kernel B2."""

from .planner import (
    CheckpointPlan,
    GroupPlan,
    pack_groups,
    plan_checkpoint_layout,
    plan_for_params,
    sample_read_set,
)
from .store import ECCheckpointStore
