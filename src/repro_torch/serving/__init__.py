"""Probabilistic-scheduling request router (serving plane) and the closed
loop's control plane (EWMA estimators, batched re-planning, hedged serving
simulation)."""
from .router import (
    AdaptiveReplanner,
    EwmaMomentEstimator,
    EwmaRateEstimator,
    GeoAdaptiveReplanner,
    HierarchicalReplanner,
    ReplicaPool,
    Router,
    batched_rollout_scores,
    simulate_serving,
)
