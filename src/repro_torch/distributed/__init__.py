"""Sharding rules for the mesh (``sharding``): GSPMD's specs as DTensor
placements."""
from .sharding import (
    MeshShape,
    NamedSharding,
    P,
    batch_specs,
    cache_shardings,
    cache_spec_for_leaf,
    mesh_axes,
    param_shardings,
    placements,
    spec_for_leaf,
)
