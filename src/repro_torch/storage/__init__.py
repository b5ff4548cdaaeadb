"""Storage substrate in PyTorch: the calibrated testbed and the exact FCFS
simulator (single run and seed fleet)."""
from .cluster import ClientSite, Cluster, GeoFabric, StorageNode, tahoe_testbed
from .simulator import (
    FleetResult,
    SimDraws,
    SimResult,
    generate_geo_workload,
    generate_workload,
    simulate,
    simulate_fleet,
)
