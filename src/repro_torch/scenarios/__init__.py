"""Scenario engine: declarative non-stationary experiments, closed-loop
with the JLCM solver (failures, flash crowds, drift, cache outages, client
migration), on the port's segment simulator and replanners (kernel B1)."""

from . import library as _library  # registers the built-in scenarios
from .library import hotspot_drift_hierarchical
from .engine import (
    POLICIES,
    ScenarioOutcome,
    initial_plan,
    oblivious_plan,
    run_all_policies,
    run_geo_scenario,
    run_scenario,
)
from .spec import (
    ScenarioSpec,
    all_scenarios,
    diurnal_trace,
    get_scenario,
    register,
    scenario_names,
)

del _library
