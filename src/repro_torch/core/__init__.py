"""The paper's math in PyTorch: queueing, projection, the Lemma-2 bound and
its tail bound, Madow sampling and the Theorem-1 decomposition, Algorithm
JLCM (merged, debug and nested modes, single and batched), the objective
layer (tenant classes, tail deadlines, cache tier), the geo client fabric,
hierarchical planning of million-file catalogs, and the baselines of
Figs. 7 and 9."""
from .aggregate import (
    Catalog,
    FactoredPlan,
    Hierarchy,
    IncrementalInfo,
    build_problem,
    cluster_catalog,
    duality_gap,
    effective_chunk_mb,
    evaluate_pi,
    kmeans1d,
    materialize,
    resolve_incremental,
    solve_hierarchical,
    synthetic_catalog,
    volume_catalog,
)
from .baselines import split_merge_bound
from .geo import (
    GeoSpec,
    geo_eq_varq,
    geo_optimal_shared_z,
    geo_problem,
    geo_shared_z_latency,
    geo_sojourn_moments,
    make_geo,
    node_mixture_moments,
    pair_moments,
)
from .jlcm import (
    JLCMProblem,
    JLCMSolution,
    max_ec_solution,
    proportional_lb_pi,
    random_placement_mask,
    smoothed_objective,
    solve,
    solve_batch,
    stack_problems,
)
from .latency_bound import (
    bound_given_z,
    file_latency_bounds,
    mean_latency_bound,
    optimal_shared_z,
    optimal_z,
    shared_z_latency,
    tail_probability_bounds,
)
from .objectives import (
    CacheSpec,
    ObjectiveSpec,
    apply_cache_thinning,
    class_mean_bounds,
    class_tail_bounds,
    compose_file_bounds,
    composed_latency,
    empirical_objective,
    empirical_objective_device,
    make_cache_spec,
    make_objective,
    refresh_shared_z,
)
from .projection import feasible_uniform, project_capped_simplex
from .queueing import (
    ServiceMoments,
    exponential_moments,
    fit_shifted_exponential,
    node_arrival_rates,
    pk_sojourn_moments,
    shifted_exponential_moments,
    stability_penalty,
    utilisation,
)
from .scheduling import (
    check_feasible,
    decompose_subsets,
    madow_sample,
    madow_sample_batch,
)
