"""The paper's math in PyTorch: queueing, projection, the Lemma-2 bound,
Madow sampling and the Theorem-1 decomposition, Algorithm JLCM (merged
mode, single and batched), and the baselines of Figs. 7 and 9."""
from .baselines import split_merge_bound
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
