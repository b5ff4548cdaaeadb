"""The paper's math in PyTorch: queueing, projection, the Lemma-2 bound,
Madow sampling and Algorithm JLCM (merged mode)."""
from .jlcm import JLCMProblem, JLCMSolution, solve
from .latency_bound import (
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
    node_arrival_rates,
    pk_sojourn_moments,
    shifted_exponential_moments,
)
from .scheduling import madow_sample, madow_sample_batch
