"""Storage substrate in PyTorch: the calibrated testbed, the exact FCFS
simulator (single run and seed fleet), streaming latency statistics,
GF(256) Reed-Solomon and the plan-driven batched codec with its repair
inventory."""
from .cluster import (
    ClientSite,
    Cluster,
    GeoFabric,
    StorageNode,
    geo_testbed,
    homogeneous_cluster,
    measured_fig6_moments,
    tahoe_testbed,
)
from .codec import (
    CodecGroup,
    CodecPlan,
    decode_bank,
    decode_batch,
    encode_batch,
    host_loop_decode,
)
from .gf256 import (
    bits_to_bytes,
    bytes_to_bits,
    gf_const_to_bitmatrix,
    gf_inv,
    gf_matmul_ref,
    gf_mul,
    gf_mul_table,
    gf_mul_xtime,
)
from .repair import (
    RepairFlow,
    augment_plan,
    build_repair_flow,
    lost_chunk_inventory,
    repair_schedule,
)
from .rs import (
    cauchy_parity_matrix,
    decode,
    decode_bytes,
    decode_matrix,
    encode,
    generator_matrix,
    gf_invert_matrix,
    pad_and_split,
)
from .simulator import (
    ClassLatencyStats,
    FleetResult,
    SimDraws,
    SimResult,
    generate_geo_workload,
    generate_workload,
    per_class_latency_stats,
    simulate,
    simulate_fleet,
    simulate_latency_cdf,
)
from .streaming import (
    DEFAULT_SKETCH,
    SketchSpec,
    StreamingStats,
    stream_from_values,
    stream_init,
    stream_mean,
    stream_merge,
    stream_quantile,
    stream_reduce,
    stream_var,
    windowed_quantile_mean,
)
