"""Storage substrate in PyTorch: the calibrated testbed, the exact FCFS
simulator (single run, segments with failures and degraded reads, geo
segments, candidate rollouts, and the seed fleet, materialized or
streaming), the hot-tier cache, streaming latency statistics, GF(256)
Reed-Solomon and the plan-driven batched codec with its repair inventory."""
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
from .cache import (
    HOT_REPLICATION,
    WARM_OVERHEAD,
    CacheModel,
    CacheState,
    che_characteristic_time,
    che_hit_rates,
    cold_cache,
    simulate_ttl_cache,
    ttl_cache_scan,
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
    GeoSegmentResult,
    NodeObservations,
    SegmentResult,
    SimCarry,
    SimDraws,
    SimResult,
    dispatch_masks,
    fleet_one_raw,
    generate_geo_workload,
    generate_workload,
    init_carry,
    per_class_latency_stats,
    run_geo_segment_batch,
    run_geo_segment_raw,
    run_segment_batch,
    run_segment_raw,
    segment_draws,
    simulate,
    simulate_fleet,
    simulate_geo_segment,
    simulate_geo_segments,
    simulate_latency_cdf,
    simulate_segment,
    simulate_segments,
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
