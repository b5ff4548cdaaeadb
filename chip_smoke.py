#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure:

1. Build the kernels from ``src/repro_torch/kernels/csrc/`` with nvcc (into
   ``build/repro_torch/``), one nvcc per source, started together: the
   FCFS scan (``fcfs_queue.cu``, kernel B1), the GF(256) product
   (``gf256_matmul.cu``, kernels B2 and B3) and flash attention
   (``flash_attention.cu``, kernel B4), and this script's three probes
   (``PROBES``). nvcc's ``-Xptxas -v`` lines give every instance's
   registers, spills and shared memory. Print each build's seconds and the
   card's name and power limit. Then the probes measure three limits no
   table gives: B1's serial chain alone (one thread, FLEET_REQUESTS steps
   of ``dep = max(t, dep) + s``; CUDA events and SM cycles), the rate
   ``mma.sync`` reaches on TF32 (the instruction B4's products use, every
   SM busy with independent accumulators), and the rate of 8-byte
   shared-memory loads at random indices (B2 and B3's lookups) on every
   SM, once with lane-private table copies as the kernel reads them and
   once into one 2 KB table, printed beside the INT32 rate
   (``clocks.max.sm`` x 64 x SMs).
2. Hold B1 against its plain PyTorch twin on the card: random, heavily
   loaded inputs at (S, N, m) = (64, 2048, 12), (5, 128, 6) and
   (3, 256, 40) (the kernel's wide instance), and unbatched at (2048, 12),
   all through ``fcfs_scan``, with carried queue state and ~5% empty mask
   rows, must give bitwise-equal latency and dep, and busy within rtol 1e-6;
   so must a strided view of the last case, and uint8 masks whose true
   bytes run from 1 to 255, at m = 12 and 40.
2b. Hold B2 and B3 against their plain twins, bitwise, on random bytes
   through ``ops.gf256_matmul`` / ``ops.gf256_matmul_batch`` with the
   default backend: the sweep shapes of ``tests/test_kernels.py`` (M up
   to 256 and K up to 128: the kernel's row and k passes), a batched
   (8, 12, 12) x (8, 12, 4099), every (M, K) the codec calls at odd
   widths with B starting off the 16-byte boundary (unbatched and a
   batch of 37), N = 1, a batch of 70 001 elements, and an unbatched
   (4, 4) x (4, 2**29 + 3) whose operand is larger than 2**31 bytes
   (timed beside its bound and the design's work at phase 1's rates).
   The ``bitplane`` backend runs once on CUDA tensors against the twins.
   Products with an empty extent and an n == k encode give the defined
   result without a launch; a sliced view of a coded batch decodes
   byte-exact through B3.
2c. Hold B4 against its plain twin on random normal inputs: the sweep,
   windows and bf16 case of ``tests/test_kernels.py::TestFlashAttention``
   (atol 2e-5, bf16 3e-2), bf16 with a window at the other head widths
   the kernel is built for (8, 32, 64), unequal and ragged lengths, a
   non-causal case, SmolLM-135M's prefill shape (4, 2016, 9, 3, 64), head
   width 128 in float32 and bfloat16 at the GQA models' groups G = 2, 3,
   6, 8 and 12, causal and windowed, at ragged lengths, Phi-4-mini's
   prefill shape (4, 2016, 24, 8, 128), and head width 64 at G = 1 (plain
   MHA) in float32 and bfloat16: SeamlessM4T-medium's decoder prefill
   (2, 2016, 16, 16, 64) and a ragged T = 1001 with a window of 300; MLA's
   widths, q/k 192 and v 128, in float32 and bfloat16: DeepSeek-V3's
   prefill (2, 2016, 128, 128), a ragged T = 1001 with 4 heads, and G = 2
   at T = 300 with a window of 100; with the four float32 prefill shapes'
   3xTF32 bounds; non-causal attention that needs key padding must raise
   ``ValueError``.
3. Quickstart twin: three files (k = 6, 7, 4) solved at theta = 0.5 and
   200, then simulated with 20000 requests; the simulated mean must stay
   within the bound x 1.05, the claim ``examples/quickstart.py`` asserts.
4. The paper's §V.B catalog (r = 1000 files, k = 6, 7, 6, 4 by quarter,
   aggregate ~0.118 req/s) on the 12-node testbed at theta = 2: the solve
   must descend monotonically and stop within 250 iterations (fig8's
   claims), and a fleet of 256 seeds x 100000 requests must go through the
   kernel with a finite mean latency within the bound x 1.05. B1 is timed
   on the fleet's inputs beside its byte bound and the chain phase 1 timed.
4b. The paper's §V figures (``benchmarks/fig{6,7,9,10,11,12,13}*.py``),
   their sizes, rates and solver settings (``max_iters`` 400, default eps),
   with explicit generators; every claim those benchmarks assert must hold.
   Fig. 6: 40 000 service draws of ``homogeneous_cluster(7)`` and the
   testbed, moments beside the paper's, KS distance to Exp(mean) > 0.3,
   ``measured_fig6_moments().validate()``. Fig. 7: (7, 4) at 12 rates, our
   bound (measured and exponential moments), [43]'s split-merge bound (+inf
   at some rate) and ``simulate`` (30 000 requests) <= ours x 1.03. One
   ``solve_batch`` of eight r = 1000 problems (fig11's 50-200 MB, fig12's
   rate scales 0.55-0.85 at 200 MB, Maximum EC's theta = 0 problem); fig9's
   four schemes by bound and simulation (Random CP the best of 100
   ``random_placement_mask`` draws, scored as one batch), JLCM <= the best
   other x 1.02; fig10's quantiles by k group and ``per_class_stats``, with
   the sketch held to the exact latencies (count, mean within 1e-4, each
   quantile between the order statistic and growth x it); fig11's
   super-linear growth and simulated <= bound x 1.03; fig12's cost and
   bound rising with load; one ``solve_batch`` of fig13's eight thetas,
   cost falling and latency rising with theta. The figures' 21 scans are
   stacked per figure on the seed axis and held to the plain twin bitwise;
   B1 is timed on fig10's one-seed scan beside its bound and the serial
   chain alone at that length.
5. The data plane on phase 4's plan: ``CodecPlan.from_solution``; a 4 MiB
   payload per file (32 Tahoe segments of 128 KiB) from a seeded generator
   on the card, split as ``pad_and_split`` does; ``encode_batch`` once per
   (n, k) group (B2); node 0 fails and ``lost_chunk_inventory`` must count
   every file; each file's ``degraded_patterns(i, [0])`` chunks are
   gathered and ``decode_requests`` decodes them (B3); every file's
   decoded rows must equal its data byte for byte. Every encode and
   decode kernel call is timed on its inputs, and their sums are printed
   beside the encode and decode walls.
6. Serving: ``serve("smollm-135m", smoke=False)``, SmolLM-135M at full
   width and depth in float32 with random weights from a seed, 4 replicas
   planned by JLCM, 2 batches of 4 prompts of 2016 tokens routed by Madow
   sampling, each prefilled (B4 in all 30 layers) and decoded greedily for
   32 tokens. Every prefill must launch B4 exactly 30 times; every B4 call
   of the path is held against the plain twin at atol 2e-5; a prefill with
   naive attention on the same weights and tokens must give last-position
   logits within 1e-3; every routed replica must lie in pi's support and
   the plan's bound must be finite. B4 is timed on the path's own inputs
   beside its plain twin and ``scaled_dot_product_attention`` (timed as a
   yardstick only; the port never calls it), against its 3xTF32 bound and
   the time of the same three passes at the rate phase 1 measured.

7. The planner's whole problem, each plan simulated through B1:
   7a. ``benchmarks/jlcm_scaling.py``'s ``jlcm_hierarchical`` section (its
       ``SOLVE_KW``, the testbed at theta = 2): its volume properties (a
       V = 1 volume solve is the file solve bitwise, 4-file volumes gather
       exactly and cost 4x), the clustered plan within 5 % of the dense
       r = 1000 solve (and its Frank-Wolfe gap), ``synthetic_catalog`` of
       10^6 files planned through ``cluster_catalog`` and
       ``solve_hierarchical``, materialized to a (10^6, 12) plan whose
       ``evaluate_pi`` equals the cluster solve's ``latency_tight`` within
       rtol 1e-4; ``resolve_incremental`` after a seeded tenth of the
       clusters' rates x1.5 (the moved count re-solved, padded to the next
       power of two, within 5 % of a cold re-solve); a fleet of 64 seeds x
       100 000 requests of the 10^6-file plan, whose marks must follow the
       cluster rates (max |share - rate share| <= 0.01) and whose mean is
       held within the bound x 1.05 where the plan's queues are stable.
       The walls of the 10^6-file plan and the dense r = 1000 solve are
       printed, not gated.
   7b. ``benchmarks/tenant_tradeoff.py`` at full size: 5 weights x 3
       deadlines as one ``solve_batch`` (400 iterations), each plan
       simulated with 60 000 requests; every assert of the benchmark, and
       ``empirical_objective_device`` on the card within rtol 1e-5 of the
       host ``empirical_objective``.
   7c. The geo fabric (``geo_testbed``, 4 client sites): a one-site
       ``geo_problem`` solves bitwise as the plain problem; one batch of
       the NJ- and TX-anchored mixes (mass on the TX nodes must rise by
       more than 0.5) and ``benchmarks/fleet_scale.py``'s four files at
       its client shares, whose plan a 64 x 100 000 fleet simulates across
       the sites: EU's mean above NJ's, the mean within the geo bound x
       1.05.
   Phase 7's scans are held to the plain twin bitwise like phases 3-4b.
8. The closed loop's simulator, every scan on B1 (phase 8 wall printed):
   8a. The Che model over phase 4's catalog (file bytes k_i x the chunk
       size, a tenth of their sum cached, hit latency 0.5 s, 0.02 $/MB hot,
       the cache scenarios' values): TTLs and hit fractions; the hot tier
       must lower phase 4's plan's bound; a cache-aware re-solve through
       ``make_cache_spec``; ``benchmarks/cache_tier.py``'s frontier (7
       capacities as one ``solve_batch`` of 300 iterations) with its two
       asserts.
   8b. ``simulate_segments``, 8 x 100 000 requests on the cache-aware plan:
       node 0 down in segments 2-4 with repair rows (``build_repair_flow``,
       ``augment_plan``; paced at the node-failure-repair scenario's share
       of the client rate, about 30 % of the reads, TTL 0), the Che TTLs, a
       hot-tier outage in segment 6. Node 0 has no busy time and no
       observation while down; every non-hit read is served by k_i available
       nodes and every hit by none (B1 gives -inf there), hits return at the
       hit latency, none in the outage or on a repair row; t0 rises; a host
       loop of ``simulate_segment`` on the same draws is bitwise the
       schedule; TTLs all zero are bitwise the cache-free run; the repair
       rows raise the clients' mean latency over the same schedule without
       them. Prints the repair share of the reads and the busiest node's
       utilisation a segment.
   8c. 8 candidates (1 - a) pi + a uniform-over-support(pi), a = 0, 1/7,
       ..., 1, x 4 draws from the carry after segment 4: ONE B1 launch at
       (32, 100 000, 12); with one draw each candidate's stream and counts
       are bitwise ``run_segment_raw``'s, its power sums within rtol 1e-5.
   8d. ``simulate_geo_segments`` on 7c's plan, 8 x 100 000 requests, the
       client mix rotating one site a segment: per-(site, node) counts sum
       to the served masks; ``fleet_scale.py``'s rider 3 (one
       ``simulate_geo_segment``'s mean within 25 % of 7c's fleet mean).
   8e. ``simulate_fleet(stream=True, n_chunks=8)`` with the cache, 64 seeds
       x 8 x 100 000 requests: hit count, sketch p99 and windowed p99;
       ``fleet_scale.py``'s rider 2 at ``n_chunks = 1`` on the materialized
       run's draws (exact count, mean within 1e-4, exact p99 <= sketch p99
       <= exact x growth); the cached mean below the uncached; seed 0's hits
       and final expiry on the card equal a host walk of the TTL cache. B1
       is timed on a chunk's inputs with carried state, and the sort-based
       cache on a chunk.
   Phase 8's scans, each with its own carried ``dep0`` and ``busy0``, are
   stacked and held to the plain twin bitwise in one walk.
9. The closed loop's control plane (``serving/router.py``, ``diag.py``):
   9a. ``benchmarks/serving_hedge.py`` at its sizes (6 replicas, rates 0.15
       and 0.6, hedge 0, 1, 2, 20 000 requests): each ``simulate_serving``
       is one B1 launch at (m, N, m); p99 with hedge 1 must fall below
       hedge 0's at low load; ``plan_sweep`` must equal single plans (bound
       within 1e-3), ``precompute_failover`` then ``drop_replica`` a fresh
       masked solve (pi within 1e-5), and a stale table must be ignored.
   9b. ``benchmarks/replan_wall.py``'s equalities at its sizes (8 / 16 / 32
       candidates, 2 / 4 draws at 16): ``batched_rollout_scores`` (one B1
       launch) picks the sequential loop's argmin, every score within rtol
       1e-5; the hoisted sweep's plans are bit-identical. Both walls are
       printed side by side, not gated.
   9c. Open check 3: a repair-aware ``AdaptiveReplanner`` (the repair flow,
       the cache model, rollouts from the live carry) re-plans phase 8b's
       schedule where availability changes, on 8b's draws; the clients'
       mean in segments 2-4 must fall below the static plan's. Per segment:
       the busiest node's utilisation, the clients' mean and p99, the
       repair share; each replan's iterations and walls.
   9d. ``HierarchicalReplanner`` at 10^6 files: the first replan full and
       materialized, a quiet one a no-op, a surge re-solving only moved
       clusters, a mask change a full solve.
   9e. ``GeoAdaptiveReplanner`` over geo segments under a rotating client
       mix, re-planned from EWMA (C, r) rates with batched geo rollouts; with
       one draw its chosen index must equal the sequential loop's.
   9f. Under ``REPRO_DIAG=1`` (in-process) 9c's first replan and two
       ``simulate_fleet`` calls must raise nothing; inside ``diag.hot_path`` a
       deliberate ``np.asarray`` of a CUDA tensor must raise
       ``HostSyncError`` and ``float()`` of one the sync-debug error.
   Phase 9's scans are held to the plain twin bitwise, stacked by (N, m).
10. The scenario engine (``repro_torch.scenarios``) at the registered sizes
   and seed 0, the four cells at once, one process each, started before
   phase 9 and collected after it (their walls are the solver's launches
   from the host, so they overlap phase 9's instead of adding to them): 10a ``run_all_policies`` on
   ``node-failure`` (adaptive's mean below static's and oblivious's,
   ``benchmarks/scenario_suite.py:102-115``; the adaptive run under
   ``REPRO_DIAG=1``, whose replans' solver iterations and rollout
   arbitrations must raise nothing); 10b ``cache-outage`` with the
   cache-blind static baseline (adaptive below it on mean and windowed p99
   at no more storage cost, ``scenario_suite.py:82-101``); 10c
   ``hotspot_drift_hierarchical(r=100_000, requests_per_segment=800)``,
   static and adaptive through the hierarchy (adaptive below static,
   ``tests/test_scenarios.py:364``); 10d ``geo-client-shift`` (replans,
   adaptive below static, ``scenario_suite.py:74-81``). Each policy's
   row, every replan's iterations and solve and rollout walls, and the
   initial plans' are printed. The cells' scans come back to this process
   and are held to the plain twin bitwise, stacked by (N, m).
11. SmolLM-135M's float32 parameters (0.54 GB, random from a seeded
   generator on the card) through the EC checkpoint store: planned with
   ``plan_for_params`` on the testbed at ``checkpoint_catalogs.py``'s
   group size and theta with chunks of a quarter group (CKPT_CHUNK_DIV),
   saved into a temporary directory under ``build/`` (removed at the end),
   group 0's last and first nodes failed (every group within n - k),
   restored and compared leaf by leaf bitwise, re-planned around the
   failures (no chunk on a failed node, n >= k), then group 0's nodes
   failed until fewer than k of its chunks survive, where ``restore`` must
   raise the data-loss error. Every B2 call of save and restore is held to
   the plain twin bitwise and timed; B2's share of each wall is printed.
12. Training (``repro_torch.launch.train`` and ``launch/steps.py``):
   12a. ``examples/train_lm.py``'s flow at full width: ``train("smollm-135m",
       smoke=False)`` on the (1, 1) mesh (each step through
       ``jit_train_step``; a save gathers the state, a restore places it),
       cut in depth to ``TRAIN_DEPTH``, 6 of 30 layers (DTensor's host cost
       sets a step's wall), float32, batch 8 x seq 64, lr 3e-3 on
       the cosine schedule, for TRAIN's 600 steps, the whole TrainState
       (parameters and both AdamW moments, 0.68 GB at 8 layers) planned by JLCM as 25
       files and saved through the EC store every 200 steps; the first group's first
       storage node fails at step 500, after the last save; then a
       ``resume=True`` run restores step 400 from the degraded store and
       trains to 600, saving step 400 again. The example's assertion in both
       runs (the last loss below the first run's first minus 0.5); the
       restored state bitwise, leaf for leaf, to the state the first run
       saved; every B2 call of the three saves and the restore held bitwise
       to the plain twin and timed, save by save, beside each wall; the
       step time and tokens/s.
   12b. SmolLM-135M at full width on one batch of 2 x 2048 tokens: the loss
       and every gradient leaf at O0 (naive attention, dense CE), O2 (B4
       under its ``autograd.Function``, ``vocab_chunk`` 32768) and O3 (O2
       with each layer recomputed in the backward). The loss within rtol
       2e-4 and every leaf within a relative L2 of 1e-3, O2 and O3 against
       O0 and O3 against O2; B4's outputs carry a ``grad_fn``; every B4
       call (O2's 30, O3's 30 and 30 recomputed) held to the plain twin at
       atol 2e-5; B4's forward and the Function's backward (torch ops)
       timed with CUDA events on the path's inputs, beside their bounds and
       ``scaled_dot_product_attention``.
13. The five GQA / MoE models of head width 128, at full width (their
   registered configs), float32, random weights from a seed, at O3 (B4 in
   every prefill and forward):
   13a. ``serve("phi4-mini-3.8b", smoke=False)``: all 32 layers (3.84e9
       parameters, 15.3 GB), phase 6's load (4 replicas, 2 batches of 4
       prompts of 2016 tokens, 32 greedy tokens). Every prefill must launch
       B4 once a layer; every B4 call is held to the plain twin as it is
       made (keeping them all would take 76 GB); routes inside pi's
       support; a naive-attention prefill within 1e-3. Then a prefill and
       its 32 decode steps are timed without the holds, and B4 on the
       path's (4, 2016, 24, 8, 128) beside its 3xTF32 bound (0.606 ms) and
       ``scaled_dot_product_attention``.
   13b. Gemma3-27B (8 of 62 layers: one period of 5 local + 1 global and
       the two trailing local layers; window 1024, so the local caches
       roll; q/k norms; tied head), the Qwen3 MoE (4 of 48 layers; 128
       experts, top 8), StarCoder2-15B (4 of 40; untied head, G = 12) and
       Qwen2-VL-2B (all 28 layers; 4 patch embeddings and (3, B, S)
       positions): ``forward_logits`` of 2 x 2048 tokens, a prefill of the
       first 2016 and 32 decode steps fed the sequence's next tokens. The
       prefill's logits and each step's are held to the forward's at
       ``tests/test_models.py``'s tolerance (rtol 2e-2, atol 2e-3); B4
       launches once a layer in the forward and in the prefill, and every
       call is held to the plain twin. For the MoE: each token's top-8 set
       in the forward against the prefill's and the steps' (a token whose
       set differs is counted, printed and left out of the comparison),
       the prefill's aux loss and per-expert load by layer, and one MoE
       layer timed at 2 x 2016 tokens and at a decode step, with its host
       syncs (one a layer call: the group sizes). Each model's forward,
       prefill and decode ms/token; the phase's wall.
14. The two layer kinds that need no new kernel, at full width and depth
   (their registered configs), float32, random weights from a seed, O3:
   14a. SeamlessM4T-medium (12 encoder + 12 decoder layers, d 1024, 16
       heads of 64, vocab 256 206 tied; 7.15e8 parameters) on the stub
       frontend's ``enc_embeds`` (2, 512, 1024) x 0.1: the encoder alone
       (its bidirectional attention and the decoder's cross-attention are
       the naive path, as in the reference), ``forward_logits`` of 2 x 2048
       tokens, a prefill of the first 2016 and 32 decode steps fed the
       sequence's next tokens, held to the forward at rtol 2e-2 / atol
       2e-3; B4 launches once a decoder layer in the forward and in the
       prefill, and each of the 24 calls is held to the plain twin; the
       cross caches after the 32 steps must equal the prefill's bitwise
       (decode never recomputes them); B4 timed on the path's
       (2, 2016, 16, 16, 64) beside its bound (0.101 ms) and
       ``scaled_dot_product_attention``.
   14b. ``serve("rwkv6-1.6b", smoke=False)`` cut in depth to ``RWKV_DEPTH``,
       12 of 24 layers (d 2048, head size 64, d_ff 7168, vocab 65 536
       untied; the cut taken when phase 17 brought the script past 850 s)
       with phase 6's 2 batches; the path has no kernel of B1-B4 (its WKV recurrence is a
       loop over tokens, as the reference's ``lax.scan`` has no Pallas
       kernel), so no prefill may launch one; routes inside pi's support.
       Then 14a's teacher forcing on 2 x 2048 tokens, the WKV loop's share
       of the prefill's wall (a host timer around each layer's scan), and
       the kernels a prefill and a decode step launch (``torch.profiler``
       over prefills of 16 and 32 tokens: the difference is the loop's, a
       token).
15. DeepSeek-V3 (MLA) at full width (its registered config: d 7168, 128
   heads of q/k 192 (nope 128 + rope 64) and v 128 over a 512 + 64 latent
   cache, 256 routed experts top 8 and a shared one, vocab 129 280 untied),
   cut in depth to 4 of 61 layers: the three ``mla_dense`` layers (d_ff
   18 432) and one ``mla`` MoE layer; 1.51e10 parameters (60.4 GB),
   float32, random weights from a seed, O3. 13b's teacher forcing: a
   forward of 2 x 2048 tokens, a prefill of the first 2016 and 32 decode
   steps in MLA's absorbed form over the compressed cache, fed the
   sequence's next tokens, each step's logits held to the forward's
   (expanded attention through B4) at rtol 2e-2 / atol 2e-3; the routes
   compared as in 13b. B4 launches once a layer in the forward and in the
   prefill; each of the 8 calls is held to the plain twin as it is made
   (in 13b and 14a too: the twin over 8 slices of the heads, which fits
   beside the parameters), and the forward and the prefill are timed again
   without the holds. B4 timed on
   the path's (2, 2016, 128, 128) x 192 / 128 beside its bound (2.019 ms),
   the plain twin and ``scaled_dot_product_attention``; one MoE layer
   timed alone; the peak memory and the host syncs.
17. The multi-device layer on the card's world-1 NCCL (1, 1) ('data',
   'model') mesh (``make_local_mesh``): the same DTensor code as on a
   mesh of many ranks, every sharded step held to the unsharded one from
   the same state. 17a: SmolLM-135M at full width and depth, float32, O2
   (batch pins, B4 on local blocks, chunked CE), 3 ``jit_train_step`` steps
   of 2 x 2048 tokens, each against ``make_train_step`` from the state the
   sharded step started from: loss and grad norm at rtol 1e-6, every
   parameter and AdamW moment leaf within 1e-6 of its largest entry (2e-6
   for v). 17b: ``jit_prefill_step`` at O3 on 4 x 2016 tokens
   and 32 ``jit_decode_step`` steps against the unsharded prefill and
   decode, logits at atol 1e-5. 17c: Qwen3-MoE-30B-A3B at full width, 4 of
   48 layers, built on the mesh so that its MoE layers run the
   expert-parallel island: a forward of 2 x 2016 (the ZeRO path), the
   sharded prefill and 32 decode steps at batch 2 (the tiny path) against
   ``ep=None`` from the same parameters at atol 2e-5, the top-k expert
   sets compared token by token. Every B4 call is held to its twin as it
   is made; each step's wall is printed sharded and unsharded (DTensor's
   host cost per op), with the peak memory and the NCCL version.
18. The dry-run and the roofline; a fleet and the rollout lanes over two
   devices. 18a and 18b's dry-runs (``start_dryruns``, started before phase
   13) run as ``python -m repro_torch.launch.dryrun`` processes with no
   card visible, each in its own fake world: 18a SmolLM-135M and
   Qwen3-MoE-30B-A3B at train_4k on the (16, 16) mesh at O2, and the
   repaired paths (``DRYRUN_18A_REPAIRED``): SmolLM-135M's train_4k on the
   (2, 16, 16) mesh at O0 and Qwen3-MoE's EP island at 8 x 2048 on the
   (16, 16) mesh at O2, a batch narrower than the DP axis (every record
   ``ok``; bytes a card and the roofline terms printed, the multi-pod
   record's from its raw count); 18b ``DRYRUN_18B``'s SmolLM-135M
   bfloat16 O2 train step on a (1, 1) fake mesh, then run for real on the
   card's (1, 1) NCCL mesh: the estimate of bytes a card beside
   ``max_memory_allocated``, the bound beside the measured wall (gate: the
   bound may not exceed it), MFU and the roofline fraction by the
   reference's definitions; every B4 call held (bfloat16: within 3e-2 +
   2^-7 x |twin|, one rounding of its output). 18c phase 4's plan
   simulated by 7 seeds over [cuda:0, cuda:0]
   (``simulator._simulate_fleet_on``), materialized and streaming in 2
   chunks, bitwise per seed to the one-device fleet; 18d
   ``router._batched_rollout_scores_on`` over [cuda:0, cuda:0] at
   replan_wall's shapes, scores bitwise and ``best`` equal to the
   one-device program's; one B1 launch a device, every B1 call held.

The bounds (``bound``, ``gf_bound``, ``flash_bound``) are the least time
the card could take for the work: each input read once and each output
written once at 3.35 TB/s, or the operations at the peak rate of the type
the design computes in. B1's bound is its bytes. B2 and B3's are theirs:
their integer operations, counted from the design, sit under the bytes at
the INT32 peak. B4 computes float32 attention as three TF32 tensor-core
passes (3xTF32), so its bound is 3 x 2 x (hd + vd) FLOP per visible (row,
key) pair at 495 TFLOP/s (vd, v's width, is hd but for MLA's 192 / 128);
the one-pass TF32, float32-outside-the-tensor-cores and byte times stand
beside it as fields. The backward of B4's Function (torch ops, no kernel)
is bound by its float32 operations, 5 x 2 x hd per visible pair, at 67
TFLOP/s (TF32 is off).
The probes' measurements are printed beside these bounds and are not
bounds themselves: they say what this card reaches, not what it cannot
beat.

In phases 3 to 18 (4b included) every launch count is set to 0 just before
each main-path call (simulator, encode, decode, prefill, serving simulation,
replan, scenario run, checkpoint save and restore, training run, loss and
gradients, forward) and read just after; each call must have launched its
kernel. Every kernel call those paths make is recorded (or, in 13 to 15,
held as it is made), and its output is held against the plain twin on the
same inputs, B1's with the carried state the call passed: bitwise for B1
to B3 (latency and dep; B1's busy within rtol 1e-6, as in phase 2), within
atol 2e-5 for B4. Each kernel and its plain twin are timed with CUDA events
on the main path's own inputs (B2 and B3's records on the largest codec
group's).

It then prints the kernel records as one JSON line and, last, the device
line. It needs a CUDA card, and fails without one.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import (  # noqa: E402
    JLCMProblem,
    ServiceMoments,
    build_problem,
    cluster_catalog,
    duality_gap,
    effective_chunk_mb,
    empirical_objective,
    empirical_objective_device,
    evaluate_pi,
    exponential_moments,
    feasible_uniform,
    geo_problem,
    make_objective,
    materialize,
    mean_latency_bound,
    node_arrival_rates,
    project_capped_simplex,
    proportional_lb_pi,
    random_placement_mask,
    resolve_incremental,
    solve,
    solve_batch,
    solve_hierarchical,
    split_merge_bound,
    synthetic_catalog,
    volume_catalog,
)
from repro_torch import diag  # noqa: E402
from repro_torch.checkpoint import ECCheckpointStore, plan_for_params  # noqa: E402
from repro_torch.checkpoint.planner import flatten_with_keys  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.jlcm import max_ec_problem, max_ec_report  # noqa: E402
from repro_torch.kernels import fcfs_queue, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._build import BUILD_DIR, build_library  # noqa: E402
from repro_torch.kernels.fcfs_queue import (  # noqa: E402
    fcfs_scan,
    fcfs_scan_cuda,
    fcfs_scan_plain,
)
from repro_torch.kernels.gf256_matmul import (  # noqa: E402
    gf256_matmul_batched_cuda,
    gf256_matmul_batched_plain,
    gf256_matmul_cuda,
    gf256_matmul_plain,
)
from repro_torch.kernels.gf256_matmul import load_library as load_gf256  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOPS, CellCosts  # noqa: E402
from repro_torch.launch.specs import batch_specs_for  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    TrainState,
    build_model,
    gather,
    jit_decode_step,
    jit_prefill_step,
    jit_train_step,
    loss_and_grads,
    make_train_step,
    place,
)
from repro_torch.distributed.sharding import param_shardings  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.models import lm, moe, rglru, rwkv6  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.stack import _mlp_kind  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.serving import (  # noqa: E402
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
from repro_torch.serving import router as router_mod  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    get_scenario,
    hotspot_drift_hierarchical,
    run_all_policies,
    run_scenario,
)
from repro_torch.scenarios import engine as scenario_engine  # noqa: E402
from repro_torch.storage import (  # noqa: E402
    DEFAULT_SKETCH,
    CacheModel,
    CodecPlan,
    GeoFabric,
    SimDraws,
    augment_plan,
    build_repair_flow,
    decode_batch,
    encode_batch,
    geo_testbed,
    homogeneous_cluster,
    init_carry,
    lost_chunk_inventory,
    measured_fig6_moments,
    pad_and_split,
    run_segment_batch,
    run_segment_raw,
    segment_draws,
    simulate,
    simulate_fleet,
    simulate_geo_segment,
    simulate_geo_segments,
    simulate_segment,
    simulate_segments,
    simulator,
    stream_mean,
    stream_quantile,
    tahoe_testbed,
    ttl_cache_scan,
)

FLEET_SEEDS, FLEET_REQUESTS, NODES = 256, 100_000, 12
FILE_BYTES = 4 * 2**20  # per file: 32 Tahoe segments of 128 KiB
# the sweep of tests/test_kernels.py (SHAPES): (M, K, N)
GF_SHAPES = [(1, 1, 1), (3, 4, 5), (8, 8, 8), (16, 100, 64), (5, 7, 512),
             (128, 128, 128), (130, 120, 260), (256, 64, 300)]
GF_WIDE_N = 2**29 + 3  # (4, GF_WIDE_N) is larger than 2**31 bytes
# every (M, K) the §V.B codec calls: encode (n - k, k) and decode (k, k), k = 6, 7, 4
GF_CODEC_MK = [(6, 6), (5, 7), (8, 4), (7, 7), (4, 4)]
# each kernel's launch count, by the name the kernels line gives it
COUNTERS = {"fcfs_scan": fcfs_scan, "gf256_matmul": gf256_matmul_cuda,
            "gf256_matmul_batched": gf256_matmul_batched_cuda,
            "flash_attention": fa.flash_attention_cuda}
# NVIDIA's published H100 SXM peaks (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_PER_CLOCK_SM = 64  # integer instructions a clock an SM
INT32_OPS_PER_S = INT32_PER_CLOCK_SM * 132 * 1.98e9  # x SMs x boost clock
TF32_OPS_PER_S = 495e12  # tensor cores, dense
TF32_PASSES = 3  # B4's float32 path: small*big + big*small + big*big
FLASH_SHAPE = (4, 2016, 9, 3, 64)  # SmolLM-135M's prefill in phase 6: (B, T, H, KH, hd)
# phase 6: SmolLM-135M serving 4 replicas; prompt + generation fill its
# published 2048-token context. serve() runs on the (1, 1) mesh, where a
# decode step costs DTensor's host time (~230 ms at SmolLM on an H100), so
# phases 6, 13a, 14b and 16a serve 2 batches each
SERVE = dict(n_replicas=4, batch=4, prompt_len=2016, gen_len=32, n_batches=2, hedge=0)
# phase 4b: the paper's §V figures, as benchmarks/fig{6,7,9,10,11,12,13}*.py
# run them (their catalog size, request counts, rates, thetas and solver
# settings), each figure's generator seeded with its benchmark's key
FIG_FILES, FIG_MAX_ITERS, FIG_RANDOM_CP = 1000, 400, 100
FIG_REQUESTS = dict(fig6=40_000, fig7=30_000, fig9=30_000, fig10=40_000, fig11=25_000)
FIG_SEEDS = dict(fig6=0, fig7=1, fig9=0, fig10=3, fig11=4, random_cp=9)
FIG7_INV_LAMBDA = (60, 40, 32, 24, 18, 14, 12, 11, 10.5, 10, 9.5, 9)
FIG11_FILE_MB = (50.0, 100.0, 150.0, 200.0)
FIG12_SCALES = (0.55, 0.7, 0.85)  # and 1.0, which is fig11's 200 MB problem
FIG13_THETAS = (0.5, 1.0, 2.0, 10.0, 50.0, 100.0, 150.0, 200.0)
# phase 7: the planner's whole problem. 7a is benchmarks/jlcm_scaling.py's
# jlcm_hierarchical section (its catalog sizes and SOLVE_KW, the 12-node
# testbed at theta = 2), 7b benchmarks/tenant_tradeoff.py at full size and
# 7c the geo fabric (geo_testbed's four client sites) with
# benchmarks/fleet_scale.py's four files
HIER_FILES, HIER_DENSE_FILES = 1_000_000, 1000
HIER_SOLVE_KW = dict(max_iters=300, eps=0.01)
HIER_MOVED, HIER_SURGE = 0.1, 1.5  # share of the clusters whose rate moves, and by what
PLAN_FLEET = dict(n_seeds=64, n_requests=100_000)  # 7a's and 7c's fleets
PLAN_THETA, PLAN_CHUNK_MB = 2.0, 12.5
TENANT_LAM, TENANT_CLASS = (0.0675, 0.0525, 0.03, 0.0225), (0, 0, 1, 1)
TENANT_WEIGHTS, TENANT_DEADLINES = (1.0, 2.0, 4.0, 8.0, 16.0), (float("inf"), 45.0, 35.0)
TENANT_TAIL_WEIGHT, TENANT_REQUESTS, TENANT_MAX_ITERS = 10.0, 60_000, 400
GEO_LAM, GEO_MIX = (0.036, 0.028, 0.016, 0.012), (0.4, 0.25, 0.25, 0.1)
PLAN_K = (4.0, 4.0, 6.0, 6.0)  # the 4-file catalogs of 7b and 7c
GEO_ANCHORED = dict(NJ=(0.9, 0.04, 0.03, 0.03), TX=(0.04, 0.9, 0.03, 0.03))
# phase 8: the closed loop's simulator on phase 4's catalog. The hot tier
# caches a tenth of the catalog's bytes (file bytes k_i x its chunk size) at
# the cache scenarios' hit latency and hot price (src/repro/scenarios/
# library.py, cache-warmup); the frontier is benchmarks/cache_tier.py's at
# cache-warmup's constants (library.py's CACHE_LAM, spec.py's DEFAULT_K,
# 12.5 MB chunks, theta = 4, its CAPACITIES_MB, 300 iterations)
CACHE_MB, CACHE_SHARE, CACHE_HIT_LATENCY, CACHE_HOT_PRICE = float(2**20), 0.1, 0.5, 0.02
# the cache-aware re-solve stops at eps 3e-4, not fig8's 0.01: at 0.01 it
# stops after a few iterations with the TX nodes at utilisation ~0.93, which
# node 0's failure in 8b pushes past capacity
CACHE_SOLVE_KW = dict(eps=3e-4, max_iters=300)
FRONTIER_LAM, FRONTIER_K = (0.09, 0.07, 0.04, 0.03), (4.0, 4.0, 6.0, 6.0)
FRONTIER_CHUNK_MB, FRONTIER_THETA, FRONTIER_MAX_ITERS = 12.5, 4.0, 300
FRONTIER_CAPACITIES_MB = (0.0, 25.0, 50.0, 100.0, 150.0, 200.0, 250.0)
SEGMENTS, SEGMENT_REQUESTS = 8, 100_000  # 8b's schedule and 8d's geo segments
SEG_DOWN, SEG_OUTAGE = (2, 5), 6  # node 0 down in segments 2-4; the hot tier out in 6
# 8b's repair pacer: the node-failure-repair scenario's repair_rate
# (src/repro/scenarios/library.py:86, 0.05 reads/s) against its client rate
# (spec.py:28's DEFAULT_LAM, 0.115 reads/s in all), scaled to this catalog by
# that share of the client rate: repair is about 30 % of the reads in an outage
REPAIR_SHARE_OF_CLIENT = 0.05 / sum((0.045, 0.035, 0.02, 0.015))
CAND_AFTER, CANDIDATES, CAND_DRAWS = 4, 8, 4  # 8c: rollouts from the carry after segment 4
STREAM_FLEET = dict(n_seeds=64, n_chunks=8, n_requests=100_000)  # 8e
# phase 9: the control plane. 9a is benchmarks/serving_hedge.py at its sizes (6
# replicas, its rates and hedge levels, 20 000 requests, key 5 as a seed),
# with tests/test_serving.py:83's sweep; 9b benchmarks/replan_wall.py's (the
# 12-node testbed, its LAM, k = 4 of 150 MB files, 600 requests, theta = 2,
# candidates solved at 60 iterations, 8 / 16 / 32 candidates, 2 / 4 draws at
# 16, a 32-point sweep); 9c re-plans phase 8b's schedule (solves of 150
# iterations, rollouts of 20 000 requests x 2 draws from the live carry); 9d
# runs phase 7a's 10^6-file catalog at HIER_SOLVE_KW; 9e geo_testbed() with
# fleet_scale.py's files over 3 geo segments of SEGMENT_REQUESTS
HEDGE_MU = (1.0, 1.2, 0.8, 1.5, 0.9, 1.1)
HEDGE_RATES = dict(low=0.15, med=0.6)
HEDGE_LEVELS, HEDGE_REQUESTS, HEDGE_SEED = (0, 1, 2), 20_000, 5
SWEEP_THETAS = (0.0, 2.0)
WALL_LAM = (0.030, 0.020, 0.015, 0.012, 0.010, 0.008)
WALL_K, WALL_FILE_MB, WALL_REQUESTS, WALL_THETA, WALL_MAX_ITERS = 4.0, 150.0, 600, 2.0, 60
WALL_CANDIDATES, WALL_DRAWS, WALL_SWEEP = (8, 16, 32), (2, 4), 32
REPLAN_MAX_ITERS, REPLAN_ROLLOUT_REQUESTS, REPLAN_ROLLOUT_DRAWS = 150, 20_000, 2
GEO_REPLAN_MAX_ITERS, GEO_ROLLOUT_REQUESTS, GEO_REPLAN_SEGMENTS = 100, 20_000, 3
# phase 10: the scenario engine at the registered sizes and seed 0, the seed
# benchmarks/scenario_suite.py runs; 10c is hotspot-drift over a 10^5-file
# catalog as benchmarks/jlcm_scaling.py's _scenario_rows runs it
SCENARIO_SEED = 0
SCENARIO_HIER = dict(r=100_000, requests_per_segment=800)
# phase 11: SmolLM-135M's float32 parameters through the EC checkpoint store,
# planned at benchmarks/checkpoint_catalogs.py's rule: group_mb = max(64, MB /
# 200), theta = 0.5, chunk_mb = group_mb / CKPT_CHUNK_DIV. The rule's divisor
# is 8; at 8 MB chunks the four groups of 101-108 MB get k = 11 of the 12
# nodes, so n = 12 and they survive one failure, not the two this phase
# injects; at group_mb / 4 every group keeps n - k = 2 (tests/
# test_torch_checkpoint.py plans both, as the reference does)
CKPT_SEED, CKPT_THETA, CKPT_CHUNK_DIV, CKPT_READ_RATE = 0, 0.5, 4, 1 / 600.0
# phase 12: training. 12a is examples/train_lm.py's flow at full width:
# SmolLM-135M float32 at batch 8 x seq 64 and lr 3e-3 on train()'s cosine,
# the whole TrainState in the EC store (train.py's plan), a storage node
# failing mid-run, then a resume. The example trains the smoke config for
# 150 steps; at full width 150 steps move the loss by 0.1 and 600 by 1.5
# (PERF.md §6), so 600 steps with a save every 200: the first run
# saves at 200 and 400, the node fails at 500 (after the last save, so the
# restore reads parity), and the resume restores step 400 and saves it once
# more (train.py replays the saved step)
TRAIN = dict(steps=600, ckpt_every=200, fail_node_at=500, batch=8, seq=64, lr=3e-3)
# train() runs on the (1, 1) mesh, where DTensor's host cost per op sets the
# step's wall; 12a cuts SmolLM-135M's depth to TRAIN_DEPTH of its 30 layers
# (by patching train()'s get_config for the call) to keep the script in time
# (8 until phase 18 came: 158-210 s of 12a, host-bound)
TRAIN_DEPTH = 6
TRAIN_LOSS_DROP = 0.5  # examples/train_lm.py's assertion, in both runs
# 12b: one batch of SmolLM-135M's published 2048-token context, batch 2,
# through O0 (naive attention, dense CE), O2 (B4 under autograd, chunked CE)
# and O3 (O2 with each layer recomputed in the backward); the loss within
# tests/test_perf_opts.py's rtol, every gradient leaf within a relative L2
GRAD_BATCH, GRAD_SEQ, GRAD_SEED, GRAD_LOSS_RTOL, GRAD_REL_L2 = 2, 2048, 0, 2e-4, 1e-3
# phase 13: the five GQA / MoE models of head width 128 at full width (their
# registered configs). 13a serves Phi-4-mini at full depth through serve() with
# phase 6's load; 13b runs the other four cut in depth only (Gemma3: one period
# of 5 local + 1 global layers and the two suffix layers), a prefill of 2 x 2016
# tokens and 32 decode steps fed the sequence's own next tokens, each step's
# logits held to forward_logits of the whole 2 x 2048 sequence at O3 within
# tests/test_models.py's tolerance. Qwen2-VL's batch carries 4 patch
# embeddings and (3, B, S) positions, as tests/test_models.py:31-35 builds them.
PHI4_FLASH_SHAPE = (4, 2016, 24, 8, 128)  # Phi-4-mini's prefill in 13a: (B, T, H, KH, hd)
GQA_DEPTH = {"gemma3-27b": 8, "qwen3-moe-30b-a3b": 4, "starcoder2-15b": 4, "qwen2-vl-2b": 28,
             "deepseek-v3-671b": 4}
GQA_BATCH, GQA_PREFILL, GQA_DECODE, GQA_PATCHES, GQA_SEED = 2, 2016, 32, 4, 0
GQA_RTOL, GQA_ATOL = 2e-2, 2e-3
# 2c's hd = 128 cases (T, H, KH, window): G = 2, 3, 6, 8, 12 and ragged T
GQA_FLASH_CASES = [(96, 4, 2, None), (130, 6, 2, 40), (77, 24, 4, None), (200, 16, 2, 64),
                   (301, 48, 4, None), (160, 24, 8, 100), (257, 12, 1, 31)]
# phase 14: the encoder-decoder and RWKV6 at full width and depth (their
# registered configs), float32, random weights from a seed, O3. 14a runs
# SeamlessM4T-medium on 2 x 2048 tokens with the stub frontend's enc_embeds
# (2, 512, 1024) x 0.1, as tests/test_models.py:26-29 builds them: a forward,
# a prefill of 2016 tokens and 32 decode steps fed the sequence's own next
# tokens, each step held to the forward at GQA_RTOL / GQA_ATOL. 14b serves
# RWKV6-1.6B through serve() with SERVE's load, then runs 14a's teacher
# forcing on 2 x 2048 tokens; its launches are counted on two short prefills
# (RWKV_PROFILE_LENS tokens) with torch.profiler.
ENCDEC_FLASH_SHAPE = (2, 2016, 16, 16, 64)  # SeamlessM4T's decoder prefill: (B, T, H, KH, hd)
ENCDEC_ENC_SCALE = 0.1
RWKV_PROFILE_LENS = (16, 32)
RWKV_DEPTH = 12  # of 24: its WKV loop walks every token a layer (14b's prefills, ~5 s each)
# phase 15: DeepSeek-V3 at full width (its registered config), cut in depth by
# GQA_DEPTH to its three mla_dense layers and one mla (MoE) layer, float32, O3,
# through 13b's teacher forcing. MLA's prefill and forward run B4 at q/k width
# 192 (nope 128 + rope 64) and v width 128.
MLA_ARCH = "deepseek-v3-671b"
MLA_FLASH_SHAPE = (2, 2016, 128, 128, 192, 128)  # MLA's prefill: (B, T, H, KH, hd, vd)
# phase 16: RecurrentGemma-2B at full width and depth (its registered config:
# 18 RG-LRU and 8 local-attention layers, MQA at head width 256, window 2048),
# float32, random weights from a seed, O3. 16a serves it through serve() with
# SERVE's load; 16b runs 13b's teacher
# forcing on 2 x 4096 tokens, a prefill of 4064 and 32 decode steps: past the
# window, so B4's window masks keys in the forward and the prefill, and the
# local caches roll in decode. The RG-LRU scan is timed inside the prefill
# (a host timer around each layer's scan) and its kernels counted on one scan
# at the prefill's shape. B4 is timed at the forward's shape.
RG_ARCH = "recurrentgemma-2b"
RG_PREFILL = 4064
RG_FLASH_SHAPE = (2, 4096, 10, 1, 256, 2048)  # the forward's: (B, T, H, KH, hd, window)
# 13b, 14a and 15 hold each B4 call to the plain twin as it is made, the twin
# over up to HOLD_SLICES slices of the KV heads (a head's attention reads only
# its own rows): beside DeepSeek-V3's 60.4 GB of parameters, its 8 calls kept
# would take 10.7 GB and the whole twin's (T, T) scores 13 GB.
HOLD_SLICES = 8
# phase 17: the sharded steps on the card's (1, 1) mesh. 17a's batch is
# 12b's; 17b's prompt and steps are phase 6's; 17c's MoE model is 13b's cut.
SHARD_TRAIN = dict(batch=GRAD_BATCH, seq=GRAD_SEQ, steps=3, lr=TRAIN["lr"],
                   total=TRAIN["steps"])
SHARD_SERVE = dict(batch=SERVE["batch"], prompt=SERVE["prompt_len"], steps=SERVE["gen_len"])
SHARD_MOE = "qwen3-moe-30b-a3b"
SHARD_RTOL, SHARD_ATOL, SHARD_MOE_ATOL = 1e-6, 1e-5, 2e-5
# phase 18: the dry-run (its own processes and fake worlds, never the card)
# and the multi-device fleet and lanes. 18a: one dense and one MoE cell of
# the sweep; 18b: one cell the card runs whole, SmolLM-135M in bfloat16 at O2
# on the (1, 1) mesh; 18c: an odd seed count over [cuda:0, cuda:0], the
# materialized fleet at N requests and a streaming one of 2 chunks; 18d:
# replan_wall's candidates x draws (and an odd 5) through the lanes
DRYRUN_18A = ["--arch", "smollm-135m,qwen3-moe-30b-a3b", "--shape", "train_4k",
              "--mesh", "single", "--opt", "O2", "--jobs", "2"]
# 18a's repaired paths on the card host's torch: a multi-pod train cell
# (the sweep's, past 600 s before the MLP ran on each rank's block) and the
# MoE island at a batch narrower than the DP axes (8 over 16)
DRYRUN_18A_REPAIRED = {
    "18a-multi": ["--arch", "smollm-135m", "--shape", "train_4k", "--mesh", "multi",
                  "--opt", "O0"],
    "18a-moe-b8": ["--arch", "qwen3-moe-30b-a3b", "--shape", "train:8x2048", "--mesh",
                   "single", "--opt", "O2"],
}
# two earlier whole runs of this script on an H100 80GB HBM3 at 700 W,
# before the residual stream kept its placements (PERF.md §6, the dry-run's
# slice, its runs F3 and F4): 12a's phase wall (s) and 18b's median step
# (ms); they kept no 17a wall
EARLIER_WALLS = dict(phase_12a_s=(135.6, 167.6), step_18b_ms=(2155.6, 2490.0))
DRYRUN_18B = dict(arch="smollm-135m", batch=8, seq=2048, opt="O2", steps=3)
FLEET_SHARD = dict(n_seeds=7, n_requests=20_000, stream_requests=10_000, n_chunks=2)
LANE_CASES = ((8, 1), (16, 2), (5, 2))
PAPER_FIG6 = dict(mean=13.9, std=4.3, m2=211.8, m3=3476.8)  # measured (paper Fig. 6)
MMA_BLOCKS_PER_SM, MMA_ITERS = 4, 4096  # the mma probe's grid and length
LDS_BLOCKS_PER_SM, LDS_ITERS = 2, 1000  # the lookup probe's grid (512 threads) and length
# Phase 1's probes, built like the kernels (into build/repro_torch/). They
# measure three limits the published table does not give: the latency of
# B1's carried chain, the TF32 rate mma.sync reaches, and the rate of B2 and
# B3's 8-byte table lookups (random indices, with and without lane copies).
PROBES = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// B1's walker chain alone: one thread, n steps of dep = max(t, dep) + s,
// the walker's own two operations; t rises by a shorter chain of its own.
// cycles[0] gets the SM cycles of the loop.
__global__ void chain_kernel(float* out, long long* cycles, int n) {
  float dep = 0.0f, t = 0.0f;
  const long long c0 = clock64();
  for (int i = 0; i < n; ++i) {
    dep = fmaxf(t, dep) + 0.75f;
    t += 1.0f;
  }
  const long long c1 = clock64();
  out[0] = dep;
  cycles[0] = c1 - c0;
}

// mma.sync m16n8k8 TF32, B4's product instruction: each warp keeps 8
// independent accumulators in flight for `iters` steps.
__global__ void __launch_bounds__(256) mma_kernel(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int r = 0; r < 4; ++r) a[r] = __float_as_uint(1.0f + 1e-3f * (threadIdx.x % 7 + r));
  for (int r = 0; r < 2; ++r) b[r] = __float_as_uint(1.0f - 1e-3f * (threadIdx.x % 5 + r));
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float sum = 0.0f;
  for (int j = 0; j < 8; ++j) sum += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// B2/B3's table lookups alone: 8-byte shared-memory loads at random byte
// offsets, 32 a thread, reread `iters` times. private_copies 0: into one
// 2 KB table (entry e at e * 8); 1: each lane into its own copy of it, as
// the kernel reads its tables (entry e of copy c at e * 128 + c * 8, lane
// l on copy l % 16), so no two lanes of a half-warp share a bank pair.
__global__ void __launch_bounds__(512) lds_kernel(unsigned* out, int iters, int private_copies) {
  extern __shared__ uint2 lds_tab[];  // 32 KB
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) lds_tab[i] = make_uint2(i * 2654435761u, i);
  __syncthreads();
  const unsigned base = (unsigned)__cvta_generic_to_shared(lds_tab);
  unsigned off[32];
  uint32_t x = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u + 12345u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    x = x * 1664525u + 1013904223u;
    const unsigned e = x >> 24;
    off[i] = base + (private_copies ? (e << 7) | ((threadIdx.x & 15) << 3) : e << 3);
  }
  uint32_t a0 = 0, a1 = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      uint32_t v0, v1;
      asm volatile("ld.volatile.shared.v2.u32 {%0, %1}, [%2];" : "=r"(v0), "=r"(v1) : "r"(off[i]));
      a0 ^= v0;
      a1 ^= v1;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0 ^ a1;
}

extern "C" int lds_probe(void* out, int blocks, int iters, int private_copies, void* stream) {
  lds_kernel<<<blocks, 512, 32768, (cudaStream_t)stream>>>((unsigned*)out, iters, private_copies);
  return (int)cudaGetLastError();
}

extern "C" int chain_probe(void* out, void* cycles, int n, void* stream) {
  chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((float*)out, (long long*)cycles, n);
  return (int)cudaGetLastError();
}

extern "C" int mma_probe(void* out, int blocks, int iters, void* stream) {
  mma_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def paper_catalog(r: int = 1000, file_mb: float = 150.0, device="cuda"):
    """The §V.B experiment: r files in four quarters with k = 6, 7, 6, 4
    (equal file sizes, so different chunk sizes), aggregate ~0.118 req/s.
    Returns float32 ``lam`` and ``k`` on ``device`` and the per-file chunk
    sizes as numpy."""
    ks = np.zeros(r, np.float32)
    ks[0::4], ks[1::4], ks[2::4], ks[3::4] = 6, 7, 6, 4
    lam = np.zeros(r, np.float32)
    lam[0::3] = 1.25 / 10000
    lam[1::3] = 1.25 / 10000
    lam[2::3] = 1.25 / 12000
    return (
        torch.tensor(lam, device=device),
        torch.tensor(ks, device=device),
        file_mb / ks,
    )


def random_fcfs_inputs(gen, lead, n, m, device):
    """Arrivals, masks with ~5% empty rows, service times, carried state.
    Each node sees half the requests at a mean service time of 1.7 unit
    gaps, so its queue runs at ~85% utilisation."""
    lead = tuple(lead)
    exp = lambda shape: torch.empty(shape, device=device).exponential_(generator=gen)
    t = torch.cumsum(exp(lead + (n,)), dim=-1)
    masks = torch.rand(lead + (n, m), generator=gen, device=device) < 0.5
    masks &= ~(torch.rand(lead + (n,), generator=gen, device=device) < 0.05)[..., None]
    service = 0.2 + 1.5 * exp(lead + (n, m))
    return t, masks, service, exp(lead + (m,)), exp(lead + (m,))


def check_parity(got: tuple, want: tuple, label: str) -> float:
    """Kernel vs plain twin: latency (-inf rows included) and dep bitwise,
    busy bitwise or within rtol 1e-6 (the bound tests/test_fleet_parity.py
    holds the reference's backends to). Returns the largest |difference|."""
    for name, x, y in zip(("latency", "dep"), got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"{label} {name}: kernel != plain twin")
    if not torch.allclose(got[2], want[2], rtol=1e-6, atol=0.0):
        raise AssertionError(f"{label} busy: kernel differs from plain twin")
    return float((got[2] - want[2]).abs().max())


def cuda_ms(fn, reps: int):
    """Mean milliseconds per call by CUDA events, and the last call's result."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


@contextlib.contextmanager
def recorded(module, name: str):
    """Record every call a main path makes to ``module.name``: its inputs
    and the outputs it got back, so that the kernel can be held against its
    plain twin on the main path's own inputs."""
    fn = getattr(module, name)
    calls = []

    def recorder(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, recorder)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def counted(label: str, fn, kernel: str = "fcfs_scan", least: int = 1):
    """Run one main-path call with every launch count set to 0 just before
    it; return its result and ``kernel``'s count read just after, which
    must be at least ``least``."""
    for counter in COUNTERS.values():
        counter.launches = 0
    out = fn()
    launches = COUNTERS[kernel].launches
    if launches < least:
        raise AssertionError(f"{label} did not go through the {kernel} kernel")
    return out, launches


def scan_inputs(args, kwargs) -> tuple:
    """A recorded ``fcfs_scan`` call's five inputs: its carried ``dep0`` and
    ``busy0`` as the call passed them, else the idle queues it defaulted to."""
    t, masks, service = args[:3]
    carries = list(args[3:5]) + [None] * (5 - len(args))
    idle = lambda: torch.zeros(t.shape[:-1] + service.shape[-1:], device=t.device)
    dep0 = kwargs.get("dep0", carries[0])
    busy0 = kwargs.get("busy0", carries[1])
    return (t, masks, service, idle() if dep0 is None else dep0,
            idle() if busy0 is None else busy0)


def hold_against_plain(calls, label: str, time_it: bool = False) -> dict:
    """Each recorded scan's output against the plain twin on its inputs, its
    own carried state included; with ``time_it``, also time kernel and plain
    twin on the last one."""
    record = dict(max_abs_err=0.0)
    for args, kwargs, got in calls:
        inputs = scan_inputs(args, kwargs)
        service = inputs[2]
        plain_ms, want = cuda_ms(lambda: fcfs_scan_plain(*inputs), reps=1)
        err = check_parity(got, want, f"{label} {tuple(service.shape)}")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        print(f"[{label}] main-path scan {tuple(service.shape)}: kernel == plain "
              f"twin, busy max_abs_err {err}, plain twin {plain_ms:.1f} ms")
    if time_it:
        kernel_ms, _ = cuda_ms(lambda: fcfs_scan_cuda(*inputs), reps=5)
        record.update(ms=kernel_ms, plain_ms=plain_ms, **bound(*service.shape))
    return record


def bound(s: int, n: int, m: int) -> dict:
    """The least time for one scan: each input read once and each output
    written once, or its float32 operations at the card's peak rate."""
    n_bytes = s * n * (8 + 5 * m) + 16 * s * m
    n_ops = 6 * s * n * m  # max, add, 2 selects, busy add, reduction step
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return dict(
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_gb=n_bytes / 1e9,
    )


def gf_bound(batch: int, m: int, k: int, n: int) -> dict:
    """The least time for one GF(256) product: each input read once and
    each output written once. Beside it, B2/B3's own work on this design:
    ``gf_lookups`` 8-byte table lookups (one a column, k and pass of 8
    rows) and ``gf_int_ops`` integer operations, counted from the source
    per column and pass of ``rows`` rows and ``kc`` values of k: 3 a
    lookup (shift, mask, xor), the repack (16 byte permutes a 4 columns
    for rows > 4, else 8), half an operation a column for each B and C
    row's window, and one for the loop. The operations at the INT32 peak
    (64 a clock an SM at 1.98 GHz on 132 SMs) stay under the bytes on every
    codec shape, so the bytes bind."""
    n_bytes = batch * (m * k + k * n + m * n)
    cols = batch * n
    lookups = int_ops = 0
    for r0 in range(0, m, 8):
        rows = min(8, m - r0)
        for k0 in range(0, k, 7):
            kc = min(7, k - k0)
            lookups += cols * kc
            int_ops += cols * (3 * kc + (4 if rows > 4 else 2) + (kc + rows) / 2 + 1)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = int_ops / INT32_OPS_PER_S * 1e3
    return dict(
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_gb=n_bytes / 1e9,
        gf_lookups=lookups,
        gf_int_ops=int_ops,
    )


def gf_work_line(record: dict, limits: dict) -> str:
    """The design's lookups and integer operations at phase 1's rates."""
    lookup_ms = record["gf_lookups"] / limits["lookups_private_per_s"] * 1e3
    int_ms = record["gf_int_ops"] / limits["int32_per_s"] * 1e3
    return (f"its {record['gf_lookups']:.4g} lookups at phase 1's lane-private rate "
            f"{lookup_ms:.4f} ms, its {record['gf_int_ops']:.4g} integer operations at "
            f"the INT32 rate {int_ms:.4f} ms")


def flash_bound(q, k, v=None, window: int | None = None) -> dict:
    """The least time for one causal float32 attention call on B4's design:
    q, k, v read once and the output written once, or its operations,
    2 x (hd + vd) per (query row, visible key) pair (q . k and p v; the
    pairs counted from the causal mask and, with ``window``, the sliding
    window: row i sees keys (i - window, i]), done as TF32_PASSES
    tensor-core passes at the TF32 rate. v defaults to k's shape. Kept
    beside it: one TF32 pass, the same FLOP in float32 outside the tensor
    cores, and the bytes."""
    b, tq, h, hd = q.shape
    vd = k.shape[3] if v is None else v.shape[3]
    rows = np.arange(tq)
    hi = np.minimum(rows + 1, k.shape[1])
    lo = np.zeros(tq, np.int64) if window is None else np.maximum(rows - window + 1, 0)
    pairs = int(np.maximum(hi - lo, 0).sum())
    n_bytes = (q.numel() + b * tq * h * vd + k.numel() + k.numel() // hd * vd) * q.element_size()
    n_ops = 2 * (hd + vd) * pairs * b * h
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = TF32_PASSES * n_ops / TF32_OPS_PER_S * 1e3
    return dict(
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_gb=n_bytes / 1e9,
        bound_flop=n_ops,
        bound_bytes_ms=bytes_ms,
        bound_tf32_ms=n_ops / TF32_OPS_PER_S * 1e3,
        bound_fp32_ms=n_ops / FP32_OPS_PER_S * 1e3,
        bound_pairs=pairs * b * h,
    )


def hold_gf_against_plain(calls, plain, kernel, label: str, limits: dict) -> dict:
    """Each recorded GF(256) call's output against the plain twin on its
    inputs, bitwise; each call's kernel timed on its inputs, and their sum
    kept as ``sum_ms``. The record's time, bound and work are the largest
    call's."""
    largest = max(calls, key=lambda call: call[0][1].numel())
    record = dict(sum_ms=0.0)
    for args, _, got in calls:
        plain_ms, want = cuda_ms(lambda: plain(*args), reps=1)
        if not torch.equal(got, want):
            raise AssertionError(f"{label} {tuple(args[1].shape)}: kernel != plain twin")
        del want
        kernel_ms, _ = cuda_ms(lambda: kernel(*args), reps=5)
        record["sum_ms"] += kernel_ms
        print(f"[{label}] main-path call {tuple(args[0].shape)} x {tuple(args[1].shape)}: "
              f"kernel == plain twin bitwise, kernel {kernel_ms:.4f} ms, "
              f"plain twin {plain_ms:.1f} ms")
        if args is largest[0]:
            record.update(ms=kernel_ms, plain_ms=plain_ms)
    a, b = largest[0]
    shape = (1,) * (3 - a.dim()) + tuple(a.shape) + (b.shape[-1],)
    record.update(max_abs_err=0.0, **gf_bound(*shape))
    # a yardstick of the card's read-and-write rate, not a GF(256) product:
    # a device copy of B, which reads and writes as many bytes as the call
    dst = torch.empty_like(b)
    dst.copy_(b)
    copy_ms, _ = cuda_ms(lambda: dst.copy_(b), reps=5)
    del dst
    print(f"[{label}] {tuple(a.shape)} x {tuple(b.shape)} on the path's inputs: kernel "
          f"{record['ms']:.4f} ms, plain twin {record['plain_ms']:.1f} ms, bound "
          f"{record['bound_ms']:.4f} ms ({record['bound_gb']:.4f} GB, {record['bound_by']}; "
          f"{100 * record['bound_ms'] / record['ms']:.1f} % of it); "
          + gf_work_line(record, limits)
          + f"; a device copy of B ({2 * b.numel() / 1e9:.4f} GB moved) {copy_ms:.4f} ms")
    return record


def load_probes():
    """Build (once per source hash) and load the probes."""
    source = BUILD_DIR / "chip_smoke_probes.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source.write_text(PROBES)
    lib = build_library(source)
    lib.chain_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    lib.mma_probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.lds_probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.chain_probe.restype = lib.mma_probe.restype = lib.lds_probe.restype = ctypes.c_int
    return lib


def phase_build():
    """Build the three sources and the probes in parallel; return the probes
    and the card's name and power limit as nvidia-smi gives them."""
    def timed(build):
        t0 = time.perf_counter()
        out = build()
        return time.perf_counter() - t0, out

    with ThreadPoolExecutor(4) as pool:  # one nvcc per source, started together
        (fcfs_s, _), (gf_s, _), (fa_s, _), (probe_s, probes) = pool.map(
            timed, [fcfs_queue.load_library, load_gf256, fa.load_library, load_probes])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(f"[1] fcfs kernel built/loaded in {fcfs_s:.3f} s")
    print(f"[1] gf256 kernels built/loaded in {gf_s:.3f} s")
    print(f"[1] flash attention kernel built/loaded in {fa_s:.3f} s")
    print(f"[1] probes built/loaded in {probe_s:.3f} s")
    print(card)
    return probes, card


def launched(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"probe launch failed: cudaError_t {err}")


def chain_time(dev, probes, steps: int) -> tuple[float, float]:
    """B1's serial chain alone, one thread, ``steps`` steps: milliseconds
    (CUDA events, mean of 5) and SM cycles a step."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.zeros(1, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    chain = lambda: launched(probes.chain_probe(
        out.data_ptr(), cycles.data_ptr(), steps, stream))
    chain()  # warm
    ms, _ = cuda_ms(chain, reps=5)
    return ms, int(cycles.item()) / steps


def phase_limits(dev, probes) -> dict:
    """Time B1's serial chain alone and mma.sync's TF32 rate on this card."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.zeros(MMA_BLOCKS_PER_SM * 256 * torch.cuda.get_device_properties(dev)
                      .multi_processor_count, device=dev)
    chain_ms, chain_cycles = chain_time(dev, probes, FLEET_REQUESTS)
    blocks = out.numel() // 256
    mma = lambda: launched(probes.mma_probe(out.data_ptr(), blocks, MMA_ITERS, stream))
    mma()  # warm
    mma_ms, _ = cuda_ms(mma, reps=5)
    mma_flop = blocks * 8 * MMA_ITERS * 8 * 2 * 16 * 8 * 8  # 8 warps, 8 mma a step
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("mma probe gave non-finite sums")
    limits = dict(chain_ms=chain_ms, chain_cycles=chain_cycles,
                  mma_tflops=mma_flop / (mma_ms * 1e-3) / 1e12)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    limits["int32_per_s"] = INT32_PER_CLOCK_SM * sms * mhz * 1e6
    lds_out = torch.zeros(LDS_BLOCKS_PER_SM * sms * 512, dtype=torch.int32, device=dev)
    lookups = lds_out.numel() * 32 * LDS_ITERS
    for private, key in ((1, "lookups_private_per_s"), (0, "lookups_random_per_s")):
        lds = lambda: launched(probes.lds_probe(
            lds_out.data_ptr(), LDS_BLOCKS_PER_SM * sms, LDS_ITERS, private, stream))
        lds()  # warm
        lds_ms, _ = cuda_ms(lds, reps=5)
        limits[key] = lookups / (lds_ms * 1e-3)
    print(f"[1] B1's serial chain alone, one thread, {FLEET_REQUESTS} steps of "
          f"dep = max(t, dep) + s: {chain_ms:.4f} ms, {chain_cycles:.3f} SM cycles a step")
    print(f"[1] mma.sync m16n8k8 TF32 on {blocks} blocks of 8 warps, 8 accumulators a "
          f"warp: {limits['mma_tflops']:.1f} TFLOP/s ({mma_ms:.4f} ms for "
          f"{mma_flop:.4g} FLOP; the table's TF32 peak is {TF32_OPS_PER_S / 1e12:.0f})")
    peak = 16 * sms * mhz * 1e6  # 128 bytes a clock an SM, 8 bytes a lookup
    print(f"[1] 8-byte shared-memory lookups at random indices on {sms} SMs x "
          f"{LDS_BLOCKS_PER_SM} blocks of 512 threads: lane-private copies "
          f"{limits['lookups_private_per_s']:.4g}/s "
          f"({100 * limits['lookups_private_per_s'] / peak:.1f} % of 16 a clock an SM at "
          f"{mhz:.0f} MHz), one 2 KB table {limits['lookups_random_per_s']:.4g}/s "
          f"({100 * limits['lookups_random_per_s'] / peak:.1f} %); INT32 "
          f"{limits['int32_per_s']:.4g}/s ({INT32_PER_CLOCK_SM} a clock an SM at clocks.max.sm)")
    return limits


def phase_kernel_vs_plain(dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = 0.0
    for lead, n, m in [((64,), 2048, 12), ((5,), 128, 6), ((3,), 256, 40), ((), 2048, 12)]:
        t, masks, service, dep0, busy0 = random_fcfs_inputs(gen, lead, n, m, dev)
        got = fcfs_scan(t, masks, service, dep0, busy0)
        want = fcfs_scan_plain(t, masks, service, dep0, busy0)
        shape = tuple(service.shape)
        err = check_parity(got, want, str(shape))
        worst = max(worst, err)
        print(f"[2] {shape} kernel == plain twin, busy max_abs_err {err} "
              f"({int(torch.isneginf(got[0]).sum())} empty service sets, "
              f"mean latency {float(got[0][torch.isfinite(got[0])].mean()):.2f})")
    # a view (every other request) goes through the public entry point
    view = fcfs_scan(t[::2], masks[::2], service[::2], dep0, busy0)
    want = fcfs_scan_plain(t[::2].contiguous(), masks[::2].contiguous(),
                           service[::2].contiguous(), dep0, busy0)
    worst = max(worst, check_parity(view, want, "strided view"))
    print(f"[2] strided view {tuple(service[::2].shape)}: kernel == plain twin")
    # uint8 masks: any non-zero byte, not only 1, means the node serves
    for lead, n, m in [((8,), 1024, 12), ((3,), 256, 40)]:
        t, masks, service, dep0, busy0 = random_fcfs_inputs(gen, lead, n, m, dev)
        bytes_ = masks.to(torch.uint8) * torch.randint(
            1, 256, masks.shape, generator=gen, device=dev, dtype=torch.uint8)
        got = fcfs_scan(t, bytes_, service, dep0, busy0)
        worst = max(worst, check_parity(
            got, fcfs_scan_plain(t, bytes_, service, dep0, busy0), f"uint8 masks {lead}"))
        check_parity(got, fcfs_scan_plain(t, masks, service, dep0, busy0), "bool masks")
        print(f"[2] {tuple(service.shape)} uint8 masks of bytes 0..255 "
              f"({int((bytes_ > 1).sum())} above 1): kernel == plain twin")
    return worst


def phase_gf256_vs_plain(dev, limits: dict) -> None:
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    def at_offset(offset, *shape):
        """Random bytes of ``shape``, contiguous, ``offset`` bytes into a
        fresh buffer, so that its rows start off the 16-byte boundary."""
        return rand(offset + int(np.prod(shape)))[offset:].view(shape)

    cases = [("B2", ops.gf256_matmul, gf256_matmul_plain, (rand(m, k), rand(k, n)))
             for m, k, n in GF_SHAPES]
    cases.append(("B3", ops.gf256_matmul_batch, gf256_matmul_batched_plain,
                  (rand(8, 12, 12), rand(8, 12, 4099))))
    # the codec's own (M, K) (encode (n - k, k), decode (k, k)) at odd widths,
    # B starting 1..9 bytes off the 16-byte boundary; N = 1; a batch of
    # 70 001 elements, hundreds a block, each with its own tables
    for i, (m, k) in enumerate(GF_CODEC_MK):
        cases.append(("B2", ops.gf256_matmul, gf256_matmul_plain,
                      (rand(m, k), at_offset(2 * i + 1, k, 100_003 + 2 * i))))
        cases.append(("B3", ops.gf256_matmul_batch, gf256_matmul_batched_plain,
                      (rand(37, m, k), at_offset(i + 1, 37, k, 4097 + 2 * i))))
    cases.append(("B3", ops.gf256_matmul_batch, gf256_matmul_batched_plain,
                  (rand(3, 6, 6), rand(3, 6, 1))))
    cases.append(("B3", ops.gf256_matmul_batch, gf256_matmul_batched_plain,
                  (rand(70_001, 6, 6), at_offset(3, 70_001, 6, 33))))
    cases.append(("B2", ops.gf256_matmul, gf256_matmul_plain, (rand(4, 4), rand(4, GF_WIDE_N))))
    for name, fn, plain, (a, b) in cases:
        counter = COUNTERS["gf256_matmul" if name == "B2" else "gf256_matmul_batched"]
        before = counter.launches
        got = fn(a, b)
        if counter.launches != before + 1:
            raise AssertionError(f"{name} {tuple(b.shape)}: default backend did not launch")
        if not torch.equal(got, plain(a, b)):
            raise AssertionError(f"{name} {tuple(a.shape)} x {tuple(b.shape)}: kernel != plain twin")
        print(f"[2b] {name} {tuple(a.shape)} x {tuple(b.shape)} ({b.numel()} bytes, B at "
              f"{b.data_ptr() % 16} past 16): kernel == plain twin bitwise")
    kernel_ms, _ = cuda_ms(lambda: gf256_matmul_cuda(a, b), reps=5)  # the > 2**31-byte case
    record = gf_bound(1, *a.shape, b.shape[-1])
    print(f"[2b] B2 {tuple(a.shape)} x {tuple(b.shape)}: kernel {kernel_ms:.4f} ms, bound "
          f"{record['bound_ms']:.4f} ms ({record['bound_by']}; "
          f"{100 * record['bound_ms'] / kernel_ms:.1f} % of it); " + gf_work_line(record, limits))
    del a, b, got
    # the bitplane backend (torch.matmul in float32) on the card, once each
    a, b = rand(6, 6), at_offset(1, 6, 4099)
    if not torch.equal(ops.gf256_matmul(a, b, backend="bitplane"), gf256_matmul_plain(a, b)):
        raise AssertionError("bitplane backend != plain twin on the card")
    a, b = rand(5, 6, 6), rand(5, 6, 999)
    if not torch.equal(ops.gf256_matmul_batch(a, b, backend="bitplane"),
                       gf256_matmul_batched_plain(a, b)):
        raise AssertionError("batched bitplane backend != plain twin on the card")
    print("[2b] bitplane backend on CUDA tensors, (6, 6) x (6, 4099) and batched "
          "(5, 6, 6) x (5, 6, 999): == plain twin bitwise")

    # an empty extent is answered without a launch: empty for M or N, zeros
    # for K; an n == k group's encode is its data
    before = {name: c.launches for name, c in COUNTERS.items()}
    for a, b in [(rand(0, 4), rand(4, 9)), (rand(3, 4), rand(4, 0)), (rand(3, 0), rand(0, 9))]:
        got = ops.gf256_matmul(a, b)
        if got.shape != (a.shape[0], b.shape[1]) or bool(got.any()):
            raise AssertionError(f"{tuple(a.shape)} x {tuple(b.shape)} gave {tuple(got.shape)}")
    got = ops.gf256_matmul_batch(rand(2, 3, 0), rand(2, 0, 5))
    if got.shape != (2, 3, 5) or bool(got.any()):
        raise AssertionError("batched K = 0 is not zeros")
    data = rand(5, 6, 1000)
    if not torch.equal(encode_batch(data, 6), data):
        raise AssertionError("an n == k encode is not its data")
    if {name: c.launches for name, c in COUNTERS.items()} != before:
        raise AssertionError("an empty product launched a kernel")
    print("[2b] empty extents and an n == k encode: defined results, no launch")
    # a sliced (non-contiguous) view of a coded batch decodes through B3
    n, k = 8, 5
    data = rand(6, k, 4099)
    chunks = encode_batch(data, n)[:, 2:2 + k]
    before = gf256_matmul_batched_cuda.launches
    got = decode_batch(chunks, [list(range(2, 2 + k))] * 6, n, k)
    if chunks.is_contiguous() or gf256_matmul_batched_cuda.launches != before + 1:
        raise AssertionError("the sliced-view decode did not take a view through B3")
    if not torch.equal(got, data):
        raise AssertionError("the sliced-view decode differs from the data")
    print(f"[2b] decode_batch of a view {tuple(chunks.shape)}: byte-exact through B3")


def qkv_on(gen, dev, b, tq, h, kh, hd, tk=None, dtype=torch.float32, vd=None):
    """Random normal q (B,Tq,H,hd), k (B,Tk,KH,hd) and v (B,Tk,KH,vd) on the
    card (vd defaults to hd)."""
    tk = tq if tk is None else tk
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dtype)
    return rand(b, tq, h, hd), rand(b, tk, kh, hd), rand(b, tk, kh, hd if vd is None else vd)


def phase_flash_vs_plain(dev) -> float:
    """B4 against its plain twin: the reference's sweep, windows and bf16
    case, unequal and ragged lengths, a non-causal case, and SmolLM-135M's
    prefill shape. Returns the largest float32 |difference|."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    cases = [(f"causal t={t} h={h} kh={kh} hd={hd} blk={blk}", qkv_on(gen, dev, 2, t, h, kh, hd),
              dict(scale=hd**-0.5, q_blk=blk, k_blk=blk), 2e-5)
             for t, h, kh, hd, blk in [(32, 2, 2, 8, 8), (64, 4, 2, 16, 16),
                                       (48, 8, 4, 32, 16), (50, 4, 1, 16, 16)]]
    cases += [(f"window {w}", qkv_on(gen, dev, 1, 64, 4, 2, 16),
               dict(scale=0.25, window=w, q_blk=16, k_blk=16), 2e-5) for w in (8, 24)]
    cases.append(("bf16", qkv_on(gen, dev, 1, 32, 2, 2, 16, dtype=torch.bfloat16),
                  dict(scale=0.25, q_blk=16, k_blk=16), 3e-2))
    cases += [(f"bf16 hd={hd}", qkv_on(gen, dev, 1, 80, 6, 2, hd, dtype=torch.bfloat16),
               dict(scale=hd**-0.5, window=40, q_blk=16, k_blk=16), 3e-2) for hd in (8, 32, 64)]
    cases += [(f"Tq={tq} Tk={tk} window {w}", qkv_on(gen, dev, 2, tq, 6, 2, 16, tk=tk),
               dict(scale=0.25, window=w, q_blk=16, k_blk=16), 2e-5)
              for tq, tk, w in [(24, 40, None), (40, 24, None), (40, 24, 8)]]
    cases.append(("non-causal", qkv_on(gen, dev, 2, 32, 4, 2, 8),
                  dict(scale=0.3, causal=False, q_blk=16, k_blk=16), 2e-5))
    b, t, h, kh, hd = FLASH_SHAPE
    cases.append((f"SmolLM prefill {FLASH_SHAPE}", qkv_on(gen, dev, b, t, h, kh, hd),
                  dict(scale=hd**-0.5, q_blk=1024, k_blk=2048), 2e-5))
    cases.append(("hd=64 window 300, ragged", qkv_on(gen, dev, 1, 1000, h, kh, hd),
                  dict(scale=hd**-0.5, window=300, q_blk=512, k_blk=512), 2e-5))
    # hd = 128, the GQA models' width: their groups G = 2, 3, 6, 8, 12, causal
    # and windowed, ragged T, float32 and bfloat16, and Phi-4-mini's prefill
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        cases += [(f"hd=128 {str(dtype)[6:]} G={h // kh} T={t}" + (f" window {w}" if w else ""),
                   qkv_on(gen, dev, 2, t, h, kh, 128, dtype=dtype),
                   dict(scale=128**-0.5, window=w, q_blk=1024, k_blk=2048), atol)
                  for t, h, kh, w in GQA_FLASH_CASES]
    b, t, h, kh, hd = PHI4_FLASH_SHAPE
    cases.append((f"Phi-4-mini prefill {PHI4_FLASH_SHAPE}", qkv_on(gen, dev, b, t, h, kh, hd),
                  dict(scale=hd**-0.5, q_blk=1024, k_blk=2048), 2e-5))
    # hd = 64 at G = 1 (plain MHA): SeamlessM4T's decoder prefill, and a ragged
    # T with a window, in float32 and bfloat16
    b, t, h, kh, hd = ENCDEC_FLASH_SHAPE
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        cases += [
            (f"SeamlessM4T prefill {ENCDEC_FLASH_SHAPE} {str(dtype)[6:]}",
             qkv_on(gen, dev, b, t, h, kh, hd, dtype=dtype),
             dict(scale=hd**-0.5, q_blk=1024, k_blk=2048), atol),
            (f"hd=64 G=1 {str(dtype)[6:]} T=1001 window 300",
             qkv_on(gen, dev, 2, 1001, h, kh, hd, dtype=dtype),
             dict(scale=hd**-0.5, window=300, q_blk=1024, k_blk=2048), atol)]
    # MLA's widths, q/k 192 and v 128: DeepSeek-V3's prefill, a ragged T with
    # a few heads, and G = 2 with a window (the template is GQA-general)
    b, t, h, kh, hd, vd = MLA_FLASH_SHAPE
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        name = str(dtype)[6:]
        cases += [
            (f"DeepSeek-V3 prefill {MLA_FLASH_SHAPE} {name}",
             qkv_on(gen, dev, b, t, h, kh, hd, dtype=dtype, vd=vd),
             dict(scale=hd**-0.5, q_blk=1024, k_blk=2048), atol),
            (f"qk192 v128 G=1 {name} T=1001",
             qkv_on(gen, dev, 2, 1001, 4, 4, hd, dtype=dtype, vd=vd),
             dict(scale=hd**-0.5, q_blk=1024, k_blk=2048), atol),
            (f"qk192 v128 G=2 {name} T=300 window 100",
             qkv_on(gen, dev, 2, 300, 8, 4, hd, dtype=dtype, vd=vd),
             dict(scale=hd**-0.5, window=100, q_blk=1024, k_blk=2048), atol)]
    # head width 256, RecurrentGemma's local layers (MQA, G = 10 at KH = 1):
    # its forward's shape with the 2048 window, a ragged T with a window,
    # unequal lengths, and G = 2, in float32 and bfloat16
    b, t, h, kh, hd, w = RG_FLASH_SHAPE
    for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        name = str(dtype)[6:]
        cases += [
            (f"RecurrentGemma forward {RG_FLASH_SHAPE[:5]} window {w} {name}",
             qkv_on(gen, dev, b, t, h, kh, hd, dtype=dtype),
             dict(scale=hd**-0.5, window=w, q_blk=1024, k_blk=2048), atol),
            (f"hd=256 G=10 {name} T=1001 window 300",
             qkv_on(gen, dev, 2, 1001, 10, 1, hd, dtype=dtype),
             dict(scale=hd**-0.5, window=300, q_blk=1024, k_blk=2048), atol),
            (f"hd=256 G=10 {name} Tq=40 Tk=72 window 24",
             qkv_on(gen, dev, 2, 40, 10, 1, hd, tk=72, dtype=dtype),
             dict(scale=hd**-0.5, window=24, q_blk=16, k_blk=16), atol),
            (f"hd=256 G=2 {name} Tq=130 Tk=97",
             qkv_on(gen, dev, 1, 130, 4, 2, hd, tk=97, dtype=dtype),
             dict(scale=hd**-0.5, q_blk=1024, k_blk=2048), atol)]
    worst = 0.0
    for label, (q, k, v), kw, atol in cases:
        before = fa.flash_attention_cuda.launches
        got = fa.flash_attention(q, k, v, **kw)
        if fa.flash_attention_cuda.launches != before + 1:
            raise AssertionError(f"{label}: flash_attention did not launch B4")
        want = fa.flash_attention_plain(q, k, v, **kw)
        if got.dtype != q.dtype or got.shape != q.shape[:3] + v.shape[3:]:
            raise AssertionError(f"{label}: output {got.dtype} {tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max())
        if not err <= atol:
            raise AssertionError(f"{label}: kernel differs from plain twin by {err} > {atol}")
        if q.dtype == torch.float32:
            worst = max(worst, err)
        print(f"[2c] B4 {label}: kernel == plain twin, max_abs_err {err:.3g} (atol {atol})")
        if (label.startswith(("SmolLM", "Phi-4", "SeamlessM4T", "DeepSeek", "RecurrentGemma"))
                or "window" in label) and q.dtype == torch.float32:
            fb = flash_bound(q, k, v, window=kw.get("window"))
            print(f"[2c] B4 {tuple(q.shape)} x {tuple(k.shape)} window {kw.get('window')} bound "
                  f"{fb['bound_ms']:.4f} ms (3xTF32, {fb['bound_pairs']:.4g} visible pairs, "
                  f"{fb['bound_flop']:.4g} FLOP x {TF32_PASSES}); one TF32 pass "
                  f"{fb['bound_tf32_ms']:.4f} ms, float32 off the tensor cores "
                  f"{fb['bound_fp32_ms']:.4f} ms, bytes {fb['bound_bytes_ms']:.4f} ms")
    q, k, v = qkv_on(gen, dev, 1, 50, 2, 2, 8)
    try:
        fa.flash_attention(q, k, v, scale=0.3, causal=False, q_blk=16, k_blk=16)
    except ValueError:
        print("[2c] non-causal attention that needs key padding raises ValueError")
    else:
        raise AssertionError("non-causal padding did not raise")
    return worst


def phase_quickstart(dev) -> tuple[int, float]:
    cluster = tahoe_testbed(device=dev)
    ks = torch.tensor([6.0, 7.0, 4.0], device=dev)
    lam = torch.full((3,), 0.125 / 3, device=dev)
    chunk_mb = float(np.mean(200.0 / np.array([6.0, 7.0, 4.0])))
    launches, worst = 0, 0.0
    for theta in (0.5, 200.0):
        prob = JLCMProblem(lam=lam, k=ks, moments=cluster.moments(chunk_mb),
                           cost=cluster.cost, theta=theta)
        t0 = time.perf_counter()
        sol = solve(prob, max_iters=300)
        solve_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(0)
        with recorded(simulator, "fcfs_scan") as calls:
            sim, n = counted("simulate", lambda: simulate(
                gen, sol.pi, lam, cluster, chunk_mb, 20000))
        launches += n
        mean, bound = float(sim.mean_latency()), float(sol.latency_tight)
        print(f"[3] theta={theta}: n_i={sol.n.tolist()} cost={float(sol.cost):.2f} "
              f"bound={bound:.3f}s simulated={mean:.3f}s "
              f"iterations={int(sol.iterations)} solve={solve_s:.2f}s fcfs launches {n}")
        if not mean <= bound * 1.05:
            raise AssertionError(f"theta={theta}: simulated {mean} > bound {bound} x 1.05")
        worst = max(worst, hold_against_plain(calls, "3")["max_abs_err"])
    return launches, worst


def phase_catalog(dev, limits: dict) -> tuple[int, dict, object, torch.Tensor]:
    cluster = tahoe_testbed(device=dev)
    lam, ks, chunk = paper_catalog(1000, device=dev)
    eff_chunk = float(np.average(chunk, weights=lam.cpu().numpy()))
    prob = JLCMProblem(lam=lam, k=ks, moments=cluster.moments(eff_chunk),
                       cost=cluster.cost, theta=2.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve(prob, eps=0.01, max_iters=300)
    trace = sol.objective_trace.cpu().numpy()
    solve_s = time.perf_counter() - t0
    iters = len(trace) - 1
    bound = float(sol.latency_tight)
    n_i = sol.n.cpu().numpy()
    print(f"[4] r=1000 solve: {iters} iterations in {solve_s:.3f} s, "
          f"bound={bound:.3f}s cost={float(sol.cost):.1f} "
          f"mean n_i by quarter k=6,7,6,4: {[float(n_i[q::4].mean()) for q in range(4)]}")
    if not (np.diff(trace) <= 1e-2).all():
        raise AssertionError(f"objective trace rises: {trace}")
    if iters > 250:
        raise AssertionError(f"solve took {iters} > 250 iterations")

    fabric = GeoFabric.single_site(cluster)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(simulator, "fcfs_scan") as calls:
        fleet, launches = counted("simulate_fleet", lambda: simulate_fleet(
            gen, sol.pi, lam[None], fabric, eff_chunk, FLEET_REQUESTS, FLEET_SEEDS))
        mean = float(fleet.mean_latency())
    fleet_s = time.perf_counter() - t0
    warm = FLEET_REQUESTS // 10
    if fleet.latency.shape != (FLEET_SEEDS, FLEET_REQUESTS - warm):
        raise AssertionError(f"fleet latency shape {tuple(fleet.latency.shape)}")
    if not bool(torch.isfinite(fleet.latency).all()):
        raise AssertionError("fleet latencies are not all finite")
    if not mean <= bound * 1.05:
        raise AssertionError(f"fleet mean {mean} > bound {bound} x 1.05")
    per_seed = fleet.latency.mean(dim=1)
    print(f"[4] fleet {FLEET_SEEDS} seeds x {FLEET_REQUESTS} requests: "
          f"mean={mean:.3f}s (per-seed {float(per_seed.min()):.2f}.."
          f"{float(per_seed.max()):.2f}) bound={bound:.3f}s, "
          f"wall {fleet_s:.3f} s, {FLEET_SEEDS * FLEET_REQUESTS / fleet_s:.4g} req/s, "
          f"fcfs launches {launches}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    record = hold_against_plain(calls, "4", time_it=True)
    print(f"[4] {tuple(calls[-1][0][2].shape)} on the fleet's inputs: kernel "
          f"{record['ms']:.4f} ms, plain twin {record['plain_ms']:.1f} ms, bound "
          f"{record['bound_ms']:.4f} ms ({record['bound_gb']:.3f} GB, {record['bound_by']}; "
          f"{100 * record['bound_ms'] / record['ms']:.1f} % of it); its serial chain alone "
          f"{limits['chain_ms']:.4f} ms (phase 1)")
    return launches, record, sol, ks


def row(sols, i: int):
    """Instance ``i`` of a batched JLCMSolution."""
    return type(sols)(*(None if f is None else f[i] for f in sols))


def timed_solve_batch(label: str, problems, dev):
    """One ``solve_batch`` at the figures' settings; prints each instance's
    iterations and the loop's wall."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = solve_batch(problems, max_iters=FIG_MAX_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = sols.iterations.tolist()
    print(f"[4b] solve_batch {label}: {len(problems)} instances at r = {sols.pi.shape[1]}, "
          f"iterations {iters}, loop of {max(iters)} iterations, wall {wall:.3f} s "
          f"({wall / max(iters) * 1e3:.2f} ms an iteration)")
    return sols, wall


def fig6_service(dev, failed: list) -> None:
    """Fig. 6: sampled service time is not exponential (KS distance)."""
    for name, cl in (("homogeneous_cluster(7)", homogeneous_cluster(7, device=dev)),
                     ("tahoe_testbed", tahoe_testbed(device=dev))):
        gen = torch.Generator(device=dev).manual_seed(FIG_SEEDS["fig6"])
        s = cl.sample_service(gen, 12.5, (FIG_REQUESTS["fig6"],)).reshape(-1).double()
        mean, std = float(s.mean()), float(s.std(correction=0))
        m2, m3 = float((s**2).mean()), float((s**3).mean())
        xs = torch.sort(s).values
        emp = torch.arange(1, xs.numel() + 1, dtype=torch.float64, device=dev) / xs.numel()
        ks = float((emp - (1.0 - torch.exp(-xs / mean))).abs().max())
        print(f"[4b] fig6 {name}: mean {mean:.3f} std {std:.3f} m2 {m2:.1f} m3 {m3:.1f} "
              f"(paper {PAPER_FIG6['mean']} / {PAPER_FIG6['std']} / {PAPER_FIG6['m2']} / "
              f"{PAPER_FIG6['m3']}), KS distance to Exp(mean) {ks:.4f}")
        if name.startswith("homogeneous") and not ks > 0.3:
            failed.append(f"fig6: KS distance {ks} <= 0.3 (service looks exponential)")
    measured_fig6_moments(device=dev).validate()
    print("[4b] fig6 measured_fig6_moments().validate() passes")


def phase_figures(dev, probes) -> tuple[int, float]:
    """Phase 4b: the paper's §V figures on the card, through the port's
    entry points. Every simulation is a main-path call (counts reset before
    it, B1 required); every scan is recorded, and each figure's scans are
    stacked on the seed axis and held bitwise against the plain twin.
    Returns B1's launches and the largest busy |difference|."""
    t_phase = time.perf_counter()
    failed: list[str] = []
    scans: dict[str, list] = {}
    launches = 0
    gen = lambda fig: torch.Generator(device=dev).manual_seed(FIG_SEEDS[fig])

    def sim(fig, *args, **kwargs):
        nonlocal launches
        with recorded(simulator, "fcfs_scan") as calls:
            out, n = counted(f"{fig} simulate", lambda: simulate(*args, **kwargs))
        launches += n
        scans.setdefault(fig, []).extend(calls)
        return out

    fig6_service(dev, failed)

    # Fig. 7: one (7, 4) file on the homogeneous Fig.-6 cluster, pi = k/n
    cl7 = homogeneous_cluster(7, device=dev)
    mom7 = cl7.moments(12.5)
    mom_exp = exponential_moments(torch.full((7,), 1 / 13.9, device=dev))
    pi7 = torch.full((1, 7), 4 / 7, device=dev)
    theirs_all = []
    for inv_lam in FIG7_INV_LAMBDA:
        lam = torch.tensor([1.0 / inv_lam], device=dev)
        ours = float(mean_latency_bound(pi7, lam, mom7))
        ours_exp = float(mean_latency_bound(pi7, lam, mom_exp))
        theirs = float(split_merge_bound(7, 4, 1 / 13.9, lam[0]))
        simulated = float(sim("fig7", gen("fig7"), pi7, lam, cl7, 12.5,
                              FIG_REQUESTS["fig7"]).mean_latency())
        theirs_all.append(theirs)
        print(f"[4b] fig7 1/lam {inv_lam}: ours (measured moments) {ours:.3f}, ours "
              f"(exponential) {ours_exp:.3f}, [43] split-merge {theirs:.3f}, "
              f"simulated {simulated:.3f}")
        if not simulated <= ours * 1.03:
            failed.append(f"fig7 1/lam={inv_lam}: simulated {simulated} > ours {ours} x 1.03")
    if not any(np.isinf(theirs_all)):
        failed.append("fig7: [43]'s split-merge bound diverges at no rate")

    # one batch of the r = 1000 problems: fig11's file sizes at theta = 2
    # (150 MB is fig9's and fig10's plan), fig12's rate scales at 200 MB,
    # and Maximum EC's theta = 0, full-support problem on the 150 MB plan
    cl = tahoe_testbed(device=dev)
    catalog, problems = [], []
    for file_mb in FIG11_FILE_MB:
        lam, ks, chunk = paper_catalog(FIG_FILES, file_mb, device=dev)
        eff = float(np.average(chunk, weights=lam.cpu().numpy()))
        catalog.append((lam, ks, torch.tensor(chunk, dtype=torch.float32, device=dev), eff))
        problems.append(JLCMProblem(lam=lam, k=ks, moments=cl.moments(eff), cost=cl.cost,
                                    theta=2.0))
    problems += [problems[3]._replace(lam=problems[3].lam * scale) for scale in FIG12_SCALES]
    problems.append(max_ec_problem(problems[2]))
    sols, _ = timed_solve_batch("figs 9-12 + Maximum EC", problems, dev)

    # Fig. 9: four schemes on the 150 MB plan, by bound and by simulation
    lam, ks, chunk_t, eff = catalog[2]
    mom = problems[2].moments
    jlcm = row(sols, 2)
    schemes = {}

    def score(name, pi, cost):
        bound = float(mean_latency_bound(pi, lam, mom))
        simulated = float(sim("fig9", gen("fig9"), pi, lam, cl, eff, FIG_REQUESTS["fig9"],
                              per_file_chunk_mb=chunk_t).mean_latency())
        schemes[name] = bound + 2.0 * cost
        print(f"[4b] fig9 {name}: bound {bound:.3f}, simulated {simulated:.3f}, "
              f"storage cost {cost:.1f}, objective {schemes[name]:.3f}")

    score("JLCM", jlcm.pi, float(jlcm.cost))
    score("Oblivious LB", proportional_lb_pi(jlcm.placement, ks, mom), float(jlcm.cost))
    u = torch.rand((FIG_RANDOM_CP,) + tuple(jlcm.pi.shape), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(FIG_SEEDS["random_cp"]))
    masks = random_placement_mask(u, jlcm.n)
    pis = proportional_lb_pi(masks, ks, mom)
    best = int(torch.argmin(mean_latency_bound(pis, lam, mom)))
    score(f"Random CP (best of {FIG_RANDOM_CP})", pis[best],
          float(torch.where(masks[best], cl.cost, 0.0).sum()))
    mec = max_ec_report(problems[2], row(sols, 7))
    score("Maximum EC", mec.pi, float(mec.cost))
    others = min(v for k, v in schemes.items() if k != "JLCM")
    if not schemes["JLCM"] <= others * 1.02:
        failed.append(f"fig9: JLCM {schemes['JLCM']} > best other {others} x 1.02")

    # Fig. 10: the 150 MB plan's latency by k group, with the sketch
    res = sim("fig10", gen("fig10"), jlcm.pi, lam, cl, eff, FIG_REQUESTS["fig10"],
              per_file_chunk_mb=chunk_t, sketch=DEFAULT_SKETCH)
    fig10_checks(res, ks, jlcm.n, failed)

    # Fig. 11: latency against file size, simulated and bounded
    sims, bounds = [], []
    for i, file_mb in enumerate(FIG11_FILE_MB):
        lam_i, _, chunk_i, eff_i = catalog[i]
        s = row(sols, i)
        bounds.append(float(mean_latency_bound(s.pi, lam_i, problems[i].moments)))
        sims.append(float(sim("fig11", gen("fig11"), s.pi, lam_i, cl, eff_i,
                              FIG_REQUESTS["fig11"], per_file_chunk_mb=chunk_i).mean_latency()))
    margs = [(sims[i] - sims[i - 1]) / (FIG11_FILE_MB[i] - FIG11_FILE_MB[i - 1])
             for i in range(1, len(sims))]
    print(f"[4b] fig11 file MB {FIG11_FILE_MB}: simulated {np.round(sims, 3).tolist()}, "
          f"bound {np.round(bounds, 3).tolist()}, marginal s/MB {np.round(margs, 5).tolist()}")
    if not margs[-1] > margs[0]:
        failed.append(f"fig11: marginal s/MB does not rise {margs}")
    for mb, simulated, bound_i in zip(FIG11_FILE_MB, sims, bounds):
        if not simulated <= bound_i * 1.03:
            failed.append(f"fig11 {mb} MB: simulated {simulated} > bound {bound_i} x 1.03")

    # Fig. 12: cost and bound against the arrival rate scale, 200 MB
    rows12 = [row(sols, i) for i in (4, 5, 6, 3)]
    cost12 = [float(x.cost) for x in rows12]
    tight12 = [float(x.latency_tight) for x in rows12]
    print(f"[4b] fig12 rate scales {FIG12_SCALES + (1.0,)}: storage cost {cost12}, "
          f"latency_tight {np.round(tight12, 3).tolist()}, mean n "
          f"{[round(float(x.n.float().mean()), 3) for x in rows12]}")
    if not cost12[-1] >= cost12[0] - 1e-6:
        failed.append(f"fig12: higher load bought less redundancy {cost12}")
    if not tight12[-1] > tight12[0]:
        failed.append(f"fig12: the bound does not rise with load {tight12}")

    # Fig. 13: the theta sweep on three 200 MB files, one batch
    ks3 = torch.tensor([6.0, 7.0, 4.0], device=dev)
    lam3 = torch.full((3,), 0.125 / 3, device=dev)
    mom3 = cl.moments(float(np.mean(200.0 / np.array([6.0, 7.0, 4.0]))))
    sols13, _ = timed_solve_batch("fig13 theta sweep", [
        JLCMProblem(lam=lam3, k=ks3, moments=mom3, cost=cl.cost, theta=t)
        for t in FIG13_THETAS], dev)
    cost13, tight13 = sols13.cost.tolist(), sols13.latency_tight.tolist()
    print(f"[4b] fig13 theta {FIG13_THETAS}: storage cost {np.round(cost13, 3).tolist()}, "
          f"latency_tight {np.round(tight13, 3).tolist()}")
    if not cost13[0] >= cost13[-1]:
        failed.append(f"fig13: cost does not fall with theta {cost13}")
    if not tight13[0] <= tight13[-1] * 1.05:
        failed.append(f"fig13: latency does not rise with theta {tight13}")

    worst = hold_figure_scans(scans, dev, probes)
    print(f"[4b] figures: fcfs launches {launches}, phase wall "
          f"{time.perf_counter() - t_phase:.3f} s")
    if failed:
        raise AssertionError("figure claims failed: " + "; ".join(failed))
    return launches, worst


def fig10_checks(res, ks, n_files, failed: list) -> None:
    """Fig. 10's per-k quantiles and per-class stats, and the sketch's
    guarantees against the exact latencies on the card."""
    lat, fid = res.latency, res.file_id
    k_of = ks[fid]
    groups = sorted(set(ks.tolist()))
    for k_grp in groups:
        sel = k_of == k_grp
        lat_k = lat[sel].cpu().numpy()
        qs = np.quantile(lat_k, [0.5, 0.9, 0.95])
        print(f"[4b] fig10 k={int(k_grp)} (mean n {float(n_files[fid][sel].float().mean()):.2f}): "
              f"p50 {qs[0]:.3f} p90 {qs[1]:.3f} p95 {qs[2]:.3f} mean {lat_k.mean():.3f} s")
    class_of_file = np.searchsorted(groups, ks.cpu().numpy())
    stats = res.per_class_stats(class_of_file, len(groups))
    print(f"[4b] fig10 per_class_stats by k {groups}: count {stats.count.tolist()}, mean "
          f"{np.round(stats.mean, 3).tolist()}, p95 {np.round(stats.p95, 3).tolist()}, "
          f"p99 {np.round(stats.p99, 3).tolist()}")
    n = lat.shape[0]
    stream = res.stream
    if int(stream.count) != n or int(stream.hist.sum()) != n:
        failed.append(f"fig10 sketch: count {int(stream.count)}, hist sum "
                      f"{int(stream.hist.sum())}, {n} requests")
    mean, smean = float(lat.mean()), float(stream_mean(stream))
    if not abs(smean - mean) <= 1e-4 * abs(mean):
        failed.append(f"fig10 sketch: mean {smean} vs {mean}")
    line = []
    for q in (0.5, 0.9, 0.95, 0.99):
        # the sketch's rank, ceil(q n) in float32, and its exact order statistic
        rank = int(torch.ceil(q * stream.count.to(torch.float32)))
        exact = float(torch.kthvalue(lat, rank).values)
        est = float(stream_quantile(stream, q))
        # its float32 edges step by the growth factor within two float32 ulps
        if not exact <= est <= DEFAULT_SKETCH.growth * exact * (1 + 2**-22):
            failed.append(f"fig10 sketch p{q}: {est} outside [{exact}, g x {exact}]")
        line.append(f"p{round(q * 100)} {est:.4f} (x_({rank}) {exact:.4f})")
    print(f"[4b] fig10 sketch over {n} requests: count {int(stream.count)}, mean {smean:.5f} "
          f"(exact {mean:.5f}); " + ", ".join(line) + f"; growth {DEFAULT_SKETCH.growth:.6f}")


def hold_stacked(calls, phase: str, name: str, dev) -> float:
    """Main-path scans that share N and m (batched or not), joined on the
    seed axis, each with its own carried ``dep0`` and ``busy0``, and held
    bitwise against one run of the plain twin, whose time is a loop over N
    whatever the seeds; returns the largest busy |difference|."""
    n, m = calls[0][0][2].shape[-2:]
    join = lambda xs, *event: torch.cat([x.reshape((-1,) + event) for x in xs])
    inputs = [scan_inputs(args, kwargs) for args, kwargs, _ in calls]
    t, masks, service, dep0, busy0 = (
        join([x[j] for x in inputs], *event)
        for j, event in enumerate([(n,), (n, m), (n, m), (m,), (m,)]))
    del inputs
    got = tuple(join([c[2][j] for c in calls], *event)
                for j, event in enumerate([(n,), (m,), (m,)]))
    plain_ms, want = cuda_ms(lambda: fcfs_scan_plain(t, masks, service, dep0, busy0), reps=1)
    err = check_parity(got, want, f"{phase} {name} {tuple(service.shape)}")
    print(f"[{phase}] {name}: {len(calls)} main-path scans stacked {tuple(service.shape)}: kernel == plain twin, busy max_abs_err {err}, "
          f"plain twin {plain_ms:.1f} ms")
    return err


def hold_figure_scans(scans: dict, dev, probes) -> float:
    """Each figure's scans stacked on the seed axis (they share N and m)
    against one run of the plain twin, bitwise; then B1 timed on fig10's
    one-seed scan beside its byte bound and the serial chain alone."""
    worst = max(hold_stacked(calls, "4b", fig, dev) for fig, calls in scans.items())
    t, masks, service, dep0, busy0 = (
        x[None].contiguous() for x in scan_inputs(*scans["fig10"][0][:2]))
    scan = lambda: fcfs_scan_cuda(t, masks, service, dep0, busy0)
    scan()  # warm
    kernel_ms, _ = cuda_ms(scan, reps=20)
    b = bound(*service.shape)
    chain_ms, chain_cycles = chain_time(dev, probes, service.shape[1])
    print(f"[4b] B1 at fig10's {tuple(service.shape)}: kernel {kernel_ms:.4f} ms, bound "
          f"{b['bound_ms']:.5f} ms ({b['bound_gb'] * 1e3:.3f} MB, {b['bound_by']}); its serial "
          f"chain alone at {service.shape[1]} steps {chain_ms:.4f} ms "
          f"({chain_cycles:.3f} SM cycles a step)")
    return worst


def split_payloads(gen, count: int, k: int, dev) -> torch.Tensor:
    """``count`` random FILE_BYTES payloads on the card, each split into k
    zero-padded rows as ``pad_and_split`` does: (count, k, ceil(L / k))."""
    payload = torch.randint(0, 256, (count, FILE_BYTES), generator=gen, device=dev,
                            dtype=torch.uint8)
    chunk = -(-FILE_BYTES // k)
    rows = torch.zeros((count, k * chunk), dtype=torch.uint8, device=dev)
    rows[:, :FILE_BYTES] = payload
    rows = rows.view(count, k, chunk)
    if not np.array_equal(rows[0].cpu().numpy(), pad_and_split(payload[0].cpu().numpy(), k)):
        raise AssertionError(f"k={k}: the split differs from pad_and_split")
    return rows


def phase_data_plane(dev, sol, ks, limits: dict) -> dict:
    t_start = time.perf_counter()
    plan = CodecPlan.from_solution(sol, ks)
    print(f"[5] codec plan: {plan.r} files on {plan.m} nodes; groups " + ", ".join(
        f"(n={g.n}, k={g.k}) x {len(g.file_ids)}" for g in plan.groups))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(2024)
    data = {(g.n, g.k): split_payloads(gen, len(g.file_ids), g.k, dev) for g in plan.groups}
    where = {int(f): ((g.n, g.k), row) for g in plan.groups for row, f in enumerate(g.file_ids)}

    coded, enc_launches = {}, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(ops, "gf256_matmul_cuda") as enc_calls:
        for g in plan.groups:
            key = (g.n, g.k)
            coded[key], n = counted(f"encode_batch {key}", lambda: encode_batch(data[key], g.n),
                                    "gf256_matmul")
            enc_launches += n
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    user_gb = sum(x.numel() for x in data.values()) / 1e9
    coded_gb = sum(x.numel() for x in coded.values()) / 1e9
    print(f"[5] encode: {user_gb:.3f} GB of rows -> {coded_gb:.3f} GB coded in {encode_s:.3f} s, "
          f"gf256_matmul launches {enc_launches}")
    b2 = hold_gf_against_plain(enc_calls, gf256_matmul_plain, gf256_matmul_cuda, "5 encode",
                               limits)
    print(f"[5] encode: its {len(enc_calls)} B2 calls take {b2['sum_ms']:.4f} ms of the "
          f"{encode_s * 1e3:.3f} ms encode wall ({100 * b2['sum_ms'] / (encode_s * 1e3):.1f} %)")
    enc_calls.clear()

    failed = np.zeros(plan.m, bool)
    failed[0] = True
    hurt = np.nonzero(lost_chunk_inventory(plan.placement, failed))[0]
    if len(hurt) != plan.r:
        raise AssertionError(f"node 0 held chunks of {len(hurt)} files, expected {plan.r}")
    patterns, chunks = [], []
    for f in hurt:
        key, row = where[int(f)]
        patterns.append(plan.degraded_patterns(int(f), [0]))
        chunks.append(coded[key][row, torch.tensor(patterns[-1], device=dev)])
    del coded
    parity_reads = sum(max(p) >= int(plan.k[f]) for p, f in zip(patterns, hurt))
    print(f"[5] node 0 failed: {len(hurt)} of {plan.r} files lost a chunk; "
          f"{parity_reads} degraded reads need a parity row")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(ops, "gf256_matmul_batched_cuda") as dec_calls:
        decoded, dec_launches = counted(
            "decode_requests", lambda: plan.decode_requests(list(hurt), patterns, chunks),
            "gf256_matmul_batched")
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    exact = sum(torch.equal(decoded[j], data[where[int(f)][0]][where[int(f)][1]])
                for j, f in enumerate(hurt))
    print(f"[5] decode_requests: {exact} of {len(hurt)} files decoded byte-exact in "
          f"{decode_s:.3f} s, gf256_matmul_batched launches {dec_launches}")
    if exact != plan.r:
        raise AssertionError(f"only {exact} of {plan.r} files decoded byte-exact")
    del decoded, chunks
    b3 = hold_gf_against_plain(dec_calls, gf256_matmul_batched_plain,
                               gf256_matmul_batched_cuda, "5 decode", limits)
    print(f"[5] decode: its {len(dec_calls)} B3 calls take {b3['sum_ms']:.4f} ms of the "
          f"{decode_s * 1e3:.3f} ms decode wall ({100 * b3['sum_ms'] / (decode_s * 1e3):.1f} %)")
    dec_calls.clear()
    print(f"[5] data plane: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"phase wall {time.perf_counter() - t_start:.3f} s")
    return {"gf256_matmul": (enc_launches, b2), "gf256_matmul_batched": (dec_launches, b3)}


def phase_serve(dev, limits: dict) -> tuple[int, dict]:
    """SmolLM-135M at full width and depth behind the JLCM router."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prefill_launches = []
    prefill = lm.Model.prefill

    def counted_prefill(self, *args, **kwargs):
        for counter in COUNTERS.values():
            counter.launches = 0
        out = prefill(self, *args, **kwargs)
        prefill_launches.append(COUNTERS["flash_attention"].launches)
        return out

    t0 = time.perf_counter()
    lm.Model.prefill = counted_prefill
    try:
        with recorded(fa, "flash_attention") as calls:
            run = serve("smollm-135m", smoke=False, device=dev, **SERVE)
    finally:
        lm.Model.prefill = prefill
    serve_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg = run.model.cfg

    # (a) every prefill launched B4 once per layer
    if prefill_launches != [cfg.n_layers] * (SERVE["n_batches"] + 1):
        raise AssertionError(f"B4 launches per prefill {prefill_launches}, "
                             f"expected {cfg.n_layers} for each")
    # (b) every B4 call of the path against the plain twin on its inputs
    worst, plain_ms = hold_flash_calls("serve prefill", calls)
    print(f"[6] {len(calls)} B4 calls of the serve path == plain twin, max_abs_err {worst:.3g}")
    # (c) the naive-attention prefill on the same weights and tokens
    cache_len = SERVE["prompt_len"] + SERVE["gen_len"]
    batch = {"tokens": run.prompts[0]}
    b4_logits, _ = run.model.prefill(run.params, batch, cache_len=cache_len)
    naive = dataclasses.replace(run.model, attn_impl="naive")
    naive_logits, _ = naive.prefill(run.params, batch, cache_len=cache_len)
    logit_err = float((b4_logits - naive_logits).abs().max())
    if not logit_err <= 1e-3:
        raise AssertionError(f"naive and B4 prefill logits differ by {logit_err}")
    # (d) the routes and the outputs
    pi = run.router.pi[0]
    if not np.isfinite(run.router.latency_bound):
        raise AssertionError(f"plan latency bound {run.router.latency_bound}")
    if any(pi[j] <= 0 for r in run.replicas for j in r):
        raise AssertionError(f"routed outside pi's support: {run.replicas}, pi {pi}")
    for toks in run.tokens:
        if toks.shape != (SERVE["batch"], SERVE["gen_len"] + 1) or not (
                (toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"generated tokens {tuple(toks.shape)} out of range")
    if not bool(torch.isfinite(b4_logits).all()):
        raise AssertionError("prefill logits are not finite")
    print(f"[6] naive vs B4 prefill last-position logits: max_abs_err {logit_err:.3g}; "
          f"routes {run.replicas} inside pi's support {np.round(pi, 3)}, "
          f"bound {run.router.latency_bound:.3f} s")

    lat = np.asarray(run.latencies)
    tokens = SERVE["batch"] * SERVE["prompt_len"]
    print(f"[6] serve wall {serve_s:.3f} s (plan included); prefill "
          f"{tokens / np.mean(run.prefill_s):.6g} tokens/s "
          f"({np.mean(run.prefill_s) * 1e3:.3f} ms per {tokens}-token batch); decode "
          f"{np.mean(run.decode_s) / SERVE['gen_len'] * 1e3:.3f} ms/token at batch "
          f"{SERVE['batch']}; batch latency mean {lat.mean() * 1e3:.3f} ms, "
          f"p95 {np.quantile(lat, 0.95) * 1e3:.3f} ms; peak {peak_gib:.2f} GiB")

    args, kwargs, got = calls[-1]
    record = time_flash("6", args, kwargs, got, dict(max_abs_err=worst, plain_ms=plain_ms),
                        limits)
    del calls
    return sum(prefill_launches), record


def time_flash(tag: str, args, kwargs, got, record: dict, limits: dict) -> dict:
    """B4 on a main path's own inputs (one call's), beside its plain twin's
    time (in ``record``), ``scaled_dot_product_attention`` and its bound."""
    q, k, v = args
    window = kwargs.get("window")
    record.update(flash_bound(q, k, v, window=window))
    fa.flash_attention(q, k, v, **kwargs)  # warm
    record["ms"], _ = cuda_ms(lambda: fa.flash_attention(q, k, v, **kwargs), reps=5)
    g = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(g, dim=2),
                                                v.repeat_interleave(g, dim=2)))
    if window is None:
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=kwargs["scale"])
    else:  # a boolean mask of the causal window: row i sees keys (i - window, i]
        iq = torch.arange(q.shape[1], device=q.device)[:, None]
        ik = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = (ik <= iq) & (ik > iq - window)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=kwargs["scale"])
    sdpa()  # warm
    record["library_ms"], lib_out = cuda_ms(sdpa, reps=5)
    lib_err = float((lib_out.transpose(1, 2) - got).abs().max())
    del qt, kt, vt, lib_out
    print(f"[{tag}] B4 {tuple(q.shape)} x {tuple(k.shape)} x {tuple(v.shape)}"
          + ("" if window is None else f" window {window}") + " on the path's inputs: kernel "
          f"{record['ms']:.4f} ms, plain twin {record['plain_ms']:.3f} ms, "
          f"scaled_dot_product_attention {record['library_ms']:.4f} ms "
          f"(|diff| {lib_err:.3g}), bound {record['bound_ms']:.4f} ms "
          f"({TF32_PASSES} TF32 passes of {record['bound_flop']:.4g} FLOP over "
          f"{record['bound_pairs']:.4g} visible pairs, {record['bound_by']}; "
          f"{100 * record['bound_ms'] / record['ms']:.1f} % of it); one TF32 pass "
          f"{record['bound_tf32_ms']:.4f} ms, float32 off the tensor cores "
          f"{record['bound_fp32_ms']:.4f} ms, bytes {record['bound_bytes_ms']:.4f} ms "
          f"({record['bound_gb']:.4f} GB)")
    at_mma = TF32_PASSES * record["bound_flop"] / (limits["mma_tflops"] * 1e12) * 1e3
    print(f"[{tag}] B4's {TF32_PASSES} TF32 passes at the {limits['mma_tflops']:.1f} TFLOP/s "
          f"mma.sync reached in phase 1: {at_mma:.4f} ms "
          f"({100 * at_mma / record['ms']:.1f} % of B4's time)")
    return record


# ---------------------------------------------------------------------------
# Phase 7: the planner's whole problem (hierarchical, tenant, geo).
# ---------------------------------------------------------------------------


def best_wall(fn, reps: int = 2):
    """Least host seconds over ``reps`` calls of ``fn`` (each ended by a
    synchronize), and the last call's result."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def on_card(x, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def hier_volumes(dev, cl, failed: list) -> None:
    """jlcm_scaling's ``_assert_volume_bitwise`` on the card: a V = 1 volume
    problem IS the file problem (bitwise solve), 4-file volumes gather
    exactly and cost 4x at the file level."""
    cat = synthetic_catalog(64, k_classes=(4,), file_mb=(100.0,), rate_sigma=0.0)
    mom = cl.moments(float(cat.chunk_mb[0]))
    file_prob = JLCMProblem(lam=on_card(cat.lam, dev), k=on_card(cat.k, dev, torch.int32),
                            moments=mom, cost=cl.cost, theta=PLAN_THETA)
    vol = solve(build_problem(volume_catalog(cat, volume_mb=100.0), mom, cl.cost, PLAN_THETA),
                **HIER_SOLVE_KW)
    ref = solve(file_prob, **HIER_SOLVE_KW)
    bitwise = torch.equal(vol.pi, ref.pi) and torch.equal(vol.objective, ref.objective)
    h4 = volume_catalog(cat, volume_mb=400.0)
    plan, sol4 = solve_hierarchical(h4, mom, cl.cost, PLAN_THETA, **HIER_SOLVE_KW)
    files = materialize(plan)
    gather = torch.equal(files, plan.cluster_pi[on_card(h4.cluster_of_file(), dev, torch.int64)])
    ev = evaluate_pi(file_prob, files)
    rel_lat = abs(float(ev.latency) - float(sol4.latency)) / max(1.0, abs(float(sol4.latency)))
    rel_cost = abs(float(ev.cost) - 4 * float(sol4.cost)) / max(1.0, 4 * float(sol4.cost))
    print(f"[7a] volumes: V = 1 solve == file solve bitwise {bitwise}; 4-file volumes: "
          f"gather exact {gather}, latency rel err {rel_lat:.3g}, file cost / volume cost "
          f"{float(ev.cost) / float(sol4.cost):.6f}")
    if not (bitwise and gather and rel_lat < 1e-3 and rel_cost < 1e-5):
        failed.append("7a volume properties")


def phase_hierarchical(dev) -> tuple[int, list, dict]:
    """7a: jlcm_scaling.py's jlcm_hierarchical section at 10^6 files, its
    checks held on the card, the incremental re-solve, and the 10^6-file
    plan simulated by a 64-seed fleet through B1. Returns B1's launches,
    the fleet's recorded scans and B1's time on them."""
    t_phase = time.perf_counter()
    failed: list[str] = []
    cl = tahoe_testbed(device=dev)
    hier_volumes(dev, cl, failed)

    def plan_catalog(cat):  # the timed region: aggregation + cluster solve
        h = cluster_catalog(cat)
        mom = cl.moments(effective_chunk_mb(h))
        return (h, mom) + solve_hierarchical(h, mom, cl.cost, PLAN_THETA, **HIER_SOLVE_KW)

    cat1k = synthetic_catalog(HIER_DENSE_FILES)
    dense = JLCMProblem(lam=on_card(cat1k.lam, dev), k=on_card(cat1k.k, dev),
                        moments=cl.moments(float(np.average(cat1k.chunk_mb, weights=cat1k.lam))),
                        cost=cl.cost, theta=PLAN_THETA)
    wall_dense, sol_dense = best_wall(lambda: solve(dense, **HIER_SOLVE_KW))
    _, _, plan1k, _ = plan_catalog(cat1k)
    obj_hier = float(evaluate_pi(dense, materialize(plan1k)).objective)
    obj_dense = float(sol_dense.objective)
    gap_pct = 100 * (obj_hier - obj_dense) / abs(obj_dense)
    fw_gap = duality_gap(dense, materialize(plan1k))
    print(f"[7a] r = {HIER_DENSE_FILES}: dense objective {obj_dense:.2f} "
          f"({int(sol_dense.iterations)} iterations), clustered plan on the dense problem "
          f"{obj_hier:.2f} ({gap_pct:+.3f} %), Frank-Wolfe gap {fw_gap:.1f}")
    if not abs(gap_pct) < 5.0:
        failed.append(f"7a clustered plan {gap_pct:.2f} % off the dense r = 1000 solve")

    cat = synthetic_catalog(HIER_FILES)
    wall_big, (h, mom, plan, sol) = best_wall(lambda: plan_catalog(cat))
    eff = effective_chunk_mb(h)
    print(f"[7a] walls: the {HIER_FILES}-file plan (aggregation + {h.n_clusters}-row solve, "
          f"{int(sol.iterations)} iterations) {1e3 * wall_big:.2f} ms; the dense r = "
          f"{HIER_DENSE_FILES} solve {1e3 * wall_dense:.2f} ms (best of 2 each)")
    files = materialize(plan)
    cid = on_card(h.cluster_of_file(), dev, torch.int64)
    if files.shape != (HIER_FILES, NODES) or not torch.equal(files, plan.cluster_pi[cid]):
        failed.append(f"7a materialize: {tuple(files.shape)} or not an exact gather")
    full = JLCMProblem(lam=on_card(cat.lam, dev), k=on_card(cat.k, dev), moments=mom,
                       cost=cl.cost, theta=PLAN_THETA)
    ev = evaluate_pi(full, files)
    tight = float(sol.latency_tight)
    rel = abs(float(ev.latency_tight) - tight) / tight
    print(f"[7a] evaluate_pi on the {HIER_FILES}-file problem: latency_tight "
          f"{float(ev.latency_tight):.6f} vs the cluster solve's {tight:.6f} (rel {rel:.3g}); "
          f"objective {float(ev.objective):.1f} vs {float(sol.objective):.1f}")
    if not rel <= 1e-4:
        failed.append(f"7a file-level latency_tight off the cluster one by {rel:.3g}")

    rng = np.random.default_rng(0)
    hot = rng.choice(h.n_clusters, max(1, round(HIER_MOVED * h.n_clusters)), replace=False)
    new_lam = plan.cluster_lam.copy()
    new_lam[hot] *= HIER_SURGE
    inc_s, (inc, info) = best_wall(lambda: resolve_incremental(
        plan, new_lam, mom, cl.cost, PLAN_THETA, **HIER_SOLVE_KW), reps=1)
    prob_new = build_problem(h._replace(lam=new_lam), mom, cl.cost, PLAN_THETA)
    cold = float(solve(prob_new, **HIER_SOLVE_KW).objective)
    rel_inc = (float(evaluate_pi(prob_new, inc.cluster_pi).objective) - cold) / abs(cold)
    print(f"[7a] resolve_incremental after {hot.size} of {h.n_clusters} clusters x{HIER_SURGE}: "
          f"{info}, {1e3 * inc_s:.2f} ms; objective {100 * rel_inc:+.4f} % against a cold re-solve")
    if info.n_resolved != hot.size or info.padded_rows != 1 << (hot.size - 1).bit_length():
        failed.append(f"7a incremental: {info} for {hot.size} moved clusters")
    if not rel_inc < 0.05:
        failed.append(f"7a incremental plan {100 * rel_inc:.2f} % above a cold re-solve")

    gen = torch.Generator(device=dev).manual_seed(0)
    lam_cs = on_card(cat.lam, dev)[None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(simulator, "fcfs_scan") as calls:
        fleet, launches = counted("7a simulate_fleet", lambda: simulate_fleet(
            gen, files, lam_cs, GeoFabric.single_site(cl), eff, **PLAN_FLEET))
        mean = float(fleet.mean_latency())
    fleet_s = time.perf_counter() - t0
    share = torch.bincount(cid[fleet.file_id.reshape(-1)], minlength=h.n_clusters)
    share_err = float(np.abs(share.cpu().numpy() / fleet.file_id.numel() - h.lam / h.lam.sum()).max())
    rho = float((node_arrival_rates(sol.pi, on_card(h.lam, dev)) / mom.mu).max())
    tenth = fleet.latency.shape[1] // 10
    first, last = (float(x.mean()) for x in (fleet.latency[:, :tenth], fleet.latency[:, -tenth:]))
    print(f"[7a] fleet of the {HIER_FILES}-file plan, {PLAN_FLEET['n_seeds']} seeds x "
          f"{PLAN_FLEET['n_requests']} requests: mean {mean:.3f} s, bound {tight:.3f} s "
          f"({mean / tight:.4f} of it), first / last tenth {first:.1f} / {last:.1f} s, the "
          f"plan's busiest node at utilisation {rho:.4f}; wall {fleet_s:.3f} s, fcfs launches "
          f"{launches}; requests per cluster vs cluster rates max |diff| {share_err:.2e}")
    if not bool(torch.isfinite(fleet.latency).all()):
        failed.append("7a fleet latencies are not all finite")
    # the P-K bound holds for stable queues only: at SOLVE_KW the reference's
    # own plan overloads a node too (ROADMAP.md §C), and is not gated there
    if rho < 1.0 and not mean <= 1.05 * tight:
        failed.append(f"7a fleet mean {mean} against bound {tight} x 1.05")
    if not share_err <= 0.01:
        failed.append(f"7a marks' cluster shares off the rates by {share_err}")
    inputs = scan_inputs(*calls[-1][:2])
    service = inputs[2]
    kernel_ms, _ = cuda_ms(lambda: fcfs_scan_cuda(*inputs), reps=5)
    record = dict(ms=kernel_ms, **bound(*service.shape))
    print(f"[7a] B1 at {tuple(service.shape)}: kernel {kernel_ms:.4f} ms, bound "
          f"{record['bound_ms']:.4f} ms ({record['bound_gb']:.3f} GB); phase wall "
          f"{time.perf_counter() - t_phase:.3f} s (its scan is held with 7c's)")
    if failed:
        raise AssertionError("phase 7a failed: " + "; ".join(failed))
    return launches, calls, record


def phase_tenant(dev) -> tuple[int, float]:
    """7b: tenant_tradeoff.py at full size: the 5 weights x 3 deadlines as
    one solve_batch, each plan simulated through B1, every assert of the
    benchmark, and the empirical objective on the card against the host's."""
    t_phase = time.perf_counter()
    failed: list[str] = []
    cl = tahoe_testbed(device=dev)
    lam, k = on_card(TENANT_LAM, dev), on_card(PLAN_K, dev)
    grid = [(w, d) for d in TENANT_DEADLINES for w in TENANT_WEIGHTS]
    specs = [make_objective(TENANT_CLASS, weight=(w, 1.0), deadline=(d, None),
                            tail_weight=(TENANT_TAIL_WEIGHT if np.isfinite(d) else 0.0, 0.0),
                            device=dev) for w, d in grid]
    problems = [JLCMProblem(lam=lam, k=k, moments=cl.moments(PLAN_CHUNK_MB), cost=cl.cost,
                            theta=PLAN_THETA, objective=spec) for spec in specs]
    wall, sols = best_wall(lambda: solve_batch(problems, max_iters=TENANT_MAX_ITERS), reps=1)
    iters = sols.iterations.tolist()
    print(f"[7b] solve_batch of {len(grid)} tenant problems: iterations {iters}, wall "
          f"{wall:.3f} s ({wall / max(iters) * 1e3:.2f} ms an iteration)")
    scans, stats, premium, launches = [], {}, {}, 0
    for i, (w, d) in enumerate(grid):
        gen = torch.Generator(device=dev).manual_seed(0)  # every point on one stream
        with recorded(simulator, "fcfs_scan") as calls:
            res, n = counted("7b simulate", lambda: simulate(
                gen, sols.pi[i], lam, cl, PLAN_CHUNK_MB, TENANT_REQUESTS))
        launches += n
        scans.extend(calls)
        st = res.per_class_stats(np.asarray(TENANT_CLASS), 2)
        stats[(w, d)] = st
        req_class = torch.tensor(TENANT_CLASS, device=dev)[res.file_id]
        premium[(w, d)] = res.latency[req_class == 0].cpu().numpy()
        on_dev = float(empirical_objective_device(res.latency, res.file_id, specs[i]))
        host = empirical_objective(res.latency, res.file_id, specs[i])
        if not abs(on_dev - host) <= 1e-5 * abs(host):
            failed.append(f"7b w={w} d={d}: empirical objective {on_dev} on the card, {host} host")
        print(f"[7b] w={w} d={d}: bound premium {float(sols.class_latency[i, 0]):.2f} "
              f"background {float(sols.class_latency[i, 1]):.2f} tail "
              f"{min(float(sols.class_tail[i, 0]), 1.0):.4f}; simulated premium mean "
              f"{st.mean[0]:.2f} p95 {st.p95[0]:.2f} p99 {st.p99[0]:.2f}, background mean "
              f"{st.mean[1]:.2f} p99 {st.p99[1]:.2f}; cost {float(sols.cost[i]):.1f}; "
              f"empirical objective {on_dev:.5f} (host {host:.5f})")
    i_base, i_top = grid.index((TENANT_WEIGHTS[0], TENANT_DEADLINES[0])), grid.index(
        (TENANT_WEIGHTS[-1], TENANT_DEADLINES[0]))
    base, top = stats[grid[i_base]], stats[grid[i_top]]
    if not float(sols.class_latency[i_top, 0]) < float(sols.class_latency[i_base, 0]):
        failed.append("7b: weighting did not tighten the premium bound")
    if not (top.mean[0] < base.mean[0] and top.p99[0] < base.p99[0]):
        failed.append(f"7b: premium mean/p99 {top.mean[0]}/{top.p99[0]} not below uniform "
                      f"{base.mean[0]}/{base.p99[0]}")
    d_t = TENANT_DEADLINES[-1]
    exc_tail = float((premium[(TENANT_WEIGHTS[0], d_t)] > d_t).mean())
    exc_mean = float((premium[(TENANT_WEIGHTS[0], TENANT_DEADLINES[0])] > d_t).mean())
    bound_t = float(sols.class_tail[grid.index((TENANT_WEIGHTS[0], d_t)), 0])
    print(f"[7b] d = {d_t}: premium tail bound {bound_t:.4f}, simulated P[T > d] {exc_tail:.4f} "
          f"with the tail term, {exc_mean:.4f} mean-only")
    if not (bound_t >= exc_tail and exc_tail < exc_mean):
        failed.append(f"7b tail: bound {bound_t}, exceedance {exc_tail} vs mean-only {exc_mean}")
    worst = hold_stacked(scans, "7b", "tenant", dev)
    print(f"[7b] fcfs launches {launches}, phase wall {time.perf_counter() - t_phase:.3f} s")
    if failed:
        raise AssertionError("phase 7b failed: " + "; ".join(failed))
    return launches, worst


def phase_geo(dev) -> tuple[int, list, torch.Tensor, float]:
    """7c: the geo fabric. The C == 1 collapse solves bitwise as the plain
    problem; placement follows the client mix; fleet_scale.py's files
    planned as a geo problem and simulated across the four client sites.
    Returns B1's launches, the fleet's recorded scans, the plan and the
    fleet's mean."""
    t_phase = time.perf_counter()
    failed: list[str] = []
    cl = tahoe_testbed(device=dev)
    fabric = geo_testbed(cl)
    lam, k = np.asarray(GEO_LAM, np.float32), np.asarray(PLAN_K, np.float32)
    mom = cl.moments(PLAN_CHUNK_MB)
    plain = JLCMProblem(lam=on_card(lam, dev), k=on_card(k, dev), moments=mom, cost=cl.cost,
                        theta=PLAN_THETA)
    collapsed = geo_problem(lam, k, ServiceMoments(*(x[None] for x in mom)), np.ones((4, 1)),
                            cl.cost, PLAN_THETA)
    a, b = solve(plain, max_iters=150), solve(collapsed, max_iters=150)
    same = collapsed.geo is None and all(
        torch.equal(getattr(a, f), getattr(b, f)) for f in ("pi", "objective", "latency_tight"))
    print(f"[7c] a one-site geo problem collapses to the plain one and solves bitwise: {same}")
    if not same:
        failed.append("7c: the C == 1 geo problem does not solve bitwise as the plain one")
    # the two anchored mixes and fleet_scale.py's client shares, one batch
    site_mom = fabric.moments(PLAN_CHUNK_MB)
    mix = np.asarray(GEO_MIX)
    mixes = [np.tile(m, (4, 1)) for m in (*GEO_ANCHORED.values(), mix)]
    sols = solve_batch([geo_problem(lam, k, site_mom, m, cl.cost, PLAN_THETA)
                        for m in mixes], max_iters=300)
    mass = [float(sols.pi[i][:, 4:8].sum()) for i in range(len(GEO_ANCHORED))]
    print(f"[7c] mass on the TX nodes under the NJ- and TX-anchored mixes: {mass} "
          f"(iterations {sols.iterations.tolist()})")
    if not mass[1] > mass[0] + 0.5:
        failed.append(f"7c: placement does not follow the client mix {mass}")
    sol = row(sols, len(GEO_ANCHORED))
    lam_cs = on_card(mix[:, None] * lam[None, :], dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with recorded(simulator, "fcfs_scan") as calls:
        fleet, launches = counted("7c simulate_fleet", lambda: simulate_fleet(
            gen, sol.pi, lam_cs, fabric, PLAN_CHUNK_MB, **PLAN_FLEET))
    per_site = fleet.per_site_mean(fabric.n_sites).tolist()
    mean, bound = float(fleet.mean_latency()), float(sol.latency_tight)
    print(f"[7c] geo plan n_i {sol.n.tolist()}, bound {bound:.3f} s; fleet "
          f"{PLAN_FLEET['n_seeds']} x {PLAN_FLEET['n_requests']}: mean {mean:.3f} s "
          f"({mean / bound:.4f} of the bound), per site {dict(zip(fabric.site_names, np.round(per_site, 3)))}")
    if not per_site[fabric.site_index("EU")] > per_site[0]:
        failed.append(f"7c: EU {per_site} not above the reference site")
    if not mean <= 1.05 * bound:
        failed.append(f"7c: fleet mean {mean} above the geo bound {bound} x 1.05")
    print(f"[7c] fcfs launches {launches}, phase wall {time.perf_counter() - t_phase:.3f} s "
          f"(its scan is held with 7a's)")
    if failed:
        raise AssertionError("phase 7c failed: " + "; ".join(failed))
    return launches, calls, sol.pi, mean


# ---------------------------------------------------------------------------
# Phase 8: the closed loop's simulator (cache tier, segments with failures
# and repair rows, candidate rollouts, geo segments, the streaming fleet).
# ---------------------------------------------------------------------------


def numpy_ttl_walk(expiry, t, fid, ttl):
    """The TTL-with-reset cache walked one request at a time on the host, in
    float32, as the reference's scan walks it: ``(new expiry, hits)``."""
    expiry = expiry.copy()
    hits = np.zeros(t.shape[0], bool)
    for i, (ti, f) in enumerate(zip(t, fid)):
        hits[i] = ti < expiry[f] and ttl[f] > 0
        expiry[f] = ti + ttl[f]
    return expiry, hits


def catalog_inputs(dev):
    """Phase 4's §V.B catalog: lam and k on the card, host copies, chunk
    sizes and the rate-weighted chunk size its fleets use."""
    lam, ks, chunk = paper_catalog(1000, device=dev)
    lam_np, ks_np = lam.cpu().numpy(), ks.cpu().numpy()
    return lam, ks, lam_np, ks_np, chunk, float(np.average(chunk, weights=lam_np))


def phase_cache_model(dev, sol, failed: list) -> tuple:
    """8a: the Che model over the catalog (a tenth of its bytes cached), a
    cache-aware re-solve through make_cache_spec, and cache_tier.py's
    frontier as one solve_batch. Returns the model, its TTLs and the plan."""
    cl = tahoe_testbed(device=dev)
    lam, ks, lam_np, ks_np, chunk, eff = catalog_inputs(dev)
    lam64 = lam_np.astype(np.float64)
    file_bytes = ks_np.astype(np.float64) * chunk * CACHE_MB  # k_i x the chunk size
    model = CacheModel(file_bytes=file_bytes, capacity_bytes=CACHE_SHARE * file_bytes.sum(),
                       hit_latency=CACHE_HIT_LATENCY, hot_price_per_mb=CACHE_HOT_PRICE)
    ttl = model.ttl(lam64)
    hit = model.hit_rates(lam64)
    print(f"[8a] Che model over {len(lam_np)} files, capacity {model.capacity_bytes / 1e9:.3f} GB "
          f"(a tenth of {file_bytes.sum() / 1e9:.3f} GB): TTLs {np.unique(ttl).tolist()} s, hit "
          f"fractions {hit.min():.5f}..{hit.max():.5f} (rate-weighted "
          f"{np.average(hit, weights=lam64):.5f}), expected hot bytes / capacity "
          f"{model.expected_hot_bytes(lam64) / model.capacity_bytes:.6f}, hot cost "
          f"{model.hot_cost():.2f}")
    prob = JLCMProblem(lam=lam, k=ks, moments=cl.moments(eff), cost=cl.cost, theta=2.0,
                       cache=model.spec(lam64, device=dev))
    wall, aware = best_wall(lambda: solve(prob, **CACHE_SOLVE_KW), reps=1)
    print(f"[8a] cache-aware re-solve: {int(aware.iterations)} iterations in {wall:.3f} s, "
          f"latency_tight {float(aware.latency_tight):.4f} s (cache-free plan "
          f"{float(sol.latency_tight):.4f} s), cost {float(aware.cost):.2f} (hot "
          f"{model.hot_cost():.2f}; cache-free {float(sol.cost):.2f}), mean n_i "
          f"{float(aware.n.float().mean()):.3f}")
    thinned = float(evaluate_pi(prob, sol.pi).latency_tight)
    print(f"[8a] phase 4's plan under the hot tier: bound {thinned:.4f} s, against "
          f"{float(sol.latency_tight):.4f} s without it")
    if not thinned < float(sol.latency_tight):
        failed.append("8a: the hot tier does not lower phase 4's plan's bound")

    # benchmarks/cache_tier.py's frontier: one batched cache-aware solve
    flam, fk = np.asarray(FRONTIER_LAM, np.float64), np.asarray(FRONTIER_K)
    fbytes = fk * FRONTIER_CHUNK_MB * CACHE_MB
    models = [CacheModel(file_bytes=fbytes, capacity_bytes=cap * CACHE_MB,
                         hit_latency=CACHE_HIT_LATENCY, hot_price_per_mb=CACHE_HOT_PRICE)
              for cap in FRONTIER_CAPACITIES_MB]
    probs = [JLCMProblem(lam=on_card(flam, dev), k=on_card(fk, dev),
                         moments=cl.moments(FRONTIER_CHUNK_MB), cost=cl.cost,
                         theta=FRONTIER_THETA, cache=cm.spec(flam, device=dev)) for cm in models]
    wall, sols = best_wall(lambda: solve_batch(probs, max_iters=FRONTIER_MAX_ITERS), reps=1)
    cost_v = cl.cost.cpu().numpy()
    bounds = sols.latency_tight.tolist()
    warm = [float(((sols.pi[i].cpu().numpy() > 1e-3) * cost_v).sum()) for i in range(len(models))]
    for cap, cm, b, w in zip(FRONTIER_CAPACITIES_MB, models, bounds, warm):
        print(f"[8a] frontier {cap:6.1f} MB: hit {np.average(cm.hit_rates(flam), weights=flam):.4f}"
              f", bound {b:.3f} s, warm cost {w:.1f}, hot cost {cm.hot_cost():.2f}, total "
              f"{w + cm.hot_cost():.2f}")
    print(f"[8a] frontier solve_batch of {len(models)}: iterations {sols.iterations.tolist()}, "
          f"wall {wall:.3f} s")
    catalog_mb = float(fbytes.sum() / CACHE_MB)
    warms = [w for w, cap in zip(warm, FRONTIER_CAPACITIES_MB) if cap < catalog_mb]
    if not all(b2 <= b1 + 1e-6 for b1, b2 in zip(bounds, bounds[1:])):
        failed.append(f"8a frontier: the bound does not fall with capacity {bounds}")
    if not all(w2 <= w1 + 1e-6 for w1, w2 in zip(warms, warms[1:])):
        failed.append(f"8a frontier: the warm support widens with capacity {warms}")
    return model, ttl, aware


def phase_segments(dev, aware, ttl, failed: list) -> tuple:
    """8b: the failure schedule on the cache-aware plan (node 0 down in
    segments SEG_DOWN with its repair rows on, paced at the node-failure-
    repair scenario's share of the client rate; a hot-tier outage in
    SEG_OUTAGE), its host-loop twin, the zero-TTL / cache-free pair and the
    same schedule with the repair rows off."""
    cl = tahoe_testbed(device=dev)
    lam, ks, lam_np, ks_np, chunk, eff = catalog_inputs(dev)
    r, n_seg, n = len(lam_np), SEGMENTS, SEGMENT_REQUESTS
    down = slice(*SEG_DOWN)
    avail_seq = np.ones((n_seg, NODES), bool)
    avail_seq[down, 0] = False
    placement = aware.placement.cpu().numpy()
    lost = int(lost_chunk_inventory(placement, ~avail_seq[SEG_DOWN[0]]).sum())
    repair_rate = REPAIR_SHARE_OF_CLIENT * float(lam_np.sum())
    flow = build_repair_flow(placement, ks_np, avail_seq[SEG_DOWN[0]], repair_rate)
    pi_aug, lam_aug = augment_plan(aware.pi.cpu().numpy(), lam_np, flow)
    rate_scale = np.ones((n_seg, 2 * r), np.float32)
    rate_scale[:, r:] = 0.0
    rate_scale[down, r:] = 1.0
    ttl_seq = np.tile(np.concatenate([ttl, np.zeros(r)]), (n_seg, 1)).astype(np.float32)
    ttl_seq[SEG_OUTAGE] = 0.0
    lam_t = on_card(lam_aug, dev)

    def schedule_draws(scale):
        gen = torch.Generator(device=dev).manual_seed(8)
        scale = on_card(scale, dev)
        draws = [simulator._draw(gen, (lam_t * scale[s])[None], (n,), NODES, prio=True)
                 for s in range(n_seg)]
        return SimDraws(*(torch.stack(xs) for xs in zip(*draws)))

    draws = schedule_draws(rate_scale)
    kw = dict(avail_seq=avail_seq, rate_scale_seq=rate_scale, cache_hit_latency=CACHE_HIT_LATENCY,
              draws=draws)
    launches = {}
    with recorded(simulator, "fcfs_scan") as calls:
        wall, (res, launches["main"]) = best_wall(lambda: counted(
            "8b simulate_segments", lambda: simulate_segments(
                None, pi_aug, lam_aug, cl, eff, n, cache_ttl_seq=ttl_seq, **kw)), reps=1)
    hit, fid, lat = res.hit, res.file_id, res.latency
    k_req = torch.round(on_card(pi_aug, dev).sum(-1)).to(torch.int64)
    sets_ok, empty_ok, down_ok = True, True, True
    for s, (args, _, out) in enumerate(calls):
        masks = args[1]
        size = masks.sum(-1)
        sets_ok &= bool(torch.where(hit[s], size == 0, size == k_req[fid[s]]).all())
        empty_ok &= torch.equal(torch.isneginf(out[0]), hit[s])
        down_ok &= not bool(masks[:, ~torch.as_tensor(avail_seq[s], device=dev)].any())
    busy0 = res.node_busy[down, 0].tolist()
    count0 = res.obs.count[down, 0].tolist()
    hits_per_seg = hit.sum(-1).tolist()
    repair = fid >= r
    repair_reads = repair.sum(-1).tolist()
    repair_hits = int((hit & repair).sum())
    repair_share = (repair.sum(-1) / n).tolist()
    disk_share = (repair.sum(-1) / (~hit).sum(-1)).tolist()  # of the reads the queues serve
    span = torch.diff(res.t_end, prepend=res.t_end.new_zeros(1))
    util = (res.node_busy / span[:, None]).amax(-1).tolist()  # the busiest node a segment
    deg = res.degraded.float().mean(-1).tolist()
    print(f"[8b] simulate_segments, {n_seg} x {n} requests (node 0 down in segments "
          f"{SEG_DOWN[0]}..{SEG_DOWN[1] - 1}, {lost} chunks lost, repair rows at "
          f"{repair_rate:.6g} reads/s there against {float(lam_np.sum()):.6g} client reads/s, "
          f"the hot tier out in segment {SEG_OUTAGE}): wall {wall:.3f} s "
          f"({n_seg * n / wall:.4g} requests/s), fcfs launches {launches['main']}")
    print(f"[8b] hits a segment {hits_per_seg}, repair reads {repair_reads} (hits among them "
          f"{repair_hits}), repair share of the reads {np.round(repair_share, 5).tolist()}, "
          f"of the reads the queues serve {np.round(disk_share, 5).tolist()}, degraded share "
          f"{np.round(deg, 5).tolist()}, mean latency "
          f"{np.round(lat.mean(-1).tolist(), 3).tolist()} s, t_end "
          f"{np.round(res.t_end.tolist(), 1).tolist()}, busiest node's utilisation "
          f"{np.round(util, 4).tolist()}")
    print(f"[8b] node 0 while down: busy {busy0}, observations {count0}; non-hit reads serve "
          f"k_i nodes, none down: {sets_ok and down_ok}; B1 gave -inf exactly on the hits' "
          f"empty sets: {empty_ok}")
    if not (all(b == 0.0 for b in busy0) and all(c == 0 for c in count0)):
        failed.append(f"8b: node 0 served while down (busy {busy0}, count {count0})")
    if not (sets_ok and down_ok and empty_ok):
        failed.append("8b: a service set is not k_i available nodes, or a hit was served")
    if not bool((lat[hit] == CACHE_HIT_LATENCY).all()):
        failed.append("8b: a hit did not return at the hit latency")
    if hits_per_seg[SEG_OUTAGE] != 0 or repair_hits != 0:
        failed.append(f"8b: hits in the outage segment or on repair rows {hits_per_seg}")
    if not all(h > 0 for s, h in enumerate(hits_per_seg) if s != SEG_OUTAGE):
        failed.append(f"8b: a segment with the hot tier up had no hit {hits_per_seg}")
    if not bool((torch.diff(res.t_end) > 0).all()):
        failed.append("8b: t0 does not rise across the segments")
    if not all((d > 0) == (SEG_DOWN[0] <= s < SEG_DOWN[1]) for s, d in enumerate(deg)):
        failed.append(f"8b: degraded reads outside the failure {deg}")

    # the host loop of simulate_segment on the same draws, and the carry
    # after segment 4 for the candidate rollouts
    with recorded(simulator, "fcfs_scan") as loop_calls:
        def host_loop():
            carry, parts, kept = None, [], None
            for s in range(n_seg):
                part, carry = simulate_segment(
                    None, pi_aug, lam_aug, cl, eff, n, avail=avail_seq[s],
                    rate_scale=rate_scale[s], carry=carry, cache_ttl=ttl_seq[s],
                    cache_hit_latency=CACHE_HIT_LATENCY, draws=draws.at(s))
                parts.append(part)
                if s == CAND_AFTER:
                    kept = carry
            return simulator._stack(parts), kept
        (loop, carry), launches["host_loop"] = counted("8b simulate_segment loop", host_loop)
        same = all(torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(loop),
                                                     torch.utils._pytree.tree_leaves(res)))
        zero_ttl, launches["zero_ttl"] = counted("8b simulate_segments zero TTLs", lambda: (
            simulate_segments(None, pi_aug, lam_aug, cl, eff, n,
                              cache_ttl_seq=np.zeros_like(ttl_seq), **kw)))
        free, launches["cache_free"] = counted("8b simulate_segments cache-free", lambda: (
            simulate_segments(None, pi_aug, lam_aug, cl, eff, n, **kw)))
        no_repair_scale = np.where(np.arange(2 * r) < r, rate_scale, 0.0).astype(np.float32)
        no_repair, launches["no_repair"] = counted("8b simulate_segments, no repair", lambda: (
            simulate_segments(None, pi_aug, lam_aug, cl, eff, n, cache_ttl_seq=ttl_seq,
                              **{**kw, "rate_scale_seq": no_repair_scale,
                                 "draws": schedule_draws(no_repair_scale)})))
    bitwise_free = free.hit is None and int(zero_ttl.hit.sum()) == 0 and all(
        torch.equal(getattr(zero_ttl, f), getattr(free, f))
        for f in ("latency", "arrival", "node_busy", "degraded", "t_end")) and all(
        torch.equal(a, b) for a, b in zip(zero_ttl.obs, free.obs))
    print(f"[8b] the host loop of simulate_segment is bitwise simulate_segments: {same}; TTLs "
          f"all zero are bitwise the cache-free run: {bitwise_free} (cache-free mean "
          f"{float(free.latency.mean()):.3f} s against {float(lat.mean()):.3f} s cached)")
    # the node-failure-repair scenario's claim (library.py): reconstruction
    # traffic measurably raises client latency
    client = lambda x: [float(x.latency[s][x.file_id[s] < r].mean()) for s in range(*SEG_DOWN)]
    with_rep, without_rep = client(res), client(no_repair)
    print(f"[8b] client mean latency while node 0 is down, segments {SEG_DOWN[0]}.."
          f"{SEG_DOWN[1] - 1}: {np.round(with_rep, 3).tolist()} s with the repair rows, "
          f"{np.round(without_rep, 3).tolist()} s without them")
    if not sum(with_rep) > sum(without_rep):
        failed.append(f"8b: repair traffic does not raise client latency {with_rep} vs "
                      f"{without_rep}")
    if not same:
        failed.append("8b: the host loop differs from simulate_segments")
    if not bitwise_free:
        failed.append("8b: TTLs all zero differ from the cache-free run")
    sched = dict(pi_aug=pi_aug, lam_aug=lam_aug, avail_seq=avail_seq, rate_scale=rate_scale,
                 ttl_seq=ttl_seq, eff=eff, carry=carry, draws=draws, static=res, flow=flow)
    return launches, calls + loop_calls, sched


def phase_candidates(dev, sched, failed: list) -> tuple:
    """8c: CANDIDATES plans (1 - a) pi + a uniform-over-support(pi), each
    rolled out over CAND_DRAWS draws from the carry after segment CAND_AFTER
    as one B1 launch; with one draw each candidate's stream is
    run_segment_raw's bitwise."""
    cl = tahoe_testbed(device=dev)
    s_next, n = CAND_AFTER + 1, SEGMENT_REQUESTS
    pi = on_card(sched["pi_aug"], dev)
    k = torch.round(pi.sum(-1))
    uni = feasible_uniform(pi > 1e-6, k)
    alphas = torch.linspace(0.0, 1.0, CANDIDATES, device=dev)[:, None, None]
    stack = (1 - alphas) * pi + alphas * uni
    d, rates = cl.service_params(sched["eff"])
    lam_s = on_card(sched["lam_aug"] * sched["rate_scale"][s_next], dev)
    avail = on_card(sched["avail_seq"][s_next], dev, torch.bool)
    ttl = on_card(sched["ttl_seq"][s_next], dev)
    carry = sched["carry"]
    gen = torch.Generator(device=dev).manual_seed(83)
    launches = {}
    with recorded(simulator, "fcfs_scan") as calls:
        wall, (roll, launches["rollout"]) = best_wall(lambda: counted(
            "8c run_segment_batch", lambda: run_segment_batch(
                carry, gen, stack, lam_s, d, rates, avail, n, ttl, CACHE_HIT_LATENCY,
                n_draws=CAND_DRAWS)), reps=1)
    shape = tuple(calls[-1][0][1].shape)
    score = roll.latency.mean(dim=(1, 2))
    print(f"[8c] {CANDIDATES} candidates x {CAND_DRAWS} draws x {n} requests from the carry after "
          f"segment {CAND_AFTER}: B1 launched {launches['rollout']} time(s) at {shape}, wall "
          f"{wall:.3f} s; mean latency by alpha {np.round(score.tolist(), 3).tolist()}, best "
          f"alpha {float(alphas[int(torch.argmin(score))]):.4f}")
    if launches["rollout"] != 1 or shape != (CANDIDATES * CAND_DRAWS, n, NODES):
        failed.append(f"8c: the rollout took {launches['rollout']} launches at {shape}")
    draws = simulator._draw(gen, lam_s[None], (1, n), NODES, prio=True)
    with recorded(simulator, "fcfs_scan") as one_calls:
        one, launches["one_draw"] = counted("8c run_segment_batch, one draw", lambda: (
            run_segment_batch(carry, None, stack, lam_s, d, rates, avail, n, ttl,
                              CACHE_HIT_LATENCY, draws=draws)))
        differ, rel = set(), []
        for b in range(CANDIDATES):
            (_, raw), nb = counted("8c run_segment_raw", lambda: run_segment_raw(
                carry, None, stack[b], lam_s, d, rates, avail, n, ttl, CACHE_HIT_LATENCY,
                draws=draws.at(0)))
            launches["one_draw"] += nb
            differ |= {f for f in ("latency", "degraded", "node_busy", "hit", "arrival")
                       if not torch.equal(getattr(one, f)[b, 0], getattr(raw, f))}
            if not torch.equal(one.obs.count[b, 0], raw.obs.count):
                differ.add("count")
            rel.append(max(float(((x - y).abs() / y.abs().clamp_min(1e-30)).max())
                           for x, y in ((getattr(one.obs, f)[b, 0], getattr(raw.obs, f))
                                        for f in ("s1", "s2", "s3"))))
    # the power sums reduce over N, and a batched reduction on the card may
    # sum in another order: held at rtol 1e-5, as the tests hold the reference's
    print(f"[8c] with one draw every candidate's stream (latency, degraded, busy, hits) and "
          f"node counts equal run_segment_raw's bitwise: {not differ}; s1-s3 worst rel diff "
          f"by candidate {[f'{x:.3g}' for x in rel]} (limit 1e-5)")
    if differ or not max(rel) <= 1e-5:
        failed.append(f"8c: one-draw candidates differ from run_segment_raw in {differ}, "
                      f"s1-s3 by {rel}")
    return launches, calls + one_calls


def phase_geo_segments(dev, geo_pi, fleet_mean: float, failed: list) -> tuple:
    """8d: phase 7c's plan over SEGMENTS geo segments, the client mix
    rotating one site a segment; per-(site, node) counts against the served
    masks; fleet_scale.py's rider 3 against phase 7c's fleet mean."""
    fabric = geo_testbed(tahoe_testbed(device=dev))
    lam, mix = np.asarray(GEO_LAM, np.float32), np.asarray(GEO_MIX)
    lam_seq = np.stack([np.roll(mix, s)[:, None] * lam[None, :] for s in range(SEGMENTS)])
    gen = torch.Generator(device=dev).manual_seed(84)
    launches = {}
    with recorded(simulator, "fcfs_scan") as calls:
        wall, (res, launches["segments"]) = best_wall(lambda: counted(
            "8d simulate_geo_segments", lambda: simulate_geo_segments(
                gen, geo_pi, lam_seq, fabric, PLAN_CHUNK_MB, SEGMENT_REQUESTS)), reps=1)
    counts_ok = all(torch.equal(res.obs.count[s].sum(0), args[1].sum(0))
                    for s, (args, _, _) in enumerate(calls))
    site_share = res.obs.count.sum(-1).float()
    site_share = (site_share / site_share.sum(-1, keepdim=True)).argmax(-1).tolist()
    per_seg = [float(x) for x in res.latency.mean(-1)]
    print(f"[8d] simulate_geo_segments, {SEGMENTS} x {SEGMENT_REQUESTS} requests on phase 7c's "
          f"plan, the mix rotating one site a segment: wall {wall:.3f} s, fcfs launches "
          f"{launches['segments']}; busiest client site by segment "
          f"{[fabric.site_names[i] for i in site_share]}, mean latency "
          f"{np.round(per_seg, 3).tolist()} s; per-(site, node) counts sum to the served "
          f"masks: {counts_ok}")
    if not counts_ok:
        failed.append("8d: per-(site, node) counts do not sum to the served masks")
    lam_cs = mix[:, None] * lam[None, :]
    with recorded(simulator, "fcfs_scan") as one_calls:
        (one, _), launches["one"] = counted("8d simulate_geo_segment", lambda: (
            simulate_geo_segment(gen, geo_pi, lam_cs, fabric, PLAN_CHUNK_MB, SEGMENT_REQUESTS)))
    one_mean = float(one.latency[SEGMENT_REQUESTS // 10:].mean())
    print(f"[8d] fleet_scale.py rider 3: one simulate_geo_segment's mean {one_mean:.3f} s, "
          f"phase 7c's fleet mean {fleet_mean:.3f} s ({abs(fleet_mean - one_mean) / one_mean:.4f}"
          f" apart, limit 0.25)")
    if not abs(fleet_mean - one_mean) / one_mean < 0.25:
        failed.append(f"8d rider 3: fleet {fleet_mean} vs one segment {one_mean}")
    return launches, calls + one_calls


def phase_stream_fleet(dev, aware, ttl, limits: dict, failed: list) -> tuple:
    """8e: the chunked streaming fleet with the cache on the cache-aware
    plan; fleet_scale.py's rider 2 at n_chunks = 1; the cached mean below
    the uncached; the card's cache against a host walk; B1 timed on a
    chunk's inputs with carried state."""
    cl = tahoe_testbed(device=dev)
    fabric = GeoFabric.single_site(cl)
    lam, ks, lam_np, ks_np, chunk, eff = catalog_inputs(dev)
    s, w, n = STREAM_FLEET["n_seeds"], STREAM_FLEET["n_chunks"], STREAM_FLEET["n_requests"]
    r = len(lam_np)
    lam_cs = lam[None]
    ttl_t = on_card(ttl, dev)
    gen = torch.Generator(device=dev).manual_seed(85)
    launches = {}
    with recorded(simulator, "fcfs_scan") as chunk_calls:
        chunk_wall, (chunked, launches["chunked"]) = best_wall(lambda: counted(
            "8e simulate_fleet chunked", lambda: simulate_fleet(
                gen, aware.pi, lam_cs, fabric, eff, n, s, stream=True, n_chunks=w,
                cache_ttl=ttl_t, cache_hit_latency=CACHE_HIT_LATENCY)), reps=1)
    warm = int(w * n * 0.1)
    count = int(chunked.stream.count.sum())
    hits = int(chunked.hit_count.sum())
    p99, p99w = float(chunked.quantile(0.99)), float(chunked.p99_windowed())
    print(f"[8e] chunked streaming fleet, {s} seeds x {w} chunks x {n} requests "
          f"({s * w * n:.4g} reads, cache state {tuple(ttl_t.shape)} a seed): wall "
          f"{chunk_wall:.3f} s ({s * w * n / chunk_wall:.4g} requests/s), fcfs launches "
          f"{launches['chunked']}; post-warmup count {count}, hit_count {hits} "
          f"({hits / count:.5f}), mean {float(chunked.mean_latency()):.4f} s, quantile(0.99) "
          f"{p99:.4f} s, p99_windowed {p99w:.4f} s")
    if count != s * (w * n - warm) or hits <= 0 or not (np.isfinite(p99) and np.isfinite(p99w)):
        failed.append(f"8e chunked: count {count}, hits {hits}, p99 {p99}, windowed {p99w}")

    # fleet_scale.py's rider 2 at n_chunks = 1, and test_fleet_cache_path's
    # claim, on one set of draws
    draws = simulator._draw(gen, lam_cs, (s, n), NODES)
    with recorded(simulator, "fcfs_scan") as calls:
        mat_wall, (mat, launches["materialized"]) = best_wall(lambda: counted(
            "8e simulate_fleet", lambda: simulate_fleet(
                None, aware.pi, lam_cs, fabric, eff, n, s, draws=draws)), reps=1)
        str_wall, (st, launches["stream"]) = best_wall(lambda: counted(
            "8e simulate_fleet stream", lambda: simulate_fleet(
                None, aware.pi, lam_cs, fabric, eff, n, s, stream=True, draws=draws)), reps=1)
        cached, launches["cached"] = counted("8e simulate_fleet cached", lambda: simulate_fleet(
            None, aware.pi, lam_cs, fabric, eff, n, s, cache_ttl=ttl_t,
            cache_hit_latency=CACHE_HIT_LATENCY, draws=draws))
    lat = mat.latency.cpu().numpy()
    mat_mean, str_mean = float(lat.mean()), float(st.mean_latency())
    exact = float(np.quantile(lat, 0.99, method="inverted_cdf"))
    sketch_p99 = float(st.quantile(0.99))
    growth = st.sketch.growth
    cached_mean = float(cached.mean_latency())
    print(f"[8e] rider 2 at n_chunks = 1: count {int(st.stream.count.sum())} of {lat.size}, mean "
          f"{str_mean:.6f} vs {mat_mean:.6f} s, p99 sketch {sketch_p99:.4f} in [exact "
          f"{exact:.4f}, x growth {exact * growth:.4f}]; cached mean {cached_mean:.4f} s below "
          f"uncached {mat_mean:.4f} s; walls: materialized {mat_wall:.3f} s "
          f"({s * n / mat_wall:.4g} requests/s), streaming {str_wall:.3f} s "
          f"({s * n / str_wall:.4g} requests/s)")
    if int(st.stream.count.sum()) != lat.size:
        failed.append("8e rider 2: the streamed count differs from the materialized one")
    if not abs(str_mean - mat_mean) <= 1e-4 * abs(mat_mean) + 1e-7:
        failed.append(f"8e rider 2: streamed mean {str_mean} vs {mat_mean}")
    if not (exact <= sketch_p99 * (1 + 1e-6) and sketch_p99 <= exact * growth * (1 + 1e-6)):
        failed.append(f"8e rider 2: sketch p99 {sketch_p99} against exact {exact}")
    if not cached_mean < mat_mean:
        failed.append(f"8e: the cached mean {cached_mean} is not below {mat_mean}")

    # the cache on the card against the sequential walk, seed 0
    t0, f0 = draws.arrival[0], draws.file_id[0]
    ttl32 = ttl.astype(np.float32)
    walk_exp, walk_hits = numpy_ttl_walk(np.full(r, -np.inf, np.float32), t0.cpu().numpy(),
                                         f0.cpu().numpy(), ttl32)
    card_exp, card_hits = ttl_cache_scan(torch.full((r,), -torch.inf, device=dev), t0, f0, ttl_t)
    walk_ok = (np.array_equal(cached.hit[0].cpu().numpy(), walk_hits[n // 10:])
               and np.array_equal(card_hits.cpu().numpy(), walk_hits)
               and np.array_equal(card_exp.cpu().numpy(), walk_exp))
    cold = torch.full((s, r), -torch.inf, device=dev)
    sort_ms, _ = cuda_ms(lambda: ttl_cache_scan(cold, draws.arrival, draws.file_id, ttl_t), reps=5)
    print(f"[8e] seed 0's hits ({int(walk_hits.sum())} of {n}) and final expiry on the card equal "
          f"a host walk of the TTL cache: {walk_ok}; the sort-based cache on a chunk "
          f"({s}, {n}): {sort_ms:.4f} ms")
    if not walk_ok:
        failed.append("8e: the card's cache differs from the host walk")

    # B1 on a chunk's inputs with carried state
    inputs = scan_inputs(*chunk_calls[-1][:2])
    kernel_ms, _ = cuda_ms(lambda: fcfs_scan_cuda(*inputs), reps=5)
    record = dict(ms=kernel_ms, **bound(s, n, NODES))
    print(f"[8e] B1 at a chunk's ({s}, {n}, {NODES}) with carried dep and busy: kernel "
          f"{kernel_ms:.4f} ms, bound {record['bound_ms']:.4f} ms ({record['bound_gb']:.3f} GB, "
          f"{record['bound_by']}), its serial chain alone {limits['chain_ms']:.4f} ms (phase 1)")
    return launches, chunk_calls + calls, record


def phase_closed_loop(dev, sol, geo_pi, geo_mean: float, limits: dict) -> tuple:
    """Phase 8: 8a-8e, then every B1 call of the phase held bitwise against
    the plain twin, each with its own carried state, in one stacked walk.
    Returns B1's launches by path, the largest busy |difference|, B1's
    record on a stream chunk, and what phase 9 re-plans on: 8a's cache model,
    TTLs and plan, and 8b's schedule with its draws and static run."""
    t_phase = time.perf_counter()
    failed: list[str] = []
    model, ttl, aware = phase_cache_model(dev, sol, failed)
    seg_launches, seg_calls, sched = phase_segments(dev, aware, ttl, failed)
    cand_launches, cand_calls = phase_candidates(dev, sched, failed)
    geo_launches, geo_calls = phase_geo_segments(dev, geo_pi, geo_mean, failed)
    fleet_launches, fleet_calls, record = phase_stream_fleet(dev, aware, ttl, limits, failed)
    by_path = {"segments_simulate": sum(seg_launches.values()),
               "candidates_run_segment_batch": sum(cand_launches.values()),
               "geo_segments_simulate": sum(geo_launches.values()),
               "stream_fleet_simulate": sum(fleet_launches.values())}
    print(f"[8] fcfs launches {by_path} (8b {seg_launches}, 8c {cand_launches}, 8d "
          f"{geo_launches}, 8e {fleet_launches})")
    calls = seg_calls + cand_calls + geo_calls + fleet_calls
    del seg_calls, cand_calls, geo_calls, fleet_calls
    err = hold_stacked(calls, "8", "phase 8's scans, each with its carried state", dev)
    del calls
    torch.cuda.empty_cache()
    print(f"[8] phase 8 wall {time.perf_counter() - t_phase:.3f} s")
    if failed:
        raise AssertionError("phase 8 failed: " + "; ".join(failed))
    return by_path, err, record, dict(model=model, ttl=ttl, aware=aware, sched=sched)


# ---------------------------------------------------------------------------
# Phase 9: the closed loop's control plane (the serving router's sweep,
# failover and hedged simulation; batched rollout arbitration; the three
# replanners; the hot-path guards).
# ---------------------------------------------------------------------------


def hold_grouped(calls, phase: str, dev) -> float:
    """Every recorded scan held bitwise against the plain twin with its own
    carried state, stacked by (N, m) so each shape is one plain-twin walk."""
    groups: dict = {}
    for call in calls:
        groups.setdefault(tuple(call[0][2].shape[-2:]), []).append(call)
    return max(hold_stacked(group, phase, f"scans of (N, m) = {shape}", dev)
               for shape, group in sorted(groups.items()))


@contextlib.contextmanager
def diag_armed():
    """``REPRO_DIAG=1`` for the region (set in-process), restored after."""
    before = os.environ.get("REPRO_DIAG")
    os.environ["REPRO_DIAG"] = "1"
    try:
        yield diag.hot_path_registry()
    finally:
        if before is None:
            del os.environ["REPRO_DIAG"]
        else:
            os.environ["REPRO_DIAG"] = before


def phase_serving(dev, failed: list) -> tuple:
    """9a: benchmarks/serving_hedge.py at its sizes, each simulate_serving one
    B1 launch at (m, N, m); plan_sweep against single plans; the failover
    table against a fresh masked solve, and a stale table ignored."""
    mu = on_card(HEDGE_MU, dev)
    m = len(HEDGE_MU)
    pool = ReplicaPool(moments=exponential_moments(mu), cost=torch.ones(m, device=dev))
    sampler = lambda g, shape: torch.empty(shape + (m,), device=dev).exponential_(generator=g) / mu
    launches, calls, plans, p99 = 0, [], {}, {}
    for load, rate in HEDGE_RATES.items():
        # the plan does not depend on hedge (it only widens each request's
        # set), so one solve a rate serves the three hedge levels
        wall, plans[load] = best_wall(lambda: Router.plan(pool, [rate]), reps=1)
        print(f"[9a] Router.plan at rate {rate}: bound {plans[load].latency_bound:.4f} s, "
              f"wall {wall:.3f} s")
        for hedge in HEDGE_LEVELS:
            router = dataclasses.replace(plans[load], hedge=hedge)
            gen = torch.Generator(device=dev).manual_seed(HEDGE_SEED)
            with recorded(router_mod, "fcfs_scan") as c:
                sim_wall, ((lat, _), n) = best_wall(lambda: counted(
                    f"9a simulate_serving {load} hedge {hedge}", lambda: simulate_serving(
                        gen, router, [rate], sampler, HEDGE_REQUESTS)), reps=1)
            launches += n
            calls += c
            p99[load, hedge] = float(np.quantile(lat, 0.99))
            print(f"[9a] {load} load (rate {rate}), hedge {hedge}: mean {lat.mean():.4f} s, p99 "
                  f"{p99[load, hedge]:.4f} s ({lat.size} requests after warm-up); B1 "
                  f"{n} launch at {tuple(c[-1][0][1].shape)}, wall {sim_wall:.3f} s")
    if not p99["low", 1] < p99["low", 0]:
        failed.append(f"9a: hedging does not cut p99 at low load {p99}")
    rate = HEDGE_RATES["low"]
    wall, sweep = best_wall(lambda: Router.plan_sweep(pool, [rate], SWEEP_THETAS), reps=1)
    singles = [plans["low"]] + [Router.plan(pool, [rate], theta=t) for t in SWEEP_THETAS[1:]]
    rel = [abs(a.latency_bound - b.latency_bound) / abs(b.latency_bound)
           for a, b in zip(sweep, singles)]
    print(f"[9a] plan_sweep over thetas {SWEEP_THETAS} at rate {rate} (one solve_batch, "
          f"{wall:.3f} s): bounds {[round(x.latency_bound, 5) for x in sweep]}, single plans "
          f"{[round(x.latency_bound, 5) for x in singles]} (rel diff {max(rel):.3g}, limit 1e-3)")
    if not max(rel) <= 1e-3:
        failed.append(f"9a: plan_sweep differs from single plans by {rel}")
    base = plans["low"]
    table_wall, table = best_wall(lambda: base.precompute_failover([rate]), reps=1)
    lookup_wall, from_table = best_wall(lambda: table.drop_replica(0, [rate]), reps=1)
    fresh_wall, fresh = best_wall(lambda: base.drop_replica(0, [rate]), reps=1)
    pi_diff = float(np.abs(from_table.pi - fresh.pi).max())
    bound_rel = abs(from_table.latency_bound - fresh.latency_bound) / fresh.latency_bound
    stale = table.drop_replica(3, [HEDGE_RATES["med"]])
    stale_ok = bool((stale.pi[:, 3] <= 1e-6).all()) and not np.allclose(
        stale.pi, table.failover[3][0], atol=1e-6)
    print(f"[9a] failover: table of {len(table.failover)} masked plans in one solve_batch "
          f"{table_wall:.3f} s; drop_replica(0) from the table {1e3 * lookup_wall:.3f} ms vs a "
          f"fresh masked solve {fresh_wall:.3f} s: pi max |diff| {pi_diff:.3g} (limit 1e-5), "
          f"bound rel diff {bound_rel:.3g} (limit 1e-5), table dropped after use "
          f"{from_table.failover == {}}; a stale table (rate {HEDGE_RATES['med']}) is ignored: "
          f"{stale_ok}")
    if not (pi_diff <= 1e-5 and bound_rel <= 1e-5 and from_table.failover == {}
            and bool((from_table.pi[:, 0] <= 1e-6).all())):
        failed.append(f"9a: the failover table differs from a fresh solve ({pi_diff}, {bound_rel})")
    if not stale_ok:
        failed.append("9a: drop_replica served a stale failover table")
    return launches, calls


def phase_replan_wall(dev, failed: list) -> tuple:
    """9b: benchmarks/replan_wall.py's equalities at its sizes: the batched
    argmin equals the sequential loop's and every score agrees within fp32
    tolerance, at 8 / 16 / 32 candidates and 2 / 4 draws; the hoisted
    sweep's plans are bit-identical. Walls of both paths printed side by
    side, not gated."""
    cl = tahoe_testbed(device=dev)
    r, chunk = len(WALL_LAM), WALL_FILE_MB / WALL_K
    d, rates = cl.service_params(chunk)
    lam = on_card(WALL_LAM, dev)
    avail = torch.ones(NODES, dtype=torch.bool, device=dev)
    carry = init_carry(NODES, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def candidates(n_cand: int):  # replan_wall.py's fan of demand scales
        return solve_batch([JLCMProblem(
            lam=on_card(np.asarray(WALL_LAM) * s, dev), k=torch.full((r,), WALL_K, device=dev),
            moments=cl.moments(chunk), cost=cl.cost, theta=WALL_THETA)
            for s in np.linspace(0.8, 1.2, n_cand)], max_iters=WALL_MAX_ITERS)

    def sequential(pi, draws, cost_term):  # replan_wall.py's _sequential_best, per draw
        scores = np.zeros((draws.arrival.shape[0], cost_term.size))
        for j in range(scores.shape[0]):
            for i in range(cost_term.size):
                _, res = run_segment_raw(carry, None, pi[i], lam, d, rates, avail,
                                         WALL_REQUESTS, draws=draws.at(j))
                lat, fid = res.latency.cpu().numpy(), res.file_id.cpu().numpy()
                ok = fid < r  # repair rows masked
                scores[j, i] = empirical_objective(lat[ok], fid[ok], None) + float(cost_term[i])
        return scores.mean(0), int(np.argmin(scores.mean(0)))

    launches, calls = 0, []
    for n_cand, n_draws in [(c, 1) for c in WALL_CANDIDATES] + [(16, k) for k in WALL_DRAWS]:
        sols = candidates(n_cand)
        cost_term = WALL_THETA * sols.cost.cpu().numpy()
        cost_dev = WALL_THETA * sols.cost
        draws = segment_draws(gen, lam[None], WALL_REQUESTS, NODES, n_draws)
        batched = lambda: batched_rollout_scores(
            carry, None, sols.pi, lam, d, rates, avail, cost_dev, None, n_clients=r,
            n_requests=WALL_REQUESTS, rollout_seeds=n_draws, draws=draws)
        with recorded(simulator, "fcfs_scan") as c:
            (scores, best), nb = counted(f"9b batched_rollout_scores {n_cand}x{n_draws}", batched)
            (seq, seq_best), ns = counted(f"9b sequential loop {n_cand}x{n_draws}",
                                          lambda: sequential(sols.pi, draws, cost_term))
        launches += nb + ns
        calls += c
        scores = scores.cpu().numpy()
        close = np.allclose(scores[:n_cand], seq, rtol=1e-5, atol=1e-5)
        t_bat, _ = best_wall(lambda: int(batched()[1]), reps=3)
        t_seq, _ = best_wall(lambda: sequential(sols.pi, draws, cost_term)[1], reps=3)
        print(f"[9b] {n_cand} candidates x {n_draws} draw(s) x {WALL_REQUESTS} requests: batched "
              f"argmin {int(best)} (B1 {nb} launch at {tuple(c[0][0][1].shape)}), sequential "
              f"{seq_best} ({ns} launches); scores within rtol 1e-5: {close} (max rel "
              f"{float(np.max(np.abs(scores[:n_cand] - seq) / np.abs(seq))):.3g}); padded to "
              f"{scores.size}; walls: batched {1e3 * t_bat:.2f} ms, sequential "
              f"{1e3 * t_seq:.2f} ms ({t_seq / t_bat:.2f}x, best of 3)")
        if int(best) != seq_best or not close or nb != 1:
            failed.append(f"9b {n_cand}x{n_draws}: batched {int(best)} vs sequential {seq_best}, "
                          f"scores close {close}, {nb} launches")
    sweep_sols = candidates(WALL_SWEEP)
    legacy = lambda: [(sweep_sols.pi[i].cpu().numpy(), float(sweep_sols.latency_tight[i]))
                      for i in range(WALL_SWEEP)]

    def hoisted():
        pi_np, lat_np = sweep_sols.pi.cpu().numpy(), sweep_sols.latency_tight.cpu().numpy()
        return [(pi_np[i], float(lat_np[i])) for i in range(WALL_SWEEP)]

    t_hoist, out_h = best_wall(hoisted, reps=3)
    t_legacy, out_l = best_wall(legacy, reps=3)
    same = all(np.array_equal(a[0], b[0]) and a[1] == b[1] for a, b in zip(out_h, out_l))
    print(f"[9b] the hoisted sweep's {WALL_SWEEP} plans are bit-identical to per-index reads: "
          f"{same}; walls: hoisted {1e3 * t_hoist:.3f} ms, per index {1e3 * t_legacy:.3f} ms")
    if not same:
        failed.append("9b: the hoisted sweep differs from per-index reads")
    return launches, calls


def client_stats(res, r: int, s: int) -> tuple[float, float]:
    """Segment ``s``'s clients' (file id < r) mean and p99 latency."""
    lat = res.latency[s][res.file_id[s] < r]
    return float(lat.mean()), float(torch.quantile(lat, 0.99))


def phase_repair_replan(dev, loop: dict, failed: list) -> tuple:
    """9c (and 9f's replan): the repair-aware AdaptiveReplanner against 8b's
    static plan on 8b's schedule and draws: it re-plans where availability
    changes, with the repair flow, the cache model and rollouts from the live
    carry; the first replan runs under REPRO_DIAG=1. Gate: the clients' mean
    in the outage below the static plan's."""
    cl = tahoe_testbed(device=dev)
    lam, ks, lam_np, ks_np, chunk, eff = catalog_inputs(dev)
    model, ttl, aware, sched = loop["model"], loop["ttl"], loop["aware"], loop["sched"]
    r, n = len(lam_np), SEGMENT_REQUESTS
    lam64 = lam_np.astype(np.float64)
    flow, draws, static = sched["flow"], sched["draws"], sched["static"]
    est = EwmaMomentEstimator(prior=cl.moments(eff))
    rate_est = EwmaRateEstimator(prior=model.thin(lam64))
    rp = AdaptiveReplanner(k=ks_np, cost=cl.cost.cpu().numpy(), theta=2.0, estimator=est,
                           cache=model, max_iters=REPLAN_MAX_ITERS,
                           rollout_requests=REPLAN_ROLLOUT_REQUESTS,
                           rollout_seeds=REPLAN_ROLLOUT_DRAWS)
    rp.last_ttl, rp.last_raw = ttl, lam64.copy()
    gen = torch.Generator(device=dev).manual_seed(90)
    pi_client, repair_pi, ttl_cur, carry = aware.pi.cpu().numpy(), flow.pi, ttl, None
    launches, calls, parts, guarded = {"replan": 0, "segments": 0}, [], [], {}
    for s in range(SEGMENTS):
        avail = sched["avail_seq"][s]
        if s in SEG_DOWN:  # availability changes: re-plan before the segment
            active = s < SEG_DOWN[1]
            armed = diag_armed() if s == SEG_DOWN[0] else contextlib.nullcontext({})
            with recorded(simulator, "fcfs_scan") as c, armed as reg:
                before = {k: v.guarded_calls for k, v in reg.items()}
                pi_client, nl = counted(f"9c replan before segment {s}", lambda: rp.replan(
                    rate_est.rates, avail, pi0=pi_client, carry=carry, generator=gen,
                    repair=flow if active else None))
                guarded.update({k: v.guarded_calls - before.get(k, 0) for k, v in reg.items()
                                if v.guarded_calls > before.get(k, 0)})
            launches["replan"] += nl
            calls += c
            repair_pi = rp.repair_pi if active else flow.pi
            ttl_cur = rp.last_ttl
            print(f"[9c] replan before segment {s} ({'node 0 down, repair on' if active else 'node 0 back'}"
                  f"{', under REPRO_DIAG=1' if s == SEG_DOWN[0] else ''}): {len(rp.last_scores)} "
                  f"candidates, iterations {rp.solve_iters[-1]}, solve {rp.solve_walls[-1]:.3f} s, "
                  f"rollouts {rp.rollout_walls[-1]:.3f} s (B1 {nl} launch at "
                  f"{tuple(c[-1][0][1].shape)}), scores {np.round(rp.last_scores.tolist(), 3).tolist()}")
        pi_s = np.concatenate([pi_client, repair_pi])
        ttl_s = sched["ttl_seq"][s] if s == SEG_OUTAGE else np.concatenate([ttl_cur, np.zeros(r)])
        with recorded(simulator, "fcfs_scan") as c:
            (res, carry), nl = counted("9c simulate_segment", lambda: simulate_segment(
                None, pi_s, sched["lam_aug"], cl, eff, n, avail=avail,
                rate_scale=sched["rate_scale"][s], carry=carry, cache_ttl=ttl_s,
                cache_hit_latency=CACHE_HIT_LATENCY, draws=draws.at(s)))
        launches["segments"] += nl
        calls += c
        parts.append(res)
        est.update(res.obs)
        client = res.file_id < r
        rate_est.update_misses(res.file_id[client], res.hit[client],
                               float(res.arrival[-1] - res.arrival[0]))
    adaptive = simulator._stack(parts)
    span = torch.diff(static.t_end, prepend=static.t_end.new_zeros(1))
    util = {name: (x.node_busy / span[:, None]).amax(-1).tolist()
            for name, x in (("static", static), ("adaptive", adaptive))}
    share = ((static.file_id >= r).sum(-1) / n).tolist()
    for s in range(SEGMENTS):
        (sm, sp), (am, ap) = client_stats(static, r, s), client_stats(adaptive, r, s)
        print(f"[9c] segment {s}: repair share {share[s]:.5f}; busiest node's utilisation "
              f"static {util['static'][s]:.4f}, adaptive {util['adaptive'][s]:.4f}; clients' "
              f"mean / p99 static {sm:.6g} / {sp:.6g} s, adaptive {am:.6g} / {ap:.6g} s")
    down = slice(*SEG_DOWN)
    out = {name: float(x.latency[down][x.file_id[down] < r].mean())
           for name, x in (("static", static), ("adaptive", adaptive))}
    print(f"[9c] clients' mean in segments {SEG_DOWN[0]}..{SEG_DOWN[1] - 1}: adaptive "
          f"{out['adaptive']:.6g} s, static {out['static']:.6g} s; replans {rp.replans}, solve "
          f"walls {np.round(rp.solve_walls, 3).tolist()} s, rollout walls "
          f"{np.round(rp.rollout_walls, 3).tolist()} s; guarded calls under REPRO_DIAG=1 {guarded}")
    if not out["adaptive"] < out["static"]:
        failed.append(f"9c: the repair-aware plan's clients' mean {out['adaptive']} is not below "
                      f"the static plan's {out['static']}")
    if not (guarded.get("core.solve_merged", 0) >= 1
            and guarded.get("serving.batched_rollout_scores", 0) == 1):
        failed.append(f"9f: the replan under REPRO_DIAG=1 ran no guarded region {guarded}")
    return launches, calls


def phase_hier_replan(dev, failed: list) -> None:
    """9d: HierarchicalReplanner at 10^6 files (phase 7a's catalog at
    jlcm_scaling.py's SOLVE_KW): the first replan full and materialized, a
    quiet segment an incremental no-op, a rate surge re-solving only the
    clusters that moved, a mask change forcing a full solve."""
    cl = tahoe_testbed(device=dev)
    cat = synthetic_catalog(HIER_FILES)
    h = cluster_catalog(cat)
    mom = cl.moments(effective_chunk_mb(h))
    rp = HierarchicalReplanner(hierarchy=h, cost=cl.cost.cpu().numpy(), theta=PLAN_THETA,
                               estimator=EwmaMomentEstimator(prior=mom),
                               max_iters=HIER_SOLVE_KW["max_iters"], eps=HIER_SOLVE_KW["eps"])
    avail = np.ones(NODES, bool)
    pi1 = rp.replan(cat.lam, avail)
    ok = [pi1.shape == (HIER_FILES, NODES), rp.full_solves == 1,
          rp.resolved_counts == [h.n_clusters], np.allclose(pi1.sum(-1), cat.k, rtol=1e-3)]
    pi2 = rp.replan(cat.lam, avail)
    ok += [rp.full_solves == 1, rp.resolved_counts[-1] == 0, np.array_equal(pi1, pi2)]
    cid = h.cluster_of_file()
    surge = cat.lam.copy()
    surge[cid == int(np.argmax(h.lam))] *= 3.0
    rp.replan(surge, avail)
    ok += [rp.full_solves == 1, 1 <= rp.resolved_counts[-1] < h.n_clusters]
    down = avail.copy()
    down[0] = False
    pi4 = rp.replan(surge, down)
    ok += [rp.full_solves == 2, bool(np.abs(pi4[:, 0]).max() <= 1e-6)]
    print(f"[9d] HierarchicalReplanner over {HIER_FILES} files in {h.n_clusters} clusters: "
          f"first (full), quiet, one cluster x3, node 0 down: resolved_counts "
          f"{rp.resolved_counts}, full solves {rp.full_solves}, iterations {rp.solve_iters}, walls "
          f"{np.round(rp.solve_walls, 3).tolist()} s (each with the materialized "
          f"({HIER_FILES}, {NODES}) plan's host copy); contracts hold: {all(ok)} {ok}")
    if not all(ok):
        failed.append(f"9d: hierarchical contracts {ok}, counts {rp.resolved_counts}")


def phase_geo_replan(dev, geo_pi, failed: list) -> tuple:
    """9e: GeoAdaptiveReplanner on geo_testbed() with fleet_scale.py's files:
    geo segments under a rotating client mix, re-planned from the EWMA (C, r)
    rate estimates with batched geo rollouts (one B1 launch); with one draw
    the chosen index equals the sequential loop's on the same draws."""
    fabric = geo_testbed(tahoe_testbed(device=dev))
    c, lam, mix = fabric.n_sites, np.asarray(GEO_LAM), np.asarray(GEO_MIX)
    r = lam.size
    est = EwmaMomentEstimator(prior=fabric.moments(PLAN_CHUNK_MB))
    rate_est = EwmaRateEstimator(prior=(mix[:, None] * lam[None, :]).ravel())
    kw = dict(k=np.asarray(PLAN_K), cost=fabric.cluster.cost.cpu().numpy(), theta=PLAN_THETA,
              estimator=est, max_iters=GEO_REPLAN_MAX_ITERS,
              rollout_requests=GEO_ROLLOUT_REQUESTS)
    rp, seq = GeoAdaptiveReplanner(**kw), GeoAdaptiveReplanner(rollout_batched=False, **kw)
    gen = torch.Generator(device=dev).manual_seed(91)
    avail = np.ones(NODES, bool)
    pi, carry, launches, calls, means = geo_pi, None, 0, [], []
    for s in range(GEO_REPLAN_SEGMENTS):
        lam_cs = np.roll(mix, s)[:, None] * lam[None, :]
        if s > 0:
            lam_hat, pi_before = rate_est.rates.reshape(c, r), pi
            draws = segment_draws(gen, on_card(lam_hat, dev), GEO_ROLLOUT_REQUESTS, NODES, 1)
            with recorded(simulator, "fcfs_scan") as cc:
                pi, nl = counted(f"9e geo replan before segment {s}", lambda: rp.replan(
                    lam_hat, avail, pi0=pi_before, carry=carry, draws=draws))
                launches += nl
                line = (f"[9e] replan before segment {s}: {len(rp.last_scores)} candidates, "
                        f"iterations {rp.solve_iters[-1]}, solve {rp.solve_walls[-1]:.3f} s, "
                        f"rollouts {rp.rollout_walls[-1]:.3f} s (B1 {nl} launch at "
                        f"{tuple(cc[-1][0][1].shape)})")
                if s == 1:  # the sequential loop on the same candidates and draws
                    pi_seq, ns = counted("9e sequential geo replan", lambda: seq.replan(
                        lam_hat, avail, pi0=pi_before, carry=carry, draws=draws))
                    launches += ns
                    same = int(np.argmin(seq.last_scores)) == int(torch.argmin(rp.last_scores))
                    line += (f"; sequential loop ({ns} launches): chosen index "
                             f"{int(np.argmin(seq.last_scores))} vs batched "
                             f"{int(torch.argmin(rp.last_scores))}, equal {same}, plans bitwise "
                             f"{np.array_equal(pi, pi_seq)}")
                    if not same:
                        failed.append("9e: the batched geo argmin differs from the sequential loop's")
            calls += cc
            print(line)
        with recorded(simulator, "fcfs_scan") as cc:
            (res, carry), nl = counted("9e simulate_geo_segment", lambda: simulate_geo_segment(
                gen, pi, lam_cs, fabric, PLAN_CHUNK_MB, SEGMENT_REQUESTS, carry=carry))
        launches += nl
        calls += cc
        est.update(res.obs)
        rate_est.update(res.site_id * r + res.file_id, float(res.arrival[-1] - res.arrival[0]))
        means.append(float(res.latency.mean()))
    print(f"[9e] geo segments under the client mix rotating one site a segment: mean latency "
          f"{np.round(means, 3).tolist()} s; estimated (C, r) rates after the last segment "
          f"{np.round(rate_est.rates.reshape(c, r), 5).tolist()}")
    if not all(np.isfinite(means)):
        failed.append(f"9e: geo segment means {means}")
    return launches, calls


def phase_guards(dev, loop: dict, failed: list) -> tuple:
    """9f: simulate_fleet under REPRO_DIAG=1 (materialized and streaming, with
    the cache) raises nothing; a deliberate np.asarray or float() of a CUDA
    tensor inside hot_path raises."""
    cl = tahoe_testbed(device=dev)
    lam, ks, lam_np, ks_np, chunk, eff = catalog_inputs(dev)
    fabric = GeoFabric.single_site(cl)
    ttl_t = on_card(loop["ttl"], dev)
    gen = torch.Generator(device=dev).manual_seed(92)
    launches, calls = 0, []
    with diag_armed() as reg, recorded(simulator, "fcfs_scan") as c:
        before = reg["storage.simulate_fleet"].guarded_calls
        for stream in (False, True):
            fleet, nl = counted(f"9f simulate_fleet stream={stream}", lambda: simulate_fleet(
                gen, loop["aware"].pi, lam[None], fabric, eff, PLAN_FLEET["n_requests"],
                PLAN_FLEET["n_seeds"], cache_ttl=ttl_t, cache_hit_latency=CACHE_HIT_LATENCY,
                stream=stream, n_chunks=2 if stream else 1))
            launches += nl
            print(f"[9f] simulate_fleet (stream={stream}) under REPRO_DIAG=1: mean "
                  f"{float(fleet.mean_latency()):.4f} s, B1 {nl} launch(es), raised nothing")
        fleet_guarded = reg["storage.simulate_fleet"].guarded_calls - before
        x = torch.arange(4.0, device=dev)
        caught = []
        for name, fn in (("np.asarray", lambda: np.asarray(x)), ("float", lambda: float(x[0]))):
            try:
                with diag.hot_path("chip_smoke.deliberate"):
                    fn()
                caught.append(f"{name}: nothing raised")
            except diag.HostSyncError as err:
                caught.append(f"{name}: HostSyncError ({str(err)[:40]}...)")
            except RuntimeError as err:  # the CUDA sync-debug mode
                caught.append(f"{name}: RuntimeError ({str(err)[:60]}...)")
    calls += c
    print(f"[9f] guarded simulate_fleet calls {fleet_guarded}; deliberate syncs inside hot_path: "
          f"{caught}; sync-debug mode after the guards {torch.cuda.get_sync_debug_mode()}")
    if not (fleet_guarded == 2 and caught[0].startswith("np.asarray: HostSyncError")
            and caught[1].startswith("float: RuntimeError")
            and torch.cuda.get_sync_debug_mode() == 0):
        failed.append(f"9f: guards {caught}, {fleet_guarded} guarded fleets")
    return launches, calls


def phase_control_plane(dev, geo_pi, loop: dict) -> tuple:
    """Phase 9: 9a-9f, then every B1 call of the phase held bitwise against
    the plain twin with its own carried state, grouped by (N, m). Returns
    B1's launches by path and the largest busy |difference|."""
    t_phase = time.perf_counter()
    failed: list[str] = []
    serve_launches, serve_calls = phase_serving(dev, failed)
    wall_launches, wall_calls = phase_replan_wall(dev, failed)
    repair_launches, repair_calls = phase_repair_replan(dev, loop, failed)
    phase_hier_replan(dev, failed)
    geo_launches, geo_calls = phase_geo_replan(dev, geo_pi, failed)
    guard_launches, guard_calls = phase_guards(dev, loop, failed)
    by_path = {"serving_simulate_serving": serve_launches,
               "replan_wall_rollouts": wall_launches,
               "repair_replan_segments_and_rollouts": sum(repair_launches.values()),
               "geo_replan_segments_and_rollouts": geo_launches,
               "diag_simulate_fleet": guard_launches}
    print(f"[9] fcfs launches {by_path} (9c {repair_launches})")
    err = hold_grouped(serve_calls + wall_calls + repair_calls + geo_calls + guard_calls, "9", dev)
    torch.cuda.empty_cache()
    print(f"[9] phase 9 wall {time.perf_counter() - t_phase:.3f} s")
    if failed:
        raise AssertionError("phase 9 failed: " + "; ".join(failed))
    return by_path, err


# ---------------------------------------------------------------------------
# Phase 10: the scenario engine (A16) on kernel B1.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def scenario_solves():
    """The engine's initial plans (``solve``, ``solve_hierarchical``): each
    call's name, iterations and wall, the card synchronized after it."""
    log = []
    originals = {name: getattr(scenario_engine, name) for name in ("solve", "solve_hierarchical")}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            sol = out if hasattr(out, "iterations") else out[1]
            log.append((name, int(sol.iterations), time.perf_counter() - t0))
            return out
        return call

    for name, fn in originals.items():
        setattr(scenario_engine, name, timed(name, fn))
    try:
        yield log
    finally:
        for name, fn in originals.items():
            setattr(scenario_engine, name, fn)


@contextlib.contextmanager
def adaptive_armed(guarded: dict):
    """``REPRO_DIAG=1`` around every adaptive ``run_scenario`` call the
    engine makes (``run_all_policies`` included); ``guarded`` gets each
    guarded region's calls in those runs."""
    fn = scenario_engine.run_scenario

    def call(spec, policy="adaptive", **kwargs):
        if policy != "adaptive":
            return fn(spec, policy, **kwargs)
        with diag_armed() as reg:
            before = {k: v.guarded_calls for k, v in reg.items()}
            out = fn(spec, policy, **kwargs)
            for k, v in reg.items():
                if v.guarded_calls > before.get(k, 0):
                    guarded[k] = guarded.get(k, 0) + v.guarded_calls - before.get(k, 0)
        return out

    scenario_engine.run_scenario = call
    try:
        yield guarded
    finally:
        scenario_engine.run_scenario = fn


def print_outcome(tag: str, o) -> None:
    line = (f"[{tag}] {o.policy}: mean {o.mean:.6g} s, p99 {o.p99:.6g} s, windowed p99 "
            f"{o.p99_windowed:.6g} s, degraded {o.degraded_frac:.4f}, segment means "
            f"{[round(float(v), 3) for v in o.seg_mean]} s")
    if np.isfinite(o.storage_cost):
        line += f", hit_frac {o.hit_frac:.4f}, storage cost {o.storage_cost:.4f}"
    if o.site_mean is not None:
        line += f", site means {[round(float(v), 3) for v in o.site_mean]} s"
    if o.replans:
        line += (f"; {o.replans} replans: iterations {[int(v) for v in o.solve_iters]}, solve "
                 f"walls {np.round(o.solve_walls, 3).tolist()} s, rollout walls "
                 f"{np.round(o.rollout_walls, 4).tolist()} s")
    if o.resolved_counts:
        line += f", resolved clusters {list(o.resolved_counts)}"
    print(line)


def run_scenario_cell(tag: str, label: str, fn, failed: list) -> tuple:
    """One scenario cell on the card: B1's launches counted, every scan
    recorded, the engine's initial plans timed; prints every outcome and
    returns ``(outcomes by policy, launches, calls, solver seconds, wall)``."""
    with recorded(simulator, "fcfs_scan") as calls, scenario_solves() as solves:
        t0 = time.perf_counter()
        outs, launches = counted(f"{tag} {label}", fn)
        wall = time.perf_counter() - t0
    by_policy = {o.policy: o for o in outs}
    for name, iters, secs in solves:
        print(f"[{tag}] initial plan ({name}): {iters} iterations, {secs:.3f} s")
    for o in outs:
        print_outcome(tag, o)
    solver_s = sum(secs for _, _, secs in solves) + sum(sum(o.solve_walls) for o in outs)
    print(f"[{tag}] {label}: wall {wall:.3f} s, solver {solver_s:.3f} s "
          f"({100 * solver_s / wall:.1f} %), B1 launches {launches}")
    for o in outs:
        if not np.isfinite(o.mean):
            failed.append(f"{tag}: {o.policy}'s mean {o.mean}")
    return by_policy, launches, calls, solver_s, wall


def scenario_cell(tag: str, device: str) -> dict:
    """One cell of phase 10 on ``device``, in a process of its own
    (``phase_scenarios`` runs the four at once): the cell's printed lines,
    its gate failures, B1's launches, the largest busy |difference| of its
    scans held bitwise against the plain twin, and its solver seconds and
    wall."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    failed: list[str] = []
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        cl = tahoe_testbed(device=dev)
        if tag == "10a":  # node-failure, all three policies; adaptive under REPRO_DIAG=1
            guarded: dict = {}
            with adaptive_armed(guarded):
                out, n, calls, sec, wall = run_scenario_cell(
                    tag, "run_all_policies(node-failure)", lambda: run_all_policies(
                        get_scenario("node-failure"), seed=SCENARIO_SEED, cluster=cl), failed)
            ada, sta, obl = out["adaptive"], out["static"], out["oblivious"]
            print(f"[10a] guarded calls in the adaptive run under REPRO_DIAG=1: {guarded}")
            if not (ada.mean < sta.mean and ada.mean < obl.mean):
                failed.append(f"10a: adaptive mean {ada.mean} not below static {sta.mean} and "
                              f"oblivious {obl.mean} (scenario_suite.py:102-115)")
            if not (guarded.get("core.solve_merged", 0) >= ada.replans
                    and guarded.get("serving.batched_rollout_scores", 0) == ada.replans):
                failed.append(f"10a: the adaptive run under REPRO_DIAG=1 guarded {guarded}, "
                              f"{ada.replans} replans")
        elif tag == "10b":  # cache-outage with the cache-blind static baseline
            out, n, calls, sec, wall = run_scenario_cell(
                tag, "run_all_policies(cache-outage)", lambda: run_all_policies(
                    get_scenario("cache-outage"), seed=SCENARIO_SEED, cluster=cl,
                    include_cacheblind=True), failed)
            ada, blind = out["adaptive"], out["static-cacheblind"]
            if not (ada.mean < blind.mean and ada.p99_windowed < blind.p99_windowed
                    and ada.storage_cost <= blind.storage_cost):
                failed.append(f"10b: adaptive mean / windowed p99 / storage cost {ada.mean} / "
                              f"{ada.p99_windowed} / {ada.storage_cost} against the cache-blind "
                              f"{blind.mean} / {blind.p99_windowed} / {blind.storage_cost} "
                              "(scenario_suite.py:82-101)")
        elif tag == "10c":  # hotspot-drift over 10^5 files, planned through the hierarchy
            spec, h = hotspot_drift_hierarchical(**SCENARIO_HIER)
            print(f"[10c] {spec.name}: {spec.r} files in {h.n_clusters} clusters, "
                  f"{spec.requests_per_segment} requests a segment, theta {spec.theta:.6g}")
            out, n, calls, sec, wall = run_scenario_cell(
                tag, "static and adaptive (hierarchical)", lambda: [
                    run_scenario(spec, policy, seed=SCENARIO_SEED, cluster=cl, hierarchy=h)
                    for policy in ("static", "adaptive")], failed)
            if not out["adaptive"].mean < out["static"].mean:
                failed.append(f"10c: adaptive mean {out['adaptive'].mean} not below static "
                              f"{out['static'].mean} (tests/test_scenarios.py:364)")
        else:  # 10d: geo-client-shift, the geo closed loop against the geo-oblivious plan
            out, n, calls, sec, wall = run_scenario_cell(
                tag, "run_all_policies(geo-client-shift)", lambda: run_all_policies(
                    get_scenario("geo-client-shift"), seed=SCENARIO_SEED, cluster=cl), failed)
            ada, sta = out["adaptive"], out["static"]
            if not (ada.replans > 0 and ada.mean < sta.mean):
                failed.append(f"10d: {ada.replans} replans, adaptive mean {ada.mean} against "
                              f"static {sta.mean} (scenario_suite.py:74-81)")
        err = hold_grouped(calls, tag, dev)
    return dict(tag=tag, log=log.getvalue(), failed=failed, launches=n, err=err,
                solver_s=sec, wall=wall)


SCENARIO_PATHS = {"10a": "scenario_node_failure", "10b": "scenario_cache_outage",
                  "10c": "scenario_hotspot_drift_hier", "10d": "scenario_geo_client_shift"}


def start_scenarios(dev) -> tuple:
    """Phase 10's four cells started at once, one spawned process each,
    before phase 9; ``phase_scenarios`` collects them after it. A cell's
    wall is the solver's launches from the host (99 % of it, PERF.md §6),
    and so is most of phase 9's: one after the other the two took 429 s of
    a 1167 s run of this script on a slow host, near its 1200 s limit, so
    phase 9's walls are taken beside the cells."""
    pool = ProcessPoolExecutor(max_workers=len(SCENARIO_PATHS),
                               mp_context=multiprocessing.get_context("spawn"))
    futures = [pool.submit(scenario_cell, tag, str(dev)) for tag in SCENARIO_PATHS]
    return pool, futures, time.perf_counter()


def phase_scenarios(started: tuple) -> tuple:
    """Phase 10: the cells ``start_scenarios`` started, collected. Prints
    each cell's lines; returns B1's launches by path and the largest busy
    |difference|."""
    pool, futures, t_phase = started
    with pool:
        cells = [future.result() for future in futures]
    for cell in cells:
        print(cell["log"], end="")
    by_path = {SCENARIO_PATHS[cell["tag"]]: cell["launches"] for cell in cells}
    cells_s = sum(cell["wall"] for cell in cells)
    solver_s = sum(cell["solver_s"] for cell in cells)
    print(f"[10] fcfs launches {by_path}")
    print(f"[10] phase 10 wall {time.perf_counter() - t_phase:.3f} s, phase 9's included (the "
          f"cells' walls add to "
          f"{cells_s:.3f} s, of it solver {solver_s:.3f} s, {100 * solver_s / cells_s:.1f} %)")
    failed = [msg for cell in cells for msg in cell["failed"]]
    if failed:
        raise AssertionError("phase 10 failed: " + "; ".join(failed))
    return by_path, max(cell["err"] for cell in cells)


# ---------------------------------------------------------------------------
# Phase 11: SmolLM-135M's parameters through the EC checkpoint store (B2).
# ---------------------------------------------------------------------------


def tree_bytes(params) -> int:
    return sum(leaf.numel() * leaf.element_size() for _, leaf in flatten_with_keys(params))


def phase_checkpoint(dev, limits: dict) -> dict:
    """Phase 11: plan, save, two node failures, restore bitwise, replan,
    then a failure beyond a group's tolerance must raise; every B2 call of
    save and restore held bitwise to the plain twin and timed."""
    t_phase = time.perf_counter()
    model = lm.Model(get_config("smollm-135m"), device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(CKPT_SEED))
    nbytes = tree_bytes(params)
    group_mb = max(64.0, nbytes / 2**20 / 200)
    cl = tahoe_testbed(device=dev)
    t0 = time.perf_counter()
    plan = plan_for_params(params, cl, group_mb=group_mb, chunk_mb=group_mb / CKPT_CHUNK_DIV,
                           theta=CKPT_THETA, read_rate=CKPT_READ_RATE)
    plan_s = time.perf_counter() - t0
    coded = sum(g.n * -(-g.nbytes // g.k) for g in plan.groups)
    print(f"[11] SmolLM-135M float32: {nbytes / 1e9:.4f} GB in {len(flatten_with_keys(params))} "
          f"leaves; plan (group {group_mb:g} MB, chunk {group_mb / CKPT_CHUNK_DIV:g} MB, theta "
          f"{CKPT_THETA}) in {plan_s:.3f} s: restore bound {plan.latency_bound:.4f} s, storage "
          f"cost {plan.storage_cost:.4f}; " + "; ".join(
              f"{g.name} {g.nbytes / 2**20:.1f} MiB (n={g.n}, k={g.k}) on {list(g.placement)}"
              for g in plan.groups))
    failed: list[str] = []
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_checkpoint_", dir=BUILD_DIR.parent))
    try:
        store = ECCheckpointStore(root, plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded(ops, "gf256_matmul_cuda") as save_calls:
            _, save_launches = counted("11 save", lambda: store.save(params, step=0),
                                       "gf256_matmul")
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t0
        on_disk = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())
        print(f"[11] save: {coded / 1e9:.4f} GB coded, {on_disk / 1e9:.4f} GB on disk, "
              f"{save_s:.3f} s, B2 launches {save_launches}")
        g0 = plan.groups[0]
        victims = [g0.placement[-1], g0.placement[0]]  # a parity chunk, then a data chunk
        for v in victims:
            store.fail_node(v)
        lost = {g.name: sum(j in victims for j in g.placement) for g in plan.groups}
        if any(lost[g.name] > g.n - g.k for g in plan.groups):
            failed.append(f"11: failing {victims} exceeds a group's tolerance: {lost}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded(ops, "gf256_matmul_cuda") as restore_calls:
            got, restore_launches = counted("11 restore", lambda: store.restore(
                0, params, seed=CKPT_SEED), "gf256_matmul")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mismatched = [key for (key, a), (_, b) in zip(flatten_with_keys(params),
                                                      flatten_with_keys(got))
                      if not (a.dtype == b.dtype and torch.equal(a, b))]
        print(f"[11] nodes {victims} failed (chunks lost by group {lost}); restore {restore_s:.3f} s, "
              f"B2 launches {restore_launches}; leaves bitwise equal "
              f"{len(flatten_with_keys(params)) - len(mismatched)} of {len(flatten_with_keys(params))}")
        if mismatched:
            failed.append(f"11: restored leaves differ: {mismatched}")
        del got
        replan = plan.replan_after_failure(cl, set(victims), read_rate=CKPT_READ_RATE)
        bad = [g.name for g in replan.groups if set(g.placement) & set(victims) or g.n < g.k]
        print(f"[11] replan_after_failure: " + "; ".join(
            f"{g.name} (n={g.n}, k={g.k}) on {list(g.placement)}" for g in replan.groups))
        if bad:
            failed.append(f"11: the replan places chunks on failed nodes or n < k: {bad}")
        more = []  # fail group 0's nodes until fewer than k of its chunks survive
        for node in g0.placement:
            if sum(j in store.alive_nodes() for j in g0.placement) < g0.k:
                break
            if node in store.alive_nodes():
                store.fail_node(node)
                more.append(node)
        try:
            store.restore(0, params, seed=CKPT_SEED)
            failed.append(f"11: restore after failing {victims + more} did not raise")
        except RuntimeError as err:
            print(f"[11] {g0.name} after failing {victims + more}: restore raised {err}")
            if "data loss" not in str(err):
                failed.append(f"11: unexpected error {err}")
        save = hold_gf_against_plain(save_calls, gf256_matmul_plain, gf256_matmul_cuda,
                                     "11 save", limits)
        restore = hold_gf_against_plain(restore_calls, gf256_matmul_plain, gf256_matmul_cuda,
                                        "11 restore", limits)
        for label, rec, wall in (("save", save, save_s), ("restore", restore, restore_s)):
            print(f"[11] {label}: its B2 calls take {rec['sum_ms']:.4f} ms of the "
                  f"{wall * 1e3:.3f} ms wall ({100 * rec['sum_ms'] / (wall * 1e3):.2f} %)")
    finally:
        shutil.rmtree(root)
    print(f"[11] phase 11 wall {time.perf_counter() - t_phase:.3f} s")
    if failed:
        raise AssertionError("phase 11 failed: " + "; ".join(failed))
    return dict(save=(save_launches, save), restore=(restore_launches, restore))


# ---------------------------------------------------------------------------
# Phase 12: training on the card.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def watched_training():
    """Record what ``train()`` does without changing it: each train step's
    wall (ended by a synchronize), and each checkpoint save's and restore's
    wall and B2 launches, with a copy of the state a save was given and the
    state a restore returned (and the nodes alive then)."""
    log = dict(steps=[], saves=[], restores=[])
    make_step, save, restore = (train_mod.jit_train_step, ECCheckpointStore.save,
                                ECCheckpointStore.restore)
    b2 = COUNTERS["gf256_matmul"]

    def timed(fn, *args, **kwargs):
        before = b2.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, dict(wall=time.perf_counter() - t0, launches=b2.launches - before)

    def jit_train_step(*args, **kwargs):
        step_fn, *rest = make_step(*args, **kwargs)

        def train_step(state, batch):
            out, rec = timed(step_fn, state, batch)
            log["steps"].append(rec["wall"])
            return out

        return (train_step, *rest)

    def timed_save(self, state, step):
        out, rec = timed(save, self, state, step)
        copy = [leaf.clone() for leaf in tree_leaves(state)]
        log["saves"].append(dict(rec, step=step, state=copy))
        return out

    def timed_restore(self, step, template, **kwargs):
        out, rec = timed(restore, self, step, template, **kwargs)
        log["restores"].append(dict(rec, step=step, state=out, alive=self.alive_nodes()))
        return out

    train_mod.jit_train_step = jit_train_step
    ECCheckpointStore.save, ECCheckpointStore.restore = timed_save, timed_restore
    try:
        yield log
    finally:
        train_mod.jit_train_step = make_step
        ECCheckpointStore.save, ECCheckpointStore.restore = save, restore


def phase_train(dev, limits: dict) -> dict:
    """Phase 12a: ``train()`` at full width with EC checkpoints of the whole
    TrainState and a node failure, then a resume from the degraded store;
    the example's loss gate in both runs, the restore bitwise to the state
    saved, every B2 call of saves and restore held to the plain twin."""
    t_phase = time.perf_counter()
    failed: list[str] = []
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_", dir=BUILD_DIR.parent))
    first = dict(TRAIN, smoke=False, ckpt_dir=str(root), log_every=100, device=dev)
    again = dict(first, fail_node_at=None, resume=True)
    full_cfg, registry = get_config("smollm-135m"), train_mod.get_config
    train_mod.get_config = lambda arch: dataclasses.replace(full_cfg, n_layers=TRAIN_DEPTH)
    print(f"[12a] train('smollm-135m', smoke=False) on the (1, 1) mesh, {TRAIN_DEPTH} of "
          f"{full_cfg.n_layers} layers")
    try:
        with watched_training() as log, recorded(ops, "gf256_matmul_cuda") as calls:
            (_, losses, store), first_launches = counted(
                "12a train", lambda: train_mod.train(**first), "gf256_matmul")
            (_, losses2, _), again_launches = counted(
                "12a resume", lambda: train_mod.train(**again), "gf256_matmul")
        plan = store.plan
        victim = plan.groups[0].placement[0]
        coded = sum(g.n * -(-g.nbytes // g.k) for g in plan.groups)
        nbytes = sum(g.nbytes for g in plan.groups)
        codes = collections.Counter((g.k, g.n) for g in plan.groups)
        print(f"[12a] TrainState {nbytes / 1e9:.4f} GB in {len(plan.groups)} groups "
              f"((k, n): {dict(sorted(codes.items()))}), {coded / 1e9:.4f} GB coded a save; "
              f"restore bound {plan.latency_bound:.4f} s; node {victim} failed at step "
              f"{TRAIN['fail_node_at']}")

        # the example's assertions, in both runs
        for label, tail in (("train", losses[-1]), ("resume", losses2[-1])):
            ok = tail < losses[0] - TRAIN_LOSS_DROP
            print(f"[12a] {label}: loss {losses[0]:.4f} -> {tail:.4f} "
                  f"({'below' if ok else 'NOT below'} the first minus {TRAIN_LOSS_DROP})")
            if not ok:
                failed.append(f"12a {label}: last loss {tail:.4f} not below {losses[0]:.4f} - "
                              f"{TRAIN_LOSS_DROP}")
        # two saves, then one restore on the degraded store and one save
        save_steps = [rec["step"] for rec in log["saves"]]
        (rst,) = log["restores"]
        want_steps = list(range(TRAIN["ckpt_every"], TRAIN["steps"], TRAIN["ckpt_every"]))
        if save_steps != want_steps + [want_steps[-1]] or rst["step"] != want_steps[-1]:
            failed.append(f"12a: saves at {save_steps}, restore of {rst['step']}")
        if victim in rst["alive"]:
            failed.append(f"12a: node {victim} was alive at the restore")
        held = log["saves"][len(want_steps) - 1]["state"]
        restored = flatten_with_keys(rst["state"])
        mismatched = [key for (key, got), want in zip(restored, held)
                      if not (got.dtype == want.dtype and torch.equal(got, want))]
        print(f"[12a] restore of step {rst['step']} with node {victim} down: "
              f"{len(restored) - len(mismatched)} of {len(held)} leaves bitwise equal to the "
              f"state the first run saved")
        if mismatched or len(restored) != len(held):
            failed.append(f"12a: restored leaves differ: {mismatched}")

        # every B2 call, save by save, held to the plain twin and timed
        spans, at = [], 0
        for label, rec in ([(f"save {r['step']}", r) for r in log["saves"][:len(want_steps)]]
                           + [(f"restore {rst['step']}", rst)]
                           + [(f"save {r['step']} (resume)", r)
                              for r in log["saves"][len(want_steps):]]):
            spans.append((label, rec, calls[at:at + rec["launches"]]))
            at += rec["launches"]
        if at != len(calls):
            failed.append(f"12a: {len(calls)} B2 calls, {at} counted by saves and restore")
        held_by = {}
        for label, rec, span in spans:
            held_by[label] = hold_gf_against_plain(span, gf256_matmul_plain, gf256_matmul_cuda,
                                                   f"12a {label}", limits)
            print(f"[12a] {label}: wall {rec['wall']:.3f} s, {rec['launches']} B2 launches "
                  f"taking {held_by[label]['sum_ms']:.4f} ms "
                  f"({100 * held_by[label]['sum_ms'] / (rec['wall'] * 1e3):.3f} % of it)")
        del calls

        steps_s = np.asarray(log["steps"])
        steady = np.median(steps_s[5:])
        tokens = TRAIN["batch"] * TRAIN["seq"]
        print(f"[12a] {len(steps_s)} train steps: first {steps_s[0] * 1e3:.1f} ms, median "
              f"{steady * 1e3:.2f} ms, p95 {np.quantile(steps_s[5:], 0.95) * 1e3:.2f} ms, "
              f"{tokens / steady:.6g} tokens/s ({tokens} tokens a step); B2 launches "
              f"{first_launches} in the first run, {again_launches} in the resume")
    finally:
        train_mod.get_config = registry
        shutil.rmtree(root)
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[12a] phase 12a wall {wall:.3f} s")
    if failed:
        raise AssertionError("phase 12a failed: " + "; ".join(failed))
    saves = [held_by[label] for label, _, _ in spans if label.startswith("save")]
    return dict(save=(sum(r["launches"] for r in log["saves"]),
                      max(saves, key=lambda r: r["bound_ms"])),
                restore=(rst["launches"], held_by[f"restore {rst['step']}"]),
                wall=wall, step_ms=steady * 1e3)


def backward_bound(q, k) -> dict:
    """The least time for the backward of one causal attention call: q, k,
    v, the output and its cotangent read once, dq, dk, dv written once, or
    its float32 operations (S recomputed, dV, dP, dQ, dK: 5 x 2 x hd per
    visible (row, key) pair) at the float32 rate, as TF32 is off."""
    b, tq, h, hd = q.shape
    pairs = int(np.minimum(np.arange(1, tq + 1), k.shape[1]).sum())
    n_bytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    n_ops = 10 * hd * pairs * b * h
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", bound_flop=n_ops)


def phase_grad(dev) -> dict:
    """Phase 12b: SmolLM-135M's loss and gradients at O0, O2 (B4 under
    autograd) and O3 (O2 with remat) on one batch; every B4 call held to the
    plain twin; B4's forward and its backward timed on the path's inputs."""
    t_phase = time.perf_counter()
    failed: list[str] = []
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("smollm-135m")
    models = {lvl: build_model(cfg, dtype=torch.float32, remat="none", opt=lvl, device=dev)
              for lvl in ("O0", "O2", "O3")}
    params = models["O0"].init(torch.Generator(device=dev).manual_seed(GRAD_SEED))
    batch = SyntheticLM(cfg.vocab, GRAD_SEQ, GRAD_BATCH, seed=GRAD_SEED, device=dev).batch_at(0)
    results, launches, walls = {}, {}, {}
    with recorded(fa, "flash_attention") as calls:
        for lvl in ("O0", "O2", "O3"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if lvl == "O0":  # naive attention: no B4
                results[lvl] = loss_and_grads(models[lvl], params, batch)
            else:
                start = len(calls)
                results[lvl], launches[lvl] = counted(
                    f"12b {lvl}", lambda: loss_and_grads(models[lvl], params, batch),
                    "flash_attention")
            torch.cuda.synchronize()
            walls[lvl] = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"[12b] {lvl} loss and gradients: {walls[lvl] * 1e3:.1f} ms, peak {peak:.2f} GiB"
                  + (f", {launches[lvl]} B4 launches" if lvl in launches else ""))
            if lvl == "O2" and not all(out.grad_fn is not None for _, _, out in calls[start:]):
                failed.append("12b: B4's output under autograd has no grad_fn")
    for lvl, base in (("O2", "O0"), ("O3", "O0"), ("O3", "O2")):
        (loss, grads), (want, want_grads) = results[lvl], results[base]
        ref = dict(flatten_with_keys(want_grads))
        rel = {key: float((g - ref[key]).norm() / ref[key].norm())
               for key, g in flatten_with_keys(grads)}
        worst = max(rel, key=rel.get)
        loss_rel = abs(float(loss) - float(want)) / abs(float(want))
        print(f"[12b] {lvl} vs {base}: loss {float(loss):.7f} vs {float(want):.7f} "
              f"(rel {loss_rel:.3g}); worst gradient leaf {worst}: relative L2 "
              f"{rel[worst]:.3g} over {len(rel)} leaves")
        if not loss_rel <= GRAD_LOSS_RTOL:
            failed.append(f"12b {lvl} vs {base}: loss rel {loss_rel:.3g} > {GRAD_LOSS_RTOL}")
        if not rel[worst] <= GRAD_REL_L2:
            failed.append(f"12b {lvl} vs {base}: {worst} relative L2 {rel[worst]:.3g}")
    del results

    # every B4 call (O2's forwards, O3's forwards and recomputes) vs the twin
    worst_err = 0.0
    with torch.no_grad():
        for args, kwargs, got in calls:
            q, k, v = (a.detach() for a in args)
            plain_ms, want = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kwargs), reps=1)
            worst_err = max(worst_err, float((got.detach() - want).abs().max()))
    print(f"[12b] {len(calls)} B4 calls of the gradient path == plain twin, max_abs_err "
          f"{worst_err:.3g}")
    if not worst_err <= 2e-5:
        failed.append(f"12b: B4 differs from plain twin by {worst_err}")

    # B4's forward and the Function's backward on the path's own inputs
    args, kwargs, _ = calls[-1]
    del calls
    q, k, v = (a.detach() for a in args)
    record = dict(max_abs_err=worst_err, **flash_bound(q, k))
    bwd = backward_bound(q, k)
    scale = kwargs["scale"]
    with torch.no_grad():
        out = fa.flash_attention(q, k, v, **kwargs)  # warm
        record["ms"], out = cuda_ms(lambda: fa.flash_attention(q, k, v, **kwargs), reps=5)
        record["plain_ms"], _ = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kwargs),
                                        reps=1)
        dout = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
        backward = lambda: fa.flash_attention_backward(
            q, k, v, out, dout, scale=scale, causal=kwargs["causal"],
            window=kwargs["window"], k_blk=kwargs["k_blk"])
        backward()  # warm
        record["backward_ms"], _ = cuda_ms(backward, reps=3)
    g = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (
        q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale)

    def sdpa_both():
        return torch.autograd.grad(sdpa(), (qt, kt, vt), dout.transpose(1, 2))

    with torch.no_grad():
        sdpa()  # warm
        record["library_ms"], _ = cuda_ms(sdpa, reps=5)
    sdpa_both()  # warm
    both_ms, _ = cuda_ms(sdpa_both, reps=3)
    record.update(backward_bound_ms=bwd["bound_ms"], library_fwd_bwd_ms=both_ms)
    print(f"[12b] B4 {tuple(q.shape)} x {tuple(k.shape)} forward on the path's inputs: "
          f"{record['ms']:.4f} ms (plain twin {record['plain_ms']:.3f} ms, "
          f"scaled_dot_product_attention {record['library_ms']:.4f} ms, bound "
          f"{record['bound_ms']:.4f} ms, {record['bound_by']}); its backward in torch ops "
          f"{record['backward_ms']:.4f} ms (bound {bwd['bound_ms']:.4f} ms: "
          f"{bwd['bound_flop']:.4g} float32 FLOP, {bwd['bound_by']}; "
          f"{100 * bwd['bound_ms'] / record['backward_ms']:.1f} % of it); "
          f"scaled_dot_product_attention forward + backward {both_ms:.4f} ms")
    print(f"[12b] phase 12b wall {time.perf_counter() - t_phase:.3f} s")
    if failed:
        raise AssertionError("phase 12b failed: " + "; ".join(failed))
    return dict(launches=launches, record=record)


# ---------------------------------------------------------------------------
# Phase 13: the GQA / MoE models of head width 128 at full width.
# ---------------------------------------------------------------------------


def plain_errors(args, kwargs, out, slices: int = 1, rtol: float = 0.0) -> list:
    """|out - plain twin| at most, for each of ``slices`` slices of the KV
    heads (with their query heads): the twin run a slice at a time, each
    on the call's own inputs, since a head's attention reads only its own
    rows. With ``rtol``, each difference less ``rtol`` x |twin| (bfloat16:
    one rounding of the output, its ulp, 2^-7 of it at most)."""
    q, k, v = args
    kh = k.shape[2]
    g, step = q.shape[2] // kh, -(-kh // slices)
    errs = []
    for j in range(0, kh, step):
        heads = slice(j * g, (j + step) * g)
        want = fa.flash_attention_plain(q[:, :, heads], k[:, :, j:j + step], v[:, :, j:j + step],
                                        **kwargs).float()
        diff = (out[:, :, heads].float() - want).abs()
        errs.append(float((diff - rtol * want.abs()).max() if rtol else diff.max()))
    return errs


@contextlib.contextmanager
def held_flash(atol: float = 2e-5, slices: int = 1, keep: str = "last", rtol: float = 0.0):
    """Hold every B4 call a main path makes against the plain twin as it is
    made (``plain_errors`` over ``slices`` slices of the heads; with
    ``rtol``, each call within atol + rtol x |twin|), and keep only its
    error: at Phi-4-mini's width the 288 calls of serving hold 76 GB of
    inputs and outputs. The record keeps the count, the worst error (over
    rtol x |twin| where ``rtol`` is set), the twin's time on the last call
    and, under "last", the last call (``keep="first"``: the first)."""
    fn = fa.flash_attention
    record = dict(calls=0, max_abs_err=0.0, plain_ms=0.0, last=None)

    def holder(*args, **kwargs):
        out = fn(*args, **kwargs)
        record["plain_ms"], errs = cuda_ms(
            lambda: plain_errors(args, kwargs, out, slices, rtol), reps=1)
        err = max(errs)
        if not all(e <= atol for e in errs):
            raise AssertionError(f"B4 {tuple(args[0].shape)} differs from plain twin by {errs}")
        record["calls"] += 1
        record["max_abs_err"] = max(record["max_abs_err"], err)
        if keep == "last" or record["last"] is None:
            record["last"] = (args, kwargs, out)
        return out

    fa.flash_attention = holder
    try:
        yield record
    finally:
        fa.flash_attention = fn


def phase_phi4_serve(dev, limits: dict) -> tuple[int, dict]:
    """13a: Phi-4-mini at full width and depth through ``serve`` with phase
    6's load, every B4 call held as it is made; then a prefill and its
    decode steps timed without the holds, a naive-attention prefill on the
    same weights and tokens, and B4 timed on the path's inputs."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prefill_launches = []
    prefill = lm.Model.prefill

    def counted_prefill(self, *args, **kwargs):
        for counter in COUNTERS.values():
            counter.launches = 0
        out = prefill(self, *args, **kwargs)
        prefill_launches.append(COUNTERS["flash_attention"].launches)
        return out

    lm.Model.prefill = counted_prefill
    try:
        with held_flash() as held:
            run = serve("phi4-mini-3.8b", smoke=False, device=dev, **SERVE)
    finally:
        lm.Model.prefill = prefill
    serve_s = time.perf_counter() - t0
    cfg = run.model.cfg
    n_params = sum(x.numel() for x in tree_leaves(run.params))
    print(f"[13a] serve('phi4-mini-3.8b', smoke=False): {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim_}, "
          f"{n_params:.4g} parameters ({4 * n_params / 1e9:.2f} GB float32); serve wall "
          f"{serve_s:.3f} s with every B4 call held as it was made")
    if prefill_launches != [cfg.n_layers] * (SERVE["n_batches"] + 1):
        raise AssertionError(f"13a B4 launches per prefill {prefill_launches}, "
                             f"expected {cfg.n_layers} for each")
    if held["calls"] != sum(prefill_launches):
        raise AssertionError(f"13a held {held['calls']} B4 calls of {sum(prefill_launches)}")
    print(f"[13a] {held['calls']} B4 calls of the serve path == plain twin, max_abs_err "
          f"{held['max_abs_err']:.3g}")
    pi = run.router.pi[0]
    if not np.isfinite(run.router.latency_bound):
        raise AssertionError(f"13a plan latency bound {run.router.latency_bound}")
    if any(pi[j] <= 0 for r in run.replicas for j in r):
        raise AssertionError(f"13a routed outside pi's support: {run.replicas}, pi {pi}")
    for toks in run.tokens:
        if toks.shape != (SERVE["batch"], SERVE["gen_len"] + 1) or not (
                (toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"13a generated tokens {tuple(toks.shape)} out of range")

    # a prefill and its decode steps without the holds; the naive prefill
    cache_len = SERVE["prompt_len"] + SERVE["gen_len"]
    batch = {"tokens": run.prompts[0]}
    prefill_s, (logits, caches) = best_wall(
        lambda: run.model.prefill(run.params, batch, cache_len=cache_len), reps=1)
    tok = torch.argmax(logits, -1)
    pos = lambda p: torch.full((SERVE["batch"],), p, dtype=torch.int64, device=dev)

    def decode():
        nonlocal caches, tok
        for t in range(SERVE["gen_len"]):
            out, caches = run.model.decode_step(run.params, caches,
                                                {"token": tok, "pos": pos(SERVE["prompt_len"] + t)})
            tok = torch.argmax(out, -1)

    decode_s, _ = best_wall(decode, reps=1)
    del caches
    naive = dataclasses.replace(run.model, attn_impl="naive")
    naive_logits, _ = naive.prefill(run.params, batch, cache_len=cache_len)
    logit_err = float((logits - naive_logits).abs().max())
    if not (logit_err <= 1e-3 and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"13a naive and B4 prefill logits differ by {logit_err}")
    tokens = SERVE["batch"] * SERVE["prompt_len"]
    lat = np.asarray(run.latencies)
    print(f"[13a] naive vs B4 prefill last-position logits: max_abs_err {logit_err:.3g}; "
          f"routes {run.replicas} inside pi's support {np.round(pi, 3)}; without the holds: "
          f"prefill {prefill_s * 1e3:.3f} ms per {tokens}-token batch "
          f"({tokens / prefill_s:.6g} tokens/s), decode "
          f"{decode_s / SERVE['gen_len'] * 1e3:.3f} ms/token at batch {SERVE['batch']}; "
          f"serve's batch latency (holds included) mean {lat.mean() * 1e3:.3f} ms; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    args, kwargs, got = held.pop("last")
    record = time_flash("13a", args, kwargs, got, held, limits)
    record.update(prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_s / SERVE["gen_len"] * 1e3)
    del run, naive, args, got
    torch.cuda.empty_cache()
    print(f"[13a] phase 13a wall {time.perf_counter() - t0:.3f} s")
    return sum(prefill_launches), record


def hold_to_forward(tag: str, name: str, outs: list, full, differ=frozenset(),
                    prefill: int = GQA_PREFILL) -> float:
    """The prefill's last-position logits and each decode step's (``outs``,
    in order from position ``prefill - 1``) against the forward's logits
    at the same position, within ``tests/test_models.py``'s rtol / atol;
    the (row, position) pairs in ``differ`` are left out. Returns the
    largest |difference|."""
    worst, worst_excess = 0.0, 0.0
    for j, out in enumerate(outs):
        position = prefill - 1 + j
        rows = [r for r in range(out.shape[0]) if (r, position) not in differ]
        got, want = out[rows], full[rows, position]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag} {name}: non-finite logits at position {position}")
        if not bool(torch.isfinite(want).all()):
            raise AssertionError(f"{tag} {name}: non-finite forward logits at position {position}")
        err = (got - want).abs()
        excess = float((err / (GQA_ATOL + GQA_RTOL * want.abs())).max())
        if not excess <= 1.0:
            raise AssertionError(f"{tag} {name}: decode differs from teacher forcing at "
                                 f"position {position} ({excess:.3g} of the tolerance)")
        worst = max(worst, float(err.max()))
        worst_excess = max(worst_excess, excess)
    print(f"[{tag}] {name}: prefill + {len(outs) - 1} decode steps vs forward_logits of the "
          f"whole sequence: max |diff| {worst:.3g}, at most {worst_excess:.3g} of rtol "
          f"{GQA_RTOL} / atol {GQA_ATOL}")
    return worst


def hold_flash_calls(label: str, calls) -> tuple[float, float]:
    """Every recorded B4 call against the plain twin on its inputs, each
    within atol 2e-5 (a NaN fails). Returns the largest |difference| and
    the twin's ms on the last call."""
    flash_err, plain_ms = 0.0, 0.0
    for i, (args, kwargs, got) in enumerate(calls):
        plain_ms, want = cuda_ms(lambda: fa.flash_attention_plain(*args, **kwargs), reps=1)
        err = float((got - want).abs().max())
        del want
        if not err <= 2e-5:
            raise AssertionError(f"{label}: B4 call {i} {tuple(args[0].shape)} differs from "
                                 f"plain twin by {err}")
        flash_err = max(flash_err, err)
    return flash_err, plain_ms


@contextlib.contextmanager
def recorded_routes():
    """Record every MoE routing call: its tokens' top-k experts and its aux
    loss, in call order."""
    fn = moe._route
    routes = []

    def recorder(x2d, router, mc):
        out = fn(x2d, router, mc)
        routes.append((out[1], out[2]))
        return out

    moe._route = recorder
    try:
        yield routes
    finally:
        moe._route = fn


def compare_routes(n_layers: int, fwd, pre, dec) -> set:
    """The (batch row, position) pairs whose top-k expert set differs, at any
    layer, between the forward of the whole sequence and the prefill or the
    decode step of that position."""
    differ = set()
    for layer in range(n_layers):
        full = torch.sort(fwd[layer][0].reshape(GQA_BATCH, -1, fwd[layer][0].shape[-1]), -1)[0]
        ours = [torch.sort(pre[layer][0].reshape(GQA_BATCH, GQA_PREFILL, -1), -1)[0]]
        ours += [torch.sort(step[layer][0].reshape(GQA_BATCH, 1, -1), -1)[0] for step in dec]
        mismatch = (torch.cat(ours, 1) != full).any(-1).nonzero().tolist()
        differ.update(map(tuple, mismatch))
    return differ


def teacher_forced(tag: str, model, params, batch: dict, pre: dict, dev, stage=None,
                   record: bool = True) -> dict:
    """Under ``no_grad``, every B4 call recorded: the forward of ``batch``'s
    whole sequence, a prefill of ``pre`` (its first tokens, GQA_PREFILL in
    13b) with room for the whole sequence, and decode steps fed the
    sequence's next tokens. ``stage(name, caches)`` runs before "forward",
    "prefill" and "decode" (``caches`` the prefill's there, else None).
    Returns the walls, B4's launches in the forward and in the prefill, the
    forward's logits (``full``), the prefill's last-position logits and
    each step's (``outs``), the caches after decode and the B4 calls (none
    kept without ``record``)."""
    stage = stage or (lambda name, caches: None)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    recorder = recorded(fa, "flash_attention") if record else contextlib.nullcontext([])
    with torch.no_grad(), recorder as calls:
        stage("forward", None)
        fwd_s, (full, fwd_launches) = best_wall(lambda: counted(
            f"{tag} forward", lambda: model.forward_logits(params, batch), "flash_attention",
            least=0), reps=1)
        stage("prefill", None)
        prefill_s, ((logits, caches), pre_launches) = best_wall(lambda: counted(
            f"{tag} prefill", lambda: model.prefill(params, pre, cache_len=s), "flash_attention",
            least=0), reps=1)
        stage("decode", caches)
        outs = [logits]

        def decode():
            nonlocal caches
            for t in range(pre["tokens"].shape[1], s):
                step = {"token": tokens[:, t],
                        "pos": torch.full((GQA_BATCH,), t, dtype=torch.int64, device=dev)}
                out, caches = model.decode_step(params, caches, step)
                outs.append(out)

        decode_s, _ = best_wall(decode, reps=1)
    return dict(fwd_s=fwd_s, prefill_s=prefill_s, decode_s=decode_s, fwd_launches=fwd_launches,
                pre_launches=pre_launches, full=full, outs=outs, caches=caches, calls=calls)


def gqa_model_run(arch: str, dev, tag: str = "13b", limits: dict | None = None,
                  prefill: int = GQA_PREFILL, stage_hook=None, time_call: str = "last") -> dict:
    """13b for one model, cut in depth to ``GQA_DEPTH`` (14a: SeamlessM4T
    at full depth, its encoder timed alone and fed ``enc_embeds``; 15:
    DeepSeek-V3; 16b: RecurrentGemma, a prefill of RG_PREFILL):
    ``teacher_forced`` on 2 x (``prefill`` + 32) tokens at O3, the
    prefill's and each step's logits held to the forward's, every B4 call
    held to its plain twin as it is made (``held_flash`` over HOLD_SLICES
    slices of the heads), an encoder-decoder's cross caches after decode
    bitwise the prefill's; the forward and the prefill timed again without
    the holds; with ``limits``, B4 also timed on the path's ``time_call``
    call, "last" or "first" (``record``). ``stage_hook(name)`` runs before
    "forward", "prefill" and "decode" and, with "after", once they are
    done."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full_cfg = get_config(arch)
    cfg = dataclasses.replace(full_cfg, n_layers=GQA_DEPTH.get(arch, full_cfg.n_layers))
    model = build_model(cfg, dtype=torch.float32, remat="none", opt="O3", device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(GQA_SEED))
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(GQA_SEED + 1)
    s = prefill + GQA_DECODE
    tokens = torch.randint(0, cfg.vocab, (GQA_BATCH, s), generator=gen, device=dev)
    batch = {"tokens": tokens}
    if cfg.mrope_sections is not None:
        batch["patch_embeds"] = torch.randn((GQA_BATCH, GQA_PATCHES, cfg.d_model),
                                            generator=gen, device=dev) * 0.1
        batch["positions"] = torch.arange(s, device=dev)[None, None].expand(3, GQA_BATCH, s)
    if cfg.encoder_layers:
        batch["enc_embeds"] = torch.randn((GQA_BATCH, cfg.encoder_seq, cfg.d_model),
                                          generator=gen, device=dev) * ENCDEC_ENC_SCALE
    pre = {k: (v[..., :prefill] if k in ("tokens", "positions") else v)
           for k, v in batch.items()}
    cut = f"{cfg.n_layers} of {full_cfg.n_layers} layers" + (
        "" if cfg.n_layers < full_cfg.n_layers else " (full depth)")
    encoder = (f", {cfg.encoder_layers} encoder layers fed enc_embeds "
               f"{tuple(batch['enc_embeds'].shape)}" if cfg.encoder_layers else "")
    kinds = ", ".join(f"{n} {kind}" for kind, n in collections.Counter(cfg.layer_kinds).items())
    m = cfg.mla
    heads = (f"{cfg.n_heads} heads of q/k {m.nope_head_dim + m.rope_head_dim} (nope "
             f"{m.nope_head_dim} + rope {m.rope_head_dim}) and v {m.v_head_dim}, latent cache "
             f"{m.kv_lora_rank} + {m.rope_head_dim} a token" if m else
             f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim_}")
    print(f"[{tag}] {arch}: {cut}{encoder} ({kinds}), d_model {cfg.d_model}, {heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {n_params:.4g} parameters "
          f"({4 * n_params / 1e9:.2f} GB float32)")
    result = dict(params=n_params)
    if cfg.encoder_layers:
        with torch.no_grad():
            model._run_encoder(params, batch["enc_embeds"])  # warm
            encoder_s, _ = best_wall(lambda: model._run_encoder(params, batch["enc_embeds"]),
                                     reps=2)
        result.update(encoder_ms=encoder_s * 1e3)
    marks, cross = {}, {}

    def stage(name, caches):
        marks[name] = len(routes)
        if name == "decode" and cfg.encoder_layers:
            cross.update(caches["period"][0]["cross"])
        if stage_hook is not None:
            stage_hook(name)

    syncs0 = moe._expert_compute.host_syncs
    try:
        with recorded_routes() as routes, held_flash(slices=HOLD_SLICES, keep=time_call) as held:
            run = teacher_forced(tag, model, params, batch, pre, dev, stage, record=False)
    finally:
        if stage_hook is not None:
            stage_hook("after")
    syncs = moe._expert_compute.host_syncs - syncs0
    attn_layers = sum(kind not in ("rglru", "rwkv") for kind in cfg.layer_kinds)  # B4's
    if run["fwd_launches"] != attn_layers or run["pre_launches"] != attn_layers:
        raise AssertionError(f"{tag} {arch}: B4 launches forward {run['fwd_launches']}, prefill "
                             f"{run['pre_launches']}, expected {attn_layers}")
    if held["calls"] != 2 * attn_layers:
        raise AssertionError(f"{tag} {arch}: held {held['calls']} B4 calls of {2 * attn_layers}")
    if cfg.encoder_layers:  # decode reads the prefill's cross K/V and never recomputes them
        kv = (cfg.n_layers, GQA_BATCH, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim_)
        after = run["caches"]["period"][0]["cross"]
        if tuple(cross["k"].shape) != kv or not all(
                torch.equal(after[key], cross[key]) for key in ("k", "v")):
            raise AssertionError(f"{tag} {arch}: the cross caches after decode are not the "
                                 f"prefill's")
        print(f"[{tag}] cross caches {kv} after {GQA_DECODE} decode steps == the prefill's, "
              f"bitwise")
        del after, cross
    del run["caches"]

    # the expert sets of the forward against the prefill's and the steps'
    differ = set()
    if cfg.moe is not None:
        n_moe = sum(_mlp_kind(kind) == "moe" for kind in cfg.layer_kinds)
        fwd_routes = routes[:marks["prefill"]]
        pre_routes = routes[marks["prefill"]:marks["decode"]]
        dec_routes = routes[marks["decode"]:]
        if not n_moe or len(fwd_routes) != n_moe or len(dec_routes) != n_moe * GQA_DECODE:
            raise AssertionError(f"{tag} {arch}: {len(fwd_routes)} routing calls in the forward "
                                 f"and {len(dec_routes)} in decode for {n_moe} MoE layers")
        dec_steps = [dec_routes[i * n_moe:(i + 1) * n_moe] for i in range(GQA_DECODE)]
        differ = compare_routes(n_moe, fwd_routes, pre_routes, dec_steps)
        load = torch.stack([torch.bincount(e.reshape(-1), minlength=cfg.moe.n_experts)
                            for e, _ in pre_routes])
        aux = [float(a) for _, a in pre_routes]
        print(f"[{tag}] {arch} prefill routing ({GQA_BATCH} x {GQA_PREFILL} tokens, top "
              f"{cfg.moe.top_k} of {cfg.moe.n_experts}, {cfg.moe.n_shared} shared): aux loss by "
              f"layer {[round(a, 7) for a in aux]} (sum {sum(aux):.7f}); per-expert load by "
              f"layer, min / median / max: "
              f"{[(int(r.min()), int(r.median()), int(r.max())) for r in load]}; "
              f"layer 0's load {load[0].tolist()}")
        print(f"[{tag}] {arch}: {len(differ)} (row, position) pairs whose top-{cfg.moe.top_k} "
              f"set differs between the forward and the prefill or decode path"
              + (f": {sorted(differ)}" if differ else ""))
        result.update(aux=sum(aux), routes_differ=len(differ))
    del routes

    # the prefill's logits (position 2015) and each step's against the forward
    result.update(max_abs_err_logits=hold_to_forward(tag, arch, run.pop("outs"),
                                                     run.pop("full"), differ, prefill))
    with torch.no_grad():  # the forward and the prefill again, without the holds
        fwd_s, _ = best_wall(lambda: model.forward_logits(params, batch), reps=1)
        prefill_s, _ = best_wall(lambda: model.prefill(params, pre, cache_len=s), reps=1)
    decode_s = run["decode_s"]  # decode launches no B4
    result.update(launches=run["fwd_launches"] + run["pre_launches"],
                  prefill_ms=prefill_s * 1e3, forward_ms=fwd_s * 1e3,
                  decode_ms_per_token=decode_s / GQA_DECODE * 1e3, host_syncs=syncs)

    if cfg.moe is not None:  # one MoE layer alone, at the prefill's and a step's tokens
        p = params["stack"]["period"][0]["moe"]
        p = {key: ({k: v[0] for k, v in val.items()} if isinstance(val, dict) else val[0])
             for key, val in p.items()}  # the shared expert is a dict of leaves
        h = torch.randn((GQA_BATCH, GQA_PREFILL, cfg.d_model), generator=gen, device=dev)
        with torch.no_grad():
            moe.moe_apply(p, h, cfg)  # warm
            n0 = moe._expert_compute.host_syncs
            result["moe_prefill_ms"], _ = cuda_ms(lambda: moe.moe_apply(p, h, cfg), reps=3)
            result["moe_decode_ms"], _ = cuda_ms(lambda: moe.moe_apply(p, h[:, :1], cfg), reps=5)
            per_call = (moe._expert_compute.host_syncs - n0) / 8
        print(f"[{tag}] {arch}: one MoE layer at {GQA_BATCH} x {GQA_PREFILL} tokens "
              f"{result['moe_prefill_ms']:.3f} ms, at {GQA_BATCH} x 1 (a decode step) "
              f"{result['moe_decode_ms']:.3f} ms; {per_call:g} host sync a layer call, "
              f"{syncs} in this model's forward, prefill and {GQA_DECODE} steps")
        del p, h
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, model
    torch.cuda.empty_cache()

    # the plain twin whole on the path's last B4 call
    flash_err = held["max_abs_err"]
    args, kwargs, got = held.pop("last")
    plain_ms, _ = cuda_ms(lambda: fa.flash_attention_plain(*args, **kwargs), reps=1)
    result.update(max_abs_err=flash_err)
    print(f"[{tag}] {arch}: {held['calls']} B4 calls (forward and prefill, held as made, the "
          f"twin over up to {HOLD_SLICES} slices of the heads; {tuple(args[0].shape)} x "
          f"{tuple(args[1].shape)} x {tuple(args[2].shape)} the {time_call}) == plain twin, "
          f"max_abs_err {flash_err:.3g}")
    if limits is not None:
        result.update(record=time_flash(tag, args, kwargs, got,
                                        dict(max_abs_err=flash_err, plain_ms=plain_ms), limits))
    del args, kwargs, got

    included = " (encoder included)" if cfg.encoder_layers else ""
    print(f"[{tag}] {arch}: "
          + (f"encoder {encoder_s * 1e3:.3f} ms ({GQA_BATCH} x {cfg.encoder_seq} frames), "
             if cfg.encoder_layers else "")
          + f"forward {fwd_s * 1e3:.3f} ms ({GQA_BATCH} x {s} tokens){included}, prefill "
          f"{prefill_s * 1e3:.3f} ms ({GQA_BATCH} x {prefill}){included} (both timed "
          f"without the holds), decode "
          f"{decode_s / GQA_DECODE * 1e3:.3f} ms/token at batch {GQA_BATCH}; peak "
          f"{peak:.2f} GiB; wall {time.perf_counter() - t0:.3f} s")
    result.update(peak_gib=peak)
    torch.cuda.empty_cache()
    return result


def phase_gqa(dev, limits: dict) -> dict:
    """Phase 13: 13a Phi-4-mini served at full width and depth, 13b the
    other four models at full width against teacher forcing."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    launches, record = phase_phi4_serve(dev, limits)
    models = {arch: gqa_model_run(arch, dev) for arch in GQA_DEPTH if arch != MLA_ARCH}
    print(f"[13] phase 13 wall {time.perf_counter() - t0:.3f} s")
    return dict(launches=launches, record=record, models=models)


# ---------------------------------------------------------------------------
# Phase 14: the encoder-decoder and RWKV6 at full width and depth.
# ---------------------------------------------------------------------------


def kernels_in(fn) -> int:
    """The CUDA kernels ``torch.profiler`` records while ``fn`` runs; fails
    if the trace holds none."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sum(1 for event in prof.events()
                  if event.device_type == torch.autograd.DeviceType.CUDA)
    if kernels == 0:
        raise RuntimeError("the profiler's trace recorded no device events")
    return kernels


def phase_rwkv(dev) -> dict:
    """14b: ``serve("rwkv6-1.6b", smoke=False)`` with phase 6's load (no prefill may launch a kernel of B1-B4: the path has none), then
    a forward of 2 x 2048 tokens, a prefill of the first 2016 with the WKV
    loop timed, and 32 decode steps held to the forward; the kernels a
    prefill and a decode step launch, counted by the profiler."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prefill_launches = []
    prefill = lm.Model.prefill

    def counted_prefill(self, *args, **kwargs):
        for counter in COUNTERS.values():
            counter.launches = 0
        out = prefill(self, *args, **kwargs)
        prefill_launches.append(sum(counter.launches for counter in COUNTERS.values()))
        return out

    full_cfg, registry = get_config("rwkv6-1.6b"), serve_mod.get_config
    lm.Model.prefill = counted_prefill
    serve_mod.get_config = lambda arch: dataclasses.replace(full_cfg, n_layers=RWKV_DEPTH)
    try:
        run = serve("rwkv6-1.6b", smoke=False, device=dev, **SERVE)
    finally:
        lm.Model.prefill = prefill
        serve_mod.get_config = registry
    serve_s = time.perf_counter() - t0
    model, params, cfg = run.model, run.params, run.model.cfg
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[14b] serve('rwkv6-1.6b', smoke=False): {cfg.n_layers} of {full_cfg.n_layers} "
          f"layers, d_model "
          f"{cfg.d_model}, {cfg.d_model // cfg.rwkv_head_size} heads of {cfg.rwkv_head_size}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab} (untied), {n_params:.4g} parameters "
          f"({4 * n_params / 1e9:.2f} GB float32); serve wall {serve_s:.3f} s")
    if len(prefill_launches) != SERVE["n_batches"] + 1 or any(prefill_launches):
        raise AssertionError(f"14b kernel launches per prefill {prefill_launches}: the path has "
                             f"no kernel of B1-B4")
    pi = run.router.pi[0]
    if not np.isfinite(run.router.latency_bound):
        raise AssertionError(f"14b plan latency bound {run.router.latency_bound}")
    if any(pi[j] <= 0 for r in run.replicas for j in r):
        raise AssertionError(f"14b routed outside pi's support: {run.replicas}, pi {pi}")
    for toks in run.tokens:
        if toks.shape != (SERVE["batch"], SERVE["gen_len"] + 1) or not (
                (toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"14b generated tokens {tuple(toks.shape)} out of range")
    tokens_served = SERVE["batch"] * SERVE["prompt_len"]
    lat = np.asarray(run.latencies)
    result = dict(params=n_params, serve_prefill_ms=np.mean(run.prefill_s) * 1e3,
                  serve_decode_ms_per_token=np.mean(run.decode_s) / SERVE["gen_len"] * 1e3)
    print(f"[14b] serve: {prefill_launches.count(0)} prefills with no kernel launch of B1-B4; "
          f"routes {run.replicas} inside pi's support {np.round(pi, 3)}; prefill "
          f"{result['serve_prefill_ms']:.3f} ms per {tokens_served}-token batch, decode "
          f"{result['serve_decode_ms_per_token']:.3f} ms/token at batch {SERVE['batch']}; "
          f"batch latency mean {lat.mean() * 1e3:.3f} ms, p95 "
          f"{np.quantile(lat, 0.95) * 1e3:.3f} ms")
    del run

    # teacher forcing on 2 x 2048 tokens, the WKV loop's share of the prefill
    gen = torch.Generator(device=dev).manual_seed(GQA_SEED + 1)
    s = GQA_PREFILL + GQA_DECODE
    tokens = torch.randint(0, cfg.vocab, (GQA_BATCH, s), generator=gen, device=dev)
    scan, loop = rwkv6._wkv_scan, dict(s=0.0, calls=0)

    def timed_scan(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = scan(*args)
        torch.cuda.synchronize()
        loop["s"] += time.perf_counter() - t
        loop["calls"] += 1
        return out

    def stage(name, caches):  # the host timer wraps the prefill's scans only
        rwkv6._wkv_scan = timed_scan if name == "prefill" else scan

    try:
        run = teacher_forced("14b", model, params, {"tokens": tokens},
                             {"tokens": tokens[:, :GQA_PREFILL]}, dev, stage)
    finally:
        rwkv6._wkv_scan = scan
    if run["fwd_launches"] or run["pre_launches"] or run["calls"]:
        raise AssertionError(f"14b: B4 launched ({run['fwd_launches']} in the forward, "
                             f"{run['pre_launches']} in the prefill): the path has no attention")
    caches = run.pop("caches")
    with torch.no_grad():
        step = {"token": tokens[:, -1], "pos": torch.full((GQA_BATCH,), s - 1, device=dev)}
        per_step = kernels_in(lambda: model.decode_step(params, caches, step))
        short = [kernels_in(lambda: model.prefill(params, {"tokens": tokens[:, :n]}, cache_len=n))
                 for n in RWKV_PROFILE_LENS]
    del caches
    if loop["calls"] != cfg.n_layers:
        raise AssertionError(f"14b: {loop['calls']} WKV scans in a prefill of {cfg.n_layers} "
                             f"layers")
    fwd_s, prefill_s, decode_s = run["fwd_s"], run["prefill_s"], run["decode_s"]
    result.update(max_abs_err_logits=hold_to_forward("14b", "rwkv6-1.6b", run.pop("outs"),
                                                     run.pop("full")),
                  forward_ms=fwd_s * 1e3, prefill_ms=prefill_s * 1e3,
                  decode_ms_per_token=decode_s / GQA_DECODE * 1e3,
                  wkv_loop_share=loop["s"] / prefill_s)
    del run
    print(f"[14b] forward {result['forward_ms']:.3f} ms ({GQA_BATCH} x {s} tokens), prefill "
          f"{result['prefill_ms']:.3f} ms ({GQA_BATCH} x {GQA_PREFILL}), of which the WKV loop "
          f"(a host timer around each layer's scan) {loop['s'] * 1e3:.3f} ms, "
          f"{100 * result['wkv_loop_share']:.1f} %; decode {result['decode_ms_per_token']:.3f} "
          f"ms/token at batch {GQA_BATCH}")
    (n0, n1), (k0, k1) = RWKV_PROFILE_LENS, short
    per_token = (k1 - k0) / (n1 - n0)
    fixed = k0 - per_token * n0
    result.update(launches_per_token_layer=per_token / cfg.n_layers,
                  launches_per_prefill=fixed + per_token * GQA_PREFILL,
                  launches_per_decode_step=per_step)
    print(f"[14b] kernels (torch.profiler): prefills of {n0} and {n1} tokens {k0} and {k1}, "
          f"so {per_token:g} a token ({result['launches_per_token_layer']:g} a token and "
          f"layer, the WKV loop) and {fixed:g} besides: "
          f"{result['launches_per_prefill']:.6g} for a prefill of {GQA_PREFILL} (extrapolated "
          f"linearly from the two, not profiled); "
          f"a decode step {per_step}")
    print(f"[14b] peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; wall "
          f"{time.perf_counter() - t0:.3f} s")
    del params, model
    torch.cuda.empty_cache()
    return result


def phase_encdec_rwkv(dev, limits: dict) -> dict:
    """Phase 14: 14a SeamlessM4T-medium and 14b RWKV6-1.6B, both at full
    width and depth."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    encdec = gqa_model_run("seamless-m4t-medium", dev, tag="14a", limits=limits)
    rwkv = phase_rwkv(dev)
    print(f"[14] phase 14 wall {time.perf_counter() - t0:.3f} s")
    return dict(encdec=encdec, rwkv=rwkv)


# ---------------------------------------------------------------------------
# Phase 15: DeepSeek-V3 (MLA) at full width, B4 at q/k width 192 and v 128.
# ---------------------------------------------------------------------------


def phase_mla(dev, limits: dict) -> dict:
    """Phase 15: DeepSeek-V3 at full width, 4 of 61 layers, through
    ``gqa_model_run``: the absorbed decode held to the expanded forward,
    every B4 call held to the twin as it is made, B4's (192, 128) instance
    timed on the path's last call."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    run = gqa_model_run(MLA_ARCH, dev, tag="15", limits=limits)
    print(f"[15] phase 15 wall {time.perf_counter() - t0:.3f} s")
    return run


# ---------------------------------------------------------------------------
# Phase 16: RecurrentGemma-2B (RG-LRU + local attention), B4 at head width 256.
# ---------------------------------------------------------------------------


def phase_recurrentgemma(dev, limits: dict) -> dict:
    """Phase 16: RecurrentGemma-2B at full width and depth. 16a serves it
    through ``serve`` with SERVE's load, every B4 call held as it is
    made (each prefill launches B4 once a local layer); 16b runs
    ``gqa_model_run`` on 2 x 4096 tokens, a prefill of RG_PREFILL and 32
    decode steps held to the forward, with a host timer around each RG-LRU
    scan of the prefill, the scan's kernels counted by the profiler on one
    scan at the prefill's shape, and B4 timed on the forward's first call
    ((2, 4096, 10, 1, 256), window 2048)."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prefill_launches = []
    prefill = lm.Model.prefill

    def counted_prefill(self, *args, **kwargs):
        for counter in COUNTERS.values():
            counter.launches = 0
        out = prefill(self, *args, **kwargs)
        prefill_launches.append(COUNTERS["flash_attention"].launches)
        return out

    lm.Model.prefill = counted_prefill
    try:
        with held_flash() as held:
            run = serve(RG_ARCH, smoke=False, device=dev, **SERVE)
    finally:
        lm.Model.prefill = prefill
    serve_s = time.perf_counter() - t0
    cfg = run.model.cfg
    kinds = collections.Counter(cfg.layer_kinds)
    n_params = sum(x.numel() for x in tree_leaves(run.params))
    print(f"[16a] serve('{RG_ARCH}', smoke=False): {cfg.n_layers} layers (full depth: "
          f"{kinds['rglru']} rglru, {kinds['local']} local), d_model {cfg.d_model}, lru width "
          f"{cfg.lru_width}, {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim_}, window "
          f"{cfg.window}, d_ff {cfg.d_ff}, vocab {cfg.vocab} (tied), {n_params:.4g} parameters "
          f"({4 * n_params / 1e9:.2f} GB float32); serve wall {serve_s:.3f} s with every B4 "
          f"call held as it was made")
    if prefill_launches != [kinds["local"]] * (SERVE["n_batches"] + 1):
        raise AssertionError(f"16a B4 launches per prefill {prefill_launches}, expected "
                             f"{kinds['local']} (one a local layer) for each")
    if held["calls"] != sum(prefill_launches):
        raise AssertionError(f"16a held {held['calls']} B4 calls of {sum(prefill_launches)}")
    pi = run.router.pi[0]
    if not np.isfinite(run.router.latency_bound):
        raise AssertionError(f"16a plan latency bound {run.router.latency_bound}")
    if any(pi[j] <= 0 for r in run.replicas for j in r):
        raise AssertionError(f"16a routed outside pi's support: {run.replicas}, pi {pi}")
    for toks in run.tokens:
        if toks.shape != (SERVE["batch"], SERVE["gen_len"] + 1) or not (
                (toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"16a generated tokens {tuple(toks.shape)} out of range")
    lat = np.asarray(run.latencies)
    result = dict(params=n_params, serve_launches=sum(prefill_launches),
                  serve_max_abs_err=held["max_abs_err"])
    print(f"[16a] {held['calls']} B4 calls of the serve path == plain twin, max_abs_err "
          f"{held['max_abs_err']:.3g}; routes {run.replicas} inside pi's support "
          f"{np.round(pi, 3)}; prefill {np.mean(run.prefill_s) * 1e3:.3f} ms per "
          f"{SERVE['batch'] * SERVE['prompt_len']}-token batch and decode "
          f"{np.mean(run.decode_s) / SERVE['gen_len'] * 1e3:.3f} ms/token at batch "
          f"{SERVE['batch']} (holds included); batch latency mean {lat.mean() * 1e3:.3f} ms; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del run, held
    torch.cuda.empty_cache()

    # 16b: teacher forcing past the window, the RG-LRU scans of the prefill timed
    scan, scans = rglru._linear_scan, dict(s=0.0, calls=0)

    def timed_scan(a, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = scan(a, b)
        torch.cuda.synchronize()
        scans["s"] += time.perf_counter() - t
        scans["calls"] += 1
        return out

    def hook(name):  # the host timer wraps the prefill's scans only
        rglru._linear_scan = timed_scan if name == "prefill" else scan

    tf = gqa_model_run(RG_ARCH, dev, tag="16b", limits=limits, prefill=RG_PREFILL,
                       stage_hook=hook, time_call="first")
    if scans["calls"] != kinds["rglru"]:
        raise AssertionError(f"16b: {scans['calls']} RG-LRU scans in a prefill of "
                             f"{kinds['rglru']} rglru layers")
    lru = cfg.lru_width or cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(GQA_SEED + 2)
    a = torch.rand((GQA_BATCH, RG_PREFILL, lru), generator=gen, device=dev)
    b = torch.randn((GQA_BATCH, RG_PREFILL, lru), generator=gen, device=dev)
    per_scan = kernels_in(lambda: rglru._linear_scan(a, b))
    scan_ms, _ = cuda_ms(lambda: rglru._linear_scan(a, b), reps=3)
    del a, b
    share = scans["s"] / (tf["prefill_ms"] / 1e3)
    print(f"[16b] RG-LRU scans in the prefill ({GQA_BATCH} x {RG_PREFILL} tokens, a host timer "
          f"around each of {scans['calls']} layers' scans): {scans['s'] * 1e3:.3f} ms, "
          f"{100 * share:.1f} % of the prefill's {tf['prefill_ms']:.3f} ms (timed without the "
          f"holds); one scan at ({GQA_BATCH}, {RG_PREFILL}, {lru}) {scan_ms:.3f} ms (CUDA "
          f"events), {per_scan} kernels (torch.profiler, "
          f"{int(np.ceil(np.log2(RG_PREFILL)))} doubling steps)")
    result.update(tf, scan_share=share, scan_ms=scan_ms, scan_kernels=per_scan)
    print(f"[16] phase 16 wall {time.perf_counter() - t0:.3f} s")
    return result


def sync_wall(fn):
    """(fn's result, its wall in s between two synchronizes)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def hold_train_state(got, want, rtol: float) -> dict:
    """One sharded train step's state against the unsharded step's from the
    same start (trees of full tensors): every leaf within ``rtol`` of its
    largest entry (v, AdamW's second moment, at twice it: a square doubles
    a relative error), the step count exactly. Returns the largest
    differences, relative to each leaf's largest entry."""
    got, want = dict(flatten_with_keys(got)), dict(flatten_with_keys(want))
    if got.keys() != want.keys():
        raise AssertionError("17a: the sharded state's leaves differ from the unsharded one's")
    worst = dict(moments=0.0, params=0.0)
    for key, w in want.items():
        g = got[key].to(w.device)
        if key == ".opt.step":
            if int(g) != int(w):
                raise AssertionError(f"17a: step {int(g)} against {int(w)}")
            continue
        scale = float(w.abs().max()) or 1.0
        rel = float((g.float() - w.float()).abs().max()) / scale
        kind = "params" if key.startswith(".params") else "moments"
        worst[kind] = max(worst[kind], rel)
        if not rel <= rtol * (2 if key.startswith(".opt.v") else 1):
            raise AssertionError(f"17a {key}: {rel:.3g} of its largest entry")
    return worst


def sharded_train(dev, mesh) -> dict:
    """17a: SHARD_TRAIN's sharded train steps of SmolLM-135M at O2, each
    held to the unsharded step from the same state."""
    cfg = get_config("smollm-135m")
    model = build_model(cfg, mesh, dtype=torch.float32, remat="none", opt="O2", device=dev)
    plain = build_model(cfg, None, dtype=torch.float32, remat="none", opt="O2", device=dev)
    n = SHARD_TRAIN
    opt = AdamW(lr=cosine_schedule(n["lr"], warmup=20, total=n["total"]), weight_decay=0.01)
    params = model.init(torch.Generator(device=dev).manual_seed(GRAD_SEED))
    meta = torch.empty((n["batch"], n["seq"]), dtype=torch.int64, device="meta")
    step, _, state_sh, batch_sh = jit_train_step(model, opt, mesh, {"tokens": meta})
    ref_step = make_train_step(plain, opt)
    state = place(TrainState(params, opt.init(params)), state_sh)
    gen = torch.Generator(device=dev).manual_seed(GRAD_SEED + 1)
    walls, ref_walls, launches, worst = [], [], 0, dict(loss=0.0, grad_norm=0.0)
    for i in range(n["steps"]):
        batch = {"tokens": torch.randint(0, cfg.vocab, (n["batch"], n["seq"]), generator=gen,
                                         device=dev)}
        start = gather(state)
        ((new, metrics), b4), wall = sync_wall(lambda: counted(
            f"17a sharded step {i + 1}", lambda: step(state, batch), "flash_attention"))
        (want, ref_metrics), ref_wall = sync_wall(lambda: ref_step(start, batch))
        walls.append(wall)
        ref_walls.append(ref_wall)
        launches += b4
        for key in ("loss", "grad_norm"):
            got, exp = float(gather(metrics[key])), float(ref_metrics[key])
            rel = abs(got - exp) / abs(exp)
            worst[key] = max(worst[key], rel)
            if rel > SHARD_RTOL:
                raise AssertionError(f"17a step {i + 1} {key} {got} against {exp} ({rel:.3g})")
        for key, v in hold_train_state(gather(new), want, SHARD_RTOL).items():
            worst[key] = max(worst.get(key, 0.0), v)
        print(f"[17a] step {i + 1}: loss {float(ref_metrics['loss']):.6f}, grad norm "
              f"{float(ref_metrics['grad_norm']):.6f}; sharded {wall * 1e3:.1f} ms "
              f"({b4} B4 launches), unsharded {ref_wall * 1e3:.1f} ms")
        del start, want
        state = new
    print(f"[17a] {n['steps']} sharded train steps of {n['batch']} x {n['seq']} tokens (O2) == "
          f"unsharded from the same states: largest relative differences loss "
          f"{worst['loss']:.3g}, grad norm {worst['grad_norm']:.3g}, moments "
          f"{worst['moments']:.3g}, parameters {worst['params']:.3g}, of each leaf's largest "
          f"entry; rtol {SHARD_RTOL}")
    return dict(launches=launches, walls=walls, ref_walls=ref_walls, worst=worst,
                params=params)


def sharded_serve(tag: str, dev, mesh, model, plain, params, batch: int, prompt: int,
                  steps: int, atol: float, forward: bool = False) -> dict:
    """``jit_prefill_step`` on ``batch`` x ``prompt`` random tokens and
    ``steps`` ``jit_decode_step`` steps fed random tokens, each held to the
    unsharded model's at ``atol`` (with ``forward``, first the whole
    sequence's logits through ``forward_logits`` on the placed parameters);
    the MoE routes of both recorded."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(GQA_SEED + 3)
    toks = torch.randint(0, cfg.vocab, (batch, prompt + steps), generator=gen, device=dev)
    i64 = lambda *shape: torch.empty(shape, dtype=torch.int64, device="meta")
    prefill, _, p_sh, b_sh = jit_prefill_step(model, mesh, {"tokens": i64(batch, prompt)})
    cache_sds = dataclasses.replace(model, device=torch.device("meta")).empty_caches(
        batch, prompt + steps)
    decode, *_ = jit_decode_step(model, mesh, {"token": i64(batch), "pos": i64(batch)},
                                 cache_sds)
    sharded = place(params, p_sh)
    rec = dict(launches=0, walls={}, worst=0.0, routes={})
    pos = lambda t: torch.full((batch,), t, dtype=torch.int64, device=dev)

    def held(label, got, want):
        err = float((gather(got).float() - want.float()).abs().max())
        rec["worst"] = max(rec["worst"], err)
        if not err <= atol:
            raise AssertionError(f"{tag} {label}: logits differ by {err:.3g} (atol {atol})")

    for name, params_ in (("sharded", sharded), ("unsharded", params)):
        sharding = name == "sharded"
        m = model if sharding else plain
        with recorded_routes() as routes:
            outs = []
            if forward:
                def fwd():
                    if not sharding:
                        return m.forward_logits(params_, {"tokens": toks[:, :prompt]})
                    with implicit_replication():
                        return m.forward_logits(params_, place({"tokens": toks[:, :prompt]},
                                                               {"tokens": b_sh["tokens"]}))

                with torch.no_grad():
                    (logits, b4), wall = sync_wall(lambda: counted(
                        f"{tag} {name} forward", fwd, "flash_attention"))
                rec["walls"][f"{name}_forward"] = wall
                rec["launches"] += b4 if sharding else 0
                outs.append(gather(logits))
                del logits
            run_prefill = ((lambda: prefill(params_, {"tokens": toks[:, :prompt]}, prompt + steps))
                           if sharding else
                           (lambda: m.prefill(params_, {"tokens": toks[:, :prompt]},
                                              cache_len=prompt + steps)))
            ((logits, caches), b4), wall = sync_wall(lambda: counted(
                f"{tag} {name} prefill", run_prefill, "flash_attention"))
            rec["walls"][f"{name}_prefill"] = wall
            rec["launches"] += b4 if sharding else 0
            outs.append(gather(logits))
            step_walls = []
            for t in range(steps):
                b = {"token": toks[:, prompt + t], "pos": pos(prompt + t)}
                if sharding:
                    (logits, caches), wall = sync_wall(lambda: decode(params_, caches, b))
                else:
                    (logits, caches), wall = sync_wall(lambda: m.decode_step(params_, caches, b))
                step_walls.append(wall)
                outs.append(gather(logits))
            rec["walls"][f"{name}_decode"] = step_walls
            rec["routes"][name] = [r[0].cpu() for r in routes]
            rec[name] = outs
            del caches
    labels = (["forward"] if forward else []) + ["prefill"] + [f"step {t + 1}"
                                                               for t in range(steps)]
    for label, got, want in zip(labels, rec.pop("sharded"), rec.pop("unsharded")):
        held(label, got, want)
    w = rec["walls"]
    print(f"[{tag}] prefill {batch} x {prompt}: sharded {w['sharded_prefill'] * 1e3:.1f} ms, "
          f"unsharded {w['unsharded_prefill'] * 1e3:.1f} ms; decode step (median of {steps}): "
          f"sharded {np.median(w['sharded_decode']) * 1e3:.1f} ms, unsharded "
          f"{np.median(w['unsharded_decode']) * 1e3:.1f} ms; each sharded step's wall (ms): "
          f"{[round(x * 1e3, 1) for x in w['sharded_decode']]}")
    if forward:
        print(f"[{tag}] forward {batch} x {prompt}: sharded {w['sharded_forward'] * 1e3:.1f} ms, "
              f"unsharded {w['unsharded_forward'] * 1e3:.1f} ms")
    print(f"[{tag}] {len(labels)} outputs == unsharded, largest |difference| "
          f"{rec['worst']:.3g} (atol {atol}); {rec['launches']} B4 launches sharded")
    return rec


def phase_sharded(dev) -> dict:
    """Phase 17: the multi-device layer on the card's world-1 NCCL (1, 1)
    mesh: 17a sharded train steps, 17b sharded serving of SmolLM-135M, 17c
    Qwen3-MoE's expert-parallel island; every B4 call held as it is made."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_local_mesh(dev)
    print(f"[17] mesh {tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)} on {mesh.device_type}, "
          f"backend {dist.get_backend()}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}")
    result = {}
    try:
        with held_flash() as held:
            train = sharded_train(dev, mesh)
            cfg = get_config("smollm-135m")
            n = SHARD_SERVE
            serve_rec = sharded_serve(
                "17b", dev, mesh,
                build_model(cfg, mesh, dtype=torch.float32, remat="none", opt="O3", device=dev),
                build_model(cfg, None, dtype=torch.float32, remat="none", opt="O3", device=dev),
                train.pop("params"), n["batch"], n["prompt"], n["steps"], SHARD_ATOL)
            torch.cuda.empty_cache()
            full_cfg = get_config(SHARD_MOE)
            cfg = dataclasses.replace(full_cfg, n_layers=GQA_DEPTH[SHARD_MOE])
            model = build_model(cfg, mesh, dtype=torch.float32, remat="none", opt="O3",
                                device=dev)
            if model.ep is None:
                raise AssertionError("17c: the MoE model on the mesh has no EP island")
            plain = build_model(cfg, None, dtype=torch.float32, remat="none", opt="O3",
                                device=dev)
            params = plain.init(torch.Generator(device=dev).manual_seed(GQA_SEED))
            ep0 = moe._expert_compute.host_syncs
            moe_rec = sharded_serve("17c", dev, mesh, model, plain, params, GQA_BATCH,
                                    GQA_PREFILL, GQA_DECODE, SHARD_MOE_ATOL, forward=True)
            del params
            routes = moe_rec.pop("routes")
            if len(routes["sharded"]) != len(routes["unsharded"]):
                raise AssertionError(f"17c: {len(routes['sharded'])} routing calls sharded, "
                                     f"{len(routes['unsharded'])} unsharded")
            differ = sum(int((torch.sort(a, -1)[0] != torch.sort(b, -1)[0]).any(-1).sum())
                         for a, b in zip(routes["sharded"], routes["unsharded"]))
            tokens = sum(r.shape[0] for r in routes["sharded"])
            path = lambda t: f"t_local * top_k = {t * cfg.moe.top_k}: the " + (
                "tiny path" if t * cfg.moe.top_k <= 4096 else "ZeRO path")
            print(f"[17c] {SHARD_MOE}: {cfg.n_layers} of {full_cfg.n_layers} layers on the EP "
                  f"island (forward and prefill {path(GQA_BATCH * GQA_PREFILL)}; decode "
                  f"{path(GQA_BATCH)}); "
                  f"{len(routes['sharded'])} routing calls, {differ} of {tokens} tokens' top-"
                  f"{cfg.moe.top_k} sets differ; {moe._expert_compute.host_syncs - ep0} host "
                  f"syncs")
            if differ:
                raise AssertionError(f"17c: {differ} top-k sets differ from the local path")
        result = dict(train=train, serve=serve_rec, moe=moe_rec, held_calls=held["calls"],
                      max_abs_err=held["max_abs_err"],
                      launches=train["launches"] + serve_rec["launches"] + moe_rec["launches"])
        print(f"[17] {held['calls']} B4 calls held to the plain twin as made, max_abs_err "
              f"{held['max_abs_err']:.3g}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB")
    finally:
        dist.destroy_process_group()
    print(f"[17] phase 17 wall {time.perf_counter() - t0:.3f} s")
    return result


# ---------------------------------------------------------------------------
# Phase 18: the dry-run and the roofline; a fleet's seeds and the rollout
# lanes over two devices.
# ---------------------------------------------------------------------------


def start_dryruns() -> dict:
    """18a's and 18b's dry-runs, started before phase 13, one
    ``python -m repro_torch.launch.dryrun`` process each (its own fake
    world: the script's NCCL world cannot host one), with no card visible:
    the dry-run runs on fake tensors and launches nothing. Each writes its
    records to ``build/dryrun_18*.json`` and its lines to a log there."""
    import atexit

    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"), CUDA_VISIBLE_DEVICES="")
    n = DRYRUN_18B
    args = {"18a": DRYRUN_18A, **DRYRUN_18A_REPAIRED,
            "18b": ["--arch", n["arch"], "--shape", f"train:{n['batch']}x{n['seq']}",
                    "--mesh", "1x1", "--opt", n["opt"]]}
    started = {}
    for tag, extra in args.items():
        out, log = root / "build" / f"dryrun_{tag}.json", root / "build" / f"dryrun_{tag}.log"
        out.unlink(missing_ok=True)
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *extra,
                                 "--out", str(out)], cwd=root, env=env,
                                stdout=log.open("w"), stderr=subprocess.STDOUT)
        atexit.register(proc.kill)  # no process outlives the script
        started[tag] = (proc, out, log, time.perf_counter())
    return started


def dryrun_records(tag: str, started: dict) -> list:
    """A started dry-run's records, once it has exited; its lines printed.
    Fails on a failed process or any record not ``ok``."""
    proc, out, log, t0 = started[tag]
    rc = proc.wait()
    print(log.read_text(), end="")
    print(f"[{tag}] dry-run process exit {rc}, {time.perf_counter() - t0:.1f} s after its start")
    records = json.loads(out.read_text()) if out.exists() else []
    for rec in records:
        if rec["status"] != "ok":
            print(rec.get("trace", ""))
            raise AssertionError(f"{tag}: {rec['arch']} x {rec['shape']} {rec['status']}: "
                                 f"{rec.get('error', rec.get('reason'))}")
    if rc != 0 or not records:
        raise AssertionError(f"{tag}: the dry-run failed (exit {rc}); see {log}")
    for rec in records:
        head = (f"[{tag}] {rec['arch']} x {rec['shape']} x {rec['mesh']} x {rec['opt']}: "
                f"{rec['per_device_bytes'] / 1e9:.3f} GB a card (fits 80 GB: "
                f"{rec['fits_h100_80g']}); ")
        if "roofline" not in rec:  # the multi-pod mesh: the raw count's terms
            raw = dict(rec["raw"], intra_node_axes=tuple(rec["raw"]["intra_node_axes"]))
            r = CellCosts(**raw).roofline(512 if rec["mesh"] == "multi" else 256)
            print(head + f"raw count, no corrections (as the reference's multi-pod records): "
                  f"compute {r['compute_s']:.6g} s, memory {r['memory_s']:.6g} s, collective "
                  f"{r['collective_s']:.6g} s -> {r['dominant']}, bound "
                  f"{r['bound_step_s']:.6g} s; {rec['raw']['flops']:.6g} FLOP a card; counted "
                  f"in {rec['compile_s']} s")
            continue
        r = rec["roofline"]
        print(head + f"compute {r['compute_s']:.6g} s, memory "
              f"{r['memory_s']:.6g} s (pre-fusion {r['memory_prefusion_s']:.6g}), collective "
              f"{r['collective_s']:.6g} s -> {r['dominant']}, bound {r['bound_step_s']:.6g} s; "
              f"{rec['raw']['flops']:.6g} FLOP a card, MoE excess of the reference's CPU "
              f"product {rec['moe_cpu_excess_flops']:.6g} (recorded, not subtracted), B4 I/O "
              f"{rec['flash_io_bytes']:.6g} B; roofline fraction "
              f"{rec['roofline_fraction']:.4%}; counted in {rec['wall_s']} s")
    return records


def roofline_check(dev, rec: dict) -> dict:
    """18b: DRYRUN_18B's train step run for real on the card's (1, 1) mesh,
    beside its dry-run: the estimate of bytes a card against
    ``max_memory_allocated``, the bound against the measured wall (the
    gate: a bound above a measured time means the count or the peaks are
    wrong), and the wall's share of the model FLOPs at peak (MFU)."""
    n = DRYRUN_18B
    cfg = get_config(n["arch"])
    mesh = make_local_mesh(dev)
    model = build_model(cfg, mesh, dtype=torch.bfloat16, remat="dots", opt=n["opt"],
                        device=dev)
    opt = AdamW(lr=1e-4)
    shape = ShapeConfig(rec["shape"], n["seq"], n["batch"], "train")
    step, _, state_sh, _ = jit_train_step(model, opt, mesh, batch_specs_for(cfg, shape))
    params = model.init(torch.Generator(device=dev).manual_seed(GRAD_SEED))
    state = place(TrainState(params, opt.init(params)), state_sh)
    del params
    gen = torch.Generator(device=dev).manual_seed(GRAD_SEED + 18)
    batch = lambda: {"tokens": torch.randint(0, cfg.vocab, (n["batch"], n["seq"]),
                                             generator=gen, device=dev, dtype=torch.int32)}
    walls, launches, losses = [], 0, []
    # bfloat16: phase 2c's bf16 atol, and one rounding of outputs above 4
    with held_flash(atol=3e-2, rtol=2.0**-7) as held:
        state, _ = step(state, batch())  # DTensor's first call of each op and shape
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(n["steps"]):
            b = batch()
            ((state, metrics), b4), wall = sync_wall(lambda: counted(
                f"18b train step {i + 1}", lambda: step(state, b), "flash_attention"))
            walls.append(wall)
            launches += b4
            losses.append(float(gather(metrics["loss"])))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"18b: losses {losses}")
    wall = float(np.median(walls))
    r = rec["roofline"]
    bound, chips = r["bound_step_s"], 1
    mfu = rec["model_flops"] / chips / PEAK_FLOPS / wall
    est = rec["per_device_bytes"]
    print(f"[18b] {n['arch']} bfloat16 {n['opt']} train step {n['batch']} x {n['seq']} on the "
          f"(1, 1) mesh: walls {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms (median "
          f"{wall * 1e3:.1f}), losses {', '.join(f'{x:.4f}' for x in losses)}, {launches} B4 "
          f"launches, {held['calls']} B4 calls held (largest difference over 2^-7 x |twin|: "
          f"{held['max_abs_err']:.3g}, atol 3e-2)")
    print(f"[18b] bytes a card: dry-run estimate {est / 1e9:.3f} GB, measured "
          f"max_memory_allocated {peak / 1e9:.3f} GB: estimate / measured "
          f"{est / peak:.3f}")
    print(f"[18b] bound {bound * 1e3:.3f} ms ({r['dominant']}: compute "
          f"{r['compute_s'] * 1e3:.3f}, memory {r['memory_s'] * 1e3:.3f}, collective "
          f"{r['collective_s'] * 1e3:.3f} ms) against the measured wall {wall * 1e3:.1f} ms: "
          f"bound / wall {bound / wall:.4f}; mfu {mfu:.4%} (model FLOPs "
          f"{rec['model_flops']:.4g} at {PEAK_FLOPS / 1e12:.1f} TFLOP/s), roofline_fraction "
          f"{rec['roofline_fraction']:.4%}")
    if not bound <= wall:
        raise AssertionError(f"18b: the bound {bound} s exceeds the measured wall {wall} s")
    return dict(launches=launches, max_abs_err=held["max_abs_err"], wall=wall, bound=bound,
                est=est, peak=peak, mfu=mfu)


def fleets_equal(got, want, label: str) -> None:
    for field in ("latency", "file_id", "site_id", "node_busy", "hit", "hit_count"):
        g, w = getattr(got, field), getattr(want, field)
        if (g is None) != (w is None) or (g is not None and not torch.equal(g, w)):
            raise AssertionError(f"{label}: {field} differs from the one-device fleet")
    for part in ("stream", "windows"):
        g, w = getattr(got, part), getattr(want, part)
        if (g is None) != (w is None) or (g is not None and not all(
                torch.equal(a, b) for a, b in zip(g, w))):
            raise AssertionError(f"{label}: {part} differs from the one-device fleet")


def fleet_shard(dev, sol) -> tuple[int, float]:
    """18c: phase 4's plan simulated by an odd seed count over
    [cuda:0, cuda:0] (``simulator._simulate_fleet_on``: the seeds padded to
    a multiple of 2, one B1 launch a device; streaming, one a device and
    chunk, each device's queue state carried), bitwise per seed to the
    one-device fleet from the same generator seed; every B1 call held."""
    cluster = tahoe_testbed(device=dev)
    lam, _, chunk = paper_catalog(1000, device=dev)
    eff_chunk = float(np.average(chunk, weights=lam.cpu().numpy()))
    fabric = GeoFabric.single_site(cluster)
    n = FLEET_SHARD
    gen = lambda: torch.Generator(device=dev).manual_seed(18)
    launches, calls = 0, []
    for label, kw, size, per_run in (
            ("materialized", {}, n["n_requests"], 2),
            (f"streaming, {n['n_chunks']} chunks",
             dict(stream=True, n_chunks=n["n_chunks"], keep_latency=True), n["stream_requests"],
             2 * n["n_chunks"])):
        args = (sol.pi, lam[None], fabric, eff_chunk, size, n["n_seeds"])
        with recorded(simulator, "fcfs_scan") as c:
            (one, l1), w1 = sync_wall(lambda: counted(
                f"18c one-device fleet ({label})",
                lambda: simulate_fleet(gen(), *args, devices="never", **kw)))
            (two, l2), w2 = sync_wall(lambda: counted(
                f"18c fleet over two devices ({label})",
                lambda: simulator._simulate_fleet_on([dev, dev], gen(), *args, **kw),
                least=per_run))
        fleets_equal(two, one, f"18c {label}")
        if l2 != per_run:
            raise AssertionError(f"18c {label}: {l2} B1 launches, expected {per_run}")
        launches += l1 + l2
        calls += c
        rows = sorted({tuple(call[0][0].shape) for call in c})
        print(f"[18c] {label}: {n['n_seeds']} seeds x {size} requests over [cuda:0, cuda:0] "
              f"(padded to {n['n_seeds'] + n['n_seeds'] % 2}) == one device, bitwise per "
              f"seed (mean {float(one.mean_latency()):.4f} s); B1 launches {l2} sharded, {l1} "
              f"one device, at {rows}; walls {w2 * 1e3:.1f} / {w1 * 1e3:.1f} ms")
    return launches, hold_grouped(calls, "18c", dev)


def rollout_lanes(dev) -> tuple[int, float]:
    """18d: ``batched_rollout_scores``' lanes over [cuda:0, cuda:0]
    (``router._batched_rollout_scores_on``) at replan_wall's shapes, held
    to the one-device program: scores bitwise, ``best`` equal, one B1
    launch a device; every B1 call held."""
    cl = tahoe_testbed(device=dev)
    r, chunk = len(WALL_LAM), WALL_FILE_MB / WALL_K
    d, rates = cl.service_params(chunk)
    lam = on_card(WALL_LAM, dev)
    avail = torch.ones(NODES, dtype=torch.bool, device=dev)
    carry = init_carry(NODES, device=dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    launches, calls = 0, []
    for n_cand, n_draws in LANE_CASES:
        pi = torch.stack([project_capped_simplex(
            torch.rand((r, NODES), generator=gen, device=dev),
            torch.full((r,), WALL_K, device=dev)) for _ in range(n_cand)])
        cost = torch.rand((n_cand,), generator=gen, device=dev)
        draws = segment_draws(gen, lam[None], WALL_REQUESTS, NODES, n_draws)
        kw = dict(n_clients=r, n_requests=WALL_REQUESTS, rollout_seeds=n_draws, draws=draws)
        args = (carry, None, pi, lam, d, rates, avail, cost, None)
        with recorded(simulator, "fcfs_scan") as c:
            (want, want_best), l1 = counted(
                f"18d one device {n_cand}x{n_draws}",
                lambda: batched_rollout_scores(*args, devices="never", **kw))
            (got, best), l2 = counted(
                f"18d lanes over two devices {n_cand}x{n_draws}",
                lambda: router_mod._batched_rollout_scores_on([dev, dev], *args, **kw), least=2)
        pad = router_mod._lane_pad(n_cand, n_draws, 2)
        if not (torch.equal(got[:n_cand], want[:n_cand]) and int(best) == int(want_best)
                and bool(torch.isinf(got[n_cand:]).all()) and l2 == 2 and l1 == 1):
            raise AssertionError(f"18d {n_cand}x{n_draws}: scores, best ({int(best)} against "
                                 f"{int(want_best)}) or launches ({l2}) differ")
        launches += l1 + l2
        calls += c
        print(f"[18d] {n_cand} candidates x {n_draws} draw(s) x {WALL_REQUESTS} requests: "
              f"lanes padded to {pad} x {n_draws} over [cuda:0, cuda:0], B1 at "
              f"{[tuple(call[0][1].shape) for call in c[1:]]}: scores bitwise the one-device "
              f"program's, best {int(best)}")
    return launches, hold_grouped(calls, "18d", dev)


def phase_dryrun(dev, started: dict, sol) -> dict:
    """Phase 18: 18a and 18b's dry-runs collected, 18b's cell run for real,
    18c's fleet and 18d's lanes over two devices."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    for tag in ("18a", *DRYRUN_18A_REPAIRED):
        dryrun_records(tag, started)
    (rec,) = dryrun_records("18b", started)
    torch.cuda.empty_cache()
    try:
        check = roofline_check(dev, rec)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    fleet_launches, fleet_err = fleet_shard(dev, sol)
    lane_launches, lane_err = rollout_lanes(dev)
    print(f"[18] phase 18 wall {time.perf_counter() - t0:.3f} s (the dry-runs ran beside "
          f"phases 13 to 17)")
    return dict(check=check, fleet_launches=fleet_launches, lane_launches=lane_launches,
                err=max(fleet_err, lane_err))


def main() -> int:
    t_start = time.perf_counter()
    sys.stdout.reconfigure(line_buffering=True)  # keep output if the run is cut
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    probes, card = phase_build()
    limits = phase_limits(dev, probes)
    worst = phase_kernel_vs_plain(dev)
    phase_gf256_vs_plain(dev, limits)
    flash_err = phase_flash_vs_plain(dev)
    quick_launches, quick_err = phase_quickstart(dev)
    fleet_launches, record, sol, ks = phase_catalog(dev, limits)
    figure_launches, figure_err = phase_figures(dev, probes)
    plane = phase_data_plane(dev, sol, ks, limits)
    serve_launches, flash = phase_serve(dev, limits)
    t7 = time.perf_counter()
    hier_launches, hier_calls, hier = phase_hierarchical(dev)
    tenant_launches, tenant_err = phase_tenant(dev)
    geo_launches, geo_calls, geo_pi, geo_mean = phase_geo(dev)
    # 7a's and 7c's fleets share (N, m): one plain-twin run holds both
    fleets_err = hold_stacked(hier_calls + geo_calls, "7", "7a and 7c fleets", dev)
    del hier_calls, geo_calls
    print(f"[7] phase 7 wall {time.perf_counter() - t7:.3f} s")
    closed_by_path, closed_err, chunk, loop = phase_closed_loop(dev, sol, geo_pi, geo_mean, limits)
    scenarios = start_scenarios(dev)
    control_by_path, control_err = phase_control_plane(dev, geo_pi, loop)
    del loop
    scenario_by_path, scenario_err = phase_scenarios(scenarios)
    ckpt = phase_checkpoint(dev, limits)
    t12 = time.perf_counter()
    training = phase_train(dev, limits)
    grad = phase_grad(dev)
    print(f"[12] phase 12 wall {time.perf_counter() - t12:.3f} s")
    dryruns = start_dryruns()  # beside phases 13 to 17, after 12a's host-bound steps
    gqa = phase_gqa(dev, limits)
    late = phase_encdec_rwkv(dev, limits)
    mla = phase_mla(dev, limits)
    rg = phase_recurrentgemma(dev, limits)
    sharded = phase_sharded(dev)
    roof = phase_dryrun(dev, dryruns, sol)
    by_path = {"quickstart_simulate": quick_launches,
               "catalog_simulate_fleet": fleet_launches,
               "figures_simulate": figure_launches,
               "hierarchical_simulate_fleet": hier_launches,
               "tenant_simulate": tenant_launches,
               "geo_simulate_fleet": geo_launches,
               **closed_by_path,
               **control_by_path,
               **scenario_by_path,
               "fleet_two_devices": roof["fleet_launches"],
               "rollout_lanes_two_devices": roof["lane_launches"]}
    kernels = [{
        "name": "fcfs_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fcfs_queue.cu",
        "replaces": "src/repro/kernels/fcfs_queue.py:108",
        "parity": "bitwise",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(worst, quick_err, record["max_abs_err"], figure_err,
                           tenant_err, fleets_err, closed_err, control_err, scenario_err,
                           roof["err"]),
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": record["bound_by"],
        "ms_hierarchical_fleet": hier["ms"],  # phase 7a's (64, 100 000, 12)
        "bound_ms_hierarchical_fleet": hier["bound_ms"],
        "ms_stream_chunk": chunk["ms"],  # phase 8e's (64, 100 000, 12), carried state
        "bound_ms_stream_chunk": chunk["bound_ms"],
        "library_ms": None,
    }]
    for name, replaces, path in [
        ("gf256_matmul", "src/repro/kernels/gf256_matmul.py:106", "data_plane_encode_batch"),
        ("gf256_matmul_batched", "src/repro/kernels/gf256_matmul.py:168",
         "data_plane_decode_requests"),
    ]:
        launches, rec = plane[name]
        paths = {path: launches}
        if name == "gf256_matmul":  # phases 11 and 12a's encodes and degraded decodes
            paths.update(checkpoint_save=ckpt["save"][0], checkpoint_restore=ckpt["restore"][0],
                         train_save=training["save"][0], train_restore=training["restore"][0])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gf256_matmul.cu",
            "replaces": replaces,
            "parity": "bitwise",
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": None,  # no PyTorch call computes a GF(256) product
        })
        if name == "gf256_matmul":  # the largest checkpoint encodes, on their own inputs
            kernels[-1].update(ms_checkpoint_save=ckpt["save"][1]["ms"],
                               bound_ms_checkpoint_save=ckpt["save"][1]["bound_ms"],
                               ms_train_save=training["save"][1]["ms"],
                               bound_ms_train_save=training["save"][1]["bound_ms"],
                               ms_train_restore=training["restore"][1]["ms"],
                               bound_ms_train_restore=training["restore"][1]["bound_ms"])
    flash_paths = {"serve_prefill": serve_launches,
                   "train_grad_O2": grad["launches"]["O2"],
                   "train_grad_O3": grad["launches"]["O3"],
                   "phi4_serve_prefill": gqa["launches"],
                   **{f"{arch}_forward_prefill": run["launches"]
                      for arch, run in gqa["models"].items()},
                   "seamless-m4t-medium_forward_prefill": late["encdec"]["launches"],
                   f"{MLA_ARCH}_forward_prefill": mla["launches"],
                   f"{RG_ARCH}_serve_prefill": rg["serve_launches"],
                   f"{RG_ARCH}_forward_prefill": rg["launches"],
                   "sharded_train_O2": sharded["train"]["launches"],
                   "sharded_prefill_O3": sharded["serve"]["launches"],
                   f"{SHARD_MOE}_ep_forward_prefill": sharded["moe"]["launches"],
                   "dryrun_check_train_bf16_O2": roof["check"]["launches"]}
    phi4, encdec, qk192 = gqa["record"], late["encdec"]["record"], mla["record"]
    hd256 = rg["record"]
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "parity": "atol 2e-5",
        "launches": sum(flash_paths.values()),
        "launches_by_path": flash_paths,
        "max_abs_err": max(flash_err, flash["max_abs_err"], grad["record"]["max_abs_err"],
                           phi4["max_abs_err"], encdec["max_abs_err"], qk192["max_abs_err"],
                           rg["serve_max_abs_err"], hd256["max_abs_err"], sharded["max_abs_err"],
                           *(run["max_abs_err"] for run in gqa["models"].values())),
        # phase 18b's bfloat16 calls, held within 3e-2 + 2^-7 x |twin|: the
        # largest difference over 2^-7 x |twin|
        "max_err_over_rtol_bf16": roof["check"]["max_abs_err"],
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "bound_tf32_ms": flash["bound_tf32_ms"],
        "bound_fp32_ms": flash["bound_fp32_ms"],
        "bound_bytes_ms": flash["bound_bytes_ms"],
        "library_ms": flash["library_ms"],  # scaled_dot_product_attention, timed only
        # phase 12b's (2, 2048, 9, 3, 64): the forward under autograd, and the
        # Function's backward in torch ops (no kernel: the reference has none)
        "ms_train_forward": grad["record"]["ms"],
        "bound_ms_train_forward": grad["record"]["bound_ms"],
        "library_ms_train_forward": grad["record"]["library_ms"],
        "ms_backward": grad["record"]["backward_ms"],
        "bound_ms_backward": grad["record"]["backward_bound_ms"],
        "library_ms_forward_backward": grad["record"]["library_fwd_bwd_ms"],
        # phase 13a's hd = 128 float32 instance at Phi-4-mini's (4, 2016, 24, 8, 128)
        "ms_hd128": phi4["ms"],
        "plain_ms_hd128": phi4["plain_ms"],
        "bound_ms_hd128": phi4["bound_ms"],
        "bound_by_hd128": phi4["bound_by"],
        "library_ms_hd128": phi4["library_ms"],
        # phase 14a's hd = 64 at G = 1, SeamlessM4T's decoder prefill (2, 2016, 16, 16, 64)
        "ms_hd64_g1": encdec["ms"],
        "plain_ms_hd64_g1": encdec["plain_ms"],
        "bound_ms_hd64_g1": encdec["bound_ms"],
        "bound_by_hd64_g1": encdec["bound_by"],
        "library_ms_hd64_g1": encdec["library_ms"],
        # phase 15's q/k width 192, v width 128 at DeepSeek-V3's MLA prefill
        # (2, 2016, 128, 128, 192 / 128)
        "ms_qk192_v128": qk192["ms"],
        "plain_ms_qk192_v128": qk192["plain_ms"],
        "bound_ms_qk192_v128": qk192["bound_ms"],
        "bound_by_qk192_v128": qk192["bound_by"],
        "library_ms_qk192_v128": qk192["library_ms"],
        # phase 16b's head width 256 at RecurrentGemma's forward (2, 4096, 10, 1,
        # 256), window 2048; the library call is SDPA with a boolean window mask
        "ms_hd256": hd256["ms"],
        "plain_ms_hd256": hd256["plain_ms"],
        "bound_ms_hd256": hd256["bound_ms"],
        "bound_by_hd256": hd256["bound_by"],
        "library_ms_hd256": hd256["library_ms"],
    })
    walls_17a = sharded["train"]["walls"]
    earlier = EARLIER_WALLS
    print(f"[walls] {card}: 12a phase {training['wall']:.1f} s (median step "
          f"{training['step_ms']:.1f} ms; earlier runs F3 {earlier['phase_12a_s'][0]} s, F4 "
          f"{earlier['phase_12a_s'][1]} s); 17a sharded steps "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls_17a)} ms, unsharded "
          f"{', '.join(f'{w * 1e3:.1f}' for w in sharded['train']['ref_walls'])} ms (no "
          f"earlier wall kept); 18b median step {roof['check']['wall'] * 1e3:.1f} ms (earlier "
          f"runs F3 {earlier['step_18b_ms'][0]} ms, F4 {earlier['step_18b_ms'][1]} ms)")
    print(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(card)  # again, so that the end of the output names the card
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
