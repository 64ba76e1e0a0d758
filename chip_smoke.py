"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two serving paths (the int8 continuous-batching
server ``mpistragglers_jl_tpu_torch.models.serving.ServingScheduler``
on the slot ring and on the paged cache) at the full width of the
widest model the repo serves, its training path (the single-device
train step of ``models/transformer.py`` over flash attention) at the
full width of ``benchmarks/transformer_train_bench.py``, its
long-context generation (``models/decode.py`` ``generate_dense``) and
speculative decoding (``models/speculative.py``) at the width of that
file's decode rungs, the attribution bench of the decode kernel
(``bench/decode_kernel_attrib.py``), the pool on CUDA streams with
BASELINE configs 2-5, the mixture of experts (``models/moe.py``:
training at ``benchmarks/moe_bench.py``'s width, generation),
gradient-coded transformer training over the pool
(``models/coded_train.py``), and sampled, instrumented serving on both
caches (``utils/prng.py``, ``ops/sampling.py``, ``obs/``), training
checkpoints and their resume, the pool simulator (``sim/``) and
multi-tenant QoS admission (``qos/``) on the paged server, page-state migration between paged schedulers and the
fleet prefix cache (``models/disagg.py``, ``cache/``), fused K-epoch
device windows and the single-controller mesh plane (``parallel/``), the
sharded transformer over that mesh (ring and Ulysses attention), its
experts over ``ep`` and the pipeline (GPipe, circular, 1F1B with MoE
stages), sharded inference over that mesh (prefill, decode, extend,
generation, the ring, speculation, the serving tick) and the multi-device
dry run, and holds every CUDA kernel of those paths against its plain
PyTorch version:

1. card name and power limit;
2. build the kernels from the sources in this checkout, one ``nvcc``
   per source, all started together (``_build.build``): the decode
   kernels, the flash kernels and the sampling kernel;
3. K5 (split-K: a split kernel and its combine) against its plain
   version at the serving shape (8 splits of 128 keys), bf16 and f32,
   ring (warm-up, W - 1, W, wrapped) and positional (with and without
   window) masks, GQA groups 1, 4 and 8;
4. slot-ring serving parity in f32 at full width: ~10 requests through
   the scheduler on the kernel route, then on the einsum route
   (``use_decode_kernel(False)``); greedy streams must be identical,
   equal the ``generate_ring_dense`` oracle, and K5 must launch
   ``n_layers * n_inner * decode ticks`` times on the first run and
   never on the second;
5. slot-ring main path: serving in bf16, S=8 slots of 512-token
   prompts, ``n_inner=64``; every launch count is set to 0 just before
   and read just after; decode tokens/s, ms/step and peak memory;
6. K5 timing at the serving shape (CUDA events, caches rotated past
   the 50 MB L2; eager calls, as its first design was timed, and
   replays of a CUDA graph) beside its first design's time (PERF.md),
   its byte bound, the plain version and one
   ``F.scaled_dot_product_attention`` call over the dequantised cache
   (a yardstick only: the port never calls it);
7. K6 (the paged kernel: K5's split kernel and combine over
   ``paged_split_plan``'s chunks, more than one split in every case)
   against its plain version: B=8, pages of 16, 64 and 24 rows, GQA
   groups 1, 4 and 8, bf16 and f32, page tables from a seeded
   permutation with shared pages and null entries past the budget of
   rows in warm-up, positions in warm-up, at W - 1, at W and wrapped;
   then one K6 call at the serving shape captured into a CUDA graph
   with its scratch allocated inside the capture: replays equal the
   eager output, and neither capture nor replays add to the counts;
8. paged serving parity in f32 at full width, kernel route against the
   gather route: ~10 requests, two of them sharing a 256-token prefix
   and wrapping past it (copy-on-write); identical streams, those two
   equal to the oracle, K6 launches counted, K5 none, the pool drained;
9. paged main path: bf16, S=8, pages of 64, 8 requests on one
   256-token system prompt; share hits, prefill chunks, decode
   tokens/s, ms/step, peak memory, launches (all counts set to 0 just
   before);
10. K6 timing at the serving shape, as phase 6, then as CUDA-graph
    replays at pages of 16 and 24 rows beside 64, and at 1 to 32 splits
    (chunks of 1024 down to 32 ring slots, through the C entry: not a
    path of the port, so not counted), each held to the plan's output;
11. the flash kernels' build report (registers and spills per kernel);
12. K1-K4 against their plain versions: bf16 (on the tensor cores) and
    f32, (B, L, H, Hkv, D) in (2, 512, 8, 8, 128), (2, 384, 8, 2, 128),
    (1, 300, 4, 1, 64), causal or not, window None or 128;
13. training parity in f32 at full width, batch 2: the loss and every
    gradient with ``attn_impl="flash"`` against ``"reference"``;
14. training main path: bf16, batch 8, sequence 2048, one warm-up and
    5 timed SGD steps; every launch count set to 0 just before and read
    just after; ms/step, tokens/s, model TFLOP/s, MFU against a raw
    bf16 matmul chain, peak memory; before it, the first step's loss
    and attention-projection gradients against the reference
    attention's, with two broken attentions as controls; after it,
    each parameter's change over the six steps against its change over
    the same steps with the reference attention, with two broken
    attentions' changes as controls;
15. the fused backward (K4) at the same width, one step's gradients
    against the split backward's (the share of the limit printed),
    launches counted (set to 0 before);
16. K1-K4 at the bench shape, the main path's (bf16, B=8, L=2048, H=8,
    D=128, causal): against their plain versions as in phase 12, K4
    also in f32, with a control that must break the limit (K2's and
    K3's gradients from P and dS in bf16 alone, plain torch on the same
    inputs), then timed beside their first designs' times, their
    bounds and the tensor work their hi/lo products issue, the plain
    versions and ``F.scaled_dot_product_attention`` forward and
    backward (a yardstick only: the port never calls it);
17. K7 (the attribution variants dma, dot, dequant, full_nosm) and K5
    in positional mode against their plain versions on K5's split
    grid: bf16 and f32, (B, L, block_k) in (1, 16384, 4096), (4, 16384,
    4096), (2, 1024, 256), (4, 1000, 160) (a short last chunk); K5 also
    at positions that leave whole chunks empty and with a window whose
    lower edge cuts a chunk; then one K5 call captured into a CUDA graph
    with its scratch allocated inside the capture: replays equal the
    eager output, and neither capture nor replays add to the counts;
18. long-context generation parity in f32 at the decode rung's full
    width (``generate_dense``, B=4, prompt 2048, n_new 32): int8 streams
    identical on the kernel route (AUTO at B=4) and the einsum route,
    K5 launched 8 x 31 and 0 times; the f32-cache stream equal to the
    argmax of ``forward_dense`` teacher-forced on prompt + stream, with
    the reference attention (not K1);
19. the long-context main path at ``bench_decode``'s shape (bf16, B=1,
    prompt 16384): first K1 against its plain version at the prefill
    shapes of this phase and phase 21 (B=1, L=16384 and 2048, H=8 over
    Hkv=2, D=128, causal), timed there beside SDPA's forward with GQA;
    then prefill alone (K1 = 8 launches), decode
    ms/token by slope (n_new 128 -> 256, after a warm-up run) for the
    bf16 cache, int8 AUTO (K5 = 0) and int8 with K5 forced (K5 = 8 x
    (n_new - 1)), then int8 AUTO at B=4 (K5 = 8 x 127 in the 128-token
    run); counts set to 0 just before each run;
20. the port's attribution bench (``bench/decode_kernel_attrib.py``):
    every K7 variant and K5 at B=1, L=16384 as CUDA-graph chains, then
    K5 at B=4 and 8, each at or above its byte bound and beside its
    first design's time; K7's plain version and SDPA over the
    dequantised cache (B=1, 4, 8) timed beside it; the launch counts
    hold the eager calls, not the graph replays;
21. speculative decoding: in f32 both drafters' streams equal
    ``generate_dense``'s (prompt 512, n_new 64); in bf16 at
    ``bench_spec_decode``'s shape (prompt 2048, n_new 256, k 4) the
    reference's keys for both drafters;
22. the pool on CUDA streams (``pool.py`` over ``backends/cuda.py``): a
    kmap2-style run, 8 workers, 100 epochs, ``nwait=6``, workers 3 and 6
    slowed by ``delay_fn``: every result on the card echoes its epoch,
    the stale workers are re-tasked; a CUDA sendbuf written right after
    ``asyncmap`` returns does not reach a worker still out; a functional
    ``nwait`` waits for a slowed worker; ``waitall`` quiesces;
23. BASELINE config 2, uncoded GEMM 4096^3 f32 over 4 workers
    (``bench/coded_gemm.py``): ms/epoch, MFU against a raw
    ``torch.matmul``, the error against it;
24. config 3, (8, 6) MDS-coded GEMM at 8192^3: ``"ready"`` and
    ``"enqueue"`` at ``"highest"`` and ``"default"`` (ms/epoch, MFU, the
    error, the products' and the decode's own times), then the per-worker
    rung with workers 2 and 5 delayed 0.5 s: every epoch returns at k
    while they are out, and ``vs_baseline`` from a ``nwait=n`` epoch;
25. config 4, LT-coded GEMM at 16384^2 over 16 workers, workers 3 and 11
    delayed 0.5 s: decoded on the device, checked against the host peel
    of the same epoch;
26. config 5, ``CodedSGD.synthetic`` at 1e6 x 1024, 16 workers, s=2,
    workers 2 and 9 delayed 0.5 s, 5 epochs: the loss falls, and one
    coded step equals the uncoded full-batch step from the same ``w``;
27. the MoE layer on the card, f32, at the main path's token count
    (T=16384, D=1024, 4 experts, d_ff 4096) at cf 1.25 and 0.5: the
    gather form against the one-hot oracle (``switch_route``) and the
    scatter-add combine; the table, experts and slots bit-equal, y and
    the gradients of x and the router within their limits (the share
    used printed), dropped rows exactly zero;
28. the MoE training main path (``bench/moe_train.py``: bf16, batch 8,
    sequence 2048, 4 experts at cf 1.25, aux 0.01, SGD lr 1e-3), after
    its first step's loss and gradients in f32 at batch 2 against the
    reference attention (phase 13's limits): through the sharded
    program on a (1, 1, 1, 1) mesh and on one device, each one warm-up
    and 5 timed steps between a reset of the counts and a read (K1-K3
    8 x 6 each, on each side); the mesh step's ms/step, tokens/s, MFU
    against activated FLOPs and peak memory, the one-device step's
    ms/step and ``routing_overhead_share`` (the mesh step's beside it)
    against the dense step timed alternately in the same process, drop
    rates at cf 1.25 and 0.5, aux at init;
    the 12-step bf16 loss trajectory printed, and the same 12 steps in
    f32 at batch 2 must fall beyond their noise;
29. MoE generation parity, f32, full width (phase 18's model with 4
    experts at cf 4, so nothing drops): as phase 18;
30. coded transformer training (``bench/coded_train.py``: n=6, s=2,
    chunks (2, 2049), workers 1 and 4 delayed 0.5 s): first 2 coded
    epochs in f32 against direct full-batch SGD, each leaf's change
    within its limit, and a broken control (one fresh worker left out of
    the decode) that must miss it; then in bf16 3 coded epochs against 3
    bulk-synchronous ones, the delayed workers out at every coded
    return, K1-K3 launched at least 8 x 3 x 4 x 3 times.

31. the sampling kernel (``ops/csrc/sampling.cu``) against its plain
    chain (``utils/prng.py``) at the serving shape (8 rows of the 32768
    vocabulary), f32 and bf16 logits, top_k None, 1 and 50: every
    entry's random bits and Gumbel noise bit-equal, the tokens equal;
    then its time in a CUDA graph of one tick's 64 calls and eagerly,
    the plain chain's time, and its bound (``bench/kernel_bounds.py``);
32. sampled slot-ring serving parity in f32 at full width (temperature
    0.8, top_k 50, a key per request, K5 routed): each stream equals
    ``generate_ring_dense`` with the request's key; the sampling kernel
    launched once per admission and once per inner step;
33. the slot-ring main path (phase 5's workload) three times in one
    process: greedy and dark, sampled and dark, sampled and
    lit (a registry, a span recorder, a flight recorder, a TraceBook and
    an ObsServer on loopback port 0): ms/tick and decode tokens/s of each over 1 timed tick,
    kernels per inner step from one profiled 4-step tick of the first
    greedy and sampled runs; counts set to 0 before each run (K5 8 x 64
    per tick, the sampling kernel 8 + 64 per tick); lit, ``/metrics``
    and ``/healthz`` scraped over HTTP between ticks, ``audit`` passing over the drained book (every request
    retired once, the token counter equal to the streams), and a merged
    Chrome trace written to a temporary directory with the scheduler's
    tick track;
34. the paged main path (phase 9's workload: pages of 64, a shared
    256-token system prompt, 28 share hits) the same three ways, K6;
35. phase 30's coded trainer (2 bf16 epochs, workers 1 and 4 delayed)
    and config 3's (8, 6)-coded GEMM at 8192^3 (3 epochs) with a
    registry, spans and an ``EpochTracer``: steps, decodes and recovered
    workers in the registry, and the merged trace carrying the pool's
    six or eight worker tracks beside the steps.
36. the rateless LT-coded GEMM (``ops/rateless.py``) at config 4's
    rateless rung (``bench/coded_family.py``: 8192^3 f32, n=12, k=8,
    the classic stream, worker 0 dead, round timeout 2 s): decoded within
    1e-3 of an f32 ``torch.matmul`` on the card, with generation-1
    shards drawn; then ``bench.py``'s systematic-against-classic
    overhead (m=2048, n=k=8, worker 3 dead, staggered 0.15-0.6 s);
37. MatDot (p=4, k=7) and polynomial (p=q=2, k=4) coded GEMM at 8192^3
    f32 over 8 stream workers, after a warm-up epoch two epochs, worker 5
    delayed 0.5 s in the second: each decode within 1e-5 x cond(V_S) of
    the f32 product;
38. the hierarchical code (4 groups of 8 stream workers, k_inner=6, A
    9216 x 8192): after a warm-up epoch 3 epochs, group 2 dead from the
    second, each decode within
    1e-5 x cond of the f32 product, its decode time beside the flat
    (32, 24) MDS decode's;
39. GF(256) Reed-Solomon on the card (``DeviceRSGF256(8, 6)``, both
    methods) over the bytes of the training model's f32 parameters:
    decode(encode(x)) with rows 0 and 3 lost equal to x, a 1 MiB slice
    equal to the numpy codec's shards, GB/s;
40. adaptive ``nwait`` over the pool on streams
    (``bench/adaptive_nwait.py``): a rotating-straggler trace recorded
    with ``EpochTracer`` (16 workers, 0.1 s, moving every 5 of 20
    epochs), replayed by ``faults.from_trace`` into config 5's
    ``CodedSGD`` under full gather and ``AdaptiveNwait(kmin=n-s)``;
    the drained pool saved and restored (``utils/checkpoint.py``) to an
    equal state;
41. hedged requests (``utils/hedge.py``) over 4 stream replicas, one
    4096^2 bf16 product per request, replica 0 stalled 50 ms: p50/p99
    at hedge 1 and 2;
42. the native host libraries, built with ``g++`` from the port's
    ``native/`` sources in threads beside phase 2's ``nvcc``: the
    transport loaded from the port's ``native/_build/``;
    ``RSGF256(8, 6)`` on its native route, byte-equal to the numpy
    route and to ``DeviceRSGF256`` over 64 MiB of the training model's
    f32 parameter bytes (decoded with rows 0 and 3 lost), GB/s; the
    native LT peel at ``bench.py:1046``'s overhead shape (m=2048, 256
    columns, k=8, f32) within 1e-5 of the numpy peel, and the card's
    peel equal to the numpy peel bit for bit;
43. the transport bench (``bench/transport.py``, spawned host workers):
    8-byte round trips over pipes and native, a 4 MiB broadcast to 4
    workers over pipes, native sockets and the shared-memory arena;
44. BASELINE config 2 over OS worker processes on the card
    (``bench/process_gemm.py``): 4 spawned workers per backend
    (``ProcessBackend`` and ``NativeProcessBackend``, each with a
    registry), every worker with its own CUDA context and its row block
    of A made from the seed; one chain of 5 epochs each, the product
    within ``REL_TOL["highest"]`` of an on-card ``torch.matmul``, equal
    across epochs; the workers' telemetry spans merged; then on the
    native backend worker 2 exits in the fifth of 10 epochs: a
    ``WorkerFailure``, ``respawn(2)``, the last epochs equal bit for
    bit; phase 23's stream epoch beside it;
45. the launcher: ``python -m mpistragglers_jl_tpu_torch.launch -n 3
    bench/launch_gemm.py``: rank 0 coordinates, ranks 1-2 multiply
    2048-row blocks of the 4096^3 f32 product on the card; exit code 0
    and the product within ``REL_TOL["highest"]`` in rank 0's line; and,
    launched beside it, a job whose rank 1 exits 3 must exit 3.
46. training resume: phase 14's model and batch (bf16, batch 8,
    sequence 2048) under ``make_optax_train_step(cfg,
    tx=adamw(3e-4))``, 6 steps straight; then 3 steps, the parameters,
    the AdamW state and a drained stream pool's ``pool.json`` saved by
    ``utils/train_checkpoint.py``, restored into fresh tensors and a
    fresh AdamW, 3 more steps (K1-K3 counted from a reset before it):
    the losses and every leaf (parameters, moments, steps) bit-equal to
    the straight run; save s, restore s, GB written;
47. that state through ``CodedCheckpoint(8, 6)`` (``utils/
    coded_checkpoint.py`` over the native RS codec): shard 0 deleted and
    shard 3 corrupted, the restore bit-equal; with shard 5 gone too,
    ``CheckpointCorrupt``; save and restore GB/s, shard bytes;
48. the pool simulator: ``bench/adaptive_nwait.py``'s trace (16 stream
    workers, full gather) dumped as JSONL, replayed by ``sim.replay``
    at the recorded nwait (every fresh set reproduced, ``compare``),
    ``sim.sweep_nwait`` over 1000 virtual epochs of it and
    ``recommend_nwait`` from a latency model fitted to it, beside phase
    40's final ``AdaptiveNwait``;
49. QoS on the paged main path (pages of 64, a 256-token system
    prompt, 16 requests): tenants gold (weight 2) and bronze (weight 1,
    16 pages) on ``qos=``; in f32 every stream equal to
    ``generate_ring_dense``, the first burst of admissions 2:1, bronze
    within its quota, retired prefix pages gone cold and reshared, the
    pool checked, K6 counted from a reset before it; then in bf16
    ms/tick with and without ``qos=`` in one ordered pair (one pair
    keeps the whole run inside its time limit), printed, not held.
50. page-state migration on the paged main path (pages of 64, S=8,
    int8): a ``PrefillWorker`` and a ``DecodeReplica`` with one
    ``MigrationPlanner``, 8 f32 requests (4 on one 256-token prefix),
    each migrated once it has its first token, alternately in process
    and through ``ticket_to_frames`` -> ``MigrationRing`` ->
    ``ticket_from_frames``: every stream equal to
    ``generate_ring_dense``, the prefix pages registered again on the
    destination (share hits), both pools drained and checked, the
    destination's ticks K6 only (counts set to 0 before); then
    ``bench/disagg.py`` in bf16: the handoff ms of each route for 8
    requests of 960 tokens (16 pages, ``migration_nbytes`` = pages x
    270,336 bytes) held to a never-migrated run, and the ring's
    one-way GB/s (16 x 4 MiB, 4 slots);
51. the fleet prefix cache: two paged schedulers on one
    ``FleetPrefixCache``, a 512-token shared prefix. DRAM route: A
    serves and retires two requests (their pages spill), A is killed,
    B fetches the 8 prefix pages (``fleet_hit`` dram) and runs fewer
    prefill chunks; peer route (no DRAM tier): B fetches from A's live
    pages; f32 streams equal the oracle, no fallbacks, B's ticks K6
    only; then in bf16 a fresh B's submit-to-first-token with the
    DRAM fetch against a cache-less prefill, 3 alternating pairs with
    each variant's spread.
52. the router (``models/router.py``) over four paged schedulers (pages
    of 64, S=8, int8, f32, TF32 off): four requests of 256 tokens (two
    on one 192-token prefix) under round_robin, least_loaded,
    prefix_affinity (the first sharer holds its first token before the
    rest arrive; the second must land on its replica with share hits)
    and hedge_p99 (replica 0 ticks once, then is gated for the phase: a
    hedge must fire and win, the loser cancelled), every stream equal
    to ``generate_ring_dense``, every pool drained; then
    ``bench/router.py``'s live half in bf16: the warm tick calibrated,
    replica 3 gated to 4x it, a closed burst for the fleet's rate, an
    open loop of 24 requests at 0.8 of it under round_robin and
    least_loaded (TTFT p50/p99, the router's
    share of the stepping wall), and a kill/recover leg with 0 dropped
    and more than 0 re-routed; K6 counted over the phase, K5 none;
53. ``two_tier``: two ``PrefillWorker`` and two ``DecodeReplica`` on one
    ``MigrationPlanner`` (f32), the same four requests: streams equal
    the oracle, migrations named ``"migrated"``, the ``disagg_*`` series
    in the registry, the decode tier's ticks K6 only;
54. the host planes (numpy, no pool): a 100k-request diurnal day over 8
    ``SimReplica`` through ``run_router_day`` and
    ``run_router_day_fast`` (one digest, requests/s each; the
    reference's 1M cut to fit seconds), ``sweep_router_policy`` at 0.8
    load with a 1.8x straggler, an elastic fleet day with a coordinator
    kill (``bench/fleet.py``, 3000 requests), and every chaos episode
    twice at half size (``bench/chaos.py``), digests printed;
55. fused K-epoch windows on the card (``parallel/device_coord.py``):
    an (8, 6) MDS, an LT and a hierarchical (3 groups of 4, k_inner 3,
    one group straggling) window in f64 with straggler schedules, two
    back-to-back windows of K=16, each a replayed CUDA graph:
    ``repochs`` bit-equal to the host loop over ``SimBackend``, every
    epoch's decode within 1e-9 of the float64 host product (the CPU
    tests' bound); then config 3's shape (8196x8192 coded at (8, 6), B
    8192x8192, ``"default"``): the host loop ("ready" and "enqueue")
    and a graph window at K=8, ms/epoch and the device's idle share
    each (``bench/device_coord.py --config3``); then that bench's
    ladder at 128 epochs: the host loop against graph and eager windows
    at K in {1, 8, 64}, the swept K and its overhead multiple (floor
    3);
56. the mesh plane on one card, eight ranks on cuda:0
    (``make_mesh(8, devices=[cuda:0] * 8)``, f32, TF32 off):
    ``MeshCodedGemm`` with two stale ranks, ``MeshMatDotGemm`` past two,
    ``PoolMeshCodedGemm`` one worker per rank and folded on
    ``make_mesh(1)``, each with workers 0 and 7 stalled 0.2 s, a mesh
    ``DeviceCoordinator`` window (f64) whose ``repochs`` equal the flat
    window's and whose blocks equal them within 1e-12, and
    ``ring_allgather`` bit-exact; each rank's map time printed (the
    ranks share one card: no collective speed is claimed).
57. the sharded transformer (``models/transformer.py`` given a ``Mesh``
    of ranks on cuda:0): in f32 at full width (2 layers, batch 2, L=2048,
    TF32 off) the sharded loss and every gradient leaf against the dense
    ``loss_and_grads`` with the reference attention (phase 13's limits),
    on (2, 2, 2) with Ulysses over the flash kernels and with ring
    attention, and GQA kv=2 Ulysses on (1, 2, 4) (kv replicated and
    sliced); a control (the tp psum dropped on rank 0) must break both
    limits; replicas bit-equal. Then the training main path in bf16
    (phase 14's model, batch and lr) on (1, 1, 1) and (2, 2, 2): 1
    warm-up and 2 timed steps between a reset of the counts and a read
    (K1-K3 each 8 layers x ranks x 3), the first loss within
    ``TRAIN_BF16_ORACLE`` of the dense reference-attention loss (the
    dropped psum and the zeroed attention as controls above it), each
    leaf's change within ``TRAIN_BF16_UPDATE`` of the dense reference
    step's (3 steps with the dp gradient sum dropped on (2, 2, 2) as the
    control above it), replicas bit-equal; ms/step, tokens/s and peak
    memory beside
    phase 14's dense ms/step. Then one fused-backward (K4) step on (2, 2,
    2) against the split step;
58. expert parallelism and the pipeline (ranks on cuda:0). (a) f32 at
    full width (batch 4, L=2048, TF32 off), phase 13's limits: the MoE
    over ``("dp", "sp", "tp", "ep")`` = (2, 1, 2, 2) at capacity factor
    4 (no drops, no aux) against the dense ``loss_and_grads``, then at
    1.25 with aux 0.01 against the dense loss of each (dp, ep) batch
    shard alone, averaged (the experts' shards swapped across ep as the
    control); GPipe and circular (v=2) dense, 4 layers, on ``("dp",
    "pp")`` = (1, 2) against the dense step; 1F1B with MoE stages on (2,
    2) against the dense loss of each microbatch alone, averaged (the
    aux cotangent dropped as the control); exact K1-K3 counts.
    (b) bf16, 8 layers, batch 8, lr 1e-3, donated, 1 warm-up and 2
    timed steps each: the MoE step on (1, 1, 1, 1) and (2, 1, 2, 2)
    (``MULTICHIP_r05.json``'s fifth leg), 1F1B MoE on (4, 2) with 2
    microbatches (its fourth leg), GPipe and circular dense on (1, 4)
    with 4 (``bench/pipeline_train.py``): exact K1-K3 counts (K4-K7 and
    the sampler 0), the first loss within ``TRAIN_BF16_ORACLE`` of its
    oracle, each leaf's change within ``TRAIN_BF16_UPDATE`` of the
    oracle steps' (the dp gradient sum dropped on (2, 1, 2, 2) as the
    control above it), replicas bit-equal, ``measure_bubble`` on the
    card against ``bubble_fraction``; ms/step, tokens/s, peak memory
    beside phase 28's one-device MoE step and phase 14's dense step;
59. sharded inference (ranks on cuda:0; ``models/decode.py``
    ``make_prefill``, ``make_decode_step``, ``make_extend``,
    ``make_generate``, ``make_ring_generate``, ``models/speculative.py``
    ``make_speculative``, ``models/serving.py`` ``make_serving_scan``,
    ``parallel/dryrun.py``). (a) f32 at the decode rung's full width, 2
    layers, TF32 off, prompts of 504 tokens (504 + 8 = 512 positions,
    a length K5's block picker takes): prefill and 4 decode steps on
    ``("dp", "tp")`` = (2, 4) (kv heads replicated and sliced) against
    ``prefill_dense`` and ``decode_step_dense``, logits within
    ``INF_F32_LOGITS`` (the tp psum dropped on one rank as the control);
    ``make_generate`` token for token against ``generate_dense``:
    greedy, int8 at B=8 (K5 routed at 4 rows a rank) and sampled;
    ``make_ring_generate`` int8 on (2, 2) against
    ``generate_ring_dense``; ``make_extend`` in 4 chunks against the
    prefill; ``make_speculative`` on (1, 4), both drafters, against
    ``generate_speculative_dense`` (tokens, forwards, every rank's
    buffer bit-equal); the int8 serving tick on (2, 2), S=8, against the
    dense per-row step; MoE ``make_generate`` on ``("dp", "ep", "tp")``
    = (2, 2, 2) at ``moe_bench.py``'s width against ``generate_dense``;
    exact K1, K5 and sampler counts per run (K2-K4, K6, K7 0). (b) bf16,
    8 layers: ``bench_decode``'s own path on (1, 1), prompt 16384, B=1,
    int8 with K5 forced (prefill s; decode ms/token by slope over 32
    steps for ``make_generate`` and, in the same run at the same cache
    length and steps, ``generate_dense``, beside phase 19's slope; the
    streams equal); ``make_generate`` int8 on (2, 4), B=8, prompt 2048,
    n_new 16; the int8 serving tick, S=8, 32 inner steps, on (2, 2),
    after a 4-step warm-up tick; ``make_speculative`` on (1, 4) at
    ``bench_spec_decode``'s prompt, its stream equal to
    ``generate_dense``'s; MoE ``make_generate`` on (2, 2, 2), 8 new, its
    tp replicas bit-equal; counts, times and peak memory (ranks share the
    card: no collective speed). (c) the port's ``dryrun_multichip(8)`` on eight ranks of
    cuda:0;
60. the mesh plane across processes (``bench/multiproc.py``): two
    processes spawned on cuda:0, each loading the kernels built above.
    Each asks for ``nccl`` first (two processes on one card: refused,
    naming ``backend="gloo"``), then joins the job over ``gloo`` and
    drives four ranks of ``make_multihost_mesh((2, 2, 2), ("dp", "sp",
    "tp"), dcn_axis="dp")`` and of ``((2, 4), ("dp", "tp"))``. (a) f32,
    TF32 off, 2 layers, batch 2: one SGD step's loss and leaves bit-equal
    to the single-controller (2, 2, 2) step the same process runs on its
    own eight ranks (the bytes across processes dropped as the control:
    the loss must move); ``make_generate`` greedy and int8 on (2, 4) at
    the decode rung's width (2 layers, B=8, prompt 504, 8 new), each
    stream equal to the single-controller one. (b) bf16 at phase 14's
    width: 2 SGD steps across the processes, the first loss within
    ``TRAIN_BF16_ORACLE`` of phase 57's reference-attention oracle, each
    leaf's change within ``TRAIN_BF16_UPDATE`` of 2 reference steps',
    ms/step beside phases 57 and 14; then phase 59(b)'s (2, 4) int8
    generation, its stream equal to phase 59's. Then, in the same two
    processes, the models of ROADMAP item 18h's parts (i) and (ii) with
    the named axis across them (``bench/multiproc.py``): (a) f32, TF32
    off, 2 layers (4 for the pipelines), each bit-equal to the
    single-controller run of the same shape in the same process: the EP
    step on (2, 1, 2, 2), ep across; ``make_ring_generate`` int8 and the
    int8 serving tick on (2, 4), dp across; ``make_speculative`` on (1,
    8), tp across; GPipe and circular on (1, 2) and 1F1B with MoE stages
    on (2, 2), pp across, the 1F1B state saved by ``TrainCheckpointer``
    (process 0 writing), restored and stepped again bit-equal to the
    uninterrupted run. (b) bf16 at full width, a warm-up and one timed
    step or tick each: the EP step (its first loss within
    ``TRAIN_BF16_ORACLE`` of phase 58's EP oracle), the 1F1B cell on (4,
    2) (within it of phase 58's 1F1B oracle), the int8 serving tick on
    (2, 4), S=8, 32 inner steps; ms and exchanges per process. Exact
    K1-K3 and K5 counts per process (each drives four ranks, or its half
    of a pipeline's). Then, in the same two processes, the device
    coordinator's mesh window over ``("w",)`` of 8, the pool axis
    across them: (a) f64 at phase 56's shape, K=6 then K=4, each window
    bit-equal to the single-controller window the process runs itself
    (histories, blocks, ``last_full``, the pool's end state),
    ``last_full`` within 1e-9 of ``A @ B``, K + 2 exchanges a window
    (the reduce-scatters, the ring, the digest); (b) config 3's width
    (8196x8192 coded at (8, 6), B 8192x8192, ``"default"``), a K=1
    warm-up window and a timed K=2 one: ms/epoch and the exchanges and
    GB out of each process, the histories equal to the flat window's on
    the card, the product within 1e-5 cond(G_S) of the flat window's
    decode and 2^-8 cond(G_S) of ``A @ B``.

Prints a ``{"coded": {...}}`` JSON line with phases 22-26's results, a
``{"moe": ..., "coded_train": ...}`` line with phases 27, 28 and 30's,
a ``{"sampling": ..., "instrumented_coded": ...}`` line with phases
31-35's, a ``{"coded_family": ..., "pool_utils": ...}`` line with
phases 36-41's, a ``{"process_pool": ...}`` line with phases 42-45's, a
``{"slice13": ...}`` line with phases 46-49's, a ``{"slice14": ...}``
line with phases 50-51's, a ``{"slice15": ...}`` line with phases
52-54's, a ``{"slice16": ...}`` line with phases 55-56's, a
``{"slice17": ...}`` line with phase 57's, a ``{"slice18": ...}``
line with phase 58's, a ``{"slice19": ...}`` line with phase 59's, a
``{"slice20": ...}`` line with phase 60's, a
``{"kernels": [...]}`` JSON line and, last,
``{"ok": true, "device": {...}}``. Exits nonzero, printing no result,
without a CUDA device or when any phase fails.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mpistragglers_jl_tpu_torch import AsyncPool, asyncmap, asyncmap_fused, waitall
from mpistragglers_jl_tpu_torch import sim as tsim
from mpistragglers_jl_tpu_torch import native
from mpistragglers_jl_tpu_torch import obs as tobs
from mpistragglers_jl_tpu_torch.backends.cuda import CUDADeviceBackend
from mpistragglers_jl_tpu_torch.bench import adaptive_nwait as an_bench
from mpistragglers_jl_tpu_torch.bench import coded_family as cf_bench
from mpistragglers_jl_tpu_torch.bench import coded_gemm as coded_bench
from mpistragglers_jl_tpu_torch.bench import coded_train as ct_bench
from mpistragglers_jl_tpu_torch.bench import decode_kernel_attrib as attrib
from mpistragglers_jl_tpu_torch.bench import device_coord as dc_bench
from mpistragglers_jl_tpu_torch.bench import chaos as chaos_bench
from mpistragglers_jl_tpu_torch.bench import disagg as disagg_bench
from mpistragglers_jl_tpu_torch.bench import fleet as fleet_bench
from mpistragglers_jl_tpu_torch.bench.configs import DECODE
from mpistragglers_jl_tpu_torch.bench import moe_train as mt
from mpistragglers_jl_tpu_torch.bench import pipeline_train as pt
from mpistragglers_jl_tpu_torch.bench import process_gemm as pg_bench
from mpistragglers_jl_tpu_torch.bench import router as router_bench
from mpistragglers_jl_tpu_torch.bench import transport as tr_bench
from mpistragglers_jl_tpu_torch.bench.kernel_bounds import (
    flash_bounds,
    sampling_bounds,
)
from mpistragglers_jl_tpu_torch.bench.serving_profile import MODEL, _busy_us
from mpistragglers_jl_tpu_torch.bench.train_profile import (
    BATCH,
    LR,
    SEQ,
    TRAIN,
    launch_counts,
    model_flops_per_step,
    raw_matmul_tflops,
    train_batch,
    zero_launches,
)
from mpistragglers_jl_tpu_torch.models import decode as td
from mpistragglers_jl_tpu_torch.models import moe
from mpistragglers_jl_tpu_torch.cache import FleetPrefixCache
from mpistragglers_jl_tpu_torch.models.coded_train import (
    CodedGradTrainer,
    transformer_chunk_loss,
)
from mpistragglers_jl_tpu_torch.models.disagg import (
    DecodeReplica,
    MigrationPlanner,
    MigrationRing,
    MigrationRingReader,
    MigrationTicket,
    PrefillWorker,
    ticket_from_frames,
    ticket_to_frames,
)
from mpistragglers_jl_tpu_torch.models.router import RequestRouter
from mpistragglers_jl_tpu_torch.models.serving import ServingScheduler
from mpistragglers_jl_tpu_torch.models.speculative import (
    generate_speculative_dense,
)
from mpistragglers_jl_tpu_torch.models.transformer import (
    TransformerConfig,
    _leaves,
    _rebuild,
    adamw,
    forward_dense,
    init_params,
    loss_and_grads,
    make_optax_train_step,
    make_train_step,
    nll_loss,
)
from mpistragglers_jl_tpu_torch.ops import _build
from mpistragglers_jl_tpu_torch.parallel.mesh import from_local
from mpistragglers_jl_tpu_torch.ops import decode_attention as da
from mpistragglers_jl_tpu_torch.ops import flash_attention as fa
from mpistragglers_jl_tpu_torch.ops import sampling
from mpistragglers_jl_tpu_torch.native import transport as native_transport
from mpistragglers_jl_tpu_torch.ops.coded_gemm import CodedGemm
from mpistragglers_jl_tpu_torch.ops.gf256_device import DeviceRSGF256
from mpistragglers_jl_tpu_torch.ops.lt import LTCode
from mpistragglers_jl_tpu_torch.qos import TenantContract, TenantRegistry
from mpistragglers_jl_tpu_torch.utils import (
    CheckpointCorrupt,
    CodedCheckpoint,
    TrainCheckpointer,
    prng,
)
from mpistragglers_jl_tpu_torch.utils import load_state_dict as load_pool_state
from mpistragglers_jl_tpu_torch.utils.straggle import PoolLatencyModel
from mpistragglers_jl_tpu_torch.utils.rs_gf256 import RSGF256
from mpistragglers_jl_tpu_torch.utils import trace as ttrace

SLOTS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel against plain version: |got - want| <= atol + rtol * |want|.
# Both sum in f32 (in different orders, hence atol); a bf16 output is
# held against the f32 plain result and may differ by one bf16
# rounding, at most 2**-8 of the value.
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -8)}
K5 = "quantized_decode_attention"
K6 = "paged_decode_attention"
K7 = "decode_attention_attrib"
SAMPLE = "sample_rows"
# phases 31-34: sampled serving at temperature 0.8 with top_k 50; the
# main-path runs of phases 33 and 34 (S=8, n_inner=64) time 1 tick
SAMPLE_T, SAMPLE_TOP_K = 0.8, 50
SERVE_INNER, SERVE_TICKS = 64, 1
SERVE_VARIANTS = ("greedy-dark", "sampled-dark", "sampled-lit")
PROFILE_INNER = 4  # inner steps of the profiled tick
# phase 35: epochs of the instrumented coded trainer and coded GEMM
INSTR_EPOCHS = 2
PAGE = 64  # the paged main path's page size
# flash kernel launch counter -> (name, line of the TPU kernel in
# mpistragglers_jl_tpu/ops/flash_attention.py)
FLASH = {"flash_fwd": ("K1", 169), "flash_bwd_dq": ("K2", 266),
         "flash_bwd_dkv": ("K3", 303), "flash_bwd_fused": ("K4", 348)}
# flash kernels against their plain versions on the same inputs, both
# in f32 (the kernels widen bf16 inputs exactly): the JAX package's own
# bounds, |got - want| <= tol + tol * |want|, 2e-5 for o and lse, 5e-5
# for gradients; a bf16 output adds one bf16 rounding, 2**-8 |want|
FLASH_OUT, FLASH_GRAD = 2e-5, 5e-5
# training at full width, flash against reference attention (phase 13,
# f32, TF32 off): the loss within 1e-5 relative, each gradient leaf's
# largest difference within 1e-3 of the leaf's largest value (f32 sums
# over 2048 positions and 8 layers, in different orders)
TRAIN_F32_LOSS, TRAIN_F32_GRAD = 1e-5, 1e-3
# bf16 main path against the reference attention on the same batch
# (both attentions sum in f32 and round o, dq, dk, dv to bf16 once; the
# rest of the step rounds to bf16 alike): the first loss within
# TRAIN_BF16_ORACLE relative, and each layer's wq, wk, wv, wo gradient
# within TRAIN_BF16_ATTN_GRAD relative Frobenius difference. Phase 14
# prints two controls that must break both limits: the attention output
# zeroed, and the reference with a window of L/2 (far keys dropped).
# On an H100 80GB HBM3 at 700 W the sound readings were 2.9e-6 (loss)
# and 1.4e-2 (gradients), the controls 2.8e-4 and 5.6e-4 (loss) and
# 0.68 (gradients, window); each limit sits near the geometric middle.
# The update: each leaf's change over the main path's six SGD steps,
# held to the same leaf's change with the reference attention (same
# init, same batch, its own updates) within TRAIN_BF16_UPDATE relative
# Frobenius difference, worst leaf. Two controls must break it: wo
# zeroed (the attention's output dropped) and the window of L/2. On an
# H100 80GB HBM3 at 700 W the sound reading was 0.162, the controls
# 1.3e3 and 1.08; the limit sits near the geometric middle of the sound
# reading and the nearer control. Phase 57 holds the sharded step to it
# too: on (2, 2, 2) the sound reading was 0.244 and its control, the dp
# gradient sum dropped, 1.03 (H100 80GB HBM3, 400 W). The loss itself
# does not fall
# measurably at this learning rate (lr * g is under half a bf16 ulp for
# nearly every weight; PERF.md §6), so it is printed, not held.
TRAIN_BF16_ORACLE = 3e-5
TRAIN_BF16_ATTN_GRAD = 1e-1
TRAIN_BF16_UPDATE = 0.4
# fused against split backward in bf16 (phase 15): K4 and K2, K3 round
# the same f32 dq, dk and dv sums (added in other orders) to bf16 once;
# each leaf's relative Frobenius difference within 2e-2, about five bf16
# roundings
FUSED_BF16_GRAD = 2e-2
# phase 19: bench_decode's prompt and n_new; the slope's step delta is
# cut from the reference's 384 to 128 to keep the script short
LONG_PROMPT, LONG_NEW, SLOPE_STEPS = 16384, 128, 128
# phase 18: (B, prompt, n_new) of the f32 long-context parity
GEN_PARITY = (4, 2048, 32)
# phase 21: (prompt, n_new) of the f32 parity and of bench_spec_decode
SPEC_F32, SPEC_BF16, SPEC_K = (512, 64), (2048, 256), 4
SPEC_DRAFT_LAYERS = 2  # bench_spec_decode's truncated-layer drafter
# phase 17: K7 and K5 at (B, L, block_k); the bench's flagship and its
# B=4, a smaller batch, and a length that leaves the last segment short
ATTRIB_CASES = ((1, 16384, 4096), (4, 16384, 4096), (2, 1024, 256),
                (4, 1000, 160))
# phase 17: K5 windows whose lower edge cuts a split's chunk, by L
K5_CUT_WINDOW = {16384: 1000, 1024: 77, 1000: 77}
# The first designs' times (us) on an H100 80GB HBM3 at 700 W (PERF.md
# §6), printed beside this run's: K1-K4 at the train shape, K5 and K6
# at the serving shape (eager loops), K5 at 16k and K7's variants at
# B=1 (CUDA-graph replays)
OLD_US = {"K1": 5197.2, "K2": 5955.8, "K3": 6985.5, "K4": 9106.3,
          "K5": 78.24, "K6": 91.21, "K5 B=1": 1188.15, "K5 B=4": 1191.15,
          "K5 B=8": 1190.87, "dma": 378.23, "dot": 745.30,
          "dequant": 747.30, "full_nosm": 1051.37}
# K7's dot, dequant and full_nosm against their plain versions: f32
# sums over up to 16384 keys in other orders; within 1e-5 of the
# largest value plus 1e-5 relative (dma is exact: integer sums)
ATTRIB_TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _cache(B, L, Hkv, D, gen, dev):
    kq, ks = td._kv_quantize(torch.randn(B, L, Hkv, D, generator=gen))
    vq, vs = td._kv_quantize(torch.randn(B, L, Hkv, D, generator=gen))
    return {n: t.to(dev) for n, t in
            {"k": kq, "k_s": ks, "v": vq, "v_s": vs}.items()}


def _hold(got, want, dt, label: str) -> float:
    """Hold a kernel output against the f32 plain result; returns the
    max abs error."""
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    diff = (got.float() - want).abs()
    err = diff.max().item()
    # share of the limit used by the worst element (<= 1)
    used = (diff / (atol + rtol * want.abs())).max().item()
    ok = bool(torch.isfinite(got).all()) and used <= 1.0
    print(f"  {label} {str(dt):15s} max_abs_err={err:.3e} limit "
          f"atol={atol:.0e} rtol={rtol:.3e} used {used:.3f} "
          f"{'ok' if ok else 'FAIL'}")
    _require(ok, f"kernel disagrees with plain version: {label} {dt} "
                 f"err={err} limit used {used}")
    return err


def phase_kernel_vs_plain(dev) -> float:
    """K5: every mode, both q types, GQA 1/4/8 at B=8, L=W=1024,
    D=128."""
    gen = torch.Generator().manual_seed(0)
    B, L, D, Hq = SLOTS, MODEL["attn_window"], 128, 8
    pos = torch.tensor([0, 7, 31, 32, 1023, 1024, 5000, 2047],
                       dtype=torch.int32, device=dev)
    worst = 0.0
    for Hkv in (8, 2, 1):
        cache = _cache(B, L, Hkv, D, gen, dev)
        q32 = torch.randn(B, 1, Hq, D, generator=gen).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            q = q32.to(dt)
            for kw in ({"ring": True}, {}, {"window": 100}):
                got = da.quantized_decode_attention(q, cache, pos,
                                                    D ** -0.5, **kw)
                # the plain version in f32 on the same (bf16-valued) q
                want = da.quantized_decode_attention_ref(
                    q.float(), cache, pos, D ** -0.5, **kw)
                worst = max(worst, _hold(got, want, dt,
                                         f"g={Hq // Hkv} {str(kw):16s}"))
    return worst


def _paged_case(B, W, P, Hkv, D, gen, dev):
    """A pool of B * W/P + 4 pages (page 0 the null page), a page table
    from a seeded permutation with pages shared by rows 1 and 2 and
    null entries past the budget of the rows in warm-up, and positions
    in warm-up, at W - 1, at W and wrapped."""
    mp = W // P
    n_pages = B * mp + 4
    pool = {k: t[0] for k, t in
            _cache(1, n_pages * P, Hkv, D, gen, dev).items()}
    pt = torch.randperm(n_pages - 1, generator=gen)[:B * mp] + 1
    pt = pt.reshape(B, mp).to(torch.int32)
    pos = torch.tensor([0, 7, 31, 32, W - 1, W, 5000, 3 * W + 1],
                       dtype=torch.int32)[:B]
    pt[2, :3] = pt[1, :3]
    for b in range(B):
        if pos[b] < W:
            pt[b, int(pos[b]) // P + 1:] = 0
    return pool, pt.to(dev), pos.to(dev)


def phase_paged_vs_plain(dev) -> float:
    """K6: pages of 16, 64 and 24 rows, GQA 1/4/8, both q types, each
    on more than one split."""
    gen = torch.Generator().manual_seed(4)
    B, D, Hq = SLOTS, 128, 8
    worst = 0.0
    for P, W in ((16, 1024), (64, 1024), (24, 960)):
        for Hkv in (8, 2, 1):
            chunk, n_split = da.paged_split_plan(B, Hkv, W, P,
                                                 n_sm=da.sm_count(dev))
            print(f"  P={P:2d} W={W} Hkv={Hkv}: {n_split} splits of "
                  f"{chunk} ring slots")
            _require(n_split > 1, f"K6 ran one split at P={P} W={W} "
                                  f"Hkv={Hkv}")
            pool, pt, pos = _paged_case(B, W, P, Hkv, D, gen, dev)
            q32 = torch.randn(B, 1, Hq, D, generator=gen).to(dev)
            for dt in (torch.bfloat16, torch.float32):
                q = q32.to(dt)
                got = da.quantized_decode_attention(
                    q, pool, pos, D ** -0.5, ring=True, page_table=pt,
                    page_tokens=P)
                want = da.paged_decode_attention_ref(
                    q.float(), pool, pos, D ** -0.5, pt, P)
                worst = max(worst, _hold(got, want, dt,
                                         f"P={P:2d} W={W} g={Hq // Hkv}"))
    return worst


def _capture_equals_eager(call, what: str) -> None:
    """``call()`` captured into a CUDA graph (its scratch allocated
    inside the capture) after an eager call and a warm-up off the
    default stream: two replays must equal the eager output, and
    neither the capture nor the replays add to the launch counts."""
    want = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        call()
    torch.cuda.current_stream().wait_stream(side)
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    same = []
    for _ in range(2):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same.append(bool(torch.equal(got, want)))
    after = launch_counts()
    print(f"  {what}: replays equal the eager output: {same}; counts "
          f"unchanged by capture and replays: {after == before}")
    _require(all(same), f"a CUDA-graph replay of {what} differs from the "
                        "eager call")
    _require(after == before, f"capture or replay counted launches: "
                              f"{before} -> {after}")


def phase_k6_graph(dev) -> None:
    """One K6 call at the serving shape (B=8, W=1024, pages of 64, 8
    q heads over 2 kv heads: 8 splits) under CUDA-graph capture."""
    gen = torch.Generator().manual_seed(29)
    B, W, Hkv, D = SLOTS, MODEL["attn_window"], MODEL["n_kv_heads"], 128
    pool, pt, pos = _paged_case(B, W, PAGE, Hkv, D, gen, dev)
    q = torch.randn(B, 1, MODEL["n_heads"], D,
                    generator=gen).to(torch.bfloat16).to(dev)
    plan = da.paged_split_plan(B, Hkv, W, PAGE, n_sm=da.sm_count(dev))
    _capture_equals_eager(
        lambda: da.quantized_decode_attention(
            q, pool, pos, D ** -0.5, ring=True, page_table=pt,
            page_tokens=PAGE),
        f"K6 split plan {plan}")


def _prompts(rng, lens, vocab):
    return [rng.integers(0, vocab, n, dtype=np.int64) for n in lens]


def _oracle_equal(params, cfg, prompt, n, stream, dev, what):
    o = td.generate_ring_dense(params, prompt[None], n, cfg,
                               quantize_kv=True, device=dev)
    _require(o.cpu().numpy()[0].tolist() == stream,
             f"{what} differs from the generate_ring_dense oracle")


def phase_serving_parity_f32(dev) -> None:
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    lens = [512, 300, 77, 450, 128, 5, 260, 511, 64, 333]
    budgets = [16, 32, 24, 16, 32, 20, 16, 28, 32, 18]
    prompts = _prompts(rng, lens, cfg.vocab)
    streams = []
    for toggle in (None, False):
        td.use_decode_kernel(toggle)
        try:
            sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=8,
                                     prompt_chunk=256, max_prompt=512,
                                     quantize_kv=True, device=dev)
        finally:
            td.use_decode_kernel(None)
        _require(sched.use_kernel == (toggle is None),
                 f"routing: use_kernel={sched.use_kernel} at toggle "
                 f"{toggle}")
        zero_launches()
        reqs = [sched.submit(p, max_new=n) for p, n in zip(prompts, budgets)]
        sched.run()
        n = da.LAUNCHES[K5]
        want = (cfg.n_layers * sched.n_inner * sched.decode_ticks
                if toggle is None else 0)
        route = "kernel" if toggle is None else "einsum"
        print(f"  {route} route: {sched.decode_ticks} decode ticks, "
              f"{n} kernel launches (want {want})")
        _require(n == want, f"{route} route launched the kernel {n} times, "
                            f"want {want}")
        _require(all(r.finished and len(r.tokens) == b
                     for r, b in zip(reqs, budgets)),
                 f"{route} route: a request did not finish its budget")
        streams.append([r.tokens for r in reqs])
    same = sum(a == b for a, b in zip(*streams))
    print(f"  streams identical on both routes: {same}/{len(prompts)}")
    _require(same == len(prompts), "kernel and einsum routes disagree")
    for i in (2, 5):
        _oracle_equal(params, cfg, prompts[i], budgets[i], streams[0][i],
                      dev, f"request {i}")
    print("  requests 2 and 5 equal the generate_ring_dense oracle")
    del params


def phase_paged_parity_f32(dev) -> None:
    """Ten requests through pages of 64 on both routes. Requests A and
    B are 900 tokens on one 256-token prefix; B is submitted once A
    has its first token, so it shares A's 4 prefix pages, and both
    decode past position 1024, so the first of them to write page 0
    copies it."""
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(0, cfg.vocab, 256)
    pa, pb = (np.concatenate([sys_prompt, rng.integers(0, cfg.vocab, 644)])
              for _ in range(2))
    others = _prompts(rng, [77, 450, 128, 5, 260, 511, 64, 333], cfg.vocab)
    budgets = [16, 32, 24, 16, 32, 20, 16, 28]
    n_ab = 160
    streams = []
    for toggle in (None, False):
        td.use_decode_kernel(toggle)
        try:
            sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=8,
                                     prompt_chunk=256, max_prompt=1024,
                                     quantize_kv=True, page_tokens=PAGE,
                                     device=dev)
        finally:
            td.use_decode_kernel(None)
        route = "kernel" if toggle is None else "gather"
        _require(sched.use_kernel == (toggle is None),
                 f"routing: use_kernel={sched.use_kernel} at toggle "
                 f"{toggle}")
        zero_launches()
        ra = sched.submit(pa, max_new=n_ab)
        reqs = [sched.submit(p, max_new=n)
                for p, n in zip(others[:6], budgets[:6])]
        while not ra.tokens:
            sched.step()
        rb = sched.submit(pb, max_new=n_ab)
        reqs += [sched.submit(p, max_new=n)
                 for p, n in zip(others[6:], budgets[6:])]
        sched.run()
        n5, n6 = da.LAUNCHES[K5], da.LAUNCHES[K6]
        want = (cfg.n_layers * sched.n_inner * sched.decode_ticks
                if toggle is None else 0)
        pool = sched.pool
        print(f"  {route} route: {sched.decode_ticks} decode ticks, K6 "
              f"{n6} launches (want {want}), K5 {n5}; share hits "
              f"{pool.share_hits}, COW copies {pool.cow_copies}")
        _require(n6 == want and n5 == 0,
                 f"{route} route launched K6 {n6} times (want {want}) "
                 f"and K5 {n5} times (want 0)")
        _require(pool.share_hits == 4 and pool.cow_copies > 0,
                 f"{route} route: {pool.share_hits} share hits (want 4), "
                 f"{pool.cow_copies} COW copies (want > 0)")
        pool.check()
        _require(pool.used == 0 and pool.reserved == 0,
                 f"{route} route: pool not drained: {pool.stats()}")
        _require(all(r.finished and len(r.tokens) == b for r, b in
                     zip([ra, rb] + reqs, [n_ab, n_ab] + budgets)),
                 f"{route} route: a request did not finish its budget")
        streams.append([r.tokens for r in [ra, rb] + reqs])
    same = sum(a == b for a, b in zip(*streams))
    print(f"  streams identical on both routes: {same}/{len(streams[0])}")
    _require(same == len(streams[0]), "kernel and gather routes disagree")
    for name, p, s in (("A", pa, streams[0][0]), ("B", pb, streams[0][1])):
        _oracle_equal(params, cfg, p, n_ab, s, dev, f"request {name}")
    print("  the two sharing requests equal the generate_ring_dense oracle")
    del params


def _serving_report(sched, cfg, n_inner, ticks, dt, t_admit, dev):
    peak = torch.cuda.max_memory_allocated(dev)
    rep = {
        "decode_tokens_per_s": SLOTS * n_inner * ticks / dt,
        "ms_per_step": dt / (n_inner * ticks) * 1e3,
        "admit_tick_s": t_admit,
        "peak_mem_gb": peak / 1e9,
        "decode_ticks": sched.decode_ticks,
    }
    print(f"  aggregate decode {rep['decode_tokens_per_s']:.1f} tokens/s, "
          f"{rep['ms_per_step']:.3f} ms/step (S={SLOTS}), admission tick "
          f"{t_admit:.3f} s, peak memory {rep['peak_mem_gb']:.3f} GB")
    return rep


def _timed_ticks(sched, ticks):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        sched.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_serving_bf16(dev):
    """The slot-ring main path: returns (launches, report)."""
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    n_inner, ticks, Tp = 64, 3, 512
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(2)
    zero_launches()
    sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=n_inner,
                             prompt_chunk=Tp, max_prompt=Tp,
                             quantize_kv=True, device=dev)
    _require(sched.use_kernel, "the S=8 int8 tick did not route the kernel")
    reqs = [sched.submit(p, max_new=n_inner * (ticks + 2))
            for p in _prompts(rng, [Tp] * SLOTS, cfg.vocab)]
    t0 = time.perf_counter()
    sched.step()  # admits all 8 (one 512-token chunk each) + 1 tick
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    dt = _timed_ticks(sched, ticks)
    launches = launch_counts()
    want = cfg.n_layers * n_inner * sched.decode_ticks
    _require(launches[K5] == want and launches[K6] == 0,
             f"main path launched K5 {launches[K5]} times (want {want}) "
             f"and K6 {launches[K6]} times (want 0)")
    for r in reqs:
        _require(len(r.tokens) == 1 + n_inner * (ticks + 1),
                 f"request {r.id} holds {len(r.tokens)} tokens")
        _require(all(0 <= t < cfg.vocab for t in r.tokens),
                 f"request {r.id} emitted an out-of-vocabulary token")
    print(f"  {sched.decode_ticks} decode ticks ({ticks} timed), "
          f"{launches[K5]} K5 launches (= {cfg.n_layers} layers x "
          f"{n_inner} steps x {sched.decode_ticks} ticks)")
    rep = _serving_report(sched, cfg, n_inner, ticks, dt, t_admit, dev)
    del sched, params
    return launches, rep


def phase_paged_serving_bf16(dev):
    """The paged main path: request 1 is a 256-token system prompt plus
    256 own tokens; once it has its first token, 7 more on the same
    system prompt arrive, each sharing its 4 prefix pages and running
    one prefill chunk. Budgets keep every request resident and short of
    the wrap. Returns (launches, report)."""
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    n_inner, ticks, max_new = 64, 3, 384
    rng = np.random.default_rng(6)
    sys_prompt = rng.integers(0, cfg.vocab, 256)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, cfg.vocab, 256)])
               for _ in range(SLOTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=n_inner,
                             prompt_chunk=256, max_prompt=512,
                             quantize_kv=True, page_tokens=PAGE, device=dev)
    _require(sched.use_kernel,
             "the S=8 paged int8 tick did not route the kernel")
    first = sched.submit(prompts[0], max_new=max_new)
    while not first.tokens:
        sched.step()  # two 256-token chunks, then its first tick
    reqs = [first] + [sched.submit(p, max_new=max_new) for p in prompts[1:]]
    t0 = time.perf_counter()
    sched.step()  # admits the 7 (one chunk each) + a tick of all 8
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    dt = _timed_ticks(sched, ticks)
    launches = launch_counts()
    pool = sched.pool
    want = cfg.n_layers * n_inner * sched.decode_ticks
    print(f"  share hits {pool.share_hits} (want 28), prefill chunks "
          f"{sched.prefill_chunks} (want 9), pages used {pool.used} of "
          f"{pool.n_pages - 1}")
    print(f"  {sched.decode_ticks} decode ticks ({ticks} timed), "
          f"{launches[K6]} K6 launches (= {cfg.n_layers} layers x "
          f"{n_inner} steps x {sched.decode_ticks} ticks), "
          f"{launches[K5]} K5")
    _require(launches[K6] == want and launches[K5] == 0,
             f"main path launched K6 {launches[K6]} times (want {want}) "
             f"and K5 {launches[K5]} times (want 0)")
    _require(pool.share_hits == 28 and sched.prefill_chunks == 9,
             f"{pool.share_hits} share hits (want 28), "
             f"{sched.prefill_chunks} prefill chunks (want 9)")
    pool.check()
    for r in reqs:
        _require(not r.finished and len(r.tokens) > n_inner,
                 f"request {r.id} retired or holds {len(r.tokens)} tokens")
        _require(all(0 <= t < cfg.vocab for t in r.tokens),
                 f"request {r.id} emitted an out-of-vocabulary token")
    rep = _serving_report(sched, cfg, n_inner, ticks, dt, t_admit, dev)
    rep.update(share_hits=pool.share_hits,
               prefill_chunks=sched.prefill_chunks, pages_used=pool.used)
    del sched, params
    return launches, rep


def _time_ms(fn, n_iter, n_warm=10):
    for i in range(n_warm):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def _graph_ms(fn, n: int, replays: int = 3) -> float:
    """Device time per call of ``fn(0) .. fn(n - 1)`` captured as one
    CUDA graph: the least of ``replays`` replays, timed with CUDA events,
    over n. A replay launches no Python, so this is the kernels' own
    time, which an eager loop of microsecond calls hides behind the
    host's enqueue time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for i in range(n):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    best = min(_time_ms(lambda _: graph.replay(), 1, n_warm=0)
               for _ in range(replays))
    del graph
    return best / n


def _timing(kern_fn, plain_fn, views, q, pos, nbytes, label):
    """Time a kernel, its plain version and the SDPA yardstick over the
    dequantised ring views (heads repeated for GQA, the same ring mask,
    here all visible); bound from the bytes and operations the call
    needs. ``views`` are the rotated copies' (B, W, ...) ring views;
    ``label`` (K5 or K6) keys its first design's time in OLD_US.

    ``ms``, ``plain_ms`` and ``library_ms`` are eager loops over the
    rotated copies, timed with CUDA events as the first design was (the
    host's enqueue time included where it exceeds the kernels');
    ``graph_ms`` and ``library_graph_ms`` are the kernel and SDPA as
    replays of a CUDA graph of one call per copy (``_graph_ms``), the
    device's own time."""
    B, _, H, D = q.shape
    W, Hkv = views[0]["k"].shape[1], views[0]["k"].shape[2]
    dt = q.dtype
    n = len(views)
    kern = _time_ms(lambda i: kern_fn(i % n), 400)
    kern_graph = _graph_ms(kern_fn, n)
    plain = _time_ms(lambda i: plain_fn(i % n), 50)
    g = H // Hkv
    deq = []
    for c in views:
        kd = (c["k"].float() * c["k_s"][..., None]).to(dt)
        vd = (c["v"].float() * c["v_s"][..., None]).to(dt)
        deq.append((kd.repeat_interleave(g, 2).transpose(1, 2).contiguous(),
                    vd.repeat_interleave(g, 2).transpose(1, 2).contiguous()))
    kidx = torch.arange(W, device=q.device)
    mask = ((kidx[None] <= pos[:, None]) | (pos[:, None] >= W))[:, None,
                                                                None, :]
    qh = q.transpose(1, 2).contiguous()

    def sdpa(i):
        return F.scaled_dot_product_attention(
            qh, deq[i % n][0], deq[i % n][1], attn_mask=mask,
            scale=D ** -0.5)

    lib = _time_ms(sdpa, 200)
    lib_graph = _graph_ms(sdpa, n)
    nops = 4 * B * H * W * D  # q.k and p.v multiply-adds, all visible
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dt] * 1e3
    rep = {"ms": kern, "plain_ms": plain, "library_ms": lib,
           "graph_ms": kern_graph, "library_graph_ms": lib_graph,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": nops}
    print(f"  {label} {kern * 1e3:.2f} us/launch eager (first design, "
          f"eager: {OLD_US[label]} us), {kern_graph * 1e3:.2f} us in a "
          f"graph; bound {rep['bound_ms'] * 1e3:.3f} us ({nbytes} B at "
          f"3.35 TB/s; {nops} ops {t_ops * 1e3:.4f} us), plain "
          f"{plain * 1e3:.2f} us eager, SDPA over the dequantised cache "
          f"{lib * 1e3:.2f} us eager, {lib_graph * 1e3:.2f} us in a graph")
    return rep


def _attention_bytes(B, W, Hkv, D, q):
    """Each input read once, the output written once: int8 K and V,
    f32 k_s and v_s over the W visible keys, q in and out, positions."""
    return (B * W * Hkv * D * 2 + B * W * Hkv * 4 * 2
            + q.numel() * q.element_size() * 2 + B * 4)


def phase_kernel_timing(dev) -> dict:
    """K5, bf16 ring mode, every row past warm-up (all W keys visible),
    16 cache copies rotated so each launch finds its cache outside
    L2."""
    gen = torch.Generator().manual_seed(3)
    B, L, Hkv, D = SLOTS, MODEL["attn_window"], MODEL["n_kv_heads"], 128
    caches = [_cache(B, L, Hkv, D, gen, dev) for _ in range(16)]
    q = torch.randn(B, 1, MODEL["n_heads"], D,
                    generator=gen).to(torch.bfloat16).to(dev)
    pos = torch.arange(B, dtype=torch.int32, device=dev) + 5000
    scale = D ** -0.5
    return _timing(
        lambda i: da.quantized_decode_attention(q, caches[i], pos, scale,
                                                ring=True),
        lambda i: da.quantized_decode_attention_ref(q, caches[i], pos, scale,
                                                    ring=True),
        caches, q, pos, _attention_bytes(B, L, Hkv, D, q), "K5")


def _paged_pools(B, W, P, Hkv, D, gen, dev, n=16):
    """``n`` pools of B * W/P + 1 pages, each with its own page-table
    permutation (every row past warm-up reads W/P pages of its own)."""
    mp = W // P
    n_pages = B * mp + 1
    pools, pts = [], []
    for _ in range(n):
        pools.append({k: t[0] for k, t in
                      _cache(1, n_pages * P, Hkv, D, gen, dev).items()})
        pts.append((torch.randperm(n_pages - 1, generator=gen) + 1)
                   .reshape(B, mp).to(torch.int32).to(dev))
    return pools, pts


def phase_paged_timing(dev) -> dict:
    """K6, bf16, pages of 64, W=1024 (16 pages a row), every row past
    warm-up; 16 pools, each with its own page-table permutation,
    rotated so each launch finds its pages outside L2. Then K6 alone as
    CUDA-graph replays at pages of 16 (W=1024) and 24 (W=960), phase
    7's other page sizes."""
    gen = torch.Generator().manual_seed(7)
    B, W, Hkv, D = SLOTS, MODEL["attn_window"], MODEL["n_kv_heads"], 128
    q = torch.randn(B, 1, MODEL["n_heads"], D,
                    generator=gen).to(torch.bfloat16).to(dev)
    pos = torch.arange(B, dtype=torch.int32, device=dev) + 5000
    scale = D ** -0.5
    pools, pts = _paged_pools(B, W, PAGE, Hkv, D, gen, dev)
    views = [{k: da.paged_ring_view(a, pt, PAGE) for k, a in p.items()}
             for p, pt in zip(pools, pts)]
    nbytes = _attention_bytes(B, W, Hkv, D, q) + pts[0].numel() * 4
    rep = _timing(
        lambda i: da.quantized_decode_attention(
            q, pools[i], pos, scale, ring=True, page_table=pts[i],
            page_tokens=PAGE),
        lambda i: da.paged_decode_attention_ref(q, pools[i], pos, scale,
                                                pts[i], PAGE),
        views, q, pos, nbytes, "K6")
    del views
    by_page = {f"P={PAGE} W={W}": rep["graph_ms"]}
    for P, Wp in ((16, 1024), (24, 960)):
        pools, pts = _paged_pools(B, Wp, P, Hkv, D, gen, dev)
        by_page[f"P={P} W={Wp}"] = _graph_ms(
            lambda i: da.quantized_decode_attention(
                q, pools[i], pos, scale, ring=True, page_table=pts[i],
                page_tokens=P), len(pools))
    plans = {k: da.paged_split_plan(B, Hkv, int(k.split("W=")[1]),
                                    int(k.split()[0][2:]),
                                    n_sm=da.sm_count(dev))
             for k in by_page}
    print("  K6 in a graph by page size: " + ", ".join(
        f"{k} {v * 1e3:.2f} us ({plans[k][1]} splits of {plans[k][0]})"
        for k, v in by_page.items()))
    rep["at_pages_graph_ms"] = by_page
    rep["at_chunks_graph_ms"] = _k6_by_chunk(q, pos, scale, gen, dev)
    return rep


def _k6_at_chunk(q, pool, pos, scale, pt, P, chunk):
    """One K6 call with ``chunk`` ring slots a split instead of
    ``paged_split_plan``'s, straight through the C entry: a measurement
    of the block, not a path of the port, so it is not counted."""
    B, _, H, D = q.shape
    Hkv, max_pages = pool["k"].shape[1], pt.shape[1]
    n_split = -(-max_pages * P // chunk)
    out = torch.empty_like(q)
    (acc, m, l), _keep = da._split_scratch(q, B, Hkv, H // Hkv, D, n_split)
    lib = da._kernel_lib()
    err = lib.k6_paged_decode_attention_int8(
        q.data_ptr(), pool["k"].data_ptr(), pool["v"].data_ptr(),
        pool["k_s"].data_ptr(), pool["v_s"].data_ptr(), pos.data_ptr(),
        pt.data_ptr(), out.data_ptr(), m, l, acc, B, max_pages, P,
        pool["k"].shape[0] // P, Hkv, H // Hkv, D, float(scale), chunk,
        n_split, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _require(err == 0, f"K6 at chunk {chunk}: CUDA error {err}")
    return out


def _k6_by_chunk(q, pos, scale, gen, dev) -> dict:
    """K6 at the serving shape (pages of 64) as CUDA-graph replays with
    1 to 32 splits: a split of c slots gives each of the block's 8 warps
    c / 256 tiles of 32 keys (at least one warp busy), so the times show
    what one warp's tile costs and what the launch, merge and combine
    cost around it. Each chunk's output is held to the plain
    version."""
    B, W = q.shape[0], MODEL["attn_window"]
    pools, pts = _paged_pools(B, W, PAGE, MODEL["n_kv_heads"], q.shape[-1],
                              gen, dev)
    want = da.paged_decode_attention_ref(q.float(), pools[0], pos, scale,
                                         pts[0], PAGE)
    out = {}
    for chunk in (32, 64, 128, 256, 512, 1024):
        got = _k6_at_chunk(q, pools[0], pos, scale, pts[0], PAGE, chunk)
        _hold(got, want, q.dtype, f"K6 chunk {chunk:4d}")
        out[f"chunk={chunk}"] = _graph_ms(
            lambda i, c=chunk: _k6_at_chunk(q, pools[i], pos, scale, pts[i],
                                            PAGE, c), len(pools))
    print("  K6 in a graph by split (slots a split: us): " + ", ".join(
        f"{k[6:]}: {v * 1e3:.2f}" for k, v in out.items()))
    return out


def _decode_build_report() -> None:
    """Registers, stack and spills of the decode kernels at D=128 (the
    main paths' head width), from the ptxas output of the build."""
    log = _build.build_logs.get("decode_attention")
    if log is None:
        print("  (library reused from an earlier build: no compiler output)")
        return
    modes = ("full", "dma", "dot", "dequant", "full_nosm")
    kern = None
    for line in log.splitlines():
        split = re.search(r"decode_split_kernelI(f|13__nv_bfloat16)Li(\d)E"
                          r"Lb([01])ELi(\d)E", line)
        comb = re.search(r"decode_combine_kernelI(f|13__nv_bfloat16)Li(\d)E"
                         r"Li(\d)E", line)
        m = split or comb
        if m:
            dt = "f32" if m.group(1) == "f" else "bf16"
            kern = None
            if m.group(2) == "1":  # DV = 1: D = 128
                kern = (f"decode_split_kernel<{dt}, paged={m.group(3)}, "
                        f"{modes[int(m.group(4))]}>" if split else
                        f"decode_combine_kernel<{dt}, "
                        f"{modes[int(m.group(3))]}>")
        elif kern and ("registers" in line or "spill" in line):
            print(f"  {kern}: {line.strip()}")


def _flash_build_report() -> None:
    """Registers and spills of every flash kernel instantiation, from
    the ptxas output of the build."""
    if "flash_attention" not in _build.build_logs:
        print("  (library reused from an earlier build: no compiler output)")
        return
    kern = None
    for line in _build.build_logs["flash_attention"].splitlines():
        m = re.search(r"(flash_[a-z_]+_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                      line)
        tc = re.search(r"(flash_[a-z_]+_wgmma_kernel)ILi(\d+)E", line)
        if m:
            kern = (f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}"
                    f", D={m.group(3)}>")
        elif tc:
            kern = f"{tc.group(1)}<bf16, D={tc.group(2)}>"
        elif kern and ("registers" in line or "spill" in line):
            print(f"  {kern}: {line.strip()}")


def _share_used(got, want, tol) -> tuple[float, float]:
    """(max abs error, share of the limit used by the worst element) of
    a flash kernel output against its f32 plain result; a bf16 output
    may add one bf16 rounding."""
    rtol = tol + (2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0)
    _require(bool(torch.isfinite(got).all()), "non-finite kernel output")
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), (diff / (tol + rtol * want.float().abs())
                               ).max().item()


def _flash_pairs(fwd_out, args, args_ref) -> dict:
    """kernel name -> [(kernel output, plain output)] for K1-K4 on the
    same inputs: ``fwd_out`` is K1's (o, lse) on ``args[:3]``, and
    ``args_ref`` are ``args`` with f32 copies of q, k, v and dO."""
    meta = args[6:]
    return {
        "flash_fwd": list(zip(fwd_out, fa._fwd_ref(*args_ref[:3], *meta))),
        "flash_bwd_dq": [(fa._bwd_dq(*args), fa._bwd_dq_ref(*args_ref))],
        "flash_bwd_dkv": list(zip(fa._bwd_dkv(*args),
                                  fa._bwd_dkv_ref(*args_ref))),
        "flash_bwd_fused": list(zip(fa._bwd_fused_grads(*args),
                                    fa._bwd_fused_ref(*args_ref))),
    }


def _hold_flash(pairs, label, worst) -> None:
    """Hold every flash kernel output against its plain result (o, lse
    to FLASH_OUT, gradients to FLASH_GRAD), print the share of the limit
    each kernel uses, fail above 1, and fold each kernel's largest abs
    error into ``worst``."""
    torch.cuda.synchronize()
    used = {}
    for name, outs in pairs.items():
        tol = FLASH_OUT if name == "flash_fwd" else FLASH_GRAD
        for got, want in outs:
            err, u = _share_used(got, want, tol)
            worst[name] = max(worst[name], err)
            used[name] = max(used.get(name, 0.0), u)
    ok = all(u <= 1.0 for u in used.values())
    print(f"  {label:58s} limit used "
          + " ".join(f"{FLASH[n][0]} {u:.3f}" for n, u in used.items())
          + (" ok" if ok else " FAIL"))
    _require(ok, f"flash kernel disagrees with its plain version: {label} "
                 f"{used}")


def _bf16_only_control(args_ref) -> dict:
    """K2's and K3's gradients as a tensor-core kernel without the hi/lo
    split would form them, in plain torch on the kernels' inputs: P and
    dS rounded to bf16, the products summed in f32, the gradients
    rounded to bf16. Returns each gradient's share of FLASH_GRAD (with
    the bf16 rounding allowance, as ``_hold_flash`` holds K2 and K3)
    against the plain versions; each must exceed 1, or the limit could
    not tell such a kernel from one that keeps the reference's
    precision."""
    q, k, _, do = args_ref[:4]
    scale, g = args_ref[6], args_ref[9]
    p, ds = (t.to(torch.bfloat16).float()
             for t in fa._probs_and_ds(*args_ref))
    got = {"dq": ds @ fa._kv_rows(k, g) * scale,
           "dk": ds.transpose(1, 2) @ q * scale,
           "dv": p.transpose(1, 2) @ do}
    del p, ds
    want = dict(zip(("dk", "dv"), fa._bwd_dkv_ref(*args_ref)),
                dq=fa._bwd_dq_ref(*args_ref))
    return {n: _share_used(got[n].to(torch.bfloat16), want[n],
                           FLASH_GRAD)[1] for n in got}


def phase_flash_vs_plain(dev) -> dict:
    """K1-K4 against their plain versions on the same inputs (the plain
    versions take f32 copies). Returns each kernel's largest abs
    error."""
    gen = torch.Generator().manual_seed(11)
    worst = {name: 0.0 for name in FLASH}
    for B, L, H, Hkv, D in ((2, 512, 8, 8, 128), (2, 384, 8, 2, 128),
                            (1, 300, 4, 1, 64)):
        base = [torch.randn(B * h, L, D, generator=gen)
                for h in (H, Hkv, Hkv, H)]
        for dt in (torch.bfloat16, torch.float32):
            q3, k3, v3, do3 = (t.to(dt).to(dev) for t in base)
            f32 = [t.float() for t in (q3, k3, v3, do3)]
            for causal in (True, False):
                for window in (None, 128):
                    meta = (D ** -0.5, causal, window, H // Hkv)
                    o, lse = fa._fwd(q3, k3, v3, *meta)
                    delta = fa._delta(do3, o)
                    args = (q3, k3, v3, do3, lse, delta) + meta
                    args_ref = tuple(f32) + (lse, delta) + meta
                    label = (f"B={B} L={L} H={H} Hkv={Hkv} D={D} "
                             f"{'bf16' if dt == torch.bfloat16 else 'f32 '} "
                             f"causal={int(causal)} window={window}")
                    _hold_flash(_flash_pairs((o, lse), args, args_ref),
                                label, worst)
    print("  worst abs error " + " ".join(
        f"{FLASH[n][0]} {e:.3e}" for n, e in worst.items()))
    return worst


def _train_cfg(dtype, **kw):
    return TransformerConfig(**TRAIN, dtype=dtype, **kw)


def _leaf_errors(grads, want, relative_norm: bool):
    """Per leaf of two gradient trees: the largest difference over the
    largest value, or the relative Frobenius difference."""
    out = []
    for a, b in zip(_leaves(grads), _leaves(want)):
        a, b = a.float(), b.float()
        if relative_norm:
            out.append(((a - b).norm() / b.norm().clamp_min(1e-30)).item())
        else:
            out.append(((a - b).abs().max()
                        / b.abs().max().clamp_min(1e-30)).item())
    return out


def phase_train_parity_f32(dev, cfg=None) -> None:
    """One SGD step's loss and gradients at full width, batch 2, f32:
    flash (K1-K3) against the reference attention (``cfg``: the training
    main path's by default; phase 28 passes its MoE config)."""
    cfg = cfg or _train_cfg(torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    inp, tgt = (t[:2] for t in train_batch(cfg.vocab, dev))
    zero_launches()
    loss_f, g_f = loss_and_grads(params, inp, tgt, cfg)
    launches = dict(fa.LAUNCHES)
    loss_r, g_r = loss_and_grads(
        params, inp, tgt, dataclasses.replace(cfg, attn_impl="reference"))
    rel = abs(loss_f.item() - loss_r.item()) / abs(loss_r.item())
    errs = _leaf_errors(g_f, g_r, relative_norm=False)
    print(f"  loss flash {loss_f.item():.6f} reference {loss_r.item():.6f} "
          f"rel err {rel:.3e} (limit {TRAIN_F32_LOSS:.0e}); worst grad leaf "
          f"{max(errs):.3e} of its max (limit {TRAIN_F32_GRAD:.0e}) over "
          f"{len(errs)} leaves; launches {launches}")
    _require(rel <= TRAIN_F32_LOSS and max(errs) <= TRAIN_F32_GRAD,
             f"f32 flash training disagrees with the reference: loss rel "
             f"{rel}, grad {max(errs)}")
    want = cfg.n_layers
    _require(launches == {"flash_fwd": want, "flash_bwd_dq": want,
                          "flash_bwd_dkv": want, "flash_bwd_fused": 0},
             f"f32 step launched {launches}")


def _attn_grad_errors(grads, want) -> list:
    """Relative Frobenius difference of every layer's wq, wk, wv and wo
    gradient."""
    return [((a[k].float() - b[k].float()).norm()
             / b[k].float().norm().clamp_min(1e-30)).item()
            for a, b in zip(grads["layers"], want["layers"])
            for k in ("wq", "wk", "wv", "wo")]


def _oracle_readings(params, inp, tgt, cfg) -> dict:
    """The main path's first-step loss and attention gradients
    (``cfg``, K1-K3) against the reference attention's on the same
    batch, and the same two readings for two broken attentions (the
    controls): the output zeroed (``wo`` = 0) and far keys dropped (a
    window of L/2)."""
    ref = dataclasses.replace(cfg, attn_impl="reference")
    loss_r, g_r = loss_and_grads(params, inp, tgt, ref)
    loss_f, g_f = loss_and_grads(params, inp, tgt, cfg)
    loss_w, g_w = loss_and_grads(
        params, inp, tgt, dataclasses.replace(ref, attn_window=SEQ // 2))
    no_attn = {**params, "layers": [{**lp, "wo": torch.zeros_like(lp["wo"])}
                                    for lp in params["layers"]]}
    with torch.no_grad():
        loss_z = nll_loss(forward_dense(no_attn, inp, ref), tgt)

    def rel(x):
        return abs(x.item() - loss_r.item()) / abs(loss_r.item())

    return {"loss_oracle": loss_r.item(), "loss_rel": rel(loss_f),
            "attn_grad_rel": max(_attn_grad_errors(g_f, g_r)),
            "ctrl_window_loss_rel": rel(loss_w),
            "ctrl_window_attn_grad_rel": max(_attn_grad_errors(g_w, g_r)),
            "ctrl_zero_loss_rel": rel(loss_z)}


def _changes(params, init) -> list:
    """Each leaf's change from ``init`` (its values before the steps),
    in f32."""
    return [a.float() - b.float() for a, b in zip(_leaves(params), init)]


def _reference_changes(cfg, inp, tgt, steps, zero_wo=False, **kw):
    """(each leaf's change, the losses) over ``steps`` SGD steps (lr LR,
    in place) from the seed-0 init on the main path's batch, with the
    reference attention (``kw`` replaces fields of its config);
    ``zero_wo`` zeroes every layer's ``wo`` first, so the attention's
    output is dropped."""
    ref = dataclasses.replace(cfg, attn_impl="reference", **kw)
    params = init_params(ref, seed=0, device=inp.device)
    if zero_wo:
        for lp in params["layers"]:
            lp["wo"].zero_()
    init = [p.clone() for p in _leaves(params)]
    step = make_train_step(ref, lr=LR, donate=True)
    losses = []
    for _ in range(steps):
        params, loss = step(params, inp, tgt)
        losses.append(loss.item())
    return _changes(params, init), losses


def _update_errors(got, want) -> list:
    """Each leaf's relative Frobenius difference of ``got``'s change
    from ``want``'s: None for a leaf that changed in neither run (the
    norms' gains: lr * g stays under half a bf16 ulp of 1), infinite
    for one that changed only in ``got``."""
    out = []
    for a, b in zip(got, want):
        d, nb = (a - b).norm().item(), b.norm().item()
        out.append(None if d == 0.0 and nb == 0.0
                   else d / nb if nb > 0.0 else float("inf"))
    return out


def _update_error(got, want) -> tuple[float, int]:
    """(worst leaf's :func:`_update_errors`, leaves compared)."""
    errs = [e for e in _update_errors(got, want) if e is not None]
    return max(errs, default=0.0), len(errs)


def _leaf_names(tree, prefix: str = "") -> list:
    """Each leaf's path in :func:`_leaves` order (``layers.3.be2``)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _worst_leaf(got, want, names) -> tuple[float, str, int]:
    """(worst leaf's :func:`_update_errors`, its name, leaves
    compared)."""
    errs = [(e, n) for e, n in zip(_update_errors(got, want), names)
            if e is not None]
    worst = max(errs, default=(0.0, ""))
    return worst[0], worst[1], len(errs)


def phase_train_bf16(dev):
    """The training main path. Returns (launches, report, params,
    batch) for phase 15."""
    cfg = _train_cfg(torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    init = [p.clone() for p in _leaves(params)]
    n_params = sum(p.numel() for p in _leaves(params))
    inp, tgt = train_batch(cfg.vocab, dev)
    oracle = _oracle_readings(params, inp, tgt, cfg)
    step = make_train_step(cfg, lr=LR, donate=True)
    timed = 5
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    params, loss0 = step(params, inp, tgt)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = []
    for _ in range(timed):
        params, loss = step(params, inp, tgt)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / timed
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = timed + 1
    want = {"flash_fwd": cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps, "flash_bwd_fused": 0,
            K5: 0, K6: 0, K7: 0, SAMPLE: 0}
    print(f"  {steps} steps (1 warm-up, {timed} timed), launches "
          f"{ {FLASH.get(k, (k,))[0]: v for k, v in launches.items()} }")
    _require(launches == want, f"main path launched {launches}, want {want}")
    traj = [loss0.item()] + [x.item() for x in losses]
    loss_first, loss_last = traj[0], traj[-1]
    loss_oracle = oracle["loss_oracle"]
    rel = abs(loss_first - loss_oracle) / abs(loss_oracle)
    print(f"  against the reference attention: first loss rel err "
          f"{rel:.3e} (limit {TRAIN_BF16_ORACLE:.0e}), worst attention "
          f"gradient leaf {oracle['attn_grad_rel']:.3e} (limit "
          f"{TRAIN_BF16_ATTN_GRAD:.0e}); controls: attention zeroed, loss "
          f"{oracle['ctrl_zero_loss_rel']:.3e}; window L/2, loss "
          f"{oracle['ctrl_window_loss_rel']:.3e}, attention gradient "
          f"{oracle['ctrl_window_attn_grad_rel']:.3e}")
    _require(bool(np.isfinite(traj).all()), f"non-finite loss: {traj}")
    got = _changes(params, init)
    del init
    want, ref_traj = _reference_changes(cfg, inp, tgt, steps)
    upd, n_leaves = _update_error(got, want)
    del got
    ctrl_zero = _update_error(
        _reference_changes(cfg, inp, tgt, steps, zero_wo=True)[0], want)[0]
    ctrl_window = _update_error(
        _reference_changes(cfg, inp, tgt, steps, attn_window=SEQ // 2)[0],
        want)[0]
    del want
    print(f"  losses {traj}; with the reference attention {ref_traj}")
    print(f"  each leaf's change over the {steps} steps against the "
          f"reference attention's: worst leaf {upd:.3e} relative (limit "
          f"{TRAIN_BF16_UPDATE}) over {n_leaves} changed leaves; controls: "
          f"wo zeroed {ctrl_zero:.3e}, window L/2 {ctrl_window:.3e}")
    _require(upd <= TRAIN_BF16_UPDATE,
             f"the update leaves the reference attention's: {upd}")
    _require(min(ctrl_zero, ctrl_window) > TRAIN_BF16_UPDATE,
             f"a broken attention's update passes the limit: zeroed "
             f"{ctrl_zero}, window {ctrl_window}")
    _require(rel <= TRAIN_BF16_ORACLE,
             f"first loss {loss_first} vs the reference-attention oracle "
             f"{loss_oracle}: rel err {rel}")
    _require(oracle["attn_grad_rel"] <= TRAIN_BF16_ATTN_GRAD,
             f"attention gradients vs the reference attention's: "
             f"{oracle['attn_grad_rel']}")
    _require(min(oracle["ctrl_zero_loss_rel"],
                 oracle["ctrl_window_loss_rel"]) > TRAIN_BF16_ORACLE
             and oracle["ctrl_window_attn_grad_rel"] > TRAIN_BF16_ATTN_GRAD,
             f"a broken attention passes the oracle limits: {oracle}")
    raw = raw_matmul_tflops(dev)
    flops = model_flops_per_step(cfg, BATCH, SEQ)
    rep = {
        "ms_per_step": dt * 1e3,
        "tokens_per_s": BATCH * SEQ / dt,
        "model_tflops_per_s": flops / dt / 1e12,
        "mfu_vs_raw_matmul": flops / dt / 1e12 / raw,
        "raw_bf16_tflops_per_s": raw,
        "params_m": n_params / 1e6,
        "loss_first": loss_first,
        "loss_trajectory": traj,
        "loss_trajectory_reference_attention": ref_traj,
        "update_rel_err": upd,
        "ctrl_zero_update_rel_err": ctrl_zero,
        "ctrl_window_update_rel_err": ctrl_window,
        "loss_last": loss_last,
        "loss_oracle": loss_oracle,
        "loss_vs_oracle_rel_err": rel,
        "attn_grad_vs_oracle_rel_err": oracle["attn_grad_rel"],
        "ctrl_zero_loss_rel_err": oracle["ctrl_zero_loss_rel"],
        "ctrl_window_loss_rel_err": oracle["ctrl_window_loss_rel"],
        "ctrl_window_attn_grad_rel_err": oracle["ctrl_window_attn_grad_rel"],
        "warmup_step_s": warm_s,
        "peak_mem_gb": peak / 1e9,
    }
    print(f"  {rep['ms_per_step']:.2f} ms/step, {rep['tokens_per_s']:.1f} "
          f"tokens/s, {rep['model_tflops_per_s']:.2f} model TFLOP/s, MFU "
          f"{rep['mfu_vs_raw_matmul']:.4f} of a raw bf16 matmul chain at "
          f"{raw:.1f} TFLOP/s; {rep['params_m']:.1f} M params")
    print(f"  loss {loss_first:.5f} -> {loss_last:.5f}; oracle "
          f"{loss_oracle:.5f}; warm-up step {warm_s:.2f} s; peak "
          f"memory {rep['peak_mem_gb']:.3f} GB")
    return launches, rep, params, (inp, tgt)


def phase_fused_bf16(params, batch):
    """One step's gradients through the fused backward (K4) against
    the split backward (K2, K3), bf16 at full width. Returns the fused
    step's launches."""
    cfg = _train_cfg(torch.bfloat16)
    inp, tgt = batch
    zero_launches()
    loss_f, g_f = loss_and_grads(params, inp, tgt,
                                 dataclasses.replace(cfg, flash_bwd="fused"))
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "flash_bwd_fused": cfg.n_layers,
            K5: 0, K6: 0, K7: 0, SAMPLE: 0}
    _require(launches == want, f"fused step launched {launches}")
    loss_s, g_s = loss_and_grads(params, inp, tgt, cfg)
    errs = _leaf_errors(g_f, g_s, relative_norm=True)
    print(f"  K4 {launches['flash_bwd_fused']} launches, K2 0, K3 0; loss "
          f"{loss_f.item():.5f} (split {loss_s.item():.5f}); worst grad "
          f"leaf relative difference {max(errs):.3e} (limit "
          f"{FUSED_BF16_GRAD:.0e}, used {max(errs) / FUSED_BF16_GRAD:.3f}) "
          f"over {len(errs)} leaves")
    _require(loss_f.item() == loss_s.item(),
             "the same forward gave another loss")
    _require(max(errs) <= FUSED_BF16_GRAD,
             f"fused and split gradients differ: {max(errs)}")
    return launches


def phase_flash_bench_shape(dev) -> tuple[dict, dict]:
    """K1-K4 at the bench shape, the main path's (bf16, B=8, L=2048,
    H=8, D=128, causal): each held against its plain version on the same
    inputs (f32 copies) as in phase 12, a bf16-only control of K2 and K3
    that must exceed the limit, then us per launch beside the
    plain versions and SDPA's forward (for K1) and backward (for K2+K3
    and for K4, since one call computes dq, dk and dv together). Inputs
    are 168 MB, past L2. Returns (largest abs error, timing row) per
    kernel."""
    H = TRAIN["n_heads"]
    B, L, D = BATCH, SEQ, TRAIN["d_model"] // H
    gen = torch.Generator().manual_seed(13)
    q3, k3, v3, do3 = (torch.randn(B * H, L, D, generator=gen)
                       .to(torch.bfloat16).to(dev) for _ in range(4))
    meta = (D ** -0.5, True, None, 1)
    o, lse = fa._fwd(q3, k3, v3, *meta)
    args = (q3, k3, v3, do3, lse, fa._delta(do3, o)) + meta
    args_ref = tuple(t.float() for t in (q3, k3, v3, do3)) + args[4:]
    errs = {name: 0.0 for name in FLASH}
    _hold_flash(_flash_pairs((o, lse), args, args_ref),
                f"B={B} L={L} H={H} Hkv={H} D={D} bf16 causal=1 "
                "window=None", errs)
    print("  abs error " + " ".join(f"{FLASH[n][0]} {e:.3e}"
                                    for n, e in errs.items()))
    ctl = _bf16_only_control(args_ref)
    print("  control, P and dS in bf16 alone (must exceed 1): limit used "
          + " ".join(f"{n} {u:.2f}" for n, u in ctl.items()))
    _require(min(ctl.values()) > 1.0,
             f"FLASH_GRAD cannot tell bf16-only P and dS: {ctl}")
    del args_ref
    # K4's f32 route (the key-major FMA kernel) on f32 copies
    f32 = tuple(t.float() for t in (q3, k3, v3, do3))
    o32, lse32 = fa._fwd(*f32[:3], *meta)
    args32 = f32 + (lse32, fa._delta(f32[3], o32)) + meta
    _hold_flash({"flash_bwd_fused": list(zip(fa._bwd_fused_grads(*args32),
                                             fa._bwd_fused_ref(*args32)))},
                f"B={B} L={L} H={H} Hkv={H} D={D} f32  causal=1 "
                "window=None", errs)
    del f32, o32, lse32, args32
    torch.cuda.empty_cache()
    calls = {"flash_fwd": (fa._fwd, fa._fwd_ref, (q3, k3, v3) + meta),
             "flash_bwd_dq": (fa._bwd_dq, fa._bwd_dq_ref, args),
             "flash_bwd_dkv": (fa._bwd_dkv, fa._bwd_dkv_ref, args),
             "flash_bwd_fused": (fa._bwd_fused_grads, fa._bwd_fused_ref,
                                 args)}
    qh, kh, vh, doh = (t.view(B, H, L, D) for t in (q3, k3, v3, do3))
    sdpa_fwd = _time_ms(lambda i: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True), 20, n_warm=3)
    qg, kg, vg = (t.clone().requires_grad_() for t in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd = _time_ms(lambda i: torch.autograd.grad(
        out, (qg, kg, vg), doh, retain_graph=True), 20, n_warm=3)
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
               "flash_bwd_dkv": sdpa_bwd, "flash_bwd_fused": sdpa_bwd}
    bounds = flash_bounds(B=B, L=L, H=H, D=D)
    rows = {}
    for name, (kern, plain, a) in calls.items():
        ms = _time_ms(lambda i: kern(*a), 10, n_warm=2)
        plain_ms = _time_ms(lambda i: plain(*a), 3, n_warm=1)
        bnd = bounds[FLASH[name][0]]
        rows[name] = {"ms": ms, "plain_ms": plain_ms,
                      "library_ms": library[name],
                      "bound_ms": bnd["bound_ms"],
                      "bound_by": bnd["bound_by"]}
        hi_lo = ""
        if "hi_lo_bound_ms" in bnd:  # the bf16 tensor-core kernels
            hi_lo = (f", hi/lo tensor work {bnd['hi_lo_bound_ms'] * 1e3:.2f}"
                     f" us ({ms / bnd['hi_lo_bound_ms']:.1f}x)")
        print(f"  {FLASH[name][0]} {ms * 1e3:.1f} us/launch (first design "
              f"{OLD_US[FLASH[name][0]]} us), bound "
              f"{bnd['bound_ms'] * 1e3:.2f} us ({bnd['ops']} ops at 989 "
              f"TFLOP/s; {bnd['bytes']} B at 3.35 TB/s), "
              f"{ms / bnd['bound_ms']:.1f}x{hi_lo}; plain "
              f"{plain_ms * 1e3:.1f} us; "
              f"SDPA {'forward' if name == 'flash_fwd' else 'backward'} "
              f"{library[name] * 1e3:.1f} us")
    return errs, rows


def _hold_attrib(got, want, mode, label) -> float:
    """Hold a K7 output against its plain version: ``dma`` exactly
    (integer sums in f32), the others within ATTRIB_TOL of the largest
    value plus ATTRIB_TOL relative. Returns the max abs error."""
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = diff.max().item()
    if mode == "dma":
        used = 0.0 if err == 0 else float("inf")
    else:
        lim = ATTRIB_TOL * want.abs().max() + ATTRIB_TOL * want.abs()
        used = (diff / lim.clamp_min(1e-30)).max().item()
    ok = bool(torch.isfinite(got).all()) and used <= 1.0
    print(f"  {label} K7 {mode:9s} max_abs_err={err:.3e} limit used "
          f"{used:.3f} {'ok' if ok else 'FAIL'}")
    _require(ok, f"K7 {mode} disagrees with its plain version: {label} "
                 f"err={err} limit used {used}")
    return err


def phase_attrib_vs_plain(dev) -> tuple[float, float]:
    """K7's four variants and K5 in positional mode against their plain
    versions on K5's split grid: bf16 and f32 q, (B, L, block_k) in
    ATTRIB_CASES (the last with a short last chunk and segment). K5 at
    two sets of positions, the second leaving whole chunks empty, each
    with and without a window whose lower edge cuts a chunk. Returns
    the largest abs errors (K7, K5)."""
    gen = torch.Generator().manual_seed(17)
    H, Hkv, D = DECODE["n_heads"], DECODE["n_kv_heads"], 128
    scale = D ** -0.5
    worst7 = worst5 = 0.0
    for B, L, bk in ATTRIB_CASES:
        cache = _cache(B, L, Hkv, D, gen, dev)
        q32 = torch.randn(B, 1, H, D, generator=gen).to(dev)
        positions = (
            torch.tensor([L - 1, 0, L // 2, 37][:B], dtype=torch.int32,
                         device=dev),
            torch.tensor([L // 3, 5, L - 2, 100][:B], dtype=torch.int32,
                         device=dev))
        chunk5, n5 = da.split_plan(B, Hkv, L, n_sm=da.sm_count(dev))
        chunk7, n7 = da.split_plan(B, Hkv, L, bk, n_sm=da.sm_count(dev))
        print(f"  B={B} L={L}: K5 {n5} splits of {chunk5} keys, K7 {n7} of "
              f"{chunk7} (block_k {bk}); K5 window {K5_CUT_WINDOW[L]}")
        for dt in (torch.bfloat16, torch.float32):
            q = q32.to(dt)
            label = f"B={B} L={L:5d} bk={bk:4d} {str(dt):14s}"
            for mode in da.ATTRIB_MODES:
                got = da.decode_attention_attrib(q, cache, positions[0],
                                                 scale, mode, bk)
                want = da.decode_attention_attrib_ref(
                    q.float(), cache, positions[0], scale, mode, bk)
                worst7 = max(worst7, _hold_attrib(got, want, mode, label))
            for i, pos in enumerate(positions):
                for kw in ({}, {"window": K5_CUT_WINDOW[L]}):
                    got = da.quantized_decode_attention(q, cache, pos, scale,
                                                        **kw)
                    want = da.quantized_decode_attention_ref(
                        q.float(), cache, pos, scale, **kw)
                    worst5 = max(worst5, _hold(
                        got, want, dt,
                        f"{label} K5 pos set {i} {str(kw):16s}"))
    return worst7, worst5


def phase_k5_graph(dev) -> None:
    """One K5 call (B=1, L=16384: 64 splits, so the wrapper allocates
    its scratch) under CUDA-graph capture."""
    gen = torch.Generator().manual_seed(23)
    H, Hkv, D, L = DECODE["n_heads"], DECODE["n_kv_heads"], 128, LONG_PROMPT
    cache = _cache(1, L, Hkv, D, gen, dev)
    q = torch.randn(1, 1, H, D, generator=gen).to(torch.bfloat16).to(dev)
    pos = torch.tensor([L - 1], dtype=torch.int32, device=dev)
    plan = da.split_plan(1, Hkv, L, n_sm=da.sm_count(dev))
    _capture_equals_eager(
        lambda: da.quantized_decode_attention(q, cache, pos, D ** -0.5),
        f"K5 split plan {plan}")


def _prompt(vocab, B, Tp, seed=0):
    """Prompts as the reference's decode benches draw them."""
    return np.random.default_rng(seed).integers(0, vocab, (B, Tp))


def _generate(params, prompt, n_new, cfg, dev, **kw):
    """generate_dense with every launch count set to 0 just before and
    read just after: (tokens, seconds, launches)."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    toks = td.generate_dense(params, prompt, n_new, cfg, device=dev, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    _require(tuple(toks.shape) == (len(prompt), n_new)
             and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
             f"generate_dense gave {tuple(toks.shape)} tokens or tokens "
             "outside the vocabulary")
    return toks, dt, launches


def _want_launches(launches, k1, k5, what) -> None:
    got = {n: launches[n] for n in ("flash_fwd", K5)}
    want = {"flash_fwd": k1, K5: k5}
    others = {n: v for n, v in launches.items()
              if n not in want and v}
    print(f"  {what}: K1 {got['flash_fwd']} (want {k1}), K5 {got[K5]} "
          f"(want {k5}), others {others or 0}")
    _require(got == want and not others,
             f"{what} launched {launches}, want K1 {k1}, K5 {k5}")


def phase_generate_parity_f32(dev, cfg=None) -> None:
    """Long-context generation parity at full width, f32, TF32 off: B=4,
    prompt 2048, n_new 32. The int8 streams on the kernel route (AUTO at
    B=4) and the einsum route must be identical; the f32-cache stream
    must be the argmax of forward_dense teacher-forced on prompt +
    stream, through the reference attention (no K1). ``cfg``: the decode
    rung's model by default; phase 29 passes its MoE config."""
    cfg = cfg or TransformerConfig(**DECODE, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    B, Tp, n_new = GEN_PARITY
    prompt = _prompt(cfg.vocab, B, Tp)
    streams = []
    for toggle, route in ((None, "kernel"), (False, "einsum")):
        td.use_decode_kernel(toggle)
        try:
            toks, _, launches = _generate(params, prompt, n_new, cfg, dev,
                                          quantize_kv=True)
        finally:
            td.use_decode_kernel(None)
        _want_launches(launches, cfg.n_layers,
                       cfg.n_layers * (n_new - 1) if toggle is None else 0,
                       f"int8 {route} route")
        streams.append(toks)
    same = int((streams[0] == streams[1]).all(dim=1).sum())
    print(f"  int8 streams identical on both routes: {same}/{B}")
    _require(same == B, "int8 kernel and einsum routes disagree")
    fp, _, _ = _generate(params, prompt, n_new, cfg, dev)
    full = torch.cat([torch.as_tensor(prompt, device=dev),
                      fp[:, :-1].long()], dim=1)
    # the oracle attends through the reference attention, not K1
    ref = dataclasses.replace(cfg, attn_impl="reference")
    with torch.no_grad():
        want = forward_dense(params, full, ref)[:, Tp - 1:].argmax(-1)
    agree = int((want == fp.long()).sum())
    print(f"  f32-cache stream vs teacher-forced forward_dense argmax "
          f"(reference attention): {agree}/{B * n_new} tokens")
    _require(agree == B * n_new,
             "the f32-cache stream differs from the teacher-forced argmax")
    del params


def phase_prefill_flash(dev) -> tuple[float, dict]:
    """K1 at the prefill shapes of phases 19 and 21 (bf16, B=1, H=8
    over Hkv=2, D=128, causal; L=16384 and 2048) against its plain
    version on f32 copies of the same inputs, one q head at a time (the
    plain scores of one head at 16k are 1.07 GB); then timed beside its
    bound and one SDPA forward with GQA on the same inputs (a yardstick
    only). Returns K1's largest abs error and the timing rows by L."""
    gen = torch.Generator().manual_seed(19)
    H, Hkv = DECODE["n_heads"], DECODE["n_kv_heads"]
    D, g = DECODE["d_model"] // H, H // Hkv
    worst = {"flash_fwd": 0.0}
    rows = {}
    for L in (LONG_PROMPT, SPEC_BF16[0]):
        q3, k3, v3 = (torch.randn(h, L, D, generator=gen)
                      .to(torch.bfloat16).to(dev) for h in (H, Hkv, Hkv))
        meta = (D ** -0.5, True, None)
        o, lse = fa._fwd(q3, k3, v3, *meta, g)
        pairs = []
        for h in range(H):
            want = fa._fwd_ref(q3[h:h + 1].float(), k3[h // g:h // g + 1]
                               .float(), v3[h // g:h // g + 1].float(),
                               *meta, 1)
            pairs += [(o[h:h + 1], want[0]), (lse[h:h + 1], want[1])]
        _hold_flash({"flash_fwd": pairs},
                    f"B=1 L={L} H={H} Hkv={Hkv} D={D} bf16 causal=1 "
                    "window=None", worst)
        del pairs
        ms = _time_ms(lambda i: fa._fwd(q3, k3, v3, *meta, g), 10, n_warm=2)
        qh, kh, vh = (t[None] for t in (q3, k3, v3))
        lib = _time_ms(lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True), 10, n_warm=2)
        bnd = flash_bounds(B=1, L=L, H=H, D=D, Hkv=Hkv)["K1"]
        rows[L] = {"ms": ms, "library_ms": lib, "bound_ms": bnd["bound_ms"],
                   "bound_by": bnd["bound_by"]}
        print(f"  K1 L={L}: {ms * 1e3:.1f} us/launch, bound "
              f"{bnd['bound_ms'] * 1e3:.2f} us ({bnd['ops']} ops at 989 "
              f"TFLOP/s), {ms / bnd['bound_ms']:.2f}x; SDPA forward with GQA "
              f"{lib * 1e3:.1f} us ({ms / lib:.2f}x)")
    return worst["flash_fwd"], rows


def phase_long_context_bf16(dev):
    """The long-context main path at bench_decode's shape (bf16, B=1,
    prompt 16384): prefill alone, then decode ms/token by slope over
    SLOPE_STEPS for the bf16 cache, int8 under AUTO (einsum at B=1) and
    int8 with K5 forced; then int8 AUTO at B=4 (K5 routed), by slope
    too. Each variant's first call is a short warm-up run, as the
    reference compiles before it times. Every run sets the launch
    counts to 0 just before it and reads them just after. Returns the
    report."""
    cfg = TransformerConfig(**DECODE, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    Tp, n1 = LONG_PROMPT, LONG_NEW
    prompt = _prompt(cfg.vocab, 1, Tp)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tp = torch.as_tensor(prompt, device=dev)
    cache0 = td.init_cache(cfg, 1, Tp + n1, device=dev)
    prefill_s = None
    with torch.no_grad():
        for _ in range(2):  # the first one warms up
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            logits, _ = td.prefill_dense(params, tp, cache0, cfg)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            _want_launches(launch_counts(), cfg.n_layers, 0, "prefill")
            _require(bool(torch.isfinite(logits[:, -1]).all()),
                     "non-finite prefill logits")
            del logits
    del cache0
    totals, streams = {}, {}
    B4 = 4
    for name, B, q8, toggle in (("bf16", 1, False, None),
                                ("int8", 1, True, None),
                                ("int8_kernel", 1, True, True),
                                ("int8_b4", B4, True, None)):
        kernel = bool(toggle) or B >= td.KERNEL_MIN_BATCH
        pr = _prompt(cfg.vocab, B, Tp)
        td.use_decode_kernel(toggle)
        try:
            # a short warm-up on the n1 run's cache length (one the
            # block picker accepts, so the forced route takes K5), then
            # the pair
            for nn in (4, n1, n1 + SLOPE_STEPS):
                toks, dt, launches = _generate(
                    params, pr, nn, cfg, dev, quantize_kv=q8,
                    max_len=Tp + max(nn, n1))
                _want_launches(
                    launches, cfg.n_layers,
                    cfg.n_layers * (nn - 1) if q8 and kernel else 0,
                    f"{name} cache, B={B}, n_new {nn}, {dt:.3f} s")
                totals[name, nn] = dt
        finally:
            td.use_decode_kernel(None)
        streams[name] = toks
    slope = {name: (totals[name, n1 + SLOPE_STEPS] - totals[name, n1])
             / SLOPE_STEPS * 1e3 for name in streams}
    agree = {name: int((streams[name] == streams["bf16"]).sum())
             for name in ("int8", "int8_kernel")}
    peak = torch.cuda.max_memory_allocated(dev)
    cache_mb = (2 * cfg.n_layers * (Tp + n1) * cfg.kv_heads * cfg.head_dim
                * 2 / 2 ** 20)
    rep = {
        "metric": "decode-rung",
        "prompt_len": Tp,
        "n_new": n1,
        "batch": 1,
        "n_kv_heads": cfg.kv_heads,
        "kv_cache_mib": cache_mb,
        "kv_cache_vs_mha": cfg.kv_heads / cfg.n_heads,
        "prefill_s": prefill_s,
        "prefill_tokens_per_s": Tp / prefill_s,
        "generate_total_s": totals["bf16", n1],
        "decode_ms_per_token": slope["bf16"],
        "decode_tokens_per_s": 1e3 / slope["bf16"],
        "kv_cache_mib_int8": cache_mb * (1 + 4 / cfg.head_dim) / 2,
        "decode_ms_per_token_int8": slope["int8"],
        "int8_decode_speedup": slope["bf16"] / slope["int8"],
        "decode_ms_per_token_int8_kernel": slope["int8_kernel"],
        "decode_slope_steps": SLOPE_STEPS,
        "chains_min_of": 1,
        "int8_b4_generate_total_s": totals["int8_b4", n1],
        "int8_b4_decode_ms_per_step": slope["int8_b4"],
        "tokens_equal_to_bf16_stream": agree,
        "peak_mem_gb": peak / 1e9,
    }
    print(f"  prefill {prefill_s:.3f} s ({rep['prefill_tokens_per_s']:.0f} "
          f"tokens/s); decode ms/token by slope: bf16 {slope['bf16']:.3f}, "
          f"int8 {slope['int8']:.3f}, int8 + K5 {slope['int8_kernel']:.3f};"
          f" B=4 int8 AUTO (K5) {slope['int8_b4']:.3f} ms/step; peak "
          f"{rep['peak_mem_gb']:.2f} GB; tokens equal to the bf16-cache "
          f"stream {agree} of {n1 + SLOPE_STEPS}")
    del params
    return rep


def phase_attribution(dev):
    """The port's attribution bench (K7) at its shapes: the flagship
    with all variants, then B=4 and B=8 with the full kernel. Launch
    counts set to 0 just before, read just after: they hold the eager
    calls that ran (the graph replays timed beside them are not
    counted). Every variant at or above its byte bound, beside its first
    design's time; SDPA over the dequantised cache at each batch.
    Returns (flagship result, K7 launches, plain and SDPA times, SDPA
    time by batch)."""
    torch.cuda.empty_cache()
    zero_launches()
    results = attrib.main()
    calls = launch_counts()
    print(f"  launches {{K5: {calls[K5]}, K7: {calls[K7]}}} (eager calls; "
          f"{results[0]['graph_replays']} replays per variant of a graph of "
          f"{attrib.INNER} calls not counted)")
    H, Hkv, D, L = DECODE["n_heads"], DECODE["n_kv_heads"], 128, LONG_PROMPT
    scale, g = D ** -0.5, H // Hkv
    sdpa = {}
    for r in results:
        B = int(r["shape"].split()[0][2:])
        q, cache = attrib.inputs(B, L, H, Hkv, D, dev)
        kd, vd = ((cache[n].to(torch.bfloat16) * cache[n + "_s"][..., None]
                   .to(torch.bfloat16)).repeat_interleave(g, 2)
                  .transpose(1, 2).contiguous() for n in ("k", "v"))
        qh = q.transpose(1, 2).contiguous()
        # as a graph of calls, like the bench's kernel times
        sdpa[B] = _graph_ms(lambda i: F.scaled_dot_product_attention(
            qh, kd, vd, scale=scale), 20)
        del kd, vd
        keys = ["kernel_full_ms"] + (list(attrib.VARIANTS.values())
                                     if "kernel_dma_ms" in r else [])

        def old(k, B=B):
            if k == "kernel_full_ms":
                return OLD_US[f"K5 B={B}"]
            return OLD_US[next(m for m, v in attrib.VARIANTS.items()
                               if v == k)]

        print(f"  {r['shape']}: bound {r['bound_ms'] * 1e3:.2f} us; "
              + ", ".join(f"{k[:-3]} {r[k] * 1e3:.2f} us (first design "
                          f"{old(k)})" for k in keys)
              + f"; einsum bf16 {r['einsum_bf16_ms'] * 1e3:.2f} us, int8 "
              f"{r['einsum_int8_ms'] * 1e3:.2f} us; kernel_vs_bf16 "
              f"{r['kernel_vs_bf16']:.3f}; SDPA over the dequantised cache "
              f"{sdpa[B] * 1e3:.2f} us (K5 {r['kernel_full_ms'] / sdpa[B]:.2f}x)")
        for k in keys:
            _require(r[k] >= r["bound_ms"],
                     f"{r['shape']} {k} {r[k]} ms is under its byte bound "
                     f"{r['bound_ms']} ms: it moved less than the cache")
    _require(calls[K7] > 0, "the bench never ran K7")
    q, cache = attrib.inputs(1, L, H, Hkv, D, dev)
    plain = _time_ms(lambda i: da.decode_attention_attrib_ref(
        q, cache, L - 1, scale, "full_nosm", 4096), 5, n_warm=1)
    print(f"  full_nosm plain version {plain * 1e3:.1f} us")
    return results, calls[K7], {"plain_ms": plain, "library_ms": sdpa[1]}, sdpa


def phase_speculative(dev):
    """Speculative decoding: in f32 (TF32 off), prompt 512, n_new 64,
    both drafters' streams equal generate_dense's; in bf16 at
    bench_spec_decode's shape (prompt 2048, n_new 256, k 4), the
    reference's keys for both drafters. Returns the bf16 report."""
    k = SPEC_K
    cfg = TransformerConfig(**DECODE, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    Tp, n_new = SPEC_F32
    prompt = _prompt(cfg.vocab, 1, Tp)
    greedy, _, _ = _generate(params, prompt, n_new, cfg, dev)
    for dl in (None, SPEC_DRAFT_LAYERS):
        toks, fwd = generate_speculative_dense(params, prompt, n_new, cfg,
                                               k=k, draft_layers=dl,
                                               device=dev)
        same = bool(torch.equal(toks.to(greedy.dtype), greedy))
        print(f"  f32, drafter {dl or 'n-gram'}: stream equal to "
              f"generate_dense: {same}, {fwd} verify forwards for "
              f"{n_new - 1} decoded tokens")
        _require(same, f"f32 speculative stream (draft_layers={dl}) "
                       "differs from generate_dense")
    del params
    cfg = TransformerConfig(**DECODE, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    Tp, n_new = SPEC_BF16
    prompt = _prompt(cfg.vocab, 1, Tp)
    _generate(params, prompt, 8, cfg, dev)  # warm-up
    greedy, greedy_s, _ = _generate(params, prompt, n_new, cfg, dev)
    rep = {"metric": "spec-decode-rung", "prompt_len": Tp, "n_new": n_new,
           "draft_k": k, "greedy_total_s": greedy_s}
    for dl in (None, SPEC_DRAFT_LAYERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, fwd = generate_speculative_dense(params, prompt, n_new, cfg,
                                               k=k, draft_layers=dl,
                                               device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        r = {"stream_exact_vs_greedy": bool(torch.equal(
                 toks.to(greedy.dtype), greedy)),
             "verify_forwards": fwd,
             "tokens_per_forward": (n_new - 1) / max(fwd, 1),
             "spec_total_s": dt, "spec_speedup": greedy_s / dt}
        _require(tuple(toks.shape) == (1, n_new) and 0 < fwd < n_new,
                 f"speculative run gave {tuple(toks.shape)} tokens in {fwd} "
                 "forwards")
        print(f"  bf16, drafter {dl or 'n-gram'}: {r}")
        if dl is None:
            rep.update(r)
        else:
            rep["model_draft"] = {"draft_layers": dl, **r}
    del params
    return rep


# phase 22: a kmap2-style pool run on CUDA streams (test/kmap2.jl:32-54
# at n=8 with nwait=6); workers 3 and 6 stall 20 ms before every task
POOL_N, POOL_EPOCHS, POOL_NWAIT = 8, 100, 6
POOL_SLOW, POOL_DELAY_S = (3, 6), 0.02
# phases 24-26: the injected delays are cut from the reference benches'
# 1-5 s to 0.5 s and config 5's epochs from 10 to 5 (PERF.md §4); no
# shape is cut
CODED_DELAY_S, CONFIG5_EPOCHS = 0.5, 5
# phase 28: timed MoE steps after the warm-up (the reference's chains
# take 4); phase 30: coded and bulk epochs (bench/coded_train.py)
MOE_STEPS, CODED_EPOCHS = 5, 3


def _pool_kmap2(dev) -> dict:
    tasks = {}  # worker -> tasks it ran (the reference worker's t)

    def work(i, payload, epoch):
        tasks[i] = tasks.get(i, 0) + 1
        z = payload[:1] * 0
        return torch.cat([z + (i + 1), z + tasks[i], payload[:1]])

    backend = CUDADeviceBackend(
        work, POOL_N, devices=[dev],
        delay_fn=lambda i, e: POOL_DELAY_S if i in POOL_SLOW else 0.0)
    try:
        pool = AsyncPool(POOL_N)
        sendbuf = np.zeros(1)
        recvbuf = np.zeros(3 * POOL_N)
        stale = 0
        t0 = time.perf_counter()
        for epoch in range(1, POOL_EPOCHS + 1):
            sendbuf[0] = epoch
            repochs = asyncmap(pool, sendbuf, backend, recvbuf,
                               nwait=POOL_NWAIT)
            chunks = recvbuf.reshape(POOL_N, 3)
            heard = np.flatnonzero(repochs > 0)
            _require(all(chunks[i][0] == i + 1 and chunks[i][2] == repochs[i]
                         for i in heard),
                     f"epoch {epoch}: an echo disagrees with repochs")
            _require(int((repochs == epoch).sum()) >= POOL_NWAIT,
                     f"epoch {epoch}: fewer than {POOL_NWAIT} fresh")
            stale += int((repochs[list(POOL_SLOW)] < epoch).sum())
        ms = (time.perf_counter() - t0) * 1e3 / POOL_EPOCHS
        _require(all(r is not None and r.device.type == "cuda"
                     for r in pool.results), "a result is not on the card")
        slow_tasks = [tasks[i] for i in POOL_SLOW]
        # stale at most epochs, and re-tasked on every stale arrival
        _require(stale > 0 and all(1 < t < POOL_EPOCHS for t in slow_tasks),
                 f"slowed workers ran {slow_tasks} tasks, stale {stale}")
        waitall(pool, backend, timeout=30)
        _require(not pool.active.any(), "waitall left workers active")
        slow = POOL_SLOW[0]
        for epoch in range(POOL_EPOCHS + 1, POOL_EPOCHS + 11):
            repochs = asyncmap(pool, sendbuf, backend, epoch=epoch,
                               nwait=lambda e, r: r[slow] == e)
            _require(repochs[slow] == epoch,
                     "the functional nwait returned before its worker")
        waitall(pool, backend, timeout=30)
        _require(not pool.active.any(), "waitall left workers active")
        return {"ms_per_epoch": ms, "stale_arrivals_of_slowed": stale,
                "tasks_of_slowed": slow_tasks,
                "tasks_of_fast": tasks[0]}
    finally:
        backend.shutdown()


def _pool_cuda_snapshot(dev) -> None:
    """A 64 MB CUDA sendbuf overwritten on the current stream right after
    asyncmap returns: the worker still out (gated) reads its own copy."""
    gate = threading.Event()

    def delay(i, epoch):
        if i == 1 and not gate.wait(60):
            raise TimeoutError("gate never opened")
        return 0.0

    backend = CUDADeviceBackend(lambda i, p, e: p[-2:].clone(), 2,
                                devices=[dev], delay_fn=delay)
    try:
        pool = AsyncPool(2)
        big = torch.ones(1 << 24, device=dev)
        asyncmap(pool, big, backend, nwait=1)
        _require(bool(pool.active[1]), "the gated worker was not out")
        big.fill_(99.0)
        gate.set()
        waitall(pool, backend, timeout=60)
        got = pool.results[1].cpu()
        _require(torch.equal(got, torch.ones(2)),
                 f"a write after asyncmap reached a worker's copy: {got}")
    finally:
        backend.shutdown()


def phase_pool_streams(dev) -> dict:
    rep = _pool_kmap2(dev)
    _pool_cuda_snapshot(dev)
    print(f"  kmap2 on streams: {POOL_EPOCHS} epochs, {rep['ms_per_epoch']:.3f}"
          f" ms/epoch, slowed workers ran {rep['tasks_of_slowed']} tasks "
          f"(stale arrivals {rep['stale_arrivals_of_slowed']}), a fast one "
          f"{rep['tasks_of_fast']}; functional nwait, waitall, CUDA sendbuf "
          "snapshot ok")
    return rep


def _coded_line(label, r) -> None:
    print(f"  {label}: {r['ms_per_epoch']:.3f} ms/epoch, MFU "
          f"{r['mfu_vs_raw_matmul']:.3f} of a raw torch.matmul, rel err "
          f"{r['rel_err']:.2e}" + (f", decode {r['decode_ms']:.3f} ms, "
                                    f"products {r['products_ms']:.3f} ms"
                                    if "decode_ms" in r else ""))


def phase_coded(dev) -> dict:
    """Configs 2-5 through bench/coded_gemm.py at their full shapes."""
    out = {}
    print("[23] config 2: uncoded GEMM 4096^3 f32, 4 workers, nwait=n")
    r = coded_bench.config2(dev)
    _coded_line("config 2", r)
    _require(r["ok"], f"config 2 error {r['rel_err']}")
    out["config2"] = r
    torch.cuda.empty_cache()
    print("[24] config 3: (8, 6) MDS-coded GEMM 8192^3 (A padded to 8196 "
          "rows), nwait=6")
    r = coded_bench.config3(dev, delay_s=CODED_DELAY_S)
    for name, rung in r["rungs"].items():
        _coded_line(name, rung)
    st = r["straggler_rung"]
    print(f"  per-worker, workers {st['stragglers']} delayed "
          f"{st['delay_s']} s: {st['ms_per_epoch_median']:.3f} ms/epoch "
          f"(median), decoded from {st['decoded_from']}, out at every "
          f"return {st['stragglers_out_at_return']}; nwait=n epoch "
          f"{st['nwait_n_epoch_ms']:.1f} ms, vs_baseline "
          f"{st['vs_baseline']:.2f}")
    _require(r["ok"], "config 3 failed: " + json.dumps(
        {k: v.get("ok") for k, v in r["rungs"].items()}
        | {"straggler": st["ok"]}))
    out["config3"] = r
    torch.cuda.empty_cache()
    print("[25] config 4: LT-coded GEMM 16384^2, 16 workers, k=8, workers "
          f"3 and 11 delayed {CODED_DELAY_S} s")
    r = coded_bench.config4(dev, delay_s=CODED_DELAY_S, epochs=2, chains=2,
                            raw_reps=2)
    _coded_line("config 4", r)
    print(f"  fresh at return {r['fresh_at_return']}, host peel vs device "
          f"{r['host_peel_vs_device']:.2e} ({r['host_peel_s']:.2f} s), "
          f"nwait=n epoch {r['nwait_n_epoch_ms']:.1f} ms, vs_baseline "
          f"{r['vs_baseline']:.2f}")
    _require(r["ok"], f"config 4 failed: err {r['rel_err']}, host vs "
                      f"device {r['host_peel_vs_device']}")
    out["config4"] = r
    torch.cuda.empty_cache()
    print("[26] config 5: gradient-coded SGD, synthetic 1e6 x 1024, 16 "
          f"workers, s=2, workers 2 and 9 delayed {CODED_DELAY_S} s")
    r = coded_bench.config5(dev, delay_s=CODED_DELAY_S,
                            epochs=CONFIG5_EPOCHS)
    print(f"  {r['ms_per_epoch']:.3f} ms/epoch (bound {r['bound_ms']:.3f} "
          f"ms), loss {r['loss_after_warmup']:.5f} -> "
          f"{r['loss_after_epochs']:.5f}, coded step vs full batch "
          f"{r['coded_step_vs_full_batch']:.2e}, nwait=n epoch "
          f"{r['nwait_n_epoch_ms']:.1f} ms, vs_baseline "
          f"{r['vs_baseline']:.2f}")
    _require(r["ok"], "config 5 failed: " + json.dumps(
        {k: r[k] for k in ("loss_after_warmup", "loss_after_epochs",
                           "coded_step_vs_full_batch")}))
    out["config5"] = r
    torch.cuda.empty_cache()
    return out


# phase 27: the MoE layer at the training main path's token count
# (bench/moe_train.py's experts: d_model 1024, d_ff 4096, 4 experts),
# f32 with TF32 off. Dispatch and combine move values exactly (the
# one-hot oracle's products have one 1 and zeros), so y differs from the
# oracle's only by the order of the oracle's sums: within 1e-5 of the
# largest value. The gradients of x and wg sum over seats, tokens and
# the router's softmax in other orders: within 1e-4 of the largest value
# (the reference test's bound is 2e-4 on smaller shapes)
MOE_Y_TOL, MOE_GRAD_TOL = 1e-5, 1e-4


def _moe_layer_case(dev, seed=27):
    """(x (T, D), layer params) on the card: the bench's expert shapes at
    the main path's T, the router and biases drawn nonzero."""
    rng = np.random.default_rng(seed)
    E, D, Fd = mt.MOE["n_experts"], TRAIN["d_model"], TRAIN["d_ff"]
    mp = moe.init_moe_layer(rng, D, Fd, E, TRAIN["n_layers"], torch.float32)
    mp["be1"] = torch.from_numpy(rng.standard_normal((E, Fd)) * 0.1).float()
    mp["be2"] = torch.from_numpy(rng.standard_normal((E, D)) * 0.1).float()
    x = torch.from_numpy(rng.standard_normal((BATCH * SEQ, D),
                                             dtype=np.float32))
    return x.to(dev), {k: v.to(dev) for k, v in mp.items()}


def _moe_grads(fn, x, mp, w):
    """(y, aux, d(sum(y * w))/dx, .../dwg) of ``fn(x, wg) -> (y, aux)``."""
    xg = x.clone().requires_grad_()
    wg = mp["wg"].clone().requires_grad_()
    y, aux = fn(xg, wg)
    gx, gwg = torch.autograd.grad((y * w).sum(), (xg, wg))
    return y.detach(), aux.detach(), gx, gwg


def _moe_routing_case(dev, cf) -> dict:
    x, mp = _moe_layer_case(dev)
    T, D = x.shape
    E = mp["wg"].shape[1]
    C = moe._capacity(T, E, cf)
    w = torch.randn(T, D, generator=torch.Generator().manual_seed(28)).to(dev)

    def gather_form(xg, wg):
        y, aux = moe.moe_ffn_dense(xg[None], {**mp, "wg": wg}, cf)
        return y[0], aux

    def one_hot(xg, wg):
        dispatch, combine, aux = moe.switch_route(xg, wg, C)
        xe = torch.einsum("td,tec->ecd", xg, dispatch)
        ye = moe._expert_ffn(xe, mp) + mp["be2"][:, None, :]
        return torch.einsum("ecd,tec->td", ye, combine), aux

    y, aux, gx, gwg = _moe_grads(gather_form, x, mp, w)
    y_o, aux_o, gx_o, gwg_o = _moe_grads(one_hot, x, mp, w)
    with torch.no_grad():
        table, expert, slot, gate, _ = moe._route_tables(x, mp["wg"], C)
        dispatch = moe.switch_route(x, mp["wg"], C)[0]
        occupied = dispatch.sum(0) > 0  # (E, C)
        tok = torch.arange(T, device=dev, dtype=torch.float32)
        table_o = torch.where(occupied, torch.einsum(
            "tec,t->ec", dispatch, tok).round().long(), T)
        kept = dispatch.sum((1, 2)) > 0
        expert_o = dispatch.sum(2).argmax(1)
        slot_o = dispatch.sum(1).argmax(1)
        ye = moe._expert_ffn(moe._seat_gather(x, table), mp) \
            + mp["be2"][:, None, :]
        gate_pad = torch.cat([gate, gate.new_zeros(1)])
        y_s = moe._scatter_combine(ye * gate_pad[table][..., None], table, T)
    bit_equal = (torch.equal(table, table_o)
                 and torch.equal(kept, slot < C)
                 and torch.equal(expert[kept], expert_o[kept])
                 and torch.equal(slot[kept], slot_o[kept]))
    dropped = int((~kept).sum())

    def share(a, b, tol):
        return ((a - b).abs().max() / b.abs().max()).item() / tol

    rep = {"capacity_factor": cf, "tokens": T, "capacity": C,
           "dropped": dropped, "routing_bit_equal": bit_equal,
           "dropped_rows_zero": bool((y[~kept] == 0).all()),
           "y_share": share(y, y_o, MOE_Y_TOL),
           "y_scatter_share": share(y, y_s, MOE_Y_TOL),
           "grad_x_share": share(gx, gx_o, MOE_GRAD_TOL),
           "grad_wg_share": share(gwg, gwg_o, MOE_GRAD_TOL),
           "aux": aux.item(), "aux_oracle": aux_o.item()}
    print(f"  cf {cf}: T={T}, C={C}, {dropped} dropped (rows zero: "
          f"{rep['dropped_rows_zero']}); table, experts, slots bit-equal "
          f"{bit_equal}; share of the limit used: y {rep['y_share']:.3f} "
          f"(scatter-add {rep['y_scatter_share']:.3f}), dx "
          f"{rep['grad_x_share']:.3f}, dwg {rep['grad_wg_share']:.3f}")
    _require(bit_equal, f"cf {cf}: the gather form's routing differs from "
                        "the one-hot oracle's")
    _require(rep["dropped_rows_zero"], f"cf {cf}: a dropped row is nonzero")
    _require(aux.item() == aux_o.item(), f"cf {cf}: aux differs")
    _require(max(rep[k] for k in ("y_share", "y_scatter_share",
                                  "grad_x_share", "grad_wg_share")) <= 1.0,
             f"cf {cf}: the gather form disagrees with the oracles: {rep}")
    return rep


def phase_moe_routing(dev) -> dict:
    rep = {f"cf_{cf}": _moe_routing_case(dev, cf) for cf in (1.25, 0.5)}
    _require(rep["cf_0.5"]["dropped"] > 0, "cf 0.5 dropped no token")
    return rep


def phase_moe_train(dev) -> dict:
    """The MoE training main path (bench/moe_train.py), after its first
    step's loss and gradients in f32 at batch 2 against the reference
    attention (phase 13's limits)."""
    print("  f32, batch 2: the first step, flash against reference "
          "attention")
    phase_train_parity_f32(dev, mt.moe_config(torch.float32))
    torch.cuda.empty_cache()
    r = mt.bench_moe_train(dev, steps=MOE_STEPS, chains=2)
    launches, one = r["launches"], r["one_device_launches"]
    steps = r["launch_steps"]
    k = TRAIN["n_layers"] * steps
    want = _want_all(k, k)
    for side, counts in (("the mesh", launches), ("one device", one)):
        print(f"  {side}: {steps} steps (1 warm-up, {MOE_STEPS} timed), "
              f"launches "
              f"{ {FLASH.get(n, (n,))[0]: v for n, v in counts.items()} }")
    print(f"  {r['ms_per_step']:.2f} ms/step on {r['mesh']} (one device "
          f"{r['one_device_ms_per_step']:.2f}, dense "
          f"{r['dense_ms_per_step']:.2f}), {r['tokens_per_s']:.1f} tokens/s, "
          f"routing_overhead_share {r['routing_overhead_share']:.3f} (one "
          f"device; the mesh step's {r['mesh_routing_overhead_share']:.3f})"
          f", MFU (activated) "
          f"{r['mfu_vs_raw_matmul']:.4f} of a raw bf16 matmul chain at "
          f"{r['raw_bf16_tflops_per_s']:.1f} TFLOP/s; peak memory "
          f"{r['peak_mem_gb']:.3f} GB; {r['params_m']:.1f} M params")
    print(f"  drop rate {r['drop_rate']:.4f} at cf 1.25, "
          f"{r['drop_rate_at_cf_0.5']:.4f} at cf 0.5; aux at init "
          f"{r['aux_loss_at_init']:.4f}; trajectory {r['trajectory']} "
          f"(drop {r['trajectory_drop']:.3e}, noise "
          f"{r['trajectory_noise_med2nd']:.3e})")
    _require(launches == want, f"MoE main path launched {launches}, "
                               f"want {want}")
    _require(one == want, f"the one-device MoE step launched {one}, "
                          f"want {want}")
    _require(bool(np.isfinite(r["trajectory"]).all()),
             f"non-finite MoE loss: {r['trajectory']}")
    # in bf16, lr * g is under half an ulp of nearly every weight (phase
    # 14), so only the zero-init biases and the f32 router move and the
    # bf16 trajectory is printed, not held; the same 12 steps in f32 at
    # batch 2, where every weight moves, must fall beyond their noise
    cfg = mt.moe_config(torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    inp, tgt = (t[:2] for t in train_batch(cfg.vocab, dev))
    _, f32 = mt.trajectory(make_train_step(cfg, lr=LR, donate=True),
                           params, inp, tgt)
    del params
    r["f32_batch2"] = f32
    print(f"  f32, batch 2: trajectory {f32['trajectory']} (drop "
          f"{f32['trajectory_drop']:.3e}, noise "
          f"{f32['trajectory_noise_med2nd']:.3e})")
    _require(f32["trajectory_ok"], "the f32 MoE loss trajectory does not "
                                   "fall beyond its noise")
    return r


def phase_coded_train(dev) -> dict:
    """Coded transformer training (bench/coded_train.py): the f32
    exactness check and its broken control, then the bf16 run."""
    ex = ct_bench.exactness_f32(dev, delay_s=CODED_DELAY_S)
    print(f"  f32, {ex['epochs']} coded epochs (fresh {ex['fresh_sets']}) "
          f"against direct full-batch SGD: worst leaf change "
          f"{ex['worst_leaf_rel_err']:.3e} relative (limit {ex['tol']:.0e})"
          f" over {len(ex['leaf_rel_err'])} leaves; control (one fresh "
          f"worker left out of the decode) {ex['ctrl_best_leaf_rel_err']:.3e}"
          f"-{ex['ctrl_worst_leaf_rel_err']:.3e}")
    _require(ex["ok"], f"coded f32 training is not exact: {ex}")
    torch.cuda.empty_cache()
    r = ct_bench.bench_coded_train(dev, epochs=CODED_EPOCHS,
                                   delay_s=ct_bench.DELAY_S)
    print(f"  bf16: coded {r['coded_epoch_ms']} ms/epoch (fresh "
          f"{r['fresh_sets']}, workers {r['stragglers']} out at every "
          f"return: {r['stragglers_out_at_return']}), bulk "
          f"{r['bulk_epoch_ms']} ms/epoch, vs_baseline "
          f"{r['vs_baseline']:.2f}, {r['full_batch_tokens_per_s']:.1f} "
          f"full-batch tokens/s; traced epoch idle share "
          f"{r.get('device_idle_share')}; peak {r['peak_mem_gb']:.3f} GB; "
          f"launches {r['launches']} (at least {r['launches_at_least']})")
    _require(r["ok"], "coded training failed: " + json.dumps(
        {k: r[k] for k in ("stragglers_out_at_return", "launches",
                           "full_batch_loss_after")}))
    return {"exactness_f32": ex, **r}


# --------------------------------------------------------------------------
# phases 31-36: sampling and the observability plane
# --------------------------------------------------------------------------


def _sampling_case(R, V, dt, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    logits = (torch.randn(R, V, generator=gen) * 3).to(dt).to(dev)
    keys = torch.stack([prng.key(1000 * seed + r) for r in range(R)]).to(dev)
    pos = torch.arange(R, dtype=torch.int32, device=dev) * 131 + 7
    rows = torch.zeros(R, dtype=torch.int32, device=dev)
    return logits, pos, keys, rows


def phase_sampling_vs_plain(dev) -> tuple[float, dict]:
    """The sampling kernel at the serving shape (S=8 rows of the vocab)
    against its plain chain on the same inputs: every entry's bits and
    Gumbel noise bit-equal, the tokens equal, f32 and bf16 logits, top_k
    None, 1 and 50; then its time in a CUDA graph (a tick's 64 calls)
    and eagerly, the plain chain's (eager: it reads the temperature from
    the host), and the bound (bench/kernel_bounds.py)."""
    R, V = SLOTS, MODEL["vocab"]
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for top_k in (None, 1, SAMPLE_TOP_K):
            logits, pos, keys, rows = _sampling_case(R, V, dt, dev,
                                                     seed=1 + (top_k or 0))
            bits = torch.empty(R, V, dtype=torch.int32, device=dev)
            noise = torch.empty(R, V, dtype=torch.float32, device=dev)
            got = sampling.sample_rows(logits, pos, keys, rows, SAMPLE_T,
                                       top_k, bits_out=bits,
                                       noise_out=noise)
            k = prng.fold_in(prng.fold_in(keys, pos), rows)
            want_noise = prng.gumbel(k, (V,))
            want = sampling.sample_rows_ref(logits, pos, keys, rows,
                                            SAMPLE_T, top_k)
            torch.cuda.synchronize()
            same_bits = torch.equal(bits.long() & 0xFFFFFFFF,
                                    prng.bits(k, (V,)))
            err = (noise - want_noise).abs().max().item()
            worst = max(worst, err)
            print(f"  {str(dt)[6:]} top_k={top_k}: bits equal {same_bits}, "
                  f"noise max |diff| {err:.3e}, tokens {got.tolist()} "
                  f"(plain {want.tolist()})")
            _require(same_bits and err == 0.0 and torch.equal(got, want),
                     f"the sampling kernel disagrees with its plain chain "
                     f"({dt}, top_k={top_k})")
    logits, pos, keys, rows = _sampling_case(R, V, torch.bfloat16, dev, 9)
    call = (lambda i: sampling.sample_rows(logits, pos, keys, rows,
                                           SAMPLE_T, SAMPLE_TOP_K))
    plain = (lambda i: sampling.sample_rows_ref(logits, pos, keys, rows,
                                                SAMPLE_T, SAMPLE_TOP_K))
    alone = (lambda i: sampling.sample_rows(logits, pos, keys, rows,
                                            SAMPLE_T))
    n0 = sampling.LAUNCHES["sample_rows"]
    alone_ms = _graph_ms(alone, 64)
    graph_ms = _graph_ms(call, 64)
    eager_ms = _time_ms(call, 64)
    plain_ms = _time_ms(plain, 10, n_warm=2)
    bound = sampling_bounds(R, V, 2)
    sampling.LAUNCHES["sample_rows"] = n0  # timing launches: not a path
    tim = {"ms": graph_ms, "graph_ms": graph_ms, "eager_ms": eager_ms,
           "kernel_alone_graph_ms": alone_ms,
           "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"], "library_ms": None}
    print(f"  R={R} V={V} bf16, top_k {SAMPLE_TOP_K}: kernel "
          f"{graph_ms * 1e3:.2f} us in a CUDA graph (with torch.topk; "
          f"{alone_ms * 1e3:.2f} us without top_k), "
          f"{eager_ms * 1e3:.2f} us eager; plain chain "
          f"{plain_ms * 1e3:.1f} us eager; bound "
          f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}: "
          f"{bound['int32_ops']} int32, {bound['f32_ops']} f32 ops, "
          f"{bound['bytes']} B)")
    return worst, tim


def phase_sampled_parity_f32(dev) -> None:
    """Sampled slot-ring serving in f32 at full width on the kernel
    route (K5 and the sampling kernel): each stream equals
    ``generate_ring_dense`` with the request's key, and the sampling
    kernel launched once per admission and once per inner step."""
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(11)
    lens, budgets = [300, 77, 512, 5, 260, 128], [16, 24, 16, 20, 12, 24]
    prompts = _prompts(rng, lens, cfg.vocab)
    keys = [prng.key(500 + i) for i in range(len(prompts))]
    sched = ServingScheduler(params, cfg, slots=4, n_inner=8,
                             prompt_chunk=256, max_prompt=512,
                             quantize_kv=True, temperature=SAMPLE_T,
                             top_k=SAMPLE_TOP_K, device=dev)
    _require(sched.use_kernel, "the S=4 int8 tick did not route K5")
    zero_launches()
    reqs = [sched.submit(p, max_new=n, key=k)
            for p, n, k in zip(prompts, budgets, keys)]
    sched.run()
    n = launch_counts()
    want = len(reqs) + sched.n_inner * sched.decode_ticks
    print(f"  {sched.decode_ticks} decode ticks: sampling kernel "
          f"{n[SAMPLE]} launches (want {want}), K5 {n[K5]}")
    _require(n[SAMPLE] == want and n[K5] == cfg.n_layers * sched.n_inner
             * sched.decode_ticks, f"launch counts {n}")
    for i, (r, k) in enumerate(zip(reqs, keys)):
        o = td.generate_ring_dense(params, r.prompt[None], budgets[i], cfg,
                                   temperature=SAMPLE_T, top_k=SAMPLE_TOP_K,
                                   key=k, quantize_kv=True, device=dev)
        _require(r.finished and o.cpu().numpy()[0].tolist() == r.tokens,
                 f"sampled request {i} differs from generate_ring_dense")
    print(f"  {len(reqs)} sampled streams equal generate_ring_dense with "
          "their keys")
    del params


def _get(url) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _kernels_per_step(sched) -> tuple[float, float]:
    """One profiled tick of PROFILE_INNER inner steps (a 64-step tick's
    trace takes the profiler tens of seconds to read): (kernels per
    inner step, device idle share)."""
    n_inner, sched.n_inner = sched.n_inner, PROFILE_INNER
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sched.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        sched.n_inner = n_inner
    events = prof.events()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) for e in events)
    return n / PROFILE_INNER, 1.0 - _busy_us(events) / wall_us


def _serve_variant(dev, cfg, params, variant, paged, workload,
                   profile_it):
    """One of greedy-dark, sampled-dark and sampled-lit on a main-path
    workload; returns its report (and, lit, the live instruments)."""
    lit = variant == "sampled-lit"
    sampled = variant != "greedy-dark"
    kw = dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K) if sampled else {}
    obs = {}
    if lit:
        obs = {"registry": tobs.MetricsRegistry(),
               "spans": tobs.SpanRecorder("serving"),
               "flight": tobs.FlightRecorder(capacity=8192),
               "trace": tobs.TraceBook()}
        obs["exporter"] = tobs.ObsServer(obs["registry"],
                                         flight=obs["flight"]).start()
    torch.cuda.synchronize()
    zero_launches()
    sched = ServingScheduler(
        params, cfg, slots=SLOTS, n_inner=SERVE_INNER,
        prompt_chunk=256 if paged else 512, max_prompt=512,
        quantize_kv=True, page_tokens=PAGE if paged else None,
        device=dev, **kw, **obs)
    reqs = workload(sched, sampled)
    t0 = time.perf_counter()
    sched.step()  # admission (and a first tick of all 8)
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    scrapes = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_TICKS):
        sched.step()
        if lit:  # scraped over HTTP while the scheduler runs
            torch.cuda.synchronize()
            dt_pause = time.perf_counter()
            url = obs["exporter"].url
            scrapes.append((_get(url + "/metrics"), _get(url + "/healthz")))
            t0 += time.perf_counter() - dt_pause  # scrapes not timed
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    ticks_timed = sched.decode_ticks
    rep = {"ms_per_tick": dt / SERVE_TICKS * 1e3,
           "decode_tokens_per_s": SLOTS * SERVE_INNER * SERVE_TICKS / dt,
           "admit_tick_s": t_admit, "launches": launches,
           "decode_ticks": ticks_timed}
    if profile_it:
        per_step, idle = _kernels_per_step(sched)
        rep.update(kernels_per_inner_step=per_step,
                   profiled_tick_idle_share=idle)
    if lit:
        sched.run()  # the audit closes over retired requests
    else:
        for r in reqs:
            sched.cancel(r)
    print(f"  {variant}: {rep['ms_per_tick']:.2f} ms/tick, "
          f"{rep['decode_tokens_per_s']:.1f} decode tokens/s, "
          + (f"{rep['kernels_per_inner_step']:.1f} kernels per inner step "
             f"(profiled tick idle {rep['profiled_tick_idle_share']:.3f}); "
             if profile_it else "")
          + f"launches {launches}")
    for r in reqs:
        _require(r.finished and len(r.tokens) > SERVE_INNER
                 and all(0 <= t < cfg.vocab for t in r.tokens),
                 f"{variant}: request {r.id} short or out of vocab")
    return rep, sched, reqs, obs, scrapes, ticks_timed


def _check_lit(sched, reqs, obs, scrapes, tmp, label) -> dict:
    """The lit run's proofs: scrapes answered during the run, the audit
    closes, the merged Chrome trace holds the scheduler's tick track."""
    reg, book = obs["registry"], obs["trace"]
    ok_scrapes = all(m[0] == 200 and b"serving_ticks_total" in m[1]
                     and h[0] == 200 for m, h in scrapes)
    _require(scrapes and ok_scrapes, f"{label}: /metrics or /healthz "
             f"failed during the run: {[(m[0], h[0]) for m, h in scrapes]}")
    res = tobs.audit(book, None, reg)
    kinds = [book.kinds(t) for t in book.ids()]
    _require(res.ok and len(kinds) == len(reqs) and all(
        k.count("retired") == 1 for k in kinds),
        f"{label}: audit failed: {res.to_dict()}")
    toks = reg.counter("serving_tokens_total").value
    _require(toks == sum(len(r.tokens) for r in reqs),
             f"{label}: serving_tokens_total {toks} != the streams")
    path = f"{tmp}/{label}_trace.json"
    n_ev = tobs.dump_merged_chrome_trace(path, recorders=[obs["spans"]])
    with open(path) as f:
        doc = json.load(f)
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e.get("name") == "thread_name"}
    ticks = sum(e["name"].startswith("tick ") for e in doc["traceEvents"]
                if e.get("ph") == "X")
    _require("scheduler" in tracks and ticks >= sched.decode_ticks,
             f"{label}: merged trace lacks the scheduler's ticks: {tracks}")
    obs["exporter"].close()
    flight_ticks = sum(e.get("name", "").startswith("tick ")
                       for e in obs["flight"].snapshot()["traceEvents"])
    out = {"scrapes": len(scrapes), "audit_ok": res.ok,
           "audit_checked": res.checked, "trace_events": n_ev,
           "trace_tick_spans": ticks, "flight_tick_spans": flight_ticks,
           "serving_tokens_total": toks,
           "ttft_count": reg.histogram("serving_ttft_seconds").count}
    print(f"  {label}: {len(scrapes)} scrapes of /metrics and /healthz "
          f"during the run (200); audit ok over {len(kinds)} requests "
          f"({', '.join(res.checked)}); merged trace {n_ev} events, "
          f"{ticks} tick spans on the scheduler track")
    return out


def _ring_workload(cfg):
    def submit(sched, sampled):
        rng = np.random.default_rng(2)
        return [sched.submit(p, max_new=SERVE_INNER * (SERVE_TICKS + 2),
                             **({"key": prng.key(900 + i)} if sampled
                                else {}))
                for i, p in enumerate(_prompts(rng, [512] * SLOTS,
                                               cfg.vocab))]
    return submit


def _paged_workload(cfg):
    def submit(sched, sampled):
        rng = np.random.default_rng(6)
        sys_prompt = rng.integers(0, cfg.vocab, 256)
        reqs = []
        for i in range(SLOTS):
            p = np.concatenate([sys_prompt, rng.integers(0, cfg.vocab, 256)])
            reqs.append(sched.submit(p, max_new=384, **(
                {"key": prng.key(700 + i)} if sampled else {})))
            if i == 0:
                while not reqs[0].tokens:
                    sched.step()  # resident, so the other 7 share
        return reqs
    return submit


def phase_sampled_serving(dev, paged: bool) -> dict:
    """The main path sampled and instrumented, beside greedy and
    sampled dark runs of the same workload, in turns in one process
    (A B C, once each: the host's spread between runs is measured in
    phase 49's pairs and PERF.md §5)."""
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    workload = (_paged_workload if paged else _ring_workload)(cfg)
    runs = {v: [] for v in SERVE_VARIANTS}
    with tempfile.TemporaryDirectory() as tmp:
        for i, variant in enumerate(SERVE_VARIANTS):
            first = not runs[variant]
            rep, sched, reqs, obs, scrapes, ticks = _serve_variant(
                dev, cfg, params, variant, paged, workload,
                profile_it=first and variant != "sampled-lit")
            sampled = variant != "greedy-dark"
            want = SLOTS + SERVE_INNER * ticks if sampled else 0
            _require(rep["launches"][SAMPLE] == want,
                     f"{variant}: the sampling kernel launched "
                     f"{rep['launches'][SAMPLE]} times, want {want}")
            attn = K6 if paged else K5
            _require(rep["launches"][attn] == cfg.n_layers * SERVE_INNER
                     * ticks, f"{variant}: {attn} launches "
                     f"{rep['launches'][attn]}")
            if paged:
                rep["share_hits"] = sched.pool.share_hits
                _require(sched.pool.share_hits == 28,
                         f"{variant}: {sched.pool.share_hits} share hits")
                sched.pool.check()
            if variant == "sampled-lit":
                rep["lit"] = _check_lit(
                    sched, reqs, obs, scrapes, tmp,
                    f"{'paged' if paged else 'ring'}_{i}")
            runs[variant].append(rep)
            del sched, reqs, obs
            torch.cuda.empty_cache()
    out = {}
    for v, rs in runs.items():
        ms = [r["ms_per_tick"] for r in rs]
        out[v] = {"ms_per_tick": ms, "mean_ms_per_tick": float(np.mean(ms)),
                  "decode_tokens_per_s": [r["decode_tokens_per_s"]
                                          for r in rs],
                  **{k: rs[0][k] for k in ("kernels_per_inner_step",
                                           "profiled_tick_idle_share")
                     if k in rs[0]},
                  "runs": rs}
    g, d, l_ = (out[v]["mean_ms_per_tick"] for v in SERVE_VARIANTS)
    print(f"  mean ms/tick greedy-dark {g:.2f}, sampled-dark {d:.2f} "
          f"({d / g:.3f}x), sampled-lit {l_:.2f} ({l_ / g:.3f}x); kernels "
          f"per inner step greedy {out['greedy-dark']['kernels_per_inner_step']:.2f}, "
          f"sampled {out['sampled-dark']['kernels_per_inner_step']:.2f}")
    del params
    return out


def phase_instrumented_coded(dev) -> dict:
    """Phase 30's coded trainer with a registry, spans and an
    EpochTracer (2 coded bf16 epochs, workers 1 and 4 delayed), and
    config 3's (8, 6)-coded GEMM at 8192^3 (batch, "ready") with a
    registry, spans and an EpochTracer (3 epochs): the series and the
    merged trace, which must carry the pool's worker tracks."""
    out = {}
    cfg = TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    reg, rec, tracer = (tobs.MetricsRegistry(), tobs.SpanRecorder("train"),
                        ttrace.EpochTracer())
    tr = CodedGradTrainer(
        transformer_chunk_loss(cfg), params, ct_bench.chunk_fn(cfg.vocab),
        ct_bench.N, ct_bench.S, devices=[dev],
        delay_fn=lambda i, e: (CODED_DELAY_S if i in ct_bench.STRAGGLERS
                               else 0.0),
        tracer=tracer, registry=reg, spans=rec)
    pool = AsyncPool(ct_bench.N)
    zero_launches()
    try:
        for _ in range(INSTR_EPOCHS):
            params = tr.step(pool, params, lr=ct_bench.LR)
        waitall(pool, tr.backend, timeout=ct_bench.DRAIN_S, tracer=tracer)
        torch.cuda.synchronize()
    finally:
        tr.backend.shutdown()
    launches = launch_counts()
    doc, n_ev = tobs.merged_chrome_trace(tracers=[tracer], recorders=[rec])
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e.get("name") == "thread_name"}
    workers = sorted(t for t in tracks if t.startswith("worker"))
    steps = reg.counter("train_steps_total").value
    recovered = {i: reg.counter("train_worker_recovered_total",
                                worker=str(i)).value
                 for i in range(ct_bench.N)}
    need = cfg.n_layers * (ct_bench.S + 1) * (ct_bench.N - ct_bench.S)
    print(f"  coded trainer: {steps:.0f} steps, recovered per worker "
          f"{recovered}, step spans {len(rec.spans)}, merged trace "
          f"{n_ev} events on tracks {sorted(tracks)}; K1-K3 launches "
          f"{[launches[k] for k in ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')]}")
    _require(steps == INSTR_EPOCHS and len(rec.spans) == INSTR_EPOCHS
             and len(workers) == ct_bench.N and "train" in tracks
             and sum(recovered.values()) == INSTR_EPOCHS * (
                 ct_bench.N - ct_bench.S)
             and all(launches[k] >= need * INSTR_EPOCHS for k in
                     ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
             "the instrumented coded trainer's series or trace")
    out["coded_train"] = {"steps": steps, "recovered": recovered,
                          "tracks": sorted(tracks), "trace_events": n_ev,
                          "launches": launches,
                          "prometheus_lines": len(
                              reg.to_prometheus().splitlines())}
    del tr, params
    torch.cuda.empty_cache()
    m, n, k = coded_bench.MDS_M, coded_bench.MDS_N, coded_bench.MDS_K
    A, B = coded_bench._operands(m, m, m, 0, dev)
    A_pad = torch.zeros(-(-m // k) * k, m, device=dev)
    A_pad[:m] = A
    reg, rec, tracer = (tobs.MetricsRegistry(), tobs.SpanRecorder("gemm"),
                        ttrace.EpochTracer())
    cg = CodedGemm(A_pad, n, k, devices=[dev], batch=True, registry=reg)
    pool = AsyncPool(n)
    try:
        for _ in range(INSTR_EPOCHS + 1):
            t0 = time.perf_counter()
            asyncmap(pool, B, cg.backend, nwait=k, tracer=tracer)
            C = cg.result_device(pool)[:m]
            torch.cuda.synchronize()
            rec.add(f"coded gemm epoch {pool.epoch}", t0,
                    time.perf_counter() - t0, track="gemm",
                    fresh=len(pool.fresh_indices()))
        err = coded_bench.rel_err(C, torch.matmul(A, B))
        tol = coded_bench.REL_TOL["highest"] * coded_bench._cond(
            cg.code.G, pool.fresh_indices()[:k].tolist())
        waitall(pool, cg.backend, tracer=tracer)
    finally:
        cg.backend.shutdown()
    doc, n_ev = tobs.merged_chrome_trace(tracers=[tracer], recorders=[rec])
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e.get("name") == "thread_name"}
    decodes = reg.counter("coded_gemm_decodes_total").value
    print(f"  coded GEMM (config 3): {decodes:.0f} decodes, error "
          f"{err:.2e}, merged trace {n_ev} events on tracks "
          f"{sorted(tracks)}")
    _require(decodes == INSTR_EPOCHS + 1 and err <= tol
             and sum(t.startswith("worker") for t in tracks) == n
             and "gemm" in tracks, "the instrumented coded GEMM")
    out["coded_gemm"] = {"decodes": decodes, "rel_err": err,
                         "tracks": sorted(tracks), "trace_events": n_ev}
    return out


def _rung(label, res) -> dict:
    print(f"  {label}: " + json.dumps(
        {k: v for k, v in res.items() if k not in ("card", "epochs")}))
    _require(res["ok"], f"{label} failed")
    torch.cuda.empty_cache()
    return res


def phase_coded_family(dev, t_start) -> dict:
    """Phases 36-39 (bench/coded_family.py at chip_smoke's cuts)."""
    out = {}
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print("[36] rateless LT GEMM 8192^3 f32, n=12, k=8, worker 0 dead, "
          "round timeout 2 s [60]; then the systematic/classic overhead")
    out["rateless"] = _rung("rateless", cf_bench.rateless(dev))
    out["overhead"] = _rung("overhead", cf_bench.rateless_overhead(dev))
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print("[37] MatDot p=4 and polynomial p=q=2, 8192^3 f32, n=8, worker 5 "
          "delayed 0.5 s in the second epoch")
    out["matdot"] = _rung("matdot", cf_bench.evalpoint(dev, "matdot"))
    out["poly"] = _rung("poly", cf_bench.evalpoint(dev, "poly"))
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print("[38] hierarchical: 4 groups x 8 stream workers, k_inner=6, A "
          "9216 x 8192, group 2 dead from the second of 3 epochs; flat "
          "(32, 24) decode")
    out["hierarchical"] = _rung("hierarchical", cf_bench.hierarchical(dev))
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print("[39] GF(256) RS (8, 6) on the card over the training model's "
          "f32 parameter bytes, bitslice and gather")
    out["gf256"] = _rung("gf256", cf_bench.gf256(dev))
    return out


def phase_pool_utils(dev, t_start) -> dict:
    """Phases 40-41 (bench/adaptive_nwait.py at chip_smoke's cuts)."""
    out = {}
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print("[40] adaptive nwait: a rotating-straggler trace (16 stream "
          "workers, 0.1 s, every 5 of 20 epochs) replayed into config 5's "
          "CodedSGD, full gather and AdaptiveNwait; pool checkpoint")
    out["coded_sgd"] = _rung("coded_sgd", an_bench.coded_sgd(dev))
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print("[41] hedged requests: 4 stream replicas, 4096^2 bf16 products, "
          "replica 0 stalled 50 ms, 40 requests at hedge 1 and 2")
    out["hedge"] = _rung("hedge", an_bench.hedge(dev))
    return out


# --------------------------------------------------------------------------
# phases 42-45: the host backends and the native transport
# --------------------------------------------------------------------------

# cuts (PERF.md section 4): the transport bench's round trips 200 -> 50
# epochs (its broadcasts 20 -> 5); config 2 over process workers runs one
# chain of 5 epochs (phase 23's stream rung 40 x 3), and both backends'
# workers start together; the launcher's run 3 epochs
NATIVE_LIBS = ("transport", "lt_peel", "rs_gf256")
TRANSPORT_EPOCHS = 50
RS_BYTES = 64 << 20                # of the training model's f32 parameters
LT_M, LT_COLS, LT_K = 2048, 256, 8  # bench.py:1046's overhead shape
# the native peel against the numpy peel: f32 sums of a few blocks
# released in another order (worklist against rescan), relative to the
# largest value
LT_TOL = 1e-5
LAUNCH_RANKS, LAUNCH_TIMEOUT_S = 3, 240
ROOT = os.path.dirname(os.path.abspath(__file__))


def _start_native_builds():
    """One g++ per native source, in threads, started beside phase 2's
    nvcc; returns (threads, name -> seconds or the exception)."""
    done: dict = {}
    t0 = time.perf_counter()

    def one(name):
        try:
            native.build(name)
            done[name] = time.perf_counter() - t0
        except Exception as e:  # reported and required in phase 42
            done[name] = e

    threads = [threading.Thread(target=one, args=(n,)) for n in NATIVE_LIBS]
    for t in threads:
        t.start()
    return threads, done


def _peelable_prefix(code) -> list:
    ids = []
    while not code.peelable(ids):
        ids.append(len(ids))
    return ids


def phase_native(dev, builds) -> dict:
    """Phase 42: the native libraries, the RS codec's and the LT peel's
    native routes against the numpy routes and the card's."""
    threads, done = builds
    for t in threads:
        t.join()
    bad = {n: repr(v) for n, v in done.items() if isinstance(v, Exception)}
    _require(not bad, f"native build failed: {bad}")
    lib = native_transport.load_lib()
    want = native.lib_path("transport")
    _require(lib._name == want and os.path.join(
        "mpistragglers_jl_tpu_torch", "native", "_build") in want,
        f"transport loaded from {lib._name}, not the port's build")
    out = {"build_s": max(done.values()), "libs": {
        n: os.path.basename(native.lib_path(n)) for n in NATIVE_LIBS}}
    print(f"  built {', '.join(NATIVE_LIBS)} in {out['build_s']:.2f} s "
          f"(g++ -O3, beside nvcc); transport from {os.path.relpath(want)}")

    n, k, lost = cf_bench.GF_N, cf_bench.GF_K, cf_bench.GF_LOST
    rs, npy = RSGF256(n, k), RSGF256(n, k, prefer_native=False)
    _require(rs.impl == "native" and npy.impl == "numpy",
             f"RSGF256 routes {rs.impl}, {npy.impl}")
    cfg = TransformerConfig(**cf_bench.TRAIN, dtype=torch.float32)
    raw = cf_bench.param_bytes(init_params(cfg, seed=0, device=dev))
    L = -(-RS_BYTES // k)
    data = torch.zeros(k * L, dtype=torch.uint8, device=dev)
    data[:RS_BYTES] = raw[:RS_BYTES]
    del raw
    data = data.reshape(k, L)
    host = data.cpu().numpy()
    keep = [r for r in range(n) if r not in lost]
    rs.decode(rs.encode(host[:, :4096])[keep], keep)  # warm-up
    t0 = time.perf_counter()
    coded = rs.encode(host)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = rs.decode(coded[keep], keep)
    dec_s = time.perf_counter() - t0
    eq_numpy = bool(np.array_equal(coded, npy.encode(host)))
    card = DeviceRSGF256(n, k, method="gather", device=dev)
    eq_card = bool(np.array_equal(coded, card.encode(data).cpu().numpy()))
    exact = bool(np.array_equal(back, host))
    del data, coded, back
    out["rs"] = {"n": n, "k": k, "bytes": RS_BYTES, "lost_rows": list(lost),
                 "impl": rs.impl, "encode_GB_per_s": host.nbytes / enc_s / 1e9,
                 "decode_GB_per_s": host.nbytes / dec_s / 1e9,
                 "equal_to_numpy": eq_numpy, "equal_to_card": eq_card,
                 "round_trip_exact": exact}
    print(f"  RS (8, 6) native over {RS_BYTES >> 20} MiB: encode "
          f"{out['rs']['encode_GB_per_s']:.3f} GB/s, decode "
          f"{out['rs']['decode_GB_per_s']:.3f} GB/s; equal to numpy "
          f"{eq_numpy}, to the card {eq_card}, round trip {exact}")
    _require(eq_numpy and eq_card and exact, "RS native route disagrees")

    code = LTCode(LT_K, seed=0)
    ids = _peelable_prefix(code)
    blocks = np.random.default_rng(42).standard_normal(
        (LT_K, LT_M // LT_K, LT_COLS)).astype(np.float32)
    shards = np.einsum("nk,krc->nrc", code.generator_rows(ids),
                       blocks).astype(np.float32)
    code.decode(shards, ids)  # warm-up (loads the library)
    t0 = time.perf_counter()
    nat = code.decode(shards, ids)
    nat_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = code.decode(shards, ids, prefer_native=False)
    npy_ms = (time.perf_counter() - t0) * 1e3
    on_card = code.decode(torch.from_numpy(shards).to(dev), ids)
    on_card = on_card.cpu().numpy()
    err = float(np.abs(nat - ref).max() / np.abs(ref).max())
    card_equal = bool(np.array_equal(on_card, ref))
    out["lt"] = {"m": LT_M, "cols": LT_COLS, "k": LT_K, "shards": len(ids),
                 "native_ms": nat_ms, "numpy_ms": npy_ms,
                 "native_vs_numpy": err, "tol": LT_TOL,
                 "card_equal_to_numpy": card_equal}
    print(f"  LT peel k={LT_K} over {len(ids)} shards of {LT_M // LT_K} x "
          f"{LT_COLS} f32: native {nat_ms:.3f} ms, numpy {npy_ms:.3f} ms, "
          f"native vs numpy {err:.2e} (limit {LT_TOL:.0e}), card equal to "
          f"numpy {card_equal}")
    _require(err <= LT_TOL and card_equal, "LT native or card peel off")
    return out


def _run(cmd, timeout) -> tuple[int, str, str, float]:
    """Run ``cmd`` from the checkout's root in its own session (so a
    timeout takes every process it started with it), with the package
    importable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    return proc.returncode, out, err, time.perf_counter() - t0


@contextlib.contextmanager
def _workers_skip_this_script():
    """Spawned workers re-run the parent's ``__main__`` file before they
    unpickle their work function (``multiprocessing`` spawn), which would
    import this whole script (and everything it imports) in each one.
    While process backends start, ``__main__`` is a bare module, so a
    worker imports only its work function's module."""
    main = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        sys.modules["__main__"] = main


def phase_transport() -> list:
    """Phase 43: bench/transport.py at chip_smoke's cut."""
    with _workers_skip_this_script():
        rows = tr_bench.run(TRANSPORT_EPOCHS)
    for r in rows:
        print(f"  {r['metric']}: {r['value']:.3f} {r['unit']}")
        _require(r["value"] > 0, f"{r['metric']} read {r['value']}")
    return rows


def phase_process_gemm(streams_ms: float) -> list:
    """Phase 44: config 2 over process workers on the card, then the
    respawn run on the native backend (bench/process_gemm.py)."""
    with _workers_skip_this_script():
        # one chain of 5 epochs per backend (bench/process_gemm.py's
        # default is the least of 3 of 10): the run's time limit
        res = pg_bench.run(("process", "native"), epochs=5, chains=1,
                           respawn=True)
    for r in res:
        print(f"  {r['backend']}: {r['ms_per_epoch']:.3f} ms/epoch (streams "
              f"{streams_ms:.3f}, phase 23), worker task "
              f"{r['worker_task_ms']:.3f} ms, transport "
              f"{r['transport_ms']:.3f} ms, start-up {r['startup_s']:.2f} s, "
              f"rel err {r['rel_err']:.2e}, spans {r['worker_spans']}")
        r["streams_ms_per_epoch"] = streams_ms
        _require(r["ok"], f"{r['backend']} process pool failed: "
                 + json.dumps({k: r.get(k) for k in (
                     "rel_err", "bit_equal_across_epochs", "respawn")}))
        _require(r["worker_spans"] >= r["worker_tasks"] > 0,
                 f"{r['backend']}: worker spans not merged")
        if "respawn" in r:
            rr = r["respawn"]
            print(f"  respawn: {rr['failure']}, respawn(2) in "
                  f"{rr['respawn_s']:.2f} s, later epochs exact "
                  f"{rr['exact_after']}")
    _require(any("respawn" in r for r in res), "no respawn run")
    return res


def _launch(*args) -> tuple[int, str, str, float]:
    """The launcher on bench/launch_gemm.py."""
    return _run([sys.executable, "-m", "mpistragglers_jl_tpu_torch.launch",
                 "-n", str(LAUNCH_RANKS),
                 os.path.join("mpistragglers_jl_tpu_torch", "bench",
                              "launch_gemm.py"), *args], LAUNCH_TIMEOUT_S)


def phase_launcher() -> dict:
    """Phase 45: the launcher's GEMM, and beside it a launch whose rank
    1 exits 3."""
    fail: list = []
    failing = threading.Thread(target=lambda: fail.append(_launch(
        "--exit-rank", "1", "--exit-code", "3", "--connect-timeout", "30")))
    failing.start()
    rc, out, err, wall = _launch()
    failing.join()
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith('{"launch_gemm"')]
    _require(rc == 0 and len(lines) == 1,
             f"launch exited {rc}: {out[-1000:]} {err[-2000:]}")
    res = lines[0]["launch_gemm"]
    res["wall_s"] = wall
    print(f"  -n {LAUNCH_RANKS}: exit 0 in {wall:.2f} s, epochs "
          f"{[round(x, 2) for x in res['epoch_ms']]} ms, rel err "
          f"{res['rel_err']:.2e}, bit-equal {res['bit_equal']}")
    _require(res["ok"], f"launcher product off: {res}")
    rc, out, err, wall = fail[0]
    print(f"  rank 1 exits 3: the launch exits {rc} in {wall:.2f} s")
    _require(rc == 3, f"a failed rank gave launch exit {rc}: {err[-2000:]}")
    res["failed_rank_exit"] = rc
    res["failed_rank_wall_s"] = wall
    return res


def phase_host_backends(dev, builds, streams_ms, t_start) -> dict:
    """Phases 42-45."""
    out = {}
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print("[42] native host libraries (transport, LT peel, RS codec) from "
          "the port's sources; RS (8, 6) and the LT peel on their native "
          "routes")
    out["native"] = phase_native(dev, builds)
    torch.cuda.empty_cache()
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print(f"[43] transport bench on the host: round trips "
          f"({TRANSPORT_EPOCHS} epochs), 4 MiB broadcasts to 4 workers")
    out["transport"] = phase_transport()
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print("[44] config 2 over 4 spawned workers on the card per backend: "
          "4096^3 f32, nwait=4, one chain of 5 epochs; then worker 2 exits "
          "in epoch 5 of 10 and is respawned")
    out["config2"] = phase_process_gemm(streams_ms)
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print(f"[45] the launcher: -n {LAUNCH_RANKS} bench/launch_gemm.py, "
          "2048-row blocks on the card; beside it a job whose rank 1 "
          "exits 3")
    out["launcher"] = phase_launcher()
    return out


# --------------------------------------------------------------------------
# phases 46-49: checkpoints, the pool simulator, QoS admission
# --------------------------------------------------------------------------

# phase 46: phase 14's model and batch under AdamW, 6 steps straight
# against 3 + a checkpoint + 3
RESUME_STEPS, RESUME_LR = 6, 3e-4
# phase 47: the resumed state RS-coded over 8 shards, any 6 decode
CKPT_N, CKPT_K = 8, 6
# phase 49: 16 requests on one 256-token system prompt (+ 64 own tokens
# each), tenants gold (weight 2) and bronze (weight 1, a page quota of
# two of its requests at a time); parity in f32 with 24 new tokens,
# then ms/tick in bf16 with and without qos= in alternating pairs
QOS_REQUESTS, QOS_OWN, QOS_NEW_F32 = 16, 64, 24
QOS_INNER, QOS_TICKS, QOS_PAIRS = 32, 2, 1
QOS_NEW_BF16 = QOS_INNER * (QOS_TICKS + 3)
QOS_BRONZE_PAGES = 16


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes (Python values: equal)."""
    if not isinstance(a, torch.Tensor):
        return a == b
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().reshape(-1).view(torch.uint8),
        b.detach().to(a.device).reshape(-1).view(torch.uint8)))


def _tree_mismatches(got, want) -> list[int]:
    from mpistragglers_jl_tpu_torch.utils.coded_checkpoint import (
        tree_leaves)

    gl, wl = tree_leaves(got), tree_leaves(want)
    _require(len(gl) == len(wl), f"{len(gl)} leaves against {len(wl)}")
    return [i for i, (a, b) in enumerate(zip(gl, wl))
            if not _same_bits(a, b)]


def _quiescent_stream_pool(dev) -> AsyncPool:
    """A pool drained after 5 epochs over 4 stream workers, nwait 3."""
    backend = CUDADeviceBackend(an_bench._echo, 4, devices=[dev])
    pool = AsyncPool(4)
    try:
        for _ in range(5):
            asyncmap(pool, torch.zeros(1, device=dev), backend, nwait=3)
        waitall(pool, backend, timeout=60)
    finally:
        backend.shutdown()
    return pool


def phase_train_resume(dev, tmp) -> tuple[dict, dict, dict]:
    """Phase 46. Returns (launches of the resumed run, report, the
    resumed state for phase 47)."""
    cfg = _train_cfg(torch.bfloat16)
    p0 = init_params(cfg, seed=0, device=dev)
    init = [p.clone() for p in _leaves(p0)]
    inp, tgt = train_batch(cfg.vocab, dev)
    step, init_state = make_optax_train_step(cfg, tx=adamw(RESUME_LR))

    def fresh():
        return _rebuild(p0, iter([p.clone() for p in init]))

    params = fresh()
    opt = init_state(params)
    want = []
    for _ in range(RESUME_STEPS):
        params, opt, loss = step(params, opt, inp, tgt)
        want.append(loss)
    straight = {"params": params, "opt": opt.state_dict()}
    half = RESUME_STEPS // 2
    torch.cuda.synchronize()
    zero_launches()
    params = fresh()
    opt = init_state(params)
    got = []
    for _ in range(half):
        params, opt, loss = step(params, opt, inp, tgt)
        got.append(loss)
    pool = _quiescent_stream_pool(dev)
    ckpt = TrainCheckpointer(os.path.join(tmp, "train"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = ckpt.save(half, {"params": params, "opt": opt.state_dict()},
                  pool=pool)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    del params, opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    back, pool_state, at = ckpt.restore()
    params = _rebuild(p0, iter([torch.empty_like(p) for p in init]))
    with torch.no_grad():
        for p, r in zip(_leaves(params), _leaves(back["params"])):
            p.copy_(r)
    opt = init_state(params)
    opt.load_state_dict(back["opt"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del back, p0, init
    pool2 = load_pool_state(pool_state)
    _require(at == half and pool2.epoch == pool.epoch
             and (pool2.repochs == pool.repochs).all()
             and not pool2.active.any(),
             f"pool.json restored to epoch {pool2.epoch}, repochs "
             f"{pool2.repochs.tolist()} (saved {pool.epoch}, "
             f"{pool.repochs.tolist()})")
    for _ in range(RESUME_STEPS - half):
        params, opt, loss = step(params, opt, inp, tgt)
        got.append(loss)
    torch.cuda.synchronize()
    launches = launch_counts()
    resumed = {"params": params, "opt": opt.state_dict()}
    bad_loss = [i for i, (a, b) in enumerate(zip(got, want))
                if not _same_bits(a, b)]
    bad = _tree_mismatches(resumed, straight)
    n_leaves = len(_leaves(params))
    print(f"  losses straight {[x.item() for x in want]}, resumed "
          f"{[x.item() for x in got]}; {len(bad_loss)} losses and "
          f"{len(bad)} state leaves differ in any bit (params "
          f"{n_leaves} leaves + AdamW moments and steps)")
    print(f"  saved step {half} ({nbytes / 1e9:.3f} GB: state.npz, "
          f"tree.json, pool.json of a drained 4-stream pool at epoch "
          f"{pool.epoch}) in {save_s:.2f} s, restored into fresh tensors "
          f"and a fresh AdamW in {restore_s:.2f} s")
    steps = RESUME_STEPS
    want_n = {"flash_fwd": cfg.n_layers * steps,
              "flash_bwd_dq": cfg.n_layers * steps,
              "flash_bwd_dkv": cfg.n_layers * steps, "flash_bwd_fused": 0,
              K5: 0, K6: 0, K7: 0, SAMPLE: 0}
    _require(launches == want_n,
             f"resumed run launched {launches}, want {want_n}")
    _require(not bad_loss and not bad,
             f"resume is not bit-equal: losses {bad_loss}, leaves "
             f"{bad[:10]}")
    rep = {"steps": steps, "resumed_after": half, "save_s": save_s,
           "restore_s": restore_s, "gb_written": nbytes / 1e9,
           "loss_trajectory": [x.item() for x in got],
           "leaves_compared": len(_leaves(resumed)), "bit_equal": True}
    del straight
    return launches, rep, resumed


def phase_coded_checkpoint(state, tmp) -> dict:
    """Phase 47: the resumed state through CodedCheckpoint(8, 6)."""
    cc = CodedCheckpoint(CKPT_N, CKPT_K)
    d = os.path.join(tmp, "coded")
    t0 = time.perf_counter()
    paths = cc.save(d, state)
    enc_s = time.perf_counter() - t0
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    os.remove(paths[0])  # a lost source shard
    with open(paths[3], "r+b") as f:  # a corrupted one
        f.seek(man["shard_bytes"] // 2)
        b = f.read(1)
        f.seek(man["shard_bytes"] // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    t0 = time.perf_counter()
    back = cc.restore(d, target=state)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    bad = _tree_mismatches(back, state)
    del back
    os.remove(paths[5])
    try:
        cc.restore(d, target=state)
        raised = None
    except CheckpointCorrupt as e:
        raised = e
    gb = man["payload_bytes"] / 1e9
    print(f"  RS ({CKPT_N}, {CKPT_K}) on its {cc.rs.impl} route: "
          f"{gb:.3f} GB packed into {CKPT_N} shards of "
          f"{man['shard_bytes']} bytes; save {enc_s:.2f} s "
          f"({gb / enc_s:.3f} GB/s), restore with shard 0 lost and shard "
          f"3 corrupted {dec_s:.2f} s ({gb / dec_s:.3f} GB/s); "
          f"{len(bad)} leaves differ; a third lost shard: {raised}")
    _require(not bad, f"coded restore differs in leaves {bad[:10]}")
    _require(raised is not None and raised.have == CKPT_K - 1,
             "restore past n - k + 1 lost shards did not raise "
             "CheckpointCorrupt")
    return {"n": CKPT_N, "k": CKPT_K, "route": cc.rs.impl,
            "payload_gb": gb, "shard_bytes": man["shard_bytes"],
            "save_s": enc_s, "save_gb_per_s": gb / enc_s,
            "restore_s": dec_s, "restore_gb_per_s": gb / dec_s,
            "bit_equal": True, "third_loss_raises": True}


def phase_sim_replay(dev, tmp, adaptive_nwait) -> dict:
    """Phase 48: a stream-pool trace replayed and swept on virtual
    time."""
    path = os.path.join(tmp, "trace.jsonl")
    t0 = time.perf_counter()
    an_bench.record_trace(dev, path)
    record_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace = tsim.ReplayTrace.from_jsonl(path)
    drift = tsim.compare(trace, tsim.replay(trace))
    n, floor = trace.n_workers, trace.n_workers - an_bench.SGD_S
    delay = trace.delay_fn()
    epochs = [snap.epoch for snap in trace.epochs]

    def cycled(i, e):  # the recorded epochs, over and over
        return delay(i, epochs[(e - 1) % len(epochs)])

    sweep = tsim.sweep_nwait(cycled, n_workers=n, epochs=1000, floor=floor)
    model = PoolLatencyModel(n, seed=0)
    for e in epochs:
        for i in range(n):
            model.observe(i, delay(i, e))
    rec = tsim.recommend_nwait(model, floor=floor, epochs=1000, seed=0)
    wall_s = time.perf_counter() - t0
    print(f"  recorded {len(epochs)} epochs of {n} stream workers in "
          f"{record_s:.2f} s; replay at the recorded nwait: fresh sets "
          f"reproduced {drift['fresh_exact_rate']:.0%}, wall drift max "
          f"{drift['wall_drift_max_s']:.4f} s")
    print(f"  sweep over 1000 virtual epochs (floor {floor}): best "
          f"{sweep.best}, " + ", ".join(
              f"nwait {r['nwait']}: {r['mean_epoch_s'] * 1e3:.2f} ms"
              for r in sweep.entries)
          + f"; recommend_nwait sim {rec['sim_nwait']}, model "
          f"{rec['model_nwait']}; AdaptiveNwait's final nwait "
          f"{adaptive_nwait} (phase 40); {wall_s:.2f} s wall")
    _require(drift["fresh_exact_rate"] == 1.0,
             f"replay reproduced {drift['fresh_exact_rate']} of fresh sets")
    return {"record_s": record_s, "sim_wall_s": wall_s,
            "fresh_exact_rate": drift["fresh_exact_rate"],
            "wall_drift_max_s": drift["wall_drift_max_s"],
            "sweep_best": sweep.best, "sweep": sweep.entries,
            "recommend": {k: rec[k] for k in ("sim_nwait", "model_nwait",
                                               "agree")},
            "adaptive_final_nwait": adaptive_nwait}


def _qos_registry():
    return TenantRegistry([
        TenantContract("gold", weight=2.0),
        TenantContract("bronze", weight=1.0, pages=QOS_BRONZE_PAGES)])


def _qos_workload(vocab):
    """The system prompt + 64 own tokens per request; the first is gold,
    then 7 gold and 8 bronze."""
    rng = np.random.default_rng(9)
    sys_prompt = rng.integers(0, vocab, 256)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, vocab, QOS_OWN)])
               for _ in range(QOS_REQUESTS)]
    tenants = ["gold"] * (QOS_REQUESTS // 2) + ["bronze"] * (
        QOS_REQUESTS // 2)
    return prompts, tenants


def _qos_submit(sched, prompts, tenants, max_new):
    """Request 0 alone until its first token (its system-prompt pages
    are then registered), then the other 15 at once (on a FIFO
    scheduler the tenant only rides the request)."""
    first = sched.submit(prompts[0], max_new=max_new, tenant=tenants[0])
    while not first.tokens:
        sched.step()
    return [first] + [sched.submit(p, max_new=max_new, tenant=t)
                      for p, t in zip(prompts[1:], tenants[1:])]


def _qos_spies(sched) -> dict:
    """Admission order, and the shared pages that were cold at commit."""
    seen = {"admitted": [], "cold_reshares": 0}
    admit, commit = sched._admit_into, sched._commit_pages

    def admit_spy(s, req, plan, retired):
        seen["admitted"].append(req.tenant)
        return admit(s, req, plan, retired)

    def commit_spy(req, plan):
        seen["cold_reshares"] += sum(pid in sched._cold for pid in plan[0])
        return commit(req, plan)

    sched._admit_into, sched._commit_pages = admit_spy, commit_spy
    return seen


def phase_qos_serving(dev) -> tuple[dict, dict]:
    """Phase 49. Returns (launches of the f32 QoS run, report)."""
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    prompts, tenants = _qos_workload(cfg.vocab)
    zero_launches()
    sched = ServingScheduler(params, cfg, slots=SLOTS, n_inner=8,
                             prompt_chunk=256, max_prompt=512,
                             quantize_kv=True, page_tokens=PAGE,
                             qos=_qos_registry(), device=dev)
    _require(sched.use_kernel, "the S=8 paged int8 tick did not route K6")
    seen = _qos_spies(sched)
    reqs = _qos_submit(sched, prompts, tenants, QOS_NEW_F32)
    bronze_max = 0
    while sched.pending or sched.active:
        sched.step()
        bronze_max = max(bronze_max, sched._tenant_usage("bronze"))
    launches = launch_counts()
    pool = sched.pool
    want = cfg.n_layers * sched.n_inner * sched.decode_ticks
    burst = seen["admitted"][1:7]
    oracle = td.generate_ring_dense(
        params, torch.as_tensor(np.stack(prompts), device=dev), QOS_NEW_F32,
        cfg, quantize_kv=True, device=dev).cpu().numpy()
    same = sum(r.tokens == oracle[i].tolist() for i, r in enumerate(reqs))
    print(f"  f32: admission order {''.join(t[0] for t in seen['admitted'])}"
          f" (g = gold, b = bronze); {same}/{len(reqs)} streams equal "
          f"generate_ring_dense; bronze held at most {bronze_max} pages "
          f"(quota {QOS_BRONZE_PAGES}); share hits {pool.share_hits}, of "
          f"them {seen['cold_reshares']} on cold pages; {len(sched._cold)} "
          f"pages cold at the end; K6 {launches[K6]} launches (want "
          f"{want}), K5 {launches[K5]}")
    _require(same == len(reqs), "a QoS stream differs from the oracle")
    _require(len(burst) == 6 and burst.count("gold") == 4,
             f"the first admissions did not run 2:1: {burst}")
    _require(seen["cold_reshares"] > 0 and len(sched._cold) > 0,
             "no retired prefix page went cold and was reshared")
    _require(bronze_max <= QOS_BRONZE_PAGES,
             f"bronze held {bronze_max} pages over its quota")
    _require(launches[K6] == want and launches[K5] == 0,
             f"QoS run launched K6 {launches[K6]} (want {want}), K5 "
             f"{launches[K5]}")
    pool.check()
    rep = {"streams_equal_oracle": same, "admission_order":
           seen["admitted"], "share_hits": pool.share_hits,
           "cold_reshares": seen["cold_reshares"],
           "bronze_max_pages": bronze_max,
           "decode_ticks": sched.decode_ticks}
    del sched, params
    torch.cuda.empty_cache()
    # ms/tick at the main path's dtype: the same 16 requests, 8 decoding
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    ms = {"qos": [], "fifo": []}
    order = [v for i in range(QOS_PAIRS)
             for v in (("qos", "fifo") if i % 2 == 0 else ("fifo", "qos"))]
    for variant in order:
        sched = ServingScheduler(
            params, cfg, slots=SLOTS, n_inner=QOS_INNER, prompt_chunk=256,
            max_prompt=512, quantize_kv=True, page_tokens=PAGE,
            qos=_qos_registry() if variant == "qos" else None, device=dev)
        _qos_submit(sched, prompts, tenants, QOS_NEW_BF16)
        sched.step()  # the burst's admissions
        ms[variant].append(_timed_ticks(sched, QOS_TICKS) / QOS_TICKS * 1e3)
        _require(sched.active == SLOTS, f"{variant}: {sched.active} slots")
        del sched
    spread = {v: max(x) - min(x) for v, x in ms.items()}
    gap = float(np.mean(ms["qos"]) - np.mean(ms["fifo"]))
    print(f"  bf16 ms/tick ({QOS_INNER} inner steps, 8 slots decoding), "
          f"in turns {order}: qos {[round(x, 2) for x in ms['qos']]}, "
          f"fifo {[round(x, 2) for x in ms['fifo']]}; mean gap "
          f"{gap:+.2f} ms against spreads {spread['qos']:.2f} / "
          f"{spread['fifo']:.2f} ms")
    rep.update(ms_per_tick=ms, turns=order, gap_ms=gap, spread_ms=spread,
               resolved=abs(gap) > max(spread.values()))
    del params
    torch.cuda.empty_cache()
    return launches, rep


def phase_slice13(dev, t_start, adaptive_nwait) -> tuple[dict, dict, dict]:
    """Phases 46-49. Returns (phase 46's launches, phase 49's launches,
    report)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        print(f"  (+{time.perf_counter() - t_start:.1f} s)")
        print(f"[46] training resume: bf16, batch {BATCH}, L={SEQ}, AdamW "
              f"{RESUME_LR}: {RESUME_STEPS} steps straight against "
              f"{RESUME_STEPS // 2} + TrainCheckpointer + "
              f"{RESUME_STEPS // 2}, bit for bit")
        launches46, out["train_resume"], state = phase_train_resume(dev, tmp)
        print(f"  (+{time.perf_counter() - t_start:.1f} s)")
        print(f"[47] the resumed state through CodedCheckpoint({CKPT_N}, "
              f"{CKPT_K}): one shard lost, one corrupted, then a third")
        out["coded_checkpoint"] = phase_coded_checkpoint(state, tmp)
        del state
        torch.cuda.empty_cache()
        print(f"  (+{time.perf_counter() - t_start:.1f} s)")
        print("[48] sim replay: bench/adaptive_nwait.py's trace (16 stream "
              "workers) replayed on virtual time, swept over 1000 epochs")
        out["sim"] = phase_sim_replay(dev, tmp, adaptive_nwait)
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print(f"[49] QoS paged serving: S={SLOTS}, pages of {PAGE}, a shared "
          f"256-token system prompt, {QOS_REQUESTS} requests, gold (2) and "
          f"bronze (1, quota {QOS_BRONZE_PAGES} pages)")
    launches49, out["qos"] = phase_qos_serving(dev)
    return launches46, launches49, out


# phases 50-51: page-state migration and the fleet prefix cache on the
# paged main path (pages of 64, S=8, int8). One int8 page of MODEL is
# 8 layers x (2 x 64*2*128 int8 + 2 x 64*2 f32 scales) bytes.
MODEL_PAGE_BYTES = 270_336
MIG_PREFIX, MIG_OWN, MIG_NEW_F32 = 256, 64, 24
FLEET_PREFIX, FLEET_OWN, FLEET_NEW_F32 = 512, 64, 16
FLEET_STORE_PAGES, FLEET_PAIRS = 64, 3


def _paged_kw(dev, **kw):
    return {**dict(slots=SLOTS, n_inner=8, prompt_chunk=256, max_prompt=512,
                   quantize_kv=True, page_tokens=PAGE, device=dev), **kw}


def _stepped_k6(sched) -> int:
    """One tick of ``sched``; returns the K6 launches it made."""
    k0 = da.LAUNCHES[K6]
    sched.step()
    return da.LAUNCHES[K6] - k0


def _oracle_rows(params, cfg, prompts, n, dev) -> list:
    """generate_ring_dense (int8) of equal-length prompts, one call."""
    return td.generate_ring_dense(
        params, torch.as_tensor(np.stack(prompts), device=dev), n, cfg,
        quantize_kv=True, device=dev).cpu().numpy().tolist()


def phase_migration(dev) -> tuple[int, dict]:
    """Phase 50: eight f32 requests, four on one 256-token prefix, each
    migrated from a PrefillWorker to a DecodeReplica once it has its
    first token, alternately in process and through a MigrationRing;
    then the bf16 handoff and ring rates of ``bench/disagg.py``.
    Returns (K6 launches on the destination's ticks, report)."""
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(50)
    prefix = rng.integers(0, cfg.vocab, MIG_PREFIX)
    prompts = ([np.concatenate([prefix, rng.integers(0, cfg.vocab,
                                                      MIG_OWN)])
                for _ in range(4)]
               + [rng.integers(0, cfg.vocab, MIG_PREFIX + MIG_OWN)
                  for _ in range(4)])
    planner = MigrationPlanner()
    pw = PrefillWorker(ServingScheduler(params, cfg, **_paged_kw(dev)),
                       planner=planner)
    dr = DecodeReplica(ServingScheduler(params, cfg, **_paged_kw(dev)),
                       planner=planner)
    _require(dr.use_kernel, "the S=8 paged int8 tick did not route K6")
    # a slot per ticket segment: the prompt, the key, and per layer four
    # leaves of W rows, the int8 K and V the largest
    ring = MigrationRing(slot_bytes=cfg.attn_window * cfg.kv_heads
                         * cfg.head_dim, slots=2 + 4 * cfg.n_layers)
    reader = MigrationRingReader(ring)
    routes = {"in_process": 0, "frames": 0}
    dst_k6 = 0
    zero_launches()
    reqs = [pw.submit(p, max_new=MIG_NEW_F32) for p in prompts]
    moved: set[int] = set()
    while not all(r.finished for r in reqs):
        pw.step()
        for r in pw.ready():
            if r.id in moved:
                continue
            moved.add(r.id)
            if len(moved) % 2:
                dr.adopt(pw.migrate_out(r))
                routes["in_process"] += 1
            else:
                ticket = MigrationTicket(pw.sched.export_page_state(r))
                meta = ticket_to_frames(ticket, ring)
                dr.adopt(ticket_from_frames(meta, ticket.frames, reader),
                         request=r)
                ticket.release()
                routes["frames"] += 1
        dst_k6 += _stepped_k6(dr)
    launches = launch_counts()
    want_k6 = cfg.n_layers * dr.n_inner * dr.decode_ticks
    oracle = _oracle_rows(params, cfg, prompts, MIG_NEW_F32, dev)
    same = sum(r.tokens == o for r, o in zip(reqs, oracle))
    gc.collect()
    print(f"  f32: {len(moved)} migrations ({routes['in_process']} in "
          f"process, {routes['frames']} through the ring); {same}/"
          f"{len(reqs)} streams equal generate_ring_dense; destination "
          f"share hits {dr.pool.share_hits}; destination K6 {dst_k6} "
          f"launches (want {want_k6} = {cfg.n_layers} x {dr.n_inner} x "
          f"{dr.decode_ticks} ticks), K5 {launches[K5]} in the phase")
    _require(same == len(reqs), "a migrated stream differs from the oracle")
    _require(len(moved) == len(reqs) and min(routes.values()) > 0,
             f"migrations by route: {routes}")
    _require(dr.pool.share_hits > 0,
             "the shared prefix pages were not registered again on the "
             "destination")
    _require(dst_k6 == want_k6 and launches[K5] == 0,
             f"destination K6 {dst_k6} (want {want_k6}), K5 "
             f"{launches[K5]}")
    for pool in (pw.pool, dr.pool):
        pool.check()
        _require(pool.used == 0 and pool.reserved == 0,
                 f"a pool holds {pool.used} pages once drained")
    _require(ring.pinned == 0 and planner.in_flight == 0,
             f"{ring.pinned} ring slots pinned, {planner.in_flight} in "
             "flight once drained")
    reader.close()
    ring.close()
    rep = {"streams_equal_oracle": same, "routes": routes,
           "destination_share_hits": dr.pool.share_hits,
           "destination_decode_ticks": dr.decode_ticks,
           "destination_k6": dst_k6}
    del pw, dr, params
    torch.cuda.empty_cache()
    # the handoff and ring rates at the main path's dtype
    bench = disagg_bench.bench_disagg_live_rung(dev)
    hand = bench["handoff"]
    _require(hand["page_bytes"] == MODEL_PAGE_BYTES,
             f"a page is {hand['page_bytes']} bytes, want "
             f"{MODEL_PAGE_BYTES}")
    for route, r in hand["routes"].items():
        print(f"  bf16 handoff {route}: ms {[round(x, 3) for x in r['ms']]}"
              f", {r['pages'][0]} pages = {r['payload_bytes'][0]} bytes "
              f"(pages x {MODEL_PAGE_BYTES} = "
              f"{r['pages'][0] * MODEL_PAGE_BYTES})")
        _require(all(b == p * MODEL_PAGE_BYTES for b, p in
                     zip(r["payload_bytes"], r["pages"])),
                 f"{route}: migration_nbytes is not pages x page bytes")
    print(f"  ring: {bench['ring']['segments']} x "
          f"{bench['ring']['segment_bytes']} bytes one way at "
          f"{bench['ring']['migrate_gbs']:.3f} GB/s, "
          f"{bench['ring']['ring_stalls']} stalls; handoff streams equal "
          f"the never-migrated ones: {hand['streams_equal']}")
    rep["bench_bf16"] = bench
    torch.cuda.empty_cache()
    return dst_k6, rep


def _fleet_prompts(cfg, n, seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab, FLEET_PREFIX)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab, FLEET_OWN)])
            for _ in range(n)]


def _fleet_run(sched, reqs) -> int:
    """Tick ``sched`` until ``reqs`` retire; returns its K6 launches."""
    n = 0
    while not all(r.finished for r in reqs):
        n += _stepped_k6(sched)
    return n


def _first_token_ms(params, cfg, dev, prompt, hub) -> tuple[float, int]:
    """A fresh scheduler (on ``hub``, or cache-less) admits ``prompt``:
    ms from submit to its first token, card synchronized, and the
    prefill chunks it ran."""
    sched = ServingScheduler(params, cfg, **_paged_kw(
        dev, max_prompt=1024, cache=hub))
    r = sched.submit(prompt, max_new=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not r.tokens:
        sched.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _require(r.finished, "a one-token request did not retire at admission")
    if hub is not None:
        hub.kill(sched.cache_name)
    return ms, sched.prefill_chunks


def phase_fleet_cache(dev) -> tuple[int, dict]:
    """Phase 51: two paged schedulers on one FleetPrefixCache, a
    512-token shared prefix. DRAM route: A serves and retires two
    requests (their prefix pages spill), A is killed, B admits the
    prefix and fetches 8 pages; peer route (no DRAM tier): B fetches
    from A's live pages. f32 parity, then B's first token with the
    fetch against a cache-less prefill, bf16, in alternating pairs.
    Returns (K6 launches of the fetching replicas, report)."""
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    prompts = _fleet_prompts(cfg, 4, 51)
    kw = _paged_kw(dev, max_prompt=1024)
    zero_launches()
    hub = FleetPrefixCache(store_pages=FLEET_STORE_PAGES)
    reg_a, reg_b = tobs.MetricsRegistry(), tobs.MetricsRegistry()
    a = ServingScheduler(params, cfg, cache=hub, registry=reg_a, **kw)
    ra = [a.submit(p, max_new=FLEET_NEW_F32) for p in prompts[:2]]
    a.run()
    spilled = hub.store.pages
    hub.kill(a.cache_name)  # the owner dies between spill and fetch
    b = ServingScheduler(params, cfg, cache=hub, registry=reg_b, **kw)
    rb = b.submit(prompts[2], max_new=FLEET_NEW_F32)
    fetch_k6 = _fleet_run(b, [rb])
    dram_hits = reg_b.counter("serving_prefix_share_hits_total",
                              tier="dram").value
    chunks = (reg_a.counter("serving_prefill_chunks_total").value / 2,
              reg_b.counter("serving_prefill_chunks_total").value)
    want_b = cfg.n_layers * b.n_inner * b.decode_ticks
    n_pages = FLEET_PREFIX // PAGE
    print(f"  f32 DRAM route: A retired 2 requests, {hub.n_spills} pages "
          f"spilled ({spilled} resident), A killed; B fetched "
          f"{hub.n_fetches['dram']} pages (fleet_hit dram {dram_hits:g}), "
          f"prefill chunks per request A {chunks[0]:g} / B {chunks[1]:g}, "
          f"fallbacks {hub.n_fallbacks}; B's K6 {fetch_k6} (want {want_b})")
    _require(hub.n_fetches["dram"] == n_pages and dram_hits == n_pages,
             f"B fetched {hub.n_fetches['dram']} DRAM pages, want {n_pages}")
    _require(chunks[1] < chunks[0], f"prefill chunks A/B {chunks}")
    _require(hub.n_fallbacks == 0, f"{hub.n_fallbacks} DRAM fallbacks")
    _require(fetch_k6 == want_b, f"B's K6 {fetch_k6}, want {want_b}")
    hub.check()
    rep = {"dram": {"spilled": hub.n_spills, "fetched": hub.n_fetches[
        "dram"], "fleet_hit_dram": dram_hits, "prefill_chunks_a_per_req":
        chunks[0], "prefill_chunks_b": chunks[1],
        "fallbacks": hub.n_fallbacks}}
    # peer route: no DRAM tier, A holds the prefix mid-decode
    hub2 = FleetPrefixCache(store_pages=0)
    a2 = ServingScheduler(params, cfg, cache=hub2, **kw)
    b2 = ServingScheduler(params, cfg, cache=hub2, **kw)
    ra2 = a2.submit(prompts[0], max_new=FLEET_NEW_F32)
    while not ra2.tokens:
        a2.step()
    _require(not ra2.finished, "the peer's request retired before the fetch")
    rb2 = b2.submit(prompts[3], max_new=FLEET_NEW_F32)
    peer_k6 = _fleet_run(b2, [rb2])
    a2.run()
    want_b2 = cfg.n_layers * b2.n_inner * b2.decode_ticks
    launches = launch_counts()
    print(f"  f32 peer route: B fetched {hub2.n_fetches['peer']} pages from "
          f"A's live pages, fallbacks {hub2.n_fallbacks}; B's K6 {peer_k6} "
          f"(want {want_b2}); K5 {launches[K5]} in the phase")
    _require(hub2.n_fetches["peer"] == n_pages and hub2.n_fallbacks == 0,
             f"peer fetches {hub2.n_fetches}, fallbacks {hub2.n_fallbacks}")
    _require(peer_k6 == want_b2 and launches[K5] == 0,
             f"B's K6 {peer_k6} (want {want_b2}), K5 {launches[K5]}")
    hub2.check()
    oracle = _oracle_rows(params, cfg, prompts, FLEET_NEW_F32, dev)
    streams = [ra[0], ra[1], rb, rb2]
    same = sum(r.tokens == o for r, o in zip(streams, oracle))
    same += ra2.tokens == oracle[0]
    print(f"  {same}/5 streams equal generate_ring_dense")
    _require(same == 5, "a fleet-cache stream differs from the oracle")
    for s in (a, b, a2, b2):
        s.pool.check()
        _require(s.pool.used == 0, f"a pool holds {s.pool.used} pages")
    rep["peer"] = {"fetched": hub2.n_fetches["peer"],
                   "fallbacks": hub2.n_fallbacks}
    rep["streams_equal_oracle"] = same
    hub.close()
    hub2.close()
    del a, b, a2, b2, params
    torch.cuda.empty_cache()
    # bf16: B's first token with the fetch against a cache-less prefill
    cfg = TransformerConfig(**MODEL, dtype=torch.bfloat16)
    params = init_params(cfg, seed=0, device=dev)
    prompts = _fleet_prompts(cfg, 2 + 2 * FLEET_PAIRS, 52)
    hub = FleetPrefixCache(store_pages=FLEET_STORE_PAGES)
    seed = ServingScheduler(params, cfg, cache=hub, **kw)
    seed.submit(prompts[0], max_new=1)
    seed.run()
    hub.kill(seed.cache_name)
    for variant in (hub, None):  # warm-up, one of each
        _first_token_ms(params, cfg, dev, prompts[1], variant)
    ms = {"fetch": [], "prefill": []}
    chunks = {}
    order = [v for i in range(FLEET_PAIRS) for v in (
        ("fetch", "prefill") if i % 2 == 0 else ("prefill", "fetch"))]
    for i, variant in enumerate(order):
        t, chunks[variant] = _first_token_ms(
            params, cfg, dev, prompts[2 + i],
            hub if variant == "fetch" else None)
        ms[variant].append(t)
    _require(hub.n_fallbacks == 0, f"{hub.n_fallbacks} timing fallbacks")
    spread = {v: max(x) - min(x) for v, x in ms.items()}
    gap = float(np.mean(ms["prefill"]) - np.mean(ms["fetch"]))
    print(f"  bf16 submit -> first token of a {FLEET_PREFIX + FLEET_OWN}"
          f"-token prompt, in turns {order}: fetch (8 DRAM pages + "
          f"{chunks['fetch']} chunk) {[round(x, 2) for x in ms['fetch']]} "
          f"ms, prefill ({chunks['prefill']} chunks) "
          f"{[round(x, 2) for x in ms['prefill']]} ms; mean gap "
          f"{gap:+.2f} ms against spreads {spread['fetch']:.2f} / "
          f"{spread['prefill']:.2f} ms")
    rep["first_token_bf16"] = {
        "ms": ms, "turns": order, "prefill_chunks": chunks, "gap_ms": gap,
        "spread_ms": spread, "resolved": abs(gap) > max(spread.values()),
        "dram_fetches": hub.n_fetches["dram"]}
    hub.close()
    del params
    torch.cuda.empty_cache()
    return fetch_k6 + peer_k6, rep


def phase_slice14(dev, t_start) -> tuple[int, int, dict]:
    """Phases 50-51. Returns (phase 50's destination K6 launches, phase
    51's fetching replicas' K6 launches, report)."""
    out = {}
    t0 = time.perf_counter()
    print(f"  (+{t0 - t_start:.1f} s)")
    print(f"[50] page-state migration: PrefillWorker -> DecodeReplica, "
          f"S={SLOTS}, pages of {PAGE}, 8 requests (4 on a "
          f"{MIG_PREFIX}-token prefix), in process and through the ring")
    k6_50, out["migration"] = phase_migration(dev)
    t1 = time.perf_counter()
    out["migration"]["seconds"] = t1 - t0
    print(f"  (+{t1 - t_start:.1f} s)")
    print(f"[51] the fleet prefix cache: a {FLEET_PREFIX}-token prefix "
          f"spilled to DRAM and fetched after its owner is killed, then "
          f"fetched from a peer's live pages")
    k6_51, out["fleet_cache"] = phase_fleet_cache(dev)
    out["fleet_cache"]["seconds"] = time.perf_counter() - t1
    return k6_50, k6_51, out



# phases 52-54: the planes above serving. The router over four live paged
# replicas (S=8, pages of 64, int8), two_tier through the tier wrappers,
# then the host planes (the router-day simulator, fleet control, chaos)
ROUTE_PREFIX, ROUTE_OWN, ROUTE_NEW_F32 = 192, 64, 16
ROUTE_POLICIES = ("round_robin", "least_loaded", "prefix_affinity",
                  "hedge_p99")
ROUTE_LIVE_REQUESTS, ROUTE_LIVE_REPEATS = 24, 1
ROUTE_SIM_REQUESTS, ROUTE_SIM_WITNESS = 100_000, 10_000
FLEET_DAY_REQUESTS, CHAOS_SCALE = 3000, 0.5


def _route_prompts(cfg):
    """Four prompts of 256 tokens (one admission chunk), the first two
    on one 192-token prefix."""
    rng = np.random.default_rng(52)
    prefix = rng.integers(0, cfg.vocab, ROUTE_PREFIX)
    return ([np.concatenate([prefix, rng.integers(0, cfg.vocab, ROUTE_OWN)])
             for _ in range(2)]
            + [rng.integers(0, cfg.vocab, ROUTE_PREFIX + ROUTE_OWN)
               for _ in range(2)])


def _route_f32(params, cfg, dev, prompts, oracle, policy, tick_s):
    """One policy over four fresh paged replicas; returns its report."""
    kw = {}
    scheds = [ServingScheduler(params, cfg, **_paged_kw(dev))
              for _ in range(4)]
    if policy == "hedge_p99":
        # replica 0 ticks once, then waits out the phase: its one tick
        # prefills half the 256-token prompt (chunks of 128), so its leg
        # misses the deadline mid-admission, the hedge onto a live
        # replica wins, and the loser is cancelled mid-admission
        half = (ROUTE_PREFIX + ROUTE_OWN) // 2
        scheds[0] = router_bench.live_fleet(
            params, cfg, 3600.0, _paged_kw(dev, prompt_chunk=half), n=1,
            slow=0)[0].inner
        kw["ttft_slo"] = 16 * tick_s
    _require(all(s.use_kernel for s in scheds),
             "a replica's S=8 paged int8 tick did not route K6")
    router = RequestRouter(scheds, policy=policy, **kw)
    first = router.submit(prompts[0], ROUTE_NEW_F32)
    if policy == "prefix_affinity":
        # the prefix pages register when the first sharer's admission
        # ends: it holds its first token before the others arrive, and
        # stays resident (16 new tokens: two decode ticks) while the
        # second sharer admits
        while not first.tokens:
            router.step()
    rrs = [first] + [router.submit(p, ROUTE_NEW_F32) for p in prompts[1:]]
    t0 = time.perf_counter()
    router.drain()
    wall = time.perf_counter() - t0
    same = sum(list(rr.tokens) == o for rr, o in zip(rrs, oracle))
    rep = {"streams_equal_oracle": same,
           "replicas": [rr.replica for rr in rrs],
           "outcomes": [rr.outcome for rr in rrs],
           "hedges": router.n_hedges,
           "share_hits": [s.pool.share_hits for s in scheds],
           "ticks": [s.tick_count for s in scheds], "drain_s": wall}
    print(f"  f32 {policy}: {same}/{len(rrs)} streams equal "
          f"generate_ring_dense; replicas {rep['replicas']}, outcomes "
          f"{rep['outcomes']}, hedges {router.n_hedges}, share hits "
          f"{rep['share_hits']}")
    _require(same == len(rrs), f"{policy}: a routed stream differs from "
             "the oracle")
    if policy == "prefix_affinity":
        _require(rrs[1].replica == first.replica
                 and scheds[first.replica].pool.share_hits > 0,
                 "prefix_affinity: the sharer missed the prefix's pages")
    if policy == "hedge_p99":
        slow = scheds[0]
        _require(router.n_hedges > 0 and any(
            rr.outcome == "hedge_won" for rr in rrs),
            "hedge_p99: no hedge fired and won")
        _require(slow.tick_count == 1 and slow.prefill_chunks == 1,
                 f"hedge_p99: the slow replica ticked {slow.tick_count} "
                 f"times, prefilled {slow.prefill_chunks} chunks (want "
                 "one of two)")
        _require(slow.active == 0 and slow.pending == 0,
                 "hedge_p99: the slow replica's losing leg was not "
                 "cancelled")
    for s in scheds:
        s.pool.check()
        _require(s.pool.used == 0, f"{policy}: a pool holds "
                 f"{s.pool.used} pages once drained")
    return rep


def phase_router_live(dev, params, cfg, prompts, oracle) -> tuple[int, dict]:
    """Phase 52: the router over four live paged replicas. Returns (K6
    launches over the phase, report)."""
    out = {"f32": {}}
    zero_launches()
    # the f32 tick, for the hedge deadline: one replica, one request
    warm = ServingScheduler(params, cfg, **_paged_kw(dev))
    warm.submit(prompts[2], ROUTE_NEW_F32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while warm.pending or warm.active:
        warm.step()
    torch.cuda.synchronize()
    tick_s = (time.perf_counter() - t0) / warm.tick_count
    out["f32"]["tick_s"] = tick_s
    del warm
    for policy in ROUTE_POLICIES:
        out["f32"][policy] = _route_f32(params, cfg, dev, prompts, oracle,
                                        policy, tick_s)
    torch.cuda.empty_cache()
    # the live half of bench/router.py at the main path's dtype
    live = router_bench.bench_router_live_rung(
        dev, requests=ROUTE_LIVE_REQUESTS, repeats=ROUTE_LIVE_REPEATS)
    out["bf16"] = live
    for r in live["runs"]:
        print(f"  bf16 {r['policy']}: TTFT p50 {r['p50_ttft_s'] * 1e3:.2f} "
              f"ms, p99 {r['p99_ttft_s'] * 1e3:.2f} ms; router share "
              f"{r['router_share']:.4f} of {r['stepping_wall_s']:.2f} s")
    kill = live["kill_leg"]
    print(f"  warm tick {live['tick_s'] * 1e3:.2f} ms, replica 3 gated to "
          f"{live['stall_s'] * 1e3:.2f} ms; fleet {live['fleet_req_per_s']:.2f}"
          f" req/s closed, paced at 0.8; live_p99_x {live['live_p99_x']}; "
          f"kill leg: {kill['dropped']} dropped, {kill['rerouted']} "
          f"re-routed of {kill['requests']}")
    _require(kill["dropped"] == 0 and kill["rerouted"] > 0,
             f"kill leg: {kill}")
    launches = launch_counts()
    _require(launches[K6] > 0 and launches[K5] == 0,
             f"phase 52 launched K6 {launches[K6]}, K5 {launches[K5]}")
    return launches[K6], out


def phase_two_tier_live(dev, params, cfg, prompts, oracle) -> tuple[int, dict]:
    """Phase 53: two PrefillWorkers and two DecodeReplicas on one
    MigrationPlanner under the two_tier router, f32. Returns (K6
    launches on the decode tier's ticks, report)."""
    planner = MigrationPlanner()
    reg = tobs.MetricsRegistry()
    decode_k6 = [0]

    def counted(rep):
        inner = rep.step

        def step():
            k0 = da.LAUNCHES[K6]
            done = inner()
            decode_k6[0] += da.LAUNCHES[K6] - k0
            return done
        rep.step = step
        return rep

    fleet = ([PrefillWorker(ServingScheduler(params, cfg, **_paged_kw(dev)),
                            planner=planner) for _ in range(2)]
             + [counted(DecodeReplica(
                 ServingScheduler(params, cfg, **_paged_kw(dev)),
                 planner=planner)) for _ in range(2)])
    _require(all(r.use_kernel for r in fleet),
             "a tier's S=8 paged int8 tick did not route K6")
    router = RequestRouter(fleet, policy="two_tier", registry=reg)
    zero_launches()
    rrs = [router.submit(p, ROUTE_NEW_F32) for p in prompts]
    router.drain()
    launches = launch_counts()
    same = sum(list(rr.tokens) == o for rr, o in zip(rrs, oracle))
    migrated = [rr for rr in rrs if rr.migrated]
    series = sorted(n for n in reg.snapshot() if n.startswith("disagg_"))
    print(f"  f32: {same}/{len(rrs)} streams equal generate_ring_dense; "
          f"{router.n_migrated} migrated ({router.migrated_bytes} bytes), "
          f"{router.n_kept_local} kept local; outcomes "
          f"{[rr.outcome for rr in rrs]}; decode tier K6 {decode_k6[0]}, "
          f"K5 {launches[K5]}; series {series}")
    _require(same == len(rrs), "a two_tier stream differs from the oracle")
    _require(router.n_migrated > 0 and migrated
             and all(rr.outcome == "migrated" for rr in migrated),
             "two_tier: no migration, or a migrated outcome is not named")
    _require({"disagg_migrations_total", "disagg_migrated_bytes_total",
              "disagg_tier_depth"} <= set(series),
             f"two_tier: the disagg series are missing: {series}")
    _require(decode_k6[0] > 0 and launches[K5] == 0,
             f"decode tier K6 {decode_k6[0]}, K5 {launches[K5]}")
    for r in fleet:
        r.pool.check()
        _require(r.pool.used == 0, "a tier's pool holds pages once drained")
    return decode_k6[0], {"streams_equal_oracle": same,
                          "migrated": router.n_migrated,
                          "migrated_bytes": router.migrated_bytes,
                          "kept_local": router.n_kept_local,
                          "outcomes": [rr.outcome for rr in rrs],
                          "series": series, "decode_k6": decode_k6[0]}


def phase_host_planes() -> dict:
    """Phase 54: the router-day simulator on both drivers, the policy
    sweep, an elastic fleet day with a coordinator kill, every chaos
    episode twice (numpy on the host; no pool is spawned)."""
    out = {}
    t0 = time.perf_counter()
    sim = router_bench.bench_router_rung(
        ROUTE_SIM_REQUESTS, witness=ROUTE_SIM_WITNESS)
    out["router_day"] = sim
    out["router_day"]["seconds"] = time.perf_counter() - t0
    print(f"  router day ({ROUTE_SIM_REQUESTS} requests, 8 SimReplicas): "
          f"scalar {sim['scalar']['req_per_s']:.0f} req/s, fast "
          f"{sim['fast']['req_per_s']:.0f} req/s ({sim['fast']['path']}), "
          f"one digest {sim['fast']['digest']}; witness "
          f"{sim['replay_digest']}; sweep at 0.8 load, 1.8x straggler: "
          f"{sim['sweep_best']} wins, router_p99_x {sim['router_p99_x']:.3f}")
    t1 = time.perf_counter()
    fl = fleet_bench.bench_fleet_rung(FLEET_DAY_REQUESTS)
    fl["seconds"] = time.perf_counter() - t1
    out["fleet"] = fl
    print(f"  fleet day ({FLEET_DAY_REQUESTS} requests): "
          f"{fl['fleet_failover_drops']} dropped, {fl['failovers']} takeover, "
          f"{fl['resizes']} resizes, chip-time x{fl['fleet_chip_time_x']:.3f}, "
          f"digest {fl['digest']}")
    _require(fl["fleet_failover_drops"] == 0 and fl["failovers"] == 1,
             f"fleet day: {fl}")
    t2 = time.perf_counter()
    ch = chaos_bench.bench_chaos_suite(scale=CHAOS_SCALE)
    out["chaos"] = ch
    out["chaos_seconds"] = time.perf_counter() - t2
    for name, r in ch.items():
        print(f"  chaos {name}: digest {r['digest']} twice, invariants "
              f"{r['invariants']}, shed {r['shed']}")
    return out


def phase_slice15(dev, t_start) -> tuple[int, int, dict]:
    """Phases 52-54. Returns (phase 52's K6 launches, phase 53's decode
    tier's K6 launches, report)."""
    out = {}
    t0 = time.perf_counter()
    print(f"  (+{t0 - t_start:.1f} s)")
    print(f"[52] the router over four live paged replicas, S={SLOTS}, pages "
          f"of {PAGE}: f32 {len(ROUTE_POLICIES)} policies x 4 requests "
          f"against the oracle, then bench/router.py's live half in bf16 "
          f"({ROUTE_LIVE_REQUESTS} requests, {ROUTE_LIVE_REPEATS} pairs, "
          f"kill leg)")
    cfg = TransformerConfig(**MODEL, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=dev)
    prompts = _route_prompts(cfg)
    oracle = _oracle_rows(params, cfg, prompts, ROUTE_NEW_F32, dev)
    k6_52, out["router"] = phase_router_live(dev, params, cfg, prompts,
                                             oracle)
    t1 = time.perf_counter()
    out["router"]["seconds"] = t1 - t0
    print(f"  (+{t1 - t_start:.1f} s)")
    print("[53] two_tier live: two PrefillWorkers, two DecodeReplicas, one "
          "MigrationPlanner, f32")
    k6_53, out["two_tier"] = phase_two_tier_live(dev, params, cfg, prompts,
                                                 oracle)
    del params
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    out["two_tier"]["seconds"] = t2 - t1
    print(f"  (+{t2 - t_start:.1f} s)")
    print("[54] the host planes: the router day on both drivers, the policy "
          "sweep, an elastic fleet day with a coordinator kill, every chaos "
          "episode twice")
    out["host_planes"] = phase_host_planes()
    out["host_planes"]["seconds"] = time.perf_counter() - t2
    return k6_52, k6_53, out



# -- phases 55-56: fused windows and the mesh plane (slice 16) -------------

WINDOW_K = 16      # phase 55's parity windows (two back to back)
LADDER_EPOCHS = 128
MESH_N, MESH_K = 8, 6
MESH_LATE = (0, 7)


def _window_parity(dev, decode) -> dict:
    """Phase 55's parity leg for one code, in f64 on the card: two
    back-to-back graph windows against the host loop over SimBackend on
    the same virtual schedule."""
    from mpistragglers_jl_tpu_torch.ops.coded_gemm import LTCodedGemm
    from mpistragglers_jl_tpu_torch.ops.hierarchical import (
        HierarchicalCodedGemm,
    )
    from mpistragglers_jl_tpu_torch.parallel.device_coord import (
        DeviceCoordinator,
        _GraphWindow,
    )
    from mpistragglers_jl_tpu_torch.utils import faults

    rng = np.random.default_rng(55)
    base = faults.seeded_lognormal(0.01, 0.6, seed=3)
    if decode == "hierarchical":
        A = rng.standard_normal((2 * 3 * 64, 256))
        g = HierarchicalCodedGemm(A, groups=3, n_inner=4, k_inner=3,
                                  dtype=np.float64, devices=[dev],
                                  device_backend=False)
        n = 12

        def delay(w, e):
            return base(w, e) + (50.0 if 4 <= w < 8 else 0.0)

        coord = DeviceCoordinator.for_hierarchical(g, delay_fn=delay)
        nwait = g.nwait
    else:
        n = 8
        A = rng.standard_normal((6 * 128, 256))

        def delay(w, e):
            return base(w, e) + (0.04 if w == 5 else 0.0)

        if decode == "mds":
            g = CodedGemm(A, 8, 6, devices=[dev], dtype=np.float64)
            nwait = 6
        else:
            g = LTCodedGemm(A, 8, 6, devices=[dev], seed=1,
                            dtype=np.float64)
            nwait = 8
        coord = g.coordinator(delay_fn=delay, nwait=nwait)
    B = rng.standard_normal((256, 128))
    be = tsim.SimBackend(lambda i, p, e: p, n, delay_fn=delay)
    hpool = AsyncPool(n)
    host = np.stack([asyncmap(hpool, B, be, nwait=nwait).copy()
                     for _ in range(2 * WINDOW_K)])
    pool = AsyncPool(n)
    want = A @ B
    fused, err = [], 0.0
    t0 = time.perf_counter()
    for _ in range(2):
        fused.append(asyncmap_fused(pool, B, coord, epochs=WINDOW_K))
        dec = coord.last_decoded.cpu().numpy()[:, :want.shape[0]]
        err = max(err, float(np.abs(dec - want).max()
                             / np.abs(want).max()))
    wall = time.perf_counter() - t0
    if g.backend is not None:
        g.backend.shutdown()
    graphs = all(isinstance(p, _GraphWindow) and p.graph is not None
                 for p in coord._programs.values())
    equal = bool(np.array_equal(np.concatenate(fused), host))
    _require(graphs, f"{decode} window: not a captured CUDA graph")
    _require(equal, f"{decode} window: repochs differ from the host loop")
    _require(err < 1e-9, f"{decode} window: decode error {err:.3e}")
    stale = int((host < np.arange(1, 2 * WINDOW_K + 1)[:, None]).sum())
    return {"repochs_equal": equal, "graph": graphs, "rel_err": err,
            "stale_or_late_stamps": stale, "two_windows_s": wall}


def phase_fused_windows(dev) -> dict:
    """Phase 55."""
    out = {}
    for decode in ("mds", "lt", "hierarchical"):
        out[decode] = r = _window_parity(dev, decode)
        print(f"  {decode}: 2 x K={WINDOW_K} graph windows, repochs "
              f"bit-equal to the host loop ({r['stale_or_late_stamps']} "
              f"non-fresh stamps), decode rel err {r['rel_err']:.2e}")
    torch.cuda.empty_cache()
    c3 = dc_bench.config3(dev)
    out["config3"] = c3
    for name in ("host_loop_ready", "host_loop_enqueue", "window"):
        r = c3[name]
        print(f"  config 3 {name}: {r['ms_per_epoch']:.3f} ms/epoch, idle "
              f"share {r.get('device_idle_share', float('nan')):.3f}, rel "
              f"err {r['rel_err']:.2e} (limit {r['rel_tol']:.2e})")
    print(f"  config 3 window: idle share at least "
          f"{c3['window']['event_idle_share_floor']:.3f} by CUDA events")
    _require(c3["ok"] and c3["window"]["graph"], f"config 3 window: {c3}")
    torch.cuda.empty_cache()
    lad = dc_bench.ladder(dev, epochs=LADDER_EPOCHS)
    out["ladder"] = lad
    print(f"  ladder, {LADDER_EPOCHS} epochs: host "
          f"{lad['host_ms_per_epoch']:.4f} ms/epoch; " + ", ".join(
              f"{k} {r['ms_per_epoch']:.4f}"
              for k, r in lad["ladder"].items())
          + f"; swept K={lad['devcoord_harvest_k']}, overhead x"
          f"{lad['devcoord_overhead_x']:.2f}")
    return out


def _rank_ms(fn, reps=3) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_mesh_plane(dev) -> dict:
    """Phase 56."""
    from mpistragglers_jl_tpu_torch.ops._batch import matmul
    from mpistragglers_jl_tpu_torch.parallel import (
        DeviceCoordinator,
        MeshCodedGemm,
        MeshMatDotGemm,
        PoolMeshCodedGemm,
        make_mesh,
        ring_allgather,
        shard,
    )
    from mpistragglers_jl_tpu_torch.parallel.mesh import PartitionSpec
    from mpistragglers_jl_tpu_torch.utils import faults

    out = {}
    mesh = make_mesh(MESH_N, devices=[dev] * MESH_N)
    one = make_mesh(1, devices=[dev])
    rng = np.random.default_rng(56)
    A = rng.standard_normal((MESH_K * 512, 1024)).astype(np.float32)
    B = rng.standard_normal((1024, 512)).astype(np.float32)
    want = A.astype(np.float64) @ B.astype(np.float64)

    def rel(got):
        return float(np.abs(np.asarray(got) - want).max()
                     / np.abs(want).max())

    mg = MeshCodedGemm(A, mesh, MESH_K)
    repochs = np.full(MESH_N, 5)
    repochs[list(MESH_LATE)] = 4
    fresh = np.flatnonzero(repochs == 5)[:MESH_K]
    cond = float(np.linalg.cond(mg.code.G.astype(np.float64)[fresh]))
    limit = 1e-5 * cond
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    err = rel(mg.full(mg.epoch(B, repochs, 5)))
    out["mesh_coded"] = {"rel_err": err, "limit": limit,
                         "epoch_s": time.perf_counter() - t0}
    Bd = torch.from_numpy(B).to(dev)
    out["rank_map_ms"] = [
        _rank_ms(lambda w=w: matmul(mg.blocks.local(w)[0], Bd, "highest"))
        for w in range(MESH_N)]
    _require(err < limit, f"MeshCodedGemm: {err:.3e} > {limit:.3e}")
    print(f"  MeshCodedGemm, ranks {MESH_LATE} stale: rel err {err:.2e} "
          f"(limit {limit:.2e}); each rank's map, ms: "
          + " ".join(f"{x:.3f}" for x in out["rank_map_ms"]))
    md = MeshMatDotGemm(A, mesh, p=2)
    md_rep = np.full(MESH_N, 3)
    md_rep[[2, 6]] = 2
    err = rel(np.asarray(md.epoch(B, md_rep, 3)))
    out["mesh_matdot"] = {"rel_err": err}
    _require(err < 1e-3, f"MeshMatDotGemm: {err:.3e}")
    print(f"  MeshMatDotGemm p=2, ranks (2, 6) stale: rel err {err:.2e}")

    def delay(i, e):
        return 0.2 if i in MESH_LATE else 0.0

    for label, m, nw in (("one worker per rank", mesh, None),
                         ("folded on one rank", one, MESH_N)):
        fg = PoolMeshCodedGemm(A, m, MESH_K, n_workers=nw, delay_fn=delay)
        pool = AsyncPool(MESH_N)
        try:
            t0 = time.perf_counter()
            dec = fg.epoch(pool, B, timeout=60.0)
            C = fg.full(dec)
            dt = time.perf_counter() - t0
            late_out = all(pool.active[i] and pool.repochs[i] != pool.epoch
                           for i in MESH_LATE)
            idx = pool.fresh_indices()[:MESH_K]
            lim = 1e-5 * float(np.linalg.cond(
                fg.code.G.astype(np.float64)[idx]))
            err = rel(C)
            waitall(pool, fg.backend, timeout=60.0)
        finally:
            fg.shutdown()
        out[f"pool_mesh_{'fold' if nw else 'ranks'}"] = {
            "rel_err": err, "limit": lim, "stragglers_out": late_out,
            "epoch_s": dt}
        _require(late_out and err < lim,
                 f"PoolMeshCodedGemm {label}: {err:.3e}, {late_out}")
        print(f"  PoolMeshCodedGemm {label}: workers {MESH_LATE} out at "
              f"return, rel err {err:.2e} (limit {lim:.2e}), "
              f"{dt * 1e3:.1f} ms")
    # the mesh window against the flat window, f64
    A64, B64 = A[:MESH_K * 64, :256].astype(np.float64), B[:256, :64]
    B64 = B64.astype(np.float64)
    base = faults.seeded_lognormal(0.01, 0.7, seed=3)

    def wdelay(w, e):
        return base(w, e) + (30.0 if w == 2 else 0.0)

    fg = PoolMeshCodedGemm(A64, mesh, MESH_K, dtype=np.float64)
    try:
        coord = fg.device_coordinator(delay_fn=wdelay)
        t0 = time.perf_counter()
        mesh_hist = asyncmap_fused(AsyncPool(MESH_N), B64, coord, epochs=6)
        mesh_s = time.perf_counter() - t0
        mesh_dec = [coord.full(np.asarray(coord.last_decoded)[j])
                    for j in range(6)]
        last_full = coord.last_window["last_full"].cpu().numpy()
        flat = DeviceCoordinator(
            torch.stack(fg.blocks), decode="mds", G=fg.code.G, k=MESH_K,
            delay_fn=wdelay, device=dev)
        flat_hist = asyncmap_fused(AsyncPool(MESH_N), B64, flat, epochs=6)
        flat_dec = flat.last_decoded.cpu().numpy()
    finally:
        fg.shutdown()
    w_err = max(float(np.abs(m_ - f_).max() / np.abs(f_).max())
                for m_, f_ in zip(mesh_dec, flat_dec))
    full_err = float(np.abs(last_full - A64 @ B64).max()
                     / np.abs(A64 @ B64).max())
    same = bool(np.array_equal(mesh_hist, flat_hist))
    out["mesh_window"] = {"repochs_equal_flat": same, "rel_err_vs_flat":
                          w_err, "last_full_rel_err": full_err,
                          "window_s": mesh_s}
    _require(same and w_err < 1e-12 and full_err < 1e-9,
             f"mesh window: {out['mesh_window']}")
    print(f"  mesh DeviceCoordinator window (K=6, f64): repochs equal the "
          f"flat window's, blocks within {w_err:.1e}, ring-gathered "
          f"product {full_err:.1e}, {mesh_s * 1e3:.1f} ms")
    blocks = torch.randn(MESH_N, 256, 512, device=dev)
    t0 = time.perf_counter()
    g = ring_allgather(mesh)(shard(blocks, mesh, PartitionSpec("w")))
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    full = blocks.reshape(-1, 512)
    exact = all(torch.equal(g.local(r)[0], full) for r in range(MESH_N))
    out["ring_allgather"] = {"exact": exact, "s": ring_s}
    _require(exact, "ring_allgather: a rank's copy differs")
    print(f"  ring_allgather over 8 ranks of (256, 512) f32: every rank "
          f"holds the full (2048, 512) bit for bit, {ring_s * 1e3:.1f} ms "
          "(one card: no collective speed claimed)")
    return out


def phase_slice16(dev, t_start) -> dict:
    """Phases 55-56."""
    out = {}
    t0 = time.perf_counter()
    print(f"  (+{t0 - t_start:.1f} s)")
    print(f"[55] fused K-epoch windows on the card: MDS, LT and "
          f"hierarchical parity (f64, 2 x K={WINDOW_K}, CUDA graphs), "
          f"config 3's window at K=8, the ladder at {LADDER_EPOCHS} epochs")
    out["fused_windows"] = phase_fused_windows(dev)
    t1 = time.perf_counter()
    out["fused_windows"]["seconds"] = t1 - t0
    torch.cuda.empty_cache()
    print(f"  (+{t1 - t_start:.1f} s)")
    print(f"[56] the mesh plane, {MESH_N} ranks on one card: MeshCodedGemm, "
          "MeshMatDotGemm, PoolMeshCodedGemm (per rank and folded), a mesh "
          "window, ring_allgather")
    out["mesh_plane"] = phase_mesh_plane(dev)
    out["mesh_plane"]["seconds"] = time.perf_counter() - t1
    torch.cuda.empty_cache()
    return out


# -- phase 57: the sharded transformer (slice 17) ---------------------------

SHARD_AXES = ("dp", "sp", "tp")
SHARD_MESH = (2, 2, 2)
SHARD_F32_LAYERS = 2  # phase 57(a): phase 13's shape at 2 layers
SHARD_TIMED = 2       # phase 57(b): 1 warm-up and 2 timed steps a mesh
# (3 before phase 60 took item 18h's runs: a depth cut, no check)
SHARD_CTRL_RANK = 0   # the control drops the tp psum on this rank


def _card_mesh(dev, shape):
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    return make_mesh(shape, SHARD_AXES, devices=[dev] * int(np.prod(shape)))


@contextlib.contextmanager
def _tp_psum_dropped():
    """The control of phase 57: on rank ``SHARD_CTRL_RANK`` the tp psum
    returns the rank's own partial sum (its tp partners' heads and MLP
    columns dropped); every other collective runs as it should."""
    from mpistragglers_jl_tpu_torch.models import transformer as tmod

    right = tmod.psum

    def dropped(xs, mesh, axes, **kw):
        out = right(xs, mesh, axes, **kw)
        if axes == "tp":
            out[SHARD_CTRL_RANK] = xs[SHARD_CTRL_RANK].clone()
        return out

    tmod.psum = dropped
    try:
        yield
    finally:
        tmod.psum = right


@contextlib.contextmanager
def _grad_sum_dropped(axis):
    """The update control of phase 57(b): the replica-gradient sum (the
    one ``psum`` called with a ``dtype``) skips ``axis``, so each
    replica steps on its own ``axis`` member's share of the gradient
    alone; the forward's collectives run as they should."""
    from mpistragglers_jl_tpu_torch.models import transformer as tmod

    right = tmod.psum

    def dropped(xs, mesh, axes, **kw):
        if kw.get("dtype") is not None:
            axes = [a for a in axes if a != axis]
        return right(xs, mesh, axes, **kw)

    tmod.psum = dropped
    try:
        yield
    finally:
        tmod.psum = right


def _dense_of(grads, dev) -> dict:
    """A tree of ShardedTensors as the dense tree on ``dev``."""
    return _rebuild(grads, iter(g.gather(dev) for g in _leaves(grads)))


def _replicas_bit_equal(tree) -> bool:
    """Every leaf's positions that hold one block hold equal bits."""
    for leaf in _leaves(tree):
        named = {n for a in leaf.spec if a is not None
                 for n in ((a,) if isinstance(a, str) else a)}
        over = [a for a in leaf.mesh.axis_names if a not in named]
        for group in leaf.mesh.axis_groups(over):
            first = leaf.local(group[0])
            if not all(torch.equal(leaf.local(r), first) for r in group[1:]):
                return False
    return True


def _sharded_f32_leg(dev, label, shape, **kw) -> dict:
    """One leg of phase 57(a): the sharded loss and gradients at full
    width (2 layers, batch 2, f32) against the dense ``loss_and_grads``
    with the reference attention; and, on the first leg, the control."""
    from mpistragglers_jl_tpu_torch.models.transformer import (
        shard_params,
        sharded_loss_and_grads,
    )

    cfg = dataclasses.replace(_train_cfg(torch.float32),
                              n_layers=SHARD_F32_LAYERS, **kw)
    params = init_params(cfg, seed=0, device=dev)
    inp, tgt = (t[:2] for t in train_batch(cfg.vocab, dev))
    loss_r, g_r = loss_and_grads(
        params, inp, tgt, dataclasses.replace(cfg, attn_impl="reference"))
    mesh = _card_mesh(dev, shape)
    sp = shard_params(params, cfg, mesh)
    zero_launches()
    loss, grads = sharded_loss_and_grads(sp, inp, tgt, cfg, mesh)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    rel = abs(loss.item() - loss_r.item()) / abs(loss_r.item())
    grad = max(_leaf_errors(_dense_of(grads, dev), g_r, relative_norm=False))
    equal = _replicas_bit_equal(grads)
    del grads
    k = (SHARD_F32_LAYERS * mesh.size if cfg.attn_impl == "flash" else 0)
    want = {"flash_fwd": k, "flash_bwd_dq": k, "flash_bwd_dkv": k,
            "flash_bwd_fused": 0}
    print(f"  {label} on {shape}: loss rel err {rel:.3e} (limit "
          f"{TRAIN_F32_LOSS:.0e}), worst grad leaf {grad:.3e} of its max "
          f"(limit {TRAIN_F32_GRAD:.0e}), replicas bit-equal {equal}; "
          f"launches { {FLASH[n][0]: v for n, v in launches.items()} }")
    _require(rel <= TRAIN_F32_LOSS and grad <= TRAIN_F32_GRAD and equal,
             f"sharded f32 {label} disagrees with the dense step: loss "
             f"{rel}, grad {grad}, replicas equal {equal}")
    _require(launches == want, f"sharded f32 {label} launched {launches}")
    out = {"mesh": list(shape), "loss_rel_err": rel, "grad_rel_err": grad,
           "launches": launches}
    if label == "ulysses":
        with _tp_psum_dropped():
            loss_c, g_c = sharded_loss_and_grads(sp, inp, tgt, cfg, mesh)
        c_rel = abs(loss_c.item() - loss_r.item()) / abs(loss_r.item())
        c_grad = max(_leaf_errors(_dense_of(g_c, dev), g_r,
                                  relative_norm=False))
        del g_c
        print(f"  control, the tp psum dropped on rank {SHARD_CTRL_RANK}: "
              f"loss rel err {c_rel:.3e}, worst grad leaf {c_grad:.3e}")
        _require(c_rel > TRAIN_F32_LOSS and c_grad > TRAIN_F32_GRAD,
                 f"the control passes the limits: {c_rel}, {c_grad}")
        out["ctrl_loss_rel_err"], out["ctrl_grad_rel_err"] = c_rel, c_grad
    return out


def _sharded_bf16_run(dev, cfg, shape, params0, inp, tgt, want_changes,
                      loss_oracle) -> tuple[dict, dict]:
    """Phase 57(b) on one mesh: 1 warm-up and SHARD_TIMED timed SGD
    steps (lr LR, donated) between a reset of the counts and a read."""
    from mpistragglers_jl_tpu_torch.models.transformer import shard_params

    mesh = _card_mesh(dev, shape)
    sp = shard_params(params0, cfg, mesh)
    step = make_train_step(cfg, mesh, lr=LR, donate=True)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    sp, loss0 = step(sp, inp, tgt)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    losses = []
    t0 = time.perf_counter()
    for _ in range(SHARD_TIMED):
        sp, loss = step(sp, inp, tgt)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SHARD_TIMED
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    steps = SHARD_TIMED + 1
    k = cfg.n_layers * mesh.size * steps
    want = {"flash_fwd": k, "flash_bwd_dq": k, "flash_bwd_dkv": k,
            "flash_bwd_fused": 0, K5: 0, K6: 0, K7: 0, SAMPLE: 0}
    _require(launches == want, f"{shape}: launched {launches}, want {want}")
    traj = [loss0.item()] + [x.item() for x in losses]
    _require(bool(np.isfinite(traj).all()), f"non-finite loss: {traj}")
    rel = abs(traj[0] - loss_oracle) / abs(loss_oracle)
    equal = _replicas_bit_equal(sp)
    got = [a.float() - b.float() for a, b in
           zip((p.gather(dev) for p in _leaves(sp)), _leaves(params0))]
    upd, n_leaves = _update_error(got, want_changes)
    del got, sp
    rep = {"mesh": list(shape), "ranks": mesh.size, "ms_per_step": dt * 1e3,
           "tokens_per_s": BATCH * SEQ / dt, "peak_mem_gb": peak / 1e9,
           "warmup_step_s": warm_s, "loss_trajectory": traj,
           "loss_vs_oracle_rel_err": rel, "update_rel_err": upd,
           "replicas_bit_equal": equal,
           "launches": {FLASH.get(n, (n,))[0]: v
                        for n, v in launches.items()}}
    print(f"  {shape}: {steps} steps, launches {rep['launches']}; first "
          f"loss rel err {rel:.3e} (limit {TRAIN_BF16_ORACLE:.0e}); worst "
          f"leaf change {upd:.3e} (limit {TRAIN_BF16_UPDATE}) over "
          f"{n_leaves} changed leaves; replicas bit-equal {equal}; "
          f"{rep['ms_per_step']:.2f} ms/step, {rep['tokens_per_s']:.1f} "
          f"tokens/s, peak {rep['peak_mem_gb']:.3f} GB, warm-up "
          f"{warm_s:.2f} s")
    _require(rel <= TRAIN_BF16_ORACLE,
             f"{shape}: first loss {traj[0]} vs the oracle {loss_oracle}: "
             f"{rel}")
    _require(upd <= TRAIN_BF16_UPDATE,
             f"{shape}: the update leaves the dense step's: {upd}")
    _require(equal, f"{shape}: replicas differ after the steps")
    return rep, launches


def phase_sharded(dev, dense_ms: float) -> tuple[dict, dict]:
    """Phase 57. Returns (report, launches per run for the kernels
    line)."""
    from mpistragglers_jl_tpu_torch.models.transformer import (
        shard_params,
        sharded_loss_and_grads,
    )

    out = {"f32": [
        _sharded_f32_leg(dev, "ulysses", SHARD_MESH),
        _sharded_f32_leg(dev, "ring", SHARD_MESH, attn="ring",
                         attn_impl="reference"),
        _sharded_f32_leg(dev, "GQA kv=2 ulysses", (1, 2, 4), n_kv_heads=2),
    ]}
    torch.cuda.empty_cache()
    cfg = _train_cfg(torch.bfloat16)
    params0 = init_params(cfg, seed=0, device=dev)
    inp, tgt = train_batch(cfg.vocab, dev)
    ref = dataclasses.replace(cfg, attn_impl="reference")
    no_attn = {**params0, "layers": [
        {**lp, "wo": torch.zeros_like(lp["wo"])}
        for lp in params0["layers"]]}
    with torch.no_grad():
        loss_oracle = nll_loss(forward_dense(params0, inp, ref), tgt).item()
        loss_zero = nll_loss(forward_dense(no_attn, inp, ref), tgt).item()
    del no_attn
    mesh = _card_mesh(dev, SHARD_MESH)
    with _tp_psum_dropped():
        loss_ctrl, _ = sharded_loss_and_grads(
            shard_params(params0, cfg, mesh), inp, tgt, cfg, mesh)
    ctrl = {"tp_psum_dropped": abs(loss_ctrl.item() - loss_oracle)
            / abs(loss_oracle),
            "attention_zeroed": abs(loss_zero - loss_oracle)
            / abs(loss_oracle)}
    print(f"  bf16 controls, first loss against the reference-attention "
          f"oracle {loss_oracle:.5f}: tp psum dropped on rank "
          f"{SHARD_CTRL_RANK} {ctrl['tp_psum_dropped']:.3e}, attention "
          f"zeroed {ctrl['attention_zeroed']:.3e} (limit "
          f"{TRAIN_BF16_ORACLE:.0e})")
    _require(min(ctrl.values()) > TRAIN_BF16_ORACLE,
             f"a control passes the first-loss limit: {ctrl}")
    torch.cuda.empty_cache()
    want_changes, ref_traj = _reference_changes(cfg, inp, tgt,
                                                SHARD_TIMED + 1)
    out["bf16"] = {"loss_oracle": loss_oracle, "controls": ctrl,
                   "loss_trajectory_reference_attention": ref_traj,
                   "dense_ms_per_step_phase14": dense_ms}
    launches = {}
    for shape in ((1, 1, 1), SHARD_MESH):
        rep, launches[shape] = _sharded_bf16_run(
            dev, cfg, shape, params0, inp, tgt, want_changes, loss_oracle)
        out["bf16"]["x".join(map(str, shape))] = rep
        torch.cuda.empty_cache()
    # the update control: the dp gradient sum dropped over the steps
    mesh = _card_mesh(dev, SHARD_MESH)
    sp = shard_params(params0, cfg, mesh)
    step = make_train_step(cfg, mesh, lr=LR, donate=True)
    with _grad_sum_dropped("dp"):
        for _ in range(SHARD_TIMED + 1):
            sp, _ = step(sp, inp, tgt)
    ctrl_upd = _update_error(
        [a.float() - b.float() for a, b in
         zip((p.gather(dev) for p in _leaves(sp)), _leaves(params0))],
        want_changes)[0]
    del want_changes, sp, step
    sound = out["bf16"]["2x2x2"]["update_rel_err"]
    print(f"  update control on {SHARD_MESH}, the dp gradient sum dropped "
          f"over {SHARD_TIMED + 1} steps: worst leaf change "
          f"{ctrl_upd:.3e} (limit {TRAIN_BF16_UPDATE}; sound {sound:.3e})")
    _require(ctrl_upd > TRAIN_BF16_UPDATE,
             f"a dropped dp gradient sum passes the update limit: "
             f"{ctrl_upd}")
    ctrl["update_dp_grad_sum_dropped"] = ctrl_upd
    torch.cuda.empty_cache()
    print(f"  ms/step: (1, 1, 1) "
          f"{out['bf16']['1x1x1']['ms_per_step']:.2f}, (2, 2, 2) on one card "
          f"{out['bf16']['2x2x2']['ms_per_step']:.2f}; the dense step of "
          f"phase 14 {dense_ms:.2f} (8 ranks share the card: per-rank and "
          "dispatch cost, no collective speed)")
    # (c) one fused-backward step on (2, 2, 2) against the split step
    fused = dataclasses.replace(cfg, flash_bwd="fused")
    sp = shard_params(params0, cfg, mesh)
    zero_launches()
    loss_f, g_f = sharded_loss_and_grads(sp, inp, tgt, fused, mesh)
    torch.cuda.synchronize()
    launches["fused"] = launch_counts()
    k = cfg.n_layers * mesh.size
    want = {"flash_fwd": k, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_bwd_fused": k, K5: 0, K6: 0, K7: 0, SAMPLE: 0}
    _require(launches["fused"] == want,
             f"fused sharded step launched {launches['fused']}")
    g_f = _dense_of(g_f, dev)
    loss_s, g_s = sharded_loss_and_grads(sp, inp, tgt, cfg, mesh)
    errs = _leaf_errors(g_f, _dense_of(g_s, dev), relative_norm=True)
    del g_f, g_s, sp
    print(f"  fused backward on {SHARD_MESH}: K4 "
          f"{launches['fused']['flash_bwd_fused']} launches, K2 0, K3 0; "
          f"loss {loss_f.item():.5f} (split {loss_s.item():.5f}); worst grad "
          f"leaf relative difference {max(errs):.3e} (limit "
          f"{FUSED_BF16_GRAD:.0e})")
    _require(loss_f.item() == loss_s.item(),
             "the same sharded forward gave another loss")
    _require(max(errs) <= FUSED_BF16_GRAD,
             f"fused and split sharded gradients differ: {max(errs)}")
    out["fused"] = {"grad_rel_err": max(errs),
                    "launches": launches["fused"]}
    torch.cuda.empty_cache()
    return out, launches


def phase_slice17(dev, t_start, dense_ms) -> tuple[dict, dict]:
    """Phase 57."""
    t0 = time.perf_counter()
    print(f"  (+{t0 - t_start:.1f} s)")
    print(f"[57] the sharded transformer over {SHARD_MESH} ranks of one card: "
          f"f32 parity at full width ({SHARD_F32_LAYERS} layers; Ulysses, "
          "ring, GQA kv=2 on (1, 2, 4)) with a control; the bf16 main path "
          f"on (1, 1, 1) and {SHARD_MESH} ({SHARD_TIMED} timed steps) with "
          "an update control; one fused-backward step")
    out, launches = phase_sharded(dev, dense_ms)
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def _phase57_launches(launches, kname) -> list:
    """K1-K4's launches on phase 57's runs, for the kernels line."""
    return [{"phase": 57, "mesh": list(shape) if shape != "fused"
             else list(SHARD_MESH), "fused": shape == "fused",
             "steps": 1 if shape == "fused" else SHARD_TIMED + 1,
             "launches": counts[kname]}
            for shape, counts in launches.items()]


# -- phase 58: expert parallelism and the pipeline (slice 18) -------------

EP_AXES = ("dp", "sp", "tp", "ep")
EP_MESH = (2, 1, 2, 2)  # MULTICHIP_r05.json's fifth leg
F32_BATCH = 4           # phase 58(a)'s batch
PIPE_F32_LAYERS = 4     # circular: v=2 chunks over pp=2
EXPERT_LEAVES = ("we1", "be1", "we2", "be2")


def _ep_mesh(dev, shape):
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    return make_mesh(shape, EP_AXES, devices=[dev] * int(np.prod(shape)))


def _flash_want(k1, k23) -> dict:
    return {"flash_fwd": k1, "flash_bwd_dq": k23, "flash_bwd_dkv": k23,
            "flash_bwd_fused": 0}


def _per_shard_oracle(params, inp, tgt, cfg, shards):
    """(loss, grads) of the dense step on each of ``shards`` equal row
    blocks alone, averaged (losses and f32 gradients): the oracle where
    each block routes its own tokens (``shards`` 1: the dense step)."""
    rows = inp.shape[0] // shards
    loss, acc = 0.0, None
    for i in range(shards):
        blk = slice(i * rows, (i + 1) * rows)
        lo, g = loss_and_grads(params, inp[blk], tgt[blk], cfg)
        loss += lo.item() / shards
        g = [x.float() / shards for x in _leaves(g)]
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
        del g
    return loss, _rebuild(params, iter(acc))


def _oracle_changes(cfg, params0, inp, tgt, shards, steps):
    """(each leaf's change, the losses) over ``steps`` SGD steps (lr LR)
    from ``params0`` on the per-shard oracle's averaged gradients, with
    the reference attention."""
    ref = dataclasses.replace(cfg, attn_impl="reference")
    params = _rebuild(params0, iter(p.clone() for p in _leaves(params0)))
    losses = []
    for _ in range(steps):
        loss, g = _per_shard_oracle(params, inp, tgt, ref, shards)
        with torch.no_grad():
            for p, gi in zip(_leaves(params), _leaves(g)):
                p.sub_(LR * gi.to(p.dtype))
        losses.append(loss)
        del g
    return _changes(params, _leaves(params0)), losses


def _swap_experts(sp, mesh):
    """The EP control: every expert leaf's shards rotated one step along
    ``ep``, so each member holds another member's experts."""
    perm = list(range(mesh.size))
    for g in mesh.axis_groups("ep"):
        for a, b in zip(g, g[1:] + g[:1]):
            perm[a] = b
    layers = [{**lp, **{k: from_local(mesh, lp[k].spec,
                                      [lp[k].local(perm[r])
                                       for r in range(mesh.size)],
                                      lp[k].shape)
                        for k in EXPERT_LEAVES}}
              for lp in sp["layers"]]
    return {**sp, "layers": layers}


def _unstack(tree, dev, v=None):
    """A pipeline tree (stacked layers, device-major for the circular
    layout when ``v``) as the dense tree on ``dev``, leaf by leaf."""
    out = {k: tree[k].gather(dev) for k in ("emb", "lnf_s", "lnf_b")}
    stacked = {}
    for k, leaf in tree["layers"].items():
        a = leaf.gather(dev)
        if v is not None:  # (pp, v, lpc, ...) back to (L, ...)
            a = a.transpose(0, 1).reshape(-1, *a.shape[3:])
        stacked[k] = a
    n = next(iter(stacked.values())).shape[0]
    out["layers"] = [{k: a[i] for k, a in stacked.items()} for i in range(n)]
    return out


def _f32_errors(loss, grads, loss_r, g_r) -> tuple[float, float]:
    rel = abs(loss - loss_r) / abs(loss_r)
    return rel, max(_leaf_errors(grads, g_r, relative_norm=False))


def _seed0_params(cfg, dev, cache) -> dict:
    """``init_params(cfg, seed=0)`` drawn once per width, depth, expert
    count and dtype (the host's numpy draws take seconds at full width;
    the capacity factor and aux coefficient draw nothing). No caller
    changes the tensors: every path lays out its own copies."""
    key = (cfg.n_layers, cfg.n_experts, cfg.dtype)
    if key not in cache:
        cache[key] = init_params(cfg, seed=0, device=dev)
    return cache[key]


def _ep_f32_leg(dev, cf, aux, cache) -> dict:
    """Phase 58(a), the MoE over EP_MESH: at ``cf`` 4 against the dense
    step (nothing drops; no aux), at 1.25 against the per-shard oracle,
    with the swapped-experts control."""
    from mpistragglers_jl_tpu_torch.models.transformer import (
        shard_params,
        sharded_loss_and_grads,
    )

    t0 = time.perf_counter()
    cfg = mt.moe_config(torch.float32, n_layers=SHARD_F32_LAYERS,
                        capacity_factor=cf, moe_aux_coef=aux)
    params = _seed0_params(cfg, dev, cache)
    inp, tgt = (t[:F32_BATCH] for t in train_batch(cfg.vocab, dev))
    mesh = _ep_mesh(dev, EP_MESH)
    shards = 1 if cf == 4.0 else EP_MESH[0] * EP_MESH[3]
    loss_r, g_r = _per_shard_oracle(
        params, inp, tgt, dataclasses.replace(cfg, attn_impl="reference"),
        shards)
    sp = shard_params(params, cfg, mesh)
    zero_launches()
    loss, grads = sharded_loss_and_grads(sp, inp, tgt, cfg, mesh)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    rel, grad = _f32_errors(loss.item(), _dense_of(grads, dev), loss_r, g_r)
    equal = _replicas_bit_equal(grads)
    del grads
    loss_c, g_c = sharded_loss_and_grads(_swap_experts(sp, mesh), inp, tgt,
                                         cfg, mesh)
    c_rel, c_grad = _f32_errors(loss_c.item(), _dense_of(g_c, dev), loss_r,
                                g_r)
    del g_c
    k = SHARD_F32_LAYERS * mesh.size
    oracle = "dense" if shards == 1 else f"{shards} shards alone"
    print(f"  EP cf {cf} aux {aux} on {EP_MESH} against the {oracle}: loss "
          f"rel err {rel:.3e} (limit {TRAIN_F32_LOSS:.0e}), worst grad leaf "
          f"{grad:.3e} (limit {TRAIN_F32_GRAD:.0e}), replicas bit-equal "
          f"{equal}; control, experts swapped across ep: {c_rel:.3e}, "
          f"{c_grad:.3e}; launches {launches} "
          f"({time.perf_counter() - t0:.1f} s)")
    _require(rel <= TRAIN_F32_LOSS and grad <= TRAIN_F32_GRAD and equal,
             f"EP f32 cf {cf} disagrees with its oracle: {rel}, {grad}, "
             f"{equal}")
    _require(c_rel > TRAIN_F32_LOSS and c_grad > TRAIN_F32_GRAD,
             f"swapped experts pass the limits: {c_rel}, {c_grad}")
    _require(launches == _flash_want(k, k), f"EP f32 launched {launches}")
    return {"mesh": list(EP_MESH), "capacity_factor": cf, "aux": aux,
            "oracle_shards": shards, "loss_rel_err": rel,
            "grad_rel_err": grad, "ctrl_loss_rel_err": c_rel,
            "ctrl_grad_rel_err": c_grad, "launches": launches}


def _pipe_f32_leg(dev, schedule, shape, M, moe_stages, oracles,
                  cache) -> dict:
    """Phase 58(a), a pipeline schedule's loss and gradients against
    the dense step (dense stages) or the per-microbatch oracle (MoE
    stages, 1F1B, with the dropped aux cotangent as the control);
    ``oracles`` keeps each oracle for the next leg that needs it."""
    from mpistragglers_jl_tpu_torch.parallel import pipeline as pl

    t0 = time.perf_counter()
    n_layers = SHARD_F32_LAYERS if moe_stages else PIPE_F32_LAYERS
    cfg = (mt.moe_config(torch.float32, n_layers=n_layers) if moe_stages
           else dataclasses.replace(_train_cfg(torch.float32),
                                    n_layers=n_layers))
    params = _seed0_params(cfg, dev, cache)
    inp, tgt = (t[:F32_BATCH] for t in train_batch(cfg.vocab, dev))
    shards = shape[0] * M if moe_stages else 1
    key = (moe_stages, shards)
    if key not in oracles:
        oracles[key] = _per_shard_oracle(
            params, inp, tgt,
            dataclasses.replace(cfg, attn_impl="reference"), shards)
    loss_r, g_r = oracles[key]
    mesh = pt.pipeline_mesh(dev, shape)
    v = pt.V if schedule == "circular" else None
    pp_params = pl.shard_params_pipeline(params, cfg, mesh,
                                         virtual_stages=v)
    grad_fn = pl._pipeline_grad_fn(cfg, mesh, M, schedule, pt.V)
    zero_launches()
    loss, grads = grad_fn(pp_params, inp, tgt)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    rel, grad = _f32_errors(loss.item(), _unstack(grads, dev, v), loss_r,
                            g_r)
    equal = _replicas_bit_equal(grads)
    del grads
    k = n_layers * M * shape[0]
    out = {"schedule": schedule, "mesh": list(shape), "n_microbatch": M,
           "oracle_shards": shards, "loss_rel_err": rel,
           "grad_rel_err": grad, "launches": launches}
    ctrl = ""
    if moe_stages:
        right = pl._vjp

        def dropped(outputs, inputs, grad_outputs):
            if grad_outputs is not None:  # dL/d aux zeroed
                grad_outputs = (grad_outputs[0],
                                torch.zeros_like(grad_outputs[1]))
            return right(outputs, inputs, grad_outputs)

        pl._vjp = dropped
        try:
            loss_c, g_c = grad_fn(pp_params, inp, tgt)
        finally:
            pl._vjp = right
        out["ctrl_loss_rel_err"], out["ctrl_grad_rel_err"] = _f32_errors(
            loss_c.item(), _unstack(g_c, dev), loss_r, g_r)
        del g_c
        ctrl = (f"; control, the aux cotangent dropped: loss "
                f"{out['ctrl_loss_rel_err']:.3e}, grad "
                f"{out['ctrl_grad_rel_err']:.3e}")
        _require(out["ctrl_grad_rel_err"] > TRAIN_F32_GRAD,
                 f"a dropped aux cotangent passes: {out}")
    print(f"  {schedule} {'MoE' if moe_stages else 'dense'} on {shape}, "
          f"{M} microbatches: loss rel err {rel:.3e}, worst grad leaf "
          f"{grad:.3e}, replicas bit-equal {equal}{ctrl}; launches "
          f"{launches} ({time.perf_counter() - t0:.1f} s)")
    _require(rel <= TRAIN_F32_LOSS and grad <= TRAIN_F32_GRAD and equal,
             f"{schedule} f32 disagrees with its oracle: {out}")
    want = _flash_want(2 * k if schedule == "1f1b" else k, k)
    _require(launches == want, f"{schedule} f32 launched {launches}")
    return out


def _bf16_checks(label, rep, changes, oracle_changes, oracle_loss,
                 equal, want, names) -> None:
    """Phase 58(b)'s checks on one run's report (updated in place);
    ``names`` the leaves' paths."""
    launches = rep.pop("launches")
    traj = rep["loss_trajectory"]
    rel = abs(traj[0] - oracle_loss) / abs(oracle_loss)
    upd, leaf, n = _worst_leaf(changes, oracle_changes, names)
    rep.update({"loss_vs_oracle_rel_err": rel, "update_rel_err": upd,
                "update_worst_leaf": leaf, "replicas_bit_equal": equal,
                "launches": {FLASH.get(k, (k,))[0]: c
                             for k, c in launches.items()}})
    print(f"  {label}: {rep['steps']} steps, launches {rep['launches']}; "
          f"first loss rel err {rel:.3e} (limit {TRAIN_BF16_ORACLE:.0e}); "
          f"worst leaf change {upd:.3e} ({leaf}; limit "
          f"{TRAIN_BF16_UPDATE}) over {n} changed leaves; replicas "
          f"bit-equal {equal}; {rep['ms_per_step']:.2f} ms/step, {rep['tokens_per_s']:.1f} "
          f"tokens/s, peak {rep['peak_mem_gb']:.3f} GB, warm-up "
          f"{rep['warmup_step_s']:.2f} s")
    _require(launches == want, f"{label}: launched {launches}, want {want}")
    _require(bool(np.isfinite(traj).all()), f"{label}: loss {traj}")
    _require(rel <= TRAIN_BF16_ORACLE,
             f"{label}: first loss {traj[0]} vs the oracle {oracle_loss}")
    _require(upd <= TRAIN_BF16_UPDATE, f"{label}: update off by {upd}")
    _require(equal, f"{label}: replicas differ after the steps")


def _want_all(k1, k23) -> dict:
    return {**_flash_want(k1, k23), K5: 0, K6: 0, K7: 0, SAMPLE: 0}


def _ep_bf16(dev, cache) -> tuple[dict, dict]:
    """Phase 58(b), the MoE step over the mesh: (1, 1, 1, 1) and
    EP_MESH, then the update control on EP_MESH."""
    from mpistragglers_jl_tpu_torch.models.transformer import shard_params

    cfg = mt.moe_config()
    params0 = _seed0_params(cfg, dev, cache)
    names = _leaf_names(params0)
    inp, tgt = train_batch(cfg.vocab, dev)
    out, launches = {}, {}
    for shape in ((1, 1, 1, 1), EP_MESH):
        shards = shape[0] * shape[3]
        want_changes, oracle = _oracle_changes(cfg, params0, inp, tgt,
                                               shards, pt.TIMED + 1)
        mesh = _ep_mesh(dev, shape)
        step = make_train_step(cfg, mesh, lr=LR, donate=True)
        sp, rep = pt.train_run(step, shard_params(params0, cfg, mesh), inp,
                               tgt, dev)
        launches[shape] = rep["launches"]
        k = cfg.n_layers * mesh.size * rep["steps"]
        got = _changes(_dense_of(sp, dev), _leaves(params0))
        _bf16_checks(f"EP {shape}", rep, got, want_changes, oracle[0],
                     _replicas_bit_equal(sp), _want_all(k, k), names)
        del sp
        if mesh.size == 1:
            rep["one_device"] = _one_device_update(
                cfg, params0, inp, tgt, got, want_changes, names)
        del got
        rep.update({"mesh": list(shape), "ranks": mesh.size,
                    "oracle_shards": shards, "oracle_trajectory": oracle})
        out["x".join(map(str, shape))] = rep
        torch.cuda.empty_cache()
    mesh = _ep_mesh(dev, EP_MESH)
    sp = shard_params(params0, cfg, mesh)
    step = make_train_step(cfg, mesh, lr=LR, donate=True)
    with _grad_sum_dropped("dp"):
        for _ in range(pt.TIMED + 1):
            sp, _ = step(sp, inp, tgt)
    ctrl = _update_error(_changes(_dense_of(sp, dev), _leaves(params0)),
                         want_changes)[0]
    del sp, want_changes
    sound = out["x".join(map(str, EP_MESH))]["update_rel_err"]
    print(f"  update control on {EP_MESH}, the dp gradient sum dropped: "
          f"worst leaf change {ctrl:.3e} (limit {TRAIN_BF16_UPDATE}; "
          f"sound {sound:.3e})")
    _require(ctrl > TRAIN_BF16_UPDATE,
             f"a dropped dp gradient sum passes the update limit: {ctrl}")
    out["update_ctrl_dp_grad_sum_dropped"] = ctrl
    torch.cuda.empty_cache()
    return out, launches


def _one_device_update(cfg, params0, inp, tgt, mesh_changes,
                       want_changes, names) -> dict:
    """Phase 58(b): the one-device MoE step (phase 28's) over the same
    steps, its leaf changes held to the same oracle's and to the
    (1, 1, 1, 1) mesh's, each with its worst leaf: the mesh's own share
    of the gap to the oracle. Printed and recorded, not held."""
    params = _rebuild(params0, iter(p.clone() for p in _leaves(params0)))
    step = make_train_step(cfg, lr=LR, donate=True)
    for _ in range(pt.TIMED + 1):
        params, _ = step(params, inp, tgt)
    one = _changes(params, _leaves(params0))
    del params
    rep = {}
    for key, got, want in (("vs_oracle", one, want_changes),
                           ("mesh_vs_one_device", mesh_changes, one)):
        upd, leaf, n = _worst_leaf(got, want, names)
        rep[key] = {"update_rel_err": upd, "worst_leaf": leaf,
                    "leaves": n}
    del one
    print(f"    the one-device step over the same {pt.TIMED + 1} steps: "
          f"worst leaf change against the oracle "
          f"{rep['vs_oracle']['update_rel_err']:.3e} "
          f"({rep['vs_oracle']['worst_leaf']}); the (1, 1, 1, 1) mesh's "
          f"against it {rep['mesh_vs_one_device']['update_rel_err']:.3e} "
          f"({rep['mesh_vs_one_device']['worst_leaf']}) over "
          f"{rep['mesh_vs_one_device']['leaves']} leaves")
    return rep


def _pipe_bf16(dev, cache) -> tuple[dict, dict]:
    """Phase 58(b), the pipeline cells of ``bench/pipeline_train.py``."""
    out, launches = {}, {}
    dense_oracle = None
    for schedule, (shape, M, moe_stages) in pt.CELLS.items():
        cfg = pt.cell_config(schedule)
        params0 = _seed0_params(cfg, dev, cache)
        inp, tgt = train_batch(cfg.vocab, dev)
        shards = shape[0] * M if moe_stages else 1
        if moe_stages or dense_oracle is None:
            oracle = _oracle_changes(cfg, params0, inp, tgt, shards,
                                     pt.TIMED + 1)
            if not moe_stages:
                dense_oracle = oracle
        else:
            oracle = dense_oracle
        params, rep = pt.bench_cell(dev, schedule, params0)
        launches[schedule] = rep["launches"]
        k = cfg.n_layers * M * shape[0] * rep["steps"]
        v = pt.V if schedule == "circular" else None
        got = _changes(_unstack(params, dev, v), _leaves(params0))
        _bf16_checks(f"{schedule} on {shape}, {M} microbatches", rep, got,
                     oracle[0], oracle[1][0], _replicas_bit_equal(params),
                     _want_all(2 * k if schedule == "1f1b" else k, k),
                     _leaf_names(params0))
        del got, params
        gap = rep["bubble_measured"] - rep["bubble_formula"]
        print(f"    measure_bubble on the card: {rep['bubble_measured']:.6f} "
              f"against bubble_fraction {rep['bubble_formula']:.6f} over "
              f"{rep['ticks']} ticks")
        if schedule == "circular":
            _require(abs(rep["bubble_measured"] - shape[1] / rep["ticks"])
                     < 1e-12 and gap > 0, f"circular bubble {rep}")
        else:
            _require(abs(gap) < 1e-12, f"{schedule} bubble {rep}")
        rep.update({"oracle_shards": shards, "oracle_trajectory": oracle[1]})
        out[schedule] = rep
        torch.cuda.empty_cache()
    del dense_oracle
    return out, launches


def phase_slice18(dev, t_start, dense_ms, moe_ms) -> tuple[dict, dict]:
    """Phase 58. Returns (report, launches per run for the kernels
    line)."""
    t0 = time.perf_counter()
    print(f"  (+{t0 - t_start:.1f} s)")
    print(f"[58] expert parallelism and the pipeline, every rank on one "
          f"card: f32 parity at full width (EP on {EP_MESH}, GPipe and "
          "circular on (1, 2), 1F1B MoE on (2, 2)) with controls; bf16 "
          f"main paths (EP on (1, 1, 1, 1) and {EP_MESH}, 1F1B MoE on (4, "
          f"2), GPipe and circular on (1, 4); {pt.TIMED} timed steps)")
    oracles, cache = {}, {}
    out = {"f32": [
        _ep_f32_leg(dev, 4.0, 0.0, cache),
        _ep_f32_leg(dev, 1.25, 0.01, cache),
        _pipe_f32_leg(dev, "gpipe", (1, 2), 2, False, oracles, cache),
        _pipe_f32_leg(dev, "circular", (1, 2), 2, False, oracles, cache),
        _pipe_f32_leg(dev, "1f1b", (2, 2), 2, True, oracles, cache)]}
    oracles.clear()
    cache.clear()
    torch.cuda.empty_cache()
    print(f"  f32 legs done (+{time.perf_counter() - t0:.1f} s)")
    out["ep"], launches = _ep_bf16(dev, cache)
    print(f"  EP runs done (+{time.perf_counter() - t0:.1f} s)")
    out["pipeline"], more = _pipe_bf16(dev, cache)
    cache.clear()
    launches.update(more)
    runs = {**{f"EP {k}": r for k, r in out["ep"].items()
               if isinstance(r, dict)}, **out["pipeline"]}
    print("  ms/step on one card: " + "; ".join(
        f"{k} {r['ms_per_step']:.2f}" for k, r in runs.items())
        + f"; the one-device MoE step of phase 28 {moe_ms:.2f}, the dense "
        f"step of phase 14 {dense_ms:.2f} (ranks share the card: per-rank "
        "and dispatch cost, no collective speed or pipeline overlap)")
    out.update({"one_device_moe_ms_per_step_phase28": moe_ms,
                "dense_ms_per_step_phase14": dense_ms,
                "seconds": time.perf_counter() - t0})
    return out, launches


def _phase58_launches(launches, kname) -> list:
    """K1-K3's launches on phase 58's bf16 runs, for the kernels line."""
    rows = []
    for run, counts in launches.items():
        if isinstance(run, tuple):
            rows.append({"phase": 58, "mesh": list(run), "axes": EP_AXES,
                         "schedule": "expert-parallel",
                         "steps": pt.TIMED + 1,
                         "launches": counts[kname]})
        else:
            shape, M, _ = pt.CELLS[run]
            rows.append({"phase": 58, "mesh": list(shape),
                         "axes": ("dp", "pp"), "schedule": run,
                         "n_microbatch": M, "steps": pt.TIMED + 1,
                         "launches": counts[kname]})
    return rows


# -- phase 59: sharded inference (slice 19) -------------------------------

INF_MESH = (2, 4)       # MULTICHIP_r05.json's sixth leg: ("dp", "tp")
INF_F32_LAYERS = 2
# (a)'s batch, prompt and n_new: 504 + 8 = 512 cache positions, a length
# K5's block picker takes (a routed int8 step then launches K5)
INF_B, INF_TP, INF_NEW = 8, 504, 8
INF_STEPS = 4           # (a)'s teacher-forced decode steps
INF_CHUNK = 126         # (a)'s extend chunks: 4 of them
INF_SPEC_NEW = 32       # (a)'s speculative n_new
INF_INNER = 8           # (a)'s serving tick
# f32 logits of the per-rank program against the dense program's: both
# sum in f32, the tp partial sums in another order than the dense
# einsum's; the control (a dropped tp psum) must break it
INF_F32_LOGITS = 1e-5
# (b): the 16k decode slope, make_generate on (1, 1) and generate_dense
# (phase 19's program) each timed at both n_new, back to back at one
# cache length: ms/token = (t(64) - t(32)) / 32 (over 64 steps, (32, 96),
# before phase 60 took item 18h's runs: a depth cut, no check)
INF_SLOPE_NEW = (32, 64)
INF_LONG_LEN = 18432    # (b): cache positions, 16384 + 128 rounded up
# (b): (B, prompt, n_new) on (2, 4); n_new 32 -> 16, MoE's 16 -> 8 and the
# timed tick's 64 inner steps -> 32 once phase 60 was added (the ROADMAP's
# depth cuts for a whole run past 600 s); phase 60 generates the same
# (2, 4) stream
INF_GEN_BF16 = (8, 2048, 16)
INF_SPEC_BF16_NEW = 64  # (b): bench_spec_decode's 256 cut to 64
INF_MOE_BF16 = (8, 512, 8)     # (b): (B, prompt, n_new) on (2, 2, 2)
INF_TICK_INNER = 32     # (b): the timed tick's inner steps
INF_WARM_INNER = 4      # (b): the serving tick's warm-up inner steps


def _inf_mesh(dev, shape, axes=("dp", "tp")):
    from mpistragglers_jl_tpu_torch.parallel import make_mesh

    return make_mesh(shape, axes, devices=[dev] * int(np.prod(shape)))


def _counted(fn):
    """``fn()`` with every launch count set to 0 just before and read
    just after: (its result, seconds, launches)."""
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, launch_counts()


def _want_counts(launches, what, k1=0, k5=0, sample=0) -> dict:
    """Hold a run's launches to exact K1, K5 and sampler counts, every
    other kernel 0; returns the three."""
    want = {"flash_fwd": k1, K5: k5, SAMPLE: sample}
    got = {n: launches[n] for n in want}
    others = {n: v for n, v in launches.items() if n not in want and v}
    print(f"  {what}: K1 {got['flash_fwd']} (want {k1}), K5 {got[K5]} "
          f"(want {k5}), sampler {got[SAMPLE]} (want {sample}), others "
          f"{others or 0}")
    _require(got == want and not others,
             f"{what} launched {launches}, want {want} and no other")
    return {"K1": k1, "K5": k5, "sampler": sample}


@contextlib.contextmanager
def _inf_psum_dropped():
    """Phase 59's control: on rank ``SHARD_CTRL_RANK`` the decode
    program's tp psum returns the rank's own partial sum."""
    right = td.psum

    def dropped(xs, mesh, axes, **kw):
        out = right(xs, mesh, axes, **kw)
        if axes == "tp":
            out[SHARD_CTRL_RANK] = xs[SHARD_CTRL_RANK].clone()
        return out

    td.psum = dropped
    try:
        yield
    finally:
        td.psum = right


def _same_tokens(got, want, what) -> int:
    got = got.gather(want.device) if hasattr(got, "gather") else got
    same = int((got.long() == want.long()).all(dim=1).sum())
    print(f"  {what}: {same}/{want.shape[0]} streams equal")
    _require(same == want.shape[0], f"{what}: the streams differ")
    return same


def _inf_f32_logits(dev, cfg, params, sp, mesh, prompt) -> dict:
    """(a) prefill and INF_STEPS teacher-forced decode steps on mesh
    against the dense programs; the control."""
    B, n, L = INF_B, mesh.size, cfg.n_layers
    tp = torch.as_tensor(prompt, device=dev)
    c = td.init_cache(cfg, B, INF_TP + INF_NEW, mesh, device=dev)
    prefill = td.make_prefill(cfg, mesh)
    (lg, c), _, k = _counted(lambda: prefill(sp, prompt[:, :INF_TP], c))
    counts = {"prefill": _want_counts(k, f"prefill on {INF_MESH}",
                                      k1=L * n)}
    dc = td.init_cache(cfg, B, INF_TP + INF_NEW, device=dev)
    with torch.no_grad():
        dlg, dc = td.prefill_dense(params, tp[:, :INF_TP], dc, cfg)
    errs = [(lg.gather(dev) - dlg[:, -1]).abs().max().item()]
    del dlg
    step = td.make_decode_step(cfg, mesh)
    for t in range(INF_TP, INF_TP + INF_STEPS):
        (lg, c), _, k = _counted(lambda: step(sp, prompt[:, t], c, t))
        _require(k["flash_fwd"] == 0 and k[K5] == 0,
                 f"an f32-cache decode step launched {k}")
        with torch.no_grad():
            dlg, dc = td.decode_step_dense(params, tp[:, t], dc, t, cfg)
        errs.append((lg.gather(dev) - dlg).abs().max().item())
    err = max(errs)
    with _inf_psum_dropped():
        lg_c, _ = prefill(sp, prompt[:, :INF_TP],
                          td.init_cache(cfg, B, INF_TP, mesh, device=dev))
    with torch.no_grad():
        dlg, _ = td.prefill_dense(params, tp[:, :INF_TP],
                                  td.init_cache(cfg, B, INF_TP, device=dev),
                                  cfg)
    ctrl = (lg_c.gather(dev) - dlg[:, -1]).abs().max().item()
    del dlg, dc, c
    print(f"  prefill + {INF_STEPS} decode steps on {INF_MESH} against the "
          f"dense programs: worst logit {err:.3e} (limit "
          f"{INF_F32_LOGITS:.0e}); control, the tp psum dropped on rank "
          f"{SHARD_CTRL_RANK}: {ctrl:.3e}")
    _require(err <= INF_F32_LOGITS, f"sharded logits differ by {err}")
    _require(ctrl > INF_F32_LOGITS, f"the control passes the limit: {ctrl}")
    return {"logit_abs_err": err, "ctrl_tp_psum_dropped": ctrl,
            "launches": counts}


def _inf_f32(dev) -> tuple[dict, dict]:
    """Phase 59(a). Returns (report, launches per run)."""
    from mpistragglers_jl_tpu_torch.models import serving as sv
    from mpistragglers_jl_tpu_torch.models import speculative as tsp
    from mpistragglers_jl_tpu_torch.models.transformer import shard_params

    cfg = TransformerConfig(**{**DECODE, "n_layers": INF_F32_LAYERS},
                            dtype=torch.float32)
    L = cfg.n_layers
    params = init_params(cfg, seed=0, device=dev)
    mesh = _inf_mesh(dev, INF_MESH)
    n = mesh.size
    sp = shard_params(params, cfg, mesh)
    prompt = _prompt(cfg.vocab, INF_B, INF_TP + INF_NEW, seed=59)
    pr = prompt[:, :INF_TP]
    out = _inf_f32_logits(dev, cfg, params, sp, mesh, prompt)
    counts = dict(out.pop("launches"))
    steps = INF_NEW - 1
    key = prng.key(59)
    for name, kw, k5, smp in (
            ("greedy", {}, 0, 0),
            ("int8", {"quantize_kv": True}, L * n * steps, 0),
            ("sampled", {"temperature": SAMPLE_T, "top_k": SAMPLE_TOP_K},
             0, n * INF_NEW)):
        sampled = "temperature" in kw
        gen = td.make_generate(cfg, mesh, INF_NEW, **kw)
        toks, dt, k = _counted(lambda: gen(sp, pr, key if sampled else None))
        counts[f"generate_{name}"] = _want_counts(
            k, f"make_generate {name} on {INF_MESH}, {dt:.2f} s", k1=L * n,
            k5=k5, sample=smp)
        want = td.generate_dense(params, pr, INF_NEW, cfg, device=dev,
                                 **({"key": key} if sampled else {}), **kw)
        _same_tokens(toks, want, f"make_generate {name} vs generate_dense")
    # the int8 ring on (2, 2): the aligned prefill attends the cache
    cfg_w = dataclasses.replace(cfg, attn_window=MODEL["attn_window"])
    mesh22 = _inf_mesh(dev, (2, 2))
    sp22 = shard_params(params, cfg_w, mesh22)
    gen = td.make_ring_generate(cfg_w, mesh22, INF_NEW, quantize_kv=True)
    toks, dt, k = _counted(lambda: gen(sp22, pr))
    counts["ring_int8"] = _want_counts(
        k, f"make_ring_generate int8 on (2, 2), {dt:.2f} s",
        k5=L * 4 * steps)
    _same_tokens(toks, td.generate_ring_dense(params, pr, INF_NEW, cfg_w,
                                              quantize_kv=True, device=dev),
                 "make_ring_generate int8 vs generate_ring_dense")
    # make_extend in chunks against the one-shot prefill
    ext = td.make_extend(cfg, mesh)
    c = td.init_cache(cfg, INF_B, INF_TP, mesh, device=dev)

    def chunks():
        nonlocal c
        for i in range(0, INF_TP, INF_CHUNK):
            lg, c = ext(sp, pr[:, i:i + INF_CHUNK], c, i)
        return lg

    lg_ext, _, k = _counted(chunks)
    counts["extend"] = _want_counts(k, f"make_extend, {INF_TP // INF_CHUNK} "
                                    "chunks")
    lg_one, _ = td.make_prefill(cfg, mesh)(
        sp, pr, td.init_cache(cfg, INF_B, INF_TP, mesh, device=dev))
    ext_err = (lg_ext.gather(dev)[:, -1] - lg_one.gather(dev)).abs().max()
    print(f"  make_extend's last logits against make_prefill's: "
          f"{ext_err.item():.3e} (limit {INF_F32_LOGITS:.0e})")
    _require(ext_err.item() <= INF_F32_LOGITS, "extend and prefill differ")
    out["extend_vs_prefill_abs_err"] = ext_err.item()
    del lg_ext, lg_one, c
    # speculative decoding on (1, 4), both drafters
    mesh14 = _inf_mesh(dev, (1, 4))
    sp14 = shard_params(params, cfg, mesh14)
    d = min(SPEC_DRAFT_LAYERS, L - 1)
    for layers in (None, d):
        run = tsp.make_speculative(cfg, mesh14, INF_TP, INF_SPEC_NEW,
                                   k=SPEC_K, draft_layers=layers)
        (toks, fwd), dt, k = _counted(lambda: run(sp14, pr[:1]))
        name = "n-gram" if layers is None else f"draft_layers={layers}"
        counts[f"speculative_{name}"] = _want_counts(
            k, f"make_speculative {name} on (1, 4), {dt:.2f} s",
            k1=4 * (L + (layers or 0)))
        want, want_fwd = generate_speculative_dense(
            params, pr[:1], INF_SPEC_NEW, cfg, k=SPEC_K, draft_layers=layers,
            device=dev)
        equal = all(torch.equal(toks.local(r), toks.local(0))
                    for r in range(4))
        print(f"  make_speculative {name}: {fwd} verify forwards (dense "
              f"{want_fwd}); ranks' buffers bit-equal {equal}")
        _same_tokens(toks, want, f"make_speculative {name}")
        _require(fwd == want_fwd and equal,
                 f"speculative {name}: forwards {fwd} vs {want_fwd}, "
                 f"buffers equal {equal}")
        out[f"speculative_{name}_forwards"] = fwd
    # the int8 serving tick on (2, 2) against the dense per-row step
    rng = np.random.default_rng(59)
    W, S = cfg_w.attn_window, SLOTS
    tok = rng.integers(1, cfg.vocab, S).astype(np.int32)
    pos = rng.integers(W // 2, 3 * W, S).astype(np.int32)  # some wrapped
    caches = []
    for _ in range(L):
        layer = {}
        for kk in ("k", "v"):
            x = torch.randn((S, W, cfg.kv_heads, cfg.head_dim),
                            generator=torch.Generator().manual_seed(
                                len(caches) * 2 + len(layer)))
            layer[kk], layer[kk + "_s"] = (
                t.to(dev) for t in td._kv_quantize(x))
        caches.append(layer)
    tick = sv.make_serving_scan(cfg_w, mesh22, INF_INNER, quantize_kv=True)
    res, dt, k = _counted(lambda: tick(sp22, tok, pos, np.zeros(S, bool),
                                       [dict(c) for c in caches]))
    counts["serving_tick_int8"] = _want_counts(
        k, f"make_serving_scan int8 on (2, 2), S={S}, {INF_INNER} inner "
        f"steps, {dt:.2f} s", k5=L * 4 * INF_INNER)
    dtok = torch.as_tensor(tok, device=dev)
    dpos = torch.as_tensor(pos, device=dev)
    dc = [{kk: a.clone() for kk, a in c.items()} for c in caches]
    want = []
    for _ in range(INF_INNER):
        lg, dc = sv.serving_decode_step_dense(params, dtok, dpos, dc, cfg_w)
        dtok, dpos = torch.argmax(lg, dim=-1).to(torch.int32), dpos + 1
        want.append(dtok)
    _same_tokens(res[4], torch.stack(want, dim=1),
                 "the sharded tick vs the dense per-row step (slots)")
    del caches, dc, res, sp, sp22, sp14, params
    torch.cuda.empty_cache()
    # MoE over ("dp", "ep", "tp") at moe_bench's width: 4 experts at
    # capacity factor 4 (= the expert count: no token dropped in either
    # program, the reference test's condition, as phase 29)
    cfg_m = mt.moe_config(dtype=torch.float32, n_layers=L,
                          capacity_factor=4.0, moe_aux_coef=0.0)
    params_m = init_params(cfg_m, seed=0, device=dev)
    mesh_m = _inf_mesh(dev, (2, 2, 2), ("dp", "ep", "tp"))
    prm = pr[:4]
    gen = td.make_generate(cfg_m, mesh_m, INF_NEW)
    toks, dt, k = _counted(lambda: gen(shard_params(params_m, cfg_m, mesh_m),
                                       prm))
    counts["moe_generate"] = _want_counts(
        k, f"MoE make_generate on (2, 2, 2), B=4, {dt:.2f} s", k1=L * 8)
    _same_tokens(toks, td.generate_dense(params_m, prm, INF_NEW, cfg_m,
                                         device=dev),
                 "MoE make_generate vs generate_dense")
    del params_m
    torch.cuda.empty_cache()
    return out, counts


def _inf_bf16(dev, serve_ms_per_step, phase19_ms) -> tuple[dict, dict]:
    """Phase 59(b); ``phase19_ms`` is phase 19's int8 + K5 decode slope,
    printed beside this phase's. Returns (report, launches per run)."""
    from mpistragglers_jl_tpu_torch.models import serving as sv
    from mpistragglers_jl_tpu_torch.models import speculative as tsp
    from mpistragglers_jl_tpu_torch.models.transformer import shard_params

    cfg = TransformerConfig(**DECODE, dtype=torch.bfloat16)
    L = cfg.n_layers
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out, counts = {}, {}
    # bench_decode's path on (1, 1): prefill, then the K5-forced slope
    mesh11 = _inf_mesh(dev, (1, 1))
    sp = shard_params(params, cfg, mesh11)
    prompt = _prompt(cfg.vocab, 1, LONG_PROMPT)
    prefill = td.make_prefill(cfg, mesh11, quantize_kv=True)
    c = td.init_cache(cfg, 1, INF_LONG_LEN, mesh11, quantize_kv=True,
                      device=dev)
    for _ in range(2):  # the first one warms up
        (lg, c), prefill_s, k = _counted(lambda: prefill(sp, prompt, c))
    counts["prefill_16k_1x1"] = _want_counts(
        k, f"prefill on (1, 1), prompt {LONG_PROMPT}, {prefill_s:.3f} s",
        k1=L)
    _require(bool(torch.isfinite(lg.local(0)).all()), "non-finite logits")
    del c, lg
    # K5 forced on both programs; each one's n_new 4 run warms it up
    n0, n1 = INF_SLOPE_NEW
    td.use_decode_kernel(True)
    try:
        gens = {nn: td.make_generate(cfg, mesh11, nn, max_len=INF_LONG_LEN,
                                     quantize_kv=True)
                for nn in (4, n0, n1)}
        runs = {("mesh", nn): lambda nn=nn: gens[nn](sp, prompt)
                for nn in (4, n0, n1)}
        runs.update({("dense", nn): lambda nn=nn: td.generate_dense(
            params, prompt, nn, cfg, max_len=INF_LONG_LEN, quantize_kv=True,
            device=dev) for nn in (4, n0, n1)})
        totals, toks = {}, {}
        for key in (("mesh", 4), ("dense", 4), ("mesh", n0), ("dense", n0),
                    ("mesh", n1), ("dense", n1)):
            name, nn = key
            toks[key], totals[key], k = _counted(runs[key])
            counts[f"generate_16k_1x1_{name}_n{nn}"] = _want_counts(
                k, f"{'make_generate' if name == 'mesh' else 'generate_dense'}"
                f" int8 K5 forced on (1, 1), n_new {nn}, {totals[key]:.3f} s",
                k1=L, k5=L * (nn - 1))
    finally:
        td.use_decode_kernel(None)
    slope = {name: (totals[name, n1] - totals[name, n0]) / (n1 - n0) * 1e3
             for name in ("mesh", "dense")}
    _same_tokens(toks["mesh", n1], toks["dense", n1], f"(1, 1) 16k stream "
                 f"vs generate_dense at {INF_LONG_LEN} cache positions")
    out["long_1x1"] = {"prompt": LONG_PROMPT, "prefill_s": prefill_s,
                       "decode_ms_per_token": slope["mesh"],
                       "dense_ms_per_token": slope["dense"],
                       "phase19_ms_per_token": phase19_ms,
                       "slope_steps": n1 - n0, "slope_from_n_new": n0,
                       "cache_len": INF_LONG_LEN}
    print(f"  (1, 1): prefill {prefill_s:.3f} s; decode ms/token by slope "
          f"over n_new {n0} -> {n1} at {INF_LONG_LEN} cache positions, K5 "
          f"forced: make_generate {slope['mesh']:.3f}, generate_dense "
          f"{slope['dense']:.3f} (the same run); phase 19's generate_dense "
          f"{phase19_ms and round(phase19_ms, 3)} (n_new {LONG_NEW} -> "
          f"{LONG_NEW + SLOPE_STEPS}, caches of {LONG_PROMPT + LONG_NEW} and "
          f"{LONG_PROMPT + LONG_NEW + SLOPE_STEPS} positions)")
    del sp, toks
    torch.cuda.empty_cache()
    # make_generate int8 on (2, 4)
    B, Tp, nn = INF_GEN_BF16
    mesh = _inf_mesh(dev, INF_MESH)
    sp = shard_params(params, cfg, mesh)
    pr = _prompt(cfg.vocab, B, Tp, seed=1)
    gen = td.make_generate(cfg, mesh, nn, quantize_kv=True)
    toks, dt, k = _counted(lambda: gen(sp, pr))
    counts["generate_int8_2x4"] = _want_counts(
        k, f"make_generate int8 on {INF_MESH}, B={B}, prompt {Tp}, n_new "
        f"{nn}, {dt:.2f} s", k1=L * 8, k5=L * 8 * (nn - 1))
    _require(bool(((toks.gather() >= 0) & (toks.gather() < cfg.vocab)).all()),
             "out-of-vocabulary tokens")
    out["generate_int8_2x4"] = {"B": B, "prompt": Tp, "n_new": nn,
                                "total_s": dt, "ms_per_token": dt / nn * 1e3,
                                "stream": toks.gather().tolist()}
    del sp
    # the int8 serving tick on (2, 2): one warm-up, one timed
    cfg_w = dataclasses.replace(cfg, attn_window=MODEL["attn_window"])
    mesh22 = _inf_mesh(dev, (2, 2))
    sp22 = shard_params(params, cfg_w, mesh22)
    W, S = cfg_w.attn_window, SLOTS
    rng = np.random.default_rng(60)
    tok = rng.integers(1, cfg.vocab, S).astype(np.int32)
    pos = rng.integers(W, 3 * W, S).astype(np.int32)
    caches = td.shard_cache(td.init_cache(cfg_w, S, W, mesh22,
                                          quantize_kv=True, device=dev),
                            cfg_w, mesh22)
    state = (tok, pos, np.zeros(S, bool))
    ms = []
    for n_inner in (INF_WARM_INNER, INF_TICK_INNER):  # a warm-up first
        tick = sv.make_serving_scan(cfg_w, mesh22, n_inner, quantize_kv=True)
        res, dt, k = _counted(lambda: tick(sp22, *state, caches))
        state = res[:3]
        ms.append(dt * 1e3)
    one_device = (None if serve_ms_per_step is None
                  else serve_ms_per_step * INF_TICK_INNER)
    counts["serving_tick_int8_2x2"] = _want_counts(
        k, f"make_serving_scan int8 on (2, 2), S={S}, {INF_TICK_INNER} inner "
        f"steps: {ms[1]:.1f} ms/tick ({INF_WARM_INNER}-step warm-up "
        f"{ms[0]:.1f}; phase 5's "
        f"one-device scheduler {one_device and round(one_device, 1)} for "
        "as many steps)", k5=L * 4 * INF_TICK_INNER)
    out["serving_tick_2x2"] = {"ms_per_tick": ms[1], "warmup_ms": ms[0],
                               "phase5_ms_per_tick": one_device}
    del caches, sp22
    # make_speculative on (1, 4) at bench_spec_decode's prompt
    mesh14 = _inf_mesh(dev, (1, 4))
    sp14 = shard_params(params, cfg, mesh14)
    pr = _prompt(cfg.vocab, 1, SPEC_BF16[0], seed=2)
    run = tsp.make_speculative(cfg, mesh14, SPEC_BF16[0], INF_SPEC_BF16_NEW,
                               k=SPEC_K)
    (toks, fwd), dt, k = _counted(lambda: run(sp14, pr))
    counts["speculative_1x4"] = _want_counts(
        k, f"make_speculative on (1, 4), prompt {SPEC_BF16[0]}, n_new "
        f"{INF_SPEC_BF16_NEW}, {dt:.2f} s, {fwd} verify forwards", k1=L * 4)
    _require(all(torch.equal(toks.local(r), toks.local(0))
                 for r in range(4)), "the ranks' token buffers differ")
    _same_tokens(toks, td.generate_dense(params, pr, INF_SPEC_BF16_NEW, cfg,
                                         device=dev),
                 "make_speculative on (1, 4) vs generate_dense")
    out["speculative_1x4"] = {"prompt": SPEC_BF16[0],
                              "n_new": INF_SPEC_BF16_NEW, "total_s": dt,
                              "verify_forwards": fwd,
                              "tokens_per_forward":
                                  (INF_SPEC_BF16_NEW - 1) / max(fwd, 1)}
    del sp14, params
    torch.cuda.empty_cache()
    # MoE make_generate on (2, 2, 2) at moe_bench's width
    cfg_m = mt.moe_config(dtype=torch.bfloat16)
    mesh_m = _inf_mesh(dev, (2, 2, 2), ("dp", "ep", "tp"))
    B, Tp, nn = INF_MOE_BF16
    spm = shard_params(init_params(cfg_m, seed=0, device=dev), cfg_m, mesh_m)
    gen = td.make_generate(cfg_m, mesh_m, nn)
    toks, dt, k = _counted(lambda: gen(spm, _prompt(cfg_m.vocab, B, Tp, 3)))
    counts["moe_generate_2x2x2"] = _want_counts(
        k, f"MoE make_generate on (2, 2, 2), B={B}, prompt {Tp}, n_new {nn}, "
        f"{dt:.2f} s", k1=cfg_m.n_layers * 8)
    _require(_replicas_bit_equal(toks), "MoE: the tp replicas' tokens differ")
    _require(bool(((toks.gather() >= 0) & (toks.gather() < cfg_m.vocab)).all()),
             "MoE: out-of-vocabulary tokens")
    print("  MoE make_generate: tp replicas bit-equal, tokens in the "
          "vocabulary")
    out["moe_generate_2x2x2"] = {"B": B, "prompt": Tp, "n_new": nn,
                                 "total_s": dt,
                                 "ms_per_token": dt / nn * 1e3}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del spm
    torch.cuda.empty_cache()
    print(f"  peak memory {out['peak_mem_gb']:.2f} GB; every rank on one "
          "card: per-rank and dispatch cost, no collective speed")
    return out, counts


def phase_slice19(dev, t_start, serve_ms_per_step,
                  phase19_ms) -> tuple[dict, dict]:
    """Phase 59. Returns (report, launches per run for the kernels
    line)."""
    from mpistragglers_jl_tpu_torch.parallel import dryrun_multichip

    t0 = time.perf_counter()
    print(f"  (+{t0 - t_start:.1f} s)")
    print(f"[59] sharded inference, every rank on one card: (a) f32 parity "
          f"at full width ({INF_F32_LAYERS} layers) on {INF_MESH}, (2, 2), "
          "(1, 4) and (2, 2, 2) with a control; (b) the bf16 paths (8 "
          "layers); (c) dryrun_multichip(8)")
    out, counts = {}, {}
    out["f32"], counts["f32"] = _inf_f32(dev)
    print(f"  (a) done (+{time.perf_counter() - t0:.1f} s)")
    out["bf16"], counts["bf16"] = _inf_bf16(dev, serve_ms_per_step,
                                                phase19_ms)
    print(f"  (b) done (+{time.perf_counter() - t0:.1f} s)")
    t1 = time.perf_counter()
    dryrun_multichip(8, device=dev)
    out["dryrun_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out, counts


MP_TIMEOUT = 420  # phase 60: both processes, start-up included


def _mp_counts(launches, what, **want) -> dict:
    """Hold one process's run of phase 60 to exact counts (the flash
    kernels and K5 by their K names), every other kernel 0."""
    names = {"K1": "flash_fwd", "K2": "flash_bwd_dq",
             "K3": "flash_bwd_dkv", "K5": K5}
    exp = {names[k]: v for k, v in want.items() if v}
    print(f"  {what}: {launches} (want {exp})")
    _require(launches == exp, f"{what} launched {launches}, want {exp}")
    return want


def phase_slice20(dev, t_start, loss_oracle, dense_ms, sharded_ms,
                  stream59, moe_oracles) -> tuple[dict, dict]:
    """Phase 60. ``loss_oracle`` is phase 57's first bf16 loss with the
    reference attention, ``dense_ms`` and ``sharded_ms`` phase 14's and
    phase 57's (2, 2, 2) ms/step, ``stream59`` phase 59(b)'s (2, 4) int8
    stream, ``moe_oracles`` phase 58(b)'s first oracle losses and
    ms/step of its EP (2, 1, 2, 2) and 1F1B (4, 2) runs. Returns
    (report, launches per run of one process)."""
    from mpistragglers_jl_tpu_torch.bench import multiproc as mp

    t0 = time.perf_counter()
    print(f"  (+{t0 - t_start:.1f} s)")
    print("[60] the mesh plane across two processes on one card (gloo), "
          "four ranks each: (a) f32 bit-equality with the single-controller "
          "step and streams, a control; (b) bf16 at full width, "
          f"{mp.SGD_STEPS} steps, and phase 59's (2, 4) int8 generation; "
          "then item 18h's models, the named axis across the processes: "
          "(a) f32 bit-equality of the EP step, ring generation, the "
          "serving tick, speculation, GPipe, circular, 1F1B and its "
          "checkpoint resume; (b) bf16 EP and 1F1B steps and the int8 "
          "tick, timed; then the device coordinator's window over ('w',) "
          "of 8: (a) f64 bit-equality, (b) config 3's width, timed")
    cfg = _train_cfg(torch.bfloat16)
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        handle = mp.start(tmp)
        # the oracle steps run while the processes start up
        inp, tgt = train_batch(cfg.vocab, dev)
        want_changes, ref_traj = _reference_changes(cfg, inp, tgt,
                                                    mp.SGD_STEPS)
        init = _leaves(init_params(cfg, seed=0, device=dev))
        del inp, tgt
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t1
        reps = mp.wait(handle, timeout=MP_TIMEOUT)
        run_s = time.perf_counter() - t1
        final = torch.load(os.path.join(tmp, "params.pt"))
    upd, n_leaves = _update_error(
        [a.to(dev).float() - b.float() for a, b in zip(final, init)],
        want_changes)
    del final, init, want_changes
    torch.cuda.empty_cache()
    L, Lg = SHARD_F32_LAYERS, TransformerConfig(**DECODE).n_layers
    k_new = mp.GEN_F32[2] - 1
    counts = {}
    for rep in reps:
        r = rep["rank"]
        msg = rep["nccl_shared_card"] or ""
        print(f"  process {r}: nccl on the shared card refused: "
              f"{msg[:110]}...; backend {rep['backend']}; start-up "
              f"{rep['init_s']:.1f} s, (a) {rep['f32_s']:.1f} s, the whole "
              f"process {rep['seconds']:.1f} s")
        _require("share cuda:0" in msg and "backend='gloo'" in msg,
                 f"process {r}: nccl on one card was not refused by name: "
                 f"{msg!r}")
        _require(rep["backend"] == "gloo", f"process {r}: {rep['backend']}")
        a = rep["f32"]
        ctrl = abs(a["ctrl_loss"] - a["step_x"]["loss"]) / abs(
            a["step_x"]["loss"])
        print(f"  process {r} (a): loss {a['step_x']['loss']:.7f}, the "
              f"step bit-equal to the single-controller one "
              f"{a['step_bit_equal']} ({a['step_x']['s']:.2f} s against "
              f"{a['step_s']['s']:.2f}); control, the bytes across "
              f"processes dropped: loss moves {ctrl:.3e} (must pass "
              f"{TRAIN_F32_LOSS:.0e}); streams equal greedy "
              f"{a['generate_greedy_equal']}, int8 "
              f"{a['generate_int8_equal']}")
        _require(a["step_bit_equal"], f"process {r}: the f32 step across "
                 "processes differs from the single-controller step")
        _require(ctrl > TRAIN_F32_LOSS, f"process {r}: the control passes")
        _require(a["generate_greedy_equal"] and a["generate_int8_equal"],
                 f"process {r}: a stream across processes differs")
        b = rep["bf16"]
        _require(b["exchanges"] > 0 and b["exchange_gb"] > 0,
                 f"process {r}: the timed bf16 step counted "
                 f"{b['exchanges']} exchanges across processes")
        k_bf16 = cfg.n_layers * 4 * mp.SGD_STEPS
        c = {
            "f32 step": _mp_counts(a["step_x"]["launches"],
                                   f"process {r} f32 step", K1=L * 4,
                                   K2=L * 4, K3=L * 4),
            "f32 single-controller step": _mp_counts(
                a["step_s"]["launches"], f"process {r} f32 step on its own "
                "8 ranks", K1=L * 8, K2=L * 8, K3=L * 8),
            "f32 generate greedy": _mp_counts(
                a["generate_greedy_x"]["launches"],
                f"process {r} greedy make_generate", K1=L * 4),
            "f32 generate int8": _mp_counts(
                a["generate_int8_x"]["launches"],
                f"process {r} int8 make_generate", K1=L * 4,
                K5=L * 4 * k_new),
            "bf16 steps": _mp_counts(
                b["launches"], f"process {r} bf16, {mp.SGD_STEPS} steps",
                K1=k_bf16, K2=k_bf16, K3=k_bf16),
            "bf16 generate int8": _mp_counts(
                b["generate_int8"]["launches"],
                f"process {r} bf16 int8 make_generate", K1=Lg * 4,
                K5=Lg * 4 * (mp.GEN_BF16[2] - 1)),
        }
        c.update(_mp_models_checks(rep, mp))
        counts.setdefault("per process", c)
        _require(c == counts["per process"], "the processes' counts differ")
    b0, b1 = (rep["bf16"] for rep in reps)
    rel = abs(b0["losses"][0] - loss_oracle) / abs(loss_oracle)
    stream = b0["generate_int8"]["stream"]
    print(f"  (b) losses {b0['losses']} (process 1: {b1['losses']}); first "
          f"against phase 57's oracle {loss_oracle:.5f}: {rel:.3e} (limit "
          f"{TRAIN_BF16_ORACLE:.0e}); worst leaf change {upd:.3e} (limit "
          f"{TRAIN_BF16_UPDATE}) over {n_leaves} changed leaves; "
          f"{b0['ms_per_step']:.1f} ms/step (process 1 "
          f"{b1['ms_per_step']:.1f}; the warm-up step "
          f"{b0['step_s'][0] * 1e3:.1f}), phase 57's (2, 2, 2) in one "
          f"process {sharded_ms:.1f}, phase 14's dense {dense_ms:.1f}; in "
          f"the timed step {b0['exchanges']} exchanges across processes "
          f"took {b0['exchange_ms']:.1f} ms for {b0['exchange_gb']:.3f} GB "
          f"out (process 1: {b1['exchange_ms']:.1f} ms); peak "
          f"{b0.get('peak_mem_gb', 0):.2f} GB a process")
    _require(b0["losses"] == b1["losses"], "the processes' losses differ")
    _require(rel <= TRAIN_BF16_ORACLE, f"first loss {rel} off the oracle")
    _require(upd <= TRAIN_BF16_UPDATE, f"the update leaves the oracle's: "
             f"{upd}")
    same = sum(a == w for a, w in zip(stream, stream59))
    print(f"  (b) make_generate int8 on (2, 4) across processes: "
          f"{b0['generate_int8']['s']:.2f} s; {same}/{len(stream59)} "
          "streams equal to phase 59's")
    _require(stream == b1["generate_int8"]["stream"] and same == len(
        stream59) == len(stream), "the (2, 4) stream differs from phase 59's")
    for rep in reps:
        rep["bf16"]["generate_int8"].pop("stream")
    models = _mp_models_bf16(reps, mp, moe_oracles)
    window = _mp_window(reps, mp)
    out = {"processes": reps, "run_s": run_s, "oracle_steps_s": ref_s,
           "models_bf16": models, "window": window,
           "bf16": {"loss_oracle": loss_oracle, "first_loss_rel_err": rel,
                    "update_rel_err": upd, "reference_losses": ref_traj,
                    "ms_per_step": [b0["ms_per_step"], b1["ms_per_step"]],
                    "phase57_ms_per_step": sharded_ms,
                    "phase14_ms_per_step": dense_ms},
           "seconds": time.perf_counter() - t0}
    print(f"  phase 60: {out['seconds']:.1f} s (the processes "
          f"{run_s:.1f}, the oracle steps beside their start-up "
          f"{ref_s:.1f})")
    return out, counts["per process"]


def _mp_models_checks(rep, mp) -> dict:
    """Phase 60(a) for item 18h's models on one process's report: each
    run bit-equal to the single-controller one, the checkpoint resume
    bit-equal, exact counts (this process's four ranks, or its half of
    a pipeline's). Returns the counts, by run."""
    r, m = rep["rank"], rep["models_f32"]
    runs = ("ep_step", "ring_int8", "tick_int8", "speculative", "gpipe",
            "circular", "1f1b")
    res = m["resume"]
    print(f"  process {r} (a) item 18h, f32, across processes bit-equal to "
          "the single-controller run: " + ", ".join(
              f"{n} {m[n]['bit_equal']} ({m[n]['x']['s']:.2f} s against "
              f"{m[n]['s']['s']:.2f})" for n in runs)
          + f"; 1F1B resumed from its checkpoint bit-equal {res['bit_equal']}"
          f" (uninterrupted {res['x']['bit_equal']}, files "
          f"{res['x']['files']}); speculation {m['speculative']['x']['forwards']}"
          " verify forwards")
    for n in runs:
        _require(m[n]["bit_equal"], f"process {r}: {n} across processes "
                 "differs from the single-controller run")
    _require(res["bit_equal"] and res["x"]["bit_equal"]
             and res["s"]["bit_equal"] and res["x"]["files"] == ["step_1"]
             and res["x"]["step"] == 1, f"process {r}: the resume {res}")
    L, Lp, M = 2, mp.PIPE_F32_LAYERS, 2
    k_ring = L * 4 * (mp.RING_F32[2] - 1)

    def pipe(name):  # this process's half of the mesh's stage layers
        shape = mp.PIPE_F32[name]
        return Lp * M * shape[0] // 2

    want = {
        "f32 EP step": dict(K1=L * 4, K2=L * 4, K3=L * 4),
        "f32 ring int8": dict(K5=k_ring),
        "f32 tick int8": dict(K5=L * 4 * mp.TICK_F32[1]),
        "f32 speculative": dict(K1=L * 4),
        "f32 gpipe": dict(K1=pipe("gpipe"), K2=pipe("gpipe"),
                          K3=pipe("gpipe")),
        "f32 circular": dict(K1=pipe("circular"), K2=pipe("circular"),
                             K3=pipe("circular")),
        "f32 1f1b": dict(K1=2 * pipe("1f1b"), K2=pipe("1f1b"),
                         K3=pipe("1f1b")),
    }
    b = rep["models_bf16"]
    Lb = 8
    shape, Mb, _ = pt.CELLS["1f1b"]
    k_1f1b = Lb * Mb * shape[0] // 2 * mp.SGD_STEPS
    want.update({
        "bf16 EP steps": dict(K1=Lb * 4 * mp.SGD_STEPS,
                              K2=Lb * 4 * mp.SGD_STEPS,
                              K3=Lb * 4 * mp.SGD_STEPS),
        "bf16 1f1b steps": dict(K1=2 * k_1f1b, K2=k_1f1b, K3=k_1f1b),
        "bf16 tick int8": dict(K5=Lb * 4 * mp.TICK_BF16[2]),
    })
    got = {"f32 EP step": m["ep_step"]["x"]["launches"],
           "f32 ring int8": m["ring_int8"]["x"]["launches"],
           "f32 tick int8": m["tick_int8"]["x"]["launches"],
           "f32 speculative": m["speculative"]["x"]["launches"],
           "f32 gpipe": m["gpipe"]["x"]["launches"],
           "f32 circular": m["circular"]["x"]["launches"],
           "f32 1f1b": m["1f1b"]["x"]["launches"],
           "bf16 EP steps": b["ep_step"]["launches"],
           "bf16 1f1b steps": b["1f1b"]["launches"],
           "bf16 tick int8": b["tick_int8"]["launches"]}
    return {run: _mp_counts(got[run], f"process {r} {run}", **w)
            for run, w in want.items()}


def _mp_models_bf16(reps, mp, moe_oracles) -> dict:
    """Phase 60(b) for item 18h's models: the EP and 1F1B first losses
    against phase 58's oracles, both processes' losses equal, the
    tick's tokens equal and in the vocabulary, ms and exchanges per
    process."""
    b0, b1 = (rep["models_bf16"] for rep in reps)
    out = {}
    for name, run in (("ep", "ep_step"), ("1f1b", "1f1b")):
        oracle, ms58 = moe_oracles[name]
        x0, x1 = b0[run], b1[run]
        rel = abs(x0["losses"][0] - oracle) / abs(oracle)
        print(f"  (b) {run} across processes: losses {x0['losses']}, the "
              f"first against phase 58's oracle {oracle:.5f}: {rel:.3e} "
              f"(limit {TRAIN_BF16_ORACLE:.0e}); {x0['ms_per_step']:.1f} "
              f"ms/step (process 1 {x1['ms_per_step']:.1f}; warm-up "
              f"{x0['step_s'][0] * 1e3:.1f}; phase 58 in one process "
              f"{ms58:.1f}); in the timed step {x0['exchanges']} exchanges "
              f"took {x0['exchange_ms']:.1f} ms for {x0['exchange_gb']:.3f} "
              f"GB out (process 1: {x1['exchanges']}, "
              f"{x1['exchange_ms']:.1f} ms, {x1['exchange_gb']:.3f} GB); "
              f"peak {x0['peak_mem_gb']:.2f} GB a process")
        _require(x0["losses"] == x1["losses"],
                 f"{run}: the processes' losses differ")
        _require(bool(np.isfinite(x0["losses"]).all()), f"{run}: {x0}")
        _require(rel <= TRAIN_BF16_ORACLE, f"{run}: first loss {rel} off "
                 "phase 58's oracle")
        _require(x0["exchanges"] > 0, f"{run}: no exchange across processes")
        out[run] = {"first_loss_rel_err": rel, "oracle": oracle,
                    "phase58_ms_per_step": ms58,
                    "ms_per_step": [x0["ms_per_step"], x1["ms_per_step"]],
                    "exchanges": [x0["exchanges"], x1["exchanges"]],
                    "exchange_ms": [x0["exchange_ms"], x1["exchange_ms"]],
                    "exchange_gb": [x0["exchange_gb"], x1["exchange_gb"]]}
    t0, t1 = b0["tick_int8"], b1["tick_int8"]
    print(f"  (b) the int8 serving tick on (2, 4), S={mp.TICK_BF16[0]}, "
          f"{mp.TICK_BF16[2]} inner steps across processes: "
          f"{t0['ms_per_tick']:.1f} ms/tick (process 1 "
          f"{t1['ms_per_tick']:.1f}; {mp.TICK_BF16[1]}-step warm-up "
          f"{t0['warmup_ms']:.1f}); {t0['exchanges']} exchanges (tp within "
          "each process)")
    _require(t0["tokens"] == t1["tokens"] and t0["tokens_in_vocab"],
             "the tick's tokens differ between the processes or leave the "
             "vocabulary")
    out["tick_int8"] = {"ms_per_tick": [t0["ms_per_tick"],
                                        t1["ms_per_tick"]],
                        "warmup_ms": [t0["warmup_ms"], t1["warmup_ms"]],
                        "exchanges": [t0["exchanges"], t1["exchanges"]]}
    for rep in reps:
        rep["models_bf16"]["tick_int8"].pop("tokens")
    return out


def _mp_window(reps, mp) -> dict:
    """Phase 60's device coordinator window, the pool axis across the
    processes: (a) f64, every window bit-equal to the single-controller
    one in both processes, ``last_full`` within 1e-9 of ``A @ B``, K
    reduce-scatters + one ring + one digest exchange a window; (b)
    config 3's width at ``"default"``, the histories equal to the flat
    window's, the product held to the flat window's decode of the same
    bf16 products and to ``A @ B`` (limits scaled by cond(G_S)), ms and
    exchanges per process of the timed window."""
    for rep in reps:
        r, w = rep["rank"], rep["window"]
        ex = [x["exchanges"] for x in w["f64_x"]]
        print(f"  process {r} (a) the device coordinator's window over ('w',) "
              f"of 8, f64, K={mp.WIN_KS}: bit-equal to the single-controller "
              f"window {w['f64_bit_equal']}; last_full rel err "
              f"{w['f64_last_full_rel_err']:.2e} (limit 1e-9); exchanges a "
              f"window {ex} (want K + 2); "
              + ", ".join(f"{x['s'] * 1e3:.1f} ms" for x in w["f64_x"])
              + " (single-controller "
              + ", ".join(f"{x['s'] * 1e3:.1f}" for x in w["f64_s"]) + ")")
        _require(w["f64_bit_equal"], f"process {r}: the f64 window across "
                 "processes differs from the single-controller window")
        _require(w["f64_last_full_rel_err"] < 1e-9,
                 f"process {r}: last_full {w['f64_last_full_rel_err']}")
        _require(ex == [K + 2 for K in mp.WIN_KS]
                 and all(x["exchanges"] == 0 for x in w["f64_s"]),
                 f"process {r}: exchanges {ex}")
        c = w["config3"]
        t = c["timed"]
        print(f"  process {r} (b) config 3's width {c['shape']} at "
              f"'default': warm-up K={c['warmup']['K']} "
              f"{c['warmup']['ms_per_epoch']:.1f} ms/epoch, timed "
              f"K={t['K']} {t['ms_per_epoch']:.1f} ms/epoch, "
              f"{t['exchanges']} exchanges {t['exchange_ms']:.1f} ms for "
              f"{t['exchange_gb']:.3f} GB out; histories equal the flat "
              f"window's {c['histories_equal_flat']}; fresh {c['fresh']}, "
              f"cond(G_S) {c['cond']:.1f}: rel err against the flat "
              f"window's decode {c['rel_err_vs_flat']:.2e} (limit "
              f"{c['limit_vs_flat']:.2e}), against A @ B "
              f"{c['rel_err_vs_ab']:.2e} (limit {c['limit_vs_ab']:.2e})")
        _require(c["histories_equal_flat"], f"process {r}: the config 3 "
                 "window's history differs from the flat window's")
        _require(c["rel_err_vs_flat"] <= c["limit_vs_flat"]
                 and c["rel_err_vs_ab"] <= c["limit_vs_ab"],
                 f"process {r}: the config 3 window's product: {c}")
        _require(t["exchanges"] == t["K"] + 2, f"process {r}: {t}")
    c0, c1 = (rep["window"]["config3"] for rep in reps)
    _require(c0["history"] == c1["history"],
             "the processes' config 3 histories differ")
    return {"f64_ms": [[x["s"] * 1e3 for x in rep["window"]["f64_x"]]
                       for rep in reps],
            "config3_ms_per_epoch": [c0["timed"]["ms_per_epoch"],
                                     c1["timed"]["ms_per_epoch"]],
            "config3_exchanges": [c0["timed"]["exchanges"],
                                  c1["timed"]["exchanges"]],
            "config3_exchange_gb": [c0["timed"]["exchange_gb"],
                                    c1["timed"]["exchange_gb"]],
            "config3_exchange_ms": [c0["timed"]["exchange_ms"],
                                    c1["timed"]["exchange_ms"]]}


def _phase60_launches(counts, key) -> dict:
    """One kernel's launches per process on phase 60's runs."""
    return {run: c[key] for run, c in counts.items() if c.get(key)}


def _phase59_launches(counts, key) -> dict:
    """One kernel's launches on phase 59's runs, for the kernels line."""
    return {f"{part} {run}": c[key] for part, runs in counts.items()
            for run, c in runs.items() if c[key]}


def _kernel_row(name, replaces, launches, err, tim,
                source="decode_attention.cu"):
    return {
        "name": name,
        "route": "cuda",
        "source": f"mpistragglers_jl_tpu_torch/ops/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": tim["ms"],
        "plain_ms": tim["plain_ms"],
        "bound_ms": tim["bound_ms"],
        "bound_by": tim["bound_by"],
        "library_ms": tim["library_ms"],
        # the same kernel timed at its other main-path shapes, and as
        # CUDA-graph replays where its ms is an eager loop's
        **{k: v for k, v in tim.items()
           if k.startswith("at_") or k.endswith("graph_ms")},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on "
              "the GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # f32 parity needs full-precision products, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, smi = attrib.card()
    print(f"[1] device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    native_builds = _start_native_builds()
    _build.build("decode_attention", "flash_attention", "sampling")
    t_build = time.perf_counter() - t0
    print(f"[2] built decode_attention.cu (K5, K6, K7), "
          f"flash_attention.cu (K1-K4) and sampling.cu, one nvcc each in "
          f"parallel (g++ of the native host sources beside them), in "
          f"{t_build:.1f} s; decode kernels at D=128:")
    _decode_build_report()

    print("[3] K5 against plain version, B=8 L=W=1024 D=128")
    err5 = phase_kernel_vs_plain(dev)

    print("[4] serving parity, f32, full width, kernel vs einsum route")
    phase_serving_parity_f32(dev)
    torch.cuda.empty_cache()

    print("[5] main path: bf16 serving, S=8, 512-token prompts, "
          "n_inner=64")
    launches5, serve = phase_serving_bf16(dev)
    torch.cuda.empty_cache()

    print("[6] K5 timing, bf16 ring, B=8 L=W=1024 Hkv=2 g=4 D=128")
    tim5 = phase_kernel_timing(dev)

    print("[7] K6 against plain version, B=8 D=128, pages of 16/64/24, "
          "split by paged_split_plan; then K6 under CUDA-graph capture")
    err6 = phase_paged_vs_plain(dev)
    phase_k6_graph(dev)

    print("[8] paged serving parity, f32, full width, pages of 64, "
          "kernel vs gather route")
    phase_paged_parity_f32(dev)
    torch.cuda.empty_cache()

    print("[9] paged main path: bf16, S=8, pages of 64, a shared "
          "256-token system prompt, n_inner=64")
    launches9, serve_paged = phase_paged_serving_bf16(dev)
    torch.cuda.empty_cache()

    print("[10] K6 timing, bf16, B=8 W=1024 (16 pages of 64) Hkv=2 g=4 "
          "D=128; then pages of 16 and 24 in a graph")
    tim6 = phase_paged_timing(dev)

    print("[11] flash_attention.cu (K1-K4), built in phase 2: registers "
          "and spills")
    _flash_build_report()

    print("[12] K1-K4 against their plain versions, bf16 and f32")
    err_flash = phase_flash_vs_plain(dev)
    torch.cuda.empty_cache()

    print("[13] training parity, f32, full width, batch 2, L=2048: flash "
          "against reference attention")
    phase_train_parity_f32(dev)
    torch.cuda.empty_cache()

    print(f"[14] training main path: bf16, batch {BATCH}, L={SEQ}, flash "
          f"attention, SGD lr {LR}")
    launches14, train, params, batch = phase_train_bf16(dev)

    print("[15] fused backward (K4), bf16, full width: one step's "
          "gradients against the split backward")
    launches15 = phase_fused_bf16(params, batch)
    del params, batch
    torch.cuda.empty_cache()

    print(f"[16] K1-K4 at the main path's shape, bf16, B={BATCH} L={SEQ} "
          "H=8 D=128, causal: against their plain versions, then timing")
    err16, tim_flash = phase_flash_bench_shape(dev)
    err_flash = {n: max(e, err16[n]) for n, e in err_flash.items()}

    print("[17] K7's variants and K5 positional against their plain "
          "versions on K5's split grid, bf16 and f32, (B, L, block_k) in "
          f"{ATTRIB_CASES}; then K5 under CUDA-graph capture")
    err7, err5_pos = phase_attrib_vs_plain(dev)
    err5 = max(err5, err5_pos)
    phase_k5_graph(dev)
    torch.cuda.empty_cache()

    print("[18] long-context generation parity, f32, full width, B=4, "
          "prompt 2048, n_new 32: int8 kernel vs einsum route, f32 cache "
          "vs teacher-forced forward_dense")
    phase_generate_parity_f32(dev)
    torch.cuda.empty_cache()

    print(f"[19] long-context main path: bf16, B=1, prompt {LONG_PROMPT}, "
          f"decode slope n_new {LONG_NEW} -> {LONG_NEW + SLOPE_STEPS}; "
          "then int8 AUTO at B=4; first K1 at the prefill shapes against "
          "its plain version")
    err_prefill, tim_prefill = phase_prefill_flash(dev)
    err_flash["flash_fwd"] = max(err_flash["flash_fwd"], err_prefill)
    torch.cuda.empty_cache()
    long_ctx = phase_long_context_bf16(dev)
    torch.cuda.empty_cache()

    print("[20] the attribution bench (K7): B=1 L=16384 H=8 Hkv=2 D=128, "
          "all variants; then B=4 and B=8, the full kernel")
    attrib_rows, launches7, tim7, sdpa16k = phase_attribution(dev)
    flag = attrib_rows[0]
    torch.cuda.empty_cache()

    print("[21] speculative decoding: f32 parity, then bf16 at "
          "bench_spec_decode's shape")
    spec = phase_speculative(dev)
    torch.cuda.empty_cache()

    print(f"[22] the pool on CUDA streams: {POOL_N} workers, "
          f"{POOL_EPOCHS} epochs, nwait={POOL_NWAIT}, workers {POOL_SLOW} "
          f"slowed {POOL_DELAY_S} s")
    coded = {"pool": phase_pool_streams(dev), **phase_coded(dev)}

    print("[27] MoE routing on the card, f32, T=16384 D=1024 E=4: the "
          "gather form against the one-hot oracle and the scatter-add "
          "combine, cf 1.25 and 0.5")
    moe_routing = phase_moe_routing(dev)
    torch.cuda.empty_cache()

    print(f"[28] MoE training main path: bf16, batch {BATCH}, L={SEQ}, 4 "
          f"experts, cf 1.25, aux 0.01, flash attention, SGD lr {LR}, "
          "through make_train_step(cfg, mesh) on a (1, 1, 1, 1) mesh beside "
          "the one-device step")
    moe_train = phase_moe_train(dev)
    torch.cuda.empty_cache()

    print("[29] MoE generation parity, f32, full width, 4 experts at cf 4 "
          "(no drops), B=4, prompt 2048, n_new 32: int8 kernel vs einsum "
          "route, f32 cache vs teacher-forced forward_dense")
    phase_generate_parity_f32(dev, TransformerConfig(
        **DECODE, n_experts=4, capacity_factor=4.0, dtype=torch.float32))
    torch.cuda.empty_cache()

    print(f"[30] coded transformer training: {ct_bench.N} workers on CUDA "
          f"streams, s={ct_bench.S}, chunks (2, 2049), workers "
          f"{ct_bench.STRAGGLERS} delayed {CODED_DELAY_S} s (f32 check), "
          f"{ct_bench.DELAY_S} s (bf16 run)")
    coded_train = phase_coded_train(dev)
    torch.cuda.empty_cache()

    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print(f"[31] the sampling kernel against its plain chain, S={SLOTS} "
          f"rows of V={MODEL['vocab']}, f32 and bf16, top_k None/1/"
          f"{SAMPLE_TOP_K}; then timed in a CUDA graph")
    err_sample, tim_sample = phase_sampling_vs_plain(dev)

    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print(f"[32] sampled serving parity, f32, full width, temperature "
          f"{SAMPLE_T}, top_k {SAMPLE_TOP_K}: kernel route against "
          "generate_ring_dense with each request's key")
    phase_sampled_parity_f32(dev)
    torch.cuda.empty_cache()

    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print(f"[33] slot-ring main path sampled and instrumented: bf16, "
          f"S={SLOTS}, n_inner={SERVE_INNER}, greedy-dark, sampled-dark, "
          "sampled-lit (registry, spans, flight, trace, ObsServer)")
    sampled_ring = phase_sampled_serving(dev, paged=False)

    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print(f"[34] paged main path sampled and instrumented: bf16, pages of "
          f"{PAGE}, a shared 256-token system prompt, the same three runs")
    sampled_paged = phase_sampled_serving(dev, paged=True)

    print(f"  (+{time.perf_counter() - t_start:.1f} s)")
    print(f"[35] the coded trainer and config 3's coded GEMM with a "
          f"registry, spans and an EpochTracer, {INSTR_EPOCHS} epochs")
    instrumented = phase_instrumented_coded(dev)
    torch.cuda.empty_cache()
    coded_family = phase_coded_family(dev, t_start)
    pool_utils = phase_pool_utils(dev, t_start)
    torch.cuda.empty_cache()
    process_pool = phase_host_backends(
        dev, native_builds, coded["config2"]["ms_per_epoch"], t_start)
    adaptive_final = [r["final_nwait"] for r in pool_utils["coded_sgd"][
        "runs"] if r["policy"] == "adaptive"][0]
    launches46, launches49, slice13 = phase_slice13(dev, t_start,
                                                    adaptive_final)
    k6_50, k6_51, slice14 = phase_slice14(dev, t_start)
    k6_52, k6_53, slice15 = phase_slice15(dev, t_start)
    slice16 = phase_slice16(dev, t_start)
    slice17, launches57 = phase_slice17(dev, t_start, train["ms_per_step"])
    slice18, launches58 = phase_slice18(
        dev, t_start, train["ms_per_step"],
        moe_train["one_device_ms_per_step"])
    slice19, launches59 = phase_slice19(
        dev, t_start, serve["ms_per_step"],
        long_ctx["decode_ms_per_token_int8_kernel"])
    ep58 = slice18["ep"]["x".join(map(str, EP_MESH))]
    f1b58 = slice18["pipeline"]["1f1b"]
    slice20, launches60 = phase_slice20(
        dev, t_start, slice17["bf16"]["loss_oracle"], train["ms_per_step"],
        slice17["bf16"]["2x2x2"]["ms_per_step"],
        slice19["bf16"]["generate_int8_2x4"]["stream"],
        {"ep": (ep58["oracle_trajectory"][0], ep58["ms_per_step"]),
         "1f1b": (f1b58["oracle_trajectory"][0], f1b58["ms_per_step"])})
    print(f"  (+{time.perf_counter() - t_start:.1f} s)")

    # K5's row: the serving shape's time (phase 6), with the long-context
    # shape's beside it (phase 20: graph replays; SDPA at the same B)
    tim5["at_16k_ms"] = {f"B={B}": {"ms": r["kernel_full_ms"],
                                    "library_ms": sdpa16k[B],
                                    "bound_ms": r["bound_ms"]}
                         for B, r in zip((1, 4, 8), attrib_rows)}
    tim_flash["flash_fwd"]["at_prefill_ms"] = {
        f"L={L}": r for L, r in tim_prefill.items()}
    kernels = [
        {**_kernel_row(K5, "mpistragglers_jl_tpu/ops/decode_attention.py:134",
                       launches5[K5], err5, tim5),
         "launches_are": "wrapper calls; each runs the split kernel and, "
                         "with more than one split, its combine"},
        {**_kernel_row(K6, "mpistragglers_jl_tpu/ops/decode_attention.py:105",
                       launches9[K6], err6, tim6),
         "launches_qos_phase49": launches49[K6],
         "launches_migration_phase50": k6_50,
         "launches_fleet_cache_phase51": k6_51,
         "launches_router_phase52": k6_52,
         "launches_two_tier_phase53": k6_53},
    ]
    kernels[0]["launches_sharded_inference_phase59"] = _phase59_launches(
        launches59, "K5")
    kernels[0]["launches_per_process_phase60"] = _phase60_launches(
        launches60, "K5")
    for kname, (_, line) in FLASH.items():
        launched = (launches15 if kname == "flash_bwd_fused"
                    else launches14)[kname]
        kernels.append({**_kernel_row(
            kname, f"mpistragglers_jl_tpu/ops/flash_attention.py:{line}",
            launched, err_flash[kname], tim_flash[kname],
            source="flash_attention.cu"),
            "launches_resume_phase46": launches46[kname],
            "launches_sharded_phase57": _phase57_launches(launches57,
                                                          kname),
            **({} if kname == "flash_bwd_fused" else {
                "launches_ep_pipeline_phase58": _phase58_launches(
                    launches58, kname)}),
            **({} if kname != "flash_fwd" else {
                "launches_sharded_inference_phase59": _phase59_launches(
                    launches59, "K1")}),
            **({} if kname == "flash_bwd_fused" else {
                "launches_per_process_phase60": _phase60_launches(
                    launches60, FLASH[kname][0])})})
    # K7's time is its fullest variant's (full_nosm); all four beside it
    variants = {m: flag[k] for m, k in attrib.VARIANTS.items()}
    kernels.append({
        **_kernel_row(K7, "benchmarks/decode_kernel_attrib.py:149",
                      launches7, err7, {"ms": variants["full_nosm"],
                                        "bound_ms": flag["bound_ms"],
                                        "bound_by": flag["bound_by"],
                                        **tim7}),
        "variants": variants,
        "launches_are": "eager calls; CUDA-graph replays not counted",
    })
    kernels.append({
        **_kernel_row(SAMPLE, "mpistragglers_jl_tpu/models/decode.py:726",
                      sampled_ring["sampled-lit"]["runs"][0]["launches"][
                          SAMPLE],
                      err_sample, tim_sample, source="sampling.cu"),
        "replaces_is": "the reference's XLA-fused _pick_token, not a "
                       "pallas_call: a port-only kernel",
        "launches_are": "the first slot-ring sampled-lit run of phase 33 "
                        "(admissions + inner steps)",
        "launches_sharded_inference_phase59": _phase59_launches(
            launches59, "sampler"),
    })
    _require(all(k["launches"] > 0 for k in kernels),
             "a kernel of a main path was never launched")
    print(json.dumps({"coded": coded, "card": smi}))
    print(json.dumps({"serving_bf16": serve,
                      "paged_serving_bf16": serve_paged,
                      "train_bf16": train,
                      "long_context_bf16": long_ctx,
                      "attribution": flag,
                      "speculative_bf16": spec,
                      "build_s": t_build,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"moe": {"routing": moe_routing, "train": moe_train},
                      "coded_train": coded_train}))
    print(json.dumps({"sampling": {"ring": sampled_ring,
                                   "paged": sampled_paged,
                                   "kernel": tim_sample},
                      "instrumented_coded": instrumented,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"coded_family": coded_family,
                      "pool_utils": pool_utils,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"process_pool": process_pool,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"slice13": slice13,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"slice14": slice14,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"slice15": slice15,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"slice16": slice16,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"slice17": slice17,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"slice18": slice18,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"slice19": slice19,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"slice20": slice20,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
