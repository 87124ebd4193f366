#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py                  # the check below
    python3 chip_smoke.py --profile-train  # where a train step's time goes
    python3 chip_smoke.py --profile-engine # where the engine's time goes

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit; TF32 off for f32 products
   and convolutions.
2. build: compile every kernel under kubeshare_tpu_torch/csrc with nvcc
   (one nvcc per source, all at once); each instantiation's registers and
   spills, and the SASS counts: wgmma and TMA in the bf16 kernels,
   mma.sync (HMMA) and cp.async (LDGSTS) in the three f32 kernels,
   which must not spill.
   hbm_cap: in a child process at TPUSHARE_MEM_FRACTION=0.5,
   isolation.apply_hbm_cap returns 0.5, 0.4 of the card allocates and
   0.6 raises torch.OutOfMemoryError.
3. kernels: the flash forward and the two flash backward kernels (dK/dV,
   dQ) against their plain PyTorch versions on the card, at the main
   paths' shapes and a few more (GQA, window, ragged, d=128, f32 causal
   and non-causal, the edges of the bf16 kernels' tiles, and
   train_sharded's unit), with the tolerances below; every f32 case
   also at the f32 path's shapes, and
   each f32 kernel launched once more with its outputs between guard
   bands (check_f32_writes: it must write every element of them, to the
   bit of its first launch, and nothing of the guards); then each kernel's time beside the plain version's,
   one library call's, and the bound the card sets, at the serving
   flagship's attention shape, at the training shape and at
   train_sharded's unit shape (1, 4, 2048, 128), with the
   achieved TFLOP/s and the ratio to the library call; and the f32
   instantiations' times at (4, 8, 1024, 64) beside SDPA at f32 (TF32
   off) and the bound at the 3xTF32 rate (165 TFLOP/s).
4. block_sparse: the masked instantiations of the three kernels against
   their plain versions at ten masks (documents, prefix-LM, dead rows,
   mask blocks straddling the kernels' tiles, JAX's default blocks, GQA,
   f32 at a ragged length, a document mask, a prefix-LM mask and dead rows
   at head_dim 128, the f32 ones also in guard bands); block_sparse_attention's
   forward and gradient at the document-masked training shape, held
   against the plain path; and each masked kernel's time there beside
   the plain version's, SDPA's with the expanded mask, and the bound.
5. slice: the flagship Transformer (entry.flagship_config, full width,
   weights from a seed) runs its forward at tokens (4, 1024), then serves
   4 requests (896-token prompts, 128 greedy tokens each: bulk prefill,
   then cached decode).  Both are held against the same path with plain
   attention.
   decode_capture: the same 4 requests served eager and with every decode
   step one CUDA graph replay (greedy_decode_with_cache(capture=True)):
   the two token streams must be equal; the serve time of each, and the
   CUDA-event ms of a decode step beside the host's enqueue ms.
   f32: the f32 path.  The flagship at f32 (entry.flagship_config(
   torch.float32), weights from seed 0): the bulk forward at random
   tokens (4, 1024) and a greedy serve of 4 x (896 + 128), against the
   same model with attention="reference" at f32 (logits within
   F32_LOGITS_ATOL, every served token teacher-forced within
   F32_TOKEN_MARGIN of its row's maximum), with the prefill ms and a
   decode step's ms; then the train-step flagship at f32: step 1's loss
   and every gradient against attention="reference" (F32_TRAIN_*), and
   3 eager AdamW steps timed by CUDA events.  Its launches are the
   kernels line's f32_forward, f32_serve and f32_train columns: every
   f32 kernel must run there.
   engine: serving.ServingEngine runs the flagship serving model (bf16,
   ENGINE_POOL: 8 slots, 16-row blocks, 64-token prefill chunks, spans of
   4, mixed batching and the prefix cache on) over 48 greedy requests
   arriving back to back (prompts of 64-896 tokens, a third of them
   sharing a 384-token prefix; 16-128 new tokens): warm-up captures every
   dispatch shape and serving captures none; tokens/s, TTFT and TBT from
   the engine's histograms, the dispatches' CUDA-event ms beside the
   host's ms a step, prefix hits, peak memory.  Every emitted token is
   held teacher-forced against the dense forward (within
   ENGINE_TOKEN_MARGIN of its row's maximum), and the share of streams
   equal to the dense greedy decode is printed.  A second pass with
   steps_per_launch=4 and a third behind an ExecutionGuard must emit the
   same streams; the guard must charge >= GUARD_MIN_SHARE of the
   dispatches' CUDA-event time.
   speculative: the dense draft-model decoders on the serving flagship,
   4 requests of 892 + 128 greedy tokens at draft_len 4, with a
   self-draft and with a truncated draft (the target's first layer,
   final norm and lm_head), every round one CUDA graph replay
   (speculative_greedy_decode(capture=True)): rounds, tokens a round,
   serve ms, a round's CUDA-event ms beside its host enqueue; the
   captured tokens must equal the eager rounds', every token must lie
   within ENGINE_TOKEN_MARGIN of its row's maximum in the dense forward,
   and the self-draft must take fewer rounds than tokens.  Then
   speculative_sample_decode once (T 0.9, top_k 50).
   engine speculative: the engine with self-drafted speculation
   (ENGINE_SPEC) over the same trace, steps_per_launch 1 (verify and
   mixed_verify dispatches), then 4 with an admission ring of 2 (the
   speculative loop), then the first behind a guard: the engine lines
   above plus acceptance, its per-round histogram, the loops' exit
   reasons and realised depth, ring activations, the teacher-forced
   check, the share of streams equal to speculation off; 0 captures
   after warm-up and guarded streams equal unguarded are required.
   engine_tier: the KV tiers and the autotuner on the flagship.  56
   requests, each one of 8 distinct 384-token prefixes + a private tail
   (benchmarks/serving_bench.py's tiered workload at the flagship's
   context), served (a) on a pool the size of HBM, (b) on a 193-block
   pool with no tier, (c) on it over a 32 MiB host tier, (d) over a 4 MiB
   host tier cascading to a 64 MiB disk arena; then (e) the autotuner
   over engine_trace at steps_per_launch=4.  Each pass prints the engine
   line, the tier counters, the upload dispatches' CUDA-event ms, the
   demotion and promotion host seconds, TTFT and tokens/s, and the streams
   equal to (a) (to the untuned loop pass for (e)).  Required: (c) and (d)
   demote and promote, (c) serves more requests from a cached prefix and
   runs fewer prefill chunks than (b), (d) promotes from disk, one upload
   graph in (c) and (d), 0 captures after warm-up, every stream at its
   length and teacher-forced within ENGINE_TOKEN_MARGIN, a tuning round in
   (e), and random bf16 rows demoted and promoted through the captured
   upload equal as int16 words.
   engine_disagg: disaggregated prefill/decode serving on the flagship.
   96 requests from benchmarks/serving_bench.py's disagg_settings /
   build_mixed_workload (one in eight a 192-288-token ingest prompt with
   8-16 new tokens, the rest 16-48-token streamers with 96-128), 16-row
   blocks, 64-token chunks, spans of 2, the settings' 120-block KV budget,
   served by (a0) a monolithic engine with mixed=False and the decode
   pool's 6 slots (the bit-exact oracle), (a1) it with mixed=True, (b) the
   two-cell DisaggRouter (prefill pool 2 slots / 41 blocks, decode pool 6
   / 81, 6 pending handoffs), (c) (b) with its tickets over a loopback
   fabric, (d) (a0) and (b) with every fourth request sampled (T 0.8,
   top_k 50), (e) (a1) and (b) under Poisson arrivals offering 0.7 of
   (a1)'s tokens/s.  Each pass prints tokens/s, TTFT, TBT (the decode
   pool's, from the pool-labelled histograms), dispatches, each pool's
   busy share by CUDA events, and for the router migrations, migrated
   bytes, the migration stall, the uploads' CUDA-event ms, the stage /
   pack / deliver host seconds and the handoff retries.  Required: no
   capture after warm-up in any pool, every migration packed delivered,
   (b) and (c) streams equal to (a0)'s and (d)'s router streams to its
   engine's, (a1), (b), (c) and (e) teacher-forced within
   ENGINE_TOKEN_MARGIN, and one migrated chain's bytes in the decode pool
   equal to the prefill pool's.
   engine_fleet: the replica fleet on the flagship.  48 requests from
   benchmarks/serving_bench.py's fleet_settings / build_fleet_workload
   (80% in 6 families of a 256-token prefix + an 8-16-token tail, the
   rest 8-192 tokens, 4-32 new), replicas of 6 slots / 81 blocks, served
   by (a0) one engine of 12 slots / 161 blocks (the equal-budget
   control), (a1) one engine of a replica's geometry, (b) a 2-replica
   ReplicaFleet with prefix affinity, back to back; (c) (a0), the
   affinity fleet and a round-robin fleet under Poisson arrivals offering
   0.5 of (a0)'s tokens/s; (d) chaos_settings (41 blocks a replica over a
   16 MiB shared host tier, every fourth request sampled) fault-free,
   with r1 killed halfway through its fault-free steps, and the kill
   replayed; (e) r0 drained a third into the trace and a scale-up once
   it retired, over the shared tier; (f) (e) over a loopback fabric.
   Each pass prints tokens/s, TTFT, prefix-hit tokens, dispatches and
   busy share per replica and the routing decisions; (d) the recovery
   (fault clock and host), salvage and orphans; (e), (f) the drain, the
   handoff's blocks and host seconds, r1's promotions after the handoff,
   r2's warm-up and (f)'s chain messages.  Required: 0 captures after
   each replica's own warm-up, affinity's prefix-hit tokens at least
   round robin's, the replay equal to the kill, one liveness failure and
   orphans readmitted, (f) equal to (e), and (b), (c), (d)'s greedy
   streams, (e), (f) teacher-forced within ENGINE_TOKEN_MARGIN.
   engine_sharded: tensor-parallel serving (serving/sharded.py) on the
   one card, every device group naming cuda:0 tp times, so the shards'
   bodies run in turn on its stream.  First one 64-token prefill chunk
   through the paged step and through the tp=2 and tp=4 twins on fresh
   pools: the first layer whose K/V differ and the logits' difference;
   the same for tests/test_torch_cuda.py's tiny f32 GQA model at tp=2
   (one KV head a shard), and the attention score product of one (lane,
   KV head) matrix alone against inside a batch, at f32 and bf16.
   Then (a) the flagship at tp=2 over engine_trace (ENGINE_POOL), (b) at
   tp=4 with long_context_threshold=64 (every full chunk takes the
   Ulysses route), then a GQA variant (2 KV heads, seed 0) at tp=4 in the
   replicated-KV fallback over the trace's first 16 requests against its
   own single-device engine, (c) the MoE model at tp=2 over its first 16
   requests against its single-device engine, (d) a ReplicaFleet of
   dp=2 x tp=2 over [cuda:0] * 4 on the first 16 requests.  Each pass
   prints the engine line, describe() and the estimated collective bytes
   by kind; (a) prints its tokens/s beside the single-device engine's.
   Required: 0 captures after warm-up, collective bytes counted, every
   stream bit-equal to the single-device engine's or teacher-forced
   within ENGINE_TOKEN_MARGIN (the count of each is printed; the MoE
   model's near-tie rows excused as in the moe phase), (a) and (b)
   head-sharded, (b)'s GQA variant replicated.  One card cannot show a
   tensor-parallel speed-up.
6. train: the repo's train-step flagship (benchmarks/kernel_bench.py
   MODEL_SIZES["flagship"], rope, bf16, full width and depth) takes 10
   AdamW steps on a fixed batch of 2 x 2048 tokens through
   parallel.train.make_train_step.  Step 1's loss and every gradient are
   held against attention="reference"; the loss must fall; the median
   step time gives tokens/s and the share of the bf16 peak.  Then the
   same 10 steps from the same state through make_train_step(...,
   capture=True) (one CUDA graph a step), held against the eager run
   (losses and parameters), each step's CUDA-event time beside its host
   enqueue time.
   moe: the repo's MoE model (benchmarks/kernel_bench.py
   MODEL_SIZES["moe"]: the train flagship with every 2nd MLP an 8-expert
   top-2 mixture at capacity factor 1.25; rope, bf16, full width and
   depth, weights from seed 0).  (a) ops.moe.moe_apply at x (2, 2048,
   1024) bf16 in both routings and both dispatches against the same call
   on the CPU in f32 routed by the card's router probabilities, scatter
   against einsum, a second run's output and gradients equal to the bit;
   the forwards profiled by kernel and timed beside the dense MLP of the
   same width and the experts' MLP alone.  (b) transformer_apply_with_aux
   at tokens (2, 2048) with the flash kernel against attention=
   "reference": the rows that router near-ties send to other experts are
   counted (each must be a near-tie, MOE_ROUTE_MARGIN) and the others'
   logits held at SLICE_LOGITS_ATOL.  (c) 4 requests of 896 + 128 greedy
   tokens, bulk prefill then the dense decode eager and captured (equal
   streams), every token teacher-forced against the dense forward with
   the experts' capacity pinned (rows within a routing near-tie
   excused).  (d) ServingEngine(ENGINE_POOL) over engine_trace: 0
   captures after warm-up, teacher-forced likewise.  (e) 10 AdamW steps
   on the train phase's batch, loss = cross entropy + MOE_AUX_COEF x aux:
   step 1 held against attention="reference" routed alike, eager,
   captured (equal to an eager run with the same AdamW to the bit, the
   default AdamW's first update at the drift limits) and captured with
   einsum dispatch, with step ms, tokens/s and the share of the bf16
   peak.
   train_sharded: the training half of the mesh (parallel/spmd.py,
   make_train_step(mesh=..., param_rules=...)) on the one card, the mesh
   dp=2 x tp=2 naming cuda:0 four times, on the train phase's batch.
   Step 1's loss and every gradient of the sharded program against one
   device's; then (a) the train-step flagship under
   transformer_sharding_rules, 10 steps eager and 10 captured (the whole
   sharded step one CUDA graph); (b) the same captured under
   transformer_fsdp_rules (embed P("tp", "dp"), wq P("dp", "tp", None),
   a unit holding half of (a)'s bytes); (c) the MoE model captured
   (experts over tp), after its step-1 forward against one device's with
   rows moved by router near-ties counted and excused; (d) moe_apply
   under moe_sharding_rules("ep") over dp=1 x ep=2 x tp=2 at x (2, 2048,
   1024) against the unsharded op, loss and gradients.  Each run prints
   its launches (the flash kernels per unit at (1, 4, 2048, 128)), losses,
   step ms by CUDA events beside the host enqueue, the bytes of
   parameters and moments a unit holds, and checks that every copy of a
   slice is equal to the bit; the losses are held to the single-device
   captured runs of the train and moe phases.
   long_context: long context and pipelined training of the train-step
   flagship (TRAIN_DIMS, rope, bf16, full width and depth) on meshes
   naming the card once a shard.  First row 1c: the ring's diagonal
   partial (_partial_flash, the flash forward) at (1, 8, 4096, 128)
   against its plain version and timed beside SDPA and the bound.  (a)
   transformer_apply_ring, the contiguous hybrid ring over sp=4 at 1 x
   16,384 tokens: logits against the single-device flash forward of the
   same tokens (LC_LOGITS_ATOL) and a control with RoPE at offset 0 on
   every shard that the limit must refuse; ten eager AdamW steps against
   ten single-device steps (LC_FIRST_LOSS_ATOL, LC_DRIFT_*: step 1's
   loss, every loss, the parameters over the update) and the RoPE
   control's ten steps, which they must refuse; the same ten steps
   captured (make_train_step(capture=True)) against the eager ring, each
   step's CUDA-event ms.  (b) the zigzag hybrid ring over dp=2 x tp=2 x
   sp=2 under transformer_fsdp_rules at 2 x 8,192: logits against the
   single-device forward and a control whose diagonal blocks drop their
   causal mask; ten steps against ten single-device steps at 2 x 8,192
   (LC_FIRST_LOSS_ATOL, LC_ZIGZAG_DRIFT_LOSS_ATOL, LC_DRIFT_UPDATE_RTOL)
   and the RoPE control's ten, which they must refuse.  (c)
   transformer_apply_ulysses over sp=4 at 1 x 16,384: logits; ten steps
   against (a)'s ten single-device steps (the same limits); its flash
   forward, dK/dV and dQ at a member's shape (1, 2, 16384, 128) are
   also held to their plain versions among the kernel phase's shapes
   ("ulysses_member").  (d) transformer_train_1f1b over
   pp=2 x sp=2, the hybrid ring in each stage, 4 microbatches of 1 x
   8,192: step 1's loss and every gradient against autograd through
   transformer_apply_ring over sp=2 (LC_1F1B_*), and a control that
   forgets one microbatch's cotangent, which they must refuse; three
   AdamW steps.  Launches are the kernels line's ring, ring_captured,
   zigzag, ulysses and pipeline_1f1b columns: the flash forward on every
   one, the backward kernels only on ulysses (the ring's backward is its
   own block math, as in JAX).
7. mnist: the co-run's MNIST at batch 512 from weights converted from a
   numpy tree: its logits against the CPU's, and 8 captured train steps
   against 8 eager ones, timed.
   resnet: the gang job's ResNet (models/resnet.py) at full width,
   ResNetConfig(), batch 128 of 32 x 32 x 3 random images: its logits
   against the CPU's relative to max |logit| (RESNET_LOGITS_RTOL, and a
   control with TF32 convolutions that it must refuse).  With
   deterministic convolutions: 10 captured steps held against 10 eager
   ones (hold_captured; the drift limits also against a control at 1.1x
   the learning rate, which they must refuse), the captured step fed by
   ShardedBatchLoader -> prefetch_to_device equal to the bit to it, a
   checkpoint saved at step 5 and restored in place into the captured
   step's state after step 10, steps 6-10 replayed to the same
   parameters to the bit, and ResNet and MNIST (batch 512) captured over
   dp=2 on [cuda:0] * 2 against one device.  Then, with the default
   convolutions, the captured step fed by the loader and prefetch, its
   CUDA-event ms and images/s; profile_trace's Chrome trace must hold
   CUDA kernel events.
8. distributed: BASELINE config 5, the DDP gang worker
   (train_distributed_torch.py's full-width config: vocab 8192, d 512, 8
   heads, 6 layers, bf16, 32 x 256 tokens, weights from seed 0) over
   torch.distributed.  (a) One process's 10 eager steps over the whole
   global batch, then two gloo ranks on cuda:0 (NCCL refuses two ranks
   on one GPU), real processes started as ``chip_smoke.py --ddp-worker
   DIR`` with the gang env and one deadline (DDP_RANK_TIMEOUT_S; a rank
   that fails kills the other), each its half of the batch: every rank
   launches the three dense kernels 6 times a step, the ranks'
   parameters are equal to the bit after every step (sha256), step 1's
   gradients after the all-reduce lie within DDP_GRAD_RTOL of one
   process's, and the losses and parameters follow its trajectory at
   the drift limits; controls: the gradients summed and not divided
   (refused by the gradient check; Adam hides it from the trajectory,
   which is printed) and no all-reduce (the ranks' parameters part).
   Each rank's step ms by CUDA events beside one process's.  The three
   kernels at a rank's shape and at one process's, DDP_RANK_SHAPE and
   DDP_SHAPE, are held to their plain versions among the kernel phase's
   shapes ("ddp_rank", "ddp_single").  Then 3
   steps captured over gloo (forward and backward one graph, the
   all-reduce between replays, the optimizer a second graph): the ranks
   equal to the bit, and equal to their eager steps with the same
   capturable AdamW within CAPTURE_SAME_*.  (b) One
   NCCL rank (world size 1): 3 eager steps against the plain step and 3
   captured with the all-reduce inside the graph against eager steps
   with the same optimizer (CAPTURE_SAME_*) and the default one (the
   drift limits).  (c) dryrun_multichip(8) with its multislice leg, and
   the DisaggRouter in virtual_multislice over [cuda:0, cuda:0] on 16
   requests of disagg_trace: streams equal to the monolithic engine's,
   every chain delivered.  (d) The mesh of ranks: in (a)'s two gloo
   processes, after (a)'s runs, train_distributed_torch.py --tp 2
   (make_mesh over the gang: dp=1 x tp=2, each rank half of every
   tp-split weight, the whole global batch) takes 5 eager steps, after
   a probe of which gloo collectives take CUDA tensors.  Every rank
   launches the three dense kernels 6 times a step at DDP_TP_SHAPE (held
   to their plain versions and timed among the kernel phase's shapes,
   "distributed_tp"); its losses and final parameters equal the
   one-process step over the same mesh on [cuda:0] * 2 to the bit, and
   one device's ((a)'s one process) within SHARDED_FIRST_LOSS_ATOL /
   SHARDED_DRIFT_LOSS_ATOL; each rank's parameter bytes beside the
   one-process mesh device 0's, the step ms by CUDA events and the
   share and bytes of the rank collectives.  (e) and (f), in the same
   processes after (d): the train-step flagship (half its layers) at 1 x
   LC_SEQ over a mesh of the two ranks dp=1 x tp=1 x sp=2, DDP_SP_STEPS
   eager steps of the zigzag hybrid ring (each rank's diagonal quadrants launch the
   flash forward at LC_DIAG_SHAPE, twice a layer) and of Ulysses (the
   three kernels once a layer at DDP_ULYSSES_SHAPE, held to their plain
   versions and timed among the kernel phase's shapes,
   "distributed_sp_ulysses"); then the MoE model (MOE_DIMS) at
   TRAIN_BATCH x TRAIN_SEQ over dp=2 ranks, the experts split over dp,
   loss CE + MOE_AUX_COEF x aux.  Each: launches per rank as expected,
   losses and final parameters equal to the one-process mesh over
   [cuda:0] * 2 to the bit, one device's within the LC_* limits ((e))
   or SHARDED_* ((f)); step ms by CUDA events and the rank collectives'
   ms, share and bytes received a step.  (g) and (h), in the same
   processes after (f): the train-step flagship (TRAIN_DIMS, full width
   and depth) under transformer_train_1f1b over pp=2 ranks
   (rank_mesh_over), DDP_PP_MICRO microbatches of one row, each rank a
   stage of four layers launching the three kernels at
   DDP_MOE_RANK_SHAPE once a layer and microbatch: a step with every
   forward hop carrying the previous microbatch (the control), then
   DDP_PP_STEPS eager AdamW steps; step 1's loss, each rank's stage's
   gradients and the embedding's and head's (sha256), the losses and
   the final parameters equal the one-process pipeline's over
   [cuda:0] * 2 to the bit, the control's must not, and the one-process
   pipeline follows one device's steps (SHARDED_FIRST_LOSS_ATOL, the
   train step's drift limits); each rank's step ms by CUDA events, the
   hops' (point to point) and broadcasts' ms and the bytes received a
   step.  (h) the ResNet (ResNetConfig(), RESNET_BATCH images) through
   data_parallel_apply over dp=2 ranks, DDP_RESNET_STEPS eager steps
   with deterministic convolutions: losses and final parameters equal
   to the one-process dp=2 mesh's to the bit, step ms beside it.
   discovery: discover_local_chips() against nvidia-smi's uuid, name
   and memory.total (within DISCOVERY_MEMORY_MIB); the card's link
   record (cell.topology.LinkRecord) from the driver's NVML, loaded with
   no fallback: NVML's uuid and bus id against nvidia-smi's (a bus id
   nvidia-smi prints as N/A must be NVML's NOT_SUPPORTED, and the record
   then carries the CUDA runtime's), the NUMA node against sysfs and
   nvidia-smi topo -m's NUMA affinity where either gives one, the
   enabled NVLinks against nvidia-smi nvlink -s's active links, the
   NVLink domain against the links' far ends, link_distance(chip, chip)
   == 0; csrc/nvml_test/api_check.cc built against the toolkit's nvml.h
   and run; Collector(
   CudaEnumerator()) served on port 0 and scraped, its gpu_capacity
   sample carrying the chip's labels and the record's topo label, which
   PromInventory reads back to the same record; a ChipSupervisor for the card's
   UUID over the tree's tpushare-tokend and tpushare-pmgr, one pod in
   its port file, one MNIST step gated by TokenClient + ExecutionGuard
   through the pod manager: tokend must charge the pod more than 0 ms.
   placement: the port's control plane places pods on the card and runs
   them.  The topology is built from discover_local_chips() (one node,
   one cell of the card's model) with TopologyConfig.from_dict; the
   port's KubeShareScheduler, in the shadow bind mode the deployment runs
   (deploy/cuda/scheduler.yaml: each placed pod is deleted and created
   again, so its uid changes), and SchedulerEngine over a FakeCluster bind
   pod A (request 0.5, limit 1.0) and pod B (0.5, 0.5), each with gpu_mem
   PLACEMENT_MEM_FRACTION of the card, to the card's UUID at two ports of
   the 50050 pool, and refuse pod C, the pod of
   deploy/cuda/examples/mnist-fractional.yaml (MNIST_MANIFEST_*: request
   0.5): the card is full.  The port's
   ConfigDaemon writes config/<UUID> and podmanagerport/<UUID>, and a
   The port's Aggregator, served on a free port, exports one
   gpu_requirement sample a running pod with the card's UUID, the node,
   the limit, request, memory and manager port; a second ConfigDaemon in
   aggregator mode scrapes it into its own directories, and its files
   must equal the cluster mode's byte for byte (the reference's chain:
   scheduler -> aggregator -> config daemon).  A
   ChipSupervisor over them runs the tree's tpushare-tokend and one
   tpushare-pmgr per pod at the scheduler's ports (a port of the pool
   taken on the host fails the phase).  A and B then run at once as
   child processes (chip_smoke.py --interposer-child pod OUT) whose env
   is the container env the scheduler injected, with a node's two
   substitutions: LD_PRELOAD's /kubeshare/library path becomes the built
   hook's, and NVIDIA_VISIBLE_DEVICES becomes CUDA_VISIBLE_DEVICES.  Each
   sees one device of the injected UUID, mem_get_info's total within
   PLACEMENT_CAP_TOLERANCE of the card of its gpu_mem, 0.3 of the card
   allocates and 0.6 raises torch.OutOfMemoryError, and it runs
   PLACEMENT_SECONDS of captured MNIST steps; "running ungated" in its
   stderr fails the phase.  Tokend's stat must show each pod under the
   scheduler's pod key with a grant and a charge.  Deleting B reclaims
   its cell and port: the files fall to one pod, the supervisor reaps
   B's pod manager, C binds on the next cycle and its pod manager runs
   at C's port.  C then runs the manifest's container command
   (python train_mnist_torch.py, at --steps MNIST_MANIFEST_STEPS) under
   its injected env with the same two substitutions: it must exit 0
   without "running ungated", its hook (CUDAHOOK_STATS) must be gated
   with graph launches, and tokend must show a grant and a charge for
   C's key.
9. corun: corun_bench.py's four phases (solo A, solo B, the co-run of
   two MNIST pods under tpushare-tokend, the adversarial pair) at 3 s
   windows; every phase must produce a result and every pod must be
   granted tokens.  The ratio and the adversarial flags are reported.
   corun_serve: corun_bench.py --suite serve's three phases (two decode
   pods, each request a prefill and 64 greedy tokens through the
   captured decode step) at 3 s windows: every pod must be granted
   tokens; the tokens/s ratio and the p50/p95 latencies are reported.
   The pods' prefills launch the flash forward in their own processes,
   out of the counters' sight.
10. interposer: libcudahook.so.1 (csrc/cuda_hook.cc) LD_PRELOADed into
   the port's unmodified workloads.  (a) csrc/hook_test/api_check.cc,
   the in-tree driver prototypes held by static_assert against the
   toolkit's cuda.h, is built and run.  Two pods, each behind a
   tpushare-pmgr and a tokend of its own: hook/full (limit 1.0, the
   default 10 s window) and hook/half (limit and memory cap
   INTERPOSER_FRACTION, a 1 s window).  Three child
   processes (``chip_smoke.py --interposer-child ROLE OUT``), none of
   which imports kubeshare_tpu_torch.isolation: "plain" without the
   hook, "hooked" under it as hook/full, "limited" under it as hook/half.
   (b) The train-step flagship's 10 eager and 10 captured steps in plain
   and hooked: losses and parameters (sha256) equal to the bit, 10 graph
   launches, and the hook's launches by kernel name of the three flash
   kernels equal to the port's counters (the proof that no copy of the
   CUDA runtime bypasses the hook).  (c) The broker's charge for
   captured steps 2-10 against their CUDA-event ms, within
   INTERPOSER_CHARGE_RANGE, which the host's dispatch time (the control)
   falls outside.  (d) A greedy captured loop (the loss read every step)
   in limited against plain: steps/s within INTERPOSER_SHARE_RANGE,
   which excludes the ungated loop's 1.0.  (e) In limited: the broker's
   mem_used at a quiescent point against memory_reserved() (no less),
   0.6 of the card refused with torch.OutOfMemoryError, mem_used back to
   its value after del and empty_cache, mem_get_info reporting the cap
   as total.  (f) The serving engine over engine_trace in plain and
   hooked (every dispatch shape captured in warm-up under the hook): the
   streams equal to the bit, 0 captures after warm-up.  (h) The eager
   and captured steps' CUDA-event medians with and without the hook;
   the libraries' resolution paths from the hooked child's counters.
   (g) corun_bench.run_suite with gate="preload" at 3 s windows: every
   pod must be granted tokens; the ratio and the adversarial flags are
   reported.  The kernels line's interposer column is the hooked
   child's launch counters over (b); interposer_hook_launches is the
   hook's count of the same launches.

The launch counters are zeroed before each path and read after it (the
captured paths' around their capture: a replay bumps no counter).  The
engine's paths (engine, engine_spec, engine_tier, engine_disagg,
engine_fleet, engine_sharded, moe_engine) launch
none of the kernels (their attention is the paged einsums, as in the JAX engine), so
their counts read 0; the speculative
path's prefills launch the flash forward.  The distributed column sums
the two ranks' own counters (each zeroed before its ten steps and read
after them in its process), distributed_captured their captured runs'
(around the capture); distributed_single is (a)'s one process,
distributed_nccl (b)'s four runs, distributed_multislice (c)'s dry run
(its rings' flash kernels) and router (0).  The
last lines are the card (nvidia-smi), a JSON ``kernels`` line, and
``{"ok": true, "device": {...}}``.

``--profile-train`` builds the kernels and runs only the train path's
steady steps under ``torch.profiler``, eager, captured, and captured over
train_sharded's dp=2 x tp=2 mesh: the
host's enqueue time and the wall time per step, the device's busy share,
and device time by kernel.  ``--profile-engine`` does the same for the
engine phase's default pass over its trace, on the serving flagship and
then on the MoE model.

Without a CUDA device, or without the rest of the repository beside it,
the script fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): the bound a kernel is held to.
# f32: the card's fastest route to f32-accurate products is three TF32
# passes on the tensor cores (3xTF32, what the f32 flash kernels run):
# 495 / 3 = 165 TFLOP/s, above the 67 TFLOP/s of f32 FMAs on the CUDA
# cores, so a kernel's least time at f32 is its operations at 165.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}

# kernel vs its plain version, same inputs on the card.  out: both round
# the same f32 result to the output dtype after summing in another order
# (and bf16 p is rounded against the running max in the kernel, the
# final max in the plain version), so allow about one bf16 ulp of |out|
# on top of a small absolute term.  lse stays f32 throughout: only the
# summation order differs.
TOLERANCES = {
    "bfloat16": {"out_atol": 1e-2, "out_rtol": 1e-2, "lse_atol": 1e-3},
    "float32": {"out_atol": 1e-4, "out_rtol": 1e-4, "lse_atol": 1e-4},
}
# the flagship with the kernel vs with attention="reference" (bf16): the
# reference rounds scores to bf16 before the softmax, the kernel keeps
# them f32, and four layers carry the difference to the logits and to the
# cached K/V (|k| reaches ~8, where a bf16 ulp is 0.03-0.06)
SLICE_LOGITS_ATOL = 0.1
SLICE_KV_ATOL = 0.2
# backward kernels vs flash_backward_reference, same inputs on the card,
# as max |kernel - plain| / max |plain| per gradient (gradients vary in
# magnitude from tensor to tensor).  bf16: both round p and ds to bf16 at
# the same points and the results to bf16 at the end, but from f32 values
# summed in another order, so an element may land on the neighbouring
# bf16 value (2^-8 relative); allow a few such ulps of the largest
# gradient.  f32: only the summation order differs.
BWD_TOLERANCES = {"bfloat16": 1e-2, "float32": 1e-5}
# the train step with the kernels vs with attention="reference" (bf16):
# the reference rounds scores to bf16 before its softmax (an absolute
# error of ~0.03 on scores of ~8, a few % on p), the kernels keep them
# f32, and eight layers carry the difference into every gradient.  Loss:
# absolute, on a loss of ~11.  Gradients: max |diff| / max |ref| per
# tensor, and their cosine similarity.
TRAIN_LOSS_ATOL = 2e-2
TRAIN_GRAD_RTOL = 0.1
TRAIN_GRAD_MIN_COSINE = 0.99
# remat on vs off: the backward recomputes each layer with the same
# kernels on the same inputs, so the gradients agree to round-off (a
# library reduction whose order may differ between the two runs)
REMAT_GRAD_RTOL = 1e-3

# benchmarks/kernel_bench.py MODEL_SIZES["flagship"]: the repo's own
# train-step flagship, at batch 2 x 2048 (suite_model builds it with rope
# and bf16)
TRAIN_DIMS = dict(vocab_size=32000, d_model=1024, n_heads=8, n_layers=8,
                  d_ff=4096, max_seq_len=2048)
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS = 10
TRAIN_TIMED_FROM = 3  # median over steps 3..10 (1-based): past warm-up

PROMPT_LEN = 896
# check_f32_writes: sentinel floats on each side of every output of an
# f32 kernel's launch (64 KB a side: 128 rows of a head at d = 128)
GUARD_FLOATS = 1 << 14
GUARD_SENTINEL = -3.0e38
# the f32 kernels' timing shape (serving's attention shape)
F32_TIMED_SHAPE = (4, 8, 1024, 64)
NEW_TOKENS = 128
N_REQUESTS = 4

# the f32 phase: each model with the kernels against the same model with
# attention="reference" at f32 (TF32 off).  Both attentions compute in
# f32; they differ in summation order, in the kernels' 3xTF32 products
# (the dropped small x small term, 2^-22 of each product) and in the
# softmax's form (online with exp2 against one pass with exp), and the
# layers carry that to the logits and gradients.  Each limit sits between
# two readings on an H100: the shipped kernels' and one TF32 pass's
# (flash_ablations.py runs this phase with its one_pass control).
# Logits, absolute on logits of magnitude ~1-5: 3.6e-5 against 8.2e-4
# (prefill) and 1.6e-3 (forward).  Gradients, max |diff| / max |ref| per
# tensor: 1.5e-4 against 2.2e-3; their lowest cosine similarity 1 - 1e-7
# against 1 - 1.3e-6.  Loss, absolute on a loss of 10.88 (an f32 ulp is
# 9.5e-7): 0 against 3.8e-6; the limit is two ulps.  Tokens: each emitted
# token within F32_TOKEN_MARGIN of its row's maximum under the reference
# forward (the engine's teacher-forced rule); every token is its row's
# argmax under both designs, so the margin follows the logits' limit.
# dK/dV without its per-step partials (the no_partials control) moves none
# of these readings: its dk, dv error (2.7e-5 of max) stays under the
# worst tensor's gap to the reference (a query projection, whose gradient
# comes through dQ); the kernel checks (BWD_TOLERANCES) refuse it.
F32_LOGITS_ATOL = 2e-4
F32_TOKEN_MARGIN = 2 * F32_LOGITS_ATOL
F32_TRAIN_LOSS_ATOL = 2e-6
F32_TRAIN_GRAD_RTOL = 5e-4
F32_TRAIN_GRAD_MIN_COSINE = 0.9999995
F32_TRAIN_STEPS = 3

# the captured train step against two eager runs from the same state and
# batches.  (1) An eager step with the same optimizer (AdamW switched to
# its capturable mode, as the captured step switches it):
# the graph replays that step's kernels on the same inputs in the same
# order, so the two agree up to the library kernels' run-to-run
# nondeterminism (none seen on the flagship, equal to the bit; ~1e-6 of
# MNIST's update, from its convolution gradients).  (2) The default eager
# step (AdamW with its bias corrections in Python floats, where the
# capturable one computes them in f32 on the device): the parameters
# differ in their last bits after step 1; in bf16 some weights then round
# to the neighbouring bf16 value, and Adam's normalised step turns small
# gradient differences into whole steps of lr, so the two runs drift
# apart over the steps (first card runs: a loss 9.5e-3 apart at step 10
# of the flagship, 1.7e-2 of its update; 7.8e-5 and 2.3e-4 on MNIST in
# f32).  Step 1's loss precedes any update and is held to (1)'s limit;
# the flagship's drift to the bounds of the train phase's
# kernel-vs-reference check, MNIST's (f32, no bf16 rounding to amplify)
# to a few times its readings.  On the card these comparisons with the
# default run are the only check that capturable AdamW computes optax's
# update.  Loss: absolute.  Parameters: per tensor, the norm of the
# difference of two runs over the norm of the eager run's whole update.
CAPTURE_SAME_LOSS_ATOL = 1e-5
CAPTURE_SAME_UPDATE_RTOL = 1e-4
CAPTURE_DRIFT_LOSS_ATOL = TRAIN_LOSS_ATOL
CAPTURE_DRIFT_UPDATE_RTOL = TRAIN_GRAD_RTOL
MNIST_DRIFT_LOSS_ATOL = 5e-4
MNIST_DRIFT_UPDATE_RTOL = 1e-3
# the captured flagship step gated by an ExecutionGuard and returning only
# its state (a TrainState): the guard's charge must cover the device's
# burst, at least this share of the step's CUDA-event median (charging
# the enqueue alone would read ~0.01)
GUARD_STEPS = 5
GUARD_MIN_SHARE = 0.9
# MNIST on the card, f32 with TF32 off: the card's logits vs the CPU's on
# the same weights and images, f32 summed in another order, ~1e-6 of
# logits of a few units (TF32 would show ~1e-2)
MNIST_BATCH = 512
MNIST_STEPS = 8
MNIST_LOGITS_ATOL = 1e-4
# the co-run's measured windows here (corun_bench.py's own default is
# 10 s): four phases in about 90 s
CORUN_SECONDS = 3.0
# resnet: the gang job's ResNet (models/resnet.py, BASELINE config 3) at
# full width, ResNetConfig() (widths 64 / 128 / 256 / 512, 2 blocks a
# stage, 8 groups), batch 128 of 32 x 32 x 3 images from a seed, f32 with
# TF32 off.  Its logits on the card against the CPU's on the same weights
# and images, relative to max |logit|: the limit lies between the shipped
# reading and a control that runs the convolutions in TF32, which it
# must refuse (both printed).
RESNET_BATCH = 128
RESNET_DATASET = 2048  # images a ShardedBatchLoader epoch holds
RESNET_STEPS = 10
RESNET_CKPT_STEP = 5  # saved here, resumed here in the checkpoint check
RESNET_LOGITS_RTOL = 1e-4
# ResNet captured against eager (hold_captured) and over a dp=2 mesh
# against one device, with deterministic convolutions (cuDNN's fastest f32
# ones are not: two such runs part by ~2.5e-3 in loss after 10 steps).
# The same optimizer gives the same bits (read 0).  Against the default
# AdamW (capturable vs not: the bias corrections rounded on the device)
# and over dp (the units' gradients summed in another order) the runs
# drift: at lr 1e-3 the first steps drive the loss from 3.05 to 10.5, and
# Adam's normalised step turns round-off in the many near-zero gradient
# components that group norm leaves into whole steps of lr (first card
# runs, H100: loss 1.832e-3 / update 1.338e-2 against the default AdamW,
# 3.113e-3 / 5.090e-2 over dp).  The limits lie between those readings
# and the control's, the same steps with AdamW at RESNET_CONTROL_LR
# (0.4148 / 0.2836), which they must refuse.  Loss: absolute.  Update:
# per tensor, |difference| / |the reference run's update|.
RESNET_DRIFT_LOSS_ATOL = 2e-2
RESNET_DRIFT_UPDATE_RTOL = 0.1
RESNET_CONTROL_LR = 1.1e-3
# MNIST over dp=2 against one device: MNIST's own drift limits (read
# 7.153e-7 / 3.036e-5; the control at RESNET_CONTROL_LR 1.344 / 0.1882)
MESH_DP = 2
# decode_capture: steps of the dense decode timed one by one after the
# first (capturing) call, eager and captured
DECODE_TIMED_STEPS = 64
# engine: the flagship serving model behind ServingEngine at full width
# (EngineConfig below), a trace of ENGINE_REQUESTS greedy requests from
# ENGINE_SEED arriving back to back: prompts of ENGINE_PROMPT tokens,
# outputs of ENGINE_NEW, one request in ENGINE_SHARE_EVERY opening with
# the same ENGINE_PREFIX-token prefix (prefix hits).  The prefix ends on
# a block boundary, so every other sharer also shares the next
# ENGINE_COW_EXTRA tokens: its match ends inside a block, which the
# engine copies on write before the request appends
ENGINE_REQUESTS = 48
ENGINE_SEED = 0
ENGINE_PROMPT = (64, 896)
ENGINE_NEW = (16, 128)
ENGINE_PREFIX = 384
ENGINE_SHARE_EVERY = 3
ENGINE_COW_EXTRA = 8
ENGINE_POOL = dict(num_slots=8, block_size=16, num_blocks=513,
                   max_request_len=1024, prefill_chunk=64, decode_span=4)
# the teacher-forced check: every token the engine emitted is held
# against the dense forward (transformer_apply, the flash kernel) over
# prompt + emitted tokens, and must lie within this margin of its row's
# maximum.  The engine's greedy pick is the argmax of logits that differ
# from the dense path's by the bf16 attention's rounding (the paged
# steps round scores to bf16 before the softmax, the kernel keeps them
# f32): up to SLICE_LOGITS_ATOL on either side, so an emitted token can
# trail the dense row's maximum by twice that where two logits nearly tie
ENGINE_TOKEN_MARGIN = 2 * SLICE_LOGITS_ATOL
# speculative: the dense draft-model decoders on the serving flagship,
# SPEC_REQUESTS prompts of SPEC_PROMPT tokens and SPEC_NEW new tokens
# (prompt + new + draft_len must fit max_seq_len 1024), and the engine
# with self-drafted speculation over engine_trace
SPEC_REQUESTS = 4
SPEC_PROMPT = 892
SPEC_NEW = 128
SPEC_DRAFT_LEN = 4
SPEC_TIMED_ROUNDS = 32
# speculative_sample_decode's filters, and its check: teacher-forced
# through the dense forward, each sampled token's logit reaches its row's
# SPEC_TOP_K-th largest less ENGINE_TOKEN_MARGIN; its log-probability
# under the filtered distribution at SPEC_TEMPERATURE over the tokens
# within that margin stays above SPEC_LOGP_FLOOR (a correct sampler goes
# below it with probability under 512 draws x 50 tokens x 1e-7 = 0.003);
# and the sum over tokens of the scaled logit less its mean under the
# row's top-k distribution lies within SPEC_LOGIT_Z standard errors of 0
# (a sum of martingale differences, its variance the sum of each row's;
# logits rather than log-probabilities, so that a token swapped across
# the top-k boundary by bf16 rounding moves the sum by its tiny logit gap)
SPEC_TEMPERATURE = 0.9
SPEC_TOP_K = 50
SPEC_LOGP_FLOOR = math.log(1e-7)
SPEC_LOGIT_Z = 5.0
ENGINE_SPEC = dict(speculative=True, draft_len=4, draft_ngram=3)
# engine_tier: benchmarks/serving_bench.py's tiered_settings /
# build_tiered_workload scaled to the flagship's context: TIER_REQUESTS
# greedy requests from TIER_SEED, all submitted at once, each opening with
# one of TIER_PREFIXES distinct TIER_PREFIX_LEN-token prefixes chosen
# uniformly (reuses interleave, so a small pool churns between them), then
# a private tail of TIER_TAIL tokens and TIER_NEW new tokens.  The working
# set is 8 x 24 = 192 blocks of 16 rows; one block is 2 x 4 layers x 8
# heads x 16 rows x 64 x 2 B = 131,072 B of K/V.  Passes: (a) a pool the
# size of HBM (TIER_HBM_BLOCKS: nothing is evicted); (b) TIER_SMALL_BLOCKS,
# no tier (the live lanes' tails and new tokens take up to 104 of its 192
# usable blocks, leaving under half the working set, so evicted prefixes
# are prefilled again); (c) the same pool over a host tier holding the
# whole working set; (d) the same over a host tier of about 32 blocks
# cascading to a disk arena; (e) autotune over engine_trace, held to the
# steps_per_launch=4 pass
TIER_REQUESTS = 56
TIER_SEED = 0
TIER_PREFIXES = 8
TIER_PREFIX_LEN = 384
TIER_TAIL = (8, 64)
TIER_NEW = (16, 128)
TIER_POOL = dict(num_slots=8, block_size=16, max_request_len=1024,
                 prefill_chunk=64, decode_span=4)
TIER_HBM_BLOCKS = 513
TIER_SMALL_BLOCKS = 193
TIER_HOST_BYTES = 32 << 20
TIER_CASCADE_HOST_BYTES = 4 << 20
TIER_DISK_BYTES = 64 << 20
# the demotion read compared both ways over this many blocks (a
# prefix's), in turns, the best of each kept
TIER_READ_BLOCKS = 24
TIER_READ_TURNS = 5
# engine_disagg: benchmarks/serving_bench.py's disagg_settings /
# build_mixed_workload on the flagship (its vocab_size 4096 cut to the
# model's 2048): DISAGG_REQUESTS greedy requests from DISAGG_SEED, one in
# eight (DISAGG_LONG_FRACTION) an ingest request (DISAGG_LONG_PROMPT
# tokens, DISAGG_LONG_NEW new), the rest streamers (DISAGG_SHORT_PROMPT,
# DISAGG_SHORT_NEW).  The KV budget is the settings' 120 allocatable
# blocks: monolithic 121, prefill 41 + decode 81 (scratch block included
# in each); every pool DISAGG_SHARED.  The monolithic engine with
# mixed=False and the decode pool's 6 slots runs decode spans of the
# decode pool's shape: the bit-exact oracle.  Pass (d) samples every
# DISAGG_SAMPLE_EVERY-th request; pass (e) draws Poisson arrivals from
# the trace's own unit exponentials, scaled so the offered tokens/s is
# DISAGG_LOAD of the back-to-back mixed pass's
DISAGG_REQUESTS = 96
DISAGG_SEED = 0
DISAGG_LONG_FRACTION = 0.125
DISAGG_LONG_PROMPT = (192, 288)
DISAGG_LONG_NEW = (8, 16)
DISAGG_SHORT_PROMPT = (16, 48)
DISAGG_SHORT_NEW = (96, 128)
DISAGG_SHARED = dict(block_size=16, max_request_len=320, prefill_chunk=64,
                     decode_span=2)
DISAGG_MONO = dict(num_slots=6, num_blocks=121)
DISAGG_PREFILL = dict(num_slots=2, num_blocks=41)
DISAGG_DECODE = dict(num_slots=6, num_blocks=81)
DISAGG_PENDING = 6
DISAGG_SAMPLE_EVERY = 4
DISAGG_TEMPERATURE = 0.8
DISAGG_TOP_K = 50
DISAGG_LOAD = 0.7
# engine_fleet: benchmarks/serving_bench.py's fleet_settings /
# build_fleet_workload on the flagship (its vocab_size 4096 cut to the
# model's 2048), in the workload's draw order: FLEET_REQUESTS greedy
# requests from FLEET_SEED, FLEET_SHARED of them in FLEET_GROUPS families
# (a FLEET_PREFIX-token prefix + a FLEET_TAIL-token tail), the rest
# FLEET_PROMPT-token prompts, FLEET_NEW new tokens each, unit-mean
# exponential gaps.  FLEET_REPLICAS replicas of FLEET_REPLICA against the
# monolithic control FLEET_MONO at the bench's equal aggregate KV budget
# (2 x 80 allocatable blocks) and against a monolithic engine with one
# replica's geometry, the oracle with the same dispatch shapes.  Pass (c)
# offers FLEET_LOAD of the control's back-to-back tokens/s; pass (d) is
# the settings' chaos_settings (FLEET_CHAOS_BLOCKS per replica over a
# FLEET_CHAOS_TIER shared host tier, replica r1 killed by
# FaultPlan(FLEET_CHAOS_SEED) halfway through its fault-free steps) with
# requests sampled as in engine_disagg (d); passes (e) and (f) drain
# r0 a third into the trace and scale up once it retired
FLEET_REQUESTS = 48
FLEET_SEED = 0
FLEET_SHARED = 0.8
FLEET_GROUPS = 6
FLEET_PREFIX = 256
FLEET_TAIL = (8, 16)
FLEET_PROMPT = (8, 192)
FLEET_NEW = (4, 32)
FLEET_REPLICAS = 2
FLEET_REPLICA = dict(num_slots=6, block_size=16, num_blocks=81,
                     max_request_len=320, prefill_chunk=64, decode_span=4)
FLEET_MONO = dict(FLEET_REPLICA, num_slots=12, num_blocks=161)
FLEET_LOAD = 0.5
FLEET_CHAOS_BLOCKS = 41
FLEET_CHAOS_TIER = 16 << 20
FLEET_CHAOS_SEED = 7
# engine_sharded: tensor-parallel engines on one card, every group naming
# it tp times; (a) at SHARDED_TP, (b) at SHARDED_ULYSSES_TP with the
# Ulysses route on each full prefill chunk and a GQA variant whose KV heads
# are below tp (the replicated-KV fallback); the GQA variant, the MoE model
# and the fleet serve the first SHARDED_SHORT requests of engine_trace
SHARDED_TP = 2
SHARDED_ULYSSES_TP = 4
SHARDED_GQA_KV_HEADS = 2
SHARDED_SHORT = 16
# moe: benchmarks/kernel_bench.py MODEL_SIZES["moe"], the repo's MoE model:
# the train-step flagship's dims with every 2nd MLP an 8-expert top-2
# mixture at capacity factor 1.25, rope and bf16 as suite_model /
# suite_moe build it, full width and depth, weights from seed 0
MOE_DIMS = dict(TRAIN_DIMS, moe_every=2, moe_num_experts=8, moe_top_k=2,
                moe_capacity_factor=1.25)
# the load-balancing loss's weight in the train loss (the coefficient
# transformer_apply_with_aux's docstring names)
MOE_AUX_COEF = 1e-2
# (a) moe_apply on the card in bf16 against the same call on the CPU in
# f32, both routed by the card's router probabilities (routed_apply), so
# that both take the same experts where a near-tie could go either way.
# bf16 rounds x, the expert weights, the hidden activations and the
# outputs (2^-9 relative each) and sums the 1,024- and 4,096-term
# products in another order: max |card - CPU| / max |CPU| of a few 2^-9.
# The router's probabilities are f32 on both (only the summation order
# differs), and the aux is computed from them
MOE_OP_RTOL = 2e-2
MOE_PROBS_ATOL = 1e-5
# scatter against einsum dispatch on the card: the expert buffers are the
# same bits (a 0/1 product adds one nonzero term), so are the experts'
# outputs; the combine rounds each gated output to bf16 before summing
# the choices (scatter) or sums the products in f32 and rounds once
# (einsum): a bf16 ulp or two of the largest output
MOE_DISPATCH_RTOL = 1e-2
# routing near-ties.  Two bf16 computations of one model (flash against
# reference attention, the cached or paged steps against the dense
# forward) differ in their router logits by round-off carried from the
# attention and the hidden states (~1e-3, 1e-2 at most); a token whose gap
# between neighbouring ranks of its router log-probabilities (at the
# top-k boundary, or among the top k + 1 where the capacity can drop) is
# under this margin may take another expert in one of them, which moves
# that token's own output by a whole expert's contribution.  Such rows
# are counted and excused from the elementwise limits; a routing
# difference at a larger gap fails the run
MOE_ROUTE_MARGIN = 0.05
# (a) forwards under torch.profiler, device time by kernel a call
MOE_PROFILED_CALLS = 5


# train_sharded: the train-step flagship and the MoE model over a
# dp=2 x tp=2 mesh that names the card four times.  A unit holds a row of
# the batch and half the heads: the flash kernels run at this shape
SHARDED_MESH = dict(dp=2, tp=2)
SHARDED_UNIT_SHAPE = (TRAIN_BATCH // SHARDED_MESH["dp"],
                      TRAIN_DIMS["n_heads"] // SHARDED_MESH["tp"], TRAIN_SEQ,
                      TRAIN_DIMS["d_model"] // TRAIN_DIMS["n_heads"])
# the sharded run's losses against the single-device captured run's,
# absolute.  Step 1 precedes any update: the sharded forward rounds each
# unit's bf16 partial product of wo and w_out before the psum adds them
# (one device rounds the whole sum once) and adds the vocabulary pieces'
# exponentials in another order (first card run: 8.297e-5 apart, dense;
# 9.441e-5, MoE).  Then the gradients differ by a few bf16 ulps (step 1:
# 2.804e-2 of max, cosine 0.999759), Adam's normalised steps turn that
# into whole steps of lr on small gradients, and on this fixed batch,
# whose loss falls from 10.9 to 7.8 in ten steps, the two runs part by
# up to 0.1383 (dense, step 10) and 0.1445 (MoE) in the first card run;
# the drift limit allows 1.8x that.  The sharded run's eager and
# captured forms (two AdamW forms on one program) are held to each other
# at CAPTURE_DRIFT_LOSS_ATOL, as the single-device pair is
SHARDED_FIRST_LOSS_ATOL = 1e-3
SHARDED_DRIFT_LOSS_ATOL = 0.25
# (d) moe_apply over dp=1 x ep=2 x tp=2 against the unsharded op on the
# card, bf16, the same router product on the same gathered tokens, so the
# same routing: the output and gradients differ only where the experts'
# batched products (4 experts a unit, 8 unsharded) and the gradient sums
# run in another order, about a bf16 ulp of the largest value
SHARDED_MOE_RTOL = MOE_DISPATCH_RTOL


# long_context: the train-step flagship (TRAIN_DIMS, rope, bf16, full
# width and depth) at long sequences on meshes that name the card n
# times: (a) the contiguous hybrid ring over sp=4 at 1 x 16,384 tokens,
# (b) the zigzag ring over dp=2 x tp=2 x sp=2 (fsdp rules) at 2 x 8,192,
# (c) Ulysses over sp=4 at 1 x 16,384, (d) the 1F1B schedule over pp=2 x
# sp=2 with the ring in-stage, 4 microbatches of 1 x 8,192.  Each shard's
# diagonal block runs the flash forward at (1, 8, 4096, 128): row 1c of
# PERF.md's kernel table, timed here
LC_SEQ = 16384
LC_SP = 4
LC_ZIGZAG_MESH = dict(dp=2, tp=2, sp=2)
LC_ZIGZAG_SHAPE = (2, 8192)
LC_PP, LC_PP_SP, LC_PP_MICRO = 2, 2, 4
LC_PP_SHAPE = (4, 8192)
# the ring (eager and captured), zigzag and Ulysses runs, each held to
# as many single-device steps (LC_DRIFT_*), as the train phase; five
# since distributed (e) and (f) joined the script (ten before, where the
# limits below were first read)
LC_DRIFT_STEPS = 5
LC_STEPS = 3  # 1F1B
LC_DIAG_SHAPE = (1, TRAIN_DIMS["n_heads"], LC_SEQ // LC_SP,
                 TRAIN_DIMS["d_model"] // TRAIN_DIMS["n_heads"])
LC_ULYSSES_SHAPE = (1, TRAIN_DIMS["n_heads"] // LC_SP, LC_SEQ,
                    LC_DIAG_SHAPE[3])
# the sequence-parallel logits against the single-device flash forward
# of the same tokens, max |diff| over the logits (max |logit| ~5.8): the
# ring's full blocks round their scores to bf16 before the softmax (the
# einsum partial, as in JAX) where the kernel keeps them f32.  First card
# run: 0.0625 for the ring (a) and the zigzag ring (b), 0.0 for Ulysses
# (c); the controls 1.836 (a ring applying RoPE at offset 0 on every
# shard) and 6.203 (a zigzag ring whose diagonal blocks drop their causal
# mask), which the limit refuses
LC_LOGITS_ATOL = 0.3
# ten eager ring steps against ten single-device steps (the trajectory
# arithmetic of hold_drift); the zigzag ring's and Ulysses' ten steps
# against ten single-device steps at their own shapes likewise.  The
# ring's first card run: step 1's loss 5.054e-5
# apart, every loss within 5.802e-3, the parameters' |diff| 5.733e-2 of
# the single-device run's whole update; the RoPE-at-offset-0 ring's ten
# steps 1.116e-4, 0.1504 and 1.084, refused by the loss and update
# limits.  Step 1's loss cannot see that control (random weights attend
# nearly uniformly at step 1): its limit is SHARDED_FIRST_LOSS_ATOL's,
# for the bf16 round-off between two programs
LC_FIRST_LOSS_ATOL = 1e-3
LC_DRIFT_LOSS_ATOL = 0.05
LC_DRIFT_UPDATE_RTOL = 0.25
# (b) runs over dp=2 x tp=2 as well, whose psums of bf16 partial
# products and split vocabulary part a run from one device's as in
# train_sharded (SHARDED_DRIFT_LOSS_ATOL): its ten steps' losses came
# 6.689e-2 apart in the first card run (update 0.1507, step 1 1.173e-4),
# over LC_DRIFT_LOSS_ATOL, while the same program at f32 on the CPU
# follows one device's losses to 1e-6 (tests/test_torch_longcontext.py).
# Its loss is held at train_sharded's limit, its update and step 1 at
# the ring's.  The control, the zigzag ring with RoPE at offset 0: step 1
# 2.106e-3, losses 6.172e-2 apart, update 0.9884, refused by step 1's
# and the update's limits; no loss limit above the shipped 6.689e-2 could
# see it.  Ulysses' ten steps (first card run): step 1 equal, losses
# 6.056e-4 apart, update 3.137e-2
LC_ZIGZAG_DRIFT_LOSS_ATOL = SHARDED_DRIFT_LOSS_ATOL
# a 1F1B step against autograd through transformer_apply_ring on a
# pp-free mesh, the same tokens: loss (absolute) and every gradient (max
# |diff| / max |ref|; cosine).  First card run: the loss equal (0.0),
# gradients 9.498e-3 of max, cosine 0.99996 (per-microbatch products
# round otherwise than whole-batch ones); a 1F1B that forgets one
# microbatch's cotangent 0.9961 of max, cosine 0.8186, refused by the
# gradient limits (its loss is unchanged by construction)
LC_1F1B_LOSS_ATOL = 1e-4
LC_1F1B_GRAD_RTOL = 0.05

# distributed: train_distributed_torch.py's full-width config (BASELINE
# config 5) over torch.distributed.  DDP_WORLD gloo ranks on cuda:0, each
# its half of the global batch, against one process over the whole batch;
# every rank's process killed past DDP_RANK_TIMEOUT_S.
DDP_WORLD = 2
# the attention shape (batch, heads, seq, head_dim) of the one-process
# step over the global batch; each rank's is its batch over DDP_WORLD.
# distributed_phase holds the script's config to it, and dense_cases
# holds the kernels to their plain versions at both
DDP_SHAPE = (32, 8, 256, 64)
DDP_RANK_SHAPE = (DDP_SHAPE[0] // DDP_WORLD, *DDP_SHAPE[1:])
# (a)'s and (d)'s steps: five since (e) and (f) joined the ranks'
# processes (ten before)
DDP_STEPS = 5
DDP_RANK_TIMEOUT_S = 480
DDP_NCCL_STEPS = 3
DDP_DISAGG_REQUESTS = 16
# step 1's gradients (after the all-reduce) against one process's over
# the global batch, max |diff| / max |ref| per tensor: the halves' bf16
# weight-gradient products round otherwise than the whole batch's.
# First card run 4.545e-3; the control, the gradients summed and not
# divided by the world size, 1.007
DDP_GRAD_RTOL = 0.1
# the ten losses and the parameters over the update against one
# process's ten steps, at the captured step's bf16 drift limits.  First
# card run: step 1 9.537e-7, losses 9.975e-4, update 2.565e-2.  The
# undivided control passes them (losses 2.447e-3, update 2.802e-2: Adam
# normalises a doubled gradient away), so the gradient check is the one
# that must refuse it; no trajectory limit above the shipped reading
# could
DDP_FIRST_LOSS_ATOL = 1e-3
DDP_DRIFT_LOSS_ATOL = TRAIN_LOSS_ATOL
DDP_DRIFT_UPDATE_RTOL = TRAIN_GRAD_RTOL
# distributed (d): train_distributed_torch.py --tp DDP_TP as DDP_WORLD gloo
# ranks on cuda:0, one mesh of the ranks (dp=1 x tp=2, as JAX's example
# over two one-chip processes): each rank's unit is the whole global batch
# on n_heads / tp heads, the attention shape DDP_TP_SHAPE
DDP_TP = 2
DDP_TP_SHAPE = (DDP_SHAPE[0], DDP_SHAPE[1] // DDP_TP, *DDP_SHAPE[2:])
# distributed (e) and (f), in the same rank processes after (d), each
# DDP_SP_STEPS eager steps over a mesh of the two ranks, held to the
# one-process mesh over [cuda:0] * 2 (equal to the bit) and to one
# device: (e) the train-step flagship (DDP_SP_LAYERS of its layers) at 1
# x LC_SEQ tokens over dp=1 x tp=1 x sp=DDP_SP, the zigzag hybrid ring (each rank's diagonal
# quadrants at LC_DIAG_SHAPE, the flash forward) and then Ulysses (a
# member attends the whole sequence on n_heads / sp heads,
# DDP_ULYSSES_SHAPE, the three kernels), at the long-context limits
# (LC_FIRST_LOSS_ATOL, LC_DRIFT_*); (f) the MoE model (MOE_DIMS) at
# TRAIN_BATCH x TRAIN_SEQ over dp=DDP_WORLD with the experts split over
# dp, loss CE + MOE_AUX_COEF x aux, at the sharded limits
# (SHARDED_FIRST_LOSS_ATOL, SHARDED_DRIFT_LOSS_ATOL)
DDP_SP = 2
DDP_SP_STEPS = 3
# (e)'s depth: half the flagship's layers at its full width.  Over gloo
# through the host a step is transport-bound (2,292,387,911 bytes a
# zigzag rank at 8 layers: the replicated tree's f32 gradients and the
# ring's K/V and dK/dV, 5.6-8.2 s a step on one card's host), and the
# whole script must stay well inside its limit on a slow host
DDP_SP_LAYERS = TRAIN_DIMS["n_layers"] // 2
DDP_ULYSSES_SHAPE = (1, TRAIN_DIMS["n_heads"] // DDP_SP, LC_SEQ,
                     LC_DIAG_SHAPE[3])
DDP_MOE_RANK_SHAPE = (TRAIN_BATCH // DDP_WORLD, MOE_DIMS["n_heads"],
                      TRAIN_SEQ, MOE_DIMS["d_model"] // MOE_DIMS["n_heads"])
# distributed (g), in the same rank processes after (f): the train-step
# flagship (TRAIN_DIMS: full width and depth, bf16) under
# transformer_train_1f1b over pp=DDP_WORLD ranks, each rank a stage of
# n_layers / pp layers, TRAIN_BATCH microbatches of one row (a
# microbatch's attention is (1, 8, TRAIN_SEQ, 128), DDP_MOE_RANK_SHAPE,
# held to the plain versions and timed as "distributed_moe_rank"),
# DDP_PP_STEPS eager AdamW steps held to the one-process pipeline over
# [cuda:0] * DDP_WORLD (equal to the bit) and to one device (the
# sharded first-loss limit and the train step's drift limits)
DDP_PP_MICRO = TRAIN_BATCH
DDP_PP_STEPS = 4
# (h): the gang's CIFAR ResNet (ResNetConfig()) through
# data_parallel_apply over dp=DDP_WORLD ranks, RESNET_BATCH images,
# DDP_RESNET_STEPS eager steps with deterministic convolutions, held to
# the one-process dp=DDP_WORLD mesh to the bit
DDP_RESNET_STEPS = 4
# discovery: the card's memory by torch (cudaDeviceProp.totalGlobalMem)
# against nvidia-smi's memory.total (NVML), in MiB: 480.0 MiB apart on
# an H100 80GB HBM3 (81,559 MiB by NVML), the CUDA driver's reserve; a card
# of another size lies thousands of MiB away
DISCOVERY_MEMORY_MIB = 1024

# ---- placement: the port's control plane placing pods on the card ----
PLACEMENT_NODE = "card-node"
PLACEMENT_MEM_FRACTION = 0.4  # each pod's gpu_mem, of the card
PLACEMENT_FITS = 0.3  # of the card: allocates under the 0.4 cap
PLACEMENT_REFUSED = 0.6  # of the card: the hook refuses it
PLACEMENT_SECONDS = 4.0  # captured MNIST steps in each pod, at once
PLACEMENT_CHILD_TIMEOUT_S = 180
# deploy/cuda/examples/mnist-fractional.yaml, the pod that binds in B's
# place: its name, labels and container command, kept here so that the
# script needs no PyYAML (tests/test_torch_deploy.py holds them equal to
# the file)
MNIST_MANIFEST = "deploy/cuda/examples/mnist-fractional.yaml"
MNIST_MANIFEST_POD = "mnist1"
MNIST_MANIFEST_CONTAINER = "train"
MNIST_MANIFEST_LABELS = {
    "sharedgpu/gpu_request": "0.5", "sharedgpu/gpu_limit": "1.0",
    "sharedgpu/gpu_mem": "8589934592", "sharedgpu/priority": "100"}
MNIST_MANIFEST_COMMAND = ("python", "train_mnist_torch.py")
MNIST_MANIFEST_STEPS = 100  # captured steps of about 1 ms at batch 256
# mem_get_info's total against the pod's gpu_mem, over the card's memory:
# the hook caps at TPUSHARE_MEM_FRACTION, printed to 4 decimals, of
# cuMemGetInfo's total, so the cap may be off by about 4 MiB of 80 GB
PLACEMENT_CAP_TOLERANCE = 5e-5

# ---- interposer: libcudahook.so.1 under the unmodified workloads ----
# two pods, each behind its own tokend: hook/full at limit 1.0 (the
# bit-equality, charge and overhead runs) at tokend's default 10 s
# window, hook/half at limit and memory cap INTERPOSER_FRACTION (the
# share and the memory checks) at a 1 s window, so that its share
# settles within the greedy loop's warm-up.  (At a 1 s window a pod busy
# for most of a second nears limit 1.0 and waits at the broker.)
INTERPOSER_HALF_WINDOW_MS = 1000
INTERPOSER_FRACTION = 0.5
INTERPOSER_GREEDY_S = 3.0  # the greedy captured loop's measured window
INTERPOSER_WARMUP_S = 1.5  # its warm-up: the limited pod's share settles
INTERPOSER_CHILD_TIMEOUT_S = 300
# (c): the broker's charge for captured steps 2-10 over their CUDA-event
# ms; the control it must refuse is the host's dispatch time of the same
# steps (a graph launch returns in microseconds)
INTERPOSER_CHARGE_RANGE = (0.8, 1.5)
# (d): the limited pod's greedy steps/s over the ungated loop's; the
# control it must refuse is the ungated loop itself (1.0)
INTERPOSER_SHARE_RANGE = (0.35, 0.65)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # hold the device (~25 ms) while the host queues every timed call, so
    # the events read device time and not the host's pace of issuing (an
    # autograd call's host work can exceed its kernels' time)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(s: int, causal: bool, window) -> int:
    """Query-key pairs the mask keeps per head (what the kernel computes)."""
    if window is not None:
        return sum(min(i + 1, window) for i in range(s))
    return s * (s + 1) // 2 if causal else s * s


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound(shape, h_kv, dtype_name, causal, window, pairs=None):
    """(bound_ms, bound_by): bytes of q, k, v, out, lse once each over
    the memory rate vs the two products' operations over the peak.
    ``pairs``: visible pairs per head, when a block mask sets them."""
    b, h, s, d = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * b * h * s * d + 2 * b * h_kv * s * d) * elt + b * h * s * 4
    if pairs is None:
        pairs = visible_pairs(s, causal, window)
    flops = 4 * d * pairs * b * h
    return _bound(nbytes, flops, dtype_name)


# FLOPs per visible query-key pair and unit of head_dim: the forward's two
# products, dK/dV's four, dQ's three
PAIR_FLOPS = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}


def achieved(name, shape, ms, library_ms, pairs):
    """A timing's achieved TFLOP/s (the visible pairs' operations over the
    kernel time) and its ratio to the library call, for the timing lines."""
    b, h, s, d = shape
    kernel = name.removesuffix("_block_sparse")
    tflops = PAIR_FLOPS[kernel] * d * pairs * b * h / (ms * 1e-3) / 1e12
    return tflops, ms / library_ms


def flash_bwd_bound(kernel, shape, h_kv, dtype_name, causal, window,
                    pairs=None):
    """(bound_ms, bound_by) of one backward kernel.  dkv reads q, k, v,
    dO, lse, delta and writes dk, dv; it does four products per visible
    pair (S, dP, p^T.dO, ds^T.q: 8 d FLOPs).  dq reads the same and
    writes dq; it does three (S, dP, ds.k: 6 d FLOPs).  ``pairs``:
    visible pairs per head, when a block mask sets them."""
    b, h, s, d = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    q_elems, kv_elems = b * h * s * d, b * h_kv * s * d
    rows = 2 * b * h * s * 4  # lse and delta, f32
    if pairs is None:
        pairs = visible_pairs(s, causal, window)
    pairs *= b * h
    if kernel == "dkv":
        nbytes = (2 * q_elems + 4 * kv_elems) * elt + rows
        flops = 8 * d * pairs
    else:
        nbytes = (3 * q_elems + 2 * kv_elems) * elt + rows
        flops = 6 * d * pairs
    return _bound(nbytes, flops, dtype_name)


def train_flops_per_token(dims, seq):
    """benchmarks/kernel_bench.py:_train_flops_per_token: per layer
    forward 2*(4 d^2) attention projections + 2*(2 d ff) MLP + 2*2*(seq/2)*d
    causal attention, plus the lm_head's 2 d vocab; a train step is 3x the
    forward.  An MoE layer (every moe_every-th) credits top_k MLPs: a
    routed token runs top_k experts of the MLP's shape; the router and the
    dispatch are not credited."""
    d, ff, vocab = dims["d_model"], dims["d_ff"], dims["vocab_size"]
    every = dims.get("moe_every")
    forward = 2 * d * vocab
    for i in range(dims["n_layers"]):
        k = (dims["moe_top_k"] if every is not None and i % every == every - 1
             else 1)
        forward += 2 * 4 * d * d + 2 * seq * d + 2 * 2 * d * ff * k
    return 3 * forward


def kernel_resources(log: str):
    """(kernel, registers, spill bytes) per kernel from ptxas -v output."""
    import re

    rows, name, spill = [], None, 0
    for line in log.splitlines():
        # the mangled name puts the identifier's length just before it;
        # the masked instantiations' bool template argument reads Lb1E
        entry = re.search(r"Compiling entry function '\w*\d(flash_[a-z0-9_]+?_kernel)ILi(\d+)E(Lb1E)?", line)
        if entry:
            masked = ", masked" if entry.group(3) else ""
            name, spill = f"{entry.group(1)}<{entry.group(2)}{masked}>", 0
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and name:
            spill = int(spills.group(1)) + int(spills.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            rows.append((name, int(used.group(1)), spill))
            name = None
    return rows


SASS_OPS = ("HGMMA", "WARPGROUP.DEPBAR", "UTMALDG", "UTMASTG")
# the bf16 kernels, which run on wgmma and TMA
SASS_KERNELS = ("flash_fwd_bf16_kernel", "flash_bwd_dkv_bf16_kernel",
                "flash_bwd_dq_bf16_kernel")
# the f32 forward, dK/dV and dQ kernels run 3xTF32 products on mma.sync
# (HMMA) fed by cp.async (LDGSTS)
F32_SASS_OPS = ("HMMA", "LDGSTS")
F32_SASS_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_dkv_f32_kernel",
                    "flash_bwd_dq_f32_kernel")


def sass_counts(sass: str):
    """{"<kernel><D>" or "<kernel><D, masked>": {op: count}} of the bf16
    kernels' instantiations in cuobjdump's SASS of a library, wgmma
    (HGMMA), its serialising waits (WARPGROUP.DEPBAR), TMA loads and
    stores; and of the f32 kernels', mma.sync (HMMA) and cp.async
    (LDGSTS)."""
    import re

    ops_of = {**dict.fromkeys(SASS_KERNELS, SASS_OPS),
              **dict.fromkeys(F32_SASS_KERNELS, F32_SASS_OPS)}
    kernels = "|".join(ops_of)
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(rf"\d({kernels})ILi(\d+)ELb(\d)", line)
            name = None
            if found:
                masked = ", masked" if found.group(3) == "1" else ""
                name = f"{found.group(1)}<{found.group(2)}{masked}>"
                counts[name] = dict.fromkeys(ops_of[found.group(1)], 0)
            continue
        if name:
            for op in counts[name]:
                if op in line:
                    counts[name][op] += 1
    return counts


def library_sass(library) -> str:
    """cuobjdump -sass of a built library (cuobjdump beside nvcc)."""
    from pathlib import Path

    from kubeshare_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(library)], check=True,
                          capture_output=True, text=True, timeout=300).stdout


def reset_counts():
    from kubeshare_tpu_torch.ops import attention as A

    A.flash_forward.launches = 0
    A.flash_backward.launches_dkv = 0
    A.flash_backward.launches_dq = 0
    A.block_sparse_forward.launches = 0
    A.block_sparse_backward.launches_dkv = 0
    A.block_sparse_backward.launches_dq = 0


def read_counts():
    from kubeshare_tpu_torch.ops import attention as A

    return {"flash_fwd": A.flash_forward.launches,
            "flash_bwd_dkv": A.flash_backward.launches_dkv,
            "flash_bwd_dq": A.flash_backward.launches_dq,
            "flash_fwd_block_sparse": A.block_sparse_forward.launches,
            "flash_bwd_dkv_block_sparse": A.block_sparse_backward.launches_dkv,
            "flash_bwd_dq_block_sparse": A.block_sparse_backward.launches_dq}


def only(*names):
    """The counts of a path that launched each named kernel once and no
    other kernel."""
    return {name: int(name in names) for name in read_counts()}


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| in f32."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def check_out(torch, label, out, ref_out):
    """A forward's out against its plain version's, element by element
    (TOLERANCES); returns the max abs error."""
    tol = TOLERANCES[str(out.dtype).removeprefix("torch.")]
    out_err = (out.float() - ref_out.float()).abs()
    out_ok = bool((out_err <= tol["out_atol"]
                   + tol["out_rtol"] * ref_out.float().abs()).all())
    err = float(out_err.max())
    check(out_ok, f"{label}: out disagrees with the plain version "
                  f"(max abs err {err})")
    return err


def check_forward(torch, label, out, lse, ref_out, ref_lse):
    """A forward kernel's (out, lse) against its plain version's on the
    same inputs; returns out's max abs error."""
    tol = TOLERANCES[str(out.dtype).removeprefix("torch.")]
    finite = torch.isfinite(ref_lse)
    check(bool((torch.isfinite(lse) == finite).all()),
          f"{label}: lse -inf rows differ")
    lse_err = float((lse[finite] - ref_lse[finite]).abs().max())
    err = float((out.float() - ref_out.float()).abs().max())
    print(f"{label}: out_max_abs_err={err:.3e} lse_max_abs_err={lse_err:.3e}")
    check_out(torch, label, out, ref_out)
    check(lse_err <= tol["lse_atol"],
          f"{label}: lse disagrees with the plain version (max abs err "
          f"{lse_err})")
    return err


def check_grads(torch, label, grads, ref):
    """(dq, dk, dv) from the backward kernels against the plain
    version's; returns the worst (relative, absolute) error of the dK/dV
    and the dQ kernel."""
    names = ("dq", "dk", "dv")
    errs = {n: rel_err(g, r) for n, g, r in zip(names, grads, ref)}
    abs_errs = {n: float((g.float() - r.float()).abs().max())
                for n, g, r in zip(names, grads, ref)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    tol = BWD_TOLERANCES[str(grads[0].dtype).removeprefix("torch.")]
    print(f"{label}: " + " ".join(
        f"{n}_rel_err={e:.3e}" for n, e in errs.items()) + f" (tol {tol})")
    check(finite, f"{label}: non-finite gradients from the backward kernels")
    for n, e in errs.items():
        check(e <= tol, f"{label}: {n} disagrees with the plain version "
                        f"(max abs err / max |ref| = {e})")
    return {"dkv": (max(errs["dk"], errs["dv"]),
                    max(abs_errs["dk"], abs_errs["dv"])),
            "dq": (errs["dq"], abs_errs["dq"])}


def check_backward(torch, name, q, k, v, out, lse, causal, window, gen):
    """The dK/dV and dQ kernels against flash_backward_reference on the
    same inputs (the forward kernel's out and lse, a random dO); returns
    the worst relative error of each kernel."""
    from kubeshare_tpu_torch.ops.attention import flash_backward, flash_backward_reference

    dout = torch.randn(q.shape, generator=gen, device=q.device, dtype=q.dtype)
    grads = flash_backward(q, k, v, out, lse, dout, causal, window)
    torch.cuda.synchronize()
    ref = flash_backward_reference(q, k, v, out, lse, dout, causal, window)
    return check_grads(torch, f"kernel flash_bwd {name}", grads, ref)


def check_f32_writes(torch, name, q, k, v, causal, window=None,
                     mask=None, blocks=None):
    """The f32 kernels' writes, for a memory fault that no comparison of
    values shows: each of the forward, dK/dV and dQ (masked when ``mask``
    is given) is launched by its wrapper, then once more through its C
    launcher with every output placed between GUARD_FLOATS sentinel floats
    on each side.  Fails unless the second launch wrote its outputs to the
    bit of the first (so every element of them) and nothing of the
    guards."""
    from kubeshare_tpu_torch.ops import _build
    from kubeshare_tpu_torch.ops import attention as A

    gen = torch.Generator(device=q.device).manual_seed(77)
    dout = torch.randn(q.shape, generator=gen, device=q.device,
                       dtype=q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = A._launch_args(q, k, causal, window, stream)
    fwd, bwd = _build.load("flash_fwd"), _build.load("flash_bwd")
    if mask is None:
        out, lse = A.flash_forward(q, k, v, causal, window)
        delta = A._backward_delta(out, dout)
        dk, dv = A._flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal,
                                       window)
        dq = A._flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, window)
        launchers = (fwd.flash_fwd_launch, bwd.flash_bwd_dkv_launch,
                     bwd.flash_bwd_dq_launch)
    else:
        args = (mask, causal, *blocks)
        out, lse = A.block_sparse_forward(q, k, v, *args)
        delta = A._backward_delta(out, dout)
        dk, dv = A._block_sparse_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                              *args)
        dq = A._block_sparse_bwd_dq_cuda(q, k, v, dout, lse, delta, *args)
        bits, mask_args = A._mask_args(q, mask, *blocks)  # held to the end
        tail = (*mask_args, *tail)
        launchers = (fwd.flash_fwd_block_sparse_launch,
                     bwd.flash_bwd_dkv_block_sparse_launch,
                     bwd.flash_bwd_dq_block_sparse_launch)
    for launcher, inputs, wrote in (
            (launchers[0], (q, k, v), (out, lse)),
            (launchers[1], (q, k, v, dout, lse, delta), (dk, dv)),
            (launchers[2], (q, k, v, dout, lse, delta), (dq,))):
        bufs = [torch.full((t.numel() + 2 * GUARD_FLOATS,), GUARD_SENTINEL,
                           device=q.device) for t in wrote]
        views = [buf[GUARD_FLOATS:GUARD_FLOATS + t.numel()].view(t.shape)
                 for buf, t in zip(bufs, wrote)]
        err = launcher(*(t.data_ptr() for t in (*inputs, *views)), *tail)
        torch.cuda.synchronize()
        label = f"kernel f32 writes {name}: {launcher.__name__}"
        check(err == 0, f"{label} failed: CUDA error {err}")
        for buf, view, first in zip(bufs, views, wrote):
            guards = torch.cat((buf[:GUARD_FLOATS],
                                buf[GUARD_FLOATS + view.numel():]))
            check(bool((guards == GUARD_SENTINEL).all()),
                  f"{label} wrote outside its output {tuple(view.shape)}")
            check(torch.equal(view, first),
                  f"{label}: an output differs from the first launch's "
                  f"(or an element was left unwritten)")
    print(f"kernel f32 writes {name}: forward, dK/dV and dQ wrote every "
          f"element of their outputs, to the bit of their first launch, "
          f"and none of {GUARD_FLOATS} guard floats on either side")


def time_shape(torch, shape, gen, dtype_name="bfloat16"):
    """Times of the forward and both backward kernels at one causal MHA
    shape, beside the plain versions, the library calls and the bounds
    (at f32: the f32 instantiations, SDPA with TF32 off, and the bound at
    the 3xTF32 rate)."""
    import torch.nn.functional as F
    from kubeshare_tpu_torch.ops import attention as A

    b, h, s, d = shape
    dtype = getattr(torch, dtype_name)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda",
                                 dtype=dtype) for _ in range(4))
    out, lse = A.flash_forward(q, k, v, True)
    delta = A._backward_delta(out, dout)
    fwd_ms = time_ms(lambda: A.flash_forward(q, k, v, True))
    dkv_ms = time_ms(lambda: A._flash_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                                   True, None))
    dq_ms = time_ms(lambda: A._flash_bwd_dq_cuda(q, k, v, dout, lse, delta,
                                                 True, None))
    fwd_plain_ms = time_ms(lambda: A.flash_forward_reference(q, k, v, True))
    # the plain backward computes dq, dk and dv in one call
    bwd_plain_ms = time_ms(lambda: A.flash_backward_reference(
        q, k, v, out, lse, dout, True, None))
    # yardsticks only: the port never calls them.  The library backward
    # is one autograd.grad of SDPA's output (its forward excluded, graph
    # kept): it computes what the two backward kernels compute together.
    fwd_library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True))
    rows = {}
    for name, ms, plain_ms, library_ms, bound in (
        ("flash_fwd", fwd_ms, fwd_plain_ms, fwd_library_ms,
         flash_bound(shape, h, dtype_name, True, None)),
        ("flash_bwd_dkv", dkv_ms, bwd_plain_ms, bwd_library_ms,
         flash_bwd_bound("dkv", shape, h, dtype_name, True, None)),
        ("flash_bwd_dq", dq_ms, bwd_plain_ms, bwd_library_ms,
         flash_bwd_bound("dq", shape, h, dtype_name, True, None)),
    ):
        tflops, ratio = achieved(name, shape, ms, library_ms,
                                  visible_pairs(s, True, None))
        rows[name] = {"shape": list(shape), "dtype": dtype_name, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound[0], "bound_by": bound[1],
                      "tflops": tflops, "library_ratio": ratio}
        print(f"kernel {name} timing at {shape} {dtype_name} causal: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}); {tflops:.1f} TFLOP/s, {ratio:.3f}x library")
    return rows


def dense_cases(torch):
    """(name, (b, h, s, d), h_kv, dtype, causal, window) of the kernel
    phase."""
    return [
        ("flagship", (4, 8, 1024, 64), 8, torch.bfloat16, True, None),
        ("prefill_896", (4, 8, PROMPT_LEN, 64), 8, torch.bfloat16, True, None),
        # the speculative path's prefills: ragged across a 128-row tile
        ("prefill_892", (4, 8, SPEC_PROMPT, 64), 8, torch.bfloat16, True,
         None),
        ("gqa_hkv2", (4, 8, 1024, 64), 2, torch.bfloat16, True, None),
        ("window_256", (4, 8, 1024, 64), 8, torch.bfloat16, True, 256),
        ("ragged_333_noncausal", (2, 8, 333, 64), 8, torch.bfloat16, False, None),
        ("d128", (2, 4, 1024, 128), 4, torch.bfloat16, True, None),
        ("f32_ragged_500", (2, 4, 500, 64), 2, torch.float32, True, None),
        ("f32_d128_window", (1, 4, 512, 128), 4, torch.float32, True, 100),
        ("train", (TRAIN_BATCH, 8, TRAIN_SEQ, 128), 8, torch.bfloat16, True, None),
        # the MoE model's serving prefill: head_dim 128 at s = 896
        ("moe_prefill_896_d128", (N_REQUESTS, 8, PROMPT_LEN, 128), 8,
         torch.bfloat16, True, None),
        # train_sharded's unit: the train shape's rows over dp, its heads
        # over tp
        ("train_sharded_unit", SHARDED_UNIT_SHAPE, SHARDED_UNIT_SHAPE[1],
         torch.bfloat16, True, None),
        # the edges of the bf16 forward's 128-row tiles and TMA boxes:
        # ragged across a tile (TMA's zero fill) with GQA, less than one
        # tile, and a window edge that no tile boundary meets
        ("gqa_ragged_1000_d128", (2, 8, 1000, 128), 2, torch.bfloat16, True, None),
        ("noncausal_77", (2, 4, 77, 64), 4, torch.bfloat16, False, None),
        ("window_100_d128", (2, 4, 1024, 128), 4, torch.bfloat16, True, 100),
        # the edges of the bf16 backward's tiles: a window narrower than a
        # Q step, s ragged across a 64-row step and a 128-row tile, a
        # group of 4
        ("gqa4_ragged_200_window48", (1, 8, 200, 64), 2, torch.bfloat16,
         True, 48),
        # the f32 path's shapes (the f32 phase's forward, prefill and train
        # step; the kernels' truncation grows with a sweep's length) and
        # the edges of the f32 tiles at d = 128 with GQA
        ("f32_flagship", (4, 8, 1024, 64), 8, torch.float32, True, None),
        ("f32_prefill_896", (4, 8, PROMPT_LEN, 64), 8, torch.float32, True,
         None),
        ("f32_train", (TRAIN_BATCH, 8, TRAIN_SEQ, 128), 8, torch.float32,
         True, None),
        ("f32_gqa_ragged_1000_d128", (2, 8, 1000, 128), 2, torch.float32,
         True, None),
        # non-causal at the train shape: every row of dq sums all s keys
        # (causal, the rows with the longest sums have the smallest dq),
        # where dQ without its per-tile partials drifts past the limit
        # (flash_ablations.py dq_no_partials)
        ("f32_noncausal_2048_d128", (TRAIN_BATCH, 8, TRAIN_SEQ, 128), 8,
         torch.float32, False, None),
        # the long_context phase's Ulysses member: the whole 16,384-token
        # sweep on n_heads / sp heads, the longest sweep of any path
        ("ulysses_member", LC_ULYSSES_SHAPE, LC_ULYSSES_SHAPE[1],
         torch.bfloat16, True, None),
        # the distributed phase's shapes: a DDP rank's half of the global
        # batch, and the one process over the whole batch it is held to
        ("ddp_rank", DDP_RANK_SHAPE, DDP_RANK_SHAPE[1], torch.bfloat16,
         True, None),
        ("ddp_single", DDP_SHAPE, DDP_SHAPE[1], torch.bfloat16, True, None),
        # distributed (d): a tp rank's unit, the global batch on half the
        # heads
        ("distributed_tp", DDP_TP_SHAPE, DDP_TP_SHAPE[1], torch.bfloat16,
         True, None),
        # distributed (e): a Ulysses member over the two ranks, the whole
        # 16,384-token sweep on half the heads; (f): an MoE dp rank's row
        ("distributed_sp_ulysses", DDP_ULYSSES_SHAPE, DDP_ULYSSES_SHAPE[1],
         torch.bfloat16, True, None),
        # (f)'s MoE dp rank's row, and (g)'s microbatch on a pp stage
        ("distributed_moe_rank", DDP_MOE_RANK_SHAPE, DDP_MOE_RANK_SHAPE[1],
         torch.bfloat16, True, None),
    ]


def kernel_phase(torch, device):
    """The dense kernels against their plain versions at dense_cases, the
    f32 ones also in guard bands; returns the worst errors and the
    timings."""
    from kubeshare_tpu_torch.ops.attention import flash_forward, flash_forward_reference

    gen = torch.Generator(device=device).manual_seed(1234)
    # worst (relative, absolute) error of each kernel over the shapes; the
    # forward's relative error is not computed (its check is per element)
    worst = {"flash_fwd": [None, 0.0], "flash_bwd_dkv": [0.0, 0.0],
             "flash_bwd_dq": [0.0, 0.0]}
    for name, shape, h_kv, dtype, causal, window in dense_cases(torch):
        b, h, s, d = shape
        q = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        k = torch.randn((b, h_kv, s, d), generator=gen, device=device, dtype=dtype)
        v = torch.randn((b, h_kv, s, d), generator=gen, device=device, dtype=dtype)
        out, lse = flash_forward(q, k, v, causal, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_forward_reference(q, k, v, causal, window)
        err = check_forward(
            torch, f"kernel flash_fwd {name}: shape={shape} h_kv={h_kv} "
            f"{dtype} causal={causal} window={window}",
            out, lse, ref_out, ref_lse)
        worst["flash_fwd"][1] = max(worst["flash_fwd"][1], err)
        bwd = check_backward(torch, name, q, k, v, out, lse, causal, window, gen)
        for kernel, errs in (("flash_bwd_dkv", bwd["dkv"]),
                             ("flash_bwd_dq", bwd["dq"])):
            worst[kernel] = [max(a, b) for a, b in zip(worst[kernel], errs)]
        if dtype == torch.float32:
            check_f32_writes(torch, name, q, k, v, causal, window)
        del q, k, v, out, lse, ref_out, ref_lse

    # times at the serving flagship's attention shape and the training
    # shape, then the f32 instantiations (3xTF32 on mma.sync) at the
    # serving shape, beside SDPA at f32 (TF32 is off
    # for the whole run), and at the end at the training shape,
    # then the MoE model's serving prefill shape and train_sharded's unit
    timings = [time_shape(torch, shape, gen)
               for shape in ((4, 8, 1024, 64), (TRAIN_BATCH, 8, TRAIN_SEQ, 128))]
    timings.append(time_shape(torch, F32_TIMED_SHAPE, gen, "float32"))
    timings.append(time_shape(torch, (N_REQUESTS, 8, PROMPT_LEN, 128), gen))
    timings.append(time_shape(torch, SHARDED_UNIT_SHAPE, gen))
    # the f32 train path's shape (the f32 phase's train-step flagship)
    timings.append(time_shape(torch, (TRAIN_BATCH, 8, TRAIN_SEQ, 128), gen,
                              "float32"))
    # distributed (d)'s: a tp rank's unit over the mesh of ranks; (e)'s
    # Ulysses member, and (f)'s MoE dp rank (the shape of (g)'s microbatch)
    timings.append(time_shape(torch, DDP_TP_SHAPE, gen))
    timings.append(time_shape(torch, DDP_ULYSSES_SHAPE, gen))
    timings.append(time_shape(torch, DDP_MOE_RANK_SHAPE, gen))
    return worst, timings


def doc_mask(torch, lengths, block):
    """Block-diagonal mask of documents of ``lengths`` tokens (multiples
    of ``block``): a block sees the blocks of its own document."""
    doc = torch.repeat_interleave(torch.arange(len(lengths)),
                                  torch.tensor(lengths) // block)
    return (doc[:, None] == doc[None, :]).to(torch.int32)


def random_mask(torch, n, density, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((n, n), generator=gen) < density).to(torch.int32)


def block_sparse_cases(torch):
    """(name, (b, h, s, d), h_kv, dtype, block_q, block_k, mask, causal)"""
    bf16, f32 = torch.bfloat16, torch.float32
    docs = doc_mask(torch, (384, 640, 256, 768), 128)
    i = torch.arange(16)
    prefix_lm = ((i[None, :] <= i[:, None]) | (i[None, :] < 4)).to(torch.int32)
    dead = random_mask(torch, 16, 0.5, 21)
    dead[5] = 0  # queries 320-383 see no key
    return [
        ("doc_causal", (2, 8, 2048, 128), 8, bf16, 128, 128, docs, True),
        ("prefix_lm", (4, 8, 1024, 64), 8, bf16, 64, 64, prefix_lm, False),
        ("dead_rows", (2, 8, 1024, 64), 8, bf16, 64, 64, dead, False),
        ("straddle_b32", (2, 4, 1024, 64), 4, bf16, 32, 32,
         random_mask(torch, 32, 0.6, 22), True),
        ("coarse_default", (2, 8, 2048, 128), 8, bf16, 512, 1024,
         torch.tensor([[1, 0], [1, 0], [0, 1], [1, 1]], dtype=torch.int32),
         True),
        ("gqa_hkv2", (2, 8, 2048, 128), 2, bf16, 128, 128, docs, True),
        ("f32_odd_s1000_b40", (2, 4, 1000, 64), 4, f32, 40, 40,
         random_mask(torch, 25, 0.6, 23), True),
        ("f32_d128_doc", (1, 4, 1024, 128), 4, f32, 128, 128,
         doc_mask(torch, (384, 640), 128), True),
        ("f32_d128_prefix_lm", (2, 8, 1024, 128), 8, f32, 64, 64, prefix_lm,
         False),
        # the f32 dQ's rows with no visible key (lse = -inf) at d = 128
        ("f32_d128_dead_rows", (1, 4, 1024, 128), 4, f32, 64, 64, dead,
         False),
    ]


def time_block_sparse(torch, shape, mask, block, gen):
    """Times of the three masked kernels at one bf16 causal MHA shape and
    mask, beside the plain versions, SDPA with the expanded mask and the
    bounds."""
    import torch.nn.functional as F
    from kubeshare_tpu_torch.ops import attention as A

    b, h, s, d = shape
    q, k, v, dout = (torch.randn(shape, generator=gen, device=mask.device,
                                 dtype=torch.bfloat16) for _ in range(4))
    mask = mask.bool()  # read in place by the kernels: nothing but them timed
    args = (mask, True, block, block)
    out, lse = A.block_sparse_forward(q, k, v, *args)
    delta = A._backward_delta(out, dout)
    fwd_ms = time_ms(lambda: A._block_sparse_forward_cuda(q, k, v, *args))
    dkv_ms = time_ms(lambda: A._block_sparse_bwd_dkv_cuda(
        q, k, v, dout, lse, delta, *args))
    dq_ms = time_ms(lambda: A._block_sparse_bwd_dq_cuda(
        q, k, v, dout, lse, delta, *args))
    fwd_plain_ms = time_ms(lambda: A.block_sparse_forward_reference(
        q, k, v, mask, True, block, block))
    bwd_plain_ms = time_ms(lambda: A.block_sparse_backward_reference(
        q, k, v, out, lse, dout, mask, True, block, block))
    # yardsticks only, never on the port's path: SDPA with the element
    # mask (block mask and causal band) as a boolean attn_mask, and its
    # backward as one autograd.grad with the graph kept
    elem = A._element_mask(mask, block, block, s, True)
    fwd_library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=elem))
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=elem)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True))
    # the bounds count the operations of the mask's visible pairs, but
    # the dense bytes: every row of out and lse is written (zeros where a
    # row sees nothing), dk and dv in full, and every row of q, k, v and
    # dO meets a visible pair in these masks, so sparsity removes
    # operations and no byte of input or output
    pairs = int(elem.sum())
    print(f"kernel block_sparse mask at {shape} blocks {block}: visible "
          f"pairs per head {pairs} = {pairs / (s * s):.4f} of s^2")
    # the whole op as a caller sees it: forward, delta and both backward
    # kernels, beside SDPA's forward and backward with the mask
    path_ms = time_ms(lambda: torch.autograd.grad(A.block_sparse_attention(
        ql, kl, vl, mask, causal=True, block_q=block, block_k=block),
        (ql, kl, vl), dout))
    library_path_ms = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(ql, kl, vl, attn_mask=elem),
        (ql, kl, vl), dout))
    print(f"block_sparse_attention forward + grad at {shape}: "
          f"{path_ms:.4f} ms; SDPA with the mask forward + grad "
          f"{library_path_ms:.4f} ms")
    rows = {}
    for name, ms, plain_ms, library_ms, bound in (
        ("flash_fwd_block_sparse", fwd_ms, fwd_plain_ms, fwd_library_ms,
         flash_bound(shape, h, "bfloat16", True, None, pairs)),
        ("flash_bwd_dkv_block_sparse", dkv_ms, bwd_plain_ms, bwd_library_ms,
         flash_bwd_bound("dkv", shape, h, "bfloat16", True, None, pairs)),
        ("flash_bwd_dq_block_sparse", dq_ms, bwd_plain_ms, bwd_library_ms,
         flash_bwd_bound("dq", shape, h, "bfloat16", True, None, pairs)),
    ):
        tflops, ratio = achieved(name, shape, ms, library_ms, pairs)
        rows[name] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound[0],
                      "bound_by": bound[1], "visible_pairs": pairs,
                      "tflops": tflops, "library_ratio": ratio}
        print(f"kernel {name} timing at {shape} bf16 causal doc mask: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}); {tflops:.1f} TFLOP/s, {ratio:.3f}x library")
    return rows


def block_sparse_phase(torch, device):
    """The masked kernels against their plain versions at every case, the
    f32 ones also in guard bands, block_sparse_attention end to end at
    doc_causal, and the timings."""
    from kubeshare_tpu_torch.ops import attention as A

    gen = torch.Generator(device=device).manual_seed(4321)
    worst = {"flash_fwd_block_sparse": [None, 0.0],
             "flash_bwd_dkv_block_sparse": [0.0, 0.0],
             "flash_bwd_dq_block_sparse": [0.0, 0.0]}
    launches = None
    for (name, shape, h_kv, dtype, bq, bk, mask,
         causal) in block_sparse_cases(torch):
        b, h, s, d = shape
        mask = mask.to(device)
        q = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        k = torch.randn((b, h_kv, s, d), generator=gen, device=device, dtype=dtype)
        v = torch.randn((b, h_kv, s, d), generator=gen, device=device, dtype=dtype)
        dout = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        args = (mask, causal, bq, bk)
        out, lse = A.block_sparse_forward(q, k, v, *args)
        torch.cuda.synchronize()
        ref_out, ref_lse = A.block_sparse_forward_reference(q, k, v, *args)
        err = check_forward(
            torch, f"kernel flash_fwd_block_sparse {name}: shape={shape} "
            f"h_kv={h_kv} {dtype} blocks=({bq}, {bk}) causal={causal} "
            f"mask density={float((mask != 0).float().mean()):.3f}",
            out, lse, ref_out, ref_lse)
        worst["flash_fwd_block_sparse"][1] = max(
            worst["flash_fwd_block_sparse"][1], err)
        grads = A.block_sparse_backward(q, k, v, out, lse, dout, *args)
        torch.cuda.synchronize()
        ref = A.block_sparse_backward_reference(q, k, v, out, lse, dout, *args)
        bwd = check_grads(torch, f"kernel flash_bwd_block_sparse {name}",
                          grads, ref)
        for kernel, errs in (("flash_bwd_dkv_block_sparse", bwd["dkv"]),
                             ("flash_bwd_dq_block_sparse", bwd["dq"])):
            worst[kernel] = [max(a, b) for a, b in zip(worst[kernel], errs)]
        if name.endswith("dead_rows"):
            rows = slice(5 * bq, 6 * bq)
            check(bool((out[:, :, rows] == 0).all())
                  and bool(torch.isneginf(lse[:, :, rows]).all())
                  and bool((grads[0][:, :, rows] == 0).all()),
                  f"{name}: a query row with no visible key has a nonzero "
                  "out or dq, or a finite lse")
            print(f"kernel block_sparse {name}: out and dq of queries "
                  f"{rows.start}-{rows.stop - 1} are 0, their lse -inf, "
                  "every gradient finite")
        if name == "doc_causal":
            launches = block_sparse_path(torch, q, k, v, dout, args,
                                         (ref_out, ref_lse))
        if dtype == torch.float32:
            check_f32_writes(torch, name, q, k, v, causal, mask=mask,
                             blocks=(bq, bk))
        del q, k, v, dout, out, lse, ref_out, ref_lse, grads, ref
    docs = doc_mask(torch, (384, 640, 256, 768), 128).to(device)
    timing = time_block_sparse(torch, (TRAIN_BATCH, 8, TRAIN_SEQ, 128), docs,
                               128, gen)
    return worst, timing, launches


def block_sparse_path(torch, q, k, v, dout, args, plain_forward):
    """block_sparse_attention forward + autograd.grad, counted, against
    the plain path (the plain forward and backward on the same inputs)."""
    from kubeshare_tpu_torch.ops import attention as A

    mask, causal, bq, bk = args
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_counts()
    out = A.block_sparse_attention(*leaves, mask, causal=causal, block_q=bq,
                                   block_k=bk)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"block_sparse_attention forward + grad at {tuple(q.shape)}: "
          f"launches {launches}")
    check(launches == only("flash_fwd_block_sparse",
                           "flash_bwd_dkv_block_sparse",
                           "flash_bwd_dq_block_sparse"),
          f"block_sparse_attention launched {launches}: expected each "
          f"masked kernel once and no dense kernel")
    ref_out, ref_lse = plain_forward
    check(tuple(out.shape) == tuple(q.shape) and out.dtype == q.dtype,
          f"block_sparse_attention out {tuple(out.shape)} {out.dtype}")
    out = out.detach()
    err = check_out(torch, "block_sparse_attention out vs plain path", out,
                    ref_out)
    print(f"block_sparse_attention out vs plain path: max abs err {err:.3e}")
    ref = A.block_sparse_backward_reference(q, k, v, ref_out, ref_lse, dout,
                                            *args)
    check_grads(torch, "block_sparse_attention grads vs plain path", grads,
                ref)
    oracle = A.block_sparse_reference(q, k, v, *args)
    print("block_sparse_attention out vs block_sparse_reference (bf16 "
          "scores): max abs err "
          f"{float((out.float() - oracle.float()).abs().max()):.3e}")
    return launches


def slice_phase(torch, device):
    from kubeshare_tpu_torch.entry import entry, flagship_config
    from kubeshare_tpu_torch.models.decoding import greedy_decode_with_cache, prefill
    from kubeshare_tpu_torch.models.transformer import transformer_apply
    from kubeshare_tpu_torch.ops.attention import flash_forward

    config = flagship_config()
    plain = dataclasses.replace(config, attention="reference")
    fn, (params, tokens) = entry()
    launches = {}

    # path 1: the entry forward at (4, 1024)
    reset_counts()
    t0 = time.perf_counter()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches["forward"] = read_counts()
    check(launches["forward"]["flash_fwd"] == config.n_layers,
          f"forward launched the kernel {launches['forward']['flash_fwd']} "
          f"times, expected {config.n_layers}")
    with torch.no_grad():
        plain_logits = transformer_apply(params, tokens, plain)
    check(tuple(logits.shape) == (*tokens.shape, config.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite forward logits")
    forward_err = float((logits - plain_logits).abs().max())
    print(f"slice forward {tuple(tokens.shape)}: {forward_s * 1e3:.1f} ms (first call), "
          f"logits max abs err vs plain {forward_err:.3e}")
    check(forward_err <= SLICE_LOGITS_ATOL,
          f"forward logits differ from the plain path by {forward_err}")

    # path 2: serve 4 requests — bulk prefill, then greedy decode
    prompts = serve_prompts(torch, config, device)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, last = prefill(params, config, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(flash_forward.launches == config.n_layers,
          f"prefill launched the kernel {flash_forward.launches} times, "
          f"expected {config.n_layers}")
    out = greedy_decode_with_cache(params, config, cache, last, NEW_TOKENS)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches["serve"] = read_counts()

    plain_cache, plain_last = prefill(params, plain, prompts)
    plain_out = greedy_decode_with_cache(params, plain, plain_cache,
                                         plain_last, NEW_TOKENS)
    check(tuple(out.shape) == (N_REQUESTS, NEW_TOKENS), f"tokens {out.shape}")
    check(bool(((out >= 0) & (out < config.vocab_size)).all()),
          "token ids out of range")
    check(bool(torch.isfinite(last).all()), "non-finite prefill logits")
    check(int(cache["length"]) == PROMPT_LEN + NEW_TOKENS - 1,
          f"cache length {cache['length']}")
    logits_err = float((last - plain_last).abs().max())
    kv_err = max(
        float((cache[n][..., :PROMPT_LEN, :].float()
               - plain_cache[n][..., :PROMPT_LEN, :].float()).abs().max())
        for n in ("k", "v"))
    agree = float((out == plain_out).float().mean())
    top2 = torch.topk(plain_last, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > SLICE_LOGITS_ATOL
    first_ok = bool((out[decided, 0] == plain_out[decided, 0]).all())
    print(f"slice serve {N_REQUESTS} x ({PROMPT_LEN} prompt + {NEW_TOKENS} "
          f"greedy): prefill {prefill_s * 1e3:.1f} ms, total "
          f"{serve_s * 1e3:.1f} ms; last logits max abs err vs plain "
          f"{logits_err:.3e}, kv max abs err {kv_err:.3e}, token agreement "
          f"{agree:.4f}, first token checked in "
          f"{int(decided.sum())}/{N_REQUESTS} rows")
    check(logits_err <= SLICE_LOGITS_ATOL,
          f"prefill logits differ from the plain path by {logits_err}")
    check(kv_err <= SLICE_KV_ATOL,
          f"prefill KV cache differs from the plain path by {kv_err}")
    check(first_ok, "first greedy token differs from the plain path in a "
                    "row whose top-2 margin exceeds the tolerance")
    return launches


def serve_prompts(torch, config, device):
    """The slice phase's N_REQUESTS prompts of PROMPT_LEN tokens."""
    gen = torch.Generator().manual_seed(7)
    return torch.randint(0, config.vocab_size, (N_REQUESTS, PROMPT_LEN),
                         generator=gen).to(device)


def serve_both_ways(torch, params, config, prompts):
    """``prompts`` served by bulk prefill + greedy decode of NEW_TOKENS,
    eager and with every decode step one CUDA graph replay; returns the
    two token streams (by capture) and a line per way: the serve time and
    a decode step's CUDA-event median beside its host enqueue."""
    from kubeshare_tpu_torch.models.decoding import (
        greedy_decode_with_cache, make_decode_step, prefill)

    streams, lines = {}, []
    for capture in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, last = prefill(params, config, prompts)
        streams[capture] = greedy_decode_with_cache(
            params, config, cache, last, NEW_TOKENS, capture=capture)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
        # the step alone: its first call (the capture) untimed, then
        # DECODE_TIMED_STEPS steps, each between two events
        cache, last = prefill(params, config, prompts)
        step = make_decode_step(params, config, prompts.shape[0],
                                capture=capture)
        token = torch.argmax(step(cache, torch.argmax(last, dim=-1)), dim=-1)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(DECODE_TIMED_STEPS)]
        enqueue = []
        torch.cuda.synchronize()
        for start, end in events:
            t0 = time.perf_counter()
            start.record()
            token = torch.argmax(step(cache, token), dim=-1)
            end.record()
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        step_ms = steady_median([a.elapsed_time(b) for a, b in events])
        lines.append(f"{'captured' if capture else 'eager'}: serve "
                     f"{serve_ms:.1f} ms, decode step {step_ms:.4f} ms "
                     f"(CUDA events, median) / enqueue "
                     f"{steady_median(enqueue):.4f} ms (host)")
    return streams, lines


def decode_capture_phase(torch, device):
    """The slice phase's 4 requests of PROMPT_LEN + NEW_TOKENS greedy
    tokens served eager and captured: equal streams, each serve's time,
    and a decode step's CUDA-event ms beside its host enqueue ms."""
    from kubeshare_tpu_torch.entry import entry, flagship_config

    config = flagship_config()
    _, (params, _) = entry()
    prompts = serve_prompts(torch, config, device)
    reset_counts()
    streams, lines = serve_both_ways(torch, params, config, prompts)
    launches = read_counts()
    same = bool(torch.equal(streams[False], streams[True]))
    print(f"decode_capture {N_REQUESTS} x ({PROMPT_LEN} + {NEW_TOKENS}): "
          + "; ".join(lines) + f"; captured tokens equal eager: {same}")
    check(same, "the captured decode's tokens differ from the eager decode's")
    return launches


def f32_phase(torch, device, hold=True):
    """The f32 path: (a) the serving flagship at f32 (flagship_config(
    torch.float32)): the bulk forward at tokens (4, 1024) and a greedy
    serve of N_REQUESTS x (PROMPT_LEN + NEW_TOKENS), each held against
    attention="reference"; (b) the train-step flagship at f32: step 1's
    loss and gradients against attention="reference", then
    F32_TRAIN_STEPS eager AdamW steps timed by CUDA events.  Returns the
    launches of the forward, the serve and the train steps, and the
    readings held to the F32_* limits; ``hold=False`` reads them without
    holding them (for a variant of the kernels that should fail them).
    Launches, shapes and finite values are checked either way."""
    within = check if hold else (lambda condition, message: None)
    from kubeshare_tpu_torch.entry import flagship_config
    from kubeshare_tpu_torch.models.decoding import (
        greedy_decode_with_cache, prefill)
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply, transformer_init)
    from kubeshare_tpu_torch.parallel.train import (
        cross_entropy_loss, make_train_step, tree_leaves_with_paths)

    launches = {}
    config = flagship_config(torch.float32)
    plain = dataclasses.replace(config, attention="reference")
    params = transformer_init(config, torch.Generator().manual_seed(0),
                              device)
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, config.vocab_size, (4, config.max_seq_len),
                           generator=gen).to(device)

    # (a) the bulk forward, then the serve
    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = transformer_apply(params, tokens, config)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
        launches["f32_forward"] = read_counts()
        plain_logits = transformer_apply(params, tokens, plain)
    check(launches["f32_forward"] == {
              **only(), "flash_fwd": config.n_layers},
          f"the f32 forward launched {launches['f32_forward']}, expected "
          f"{config.n_layers} forward kernels")
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (*tokens.shape, config.vocab_size),
          f"f32 forward logits: shape {tuple(logits.shape)} or non-finite")
    forward_err = float((logits - plain_logits).abs().max())
    print(f"f32 forward {tuple(tokens.shape)}: {forward_ms:.1f} ms (first "
          f"call), logits max abs err vs attention=reference "
          f"{forward_err:.3e} (max |logit| "
          f"{float(plain_logits.abs().max()):.3f}, tol {F32_LOGITS_ATOL})")
    within(forward_err <= F32_LOGITS_ATOL,
          f"f32 forward logits differ from the reference path by "
          f"{forward_err}")
    del logits, plain_logits

    prompts = serve_prompts(torch, config, device)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, last = prefill(params, config, prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out = greedy_decode_with_cache(params, config, cache, last, NEW_TOKENS)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches["f32_serve"] = read_counts()
    check(launches["f32_serve"] == {**only(), "flash_fwd": config.n_layers},
          f"the f32 serve launched {launches['f32_serve']}, expected "
          f"{config.n_layers} forward kernels (the prefill)")
    _, plain_last = prefill(params, plain, prompts)
    last_err = float((last - plain_last).abs().max())
    trace = [(i, prompts[i].tolist(), NEW_TOKENS) for i in range(N_REQUESTS)]
    streams = {i: out[i].tolist() for i in range(N_REQUESTS)}
    worst = teacher_forced(torch, params, plain, trace, streams, device)
    # greedy_decode_with_cache takes NEW_TOKENS - 1 decode steps after the
    # prefill's token
    step_ms = (serve_ms - prefill_ms) / (NEW_TOKENS - 1)
    print(f"f32 serve {N_REQUESTS} x ({PROMPT_LEN} + {NEW_TOKENS} greedy): "
          f"prefill {prefill_ms:.1f} ms, decode {step_ms:.3f} ms a step "
          f"(host clock, eager), serve {serve_ms:.1f} ms; prefill logits "
          f"max abs err vs attention=reference {last_err:.3e}; "
          f"teacher-forced worst {worst:.3e} (margin {F32_TOKEN_MARGIN})")
    check(bool(((out >= 0) & (out < config.vocab_size)).all()),
          "f32 serve: token ids out of range")
    within(last_err <= F32_LOGITS_ATOL,
          f"f32 prefill logits differ from the reference path by {last_err}")
    within(worst <= F32_TOKEN_MARGIN,
          f"an f32 served token is {worst} below its row's maximum under "
          f"the reference forward")
    del cache, params

    # (b) the train-step flagship at f32
    config, params, tokens, targets = train_setup(torch, device,
                                                  dtype=torch.float32)
    plain = dataclasses.replace(config, attention="reference")
    paths, leaves = zip(*tree_leaves_with_paths(params))
    for leaf in leaves:
        leaf.requires_grad_(True)

    def loss_and_grads(cfg):
        loss = cross_entropy_loss(transformer_apply(params, tokens, cfg),
                                  targets)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    loss, grads = loss_and_grads(config)
    plain_loss, plain_grads = loss_and_grads(plain)
    loss_err = abs(loss - plain_loss)
    grad_err, worst_path = max(
        ((rel_err(g, r), path) for g, r, path in zip(grads, plain_grads,
                                                     paths)),
        key=lambda pair: pair[0])
    cosine = min(float(torch.nn.functional.cosine_similarity(
        g.flatten(), r.flatten(), dim=0))
        for g, r in zip(grads, plain_grads))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    del grads, plain_grads
    print(f"f32 train grads vs attention=reference ({len(leaves)} "
          f"tensors): loss {loss:.6f} vs {plain_loss:.6f} (abs err "
          f"{loss_err:.3e}, tol {F32_TRAIN_LOSS_ATOL}), worst grad "
          f"max-abs-err/max-ref {grad_err:.3e} (tol {F32_TRAIN_GRAD_RTOL}, "
          f"{worst_path}), lowest cosine {cosine:.9f} (tol "
          f"{F32_TRAIN_GRAD_MIN_COSINE})")
    check(finite, "non-finite gradients on the f32 train path")
    within(loss_err <= F32_TRAIN_LOSS_ATOL,
          f"f32 train loss differs from the reference path by {loss_err}")
    within(grad_err <= F32_TRAIN_GRAD_RTOL,
          f"f32 train gradients differ from the reference path by "
          f"{grad_err} of max")
    within(cosine >= F32_TRAIN_GRAD_MIN_COSINE,
          f"an f32 train gradient points elsewhere than the reference "
          f"path's (cosine {cosine})")

    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config))
    reset_counts()
    _, losses, step_ms, enqueue_ms = timed_steps(
        torch, train_step, init_state(params),
        [(tokens, targets)] * F32_TRAIN_STEPS)
    launches["f32_train"] = read_counts()
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    print(f"f32 train {F32_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens: launches {launches['f32_train']}, losses "
          + " ".join(f"{x:.5f}" for x in losses) + ", step ms "
          + " ".join(f"{x:.2f}" for x in step_ms) + " (CUDA events), "
          f"enqueue ms " + " ".join(f"{x:.2f}" for x in enqueue_ms)
          + f"; last step {tokens_per_step / (step_ms[-1] * 1e-3):.0f} "
          f"tokens/s")
    check(launches["f32_train"] == {
              name: n * F32_TRAIN_STEPS * config.n_layers
              for name, n in only("flash_fwd", "flash_bwd_dkv",
                                  "flash_bwd_dq").items()},
          f"the f32 train steps launched {launches['f32_train']}, expected "
          f"{F32_TRAIN_STEPS * config.n_layers} of each kernel")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    within(abs(losses[0] - loss) <= F32_TRAIN_LOSS_ATOL,
          f"f32 train step 1 loss {losses[0]} differs from the checked "
          f"{loss}")
    check(losses[-1] < losses[0], f"f32 loss did not fall: {losses}")
    readings = {"forward_logits": forward_err, "prefill_logits": last_err,
                "token_gap": worst, "loss": loss_err, "grad_rel": grad_err,
                "grad_cosine": cosine}
    return launches, readings


def engine_trace(config):
    """ENGINE_REQUESTS (rid, prompt, new_tokens), from ENGINE_SEED."""
    import numpy as np

    rng = np.random.default_rng(ENGINE_SEED)
    prefix = rng.integers(0, config.vocab_size,
                          ENGINE_PREFIX + ENGINE_COW_EXTRA)
    trace = []
    for i in range(ENGINE_REQUESTS):
        length = int(rng.integers(ENGINE_PROMPT[0], ENGINE_PROMPT[1] + 1))
        new = int(rng.integers(ENGINE_NEW[0], ENGINE_NEW[1] + 1))
        prompt = rng.integers(0, config.vocab_size, length)
        if i % ENGINE_SHARE_EVERY == 0:
            shared = ENGINE_PREFIX + (
                ENGINE_COW_EXTRA if i % (2 * ENGINE_SHARE_EVERY) else 0)
            prompt = np.concatenate([prefix[:shared], prompt])[:max(
                length, shared + 1)]
        trace.append((f"req{i}", prompt, new))
    return trace


def engine_pass(torch, device, params, config, trace, guard=None,
                pool=ENGINE_POOL, after=None, mesh_devices=None,
                **overrides):
    """One ServingEngine run over ``trace``: warm-up, then every request
    submitted at once and served.  ``after(engine)``, when given, runs on
    the drained engine and its dict joins the stats; ``mesh_devices``
    is a tensor-parallel engine's device group.  Returns (streams,
    stats)."""
    from kubeshare_tpu_torch.serving import EngineConfig, Request, ServingEngine
    from kubeshare_tpu_torch.serving.metrics_view import (
        flatten_metrics, hist_quantile, metric_histogram)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base_mem = torch.cuda.memory_allocated(device)
    engine = ServingEngine(params, config,
                           EngineConfig(**{**pool, **overrides}),
                           guard=guard, device=device,
                           mesh_devices=mesh_devices)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    captures = engine.capture_counts()
    reset_counts()
    t0 = time.perf_counter()
    for rid, prompt, new in trace:
        engine.submit(Request(rid, prompt, new))
    steps = 0
    while engine.step():
        steps += 1
    if guard is not None:
        guard.finish()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = read_counts()
    device_ms = engine.dispatch_device_ms()
    metrics = flatten_metrics(engine.collect_metrics())

    def quantile(name, q):
        return hist_quantile(metric_histogram(metrics, name), q)

    new_captures = sum(engine.capture_counts().values()) - sum(captures.values())
    results = {rid: engine.result(rid) for rid, _, _ in trace}
    stats = {
        "warmup_s": warmup_s, "captures": sum(captures.values()),
        "captures_by_kind": {k: n for k, n in captures.items() if n},
        "new_captures": new_captures, "serve_s": serve_s, "steps": steps,
        "tokens": engine.tokens_generated,
        "tokens_per_s": engine.tokens_generated / serve_s,
        "ttft_p50_s": quantile("kubeshare_serving_ttft_seconds", 0.5),
        "ttft_p95_s": quantile("kubeshare_serving_ttft_seconds", 0.95),
        "tbt_p50_s": quantile("kubeshare_serving_tbt_seconds", 0.5),
        "tbt_p99_s": quantile("kubeshare_serving_tbt_seconds", 0.99),
        "device_ms": {k: v for k, v in device_ms.items() if v[0]},
        "host_s": dict(engine.host_seconds),
        "prefix_hit_requests": engine.prefix_hit_requests,
        "prefix_hit_tokens": engine.prefix_hit_tokens,
        "cow_copies": engine.cow_copies,
        "mixed_steps": engine.mixed_steps,
        "loop_launches": engine.loop_launches,
        "loop_units": engine.loop_units,
        "verify_steps": engine.verify_steps,
        "mixed_verify_steps": engine.mixed_verify_steps,
        "spec_loop_launches": engine.spec_loop_launches,
        "spec_loop_units": engine.spec_loop_units,
        "spec_drafted": sum(engine.spec_drafted.values()),
        "spec_accepted": sum(engine.spec_accepted.values()),
        "spec_accept_hist": [sum(c) for c in zip(
            *(h[0] for h in engine._spec_accept.values()))],
        "loop_exit_reasons": dict(engine.loop_exit_reasons),
        "loop_depth": (engine.loop_depth_sum
                       / max(engine.loop_depth_count, 1)),
        "ring_activations": engine.ring_activations,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(device)
                         - base_mem) / 2 ** 30,
        "launches": launches,
        "prefill_chunks": engine.prefill_chunks,
        "tier": tier_stats(engine),
        "tuner": (None if engine._tuner is None else {
            "rounds": engine._tuner._rounds,
            "decisions": {f"{knob} {way}": n for (knob, way), n
                          in sorted(engine._tuner.decisions.items())},
            "trajectory": engine._tuner.trajectory}),
    }
    check(all(r.done for r in results.values()), "a request did not finish")
    try:
        if after is not None:
            stats.update(after(engine))
    finally:
        if engine.disk_tier is not None:
            engine.disk_tier.close()
    del engine
    torch.cuda.empty_cache()
    return {rid: r.tokens for rid, r in results.items()}, stats


def tier_stats(engine):
    """The KV tiers' counters of one engine (zeros without a tier)."""
    host, disk = engine.host_tier, engine.disk_tier
    return {
        "demoted": engine.tier_demoted_blocks,
        "promoted": engine.tier_promoted_blocks,
        "dropped": engine.tier_dropped_blocks,
        "host_evicted": host.evicted_blocks if host is not None else 0,
        "hit_requests": engine.tier_hit_requests,
        "hit_tokens": engine.tier_hit_tokens,
        "disk_stored": disk.stored_blocks if disk is not None else 0,
        "disk_promoted": disk.promoted_blocks if disk is not None else 0,
        "disk_evicted": disk.evicted_blocks if disk is not None else 0,
        "corrupt": engine.tier_corrupt_blocks,
        "demotion_s": engine.tier_demotion_s,
        "promotion_stall_s": engine.tier_promotion_stall_s,
        "host_peak_bytes": host.peak_bytes if host is not None else 0,
        "disk_peak_bytes": disk.peak_bytes if disk is not None else 0,
    }


def engine_report(label, stats):
    dev = stats["device_ms"]
    spans = "; ".join(f"{kind} {n} x {ms / n:.3f} ms"
                      for kind, (n, ms) in sorted(dev.items()))
    busy = sum(ms for _, ms in dev.values()) / (stats["serve_s"] * 1e3)
    print(f"engine {label}: warm-up {stats['warmup_s']:.2f} s, "
          f"{stats['captures']} captures {stats['captures_by_kind']}, "
          f"{stats['new_captures']} after warm-up; {stats['tokens']} tokens "
          f"in {stats['serve_s']:.3f} s = {stats['tokens_per_s']:.1f} "
          f"tokens/s over {stats['steps']} steps "
          f"({stats['serve_s'] * 1e3 / stats['steps']:.3f} ms host a step); "
          f"TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; TBT p50 "
          f"{stats['tbt_p50_s'] * 1e3:.3f} ms p99 "
          f"{stats['tbt_p99_s'] * 1e3:.3f} ms (engine histograms); "
          f"dispatches by CUDA events: {spans} (device busy {busy:.4f} "
          f"of the serve); host s by phase "
          + json.dumps({k: round(v, 4) for k, v in stats['host_s'].items()})
          + f"; prefix hits {stats['prefix_hit_requests']} requests / "
          f"{stats['prefix_hit_tokens']} tokens, cow copies "
          f"{stats['cow_copies']}; mixed steps {stats['mixed_steps']}, "
          f"loop launches {stats['loop_launches']} ({stats['loop_units']} "
          f"units); peak memory {stats['peak_mem_gib']:.3f} GiB above the "
          f"weights")


def teacher_forced(torch, params, config, trace, streams, device):
    """Each emitted token's shortfall from its row's maximum under the
    dense forward over prompt + emitted tokens; returns the worst."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply

    worst = 0.0
    with torch.no_grad():
        for rid, prompt, _ in trace:
            emitted = streams[rid]
            seq = torch.tensor(list(prompt) + emitted[:-1], device=device)
            logits = transformer_apply(params, seq[None], config)[0]
            rows = logits[len(prompt) - 1:]
            picked = rows.gather(1, torch.tensor(emitted, device=device)[:, None])
            worst = max(worst, float((rows.max(dim=1).values
                                      - picked[:, 0]).max()))
    return worst


def engine_phase(torch, device):
    """The flagship serving model behind ServingEngine: three passes over
    one trace (default, steps_per_launch=4, behind a guard)."""
    from kubeshare_tpu_torch.entry import entry, flagship_config
    from kubeshare_tpu_torch.isolation import ExecutionGuard
    from kubeshare_tpu_torch.models.decoding import (greedy_decode_with_cache,
                                                     prefill)

    config = flagship_config()
    _, (params, _) = entry()
    trace = engine_trace(config)
    streams, stats = engine_pass(torch, device, params, config, trace)
    engine_report("default", stats)
    check(stats["new_captures"] == 0,
          f"the engine captured {stats['new_captures']} graphs after warm-up")
    check(stats["prefix_hit_requests"] > 0 and stats["cow_copies"] > 0,
          "the trace's shared prefix produced no hit or no copy-on-write")
    check(all(len(streams[rid]) == new for rid, _, new in trace),
          "a stream has the wrong length")
    check(all(0 <= t < config.vocab_size for s in streams.values() for t in s),
          "token ids out of range")
    worst = teacher_forced(torch, params, config, trace, streams, device)
    equal = 0
    for rid, prompt, new in trace:
        cache, last = prefill(params, config,
                              torch.from_numpy(prompt)[None].to(device))
        dense = greedy_decode_with_cache(params, config, cache, last, new,
                                         capture=True)
        equal += int(dense[0].tolist() == streams[rid])
    print(f"engine teacher-forced: worst emitted token {worst:.4f} under its "
          f"row's max in the dense forward (tol {ENGINE_TOKEN_MARGIN}); "
          f"streams equal to the dense greedy decode: {equal}/{len(trace)} "
          f"= {equal / len(trace):.4f}")
    check(worst <= ENGINE_TOKEN_MARGIN,
          f"an emitted token lies {worst} under its row's max in the dense "
          "forward")

    loop_streams, loop_stats = engine_pass(torch, device, params, config,
                                           trace, steps_per_launch=4)
    engine_report("steps_per_launch=4", loop_stats)
    check(loop_stats["new_captures"] == 0,
          "the steps_per_launch=4 engine captured graphs after warm-up")
    check(loop_stats["loop_launches"] > 0, "the device loop never launched")
    check(loop_streams == streams,
          "steps_per_launch=4 streams differ from steps_per_launch=1")

    class GrantAll:
        """A broker that grants every request in full."""

        def acquire(self, estimate_ms):
            return 1e9

        def release(self, used_ms):
            pass

    guard = ExecutionGuard(client=GrantAll(), from_env=False,
                           idle_release_ms=0)
    guarded_streams, guarded = engine_pass(torch, device, params, config,
                                           trace, guard=guard)
    device_total = sum(ms for _, ms in guarded["device_ms"].values())
    share = guard.total_gated_ms / device_total
    print(f"engine under an ExecutionGuard: {guarded['tokens_per_s']:.1f} "
          f"tokens/s; charged {guard.total_gated_ms:.1f} ms for "
          f"{device_total:.1f} ms of dispatches by CUDA events = "
          f"{share:.4f} (tol >= {GUARD_MIN_SHARE}); streams equal the "
          f"unguarded run: {guarded_streams == streams}")
    check(share >= GUARD_MIN_SHARE,
          f"the guard charged {share} of the dispatches' device time")
    check(guarded_streams == streams, "guarded streams differ")
    return stats["launches"], streams, stats, (loop_streams, loop_stats)


def tier_trace(config):
    """TIER_REQUESTS (rid, prompt, new_tokens) from TIER_SEED, in
    build_tiered_workload's draw order (all submitted at once, so no
    arrival times are drawn)."""
    import numpy as np

    rng = np.random.default_rng(TIER_SEED)
    prefixes = [rng.integers(0, config.vocab_size, TIER_PREFIX_LEN)
                for _ in range(TIER_PREFIXES)]
    trace = []
    for i in range(TIER_REQUESTS):
        prefix = prefixes[int(rng.integers(TIER_PREFIXES))]
        tail = rng.integers(0, config.vocab_size,
                            int(rng.integers(TIER_TAIL[0], TIER_TAIL[1] + 1)))
        new = int(rng.integers(TIER_NEW[0], TIER_NEW[1] + 1))
        trace.append((f"req{i}", np.concatenate([prefix, tail]), new))
    return trace


def tier_round_trip(torch, engine):
    """The demotion and promotion paths' bytes on the card: random bf16
    rows written into one pool block, read back as a demotion reads them
    (_read_block_payload: a gather and a device-to-host copy, then
    pack_block), unpacked, and uploaded into another block by the captured
    upload program; the two blocks must be equal as int16 words.  Then
    the demotion read of TIER_READ_BLOCKS cached blocks, one gather for
    all (as a subtree walk reads them) against one read a block."""
    import types

    from kubeshare_tpu_torch.serving.kv_tier import pack_block, unpack_block

    cfg, pool = engine.model_config, engine.pool
    src, dst = engine.allocator.reserve(2, "round-trip")
    gen = torch.Generator(device=pool.k.device).manual_seed(0)
    shape = (cfg.n_layers, cfg.kv_heads, pool.block_size, cfg.head_dim)
    for slab in (pool.k, pool.v):
        slab[:, src] = torch.randn(shape, generator=gen, device=slab.device,
                                   dtype=torch.float32).to(slab.dtype)
    node = types.SimpleNamespace(block=src,
                                 tokens=tuple(range(pool.block_size)))
    uploads = engine.device_dispatches["upload"]
    _, k, v = unpack_block(engine._read_block_payload(node))
    engine._upload(dst, k, v)
    torch.cuda.synchronize()
    equal = all(torch.equal(slab[:, src].view(torch.int16),
                            slab[:, dst].view(torch.int16))
                for slab in (pool.k, pool.v))
    engine.allocator.reclaim([src, dst])
    engine.dispatch_device_ms()
    check(engine.device_dispatches["upload"] == uploads + 1,
          "the round trip's upload did not run the upload program")

    blocks = list(range(1, 1 + TIER_READ_BLOCKS))
    tokens = tuple(range(pool.block_size))

    def gathered():
        k_rows, v_rows = engine._read_blocks(blocks)
        return [pack_block(tokens, k_rows[i], v_rows[i])
                for i in range(len(blocks))]

    def per_block():
        return [engine._read_block_payload(
            types.SimpleNamespace(block=b, tokens=tokens)) for b in blocks]

    times, payloads = {"gathered": [], "per_block": []}, {}
    for _ in range(TIER_READ_TURNS):
        for label, fn in (("gathered", gathered), ("per_block", per_block)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payloads[label] = fn()
            times[label].append((time.perf_counter() - t0) * 1e3)
    same = payloads["gathered"] == payloads["per_block"]
    return {"round_trip_equal": equal, "read_same_bytes": same,
            "read_ms": {k: min(v) for k, v in times.items()}}


def engine_tier_phase(torch, device, loop_pass):
    """The KV tiers and the autotuner on the flagship: passes (a)-(d) over
    tier_trace, (e) autotune over engine_trace against the engine phase's
    steps_per_launch=4 pass (``loop_pass``: its streams and stats)."""
    from kubeshare_tpu_torch.entry import entry, flagship_config

    config = flagship_config()
    _, (params, _) = entry()
    trace = tier_trace(config)
    small = dict(TIER_POOL, num_blocks=TIER_SMALL_BLOCKS)
    arms = [
        ("(a) HBM-sized pool", dict(TIER_POOL, num_blocks=TIER_HBM_BLOCKS),
         {}),
        ("(b) small pool, tier off", small, {}),
        ("(c) small pool, host tier", small,
         dict(host_tier_bytes=TIER_HOST_BYTES)),
        ("(d) small pool, host tier cascading to disk", small,
         dict(host_tier_bytes=TIER_CASCADE_HOST_BYTES,
              disk_tier_bytes=TIER_DISK_BYTES)),
    ]
    passes, launches = {}, []
    for label, pool, overrides in arms:
        after = (lambda engine: tier_round_trip(torch, engine)) \
            if label.startswith("(c)") else None
        streams, stats = engine_pass(torch, device, params, config, trace,
                                     pool=pool, after=after, **overrides)
        passes[label[:3]] = (streams, stats)
        launches.append(stats["launches"])
        engine_report(f"tier {label}", stats)
        tier_report(label, stats, streams, passes["(a)"][0], trace)
        worst = teacher_forced(torch, params, config, trace, streams, device)
        print(f"engine tier {label} teacher-forced: worst emitted token "
              f"{worst:.4f} under its row's max (tol {ENGINE_TOKEN_MARGIN})")
        check(stats["new_captures"] == 0,
              f"{label}: {stats['new_captures']} captures after warm-up")
        check(worst <= ENGINE_TOKEN_MARGIN,
              f"{label}: an emitted token lies {worst} under its row's max")
        check(all(len(streams[rid]) == new for rid, _, new in trace),
              f"{label}: a stream has the wrong length")
    b, c, d = (passes[k][1] for k in ("(b)", "(c)", "(d)"))
    for label, stats in (("(c)", c), ("(d)", d)):
        check(stats["tier"]["demoted"] > 0 and stats["tier"]["promoted"] > 0,
              f"{label} demoted or promoted no block")
        check(stats["captures_by_kind"].get("upload") == 1,
              f"{label} has {stats['captures_by_kind'].get('upload')} upload "
              "graphs, not one")
    check(c["prefix_hit_requests"] > b["prefix_hit_requests"],
          f"the host tier served {c['prefix_hit_requests']} requests from a "
          f"cached prefix, tier off {b['prefix_hit_requests']}")
    check(c["prefill_chunks"] < b["prefill_chunks"],
          f"the host tier ran {c['prefill_chunks']} prefill chunks, tier "
          f"off {b['prefill_chunks']}")
    check(d["tier"]["disk_promoted"] > 0, "(d) promoted nothing from disk")
    check(c["round_trip_equal"],
          "the demote -> promote round trip changed the block's bytes")
    check(c["read_same_bytes"],
          "the gathered demotion read packs other bytes than a per-block read")
    print(f"engine tier round trip: random bf16 rows through "
          f"_read_block_payload -> pack_block -> unpack_block -> the "
          f"captured upload equal as int16 words: {c['round_trip_equal']}; "
          f"demotion read of {TIER_READ_BLOCKS} blocks (gather + copy + "
          f"pack): one gather {c['read_ms']['gathered']:.3f} ms, one read a "
          f"block {c['read_ms']['per_block']:.3f} ms (host clock, best of "
          f"{TIER_READ_TURNS} turns each), same bytes: "
          f"{c['read_same_bytes']}")

    loop_streams, loop_stats = loop_pass
    etrace = engine_trace(config)
    streams, stats = engine_pass(torch, device, params, config, etrace,
                                 steps_per_launch=4, autotune=True)
    launches.append(stats["launches"])
    engine_report("tier (e) autotune steps_per_launch=4", stats)
    tuner = stats["tuner"]
    worst = teacher_forced(torch, params, config, etrace, streams, device)
    equal = sum(streams[rid] == loop_streams[rid] for rid, _, _ in etrace)
    print(f"engine tier (e) autotune: {tuner['rounds']} tuning rounds, "
          f"decisions {json.dumps(tuner['decisions'])}, trajectory "
          f"(round, knob, old, new) {json.dumps(tuner['trajectory'][:24])}"
          f"{' ...' if len(tuner['trajectory']) > 24 else ''}; "
          f"{stats['tokens_per_s']:.1f} tokens/s against "
          f"{loop_stats['tokens_per_s']:.1f} for steps_per_launch=4 without "
          f"the tuner ({loop_stats['captures']} graphs, warm-up "
          f"{loop_stats['warmup_s']:.2f} s); teacher-forced worst "
          f"{worst:.4f}; streams equal to steps_per_launch=4: "
          f"{equal}/{len(etrace)}")
    check(stats["new_captures"] == 0,
          f"(e): {stats['new_captures']} captures after warm-up")
    check(tuner["rounds"] > 0, "(e): the tuner ran no tuning round")
    check(worst <= ENGINE_TOKEN_MARGIN,
          f"(e): an emitted token lies {worst} under its row's max")
    check(all(len(streams[rid]) == new for rid, _, new in etrace),
          "(e): a stream has the wrong length")
    return {name: sum(counts[name] for counts in launches)
            for name in launches[0]}


def tier_report(label, stats, streams, hbm_streams, trace):
    """The tier counters, prefill chunks, the upload dispatches' CUDA-event
    time, the demotion and promotion host seconds, and the streams equal
    to the HBM-sized pass."""
    tier = stats["tier"]
    n_up, up_ms = stats["device_ms"].get("upload", (0, 0.0))
    equal = sum(streams[rid] == hbm_streams[rid] for rid, _, _ in trace)
    per_block = tier["demotion_s"] * 1e3 / max(tier["demoted"]
                                               + tier["dropped"], 1)
    print(f"engine tier {label} tiers: demoted {tier['demoted']}, promoted "
          f"{tier['promoted']}, dropped {tier['dropped']}, host-evicted "
          f"{tier['host_evicted']}, tier hits {tier['hit_requests']} requests "
          f"/ {tier['hit_tokens']} tokens, disk stored {tier['disk_stored']} "
          f"promoted {tier['disk_promoted']} evicted {tier['disk_evicted']}, "
          f"corruptions {tier['corrupt']}; peak host {tier['host_peak_bytes']}"
          f" B, disk {tier['disk_peak_bytes']} B; cached-prefix requests "
          f"{stats['prefix_hit_requests']} (device and tier) / "
          f"{stats['prefix_hit_tokens']} tokens; prefill chunks "
          f"{stats['prefill_chunks']}; upload {n_up} x "
          f"{up_ms / max(n_up, 1):.4f} ms (CUDA events); demotion host "
          f"{tier['demotion_s']:.4f} s ({per_block:.4f} ms a block: read + "
          f"pack), promotion stall {tier['promotion_stall_s']:.4f} s; TTFT "
          f"p50 {stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; "
          f"{stats['tokens_per_s']:.1f} tokens/s; streams equal to (a): "
          f"{equal}/{len(trace)}")


def disagg_trace(config):
    """DISAGG_REQUESTS (rid, prompt, new_tokens, unit_arrival) in
    build_mixed_workload's draw order: the arrival is the running sum of
    unit-mean exponentials (scale it by a mean inter-arrival)."""
    import numpy as np

    rng = np.random.default_rng(DISAGG_SEED)
    trace, t = [], 0.0
    for i in range(DISAGG_REQUESTS):
        t += float(rng.exponential(1.0))
        if rng.random() < DISAGG_LONG_FRACTION:
            length = int(rng.integers(DISAGG_LONG_PROMPT[0],
                                      DISAGG_LONG_PROMPT[1] + 1))
            new = int(rng.integers(DISAGG_LONG_NEW[0], DISAGG_LONG_NEW[1] + 1))
        else:
            length = int(rng.integers(DISAGG_SHORT_PROMPT[0],
                                      DISAGG_SHORT_PROMPT[1] + 1))
            new = int(rng.integers(DISAGG_SHORT_NEW[0],
                                   DISAGG_SHORT_NEW[1] + 1))
        trace.append((f"req{i}", rng.integers(0, config.vocab_size, length),
                      new, t))
    return trace


def disagg_request(torch, i, rid, prompt, new, sampled):
    """Request i of the trace; sampled ones (every DISAGG_SAMPLE_EVERY-th
    when ``sampled``) draw their seed schedule from a generator seeded
    with i, so both engines of a pass get the same schedule."""
    from kubeshare_tpu_torch.serving import Request

    if sampled and i % DISAGG_SAMPLE_EVERY == 0:
        return Request(rid, prompt, new, temperature=DISAGG_TEMPERATURE,
                       rng=torch.Generator().manual_seed(DISAGG_SEED + i))
    return Request(rid, prompt, new)


def chain_round_trip(torch, router):
    """Hold one migrated chain to the bytes the prefill pool wrote: at the
    handoff of the first request with a prompt over 128 tokens its blocks
    are read (after a synchronize) before the pack; right after the
    delivery that admits it, the decode pool's blocks of the chain are
    read back.  Returns a dict filled by the run."""
    seen = {}
    handoff, deliver = router.prefill.on_handoff, router.migrator.deliver

    def read(pool, blocks):
        torch.cuda.synchronize()
        return [slab[:, blocks].view(torch.int16).cpu()
                for slab in (pool.k, pool.v)]

    def on_handoff(slot):
        if "rid" not in seen and slot.prompt.size > 128:
            n = -(-slot.prompt.size // router.prefill.pool.block_size)
            seen.update(rid=slot.rid, blocks=n, want=read(
                router.prefill.pool, [int(b) for b in slot.table[:n]]))
        handoff(slot)

    def on_deliver(ticket):
        ok = deliver(ticket)
        if ok and ticket.rid == seen.get("rid") and "equal" not in seen:
            slot = next(s for s in router.decode._slots
                        if s.state == "decode" and s.rid == ticket.rid)
            got = read(router.decode.pool, slot.blocks[:seen["blocks"]])
            seen["equal"] = all(torch.equal(g, w)
                                for g, w in zip(got, seen["want"]))
        return ok

    router.prefill.on_handoff = on_handoff
    router.migrator.deliver = on_deliver
    return seen


def serve(torch, engine, trace, mean_gap=None, sampled=False, release=None,
          script=None):
    """Submit ``trace`` to ``engine`` — every request at once or, with
    ``mean_gap``, at its arrival scaled by it (open loop); with
    ``release(engine, i)`` request i also waits until that returns True —
    and step it until it is idle, running ``script(engine)`` after every
    step.  Returns (steps that worked, serve seconds up to a
    synchronize)."""
    requests = [(i, disagg_request(torch, i, rid, prompt, new, sampled),
                 0.0 if mean_gap is None else arrival * mean_gap)
                for i, (rid, prompt, new, arrival) in enumerate(trace)]
    steps = 0
    t0 = time.perf_counter()
    while requests or not engine.idle:
        now = time.perf_counter() - t0
        while requests and requests[0][2] <= now and (
                release is None or release(engine, requests[0][0])):
            engine.submit(requests.pop(0)[1])
        if engine.step():
            steps += 1
        elif requests:
            time.sleep(min(0.001, max(requests[0][2] - now, 0.0)))
        if script is not None:
            script(engine)
    torch.cuda.synchronize()
    return steps, time.perf_counter() - t0


def disagg_pass(torch, device, params, config, trace, disagg, mixed=False,
                sampled=False, fabric=False, mean_gap=None, top_k=None,
                topology=None):
    """One pass over ``trace``: the monolithic ServingEngine (``mixed``) or
    the DisaggRouter (two-cell, or ``topology``; over a LoopbackTransport
    fabric when ``fabric``), warmed up, then every request submitted at
    once or, with ``mean_gap``, at its arrival scaled by it (open loop).
    Returns (streams, stats)."""
    from kubeshare_tpu_torch.serving import (DisaggRouter, EngineConfig,
                                             LoopbackTransport, ServingEngine)
    from kubeshare_tpu_torch.serving.metrics_view import (
        flatten_metrics, hist_quantile, metric_histogram)

    shared = dict(DISAGG_SHARED, top_k=top_k)
    torch.cuda.synchronize()
    if disagg:
        engine = DisaggRouter(
            params, config, EngineConfig(**shared, **DISAGG_PREFILL),
            EngineConfig(**shared, **DISAGG_DECODE),
            max_pending_handoffs=DISAGG_PENDING,
            fabric=LoopbackTransport() if fabric else None, device=device,
            topology=topology)
        pools = {"prefill": engine.prefill, "decode": engine.decode}
        round_trip = chain_round_trip(torch, engine) if not fabric else None
    else:
        engine = ServingEngine(params, config, EngineConfig(
            **shared, **DISAGG_MONO, mixed=mixed), device=device)
        pools = {"mono": engine}
        round_trip = None
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    captures = {name: dict(pool.capture_counts())
                for name, pool in pools.items()}
    reset_counts()
    steps, serve_s = serve(torch, engine, trace, mean_gap, sampled)
    launches = read_counts()
    metrics = flatten_metrics(engine.collect_metrics())

    def quantile(name, q, pool=None):
        view = {key: v for key, v in metrics.items()
                if pool is None or dict(key[1]).get("pool") == pool}
        return hist_quantile(metric_histogram(view, name), q)

    tbt_pool = "decode" if disagg else None
    ttft_pool = "prefill" if disagg else None
    results = {rid: engine.result(rid) for rid, _, _, _ in trace}
    check(all(r.done for r in results.values()), "a request did not finish")
    tokens = sum(len(r.tokens) for r in results.values())
    device_ms = {name: pool.dispatch_device_ms()
                 for name, pool in pools.items()}
    stats = {
        "warmup_s": warmup_s, "serve_s": serve_s, "steps": steps,
        "tokens": tokens, "tokens_per_s": tokens / serve_s,
        "captures": {name: sum(c.values()) for name, c in captures.items()},
        "new_captures": {
            name: sum(pool.capture_counts().values())
            - sum(captures[name].values()) for name, pool in pools.items()},
        "ttft_p50_s": quantile("kubeshare_serving_ttft_seconds", 0.5,
                               ttft_pool),
        "ttft_p95_s": quantile("kubeshare_serving_ttft_seconds", 0.95,
                               ttft_pool),
        "tbt_p50_s": quantile("kubeshare_serving_tbt_seconds", 0.5, tbt_pool),
        "tbt_p99_s": quantile("kubeshare_serving_tbt_seconds", 0.99,
                              tbt_pool),
        "busy": {name: sum(ms for _, ms in dev.values()) / (serve_s * 1e3)
                 for name, dev in device_ms.items()},
        "dispatches": {name: {k: n for k, (n, _) in dev.items() if n}
                       for name, dev in device_ms.items()},
        "launches": launches,
    }
    if disagg:
        mig = engine.migrator
        n_up, up_ms = device_ms["decode"]["upload"]
        stats.update({
            "migrations": mig.migrations, "delivered": mig.delivered,
            "migrated_bytes": mig.migrated_bytes,
            "stall_sum_s": metrics[
                ("kubeshare_serving_migration_stall_seconds_sum", ())],
            "stall_count": metrics[
                ("kubeshare_serving_migration_stall_seconds_count", ())],
            "uploads": n_up, "upload_ms": up_ms,
            "host_s": dict(mig.host_seconds),
            "retries": {k: n for k, n in engine.handoff_retries.items()
                        if n},
            "round_trip": (None if round_trip is None
                           else round_trip.get("equal")),
        })
        if fabric:
            pf = engine._fabric_pf
            stats["fabric"] = {f"{kind} {outcome}": n for (kind, outcome), n
                               in sorted(pf.messages.items())}
    del engine, pools
    torch.cuda.empty_cache()
    return {rid: r.tokens for rid, r in results.items()}, stats


def disagg_report(label, stats):
    busy = ", ".join(f"{name} {share:.4f}"
                     for name, share in stats["busy"].items())
    line = (f"engine disagg {label}: warm-up {stats['warmup_s']:.2f} s, "
            f"captures {json.dumps(stats['captures'])}, after warm-up "
            f"{json.dumps(stats['new_captures'])}; {stats['tokens']} tokens "
            f"in {stats['serve_s']:.3f} s = {stats['tokens_per_s']:.1f} "
            f"tokens/s over {stats['steps']} steps; TTFT p50 "
            f"{stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
            f"{stats['ttft_p95_s'] * 1e3:.1f} ms; TBT p50 "
            f"{stats['tbt_p50_s'] * 1e3:.3f} ms p99 "
            f"{stats['tbt_p99_s'] * 1e3:.3f} ms"
            + (" (decode pool)" if "migrations" in stats else "")
            + f"; dispatches {json.dumps(stats['dispatches'])}; busy share "
            f"over the serve (CUDA events): {busy}")
    if "migrations" in stats:
        line += (f"; migrations {stats['migrations']} packed / "
                 f"{stats['delivered']} delivered, {stats['migrated_bytes']} "
                 f"bytes; migration stall sum {stats['stall_sum_s']:.4f} s "
                 f"over {stats['stall_count']:.0f}; upload "
                 f"{stats['uploads']} x "
                 f"{stats['upload_ms'] / max(stats['uploads'], 1):.4f} ms "
                 f"(CUDA events); host s stage "
                 f"{stats['host_s']['stage']:.4f}, pack "
                 f"{stats['host_s']['pack']:.4f}, deliver "
                 f"{stats['host_s']['deliver']:.4f}; handoff retries "
                 f"{json.dumps(stats['retries'])}")
        if "fabric" in stats:
            line += f"; fabric {json.dumps(stats['fabric'])}"
    print(line)


def engine_disagg_phase(torch, device):
    """Disaggregated prefill/decode serving on the flagship: passes (a0)
    monolithic mixed=False (the oracle), (a1) monolithic mixed=True,
    (b) the two-cell router, (c) it over a loopback fabric, (d) (a0) and
    (b) with every fourth request sampled, (e) (a1) and (b) under Poisson
    arrivals at DISAGG_LOAD of (a1)'s tokens/s."""
    from kubeshare_tpu_torch.entry import entry, flagship_config

    config = flagship_config()
    _, (params, _) = entry()
    trace = disagg_trace(config)
    forced = [(rid, prompt, new) for rid, prompt, new, _ in trace]
    passes, launches = {}, []

    def run(label, *args, **kwargs):
        streams, stats = disagg_pass(torch, device, params, config, trace,
                                     *args, **kwargs)
        passes[label] = (streams, stats)
        launches.append(stats["launches"])
        disagg_report(label, stats)
        check(all(n == 0 for n in stats["new_captures"].values()),
              f"{label}: captures after warm-up {stats['new_captures']}")
        check(all(len(streams[rid]) == new for rid, _, new in forced),
              f"{label}: a stream has the wrong length")
        if "migrations" in stats:
            check(stats["migrations"] == stats["delivered"] > 0,
                  f"{label}: {stats['migrations']} migrations packed, "
                  f"{stats['delivered']} delivered")
        return streams, stats

    def forced_check(label, streams):
        worst = teacher_forced(torch, params, config, forced, streams, device)
        print(f"engine disagg {label} teacher-forced: worst emitted token "
              f"{worst:.4f} under its row's max (tol {ENGINE_TOKEN_MARGIN})")
        check(worst <= ENGINE_TOKEN_MARGIN,
              f"{label}: an emitted token lies {worst} under its row's max")

    def equal(label, streams, oracle_label):
        oracle = passes[oracle_label][0]
        same = sum(streams[rid] == oracle[rid] for rid, _, _ in forced)
        print(f"engine disagg {label}: streams equal to {oracle_label}: "
              f"{same}/{len(forced)}")
        return same == len(forced)

    a0, _ = run("(a0) monolithic mixed=False", False)
    a1, a1_stats = run("(a1) monolithic mixed=True", False, mixed=True)
    forced_check("(a1)", a1)
    b, b_stats = run("(b) two-cell router", True)
    forced_check("(b)", b)
    check(equal("(b)", b, "(a0) monolithic mixed=False"),
          "(b): the router's streams differ from the mixed=False engine's")
    check(b_stats["round_trip"] is True,
          f"(b): the migrated chain's bytes round trip: "
          f"{b_stats['round_trip']}")
    print("engine disagg (b) chain round trip: the decode pool's blocks of "
          "a migrated chain equal the prefill pool's as int16 words: True")
    c, _ = run("(c) two-cell router over a loopback fabric", True,
               fabric=True)
    forced_check("(c)", c)
    check(equal("(c)", c, "(a0) monolithic mixed=False"),
          "(c): the fabric router's streams differ from the mixed=False "
          "engine's")
    d0, _ = run("(d) monolithic mixed=False, sampled", False, sampled=True,
                top_k=DISAGG_TOP_K)
    d1, _ = run("(d) two-cell router, sampled", True, sampled=True,
                top_k=DISAGG_TOP_K)
    check(equal("(d) router, sampled", d1,
                "(d) monolithic mixed=False, sampled"),
          "(d): the sampled router's streams differ from the engine's")
    total_new = sum(new for _, _, new, _ in trace)
    mean_gap = total_new / (DISAGG_LOAD * a1_stats["tokens_per_s"]
                            * DISAGG_REQUESTS)
    print(f"engine disagg (e): mean inter-arrival {mean_gap * 1e3:.3f} ms = "
          f"{total_new} tokens / ({DISAGG_LOAD} x "
          f"{a1_stats['tokens_per_s']:.1f} tokens/s of (a1) x "
          f"{DISAGG_REQUESTS} requests)")
    e1, e1_stats = run("(e) monolithic mixed=True, Poisson", False,
                       mixed=True, mean_gap=mean_gap)
    forced_check("(e) monolithic", e1)
    e2, e2_stats = run("(e) two-cell router, Poisson", True,
                       mean_gap=mean_gap)
    forced_check("(e) router", e2)
    equal("(e) router", e2, "(a0) monolithic mixed=False")
    print(f"engine disagg (e) decode tail: TBT p99 {e2_stats['tbt_p99_s'] * 1e3:.3f}"
          f" ms on the decode pool against {e1_stats['tbt_p99_s'] * 1e3:.3f} "
          f"ms monolithic mixed (ratio "
          f"{e2_stats['tbt_p99_s'] / e1_stats['tbt_p99_s']:.4f}); tokens/s "
          f"{e2_stats['tokens_per_s']:.1f} against "
          f"{e1_stats['tokens_per_s']:.1f}; back to back TBT p99 "
          f"{b_stats['tbt_p99_s'] * 1e3:.3f} ms against "
          f"{a1_stats['tbt_p99_s'] * 1e3:.3f} ms")
    return {name: sum(counts[name] for counts in launches)
            for name in launches[0]}


def fleet_trace(config):
    """FLEET_REQUESTS (rid, prompt, new_tokens, unit_arrival) in
    build_fleet_workload's draw order (the family prefixes first, then per
    request its gap, its budget, and its family tail or its own prompt)."""
    import numpy as np

    rng = np.random.default_rng(FLEET_SEED)
    prefixes = [rng.integers(0, config.vocab_size, FLEET_PREFIX)
                for _ in range(FLEET_GROUPS)]
    trace, t = [], 0.0
    for i in range(FLEET_REQUESTS):
        t += float(rng.exponential(1.0))
        new = int(rng.integers(FLEET_NEW[0], FLEET_NEW[1] + 1))
        if rng.random() < FLEET_SHARED:
            g = int(rng.integers(0, FLEET_GROUPS))
            tail = rng.integers(0, config.vocab_size, int(
                rng.integers(FLEET_TAIL[0], FLEET_TAIL[1] + 1)))
            prompt = np.concatenate([prefixes[g], tail])
        else:
            prompt = rng.integers(0, config.vocab_size, int(
                rng.integers(FLEET_PROMPT[0], FLEET_PROMPT[1] + 1)))
        trace.append((f"req{i}", prompt, new, t))
    return trace


def fleet_pass(torch, trace, build, mean_gap=None, sampled=False,
               release=None, script=None):
    """One pass over ``trace``: ``build()`` makes a ServingEngine or a
    ReplicaFleet, warmed up, then :func:`serve` drives it;
    ``script(engine, base)`` runs after every step (passes (e) and (f): a
    replica the script adds records the captures of its own warm-up into
    ``base``).  Returns (streams, stats, engine)."""
    from kubeshare_tpu_torch.serving import ReplicaFleet
    from kubeshare_tpu_torch.serving.metrics_view import (
        flatten_metrics, hist_quantile, metric_histogram, metric_value)

    torch.cuda.synchronize()
    engine = build()
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    base = dict(engine.capture_counts())
    reset_counts()
    steps, serve_s = serve(
        torch, engine, trace, mean_gap, sampled, release,
        None if script is None else lambda eng: script(eng, base))
    launches = read_counts()
    metrics = flatten_metrics(engine.collect_metrics())
    results = {rid: engine.result(rid) for rid, _, _, _ in trace}
    check(all(r.done for r in results.values()), "a request did not finish")
    tokens = sum(len(r.tokens) for r in results.values())
    fleet = isinstance(engine, ReplicaFleet)
    pools = ({h.name: h.engine for h in engine.replicas} if fleet
             else {"mono": engine})
    device_ms = {name: pool.dispatch_device_ms()
                 for name, pool in pools.items()}
    counts = engine.capture_counts()

    def quantile(name, q):
        return hist_quantile(metric_histogram(metrics, name), q)

    stats = {
        "warmup_s": warmup_s, "serve_s": serve_s, "steps": steps,
        "tokens": tokens, "tokens_per_s": tokens / serve_s,
        "captures": sum(base.values()),
        "new_captures": {k: n - base.get(k, 0) for k, n in counts.items()
                         if n != base.get(k, 0)},
        "ttft_p50_s": quantile("kubeshare_serving_ttft_seconds", 0.5),
        "ttft_p95_s": quantile("kubeshare_serving_ttft_seconds", 0.95),
        "prefix_hit_tokens": metric_value(
            metrics, "kubeshare_serving_prefix_hit_tokens_total"),
        "busy": {name: sum(ms for _, ms in dev.values()) / (serve_s * 1e3)
                 for name, dev in device_ms.items()},
        "dispatches": {name: sum(n for n, _ in dev.values())
                       for name, dev in device_ms.items()},
        "launches": launches,
    }
    if fleet:
        stats["routing"] = {k: n for k, n in engine.routing_decisions.items()
                            if n}
        stats["owners"] = {h.name: sum(engine.owner_of(rid) == h.name
                                       for rid in results)
                           for h in engine.replicas}
    return {rid: r.tokens for rid, r in results.items()}, stats, engine


def fleet_report(label, stats):
    busy = ", ".join(f"{name} {share:.4f}"
                     for name, share in stats["busy"].items())
    line = (f"engine fleet {label}: warm-up {stats['warmup_s']:.2f} s, "
            f"{stats['captures']} captures, after warm-up "
            f"{json.dumps(stats['new_captures'])}; {stats['tokens']} tokens "
            f"in {stats['serve_s']:.3f} s = {stats['tokens_per_s']:.1f} "
            f"tokens/s over {stats['steps']} steps; TTFT p50 "
            f"{stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
            f"{stats['ttft_p95_s'] * 1e3:.1f} ms; prefix-hit tokens "
            f"{stats['prefix_hit_tokens']:.0f}; dispatches "
            f"{json.dumps(stats['dispatches'])}; busy share over the serve "
            f"(CUDA events): {busy}")
    if "routing" in stats:
        line += (f"; routing {json.dumps(stats['routing'])}, requests by "
                 f"replica {json.dumps(stats['owners'])}")
    print(line)


def drain_then_scale(trace):
    """(release, script, record) of passes (e) and (f): the first third of
    the trace arrives at once; r0 drains once half of it is done, the
    second third arrives while r0 drains (so only r1 takes it), and once
    r0 retired (its trie handed to r1) the fleet scales up and the last
    third arrives.  ``record`` keeps r1's tier promotions at r0's
    retirement, the scale-up's seconds and r2's warm-up captures."""
    third = len(trace) // 3
    record = {}

    def release(engine, i):
        if i < third:
            return True
        if i < 2 * third:
            return engine._handle("r0").state != "active"
        return len(engine.replicas) > 2

    def script(engine, base):
        r0 = engine._handle("r0")
        if r0.state == "active":
            done = sum(engine.result(rid).done
                       for rid, _, _, _ in trace[:third])
            if done >= third // 2:
                engine.drain("r0")
        elif r0.state == "retired" and len(engine.replicas) == 2:
            r1 = engine._handle("r1").engine
            record["r1_at_retire"] = (r1.tier_promoted_blocks,
                                      r1.tier_hit_requests)
            t0 = time.perf_counter()
            handle = engine.scale_up()
            record["scale_up_s"] = time.perf_counter() - t0
            record["r2_captures"] = dict(handle.engine.capture_counts())
            base.update({f"{handle.name}.{k}": n
                         for k, n in record["r2_captures"].items()})

    return release, script, record


def engine_fleet_phase(torch, device):
    """The replica fleet on the flagship: (a) monolithic engines back to
    back, (b) the affinity fleet back to back, (c) the control, the
    affinity and the round-robin fleet under Poisson arrivals, (d) a
    replica kill and its replay, (e) a drain then a scale-up over the
    shared tier, (f) (e) over a loopback fabric."""
    from kubeshare_tpu_torch.entry import entry, flagship_config
    from kubeshare_tpu_torch.serving import (EngineConfig, LoopbackTransport,
                                             ReplicaFleet, RoundRobinPolicy,
                                             ServingEngine)
    from kubeshare_tpu_torch.serving.chaos import FaultClock, FaultPlan

    config = flagship_config()
    _, (params, _) = entry()
    trace = fleet_trace(config)
    forced = [(rid, prompt, new) for rid, prompt, new, _ in trace]
    greedy = {rid for i, (rid, _, _) in enumerate(forced)
              if i % DISAGG_SAMPLE_EVERY}
    launches = []

    def mono(pool):
        return lambda: ServingEngine(params, config, EngineConfig(**pool),
                                     device=device)

    def fleet(pool=FLEET_REPLICA, top_k=None, **kwargs):
        return lambda: ReplicaFleet(
            params, config, EngineConfig(**pool, top_k=top_k),
            replicas=FLEET_REPLICAS, device=device, **kwargs)

    def run(label, build, **kwargs):
        streams, stats, engine = fleet_pass(torch, trace, build, **kwargs)
        launches.append(stats["launches"])
        fleet_report(label, stats)
        check(not stats["new_captures"],
              f"{label}: captures after warm-up {stats['new_captures']}")
        check(all(len(streams[rid]) == new for rid, _, new in forced),
              f"{label}: a stream has the wrong length")
        return streams, stats, engine

    def forced_check(label, streams, rids=None):
        rows = [r for r in forced if rids is None or r[0] in rids]
        worst = teacher_forced(torch, params, config, rows, streams, device)
        print(f"engine fleet {label} teacher-forced: worst emitted token "
              f"{worst:.4f} under its row's max over {len(rows)} greedy "
              f"streams (tol {ENGINE_TOKEN_MARGIN})")
        check(worst <= ENGINE_TOKEN_MARGIN,
              f"{label}: an emitted token lies {worst} under its row's max")

    def equal(label, streams, oracle, oracle_label):
        same = sum(streams[rid] == oracle[rid] for rid, _, _ in forced)
        print(f"engine fleet {label}: streams equal to {oracle_label}: "
              f"{same}/{len(forced)}")

    a0, a0_stats, _ = run("(a0) monolithic 12 slots / 161 blocks",
                          mono(FLEET_MONO))
    a1, _, _ = run("(a1) monolithic 6 slots / 81 blocks", mono(FLEET_REPLICA))
    b, _, _ = run("(b) fleet of 2 x (6 slots / 81 blocks), prefix affinity",
                  fleet())
    forced_check("(b)", b)
    equal("(b)", b, a0, "(a0)")
    equal("(b)", b, a1, "(a1)")

    total_new = sum(new for _, _, new, _ in trace)
    mean_gap = total_new / (FLEET_LOAD * a0_stats["tokens_per_s"]
                            * FLEET_REQUESTS)
    print(f"engine fleet (c): mean inter-arrival {mean_gap * 1e3:.3f} ms = "
          f"{total_new} tokens / ({FLEET_LOAD} x "
          f"{a0_stats['tokens_per_s']:.1f} tokens/s of (a0) x "
          f"{FLEET_REQUESTS} requests)")
    run("(c) monolithic 12 slots / 161 blocks, Poisson", mono(FLEET_MONO),
        mean_gap=mean_gap)
    c_aff, c_aff_stats, _ = run("(c) fleet, prefix affinity, Poisson",
                                fleet(), mean_gap=mean_gap)
    forced_check("(c) affinity", c_aff)
    _, c_rr_stats, _ = run("(c) fleet, round robin, Poisson",
                           fleet(routing=RoundRobinPolicy()),
                           mean_gap=mean_gap)
    check(c_aff_stats["prefix_hit_tokens"]
          >= c_rr_stats["prefix_hit_tokens"],
          "(c): prefix affinity recovered fewer prefix tokens than round "
          "robin")

    def chaos_fleet(plan):
        return fleet(dict(FLEET_REPLICA, num_blocks=FLEET_CHAOS_BLOCKS),
                     top_k=DISAGG_TOP_K, shared_tier_bytes=FLEET_CHAOS_TIER,
                     fault_clock=FaultClock(plan))

    d0, _, ref = run("(d) fault-free", chaos_fleet(
        FaultPlan(seed=FLEET_CHAOS_SEED)), sampled=True)
    check(not ref.replica_failures,
          f"(d): the fault-free run failed {ref.replica_failures}")
    r1_steps = ref.fault_clock._steps["r1"]
    kill_at = r1_steps // 2
    print(f"engine fleet (d): r1 took {r1_steps} steps fault-free; the "
          f"kill lands at its step {kill_at}")
    kills = []
    for label in ("(d) kill", "(d) kill replayed"):
        streams, _, killed = run(label, chaos_fleet(
            FaultPlan(seed=FLEET_CHAOS_SEED).kill("r1", at_step=kill_at)),
            sampled=True)
        kills.append(streams)
        check(killed.replica_failures == {"liveness": 1},
              f"{label}: failures {killed.replica_failures}")
        check(killed.orphans_readmitted > 0,
              f"{label}: no orphan was readmitted")
        print(f"engine fleet {label}: failures "
              f"{json.dumps(killed.replica_failures)}, orphans readmitted "
              f"{killed.orphans_readmitted}, salvaged "
              f"{killed.salvaged_tokens} of "
              f"{killed.salvage_candidate_tokens} candidate prefix tokens, "
              f"recovery {killed.recovery_durations[0] * 1e3:.3f} ms on the "
              f"fault clock, {killed.recovery_host_s * 1e3:.3f} ms host in "
              f"_recover_replica")
    check(kills[1] == kills[0],
          "(d): the replayed kill's streams differ from the kill's")
    equal("(d) kill", kills[0], d0, "(d) fault-free")
    forced_check("(d) kill", kills[0], greedy)

    drained = {}
    for label, fabric in (("(e) drain, scale up", False),
                          ("(f) drain, scale up, loopback fabric", True)):
        release, script, record = drain_then_scale(trace)
        streams, _, eng = run(label, fleet(
            shared_tier_bytes=FLEET_CHAOS_TIER,
            fabric=LoopbackTransport() if fabric else None),
            release=release, script=script)
        check(eng._handle("r0").state == "retired"
              and len(eng.replicas) == 3,
              f"{label}: r0 did not retire or the fleet did not grow")
        check(sum(record["r2_captures"].values()) > 0,
              f"{label}: r2 captured nothing at its warm-up")
        r1 = eng._handle("r1").engine
        promoted, hits = record["r1_at_retire"]
        line = (f"engine fleet {label}: drain {eng._drain_sum:.3f} s; "
                f"handoff {eng.handoff_blocks} device blocks in "
                f"{eng.handoff_host_s * 1e3:.3f} ms host; after r0 retired "
                f"r1 promoted {r1.tier_promoted_blocks - promoted} tier "
                f"blocks for {r1.tier_hit_requests - hits} requests "
                f"(r1's tier hits by origin over the pass "
                f"{json.dumps(r1.tier_hit_requests_by_origin)}); r2 warm-up "
                f"{record['scale_up_s']:.2f} s, "
                f"{sum(record['r2_captures'].values())} captures")
        if fabric:
            eps = list(eng._endpoints.values()) + [eng._fleet_ep]
            chains = {outcome: sum(ep.messages.get(("chain", outcome), 0)
                                   for ep in eps)
                      for outcome in ("sent", "delivered", "expired")}
            line += (f"; chain messages {json.dumps(chains)} (live "
                     f"endpoints and the fleet's), adopted "
                     f"{eng.fabric_adopted_tokens} tokens, expired chains "
                     f"{eng.fabric_expired_chains}")
        print(line)
        forced_check(label, streams)
        drained[fabric] = streams
    check(drained[True] == drained[False],
          "(f): the fabric fleet's streams differ from (e)'s")
    print("engine fleet (f): streams equal to (e): True")
    return {name: sum(counts[name] for counts in launches)
            for name in launches[0]}


def sharded_first_difference(torch, params, config, tp, device, prompt,
                             bs):
    """``prompt`` as one prefill chunk (blocks of ``bs`` rows) through the
    single-device paged step and through a tp-way context's twin over
    ``[device] * tp``, on fresh pools: the first layer whose K/V rows
    differ (None: none), the K/V max |difference| there, and the logits'
    max |difference| (0 and none where the card computes every product's
    output elements alike whatever the product's width or batch)."""
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec
    from kubeshare_tpu_torch.serving import ShardedServingContext
    from kubeshare_tpu_torch.serving.kv_blocks import init_paged_pool
    from kubeshare_tpu_torch.serving.paged import paged_prefill_step

    chunk = len(prompt)
    blocks = -(-chunk // bs)
    pool = init_paged_pool(config, blocks + 1, bs, device)
    ctx = ShardedServingContext(config, MeshSpec(dp=1, tp=tp), params,
                                devices=[device] * tp)
    ctx.place_params(params)
    pk, pv = ctx.place_pool(pool.k, pool.v)
    tables = torch.arange(1, blocks + 1, device=device)[None]
    tokens = torch.as_tensor(prompt, device=device)[None]
    one = torch.ones(1, dtype=torch.bool, device=device)
    start = torch.zeros(1, dtype=torch.int64, device=device)
    last = torch.full((1,), chunk - 1, dtype=torch.int64, device=device)
    with torch.no_grad():
        want = paged_prefill_step(params, config, pool.k, pool.v, tables,
                                  start, one, tokens, last)
        got = ctx.prefill_step(pk, pv, tables, start, one, tokens, last)
        k_got, v_got = pk.gather(), pv.gather()
    for layer in range(config.n_layers):
        diff = max(float((k_got[layer] - pool.k[layer]).abs().max()),
                   float((v_got[layer] - pool.v[layer]).abs().max()))
        if diff > 0:
            return layer, diff, float((got - want).abs().max())
    return None, 0.0, float((got - want).abs().max())


def batch_of_one_difference(torch, device, dtype):
    """The attention score product ``einsum("bhgqd,bhkd->bhgqk")`` of one
    (lane, KV head) matrix alone against the same matrix inside batches of
    two KV heads, and of two lanes against four: max |difference| of
    each (the products are equal in exact arithmetic)."""
    gen = torch.Generator().manual_seed(0)
    out = []
    for lanes in (1, 2):
        q = torch.randn(lanes, 2, 2, 8, 8, generator=gen).to(device, dtype)
        k = torch.randn(lanes, 2, 16, 8, generator=gen).to(device, dtype)
        whole = torch.einsum("bhgqd,bhkd->bhgqk", q, k)
        head = torch.einsum("bhgqd,bhkd->bhgqk", q[:, :1].contiguous(),
                            k[:, :1].contiguous())
        out.append(float((head - whole[:, :1]).abs().max()))
    return out


def engine_sharded_phase(torch, device, single_streams, single_stats):
    """Tensor-parallel serving on one card, every group naming it more
    than once: (a) the flagship at tp=2 over engine_trace, (b) tp=4 with
    the Ulysses route on every full prefill chunk, then a GQA variant
    (2 KV heads) in the replicated-KV fallback, (c) the MoE model at
    tp=2, (d) a dp=2 x tp=2 fleet.  Streams are held to the single-device
    engine's: bit-equal counted, every token teacher-forced within
    ENGINE_TOKEN_MARGIN (the MoE model's near-tie rows excused).
    Returns the path's kernel launches."""
    import numpy as np

    from kubeshare_tpu_torch.entry import entry, flagship_config
    from kubeshare_tpu_torch.models.transformer import transformer_init
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec
    from kubeshare_tpu_torch.serving import EngineConfig, ReplicaFleet

    config = flagship_config()
    _, (params, _) = entry()
    trace = engine_trace(config)
    short = trace[:SHARDED_SHORT]
    launches = []

    def describe(engine):
        return {"describe": engine._sharded.describe(),
                "collective_bytes": dict(engine.collective_bytes)}

    def held(label, streams, oracle, rows, params, config, moe=False):
        same = sum(streams[rid] == oracle[rid] for rid, _, _ in rows)
        if moe:
            forced = moe_teacher_forced(torch, params, config, rows, streams,
                                        device)
            print(f"engine sharded {label}: streams bit-equal to the "
                  f"single-device engine's {same}/{len(rows)}, the other "
                  f"{len(rows) - same} held teacher-forced:")
            moe_forced_report(f"sharded {label}", forced)
            return
        worst = teacher_forced(torch, params, config, rows, streams, device)
        print(f"engine sharded {label}: streams bit-equal to the "
              f"single-device engine's {same}/{len(rows)}, the other "
              f"{len(rows) - same} held teacher-forced; worst emitted token "
              f"{worst:.4f} under its row's max in the dense forward (tol "
              f"{ENGINE_TOKEN_MARGIN})")
        check(worst <= ENGINE_TOKEN_MARGIN,
              f"sharded {label}: an emitted token lies {worst} under its "
              "row's max")

    def sharded(label, params, config, rows, tp, oracle, moe=False,
                **overrides):
        streams, stats = engine_pass(
            torch, device, params, config, rows, after=describe,
            mesh_devices=[device] * tp, mesh_spec=MeshSpec(dp=1, tp=tp),
            **overrides)
        launches.append(stats["launches"])
        engine_report(f"sharded {label}", stats)
        print(f"engine sharded {label}: describe "
              f"{json.dumps(stats['describe'])}; estimated collective bytes "
              f"by kind {json.dumps(stats['collective_bytes'])}")
        check(stats["new_captures"] == 0,
              f"sharded {label}: {stats['new_captures']} captures after "
              "warm-up")
        check(all(len(streams[rid]) == new for rid, _, new in rows),
              f"sharded {label}: a stream has the wrong length")
        check(all(0 <= t < config.vocab_size for s in streams.values()
                  for t in s), f"sharded {label}: token ids out of range")
        check(stats["collective_bytes"]["prefill_chunk"] > 0
              and stats["collective_bytes"]["decode_span"] > 0,
              f"sharded {label}: no collective bytes counted")
        held(label, streams, oracle, rows, params, config, moe)
        return streams, stats

    def first_difference(label, params, config, tp, prompt,
                         bs=ENGINE_POOL["block_size"]):
        first, kv, logits = sharded_first_difference(
            torch, params, config, tp, device, prompt, bs)
        print(f"engine sharded {label} first difference: one "
              f"{len(prompt)}-token prefill chunk through the paged step "
              f"and the tp={tp} twin, K/V "
              + ("equal in every layer" if first is None
                 else f"first differ at layer {first} of {config.n_layers} "
                      f"(max |difference| {kv:.3e})")
              + f"; logits max |difference| {logits:.3e}")

    chunk = ENGINE_POOL["prefill_chunk"]
    for tp in (SHARDED_TP, SHARDED_ULYSSES_TP):
        first_difference(f"tp={tp}", params, config, tp, trace[0][1][:chunk])
    # the limit at f32: tests/test_torch_cuda.py's tiny GQA model (one KV
    # head a shard at tp=2), one 8-token chunk
    tiny = dataclasses.replace(config, vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq_len=64,
                               n_kv_heads=2, positional="rope",
                               dtype=torch.float32, attention="reference")
    tiny_params = transformer_init(tiny, torch.Generator().manual_seed(0),
                                   device)
    first_difference("f32 tiny GQA tp=2", tiny_params, tiny, 2,
                     np.arange(8) * 7 % 64, bs=4)
    for dtype in (torch.float32, torch.bfloat16):
        alone, pairs = batch_of_one_difference(torch, device, dtype)
        print(f"engine sharded batch-of-one check at {dtype}: one (lane, "
              f"KV head) score product alone vs inside a batch of two KV "
              f"heads, max |difference| {alone:.3e}; two lanes vs four "
              f"{pairs:.3e}")
    del tiny_params

    _, a = sharded(f"(a) flagship tp={SHARDED_TP}", params, config, trace,
                   SHARDED_TP, single_streams)
    print(f"engine sharded (a): {a['tokens_per_s']:.1f} tokens/s at "
          f"tp={SHARDED_TP} against {single_stats['tokens_per_s']:.1f} "
          f"single-device on the same card (ratio "
          f"{a['tokens_per_s'] / single_stats['tokens_per_s']:.4f}); both "
          f"shards run on this one card in turn, so no tensor-parallel "
          f"speed-up can show here")
    check(a["describe"]["attn_sharded"], "(a): attention is not sharded")

    _, b = sharded(f"(b) flagship tp={SHARDED_ULYSSES_TP}, "
                   f"long_context_threshold={ENGINE_POOL['prefill_chunk']}",
                   params, config, trace, SHARDED_ULYSSES_TP, single_streams,
                   long_context_threshold=ENGINE_POOL["prefill_chunk"])
    check(b["describe"]["attn_sharded"], "(b): attention is not sharded")
    gqa = dataclasses.replace(config, n_kv_heads=SHARDED_GQA_KV_HEADS)
    gqa_params = transformer_init(gqa, torch.Generator().manual_seed(0),
                                  device)
    gqa_single, _ = engine_pass(torch, device, gqa_params, gqa, short)
    _, b2 = sharded(f"(b) GQA {SHARDED_GQA_KV_HEADS} KV heads at "
                    f"tp={SHARDED_ULYSSES_TP}", gqa_params, gqa, short,
                    SHARDED_ULYSSES_TP, gqa_single)
    check(not b2["describe"]["attn_sharded"],
          "(b) GQA: kv_heads < tp did not take the replicated-KV fallback")
    del gqa_params

    fleet_rows = [(rid, prompt, new, 0.0) for rid, prompt, new in short]
    streams, stats, _ = fleet_pass(
        torch, fleet_rows,
        lambda: ReplicaFleet(
            params, config, EngineConfig(**ENGINE_POOL, mesh_spec=MeshSpec(
                dp=2, tp=SHARDED_TP, sp=1)),
            replicas=2, device=device, devices=[device] * (2 * SHARDED_TP)))
    launches.append(stats["launches"])
    fleet_report(f"sharded (d) dp=2 x tp={SHARDED_TP}", stats)
    check(not stats["new_captures"],
          f"sharded (d): captures after warm-up {stats['new_captures']}")
    check(all(len(streams[rid]) == new for rid, _, new in short),
          "sharded (d): a stream has the wrong length")
    held("(d) fleet", streams, single_streams, short, params, config)
    del params

    moe_config, moe_params, _, _ = train_setup(torch, device, MOE_DIMS)
    moe_short = engine_trace(moe_config)[:SHARDED_SHORT]
    moe_single, _ = engine_pass(torch, device, moe_params, moe_config,
                                moe_short)
    sharded(f"(c) moe tp={SHARDED_TP}", moe_params, moe_config, moe_short,
            SHARDED_TP, moe_single, moe=True)
    del moe_params
    torch.cuda.empty_cache()
    return {name: sum(counts[name] for counts in launches)
            for name in launches[0]}


def truncated_draft(config, params):
    """The speculative phase's cheap draft: the target's embedding, its
    first layer, its final norm and its lm_head — a one-layer model of
    the same width, with no weights of its own."""
    draft = {name: value for name, value in params.items()
             if name != "layers"}
    draft["layers"] = params["layers"][:1]
    return dataclasses.replace(config, n_layers=1), draft


def sampled_forced(torch, params, config, prompts, sampled):
    """Teacher-force speculative_sample_decode's streams through the
    dense forward: (the worst shortfall of a token's logit below its
    row's SPEC_TOP_K-th largest, the least log-probability, z of the
    tokens' scaled logits against their top-k means)."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply

    n = prompts.shape[1]
    with torch.no_grad():
        seqs = torch.cat([prompts, sampled[:, :-1]], dim=1)
        scaled = (transformer_apply(params, seqs, config)[:, n - 1:].float()
                  / SPEC_TEMPERATURE)
    margin = ENGINE_TOKEN_MARGIN / SPEC_TEMPERATURE
    kth = scaled.topk(SPEC_TOP_K, dim=-1).values[..., -1:]
    picked = scaled.gather(-1, sampled[..., None])[..., 0]
    shortfall = float((kth[..., 0] - picked).max()) * SPEC_TEMPERATURE
    relaxed = scaled.masked_fill(scaled < kth - margin, float("-inf"))
    least = float((picked - relaxed.logsumexp(dim=-1)).min())
    p = scaled.masked_fill(scaled < kth, float("-inf")).softmax(dim=-1)
    kept = scaled.masked_fill(p == 0, 0.0)
    mean = (p * kept).sum(dim=-1)
    variance = (p * kept * kept).sum(dim=-1) - mean ** 2
    z = float((picked - mean).sum() / variance.sum().sqrt())
    return shortfall, least, z


def speculative_phase(torch, device):
    """Dense draft-model speculation on the serving flagship: SPEC_REQUESTS
    prompts of SPEC_PROMPT tokens, SPEC_NEW greedy tokens each, draft_len
    SPEC_DRAFT_LEN, with a self-draft and with the truncated draft, each
    round one CUDA graph replay; then speculative_sample_decode once.
    Held to the eager rounds (equal tokens) and teacher-forced against
    the dense forward.  Returns the kernel launches of the path."""
    from kubeshare_tpu_torch.entry import entry, flagship_config
    from kubeshare_tpu_torch.models import decoding

    config = flagship_config()
    _, (params, _) = entry()
    gen = torch.Generator().manual_seed(11)
    prompts = torch.randint(0, config.vocab_size,
                            (SPEC_REQUESTS, SPEC_PROMPT), generator=gen
                            ).to(device)
    drafts = {"self": (config, params),
              "truncated": truncated_draft(config, params)}
    runs = {}
    reset_counts()
    for name, (dconfig, dparams) in drafts.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, stats = decoding.speculative_greedy_decode(
            params, config, dparams, dconfig, prompts, SPEC_NEW,
            draft_len=SPEC_DRAFT_LEN, return_stats=True, capture=True)
        torch.cuda.synchronize()
        runs[name] = (tokens, stats["rounds"], time.perf_counter() - t0)
    sgen = torch.Generator(device=device).manual_seed(12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampled, sample_stats = decoding.speculative_sample_decode(
        params, config, drafts["truncated"][1], drafts["truncated"][0],
        prompts, sgen, SPEC_NEW, draft_len=SPEC_DRAFT_LEN,
        temperature=SPEC_TEMPERATURE, top_k=SPEC_TOP_K, return_stats=True)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = read_counts()
    flash = launches["flash_fwd"]
    # both prefills of all three calls run the flash forward a layer
    # each: the self-draft's, then the truncated draft's twice
    expected = 2 * config.n_layers + 2 * (config.n_layers + 1)
    check(flash == expected,
          f"the speculative path launched the flash forward {flash} times, "
          f"expected {expected}")
    check(tuple(sampled.shape) == (SPEC_REQUESTS, SPEC_NEW)
          and bool(((sampled >= 0) & (sampled < config.vocab_size)).all()),
          "speculative sampling's tokens are out of shape or range")

    trace = [(f"spec{i}", prompts[i].tolist(), SPEC_NEW)
             for i in range(SPEC_REQUESTS)]
    for name, (dconfig, dparams) in drafts.items():
        tokens, rounds, serve_s = runs[name]
        # the captured round's device time beside its host enqueue
        state = decoding.speculative_state(params, config, dparams, dconfig,
                                           prompts, SPEC_NEW, SPEC_DRAFT_LEN)
        step = decoding.make_speculative_round(
            params, config, dparams, dconfig, state, SPEC_NEW,
            SPEC_DRAFT_LEN, capture=True)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(SPEC_TIMED_ROUNDS)]
        enqueue = []
        torch.cuda.synchronize()
        for start, end in events:
            t0 = time.perf_counter()
            start.record()
            step()
            end.record()
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        round_ms = steady_median([a.elapsed_time(b) for a, b in events])
        del state, step
        eager, eager_stats = decoding.speculative_greedy_decode(
            params, config, dparams, dconfig, prompts, SPEC_NEW,
            draft_len=SPEC_DRAFT_LEN, return_stats=True)
        same = bool(torch.equal(eager, tokens))
        streams = {rid: tokens[i].tolist() for i, (rid, _, _) in
                   enumerate(trace)}
        worst = teacher_forced(torch, params, config, trace, streams, device)
        print(f"speculative {name} draft ({dconfig.n_layers} layer(s)), "
              f"{SPEC_REQUESTS} x ({SPEC_PROMPT} + {SPEC_NEW}), draft_len "
              f"{SPEC_DRAFT_LEN}: {rounds} rounds = "
              f"{(SPEC_NEW - 1) / rounds:.3f} tokens a round after the "
              f"first; serve {serve_s * 1e3:.1f} ms captured; round "
              f"{round_ms:.4f} ms (CUDA events, median of "
              f"{SPEC_TIMED_ROUNDS}) / enqueue {steady_median(enqueue):.4f} "
              f"ms (host); eager rounds {eager_stats['rounds']}, captured "
              f"tokens equal eager: {same}; teacher-forced worst "
              f"{worst:.4f} (tol {ENGINE_TOKEN_MARGIN})")
        check(same, f"the {name} draft's captured tokens differ from eager")
        check(worst <= ENGINE_TOKEN_MARGIN,
              f"a speculative token lies {worst} under its row's max")
    check(runs["self"][1] < SPEC_NEW,
          f"the self-draft took {runs['self'][1]} rounds for {SPEC_NEW} "
          "tokens")
    shortfall, least, z = sampled_forced(torch, params, config, prompts,
                                         sampled)
    print(f"speculative sample (truncated draft, T {SPEC_TEMPERATURE}, "
          f"top_k {SPEC_TOP_K}): {sample_stats['rounds']} rounds, "
          f"{sample_s * 1e3:.1f} ms eager; teacher-forced: worst shortfall "
          f"below the row's top_k-th logit {shortfall:.4f} (tol "
          f"{ENGINE_TOKEN_MARGIN}), least log-probability {least:.3f} "
          f"(floor {SPEC_LOGP_FLOOR:.3f}), scaled logits against their "
          f"top-k means z = {z:.3f} (tol {SPEC_LOGIT_Z}); flash "
          f"forward launches on the path {flash}")
    check(shortfall <= ENGINE_TOKEN_MARGIN,
          f"a sampled token lies {shortfall} under its row's top_k-th logit")
    check(least >= SPEC_LOGP_FLOOR,
          f"a sampled token has log-probability {least}")
    check(abs(z) <= SPEC_LOGIT_Z,
          f"the sampled tokens' logits sum {z} standard errors from their "
          "top-k means")
    return launches


def engine_spec_phase(torch, device, plain_streams):
    """The speculative ServingEngine on the flagship over engine_trace:
    speculative with steps_per_launch 1 (verify and mixed_verify), then
    steps_per_launch 4 with an admission ring of 2 (the speculative
    loop), then the first behind an ExecutionGuard."""
    from kubeshare_tpu_torch.entry import entry, flagship_config
    from kubeshare_tpu_torch.isolation import ExecutionGuard

    config = flagship_config()
    _, (params, _) = entry()
    trace = engine_trace(config)
    passes = {}
    for label, overrides in (
            ("speculative", ENGINE_SPEC),
            ("speculative steps_per_launch=4 admission_ring=2",
             dict(ENGINE_SPEC, steps_per_launch=4, admission_ring=2))):
        streams, stats = engine_pass(torch, device, params, config, trace,
                                     **overrides)
        passes[label] = (streams, stats)
        engine_report(label, stats)
        worst = teacher_forced(torch, params, config, trace, streams, device)
        equal = sum(streams[rid] == plain_streams[rid] for rid, _, _ in trace)
        drafted, accepted = stats["spec_drafted"], stats["spec_accepted"]
        print(f"engine {label} speculation: verify steps "
              f"{stats['verify_steps']} ({stats['mixed_verify_steps']} "
              f"mixed), accepted/drafted {accepted}/{drafted} = "
              f"{accepted / max(drafted, 1):.4f}, per-round acceptance "
              f"histogram (le 0.125 .. 1, +Inf) {stats['spec_accept_hist']}; "
              f"spec loop launches {stats['spec_loop_launches']} "
              f"({stats['spec_loop_units']} units, realised depth "
              f"{stats['loop_depth']:.3f}), exit reasons "
              + json.dumps(stats["loop_exit_reasons"])
              + f", ring activations {stats['ring_activations']}; "
              f"teacher-forced worst {worst:.4f} (tol "
              f"{ENGINE_TOKEN_MARGIN}); streams equal to speculation off: "
              f"{equal}/{len(trace)} = {equal / len(trace):.4f}")
        check(stats["new_captures"] == 0,
              f"{label}: {stats['new_captures']} captures after warm-up")
        check(worst <= ENGINE_TOKEN_MARGIN,
              f"{label}: an emitted token lies {worst} under its row's max")
        check(all(len(streams[rid]) == new for rid, _, new in trace),
              f"{label}: a stream has the wrong length")
        check(stats["verify_steps"] > 0, f"{label}: no verify dispatch ran")
    loop_stats = passes["speculative steps_per_launch=4 admission_ring=2"][1]
    check(loop_stats["spec_loop_launches"] > 0,
          "the speculative loop never launched")

    class GrantAll:
        """A broker that grants every request in full."""

        def acquire(self, estimate_ms):
            return 1e9

        def release(self, used_ms):
            pass

    guard = ExecutionGuard(client=GrantAll(), from_env=False,
                           idle_release_ms=0)
    guarded_streams, guarded = engine_pass(torch, device, params, config,
                                           trace, guard=guard, **ENGINE_SPEC)
    streams, stats = passes["speculative"]
    device_total = sum(ms for _, ms in guarded["device_ms"].values())
    print(f"engine speculative under an ExecutionGuard: "
          f"{guarded['tokens_per_s']:.1f} tokens/s; charged "
          f"{guard.total_gated_ms:.1f} ms for {device_total:.1f} ms of "
          f"dispatches by CUDA events = "
          f"{guard.total_gated_ms / device_total:.4f}; {guarded['new_captures']}"
          f" captures after warm-up; streams equal the unguarded run: "
          f"{guarded_streams == streams}")
    check(guarded["new_captures"] == 0,
          "the guarded speculative engine captured after warm-up")
    check(guarded_streams == streams, "guarded speculative streams differ")
    return stats["launches"]


def train_setup(torch, device, dims=TRAIN_DIMS, **overrides):
    """The train-step flagship's (or another ``dims``') config, params
    (seed 0) and fixed batch (seed 11)."""
    from kubeshare_tpu_torch.models.transformer import (
        TransformerConfig, transformer_init)

    config = TransformerConfig(**{**dims, "positional": "rope",
                                  "dtype": torch.bfloat16,
                                  "attention": "flash", **overrides})
    params = transformer_init(config, torch.Generator().manual_seed(0), device)
    gen = torch.Generator().manual_seed(11)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    tokens = torch.randint(0, config.vocab_size, shape, generator=gen).to(device)
    targets = torch.randint(0, config.vocab_size, shape, generator=gen).to(device)
    return config, params, tokens, targets


def train_phase(torch, device):
    """Ten AdamW steps of the train-step flagship on a fixed batch."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply
    from kubeshare_tpu_torch.parallel.train import (
        cross_entropy_loss, make_train_step, tree_leaves)

    config, params, tokens, targets = train_setup(torch, device)
    plain = dataclasses.replace(config, attention="reference")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)

    # (a) step 1's loss and gradients against attention="reference"
    def loss_and_grads(cfg):
        loss = cross_entropy_loss(transformer_apply(params, tokens, cfg), targets)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss, grads = loss_and_grads(config)
    reset_counts()
    remat_loss, remat_grads = loss_and_grads(
        dataclasses.replace(config, remat=True))
    remat_launches = read_counts()
    remat_err = max(rel_err(g, r) for g, r in zip(remat_grads, grads))
    del remat_grads
    print(f"train remat: launches {remat_launches} for one forward + "
          f"backward, loss {float(remat_loss):.5f}, worst grad "
          f"max-abs-err/max-ref vs remat off {remat_err:.3e}")
    check(remat_launches == {**only(), "flash_fwd": 2 * config.n_layers,
                             "flash_bwd_dkv": config.n_layers,
                             "flash_bwd_dq": config.n_layers},
          f"remat launched {remat_launches}: expected the forward twice "
          f"per layer and each backward kernel once")
    check(remat_err <= REMAT_GRAD_RTOL,
          f"remat gradients differ from remat off by {remat_err} of max")
    plain_loss, plain_grads = loss_and_grads(plain)
    loss_err = abs(float(loss) - float(plain_loss))
    grad_err = max(rel_err(g, r) for g, r in zip(grads, plain_grads))
    cosine = min(float(torch.nn.functional.cosine_similarity(
        g.float().flatten(), r.float().flatten(), dim=0))
        for g, r in zip(grads, plain_grads))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    del grads, plain_grads
    print(f"train grads vs attention=reference ({len(leaves)} tensors): "
          f"loss {float(loss):.5f} vs {float(plain_loss):.5f} (abs err "
          f"{loss_err:.3e}), worst grad max-abs-err/max-ref {grad_err:.3e}, "
          f"lowest cosine {cosine:.6f}")
    check(finite, "non-finite gradients on the train path")
    check(loss_err <= TRAIN_LOSS_ATOL,
          f"train loss differs from the plain path by {loss_err}")
    check(grad_err <= TRAIN_GRAD_RTOL,
          f"train gradients differ from the plain path by {grad_err} of max")
    check(cosine >= TRAIN_GRAD_MIN_COSINE,
          f"a train gradient points elsewhere than the plain path's "
          f"(cosine {cosine})")

    # (b)-(d) ten steps through make_train_step, counted and timed
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config))
    state = init_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(TRAIN_STEPS)]
    losses, enqueue_ms = [], []
    reset_counts()
    for i, (start, end) in enumerate(events):
        t0 = time.perf_counter()
        start.record()
        state, step_loss = train_step(state, tokens, targets)
        end.record()
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(step_loss)
        if i == 0:
            first = read_counts()
            check(first == {name: n * config.n_layers for name, n in
                             only("flash_fwd", "flash_bwd_dkv",
                                  "flash_bwd_dq").items()},
                  f"train step 1 launched {first}, expected {config.n_layers} "
                  f"of each kernel")
    launches = read_counts()
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    median_ms = steady_median(step_ms)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops_per_token(TRAIN_DIMS, TRAIN_SEQ) * tokens_per_step
    share = flops / (median_ms * 1e-3) / PEAK_FLOPS["bfloat16"]
    # the host's time to enqueue a step (it never waits for the device):
    # close to the step's device time means the host sets the pace
    host_median_ms = steady_median(enqueue_ms)
    print(f"train losses: " + " ".join(f"{x:.4f}" for x in losses))
    print(f"train host enqueue ms per step: "
          + " ".join(f"{x:.2f}" for x in enqueue_ms)
          + f"; median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS} {host_median_ms:.3f}")
    print(f"train {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
          f"launches {launches}, step ms " + " ".join(f"{x:.2f}" for x in step_ms)
          + f"; median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS} "
          f"{median_ms:.3f} ms, {tokens_per_step / (median_ms * 1e-3):.0f} "
          f"tokens/s, {flops / 1e12:.3f} TFLOP per step = {share:.4f} of "
          f"989 TFLOP/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == {name: n * TRAIN_STEPS * config.n_layers for name, n in
                       only("flash_fwd", "flash_bwd_dkv",
                            "flash_bwd_dq").items()},
          f"train path launched {launches}, expected "
          f"{TRAIN_STEPS * config.n_layers} of each kernel")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(abs(losses[0] - float(loss)) <= TRAIN_LOSS_ATOL,
          f"train step 1 loss {losses[0]} differs from the checked {float(loss)}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    eager = {"losses": losses, "params": tree_leaves(state.params),
             "median_ms": median_ms, "host_median_ms": host_median_ms}
    return launches, eager


def steady_median(values):
    """The median of steps TRAIN_TIMED_FROM.. (1-based): past warm-up."""
    tail = sorted(values[TRAIN_TIMED_FROM - 1:])
    return (tail[(len(tail) - 1) // 2] + tail[len(tail) // 2]) / 2


def timed_steps(torch, train_step, state, batches):
    """Run ``train_step`` over ``batches`` ((inputs, targets) pairs, drawn
    as the loop goes); returns (state, losses, CUDA-event ms per step,
    host enqueue ms per step).  The host never waits for the device
    inside the loop."""
    events, losses, enqueue_ms = [], [], []
    for inputs, targets in batches:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        events.append((start, end))
        t0 = time.perf_counter()
        start.record()
        state, loss = train_step(state, inputs, targets)
        end.record()
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    torch.cuda.synchronize()
    return (state, [float(x) for x in losses],
            [a.elapsed_time(b) for a, b in events], enqueue_ms)


def update_errors(final, reference, initial):
    """Per tensor, |final - reference| / |reference - initial| (norms:
    the difference of two runs over the reference run's whole update),
    the worst of them, and the largest element difference."""
    worst, max_abs = 0.0, 0.0
    for got, ref, first in zip(final, reference, initial):
        diff = (got.detach().float() - ref.detach().float())
        update = (ref.detach().float() - first.float()).norm()
        worst = max(worst, float(diff.norm() / update.clamp_min(1e-30)))
        max_abs = max(max_abs, float(diff.abs().max()))
    return worst, max_abs


def trajectory_errors(run, reference, initial):
    """(step 1's loss |diff|, the largest loss |diff|, the worst update
    error, the largest parameter |diff|) of ``run`` against
    ``reference``, each (losses, parameters)."""
    first = abs(run[0][0] - reference[0][0])
    loss_err = max(abs(a - b) for a, b in zip(run[0], reference[0]))
    update_err, max_abs = update_errors(run[1], reference[1], initial)
    return first, loss_err, update_err, max_abs


def capturable_adamw(device):
    """adamw(1e-3) switched to its capturable mode, as the captured step
    switches it: the optimizer of the eager run held to the captured."""
    from kubeshare_tpu_torch.parallel.train import _make_capturable, adamw

    def make(leaves):
        optimizer = adamw(1e-3)(leaves)
        _make_capturable(optimizer, device)
        return optimizer
    return make


def hold_drift(what, run, reference, initial, limits, must_pass=True,
               first_atol=CAPTURE_SAME_LOSS_ATOL):
    """``run`` against ``reference`` (each (losses, parameters)): step 1's
    loss at ``first_atol``, the run at ``limits`` (loss, update).  A
    control passes ``must_pass=False``: the limits must refuse it."""
    first, loss_err, update_err, max_abs = trajectory_errors(
        run, reference, initial)
    print(f"{what}: step 1 loss abs err {first:.3e} (tol "
          f"{first_atol:g}), max {loss_err:.3e} (tol "
          f"{limits[0]:g}), params worst |diff| / |update| "
          f"{update_err:.3e} (tol {limits[1]:g}), max abs diff "
          f"{max_abs:.3e}")
    within = (first <= first_atol and loss_err <= limits[0]
              and update_err <= limits[1])
    check(within == must_pass,
          f"{what}: " + ("outside the limits" if must_pass
                         else "the limits do not refuse the control")
          + f" (step 1 {first}, loss {loss_err}, update {update_err})")


def hold_captured(label, captured, same, default, initial,
                  drift_loss_atol, drift_update_rtol):
    """The captured run's (losses, parameters) against the eager run with
    the same optimizer (limits at CAPTURE_SAME_*) and against the default
    eager run (step 1 at CAPTURE_SAME_LOSS_ATOL, then the drift limits)."""
    check(all(math.isfinite(x) for x in captured[0]),
          f"{label}: non-finite loss {captured[0]}")
    hold_drift(f"{label} captured vs eager with the same optimizer",
               captured, same, initial,
               (CAPTURE_SAME_LOSS_ATOL, CAPTURE_SAME_UPDATE_RTOL))
    hold_drift(f"{label} captured vs eager with the default AdamW",
               captured, default, initial,
               (drift_loss_atol, drift_update_rtol))


def capture_phase(torch, device, eager):
    """The train-step flagship's 10 steps through make_train_step(...,
    capture=True) from the train phase's initial state and batch, held
    against an eager run with the same optimizer and the train phase's
    default eager run; the launch counters read around the capture
    (replays do not bump them)."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply
    from kubeshare_tpu_torch.parallel.train import (
        CAPTURE_WARMUP_STEPS, make_train_step, tree_leaves)

    def setup(capture):
        config, params, tokens, targets = train_setup(torch, device)
        init_state, train_step = make_train_step(
            lambda p, t: transformer_apply(p, t, config),
            optimizer=None if capture else capturable_adamw(device),
            capture=capture)
        return (config, init_state(params), train_step,
                [(tokens, targets)] * TRAIN_STEPS)

    config, state, train_step, batches = setup(capture=False)
    initial = [leaf.detach().clone() for leaf in tree_leaves(state.params)]
    state, same_losses, _, _ = timed_steps(torch, train_step, state, batches)
    same = (same_losses, tree_leaves(state.params))
    del state, train_step
    config, state, train_step, batches = setup(capture=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, losses, step_ms, enqueue_ms = timed_steps(torch, train_step,
                                                     state, batches)
    launches = read_counts()
    passes = (CAPTURE_WARMUP_STEPS + 1) * config.n_layers
    check(launches == {name: n * passes for name, n in
                       only("flash_fwd", "flash_bwd_dkv",
                            "flash_bwd_dq").items()},
          f"captured train path launched {launches}, expected {passes} of "
          f"each kernel ({CAPTURE_WARMUP_STEPS} warm-up passes and the "
          f"capture, {config.n_layers} layers; replays bump no counter)")
    median_ms, host_ms = steady_median(step_ms), steady_median(enqueue_ms)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    print(f"train captured losses: " + " ".join(f"{x:.4f}" for x in losses))
    print(f"train captured {TRAIN_STEPS} steps (step 1 = {CAPTURE_WARMUP_STEPS} "
          f"warm-up steps + capture + replay): launches {launches}, step ms "
          + " ".join(f"{x:.2f}" for x in step_ms)
          + f"; host enqueue ms " + " ".join(f"{x:.3f}" for x in enqueue_ms))
    print(f"train step, median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS}: "
          f"captured {median_ms:.3f} ms (CUDA events), enqueue "
          f"{host_ms:.3f} ms, {tokens_per_step / (median_ms * 1e-3):.0f} "
          f"tokens/s; eager {eager['median_ms']:.3f} ms, enqueue "
          f"{eager['host_median_ms']:.3f} ms; captured / eager "
          f"{median_ms / eager['median_ms']:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    hold_captured("train", (losses, tree_leaves(state.params)), same,
                  (eager["losses"], eager["params"]), initial,
                  CAPTURE_DRIFT_LOSS_ATOL, CAPTURE_DRIFT_UPDATE_RTOL)
    guard_check(torch, train_step, state, batches[0], median_ms)
    return launches, {"median_ms": median_ms, "host_median_ms": host_ms,
                      "losses": losses}


def guard_check(torch, train_step, state, batch, step_ms):
    """GUARD_STEPS captured steps through an ExecutionGuard, the step
    returning only its TrainState: the guard must charge at least
    GUARD_MIN_SHARE of the step's CUDA-event time ``step_ms`` a step."""
    from kubeshare_tpu_torch.isolation import ExecutionGuard

    class GrantAll:
        """A broker that grants every request in full."""

        def acquire(self, estimate_ms):
            return 1e9

        def release(self, used_ms):
            pass

    guard = ExecutionGuard(client=GrantAll(), from_env=False,
                           idle_release_ms=0)
    gated = guard(lambda s: train_step(s, *batch)[0])
    torch.cuda.synchronize()
    for _ in range(GUARD_STEPS):
        state = gated(state)
    charged_ms = guard.total_gated_ms / GUARD_STEPS
    print(f"guard around the captured step returning its state: charged "
          f"{charged_ms:.3f} ms a step, {charged_ms / step_ms:.4f} of the "
          f"step's {step_ms:.3f} ms (tol >= {GUARD_MIN_SHARE})")
    check(charged_ms >= GUARD_MIN_SHARE * step_ms,
          f"the guard charged {charged_ms} ms a step for a {step_ms} ms "
          "device burst: it did not wait for the step's device")


def mnist_phase(torch, device):
    """MNIST (the co-run's workload, batch 512, weights converted from a
    numpy tree) on the card: its logits against the CPU's, and
    MNIST_STEPS captured train steps against eager ones, timed."""
    import numpy as np

    from kubeshare_tpu_torch.convert import params_from_jax
    from kubeshare_tpu_torch.models.mnist import mnist_apply, mnist_init
    from kubeshare_tpu_torch.parallel.train import (
        cross_entropy_loss, make_train_step, tree_leaves)

    tree = mnist_init(torch.Generator().manual_seed(0), device="cpu")
    weights = {layer: {name: leaf.numpy() for name, leaf in leaves.items()}
               for layer, leaves in tree.items()}
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal(
        (8192, 28, 28, 1), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (8192,), dtype=np.int64))
    starts = [torch.tensor(int(s), device=device) for s in
              rng.integers(0, 8192 - MNIST_BATCH, MNIST_STEPS)]

    with torch.no_grad():
        cpu_logits = mnist_apply(tree, images[:MNIST_BATCH])
        logits = mnist_apply(params_from_jax(weights, device),
                             images[:MNIST_BATCH].to(device)).cpu()
    logits_err = float((logits - cpu_logits).abs().max())
    print(f"mnist logits {tuple(logits.shape)} on the card vs the CPU: max "
          f"abs err {logits_err:.3e} (tol {MNIST_LOGITS_ATOL}; |logits| up "
          f"to {float(cpu_logits.abs().max()):.2f})")
    check(logits_err <= MNIST_LOGITS_ATOL,
          f"MNIST logits on the card differ from the CPU's by {logits_err}")

    images, labels = images.to(device), labels.to(device)
    rows = torch.arange(MNIST_BATCH, device=device)

    def run(capture=False, optimizer=None):
        init_state, train_step = make_train_step(
            lambda p, start: mnist_apply(
                p, images.index_select(0, start + rows)),
            loss_fn=lambda logits, start: cross_entropy_loss(
                logits, labels.index_select(0, start + rows)),
            optimizer=optimizer, capture=capture)
        state = init_state(params_from_jax(weights, device))
        state, losses, step_ms, enqueue_ms = timed_steps(
            torch, train_step, state, [(s, s) for s in starts])
        return (losses, tree_leaves(state.params)), step_ms, enqueue_ms

    default, eager_ms, eager_enqueue = run()
    same, _, _ = run(optimizer=capturable_adamw(device))
    captured, step_ms, enqueue_ms = run(capture=True)
    print(f"mnist {MNIST_STEPS} steps of batch {MNIST_BATCH}: captured "
          "losses " + " ".join(f"{x:.5f}" for x in captured[0]))
    print(f"mnist step, median of steps {TRAIN_TIMED_FROM}-{MNIST_STEPS}: "
          f"captured {steady_median(step_ms):.4f} ms (CUDA events), "
          f"enqueue {steady_median(enqueue_ms):.4f} ms; eager "
          f"{steady_median(eager_ms):.4f} ms, enqueue "
          f"{steady_median(eager_enqueue):.4f} ms")
    hold_captured("mnist", captured, same, default,
                  [torch.from_numpy(leaf).to(device)
                   for leaf in tree_leaves(weights)],
                  MNIST_DRIFT_LOSS_ATOL, MNIST_DRIFT_UPDATE_RTOL)


def hbm_cap_phase():
    """apply_hbm_cap at TPUSHARE_MEM_FRACTION=0.5 in a child process (the
    fraction is process-wide): 0.4 of the card allocates, 0.6 raises
    torch.OutOfMemoryError."""
    import os
    import textwrap

    code = textwrap.dedent("""
        import json, torch
        from kubeshare_tpu_torch.isolation import apply_hbm_cap
        fraction = apply_hbm_cap()
        total = torch.cuda.get_device_properties(0).total_memory
        held = torch.empty(int(0.4 * total), dtype=torch.uint8, device="cuda")
        del held
        try:
            torch.empty(int(0.6 * total), dtype=torch.uint8, device="cuda")
            refused = None
        except torch.OutOfMemoryError as e:
            refused = str(e).splitlines()[0]
        print(json.dumps({"fraction": fraction, "total": total,
                          "refused": refused}))
    """)
    env = dict(os.environ, TPUSHARE_MEM_FRACTION="0.5")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"HBM cap child failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"hbm cap at TPUSHARE_MEM_FRACTION=0.5: apply_hbm_cap returned "
          f"{result['fraction']}; 0.4 of {result['total'] / 2**30:.2f} GiB "
          f"allocated; 0.6 refused: {result['refused']}")
    check(result["fraction"] == 0.5,
          f"apply_hbm_cap returned {result['fraction']}, expected 0.5")
    check(result["refused"] is not None,
          "0.6 of the card was allocated under a 0.5 cap")


def corun_phase():
    """corun_bench.py's four phases (solo A, solo B, the co-run, the
    adversarial pair) at CORUN_SECONDS windows: each phase must produce
    a result and every pod must be granted tokens.  The ratio and the
    adversarial flags are reported, not gated."""
    import corun_bench

    t0 = time.perf_counter()
    result = corun_bench.run_suite(corun_bench.ensure_tokend(),
                                   seconds=CORUN_SECONDS)
    detail = result["detail"]
    tokens = detail["tokens"]
    print(f"corun ratio {result['value']:.4f} ({CORUN_SECONDS:g} s windows, "
          f"{time.perf_counter() - t0:.1f} s in all): solo steps/s "
          f"{detail['solo_a_steps_per_s']:.2f} + "
          f"{detail['solo_b_steps_per_s']:.2f}, co-run "
          + " + ".join(f"{r:.2f}" for r in detail["corun_steps_per_s"])
          + f" = {detail['corun_aggregate_steps_per_s']:.2f}; solo step ms "
          f"{detail['solo_step_ms']}; tokens {json.dumps(tokens)}; "
          f"breakdown_ms {json.dumps(detail['breakdown_ms'])}; adversarial "
          f"{json.dumps(detail['adversarial'])}")
    granted = [tokens["solo_a"], tokens["solo_b"], *tokens["corun"],
               *tokens["adversarial"]]
    check(all(n > 0 for n in granted), f"a pod was granted no token: {tokens}")


def corun_serve_phase():
    """corun_bench.py's serve suite (solo A, solo B, the co-run of two
    decode pods, each request a prefill and 64 greedy tokens through the
    captured decode step) at CORUN_SECONDS windows: each phase must
    produce a result and every pod must be granted tokens.  The ratio and
    the latencies are reported, not gated."""
    import corun_bench

    t0 = time.perf_counter()
    result = corun_bench.run_serve_suite(corun_bench.ensure_tokend(),
                                         seconds=CORUN_SECONDS)
    detail = result["detail"]
    tokens = detail["tokens"]
    print(f"corun serve ratio {result['value']:.4f} ({CORUN_SECONDS:g} s "
          f"windows, {time.perf_counter() - t0:.1f} s in all): solo "
          "tokens/s " + " + ".join(f"{x:.1f}" for x in
                                   detail["solo_tokens_per_s"])
          + ", co-run " + " + ".join(f"{x:.1f}" for x in
                                     detail["corun_tokens_per_s"])
          + f" = {detail['corun_aggregate_tokens_per_s']:.1f}; request "
          f"service ms {detail['request_service_ms']}; latency p50 / p95 "
          f"ms solo {detail['solo_lat_p50_ms']} / {detail['solo_lat_p95_ms']}"
          f", co-run {detail['corun_lat_p50_ms']} / "
          f"{detail['corun_lat_p95_ms']}; requests "
          f"{json.dumps(detail['requests'])}; tokens {json.dumps(tokens)}")
    granted = [tokens["solo_a"], tokens["solo_b"], *tokens["corun"]]
    check(all(n > 0 for n in granted), f"a pod was granted no token: {tokens}")
    return result


def pairs(stream, n):
    """The first ``n`` items of ``stream`` (trees with "images" and
    "labels", as prefetch_to_device yields them) as (inputs, targets)."""
    return ((b["images"], b["labels"]) for b in itertools.islice(stream, n))


def resnet_setup(torch, device):
    """ResNetConfig(), its weights (seed 0) on the CPU, and the loader
    over RESNET_DATASET random images (seed 0)."""
    import numpy as np

    from kubeshare_tpu_torch.data import ShardedBatchLoader
    from kubeshare_tpu_torch.models.resnet import ResNetConfig, resnet_init

    config = ResNetConfig()
    params = resnet_init(torch.Generator().manual_seed(0), config,
                         device="cpu")
    rng = np.random.default_rng(0)
    arrays = {"images": rng.standard_normal((RESNET_DATASET, 32, 32, 3),
                                            dtype=np.float32),
              "labels": rng.integers(0, 10, (RESNET_DATASET,),
                                     dtype=np.int64)}
    return config, params, ShardedBatchLoader(arrays, RESNET_BATCH, seed=0)


def resnet_forward_check(torch, device, config, params, images):
    """The card's logits against the CPU's, relative to max |logit|, with
    TF32 off (shipped) and on (the control the limit must refuse)."""
    from kubeshare_tpu_torch.models.resnet import resnet_apply

    with torch.no_grad():
        t0 = time.perf_counter()
        cpu = resnet_apply(params, images, config)
        cpu_s = time.perf_counter() - t0
        card_params, card_images = clone_tree(params, device), images.to(device)
        errs = {}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                logits = resnet_apply(card_params, card_images, config)
            finally:
                torch.backends.cudnn.allow_tf32 = False
            check(logits.shape == (RESNET_BATCH, config.num_classes)
                  and bool(torch.isfinite(logits).all()),
                  f"resnet logits {tuple(logits.shape)} not finite")
            errs[tf32] = rel_err(logits.cpu(), cpu)
    print(f"resnet logits {tuple(cpu.shape)} on the card vs the CPU ({cpu_s:.1f}"
          f" s there): max abs err / max |logit| {errs[False]:.3e} (tol "
          f"{RESNET_LOGITS_RTOL:g}; |logits| up to "
          f"{float(cpu.abs().max()):.3f}); control with TF32 convolutions "
          f"{errs[True]:.3e}")
    check(errs[False] <= RESNET_LOGITS_RTOL,
          f"ResNet logits on the card differ from the CPU's by {errs[False]}")
    check(errs[True] > RESNET_LOGITS_RTOL,
          f"the ResNet logits limit {RESNET_LOGITS_RTOL} does not refuse "
          f"TF32 convolutions ({errs[True]})")
    return errs


def resnet_checkpoint_check(torch, device, config, params, loader, tmp):
    """Captured steps with deterministic convolutions: save at step
    RESNET_CKPT_STEP, run to RESNET_STEPS, restore the checkpoint into the
    captured step's state in place, and replay the steps after it: the
    parameters and losses must equal the first run's to the bit."""

    from kubeshare_tpu_torch.data import prefetch_to_device
    from kubeshare_tpu_torch.models.resnet import resnet_apply
    from kubeshare_tpu_torch.parallel.checkpoint import (restore_checkpoint,
                                                         save_checkpoint)
    from kubeshare_tpu_torch.parallel.train import (make_train_step,
                                                    tree_leaves)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        init_state, train_step = make_train_step(
            lambda p, x: resnet_apply(p, x, config), capture=True)
        state = init_state(clone_tree(params, device))
        host = list(itertools.islice(loader.epochs(0), RESNET_STEPS))
        stream = prefetch_to_device(iter(host), size=2, sharding=device)
        state, first, _, _ = timed_steps(torch, train_step, state,
                                         pairs(stream, RESNET_CKPT_STEP))
        path = save_checkpoint(tmp, state, RESNET_CKPT_STEP)
        rest = RESNET_STEPS - RESNET_CKPT_STEP
        state, losses, _, _ = timed_steps(torch, train_step, state,
                                          pairs(stream, rest))
        final = [leaf.detach().clone() for leaf in tree_leaves(state.params)]
        pointers = [leaf.data_ptr() for leaf in tree_leaves(state.params)]
        state = restore_checkpoint(tmp, into=state)
        check(state.step == RESNET_CKPT_STEP,
              f"restored step {state.step}, saved {RESNET_CKPT_STEP}")
        check(pointers == [leaf.data_ptr() for leaf in
                           tree_leaves(state.params)],
              "the restore rebound the captured step's parameters")
        replay = prefetch_to_device(iter(host[RESNET_CKPT_STEP:]), size=2,
                                    sharding=device)
        state, again, _, _ = timed_steps(torch, train_step, state,
                                         pairs(replay, rest))
        equal = all(torch.equal(a, b) for a, b in
                    zip(final, tree_leaves(state.params)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"resnet checkpoint: saved {path} at step {RESNET_CKPT_STEP}, ran "
          f"to {RESNET_STEPS}, restored in place into the captured step's "
          f"state and replayed steps {RESNET_CKPT_STEP + 1}-{RESNET_STEPS}: "
          f"losses {' '.join(f'{x:.6f}' for x in losses)} then "
          f"{' '.join(f'{x:.6f}' for x in again)}; parameters equal to the "
          f"bit: {equal}")
    check(equal and losses == again,
          "the resumed captured run differs from the first one")


def resnet_profile_check(torch, train_step, state, batch, log_dir):
    """profile_trace around three captured steps: the Chrome trace must
    hold CUDA kernel events."""
    import glob
    import os

    from kubeshare_tpu_torch.utils.profiling import profile_trace

    with profile_trace(log_dir):
        for _ in range(3):
            state, _ = train_step(state, batch["images"], batch["labels"])
    (trace,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    print(f"resnet profile_trace: {os.path.basename(trace)}, "
          f"{os.path.getsize(trace) / 2**20:.2f} MiB, {len(events)} events, "
          f"{len(kernels)} CUDA kernel events over 3 captured steps")
    check(len(kernels) > 0, "profile_trace recorded no CUDA kernel")
    return state


def mesh_check(torch, label, apply, params, batches, reference, initial,
               limits):
    """``apply`` captured over dp=MESH_DP on [cuda:0] * MESH_DP from
    ``params`` over ``batches`` against the one-device captured run
    ``reference`` (losses, parameters): step 1 at CAPTURE_SAME_LOSS_ATOL,
    the run at ``limits`` (loss, update), every copy equal to the bit."""
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import (make_train_step,
                                                    tree_leaves)

    device = batches[0][0].device
    mesh = make_mesh(MeshSpec(dp=MESH_DP), devices=[device] * MESH_DP)
    init_state, train_step = make_train_step(apply, mesh=mesh,
                                             param_rules={}, capture=True)
    state = init_state(params)
    state, losses, step_ms, enqueue_ms = timed_steps(torch, train_step,
                                                     state, batches)
    gathered = [leaf.gather() for leaf in tree_leaves(state.params)]
    copied, equal = replicas_equal(torch, state.params)
    print(f"{label} captured over dp={MESH_DP} on {MESH_DP} x {device}: "
          f"losses {' '.join(f'{x:.5f}' for x in losses)}; step "
          f"{steady_median(step_ms):.4f} ms (CUDA events), enqueue "
          f"{steady_median(enqueue_ms):.4f} ms; {copied} replicated leaves, "
          f"every copy equal to the bit: {equal}")
    check(equal, f"{label} over dp: the copies of a leaf differ")
    hold_drift(f"{label} over dp={MESH_DP} vs one device",
               (losses, gathered), reference, initial, limits)
    return losses


def resnet_phase(torch, device):
    """The ResNet gang job on the card: the forward against the CPU (with
    its TF32 control); with deterministic convolutions, RESNET_STEPS
    eager steps (default AdamW, capturable AdamW, and the drift limits'
    control) against RESNET_STEPS captured ones, the captured step fed by
    the loader through prefetch_to_device equal to it to the bit, the
    checkpoint resume into the captured step, and MNIST and ResNet
    captured over a dp=2 mesh on the one card against one device; then,
    in the default (fastest) convolution mode, the captured step fed by
    the loader and prefetch timed, and profile_trace."""
    import tempfile

    import numpy as np

    from kubeshare_tpu_torch.data import prefetch_to_device
    from kubeshare_tpu_torch.models.mnist import mnist_apply, mnist_init
    from kubeshare_tpu_torch.models.resnet import resnet_apply
    from kubeshare_tpu_torch.parallel.train import (adamw, make_train_step,
                                                    tree_leaves)

    config, params, loader = resnet_setup(torch, device)
    host = list(itertools.islice(loader.epochs(0), RESNET_STEPS))
    resnet_forward_check(torch, device, config, params,
                         torch.from_numpy(host[0]["images"]))
    batches = [(torch.from_numpy(b["images"]).to(device),
                torch.from_numpy(b["labels"]).to(device)) for b in host]
    initial = [leaf.to(device) for leaf in tree_leaves(params)]

    def apply(p, x):
        return resnet_apply(p, x, config)

    def run(apply_fn, tree, batches, optimizer=None, capture=False):
        init_state, train_step = make_train_step(
            apply_fn, optimizer=optimizer, capture=capture)
        state, losses, step_ms, enqueue_ms = timed_steps(
            torch, train_step, init_state(clone_tree(tree, device)), batches)
        return (losses, [leaf.detach().clone()
                         for leaf in tree_leaves(state.params)]), step_ms

    def prefetched():
        init_state, train_step = make_train_step(apply, capture=True)
        stream = prefetch_to_device(iter(host), size=2, sharding=device)
        state, losses, step_ms, enqueue_ms = timed_steps(
            torch, train_step, init_state(clone_tree(params, device)),
            pairs(stream, RESNET_STEPS))
        return ((losses, [leaf.detach().clone()
                          for leaf in tree_leaves(state.params)]),
                step_ms, enqueue_ms, train_step, state)

    # cuDNN's fastest f32 algorithms are not deterministic (two eager runs
    # of this model part by ~1e-3 in loss after 10 steps: Adam's
    # normalised step amplifies round-off); the comparisons run the
    # deterministic ones
    torch.backends.cudnn.deterministic = True
    try:
        default, eager_ms = run(apply, params, batches)
        same, _ = run(apply, params, batches, capturable_adamw(device))
        control, _ = run(apply, params, batches, adamw(RESNET_CONTROL_LR))
        captured, _ = run(apply, params, batches, capture=True)
        print(f"resnet {RESNET_STEPS} steps of batch {RESNET_BATCH}, "
              "deterministic convolutions: captured losses "
              + " ".join(f"{x:.5f}" for x in captured[0]))
        hold_captured("resnet", captured, same, default, initial,
                      RESNET_DRIFT_LOSS_ATOL, RESNET_DRIFT_UPDATE_RTOL)
        resnet_limits = (RESNET_DRIFT_LOSS_ATOL, RESNET_DRIFT_UPDATE_RTOL)
        hold_drift(f"resnet control, eager at lr {RESNET_CONTROL_LR:g} vs "
                   "the captured run", control, captured, initial,
                   resnet_limits, must_pass=False)
        fed = prefetched()[0]
        equal = fed[0] == captured[0] and all(
            torch.equal(a, b) for a, b in zip(fed[1], captured[1]))
        print("resnet captured step fed by ShardedBatchLoader -> "
              "prefetch_to_device: losses and parameters equal to the bit "
              f"to the run fed by batches placed beforehand: {equal}")
        check(equal, "the prefetched batches trained other parameters")
        with tempfile.TemporaryDirectory() as tmp:
            resnet_checkpoint_check(torch, device, config, params, loader,
                                    tmp)
        mesh_check(torch, "resnet", apply, clone_tree(params, device), batches,
                   captured, initial, resnet_limits)

        # MNIST at the co-run's batch: one device captured, its control,
        # then over dp
        mnist = mnist_init(torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(1)
        n = RESNET_STEPS * MNIST_BATCH
        images = torch.from_numpy(rng.standard_normal(
            (n, 28, 28, 1), dtype=np.float32)).to(device)
        labels = torch.from_numpy(rng.integers(
            0, 10, (n,), dtype=np.int64)).to(device)
        mnist_batches = [(images[i:i + MNIST_BATCH], labels[i:i + MNIST_BATCH])
                         for i in range(0, n, MNIST_BATCH)]
        mnist_initial = [leaf.to(device) for leaf in tree_leaves(mnist)]
        one, _ = run(mnist_apply, mnist, mnist_batches, capture=True)
        mnist_control, _ = run(mnist_apply, mnist, mnist_batches,
                               adamw(RESNET_CONTROL_LR))
        mnist_limits = (MNIST_DRIFT_LOSS_ATOL, MNIST_DRIFT_UPDATE_RTOL)
        hold_drift(f"mnist control, eager at lr {RESNET_CONTROL_LR:g} vs "
                   "the captured run", mnist_control, one, mnist_initial,
                   mnist_limits, must_pass=False)
        mesh_check(torch, "mnist", mnist_apply, clone_tree(mnist, device),
                   mnist_batches, one, mnist_initial, mnist_limits)
    finally:
        torch.backends.cudnn.deterministic = False

    # the timed run: the default convolutions, fed by the loader and
    # prefetch (its losses part from the deterministic run's by the
    # nondeterministic algorithms' round-off: printed, not held)
    timed, step_ms, enqueue_ms, train_step, state = prefetched()
    median = steady_median(step_ms)
    drift = max(abs(a - b) for a, b in zip(timed[0], captured[0]))
    print(f"resnet step, default convolutions, fed by ShardedBatchLoader -> "
          f"prefetch_to_device, median of steps {TRAIN_TIMED_FROM}-"
          f"{RESNET_STEPS}: captured {median:.4f} ms (CUDA events), enqueue "
          f"{steady_median(enqueue_ms):.4f} ms, "
          f"{RESNET_BATCH / (median * 1e-3):.0f} images/s; eager "
          f"(deterministic) {steady_median(eager_ms):.4f} ms; losses "
          + " ".join(f"{x:.5f}" for x in timed[0])
          + f" (max |diff| from the deterministic run {drift:.3e})")
    check(all(math.isfinite(x) for x in timed[0]),
          f"resnet: non-finite loss {timed[0]}")
    with tempfile.TemporaryDirectory() as tmp:
        resnet_profile_check(torch, train_step, state, next(iter(
            prefetch_to_device(iter(host[:1]), sharding=device))), tmp)
    return {"step_ms": median, "images_per_s": RESNET_BATCH / (median * 1e-3)}


def device_rows(prof):
    """(self device us, calls, name) of every kernel and copy in a
    profile, longest first."""
    rows = []
    for event in prof.key_averages():
        # kernels only: a CPU op's row, and a range such as
        # "Optimizer.step#AdamW.step" on the device's timeline, carry their
        # kernels' time as well
        if (not str(event.device_type).endswith("CUDA")
                or getattr(event, "is_user_annotation", False)):
            continue
        device_us = getattr(event, "self_device_time_total",
                            getattr(event, "self_cuda_time_total", 0))
        if device_us > 0:
            rows.append((device_us, event.count, event.key))
    return sorted(rows, reverse=True)


def profile_engine(torch, device, label, config, params):
    """The engine phase's default pass (after its warm-up) under
    torch.profiler: wall time, the device's busy share, and device time
    by kernel over the whole trace."""
    from torch.profiler import ProfilerActivity, profile

    from kubeshare_tpu_torch.serving import EngineConfig, Request, ServingEngine

    trace = engine_trace(config)
    engine = ServingEngine(params, config, EngineConfig(**ENGINE_POOL),
                           device=device)
    engine.warmup()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for rid, prompt, new in trace:
            engine.submit(Request(rid, prompt, new))
        steps = 0
        while engine.step():
            steps += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    device_ms = sum(r[0] for r in rows) / 1e3
    print(f"profile engine {label} ({len(trace)} requests, {steps} steps, profiler "
          f"on): wall {wall_ms:.1f} ms, device busy {device_ms:.1f} ms = "
          f"{device_ms / wall_ms:.4f} of wall, "
          f"{sum(r[1] for r in rows)} device kernels and copies")
    check(device_ms > 0, "the profiler saw no device time")
    for device_us, count, name in rows[:40]:
        print(f"profile engine {label} kernel {device_us / 1e3:9.3f} ms {count:7d} "
              f"calls  {name[:110]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms, "steps": steps}


def profile_train(torch, device, capture: bool, warmup: int = 3,
                  steps: int = 5, sharded: bool = False):
    """Steady train steps (eager, or captured: one graph replay a step;
    ``sharded``: train_sharded's (a) over SHARDED_MESH on the one card)
    under torch.profiler: host enqueue and wall time per step, device
    busy share, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply, transformer_sharding_rules)
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import make_train_step

    config, params, tokens, targets = train_setup(torch, device)
    mesh = (make_mesh(MeshSpec(**SHARDED_MESH), devices=[device] * 4)
            if sharded else None)
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config), mesh=mesh,
        param_rules=transformer_sharding_rules() if sharded else None,
        capture=capture)
    state = init_state(params)
    mode = ("sharded " if sharded else "") + ("captured" if capture
                                              else "eager")
    for _ in range(warmup):
        state, _ = train_step(state, tokens, targets)
    torch.cuda.synchronize()
    enqueue_s = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            t1 = time.perf_counter()
            state, _ = train_step(state, tokens, targets)
            enqueue_s.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = device_rows(prof)
    device_ms = sum(r[0] for r in rows) / 1e3 / steps
    launches = sum(r[1] for r in rows) / steps
    wall_ms = wall_s * 1e3 / steps
    print(f"profile {mode} train step ({steps} steps after {warmup} warm-up, "
          f"profiler on): wall {wall_ms:.3f} ms per step, host enqueue "
          + " ".join(f"{x * 1e3:.2f}" for x in enqueue_s) + " ms, device "
          f"busy {device_ms:.3f} ms per step = {device_ms / wall_ms:.4f} "
          f"of wall, {launches:.0f} device kernels and copies per step")
    check(device_ms > 0, "the profiler saw no device time")
    for device_us, count, name in rows[:40]:
        print(f"profile {mode} kernel {device_us / 1e3 / steps:9.4f} ms/step "
              f"{count // steps:5d} calls/step  {name[:110]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "launches_per_step": launches,
            "enqueue_ms": [x * 1e3 for x in enqueue_s]}


class MoERoutes:
    """Each MoE layer's router probabilities in the transformer forwards
    run inside the block: a spy on models.transformer._moe_or_mlp (put
    back on exit), which the dense forward calls.  ``layers``: (probs
    [n, e] f32, capacity) per MoE layer call, in order.

    ``replay`` (another run's ``layers``): each MoE layer is routed by
    that run's probabilities instead of its own, the same values going
    into the routing and the gates, while the gradient flows through the
    layer's own router (``own + (replayed - own).detach()``), so two runs
    that differ elsewhere (attention) take the same experts."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        import torch
        from kubeshare_tpu_torch.models import transformer
        from kubeshare_tpu_torch.ops.moe import (moe_capacity, routed_apply,
                                                 router_probs)

        self.layers = []
        self._module, self._inner = transformer, transformer._moe_or_mlp

        def spy(layer, config, y, capacity=None):
            if "moe" not in layer:
                return self._inner(layer, config, y, capacity)
            e, d, f = layer["moe"]["w_in"].shape
            moe_config = transformer._moe_config(config, d, f, e)
            tokens = y.reshape(-1, d)
            capacity = moe_capacity(moe_config, tokens.shape[0], capacity)
            if self.replay is None:
                with torch.no_grad():
                    probs = router_probs(layer["moe"], tokens.detach())
                self.layers.append((probs, capacity))
                return self._inner(layer, config, y, capacity)
            probs = router_probs(layer["moe"], tokens)
            probs = probs + (self.replay[len(self.layers)][0]
                             - probs).detach()
            self.layers.append((probs.detach(), capacity))
            out, aux = routed_apply(layer["moe"], y, probs, moe_config,
                                    capacity)
            return out.to(config.dtype), aux

        transformer._moe_or_mlp = spy
        return self

    def __exit__(self, *exc):
        self._module._moe_or_mlp = self._inner


def route_summary(torch, probs, k, capacity):
    """(expert order [n, k], kept experts [n, e], margin [n]) of top-k
    routing: the margin is the smallest log-probability gap between
    neighbouring ranks among the top k + 1 where the capacity can drop a
    choice (the order claims the slots), else the gap at the top-k
    boundary (only the set matters)."""
    from kubeshare_tpu_torch.ops.moe import tokens_choose_routing

    n, e = probs.shape
    _, index, _, kept, _ = tokens_choose_routing(probs, k, capacity)
    top = torch.sort(torch.log(probs), dim=-1,
                     descending=True).values[:, :k + 1]
    gaps = top[:, :-1] - top[:, 1:]
    margin = gaps.min(dim=-1).values if capacity < n else gaps[:, k - 1]
    return index, kept.reshape(k, n, e).any(dim=0), margin


def routing_differences(torch, run_a, run_b, k):
    """Two forwards' routing compared layer by layer: (touched [n], rows
    whose kept experts or expert order differ at some layer; moved, rows
    first moved; unexplained, rows first moved where both runs' margins
    were at least MOE_ROUTE_MARGIN, plus keep differences in a layer where
    no row moved, which a capacity cascade cannot explain; widest, the
    largest margin at which a row first moved)."""
    touched, moved_rows, unexplained, widest = None, 0, 0, 0.0
    for (pa, cap), (pb, _) in zip(run_a, run_b, strict=True):
        ia, ka, ma = route_summary(torch, pa, k, cap)
        ib, kb, mb = route_summary(torch, pb, k, cap)
        if touched is None:
            touched = torch.zeros(pa.shape[0], dtype=torch.bool,
                                  device=pa.device)
        kept = (ka != kb).any(dim=-1)
        moved = kept if cap >= pa.shape[0] else (ia != ib).any(dim=-1)
        new = moved & ~touched
        moved_rows += int(new.sum())
        margin = torch.minimum(ma, mb)
        unexplained += int((new & (margin >= MOE_ROUTE_MARGIN)).sum())
        if bool(new.any()):
            widest = max(widest, float(margin[new].max()))
        if not bool(moved.any()):
            unexplained += int(kept.sum())
        touched |= moved | kept
    return touched, moved_rows, unexplained, widest


def moe_teacher_forced(torch, params, config, trace, streams, device):
    """teacher_forced for an MoE model: the dense forward over prompt +
    emitted tokens with the experts' capacity pinned to the sequence (the
    prefill's contract, as every cached path routes).  Each emitted
    token's shortfall from its row's maximum; a row whose routing margin
    at some MoE layer is under MOE_ROUTE_MARGIN is undecided.  Returns
    (worst over decided rows, worst over all rows, rows, undecided rows,
    undecided rows over ENGINE_TOKEN_MARGIN)."""
    from kubeshare_tpu_torch.models.transformer import (_forward,
                                                        _select_attention)

    attention = _select_attention(config, device)
    worst, worst_all, rows_n, undecided_n, excused = 0.0, 0.0, 0, 0, 0
    with torch.no_grad():
        for rid, prompt, _ in trace:
            emitted = streams[rid]
            seq = torch.tensor(list(prompt) + emitted[:-1], device=device)
            with MoERoutes() as routes:
                logits, _ = _forward(params, seq[None], config, attention, 0,
                                     kv_sink=[])
            start = len(prompt) - 1
            rows = logits[0, start:]
            picked = rows.gather(
                1, torch.tensor(emitted, device=device)[:, None])[:, 0]
            short = rows.max(dim=1).values - picked
            margin = torch.stack([
                route_summary(torch, probs, config.moe_top_k, cap)[2]
                for probs, cap in routes.layers]).min(dim=0).values[start:]
            undecided = margin < MOE_ROUTE_MARGIN
            if bool((~undecided).any()):
                worst = max(worst, float(short[~undecided].max()))
            worst_all = max(worst_all, float(short.max()))
            rows_n += len(emitted)
            undecided_n += int(undecided.sum())
            excused += int((undecided & (short > ENGINE_TOKEN_MARGIN)).sum())
    return worst, worst_all, rows_n, undecided_n, excused


def moe_forced_report(label, forced):
    worst, worst_all, rows, undecided, excused = forced
    print(f"moe {label} teacher-forced (capacity pinned): worst emitted "
          f"token {worst:.4f} under its row's max over the {rows - undecided} "
          f"rows whose routing margin is >= {MOE_ROUTE_MARGIN} (tol "
          f"{ENGINE_TOKEN_MARGIN}); {undecided}/{rows} rows within the "
          f"margin of a routing tie, {excused} of them over the tolerance "
          f"(worst over all rows {worst_all:.4f})")
    check(worst <= ENGINE_TOKEN_MARGIN,
          f"moe {label}: an emitted token of a decided row lies {worst} "
          "under its row's max in the pinned dense forward")


def clone_tree(tree, device=None):
    """A copy of a parameter tree (nested dicts and lists of tensors), on
    ``device`` (default: each tensor's own)."""
    if isinstance(tree, dict):
        return {key: clone_tree(value, device) for key, value in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(value, device) for value in tree]
    return tree.detach().to(device, copy=True)


def moe_op_check(torch, device):
    """(a) moe_apply at the MoE model's layer shape, x (2, 2048, 1024)
    bf16: both routings x both dispatches against the same call on the
    CPU in f32 (routed by the card's probabilities), scatter against
    einsum, a second run's forward and gradient equal to the first to the
    bit; then the scatter and einsum forwards timed beside the dense MLP
    of the same width and the experts' MLP alone."""
    from kubeshare_tpu_torch.models.transformer import _mlp
    from kubeshare_tpu_torch.ops import moe

    d, f, e = MOE_DIMS["d_model"], MOE_DIMS["d_ff"], MOE_DIMS["moe_num_experts"]
    base = moe.MoEConfig(d_model=d, d_ff=f, num_experts=e,
                         capacity_factor=MOE_DIMS["moe_capacity_factor"],
                         top_k=MOE_DIMS["moe_top_k"])
    params = moe.moe_init(base, torch.Generator().manual_seed(0), device)
    cpu_params = {name: t.cpu() for name, t in params.items()}
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, d),
                    generator=torch.Generator().manual_seed(1)).to(
                        device, torch.bfloat16)
    x_cpu = x.float().cpu()
    n = TRAIN_BATCH * TRAIN_SEQ
    probs = moe.router_probs(params, x.reshape(n, d))
    probs_err = float((probs.cpu() - moe.router_probs(
        cpu_params, x_cpu.reshape(n, d))).abs().max())
    print(f"moe op router probs vs the CPU (f32): max abs err {probs_err:.3e} "
          f"(tol {MOE_PROBS_ATOL})")
    check(probs_err <= MOE_PROBS_ATOL,
          f"moe router probabilities differ from the CPU's by {probs_err}")
    outs = {}
    for routing in ("tokens_choose", "experts_choose"):
        for dispatch in ("scatter", "einsum"):
            cfg = dataclasses.replace(base, routing=routing, dispatch=dispatch)
            runs = []
            for _ in range(2):
                leaves = {name: t.clone().requires_grad_()
                          for name, t in params.items()}
                xx = x.clone().requires_grad_()
                out, aux = moe.moe_apply(leaves, xx, cfg)
                (out.float().square().mean() + MOE_AUX_COEF * aux).backward()
                runs.append([out.detach(), aux.detach(), xx.grad]
                            + [leaves[name].grad for name in sorted(leaves)])
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            out, aux = runs[0][0], runs[0][1]
            del runs
            capacity = moe.moe_capacity(cfg, n)
            ref, ref_aux = moe.routed_apply(cpu_params, x_cpu, probs.cpu(),
                                            cfg, capacity)
            err = rel_err(out.cpu(), ref)
            aux_err = abs(float(aux) - float(ref_aux))
            outs[dispatch] = out
            print(f"moe op {routing} {dispatch} at x {tuple(x.shape)} bf16, "
                  f"capacity {capacity}: out max-abs-err/max-ref vs the CPU "
                  f"f32 {err:.3e} (tol {MOE_OP_RTOL}), aux {float(aux):.6f} "
                  f"vs {float(ref_aux):.6f}; second run equal to the bit "
                  f"(out and every gradient): {same}")
            check(bool(torch.isfinite(out).all()), "non-finite moe output")
            check(same, f"moe {routing} {dispatch}: a second run's output or "
                        "gradient differs from the first's")
            check(err <= MOE_OP_RTOL,
                  f"moe {routing} {dispatch} differs from the CPU by {err}")
            check(aux_err <= MOE_PROBS_ATOL,
                  f"moe {routing} {dispatch} aux differs by {aux_err}")
        d_err = rel_err(outs["scatter"], outs["einsum"])
        print(f"moe op {routing}: scatter vs einsum on the card "
              f"max-abs-err/max-ref {d_err:.3e} (tol {MOE_DISPATCH_RTOL})")
        check(d_err <= MOE_DISPATCH_RTOL,
              f"moe {routing}: scatter and einsum dispatch differ by {d_err}")
    del outs

    gen = torch.Generator().manual_seed(2)
    mlp = {"w_in": (torch.randn((d, f), generator=gen) * d ** -0.5).to(device),
           "w_out": (torch.randn((f, d), generator=gen) * f ** -0.5).to(device)}
    capacity = moe.moe_capacity(base, n)
    buf = torch.randn((e, capacity, d), generator=gen).to(device,
                                                          torch.bfloat16)
    times = {
        "dense_mlp": time_ms(lambda: _mlp(x, mlp)),
        "experts_mlp": time_ms(lambda: moe._expert_ffn(params, buf,
                                                       torch.bfloat16)),
        "scatter": time_ms(lambda: moe.moe_apply(params, x, base)),
        "einsum": time_ms(lambda: moe.moe_apply(
            params, x, dataclasses.replace(base, dispatch="einsum"))),
    }
    from torch.profiler import ProfilerActivity, profile

    for dispatch in ("scatter", "einsum"):
        cfg = dataclasses.replace(base, dispatch=dispatch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(MOE_PROFILED_CALLS):
                moe.moe_apply(params, x, cfg)
            torch.cuda.synchronize()
        rows = device_rows(prof)
        total = sum(r[0] for r in rows) / MOE_PROFILED_CALLS / 1e3
        print(f"moe op profile {dispatch} forward: {total:.4f} ms of device "
              f"time a call over {sum(r[1] for r in rows) // MOE_PROFILED_CALLS}"
              f" kernels; the largest: " + "; ".join(
                  f"{us / MOE_PROFILED_CALLS / 1e3:.4f} ms {name[:60]}"
                  for us, _, name in rows[:8]))
    flops = {"dense_mlp": 4 * n * d * f, "experts_mlp": 4 * e * capacity * d * f}
    flops["scatter"] = flops["experts_mlp"]
    flops["einsum"] = flops["experts_mlp"] + 2 * 2 * n * e * capacity * d
    print(f"moe op timing at x {tuple(x.shape)} bf16, forward, CUDA events: "
          + "; ".join(f"{name} {ms:.4f} ms ({flops[name] / (ms * 1e-3) / 1e12:.1f}"
                      f" TFLOP/s)" for name, ms in times.items())
          + f"; routing + dispatch = scatter - experts_mlp "
          f"{times['scatter'] - times['experts_mlp']:.4f} ms; scatter / "
          f"dense_mlp {times['scatter'] / times['dense_mlp']:.3f}x, einsum "
          f"/ scatter {times['einsum'] / times['scatter']:.3f}x")
    return times


def moe_forward_check(torch, config, params, tokens):
    """(b) transformer_apply_with_aux at tokens (2, 2048) with the flash
    kernel against attention="reference": rows routed alike held at the
    slice phase's logits limit, rows moved by a routing near-tie
    counted."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply_with_aux

    plain = dataclasses.replace(config, attention="reference")
    reset_counts()
    with torch.no_grad(), MoERoutes() as routes:
        logits, aux = transformer_apply_with_aux(params, tokens, config)
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches == {**only(), "flash_fwd": config.n_layers},
          f"the moe forward launched {launches}")
    with torch.no_grad(), MoERoutes() as plain_routes:
        plain_logits, plain_aux = transformer_apply_with_aux(params, tokens,
                                                             plain)
    touched, moved, unexplained, widest = routing_differences(
        torch, routes.layers, plain_routes.layers, config.moe_top_k)
    n = tokens.numel()
    row_err = (logits - plain_logits).abs().reshape(n, -1).max(dim=1).values
    err = float(row_err[~touched].max())
    print(f"moe forward {tuple(tokens.shape)}: launches {launches}; aux "
          f"{float(aux):.6f} (reference {float(plain_aux):.6f}); "
          f"{int(touched.sum())}/{n} rows routed differently from "
          f"attention=reference ({moved} moved first, the widest at a "
          f"margin of {widest:.4f}, {unexplained} at a margin >= "
          f"{MOE_ROUTE_MARGIN}); the other rows' logits max abs "
          f"err {err:.3e} (tol {SLICE_LOGITS_ATOL}), all rows "
          f"{float(row_err.max()):.3e}")
    check(tuple(logits.shape) == (*tokens.shape, config.vocab_size),
          f"moe logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()) and math.isfinite(float(aux)),
          "non-finite moe forward")
    check(unexplained == 0,
          f"{unexplained} rows routed differently at a margin >= "
          f"{MOE_ROUTE_MARGIN}")
    check(err <= SLICE_LOGITS_ATOL,
          f"moe forward logits differ from the plain path by {err}")
    return launches


def moe_loss(out, targets):
    """Cross entropy + MOE_AUX_COEF x the load-balancing aux."""
    from kubeshare_tpu_torch.parallel.train import cross_entropy_loss

    logits, aux = out
    return cross_entropy_loss(logits, targets) + MOE_AUX_COEF * aux


def moe_grad_check(torch, config, params, tokens, targets):
    """(e) step 1's loss and gradients against attention="reference" at
    the train phase's limits, the reference run routed by the flash run's
    router probabilities (MoERoutes' replay): otherwise the rows that a
    routing near-tie sends to other experts (the moe forward line counts
    them on this batch) carry whole experts' differences into every
    expert's, the router's and their embedding rows' gradients, and the
    comparison would measure the ties rather than the kernels."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply_with_aux
    from kubeshare_tpu_torch.parallel.train import tree_leaves

    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)

    def loss_and_grads(cfg, replay=None):
        with MoERoutes(replay) as routes:
            out = transformer_apply_with_aux(params, tokens, cfg)
        loss = moe_loss(out, targets)
        return loss.detach(), torch.autograd.grad(loss, leaves), routes.layers

    loss, grads, routes = loss_and_grads(config)
    plain_loss, plain_grads, _ = loss_and_grads(
        dataclasses.replace(config, attention="reference"), routes)
    for leaf in leaves:
        leaf.requires_grad_(False)
    grad_err = max(rel_err(g, r) for g, r in zip(grads, plain_grads))
    cosine = min(float(torch.nn.functional.cosine_similarity(
        g.float().flatten(), r.float().flatten(), dim=0))
        for g, r in zip(grads, plain_grads))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    loss_err = abs(float(loss) - float(plain_loss))
    print(f"moe train grads vs attention=reference routed alike "
          f"({len(leaves)} tensors): loss {float(loss):.5f} vs "
          f"{float(plain_loss):.5f} (abs err {loss_err:.3e}), worst grad "
          f"max-abs-err/max-ref {grad_err:.3e}, lowest cosine {cosine:.6f}")
    check(finite, "non-finite gradients on the moe train path")
    check(loss_err <= TRAIN_LOSS_ATOL,
          f"moe train loss differs from the plain path by {loss_err}")
    check(grad_err <= TRAIN_GRAD_RTOL,
          f"moe train gradients differ from the plain path by {grad_err}")
    check(cosine >= TRAIN_GRAD_MIN_COSINE,
          f"a moe train gradient points elsewhere (cosine {cosine})")


def moe_train_run(torch, device, params, tokens, targets, capture=False,
                  optimizer=None, steps=TRAIN_STEPS, **overrides):
    """``steps`` steps of the MoE model from ``params`` (a copy is
    trained) through make_train_step: (losses, final parameters, step
    CUDA-event ms, host enqueue ms, launches, config)."""
    from kubeshare_tpu_torch.models.transformer import (
        TransformerConfig, transformer_apply_with_aux)
    from kubeshare_tpu_torch.parallel.train import make_train_step, tree_leaves

    config = TransformerConfig(**{**MOE_DIMS, "positional": "rope",
                                  "dtype": torch.bfloat16,
                                  "attention": "flash", **overrides})
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply_with_aux(p, t, config),
        optimizer=optimizer, loss_fn=moe_loss, capture=capture)
    state = init_state(clone_tree(params))
    torch.cuda.synchronize()
    reset_counts()
    state, losses, step_ms, enqueue_ms = timed_steps(
        torch, train_step, state, [(tokens, targets)] * steps)
    return (losses, tree_leaves(state.params), step_ms, enqueue_ms,
            read_counts(), config)


def moe_train_check(torch, device, config, params, tokens, targets):
    """(e) the MoE model's 10 AdamW steps on the train phase's batch,
    eager, then captured, then the einsum dispatch's captured step timed
    beside the scatter's.  The captured run is held to the eager run with
    the same capturable AdamW at CAPTURE_SAME_* over the 10 steps, and to
    the default AdamW through step 1's loss and first update at the
    drift limits: past a few steps the two AdamW forms' last-bit
    differences move bf16 weights across rounding boundaries, tokens
    across router near-ties, and the MoE model's two trajectories apart
    (the 10-step drift is printed as a reading)."""
    from kubeshare_tpu_torch.parallel.train import CAPTURE_WARMUP_STEPS, tree_leaves

    moe_grad_check(torch, config, params, tokens, targets)
    initial = [leaf.detach().clone() for leaf in tree_leaves(params)]
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops_per_token(MOE_DIMS, TRAIN_SEQ) * tokens_per_step
    launches, runs = {}, {}
    for name, capture, optimizer, overrides in (
            ("eager", False, None, {}),
            ("eager_capturable", False, capturable_adamw(device), {}),
            ("captured", True, None, {}),
            ("einsum_captured", True, None, {"moe_dispatch": "einsum"})):
        losses, final, step_ms, enqueue_ms, counts, cfg = moe_train_run(
            torch, device, params, tokens, targets, capture, optimizer,
            **overrides)
        passes = ((CAPTURE_WARMUP_STEPS + 1) if capture
                  else TRAIN_STEPS) * cfg.n_layers
        check(counts == {kernel: k * passes for kernel, k in only(
            "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq").items()},
              f"moe train {name} launched {counts}, expected {passes} of "
              "each kernel")
        check(all(math.isfinite(x) for x in losses),
              f"moe train {name}: non-finite loss {losses}")
        median_ms = steady_median(step_ms)
        runs[name] = (losses, final, median_ms, steady_median(enqueue_ms))
        if name != "eager_capturable":
            launches[{"eager": "moe_train", "captured": "moe_train_captured",
                      "einsum_captured": "moe_train_einsum"}[name]] = counts
        print(f"moe train {name} {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens: launches {counts}, losses "
              + " ".join(f"{x:.4f}" for x in losses) + "; step ms "
              + " ".join(f"{x:.2f}" for x in step_ms)
              + f"; median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS} "
              f"{median_ms:.3f} ms (CUDA events), enqueue "
              f"{runs[name][3]:.3f} ms, "
              f"{tokens_per_step / (median_ms * 1e-3):.0f} tokens/s, "
              f"{flops / 1e12:.3f} TFLOP per step = "
              f"{flops / (median_ms * 1e-3) / PEAK_FLOPS['bfloat16']:.4f} of "
              f"989 TFLOP/s")
        del final
    check(runs["eager"][0][-1] < runs["eager"][0][0],
          f"moe train loss did not fall: {runs['eager'][0]}")

    captured, same = runs["captured"], runs["eager_capturable"]
    hold_drift("moe train captured vs eager with the same optimizer",
               captured, same, initial,
               (CAPTURE_SAME_LOSS_ATOL, CAPTURE_SAME_UPDATE_RTOL))
    first = {name: moe_train_run(torch, device, params, tokens, targets,
                                 optimizer=optimizer, steps=1)
             for name, optimizer in (("default", None),
                                     ("capturable", capturable_adamw(device)))}
    first_loss = abs(first["capturable"][0][0] - first["default"][0][0])
    first_update, _ = update_errors(first["capturable"][1],
                                    first["default"][1], initial)
    drift_loss = max(abs(a - b) for a, b in zip(captured[0], runs["eager"][0]))
    drift_update, _ = update_errors(captured[1], runs["eager"][1], initial)
    print(f"moe train capturable vs default AdamW: step 1 loss abs err "
          f"{first_loss:.3e} (tol {CAPTURE_SAME_LOSS_ATOL:g}), first update "
          f"worst |diff| / |update| {first_update:.3e} (tol "
          f"{CAPTURE_DRIFT_UPDATE_RTOL:g}); after {TRAIN_STEPS} steps the "
          f"captured run is {drift_loss:.3e} in loss and {drift_update:.3e} "
          f"of the update from the default eager run (a reading)")
    check(first_loss <= CAPTURE_SAME_LOSS_ATOL
          and first_update <= CAPTURE_DRIFT_UPDATE_RTOL,
          f"moe train: capturable AdamW's first update differs from the "
          f"default's (loss {first_loss}, update {first_update})")
    del first
    first_einsum = abs(runs["einsum_captured"][0][0] - captured[0][0])
    print(f"moe train step, median: eager {runs['eager'][2]:.3f} ms, captured "
          f"{captured[2]:.3f} ms (scatter dispatch), einsum dispatch "
          f"captured {runs['einsum_captured'][2]:.3f} ms = "
          f"{runs['einsum_captured'][2] / captured[2]:.3f}x; einsum "
          f"step 1 loss vs scatter's abs err {first_einsum:.3e} (tol "
          f"{TRAIN_LOSS_ATOL})")
    check(first_einsum <= TRAIN_LOSS_ATOL,
          f"the einsum dispatch's step 1 loss differs from scatter's by "
          f"{first_einsum}")
    return launches, captured[0]


def moe_phase(torch, device):
    """The repo's MoE model (MOE_DIMS) at full width on the card: (a) the
    op, (b) the forward, (c) serving 4 requests eager and captured, (d)
    the engine, (e) training eager and captured.  Returns the launches by
    path and the captured run's losses."""

    t0 = time.perf_counter()
    moe_op_check(torch, device)
    config, params, tokens, targets = train_setup(torch, device, MOE_DIMS)
    launches = {"moe_forward": moe_forward_check(torch, config, params,
                                                 tokens)}

    prompts = serve_prompts(torch, config, device)
    reset_counts()
    streams, lines = serve_both_ways(torch, params, config, prompts)
    launches["moe_serve"] = read_counts()
    check(launches["moe_serve"] == {**only(),
                                    "flash_fwd": 4 * config.n_layers},
          f"the moe serve launched {launches['moe_serve']}")
    same = bool(torch.equal(streams[False], streams[True]))
    print(f"moe serve {N_REQUESTS} x ({PROMPT_LEN} + {NEW_TOKENS}): "
          + "; ".join(lines) + f"; captured tokens equal eager: {same}")
    check(same, "the moe model's captured decode differs from the eager")
    serve_trace = [(f"s{i}", prompts[i].tolist(), NEW_TOKENS)
                   for i in range(N_REQUESTS)]
    moe_forced_report("serve", moe_teacher_forced(
        torch, params, config, serve_trace,
        {rid: streams[True][i].tolist()
         for i, (rid, _, _) in enumerate(serve_trace)}, device))

    trace = engine_trace(config)
    engine_streams, stats = engine_pass(torch, device, params, config, trace)
    launches["moe_engine"] = stats["launches"]
    engine_report("moe", stats)
    check(stats["new_captures"] == 0,
          f"the moe engine captured {stats['new_captures']} graphs after "
          "warm-up")
    check(all(len(engine_streams[rid]) == new for rid, _, new in trace),
          "a moe engine stream has the wrong length")
    check(all(0 <= t < config.vocab_size for s in engine_streams.values()
              for t in s), "moe engine token ids out of range")
    moe_forced_report("engine", moe_teacher_forced(
        torch, params, config, trace, engine_streams, device))

    train_launches, captured_losses = moe_train_check(
        torch, device, config, params, tokens, targets)
    launches.update(train_launches)
    print(f"moe phase: {time.perf_counter() - t0:.1f} s")
    return launches, captured_losses


class ShardedMoERoutes:
    """MoERoutes for the sharded forward: a spy on
    models.transformer.sharded_moe (put back on exit) recording each MoE
    layer's router probabilities over the gathered batch, as the layer
    computes them, and its capacity."""

    def __enter__(self):
        import torch
        from kubeshare_tpu_torch.models import transformer
        from kubeshare_tpu_torch.ops.moe import moe_capacity, router_probs

        self.layers = []
        self._module, self._inner = transformer, transformer.sharded_moe

        def spy(units, params, ys, config, batch, capacity=None):
            with torch.no_grad():
                tokens = units.all_gather([y.detach() for y in ys], 0,
                                          batch)[0]
                tokens = tokens.reshape(-1, tokens.shape[-1])
                router = units.local(params["router"])[0].detach()
                self.layers.append((
                    router_probs({"router": router}, tokens),
                    moe_capacity(config, tokens.shape[0], capacity)))
            return self._inner(units, params, ys, config, batch, capacity)

        transformer.sharded_moe = spy
        return self

    def __exit__(self, *exc):
        self._module.sharded_moe = self._inner


def unit_bytes(state):
    """Bytes of parameters and AdamW moments that mesh device 0 holds."""
    from kubeshare_tpu_torch.parallel.train import tree_leaves

    total = 0
    for leaf in tree_leaves(state.params):
        shard = leaf.shards[0]
        moments = state.opt_state.state[shard]
        total += sum(t.numel() * t.element_size() for t in (
            shard, moments["exp_avg"], moments["exp_avg_sq"]))
    return total


def replicas_equal(torch, tree):
    """(slices held by several shards, all their copies equal to the bit)."""
    from kubeshare_tpu_torch.parallel.train import tree_leaves

    copied, equal = 0, True
    for leaf in tree_leaves(tree):
        for group in leaf.copies:
            if len(group) > 1:
                copied += 1
                equal &= all(torch.equal(leaf.shards[i], leaf.shards[group[0]])
                             for i in group[1:])
    return copied, equal


def sharded_train_run(torch, device, label, dims, rules, capture,
                      with_aux=False):
    """TRAIN_STEPS AdamW steps of ``dims`` (seed 0, the train phase's
    batch) over SHARDED_MESH on [device] * 4 under ``rules``: the state,
    losses, step CUDA-event and host enqueue medians, launches, bytes a
    unit holds; checks the launches and the replicas."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply, transformer_apply_with_aux)
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import (
        CAPTURE_WARMUP_STEPS, cross_entropy_loss, make_train_step,
        tree_leaves)

    config, params, tokens, targets = train_setup(torch, device, dims)
    units = SHARDED_MESH["dp"] * SHARDED_MESH["tp"]
    mesh = make_mesh(MeshSpec(**SHARDED_MESH), devices=[device] * units)
    apply = transformer_apply_with_aux if with_aux else transformer_apply
    init_state, train_step = make_train_step(
        lambda p, t: apply(p, t, config), mesh=mesh, param_rules=rules,
        loss_fn=moe_loss if with_aux else cross_entropy_loss,
        capture=capture)
    state = init_state(params)
    del params
    torch.cuda.synchronize()
    reset_counts()
    state, losses, step_ms, enqueue_ms = timed_steps(
        torch, train_step, state, [(tokens, targets)] * TRAIN_STEPS)
    launches = read_counts()
    passes = ((CAPTURE_WARMUP_STEPS + 1) if capture
              else TRAIN_STEPS) * config.n_layers * units
    check(launches == {name: n * passes for name, n in only(
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq").items()},
          f"train_sharded {label} launched {launches}, expected {passes} of "
          f"each kernel ({config.n_layers} layers x {units} units a pass)")
    check(all(math.isfinite(x) for x in losses),
          f"train_sharded {label}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train_sharded {label}: the loss did not "
                                  f"fall: {losses}")
    copied, equal = replicas_equal(torch, state.params)
    run = {"state": state, "losses": losses, "median_ms": steady_median(step_ms),
           "host_ms": steady_median(enqueue_ms), "launches": launches,
           "bytes": unit_bytes(state), "config": config,
           # one device's parameters and AdamW moments, f32
           "single_bytes": 3 * 4 * sum(leaf.shape.numel() for leaf in
                                       tree_leaves(state.params))}
    print(f"train_sharded {label} {TRAIN_STEPS} steps over dp="
          f"{SHARDED_MESH['dp']} x tp={SHARDED_MESH['tp']} on {units} x "
          f"{device}: launches {launches} ({passes // (config.n_layers * units)}"
          f" passes x {config.n_layers} layers x {units} units), losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; step ms "
          + " ".join(f"{x:.2f}" for x in step_ms)
          + f"; median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS} "
          f"{run['median_ms']:.3f} ms (CUDA events), host enqueue "
          f"{run['host_ms']:.3f} ms; parameters + moments a unit "
          f"{run['bytes'] / 2**20:.1f} MiB; {copied} slices held by several "
          f"shards, every copy equal to the bit: {equal}")
    check(equal, f"train_sharded {label}: the copies of a slice differ")
    return run


def hold_trajectory(label, losses, reference, against="the single-device "
                    "captured run", atol=SHARDED_DRIFT_LOSS_ATOL):
    """Step 1's loss at SHARDED_FIRST_LOSS_ATOL, every step at ``atol``."""
    first = abs(losses[0] - reference[0])
    err = max(abs(a - b) for a, b in zip(losses, reference))
    print(f"train_sharded {label} losses vs {against}: step 1 abs err "
          f"{first:.3e} (tol {SHARDED_FIRST_LOSS_ATOL:g}), max over "
          f"{len(losses)} steps {err:.3e} (tol {atol:g})")
    check(first <= SHARDED_FIRST_LOSS_ATOL and err <= atol,
          f"train_sharded {label}: the losses differ from {against}'s by "
          f"{first} at step 1, {err} at most")


def sharded_grad_check(torch, device):
    """(a) step 1's loss and every gradient of the sharded program
    (gathered, the copies summed) against one device's, both bf16 with
    the flash kernels, at the train phase's kernel-vs-reference limits."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply, transformer_sharding_rules)
    from kubeshare_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                   shard_params)
    from kubeshare_tpu_torch.parallel.spmd import sum_copies
    from kubeshare_tpu_torch.parallel.train import (cross_entropy_loss,
                                                    tree_leaves)

    config, params, tokens, targets = train_setup(torch, device)
    mesh = make_mesh(MeshSpec(**SHARDED_MESH), devices=[device] * 4)
    with torch.no_grad():
        placed = shard_params(params, transformer_sharding_rules(), mesh,
                              copy=True)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = cross_entropy_loss(transformer_apply(params, tokens, config),
                              targets)
    grads = torch.autograd.grad(loss, leaves)
    del params, leaves
    placed_leaves = tree_leaves(placed)
    for leaf in placed_leaves:
        for shard in leaf.shards:
            shard.requires_grad_(True)
    sharded_loss = cross_entropy_loss(transformer_apply(placed, tokens,
                                                        config), targets)
    sharded_loss.backward()
    sum_copies(placed_leaves)
    sharded = [leaf.grad.gather() for leaf in placed_leaves]
    loss, sharded_loss = float(loss.detach()), float(sharded_loss.detach())
    loss_err = abs(sharded_loss - loss)
    grad_err = max(rel_err(g, r) for g, r in zip(sharded, grads))
    cosine = min(float(torch.nn.functional.cosine_similarity(
        g.float().flatten(), r.float().flatten(), dim=0))
        for g, r in zip(sharded, grads))
    print(f"train_sharded (a) step 1 vs one device ({len(grads)} tensors): "
          f"loss {sharded_loss:.5f} vs {loss:.5f} (abs err "
          f"{loss_err:.3e}, tol {SHARDED_FIRST_LOSS_ATOL}), worst grad "
          f"max-abs-err/max-ref {grad_err:.3e} (tol {TRAIN_GRAD_RTOL}), "
          f"lowest cosine {cosine:.6f} (tol {TRAIN_GRAD_MIN_COSINE})")
    check(loss_err <= SHARDED_FIRST_LOSS_ATOL,
          f"train_sharded: step 1's loss differs from one device's by "
          f"{loss_err}")
    check(grad_err <= TRAIN_GRAD_RTOL and cosine >= TRAIN_GRAD_MIN_COSINE,
          f"train_sharded: step 1's gradients differ from one device's "
          f"({grad_err} of max, cosine {cosine})")


def sharded_moe_forward_check(torch, device):
    """(c) step 1's forward of the MoE model, sharded against one device:
    the rows that router near-ties send to other experts are counted
    (each a near-tie, MOE_ROUTE_MARGIN), the others' logits held at
    SLICE_LOGITS_ATOL."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply_with_aux, transformer_sharding_rules)
    from kubeshare_tpu_torch.parallel.mesh import (MeshSpec, make_mesh,
                                                   shard_params)

    config, params, tokens, _ = train_setup(torch, device, MOE_DIMS)
    mesh = make_mesh(MeshSpec(**SHARDED_MESH), devices=[device] * 4)
    with torch.no_grad():
        with MoERoutes() as routes:
            logits, aux = transformer_apply_with_aux(params, tokens, config)
        placed = shard_params(params, transformer_sharding_rules(), mesh)
        with ShardedMoERoutes() as sharded_routes:
            sharded, sharded_aux = transformer_apply_with_aux(placed, tokens,
                                                              config)
        sharded = sharded.gather()
    touched, moved, unexplained, widest = routing_differences(
        torch, routes.layers, sharded_routes.layers, config.moe_top_k)
    n = tokens.numel()
    row_err = (logits - sharded).abs().reshape(n, -1).max(dim=1).values
    err = float(row_err[~touched].max())
    print(f"train_sharded moe forward {tuple(tokens.shape)} sharded vs one "
          f"device: aux {float(sharded_aux):.6f} vs {float(aux):.6f}; "
          f"{int(touched.sum())}/{n} rows routed differently ({moved} moved "
          f"first, the widest at a margin of {widest:.4f}, {unexplained} at "
          f"a margin >= {MOE_ROUTE_MARGIN}); the other rows' logits max abs "
          f"err {err:.3e} (tol {SLICE_LOGITS_ATOL}), all rows "
          f"{float(row_err.max()):.3e}")
    check(unexplained == 0, f"train_sharded moe: {unexplained} rows routed "
                            f"differently at a margin >= {MOE_ROUTE_MARGIN}")
    check(err <= SLICE_LOGITS_ATOL,
          f"train_sharded moe: logits differ from one device's by {err}")


def sharded_moe_op_check(torch, device):
    """(d) moe_apply under moe_sharding_rules(ep_axis="ep") over dp=1 x
    ep=2 x tp=2 against the unsharded op on the card: x (2, 2048, 1024)
    bf16, the MoE model's experts; loss = mean(out^2) + aux coefficient x
    aux, its value and every gradient."""
    from kubeshare_tpu_torch.ops import moe
    from kubeshare_tpu_torch.parallel.mesh import (MeshSpec, ShardedTensor,
                                                   batch_sharding, device_put,
                                                   make_mesh, shard_params)
    from kubeshare_tpu_torch.parallel.spmd import sum_copies

    d, f, e = MOE_DIMS["d_model"], MOE_DIMS["d_ff"], MOE_DIMS["moe_num_experts"]
    config = moe.MoEConfig(d_model=d, d_ff=f, num_experts=e,
                           capacity_factor=MOE_DIMS["moe_capacity_factor"],
                           top_k=MOE_DIMS["moe_top_k"])
    params = moe.moe_init(config, torch.Generator().manual_seed(0), device)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, d),
                    generator=torch.Generator().manual_seed(1)).to(
                        device, torch.bfloat16)

    def loss_of(out, aux):
        out = out.gather() if isinstance(out, ShardedTensor) else out
        return out.float().square().mean() + MOE_AUX_COEF * aux

    leaves = {name: t.clone().requires_grad_() for name, t in params.items()}
    loss = loss_of(*moe.moe_apply(leaves, x, config))
    loss.backward()
    mesh = make_mesh(MeshSpec(dp=1, ep=2, tp=2), devices=[device] * 4)
    with torch.no_grad():
        placed = shard_params(params, moe.moe_sharding_rules("ep"), mesh,
                              copy=True)
    for leaf in placed.values():
        for shard in leaf.shards:
            shard.requires_grad_(True)
    reset_counts()
    sharded_loss = loss_of(*moe.moe_apply(
        placed, device_put(x, batch_sharding(mesh, 3)), config))
    sharded_loss.backward()
    sum_copies(placed.values())
    launches = read_counts()
    errs = {name: rel_err(leaf.grad.gather(), leaves[name].grad)
            for name, leaf in placed.items()}
    loss, sharded_loss = float(loss.detach()), float(sharded_loss.detach())
    loss_err = abs(sharded_loss - loss) / abs(loss)
    print(f"train_sharded moe op at x {tuple(x.shape)} bf16 under "
          f"moe_sharding_rules('ep') over dp=1 x ep=2 x tp=2: experts "
          f"{placed['w_in'].spec}, loss {sharded_loss:.6f} vs "
          f"unsharded {loss:.6f} (rel err {loss_err:.3e}); gradients "
          f"max-abs-err/max-ref " + ", ".join(
              f"{name} {err:.3e}" for name, err in sorted(errs.items()))
          + f" (tol {SHARDED_MOE_RTOL})")
    check(loss_err <= SHARDED_MOE_RTOL and max(errs.values()) <= SHARDED_MOE_RTOL,
          f"train_sharded moe op differs from the unsharded op: loss "
          f"{loss_err}, gradients {errs}")
    return launches


def train_sharded_phase(torch, device, dense, moe_losses):
    """The training half of the mesh at full width on the one card: (a)
    the train-step flagship over dp=2 x tp=2 under
    transformer_sharding_rules, eager then captured; (b) the same captured
    under transformer_fsdp_rules; (c) the MoE model captured (experts over
    tp); (d) moe_apply under moe_sharding_rules('ep').  ``dense`` and
    ``moe_losses``: the single-device captured runs of the train and moe
    phases.  Returns the launches by path."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_fsdp_rules, transformer_sharding_rules)
    from kubeshare_tpu_torch.parallel.mesh import P

    t0 = time.perf_counter()
    launches = {}
    sharded_grad_check(torch, device)
    torch.cuda.empty_cache()
    eager = sharded_train_run(torch, device, "(a) eager", TRAIN_DIMS,
                              transformer_sharding_rules(), capture=False)
    launches["train_sharded"] = eager["launches"]
    eager_losses = eager["losses"]
    del eager
    base = sharded_train_run(torch, device, "(a) captured", TRAIN_DIMS,
                             transformer_sharding_rules(), capture=True)
    launches["train_sharded_captured"] = base["launches"]
    hold_trajectory("(a) eager", eager_losses, dense["losses"])
    hold_trajectory("(a) captured", base["losses"], dense["losses"])
    hold_trajectory("(a) captured", base["losses"], eager_losses,
                    "the sharded eager run", CAPTURE_DRIFT_LOSS_ATOL)
    print(f"train_sharded (a) step, median: captured {base['median_ms']:.3f} "
          f"ms over 4 units against the single-device captured "
          f"{dense['median_ms']:.3f} ms ({base['median_ms'] / dense['median_ms']:.3f}x); "
          f"parameters + moments a unit {base['bytes'] / 2**20:.1f} MiB "
          f"against one device's {base['single_bytes'] / 2**20:.1f} MiB "
          f"({base['bytes'] / base['single_bytes']:.4f})")
    base_bytes, base_losses = base["bytes"], base["losses"]
    del base
    torch.cuda.empty_cache()

    fsdp = sharded_train_run(torch, device, "(b) fsdp captured", TRAIN_DIMS,
                             transformer_fsdp_rules(), capture=True)
    launches["train_sharded_fsdp"] = fsdp["launches"]
    embed = fsdp["state"].params["embed"].spec
    wq = fsdp["state"].params["layers"][0]["attn"]["wq"].spec
    ratio = fsdp["bytes"] / base_bytes
    print(f"train_sharded (b) placements: embed {embed}, wq {wq}; "
          f"parameters + moments a unit {ratio:.4f} of (a)'s; step median "
          f"{fsdp['median_ms']:.3f} ms")
    check(embed == P("tp", "dp") and wq == P("dp", "tp", None),
          f"train_sharded (b): embed {embed}, wq {wq}")
    check(0.5 <= ratio <= 0.52,
          f"train_sharded (b): a unit holds {ratio} of (a)'s bytes")
    hold_trajectory("(b) fsdp captured", fsdp["losses"], dense["losses"])
    # fsdp gathers whole weights before the products: (a)'s products on
    # the same operands (equal to the bit in the first card run)
    hold_trajectory("(b) fsdp captured", fsdp["losses"], base_losses,
                    "(a) captured", CAPTURE_SAME_LOSS_ATOL)
    del fsdp
    torch.cuda.empty_cache()

    sharded_moe_forward_check(torch, device)
    torch.cuda.empty_cache()
    moe_run = sharded_train_run(torch, device, "(c) moe captured", MOE_DIMS,
                                transformer_sharding_rules(), capture=True,
                                with_aux=True)
    launches["train_sharded_moe"] = moe_run["launches"]
    hold_trajectory("(c) moe captured", moe_run["losses"], moe_losses)
    del moe_run
    torch.cuda.empty_cache()
    launches["train_sharded_moe_op"] = sharded_moe_op_check(torch, device)
    check(launches["train_sharded_moe_op"] == only(),
          f"moe_apply launched {launches['train_sharded_moe_op']}")
    print(f"train sharded phase: {time.perf_counter() - t0:.1f} s")
    return launches


def lc_setup(torch, device, batch, seq, seed=11, **overrides):
    """The train-step flagship at ``seq`` tokens (max_seq_len ``seq``,
    weights from seed 0) and a batch of random tokens and targets (seed
    ``seed``), on the card."""
    from kubeshare_tpu_torch.models.transformer import (
        TransformerConfig, transformer_init)

    config = TransformerConfig(**{**TRAIN_DIMS, "max_seq_len": seq,
                                  "positional": "rope",
                                  "dtype": torch.bfloat16,
                                  "attention": "ring", **overrides})
    params = transformer_init(config, torch.Generator().manual_seed(0), device)
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, config.vocab_size, (batch, seq), generator=gen)
    targets = torch.randint(0, config.vocab_size, (batch, seq), generator=gen)
    return config, params, tokens.to(device), targets.to(device)


def lc_mesh(device, names, **axes):
    """A mesh over ``names`` naming the card once a shard."""
    import numpy as np

    from kubeshare_tpu_torch.parallel.mesh import Mesh

    shape = tuple(axes[name] for name in names)
    array = np.empty(int(np.prod(shape)), dtype=object)
    array[:] = [device] * array.size
    return Mesh(array.reshape(shape), names)


def lc_single(torch, config, params, tokens):
    """The single-device forward of the same tokens with the flash
    kernel (``attention="flash"``): the logits every long-context path is
    held to."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply

    with torch.no_grad():
        return transformer_apply(params, tokens, dataclasses.replace(
            config, attention="flash"))


def lc_logits_error(torch, what, logits, reference, must_pass=True):
    """max |logits - reference| (gathered) at LC_LOGITS_ATOL; a control
    passes ``must_pass=False``: the limit must refuse it."""
    got = logits.gather() if hasattr(logits, "shards") else logits
    diff = (got - reference).abs()
    err, mean = float(diff.max()), float(diff.mean())
    del got, diff
    print(f"long_context {what} logits vs the single-device flash forward: "
          f"max abs err {err:.4e} (tol {LC_LOGITS_ATOL}), mean {mean:.4e}, "
          f"max |logit| {float(reference.abs().max()):.3f}")
    check(math.isfinite(err) and (err <= LC_LOGITS_ATOL) == must_pass,
          f"long_context {what}: logits err {err} " + (
              "over the limit" if must_pass
              else "within the limit: it does not refuse the control"))
    return err


def lc_rope_at_offset_zero():
    """Control: every shard's RoPE at offset 0 (positions relative to the
    shard's first token) in the sharded forward."""
    from unittest import mock

    from kubeshare_tpu_torch.models import transformer

    rope = transformer.apply_rope
    return mock.patch.object(transformer, "apply_rope",
                             lambda x, pos: rope(x, pos - pos[0]))


def lc_no_diagonal_mask():
    """Control: the ring's diagonal blocks without their causal mask."""
    import importlib
    from unittest import mock

    ring = importlib.import_module("kubeshare_tpu_torch.ops.ring_attention")
    partial = ring._partial_flash
    return mock.patch.object(ring, "_partial_flash",
                             lambda q, k, v, causal: partial(q, k, v, False))


def lc_expect(label, launches, fwd, bwd=0):
    check(launches == {**only(), "flash_fwd": fwd, "flash_bwd_dkv": bwd,
                       "flash_bwd_dq": bwd},
          f"long_context {label} launched {launches}, expected flash_fwd "
          f"{fwd} and each backward kernel {bwd}")


def lc_train(torch, label, apply, mesh, params, tokens, targets, steps,
             capture=False, rules=None):
    """``steps`` AdamW steps through make_train_step (on ``mesh`` when
    given) from ``params``, timed by CUDA events: (state, losses, step ms,
    host enqueue ms, launches)."""
    from kubeshare_tpu_torch.parallel.train import make_train_step

    init_state, train_step = make_train_step(
        apply, mesh=mesh, param_rules=rules if mesh is not None else None,
        capture=capture)
    state = init_state(clone_tree(params))
    torch.cuda.synchronize()
    reset_counts()
    state, losses, step_ms, enqueue_ms = timed_steps(
        torch, train_step, state, [(tokens, targets)] * steps)
    launches = read_counts()
    check(all(math.isfinite(x) for x in losses),
          f"long_context {label}: non-finite loss {losses}")
    check(losses[-1] < losses[0],
          f"long_context {label}: the loss did not fall: {losses}")
    print(f"long_context {label} {steps} steps: launches {launches}, losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; step ms "
          + " ".join(f"{x:.2f}" for x in step_ms))
    return state, losses, step_ms, enqueue_ms, launches


def lc_leaves(state):
    """A run's parameters (gathered where placed), for the trajectory
    arithmetic."""
    from kubeshare_tpu_torch.parallel.train import tree_leaves

    return [leaf.gather() if hasattr(leaf, "shards") else leaf.detach()
            for leaf in tree_leaves(state.params)]


def lc_single_run(torch, label, config, params, tokens, targets):
    """LC_DRIFT_STEPS single-device steps with the flash kernel: (the
    run's (losses, parameters), the initial parameters, the steady step
    median) that a sequence-parallel run is held to."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply
    from kubeshare_tpu_torch.parallel.train import tree_leaves

    initial = [leaf.detach().clone() for leaf in tree_leaves(params)]
    flash = dataclasses.replace(config, attention="flash")
    state, losses, step_ms, _, _ = lc_train(
        torch, f"{label} single device", lambda p, t: transformer_apply(
            p, t, flash), None, params, tokens, targets, LC_DRIFT_STEPS)
    return (losses, lc_leaves(state)), initial, steady_median(step_ms)


def lc_ring_phase(torch, device, launches):
    """(a) the contiguous hybrid ring over sp=4 at 1 x LC_SEQ: logits
    against the single-device flash forward (and the two controls), ten
    eager steps against ten single-device steps (and the RoPE control's),
    the same ten steps captured; returns the single-device run, its
    initial parameters and its step median (Ulysses is held to them)."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply_ring
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import CAPTURE_WARMUP_STEPS

    config, params, tokens, targets = lc_setup(torch, device, 1, LC_SEQ)
    mesh = make_mesh(MeshSpec(dp=1, sp=LC_SP), devices=[device] * LC_SP)
    reference = lc_single(torch, config, params, tokens)
    with torch.no_grad():
        lc_logits_error(torch, "(a) ring sp=4", transformer_apply_ring(
            params, tokens, config, mesh), reference)
        with lc_rope_at_offset_zero():
            lc_logits_error(torch, "(a) control: RoPE at offset 0 on every "
                            "shard", transformer_apply_ring(
                                params, tokens, config, mesh), reference,
                            must_pass=False)
    del reference
    torch.cuda.empty_cache()

    single_run, initial, single_ms = lc_single_run(
        torch, "(a)", config, params, tokens, targets)
    ring_apply = lambda p, t: transformer_apply_ring(p, t, config, mesh)
    torch.cuda.reset_peak_memory_stats()
    state, losses, step_ms, enqueue_ms, ring_launches = lc_train(
        torch, "(a) ring sp=4 eager", ring_apply, mesh, params, tokens,
        targets, LC_DRIFT_STEPS, rules={})
    peak = torch.cuda.max_memory_allocated() / 2**30
    passes = LC_DRIFT_STEPS * config.n_layers * LC_SP
    lc_expect("(a) ring", ring_launches, passes)
    launches["ring"] = ring_launches
    eager_run = (losses, lc_leaves(state))
    eager_ms = steady_median(step_ms)
    del state
    limits = (LC_DRIFT_LOSS_ATOL, LC_DRIFT_UPDATE_RTOL)
    hold_drift("long_context (a) ring eager vs single device", eager_run,
               single_run, initial, limits, first_atol=LC_FIRST_LOSS_ATOL)
    torch.cuda.empty_cache()
    with lc_rope_at_offset_zero():
        state, losses, _, _, _ = lc_train(
            torch, "(a) control: RoPE at offset 0", ring_apply, mesh, params,
            tokens, targets, LC_DRIFT_STEPS, rules={})
    hold_drift("long_context (a) control: RoPE at offset 0 vs single device",
               (losses, lc_leaves(state)), single_run, initial, limits,
               must_pass=False, first_atol=LC_FIRST_LOSS_ATOL)
    del state
    torch.cuda.empty_cache()

    state, losses, step_ms, enqueue_ms, captured_launches = lc_train(
        torch, "(a) ring sp=4 captured", ring_apply, mesh, params, tokens,
        targets, LC_DRIFT_STEPS, capture=True, rules={})
    lc_expect("(a) ring captured", captured_launches,
              (CAPTURE_WARMUP_STEPS + 1) * config.n_layers * LC_SP)
    launches["ring_captured"] = captured_launches
    hold_drift("long_context (a) ring captured vs eager",
               (losses, lc_leaves(state)), eager_run, initial,
               (CAPTURE_DRIFT_LOSS_ATOL, CAPTURE_DRIFT_UPDATE_RTOL))
    captured_ms = steady_median(step_ms)
    print(f"long_context (a) step, median of steps {TRAIN_TIMED_FROM}-"
          f"{LC_DRIFT_STEPS} at 1 x {LC_SEQ} tokens (CUDA events): ring sp=4 "
          f"eager {eager_ms:.3f} ms, captured {captured_ms:.3f} ms (host "
          f"enqueue {steady_median(enqueue_ms):.3f} ms), single device "
          f"eager {single_ms:.3f} ms; captured ring / single "
          f"{captured_ms / single_ms:.3f}; {LC_SEQ / (captured_ms * 1e-3):.0f} "
          f"tokens/s captured; peak memory (eager ring) {peak:.2f} GiB")
    del state
    torch.cuda.empty_cache()
    return single_run, initial, single_ms


def lc_zigzag_phase(torch, device, launches):
    """(b) the zigzag ring over dp=2 x tp=2 x sp=2 under the fsdp rules at
    LC_ZIGZAG_SHAPE: logits against the single-device forward (and the
    no-diagonal-mask control), LC_DRIFT_STEPS AdamW steps against as
    many single-device steps."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply_ring, transformer_fsdp_rules)
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    batch, seq = LC_ZIGZAG_SHAPE
    config, params, tokens, targets = lc_setup(torch, device, batch, seq)
    units = math.prod(LC_ZIGZAG_MESH.values())
    mesh = make_mesh(MeshSpec(**LC_ZIGZAG_MESH), devices=[device] * units)
    rules = transformer_fsdp_rules()
    reference = lc_single(torch, config, params, tokens)
    apply = lambda p, t: transformer_apply_ring(p, t, config, mesh,
                                                layout="zigzag")
    with torch.no_grad():
        from kubeshare_tpu_torch.parallel.mesh import shard_params

        placed = shard_params(params, rules, mesh)
        lc_logits_error(torch, "(b) zigzag dp=2 x tp=2 x sp=2",
                        apply(placed, tokens), reference)
        with lc_no_diagonal_mask():
            lc_logits_error(torch, "(b) control: the diagonal blocks "
                            "unmasked", apply(placed, tokens), reference,
                            must_pass=False)
        del placed
    del reference
    torch.cuda.empty_cache()
    single_run, initial, single_ms = lc_single_run(
        torch, "(b)", config, params, tokens, targets)
    state, losses, step_ms, _, zigzag_launches = lc_train(
        torch, "(b) zigzag", apply, mesh, params, tokens, targets,
        LC_DRIFT_STEPS, rules=rules)
    # a unit's diagonal step launches the kernel on its two quadrants
    lc_expect("(b) zigzag", zigzag_launches,
              LC_DRIFT_STEPS * config.n_layers * units * 2)
    launches["zigzag"] = zigzag_launches
    limits = (LC_ZIGZAG_DRIFT_LOSS_ATOL, LC_DRIFT_UPDATE_RTOL)
    hold_drift("long_context (b) zigzag vs single device",
               (losses, lc_leaves(state)), single_run, initial, limits,
               first_atol=LC_FIRST_LOSS_ATOL)
    print(f"long_context (b) zigzag step at {batch} x {seq} tokens, median "
          f"of steps {TRAIN_TIMED_FROM}-{LC_DRIFT_STEPS} (CUDA events): "
          f"{steady_median(step_ms):.3f} ms, single device "
          f"{single_ms:.3f} ms; wq placed "
          f"{state.params['layers'][0]['attn']['wq'].spec}")
    del state
    torch.cuda.empty_cache()
    with lc_rope_at_offset_zero():
        state, losses, _, _, _ = lc_train(
            torch, "(b) control: RoPE at offset 0", apply, mesh, params,
            tokens, targets, LC_DRIFT_STEPS, rules=rules)
    hold_drift("long_context (b) control: RoPE at offset 0 vs single device",
               (losses, lc_leaves(state)), single_run, initial, limits,
               must_pass=False, first_atol=LC_FIRST_LOSS_ATOL)
    del state, single_run, initial
    torch.cuda.empty_cache()


def lc_ulysses_phase(torch, device, launches, single):
    """(c) Ulysses over sp=4 at 1 x LC_SEQ: logits against the
    single-device forward, LC_DRIFT_STEPS AdamW steps against ``single``
    ((a)'s single-device run of the same weights and tokens, its
    initial parameters and step median)."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply_ulysses
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    config, params, tokens, targets = lc_setup(torch, device, 1, LC_SEQ,
                                               attention="ulysses")
    mesh = make_mesh(MeshSpec(dp=1, sp=LC_SP), devices=[device] * LC_SP)
    apply = lambda p, t: transformer_apply_ulysses(p, t, config, mesh)
    reference = lc_single(torch, config, params, tokens)
    with torch.no_grad():
        lc_logits_error(torch, "(c) ulysses sp=4", apply(params, tokens),
                        reference)
    del reference
    torch.cuda.empty_cache()
    state, losses, step_ms, _, ulysses_launches = lc_train(
        torch, "(c) ulysses", apply, mesh, params, tokens, targets,
        LC_DRIFT_STEPS, rules={})
    # every member attends over the whole sequence on n_heads / sp heads
    passes = LC_DRIFT_STEPS * config.n_layers * LC_SP
    lc_expect("(c) ulysses", ulysses_launches, passes, passes)
    launches["ulysses"] = ulysses_launches
    single_run, initial, single_ms = single
    hold_drift("long_context (c) ulysses vs single device",
               (losses, lc_leaves(state)), single_run, initial,
               (LC_DRIFT_LOSS_ATOL, LC_DRIFT_UPDATE_RTOL),
               first_atol=LC_FIRST_LOSS_ATOL)
    print(f"long_context (c) ulysses step at 1 x {LC_SEQ} tokens, median of "
          f"steps {TRAIN_TIMED_FROM}-{LC_DRIFT_STEPS} (CUDA events): "
          f"{steady_median(step_ms):.3f} ms, single device {single_ms:.3f} "
          f"ms; the flash kernels at {LC_ULYSSES_SHAPE}")
    del state
    torch.cuda.empty_cache()


def lc_forget_one_cotangent():
    """Control: the 1F1B step's second microbatch seeds no cotangent (its
    loss keeps its value, its gradient is zero)."""
    import itertools
    from unittest import mock

    from kubeshare_tpu_torch.models import transformer

    loss_fn = transformer.cross_entropy_loss
    calls = itertools.count()

    def forgetful(logits, targets):
        value = loss_fn(logits, targets)
        # the loss is called once a sequence member, microbatch-major
        if next(calls) // LC_PP_SP == 1:
            return value.detach() + 0 * value
        return value

    return mock.patch.object(transformer, "cross_entropy_loss", forgetful)


def lc_pipeline_phase(torch, device, launches):
    """(d) the 1F1B schedule over pp=2 x sp=2, the hybrid ring in-stage,
    LC_PP_MICRO microbatches of LC_PP_SHAPE: step 1's loss and gradients
    against autograd through transformer_apply_ring over sp=2 (and the
    forgotten-cotangent control), then LC_STEPS AdamW steps."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply_ring, transformer_train_1f1b)
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import (adamw, cross_entropy_loss,
                                                    tree_leaves)

    batch, seq = LC_PP_SHAPE
    config, params, tokens, targets = lc_setup(torch, device, batch, seq)
    pp_mesh = lc_mesh(device, ("pp", "sp"), pp=LC_PP, sp=LC_PP_SP)

    def step():
        return transformer_train_1f1b(params, tokens, targets, config,
                                      pp_mesh, num_microbatches=LC_PP_MICRO)

    def errors(grads, ref):
        rel = max(rel_err(g, r) for g, r in zip(grads, ref))
        cosine = min(float(torch.nn.functional.cosine_similarity(
            g.float().flatten(), r.float().flatten(), dim=0))
            for g, r in zip(grads, ref))
        return rel, cosine

    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    mesh = make_mesh(MeshSpec(dp=1, sp=LC_PP_SP), devices=[device] * LC_PP_SP)
    loss = cross_entropy_loss(transformer_apply_ring(params, tokens, config,
                                                     mesh), targets)
    ref = torch.autograd.grad(loss, leaves)
    ref_loss = float(loss.detach())
    del loss
    for leaf in leaves:
        leaf.requires_grad_(False)
    torch.cuda.empty_cache()
    for what, control in (("(d) 1f1b", None),
                          ("(d) control: one microbatch's cotangent "
                           "forgotten", lc_forget_one_cotangent)):
        reset_counts()
        if control is None:
            got_loss, grads = step()
            step_launches = read_counts()
        else:
            with control():
                got_loss, grads = step()
        loss_err = abs(float(got_loss) - ref_loss)
        rel, cosine = errors(tree_leaves(grads), ref)
        del grads
        print(f"long_context {what} step 1 vs autograd through the ring on "
              f"sp={LC_PP_SP}: loss {float(got_loss):.5f} vs {ref_loss:.5f} "
              f"(abs err {loss_err:.3e}, tol {LC_1F1B_LOSS_ATOL}), worst "
              f"grad max-abs-err/max-ref {rel:.3e} (tol {LC_1F1B_GRAD_RTOL}), "
              f"lowest cosine {cosine:.6f} (tol {TRAIN_GRAD_MIN_COSINE})")
        within = (loss_err <= LC_1F1B_LOSS_ATOL and rel <= LC_1F1B_GRAD_RTOL
                  and cosine >= TRAIN_GRAD_MIN_COSINE)
        check(within == (control is None),
              f"long_context {what}: " + ("outside the limits"
                                          if control is None else
                                          "the limits do not refuse it"))
    del ref
    torch.cuda.empty_cache()
    # microbatches x layers x sequence members, one diagonal each
    passes = LC_PP_MICRO * config.n_layers * LC_PP_SP
    lc_expect("(d) 1f1b", step_launches, passes)
    opt = adamw(1e-3)(leaves)
    losses, step_ms = [], []
    reset_counts()
    for _ in range(LC_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        loss, grads = step()
        for leaf, grad in zip(leaves, tree_leaves(grads)):
            leaf.grad = grad
        opt.step()
        opt.zero_grad(set_to_none=True)
        end.record()
        losses.append(loss)
        step_ms.append((start, end))
        del grads
    pipeline_launches = read_counts()
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in step_ms]
    lc_expect("(d) 1f1b steps", pipeline_launches, LC_STEPS * passes)
    launches["pipeline_1f1b"] = pipeline_launches
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"long_context (d) 1f1b: the loss did not fall: {losses}")
    print(f"long_context (d) 1f1b {LC_STEPS} AdamW steps of {batch} x {seq} "
          f"tokens ({LC_PP_MICRO} microbatches, pp={LC_PP} x sp={LC_PP_SP}): "
          f"launches {pipeline_launches}, losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; step ms "
          + " ".join(f"{x:.2f}" for x in step_ms))
    del opt, leaves, params
    torch.cuda.empty_cache()


def lc_diagonal_timing(torch, device):
    """Row 1c: the ring's diagonal partial (``_partial_flash``, the flash
    forward kernel, causal) at LC_DIAG_SHAPE, beside its plain version,
    SDPA at the same shape and the bound."""
    import importlib

    import torch.nn.functional as F
    from kubeshare_tpu_torch.ops import attention as A

    ring = importlib.import_module("kubeshare_tpu_torch.ops.ring_attention")
    gen = torch.Generator(device=device).manual_seed(4321)
    q, k, v = (torch.randn(LC_DIAG_SHAPE, generator=gen, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    out, lse = ring._partial_flash(q, k, v, True)
    ref_out, ref_lse = A.flash_forward_reference(q, k, v, True)
    err = check_forward(torch, f"kernel flash_fwd ring diagonal "
                        f"{LC_DIAG_SHAPE}", out.to(q.dtype), lse[..., None],
                        ref_out, ref_lse)
    ms = time_ms(lambda: ring._partial_flash(q, k, v, True))
    plain_ms = time_ms(lambda: A.flash_forward_reference(q, k, v, True))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    bound_ms, bound_by = flash_bound(LC_DIAG_SHAPE, LC_DIAG_SHAPE[1],
                                     "bfloat16", True, None)
    tflops, ratio = achieved("flash_fwd", LC_DIAG_SHAPE, ms, library_ms,
                             visible_pairs(LC_DIAG_SHAPE[2], True, None))
    print(f"kernel flash_fwd ring diagonal (row 1c) timing at "
          f"{LC_DIAG_SHAPE} bfloat16 causal: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); {tflops:.1f} TFLOP/s, "
          f"{ratio:.3f}x library")
    return err, {"shape": list(LC_DIAG_SHAPE), "dtype": "bfloat16",
                 "path": "ring_diagonal", "ms": ms, "plain_ms": plain_ms,
                 "library_ms": library_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "tflops": tflops,
                 "library_ratio": ratio}


def long_context_phase(torch, device):
    """Long context on the card at full width: (a) the ring, (b) the
    zigzag ring over dp x tp x sp, (c) Ulysses, (d) 1F1B x sp, and row
    1c's timing.  Returns (launches by path, the diagonal's error and
    timing)."""
    t0 = time.perf_counter()
    launches = {}
    diag_err, diag_timing = lc_diagonal_timing(torch, device)
    single = lc_ring_phase(torch, device, launches)
    lc_zigzag_phase(torch, device, launches)
    lc_ulysses_phase(torch, device, launches, single)
    del single
    lc_pipeline_phase(torch, device, launches)
    print(f"long context phase: {time.perf_counter() - t0:.1f} s")
    return launches, diag_err, diag_timing

# ---------------------------------------------------------------------------
# distributed and discovery: the DDP gang worker over torch.distributed and
# the node side (device discovery, the collector, the per-chip supervisor)
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_listening(port: int, timeout: float = 30.0) -> None:
    import socket

    deadline = time.monotonic() + timeout
    while True:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            check(time.monotonic() < deadline,
                  f"nothing listens on port {port} after {timeout} s")
            time.sleep(0.05)


def ddp_leaves(state):
    """The optimizer's parameters (the mesh's shards), in its order."""
    return [p for group in state.opt_state.param_groups
            for p in group["params"]]


def params_digest(torch, leaves) -> str:
    """sha256 of every parameter's bytes: equal digests, equal bits."""
    import hashlib

    flat = torch.cat([p.detach().reshape(-1) for p in leaves])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def ddp_run(torch, T, args, device, tokens, steps, distributed,
            grads_out=None, **options):
    """``steps`` steps of train_distributed_torch's step (``options`` to
    make_train_step, e.g. ``capture=True``) on ``tokens`` from the seed's
    weights: (losses, digests, step ms by CUDA events, host ms, launches,
    state, initial parameters); step 1's gradients, read before the
    optimizer (after the all-reduce when ``distributed``), are appended
    to ``grads_out``."""
    _, init_state, train_step, params = T.setup(args, device, distributed,
                                                 **options)
    state = init_state(params)
    leaves = ddp_leaves(state)
    initial = [p.detach().clone() for p in leaves]
    if grads_out is not None:
        state.opt_state.register_step_pre_hook(
            lambda *_: None if grads_out else grads_out.extend(
                p.grad.detach().clone() for p in leaves))
    losses, digests, step_ms, host_ms = [], [], [], []
    reset_counts()
    for _ in range(steps):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        start.record()
        state, loss = train_step(state, tokens, tokens)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
        digests.append(params_digest(torch, leaves))
    return losses, digests, step_ms, host_ms, read_counts(), state, initial


def ddp_worker(torch, out_dir: str) -> int:
    """One rank of the distributed phase (``chip_smoke.py --ddp-worker
    DIR``, the gang env set): DDP_STEPS steps of the shipped step;
    DDP_NCCL_STEPS captured (two graphs around gloo's all-reduce) and as
    many eager with the same capturable AdamW; then the controls (the sum
    without the division, DDP_STEPS steps; no all-reduce, one step), each
    from the seed's weights; then distributed (d)'s to (h)'s runs
    (``tp_run``, ``sp_run``, ``moe_rank_run``, ``pp_rank_run``,
    ``resnet_rank_run``).  Writes its record to DIR/rank<r>.json; rank 0 also saves step 1's
    gradients and each run's last parameters."""
    import train_distributed_torch as T
    from kubeshare_tpu_torch.parallel import train as port_train
    from kubeshare_tpu_torch.parallel.distributed import initialize_from_env

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # the parent's numerics (main): f32 products and convolutions without
    # TF32, so (h)'s ranks run the one-process mesh's convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # two ranks on one card: NCCL refuses a duplicate GPU
    spec = initialize_from_env(backend="gloo", device=device)
    rank, world = spec.process_id, spec.num_processes
    args = T.parse_args([])
    tokens = T.rank_rows(T.global_batch(T.model_config(args), args), rank,
                         world).to(device)
    record = {}

    def run(label, steps, **options):
        grads = []
        losses, digests, step_ms, host_ms, launches, state, _ = ddp_run(
            torch, T, args, device, tokens, steps, True,
            None if options else grads, **options)
        record[label] = dict(losses=losses, digests=digests,
                             step_ms=step_ms, host_ms=host_ms,
                             launches=launches)
        if rank == 0:
            if grads:
                torch.save([g.cpu() for g in grads],
                           f"{out_dir}/grads_{label}.pt")
            torch.save([p.detach().cpu() for p in ddp_leaves(state)],
                       f"{out_dir}/params_{label}.pt")

    shipped = port_train.GroupMean.all_reduce, port_train.GroupMean.unflatten
    reduce_ms = []

    def timed_all_reduce(self):
        # the flats' host copy waits for the backward anyway: synchronise
        # first, so the time is the transport's alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shipped[0](self)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    port_train.GroupMean.all_reduce = timed_all_reduce
    run("shipped", DDP_STEPS)
    record["shipped"]["all_reduce_ms"] = reduce_ms
    port_train.GroupMean.all_reduce = shipped[0]
    run("captured", DDP_NCCL_STEPS, capture=True)
    run("captured_same", DDP_NCCL_STEPS, optimizer=capturable_adamw(device))

    def undivided(self):
        # the gradients summed over the ranks and not divided (the loss
        # still the mean): a missing division by the world size
        shipped[1](self)
        for bucket in self.buckets:
            for t in bucket:
                if t is not self.loss:
                    t.mul_(self.size)

    port_train.GroupMean.unflatten = undivided
    run("undivided", DDP_STEPS)
    port_train.GroupMean.all_reduce = lambda self: None
    port_train.GroupMean.unflatten = lambda self: None
    run("no_all_reduce", 1)
    port_train.GroupMean.all_reduce, port_train.GroupMean.unflatten = shipped
    record["tp"] = tp_run(torch, out_dir, rank, world)
    torch.cuda.empty_cache()
    record["sp"] = sp_run(torch, out_dir, rank)
    torch.cuda.empty_cache()
    record["moe"] = moe_rank_run(torch, out_dir, rank)
    torch.cuda.empty_cache()
    record["pp"] = pp_rank_run(torch, rank)
    torch.cuda.empty_cache()
    record["resnet"] = resnet_rank_run(torch)
    torch.distributed.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(record, f)
    return 0


def run_ranks(cmd, envs, out_dir, timeout_s):
    """Start one process per env (stdout and stderr into ``out_dir``) and
    wait for all of them by one deadline.  A rank that exits non-zero or
    a deadline passed kills the others and fails the run."""
    import os

    procs = []
    try:
        for rank, extra in enumerate(envs):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("TPUSHARE_")}
            env.update(extra)
            with open(f"{out_dir}/rank{rank}.out", "w") as out, \
                    open(f"{out_dir}/rank{rank}.err", "w") as err:
                procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                              stderr=err))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(f"{out_dir}/rank{rank}.err") as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"rank {rank} exited {p.returncode} (a "
                               f"negative code: killed at the "
                               f"{timeout_s} s limit or by a peer's "
                               f"failure): {tail}")


def ddp_two_ranks(torch, device, T, args):
    """(a): two gloo ranks of the full-width DDP step on the card against
    one process's step over the whole global batch, eager and captured.
    Returns the launches of the ranks' eager and captured runs (summed
    over the ranks) and of the one process, the one process's losses,
    and (d)'s, (e)'s and (f)'s: the ranks' records and final parameters
    by run."""
    import os
    import tempfile

    from kubeshare_tpu_torch.parallel.train import CAPTURE_WARMUP_STEPS

    tokens = T.global_batch(T.model_config(args), args).to(device)
    grads = []
    losses, _, step_ms, host_ms, single_launches, state, initial = ddp_run(
        torch, T, args, device, tokens, DDP_STEPS, False, grads)
    reference = (losses, ddp_leaves(state))
    per_step = only("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    n_layers = T.model_config(args).n_layers
    expect = {name: n * n_layers * DDP_STEPS for name, n in per_step.items()}
    check(single_launches == expect,
          f"one process launched {single_launches}, expected {expect}")
    print(f"distributed (a) one process, {args.batch} x {args.seq} tokens: "
          f"losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; step ms {steady_median(step_ms):.3f} by CUDA events "
          f"(median of steps {TRAIN_TIMED_FROM}-{DDP_STEPS}), host "
          f"{steady_median(host_ms):.3f}")
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out:
        port = free_port()
        t0 = time.perf_counter()
        run_ranks([sys.executable, os.path.abspath(__file__), "--ddp-worker",
                   out],
                  [{"TPUSHARE_GANG_NAME": "ddp",
                    "TPUSHARE_GANG_SIZE": str(DDP_WORLD),
                    "TPUSHARE_GANG_RANK": str(rank),
                    "TPUSHARE_COORDINATOR": f"127.0.0.1:{port}",
                    "PYTHONPATH": here} for rank in range(DDP_WORLD)],
                  out, DDP_RANK_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        records = []
        for rank in range(DDP_WORLD):
            with open(f"{out}/rank{rank}.json") as f:
                records.append(json.load(f))
        loaded = {name: [t.to(device) for t in torch.load(
            f"{out}/{name}.pt")] for name in (
            "grads_shipped", "grads_undivided", "params_shipped",
            "params_undivided", "params_captured", "params_captured_same",
            "params_tp", "params_sp_zigzag", "params_sp_ulysses",
            "params_moe")}
    shipped = [r["shipped"] for r in records]
    for rank, run in enumerate(shipped):
        print(f"distributed (a) rank {rank}/{DDP_WORLD} (gloo, cuda:0, "
              f"{args.batch // DDP_WORLD} x {args.seq} tokens): launches "
              f"{run['launches']}; step ms {steady_median(run['step_ms']):.3f}"
              f" by CUDA events (median of steps {TRAIN_TIMED_FROM}-"
              f"{DDP_STEPS}; " + " ".join(f"{x:.1f}" for x in run["step_ms"])
              + f"), host {steady_median(run['host_ms']):.3f}; of it the "
              f"all-reduce (host copy, gloo, copy back) "
              f"{steady_median(run['all_reduce_ms']):.3f} ms")
        check(run["launches"] == expect,
              f"rank {rank} launched {run['launches']}, expected {expect}")
    equal_steps = sum(a == b for a, b in zip(shipped[0]["digests"],
                                            shipped[1]["digests"]))
    print(f"distributed (a) ranks' parameters equal to the bit after "
          f"{equal_steps}/{DDP_STEPS} steps (sha256); the ranks' processes "
          f"took {ranks_s:.1f} s ((a)'s runs, then (d)'s)")
    check(equal_steps == DDP_STEPS and shipped[0]["losses"]
          == shipped[1]["losses"], "the ranks' parameters or losses differ")
    grad_err = max(rel_err(g, r) for g, r in zip(loaded["grads_shipped"],
                                                 grads))
    sum_err = max(rel_err(g, r) for g, r in zip(loaded["grads_undivided"],
                                                grads))
    print(f"distributed (a) step 1's gradients against one process's over "
          f"the global batch ({len(grads)} tensors): worst max-abs-err/"
          f"max-ref {grad_err:.3e} (tol {DDP_GRAD_RTOL:g}); control, the sum "
          f"without the division: {sum_err:.3e}")
    check(grad_err <= DDP_GRAD_RTOL,
          f"step 1's gradients differ from one process's by {grad_err}")
    check(sum_err > DDP_GRAD_RTOL,
          f"the gradient check does not refuse the undivided sum ({sum_err})")
    hold_drift("distributed (a) 2 ranks vs one process",
               (shipped[0]["losses"], loaded["params_shipped"]), reference,
               initial, (DDP_DRIFT_LOSS_ATOL, DDP_DRIFT_UPDATE_RTOL),
               first_atol=DDP_FIRST_LOSS_ATOL)
    first, loss_err, update_err, _ = trajectory_errors(
        (records[0]["undivided"]["losses"], loaded["params_undivided"]),
        reference, initial)
    print(f"distributed (a) control, the sum without the division, "
          f"{DDP_STEPS} steps: step 1 loss abs err {first:.3e}, max "
          f"{loss_err:.3e}, update {update_err:.3e} (Adam scales the doubled "
          f"gradient away: the gradient check refuses it)")
    captured = [r["captured"] for r in records]
    per_capture = {name: n * n_layers * (CAPTURE_WARMUP_STEPS + 1)
                   for name, n in per_step.items()}
    print(f"distributed (a) {DDP_WORLD} gloo ranks captured (forward + "
          f"backward, gloo's all-reduce, the optimizer: two graphs), "
          f"{DDP_NCCL_STEPS} steps: losses " + " ".join(
              f"{x:.4f}" for x in captured[0]["losses"])
          + f"; step ms " + ", ".join(" ".join(f"{x:.1f}" for x in
                                               run["step_ms"])
                                      for run in captured)
          + f" by CUDA events; launches around the capture "
          f"{captured[0]['launches']}")
    for rank, run in enumerate(captured):
        check(run["launches"] == per_capture,
              f"rank {rank} captured with {run['launches']}, expected "
              f"{per_capture}")
    check(captured[0]["digests"] == captured[1]["digests"],
          "the captured ranks' parameters differ")
    hold_drift("distributed (a) captured ranks vs eager ranks with the "
               "same optimizer",
               (captured[0]["losses"], loaded["params_captured"]),
               (records[0]["captured_same"]["losses"],
                loaded["params_captured_same"]), initial,
               (CAPTURE_SAME_LOSS_ATOL, CAPTURE_SAME_UPDATE_RTOL))
    apart = [records[r]["no_all_reduce"]["digests"][0]
             for r in range(DDP_WORLD)]
    print(f"distributed (a) control, no all-reduce: the ranks' parameters "
          f"after step 1 equal: {apart[0] == apart[1]}")
    check(apart[0] != apart[1],
          "the ranks stayed equal without the all-reduce")
    return ({name: sum(r["shipped"]["launches"][name] for r in records)
             for name in expect},
            {name: sum(r["captured"]["launches"][name] for r in records)
             for name in expect}, single_launches, losses,
            {"tp": ([r["tp"] for r in records], loaded["params_tp"]),
             "sp": ([r["sp"] for r in records],
                    {kind: loaded[f"params_sp_{kind}"]
                     for kind in ("zigzag", "ulysses")}),
             "moe": ([r["moe"] for r in records], loaded["params_moe"]),
             "pp": [r["pp"] for r in records],
             "resnet": [r["resnet"] for r in records]})


def gloo_cuda_probe(torch) -> dict:
    """Which of gloo's collectives take CUDA tensors (bf16, on this
    rank's card) themselves; the rank mesh's transport stages through the
    host and uses gloo's CPU collectives either way."""
    import torch.distributed as dist

    x = torch.arange(8, device="cuda", dtype=torch.bfloat16)
    calls = {
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(16, device="cuda", dtype=x.dtype), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device="cuda", dtype=x.dtype), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(8, device="cuda", dtype=x.dtype), x),
    }
    found = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            found[name] = "takes CUDA tensors"
        except (RuntimeError, ValueError) as e:
            found[name] = f"refuses them ({str(e).splitlines()[0][:80]})"
        dist.barrier()
    return found


class RankCollectives:
    """Every transfer of the rank mesh's lines (``spmd.RankLine``: the
    gather, the reduce-scatter, the all-to-all, the shift, the chunk
    exchange, the pipeline's point-to-point hops and their completion,
    the broadcast of a stage's result) timed with the device
    synchronised around it, and the bytes this rank receives from the
    others counted, step by step (:meth:`step` opens a step); ``by``
    keeps each transfer's ms a step."""

    NAMES = ("gather", "scatter_sum", "all_to_all", "shift", "exchange",
             "send", "recv", "wait", "broadcast")

    def __init__(self, torch):
        self.torch = torch
        self.ms, self.received = [], []
        self.by = {name: [] for name in self.NAMES}

    @staticmethod
    def received_bytes(name, line, args) -> int:
        n = line.size
        if name in ("send", "wait"):
            return 0
        if name in ("recv", "broadcast"):
            if name == "broadcast" and args[1] == line.index:
                return 0  # the member that sends
            return sum(x.numel() * x.element_size() for x in args[0])
        if name == "exchange":
            _, expect, like = args
            return sum(count for m, count in expect.items()
                       if m != line.index) * like.numel() * like.element_size()
        if name == "shift":
            offset = args[1] if len(args) > 1 else 1
            return (0 if offset % n == 0 else
                    sum(x.numel() * x.element_size() for x in args[0]))
        x = args[0]
        share = (n - 1) if name == "gather" else (n - 1) / n
        return int(x.numel() * x.element_size() * share)

    def step(self) -> None:
        self.ms.append(0.0)
        self.received.append(0)
        for times in self.by.values():
            times.append(0.0)

    def __enter__(self):
        from kubeshare_tpu_torch.parallel.spmd import RankLine

        self.shipped = {name: getattr(RankLine, name) for name in self.NAMES}
        torch = self.torch

        def timed(name, fn):
            def call(line, *args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(line, *args)
                torch.cuda.synchronize()
                if self.ms:
                    self.ms[-1] += (time.perf_counter() - t0) * 1e3
                    self.by[name][-1] += (time.perf_counter() - t0) * 1e3
                    self.received[-1] += self.received_bytes(name, line,
                                                             args)
                return out
            return call

        for name, fn in self.shipped.items():
            setattr(RankLine, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        from kubeshare_tpu_torch.parallel.spmd import RankLine

        for name, fn in self.shipped.items():
            setattr(RankLine, name, fn)
        return False


def rank_steps(torch, train_step, state, tokens, targets, steps) -> dict:
    """``steps`` eager steps of a step over a mesh of ranks, each rank
    collective timed (:class:`RankCollectives`): the rank's losses, step
    ms by CUDA events, host ms, collective ms and received bytes a step,
    and launches."""
    losses, step_ms, host_ms = [], [], []
    with RankCollectives(torch) as timed:
        reset_counts()
        for _ in range(steps):
            timed.step()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            start.record()
            state, loss = train_step(state, tokens, targets)
            end.record()
            end.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            step_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
        launches = read_counts()
    return dict(losses=losses, step_ms=step_ms, host_ms=host_ms,
                collective_ms=timed.ms, received=timed.received,
                launches=launches)


def sp_apply(config, mesh, kind):
    """(e)'s forward over ``mesh``: the zigzag hybrid ring or Ulysses."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply_ring, transformer_apply_ulysses)

    if kind == "zigzag":
        return lambda p, t: transformer_apply_ring(p, t, config, mesh,
                                                   layout="zigzag")
    ulysses = dataclasses.replace(config, attention="ulysses")
    return lambda p, t: transformer_apply_ulysses(p, t, ulysses, mesh)


def moe_dp_rules():
    """(f)'s placement: the transformer rules with the experts split over
    dp (``moe_sharding_rules("dp")``'s expert split) in place of tp."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_sharding_rules)
    from kubeshare_tpu_torch.ops.moe import moe_sharding_rules

    rules = transformer_sharding_rules()
    rules.update({f"moe']['{name}": spec for name, spec in
                  moe_sharding_rules("dp").items() if name != "router"})
    return rules


def sp_run(torch, out_dir: str, rank: int) -> dict:
    """Distributed (e) in a rank of (a)'s gang: DDP_SP_STEPS eager steps
    of the train-step flagship (DDP_SP_LAYERS layers) at 1 x LC_SEQ over
    the mesh of the ranks
    (dp=1 x tp=1 x sp=DDP_SP), the zigzag hybrid ring and then Ulysses,
    each from the seed's weights; rank 0 saves each run's final
    parameters, gathered, to DIR/params_sp_<kind>.pt."""
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import make_train_step, tree_leaves

    device = torch.device("cuda", 0)
    mesh = make_mesh(MeshSpec(dp=1, tp=1, sp=DDP_SP), device=device)
    config, params, tokens, targets = lc_setup(torch, device, 1, LC_SEQ,
                                               n_layers=DDP_SP_LAYERS)
    runs = {}
    for kind in ("zigzag", "ulysses"):
        init_state, train_step = make_train_step(
            sp_apply(config, mesh, kind), mesh=mesh, param_rules={})
        state = init_state(clone_tree(params))
        runs[kind] = dict(rank_steps(torch, train_step, state, tokens,
                                     targets, DDP_SP_STEPS),
                          mesh=dict(mesh.shape))
        final = [leaf.gather().cpu() for leaf in tree_leaves(state.params)]
        if rank == 0:
            torch.save(final, f"{out_dir}/params_sp_{kind}.pt")
        del state, final, train_step, init_state
        torch.cuda.empty_cache()
    return runs


def moe_rank_run(torch, out_dir: str, rank: int) -> dict:
    """Distributed (f) in a rank of (a)'s gang: DDP_SP_STEPS eager steps
    of the MoE model at TRAIN_BATCH x TRAIN_SEQ over dp=DDP_WORLD ranks,
    the experts split over dp, loss CE + MOE_AUX_COEF x aux; rank 0 saves
    the final parameters, gathered, to DIR/params_moe.pt."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply_with_aux)
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import (CrossEntropyWithAux,
                                                    make_train_step,
                                                    tree_leaves)

    device = torch.device("cuda", 0)
    mesh = make_mesh(MeshSpec(dp=DDP_WORLD), device=device)
    config, params, tokens, targets = train_setup(torch, device, MOE_DIMS)
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply_with_aux(p, t, config), mesh=mesh,
        param_rules=moe_dp_rules(),
        loss_fn=CrossEntropyWithAux(MOE_AUX_COEF))
    state = init_state(params)
    run = dict(rank_steps(torch, train_step, state, tokens, targets,
                          DDP_SP_STEPS), mesh=dict(mesh.shape))
    final = [leaf.gather().cpu() for leaf in tree_leaves(state.params)]
    if rank == 0:
        torch.save(final, f"{out_dir}/params_moe.pt")
    return run


def pp_pairs(params, grads, first_layer):
    """(parameter, gradient) for every gradient of a 1F1B step:
    ``grads["layers"][i]`` is layer ``first_layer + i``'s (over ranks a
    rank's gradients are its stage's layers and the whole embedding and
    head)."""
    from kubeshare_tpu_torch.parallel.train import tree_leaves

    pairs = []
    for key, grad in grads.items():
        if key == "layers":
            for i, layer in enumerate(grad):
                pairs += zip(tree_leaves(params["layers"][first_layer + i]),
                             tree_leaves(layer))
        else:
            pairs += zip(tree_leaves(params[key]), tree_leaves(grad))
    return pairs


def pp_digests(torch, params, grads, first_layer, stages):
    """sha256 of a 1F1B step's gradients (or, with ``grads`` None, the
    parameters they update): of the embedding's, the final norm's and
    the head's, and of each stage's layers, ``stages`` (first layer,
    count) pairs."""
    from kubeshare_tpu_torch.parallel.train import tree_leaves

    pairs = (pp_pairs(params, grads, first_layer) if grads is not None
             else [(p, p) for p in tree_leaves(params)])
    layers = {id(p) for layer in params["layers"] for p in tree_leaves(layer)}
    rest = [g for p, g in pairs if id(p) not in layers]
    by_stage = []
    for first, count in stages:
        held = {id(p) for layer in params["layers"][first:first + count]
                for p in tree_leaves(layer)}
        by_stage.append(params_digest(torch, [g for p, g in pairs
                                              if id(p) in held]))
    return dict(rest=params_digest(torch, rest), layers=by_stage)


def pp_train(torch, step, params, first_layer, stages, steps, timed=None):
    """``steps`` AdamW steps of a 1F1B ``step() -> (loss, grads)`` that
    reads ``params`` (updated in place; a layer the step returns no
    gradient for, another rank's stage, stays as it is): losses, step ms
    by CUDA events, host ms, launches, step 1's gradient digests and the
    final parameters' (``pp_digests``); with ``timed`` (a
    :class:`RankCollectives`) also each rank transfer's ms and the bytes
    received, a step."""
    import contextlib

    from kubeshare_tpu_torch.parallel.train import adamw, tree_leaves

    opt = adamw(1e-3)(tree_leaves(params))
    losses, step_ms, host_ms, first = [], [], [], None
    with timed if timed is not None else contextlib.nullcontext():
        reset_counts()
        for _ in range(steps):
            if timed is not None:
                timed.step()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            start.record()
            loss, grads = step()
            if first is None:  # step 1 (not in the steady median)
                first = pp_digests(torch, params, grads, first_layer, stages)
            for param, grad in pp_pairs(params, grads, first_layer):
                param.grad = grad
            del grads
            opt.step()
            opt.zero_grad(set_to_none=True)
            end.record()
            end.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            step_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
        launches = read_counts()
    run = dict(losses=losses, step_ms=step_ms, host_ms=host_ms,
               launches=launches, first=first,
               final=pp_digests(torch, params, None, 0, stages))
    if timed is not None:
        run.update(collective_ms=timed.ms, received=timed.received,
                   by=timed.by)
    return run


def pp_stale_hop():
    """Control: every forward hop after a stage's first carries the
    previous microbatch's activations."""
    from unittest import mock

    from kubeshare_tpu_torch.parallel import pipeline

    shipped = pipeline._RankStages.post
    previous = {}

    def stale(self, xs, stage, m, direction):
        if direction == pipeline.FORWARD:
            previous[m] = xs
            xs = previous.get(m - 1, xs)
        shipped(self, xs, stage, m, direction)

    return mock.patch.object(pipeline._RankStages, "post", stale)


def pp_rank_run(torch, rank: int) -> dict:
    """Distributed (g) in a rank of (a)'s gang: the train-step flagship
    under transformer_train_1f1b over pp=DDP_WORLD ranks (this rank's
    stage: its n_layers / pp layers), from the seed's weights: one step
    of the stale-hop control, then DDP_PP_STEPS eager AdamW steps with
    each rank transfer timed."""
    from kubeshare_tpu_torch.models.transformer import transformer_train_1f1b
    from kubeshare_tpu_torch.parallel.distributed import rank_mesh_over

    device = torch.device("cuda", 0)
    mesh = rank_mesh_over(("pp",), (DDP_WORLD,), device=device)
    config, params, tokens, targets = train_setup(torch, device)
    per = config.n_layers // DDP_WORLD
    stage = [(rank * per, per)]

    def step():
        return transformer_train_1f1b(params, tokens, targets, config, mesh,
                                      num_microbatches=DDP_PP_MICRO)

    with pp_stale_hop():
        loss, grads = step()
    control = dict(loss=float(loss), first=pp_digests(
        torch, params, grads, rank * per, stage))
    del grads
    run = pp_train(torch, step, params, rank * per, stage, DDP_PP_STEPS,
                   RankCollectives(torch))
    return dict(run, control=control, mesh=dict(mesh.shape))


def resnet_rank_setup(torch, device):
    """(h)'s model, weights and batch on ``device``: ResNetConfig(), the
    seed's weights, RESNET_BATCH random images (seed 0), the same on
    every rank (the rank mesh places each rank's rows)."""
    import numpy as np

    from kubeshare_tpu_torch.models.resnet import ResNetConfig, resnet_init

    config = ResNetConfig()
    rng = np.random.default_rng(0)
    images = rng.standard_normal((RESNET_BATCH, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, (RESNET_BATCH,), dtype=np.int64)
    return (config, resnet_init(torch.Generator().manual_seed(0), config,
                                device=device),
            torch.from_numpy(images).to(device),
            torch.from_numpy(labels).to(device))


def resnet_dp_steps(torch, mesh, params, config, images, labels,
                    ranked: bool) -> dict:
    """DDP_RESNET_STEPS eager steps of the ResNet over ``mesh``
    (``data_parallel_apply``) with deterministic convolutions: the run
    (``rank_steps``'s record over ranks; losses, step ms and launches on
    one process) and the digest of the final parameters (a replicated
    leaf's first shard is the whole of it)."""
    from kubeshare_tpu_torch.models.resnet import resnet_apply
    from kubeshare_tpu_torch.parallel.train import make_train_step, tree_leaves

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        init_state, train_step = make_train_step(
            lambda p, x: resnet_apply(p, x, config), mesh=mesh,
            param_rules={})
        state = init_state(params)
        if ranked:
            run = rank_steps(torch, train_step, state, images, labels,
                             DDP_RESNET_STEPS)
        else:
            reset_counts()
            state, losses, step_ms, _ = timed_steps(
                torch, train_step, state,
                [(images, labels)] * DDP_RESNET_STEPS)
            run = dict(losses=losses, step_ms=step_ms,
                       launches=read_counts())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return dict(run, mesh=dict(mesh.shape), digest=params_digest(
        torch, [leaf.shards[0] for leaf in tree_leaves(state.params)]))


def resnet_rank_run(torch) -> dict:
    """Distributed (h) in a rank of (a)'s gang: the ResNet over
    dp=DDP_WORLD ranks (``resnet_dp_steps``)."""
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    device = torch.device("cuda", 0)
    config, params, images, labels = resnet_rank_setup(torch, device)
    return resnet_dp_steps(torch, make_mesh(MeshSpec(dp=DDP_WORLD),
                                            device=device),
                           params, config, images, labels, True)


def tp_run(torch, out_dir: str, rank: int, world: int) -> dict:
    """Distributed (d) in a rank of (a)'s gang (``ddp_worker``): gloo's
    collectives probed on CUDA tensors, then DDP_STEPS eager steps of
    train_distributed_torch.py --tp DDP_TP, the mesh of the ranks, on the
    whole global batch, each collective of the rank mesh timed (the
    device synchronised around it).  Returns the rank's record; rank 0
    also saves the final parameters, gathered, to DIR/params_tp.pt."""
    import train_distributed_torch as T
    from kubeshare_tpu_torch.parallel.train import tree_leaves

    device = torch.device("cuda", 0)
    probe = gloo_cuda_probe(torch)
    args = T.parse_args(["--tp", str(DDP_TP)])
    tokens = T.rank_tokens(T.global_batch(T.model_config(args), args), args,
                           rank, world).to(device)
    _, init_state, train_step, params = T.setup(args, device, True)
    state = init_state(params)
    run = rank_steps(torch, train_step, state, tokens, tokens, DDP_STEPS)
    final = [leaf.gather().cpu() for leaf in tree_leaves(state.params)]
    if rank == 0:
        torch.save(final, f"{out_dir}/params_tp.pt")
    leaves = tree_leaves(state.params)
    return dict(run, bytes=unit_bytes(state),
                param_bytes=sum(leaf.shards[0].numel() * leaf.element_size()
                                for leaf in leaves),
                whole_bytes=sum(leaf.shape.numel() * leaf.element_size()
                                for leaf in leaves),
                mesh=dict(tree_leaves(state.params)[0].mesh.shape),
                probe=probe)


def ddp_tp(torch, device, T, single_losses, ranks):
    """(d): two gloo ranks of train_distributed_torch.py --tp DDP_TP, one
    mesh of the ranks (run in (a)'s processes: ``ranks`` is their records
    and rank 0's final parameters), against the one-process step over
    the same mesh naming the card twice (equal to the bit) and against
    one device (the one process's run of (a), at the sharded limits).
    Returns the ranks' launches (summed) and the one-process mesh's."""
    from kubeshare_tpu_torch.parallel.train import tree_leaves

    records, final = ranks
    args = T.parse_args(["--tp", str(DDP_TP)])
    config = T.model_config(args)
    tokens = T.global_batch(config, args).to(device)
    _, init_state, train_step, params = T.setup(args, device, False)
    state = init_state(params)
    reset_counts()
    state, losses, step_ms, _ = timed_steps(
        torch, train_step, state, [(tokens, tokens)] * DDP_STEPS)
    one_launches = read_counts()
    reference = [leaf.gather() for leaf in tree_leaves(state.params)]
    one_bytes = unit_bytes(state)
    del state
    torch.cuda.empty_cache()
    for name, found in records[0]["probe"].items():
        print(f"distributed (d) gloo {name} on cuda:0 bf16: {found}")
    per_step = only("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
    expect = {name: n * config.n_layers * DDP_STEPS
              for name, n in per_step.items()}
    # one controller runs both units' bodies
    check(one_launches == {name: DDP_TP * n for name, n in expect.items()},
          f"the one-process mesh launched {one_launches}, expected "
          f"{DDP_TP} x {expect}")
    print(f"distributed (d) one process, mesh {{'dp': 1, 'tp': {DDP_TP}, "
          f"'sp': 1}} over [cuda:0] * {DDP_TP}: losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; step ms {steady_median(step_ms):.3f} by CUDA events; unit "
          f"bytes (parameters + AdamW moments, mesh device 0) {one_bytes}")
    for rank, run in enumerate(records):
        share = [c / h for c, h in zip(run["collective_ms"], run["host_ms"])]
        print(f"distributed (d) rank {rank}/{DDP_WORLD} (gloo, cuda:0, mesh "
              f"{run['mesh']} over the ranks, attention {DDP_TP_SHAPE}): "
              f"launches {run['launches']}; parameter bytes "
              f"{run['param_bytes']} of the model's {run['whole_bytes']}, "
              f"with the AdamW moments {run['bytes']} (the one-process "
              f"mesh device 0's {one_bytes}); step ms "
              f"{steady_median(run['step_ms']):.3f} by CUDA events (median "
              f"of steps {TRAIN_TIMED_FROM}-{DDP_STEPS}; "
              + " ".join(f"{x:.1f}" for x in run["step_ms"])
              + f"), host {steady_median(run['host_ms']):.3f}; of it in the "
              f"rank collectives (host copy, gloo, copy back) "
              f"{steady_median(run['collective_ms']):.3f} ms, share "
              f"{steady_median(share):.3f}, {run['received'][-1]} bytes "
              f"received a step")
        check(run["launches"] == expect,
              f"rank {rank} launched {run['launches']}, expected {expect}")
        check(run["mesh"] == {"dp": 1, "tp": DDP_TP, "sp": 1},
              f"rank {rank} ran mesh {run['mesh']}")
        check(run["bytes"] == one_bytes,
              f"rank {rank} holds {run['bytes']} bytes, the one-process "
              f"unit {one_bytes}")
    same_losses = records[0]["losses"] == records[1]["losses"] == losses
    same_params = all(torch.equal(a, b) for a, b in zip(final, reference))
    print(f"distributed (d) ranks against the one-process mesh: losses "
          f"equal to the bit: {same_losses}; parameters after {DDP_STEPS} "
          f"steps equal to the bit: {same_params}")
    check(same_losses and same_params,
          "the ranks differ from the one-process mesh")
    first = abs(losses[0] - single_losses[0])
    err = max(abs(a - b) for a, b in zip(losses, single_losses))
    print(f"distributed (d) against one device ((a)'s one process): step 1 "
          f"loss abs err {first:.3e} (tol {SHARDED_FIRST_LOSS_ATOL:g}), max "
          f"over {DDP_STEPS} steps {err:.3e} (tol "
          f"{SHARDED_DRIFT_LOSS_ATOL:g})")
    check(first <= SHARDED_FIRST_LOSS_ATOL and err <= SHARDED_DRIFT_LOSS_ATOL,
          f"distributed (d): the losses differ from one device's by {first} "
          f"at step 1, {err} at most")
    return ({name: sum(r["launches"][name] for r in records)
             for name in expect}, one_launches)


def rank_lines(label, records, unit):
    """Each rank's line of a run over the mesh of the ranks: launches,
    step ms by CUDA events, the rank collectives' ms, share of the step
    and bytes received a step."""
    for rank, run in enumerate(records):
        share = [c / h for c, h in zip(run["collective_ms"], run["host_ms"])]
        print(f"distributed {label} rank {rank}/{DDP_WORLD} (gloo, cuda:0, "
              f"mesh {run['mesh']} over the ranks, {unit}): launches "
              f"{run['launches']}; losses " + " ".join(
                  f"{x:.4f}" for x in run["losses"])
              + f"; step ms {steady_median(run['step_ms']):.3f} by CUDA "
              f"events (median of steps {TRAIN_TIMED_FROM}-"
              f"{len(run['step_ms'])}; " + " ".join(
                  f"{x:.1f}" for x in run["step_ms"])
              + f"), host {steady_median(run['host_ms']):.3f}; of it in the "
              f"rank collectives (host copy, gloo, copy back) "
              f"{steady_median(run['collective_ms']):.3f} ms, share "
              f"{steady_median(share):.3f}, {run['received'][-1]} bytes "
              f"received a step")


def hold_ranks(torch, label, records, final, losses, reference):
    """The ranks' losses and final parameters equal to the one-process
    mesh's (``losses``, ``reference``) to the bit."""
    same_losses = all(r["losses"] == losses for r in records)
    same_params = all(torch.equal(a, b.to(a.device))
                      for a, b in zip(reference, final))
    print(f"distributed {label} ranks against the one-process mesh: losses "
          f"equal to the bit: {same_losses}; parameters after "
          f"{len(losses)} steps equal to the bit: {same_params}")
    check(same_losses and same_params,
          f"distributed {label}: the ranks differ from the one-process mesh")


def ddp_sp(torch, device, ranks):
    """(e): the zigzag hybrid ring and Ulysses over dp=1 x tp=1 x
    sp=DDP_SP gloo ranks (run in (a)'s processes: ``ranks`` is their
    records and rank 0's final parameters by kind) against the
    one-process mesh over [cuda:0] * DDP_SP (equal to the bit) and one
    device's DDP_SP_STEPS steps (the long-context limits).  Returns the
    ranks' launches (summed) and the one-process meshes'."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import tree_leaves

    records, finals = ranks
    config, params, tokens, targets = lc_setup(torch, device, 1, LC_SEQ,
                                               n_layers=DDP_SP_LAYERS)
    initial = [leaf.detach().clone() for leaf in tree_leaves(params)]
    flash = dataclasses.replace(config, attention="flash")
    state, losses, step_ms, _, _ = lc_train(
        torch, "distributed (e) single device", lambda p, t:
        transformer_apply(p, t, flash), None, params, tokens, targets,
        DDP_SP_STEPS)
    single = (losses, lc_leaves(state))
    single_ms = steady_median(step_ms)
    del state
    torch.cuda.empty_cache()
    mesh = make_mesh(MeshSpec(dp=1, tp=1, sp=DDP_SP),
                     devices=[device] * DDP_SP)
    n = DDP_SP_STEPS * config.n_layers
    # a zigzag rank's diagonal step runs the kernel on its two quadrants;
    # a Ulysses member attends the whole sequence once a layer
    expect = {"zigzag": {**only(), "flash_fwd": 2 * n},
              "ulysses": {name: c * n for name, c in only(
                  "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq").items()}}
    summed, one_launches = dict(only()), dict(only())
    for kind in ("zigzag", "ulysses"):
        state, losses, step_ms, _, launches = lc_train(
            torch, f"distributed (e) {kind} one process over [{device}] * "
            f"{DDP_SP}", sp_apply(config, mesh, kind), mesh, params, tokens,
            targets, DDP_SP_STEPS, rules={})
        check(launches == {k: DDP_SP * c for k, c in expect[kind].items()},
              f"distributed (e) {kind}: the one-process mesh launched "
              f"{launches}, expected {DDP_SP} x {expect[kind]}")
        reference = lc_leaves(state)
        del state
        runs = [r[kind] for r in records]
        rank_lines(f"(e) {kind}", runs, "1 x " + str(LC_SEQ) + " tokens, "
                   + (f"diagonal quadrants {LC_DIAG_SHAPE}" if kind == "zigzag"
                      else f"member {DDP_ULYSSES_SHAPE}"))
        for rank, run in enumerate(runs):
            check(run["launches"] == expect[kind],
                  f"distributed (e) {kind} rank {rank} launched "
                  f"{run['launches']}, expected {expect[kind]}")
            for name, c in run["launches"].items():
                summed[name] += c
        for name, c in launches.items():
            one_launches[name] += c
        final = [t.to(device) for t in finals[kind]]
        hold_ranks(torch, f"(e) {kind}", runs, final, losses, reference)
        hold_drift(f"distributed (e) {kind} ranks vs single device",
                   (runs[0]["losses"], final), single, initial,
                   (LC_DRIFT_LOSS_ATOL, LC_DRIFT_UPDATE_RTOL),
                   first_atol=LC_FIRST_LOSS_ATOL)
        print(f"distributed (e) {kind} step at 1 x {LC_SEQ} tokens, median "
              f"of steps {TRAIN_TIMED_FROM}-{DDP_SP_STEPS} (CUDA events): "
              f"ranks " + ", ".join(f"{steady_median(r['step_ms']):.3f}"
                                    for r in runs)
              + f" ms, one-process mesh {steady_median(step_ms):.3f} ms, "
              f"single device {single_ms:.3f} ms")
        del reference
        torch.cuda.empty_cache()
    return summed, one_launches


def ddp_moe(torch, device, ranks):
    """(f): the MoE model over dp=DDP_WORLD gloo ranks, the experts split
    over dp (run in (a)'s processes), against the one-process mesh over
    [cuda:0] * DDP_WORLD (equal to the bit) and one device's DDP_SP_STEPS
    steps (the sharded limits).  Returns the ranks' launches (summed) and
    the one-process mesh's."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply_with_aux)
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import (CrossEntropyWithAux,
                                                    make_train_step,
                                                    tree_leaves)

    records, final = ranks
    config, params, tokens, targets = train_setup(torch, device, MOE_DIMS)
    apply = lambda p, t: transformer_apply_with_aux(p, t, config)
    loss_fn = CrossEntropyWithAux(MOE_AUX_COEF)
    init_state, train_step = make_train_step(apply, loss_fn=loss_fn)
    state = init_state(clone_tree(params))
    state, single, _, _ = timed_steps(torch, train_step, state,
                                      [(tokens, targets)] * DDP_SP_STEPS)
    del state
    mesh = make_mesh(MeshSpec(dp=DDP_WORLD), devices=[device] * DDP_WORLD)
    init_state, train_step = make_train_step(
        apply, mesh=mesh, param_rules=moe_dp_rules(), loss_fn=loss_fn)
    state = init_state(params)
    reset_counts()
    state, losses, step_ms, _ = timed_steps(
        torch, train_step, state, [(tokens, targets)] * DDP_SP_STEPS)
    one_launches = read_counts()
    w_in = state.params["layers"][1]["moe"]["w_in"]
    reference = [leaf.gather() for leaf in tree_leaves(state.params)]
    del state
    torch.cuda.empty_cache()
    expect = {name: c * DDP_SP_STEPS * config.n_layers for name, c in only(
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq").items()}
    check(one_launches == {k: DDP_WORLD * c for k, c in expect.items()},
          f"distributed (f): the one-process mesh launched {one_launches}, "
          f"expected {DDP_WORLD} x {expect}")
    rank_lines("(f) moe", records, f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
               f"{config.moe_num_experts} experts split as {w_in.spec}")
    for rank, run in enumerate(records):
        check(run["launches"] == expect,
              f"distributed (f) rank {rank} launched {run['launches']}, "
              f"expected {expect}")
    print(f"distributed (f) moe one process over [{device}] * {DDP_WORLD}: "
          f"losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; step ms {steady_median(step_ms):.3f} by CUDA events")
    hold_ranks(torch, "(f) moe", records, final, losses, reference)
    first = abs(records[0]["losses"][0] - single[0])
    err = max(abs(a - b) for a, b in zip(records[0]["losses"], single))
    print(f"distributed (f) moe ranks against one device: step 1 loss abs "
          f"err {first:.3e} (tol {SHARDED_FIRST_LOSS_ATOL:g}), max over "
          f"{DDP_SP_STEPS} steps {err:.3e} (tol {SHARDED_DRIFT_LOSS_ATOL:g})")
    check(first <= SHARDED_FIRST_LOSS_ATOL and err <= SHARDED_DRIFT_LOSS_ATOL,
          f"distributed (f): the losses differ from one device's by {first} "
          f"at step 1, {err} at most")
    return ({name: sum(r["launches"][name] for r in records)
             for name in expect}, one_launches)


def ddp_pp(torch, device, records):
    """(g): the train-step flagship under transformer_train_1f1b over
    pp=DDP_WORLD gloo ranks (run in (a)'s processes: ``records`` is their
    records) against the one-process pipeline over [cuda:0] * DDP_WORLD
    (step 1's loss, each rank's stage's gradients and the embedding's and
    head's, the losses and the final parameters equal to the bit; the
    stale-hop control refused) and one device's DDP_PP_STEPS steps (the
    sharded first-loss limit, the train step's drift limits).  Returns
    the ranks' launches (summed) and the one-process pipeline's."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply, transformer_train_1f1b)
    from kubeshare_tpu_torch.parallel.train import make_train_step, tree_leaves

    config, params, tokens, targets = train_setup(torch, device)
    initial = [leaf.detach().clone() for leaf in tree_leaves(params)]
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config))
    state, losses, single_ms, _ = timed_steps(
        torch, train_step, init_state(clone_tree(params)),
        [(tokens, targets)] * DDP_PP_STEPS)
    single = (losses, [leaf.detach() for leaf in tree_leaves(state.params)])
    del state, init_state, train_step
    torch.cuda.empty_cache()
    per = config.n_layers // DDP_WORLD
    stages = [(s * per, per) for s in range(DDP_WORLD)]
    mesh = lc_mesh(device, ("pp",), pp=DDP_WORLD)
    one = pp_train(torch, lambda: transformer_train_1f1b(
        params, tokens, targets, config, mesh,
        num_microbatches=DDP_PP_MICRO), params, 0, stages, DDP_PP_STEPS)
    # each microbatch runs each of a stage's layers once, forward and back
    expect = {name: c * DDP_PP_MICRO * per * DDP_PP_STEPS for name, c in
              only("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq").items()}
    check(one["launches"] == {k: DDP_WORLD * c for k, c in expect.items()},
          f"distributed (g): the one-process pipeline launched "
          f"{one['launches']}, expected {DDP_WORLD} x {expect}")
    print(f"distributed (g) one process, the pipeline over [{device}] * "
          f"{DDP_WORLD} ({DDP_PP_MICRO} microbatches of 1 x {TRAIN_SEQ}): "
          f"losses " + " ".join(f"{x:.4f}" for x in one["losses"])
          + f"; step ms {steady_median(one['step_ms']):.3f} by CUDA events; "
          f"one device {steady_median(single_ms):.3f}")
    rank_lines("(g) pp", records, f"stage of {per} layers, {DDP_PP_MICRO} "
               f"microbatches at {DDP_MOE_RANK_SHAPE}")
    for rank, run in enumerate(records):
        hops = [sum(run["by"][name][i] for name in ("send", "recv", "wait"))
                for i in range(len(run["step_ms"]))]
        share = [h / t for h, t in zip(hops, run["host_ms"])]
        print(f"distributed (g) rank {rank}: the hops (point to point, "
              f"send + recv + wait) {steady_median(hops):.3f} ms a step, "
              f"share {steady_median(share):.3f}; the broadcasts of the "
              f"loss, the head's gradients and dx "
              f"{steady_median(run['by']['broadcast']):.3f} ms")
        check(run["launches"] == expect,
              f"distributed (g) rank {rank} launched {run['launches']}, "
              f"expected {expect}")
        check(run["mesh"] == {"pp": DDP_WORLD},
              f"distributed (g) rank {rank} ran mesh {run['mesh']}")
        first = (run["losses"][0] == one["losses"][0]
                 and run["first"]["rest"] == one["first"]["rest"]
                 and run["first"]["layers"] == [one["first"]["layers"][rank]])
        final = (run["losses"] == one["losses"]
                 and run["final"]["rest"] == one["final"]["rest"]
                 and run["final"]["layers"] == [one["final"]["layers"][rank]])
        stale = (run["control"]["loss"] == one["losses"][0]
                 and run["control"]["first"] == run["first"])
        print(f"distributed (g) rank {rank} against the one-process "
              f"pipeline: step 1's loss and gradients (its stage's layers, "
              f"the embedding, final norm and head) equal to the bit: "
              f"{first}; losses and parameters after {DDP_PP_STEPS} steps "
              f"equal to the bit: {final}; control, each hop carrying the "
              f"previous microbatch: loss {run['control']['loss']:.6f} "
              f"(shipped {one['losses'][0]:.6f}), equal to the bit: {stale}")
        check(first and final,
              f"distributed (g) rank {rank} differs from the one-process "
              f"pipeline")
        check(not stale, "distributed (g): the check does not refuse the "
                         "stale hop")
    hold_drift("distributed (g) the one-process pipeline vs one device",
               (one["losses"], [leaf.detach() for leaf in
                                tree_leaves(params)]), single, initial,
               (TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL),
               first_atol=SHARDED_FIRST_LOSS_ATOL)
    return ({name: sum(r["launches"][name] for r in records)
             for name in expect}, one["launches"])


def ddp_resnet(torch, device, records):
    """(h): the ResNet through data_parallel_apply over dp=DDP_WORLD gloo
    ranks (run in (a)'s processes) against the one-process dp=DDP_WORLD
    mesh over [cuda:0] * DDP_WORLD: losses and final parameters equal to
    the bit.  Returns the ranks' launches (summed) and the one-process
    mesh's (no flash kernel: a per-sample model)."""
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    config, params, images, labels = resnet_rank_setup(torch, device)
    one = resnet_dp_steps(torch, make_mesh(MeshSpec(dp=DDP_WORLD),
                                           devices=[device] * DDP_WORLD),
                          params, config, images, labels, False)
    check(one["launches"] == only(),
          f"distributed (h): the one-process mesh launched {one['launches']}")
    rank_lines("(h) resnet", records, f"{RESNET_BATCH // DDP_WORLD} of "
               f"{RESNET_BATCH} images, ResNetConfig()")
    same = all(r["losses"] == one["losses"] and r["digest"] == one["digest"]
               for r in records)
    print(f"distributed (h) resnet one process over [{device}] * "
          f"{DDP_WORLD}: losses " + " ".join(f"{x:.5f}" for x in
                                            one["losses"])
          + f"; step ms {steady_median(one['step_ms']):.3f} by CUDA events, "
          f"ranks " + ", ".join(f"{steady_median(r['step_ms']):.3f}"
                                for r in records)
          + f"; the ranks' losses and parameters after {DDP_RESNET_STEPS} "
          f"steps equal to the bit: {same}")
    for rank, run in enumerate(records):
        check(run["launches"] == only() and run["mesh"] == one["mesh"],
              f"distributed (h) rank {rank} ran {run['mesh']}, launched "
              f"{run['launches']}")
    check(same, "distributed (h): the ranks differ from the one-process mesh")
    check(all(math.isfinite(x) for x in one["losses"]),
          f"distributed (h): non-finite loss {one['losses']}")
    return only(), one["launches"]


def ddp_nccl(torch, device, T, args):
    """(b): one NCCL rank (world size 1), eager and captured with the
    all-reduce inside the graph, against the plain single-device step."""
    import torch.distributed as dist

    from kubeshare_tpu_torch.parallel.train import CapturedTrainStep

    tokens = T.rank_rows(T.global_batch(T.model_config(args), args), 0,
                         DDP_WORLD).to(device)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    launches = []
    try:
        def run(distributed, **options):
            _, init_state, train_step, params = T.setup(
                args, device, distributed, **options)
            state = init_state(params)
            initial = [p.detach().clone() for p in ddp_leaves(state)]
            reset_counts()
            losses = []
            for _ in range(DDP_NCCL_STEPS):
                state, loss = train_step(state, tokens, tokens)
                losses.append(float(loss))
            launches.append(read_counts())
            return (losses, ddp_leaves(state)), initial, train_step

        default, initial, _ = run(False)
        same, _, _ = run(False, optimizer=capturable_adamw(device))
        eager, _, _ = run(True)
        captured, _, step = run(True, capture=True)
    finally:
        dist.destroy_process_group()
    check(isinstance(step, CapturedTrainStep) and step.mean is not None
          and step.update_graph is None,
          "the NCCL step did not capture its all-reduce in one graph")
    bits = all(torch.equal(a, b) for a, b in zip(eager[1], default[1]))
    print(f"distributed (b) one NCCL rank, {DDP_NCCL_STEPS} steps: eager "
          f"losses " + " ".join(f"{x:.4f}" for x in eager[0])
          + f", equal to the plain step's to the bit: {bits}; captured (the "
          f"all-reduce inside the graph) " + " ".join(
              f"{x:.4f}" for x in captured[0]))
    hold_drift("distributed (b) NCCL eager vs the plain step", eager, default,
               initial, (CAPTURE_SAME_LOSS_ATOL, CAPTURE_SAME_UPDATE_RTOL))
    hold_captured("distributed (b) NCCL", captured, same, default, initial,
                  CAPTURE_DRIFT_LOSS_ATOL, CAPTURE_DRIFT_UPDATE_RTOL)
    return {name: sum(c[name] for c in launches) for name in launches[0]}


def ddp_multislice(torch, device):
    """(c): the dry run's multislice leg on the card, and the disagg
    router in virtual_multislice over [cuda:0, cuda:0] against the
    monolithic engine."""
    from kubeshare_tpu_torch import constants
    from kubeshare_tpu_torch.entry import (dryrun_multichip, entry,
                                           flagship_config)
    from kubeshare_tpu_torch.parallel.distributed import (
        multislice_spec_from_env)
    from kubeshare_tpu_torch.serving import DisaggTopology

    reset_counts()
    line = dryrun_multichip(8)
    launches = read_counts()
    check("multislice dcn mesh 2 slices x 4 devices" in line,
          f"the dry run ran no multislice leg: {line}")
    ms = multislice_spec_from_env({constants.ENV_MEGASCALE_NUM_SLICES: "2",
                                   constants.ENV_MEGASCALE_SLICE_ID: "0"})
    topology = DisaggTopology("virtual_multislice", ms,
                              devices=(device, device))
    check(topology.place() == (device, device),
          f"virtual_multislice placed {topology.place()}")
    config = flagship_config()
    _, (params, _) = entry()
    trace = disagg_trace(config)[:DDP_DISAGG_REQUESTS]
    oracle, _ = disagg_pass(torch, device, params, config, trace, False)
    streams, stats = disagg_pass(torch, device, params, config, trace, True,
                                 topology=topology)
    same = sum(streams[rid] == oracle[rid] for rid, _, _, _ in trace)
    print(f"distributed (c) disagg router, virtual_multislice over "
          f"[{device}, {device}]: {stats['tokens_per_s']:.1f} tokens/s, "
          f"migrations {stats['migrations']} packed / {stats['delivered']} "
          f"delivered, {stats['migrated_bytes']} bytes; streams equal to the "
          f"monolithic engine's: {same}/{len(trace)}")
    check(same == len(trace), "the multislice router's streams differ")
    check(stats["migrations"] == stats["delivered"] == len(trace),
          f"{stats['delivered']} of {len(trace)} chains delivered")
    for name, n in stats["launches"].items():
        launches[name] += n
    return launches


def distributed_phase(torch, device):
    """The DDP gang worker (train_distributed_torch.py's full-width
    config, BASELINE config 5) over torch.distributed: (a) two gloo ranks
    on the card, (b) one NCCL rank eager and captured, (c) the multislice
    dry run and router, (d) two gloo ranks at --tp 2, one mesh of the
    ranks; (e) sequence parallelism (the zigzag hybrid ring, Ulysses),
    (f) MoE, (g) the 1F1B pipeline and (h) the ResNet over a mesh of the
    same two ranks."""
    import train_distributed_torch as T

    args = T.parse_args([])
    config = T.model_config(args)
    shape = (args.batch, config.n_heads, args.seq, config.head_dim)
    if shape != DDP_SHAPE:
        raise AssertionError(f"distributed: attention shape {shape} is not "
                             f"the kernel phase's DDP_SHAPE {DDP_SHAPE}")
    launches = {}
    (launches["distributed"], launches["distributed_captured"],
     launches["distributed_single"], single_losses, ranks) = \
        ddp_two_ranks(torch, device, T, args)
    torch.cuda.empty_cache()
    launches["distributed_nccl"] = ddp_nccl(torch, device, T, args)
    torch.cuda.empty_cache()
    launches["distributed_multislice"] = ddp_multislice(torch, device)
    torch.cuda.empty_cache()
    launches["distributed_tp"], launches["distributed_tp_one_process"] = \
        ddp_tp(torch, device, T, single_losses, ranks["tp"])
    torch.cuda.empty_cache()
    launches["distributed_sp"], launches["distributed_sp_one_process"] = \
        ddp_sp(torch, device, ranks["sp"])
    torch.cuda.empty_cache()
    launches["distributed_moe"], launches["distributed_moe_one_process"] = \
        ddp_moe(torch, device, ranks["moe"])
    torch.cuda.empty_cache()
    launches["distributed_pp"], launches["distributed_pp_one_process"] = \
        ddp_pp(torch, device, ranks["pp"])
    torch.cuda.empty_cache()
    (launches["distributed_resnet"],
     launches["distributed_resnet_one_process"]) = ddp_resnet(
        torch, device, ranks["resnet"])
    torch.cuda.empty_cache()
    return launches


HOOK_KERNEL = re.compile(
    r"(flash_(?:fwd|bwd_dkv|bwd_dq))_(?:bf16|f32)_kernelILi\d+ELb([01])E")


def hook_kernel_counts(kernels):
    """The hook's launches by kernel name mapped onto read_counts()'s
    names: <D, false> instantiations are the dense kernels, <D, true> the
    block-sparse ones (the bf16 and f32 kernels share a counter, as the
    port's wrappers count them)."""
    counts = {name: 0 for name in read_counts()}
    for name, n in kernels.items():
        match = HOOK_KERNEL.search(name)
        if match:
            key = match.group(1) + ("_block_sparse" if match.group(2) == "1"
                                    else "")
            counts[key] += n
    return counts


def hook_stats():
    """The preloaded hook's counters, every charge at the broker first:
    its own exported C functions, read through ctypes (the interposer
    phase's children import nothing of kubeshare_tpu_torch.isolation)."""
    import ctypes

    process = ctypes.CDLL(None)
    settle, stats = process.cudahook_settle, process.cudahook_stats
    settle.argtypes, settle.restype = [ctypes.c_double], ctypes.c_int
    stats.argtypes, stats.restype = [ctypes.c_char_p, ctypes.c_long], ctypes.c_long
    check(settle(5000.0) == 0, "the hook's charges did not reach the broker")
    size = stats(None, 0)
    buf = ctypes.create_string_buffer(size + 1)
    stats(buf, size + 1)
    return json.loads(buf.value.decode())


def broker_stat():
    """This pod's line of the broker's STAT, asked through its pmgr."""
    import os
    import socket

    with socket.create_connection(
            ("127.0.0.1", int(os.environ["POD_MANAGER_PORT"])), timeout=30) as s:
        s.sendall(b"STAT\n")
        data = b""
        while not data.endswith(b"\n"):
            chunk = s.recv(1 << 16)
            check(bool(chunk), "the broker closed the STAT connection")
            data += chunk
    return json.loads(data)["pods"][os.environ["POD_NAME"]]


def greedy_rate(torch, train_step, state, batch):
    """A greedy captured loop (no input wait; the loss read every step):
    INTERPOSER_WARMUP_S, then steps/s over INTERPOSER_GREEDY_S."""
    deadline = time.perf_counter() + INTERPOSER_WARMUP_S
    while time.perf_counter() < deadline:
        state, loss = train_step(state, *batch)
        float(loss)
    start = time.perf_counter()
    steps = 0
    while time.perf_counter() - start < INTERPOSER_GREEDY_S:
        state, loss = train_step(state, *batch)
        float(loss)
        steps += 1
    return steps / (time.perf_counter() - start)


def interposer_train(torch, device, hooked):
    """The train-step flagship, eager then captured, TRAIN_STEPS each
    from one state and batch (the captured run's step 1 apart from
    steps 2-10, so that the charge covers replays alone), then the
    greedy captured loop.  Losses, parameter digests, CUDA-event and
    enqueue ms, the port's launch counters and, under the hook, its
    counts and the broker's grants and charged ms for each run."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply
    from kubeshare_tpu_torch.parallel.train import make_train_step, tree_leaves

    result = {}
    for mode, capture in (("eager", False), ("captured", True)):
        config, params, tokens, targets = train_setup(torch, device)
        init_state, train_step = make_train_step(
            lambda p, t: transformer_apply(p, t, config), capture=capture)
        state = init_state(params)
        batch = (tokens, targets)
        torch.cuda.synchronize()
        before = hook_stats() if hooked else None
        reset_counts()
        first = []
        if capture:  # step 1: warm-up, capture, replay
            state, first, _, _ = timed_steps(torch, train_step, state, [batch])
        if hooked:  # step 1's charges at the broker, its lease returned
            mid = hook_stats()
            stat0 = broker_stat()
        state, losses, step_ms, enqueue_ms = timed_steps(
            torch, train_step, state, [batch] * (TRAIN_STEPS - len(first)))
        if hooked:  # before the digest, whose copies are device work too
            after = hook_stats()
            stat1 = broker_stat()
        # medians of steps TRAIN_TIMED_FROM.. (step_ms starts at step
        # len(first) + 1)
        steady = slice(TRAIN_TIMED_FROM - 1 - len(first), None)
        run = {"losses": first + losses,
               "digest": params_digest(torch, tree_leaves(state.params)),
               "step_ms": step_ms, "enqueue_ms": enqueue_ms,
               "steady_ms": statistics.median(step_ms[steady]),
               "steady_enqueue_ms": statistics.median(enqueue_ms[steady]),
               "launches": read_counts()}
        if hooked:
            run["hook"] = {key: after[key] - before[key] for key in (
                "graph_launches", "eager_launches", "captured_launches",
                "acquires", "acquire_ms", "charged_ms")}
            run["hook"]["kernels"] = {
                name: n - hook_kernel_counts(before["kernels"])[name]
                for name, n in hook_kernel_counts(after["kernels"]).items()}
            run["broker"] = {
                "charged_ms": stat1["charged_total_ms"] - stat0["charged_total_ms"],
                "grants": stat1["grants"] - stat0["grants"],
                "hook_charged_ms": after["charged_ms"] - mid["charged_ms"]}
        result[mode] = run
        if capture:
            result["greedy_steps_per_s"] = greedy_rate(torch, train_step,
                                                       state, batch)
        del state, train_step, params
        torch.cuda.empty_cache()
    return result


def interposer_child(torch, role, out_path):
    """A child process of the interposer phase: the workloads,
    unmodified.  "plain" runs without the hook, "hooked" under it (pod
    hook/full): the train-step flagship (interposer_train) and the serving
    engine over engine_trace.  "limited" (pod hook/half, a memory cap of
    INTERPOSER_FRACTION) runs the memory checks, then the greedy loop."""
    import os

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"role": role}
    if role == "pod":
        result.update(placement_pod(torch, device))
    elif role == "limited":
        anchor = torch.zeros(1, device=device)  # a segment held throughout
        torch.cuda.synchronize()
        total = torch.cuda.get_device_properties(0).total_memory
        base = broker_stat()["mem_used"]
        held = torch.empty(1 << 30, dtype=torch.uint8, device=device)
        torch.cuda.synchronize()
        result["quiescent"] = {"mem_used": broker_stat()["mem_used"],
                               "reserved": torch.cuda.memory_reserved(device)}
        try:
            torch.empty(int(0.6 * total), dtype=torch.uint8, device=device)
            result["refused"] = None
        except torch.OutOfMemoryError as e:
            result["refused"] = str(e).splitlines()[0][:240]
        del held
        torch.cuda.empty_cache()
        check(float(anchor) == 0.0, "the anchor tensor changed")
        free, reported = torch.cuda.mem_get_info(device)
        result.update(base=base, after=broker_stat()["mem_used"],
                      total=total, mem_get_info=[free, reported],
                      cap=int(float(os.environ["TPUSHARE_MEM_FRACTION"])
                              * total))
        from kubeshare_tpu_torch.models.transformer import transformer_apply
        from kubeshare_tpu_torch.parallel.train import make_train_step

        config, params, tokens, targets = train_setup(torch, device)
        init_state, train_step = make_train_step(
            lambda p, t: transformer_apply(p, t, config), capture=True)
        result["greedy_steps_per_s"] = greedy_rate(
            torch, train_step, init_state(params), (tokens, targets))
    else:
        from kubeshare_tpu_torch.entry import entry, flagship_config

        result["train"] = interposer_train(torch, device, role == "hooked")
        config = flagship_config()
        _, (params, _) = entry()
        streams, stats = engine_pass(torch, device, params, config,
                                     engine_trace(config))
        result["engine"] = {"streams": streams,
                            "new_captures": stats["new_captures"],
                            "captures": stats["captures"],
                            "tokens_per_s": stats["tokens_per_s"]}
    result["isolation_imported"] = sorted(
        name for name in sys.modules
        if name.startswith("kubeshare_tpu_torch.isolation"))
    with open(out_path, "w") as f:
        json.dump(result, f)
    return 0


def run_interposer_child(role, out_dir, env):
    """``chip_smoke.py --interposer-child role`` in ``env``; its result."""
    import os

    out = os.path.join(out_dir, f"{role}.json")
    with open(os.path.join(out_dir, f"{role}.err"), "w") as err:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--interposer-child",
             role, out], env=env, stdout=err, stderr=subprocess.STDOUT,
            timeout=INTERPOSER_CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        with open(os.path.join(out_dir, f"{role}.err")) as f:
            tail = f.read()[-3000:]
        check(False, f"interposer child {role} exited {proc.returncode}: "
                     f"{tail}")
    with open(out) as f:
        return json.load(f)


def interposer_phase(torch, device, engine_streams):
    """10. interposer: libcudahook.so.1 LD_PRELOADed under the port's
    unmodified workloads (see the module docstring).  Returns the launch
    counters of the hooked child's train runs (the kernels line's
    interposer column) and the hook's own counts of the same launches."""
    import os
    import tempfile

    import corun_bench
    from kubeshare_tpu_torch.isolation import hook

    # (a) the in-tree prototypes against the toolkit's cuda.h
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    api_check = hook.build(
        "api_check", (hook.CSRC / "hook_test" / "api_check.cc",),
        (f"-I{cuda_home}/include",),
        headers=(hook.CSRC / "cuda_driver_api.h",), label="api_check")
    proc = subprocess.run([str(api_check)], capture_output=True, text=True,
                          timeout=60)
    print(f"interposer (a) {proc.stdout.strip()}")
    check(proc.returncode == 0, f"api_check failed: {proc.stdout}")

    library = hook.hook_path()
    tokend_binary = corun_bench.ensure_binary("tpushare-tokend")
    pmgr_binary = corun_bench.ensure_binary("tpushare-pmgr")
    total = torch.cuda.get_device_properties(device).total_memory
    out_dir = tempfile.mkdtemp(prefix="interposer-")
    procs, pmgrs = [], {}
    try:
        for pod, limit, cap, window in (
                ("hook/full", 1.0, total, None),
                ("hook/half", INTERPOSER_FRACTION,
                 int(INTERPOSER_FRACTION * total), INTERPOSER_HALF_WINDOW_MS)):
            config = pod.replace("/", "-")
            with open(os.path.join(out_dir, config), "w") as f:
                f.write(f"1\n{pod} {limit} {limit} {cap}\n")
            tokend_port = free_port()
            procs.append(subprocess.Popen(
                [tokend_binary, "-p", out_dir, "-f", config, "-P",
                 str(tokend_port)]
                + (["-w", str(window)] if window else []),
                stderr=subprocess.DEVNULL))
            wait_listening(tokend_port)
            pmgrs[pod] = free_port()
            procs.append(subprocess.Popen(
                [pmgr_binary], stderr=subprocess.DEVNULL,
                env=dict(os.environ, SCHEDULER_IP="127.0.0.1",
                         SCHEDULER_PORT=str(tokend_port),
                         POD_MANAGER_IP="127.0.0.1",
                         POD_MANAGER_PORT=str(pmgrs[pod]), POD_NAME=pod)))
            wait_listening(pmgrs[pod])
        bare = {k: v for k, v in os.environ.items()
                if k not in ("LD_PRELOAD", "POD_MANAGER_PORT", "POD_NAME")
                and not k.startswith(("TPUSHARE_", "CUDAHOOK_"))}
        stats_path = os.path.join(out_dir, "hooked_stats.json")
        plain = run_interposer_child("plain", out_dir, bare)
        hooked = run_interposer_child("hooked", out_dir, {
            **bare, **hook.hook_env(pmgrs["hook/full"], "hook/full",
                                    stats_path=stats_path,
                                    library=library)})
        limited = run_interposer_child("limited", out_dir, {
            **bare, **hook.hook_env(pmgrs["hook/half"], "hook/half",
                                    mem_fraction=INTERPOSER_FRACTION,
                                    library=library)})
    finally:
        for p in procs:
            p.kill()
            p.wait()
    card = card_line()
    for child in (plain, hooked, limited):
        check(not child["isolation_imported"],
              f"the {child['role']} child imported "
              f"{child['isolation_imported']}")

    # (b) gating changes no arithmetic; the hook sees every launch
    for mode in ("eager", "captured"):
        a, b = plain["train"][mode], hooked["train"][mode]
        seen = b["hook"]["kernels"]
        print(f"interposer (b) {mode}: losses equal to the bit "
              f"{a['losses'] == b['losses']} ({' '.join(f'{x:.4f}' for x in b['losses'])}), "
              f"parameters equal to the bit {a['digest'] == b['digest']}; "
              f"hook: {b['hook']['graph_launches']} graph launches, "
              f"{b['hook']['eager_launches']} eager ({b['hook']['captured_launches']} "
              f"in a capture), {b['hook']['acquires']} grants "
              f"({b['hook']['acquire_ms']:.3f} ms acquiring); flash launches "
              f"by name {seen}, the port's counters {b['launches']}; {card}")
        check(a["losses"] == b["losses"] and a["digest"] == b["digest"],
              f"the {mode} run under the hook differs from the run without")
        check(seen == b["launches"] == a["launches"],
              f"the hook counted {seen}, the port {b['launches']} (without "
              f"the hook {a['launches']}): a launch bypassed the hook")
    captured = hooked["train"]["captured"]
    check(captured["hook"]["graph_launches"] == TRAIN_STEPS,
          f"{captured['hook']['graph_launches']} graph launches for "
          f"{TRAIN_STEPS} captured steps")

    # (c) the charge is the device's time, not the dispatch's
    event_ms = sum(captured["step_ms"])
    charge = captured["broker"]["charged_ms"] / event_ms
    control = sum(captured["enqueue_ms"]) / event_ms
    lo, hi = INTERPOSER_CHARGE_RANGE
    print(f"interposer (c) charge: the broker charged "
          f"{captured['broker']['charged_ms']:.3f} ms ({captured['broker']['grants']} "
          f"grants; the hook released {captured['broker']['hook_charged_ms']:.3f}"
          f") for {len(captured['step_ms'])} captured steps of "
          f"{event_ms:.3f} ms by CUDA events = {charge:.4f} (limits {lo}-{hi}); "
          f"the host's dispatch {sum(captured['enqueue_ms']):.3f} ms = "
          f"{control:.4f} (the control, refused); {card}")
    check(lo <= charge <= hi, f"the charge is {charge} of the device time")
    check(not lo <= control <= hi, "the charge limits admit the dispatch time")

    # (d) the share: a greedy loop at limit 0.5
    ungated = plain["train"]["greedy_steps_per_s"]
    share = limited["greedy_steps_per_s"] / ungated
    lo, hi = INTERPOSER_SHARE_RANGE
    print(f"interposer (d) share: greedy captured loop {ungated:.2f} steps/s "
          f"ungated, {hooked['train']['greedy_steps_per_s']:.2f} under the hook "
          f"at limit 1.0, {limited['greedy_steps_per_s']:.2f} at limit "
          f"{INTERPOSER_FRACTION} = {share:.4f} of ungated (limits {lo}-{hi}; "
          f"the control, the ungated loop at 1.0, refused); {card}")
    check(lo <= share <= hi, f"the limited pod ran at {share} of ungated")
    check(not lo <= 1.0 <= hi, "the share limits admit the ungated loop")

    # (e) memory, in a pod that never imports the guard
    free, reported = limited["mem_get_info"]
    quiescent = limited["quiescent"]
    print(f"interposer (e) memory: mem_used {quiescent['mem_used']} B at a "
          f"quiescent point against memory_reserved {quiescent['reserved']} B "
          f"(difference {quiescent['mem_used'] - quiescent['reserved']} B); "
          f"0.6 of the card refused: {limited['refused']}; after del and "
          f"empty_cache mem_used {limited['after']} B, before {limited['base']} B; "
          f"mem_get_info total {reported} B, free {free} B, the cap "
          f"{limited['cap']} B; {card}")
    check(limited["refused"] is not None,
          "0.6 of the card was allocated under a 0.5 cap")
    check(quiescent["mem_used"] >= quiescent["reserved"],
          "memory PyTorch holds is not charged to the pod")
    check(limited["after"] == limited["base"],
          "mem_used did not return to its value before the allocation")
    # the hook's cap is the fraction of cuMemGetInfo's total, the child's
    # of cudaDeviceProp.totalGlobalMem: the same memory, read two ways
    check(abs(reported - limited["cap"]) <= 2 << 20,
          "mem_get_info does not report the cap")

    # (f) capture safety: the engine's warm-up captures under the hook
    engine = hooked["engine"]
    print(f"interposer (f) engine: {engine['captures']} captures in warm-up, "
          f"{engine['new_captures']} after; streams equal to the run without "
          f"the hook {engine['streams'] == plain['engine']['streams']}, to "
          f"the engine phase's {engine['streams'] == engine_streams}; "
          f"{engine['tokens_per_s']:.1f} tokens/s (without "
          f"{plain['engine']['tokens_per_s']:.1f}); {card}")
    check(engine["streams"] == plain["engine"]["streams"],
          "the engine's streams under the hook differ")
    check(engine["new_captures"] == 0, "the engine captured after warm-up")

    # (h) overhead
    for mode in ("eager", "captured"):
        a, b = plain["train"][mode], hooked["train"][mode]
        print(f"interposer (h) {mode} step, median of steps "
              f"{TRAIN_TIMED_FROM}-{TRAIN_STEPS}: {b['steady_ms']:.3f} ms "
              f"under the hook, {a['steady_ms']:.3f} without (CUDA events), "
              f"{b['steady_ms'] / a['steady_ms']:.4f}; host enqueue "
              f"{b['steady_enqueue_ms']:.3f} / {a['steady_enqueue_ms']:.3f} "
              f"ms; {card}")

    stats = hook.read_stats(stats_path)
    for library_name, paths in sorted(stats["resolution"].items()):
        print(f"interposer resolution {library_name}: {json.dumps(paths)}")

    # (g) the co-run with the preload gate
    t0 = time.perf_counter()
    result = corun_bench.run_suite(corun_bench.ensure_tokend(),
                                   seconds=CORUN_SECONDS, gate="preload")
    detail = result["detail"]
    tokens = detail["tokens"]
    print(f"interposer (g) corun with the preload gate: ratio "
          f"{result['value']:.4f} ({CORUN_SECONDS:g} s windows, "
          f"{time.perf_counter() - t0:.1f} s): solo steps/s "
          f"{detail['solo_a_steps_per_s']:.2f} + {detail['solo_b_steps_per_s']:.2f}, "
          f"co-run " + " + ".join(f"{r:.2f}" for r in detail["corun_steps_per_s"])
          + f"; tokens {json.dumps(tokens)}; adversarial "
          f"{json.dumps(detail['adversarial'])}; {card}")
    granted = [tokens["solo_a"], tokens["solo_b"], *tokens["corun"],
               *tokens["adversarial"]]
    check(all(n > 0 for n in granted), f"a pod was granted no token: {tokens}")
    runs = hooked["train"]
    return ({name: runs["eager"]["launches"][name]
             + runs["captured"]["launches"][name] for name in read_counts()},
            {name: runs["eager"]["hook"]["kernels"][name]
             + runs["captured"]["hook"]["kernels"][name]
             for name in read_counts()})


def placement_pod(torch, device):
    """A pod of the placement phase, in its own process under the env the
    scheduler injected: the device it sees, the memory cap, then
    PLACEMENT_SECONDS of captured MNIST steps, the hook's counters and
    its line of the broker's STAT."""
    import math
    import os

    from kubeshare_tpu_torch.models.mnist import mnist_apply, mnist_init
    from kubeshare_tpu_torch.parallel.train import make_train_step

    props = torch.cuda.get_device_properties(device)
    total = props.total_memory
    free, reported = torch.cuda.mem_get_info(device)
    result = {"device_count": torch.cuda.device_count(),
              "uuid": f"GPU-{props.uuid}", "total": total,
              "mem_get_info": [free, reported],
              "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
    held = torch.empty(int(PLACEMENT_FITS * total), dtype=torch.uint8,
                       device=device)
    torch.cuda.synchronize()
    result["fits"] = held.numel()
    del held
    torch.cuda.empty_cache()
    try:
        torch.empty(int(PLACEMENT_REFUSED * total), dtype=torch.uint8,
                    device=device)
        result["refused"] = None
    except torch.OutOfMemoryError as e:
        result["refused"] = str(e).splitlines()[0][:240]
    torch.cuda.empty_cache()

    init_state, train_step = make_train_step(mnist_apply, capture=True)
    state = init_state(mnist_init(torch.Generator().manual_seed(0),
                                  device=device))
    gen = torch.Generator().manual_seed(3)
    images = torch.rand((MNIST_BATCH, 28, 28, 1), generator=gen).to(device)
    labels = torch.randint(0, 10, (MNIST_BATCH,), generator=gen).to(device)
    losses = []
    deadline = time.perf_counter() + PLACEMENT_SECONDS
    while time.perf_counter() < deadline:
        state, loss = train_step(state, images, labels)
        losses.append(float(loss))
    check(all(math.isfinite(x) for x in losses), f"MNIST losses {losses}")
    result["steps"] = len(losses)
    result["losses"] = [losses[0], losses[-1]]
    stats = hook_stats()
    result["hook"] = {key: stats[key] for key in (
        "gated", "acquires", "leases", "graph_launches", "captured_launches",
        "graph_launches_in_lease", "charged_ms", "mem_fraction", "denials")}
    result["broker"] = broker_stat()
    return result


def placement_aggregator(cluster, chip, pods, ports, gpu_mem, out_dir,
                         placed):
    """The reference's wiring on the placement phase's cluster: the
    port's Aggregator served on a free port, its gpu_requirement samples
    for the two running pods, and a ConfigDaemon in aggregator mode whose
    files must equal the cluster mode's (``placed``) byte for byte."""
    from kubeshare_tpu_torch import constants
    from kubeshare_tpu_torch.aggregator import Aggregator
    from kubeshare_tpu_torch.configd import ConfigDaemon
    from kubeshare_tpu_torch.utils.promtext import parse_text
    import urllib.request

    server = Aggregator(cluster).serve(port=free_port())
    try:
        url = f"http://127.0.0.1:{server.port}/kubeshare-aggregator"
        with urllib.request.urlopen(url, timeout=10) as response:
            text = response.read().decode()
        daemon = ConfigDaemon(PLACEMENT_NODE, aggregator_url=url,
                              config_dir=f"{out_dir}/agg-config",
                              port_dir=f"{out_dir}/agg-ports")
        daemon.sync()
    finally:
        server.stop()
    samples = {s.labels["pod"]: s.labels for s in parse_text(text)
               if s.name == constants.METRIC_REQUIREMENT}
    print(f"placement aggregator: {len(text)} B of exposition text, "
          f"gpu_requirement {json.dumps(samples, sort_keys=True)}")
    check(sorted(samples) == ["pod-a", "pod-b"],
          f"aggregator samples for {sorted(samples)}")
    for name, labels in samples.items():
        want = {"namespace": "default", "node": PLACEMENT_NODE,
                "uuid": chip.uuid,
                "limit": pods[name].labels[constants.POD_GPU_LIMIT],
                "request": "0.5", "memory": str(gpu_mem),
                "port": str(ports[name]), "group_name": f"default/{name}",
                "cell_id": pods[name].annotations[constants.POD_CELL_ID]}
        got = {k: labels.get(k) for k in want}
        check(got == want, f"aggregator sample for {name}: {got}, "
                           f"wanted {want}")
    scraped = {}
    for kind in ("config", "ports"):
        with open(f"{out_dir}/agg-{kind}/{chip.uuid}") as f:
            scraped[kind] = f.read()
    print(f"placement aggregator-mode files: {json.dumps(scraped)}; equal "
          f"to the cluster mode's: {scraped == placed}")
    check(scraped == placed, f"aggregator-mode files {scraped} differ "
                             f"from the cluster mode's {placed}")


def placement_phase(torch, device):
    """The port's control plane on the card: pod labels -> the port's
    scheduler -> the port's configd files -> ChipSupervisor -> pod
    processes under libcudahook.so.1 (see the module docstring)."""
    import os
    import socket
    import tempfile

    import corun_bench
    from kubeshare_tpu_torch import constants
    from kubeshare_tpu_torch.cell import TopologyConfig, discover_local_chips
    from kubeshare_tpu_torch.cell.spec import check_physical_cells
    from kubeshare_tpu_torch.cluster.api import (Container, FakeClock, Node,
                                                 Pod, PodPhase)
    from kubeshare_tpu_torch.cluster.fake import FakeCluster
    from kubeshare_tpu_torch.configd import ConfigDaemon
    from kubeshare_tpu_torch.isolation import TokenClient, hook
    from kubeshare_tpu_torch.runtime import ChipSupervisor
    from kubeshare_tpu_torch.scheduler import (KubeShareScheduler,
                                               SchedulerArgs, SchedulerEngine)

    started = time.perf_counter()
    card = card_line()
    [chip] = discover_local_chips()
    topology = TopologyConfig.from_dict({
        "cellTypes": {"1-GPU-NODE": {
            "childCellType": chip.model, "childCellNumber": 1,
            "childCellPriority": 100, "isNodeLevel": True}},
        "cells": [{"cellType": "1-GPU-NODE", "cellId": PLACEMENT_NODE}]})
    check_physical_cells(topology)
    cluster = FakeCluster()
    cluster.add_node(Node(PLACEMENT_NODE,
                          {constants.NODE_LABEL_FILTER: "true"}))
    clock = FakeClock(0.0)
    plugin = KubeShareScheduler(
        topology, cluster, lambda node: [chip] if node == PLACEMENT_NODE else [],
        args=SchedulerArgs(bind_mode="shadow"), clock=clock)
    engine = SchedulerEngine(plugin, cluster, clock)
    gpu_mem = int(PLACEMENT_MEM_FRACTION * chip.memory)
    submitted = {}  # name -> uid of the pod as submitted

    def submit(name, labels, container="main"):
        submitted[name] = cluster.create_pod(Pod(
            name=name, scheduler_name=constants.SCHEDULER_NAME,
            labels=labels, containers=[Container(name=container)])).uid

    def shadow_bound(name):
        """The bound pod is the shadow bind's copy: a new pod, new uid."""
        pod = cluster.get_pod("default", name)
        print(f"placement {name}: shadow bind, uid {submitted[name]} -> "
              f"{pod.uid}")
        check(pod.uid != submitted[name],
              f"{name} kept its uid {pod.uid}: not bound in shadow mode")
        return pod

    for name, limit in (("pod-a", "1.0"), ("pod-b", "0.5")):
        submit(name, {constants.POD_GPU_REQUEST: "0.5",
                      constants.POD_GPU_LIMIT: limit,
                      constants.POD_GPU_MEMORY: str(gpu_mem)})
    results = {r.pod_key: r.result for r in engine.run_until_idle()}
    check(results == {"default/pod-a": "bound", "default/pod-b": "bound"},
          f"placement cycles {results}")
    manifest_key = f"default/{MNIST_MANIFEST_POD}"
    submit(MNIST_MANIFEST_POD, dict(MNIST_MANIFEST_LABELS),
           MNIST_MANIFEST_CONTAINER)
    refused = engine.run_until_idle()
    check(refused and all(r.result == "unschedulable" for r in refused),
          f"pod C ({MNIST_MANIFEST}) on a full card: {refused}")
    pods = {name: shadow_bound(name) for name in ("pod-a", "pod-b")}
    ports = {}
    for name, pod in pods.items():
        annotations = pod.annotations
        ports[name] = int(annotations[constants.POD_MANAGER_PORT])
        print(f"placement {name}: node {pod.node_name}, annotations "
              f"{json.dumps(annotations, sort_keys=True)}")
        check(pod.node_name == PLACEMENT_NODE
              and annotations[constants.POD_GPU_UUID] == chip.uuid,
              f"{name} bound to {annotations}")
        check(constants.POD_MANAGER_PORT_START < ports[name]
              < constants.POD_MANAGER_PORT_START + constants.POD_MANAGER_PORT_POOL,
              f"{name}'s manager port {ports[name]} is outside the pool")
        env = pod.containers[0].env
        shown = {k: (v if k in (constants.ENV_VISIBLE_DEVICES,
                                constants.ENV_MEM_BYTES,
                                constants.ENV_MEM_FRACTION) else "...")
                 for k, v in sorted(env.items())}
        print(f"placement {name} env: {json.dumps(shown)}")
        check(env[constants.ENV_VISIBLE_DEVICES] == chip.uuid
              and env[constants.ENV_SHIM_PRELOAD] == constants.SHIM_LIBRARY
              and env[constants.ENV_POD_NAME] == pod.key,
              f"{name}'s env {env}")
        cluster.set_pod_phase("default", name, PodPhase.RUNNING)
    check(ports["pod-a"] != ports["pod-b"], f"one manager port: {ports}")

    corun_bench.ensure_tokend()
    corun_bench.ensure_binary("tpushare-pmgr")
    library = str(hook.hook_path())
    out_dir = tempfile.mkdtemp(prefix="placement-")
    config_dir, port_dir = f"{out_dir}/config", f"{out_dir}/ports"
    daemon = ConfigDaemon(PLACEMENT_NODE, cluster=cluster,
                          config_dir=config_dir, port_dir=port_dir)
    daemon.sync()

    def files():
        out = {}
        for directory in (config_dir, port_dir):
            with open(os.path.join(directory, chip.uuid)) as f:
                out[os.path.basename(directory)] = f.read()
        return out

    placed = files()
    print(f"placement files: {json.dumps(placed)}")
    check(placed["config"] == f"2\ndefault/pod-a 1.0 0.5 {gpu_mem}\n"
          f"default/pod-b 0.5 0.5 {gpu_mem}\n", f"config file {placed}")
    check(placed["ports"] == f"2\ndefault/pod-a {ports['pod-a']}\n"
          f"default/pod-b {ports['pod-b']}\n", f"port file {placed}")
    placement_aggregator(cluster, chip, pods, ports, gpu_mem, out_dir, placed)
    def require_free(port):
        """The scheduler's port is the pod manager's: no other is picked."""
        with socket.socket() as s:
            try:
                s.bind(("0.0.0.0", port))
            except OSError as e:
                check(False, f"port {port} of the pod manager pool is taken "
                             f"on this host ({e}): the scheduler's pod "
                             f"cannot get its manager there")

    for port in ports.values():
        require_free(port)

    tokend_port = free_port()
    with ChipSupervisor(chip.uuid, config_dir=config_dir, port_dir=port_dir,
                        tokend_port=tokend_port, poll_interval=0.1,
                        base_quota_ms=50.0, min_quota_ms=5.0,
                        window_ms=1000.0) as supervisor:
        wait_listening(tokend_port)
        for port in ports.values():
            wait_listening(port)
        bare = {k: v for k, v in os.environ.items()
                if k not in ("LD_PRELOAD", "POD_MANAGER_PORT", "POD_NAME",
                             "POD_MANAGER_IP", "CUDA_VISIBLE_DEVICES")
                and not k.startswith(("TPUSHARE_", "CUDAHOOK_", "NVIDIA_"))}
        children = {}
        for name, pod in pods.items():
            env = dict(pod.containers[0].env)
            check(env[constants.ENV_SHIM_PRELOAD] == constants.SHIM_LIBRARY,
                  f"{name} preloads {env[constants.ENV_SHIM_PRELOAD]}")
            # the node's hostPath mount and the container runtime's mapping
            env[constants.ENV_SHIM_PRELOAD] = library
            env["CUDA_VISIBLE_DEVICES"] = env.pop(constants.ENV_VISIBLE_DEVICES)
            out = os.path.join(out_dir, f"{name}.json")
            err = open(os.path.join(out_dir, f"{name}.err"), "w")
            children[name] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--interposer-child", "pod", out],
                env={**bare, **env}, stdout=err, stderr=subprocess.STDOUT),
                out, err)
        deadline = time.monotonic() + PLACEMENT_CHILD_TIMEOUT_S
        runs = {}
        try:
            for name, (proc, out, err) in children.items():
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for proc, _, err in children.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                err.close()
        for name, (proc, out, _) in children.items():
            with open(os.path.join(out_dir, f"{name}.err")) as f:
                log = f.read()
            check(proc.returncode == 0,
                  f"pod {name} exited {proc.returncode}: {log[-3000:]}")
            check("running ungated" not in log,
                  f"pod {name} ran ungated: {log[-3000:]}")
            with open(out) as f:
                runs[name] = json.load(f)
        probe = TokenClient("127.0.0.1", tokend_port, "probe")
        stat = json.loads(probe.stat())
        probe.close()
        print(f"placement tokend stat: {json.dumps(stat, sort_keys=True)}")
        for name, run in runs.items():
            pod = pods[name]
            free, reported = run["mem_get_info"]
            cap_error = abs(reported - gpu_mem) / run["total"]
            entry = stat["pods"].get(pod.key, {})
            print(f"placement {name} pod: {run['device_count']} device, uuid "
                  f"{run['uuid']} (visible {run['visible']}); mem_get_info "
                  f"total {reported} B against gpu_mem {gpu_mem} B "
                  f"({cap_error:.2e} of the card), free {free} B; "
                  f"{PLACEMENT_FITS} of the card ({run['fits']} B) allocated, "
                  f"{PLACEMENT_REFUSED} refused: {run['refused']}; "
                  f"{run['steps']} captured MNIST steps, loss "
                  f"{run['losses'][0]:.4f} -> {run['losses'][1]:.4f}; hook "
                  f"{json.dumps(run['hook'])}; its broker line "
                  f"{json.dumps(run['broker'])}; tokend for {pod.key}: grants "
                  f"{entry.get('grants')}, charged {entry.get('charged_total_ms')}"
                  f" ms; {card}")
            check(run["device_count"] == 1 and run["uuid"] == chip.uuid,
                  f"{name} sees {run['device_count']} device(s), {run['uuid']}")
            check(cap_error <= PLACEMENT_CAP_TOLERANCE,
                  f"{name}'s mem_get_info total {reported} is not its "
                  f"gpu_mem {gpu_mem}")
            check(run["refused"] is not None,
                  f"{name} allocated {PLACEMENT_REFUSED} of the card")
            check(run["hook"]["gated"] and run["hook"]["graph_launches"] > 0,
                  f"{name}'s hook {run['hook']}")
            check(entry.get("grants", 0) >= 1
                  and entry.get("charged_total_ms", 0) > 0,
                  f"tokend charged {pod.key} nothing: {stat}")

        # reclaim: B goes; its cell and port come back and C binds there
        cluster.delete_pod("default", "pod-b")
        daemon.sync()
        reclaimed = files()
        print(f"placement files after deleting pod-b: {json.dumps(reclaimed)}")
        check(reclaimed["config"] == f"1\ndefault/pod-a 1.0 0.5 {gpu_mem}\n"
              and reclaimed["ports"] == f"1\ndefault/pod-a {ports['pod-a']}\n",
              f"files after the reclaim {reclaimed}")
        check(not plugin.port_bitmaps[PLACEMENT_NODE].is_masked(
            ports["pod-b"] - constants.POD_MANAGER_PORT_START),
              "pod-b's port was not reclaimed")
        wanted = {f"default/pod-a {ports['pod-a']}"}
        until = time.monotonic() + 10
        while set(supervisor.pod_managers) != wanted and time.monotonic() < until:
            time.sleep(0.1)
        check(set(supervisor.pod_managers) == wanted,
              f"pod managers after the reclaim {sorted(supervisor.pod_managers)}")
        bound = engine.run_until_idle()
        check([(r.pod_key, r.result) for r in bound]
              == [(manifest_key, "bound")], f"pod C after the reclaim {bound}")
        pod_c = shadow_bound(MNIST_MANIFEST_POD)
        c_port = int(pod_c.annotations[constants.POD_MANAGER_PORT])
        require_free(c_port)
        cluster.set_pod_phase("default", MNIST_MANIFEST_POD, PodPhase.RUNNING)
        daemon.sync()
        wanted.add(f"{manifest_key} {c_port}")
        until = time.monotonic() + 10
        while set(supervisor.pod_managers) != wanted and time.monotonic() < until:
            time.sleep(0.1)
        check(set(supervisor.pod_managers) == wanted,
              f"pod managers after C bound {sorted(supervisor.pod_managers)}")
        wait_listening(c_port)
        print(f"placement reclaim: pod-b's cell and port "
              f"{ports['pod-b']} reclaimed, its manager reaped; "
              f"{MNIST_MANIFEST_POD} bound "
              f"to {pod_c.annotations[constants.POD_GPU_UUID]} at port "
              f"{c_port}, its manager running; files {json.dumps(files())}")
        placement_manifest_pod(pod_c, bare, library, out_dir, tokend_port,
                               card)
    print(f"placement: {time.perf_counter() - started:.1f} s wall; {card}")


def placement_manifest_pod(pod, bare, library, out_dir, tokend_port, card):
    """Pod C of the placement phase, the pod of MNIST_MANIFEST: its
    container command at --steps MNIST_MANIFEST_STEPS under the env the
    scheduler injected (with the node's two substitutions), from the root
    of the checkout as the image's working directory; it must run gated
    by the hook and be charged by tokend under its key."""
    import os

    from kubeshare_tpu_torch import constants
    from kubeshare_tpu_torch.isolation import TokenClient, hook

    check(pod.labels == MNIST_MANIFEST_LABELS
          and [c.name for c in pod.containers] == [MNIST_MANIFEST_CONTAINER],
          f"{pod.key} is not {MNIST_MANIFEST}'s pod: {pod.labels}, "
          f"{[c.name for c in pod.containers]}")
    env = dict(pod.containers[0].env)
    check(env[constants.ENV_SHIM_PRELOAD] == constants.SHIM_LIBRARY
          and env[constants.ENV_POD_NAME] == pod.key,
          f"{pod.key}'s env {env}")
    env[constants.ENV_SHIM_PRELOAD] = library
    env["CUDA_VISIBLE_DEVICES"] = env.pop(constants.ENV_VISIBLE_DEVICES)
    stats_path = os.path.join(out_dir, f"{pod.name}-hook.json")
    env[hook.ENV_STATS] = stats_path
    command = [sys.executable, *MNIST_MANIFEST_COMMAND[1:],
               "--steps", str(MNIST_MANIFEST_STEPS)]
    began = time.perf_counter()
    proc = subprocess.run(command, env={**bare, **env},
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True,
                          timeout=PLACEMENT_CHILD_TIMEOUT_S)
    wall_s = time.perf_counter() - began
    log = proc.stdout + proc.stderr
    check(proc.returncode == 0,
          f"{pod.key} ({' '.join(command)}) exited {proc.returncode}: "
          f"{log[-3000:]}")
    check("running ungated" not in log, f"{pod.key} ran ungated: {log[-3000:]}")
    done = re.search(r"done: (\d+) steps, final loss (\S+)", proc.stdout)
    check(done is not None and int(done.group(1)) == MNIST_MANIFEST_STEPS
          and math.isfinite(float(done.group(2))),
          f"{pod.key}'s output: {proc.stdout[-2000:]}")
    stats = hook.read_stats(stats_path)
    probe = TokenClient("127.0.0.1", tokend_port, "probe")
    entry = json.loads(probe.stat())["pods"].get(pod.key, {})
    probe.close()
    shown = {key: stats.get(key) for key in (
        "gated", "acquires", "graph_launches", "captured_launches",
        "charged_ms", "mem_fraction", "denials")}
    print(f"placement {pod.name} ({MNIST_MANIFEST}): labels "
          f"{json.dumps(pod.labels, sort_keys=True)}; "
          f"{' '.join(MNIST_MANIFEST_COMMAND)} --steps "
          f"{MNIST_MANIFEST_STEPS}: {done.group(1)} steps, final loss "
          f"{done.group(2)}, {wall_s:.1f} s wall (process start included); "
          f"hook {json.dumps(shown)}; tokend for {pod.key}: grants "
          f"{entry.get('grants')}, charged {entry.get('charged_total_ms')} "
          f"ms; {card}")
    check(stats.get("gated") and stats.get("graph_launches", 0) > 0,
          f"{pod.key}'s hook {stats}")
    check(entry.get("grants", 0) >= 1 and entry.get("charged_total_ms", 0) > 0,
          f"tokend charged {pod.key} nothing: {entry}")


def nvidia_smi_locality(uuid):
    """nvidia-smi's view of the card ``uuid``: its bus id (None where it
    prints N/A), the NUMA affinity ``topo -m`` prints for it (None where
    topo -m fails or prints none) and its active NVLinks (``nvlink -s``:
    each "Link <n>: <rate>" line, "<inactive>" ones not)."""
    from kubeshare_tpu_torch.cell import nvml

    def smi(*args):
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=60)

    rows = smi("--query-gpu=index,uuid,pci.bus_id", "--format=csv,noheader")
    bus_id = gpu = None
    for row in rows.stdout.strip().splitlines():
        row_index, row_uuid, row_bus = (x.strip() for x in row.split(","))
        if row_uuid == uuid:
            gpu = row_index  # nvidia-smi's index, its topo -m row
            try:
                bus_id = nvml.nvml_bus_id(row_bus)
            except ValueError:  # "[N/A]"
                bus_id = None
    numa = None
    topo = smi("topo", "-m")
    lines = [re.sub(r"\x1b\[[0-9;]*m", "", line)
             for line in topo.stdout.splitlines()]
    index = [i for i, line in enumerate(lines) if "NUMA Affinity" in line]
    if topo.returncode == 0 and index:
        header = [c.strip() for c in lines[index[0]].split("\t")]
        column = header.index("NUMA Affinity")
        for line in lines[index[0] + 1:]:
            cells = [c.strip() for c in line.split("\t")]
            if cells and cells[0] == f"GPU{gpu}" and len(cells) > column:
                numa = int(cells[column]) if cells[column].isdigit() else None
    links, current = 0, False
    for line in smi("nvlink", "-s").stdout.splitlines():
        if line.startswith("GPU "):
            current = uuid in line
        elif current and re.match(r"\s*Link \d+: ", line) \
                and "inactive" not in line.lower():
            links += 1
    return {"bus_id": bus_id, "topo_rc": topo.returncode,
            "topo_numa": numa, "active_links": links}


def discovery_locality(torch, chip):
    """The card's link record against NVML (loaded with no fallback) and
    the witnesses that do not share the record's rules: nvidia-smi's bus
    id, sysfs's and ``topo -m``'s NUMA node and ``nvlink -s``'s active
    links.  A comparison that no witness answers on this host is printed
    as skipped.  Then nvml_test/api_check.cc against the toolkit's
    nvml.h."""
    import os

    from kubeshare_tpu_torch.cell import nvml
    from kubeshare_tpu_torch.cell.topology import link_distance, link_tier
    from kubeshare_tpu_torch.isolation import hook

    # NVML must load: a missing or failing library raises here
    devices = {d.uuid: d for d in nvml.read_devices()}
    check(chip.uuid in devices, f"NVML lists {sorted(devices)}, not "
                                f"{chip.uuid}")
    device = devices[chip.uuid]
    record = chip.links
    smi = nvidia_smi_locality(chip.uuid)
    props = torch.cuda.get_device_properties(chip.index)
    runtime_bus = "%08X:%02X:%02X.0" % (props.pci_domain_id, props.pci_bus_id,
                                        props.pci_device_id)
    sysfs_numa = None
    for bus_id in {b for b in (smi["bus_id"], runtime_bus) if b}:
        path = f"/sys/bus/pci/devices/{nvml.sysfs_bus_id(bus_id)}/numa_node"
        if os.path.exists(path):
            with open(path) as f:
                sysfs_numa = int(f.read())
    kinds = sorted({l.remote_type for l in device.links})
    print(f"discovery link record: {record}; NVML bus id {device.bus_id} "
          f"(nvidia-smi {smi['bus_id']}, CUDA runtime {runtime_bus}), NUMA "
          f"node: sysfs {sysfs_numa}, topo -m "
          f"{smi['topo_numa'] if smi['topo_rc'] == 0 else 'failed'}; "
          f"{len(device.links)} enabled NVLinks (nvidia-smi nvlink -s: "
          f"{smi['active_links']} active), far ends of type {kinds} at "
          f"{sorted({l.remote_bus_id for l in device.links})}")
    check(record is not None, "the chip carries no link record")
    skipped = []
    # NVML and nvidia-smi agree on the bus id, or both hide it
    check(device.bus_id == smi["bus_id"],
          f"NVML bus id {device.bus_id} != nvidia-smi's {smi['bus_id']}")
    if smi["bus_id"] is not None:
        check(record.bus_id == smi["bus_id"],
              f"record bus id {record.bus_id} != nvidia-smi's "
              f"{smi['bus_id']}")
    else:
        skipped.append("bus id (nvidia-smi prints none)")
    if sysfs_numa is not None:
        check(record.numa_node == max(sysfs_numa, -1),
              f"record NUMA node {record.numa_node} != sysfs's {sysfs_numa}")
    if smi["topo_numa"] is not None:
        check(record.numa_node == smi["topo_numa"],
              f"record NUMA node {record.numa_node} != topo -m's "
              f"{smi['topo_numa']}")
    if sysfs_numa is None and smi["topo_numa"] is None:
        skipped.append("NUMA node (no sysfs numa_node, no topo -m affinity)")
    check(len(device.links) == smi["active_links"],
          f"{len(device.links)} enabled NVLinks, nvidia-smi "
          f"{smi['active_links']}")
    check(link_distance(record, record) == 0
          and link_tier(record, record) == "X", "link_distance(chip, chip)")
    print(f"discovery locality checks skipped: "
          f"{'; '.join(skipped) if skipped else 'none'}")

    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    api_check = hook.build(
        "nvml_api_check", (hook.CSRC / "nvml_test" / "api_check.cc",),
        (f"-I{cuda_home}/include",), headers=(hook.CSRC / "nvml_api.h",),
        label="nvml_api_check")
    proc = subprocess.run([str(api_check)], capture_output=True, text=True,
                          timeout=60)
    print(f"discovery {proc.stdout.strip()}")
    check(proc.returncode == 0, f"nvml api_check failed: {proc.stdout}")


def discovery_phase(torch, device):
    """Device discovery and the node daemons on the card:
    discover_local_chips against nvidia-smi, the card's link record
    against NVML, nvidia-smi and sysfs, the collector served and scraped
    (the record round-tripping through its topo label), and a
    ChipSupervisor over the tree's tokend and pod manager gating one
    MNIST step."""
    import os
    import tempfile
    import urllib.request

    import corun_bench
    from kubeshare_tpu_torch.cell import discover_local_chips
    from kubeshare_tpu_torch.collector import (Collector, CudaEnumerator,
                                               PromInventory)
    from kubeshare_tpu_torch.isolation import ExecutionGuard, TokenClient
    from kubeshare_tpu_torch.models.mnist import mnist_apply, mnist_init
    from kubeshare_tpu_torch.parallel.train import make_train_step
    from kubeshare_tpu_torch.runtime import ChipSupervisor, find_binary
    from kubeshare_tpu_torch.utils.promtext import parse_text

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,memory.total",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    chips = discover_local_chips()
    check(len(chips) == len(smi) == torch.cuda.device_count() == 1,
          f"discovered {chips}, nvidia-smi {smi}")
    chip = chips[0]
    uuid, name, mib = (x.strip() for x in smi[0].split(","))
    memory_mib = chip.memory / 2**20
    print(f"discovery: {chip}; nvidia-smi uuid {uuid}, name {name}, memory "
          f"{mib} MiB (torch total_memory {memory_mib:.1f} MiB, "
          f"{float(mib) - memory_mib:.1f} MiB less)")
    check(chip.uuid == uuid, f"uuid {chip.uuid} != nvidia-smi's {uuid}")
    check(chip.model == name.replace(" ", "-"),
          f"model {chip.model} != nvidia-smi's {name}")
    check(abs(float(mib) - memory_mib) <= DISCOVERY_MEMORY_MIB,
          f"memory {memory_mib} MiB != nvidia-smi's {mib} MiB")
    discovery_locality(torch, chip)

    server = Collector(CudaEnumerator()).serve(port=0)
    url = f"http://127.0.0.1:{server.port}/kubeshare-collector"
    try:
        text = urllib.request.urlopen(url, timeout=10).read().decode()
        samples = [s for s in parse_text(text) if s.name == "gpu_capacity"]
        node = samples[0].labels.get("node") if samples else None
        inventory = PromInventory([url], ttl=0)(node)
    finally:
        server.stop()
    print(f"discovery collector: {len(samples)} gpu_capacity sample(s), "
          f"labels {samples[0].labels if samples else None}; PromInventory "
          f"read back {[(c.uuid, c.links) for c in inventory]}")
    check(len(samples) == 1 and {k: samples[0].labels.get(k) for k in
                                 ("uuid", "model", "memory", "index", "topo")}
          == {"uuid": chip.uuid, "model": chip.model,
              "memory": str(chip.memory), "index": "0",
              "topo": chip.links.label()},
          f"the collector exported {samples}")
    check(inventory == [chip] and inventory[0].links == chip.links,
          f"PromInventory read {inventory}")

    corun_bench.ensure_tokend()
    if find_binary("tpushare-pmgr") is None:
        subprocess.run(["make", "-C", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "native"), "build/tpushare-pmgr"],
            check=True, capture_output=True, timeout=300)
    check(find_binary("tpushare-pmgr") is not None,
          "cannot build tpushare-pmgr")
    pod = "default/ddp-mnist"
    with tempfile.TemporaryDirectory() as tmp:
        config_dir, port_dir = f"{tmp}/config", f"{tmp}/ports"
        os.makedirs(config_dir)
        os.makedirs(port_dir)
        with open(f"{config_dir}/{chip.uuid}", "w") as f:
            f.write(f"1\n{pod} 1.0 0.5 0\n")
        pmgr_port, tokend_port = free_port(), free_port()
        with open(f"{port_dir}/{chip.uuid}.tmp", "w") as f:
            f.write(f"1\n{pod} {pmgr_port}\n")
        os.rename(f"{port_dir}/{chip.uuid}.tmp", f"{port_dir}/{chip.uuid}")
        with ChipSupervisor(chip.uuid, config_dir=config_dir,
                            port_dir=port_dir, tokend_port=tokend_port,
                            poll_interval=0.1, base_quota_ms=50.0,
                            min_quota_ms=5.0, window_ms=1000.0) as sup:
            wait_listening(tokend_port)
            wait_listening(pmgr_port)
            guard = ExecutionGuard(client=TokenClient(
                "127.0.0.1", pmgr_port, "stamped-by-pmgr"), from_env=False)
            init_state, train_step = make_train_step(mnist_apply)
            state = init_state(mnist_init(torch.Generator().manual_seed(0),
                                          device=device))
            gen = torch.Generator().manual_seed(3)
            images = torch.rand((MNIST_BATCH, 28, 28, 1),
                                generator=gen).to(device)
            labels = torch.randint(0, 10, (MNIST_BATCH,),
                                   generator=gen).to(device)

            @guard
            def step(state):
                return train_step(state, images, labels)[0]

            state = step(state)
            guard.finish()
            probe = TokenClient("127.0.0.1", tokend_port, "probe")
            stat = json.loads(probe.stat())
            probe.close()
            managers = len(sup.pod_managers)
    entry = stat["pods"].get(pod, {})
    print(f"discovery supervisor: tokend on {tokend_port}, {managers} pod "
          f"manager(s); one MNIST step (batch {MNIST_BATCH}) gated: tokens "
          f"{guard.tokens_acquired}, guard charged "
          f"{guard.total_gated_ms:.3f} ms; tokend for {pod}: grants "
          f"{entry.get('grants')}, charged {entry.get('charged_total_ms')} ms")
    check(managers == 1, f"{managers} pod managers for one pod")
    check(guard.tokens_acquired >= 1 and entry.get("grants", 0) >= 1,
          "the MNIST step was not granted a token")
    check(entry.get("charged_total_ms", 0) > 0,
          f"tokend charged {pod} nothing: {stat}")


def main() -> int:
    import torch

    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ddp-worker"]:
        return ddp_worker(torch, sys.argv[2])
    if sys.argv[1:2] == ["--interposer-child"]:
        return interposer_child(torch, sys.argv[2], sys.argv[3])
    from kubeshare_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for source, log in sorted(build_logs.items()):
        for kernel, registers, spill in kernel_resources(log):
            print(f"build {source}.cu {kernel}: {registers} registers, "
                  f"{spill} bytes spilled")
            check(not kernel.startswith(F32_SASS_KERNELS) or spill == 0,
                  f"{kernel} spills {spill} bytes")
        for line in log.splitlines():
            if "Potential Performance Loss" in line:
                print(f"build {source}.cu ptxas: {line.split('info    : ')[-1]}")
    # the bf16 kernels run on wgmma and TMA, the f32 kernels on mma.sync
    # and cp.async: their SASS must hold them
    sass = {}
    for source in ("flash_fwd", "flash_bwd"):
        counts = sass_counts(library_sass(_build.library_path(source)))
        for kernel, ops in sorted(counts.items()):
            print(f"build {source}.cu {kernel} SASS: "
                  + ", ".join(f"{op} {n}" for op, n in ops.items()))
            if kernel.startswith(F32_SASS_KERNELS):
                check(ops["HMMA"] > 0 and ops["LDGSTS"] > 0,
                      f"{kernel} issues no mma.sync or cp.async")
            else:
                check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0
                      and ops["UTMASTG"] > 0,
                      f"{kernel} issues no wgmma or TMA")
        sass.update(counts)
    check(len(sass) == 4 * (len(SASS_KERNELS) + len(F32_SASS_KERNELS)),
          f"bf16 and f32 instantiations in the SASS: {sorted(sass)}")

    if "--profile-train" in sys.argv[1:]:
        result = {mode: profile_train(torch, device, capture)
                  for mode, capture in (("eager", False), ("captured", True))}
        result["sharded_captured"] = profile_train(torch, device, True,
                                                   sharded=True)
        print(card)
        print(json.dumps({"profile_train": result}))
        return 0
    if "--profile-engine" in sys.argv[1:]:
        from kubeshare_tpu_torch.entry import entry, flagship_config

        _, (params, _) = entry()
        result = {"flagship": profile_engine(torch, device, "flagship",
                                             flagship_config(), params)}
        del params
        config, params, _, _ = train_setup(torch, device, MOE_DIMS)
        result["moe"] = profile_engine(torch, device, "moe", config, params)
        print(card)
        print(json.dumps({"profile_engine": result}))
        return 0

    hbm_cap_phase()
    worst, timings = kernel_phase(torch, device)
    bs_worst, bs_timing, bs_launches = block_sparse_phase(torch, device)
    worst.update(bs_worst)
    launches = slice_phase(torch, device)
    launches["decode_capture"] = decode_capture_phase(torch, device)
    t0 = time.perf_counter()
    f32_launches, _ = f32_phase(torch, device)
    launches.update(f32_launches)
    torch.cuda.empty_cache()
    print(f"f32 phase: {time.perf_counter() - t0:.1f} s")
    launches["engine"], engine_streams, engine_stats, loop_pass = \
        engine_phase(torch, device)
    launches["speculative"] = speculative_phase(torch, device)
    launches["engine_spec"] = engine_spec_phase(torch, device,
                                                engine_streams)
    t0 = time.perf_counter()
    launches["engine_tier"] = engine_tier_phase(torch, device, loop_pass)
    print(f"engine tier phase: {time.perf_counter() - t0:.1f} s")
    del loop_pass
    t0 = time.perf_counter()
    launches["engine_disagg"] = engine_disagg_phase(torch, device)
    print(f"engine disagg phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["engine_fleet"] = engine_fleet_phase(torch, device)
    print(f"engine fleet phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["engine_sharded"] = engine_sharded_phase(
        torch, device, engine_streams, engine_stats)
    print(f"engine sharded phase: {time.perf_counter() - t0:.1f} s")
    del engine_stats
    launches["train"], eager = train_phase(torch, device)
    launches["train_captured"], captured = capture_phase(torch, device, eager)
    launches["block_sparse"] = bs_launches
    del eager
    torch.cuda.empty_cache()
    moe_launches, moe_captured = moe_phase(torch, device)
    launches.update(moe_launches)
    torch.cuda.empty_cache()
    launches.update(train_sharded_phase(torch, device, captured,
                                        moe_captured))
    torch.cuda.empty_cache()
    lc_launches, diag_err, diag_timing = long_context_phase(torch, device)
    launches.update(lc_launches)
    worst["flash_fwd"][1] = max(worst["flash_fwd"][1], diag_err)
    torch.cuda.empty_cache()
    mnist_phase(torch, device)
    t0 = time.perf_counter()
    resnet_phase(torch, device)
    torch.cuda.empty_cache()
    print(f"resnet phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches.update(distributed_phase(torch, device))
    print(f"distributed phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    discovery_phase(torch, device)
    print(f"discovery phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    placement_phase(torch, device)
    print(f"placement phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    corun_phase()
    print(f"corun phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    corun_serve_phase()
    print(f"corun serve phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["interposer"], hook_counts = interposer_phase(
        torch, device, engine_streams)
    print(f"interposer phase: {time.perf_counter() - t0:.1f} s")

    fwd_src = "kubeshare_tpu_torch/csrc/flash_fwd.cu"
    bwd_src = "kubeshare_tpu_torch/csrc/flash_bwd.cu"
    jax_src = "kubeshare_tpu/ops/attention.py"
    # name: (source, TPU kernel, mode, timings); the headline numbers are
    # at the shape of the path that runs the kernel most: serving's for the
    # dense forward, training's for the dense backward, the document mask
    # at the training shape for the masked kernels
    sources = {
        "flash_fwd": (fwd_src, f"{jax_src}:107", "dense", timings),
        "flash_bwd_dkv": (bwd_src, f"{jax_src}:278", "dense", timings),
        "flash_bwd_dq": (bwd_src, f"{jax_src}:330", "dense", timings),
        "flash_fwd_block_sparse": (fwd_src, f"{jax_src}:107", "has_mask",
                                   [bs_timing]),
        "flash_bwd_dkv_block_sparse": (bwd_src, f"{jax_src}:278", "has_mask",
                                       [bs_timing]),
        "flash_bwd_dq_block_sparse": (bwd_src, f"{jax_src}:330", "has_mask",
                                      [bs_timing]),
    }
    kernels = []
    for name, (source, replaces, mode, kernel_timings) in sources.items():
        main_timing = kernel_timings[1 if name in ("flash_bwd_dkv",
                                                   "flash_bwd_dq") else 0][name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "mode": mode,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": worst[name][1],
            "max_rel_err": worst[name][0],
            "ms": main_timing["ms"],
            "plain_ms": main_timing["plain_ms"],
            "bound_ms": main_timing["bound_ms"],
            "bound_by": main_timing["bound_by"],
            "library_ms": main_timing["library_ms"],
            "timed_shape": main_timing["shape"],
            "timings": [t[name] for t in kernel_timings]
            + ([diag_timing] if name == "flash_fwd" else []),
            # the same launches of the interposer column, as the hook
            # counted them by kernel name
            "interposer_hook_launches": hook_counts[name],
        })
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
