"""Continuous-batching serving engine over a block-paged KV cache, port
of the single-device core of kubeshare_tpu/serving:

- :mod:`kv_blocks` — the fixed-size-block KV pool (updated in place)
  and its refcounted free-list allocator with tenant quotas;
- :mod:`paged` — the paged twins of the dense cached model steps:
  chunked prefill into a slot's blocks, the batched decode step, the
  decode span, the device-resident decode loop, the mixed step, and the
  speculative verify span, mixed verify step and device loop;
- :mod:`drafter` — the n-gram (prompt-lookup) drafter, on the host and
  vectorised for the device loop;
- :mod:`engine` — the continuous-batching engine: admission into freed
  slots mid-flight, bucketed chunked prefill, decode spans and loops,
  stall-free mixed batching, self-drafted speculative decoding with its
  device loop and admission ring, every dispatch shape a CUDA graph captured
  at warm-up, and every dispatch chargeable through the
  :class:`~kubeshare_tpu_torch.isolation.ExecutionGuard`;
- :mod:`prefix_index` — the radix-tree prefix cache over the pool;
- :mod:`qos` — tenants, classes and the token-weighted fair queue;
- :mod:`metrics_view` — readers over the engine's metric families;
- :mod:`kv_tier` — the KV wire format and the host and disk tiers below
  the prefix cache (the engine demotes evicted prefix blocks into them
  and promotes matches back through one captured upload);
- :mod:`autotune` — the online autotuner over the engine's capture-free
  knobs, with a sandboxed pluggable policy;
- :mod:`chaos` — the seeded fault plan and its virtual clock, consulted
  through the engine's, the tiers', the router's and the fabric's
  ``fault_clock`` seams;
- :mod:`fabric` — the cluster KV fabric: a versioned, crc-framed
  message envelope over loopback or socket transports, at-least-once
  :class:`FabricEndpoint` delivery (ack, dedup, TTL, bounded-backoff
  redelivery), the :class:`FabricDirectory` of prefix owners and the
  exportable prefix store served across a process boundary;
- :mod:`disagg` — disaggregated prefill/decode serving: a
  :class:`PrefillPool` and a :class:`DecodePool` on one card, a
  :class:`KVMigrator` moving each prompt's KV chain between them as wire
  frames (read on a side stream as the prompt prefills), and a
  :class:`DisaggRouter` in front whose streams equal the monolithic
  engine's;
- :mod:`fleet` — the replica fleet: N engines (or disagg pairs) behind a
  prefix-affinity :class:`ReplicaFleet` router, with drain-then-retire
  cache inheritance over a shared host tier, an autoscaler with
  hysteresis, and crash recovery (salvage + orphan re-admission) under a
  health monitor; :mod:`sharded`'s :func:`carve_replica_groups` splits a
  dp x tp mesh spec into the replicas' device groups;
- :mod:`sharded` — tensor-parallel serving: a
  :class:`ShardedServingContext` splits the params Megatron-style with no
  partial sums and head-shards the pool over a device group, and the
  engine runs every dispatch through its twins (streams bit-exact with
  the single-device engine where products do not depend on their
  output's width); :func:`plan_sharding` is the policy, with the
  replicated-KV fallback and the Ulysses route for long chunks.
"""

from .autotune import (AnalyticPolicy, AutoTuner, CostModel, FittedTracePolicy,
                       Knob, KnobSpec, KnobView, TuningPolicy)
from .chaos import FaultClock, FaultPlan, ReplicaKilled
from .disagg import (DecodePool, DisaggRouter, DisaggTopology, KVMigrator,
                     PrefillPool)
from .drafter import NGramDrafter, ngram_propose_rows
from .engine import (EngineConfig, Request, RequestResult, ServingEngine,
                     plan_prefill_chunks)
from .fabric import (FabricDirectory, FabricEndpoint, FabricTransport,
                     LoopbackTransport, PrefixStoreClient, SocketTransport,
                     export_prefix_store, fabric_metric_families,
                     load_prefix_store, pack_message, pack_ticket,
                     prefix_fabric_key, recv_frame, send_frame,
                     serve_prefix_store, unpack_message, unpack_ticket)
from .fleet import (DRAIN_BUCKETS, RECOVERY_BUCKETS, PrefixAffinityPolicy,
                    ReplicaFleet, ReplicaHandle, RoundRobinPolicy,
                    RoutingPolicy, ScalingPolicy, TTFTBreachPolicy)
from .kv_blocks import (BlockAllocator, BlockExhausted, PagedKVPool,
                        QuotaExceeded, chain_token_runs, init_paged_pool)
from .kv_tier import (KV_CHAIN_VERSION, KV_WIRE_VERSION, DiskTier, HostTier,
                      LRUTierPolicy, QoSTierPolicy, TierPolicy, WireCorruption,
                      adopt_into, pack_block, pack_chain, unpack_block,
                      unpack_chain, wire_block_bytes)
from .paged import (paged_copy_block, paged_decode_loop, paged_decode_span,
                    paged_decode_step, paged_gather_kv, paged_mixed_step,
                    paged_mixed_verify_step, paged_prefill_step,
                    paged_spec_loop, paged_upload_block, paged_verify_span)
from .prefix_index import PrefixIndex
from .qos import (DEFAULT_TENANT, QOS_GUARANTEE, QOS_OPPORTUNISTIC, FairQueue,
                  TenantRegistry, TenantSpec)
from .sharded import (ShardDecision, ShardedServingContext,
                      carve_replica_groups, plan_sharding,
                      serving_sharding_rules)

__all__ = [
    "AnalyticPolicy",
    "AutoTuner",
    "BlockAllocator",
    "BlockExhausted",
    "CostModel",
    "DEFAULT_TENANT",
    "DRAIN_BUCKETS",
    "DecodePool",
    "DisaggRouter",
    "DisaggTopology",
    "DiskTier",
    "EngineConfig",
    "FabricDirectory",
    "FabricEndpoint",
    "FabricTransport",
    "FairQueue",
    "FaultClock",
    "FaultPlan",
    "FittedTracePolicy",
    "HostTier",
    "KVMigrator",
    "KV_CHAIN_VERSION",
    "KV_WIRE_VERSION",
    "Knob",
    "KnobSpec",
    "KnobView",
    "LRUTierPolicy",
    "LoopbackTransport",
    "NGramDrafter",
    "PagedKVPool",
    "PrefillPool",
    "PrefixAffinityPolicy",
    "PrefixIndex",
    "PrefixStoreClient",
    "QOS_GUARANTEE",
    "QOS_OPPORTUNISTIC",
    "QoSTierPolicy",
    "QuotaExceeded",
    "RECOVERY_BUCKETS",
    "ReplicaFleet",
    "ReplicaHandle",
    "ReplicaKilled",
    "Request",
    "RequestResult",
    "RoundRobinPolicy",
    "RoutingPolicy",
    "ScalingPolicy",
    "ServingEngine",
    "ShardDecision",
    "ShardedServingContext",
    "SocketTransport",
    "TTFTBreachPolicy",
    "TenantRegistry",
    "TenantSpec",
    "TierPolicy",
    "TuningPolicy",
    "WireCorruption",
    "adopt_into",
    "carve_replica_groups",
    "chain_token_runs",
    "export_prefix_store",
    "fabric_metric_families",
    "init_paged_pool",
    "load_prefix_store",
    "ngram_propose_rows",
    "pack_block",
    "pack_chain",
    "pack_message",
    "pack_ticket",
    "paged_copy_block",
    "paged_decode_loop",
    "paged_decode_span",
    "paged_decode_step",
    "paged_gather_kv",
    "paged_mixed_step",
    "paged_mixed_verify_step",
    "paged_prefill_step",
    "paged_spec_loop",
    "paged_upload_block",
    "paged_verify_span",
    "plan_prefill_chunks",
    "plan_sharding",
    "prefix_fabric_key",
    "recv_frame",
    "send_frame",
    "serve_prefix_store",
    "serving_sharding_rules",
    "unpack_block",
    "unpack_chain",
    "unpack_message",
    "unpack_ticket",
    "wire_block_bytes",
]
