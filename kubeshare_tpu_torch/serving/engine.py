"""Continuous-batching serving engine over the paged KV pool, port of the
single-device core of kubeshare_tpu/serving/engine.py.

The engine schedules at TOKEN granularity:

- a static pool of S slots runs one decode dispatch per iteration —
  every active slot advances, each at its own length (the paged steps'
  per-row positions);
- queued requests are admitted into freed slots mid-flight: admission
  reserves exactly the blocks the request can ever touch
  (prompt + max_new_tokens, rounded to blocks), and a reservation the
  pool cannot fund queues the request rather than clamping anything;
- prompts prefill in chunks of power-of-two widths (O(log chunk) shapes,
  not one per remainder), filling slots rotating round-robin;
- decode advances every active slot ``decode_span`` tokens per dispatch
  (lanes deactivate themselves on budget/EOS), and with
  ``steps_per_launch`` K > 1 up to K spans run in one launch
  (``paged.paged_decode_loop``);
- stall-free mixed batching (on by default): when prefill and decode
  work coexist, one fused dispatch (``paged.paged_mixed_step``) advances
  every decode lane by its span AND consumes one prefill chunk bounded
  by ``mixed_prefill_budget`` tokens;
- host/device overlap: a dispatch synchronizes only when charging an
  :class:`~kubeshare_tpu_torch.isolation.ExecutionGuard`; unguarded, the
  engine runs one step ahead — emitted tokens travel to pinned host
  memory by a non-blocking copy and are read when the next step consumes
  them;
- a radix-tree prefix cache (prefix_index.py) makes retired prompts'
  blocks content-addressable, with copy-on-write of a shared tail block
  (``paged.paged_copy_block``) when a prompt diverges mid-block;
- multi-tenant QoS (qos.py): a token-weighted fair queue, per-tenant
  KV block quotas, and cache-backed preemption of Opportunistic decode
  slots for a starved Guarantee admission, resumed bit-exactly;
- speculative decoding (``speculative``): decode lanes draft by n-gram
  lookup over their own history (drafter.py) and one width-W verify
  dispatch (``paged.paged_verify_span``) scores every lane's drafts,
  emitting the accepted prefix plus the correction pick; each lane's
  draft width adapts to its acceptance.  Verification is exact-match
  against the engine's own pick (each column under its emission's
  seed), so streams equal speculation off, greedy and sampled.  With
  ``steps_per_launch`` K > 1 drafted rounds run in the speculative device
  loop (``paged.paged_spec_loop``: up to K draft-verify units in one
  launch), and ``admission_ring`` R > 0 stages up to R queued requests,
  admitted and prefilled, which the loop activates into lanes that retire
  inside it.

Every dispatch shape is static — slot count, block tables, chunk widths
— and on the card each one is a CUDA graph, the counterpart of the JAX
engine's ``jax.jit`` programs: its inputs travel in one host-to-device
copy into a static buffer, and the graph replays.  :meth:`warmup`
captures every shape the engine can dispatch (all graphs share one
memory pool), after which serving captures nothing new
(:meth:`capture_counts`).  On the CPU, which a caller must ask for
(``device="cpu"``), the same programs run eagerly: that is the parity
path the tests hold against the JAX engine.

Sampling: a request carries a ``torch.Generator`` (``rng``); at its
first admission the engine draws one int64 seed per emission
(``models.decoding.sampling_seeds``), and each sampled pick is
``argmax(filtered / T + gumbel(seed))`` on the device.  The stream
depends on the seeds only — not on the slot, the span, the loop depth or
a preemption — and a single-slot engine reproduces
``sample_decode_with_cache`` token for token.

KV tiering (``host_tier_bytes``, ``disk_tier_bytes``, kv_tier.py): the
allocator's eviction callback serializes evicted prefix blocks into a
byte-budgeted host store instead of destroying them (one gather and one
device-to-host copy a subtree walk), host-budget evictions cascade into
an mmap-backed disk arena, and admission promotes matched blocks back
into fresh device blocks through ONE captured ``upload`` program.  The
online autotuner (``autotune``, autotune.py) retunes the capture-free
knobs — the fused budget, the loop depth, the draft-width caps — between
consume and plan.  The chaos seams (chaos.py) are plain attributes:
``fault_clock`` is consulted at the top of :meth:`ServingEngine.step`
and before every dispatch.  Streams are bit-exact with each of them off.

Disaggregation (``pool_role``, disagg.py): a "prefill" pool runs only
prefill chunks and reserves only a prompt's cover, handing each finished
prompt to its router through ``on_handoff``; a "decode" pool runs only
decode and verify dispatches and admits only through
:meth:`ServingEngine.admit_migrated`, which uploads the migrated chain
through the captured ``upload`` program.  ``admission_gate`` and
``on_preempt_requeue`` are the router's other seams, and ``pool_label`` /
``replica_label`` label the engine's metric families.

Tensor-parallel serving (``mesh_spec`` with tp > 1, sharded.py): a
:class:`~.sharded.ShardedServingContext` splits the params and the pool
over a device group and the step closures swap in its twins; nothing
else changes.  Host reads of the pool gather its shards into the
unsharded head order, uploads re-scatter them, and every dispatch is
still one captured graph on the group's card.  Streams equal the
single-device engine's wherever a product's output elements do not
depend on the product's width or batch (the CPU; the card at bf16; at
f32 cuBLAS gives a batch of ONE matrix other last bits).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from functools import partial
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.decoding import (_filter_logits, bucket_width, capture_graph,
                               pick_rows, sampling_seeds)
from ..models.transformer import TransformerConfig, check_config
from ..parallel.train import tree_leaves
from ..utils.promtext import MetricFamily, MetricServer, Sample, _format_value
from .autotune import AnalyticPolicy, AutoTuner
from .drafter import NGramDrafter
from .kv_blocks import (BlockAllocator, BlockExhausted, QuotaExceeded,
                        init_paged_pool)
from .kv_tier import (DiskTier, HostTier, LRUTierPolicy, QoSTierPolicy,
                      WireCorruption, pack_block, slab_words, unpack_block,
                      wire_block_bytes)
from .paged import (paged_copy_block, paged_decode_loop, paged_decode_span,
                    paged_mixed_step, paged_mixed_verify_step,
                    paged_prefill_step, paged_spec_loop, paged_upload_block,
                    paged_verify_span)
from .prefix_index import PrefixIndex
from .qos import (DEFAULT_TENANT, QOS_GUARANTEE, QOS_OPPORTUNISTIC,
                  FairQueue, TenantRegistry, TenantSpec)
from .sharded import ShardedServingContext

# TTFT histogram bucket upper bounds (seconds) for the metrics endpoint
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0)
# inter-token-latency (time-between-tokens) bucket bounds: an order of
# magnitude finer than TTFT; a lane stalled behind a long prompt shows up
# in the 100 ms .. 1 s slots
TBT_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
               0.1, 0.25, 0.5, 1.0)

# speculative acceptance-ratio bucket bounds: per verify round, accepted
# drafts / drafted, always in [0, 1]
SPEC_ACCEPT_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
# the speculative device loop's statics: each lane carries its newest
# SPEC_LOOP_HIST tokens as its device drafting window (drafts move the
# acceptance rate, never a stream), and a unit whose drafting lanes
# accept below SPEC_LOOP_REDRAFT of their aggregate proposals ends the
# launch, so the host's adaptive width sees the collapse
SPEC_LOOP_HIST = 64
SPEC_LOOP_REDRAFT = 0.25

# the dispatch kinds, as the JAX engine's compile_counts names them
DISPATCH_KINDS = ("decode", "prefill", "mixed", "verify", "mixed_verify",
                  "copy", "upload", "loop", "spec_loop")


def _bucket_observe(counts: List[int], seconds: float,
                    bounds=TTFT_BUCKETS, n: int = 1) -> None:
    """Add ``n`` observations of ``seconds`` to the ``bounds``
    histogram slot covering it (last slot is the +Inf tail)."""
    for i, le in enumerate(bounds):
        if seconds <= le:
            counts[i] += n
            return
    counts[-1] += n


def _histogram_samples(family: MetricFamily, name: str, labels: Dict[str, str],
                       counts: List[int], total: float,
                       bounds=TTFT_BUCKETS) -> None:
    """Append one Prometheus histogram series (cumulative buckets +
    sum + count) over ``bounds`` to ``family``."""
    cum = 0
    for le, count in zip(bounds, counts):
        cum += count
        family.samples.append(Sample(
            f"{name}_bucket", {**labels, "le": _format_value(le)}, cum))
    cum += counts[-1]
    family.samples.append(Sample(
        f"{name}_bucket", {**labels, "le": "+Inf"}, cum))
    family.samples.append(Sample(f"{name}_sum", labels, total))
    family.samples.append(Sample(f"{name}_count", labels, cum))


def plan_prefill_chunks(
    prompt_len: int, chunk: int, max_len: int, start: int = 0
) -> Tuple[List[Tuple[int, int, int]], int]:
    """Split a prompt into (start, width, last_row) chunks of bucketed
    widths; returns (plan, cover) where ``cover`` is the highest cache
    row the plan writes + 1 (never past ``max_len``).

    ``start`` is the first token that needs prefilling (the prefix
    cache's match length, 0 when cold): full-width chunks tile
    ``start ..``; the ragged tail becomes ONE bucketed chunk that ENDS at
    the prompt's last token by sliding its start back over written
    positions (the recompute is deterministic, so the overwrite is a
    no-op).  Only a prompt shorter than its own bucket pads forward from
    0; its pad rows are dead."""
    if not 0 <= start < prompt_len:
        raise ValueError(
            f"start {start} not in 0..{prompt_len - 1} (at least one "
            f"prompt token must prefill to produce first-token logits)")
    n, r = divmod(prompt_len - start, chunk)
    plan = [(start + i * chunk, chunk, chunk - 1) for i in range(n)]
    cover = start + n * chunk
    if r:
        width = min(bucket_width(r, chunk), max_len)
        if prompt_len >= width:
            plan.append((prompt_len - width, width, width - 1))
            cover = prompt_len
        else:  # whole prompt under its bucket: pad the tail; logits row
            plan = [(0, width, prompt_len - 1)]  # is the last REAL token
            cover = width
    return plan, cover


@dataclass(frozen=True)
class EngineConfig:
    """Static serving-pool geometry and scheduling knobs, the JAX
    engine's fields with their defaults.  ``num_slots`` bounds in-flight
    requests; ``num_blocks``/``block_size`` size the KV pool;
    ``max_request_len`` bounds prompt + generation per request and fixes
    the block-table width.  The fields of unported features are kept so
    a configuration reads the same in both packages; setting one raises
    (see ``_config_rows``)."""

    num_slots: int = 8
    block_size: int = 16
    num_blocks: int = 129  # 128 allocatable + scratch block 0
    max_request_len: int = 256
    prefill_chunk: int = 32
    # decode steps fused into ONE dispatch; lanes deactivate themselves
    # mid-span on budget/EOS, so streams are span-invariant
    decode_span: int = 4
    # up to K consecutive decode spans in one launch, exiting at the
    # first span boundary where any lane deactivated; a power of two
    # >= 1; 1 = off.  Streams are bit-exact with K=1.
    steps_per_launch: int = 1
    eos_token: Optional[int] = None
    # sampling restriction set, engine-wide (temperature rides per
    # request; the filter set is part of the captured step)
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    # radix-tree prefix caching over the block pool; streams are
    # bit-exact either way
    prefix_cache: bool = True
    # stall-free mixed batching; streams are bit-exact either way
    mixed: bool = True
    # KV cache tiering (kv_tier.py): a host-RAM byte budget for demoted
    # prefix blocks.  None = off (evicted prefixes are destroyed); set, the
    # allocator's eviction path serializes victims into the host tier, the
    # trie keeps their nodes HOST-resident, and admission promotes matched
    # host blocks back through one captured upload program.  Streams are
    # bit-exact either way.  Requires prefix_cache
    host_tier_bytes: Optional[int] = None
    # the TierPolicy: "lru" (demote all, evict coldest) or "qos"
    # (Guarantee-charged host bytes protected from Opportunistic pressure)
    tier_policy: str = "lru"
    # the DISK tier below host RAM: a byte budget for the mmap arena that
    # host-budget evictions cascade into; admission stages a matched disk
    # block back up (crc-validated) before its upload.  Requires
    # host_tier_bytes
    disk_tier_bytes: Optional[int] = None
    # the disk arena's file (None = an anonymous unlinked temporary file)
    disk_tier_path: Optional[str] = None
    # per-step cap on the prefill tokens fused into a mixed dispatch;
    # None = prefill_chunk
    mixed_prefill_budget: Optional[int] = None
    # self-drafted speculative decoding; streams are bit-exact either way
    speculative: bool = False
    # max drafted tokens per lane per verify round, a power of two: the
    # per-lane adaptive width doubles/halves within {1, 2, .., draft_len},
    # so warm-up captures O(log draft_len) verify shapes
    draft_len: int = 4
    # the drafter's maximum n-gram order
    draft_ngram: int = 3
    # disaggregated serving role (disagg.py): "both" is the monolithic
    # engine; "prefill" runs only prefill chunks, reserves only the
    # prompt's cover and hands finished prompts to a decode pool; "decode"
    # runs only decode/verify dispatches and admits only through
    # admit_migrated().  Streams are bit-exact with the monolithic engine
    pool_role: str = "both"
    # a parallel.mesh.MeshSpec: dp > 1 is a fleet's replica axis
    # (fleet.ReplicaFleet carves it); dp=ep=sp=1 within one engine is
    # tensor-parallel serving (sharded.py): params split Megatron-style,
    # the pool head-sharded, every dispatch one program over the group.
    # Streams are bit-exact with None wherever products do not depend on
    # their output's width
    mesh_spec: Optional[object] = None
    # prefill chunks at least this wide re-shard Ulysses-style (sequence-
    # parallel attention inside the sharded dispatch); requires mesh_spec
    long_context_threshold: Optional[int] = None
    # online autotuning (autotune.py): retune the capture-free knobs (the
    # fused budget, the loop depth, the draft-width caps) every
    # autotune_interval scheduler steps; under autotune warm-up captures
    # every fused width and every power-of-two loop depth up to
    # steps_per_launch, so a retuned knob only selects among captured
    # shapes.  Streams are bit-exact tuner-on vs tuner-off
    autotune: bool = False
    autotune_interval: int = 32
    # the speculative device loop's admission ring: queued requests
    # admitted and prefilled ahead of a launch, activated inside it into
    # lanes that retire; 0 = off.  Requires speculative and
    # steps_per_launch > 1
    admission_ring: int = 0


def _warmed_prefill_widths(ec: EngineConfig) -> set:
    """The prefill-chunk bucket universe warmup captures: the configured
    chunk plus every smaller power of two, capped at the slot row bound.
    Empty on a decode-role pool: no prefill shape ever dispatches there."""
    if ec.pool_role == "decode":
        return set()
    widths = {ec.prefill_chunk}
    w = 1
    while w < ec.prefill_chunk:
        widths.add(w)
        w *= 2
    return {min(w, ec.max_request_len) for w in widths}


def _config_rows(ec: EngineConfig, config: TransformerConfig,
                 mesh_devices=None, shared_host_tier=None):
    """The engine-config validation table: ``(failed, error, message)``
    rows checked in order by :class:`ServingEngine`, the JAX engine's
    rows.  The two mesh rows the JAX engine raises for a fleet's axis
    come first (the spec is read duck-typed; the sharded context reads
    it again)."""
    widths = _warmed_prefill_widths(ec)
    min_piece = min(widths) if widths else 1
    wire = (wire_block_bytes(
        ec.block_size, config.n_layers, config.kv_heads, ec.block_size,
        config.head_dim, torch.empty((), dtype=config.dtype).element_size())
        if ec.host_tier_bytes is not None else None)
    bad = ValueError
    spec = ec.mesh_spec
    return [
        (spec is not None and (getattr(spec, "dp", 1) != 1
                               or getattr(spec, "ep", 1) != 1
                               or getattr(spec, "sp", 1) != 1), bad,
         f"a SINGLE engine shards tensor-parallel only: "
         f"mesh_spec must have dp=ep=sp=1 (slots are the batch "
         f"axis inside one engine), got {spec} — dp > 1 is "
         f"the replica axis: hand this spec to "
         f"serving/fleet.ReplicaFleet, which carves it into "
         f"per-replica tp device groups via "
         f"carve_replica_groups and runs one engine per group"),
        (mesh_devices is not None and spec is None, bad,
         "mesh_devices requires mesh_spec — an unsharded engine "
         "has no mesh to pin onto a device group; pin it with "
         "device= instead (the fleet's tp=1 build path does exactly "
         "that)"),
        (ec.max_request_len > config.max_seq_len, bad,
         f"max_request_len {ec.max_request_len} exceeds the model's "
         f"max_seq_len {config.max_seq_len}"),
        (ec.prefill_chunk < 1, bad,
         f"prefill_chunk must be >= 1, got {ec.prefill_chunk}"),
        (ec.decode_span < 1, bad,
         f"decode_span must be >= 1, got {ec.decode_span}"),
        (ec.steps_per_launch < 1
         or bool(ec.steps_per_launch & (ec.steps_per_launch - 1)), bad,
         f"steps_per_launch must be a power of two >= 1, got "
         f"{ec.steps_per_launch}"),
        (ec.steps_per_launch > 1 and ec.pool_role == "prefill", bad,
         f"steps_per_launch {ec.steps_per_launch} is meaningless "
         f"on a prefill-role pool — it never runs decode plans, "
         f"so the device loop would silently never fire; set "
         f"steps_per_launch=1"),
        (ec.mixed_prefill_budget is not None
         and ec.mixed_prefill_budget < 1, bad,
         f"mixed_prefill_budget must be >= 1 or None, got "
         f"{ec.mixed_prefill_budget}"),
        (ec.mixed and ec.mixed_prefill_budget is not None
         and ec.mixed_prefill_budget < min_piece, bad,
         f"mixed_prefill_budget {ec.mixed_prefill_budget} is below the "
         f"smallest warmed chunk piece ({min_piece}) — no fused chunk "
         f"could ever be sliced to fit, so prefill would silently starve "
         f"behind decode"),
        (ec.host_tier_bytes is not None and not ec.prefix_cache, bad,
         "host_tier_bytes requires prefix_cache=True — the tier "
         "spills the radix index; there is nothing to spill "
         "without it"),
        (ec.host_tier_bytes is not None and wire is not None
         and ec.host_tier_bytes < wire, bad,
         f"host_tier_bytes {ec.host_tier_bytes} is below one "
         f"block's wire size ({wire}) — the tier could "
         f"never hold a single block"),
        (ec.tier_policy not in ("lru", "qos"), bad,
         f"tier_policy must be 'lru' or 'qos', got {ec.tier_policy!r}"),
        (ec.disk_tier_bytes is not None and ec.host_tier_bytes is None, bad,
         "disk_tier_bytes requires host_tier_bytes — the disk tier "
         "is the cascade target of host-budget evictions; there is "
         "no HOST→DISK demotion without a host tier above it"),
        (ec.disk_tier_bytes is not None and wire is not None
         and ec.disk_tier_bytes < wire, bad,
         f"disk_tier_bytes {ec.disk_tier_bytes} is below one "
         f"block's wire size ({wire}) — the disk tier could "
         f"never hold a single block"),
        (ec.disk_tier_path is not None and ec.disk_tier_bytes is None, bad,
         "disk_tier_path without disk_tier_bytes — a named arena file "
         "needs a disk tier to fill it"),
        (shared_host_tier is not None and ec.host_tier_bytes is not None, bad,
         "shared_host_tier and host_tier_bytes are mutually "
         "exclusive — the disagg router owns the shared tier's "
         "budget"),
        (shared_host_tier is not None and not ec.prefix_cache, bad,
         "shared_host_tier requires prefix_cache=True — the tier "
         "spills the radix index; there is nothing to spill "
         "without it"),
        (ec.long_context_threshold is not None and spec is None, bad,
         "long_context_threshold requires mesh_spec — the "
         "Ulysses route is a re-shard inside the sharded "
         "program; a single-device engine has nothing to route"),
        (ec.draft_len < 1 or bool(ec.draft_len & (ec.draft_len - 1)), bad,
         f"draft_len must be a power of two >= 1, got {ec.draft_len}"),
        (ec.draft_ngram < 1, bad,
         f"draft_ngram must be >= 1, got {ec.draft_ngram}"),
        (ec.pool_role not in ("both", "prefill", "decode"), bad,
         f"pool_role must be 'both', 'prefill' or 'decode', got "
         f"{ec.pool_role!r}"),
        (ec.pool_role != "both" and ec.mixed, bad,
         f"pool_role {ec.pool_role!r} excludes mixed batching — "
         f"a single-phase pool has no prefill+decode coexistence "
         f"to fuse; set mixed=False"),
        (ec.autotune_interval < 1, bad,
         f"autotune_interval must be >= 1, got "
         f"{ec.autotune_interval} — the tuner ticks once per "
         f"scheduler step and retunes every interval-th tick"),
        (ec.admission_ring < 0, bad,
         f"admission_ring must be >= 0, got {ec.admission_ring}"),
        (ec.admission_ring > 0 and (not ec.speculative
                                    or ec.steps_per_launch <= 1
                                    or ec.pool_role != "both"), bad,
         f"admission_ring {ec.admission_ring} requires "
         f"speculative=True, steps_per_launch > 1 and "
         f"pool_role='both' — the ring is consumed only inside the "
         f"speculative device loop, and its host-side fill runs this "
         f"pool's own prefill path"),
    ]


@dataclass
class Request:
    """One generation request.  ``temperature == 0`` is greedy; sampled
    requests must carry their own ``torch.Generator`` as ``rng`` (the
    engine draws the request's seed schedule from it at first admission,
    as ``sample_decode_with_cache`` draws it, so a single-slot engine
    reproduces that stream).  ``tenant`` names a registered
    :class:`~kubeshare_tpu_torch.serving.qos.TenantSpec`; the default
    registry has one uncapped Guarantee tenant."""

    rid: str
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    rng: Optional[torch.Generator] = None
    tenant: str = DEFAULT_TENANT


@dataclass
class _Pending:
    """A queued (or preempted-and-requeued) request with everything
    admission needs precomputed.  Fresh submissions carry ``rng`` and
    draw their seed schedule at first admission; a RESUMED entry carries
    the remaining schedule explicitly (``first_seed`` + ``step_seeds``)
    plus the tokens already emitted."""

    rid: str
    tenant: str
    prompt: np.ndarray
    max_new: int
    temperature: float
    plan: List[Tuple[int, int, int]]
    needed: int
    rng: Optional[torch.Generator] = None
    first_seed: Optional[int] = None
    step_seeds: Optional[np.ndarray] = None
    emitted: List[int] = field(default_factory=list)
    # a RESUMED entry's last pre-preemption emission time (its gap to
    # the continuation's first token lands in the TBT histogram)
    last_token_at: Optional[float] = None


@dataclass
class _PrefixHit:
    """One admission's prefix-cache match, tier-aware.  ``start`` is the
    first token that must prefill; ``shared`` are DEVICE-resident fully
    matched blocks (retained and mapped for the request's lifetime);
    ``promote`` are HOST-resident fully matched trie nodes whose payloads
    upload into the leading freshly reserved blocks; at most one of
    ``cow_src`` (device partial match: the copy-on-write dispatch) and
    ``host_cow`` (host partial match: the payload uploaded straight into
    the private tail block, the entry staying host-side) is set.
    ``needed`` counts the reservation (promoted + private tail + fresh
    suffix blocks); ``host_tokens`` the prompt tokens recovered from
    host-resident blocks."""

    start: int
    shared: List[int]
    cow_src: Optional[int]
    promote: List
    host_cow: Optional[object]
    plan: List[Tuple[int, int, int]]
    needed: int
    host_tokens: int


@dataclass
class RequestResult:
    rid: str
    prompt_len: int
    tokens: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.finished_at is not None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


@dataclass
class _StepPlan:
    """ONE scheduling decision: which lanes prefill / decode / verify this
    step and at what widths.  ``kind`` selects the dispatch — "prefill"
    (one standalone chunk), "decode" (the span), "loop" (the
    device-resident multi-span loop), "verify" (the draft-verify chunk),
    "spec_loop" (the speculative device loop), "mixed" / "mixed_verify"
    (a prefill chunk fused with the span / the verify chunk).  ``drafts``
    maps a slot index to its proposed tokens; ``verify_width`` is the
    dispatch width 1 + the power-of-two-bucketed longest draft."""

    kind: str
    prefill_slot: Optional["_Slot"] = None
    chunk: Optional[Tuple[int, int, int]] = None
    decode_slots: List["_Slot"] = field(default_factory=list)
    drafts: Dict[int, List[int]] = field(default_factory=dict)
    verify_width: int = 0


class _Slot:
    __slots__ = (
        "idx", "state", "rid", "blocks", "table", "length", "generated",
        "prompt", "plan", "max_new", "temperature", "first_seed",
        "step_seeds", "result", "tenant", "emitted_prefix",
        "last_token_at", "drafter", "draft_width", "accept_rate",
    )

    def __init__(self, idx: int, table_width: int) -> None:
        self.idx = idx
        self.state = "free"  # free | prefill | decode
        self.table = np.zeros(table_width, np.int64)
        self._clear()

    def _clear(self) -> None:
        self.rid = ""
        self.blocks: List[int] = []
        self.table[:] = 0  # every entry back to the scratch block
        self.length = 0
        self.generated: List[int] = []
        self.prompt = None
        self.plan: List[Tuple[int, int, int]] = []
        self.max_new = 0
        self.temperature = 0.0
        self.first_seed = 0
        self.step_seeds = np.zeros((0,), np.int64)
        self.result: Optional[RequestResult] = None
        self.tenant = DEFAULT_TENANT
        # tokens emitted in earlier incarnations of a preempted request;
        # prepended to slot.generated at retirement
        self.emitted_prefix: List[int] = []
        # wall time the slot's newest token became host-visible
        self.last_token_at: Optional[float] = None
        # speculative state: the lane's drafter, its adaptive draft width
        # (a power of two in 1..draft_len) and the acceptance-rate EMA
        # driving it; rebuilt at (re-)admission from the prompt, which
        # for a resumed request is prompt + generated
        self.drafter: Optional[NGramDrafter] = None
        self.draft_width = 0
        self.accept_rate = 0.5


# the host staging views of a program's inputs; a bf16 input (the upload
# program's slabs) is staged as its raw int16 words, which numpy holds
_NUMPY_DTYPES = {torch.int64: np.int64, torch.float32: np.float32,
                 torch.bool: np.bool_, torch.bfloat16: np.int16,
                 torch.float16: np.float16}


class _Program:
    """One dispatch shape: its inputs' static device buffers, the
    function, and on CUDA the graph that replays it.

    All inputs live in one byte arena, so a dispatch moves its inputs in
    ONE host-to-device copy: on CUDA from one of two pinned staging
    arenas (alternated, each reused only once its previous copy has run),
    on the CPU written straight into the buffers.  The buffers start at
    zero — all lanes inactive, every table at the scratch block — and the
    warm-up passes and the capture run on those zeros, so they write
    only the scratch block.  On CUDA :meth:`run` returns the graph's
    static outputs, which the next replay of this program overwrites:
    the caller copies what it keeps before then."""

    def __init__(self, kind: str, fn: Callable, specs, device: torch.device,
                 pool) -> None:
        self.kind = kind
        self.fn = fn
        self.device = device
        views, nbytes = [], 0
        for name, shape, dtype in specs:
            size = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            views.append((name, nbytes, size, shape, dtype))
            nbytes += -(-size // 8) * 8  # 8-byte aligned views
        self.arena = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        self.inputs = {name: self.arena[o: o + n].view(dtype).view(shape)
                       for name, o, n, shape, dtype in views}
        self.cuda = device.type == "cuda"
        arenas = ([torch.zeros_like(self.arena, device="cpu").pin_memory()
                   for _ in range(2)] if self.cuda else [self.arena])
        self.staging = [
            (arena, {name: arena.numpy()[o: o + n].view(
                _NUMPY_DTYPES[dtype]).reshape(shape)
                for name, o, n, shape, dtype in views})
            for arena in arenas]
        self.copied: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0
        if self.cuda:
            self.graph, self.outputs = capture_graph(
                lambda: self.fn(**self.inputs), device, pool)

    def run(self, values: Dict[str, np.ndarray]):
        if values.keys() != self.inputs.keys():
            raise ValueError(
                f"{self.kind}: inputs {sorted(values)} differ from "
                f"{sorted(self.inputs)}")
        turn = self.turn if self.cuda else 0
        arena, host = self.staging[turn]
        if self.copied[turn] is not None:
            self.copied[turn].synchronize()
        for name, value in values.items():
            host[name][...] = value
        if not self.cuda:
            return self.fn(**self.inputs)
        self.arena.copy_(arena, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.copied[turn] = event
        self.turn ^= 1
        self.graph.replay()
        return self.outputs


class _Fetch:
    """Device outputs on their way to the host: on CUDA a non-blocking
    copy into pinned memory and an event, read (waiting on the event
    only) when the engine consumes them."""

    def __init__(self, *tensors: torch.Tensor) -> None:
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in tensors]
            for host, t in zip(self.host, tensors):
                host.copy_(t, non_blocking=True)
            self.event: Optional[torch.cuda.Event] = torch.cuda.Event()
            self.event.record()
        else:  # the eager programs return new tensors every run
            self.host = list(tensors)
            self.event = None

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [host.numpy() for host in self.host]


def _paged_steps(params, config: TransformerConfig) -> SimpleNamespace:
    """The single-device paged steps under the sharded twins' names and
    signatures (paged's, less ``params`` and ``config``)."""
    return SimpleNamespace(
        prefill_step=partial(paged_prefill_step, params, config),
        decode_span=partial(paged_decode_span, params, config),
        decode_loop=partial(paged_decode_loop, params, config),
        mixed_step=partial(paged_mixed_step, params, config),
        verify_span=partial(paged_verify_span, params, config),
        mixed_verify_step=partial(paged_mixed_verify_step, params, config),
        spec_loop=partial(paged_spec_loop, params, config),
        copy_block=paged_copy_block,
        upload_block=paged_upload_block)


class ServingEngine:
    """Continuous-batching engine; see the module docstring.

    Drive it with :meth:`submit` + :meth:`run` (drain everything) or
    :meth:`step` (one scheduling iteration).  ``device`` is the CUDA
    device unless the caller names another (``"cpu"`` runs the programs
    eagerly); ``params`` must live there.  Without a card and without
    ``device="cpu"`` the constructor raises.  With a ``mesh_spec`` the
    engine runs over ``mesh_devices`` (None: the CPU tp times when
    ``device="cpu"``, else the leading tp CUDA devices), its device is the
    group's first, and the params are placed from wherever they live."""

    def __init__(
        self,
        params,
        config: TransformerConfig,
        engine_config: Optional[EngineConfig] = None,
        guard=None,
        tenants: Optional[TenantRegistry] = None,
        device=None,
        shared_host_tier: Optional[HostTier] = None,
        mesh_devices=None,
        tier_ledger_hook=None,
        tuning_policy=None,
        pool_label: Optional[str] = None,
        replica_label: Optional[str] = None,
    ) -> None:
        ec = engine_config or EngineConfig()
        for failed, error, message in _config_rows(
                ec, config, mesh_devices=mesh_devices,
                shared_host_tier=shared_host_tier):
            if failed:
                raise error(message)
        check_config(config)
        # fail fast on a bad filter set, like the dense sampling entries
        _filter_logits(torch.zeros((1, 2)), ec.top_k, ec.top_p)
        # tensor-parallel mode: the context owns the mesh, the sharding
        # decision, parameter placement, and the twins the step closures
        # swap in.  On the CPU the group names the CPU tp times; the
        # engine's device is the group's first (inputs, picks, reads)
        if (ec.mesh_spec is not None and mesh_devices is None
                and device is not None
                and torch.device(device).type == "cpu"):
            mesh_devices = [torch.device(device)] * ec.mesh_spec.tp
        self._sharded = (ShardedServingContext(
            config, ec.mesh_spec, params,
            long_context_threshold=ec.long_context_threshold,
            devices=mesh_devices)
            if ec.mesh_spec is not None else None)
        if self._sharded is not None:
            group = self._sharded.devices
            self.device = group[0]
            if self.device.type == "cuda" and len(set(group)) > 1:
                raise ValueError(
                    f"mesh_devices {[str(d) for d in group]}: a group of "
                    f"distinct CUDA devices is not supported — each "
                    f"dispatch is one CUDA graph captured on one card's "
                    f"stream; name one card for every shard (e.g. "
                    f"[cuda:0] * tp)")
            params = self._sharded.place_params(params)
        else:
            self.device = resolve_device(device)
            devices = {leaf.device for leaf in tree_leaves(params)}
            if devices != {self.device}:
                raise ValueError(
                    f"params live on {sorted(map(str, devices))}, the "
                    f"engine runs on {self.device}")
        self.params = params
        self.model_config = config
        self.engine_config = ec
        self.guard = guard
        self.pool = init_paged_pool(config, ec.num_blocks, ec.block_size,
                                    self.device)
        if self._sharded is not None:
            k, v = self._sharded.place_pool(self.pool.k, self.pool.v)
            self.pool = replace(self.pool, k=k, v=v)
        self.prefix_index = (PrefixIndex(ec.block_size)
                             if ec.prefix_cache else None)
        # the tenant registry must exist before the tier policy (the QoS
        # policy reads class membership from it)
        self.tenants = tenants or TenantRegistry.default()
        self.host_tier: Optional[HostTier] = None
        self.disk_tier: Optional[DiskTier] = None
        if ec.host_tier_bytes is not None:
            policy = (LRUTierPolicy() if ec.tier_policy == "lru"
                      else QoSTierPolicy(self.tenants))
            self.host_tier = HostTier(ec.host_tier_bytes, policy,
                                      on_drop=self._spill_host_entry,
                                      ledger_hook=tier_ledger_hook)
            # the index purges a detached host descendant's tier entry
            # through this hook
            self.prefix_index.host_drop = self.host_tier.forget
            if ec.disk_tier_bytes is not None:
                self.disk_tier = DiskTier(ec.disk_tier_bytes,
                                          path=ec.disk_tier_path,
                                          on_drop=self._drop_disk_entry)
                self.prefix_index.disk_drop = self.disk_tier.forget
        elif shared_host_tier is not None:
            # a tier shared with another pool: its owner sets on_drop
            # (it must route an entry to whichever trie holds its node);
            # this engine wires forget so its own detach paths purge
            self.host_tier = shared_host_tier
            self.prefix_index.host_drop = self.host_tier.forget
        self.allocator = BlockAllocator(
            ec.num_blocks, ec.block_size,
            evictor=(self._evict_blocks if self.prefix_index is not None
                     else None))
        self._table_width = -(-ec.max_request_len // ec.block_size)
        self._slots = [_Slot(i, self._table_width)
                       for i in range(ec.num_slots)]
        self._mixed_budget = (ec.mixed_prefill_budget
                              if ec.mixed_prefill_budget is not None
                              else ec.prefill_chunk)
        self._prefill_rr = 0
        # the one dispatch whose host-side effects are still pending
        # (read when consumed — see _consume_inflight)
        self._inflight = None
        # the admission ring: requests admitted and prefilled into
        # detached _Slot objects (idx -1) for activation inside the
        # speculative loop; entries it does not activate are bound to free
        # slots by _admit
        self._ring_staged: List[_Slot] = []
        self._warmed_widths = _warmed_prefill_widths(ec)
        # autotuner-owned scheduling state: the effective loop depth
        # (starts at the configured ceiling; the tuner moves it among the
        # captured depths), the per-lane draft-width cap and the
        # speculative loop's in-loop draft cap (data to its one graph)
        self._loop_k = ec.steps_per_launch
        self._draft_width_cap = ec.draft_len
        self._loop_draft_cap = ec.draft_len
        # the loop depths warm-up captures: the configured K, or under
        # autotune every power of two from 2 up to it (K = 1 is the plain
        # span); the speculative loop's the same set
        loop_ks: List[int] = []
        if ec.steps_per_launch > 1:
            loop_ks = ([k for k in (2 ** i for i in range(1, 32))
                        if k <= ec.steps_per_launch] if ec.autotune
                       else [ec.steps_per_launch])
        self._loop_steps = set(loop_ks)
        self._spec_loops = (set(loop_ks) if ec.speculative
                            and ec.pool_role != "prefill" else set())
        self._queue = FairQueue(self.tenants)
        self._results: Dict[str, RequestResult] = {}
        # counters: prefill_chunks / decode_steps / verify_steps count
        # WORK UNITS (chunks processed, spans and verify chunks run —
        # standalone or fused); mixed_steps / mixed_verify_steps count
        # fused dispatches; loop_launches / spec_loop_launches the device
        # loops' launches and loop_units / spec_loop_units the units they
        # ran (absorbed into decode_steps / verify_steps)
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.mixed_steps = 0
        self.verify_steps = 0
        self.mixed_verify_steps = 0
        self.loop_launches = 0
        self.loop_units = 0
        self.spec_loop_launches = 0
        self.spec_loop_units = 0
        self.loop_exit_reasons: Dict[str, int] = {
            "retire": 0, "budget": 0, "stop": 0, "redraft": 0,
            "ring_empty": 0}
        # speculation per tenant: drafts scored, drafts that reached the
        # stream, and the per-round acceptance histogram [counts, sum]
        self.spec_drafted: Dict[str, int] = {}
        self.spec_accepted: Dict[str, int] = {}
        self._spec_accept: Dict[str, list] = {}
        # activations of ring entries inside the speculative loop
        self.ring_activations = 0
        self.loop_depth_sum = 0
        self.loop_depth_count = 0
        # span-units the most recent launch may cover: the fleet's
        # dispatch watchdog scales its hang budget by it, so a healthy
        # K-unit loop launch is never flagged hung
        self.last_launch_units = 1
        # host wall seconds by step() phase; "tune" stays 0 without a tuner
        self.host_seconds: Dict[str, float] = {
            "admit": 0.0, "plan": 0.0, "dispatch": 0.0, "consume": 0.0,
            "tune": 0.0}
        self.host_planner_invocations = 0
        self.tokens_generated = 0
        self.peak_blocks_in_use = 0
        self.requests_admitted = 0
        self.requests_finished = 0
        self.prefix_hit_requests = 0
        self.prefix_hit_tokens = 0  # prompt tokens whose prefill was skipped
        self.cow_copies = 0
        # sharded serving: ESTIMATED group-total bytes moved by the
        # collectives inside each dispatch kind (the shard-shape model of
        # sharded.dispatch_collective_bytes) — all zero on a single-device
        # engine, exported as kubeshare_serving_collective_bytes_total
        self.collective_bytes: Dict[str, int] = {
            "prefill_chunk": 0, "decode_span": 0, "verify_span": 0}
        # eviction outcome by reason: reservation_pressure / quota_drain
        # name the trigger when evicted K/V is destroyed, tier_demote /
        # tier_drop the tier's verdict when it is consulted instead
        self.evictions_by_reason: Dict[str, int] = {
            "reservation_pressure": 0, "quota_drain": 0,
            "tier_demote": 0, "tier_drop": 0}
        # KV tier counters: blocks spilled host-side, dropped, copied back
        # into device blocks (private partial copies included), admissions
        # that recovered tiered prefix rows and the tokens they recovered,
        # the host seconds spent staging promotions (payload validation,
        # disk reads, upload enqueue) and demoting (the device-to-host
        # read and the packing), and wire blocks that failed their crc32
        # (each dropped and re-prefilled, never attended)
        self.tier_demoted_blocks = 0
        self.tier_dropped_blocks = 0
        self.tier_promoted_blocks = 0
        self.tier_hit_requests = 0
        self.tier_hit_tokens = 0
        self.tier_promotion_stall_s = 0.0
        self.tier_demotion_s = 0.0
        self.tier_hit_requests_by_origin: Dict[str, int] = {
            "local": 0, "remote": 0}
        self.tier_corrupt_blocks = 0
        # disaggregation surface (disagg.py): pool_label labels this
        # engine's latency and dispatch families, replica_label a fleet
        # replica's.  The hooks are router-installed seams:
        # on_handoff(slot) fires at prefill completion in place of
        # entering decode, on_preempt_requeue(tenant, pending) reroutes a
        # preemption's resume (the router re-plans it with the PREFILL
        # pool's geometry), on_tier_demote(node, payload, tenant) mirrors
        # a demoted block into the peer pool's trie, and admission_gate()
        # -> bool is consulted before each queue pop (the router's
        # handoff backpressure).  None outside a router
        self.pool_label = pool_label
        self.replica_label = replica_label
        self.on_handoff = None
        self.on_preempt_requeue = None
        self.on_tier_demote = None
        self.admission_gate = None
        # the event recorded after this engine's newest dispatch (on the
        # card): a reader of the pool on another stream waits on it
        self.last_dispatch_event: Optional[torch.cuda.Event] = None
        # chaos seam (chaos.py): a FaultClock consulted at the top of
        # step() (replica kill) and before every dispatch (slow dispatch);
        # None outside chaos runs
        self.fault_clock = None
        self._ttft_counts = [0] * (len(TTFT_BUCKETS) + 1)  # +Inf tail
        self._ttft_sum = 0.0
        self.preemptions: Dict[str, int] = {}
        self.tenant_tokens: Dict[str, int] = {}
        self._ttft_class: Dict[str, list] = {
            cls: [[0] * (len(TTFT_BUCKETS) + 1), 0.0]
            for cls in (QOS_GUARANTEE, QOS_OPPORTUNISTIC)}
        self._tbt_class: Dict[str, list] = {
            cls: [[0] * (len(TBT_BUCKETS) + 1), 0.0]
            for cls in (QOS_GUARANTEE, QOS_OPPORTUNISTIC)}
        # the device time of every dispatch by kind (CUDA events around
        # the input copy and the replay; on the card only), read as the
        # events complete
        self.device_ms: Dict[str, float] = {k: 0.0 for k in DISPATCH_KINDS}
        self.device_dispatches: Dict[str, int] = {k: 0 for k in DISPATCH_KINDS}
        self._timings: List[Tuple[str, torch.cuda.Event,
                                  torch.cuda.Event]] = []

        # one program per dispatch shape, built (captured, on the card)
        # at warm-up or at first use; all graphs share one memory pool
        self._programs: Dict[Tuple, _Program] = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self._pick = self._make_pick()
        # the online autotuner, ticked by step() between consume and plan;
        # its policy is pluggable and sandboxed to the captured shapes
        self._tuner = (AutoTuner.for_engine(
            self, policy=tuning_policy or AnalyticPolicy(),
            interval=ec.autotune_interval) if ec.autotune else None)

    # ------------------------------------------------------------------
    # the device programs
    # ------------------------------------------------------------------
    def _make_pick(self):
        top_k, top_p = self.engine_config.top_k, self.engine_config.top_p

        def pick(logits, temps, seeds):
            return pick_rows(logits, temps, seeds, top_k, top_p)

        return pick

    def _program(self, kind: str, width: int = 0,
                 verify_width: int = 0) -> _Program:
        """The program of one dispatch shape, built on first use:
        ``width`` is the prefill chunk of "prefill" / "mixed" /
        "mixed_verify", the depth K of "loop" / "spec_loop";
        ``verify_width`` the chunk width W of "verify" / "mixed_verify"."""
        key = (kind, width, verify_width)
        program = self._programs.get(key)
        if program is None:
            fn, specs = self._program_spec(kind, width, verify_width)
            program = _Program(kind, fn, specs, self.device, self._graph_pool)
            self._programs[key] = program
        return program

    def _program_spec(self, kind: str, width: int, verify_width: int):
        """(function, input specs) of one dispatch shape.  The closures
        call the single-device paged steps or, on a sharded engine, the
        context's twins (the same signatures less params and config)."""
        ec = self.engine_config
        cfg, pick = self.model_config, self._pick
        steps = (self._sharded if self._sharded is not None
                 else _paged_steps(self.params, cfg))
        pk, pv = self.pool.k, self.pool.v
        span, eos = ec.decode_span, ec.eos_token
        s, t = ec.num_slots, self._table_width
        i64, f32, b = torch.int64, torch.float32, torch.bool
        prefill_specs = [
            ("p_table", (1, t), i64), ("p_start", (1,), i64),
            ("p_tokens", (1, width), i64), ("p_last_row", (1,), i64),
            ("p_temp", (1,), f32), ("p_seed", (1,), i64)]

        def lane_specs(steps):
            return [("tables", (s, t), i64), ("lengths", (s,), i64),
                    ("active", (s,), b), ("tokens", (s,), i64),
                    ("temps", (s,), f32), ("seeds", (s, steps), i64),
                    ("budgets", (s,), i64)]

        if kind == "prefill":
            def prefill(p_table, p_start, p_tokens, p_last_row, p_temp,
                        p_seed):
                # one lane a chunk; the first-token pick rides fused (only
                # a prompt's final chunk consumes it)
                logits = steps.prefill_step(
                    pk, pv, p_table, p_start,
                    torch.ones_like(p_start, dtype=torch.bool), p_tokens,
                    p_last_row)
                return (pick(logits, p_temp, p_seed),)
            return prefill, prefill_specs
        if kind == "decode":
            def decode(tables, lengths, active, tokens, temps, seeds,
                       budgets):
                return (steps.decode_span(
                    pick, span, eos, pk, pv, tables, lengths, active,
                    tokens, temps, seeds, budgets),)
            return decode, lane_specs(span)
        if kind == "loop":
            def loop(tables, lengths, active, tokens, temps, seeds,
                     budgets):
                return steps.decode_loop(
                    pick, span, width, eos, pk, pv, tables, lengths, active,
                    tokens, temps, seeds, budgets)
            return loop, lane_specs(width * span)
        if kind == "mixed":
            def mixed(p_table, p_start, p_tokens, p_last_row, p_temp,
                      p_seed, tables, lengths, active, tokens, temps, seeds,
                      budgets):
                return steps.mixed_step(
                    pick, span, eos, pk, pv, p_table, p_start,
                    p_tokens, p_last_row, p_temp, p_seed, tables, lengths,
                    active, tokens, temps, seeds, budgets)
            return mixed, prefill_specs + lane_specs(span)
        verify_specs = [
            ("tables", (s, t), i64), ("lengths", (s,), i64),
            ("active", (s,), b), ("tokens", (s, verify_width), i64),
            ("widths", (s,), i64), ("temps", (s,), f32),
            ("seeds", (s, verify_width), i64)]
        if kind == "verify":
            def verify(tables, lengths, active, tokens, widths, temps,
                       seeds):
                return steps.verify_span(
                    pick, pk, pv, tables, lengths, active, tokens, widths,
                    temps, seeds)
            return verify, verify_specs
        if kind == "mixed_verify":
            def mixed_verify(p_table, p_start, p_tokens, p_last_row, p_temp,
                             p_seed, tables, lengths, active, tokens, widths,
                             temps, seeds):
                return steps.mixed_verify_step(
                    pick, pk, pv, p_table, p_start, p_tokens,
                    p_last_row, p_temp, p_seed, tables, lengths, active,
                    tokens, widths, temps, seeds)
            return mixed_verify, prefill_specs + verify_specs
        if kind == "spec_loop":
            w, r, h = 1 + ec.draft_len, ec.admission_ring, SPEC_LOOP_HIST
            n_seeds = width * w

            def spec_loop(tables, lengths, active, tokens, temps, seeds,
                          budgets, hist, hist_len, dcaps, r_tables,
                          r_lengths, r_tokens, r_temps, r_seeds, r_budgets,
                          r_hist, r_hist_len, r_caps, r_count):
                return steps.spec_loop(
                    pick, width, eos, ec.draft_ngram,
                    SPEC_LOOP_REDRAFT, w, pk, pv, tables, lengths, active,
                    tokens, temps, seeds, budgets, hist, hist_len, dcaps,
                    r_tables, r_lengths, r_tokens, r_temps, r_seeds,
                    r_budgets, r_hist, r_hist_len, r_caps, r_count)
            return spec_loop, lane_specs(n_seeds) + [
                ("hist", (s, h), i64), ("hist_len", (s,), i64),
                ("dcaps", (s,), i64), ("r_tables", (r, t), i64),
                ("r_lengths", (r,), i64), ("r_tokens", (r,), i64),
                ("r_temps", (r,), f32), ("r_seeds", (r, n_seeds), i64),
                ("r_budgets", (r,), i64), ("r_hist", (r, h), i64),
                ("r_hist_len", (r,), i64), ("r_caps", (r,), i64),
                ("r_count", (), i64)]
        if kind == "copy":
            def copy(src, dst):
                steps.copy_block(pk, pv, src, dst)
                return ()
            return copy, [("src", (1,), i64), ("dst", (1,), i64)]
        if kind == "upload":
            # the KV tier's promotion: one block's slabs, staged in the
            # program's arena like every input, into pool block dst
            def upload(dst, k_slab, v_slab):
                steps.upload_block(pk, pv, dst, k_slab, v_slab)
                return ()
            slab = (cfg.n_layers, cfg.kv_heads, ec.block_size, cfg.head_dim)
            return upload, [("dst", (1,), i64), ("k_slab", slab, pk.dtype),
                            ("v_slab", slab, pk.dtype)]
        raise ValueError(f"unknown dispatch kind {kind!r}")

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def _lifetime_rows(self, prompt_len: int, max_new: int,
                       cover: int) -> int:
        """Cache rows a request occupies over its life in THIS pool: a
        prefill-role pool writes only the prompt's K/V (decode rows land
        in the decode pool after migration), so it reserves just the
        chunk plan's cover; every other pool the full lifetime.  The
        max_request_len check stays on the full rows (:meth:`submit`)."""
        if self.engine_config.pool_role == "prefill":
            return cover
        return max(cover, prompt_len + max_new)

    def submit(self, request: Request) -> RequestResult:
        """Queue a request; validation failures raise HERE (loudly), a
        merely-busy pool queues.  A decode-role pool refuses: it admits
        only through :meth:`admit_migrated`."""
        prompt = np.asarray(request.prompt, np.int64)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError(f"prompt must be a non-empty 1-D token array, "
                             f"got shape {prompt.shape}")
        vocab = self.model_config.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            # an id out of range would index the embedding out of bounds
            # inside a graph, which ends the process's CUDA context
            raise ValueError(f"prompt token ids must lie in [0, {vocab})")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {request.max_new_tokens}")
        if request.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {request.temperature}")
        if request.temperature > 0.0 and request.rng is None:
            raise ValueError("sampled requests (temperature > 0) must carry rng")
        if request.rid in self._results and not self._results[request.rid].done:
            raise ValueError(f"request id {request.rid!r} already in flight")
        try:
            spec = self.tenants.get(request.tenant)
        except KeyError as exc:
            raise ValueError(str(exc)) from None
        ec = self.engine_config
        if ec.pool_role == "decode":
            raise RuntimeError(
                "a decode-role pool admits only through admit_migrated() "
                "— submit to the DisaggRouter (or the prefill pool)")
        plan, cover = plan_prefill_chunks(
            prompt.size, ec.prefill_chunk, ec.max_request_len)
        total_rows = max(cover, prompt.size + request.max_new_tokens)
        if total_rows > ec.max_request_len:
            raise ValueError(
                f"request {request.rid!r}: prompt {prompt.size} + "
                f"max_new_tokens {request.max_new_tokens} needs "
                f"{total_rows} cache rows, over max_request_len "
                f"{ec.max_request_len}"
            )
        needed = self.allocator.blocks_for_tokens(
            self._lifetime_rows(prompt.size, request.max_new_tokens, cover))
        if needed > self.allocator.num_blocks - 1:
            raise BlockExhausted(
                f"request {request.rid!r} needs {needed} blocks but the "
                f"pool only has {self.allocator.num_blocks - 1} — it can "
                f"NEVER be admitted (grow num_blocks or shrink the request)"
            )
        if spec.kv_block_quota is not None and needed > spec.kv_block_quota:
            raise QuotaExceeded(
                f"request {request.rid!r} needs {needed} blocks but "
                f"tenant {spec.name!r}'s quota is {spec.kv_block_quota} "
                f"— it can NEVER be admitted (raise the quota or shrink "
                f"the request)"
            )
        result = RequestResult(rid=request.rid, prompt_len=prompt.size,
                               submitted_at=time.monotonic())
        self._results[request.rid] = result
        self._queue.push(request.tenant, _Pending(
            rid=request.rid, tenant=request.tenant, prompt=prompt,
            max_new=request.max_new_tokens,
            temperature=request.temperature, plan=plan, needed=needed,
            rng=request.rng))
        return result

    def admit_migrated(
        self, *,
        rid: str,
        tenant: str,
        prompt: np.ndarray,
        first_token: int,
        max_new: int,
        temperature: float,
        step_seeds: np.ndarray,
        payloads: List[bytes],
        result: RequestResult,
        emitted_prefix: List[int],
        last_token_at: Optional[float],
        hint: Optional[List[int]] = None,
    ) -> bool:
        """Admit a request that finished prefill in ANOTHER pool: the
        disaggregated router's decode-side entry point.  Every migrated
        wire frame is crc-checked before anything is reserved; then the
        full decode lifetime's blocks are reserved, each frame uploads
        through the captured ``upload`` program (pipelined: the copy-in
        overlaps the in-flight decode dispatch), and the slot is built as
        :meth:`_finish_prefill` would leave it: ``length`` is the prompt,
        ``generated`` the prefill pool's first token, the seed schedule
        continues at ``step_seeds[0]``, and the drafter's window is
        ``prompt + [first_token]`` with the prefill side's trie hint —
        so every later emission equals the monolithic engine's.

        Returns False (reserving nothing) when no slot is free or the
        reservation cannot be funded; the router keeps the ticket and
        retries (or preempts).  Raises :class:`WireCorruption` on a
        rotted frame, with nothing reserved."""
        ec = self.engine_config
        if ec.pool_role == "prefill":
            raise RuntimeError(
                "a prefill-role pool cannot admit migrated requests")
        spec = self.tenants.get(tenant)
        slot = next((s for s in self._slots if s.state == "free"), None)
        if slot is None:
            return False
        prompt = np.asarray(prompt, np.int64)
        needed = self.allocator.blocks_for_tokens(prompt.size + max_new)
        if len(payloads) > needed:
            raise ValueError(
                f"migrated chain has {len(payloads)} blocks but the "
                f"decode lifetime only spans {needed}")
        try:
            frames = [unpack_block(p) for p in payloads]
        except WireCorruption:
            self.tier_corrupt_blocks += 1
            raise
        shape = self.pool.k.shape
        slab = shape[:1] + shape[2:]
        for _, k_slab, _ in frames:
            if k_slab.shape != slab or k_slab.dtype != self.pool.k.dtype:
                raise ValueError(
                    f"migrated block {tuple(k_slab.shape)}/{k_slab.dtype} "
                    f"does not fit this pool's {tuple(slab)}/"
                    f"{self.pool.k.dtype} blocks")
        evict_first = (set(self.tenants.opportunistic())
                       if spec.is_guarantee else None)
        try:
            blocks = self.allocator.reserve(
                needed, rid, tenant=spec.name, quota=spec.kv_block_quota,
                evict_tenants_first=evict_first)
        except (BlockExhausted, QuotaExceeded):
            return False
        for (_, k_slab, v_slab), dst in zip(frames, blocks):
            self._upload(dst, k_slab, v_slab)
        slot.state = "decode"
        slot.rid = rid
        slot.tenant = spec.name
        slot.blocks = list(blocks)
        slot.table[:] = 0
        slot.table[: len(blocks)] = blocks
        slot.length = prompt.size
        slot.generated = [int(first_token)]
        slot.emitted_prefix = list(emitted_prefix)
        slot.last_token_at = last_token_at
        slot.prompt = prompt
        slot.plan = []
        slot.max_new = max_new
        slot.temperature = temperature
        slot.first_seed = 0  # consumed by the prefill pool's pick
        slot.step_seeds = np.asarray(step_seeds, np.int64).reshape(-1)
        slot.result = result
        self._results[rid] = result
        if ec.speculative:
            slot.drafter = NGramDrafter(ec.draft_ngram, prompt)
            if hint:
                slot.drafter.hint(hint)
            slot.drafter.extend([int(first_token)])
            slot.draft_width = min(ec.draft_len, self._draft_width_cap)
            slot.accept_rate = 0.5
        self.peak_blocks_in_use = max(
            self.peak_blocks_in_use, self.allocator.blocks_in_use)
        return True

    def step(self) -> bool:
        """One scheduling iteration: admit what fits, consume the
        previous dispatch's results, PLAN the next step, then dispatch
        it.  Admission (host work) runs before the previous dispatch's
        results are read, so on an unguarded engine it overlaps the
        device.  Returns False when the engine is fully idle.  Every
        phase is wall-timed into ``host_seconds``; the autotuner ticks
        between consume and plan, in its own "tune" phase."""
        if self.fault_clock is not None:
            # chaos seam: a planned kill raises ReplicaKilled HERE, before
            # any host state of this step mutates
            self.fault_clock.on_engine_step(self)
        hs = self.host_seconds
        t0 = time.monotonic()
        self._admit()
        t1 = time.monotonic()
        consumed = self._consume_inflight()
        t2 = time.monotonic()
        if self._tuner is not None:
            self._tuner.tick()
            t2t = time.monotonic()
        else:
            t2t = t2  # no tuner: the "tune" phase stays exactly zero
        plan = self._plan_step()
        t3 = time.monotonic()
        hs["admit"] += t1 - t0
        hs["consume"] += t2 - t1
        hs["tune"] += t2t - t2
        hs["plan"] += t3 - t2t
        if plan is None:
            return consumed
        self._dispatch_plan(plan)
        hs["dispatch"] += time.monotonic() - t3
        return True

    def _plan_step(self) -> Optional[_StepPlan]:
        """The scheduling decision.  When prefill and decode work coexist
        (and ``mixed`` is on) ONE fused dispatch advances every decode
        lane AND consumes one budget-bounded prefill chunk; with
        ``mixed`` off, prefill has strict priority.  Filling slots rotate
        round-robin.  The decode phase is the span, a verify chunk or a
        device loop (:meth:`_plan_decode_phase`)."""
        self.host_planner_invocations += 1
        prefill = [s for s in self._slots if s.state == "prefill"]
        decode = [s for s in self._slots if s.state == "decode"]
        ec = self.engine_config
        if prefill and decode and ec.mixed:
            slot = self._next_prefill_slot(prefill)
            chunk = self._sliced_chunk(slot)
            if chunk[1] > self._mixed_budget:
                # an unsliceable pad-forward tail over the budget: the one
                # shape that still stalls decode, for a single dispatch
                return _StepPlan("prefill", prefill_slot=slot, chunk=chunk)
            plan = self._plan_decode_phase(decode, fused=True)
            plan.kind = ("mixed_verify" if plan.kind == "verify"
                         else "mixed")
            plan.prefill_slot, plan.chunk = slot, chunk
            return plan
        if prefill:
            slot = self._next_prefill_slot(prefill)
            return _StepPlan("prefill", prefill_slot=slot,
                             chunk=slot.plan.pop(0))
        if decode:
            return self._plan_decode_phase(decode)
        return None

    def _plan_decode_phase(self, decode: List[_Slot],
                           fused: bool = False) -> _StepPlan:
        """The decode phase's dispatch.  Speculative: when any lane
        drafted, every decode lane rides ONE verify chunk (a lane without
        a draft rides at width 1, a decode step); when nobody drafted, the
        span is better (it emits up to ``decode_span`` a dispatch).  With
        ``steps_per_launch > 1`` an unfused drafted step runs the
        speculative loop, which re-drafts on the device every unit (the
        host draft only arms it, so drafts stay scheduling-only), and an
        undrafted one the decode loop."""
        ec = self.engine_config
        # the EFFECTIVE depth: the autotuner may have lowered it
        looping = self._loop_k > 1 and not fused
        if ec.speculative:
            drafts = self._plan_drafts(decode)
            if drafts:
                if looping and self._spec_loops:
                    return _StepPlan("spec_loop", decode_slots=decode,
                                     drafts=drafts)
                # bucketed like prefill chunks (draft_len is a power of
                # two), so ragged drafts hit warmed verify widths
                width = 1 + bucket_width(
                    max(len(d) for d in drafts.values()), ec.draft_len)
                return _StepPlan("verify", decode_slots=decode,
                                 drafts=drafts, verify_width=width)
        return _StepPlan("loop" if looping else "decode", decode_slots=decode)

    def _plan_drafts(self, decode: List[_Slot]) -> Dict[int, List[int]]:
        """Each decode lane's proposal, at most ``min(adaptive width,
        remaining budget - 1)`` tokens: a round emits at most k + 1, so a
        wider draft would only write dead K/V rows."""
        drafts: Dict[int, List[int]] = {}
        for slot in decode:
            k = min(slot.draft_width, slot.max_new - len(slot.generated) - 1)
            if k < 1:
                continue
            proposal = slot.drafter.propose(k)
            if proposal:
                drafts[slot.idx] = proposal
        return drafts

    def _dispatch_plan(self, plan: _StepPlan) -> None:
        self.last_launch_units = (self._loop_k
                                  if plan.kind in ("loop", "spec_loop")
                                  else 1)
        if plan.kind == "mixed":
            self._run_mixed_step(plan.decode_slots, plan.prefill_slot,
                                 plan.chunk)
        elif plan.kind == "mixed_verify":
            self._run_mixed_verify_step(plan)
        elif plan.kind == "prefill":
            self._run_prefill_chunk(plan.prefill_slot, plan.chunk)
        elif plan.kind == "verify":
            self._run_verify_step(plan)
        elif plan.kind == "spec_loop":
            self._run_spec_loop_step(plan)
        elif plan.kind == "loop":
            self._run_loop_step(plan.decode_slots)
        else:
            self._run_decode_step(plan.decode_slots)

    def run(self) -> Dict[str, RequestResult]:
        """Drain the queue and every in-flight slot; returns results by
        request id."""
        try:
            while self.step():
                pass
        finally:
            if self.guard is not None:
                self.guard.finish()
        return dict(self._results)

    @property
    def idle(self) -> bool:
        return (not self._queue and self._inflight is None
                and not self._ring_staged
                and all(s.state == "free" for s in self._slots))

    def result(self, rid: str) -> RequestResult:
        return self._results[rid]

    def pop_finished(self) -> Dict[str, RequestResult]:
        """Remove and return every completed result — the eviction point
        of a caller driving :meth:`step` forever, whose result map would
        otherwise grow with every request served."""
        done = {rid: r for rid, r in self._results.items() if r.done}
        for rid in done:
            del self._results[rid]
        return done

    def prefix_match_len(self, tokens) -> int:
        """Tokens of ``tokens`` this engine's radix trie covers (device or
        tier) — 0 when prefix caching is off.  Read-only."""
        if self.prefix_index is None:
            return 0
        return self.prefix_index.match_len(tokens)

    def load_probe(self) -> Dict[str, int]:
        """A cheap load snapshot for routing: queue depth, free slots and
        allocatable blocks (free + cached-idle).  Read-only."""
        return {
            "queue_depth": len(self._queue),
            "free_slots": sum(1 for s in self._slots if s.state == "free"),
            "free_blocks": (self.allocator.free_blocks
                            + self.allocator.cached_idle_blocks),
        }

    def _verify_ks(self) -> List[int]:
        """Every draft width the adaptive controller can reach: powers of
        two from 1 up to ``draft_len`` (the verify chunk is 1 + k wide)."""
        ks, k = [], 1
        while k <= self.engine_config.draft_len:
            ks.append(k)
            k *= 2
        return ks

    def warmup(self) -> None:
        """Build (on the card: capture) every program the engine can
        dispatch: one prefill chunk per bucketed width, one MIXED shape
        per width within the fused budget (a sliced chunk is always a
        power-of-two piece at or under it), the decode span, the loop
        (``steps_per_launch > 1``) and the copy-on-write copy (prefix
        cache on).  Speculative adds one verify chunk per reachable draft
        width, the mixed-verify cross product with the fused prefill
        widths, and the speculative loop.  A KV tier adds the upload.  A
        prefill-role pool captures no decode shape; a decode-role pool no
        prefill chunk and no copy, but the upload its migrations arrive
        through.  Under autotune every fused width and every loop depth up to
        ``steps_per_launch`` is captured, so a retuned knob only selects
        among captured shapes.  Every warm-up pass and capture runs on
        all-zero inputs (no lane active, every table at the scratch block),
        which write only the scratch block.  After this, serving captures
        nothing new (:meth:`capture_counts` stays fixed)."""
        ec = self.engine_config
        verify_widths = ([1 + k for k in self._verify_ks()]
                         if ec.speculative else [])
        for width in sorted(self._warmed_widths):
            self._program("prefill", width)
            if ec.mixed and (ec.autotune or width <= self._mixed_budget):
                self._program("mixed", width)
                for w in verify_widths:
                    self._program("mixed_verify", width, w)
        if ec.pool_role != "prefill":
            self._program("decode")
            for w in verify_widths:
                self._program("verify", 0, w)
        for k_depth in sorted(self._loop_steps):
            self._program("loop", k_depth)
        for k_depth in sorted(self._spec_loops):
            self._program("spec_loop", k_depth)
        if self.prefix_index is not None and ec.pool_role != "decode":
            self._program("copy")
        if self.host_tier is not None or ec.pool_role == "decode":
            self._program("upload")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def capture_counts(self) -> Dict[str, int]:
        """Programs built per dispatch kind (the JAX engine's
        ``compile_counts`` keys); on the card each one is one captured
        CUDA graph — the zero-new-captures assertion's raw data."""
        counts = {kind: 0 for kind in DISPATCH_KINDS}
        for kind, _, _ in self._programs:
            counts[kind] += 1
        return counts

    def dispatch_device_ms(self) -> Dict[str, Tuple[int, float]]:
        """(dispatches, device ms) by kind from CUDA events around each
        dispatch's input copy and replay; waits for the device.  On the
        CPU there are no events and every entry reads (n, 0.0)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._drain_timings()
        return {kind: (self.device_dispatches[kind], self.device_ms[kind])
                for kind in DISPATCH_KINDS}

    # ------------------------------------------------------------------
    # metrics (the collector-plane scrape surface)
    # ------------------------------------------------------------------
    def collect_metrics(self) -> List[MetricFamily]:
        """Serving-plane runtime metrics in Prometheus exposition form,
        the JAX engine's families for the ported features."""
        req = MetricFamily(
            "kubeshare_serving_requests_total",
            "Requests by lifecycle stage.", "counter")
        req.add({"stage": "admitted"}, self.requests_admitted)
        req.add({"stage": "finished"}, self.requests_finished)
        blocks = MetricFamily(
            "kubeshare_serving_kv_blocks",
            "KV pool blocks by state (in_use counts refcounted blocks; "
            "cached are idle prefix-cache blocks, evictable on demand).",
            "gauge")
        blocks.add({"state": "in_use"}, self.allocator.blocks_in_use)
        blocks.add({"state": "free"}, self.allocator.free_blocks)
        blocks.add({"state": "cached"}, self.allocator.cached_idle_blocks)
        tokens = MetricFamily(
            "kubeshare_serving_tokens_generated_total",
            "Tokens emitted across all requests.", "counter")
        tokens.add({}, self.tokens_generated)
        # a disaggregated pool labels its latency and dispatch families
        # with its `pool`, a tensor-parallel engine with its `tp` (the
        # group's size), a fleet replica with its `replica`; a monolithic
        # single-device engine adds no label
        plabel = {"pool": self.pool_label} if self.pool_label else {}
        if self._sharded is not None:
            plabel["tp"] = str(self._sharded.tp)
        if self.replica_label:
            plabel["replica"] = self.replica_label
        dispatches = MetricFamily(
            "kubeshare_serving_dispatches_total",
            "Device dispatches by kind (mixed = one fused prefill chunk + "
            "decode span, mixed_verify = prefill chunk + verify chunk, "
            "loop / spec_loop = one device-resident multi-unit launch; the "
            "standalone kinds exclude fused work).", "counter")
        dispatches.add({"kind": "prefill_chunk", **plabel},
                       self.prefill_chunks - self.mixed_steps
                       - self.mixed_verify_steps)
        dispatches.add({"kind": "decode_span", **plabel},
                       self.decode_steps - self.mixed_steps - self.loop_units)
        dispatches.add({"kind": "mixed", **plabel}, self.mixed_steps)
        dispatches.add({"kind": "verify_span", **plabel},
                       self.verify_steps - self.mixed_verify_steps
                       - self.spec_loop_units)
        dispatches.add({"kind": "mixed_verify", **plabel},
                       self.mixed_verify_steps)
        dispatches.add({"kind": "loop", **plabel}, self.loop_launches)
        dispatches.add({"kind": "spec_loop", **plabel},
                       self.spec_loop_launches)
        dispatches.add({"kind": "cow_copy", **plabel}, self.cow_copies)
        loop_units = MetricFamily(
            "kubeshare_serving_loop_units_total",
            "Decode span-units executed inside device-resident loop "
            "launches.", "counter")
        loop_units.add(dict(plabel), self.loop_units)
        spec_loop_units = MetricFamily(
            "kubeshare_serving_spec_loop_units_total",
            "Draft-verify units executed inside speculative device-loop "
            "launches (each absorbed into verify_steps).", "counter")
        spec_loop_units.add(dict(plabel), self.spec_loop_units)
        exit_reason = MetricFamily(
            "kubeshare_serving_loop_exit_reason_total",
            "Device-resident loop launches by exit reason (both loop "
            "kinds): retire = a lane exhausted its budget unrefilled, "
            "stop = a lane hit EOS unrefilled, budget = all K units ran, "
            "redraft = in-loop acceptance collapsed below the re-draft "
            "threshold, ring_empty = a lane died with the admission ring "
            "configured but drained.", "counter")
        for reason in sorted(self.loop_exit_reasons):
            exit_reason.add({"reason": reason, **plabel},
                            self.loop_exit_reasons[reason])
        depth_summary = MetricFamily(
            "kubeshare_serving_loop_realized_depth",
            "Realized fusion depth per device-loop launch.", "summary")
        depth_summary.samples.append(Sample(
            "kubeshare_serving_loop_realized_depth_sum", dict(plabel),
            self.loop_depth_sum))
        depth_summary.samples.append(Sample(
            "kubeshare_serving_loop_realized_depth_count", dict(plabel),
            self.loop_depth_count))
        host_s = MetricFamily(
            "kubeshare_serving_host_seconds_total",
            "Host wall seconds inside the engine's step loop, by "
            "scheduling phase.", "counter")
        for phase in sorted(self.host_seconds):
            host_s.add({"phase": phase, **plabel}, self.host_seconds[phase])
        planner = MetricFamily(
            "kubeshare_serving_host_planner_invocations_total",
            "Scheduler planner invocations (_plan_step calls).", "counter")
        planner.add(dict(plabel), self.host_planner_invocations)
        prefix = MetricFamily(
            "kubeshare_serving_prefix_cache_requests_total",
            "Admitted requests by prefix-cache outcome.", "counter")
        hits = self.prefix_hit_requests
        prefix.add({"result": "hit"}, hits)
        prefix.add({"result": "miss"}, self.requests_admitted - hits)
        hit_tokens = MetricFamily(
            "kubeshare_serving_prefix_hit_tokens_total",
            "Prompt tokens whose prefill was skipped via the prefix "
            "cache.", "counter")
        hit_tokens.add({}, self.prefix_hit_tokens)
        evicted = MetricFamily(
            "kubeshare_serving_prefix_evicted_blocks_total",
            "Cached blocks evicted to fund reservations, by reason "
            "(reservation_pressure / quota_drain name the trigger when "
            "the K/V is destroyed; tier_demote / tier_drop name the "
            "host tier's verdict when tiering is on).", "counter")
        for reason in sorted(self.evictions_by_reason):
            evicted.add({"reason": reason},
                        self.evictions_by_reason[reason])
        tier_families = self._tier_metric_families()
        ttft = MetricFamily(
            "kubeshare_serving_ttft_seconds",
            "Time to first token (submit to first emitted token).",
            "histogram")
        _histogram_samples(ttft, "kubeshare_serving_ttft_seconds",
                           dict(plabel), self._ttft_counts, self._ttft_sum)
        t_depth = MetricFamily(
            "kubeshare_serving_tenant_queue_depth",
            "Queued (unadmitted) requests per tenant.", "gauge")
        for name, depth in self._queue.depths().items():
            t_depth.add({"tenant": name}, depth)
        t_blocks = MetricFamily(
            "kubeshare_serving_tenant_kv_blocks",
            "KV pool blocks charged per tenant (in-use + idle-cached).",
            "gauge")
        usage = self.allocator.usage_by_tenant
        for name in self.tenants.names():
            t_blocks.add({"tenant": name}, usage.get(name, 0))
        t_tokens = MetricFamily(
            "kubeshare_serving_tenant_tokens_total",
            "Tokens emitted per tenant.", "counter")
        for name in self.tenants.names():
            t_tokens.add({"tenant": name}, self.tenant_tokens.get(name, 0))
        preempt = MetricFamily(
            "kubeshare_serving_preemptions_total",
            "Decode slots preempted, by victim tenant (the victim resumes "
            "via the prefix cache).", "counter")
        for name in self.tenants.names():
            preempt.add({"tenant": name}, self.preemptions.get(name, 0))
        cls_ttft = MetricFamily(
            "kubeshare_serving_ttft_by_class_seconds",
            "Time to first token by QoS class.", "histogram")
        for cls, (counts, total) in sorted(self._ttft_class.items()):
            _histogram_samples(
                cls_ttft, "kubeshare_serving_ttft_by_class_seconds",
                {"qos": cls, **plabel}, counts, total)
        tbt = MetricFamily(
            "kubeshare_serving_tbt_seconds",
            "Inter-token latency by QoS class: wall time between "
            "consecutive host-visible tokens of one request (a span's "
            "burst is attributed evenly across its tokens).", "histogram")
        for cls, (counts, total) in sorted(self._tbt_class.items()):
            _histogram_samples(
                tbt, "kubeshare_serving_tbt_seconds", {"qos": cls, **plabel},
                counts, total, TBT_BUCKETS)
        coll_bytes = MetricFamily(
            "kubeshare_serving_collective_bytes_total",
            "ESTIMATED fleet-total bytes moved by the collectives "
            "inside sharded dispatches, by kind (shard-shape model, "
            "not a transport measurement; all-zero on a single-device "
            "engine).", "counter")
        for kind in sorted(self.collective_bytes):
            coll_bytes.add({"kind": kind, **plabel},
                           self.collective_bytes[kind])
        spec_tokens = MetricFamily(
            "kubeshare_serving_spec_tokens_total",
            "Speculative decoding volume per tenant: drafted = proposal "
            "tokens scored by verify dispatches, accepted = drafted tokens "
            "that reached the stream (the correction pick is not "
            "counted).", "counter")
        for name in self.tenants.names():
            spec_tokens.add({"tenant": name, "kind": "drafted"},
                            self.spec_drafted.get(name, 0))
            spec_tokens.add({"tenant": name, "kind": "accepted"},
                            self.spec_accepted.get(name, 0))
        spec_accept = MetricFamily(
            "kubeshare_serving_spec_acceptance_ratio",
            "Per-verify-round draft acceptance rate (accepted prefix / "
            "drafted) by tenant.", "histogram")
        for name, (counts, total) in sorted(self._spec_accept.items()):
            _histogram_samples(
                spec_accept, "kubeshare_serving_spec_acceptance_ratio",
                {"tenant": name}, counts, total, SPEC_ACCEPT_BUCKETS)
        tuner = MetricFamily(
            "kubeshare_serving_tuner_decisions_total",
            "Autotuner knob decisions by knob and direction (up / down = "
            "an in-envelope value applied; rejected = the central sandbox "
            "refused an out-of-envelope proposal).  Empty with autotune "
            "off.", "counter")
        if self._tuner is not None:
            for (knob, direction), n in sorted(
                    self._tuner.decisions.items()):
                tuner.add({"knob": knob, "direction": direction, **plabel},
                          n)
        return [req, blocks, tokens, dispatches, loop_units,
                spec_loop_units, exit_reason, depth_summary, host_s,
                planner, prefix, hit_tokens, evicted, *tier_families, ttft,
                t_depth, t_blocks, t_tokens, preempt, cls_ttft, tbt,
                coll_bytes, spec_tokens, spec_accept, tuner]

    def serve_metrics(self, port: int = 0) -> MetricServer:
        """Start the textfile HTTP scrape endpoint (``/metrics`` and
        ``/kubeshare-serving``) over :meth:`collect_metrics`; returns the
        started server (its ``.port`` is the bound port — pass 0 for
        ephemeral; ``.stop()`` ends it)."""
        server = MetricServer(self.collect_metrics, port=port,
                              path="/kubeshare-serving")
        server.start()
        return server

    def _tier_metric_families(self) -> List[MetricFamily]:
        """The host and disk tiers' families, the JAX engine's."""
        host, disk = self.host_tier, self.disk_tier
        tier_blocks = MetricFamily(
            "kubeshare_serving_tier_blocks_total",
            "Host-tier block movement: demoted (device -> host), "
            "promoted (host -> device, private partial copies "
            "included), dropped (policy/budget refused the spill), "
            "host_evicted (host entries evicted for host-budget room).",
            "counter")
        tier_blocks.add({"event": "demoted"}, self.tier_demoted_blocks)
        tier_blocks.add({"event": "promoted"}, self.tier_promoted_blocks)
        tier_blocks.add({"event": "dropped"}, self.tier_dropped_blocks)
        tier_blocks.add({"event": "host_evicted"},
                        host.evicted_blocks if host is not None else 0)
        tier_req = MetricFamily(
            "kubeshare_serving_tier_requests_total",
            "Admitted requests by host-tier outcome (hit = at least "
            "one prompt block recovered from host RAM).", "counter")
        tier_req.add({"result": "hit"}, self.tier_hit_requests)
        tier_req.add({"result": "miss"},
                     self.requests_admitted - self.tier_hit_requests)
        tier_tokens = MetricFamily(
            "kubeshare_serving_tier_hit_tokens_total",
            "Prompt tokens recovered from host-resident blocks.",
            "counter")
        tier_tokens.add({}, self.tier_hit_tokens)
        tier_bytes = MetricFamily(
            "kubeshare_serving_tier_host_bytes",
            "Host-tier occupancy vs budget (serialized wire bytes).",
            "gauge")
        tier_bytes.add({"kind": "used"},
                       host.used_bytes if host is not None else 0)
        tier_bytes.add({"kind": "budget"},
                       host.budget_bytes if host is not None else 0)
        tier_stall = MetricFamily(
            "kubeshare_serving_tier_promotion_stall_seconds_total",
            "Host wall time staging promotions (validation, disk reads, "
            "upload enqueue; the device copy-in itself overlaps the "
            "pipelined dispatch on an unguarded engine).", "counter")
        tier_stall.add({}, self.tier_promotion_stall_s)
        tier_corrupt = MetricFamily(
            "kubeshare_serving_tier_corruptions_total",
            "Wire blocks that failed their v2 crc32 at consumption — "
            "each was dropped and re-prefilled, never attended into a "
            "stream.", "counter")
        tier_corrupt.add({}, self.tier_corrupt_blocks)
        tier_origin = MetricFamily(
            "kubeshare_serving_tier_hit_origin_requests_total",
            "Tier-hit admissions split by payload origin: local = this "
            "engine's own demotions, remote = at least one consumed "
            "payload arrived from another replica.", "counter")
        for org in ("local", "remote"):
            tier_origin.add({"origin": org},
                            self.tier_hit_requests_by_origin[org])
        disk_bytes = MetricFamily(
            "kubeshare_serving_disk_tier_bytes",
            "Disk-tier occupancy vs budget (serialized wire bytes live in "
            "the mmap arena; fragmentation can grow the file past used, "
            "never used past budget).", "gauge")
        disk_bytes.add({"kind": "used"},
                       disk.used_bytes if disk is not None else 0)
        disk_bytes.add({"kind": "budget"},
                       disk.budget_bytes if disk is not None else 0)
        disk_blocks = MetricFamily(
            "kubeshare_serving_disk_tier_blocks_total",
            "Disk-tier lifetime events: demoted = HOST→DISK cascades in, "
            "promoted = DISK→HOST stagings out, evicted = disk-budget LRU "
            "drops, refused = puts that found no room, corrupt_read = "
            "payloads whose crc32 failed after a disk read (dropped, "
            "re-prefilled cold).", "counter")
        events = (("demoted", "stored_blocks"), ("promoted", "promoted_blocks"),
                  ("evicted", "evicted_blocks"), ("refused", "refused_blocks"),
                  ("corrupt_read", "corrupt_reads"))
        for event, attr in events:
            disk_blocks.add({"event": event},
                            getattr(disk, attr) if disk is not None else 0)
        return [tier_blocks, tier_req, tier_tokens, tier_bytes, tier_stall,
                tier_corrupt, tier_origin, disk_bytes, disk_blocks]

    def _observe_ttft(self, seconds: float, tenant: str) -> None:
        self._ttft_sum += seconds
        cls = self._ttft_class[self.tenants.get(tenant).qos_class]
        cls[1] += seconds
        _bucket_observe(self._ttft_counts, seconds)
        _bucket_observe(cls[0], seconds)

    def _observe_tbt(self, per_token: float, count: int,
                     tenant: str) -> None:
        """Record ``count`` inter-token gaps of ``per_token`` seconds
        each (a span's tokens become host-visible in one burst)."""
        cls = self._tbt_class[self.tenants.get(tenant).qos_class]
        cls[1] += per_token * count
        _bucket_observe(cls[0], per_token, TBT_BUCKETS, count)

    # ------------------------------------------------------------------
    # KV tiering internals (kv_tier.py owns the stores; the engine owns the
    # glue between allocator eviction, the trie and the pool)
    # ------------------------------------------------------------------
    def _evict_blocks(self, victim: int, reason: str) -> List[int]:
        """The allocator's eviction callback.  Tiering off: detach the
        victim's subtree from the trie (its K/V is destroyed) and count the
        trigger.  Tiering on: walk the subtree through the TierPolicy — each
        node is DEMOTED (serialized into the host tier, its trie node kept
        HOST-resident) or DROPPED (subtree detached).  Either way every
        device block of the subtree returns to the allocator, which
        uncharges its tenant; promotion charges again.  Runs under the
        allocator's lock: no locking allocator method may be called."""
        if self.host_tier is None:
            removed = self.prefix_index.evict(victim)
            self.evictions_by_reason[reason] += len(removed)
            return removed
        released: List[int] = []
        # entries demoted within this walk stay pinned until it returns: the
        # walk goes parent-first, so a just-demoted ancestor transiently has
        # device children, and the tier must not evict it to fund them
        walk_pins: List[int] = []
        t0 = time.monotonic()
        try:
            self._tier_visit(self.prefix_index.node_of(victim), released,
                             walk_pins)
        finally:
            for k in walk_pins:
                self.host_tier.unpin(k)
            self.tier_demotion_s += time.monotonic() - t0
        return released

    def _read_blocks(self, blocks: List[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The K and V rows of pool ``blocks`` on the host, [len(blocks),
        n_layers, kv_heads, block_size, head_dim] each (every block's slab
        contiguous, ready to pack): one gather and one device-to-host copy
        per pool, into pinned memory on the card.  The copy is ordered on
        the stream after every dispatch that wrote the blocks, and it
        completes before the caller returns them to the allocator."""
        idx = torch.tensor(blocks, dtype=torch.int64, device=self.device)
        rows = []
        for pool in (self.pool.k, self.pool.v):
            gathered = pool.index_select(1, idx).transpose(0, 1)
            host = torch.empty(gathered.shape, dtype=gathered.dtype,
                               pin_memory=gathered.is_cuda)
            rows.append(host.copy_(gathered))
        return rows[0], rows[1]

    def _read_block_payload(self, node) -> bytes:
        """Serialize one device block's K/V rows and token run."""
        k, v = self._read_blocks([node.block])
        return pack_block(node.tokens, k[0], v[0])

    def _tier_visit(self, root, released: List[int],
                    walk_pins: List[int]) -> None:
        """Demote-or-drop every device-resident node in ``root``'s subtree,
        parent-first (host children are already spilled).  A dropped node
        takes its whole subtree with it.  Demoted keys are pinned into
        ``walk_pins`` (released by the caller).  The subtree's device
        blocks are read to the host in one copy first; each node is packed
        from it as the walk reaches it, the bytes a per-node read would
        give.  Iterative: subtree depth is bounded only by
        ``max_request_len / block_size``."""
        if root is None:
            return
        subtree, stack = [], [root]
        while stack:
            node = stack.pop()
            subtree.append(node.block)
            stack.extend(child for child in
                         list(node.children.values()) + node.partials
                         if child.block >= 0)
        k_rows, v_rows = self._read_blocks(subtree)
        column = {block: i for i, block in enumerate(subtree)}
        stack = [root]
        while stack:
            node = stack.pop()
            # under the allocator lock: read the charge ledger directly
            tenant = self.allocator._tenant_of.get(node.block)
            i = column[node.block]
            payload = pack_block(node.tokens, k_rows[i], v_rows[i])
            key = self.host_tier.put(payload, tenant, node)
            if key is None:
                device, host_keys, disk_keys = \
                    self.prefix_index.detach(node)
                for hk in host_keys:
                    self.host_tier.forget(hk)
                for dk in disk_keys:
                    self.disk_tier.forget(dk)
                released.extend(device)
                self.tier_dropped_blocks += len(device)
                self.evictions_by_reason["tier_drop"] += len(device)
                continue
            self.host_tier.pin(key)
            walk_pins.append(key)
            released.append(node.block)
            self.prefix_index.demote(node.block, key)
            self.tier_demoted_blocks += 1
            self.evictions_by_reason["tier_demote"] += 1
            if self.on_tier_demote is not None:
                self.on_tier_demote(node, payload, tenant)
            stack.extend(
                child
                for child in list(node.children.values()) + node.partials
                if child.block >= 0)

    def _spill_host_entry(self, entry) -> None:
        """HostTier's budget-eviction hook.  With a disk tier below, the
        evicted payload CASCADES (HOST→DISK): the bytes move into the mmap
        arena and the trie node becomes DISK-resident, still matchable.
        Without one (or when the disk refuses), the entry is destroyed."""
        if self.disk_tier is not None and entry.node is not None:
            dkey = self.disk_tier.put(entry.payload, entry.tenant,
                                      entry.node, origin=entry.origin)
            if dkey is not None:
                self.prefix_index.to_disk(entry.node, dkey)
                self.host_tier.forget(entry.key)
                return
        self._drop_host_entry(entry)

    def _drop_tier_subtree(self, entry, tier: str) -> None:
        """Detach a tier entry's trie node and its all-non-device subtree,
        purging every tier copy in it."""
        device, host_keys, disk_keys = self.prefix_index.detach(entry.node)
        if device:  # non-device-below-device invariant violated
            raise RuntimeError(
                f"{tier} entry {entry.key}'s subtree held device blocks "
                f"{device} — index/tier state diverged")
        for hk in host_keys:
            self.host_tier.forget(hk)
        for dk in disk_keys:
            self.disk_tier.forget(dk)

    def _drop_host_entry(self, entry) -> None:
        """Destroy a host entry with its trie subtree.  The corrupt-payload
        path calls this directly (rotted bytes must not be parked on
        disk)."""
        self._drop_tier_subtree(entry, "host")

    def _drop_disk_entry(self, entry) -> None:
        """DiskTier's budget-eviction hook: the end of the cascade."""
        self._drop_tier_subtree(entry, "disk")

    def _validate_host_hit(self, hit: _PrefixHit):
        """Unpack (and crc-check) every host payload ``hit`` will consume:
        ``{host_key: (tokens, k_slab, v_slab)}``, or None after dropping the
        corrupt entries (counted in ``tier_corrupt_blocks``), in which case
        the caller retries the admission cold.  Validation comes before any
        upload, so a corrupt middle block leaves no half-promoted slot."""
        slabs, bad = {}, []
        nodes = list(hit.promote)
        if hit.host_cow is not None:
            nodes.append(hit.host_cow)
        for node in nodes:
            entry = self.host_tier.probe(node.host_key)
            try:
                slabs[node.host_key] = unpack_block(entry.payload)
            except WireCorruption:
                bad.append(entry)
        if not bad:
            return slabs
        for entry in bad:
            self.tier_corrupt_blocks += 1
            if self.host_tier.probe(entry.key) is not None:
                # a corrupt ancestor's detach may already have cascaded
                # this entry out of the tier
                self._drop_host_entry(entry)
        return None

    def _match_prefix(self, pending: _Pending,
                      limit: Optional[int] = None) -> Optional[_PrefixHit]:
        """Admission-time prefix lookup for one queued request (None =
        cold).  The tier-aware walk may cross HOST- and DISK-resident nodes:
        device full matches map as shared blocks, tiered full matches become
        promotions (disk ones are staged to host first,
        :meth:`_stage_disk_hit`), and a partial tail match routes to the
        copy-on-write copy (device) or a private payload upload (tiered).
        The match is capped at prompt - 1 tokens, keeping one real token in
        the prefill plan (its logits row IS the first output token);
        ``limit`` caps it further (the disk-staging retry)."""
        ec = self.engine_config
        prompt = pending.prompt
        matched, chain = self.prefix_index.match_tiered(prompt)
        matched = min(matched, prompt.size - 1)
        if limit is not None:
            matched = min(matched, limit)
        if matched <= 0:
            return None
        chain = chain[: self.allocator.blocks_for_tokens(matched)]
        n_full = matched // ec.block_size
        partial = matched % ec.block_size
        shared: List[int] = []
        promote: List = []
        for node in chain[:n_full]:
            if node.block >= 0:
                if promote:  # non-device-ness is downward-closed
                    raise RuntimeError(
                        "device-resident node below a tiered one in a match "
                        "chain — index/tier state diverged")
                shared.append(node.block)
            else:
                promote.append(node)
        cow_src = host_cow = None
        if partial:
            tail = chain[n_full]
            if tail.block >= 0:
                cow_src = tail.block
            else:
                host_cow = tail
        plan, cover = plan_prefill_chunks(
            prompt.size, ec.prefill_chunk, ec.max_request_len, matched)
        total_rows = self._lifetime_rows(prompt.size, pending.max_new, cover)
        needed = self.allocator.blocks_for_tokens(total_rows) - len(shared)
        host_tokens = (len(promote) * ec.block_size
                       + (partial if host_cow is not None else 0))
        return _PrefixHit(matched, shared, cow_src, promote, host_cow,
                          plan, needed, host_tokens)

    def _stage_disk_hit(self, pending: _Pending) -> Optional[_PrefixHit]:
        """Match + DISK→HOST staging: re-home every disk-resident node the
        hit would consume into the host tier (read, crc-validate, put, pin)
        so the promotion path sees only host payloads.  A corrupt disk read
        drops the node's subtree and re-matches (a shorter or cold
        admission, never wrong tokens); a host tier that cannot take a
        staged payload truncates the match just before that block."""
        limit: Optional[int] = None
        staged_pins: List[int] = []
        try:
            hit = self._match_prefix(pending, limit)
            while hit is not None:
                nodes = list(hit.promote)
                if hit.host_cow is not None:
                    nodes.append(hit.host_cow)
                disk_nodes = [n for n in nodes if n.disk_key is not None]
                if not disk_nodes:
                    return hit
                # the hit's host-resident nodes stay pinned through the
                # staging too: a staged put must not spill them (to disk,
                # or out of the trie) from under the hit it belongs to
                for node in nodes:
                    if node.host_key is not None:
                        self.host_tier.pin(node.host_key)
                        staged_pins.append(node.host_key)
                t0 = time.monotonic()
                clean = True
                for node in disk_nodes:
                    dkey = node.disk_key
                    entry = self.disk_tier.probe(dkey)
                    payload = self.disk_tier.read(dkey)
                    try:
                        unpack_block(payload)
                    except WireCorruption:
                        self.disk_tier.corrupt_reads += 1
                        self.tier_corrupt_blocks += 1
                        self._drop_disk_entry(entry)
                        clean = False
                        break
                    hkey = self.host_tier.put(payload, entry.tenant, node,
                                              origin=entry.origin)
                    if hkey is None:
                        before = (len(self.prefix_index.path_tokens(node))
                                  - len(node.tokens))
                        limit = before if limit is None else min(limit,
                                                                 before)
                        clean = False
                        break
                    # pinned through the rest of staging: a later put must
                    # not cascade this one straight back to disk
                    self.host_tier.pin(hkey)
                    staged_pins.append(hkey)
                    self.prefix_index.stage_to_host(node, hkey)
                    self.disk_tier.forget(dkey)
                    self.disk_tier.promoted_blocks += 1
                self.tier_promotion_stall_s += time.monotonic() - t0
                if clean:
                    return hit
                hit = self._match_prefix(pending, limit)
            return None
        finally:
            # _try_admit re-pins what the hit consumes
            for k in staged_pins:
                self.host_tier.unpin(k)

    def _upload(self, dst: int, k_slab: torch.Tensor,
                v_slab: torch.Tensor) -> None:
        """Dispatch the upload program: one block's slabs into ``dst``,
        staged as raw words (a bf16 slab as int16, no float conversion)."""
        self._dispatch(self._program("upload"), {
            "dst": np.array([dst], np.int64),
            "k_slab": slab_words(k_slab)[1],
            "v_slab": slab_words(v_slab)[1]})

    def _admit(self) -> None:
        """QoS admission: walk tenants in fair-queue order (Guarantee
        class first, lowest decayed service/weight within a class) and
        pop each tenant's head into a free slot while the allocator can
        fund it.  Within a tenant head-of-line blocking is deliberate; a
        tenant blocked on its OWN quota is skipped so the rest keeps
        flowing.  A Guarantee head the POOL cannot fund preempts
        Opportunistic decode slots (cache-backed: see :meth:`_preempt`)
        until it fits or no victims remain.

        Ring-staged requests the speculative loop did not activate enter
        first, by a field copy into a free lane (they are admitted and
        prefilled already) — but not while a speculative loop is still in
        flight: its consume may yet activate them."""
        if self._ring_staged and (self._inflight is None
                                  or self._inflight[0] != "spec_loop"):
            for staged in list(self._ring_staged):
                slot = next((s for s in self._slots if s.state == "free"),
                            None)
                if slot is None:
                    break
                self._bind_staged(staged, slot)
                self._ring_staged.remove(staged)
        while True:
            if self.admission_gate is not None \
                    and not self.admission_gate():
                return
            order = self._queue.order()
            if not order:
                return
            progressed = False
            for tenant in order:
                spec = self.tenants.get(tenant)
                free = [s for s in self._slots if s.state == "free"]
                if not free:
                    # a head blocked on its OWN quota must not preempt (a
                    # victim's slot cannot cure a quota block)
                    if self._quota_blocked(self._queue.peek(tenant), spec):
                        continue
                    if spec.is_guarantee and self._preempt_victim():
                        free = [s for s in self._slots
                                if s.state == "free"]
                        progressed = True
                        if not free:
                            break
                    else:
                        return
                outcome = self._try_admit(self._queue.peek(tenant), spec,
                                          free[0])
                if outcome == "admitted":
                    self._queue.pop(tenant)
                    progressed = True
                    break
                if outcome == "quota":
                    continue  # this tenant's own limit; try the next
                # pool exhausted: Guarantee preempts, everyone else stops
                # here (admitting past a blocked head would invert the
                # fair order)
                if spec.is_guarantee and self._preempt_victim():
                    progressed = True
                    break
                return
            if not progressed:
                return

    def _bind_staged(self, staged: _Slot, slot: _Slot) -> None:
        """Bind one ring-staged (admitted + prefilled) request into an
        engine lane: a field copy — the allocator, results, counters and
        queue were charged when it passed :meth:`_try_admit` and its
        prefill."""
        for name in _Slot.__slots__:
            if name not in ("idx", "table"):
                setattr(slot, name, getattr(staged, name))
        slot.table[:] = staged.table

    def _quota_blocked(self, pending: _Pending, spec: TenantSpec) -> bool:
        """Would admitting ``pending`` fail on its tenant's OWN quota both
        ways _try_admit can attempt it (prefix hit AND cold)?
        Side-effect-free."""
        if spec.kv_block_quota is None:
            return False
        if self.allocator.quota_can_fit(
                pending.needed, spec.name, spec.kv_block_quota):
            return False  # the cold fallback fits
        if self.prefix_index is not None:
            hit = self._match_prefix(pending)
            if hit is not None and self.allocator.quota_can_fit(
                    hit.needed, spec.name, spec.kv_block_quota,
                    keep=hit.shared + ([hit.cow_src]
                                       if hit.cow_src is not None else [])):
                return False
        return True

    def _try_admit(self, pending: _Pending, spec: TenantSpec,
                   slot: _Slot) -> str:
        """Try to admit one queued request into ``slot``; returns
        "admitted", "quota" (the tenant's own cap — skippable), or "pool"
        (global shortfall).  A failed attempt rolls back every retained
        block."""
        plan, needed = pending.plan, pending.needed
        if self.prefix_index is None:
            hit = None
        elif self.disk_tier is not None:
            hit = self._stage_disk_hit(pending)
        else:
            hit = self._match_prefix(pending)
        if hit is not None:
            plan, needed = hit.plan, hit.needed
        evict_first = (set(self.tenants.opportunistic())
                       if spec.is_guarantee else None)
        while True:
            shared = hit.shared if hit is not None else []
            cow_src = hit.cow_src if hit is not None else None
            retained = shared + ([cow_src] if cow_src is not None else [])
            pinned: List[int] = []
            if hit is not None and self.host_tier is not None:
                # the reserve below may demote more blocks into the host
                # tier, whose budget eviction must not take the entries
                # this admission is about to promote
                pinned = [n.host_key for n in hit.promote]
                if hit.host_cow is not None:
                    pinned.append(hit.host_cow.host_key)
                for k in pinned:
                    self.host_tier.pin(k)
            if retained:
                self.allocator.retain(retained)
            try:
                blocks = self.allocator.reserve(
                    needed, pending.rid, tenant=spec.name,
                    quota=spec.kv_block_quota,
                    evict_tenants_first=evict_first)
                # every host payload is unpacked (and crc-checked) BEFORE
                # any of them uploads: a corrupt block is dropped from tier
                # and trie and the admission retries cold
                slabs = (self._validate_host_hit(hit)
                         if hit is not None
                         and (hit.promote or hit.host_cow is not None)
                         else {})
                if slabs is None:
                    for k in pinned:
                        self.host_tier.unpin(k)
                    self.allocator.reclaim(blocks)
                    if retained:
                        self.allocator.reclaim(retained)
                    hit = None
                    plan, needed = pending.plan, pending.needed
                    continue
                break
            except QuotaExceeded:
                for k in pinned:
                    self.host_tier.unpin(k)
                if retained:
                    self.allocator.reclaim(retained)
                if hit is not None:
                    # a prefix HIT can be quota-infeasible where a cold
                    # admission is not (the retained chain pins charged
                    # blocks the quota drain may not touch): retry cold
                    hit = None
                    plan, needed = pending.plan, pending.needed
                    continue
                return "quota"
            except BlockExhausted:
                for k in pinned:
                    self.host_tier.unpin(k)
                if retained:
                    self.allocator.reclaim(retained)
                return "pool"
        slot.state = "prefill"
        slot.rid = pending.rid
        slot.tenant = spec.name
        # table order: [device shared prefix | promoted tier blocks
        # (blocks[:n_promote], chain order) | CoW / tier-partial copy
        # (blocks[n_promote], when the match ends mid-block) | fresh
        # suffix blocks]
        n_promote = len(hit.promote) if hit is not None else 0
        slot.blocks = shared + blocks
        slot.table[:] = 0
        slot.table[: len(slot.blocks)] = slot.blocks
        slot.length = 0
        if n_promote or (hit is not None and hit.host_cow is not None):
            self._promote(hit, blocks, slabs)
        for k in pinned:
            self.host_tier.unpin(k)
        if cow_src is not None:
            self._dispatch(self._program("copy"),
                           {"src": np.array([cow_src], np.int64),
                            "dst": np.array([blocks[n_promote]], np.int64)})
            self.allocator.reclaim([cow_src])  # transient read ref
            self.cow_copies += 1
        if hit is not None:
            # honest skip count: the bucketed tail may slide BELOW the
            # match point, re-prefilling cached rows
            skipped = min(hit.start, min(s for s, _, _ in plan))
            self.prefix_hit_requests += 1
            self.prefix_hit_tokens += skipped
        self.requests_admitted += 1
        slot.generated = []
        slot.emitted_prefix = list(pending.emitted)
        slot.last_token_at = pending.last_token_at
        slot.prompt = pending.prompt
        slot.plan = list(plan)
        slot.max_new = pending.max_new
        slot.temperature = pending.temperature
        if pending.first_seed is not None:
            # resumed after preemption: the remaining seed schedule rides
            # with the pending entry
            slot.first_seed = pending.first_seed
            slot.step_seeds = pending.step_seeds
        elif pending.temperature > 0.0:
            # sample_decode_with_cache's schedule: one seed per emission
            seeds = sampling_seeds(pending.rng, 1, pending.max_new)[0]
            seeds = seeds.cpu().numpy()
            slot.first_seed = int(seeds[0])
            slot.step_seeds = seeds[1:]
        else:
            slot.first_seed = 0
            slot.step_seeds = np.zeros((0,), np.int64)
        slot.result = self._results[pending.rid]
        if slot.result.admitted_at is None:
            slot.result.admitted_at = time.monotonic()
        ec = self.engine_config
        if ec.speculative:
            # the lookup window starts as the prompt (for a resumed
            # request: prompt + generated, the window an unpreempted lane
            # would hold); the width starts at draft_len (under the tuned
            # cap) and the EMA of acceptance halves it on lanes whose
            # drafts miss
            slot.drafter = NGramDrafter(ec.draft_ngram, pending.prompt)
            slot.draft_width = min(ec.draft_len, self._draft_width_cap)
            slot.accept_rate = 0.5
            if self.prefix_index is not None:
                # a cache hit's trie continuation is a second window: a
                # previous request's generation predicts a re-run's
                cont = self.prefix_index.continuation(pending.prompt,
                                                      4 * ec.draft_len)
                if cont:
                    slot.drafter.hint(list(pending.prompt) + cont)
        self.peak_blocks_in_use = max(
            self.peak_blocks_in_use, self.allocator.blocks_in_use)
        return "admitted"

    def _promote(self, hit: _PrefixHit, blocks: List[int],
                 slabs: Dict) -> None:
        """PROMOTION: the hit's host payloads back into the leading fresh
        blocks, each one dispatch of the upload program through the
        pipelined path (on an unguarded engine the copy-in overlaps the
        in-flight dispatch).  A partial host match uploads straight into
        the request's private tail block and leaves its entry host-side."""
        t0 = time.monotonic()
        n_promote = len(hit.promote)
        tail = [hit.host_cow] if hit.host_cow is not None else []
        # a hit is "remote" when any payload it consumes came from another
        # replica (probe before the takes below surrender the entries)
        origin = "local"
        for node in hit.promote + tail:
            entry = self.host_tier.probe(node.host_key)
            if entry is not None and entry.origin == "remote":
                origin = "remote"
                break
        for node, dst in zip(hit.promote, blocks[:n_promote]):
            self.host_tier.take(node.host_key)
            _, k_slab, v_slab = slabs[node.host_key]
            self._upload(dst, k_slab, v_slab)
            self.prefix_index.promote(node, dst)
        if n_promote:
            # trie-referenced again: park idle-cached at release, like any
            # indexed block (the reserve already charged them)
            self.allocator.mark_cached(blocks[:n_promote])
        if tail:
            entry = self.host_tier.peek(hit.host_cow.host_key)
            _, k_slab, v_slab = slabs[hit.host_cow.host_key]
            self._upload(blocks[n_promote], k_slab, v_slab)
            # peek leaves the entry host-side: meter the copy-out here
            self.host_tier.meter(entry.nbytes, "promote")
        self.tier_promoted_blocks += n_promote + len(tail)
        self.tier_promotion_stall_s += time.monotonic() - t0
        self.tier_hit_requests += 1
        self.tier_hit_requests_by_origin[origin] += 1
        self.tier_hit_tokens += hit.host_tokens

    def _preempt_victim(self) -> bool:
        """Pick and preempt one Opportunistic DECODE slot for a starved
        Guarantee admission; returns False when none exists.  The slot
        holding the most blocks goes (highest index breaks ties).  The
        in-flight dispatch is consumed first: it may already have retired
        slots or advanced the would-be victim."""
        if self._consume_inflight():
            return True
        victims = [
            s for s in self._slots
            if s.state == "decode"
            and not self.tenants.get(s.tenant).is_guarantee]
        if not victims:
            return False
        self._preempt(max(victims, key=lambda s: (len(s.blocks), s.idx)))
        return True

    def _preempt(self, slot: _Slot) -> None:
        """Cache-backed preemption: retire the victim's prompt AND
        generated blocks into the prefix index, free its slot, and
        re-queue the remainder at the front of its tenant's lane.  The
        cache holds ``prompt + generated[:-1]``; the resume prompt is
        ``prompt + generated``, so re-admission restarts prefill at its
        last token, and the remaining seed schedule rides along (emission
        k of the original consumes ``step_seeds[k-1]``)."""
        done = len(slot.generated)  # >= 1 in decode state
        if self.prefix_index is not None:
            cached_seq = np.concatenate(
                [slot.prompt, np.asarray(slot.generated[:-1], np.int64)])
            n_cached = self.allocator.blocks_for_tokens(slot.length)
            cached_blocks = [int(b) for b in slot.table[:n_cached]]
            newly_cached, displaced = self.prefix_index.insert(
                cached_seq, cached_blocks)
            self.allocator.mark_cached(newly_cached)
            for b in displaced:
                self.allocator.uncache(b)
        # tail-first: idle-LRU eviction then shaves the chain's deepest
        # block before its head
        self.allocator.reclaim(slot.blocks[::-1])
        ec = self.engine_config
        resume_prompt = np.concatenate(
            [slot.prompt, np.asarray(slot.generated, np.int64)])
        remaining = slot.max_new - done
        plan, cover = plan_prefill_chunks(
            resume_prompt.size, ec.prefill_chunk, ec.max_request_len)
        needed = self.allocator.blocks_for_tokens(
            max(cover, resume_prompt.size + remaining))
        if slot.temperature > 0.0:
            first_seed = int(slot.step_seeds[done - 1])
            step_seeds = np.asarray(slot.step_seeds[done:])
        else:
            first_seed = 0
            step_seeds = np.zeros((0,), np.int64)
        pending = _Pending(
            rid=slot.rid, tenant=slot.tenant, prompt=resume_prompt,
            max_new=remaining, temperature=slot.temperature,
            plan=plan, needed=needed, first_seed=first_seed,
            step_seeds=step_seeds,
            emitted=slot.emitted_prefix + slot.generated,
            last_token_at=slot.last_token_at)
        if self.on_preempt_requeue is not None:
            # disaggregated: the resume re-prefills in the PREFILL pool,
            # whose router re-plans the entry with that pool's geometry
            self.on_preempt_requeue(slot.tenant, pending)
        else:
            self._queue.requeue_front(slot.tenant, pending)
        self.preemptions[slot.tenant] = \
            self.preemptions.get(slot.tenant, 0) + 1
        slot._clear()
        slot.state = "free"

    def _dispatch(self, program: _Program, values: Dict[str, np.ndarray]):
        """Run one program.  With a guard attached, every dispatch
        acquires, waits for the device and charges its wall time (the
        token-gated shape of the run-to-completion path); unguarded, the
        dispatch stays asynchronous and its results are read one step
        later (:meth:`_consume_inflight`)."""
        if self.fault_clock is not None:
            # chaos seam: a planned slow dispatch advances the fault
            # clock's virtual time here
            self.fault_clock.on_dispatch(self)
        if self.guard is None:
            return self._launch(program, values)
        self.guard.acquire()
        start = time.monotonic()
        try:
            out = self._launch(program, values)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        finally:
            self.guard.charge((time.monotonic() - start) * 1e3)
        return out

    def _launch(self, program: _Program, values: Dict[str, np.ndarray]):
        if self.device.type != "cuda":
            self.device_dispatches[program.kind] += 1
            return program.run(values)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = program.run(values)
        end.record()
        self._timings.append((program.kind, start, end))
        self.last_dispatch_event = end
        return out

    def _drain_timings(self) -> None:
        """Fold the timing events of completed dispatches into
        ``device_ms``."""
        pending = []
        for kind, start, end in self._timings:
            if end.query():
                self.device_ms[kind] += start.elapsed_time(end)
                self.device_dispatches[kind] += 1
            else:
                pending.append((kind, start, end))
        self._timings = pending

    def _next_prefill_slot(self, prefill: List[_Slot]) -> _Slot:
        """Round-robin over filling slots."""
        chosen = min(prefill, key=lambda s:
                     (s.idx - self._prefill_rr) % len(self._slots))
        self._prefill_rr = (chosen.idx + 1) % len(self._slots)
        return chosen

    def _sliced_chunk(self, slot: _Slot) -> Tuple[int, int, int]:
        """Pop the slot's next prefill chunk for a mixed dispatch, sliced
        to the fused budget: a wider chunk yields its leading
        largest-power-of-two piece <= budget and the remainder re-enters
        the plan head as power-of-two chunks, widest first (every piece a
        warmed bucket width).  A pad-forward chunk (its logits row inside
        the chunk) is returned whole."""
        start, width, last_row = slot.plan.pop(0)
        budget = self._mixed_budget
        if width <= budget or last_row != width - 1:
            return (start, width, last_row)
        piece = 1 << (budget.bit_length() - 1)
        rest, offset, rem = [], start + piece, width - piece
        while rem:
            w = 1 << (rem.bit_length() - 1)
            rest.append((offset, w, w - 1))
            offset += w
            rem -= w
        slot.plan[:0] = rest
        return (start, piece, piece - 1)

    def _prefill_lane(self, slot: _Slot, chunk: Tuple[int, int, int]):
        """(final, inputs) for one slot's prefill chunk — shared by the
        standalone and the mixed dispatch."""
        start, width, last_row = chunk
        final = not slot.plan
        segment = slot.prompt[start: start + width]
        if segment.size < width:  # short-prompt pad tail (dead rows)
            segment = np.pad(segment, (0, width - segment.size))
        return final, {
            "p_table": slot.table[None],
            "p_start": np.array([start], np.int64),
            "p_tokens": segment[None],
            "p_last_row": np.array([last_row], np.int64),
            # the pick is consumed only on the prompt's final chunk
            "p_temp": np.array([slot.temperature if final else 0.0],
                               np.float32),
            "p_seed": np.array([slot.first_seed if final else 0], np.int64),
        }

    def _decode_lanes(self, decode_slots: List[_Slot],
                      n_steps: Optional[int] = None):
        """Device inputs for a decode span over the slot pool — shared by
        the standalone, the mixed, and (``n_steps`` = K*span) the loop
        dispatch.  The seed window is sliced flat: a K-unit loop consumes
        exactly the seeds K back-to-back spans would."""
        ec = self.engine_config
        s = ec.num_slots
        steps = ec.decode_span if n_steps is None else n_steps
        lanes = {
            "tables": np.zeros((s, self._table_width), np.int64),
            "lengths": np.zeros((s,), np.int64),
            "active": np.zeros((s,), bool),
            "tokens": np.zeros((s,), np.int64),
            "temps": np.zeros((s,), np.float32),
            "seeds": np.zeros((s, steps), np.int64),
            "budgets": np.zeros((s,), np.int64),
        }
        for slot in decode_slots:
            i = slot.idx
            lanes["tables"][i] = slot.table
            lanes["lengths"][i] = slot.length
            lanes["active"][i] = True
            lanes["tokens"][i] = slot.generated[-1]
            lanes["temps"][i] = slot.temperature
            lanes["budgets"][i] = slot.max_new - len(slot.generated)
            lanes["seeds"][i] = self._seed_window(slot, steps)
        return lanes

    @staticmethod
    def _seed_window(slot: _Slot, n: int) -> np.ndarray:
        """The seeds of a lane's next ``n`` emissions, zeros past its
        schedule (and for greedy lanes)."""
        seeds = np.zeros((n,), np.int64)
        if slot.temperature > 0.0:
            offset = len(slot.generated) - 1
            window = slot.step_seeds[offset: offset + n]
            seeds[: len(window)] = window
        return seeds

    def _charge_collectives(self, family: str, kind: str, *, lanes: int,
                            chunk: int = 0, span: int = 0,
                            width: int = 0) -> None:
        """Account one sharded dispatch's estimated collective traffic
        (no-op on a single-device engine: the counters stay zero)."""
        if self._sharded is None:
            return
        self.collective_bytes[family] += \
            self._sharded.dispatch_collective_bytes(
                kind, lanes=lanes, chunk=chunk, span=span, width=width,
                view_rows=self._table_width * self.engine_config.block_size)

    def _run_prefill_chunk(self, slot: _Slot,
                           chunk: Tuple[int, int, int]) -> None:
        # ONE lane per prefill dispatch; the first-token pick rides fused
        final, inputs = self._prefill_lane(slot, chunk)
        (picked,) = self._dispatch(self._program("prefill", chunk[1]), inputs)
        self.prefill_chunks += 1
        self._charge_collectives("prefill_chunk", "prefill", lanes=1,
                                 chunk=chunk[1])
        # fair-share service: the prefill width actually dispatched
        self._queue.charge(slot.tenant, chunk[1])
        if final:
            self._inflight = ("span", None, (slot, _Fetch(picked)))

    def _run_decode_step(self, decode_slots: List[_Slot]) -> None:
        lanes = self._decode_lanes(decode_slots)
        (emitted,) = self._dispatch(self._program("decode"), lanes)
        self.decode_steps += 1
        self._charge_collectives(
            "decode_span", "decode", lanes=self.engine_config.num_slots,
            span=self.engine_config.decode_span)
        self._inflight = ("span", (_Fetch(emitted), list(decode_slots),
                                   lanes["budgets"]), None)

    def _run_loop_step(self, decode_slots: List[_Slot]) -> None:
        """Launch the device-resident loop: up to ``steps_per_launch``
        span-units in ONE dispatch.  The ring and the units-ran count
        are read when consumed, so all unit-proportional bookkeeping
        happens in :meth:`_consume_inflight`."""
        ec = self.engine_config
        k_depth = self._loop_k  # the effective depth, a captured one
        lanes = self._decode_lanes(decode_slots, k_depth * ec.decode_span)
        ring, units = self._dispatch(self._program("loop", k_depth), lanes)
        self.loop_launches += 1
        self._inflight = ("loop", (_Fetch(ring, units), list(decode_slots),
                                   lanes["budgets"]), None)

    def _run_mixed_step(self, decode_slots: List[_Slot], p_slot: _Slot,
                        chunk: Tuple[int, int, int]) -> None:
        """The stall-free fused dispatch: every decode lane advances its
        span AND ``p_slot`` consumes one budget-bounded prefill chunk, in
        ONE program (``paged.paged_mixed_step``)."""
        final, inputs = self._prefill_lane(p_slot, chunk)
        lanes = self._decode_lanes(decode_slots)
        picked, emitted = self._dispatch(self._program("mixed", chunk[1]),
                                         {**inputs, **lanes})
        self.prefill_chunks += 1
        self.decode_steps += 1
        self.mixed_steps += 1
        self._charge_collectives("prefill_chunk", "prefill", lanes=1,
                                 chunk=chunk[1])
        self._charge_collectives(
            "decode_span", "decode", lanes=self.engine_config.num_slots,
            span=self.engine_config.decode_span)
        self._queue.charge(p_slot.tenant, chunk[1])
        fetch = _Fetch(picked, emitted)
        self._inflight = ("mixed", (fetch, list(decode_slots),
                                    lanes["budgets"]),
                          (p_slot, fetch) if final else None)

    def _verify_lanes(self, decode_slots: List[_Slot],
                      drafts: Dict[int, List[int]], width: int):
        """(inputs, k_lanes, budgets) of a verify chunk over the slot
        pool.  Columns a lane does not fill carry -1, which the acceptance
        can never count.  Each lane's seed window is the slice
        ``step_seeds[offset: offset + width]`` a width-``width`` span would
        take: accepted picks consume their seeds at the same emissions,
        and a rejected column's seed is consumed again next round."""
        s = self.engine_config.num_slots
        lanes = {
            "tables": np.zeros((s, self._table_width), np.int64),
            "lengths": np.zeros((s,), np.int64),
            "active": np.zeros((s,), bool),
            "tokens": np.full((s, width), -1, np.int64),
            "widths": np.ones((s,), np.int64),
            "temps": np.zeros((s,), np.float32),
            "seeds": np.zeros((s, width), np.int64),
        }
        lanes["tokens"][:, 0] = 0
        k_lanes = np.zeros((s,), np.int64)
        budgets = np.zeros((s,), np.int64)
        for slot in decode_slots:
            i = slot.idx
            lanes["tables"][i] = slot.table
            lanes["lengths"][i] = slot.length
            lanes["active"][i] = True
            lanes["tokens"][i, 0] = slot.generated[-1]
            proposal = drafts.get(i, [])
            k_lanes[i] = len(proposal)
            lanes["widths"][i] = 1 + len(proposal)
            lanes["tokens"][i, 1: 1 + len(proposal)] = proposal
            lanes["temps"][i] = slot.temperature
            lanes["seeds"][i] = self._seed_window(slot, width)
            budgets[i] = slot.max_new - len(slot.generated)
        return lanes, k_lanes, budgets

    def _run_verify_step(self, plan: _StepPlan) -> None:
        """One draft-verify chunk: every decode lane scores its proposal
        (a lane without one rides as a decode step) in ONE dispatch."""
        lanes, k_lanes, budgets = self._verify_lanes(
            plan.decode_slots, plan.drafts, plan.verify_width)
        picked, accepts = self._dispatch(
            self._program("verify", 0, plan.verify_width), lanes)
        self.verify_steps += 1
        self._charge_collectives(
            "verify_span", "verify", lanes=self.engine_config.num_slots,
            width=plan.verify_width)
        self._inflight = ("verify", (_Fetch(picked, accepts),
                                     list(plan.decode_slots), k_lanes,
                                     budgets), None)

    def _run_mixed_verify_step(self, plan: _StepPlan) -> None:
        """The speculative fused dispatch: every decode lane rides one
        verify chunk AND the filling slot consumes one budget-bounded
        prefill chunk, in ONE program."""
        p_slot, chunk = plan.prefill_slot, plan.chunk
        final, inputs = self._prefill_lane(p_slot, chunk)
        lanes, k_lanes, budgets = self._verify_lanes(
            plan.decode_slots, plan.drafts, plan.verify_width)
        outputs = self._dispatch(
            self._program("mixed_verify", chunk[1], plan.verify_width),
            {**inputs, **lanes})
        self.prefill_chunks += 1
        self.verify_steps += 1
        self.mixed_verify_steps += 1
        self._charge_collectives("prefill_chunk", "prefill", lanes=1,
                                 chunk=chunk[1])
        self._charge_collectives(
            "verify_span", "verify", lanes=self.engine_config.num_slots,
            width=plan.verify_width)
        self._queue.charge(p_slot.tenant, chunk[1])
        fetch = _Fetch(*outputs)
        self._inflight = ("verify", (fetch, list(plan.decode_slots),
                                     k_lanes, budgets),
                          (p_slot, fetch) if final else None)

    @staticmethod
    def _drafting_window(slot: _Slot) -> Tuple[np.ndarray, int]:
        """(hist [SPEC_LOOP_HIST], hist_len): a lane's newest tokens,
        right-aligned — its device drafting window in the speculative
        loop."""
        toks = np.concatenate([slot.prompt, np.asarray(
            slot.generated, np.int64)])[-SPEC_LOOP_HIST:]
        hist = np.zeros((SPEC_LOOP_HIST,), np.int64)
        hist[SPEC_LOOP_HIST - toks.size:] = toks
        return hist, toks.size

    def _spec_loop_lanes(self, decode_slots: List[_Slot], k_depth: int):
        """Inputs of a speculative loop launch: the decode-lane marshal
        with a flat seed window of K verify units (unit u of a lane reads
        seeds ``done .. done+W-1``, ``done`` its in-loop emissions: the
        seeds K separate verify dispatches would read), plus each lane's
        device drafting window and draft cap."""
        n_seeds = k_depth * (1 + self.engine_config.draft_len)
        lanes = self._decode_lanes(decode_slots, n_seeds)
        s = self.engine_config.num_slots
        lanes["hist"] = np.zeros((s, SPEC_LOOP_HIST), np.int64)
        lanes["hist_len"] = np.zeros((s,), np.int64)
        lanes["dcaps"] = np.zeros((s,), np.int64)
        for slot in decode_slots:
            i = slot.idx
            lanes["hist"][i], lanes["hist_len"][i] = \
                self._drafting_window(slot)
            lanes["dcaps"][i] = min(slot.draft_width, self._loop_draft_cap)
        return lanes

    def _ring_lanes(self, k_depth: int):
        """The admission ring's inputs from the staged admissions, in
        ring order (rows past the count are zeros the device never
        activates), and the staged slots they came from."""
        ec = self.engine_config
        r = ec.admission_ring
        n_seeds = k_depth * (1 + ec.draft_len)
        ring = {
            "r_tables": np.zeros((r, self._table_width), np.int64),
            "r_lengths": np.zeros((r,), np.int64),
            "r_tokens": np.zeros((r,), np.int64),
            "r_temps": np.zeros((r,), np.float32),
            "r_seeds": np.zeros((r, n_seeds), np.int64),
            "r_budgets": np.zeros((r,), np.int64),
            "r_hist": np.zeros((r, SPEC_LOOP_HIST), np.int64),
            "r_hist_len": np.zeros((r,), np.int64),
            "r_caps": np.zeros((r,), np.int64),
        }
        staged = list(self._ring_staged[:r])
        for j, slot in enumerate(staged):
            ring["r_tables"][j] = slot.table
            ring["r_lengths"][j] = slot.length
            ring["r_tokens"][j] = slot.generated[-1]
            ring["r_temps"][j] = slot.temperature
            ring["r_budgets"][j] = slot.max_new - len(slot.generated)
            ring["r_seeds"][j] = self._seed_window(slot, n_seeds)
            ring["r_hist"][j], ring["r_hist_len"][j] = \
                self._drafting_window(slot)
            ring["r_caps"][j] = min(slot.draft_width, self._loop_draft_cap)
        ring["r_count"] = np.array(len(staged), np.int64)
        return ring, staged

    def _fill_admission_ring(self) -> None:
        """Top the admission ring up from the queue: each entry runs the
        full admission path (fair order, quota, prefix cache, reservation)
        into a detached ``_Slot``, then prefills its prompt synchronously
        through the standalone chunk programs, so its blocks, charges and
        first token are a normal admission's.  The fill never preempts
        and never touches the in-flight dispatch."""
        room = self.engine_config.admission_ring - len(self._ring_staged)
        while room > 0:
            if self.admission_gate is not None \
                    and not self.admission_gate():
                return
            staged = None
            for tenant in self._queue.order():
                spec = self.tenants.get(tenant)
                pending = self._queue.peek(tenant)
                if self._quota_blocked(pending, spec):
                    continue
                cand = _Slot(-1, self._table_width)
                outcome = self._try_admit(pending, spec, cand)
                if outcome == "admitted":
                    self._queue.pop(tenant)
                    staged = cand
                    break
                if outcome == "quota":
                    continue
                return  # pool exhausted
            if staged is None:
                return
            while staged.plan:
                chunk = staged.plan.pop(0)
                final, inputs = self._prefill_lane(staged, chunk)
                (picked,) = self._dispatch(
                    self._program("prefill", chunk[1]), inputs)
                self.prefill_chunks += 1
                self._charge_collectives("prefill_chunk", "prefill",
                                         lanes=1, chunk=chunk[1])
                self._queue.charge(staged.tenant, chunk[1])
                if final:
                    self._finish_prefill(staged,
                                         int(_Fetch(picked).get()[0][0]))
            # a request done at its first token retired in _finish_prefill
            if staged.state == "decode":
                self._ring_staged.append(staged)
                room -= 1

    def _run_spec_loop_step(self, plan: _StepPlan) -> None:
        """Launch the speculative device loop: up to ``steps_per_launch``
        draft-verify units, with ring activations at unit boundaries, in
        ONE dispatch.  The host draft that armed the plan is dropped (the
        device drafts every unit itself); all unit-proportional
        bookkeeping waits for :meth:`_consume_inflight`."""
        k_depth = self._loop_k
        if self.engine_config.admission_ring:
            self._fill_admission_ring()
        lanes = self._spec_loop_lanes(plan.decode_slots, k_depth)
        ring, staged = self._ring_lanes(k_depth)
        outputs = self._dispatch(self._program("spec_loop", k_depth),
                                 {**lanes, **ring})
        self.spec_loop_launches += 1
        self._inflight = ("spec_loop", (_Fetch(*outputs),
                                        list(plan.decode_slots), staged),
                          None)

    def _consume_inflight(self) -> bool:
        """Apply the previous dispatch's host-side effects: read its
        emitted tokens (the only wait for the device in the unguarded hot
        loop) and run first-token / acceptance / retirement bookkeeping.
        Returns True when there was something to consume."""
        if self._inflight is None:
            return False
        kind, decode_part, prefill_part = self._inflight
        self._inflight = None
        if prefill_part is not None:
            slot, fetch = prefill_part
            self._finish_prefill(slot, int(fetch.get()[0][0]))
        if decode_part is not None:
            if kind == "verify":
                fetch, slots, k_lanes, budgets = decode_part
                picked, accepts = fetch.get()[-2:]
                self._accept_verify(slots, picked, accepts, k_lanes, budgets)
            elif kind == "spec_loop":
                fetch, slots, staged = decode_part
                out_p, out_a, out_d, units, head = fetch.get()
                self._accept_spec_loop(slots, staged, out_p, out_a, out_d,
                                       int(units), int(head))
            elif kind == "loop":
                fetch, slots, budgets = decode_part
                ring, units = fetch.get()
                units = int(units)
                span = self.engine_config.decode_span
                self.decode_steps += units
                self.loop_units += units
                self._charge_collectives(
                    "decode_span", "decode",
                    lanes=self.engine_config.num_slots, span=units * span)
                emitted = ring[: units * span]
                # exit reason + realized depth BEFORE acceptance retires
                # the slots the derivation reads
                self._observe_loop_exit(slots, emitted, budgets, units,
                                        units * span)
                self._accept_decode(slots, emitted, budgets,
                                    n_steps=units * span)
            else:
                fetch, slots, budgets = decode_part
                self._accept_decode(slots, fetch.get()[-1], budgets)
        if self.device.type == "cuda":
            self._drain_timings()
        return True

    def _finish_prefill(self, slot: _Slot, first: int) -> None:
        # prompt fully cached: join the decode pool with the fused
        # first-token pick as the stream's head
        slot.length = slot.prompt.size
        slot.generated = [first]
        now = time.monotonic()
        if slot.result.first_token_at is None:
            # a RESUMED slot keeps its original first-token time
            slot.result.first_token_at = now
            self._observe_ttft(slot.result.ttft, slot.tenant)
        elif slot.last_token_at is not None:
            # resumed after preemption: the stretch since the victim's
            # last token is a real inter-token gap
            self._observe_tbt(now - slot.last_token_at, 1, slot.tenant)
        slot.last_token_at = now
        self.tokens_generated += 1
        self.tenant_tokens[slot.tenant] = \
            self.tenant_tokens.get(slot.tenant, 0) + 1
        self._queue.charge(slot.tenant, 1)
        if slot.drafter is not None:
            slot.drafter.extend([first])
        slot.state = "decode"
        eos = self.engine_config.eos_token
        if (self.on_handoff is not None and len(slot.generated) < slot.max_new
                and not (eos is not None and first == eos)):
            # disaggregated handoff: the request still owes tokens and this
            # pool's role ends at prefill — the router packs the slot's
            # chain for the decode pool; a request already done (max_new
            # 1, or an EOS first token) retires here like any other
            self.on_handoff(slot)
            self._retire_handoff(slot)
            return
        self._maybe_retire(slot, first)

    def _retire_handoff(self, slot: _Slot) -> None:
        """Free a slot whose request just migrated out: index its prompt
        blocks as :meth:`_maybe_retire` does (the NEXT prompt sharing the
        prefix hits here, where prefill happens), reclaim the chain and
        clear the slot.  The request is not finished: no finished_at, no
        requests_finished — the decode pool emits the rest."""
        if self.prefix_index is not None:
            n_prompt = self.allocator.blocks_for_tokens(slot.prompt.size)
            prompt_blocks = [int(b) for b in slot.table[:n_prompt]]
            newly_cached, displaced = self.prefix_index.insert(
                slot.prompt, prompt_blocks)
            self.allocator.mark_cached(newly_cached)
            for b in displaced:
                self.allocator.uncache(b)
        self.allocator.reclaim(slot.blocks[::-1])
        slot._clear()
        slot.state = "free"

    def _emit(self, slot: _Slot, tokens, now: float) -> Tuple[int, bool]:
        """Append ``tokens`` to a lane's stream, stopping after an EOS
        (inclusive), and account for them; returns (emitted, hit EOS)."""
        eos = self.engine_config.eos_token
        accepted, hit_eos = 0, False
        for tok in tokens:
            tok = int(tok)
            slot.length += 1
            slot.generated.append(tok)
            self.tokens_generated += 1
            accepted += 1
            if eos is not None and tok == eos:
                hit_eos = True
                break
        if accepted:
            if slot.drafter is not None:
                slot.drafter.extend(slot.generated[-accepted:])
            self.tenant_tokens[slot.tenant] = \
                self.tenant_tokens.get(slot.tenant, 0) + accepted
            self._queue.charge(slot.tenant, accepted)
            gap = now - (slot.last_token_at
                         if slot.last_token_at is not None else now)
            self._observe_tbt(gap / accepted, accepted, slot.tenant)
            slot.last_token_at = now
        return accepted, hit_eos

    def _accept_decode(self, decode_slots: List[_Slot],
                       emitted: np.ndarray, budgets: np.ndarray,
                       n_steps: Optional[int] = None) -> None:
        """Host acceptance for a decode span — or, with ``n_steps`` =
        units*span, for a loop's ring.  Mirrors the device's
        lane-deactivation rule: accept min(budget, span) tokens,
        truncated at EOS (inclusive)."""
        span = self.engine_config.decode_span if n_steps is None else n_steps
        now = time.monotonic()
        for slot in decode_slots:
            i = slot.idx
            take = min(int(budgets[i]), span)
            self._emit(slot, emitted[:take, i], now)
            self._maybe_retire(slot, slot.generated[-1])

    def _learn_round(self, slot: _Slot, k: int, m: int,
                     accepted: int) -> None:
        """One verify round's speculative bookkeeping for a lane that
        drafted ``k`` tokens and had ``m`` accepted (``accepted`` tokens
        reached the stream): the acceptance EMA doubles the adaptive width
        at >= 0.75 and halves it at <= 0.25 (powers of two only, so every
        reachable width is a warmed shape) — under autotune the tuner's
        cost-model argmax over the widths up to its cap replaces that rule
        — and the counters and the acceptance histogram."""
        rate = m / k
        slot.accept_rate = 0.5 * slot.accept_rate + 0.5 * rate
        if self._tuner is not None:
            slot.draft_width = self._tuner.lane_draft_width(
                slot.accept_rate, self._draft_width_cap)
        elif slot.accept_rate >= 0.75:
            slot.draft_width = min(slot.draft_width * 2,
                                   self.engine_config.draft_len)
        elif slot.accept_rate <= 0.25:
            slot.draft_width = max(slot.draft_width // 2, 1)
        tenant = slot.tenant
        self.spec_drafted[tenant] = self.spec_drafted.get(tenant, 0) + k
        # an EOS may cut the emission short of the accepted prefix: count
        # only drafts that reached the stream
        self.spec_accepted[tenant] = \
            self.spec_accepted.get(tenant, 0) + min(m, accepted)
        hist = self._spec_accept.setdefault(
            tenant, [[0] * (len(SPEC_ACCEPT_BUCKETS) + 1), 0.0])
        hist[1] += rate
        _bucket_observe(hist[0], rate, SPEC_ACCEPT_BUCKETS)

    def _accept_verify(self, decode_slots: List[_Slot], picked: np.ndarray,
                       accepts: np.ndarray, k_lanes: np.ndarray,
                       budgets: np.ndarray) -> None:
        """Host acceptance for one verify chunk: each lane emits its
        accepted draft prefix plus the correction pick (what sequential
        decoding would have emitted), truncated at its remaining budget
        and at EOS; lanes that drafted learn their next width."""
        now = time.monotonic()
        for slot in decode_slots:
            i = slot.idx
            k = int(k_lanes[i])
            m = min(int(accepts[i]), k)
            emit = min(m + 1, int(budgets[i]))
            accepted, _ = self._emit(slot, picked[i, :emit], now)
            if k:
                self._learn_round(slot, k, m, accepted)
            self._maybe_retire(slot, slot.generated[-1])

    def _accept_spec_loop(self, decode_slots: List[_Slot],
                          staged: List[_Slot], out_p: np.ndarray,
                          out_a: np.ndarray, out_d: np.ndarray, units: int,
                          head: int) -> None:
        """Host replay of a speculative loop launch: unit u's lane i
        emitted ``min(accepted + 1, remaining budget)`` tokens of
        ``out_p[u, i]``, truncated at EOS, exactly as K separate verify
        rounds would have.  A lane that retires is rebound to the next
        staged entry in the device's order (ascending lanes within a unit
        boundary, entries head first); activated entries alive at the end
        are bound into their lane's engine slot, which retired.  Also the
        unit-proportional counters and the adaptive widths, round for
        round as :meth:`_accept_verify`, and the exit reason."""
        ec = self.engine_config
        self.verify_steps += units
        self.spec_loop_units += units
        for _ in range(units):
            self._charge_collectives(
                "verify_span", "verify", lanes=ec.num_slots,
                width=1 + ec.draft_len)
        self.loop_depth_sum += units
        self.loop_depth_count += 1
        owner: Dict[int, _Slot] = {s.idx: s for s in decode_slots}
        dead: Dict[int, bool] = {s.idx: False for s in decode_slots}
        next_staged = 0
        unrefilled = None  # "stop" / "retire" of a death with no refill
        for u in range(units):
            now = time.monotonic()
            died: List[int] = []
            for i in sorted(owner):
                if dead[i]:
                    continue
                own = owner[i]
                k, m = int(out_d[u, i]), int(out_a[u, i])
                emit = min(m + 1, own.max_new - len(own.generated))
                accepted, hit_eos = self._emit(own, out_p[u, i, :emit], now)
                if k:
                    self._learn_round(own, k, m, accepted)
                if hit_eos or len(own.generated) >= own.max_new:
                    self._maybe_retire(own, own.generated[-1])
                    died.append(i)
                    if next_staged >= head:
                        # unrefilled: the device exits after this unit
                        # (an EOS death outranks a budget death)
                        unrefilled = ("stop" if hit_eos or unrefilled == "stop"
                                      else "retire")
            for i in died:
                if next_staged < head:
                    owner[i] = staged[next_staged]
                    next_staged += 1
                else:
                    dead[i] = True
        if next_staged != head:
            raise RuntimeError(
                f"spec-loop replay diverged: the device activated {head} "
                f"ring entries, the host replay {next_staged}")
        self.ring_activations += head
        for i, own in owner.items():
            if own.idx == -1 and own.state == "decode":
                self._bind_staged(own, self._slots[i])
        for entry in staged[:next_staged]:
            self._ring_staged.remove(entry)
        if unrefilled is not None:
            reason = "ring_empty" if ec.admission_ring > 0 else unrefilled
        elif units < self._loop_k:
            reason = "redraft"
        else:
            reason = "budget"
        self.loop_exit_reasons[reason] += 1

    def _observe_loop_exit(self, slots: List[_Slot], emitted: np.ndarray,
                           budgets: np.ndarray, units: int,
                           n_steps: int) -> None:
        """The loop's exit reason (an EOS death beats a budget death
        beats running all K units) and its realized depth."""
        ec = self.engine_config
        eos_death = budget_death = False
        for slot in slots:
            i = slot.idx
            take = min(int(budgets[i]), n_steps)
            if ec.eos_token is not None and any(
                    int(emitted[t, i]) == ec.eos_token for t in range(take)):
                eos_death = True
            elif int(budgets[i]) <= n_steps:
                budget_death = True
        if eos_death:
            reason = "stop"
        elif budget_death:
            reason = "retire"
        else:
            reason = "budget"
        self.loop_exit_reasons[reason] += 1
        self.loop_depth_sum += units
        self.loop_depth_count += 1

    def _maybe_retire(self, slot: _Slot, token: int) -> None:
        eos = self.engine_config.eos_token
        if len(slot.generated) >= slot.max_new or (
                eos is not None and token == eos):
            result = slot.result
            # a preempted-and-resumed request's earlier incarnations'
            # tokens come first — the caller sees ONE contiguous stream
            result.tokens = slot.emitted_prefix + list(slot.generated)
            result.finished_at = time.monotonic()
            if self.prefix_index is not None:
                # index the prompt's blocks BEFORE dropping our refs, so
                # they park idle-cached instead of freeing
                n_prompt = self.allocator.blocks_for_tokens(slot.prompt.size)
                prompt_blocks = [int(b) for b in slot.table[:n_prompt]]
                newly_cached, displaced = self.prefix_index.insert(
                    slot.prompt, prompt_blocks)
                self.allocator.mark_cached(newly_cached)
                for b in displaced:
                    self.allocator.uncache(b)
            self.allocator.reclaim(slot.blocks[::-1])
            self.requests_finished += 1
            slot._clear()
            slot.state = "free"
