"""Disaggregated prefill/decode serving: split pools + KV migration, the
port of kubeshare_tpu/serving/disagg.py.

Run PREFILL and DECODE in separate pools so a long prompt never contends
with decode lanes for bandwidth or dispatch slots — the
DistServe/Mooncake shape, and the endgame of mixed batching: mixed
batching bounds how much prefill a decode dispatch carries,
disaggregation removes the contention.

Three pieces:

- :class:`PrefillPool` / :class:`DecodePool` — two
  :class:`~kubeshare_tpu_torch.serving.engine.ServingEngine` instances
  with their own block allocators, slot pools and captured graphs, each
  restricted to its phase through ``EngineConfig.pool_role`` (the
  prefill pool captures and dispatches only prefill chunks and reserves
  only prompt-cover blocks; the decode pool only decode/verify shapes,
  and admits only through ``ServingEngine.admit_migrated``);
- :class:`KVMigrator` — packs a prompt's block chain into the wire
  format (``kv_tier.pack_block`` frames inside a ``pack_chain``
  envelope) and unpacks it into freshly reserved decode-pool blocks
  through the decode pool's captured ``upload`` program.  Serialization
  is EAGER: blocks whose prompt rows are final are read and packed while
  later chunks still prefill, so the handoff itself reads only the last
  chunk's blocks.  On the card every read runs on a side stream that
  waits only on the prefill pool's newest dispatch, into pinned host
  memory, so it never waits on the decode pool's in-flight work; the
  host-side staging (read enqueue, serialize, deserialize, upload
  enqueue) is metered into a stall histogram, and migrated bytes flow
  through the same ``ledger_hook`` the host tier's demote/promote
  traffic uses;
- :class:`DisaggRouter` — the front end: admits through the prefill
  pool's QoS fair queue, tracks each request across the handoff, and
  keeps streams EXACT: the migrated slot is indistinguishable from one
  that just finished prefill in a monolithic engine — same K/V rows
  (bit-exact wire round trip), same first token, same remaining seed
  schedule, same drafter window and trie hint — so greedy and sampled
  streams, speculative on or off, across preemption, equal the
  monolithic engine's token for token.

Topology (:class:`DisaggTopology`): ``two_cell`` runs both pools in one
process on the router's device — two fractional cells of one card.
``virtual_multislice`` places the prefill pool on slice 0's first device
and the decode pool on slice 1's of a 2-slice mesh
(``parallel.distributed.slice_device_mesh``), so the KV migration
crosses the slice boundary where a deployment's cross-slice transfer
sits; on one card both are ``cuda:0`` and the chain still goes through
``pack`` / ``deliver``.

Each pool keeps its OWN radix prefix index (matching happens where
admission happens), with one HOST TIER shared underneath as the
cross-pool cache bus: when either pool demotes a block, the payload
lands in the shared tier and a host-resident mirror node is adopted into
the peer pool's trie (``PrefixIndex.adopt_host``), so a prefix
prefilled once is promotable by whichever pool needs it next.  Mirror
entries are independent copies — the tier's byte budget pays twice for
a both-pools-hot prefix, the price of keeping each trie's invariants
local to its pool.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.distributed import (MultisliceSpec, _world_size,
                                    multislice_spec_from_env,
                                    slice_device_mesh)
from ..parallel.mesh import _visible_cuda_devices
from ..utils.promtext import MetricFamily, Sample
from .autotune import AutoTuner
from .engine import (EngineConfig, Request, RequestResult, ServingEngine,
                     _Pending, _histogram_samples, _bucket_observe,
                     plan_prefill_chunks)
from .fabric import (FabricEndpoint, FabricTransport, K_TICKET,
                     fabric_metric_families, keys_to_seeds, pack_ticket,
                     seeds_to_keys, unpack_ticket)
from .kv_blocks import BlockExhausted, QuotaExceeded, chain_token_runs
from .kv_tier import (HostTier, LRUTierPolicy, QoSTierPolicy,
                      WireCorruption, pack_block, pack_chain,
                      unpack_chain)
from .qos import TenantRegistry

# Migration staging stall bounds: what this histogram sees is host-side
# read-enqueue / serialize / deserialize / upload-enqueue time per
# migration (the device copies overlap the pipelined dispatches); the
# 10ms+ slots are the alarm.
MIGRATION_STALL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                           0.05, 0.1, 0.25, 0.5, 1.0)

# Eager-staging width: how many newly-final prompt blocks one router
# iteration reads ahead of the handoff.  One prefill chunk covers at most
# ``prefill_chunk / block_size`` blocks per iteration, so 4 keeps pace
# with a 64-token chunk over 16-token blocks; the per-iteration cost is a
# ~4-block read, thin enough to hide under the dispatch cadence.
STAGE_GATHER_BLOCKS = 4

# geometry fields both pools must agree on for a migrated slot to be a
# drop-in continuation (block/table layout, chunk planning, pick policy)
_SHARED_GEOMETRY = ("block_size", "max_request_len", "prefill_chunk",
                    "eos_token", "top_k", "top_p", "speculative",
                    "draft_len", "draft_ngram")


class PrefillPool(ServingEngine):
    """A ServingEngine pinned to the prefill phase: ``pool_role`` is
    forced to ``"prefill"`` (mixed batching off — a single-phase pool
    has nothing to fuse) and metric families carry ``pool="prefill"``.
    Slots reserve only prompt-cover blocks; at prefill completion the
    router's handoff hook migrates the chain out."""

    def __init__(self, params, config, engine_config=None, **kwargs):
        ec = replace(engine_config or EngineConfig(),
                     pool_role="prefill", mixed=False)
        kwargs.setdefault("pool_label", "prefill")
        super().__init__(params, config, ec, **kwargs)


class DecodePool(ServingEngine):
    """A ServingEngine pinned to the decode phase: ``pool_role`` is
    forced to ``"decode"`` and metric families carry ``pool="decode"``.
    ``submit`` refuses; requests arrive only through
    :meth:`~kubeshare_tpu_torch.serving.engine.ServingEngine.admit_migrated`."""

    def __init__(self, params, config, engine_config=None, **kwargs):
        ec = replace(engine_config or EngineConfig(),
                     pool_role="decode", mixed=False)
        kwargs.setdefault("pool_label", "decode")
        super().__init__(params, config, ec, **kwargs)


@dataclass(frozen=True)
class DisaggTopology:
    """Where the two pools live.

    ``two_cell`` (default): both pools in one process on the router's
    device — two fractional cells of one card, each pool chargeable
    through its own ExecutionGuard.  ``virtual_multislice``: the prefill
    pool on the first device of slice 0 and the decode pool on the first
    device of slice 1 of a 2-slice mesh built from the MEGASCALE env
    contract over ``devices`` (None: every visible CUDA device, as JAX
    reads ``jax.devices()``), so the KV migration crosses the slice
    boundary where a deployment's cross-slice transfer sits.  A device
    may repeat (``[cuda:0, cuda:0]`` on one card).  Both pools live in
    the router's process, so the mesh is one process's: under several
    processes slice 1's devices are another process's, and ``place``
    raises."""

    mode: str = "two_cell"
    # MEGASCALE-style spec for virtual_multislice (None: read the env)
    multislice: Optional[MultisliceSpec] = None
    devices: Optional[Tuple] = None

    def __post_init__(self) -> None:
        if self.mode not in ("two_cell", "virtual_multislice"):
            raise ValueError(
                f"mode must be 'two_cell' or 'virtual_multislice', got "
                f"{self.mode!r}")

    def place(self, device=None) -> Tuple[object, object]:
        """(prefill_device, decode_device): in two-cell mode both are
        ``device`` (None: the engines' default, the CUDA device)."""
        if self.mode == "two_cell":
            return device, device
        ms = self.multislice or multislice_spec_from_env()
        if ms is None:
            raise ValueError(
                "virtual_multislice topology needs a MultisliceSpec "
                "(pass one, or set the MEGASCALE env like "
                "dryrun_multichip does)")
        world = _world_size()
        if world > 1:
            raise ValueError(
                f"virtual_multislice places both pools in this process, but "
                f"torch.distributed runs {world} processes: slice 1's "
                f"devices are another process's")
        devices = (list(self.devices) if self.devices is not None
                   else _visible_cuda_devices())
        if len(devices) < 2:
            raise ValueError(
                f"virtual_multislice needs >= 2 devices, have "
                f"{len(devices)}")
        mesh = slice_device_mesh(ms, devices=devices)
        return mesh.devices[0, 0], mesh.devices[1, 0]


@dataclass
class _Ticket:
    """One in-flight migration: everything the decode pool needs to
    continue the stream exactly, captured at the instant the prefill
    pool finished the prompt."""

    rid: str
    tenant: str
    prompt: np.ndarray
    first_token: int
    max_new: int
    temperature: float
    step_seeds: np.ndarray         # int64, the remaining seed schedule
    payload: bytes                 # pack_chain envelope
    result: RequestResult
    emitted_prefix: List[int]
    last_token_at: Optional[float]
    hint: Optional[List[int]] = None
    pack_stall_s: float = 0.0
    attempts: int = 0
    # TTL/backoff bookkeeping (router step ordinals): the step the
    # ticket was packed at, and the earliest step its next delivery
    # attempt may run (exponential backoff after each failed attempt)
    created_step: int = 0
    next_attempt_step: int = 0


def _ticket_resume_pending(ticket: _Ticket) -> _Pending:
    """Turn an undeliverable ticket back into a queueable resume — the
    preemption-resume contract at ``done=1`` (the first token was
    emitted at prefill completion; everything after it is still owed).
    The resume prompt appends that first token, the budget drops by one,
    and a sampled stream's next emission consumes ``step_seeds[0]`` —
    exactly the seed the delivered continuation would have consumed, so
    the re-prefilled stream equals the migrated one.  ``plan``/``needed``
    are left empty: the caller re-plans with the admitting pool's
    geometry (``_forward_resume`` does exactly that)."""
    resume_prompt = np.concatenate(
        [np.asarray(ticket.prompt, np.int64),
         np.asarray([ticket.first_token], np.int64)])
    remaining = ticket.max_new - 1
    if ticket.temperature > 0.0:
        seeds = np.asarray(ticket.step_seeds, np.int64).reshape(-1)
        first_seed = int(seeds[0])
        step_seeds = seeds[1:]
    else:
        first_seed = 0
        step_seeds = np.zeros((0,), np.int64)
    return _Pending(
        rid=ticket.rid, tenant=ticket.tenant, prompt=resume_prompt,
        max_new=remaining, temperature=ticket.temperature, plan=[],
        needed=0, first_seed=first_seed, step_seeds=step_seeds,
        emitted=list(ticket.emitted_prefix) + [int(ticket.first_token)],
        last_token_at=ticket.last_token_at)


class _BlockRead:
    """Pool blocks on their way to host memory.  On the card the gather
    and the copy into pinned memory run on ``stream`` after waiting on
    ``after`` (the event of the newest dispatch of the pool that wrote
    them), so the read waits on no other dispatch; :meth:`rows` waits on
    this copy alone.  On the CPU the read is immediate."""

    def __init__(self, engine: ServingEngine, blocks: List[int], after,
                 stream) -> None:
        self.blocks = list(blocks)
        self.event = None
        if stream is None:
            self.k, self.v = engine._read_blocks(self.blocks)
            return
        with torch.cuda.stream(stream):
            if after is not None:
                stream.wait_event(after)
            idx = torch.tensor(self.blocks, dtype=torch.int64).pin_memory()
            idx = idx.to(engine.device, non_blocking=True)
            rows = []
            # a sharded pool's index_select gathers its shards into the
            # unsharded head order, as the engine's _read_blocks does
            for pool in (engine.pool.k, engine.pool.v):
                gathered = pool.index_select(1, idx).transpose(0, 1)
                host = torch.empty(gathered.shape, dtype=gathered.dtype,
                                   pin_memory=True)
                rows.append(host.copy_(gathered, non_blocking=True))
            self.k, self.v = rows
            self.event = torch.cuda.Event()
            self.event.record(stream)

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def frames(self, runs: List[List[int]], first: int) -> List[bytes]:
        """The blocks' wire frames (block ``j`` holds ``runs[first + j]``),
        once the copy has landed."""
        if self.event is not None:
            self.event.synchronize()
        return [pack_block(runs[first + j], self.k[j], self.v[j])
                for j in range(len(self.blocks))]


class KVMigrator:
    """Packs a prefill slot's block chain into the wire format and
    unpacks it into the decode pool — eagerly, block by block, as the
    prompt prefills (:meth:`stage`), with the handoff (:meth:`pack`)
    reading only the remainder.  Counters feed the metrics plane;
    ``ledger_hook(nbytes, "migrate")`` feeds the interposer's
    CopyToDevice accounting (the hook shape ``HostTier`` uses for
    demote/promote bytes); ``host_seconds`` splits the host time by
    stage / pack / deliver."""

    def __init__(self, decode: ServingEngine, ledger_hook=None) -> None:
        self.decode = decode
        self.ledger_hook = ledger_hook
        self.migrations = 0          # chains packed
        self.delivered = 0           # chains admitted decode-side
        self.migrated_bytes = 0      # wire envelope bytes packed
        self._stall_counts = [0] * (len(MIGRATION_STALL_BUCKETS) + 1)
        self._stall_sum = 0.0
        self.host_seconds: Dict[str, float] = {
            "stage": 0.0, "pack": 0.0, "deliver": 0.0}
        # eager staging, per rid: the (block, frame) pairs packed AHEAD of
        # the handoff, the reads still in flight, and the host seconds
        # spent on them (folded into the chain's stall)
        self._staged: Dict[str, List[Tuple[int, bytes]]] = {}
        self._reading: Dict[str, List[_BlockRead]] = {}
        self._staged_secs: Dict[str, float] = {}
        # the side stream every read of the card runs on
        self._stream = (torch.cuda.Stream(decode.device)
                        if decode.device.type == "cuda" else None)

    def _drop_staging(self, rid: str) -> None:
        self._staged.pop(rid, None)
        self._reading.pop(rid, None)
        self._staged_secs.pop(rid, None)

    def _staged_blocks(self, rid: str) -> List[int]:
        """The chain blocks ``rid`` has staged or is reading, in order."""
        return ([b for b, _ in self._staged.get(rid, [])]
                + [b for r in self._reading.get(rid, []) for b in r.blocks])

    def _stale(self, rid: str, slot, settled: int) -> bool:
        """Does ``rid``'s staging belong to another incarnation of the rid
        (more blocks than ``settled``, or not ``slot``'s blocks)?"""
        blocks = self._staged_blocks(rid)
        return len(blocks) > settled or any(
            int(slot.table[i]) != b for i, b in enumerate(blocks))

    def _land(self, rid: str, runs: List[List[int]], wait: bool) -> None:
        """Pack ``rid``'s landed reads (every read when ``wait``) into its
        staged frames, in chain order."""
        frames = self._staged.setdefault(rid, [])
        reads = self._reading.get(rid, [])
        while reads and (wait or reads[0].ready()):
            read = reads.pop(0)
            frames.extend(zip(read.blocks, read.frames(runs, len(frames))))

    def read(self, engine: ServingEngine, blocks: List[int]) -> _BlockRead:
        """Start a read of ``engine``'s ``blocks`` after its newest
        dispatch (on the card, on the migrator's side stream)."""
        return _BlockRead(engine, blocks, engine.last_dispatch_event,
                          self._stream)

    def stage(self, engine: ServingEngine, after,
              settled: Dict[str, int]) -> None:
        """Eagerly read and serialize prompt blocks that are already FINAL
        while their prompt is still prefilling — the Mooncake/Splitwise
        overlap of KV transfer with prefill, so the handoff reads only the
        last chunk's blocks.  ``settled`` maps rid -> prompt tokens whose
        rows no later chunk rewrites, as of the END of the previous
        router iteration, and ``after`` is the event of the prefill
        pool's last dispatch then: the reads wait on it and on nothing
        else, and land in pinned memory while this iteration's
        dispatches run; landed reads are packed at the next call.  At
        most :data:`STAGE_GATHER_BLOCKS` blocks are read per call."""
        t_all = time.monotonic()
        live = {s.rid: s for s in engine._slots if s.state == "prefill"}
        for rid in [r for r in set(self._staged) | set(self._reading)
                    if r not in live]:
            # finished without a handoff (single-token stream) or
            # otherwise gone: the frames will never be packed
            self._drop_staging(rid)
        budget = STAGE_GATHER_BLOCKS
        bs = engine.engine_config.block_size
        for rid, slot in live.items():
            t0 = time.monotonic()
            done = settled.get(rid)
            if done is None or self._stale(rid, slot, done // bs):
                # admitted since the snapshot, or a fresh incarnation of
                # the rid with new blocks: nothing staged is this slot's
                self._drop_staging(rid)
            if self._reading.get(rid):
                self._land(rid, chain_token_runs(slot.prompt, bs), False)
            if done is not None and budget > 0:
                n = len(self._staged_blocks(rid))
                take = min(done // bs - n, budget)
                if take > 0:
                    budget -= take
                    self._reading.setdefault(rid, []).append(_BlockRead(
                        engine,
                        [int(slot.table[i]) for i in range(n, n + take)],
                        after, self._stream))
            self._staged_secs[rid] = (self._staged_secs.get(rid, 0.0)
                                      + time.monotonic() - t0)
        self.host_seconds["stage"] += time.monotonic() - t_all

    def pack(self, engine: ServingEngine, slot) -> _Ticket:
        """Serialize ``slot``'s prompt chain (called from the prefill
        pool's handoff hook, BEFORE the slot's blocks are reclaimed: every
        read of the chain has landed when this returns, so a later
        dispatch may rewrite the blocks).  Frames already staged are
        reused verbatim; only the remainder — normally the final chunk's
        blocks plus the partial tail — is read here.  The stall metered
        per migration is the TOTAL staging time (eager + handoff)."""
        t0 = time.monotonic()
        ec = engine.engine_config
        runs = chain_token_runs(slot.prompt, ec.block_size)
        if self._stale(slot.rid, slot, len(runs)):
            self._drop_staging(slot.rid)  # another incarnation's: restage
        self._land(slot.rid, runs, True)
        frames = [frame for _, frame in self._staged.get(slot.rid, [])]
        eager_s = self._staged_secs.get(slot.rid, 0.0)
        self._drop_staging(slot.rid)
        n = len(frames)
        if n < len(runs):
            frames += self.read(
                engine, [int(slot.table[i]) for i in range(n, len(runs))]
            ).frames(runs, n)
        payload = pack_chain(frames)
        hint = (slot.drafter.hint_window
                if slot.drafter is not None else None)
        spent = time.monotonic() - t0
        self.host_seconds["pack"] += spent
        ticket = _Ticket(
            rid=slot.rid, tenant=slot.tenant,
            prompt=np.array(slot.prompt, np.int64),
            first_token=int(slot.generated[0]), max_new=slot.max_new,
            temperature=slot.temperature,
            step_seeds=np.array(slot.step_seeds, np.int64),
            payload=payload, result=slot.result,
            emitted_prefix=list(slot.emitted_prefix),
            last_token_at=slot.last_token_at, hint=hint,
            pack_stall_s=eager_s + spent)
        self.migrations += 1
        self.migrated_bytes += len(payload)
        if self.ledger_hook is not None:
            self.ledger_hook(len(payload), "migrate")
        return ticket

    def deliver(self, ticket: _Ticket) -> bool:
        """Unpack ``ticket`` into freshly reserved decode-pool blocks;
        False when the decode pool cannot place it right now (no free
        slot / unfundable reservation) — the router retries after the
        pool's next step, or preempts for a Guarantee ticket.  On
        success the full staging time (pack + unpack + upload enqueue;
        the device copy-in overlaps the pipelined dispatch) lands in
        the stall histogram."""
        ticket.attempts += 1
        t0 = time.monotonic()
        try:
            frames = unpack_chain(ticket.payload)
            ok = self.decode.admit_migrated(
                rid=ticket.rid, tenant=ticket.tenant, prompt=ticket.prompt,
                first_token=ticket.first_token, max_new=ticket.max_new,
                temperature=ticket.temperature,
                step_seeds=ticket.step_seeds, payloads=frames,
                result=ticket.result, emitted_prefix=ticket.emitted_prefix,
                last_token_at=ticket.last_token_at, hint=ticket.hint)
        finally:
            self.host_seconds["deliver"] += time.monotonic() - t0
        if not ok:
            return False
        self.delivered += 1
        stall = ticket.pack_stall_s + (time.monotonic() - t0)
        self._stall_sum += stall
        _bucket_observe(self._stall_counts, stall,
                        MIGRATION_STALL_BUCKETS)
        return True

    def collect_metrics(self) -> List[MetricFamily]:
        mig = MetricFamily(
            "kubeshare_serving_migrations_total",
            "KV chain migrations by stage (packed = prefill chains "
            "serialized, delivered = chains admitted into the decode "
            "pool; packed - delivered are pending).", "counter")
        mig.add({"stage": "packed"}, self.migrations)
        mig.add({"stage": "delivered"}, self.delivered)
        mbytes = MetricFamily(
            "kubeshare_serving_migrated_bytes_total",
            "Wire-format bytes migrated prefill -> decode.", "counter")
        mbytes.add({}, self.migrated_bytes)
        stall = MetricFamily(
            "kubeshare_serving_migration_stall_seconds",
            "Host-side migration staging time per delivered chain "
            "(serialize + deserialize + upload enqueue; the device "
            "copy-in overlaps the decode pool's pipelined dispatch).",
            "histogram")
        _histogram_samples(
            stall, "kubeshare_serving_migration_stall_seconds", {},
            self._stall_counts, self._stall_sum,
            MIGRATION_STALL_BUCKETS)
        return [mig, mbytes, stall]


class DisaggRouter:
    """The disaggregated front end: one :class:`PrefillPool`, one
    :class:`DecodePool`, a :class:`KVMigrator` between them, and a
    submit/step/run surface shaped like ``ServingEngine``'s so callers
    (benchmarks, tests) swap it in directly.

    ``prefill_config`` / ``decode_config`` size the two pools
    independently (slots, blocks, host budgets); the fields in
    ``_SHARED_GEOMETRY`` must agree — asserted loudly here, because a
    silent mismatch would corrupt streams, not crash.  Tenant quotas
    are split across the pools proportionally to each pool's share of
    total allocatable blocks (``TenantRegistry.pool_view``), so the
    aggregate contract tracks the monolithic one.

    ``shared_tier_bytes`` turns on the cross-pool host tier (the cache
    bus); ``ledger_hook(nbytes, kind)`` sees every demote/promote/
    migrate byte — wire it to
    ``TokenClient.request_memory`` and the interposer's fractional-HBM
    ledger accounts the traffic like any ``Buffer_CopyToDevice``.

    ``max_pending_handoffs`` makes prefill admission RESERVE decode
    capacity: a prompt starts prefilling only when a free decode slot
    (net of in-flight prefills and undelivered tickets) can absorb its
    handoff, with at most that many prefills in flight at once.  The
    backlog waits in the fair queue — where the wait is TTFT, exactly
    as in a monolithic engine — instead of as first-token-emitted
    streams stalled at the handoff.  ``None`` (default) disables the
    gate.

    ``decode_priority=K`` paces prefill against decode activity: while
    the decode pool is dispatching, the prefill pool advances at most
    once per ``K`` decode steps (and freely whenever decode goes
    idle).  On pools sharing compute — two fractional cells of one
    chip, or one host emulating both slices — this bounds how often a
    prefill chunk can land in front of a decode span, the collision
    mixed batching pays on EVERY dispatch with prefill pending; on
    truly separate slices there is no collision and the pacing merely
    defers prefill the decode pool never felt.  ``None`` (default)
    alternates the pools every step.

    ``device`` is the card both pools run on unless the caller names
    another (``"cpu"`` runs their programs eagerly); ``params`` must live
    there."""

    def __init__(
        self,
        params,
        config,
        prefill_config: EngineConfig,
        decode_config: EngineConfig,
        guard=None,
        decode_guard=None,
        tenants: Optional[TenantRegistry] = None,
        topology: Optional[DisaggTopology] = None,
        shared_tier_bytes: Optional[int] = None,
        tier_policy: str = "lru",
        ledger_hook=None,
        max_pending_handoffs: Optional[int] = None,
        decode_priority: Optional[int] = None,
        replica_label: Optional[str] = None,
        handoff_ttl_steps: Optional[int] = None,
        handoff_backoff_steps: int = 1,
        handoff_backoff_cap_steps: int = 8,
        fabric: Optional[FabricTransport] = None,
        fabric_ttl_ticks: int = 16,
        device=None,
    ) -> None:
        if handoff_ttl_steps is not None and handoff_ttl_steps < 1:
            raise ValueError(
                f"handoff_ttl_steps must be >= 1, got {handoff_ttl_steps}")
        if handoff_backoff_steps < 1:
            raise ValueError(
                f"handoff_backoff_steps must be >= 1, got "
                f"{handoff_backoff_steps}")
        if handoff_backoff_cap_steps < handoff_backoff_steps:
            raise ValueError(
                f"handoff_backoff_cap_steps {handoff_backoff_cap_steps} "
                f"is below handoff_backoff_steps {handoff_backoff_steps}")
        for name in _SHARED_GEOMETRY:
            pv, dv = (getattr(prefill_config, name),
                      getattr(decode_config, name))
            if pv != dv:
                raise ValueError(
                    f"prefill/decode pools disagree on {name}: "
                    f"{pv!r} vs {dv!r} — shared geometry is what makes "
                    f"a migrated slot a drop-in continuation")
        if decode_priority is not None \
                and decode_config.steps_per_launch > 1:
            raise ValueError(
                f"decode_priority pacing is incompatible with the "
                f"decode pool's device-resident loop (steps_per_launch="
                f"{decode_config.steps_per_launch}): the pacing counts "
                f"HOST decode steps to interleave prefill, but a loop "
                f"launch runs up to K scheduler iterations headless — "
                f"the router would pace against launches, not steps, "
                f"silently starving prefill by up to K x; set "
                f"steps_per_launch=1 on the decode pool or drop "
                f"decode_priority")
        self.tenants = tenants or TenantRegistry.default()
        p_share = prefill_config.num_blocks - 1
        d_share = decode_config.num_blocks - 1
        total = p_share + d_share
        self.topology = topology or DisaggTopology()
        p_dev, d_dev = self.topology.place(device)

        self.shared_tier: Optional[HostTier] = None
        if shared_tier_bytes is not None:
            policy = (LRUTierPolicy() if tier_policy == "lru"
                      else QoSTierPolicy(self.tenants))
            self.shared_tier = HostTier(shared_tier_bytes, policy,
                                        on_drop=self._route_drop,
                                        ledger_hook=ledger_hook)

        def build(cls, ec, dev, pool_guard):
            kwargs = dict(guard=pool_guard,
                          tenants=self.tenants.pool_view(
                              (p_share if cls is PrefillPool else d_share)
                              / total),
                          shared_host_tier=self.shared_tier,
                          tier_ledger_hook=(ledger_hook
                                            if self.shared_tier is None
                                            else None),
                          replica_label=replica_label, device=dev)
            return cls(params, config, ec, **kwargs)

        self.prefill = build(PrefillPool, prefill_config, p_dev, guard)
        self.decode = build(DecodePool, decode_config, d_dev,
                            decode_guard if decode_guard is not None
                            else guard)
        self.migrator = KVMigrator(self.decode, ledger_hook=ledger_hook)
        self.prefill.on_handoff = self._handoff
        self.decode.on_preempt_requeue = self._forward_resume
        if self.shared_tier is not None:
            self.prefill.on_tier_demote = self._mirror(self.decode)
            self.decode.on_tier_demote = self._mirror(self.prefill)
        self._tickets: List[_Ticket] = []
        self._results: Dict[str, RequestResult] = {}
        # handoff TTL + bounded exponential backoff: a ticket that has
        # been attempted at least once and sat undelivered for
        # ``handoff_ttl_steps`` router steps EXPIRES — its decode
        # reserve is released (the admission gate counts tickets, so
        # popping it restores the reserve) and the request re-queues to
        # prefill-from-cache via the done=1 resume contract.  Failed
        # attempts back off ``base * 2^(attempts-1)`` steps, capped.
        # None (default) keeps the legacy wait-forever behavior, where
        # an undeliverable ticket with both pools idle is still a loud
        # deadlock.
        self._handoff_ttl = handoff_ttl_steps
        self._handoff_backoff = handoff_backoff_steps
        self._handoff_backoff_cap = handoff_backoff_cap_steps
        # handoffs over the cluster KV fabric (serving/fabric.py): a
        # packed ticket becomes a K_TICKET message from the prefill
        # endpoint to the decode endpoint — per-message crc, TTL,
        # bounded-backoff redelivery, receiver dedup.  Transport-level
        # faults (drop/duplicate/corrupt) are the fabric's problem;
        # decode CAPACITY retries keep the legacy backoff discipline,
        # applied to the arrival queue instead of the send queue.
        self._fabric_pf: Optional[FabricEndpoint] = None
        self._fabric_dc: Optional[FabricEndpoint] = None
        self._fabric_inflight: Dict[int, _Ticket] = {}
        self._fabric_arrivals: List[_Ticket] = []
        self._fabric_expired_rids: set = set()
        self._fabric_tick_step = -1
        if fabric is not None:
            if fabric_ttl_ticks < 1:
                raise ValueError(
                    f"fabric_ttl_ticks must be >= 1, got "
                    f"{fabric_ttl_ticks}")
            tag = replica_label or "dg"
            self._fabric_pf = FabricEndpoint(
                f"{tag}-pf", fabric, ttl_ticks=fabric_ttl_ticks,
                backoff_base=handoff_backoff_steps,
                backoff_cap=handoff_backoff_cap_steps)
            self._fabric_dc = FabricEndpoint(
                f"{tag}-dc", fabric, ttl_ticks=fabric_ttl_ticks,
                backoff_base=handoff_backoff_steps,
                backoff_cap=handoff_backoff_cap_steps)
        self._steps = 0
        self.handoff_retries: Dict[str, int] = {
            "delivered": 0, "retried": 0, "expired": 0, "corrupt": 0,
            "dropped": 0}
        # chaos seam (serving/chaos.py): consulted before each delivery
        # attempt; a False return models the handoff RPC lost in flight
        self.fault_clock = None
        # eager-staging snapshot: the prefill pool's last dispatch event
        # and per-rid settled-token counts as of the END of the last
        # step() — one iteration stale, so the reads wait on nothing this
        # iteration dispatches (see KVMigrator.stage)
        self._stage_after = None
        self._stage_settled: Optional[Dict[str, int]] = None
        if decode_priority is not None and decode_priority < 1:
            raise ValueError(
                f"decode_priority must be >= 1, got {decode_priority}")
        self._decode_priority = decode_priority
        self._decode_streak = 0
        # held as an attribute (not closed over) so the autotuner can
        # retune the reserve margin between steps; the admission gate
        # reads the live value on every call
        self._max_pending_handoffs = max_pending_handoffs
        if max_pending_handoffs is not None:
            # handoff backpressure: a stream's first token is emitted at
            # prefill completion, so every finished-but-undelivered
            # prompt is a STALLED stream, not progress.  Admission into
            # the prefill pool therefore RESERVES decode capacity: a
            # prompt starts prefilling only when a free decode slot —
            # net of in-flight prefills and pending tickets — can
            # absorb its handoff, capped at ``max_pending_handoffs``
            # prefill-ahead.  The backlog waits in the fair queue,
            # where it is TTFT (as in a monolithic engine), instead of
            # inflating the decode pool's inter-token tail by a whole
            # stream's lifetime.
            def gate() -> bool:
                staged = sum(s.state != "free"
                             for s in self.prefill._slots)
                free_d = sum(s.state == "free"
                             for s in self.decode._slots)
                return (staged + self._pending_handoffs()
                        < min(self._max_pending_handoffs, free_d))
            self.prefill.admission_gate = gate
        # router-level autotuner (serving/autotune.py): retunes the
        # pacing ratio and reserve margin within their validated
        # ranges.  Knobs exist only for limits the router was built
        # with; tick time is charged to the decode pool's
        # host_seconds["tune"], never to either pool's planner.
        self._tuner = (AutoTuner.for_router(
            self, interval=decode_config.autotune_interval)
            if ((prefill_config.autotune or decode_config.autotune)
                and (decode_priority is not None
                     or max_pending_handoffs is not None))
            else None)

    # ------------------------------------------------------------------
    def submit(self, request: Request) -> RequestResult:
        """Queue a request into the prefill pool.  Decode-side lifetime
        feasibility is checked HERE (loudly): a request the decode pool
        could never hold must not burn prefill work first."""
        prompt = np.asarray(request.prompt, np.int32)
        if prompt.ndim == 1 and prompt.size >= 1 \
                and request.max_new_tokens >= 1 \
                and request.tenant in self.decode.tenants:
            alloc = self.decode.allocator
            needed = alloc.blocks_for_tokens(
                prompt.size + request.max_new_tokens)
            if needed > alloc.num_blocks - 1:
                raise BlockExhausted(
                    f"request {request.rid!r} needs {needed} decode-pool "
                    f"blocks but that pool only has "
                    f"{alloc.num_blocks - 1} — it can NEVER migrate in "
                    f"(grow the decode pool or shrink the request)")
            quota = self.decode.tenants.get(request.tenant).kv_block_quota
            if quota is not None and needed > quota:
                raise QuotaExceeded(
                    f"request {request.rid!r} needs {needed} decode-pool "
                    f"blocks but tenant {request.tenant!r}'s decode-side "
                    f"quota is {quota} — it can NEVER migrate in")
        result = self.prefill.submit(request)
        self._results[request.rid] = result
        return result

    def step(self) -> bool:
        """One routing iteration: try pending deliveries, advance the
        prefill pool (handoffs append tickets), deliver fresh tickets,
        advance the decode pool.  Returns False only when everything —
        both pools and the ticket list — is drained."""
        if self._tuner is not None:
            # tick before either pool advances: the tuner reads last
            # iteration's fully-consumed counters and retunes the
            # pacing/reserve knobs the gates below consult
            t0 = time.monotonic()
            self._tuner.tick()
            self.decode.host_seconds["tune"] += time.monotonic() - t0
        self._steps += 1
        worked = self._drain_tickets()
        if self._stage_settled is not None:
            # read a few already-final prompt blocks ahead of their
            # handoff (from last iteration's settled snapshot)
            self.migrator.stage(self.prefill, self._stage_after,
                                self._stage_settled)
        if self._decode_priority is None:
            worked |= self.prefill.step()
            worked |= self._drain_tickets()
            worked |= self.decode.step()
        else:
            # decode-priority pacing: decode first, prefill only when
            # decode idles or its turn comes up (1 per K decode steps)
            d_worked = self.decode.step()
            worked |= d_worked
            self._decode_streak = (self._decode_streak + 1
                                   if d_worked else 0)
            if not d_worked \
                    or self._decode_streak >= self._decode_priority:
                self._decode_streak = 0
                worked |= self.prefill.step()
                worked |= self._drain_tickets()
        self._stage_after = self.prefill.last_dispatch_event
        self._stage_settled = {
            s.rid: (s.plan[0][0] if s.plan else s.prompt.size)
            for s in self.prefill._slots if s.state == "prefill"}
        if self._tickets and not worked and self._handoff_ttl is None \
                and self._fabric_pf is None:
            # nothing moved anywhere yet a ticket is stuck: with the
            # decode pool fully idle its reservation can never succeed
            # (submit() pre-checked sizing, so this is state corruption
            # — fail loudly rather than spin).  With a TTL configured
            # the ticket instead expires and re-queues within
            # ``handoff_ttl_steps`` — quiet steps while it backs off
            # are progress toward that, not a deadlock.
            raise RuntimeError(
                f"migration deadlock: {len(self._tickets)} ticket(s) "
                f"undeliverable with both pools idle (head: "
                f"{self._tickets[0].rid!r})")
        if self._fabric_pf is not None and self._fabric_arrivals \
                and not worked and self._handoff_ttl is None \
                and not self._fabric_inflight and not self._tickets:
            raise RuntimeError(
                f"migration deadlock: {len(self._fabric_arrivals)} "
                f"fabric-delivered ticket(s) unadmittable with both "
                f"pools idle (head: {self._fabric_arrivals[0].rid!r})")
        return worked or self._pending_handoffs() > 0

    def run(self) -> Dict[str, RequestResult]:
        """Drain everything; returns results by request id."""
        try:
            while self.step():
                pass
        finally:
            done = set()
            for eng in (self.prefill, self.decode):
                if eng.guard is not None and id(eng.guard) not in done:
                    done.add(id(eng.guard))
                    eng.guard.finish()
        return dict(self._results)

    def _pending_handoffs(self) -> int:
        """Every undelivered handoff, wherever it currently sits: the
        local ticket queue, the fabric's unacked in-flight map, and the
        decode-side arrival queue — the admission gate's decode-reserve
        count and the idle test both need all three."""
        return (len(self._tickets) + len(self._fabric_inflight)
                + len(self._fabric_arrivals))

    @property
    def idle(self) -> bool:
        return (self._pending_handoffs() == 0 and self.prefill.idle
                and self.decode.idle)

    def result(self, rid: str) -> RequestResult:
        return self._results[rid]

    def pop_finished(self) -> Dict[str, RequestResult]:
        """Remove and return every completed result (the live-loop
        eviction point) — drains all three maps so a forever-stepping
        server does not grow without bound."""
        done = {rid: r for rid, r in self._results.items() if r.done}
        for rid in done:
            del self._results[rid]
        self.prefill.pop_finished()
        self.decode.pop_finished()
        return done

    # ------------------------------------------------------------------
    # fleet routing probes (serving/fleet.py): a disagg pair is one
    # replica — composition, not a special case.  Affinity is judged
    # against the PREFILL trie (that is where a new prompt's prefix
    # lands), load against both pools (a saturated decode side stalls
    # streams just as surely as a saturated prefill side).
    def prefix_match_len(self, tokens) -> int:
        return self.prefill.prefix_match_len(tokens)

    def load_probe(self) -> Dict[str, int]:
        p = self.prefill.load_probe()
        d = self.decode.load_probe()
        return {
            "queue_depth": p["queue_depth"] + self._pending_handoffs(),
            "free_slots": min(p["free_slots"], d["free_slots"]),
            "free_blocks": p["free_blocks"] + d["free_blocks"],
        }

    def warmup(self) -> None:
        """Both pools' warm-up (each captures its own graphs, on its own
        graph memory pool), then one read of the scratch block through
        the migrator, so the side stream and the pinned buffers are not
        first made under the first migration's metered stall."""
        self.prefill.warmup()
        self.decode.warmup()
        self.migrator.read(self.prefill, [0]).frames([[0]], 0)

    def capture_counts(self) -> Dict[str, int]:
        """Both pools' programs by kind, keys prefixed ``prefill.`` /
        ``decode.`` — the zero-new-captures assertion's raw data."""
        counts = {f"prefill.{k}": v
                  for k, v in self.prefill.capture_counts().items()}
        counts.update({f"decode.{k}": v
                       for k, v in self.decode.capture_counts().items()})
        return counts

    # ------------------------------------------------------------------
    def collect_metrics(self) -> List[MetricFamily]:
        """Both pools' families merged (same-name families concatenate
        their samples — the ``pool`` label keeps series distinct where
        it is set; unlabeled families sum), plus the migrator's
        families.  Shared-tier gauges are reported ONCE from the tier
        itself — both pools read the same store, so summing their
        copies would double-count."""
        merged: Dict[str, MetricFamily] = {}
        shared_once = {"kubeshare_serving_tier_host_bytes"}
        for i, eng in enumerate((self.prefill, self.decode)):
            for fam in eng.collect_metrics():
                if self.shared_tier is not None \
                        and fam.name in shared_once and i > 0:
                    continue  # one copy of the shared store's gauges
                have = merged.get(fam.name)
                if have is None:
                    merged[fam.name] = fam
                    continue
                self._merge_samples(have, fam)
        if self.shared_tier is not None:
            # host_evicted reaches both pools' tier_blocks families
            # from the one shared store: rebuild that sample once
            fam = merged["kubeshare_serving_tier_blocks_total"]
            fam.samples = [
                s for s in fam.samples
                if s.labels.get("event") != "host_evicted"]
            fam.add({"event": "host_evicted"},
                    self.shared_tier.evicted_blocks)
        if self._tuner is not None:
            # the router's own tuner decisions join the merged family;
            # pool="router" keeps them distinct from any per-pool
            # engine tuner's samples
            fam = merged.get("kubeshare_serving_tuner_decisions_total")
            if fam is None:
                fam = MetricFamily(
                    "kubeshare_serving_tuner_decisions_total",
                    "Autotuner knob decisions by knob and direction.",
                    "counter")
                merged[fam.name] = fam
            for (knob, direction), n in sorted(
                    self._tuner.decisions.items()):
                fam.add({"knob": knob, "direction": direction,
                         "pool": "router"}, n)
        retries = MetricFamily(
            "kubeshare_serving_handoff_retries_total",
            "Handoff ticket delivery outcomes (delivered = admitted "
            "decode-side; retried = decode pool full, backing off; "
            "dropped = delivery attempt lost in flight [chaos]; "
            "expired = TTL hit, decode reserve released and stream "
            "re-queued to prefill-from-cache; corrupt = wire checksum "
            "failed, stream re-queued to re-prefill)", "counter")
        for outcome, n in sorted(self.handoff_retries.items()):
            retries.add({"outcome": outcome}, n)
        out = (list(merged.values()) + self.migrator.collect_metrics()
               + [retries])
        if self._fabric_pf is not None:
            out.extend(fabric_metric_families(
                [self._fabric_pf, self._fabric_dc]))
        return out

    @staticmethod
    def _merge_samples(dst: MetricFamily, src: MetricFamily) -> None:
        index = {(s.name, tuple(sorted(s.labels.items()))): s
                 for s in dst.samples}
        for s in src.samples:
            key = (s.name, tuple(sorted(s.labels.items())))
            have = index.get(key)
            if have is None:
                dst.samples.append(s)
                index[key] = s
            else:
                # same series from both pools (unlabeled families):
                # counters/gauges sum
                merged = Sample(have.name, have.labels,
                                have.value + s.value)
                dst.samples[dst.samples.index(have)] = merged
                index[key] = merged

    # ------------------------------------------------------------------
    def _handoff(self, slot) -> None:
        """Prefill-pool hook: the slot just produced its first token
        and still owes more — pack the chain NOW (the caller reclaims
        the blocks right after) and queue the ticket; delivery is
        attempted at the next drain point so the prefill pool's step
        finishes first (the decode upload then overlaps it)."""
        ticket = self.migrator.pack(self.prefill, slot)
        ticket.created_step = self._steps
        self._tickets.append(ticket)

    def _drain_tickets(self) -> bool:
        if self._fabric_pf is not None:
            return self._drain_tickets_fabric()
        progressed = False
        now = self._steps
        while self._tickets:
            ticket = self._tickets[0]
            if self._handoff_ttl is not None \
                    and ticket.attempts > 0 \
                    and now - ticket.created_step >= self._handoff_ttl:
                # TTL expiry: pop the ticket (the admission gate counts
                # tickets, so this releases its decode reserve) and
                # re-queue the stream to prefill-from-cache
                self._tickets.pop(0)
                self._expire_ticket(ticket, "expired")
                progressed = True
                continue
            if ticket.next_attempt_step > now:
                break  # backing off; head-of-line FIFO is preserved
            if self.fault_clock is not None \
                    and not self.fault_clock.on_ticket_delivery(ticket):
                # chaos: the delivery RPC was lost in flight — burn an
                # attempt (drives backoff and the TTL's attempted-once
                # precondition) and retry later
                ticket.attempts += 1
                self.handoff_retries["dropped"] += 1
                self._set_backoff(ticket, now)
                break
            try:
                delivered = self.migrator.deliver(ticket)
            except WireCorruption:
                # the packed chain rotted in flight: admit_migrated
                # detected it BEFORE reserving anything decode-side, so
                # the only loss is the wire bytes — re-queue the stream
                # to re-prefill from clean device state
                self._tickets.pop(0)
                self._expire_ticket(ticket, "corrupt")
                progressed = True
                continue
            if delivered:
                self._tickets.pop(0)
                self.handoff_retries["delivered"] += 1
                progressed = True
                continue
            spec = self.decode.tenants.get(ticket.tenant)
            if spec.is_guarantee and self.decode._preempt_victim():
                # cache-backed preemption decode-side; the victim's
                # resume routes back through the prefill pool
                # (_forward_resume)
                progressed = True
                continue
            self.handoff_retries["retried"] += 1
            self._set_backoff(ticket, now)
            break
        return progressed

    def _drain_tickets_fabric(self) -> bool:
        """The handoff path when tickets ride the cluster KV fabric.
        Four stages, all host work: (1) every freshly packed ticket is
        serialized (:func:`~kubeshare_tpu.serving.fabric.pack_ticket`)
        and sent prefill-endpoint → decode-endpoint; (2) the decode
        endpoint's arrivals are deserialized into tickets (dedup +
        crc already handled by the endpoint) and queued; (3) acks
        retire the in-flight map, the per-step tick drives redelivery,
        and TTL expiries resume their streams through the done=1
        contract; (4) the arrival queue drains under the LEGACY
        capacity discipline — deliver, Guarantee preemption, bounded
        backoff — so a full decode pool behaves exactly as it did
        before the fabric existed."""
        progressed = False
        now = self._steps
        while self._tickets:
            t = self._tickets.pop(0)
            hint = np.asarray(
                t.hint if t.hint is not None else [], np.int32)
            body = pack_ticket(
                t.rid, t.tenant, t.prompt, t.first_token, t.max_new,
                t.temperature, seeds_to_keys(t.step_seeds),
                t.payload, t.emitted_prefix, hint, t.pack_stall_s,
                t.last_token_at)
            mid = self._fabric_pf.send(self._fabric_dc.name, K_TICKET,
                                       body)
            self._fabric_inflight[mid] = t
            progressed = True
        for src, kind, mid, body in self._fabric_dc.poll():
            if kind != K_TICKET:
                continue
            d = unpack_ticket(body)
            if d["rid"] in self._fabric_expired_rids:
                # the sender already expired this ticket and resumed
                # the stream via re-prefill; a late frame must not
                # admit it a second time
                self._fabric_expired_rids.discard(d["rid"])
                self.handoff_retries["stale"] = \
                    self.handoff_retries.get("stale", 0) + 1
                continue
            self._fabric_arrivals.append(_Ticket(
                rid=d["rid"], tenant=d["tenant"], prompt=d["prompt"],
                first_token=d["first_token"], max_new=d["max_new"],
                temperature=d["temperature"],
                step_seeds=keys_to_seeds(d["step_keys"]),
                payload=d["payload"],
                result=self._results.get(d["rid"]),
                emitted_prefix=list(d["emitted_prefix"]),
                last_token_at=d["last_token_at"],
                hint=([int(x) for x in d["hint"]]
                      if d["hint"].size else None),
                pack_stall_s=d["pack_stall_s"], created_step=now))
            progressed = True
        self._fabric_pf.poll()  # acks
        for mid in self._fabric_pf.take_delivered():
            self._fabric_inflight.pop(mid, None)
        if self._fabric_tick_step != now:
            # _drain_tickets runs up to three times per router step;
            # virtual time advances once
            self._fabric_tick_step = now
            self._fabric_pf.tick()
            self._fabric_dc.tick()
        for dest, kind, mid, body in self._fabric_pf.take_expired():
            t = self._fabric_inflight.pop(mid, None)
            if t is None:
                continue
            if self._rid_live_decode(t.rid):
                # the ticket WAS admitted — only its ack died.  Work
                # happened exactly once; resuming would run it twice.
                self.handoff_retries["delivered"] += 1
                continue
            self._fabric_expired_rids.add(t.rid)
            self._expire_ticket(t, "expired")
            progressed = True
        while self._fabric_arrivals:
            ticket = self._fabric_arrivals[0]
            if self._handoff_ttl is not None \
                    and ticket.attempts > 0 \
                    and now - ticket.created_step >= self._handoff_ttl:
                self._fabric_arrivals.pop(0)
                self._expire_ticket(ticket, "expired")
                progressed = True
                continue
            if ticket.next_attempt_step > now:
                break
            try:
                delivered = self.migrator.deliver(ticket)
            except WireCorruption:
                # rot that predates the envelope (a corrupt tier put
                # packed into the chain): the block crc catches it at
                # admit, the stream re-prefills from clean state
                self._fabric_arrivals.pop(0)
                self._expire_ticket(ticket, "corrupt")
                progressed = True
                continue
            if delivered:
                self._fabric_arrivals.pop(0)
                self.handoff_retries["delivered"] += 1
                progressed = True
                continue
            spec = self.decode.tenants.get(ticket.tenant)
            if spec.is_guarantee and self.decode._preempt_victim():
                progressed = True
                continue
            self.handoff_retries["retried"] += 1
            self._set_backoff(ticket, now)
            break
        return progressed

    def _rid_live_decode(self, rid: str) -> bool:
        """Did ``rid`` already make it decode-side (admitted slot, or
        finished)?  The expiry-vs-late-ack tiebreaker: at-least-once
        delivery plus this check is what keeps a lost ACK from running
        a stream twice."""
        if any(s.state != "free" and s.rid == rid
               for s in self.decode._slots):
            return True
        r = self._results.get(rid)
        return r is not None and r.done

    def _set_backoff(self, ticket: _Ticket, now: int) -> None:
        """Bounded exponential backoff in router steps: attempt k waits
        ``base * 2^(k-1)`` steps before retrying, capped — the decode
        pool gets breathing room to free a slot without the router
        hammering a full pool every iteration."""
        backoff = min(self._handoff_backoff_cap,
                      self._handoff_backoff
                      * (2 ** max(0, ticket.attempts - 1)))
        ticket.next_attempt_step = now + backoff

    def _expire_ticket(self, ticket: _Ticket, outcome: str) -> None:
        """An undeliverable (or corrupt) ticket's exit: count it, then
        re-queue the stream through the done=1 resume contract — the
        prompt was cached into the prefill trie at handoff, so the
        re-prefill is a cache hit re-materializing K/V plus one new
        token, and the stream stays bit-exact (the remaining key
        schedule rides the pending entry)."""
        self.handoff_retries[outcome] = \
            self.handoff_retries.get(outcome, 0) + 1
        self._forward_resume(ticket.tenant, _ticket_resume_pending(ticket))

    def _forward_resume(self, tenant: str, pending) -> None:
        """Decode-pool preemption hook: a victim's resume must
        RE-PREFILL (its cached tail re-materializes where prefill
        runs), so the pending entry is re-planned with the prefill
        pool's geometry and requeued at the front of its lane there —
        the seed schedule rides along untouched, keeping the resumed
        stream bit-exact."""
        ec = self.prefill.engine_config
        plan, cover = plan_prefill_chunks(
            pending.prompt.size, ec.prefill_chunk, ec.max_request_len)
        pending.plan = plan
        pending.needed = self.prefill.allocator.blocks_for_tokens(
            self.prefill._lifetime_rows(
                pending.prompt.size, pending.max_new, cover))
        self.prefill._queue.requeue_front(tenant, pending)

    # ------------------------------------------------------------------
    def _mirror(self, peer: ServingEngine):
        """Make one pool's ``on_tier_demote`` hook: when THIS pool
        demotes a block into the shared tier, insert an independent
        copy of the payload under the PEER pool's trie as a
        host-resident node — the cross-pool cache bus.  Adoption can
        decline (missing ancestor, overlapping run): then the mirror
        copy is forgotten and only the demoting pool's entry remains.
        Pure host work, safe under the demoting pool's allocator
        lock."""
        def on_demote(node, payload: bytes, tenant) -> None:
            src = (self.prefill if peer is self.decode
                   else self.decode).prefix_index
            tokens = src.path_tokens(node)
            key = self.shared_tier.put(payload, tenant, None)
            if key is None:
                return  # budget/policy refused the mirror copy
            adopted = peer.prefix_index.adopt_host(tokens, key)
            if adopted is None:
                self.shared_tier.forget(key)
            else:
                self.shared_tier.bind_node(key, adopted)
        return on_demote

    def _route_drop(self, entry) -> None:
        """Shared tier's budget-eviction hook: route the dying entry to
        whichever pool's trie holds its node.  A mirror inserted with
        ``node=None`` and evicted before ``bind_node`` ran has no trie
        presence yet — nothing to detach."""
        if entry.node is None:
            return
        if self.prefill.prefix_index.owns(entry.node):
            self.prefill._drop_host_entry(entry)
        else:
            self.decode._drop_host_entry(entry)
