"""Replica fleet serving: prefix-affinity routing + placement control, the
port of kubeshare_tpu/serving/fleet.py.

Everything below :class:`ReplicaFleet` is one engine (or one disagg
pair) on one card; this module is the cluster axis — N data-parallel
REPLICAS behind one front end.  Three ideas, composed:

- **Prefix-affinity routing.**  Each arrival probes every active
  replica's radix trie through the read-only
  :meth:`~kubeshare_tpu_torch.serving.prefix_index.PrefixIndex.match_len`
  (device- and host-tier-resident prefixes both count) and goes to the
  replica holding the longest prefix at BLOCK granularity — ties and
  zero-hit prompts fall back to least-loaded (free blocks + queue
  depth).  Affinity never wins over QoS: a Guarantee request whose
  affinity target would queue it spills to a replica with a free slot,
  and any request spills off a saturated target.  Policies are
  pluggable (:class:`RoutingPolicy`); the control arm is
  :class:`RoundRobinPolicy`.

- **Drain-then-retire with cache inheritance.**  :meth:`drain` stops
  admission to a replica and lets its lanes finish; at idle the fleet
  snapshots the replica's whole radix trie (device blocks read back in
  one gather, host entries probed without touching tier LRU) and
  re-inserts every block into the SHARED host tier under each surviving
  replica's trie (``PrefixIndex.adopt_host``), so a retired replica's
  cache is inherited, not lost.  While replicas live, pressure-demoted
  blocks mirror to siblings through the same bus.

- **Placement + autoscaling as control-plane decisions.**  The fleet
  accepts a placement plane (any object with ``place(name)`` /
  ``release(name)``, such as the scheduler's ``FleetPlacementPlane``)
  and a :class:`ScalingPolicy` consulted every ``autoscale_every``
  steps: :class:`TTFTBreachPolicy` scales up on a sustained
  interval-TTFT-p95 breach and drains the least-loaded replica after
  sustained idleness, with consecutive-cycle hysteresis so a bursty
  trace never flaps.

Devices: every replica runs on the fleet's ``device`` (the CUDA device
unless the caller names another; ``"cpu"`` runs the programs eagerly)
and shares the caller's parameter tensors — N fractional cells of one
card.  ``EngineConfig.mesh_spec`` with dp > 1 is carved by
:func:`~kubeshare_tpu_torch.serving.sharded.carve_replica_groups` over
``devices`` (every visible card by default) into per-replica groups; a
tp = 1 replica runs on its group's device with one copy of the
parameters per device, and a tp > 1 group runs a tensor-parallel engine
(sharded.py) over exactly its group.  A ``replica_factory`` swaps whole
replicas for disagg pairs or anything engine-shaped.

Streams equal one monolithic engine's at equal aggregate KV budget: a
stream is deterministic in (prompt, budget, temperature, seed schedule)
whichever replica runs it and however scheduling interleaves.  No
replica captures a CUDA graph after its warm-up.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..utils.promtext import MetricFamily, Sample
from ..parallel.mesh import MeshSpec
from .autotune import AutoTuner
from .chaos import ReplicaKilled
from .engine import (EngineConfig, Request, RequestResult, ServingEngine,
                     TTFT_BUCKETS, _Pending, _bucket_observe,
                     _histogram_samples, plan_prefill_chunks)
from .fabric import (FabricDirectory, FabricEndpoint, FabricTransport,
                     K_CHAIN, fabric_metric_families, pack_chain_msg,
                     prefix_fabric_key, unpack_chain_msg)
from .kv_tier import (HostTier, LRUTierPolicy, QoSTierPolicy, adopt_into,
                      pack_block)
from .metrics_view import HistogramWindow, interval_quantile
from .qos import TenantRegistry
from .sharded import carve_replica_groups

# Drain-duration bucket bounds: a drain lasts as long as its slowest
# in-flight lane (admission stops immediately), so healthy drains track
# a request lifetime; the 30s+ tail is a stuck lane, not a drain.
DRAIN_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# Recovery-duration bucket bounds: last proof of life -> recovery
# complete (detection latency INCLUDED — the grace epochs are part of
# what a user-visible stall costs).  Under a virtual FaultClock a step is
# ~1ms, so healthy recoveries land in the low-millisecond buckets; the
# 1s+ tail means detection took real wall-clock somewhere.
RECOVERY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 5.0)


def _pool_engines(eng) -> list:
    """The raw ServingEngine(s) behind a replica: the engine itself, or
    a disagg pair's two pools — duck-typed so any engine-shaped replica
    works."""
    if hasattr(eng, "_ttft_counts"):
        return [eng]
    return [eng.prefill, eng.decode]


def _slot_resume_pending(slot) -> _Pending:
    """The ``_preempt`` resume arithmetic, computed purely host-side
    from a DEAD engine's slot (no device reads, no allocator work — the
    crashed replica's pool is gone and its blocks die with it).

    With ``done`` tokens emitted, the cache-independent resume is:
    prompt becomes ``prompt + generated`` (its last token is the first
    uncached one), budget becomes ``max_new - done``, and a sampled
    lane's next emission consumes ``step_seeds[done - 1]`` — exactly
    the seed the unperturbed run would have used, which is what keeps
    the recovered stream exact.  A slot that emitted nothing yet
    (prefill state) resumes as its own admission: the seed schedule the
    engine drew at admit time rides along verbatim (a greedy lane's is
    ``first_seed=0`` and an empty schedule).  ``plan`` and ``needed``
    are left empty — the survivor re-plans with its own geometry at
    placement."""
    done = len(slot.generated)
    if done == 0:
        resume_prompt = np.asarray(slot.prompt, np.int64)
        remaining = slot.max_new
        first_seed = int(slot.first_seed)
        step_seeds = np.asarray(slot.step_seeds, np.int64)
        emitted = list(slot.emitted_prefix)
    else:
        resume_prompt = np.concatenate(
            [np.asarray(slot.prompt, np.int64),
             np.asarray(slot.generated, np.int64)])
        remaining = slot.max_new - done
        if slot.temperature > 0.0:
            first_seed = int(slot.step_seeds[done - 1])
            step_seeds = np.asarray(slot.step_seeds[done:], np.int64)
        else:
            first_seed = 0
            step_seeds = np.zeros((0,), np.int64)
        emitted = slot.emitted_prefix + slot.generated
    return _Pending(
        rid=slot.rid, tenant=slot.tenant, prompt=resume_prompt,
        max_new=remaining, temperature=slot.temperature, plan=[],
        needed=0, first_seed=first_seed, step_seeds=step_seeds,
        emitted=emitted, last_token_at=slot.last_token_at)


def _interval_quantile(counts, q: float,
                       bounds=TTFT_BUCKETS) -> Optional[float]:
    """Histogram-bucket quantile over INTERVAL counts (the PromQL
    ``histogram_quantile`` estimate, upper-bound flavored): None on an
    empty interval; observations in the +Inf tail report as infinite —
    any finite threshold treats that as a breach, which is the point."""
    if sum(counts) == 0:
        return None
    return interval_quantile(counts, q, bounds)


def _params_to(tree, device: torch.device):
    """A copy of a parameter tree of dicts and lists on ``device``."""
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_params_to(v, device) for v in tree)
    return tree.to(device)


@dataclass
class ReplicaHandle:
    """One replica's lifecycle record.  ``state`` walks active ->
    draining -> retired on the healthy path; ``failed`` is the crash
    exit (reachable from active or draining) — a failed replica's cell
    and device group are reclaimed and its requests re-admitted
    elsewhere, but the engine reference is kept, exactly as for
    retirement, so ``capture_counts``/``collect_metrics`` still cover
    its final counters.

    ``last_live_at``/``missed_epochs``/``watchdog_trips`` are the
    health monitor's per-replica ledger: the last instant the replica
    completed a step within budget, consecutive steps that raised
    :class:`~kubeshare_tpu_torch.serving.chaos.ReplicaKilled`, and
    consecutive steps that blew the dispatch watchdog budget."""

    name: str
    engine: object
    state: str = "active"
    group_idx: Optional[int] = None
    uses_fleet_tier: bool = False
    drain_started: Optional[float] = None
    placement: object = None
    last_live_at: Optional[float] = None
    missed_epochs: int = 0
    watchdog_trips: int = 0
    fail_cause: Optional[str] = None


# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------

class RoutingPolicy:
    """Where does this arrival go?  ``route`` sees the fleet (for trie
    probes and QoS lookups) and the ACTIVE replica handles; it returns
    (handle, reason) where the reason lands in
    ``kubeshare_serving_fleet_routing_decisions_total{reason=...}``."""

    def route(self, fleet: "ReplicaFleet", request: Request,
              candidates: List[ReplicaHandle]
              ) -> Tuple[ReplicaHandle, str]:
        raise NotImplementedError


def _load_key(probe: Dict[str, int]) -> tuple:
    # fewest queued first, then most free slots, then most allocatable
    # blocks — the "free blocks + queue depth" tie-break
    return (probe["queue_depth"], -probe["free_slots"],
            -probe["free_blocks"])


class PrefixAffinityPolicy(RoutingPolicy):
    """Longest-cached-prefix wins, at block granularity; least-loaded
    breaks ties and takes zero-hit prompts; saturation and Guarantee
    QoS spill.

    ``spill_queue_depth``: a replica with no free slot AND at least
    this many queued requests is saturated.  Guarantee traffic spills
    as soon as the affinity target would queue it at all (no free slot)
    while any candidate has one."""

    def __init__(self, spill_queue_depth: int = 2) -> None:
        if spill_queue_depth < 1:
            raise ValueError(
                f"spill_queue_depth must be >= 1, got {spill_queue_depth}")
        self.spill_queue_depth = spill_queue_depth

    def route(self, fleet, request, candidates):
        probes = {h.name: h.engine.load_probe() for h in candidates}
        least_loaded = min(
            candidates, key=lambda h: (_load_key(probes[h.name]), h.name))
        bs = fleet.block_size
        blocks = {h.name: h.engine.prefix_match_len(request.prompt) // bs
                  for h in candidates}
        best = max(blocks.values())

        def saturated(h):
            p = probes[h.name]
            return (p["free_slots"] == 0
                    and p["queue_depth"] >= self.spill_queue_depth)

        if best <= 0:
            # no LOCAL trie holds any of this prompt — consult the fabric
            # directory: a published prefix key means some replica's host
            # tier still holds the blocks, and routing there turns the
            # miss into a tier promotion.  Longest boundary first;
            # staleness is safe (a withdrawn owner prefills cold)
            directory = getattr(fleet, "directory", None)
            if directory is not None and len(directory) > 0:
                prompt = np.asarray(request.prompt)
                names = {h.name: h for h in candidates}
                top = (prompt.size // bs) * bs
                for n in range(top, 0, -bs):
                    for owner in directory.lookup(
                            prefix_fabric_key(prompt[:n])):
                        h = names.get(owner)
                        if h is not None and not saturated(h):
                            return h, "remote_affinity"
            return least_loaded, "least_loaded"
        winner = min((h for h in candidates if blocks[h.name] == best),
                     key=lambda h: (_load_key(probes[h.name]), h.name))

        wp = probes[winner.name]
        if fleet.tenants.get(request.tenant).is_guarantee \
                and wp["free_slots"] == 0:
            with_slot = [h for h in candidates
                         if probes[h.name]["free_slots"] > 0]
            if with_slot:
                return min(with_slot,
                           key=lambda h: (_load_key(probes[h.name]),
                                          h.name)), "spill"
        if saturated(winner):
            open_ = [h for h in candidates if not saturated(h)]
            if open_:
                return min(open_,
                           key=lambda h: (_load_key(probes[h.name]),
                                          h.name)), "spill"
        return winner, "affinity"


class RoundRobinPolicy(RoutingPolicy):
    """Cache-blind rotation over the active set — the control arm: the
    affinity policy's margin over it is the router's whole
    contribution."""

    def __init__(self) -> None:
        self._next = 0

    def route(self, fleet, request, candidates):
        handle = candidates[self._next % len(candidates)]
        self._next += 1
        return handle, "round_robin"


# ---------------------------------------------------------------------------
# scaling policies
# ---------------------------------------------------------------------------

class ScalingPolicy:
    """Consulted every ``autoscale_every`` fleet steps: return ``"up"``
    to add a replica, ``"down"`` to drain the least-loaded one,
    ``"down:<name>"`` to drain a specific one, None to hold.  The fleet
    clamps to [min_replicas, max_replicas] and to the carved device
    groups."""

    def decide(self, fleet: "ReplicaFleet") -> Optional[str]:
        return None


class TTFTBreachPolicy(ScalingPolicy):
    """Scale up on sustained TTFT p95 breach, drain on sustained idle.

    Each ``decide`` diffs the fleet's cumulative TTFT histogram counts
    (all non-retired replicas, merged) against the previous call's
    snapshot — an INTERVAL histogram — and estimates its p95.
    ``breach_cycles`` consecutive breached intervals (each with at least
    ``min_samples`` observations) trigger one scale-up; ``idle_cycles``
    consecutive empty-and-idle intervals trigger one drain.  Both
    streaks reset after firing and on any contrary observation, so a
    bursty trace never flaps the fleet."""

    def __init__(self, threshold_s: float, *, breach_cycles: int = 3,
                 idle_cycles: int = 3, min_samples: int = 4,
                 quantile: float = 0.95) -> None:
        if threshold_s <= 0:
            raise ValueError(
                f"threshold_s must be > 0, got {threshold_s}")
        if breach_cycles < 1 or idle_cycles < 1:
            raise ValueError(
                f"breach_cycles/idle_cycles must be >= 1, got "
                f"{breach_cycles}/{idle_cycles}")
        if min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {min_samples}")
        if not (0.0 < quantile < 1.0):
            raise ValueError(
                f"quantile must be in (0, 1), got {quantile}")
        self.threshold_s = threshold_s
        self.breach_cycles = breach_cycles
        self.idle_cycles = idle_cycles
        self.min_samples = min_samples
        self.quantile = quantile
        # this policy's OWN interval view over the fleet's cumulative
        # TTFT buckets — the tuner holds a separate window
        self._window = HistogramWindow()
        self._breaches = 0
        self._idle = 0

    def decide(self, fleet):
        interval = self._window.update(fleet._ttft_counts_snapshot())
        n = sum(interval)
        if n >= self.min_samples:
            p = _interval_quantile(interval, self.quantile)
            if p is not None and p > self.threshold_s:
                self._breaches += 1
                self._idle = 0
            else:
                self._breaches = 0
        elif n == 0 and fleet.idle:
            self._idle += 1
            self._breaches = 0
        else:
            # a thin or busy interval is evidence of neither overload
            # nor idleness — break both streaks rather than guess
            self._breaches = 0
            self._idle = 0
        if self._breaches >= self.breach_cycles:
            self._breaches = 0
            self._idle = 0
            return "up"
        if self._idle >= self.idle_cycles:
            self._idle = 0
            self._breaches = 0
            return "down"
        return None


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

class ReplicaFleet:
    """N replica engines behind a prefix-affinity router — the
    engine-shaped front end over the ``dp`` axis (submit / step / run /
    idle / result / pop_finished / warmup / capture_counts /
    collect_metrics, same surface as one engine or a disagg pair).

    ``engine_config`` is the PER-REPLICA geometry (a fleet of 2 at equal
    aggregate budget with a monolithic ``num_blocks=2B+1`` engine runs
    each replica at ``num_blocks=B+1`` — block 0 is scratch in every
    pool).  ``shared_tier_bytes`` stands up ONE host tier under every
    replica's trie: the cross-replica cache bus that drains and
    pressure-demotes travel over.  ``placement`` is any object with
    ``place(name)`` / ``release(name)``; ``replica_factory(name,
    devices, shared_host_tier, tenants)`` swaps whole replicas (a disagg
    pair is one replica) — factory replicas that keep their own tier opt
    out of the fleet bus and its drain inheritance.

    ``device`` is the card every replica runs on unless the caller names
    another (``"cpu"`` runs their programs eagerly); ``params`` must
    live there.  ``devices`` is the list a dp > 1 ``mesh_spec`` carves
    (every visible card by default)."""

    def __init__(
        self,
        params,
        config,
        engine_config: Optional[EngineConfig] = None,
        *,
        replicas: int = 2,
        min_replicas: int = 1,
        max_replicas: Optional[int] = None,
        guard=None,
        tenants: Optional[TenantRegistry] = None,
        routing: Optional[RoutingPolicy] = None,
        scaling: Optional[ScalingPolicy] = None,
        autoscale_every: int = 50,
        placement=None,
        shared_tier_bytes: Optional[int] = None,
        tier_policy: str = "lru",
        fabric: Optional[FabricTransport] = None,
        fabric_ttl_ticks: int = 16,
        ledger_hook=None,
        replica_factory: Optional[Callable] = None,
        clock: Callable[[], float] = time.monotonic,
        fault_clock=None,
        liveness_grace: int = 2,
        watchdog_budget_s: Optional[float] = None,
        watchdog_grace: int = 2,
        device=None,
        devices=None,
    ) -> None:
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if liveness_grace < 1:
            raise ValueError(
                f"liveness_grace must be >= 1, got {liveness_grace}")
        if watchdog_grace < 1:
            raise ValueError(
                f"watchdog_grace must be >= 1, got {watchdog_grace}")
        if watchdog_budget_s is not None and watchdog_budget_s <= 0:
            raise ValueError(
                f"watchdog_budget_s must be > 0, got {watchdog_budget_s}")
        if min_replicas < 1 or min_replicas > replicas:
            raise ValueError(
                f"min_replicas must be in [1, replicas={replicas}], "
                f"got {min_replicas}")
        if max_replicas is not None and max_replicas < replicas:
            raise ValueError(
                f"max_replicas {max_replicas} is below the initial "
                f"fleet size {replicas}")
        if autoscale_every < 1:
            raise ValueError(
                f"autoscale_every must be >= 1, got {autoscale_every}")
        self.device = resolve_device(device)
        self.params = params
        # one parameter copy per device a carved group lives on (the
        # fleet's own device shares the caller's tensors)
        self._device_params: Dict[torch.device, object] = {
            self.device: params}
        self.model_config = config
        self.engine_config = engine_config or EngineConfig()
        self.tenants = tenants or TenantRegistry.default()
        self.routing = routing or PrefixAffinityPolicy()
        self.scaling = scaling
        self.autoscale_every = autoscale_every
        self.placement = placement
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self._guard = guard
        self._replica_factory = replica_factory
        self._ledger_hook = ledger_hook
        # chaos seam (serving/chaos.py): the fault clock is installed on
        # every pool engine at build time, and — unless the caller pinned
        # a clock of their own — its virtual ``now`` becomes the fleet's
        # clock, so watchdog timing, drain durations and recovery latency
        # are deterministic under injection
        self.fault_clock = fault_clock
        if fault_clock is not None and clock is time.monotonic:
            clock = fault_clock.now
        self._clock = clock
        # health monitor: a replica is declared dead after
        # ``liveness_grace`` consecutive steps raising ReplicaKilled, or
        # — with a watchdog budget set — ``watchdog_grace`` consecutive
        # steps whose time blew the budget (one slow step is NOT a
        # failure)
        self.liveness_grace = liveness_grace
        self.watchdog_budget_s = watchdog_budget_s
        self.watchdog_grace = watchdog_grace
        self.replica_failures: Dict[str, int] = {}
        self.salvaged_tokens = 0
        # the salvage rate's denominator: tokens of every host-resident
        # node a dead replica HELD, whether or not a survivor adopted it
        self.salvage_candidate_tokens = 0
        # exact recovery latencies (the histogram buckets coarsen)
        self.recovery_durations: List[float] = []
        self.orphans_readmitted = 0
        self._recovery_counts = [0] * (len(RECOVERY_BUCKETS) + 1)
        self._recovery_sum = 0.0
        # host seconds inside _recover_replica, and the drain handoffs'
        # host seconds and device blocks read back (one gather a handoff)
        self.recovery_host_s = 0.0
        self.handoff_host_s = 0.0
        self.handoff_blocks = 0
        # each replica serves ~1/N of the traffic, so each gets a 1/N
        # view of every tenant's KV quota (scale-ups reuse the fraction)
        self._quota_fraction = 1.0 / replicas

        self.shared_tier: Optional[HostTier] = None
        if shared_tier_bytes is not None:
            if tier_policy not in ("lru", "qos"):
                raise ValueError(
                    f"tier_policy must be 'lru' or 'qos', got "
                    f"{tier_policy!r}")
            policy = (LRUTierPolicy() if tier_policy == "lru"
                      else QoSTierPolicy(self.tenants))
            self.shared_tier = HostTier(shared_tier_bytes, policy,
                                        on_drop=self._route_drop,
                                        ledger_hook=ledger_hook)
            if fault_clock is not None:
                self.shared_tier.fault_clock = fault_clock

        # the cluster KV fabric (serving/fabric.py): with a transport,
        # mirror/drain/salvage chain traffic rides it as K_CHAIN messages
        # under the at-least-once delivery contract instead of direct
        # shared-tier inserts, and a directory of published prefix keys
        # gives the router a remote-affinity path
        self.fabric = fabric
        self.directory: Optional[FabricDirectory] = None
        self._fleet_ep: Optional[FabricEndpoint] = None
        self._endpoints: Dict[str, FabricEndpoint] = {}
        self._fabric_ttl = fabric_ttl_ticks
        # sender-side bookkeeping for salvage/handoff accounting:
        # (sender name, msg_id) -> prompt-token weight of the chain, and
        # the set of messages some receiver actually adopted
        self._chain_weight: Dict[Tuple[str, int], int] = {}
        self._adopted_msgs: set = set()
        self.fabric_adopted_tokens = 0
        self.fabric_expired_chains = 0
        if fabric is not None:
            if self.shared_tier is None:
                raise ValueError(
                    "fabric requires shared_tier_bytes — the chain "
                    "messages it carries adopt into the fleet's shared "
                    "host tier")
            if fabric_ttl_ticks < 1:
                raise ValueError(
                    f"fabric_ttl_ticks must be >= 1, got "
                    f"{fabric_ttl_ticks}")
            if fault_clock is not None:
                fabric.fault_clock = fault_clock
            self.directory = FabricDirectory()
            self._fleet_ep = FabricEndpoint("fleet", fabric,
                                            ttl_ticks=fabric_ttl_ticks)

        # dp carving: a dp>1 mesh_spec names this fleet's device budget
        self._groups: Optional[List[list]] = None
        self._free_groups: List[int] = []
        if self.engine_config.mesh_spec is not None:
            self._groups = carve_replica_groups(self.engine_config.mesh_spec,
                                                devices)
            if replicas > len(self._groups):
                raise ValueError(
                    f"replicas={replicas} exceeds the "
                    f"{len(self._groups)} device group(s) carved from "
                    f"mesh_spec {self.engine_config.mesh_spec}")
            if max_replicas is not None \
                    and max_replicas > len(self._groups):
                raise ValueError(
                    f"max_replicas={max_replicas} exceeds the "
                    f"{len(self._groups)} device group(s) carved from "
                    f"mesh_spec {self.engine_config.mesh_spec} — the "
                    f"autoscaler cannot conjure devices")
            self._free_groups = list(range(len(self._groups)))[::-1]

        self._replicas: List[ReplicaHandle] = []
        self._next_idx = 0
        self._owner: Dict[str, str] = {}
        self._results: Dict[str, RequestResult] = {}
        self._steps = 0
        self.routing_decisions: Dict[str, int] = {
            "affinity": 0, "least_loaded": 0, "spill": 0,
            "remote_affinity": 0}
        self.scale_events: Dict[str, int] = {"up": 0, "down": 0}
        self._drain_counts = [0] * (len(DRAIN_BUCKETS) + 1)
        self._drain_sum = 0.0
        # the fleet-level autotuner (serving/autotune.py): with autotune
        # on and a TTFT-breach autoscaler installed, retune its breach
        # threshold within (init/4, init*4) from the same interval TTFT
        # reader the autoscaler uses (each holds its own window)
        self._tuner = (AutoTuner.for_fleet(
            self, self.scaling, TTFT_BUCKETS,
            interval=self.engine_config.autotune_interval)
            if (self.engine_config.autotune
                and isinstance(self.scaling, TTFTBreachPolicy))
            else None)
        for _ in range(replicas):
            self._add_replica(count_event=False)

    # ------------------------------------------------------------------
    # replica lifecycle
    # ------------------------------------------------------------------
    @property
    def replicas(self) -> List[ReplicaHandle]:
        return list(self._replicas)

    def _active(self) -> List[ReplicaHandle]:
        return [h for h in self._replicas if h.state == "active"]

    def _handle(self, name: str) -> ReplicaHandle:
        for h in self._replicas:
            if h.name == name:
                return h
        raise KeyError(
            f"unknown replica {name!r} (have: "
            f"{[h.name for h in self._replicas]})")

    @property
    def block_size(self) -> int:
        return self.engine_config.block_size

    def _add_replica(self, count_event: bool, warmup: bool = False
                     ) -> ReplicaHandle:
        group_idx = None
        devices = None
        if self._groups is not None:
            if not self._free_groups:
                raise RuntimeError(
                    f"dp carve exhausted: all {len(self._groups)} "
                    f"device groups hold replicas — the fleet cannot "
                    f"grow past dp")
            group_idx = self._free_groups.pop()
            devices = self._groups[group_idx]
        name = f"r{self._next_idx}"
        self._next_idx += 1
        view = self.tenants.pool_view(self._quota_fraction)
        if self._replica_factory is not None:
            eng = self._replica_factory(name, devices, self.shared_tier,
                                        view)
            uses_tier = (self.shared_tier is not None
                         and getattr(eng, "host_tier", None)
                         is self.shared_tier)
        else:
            eng = self._build_engine(name, devices, view)
            uses_tier = self.shared_tier is not None
        handle = ReplicaHandle(name=name, engine=eng, group_idx=group_idx,
                               uses_fleet_tier=uses_tier)
        handle.last_live_at = self._clock()
        if self.fault_clock is not None:
            for pool_eng in _pool_engines(eng):
                pool_eng.fault_clock = self.fault_clock
                if getattr(pool_eng, "disk_tier", None) is not None:
                    pool_eng.disk_tier.fault_clock = self.fault_clock
        if uses_tier:
            eng.on_tier_demote = self._mirror_from(handle)
            if self.fabric is not None:
                self._endpoints[name] = FabricEndpoint(
                    name, self.fabric, ttl_ticks=self._fabric_ttl)
        if self.placement is not None:
            handle.placement = self.placement.place(name)
        self._replicas.append(handle)
        if warmup:
            eng.warmup()
        if count_event:
            self.scale_events["up"] += 1
        return handle

    def _build_engine(self, name: str, devices, view: TenantRegistry):
        base = self.engine_config
        kwargs = dict(guard=self._guard, tenants=view, replica_label=name,
                      shared_host_tier=self.shared_tier,
                      tier_ledger_hook=(self._ledger_hook
                                        if self.shared_tier is None
                                        else None))
        if devices is not None and len(devices) > 1:
            # tp-sharded replica: a private dp=1 mesh over exactly this
            # group — the engine's sharded context places the params and
            # splits the pool over it
            ec = replace(base, mesh_spec=MeshSpec(
                dp=1, tp=len(devices), sp=1))
            return ServingEngine(self.params, self.model_config, ec,
                                 mesh_devices=list(devices), **kwargs)
        ec = replace(base, mesh_spec=None)
        dev = (self.device if devices is None
               else torch.device(devices[0]))
        params = self._device_params.get(dev)
        if params is None:
            params = self._device_params[dev] = _params_to(self.params,
                                                           dev)
        # JAX commits the fresh KV slabs to the replica's device here
        # (an uncommitted pool would recompile after warm-up); a torch
        # pool is allocated on its device, so nothing needs committing
        return ServingEngine(params, self.model_config, ec, device=dev,
                             **kwargs)

    def scale_up(self, *, warmup: bool = True) -> ReplicaHandle:
        """Add one replica (placed, tier-wired, warmed: on the card its
        warm-up captures the new replica's graphs while its siblings'
        dispatches may still be in flight).  Loud when the fleet is at
        max_replicas or out of device groups — the autoscaler pre-checks
        :meth:`can_grow` instead of catching."""
        live = sum(1 for h in self._replicas
                   if h.state not in ("retired", "failed"))
        if self.max_replicas is not None and live >= self.max_replicas:
            raise RuntimeError(
                f"fleet is at max_replicas={self.max_replicas} "
                f"({live} live replicas)")
        return self._add_replica(count_event=True, warmup=warmup)

    def can_grow(self) -> bool:
        live = sum(1 for h in self._replicas
                   if h.state not in ("retired", "failed"))
        if self.max_replicas is not None and live >= self.max_replicas:
            return False
        if self._groups is not None and not self._free_groups:
            return False
        return True

    def drain(self, name: str) -> None:
        """Stop admission to ``name`` and let its lanes finish; the step
        loop retires it at idle, handing its trie to the shared tier so
        siblings inherit the cache.  Refuses to shrink the active set
        below ``min_replicas``."""
        handle = self._handle(name)
        if handle.state != "active":
            raise ValueError(
                f"replica {name!r} is {handle.state}, not active")
        if len(self._active()) - 1 < self.min_replicas:
            raise RuntimeError(
                f"draining {name!r} would leave "
                f"{len(self._active()) - 1} active replicas, below "
                f"min_replicas={self.min_replicas}")
        handle.state = "draining"
        handle.drain_started = self._clock()
        self.scale_events["down"] += 1

    def _finish_drains(self) -> None:
        for handle in self._replicas:
            if handle.state != "draining" or not handle.engine.idle:
                continue
            dur = max(0.0, self._clock() - handle.drain_started)
            _bucket_observe(self._drain_counts, dur, DRAIN_BUCKETS)
            self._drain_sum += dur
            self._handoff_trie(handle)
            handle.state = "retired"
            if self.directory is not None:
                self.directory.withdraw_owner(handle.name)
            self._endpoints.pop(handle.name, None)
            if self.placement is not None:
                self.placement.release(handle.name)
            if handle.group_idx is not None:
                self._free_groups.append(handle.group_idx)

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------
    def _recover_replica(self, handle: ReplicaHandle, cause: str) -> None:
        """The pod-died path, end to end.  Ordering matters:

        1. mark the replica failed (every later walk skips it);
        2. SALVAGE the host-tier slice of its radix trie into the
           survivors' tries — first, so the re-admitted orphans below
           can prefix-hit whatever survived;
        3. re-admit its queued and in-flight requests on survivors via
           the preemption-resume contract (the emitted tokens, the
           remaining seed schedule and the first-uncached-token restart
           all ride along);
        4. reclaim the control-plane cell through the placement plane's
           pod-deleted path and return the device group to the carve.

        Recovery latency is measured last-proof-of-life -> recovery
        complete, so the grace epochs' detection cost is included.

        Before any of that, the dead replica's IN-FLIGHT launch is
        consumed: a kill lands at the top of ``step()`` — before
        ``_consume_inflight`` — so a launch that completed on the device
        may still hold emitted tokens, retirements and ring activations
        that never reached host state.  Consuming it (on the card: a
        wait on its pending fetch) means the orphans resume from the
        true post-launch position."""
        t0 = time.monotonic()
        handle.state = "failed"
        handle.fail_cause = cause
        if self.directory is not None:
            # a router must not send remote-affinity traffic at a corpse
            self.directory.withdraw_owner(handle.name)
        self._endpoints.pop(handle.name, None)
        for eng in _pool_engines(handle.engine):
            if hasattr(eng, "_consume_inflight"):
                eng._consume_inflight()
        self.replica_failures[cause] = \
            self.replica_failures.get(cause, 0) + 1
        self.salvaged_tokens += self._salvage_trie(handle)
        self.orphans_readmitted += self._readmit_orphans(handle)
        if self.placement is not None:
            self.placement.release(handle.name, cause=cause)
        if handle.group_idx is not None:
            self._free_groups.append(handle.group_idx)
            handle.group_idx = None
        now = self._clock()
        dur = max(0.0, now - (handle.last_live_at
                              if handle.last_live_at is not None else now))
        _bucket_observe(self._recovery_counts, dur, RECOVERY_BUCKETS)
        self._recovery_sum += dur
        self.recovery_durations.append(dur)
        self.recovery_host_s += time.monotonic() - t0

    def _salvage_trie(self, handle: ReplicaHandle) -> int:
        """Crash-time twin of :meth:`_handoff_trie`: the dead replica's
        DEVICE blocks died with it, so only trie nodes whose payloads
        already reached the SHARED host tier are snapshotted, forgotten
        from the retiree's own tier budget, and offered to every active
        surviving trie in BFS order (a peer adopts a node only when it
        already holds the node's ancestors).  Returns the number of
        prompt tokens whose K/V landed in at least one survivor."""
        if self.shared_tier is None or not handle.uses_fleet_tier:
            return 0
        entries: List[tuple] = []  # (path_tokens, payload, tenant, ntok)
        own_keys: List[int] = []
        for eng in _pool_engines(handle.engine):
            idx = getattr(eng, "prefix_index", None)
            if idx is None:
                continue
            queue = (list(idx._root.children.values())
                     + list(idx._root.partials))
            i = 0
            while i < len(queue):
                node = queue[i]
                i += 1
                if node.host_key is not None:
                    entry = self.shared_tier.probe(node.host_key)
                    if entry is not None:
                        entries.append(
                            (idx.path_tokens(node), entry.payload,
                             entry.tenant, len(node.tokens)))
                        own_keys.append(node.host_key)
                queue.extend(list(node.children.values()) + node.partials)
        for key in own_keys:
            self.shared_tier.forget(key)
        peers = [p for p in self._replicas
                 if p is not handle and p.state == "active"
                 and p.uses_fleet_tier]
        if self.fabric is not None:
            # salvage over the fabric: one K_CHAIN message per entry per
            # surviving peer from the fleet's own endpoint (the dead
            # replica cannot speak), pumped to quiescence so the count
            # below reflects what actually landed
            offers: List[Tuple[List[Tuple[str, int]], int]] = []
            for tokens, payload, tenant, ntok in entries:
                self.salvage_candidate_tokens += ntok
                body = pack_chain_msg(
                    tenant if isinstance(tenant, str) else "",
                    [(np.asarray(tokens, np.int32), payload)])
                sent = []
                for peer in peers:
                    mid = self._fleet_ep.send(peer.name, K_CHAIN, body)
                    self._chain_weight[("fleet", mid)] = len(tokens)
                    sent.append(("fleet", mid))
                offers.append((sent, ntok))
            self._pump_fabric_to_quiescence()
            salvaged = sum(
                ntok for sent, ntok in offers
                if any(ref in self._adopted_msgs for ref in sent))
            self._adopted_msgs.clear()
            return salvaged
        salvaged = 0
        for tokens, payload, tenant, ntok in entries:
            self.salvage_candidate_tokens += ntok
            adopted_any = False
            for peer in peers:
                key = adopt_into(self.shared_tier,
                                 peer.engine.prefix_index,
                                 tokens, payload, tenant)
                if key is not None:
                    adopted_any = True
            if adopted_any:
                salvaged += ntok
        return salvaged

    def _readmit_orphans(self, handle: ReplicaHandle) -> int:
        """Re-admit every request the dead replica was holding — its
        in-flight slots (by the ``_preempt`` arithmetic, computed
        host-side from the slot's own records), its admission-ring lanes,
        its queued pendings (verbatim), and, for a disagg-pair replica,
        its undelivered migration tickets (the done=1 resume).  Each
        orphan is ROUTED like a fresh arrival (affinity sees the salvaged
        prefixes), then requeued at the FRONT of its lane on the survivor
        in original admission order, carrying its original result object
        so callers' references keep filling in."""
        orphans: List[tuple] = []  # (pending, result)
        for eng in _pool_engines(handle.engine):
            for slot in eng._slots:
                if slot.state == "free":
                    continue
                orphans.append((_slot_resume_pending(slot), slot.result))
            # admission-ring lanes staged for the dead replica's next
            # loop launch: prefilled (their device K/V died with the
            # pool) but never bound into a slot — the staged slot
            # carries the full host-side resume record
            for staged in getattr(eng, "_ring_staged", []):
                orphans.append(
                    (_slot_resume_pending(staged), staged.result))
            eng._ring_staged = []
            for tenant, lane in getattr(eng, "_queue")._lanes.items():
                while lane.items:
                    pending = lane.items.popleft()[1]
                    orphans.append((pending, eng._results[pending.rid]))
        tickets = list(getattr(handle.engine, "_tickets", ()))
        # a disagg-pair replica running its handoffs over the fabric
        # keeps undelivered tickets in the in-flight map and the
        # decode-side arrival queue — both are orphans too
        tickets += list(getattr(handle.engine, "_fabric_inflight",
                                {}).values())
        tickets += list(getattr(handle.engine, "_fabric_arrivals", ()))
        if tickets:
            from .disagg import _ticket_resume_pending
            for ticket in tickets:
                orphans.append(
                    (_ticket_resume_pending(ticket), ticket.result))
        if not orphans:
            return 0
        if not self._active():
            raise RuntimeError(
                f"replica {handle.name!r} failed ({handle.fail_cause}) "
                f"holding {len(orphans)} request(s) with no active "
                f"survivor to recover them onto")
        placed = []
        for pending, result in orphans:
            probe = Request(
                rid=pending.rid, prompt=pending.prompt,
                max_new_tokens=pending.max_new,
                temperature=pending.temperature, rng=pending.rng,
                tenant=pending.tenant)
            target, reason = self.routing.route(self, probe,
                                                self._active())
            self.routing_decisions[reason] = \
                self.routing_decisions.get(reason, 0) + 1
            placed.append((target, pending, result))
        # requeue_front reverses arrival order, so walk the placements
        # backwards: the earliest orphan ends up at the head of its lane
        for target, pending, result in reversed(placed):
            self._place_orphan(target, pending, result)
        return len(placed)

    def _place_orphan(self, handle: ReplicaHandle, pending: _Pending,
                      result: RequestResult) -> None:
        """Hand one orphaned pending to a survivor: re-plan it with the
        survivor's geometry (``_preempt``'s re-plan), transplant the
        result object, and requeue at the front of its tenant lane.  A
        disagg-pair survivor takes it through its own
        ``_forward_resume`` (the resume re-prefills in its prefill
        pool)."""
        target = handle.engine
        if hasattr(target, "_forward_resume"):
            target._results[pending.rid] = result
            target.prefill._results[pending.rid] = result
            target._forward_resume(pending.tenant, pending)
        else:
            ec = target.engine_config
            plan, cover = plan_prefill_chunks(
                pending.prompt.size, ec.prefill_chunk, ec.max_request_len)
            pending.plan = plan
            pending.needed = target.allocator.blocks_for_tokens(
                target._lifetime_rows(pending.prompt.size,
                                      pending.max_new, cover))
            target._results[pending.rid] = result
            target._queue.requeue_front(pending.tenant, pending)
        self._owner[pending.rid] = handle.name

    # ------------------------------------------------------------------
    # the cross-replica cache bus
    # ------------------------------------------------------------------
    def _mirror_from(self, handle: ReplicaHandle):
        """A replica's ``on_tier_demote`` hook: when it demotes a block
        into the shared tier, insert an independent payload copy under
        each ACTIVE sibling's trie (one copy per peer).  A refused put
        ends the loop — the tier has no budget for more mirrors."""
        def on_demote(node, payload: bytes, tenant) -> None:
            src = handle.engine.prefix_index
            tokens = src.path_tokens(node)
            if self.directory is not None:
                # the demoting replica now holds these bytes host-side:
                # publish the prefix key for the remote-affinity path
                self.directory.publish(prefix_fabric_key(tokens),
                                       handle.name,
                                       token_len=len(tokens))
            if self.fabric is not None:
                ep = self._endpoints.get(handle.name)
                if ep is not None:
                    body = pack_chain_msg(
                        tenant if isinstance(tenant, str) else "",
                        [(np.asarray(tokens, np.int32), payload)])
                    for peer in self._replicas:
                        if peer is handle or peer.state != "active" \
                                or not peer.uses_fleet_tier:
                            continue
                        ep.send(peer.name, K_CHAIN, body)
                return
            for peer in self._replicas:
                if peer is handle or peer.state != "active" \
                        or not peer.uses_fleet_tier:
                    continue
                key = adopt_into(self.shared_tier,
                                 peer.engine.prefix_index,
                                 tokens, payload, tenant)
                if key is None:
                    return  # tier refused: no budget for more mirrors
        return on_demote

    def _handoff_trie(self, handle: ReplicaHandle) -> None:
        """Drain completion: move the retiring replica's whole radix
        trie into the shared tier under every surviving trie.  The walk
        SNAPSHOTS first (host payloads probed without LRU touches, every
        device-resident block read back in ONE gather and device-to-host
        copy, then packed in walk order — the bytes a per-block read
        would give), then forgets the retiree's own tier entries (their
        budget funds the mirrors), then re-inserts breadth-first — BFS
        guarantees every node's full-block ancestors were adopted before
        ``adopt_host`` checks for them.  Host seconds and blocks read
        accumulate in ``handoff_host_s`` / ``handoff_blocks``."""
        if self.shared_tier is None or not handle.uses_fleet_tier:
            return
        eng = handle.engine
        idx = getattr(eng, "prefix_index", None)
        if idx is None:
            return
        t0 = time.monotonic()
        entries: List[list] = []  # [path_tokens, payload, tenant]
        device_nodes: List[tuple] = []  # (entry index, node)
        own_keys: List[int] = []
        queue = list(idx._root.children.values()) + list(idx._root.partials)
        i = 0
        while i < len(queue):
            node = queue[i]
            i += 1
            tokens = idx.path_tokens(node)
            if node.host_key is not None:
                entry = self.shared_tier.probe(node.host_key)
                if entry is not None:
                    entries.append([tokens, entry.payload, entry.tenant])
                    own_keys.append(node.host_key)
            else:
                tenant = eng.allocator._tenant_of.get(node.block)
                device_nodes.append((len(entries), node))
                entries.append([tokens, None, tenant])
            queue.extend(list(node.children.values()) + node.partials)
        if device_nodes:
            k, v = eng._read_blocks([node.block for _, node in device_nodes])
            for j, (at, node) in enumerate(device_nodes):
                entries[at][1] = pack_block(node.tokens, k[j], v[j])
            self.handoff_blocks += len(device_nodes)
        for key in own_keys:
            self.shared_tier.forget(key)
        peers = [p for p in self._replicas
                 if p is not handle and p.state == "active"
                 and p.uses_fleet_tier]
        if self.fabric is not None:
            # drain inheritance over the fabric: same bus and delivery
            # contract as salvage, pumped to quiescence so the retiree's
            # cache has landed before retirement returns
            for tokens, payload, tenant in entries:
                body = pack_chain_msg(
                    tenant if isinstance(tenant, str) else "",
                    [(np.asarray(tokens, np.int32), payload)])
                for peer in peers:
                    mid = self._fleet_ep.send(peer.name, K_CHAIN, body)
                    self._chain_weight[("fleet", mid)] = len(tokens)
            self._pump_fabric_to_quiescence()
            self._adopted_msgs.clear()
        else:
            for tokens, payload, tenant in entries:
                for peer in peers:
                    adopt_into(self.shared_tier, peer.engine.prefix_index,
                               tokens, payload, tenant)
        self.handoff_host_s += time.monotonic() - t0

    # ------------------------------------------------------------------
    # the fabric pump
    # ------------------------------------------------------------------
    def _pump_fabric(self) -> None:
        """One delivery round for every live endpoint: drain arrivals
        (adopting K_CHAIN bodies into the receiving replica's trie with
        ``origin="remote"``), then advance every endpoint's virtual clock
        (redelivery + expiry).  Called once per fleet step; salvage and
        drain inheritance loop it to quiescence."""
        if self.fabric is None:
            return
        eps = list(self._endpoints.items())
        if self._fleet_ep is not None:
            eps.append(("fleet", self._fleet_ep))
        live = {h.name: h for h in self._replicas
                if h.state == "active" and h.uses_fleet_tier}
        for name, ep in eps:
            for src, kind, mid, body in ep.poll():
                if kind != K_CHAIN:
                    continue
                handle = live.get(name)
                if handle is None:
                    continue  # delivered to a corpse: acked, discarded
                try:
                    tenant, items = unpack_chain_msg(body)
                except ValueError:
                    continue  # malformed body past the crc: sender bug
                adopted_any = False
                for tokens, payload in items:
                    key = adopt_into(self.shared_tier,
                                     handle.engine.prefix_index,
                                     tokens, payload, tenant or None,
                                     origin="remote")
                    if key is not None:
                        adopted_any = True
                        if self.directory is not None:
                            self.directory.publish(
                                prefix_fabric_key(tokens), name,
                                token_len=len(tokens))
                if adopted_any:
                    self._adopted_msgs.add((src, mid))
                    self.fabric_adopted_tokens += self._chain_weight.get(
                        (src, mid), 0)
        for name, ep in eps:
            ep.tick()
            for dest, kind, mid, body in ep.take_expired():
                self.fabric_expired_chains += 1
                self._chain_weight.pop((name, mid), None)

    def _pump_fabric_to_quiescence(self) -> None:
        """Pump until no endpoint holds an unacked message — every frame
        either delivered (ack processed) or TTL-expired.  Bounded: each
        pump ticks every endpoint once, and an outbox empties within its
        TTL."""
        if self.fabric is None:
            return
        for _ in range(self._fabric_ttl * 4 + 8):
            eps = list(self._endpoints.values())
            if self._fleet_ep is not None:
                eps.append(self._fleet_ep)
            if not any(ep.inflight for ep in eps):
                break
            self._pump_fabric()
        self._pump_fabric()  # trailing acks

    def _route_drop(self, entry) -> None:
        """Shared tier's budget-eviction hook: route the dying entry to
        whichever live replica's trie holds its node (a mirror evicted
        before ``bind_node`` has no trie presence — nothing to
        detach)."""
        if entry.node is None:
            return
        for handle in self._replicas:
            if handle.state in ("retired", "failed") \
                    or not handle.uses_fleet_tier:
                continue
            if handle.engine.prefix_index.owns(entry.node):
                handle.engine._drop_host_entry(entry)
                return

    # ------------------------------------------------------------------
    # the engine-shaped surface
    # ------------------------------------------------------------------
    def submit(self, request: Request) -> RequestResult:
        candidates = self._active()
        if not candidates:
            raise RuntimeError(
                "fleet has no active replicas to route to")
        handle, reason = self.routing.route(self, request, candidates)
        if handle.state != "active":
            raise RuntimeError(
                f"routing policy {type(self.routing).__name__} picked "
                f"non-active replica {handle.name!r} ({handle.state})")
        self.routing_decisions[reason] = \
            self.routing_decisions.get(reason, 0) + 1
        result = handle.engine.submit(request)
        self._owner[request.rid] = handle.name
        self._results[request.rid] = result
        return result

    def step(self) -> bool:
        """One fleet iteration: advance every live replica under the
        health monitor, retire any drain that completed, and consult the
        scaling policy on its cadence.  Returns False only when every
        live replica is drained-and-idle.

        The monitor is two independent detectors per replica.  LIVENESS:
        a step that raises
        :class:`~kubeshare_tpu_torch.serving.chaos.ReplicaKilled` is a
        missed epoch; ``liveness_grace`` consecutive misses declare the
        replica dead.  WATCHDOG: with ``watchdog_budget_s`` set, a step
        whose clock time blows the budget (scaled by the launch's unit
        depth) is a trip; ``watchdog_grace`` consecutive trips declare
        the replica hung.  Both streaks reset on any healthy step."""
        worked = False
        for handle in self._replicas:
            if handle.state in ("retired", "failed"):
                continue
            t0 = self._clock()
            healthy = False
            try:
                worked |= handle.engine.step()
            except ReplicaKilled:
                handle.missed_epochs += 1
                # detection-in-progress IS work: keep stepping until the
                # grace budget declares the replica dead, or run() could
                # return with orphans stranded
                worked = True
            else:
                handle.missed_epochs = 0
                healthy = True
            if self.watchdog_budget_s is not None \
                    and self._clock() - t0 > self._step_budget_s(handle):
                handle.watchdog_trips += 1
            else:
                handle.watchdog_trips = 0
                if healthy:
                    handle.last_live_at = self._clock()
            cause = None
            if handle.missed_epochs >= self.liveness_grace:
                cause = "liveness"
            elif self.watchdog_budget_s is not None \
                    and handle.watchdog_trips >= self.watchdog_grace:
                cause = "watchdog"
            if cause is not None:
                self._recover_replica(handle, cause)
                worked = True
        self._finish_drains()
        self._pump_fabric()
        self._steps += 1
        if self._tuner is not None:
            self._tuner.tick()
        if self.scaling is not None \
                and self._steps % self.autoscale_every == 0:
            self._autoscale_tick()
        return worked

    def _step_budget_s(self, handle: ReplicaHandle) -> float:
        """The watchdog budget for ONE step of this replica: the
        per-dispatch budget scaled by the unit depth of the replica's
        most recent launch (``last_launch_units``) — a K-unit loop
        launch legitimately does K dispatches' work in one step, while a
        stuck dispatch still trips at K times the budget."""
        units = max((getattr(e, "last_launch_units", 1)
                     for e in _pool_engines(handle.engine)), default=1)
        return self.watchdog_budget_s * max(1, units)

    def _autoscale_tick(self) -> None:
        decision = self.scaling.decide(self)
        if decision is None:
            return
        if decision == "up":
            if self.can_grow():
                self.scale_up()
            return
        if decision == "down" or decision.startswith("down:"):
            active = self._active()
            if len(active) - 1 < self.min_replicas:
                return
            if ":" in decision:
                name = decision.split(":", 1)[1]
            else:
                probes = {h.name: h.engine.load_probe() for h in active}
                name = min(active,
                           key=lambda h: (_load_key(probes[h.name]),
                                          h.name)).name
            self.drain(name)
            return
        raise ValueError(
            f"scaling policy returned {decision!r} — expected 'up', "
            f"'down', 'down:<name>' or None")

    def run(self) -> Dict[str, RequestResult]:
        """Drain everything; returns results by request id."""
        try:
            while self.step():
                pass
        finally:
            done = set()
            for handle in self._replicas:
                for eng in _pool_engines(handle.engine):
                    if eng.guard is not None \
                            and id(eng.guard) not in done:
                        done.add(id(eng.guard))
                        eng.guard.finish()
        return dict(self._results)

    @property
    def idle(self) -> bool:
        return all(h.engine.idle for h in self._replicas
                   if h.state not in ("retired", "failed"))

    def result(self, rid: str) -> RequestResult:
        return self._results[rid]

    def owner_of(self, rid: str) -> str:
        """Which replica a request was routed to (sticks after the
        replica retires) — observability and test hook."""
        return self._owner[rid]

    def pop_finished(self) -> Dict[str, RequestResult]:
        done = {rid: r for rid, r in self._results.items() if r.done}
        for rid in done:
            del self._results[rid]
            del self._owner[rid]
        for handle in self._replicas:
            handle.engine.pop_finished()
        return done

    def warmup(self) -> None:
        for handle in self._replicas:
            if handle.state not in ("retired", "failed"):
                handle.engine.warmup()

    def capture_counts(self) -> Dict[str, int]:
        """Every replica's programs by kind (on the card, captured CUDA
        graphs), keys prefixed with the replica name; retired and failed
        replicas included — their counts are frozen, so any growth after
        warm-up is a live capture.  The JAX fleet's ``compile_counts``."""
        counts: Dict[str, int] = {}
        for handle in self._replicas:
            for k, v in handle.engine.capture_counts().items():
                counts[f"{handle.name}.{k}"] = v
        return counts

    def _ttft_counts_snapshot(self) -> List[int]:
        """Cumulative TTFT bucket counts merged over every non-retired
        replica — the autoscaler's interval-diff raw material."""
        counts = [0] * (len(TTFT_BUCKETS) + 1)
        for handle in self._replicas:
            if handle.state in ("retired", "failed"):
                continue
            for eng in _pool_engines(handle.engine):
                for i, c in enumerate(eng._ttft_counts):
                    counts[i] += c
        return counts

    # ------------------------------------------------------------------
    def collect_metrics(self) -> List[MetricFamily]:
        """Every replica's families merged (the ``replica`` label keeps
        per-request series distinct; unlabeled counters sum), plus the
        fleet's own families.  The shared tier's store-level series — its
        byte gauges and the ``host_evicted`` counter — are reported once,
        not once per replica reading the same store; replicas with
        private tiers (factory-built disagg pairs) still sum."""
        merged: Dict[str, MetricFamily] = {}
        seen_shared = False
        for handle in self._replicas:
            dedup = (self.shared_tier is not None
                     and handle.uses_fleet_tier and seen_shared)
            if self.shared_tier is not None and handle.uses_fleet_tier:
                seen_shared = True
            for fam in handle.engine.collect_metrics():
                if dedup:
                    if fam.name == "kubeshare_serving_tier_host_bytes":
                        continue
                    if fam.name == "kubeshare_serving_tier_blocks_total":
                        fam.samples = [
                            s for s in fam.samples
                            if s.labels.get("event") != "host_evicted"]
                have = merged.get(fam.name)
                if have is None:
                    merged[fam.name] = fam
                    continue
                self._merge_samples(have, fam)
        states = {"active": 0, "draining": 0, "retired": 0, "failed": 0}
        for handle in self._replicas:
            states[handle.state] += 1
        replicas = MetricFamily(
            "kubeshare_serving_fleet_replicas",
            "Replicas by lifecycle state", kind="gauge")
        for state, n in states.items():
            replicas.add({"state": state}, n)
        routing = MetricFamily(
            "kubeshare_serving_fleet_routing_decisions_total",
            "Routing decisions by reason (affinity = longest cached "
            "prefix won; least_loaded = no cached prefix anywhere, or "
            "tie; spill = affinity target saturated or a Guarantee "
            "request would have queued there)")
        for reason, n in sorted(self.routing_decisions.items()):
            routing.add({"reason": reason}, n)
        scale = MetricFamily(
            "kubeshare_serving_fleet_scale_events_total",
            "Fleet size changes by direction (up = replica added, "
            "down = drain initiated)")
        for direction, n in sorted(self.scale_events.items()):
            scale.add({"direction": direction}, n)
        drain = MetricFamily(
            "kubeshare_serving_fleet_drain_seconds",
            "Drain duration: admission stop to retirement (the slowest "
            "in-flight lane's remaining lifetime)", kind="histogram")
        _histogram_samples(drain, "kubeshare_serving_fleet_drain_seconds",
                           {}, self._drain_counts, self._drain_sum,
                           DRAIN_BUCKETS)
        failures = MetricFamily(
            "kubeshare_serving_fleet_replica_failures_total",
            "Replicas declared dead by the health monitor, by cause "
            "(liveness = consecutive crashed steps; watchdog = "
            "consecutive over-budget steps, the hung-dispatch "
            "signature)")
        for cause, n in sorted(self.replica_failures.items()):
            failures.add({"cause": cause}, n)
        salvaged = MetricFamily(
            "kubeshare_serving_fleet_salvaged_prefix_tokens_total",
            "Prompt tokens whose K/V was recovered from a dead "
            "replica's host-tier trie slice into at least one "
            "survivor's trie")
        salvaged.add({}, self.salvaged_tokens)
        orphans = MetricFamily(
            "kubeshare_serving_fleet_orphans_readmitted_total",
            "Dead replicas' queued and in-flight requests re-admitted "
            "on survivors through the preemption-resume contract")
        orphans.add({}, self.orphans_readmitted)
        recovery = MetricFamily(
            "kubeshare_serving_fleet_recovery_seconds",
            "Replica crash recovery latency: last proof of life to "
            "recovery complete (salvage + orphan re-admission + cell "
            "reclaim; detection grace included)", kind="histogram")
        _histogram_samples(
            recovery, "kubeshare_serving_fleet_recovery_seconds", {},
            self._recovery_counts, self._recovery_sum, RECOVERY_BUCKETS)
        if self._tuner is not None:
            # the fleet tuner's own decisions join the merged tuner
            # family (replica engines' samples carry replica labels, so
            # scope=fleet samples never collide)
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
                         "scope": "fleet"}, n)
        out = (list(merged.values())
               + [replicas, routing, scale, drain, failures, salvaged,
                  orphans, recovery])
        if self.fabric is not None:
            eps = list(self._endpoints.values())
            if self._fleet_ep is not None:
                eps.append(self._fleet_ep)
            out.extend(fabric_metric_families(eps))
            adopted = MetricFamily(
                "kubeshare_serving_fabric_chain_tokens_adopted_total",
                "Prompt tokens whose K/V landed in a receiving "
                "replica's trie via a fabric chain message")
            adopted.add({}, self.fabric_adopted_tokens)
            expired = MetricFamily(
                "kubeshare_serving_fabric_chains_expired_total",
                "Chain messages the fabric gave up on (TTL exhausted "
                "before any ack) — lost mirrors/salvage, never "
                "corruption")
            expired.add({}, self.fabric_expired_chains)
            out.extend([adopted, expired])
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
                merged = Sample(have.name, have.labels,
                                have.value + s.value)
                dst.samples[dst.samples.index(have)] = merged
                index[key] = merged
