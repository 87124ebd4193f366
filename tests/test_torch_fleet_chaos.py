"""Port parity: the replica fleet of kubeshare_tpu_torch.serving under
seeded chaos, against the JAX package's fleet on the CPU — the fleet
tests of tests/test_chaos.py (replica kills, the speculative loop under a
kill and under the watchdog, the placement reclaim, the watchdog, drain
inheritance over a faulty fabric) and tests/test_serving.py's fleet
fabric cases (remote affinity through the directory, drain inheritance
riding the fabric).

A kill, a hang, a drain and a faulty fabric leave every stream of the
port's fleet (``device="cpu"``) equal to its fault-free run, greedy and
sampled; greedy streams, failures and orphan counts equal JAX's fleet
under the same plan.  The speculative cases run the copy model of
tests/test_torch_engine.py (its greedy pick is a fixed 3-cycle of its
input token, so drafts are accepted and the speculative loop launches,
which the JAX run asserts).  Each JAX fleet runs once, in a
module-scoped fixture, unwarmed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubeshare_tpu.serving as jax_serving
import kubeshare_tpu.serving.chaos as jax_chaos
import kubeshare_tpu_torch.serving.chaos as port_chaos
from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models.decoding import greedy_decode
from kubeshare_tpu_torch.models.transformer import TransformerConfig
from kubeshare_tpu_torch.serving import (EngineConfig, LoopbackTransport,
                                         ReplicaFleet, Request,
                                         prefix_fabric_key)
from kubeshare_tpu_torch.serving.chaos import FaultClock, FaultPlan
from kubeshare_tpu_torch.serving.metrics_view import (flatten_metrics,
                                                      metric_value)

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=64, attention="reference")
REPLICA = dict(num_slots=3, block_size=4, num_blocks=21, max_request_len=48,
               prefill_chunk=8)
FLEET_KWARGS = ("routing", "tenants", "shared_tier_bytes", "fault_clock",
                "liveness_grace", "watchdog_budget_s", "watchdog_grace",
                "fabric", "fabric_ttl_ticks", "placement")
# the speculative loop's fleet: everything pinned to r0, an admission ring
SPEC_LOOP = dict(num_blocks=41, speculative=True, steps_per_launch=4,
                 admission_ring=2)


def _copy_params(jp):
    """The copy model: greedy picks t -> t's successor in its group of
    three (63 repeats)."""
    def scale(tree):
        return {k: scale(v) if isinstance(v, dict) else v * 1e-3
                for k, v in tree.items()}

    nxt = np.arange(64)
    nxt[:63] = 3 * (nxt[:63] // 3) + (nxt[:63] % 3 + 1) % 3
    layers = [{**layer, "attn": scale(layer["attn"]),
               "mlp": scale(layer["mlp"])} for layer in jp["layers"]]
    return {**jp, "layers": layers,
            "lm_head": jp["embed"][np.argsort(nxt)].T}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, extra in (("plain", {}),
                        ("gqa_rope", dict(n_kv_heads=2, positional="rope"))):
        jax_cfg = JaxConfig(dtype=jnp.float32, **MODEL, **extra)
        jp = jax.device_get(jax_init(jax.random.PRNGKey(0), jax_cfg))
        out[name] = (jax_cfg, jp,
                     TransformerConfig(dtype=torch.float32, **MODEL, **extra),
                     params_from_jax(jp, "cpu"))
    jax_cfg, jp, cfg, _ = out["plain"]
    copy = _copy_params(jp)
    out["copy"] = (jax_cfg, copy, cfg, params_from_jax(copy, "cpu"))
    return out


def _fleet(model, *, replicas=2, **overrides):
    _, _, cfg, tp = model
    fleet_kwargs = {k: overrides.pop(k) for k in FLEET_KWARGS
                    if k in overrides}
    return ReplicaFleet(tp, cfg, EngineConfig(**{**REPLICA, **overrides}),
                        replicas=replicas, device="cpu", **fleet_kwargs)


def _jax_fleet(model, *, replicas=2, **overrides):
    jax_cfg, jp, _, _ = model
    fleet_kwargs = {k: overrides.pop(k) for k in FLEET_KWARGS
                    if k in overrides}
    return jax_serving.ReplicaFleet(
        jp, jax_cfg, jax_serving.EngineConfig(**{**REPLICA, **overrides}),
        replicas=replicas, **fleet_kwargs)


def _metric(families, name, **labels):
    total = 0.0
    for fam in families:
        for s in fam.samples:
            if s.name == name and all(
                    s.labels.get(k) == v for k, v in labels.items()):
                total += s.value
    return total


def _streams(results):
    return {rid: r.tokens for rid, r in results.items()}


class _PinFirst:
    """Route everything to the first live candidate — keeps the doomed
    replica's ownership deterministic."""

    def route(self, fleet, request, candidates):
        return candidates[0], "least_loaded"


def _mixed_trace():
    """tests/test_chaos.py's 8 requests over a shared-prefix family; every
    third one samples (greedy here when the caller asks for JAX)."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 64, 12)
    out = []
    for i in range(8):
        if i % 2 == 0:
            prompt = np.concatenate([shared, rng.integers(0, 64, 4)])
        else:
            prompt = rng.integers(0, 64, 10)
        out.append((f"r{i}", prompt, 6, i % 3 == 0))
    return out


def _spec_trace():
    """tests/test_torch_engine.py's speculative trace: s4 and s6 share
    s0's first 14 tokens; every third request samples when asked."""
    rng = np.random.default_rng(13)
    base = rng.integers(0, 63, 16)

    def shared():
        return np.concatenate([base[:14], rng.integers(0, 63, 8)])

    trace = [("s0", np.concatenate([base, rng.integers(0, 63, 8)]), 4),
             ("s1", rng.integers(0, 63, 8), 13),
             ("s2", rng.integers(0, 63, 16), 17),
             ("s3", rng.integers(0, 63, 8), 9),
             ("s4", shared(), 6),
             ("s5", rng.integers(0, 63, 8), 11),
             ("s6", shared(), 7)]
    return [(rid, p, n, i % 3 == 2) for i, (rid, p, n) in enumerate(trace)]


def _requests(trace, sampled=True, seed=70):
    return [Request(rid, p, n, temperature=0.8,
                    rng=torch.Generator().manual_seed(seed + i))
            if hot and sampled else Request(rid, p, n)
            for i, (rid, p, n, hot) in enumerate(trace)]


def _jax_submit(fleet, trace):
    for rid, prompt, new, _ in trace:
        fleet.submit(jax_serving.Request(rid, prompt.astype(np.int32), new))


@pytest.fixture(scope="module")
def jax_runs(models):
    """JAX's fleet, greedy, once each: the mixed trace under a kill of r1
    at its step 2, the copy model's speculative loop fault-free, and a
    drain over the faulty fabric."""
    out = {}
    clock = jax_chaos.FaultClock(jax_chaos.FaultPlan(seed=7).kill(
        "r1", at_step=2))
    fleet = _jax_fleet(models["plain"], shared_tier_bytes=1 << 20,
                       fault_clock=clock)
    _jax_submit(fleet, _mixed_trace())
    streams = _streams(fleet.run())
    out["kill"] = (streams, {r: fleet.owner_of(r) for r in streams},
                   dict(fleet.replica_failures), fleet.orphans_readmitted)
    fleet = _jax_fleet(models["copy"], routing=_PinFirst(), **SPEC_LOOP)
    _jax_submit(fleet, _spec_trace())
    streams = _streams(fleet.run())
    eng = fleet._handle("r0").engine
    # the premise: speculation engaged on the copy model
    assert eng.spec_loop_launches > 0
    assert 2 * sum(eng.spec_accepted.values()) > sum(
        eng.spec_drafted.values())
    out["spec"] = streams
    clock = jax_chaos.FaultClock(_fabric_plan(jax_chaos))
    fleet = _jax_fleet(models["plain"], shared_tier_bytes=1 << 20,
                       fault_clock=clock,
                       fabric=jax_serving.LoopbackTransport(),
                       fabric_ttl_ticks=12)
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 64, 16)
    fleet.submit(jax_serving.Request("seed", np.concatenate(
        [shared, rng.integers(0, 64, 4)]).astype(np.int32), 4))
    fleet.run()
    owner = fleet.owner_of("seed")
    fleet.drain(owner)
    fleet.run()
    survivor = [h for h in fleet.replicas if h.name != owner][0]
    eps = list(fleet._endpoints.values()) + [fleet._fleet_ep]
    out["fabric"] = dict(
        events=list(clock.events),
        inherited=survivor.engine.prefix_match_len(shared),
        adopted=fleet.fabric_adopted_tokens,
        chains={k: v for ep in eps for k, v in ep.messages.items()
                if k[0] == "chain"})
    return out


# -- TestReplicaKillRecovery -------------------------------------------------

def test_kill_mid_trace_bit_exact_greedy_and_sampled(models, jax_runs):
    """Kill r1 mid-trace: every stream, greedy and sampled (top_k 10,
    top_p 0.95), including the orphans', equals the fault-free fleet's,
    the survivor captures nothing new, the metrics plane shows the
    failure; on the greedy trace the streams, owners, failures and orphan
    count equal JAX's fleet under the same plan."""
    model = models["gqa_rope"]

    def run_arm(fault_clock=None):
        fleet = _fleet(model, top_k=10, top_p=0.95,
                       shared_tier_bytes=1 << 20, fault_clock=fault_clock)
        fleet.warmup()
        base = fleet.capture_counts()
        for r in _requests(_mixed_trace()):
            fleet.submit(r)
        return fleet, base, _streams(fleet.run())

    _, _, want = run_arm()
    fleet, base, got = run_arm(FaultClock(FaultPlan(seed=7).kill(
        "r1", at_step=2)))
    assert got == want
    assert fleet.replica_failures == {"liveness": 1}
    assert fleet._handle("r1").state == "failed"
    assert fleet._handle("r1").fail_cause == "liveness"
    assert fleet.orphans_readmitted > 0
    after = fleet.capture_counts()
    for k, v in base.items():
        if not k.startswith("r1"):
            assert after[k] == v, k
    fams = fleet.collect_metrics()
    assert _metric(fams, "kubeshare_serving_fleet_replica_failures_total",
                   cause="liveness") == 1
    assert _metric(fams, "kubeshare_serving_fleet_recovery_seconds_count") \
        == 1
    assert _metric(fams, "kubeshare_serving_fleet_replicas",
                   state="failed") == 1

    want_streams, want_owners, want_failures, want_orphans = jax_runs["kill"]
    fleet = _fleet(models["plain"], shared_tier_bytes=1 << 20,
                   fault_clock=FaultClock(FaultPlan(seed=7).kill(
                       "r1", at_step=2)))
    for r in _requests(_mixed_trace(), sampled=False):
        fleet.submit(r)
    got = _streams(fleet.run())
    assert got == want_streams
    assert {r: fleet.owner_of(r) for r in got} == want_owners
    assert fleet.replica_failures == want_failures
    assert fleet.orphans_readmitted == want_orphans


def test_replay_same_plan_same_faults_same_streams(models):
    def run_once():
        clock = FaultClock(FaultPlan(seed=7).kill("r1", at_step=3))
        fleet = _fleet(models["plain"], shared_tier_bytes=1 << 20,
                       fault_clock=clock)
        fleet.warmup()
        for r in _requests(_mixed_trace()):
            fleet.submit(r)
        return clock.events, _streams(fleet.run())

    events_a, streams_a = run_once()
    events_b, streams_b = run_once()
    assert events_a == events_b
    assert streams_a == streams_b
    assert any(e[0] == "kill" for e in events_a)


def test_orphan_lands_on_survivor_with_salvaged_prefix(models):
    """The dead replica's host-resident trie is salvaged into the
    survivor through the shared tier; the orphan resumes there
    mid-stream and equals the dense greedy decode."""
    _, _, cfg, tp = models["plain"]
    plan = FaultPlan(seed=11)
    clock = FaultClock(plan)
    fleet = _fleet(models["plain"], num_slots=2, num_blocks=13,
                   max_request_len=32, routing=_PinFirst(),
                   shared_tier_bytes=1 << 20, fault_clock=clock)
    fleet.warmup()
    rng = np.random.default_rng(13)
    shared = rng.integers(0, 64, 16)
    fleet.submit(Request(
        "warm", np.concatenate([shared, rng.integers(0, 64, 4)]), 4))
    fleet.run()
    owner = fleet.owner_of("warm")
    oeng = fleet._handle(owner).engine
    for i in range(3):
        fleet.submit(Request(f"p{i}", rng.integers(0, 64, 20), 4))
        fleet.run()
    assert oeng.tier_demoted_blocks > 0
    survivor = [h for h in fleet.replicas if h.name != owner][0]
    prompt = np.concatenate([shared, rng.integers(0, 64, 4)])
    fleet.submit(Request("orphan", prompt, 10))
    while True:
        slots = [s for s in oeng._slots
                 if s.rid == "orphan" and s.state == "decode"]
        if slots and len(slots[0].generated) >= 2:
            break
        assert fleet.step(), "fleet idle before the orphan decoded"
    plan.kill(owner, at_step=clock._steps.get(owner, 0))
    out = fleet.run()
    ref = greedy_decode(tp, cfg, torch.from_numpy(prompt)[None], 10)[0]
    assert out["orphan"].tokens == ref.tolist()
    assert fleet.owner_of("orphan") == survivor.name
    assert fleet.salvaged_tokens > 0
    assert fleet.salvage_candidate_tokens >= fleet.salvaged_tokens
    assert survivor.engine.prefix_match_len(shared) >= 16
    fams = fleet.collect_metrics()
    assert _metric(
        fams, "kubeshare_serving_fleet_salvaged_prefix_tokens_total") > 0
    assert _metric(
        fams, "kubeshare_serving_fleet_orphans_readmitted_total") >= 1


# -- TestSpecLoopChaos -------------------------------------------------------

def _spec_fleet(models, fault_clock=None, **kw):
    return _fleet(models["copy"], routing=_PinFirst(), top_k=10, top_p=0.95,
                  fault_clock=fault_clock, **SPEC_LOOP, **kw)


def _greedy(streams, trace):
    return {rid: streams[rid] for rid, _, _, hot in trace if not hot}


def test_kill_at_loop_boundary_drains_ring_bit_exact(models, jax_runs):
    """Kill r0 while a speculative loop launch is in flight: recovery
    consumes it first (emissions, retirements, ring activations), then
    re-admits the orphans; every stream equals the fault-free run's,
    whose greedy streams equal JAX's."""
    trace = _spec_trace()
    ref = _spec_fleet(models)
    ref.warmup()
    for r in _requests(trace):
        ref.submit(r)
    want = _streams(ref.run())
    assert _greedy(want, trace) == _greedy(jax_runs["spec"], trace)
    assert ref._handle("r0").engine.spec_loop_launches > 0

    plan = FaultPlan(seed=31)
    clock = FaultClock(plan)
    fleet = _spec_fleet(models, clock)
    fleet.warmup()
    for r in _requests(trace):
        fleet.submit(r)
    eng = fleet._handle("r0").engine
    while not (eng._inflight is not None
               and eng._inflight[0] == "spec_loop"):
        assert fleet.step(), \
            "trace drained before a spec-loop launch was in flight"
    plan.kill("r0", at_step=clock._steps.get("r0", 0))
    got = _streams(fleet.run())
    assert got == want
    assert fleet.replica_failures == {"liveness": 1}
    assert eng._inflight is None
    assert eng._ring_staged == []
    assert fleet.orphans_readmitted > 0


def test_watchdog_budget_covers_k_unit_launches(models):
    """A healthy K-unit loop launch takes K dispatches' time in one step:
    the watchdog budgets it by ``last_launch_units``.  The injected delay
    is over the per-dispatch budget but inside K times it."""
    trace = _spec_trace()
    clock = FaultClock(FaultPlan(seed=37))
    fleet = _spec_fleet(models, clock)
    fleet.warmup()
    results = {r.rid: fleet.submit(r) for r in _requests(trace)}
    eng = fleet._handle("r0").engine
    loop_ordinals = []
    while fleet.step():
        if eng._inflight is not None and eng._inflight[0] == "spec_loop":
            assert eng.last_launch_units == SPEC_LOOP["steps_per_launch"]
            loop_ordinals.append(clock._dispatches["r0"] - 1)
    want = _streams(results)
    assert loop_ordinals, "trace never engaged the spec loop"

    budget, delay = 0.05, 0.12
    assert budget < delay < 4 * budget
    plan = FaultPlan(seed=37)
    for n in loop_ordinals:
        plan.slow_dispatch("r0", n, delay)
    clock2 = FaultClock(plan)
    fleet2 = _spec_fleet(models, clock2, watchdog_budget_s=budget,
                         watchdog_grace=1)
    fleet2.warmup()
    for r in _requests(trace):
        fleet2.submit(r)
    assert _streams(fleet2.run()) == want
    assert fleet2.replica_failures == {}
    assert fleet2._handle("r0").state == "active"
    assert sum(1 for e in clock2.events
               if e[0] == "slow_dispatch") == len(loop_ordinals)


# -- TestPlacementReclaim ----------------------------------------------------

def test_crash_releases_cell_through_pod_deleted_path(models):
    """A killed replica's fractional cell is reclaimed through JAX's
    placement plane's pod-deleted path, with the crash as its cause."""
    from test_torch_fleet import FRACTION, _plane

    plane, cluster = _plane(**FRACTION)
    clock = FaultClock(FaultPlan(seed=5).kill("r1", at_step=1))
    fleet = _fleet(models["plain"], placement=plane, fault_clock=clock)
    assert len(cluster.list_pods(namespace="serving")) == 2
    fleet.warmup()
    rng = np.random.default_rng(3)
    for i in range(4):
        fleet.submit(Request(f"q{i}", rng.integers(0, 64, 10), 4))
    out = fleet.run()
    assert fleet.replica_failures == {"liveness": 1}
    assert all(len(r.tokens) == 4 for r in out.values())
    assert len(cluster.list_pods(namespace="serving")) == 1
    assert plane.release_causes == {"liveness": 1}


# -- TestWatchdog ------------------------------------------------------------

def _decode_dispatch_ordinal(fleet, clock, label, rid):
    eng = fleet._handle(label).engine
    while True:
        slots = [s for s in eng._slots
                 if s.rid == rid and s.state == "decode"]
        if slots and len(slots[0].generated) >= 1:
            return clock._dispatches.get(label, 0)
        assert fleet.step(), "fleet idle before target decoded"


def test_slow_dispatch_below_budget_is_not_a_failure(models):
    plan = FaultPlan(seed=3)
    clock = FaultClock(plan)
    fleet = _fleet(models["plain"], routing=_PinFirst(), fault_clock=clock,
                   watchdog_budget_s=0.05, watchdog_grace=2)
    fleet.warmup()
    rng = np.random.default_rng(17)
    fleet.submit(Request("slowpoke", rng.integers(0, 64, 10), 12))
    n = _decode_dispatch_ordinal(fleet, clock, "r0", "slowpoke")
    for k in range(4):
        plan.slow_dispatch("r0", n + k, 0.02)
    out = fleet.run()
    assert fleet.replica_failures == {}
    assert fleet._handle("r0").state == "active"
    assert len(out["slowpoke"].tokens) == 12
    assert sum(1 for e in clock.events if e[0] == "slow_dispatch") >= 1


def test_hung_dispatch_trips_watchdog_and_stream_survives(models):
    _, _, cfg, tp = models["plain"]
    plan = FaultPlan(seed=3)
    clock = FaultClock(plan)
    fleet = _fleet(models["plain"], routing=_PinFirst(),
                   shared_tier_bytes=1 << 20, fault_clock=clock,
                   watchdog_budget_s=0.05, watchdog_grace=2)
    fleet.warmup()
    rng = np.random.default_rng(19)
    prompt = rng.integers(0, 64, 10)
    fleet.submit(Request("victim", prompt, 12))
    n = _decode_dispatch_ordinal(fleet, clock, "r0", "victim")
    for k in range(4):
        plan.slow_dispatch("r0", n + k, 10.0)
    out = fleet.run()
    assert fleet.replica_failures == {"watchdog": 1}
    assert fleet._handle("r0").fail_cause == "watchdog"
    ref = greedy_decode(tp, cfg, torch.from_numpy(prompt)[None], 12)[0]
    assert out["victim"].tokens == ref.tolist()
    fams = fleet.collect_metrics()
    assert _metric(fams, "kubeshare_serving_fleet_replica_failures_total",
                   cause="watchdog") == 1
    assert _metric(fams,
                   "kubeshare_serving_fleet_recovery_seconds_sum") >= 20.0


# -- TestFabricChaos / TestFabric: the fleet over the KV fabric ---------------

def _drain_over_fabric(model, clock, ttl):
    fleet = _fleet(model, shared_tier_bytes=1 << 20, fault_clock=clock,
                   fabric=LoopbackTransport(), fabric_ttl_ticks=ttl)
    fleet.warmup()
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 64, 16)

    def req(rid):
        return Request(rid, np.concatenate(
            [shared, rng.integers(0, 64, 4)]), 4)

    streams = {}
    fleet.submit(req("seed"))
    streams.update(_streams(fleet.run()))
    owner = fleet.owner_of("seed")
    survivor = [h for h in fleet.replicas if h.name != owner][0]
    assert survivor.engine.prefix_match_len(shared) == 0
    fleet.drain(owner)
    fleet.run()
    assert fleet._handle(owner).state == "retired"
    inherited = survivor.engine.prefix_match_len(shared)
    fleet.submit(req("heir"))
    streams.update(_streams(fleet.run()))
    return fleet, streams, owner, survivor, inherited


def _fabric_plan(mod):
    """tests/test_chaos.py's faulty fabric: early frames dropped,
    corrupted, duplicated and reordered (ordinals count every transmit)."""
    plan = mod.FaultPlan(seed=21)
    for n in (0, 5):
        plan.drop_fabric(n)
    return plan.corrupt_fabric(2).duplicate_fabric(3).reorder_fabric(7)


def test_fleet_drain_over_faulty_fabric_bit_exact(models, jax_runs):
    """Drain inheritance over a fabric that drops, duplicates, reorders
    and corrupts frames: redelivery recovers every chain, the streams
    equal the fault-free fleet's, and the send-side counters reconcile."""
    clock = FaultClock(_fabric_plan(port_chaos))
    chaotic, got, _, _, inherited = _drain_over_fabric(models["plain"],
                                                       clock, 12)
    _, want, _, _, _ = _drain_over_fabric(models["plain"], None, 12)
    assert got == want
    # JAX's fleet under the same plan: the same faults, the same inherited
    # prefix, the same adopted tokens and chain messages
    assert clock.events == jax_runs["fabric"]["events"]
    assert inherited == jax_runs["fabric"]["inherited"]
    assert chaotic.fabric_adopted_tokens == jax_runs["fabric"]["adopted"]
    faults = {e[0] for e in clock.events}
    assert "drop_fabric" in faults and "corrupt_fabric" in faults
    eps = list(chaotic._endpoints.values()) + [chaotic._fleet_ep]
    assert all(ep.inflight == 0 for ep in eps)
    sent = sum(ep.messages.get(("chain", "sent"), 0) for ep in eps)
    delivered = sum(ep.messages.get(("chain", "delivered"), 0) for ep in eps)
    expired = sum(ep.messages.get(("chain", "expired"), 0) for ep in eps)
    assert sent > 0 and delivered + expired == sent
    assert sum(ep.redeliveries for ep in eps) > 0
    assert {k: v for ep in eps for k, v in ep.messages.items()
            if k[0] == "chain"} == jax_runs["fabric"]["chains"]
    assert _metric(chaotic.collect_metrics(),
                   "kubeshare_serving_fabric_redeliveries_total") > 0
    assert chaotic.fabric_adopted_tokens > 0


def test_remote_affinity_routes_via_directory(models):
    """A trie miss everywhere + a directory hit routes to the publishing
    owner (reason remote_affinity); a withdrawn owner falls back to
    least-loaded."""
    fleet = _fleet(models["plain"], shared_tier_bytes=1 << 20,
                   fabric=LoopbackTransport())
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 64, 14)
    target = fleet.replicas[1].name
    fleet.directory.publish(prefix_fabric_key(prompt[:12]), target,
                            token_len=12)
    fleet.submit(Request("q", prompt, 3))
    fleet.run()
    assert fleet.owner_of("q") == target
    assert fleet.routing_decisions["remote_affinity"] == 1
    fleet.directory.withdraw_owner(target)
    fleet.submit(Request("q2", rng.integers(0, 64, 14), 3))
    fleet.run()
    assert fleet.routing_decisions["remote_affinity"] == 1


def test_fleet_drain_inheritance_rides_the_fabric(models):
    """The retiree's trie crosses to the survivor as acked K_CHAIN
    messages, the directory learns the adopter, and the heir promotes
    remotely adopted host blocks (the remote tier-hit origin)."""
    fleet, streams, owner, survivor, inherited = _drain_over_fabric(
        models["plain"], None, 8)
    assert inherited >= 16
    assert fleet.fabric_adopted_tokens > 0
    assert len(fleet.directory) > 0
    assert owner not in fleet._endpoints
    assert fleet.owner_of("heir") == survivor.name
    flat = flatten_metrics(fleet.collect_metrics())
    delivered = metric_value(flat, "kubeshare_serving_fabric_messages_total",
                             kind="chain", outcome="delivered")
    sent = metric_value(flat, "kubeshare_serving_fabric_messages_total",
                        kind="chain", outcome="sent")
    assert delivered > 0 and delivered == sent
    assert metric_value(flat, "kubeshare_serving_fabric_bytes_total") > 0
    assert metric_value(
        flat, "kubeshare_serving_fabric_chain_tokens_adopted_total") \
        == fleet.fabric_adopted_tokens
    assert metric_value(
        flat, "kubeshare_serving_tier_hit_origin_requests_total",
        origin="remote") >= 1
