"""Port parity: kubeshare_tpu_torch.serving.fleet against the JAX package's
ReplicaFleet on the CPU — one counterpart for each test of
tests/test_fleet.py.

The port's fleet (``device="cpu"``: every replica's programs run eagerly)
is held to JAX's fleet at f32 on the same greedy traces: streams, the
replica each request was routed to and the routing decisions by reason.
Its streams equal the port's monolithic engine at equal aggregate KV
budget, greedy and sampled (a sampled lane draws its seed schedule from a
``torch.Generator``, not JAX's PRNG, so sampled streams are held to the
port's own engine).  The autoscaler's decisions equal JAX's policy's on
the same interval sequence, the carve and the engine's mesh rows raise
JAX's errors, the metric families carry ``replica=`` labels with the
shared tier counted once, and replicas are placed and released through
JAX's ``FleetPlacementPlane`` (the placement stays duck-typed).  Each JAX
fleet runs once, in a module-scoped fixture, unwarmed (only the shapes
its trace dispatches compile)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubeshare_tpu.serving as jax_serving
import kubeshare_tpu_torch.serving as port_serving
from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models.decoding import greedy_decode
from kubeshare_tpu_torch.models.transformer import TransformerConfig
from kubeshare_tpu_torch.parallel.mesh import MeshSpec
from kubeshare_tpu_torch.serving import (EngineConfig, PrefixAffinityPolicy,
                                         ReplicaFleet, Request,
                                         RoundRobinPolicy, RoutingPolicy,
                                         ScalingPolicy, ServingEngine,
                                         TTFTBreachPolicy,
                                         carve_replica_groups)
from kubeshare_tpu_torch.serving.engine import TTFT_BUCKETS
from kubeshare_tpu_torch.serving.fleet import _bucket_observe
from kubeshare_tpu_torch.serving.metrics_view import (flatten_metrics,
                                                      metric_value)

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=64, attention="reference")
CASES = {"plain": {}, "gqa_rope": dict(n_kv_heads=2, positional="rope")}
# tests/test_fleet.py's per-replica pool; the monolithic twin holds the
# two pools' 40 allocatable blocks
REPLICA = dict(num_slots=3, block_size=4, num_blocks=21, max_request_len=48,
               prefill_chunk=8)
FLEET_KWARGS = ("routing", "scaling", "autoscale_every", "tenants",
                "shared_tier_bytes", "min_replicas", "max_replicas",
                "placement", "devices")


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, extra in CASES.items():
        jax_cfg = JaxConfig(dtype=jnp.float32, **MODEL, **extra)
        jp = jax_init(jax.random.PRNGKey(0), jax_cfg)
        out[name] = (jax_cfg, jp,
                     TransformerConfig(dtype=torch.float32, **MODEL, **extra),
                     params_from_jax(jax.device_get(jp), "cpu"))
    return out


def _split(overrides):
    fleet = {k: overrides.pop(k) for k in FLEET_KWARGS if k in overrides}
    return fleet, {**REPLICA, **overrides}


def _fleet(model, *, replicas=2, **overrides):
    _, _, cfg, tp = model
    fleet_kwargs, ec = _split(dict(overrides))
    return ReplicaFleet(tp, cfg, EngineConfig(**ec), replicas=replicas,
                        device="cpu", **fleet_kwargs)


def _jax_fleet(model, *, replicas=2, **overrides):
    jax_cfg, jp, _, _ = model
    fleet_kwargs, ec = _split(dict(overrides))
    return jax_serving.ReplicaFleet(jp, jax_cfg,
                                    jax_serving.EngineConfig(**ec),
                                    replicas=replicas, **fleet_kwargs)


def _mono(model, num_blocks=41, tenants=None, **overrides):
    _, _, cfg, tp = model
    return ServingEngine(tp, cfg, EngineConfig(**{
        **REPLICA, "num_blocks": num_blocks, **overrides}),
        tenants=tenants, device="cpu")


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


# -- the traces ------------------------------------------------------------

def _bitexact_trace(sampled):
    """tests/test_fleet.py's 8 requests: even ones share a 12-token
    prefix; with ``sampled`` every third one samples at T 0.8."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 64, 12)
    out = []
    for i in range(8):
        if i % 2 == 0:
            prompt = np.concatenate([shared, rng.integers(0, 64, 4)])
        else:
            prompt = rng.integers(0, 64, 10)
        hot = sampled and i % 3 == 0
        out.append((f"r{i}", prompt, 6, hot))
    return out


def _request(rid, prompt, new, hot=False, i=0, tenant=None):
    kwargs = {} if tenant is None else dict(tenant=tenant)
    if hot:
        return Request(rid, prompt, new, temperature=0.8,
                       rng=torch.Generator().manual_seed(70 + i), **kwargs)
    return Request(rid, prompt, new, **kwargs)


def _shared_prefix_trace(n_groups=3, per_group=4, prefix_len=12,
                         tail_len=4, max_new=5, seed=3):
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 64, prefix_len) for _ in range(n_groups)]
    trace = []
    for i in range(n_groups * per_group):
        g = i % n_groups
        tail = rng.integers(0, 64, tail_len)
        trace.append((f"g{g}x{i}",
                      np.concatenate([prefixes[g], tail]).astype(np.int64),
                      max_new))
    return trace


def _spill_trace():
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 64, 12)

    def req(rid, tenant, max_new=4):
        return (rid, np.concatenate([shared, rng.integers(0, 64, 4)]),
                max_new, tenant)

    return [req("warm", "batch"), req("fill", "batch", 16),
            req("sticky", "batch", 16), req("gold", "gold"),
            req("spilled", "batch")]


def _registry(mod):
    return mod.TenantRegistry([
        mod.TenantSpec("gold"),
        mod.TenantSpec("batch", qos_class=mod.QOS_OPPORTUNISTIC)])


def _drive_spill(fleet, request, trace):
    """The spill script: warm, fill the owner's only slot, then three
    arrivals against it; returns each rid's owner."""
    (warm, fill, sticky, gold, spilled) = [request(*r) for r in trace]
    fleet.submit(warm)
    fleet.run()
    fleet.submit(fill)
    fleet.step()
    for r in (sticky, gold, spilled):
        fleet.submit(r)
    fleet.run()
    return {rid: fleet.owner_of(rid) for rid, _, _, _ in trace}


@pytest.fixture(scope="module")
def jax_runs(models):
    """JAX's fleet over the greedy traces, once each: (streams, owners,
    routing decisions) by scenario."""
    def jreq(rid, prompt, new, tenant=None):
        kwargs = {} if tenant is None else dict(tenant=tenant)
        return jax_serving.Request(rid, prompt.astype(np.int32), new,
                                   **kwargs)

    out = {}
    fleet = _jax_fleet(models["plain"])
    trace = _bitexact_trace(False)
    for rid, prompt, new, _ in trace[:2]:
        fleet.submit(jreq(rid, prompt, new))
    fleet.run()
    for rid, prompt, new, _ in trace[2:]:
        fleet.submit(jreq(rid, prompt, new))
    streams = _streams(fleet.run())
    out["bitexact"] = (streams, {r: fleet.owner_of(r) for r in streams},
                       dict(fleet.routing_decisions))

    fleet = _jax_fleet(models["plain"])
    for rid, prompt, new in _shared_prefix_trace():
        fleet.submit(jreq(rid, prompt, new))
        fleet.run()
    streams = _streams(fleet._results)
    out["affinity"] = (streams, {r: fleet.owner_of(r) for r in streams},
                       dict(fleet.routing_decisions))

    fleet = _jax_fleet(models["plain"], num_slots=1,
                       tenants=_registry(jax_serving),
                       routing=jax_serving.PrefixAffinityPolicy(
                           spill_queue_depth=1))
    owners = _drive_spill(fleet, jreq, _spill_trace())
    out["spill"] = (None, owners, dict(fleet.routing_decisions))
    return out


# -- TestFleetBitExact -------------------------------------------------------

def test_greedy_sampled_and_prefix_hits_match_monolithic(models, jax_runs):
    """A fleet of 2 x 20 blocks against one 40-block engine: greedy and
    sampled streams (top_k 10, top_p 0.95) equal the monolithic engine's,
    the tries are hit, nothing is captured after warm-up; on the greedy
    trace the streams, owners and routing decisions equal JAX's fleet."""
    model = models["gqa_rope"]
    trace = _bitexact_trace(True)
    mono = _mono(model, top_k=10, top_p=0.95)
    mono.warmup()
    for i, (rid, prompt, new, hot) in enumerate(trace):
        mono.submit(_request(rid, prompt, new, hot, i))
    want = _streams(mono.run())
    fleet = _fleet(model, top_k=10, top_p=0.95, shared_tier_bytes=1 << 20)
    fleet.warmup()
    base = fleet.capture_counts()
    requests = [_request(rid, prompt, new, hot, i)
                for i, (rid, prompt, new, hot) in enumerate(trace)]
    for r in requests[:2]:
        fleet.submit(r)
    fleet.run()
    for r in requests[2:]:
        fleet.submit(r)
    assert _streams(fleet.run()) == want
    assert _metric(fleet.collect_metrics(),
                   "kubeshare_serving_prefix_hit_tokens_total") > 0
    assert fleet.capture_counts() == base

    want_streams, want_owners, want_decisions = jax_runs["bitexact"]
    greedy = _bitexact_trace(False)
    fleet = _fleet(models["plain"])
    for rid, prompt, new, _ in greedy[:2]:
        fleet.submit(Request(rid, prompt, new))
    fleet.run()
    for rid, prompt, new, _ in greedy[2:]:
        fleet.submit(Request(rid, prompt, new))
    got = _streams(fleet.run())
    assert got == want_streams
    assert {r: fleet.owner_of(r) for r in got} == want_owners
    assert fleet.routing_decisions == want_decisions
    mono = _mono(models["plain"])
    for rid, prompt, new, _ in greedy:
        mono.submit(Request(rid, prompt, new))
    assert _streams(mono.run()) == got


def test_preemption_inside_a_replica_stays_bit_exact(models):
    """QoS preemption fires inside one replica (all traffic pinned there)
    and both streams still equal the dense greedy decode."""
    class PinFirst(RoutingPolicy):
        def route(self, fleet, request, candidates):
            return candidates[0], "least_loaded"

    model = models["gqa_rope"]
    _, _, cfg, tp = model
    fleet = _fleet(model, num_blocks=13, num_slots=2, max_request_len=32,
                   tenants=_registry(port_serving),
                   routing=PinFirst())
    fleet.warmup()
    r0 = fleet.replicas[0]
    rng = np.random.default_rng(21)
    p_batch = rng.integers(0, 64, 17)
    p_gold = rng.integers(0, 64, 18)
    fleet.submit(Request("victim", p_batch, 14, tenant="batch"))
    while True:
        slots = [s for s in r0.engine._slots
                 if s.rid == "victim" and s.state == "decode"]
        if slots and len(slots[0].generated) >= 2:
            break
        assert fleet.step(), "fleet idle before victim decoded"
    fleet.submit(Request("gold", p_gold, 6, tenant="gold"))
    out = fleet.run()
    assert r0.engine.preemptions.get("batch", 0) >= 1
    for rid, prompt, new in (("victim", p_batch, 14), ("gold", p_gold, 6)):
        ref = greedy_decode(tp, cfg, torch.from_numpy(prompt)[None], new)[0]
        assert out[rid].tokens == ref.tolist(), rid


# -- TestRouting -------------------------------------------------------------

def test_affinity_beats_round_robin_on_shared_prefix_trace(models, jax_runs):
    """Closed loop over 3 prefix families: routing never changes a
    stream, affinity recovers strictly more prefix tokens than
    round-robin, and its owners and decisions equal JAX's."""
    model = models["plain"]

    def run_arm(routing):
        fleet = _fleet(model, routing=routing)
        fleet.warmup()
        for rid, prompt, new in _shared_prefix_trace():
            fleet.submit(Request(rid, prompt, new))
            fleet.run()
        streams = _streams(fleet._results)
        fams = fleet.collect_metrics()
        return (fleet, streams,
                _metric(fams, "kubeshare_serving_prefix_hit_tokens_total"),
                fams)

    _, rr_streams, rr_hits, _ = run_arm(RoundRobinPolicy())
    fleet, aff_streams, aff_hits, aff_fams = run_arm(None)
    assert aff_streams == rr_streams
    assert aff_hits > rr_hits
    decisions = "kubeshare_serving_fleet_routing_decisions_total"
    assert _metric(aff_fams, decisions, reason="affinity") >= 6
    assert _metric(aff_fams, decisions, reason="least_loaded") >= 3
    want_streams, want_owners, want_decisions = jax_runs["affinity"]
    assert aff_streams == want_streams
    assert {r: fleet.owner_of(r) for r in aff_streams} == want_owners
    assert fleet.routing_decisions == want_decisions


def test_guarantee_and_saturation_spills(models, jax_runs):
    """Guarantee traffic leaves the affinity target as soon as it would
    queue; Opportunistic traffic sticks until the target is saturated;
    every owner equals JAX's."""
    fleet = _fleet(models["plain"], num_slots=1,
                   tenants=_registry(port_serving),
                   routing=PrefixAffinityPolicy(spill_queue_depth=1))
    fleet.warmup()

    def preq(rid, prompt, new, tenant):
        return Request(rid, prompt, new, tenant=tenant)

    owners = _drive_spill(fleet, preq, _spill_trace())
    owner = owners["warm"]
    assert owners["fill"] == owners["sticky"] == owner
    assert owners["gold"] != owner and owners["spilled"] != owner
    assert fleet.routing_decisions["spill"] >= 2
    _, want_owners, want_decisions = jax_runs["spill"]
    assert owners == want_owners
    assert fleet.routing_decisions == want_decisions


# -- TestDrain ---------------------------------------------------------------

def _drain_script(fleet, seed=11):
    """Serve "seed", drain its owner, serve "heir"; returns (owner,
    survivor handle, streams)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 64, 16)

    def req(rid):
        return Request(rid, np.concatenate([shared, rng.integers(0, 64, 4)]),
                       4)

    streams = {}
    fleet.submit(req("seed"))
    streams.update(_streams(fleet.run()))
    owner = fleet.owner_of("seed")
    survivor = [h for h in fleet.replicas if h.name != owner][0]
    assert survivor.engine.prefix_match_len(shared) == 0
    fleet.drain(owner)
    fleet.run()
    assert fleet._handle(owner).state == "retired"
    assert survivor.engine.prefix_match_len(shared) >= 16
    fleet.submit(req("heir"))
    streams.update(_streams(fleet.run()))
    return owner, survivor, streams, shared


def test_drain_hands_trie_to_shared_tier_and_sibling_promotes(models):
    model = models["plain"]
    fleet = _fleet(model, shared_tier_bytes=1 << 20)
    fleet.warmup()
    owner, survivor, streams, _ = _drain_script(fleet)
    assert len(fleet.shared_tier._entries) > 0
    assert fleet.owner_of("heir") == survivor.name
    assert survivor.engine.tier_hit_requests >= 1
    # the retiree's device blocks came back in one gather
    assert fleet.handoff_blocks >= 4 and fleet.handoff_host_s > 0
    fams = fleet.collect_metrics()
    assert _metric(fams, "kubeshare_serving_fleet_replicas",
                   state="retired") == 1
    assert _metric(fams, "kubeshare_serving_fleet_drain_seconds_count") == 1
    mono = _mono(model)
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 64, 16)
    for rid in ("seed", "heir"):
        mono.submit(Request(rid, np.concatenate(
            [shared, rng.integers(0, 64, 4)]), 4))
    assert _streams(mono.run()) == streams


def test_drain_below_min_replicas_refuses(models):
    fleet = _fleet(models["plain"], replicas=2, min_replicas=2)
    with pytest.raises(RuntimeError, match="min_replicas"):
        fleet.drain(fleet.replicas[0].name)


def test_scale_up_then_zero_captures(models):
    fleet = _fleet(models["plain"], replicas=2)
    fleet.warmup()
    handle = fleet.scale_up()
    assert handle.state == "active" and len(fleet.replicas) == 3
    # the new replica shares the caller's parameter tensors
    assert handle.engine.params is fleet.params
    base = fleet.capture_counts()
    assert base["r2.decode"] == 1
    rng = np.random.default_rng(2)
    for i in range(6):
        fleet.submit(Request(f"s{i}", rng.integers(0, 64, 10), 5))
    fleet.run()
    assert fleet.capture_counts() == base
    assert fleet.scale_events["up"] == 1


# -- TestAutoscaler ----------------------------------------------------------

class _Stub:
    """A fleet stand-in: cumulative TTFT buckets and an idle flag."""

    def __init__(self):
        self.counts = [0] * (len(TTFT_BUCKETS) + 1)
        self.idle = True

    def observe(self, seconds, n=1):
        _bucket_observe(self.counts, seconds, TTFT_BUCKETS, n)

    def _ttft_counts_snapshot(self):
        return list(self.counts)


def _decisions(policy, script):
    """Feed ``script`` (a list of [(seconds, n), ...] per interval) to
    ``policy``; returns its decisions, the first on an empty baseline."""
    stub = _Stub()
    out = [policy.decide(stub)]
    for interval in script:
        for seconds, n in interval:
            stub.observe(seconds, n)
        out.append(policy.decide(stub))
    return out


def _both(kwargs, script):
    port = _decisions(TTFTBreachPolicy(0.1, **kwargs), script)
    want = _decisions(jax_serving.TTFTBreachPolicy(0.1, **kwargs), script)
    assert port == want
    return port


def test_sustained_breach_scales_up_once():
    got = _both(dict(breach_cycles=3, min_samples=2),
                [[(1.0, 4)]] * 4)
    assert got == [None, None, None, "up", None]


def test_bursty_trace_never_flaps():
    got = _both(dict(breach_cycles=2, idle_cycles=3, min_samples=2),
                [[(1.0, 4)], [(0.01, 4)]] * 6)
    assert got == [None] * 13


def test_sustained_idle_drains():
    got = _both(dict(idle_cycles=3, min_samples=2),
                [[], [], [(0.01, 1)], [], [], []])
    assert got == [None, None, "down", None, None, None, "down"]


def test_fleet_applies_policy_decisions(models):
    """A scripted policy through the fleet's autoscale tick: one up, one
    down — the fleet grows, then drains its least-loaded replica and
    retires it."""
    class Script(ScalingPolicy):
        def __init__(self):
            self.plan = ["up", None, "down"]

        def decide(self, fleet):
            return self.plan.pop(0) if self.plan else None

    fleet = _fleet(models["plain"], replicas=2, max_replicas=3,
                   scaling=Script(), autoscale_every=1)
    fleet.warmup()
    rng = np.random.default_rng(4)
    for i in range(6):
        fleet.submit(Request(f"a{i}", rng.integers(0, 64, 10), 4))
    out = fleet.run()
    assert all(len(r.tokens) == 4 for r in out.values())
    states = sorted(h.state for h in fleet.replicas)
    assert len(fleet.replicas) == 3
    assert states.count("retired") == 1
    assert fleet.scale_events == {"up": 1, "down": 1}


# -- TestCarving -------------------------------------------------------------

def test_carve_replica_groups_slices():
    from kubeshare_tpu.serving import carve_replica_groups as jax_carve

    devs = list("abcdefgh")
    for kwargs in (dict(dp=2, tp=2, sp=1), dict(dp=-1, tp=3, sp=1)):
        got = carve_replica_groups(MeshSpec(**kwargs), devs)
        assert got == jax_carve(JaxMeshSpec(**kwargs), devs)
    assert carve_replica_groups(MeshSpec(dp=2, tp=2, sp=1), devs) == [
        ["a", "b"], ["c", "d"]]


@pytest.mark.parametrize("kwargs", [
    dict(dp=2, tp=1, ep=2, sp=1), dict(dp=2, tp=-1, sp=1),
    dict(dp=0, tp=1, sp=1), dict(dp=3, tp=2, sp=1),
    dict(dp=-1, tp=8, sp=1)],
    ids=["ep", "tp_fill", "dp_zero", "too_few", "does_not_fit"])
def test_carve_validation_errors(kwargs):
    """Each refused spec raises JAX's ValueError with its message."""
    from kubeshare_tpu.serving import carve_replica_groups as jax_carve

    devs = list("abcd")
    with pytest.raises(ValueError) as want:
        jax_carve(JaxMeshSpec(**kwargs), devs)
    with pytest.raises(ValueError) as got:
        carve_replica_groups(MeshSpec(**kwargs), devs)
    assert str(got.value) == str(want.value)


def test_no_card_no_fallback(models, monkeypatch):
    """Without a card and without device="cpu" the fleet and the carve
    raise; nothing drops quietly to the CPU."""
    _, _, cfg, tp = models["plain"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaFleet(tp, cfg, EngineConfig(**REPLICA))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        carve_replica_groups(MeshSpec(dp=2, tp=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaFleet(tp, cfg, EngineConfig(
            **REPLICA, mesh_spec=MeshSpec(dp=2, tp=1)), device="cpu")


def test_single_engine_dp_rejection_points_at_fleet(models):
    """The engine's dp row raises JAX's ValueError with its message; a
    tp > 1 spec builds a tensor-parallel engine, as JAX's does."""
    jax_cfg, jp, cfg, tp = models["plain"]
    pool = dict(num_slots=2, block_size=4, num_blocks=13,
                max_request_len=32, prefill_chunk=8)
    for kwargs in (dict(dp=2, tp=1, sp=1), dict(dp=1, tp=1, ep=2),
                   dict(dp=1, tp=1, sp=2)):
        with pytest.raises(ValueError) as want:
            jax_serving.ServingEngine(jp, jax_cfg, jax_serving.EngineConfig(
                **pool, mesh_spec=JaxMeshSpec(**kwargs)))
        with pytest.raises(ValueError, match="ReplicaFleet") as got:
            ServingEngine(tp, cfg, EngineConfig(
                **pool, mesh_spec=MeshSpec(**kwargs)), device="cpu")
        assert str(got.value) == str(want.value)
    engine = ServingEngine(tp, cfg, EngineConfig(
        **pool, mesh_spec=MeshSpec(dp=1, tp=2)), device="cpu")
    want = jax_serving.ServingEngine(jp, jax_cfg, jax_serving.EngineConfig(
        **pool, mesh_spec=JaxMeshSpec(dp=1, tp=2, sp=1)))
    assert engine._sharded.describe()["tp"] == want._sharded.describe()["tp"]
    assert engine._sharded.decision.attn_sharded == \
        want._sharded.decision.attn_sharded


def test_mesh_devices_requires_mesh_spec(models):
    """mesh_devices without a spec raises JAX's ValueError; its message
    names the port's device= where JAX's names default_device."""
    jax_cfg, jp, cfg, tp = models["plain"]
    pool = dict(num_slots=2, block_size=4, num_blocks=13,
                max_request_len=32, prefill_chunk=8)
    with pytest.raises(ValueError) as want:
        jax_serving.ServingEngine(jp, jax_cfg, jax_serving.EngineConfig(
            **pool), mesh_devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="mesh_devices requires") as got:
        ServingEngine(tp, cfg, EngineConfig(**pool), device="cpu",
                      mesh_devices=[torch.device("cpu")])
    head = "mesh_devices requires mesh_spec — an unsharded engine has no " \
           "mesh to pin onto a device group; pin it with "
    assert str(want.value).startswith(head)
    assert str(got.value).startswith(head + "device=")


def test_fleet_refuses_more_replicas_than_groups(models):
    """A dp carve bounds the fleet; within it each tp=1 replica runs on
    its group's device, and a tp > 1 group runs a tensor-parallel
    replica over its group."""
    _, _, cfg, tp = models["plain"]
    devs = [torch.device("cpu")] * 2
    ec = EngineConfig(**REPLICA, mesh_spec=MeshSpec(dp=2, tp=1, sp=1))
    with pytest.raises(ValueError, match="device group"):
        ReplicaFleet(tp, cfg, ec, replicas=3, device="cpu", devices=devs)
    with pytest.raises(ValueError, match="device group"):
        ReplicaFleet(tp, cfg, ec, replicas=2, max_replicas=3,
                     device="cpu", devices=devs)
    fleet = ReplicaFleet(tp, cfg, ec, replicas=2, device="cpu",
                         devices=devs)
    assert [h.group_idx for h in fleet.replicas] == [0, 1]
    assert not fleet.can_grow()
    fleet.submit(Request("a", np.arange(8), 3))
    assert len(fleet.run()["a"].tokens) == 3
    sharded = ReplicaFleet(tp, cfg, EngineConfig(
        **REPLICA, mesh_spec=MeshSpec(dp=1, tp=2, sp=1)),
        replicas=1, device="cpu", devices=devs)
    assert sharded.replicas[0].engine._sharded.devices == devs
    sharded.submit(Request("a", np.arange(8), 3))
    assert sharded.run()["a"].tokens == fleet.result("a").tokens


# -- TestFleetMetrics --------------------------------------------------------

def test_replica_label_and_no_shared_tier_double_count(models):
    fleet = _fleet(models["plain"], shared_tier_bytes=1 << 20)
    fleet.warmup()
    rng = np.random.default_rng(8)
    shared = rng.integers(0, 64, 16)
    fleet.submit(Request("a", np.concatenate(
        [shared, rng.integers(0, 64, 4)]), 4))
    fleet.run()
    fleet.drain(fleet.owner_of("a"))
    fleet.run()
    fams = fleet.collect_metrics()
    names = {(s.labels.get("replica"), s.labels.get("kind"))
             for f in fams if f.name == "kubeshare_serving_dispatches_total"
             for s in f.samples}
    assert {r for r, _ in names} == {"r0", "r1"}
    used = [s.value for f in fams
            if f.name == "kubeshare_serving_tier_host_bytes"
            for s in f.samples if s.labels.get("kind") == "used"]
    assert used == [fleet.shared_tier.used_bytes]
    evicted = [s.value for f in fams
               if f.name == "kubeshare_serving_tier_blocks_total"
               for s in f.samples if s.labels.get("event") == "host_evicted"]
    assert evicted == [fleet.shared_tier.evicted_blocks]
    # the fleet's own families carry JAX's names and labels
    flat = flatten_metrics(fams)
    assert metric_value(flat, "kubeshare_serving_fleet_replicas",
                        state="retired") == 1
    assert metric_value(flat, "kubeshare_serving_fleet_scale_events_total",
                        direction="down") == 1
    for name in ("kubeshare_serving_fleet_routing_decisions_total",
                 "kubeshare_serving_fleet_drain_seconds",
                 "kubeshare_serving_fleet_replica_failures_total",
                 "kubeshare_serving_fleet_salvaged_prefix_tokens_total",
                 "kubeshare_serving_fleet_orphans_readmitted_total",
                 "kubeshare_serving_fleet_recovery_seconds"):
        assert name in {f.name for f in fams}, name


# -- TestPlacementAdapter: JAX's scheduler plane, handed to the port ----------

TOPOLOGY = """
cellTypes:
  V4-NODE:
    childCellType: "TPU-v4"
    childCellNumber: 4
    childCellPriority: 60
    isNodeLevel: true
  2-V4-NODE:
    childCellType: V4-NODE
    childCellNumber: 2
cells:
- cellType: 2-V4-NODE
  cellChildren:
  - cellId: host-a
  - cellId: host-b
"""


def _plane(**kwargs):
    from kubeshare_tpu import constants
    from kubeshare_tpu.cell import load_config
    from kubeshare_tpu.cell.allocator import ChipInfo
    from kubeshare_tpu.cluster.api import FakeClock, Node
    from kubeshare_tpu.cluster.fake import FakeCluster
    from kubeshare_tpu.scheduler import (FleetPlacementPlane,
                                         KubeShareScheduler, SchedulerArgs,
                                         SchedulerEngine)

    hbm = 32 << 30
    inventory = {
        node: [ChipInfo(f"{node}-tpu-{i}", hbm, "TPU-v4", i, (i, rank, 0))
               for i in range(4)]
        for rank, node in enumerate(("host-a", "host-b"))}
    cluster = FakeCluster()
    for n in ("host-a", "host-b"):
        cluster.add_node(Node(
            name=n, labels={constants.NODE_LABEL_FILTER: "true"}))
    clock = FakeClock(1000.0)
    plugin = KubeShareScheduler(
        topology=load_config(text=TOPOLOGY), cluster=cluster,
        inventory=lambda node: inventory.get(node, []),
        args=SchedulerArgs(), clock=clock)
    engine = SchedulerEngine(plugin, cluster, clock)
    return FleetPlacementPlane(engine, cluster, **kwargs), cluster


FRACTION = dict(gpu_request="0.5", gpu_limit="0.5", gpu_memory=1 << 30,
                priority=10)


def test_place_binds_fractional_cell_and_release_reclaims(models):
    """Each replica the port's fleet builds is bound to a fractional cell;
    a retirement releases it and a scale-up is placed again."""
    plane, cluster = _plane(**FRACTION)
    fleet = _fleet(models["plain"], placement=plane, max_replicas=3)
    for handle in fleet.replicas:
        assert handle.placement.cell_id and handle.placement.gpu_uuid
        assert handle.placement.node in {"host-a", "host-b"}
    fleet.drain("r0")
    fleet.run()
    assert len(cluster.list_pods(namespace="serving")) == 1
    handle = fleet.scale_up(warmup=False)
    assert handle.placement.cell_id
    assert len(cluster.list_pods(namespace="serving")) == 2


def test_unplaceable_replica_is_loud(models):
    plane, _ = _plane(gpu_request="8.0", gpu_limit="8.0")
    with pytest.raises(RuntimeError, match="unplaceable"):
        _fleet(models["plain"], placement=plane)


def test_fleet_places_and_releases_through_the_plane(models):
    plane, cluster = _plane(**FRACTION)
    fleet = _fleet(models["plain"], placement=plane)
    assert all(h.placement is not None for h in fleet.replicas)
    assert len(cluster.list_pods(namespace="serving")) == 2
    fleet.warmup()
    fleet.submit(Request("a", np.arange(8), 3))
    fleet.run()
    fleet.drain(fleet.replicas[0].name)
    fleet.run()
    assert len(cluster.list_pods(namespace="serving")) == 1
