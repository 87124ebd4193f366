"""Port parity: kubeshare_tpu_torch.serving.disagg against the JAX
package's DisaggRouter on the CPU.

The split-pool router (prefill pool + decode pool + KV-chain migration
over the wire format, ``device="cpu"``: programs run eagerly) emits
exactly the greedy streams of JAX's router and of JAX's monolithic
engine at f32, on TestDisagg's pools and requests (every prompt off a
block multiple, so every chain ships a partial tail).  Sampled streams
are port-internal (the port's seed schedule is not JAX's PRNG): they
equal the port's monolithic engine's.  Speculation engages on the copy
model of tests/test_torch_engine.py; preemption, the shared host tier,
the metric families, the handoff TTL and tickets over a faulty fabric
are held to JAX's counters for the same script.  The JAX runs are made
once each, in module-scoped fixtures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubeshare_tpu.serving as jax_serving
import kubeshare_tpu.serving.chaos as jax_chaos
import kubeshare_tpu_torch.serving as port_serving
import kubeshare_tpu_torch.serving.chaos as chaos
from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models.transformer import TransformerConfig
from kubeshare_tpu_torch.serving import (BlockExhausted, DecodePool,
                                         DisaggRouter, DisaggTopology,
                                         EngineConfig, LoopbackTransport,
                                         Request, ServingEngine)
from kubeshare_tpu_torch.serving.metrics_view import flatten_metrics

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=64, attention="reference")
# TestDisagg's configurations
CASES = {"gqa_rope": dict(n_kv_heads=2, positional="rope"),
         "windowed": dict(attention_window=6),
         "moe": dict(moe_every=2, moe_num_experts=4, moe_top_k=2)}
MONO = dict(num_slots=3, block_size=4, num_blocks=41, max_request_len=48,
            prefill_chunk=8, mixed=False)
PREFILL = dict(num_slots=2, block_size=4, num_blocks=17, max_request_len=48,
               prefill_chunk=8, mixed=False)
DECODE = dict(num_slots=3, block_size=4, num_blocks=25, max_request_len=48,
              prefill_chunk=8, mixed=False)


def _reqs():
    rng = np.random.default_rng(61)
    return [("long", rng.integers(0, 64, 29), 6),
            ("s0", rng.integers(0, 64, 5), 8),
            ("s1", rng.integers(0, 64, 13), 4)]


REQS = _reqs()


def _models(extra):
    jax_cfg = JaxConfig(dtype=jnp.float32, **MODEL, **extra)
    jp = jax_init(jax.random.PRNGKey(0), jax_cfg)
    return (jax_cfg, jp, TransformerConfig(dtype=torch.float32, **MODEL,
                                           **extra),
            params_from_jax(jax.device_get(jp), "cpu"))


@pytest.fixture(scope="module")
def models():
    return {name: _models(extra) for name, extra in CASES.items()}


def _jax_router(jax_cfg, jp, prefill=None, decode=None, **kwargs):
    return jax_serving.DisaggRouter(
        jp, jax_cfg, jax_serving.EngineConfig(**{**PREFILL, **(prefill or {})}),
        jax_serving.EngineConfig(**{**DECODE, **(decode or {})}), **kwargs)


def _router(model, prefill=None, decode=None, **kwargs):
    _, _, cfg, tp = model
    return DisaggRouter(tp, cfg, EngineConfig(**{**PREFILL, **(prefill or {})}),
                        EngineConfig(**{**DECODE, **(decode or {})}),
                        device="cpu", **kwargs)


def _mono(model, tenants=None, **overrides):
    _, _, cfg, tp = model
    return ServingEngine(tp, cfg, EngineConfig(**{**MONO, **overrides}),
                         tenants=tenants, device="cpu")


def _jax_streams(engine, reqs=REQS):
    for rid, prompt, new in reqs:
        engine.submit(jax_serving.Request(rid, prompt.astype(np.int32), new))
    return {rid: r.tokens for rid, r in engine.run().items()}


def _streams(engine, reqs=REQS, sampled=()):
    """Serve ``reqs``; the rids in ``sampled`` at temperature 0.8 from a
    generator seeded by their index."""
    for i, (rid, prompt, new) in enumerate(reqs):
        if rid in sampled:
            engine.submit(Request(rid, prompt, new, temperature=0.8,
                                  rng=torch.Generator().manual_seed(60 + i)))
        else:
            engine.submit(Request(rid, prompt, new))
    return {rid: r.tokens for rid, r in engine.run().items()}


@pytest.fixture(scope="module")
def jax_greedy(models):
    """JAX's monolithic and disaggregated streams over REQS, per case."""
    out = {}
    for name, (jax_cfg, jp, _, _) in models.items():
        mono = jax_serving.ServingEngine(jp, jax_cfg,
                                         jax_serving.EngineConfig(**MONO))
        router = _jax_router(jax_cfg, jp)
        out[name] = (_jax_streams(mono), _jax_streams(router),
                     router.migrator.migrated_bytes)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_streams_equal_jax_router_and_engine(models, jax_greedy, name):
    want_mono, want_router, want_bytes = jax_greedy[name]
    assert want_router == want_mono
    router = _router(models[name])
    router.warmup()
    base = router.capture_counts()
    staged = {}
    pack = router.migrator.pack

    def spy(engine, slot):
        staged[slot.rid] = len(router.migrator._staged_blocks(slot.rid))
        return pack(engine, slot)

    router.migrator.pack = spy
    assert _streams(router) == want_router
    # the long prompt's settled blocks were read ahead of its handoff
    assert staged["long"] >= 4
    # every request crossed the wire once, in JAX's bytes...
    assert router.migrator.migrations == router.migrator.delivered == 3
    assert router.migrator.migrated_bytes == want_bytes
    # ...each pool ran only its phase's dispatches...
    assert router.prefill.decode_steps == 0
    assert router.decode.prefill_chunks == 0
    assert base["decode.prefill"] == base["decode.copy"] == 0
    assert base["prefill.decode"] == base["prefill.upload"] == 0
    assert base["decode.upload"] == 1
    # ...nothing was built after warm-up, and nothing leaked
    assert router.capture_counts() == base
    assert router.idle and router.prefill.allocator.blocks_in_use == 0
    assert router.decode.allocator.blocks_in_use == 0


@pytest.mark.parametrize("fabric", [False, True], ids=["direct", "fabric"])
def test_sampled_streams_equal_the_port_engine(models, fabric):
    shared = dict(top_k=10, top_p=0.95)
    sampled = {"long", "s1"}
    want = _streams(_mono(models["gqa_rope"], **shared), sampled=sampled)
    router = _router(models["gqa_rope"], prefill=shared, decode=shared,
                     fabric=LoopbackTransport() if fabric else None)
    assert _streams(router, sampled=sampled) == want
    assert router.migrator.delivered == 3
    if fabric:
        assert router._fabric_pf.messages[("ticket", "delivered")] == 3


# -- speculation: the copy model of tests/test_torch_engine.py, whose greedy
# pick is a fixed 3-cycle of its input token, so drafts are accepted

def _copy_params(jp):
    def scale(tree):
        return {k: scale(v) if isinstance(v, dict) else v * 1e-3
                for k, v in tree.items()}

    nxt = np.arange(64)
    nxt[:63] = 3 * (nxt[:63] // 3) + (nxt[:63] % 3 + 1) % 3
    layers = [{**layer, "attn": scale(layer["attn"]),
               "mlp": scale(layer["mlp"])} for layer in jp["layers"]]
    return {**jp, "layers": layers,
            "lm_head": jp["embed"][np.argsort(nxt)].T}


PHRASE = [7, 11, 19, 7, 11, 19, 7, 11, 19, 7, 11, 19]
SPEC_FULL = np.asarray(PHRASE + [23, 29, 23, 29])
SPEC_HEAD = np.asarray(PHRASE[:8])  # a prefix of SPEC_FULL


def _drive_spec(engine, request):
    engine.submit(request("warm", SPEC_FULL, 4))
    engine.run()
    engine.submit(request("b", SPEC_HEAD, 8))
    return engine.run()["b"].tokens


@pytest.fixture(scope="module")
def copy_model(models):
    jax_cfg, jp, cfg, _ = models["gqa_rope"]
    copy = _copy_params(jax.device_get(jp))
    return jax_cfg, copy, cfg, params_from_jax(copy, "cpu")


def test_speculative_drafter_state_survives_handoff(copy_model):
    jax_cfg, jp, _, _ = copy_model
    spec = dict(speculative=True)

    def jax_request(rid, prompt, new):
        return jax_serving.Request(rid, prompt.astype(np.int32), new)

    mono = jax_serving.ServingEngine(
        jp, jax_cfg, jax_serving.EngineConfig(**MONO, **spec))
    want = _drive_spec(mono, jax_request)
    jax_router = _jax_router(jax_cfg, jp, prefill=spec, decode=spec)
    assert _drive_spec(jax_router, jax_request) == want
    # the premise: on the copy model JAX's decode pool accepts drafts
    assert sum(jax_router.decode.spec_accepted.values()) >= 1

    router = _router(copy_model, prefill=spec, decode=spec)
    router.warmup()
    base = router.capture_counts()
    tickets = []
    pack = router.migrator.pack

    def spy(engine, slot):
        tickets.append(pack(engine, slot))
        return tickets[-1]

    router.migrator.pack = spy
    assert _drive_spec(router, Request) == want
    assert router.capture_counts() == base
    # the cache-hit lane's ticket carried prompt + trie continuation...
    assert tickets[1].hint[:len(SPEC_HEAD)] == list(SPEC_HEAD)
    assert len(tickets[1].hint) > len(SPEC_HEAD)
    # ...and the rebuilt drafter drafted and accepted as JAX's did
    assert router.decode.spec_drafted == jax_router.decode.spec_drafted
    assert router.decode.spec_accepted == jax_router.decode.spec_accepted


# -- preemption: a Guarantee ticket the full decode pool cannot place
# preempts an Opportunistic decode slot, whose resume re-prefills

def _tenants(mod):
    return mod.TenantRegistry([
        mod.TenantSpec("gold"),
        mod.TenantSpec("batch", qos_class=mod.QOS_OPPORTUNISTIC)])


def _drive_preemption(engine, request, is_router, gold_kwargs):
    rng = np.random.default_rng(5)
    v0, v1, g = (rng.integers(0, 64, 8) for _ in range(3))
    engine.submit(request("v0", v0, 24, tenant="batch"))
    engine.submit(request("v1", v1, 24, tenant="batch"))
    if is_router:  # both victims resident decode-side first
        while engine.migrator.delivered < 2:
            engine.step()
    else:
        for _ in range(4):
            engine.step()
    engine.submit(request("g", g, 6, tenant="gold", **gold_kwargs))
    return {rid: r.tokens for rid, r in engine.run().items()}


@pytest.fixture(scope="module")
def jax_preemption(models):
    jax_cfg, jp, _, _ = models["gqa_rope"]

    def request(rid, prompt, new, **kw):
        return jax_serving.Request(rid, prompt.astype(np.int32), new, **kw)

    mono = jax_serving.ServingEngine(jp, jax_cfg,
                                     jax_serving.EngineConfig(**MONO),
                                     tenants=_tenants(jax_serving))
    router = _jax_router(jax_cfg, jp, decode=dict(num_slots=2, num_blocks=17),
                         tenants=_tenants(jax_serving))
    return (_drive_preemption(mono, request, False, {}),
            _drive_preemption(router, request, True, {}),
            router.migrator.migrations)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_preemption_mid_migration_stays_exact(models, jax_preemption,
                                              sampled):
    model = models["gqa_rope"]

    def gold():
        return (dict(temperature=0.9, rng=torch.Generator().manual_seed(77))
                if sampled else {})

    want = _drive_preemption(_mono(model, tenants=_tenants(port_serving)),
                             Request, False, gold())
    router = _router(model, decode=dict(num_slots=2, num_blocks=17),
                     tenants=_tenants(port_serving))
    router.warmup()
    base = router.capture_counts()
    got = _drive_preemption(router, Request, True, gold())
    assert got == want
    assert router.capture_counts() == base
    assert router.decode.preemptions.get("batch", 0) >= 1
    # the victim re-prefilled and re-migrated: 3 requests, 4+ chains
    assert router.migrator.migrations >= 4
    assert router.migrator.delivered == router.migrator.migrations
    if not sampled:
        want_mono, want_router, migrations = jax_preemption
        assert got == want_mono == want_router
        assert router.migrator.migrations == migrations


# -- the shared host tier as the cross-pool cache bus

def _drive_bus(router, request):
    rng = np.random.default_rng(9)
    p_a = rng.integers(0, 64, 12)
    router.submit(request("a0", p_a, 6))
    a0 = router.run()["a0"].tokens
    # flood: drains the decode pool's cached chains into the shared tier;
    # their generated-row blocks mirror into the prefill trie
    for i in range(6):
        router.submit(request(f"o{i}", rng.integers(0, 64, 12), 6))
    router.run()
    ext = np.concatenate([p_a, np.asarray(a0)])
    router.submit(request("ext", ext, 4))
    return ext, router.run()["ext"].tokens


def _bus_router(make, ledger):
    return make(decode=dict(num_slots=2, num_blocks=13),
                shared_tier_bytes=1 << 20,
                ledger_hook=lambda nbytes, kind: ledger.append((kind, nbytes)))


def test_shared_tier_is_the_cross_pool_cache_bus(models):
    jax_cfg, jp, _, _ = models["gqa_rope"]
    jax_ledger, ledger = [], []
    jax_router = _bus_router(lambda **kw: _jax_router(jax_cfg, jp, **kw),
                             jax_ledger)
    _, want = _drive_bus(
        jax_router, lambda rid, p, n: jax_serving.Request(
            rid, p.astype(np.int32), n))
    router = _bus_router(lambda **kw: _router(models["gqa_rope"], **kw),
                         ledger)
    router.warmup()
    base = router.capture_counts()
    ext, got = _drive_bus(router, Request)
    assert got == want
    assert router.capture_counts() == base
    # rows 12.. of `ext` exist only in the decode pool's demoted chain:
    # serving them from the prefill pool's tier proves the bus
    assert router.prefill.tier_hit_requests >= 1
    assert router.prefill.tier_hit_requests == \
        jax_router.prefill.tier_hit_requests
    assert got == _streams(_mono(models["gqa_rope"]),
                           [("ext", ext, 4)])["ext"]
    # the ledger hook saw JAX's demote / promote / migrate bytes
    assert ledger == jax_ledger
    assert {kind for kind, _ in ledger} == {"demote", "promote", "migrate"}
    assert sum(n for kind, n in ledger if kind == "migrate") \
        == router.migrator.migrated_bytes


# -- the merged metrics plane

def _families(router):
    """The migration, handoff and pool-labelled families: (sample name,
    labels) -> value, timing sums left out."""
    keep = ("kubeshare_serving_migrations_total",
            "kubeshare_serving_migrated_bytes_total",
            "kubeshare_serving_migration_stall_seconds_count",
            "kubeshare_serving_handoff_retries_total",
            "kubeshare_serving_dispatches_total",
            "kubeshare_serving_ttft_seconds_count",
            "kubeshare_serving_tbt_seconds_count",
            "kubeshare_serving_requests_total",
            "kubeshare_serving_tokens_generated_total",
            "kubeshare_serving_host_planner_invocations_total")
    return {key: value for key, value in flatten_metrics(
        router.collect_metrics()).items() if key[0] in keep}


def test_metric_families_equal_jax(models):
    jax_cfg, jp, _, _ = models["gqa_rope"]
    rng = np.random.default_rng(21)
    reqs = [(f"r{i}", rng.integers(0, 64, 9), 4) for i in range(3)]
    jax_router = _jax_router(jax_cfg, jp)
    _jax_streams(jax_router, reqs)
    router = _router(models["gqa_rope"])
    _streams(router, reqs)
    got = _families(router)
    assert got == _families(jax_router)
    assert got[("kubeshare_serving_migrations_total",
                (("stage", "delivered"),))] == 3
    pools = {dict(labels).get("pool") for name, labels in got
             if name == "kubeshare_serving_dispatches_total"}
    assert pools == {"prefill", "decode"}
    assert got[("kubeshare_serving_migration_stall_seconds_count", ())] == 3
    # a monolithic engine's families stay unlabelled
    mono = _mono(models["gqa_rope"])
    _streams(mono, reqs)
    assert all("pool" not in dict(labels) for name, labels in flatten_metrics(
        mono.collect_metrics()) if name == "kubeshare_serving_dispatches_total")


# -- handoff TTL and bounded backoff (JAX's TestDisaggHandoffTTL)

TTL_REQS = REQS[:2] + [("samp", np.random.default_rng(62).integers(0, 64, 11),
                        7)]


def _ttl_plan(mod, drops):
    plan = mod.FaultPlan(seed=9)
    for n in drops:
        plan.drop_ticket(n)
    return plan


TTL_ARMS = {"expire": (dict(handoff_ttl_steps=3, handoff_backoff_steps=1),
                       (0, 1, 2)),
            "backoff": (dict(handoff_ttl_steps=50, handoff_backoff_steps=2,
                             handoff_backoff_cap_steps=8), (0,))}


@pytest.fixture(scope="module")
def jax_ttl(models):
    jax_cfg, jp, _, _ = models["gqa_rope"]
    out = {}
    for arm, (kwargs, drops) in TTL_ARMS.items():
        router = _jax_router(jax_cfg, jp, **kwargs)
        router.fault_clock = jax_chaos.FaultClock(_ttl_plan(jax_chaos, drops))
        streams = _jax_streams(router, TTL_REQS)
        out[arm] = (streams, dict(router.handoff_retries),
                    router.migrator.migrations)
    return out


@pytest.mark.parametrize("arm", sorted(TTL_ARMS))
def test_dropped_tickets_expire_or_back_off_and_stay_exact(models, jax_ttl,
                                                           arm):
    kwargs, drops = TTL_ARMS[arm]
    model = models["gqa_rope"]
    want = _streams(_mono(model), TTL_REQS, sampled={"samp"})
    router = _router(model, **kwargs)
    router.fault_clock = chaos.FaultClock(_ttl_plan(chaos, drops))
    router.warmup()
    base = router.capture_counts()
    assert _streams(router, TTL_REQS, sampled={"samp"}) == want
    jax_streams, jax_retries, jax_migrations = jax_ttl[arm]
    # the retry ledger and the chain count are JAX's, the greedy streams too
    assert dict(router.handoff_retries) == jax_retries
    assert router.migrator.migrations == jax_migrations
    assert {rid: want[rid] for rid in ("long", "s0")} == {
        rid: jax_streams[rid] for rid in ("long", "s0")}
    assert router.handoff_retries["dropped"] == len(drops)
    if arm == "expire":
        # the reserve is released: no ticket left holding a decode slot
        assert router.handoff_retries["expired"] >= 1
        assert not router._tickets
    else:
        assert router.handoff_retries["expired"] == 0
        assert router.handoff_retries["delivered"] == len(TTL_REQS)
    assert router.capture_counts() == base
    retries = flatten_metrics(router.collect_metrics())
    assert retries[("kubeshare_serving_handoff_retries_total",
                    (("outcome", "dropped"),))] == len(drops)


@pytest.mark.parametrize("kwargs", [
    dict(handoff_ttl_steps=0), dict(handoff_backoff_steps=0),
    dict(handoff_backoff_steps=4, handoff_backoff_cap_steps=2),
    dict(fabric=LoopbackTransport(), fabric_ttl_ticks=0),
    dict(decode_priority=0)],
    ids=["ttl", "backoff", "cap_below_backoff", "fabric_ttl", "priority"])
def test_router_knobs_validate_like_jax(models, kwargs):
    jax_cfg, jp, _, _ = models["gqa_rope"]
    with pytest.raises(ValueError) as want:
        _jax_router(jax_cfg, jp, **{
            k: (jax_serving.LoopbackTransport() if k == "fabric" else v)
            for k, v in kwargs.items()})
    with pytest.raises(ValueError) as got:
        _router(models["gqa_rope"], **kwargs)
    assert str(got.value) == str(want.value)


# -- tickets over a faulty fabric (JAX's TestFabricChaos)

def _fabric_reqs():
    return [(f"r{i}", np.arange(3 + i * 2) % 60, 8) for i in range(5)]


def _fabric_plan(mod):
    return (mod.FaultPlan(seed=31).drop_fabric(0).drop_fabric(3)
            .duplicate_fabric(5).corrupt_fabric(7))


def _fabric_counters(router):
    pf, dc = router._fabric_pf, router._fabric_dc
    return (pf.messages, dc.messages, pf.redeliveries, dc.redeliveries,
            pf.bytes_total, dc.bytes_total, dict(router.handoff_retries))


def test_tickets_over_a_faulty_fabric_stay_exact(models):
    jax_cfg, jp, _, _ = models["gqa_rope"]
    jax_fabric = jax_serving.LoopbackTransport()
    jax_clock = jax_chaos.FaultClock(_fabric_plan(jax_chaos))
    jax_fabric.fault_clock = jax_clock
    jax_router = _jax_router(jax_cfg, jp, fabric=jax_fabric,
                             fabric_ttl_ticks=12)
    # greedy: the ticket frames carry no seeds, so their bytes are JAX's
    want = _jax_streams(jax_router, _fabric_reqs())

    fabric = LoopbackTransport()
    clock = chaos.FaultClock(_fabric_plan(chaos))
    fabric.fault_clock = clock
    router = _router(models["gqa_rope"], fabric=fabric, fabric_ttl_ticks=12)
    router.warmup()
    assert _streams(router, _fabric_reqs()) == want
    assert want == _streams(_mono(models["gqa_rope"]), _fabric_reqs())
    assert clock.events == jax_clock.events and clock.events
    assert _fabric_counters(router) == _fabric_counters(jax_router)
    assert router._fabric_inflight == {} and router._fabric_arrivals == []
    pf = router._fabric_pf
    assert pf.inflight == 0
    assert (pf.messages.get(("ticket", "delivered"), 0)
            + pf.messages.get(("ticket", "expired"), 0)
            == pf.messages[("ticket", "sent")])
    assert pf.redeliveries + router._fabric_dc.redeliveries > 0


# -- loud misconfiguration (JAX's test_loud_misconfiguration)

def test_geometry_mismatch_and_oversized_requests_raise(models):
    _, _, cfg, tp = models["gqa_rope"]
    with pytest.raises(ValueError, match="disagree on block_size"):
        DisaggRouter(tp, cfg, EngineConfig(**PREFILL),
                     EngineConfig(**{**DECODE, "block_size": 8}),
                     device="cpu")
    with pytest.raises(ValueError, match="decode_priority pacing"):
        _router(models["gqa_rope"], decode=dict(steps_per_launch=2),
                decode_priority=2)
    router = _router(models["gqa_rope"], decode=dict(num_slots=2,
                                                     num_blocks=5))
    with pytest.raises(BlockExhausted, match="NEVER migrate"):
        router.submit(Request("big", np.arange(20), 20))
    assert router.prefill.idle  # rejected before any prefill work


def test_decode_pool_refuses_submit_and_prefill_pool_migrations(models):
    _, _, cfg, tp = models["gqa_rope"]
    decode = DecodePool(tp, cfg, EngineConfig(**DECODE), device="cpu")
    with pytest.raises(RuntimeError, match="admit_migrated"):
        decode.submit(Request("r", np.arange(4), 2))
    router = _router(models["gqa_rope"])
    with pytest.raises(RuntimeError, match="cannot admit migrated"):
        router.prefill.admit_migrated(
            rid="r", tenant="default", prompt=np.arange(4), first_token=1,
            max_new=2, temperature=0.0, step_seeds=np.zeros(0, np.int64),
            payloads=[], result=None, emitted_prefix=[], last_token_at=None)


def test_virtual_multislice_topology_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        DisaggTopology("virtual_multislice").place()
    with pytest.raises(ValueError, match="two_cell"):
        DisaggTopology("three_cell")
    assert DisaggTopology().place("cpu") == ("cpu", "cpu")
