"""Port parity: kubeshare_tpu_torch.serving.sharded and the serving half of
parallel/mesh.py against the JAX package on the CPU.

The port's tensor-parallel engine runs every shard of a group from one
controller; here a group names the CPU tp times (``[cpu] * tp``), the
counterpart of JAX's forced host-platform devices.  The contract is
tests/test_sharded_serving.py's: a sharded engine's streams are
BIT-IDENTICAL to the single-device engine's (the port's own, which
tests/test_torch_engine.py holds to JAX's) — greedy and sampled, MHA,
the replicated-KV fallback, windowed, MoE, the device loops, CoW,
preemption, speculation, the tiers, the long-context route and a
dp x tp fleet — at tp = 2 and 4, f32.  The greedy streams of the four
configurations also equal JAX's: the JAX sharded engine's for MHA and
MoE (on conftest's forced CPU devices), JAX's single-device engine's for
the others.  The mesh's and the policy's error texts, the sharding
decisions, the spec trees and the collective-byte integers equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubeshare_tpu.serving as jax_serving
from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.parallel import mesh as jax_mesh
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models import decoding
from kubeshare_tpu_torch.models.transformer import TransformerConfig
from kubeshare_tpu_torch.parallel import mesh as port_mesh
from kubeshare_tpu_torch.parallel.mesh import MeshSpec, P, shard_params
from kubeshare_tpu_torch.serving import (QOS_OPPORTUNISTIC, EngineConfig,
                                         ReplicaFleet, Request, ServingEngine,
                                         ShardedServingContext,
                                         TenantRegistry, TenantSpec,
                                         plan_sharding,
                                         serving_sharding_rules)
from kubeshare_tpu_torch.utils.promtext import encode_families

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=64, attention="reference")
CONFIGS = {
    "mha": {},
    "gqa_rope": dict(n_kv_heads=2, positional="rope"),
    "windowed": dict(attention_window=6),
    "moe": dict(moe_every=2, moe_num_experts=4, moe_top_k=2),
}
POOL = dict(num_slots=3, block_size=4, num_blocks=41, max_request_len=48,
            prefill_chunk=8)
CPU = torch.device("cpu")


def _trace():
    """Five requests of mixed lengths; r3 shares r0's first 10 tokens
    (a prefix hit with a copy-on-write mid-block)."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 64, 13)
    return [("r0", base, 8),
            ("r1", rng.integers(0, 64, 5), 9),
            ("r2", rng.integers(0, 64, 21), 4),
            ("r3", np.concatenate([base[:10], rng.integers(0, 64, 4)]), 6),
            ("r4", rng.integers(0, 64, 2), 7)]


TRACE = _trace()


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, extra in CONFIGS.items():
        jax_cfg = JaxConfig(dtype=jnp.float32, **MODEL, **extra)
        jp = jax_init(jax.random.PRNGKey(0), jax_cfg)
        out[name] = (jax_cfg, jp,
                     TransformerConfig(dtype=torch.float32, **MODEL, **extra),
                     params_from_jax(jax.device_get(jp), "cpu"))
    return out


def _engine(model, tp=None, tenants=None, **overrides):
    """The port's engine on the CPU; ``tp`` makes it a tensor-parallel
    engine over ``[cpu] * tp``."""
    _, _, cfg, params = model
    kwargs = dict(POOL, **overrides)
    if tp is not None:
        kwargs["mesh_spec"] = MeshSpec(dp=1, tp=tp)
    return ServingEngine(params, cfg, EngineConfig(**kwargs), device="cpu",
                         tenants=tenants)


def _serve(engine, trace=TRACE, sampled=()):
    for rid, prompt, new in trace:
        if rid in sampled:
            engine.submit(Request(rid, prompt, new, temperature=0.8,
                                  rng=torch.Generator().manual_seed(
                                      int(rid[1:]) + 40)))
        else:
            engine.submit(Request(rid, prompt, new))
    return {rid: r.tokens for rid, r in engine.run().items()}


def _run_sequentially(engine, trace):
    out = {}
    for rid, prompt, new in trace:
        engine.submit(Request(rid, prompt, new))
        out.update({k: r.tokens for k, r in engine.run().items() if r.done})
        engine.pop_finished()
    return out


def _jax_streams(model, tp=None):
    jax_cfg, jp, _, _ = model
    kwargs = dict(POOL)
    if tp is not None:
        kwargs["mesh_spec"] = jax_mesh.MeshSpec(dp=1, tp=tp, sp=1)
    engine = jax_serving.ServingEngine(jp, jax_cfg,
                                       jax_serving.EngineConfig(**kwargs))
    for rid, prompt, new in TRACE:
        engine.submit(jax_serving.Request(rid, prompt.astype(np.int32), new))
    return {rid: r.tokens for rid, r in engine.run().items()}


@pytest.fixture(scope="module")
def single(models):
    """The port's single-device greedy streams over TRACE per config."""
    return {name: _serve(_engine(models[name])) for name in CONFIGS}


def _raises_alike(port_call, jax_call, error=ValueError):
    with pytest.raises(error) as want:
        jax_call()
    with pytest.raises(error) as got:
        port_call()
    assert str(got.value) == str(want.value)


# -- TestServingMeshStrict ---------------------------------------------------

@pytest.mark.parametrize("kwargs,n", [
    (dict(dp=0, tp=1), 4), (dict(tp=-2), 4), (dict(dp=-1, tp=-1), 8),
    (dict(dp=2, tp=3), 4), (dict(dp=1, tp=2), 8), (dict(dp=-1, tp=3), 8),
    (dict(dp=-1, tp=2), 8), (dict(dp=2, tp=2, sp=2), 8),
    (dict(dp=1, tp=1), 1)])
def test_mesh_spec_resolve_matches_jax(kwargs, n):
    try:
        want = jax_mesh.MeshSpec(**kwargs).resolve(n)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            MeshSpec(**kwargs).resolve(n)
        assert str(got.value) == str(exc)
    else:
        assert MeshSpec(**kwargs).resolve(n) == want


def test_serving_mesh_preset_takes_the_leading_devices():
    devices = [torch.device("cuda", i) for i in range(8)]
    mesh = port_mesh.serving_mesh(4, devices=devices)
    assert mesh.shape == {"dp": 1, "tp": 4, "sp": 1}
    assert list(mesh.devices.flat) == devices[:4]
    mesh = port_mesh.serving_mesh(2, dp=2, devices=devices)
    assert mesh.shape == {"dp": 2, "tp": 2, "sp": 1}
    ep = port_mesh.make_mesh(MeshSpec(dp=2, ep=2, tp=2), devices=devices)
    assert ep.axis_names == ("dp", "ep", "tp", "sp")
    assert ep.devices.shape == (2, 2, 2, 1)
    assert port_mesh.replicated(mesh).spec == P()


def test_serving_mesh_validation_is_loud():
    n = len(jax.devices())
    cpus = [CPU] * n
    _raises_alike(lambda: port_mesh.serving_mesh(0, devices=cpus),
                  lambda: jax_mesh.serving_mesh(0))
    _raises_alike(lambda: port_mesh.serving_mesh(n + 1, devices=cpus),
                  lambda: jax_mesh.serving_mesh(n + 1))


# -- TestShardingPlan --------------------------------------------------------

PLAN_CONFIGS = {
    **CONFIGS,
    "mqa": dict(n_kv_heads=1),
    "kv6_of_12": dict(n_heads=12, n_kv_heads=6, d_model=48),
    "d_ff_66": dict(d_ff=66),
    "vocab_63": dict(vocab_size=63),
}


@pytest.mark.parametrize("name", sorted(PLAN_CONFIGS))
def test_plan_sharding_decisions_match_jax(name):
    extra = {**MODEL, **PLAN_CONFIGS[name]}
    jax_cfg = JaxConfig(dtype=jnp.float32, **extra)
    cfg = TransformerConfig(dtype=torch.float32, **extra)
    for tp in (1, 2, 3, 4, 8):
        try:
            want = jax_serving.plan_sharding(jax_cfg, tp)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                plan_sharding(cfg, tp)
            assert str(got.value) == str(exc)
            continue
        got = plan_sharding(cfg, tp)
        assert (got.tp, got.attn_sharded, got.mlp_sharded,
                got.lm_head_sharded) == (want.tp, want.attn_sharded,
                                         want.mlp_sharded,
                                         want.lm_head_sharded)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, (jax.sharding.PartitionSpec, port_mesh.PartitionSpec)):
        for i, value in enumerate(tree):
            yield from _leaves(value, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spec_trees_match_jax(models, name):
    jax_cfg, jp, cfg, params = models[name]
    for tp in (2, 4):
        jax_rules = jax_serving.serving_sharding_rules(
            jax_serving.plan_sharding(jax_cfg, tp))
        rules = serving_sharding_rules(plan_sharding(cfg, tp))
        assert {k: tuple(v) for k, v in rules.items()} == \
            {k: tuple(v) for k, v in jax_rules.items()}
        want = list(_leaves(jax_mesh.param_spec_tree(jp, jax_rules)))
        got = list(_leaves(port_mesh.param_spec_tree(params, rules)))
        assert [(p, tuple(s)) for p, s in got] == \
            [(p, tuple(s)) for p, s in want]
    if name == "moe":
        specs = port_mesh.param_spec_tree(params, rules)
        assert specs["layers"][0]["mlp"]["w_in"] == P(None, "tp")
        assert specs["layers"][1]["moe"]["w_in"] == P()
        assert specs["layers"][1]["moe"]["w_out"] == P()


def test_shard_params_splits_exactly_and_names_indivisible_axes(models):
    jax_cfg, jp, cfg, params = models["gqa_rope"]
    mesh = port_mesh.serving_mesh(2, devices=[CPU] * 2)
    placed = shard_params(params, serving_sharding_rules(
        plan_sharding(cfg, 2)), mesh)
    wq = placed["layers"][0]["attn"]["wq"]
    full = params["layers"][0]["attn"]["wq"]
    assert wq.spec == P(None, "tp", None) and not wq.is_fully_replicated
    assert [tuple(s.shape) for s in wq.shards] == [(32, 2, 8)] * 2
    assert torch.equal(wq.shards[1], full[:, 2:])
    assert torch.equal(wq.gather(), full)
    embed = placed["embed"]
    # a replicated leaf already on its device is not copied
    assert embed.is_fully_replicated
    assert {s.data_ptr() for s in embed.shards} == {params["embed"].data_ptr()}
    rules = {"wk": P(None, "tp", None)}
    _raises_alike(
        lambda: shard_params(params, rules, port_mesh.serving_mesh(
            4, devices=[CPU] * 4)),
        lambda: jax_mesh.shard_params(
            jp, {"wk": jax.sharding.PartitionSpec(None, "tp", None)},
            jax_mesh.serving_mesh(4)))


# -- TestShardedServing ------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_streams_match_single_device_across_configs(models, single,
                                                           name, tp):
    """Engine vs engine, token for token — MHA (head-sharded), GQA+RoPE
    (the replicated-KV fallback at tp=4), windowed, MoE (replicated
    experts)."""
    engine = _engine(models[name], tp=tp)
    assert _serve(engine) == single[name]
    fallback = name == "gqa_rope" and tp == 4  # 2 KV heads < tp
    assert engine._sharded.decision.attn_sharded != fallback


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_streams_equal_jax(models, single, name):
    """The port's tp=4 streams equal JAX's: its sharded engine's for MHA
    and MoE, its single-device engine's (which its own suite holds equal
    to its sharded one) for the others."""
    jax_tp = 4 if name in ("mha", "moe") else None
    want = _jax_streams(models[name], jax_tp)
    assert single[name] == want
    assert _serve(_engine(models[name], tp=4)) == want


def test_replicated_fallback_pool_and_params_stay_replicated(models):
    engine = _engine(models["gqa_rope"], tp=4)
    assert engine.pool.k.is_fully_replicated
    assert engine.pool.k.spec == P()
    assert engine.params["layers"][0]["attn"]["wq"].is_fully_replicated
    assert not engine.params["layers"][0]["mlp"]["w_in"].is_fully_replicated


@pytest.mark.parametrize("tp", [2, 4])
def test_head_sharded_pool_splits_kv_head_axis(models, tp):
    _, _, cfg, _ = models["mha"]
    engine = _engine(models["mha"], tp=tp)
    assert not engine.pool.k.is_fully_replicated
    assert tuple(engine.pool.k.shape) == (2, 41, 4, 4, 8)
    for shard in engine.pool.k.shards + engine.pool.v.shards:
        assert tuple(shard.shape) == (2, 41, cfg.kv_heads // tp, 4, 8)
    # every shard owns its storage
    ptrs = {s.data_ptr() for s in engine.pool.k.shards + engine.pool.v.shards}
    assert len(ptrs) == 2 * tp


def test_indivisible_kv_heads_is_loud_at_engine_build():
    extra = dict(MODEL, n_heads=12, n_kv_heads=6, d_model=48)
    cfg = TransformerConfig(dtype=torch.float32, **extra)
    params = {"layers": []}
    with pytest.raises(ValueError) as want:
        jax_serving.plan_sharding(JaxConfig(dtype=jnp.float32, **extra), 4)
    with pytest.raises(ValueError, match="not divisible by tp=4") as got:
        ServingEngine(params, cfg, EngineConfig(
            **POOL, mesh_spec=MeshSpec(dp=1, tp=4)), device="cpu")
    assert str(got.value) == str(want.value)


def test_sampled_stream_matches_dense_oracle(models):
    """Same seed => the SHARDED engine reproduces the dense sampled
    decoder exactly (the single-device engine's contract)."""
    _, _, cfg, params = models["gqa_rope"]
    prompt = np.random.default_rng(1).integers(0, 64, 10)
    engine = _engine(models["gqa_rope"], tp=4, top_k=10, top_p=0.95)
    engine.submit(Request("r0", prompt, 6, temperature=0.8,
                          rng=torch.Generator().manual_seed(7)))
    want = decoding.sample_decode(
        params, cfg, torch.from_numpy(prompt)[None],
        torch.Generator().manual_seed(7), 6, temperature=0.8, top_k=10,
        top_p=0.95)
    assert engine.run()["r0"].tokens == want[0].tolist()


def test_zero_new_programs_after_warmup(models, single):
    engine = _engine(models["gqa_rope"], tp=4)
    engine.warmup()
    baseline = engine.capture_counts()
    assert _serve(engine) == single["gqa_rope"]
    assert engine.capture_counts() == baseline


def test_device_loop_sharded_bit_exact(models):
    """steps_per_launch=4 under tp=4 emits the single-device K=1 streams,
    greedy and sampled, with fewer planner invocations and no new
    program after warm-up."""
    model = models["mha"]
    rng = np.random.default_rng(9)
    trace = [("r0", rng.integers(0, 64, 5), 24),
             ("r1", rng.integers(0, 64, 13), 9)]
    want_engine = _engine(model, top_k=10, top_p=0.95)
    want = _serve(want_engine, trace, sampled=("r1",))
    engine = _engine(model, tp=4, steps_per_launch=4, top_k=10, top_p=0.95)
    engine.warmup()
    baseline = engine.capture_counts()
    assert baseline["loop"] >= 1
    assert _serve(engine, trace, sampled=("r1",)) == want
    assert engine.loop_launches >= 1
    assert engine.host_planner_invocations < \
        want_engine.host_planner_invocations
    assert engine.capture_counts() == baseline


def test_cow_divergence_sharded(models):
    _, _, cfg, params = models["gqa_rope"]
    rng = np.random.default_rng(4)
    a = rng.integers(0, 64, 10)
    b = a.copy()
    b[9] = (b[9] + 7) % 64  # diverges at the tail block's 2nd row
    trace = [("a1", a, 6), ("b", b, 6), ("a2", a.copy(), 6)]
    engine = _engine(models["gqa_rope"], tp=2)
    got = _run_sequentially(engine, trace)
    assert engine.cow_copies >= 1
    assert engine.prefix_hit_requests >= 1
    for rid, prompt, new in trace:
        want = decoding.greedy_decode(params, cfg,
                                      torch.from_numpy(prompt)[None], new)
        assert got[rid] == want[0].tolist(), rid
    assert got["a1"] == got["a2"]


def test_prefix_hit_sampled_sharded(models):
    _, _, cfg, params = models["gqa_rope"]
    prompt = np.random.default_rng(3).integers(0, 64, 14)
    engine = _engine(models["gqa_rope"], tp=4, top_k=10, top_p=0.95)
    engine.submit(Request("warm", prompt, 3))
    engine.run()
    engine.submit(Request("samp", prompt.copy(), 5, temperature=0.8,
                          rng=torch.Generator().manual_seed(9)))
    got = engine.run()["samp"].tokens
    assert engine.prefix_hit_tokens == 13
    want = decoding.sample_decode(
        params, cfg, torch.from_numpy(prompt)[None],
        torch.Generator().manual_seed(9), 5, temperature=0.8, top_k=10,
        top_p=0.95)
    assert got == want[0].tolist()


def test_preemption_resume_sharded_bit_exact(models):
    _, _, cfg, params = models["gqa_rope"]
    registry = TenantRegistry([
        TenantSpec("gold"),
        TenantSpec("batch", qos_class=QOS_OPPORTUNISTIC)])
    engine = _engine(models["gqa_rope"], tp=4, tenants=registry,
                     num_slots=2, num_blocks=13, max_request_len=32)
    rng = np.random.default_rng(21)
    p_batch, p_gold = rng.integers(0, 64, 17), rng.integers(0, 64, 18)
    engine.submit(Request("victim", p_batch, 14, tenant="batch"))
    while True:
        slots = [s for s in engine._slots
                 if s.rid == "victim" and s.state == "decode"]
        if slots and len(slots[0].generated) >= 2:
            break
        assert engine.step(), "engine idle before the victim decoded"
    engine.submit(Request("gold", p_gold, 6, tenant="gold"))
    out = engine.run()
    assert engine.preemptions.get("batch", 0) >= 1
    assert engine.prefix_hit_requests >= 1
    for rid, prompt, new in (("victim", p_batch, 14), ("gold", p_gold, 6)):
        want = decoding.greedy_decode(params, cfg,
                                      torch.from_numpy(prompt)[None], new)
        assert out[rid].tokens == want[0].tolist(), rid


def _repetitive_trace(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pat = rng.integers(0, 64, 4)
        out.append((f"r{i}", np.concatenate([np.tile(pat, 3),
                                             rng.integers(0, 64, 2)]), 9))
    return out


def test_speculative_sharded_bit_exact(models):
    """Verify chunks run through the sharded twin; the streams stay the
    non-speculative single-device engine's."""
    model = models["gqa_rope"]
    trace = _repetitive_trace(52, 3)
    want = _serve(_engine(model), trace)
    engine = _engine(model, tp=4, speculative=True, draft_len=4)
    assert _serve(engine, trace) == want
    assert engine.verify_steps > 0
    assert sum(engine.spec_drafted.values()) > 0
    assert engine.collective_bytes["verify_span"] > 0


def test_spec_loop_sharded_bit_exact(models):
    """The speculative device loop with its admission ring under tp=4:
    streams equal the single-device non-loop speculative engine's, greedy
    and sampled, no new program after warm-up."""
    model = models["gqa_rope"]
    trace = _repetitive_trace(57, 5)
    kwargs = dict(speculative=True, draft_len=4, top_k=10, top_p=0.95)
    want = _serve(_engine(model, **kwargs), trace, sampled=("r1", "r3"))
    engine = _engine(model, tp=4, steps_per_launch=4, admission_ring=2,
                     **kwargs)
    engine.warmup()
    baseline = engine.capture_counts()
    assert baseline["spec_loop"] >= 1
    assert _serve(engine, trace, sampled=("r1", "r3")) == want
    assert engine.spec_loop_launches > 0 and engine.spec_loop_units > 0
    assert engine.capture_counts() == baseline


@pytest.mark.parametrize("tp", [2, 4])
def test_long_context_threshold_routes_bit_exact(models, single, tp):
    """Prefill chunks at the threshold re-shard Ulysses-style and the
    streams do not move by a bit; the route adds its all-to-alls and
    gathered views to the collective bytes."""
    plain = _engine(models["mha"], tp=tp)
    routed = _engine(models["mha"], tp=tp, long_context_threshold=8)
    assert _serve(routed) == single["mha"] == _serve(plain)
    assert routed._sharded.decision.attn_sharded
    assert routed.collective_bytes["prefill_chunk"] > \
        plain.collective_bytes["prefill_chunk"]
    assert routed.collective_bytes["decode_span"] == \
        plain.collective_bytes["decode_span"]


def test_long_context_threshold_requires_mesh(models):
    jax_cfg, jp, cfg, params = models["mha"]
    _raises_alike(
        lambda: ServingEngine(params, cfg, EngineConfig(
            **POOL, long_context_threshold=8), device="cpu"),
        lambda: jax_serving.ServingEngine(jp, jax_cfg, jax_serving.EngineConfig(
            **POOL, long_context_threshold=8)))


def test_tier_roundtrip_sharded(models):
    """Demotion gathers the sharded blocks into host wire bytes and
    promotion re-scatters them through the sharded upload: the streams
    and the tier counters equal the single-device tiered engine's."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 64, 13)
    trace = [("r0", shared, 3), ("f1", rng.integers(0, 64, 29), 3),
             ("f2", rng.integers(0, 64, 29), 3),
             ("hit", np.concatenate([shared, rng.integers(0, 64, 4)]), 3)]
    tier = dict(num_slots=1, num_blocks=13, max_request_len=32,
                host_tier_bytes=1 << 20)
    want_engine = _engine(models["mha"], **tier)
    want = _run_sequentially(want_engine, trace)
    engine = _engine(models["mha"], tp=4, **tier)
    assert _run_sequentially(engine, trace) == want
    assert engine.tier_demoted_blocks > 0
    assert engine.tier_promoted_blocks > 0
    assert engine.tier_hit_requests > 0
    assert (engine.tier_demoted_blocks, engine.tier_promoted_blocks) == \
        (want_engine.tier_demoted_blocks, want_engine.tier_promoted_blocks)


@pytest.mark.parametrize("name", ["mha", "gqa_rope"])
def test_block_reads_gather_shards_and_uploads_rescatter(models, name):
    """``_read_blocks`` of a sharded engine returns the single-device
    engine's rows for the same trace; an upload of those rows into a
    fresh block reads back equal."""
    a, b = _engine(models[name]), _engine(models[name], tp=4)
    _serve(a)
    _serve(b)
    blocks = list(range(1, 9))
    ka, va = a._read_blocks(blocks)
    kb, vb = b._read_blocks(blocks)
    assert torch.equal(ka, kb) and torch.equal(va, vb)
    assert ka.abs().sum() > 0
    b._upload(40, ka[3], va[3])
    k40, v40 = b._read_blocks([40])
    assert torch.equal(k40[0], ka[3]) and torch.equal(v40[0], va[3])


def test_collective_bytes_counter_and_tp_label(models):
    engine = _engine(models["mha"], tp=4)
    _serve(engine, TRACE[:1])
    assert engine.collective_bytes["prefill_chunk"] > 0
    assert engine.collective_bytes["decode_span"] > 0
    text = encode_families(engine.collect_metrics())
    assert 'tp="4"' in text
    assert "kubeshare_serving_collective_bytes_total" in text
    plain = _engine(models["mha"])
    _serve(plain, TRACE[:1])
    assert all(v == 0 for v in plain.collective_bytes.values())
    assert 'tp="' not in encode_families(plain.collect_metrics())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dispatch_collective_bytes_match_jax(models, name):
    """The shard-shape model gives JAX's integers over every kind, tp and
    shape, with and without the long-context route; ``describe`` equals
    JAX's but for the device names."""
    jax_cfg, jp, cfg, params = models[name]
    for tp in (2, 4):
        for lct in (None, 8):
            want = jax_serving.ShardedServingContext(
                jax_cfg, jax_mesh.MeshSpec(dp=1, tp=tp, sp=1), jp,
                long_context_threshold=lct)
            got = ShardedServingContext(
                cfg, MeshSpec(dp=1, tp=tp), params,
                long_context_threshold=lct, devices=[CPU] * tp)
            for kind in ("prefill", "prefill_chunk", "decode",
                         "decode_span", "verify", "verify_span", "cow_copy",
                         "upload"):
                for lanes, chunk, span, width in ((1, 8, 0, 0),
                                                  (1, 16, 0, 0),
                                                  (3, 4, 2, 5), (8, 64, 4, 5)):
                    shape = dict(lanes=lanes, chunk=chunk, span=span,
                                 width=width, view_rows=48)
                    assert got.dispatch_collective_bytes(kind, **shape) == \
                        want.dispatch_collective_bytes(kind, **shape)
            described = got.describe()
            expected = want.describe()
            assert described.pop("devices") == ["cpu"] * tp
            expected.pop("devices")
            assert described == expected
    _raises_alike(lambda: got.dispatch_collective_bytes("bogus", lanes=1),
                  lambda: want.dispatch_collective_bytes("bogus", lanes=1))


def test_engine_mesh_errors_match_jax(models):
    jax_cfg, jp, cfg, params = models["mha"]
    _raises_alike(
        lambda: ServingEngine(params, cfg, EngineConfig(
            **POOL, mesh_spec=MeshSpec(dp=1, tp=2)), device="cpu",
            mesh_devices=[CPU] * 3),
        lambda: jax_serving.ServingEngine(jp, jax_cfg, jax_serving.EngineConfig(
            **POOL, mesh_spec=jax_mesh.MeshSpec(dp=1, tp=2, sp=1)),
            mesh_devices=jax.devices()[:3]))
    _raises_alike(
        lambda: ServingEngine(params, cfg, EngineConfig(
            **POOL, mesh_spec=MeshSpec(dp=1, tp=4),
            long_context_threshold=0), device="cpu"),
        lambda: jax_serving.ServingEngine(jp, jax_cfg, jax_serving.EngineConfig(
            **POOL, mesh_spec=jax_mesh.MeshSpec(dp=1, tp=4, sp=1),
            long_context_threshold=0)))
    # one dispatch is one CUDA graph on one card's stream: a group of
    # distinct cards is refused before anything is placed
    with pytest.raises(ValueError, match="distinct CUDA devices"):
        ServingEngine(params, cfg, EngineConfig(
            **POOL, mesh_spec=MeshSpec(dp=1, tp=2)),
            mesh_devices=[torch.device("cuda", 0), torch.device("cuda", 1)])


@pytest.mark.parametrize("name", ["mha", "moe"])
def test_fleet_of_sharded_replicas_equals_one_engine(models, single, name):
    """dp=2 x tp=2 over ``[cpu] * 4``: two tensor-parallel replicas whose
    streams equal one single-device engine's."""
    _, _, cfg, params = models[name]
    fleet = ReplicaFleet(params, cfg, EngineConfig(
        **POOL, mesh_spec=MeshSpec(dp=2, tp=2, sp=1)), replicas=2,
        device="cpu", devices=[CPU] * 4)
    assert [h.engine._sharded.tp for h in fleet.replicas] == [2, 2]
    for rid, prompt, new in TRACE:
        fleet.submit(Request(rid, prompt, new))
    got = {rid: r.tokens for rid, r in fleet.run().items()}
    assert got == single[name]
    assert {fleet.owner_of(rid) for rid, _, _ in TRACE} == {"r0", "r1"}


def test_disagg_router_over_sharded_pools_equals_one_engine(models, single):
    """Both pools of a two-cell router at tp=2: the migration reads the
    prefill pool's shards into wire frames and the decode pool's upload
    re-scatters them; the streams equal the single-device engine's."""
    from kubeshare_tpu_torch.serving import DisaggRouter

    _, _, cfg, params = models["gqa_rope"]
    pool = dict(POOL, mixed=False, mesh_spec=MeshSpec(dp=1, tp=2))
    router = DisaggRouter(params, cfg,
                          EngineConfig(**{**pool, "num_slots": 2}),
                          EngineConfig(**pool), device="cpu")
    assert router.prefill._sharded.tp == router.decode._sharded.tp == 2
    for rid, prompt, new in TRACE:
        router.submit(Request(rid, prompt, new))
    got = {rid: r.tokens for rid, r in router.run().items()}
    assert got == single["gqa_rope"]
    assert router.migrator.delivered == len(TRACE)


def test_drain_hands_a_sharded_replicas_blocks_to_its_sibling(models,
                                                              single):
    """Draining a tp=2 replica reads its device blocks through the
    gathered block read into the shared tier; the sibling promotes them
    through its own sharded upload and r0 served again is unchanged."""
    _, _, cfg, params = models["mha"]
    fleet = ReplicaFleet(params, cfg, EngineConfig(
        **POOL, mesh_spec=MeshSpec(dp=2, tp=2, sp=1)), replicas=2,
        device="cpu", devices=[CPU] * 4, shared_tier_bytes=1 << 20)
    rid, prompt, new = TRACE[0]
    fleet.submit(Request(rid, prompt, new))
    fleet.run()
    owner = fleet.owner_of(rid)
    fleet.drain(owner)
    fleet.run()
    assert fleet.handoff_blocks > 0
    fleet.submit(Request("again", prompt, new))
    assert fleet.run()["again"].tokens == single["mha"][rid]
    survivor = next(h.engine for h in fleet.replicas if h.name != owner)
    assert survivor.tier_promoted_blocks > 0
