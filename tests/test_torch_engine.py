"""Port parity: kubeshare_tpu_torch.serving.engine against the JAX
ServingEngine on the CPU.

A 6-request trace of mixed lengths, two of them sharing a prefix (a hit
with a copy-on-write divergence), runs through the JAX engine once and
through the port's engine under several configurations: the greedy
streams must be equal token for token at f32 — mixed batching on and
off, the prefix cache on and off, ``steps_per_launch`` 1 and 4, a sliced
fused budget.  Preemption and sampling are held to the port's own dense
decoders (which tests/test_torch_decoding.py holds to JAX's), sampled
streams being port-internal (the port draws Gumbel noise from a seed
schedule, not JAX's PRNG).  On the CPU the engine runs its programs
eagerly; the captured form runs in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.serving import EngineConfig as JaxEngineConfig
from kubeshare_tpu.serving import Request as JaxRequest
from kubeshare_tpu.serving import ServingEngine as JaxServingEngine
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.isolation import ExecutionGuard
from kubeshare_tpu_torch.models import decoding
from kubeshare_tpu_torch.models.transformer import TransformerConfig
from kubeshare_tpu_torch.parallel.mesh import MeshSpec
from kubeshare_tpu_torch.serving import (QOS_OPPORTUNISTIC, EngineConfig,
                                         Request, ServingEngine,
                                         TenantRegistry, TenantSpec)
from kubeshare_tpu_torch.serving.metrics_view import (flatten_metrics,
                                                      metric_value)
from kubeshare_tpu_torch.utils.promtext import encode_families

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=64, attention="reference", positional="rope",
             n_kv_heads=2)
POOL = dict(num_slots=3, block_size=4, num_blocks=41, max_request_len=48,
            prefill_chunk=8)


def _trace():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 64, 14)

    def fresh(n):
        return rng.integers(0, 64, n)

    # r4 shares r0's first 14 tokens: three full blocks and half of the
    # fourth, which it copies on write before appending
    return [("r0", np.concatenate([base, fresh(3)]), 6),
            ("r1", fresh(5), 9),
            ("r2", fresh(19), 4),
            ("r3", np.concatenate([base[:10], fresh(6)]), 5),
            ("r4", np.concatenate([base, fresh(1)]), 7),
            ("r5", fresh(2), 11)]


TRACE = _trace()


@pytest.fixture(scope="module")
def model():
    jax_cfg = JaxConfig(dtype=jnp.float32, **MODEL)
    params = jax_init(jax.random.PRNGKey(0), jax_cfg)
    return jax_cfg, params, TransformerConfig(dtype=torch.float32, **MODEL), \
        params_from_jax(jax.device_get(params), "cpu")


@pytest.fixture(scope="module")
def jax_streams(model):
    jax_cfg, jp, _, _ = model
    engine = JaxServingEngine(jp, jax_cfg, JaxEngineConfig(**POOL))
    for rid, prompt, new in TRACE:
        engine.submit(JaxRequest(rid, prompt.astype(np.int32), new))
    out = engine.run()
    return {rid: out[rid].tokens for rid, _, _ in TRACE}


def _engine(model, tenants=None, guard=None, **overrides):
    _, _, cfg, tp = model
    return ServingEngine(tp, cfg, EngineConfig(**{**POOL, **overrides}),
                         guard=guard, tenants=tenants, device="cpu")


def _serve(engine, trace=TRACE):
    engine.warmup()
    counts = engine.capture_counts()
    for rid, prompt, new in trace:
        engine.submit(Request(rid, prompt, new))
    out = engine.run()
    # warm-up built every shape the trace needed
    assert engine.capture_counts() == counts
    assert engine.allocator.blocks_in_use == 0
    return {rid: out[rid].tokens for rid, _, _ in trace}


@pytest.mark.parametrize("overrides", [
    {},
    dict(mixed=False),
    dict(prefix_cache=False),
    dict(steps_per_launch=4),
    dict(mixed_prefill_budget=2),
    dict(steps_per_launch=2, decode_span=1, mixed=False),
], ids=["default", "mixed_off", "prefix_off", "steps_per_launch_4",
        "sliced_budget", "loop_span_1"])
def test_greedy_streams_equal_jax_engine(model, jax_streams, overrides):
    engine = _engine(model, **overrides)
    assert _serve(engine) == jax_streams
    if overrides.get("prefix_cache", True):
        assert engine.prefix_hit_requests >= 1 and engine.cow_copies >= 1
    if overrides.get("mixed", True):
        assert engine.mixed_steps >= 1
    if overrides.get("steps_per_launch", 1) > 1:
        assert engine.loop_launches >= 1
        assert engine.loop_units >= engine.loop_launches


# JAX's MoE case (tests/test_serving.py): layer 1's MLP a top-2 mixture of
# 4 experts; the engine holds no MoE code of its own, its paged steps pin
# the capacity to each dispatch's tokens
MOE = dict(moe_every=2, moe_num_experts=4, moe_top_k=2)


@pytest.fixture(scope="module")
def moe_model():
    jax_cfg = JaxConfig(dtype=jnp.float32, **MODEL, **MOE)
    params = jax_init(jax.random.PRNGKey(0), jax_cfg)
    return jax_cfg, params, TransformerConfig(dtype=torch.float32, **MODEL,
                                              **MOE), \
        params_from_jax(jax.device_get(params), "cpu")


@pytest.fixture(scope="module")
def moe_jax_streams(moe_model):
    # JAX's streams do not depend on mixed batching (its engine is
    # bit-exact across it); mixed=False compiles fewer shapes
    jax_cfg, jp, _, _ = moe_model
    engine = JaxServingEngine(jp, jax_cfg, JaxEngineConfig(**POOL,
                                                           mixed=False))
    for rid, prompt, new in TRACE:
        engine.submit(JaxRequest(rid, prompt.astype(np.int32), new))
    out = engine.run()
    return {rid: out[rid].tokens for rid, _, _ in TRACE}


@pytest.mark.parametrize("overrides", [{}, dict(steps_per_launch=4),
                                       dict(mixed=False)],
                         ids=["default", "steps_per_launch_4", "mixed_off"])
def test_moe_greedy_streams_equal_jax_engine(moe_model, moe_jax_streams,
                                             overrides):
    assert _serve(_engine(moe_model, **overrides)) == moe_jax_streams


def test_warmup_builds_every_shape_once(model):
    engine = _engine(model, steps_per_launch=4)
    engine.warmup()
    counts = engine.capture_counts()
    # prefill widths 1, 2, 4, 8 and the mixed twin of each, the span,
    # the loop, the copy-on-write copy; nothing speculative or tiered
    assert counts == {"decode": 1, "prefill": 4, "mixed": 4, "verify": 0,
                      "mixed_verify": 0, "copy": 1, "upload": 0, "loop": 1,
                      "spec_loop": 0}
    engine.warmup()
    assert engine.capture_counts() == counts
    # warm-up wrote only the scratch block
    assert not engine.pool.k[:, 1:].any() and not engine.pool.v[:, 1:].any()


def test_guarded_engine_charges_every_dispatch(model, jax_streams):
    class GrantAll:
        def acquire(self, estimate_ms):
            return 1e9

        def release(self, used_ms):
            pass

    guard = ExecutionGuard(client=GrantAll(), from_env=False,
                           idle_release_ms=0)
    engine = _engine(model, guard=guard)
    assert _serve(engine) == jax_streams
    dispatches = sum(n for n, _ in engine.dispatch_device_ms().values())
    assert dispatches >= len(TRACE) and guard.tokens_acquired >= 1
    assert guard.total_gated_ms > 0


def _registry():
    return TenantRegistry([
        TenantSpec("gold"),
        TenantSpec("batch", qos_class=QOS_OPPORTUNISTIC),
    ])


def _drive_to_decode(engine, rid, min_tokens=2):
    """Step until ``rid`` decodes with >= min_tokens emitted."""
    while True:
        slot = [s for s in engine._slots if s.rid == rid]
        if slot and slot[0].state == "decode" and \
                len(slot[0].generated) >= min_tokens:
            return
        assert engine.step(), f"engine idle before {rid} decoded"


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_preempted_then_resumed_equals_the_dense_stream(model, temperature):
    # the victim holds 8 of the 12 blocks; the Guarantee request needs 6,
    # so admitting it preempts the Opportunistic decode, which resumes
    # through the prefix cache with its remaining seed schedule
    _, _, cfg, tp = model
    engine = _engine(model, tenants=_registry(), num_slots=2, num_blocks=13,
                     max_request_len=32, top_k=10, top_p=0.95)
    engine.warmup()
    counts = engine.capture_counts()
    rng = np.random.default_rng(21)
    p_batch, p_gold = rng.integers(0, 64, 17), rng.integers(0, 64, 18)
    engine.submit(Request("victim", p_batch, 14, temperature=temperature,
                          rng=torch.Generator().manual_seed(13),
                          tenant="batch"))
    _drive_to_decode(engine, "victim")
    engine.submit(Request("gold", p_gold, 6, tenant="gold"))
    out = engine.run()
    assert engine.preemptions.get("batch", 0) >= 1
    assert engine.prefix_hit_requests >= 1
    want = decoding.sample_decode(
        tp, cfg, torch.from_numpy(p_batch)[None],
        torch.Generator().manual_seed(13), 14, temperature=temperature,
        top_k=10, top_p=0.95)
    assert out["victim"].tokens == want[0].tolist()
    gold = decoding.greedy_decode(tp, cfg, torch.from_numpy(p_gold)[None], 6)
    assert out["gold"].tokens == gold[0].tolist()
    assert engine.allocator.blocks_in_use == 0
    assert engine.capture_counts() == counts


@pytest.mark.parametrize("num_slots", [1, 3])
def test_sampled_streams_equal_sample_decode_with_cache(model, num_slots):
    # one slot reproduces the dense sampled continuation; three slots
    # give each request the same stream (its seeds, not its slot, decide)
    _, _, cfg, tp = model
    engine = _engine(model, num_slots=num_slots, top_k=12, top_p=0.9,
                     steps_per_launch=2)
    temps = (0.7, 1.0, 1.3)
    for (rid, prompt, new), t, seed in zip(TRACE[:3], temps, (5, 6, 7)):
        engine.submit(Request(rid, prompt, new, temperature=t,
                              rng=torch.Generator().manual_seed(seed)))
    out = engine.run()
    for (rid, prompt, new), t, seed in zip(TRACE[:3], temps, (5, 6, 7)):
        cache, logits = decoding.prefill(tp, cfg, torch.from_numpy(prompt)[None])
        want = decoding.sample_decode_with_cache(
            tp, cfg, cache, logits, torch.Generator().manual_seed(seed), new,
            temperature=t, top_k=12, top_p=0.9)
        assert out[rid].tokens == want[0].tolist(), rid


def test_eos_retires_a_request(model, jax_streams):
    eos = jax_streams["r5"][3]
    engine = _engine(model, eos_token=eos, steps_per_launch=2)
    out = _serve(engine)
    for rid, _, _ in TRACE:
        full = jax_streams[rid]
        want = full[: full.index(eos) + 1] if eos in full else full
        assert out[rid] == want, rid
    assert any(len(out[rid]) < new for rid, _, new in TRACE)


def test_metrics_count_the_trace(model):
    engine = _engine(model)
    _serve(engine)
    metrics = flatten_metrics(engine.collect_metrics())
    assert metric_value(metrics, "kubeshare_serving_requests_total",
                        stage="finished") == len(TRACE)
    assert metric_value(metrics, "kubeshare_serving_tokens_generated_total") \
        == sum(new for _, _, new in TRACE)
    assert metric_value(metrics, "kubeshare_serving_ttft_seconds_count") \
        == len(TRACE)
    assert metric_value(metrics, "kubeshare_serving_dispatches_total",
                        kind="cow_copy") == engine.cow_copies
    assert "kubeshare_serving_tbt_seconds_bucket" in encode_families(
        engine.collect_metrics())


@pytest.mark.parametrize("overrides,kwargs", [
    (dict(mesh_spec=object()), {}),
    (dict(long_context_threshold=64), {}),
    (dict(mesh_spec=MeshSpec(dp=1, tp=2)), dict(mesh_devices=[0])),
    (dict(mesh_spec=MeshSpec(dp=1, tp=2)), {}),
])
def test_unported_options_raise(model, overrides, kwargs):
    _, _, cfg, tp = model
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
        ServingEngine(tp, cfg, EngineConfig(**{**POOL, **overrides}),
                      device="cpu", **kwargs)


@pytest.mark.parametrize("overrides", [
    dict(pool_role="prefill"),
    dict(pool_role="decode"),
    dict(pool_role="prefill", mixed=False, steps_per_launch=4),
    dict(pool_role="both_ways", mixed=False),
    dict(pool_role="decode", mixed=False, speculative=True,
         steps_per_launch=2, admission_ring=2),
], ids=["prefill_mixed", "decode_mixed", "prefill_loop", "unknown_role",
        "ring_on_a_decode_pool"])
def test_pool_role_rows_raise_like_jax(model, overrides):
    """Each validation row of the disaggregated roles raises the JAX
    engine's ValueError with its message."""
    jax_cfg, jp, cfg, tp = model
    with pytest.raises(ValueError) as want:
        JaxServingEngine(jp, jax_cfg, JaxEngineConfig(**{**POOL, **overrides}))
    with pytest.raises(ValueError) as got:
        ServingEngine(tp, cfg, EngineConfig(**{**POOL, **overrides}),
                      device="cpu")
    assert str(got.value) == str(want.value)


def test_a_decode_pool_admits_only_migrations(model):
    _, _, cfg, tp = model
    engine = _engine(model, pool_role="decode", mixed=False)
    with pytest.raises(RuntimeError, match="admit_migrated"):
        engine.submit(Request("r", np.arange(4), 2))
    engine.warmup()
    counts = {k: n for k, n in engine.capture_counts().items() if n}
    assert counts == {"decode": 1, "upload": 1}


@pytest.mark.parametrize("overrides,shared_tier", [
    (dict(host_tier_bytes=1 << 20, prefix_cache=False), False),
    (dict(host_tier_bytes=100), False),
    (dict(disk_tier_bytes=1 << 20), False),
    (dict(host_tier_bytes=1 << 20, disk_tier_bytes=100), False),
    (dict(disk_tier_path="kv.arena"), False),
    (dict(host_tier_bytes=1 << 20), True),
    (dict(prefix_cache=False), True),
    (dict(autotune=True, autotune_interval=0), False),
], ids=["host_needs_prefix_cache", "host_below_one_block",
        "disk_needs_host", "disk_below_one_block", "path_needs_disk",
        "shared_and_host_budget", "shared_needs_prefix_cache",
        "autotune_interval"])
def test_tier_and_tuner_rows_raise_like_jax(model, overrides, shared_tier):
    """Each validation row of the tier and tuner options raises the JAX
    engine's error with the JAX engine's message."""
    from kubeshare_tpu.serving import HostTier as JaxHostTier
    from kubeshare_tpu.serving import LRUTierPolicy as JaxLRU
    from kubeshare_tpu_torch.serving import HostTier, LRUTierPolicy

    jax_cfg, jp, cfg, tp = model
    with pytest.raises(ValueError) as want:
        JaxServingEngine(jp, jax_cfg, JaxEngineConfig(**{**POOL, **overrides}),
                         shared_host_tier=(JaxHostTier(1 << 20, JaxLRU())
                                           if shared_tier else None))
    with pytest.raises(ValueError) as got:
        ServingEngine(tp, cfg, EngineConfig(**{**POOL, **overrides}),
                      device="cpu",
                      shared_host_tier=(HostTier(1 << 20, LRUTierPolicy())
                                        if shared_tier else None))
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_submit_validates_and_the_engine_needs_a_device(model, monkeypatch):
    _, _, cfg, tp = model
    engine = _engine(model)
    with pytest.raises(ValueError, match="max_request_len"):
        engine.submit(Request("long", np.zeros(40, np.int64), 9))
    with pytest.raises(ValueError, match="token ids"):
        engine.submit(Request("oov", np.array([3, 64]), 2))
    with pytest.raises(ValueError, match="must carry rng"):
        engine.submit(Request("s", np.zeros(4, np.int64), 2, temperature=1.0))
    with pytest.raises(ValueError, match="max_seq_len"):
        _engine(model, max_request_len=128)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tp, cfg, EngineConfig(**POOL))


# -- speculative decoding ---------------------------------------------------
#
# Two models: the random one above (drafts are mostly rejected) and a copy
# model whose greedy pick is a fixed function of its input token (the
# layers' projections scaled to 1e-3, lm_head = embed.T with its columns
# permuted, rope), so its streams cycle with period 3 and its drafts are
# accepted (all but those a random prompt's own n-grams propose).  Each JAX run first asserts its premise: the copy model's
# drafts are accepted and its loop launches, the random model's rejected.
# The trace's prompts are multiples of the 8-token chunk, so the JAX
# engines compile few shapes; s4 and s6 share s0's first 14 tokens (hits
# with a copy-on-write divergence), and with three slots the queue backs
# up enough for the admission ring to activate entries.

SPEC = dict(speculative=True)
SPEC_LOOP = dict(speculative=True, steps_per_launch=4, admission_ring=2)


def _spec_trace():
    rng = np.random.default_rng(13)
    base = rng.integers(0, 63, 16)

    def shared():
        return np.concatenate([base[:14], rng.integers(0, 63, 8)])

    return [("s0", np.concatenate([base, rng.integers(0, 63, 8)]), 4),
            ("s1", rng.integers(0, 63, 8), 13),
            ("s2", rng.integers(0, 63, 16), 17),
            ("s3", rng.integers(0, 63, 8), 9),
            ("s4", shared(), 6),
            ("s5", rng.integers(0, 63, 8), 11),
            ("s6", shared(), 7)]


SPEC_TRACE = _spec_trace()


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
def spec_models(model):
    jax_cfg, jp, cfg, tp = model
    copy = _copy_params(jax.device_get(jp))
    return {"random": (jax_cfg, jp, cfg, tp),
            "copy": (jax_cfg, copy, cfg, params_from_jax(copy, "cpu"))}


def _spec_counters(engine):
    return {"verify_steps": engine.verify_steps,
            "mixed_verify_steps": engine.mixed_verify_steps,
            "spec_loop_launches": engine.spec_loop_launches,
            "spec_loop_units": engine.spec_loop_units,
            "drafted": dict(engine.spec_drafted),
            "accepted": dict(engine.spec_accepted),
            "exit_reasons": dict(engine.loop_exit_reasons),
            "dispatches": engine.decode_steps + engine.verify_steps}


@pytest.fixture(scope="module")
def jax_spec_runs(spec_models):
    """The JAX engine over SPEC_TRACE: (streams, counters) by (model,
    configuration), run once each."""
    runs = {}

    def run(name, overrides):
        key = (name, tuple(sorted(overrides.items())))
        if key not in runs:
            jax_cfg, jp, _, _ = spec_models[name]
            engine = JaxServingEngine(jp, jax_cfg,
                                      JaxEngineConfig(**POOL, **overrides))
            for rid, prompt, new in SPEC_TRACE:
                engine.submit(JaxRequest(rid, prompt.astype(np.int32), new))
            out = engine.run()
            counters = _spec_counters(engine)
            drafted = sum(counters["drafted"].values())
            accepted = sum(counters["accepted"].values())
            # the premise of every comparison below: the copy model's
            # drafts are accepted (all but those a random prompt's n-grams
            # propose) and its loop launches, the random model's rejected
            assert drafted > 0
            if name == "copy":
                assert 2 * accepted > drafted
                assert (counters["spec_loop_launches"] > 0) == (
                    overrides.get("steps_per_launch", 1) > 1)
            else:
                assert accepted < drafted
            runs[key] = ({rid: out[rid].tokens for rid, _, _ in SPEC_TRACE},
                         counters)
        return runs[key]

    return run


def _spec_engine(spec_models, name, **overrides):
    _, _, cfg, tp = spec_models[name]
    return ServingEngine(tp, cfg, EngineConfig(**{**POOL, **overrides}),
                         device="cpu")


@pytest.mark.parametrize("name,overrides", [
    ("copy", SPEC), ("copy", SPEC_LOOP), ("random", SPEC)],
    ids=["copy", "copy_loop_ring", "random"])
def test_speculative_streams_and_counters_equal_jax(
        spec_models, jax_spec_runs, name, overrides):
    want, want_counters = jax_spec_runs(name, overrides)
    engine = _spec_engine(spec_models, name, **overrides)
    assert _serve(engine, SPEC_TRACE) == want
    assert _spec_counters(engine) == want_counters
    plain = _serve(_spec_engine(spec_models, name), SPEC_TRACE)
    assert plain == want  # speculation never changes a stream
    if overrides.get("admission_ring"):
        assert engine.ring_activations > 0
    if name == "copy":
        assert engine.prefix_hit_requests >= 1 and engine.cow_copies >= 1


@pytest.mark.parametrize("overrides", [
    dict(mixed=False),
    dict(steps_per_launch=4),
    dict(steps_per_launch=4, admission_ring=2, mixed=False),
    dict(steps_per_launch=2, decode_span=1, prefix_cache=False),
], ids=["mixed_off", "loop_no_ring", "loop_ring_mixed_off", "loop_span_1"])
def test_speculative_copy_streams_equal_spec_off(spec_models, jax_spec_runs,
                                                 overrides):
    want, _ = jax_spec_runs("copy", SPEC)
    engine = _spec_engine(spec_models, "copy", speculative=True, **overrides)
    assert _serve(engine, SPEC_TRACE) == want
    assert 2 * engine.spec_accepted["default"] > engine.spec_drafted["default"]
    if overrides.get("steps_per_launch", 1) > 1:
        assert engine.spec_loop_launches > 0
        assert engine.spec_loop_units >= engine.spec_loop_launches


def test_speculation_needs_fewer_dispatches_on_the_copy_model(spec_models):
    counts = {}
    for spec in (True, False):
        engine = _spec_engine(spec_models, "copy", speculative=spec,
                              decode_span=1, draft_len=8)
        _serve(engine, SPEC_TRACE)
        counts[spec] = engine.decode_steps + engine.verify_steps
    assert counts[True] < counts[False]


@pytest.mark.parametrize("overrides", [SPEC, SPEC_LOOP], ids=["spec", "loop"])
def test_speculative_sampled_streams_equal_spec_off(spec_models, overrides):
    temps = (0.7, 1.0, 1.3, 0.0, 0.9)
    outs = []
    for spec in (overrides, {}):
        engine = _spec_engine(spec_models, "copy", top_k=12, top_p=0.9,
                              **spec)
        for (rid, prompt, new), t, seed in zip(SPEC_TRACE, temps, range(5)):
            engine.submit(Request(rid, prompt, new, temperature=t,
                                  rng=torch.Generator().manual_seed(seed)))
        outs.append({rid: r.tokens for rid, r in engine.run().items()})
        if spec:
            assert engine.spec_drafted["default"] > 0
            assert engine.spec_accepted["default"] > 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculative_preempted_then_resumed_equals_the_dense_stream(
        spec_models, temperature):
    _, _, cfg, tp = spec_models["copy"]
    engine = ServingEngine(tp, cfg, EngineConfig(**{
        **POOL, "num_slots": 2, "num_blocks": 13, "max_request_len": 32,
        **SPEC}), tenants=_registry(), device="cpu")
    engine.warmup()
    counts = engine.capture_counts()
    rng = np.random.default_rng(21)
    p_batch, p_gold = rng.integers(0, 64, 17), rng.integers(0, 64, 18)
    engine.submit(Request("victim", p_batch, 14, temperature=temperature,
                          rng=torch.Generator().manual_seed(13),
                          tenant="batch"))
    _drive_to_decode(engine, "victim")
    engine.submit(Request("gold", p_gold, 6, tenant="gold"))
    out = engine.run()
    assert engine.preemptions.get("batch", 0) >= 1
    assert engine.spec_drafted["batch"] > 0
    want = decoding.sample_decode(
        tp, cfg, torch.from_numpy(p_batch)[None],
        torch.Generator().manual_seed(13), 14, temperature=temperature)
    assert out["victim"].tokens == want[0].tolist()
    gold = decoding.greedy_decode(tp, cfg, torch.from_numpy(p_gold)[None], 6)
    assert out["gold"].tokens == gold[0].tolist()
    assert engine.allocator.blocks_in_use == 0
    assert engine.capture_counts() == counts


def test_speculative_warmup_builds_every_shape_once(spec_models):
    engine = _spec_engine(spec_models, "copy", **SPEC_LOOP)
    engine.warmup()
    counts = engine.capture_counts()
    # prefill widths 1, 2, 4, 8, their mixed twins, each with the verify
    # widths 2, 3, 5 (draft widths 1, 2, 4), the span, the two loops and
    # the copy-on-write copy
    assert counts == {"decode": 1, "prefill": 4, "mixed": 4, "verify": 3,
                      "mixed_verify": 12, "copy": 1, "upload": 0, "loop": 1,
                      "spec_loop": 1}
    engine.warmup()
    assert engine.capture_counts() == counts
    assert not engine.pool.k[:, 1:].any() and not engine.pool.v[:, 1:].any()


def test_speculative_metrics_count_the_trace(spec_models):
    engine = _spec_engine(spec_models, "copy", **SPEC_LOOP)
    _serve(engine, SPEC_TRACE)
    metrics = flatten_metrics(engine.collect_metrics())
    assert metric_value(metrics, "kubeshare_serving_spec_tokens_total",
                        tenant="default", kind="accepted") \
        == engine.spec_accepted["default"] > 0
    assert metric_value(metrics, "kubeshare_serving_spec_loop_units_total") \
        == engine.spec_loop_units > 0
    assert metric_value(metrics, "kubeshare_serving_dispatches_total",
                        kind="spec_loop") == engine.spec_loop_launches
    assert metric_value(
        metrics, "kubeshare_serving_spec_acceptance_ratio_count",
        tenant="default") > 0
    assert metric_value(metrics, "kubeshare_serving_loop_exit_reason_total",
                        reason="ring_empty") \
        == engine.loop_exit_reasons["ring_empty"]


@pytest.mark.parametrize("overrides,match", [
    (dict(admission_ring=2), "admission_ring 2 requires"),
    (dict(admission_ring=2, speculative=True), "admission_ring 2 requires"),
    (dict(speculative=True, draft_len=3), "draft_len must be a power of two"),
], ids=["ring_without_speculation", "ring_without_loop", "draft_len_3"])
def test_speculative_config_rows_raise_like_jax(model, overrides, match):
    jax_cfg, jp, cfg, tp = model
    with pytest.raises(ValueError, match=match):
        JaxServingEngine(jp, jax_cfg, JaxEngineConfig(**POOL, **overrides))
    with pytest.raises(ValueError, match=match):
        ServingEngine(tp, cfg, EngineConfig(**{**POOL, **overrides}),
                      device="cpu")
