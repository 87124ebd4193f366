"""Port parity: kubeshare_tpu_torch.serving.kv_tier and the engine's KV
tiers against kubeshare_tpu.serving on the CPU.

The wire format's bytes equal the JAX package's for the same slab bits,
f32 and bf16 (the port stages bf16 as its raw int16 words), and frames
unpack across the packages; the stores (HostTier, DiskTier, the LRU and
QoS policies) make the same victims under the same put / pin / take /
forget sequence.  The engine, on the shape of
benchmarks/serving_bench.py's ``tiered_smoke_settings`` cut to a
13-block pool, drives a demote -> promote trace (a cached prompt flushed
through the tier by two long prompts, then matched again): with the tier
on, its greedy streams equal the JAX engine's at f32 and its own with the
tier off, and the tier counters equal JAX's through a host pass and a
disk cascade.  The JAX engines run once each, in module-scoped
fixtures."""

import struct
import zlib

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
from kubeshare_tpu.serving import kv_tier as jax_tier
from kubeshare_tpu.serving.qos import QOS_OPPORTUNISTIC as JAX_OPP
from kubeshare_tpu.serving.qos import TenantRegistry as JaxRegistry
from kubeshare_tpu.serving.qos import TenantSpec as JaxSpec
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models import decoding
from kubeshare_tpu_torch.models.transformer import TransformerConfig
from kubeshare_tpu_torch.serving import (QOS_OPPORTUNISTIC, EngineConfig,
                                         HostTier, LRUTierPolicy, Request,
                                         ServingEngine, TenantRegistry,
                                         TenantSpec, kv_tier)
from kubeshare_tpu_torch.serving.metrics_view import (flatten_metrics,
                                                      metric_value)

torch.set_num_threads(1)

BASE = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq_len=64, attention="reference")
CASES = {"gqa_rope": dict(n_kv_heads=2, positional="rope"),
         "windowed": dict(attention_window=6)}
# one slot and 12 usable blocks: two 29-token flushers (8 blocks each)
# drain the cached prompt through the tier between its two uses
POOL = dict(num_slots=1, block_size=4, num_blocks=13, max_request_len=32,
            prefill_chunk=8)
HOST = 1 << 20


def _full_wire(config):
    return kv_tier.wire_block_bytes(4, config.n_layers, config.kv_heads, 4,
                                    config.head_dim, 4)


def _trace(seed=11):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 64, 13)
    return [("r0", shared, 3),
            ("f1", rng.integers(0, 64, 29), 3),
            ("f2", rng.integers(0, 64, 29), 3),
            ("hit", np.concatenate([shared, rng.integers(0, 64, 4)]), 3)]


TRACE = _trace()
COUNTERS = ("tier_demoted_blocks", "tier_promoted_blocks",
            "tier_dropped_blocks", "tier_hit_requests", "tier_hit_tokens",
            "tier_corrupt_blocks")
DISK_COUNTERS = ("stored_blocks", "promoted_blocks", "evicted_blocks",
                 "refused_blocks", "corrupt_reads")


def _models(extra):
    dims = {**BASE, **extra}
    jax_cfg = JaxConfig(dtype=jnp.float32, **dims)
    params = jax_init(jax.random.PRNGKey(0), jax_cfg)
    return (jax_cfg, params, TransformerConfig(dtype=torch.float32, **dims),
            params_from_jax(jax.device_get(params), "cpu"))


@pytest.fixture(scope="module")
def models():
    return {name: _models(extra) for name, extra in CASES.items()}


def _counters(engine):
    out = {name: getattr(engine, name) for name in COUNTERS}
    out["evictions_by_reason"] = dict(engine.evictions_by_reason)
    out["host_evicted"] = engine.host_tier.evicted_blocks
    if engine.disk_tier is not None:
        out["disk"] = {name: getattr(engine.disk_tier, name)
                       for name in DISK_COUNTERS}
    return out


def _jax_run(model, trace=TRACE, **overrides):
    jax_cfg, params, _, _ = model
    engine = JaxServingEngine(params, jax_cfg,
                              JaxEngineConfig(**{**POOL, **overrides}))
    out = {}
    for rid, prompt, new in trace:
        engine.submit(JaxRequest(rid, prompt.astype(np.int32), new))
        out.update({k: r.tokens for k, r in engine.run().items() if r.done})
        engine.pop_finished()
    counters = _counters(engine) if engine.host_tier is not None else None
    if engine.disk_tier is not None:
        engine.disk_tier.close()
    return out, counters


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engine's streams and counters: a host pass per model and a
    disk cascade (three full blocks of host room) on the first."""
    runs = {name: _jax_run(models[name], host_tier_bytes=HOST)
            for name in CASES}
    cfg = models["gqa_rope"][2]
    runs["disk"] = _jax_run(models["gqa_rope"],
                            host_tier_bytes=3 * _full_wire(cfg),
                            disk_tier_bytes=1 << 20)
    return runs


def _engine(model, tenants=None, **overrides):
    _, _, cfg, tp = model
    return ServingEngine(tp, cfg, EngineConfig(**{**POOL, **overrides}),
                         tenants=tenants, device="cpu")


def _serve(engine, trace=TRACE, **request):
    """The trace one request at a time (each drains before the next), with
    every shape captured at warm-up and none after."""
    engine.warmup()
    counts = engine.capture_counts()
    out = {}
    for rid, prompt, new in trace:
        engine.submit(Request(rid, prompt, new, **request.get(rid, {})))
        out.update({k: r.tokens for k, r in engine.run().items() if r.done})
    assert engine.capture_counts() == counts
    assert engine.allocator.blocks_in_use == 0
    return out


# ----------------------------------------------------------------------
# the wire format
# ----------------------------------------------------------------------
def _slabs(dtype_name, seed=0):
    """(JAX-side numpy slabs, port-side tensors) holding the same bits."""
    rng = np.random.default_rng(seed)
    shape = (2, 2, 4, 8)
    if dtype_name == "float32":
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        return (k, v), (torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    k, v = (rng.integers(0, 1 << 16, shape, dtype=np.uint16)
            for _ in range(2))
    jax_side = (k.view(jnp.bfloat16), v.view(jnp.bfloat16))
    port = tuple(torch.from_numpy(w.view(np.int16).copy()).view(torch.bfloat16)
                 for w in (k, v))
    return jax_side, port


def _bits(slab):
    if isinstance(slab, torch.Tensor):
        return (slab.view(torch.int16) if slab.dtype == torch.bfloat16
                else slab).numpy().tobytes()
    return np.ascontiguousarray(slab).tobytes()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_wire_bytes_equal_jax_and_unpack_across(dtype_name):
    (jk, jv), (tk, tv) = _slabs(dtype_name)
    toks = np.asarray([5, 9, 2], np.int32)  # a partial block (3 < 4)
    frame = kv_tier.pack_block(toks, tk, tv)
    assert frame == jax_tier.pack_block(toks, jk, jv)
    assert len(frame) == kv_tier.wire_block_bytes(3, 2, 2, 4, 8,
                                                  tk.element_size())
    full = np.arange(4, dtype=np.int32)
    frames = [frame, kv_tier.pack_block(full, tv, tk)]
    chain = kv_tier.pack_chain(frames)
    assert chain == jax_tier.pack_chain(
        [frame, jax_tier.pack_block(full, jv, jk)])
    assert kv_tier.unpack_chain(chain) == frames
    # a JAX frame unpacks in the port to the same bits, and back
    t2, k2, v2 = kv_tier.unpack_block(jax_tier.pack_block(toks, jk, jv))
    assert k2.dtype == tk.dtype and k2.device.type == "cpu"
    assert np.array_equal(t2, toks)
    assert _bits(k2) == _bits(jk) and _bits(v2) == _bits(jv)
    t3, k3, v3 = jax_tier.unpack_block(frame)
    assert np.array_equal(t3, toks)
    assert _bits(k3) == _bits(tk) and _bits(v3) == _bits(tv)
    # the identity, re-packed
    assert kv_tier.pack_block(t2, k2, v2) == frame


def _reseal(buf: bytes) -> bytes:
    return buf[:-4] + struct.pack("<I", zlib.crc32(buf[:-4]) & 0xFFFFFFFF)


def test_wire_rejects_rot_and_foreign_bytes():
    _, (tk, tv) = _slabs("bfloat16")
    buf = kv_tier.pack_block([1, 2, 3, 4], tk, tv)
    for at in (0, 5, kv_tier._HEADER.size + 1, len(buf) // 2, len(buf) - 1):
        bad = bytearray(buf)
        bad[at] ^= 0x40
        with pytest.raises(kv_tier.WireCorruption):
            kv_tier.unpack_block(bytes(bad))
    with pytest.raises(ValueError, match="magic"):
        kv_tier.unpack_block(_reseal(b"XXXX" + buf[4:]))
    with pytest.raises(ValueError, match="version"):
        kv_tier.unpack_block(_reseal(buf[:4] + b"\x63\x00" + buf[6:]))
    with pytest.raises(kv_tier.WireCorruption, match="truncated"):
        kv_tier.unpack_block(buf[:10])
    chain = kv_tier.pack_chain([buf])
    with pytest.raises(ValueError, match="magic"):
        kv_tier.unpack_chain(b"XXXX" + chain[4:])
    with pytest.raises(ValueError, match="version"):
        kv_tier.unpack_chain(chain[:4] + b"\x09\x00" + chain[6:])
    with pytest.raises(ValueError, match="trailing"):
        kv_tier.unpack_chain(chain + b"\0")
    with pytest.raises(ValueError, match="mismatch"):
        kv_tier.pack_block([1], tk, tv.float())


# ----------------------------------------------------------------------
# the stores
# ----------------------------------------------------------------------
def _host_sequence(mod, policy_factory, registry):
    """Run one put / pin / take / forget sequence under budget pressure;
    returns a record of every outcome."""
    tier = mod.HostTier(3 * 100, policy_factory(registry))
    log = []

    def put(payload, tenant):
        key = tier.put(payload, tenant, None)
        log.append(("put", key, tier.used_bytes, len(tier),
                    sorted(e.key for _, e in tier.iter_lru())))
        return key

    g0 = put(b"g" * 100, "gold")
    b0 = put(b"b" * 100, "batch")
    g1 = put(b"h" * 100, "gold")
    put(b"i" * 100, "gold")          # evicts (LRU: g0; QoS: b0)
    put(b"c" * 100, "batch")         # QoS: refused (only gold to evict)
    tier.pin(g1)
    log.append(("peek", tier.peek(g1).payload))
    put(b"d" * 150, None)            # needs two victims, g1 pinned
    tier.unpin(g1)
    if tier.probe(g1) is not None:
        log.append(("take", tier.take(g1).payload, tier.used_bytes))
    log.append(("forget", tier.forget(b0), tier.forget(g0)))
    put(b"e" * 301, "gold")          # over budget: refused up front
    log.append(("counters", tier.stored_blocks, tier.evicted_blocks,
                tier.refused_blocks, tier.peak_bytes, tier.used_bytes))
    return log


@pytest.mark.parametrize("policy", ["lru", "qos"])
def test_host_tier_sequence_equals_jax(policy):
    names = {"lru": "LRUTierPolicy", "qos": "QoSTierPolicy"}

    def factory(mod):
        cls = getattr(mod, names[policy])
        return (lambda registry: cls()) if policy == "lru" else cls

    jax_reg = JaxRegistry([JaxSpec("gold"),
                           JaxSpec("batch", qos_class=JAX_OPP)])
    reg = TenantRegistry([TenantSpec("gold"),
                          TenantSpec("batch", qos_class=QOS_OPPORTUNISTIC)])
    assert (_host_sequence(kv_tier, factory(kv_tier), reg)
            == _host_sequence(jax_tier, factory(jax_tier), jax_reg))


def _disk_sequence(mod):
    tier = mod.DiskTier(budget_bytes=300)
    big = mod.DiskTier(budget_bytes=1 << 22)
    try:
        log = []
        a = tier.put(b"a" * 100, None, None)
        b = tier.put(b"b" * 100, None, None)
        c = tier.put(b"c" * 100, None, None)
        log.append(("read", tier.read(a), tier.used_bytes))
        d = tier.put(b"d" * 100, None, None)   # evicts b (a was read)
        log.append(("evict", tier.probe(b) is None, tier.evicted_blocks,
                    tier.probe(d).offset))
        log.append(("take", tier.take(c), tier.promoted_blocks,
                    tier.used_bytes))
        for key in (a, d):
            tier.pin(key)
        e = tier.put(b"e" * 60, None, None)    # where c was
        log.append(("hole", tier.probe(e).offset, tier.probe(c) is None))
        f = tier.put(b"f" * 40, None, None)    # the rest of c's room
        log.append(("hole", tier.probe(f).offset))
        log.append(("refuse", tier.put(b"g" * 100, None, None),
                    tier.refused_blocks))
        tier.unpin(a)
        log.append(("forget", tier.forget(e), tier.forget(e)))
        g = tier.put(b"g" * 120, None, None)   # evicts a
        log.append(("placed", tier.probe(g).offset, tier._holes,
                    tier._tail, tier.used_bytes, tier.peak_bytes))
        k1 = big.put(b"q" * 37, None, None)
        k2 = big.put(b"z" * (1 << 20), None, None)  # grows the arena
        log.append(("grow", big.read(k1), len(big.read(k2)),
                    big._capacity))
        return log
    finally:
        tier.close()
        big.close()


def test_disk_tier_sequence_equals_jax():
    log = _disk_sequence(kv_tier)
    assert log == _disk_sequence(jax_tier)
    # d reused the hole b's eviction left; c's room (the tail, given back
    # when c was taken) took e (60 bytes) then f (40)
    assert log[1][3] == 100
    assert log[3][1] == 200 and log[4][1] == 260


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_tier_streams_equal_jax_engine_and_tier_off(models, jax_runs, case):
    tiered = _engine(models[case], host_tier_bytes=HOST)
    got = _serve(tiered)
    assert got == jax_runs[case][0]
    assert got == _serve(_engine(models[case]))
    assert tiered.tier_demoted_blocks > 0 and tiered.tier_promoted_blocks > 0
    assert tiered.capture_counts()["upload"] == 1
    assert _counters(tiered) == jax_runs[case][1]


def test_disk_cascade_counters_equal_jax_engine(models, jax_runs):
    cfg = models["gqa_rope"][2]
    engine = _engine(models["gqa_rope"], host_tier_bytes=3 * _full_wire(cfg),
                     disk_tier_bytes=1 << 20)
    try:
        got = _serve(engine)
        counters = _counters(engine)
    finally:
        engine.disk_tier.close()
    assert got == jax_runs["disk"][0] == jax_runs["gqa_rope"][0]
    assert counters == jax_runs["disk"][1]
    assert counters["disk"]["stored_blocks"] > 0
    assert counters["disk"]["promoted_blocks"] > 0
    metrics = flatten_metrics(engine.collect_metrics())
    assert metric_value(metrics, "kubeshare_serving_disk_tier_blocks_total",
                        event="promoted") == counters["disk"]["promoted_blocks"]
    assert metric_value(metrics, "kubeshare_serving_tier_blocks_total",
                        event="demoted") == engine.tier_demoted_blocks
    assert metric_value(metrics, "kubeshare_serving_tier_requests_total",
                        result="hit") == engine.tier_hit_requests


def test_sampled_streams_equal_with_tier_off(models):
    """The seed schedule survives a tier hit."""

    def sampled():
        return {rid: dict(temperature=0.8,
                          rng=torch.Generator().manual_seed(40 + i))
                for i, (rid, _, _) in enumerate(TRACE)}

    tiered = _engine(models["gqa_rope"], top_k=10, host_tier_bytes=HOST)
    got = _serve(tiered, **sampled())
    assert got == _serve(_engine(models["gqa_rope"], top_k=10), **sampled())
    assert tiered.tier_promoted_blocks > 0


def test_cow_on_promoted_block_and_quota_honesty(models):
    """A prompt diverging inside a promoted block copies it on write and
    still emits the dense greedy stream; a tenant whose idle cache was
    demoted stops being charged for it, and promotion charges again."""
    _, _, cfg, tp = models["gqa_rope"]
    registry = TenantRegistry([TenantSpec("t", kv_block_quota=6),
                               TenantSpec("u")])
    engine = _engine(models["gqa_rope"], tenants=registry,
                     host_tier_bytes=HOST)
    engine.warmup()
    rng = np.random.default_rng(17)
    shared = rng.integers(0, 64, 13)

    def serve(rid, prompt, new, tenant):
        engine.submit(Request(rid, prompt, new, tenant=tenant))
        return engine.run()[rid].tokens

    serve("a", shared, 3, "t")
    assert engine.allocator.tenant_usage("t") == 4  # idle, charged
    for rid in ("u1", "u2"):  # u's traffic demotes t's cache
        serve(rid, rng.integers(0, 64, 29), 3, "u")
    assert engine.tier_demoted_blocks > 0
    assert engine.allocator.tenant_usage("t") == 0  # uncharged
    hit = np.concatenate([shared, rng.integers(0, 64, 4)])
    serve("a2", hit, 3, "t")
    assert engine.tier_promoted_blocks >= 3
    assert 3 <= engine.allocator.tenant_usage("t") <= 6  # charged again
    diverge = hit.copy()
    diverge[9] = (diverge[9] + 1) % 64  # inside the third block
    cows = engine.cow_copies
    got = serve("cow", diverge, 4, "u")  # t's quota would refuse the hit
    assert engine.cow_copies == cows + 1
    want = decoding.greedy_decode(tp, cfg, torch.from_numpy(diverge)[None], 4)
    assert got == want[0].tolist()


def test_subtree_walk_survives_one_block_host_budget(models):
    cfg = models["gqa_rope"][2]
    engine = _engine(models["gqa_rope"], host_tier_bytes=_full_wire(cfg))
    shared = np.random.default_rng(41).integers(0, 64, 13)
    engine.submit(Request("r0", shared, 3))
    engine.run()
    matched, blocks = engine.prefix_index.match(shared)
    assert matched == 13
    with engine.allocator._lock:
        engine.allocator._evict_locked(blocks[0], "reservation_pressure")
    # the head demoted (pinned through the walk), its descendants dropped
    assert engine.tier_demoted_blocks == 1
    assert engine.tier_dropped_blocks == 3
    assert len(engine.host_tier) == 1
    survivor = next(e.key for _, e in engine.host_tier.iter_lru())
    assert not engine.host_tier.is_pinned(survivor)
    assert (engine.allocator.free_blocks + engine.allocator.cached_idle_blocks
            == engine.allocator.num_blocks - 1)


def test_demoted_payload_is_the_device_rows(models):
    """Device rows -> host payload -> device rows, bit for bit, through
    the walk's one gather and the upload program."""
    engine = _engine(models["windowed"], host_tier_bytes=HOST)
    engine.warmup()
    trace = _trace(7)  # its flushers demote the whole cached chain
    shared = trace[0][1]
    engine.submit(Request("r0", shared, 3))
    engine.run()
    _, blocks = engine.prefix_index.match(shared)
    rows = [(engine.pool.k[:, b].clone(), engine.pool.v[:, b].clone())
            for b in blocks[:3]]
    assert kv_tier.unpack_block(engine._read_block_payload(
        engine.prefix_index.node_of(blocks[0])))[1].equal(rows[0][0])
    for rid, prompt, new in trace[1:3]:
        engine.submit(Request(rid, prompt, new))
        engine.run()
    _, chain = engine.prefix_index.match_tiered(shared)
    for node, (k, v) in zip(chain[:3], rows):
        assert node.location == "host"
        _, hk, hv = kv_tier.unpack_block(
            engine.host_tier.peek(node.host_key).payload)
        assert hk.equal(k) and hv.equal(v)
    engine.submit(Request("again", shared.copy(), 3))
    engine.run()
    _, blocks = engine.prefix_index.match(shared)
    for b, (k, v) in zip(blocks[:3], rows):
        assert engine.pool.k[:, b].equal(k) and engine.pool.v[:, b].equal(v)


def test_shared_host_tier_serves(models):
    tier = HostTier(HOST, LRUTierPolicy())
    engine = _engine(models["gqa_rope"])
    shared_engine = ServingEngine(
        models["gqa_rope"][3], models["gqa_rope"][2],
        EngineConfig(**POOL), shared_host_tier=tier, device="cpu")
    tier.on_drop = shared_engine._drop_host_entry
    assert shared_engine.host_tier is tier
    assert _serve(shared_engine) == _serve(engine)
    assert shared_engine.tier_promoted_blocks > 0 and len(tier) > 0


def _churn_trace(n=14):
    """serving_bench's tiered workload at a tiny width: 8 distinct
    96-token prefixes chosen uniformly, private tails of 8-24 tokens."""
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(0, 64, 96) for _ in range(8)]
    trace = []
    for i in range(n):
        prefix = prefixes[int(rng.integers(8))]
        tail = rng.integers(0, 64, int(rng.integers(8, 25)))
        trace.append((f"req{i}", np.concatenate([prefix, tail]),
                      int(rng.integers(4, 13))))
    return trace


def test_disk_staging_keeps_the_hits_host_blocks_pinned():
    """Under churn, staging a hit's disk blocks to a full host tier must
    not spill the hit's own host blocks: the JAX engine does (its staging
    pins only the blocks it stages), and its admission then reads a
    payload that left the host tier (AttributeError); the port pins the
    whole hit and serves the tier-off streams."""
    extra = dict(max_seq_len=160)
    model = _models(extra)
    jax_cfg, params, cfg, _ = model
    pool = dict(num_slots=8, block_size=16, max_request_len=160,
                prefill_chunk=64, decode_span=4, num_blocks=41)
    # just under six blocks of host room, with a disk arena below it
    tiers = dict(host_tier_bytes=6 * kv_tier.wire_block_bytes(
        16, cfg.n_layers, cfg.kv_heads, 16, cfg.head_dim, 4) - 24,
        disk_tier_bytes=1 << 20)
    trace = _churn_trace()
    engine = ServingEngine(model[3], cfg, EngineConfig(**pool, **tiers),
                           device="cpu")
    plain = ServingEngine(model[3], cfg, EngineConfig(**pool), device="cpu")
    try:
        for e in (engine, plain):
            for rid, prompt, new in trace:
                e.submit(Request(rid, prompt, new))
        got = {rid: r.tokens for rid, r in engine.run().items()}
        assert engine.tier_hit_requests > 0 and engine.disk_tier.stored_blocks > 0
    finally:
        engine.disk_tier.close()
    assert got == {rid: r.tokens for rid, r in plain.run().items()}
    jax_engine = JaxServingEngine(params, jax_cfg,
                                  JaxEngineConfig(**pool, **tiers))
    try:
        for rid, prompt, new in trace:
            jax_engine.submit(JaxRequest(rid, prompt.astype(np.int32), new))
        with pytest.raises(AttributeError, match="payload"):
            jax_engine.run()
    finally:
        jax_engine.disk_tier.close()
