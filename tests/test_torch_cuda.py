"""The port's captured (CUDA graph) serving and sharded training paths
against their eager forms, the f32 flash kernels (3xTF32 on the tensor
cores) against their plain versions, the full-width ResNet against the
CPU, a checkpoint restored into a captured train step, prefetch's
stream ordering, two gloo ranks of train_distributed_torch.py on one
card, device discovery against nvidia-smi, a captured step under the
CUDA driver interposer (libcudahook.so.1), and the root twins of
examples/ at their full configurations (the MNIST pod under the env the
port's scheduler injects), on the card.  Every test here skips without
a CUDA device.

The file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

At f32 with TF32 off a graph replays the eager step's kernels on the same
inputs, so captured and eager tokens are equal and the logits agree to
round-off."""

import dataclasses

import numpy as np
import pytest
import torch

from kubeshare_tpu_torch.data import prefetch_to_device
from kubeshare_tpu_torch.models import decoding
from kubeshare_tpu_torch.models.resnet import (ResNetConfig, resnet_apply,
                                               resnet_init)
from kubeshare_tpu_torch.ops import attention as A
from kubeshare_tpu_torch.models.transformer import (
    TransformerConfig, transformer_apply, transformer_init,
    transformer_sharding_rules)
from kubeshare_tpu_torch.parallel.checkpoint import (restore_checkpoint,
                                                     save_checkpoint)
from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from kubeshare_tpu_torch.parallel.train import (_make_capturable, adamw,
                                                make_train_step, tree_leaves)
from kubeshare_tpu_torch.serving import (DisaggRouter, EngineConfig,
                                         ReplicaFleet, Request,
                                         ServingEngine, ShardedServingContext,
                                         kv_tier, paged)
from kubeshare_tpu_torch.serving.chaos import FaultClock, FaultPlan

pytestmark = pytest.mark.cuda

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=64, attention="reference", positional="rope",
             n_kv_heads=2, dtype=torch.float32)
LOGITS_TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    config = TransformerConfig(**MODEL)
    params = transformer_init(config, torch.Generator().manual_seed(0), device)
    return device, config, params


def test_captured_dense_decode_equals_eager(card):
    device, config, params = card
    prompt = torch.randint(0, 64, (3, 9), generator=torch.Generator()
                           .manual_seed(1)).to(device)
    outs = []
    for capture in (False, True):
        cache, logits = decoding.prefill(params, config, prompt)
        outs.append(decoding.greedy_decode_with_cache(
            params, config, cache, logits, 20, capture=capture))
        assert int(cache["length"]) == 9 + 19
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    # one step, logits against logits
    cache, logits = decoding.prefill(params, config, prompt)
    eager_cache = {k: v.clone() for k, v in cache.items()}
    token = torch.argmax(logits, dim=-1)
    step = decoding.make_decode_step(params, config, 3, capture=True)
    got = step(cache, token)
    want = decoding.make_decode_step(params, config, 3, capture=False)(
        eager_cache, token)
    torch.testing.assert_close(got, want, rtol=LOGITS_TOL, atol=LOGITS_TOL)
    with pytest.raises(ValueError, match="cache it was captured with"):
        step(eager_cache, token)


def test_captured_decode_span_equals_eager(card):
    device, config, params = card
    s, t, bs, nb = 3, 8, 4, 30
    shape = (config.n_layers, nb, config.kv_heads, bs, config.head_dim)
    gen = torch.Generator().manual_seed(2)
    pool = [torch.randn(shape, generator=gen).to(device) for _ in range(2)]
    tables = torch.arange(1, 1 + s * t).reshape(s, t).to(device)
    args = dict(
        lengths=torch.tensor([13, 5, 20], device=device),
        active=torch.tensor([True, True, False], device=device),
        tokens=torch.tensor([3, 9, 0], device=device),
        temps=torch.tensor([0.0, 0.9, 0.0], device=device),
        seeds=torch.randint(0, 2 ** 62, (s, 4), generator=gen).to(device),
        budgets=torch.tensor([4, 2, 0], device=device))

    def span(pk, pv):
        return paged.paged_decode_span(
            params, config, decoding.pick_rows, 4, None, pk, pv, tables,
            args["lengths"], args["active"], args["tokens"], args["temps"],
            args["seeds"], args["budgets"])

    eager_pool = [p.clone() for p in pool]
    want = span(*eager_pool)
    graph_pool = [p.clone() for p in pool]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        span(*[p.clone() for p in pool])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = span(*graph_pool)
    graph.replay()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(graph_pool, eager_pool):
        torch.testing.assert_close(a[:, 1:], b[:, 1:], rtol=0, atol=0)


@pytest.mark.parametrize("steps_per_launch", [1, 4])
def test_captured_engine_equals_dense_greedy(card, steps_per_launch):
    device, config, params = card
    rng = np.random.default_rng(3)
    base = rng.integers(0, 64, 14)
    trace = [("r0", np.concatenate([base, rng.integers(0, 64, 3)]), 6),
             ("r1", rng.integers(0, 64, 5), 9),
             ("r2", rng.integers(0, 64, 19), 4),
             ("r3", np.concatenate([base, rng.integers(0, 64, 1)]), 7),
             ("r4", rng.integers(0, 64, 2), 11)]
    engine = ServingEngine(params, config, EngineConfig(
        num_slots=3, block_size=4, num_blocks=41, max_request_len=48,
        prefill_chunk=8, steps_per_launch=steps_per_launch), device=device)
    engine.warmup()
    counts = engine.capture_counts()
    assert counts["prefill"] == 4 and counts["mixed"] == 4
    for rid, prompt, new in trace:
        engine.submit(Request(rid, prompt, new))
    out = engine.run()
    assert engine.capture_counts() == counts
    for rid, prompt, new in trace:
        want = decoding.greedy_decode(
            params, config, torch.from_numpy(prompt)[None].to(device), new)
        assert out[rid].tokens == want[0].tolist(), rid
    timed = engine.dispatch_device_ms()
    assert timed["mixed"][0] >= 1 and timed["mixed"][1] > 0


def test_captured_speculative_round_equals_eager(card):
    device, config, params = card
    draft_config = TransformerConfig(**{**MODEL, "n_layers": 1,
                                        "d_model": 16, "n_heads": 2,
                                        "n_kv_heads": 1})
    draft = transformer_init(draft_config, torch.Generator().manual_seed(9),
                             device)
    prompt = torch.randint(0, 64, (3, 9), generator=torch.Generator()
                           .manual_seed(4)).to(device)
    runs = [decoding.speculative_greedy_decode(
        params, config, draft, draft_config, prompt, 20, draft_len=4,
        return_stats=True, capture=capture) for capture in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    want = decoding.greedy_decode(params, config, prompt, 20)
    assert torch.equal(runs[1][0], want)
    # a replay past completion changes nothing
    state = decoding.speculative_state(params, config, params, config,
                                       prompt, 9, 4)
    step = decoding.make_speculative_round(params, config, params, config,
                                           state, 9, 4, capture=True)
    while int(state["n_done"]) < 9:
        step()
    saved = {k: state[k].clone() for k in ("out", "last", "n_done",
                                             "rounds")}
    cache_k = state["cache"]["k"].clone()
    step()
    for k, v in saved.items():
        assert torch.equal(state[k], v), k
    assert torch.equal(state["cache"]["k"], cache_k)


def test_speculative_engine_captures_nothing_after_warmup(card):
    device, config, params = card
    rng = np.random.default_rng(5)
    cycle = rng.integers(0, 64, 5)
    trace = [("r0", np.tile(cycle, 4), 12), ("r1", rng.integers(0, 64, 9), 7),
             ("r2", np.tile(cycle[:3], 5), 15), ("r3", rng.integers(0, 64, 4), 9),
             ("r4", np.tile(cycle, 3), 10)]
    engine = ServingEngine(params, config, EngineConfig(
        num_slots=3, block_size=4, num_blocks=41, max_request_len=48,
        prefill_chunk=8, speculative=True, steps_per_launch=4,
        admission_ring=2), device=device)
    engine.warmup()
    counts = engine.capture_counts()
    assert counts["verify"] == 3 and counts["mixed_verify"] == 12
    assert counts["spec_loop"] == 1
    for rid, prompt, new in trace:
        engine.submit(Request(rid, prompt, new))
    out = engine.run()
    assert engine.capture_counts() == counts
    assert engine.verify_steps > 0
    for rid, prompt, new in trace:
        want = decoding.greedy_decode(
            params, config, torch.from_numpy(prompt)[None].to(device), new)
        assert out[rid].tokens == want[0].tolist(), rid


def test_bf16_demote_promote_round_trip_through_the_upload_graph(card):
    """Random bf16 rows in one pool block come back bit for bit in another
    through the demotion read (a gather and a device-to-host copy),
    pack_block / unpack_block, and the captured upload program."""
    device, _, _ = card
    config = TransformerConfig(**{**MODEL, "dtype": torch.bfloat16})
    params = transformer_init(config, torch.Generator().manual_seed(0), device)
    engine = ServingEngine(params, config, EngineConfig(
        num_slots=2, block_size=4, num_blocks=9, max_request_len=16,
        prefill_chunk=8, host_tier_bytes=1 << 20), device=device)
    engine.warmup()
    counts = engine.capture_counts()
    assert counts["upload"] == 1
    pool = engine.pool
    # warm-up and capture wrote only scratch block 0
    assert not pool.k[:, 1:].any() and not pool.v[:, 1:].any()
    src, dst = 3, 6
    gen = torch.Generator(device=device).manual_seed(1)
    for slab in (pool.k, pool.v):
        slab[:, src] = torch.randn(slab[:, src].shape, generator=gen,
                                   device=device).to(torch.bfloat16)

    class Node:
        block, tokens = src, (1, 2, 3, 4)

    tokens, k, v = kv_tier.unpack_block(engine._read_block_payload(Node))
    assert k.dtype == torch.bfloat16 and list(tokens) == [1, 2, 3, 4]
    engine._upload(dst, k, v)
    torch.cuda.synchronize(device)
    for slab in (pool.k, pool.v):
        assert torch.equal(slab[:, dst].view(torch.int16),
                           slab[:, src].view(torch.int16))
    assert engine.capture_counts() == counts
    assert engine.dispatch_device_ms()["upload"][0] == 1


def test_tiered_engine_captures_nothing_after_warmup(card):
    """A demote -> promote trace through the host tier and the disk
    cascade on the card: dense greedy streams, one upload graph, no
    capture after warm-up."""
    device, config, params = card
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 64, 13)
    trace = [("r0", shared, 3), ("f1", rng.integers(0, 64, 29), 3),
             ("f2", rng.integers(0, 64, 29), 3),
             ("hit", np.concatenate([shared, rng.integers(0, 64, 4)]), 3)]
    wire = kv_tier.wire_block_bytes(4, config.n_layers, config.kv_heads, 4,
                                    config.head_dim, 4)
    engine = ServingEngine(params, config, EngineConfig(
        num_slots=1, block_size=4, num_blocks=13, max_request_len=32,
        prefill_chunk=8, host_tier_bytes=3 * wire, disk_tier_bytes=1 << 20),
        device=device)
    try:
        engine.warmup()
        counts = engine.capture_counts()
        for rid, prompt, new in trace:
            engine.submit(Request(rid, prompt, new))
            out = engine.run()
            want = decoding.greedy_decode(
                params, config, torch.from_numpy(prompt)[None].to(device), new)
            assert out[rid].tokens == want[0].tolist(), rid
        assert engine.capture_counts() == counts and counts["upload"] == 1
        assert engine.tier_promoted_blocks > 0
        assert engine.disk_tier.promoted_blocks > 0
    finally:
        engine.disk_tier.close()


# the disaggregated pools at the serving flagship's width, two layers deep
FLAGSHIP = dict(vocab_size=2048, d_model=512, n_heads=8, n_layers=2,
                d_ff=1408, max_seq_len=1024, dtype=torch.bfloat16)
DISAGG = dict(block_size=16, max_request_len=320, prefill_chunk=64,
              decode_span=2, mixed=False)


def _disagg_trace(n, vocab):
    rng = np.random.default_rng(3)
    return [(f"r{i}", rng.integers(0, vocab, int(rng.integers(17, 150))),
             int(rng.integers(6, 24))) for i in range(n)]


def _flagship(device):
    config = TransformerConfig(**FLAGSHIP)
    return config, transformer_init(config, torch.Generator().manual_seed(0),
                                    device)


def _two_cell(params, config, device, **overrides):
    return DisaggRouter(
        params, config,
        EngineConfig(num_slots=2, num_blocks=41, **DISAGG, **overrides),
        EngineConfig(num_slots=4, num_blocks=81, **DISAGG, **overrides),
        max_pending_handoffs=4, device=device)


def _served(engine, trace):
    for rid, prompt, new in trace:
        engine.submit(Request(rid, prompt, new))
    out = engine.run()
    return {rid: out[rid].tokens for rid, _, _ in trace}


def test_two_cell_router_on_the_flagship_equals_the_monolithic_engine(card):
    """Both pools capture at warm-up and nothing after; the streams equal
    a mixed=False monolithic engine's whose decode spans have the decode
    pool's shape (4 slots), token for token in bf16."""
    device, _, _ = card
    config, params = _flagship(device)
    trace = _disagg_trace(10, config.vocab_size)
    mono = ServingEngine(params, config, EngineConfig(
        num_slots=4, num_blocks=121, **DISAGG), device=device)
    mono.warmup()
    want = _served(mono, trace)
    router = _two_cell(params, config, device)
    router.warmup()
    base = router.capture_counts()
    assert base["prefill.prefill"] == 7 and base["decode.decode"] == 1
    assert base["decode.upload"] == 1 and base["prefill.decode"] == 0
    assert _served(router, trace) == want
    assert router.capture_counts() == base
    assert router.migrator.delivered == router.migrator.migrations \
        == len(trace)
    assert router.decode.dispatch_device_ms()["upload"][0] > 0


def test_a_chain_rewritten_right_after_its_handoff_keeps_its_bytes(card):
    """The handoff packs a chain and the prefill pool reclaims it at once:
    a write enqueued on the main stream the moment pack returns (what the
    next dispatch into the reclaimed blocks does) must not reach the
    migrated bytes, which equal the chain as the prefill pool wrote it.
    Prefix caching is off, so the reclaimed blocks are free for reuse."""
    device, _, _ = card
    config, params = _flagship(device)
    trace = _disagg_trace(8, config.vocab_size)
    router = _two_cell(params, config, device, prefix_cache=False)
    router.warmup()
    pool = router.prefill.pool
    checked = []
    handoff = router._handoff

    def rewrite_after_pack(slot):
        n = -(-slot.prompt.size // pool.block_size)
        blocks = [int(b) for b in slot.table[:n]]
        torch.cuda.synchronize(device)
        want = (pool.k[:, blocks].cpu(), pool.v[:, blocks].cpu())
        handoff(slot)
        for slab in (pool.k, pool.v):  # no synchronize: enqueued at once
            slab[:, blocks] = torch.randn(
                slab[:, blocks].shape, device=device).to(slab.dtype)
        frames = kv_tier.unpack_chain(router._tickets[-1].payload)
        got = [kv_tier.unpack_block(f)[1:] for f in frames]
        for j in range(n):
            assert torch.equal(got[j][0].view(torch.int16),
                               want[0][:, j].view(torch.int16))
            assert torch.equal(got[j][1].view(torch.int16),
                               want[1][:, j].view(torch.int16))
        checked.append(slot.rid)

    router.prefill.on_handoff = rewrite_after_pack
    mono = ServingEngine(params, config, EngineConfig(
        num_slots=4, num_blocks=121, **{**DISAGG, "prefix_cache": False}),
        device=device)
    assert _served(router, trace) == _served(mono, trace)
    assert len(checked) == len(trace)


# -- the replica fleet ------------------------------------------------------

FLEET_POOL = dict(num_slots=3, block_size=4, num_blocks=21,
                  max_request_len=48, prefill_chunk=8)


def _fleet_trace(n):
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 64, 12)
    return [(f"r{i}", np.concatenate([shared, rng.integers(0, 64, 4)])
             if i % 2 == 0 else rng.integers(0, 64, 10), 6 + i % 3)
            for i in range(n)]


def test_fleet_replicas_share_params_and_capture_nothing_after_warmup(card):
    """Two replicas on one card run on the caller's parameter tensors,
    capture every graph at warm-up and nothing after, and their f32
    streams equal a monolithic engine's at the same aggregate budget."""
    device, config, params = card
    trace = _fleet_trace(8)
    mono = ServingEngine(params, config, EngineConfig(
        **{**FLEET_POOL, "num_blocks": 41}), device=device)
    mono.warmup()
    want = _served(mono, trace)
    fleet = ReplicaFleet(params, config, EngineConfig(**FLEET_POOL),
                         replicas=2, shared_tier_bytes=1 << 20,
                         device=device)
    assert all(h.engine.params is params for h in fleet.replicas)
    fleet.warmup()
    base = fleet.capture_counts()
    assert base["r0.decode"] == base["r1.decode"] == 1
    assert _served(fleet, trace) == want
    assert fleet.capture_counts() == base
    fleet.drain(fleet.owner_of("r0"))
    fleet.run()
    assert fleet.handoff_blocks > 0
    assert fleet.capture_counts() == base


def test_scale_up_while_a_sibling_dispatch_is_in_flight(card):
    """scale_up() warms the new replica (capturing its graphs) while r0's
    newest dispatch is still in flight: the capture succeeds, r0's
    capture counts stay put, and r0's streams equal a fleet that never
    scaled."""
    device, config, params = card
    trace = _fleet_trace(6)

    def fleet():
        f = ReplicaFleet(params, config, EngineConfig(**FLEET_POOL),
                         replicas=1, device=device)
        f.warmup()
        return f

    want = _served(fleet(), trace)
    grown = fleet()
    for rid, prompt, new in trace:
        grown.submit(Request(rid, prompt, new))
    r0 = grown.replicas[0].engine
    while r0._inflight is None or r0._inflight[0] == "span" \
            and r0._inflight[1] is None:
        assert grown.step()
    assert r0._inflight is not None
    before = grown.capture_counts()
    handle = grown.scale_up()
    after = grown.capture_counts()
    assert {k: v for k, v in after.items() if k.startswith("r0.")} == before
    assert after["r1.decode"] == 1 and handle.engine.params is params
    out = grown.run()
    assert {rid: out[rid].tokens for rid, _, _ in trace} == want
    assert grown.capture_counts() == after


def test_kill_consumes_the_dead_replicas_inflight_fetch_first(card):
    """A kill lands while r0 has a dispatch in flight: recovery consumes
    that dispatch (waiting on its fetch) before the orphans are
    re-admitted, so they resume from the post-dispatch position, and
    every stream equals the fault-free fleet's."""
    device, config, params = card
    trace = _fleet_trace(8)

    class PinFirst:
        def route(self, fleet, request, candidates):
            return candidates[0], "least_loaded"

    def fleet(clock):
        f = ReplicaFleet(params, config, EngineConfig(**FLEET_POOL),
                         replicas=2, routing=PinFirst(),
                         shared_tier_bytes=1 << 20, fault_clock=clock,
                         device=device)
        f.warmup()
        return f

    want = _served(fleet(FaultClock(FaultPlan(seed=3))), trace)
    plan = FaultPlan(seed=3)
    clock = FaultClock(plan)
    doomed = fleet(clock)
    for rid, prompt, new in trace:
        doomed.submit(Request(rid, prompt, new))
    eng = doomed.replicas[0].engine
    while not (eng._inflight is not None and eng._inflight[1] is not None
               and any(s.state == "decode" for s in eng._slots)):
        assert doomed.step()
    plan.kill("r0", at_step=clock._steps.get("r0", 0))
    seen = []
    readmit = doomed._readmit_orphans

    def spy(handle):
        seen.append((handle.engine._inflight,
                     {s.rid: len(s.generated) for s in handle.engine._slots
                      if s.state != "free"}))
        return readmit(handle)

    doomed._readmit_orphans = spy
    emitted = {s.rid: len(s.generated) for s in eng._slots
               if s.state == "decode"}
    out = doomed.run()
    assert doomed.replica_failures == {"liveness": 1}
    assert seen and seen[0][0] is None
    # the consumed dispatch moved every decoding orphan forward
    assert any(seen[0][1].get(rid, 6) > n for rid, n in emitted.items())
    assert {rid: out[rid].tokens for rid, _, _ in trace} == want


MOE = dict(moe_every=2, moe_num_experts=4, moe_top_k=2)


@pytest.mark.parametrize("routing,dispatch", [
    ("tokens_choose", "scatter"), ("tokens_choose", "einsum"),
    ("experts_choose", "scatter"), ("experts_choose", "einsum")])
def test_moe_bits_equal_run_to_run(card, routing, dispatch):
    # bf16 at a width where repeated indices would meet in atomic adds (a
    # token's two choices, a token picked by several experts): the op's
    # forward and gradient must come out the same bits every run
    from kubeshare_tpu_torch.ops.moe import MoEConfig, moe_apply, moe_init

    device = card[0]
    config = MoEConfig(d_model=256, d_ff=512, num_experts=8, top_k=2,
                       routing=routing, dispatch=dispatch)
    params = moe_init(config, torch.Generator().manual_seed(3), device)
    x = torch.randn((2, 512, 256), generator=torch.Generator().manual_seed(4)
                    ).to(device, torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        xx = x.clone().requires_grad_()
        out, aux = moe_apply(leaves, xx, config)
        (out.float().square().mean() + 0.01 * aux).backward()
        runs.append([out, xx.grad] + [leaves[k].grad for k in sorted(leaves)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_captured_moe_decode_step_equals_eager(card):
    device, _, _ = card
    config = TransformerConfig(**{**MODEL, **MOE})
    params = transformer_init(config, torch.Generator().manual_seed(5), device)
    prompt = torch.randint(0, 64, (3, 9), generator=torch.Generator()
                           .manual_seed(6)).to(device)
    outs = []
    for capture in (False, True):
        cache, logits = decoding.prefill(params, config, prompt)
        outs.append(decoding.greedy_decode_with_cache(
            params, config, cache, logits, 20, capture=capture))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    cache, logits = decoding.prefill(params, config, prompt)
    eager_cache = {k: v.clone() for k, v in cache.items()}
    token = torch.argmax(logits, dim=-1)
    got = decoding.make_decode_step(params, config, 3, capture=True)(
        cache, token)
    want = decoding.make_decode_step(params, config, 3, capture=False)(
        eager_cache, token)
    torch.testing.assert_close(got, want, rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_captured_sharded_decode_span_equals_eager(card):
    """The tp=2 context's decode span over ``[cuda:0, cuda:0]`` (one KV
    head a shard), captured in one graph, equals its eager run: the
    tokens and every shard's pool rows."""
    device, config, params = card
    ctx = ShardedServingContext(config, MeshSpec(dp=1, tp=2), params,
                                devices=[device] * 2)
    ctx.place_params(params)
    s, t, bs, nb = 3, 8, 4, 30
    shape = (config.n_layers, nb, config.kv_heads, bs, config.head_dim)
    gen = torch.Generator().manual_seed(2)
    full = [torch.randn(shape, generator=gen).to(device) for _ in range(2)]
    tables = torch.arange(1, 1 + s * t).reshape(s, t).to(device)
    args = (torch.tensor([13, 5, 20], device=device),
            torch.tensor([True, True, False], device=device),
            torch.tensor([3, 9, 0], device=device),
            torch.tensor([0.0, 0.9, 0.0], device=device),
            torch.randint(0, 2 ** 62, (s, 4), generator=gen).to(device),
            torch.tensor([4, 2, 0], device=device))

    def span(pools):
        return ctx.decode_span(decoding.pick_rows, 4, None, *pools, tables,
                               *args)

    eager_pool = ctx.place_pool(*full)
    want = span(eager_pool)
    graph_pool = ctx.place_pool(*full)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        span(ctx.place_pool(*full))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = span(graph_pool)
    graph.replay()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(graph_pool, eager_pool):
        torch.testing.assert_close(a.gather()[:, 1:], b.gather()[:, 1:],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sharded_engine_streams_and_block_reads_equal_single_device(card,
                                                                    dtype):
    """A tp=2 engine over ``[cuda:0, cuda:0]`` (one KV head a shard)
    captures every shape at warm-up and nothing after, its captured
    streams equal the single-device engine's (and at f32 the dense greedy
    decode's), and its block reads gather the shards into its own pool's
    rows.  At bf16, the dtype the card serves, those rows are the
    single-device engine's bytes.  At f32 cuBLAS computes a batch of one
    (lane, KV head) matrix — a one-lane prefill on a one-head shard —
    with other last bits than the same matrix in a batch of two
    (ROADMAP.md queue C): layer 0's rows are equal, the later layers'
    within f32 round-off."""
    device, config, params = card
    config = dataclasses.replace(config, dtype=dtype)
    trace = _fleet_trace(6)
    pool = dict(FLEET_POOL, num_blocks=41)
    engines = [
        ServingEngine(params, config, EngineConfig(**pool), device=device),
        ServingEngine(params, config, EngineConfig(
            **pool, mesh_spec=MeshSpec(dp=1, tp=2)),
            mesh_devices=[device] * 2)]
    streams = []
    for engine in engines:
        engine.warmup()
        counts = engine.capture_counts()
        streams.append(_served(engine, trace))
        assert engine.capture_counts() == counts
    assert streams[1] == streams[0]
    if dtype == torch.float32:
        for rid, prompt, new in trace:
            want = decoding.greedy_decode(
                params, config, torch.from_numpy(prompt)[None].to(device),
                new)
            assert streams[1][rid] == want[0].tolist(), rid
    blocks = list(range(1, 17))
    idx = torch.tensor(blocks, device=device)
    single, sharded = (engine._read_blocks(blocks) for engine in engines)
    assert sharded[0].is_pinned()
    own = engines[1].pool
    for got, pool_rows, want in zip(sharded, (own.k, own.v), single):
        assert torch.equal(
            got, pool_rows.gather().index_select(1, idx).transpose(0, 1).cpu())
        assert want.abs().sum() > 0
        if dtype == torch.bfloat16:
            assert torch.equal(got, want)
        else:
            assert torch.equal(got[:, 0], want[:, 0])
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_captured_sharded_train_step_equals_eager(card):
    """Three AdamW steps of the tiny GQA model over dp=2 x tp=2 on
    ``[cuda:0] * 4`` (one KV head a tp shard): the captured sharded step
    (one graph: every unit, the psums, the copies' gradient sums and the
    optimizer) against the eager sharded step with the same capturable
    AdamW, and every copy of a slice equal to the bit after each step."""
    device, config, params = card
    mesh = make_mesh(MeshSpec(dp=2, tp=2), devices=[device] * 4)
    tokens = torch.randint(0, 64, (4, 16), generator=torch.Generator()
                           .manual_seed(2)).to(device)

    def capturable(leaves):
        optimizer = adamw(1e-3)(leaves)
        _make_capturable(optimizer, device)
        return optimizer

    runs = []
    for capture in (False, True):
        init_state, step = make_train_step(
            lambda p, t: transformer_apply(p, t, config), mesh=mesh,
            param_rules=transformer_sharding_rules(),
            optimizer=None if capture else capturable, capture=capture)
        state = init_state(params)
        losses = []
        for _ in range(3):
            state, loss = step(state, tokens, tokens)
            losses.append(float(loss))
            for leaf in tree_leaves(state.params):
                for group in leaf.copies:
                    for i in group[1:]:
                        assert torch.equal(leaf.shards[i],
                                           leaf.shards[group[0]])
        runs.append((losses, [leaf.gather() for leaf in
                              tree_leaves(state.params)]))
    (eager_losses, eager), (losses, captured) = runs
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, eager_losses, rtol=0, atol=LOGITS_TOL)
    for got, want in zip(captured, eager):
        torch.testing.assert_close(got, want, rtol=0, atol=LOGITS_TOL)


# chip_smoke.py's RESNET_LOGITS_RTOL: f32 convolutions with TF32 off sum
# in another order than the CPU's (TF32 convolutions would not pass)
RESNET_LOGITS_RTOL = 1e-4


def test_full_width_resnet_forward_equals_the_cpu(card):
    device = card[0]
    torch.backends.cudnn.allow_tf32 = False
    config = ResNetConfig()
    params = resnet_init(torch.Generator().manual_seed(0), config,
                         device="cpu")
    images = torch.randn((8, 32, 32, 3), generator=torch.Generator()
                         .manual_seed(1))
    with torch.no_grad():
        want = resnet_apply(params, images, config)
        got = resnet_apply(_on(params, device), images.to(device),
                           config).cpu()
    assert got.shape == (8, 10)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= RESNET_LOGITS_RTOL, err


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device, copy=True)


def test_restore_into_a_captured_train_step_replays_to_the_bit(card,
                                                               tmp_path):
    """A small ResNet's captured step: a checkpoint saved after step 2,
    steps 3-4 run, the checkpoint restored into the state the graph
    replays (in place: the same tensors), steps 3-4 replayed — the
    parameters and moments equal the first run's to the bit (the
    convolutions deterministic)."""
    device = card[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        config = ResNetConfig(widths=(16, 32), blocks_per_stage=(1, 1),
                              groups=4)
        init_state, step = make_train_step(
            lambda p, x: resnet_apply(p, x, config), capture=True)
        state = init_state(resnet_init(torch.Generator().manual_seed(0),
                                       config, device=device))
        gen = torch.Generator().manual_seed(3)
        batches = [(torch.randn((16, 32, 32, 3), generator=gen).to(device),
                    torch.randint(0, 10, (16,), generator=gen).to(device))
                   for _ in range(4)]
        for batch in batches[:2]:
            state, _ = step(state, *batch)
        save_checkpoint(str(tmp_path), state, 2)
        losses = [float(step(state, *batch)[1]) for batch in batches[2:]]
        leaves = tree_leaves(state.params)
        final = [leaf.detach().clone() for leaf in leaves]
        moments = [state.opt_state.state[leaf]["exp_avg"].clone()
                   for leaf in leaves]
        pointers = [leaf.data_ptr() for leaf in leaves]
        state = restore_checkpoint(str(tmp_path), into=state)
        assert state.step == 2
        assert [leaf.data_ptr() for leaf in tree_leaves(state.params)] == \
            pointers
        again = [float(step(state, *batch)[1]) for batch in batches[2:]]
        assert again == losses
        for leaf, want, moment in zip(tree_leaves(state.params), final,
                                      moments):
            assert torch.equal(leaf, want)
            assert torch.equal(state.opt_state.state[leaf]["exp_avg"],
                               moment)
    finally:
        torch.backends.cudnn.deterministic = False


def test_prefetch_orders_its_copies_around_the_step(card):
    """Each consumer step first keeps its stream busy (``_sleep``), then
    reads the prefetched batch, whose reference it drops at once, while
    the next copies run on the side stream: the step must see its own
    batch — it waits for that batch's copy, and record_stream keeps the
    allocator from handing the batch's memory to a later copy before the
    step has read it."""
    device = card[0]
    n = 1 << 22  # 16 MiB a batch

    def source():
        for i in range(8):
            yield {"x": np.full((n,), float(i), dtype=np.float32),
                   "i": np.array([i])}

    sums = []
    for batch in prefetch_to_device(source(), size=2, sharding=device):
        assert batch["x"].device == device
        torch.cuda._sleep(20_000_000)
        sums.append(batch["x"].sum())
        del batch
    torch.cuda.synchronize()
    assert [float(x) for x in sums] == [float(i * n) for i in range(8)]


# chip_smoke.py's f32 limits for a kernel against its plain version on the
# same inputs (TOLERANCES["float32"], BWD_TOLERANCES["float32"]): out per
# element (absolute and relative) and lse absolute; each gradient as
# max |kernel - plain| / max |plain|.  3xTF32 keeps f32's accuracy, so
# only the summation order and the dropped small x small term (2^-22 of
# each product) separate the two; one TF32 pass (~5e-4) would not pass.
F32_OUT_TOL = 1e-4
F32_GRAD_TOL = 1e-5


def _doc_mask(lengths, block):
    doc = np.repeat(np.arange(len(lengths)), np.asarray(lengths) // block)
    return torch.tensor((doc[:, None] == doc[None, :]).astype(np.int32))


@pytest.mark.parametrize("shape,h_kv,window,mask", [
    ((2, 8, 333, 64), 2, None, None),
    ((1, 4, 512, 128), 4, 100, None),
    ((2, 4, 1024, 64), 2, None, _doc_mask((384, 256, 384), 128)),
], ids=["gqa4_ragged_333", "window_100_d128", "doc_mask_gqa"])
def test_f32_kernels_match_their_plain_versions(card, shape, h_kv, window,
                                                mask):
    """The f32 forward, dK/dV and dQ kernels against
    flash_forward_reference / flash_backward_reference (or the
    block-sparse pair) at a ragged GQA shape, a windowed d = 128 shape and
    a document block mask, all causal."""
    device = card[0]
    b, h, s, d = shape
    rng = np.random.default_rng(15)
    q, dout = (torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=device) for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((b, h_kv, s, d),
                                             dtype=np.float32), device=device)
            for _ in range(2))
    def counts():
        return (A.flash_forward.launches, A.flash_backward.launches_dkv,
                A.flash_backward.launches_dq, A.block_sparse_forward.launches,
                A.block_sparse_backward.launches_dkv,
                A.block_sparse_backward.launches_dq)

    launched = counts()
    if mask is None:
        out, lse = A.flash_forward(q, k, v, True, window)
        grads = A.flash_backward(q, k, v, out, lse, dout, True, window)
        ref_out, ref_lse = A.flash_forward_reference(q, k, v, True, window)
        ref_grads = A.flash_backward_reference(q, k, v, out, lse, dout, True,
                                               window)
    else:
        args = (mask.to(device), True, 128, 128)
        out, lse = A.block_sparse_forward(q, k, v, *args)
        grads = A.block_sparse_backward(q, k, v, out, lse, dout, *args)
        ref_out, ref_lse = A.block_sparse_forward_reference(q, k, v, *args)
        ref_grads = A.block_sparse_backward_reference(q, k, v, out, lse,
                                                      dout, *args)
    torch.cuda.synchronize()
    assert [n - m for n, m in zip(counts(), launched)] == (
        [1, 1, 1, 0, 0, 0] if mask is None else [0, 0, 0, 1, 1, 1])
    torch.testing.assert_close(out, ref_out, rtol=F32_OUT_TOL,
                               atol=F32_OUT_TOL)
    finite = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=0,
                               atol=F32_OUT_TOL)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= F32_GRAD_TOL, (name, err)


def _ring_qkv(shape, h_kv, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, s, d = shape
    return [torch.randn(dims, generator=gen, device="cuda", dtype=dtype)
            for dims in ((b, h, s, d), (b, h_kv, s, d), (b, h_kv, s, d))]


def test_ring_diagonal_partial_equals_its_plain_version(card):
    """The hybrid ring's diagonal block (``_partial_flash``): the flash
    forward kernel, launched once, against its plain version (chip_smoke's
    bf16 TOLERANCES); the whole hybrid ring on the card against attention
    over the whole sequence; and the kernel refusing what it cannot take."""
    from kubeshare_tpu_torch.ops import ring_attention as R

    q, k, v = _ring_qkv((1, 8, 512, 128), 8, torch.bfloat16, 1)
    before = A.flash_forward.launches
    out, lse = R._partial_flash(q, k, v, True)
    assert A.flash_forward.launches == before + 1
    ref_out, ref_lse = A.flash_forward_reference(q, k, v, True)
    torch.testing.assert_close(out, ref_out.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, ref_lse[..., 0], rtol=0, atol=1e-3)

    q, k, v = _ring_qkv((2, 4, 1024, 64), 2, torch.float32, 2)
    before = A.flash_forward.launches
    outs = R.ring_flash_attention(*(list(x.chunk(4, dim=2))
                                    for x in (q, k, v)))
    assert A.flash_forward.launches == before + 4  # one diagonal a member
    whole = A.attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(torch.cat(outs, dim=2), whole, rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="head_dim"):
        R.ring_flash_attention(*([x[..., :8].contiguous()] * 2
                                 for x in (q, k, v)))


def test_zigzag_quadrant_launch_and_gradients(card):
    """The zigzag hybrid ring on the card: each diagonal step launches the
    kernel on two contiguous quadrants (a strided quadrant raises), and
    its output and hand-scheduled gradients equal the einsum zigzag ring's
    on the same tensors (autograd through plain operations) at f32."""
    from kubeshare_tpu_torch.ops import ring_attention as R

    q, k, v = _ring_qkv((1, 4, 512, 64), 4, torch.float32, 3)
    c = 256 // 2
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_forward(q[:, :, :c], k[:, :, :c], v[:, :, :c], True)
    dout = torch.randn_like(q)
    results = []
    for fn in (R.ring_flash_attention_zigzag, R.ring_attention_zigzag):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        pieces = [list(R.zigzag_shard(x, 2).chunk(2, dim=2)) for x in leaves]
        before = A.flash_forward.launches
        out = R.zigzag_unshard(torch.cat(fn(*pieces), dim=2), 2)
        launches = A.flash_forward.launches - before
        (out * dout).sum().backward()
        results.append((launches, out.detach(),
                        [x.grad for x in leaves]))
    (launches, out, grads), (plain_launches, ref, ref_grads) = results
    assert launches == 4 and plain_launches == 0
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    for got, want in zip(grads, ref_grads):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def test_1f1b_step_on_the_card_equals_autograd_through_the_ring(card):
    """A 1F1B step of a small f32 model (head_dim 64) over pp=2 x sp=2 on
    ``[cuda:0] * 4``, the hybrid ring in each stage: its loss and every
    gradient against autograd through transformer_apply_ring over sp=2,
    and the flash forward launched on the path (never the backward
    kernels: the ring's backward is its own)."""
    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply_ring, transformer_train_1f1b)
    from kubeshare_tpu_torch.parallel.mesh import Mesh
    from kubeshare_tpu_torch.parallel.train import cross_entropy_loss

    device = card[0]
    config = TransformerConfig(vocab_size=128, d_model=128, n_heads=2,
                               n_layers=2, d_ff=256, max_seq_len=256,
                               attention="ring", positional="rope",
                               dtype=torch.float32)
    params = transformer_init(config, torch.Generator().manual_seed(5), device)
    gen = torch.Generator().manual_seed(6)
    tokens, targets = (torch.randint(0, 128, (4, 256), generator=gen)
                       .to(device) for _ in range(2))
    array = np.empty(4, dtype=object)
    array[:] = [device] * 4
    before = (A.flash_forward.launches, A.flash_backward.launches_dkv,
              A.flash_backward.launches_dq)
    loss, grads = transformer_train_1f1b(
        params, tokens, targets, config, Mesh(array.reshape(2, 2),
                                              ("pp", "sp")))
    after = (A.flash_forward.launches, A.flash_backward.launches_dkv,
             A.flash_backward.launches_dq)
    # 2 microbatches x 2 layers x 2 members, one diagonal each
    assert after[0] - before[0] == 8 and after[1:] == before[1:]
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    mesh = make_mesh(MeshSpec(dp=1, sp=2), devices=[device] * 2)
    want = cross_entropy_loss(transformer_apply_ring(params, tokens, config,
                                                     mesh), targets)
    want.backward()
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    for got, leaf in zip(tree_leaves(grads), leaves):
        err = float((got - leaf.grad).abs().max() / leaf.grad.abs().max())
        assert err <= 1e-4, err


@pytest.mark.parametrize("branch", [[], ["--pp"]], ids=["dp_tp_sp", "1f1b"])
def test_train_longcontext_runs_on_the_card(card, branch):
    """``train_longcontext_torch.py`` as its README command runs it (no
    ``--device``: the card): both branches train (the script asserts the
    last loss is below the first); ``--pp``'s in-stage ring is the hybrid
    ring, so the f32 flash forward (head_dim 64) runs on its diagonal
    blocks, while the default branch's einsum zigzag ring launches no
    kernel."""
    import train_longcontext_torch

    before = A.flash_forward.launches
    losses = train_longcontext_torch.main(branch)["losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    launched = A.flash_forward.launches - before
    # --pp: 4 steps x 2 microbatches x 4 layers x sp=4 members, one
    # diagonal each
    assert launched == (4 * 2 * 4 * 4 if branch else 0), launched


def test_dryrun_multichip_on_the_card(card):
    """``entry.dryrun_multichip(8)`` with its default device, the card:
    every leg (the fsdp step, the rings and Ulysses, the MoE layers, the
    1F1B pipelines, MoE in the ring) runs and is finite, and the hybrid
    rings and Ulysses launch the flash kernels."""
    from kubeshare_tpu_torch.entry import dryrun_multichip

    before = (A.flash_forward.launches, A.flash_backward.launches_dkv)
    line = dryrun_multichip(8)
    assert line.startswith("dryrun_multichip ok: mesh dp=2 tp=2 sp=2 on "
                           "8 x cuda:0")
    assert A.flash_forward.launches > before[0]
    assert A.flash_backward.launches_dkv > before[1]
    assert "multislice dcn mesh 2 slices x 4 devices" in line


def test_two_gloo_ranks_train_on_the_card(card):
    """``train_distributed_torch.py`` at full width as a 2-member gang on
    cuda:0 over gloo (NCCL refuses two ranks on one GPU): both ranks
    rendezvous from the gang env, train three steps on their halves of
    the batch and print the same losses."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    from native_helpers import free_port

    port = free_port()
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, TPUSHARE_GANG_SIZE="2",
                       TPUSHARE_GANG_RANK=str(rank),
                       TPUSHARE_COORDINATOR=f"127.0.0.1:{port}",
                       PYTHONPATH=str(repo))
            procs.append(subprocess.Popen(
                [sys.executable, str(repo / "train_distributed_torch.py"),
                 "--backend", "gloo", "--steps", "3"], env=env,
                cwd=str(repo), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        [line] = [ln for ln in out.splitlines()
                  if ln.startswith(f"[proc {rank}/2] step 3 loss ")]
        lines.append(line.split()[5])
    assert lines[0] == lines[1]


def test_discovery_agrees_with_nvidia_smi(card):
    """discover_local_chips: one ChipInfo per card with nvidia-smi's UUID
    and name (spaces as '-'), its memory within 1 GiB of nvidia-smi's
    (torch reads the CUDA runtime's total, nvidia-smi NVML's)."""
    import subprocess

    from kubeshare_tpu_torch.cell import discover_local_chips

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,memory.total",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    chips = discover_local_chips()
    assert len(chips) == len(smi) == torch.cuda.device_count()
    for index, (chip, line) in enumerate(zip(chips, smi)):
        uuid, name, mib = (x.strip() for x in line.split(","))
        assert (chip.uuid, chip.model, chip.index, chip.coords) == (
            uuid, name.replace(" ", "-"), index, None)
        assert abs(chip.memory / 2**20 - float(mib)) <= 1024


HOOK_CHILD = """
import json, sys, torch
sys.path.insert(0, %r)
from kubeshare_tpu_torch.isolation import hook
from kubeshare_tpu_torch.models.transformer import (TransformerConfig,
                                                    transformer_apply,
                                                    transformer_init)
from kubeshare_tpu_torch.ops import attention as A
from kubeshare_tpu_torch.parallel.train import make_train_step

device = torch.device("cuda", 0)
config = TransformerConfig(vocab_size=256, d_model=256, n_heads=4, n_layers=2,
                           d_ff=512, max_seq_len=128, positional="rope",
                           dtype=torch.bfloat16, attention="flash")
params = transformer_init(config, torch.Generator().manual_seed(0), device)
gen = torch.Generator().manual_seed(1)
tokens, targets = (torch.randint(0, 256, (2, 128), generator=gen).to(device)
                   for _ in range(2))
init_state, step = make_train_step(
    lambda p, t: transformer_apply(p, t, config), capture=True)
state = init_state(params)
for _ in range(5):
    state, loss = step(state, tokens, targets)
float(loss)
hook.settle()
print(json.dumps({"stats": hook.live_stats(),
                  "port": [A.flash_forward.launches,
                           A.flash_backward.launches_dkv,
                           A.flash_backward.launches_dq]}))
"""


def test_a_captured_step_under_the_hook(card, tmp_path):
    """Five captured steps of a small flash-attention transformer in a
    child under libcudahook.so.1, behind a real tpushare-pmgr and
    tpushare-tokend: each replay is a graph launch the broker granted,
    and the hook counted each flash kernel by name as often as the
    port's wrappers launched it (warm-up passes and the capture)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))
    import corun_bench
    from kubeshare_tpu_torch.isolation import TokenClient, hook

    (tmp_path / "card").write_text("1\nhook/pod 1.0 1.0 0\n")
    tokend_port, pmgr_port = corun_bench.free_port(), corun_bench.free_port()
    procs = [subprocess.Popen(
        [corun_bench.ensure_binary("tpushare-tokend"), "-p", str(tmp_path),
         "-f", "card", "-P", str(tokend_port)], stderr=subprocess.DEVNULL)]
    try:
        corun_bench._wait_listening(tokend_port)
        procs.append(subprocess.Popen(
            [corun_bench.ensure_binary("tpushare-pmgr")],
            stderr=subprocess.DEVNULL,
            env=dict(os.environ, SCHEDULER_IP="127.0.0.1",
                     SCHEDULER_PORT=str(tokend_port),
                     POD_MANAGER_IP="127.0.0.1",
                     POD_MANAGER_PORT=str(pmgr_port), POD_NAME="hook/pod")))
        corun_bench._wait_listening(pmgr_port)
        child = subprocess.run(
            [sys.executable, "-c", HOOK_CHILD % str(repo)],
            env=dict(os.environ, **hook.hook_env(pmgr_port, "hook/pod")),
            capture_output=True, text=True, timeout=300)
        assert child.returncode == 0, child.stderr[-3000:]
        client = TokenClient("127.0.0.1", tokend_port, "observer")
        pod = json.loads(client.stat())["pods"]["hook/pod"]
        client.close()
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    result = json.loads(child.stdout.strip().splitlines()[-1])
    stats = result["stats"]
    assert stats["gated"] and stats["graph_launches"] == 5
    assert pod["grants"] == stats["acquires"] >= 1
    assert pod["charged_total_ms"] > 0
    by_kernel = [sum(n for name, n in stats["kernels"].items()
                     if f"{kernel}_bf16_kernel" in name)
                 for kernel in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")]
    assert by_kernel == result["port"] and min(by_kernel) > 0


# ---- the root twins of examples/ at their full configurations ----

def _twin_line(name, summary, keys):
    """The twin's wall time and headline numbers, with the card's name and
    power limit, on a line of its own (read with ``pytest -s``)."""
    import json
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"\ntwin {name}: " + json.dumps(
        {k: summary[k] for k in keys}, sort_keys=True) + f"; {card}",
          flush=True)


MNIST_POD_CHILD = """
import json, sys, time
sys.path.insert(0, %r)
t0 = time.monotonic()
import train_mnist_torch
summary = train_mnist_torch.main([])
summary.pop("state")
summary["process_s"] = time.monotonic() - t0
print(json.dumps(summary))
"""
# the broker's charge for steps 2-1,000 over their CUDA-event ms: about 1
# when the hook alone charges (the interposer phase's captured steps read
# 0.9955), about 2 if the pod's guard charged each step a second time.
# First card run 1.11: these ~1.1 ms graphs ride the hook's lease, whose
# segments close at 2 ms of quiet and so take in the host's gaps between
# steps.  Step 1's event spans the capture's host time, so it is left out
# (the hook's charge after step 1 is subtracted from the broker's)
MNIST_CHARGE_RANGE = (0.8, 1.5)
# the broker's total against the hook's own: the broker hears only the
# hook (first card run 1,351.63 against 1,331.37 ms: the exit settle)
MNIST_BROKER_HOOK_RTOL = 0.05


def test_train_mnist_pod_is_charged_once_under_the_scheduler_env(card,
                                                                 tmp_path):
    """``train_mnist_torch.py`` at its defaults (1,000 captured steps at
    batch 256) as the pod the port's scheduler places on the card: its
    env is the one the scheduler injects (the hook preloaded, the pod
    manager's port, the memory cap), behind the configd files and a
    ChipSupervisor's real tokend and pmgr.  The script sees the hook and
    builds no guard, so the broker charges each step once: its charge
    for steps 2-1,000 over their CUDA-event ms lies in
    MNIST_CHARGE_RANGE, and its total is the hook's own charge within
    MNIST_BROKER_HOOK_RTOL."""
    import json
    import os
    import socket
    import subprocess
    import sys
    import time
    from pathlib import Path

    from kubeshare_tpu_torch import constants
    from kubeshare_tpu_torch.cell import TopologyConfig, discover_local_chips
    from kubeshare_tpu_torch.cell.spec import check_physical_cells
    from kubeshare_tpu_torch.cluster.api import FakeClock, Node, Pod, PodPhase
    from kubeshare_tpu_torch.cluster.fake import FakeCluster
    from kubeshare_tpu_torch.configd import ConfigDaemon
    from kubeshare_tpu_torch.isolation import TokenClient, hook
    from kubeshare_tpu_torch.runtime import ChipSupervisor, ensure_binary
    from kubeshare_tpu_torch.scheduler import KubeShareScheduler, SchedulerEngine
    from kubeshare_tpu_torch.utils.net import wait_listening

    repo = Path(__file__).resolve().parent.parent
    [chip] = discover_local_chips()
    topology = TopologyConfig.from_dict({
        "cellTypes": {"1-GPU-NODE": {"childCellType": chip.model,
                                     "childCellNumber": 1,
                                     "isNodeLevel": True}},
        "cells": [{"cellType": "1-GPU-NODE", "cellId": "mnist-node"}]})
    check_physical_cells(topology)
    cluster = FakeCluster()
    cluster.add_node(Node("mnist-node", {constants.NODE_LABEL_FILTER: "true"}))
    clock = FakeClock(0.0)
    engine = SchedulerEngine(KubeShareScheduler(
        topology, cluster, lambda node: [chip], clock=clock), cluster, clock)
    cluster.create_pod(Pod(
        name="mnist", scheduler_name=constants.SCHEDULER_NAME,
        labels={constants.POD_GPU_REQUEST: "0.5",
                constants.POD_GPU_LIMIT: "1.0",
                constants.POD_GPU_MEMORY: str(chip.memory // 4)}))
    assert [r.result for r in engine.run_until_idle()] == ["bound"]
    pod = cluster.get_pod("default", "mnist")
    cluster.set_pod_phase("default", "mnist", PodPhase.RUNNING)
    ConfigDaemon("mnist-node", cluster=cluster,
                 config_dir=str(tmp_path / "config"),
                 port_dir=str(tmp_path / "ports")).sync()
    env = dict(pod.containers[0].env)
    assert env[constants.ENV_SHIM_PRELOAD] == constants.SHIM_LIBRARY
    # the node's hostPath mount and the container runtime's mapping
    env[constants.ENV_SHIM_PRELOAD] = str(hook.hook_path())
    env["CUDA_VISIBLE_DEVICES"] = env.pop(constants.ENV_VISIBLE_DEVICES)
    bare = {k: v for k, v in os.environ.items()
            if k not in ("LD_PRELOAD", "POD_MANAGER_PORT", "POD_NAME",
                         "POD_MANAGER_IP", "CUDA_VISIBLE_DEVICES")
            and not k.startswith(("TPUSHARE_", "CUDAHOOK_", "NVIDIA_"))}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        tokend_port = s.getsockname()[1]
    started = time.monotonic()
    with ChipSupervisor(chip.uuid, config_dir=str(tmp_path / "config"),
                        port_dir=str(tmp_path / "ports"),
                        tokend_port=tokend_port, poll_interval=0.1,
                        tokend_binary=ensure_binary("tpushare-tokend"),
                        pmgr_binary=ensure_binary("tpushare-pmgr")):
        wait_listening(tokend_port)
        wait_listening(int(env[constants.ENV_POD_MANAGER_PORT]))
        child = subprocess.run(
            [sys.executable, "-c", MNIST_POD_CHILD % str(repo)],
            env={**bare, **env}, capture_output=True, text=True, timeout=600)
        assert child.returncode == 0, child.stderr[-3000:]
        assert "running ungated" not in child.stderr, child.stderr[-3000:]
        probe = TokenClient("127.0.0.1", tokend_port, "probe")
        entry = json.loads(probe.stat())["pods"][pod.key]
        probe.close()
    summary = json.loads(child.stdout.strip().splitlines()[-1])
    summary["wall_s"] = time.monotonic() - started
    assert summary["gate"] == "hook" and summary["steps"] == 1000
    assert np.isfinite(summary["losses"]).all()
    steps_ms = sum(summary["step_ms"][1:])
    hooked = summary["hook"]
    first = hooked["charged_ms_after_first_step"]
    summary.update(
        broker_charged_ms=entry["charged_total_ms"],
        broker_grants=entry["grants"], step1_event_ms=summary["step_ms"][0],
        steps_event_ms=steps_ms,
        charge_over_event_ms=(entry["charged_total_ms"] - first) / steps_ms,
        hook_steps_charge_over_event_ms=(
            (hooked["charged_ms"] - first) / steps_ms))
    _twin_line("train_mnist_torch.py (under the scheduler's env)", summary,
               ("wall_s", "process_s", "steps_per_s", "step1_event_ms",
                "steps_event_ms", "broker_charged_ms", "broker_grants",
                "charge_over_event_ms", "hook_steps_charge_over_event_ms",
                "hook", "gate"))
    low, high = MNIST_CHARGE_RANGE
    assert low <= summary["charge_over_event_ms"] <= high, summary
    assert low <= summary["hook_steps_charge_over_event_ms"] <= high, summary
    assert abs(entry["charged_total_ms"] - hooked["charged_ms"]) <= \
        MNIST_BROKER_HOOK_RTOL * hooked["charged_ms"], (entry, hooked)


@pytest.mark.parametrize("script,keys", [
    ("serve_fractional_torch", ("tokens_per_s", "tokens", "seconds",
                                "preemptions", "tier_demoted_blocks",
                                "tier_promoted_blocks", "spec_drafted",
                                "spec_accepted", "grants", "charged_ms",
                                "captures_after_warmup")),
    ("serve_disagg_torch", ("tokens_per_s", "tokens", "seconds",
                            "delivered", "migrated_bytes",
                            "streams_equal_monolithic", "cells",
                            "captures_after_warmup")),
    ("serve_fleet_torch", ("tokens_per_s", "tokens", "seconds", "owners",
                           "inherited", "tier_hits", "states", "routing",
                           "prefix_hit_tokens", "captures_after_warmup")),
    ("serve_sharded_torch", ("tokens_per_s", "tokens", "seconds",
                             "collective_bytes", "streams_equal_single_device",
                             "grants", "charged_ms",
                             "captures_after_warmup")),
])
def test_serving_twin_runs_on_the_card(card, script, keys):
    """The serving twins of examples/ at their full configurations (no
    ``--device``: the card).  Each raises where its JAX example raises
    (a graph captured after warm-up, a stream unequal to its replay, a
    broken affinity or drain); here the headline numbers are checked and
    printed."""
    import importlib
    import time

    started = time.monotonic()
    summary = importlib.import_module(script).main([])
    summary["wall_s"] = time.monotonic() - started
    assert summary["device"].startswith("cuda")
    assert summary["captures_after_warmup"] == 0
    assert summary["tokens"] > 0
    if script == "serve_fractional_torch":
        assert sum(summary["preemptions"].values()) > 0
        assert summary["tier_demoted_blocks"] > 0
        assert summary["charged_ms"] > 0
    if script == "serve_disagg_torch":
        assert summary["streams_equal_monolithic"] == summary["requests"]
        assert summary["delivered"] == summary["requests"]
    if script == "serve_sharded_torch":
        assert summary["streams_equal_single_device"] == summary["requests"]
        assert summary["collective_bytes"]["prefill_chunk"] > 0
    _twin_line(f"{script}.py", summary, ("wall_s",) + keys)


def test_demo_e2e_runs_on_the_card(card):
    """``demo_e2e_torch.py`` on the card: the chip discover_local_chips
    finds, both pods bound to its UUID, the config file, three captured
    MNIST steps a pod gated through its pod manager, the reclaim."""
    import time

    import demo_e2e_torch
    from kubeshare_tpu_torch.cell import discover_local_chips

    started = time.monotonic()
    summary = demo_e2e_torch.main([])
    summary["wall_s"] = time.monotonic() - started
    [chip] = discover_local_chips()
    assert summary["chip"] == chip.uuid
    assert {p["uuid"] for p in summary["placements"].values()} == {chip.uuid}
    mem = demo_e2e_torch.POD_MEMORY
    assert summary["files"]["config"] == (
        f"2\ndefault/mnist-a 1.0 0.5 {mem}\ndefault/mnist-b 1.0 0.5 {mem}\n")
    assert summary["reclaim"]["files"]["config"] == (
        f"1\ndefault/mnist-b 1.0 0.5 {mem}\n")
    assert summary["reclaim"]["available"] == 0.5
    for steps in summary["steps"].values():
        assert steps["tokens"] >= 1 and np.isfinite(steps["losses"]).all()
    _twin_line("demo_e2e_torch.py", summary,
               ("wall_s", "chip", "steps", "tokend", "reclaim"))
