"""The port's captured (CUDA graph) serving paths against their eager
forms, on the card.  Every test here skips without a CUDA device.

The file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

At f32 with TF32 off a graph replays the eager step's kernels on the same
inputs, so captured and eager tokens are equal and the logits agree to
round-off."""

import numpy as np
import pytest
import torch

from kubeshare_tpu_torch.models import decoding
from kubeshare_tpu_torch.models.transformer import (TransformerConfig,
                                                    transformer_init)
from kubeshare_tpu_torch.serving import (DisaggRouter, EngineConfig,
                                         ReplicaFleet, Request,
                                         ServingEngine, kv_tier, paged)
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
