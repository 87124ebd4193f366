"""Port parity: kubeshare_tpu_torch.serving.chaos and the engine's chaos
seams against kubeshare_tpu.serving on the CPU.

One FaultPlan replayed through both packages' FaultClocks fires the same
events and rots the same bits (the bit of a corruption derives from
``crc32(seed, ordinal)``).  In the engine, a planned corruption of every
host-tier put is a counted miss that falls back to re-prefill: the
streams equal the JAX engine's under the same plan (both with the plan's
clock set on ``engine.host_tier.fault_clock``, a plain attribute on
either side) and the port's with no tier at all, and
``tier_corrupt_blocks`` is the same on both sides.  A planned kill raises
ReplicaKilled at the top of ``step()`` with nothing mutated; a slow
dispatch advances the virtual clock and nothing else."""

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
from kubeshare_tpu.serving import chaos as jax_chaos
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models.transformer import TransformerConfig
from kubeshare_tpu_torch.serving import (EngineConfig, Request,
                                         ServingEngine, chaos, kv_tier)

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=64, attention="reference")
POOL = dict(num_slots=1, block_size=4, num_blocks=13, max_request_len=32,
            prefill_chunk=8)


def _trace(seed=7):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 64, 13)
    return [("r0", shared, 3),
            ("f1", rng.integers(0, 64, 29), 3),
            ("f2", rng.integers(0, 64, 29), 3),
            ("hit", np.concatenate([shared, rng.integers(0, 64, 4)]), 3)]


TRACE = _trace()


@pytest.fixture(scope="module")
def model():
    jax_cfg = JaxConfig(dtype=jnp.float32, **MODEL)
    params = jax_init(jax.random.PRNGKey(0), jax_cfg)
    return jax_cfg, params, TransformerConfig(dtype=torch.float32, **MODEL), \
        params_from_jax(jax.device_get(params), "cpu")


def _plan(mod):
    plan = (mod.FaultPlan(seed=23)
            .kill("r1", at_step=3)
            .slow_dispatch("engine", at=1, seconds=0.5)
            .drop_ticket(0).refuse_tokend(1)
            .drop_fabric(0).duplicate_fabric(1).reorder_fabric(2)
            .corrupt_fabric(3).corrupt_disk_read(1))
    for n in (0, 2, 5):
        plan.corrupt_tier_put(n)
    return plan


def _drive(mod):
    """Every seam of one clock, in a fixed order; returns what each call
    gave back, the clock's reading and its events."""
    clock = mod.FaultClock(_plan(mod), step_dt=0.25)
    out = []

    class Replica:
        def __init__(self, label):
            self.replica_label = label

    r0, r1 = Replica("r0"), Replica("r1")
    payload = bytes(range(256)) * 3
    for i in range(6):
        clock.on_engine_step(r0)
        try:
            clock.on_engine_step(r1)
            out.append(("step", i, "alive"))
        except mod.ReplicaKilled as exc:
            out.append(("step", i, str(exc)))
        clock.on_dispatch(type("E", (), {})())
        out.append(("put", clock.on_tier_put(payload)))
        out.append(("ticket", clock.on_ticket_delivery()))
        out.append(("tokend", clock.on_tokend_request("ACQ")))
        out.append(("fabric", clock.on_fabric_transmit(payload[:40 + i])))
        out.append(("disk", clock.on_disk_read(payload[i:])))
    return out, clock.now(), clock.events


def test_fault_plan_events_and_rotted_bytes_equal_jax():
    got, now, events = _drive(chaos)
    want, jax_now, jax_events = _drive(jax_chaos)
    assert got == want and now == jax_now and events == jax_events
    kinds = {e[0] for e in events}
    assert {"kill", "slow_dispatch", "corrupt_put", "drop_ticket",
            "refuse_tokend", "drop_fabric", "duplicate_fabric",
            "reorder_fabric", "corrupt_fabric", "corrupt_disk_read"} <= kinds
    # a rotted payload keeps its length and fails the wire crc
    frame = kv_tier.pack_block([1, 2], torch.ones(2, 1, 4, 2),
                               torch.zeros(2, 1, 4, 2))
    rotted = chaos.FaultClock(chaos.FaultPlan(seed=5).corrupt_tier_put(0)) \
        .on_tier_put(frame)
    assert len(rotted) == len(frame) and rotted != frame
    with pytest.raises(kv_tier.WireCorruption):
        kv_tier.unpack_block(rotted)


@pytest.mark.parametrize("build", [
    lambda p: p.kill("r", at_step=-1),
    lambda p: p.slow_dispatch("r", at=0, seconds=0.0),
    lambda p: p.corrupt_tier_put(-1),
    lambda p: p.corrupt_disk_read(-2),
], ids=["kill", "slow", "tier_put", "disk_read"])
def test_plan_builders_validate_like_jax(build):
    for mod in (chaos, jax_chaos):
        with pytest.raises(ValueError):
            build(mod.FaultPlan())


def _corrupting(mod, ordinals, seed=23):
    plan = mod.FaultPlan(seed=seed)
    for n in ordinals:
        plan.corrupt_tier_put(n)
    return mod.FaultClock(plan)


def _port_engine(model, **overrides):
    _, _, cfg, tp = model
    return ServingEngine(tp, cfg, EngineConfig(**{**POOL, **overrides}),
                         device="cpu")


def _port_serve(engine, trace=TRACE):
    engine.warmup()
    counts = engine.capture_counts()
    out = {}
    for rid, prompt, new in trace:
        engine.submit(Request(rid, prompt, new))
        out.update({k: r.tokens for k, r in engine.run().items() if r.done})
    assert engine.capture_counts() == counts
    return out


def _jax_serve(model, host_clock=None, disk_clock=None, **overrides):
    jax_cfg, params, _, _ = model
    engine = JaxServingEngine(params, jax_cfg,
                              JaxEngineConfig(**{**POOL, **overrides}))
    if host_clock is not None:
        engine.host_tier.fault_clock = host_clock
    if disk_clock is not None:
        engine.disk_tier.fault_clock = disk_clock
    out = {}
    for rid, prompt, new in TRACE:
        engine.submit(JaxRequest(rid, prompt.astype(np.int32), new))
        out.update({k: r.tokens for k, r in engine.run().items() if r.done})
        engine.pop_finished()
    return out, engine


@pytest.mark.parametrize("ordinals", [range(200), [1]],
                         ids=["every_put", "the_second_put"])
def test_corrupt_tier_put_is_a_counted_miss_equal_to_jax(model, ordinals):
    """Every put rotted, or only the second (the cached prompt's middle
    block): the hit is validated before any upload, so it falls back cold
    with no block promoted."""
    jax_clock = _corrupting(jax_chaos, ordinals)
    want, jax_engine = _jax_serve(model, jax_clock, host_tier_bytes=1 << 20)
    engine = _port_engine(model, host_tier_bytes=1 << 20)
    clock = _corrupting(chaos, ordinals)
    engine.host_tier.fault_clock = clock
    got = _port_serve(engine)
    assert got == want == _port_serve(_port_engine(model, prefix_cache=False))
    assert engine.tier_corrupt_blocks == jax_engine.tier_corrupt_blocks > 0
    assert engine.tier_promoted_blocks == jax_engine.tier_promoted_blocks
    assert engine.tier_hit_requests == jax_engine.tier_hit_requests == 0
    assert clock.events == jax_clock.events
    assert any(e[0] == "corrupt_put" for e in clock.events)


def test_corrupt_disk_read_is_a_counted_miss_equal_to_jax(model):
    # three blocks of host room: the cached prompt cascades to disk
    wire = kv_tier.wire_block_bytes(4, 2, 4, 4, 8, 4)
    tiers = dict(host_tier_bytes=3 * wire, disk_tier_bytes=1 << 20)
    jax_clock = jax_chaos.FaultClock(
        jax_chaos.FaultPlan(seed=3).corrupt_disk_read(0))
    want, jax_engine = _jax_serve(model, disk_clock=jax_clock, **tiers)
    jax_engine.disk_tier.close()
    engine = _port_engine(model, **tiers)
    clock = chaos.FaultClock(chaos.FaultPlan(seed=3).corrupt_disk_read(0))
    engine.disk_tier.fault_clock = clock
    try:
        got = _port_serve(engine)
    finally:
        engine.disk_tier.close()
    assert got == want == _port_serve(_port_engine(model, prefix_cache=False))
    assert clock.events == jax_clock.events != []
    assert engine.disk_tier.corrupt_reads == jax_engine.disk_tier.corrupt_reads
    assert engine.tier_corrupt_blocks == jax_engine.tier_corrupt_blocks == 1


def test_kill_raises_at_the_top_of_step_with_nothing_mutated(model):
    engine = _port_engine(model)
    engine.warmup()
    engine.fault_clock = chaos.FaultClock(
        chaos.FaultPlan().kill("engine", at_step=2))
    for rid, prompt, new in TRACE[:2]:
        engine.submit(Request(rid, prompt, new))
    assert engine.step() and engine.step()

    def snapshot():
        return (engine.requests_admitted, engine.prefill_chunks,
                engine.decode_steps, engine.tokens_generated,
                engine.allocator.free_blocks, engine._inflight,
                [s.state for s in engine._slots],
                dict(engine.host_seconds))

    before = snapshot()
    for _ in range(2):  # a dead engine stays dead
        with pytest.raises(chaos.ReplicaKilled, match="step 2"):
            engine.step()
        assert snapshot() == before
    assert engine.fault_clock.events == [("kill", "engine", 2)] * 2


def test_slow_dispatch_advances_the_virtual_clock_only(model):
    baseline = _port_engine(model)
    want = _port_serve(baseline)
    engine = _port_engine(model)
    clock = chaos.FaultClock(
        chaos.FaultPlan().slow_dispatch("engine", at=3, seconds=5.0),
        step_dt=0.5)
    engine.fault_clock = clock
    steps = 0
    engine.warmup()
    out = {}
    for rid, prompt, new in TRACE:
        engine.submit(Request(rid, prompt, new))
        while engine.step():
            steps += 1
        steps += 1  # the idle step that returned False
        out.update({k: r.tokens for k, r in engine._results.items()})
    assert out == want
    assert clock.now() == pytest.approx(steps * 0.5 + 5.0)
    assert clock.events == [("slow_dispatch", "engine", 3, 5.0)]
    dispatches = sum(engine.device_dispatches.values())
    assert clock._dispatches["engine"] == dispatches
