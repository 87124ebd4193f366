"""Port parity: kubeshare_tpu_torch.serving.autotune and the engine's
tuner-owned scheduling state against kubeshare_tpu.serving on the CPU.

The sandbox predicate, the cost model's fit and draft-width argmax, and
the analytic and trace-fitted policies' proposals equal JAX's on the same
recorded signals; ``AutoTuner.for_engine`` builds the same knobs with the
same envelopes.  In the engine every knob is scheduling-only: greedy and
sampled streams with the tuner on equal the tuner off (speculation, mixed
batching and the device loop all armed, with no capture after warm-up),
and equal the JAX engine's with the tuner on.  A crashing or
out-of-envelope policy is sandboxed, and the tuner's time is metered in
its own "tune" phase, outside "plan"."""

import time

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
from kubeshare_tpu.serving import autotune as jax_autotune
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models.transformer import TransformerConfig
from kubeshare_tpu_torch.serving import (EngineConfig, Request,
                                         ServingEngine, autotune)
from kubeshare_tpu_torch.serving.metrics_view import (flatten_metrics,
                                                      metric_value)

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=64, attention="reference")
POOL = dict(num_slots=3, block_size=4, num_blocks=41, max_request_len=48,
            prefill_chunk=8)
ARMED = dict(mixed=True, speculative=True, draft_len=4, steps_per_launch=4)
# a recorded trace of (interval dispatch counts, seconds) rows
TRACE = [({"decode": 10.0, "prefill": 2.0}, 0.14),
         ({"decode": 4.0, "prefill": 6.0}, 0.16),
         ({"decode": 8.0, "prefill": 1.0, "mixed": 3.0}, 0.13),
         ({"decode": 2.0, "prefill": 8.0, "mixed": 1.0}, 0.19),
         ({"decode": 5.0, "prefill": 5.0, "mixed": 5.0}, 0.21)]
# interval signals a policy sees, one dict a tuning round
SIGNALS = [
    dict(prefill_chunks=9.0, decode_steps=4.0),
    dict(prefill_chunks=0.0, decode_steps=40.0),
    dict(prefill_chunks=2.0, decode_steps=8.0),
    dict(loop_launches=4.0, loop_units=6.0, decode_steps=8.0),
    dict(loop_launches=4.0, loop_units=16.0, decode_steps=16.0),
    dict(decode_steps=30.0, loop_launches=0.0),
    dict(spec_drafted=40.0, spec_accepted=36.0, verify_steps=10.0),
    dict(spec_drafted=40.0, spec_accepted=2.0, verify_steps=10.0),
    dict(spec_drafted=4.0, spec_accepted=4.0),
    dict(pending_handoffs=3.0, decode_free_slots=0.0, decode_slots=4.0),
    dict(pending_handoffs=0.0, decode_free_slots=3.0, decode_slots=4.0),
    dict(ttft_n=8.0, ttft_p95=0.3),
    dict(ttft_n=8.0, ttft_p95=float("inf")),
]
KNOBS = [("mixed_prefill_budget", dict(values=(1, 2, 4, 8)), 4),
         ("steps_per_launch", dict(values=(1, 2, 4)), 2),
         ("draft_width_cap", dict(values=(1, 2, 4)), 4),
         ("loop_draft_width", dict(values=(1, 2, 4)), 2),
         ("decode_priority", dict(values=tuple(range(1, 9))), 3),
         ("max_pending_handoffs", dict(values=(1, 2, 3, 4)), 2),
         ("ttft_threshold", dict(bounds=(0.25, 4.0)), 1.0)]


@pytest.fixture(scope="module")
def model():
    jax_cfg = JaxConfig(dtype=jnp.float32, **MODEL)
    params = jax_init(jax.random.PRNGKey(0), jax_cfg)
    return jax_cfg, params, TransformerConfig(dtype=torch.float32, **MODEL), \
        params_from_jax(jax.device_get(params), "cpu")


def _requests(n=6, sampled=False, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(1, 64, size=int(rng.integers(3, 20)))
        extra = (dict(temperature=0.8,
                      rng=torch.Generator().manual_seed(100 + i))
                 if sampled else {})
        out.append((f"r{i}", prompt, 10, extra))
    return out


def _engine(model, tuning_policy=None, **overrides):
    _, _, cfg, tp = model
    return ServingEngine(tp, cfg, EngineConfig(**{**POOL, **overrides}),
                         device="cpu", tuning_policy=tuning_policy)


def _run(engine, reqs):
    engine.warmup()
    before = engine.capture_counts()
    for rid, prompt, new, extra in reqs:
        engine.submit(Request(rid, prompt, new, **extra))
    out = engine.run()
    assert engine.capture_counts() == before
    return {rid: list(r.tokens) for rid, r in sorted(out.items())}


# ----------------------------------------------------------------------
# the module against JAX's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec,values", [
    (dict(values=(1, 2, 4)), [1, 2, 3, 4, True, 2.0, "2", None]),
    (dict(bounds=(0.5, 2.0)), [0.5, 1, 2.0, 2.5, 0.49, True, "1.0", None]),
], ids=["values", "bounds"])
def test_knobspec_admits_equals_jax(spec, values):
    ours = autotune.KnobSpec("k", **spec)
    theirs = jax_autotune.KnobSpec("k", **spec)
    assert [ours.admits(v) for v in values] \
        == [theirs.admits(v) for v in values]
    for mod in (autotune, jax_autotune):
        with pytest.raises(ValueError, match="exactly one"):
            mod.KnobSpec("k")


def test_cost_model_fit_and_draft_width_equal_jax():
    ours, theirs = autotune.CostModel(), jax_autotune.CostModel()
    for row, seconds in TRACE + [({"decode": 3.0}, 0.0), ({}, 1.0)]:
        ours.observe(row, seconds)
        theirs.observe(row, seconds)
    assert ours.coefficients == theirs.coefficients
    assert ours.coefficients.keys() == {"decode", "prefill", "mixed"}
    for kind in ("decode", "prefill", "mixed", "verify", "spec_loop"):
        assert ours.cost(kind) == theirs.cost(kind)
    for rate in np.linspace(0.0, 1.0, 21):
        for widths in ((1, 2, 4), (1, 2, 4, 8)):
            assert ours.best_draft_width(rate, widths) \
                == theirs.best_draft_width(rate, widths)
    fitted = autotune.FittedTracePolicy(TRACE)
    assert fitted.model.coefficients \
        == jax_autotune.FittedTracePolicy(TRACE).model.coefficients


@pytest.mark.parametrize("policy", ["analytic", "fitted"])
def test_policy_proposals_equal_jax(policy):
    def build(mod):
        if policy == "analytic":
            return mod.AnalyticPolicy(), mod.CostModel()
        return mod.FittedTracePolicy(TRACE), mod.CostModel()

    ours, our_model = build(autotune)
    theirs, their_model = build(jax_autotune)
    for signals in SIGNALS:
        for name, spec, value in KNOBS:
            views = {name: autotune.KnobView(
                autotune.KnobSpec(name, **spec), value)}
            jax_views = {name: jax_autotune.KnobView(
                jax_autotune.KnobSpec(name, **spec), value)}
            assert ours.propose(signals, views, our_model) \
                == theirs.propose(signals, jax_views, their_model)


def _knob_table(tuner):
    return {name: (knob.spec.values, knob.spec.bounds, knob.get())
            for name, knob in tuner.knobs.items()}


@pytest.mark.parametrize("overrides", [
    dict(ARMED), dict(mixed=True, steps_per_launch=2),
    dict(speculative=True, draft_len=2), dict(mixed=False)],
    ids=["armed", "loop_2", "spec_flat", "mixed_off"])
def test_for_engine_knobs_and_envelopes_equal_jax(model, overrides):
    jax_cfg, params, _, _ = model
    kw = dict(POOL, autotune=True, **overrides)
    jax_engine = JaxServingEngine(params, jax_cfg, JaxEngineConfig(**kw))
    engine = _engine(model, autotune=True, **overrides)
    assert _knob_table(engine._tuner) == _knob_table(jax_engine._tuner)
    assert engine._tuner.interval == jax_engine._tuner.interval == 32


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_streams_equal_tuner_off(model, sampled):
    """Speculation, mixed batching and the device loop all armed: the
    tuner may move every knob and no token may change."""
    extra = dict(top_k=10, top_p=0.95) if sampled else {}
    off = _run(_engine(model, **ARMED, **extra), _requests(sampled=sampled))
    engine = _engine(model, autotune=True, autotune_interval=2, **ARMED,
                     **extra)
    on = _run(engine, _requests(sampled=sampled))
    assert on == off
    assert engine._tuner._rounds > 0
    assert engine.capture_counts()["loop"] == 2  # depths 2 and 4
    assert engine.capture_counts()["spec_loop"] == 2


def test_streams_equal_jax_engine_with_the_tuner_on(model):
    jax_cfg, params, _, _ = model
    kw = dict(POOL, mixed=True, steps_per_launch=4, autotune=True,
              autotune_interval=2)
    jax_engine = JaxServingEngine(params, jax_cfg, JaxEngineConfig(**kw))
    for rid, prompt, new, _ in _requests():
        jax_engine.submit(JaxRequest(rid, prompt.astype(np.int32), new))
    want = {rid: list(r.tokens)
            for rid, r in sorted(jax_engine.run().items())}
    engine = _engine(model, mixed=True, steps_per_launch=4, autotune=True,
                     autotune_interval=2)
    assert _run(engine, _requests()) == want
    # the budget and depth decisions read counters only, so they match
    assert engine._tuner.decisions == jax_engine._tuner.decisions
    assert engine._tuner.trajectory == jax_engine._tuner.trajectory
    assert engine._tuner.trajectory


def test_out_of_envelope_and_crashing_policies_are_sandboxed(model):
    class Hostile(autotune.TuningPolicy):
        def propose(self, signals, knobs, cost_model):
            return {"mixed_prefill_budget": 999, "steps_per_launch": 3,
                    "draft_width_cap": True, "loop_draft_width": 64,
                    "no_such_knob": 1}

    class Crashing(autotune.TuningPolicy):
        def propose(self, signals, knobs, cost_model):
            raise RuntimeError("boom")

    baseline = _run(_engine(model, **ARMED), _requests())
    engine = _engine(model, tuning_policy=Hostile(), autotune=True,
                     autotune_interval=2, **ARMED)
    assert _run(engine, _requests()) == baseline
    assert (engine._mixed_budget, engine._loop_k, engine._draft_width_cap,
            engine._loop_draft_cap) == (8, 4, 4, 4)
    assert {d for _, d in engine._tuner.decisions} == {"rejected"}
    assert {k for k, _ in engine._tuner.decisions} == {
        "mixed_prefill_budget", "steps_per_launch", "draft_width_cap",
        "loop_draft_width", "no_such_knob"}
    assert engine._tuner.trajectory == []
    crashing = _engine(model, tuning_policy=Crashing(), autotune=True,
                       autotune_interval=2, mixed=True)
    assert len(_run(crashing, _requests(n=3))) == 3
    assert crashing._tuner.decisions[("policy", "rejected")] > 0


def test_tune_time_metered_outside_plan_and_decisions_exported(model):
    class Budget4(autotune.TuningPolicy):
        def propose(self, signals, knobs, cost_model):
            time.sleep(0.003)
            return {"mixed_prefill_budget": 4}

    engine = _engine(model, tuning_policy=Budget4(), autotune=True,
                     autotune_interval=2, mixed=True)
    _run(engine, _requests(n=3))
    hs = engine.host_seconds
    assert hs["tune"] > 0 and hs["plan"] < hs["tune"]
    metrics = flatten_metrics(engine.collect_metrics())
    assert metric_value(metrics, "kubeshare_serving_host_seconds_total",
                        phase="tune") == pytest.approx(hs["tune"])
    assert metric_value(metrics, "kubeshare_serving_tuner_decisions_total",
                        knob="mixed_prefill_budget", direction="down") == 1
    assert engine._mixed_budget == 4
    plain = _engine(model)
    _run(plain, _requests(n=2))
    assert plain.host_seconds["tune"] == 0.0
    families = {f.name: f for f in plain.collect_metrics()}
    assert families["kubeshare_serving_tuner_decisions_total"].samples == []
