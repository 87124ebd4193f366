"""Cost-model-driven online autotuning over the serving knob space, the
port's own copy of kubeshare_tpu/serving/autotune.py (the port imports
nothing of the JAX package).

Every performance knob the serving stack has grown — the fused-prefill
budget, the device-loop depth, the speculative draft width, the disagg
router's pacing and reserve margin, the fleet autoscaler's TTFT
threshold — is hand-set per workload.  This module closes the loop: a
per-kind cost model fitted online from the engine's own metrics plane
(dispatch counters by kind, acceptance ratios, TTFT histograms, queue
depths), and an :class:`AutoTuner` that retunes the CAPTURE-FREE knob
subset each tuning interval.

The contract that makes online tuning safe on a serving engine whose
zero-new-capture and bit-exactness invariants are test-locked:

- **Knobs are scheduling-only.**  Every tunable value changes WHICH
  warmed dispatch runs next, never the math inside one — streams are
  bit-exact tuner-on vs tuner-off by construction, greedy and sampled.
- **The envelope is the warmed-shape / validated-range set.**  A
  :class:`KnobSpec` carries either the discrete values the engine
  actually warmed (fused budget = the warmed chunk universe, loop depth
  = the warmed loop-K set, draft cap = the warmed verify widths) or a
  validated continuous range (the autoscaler threshold).
- **The sandbox is central, not advisory.**  A :class:`TuningPolicy` is
  pluggable and UNTRUSTED: it returns proposals, and the tuner applies
  only those :meth:`KnobSpec.admits` accepts — everything else is
  counted ``rejected`` and dropped, so a bad policy can cost throughput
  but can never trigger a new capture or an invalid config.

This module deliberately imports nothing from :mod:`engine`,
:mod:`disagg`, or :mod:`fleet` — the ``for_engine`` / ``for_router`` /
``for_fleet`` builders receive their target duck-typed and close over
it, so the dependency arrow points one way (engine -> autotune) and the
policy layer stays import-cycle-free, the same plugin discipline
KubeShare's scheduler takes for placement policies.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .metrics_view import CounterWindow, HistogramWindow, interval_quantile

__all__ = [
    "AnalyticPolicy",
    "AutoTuner",
    "CostModel",
    "FittedTracePolicy",
    "Knob",
    "KnobSpec",
    "KnobView",
    "TuningPolicy",
]


@dataclass(frozen=True)
class KnobSpec:
    """One knob's name and its sandbox envelope: either ``values`` (the
    discrete warmed-shape set) or ``bounds`` (an inclusive validated
    continuous range) — exactly one of the two."""

    name: str
    values: Optional[Tuple] = None
    bounds: Optional[Tuple[float, float]] = None

    def __post_init__(self) -> None:
        if (self.values is None) == (self.bounds is None):
            raise ValueError(
                f"knob {self.name!r} needs exactly one of values/bounds")

    def admits(self, value) -> bool:
        """The sandbox predicate: True iff ``value`` is inside the
        warmed-shape / validated-range envelope."""
        if isinstance(value, bool):
            return False  # bools are ints; a policy returning True for
            # a width knob would "admit" as 1 — refuse the pun loudly
        if self.values is not None:
            return value in self.values
        if not isinstance(value, (int, float)):
            return False
        lo, hi = self.bounds
        return lo <= value <= hi


@dataclass
class Knob:
    """A live knob: its envelope plus getter/setter closures over the
    tuned object (engine, router, fleet policy)."""

    spec: KnobSpec
    get: Callable[[], object]
    set: Callable[[object], None]


@dataclass(frozen=True)
class KnobView:
    """The read-only (spec, current value) pair a policy sees — a
    policy never holds the setter, so applying values stays behind the
    tuner's central sandbox."""

    spec: KnobSpec
    value: object


class CostModel:
    """Per-dispatch-kind cost model fitted online from interval
    observations.

    Each observation row is (interval dispatch counts by kind, wall
    seconds the interval took); the fit is a deterministic non-negative
    least-squares over the most recent rows, giving seconds-per-dispatch
    by kind.  Until enough full-rank rows exist, :meth:`cost` falls back
    to analytic relative costs — the ratios, not the absolute values,
    are what the policies consume."""

    # analytic fallback: relative dispatch costs (a fused dispatch does
    # both phases' work; a verify chunk is a decode step plus k extra
    # scored columns)
    DEFAULT_COSTS = {"prefill": 1.0, "decode": 1.0, "mixed": 1.4,
                     "verify": 1.2, "mixed_verify": 1.6, "loop": 1.0,
                     "spec_loop": 1.2}

    def __init__(self, max_rows: int = 64) -> None:
        self.max_rows = max_rows
        self.rows: List[Tuple[Dict[str, float], float]] = []
        self.coefficients: Dict[str, float] = {}

    def observe(self, dispatches: Dict[str, float], seconds: float) -> None:
        """Record one interval row and refit.  Empty or non-positive
        intervals are dropped (an idle interval carries no shape
        information, only scheduler sleep time)."""
        if seconds <= 0 or not any(v > 0 for v in dispatches.values()):
            return
        self.rows.append((dict(dispatches), float(seconds)))
        if len(self.rows) > self.max_rows:
            del self.rows[0]
        self._fit()

    def _fit(self) -> None:
        kinds = sorted({k for row, _ in self.rows
                        for k, v in row.items() if v > 0})
        if not kinds or len(self.rows) < len(kinds):
            return
        a = np.array([[row.get(k, 0.0) for k in kinds]
                      for row, _ in self.rows], dtype=float)
        b = np.array([s for _, s in self.rows], dtype=float)
        if np.linalg.matrix_rank(a) < len(kinds):
            return  # degenerate interval mix: keep the previous fit
        coef, *_ = np.linalg.lstsq(a, b, rcond=None)
        self.coefficients = {k: max(float(c), 0.0)
                             for k, c in zip(kinds, coef)}

    def cost(self, kind: str) -> float:
        """Fitted seconds per dispatch of ``kind``; analytic relative
        cost until the fit has something to say."""
        c = self.coefficients.get(kind)
        if c is not None and c > 0:
            return c
        return self.DEFAULT_COSTS.get(kind, 1.0)

    @staticmethod
    def expected_verify_tokens(accept_rate: float, k: int) -> float:
        """Expected emissions of one width-``k`` verify round at
        per-token acceptance probability ``accept_rate``: the accepted
        geometric prefix plus the always-emitted correction pick."""
        p = min(max(accept_rate, 0.0), 1.0)
        return sum(p ** i for i in range(1, k + 1)) + 1.0

    def verify_cost(self, k: int) -> float:
        """Cost of a width-``k`` verify dispatch: the fitted verify
        base scaled by a linear per-column surcharge."""
        return self.cost("verify") * (1.0 + 0.05 * k)

    def best_draft_width(self, accept_rate: float,
                         widths: Sequence[int]) -> int:
        """The width maximizing expected tokens per unit dispatch cost
        — the cost-model replacement for the fixed EMA doubling rule.
        Deterministic: ties break toward the narrower width."""
        best, best_score = 1, -1.0
        for k in sorted(widths):
            score = (self.expected_verify_tokens(accept_rate, k)
                     / self.verify_cost(k))
            if score > best_score + 1e-12:
                best, best_score = k, score
        return best


class TuningPolicy:
    """The pluggable policy interface.  ``signals`` is a flat dict of
    interval counter increases plus instantaneous gauges; ``knobs`` maps
    knob name to a read-only :class:`KnobView`; ``cost_model`` is the
    tuner's online fit.  Return ``{knob_name: proposed_value}`` —
    anything outside a knob's envelope is centrally rejected."""

    def propose(self, signals: Dict[str, float],
                knobs: Dict[str, KnobView],
                cost_model: CostModel) -> Dict[str, object]:
        raise NotImplementedError


def _step_discrete(values: Sequence, current, direction: int):
    """The neighbor of ``current`` in the sorted ``values`` envelope,
    one notch up (+1) or down (-1); a current value off the grid (a
    hand-set non-power-of-two budget) snaps to its nearest-below
    entry first."""
    vals = sorted(values)
    i = 0
    for j, v in enumerate(vals):
        if v <= current:
            i = j
    i = min(max(i + direction, 0), len(vals) - 1)
    return vals[i]


class AnalyticPolicy(TuningPolicy):
    """The default closed-form policy: each rule maps one interval
    signal to one knob nudge.

    - fused-prefill budget follows the interval prefill/decode work
      ratio (prefill-heavy -> widen the fused chunk, decode-heavy ->
      shrink it back toward minimal decode ride-along latency);
    - loop depth follows the realized fusion depth (launches exiting
      half-empty -> halve K; saturated launches -> double it; a K=1
      engine re-arms on a pure-decode interval);
    - draft-width cap is the cost model's expected-tokens-per-dispatch
      argmax at the interval acceptance rate;
    - router pacing/reserve follow the pending-handoff backlog vs the
      decode pool's free slots;
    - the autoscaler threshold tracks 2x the interval TTFT p95,
      clamped to its validated range."""

    def __init__(self, prefill_heavy: float = 0.5,
                 prefill_light: float = 0.125,
                 min_drafted: int = 8,
                 min_ttft_samples: int = 4) -> None:
        self.prefill_heavy = prefill_heavy
        self.prefill_light = prefill_light
        self.min_drafted = min_drafted
        self.min_ttft_samples = min_ttft_samples

    def propose(self, signals: Dict[str, float],
                knobs: Dict[str, KnobView],
                cost_model: CostModel) -> Dict[str, object]:
        out: Dict[str, object] = {}
        get = signals.get

        view = knobs.get("mixed_prefill_budget")
        if view is not None:
            prefill = get("prefill_chunks", 0.0)
            decode_units = get("decode_steps", 0.0) + get("verify_steps", 0.0)
            if prefill or decode_units:
                ratio = prefill / max(1.0, decode_units)
                if ratio > self.prefill_heavy:
                    nxt = _step_discrete(view.spec.values, view.value, +1)
                elif ratio < self.prefill_light:
                    nxt = _step_discrete(view.spec.values, view.value, -1)
                else:
                    nxt = view.value
                if nxt != view.value:
                    out["mixed_prefill_budget"] = nxt

        view = knobs.get("steps_per_launch")
        if view is not None:
            k = view.value
            launches = (get("loop_launches", 0.0)
                        + get("spec_loop_launches", 0.0))
            units = (get("loop_units", 0.0)
                     + get("spec_loop_units", 0.0))
            standalone_decode = (get("decode_steps", 0.0)
                                 - get("mixed_steps", 0.0)
                                 - get("loop_units", 0.0))
            other = (get("prefill_chunks", 0.0) + get("verify_steps", 0.0)
                     + get("mixed_steps", 0.0)
                     - get("spec_loop_units", 0.0))
            nxt = k
            if launches > 0:
                depth = units / launches
                if depth < 0.5 * k:
                    nxt = _step_discrete(view.spec.values, k, -1)
                elif depth > 0.9 * k:
                    nxt = _step_discrete(view.spec.values, k, +1)
            elif standalone_decode > 4 * other and standalone_decode > 0:
                # pure decode phase with the loop disarmed: re-arm it
                nxt = _step_discrete(view.spec.values, k, +1)
            if nxt != k:
                out["steps_per_launch"] = nxt

        view = knobs.get("draft_width_cap")
        if view is not None:
            drafted = get("spec_drafted", 0.0)
            accepted = get("spec_accepted", 0.0)
            if drafted >= self.min_drafted:
                best = cost_model.best_draft_width(
                    accepted / drafted, view.spec.values)
                if best != view.value:
                    out["draft_width_cap"] = best

        view = knobs.get("loop_draft_width")
        if view is not None:
            drafted = get("spec_drafted", 0.0)
            accepted = get("spec_accepted", 0.0)
            if drafted >= self.min_drafted:
                # the in-loop draft cap shares the verify-width economics
                # of the host cap, but every unit is launch-covered: the
                # argmax is the same expected-tokens-per-dispatch rule
                best = cost_model.best_draft_width(
                    accepted / drafted, view.spec.values)
                if best != view.value:
                    out["loop_draft_width"] = best

        view = knobs.get("decode_priority")
        if view is not None:
            pending = get("pending_handoffs", 0.0)
            free_d = get("decode_free_slots", 0.0)
            slots_d = get("decode_slots", 0.0)
            if pending > 0 and free_d == 0:
                nxt = _step_discrete(view.spec.values, view.value, +1)
            elif pending == 0 and free_d > slots_d / 2:
                nxt = _step_discrete(view.spec.values, view.value, -1)
            else:
                nxt = view.value
            if nxt != view.value:
                out["decode_priority"] = nxt

        view = knobs.get("max_pending_handoffs")
        if view is not None:
            free_d = get("decode_free_slots", 0.0)
            if free_d == 0:
                nxt = _step_discrete(view.spec.values, view.value, -1)
            elif free_d > view.value:
                nxt = _step_discrete(view.spec.values, view.value, +1)
            else:
                nxt = view.value
            if nxt != view.value:
                out["max_pending_handoffs"] = nxt

        view = knobs.get("ttft_threshold")
        if view is not None:
            n = get("ttft_n", 0.0)
            p95 = get("ttft_p95", 0.0)
            if n >= self.min_ttft_samples and p95 > 0:
                lo, hi = view.spec.bounds
                target = hi if p95 == float("inf") else min(
                    max(2.0 * p95, lo), hi)
                if abs(target - view.value) > 1e-9:
                    out["ttft_threshold"] = target

        return out


class FittedTracePolicy(AnalyticPolicy):
    """The recorded-trace fitted variant: the cost model is fitted ONCE
    from a recorded trace of ``(interval_dispatch_counts, seconds)``
    rows (scraped from a prior run's metrics plane) and frozen; the
    analytic rules then consult the frozen fit instead of the online
    one.  Deterministic by construction — the same trace always yields
    the same coefficients and therefore the same decisions."""

    def __init__(self, trace: Sequence[Tuple[Dict[str, float], float]],
                 **kwargs) -> None:
        super().__init__(**kwargs)
        self._model = CostModel(max_rows=max(len(trace), 1))
        for dispatches, seconds in trace:
            self._model.observe(dispatches, seconds)

    @property
    def model(self) -> CostModel:
        return self._model

    def propose(self, signals: Dict[str, float],
                knobs: Dict[str, KnobView],
                cost_model: CostModel) -> Dict[str, object]:
        return super().propose(signals, knobs, self._model)


class AutoTuner:
    """The retuning loop: every ``interval`` ticks, diff the target's
    cumulative counters into interval signals, feed the cost model one
    observation row, ask the policy for proposals, and apply ONLY the
    in-envelope ones.

    ``decisions`` counts every outcome by ``(knob, direction)`` with
    direction in {"up", "down", "rejected"} — exported as
    ``kubeshare_serving_tuner_decisions_total``; ``trajectory`` records
    each applied change as ``(round, knob, old, new)`` for the bench's
    knob-trajectory log."""

    def __init__(self, knobs: Sequence[Knob], policy: TuningPolicy,
                 read_signals: Callable[[], Tuple[Dict[str, float],
                                                  Dict[str, float]]],
                 interval: int = 32) -> None:
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.knobs: Dict[str, Knob] = {k.spec.name: k for k in knobs}
        self.policy = policy
        self.interval = interval
        self.cost_model = CostModel()
        self.decisions: Dict[Tuple[str, str], int] = {}
        self.trajectory: List[Tuple[int, str, object, object]] = []
        self._read_signals = read_signals
        self._window = CounterWindow()
        self._ticks = 0
        self._rounds = 0
        self._last_tick: Optional[float] = None

    def _bump(self, knob: str, direction: str) -> None:
        key = (knob, direction)
        self.decisions[key] = self.decisions.get(key, 0) + 1

    @staticmethod
    def _dispatch_interval(iv: Dict[str, float]) -> Dict[str, float]:
        """Interval counter increases -> per-kind STANDALONE dispatch
        counts (the cost model's row), mirroring the metrics plane's
        `kind` label arithmetic."""
        g = iv.get
        return {
            "prefill": g("prefill_chunks", 0.0) - g("mixed_steps", 0.0)
            - g("mixed_verify_steps", 0.0),
            "decode": g("decode_steps", 0.0) - g("mixed_steps", 0.0)
            - g("loop_units", 0.0),
            "mixed": g("mixed_steps", 0.0),
            "verify": g("verify_steps", 0.0) - g("mixed_verify_steps", 0.0)
            - g("spec_loop_units", 0.0),
            "mixed_verify": g("mixed_verify_steps", 0.0),
            "loop": g("loop_launches", 0.0),
            "spec_loop": g("spec_loop_launches", 0.0),
        }

    def tick(self) -> bool:
        """One scheduler-step heartbeat; retunes every ``interval``-th
        call.  Returns True when a tuning round ran."""
        self._ticks += 1
        if self._ticks % self.interval:
            return False
        self._rounds += 1
        now = time.monotonic()
        counters, gauges = self._read_signals()
        iv = self._window.update({k: float(v) for k, v in counters.items()})
        if self._last_tick is not None and counters:
            self.cost_model.observe(self._dispatch_interval(iv),
                                    now - self._last_tick)
        self._last_tick = now
        signals = {**iv, **gauges}
        views = {name: KnobView(k.spec, k.get())
                 for name, k in self.knobs.items()}
        try:
            proposals = self.policy.propose(signals, views,
                                            self.cost_model) or {}
        except Exception:
            # a crashing policy is sandboxed like an out-of-envelope
            # one: the serving loop must survive any plugged-in policy
            self._bump("policy", "rejected")
            return True
        for name, value in proposals.items():
            knob = self.knobs.get(name)
            if knob is None or not knob.spec.admits(value):
                self._bump(name, "rejected")
                continue
            old = knob.get()
            if value == old:
                continue
            knob.set(value)
            self._bump(name, "up" if value > old else "down")
            self.trajectory.append((self._rounds, name, old, value))
        return True

    def lane_draft_width(self, accept_rate: float, cap: int) -> int:
        """Per-lane draft width under the current cap: the cost model's
        expected-tokens-per-dispatch argmax over the warmed power-of-two
        widths up to ``cap`` — the tuner's replacement for the EMA
        doubling rule (the EMA itself stays maintained as this rule's
        input signal)."""
        widths = []
        w = 1
        while w <= cap:
            widths.append(w)
            w *= 2
        return self.cost_model.best_draft_width(accept_rate, widths)

    # ------------------------------------------------------------------
    # builders — each closes over its duck-typed target
    # ------------------------------------------------------------------
    @classmethod
    def for_engine(cls, engine, policy: Optional[TuningPolicy] = None,
                   interval: int = 32) -> "AutoTuner":
        """Tuner over one engine's capture-free knobs: the fused
        budget (warmed chunk universe), the effective loop depth
        (warmed loop-K set, 1 = loop disarmed), the draft-width cap
        (warmed verify widths), and — on a verify-in-loop engine — the
        in-loop draft width (data inside the warmed loop program)."""
        ec = engine.engine_config
        knobs: List[Knob] = []
        if ec.mixed and engine._warmed_widths:
            knobs.append(Knob(
                KnobSpec("mixed_prefill_budget",
                         values=tuple(sorted(engine._warmed_widths))),
                get=lambda: engine._mixed_budget,
                set=lambda v: setattr(engine, "_mixed_budget", v)))
        if engine._loop_steps:
            knobs.append(Knob(
                KnobSpec("steps_per_launch",
                         values=tuple(sorted({1, *engine._loop_steps}))),
                get=lambda: engine._loop_k,
                set=lambda v: setattr(engine, "_loop_k", v)))
        if ec.speculative:
            caps, w = [], 1
            while w <= ec.draft_len:
                caps.append(w)
                w *= 2
            knobs.append(Knob(
                KnobSpec("draft_width_cap", values=tuple(caps)),
                get=lambda: engine._draft_width_cap,
                set=lambda v: setattr(engine, "_draft_width_cap", v)))
        if getattr(engine, "_spec_loops", None):
            # the verify-in-loop draft cap: in-loop lane draft widths are
            # data (the loop pads to the warmed verify width), so any
            # power-of-two <= draft_len is capture-free by construction
            caps, w = [], 1
            while w <= ec.draft_len:
                caps.append(w)
                w *= 2
            knobs.append(Knob(
                KnobSpec("loop_draft_width", values=tuple(caps)),
                get=lambda: engine._loop_draft_cap,
                set=lambda v: setattr(engine, "_loop_draft_cap", v)))

        def read():
            counters = {
                "prefill_chunks": engine.prefill_chunks,
                "decode_steps": engine.decode_steps,
                "mixed_steps": engine.mixed_steps,
                "verify_steps": engine.verify_steps,
                "mixed_verify_steps": engine.mixed_verify_steps,
                "loop_launches": engine.loop_launches,
                "loop_units": engine.loop_units,
                "spec_loop_launches": engine.spec_loop_launches,
                "spec_loop_units": engine.spec_loop_units,
                "spec_drafted": sum(engine.spec_drafted.values()),
                "spec_accepted": sum(engine.spec_accepted.values()),
                "tokens_generated": engine.tokens_generated,
            }
            gauges = {
                "queue_depth": float(sum(
                    engine._queue.depths().values())),
                "free_slots": float(sum(
                    s.state == "free" for s in engine._slots)),
            }
            return counters, gauges

        return cls(knobs, policy or AnalyticPolicy(), read,
                   interval=interval)

    @classmethod
    def for_router(cls, router, policy: Optional[TuningPolicy] = None,
                   interval: int = 32) -> "AutoTuner":
        """Tuner over the disagg router's pacing and reserve margin.
        Knobs exist only for limits the router was built with: a
        ``None`` pacing/reserve stays None (there is no validated range
        to move inside)."""
        knobs: List[Knob] = []
        if router._decode_priority is not None:
            hi = max(8, 2 * router._decode_priority)
            knobs.append(Knob(
                KnobSpec("decode_priority",
                         values=tuple(range(1, hi + 1))),
                get=lambda: router._decode_priority,
                set=lambda v: setattr(router, "_decode_priority", v)))
        if router._max_pending_handoffs is not None:
            slots = router.decode.engine_config.num_slots
            knobs.append(Knob(
                KnobSpec("max_pending_handoffs",
                         values=tuple(range(1, slots + 1))),
                get=lambda: router._max_pending_handoffs,
                set=lambda v: setattr(router, "_max_pending_handoffs", v)))

        def read():
            p, d = router.prefill, router.decode
            counters = {
                "prefill_chunks": p.prefill_chunks + d.prefill_chunks,
                "decode_steps": p.decode_steps + d.decode_steps,
                "mixed_steps": p.mixed_steps + d.mixed_steps,
                "verify_steps": p.verify_steps + d.verify_steps,
                "mixed_verify_steps": (p.mixed_verify_steps
                                       + d.mixed_verify_steps),
                "loop_launches": p.loop_launches + d.loop_launches,
                "loop_units": p.loop_units + d.loop_units,
                "spec_loop_launches": (p.spec_loop_launches
                                       + d.spec_loop_launches),
                "spec_loop_units": p.spec_loop_units + d.spec_loop_units,
            }
            staged = sum(s.state != "free" for s in p._slots)
            gauges = {
                "pending_handoffs": float(staged + len(router._tickets)),
                "decode_free_slots": float(sum(
                    s.state == "free" for s in d._slots)),
                "decode_slots": float(d.engine_config.num_slots),
            }
            return counters, gauges

        return cls(knobs, policy or AnalyticPolicy(), read,
                   interval=interval)

    @classmethod
    def for_fleet(cls, fleet, scaling, bounds,
                  policy: Optional[TuningPolicy] = None,
                  interval: int = 32) -> "AutoTuner":
        """Tuner over the fleet autoscaler's TTFT breach threshold.
        ``scaling`` is the TTFTBreachPolicy-shaped object whose
        ``threshold_s`` is tuned within (initial/4, initial*4);
        ``bounds`` is the TTFT histogram's bucket-bound tuple (passed
        in — this module imports nothing from the engine)."""
        init = float(scaling.threshold_s)
        knobs = [Knob(
            KnobSpec("ttft_threshold", bounds=(init / 4.0, init * 4.0)),
            get=lambda: scaling.threshold_s,
            set=lambda v: setattr(scaling, "threshold_s", float(v)))]
        window = HistogramWindow()

        def read():
            iv = window.update(fleet._ttft_counts_snapshot())
            gauges = {
                "ttft_n": float(sum(iv)),
                "ttft_p95": interval_quantile(iv, 0.95, bounds),
            }
            return {}, gauges

        return cls(knobs, policy or AnalyticPolicy(), read,
                   interval=interval)
