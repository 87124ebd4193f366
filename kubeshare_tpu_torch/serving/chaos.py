"""Deterministic fault injection for the serving fleet, the port's own
copy of kubeshare_tpu/serving/chaos.py (the port imports nothing of the
JAX package).  The same plan over the same trace fires the same faults
and flips the same bits in both packages.

KubeShare's control plane is built on the assumption that workloads
die — the scheduler reclaims fractional cells through the pod-deleted
path and tokend leases expire (PAPER.md §1) — and this module brings
the same assumption into the serving plane as a TESTABLE contract.  A
chaos run is a plain serving run plus a :class:`FaultPlan`: a seeded,
declarative script of failures (replica kill at step N, slow/hung
dispatch, host-tier byte corruption, migration-ticket drops, transient
tokend refusals) that a :class:`FaultClock` replays through narrow
seams the serving stack already consults:

- ``ServingEngine.step()`` calls ``on_engine_step`` before any host
  state mutates — a planned kill raises :class:`ReplicaKilled` there,
  so the crashed engine's host-side records stay consistent for the
  fleet's recovery walk;
- ``ServingEngine._dispatch()`` calls ``on_dispatch`` — a slow or hung
  dispatch is a VIRTUAL-time delay, observable by the fleet's watchdog
  without ever sleeping the test process;
- ``HostTier.put()`` routes payload bytes through ``on_tier_put`` — a
  planned corruption flips one seeded bit, which the wire format's
  per-block crc32 must catch downstream;
- ``DisaggRouter`` consults ``on_ticket_delivery`` before each
  migration delivery attempt — a dropped ticket exercises the
  TTL/backoff retry path;
- ``TokenClient`` consults ``on_tokend_request`` before each wire
  round-trip — a refusal exercises the bounded-backoff retry;
- ``FabricTransport`` routes every transmitted frame through
  ``on_fabric_transmit`` — a planned fault drops, duplicates, reorders
  or bit-flips the frame in flight, and the fabric's per-message crc +
  ack/redelivery contract must absorb it;
- ``DiskTier`` routes every payload read through ``on_disk_read`` — a
  planned corruption models a rotten sector, which the wire-v2 block
  crc must catch before the bytes reach a device upload.

No monkeypatching anywhere: every seam is an attribute the component
owns (default ``None`` — zero overhead off the chaos path), so a chaos
run differs from a production run only in the plan it was handed.
Determinism is the whole point: the plan is seeded, the clock is
virtual (``now()`` advances ``step_dt`` per engine step plus any
injected delays — wire it in as the fleet's ``clock``), corruption
bits derive from ``crc32(seed, ordinal)``, and every injected fault is
appended to :attr:`FaultClock.events` so two runs of the same plan
over the same trace can be asserted identical, fault for fault.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Set, Tuple


class ReplicaKilled(RuntimeError):
    """The injected analog of a replica's pod dying mid-step: raised by
    the :class:`FaultClock` at the TOP of the doomed engine's
    ``step()``, before that step touches any host state.  The fleet's
    health monitor treats consecutive raises as missed liveness epochs
    and runs crash recovery; a dead engine stays dead — every later
    step raises again."""


class FaultPlan:
    """A seeded, declarative chaos script.  Builder methods return
    ``self`` so plans read as one chained expression::

        plan = (FaultPlan(seed=7)
                .kill("r1", at_step=40)
                .slow_dispatch("r0", at=12, seconds=0.05)
                .corrupt_tier_put(3)
                .drop_ticket(0)
                .refuse_tokend(2))

    Ordinals are 0-based and PER SEAM: ``at_step`` counts the target
    engine's own steps, ``at`` its dispatches; tier puts, ticket
    delivery attempts, and tokend round-trips count globally across the
    run.  The plan holds no mutable run state — one plan can drive any
    number of identical replays through fresh :class:`FaultClock`
    instances."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = int(seed)
        self.kills: Dict[str, int] = {}
        self.slow: Dict[str, Dict[int, float]] = {}
        self.tier_corruptions: Set[int] = set()
        self.ticket_drops: Set[int] = set()
        self.tokend_refusals: Set[int] = set()
        self.fabric_drops: Set[int] = set()
        self.fabric_duplicates: Set[int] = set()
        self.fabric_reorders: Set[int] = set()
        self.fabric_corruptions: Set[int] = set()
        self.disk_corruptions: Set[int] = set()

    # -- builders ------------------------------------------------------
    def kill(self, label: str, at_step: int) -> "FaultPlan":
        """Kill the engine labeled ``label`` (its ``replica_label``,
        else ``pool_label``) at its ``at_step``-th step."""
        if at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {at_step}")
        self.kills[label] = int(at_step)
        return self

    def slow_dispatch(self, label: str, at: int,
                      seconds: float) -> "FaultPlan":
        """Inflate the ``at``-th dispatch of engine ``label`` by
        ``seconds`` of VIRTUAL time (a hung dispatch is just a large
        value — the watchdog cannot tell the difference, which is the
        point)."""
        if at < 0:
            raise ValueError(f"at must be >= 0, got {at}")
        if seconds <= 0:
            raise ValueError(f"seconds must be > 0, got {seconds}")
        self.slow.setdefault(label, {})[int(at)] = float(seconds)
        return self

    def corrupt_tier_put(self, ordinal: int) -> "FaultPlan":
        """Flip one seeded bit in the payload of the ``ordinal``-th
        host-tier put (rot-in-storage / torn-write model; the wire
        crc32 must detect it on the way back out)."""
        if ordinal < 0:
            raise ValueError(f"ordinal must be >= 0, got {ordinal}")
        self.tier_corruptions.add(int(ordinal))
        return self

    def drop_ticket(self, ordinal: int) -> "FaultPlan":
        """Drop the ``ordinal``-th migration-ticket delivery attempt
        (lost handoff RPC; the router's TTL/backoff must retry or
        expire it)."""
        if ordinal < 0:
            raise ValueError(f"ordinal must be >= 0, got {ordinal}")
        self.ticket_drops.add(int(ordinal))
        return self

    def refuse_tokend(self, ordinal: int) -> "FaultPlan":
        """Refuse the ``ordinal``-th tokend wire round-trip (transient
        broker outage; the client's bounded backoff must absorb it)."""
        if ordinal < 0:
            raise ValueError(f"ordinal must be >= 0, got {ordinal}")
        self.tokend_refusals.add(int(ordinal))
        return self

    def drop_fabric(self, ordinal: int) -> "FaultPlan":
        """Drop the ``ordinal``-th fabric frame in flight (a lost
        datagram; the sender's TTL/backoff redelivery must recover
        it — or its expiry must surface through ``take_expired``).
        Ordinals count EVERY transmitted frame, acks and redeliveries
        included, in transmit order."""
        if ordinal < 0:
            raise ValueError(f"ordinal must be >= 0, got {ordinal}")
        self.fabric_drops.add(int(ordinal))
        return self

    def duplicate_fabric(self, ordinal: int) -> "FaultPlan":
        """Deliver the ``ordinal``-th fabric frame twice (a retransmit
        race; the receiver's (src, msg_id) dedup must absorb the
        second copy)."""
        if ordinal < 0:
            raise ValueError(f"ordinal must be >= 0, got {ordinal}")
        self.fabric_duplicates.add(int(ordinal))
        return self

    def reorder_fabric(self, ordinal: int) -> "FaultPlan":
        """Deliver the ``ordinal``-th fabric frame at the FRONT of the
        destination queue (it overtakes everything already in flight —
        only meaningful on the loopback transport; sockets are FIFO)."""
        if ordinal < 0:
            raise ValueError(f"ordinal must be >= 0, got {ordinal}")
        self.fabric_reorders.add(int(ordinal))
        return self

    def corrupt_fabric(self, ordinal: int) -> "FaultPlan":
        """Flip one seeded bit in the ``ordinal``-th fabric frame in
        flight (line noise; the per-message crc must reject the frame
        and redelivery must carry the clean copy)."""
        if ordinal < 0:
            raise ValueError(f"ordinal must be >= 0, got {ordinal}")
        self.fabric_corruptions.add(int(ordinal))
        return self

    def corrupt_disk_read(self, ordinal: int) -> "FaultPlan":
        """Flip one seeded bit in the payload returned by the
        ``ordinal``-th disk-tier read (a rotten sector under the mmap;
        the wire-v2 block crc must catch it before promotion)."""
        if ordinal < 0:
            raise ValueError(f"ordinal must be >= 0, got {ordinal}")
        self.disk_corruptions.add(int(ordinal))
        return self


class FaultClock:
    """The runtime half of a chaos run: counts each seam's ordinals,
    fires the plan's faults, and keeps a VIRTUAL monotonic clock so
    time-dependent machinery (the fleet watchdog, recovery latency
    histograms, drain timers) is deterministic — pass ``clock.now`` as
    the fleet's ``clock`` and no wall time leaks into the run.

    One instance is one run: ordinal counters and the :attr:`events`
    log are mutable run state.  Replay the same plan with a fresh
    clock and the events log must come out identical — that equality
    is what "replayable" means here, and tests assert it."""

    def __init__(self, plan: Optional[FaultPlan] = None, *,
                 step_dt: float = 1e-3) -> None:
        if step_dt <= 0:
            raise ValueError(f"step_dt must be > 0, got {step_dt}")
        self.plan = plan or FaultPlan()
        self.step_dt = step_dt
        self._now = 0.0
        self._steps: Dict[str, int] = {}
        self._dispatches: Dict[str, int] = {}
        self._puts = 0
        self._deliveries = 0
        self._tokend = 0
        self._fabric_frames = 0
        self._disk_reads = 0
        self.events: List[Tuple] = []

    # -- the virtual clock ---------------------------------------------
    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"seconds must be >= 0, got {seconds}")
        self._now += seconds

    @staticmethod
    def _label(engine) -> str:
        return (getattr(engine, "replica_label", None)
                or getattr(engine, "pool_label", None)
                or "engine")

    # -- seams ---------------------------------------------------------
    def on_engine_step(self, engine) -> None:
        """Called at the top of ``ServingEngine.step()``.  Advances the
        virtual clock one step quantum and raises ReplicaKilled at (and
        forever after) the engine's planned kill step — a crashed
        process does not come back because the scheduler polled it
        again."""
        label = self._label(engine)
        n = self._steps.get(label, 0)
        self._now += self.step_dt
        kill_at = self.plan.kills.get(label)
        if kill_at is not None and n >= kill_at:
            self.events.append(("kill", label, n))
            raise ReplicaKilled(
                f"replica {label!r} killed by FaultPlan at its step {n} "
                f"(planned step {kill_at})")
        self._steps[label] = n + 1

    def on_dispatch(self, engine) -> None:
        """Called before each device dispatch: a planned slow/hung
        dispatch adds virtual seconds the watchdog will observe."""
        label = self._label(engine)
        n = self._dispatches.get(label, 0)
        self._dispatches[label] = n + 1
        delay = self.plan.slow.get(label, {}).get(n)
        if delay is not None:
            self._now += delay
            self.events.append(("slow_dispatch", label, n, delay))

    def on_tier_put(self, payload: bytes) -> bytes:
        """Called by ``HostTier.put`` with the payload about to be
        stored: a planned corruption flips one bit, seeded from
        (plan seed, put ordinal) so replays rot the same byte.  Length
        is preserved — the tier's byte accounting stays honest; only
        the crc catches the damage."""
        n = self._puts
        self._puts = n + 1
        if n not in self.plan.tier_corruptions or not payload:
            return payload
        bit = (zlib.crc32(f"{self.plan.seed}:put:{n}".encode())
               % (len(payload) * 8))
        buf = bytearray(payload)
        buf[bit // 8] ^= 1 << (bit % 8)
        self.events.append(("corrupt_put", n, bit))
        return bytes(buf)

    def on_ticket_delivery(self, ticket=None) -> bool:
        """Consulted by the router before each migration delivery
        attempt; False means the attempt is dropped in flight (the
        ticket survives router-side and retries under its backoff)."""
        n = self._deliveries
        self._deliveries = n + 1
        if n in self.plan.ticket_drops:
            self.events.append(
                ("drop_ticket", n, getattr(ticket, "rid", None)))
            return False
        return True

    def on_tokend_request(self, verb: str = "") -> bool:
        """Consulted by ``TokenClient`` before each wire round-trip;
        True means the broker transiently refuses this attempt."""
        n = self._tokend
        self._tokend = n + 1
        if n in self.plan.tokend_refusals:
            self.events.append(("refuse_tokend", n, verb))
            return True
        return False

    def on_fabric_transmit(self, frame: bytes) -> List[Tuple[bytes, bool]]:
        """Consulted by a ``FabricTransport`` per transmitted frame:
        returns the DELIVERIES the plan decides on, each a
        ``(frame, front)`` pair where ``front`` asks for front-of-queue
        insertion (reorder).  ``[]`` drops the frame, two entries
        duplicate it, a mutated frame models line corruption (length
        preserved; the fabric envelope crc must catch it)."""
        n = self._fabric_frames
        self._fabric_frames = n + 1
        if n in self.plan.fabric_drops:
            self.events.append(("drop_fabric", n))
            return []
        if n in self.plan.fabric_corruptions and frame:
            bit = (zlib.crc32(f"{self.plan.seed}:fabric:{n}".encode())
                   % (len(frame) * 8))
            buf = bytearray(frame)
            buf[bit // 8] ^= 1 << (bit % 8)
            self.events.append(("corrupt_fabric", n, bit))
            return [(bytes(buf), False)]
        if n in self.plan.fabric_duplicates:
            self.events.append(("duplicate_fabric", n))
            return [(frame, False), (frame, False)]
        if n in self.plan.fabric_reorders:
            self.events.append(("reorder_fabric", n))
            return [(frame, True)]
        return [(frame, False)]

    def on_disk_read(self, payload: bytes) -> bytes:
        """Consulted by ``DiskTier`` per payload read: a planned
        corruption flips one seeded bit (rotten sector; length
        preserved — only the block crc catches the damage)."""
        n = self._disk_reads
        self._disk_reads = n + 1
        if n not in self.plan.disk_corruptions or not payload:
            return payload
        bit = (zlib.crc32(f"{self.plan.seed}:disk:{n}".encode())
               % (len(payload) * 8))
        buf = bytearray(payload)
        buf[bit // 8] ^= 1 << (bit % 8)
        self.events.append(("corrupt_disk_read", n, bit))
        return bytes(buf)
