"""Cluster KV fabric: one delivery bus for blocks, chains and tickets,
the port's own copy of kubeshare_tpu/serving/fabric.py (the port imports
nothing of the JAX package).

The serving plane ships serialized KV three ways — disagg handoff
tickets (TTL + bounded-backoff redelivery, disagg.py), fleet
drain/salvage inheritance over a shared host tier, and the in-process
cross-pool mirror.  This module carries the wire payloads
(CRC-protected, process-agnostic by construction) on a MESSAGE fabric
with per-message CRC, TTL expiry and bounded-backoff redelivery, so
migration, salvage and tier traffic share ONE delivery contract — and a
prefix DIRECTORY maps prefix keys to owning replicas/hosts, so a trie
miss on one replica can resolve to a remote promotion over the fabric
instead of a re-prefill.

Pieces:

- the **message envelope** (:func:`pack_message` / :func:`unpack_message`):
  magic + version + kind + (src, dest, msg_id) routing + body behind a
  crc32 trailer.  A flipped bit anywhere is a typed
  :class:`~kubeshare_tpu_torch.serving.kv_tier.WireCorruption` at
  unpack — the receiver drops the frame and the SENDER's redelivery
  recovers it;
- the **transport** (:class:`FabricTransport`): a byte channel moving
  opaque frames.  :class:`LoopbackTransport` is the in-process default
  (tests, single-host pools) and the chaos seam's attach point (drop /
  duplicate / reorder / corrupt in transit); :class:`SocketTransport`
  is the byte channel over connected sockets (``socketpair`` in tests,
  TCP across processes) — the same frames, the same envelope, an actual
  kernel boundary;
- the **endpoint** (:class:`FabricEndpoint`): at-least-once delivery
  over any transport — an outbox with TTL (virtual ticks, the disagg
  ticket discipline) and bounded exponential backoff, acks, and
  receiver-side (src, msg_id) dedup with re-ack, so a dropped frame is
  redelivered, a duplicated frame is absorbed, and a message the fabric
  cannot deliver within its TTL surfaces through :meth:`take_expired`
  for the OWNER to handle (a ticket expiry, a salvage give-up) instead
  of looping forever;
- the **directory** (:class:`FabricDirectory`): prefix key → owner
  names.  Owners publish at demotion/adoption and withdraw at drop;
  a router consults it before settling for a cold prefill;
- the **prefix store** (:func:`export_prefix_store` /
  :func:`serve_prefix_store` / :class:`PrefixStoreClient`): a trie's
  payload-backed prefixes exported to one file + manifest, served over
  a socket by a plain stdlib + numpy loop, fetched and adopted by a
  cold replica across the process boundary.

Every byte format equals the JAX package's for the same inputs, so
frames pass between the two packages.  A bf16 slab rides inside its
wire block as raw 2-byte words under the dtype name ``"bfloat16"``
(kv_tier.py); token runs are int32 numpy arrays in both packages.
Nothing here touches the device: the fabric moves bytes the wire format
already made portable.
"""

from __future__ import annotations

import hashlib
import select
import socket
import struct
import zlib
from collections import OrderedDict, deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..utils.promtext import MetricFamily
from .kv_tier import WireCorruption

# ---------------------------------------------------------------------------
# message envelope

FABRIC_MAGIC = b"KVFB"
FABRIC_VERSION = 1

# message kinds: what rides the bus.  CHAIN carries prefix payloads
# (salvage, remote promotion), TICKET a serialized disagg handoff,
# FETCH/RESP the directory-fetch request/response pair, ACK the
# delivery confirmation the redelivery contract turns on.
K_CHAIN = 1
K_TICKET = 2
K_FETCH = 3
K_RESP = 4
K_ACK = 5

KIND_NAMES = {K_CHAIN: "chain", K_TICKET: "ticket", K_FETCH: "fetch",
              K_RESP: "resp", K_ACK: "ack"}

# magic, version, kind, msg_id, src, dest, body_len (names are ascii,
# NUL-padded — same convention as the wire format's dtype field)
_MSG_HEADER = struct.Struct("<4sHHQ16s16sI")
_MSG_CRC = struct.Struct("<I")


def _name16(name: str) -> bytes:
    b = name.encode("ascii")
    if len(b) > 16:
        raise ValueError(f"fabric endpoint name {name!r} over 16 bytes")
    return b.ljust(16, b"\0")


def pack_message(kind: int, msg_id: int, src: str, dest: str,
                 body: bytes) -> bytes:
    """Seal one fabric frame: envelope + body + crc32 trailer over
    everything before it."""
    if kind not in KIND_NAMES:
        raise ValueError(f"unknown fabric message kind {kind}")
    head = _MSG_HEADER.pack(FABRIC_MAGIC, FABRIC_VERSION, kind, msg_id,
                            _name16(src), _name16(dest), len(body))
    buf = head + body
    return buf + _MSG_CRC.pack(zlib.crc32(buf) & 0xFFFFFFFF)


def unpack_message(buf: bytes) -> Tuple[int, int, str, str, bytes]:
    """Inverse of :func:`pack_message`: ``(kind, msg_id, src, dest,
    body)``.  Checks the crc FIRST (no envelope field is trusted before
    it passes): :class:`WireCorruption` on a mismatch, plain
    :class:`ValueError` on intact-but-foreign magic/version."""
    if len(buf) < _MSG_HEADER.size + _MSG_CRC.size:
        raise WireCorruption(
            f"fabric message truncated at {len(buf)} bytes")
    (crc,) = _MSG_CRC.unpack_from(buf, len(buf) - _MSG_CRC.size)
    if zlib.crc32(memoryview(buf)[:-_MSG_CRC.size]) & 0xFFFFFFFF != crc:
        raise WireCorruption(
            f"fabric message checksum mismatch over {len(buf)} bytes")
    magic, version, kind, msg_id, src, dest, body_len = \
        _MSG_HEADER.unpack_from(buf)
    if magic != FABRIC_MAGIC:
        raise ValueError(f"bad fabric magic {magic!r}")
    if version != FABRIC_VERSION:
        raise ValueError(
            f"fabric version {version} unsupported (this build speaks "
            f"{FABRIC_VERSION})")
    if kind not in KIND_NAMES:
        raise ValueError(f"unknown fabric message kind {kind}")
    body = buf[_MSG_HEADER.size: len(buf) - _MSG_CRC.size]
    if len(body) != body_len:
        raise ValueError(
            f"fabric body is {len(body)} bytes, header promises "
            f"{body_len}")
    return (kind, msg_id, src.rstrip(b"\0").decode("ascii"),
            dest.rstrip(b"\0").decode("ascii"), body)


# ---------------------------------------------------------------------------
# body helpers

_U32 = struct.Struct("<I")
_PREFIX_REC = struct.Struct("<II")  # n_tokens, payload_len


def pack_prefix_blocks(items: Iterable[Tuple[np.ndarray, bytes]]) -> bytes:
    """Serialize a CUMULATIVE prefix chain: each record is (the full
    root-to-node token path, the node's wire-v2 payload), in ancestor
    order — exactly what a receiver feeds ``adopt_into`` one record at
    a time (``adopt_host`` requires the ancestors first)."""
    parts: List[bytes] = []
    count = 0
    for tokens, payload in items:
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        parts.append(_PREFIX_REC.pack(toks.size, len(payload)))
        parts.append(toks.tobytes())
        parts.append(bytes(payload))
        count += 1
    return _U32.pack(count) + b"".join(parts)


def unpack_prefix_blocks(body: bytes) -> List[Tuple[np.ndarray, bytes]]:
    """Inverse of :func:`pack_prefix_blocks`.  Plain ValueError on a
    malformed body — the envelope crc already vouched for transit, so
    a parse failure here is a sender bug, not line noise."""
    if len(body) < _U32.size:
        raise ValueError(f"prefix-block body truncated at {len(body)}")
    (count,) = _U32.unpack_from(body)
    off = _U32.size
    out: List[Tuple[np.ndarray, bytes]] = []
    for _ in range(count):
        if off + _PREFIX_REC.size > len(body):
            raise ValueError("prefix-block body truncated mid-record")
        n_tok, n_pay = _PREFIX_REC.unpack_from(body, off)
        off += _PREFIX_REC.size
        end = off + 4 * n_tok + n_pay
        if end > len(body):
            raise ValueError("prefix-block record overruns the body")
        tokens = np.frombuffer(body, np.int32, n_tok, off).copy()
        payload = body[off + 4 * n_tok: end]
        out.append((tokens, payload))
        off = end
    if off != len(body):
        raise ValueError(
            f"prefix-block body carries {len(body) - off} trailing bytes")
    return out


def pack_chain_msg(tenant: str,
                   items: Iterable[Tuple[np.ndarray, bytes]]) -> bytes:
    """A K_CHAIN message body: the owning tenant (tier accounting must
    survive the hop) plus the prefix records."""
    t = tenant.encode("utf-8")
    return _U32.pack(len(t)) + t + pack_prefix_blocks(list(items))


def unpack_chain_msg(body: bytes) -> Tuple[str,
                                           List[Tuple[np.ndarray, bytes]]]:
    if len(body) < _U32.size:
        raise ValueError(f"chain message truncated at {len(body)}")
    (n,) = _U32.unpack_from(body)
    if _U32.size + n > len(body):
        raise ValueError("chain message tenant field overruns the body")
    tenant = body[_U32.size: _U32.size + n].decode("utf-8")
    return tenant, unpack_prefix_blocks(body[_U32.size + n:])


# disagg handoff ticket body: everything the decode side needs to admit
# the migrated request, minus the result object (results stay host-side
# on the router, keyed by rid)
_TICKET_MAGIC = b"KVTK"
_TICKET_HEADER = struct.Struct("<4sHH")
# first_token, max_new, temperature, pack_stall_s, last_token_at
# (NaN encodes "no token emitted yet")
_TICKET_FIXED = struct.Struct("<qqddd")


def _pack_lp(b: bytes) -> bytes:
    return _U32.pack(len(b)) + b


class _BodyReader:
    def __init__(self, body: bytes, off: int = 0) -> None:
        self.body = body
        self.off = off

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.body):
            raise ValueError("ticket body truncated")
        out = self.body[self.off: self.off + n]
        self.off += n
        return out

    def take_lp(self) -> bytes:
        (n,) = _U32.unpack(self.take(_U32.size))
        return self.take(n)


def seeds_to_keys(seeds) -> np.ndarray:
    """The port's int64 sampling seeds as the ticket's key field: each
    seed its two little-endian uint32 words, low word first, one row a
    seed (``[n, 2]``; ``[0, 2]`` for a greedy stream, the shape JAX's
    greedy schedule has)."""
    seeds = np.ascontiguousarray(np.asarray(seeds, "<i8").reshape(-1))
    return seeds.view("<u4").reshape(-1, 2).astype(np.uint32)


def keys_to_seeds(keys) -> np.ndarray:
    """Inverse of :func:`seeds_to_keys`: int64 seeds from ``[n, 2]``
    uint32 words (an empty key array gives no seeds)."""
    words = np.ascontiguousarray(np.asarray(keys, "<u4").reshape(-1))
    return words.view("<i8").astype(np.int64)


def pack_ticket(rid: str, tenant: str, prompt: np.ndarray,
                first_token: int, max_new: int, temperature: float,
                step_keys: np.ndarray, payload: bytes,
                emitted_prefix: Iterable[int], hint: np.ndarray,
                pack_stall_s: float,
                last_token_at: Optional[float] = None) -> bytes:
    """Serialize one disagg handoff ticket for the fabric.
    ``step_keys`` is the remaining sampling schedule as a uint32 array
    ``[n_keys, key_width]`` (possibly 0-row: greedy): JAX's tickets carry
    PRNG keys there, the port's its int64 seeds, each as its two uint32
    words, low word first (:func:`seeds_to_keys`), so the byte layout is
    JAX's and a greedy ticket's bytes equal JAX's for the same fields.
    ``payload`` is the packed block chain (already wire-v2 framed),
    ``hint`` the drafter seed window (possibly empty)."""
    prompt = np.ascontiguousarray(np.asarray(prompt, np.int32))
    keys = np.ascontiguousarray(np.asarray(step_keys, np.uint32))
    if keys.ndim == 1:
        keys = keys.reshape(0, 0) if keys.size == 0 else keys.reshape(1, -1)
    hint = np.ascontiguousarray(np.asarray(hint, np.int32))
    emitted = np.ascontiguousarray(
        np.asarray(list(emitted_prefix), np.int32))
    parts = [
        _TICKET_HEADER.pack(_TICKET_MAGIC, 1, 0),
        _pack_lp(rid.encode("utf-8")),
        _pack_lp(tenant.encode("utf-8")),
        _TICKET_FIXED.pack(int(first_token), int(max_new),
                           float(temperature), float(pack_stall_s),
                           float("nan") if last_token_at is None
                           else float(last_token_at)),
        _pack_lp(prompt.tobytes()),
        struct.pack("<II", keys.shape[0],
                    keys.shape[1] if keys.ndim == 2 else 0),
        _pack_lp(keys.tobytes()),
        _pack_lp(emitted.tobytes()),
        _pack_lp(hint.tobytes()),
        _pack_lp(payload),
    ]
    return b"".join(parts)


def unpack_ticket(body: bytes) -> dict:
    """Inverse of :func:`pack_ticket`; returns a plain dict of fields
    (the caller rebuilds its own ticket type around them)."""
    r = _BodyReader(body)
    magic, version, _ = _TICKET_HEADER.unpack(r.take(_TICKET_HEADER.size))
    if magic != _TICKET_MAGIC:
        raise ValueError(f"bad ticket magic {magic!r}")
    if version != 1:
        raise ValueError(f"ticket version {version} unsupported")
    rid = r.take_lp().decode("utf-8")
    tenant = r.take_lp().decode("utf-8")
    first_token, max_new, temperature, pack_stall_s, last_at = \
        _TICKET_FIXED.unpack(r.take(_TICKET_FIXED.size))
    prompt = np.frombuffer(r.take_lp(), np.int32).copy()
    n_keys, key_w = struct.unpack("<II", r.take(8))
    keys = np.frombuffer(r.take_lp(), np.uint32).copy()
    keys = keys.reshape(n_keys, key_w) if n_keys else keys.reshape(0, 0)
    emitted = np.frombuffer(r.take_lp(), np.int32).copy()
    hint = np.frombuffer(r.take_lp(), np.int32).copy()
    payload = r.take_lp()
    if r.off != len(body):
        raise ValueError(
            f"ticket body carries {len(body) - r.off} trailing bytes")
    return dict(rid=rid, tenant=tenant, prompt=prompt,
                first_token=int(first_token), max_new=int(max_new),
                temperature=float(temperature), step_keys=keys,
                emitted_prefix=[int(t) for t in emitted], hint=hint,
                payload=payload, pack_stall_s=float(pack_stall_s),
                last_token_at=(None if last_at != last_at
                               else float(last_at)))


# ---------------------------------------------------------------------------
# transports

class FabricTransport:
    """A byte channel moving opaque frames between named endpoints.
    ``fault_clock`` is the chaos seam (serving/chaos.py): consulted per
    transmitted frame, it returns the DELIVERIES the fault plan decides
    on — ``[]`` drops the frame, two entries duplicate it, a mutated
    frame models line corruption (the envelope crc catches it), and a
    front-of-queue delivery models reorder.  None outside chaos runs."""

    fault_clock = None

    def _deliveries(self, frame: bytes) -> List[Tuple[bytes, bool]]:
        if self.fault_clock is None:
            return [(frame, False)]
        return self.fault_clock.on_fabric_transmit(frame)

    def send(self, dest: str, frame: bytes) -> None:
        raise NotImplementedError

    def poll(self, name: str) -> List[bytes]:
        raise NotImplementedError


class LoopbackTransport(FabricTransport):
    """In-process transport: per-destination FIFO deques.  The default
    for single-host fleets, tests and the chaos harness — same frames,
    same envelope, no kernel boundary."""

    def __init__(self) -> None:
        self._queues: Dict[str, deque] = {}

    def send(self, dest: str, frame: bytes) -> None:
        q = self._queues.setdefault(dest, deque())
        for f, front in self._deliveries(frame):
            if front:
                q.appendleft(f)
            else:
                q.append(f)

    def poll(self, name: str) -> List[bytes]:
        q = self._queues.get(name)
        if not q:
            return []
        out = list(q)
        q.clear()
        return out


_FRAME_LEN = struct.Struct("<I")


def send_frame(sock: socket.socket, frame: bytes) -> None:
    """Length-prefixed frame write (blocking)."""
    sock.sendall(_FRAME_LEN.pack(len(frame)) + frame)


def recv_frame(sock: socket.socket) -> Optional[bytes]:
    """Length-prefixed frame read (blocking); None on clean EOF."""
    head = b""
    while len(head) < _FRAME_LEN.size:
        chunk = sock.recv(_FRAME_LEN.size - len(head))
        if not chunk:
            return None
        head += chunk
    (n,) = _FRAME_LEN.unpack(head)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            raise WireCorruption(
                f"fabric frame truncated mid-body at {len(buf)}/{n}")
        buf += chunk
    return bytes(buf)


class SocketTransport(FabricTransport):
    """The real byte-channel transport: one connected socket per side,
    frames length-prefixed on the wire.  ``poll`` drains without
    blocking (select + buffered reassembly), so an engine step never
    stalls on the fabric.  Socket order is FIFO — the chaos reorder
    fault only applies on the loopback transport; drop/duplicate/
    corrupt apply here too (the seam mutates the transmit side)."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._buf = bytearray()

    @classmethod
    def pair(cls) -> Tuple["SocketTransport", "SocketTransport"]:
        """Two transports over a real ``socketpair`` — the honest-wire
        test fixture: bytes cross a kernel buffer, not a Python list."""
        sa, sb = socket.socketpair()
        return cls(sa), cls(sb)

    def close(self) -> None:
        self._sock.close()

    def send(self, dest: str, frame: bytes) -> None:
        for f, _front in self._deliveries(frame):
            send_frame(self._sock, f)

    def poll(self, name: str) -> List[bytes]:
        while select.select([self._sock], [], [], 0)[0]:
            try:
                chunk = self._sock.recv(65536)
            except (BlockingIOError, InterruptedError):
                break
            if not chunk:
                break
            self._buf += chunk
        out: List[bytes] = []
        while len(self._buf) >= _FRAME_LEN.size:
            (n,) = _FRAME_LEN.unpack_from(self._buf)
            if len(self._buf) < _FRAME_LEN.size + n:
                break
            out.append(bytes(self._buf[_FRAME_LEN.size:
                                       _FRAME_LEN.size + n]))
            del self._buf[: _FRAME_LEN.size + n]
        return out


# ---------------------------------------------------------------------------
# endpoint: the delivery contract

class _OutMsg:
    __slots__ = ("msg_id", "dest", "kind", "frame", "body", "attempts",
                 "created_tick", "next_attempt_tick")

    def __init__(self, msg_id: int, dest: str, kind: int, frame: bytes,
                 body: bytes, tick: int, next_tick: int) -> None:
        self.msg_id = msg_id
        self.dest = dest
        self.kind = kind
        self.frame = frame
        self.body = body
        self.attempts = 1
        self.created_tick = tick
        self.next_attempt_tick = next_tick


class FabricEndpoint:
    """At-least-once delivery over any :class:`FabricTransport` — the
    disagg ticket discipline generalized to every message kind:

    - every send lands in an OUTBOX and stays there until the peer's
      ACK arrives;
    - :meth:`tick` (virtual time, the owner's step cadence) retransmits
      due entries under bounded exponential backoff
      (``min(backoff_cap, backoff_base * 2^(attempts-1))`` ticks) and
      EXPIRES entries older than ``ttl_ticks`` — surfaced through
      :meth:`take_expired` for the owner to handle, never silently
      dropped;
    - the receive side dedups on (src, msg_id) and RE-ACKS duplicates
      (the first ack may itself have been dropped), so redelivery can
      never double-apply a message.

    Counters (``messages[(kind, outcome)]``, ``bytes_total``,
    ``redeliveries``) are the raw material of the
    ``kubeshare_serving_fabric_*`` metric families."""

    def __init__(self, name: str, transport: FabricTransport, *,
                 ttl_ticks: int = 16, backoff_base: int = 1,
                 backoff_cap: int = 8) -> None:
        if ttl_ticks < 1:
            raise ValueError(f"ttl_ticks must be >= 1, got {ttl_ticks}")
        if backoff_base < 1 or backoff_cap < backoff_base:
            raise ValueError(
                f"need 1 <= backoff_base <= backoff_cap, got "
                f"{backoff_base}/{backoff_cap}")
        _name16(name)  # validate eagerly
        self.name = name
        self.transport = transport
        self.ttl_ticks = ttl_ticks
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self._tick = 0
        self._next_msg_id = 0
        self._outbox: "OrderedDict[int, _OutMsg]" = OrderedDict()
        self._expired: List[_OutMsg] = []
        self._delivered: List[int] = []
        # (src, msg_id) already applied — dedup + re-ack window.  Kept
        # unbounded: msg_ids are per-sender monotonic and a serving
        # run's message count is far below memory-relevant scale.
        self._seen: set = set()
        self.messages: Dict[Tuple[str, str], int] = {}
        self.bytes_total = 0
        self.redeliveries = 0

    # -- bookkeeping ---------------------------------------------------
    def _count(self, kind: int, outcome: str) -> None:
        k = (KIND_NAMES[kind], outcome)
        self.messages[k] = self.messages.get(k, 0) + 1

    @property
    def inflight(self) -> int:
        return len(self._outbox)

    # -- send side -----------------------------------------------------
    def send(self, dest: str, kind: int, body: bytes) -> int:
        """Queue + transmit one message; returns its msg_id (the handle
        :meth:`take_expired` reports and acks resolve)."""
        msg_id = self._next_msg_id
        self._next_msg_id += 1
        frame = pack_message(kind, msg_id, self.name, dest, body)
        self._outbox[msg_id] = _OutMsg(
            msg_id, dest, kind, frame, body, self._tick,
            self._tick + self.backoff_base)
        self.transport.send(dest, frame)
        self._count(kind, "sent")
        self.bytes_total += len(frame)
        return msg_id

    def tick(self) -> None:
        """Advance virtual time one step: expire overdue outbox
        entries, retransmit due ones with doubled (capped) backoff."""
        self._tick += 1
        for msg in list(self._outbox.values()):
            # age check FIRST and unconditionally — a capped backoff
            # can schedule the next attempt past the TTL horizon, and
            # expiry must land at ttl_ticks, not at the next retry
            if self._tick - msg.created_tick >= self.ttl_ticks:
                del self._outbox[msg.msg_id]
                self._expired.append(msg)
                self._count(msg.kind, "expired")
                continue
            if msg.next_attempt_tick > self._tick:
                continue
            msg.attempts += 1
            self.redeliveries += 1
            self._count(msg.kind, "redelivered")
            self.bytes_total += len(msg.frame)
            backoff = min(self.backoff_cap,
                          self.backoff_base * (1 << (msg.attempts - 1)))
            msg.next_attempt_tick = self._tick + backoff
            self.transport.send(msg.dest, msg.frame)

    def take_expired(self) -> List[Tuple[str, int, int, bytes]]:
        """Messages the fabric gave up on: ``(dest, kind, msg_id,
        body)`` per entry, drained — the owner decides what expiry
        means (a ticket resume, a salvage loss counter)."""
        out = [(m.dest, m.kind, m.msg_id, m.body) for m in self._expired]
        self._expired.clear()
        return out

    def take_delivered(self) -> List[int]:
        """msg_ids whose acks arrived since the last call, drained —
        the owner retires whatever send-side state it kept per
        message (e.g. the disagg router's in-flight ticket map)."""
        out = self._delivered
        self._delivered = []
        return out

    # -- receive side --------------------------------------------------
    def poll(self) -> List[Tuple[str, int, int, bytes]]:
        """Drain the transport: ``(src, kind, msg_id, body)`` per NEW
        message, in arrival order.  Corrupt frames are dropped (the
        sender redelivers), duplicates are absorbed and re-acked, acks
        retire outbox entries."""
        out: List[Tuple[str, int, int, bytes]] = []
        for frame in self.transport.poll(self.name):
            try:
                kind, msg_id, src, dest, body = unpack_message(frame)
            except WireCorruption:
                # can't trust ANY field (the kind byte included) — count
                # under a reserved kind label and let redelivery recover
                self.messages[("unknown", "corrupt")] = \
                    self.messages.get(("unknown", "corrupt"), 0) + 1
                continue
            if dest != self.name:
                self._count(kind, "misrouted")
                continue
            if kind == K_ACK:
                msg = self._outbox.pop(msg_id, None)
                if msg is not None:
                    self._count(msg.kind, "delivered")
                    self._delivered.append(msg_id)
                continue
            dedup = (src, msg_id)
            ack = pack_message(K_ACK, msg_id, self.name, src, b"")
            if dedup in self._seen:
                self._count(kind, "duplicate")
                self.transport.send(src, ack)  # the first ack may have
                continue                       # been the dropped frame
            self._seen.add(dedup)
            self.transport.send(src, ack)
            self._count(kind, "received")
            self.bytes_total += len(frame)
            out.append((src, kind, msg_id, body))
        return out


# ---------------------------------------------------------------------------
# metrics

def fabric_metric_families(
        endpoints: Iterable[FabricEndpoint]) -> List[MetricFamily]:
    """The fabric's three metric families, summed over ``endpoints`` —
    one implementation shared by every owner (fleet, disagg router)
    so their counters can't drift apart."""
    msgs: Dict[Tuple[str, str], int] = {}
    total_bytes = 0
    redeliveries = 0
    for ep in endpoints:
        for key, n in ep.messages.items():
            msgs[key] = msgs.get(key, 0) + n
        total_bytes += ep.bytes_total
        redeliveries += ep.redeliveries
    fam_msgs = MetricFamily(
        "kubeshare_serving_fabric_messages_total",
        "Fabric messages by kind and outcome (sent/received/delivered "
        "= the happy path as seen from each end; redelivered = "
        "backoff retransmits; duplicate = absorbed by receiver dedup; "
        "corrupt = frame failed its crc and was dropped for "
        "redelivery; expired = TTL exhausted, surfaced to the owner)")
    for (kind, outcome), n in sorted(msgs.items()):
        fam_msgs.add({"kind": kind, "outcome": outcome}, n)
    fam_bytes = MetricFamily(
        "kubeshare_serving_fabric_bytes_total",
        "Framed bytes moved over the fabric (transmits, retransmits "
        "and receives, envelope included)")
    fam_bytes.add({}, total_bytes)
    fam_redeliveries = MetricFamily(
        "kubeshare_serving_fabric_redeliveries_total",
        "Fabric frames retransmitted under the bounded-backoff "
        "redelivery contract")
    fam_redeliveries.add({}, redeliveries)
    return [fam_msgs, fam_bytes, fam_redeliveries]


# ---------------------------------------------------------------------------
# directory

def prefix_fabric_key(tokens) -> bytes:
    """The fabric's content address for a token prefix: a 16-byte
    blake2b over the int32 token run.  Computed at block boundaries —
    the directory's granularity is the trie's."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    return hashlib.blake2b(toks.tobytes(), digest_size=16).digest()


class FabricDirectory:
    """Prefix key → owner names.  Owners publish what they hold
    (demotion, adoption) and withdraw what they drop; a router consults
    :meth:`lookup` before settling for a cold prefill.  Deliberately
    dumb — no TTLs, no gossip: staleness is SAFE (a fetch from a
    withdrawn owner returns empty and the requester falls back cold;
    the payload crc guards everything else), so the directory can be an
    in-process dict today and a distributed map later without touching
    its consumers."""

    def __init__(self) -> None:
        self._owners: Dict[bytes, "OrderedDict[str, None]"] = {}
        # token length per key — lets a consumer rank candidate
        # boundaries longest-first without re-deriving lengths
        self._token_len: Dict[bytes, int] = {}

    def __len__(self) -> int:
        return len(self._owners)

    def publish(self, key: bytes, owner: str,
                token_len: Optional[int] = None) -> None:
        self._owners.setdefault(key, OrderedDict())[owner] = None
        if token_len is not None:
            self._token_len[key] = token_len

    def withdraw(self, key: bytes, owner: str) -> None:
        owners = self._owners.get(key)
        if owners is None:
            return
        owners.pop(owner, None)
        if not owners:
            del self._owners[key]
            self._token_len.pop(key, None)

    def withdraw_owner(self, owner: str) -> None:
        """Drop EVERY publication by ``owner`` — a crashed replica's
        directory exit."""
        for key in list(self._owners):
            self.withdraw(key, owner)

    def lookup(self, key: bytes) -> List[str]:
        return list(self._owners.get(key, ()))

    def token_len(self, key: bytes) -> Optional[int]:
        return self._token_len.get(key)


# ---------------------------------------------------------------------------
# cross-process prefix store

_STORE_MAGIC = b"KVPS"
_STORE_HEADER = struct.Struct("<4sHHI")  # magic, version, reserved, count


def export_prefix_store(index, payload_of: Callable[[object],
                                                    Optional[bytes]],
                        path: str) -> List[Tuple[bytes, int]]:
    """Walk ``index`` (a :class:`~kubeshare_tpu_torch.serving.
    prefix_index.PrefixIndex`) and write every prefix whose FULL ancestor chain is
    payload-backed into one store file.  ``payload_of(node)`` returns
    the node's serialized wire-v2 block (host tier, disk tier) or None
    when the node's bytes are unavailable (device-resident — reading
    the pool needs the engine; exporters snapshot after demotion).

    Returns the manifest: ``(prefix_fabric_key, token_len)`` per stored
    prefix — what a remote :class:`FabricDirectory` is seeded with.
    The file format is a counted sequence of
    :func:`pack_prefix_blocks`-style records, one CUMULATIVE chain per
    stored prefix, longest-path entries included individually so the
    server's lookup is a dict hit."""
    chains: List[Tuple[bytes, int, bytes]] = []

    def visit(node, path_tokens: List[int],
              chain: List[Tuple[np.ndarray, bytes]]) -> None:
        payload = payload_of(node)
        if payload is None:
            return  # device-resident (or root): nothing exportable below
        toks = path_tokens + [int(t) for t in node.tokens]
        grown = chain + [(np.asarray(toks, np.int32), payload)]
        key = prefix_fabric_key(toks)
        chains.append((key, len(toks), pack_prefix_blocks(grown)))
        for child in list(node.children.values()) + node.partials:
            visit(child, toks, grown)

    root = index._root
    for child in list(root.children.values()) + root.partials:
        visit(child, [], [])
    with open(path, "wb") as f:
        f.write(_STORE_HEADER.pack(_STORE_MAGIC, 1, 0, len(chains)))
        for key, token_len, body in chains:
            f.write(key)
            f.write(struct.pack("<II", token_len, len(body)))
            f.write(body)
    return [(key, token_len) for key, token_len, _ in chains]


def load_prefix_store(path: str) -> Dict[bytes, bytes]:
    """Read a store file back: ``{prefix key: packed chain body}``."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _STORE_HEADER.size:
        raise ValueError(f"prefix store truncated at {len(data)} bytes")
    magic, version, _, count = _STORE_HEADER.unpack_from(data)
    if magic != _STORE_MAGIC:
        raise ValueError(f"bad prefix-store magic {magic!r}")
    if version != 1:
        raise ValueError(f"prefix-store version {version} unsupported")
    off = _STORE_HEADER.size
    out: Dict[bytes, bytes] = {}
    for _ in range(count):
        key = data[off: off + 16]
        token_len, body_len = struct.unpack_from("<II", data, off + 16)
        off += 16 + 8
        out[key] = data[off: off + body_len]
        off += body_len
    if off != len(data):
        raise ValueError(
            f"prefix store carries {len(data) - off} trailing bytes")
    return out


def serve_prefix_store(path: str, port: int = 0,
                       max_requests: Optional[int] = None) -> None:
    """Serve a store file over TCP on localhost: prints ``PORT <n>`` to
    stdout (the parent reads it), accepts ONE connection, then answers
    K_FETCH(key) with K_RESP(packed chain | empty) until EOF (or
    ``max_requests``).  The loop touches no device: a server process
    only serves bytes, it never initialises an accelerator runtime."""
    store = load_prefix_store(path)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(1)
    print(f"PORT {srv.getsockname()[1]}", flush=True)
    conn, _ = srv.accept()
    served = 0
    try:
        while max_requests is None or served < max_requests:
            frame = recv_frame(conn)
            if frame is None:
                break
            try:
                kind, msg_id, src, dest, body = unpack_message(frame)
            except WireCorruption:
                continue  # client retries
            if kind != K_FETCH:
                continue
            chain = store.get(bytes(body), b"")
            resp = pack_message(K_RESP, msg_id, "store", src, chain)
            send_frame(conn, resp)
            served += 1
    finally:
        conn.close()
        srv.close()


class PrefixStoreClient:
    """Blocking fetch side of :func:`serve_prefix_store`: one TCP
    connection, request/response by msg_id, bounded retry on a corrupt
    response (the transit-integrity contract, client-side)."""

    def __init__(self, port: int, name: str = "client",
                 max_retries: int = 3) -> None:
        self.sock = socket.create_connection(("127.0.0.1", port))
        self.name = name
        self.max_retries = max_retries
        self._next_id = 0
        self.fetches = 0
        self.retries = 0
        self.bytes_total = 0

    def close(self) -> None:
        self.sock.close()

    def fetch(self, key: bytes) -> List[Tuple[np.ndarray, bytes]]:
        """The chain stored under ``key`` ([] when the store doesn't
        own it), as (cumulative tokens, payload) records in ancestor
        order."""
        last: Optional[Exception] = None
        for _ in range(self.max_retries):
            msg_id = self._next_id
            self._next_id += 1
            send_frame(self.sock, pack_message(
                K_FETCH, msg_id, self.name, "store", key))
            frame = recv_frame(self.sock)
            if frame is None:
                raise ConnectionError("prefix store hung up mid-fetch")
            try:
                kind, rid, src, dest, body = unpack_message(frame)
            except WireCorruption as e:
                last = e
                self.retries += 1
                continue
            if kind != K_RESP or rid != msg_id:
                last = ValueError(
                    f"unexpected store reply kind={kind} id={rid}")
                self.retries += 1
                continue
            self.fetches += 1
            self.bytes_total += len(frame)
            if not body:
                return []
            return unpack_prefix_blocks(body)
        raise WireCorruption(
            f"prefix store fetch failed after {self.max_retries} "
            f"attempts: {last}")
