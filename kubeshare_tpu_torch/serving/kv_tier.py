"""Host-RAM and disk KV block tiers under the radix prefix index, the
port's own copy of kubeshare_tpu/serving/kv_tier.py (the port imports
nothing of the JAX package).

The radix trie makes retired prompts reusable, but its capacity is
bounded by the device pool: when ``BlockAllocator.reserve`` drains the
idle-cached LRU pool, evicted prefixes are destroyed.  This module adds
the tiers below it: an evicted block's K/V rows are SERIALIZED into a
defined wire format and parked in a byte-budgeted host-RAM store
(:class:`HostTier`) instead of being dropped, and host-budget evictions
cascade into an mmap-backed disk arena (:class:`DiskTier`); the trie
node stays in the index marked HOST- or DISK-resident, so a later
prompt's admission walk still matches it and the engine PROMOTES the
payload back into a freshly reserved device block.

Three pieces, deliberately decoupled:

- the **wire format** (:func:`pack_block` / :func:`unpack_block`, and
  the chain container :func:`pack_chain` / :func:`unpack_chain`): one
  block's K and V slabs (all layers) plus its token-id run behind a
  versioned, magic-tagged header and a crc32 trailer.  The bytes equal
  the JAX package's for the same slab bits, so frames pass between the
  two packages.  bf16 slabs travel as their raw 2-byte words under the
  dtype name ``"bfloat16"`` (numpy has no bf16: the port maps the name
  to ``torch.bfloat16`` itself), and :func:`unpack_block` returns the
  slabs as CPU tensors;
- the **stores** (:class:`HostTier`, :class:`DiskTier`): budgeted,
  LRU-ordered, with pin sets so entries an in-progress admission is
  about to promote can never be evicted out from under it;
- the **policy** (:class:`TierPolicy`): the demote-vs-drop decision and
  the host-side victim order.  :class:`LRUTierPolicy` demotes everything
  and evicts coldest-first; :class:`QoSTierPolicy` rides the tenant
  registry — host entries charged to Guarantee tenants are protected
  from Opportunistic pressure.

The engine owns the glue (engine.py): demotion happens inside the
allocator's eviction callback (the device block is released and the
tenant's quota charge drops with it), promotion rides admission (a
normal charged reservation, the copy-in ONE captured ``upload``
program).  Streams are bit-exact with tiering off.
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
import zlib
from collections import OrderedDict
from typing import Callable, List, Optional, Set, Tuple

import numpy as np
import torch

# Wire format: magic + version first, so a receiver can reject foreign
# bytes loudly before trusting a single field.  v2 appends a crc32 trailer
# over everything before it: host RAM, a network hop, or a disk tier can
# all hand back rotted bytes, and a checksum failure must surface as a
# LOUD, typed error (:class:`WireCorruption`) the consumer can turn into
# a tier miss — never as silently corrupted K/V rows attended into a
# stream.
KV_WIRE_MAGIC = b"KVWB"
KV_WIRE_VERSION = 2
# Chain container (the disaggregated prefill/decode migration unit): a
# counted sequence of length-prefixed pack_block frames — one slot's
# whole block chain in one buffer.  Versioned separately from the block
# format: a chain receiver validates the envelope first, then each frame
# through unpack_block's own checks.
KV_CHAIN_MAGIC = b"KVCH"
KV_CHAIN_VERSION = 1
# magic, version, reserved, frame count
_CHAIN_HEADER = struct.Struct("<4sHHI")
_FRAME_LEN = struct.Struct("<I")
# magic, version, header_len, n_layers, kv_heads, block_size, head_dim,
# n_tokens, reserved, dtype NAME (ascii, NUL-padded).  The name, not a
# byte-order tag, so bfloat16 round-trips.  Slabs are always
# little-endian on the wire.
_HEADER = struct.Struct("<4sHHHHHHHH16s")
# v2 integrity trailer: crc32 of every byte before it (header, tokens,
# both slabs), little-endian u32 at the very end of the buffer.
_CRC = struct.Struct("<I")

# the slab dtypes the wire carries: name -> (torch dtype, the numpy dtype
# of its raw little-endian words)
_WIRE_DTYPES = {
    "float32": (torch.float32, np.dtype("<f4")),
    "float16": (torch.float16, np.dtype("<f2")),
    "float64": (torch.float64, np.dtype("<f8")),
    "bfloat16": (torch.bfloat16, np.dtype("<i2")),
}
_WIRE_NAMES = {torch_dtype: name
               for name, (torch_dtype, _) in _WIRE_DTYPES.items()}


class WireCorruption(ValueError):
    """Wire bytes whose integrity checksum does not match — a flipped
    bit anywhere in the buffer (header included) lands here, distinct
    from the honest-foreign-bytes :class:`ValueError` a wrong
    magic/version raises on an INTACT buffer.  Consumers (the engine's
    promotion path) catch exactly this type to demote corruption to a
    tier miss; anything else stays fatal."""


def slab_words(slab) -> Tuple[str, np.ndarray]:
    """(wire dtype name, the slab's raw little-endian words as a numpy
    array) of a CPU tensor or a numpy array: a bf16 tensor's words are
    int16, every other dtype its own numpy twin."""
    if isinstance(slab, torch.Tensor):
        name = _WIRE_NAMES.get(slab.dtype)
        if name is None:
            raise ValueError(f"slab dtype {slab.dtype} is not wire-encodable")
        if slab.device.type != "cpu":
            raise ValueError(
                f"slabs must lie on the CPU, got {slab.device} (the engine "
                f"reads device blocks to the host before packing)")
        words = slab.detach().contiguous()
        if slab.dtype == torch.bfloat16:
            words = words.view(torch.int16)
        return name, words.numpy()
    arr = np.asarray(slab)
    if arr.dtype.byteorder == ">":
        raise ValueError("big-endian slabs are not wire-encodable")
    if arr.dtype.name not in _WIRE_DTYPES:
        raise ValueError(f"slab dtype {arr.dtype} is not wire-encodable")
    return arr.dtype.name, arr


def wire_block_bytes(n_tokens: int, n_layers: int, kv_heads: int,
                     block_size: int, head_dim: int, itemsize: int) -> int:
    """Exact serialized size of one block — what a budget admission
    check needs WITHOUT materializing the payload."""
    return (_HEADER.size + 4 * n_tokens
            + 2 * n_layers * kv_heads * block_size * head_dim * itemsize
            + _CRC.size)


def pack_block(tokens, k_slab, v_slab) -> bytes:
    """Serialize one pool block: K/V slabs ``[n_layers, kv_heads,
    block_size, head_dim]`` (CPU tensors or numpy arrays) plus the token
    ids its filled rows hold (``len(tokens) <= block_size``; a partial
    leaf's stale tail rows ride along — promotion restores them and
    prefill overwrites them before any causal band can attend)."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    k_name, k_words = slab_words(k_slab)
    v_name, v_words = slab_words(v_slab)
    if k_words.shape != v_words.shape or k_name != v_name:
        raise ValueError(
            f"K/V slab mismatch: {tuple(k_words.shape)}/{k_name} vs "
            f"{tuple(v_words.shape)}/{v_name}")
    if k_words.ndim != 4:
        raise ValueError(
            f"slab must be [n_layers, kv_heads, block_size, head_dim], "
            f"got shape {tuple(k_words.shape)}")
    n_layers, kv_heads, block_size, head_dim = k_words.shape
    if not 0 < toks.size <= block_size:
        raise ValueError(
            f"{toks.size} tokens do not fit a {block_size}-row block")
    header = _HEADER.pack(
        KV_WIRE_MAGIC, KV_WIRE_VERSION, _HEADER.size, n_layers, kv_heads,
        block_size, head_dim, toks.size, 0,
        k_name.encode("ascii").ljust(16, b"\0"))
    body = b"".join([
        header, toks.tobytes(),
        np.ascontiguousarray(k_words).tobytes(),
        np.ascontiguousarray(v_words).tobytes()])
    return body + _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF)


def unpack_block(buf: bytes
                 ) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_block`: ``(tokens, k_slab, v_slab)``, the
    slabs CPU tensors of the wire's dtype.  Bit-identical round-trip;
    :class:`WireCorruption` on a checksum mismatch (checked FIRST — a
    flipped bit may land in the header, so no field is trusted before
    the crc passes), plain :class:`ValueError` on intact-but-foreign
    magic, a version this build does not speak, or an unknown dtype."""
    if len(buf) < _HEADER.size + _CRC.size:
        raise WireCorruption(f"wire block truncated at {len(buf)} bytes")
    (stored_crc,) = _CRC.unpack_from(buf, len(buf) - _CRC.size)
    if zlib.crc32(memoryview(buf)[:-_CRC.size]) & 0xFFFFFFFF != stored_crc:
        raise WireCorruption(
            f"wire block checksum mismatch over {len(buf)} bytes")
    (magic, version, header_len, n_layers, kv_heads, block_size,
     head_dim, n_tokens, _reserved, dt) = _HEADER.unpack_from(buf)
    if magic != KV_WIRE_MAGIC:
        raise ValueError(f"bad wire magic {magic!r}")
    if version != KV_WIRE_VERSION:
        raise ValueError(
            f"wire version {version} unsupported (this build speaks "
            f"{KV_WIRE_VERSION})")
    name = dt.rstrip(b"\0").decode("ascii")
    if name not in _WIRE_DTYPES:
        raise ValueError(f"wire dtype {name!r} unsupported")
    torch_dtype, words = _WIRE_DTYPES[name]
    expect = wire_block_bytes(n_tokens, n_layers, kv_heads, block_size,
                              head_dim, words.itemsize)
    if len(buf) != expect:
        raise ValueError(
            f"wire block is {len(buf)} bytes, header promises {expect}")
    off = header_len
    tokens = np.frombuffer(buf, np.int32, n_tokens, off).copy()
    off += 4 * n_tokens
    slab = (n_layers, kv_heads, block_size, head_dim)
    count = n_layers * kv_heads * block_size * head_dim
    k = np.frombuffer(buf, words, count, off).reshape(slab).copy()
    off += count * words.itemsize
    v = np.frombuffer(buf, words, count, off).reshape(slab).copy()
    return (tokens, torch.from_numpy(k).view(torch_dtype),
            torch.from_numpy(v).view(torch_dtype))


def pack_chain(frames) -> bytes:
    """Serialize a slot's whole block chain: a counted envelope of
    length-prefixed :func:`pack_block` frames, in table order (frame i
    holds rows ``i*block_size ..``) — the KV-migration unit of
    disaggregated serving."""
    frames = list(frames)
    if not frames:
        raise ValueError("a chain must carry at least one block frame")
    parts = [_CHAIN_HEADER.pack(KV_CHAIN_MAGIC, KV_CHAIN_VERSION, 0,
                                len(frames))]
    for frame in frames:
        if not isinstance(frame, (bytes, bytearray)):
            raise ValueError(
                f"chain frames must be bytes, got {type(frame).__name__}")
        parts.append(_FRAME_LEN.pack(len(frame)))
        parts.append(bytes(frame))
    return b"".join(parts)


def unpack_chain(buf: bytes) -> List[bytes]:
    """Inverse of :func:`pack_chain`: the block frames, in chain order.
    Frames come back as raw bytes — each still carries its own
    :func:`pack_block` header, so the receiver's :func:`unpack_block`
    re-validates every block independently."""
    if len(buf) < _CHAIN_HEADER.size:
        raise ValueError(f"wire chain truncated at {len(buf)} bytes")
    magic, version, _reserved, count = _CHAIN_HEADER.unpack_from(buf)
    if magic != KV_CHAIN_MAGIC:
        raise ValueError(f"bad chain magic {magic!r}")
    if version != KV_CHAIN_VERSION:
        raise ValueError(
            f"chain version {version} unsupported (this build speaks "
            f"{KV_CHAIN_VERSION})")
    if count < 1:
        raise ValueError("wire chain carries zero frames")
    frames: List[bytes] = []
    off = _CHAIN_HEADER.size
    for _ in range(count):
        if off + _FRAME_LEN.size > len(buf):
            raise ValueError(
                f"wire chain truncated mid-frame at {off} bytes")
        (n,) = _FRAME_LEN.unpack_from(buf, off)
        off += _FRAME_LEN.size
        if off + n > len(buf):
            raise ValueError(
                f"chain frame of {n} bytes overruns the {len(buf)}-byte "
                f"buffer at offset {off}")
        frames.append(buf[off: off + n])
        off += n
    if off != len(buf):
        raise ValueError(
            f"wire chain carries {len(buf) - off} trailing bytes")
    return frames


class HostEntry:
    """One demoted block living host-side: the serialized payload, the
    tenant its device HBM was charged to (the policy's protection key),
    the trie node still pointing at it, and the origin the payload
    arrived from (``"local"`` for this engine's own demotions and
    drain/salvage inheritance, ``"remote"`` for fabric promotions — the
    label the remote-vs-local tier-hit split reads back)."""

    __slots__ = ("key", "payload", "tenant", "node", "nbytes", "origin")

    def __init__(self, key: int, payload: bytes, tenant: Optional[str],
                 node, origin: str = "local") -> None:
        self.key = key
        self.payload = payload
        self.tenant = tenant
        self.node = node
        self.nbytes = len(payload)
        self.origin = origin


class TierPolicy:
    """Demote-vs-drop and host-victim-order decisions, pluggable.

    ``should_demote(tenant)`` gates a device eviction's spill (False =
    the block is destroyed, exactly the pre-tier behavior);
    ``select_victims(tier, need_bytes, incoming_tenant)`` names host
    entries to evict so ``need_bytes`` more can fit, oldest-preferred,
    or None when the policy refuses to make room (the incoming block is
    dropped instead).  Victims must skip pinned entries — the tier
    enforces this again, but a policy that names pinned keys just
    wastes its own eviction budget."""

    def should_demote(self, tenant: Optional[str]) -> bool:
        return True

    def select_victims(self, tier: "HostTier", need_bytes: int,
                       incoming_tenant: Optional[str]
                       ) -> Optional[List[int]]:
        raise NotImplementedError


class LRUTierPolicy(TierPolicy):
    """Demote everything; evict the coldest unpinned host entries
    first — the host twin of the device pool's idle-LRU drain."""

    def select_victims(self, tier, need_bytes, incoming_tenant):
        victims, freed = [], 0
        for key, entry in tier.iter_lru():
            if tier.is_pinned(key):
                continue
            victims.append(key)
            freed += entry.nbytes
            if freed >= need_bytes:
                return victims
        return victims if freed >= need_bytes else None


class QoSTierPolicy(TierPolicy):
    """Tenant-aware tier policy over the QoS registry: host bytes
    charged to Guarantee tenants are protected capital.

    - any tenant's blocks MAY demote (host residency is cheap);
    - an incoming block charged to an Opportunistic tenant (or to
      nobody) may only evict OTHER Opportunistic entries — if only
      Guarantee bytes could make room, the incoming block is dropped;
    - an incoming Guarantee block evicts Opportunistic entries first
      (LRU within the class), Guarantee entries only as a last resort —
      the paper's class asymmetry applied to the host tier, the same
      shape as ``reserve(evict_tenants_first=)`` on the device pool.
    """

    def __init__(self, registry) -> None:
        self.registry = registry

    def _is_guarantee(self, tenant: Optional[str]) -> bool:
        if tenant is None:
            return False
        try:
            return self.registry.get(tenant).is_guarantee
        except KeyError:
            return False

    def select_victims(self, tier, need_bytes, incoming_tenant):
        victims, chosen, freed = [], set(), 0
        passes = [False] if not self._is_guarantee(incoming_tenant) \
            else [False, True]
        for take_guarantee in passes:
            for key, entry in tier.iter_lru():
                if tier.is_pinned(key) or key in chosen:
                    continue
                if self._is_guarantee(entry.tenant) != take_guarantee:
                    continue
                victims.append(key)
                chosen.add(key)
                freed += entry.nbytes
                if freed >= need_bytes:
                    return victims
        return victims if freed >= need_bytes else None


class HostTier:
    """The byte-budgeted host-RAM block store.

    Engine-loop confined (no lock: every call happens on the engine's
    single scheduling thread, some under the allocator's lock).
    ``on_drop`` is the engine's detach hook: evicting a host entry must
    also remove its trie node (and the node's all-host subtree — a
    child's K/V is only valid on top of a cached prefix), which in turn
    forgets the subtree's entries here; the ``key in entries`` guards
    below make that reentrant cascade safe."""

    def __init__(self, budget_bytes: int, policy: TierPolicy,
                 on_drop: Optional[Callable[[HostEntry], None]] = None,
                 ledger_hook: Optional[Callable[[int, str], None]] = None
                 ) -> None:
        if budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be >= 1, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self.policy = policy
        self.on_drop = on_drop
        # byte-accounting tap, ``hook(nbytes, kind)`` with kind in
        # {"demote", "promote", "migrate"}: lets the serving plane
        # report tier and migration bytes to fractional-HBM accounting
        # (e.g. a token client's MEM verb).  None = no accounting.
        self.ledger_hook = ledger_hook
        # chaos seam (serving/chaos.py): a FaultClock consulted on
        # every put — it may return the payload with bytes flipped
        # (rot-at-rest; the v2 crc catches it at consumption).  None
        # outside chaos runs.
        self.fault_clock = None
        self._entries: "OrderedDict[int, HostEntry]" = OrderedDict()
        self._pinned: Set[int] = set()
        self._next_key = 0
        self.used_bytes = 0
        self.peak_bytes = 0
        # lifetime counters (the metrics plane's raw material)
        self.stored_blocks = 0    # entries ever demoted in
        self.evicted_blocks = 0   # entries evicted for host budget room
        self.refused_blocks = 0   # puts the policy/budget refused

    def __len__(self) -> int:
        return len(self._entries)

    def iter_lru(self):
        """Entries coldest-first (snapshot — eviction mutates)."""
        return list(self._entries.items())

    def is_pinned(self, key: int) -> bool:
        return key in self._pinned

    def pin(self, key: int) -> None:
        """Protect an entry an admission is about to promote: budget
        eviction (and the policy) must never take it mid-admission."""
        self._pinned.add(key)

    def unpin(self, key: int) -> None:
        self._pinned.discard(key)

    def put(self, payload: bytes, tenant: Optional[str], node,
            origin: str = "local") -> Optional[int]:
        """Store one serialized block; returns its handle, or None when
        the policy refuses / room cannot be made (caller drops the
        block — the pre-tier destroy path)."""
        if self.fault_clock is not None:
            payload = self.fault_clock.on_tier_put(payload)
        need = len(payload)
        if need > self.budget_bytes or not self.policy.should_demote(tenant):
            self.refused_blocks += 1
            return None
        while self.used_bytes + need > self.budget_bytes:
            shortfall = self.used_bytes + need - self.budget_bytes
            victims = self.policy.select_victims(self, shortfall, tenant)
            if not victims:
                self.refused_blocks += 1
                return None
            before = len(self._entries)
            for key in victims:
                entry = self._entries.get(key)
                if entry is None or key in self._pinned:
                    continue  # a cascade already took it / protected
                if self.on_drop is not None:
                    self.on_drop(entry)  # detaches the trie subtree,
                    # which forgets this entry (and any descendants)
                else:
                    self.forget(key)
            evicted = before - len(self._entries)
            if evicted <= 0:
                self.refused_blocks += 1
                return None  # no progress — everything left is pinned
            self.evicted_blocks += evicted
        key = self._next_key
        self._next_key += 1
        self._entries[key] = HostEntry(key, payload, tenant, node, origin)
        self.used_bytes += need
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)
        self.stored_blocks += 1
        self.meter(need, "demote")
        return key

    def bind_node(self, key: int, node) -> None:
        """Point an entry at its trie node after the fact — the
        cross-pool mirror path (serving/disagg.py) must insert the
        payload BEFORE it can attach the peer index's node."""
        self._entries[key].node = node

    def meter(self, nbytes: int, kind: str) -> None:
        """Report ``nbytes`` of tier/migration traffic to the ledger
        hook (no-op unhooked).  Callers that move payload bytes outside
        put/take — the engine's partial-match peek upload, the
        migrator's chain delivery — account through here."""
        if self.ledger_hook is not None:
            self.ledger_hook(nbytes, kind)

    def peek(self, key: int) -> HostEntry:
        """Read an entry WITHOUT removing it (a partial host match
        copies the payload into a private block; the entry keeps
        serving other matchers) — touches LRU recency."""
        entry = self._entries[key]
        self._entries.move_to_end(key)
        return entry

    def probe(self, key: int) -> Optional[HostEntry]:
        """Read an entry WITHOUT touching LRU recency, or None when the
        key is gone.  The fleet's drain snapshot (serving/fleet.py)
        walks a retiring replica's trie through here — reordering the
        victim tier's eviction queue mid-walk would make the handoff
        evict what it is about to copy."""
        return self._entries.get(key)

    def take(self, key: int) -> HostEntry:
        """Remove and return an entry — promotion moved its bytes back
        into a device block; the host copy is surplus."""
        entry = self._entries.pop(key)
        self.used_bytes -= entry.nbytes
        self._pinned.discard(key)
        self.meter(entry.nbytes, "promote")
        return entry

    def forget(self, key: int) -> bool:
        """Drop an entry without ceremony (its trie node was detached
        elsewhere).  Idempotent — cascades may race ahead."""
        entry = self._entries.pop(key, None)
        if entry is None:
            return False
        self.used_bytes -= entry.nbytes
        self._pinned.discard(key)
        return True


class DiskEntry:
    """One block parked on disk: where its payload lives in the arena
    file (offset/nbytes), plus the same tenant/node/origin bookkeeping
    a :class:`HostEntry` carries.  The payload itself is NOT held in
    RAM — that is the tier's whole point."""

    __slots__ = ("key", "offset", "nbytes", "tenant", "node", "origin")

    def __init__(self, key: int, offset: int, nbytes: int,
                 tenant: Optional[str], node, origin: str) -> None:
        self.key = key
        self.offset = offset
        self.nbytes = nbytes
        self.tenant = tenant
        self.node = node
        self.origin = origin


class DiskTier:
    """The mmap-backed, byte-budgeted block store BELOW host RAM.

    Demotion cascades HOST→DISK under host-budget pressure; promotion
    stages DISK→HOST and rides the existing ``paged_upload_block``
    admission path from there.  Storing serialized wire-v2 blocks is
    what makes a disk tier safe at all: every payload carries its own
    crc32, so rot on the platter (or a chaos-injected flip — the
    ``fault_clock.on_disk_read`` seam) surfaces as a LOUD
    :class:`WireCorruption` at validation, a tier miss re-prefilled
    cold, never wrong tokens.

    Layout: one arena file (a caller-named path, or an unlinked
    tempfile) grown by doubling and re-mmapped; payloads are placed
    first-fit from a free-hole list (adjacent holes coalesce on free)
    or appended at the high-water tail.  The byte budget counts PAYLOAD
    bytes, not file capacity — fragmentation can make the file larger
    than the budget, never the live bytes.  Engine-loop confined like
    :class:`HostTier`; plain LRU eviction (skipping pins) with the same
    ``on_drop`` detach-cascade contract and no-progress guard."""

    def __init__(self, budget_bytes: int, path: Optional[str] = None,
                 on_drop: Optional[Callable[[DiskEntry], None]] = None
                 ) -> None:
        if budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be >= 1, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self.on_drop = on_drop
        self.path = path
        # chaos seam (serving/chaos.py): consulted on every read — may
        # hand back the payload with a seeded bit flipped (platter
        # rot); the v2 crc catches it at validation.  None outside
        # chaos runs.
        self.fault_clock = None
        if path is None:
            fd, tmp = tempfile.mkstemp(prefix="kvdisk-", suffix=".arena")
            os.unlink(tmp)  # anonymous: the fd is the only handle
            self._fd = fd
        else:
            self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
            os.ftruncate(self._fd, 0)
        self._capacity = max(mmap.PAGESIZE, 1 << 16)
        os.ftruncate(self._fd, self._capacity)
        self._mm = mmap.mmap(self._fd, self._capacity)
        self._entries: "OrderedDict[int, DiskEntry]" = OrderedDict()
        self._pinned: Set[int] = set()
        self._holes: List[Tuple[int, int]] = []  # (offset, size), sorted
        self._tail = 0
        self._next_key = 0
        self.used_bytes = 0
        self.peak_bytes = 0
        # lifetime counters (the disk-gauge metric families' raw
        # material); corrupt_reads is bumped by the CONSUMER when a
        # disk payload fails wire validation — the tier hands back
        # bytes, the engine owns the crc verdict.
        self.stored_blocks = 0
        self.promoted_blocks = 0
        self.evicted_blocks = 0
        self.refused_blocks = 0
        self.corrupt_reads = 0

    def __len__(self) -> int:
        return len(self._entries)

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self) -> None:  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def iter_lru(self):
        """Entries coldest-first (snapshot — eviction mutates)."""
        return list(self._entries.items())

    def is_pinned(self, key: int) -> bool:
        return key in self._pinned

    def pin(self, key: int) -> None:
        self._pinned.add(key)

    def unpin(self, key: int) -> None:
        self._pinned.discard(key)

    def _grow(self, need: int) -> None:
        cap = self._capacity
        while cap < self._tail + need:
            cap *= 2
        os.ftruncate(self._fd, cap)
        self._mm.close()
        self._mm = mmap.mmap(self._fd, cap)
        self._capacity = cap

    def _place(self, nbytes: int) -> int:
        for i, (off, size) in enumerate(self._holes):
            if size >= nbytes:  # first fit; remainder stays a hole
                if size > nbytes:
                    self._holes[i] = (off + nbytes, size - nbytes)
                else:
                    del self._holes[i]
                return off
        if self._tail + nbytes > self._capacity:
            self._grow(nbytes)
        off = self._tail
        self._tail += nbytes
        return off

    def _free(self, offset: int, nbytes: int) -> None:
        # insert sorted, coalesce with both neighbors
        holes = self._holes
        lo, hi = 0, len(holes)
        while lo < hi:
            mid = (lo + hi) // 2
            if holes[mid][0] < offset:
                lo = mid + 1
            else:
                hi = mid
        holes.insert(lo, (offset, nbytes))
        if lo + 1 < len(holes) and \
                holes[lo][0] + holes[lo][1] == holes[lo + 1][0]:
            holes[lo] = (holes[lo][0], holes[lo][1] + holes[lo + 1][1])
            del holes[lo + 1]
        if lo > 0 and holes[lo - 1][0] + holes[lo - 1][1] == holes[lo][0]:
            holes[lo - 1] = (holes[lo - 1][0],
                             holes[lo - 1][1] + holes[lo][1])
            del holes[lo]
        # holes ending at the tail shrink the high-water mark back
        if holes and holes[-1][0] + holes[-1][1] == self._tail:
            self._tail = holes[-1][0]
            del holes[-1]

    def put(self, payload: bytes, tenant: Optional[str], node,
            origin: str = "local") -> Optional[int]:
        """Park one serialized block on disk; returns its handle, or
        None when room cannot be made (the block is destroyed — the
        pre-disk-tier drop path)."""
        need = len(payload)
        if need > self.budget_bytes:
            self.refused_blocks += 1
            return None
        while self.used_bytes + need > self.budget_bytes:
            before = len(self._entries)
            for key, entry in self.iter_lru():
                if key in self._pinned:
                    continue
                if self.on_drop is not None:
                    self.on_drop(entry)  # detach cascade forgets it
                else:
                    self.forget(key)
                break
            evicted = before - len(self._entries)
            if evicted <= 0:
                self.refused_blocks += 1
                return None  # no progress — everything left is pinned
            self.evicted_blocks += evicted
        offset = self._place(need)
        self._mm[offset: offset + need] = payload
        key = self._next_key
        self._next_key += 1
        self._entries[key] = DiskEntry(key, offset, need, tenant, node,
                                       origin)
        self.used_bytes += need
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)
        self.stored_blocks += 1
        return key

    def bind_node(self, key: int, node) -> None:
        self._entries[key].node = node

    def probe(self, key: int) -> Optional[DiskEntry]:
        """Entry metadata without payload I/O or LRU side effects."""
        return self._entries.get(key)

    def _payload(self, entry: DiskEntry) -> bytes:
        payload = bytes(self._mm[entry.offset: entry.offset + entry.nbytes])
        if self.fault_clock is not None:
            payload = self.fault_clock.on_disk_read(payload)
        return payload

    def read(self, key: int) -> bytes:
        """Payload bytes WITHOUT removing the entry — touches LRU
        recency; the chaos read seam applies (validate the crc before
        trusting a byte)."""
        entry = self._entries[key]
        self._entries.move_to_end(key)
        return self._payload(entry)

    def take(self, key: int) -> bytes:
        """Remove the entry and return its payload — DISK→HOST staging
        moved the bytes up a tier; the disk copy is surplus."""
        entry = self._entries.pop(key)
        payload = self._payload(entry)
        self.used_bytes -= entry.nbytes
        self._pinned.discard(key)
        self._free(entry.offset, entry.nbytes)
        self.promoted_blocks += 1
        return payload

    def forget(self, key: int) -> bool:
        """Drop an entry without reading it (its trie node was
        detached elsewhere).  Idempotent."""
        entry = self._entries.pop(key, None)
        if entry is None:
            return False
        self.used_bytes -= entry.nbytes
        self._pinned.discard(key)
        self._free(entry.offset, entry.nbytes)
        return True


def adopt_into(tier: HostTier, index, tokens, payload: bytes,
               tenant: Optional[str], origin: str = "local"
               ) -> Optional[int]:
    """THE host-tier adoption entry point — every path that moves a
    foreign serialized block under a live trie (a retiree's drain
    inheritance, a crashed replica's salvage, the disagg cross-pool
    mirror, a fabric remote promotion) goes through here, so the
    put→adopt→bind/forget bookkeeping cannot diverge between them.

    Stores ``payload`` in ``tier``, grafts a host-resident node for
    ``tokens`` (the CUMULATIVE path from the root) into ``index`` via
    :meth:`PrefixIndex.adopt_host`, and binds entry↔node.  Returns the
    tier key on success; None (with the tier entry rolled back) when
    the tier refuses the bytes or the index declines the graft — the
    caller loses nothing but the opportunity."""
    key = tier.put(payload, tenant, None, origin=origin)
    if key is None:
        return None
    node = index.adopt_host(tokens, key)
    if node is None:
        tier.forget(key)
        return None
    tier.bind_node(key, node)
    return key
