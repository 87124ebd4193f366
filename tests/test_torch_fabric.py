"""Port parity: kubeshare_tpu_torch.serving.fabric against the JAX
package's fabric on the CPU.

The wire bytes of the envelope, the prefix-block and chain bodies and a
greedy ticket equal JAX's for the same inputs (f32 and bf16 slabs), and
each package's unpack inverts the other's; the endpoints of both
packages, driven through one send/tick/poll script, deliver, ack, dedup,
redeliver and expire alike, with and without a seeded fault plan; a chain
crosses a real socketpair bit-identical; the directory behaves as JAX's;
and a prefix store exported from the port's engine is served over TCP
and fetched back.  These are the port's cases of JAX's TestFabric and
TestFabricChaos, less the fleet's."""

import contextlib
import io
import socket
import struct
import threading
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubeshare_tpu.serving.chaos as jax_chaos
import kubeshare_tpu.serving.fabric as jax_fabric
import kubeshare_tpu.serving.kv_tier as jax_tier
import kubeshare_tpu_torch.serving.chaos as chaos
import kubeshare_tpu_torch.serving.fabric as fabric
import kubeshare_tpu_torch.serving.kv_tier as tier
from kubeshare_tpu_torch.models.transformer import (TransformerConfig,
                                                    transformer_init)
from kubeshare_tpu_torch.serving import EngineConfig, Request, ServingEngine

torch.set_num_threads(1)


def _slabs(rng, dtype):
    """One block's K and V slabs in each package's form: (numpy for JAX,
    a CPU tensor for the port) with the same bits."""
    k = rng.standard_normal((2, 2, 4, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 4, 8)).astype(np.float32)
    if dtype == "float32":
        return (k, v), (torch.from_numpy(k), torch.from_numpy(v))
    jk, jv = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (k, v))
    return (jk, jv), tuple(torch.from_numpy(x.view(np.int16).copy())
                           .view(torch.bfloat16) for x in (jk, jv))


def _items(dtype):
    """A cumulative two-record prefix chain in each package's form."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 64, 8).astype(np.int32)
    jax_items, port_items = [], []
    for i in range(2):
        (jk, jv), (tk, tv) = _slabs(rng, dtype)
        run = toks[4 * i: 4 * (i + 1)]
        jax_items.append((toks[:4 * (i + 1)], jax_tier.pack_block(run, jk, jv)))
        port_items.append((toks[:4 * (i + 1)], tier.pack_block(run, tk, tv)))
    return jax_items, port_items


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bodies_and_envelope_bytes_equal_jax(dtype):
    jax_items, port_items = _items(dtype)
    for (jt, jp), (pt, pp) in zip(jax_items, port_items):
        assert np.array_equal(jt, pt) and jp == pp
    blocks = fabric.pack_prefix_blocks(port_items)
    assert blocks == jax_fabric.pack_prefix_blocks(jax_items)
    body = fabric.pack_chain_msg("tenant-a", port_items)
    assert body == jax_fabric.pack_chain_msg("tenant-a", jax_items)
    frame = fabric.pack_message(fabric.K_CHAIN, 42, "alpha", "beta", body)
    assert frame == jax_fabric.pack_message(jax_fabric.K_CHAIN, 42, "alpha",
                                            "beta", body)
    # each package's unpack inverts the other's
    for unpack in (fabric.unpack_message, jax_fabric.unpack_message):
        assert unpack(frame) == (fabric.K_CHAIN, 42, "alpha", "beta", body)
    for unpack in (fabric.unpack_chain_msg, jax_fabric.unpack_chain_msg):
        tenant, got = unpack(body)
        assert tenant == "tenant-a"
        assert [(t.tolist(), p) for t, p in got] == [
            (t.tolist(), p) for t, p in port_items]
    # the port unpacks JAX's payload to the bits it packs again
    run, k, v = tier.unpack_block(
        jax_fabric.unpack_prefix_blocks(blocks)[1][1])
    assert k.dtype == getattr(torch, dtype)
    assert tier.pack_block(run, k, v) == port_items[1][1]


def test_greedy_ticket_bytes_equal_jax_and_seeds_ride_as_words():
    prompt = np.arange(7, dtype=np.int32)
    hint = np.asarray([3, 1], np.int32)
    args = ("rid-1", "tenant-b", prompt, 11, 5, 0.0)
    tail = (b"\x00wire\xff", [11, 3], hint, 0.25)
    # a greedy stream: the port's empty seed schedule is JAX's empty keys
    port = fabric.pack_ticket(*args, fabric.seeds_to_keys(
        np.zeros((0,), np.int64)), *tail, last_token_at=123.5)
    want = jax_fabric.pack_ticket(*args, np.zeros((0, 2), np.uint32), *tail,
                                  last_token_at=123.5)
    assert port == want
    for unpack in (fabric.unpack_ticket, jax_fabric.unpack_ticket):
        d = unpack(port)
        assert (d["rid"], d["tenant"], d["first_token"], d["max_new"]) == (
            "rid-1", "tenant-b", 11, 5)
        assert d["step_keys"].size == 0 and d["last_token_at"] == 123.5
        assert d["emitted_prefix"] == [11, 3] and list(d["hint"]) == [3, 1]
    # a sampled stream's int64 seeds: two uint32 words each, low first
    seeds = np.asarray([1, -2, (1 << 40) + 5], np.int64)
    keys = fabric.seeds_to_keys(seeds)
    assert keys.tolist() == [[1, 0], [0xFFFFFFFE, 0xFFFFFFFF], [5, 256]]
    body = fabric.pack_ticket("r", "t", prompt, 0, 4, 0.8, keys, b"", [],
                              np.asarray([], np.int32), 0.0)
    assert body == jax_fabric.pack_ticket("r", "t", prompt, 0, 4, 0.8, keys,
                                          b"", [], np.asarray([], np.int32),
                                          0.0)
    d = fabric.unpack_ticket(body)
    assert np.array_equal(fabric.keys_to_seeds(d["step_keys"]), seeds)
    assert d["last_token_at"] is None


def _reseal(b: bytes) -> bytes:
    return b[:-4] + struct.pack("<I", zlib.crc32(b[:-4]) & 0xFFFFFFFF)


@pytest.mark.parametrize("at", [0, 3, 11, 40, -1],
                         ids=["magic", "version", "msg_id", "body", "crc"])
def test_a_flipped_bit_anywhere_is_wire_corruption(at):
    frame = fabric.pack_message(fabric.K_CHAIN, 42, "alpha", "beta",
                                b"\x01payload bytes\xff" * 9)
    bad = bytearray(frame)
    bad[at] ^= 0x10
    with pytest.raises(tier.WireCorruption):
        fabric.unpack_message(bytes(bad))
    with pytest.raises(jax_tier.WireCorruption):
        jax_fabric.unpack_message(bytes(bad))


def test_truncated_and_foreign_envelopes_raise_like_jax():
    frame = fabric.pack_message(fabric.K_TICKET, 1, "a", "b", b"body")
    with pytest.raises(tier.WireCorruption, match="truncated"):
        fabric.unpack_message(frame[:8])
    for bad, match in ((_reseal(b"XXXX" + frame[4:]), "magic"),
                       (_reseal(frame[:4] + b"\x63\x00" + frame[6:]),
                        "version")):
        with pytest.raises(ValueError, match=match) as got:
            fabric.unpack_message(bad)
        with pytest.raises(ValueError) as want:
            jax_fabric.unpack_message(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="over 16 bytes"):
        fabric.pack_message(fabric.K_CHAIN, 0, "x" * 17, "beta", b"")


def _plan(mod):
    plan = mod.FaultPlan(seed=31)
    for n in (0, 3, 9, 14):
        plan.drop_fabric(n)
    plan.duplicate_fabric(5).reorder_fabric(7).corrupt_fabric(11)
    # a partition late in the script: everything dropped, TTLs run out
    for n in range(40, 70):
        plan.drop_fabric(n)
    return plan


def _endpoint_script(mod, chaos_mod, faults):
    """One seeded send/tick/poll script over a loopback transport; the
    log of everything both endpoints surfaced, then their counters."""
    tr = mod.LoopbackTransport()
    clock = chaos_mod.FaultClock(_plan(chaos_mod)) if faults else None
    tr.fault_clock = clock
    a = mod.FabricEndpoint("a", tr, ttl_ticks=6, backoff_base=1,
                           backoff_cap=4)
    b = mod.FabricEndpoint("b", tr, ttl_ticks=6, backoff_base=1,
                           backoff_cap=4)
    rng = np.random.default_rng(5)
    log = []
    for i in range(60):
        op = int(rng.integers(0, 4))
        if op == 0:
            log.append(("send", a.send("b", mod.K_CHAIN, bytes([i]) * 9)))
        elif op == 1:
            log.append(("send", b.send("a", mod.K_TICKET, bytes([i]) * 5)))
        elif op == 2:
            log.append(("poll", b.poll(), a.poll()))
        else:
            a.tick()
            b.tick()
            log.append(("expired", a.take_expired(), b.take_expired()))
        log.append(("delivered", a.take_delivered(), b.take_delivered()))
    for _ in range(8):  # drain: let every message land or expire
        log.append(("poll", b.poll(), a.poll()))
        a.tick()
        b.tick()
        log.append(("expired", a.take_expired(), b.take_expired()))
    counters = [(ep.messages, ep.bytes_total, ep.redeliveries, ep.inflight)
                for ep in (a, b)]
    return log, counters, (clock.events if clock else None)


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "fault_plan"])
def test_endpoint_sequence_equals_jax(faults):
    got = _endpoint_script(fabric, chaos, faults)
    want = _endpoint_script(jax_fabric, jax_chaos, faults)
    assert got == want
    log, counters, events = got
    messages = counters[0][0]
    assert messages[("chain", "sent")] > 0
    if faults:
        kinds = {e[0] for e in events}
        assert kinds == {"drop_fabric", "duplicate_fabric", "reorder_fabric",
                         "corrupt_fabric"}
        assert any(ep_messages.get(("chain", "expired"), 0)
                   + ep_messages.get(("ticket", "expired"), 0)
                   for ep_messages, _, _, _ in counters)
        assert sum(r for _, _, r, _ in counters) > 0
    for ep_messages, _, _, inflight in counters:
        assert inflight == 0
        for kind in ("chain", "ticket"):
            assert (ep_messages.get((kind, "delivered"), 0)
                    + ep_messages.get((kind, "expired"), 0)
                    == ep_messages.get((kind, "sent"), 0))


def _flaky_script(mod):
    """JAX's ack/dedup/redelivery/TTL test, run through ``mod``."""
    class Flaky(mod.LoopbackTransport):
        def __init__(self):
            super().__init__()
            self.drop_next = 0

        def send(self, dest, frame):
            if self.drop_next > 0:
                self.drop_next -= 1
                return
            super().send(dest, frame)

    tr = Flaky()
    a = mod.FabricEndpoint("a", tr, ttl_ticks=8)
    b = mod.FabricEndpoint("b", tr, ttl_ticks=8)
    log = []
    tr.drop_next = 1
    log.append(a.send("b", mod.K_CHAIN, b"hello"))
    log += [b.poll(), a.inflight]
    a.tick()
    log += [b.poll(), a.poll(), a.take_delivered(), a.redeliveries]
    log.append(a.send("b", mod.K_CHAIN, b"again"))
    tr.drop_next = 1
    log += [b.poll(), a.poll(), a.inflight]
    a.tick()
    log += [b.poll(), dict(b.messages), a.poll(), a.take_delivered()]
    tr.drop_next = 10 ** 6
    log.append(a.send("b", mod.K_CHAIN, b"doomed"))
    for _ in range(8):
        a.tick()
    log += [a.inflight, a.take_expired(), dict(a.messages)]
    return log


def test_ack_dedup_redelivery_and_ttl_equal_jax():
    got = _flaky_script(fabric)
    assert got == _flaky_script(jax_fabric)
    messages = got[-1]
    assert messages[("chain", "delivered")] == 2
    assert messages[("chain", "expired")] == 1
    assert got[-2] == [("b", fabric.K_CHAIN, 2, b"doomed")]


@pytest.mark.parametrize("bad_at", [None, "middle"], ids=["clean", "flipped"])
def test_chain_crosses_a_socket_pair_bit_identical(bad_at):
    _, items = _items("bfloat16")
    frame = fabric.pack_message(fabric.K_CHAIN, 0, "sender", "receiver",
                                fabric.pack_chain_msg("tenant-a", items))
    a, b = fabric.SocketTransport.pair()
    try:
        if bad_at is not None:
            bad = bytearray(frame)
            bad[len(bad) // 2] ^= 0x01
            a.send("receiver", bytes(bad))
            (got,) = b.poll("receiver")
            with pytest.raises(tier.WireCorruption):
                fabric.unpack_message(got)
            return
        a.send("receiver", frame)
        (got,) = b.poll("receiver")
        assert got == frame
        tenant, got_items = fabric.unpack_chain_msg(
            fabric.unpack_message(got)[4])
        assert tenant == "tenant-a"
        for (toks0, pay0), (toks1, pay1) in zip(items, got_items):
            assert np.array_equal(toks0, toks1) and pay0 == pay1
            _, k0, v0 = tier.unpack_block(pay0)
            _, k1, v1 = tier.unpack_block(pay1)
            assert k1.dtype == torch.bfloat16
            assert torch.equal(k0.view(torch.int16), k1.view(torch.int16))
            assert torch.equal(v0.view(torch.int16), v1.view(torch.int16))
        assert b.poll("receiver") == []  # nothing more on the wire
    finally:
        a.close()
        b.close()


def _directory_script(mod):
    d = mod.FabricDirectory()
    k1 = mod.prefix_fabric_key(np.arange(12))
    k2 = mod.prefix_fabric_key(np.arange(8))
    d.publish(k1, "r0", token_len=12)
    d.publish(k1, "r1")
    d.publish(k2, "r1", token_len=8)
    log = [len(d), d.lookup(k1), d.lookup(k2), d.token_len(k1)]
    d.withdraw(k1, "r0")
    log += [d.lookup(k1), d.token_len(k1)]
    d.withdraw_owner("r1")
    log += [len(d), d.lookup(k1), d.token_len(k2), d.lookup(b"\0" * 16)]
    d.withdraw(k1, "nobody")
    return log


def test_directory_and_prefix_keys_equal_jax():
    assert fabric.prefix_fabric_key(np.arange(12)) == \
        jax_fabric.prefix_fabric_key(np.arange(12))
    got = _directory_script(fabric)
    assert got == _directory_script(jax_fabric)
    assert got[:4] == [2, ["r0", "r1"], ["r1"], 12]
    assert got[-4:-1] == [0, [], None]


def test_prefix_store_export_serve_fetch(tmp_path):
    """Export the port engine's tiered trie, serve the store over TCP on
    127.0.0.1 (port 0), fetch the longest chain back byte identical; JAX's
    loader reads the port's store file alike."""
    config = TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq_len=64,
                               attention="reference", dtype=torch.float32)
    params = transformer_init(config, torch.Generator().manual_seed(0),
                              device="cpu")
    warm = ServingEngine(params, config, EngineConfig(
        num_slots=1, block_size=4, num_blocks=13, max_request_len=32,
        prefill_chunk=8, host_tier_bytes=1 << 20), device="cpu")
    rng = np.random.default_rng(11)
    for rid, prompt in (("r0", rng.integers(0, 64, 13)),
                        ("f1", rng.integers(0, 64, 29)),
                        ("f2", rng.integers(0, 64, 29))):
        warm.submit(Request(rid, prompt, 3))
        warm.run()
        warm.pop_finished()
    assert warm.tier_demoted_blocks > 0

    def payload_of(node):
        if node.host_key is not None:
            entry = warm.host_tier.probe(node.host_key)
            return None if entry is None else entry.payload
        if node.block is not None and node.block >= 0:
            return warm._read_block_payload(node)
        return None

    path = str(tmp_path / "prefixes.kvps")
    manifest = fabric.export_prefix_store(warm.prefix_index, payload_of, path)
    assert len(manifest) > 0
    store = fabric.load_prefix_store(path)
    assert set(store) == {k for k, _ in manifest}
    assert jax_fabric.load_prefix_store(path) == store
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        server = threading.Thread(target=fabric.serve_prefix_store,
                                  args=(path,), daemon=True)
        server.start()
        deadline = time.time() + 10
        while "PORT" not in buf.getvalue():
            assert time.time() < deadline, "store never bound"
            time.sleep(0.01)
    port = int(buf.getvalue().split()[1])
    key, _ = max(manifest, key=lambda kv: kv[1])
    client = fabric.PrefixStoreClient(port)
    try:
        chain = client.fetch(key)
        want = fabric.unpack_prefix_blocks(store[key])
        assert [(t.tolist(), p) for t, p in chain] == [
            (t.tolist(), p) for t, p in want]
        assert client.fetch(b"\x00" * 16) == []  # unknown key: empty
        assert client.fetches == 2 and client.retries == 0
    finally:
        client.close()
    server.join(timeout=10)
    assert not server.is_alive()
    with socket.socket() as probe:  # the server closed its listener
        assert probe.connect_ex(("127.0.0.1", port)) != 0
