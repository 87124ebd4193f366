#!/usr/bin/env python3
"""Tensor-parallel serving on a CUDA card: one engine over a tp = 4
group with a head-sharded paged KV pool, under a tokend guard; the
PyTorch twin of ``examples/serve_sharded.py``.

    python3 serve_sharded_torch.py                   # the example's model
    python3 serve_sharded_torch.py --small --device cpu   # tests

The example's model (d 256, 4 layers, 8 query heads over 4 KV heads,
f32, rope) served by a ``ServingEngine`` with
``EngineConfig.mesh_spec = MeshSpec(tp=4)``: Megatron-split parameters
with no partial sums, the pool split on the KV-head axis (one KV head a
shard), and ``long_context_threshold`` 32, so every full 32-token
prefill chunk goes through the Ulysses re-shard.  The group is
``[cuda:0] * 4`` on the card (every dispatch one CUDA graph on the
card's stream) and ``[cpu] * 4`` under ``--device cpu``; the JAX example
instead forces four host devices through ``XLA_FLAGS``.  The engine is
gated through one cell of the real ``tpushare-tokend``.

The traffic is the example's, from ``np.random.default_rng(7)``: 3
ingest prompts, 5 streamers and one sampled stream (temperature 0.8, its
generator seeded 42).  The checks are the example's: no graph captured
after warm-up, and a final replay through the single-device engine whose
every stream, greedy and sampled, equals the sharded engine's token for
token.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

TP = 4
CELL = "demo/sharded-cell"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--small", action="store_true",
                        help="a narrow model a CPU test serves in seconds")
    parser.add_argument("--device", default=None, choices=("cpu",),
                        help="run on the CPU (tests); the default is the "
                             "CUDA card")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    from kubeshare_tpu_torch import resolve_device
    from kubeshare_tpu_torch.isolation import ExecutionGuard, TokenClient
    from kubeshare_tpu_torch.models.transformer import (TransformerConfig,
                                                        transformer_init)
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec
    from kubeshare_tpu_torch.runtime import cell_tokend
    from kubeshare_tpu_torch.serving import (EngineConfig, Request,
                                             ServingEngine, plan_sharding,
                                             serving_sharding_rules)
    from kubeshare_tpu_torch.utils.promtext import encode_families

    device = resolve_device(args.device)

    print("=== 1. model + sharding plan ===")
    width = (dict(d_model=64, n_heads=8, n_kv_heads=4, d_ff=128)
             if args.small else
             dict(d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024))
    config = TransformerConfig(
        n_layers=4, vocab_size=8000, max_seq_len=256, dtype=torch.float32,
        positional="rope", attention="reference", **width)
    params = transformer_init(config, torch.Generator().manual_seed(0),
                              device=device)
    decision = plan_sharding(config, TP)
    print(f"tp={TP}: attention "
          f"{'HEAD-SHARDED' if decision.attn_sharded else 'replicated'} "
          f"({config.n_kv_heads} KV heads -> "
          f"{config.n_kv_heads // TP if decision.attn_sharded else config.n_kv_heads}"
          f" per device), mlp "
          f"{'column/row-split' if decision.mlp_sharded else 'replicated'}, "
          f"lm_head {'sharded' if decision.lm_head_sharded else 'replicated'}")
    for needle, spec in sorted(serving_sharding_rules(decision).items()):
        print(f"  rule: ...{needle!r:24s} -> {spec}")

    rng = np.random.default_rng(7)
    specs = []
    for i in range(3):   # multi-chunk ingest prompts: their full
        specs.append(dict(  # 32-token chunks route through Ulysses
            rid=f"ingest{i}",
            prompt=rng.integers(0, config.vocab_size,
                                int(rng.integers(80, 129))),
            max_new_tokens=int(rng.integers(6, 13))))
    for i in range(5):   # short-prompt long-decode streamers
        specs.append(dict(
            rid=f"stream{i}",
            prompt=rng.integers(0, config.vocab_size,
                                int(rng.integers(10, 25))),
            max_new_tokens=int(rng.integers(24, 41))))
    # a sampled stream: its seed schedule must survive the mesh
    specs.append(dict(rid="sampled",
                      prompt=rng.integers(0, config.vocab_size, 18),
                      max_new_tokens=24, temperature=0.8))

    def request(spec):
        # a fresh generator a run: the engine draws the seed schedule
        rng_ = (torch.Generator().manual_seed(42)
                if spec.get("temperature") else None)
        return Request(**spec, rng=rng_)

    geometry = dict(num_slots=4, block_size=16, num_blocks=49,
                    max_request_len=192, prefill_chunk=32, decode_span=4)

    print("=== 2. runtime: one tokend cell gating the sharded engine ===")
    with cell_tokend([(CELL, "1.0", "1.0")], min_quota_ms=16.0) as port:
        client = TokenClient("127.0.0.1", port, CELL)
        engine = ServingEngine(
            params, config,
            EngineConfig(mesh_spec=MeshSpec(dp=1, tp=TP, sp=1),
                         long_context_threshold=32, **geometry),
            guard=ExecutionGuard(client=client, from_env=False),
            device=device, mesh_devices=[device] * TP)
        print(f"sharded context: {engine._sharded.describe()}")

        print("=== 3. capture every shape once over the group ===")
        engine.warmup()
        warm_counts = engine.capture_counts()
        print(f"captured programs: {dict(sorted(warm_counts.items()))}: "
              f"each dispatch one program over the {TP} shards")

        print("=== 4. traffic: ingest prompts + streamers, greedy and "
              "sampled ===")
        start = time.monotonic()
        for spec in specs:
            engine.submit(request(spec))
        results = engine.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.monotonic() - start
        total = 0
        for spec in specs:
            r = results[spec["rid"]]
            total += len(r.tokens)
            print(f"{spec['rid']:8s}: prompt {r.prompt_len:3d} -> "
                  f"{len(r.tokens):2d} tokens, "
                  f"ttft {1e3 * r.ttft:6.1f} ms, "
                  f"done +{1e3 * (r.finished_at - r.submitted_at):6.1f} ms")
        recaptures = sum(engine.capture_counts().values()) - sum(
            warm_counts.values())
        print(f"aggregate: {total} tokens in {elapsed:.2f} s "
              f"({total / elapsed:.0f} tok/s); captures after warmup: "
              f"{recaptures}")
        if recaptures:
            raise RuntimeError(
                f"{recaptures} graphs captured after warmup: a "
                f"static-shape leak in a sharded step")

        print("=== 5. per-device block occupancy ===")
        in_use = engine.allocator.blocks_in_use
        cached = engine.allocator.cached_idle_blocks
        for i, shard in enumerate(engine.pool.k.shards):
            n_layers, blocks, local_heads, block_size, head_dim = shard.shape
            per_block = (2 * n_layers * local_heads * block_size
                         * head_dim * shard.element_size())
            print(f"  shard {i} ({shard.device}): {local_heads} KV "
                  f"head(s) of every block; {in_use} in use + "
                  f"{cached} cached of {blocks - 1} "
                  f"({in_use * per_block >> 10} KiB in use, "
                  f"{per_block} B/block locally: 1/{TP} of the "
                  f"single-device row)")

        print("=== 6. collective-bytes estimate (the scrape surface) ===")
        for kind, nbytes in sorted(engine.collective_bytes.items()):
            print(f"  {kind:14s}: {nbytes >> 10:8d} KiB in all")
        text = encode_families(engine.collect_metrics())
        for line in text.splitlines():
            if line.startswith("kubeshare_serving_collective_bytes_total"):
                print(f"  scrape: {line}")

        print("=== 7. the group changes nothing: single-device replay ===")
        mono = ServingEngine(params, config, EngineConfig(**geometry),
                             device=device)
        mono.warmup()
        for spec in specs:
            mono.submit(request(spec))
        mono_results = mono.run()
        diverged = [spec["rid"] for spec in specs
                    if list(results[spec["rid"]].tokens)
                    != list(mono_results[spec["rid"]].tokens)]
        if diverged:
            raise RuntimeError(
                f"streams diverged vs the single-device engine: {diverged}")
        print(f"all {len(specs)} streams bit-identical to the "
              f"single-device engine (greedy and sampled: no collective "
              f"carries a partial sum)")

        probe = TokenClient("127.0.0.1", port, "probe")
        stat = json.loads(probe.stat())
        probe.close()
        client.close()
        p = stat["pods"][CELL]
        print(f"tokend accounting [{CELL}]: "
              f"grants={p['grants']} charged={p['charged_total_ms']:.0f} ms")
    print("sharded demo complete")
    return {
        "device": str(device), "tokens": total, "seconds": elapsed,
        "tokens_per_s": total / elapsed,
        "captures_after_warmup": recaptures,
        "collective_bytes": dict(engine.collective_bytes),
        "streams_equal_single_device": len(specs) - len(diverged),
        "requests": len(specs), "grants": p["grants"],
        "charged_ms": p["charged_total_ms"],
        "streams": {spec["rid"]: list(results[spec["rid"]].tokens)
                    for spec in specs},
    }


if __name__ == "__main__":
    main()
