#!/usr/bin/env python3
"""Disaggregated serving on a CUDA card: prefill and decode pools as two
token-gated fractional cells, KV chains migrating between them; the
PyTorch twin of ``examples/serve_disagg.py``.

    python3 serve_disagg_torch.py                    # the example's model
    python3 serve_disagg_torch.py --small --device cpu    # tests

The example's model (d 256, 4 layers, 8 query heads over 2 KV heads,
f32, rope) and split: a ``DisaggRouter`` over a prefill pool (2 slots,
16 blocks of 16) and a decode pool (4 slots, 32 blocks), each gated
through its own cell of one real ``tpushare-tokend`` (0.5 share each),
with a 1 MiB shared tier and a ``ledger_hook`` that charges every
migrated chain's bytes to the decode cell's memory ledger and credits
them back.  The traffic is the example's, from
``np.random.default_rng(7)``: 3 multi-chunk ingest prompts, 5 streamers
and one sampled stream (temperature 0.8, its generator seeded 42).

The checks are the example's: no graph captured after warm-up (the
port's counterpart of "recompiles after warmup"), every chain delivered,
the prefill pool runs no decode step and the decode pool no prefill
chunk, and every stream, greedy and sampled, equals the monolithic
engine's at the same total KV budget (48 allocatable blocks).  The
monolithic engine runs with ``mixed=False``: neither pool fuses a
prefill chunk into a decode span, and on the card a fused dispatch's
products run at other shapes, whose sums cuBLAS may round otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PREFILL_CELL = "demo/prefill-cell"
DECODE_CELL = "demo/decode-cell"


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
    from kubeshare_tpu_torch.runtime import cell_tokend
    from kubeshare_tpu_torch.serving import (DisaggRouter, EngineConfig,
                                             Request, ServingEngine)

    device = resolve_device(args.device)

    print("=== 1. model + split-pool geometry ===")
    width = (dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
             if args.small else
             dict(d_model=256, n_heads=8, n_kv_heads=2, d_ff=1024))
    config = TransformerConfig(
        n_layers=4, vocab_size=8000, max_seq_len=256, dtype=torch.float32,
        positional="rope", attention="reference", **width)
    params = transformer_init(config, torch.Generator().manual_seed(0),
                              device=device)
    # one KV budget, split: 48 allocatable blocks = 16 prefill + 32
    # decode (decode holds prompt and generated rows of every live
    # stream; prefill only the prompts in flight)
    prefill_ec = EngineConfig(
        num_slots=2, block_size=16, num_blocks=17,
        max_request_len=192, prefill_chunk=32)
    decode_ec = EngineConfig(
        num_slots=4, block_size=16, num_blocks=33,
        max_request_len=192, prefill_chunk=32, decode_span=4)
    print(f"prefill pool: {prefill_ec.num_slots} slots, "
          f"{prefill_ec.num_blocks - 1} blocks; decode pool: "
          f"{decode_ec.num_slots} slots, {decode_ec.num_blocks - 1} "
          f"blocks (the {prefill_ec.num_blocks + decode_ec.num_blocks - 2}"
          f"-block total a monolithic engine gets) on {device}")

    rng = np.random.default_rng(7)
    specs = []
    for i in range(3):   # multi-chunk ingest prompts, few tokens out
        specs.append(dict(
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
    # a sampled stream: its seed schedule must survive the migration
    specs.append(dict(rid="sampled",
                      prompt=rng.integers(0, config.vocab_size, 18),
                      max_new_tokens=24, temperature=0.8))

    def request(spec):
        # a fresh generator a run: the engine draws the seed schedule
        rng_ = (torch.Generator().manual_seed(42)
                if spec.get("temperature") else None)
        return Request(**spec, rng=rng_)

    print("=== 2. runtime: one tokend, two fractional cells ===")
    with cell_tokend([(PREFILL_CELL, "1.0", "0.5"),
                      (DECODE_CELL, "1.0", "0.5")],
                     min_quota_ms=16.0) as port:
        p_client = TokenClient("127.0.0.1", port, PREFILL_CELL)
        d_client = TokenClient("127.0.0.1", port, DECODE_CELL)
        ledger = {"migrate": 0, "demote": 0, "promote": 0}

        def ledger_hook(nbytes: int, kind: str) -> None:
            # migration and tier traffic charged against the decode
            # cell's memory ledger like any device copy, then credited
            # back once the transient staging copy dies
            ok, _, _ = d_client.request_memory(nbytes)
            if not ok:
                raise RuntimeError(f"ledger refused {nbytes}B {kind}")
            d_client.request_memory(-nbytes)
            ledger[kind] += nbytes

        router = DisaggRouter(
            params, config, prefill_ec, decode_ec,
            guard=ExecutionGuard(client=p_client, from_env=False),
            decode_guard=ExecutionGuard(client=d_client, from_env=False),
            shared_tier_bytes=1 << 20,
            ledger_hook=ledger_hook, device=device)

        print("=== 3. capture each pool once (zero new captures) ===")
        router.warmup()
        warm_counts = router.capture_counts()
        p_warm = sorted(k for k in warm_counts if k.startswith("prefill."))
        d_warm = sorted(k for k in warm_counts if k.startswith("decode."))
        print(f"prefill-pool program kinds: {len(p_warm)}; decode-pool "
              f"program kinds: {len(d_warm)} (each pool captures only its "
              f"phase's shapes): {warm_counts}")

        print("=== 4. traffic: ingest prompts + streamers, greedy and "
              "sampled ===")
        start = time.monotonic()
        for spec in specs:
            router.submit(request(spec))
        results = router.run()
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
        end_counts = router.capture_counts()
        recaptures = sum(end_counts.values()) - sum(warm_counts.values())
        mig = router.migrator
        print(f"aggregate: {total} tokens in {elapsed:.2f} s "
              f"({total / elapsed:.0f} tok/s); captures after warmup: "
              f"{recaptures}")
        print(f"migration: {mig.delivered}/{mig.migrations} chains "
              f"delivered, {mig.migrated_bytes >> 10} KiB over the wire "
              f"format; ledger saw migrate={ledger['migrate'] >> 10} KiB "
              f"demote={ledger['demote'] >> 10} KiB "
              f"promote={ledger['promote'] >> 10} KiB")
        print(f"phase split: {router.prefill.prefill_chunks} prefill "
              f"chunks ({router.prefill.decode_steps} decode steps, must "
              f"be 0) vs {router.decode.decode_steps} decode spans "
              f"({router.decode.prefill_chunks} prefill chunks, must be 0)")
        if recaptures:
            raise RuntimeError(
                f"{recaptures} graphs captured after warmup: a "
                f"static-shape leak in a pool's steps")
        if mig.delivered != len(specs):
            raise RuntimeError(
                f"{mig.delivered} chains delivered for {len(specs)} "
                f"requests: some handoff never completed")
        if router.prefill.decode_steps or router.decode.prefill_chunks:
            raise RuntimeError("a pool ran the other phase's dispatch")

        print("=== 5. the handoff changes nothing: monolithic replay ===")
        mono = ServingEngine(params, config, EngineConfig(
            num_slots=decode_ec.num_slots, block_size=16,
            num_blocks=prefill_ec.num_blocks + decode_ec.num_blocks - 1,
            max_request_len=192, prefill_chunk=32, decode_span=4,
            mixed=False), device=device)
        mono.warmup()
        for spec in specs:
            mono.submit(request(spec))
        mono_results = mono.run()
        diverged = [spec["rid"] for spec in specs
                    if list(results[spec["rid"]].tokens)
                    != list(mono_results[spec["rid"]].tokens)]
        if diverged:
            raise RuntimeError(
                f"streams diverged vs the monolithic engine: {diverged}")
        print(f"all {len(specs)} streams bit-identical to the monolithic "
              f"engine (greedy and sampled: the seed schedules survived "
              f"the migration)")

        probe = TokenClient("127.0.0.1", port, "probe")
        stat = json.loads(probe.stat())
        for client in (probe, p_client, d_client):
            client.close()
        cells = {}
        for pod in (PREFILL_CELL, DECODE_CELL):
            p = stat["pods"][pod]
            cells[pod] = {"grants": p["grants"],
                          "charged_ms": p["charged_total_ms"],
                          "mem_used": p["mem_used"]}
            print(f"tokend accounting [{pod}]: grants={p['grants']} "
                  f"charged={p['charged_total_ms']:.0f} ms, "
                  f"mem_used={p['mem_used']} (staging copies credited "
                  f"back)")
    print("disagg demo complete")
    return {
        "device": str(device), "tokens": total, "seconds": elapsed,
        "tokens_per_s": total / elapsed,
        "captures_after_warmup": recaptures,
        "migrations": mig.migrations, "delivered": mig.delivered,
        "migrated_bytes": mig.migrated_bytes, "ledger": ledger,
        "streams_equal_monolithic": len(specs) - len(diverged),
        "requests": len(specs), "cells": cells,
        "streams": {spec["rid"]: list(results[spec["rid"]].tokens)
                    for spec in specs},
    }


if __name__ == "__main__":
    main()
