#!/usr/bin/env python3
"""Fractional serving on a CUDA card: the continuous-batching engine of
the port on a token-gated 0.5-share pod, the PyTorch twin of
``examples/serve_fractional.py``.

    python3 serve_fractional_torch.py                 # the example's model
    python3 serve_fractional_torch.py --small --device cpu   # tests

The example's model and engine: a GQA Transformer (d 256, 4 layers, 8
query heads over 2 KV heads, f32, rope) served by ``ServingEngine`` over
a block-paged KV pool of 33 blocks of 16, stall-free mixed batching (16
fused prefill tokens a step), a 1 MiB host tier under the ``qos``
policy, self-drafted speculative decoding (``draft_len`` 4) and the
device loop (``steps_per_launch`` 4).  Two tenants share the pod: a
guaranteed "prod" and an opportunistic "batch" with a KV quota of 3/4 of
the pool.  The traffic is the example's, from ``np.random.default_rng(0)``:
a flood of 6 batch requests, 24 steps, then 8 prod requests, half of
them behind a shared 24-token prefix, so prod preempts batch.

Every dispatch is gated by the real ``tpushare-tokend`` (built from
``native/`` if missing) through an ``ExecutionGuard`` for a pod at limit
1.0, request 0.5.  The JAX example's "recompiles after warmup" is the
port's graphs captured after warm-up (``capture_counts``): the script
raises unless it is 0.  ``--small`` serves a narrow model with the same
engine and traffic; ``--device cpu`` runs the programs eagerly on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

POD = "demo/serve-pod"


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
    from kubeshare_tpu_torch.serving import (QOS_OPPORTUNISTIC, EngineConfig,
                                             Request, ServingEngine,
                                             TenantRegistry, TenantSpec)

    device = resolve_device(args.device)

    print("=== 1. model: GQA flagship (8 query heads over 2 KV heads) ===")
    width = (dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
             if args.small else
             dict(d_model=256, n_heads=8, n_kv_heads=2, d_ff=1024))
    config = TransformerConfig(
        n_layers=4, vocab_size=8000, max_seq_len=256, dtype=torch.float32,
        positional="rope", attention="reference", **width)
    params = transformer_init(config, torch.Generator().manual_seed(0),
                              device=device)
    engine_config = EngineConfig(
        num_slots=4, block_size=16, num_blocks=33,  # 32 blocks = 512 rows
        max_request_len=192, prefill_chunk=32, decode_span=4,
        mixed=True, mixed_prefill_budget=16,
        host_tier_bytes=1 << 20, tier_policy="qos",
        speculative=True, draft_len=4,
        steps_per_launch=4)
    dense_bytes = (2 * config.n_layers * engine_config.num_slots
                   * config.kv_heads * config.max_seq_len
                   * config.head_dim * 4)
    paged_bytes = ((engine_config.num_blocks - 1)
                   * 2 * config.n_layers * config.kv_heads
                   * engine_config.block_size * config.head_dim * 4)
    print(f"KV pool: {paged_bytes / 1e6:.1f} MB in "
          f"{engine_config.num_blocks - 1} blocks (dense caches for "
          f"{engine_config.num_slots} slots would pin "
          f"{dense_bytes / 1e6:.1f} MB) on {device}")

    print("=== 2. runtime: tokend with a 0.5-share serving pod ===")
    with cell_tokend([(POD, "1.0", "0.5")]) as port:
        client = TokenClient("127.0.0.1", port, POD)
        guard = ExecutionGuard(client=client, from_env=False)
        # two tenants inside the pod: "prod" guaranteed, "batch"
        # opportunistic with a KV quota of 3/4 of the pool (loose enough
        # to soak every slot, so prod must preempt it)
        tenants = TenantRegistry([
            TenantSpec("prod"),
            TenantSpec("batch", qos_class=QOS_OPPORTUNISTIC,
                       kv_block_quota=3 * (engine_config.num_blocks - 1) // 4),
        ])
        engine = ServingEngine(params, config, engine_config, guard=guard,
                               tenants=tenants, device=device)

        print("=== 3. capture once, serve any mix (zero new captures) ===")
        # warm (capture) outside the gated window, as the training pods
        # warm their step
        engine.warmup()
        warm_counts = engine.capture_counts()
        print(f"captured programs: {warm_counts}")

        print("=== 4. requests: an opportunistic flood, then prod "
              "traffic preempting through it ===")
        rng = np.random.default_rng(0)
        shared_prefix = rng.integers(0, config.vocab_size, 24)
        requests = []
        for i in range(6):  # the flood: long decodes, all slots
            prompt = rng.integers(0, config.vocab_size,
                                  int(rng.integers(12, 49)))
            requests.append(Request(f"batch{i}", prompt,
                                    int(rng.integers(48, 97)),
                                    tenant="batch"))
            engine.submit(requests[-1])
        # the flood occupies the slots before prod arrives
        for _ in range(24):
            engine.step()
        for i in range(8):
            prompt_len = int(rng.integers(12, 97))
            max_new = int(rng.integers(8, 49))
            prompt = rng.integers(0, config.vocab_size, prompt_len)
            if i % 2:
                prompt = np.concatenate([shared_prefix, prompt[24:]]) \
                    if prompt_len > 24 else prompt
            requests.append(Request(f"prod{i}", prompt, max_new,
                                    tenant="prod"))
            engine.submit(requests[-1])
        start = time.monotonic()
        results = engine.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.monotonic() - start
        total = 0
        for req in requests:
            r = results[req.rid]
            total += len(r.tokens)
            print(f"{req.rid:7s} [{req.tenant:5s}]: prompt "
                  f"{r.prompt_len:3d} -> {len(r.tokens):2d} tokens, "
                  f"ttft {1e3 * r.ttft:6.1f} ms, "
                  f"done +{1e3 * (r.finished_at - r.submitted_at):6.1f} ms")
        print(f"qos: preemptions by tenant {engine.preemptions}; "
              f"tokens by tenant {engine.tenant_tokens}; "
              f"batch quota occupancy "
              f"{engine.allocator.tenant_usage('batch')}/"
              f"{tenants.get('batch').kv_block_quota} blocks")
        end_counts = engine.capture_counts()
        recaptures = sum(end_counts.values()) - sum(warm_counts.values())
        print(f"aggregate: {total} tokens in {elapsed:.2f} s "
              f"({total / elapsed:.0f} tok/s); "
              f"peak blocks {engine.peak_blocks_in_use}/"
              f"{engine.allocator.num_blocks - 1}; "
              f"captures after warmup: {recaptures} "
              f"({end_counts} vs {warm_counts})")
        print(f"prefix cache: {engine.prefix_hit_requests} hit requests, "
              f"{engine.prefix_hit_tokens} prompt tokens skipped, "
              f"{engine.cow_copies} CoW copies, "
              f"{engine.allocator.cached_idle_blocks} blocks cached idle")
        print(f"mixed batching: {engine.mixed_steps} fused dispatches, "
              f"{engine.prefill_chunks - engine.mixed_steps} standalone "
              f"chunks, {engine.decode_steps - engine.mixed_steps} "
              f"standalone spans")
        drafted = sum(engine.spec_drafted.values())
        accepted = sum(engine.spec_accepted.values())
        print(f"speculative decoding: {engine.verify_steps} verify "
              f"dispatches ({engine.mixed_verify_steps} fused with "
              f"prefill), {drafted} tokens drafted, {accepted} accepted "
              f"({100 * accepted / max(1, drafted):.0f}%: random weights "
              f"draft poorly), by tenant drafted="
              f"{dict(engine.spec_drafted)} accepted="
              f"{dict(engine.spec_accepted)}")
        print(f"kv tier ({engine_config.tier_policy} policy, "
              f"{engine_config.host_tier_bytes >> 10} KiB host budget): "
              f"{engine.tier_demoted_blocks} blocks demoted host-side, "
              f"{engine.tier_promoted_blocks} promoted back, "
              f"{engine.tier_dropped_blocks} dropped, "
              f"{engine.tier_hit_requests} host-hit requests "
              f"({engine.tier_hit_tokens} tokens recovered), "
              f"{len(engine.host_tier)} entries / "
              f"{engine.host_tier.used_bytes >> 10} KiB resident; "
              f"evictions by reason {engine.evictions_by_reason}")
        if recaptures:
            raise RuntimeError(
                f"{recaptures} graphs captured after warmup: a "
                f"static-shape leak in the serving steps")

        probe = TokenClient("127.0.0.1", port, "probe")
        stat = json.loads(probe.stat())
        probe.close()
        client.close()
        pod = stat["pods"][POD]
        print(f"tokend accounting: grants={pod['grants']} "
              f"charged={pod['charged_total_ms']:.0f} ms "
              f"(share limit 1.0, request 0.5): every prefill chunk and "
              f"decode span charged through the guard")
    print("serve demo complete")
    return {
        "device": str(device), "tokens": total, "seconds": elapsed,
        "tokens_per_s": total / elapsed,
        "captures_after_warmup": recaptures,
        "preemptions": dict(engine.preemptions),
        "tier_demoted_blocks": engine.tier_demoted_blocks,
        "tier_promoted_blocks": engine.tier_promoted_blocks,
        "prefix_hit_requests": engine.prefix_hit_requests,
        "verify_steps": engine.verify_steps,
        "spec_drafted": drafted, "spec_accepted": accepted,
        "grants": pod["grants"], "charged_ms": pod["charged_total_ms"],
        "streams": {rid: list(r.tokens) for rid, r in results.items()},
    }


if __name__ == "__main__":
    main()
