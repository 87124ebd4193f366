#!/usr/bin/env python3
"""The full train step (loss, gradients, AdamW) of the repo's model sizes
on a CUDA card, with plain attention against the flash kernels: the
PyTorch port's twin of ``benchmarks/kernel_bench.py --suite model``.

    python3 model_bench.py                     # flagship, wide, moe

For each size of ``MODEL_SIZES`` (kernel_bench.py's: the train-step
flagship, a wide matmul-bound one and the MoE model; bf16, rope) the step
is ``make_train_step(..., capture=True)``, one CUDA graph replay a step
(the counterpart of JAX's jitted step), once with
``attention="reference"`` and once with ``attention="flash"`` (the
hand-written kernels), on a fixed batch from a seed.  A row gives each
one's median step ms by CUDA events, tokens/s, and the achieved TFLOP/s
and MFU from chip_smoke.py's FLOPs model (``train_flops_per_token``:
kernel_bench.py's) against the H100's dense bf16 peak, 989 TFLOP/s,
beside the card's name and power limit.  Prints the card line, one JSON
row a size, and as the last line a JSON object of all of them.
"""

from __future__ import annotations

import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (TRAIN_STEPS, card_line, read_counts,  # noqa: E402
                        reset_counts, steady_median, timed_steps,
                        train_flops_per_token)

# benchmarks/kernel_bench.py MODEL_SIZES: (dims, batch, seq)
MODEL_SIZES = {
    "flagship": (dict(d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
                      max_seq_len=2048, vocab_size=32000), 2, 2048),
    "wide": (dict(d_model=2048, n_layers=8, n_heads=16, d_ff=8192,
                  max_seq_len=2048, vocab_size=32000), 1, 2048),
    "moe": (dict(d_model=1024, n_layers=8, n_heads=8, d_ff=4096,
                 max_seq_len=2048, vocab_size=32000, moe_every=2,
                 moe_num_experts=8, moe_top_k=2,
                 moe_capacity_factor=1.25), 2, 2048),
}
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense (NVIDIA data sheet)


def bench_step(torch, device, dims, batch, seq, attention):
    """TRAIN_STEPS captured steps: (the median step ms by CUDA events over
    steps TRAIN_TIMED_FROM.., the flash kernels' launches while
    capturing, the losses)."""
    from kubeshare_tpu_torch.models.transformer import (
        TransformerConfig, transformer_apply, transformer_init)
    from kubeshare_tpu_torch.parallel.train import make_train_step

    config = TransformerConfig(**dims, positional="rope",
                               dtype=torch.bfloat16, attention=attention)
    params = transformer_init(config, torch.Generator().manual_seed(0),
                              device)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, config.vocab_size, (batch, seq),
                           generator=gen).to(device)
    targets = torch.randint(0, config.vocab_size, (batch, seq),
                            generator=gen).to(device)
    # kernel_bench.py's step: the cross entropy alone (for the MoE model
    # too: transformer_apply drops the auxiliary loss, as JAX's does)
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config), capture=True)
    state = init_state(params)
    del params
    torch.cuda.synchronize()
    reset_counts()
    state, losses, step_ms, _ = timed_steps(torch, train_step, state,
                                            [(tokens, targets)] * TRAIN_STEPS)
    launches = {name: n for name, n in read_counts().items() if n}
    del state, train_step
    torch.cuda.empty_cache()
    return steady_median(step_ms), launches, losses


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("model_bench: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    print(card)
    rows = []
    for size, (dims, batch, seq) in MODEL_SIZES.items():
        tokens_per_step = batch * seq
        flops_per_token = train_flops_per_token(dims, seq)
        row = {"size": size, "dims": dims, "batch": batch, "seq": seq,
               "train_flops_per_token": flops_per_token}
        for attention in ("reference", "flash"):
            ms, launches, losses = bench_step(torch, device, dims, batch,
                                              seq, attention)
            tflops = flops_per_token * tokens_per_step / (ms * 1e-3) / 1e12
            row.update({f"{attention}_ms": ms,
                        f"{attention}_tokens_per_s":
                            tokens_per_step / (ms * 1e-3),
                        f"{attention}_tflops": tflops,
                        f"{attention}_mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
                        f"{attention}_launches_while_capturing": launches,
                        f"{attention}_losses": losses})
            if not all(math.isfinite(x) for x in losses):
                raise RuntimeError(f"{size} {attention}: bad losses {losses}")
        if not row["flash_launches_while_capturing"]:
            raise RuntimeError(f"{size}: the flash step launched no kernel")
        row["speedup"] = row["reference_ms"] / row["flash_ms"]
        row["card"] = card
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"model_bench": rows, "card": card,
                      "peak_bf16_flops": PEAK_BF16_FLOPS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
