#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit; TF32 off for f32 products.
2. build: compile every kernel under kubeshare_tpu_torch/csrc with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and a few more (GQA, window, ragged, d=128,
   f32), with the tolerances below; then its time beside the plain
   version's, one library call's, and the bound the card sets.
4. slice: the flagship Transformer (entry.flagship_config, full width,
   weights from a seed) runs its forward at tokens (4, 1024), then serves
   4 requests (896-token prompts, 128 greedy tokens each: bulk prefill,
   then cached decode).  The launch counters are zeroed before each path
   and read after it; both are held against the same path with plain
   attention.

The last lines are the card (nvidia-smi), a JSON ``kernels`` line, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing any
result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): the bound a kernel is held to
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs its plain version, same inputs on the card.  out: both round
# the same f32 result to the output dtype after summing in another order
# (and bf16 p is rounded against the running max in the kernel, the
# final max in the plain version), so allow about one bf16 ulp of |out|
# on top of a small absolute term.  lse stays f32 throughout: only the
# summation order differs.
TOLERANCES = {
    "bfloat16": {"out_atol": 1e-2, "out_rtol": 1e-2, "lse_atol": 1e-3},
    "float32": {"out_atol": 1e-4, "out_rtol": 1e-4, "lse_atol": 1e-4},
}
# the flagship with the kernel vs with attention="reference" (bf16): the
# reference rounds scores to bf16 before the softmax, the kernel keeps
# them f32, and four layers carry the difference to the logits and to the
# cached K/V (|k| reaches ~8, where a bf16 ulp is 0.03-0.06)
SLICE_LOGITS_ATOL = 0.1
SLICE_KV_ATOL = 0.2

PROMPT_LEN = 896
NEW_TOKENS = 128
N_REQUESTS = 4


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(s: int, causal: bool, window) -> int:
    """Query-key pairs the mask keeps per head (what the kernel computes)."""
    if window is not None:
        return sum(min(i + 1, window) for i in range(s))
    return s * (s + 1) // 2 if causal else s * s


def flash_bound(shape, h_kv, dtype_name, causal, window):
    """(bound_ms, bound_by): bytes of q, k, v, out, lse once each over
    the memory rate vs the two products' operations over the peak."""
    b, h, s, d = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * b * h * s * d + 2 * b * h_kv * s * d) * elt + b * h * s * 4
    flops = 4 * d * visible_pairs(s, causal, window) * b * h
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, device):
    from kubeshare_tpu_torch.ops.attention import flash_forward, flash_forward_reference

    cases = [
        # name, (b, h, s, d), h_kv, dtype, causal, window
        ("flagship", (4, 8, 1024, 64), 8, torch.bfloat16, True, None),
        ("prefill_896", (4, 8, PROMPT_LEN, 64), 8, torch.bfloat16, True, None),
        ("gqa_hkv2", (4, 8, 1024, 64), 2, torch.bfloat16, True, None),
        ("window_256", (4, 8, 1024, 64), 8, torch.bfloat16, True, 256),
        ("ragged_333_noncausal", (2, 8, 333, 64), 8, torch.bfloat16, False, None),
        ("d128", (2, 4, 1024, 128), 4, torch.bfloat16, True, None),
        ("f32_ragged_500", (2, 4, 500, 64), 2, torch.float32, True, None),
        ("f32_d128_window", (1, 4, 512, 128), 4, torch.float32, True, 100),
    ]
    gen = torch.Generator(device=device).manual_seed(1234)
    worst = 0.0
    for name, shape, h_kv, dtype, causal, window in cases:
        b, h, s, d = shape
        q = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        k = torch.randn((b, h_kv, s, d), generator=gen, device=device, dtype=dtype)
        v = torch.randn((b, h_kv, s, d), generator=gen, device=device, dtype=dtype)
        out, lse = flash_forward(q, k, v, causal, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_forward_reference(q, k, v, causal, window)
        tol = TOLERANCES[str(dtype).removeprefix("torch.")]
        out_err = (out.float() - ref_out.float()).abs()
        out_ok = bool((out_err <= tol["out_atol"]
                       + tol["out_rtol"] * ref_out.float().abs()).all())
        finite = torch.isfinite(ref_lse)
        check(bool((torch.isfinite(lse) == finite).all()),
              f"{name}: lse -inf rows differ")
        lse_err = float((lse[finite] - ref_lse[finite]).abs().max())
        err = float(out_err.max())
        print(f"kernel flash_fwd {name}: shape={shape} h_kv={h_kv} "
              f"{dtype} causal={causal} window={window} "
              f"out_max_abs_err={err:.3e} lse_max_abs_err={lse_err:.3e}")
        check(out_ok, f"{name}: out disagrees with flash_forward_reference "
                      f"(max abs err {err})")
        check(lse_err <= tol["lse_atol"],
              f"{name}: lse disagrees with flash_forward_reference "
              f"(max abs err {lse_err})")
        worst = max(worst, err)

    # times at the flagship shape (the entry forward's attention)
    shape, h_kv = (4, 8, 1024, 64), 8
    q, k, v = (torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    kernel_ms = time_ms(lambda: flash_forward(q, k, v, True))
    plain_ms = time_ms(lambda: flash_forward_reference(q, k, v, True))
    # yardstick only: the port never calls it
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    bound_ms, bound_by = flash_bound(shape, h_kv, "bfloat16", True, None)
    print(f"kernel flash_fwd timing at {shape} bf16 causal: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "shape": list(shape)}


def slice_phase(torch, device):
    from kubeshare_tpu_torch.entry import entry, flagship_config
    from kubeshare_tpu_torch.models.decoding import greedy_decode_with_cache, prefill
    from kubeshare_tpu_torch.models.transformer import transformer_apply
    from kubeshare_tpu_torch.ops.attention import flash_forward

    config = flagship_config()
    plain = dataclasses.replace(config, attention="reference")
    fn, (params, tokens) = entry()
    launches = {}

    # path 1: the entry forward at (4, 1024)
    flash_forward.launches = 0
    t0 = time.perf_counter()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches["forward"] = flash_forward.launches
    check(launches["forward"] == config.n_layers,
          f"forward launched the kernel {launches['forward']} times, "
          f"expected {config.n_layers}")
    with torch.no_grad():
        plain_logits = transformer_apply(params, tokens, plain)
    check(tuple(logits.shape) == (*tokens.shape, config.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite forward logits")
    forward_err = float((logits - plain_logits).abs().max())
    print(f"slice forward {tuple(tokens.shape)}: {forward_s * 1e3:.1f} ms (first call), "
          f"logits max abs err vs plain {forward_err:.3e}")
    check(forward_err <= SLICE_LOGITS_ATOL,
          f"forward logits differ from the plain path by {forward_err}")

    # path 2: serve 4 requests — bulk prefill, then greedy decode
    gen = torch.Generator().manual_seed(7)
    prompts = torch.randint(0, config.vocab_size, (N_REQUESTS, PROMPT_LEN),
                            generator=gen).to(device)
    flash_forward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, last = prefill(params, config, prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(flash_forward.launches == config.n_layers,
          f"prefill launched the kernel {flash_forward.launches} times, "
          f"expected {config.n_layers}")
    out = greedy_decode_with_cache(params, config, cache, last, NEW_TOKENS)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches["serve"] = flash_forward.launches

    plain_cache, plain_last = prefill(params, plain, prompts)
    plain_out = greedy_decode_with_cache(params, plain, plain_cache,
                                         plain_last, NEW_TOKENS)
    check(tuple(out.shape) == (N_REQUESTS, NEW_TOKENS), f"tokens {out.shape}")
    check(bool(((out >= 0) & (out < config.vocab_size)).all()),
          "token ids out of range")
    check(bool(torch.isfinite(last).all()), "non-finite prefill logits")
    check(int(cache["length"]) == PROMPT_LEN + NEW_TOKENS - 1,
          f"cache length {cache['length']}")
    logits_err = float((last - plain_last).abs().max())
    kv_err = max(
        float((cache[n][..., :PROMPT_LEN, :].float()
               - plain_cache[n][..., :PROMPT_LEN, :].float()).abs().max())
        for n in ("k", "v"))
    agree = float((out == plain_out).float().mean())
    top2 = torch.topk(plain_last, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > SLICE_LOGITS_ATOL
    first_ok = bool((out[decided, 0] == plain_out[decided, 0]).all())
    print(f"slice serve {N_REQUESTS} x ({PROMPT_LEN} prompt + {NEW_TOKENS} "
          f"greedy): prefill {prefill_s * 1e3:.1f} ms, total "
          f"{serve_s * 1e3:.1f} ms; last logits max abs err vs plain "
          f"{logits_err:.3e}, kv max abs err {kv_err:.3e}, token agreement "
          f"{agree:.4f}, first token checked in "
          f"{int(decided.sum())}/{N_REQUESTS} rows")
    check(logits_err <= SLICE_LOGITS_ATOL,
          f"prefill logits differ from the plain path by {logits_err}")
    check(kv_err <= SLICE_KV_ATOL,
          f"prefill KV cache differs from the plain path by {kv_err}")
    check(first_ok, "first greedy token differs from the plain path in a "
                    "row whose top-2 margin exceeds the tolerance")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kubeshare_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")

    flash = kernel_phase(torch, device)
    launches = slice_phase(torch, device)

    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "kubeshare_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "kubeshare_tpu/ops/attention.py:107",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": flash["max_abs_err"],
        "ms": flash["ms"],
        "kernel_ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "timed_shape": flash["shape"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
