#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py                  # the check below
    python3 chip_smoke.py --profile-train  # where a train step's time goes

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit; TF32 off for f32 products
   and convolutions.
2. build: compile every kernel under kubeshare_tpu_torch/csrc with nvcc
   (one nvcc per source, all at once).
   hbm_cap: in a child process at TPUSHARE_MEM_FRACTION=0.5,
   isolation.apply_hbm_cap returns 0.5, 0.4 of the card allocates and
   0.6 raises torch.OutOfMemoryError.
3. kernels: the flash forward and the two flash backward kernels (dK/dV,
   dQ) against their plain PyTorch versions on the card, at the main
   paths' shapes and a few more (GQA, window, ragged, d=128, f32, and
   the edges of the bf16 kernels' tiles), with the tolerances
   below; then each kernel's time beside the plain version's, one
   library call's, and the bound the card sets, at the serving
   flagship's attention shape and at the training shape, with the
   achieved TFLOP/s and the ratio to the library call.
4. block_sparse: the masked instantiations of the three kernels against
   their plain versions at eight masks (documents, prefix-LM, dead rows,
   mask blocks straddling the kernels' tiles, JAX's default blocks, GQA,
   f32 at a ragged length and at head_dim 128); block_sparse_attention's
   forward and gradient at the document-masked training shape, held
   against the plain path; and each masked kernel's time there beside
   the plain version's, SDPA's with the expanded mask, and the bound.
5. slice: the flagship Transformer (entry.flagship_config, full width,
   weights from a seed) runs its forward at tokens (4, 1024), then serves
   4 requests (896-token prompts, 128 greedy tokens each: bulk prefill,
   then cached decode).  Both are held against the same path with plain
   attention.
6. train: the repo's train-step flagship (benchmarks/kernel_bench.py
   MODEL_SIZES["flagship"], rope, bf16, full width and depth) takes 10
   AdamW steps on a fixed batch of 2 x 2048 tokens through
   parallel.train.make_train_step.  Step 1's loss and every gradient are
   held against attention="reference"; the loss must fall; the median
   step time gives tokens/s and the share of the bf16 peak.  Then the
   same 10 steps from the same state through make_train_step(...,
   capture=True) (one CUDA graph a step), held against the eager run
   (losses and parameters), each step's CUDA-event time beside its host
   enqueue time.
7. mnist: the co-run's MNIST at batch 512 from weights converted from a
   numpy tree: its logits against the CPU's, and 8 captured train steps
   against 8 eager ones, timed.
8. corun: corun_bench.py's four phases (solo A, solo B, the co-run of
   two MNIST pods under tpushare-tokend, the adversarial pair) at 3 s
   windows; every phase must produce a result and every pod must be
   granted tokens.  The ratio and the adversarial flags are reported.

The launch counters are zeroed before each path and read after it (the
captured path's around its capture: a replay bumps no counter).  The
last lines are the card (nvidia-smi), a JSON ``kernels`` line, and
``{"ok": true, "device": {...}}``.

``--profile-train`` builds the kernels and runs only the train path's
steady steps under ``torch.profiler``, eager and then captured: the
host's enqueue time and the wall time per step, the device's busy share,
and device time by kernel.

Without a CUDA device, or without the rest of the repository beside it,
the script fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
# backward kernels vs flash_backward_reference, same inputs on the card,
# as max |kernel - plain| / max |plain| per gradient (gradients vary in
# magnitude from tensor to tensor).  bf16: both round p and ds to bf16 at
# the same points and the results to bf16 at the end, but from f32 values
# summed in another order, so an element may land on the neighbouring
# bf16 value (2^-8 relative); allow a few such ulps of the largest
# gradient.  f32: only the summation order differs.
BWD_TOLERANCES = {"bfloat16": 1e-2, "float32": 1e-5}
# the train step with the kernels vs with attention="reference" (bf16):
# the reference rounds scores to bf16 before its softmax (an absolute
# error of ~0.03 on scores of ~8, a few % on p), the kernels keep them
# f32, and eight layers carry the difference into every gradient.  Loss:
# absolute, on a loss of ~11.  Gradients: max |diff| / max |ref| per
# tensor, and their cosine similarity.
TRAIN_LOSS_ATOL = 2e-2
TRAIN_GRAD_RTOL = 0.1
TRAIN_GRAD_MIN_COSINE = 0.99
# remat on vs off: the backward recomputes each layer with the same
# kernels on the same inputs, so the gradients agree to round-off (a
# library reduction whose order may differ between the two runs)
REMAT_GRAD_RTOL = 1e-3

# benchmarks/kernel_bench.py MODEL_SIZES["flagship"]: the repo's own
# train-step flagship, at batch 2 x 2048 (suite_model builds it with rope
# and bf16)
TRAIN_DIMS = dict(vocab_size=32000, d_model=1024, n_heads=8, n_layers=8,
                  d_ff=4096, max_seq_len=2048)
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS = 10
TRAIN_TIMED_FROM = 3  # median over steps 3..10 (1-based): past warm-up

PROMPT_LEN = 896
NEW_TOKENS = 128
N_REQUESTS = 4

# the captured train step against two eager runs from the same state and
# batches.  (1) An eager step with the same optimizer (AdamW switched to
# its capturable mode, as the captured step switches it):
# the graph replays that step's kernels on the same inputs in the same
# order, so the two agree up to the library kernels' run-to-run
# nondeterminism (none seen on the flagship, equal to the bit; ~1e-6 of
# MNIST's update, from its convolution gradients).  (2) The default eager
# step (AdamW with its bias corrections in Python floats, where the
# capturable one computes them in f32 on the device): the parameters
# differ in their last bits after step 1; in bf16 some weights then round
# to the neighbouring bf16 value, and Adam's normalised step turns small
# gradient differences into whole steps of lr, so the two runs drift
# apart over the steps (first card runs: a loss 9.5e-3 apart at step 10
# of the flagship, 1.7e-2 of its update; 7.8e-5 and 2.3e-4 on MNIST in
# f32).  Step 1's loss precedes any update and is held to (1)'s limit;
# the flagship's drift to the bounds of the train phase's
# kernel-vs-reference check, MNIST's (f32, no bf16 rounding to amplify)
# to a few times its readings.  On the card these comparisons with the
# default run are the only check that capturable AdamW computes optax's
# update.  Loss: absolute.  Parameters: per tensor, the norm of the
# difference of two runs over the norm of the eager run's whole update.
CAPTURE_SAME_LOSS_ATOL = 1e-5
CAPTURE_SAME_UPDATE_RTOL = 1e-4
CAPTURE_DRIFT_LOSS_ATOL = TRAIN_LOSS_ATOL
CAPTURE_DRIFT_UPDATE_RTOL = TRAIN_GRAD_RTOL
MNIST_DRIFT_LOSS_ATOL = 5e-4
MNIST_DRIFT_UPDATE_RTOL = 1e-3
# the captured flagship step gated by an ExecutionGuard and returning only
# its state (a TrainState): the guard's charge must cover the device's
# burst, at least this share of the step's CUDA-event median (charging
# the enqueue alone would read ~0.01)
GUARD_STEPS = 5
GUARD_MIN_SHARE = 0.9
# MNIST on the card, f32 with TF32 off: the card's logits vs the CPU's on
# the same weights and images, f32 summed in another order, ~1e-6 of
# logits of a few units (TF32 would show ~1e-2)
MNIST_BATCH = 512
MNIST_STEPS = 8
MNIST_LOGITS_ATOL = 1e-4
# the co-run's measured windows here (corun_bench.py's own default is
# 10 s): four phases in about 90 s
CORUN_SECONDS = 3.0


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
    torch.cuda.synchronize()
    # hold the device (~25 ms) while the host queues every timed call, so
    # the events read device time and not the host's pace of issuing (an
    # autograd call's host work can exceed its kernels' time)
    torch.cuda._sleep(50_000_000)
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


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound(shape, h_kv, dtype_name, causal, window, pairs=None):
    """(bound_ms, bound_by): bytes of q, k, v, out, lse once each over
    the memory rate vs the two products' operations over the peak.
    ``pairs``: visible pairs per head, when a block mask sets them."""
    b, h, s, d = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * b * h * s * d + 2 * b * h_kv * s * d) * elt + b * h * s * 4
    if pairs is None:
        pairs = visible_pairs(s, causal, window)
    flops = 4 * d * pairs * b * h
    return _bound(nbytes, flops, dtype_name)


# FLOPs per visible query-key pair and unit of head_dim: the forward's two
# products, dK/dV's four, dQ's three
PAIR_FLOPS = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}


def achieved(name, shape, ms, library_ms, pairs):
    """A timing's achieved TFLOP/s (the visible pairs' operations over the
    kernel time) and its ratio to the library call, for the timing lines."""
    b, h, s, d = shape
    kernel = name.removesuffix("_block_sparse")
    tflops = PAIR_FLOPS[kernel] * d * pairs * b * h / (ms * 1e-3) / 1e12
    return tflops, ms / library_ms


def flash_bwd_bound(kernel, shape, h_kv, dtype_name, causal, window,
                    pairs=None):
    """(bound_ms, bound_by) of one backward kernel.  dkv reads q, k, v,
    dO, lse, delta and writes dk, dv; it does four products per visible
    pair (S, dP, p^T.dO, ds^T.q: 8 d FLOPs).  dq reads the same and
    writes dq; it does three (S, dP, ds.k: 6 d FLOPs).  ``pairs``:
    visible pairs per head, when a block mask sets them."""
    b, h, s, d = shape
    elt = 2 if dtype_name == "bfloat16" else 4
    q_elems, kv_elems = b * h * s * d, b * h_kv * s * d
    rows = 2 * b * h * s * 4  # lse and delta, f32
    if pairs is None:
        pairs = visible_pairs(s, causal, window)
    pairs *= b * h
    if kernel == "dkv":
        nbytes = (2 * q_elems + 4 * kv_elems) * elt + rows
        flops = 8 * d * pairs
    else:
        nbytes = (3 * q_elems + 2 * kv_elems) * elt + rows
        flops = 6 * d * pairs
    return _bound(nbytes, flops, dtype_name)


def train_flops_per_token(dims, seq):
    """benchmarks/kernel_bench.py:_train_flops_per_token for a dense
    model: per layer forward 2*(4 d^2) attention projections + 2*(2 d ff)
    MLP + 2*2*(seq/2)*d causal attention, plus the lm_head's 2 d vocab;
    a train step is 3x the forward."""
    d, ff, vocab = dims["d_model"], dims["d_ff"], dims["vocab_size"]
    layer = 2 * 4 * d * d + 2 * seq * d + 2 * 2 * d * ff
    return 3 * (2 * d * vocab + dims["n_layers"] * layer)


def kernel_resources(log: str):
    """(kernel, registers, spill bytes) per kernel from ptxas -v output."""
    import re

    rows, name, spill = [], None, 0
    for line in log.splitlines():
        # the mangled name puts the identifier's length just before it;
        # the masked instantiations' bool template argument reads Lb1E
        entry = re.search(r"Compiling entry function '\w*\d(flash_[a-z0-9_]+?_kernel)ILi(\d+)E(Lb1E)?", line)
        if entry:
            masked = ", masked" if entry.group(3) else ""
            name, spill = f"{entry.group(1)}<{entry.group(2)}{masked}>", 0
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spills and name:
            spill = int(spills.group(1)) + int(spills.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            rows.append((name, int(used.group(1)), spill))
            name = None
    return rows


SASS_OPS = ("HGMMA", "WARPGROUP.DEPBAR", "UTMALDG", "UTMASTG")
# the bf16 kernels, which run on wgmma and TMA
SASS_KERNELS = ("flash_fwd_bf16_kernel", "flash_bwd_dkv_bf16_kernel",
                "flash_bwd_dq_bf16_kernel")


def sass_counts(sass: str):
    """{"<kernel><D>" or "<kernel><D, masked>": {op: count}} of the bf16
    kernels' instantiations in cuobjdump's SASS of a library: wgmma
    (HGMMA), its serialising waits (WARPGROUP.DEPBAR), TMA loads and
    stores."""
    import re

    kernels = "|".join(SASS_KERNELS)
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(rf"\d({kernels})ILi(\d+)ELb(\d)", line)
            name = None
            if found:
                masked = ", masked" if found.group(3) == "1" else ""
                name = f"{found.group(1)}<{found.group(2)}{masked}>"
                counts[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        if name:
            for op in SASS_OPS:
                if op in line:
                    counts[name][op] += 1
    return counts


def library_sass(library) -> str:
    """cuobjdump -sass of a built library (cuobjdump beside nvcc)."""
    from pathlib import Path

    from kubeshare_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(library)], check=True,
                          capture_output=True, text=True, timeout=300).stdout


def reset_counts():
    from kubeshare_tpu_torch.ops import attention as A

    A.flash_forward.launches = 0
    A.flash_backward.launches_dkv = 0
    A.flash_backward.launches_dq = 0
    A.block_sparse_forward.launches = 0
    A.block_sparse_backward.launches_dkv = 0
    A.block_sparse_backward.launches_dq = 0


def read_counts():
    from kubeshare_tpu_torch.ops import attention as A

    return {"flash_fwd": A.flash_forward.launches,
            "flash_bwd_dkv": A.flash_backward.launches_dkv,
            "flash_bwd_dq": A.flash_backward.launches_dq,
            "flash_fwd_block_sparse": A.block_sparse_forward.launches,
            "flash_bwd_dkv_block_sparse": A.block_sparse_backward.launches_dkv,
            "flash_bwd_dq_block_sparse": A.block_sparse_backward.launches_dq}


def only(*names):
    """The counts of a path that launched each named kernel once and no
    other kernel."""
    return {name: int(name in names) for name in read_counts()}


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| in f32."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def check_out(torch, label, out, ref_out):
    """A forward's out against its plain version's, element by element
    (TOLERANCES); returns the max abs error."""
    tol = TOLERANCES[str(out.dtype).removeprefix("torch.")]
    out_err = (out.float() - ref_out.float()).abs()
    out_ok = bool((out_err <= tol["out_atol"]
                   + tol["out_rtol"] * ref_out.float().abs()).all())
    err = float(out_err.max())
    check(out_ok, f"{label}: out disagrees with the plain version "
                  f"(max abs err {err})")
    return err


def check_forward(torch, label, out, lse, ref_out, ref_lse):
    """A forward kernel's (out, lse) against its plain version's on the
    same inputs; returns out's max abs error."""
    tol = TOLERANCES[str(out.dtype).removeprefix("torch.")]
    finite = torch.isfinite(ref_lse)
    check(bool((torch.isfinite(lse) == finite).all()),
          f"{label}: lse -inf rows differ")
    lse_err = float((lse[finite] - ref_lse[finite]).abs().max())
    err = float((out.float() - ref_out.float()).abs().max())
    print(f"{label}: out_max_abs_err={err:.3e} lse_max_abs_err={lse_err:.3e}")
    check_out(torch, label, out, ref_out)
    check(lse_err <= tol["lse_atol"],
          f"{label}: lse disagrees with the plain version (max abs err "
          f"{lse_err})")
    return err


def check_grads(torch, label, grads, ref):
    """(dq, dk, dv) from the backward kernels against the plain
    version's; returns the worst (relative, absolute) error of the dK/dV
    and the dQ kernel."""
    names = ("dq", "dk", "dv")
    errs = {n: rel_err(g, r) for n, g, r in zip(names, grads, ref)}
    abs_errs = {n: float((g.float() - r.float()).abs().max())
                for n, g, r in zip(names, grads, ref)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    tol = BWD_TOLERANCES[str(grads[0].dtype).removeprefix("torch.")]
    print(f"{label}: " + " ".join(
        f"{n}_rel_err={e:.3e}" for n, e in errs.items()) + f" (tol {tol})")
    check(finite, f"{label}: non-finite gradients from the backward kernels")
    for n, e in errs.items():
        check(e <= tol, f"{label}: {n} disagrees with the plain version "
                        f"(max abs err / max |ref| = {e})")
    return {"dkv": (max(errs["dk"], errs["dv"]),
                    max(abs_errs["dk"], abs_errs["dv"])),
            "dq": (errs["dq"], abs_errs["dq"])}


def check_backward(torch, name, q, k, v, out, lse, causal, window, gen):
    """The dK/dV and dQ kernels against flash_backward_reference on the
    same inputs (the forward kernel's out and lse, a random dO); returns
    the worst relative error of each kernel."""
    from kubeshare_tpu_torch.ops.attention import flash_backward, flash_backward_reference

    dout = torch.randn(q.shape, generator=gen, device=q.device, dtype=q.dtype)
    grads = flash_backward(q, k, v, out, lse, dout, causal, window)
    torch.cuda.synchronize()
    ref = flash_backward_reference(q, k, v, out, lse, dout, causal, window)
    return check_grads(torch, f"kernel flash_bwd {name}", grads, ref)


def time_shape(torch, shape, gen):
    """Times of the forward and both backward kernels at one bf16 causal
    MHA shape, beside the plain versions, the library calls and the
    bounds."""
    import torch.nn.functional as F
    from kubeshare_tpu_torch.ops import attention as A

    b, h, s, d = shape
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda",
                                 dtype=torch.bfloat16) for _ in range(4))
    out, lse = A.flash_forward(q, k, v, True)
    delta = A._backward_delta(out, dout)
    fwd_ms = time_ms(lambda: A.flash_forward(q, k, v, True))
    dkv_ms = time_ms(lambda: A._flash_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                                   True, None))
    dq_ms = time_ms(lambda: A._flash_bwd_dq_cuda(q, k, v, dout, lse, delta,
                                                 True, None))
    fwd_plain_ms = time_ms(lambda: A.flash_forward_reference(q, k, v, True))
    # the plain backward computes dq, dk and dv in one call
    bwd_plain_ms = time_ms(lambda: A.flash_backward_reference(
        q, k, v, out, lse, dout, True, None))
    # yardsticks only: the port never calls them.  The library backward
    # is one autograd.grad of SDPA's output (its forward excluded, graph
    # kept): it computes what the two backward kernels compute together.
    fwd_library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True))
    rows = {}
    for name, ms, plain_ms, library_ms, bound in (
        ("flash_fwd", fwd_ms, fwd_plain_ms, fwd_library_ms,
         flash_bound(shape, h, "bfloat16", True, None)),
        ("flash_bwd_dkv", dkv_ms, bwd_plain_ms, bwd_library_ms,
         flash_bwd_bound("dkv", shape, h, "bfloat16", True, None)),
        ("flash_bwd_dq", dq_ms, bwd_plain_ms, bwd_library_ms,
         flash_bwd_bound("dq", shape, h, "bfloat16", True, None)),
    ):
        tflops, ratio = achieved(name, shape, ms, library_ms,
                                  visible_pairs(s, True, None))
        rows[name] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound[0],
                      "bound_by": bound[1], "tflops": tflops,
                      "library_ratio": ratio}
        print(f"kernel {name} timing at {shape} bf16 causal: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}); {tflops:.1f} TFLOP/s, {ratio:.3f}x library")
    return rows


def dense_cases(torch):
    """(name, (b, h, s, d), h_kv, dtype, causal, window) of the kernel
    phase."""
    return [
        ("flagship", (4, 8, 1024, 64), 8, torch.bfloat16, True, None),
        ("prefill_896", (4, 8, PROMPT_LEN, 64), 8, torch.bfloat16, True, None),
        ("gqa_hkv2", (4, 8, 1024, 64), 2, torch.bfloat16, True, None),
        ("window_256", (4, 8, 1024, 64), 8, torch.bfloat16, True, 256),
        ("ragged_333_noncausal", (2, 8, 333, 64), 8, torch.bfloat16, False, None),
        ("d128", (2, 4, 1024, 128), 4, torch.bfloat16, True, None),
        ("f32_ragged_500", (2, 4, 500, 64), 2, torch.float32, True, None),
        ("f32_d128_window", (1, 4, 512, 128), 4, torch.float32, True, 100),
        ("train", (TRAIN_BATCH, 8, TRAIN_SEQ, 128), 8, torch.bfloat16, True, None),
        # the edges of the bf16 forward's 128-row tiles and TMA boxes:
        # ragged across a tile (TMA's zero fill) with GQA, less than one
        # tile, and a window edge that no tile boundary meets
        ("gqa_ragged_1000_d128", (2, 8, 1000, 128), 2, torch.bfloat16, True, None),
        ("noncausal_77", (2, 4, 77, 64), 4, torch.bfloat16, False, None),
        ("window_100_d128", (2, 4, 1024, 128), 4, torch.bfloat16, True, 100),
        # the edges of the bf16 backward's tiles: a window narrower than a
        # Q step, s ragged across a 64-row step and a 128-row tile, a
        # group of 4
        ("gqa4_ragged_200_window48", (1, 8, 200, 64), 2, torch.bfloat16,
         True, 48),
    ]


def kernel_phase(torch, device):
    from kubeshare_tpu_torch.ops.attention import flash_forward, flash_forward_reference

    gen = torch.Generator(device=device).manual_seed(1234)
    # worst (relative, absolute) error of each kernel over the shapes; the
    # forward's relative error is not computed (its check is per element)
    worst = {"flash_fwd": [None, 0.0], "flash_bwd_dkv": [0.0, 0.0],
             "flash_bwd_dq": [0.0, 0.0]}
    for name, shape, h_kv, dtype, causal, window in dense_cases(torch):
        b, h, s, d = shape
        q = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        k = torch.randn((b, h_kv, s, d), generator=gen, device=device, dtype=dtype)
        v = torch.randn((b, h_kv, s, d), generator=gen, device=device, dtype=dtype)
        out, lse = flash_forward(q, k, v, causal, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_forward_reference(q, k, v, causal, window)
        err = check_forward(
            torch, f"kernel flash_fwd {name}: shape={shape} h_kv={h_kv} "
            f"{dtype} causal={causal} window={window}",
            out, lse, ref_out, ref_lse)
        worst["flash_fwd"][1] = max(worst["flash_fwd"][1], err)
        bwd = check_backward(torch, name, q, k, v, out, lse, causal, window, gen)
        for kernel, errs in (("flash_bwd_dkv", bwd["dkv"]),
                             ("flash_bwd_dq", bwd["dq"])):
            worst[kernel] = [max(a, b) for a, b in zip(worst[kernel], errs)]
        del q, k, v, out, lse, ref_out, ref_lse

    # times at the serving flagship's attention shape and the training shape
    timings = [time_shape(torch, shape, gen)
               for shape in ((4, 8, 1024, 64), (TRAIN_BATCH, 8, TRAIN_SEQ, 128))]
    return worst, timings


def doc_mask(torch, lengths, block):
    """Block-diagonal mask of documents of ``lengths`` tokens (multiples
    of ``block``): a block sees the blocks of its own document."""
    doc = torch.repeat_interleave(torch.arange(len(lengths)),
                                  torch.tensor(lengths) // block)
    return (doc[:, None] == doc[None, :]).to(torch.int32)


def random_mask(torch, n, density, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((n, n), generator=gen) < density).to(torch.int32)


def block_sparse_cases(torch):
    """(name, (b, h, s, d), h_kv, dtype, block_q, block_k, mask, causal)"""
    bf16, f32 = torch.bfloat16, torch.float32
    docs = doc_mask(torch, (384, 640, 256, 768), 128)
    i = torch.arange(16)
    prefix_lm = ((i[None, :] <= i[:, None]) | (i[None, :] < 4)).to(torch.int32)
    dead = random_mask(torch, 16, 0.5, 21)
    dead[5] = 0  # queries 320-383 see no key
    return [
        ("doc_causal", (2, 8, 2048, 128), 8, bf16, 128, 128, docs, True),
        ("prefix_lm", (4, 8, 1024, 64), 8, bf16, 64, 64, prefix_lm, False),
        ("dead_rows", (2, 8, 1024, 64), 8, bf16, 64, 64, dead, False),
        ("straddle_b32", (2, 4, 1024, 64), 4, bf16, 32, 32,
         random_mask(torch, 32, 0.6, 22), True),
        ("coarse_default", (2, 8, 2048, 128), 8, bf16, 512, 1024,
         torch.tensor([[1, 0], [1, 0], [0, 1], [1, 1]], dtype=torch.int32),
         True),
        ("gqa_hkv2", (2, 8, 2048, 128), 2, bf16, 128, 128, docs, True),
        ("f32_odd_s1000_b40", (2, 4, 1000, 64), 4, f32, 40, 40,
         random_mask(torch, 25, 0.6, 23), True),
        ("f32_d128_doc", (1, 4, 1024, 128), 4, f32, 128, 128,
         doc_mask(torch, (384, 640), 128), True),
    ]


def time_block_sparse(torch, shape, mask, block, gen):
    """Times of the three masked kernels at one bf16 causal MHA shape and
    mask, beside the plain versions, SDPA with the expanded mask and the
    bounds."""
    import torch.nn.functional as F
    from kubeshare_tpu_torch.ops import attention as A

    b, h, s, d = shape
    q, k, v, dout = (torch.randn(shape, generator=gen, device=mask.device,
                                 dtype=torch.bfloat16) for _ in range(4))
    mask = mask.bool()  # read in place by the kernels: nothing but them timed
    args = (mask, True, block, block)
    out, lse = A.block_sparse_forward(q, k, v, *args)
    delta = A._backward_delta(out, dout)
    fwd_ms = time_ms(lambda: A._block_sparse_forward_cuda(q, k, v, *args))
    dkv_ms = time_ms(lambda: A._block_sparse_bwd_dkv_cuda(
        q, k, v, dout, lse, delta, *args))
    dq_ms = time_ms(lambda: A._block_sparse_bwd_dq_cuda(
        q, k, v, dout, lse, delta, *args))
    fwd_plain_ms = time_ms(lambda: A.block_sparse_forward_reference(
        q, k, v, mask, True, block, block))
    bwd_plain_ms = time_ms(lambda: A.block_sparse_backward_reference(
        q, k, v, out, lse, dout, mask, True, block, block))
    # yardsticks only, never on the port's path: SDPA with the element
    # mask (block mask and causal band) as a boolean attn_mask, and its
    # backward as one autograd.grad with the graph kept
    elem = A._element_mask(mask, block, block, s, True)
    fwd_library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=elem))
    ql, kl, vl = (t.clone().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=elem)
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True))
    # the bounds count the operations of the mask's visible pairs, but
    # the dense bytes: every row of out and lse is written (zeros where a
    # row sees nothing), dk and dv in full, and every row of q, k, v and
    # dO meets a visible pair in these masks, so sparsity removes
    # operations and no byte of input or output
    pairs = int(elem.sum())
    print(f"kernel block_sparse mask at {shape} blocks {block}: visible "
          f"pairs per head {pairs} = {pairs / (s * s):.4f} of s^2")
    # the whole op as a caller sees it: forward, delta and both backward
    # kernels, beside SDPA's forward and backward with the mask
    path_ms = time_ms(lambda: torch.autograd.grad(A.block_sparse_attention(
        ql, kl, vl, mask, causal=True, block_q=block, block_k=block),
        (ql, kl, vl), dout))
    library_path_ms = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(ql, kl, vl, attn_mask=elem),
        (ql, kl, vl), dout))
    print(f"block_sparse_attention forward + grad at {shape}: "
          f"{path_ms:.4f} ms; SDPA with the mask forward + grad "
          f"{library_path_ms:.4f} ms")
    rows = {}
    for name, ms, plain_ms, library_ms, bound in (
        ("flash_fwd_block_sparse", fwd_ms, fwd_plain_ms, fwd_library_ms,
         flash_bound(shape, h, "bfloat16", True, None, pairs)),
        ("flash_bwd_dkv_block_sparse", dkv_ms, bwd_plain_ms, bwd_library_ms,
         flash_bwd_bound("dkv", shape, h, "bfloat16", True, None, pairs)),
        ("flash_bwd_dq_block_sparse", dq_ms, bwd_plain_ms, bwd_library_ms,
         flash_bwd_bound("dq", shape, h, "bfloat16", True, None, pairs)),
    ):
        tflops, ratio = achieved(name, shape, ms, library_ms, pairs)
        rows[name] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound[0],
                      "bound_by": bound[1], "visible_pairs": pairs,
                      "tflops": tflops, "library_ratio": ratio}
        print(f"kernel {name} timing at {shape} bf16 causal doc mask: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}); {tflops:.1f} TFLOP/s, {ratio:.3f}x library")
    return rows


def block_sparse_phase(torch, device):
    """The masked kernels against their plain versions at every case,
    block_sparse_attention end to end at doc_causal, and the timings."""
    from kubeshare_tpu_torch.ops import attention as A

    gen = torch.Generator(device=device).manual_seed(4321)
    worst = {"flash_fwd_block_sparse": [None, 0.0],
             "flash_bwd_dkv_block_sparse": [0.0, 0.0],
             "flash_bwd_dq_block_sparse": [0.0, 0.0]}
    launches = None
    for (name, shape, h_kv, dtype, bq, bk, mask,
         causal) in block_sparse_cases(torch):
        b, h, s, d = shape
        mask = mask.to(device)
        q = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        k = torch.randn((b, h_kv, s, d), generator=gen, device=device, dtype=dtype)
        v = torch.randn((b, h_kv, s, d), generator=gen, device=device, dtype=dtype)
        dout = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        args = (mask, causal, bq, bk)
        out, lse = A.block_sparse_forward(q, k, v, *args)
        torch.cuda.synchronize()
        ref_out, ref_lse = A.block_sparse_forward_reference(q, k, v, *args)
        err = check_forward(
            torch, f"kernel flash_fwd_block_sparse {name}: shape={shape} "
            f"h_kv={h_kv} {dtype} blocks=({bq}, {bk}) causal={causal} "
            f"mask density={float((mask != 0).float().mean()):.3f}",
            out, lse, ref_out, ref_lse)
        worst["flash_fwd_block_sparse"][1] = max(
            worst["flash_fwd_block_sparse"][1], err)
        grads = A.block_sparse_backward(q, k, v, out, lse, dout, *args)
        torch.cuda.synchronize()
        ref = A.block_sparse_backward_reference(q, k, v, out, lse, dout, *args)
        bwd = check_grads(torch, f"kernel flash_bwd_block_sparse {name}",
                          grads, ref)
        for kernel, errs in (("flash_bwd_dkv_block_sparse", bwd["dkv"]),
                             ("flash_bwd_dq_block_sparse", bwd["dq"])):
            worst[kernel] = [max(a, b) for a, b in zip(worst[kernel], errs)]
        if name == "dead_rows":
            rows = slice(5 * bq, 6 * bq)
            check(bool((out[:, :, rows] == 0).all())
                  and bool(torch.isneginf(lse[:, :, rows]).all())
                  and bool((grads[0][:, :, rows] == 0).all()),
                  "dead_rows: a query row with no visible key has a nonzero "
                  "out or dq, or a finite lse")
            print("kernel block_sparse dead_rows: out and dq of queries "
                  f"{rows.start}-{rows.stop - 1} are 0, their lse -inf, "
                  "every gradient finite")
        if name == "doc_causal":
            launches = block_sparse_path(torch, q, k, v, dout, args,
                                         (ref_out, ref_lse))
        del q, k, v, dout, out, lse, ref_out, ref_lse, grads, ref
    docs = doc_mask(torch, (384, 640, 256, 768), 128).to(device)
    timing = time_block_sparse(torch, (TRAIN_BATCH, 8, TRAIN_SEQ, 128), docs,
                               128, gen)
    return worst, timing, launches


def block_sparse_path(torch, q, k, v, dout, args, plain_forward):
    """block_sparse_attention forward + autograd.grad, counted, against
    the plain path (the plain forward and backward on the same inputs)."""
    from kubeshare_tpu_torch.ops import attention as A

    mask, causal, bq, bk = args
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_counts()
    out = A.block_sparse_attention(*leaves, mask, causal=causal, block_q=bq,
                                   block_k=bk)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"block_sparse_attention forward + grad at {tuple(q.shape)}: "
          f"launches {launches}")
    check(launches == only("flash_fwd_block_sparse",
                           "flash_bwd_dkv_block_sparse",
                           "flash_bwd_dq_block_sparse"),
          f"block_sparse_attention launched {launches}: expected each "
          f"masked kernel once and no dense kernel")
    ref_out, ref_lse = plain_forward
    check(tuple(out.shape) == tuple(q.shape) and out.dtype == q.dtype,
          f"block_sparse_attention out {tuple(out.shape)} {out.dtype}")
    out = out.detach()
    err = check_out(torch, "block_sparse_attention out vs plain path", out,
                    ref_out)
    print(f"block_sparse_attention out vs plain path: max abs err {err:.3e}")
    ref = A.block_sparse_backward_reference(q, k, v, ref_out, ref_lse, dout,
                                            *args)
    check_grads(torch, "block_sparse_attention grads vs plain path", grads,
                ref)
    oracle = A.block_sparse_reference(q, k, v, *args)
    print("block_sparse_attention out vs block_sparse_reference (bf16 "
          "scores): max abs err "
          f"{float((out.float() - oracle.float()).abs().max()):.3e}")
    return launches


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
    reset_counts()
    t0 = time.perf_counter()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches["forward"] = read_counts()
    check(launches["forward"]["flash_fwd"] == config.n_layers,
          f"forward launched the kernel {launches['forward']['flash_fwd']} "
          f"times, expected {config.n_layers}")
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
    reset_counts()
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
    launches["serve"] = read_counts()

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


def train_setup(torch, device):
    """The train-step flagship's config, params (seed 0) and fixed batch."""
    from kubeshare_tpu_torch.models.transformer import (
        TransformerConfig, transformer_init)

    config = TransformerConfig(**TRAIN_DIMS, positional="rope",
                               dtype=torch.bfloat16, attention="flash")
    params = transformer_init(config, torch.Generator().manual_seed(0), device)
    gen = torch.Generator().manual_seed(11)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    tokens = torch.randint(0, config.vocab_size, shape, generator=gen).to(device)
    targets = torch.randint(0, config.vocab_size, shape, generator=gen).to(device)
    return config, params, tokens, targets


def train_phase(torch, device):
    """Ten AdamW steps of the train-step flagship on a fixed batch."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply
    from kubeshare_tpu_torch.parallel.train import (
        cross_entropy_loss, make_train_step, tree_leaves)

    config, params, tokens, targets = train_setup(torch, device)
    plain = dataclasses.replace(config, attention="reference")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)

    # (a) step 1's loss and gradients against attention="reference"
    def loss_and_grads(cfg):
        loss = cross_entropy_loss(transformer_apply(params, tokens, cfg), targets)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss, grads = loss_and_grads(config)
    reset_counts()
    remat_loss, remat_grads = loss_and_grads(
        dataclasses.replace(config, remat=True))
    remat_launches = read_counts()
    remat_err = max(rel_err(g, r) for g, r in zip(remat_grads, grads))
    del remat_grads
    print(f"train remat: launches {remat_launches} for one forward + "
          f"backward, loss {float(remat_loss):.5f}, worst grad "
          f"max-abs-err/max-ref vs remat off {remat_err:.3e}")
    check(remat_launches == {**only(), "flash_fwd": 2 * config.n_layers,
                             "flash_bwd_dkv": config.n_layers,
                             "flash_bwd_dq": config.n_layers},
          f"remat launched {remat_launches}: expected the forward twice "
          f"per layer and each backward kernel once")
    check(remat_err <= REMAT_GRAD_RTOL,
          f"remat gradients differ from remat off by {remat_err} of max")
    plain_loss, plain_grads = loss_and_grads(plain)
    loss_err = abs(float(loss) - float(plain_loss))
    grad_err = max(rel_err(g, r) for g, r in zip(grads, plain_grads))
    cosine = min(float(torch.nn.functional.cosine_similarity(
        g.float().flatten(), r.float().flatten(), dim=0))
        for g, r in zip(grads, plain_grads))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    del grads, plain_grads
    print(f"train grads vs attention=reference ({len(leaves)} tensors): "
          f"loss {float(loss):.5f} vs {float(plain_loss):.5f} (abs err "
          f"{loss_err:.3e}), worst grad max-abs-err/max-ref {grad_err:.3e}, "
          f"lowest cosine {cosine:.6f}")
    check(finite, "non-finite gradients on the train path")
    check(loss_err <= TRAIN_LOSS_ATOL,
          f"train loss differs from the plain path by {loss_err}")
    check(grad_err <= TRAIN_GRAD_RTOL,
          f"train gradients differ from the plain path by {grad_err} of max")
    check(cosine >= TRAIN_GRAD_MIN_COSINE,
          f"a train gradient points elsewhere than the plain path's "
          f"(cosine {cosine})")

    # (b)-(d) ten steps through make_train_step, counted and timed
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config))
    state = init_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(TRAIN_STEPS)]
    losses, enqueue_ms = [], []
    reset_counts()
    for i, (start, end) in enumerate(events):
        t0 = time.perf_counter()
        start.record()
        state, step_loss = train_step(state, tokens, targets)
        end.record()
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(step_loss)
        if i == 0:
            first = read_counts()
            check(first == {name: n * config.n_layers for name, n in
                             only("flash_fwd", "flash_bwd_dkv",
                                  "flash_bwd_dq").items()},
                  f"train step 1 launched {first}, expected {config.n_layers} "
                  f"of each kernel")
    launches = read_counts()
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    median_ms = steady_median(step_ms)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops_per_token(TRAIN_DIMS, TRAIN_SEQ) * tokens_per_step
    share = flops / (median_ms * 1e-3) / PEAK_FLOPS["bfloat16"]
    # the host's time to enqueue a step (it never waits for the device):
    # close to the step's device time means the host sets the pace
    host_median_ms = steady_median(enqueue_ms)
    print(f"train losses: " + " ".join(f"{x:.4f}" for x in losses))
    print(f"train host enqueue ms per step: "
          + " ".join(f"{x:.2f}" for x in enqueue_ms)
          + f"; median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS} {host_median_ms:.3f}")
    print(f"train {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
          f"launches {launches}, step ms " + " ".join(f"{x:.2f}" for x in step_ms)
          + f"; median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS} "
          f"{median_ms:.3f} ms, {tokens_per_step / (median_ms * 1e-3):.0f} "
          f"tokens/s, {flops / 1e12:.3f} TFLOP per step = {share:.4f} of "
          f"989 TFLOP/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == {name: n * TRAIN_STEPS * config.n_layers for name, n in
                       only("flash_fwd", "flash_bwd_dkv",
                            "flash_bwd_dq").items()},
          f"train path launched {launches}, expected "
          f"{TRAIN_STEPS * config.n_layers} of each kernel")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(abs(losses[0] - float(loss)) <= TRAIN_LOSS_ATOL,
          f"train step 1 loss {losses[0]} differs from the checked {float(loss)}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    eager = {"losses": losses, "params": tree_leaves(state.params),
             "median_ms": median_ms, "host_median_ms": host_median_ms}
    return launches, eager


def steady_median(values):
    """The median of steps TRAIN_TIMED_FROM.. (1-based): past warm-up."""
    tail = sorted(values[TRAIN_TIMED_FROM - 1:])
    return (tail[(len(tail) - 1) // 2] + tail[len(tail) // 2]) / 2


def timed_steps(torch, train_step, state, batches):
    """Run ``train_step`` over ``batches`` ((inputs, targets) pairs);
    returns (state, losses, CUDA-event ms per step, host enqueue ms per
    step).  The host never waits for the device inside the loop."""
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in batches]
    losses, enqueue_ms = [], []
    for (start, end), (inputs, targets) in zip(events, batches):
        t0 = time.perf_counter()
        start.record()
        state, loss = train_step(state, inputs, targets)
        end.record()
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    torch.cuda.synchronize()
    return (state, [float(x) for x in losses],
            [a.elapsed_time(b) for a, b in events], enqueue_ms)


def update_errors(final, reference, initial):
    """Per tensor, |final - reference| / |reference - initial| (norms:
    the difference of two runs over the reference run's whole update),
    the worst of them, and the largest element difference."""
    worst, max_abs = 0.0, 0.0
    for got, ref, first in zip(final, reference, initial):
        diff = (got.detach().float() - ref.detach().float())
        update = (ref.detach().float() - first.float()).norm()
        worst = max(worst, float(diff.norm() / update.clamp_min(1e-30)))
        max_abs = max(max_abs, float(diff.abs().max()))
    return worst, max_abs


def capturable_adamw(device):
    """adamw(1e-3) switched to its capturable mode, as the captured step
    switches it: the optimizer of the eager run held to the captured."""
    from kubeshare_tpu_torch.parallel.train import _make_capturable, adamw

    def make(leaves):
        optimizer = adamw(1e-3)(leaves)
        _make_capturable(optimizer, device)
        return optimizer
    return make


def hold_captured(label, captured, same, default, initial,
                  drift_loss_atol, drift_update_rtol):
    """The captured run's (losses, parameters) against the eager run with
    the same optimizer (limits at CAPTURE_SAME_*) and against the default
    eager run (step 1 at CAPTURE_SAME_LOSS_ATOL, then the drift limits)."""
    rows = {}
    for name, other in (("same optimizer", same), ("default AdamW", default)):
        loss_err = max(abs(a - b) for a, b in zip(captured[0], other[0]))
        update_err, max_abs = update_errors(captured[1], other[1], initial)
        rows[name] = (abs(captured[0][0] - other[0][0]), loss_err, update_err)
        limits = ((CAPTURE_SAME_LOSS_ATOL, CAPTURE_SAME_UPDATE_RTOL)
                  if name == "same optimizer"
                  else (drift_loss_atol, drift_update_rtol))
        print(f"{label} captured vs eager with the {name}: loss max abs "
              f"err {loss_err:.3e} (tol {limits[0]:g}), params worst "
              f"|diff| / |eager update| {update_err:.3e} (tol "
              f"{limits[1]:g}), max abs diff {max_abs:.3e}")
    check(all(math.isfinite(x) for x in captured[0]),
          f"{label}: non-finite loss {captured[0]}")
    _, loss_err, update_err = rows["same optimizer"]
    check(loss_err <= CAPTURE_SAME_LOSS_ATOL
          and update_err <= CAPTURE_SAME_UPDATE_RTOL,
          f"{label}: the captured step differs from the eager step with the "
          f"same optimizer (loss {loss_err}, update {update_err})")
    first, loss_err, update_err = rows["default AdamW"]
    check(first <= CAPTURE_SAME_LOSS_ATOL,
          f"{label}: step 1's loss differs from the default eager step's "
          f"by {first}")
    check(loss_err <= drift_loss_atol and update_err <= drift_update_rtol,
          f"{label}: the captured run drifted from the default eager run "
          f"(loss {loss_err}, update {update_err})")


def capture_phase(torch, device, eager):
    """The train-step flagship's 10 steps through make_train_step(...,
    capture=True) from the train phase's initial state and batch, held
    against an eager run with the same optimizer and the train phase's
    default eager run; the launch counters read around the capture
    (replays do not bump them)."""
    from kubeshare_tpu_torch.models.transformer import transformer_apply
    from kubeshare_tpu_torch.parallel.train import (
        CAPTURE_WARMUP_STEPS, make_train_step, tree_leaves)

    def setup(capture):
        config, params, tokens, targets = train_setup(torch, device)
        init_state, train_step = make_train_step(
            lambda p, t: transformer_apply(p, t, config),
            optimizer=None if capture else capturable_adamw(device),
            capture=capture)
        return (config, init_state(params), train_step,
                [(tokens, targets)] * TRAIN_STEPS)

    config, state, train_step, batches = setup(capture=False)
    initial = [leaf.detach().clone() for leaf in tree_leaves(state.params)]
    state, same_losses, _, _ = timed_steps(torch, train_step, state, batches)
    same = (same_losses, tree_leaves(state.params))
    del state, train_step
    config, state, train_step, batches = setup(capture=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, losses, step_ms, enqueue_ms = timed_steps(torch, train_step,
                                                     state, batches)
    launches = read_counts()
    passes = (CAPTURE_WARMUP_STEPS + 1) * config.n_layers
    check(launches == {name: n * passes for name, n in
                       only("flash_fwd", "flash_bwd_dkv",
                            "flash_bwd_dq").items()},
          f"captured train path launched {launches}, expected {passes} of "
          f"each kernel ({CAPTURE_WARMUP_STEPS} warm-up passes and the "
          f"capture, {config.n_layers} layers; replays bump no counter)")
    median_ms, host_ms = steady_median(step_ms), steady_median(enqueue_ms)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    print(f"train captured losses: " + " ".join(f"{x:.4f}" for x in losses))
    print(f"train captured {TRAIN_STEPS} steps (step 1 = {CAPTURE_WARMUP_STEPS} "
          f"warm-up steps + capture + replay): launches {launches}, step ms "
          + " ".join(f"{x:.2f}" for x in step_ms)
          + f"; host enqueue ms " + " ".join(f"{x:.3f}" for x in enqueue_ms))
    print(f"train step, median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS}: "
          f"captured {median_ms:.3f} ms (CUDA events), enqueue "
          f"{host_ms:.3f} ms, {tokens_per_step / (median_ms * 1e-3):.0f} "
          f"tokens/s; eager {eager['median_ms']:.3f} ms, enqueue "
          f"{eager['host_median_ms']:.3f} ms; captured / eager "
          f"{median_ms / eager['median_ms']:.4f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    hold_captured("train", (losses, tree_leaves(state.params)), same,
                  (eager["losses"], eager["params"]), initial,
                  CAPTURE_DRIFT_LOSS_ATOL, CAPTURE_DRIFT_UPDATE_RTOL)
    guard_check(torch, train_step, state, batches[0], median_ms)
    return launches, {"median_ms": median_ms, "host_median_ms": host_ms}


def guard_check(torch, train_step, state, batch, step_ms):
    """GUARD_STEPS captured steps through an ExecutionGuard, the step
    returning only its TrainState: the guard must charge at least
    GUARD_MIN_SHARE of the step's CUDA-event time ``step_ms`` a step."""
    from kubeshare_tpu_torch.isolation import ExecutionGuard

    class GrantAll:
        """A broker that grants every request in full."""

        def acquire(self, estimate_ms):
            return 1e9

        def release(self, used_ms):
            pass

    guard = ExecutionGuard(client=GrantAll(), from_env=False,
                           idle_release_ms=0)
    gated = guard(lambda s: train_step(s, *batch)[0])
    torch.cuda.synchronize()
    for _ in range(GUARD_STEPS):
        state = gated(state)
    charged_ms = guard.total_gated_ms / GUARD_STEPS
    print(f"guard around the captured step returning its state: charged "
          f"{charged_ms:.3f} ms a step, {charged_ms / step_ms:.4f} of the "
          f"step's {step_ms:.3f} ms (tol >= {GUARD_MIN_SHARE})")
    check(charged_ms >= GUARD_MIN_SHARE * step_ms,
          f"the guard charged {charged_ms} ms a step for a {step_ms} ms "
          "device burst: it did not wait for the step's device")


def mnist_phase(torch, device):
    """MNIST (the co-run's workload, batch 512, weights converted from a
    numpy tree) on the card: its logits against the CPU's, and
    MNIST_STEPS captured train steps against eager ones, timed."""
    import numpy as np

    from kubeshare_tpu_torch.convert import params_from_jax
    from kubeshare_tpu_torch.models.mnist import mnist_apply, mnist_init
    from kubeshare_tpu_torch.parallel.train import (
        cross_entropy_loss, make_train_step, tree_leaves)

    tree = mnist_init(torch.Generator().manual_seed(0), device="cpu")
    weights = {layer: {name: leaf.numpy() for name, leaf in leaves.items()}
               for layer, leaves in tree.items()}
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal(
        (8192, 28, 28, 1), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (8192,), dtype=np.int64))
    starts = [torch.tensor(int(s), device=device) for s in
              rng.integers(0, 8192 - MNIST_BATCH, MNIST_STEPS)]

    with torch.no_grad():
        cpu_logits = mnist_apply(tree, images[:MNIST_BATCH])
        logits = mnist_apply(params_from_jax(weights, device),
                             images[:MNIST_BATCH].to(device)).cpu()
    logits_err = float((logits - cpu_logits).abs().max())
    print(f"mnist logits {tuple(logits.shape)} on the card vs the CPU: max "
          f"abs err {logits_err:.3e} (tol {MNIST_LOGITS_ATOL}; |logits| up "
          f"to {float(cpu_logits.abs().max()):.2f})")
    check(logits_err <= MNIST_LOGITS_ATOL,
          f"MNIST logits on the card differ from the CPU's by {logits_err}")

    images, labels = images.to(device), labels.to(device)
    rows = torch.arange(MNIST_BATCH, device=device)

    def run(capture=False, optimizer=None):
        init_state, train_step = make_train_step(
            lambda p, start: mnist_apply(
                p, images.index_select(0, start + rows)),
            loss_fn=lambda logits, start: cross_entropy_loss(
                logits, labels.index_select(0, start + rows)),
            optimizer=optimizer, capture=capture)
        state = init_state(params_from_jax(weights, device))
        state, losses, step_ms, enqueue_ms = timed_steps(
            torch, train_step, state, [(s, s) for s in starts])
        return (losses, tree_leaves(state.params)), step_ms, enqueue_ms

    default, eager_ms, eager_enqueue = run()
    same, _, _ = run(optimizer=capturable_adamw(device))
    captured, step_ms, enqueue_ms = run(capture=True)
    print(f"mnist {MNIST_STEPS} steps of batch {MNIST_BATCH}: captured "
          "losses " + " ".join(f"{x:.5f}" for x in captured[0]))
    print(f"mnist step, median of steps {TRAIN_TIMED_FROM}-{MNIST_STEPS}: "
          f"captured {steady_median(step_ms):.4f} ms (CUDA events), "
          f"enqueue {steady_median(enqueue_ms):.4f} ms; eager "
          f"{steady_median(eager_ms):.4f} ms, enqueue "
          f"{steady_median(eager_enqueue):.4f} ms")
    hold_captured("mnist", captured, same, default,
                  [torch.from_numpy(leaf).to(device)
                   for leaf in tree_leaves(weights)],
                  MNIST_DRIFT_LOSS_ATOL, MNIST_DRIFT_UPDATE_RTOL)


def hbm_cap_phase():
    """apply_hbm_cap at TPUSHARE_MEM_FRACTION=0.5 in a child process (the
    fraction is process-wide): 0.4 of the card allocates, 0.6 raises
    torch.OutOfMemoryError."""
    import os
    import textwrap

    code = textwrap.dedent("""
        import json, torch
        from kubeshare_tpu_torch.isolation import apply_hbm_cap
        fraction = apply_hbm_cap()
        total = torch.cuda.get_device_properties(0).total_memory
        held = torch.empty(int(0.4 * total), dtype=torch.uint8, device="cuda")
        del held
        try:
            torch.empty(int(0.6 * total), dtype=torch.uint8, device="cuda")
            refused = None
        except torch.OutOfMemoryError as e:
            refused = str(e).splitlines()[0]
        print(json.dumps({"fraction": fraction, "total": total,
                          "refused": refused}))
    """)
    env = dict(os.environ, TPUSHARE_MEM_FRACTION="0.5")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"HBM cap child failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"hbm cap at TPUSHARE_MEM_FRACTION=0.5: apply_hbm_cap returned "
          f"{result['fraction']}; 0.4 of {result['total'] / 2**30:.2f} GiB "
          f"allocated; 0.6 refused: {result['refused']}")
    check(result["fraction"] == 0.5,
          f"apply_hbm_cap returned {result['fraction']}, expected 0.5")
    check(result["refused"] is not None,
          "0.6 of the card was allocated under a 0.5 cap")


def corun_phase():
    """corun_bench.py's four phases (solo A, solo B, the co-run, the
    adversarial pair) at CORUN_SECONDS windows: each phase must produce
    a result and every pod must be granted tokens.  The ratio and the
    adversarial flags are reported, not gated."""
    import corun_bench

    t0 = time.perf_counter()
    result = corun_bench.run_suite(corun_bench.ensure_tokend(),
                                   seconds=CORUN_SECONDS)
    detail = result["detail"]
    tokens = detail["tokens"]
    print(f"corun ratio {result['value']:.4f} ({CORUN_SECONDS:g} s windows, "
          f"{time.perf_counter() - t0:.1f} s in all): solo steps/s "
          f"{detail['solo_a_steps_per_s']:.2f} + "
          f"{detail['solo_b_steps_per_s']:.2f}, co-run "
          + " + ".join(f"{r:.2f}" for r in detail["corun_steps_per_s"])
          + f" = {detail['corun_aggregate_steps_per_s']:.2f}; solo step ms "
          f"{detail['solo_step_ms']}; tokens {json.dumps(tokens)}; "
          f"breakdown_ms {json.dumps(detail['breakdown_ms'])}; adversarial "
          f"{json.dumps(detail['adversarial'])}")
    granted = [tokens["solo_a"], tokens["solo_b"], *tokens["corun"],
               *tokens["adversarial"]]
    check(all(n > 0 for n in granted), f"a pod was granted no token: {tokens}")


def profile_train(torch, device, capture: bool, warmup: int = 3,
                  steps: int = 5):
    """Steady train steps (eager, or captured: one graph replay a step)
    under torch.profiler: host enqueue and wall time per step, device
    busy share, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from kubeshare_tpu_torch.models.transformer import transformer_apply
    from kubeshare_tpu_torch.parallel.train import make_train_step

    config, params, tokens, targets = train_setup(torch, device)
    init_state, train_step = make_train_step(
        lambda p, t: transformer_apply(p, t, config), capture=capture)
    state = init_state(params)
    mode = "captured" if capture else "eager"
    for _ in range(warmup):
        state, _ = train_step(state, tokens, targets)
    torch.cuda.synchronize()
    enqueue_s = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            t1 = time.perf_counter()
            state, _ = train_step(state, tokens, targets)
            enqueue_s.append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = []
    for event in prof.key_averages():
        # kernels only: a CPU op's row, and a range such as
        # "Optimizer.step#AdamW.step" on the device's timeline, carry their
        # kernels' time as well
        if (not str(event.device_type).endswith("CUDA")
                or getattr(event, "is_user_annotation", False)):
            continue
        device_us = getattr(event, "self_device_time_total",
                            getattr(event, "self_cuda_time_total", 0))
        if device_us > 0:
            rows.append((device_us, event.count, event.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3 / steps
    launches = sum(r[1] for r in rows) / steps
    wall_ms = wall_s * 1e3 / steps
    print(f"profile {mode} train step ({steps} steps after {warmup} warm-up, "
          f"profiler on): wall {wall_ms:.3f} ms per step, host enqueue "
          + " ".join(f"{x * 1e3:.2f}" for x in enqueue_s) + " ms, device "
          f"busy {device_ms:.3f} ms per step = {device_ms / wall_ms:.4f} "
          f"of wall, {launches:.0f} device kernels and copies per step")
    check(device_ms > 0, "the profiler saw no device time")
    for device_us, count, name in rows[:40]:
        print(f"profile {mode} kernel {device_us / 1e3 / steps:9.4f} ms/step "
              f"{count // steps:5d} calls/step  {name[:110]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "launches_per_step": launches,
            "enqueue_ms": [x * 1e3 for x in enqueue_s]}


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
    build_logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for source, log in sorted(build_logs.items()):
        for kernel, registers, spill in kernel_resources(log):
            print(f"build {source}.cu {kernel}: {registers} registers, "
                  f"{spill} bytes spilled")
        for line in log.splitlines():
            if "Potential Performance Loss" in line:
                print(f"build {source}.cu ptxas: {line.split('info    : ')[-1]}")
    # the bf16 kernels run on wgmma and TMA: their SASS must hold them
    sass = {}
    for source in ("flash_fwd", "flash_bwd"):
        counts = sass_counts(library_sass(_build.library_path(source)))
        for kernel, ops in sorted(counts.items()):
            print(f"build {source}.cu {kernel} SASS: "
                  + ", ".join(f"{op} {n}" for op, n in ops.items()))
            check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0
                  and ops["UTMASTG"] > 0,
                  f"{kernel} issues no wgmma or TMA")
        sass.update(counts)
    check(len(sass) == 4 * len(SASS_KERNELS),
          f"bf16 instantiations in the SASS: {sorted(sass)}")

    if "--profile-train" in sys.argv[1:]:
        result = {mode: profile_train(torch, device, capture)
                  for mode, capture in (("eager", False), ("captured", True))}
        print(card)
        print(json.dumps({"profile_train": result}))
        return 0

    hbm_cap_phase()
    worst, timings = kernel_phase(torch, device)
    bs_worst, bs_timing, bs_launches = block_sparse_phase(torch, device)
    worst.update(bs_worst)
    launches = slice_phase(torch, device)
    launches["train"], eager = train_phase(torch, device)
    launches["train_captured"], _ = capture_phase(torch, device, eager)
    launches["block_sparse"] = bs_launches
    del eager
    torch.cuda.empty_cache()
    mnist_phase(torch, device)
    corun_phase()

    fwd_src = "kubeshare_tpu_torch/csrc/flash_fwd.cu"
    bwd_src = "kubeshare_tpu_torch/csrc/flash_bwd.cu"
    jax_src = "kubeshare_tpu/ops/attention.py"
    # name: (source, TPU kernel, mode, timings); the headline numbers are
    # at the shape of the path that runs the kernel most: serving's for the
    # dense forward, training's for the dense backward, the document mask
    # at the training shape for the masked kernels
    sources = {
        "flash_fwd": (fwd_src, f"{jax_src}:107", "dense", timings),
        "flash_bwd_dkv": (bwd_src, f"{jax_src}:278", "dense", timings),
        "flash_bwd_dq": (bwd_src, f"{jax_src}:330", "dense", timings),
        "flash_fwd_block_sparse": (fwd_src, f"{jax_src}:107", "has_mask",
                                   [bs_timing]),
        "flash_bwd_dkv_block_sparse": (bwd_src, f"{jax_src}:278", "has_mask",
                                       [bs_timing]),
        "flash_bwd_dq_block_sparse": (bwd_src, f"{jax_src}:330", "has_mask",
                                      [bs_timing]),
    }
    kernels = []
    for name, (source, replaces, mode, kernel_timings) in sources.items():
        main_timing = kernel_timings[1 if name in ("flash_bwd_dkv",
                                                   "flash_bwd_dq") else 0][name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "mode": mode,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": worst[name][1],
            "max_rel_err": worst[name][0],
            "ms": main_timing["ms"],
            "plain_ms": main_timing["plain_ms"],
            "bound_ms": main_timing["bound_ms"],
            "bound_by": main_timing["bound_by"],
            "library_ms": main_timing["library_ms"],
            "timed_shape": main_timing["shape"],
            "timings": [t[name] for t in kernel_timings],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
