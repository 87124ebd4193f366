#!/usr/bin/env python3
"""Time the flash kernels against variants of their design.

    python3 flash_ablations.py [variant ...]   # every variant by default

Each variant is a copy of kubeshare_tpu_torch/csrc (under the git-ignored
kubeshare_tpu_torch/_build/ablations/) with one edit to one source, from
which the libraries of the kernels it changes are built like the shipped
ones, all nvcc processes at once; the shipped kernels carry no switch.
On one CUDA card, at each shape of the variant's dtype (SHAPES), the
variant's kernels are checked against their plain versions and timed
beside the shipped ones in turns (shipped, variant, variant, shipped).
An accuracy control (a design the f32 limits must refuse) is reported
against chip_smoke.py's limits instead of held to them, and
chip_smoke.py's f32 phase runs once with the shipped kernels and once
with each control, its readings printed beside the F32_* limits.
Prints each variant's registers and spills, one line per (variant,
kernel, shape) and the card; exits non-zero without a card or when a
shipped kernel, or a variant that is not a control, disagrees with its
plain version.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import chip_smoke

# name: (what it changes, the source edited under csrc/, the dtype of the
# kernels it changes, the kernels timed, whether it is an accuracy
# control, [(text in the source, its replacement)])
VARIANTS = {
    "dq_no_pingpong": (
        "the dQ consumers issue without taking turns",
        "flash_bwd.cu", "bfloat16", ("dkv", "dq"), False,
        [("auto my_turn = [&]() { named_barrier_sync(kTurnBarrier + cw, 256); };",
          "auto my_turn = [&]() {};"),
         ("        named_barrier_arrive(kTurnBarrier + (cw ^ 1), 256);\n",
          "")]),
    "dkv_order_per_head": (
        "dK/dV blocks go head by head, K tile 0 first in each",
        "flash_bwd.cu", "bfloat16", ("dkv", "dq"), False,
        [("    const int lin =\n        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
          "    kv_row = lin % heads;",
          "    const int lin = blockIdx.y + gridDim.y * blockIdx.z + heads * blockIdx.x;\n"
          "    kv_row = lin % heads;")]),
    "stages3": (
        "three stages in both rings",
        "flash_bwd.cu", "bfloat16", ("dkv", "dq"), False,
        [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
    "fwd_tiles64": (
        "forward K/V tiles of 64 keys at d = 64 (32 at d = 128)",
        "flash_fwd.cu", "float32", ("fwd",), False,
        [("  static constexpr int kBK = 32;",
          "  static constexpr int kBK = 4096 / D;")]),
    "fwd_no_cap": (
        "forward without the d = 128 register cap",
        "flash_fwd.cu", "float32", ("fwd",), False,
        [("__launch_bounds__(kThreads, D == 128 ? 3 : 1)",
          "__launch_bounds__(kThreads)")]),
    "dkv_steps32": (
        "dK/dV with 32-query steps at d = 128 (64 at d = 64)",
        "flash_bwd.cu", "float32", ("dkv",), False,
        [("  static constexpr int kStep = D == 64 ? 64 : 16;",
          "  static constexpr int kStep = D == 64 ? 64 : 32;")]),
    "dkv_no_partials": (
        "dK/dV accumulating every step on the tensor cores",
        "flash_bwd.cu", "float32", ("dkv",), True,
        [("mma_3xtf32(part[n], aj, b_rows_permuted<kLd>(b, n0 + n));",
          "mma_3xtf32(acc[n0 + n], aj, b_rows_permuted<kLd>(b, n0 + n));")]),
    "dq_rows64": (
        "dQ blocks of 64 rows (4 warps) at d = 128: 135 KB, one an SM",
        "flash_bwd.cu", "float32", ("dq",), False,
        [("  static constexpr int kRows = D == 64 ? 64 : 128;",
          "  static constexpr int kRows = 64;")]),
    "dq_keys16": (
        "dQ blocks of 64 rows with 16-key tiles at d = 128: 101 KB, two an SM",
        "flash_bwd.cu", "float32", ("dq",), False,
        [("  static constexpr int kRows = D == 64 ? 64 : 128;",
          "  static constexpr int kRows = 64;"),
         ("  static constexpr int kBK = 32;",
          "  static constexpr int kBK = D == 64 ? 32 : 16;")]),
    "dq_q_shared": (
        "dQ reading Q's fragments from shared memory at d = 64 too",
        "flash_bwd.cu", "float32", ("dq",), False,
        [("  constexpr bool kQInRegs = D == 64;",
          "  constexpr bool kQInRegs = false;")]),
    "dq_cap3": (
        "dQ capped at three blocks' registers (170) at d = 64",
        "flash_bwd.cu", "float32", ("dq",), False,
        [("__launch_bounds__(DqF32<D>::kThreads, 1)",
          "__launch_bounds__(DqF32<D>::kThreads, D == 64 ? 3 : 1)")]),
    "dq_no_partials": (
        "dQ accumulating every tile on the tensor cores",
        "flash_bwd.cu", "float32", ("dq",), True,
        [("mma_3xtf32(part[n], da[j], b_rows_permuted<kLd>(kj, n0 + n));",
          "mma_3xtf32(dq_acc[n0 + n], da[j], "
          "b_rows_permuted<kLd>(kj, n0 + n));")]),
    "one_pass": (
        "one TF32 pass (big x big) for every f32 product",
        "flash_common.cuh", "float32", ("fwd", "dkv", "dq"), True,
        [("  mma_tf32(d, a.small, b.big);\n  mma_tf32(d, a.big, b.small);\n",
          "")]),
}
LIBRARY = {"fwd": "flash_fwd", "dkv": "flash_bwd", "dq": "flash_bwd"}
# (shape, under the document mask of chip_smoke.py, causal), per dtype;
# at f32 also a non-causal shape, where every row of dq sums all s keys
SHAPES = {
    "bfloat16": (((2, 8, 2048, 128), False, True),
                 ((4, 8, 1024, 64), False, True),
                 ((2, 8, 2048, 128), True, True)),
    "float32": (((4, 8, 1024, 64), False, True),
                ((2, 8, 2048, 128), False, True),
                ((2, 8, 2048, 128), False, False)),
}


def libraries(name):
    return sorted({LIBRARY[kernel] for kernel in VARIANTS[name][3]})


def build(_build, names):
    """{name: {library: loaded library}} of each named variant, every
    nvcc process started at once; prints the changed kernels' registers
    and spills."""
    procs = []
    for name in names:
        _, source, _, _, _, edits = VARIANTS[name]
        root = _build.BUILD_DIR / "ablations" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(_build.CSRC, root)
        text = (root / source).read_text()
        for old, new in edits:
            chip_smoke.check(text.count(old) == 1,
                             f"{name}: the edit no longer applies to {source}")
            text = text.replace(old, new)
        (root / source).write_text(text)
        for stem in libraries(name):
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                   str(root / f"lib{stem}.so"), str(root / f"{stem}.cu")]
            procs.append((name, stem, root, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs = {name: {} for name in names}
    for name, stem, root, proc in procs:
        log, _ = proc.communicate()
        chip_smoke.check(proc.returncode == 0,
                         f"{name}: nvcc failed for {stem}.cu\n{log}")
        f32 = VARIANTS[name][2] == "float32"
        for kernel, registers, spill in chip_smoke.kernel_resources(log):
            if (kernel.startswith(chip_smoke.F32_SASS_KERNELS) if f32
                    else "bf16" in kernel):
                print(f"build {name} {stem}.cu {kernel}: {registers} "
                      f"registers, {spill} bytes spilled")
        lib = ctypes.CDLL(str(root / f"lib{stem}.so"))
        for symbol, argtypes in _build.SIGNATURES[stem].items():
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = ctypes.c_int
        libs[name][stem] = lib
    return libs


def use(_build, loaded):
    """Load {library: loaded library} in the wrappers' place."""
    _build._loaded.update(loaded)


def kernels_at(torch, A, shape, dtype, mask, causal, gen):
    """({kernel: call}, {kernel: errors of a call's result}) at one
    shape: each kernel's call on the same inputs, and its error against
    its plain version with whether that is within chip_smoke.py's limit."""
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda",
                                 dtype=dtype) for _ in range(4))
    if mask is None:
        ref_out, _ = A.flash_forward_reference(q, k, v, causal)
        out, lse = A.flash_forward(q, k, v, causal)
        ref = A.flash_backward_reference(q, k, v, out, lse, dout, causal)
        fwd = lambda: A.flash_forward(q, k, v, causal)
        dkv = lambda: A._flash_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                            causal, None)
        dq = lambda: A._flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal,
                                          None)
    else:
        args = (mask, causal, 128, 128)
        ref_out, _ = A.block_sparse_forward_reference(q, k, v, *args)
        out, lse = A.block_sparse_forward(q, k, v, *args)
        ref = A.block_sparse_backward_reference(q, k, v, out, lse, dout,
                                                *args)
        fwd = lambda: A.block_sparse_forward(q, k, v, *args)
        dkv = lambda: A._block_sparse_bwd_dkv_cuda(q, k, v, dout, lse,
                                                   delta, *args)
        dq = lambda: A._block_sparse_bwd_dq_cuda(q, k, v, dout, lse, delta,
                                                 *args)
    delta = A._backward_delta(out, dout)
    name = str(dtype).removeprefix("torch.")
    tol = chip_smoke.TOLERANCES[name]
    bwd_tol = chip_smoke.BWD_TOLERANCES[name]

    def fwd_err(result):
        err = (result[0].float() - ref_out.float()).abs()
        within = bool((err <= tol["out_atol"] + tol["out_rtol"]
                       * ref_out.float().abs()).all())
        return f"out max abs err {float(err.max()):.3e}", within

    def dkv_err(result):
        err = max(chip_smoke.rel_err(result[0], ref[1]),
                  chip_smoke.rel_err(result[1], ref[2]))
        return f"dk/dv max err / max |ref| {err:.3e}", err <= bwd_tol

    def dq_err(result):
        err = chip_smoke.rel_err(result, ref[0])
        return f"dq max err / max |ref| {err:.3e}", err <= bwd_tol

    return ({"fwd": fwd, "dkv": dkv, "dq": dq},
            {"fwd": fwd_err, "dkv": dkv_err, "dq": dq_err})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_ablations: no CUDA device", file=sys.stderr)
        return 1
    from kubeshare_tpu_torch.ops import _build
    from kubeshare_tpu_torch.ops import attention as A

    names = sys.argv[1:] or list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    chip_smoke.check(not unknown, f"no variants {unknown}: {list(VARIANTS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    shipped = {stem: _build.load(stem) for stem in ("flash_fwd", "flash_bwd")}
    libs = build(_build, names)
    gen = torch.Generator(device="cuda").manual_seed(99)
    docs = chip_smoke.doc_mask(torch, (384, 640, 256, 768), 128).cuda().bool()
    for dtype_name, shapes in SHAPES.items():
        mine = [n for n in names if VARIANTS[n][2] == dtype_name]
        if not mine:
            continue
        timed = sorted({kernel for n in mine for kernel in VARIANTS[n][3]})
        for shape, masked, causal in shapes:
            label = (f"{shape} {dtype_name} "
                     + ("causal" if causal else "non-causal")
                     + (" doc mask" if masked else ""))
            calls, errors = kernels_at(torch, A, shape,
                                       getattr(torch, dtype_name),
                                       docs if masked else None, causal,
                                       gen)
            for name in ("shipped", *mine):
                use(_build, shipped if name == "shipped" else libs[name])
                for kernel in timed if name == "shipped" else VARIANTS[name][3]:
                    result = calls[kernel]()
                    torch.cuda.synchronize()
                    what, within = errors[kernel](result)
                    control = name != "shipped" and VARIANTS[name][4]
                    print(f"{name} {kernel} at {label}: {what}, within "
                          f"chip_smoke.py's limit: {within}")
                    chip_smoke.check(within or control,
                                     f"{name} {kernel} disagrees at {label}")
                use(_build, shipped)
            for name in mine:
                what, _, _, kernels, _, _ = VARIANTS[name]
                for kernel in kernels:
                    times = []
                    for which in ("shipped", name, name, "shipped"):
                        use(_build, shipped if which == "shipped"
                            else libs[which])
                        times.append(chip_smoke.time_ms(calls[kernel],
                                                        iters=50))
                    use(_build, shipped)
                    print(f"ablation {name} ({what}): {kernel} at {label}: "
                          f"shipped {times[0]:.4f} / {times[3]:.4f} ms, "
                          f"variant {times[1]:.4f} / {times[2]:.4f} ms")
            del calls, errors
            torch.cuda.empty_cache()
    controls = [n for n in names if VARIANTS[n][4]]
    limits = {"forward_logits": chip_smoke.F32_LOGITS_ATOL,
              "prefill_logits": chip_smoke.F32_LOGITS_ATOL,
              "token_gap": chip_smoke.F32_TOKEN_MARGIN,
              "loss": chip_smoke.F32_TRAIN_LOSS_ATOL,
              "grad_rel": chip_smoke.F32_TRAIN_GRAD_RTOL,
              "grad_cosine": chip_smoke.F32_TRAIN_GRAD_MIN_COSINE}
    for name in ("shipped", *controls) if controls else ():
        use(_build, shipped if name == "shipped" else libs[name])
        _, readings = chip_smoke.f32_phase(torch, torch.device("cuda", 0),
                                           hold=False)
        use(_build, shipped)
        torch.cuda.empty_cache()
        print(f"f32 phase with {name}: " + ", ".join(
            f"{key} {value:.7g} (limit {limits[key]})"
            for key, value in readings.items()))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
