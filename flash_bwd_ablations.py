#!/usr/bin/env python3
"""Time the bf16 backward kernels against variants of their design.

    python3 flash_bwd_ablations.py

Each variant is a copy of kubeshare_tpu_torch/csrc (under the git-ignored
kubeshare_tpu_torch/_build/) with one edit to flash_bwd.cu, built like
the shipped library; the shipped kernels carry no switch.  On one CUDA
card, each variant's dK/dV and dQ kernels are checked against the plain
backward and timed beside the shipped ones in turns (shipped, variant,
variant, shipped) at the training shape (2, 8, 2048, 128), the serving
shape (4, 8, 1024, 64) and the document mask of chip_smoke.py.  Prints
one line per (variant, kernel, shape) and the card; exits non-zero
without a card or when a variant disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import chip_smoke

# name: (what it changes, [(text in flash_bwd.cu, its replacement)])
VARIANTS = {
    "dq_no_pingpong": (
        "the dQ consumers issue without taking turns",
        [("auto my_turn = [&]() { named_barrier_sync(kTurnBarrier + cw, 256); };",
          "auto my_turn = [&]() {};"),
         ("        named_barrier_arrive(kTurnBarrier + (cw ^ 1), 256);\n",
          "")]),
    "dkv_order_per_head": (
        "dK/dV blocks go head by head, K tile 0 first in each",
        [("    const int lin =\n        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
          "    kv_row = lin % heads;",
          "    const int lin = blockIdx.y + gridDim.y * blockIdx.z + heads * blockIdx.x;\n"
          "    kv_row = lin % heads;")]),
    "stages3": (
        "three stages in both rings",
        [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]),
}


def build(torch, _build):
    """{name: loaded library}: the shipped one and each variant's."""
    libs = {"shipped": _build.load("flash_bwd")}
    procs = []
    for name, (_, edits) in VARIANTS.items():
        root = _build.BUILD_DIR / "ablations" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(_build.CSRC, root)
        source = (root / "flash_bwd.cu").read_text()
        for old, new in edits:
            chip_smoke.check(source.count(old) == 1,
                             f"{name}: the edit no longer applies to flash_bwd.cu")
            source = source.replace(old, new)
        (root / "flash_bwd.cu").write_text(source)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
               str(root / "lib.so"), str(root / "flash_bwd.cu")]
        procs.append((name, root, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, root, proc in procs:
        log, _ = proc.communicate()
        chip_smoke.check(proc.returncode == 0, f"{name}: nvcc failed\n{log}")
        for kernel, registers, spill in chip_smoke.kernel_resources(log):
            if "bf16" in kernel:
                print(f"build {name} {kernel}: {registers} registers, "
                      f"{spill} bytes spilled")
        lib = ctypes.CDLL(str(root / "lib.so"))
        for symbol, argtypes in _build.SIGNATURES["flash_bwd"].items():
            getattr(lib, symbol).argtypes = argtypes
            getattr(lib, symbol).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_ablations: no CUDA device", file=sys.stderr)
        return 1
    from kubeshare_tpu_torch.ops import _build
    from kubeshare_tpu_torch.ops import attention as A

    card = chip_smoke.card_line()
    libs = build(torch, _build)
    gen = torch.Generator(device="cuda").manual_seed(99)
    docs = chip_smoke.doc_mask(torch, (384, 640, 256, 768), 128).cuda().bool()
    for shape, mask in (((2, 8, 2048, 128), None), ((4, 8, 1024, 64), None),
                        ((2, 8, 2048, 128), docs)):
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda",
                                     dtype=torch.bfloat16) for _ in range(4))
        if mask is None:
            label = f"{shape} causal"
            out, lse = A.flash_forward(q, k, v, True)
            ref = A.flash_backward_reference(q, k, v, out, lse, dout, True)
            grads = lambda: A.flash_backward(q, k, v, out, lse, dout, True)
            kernels = {
                "dkv": lambda: A._flash_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                                     True, None),
                "dq": lambda: A._flash_bwd_dq_cuda(q, k, v, dout, lse, delta,
                                                   True, None)}
        else:
            label = f"{shape} causal doc mask"
            args = (mask, True, 128, 128)
            out, lse = A.block_sparse_forward(q, k, v, *args)
            ref = A.block_sparse_backward_reference(q, k, v, out, lse, dout,
                                                    *args)
            grads = lambda: A.block_sparse_backward(q, k, v, out, lse, dout,
                                                    *args)
            kernels = {
                "dkv": lambda: A._block_sparse_bwd_dkv_cuda(
                    q, k, v, dout, lse, delta, *args),
                "dq": lambda: A._block_sparse_bwd_dq_cuda(
                    q, k, v, dout, lse, delta, *args)}
        delta = A._backward_delta(out, dout)
        for name, lib in libs.items():
            _build._loaded["flash_bwd"] = lib
            got = grads()
            torch.cuda.synchronize()
            chip_smoke.check_grads(torch, f"{name} at {label}", got, ref)
        for kernel, fn in kernels.items():
            for name in VARIANTS:
                times = []
                for which in ("shipped", name, name, "shipped"):
                    _build._loaded["flash_bwd"] = libs[which]
                    times.append(chip_smoke.time_ms(fn, iters=50))
                print(f"ablation {name} ({VARIANTS[name][0]}): {kernel} at "
                      f"{label}: shipped {times[0]:.4f} / {times[3]:.4f} ms, "
                      f"variant {times[1]:.4f} / {times[2]:.4f} ms")
        del q, k, v, dout, out, lse, delta, ref
    _build._loaded["flash_bwd"] = libs["shipped"]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
