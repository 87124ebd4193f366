#!/usr/bin/env python3
"""Long-context training on a CUDA card: the PyTorch port's twin of
``examples/train_longcontext.py``.

    python3 train_longcontext_torch.py          # dp=2 x tp=2 x sp=2, fsdp, zigzag ring
    python3 train_longcontext_torch.py --pp     # 1F1B pp=2 x sp=4, ring in-stage
    python3 train_longcontext_torch.py --device cpu   # on the CPU (tests)

Trains the flagship Transformer on synthetic next-token data with the
long-context pieces engaged, over a mesh that names the one device eight
times (``[cuda:0] * 8``; one controller runs the shards in turn):

  - the default: zero-style (fsdp) parameter and optimizer sharding over
    dp, tensor parallelism over tp, and the load-balanced zigzag ring
    over sp (the einsum ring, as the JAX walkthrough asks), through
    ``make_train_step(mesh=..., param_rules=transformer_fsdp_rules())``;
  - ``--pp``: the 1F1B pipeline schedule (``transformer_train_1f1b``)
    with the ring inside each stage (the hybrid ring on the card: the
    flash kernel on its diagonal blocks), gradients for every parameter,
    AdamW.

The sizes are the JAX walkthrough's (4 steps, batch 4 x 128 tokens, 4
layers, vocab 256) but for the heads: 2 heads of 128 / 2 = 64, the
smallest head_dim the flash kernels take (the walkthrough's d_model 64 /
8 heads gives 8).  Asserts, as the JAX script does, that the last loss is
below the first.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--pp", action="store_true",
                        help="1F1B pipeline x sp instead of dp x tp x sp")
    parser.add_argument("--device", default=None, choices=("cpu",),
                        help="run on the CPU (tests); the default is the "
                             "CUDA card")
    return parser.parse_args(argv)


N_DEVICES = 8  # the JAX walkthrough's forced host device count


def main(argv=None) -> dict:
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    from kubeshare_tpu_torch import resolve_device
    from kubeshare_tpu_torch.models.transformer import (
        TransformerConfig, transformer_apply_ring, transformer_fsdp_rules,
        transformer_init, transformer_train_1f1b)
    from kubeshare_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import (adamw, make_train_step,
                                                    tree_leaves)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    config = TransformerConfig(
        vocab_size=256, d_model=128, n_heads=2, n_layers=4, d_ff=256,
        max_seq_len=args.seq, dtype=torch.float32, attention="ring",
        positional="rope")
    params = transformer_init(config, torch.Generator().manual_seed(0),
                              device)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, config.vocab_size, (args.batch, args.seq))).to(device)
    targets = torch.roll(tokens, -1, dims=1)
    optimizer = adamw(3e-4)
    devices = [device] * N_DEVICES
    losses = []

    if args.pp:
        # 1F1B x sp: microbatches hop the pipeline stages while the ring
        # runs over sp inside each stage; gradients cover every parameter
        pp, sp = 2, N_DEVICES // 2
        array = np.empty(pp * sp, dtype=object)
        array[:] = devices
        mesh = Mesh(array.reshape(pp, sp), ("pp", "sp"))
        print(f"mesh: 1f1b pp={pp} x sp={sp} (ring attention in-stage) on "
              f"{N_DEVICES} x {device}")
        leaves = tree_leaves(params)
        opt = optimizer(leaves)
        for i in range(args.steps):
            loss, grads = transformer_train_1f1b(
                params, tokens, targets, config, mesh, num_microbatches=2)
            for leaf, grad in zip(leaves, tree_leaves(grads)):
                leaf.grad = grad
            opt.step()
            opt.zero_grad(set_to_none=True)
            losses.append(float(loss))
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    else:
        # dp x tp x sp: fsdp-placed parameters and the zigzag ring
        spec = MeshSpec(dp=2, tp=2, sp=2)
        mesh = make_mesh(spec, devices=devices)
        print(f"mesh: dp={spec.dp} x tp={spec.tp} x sp={spec.sp} on "
              f"{N_DEVICES} x {device}, fsdp params, zigzag ring")
        init_state, train_step = make_train_step(
            lambda p, t: transformer_apply_ring(p, t, config, mesh,
                                                layout="zigzag",
                                                use_flash=False),
            mesh=mesh, param_rules=transformer_fsdp_rules(),
            optimizer=optimizer)
        state = init_state(params)
        for i in range(args.steps):
            state, loss = train_step(state, tokens, targets)
            losses.append(float(loss))
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not improve: {losses}")
    print("long-context training demo complete")
    return {"losses": losses}


if __name__ == "__main__":
    main()
