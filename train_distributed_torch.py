#!/usr/bin/env python3
"""Multi-process gang worker on CUDA cards: the PyTorch port's twin of
``examples/train_distributed.py`` (the pod of examples/distributed-ddp.yaml).

    # each gang member, with the scheduler's env (TPUSHARE_GANG_SIZE,
    # TPUSHARE_GANG_RANK, TPUSHARE_COORDINATOR or TPUSHARE_GANG_NAME):
    python3 train_distributed_torch.py [--steps 200] [--batch 32] [--tp 1] [--sp 1] [--seq 256]
    python3 train_distributed_torch.py --backend gloo     # several ranks on one card
    python3 train_distributed_torch.py --small --device cpu   # on the CPU (gloo)
    python3 train_distributed_torch.py --tp 2   # two pods: dp=1 x tp=2 across them

Bootstraps ``torch.distributed`` from the gang env first
(``initialize_from_env``; a solo pod runs single-process), then:

- ``--tp`` or ``--sp`` above 1 over a gang: the mesh of the gang's ranks,
  ``make_mesh(MeshSpec(dp=-1, tp, sp))``, as the JAX script's
  ``make_mesh`` over the multi-process ``jax.devices()`` (one GPU a
  rank): every rank draws the same weights from seed 0 and keeps its own
  shards under ``transformer_sharding_rules()``, takes the whole global
  batch and steps through ``make_train_step(mesh=...)``, one sharded
  program across the processes.  Two one-GPU pods at ``--tp 2`` are dp=1
  x tp=2: each holds half of every tp-split weight, and the tp partial
  sums cross the processes.
- ``--tp 1 --sp 1`` over a gang: data parallelism across the ranks, each
  on its own rows of the global batch through ``make_train_step(mesh=
  <[device]>, process_group=True)``, which broadcasts rank 0's
  parameters at the start and averages the gradients every step.
- a solo pod: the mesh over ``[device] * (tp * sp)``, one controller
  running the shards in turn.

The model is the JAX script's at full width (vocab 8192, d 512, 8 heads,
6 layers, d_ff 2048, bf16, attention "auto": the flash kernels on
CUDA); ``--small`` is its tiny f32 CPU model.

The backend is NCCL on CUDA and gloo on the CPU; NCCL refuses two ranks
on one GPU ("Duplicate GPU detected"), so ranks that share a card pass
``--backend gloo``.  Every 20 steps (and at the last) each rank prints
``[proc r/n] step s loss l x steps/s``, the rate read from CUDA events.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=32,
                        help="global batch, split over the ranks")
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1)
    parser.add_argument("--seq", type=int, default=256)
    parser.add_argument("--small", action="store_true",
                        help="tiny model for CPU smoke runs")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="torch.distributed backend (default: nccl on "
                             "CUDA, gloo on the CPU)")
    parser.add_argument("--device", default=None, choices=("cpu",),
                        help="run on the CPU (tests); the default is the "
                             "CUDA card")
    return parser.parse_args(argv)


def model_config(args: argparse.Namespace):
    """The JAX script's two configurations."""
    import torch

    from kubeshare_tpu_torch.models.transformer import TransformerConfig

    if args.small:
        return TransformerConfig(
            vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=max(64, args.seq), dtype=torch.float32,
            attention="reference")
    return TransformerConfig(
        vocab_size=8192, d_model=512, n_heads=8, n_layers=6, d_ff=2048,
        max_seq_len=max(512, args.seq))


def global_batch(config, args: argparse.Namespace):
    """The global batch [batch, seq] of token ids, drawn on the CPU from
    seed 1 (the same on every rank)."""
    import torch

    return torch.randint(0, config.vocab_size, (args.batch, args.seq),
                         generator=torch.Generator().manual_seed(1))


def rank_rows(tokens, rank: int, world: int):
    """Rank ``rank``'s contiguous rows of the global batch."""
    if tokens.shape[0] % world != 0:
        raise ValueError(f"global batch {tokens.shape[0]} does not split "
                         f"over {world} ranks")
    rows = tokens.shape[0] // world
    return tokens[rank * rows:(rank + 1) * rows]


def rank_mesh_run(args: argparse.Namespace, distributed: bool) -> bool:
    """Whether the gang's ranks form one mesh: tp or sp above 1 over a
    gang (otherwise the ranks are data-parallel replicas)."""
    return distributed and args.tp * args.sp > 1


def rank_tokens(tokens, args: argparse.Namespace, rank: int, world: int):
    """What a rank passes to its step: the whole global batch over a
    mesh of ranks (the step places this rank's part), its own rows
    otherwise."""
    if rank_mesh_run(args, world > 1):
        return tokens
    return rank_rows(tokens, rank, world)


def setup(args: argparse.Namespace, device, distributed: bool,
          **step_options):
    """(config, init_state, train_step, params): the model (weights from
    seed 0) and its step: over a gang with tp or sp above 1, the mesh of
    the gang's ranks (this rank on ``device``); otherwise the mesh over
    ``[device] * (tp * sp)`` and, when ``distributed``, the data-parallel
    step (``process_group=True``).  ``step_options``, e.g.
    ``capture=True``, go to ``make_train_step``."""
    import torch

    from kubeshare_tpu_torch.models.transformer import (
        transformer_apply, transformer_init, transformer_sharding_rules)
    from kubeshare_tpu_torch.parallel import MeshSpec, make_mesh, make_train_step

    config = model_config(args)
    spec = MeshSpec(dp=-1, tp=args.tp, sp=args.sp)
    ranked = rank_mesh_run(args, distributed)
    mesh = (make_mesh(spec, device=device) if ranked else
            make_mesh(spec, devices=[device] * (args.tp * args.sp)))
    init_state, train_step = make_train_step(
        lambda p, x: transformer_apply(p, x, config), mesh=mesh,
        param_rules=transformer_sharding_rules(),
        process_group=True if distributed and not ranked else None,
        **step_options)
    params = transformer_init(config, torch.Generator().manual_seed(0), device)
    return config, init_state, train_step, params


def main(argv=None) -> dict:
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from kubeshare_tpu_torch import resolve_device
    from kubeshare_tpu_torch.parallel import tree_leaves
    from kubeshare_tpu_torch.parallel.distributed import initialize_from_env

    device = resolve_device(args.device)
    # before any collective: the gang env's rendezvous
    spec = initialize_from_env(backend=args.backend, device=device)
    rank, world = (spec.process_id, spec.num_processes) if spec else (0, 1)
    config, init_state, train_step, params = setup(args, device,
                                                   spec is not None)
    state = init_state(params)
    tokens = rank_tokens(global_batch(config, args), args, rank,
                         world).to(device)
    param_bytes = sum(p.numel() * p.element_size()
                      for g in state.opt_state.param_groups
                      for p in g["params"])
    mesh = next(iter(tree_leaves(state.params))).mesh
    print(f"[proc {rank}/{world}] mesh {mesh.shape}"
          f"{' over the ranks' if rank_mesh_run(args, world > 1) else ''}; "
          f"parameter bytes {param_bytes}", flush=True)
    on_card = device.type == "cuda"
    start = torch.cuda.Event(enable_timing=True) if on_card else None
    t0 = time.perf_counter()
    if on_card:
        start.record()
    losses = []
    for step_idx in range(args.steps):
        state, loss = train_step(state, tokens, tokens)
        losses.append(loss)
        if (step_idx + 1) % 20 == 0 or step_idx + 1 == args.steps:
            if on_card:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
                elapsed_s = start.elapsed_time(end) / 1e3
            else:
                elapsed_s = time.perf_counter() - t0
            print(f"[proc {rank}/{world}] step {step_idx + 1} loss "
                  f"{float(loss):.4f} {(step_idx + 1) / elapsed_s:.1f} steps/s",
                  flush=True)
    if spec is not None:
        torch.distributed.destroy_process_group()
    return {"rank": rank, "world": world, "mesh": dict(mesh.shape),
            "param_bytes": param_bytes,
            "losses": [float(x) for x in losses]}


if __name__ == "__main__":
    main()
