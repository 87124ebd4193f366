#!/usr/bin/env python3
"""Gang-member CIFAR ResNet training pod on a CUDA card (BASELINE config
3, examples/cifar10-gang-job.yaml): the PyTorch port's twin of
``examples/train_cifar.py``.

    python3 train_cifar_torch.py                      # ResNetConfig(), batch 128
    python3 train_cifar_torch.py --small --steps 20   # a tiny model
    python3 train_cifar_torch.py --ckpt-dir ckpt      # save, and resume

The pod installs its device-memory cap (``TPUSHARE_MEM_FRACTION``) before
anything touches the card, then trains with the port's pieces: random
CIFAR-shaped images from a seed in a ``ShardedBatchLoader`` (its
process's slice of each global batch), ``prefetch_to_device`` (pinned
copies on a side stream), ``make_train_step(resnet_apply, capture=True)``
(one CUDA graph replay a step), each step gated by the ``ExecutionGuard``
(a passthrough without a token daemon).  ``--ckpt-dir`` saves a
checkpoint every ``CKPT_EVERY`` steps and at the end, and resumes from
the latest one: the restore copies into the state the captured step
replays, and the loader skips to the resumed step's batch.  ``--device
cpu`` runs the eager step on the CPU (tests).
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

DATASET_SIZE = 4096  # random images, as examples/train_cifar.py
LOG_EVERY = 50  # steps, as examples/train_cifar.py
CKPT_EVERY = 100  # steps between checkpoints (and one at the end)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--small", action="store_true",
                        help="tiny model for smoke runs")
    parser.add_argument("--ckpt-dir", default=None,
                        help="save checkpoints here and resume from the "
                             "latest")
    parser.add_argument("--device", default=None, choices=("cpu",),
                        help="run on the CPU (tests); the default is the "
                             "CUDA card")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubeshare_tpu_torch.isolation import apply_hbm_cap

    apply_hbm_cap(device=args.device)

    import numpy as np
    import torch

    from kubeshare_tpu_torch import resolve_device
    from kubeshare_tpu_torch.data import ShardedBatchLoader, prefetch_to_device
    from kubeshare_tpu_torch.isolation import ExecutionGuard
    from kubeshare_tpu_torch.models.resnet import (ResNetConfig, resnet_apply,
                                                   resnet_init)
    from kubeshare_tpu_torch.parallel.checkpoint import (latest_checkpoint,
                                                         restore_checkpoint,
                                                         save_checkpoint)
    from kubeshare_tpu_torch.parallel.train import make_train_step

    device = resolve_device(args.device)
    capture = device.type == "cuda"
    if capture:
        torch.cuda.set_device(device)
        # the convolutions in full f32 (models/resnet.py)
        torch.backends.cudnn.allow_tf32 = False
    guard = ExecutionGuard()
    config = (ResNetConfig(widths=(8, 16), blocks_per_stage=(1, 1))
              if args.small else ResNetConfig())
    rng = np.random.default_rng(0)
    arrays = {"images": rng.standard_normal((DATASET_SIZE, 32, 32, 3),
                                            dtype=np.float32),
              "labels": rng.integers(0, 10, (DATASET_SIZE,), dtype=np.int64)}
    loader = ShardedBatchLoader(arrays, args.batch, seed=0)

    init_state, train_step = make_train_step(
        lambda p, x: resnet_apply(p, x, config), capture=capture)
    state = init_state(resnet_init(torch.Generator().manual_seed(0), config,
                                   device=device))
    start_step = 0
    if args.ckpt_dir and latest_checkpoint(args.ckpt_dir) is not None:
        state = restore_checkpoint(args.ckpt_dir, into=state)
        start_step = state.step
        print(f"resumed from step {start_step}", flush=True)
    epoch, skip = divmod(start_step, loader.batches_per_epoch)
    batches = itertools.islice(loader.epochs(epoch), skip, None)
    batches = prefetch_to_device(batches, size=2, sharding=device)

    losses = []
    start = time.monotonic()
    for step_idx in range(start_step, args.steps):
        batch = next(batches)
        guard.acquire()
        t0 = time.monotonic()
        state, loss = train_step(state, batch["images"], batch["labels"])
        if capture:
            torch.cuda.synchronize(device)
        guard.charge((time.monotonic() - t0) * 1e3)
        losses.append(float(loss))
        done = step_idx + 1
        if done % LOG_EVERY == 0:
            rate = (done - start_step) / (time.monotonic() - start)
            print(f"step {done} loss {losses[-1]:.4f} {rate:.1f} steps/s",
                  flush=True)
        if args.ckpt_dir and (done % CKPT_EVERY == 0 or done == args.steps):
            save_checkpoint(args.ckpt_dir, state, done)
    guard.finish()
    return {"start_step": start_step, "losses": losses, "state": state}


if __name__ == "__main__":
    main()
