#!/usr/bin/env python3
"""Fractional-share MNIST training pod on a CUDA card
(examples/mnist-fractional.yaml): the PyTorch port's twin of
``examples/train_mnist.py``.

    python3 train_mnist_torch.py                          # 1,000 steps, batch 256
    python3 train_mnist_torch.py --checkpoint-dir ckpt    # save every 200, resume
    python3 train_mnist_torch.py --small --device cpu --steps 6   # tests

It runs as the scheduler launches it: the pod's memory cap
(``TPUSHARE_MEM_FRACTION``) is installed before anything touches the
card, then the port's MNIST CNN trains on the JAX example's synthetic
dataset (8,192 images and labels from ``np.random.default_rng(0)``) with
``make_train_step(mnist_apply, capture=True)``, one CUDA graph replay a
step.  ``--checkpoint-dir`` (default ``$CKPT_DIR``) saves every
``--checkpoint-every`` steps and resumes from the latest checkpoint,
restored into the state the captured step replays.  ``--device cpu``
runs the eager step on the CPU (tests); ``--small`` a narrow model.

The gate, decided from the process: under the port's scheduler the pod's
env preloads the CUDA driver interposer (``LD_PRELOAD=libcudahook.so.1``
beside ``POD_MANAGER_PORT``), which gates every launch through the pod
manager and charges the device time it measures.  An ``ExecutionGuard``
built from the same env would take tokens a second time from the same
pod manager and charge each step twice.  So when the hook is loaded in
this process (``isolation.hook.preloaded()``) the script builds no guard;
otherwise it builds ``ExecutionGuard()`` from the env, which is a
passthrough when no broker is configured (a pod outside the framework).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

DATASET_SIZE = 8192  # as examples/train_mnist.py's synthetic_dataset
LOG_EVERY = 100  # steps, as examples/train_mnist.py


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--checkpoint-dir",
                        default=os.environ.get("CKPT_DIR", ""))
    parser.add_argument("--checkpoint-every", type=int, default=200)
    parser.add_argument("--small", action="store_true",
                        help="narrow model for smoke runs")
    parser.add_argument("--device", default=None, choices=("cpu",),
                        help="run on the CPU (tests); the default is the "
                             "CUDA card")
    return parser.parse_args(argv)


def synthetic_dataset(n=DATASET_SIZE, seed=0):
    """examples/train_mnist.py's dataset, as numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, (n,), dtype=np.int32)
    return images, labels


def main(argv=None) -> dict:
    """Train; returns the summary: the gate, the losses, each step's
    CUDA-event ms (on the card), the hook's counters when it gates, and
    the final ``state``."""
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubeshare_tpu_torch.isolation import apply_hbm_cap

    apply_hbm_cap(device=args.device)

    import torch

    from kubeshare_tpu_torch import resolve_device
    from kubeshare_tpu_torch.isolation import ExecutionGuard, hook
    from kubeshare_tpu_torch.models.mnist import (MnistConfig, mnist_apply,
                                                  mnist_init)
    from kubeshare_tpu_torch.parallel.checkpoint import (latest_checkpoint,
                                                         restore_checkpoint,
                                                         save_checkpoint)
    from kubeshare_tpu_torch.parallel.train import make_train_step

    device = resolve_device(args.device)
    capture = device.type == "cuda"
    if capture:
        torch.cuda.set_device(device)
        # the convolutions in full f32, as the products (models/mnist.py)
        torch.backends.cudnn.allow_tf32 = False
    hooked = hook.preloaded()
    guard = None if hooked else ExecutionGuard()
    config = (MnistConfig(channels1=4, channels2=8, hidden=16)
              if args.small else MnistConfig())
    images_np, labels_np = synthetic_dataset()
    images = torch.from_numpy(images_np).to(device)
    labels = torch.from_numpy(labels_np).long().to(device)
    init_state, train_step = make_train_step(mnist_apply, capture=capture)
    state = init_state(mnist_init(torch.Generator().manual_seed(0), config,
                                  device=device))

    start_step = 0
    if args.checkpoint_dir and latest_checkpoint(args.checkpoint_dir) is not None:
        state = restore_checkpoint(args.checkpoint_dir, into=state)
        start_step = state.step
        print(f"resumed from step {start_step}", flush=True)

    losses, events, hook_first = [], [], None
    start = time.monotonic()
    while state.step < args.steps:
        i = (state.step * args.batch) % (DATASET_SIZE - args.batch)
        batch_images = images[i:i + args.batch]
        batch_labels = labels[i:i + args.batch]
        if guard is not None:
            guard.acquire()
        t0 = time.monotonic()
        if capture:
            began = torch.cuda.Event(enable_timing=True)
            ended = torch.cuda.Event(enable_timing=True)
            began.record()
        state, loss = train_step(state, batch_images, batch_labels)
        if capture:
            ended.record()
            ended.synchronize()
            events.append((began, ended))
        if guard is not None:
            guard.charge((time.monotonic() - t0) * 1e3)
        losses.append(float(loss))
        if hooked and hook_first is None:
            # the hook's charge after the first step (its capture): the
            # charge of steps 2.. is the end's minus this
            hook.settle()
            hook_first = hook.live_stats()["charged_ms"]
        done = len(losses)
        if args.checkpoint_dir and state.step % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint_dir, state, state.step)
        if done % LOG_EVERY == 0:
            rate = done / (time.monotonic() - start)
            print(f"step {state.step} loss {losses[-1]:.4f} "
                  f"{rate:.1f} steps/s gate={'hook' if hooked else 'guard'} "
                  f"gated={hooked or guard.gated}", flush=True)
    wall_s = time.monotonic() - start
    summary = {
        "device": (torch.cuda.get_device_name(device) if capture else "cpu"),
        "gate": "hook" if hooked else ("guard" if guard.gated else "none"),
        "start_step": start_step, "steps": len(losses), "losses": losses,
        "wall_s": wall_s,
        "steps_per_s": len(losses) / wall_s if losses else 0.0,
        "step_ms": [b.elapsed_time(e) for b, e in events],
        "state": state,
    }
    if guard is not None:
        guard.finish()
        summary["guard"] = {"tokens": guard.tokens_acquired,
                            "gated_ms": guard.total_gated_ms}
    if hooked:
        hook.settle()
        stats = hook.live_stats()
        summary["hook"] = {key: stats[key] for key in (
            "acquires", "graph_launches", "charged_ms")}
        summary["hook"]["charged_ms_after_first_step"] = hook_first
    if losses:
        print(f"done: {state.step} steps, final loss {losses[-1]:.4f}",
              flush=True)
    return summary


if __name__ == "__main__":
    main()
