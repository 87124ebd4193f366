"""MNIST CNN — the north-star workload (BASELINE.md: two 0.5-chip MNIST
pods co-run on one card).  Port of kubeshare_tpu/models/mnist.py.

The parameter tree keeps the JAX layout — conv weights HWIO, dense
weights ``[in, out]`` — so ``convert.params_from_jax`` carries a JAX
tree over 1:1; the activations are NHWC at the interface, as in JAX.
The convolutions and dense layers are library calls (``F.conv2d``,
``@``): the JAX model computes them with ``lax.conv_general_dilated`` and
``@``, outside any Pallas kernel, so no kernel is on this path.

Precision: float32 throughout.  On a CUDA card PyTorch's default runs
f32 convolutions in TF32 (products ``@`` stay full f32); the port's
scripts (``corun_bench.py``, ``chip_smoke.py``) turn that off, so the
whole model computes in f32 as on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..parallel.spmd import data_parallel_apply, mesh_of


@dataclass(frozen=True)
class MnistConfig:
    num_classes: int = 10
    channels1: int = 32
    channels2: int = 64
    hidden: int = 128
    image_size: int = 28


def mnist_init(generator: torch.Generator, config: MnistConfig = MnistConfig(),
               device=None) -> Dict:
    """f32 parameters with the JAX init's shapes and scales (He normal,
    zero biases), drawn from ``generator`` (a CPU generator, so one seed
    gives the same weights on every device) and moved to ``device``."""
    device = resolve_device(device)
    reduced = config.image_size // 4  # two stride-2 pools
    flat = reduced * reduced * config.channels2

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * (2.0 / fan_in) ** 0.5).to(device)

    def conv(shape):
        return normal(shape, shape[0] * shape[1] * shape[2])

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "conv1": {"w": conv((3, 3, 1, config.channels1)),
                  "b": zeros(config.channels1)},
        "conv2": {"w": conv((3, 3, config.channels1, config.channels2)),
                  "b": zeros(config.channels2)},
        "dense1": {"w": normal((flat, config.hidden), flat),
                   "b": zeros(config.hidden)},
        "dense2": {"w": normal((config.hidden, config.num_classes),
                               config.hidden),
                   "b": zeros(config.num_classes)},
    }


def mnist_apply(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images: [batch, 28, 28, 1] (NHWC) -> logits [batch, classes].

    Mesh-aware: a tree of ``ShardedTensor`` leaves (``shard_params``,
    e.g. ``make_train_step(..., mesh=mesh, param_rules={})``) runs the
    data-parallel program (``parallel.spmd.data_parallel_apply``): each
    work unit takes its rows of the batch and the logits come back as a
    ``ShardedTensor`` split along the batch."""
    mesh = mesh_of(params, images)
    if mesh is not None:
        return data_parallel_apply(_forward, params, images, mesh)
    return _forward(params, images)


def _forward(params: Dict, images: torch.Tensor) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)  # NCHW for conv2d
    for layer in ("conv1", "conv2"):
        w = params[layer]["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        # "SAME" for a 3 x 3 window at stride 1 is one pixel each side
        x = F.relu(F.conv2d(x, w, params[layer]["b"], padding=1))
        x = F.max_pool2d(x, kernel_size=2, stride=2)  # 2 x 2, "VALID"
    # flatten in NHWC order, as the JAX model does: dense1's rows are
    # (row, column, channel), channel fastest
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["dense1"]["w"] + params["dense1"]["b"])
    return x @ params["dense2"]["w"] + params["dense2"]["b"]
