"""CIFAR ResNet — the gang-job workload (BASELINE config 3: cifar10 Job,
parallelism 5, group coscheduling).  Port of kubeshare_tpu/models/resnet.py.

ResNet-18-style basic blocks, GroupNorm instead of BatchNorm (no
cross-replica batch statistics: under a dp mesh each unit normalises its
own samples, so the split is exact).  The parameter tree keeps the JAX
layout — conv weights HWIO, the head ``[in, out]`` — so
``convert.params_from_jax`` carries a JAX tree over 1:1; the images are
NHWC at the interface, as in JAX.  The convolutions, group norms and the
head are library calls (``F.conv2d``, ``F.group_norm``, ``@``): the JAX
model computes them with ``lax.conv_general_dilated``, jnp and ``@``,
outside any Pallas kernel, so no kernel is on this path.

Padding: JAX's ``padding="SAME"`` pads a window of ``k`` at stride ``s``
over ``n`` pixels by ``max((ceil(n / s) - 1) * s + k - n, 0)`` in all,
the low side getting half of it rounded down.  At stride 2 over an even
size that is (0, 1) for a 3 x 3 window — all of it on the high side —
and (0, 0) for the 1 x 1 projection; PyTorch's symmetric ``padding=1``
would shift every downsampled map by a pixel.  :func:`_same_padding`
computes JAX's split and :func:`_conv` pads with it.

Precision: float32 throughout.  On a CUDA card PyTorch's default runs
f32 convolutions in TF32; the port's scripts turn that off, so the model
computes in f32 as on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..parallel.spmd import data_parallel_apply, mesh_of


@dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    blocks_per_stage: Tuple[int, ...] = (2, 2, 2, 2)
    groups: int = 8


def _same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """JAX's "SAME" split of the padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x NCHW, w HWIO -> NCHW, "SAME" padding as JAX pads it."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_padding(x.shape[2], kh, stride)
    left, right = _same_padding(x.shape[3], kw, stride)
    weight = w.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if top == bottom and left == right:
        return F.conv2d(x, weight, stride=stride, padding=(top, left))
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, weight, stride=stride)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int) -> torch.Tensor:
    """Normalise over (h, w, c / groups), consecutive channels a group, by
    the population variance with eps 1e-5 inside the rsqrt, then the
    per-channel scale and bias: JAX's ``_group_norm``."""
    return F.group_norm(x, groups, scale, bias, eps=1e-5)


def resnet_init(generator: torch.Generator,
                config: ResNetConfig = ResNetConfig(), device=None) -> Dict:
    """f32 parameters with the JAX init's shapes and scales (He normal
    convolutions, unit scales, zero biases, a normal head at
    sqrt(1 / width)), drawn from ``generator`` (a CPU generator, so one
    seed gives the same weights on every device) and moved to
    ``device``."""
    device = resolve_device(device)

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * std).to(device)

    def conv(shape):
        return normal(shape, (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5)

    def norm(width, w):
        return {"w": w,
                "scale": torch.ones((width,), dtype=torch.float32,
                                    device=device),
                "bias": torch.zeros((width,), dtype=torch.float32,
                                    device=device)}

    params: Dict = {"stem": norm(config.widths[0],
                                 conv((3, 3, 3, config.widths[0]))),
                    "stages": []}
    in_ch = config.widths[0]
    for width, n_blocks in zip(config.widths, config.blocks_per_stage):
        stage: List[Dict] = []
        for block_idx in range(n_blocks):
            stride = 2 if (block_idx == 0 and width != in_ch) else 1
            block = {"conv1": norm(width, conv((3, 3, in_ch, width))),
                     "conv2": norm(width, conv((3, 3, width, width)))}
            if stride != 1 or in_ch != width:
                block["proj"] = {"w": conv((1, 1, in_ch, width))}
            stage.append(block)
            in_ch = width
        params["stages"].append(stage)
    params["head"] = {
        "w": normal((in_ch, config.num_classes), (1.0 / in_ch) ** 0.5),
        "b": torch.zeros((config.num_classes,), dtype=torch.float32,
                         device=device),
    }
    return params


def _forward(params: Dict, images: torch.Tensor,
             config: ResNetConfig) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)  # NHWC -> NCHW (a channels-last view)
    stem = params["stem"]
    x = F.relu(_group_norm(_conv(x, stem["w"]), stem["scale"], stem["bias"],
                           config.groups))
    for stage in params["stages"]:
        for block in stage:
            # a projection exists exactly when the block downsamples
            stride = 2 if "proj" in block else 1
            c1, c2 = block["conv1"], block["conv2"]
            y = _conv(x, c1["w"], stride)
            y = F.relu(_group_norm(y, c1["scale"], c1["bias"], config.groups))
            y = _group_norm(_conv(y, c2["w"]), c2["scale"], c2["bias"],
                            config.groups)
            residual = (_conv(x, block["proj"]["w"], stride)
                        if "proj" in block else x)
            x = F.relu(residual + y)
    x = x.mean(dim=(2, 3))
    return x @ params["head"]["w"] + params["head"]["b"]


def resnet_apply(params: Dict, images: torch.Tensor,
                 config: ResNetConfig = ResNetConfig()) -> torch.Tensor:
    """images: [batch, height, width, 3] (NHWC) -> logits [batch, classes].

    Mesh-aware: a tree of ``ShardedTensor`` leaves (``shard_params``,
    e.g. ``make_train_step(..., mesh=mesh, param_rules={})``) runs the
    data-parallel program (``parallel.spmd.data_parallel_apply``): each
    work unit takes its rows of the batch and the logits come back as a
    ``ShardedTensor`` split along the batch."""
    mesh = mesh_of(params, images)
    if mesh is not None:
        return data_parallel_apply(
            lambda p, x: _forward(p, x, config), params, images, mesh)
    return _forward(params, images, config)
