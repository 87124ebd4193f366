"""All-to-all (Ulysses-style) sequence parallelism, port of
kubeshare_tpu/ops/ulysses.py.

The second long-context strategy beside the ring
(``ops/ring_attention.py``): two all-to-alls re-shard a group's
activations from sequence-split to head-split, each member attends over
the FULL sequence on its share of the heads, and the output is swapped
back:

    [b, h, s/sp, d]  --all_to_all-->  [b, h/sp, s, d]
                     local attention (the flash kernel at full s)
    [b, h/sp, s, d]  --all_to_all-->  [b, h, s/sp, d]

A group is written as in ``ops/ring_attention.py``: on one controller
the list of its members' local q, k, v in member order, the swaps
``parallel.spmd.all_to_all`` (the collective the tensor-parallel serving
route, ``serving/sharded.py``, uses); over a mesh of ranks this rank's
member alone, the swaps the rank all-to-all over its sp line
(``spmd.RankGroup``), whose size is the group's degree.  The local attention is the port's
differentiable :func:`~kubeshare_tpu_torch.ops.attention.flash_attention`
(the forward, dK/dV and dQ kernels on CUDA) or the plain reference;
autograd differentiates the swaps (an all-to-all's transpose is the
mirrored all-to-all).  Needs heads divisible by the group size.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..parallel.mesh import Mesh, P, ShardedTensor
from .attention import attention_reference, flash_attention, use_kernel_default
from .ring_attention import group_of, over_sequence_groups


def _local_attention(q, k, v, causal: bool, window: Optional[int],
                     use_flash: Optional[bool]) -> torch.Tensor:
    """``flash_attention``'s dispatch: the flash path when ``use_flash``
    (None: the kernel on CUDA, ``use_kernel_default``), the reference
    otherwise."""
    if use_flash is None:
        use_flash = use_kernel_default(q.device)
    if use_flash:
        return flash_attention(q, k, v, causal=causal, window=window)
    return attention_reference(q, k, v, causal=causal, window=window)


def ulysses_attention(qs: List[torch.Tensor], ks: List[torch.Tensor],
                      vs: List[torch.Tensor], devices=None,
                      causal: bool = True, window: Optional[int] = None,
                      use_flash: Optional[bool] = None) -> List[torch.Tensor]:
    """Ulysses attention over a group: ``qs[i]``, ``ks[i]``, ``vs[i]``
    are the local [batch, heads, seq/sp, head_dim] of the members held
    here (``devices``: a list of devices, every member, or a
    ``spmd.RankGroup``, this rank's); returns their outputs.  The
    degree is the group's size, never the lists' length."""
    group = group_of(qs, devices)
    sp = group.size
    if sp == 1:
        return [_local_attention(qs[0], ks[0], vs[0], causal, window,
                                 use_flash)]
    h, h_kv = qs[0].shape[1], ks[0].shape[1]
    if h % sp != 0 or h_kv % sp != 0:
        raise ValueError(
            f"ulysses needs heads divisible by the sequence-parallel degree: "
            f"q heads {h}, kv heads {h_kv}, sp {sp}"
        )

    def swap_in(xs):
        return group.all_to_all(xs, 1, 2)

    outs = [_local_attention(q, k, v, causal, window, use_flash)
            for q, k, v in zip(swap_in(qs), swap_in(ks), swap_in(vs))]
    return group.all_to_all(outs, 2, 1)


def ulysses_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    causal: bool = True,
    window: Optional[int] = None,
    batch_axis: Optional[str] = "dp",
    seq_axis: str = "sp",
    head_axis: Optional[str] = "tp",
    use_flash: Optional[bool] = None,
) -> ShardedTensor:
    """Ulysses attention over a mesh: [batch, heads, seq, head_dim] with
    batch over ``batch_axis``, heads over ``head_axis`` and sequence over
    ``seq_axis`` (the mirror of ``ring_attention_sharded``); returns the
    output as a :class:`ShardedTensor` under that spec."""
    def fn(qs, ks, vs, devices):
        return ulysses_attention(qs, ks, vs, devices, causal=causal,
                                 window=window, use_flash=use_flash)

    return over_sequence_groups(fn, (q, k, v), mesh,
                                P(batch_axis, head_axis, seq_axis, None),
                                seq_axis)
