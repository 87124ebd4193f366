"""The port's twins of ``__graft_entry__``: ``entry()``, the flagship
Transformer's forward step at tokens (4, 1024), and
``dryrun_multichip(n)``, one pass over the mesh's parallelisms on tiny
shapes; both on the card unless told otherwise.

    fn, (params, tokens) = entry()
    logits = fn(params, tokens)     # [4, 1024, 2048] f32
    dryrun_multichip(8)             # over [cuda:0] * 8
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from . import resolve_device
from .models.transformer import TransformerConfig, transformer_apply, transformer_init


def flagship_config(dtype: torch.dtype = torch.bfloat16) -> TransformerConfig:
    """The flagship configuration of ``__graft_entry__._flagship_config``."""
    return TransformerConfig(
        vocab_size=2048,
        d_model=512,
        n_heads=8,
        n_layers=4,
        d_ff=1408,
        max_seq_len=1024,
        dtype=dtype,
        attention="auto",  # the flash kernel on CUDA
    )


def entry(device=None, seed: int = 0) -> Tuple[Callable, Tuple[Dict, torch.Tensor]]:
    """(fn, example_args): the flagship forward and its (params, tokens),
    with weights drawn from ``seed``.  Runs on the CUDA device unless
    ``device`` names another; raises without one."""
    device = resolve_device(device)
    config = flagship_config()
    params = transformer_init(config, torch.Generator().manual_seed(seed),
                              device)
    tokens = torch.zeros((4, 1024), dtype=torch.int64, device=device)

    @torch.no_grad()
    def forward(params, tokens):
        return transformer_apply(params, tokens, config)

    return forward, (params, tokens)


def dryrun_multichip(n_devices: int, device=None) -> str:
    """The port's twin of ``__graft_entry__.dryrun_multichip``: fold
    ``n_devices`` into a dp x tp x sp mesh over ``[device] * n_devices``
    (one controller runs every shard in turn; ``device`` defaults to the
    card, ``"cpu"`` for the CPU) and run, on tiny shapes:

    - one sharded training step (loss, gradients, AdamW) under dp x tp x
      sp with the fsdp rules (parameters and moments split over dp);
    - ``ring_attention_sharded``, contiguous and zigzag, and
      ``ulysses_attention_sharded`` over sp;
    - the MoE layer with experts over dp, gradients included, and over a
      dedicated ep axis (dp x ep x tp) when ``n_devices % 4 == 0``;
    - the 1F1B pipeline over pp x sp with the ring, then Ulysses, inside
      each stage, and an MoE model through the ring entry with its aux;
    - when ``n_devices`` is even, the multislice leg: a 2-slice mesh
      (``slice_device_mesh`` over the devices, from the MEGASCALE env
      contract) and one data-parallel train step over its "dcn" axis,
      parameters replicated, the batch split across the slices.

    Widths are the JAX dry run's but for the heads: head_dim 64 (the
    smallest the flash kernels take; JAX's model has 8).
    Returns the summary line it prints."""
    from dataclasses import replace

    import numpy as np

    from .models.transformer import (transformer_apply, transformer_apply_ring,
                                     transformer_fsdp_rules,
                                     transformer_sharding_rules,
                                     transformer_train_1f1b)
    from .ops.moe import MoEConfig, moe_apply, moe_init, moe_sharding_rules
    from .ops.ring_attention import ring_attention_sharded
    from .ops.ulysses import ulysses_attention_sharded
    from . import constants
    from .parallel.distributed import (multislice_spec_from_env,
                                       slice_device_mesh)
    from .parallel.mesh import (Mesh, MeshSpec, NamedSharding, P,
                                ShardedTensor, batch_sharding, device_put,
                                make_mesh, shard_params)
    from .parallel.train import make_train_step, tree_leaves, tree_map

    device = resolve_device(device)
    devices = [device] * n_devices
    gen = torch.Generator().manual_seed(0)

    def finite(x) -> bool:
        x = x.gather() if isinstance(x, ShardedTensor) else x
        return bool(torch.isfinite(x).all())

    # sp=2 exercises the ring, tp=2 tensor parallelism, dp the rest
    tp = 2 if n_devices % 2 == 0 else 1
    sp = 2 if n_devices % (tp * 2) == 0 else 1
    mesh = make_mesh(MeshSpec(dp=-1, tp=tp, sp=sp), devices=devices)
    dp = mesh.shape["dp"]
    config = TransformerConfig(
        vocab_size=128, d_model=256, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=512, max_seq_len=64, dtype=torch.float32,
        attention="reference")
    params = transformer_init(config, gen, device)
    use_fsdp = config.d_model % dp == 0
    init_state, train_step = make_train_step(
        lambda p, x: transformer_apply(p, x, config), mesh=mesh,
        param_rules=(transformer_fsdp_rules() if use_fsdp
                     else transformer_sharding_rules()))
    state = init_state(params)
    if use_fsdp and dp > 1 and state.params["embed"].spec != P("tp", "dp"):
        raise RuntimeError(f"embed placed {state.params['embed'].spec}")
    tokens = torch.ones((2 * dp, 16), dtype=torch.long, device=device)
    state, loss = train_step(state, tokens, tokens)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"non-finite loss {float(loss)}")

    # sequence parallelism: the ring, contiguous and zigzag, and Ulysses
    d = 64
    q = torch.randn((dp, 2, 8 * sp, d), generator=gen).to(device)
    out = ring_attention_sharded(q, q, q, mesh, causal=True, batch_axis="dp",
                                 head_axis=None)
    checks = [finite(out)]
    if sp > 1:
        qz = torch.randn((dp, 2, 4 * sp, d), generator=gen).to(device)
        checks.append(finite(ring_attention_sharded(
            qz, qz, qz, mesh, causal=True, batch_axis="dp", head_axis=None,
            use_flash=False, layout="zigzag")))
    qu = torch.randn((dp, max(sp, 1), 8 * sp, d), generator=gen).to(device)
    checks.append(finite(ulysses_attention_sharded(
        qu, qu, qu, mesh, causal=True, batch_axis="dp", head_axis=None)))

    # expert parallelism: a top-2 MoE layer with experts over dp, and over
    # a dedicated ep axis, gradients included
    def moe_grads(moe_config, rules, moe_mesh, x):
        placed = shard_params(moe_init(moe_config, gen, device), rules,
                              moe_mesh, copy=True)
        for leaf in placed.values():
            for shard in leaf.shards:
                shard.requires_grad_(True)
        out, aux = moe_apply(placed, x, moe_config)
        ((out.gather() ** 2).mean() + 0.01 * aux).backward()
        return all(finite(leaf.grad) for leaf in placed.values())

    moe_x = device_put(torch.randn((2 * dp, 4, 16), generator=gen).to(device),
                       NamedSharding(mesh, P("dp")))
    checks.append(moe_grads(MoEConfig(d_model=16, d_ff=32, num_experts=2 * dp,
                                      top_k=2), moe_sharding_rules("dp"),
                            mesh, moe_x))
    if n_devices % 4 == 0:
        ep_mesh = make_mesh(MeshSpec(dp=-1, ep=2, tp=2), devices=devices)
        ep_batch = 2 * ep_mesh.shape["dp"] * ep_mesh.shape["ep"]
        ep_x = device_put(torch.randn((ep_batch, 4, 16), generator=gen)
                          .to(device), batch_sharding(ep_mesh, 3))
        checks.append(moe_grads(MoEConfig(d_model=16, d_ff=32, num_experts=4,
                                          top_k=2), moe_sharding_rules("ep"),
                                ep_mesh, ep_x))

    # pipeline parallelism: 1F1B over pp x sp, the ring and then Ulysses
    # inside each stage, from the trained parameters
    pp_stages = 2 if n_devices >= 2 else 1
    pp_sp = 2 if n_devices >= pp_stages * 2 else 1
    array = np.empty(pp_stages * pp_sp, dtype=object)
    array[:] = devices[:pp_stages * pp_sp]
    pp_mesh = Mesh(array.reshape(pp_stages, pp_sp), ("pp", "sp"))
    pp_params = tree_map(lambda leaf: leaf.gather().detach(), state.params)
    pp_tokens = torch.ones((4, 16), dtype=torch.long, device=device)
    pp_config = replace(config, attention="ring" if pp_sp > 1 else
                        "reference", positional="rope")
    kinds = [pp_config] + ([replace(pp_config, attention="ulysses")]
                           if pp_sp > 1 else [])
    for kind in kinds:
        pp_loss, pp_grads = transformer_train_1f1b(
            pp_params, pp_tokens, pp_tokens, kind, pp_mesh,
            num_microbatches=2)
        checks.append(bool(torch.isfinite(pp_loss))
                      and all(finite(g) for g in tree_leaves(pp_grads)))

    # MoE inside the sequence-parallel forward, gradients included
    if sp > 1:
        moe_config = replace(config, moe_every=2, moe_num_experts=2,
                             moe_top_k=2, positional="rope")
        moe_params = transformer_init(moe_config, gen, device)
        leaves = tree_leaves(moe_params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        logits, aux = transformer_apply_ring(
            moe_params, torch.ones((2 * dp, 16), dtype=torch.long,
                                   device=device), moe_config, mesh,
            with_aux=True)
        ((logits.gather() ** 2).mean() + 0.01 * aux).backward()
        checks.append(all(finite(leaf.grad) for leaf in leaves))
    # multislice: the MEGASCALE env's 2-slice virtual topology, the slice
    # boundary on the outer ("dcn") axis, one dp-over-dcn train step
    ms_loss = ms_mesh = None
    if n_devices % 2 == 0:
        ms = multislice_spec_from_env({
            constants.ENV_MEGASCALE_NUM_SLICES: "2",
            constants.ENV_MEGASCALE_SLICE_ID: "0",
        })
        if ms is None or ms.num_slices != 2:
            raise RuntimeError(f"multislice spec {ms}")
        ms_mesh = slice_device_mesh(ms, devices=devices)
        if ms_mesh.axis_names != ("dcn", "device") \
                or ms_mesh.devices.shape != (2, n_devices // 2):
            raise RuntimeError(f"multislice mesh {ms_mesh.axis_names} "
                               f"{ms_mesh.devices.shape}")
        ms_init, ms_step = make_train_step(
            lambda p, x: transformer_apply(p, x, config), mesh=ms_mesh,
            param_rules={})
        ms_state = ms_init(transformer_init(config, gen, device))
        ms_tokens = device_put(
            torch.ones((2 * ms.num_slices, 16), dtype=torch.long,
                       device=device), NamedSharding(ms_mesh, P("dcn")))
        ms_state, ms_loss = ms_step(ms_state, ms_tokens, ms_tokens)
        checks.append(bool(torch.isfinite(ms_loss)))
    if not all(checks):
        raise RuntimeError(f"non-finite results in the dry run: {checks}")
    line = (f"dryrun_multichip ok: mesh dp={dp} tp={tp} sp={sp} on "
            f"{n_devices} x {device}"
            f"{' (fsdp: params+moments dp-sharded)' if use_fsdp else ''} "
            f"(ring{' + zigzag' if sp > 1 else ''} + ulysses sp) + ep(over "
            f"dp)={2 * dp} experts top-2"
            f"{' + dedicated-ep mesh' if n_devices % 4 == 0 else ''}"
            f"{' + moe-in-ring-sp' if sp > 1 else ''} + 1f1b pp={pp_stages} "
            f"x sp={pp_sp} ({', '.join(k.attention for k in kinds)} "
            f"in-stage)"
            + (f" + multislice dcn mesh {ms_mesh.devices.shape[0]} slices x "
               f"{ms_mesh.devices.shape[1]} devices (dp-over-DCN train "
               f"step, loss={float(ms_loss):.4f})" if ms_loss is not None
               else "")
            + f", loss={float(loss):.4f}")
    print(line)
    return line
