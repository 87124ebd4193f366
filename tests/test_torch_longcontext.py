"""The port's long-context twins on the CPU: ``train_longcontext_torch.py``
(the twin of ``examples/train_longcontext.py``) in both of its branches
at the JAX walkthrough's sizes, and ``entry.dryrun_multichip`` (the twin
of ``__graft_entry__.dryrun_multichip``) over ``[cpu] * n``."""

import pytest
import torch

import train_longcontext_torch
from kubeshare_tpu_torch.entry import dryrun_multichip

torch.set_num_threads(1)


@pytest.mark.parametrize("branch", [[], ["--pp"]], ids=["dp_tp_sp", "1f1b"])
def test_train_longcontext_losses_fall(branch):
    result = train_longcontext_torch.main(["--device", "cpu", *branch])
    losses = result["losses"]
    assert len(losses) == 4
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("n_devices", [8, 4])
def test_dryrun_multichip_runs_every_leg_on_the_cpu(n_devices):
    line = dryrun_multichip(n_devices, device="cpu")
    assert line.startswith("dryrun_multichip ok: mesh dp=")
    for leg in ("fsdp", "ring + zigzag + ulysses sp", "dedicated-ep mesh",
                "moe-in-ring-sp", "1f1b pp=2 x sp=2 (ring, ulysses"):
        assert leg in line, (leg, line)


def test_ten_zigzag_steps_over_a_mesh_follow_one_device_at_f32():
    """Ten AdamW steps of the zigzag hybrid ring over dp=2 x tp=2 x sp=2
    with the fsdp rules (the long-context phase's mesh) follow ten
    single-device steps of the same weights and batch at f32: the bf16
    drift chip_smoke's zigzag phase allows is round-off, not a
    difference in the program."""
    import copy
    import dataclasses

    from kubeshare_tpu_torch.models.transformer import (
        TransformerConfig, transformer_apply, transformer_apply_ring,
        transformer_fsdp_rules, transformer_init)
    from kubeshare_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from kubeshare_tpu_torch.parallel.train import make_train_step, tree_leaves

    config = TransformerConfig(vocab_size=128, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq_len=32,
                               dtype=torch.float32, attention="ring",
                               positional="rope")
    params = transformer_init(config, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(11)
    tokens, targets = (torch.randint(0, 128, (2, 32), generator=gen)
                       for _ in range(2))
    mesh = make_mesh(MeshSpec(dp=2, tp=2, sp=2), devices=["cpu"] * 8)
    single = dataclasses.replace(config, attention="reference")
    runs = []
    for apply, kwargs in (
            (lambda p, t: transformer_apply(p, t, single), {}),
            (lambda p, t: transformer_apply_ring(p, t, config, mesh,
                                                 layout="zigzag",
                                                 use_flash=True),
             dict(mesh=mesh, param_rules=transformer_fsdp_rules()))):
        init_state, train_step = make_train_step(apply, **kwargs)
        state = init_state(copy.deepcopy(params))
        losses = []
        for _ in range(10):
            state, loss = train_step(state, tokens, targets)
            losses.append(float(loss))
        runs.append((losses, [(leaf.gather() if hasattr(leaf, "shards")
                               else leaf).detach()
                              for leaf in tree_leaves(state.params)]))
    (want_losses, want), (losses, got) = runs
    assert losses[-1] < losses[0]
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(want_losses),
                               rtol=1e-5, atol=0)
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    assert worst <= 5e-6, worst
