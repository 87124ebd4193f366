"""The port's twin of ``__graft_entry__.entry()``: the flagship
Transformer's forward step at tokens (4, 1024), on the card.

    fn, (params, tokens) = entry()
    logits = fn(params, tokens)     # [4, 1024, 2048] f32
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
