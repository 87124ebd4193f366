"""Port parity: kubeshare_tpu_torch.models.transformer against the JAX
flagship model on the CPU, with the JAX weights converted 1:1
(kubeshare_tpu_torch.convert.params_from_jax)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_apply as jax_apply
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    transformer_apply,
    transformer_init,
)

torch.set_num_threads(1)

# f32 end to end: only summation order differs between the frameworks
F32_TOL = 1e-5
# bf16: the frameworks round intermediate results at different points
# (gelu, norms, attention); two layers carry a few bf16 ulps to logits of
# magnitude ~1
BF16_TOL = 6e-2

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=48,
             max_seq_len=64)


def configs(dtype="float32", **overrides):
    kw = {**SMALL, **overrides}
    jax_cfg = JaxConfig(dtype=getattr(jnp, dtype), **kw)
    torch_cfg = TransformerConfig(dtype=getattr(torch, dtype), **kw)
    return jax_cfg, torch_cfg


def converted(jax_cfg, seed=1):
    params = jax_init(jax.random.PRNGKey(seed), jax_cfg)
    return params, params_from_jax(jax.device_get(params), device="cpu")


def tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("attention", ["reference", "flash"])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("n_kv_heads", [None, 2])
@pytest.mark.parametrize("positional", ["learned", "rope"])
def test_logits_match_jax(positional, n_kv_heads, window, attention):
    # the JAX side runs its reference attention (the CPU path); the port's
    # "flash" runs the kernel's plain version here, exact in f32 as well
    jax_cfg, torch_cfg = configs(positional=positional, n_kv_heads=n_kv_heads,
                                 attention_window=window)
    jax_cfg = dataclasses.replace(jax_cfg, attention="reference")
    torch_cfg = dataclasses.replace(torch_cfg, attention=attention)
    jp, tp = converted(jax_cfg)
    toks = tokens((2, 24), SMALL["vocab_size"])
    want = np.asarray(jax_apply(jp, jnp.asarray(toks), jax_cfg))
    got = transformer_apply(tp, torch.from_numpy(toks), torch_cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("positional", ["learned", "rope"])
def test_bf16_logits_match_jax(positional):
    jax_cfg, torch_cfg = configs("bfloat16", positional=positional,
                                 attention="reference")
    jp, tp = converted(jax_cfg)
    toks = tokens((2, 16), SMALL["vocab_size"], seed=3)
    want = np.asarray(jax_apply(jp, jnp.asarray(toks), jax_cfg))
    got = transformer_apply(tp, torch.from_numpy(toks), torch_cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_TOL, atol=BF16_TOL)


def test_converted_params_mirror_the_jax_tree():
    jax_cfg, torch_cfg = configs(positional="learned")
    jp, tp = converted(jax_cfg)
    flat_jax = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf
                in jax.tree_util.tree_flatten_with_path(jp)[0]}
    model = Transformer(torch_cfg, tp)
    state = model.state_dict()
    assert len(state) == len(flat_jax)
    for path, leaf in flat_jax.items():
        # "['layers'][0]['attn']['wq']" -> "layers.0.attn.wq"
        key = ".".join(part.strip("'") for part in
                       path.replace("]", "").split("[")[1:])
        assert state[key].dtype == torch.float32
        np.testing.assert_array_equal(state[key].numpy(), leaf)


def test_init_shapes_match_jax_and_module_forward():
    for positional in ("learned", "rope"):
        jax_cfg, torch_cfg = configs(positional=positional, n_kv_heads=2)
        jp = jax_init(jax.random.PRNGKey(0), jax_cfg)
        tp = transformer_init(torch_cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        jax_shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
        torch_shapes = jax.tree.map(lambda t: tuple(t.shape), tp)
        assert torch_shapes == jax_shapes
        # same init scale: fan_in^-1/2 normal
        assert abs(float(tp["lm_head"].std()) - 32 ** -0.5) < 0.02
    model = Transformer.init(torch_cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.from_numpy(tokens((1, 8), SMALL["vocab_size"]))
    with torch.no_grad():
        torch.testing.assert_close(
            model(toks), transformer_apply(model.tree(), toks, torch_cfg))


def test_same_seed_same_weights():
    _, cfg = configs()
    a = transformer_init(cfg, torch.Generator().manual_seed(4), device="cpu")
    b = transformer_init(cfg, torch.Generator().manual_seed(4), device="cpu")
    torch.testing.assert_close(a["layers"][1]["mlp"]["w_out"],
                               b["layers"][1]["mlp"]["w_out"], rtol=0, atol=0)


@pytest.mark.parametrize("overrides,match", [
    ({"moe_every": 2}, "MoE"),
    ({"attention": "ring"}, "long context"),
    ({"attention": "ulysses"}, "long context"),
])
def test_unported_configs_raise(overrides, match):
    _, cfg = configs(**overrides)
    with pytest.raises(NotImplementedError, match=match):
        transformer_init(cfg, torch.Generator(), device="cpu")
