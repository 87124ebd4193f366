"""Port parity: the dense draft-model speculative decoders of
kubeshare_tpu_torch.models.decoding against kubeshare_tpu.models.decoding
on the CPU.

Greedy: tokens and the number of verify rounds equal JAX's exactly at f32
(a self-draft and a different draft model, GQA and a sliding window), and
equal the port's own greedy decode.  Sampled: the port draws from seeds
(not JAX's PRNG), so it is held to the target distribution instead — the
per-position total-variation distance to JAX's ``sample_decode`` over
N = 1,500 rows, and to the exact marginals of JAX's forward, stays under
0.12, the bound of JAX's own test."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models import decoding as jax_decoding
from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_apply as jax_apply
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models import decoding
from kubeshare_tpu_torch.models.transformer import TransformerConfig

torch.set_num_threads(1)

TARGET = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq_len=64)
DRAFT = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
             max_seq_len=64)
VARIANTS = [dict(positional="rope", n_kv_heads=2),
            dict(positional="learned", n_kv_heads=1, attention_window=6)]


def model(dims, seed, **extra):
    kw = {**dims, "attention": "reference", **extra}
    jax_cfg = JaxConfig(dtype=jnp.float32, **kw)
    jp = jax_init(jax.random.PRNGKey(seed), jax_cfg)
    return (jax_cfg, jp, TransformerConfig(dtype=torch.float32, **kw),
            params_from_jax(jax.device_get(jp), "cpu"))


def prompts(batch, length, seed, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (batch, length))


def test_acceptance_equals_jax():
    rng = np.random.default_rng(0)
    proposal = rng.integers(-1, 3, (6, 5, 4))
    targets = rng.integers(0, 3, (6, 5, 5))
    targets[..., :4] = np.where(rng.random((6, 5, 4)) < 0.7,
                                proposal, targets[..., :4])
    want = jax_decoding.speculative_acceptance(jnp.asarray(proposal),
                                               jnp.asarray(targets))
    got = decoding.speculative_acceptance(torch.from_numpy(proposal),
                                          torch.from_numpy(targets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the -1 pad never matches a picked token 0
    assert int(decoding.speculative_acceptance(
        torch.tensor([[-1, 0]]), torch.tensor([[0, 0, 0]]))[0]) == 0


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("draft", ["self", "other"])
@pytest.mark.parametrize("draft_len", [2, 4])
def test_greedy_equals_jax(variant, draft, draft_len):
    jcfg, jp, cfg, tp = model(TARGET, 0, **variant)
    if draft == "self":
        jdcfg, jdp, dcfg, dp = jcfg, jp, cfg, tp
    else:
        jdcfg, jdp, dcfg, dp = model(DRAFT, 9, positional="rope")
    prompt = prompts(2, 8, 1)
    new = 13
    want, want_stats = jax_decoding.speculative_greedy_decode(
        jp, jcfg, jdp, jdcfg, jnp.asarray(prompt, jnp.int32), new,
        draft_len=draft_len, return_stats=True)
    got, stats = decoding.speculative_greedy_decode(
        tp, cfg, dp, dcfg, torch.from_numpy(prompt), new,
        draft_len=draft_len, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["rounds"] == int(want_stats["rounds"])
    base = decoding.greedy_decode(tp, cfg, torch.from_numpy(prompt), new)
    assert torch.equal(got, base)
    if draft == "self":
        assert stats["rounds"] == math.ceil((new - 1) / draft_len)
    else:
        assert stats["rounds"] > math.ceil((new - 1) / draft_len)


def test_a_round_past_completion_changes_nothing():
    _, _, cfg, tp = model(TARGET, 0, positional="rope")
    prompt = torch.from_numpy(prompts(2, 8, 2))
    cache, logits = decoding.prefill(tp, cfg, prompt)
    dcache, _ = decoding.prefill(tp, cfg, prompt)
    new, draft_len = 6, 4
    # a finished stream whose cache sits at the capacity's edge: the
    # gated writes must stay in bounds and leave every tensor as it was
    for c in (cache, dcache):
        c["length"].fill_(cfg.max_seq_len - 2)
    state = {"cache": cache, "dcache": dcache,
             "out": torch.arange(2 * (new + draft_len)).reshape(2, -1),
             "last": torch.argmax(logits, dim=-1),
             "n_done": torch.tensor(new + 1), "rounds": torch.tensor(3)}
    before = {k: v.clone() for k, v in state.items() if k not in
              ("cache", "dcache")}
    caches = [{k: v.clone() for k, v in c.items()} for c in (cache, dcache)]
    decoding._speculative_round(tp, cfg, tp, cfg, state, new, draft_len)
    for k, v in before.items():
        assert torch.equal(state[k], v), k
    for c, saved in zip((cache, dcache), caches):
        for k in ("k", "v", "length"):
            assert torch.equal(c[k], saved[k]), k


def test_validation():
    _, _, cfg, tp = model(TARGET, 0)
    small = TransformerConfig(**{**DRAFT, "vocab_size": 32})
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="draft_len"):
        decoding.speculative_greedy_decode(tp, cfg, tp, cfg, prompt, 8,
                                           draft_len=1)
    with pytest.raises(ValueError, match="vocabular"):
        decoding.speculative_greedy_decode(tp, cfg, tp, small, prompt, 8)
    with pytest.raises(ValueError, match="headroom"):
        decoding.speculative_greedy_decode(tp, cfg, tp, cfg, prompt, 60)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="temperature"):
        decoding.speculative_sample_decode(tp, cfg, tp, cfg, prompt, gen, 8,
                                           temperature=-1.0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        decoding.speculative_sample_decode(tp, cfg, tp, cfg, prompt, gen, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        decoding.speculative_greedy_decode(tp, cfg, tp, cfg, prompt, 8,
                                           capture=True)


# JAX's distribution test: vocab 16, a one-layer target and a narrower
# draft, 3 positions at temperature 0.9 and top-k 12
SAMPLE_TARGET = dict(vocab_size=16, d_model=16, n_heads=2, n_layers=1,
                     d_ff=32, max_seq_len=32)
SAMPLE_DRAFT = dict(vocab_size=16, d_model=8, n_heads=1, n_layers=1,
                    d_ff=16, max_seq_len=32)


@pytest.fixture(scope="module")
def sample_models():
    jax_cfg, jp, cfg, tp = model(SAMPLE_TARGET, 0)
    _, _, dcfg, dp = model(SAMPLE_DRAFT, 7)
    return cfg, tp, dcfg, dp, jax_cfg, jp


def jax_marginals(jax_cfg, jp, prompt, steps, temperature, top_k):
    """The exact per-position marginals of JAX's filtered sampling
    distribution over ``steps`` emissions: one forward over every
    continuation of ``prompt`` (vocab ** (steps - 1) rows)."""
    vocab, length = jax_cfg.vocab_size, prompt.shape[1]
    tails = np.stack(np.meshgrid(*[np.arange(vocab)] * (steps - 1),
                                 indexing="ij"), -1).reshape(-1, steps - 1)
    seqs = np.concatenate([np.repeat(prompt, len(tails), 0), tails], 1)
    logits = jax_apply(jp, jnp.asarray(seqs), jax_cfg)[:, length - 1:]
    probs = np.stack([np.asarray(jax.nn.softmax(jax_decoding._filter_logits(
        logits[:, i] / temperature, top_k, None), axis=-1))
        for i in range(steps)], 1)  # [rows, steps, vocab]
    # P(prefix) of each row, then each position's marginal
    weight = np.ones(len(tails))
    marginals = []
    for i in range(steps):
        marginals.append(weight @ probs[:, i] / vocab ** (steps - 1 - i))
        if i < steps - 1:
            weight = weight * probs[np.arange(len(tails)), i, tails[:, i]]
    return marginals


def test_sampled_distribution_matches_sample_decode(sample_models):
    cfg, tp, dcfg, dp, jax_cfg, jp = sample_models
    n, steps, batch = 1500, 3, 4
    prompt_np = prompts(1, 4, 1, vocab=16)
    prompt = torch.from_numpy(prompt_np)
    plain = np.asarray(jax_decoding.sample_decode(
        jp, jax_cfg, jnp.asarray(np.repeat(prompt_np, n, 0)),
        jax.random.PRNGKey(42), steps, temperature=0.9, top_k=12))
    exact = jax_marginals(jax_cfg, jp, prompt_np, steps, 0.9, 12)
    # small batches: the batch-min acceptance then accepts drafts often
    # enough to exercise every branch (accept, residual, bonus)
    gen = torch.Generator().manual_seed(43)
    spec, rounds = [], 0
    for _ in range(n // batch):
        out, stats = decoding.speculative_sample_decode(
            tp, cfg, dp, dcfg, prompt.expand(batch, -1), gen, steps,
            draft_len=3, temperature=0.9, top_k=12, return_stats=True)
        spec.append(out)
        rounds += stats["rounds"]
    spec = torch.cat(spec)
    assert spec.shape == plain.shape == (n, steps)
    # some rounds accepted a draft (a round that rejects every row emits 1)
    assert rounds < (n // batch) * (steps - 1)
    for pos in range(steps):
        h_plain = np.bincount(plain[:, pos], minlength=16) / n
        h_spec = np.bincount(spec[:, pos].numpy(), minlength=16) / n
        tv = 0.5 * np.abs(h_plain - h_spec).sum()
        assert tv < 0.12, (pos, tv, h_plain, h_spec)
        tv_exact = 0.5 * np.abs(exact[pos] - h_spec).sum()
        assert tv_exact < 0.12, (pos, tv_exact, exact[pos], h_spec)


def test_sampled_self_draft_accepts_everything(sample_models):
    cfg, tp = sample_models[:2]
    prompt = torch.from_numpy(prompts(2, 4, 2, vocab=16))
    out, stats = decoding.speculative_sample_decode(
        tp, cfg, tp, cfg, prompt, torch.Generator().manual_seed(3), 12,
        draft_len=3, return_stats=True)
    assert out.shape == (2, 12)
    assert stats["rounds"] == 4  # ceil(11 / 3)


def test_sampled_is_deterministic_and_zero_temperature_is_greedy(
        sample_models):
    cfg, tp, dcfg, dp = sample_models[:4]
    prompt = torch.from_numpy(prompts(2, 4, 6, vocab=16))
    runs = [decoding.speculative_sample_decode(
        tp, cfg, dp, dcfg, prompt, torch.Generator().manual_seed(8), 10,
        draft_len=4, top_p=0.95) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    greedy = decoding.speculative_sample_decode(
        tp, cfg, dp, dcfg, prompt, torch.Generator().manual_seed(5), 8,
        temperature=0.0)
    assert torch.equal(greedy, decoding.greedy_decode(tp, cfg, prompt, 8))
    dcfg_wide = dataclasses.replace(dcfg, max_seq_len=8)
    with pytest.raises(ValueError, match="draft max_seq_len"):
        decoding.speculative_sample_decode(
            tp, cfg, dp, dcfg_wide, prompt, torch.Generator(), 8)
