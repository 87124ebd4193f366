"""Port parity: kubeshare_tpu_torch.models.decoding against the JAX
decoding path on the CPU (bulk and chunked prefill, greedy decode), plus
the port's own sampling contract (a seeded torch.Generator)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models import decoding as jax_decoding
from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models import decoding
from kubeshare_tpu_torch.models.transformer import TransformerConfig

torch.set_num_threads(1)

# f32 on both sides: only summation order differs
F32_TOL = 1e-5

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=48,
             max_seq_len=48)


def setup(seed=1, **overrides):
    kw = {**SMALL, "attention": "reference", **overrides}
    jax_cfg = JaxConfig(dtype=jnp.float32, **kw)
    torch_cfg = TransformerConfig(dtype=torch.float32, **kw)
    jp = jax_init(jax.random.PRNGKey(seed), jax_cfg)
    return jax_cfg, torch_cfg, jp, params_from_jax(jax.device_get(jp), "cpu")


def prompt(batch, length, seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], (batch, length)).astype(np.int32)


def assert_cache_close(got, want, tol=F32_TOL):
    assert int(got["length"]) == int(want["length"])
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=tol, atol=tol)


VARIANTS = [
    dict(positional="learned"),
    dict(positional="rope"),
    dict(positional="rope", n_kv_heads=2),
    dict(positional="learned", n_kv_heads=1, attention_window=6),
]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("attention", ["reference", "flash"])
def test_prefill_matches_jax(variant, attention):
    # JAX runs its reference attention (the CPU path); the port's "flash"
    # is the kernel's plain version here
    jax_cfg, torch_cfg, jp, tp = setup(**variant)
    torch_cfg = dataclasses.replace(torch_cfg, attention=attention)
    p = prompt(2, 20)
    want_cache, want_logits = jax_decoding.prefill(jp, jax_cfg, jnp.asarray(p))
    cache, logits = decoding.prefill(tp, torch_cfg, torch.from_numpy(p))
    assert_cache_close(cache, want_cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("length,chunk", [
    (24, 8),   # whole chunks
    (21, 8),   # ragged tail slides back over written positions
    (5, 8),    # shorter than its bucket: pads forward
    (13, 16),  # one chunk, pads forward to the 16 bucket
])
@pytest.mark.parametrize("positional", ["learned", "rope"])
def test_prefill_chunked_matches_jax(length, chunk, positional):
    jax_cfg, torch_cfg, jp, tp = setup(positional=positional, n_kv_heads=2)
    p = prompt(2, length, seed=length)
    want_cache, want_logits = jax_decoding.prefill_chunked(
        jp, jax_cfg, jnp.asarray(p), chunk)
    cache, logits = decoding.prefill_chunked(tp, torch_cfg,
                                             torch.from_numpy(p), chunk)
    assert_cache_close(cache, want_cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=F32_TOL, atol=F32_TOL)
    # and the chunked cache matches the port's own bulk prefill
    bulk_cache, bulk_logits = decoding.prefill(tp, torch_cfg,
                                               torch.from_numpy(p))
    torch.testing.assert_close(cache["k"], bulk_cache["k"],
                               rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(logits, bulk_logits, rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_tokens_equal_jax(variant):
    jax_cfg, torch_cfg, jp, tp = setup(**variant)
    p = prompt(3, 12, seed=2)
    want = np.asarray(jax_decoding.greedy_decode(jp, jax_cfg, jnp.asarray(p), 16))
    got = decoding.greedy_decode(tp, torch_cfg, torch.from_numpy(p), 16)
    assert got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_with_cache_after_chunked_prefill_equals_bulk():
    _, cfg, _, tp = setup(positional="rope")
    p = torch.from_numpy(prompt(2, 11, seed=5))
    cache, logits = decoding.prefill_chunked(tp, cfg, p, 4)
    chunked = decoding.greedy_decode_with_cache(tp, cfg, cache, logits, 10,
                                                prefill_length=11)
    torch.testing.assert_close(chunked, decoding.greedy_decode(tp, cfg, p, 10),
                               rtol=0, atol=0)


def _sample(tp, cfg, p, seed, **kw):
    gen = torch.Generator().manual_seed(seed)
    return decoding.sample_decode(tp, cfg, p, gen, 12, **kw)


@pytest.mark.parametrize("filters", [
    dict(temperature=1.0), dict(temperature=0.7, top_k=5),
    dict(temperature=1.3, top_p=0.8),
])
def test_sample_decode_is_deterministic_per_seed(filters):
    _, cfg, _, tp = setup(positional="rope")
    p = torch.from_numpy(prompt(2, 8, seed=6))
    first = _sample(tp, cfg, p, 11, **filters)
    torch.testing.assert_close(first, _sample(tp, cfg, p, 11, **filters),
                               rtol=0, atol=0)
    assert first.shape == (2, 12)
    assert bool(((first >= 0) & (first < SMALL["vocab_size"])).all())
    # a different seed draws a different stream (12 x 2 draws over 64 ids)
    assert not torch.equal(first, _sample(tp, cfg, p, 12, **filters))


def test_sample_decode_degenerate_cases_equal_greedy():
    _, cfg, _, tp = setup()
    p = torch.from_numpy(prompt(2, 8, seed=7))
    greedy = decoding.greedy_decode(tp, cfg, p, 12)
    torch.testing.assert_close(_sample(tp, cfg, p, 0, temperature=0.0),
                               greedy, rtol=0, atol=0)
    # top_k=1 leaves one candidate per step: the argmax
    torch.testing.assert_close(_sample(tp, cfg, p, 0, top_k=1), greedy,
                               rtol=0, atol=0)


@pytest.mark.parametrize("top_k,top_p", [(3, None), (None, 0.6), (4, 0.9),
                                         (100, None), (None, 1.0)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(8).standard_normal((3, 20)).astype(np.float32)
    want = np.asarray(jax_decoding._filter_logits(jnp.asarray(logits),
                                                  top_k, top_p))
    got = decoding._filter_logits(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bucket_width_matches_jax():
    for chunk in (1, 8, 16):
        for remainder in range(1, chunk + 1):
            assert (decoding.bucket_width(remainder, chunk)
                    == jax_decoding.bucket_width(remainder, chunk))


def test_capacity_checks_raise():
    _, cfg, _, tp = setup()
    p = torch.from_numpy(prompt(1, 40))
    with pytest.raises(ValueError, match="max_seq_len"):
        decoding.greedy_decode(tp, cfg, p, 9)
    with pytest.raises(ValueError, match="max_seq_len"):
        decoding.prefill(tp, cfg, torch.from_numpy(prompt(1, 49)))
    cache, logits = decoding.prefill(tp, cfg, p)
    with pytest.raises(ValueError, match="capacity"):
        decoding.greedy_decode_with_cache(tp, cfg, cache, logits, 9)
    with pytest.raises(ValueError, match="capacity"):
        decoding.greedy_decode_with_cache(tp, cfg, cache, logits, 4,
                                          prefill_length=45)
    with pytest.raises(ValueError, match="temperature"):
        decoding.sample_decode(tp, cfg, p, torch.Generator(), 2,
                               temperature=-1.0)
    with pytest.raises(ValueError, match="top_p"):
        decoding.sample_decode(tp, cfg, p, torch.Generator(), 2, top_p=0.0)


def test_decode_updates_the_cache_in_place():
    _, cfg, _, tp = setup()
    cache, logits = decoding.prefill(tp, cfg, torch.from_numpy(prompt(1, 10)))
    k = cache["k"]
    decoding.greedy_decode_with_cache(tp, cfg, cache, logits, 5)
    assert cache["k"] is k and cache["length"] == 14
    assert bool(k[:, :, :, 10:14].abs().sum(dim=-1).gt(0).all())
