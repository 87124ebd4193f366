"""Port parity: kubeshare_tpu_torch.serving.paged and kv_blocks against
kubeshare_tpu.serving on the CPU.

The same numpy-seeded parameters (converted with
``convert.params_from_jax``), the same pool contents, tables, lengths and
tokens go through JAX's paged entry points and the port's; logits agree
to 1e-5 at f32, tokens and ring contents exactly, and the pools the
steps write agree to 1e-5 (JAX returns new pools, the port writes its
own in place).  MHA, GQA and a sliding window; the allocator's cases of
tests/test_serving.py.  The captured (CUDA graph) forms run in
tests/test_torch_cuda.py, which needs a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeshare_tpu.models.transformer import TransformerConfig as JaxConfig
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.serving import paged as jax_paged
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.models.transformer import TransformerConfig
from kubeshare_tpu_torch.serving import kv_blocks, paged

torch.set_num_threads(1)

F32_TOL = 1e-5
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=48,
             max_seq_len=64)
BS, NB, T = 4, 24, 8  # block size, pool blocks, table width (32 rows)
VARIANTS = [
    dict(positional="learned"),
    dict(positional="rope", n_kv_heads=2),
    dict(positional="learned", n_kv_heads=1, attention_window=6),
    # JAX's MoE case: the paged steps pin the capacity to their tokens
    dict(positional="rope", moe_every=2, moe_num_experts=4, moe_top_k=2),
]
# lanes 0 and 1 own eight distinct blocks each; lane 2 is inactive, its
# table all scratch
TABLES = np.array([[3, 7, 1, 12, 5, 9, 14, 2],
                   [4, 11, 6, 15, 8, 10, 13, 16],
                   [0] * T], np.int64)
ACTIVE = np.array([True, True, False])
LENGTHS = np.array([13, 5, 0], np.int64)


class Case:
    """One model variant: both configs, both param trees and a pool of
    random rows (as if earlier steps had written it)."""

    def __init__(self, variant, seed=1):
        kw = {**SMALL, "attention": "reference", **variant}
        self.jax_cfg = JaxConfig(dtype=jnp.float32, **kw)
        self.cfg = TransformerConfig(dtype=torch.float32, **kw)
        self.jp = jax_init(jax.random.PRNGKey(seed), self.jax_cfg)
        self.tp = params_from_jax(jax.device_get(self.jp), "cpu")
        rng = np.random.default_rng(seed)
        shape = (self.cfg.n_layers, NB, self.cfg.kv_heads, BS,
                 self.cfg.head_dim)
        self.pool = [rng.standard_normal(shape).astype(np.float32)
                     for _ in range(2)]
        self.rng = rng

    def pools(self):
        """(JAX pool_k, pool_v, port pool_k, pool_v), equal."""
        return (jnp.asarray(self.pool[0]), jnp.asarray(self.pool[1]),
                torch.from_numpy(self.pool[0].copy()),
                torch.from_numpy(self.pool[1].copy()))

    def tokens(self, *shape):
        return self.rng.integers(0, SMALL["vocab_size"], shape)


def j32(a):
    return jnp.asarray(a, jnp.int32)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


def jitted(fn, *static):
    """``fn`` jitted with the given argument positions static: one XLA
    compile a shape instead of one per primitive."""
    return jax.jit(fn, static_argnums=static)


JAX_PREFILL = jitted(jax_paged.paged_prefill_step, 1)
JAX_DECODE = jitted(jax_paged.paged_decode_step, 1)
JAX_SPAN = jitted(jax_paged.paged_decode_span, 1, 2, 3, 4)
JAX_LOOP = jitted(jax_paged.paged_decode_loop, 1, 2, 3, 4, 5)
JAX_MIXED = jitted(jax_paged.paged_mixed_step, 1, 2, 3, 4)


def jax_greedy(logits, temps, keys):
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)


def port_greedy(logits, temps, seeds):
    return torch.argmax(logits, dim=-1)


def assert_pools_close(jk, jv, tk, tv, skip_scratch=True):
    lo = 1 if skip_scratch else 0
    for want, got in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(got.numpy()[:, lo:], np.asarray(want)[:, lo:],
                                   rtol=F32_TOL, atol=F32_TOL)


def lanes(case, budgets, steps):
    """The decode-lane arguments of both packages."""
    tokens = case.tokens(3)
    temps = np.zeros(3, np.float32)
    jargs = (j32(TABLES), j32(LENGTHS), jnp.asarray(ACTIVE), j32(tokens),
             jnp.asarray(temps), jnp.zeros((3, steps, 2), jnp.uint32),
             j32(budgets))
    targs = (t64(TABLES), t64(LENGTHS), torch.from_numpy(ACTIVE),
             t64(tokens), torch.from_numpy(temps),
             torch.zeros((3, steps), dtype=torch.int64), t64(budgets))
    return jargs, targs


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_step_matches_jax(variant):
    case = Case(variant)
    jk, jv, tk, tv = case.pools()
    tables, starts = TABLES[:2], np.array([6, 0])
    tokens, last_rows = case.tokens(2, 4), np.array([3, 2])
    want, jk, jv = JAX_PREFILL(
        case.jp, case.jax_cfg, jk, jv, j32(tables), j32(starts),
        jnp.ones((2,), bool), j32(tokens), j32(last_rows))
    got = paged.paged_prefill_step(
        case.tp, case.cfg, tk, tv, t64(tables), t64(starts),
        torch.ones((2,), dtype=torch.bool), t64(tokens), t64(last_rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    assert_pools_close(jk, jv, tk, tv, skip_scratch=False)


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_step_matches_jax(variant):
    case = Case(variant)
    jk, jv, tk, tv = case.pools()
    tokens = case.tokens(3)
    want, jk, jv = JAX_DECODE(
        case.jp, case.jax_cfg, jk, jv, j32(TABLES), j32(LENGTHS),
        jnp.asarray(ACTIVE), j32(tokens))
    got = paged.paged_decode_step(
        case.tp, case.cfg, tk, tv, t64(TABLES), t64(LENGTHS),
        torch.from_numpy(ACTIVE), t64(tokens))
    np.testing.assert_allclose(got.numpy()[ACTIVE], np.asarray(want)[ACTIVE],
                               rtol=F32_TOL, atol=F32_TOL)
    assert_pools_close(jk, jv, tk, tv)


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_span_matches_jax(variant):
    # lane 1's budget ends mid-span: its later rows are the dead lane's
    # picks, which both packages compute the same way
    case = Case(variant)
    jk, jv, tk, tv = case.pools()
    budgets = np.array([5, 2, 0])
    jargs, targs = lanes(case, budgets, 3)
    want, jk, jv = JAX_SPAN(
        case.jp, case.jax_cfg, jax_greedy, 3, None, jk, jv, *jargs)
    got = paged.paged_decode_span(
        case.tp, case.cfg, port_greedy, 3, None, tk, tv, *targs)
    assert got.shape == (3, 3)
    np.testing.assert_array_equal(got.numpy()[:, ACTIVE],
                                  np.asarray(want)[:, ACTIVE])
    assert_pools_close(jk, jv, tk, tv)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("budgets,units", [
    ([3, 7, 0], 2),    # lane 0 spends its budget in unit 1 of 3: exit
    ([9, 7, 0], 3),    # no lane changes: all three units run
])
def test_decode_loop_matches_jax(variant, budgets, units):
    case = Case(variant)
    jk, jv, tk, tv = case.pools()
    span, k_units = 2, 3
    jargs, targs = lanes(case, np.array(budgets), span * k_units)
    want_ring, want_units, jk, jv = JAX_LOOP(
        case.jp, case.jax_cfg, jax_greedy, span, k_units, None, jk, jv,
        *jargs)
    ring, got_units = paged.paged_decode_loop(
        case.tp, case.cfg, port_greedy, span, k_units, None, tk, tv, *targs)
    assert int(want_units) == units and int(got_units) == units
    rows = units * span
    np.testing.assert_array_equal(ring.numpy()[:rows, ACTIVE],
                                  np.asarray(want_ring)[:rows, ACTIVE])
    # rows past the units that ran are zeros in both
    assert not ring.numpy()[rows:].any()
    assert not np.asarray(want_ring)[rows:].any()
    assert_pools_close(jk, jv, tk, tv)


def test_decode_loop_stops_at_eos_like_jax():
    case = Case(VARIANTS[1])
    jk, jv, tk, tv = case.pools()
    budgets = np.array([20, 20, 0])
    jargs, targs = lanes(case, budgets, 8)
    # the EOS token: lane 0's first greedy pick, so it dies in unit 0
    first = int(JAX_DECODE(
        case.jp, case.jax_cfg, jk, jv, *jargs[:4])[0][0].argmax())
    want_ring, want_units, jk, jv = JAX_LOOP(
        case.jp, case.jax_cfg, jax_greedy, 2, 4, first, jk, jv, *jargs)
    ring, units = paged.paged_decode_loop(
        case.tp, case.cfg, port_greedy, 2, 4, first, tk, tv, *targs)
    assert int(units) == int(want_units) == 1
    np.testing.assert_array_equal(ring.numpy()[:2, ACTIVE],
                                  np.asarray(want_ring)[:2, ACTIVE])


@pytest.mark.parametrize("variant", VARIANTS)
def test_mixed_step_matches_jax(variant):
    # one prefill lane (own blocks 17..23) beside the two decode lanes
    case = Case(variant)
    jk, jv, tk, tv = case.pools()
    p_table = np.array([[17, 18, 19, 20, 21, 22, 23, 0]])
    p_tokens = case.tokens(1, 8)
    budgets = np.array([4, 1, 0])
    jargs, targs = lanes(case, budgets, 2)
    p_common = (np.array([8]), p_tokens, np.array([7]))
    want_p, want_e, jk, jv = JAX_MIXED(
        case.jp, case.jax_cfg, jax_greedy, 2, None, jk, jv, j32(p_table),
        *(j32(a) for a in p_common), jnp.zeros((1,), jnp.float32),
        jnp.zeros((1, 2), jnp.uint32), *jargs)
    got_p, got_e = paged.paged_mixed_step(
        case.tp, case.cfg, port_greedy, 2, None, tk, tv, t64(p_table),
        *(t64(a) for a in p_common), torch.zeros((1,)),
        torch.zeros((1,), dtype=torch.int64), *targs)
    assert int(got_p[0]) == int(want_p[0])
    np.testing.assert_array_equal(got_e.numpy()[:, ACTIVE],
                                  np.asarray(want_e)[:, ACTIVE])
    assert_pools_close(jk, jv, tk, tv)


def test_gather_copy_and_upload_match_jax():
    case = Case(VARIANTS[1])
    jk, jv, tk, tv = case.pools()
    for want, got in zip(jax_paged.paged_gather_kv(jk, jv, j32(TABLES[0])),
                         paged.paged_gather_kv(tk, tv, t64(TABLES[0]))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jk, jv = jax_paged.paged_copy_block(jk, jv, j32(5), j32(9))
    paged.paged_copy_block(tk, tv, t64([5]), t64([9]))
    assert_pools_close(jk, jv, tk, tv, skip_scratch=False)
    slab = case.rng.standard_normal(np.asarray(jk)[:, 0].shape).astype(
        np.float32)
    jk, jv = jax_paged.paged_upload_block(jk, jv, j32(3), jnp.asarray(slab),
                                          jnp.asarray(-slab))
    paged.paged_upload_block(tk, tv, 3, torch.from_numpy(slab),
                             torch.from_numpy(-slab))
    assert_pools_close(jk, jv, tk, tv, skip_scratch=False)


def test_pool_reads_and_geometry():
    case = Case(VARIANTS[1])
    pool = kv_blocks.init_paged_pool(case.cfg, NB, BS, device="cpu")
    assert tuple(pool.k.shape) == (2, NB, 2, BS, 8) and pool.num_blocks == NB
    assert not pool.k.any()
    assert pool.bytes_per_block() == 2 * 2 * 2 * BS * 8 * 4
    pool.k.copy_(torch.from_numpy(case.pool[0]))
    k3, _ = pool.read_block(3)
    np.testing.assert_array_equal(k3.numpy(), case.pool[0][:, 3])
    chain = pool.read_chain([3, 7], pad_to=T)
    assert len(chain) == 2
    np.testing.assert_array_equal(chain[1][0].numpy(), case.pool[0][:, 7])
    assert kv_blocks.chain_token_runs(range(9), 4) == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8]]
    with pytest.raises(ValueError, match="num_blocks"):
        kv_blocks.init_paged_pool(case.cfg, 1, BS, device="cpu")


def test_block_allocator_exhaustion_is_loud_and_all_or_nothing():
    alloc = kv_blocks.BlockAllocator(num_blocks=5, block_size=4)
    got = alloc.reserve(3, "a")
    assert len(got) == 3 and 0 not in got
    with pytest.raises(kv_blocks.BlockExhausted, match="needs 2 blocks"):
        alloc.reserve(2, "b")
    # the failed reservation granted NOTHING
    assert alloc.free_blocks == 1
    assert alloc.blocks_in_use == 3


def test_block_allocator_double_free_raises():
    alloc = kv_blocks.BlockAllocator(num_blocks=5, block_size=4)
    blocks = alloc.reserve(2, "a")
    alloc.reclaim(blocks)
    with pytest.raises(ValueError, match="double free"):
        alloc.reclaim(blocks)
    with pytest.raises(ValueError, match="not allocated"):
        alloc.reclaim([0])  # the scratch block is never allocated


def test_block_allocator_reuses_reclaimed_blocks_first():
    alloc = kv_blocks.BlockAllocator(num_blocks=9, block_size=4)
    first = alloc.reserve(3, "a")
    alloc.reclaim(first)
    again = alloc.reserve(3, "b")
    # LIFO free list: the retired request's blocks come back first
    assert set(again) == set(first)


def test_block_allocator_blocks_for_tokens():
    alloc = kv_blocks.BlockAllocator(num_blocks=9, block_size=4)
    assert [alloc.blocks_for_tokens(n) for n in (1, 4, 5, 8, 9)] == [
        1, 1, 2, 2, 3]


def test_block_allocator_quota_drains_own_cache_then_raises():
    alloc = kv_blocks.BlockAllocator(num_blocks=9, block_size=4)
    mine = alloc.reserve(3, "a", tenant="t", quota=4)
    alloc.mark_cached(mine)
    alloc.reclaim(mine)  # idle-cached, still charged to t
    assert alloc.tenant_usage("t") == 3 and alloc.cached_idle_blocks == 3
    # 3 cached + 3 new > quota 4: the tenant's own cache drains, LRU,
    # until the reservation fits
    alloc.reserve(3, "b", tenant="t", quota=4)
    assert alloc.tenant_usage("t") == 4 and alloc.evicted_blocks == 2
    with pytest.raises(kv_blocks.QuotaExceeded, match="quota"):
        alloc.reserve(2, "c", tenant="t", quota=4)


# -- the speculative entries ------------------------------------------------

JAX_VERIFY = jitted(jax_paged.paged_verify_span, 1, 2)
JAX_MIXED_VERIFY = jitted(jax_paged.paged_mixed_verify_step, 1, 2)
JAX_SPEC_LOOP = jitted(jax_paged.paged_spec_loop, 1, 2, 3, 4, 5, 6, 7)


def cycle3(t):
    """The copy model's next token: t's successor in its group of three
    (t = 63, alone in its group, repeats)."""
    t = np.asarray(t)
    return np.where(t < 63, 3 * (t // 3) + (t % 3 + 1) % 3, t)


def copy_params(jp):
    """A model whose greedy pick is :func:`cycle3` of its input token: the
    layers' projections scaled to 1e-3 and lm_head = embed.T with its
    columns permuted (rope).  Its streams repeat with period 3, so every
    self-drafted token is accepted and drafts reach their full width (a
    constant stream would draft one token a round: the most recent
    earlier occurrence of a run's suffix has a single follower)."""
    def scale(tree):
        return {k: scale(v) if isinstance(v, dict) else v * 1e-3
                for k, v in tree.items()}

    layers = [{**layer, "attn": scale(layer["attn"]),
               "mlp": scale(layer["mlp"])} for layer in jp["layers"]]
    inverse = np.argsort(cycle3(np.arange(jp["embed"].shape[0])))
    return {**jp, "layers": layers, "lm_head": jp["embed"][inverse].T}


class CopyCase(Case):
    """The rope GQA variant with :func:`copy_params` weights."""

    def __init__(self, seed=1):
        super().__init__(VARIANTS[1], seed)
        self.jp = copy_params(self.jp)
        self.tp = params_from_jax(jax.device_get(self.jp), "cpu")


def verify_tokens(case, widths, accept):
    """[3, W] verify inputs: a random last token per lane, then drafts of
    ``widths - 1`` tokens whose first ``accept`` equal the greedy picks
    (found by running the port's verify), -1 past each lane's width."""
    w = int(max(widths))
    tokens = np.full((3, w), -1, np.int64)
    tokens[:, 0] = case.tokens(3)
    for s in range(3):
        tokens[s, 1: widths[s]] = case.tokens(widths[s] - 1)
    for i in range(accept):
        _, _, tk, tv = case.pools()
        picked, _ = paged.paged_verify_span(
            case.tp, case.cfg, port_greedy, tk, tv, t64(TABLES), t64(LENGTHS),
            torch.from_numpy(ACTIVE), t64(tokens), t64(widths),
            torch.zeros(3), torch.zeros((3, w), dtype=torch.int64))
        for s in range(3):
            if i + 1 < widths[s]:
                tokens[s, i + 1] = int(picked[s, i])
    return tokens


@pytest.mark.parametrize("variant", VARIANTS)
def test_verify_span_matches_jax(variant):
    case = Case(variant)
    widths = np.array([5, 3, 1])
    tokens = verify_tokens(case, widths, accept=2)
    jk, jv, tk, tv = case.pools()
    want_p, want_a, jk, jv = JAX_VERIFY(
        case.jp, case.jax_cfg, jax_greedy, jk, jv, j32(TABLES), j32(LENGTHS),
        jnp.asarray(ACTIVE), j32(tokens), j32(widths),
        jnp.zeros((3,), jnp.float32), jnp.zeros((3, 5, 2), jnp.uint32))
    picked, accepts = paged.paged_verify_span(
        case.tp, case.cfg, port_greedy, tk, tv, t64(TABLES), t64(LENGTHS),
        torch.from_numpy(ACTIVE), t64(tokens), t64(widths), torch.zeros(3),
        torch.zeros((3, 5), dtype=torch.int64))
    np.testing.assert_array_equal(accepts.numpy(), np.asarray(want_a))
    assert accepts.tolist()[:2] == [2, 2]
    for s, width in enumerate(widths[:2]):
        np.testing.assert_array_equal(picked.numpy()[s, :width],
                                      np.asarray(want_p)[s, :width])
    assert_pools_close(jk, jv, tk, tv)


def test_verify_columns_use_their_emissions_seeds():
    # a verify whose drafts are a sampled span's emissions picks exactly
    # those emissions: column i consumes the seed of emission i
    from kubeshare_tpu_torch.models.decoding import pick_rows

    case = Case(VARIANTS[1])
    _, _, tk, tv = case.pools()
    gen = torch.Generator().manual_seed(5)
    seeds = torch.randint(0, 2 ** 62, (3, 4), generator=gen)
    temps = torch.tensor([0.9, 1.2, 0.0])
    last = t64(case.tokens(3))
    emitted = paged.paged_decode_span(
        case.tp, case.cfg, pick_rows, 4, None, tk.clone(), tv.clone(),
        t64(TABLES), t64(LENGTHS), torch.from_numpy(ACTIVE), last, temps,
        seeds, t64([9, 9, 0]))
    tokens = torch.cat([last[:, None], emitted[:3].T], dim=1)
    picked, accepts = paged.paged_verify_span(
        case.tp, case.cfg, pick_rows, tk, tv, t64(TABLES), t64(LENGTHS),
        torch.from_numpy(ACTIVE), tokens, t64([4, 4, 1]), temps, seeds)
    assert accepts.tolist()[:2] == [3, 3]
    assert torch.equal(picked[:2], emitted.T[:2])


def test_mixed_verify_step_matches_jax():
    case = Case(VARIANTS[1])
    widths = np.array([4, 2, 1])
    tokens = verify_tokens(case, widths, accept=1)
    jk, jv, tk, tv = case.pools()
    p_table = np.array([[17, 18, 19, 20, 21, 22, 23, 0]])
    p_common = (np.array([8]), case.tokens(1, 8), np.array([7]))
    want_p, want_v, want_a, jk, jv = JAX_MIXED_VERIFY(
        case.jp, case.jax_cfg, jax_greedy, jk, jv, j32(p_table),
        *(j32(a) for a in p_common), jnp.zeros((1,), jnp.float32),
        jnp.zeros((1, 2), jnp.uint32), j32(TABLES), j32(LENGTHS),
        jnp.asarray(ACTIVE), j32(tokens), j32(widths),
        jnp.zeros((3,), jnp.float32), jnp.zeros((3, 4, 2), jnp.uint32))
    got_p, got_v, got_a = paged.paged_mixed_verify_step(
        case.tp, case.cfg, port_greedy, tk, tv, t64(p_table),
        *(t64(a) for a in p_common), torch.zeros((1,)),
        torch.zeros((1,), dtype=torch.int64), t64(TABLES), t64(LENGTHS),
        torch.from_numpy(ACTIVE), t64(tokens), t64(widths), torch.zeros(3),
        torch.zeros((3, 4), dtype=torch.int64))
    assert int(got_p[0]) == int(want_p[0])
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_v.numpy()[:2, :2],
                                  np.asarray(want_v)[:2, :2])
    assert_pools_close(jk, jv, tk, tv)


HIST = 16
# two staged requests for the admission ring, on blocks the lanes and
# the prefill tests never touch
RING_TABLES = np.array([[17, 18, 19, 20, 21, 22, 23, 0],
                        [24, 25, 26, 27, 28, 29, 30, 31]], np.int64)


def spec_loop_args(case, budgets, ring_count, eos_free=True):
    """Both packages' arguments for a 4-unit, width-5 spec loop: lanes 0
    and 1 occupied (lane 2 free), drafting windows of each lane's own
    past, two ring entries of which ``ring_count`` are real."""
    k_units, width = 4, 5
    lens = np.array([13, 5, 0])
    hist = np.zeros((3, HIST), np.int64)
    hist_len = np.array([HIST, 9, 0])
    toks = case.tokens(3) % 63

    def run(t, n):  # n tokens of t's cycle, ending at t
        out = [t]
        for _ in range(n - 1):
            out.insert(0, int(cycle3(cycle3(out[0]))))
        return out

    for s in range(2):
        real = np.concatenate([case.tokens(hist_len[s] - 5),
                               run(toks[s], 5)])
        hist[s, HIST - hist_len[s]:] = real
    r_hist = np.zeros((2, HIST), np.int64)
    r_tok = case.tokens(2) % 63
    for j in range(2):
        r_hist[j, -4:] = run(r_tok[j], 4)
    arrays = dict(
        tables=TABLES, lengths=lens, active=ACTIVE, tokens=toks,
        temps=np.zeros(3, np.float32),
        seeds=np.zeros((3, k_units * width)), budgets=np.array(budgets),
        hist=hist, hist_len=hist_len, draft_caps=np.array([4, 2, 0]),
        ring_tables=RING_TABLES, ring_lengths=np.array([7, 3]),
        ring_tokens=r_tok, ring_temps=np.zeros(2, np.float32),
        ring_seeds=np.zeros((2, k_units * width)),
        ring_budgets=np.array([4, 30]), ring_hist=r_hist,
        ring_hist_len=np.array([4, 4]), ring_caps=np.array([4, 4]),
        ring_count=np.array(ring_count))

    def jax_value(name, a):
        if name.endswith("seeds"):
            return jnp.zeros(a.shape + (2,), jnp.uint32)
        if a.dtype == np.bool_ or a.dtype == np.float32:
            return jnp.asarray(a)
        return j32(a)

    def port_value(a):
        if a.dtype == np.bool_ or a.dtype == np.float32:
            return torch.from_numpy(np.asarray(a))
        return t64(a)

    jargs = [jax_value(n, np.asarray(a)) for n, a in arrays.items()]
    targs = [port_value(np.asarray(a)) for a in arrays.values()]
    return (k_units, width), jargs, targs


@pytest.mark.parametrize("copy,budgets,ring_count,units,head", [
    # the copy model accepts every draft: lane 0 emits its 3 tokens in
    # unit 0 and retires, ring entry 0 takes its lane and retires in
    # unit 1, entry 1 then runs to the end of the launch
    (True, [3, 30, 0], 2, 4, 2),
    # one ring entry: the second retirement has no refill — exit
    (True, [3, 30, 0], 1, 2, 1),
    # no ring: the first retirement ends the launch
    (True, [3, 30, 0], 0, 1, 0),
    # the random model rejects its drafts: the re-draft flag exits
    (False, [30, 30, 0], 2, 1, 0),
], ids=["ring_2", "ring_1_exit", "retire_exit", "redraft_exit"])
def test_spec_loop_matches_jax(copy, budgets, ring_count, units, head):
    case = CopyCase() if copy else Case(VARIANTS[1])
    NBIG = 32
    shape = (case.cfg.n_layers, NBIG, case.cfg.kv_heads, BS,
             case.cfg.head_dim)
    rng = np.random.default_rng(7)
    case.pool = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2)]
    (k_units, width), jargs, targs = spec_loop_args(case, budgets,
                                                    ring_count)
    jk, jv, tk, tv = case.pools()
    want = JAX_SPEC_LOOP(case.jp, case.jax_cfg, jax_greedy, k_units, None,
                         3, 0.25, width, jk, jv, *jargs)
    got = paged.paged_spec_loop(case.tp, case.cfg, port_greedy, k_units,
                                None, 3, 0.25, width, tk, tv, *targs)
    assert (int(got[3]), int(got[4])) == (units, head)
    assert (int(want[3]), int(want[4])) == (units, head)
    for ours, theirs in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    drafted, accepted = got[2].sum(), got[1].sum()
    assert drafted > 0
    assert (accepted == drafted) if copy else (accepted < drafted)
    # after the exit every unit wrote only the scratch block: the pools
    # equal JAX's, whose loop stopped
    assert_pools_close(want[5], want[6], tk, tv)
