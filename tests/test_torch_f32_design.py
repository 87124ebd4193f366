"""The f32 flash kernels' design, checked on the CPU.

1. 3xTF32: csrc/flash_fwd.cu's f32 forward and csrc/flash_bwd.cu's f32
   dK/dV and dQ kernels run every product on the tensor cores with each
   operand split into a TF32 big part and a TF32 small part (three
   products, small x small dropped).  Here the split is done with torch
   ops and bit masks (round to nearest, ties away, to TF32's 10 mantissa
   bits, as cvt.rna.tf32.f32) and the kernels' products (forward: S =
   Q K^T and P V; dK/dV: S^T, dP^T, p^T dO, ds^T Q; dQ: S, dP, ds K) are
   taken from the split parts, summed exactly (f64) and rounded to f32,
   inside the plain versions' arithmetic.  That stays within chip_smoke.py's kernel-vs-plain f32
   limits of the f32 plain versions; one TF32 pass does not, which is
   why the kernels take three.
2. The f32 path's small twin: a 2-layer f32 model of the serving
   flagship's shape (entry.flagship_config at narrow widths): its
   forward, the gradients of a train step and one AdamW step, with the
   port's flash attention (the kernels' plain versions on the CPU)
   against the JAX package's on the CPU (its flash attention takes the
   plain path off the TPU)."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config as jax_flagship_config
from kubeshare_tpu.models.transformer import transformer_apply as jax_apply
from kubeshare_tpu.models.transformer import transformer_init as jax_init
from kubeshare_tpu.parallel.train import cross_entropy_loss as jax_loss_fn
from kubeshare_tpu.parallel.train import make_train_step as jax_make_train_step
from kubeshare_tpu_torch.convert import params_from_jax
from kubeshare_tpu_torch.entry import flagship_config
from kubeshare_tpu_torch.models.transformer import transformer_apply
from kubeshare_tpu_torch.ops import attention as A
from kubeshare_tpu_torch.parallel import train as port_train

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """chip_smoke.py as a module, for its limits (it needs no card to
    import)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LIMITS = _chip_smoke()
OUT_TOL = LIMITS.TOLERANCES["float32"]
GRAD_TOL = LIMITS.BWD_TOLERANCES["float32"]


def _tf32(x):
    """x rounded to nearest (ties away from zero) to 10 mantissa bits:
    add half of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(passes):
    """einsum over f32 operands as the kernels take it: three TF32
    products (big.big + big.small + small.big) or one (big.big), summed
    exactly and rounded once to f32."""

    def einsum(spec, a, b):
        a_big, b_big = _tf32(a), _tf32(b)
        terms = [(a_big, b_big)]
        if passes == 3:
            terms += [(a_big, _tf32(b - b_big)), (_tf32(a - a_big), b_big)]
        return sum(torch.einsum(spec, x.double(), y.double())
                   for x, y in terms).float()

    return einsum


def _forward(q, k, v, mask, einsum):
    """_flash_forward_plain's arithmetic with its two products taken by
    ``einsum``."""
    k, v = A._repeat_kv(q, k, v)
    scale = q.shape[-1] ** -0.5
    scores = einsum("bhqd,bhkd->bhqk", q, k) * scale
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    probs = torch.exp(scores - safe_m)
    probs = torch.where(torch.isfinite(scores), probs, torch.zeros_like(probs))
    l = probs.sum(dim=-1, keepdim=True)
    denom = torch.clamp(l, min=1e-30)
    out = einsum("bhqk,bhkd->bhqd", probs, v) / denom
    lse = torch.where(l > 0, m + torch.log(denom),
                      torch.full_like(l, float("-inf")))
    return out, lse


def _dkv(q, k, v, out, lse, dout, mask, einsum):
    """The dK/dV half of _flash_backward_plain's arithmetic with its four
    products taken by ``einsum``; the GQA group summed in f32."""
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    k_full, v_full = A._repeat_kv(q, k, v)
    scale = d ** -0.5
    scores = einsum("bhqd,bhkd->bhqk", q, k_full) * scale
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.exp(scores - lse)
    probs = torch.where(torch.isfinite(scores), probs, torch.zeros_like(probs))
    delta = A._backward_delta(out, dout)
    dv = einsum("bhqk,bhqd->bhkd", probs, dout)
    ds = probs * (einsum("bhqd,bhkd->bhqk", dout, v_full) - delta)
    dk = scale * einsum("bhqk,bhqd->bhkd", ds, q)
    group = h // h_kv
    return (dk.reshape(b, h_kv, group, s, d).sum(dim=2),
            dv.reshape(b, h_kv, group, s, d).sum(dim=2))


def _dq(q, k, v, out, lse, dout, mask, einsum):
    """The dQ half of _flash_backward_plain's arithmetic with its three
    products (S = Q K^T, dP = dO V^T, ds K) taken by ``einsum``."""
    k_full, v_full = A._repeat_kv(q, k, v)
    scale = q.shape[-1] ** -0.5
    scores = einsum("bhqd,bhkd->bhqk", q, k_full) * scale
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.exp(scores - lse)
    probs = torch.where(torch.isfinite(scores), probs, torch.zeros_like(probs))
    delta = A._backward_delta(out, dout)
    ds = probs * (einsum("bhqd,bhkd->bhqk", dout, v_full) - delta)
    return scale * einsum("bhqk,bhkd->bhqd", ds, k_full)


def _inputs(shape, h_kv, seed):
    b, h, s, d = shape
    rng = np.random.default_rng(seed)
    q, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, h_kv, s, d),
                                                 dtype=np.float32))
            for _ in range(2))
    return q, k, v, dout


def _forward_errors(out, lse, ref_out, ref_lse):
    """The worst share of chip_smoke's f32 forward limits used: out per
    element against atol + rtol |ref|, lse absolute (1 = at the limit)."""
    out_share = float(((out - ref_out).abs()
                       / (OUT_TOL["out_atol"]
                          + OUT_TOL["out_rtol"] * ref_out.abs())).max())
    finite = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    lse_share = float((lse[finite] - ref_lse[finite]).abs().max()
                      / OUT_TOL["lse_atol"])
    return max(out_share, lse_share)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


CASES = [
    # d 64, GQA group of 2, ragged (77 is no multiple of a tile), causal
    ((1, 4, 77, 64), 2, None),
    # d 128, a sliding window of 40, causal
    ((1, 2, 96, 128), 2, 40),
]


@pytest.mark.parametrize("shape,h_kv,window", CASES,
                         ids=["d64_gqa_ragged", "d128_window"])
def test_3xtf32_holds_the_f32_limits_and_one_pass_does_not(shape, h_kv,
                                                           window):
    q, k, v, dout = _inputs(shape, h_kv, seed=15)
    s = shape[2]
    mask = A._band_mask(s, s, window, q.device)
    ref_out, ref_lse = A.flash_forward_reference(q, k, v, True, window)
    _, ref_dk, ref_dv = A.flash_backward_reference(q, k, v, ref_out, ref_lse,
                                                   dout, True, window)
    shares = {}
    for passes in (3, 1):
        einsum = _product(passes)
        out, lse = _forward(q, k, v, mask, einsum)
        dk, dv = _dkv(q, k, v, ref_out, ref_lse, dout, mask, einsum)
        shares[passes] = (_forward_errors(out, lse, ref_out, ref_lse),
                          max(_rel(dk, ref_dk), _rel(dv, ref_dv)) / GRAD_TOL)
    # three passes: within every limit, with room to spare
    assert shares[3][0] <= 0.5 and shares[3][1] <= 0.5, shares
    # one pass: the forward's and the backward's limits both broken
    assert shares[1][0] > 1 and shares[1][1] > 1, shares


@pytest.mark.parametrize("shape,h_kv,window", CASES,
                         ids=["d64_gqa_ragged", "d128_window"])
def test_3xtf32_dq_holds_the_f32_limit_and_one_pass_does_not(shape, h_kv,
                                                              window):
    # csrc/flash_bwd.cu's f32 dQ kernel: its three products in 3xTF32
    # within half of BWD_TOLERANCES["float32"], one TF32 pass beyond it
    q, k, v, dout = _inputs(shape, h_kv, seed=16)
    s = shape[2]
    mask = A._band_mask(s, s, window, q.device)
    out, lse = A.flash_forward_reference(q, k, v, True, window)
    ref_dq, _, _ = A.flash_backward_reference(q, k, v, out, lse, dout, True,
                                              window)
    shares = {passes: _rel(_dq(q, k, v, out, lse, dout, mask,
                               _product(passes)), ref_dq) / GRAD_TOL
              for passes in (3, 1)}
    assert shares[3] <= 0.5 and shares[1] > 1, shares


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12,
                      -(1 + 3 * 2 ** -11), 3.0e-3])
    got = _tf32(x)
    # 1 + 2^-11 is a tie: away from zero; 1 + 2^-12 rounds down
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -10, 1.0,
                         -(1 + 2 * 2 ** -10)])
    assert torch.equal(got[:5], want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # big + small carries about 21 significant bits of x
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000, dtype=np.float32))
    big = _tf32(x)
    rel = ((big + _tf32(x - big)).double() - x.double()).abs() / x.abs()
    assert float(rel.max()) < 2.0 ** -21


# the flagship's shape at narrow widths: head_dim 64 as in the flagship
# (512 / 8), d_ff / d_model as 1408 / 512, two layers
SMALL_FLAGSHIP = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2,
                      d_ff=352, max_seq_len=96)
# f32 end to end: logits, loss and gradients differ only by summation
# order (gradients as max |diff| / max |JAX| per tensor)
LOGITS_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
# one AdamW step of lr 1e-3: Adam's first update is lr g / (|g| + eps),
# about lr sign(g), insensitive to round-off in g unless |g| is within
# round-off of 0, where it may swing by up to 2 lr.  The parameters are
# held to test_torch_train.py's bound where |g| is above GRAD_FLOOR of
# its tensor's largest gradient, and to 2 lr elsewhere
PARAM_ATOL = 5e-6
GRAD_FLOOR = 1e-4
LR = 1e-3


def test_f32_flagship_twin_matches_jax():
    config = dataclasses.replace(flagship_config(torch.float32),
                                 attention="flash", **SMALL_FLAGSHIP)
    jax_cfg = dataclasses.replace(jax_flagship_config(jnp.float32),
                                  attention="flash", **SMALL_FLAGSHIP)
    params = jax_init(jax.random.PRNGKey(3), jax_cfg)
    rng = np.random.default_rng(4)
    # 90 tokens: ragged against every tile of the kernels
    tokens = rng.integers(0, 256, (2, 90)).astype(np.int32)
    targets = rng.integers(0, 256, (2, 90)).astype(np.int32)

    torch_params = params_from_jax(jax.device_get(params), device="cpu")
    with torch.no_grad():
        logits = transformer_apply(torch_params, torch.from_numpy(tokens),
                                   config)
    want = np.asarray(jax_apply(params, jnp.asarray(tokens), jax_cfg))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=LOGITS_ATOL)

    # the step's gradients: JAX's value_and_grad against autograd
    jax_loss, jax_grads = jax.value_and_grad(lambda p: jax_loss_fn(
        jax_apply(p, jnp.asarray(tokens), jax_cfg), jnp.asarray(targets)))(
            params)
    jax_grads = dict(port_train.tree_leaves_with_paths(
        jax.device_get(jax_grads)))
    leaves = dict(port_train.tree_leaves_with_paths(torch_params))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss = port_train.cross_entropy_loss(
        transformer_apply(torch_params, torch.from_numpy(tokens), config),
        torch.from_numpy(targets))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jax_loss),
                               rtol=LOSS_RTOL)
    assert grads.keys() == jax_grads.keys()
    for path, want in jax_grads.items():
        err = np.abs(grads[path].numpy() - want).max() / np.abs(want).max()
        assert err <= GRAD_RTOL, (path, err)
    for leaf in leaves.values():
        leaf.requires_grad_(False)

    # one AdamW step through each package's make_train_step
    init_state, step = jax_make_train_step(
        lambda p, t: jax_apply(p, t, jax_cfg), donate_state=False)
    jax_state, step_loss = step(init_state(params), jnp.asarray(tokens),
                                jnp.asarray(targets))
    init, train_step = port_train.make_train_step(
        lambda p, t: transformer_apply(p, t, config))
    state, loss = train_step(init(torch_params), torch.from_numpy(tokens),
                             torch.from_numpy(targets))
    np.testing.assert_allclose(float(loss), float(step_loss), rtol=LOSS_RTOL)
    got = dict(port_train.tree_leaves_with_paths(state.params))
    want = dict(port_train.tree_leaves_with_paths(
        jax.device_get(jax_state.params)))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        g = np.abs(jax_grads[path])
        atol = np.where(g > GRAD_FLOOR * g.max(), PARAM_ATOL, 2 * LR)
        diff = np.abs(got[path].detach().numpy() - leaf)
        assert (diff <= atol).all(), (path, float(diff.max()))
