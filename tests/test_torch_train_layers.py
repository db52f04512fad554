"""The port's backward passes (``repro_torch.models.layers``: ``rmsnorm``
and the flash scan as ``torch.autograd.Function``s; ``transformer.
cross_entropy``) against ``jax.vjp`` / ``jax.grad`` of the reference's on
the CPU, and the port's ``remat`` against no remat.

Tolerances: f32 within 1e-5 of the larger of 1 and the gradient's scale
(sums in other orders); bf16 within 2e-2 of the scale (XLA keeps some of
the backward's bf16 chains in f32, eager torch rounds after each op, as
``jnp`` semantics say).  Inputs are drawn by numpy from fixed seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as r_layers
from repro.models.transformer import cross_entropy as r_cross_entropy
from repro_torch.configs import get_config
from repro_torch.models import get_model, layers
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import cross_entropy

F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(ours, ref, tol, what):
    ref = _np(ref)
    ours = ours.detach().float().numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ours - ref).max())
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    assert err <= tol * scale, (what, err, scale)


def _jit_vjp(f, cotangent, *primals):
    """The reference's output and ``jax.vjp`` cotangents, in one jitted
    call (one compile, not one a primitive)."""
    def run(ct, *xs):
        out, vjp = jax.vjp(f, *xs)
        return out, vjp(ct)
    return jax.jit(run)(cotangent, *primals)


def _pair(a, jdt, tdt):
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_backward_matches_reference(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(21)
    x = rng.normal(0, 1.5, (3, 5, 48)).astype(np.float32)
    w = rng.normal(1, 0.2, (48,)).astype(np.float32)
    dy = rng.normal(0, 1, x.shape).astype(np.float32)
    jx, tx = _pair(x, jdt, tdt)
    jdy, tdy = _pair(dy, jdt, tdt)
    y, (r_dx, r_dw) = _jit_vjp(lambda a, b: r_layers.rmsnorm(a, b, 1e-6),
                               jdy, jx, jnp.asarray(w))
    tx.requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = layers.rmsnorm(tx, tw, 1e-6)
    dx, dw = torch.autograd.grad(out, (tx, tw), tdy)
    assert dx.dtype == tdt and dw.dtype == torch.float32
    _close(out, y, tol, "y")
    _close(dx, r_dx, tol, "dx")
    _close(dw, r_dw, tol, "dw")


#: (B, Sq, Skv, Hkv, G, hd, causal, q_offset, block): causal and not, an
#: Skv that pads to whole blocks, G > 1, a q offset (prefill continuation)
FLASH_CASES = [
    (2, 16, 16, 2, 2, 16, True, 0, 8),
    (2, 12, 20, 2, 3, 16, False, 0, 8),
    (1, 9, 13, 1, 4, 8, True, 4, 5),
    (2, 7, 7, 3, 1, 32, True, 0, 1024),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_matches_reference(case, dtype):
    B, Sq, Skv, Hkv, G, hd, causal, off, block = case
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(22)
    q = rng.normal(0, 1, (B, Sq, Hkv, G, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, Skv, Hkv, hd)).astype(np.float32)
    do = rng.normal(0, 1, q.shape).astype(np.float32)
    jq, tq = _pair(q, jdt, tdt)
    jk, tk = _pair(k, jdt, tdt)
    jv, tv = _pair(v, jdt, tdt)
    jdo, tdo = _pair(do, jdt, tdt)
    out, r_grads = _jit_vjp(lambda a, b, c: r_layers.flash_attention(
        a, b, c, causal=causal, q_offset=off, block=block), jdo, jq, jk, jv)
    ts = [t.requires_grad_() for t in (tq, tk, tv)]
    ours = layers.flash_attention(*ts, causal=causal, q_offset=off,
                                  block=block)
    grads = torch.autograd.grad(ours, ts, tdo)
    _close(ours, out, tol, "out")
    for name, g, r in zip(("dq", "dk", "dv"), grads, r_grads):
        assert g.dtype == tdt, name
        _close(g, r, tol, name)


def test_flash_decode_route_keeps_the_plain_scan():
    """A ``kv_len`` (decode) takes the plain scan, as the reference does;
    train and prefill take the Function."""
    rng = np.random.default_rng(23)
    q = torch.from_numpy(rng.normal(0, 1, (1, 1, 2, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (1, 6, 2, 8)).astype(np.float32))
    out = layers.flash_attention(q, k, k, causal=False, kv_len=4)
    assert out.grad_fn is None
    q.requires_grad_()
    out = layers.flash_attention(q, k, k, causal=True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"


def test_cross_entropy_gradient_matches_reference_with_tied_maxima():
    """Rows whose maximum logit is tied: the port detaches the max it
    subtracts, as the reference's ``stop_gradient`` does."""
    rng = np.random.default_rng(24)
    logits = rng.integers(-3, 4, (3, 5, 40)).astype(np.float32)
    logits[..., :3] = logits.max(-1, keepdims=True) + 1.0   # 3-way tie
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    labels[0, 0] = 1
    mask = (rng.random((3, 5)) < 0.7).astype(np.float32)
    for m in (None, mask):
        r_loss, r_grad = jax.jit(jax.value_and_grad(
            lambda lg: r_cross_entropy(
                lg, jnp.asarray(labels),
                None if m is None else jnp.asarray(m))))(jnp.asarray(logits))
        t = torch.from_numpy(logits).requires_grad_()
        loss = cross_entropy(t, torch.from_numpy(labels),
                             None if m is None else torch.from_numpy(m))
        (grad,) = torch.autograd.grad(loss, t)
        np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-6)
        np.testing.assert_allclose(grad.numpy(), np.asarray(r_grad),
                                   rtol=0, atol=1e-8)


def _grads(model, params, batch):
    """The loss's gradients and the count of tensors the forward saved
    for the backward outside any remat region."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(1) or t, lambda t: t):
        loss = model.loss(tree_map(lambda _: next(it), params), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [g for g in grads if g is not None], len(saved)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b",
                                  "whisper-base"])
def test_remat_equals_no_remat_bit_for_bit(arch):
    """Remat recomputes each layer body in the backward pass: the same ops
    on the same inputs, so the gradients are equal bit for bit (dense,
    hybrid and encoder-decoder sites)."""
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(25)
    toks = rng.integers(0, cfg.vocab - 1, (2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (2, cfg.enc_seq, cfg.d_model)
                                     ).astype(np.float32)
    params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(7))
    got, saved = {}, {}
    for remat in (False, True):
        model = get_model(dataclasses.replace(cfg, remat=remat), "cpu")
        got[remat], saved[remat] = _grads(model, params, batch)
    assert saved[True] < saved[False] / 2, saved   # the layers recompute
    assert len(got[True]) == len(tree_leaves(params))
    for a, b in zip(got[False], got[True]):
        assert torch.equal(a, b)
