"""The port's MoE, Mamba2, hybrid and encoder-decoder families
(``repro_torch.models.moe`` / ``mamba2`` / ``hybrid`` / ``encdec``) against
``repro.models`` on the CPU: the five non-dense configs' ``FULL`` and
``SMOKE`` tables, counts, input and cache specs; each smoke config's
prefill logits and caches, one decode step against the grown cache and
the loss (with the MoE aux term) on the reference's weights carried over
by ``params_from_numpy``; the port's own decode against the longer
prefill; bf16 granite-moe and mamba2; ``ssd_chunked`` in both
``legacy_f32`` branches, on a ragged length and against the naive
recurrence; ``moe_mlp`` on a dropping capacity with tied router scores;
the conv with a tail, ``layernorm`` and ``sinusoid_positions`` at an
offset.  Inputs are drawn by numpy from fixed seeds; the reference runs
once per config (its calls under ``jax.jit``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import get_model as r_get_model
from repro.models import act as r_act
from repro.models import encdec as r_encdec
from repro.models import mamba2 as r_mamba2
from repro.models import moe as r_moe
from repro.models.config import Shape as RShape
from repro.models.params import P as RP
from repro.models.params import count_params as r_count
from repro_torch.configs import get_config
from repro_torch.models import SHAPES, act, encdec, get_model, mamba2, moe
from repro_torch.models.config import Shape
from repro_torch.models.params import (P, count_params, params_from_numpy,
                                       tree_leaves, tree_map)
from repro_torch.serve import grow_cache

FAMILIES = ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "mamba2-130m",
            "zamba2-2.7b", "whisper-base"]
B, T, EXTRA = 2, 12, 4
TOL = 1e-4           # f32 against the reference: sums in other orders
BF16_TOL = 2e-2      # a few bf16 roundings (2^-8 each) on O(1) logits


def _t(a):
    return a.detach().float().numpy()


def _leaves(table, cls):
    out = []

    def walk(t, path):
        if isinstance(t, cls):
            out.append((path, t.shape, t.axes, t.init, t.scale))
        else:
            for k in sorted(t):
                walk(t[k], path + (k,))
    walk(table, ())
    return out


def _spec_list(tree, name):
    leaves = (jax.tree.leaves(tree) if name is None else
              tree_leaves(tree, is_leaf=lambda s: hasattr(s, "shape")))
    return [(tuple(s.shape), str(np.dtype(s.dtype)) if name is None
             else str(s.dtype).removeprefix("torch.")) for s in leaves]


@pytest.mark.parametrize("arch", FAMILIES)
def test_tables_counts_and_specs_match_reference(arch):
    for smoke in (False, True):
        model = get_model(get_config(arch, smoke), device="cpu")
        r_model = r_get_model(r_get_config(arch, smoke))
        assert type(model).__name__ == type(r_model).__name__
        assert model.family == r_model.family
        ours, ref = model.table(), r_model.table()
        assert _leaves(ours, P) == _leaves(ref, RP)
        assert count_params(ours) == r_count(ref)
        for shape in SHAPES.values():
            r_shape = RShape(shape.name, shape.seq, shape.batch, shape.kind)
            assert _spec_list(model.input_specs(shape), "torch") == \
                _spec_list(r_model.input_specs(r_shape), None)
            assert _spec_list(model.cache_specs(shape), "torch") == \
                _spec_list(r_model.cache_specs(r_shape), None)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab - 1, (B, T)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab - 1, (B, T)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)
                                     ).astype(np.float32)
    return batch


def _np_grow(model, cache, seq):
    """The reference's prefill cache padded to its own decode specs (its
    ``ServeLoop._grow_cache`` pads any axis 2 equal to the prompt length,
    ROADMAP C.7; T - 1 = 11 matches no constant axis of these configs)."""
    specs = model.cache_specs(RShape("t", seq, B, "decode"))
    return jax.tree.map(
        lambda a, s: jnp.pad(a, [(0, w - h) for h, w in zip(a.shape,
                                                            s.shape)]),
        cache, specs)


def np_params(table, seed):
    """Params for both packages, drawn by numpy leaf by leaf from the
    reference's table: its inits, with biases and gains moved off 0 and 1
    so that a bias or gain applied wrongly shows."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        if p.init in ("zeros", "ones"):
            a = rng.normal(float(p.init == "ones"), 0.1, p.shape)
        elif p.init == "a_log":
            a = np.log(rng.uniform(1.0, 16.0, p.shape))
        elif p.init == "dt_bias":
            a = np.log(np.expm1(rng.uniform(1e-3, 1e-1, p.shape)))
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            scale = p.scale if p.scale is not None else fan_in ** -0.5
            a = np.clip(rng.normal(0, 1, p.shape), -2, 2) * scale
        return a.astype(np.float32)
    return jax.tree.map(leaf, table, is_leaf=lambda x: isinstance(x, RP))


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype="float32"):
    """The params (numpy), the reference's prefill of all but the last
    token, one decode step of the last token against the grown cache and
    (in f32) the loss."""
    cfg = dataclasses.replace(r_get_config(arch, smoke=True), dtype=dtype)
    model = r_get_model(cfg)
    params = np_params(model.table(), 11)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, 12).items()}
    head = {k: v for k, v in batch.items() if k != "labels"}
    if "frames" in head:
        head["frames"] = head["frames"].astype(dtype)
    logits, cache = jax.jit(model.prefill)(
        params, dict(head, tokens=batch["tokens"][:, :-1]))
    grown = _np_grow(model, cache, T - 1 + EXTRA)
    dec_logits, dec_cache = jax.jit(model.decode)(
        params, grown, {"token": batch["tokens"][:, -1:],
                        "pos": jnp.asarray(T - 1, jnp.int32)})
    out = {"logits": logits, "cache": cache, "dec_logits": dec_logits,
           "dec_cache": dec_cache}
    if dtype == "float32":
        out["loss"] = jax.jit(model.loss)(params, dict(head, labels=batch[
            "labels"]))
    return params, jax.tree.map(lambda a: np.asarray(a, np.float32), out)


def _port_run(arch, dtype="float32"):
    params, ref = _reference(arch, dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    model = get_model(cfg, device="cpu")
    p = params_from_numpy(params, device="cpu")
    batch = _batch(cfg, 12)
    head = {k: v for k, v in batch.items() if k != "labels"}
    full_logits, _ = model.prefill(p, head)
    logits, cache = model.prefill(p, dict(head,
                                          tokens=batch["tokens"][:, :-1]))
    dec_logits, dec_cache = model.decode(
        p, grow_cache(model, cache, T - 1 + EXTRA, B),
        {"token": batch["tokens"][:, -1:], "pos": T - 1})
    out = {"full_logits": full_logits, "logits": logits, "cache": cache,
           "dec_logits": dec_logits, "dec_cache": dec_cache}
    if dtype == "float32":
        out["loss"] = model.loss(p, batch)
    return out, ref, cfg


def _flat(tree):
    return [_t(a) for a in tree_leaves(tree)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_forward_matches_reference(arch):
    ours, ref, cfg = _port_run(arch)
    for name in ref:   # the port's full_logits: its own consistency below
        got, want = _flat(ours[name]), jax.tree.leaves(ref[name])
        assert [g.shape for g in got] == [w.shape for w in want], name
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=name)
    assert ours["logits"].shape == (B, 1, cfg.vocab)
    # decode(token_T | cache(prompt[:T])) == prefill(prompt[:T+1])
    np.testing.assert_allclose(_t(ours["dec_logits"]),
                               _t(ours["full_logits"]), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-130m"])
def test_bfloat16_matches_reference(arch):
    """bf16 activations: the two packages round the same ops to bf16 but
    not always the same way (XLA keeps some fused chains in f32, its silu
    and sigmoid round otherwise), so most logits differ by an ulp or two
    of the largest one (2^-7 at magnitude 2).  The gap is held to 2e-2 of
    the logits' scale."""
    ours, ref, _ = _port_run(arch, dtype="bfloat16")
    assert ours["logits"].dtype == torch.bfloat16
    for name in ("logits", "dec_logits"):
        scale = max(1.0, float(np.abs(ref[name]).max()))
        gap = float(np.abs(_t(ours[name]) - ref[name]).max())
        assert gap <= BF16_TOL * scale, (name, gap, scale)


def _ssd_inputs(seed, S, dtype):
    rng = np.random.default_rng(seed)
    Bsz, H, Pd, N = 2, 3, 8, 16
    f = functools.partial(np.asarray, dtype=np.float32)
    return (f(rng.normal(0, 1, (Bsz, S, H, Pd))).astype(dtype),
            f(rng.uniform(0.01, 0.2, (Bsz, S, H))),
            -f(rng.uniform(0.5, 2, (H,))),
            f(rng.normal(0, 1, (Bsz, S, N))).astype(dtype),
            f(rng.normal(0, 1, (Bsz, S, N))).astype(dtype),
            f(rng.normal(0, 1, (Bsz, H, N, Pd))))


def _naive(x, dt, A, Bm, Cm):
    state = np.zeros((x.shape[0], x.shape[2], Bm.shape[-1], x.shape[3]))
    y = np.zeros(x.shape)
    for t in range(x.shape[1]):
        dec = np.exp(dt[:, t] * A[None])
        state = dec[:, :, None, None] * state + np.einsum(
            "bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t])
        y[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t], state)
    return y, state


@pytest.mark.parametrize("legacy,S,dtype,init", [
    (False, 32, "float32", False), (True, 32, "float32", True),
    (False, 29, "float32", True), (True, 29, "bfloat16", False),
    (False, 32, "bfloat16", False)])
def test_ssd_chunked_matches_reference(legacy, S, dtype, init):
    """Both ``legacy_f32`` branches; S = 29 pads to a chunk multiple; the
    bf16 cases keep their f32 statistics (within bf16 roundings); the f32
    ones also equal the naive recurrence of ``tests/test_models.py``."""
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(S + legacy, S, np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    s0 = s0 if init else None
    call = functools.partial(r_mamba2.ssd_chunked, chunk=8)
    with (r_act.legacy_f32_internals() if legacy else _nothing()):
        ry, rs = jax.jit(call)(jnp.asarray(x, jdt), dt, A,
                               jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt),
                               initial_state=s0)
    t = functools.partial(torch.tensor)
    with (act.legacy_f32_internals() if legacy else _nothing()):
        y, state = mamba2.ssd_chunked(
            t(x, dtype=tdt), t(dt), t(A), t(Bm, dtype=tdt),
            t(Cm, dtype=tdt), 8,
            initial_state=None if s0 is None else t(s0))
    assert y.dtype == tdt and state.dtype == torch.float32
    assert y.shape == (2, S, 3, 8)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_t(y), np.asarray(ry, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(_t(state), np.asarray(rs), atol=tol, rtol=tol)
    if dtype == "float32" and not init:
        ny, ns = _naive(x, dt, A, Bm, Cm)
        np.testing.assert_allclose(_t(y), ny, atol=TOL)
        np.testing.assert_allclose(_t(state), ns, atol=TOL)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_ssd_chunked_keeps_overflowing_decays_out():
    """A steep decay makes exp(seg) above the diagonal overflow to inf;
    the where picks 0 there, so no NaN reaches the output."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(3, 16, np.float32)
    A = A * 400.0
    ry, _ = jax.jit(functools.partial(r_mamba2.ssd_chunked, chunk=16))(
        x, dt, A, Bm, Cm)
    y, _ = mamba2.ssd_chunked(*map(torch.tensor, (x, dt, A, Bm, Cm)), 16)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(_t(y), np.asarray(ry), atol=TOL, rtol=TOL)


def test_moe_mlp_matches_reference_when_capacity_drops():
    """Capacity factor 0.5 on granite-moe smoke (C = 2 of a group of 12
    tokens x 2 picks over 5 experts): the clamp path drops pairs; router
    column 3 is a copy of column 1, so their scores tie and the lower
    expert wins, as ``lax.top_k`` breaks ties."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m", smoke=True),
                              moe_capacity_factor=0.5)
    r_cfg = dataclasses.replace(r_get_config("granite-moe-3b-a800m",
                                             smoke=True),
                                moe_capacity_factor=0.5)
    rng = np.random.default_rng(21)
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(0, 1, (D, E)),
         "w_gate": rng.normal(0, D ** -0.5, (E, D, F_)),
         "w_up": rng.normal(0, D ** -0.5, (E, D, F_)),
         "w_down": rng.normal(0, F_ ** -0.5, (E, F_, D))}
    p["router"][:, 3] = p["router"][:, 1]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    r_out, r_aux = jax.jit(functools.partial(r_moe.moe_mlp, cfg=r_cfg))(p, x=x)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    out, aux = moe.moe_mlp(tp, cfg, xt)
    np.testing.assert_allclose(_t(out), np.asarray(r_out), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(aux), float(r_aux), atol=TOL, rtol=TOL)
    r = moe.route(tp, cfg, xt.reshape(B, T, D))
    assert r.capacity == 2 and int((r.rank >= r.capacity).sum()) > 0
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", x, p["router"]), -1)
    _, r_topi = jax.lax.top_k(probs, cfg.experts_per_token)
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(r_topi))
    assert (r.probs[..., 1] == r.probs[..., 3]).all()


def test_conv_layernorm_and_positions_match_reference():
    rng = np.random.default_rng(22)
    x = rng.normal(0, 1, (2, 5, 6)).astype(np.float32)
    w = rng.normal(0, 1, (4, 6)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    tail = rng.normal(0, 1, (2, 3, 6)).astype(np.float32)
    for tl in (None, tail):
        ry, rt = jax.jit(r_mamba2._causal_depthwise_conv)(x, w, b, tl)
        y, new_tail = mamba2._causal_depthwise_conv(
            *map(torch.from_numpy, (x, w, b)),
            None if tl is None else torch.from_numpy(tl))
        np.testing.assert_allclose(_t(y), np.asarray(ry), atol=1e-6)
        np.testing.assert_array_equal(_t(new_tail), np.asarray(rt))
    ln = {"w": rng.normal(1, 0.1, 6).astype(np.float32),
          "b": rng.normal(0, 0.1, 6).astype(np.float32)}
    np.testing.assert_allclose(
        _t(encdec.layernorm(torch.from_numpy(x),
                            tree_map(torch.from_numpy, ln))),
        np.asarray(jax.jit(r_encdec.layernorm)(x, ln)), atol=1e-6)
    # torch's and XLA's f32 exp differ by one ulp (3e-8) on some
    # frequencies; at position 1499 that moves an angle by 4.5e-5 rad
    for S, D, off in ((7, 64, 0), (1, 512, 1499), (5, 10, 37)):
        np.testing.assert_allclose(
            _t(encdec.sinusoid_positions(S, D, off)),
            np.asarray(r_encdec.sinusoid_positions(S, D, off)), atol=TOL)
    v = np.array([-50, -30, -1, 0, 1, 19.5, 20, 20.5, 30, 80], np.float32)
    np.testing.assert_allclose(_t(mamba2.softplus(torch.from_numpy(v))),
                               np.asarray(jax.nn.softplus(v)), rtol=1e-6)


def test_grow_cache_pads_only_what_grows():
    """Prompt lengths equal to ssm_heads (8) and conv_kernel - 1 (3): the
    hybrid's KV caches grow to max_seq, its state and tails keep their
    shapes; whisper's cross-attention KV keeps enc_seq."""
    for arch in ("zamba2-2.7b", "whisper-base"):
        model = get_model(get_config(arch, smoke=True), device="cpu")
        for plen in (3, 8, 32):
            specs = model.cache_specs(Shape("p", plen, 1, "prefill"))
            cache = tree_map(lambda s: torch.ones(s.shape, dtype=s.dtype),
                             specs, is_leaf=lambda s: hasattr(s, "shape"))
            grown = grow_cache(model, cache, 40, 1)
            want = model.cache_specs(Shape("s", 40, 1, "decode"))
            assert _spec_list(grown, "torch") == _spec_list(want, "torch")
            for a, g in zip(tree_leaves(cache), tree_leaves(grown)):
                sl = tuple(slice(0, n) for n in a.shape)
                assert torch.equal(g[sl], a) and g.sum() == a.sum()


def test_attention_projections_keep_the_reference_fan_in():
    """ROADMAP C.8: both packages draw a 3-D attention projection at the
    fan-in of its second-to-last axis, wq (D, H, hd) at 1/sqrt(H) and wo
    (H, hd, D) at 1/sqrt(hd), not at D and H * hd; the port keeps it."""
    from repro.models import params as r_params
    from repro_torch.models.params import init_params

    table = {"wq": P((256, 4, 32), ("embed", "heads", None)),
             "wo": P((4, 32, 256), ("heads", None, "embed"))}
    ours = init_params(table, torch.Generator().manual_seed(2),
                       device="cpu")
    ref = jax.jit(lambda k: r_params.init_params(
        {k_: RP(p.shape, p.axes) for k_, p in table.items()}, k))(
            jax.random.key(2))
    std = 0.8796     # a unit normal truncated to [-2, 2]
    for name, fan_in in (("wq", 4), ("wo", 32)):
        for got in (float(ours[name].std()), float(np.std(ref[name]))):
            assert abs(got * np.sqrt(fan_in) / std - 1) < 0.1, (name, got)
