"""The port's models and configs (``repro_torch.models``,
``repro_torch.configs``) against ``repro.models`` / ``repro.configs`` on the
CPU: every arch's ``FULL`` and ``SMOKE`` config field by field, the dense
tables' leaves and parameter counts, ``flash_attention`` (causal, with a
query offset, with a valid-KV length), the f32 accumulation of bf16
products, the five dense/VLM smoke configs' prefill, decode and loss on
the reference's weights carried over by ``params_from_numpy``, KV-head
padding, and model checkpoints opened across packages.  Inputs are drawn
by numpy from fixed seeds; the reference runs once per config (its calls
under ``jax.jit``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as R_ARCH_NAMES
from repro.configs import cells as r_cells
from repro.configs import get_config as r_get_config
from repro.core.bloomrf import BloomRF as RBloomRF
from repro.models import get_model as r_get_model
from repro.models import layers as r_layers
from repro.models.params import P as RP
from repro.models.params import count_params as r_count
from repro.train.checkpoint import restore_checkpoint as r_restore
from repro.train.checkpoint import save_checkpoint as r_save
from repro_torch.configs import ARCH_NAMES, cells, get_config
from repro_torch.models import SHAPES, get_model, layers
from repro_torch.models.params import (P, count_params, init_params,
                                       params_from_numpy, tree_leaves)
from repro_torch.models import MODEL_FAMILIES
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.hybrid import HybridModel
from repro_torch.models.mamba2 import MambaModel
from repro_torch.models.moe import MoEModel
from repro_torch.models.transformer import DenseModel
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint

DENSE = ["qwen3-1.7b", "qwen2.5-3b", "qwen1.5-32b", "granite-8b",
         "pixtral-12b"]
B, T = 2, 12


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return a.detach().float().numpy()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_match_reference(arch):
    assert ARCH_NAMES == R_ARCH_NAMES
    for smoke in (False, True):
        ours, ref = get_config(arch, smoke), r_get_config(arch, smoke)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert (ours.hd, ours.kv_cache_heads, ours.d_inner, ours.ssm_heads,
                ours.supports_long_context) == (
            ref.hd, ref.kv_cache_heads, ref.d_inner, ref.ssm_heads,
            ref.supports_long_context)
    assert [(n, s.name, ok) for n, _, s, ok in cells()] == \
        [(n, s.name, ok) for n, _, s, ok in r_cells()]
    with pytest.raises(KeyError):
        get_config("no-such-arch")


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


@pytest.mark.parametrize("arch", DENSE)
def test_full_tables_and_specs_match_reference(arch):
    cfg = get_config(arch)
    model, r_model = get_model(cfg, device="cpu"), r_get_model(
        r_get_config(arch))
    ours, ref = model.table(), r_model.table()
    assert _leaves(ours, P) == _leaves(ref, RP)
    assert count_params(ours) == \
        sum(int(np.prod(p.shape)) for p in tree_leaves(
            ours, is_leaf=lambda x: isinstance(x, P)))
    assert count_params(ours) == r_count(ref)

    def specs(d, name):
        return {k: (tuple(v.shape), name(v.dtype)) for k, v in d.items()}
    for shape in SHAPES.values():
        assert model.text_len(shape) == r_model.text_len(shape)
        assert specs(model.input_specs(shape), _torch_name) == \
            specs(r_model.input_specs(shape), lambda d: np.dtype(d).name)
        assert [(tuple(s.shape), _torch_name(s.dtype))
                for s in model.cache_specs(shape)] == \
            [(tuple(s.shape), np.dtype(s.dtype).name)
             for s in r_model.cache_specs(shape)]


def _torch_name(dtype):
    return str(dtype).removeprefix("torch.")


def test_unported_families_raise_and_no_card_is_never_the_cpu(monkeypatch):
    """Every family is ported (ROADMAP A.11.2b): each arch builds
    its family's class on the CPU when asked, and no family's model falls
    back to the CPU where no card is present."""
    classes = {"dense": DenseModel, "vlm": DenseModel, "moe": MoEModel,
               "ssm": MambaModel, "hybrid": HybridModel,
               "encdec": EncDecModel}
    assert set(classes) == set(MODEL_FAMILIES)
    for arch in ARCH_NAMES:
        cfg = get_config(arch, smoke=True)
        model = get_model(cfg, device="cpu")
        assert type(model) is classes[cfg.family]
        assert model.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCH_NAMES:
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(get_config(arch, smoke=True))
    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                           "long_500k"}


def test_init_params_draws_each_leaf_from_the_generator():
    table = {"b": P((64, 32), ("embed", "mlp")),
             "a": {"z": P((16,), (None,), "zeros"),
                   "o": P((16,), (None,), "ones"),
                   "l": P((4096,), (None,), "a_log"),
                   "d": P((4096,), (None,), "dt_bias"),
                   "e": P((50, 8), ("vocab", "embed"), scale=0.02)}}
    g = torch.Generator().manual_seed(7)
    p = init_params(table, g, device="cpu")
    again = init_params(table, torch.Generator().manual_seed(7),
                        dtype=torch.bfloat16, device="cpu")
    assert list(p) == ["a", "b"] and list(p["a"]) == ["d", "e", "l", "o",
                                                      "z"]
    assert torch.equal(again["b"], p["b"].to(torch.bfloat16))
    assert p["b"].shape == (64, 32) and p["b"].dtype == torch.float32
    assert p["b"].abs().max() <= 2.0 / np.sqrt(64) + 1e-7
    assert 0.9 < float(p["b"].std() * np.sqrt(64)) / 0.8796 < 1.1
    assert p["a"]["e"].abs().max() <= 0.04 + 1e-7
    assert torch.equal(p["a"]["z"], torch.zeros(16))
    assert torch.equal(p["a"]["o"], torch.ones(16))
    a = torch.exp(p["a"]["l"])
    assert 1.0 <= a.min() and a.max() <= 16.0 + 1e-4
    dt = torch.nn.functional.softplus(p["a"]["d"])
    assert 1e-3 - 1e-6 <= dt.min() and dt.max() <= 1e-1 + 1e-6


def _flash_inputs(seed, Sq, Skv, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Hkv, G, hd = 2, 3, 16
    return (rng.normal(0, 1, (B, Sq, Hkv, G, hd)).astype(dtype),
            rng.normal(0, 1, (B, Skv, Hkv, hd)).astype(dtype),
            rng.normal(0, 1, (B, Skv, Hkv, hd)).astype(dtype))


@pytest.mark.parametrize("case", ["causal", "q_offset", "kv_len"])
def test_flash_attention_matches_reference(case):
    kw = {"causal": dict(causal=True),
          "q_offset": dict(causal=True, q_offset=21),
          "kv_len": dict(causal=False, kv_len=29)}[case]
    Sq = 1 if case == "kv_len" else 19
    q, k, v = _flash_inputs(3, Sq, 40)
    ref = jax.jit(functools.partial(r_layers.flash_attention, block=16,
                                    **kw))(q, k, v)
    ours = layers.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  block=16, **kw)
    np.testing.assert_allclose(_t(ours), _np(ref), atol=1e-5, rtol=0)


def test_bf16_products_accumulate_in_f32():
    """The rmsnorm statistic and the flash scan's score and PV sums are
    f32 sums of bf16 products: rmsnorm equals the reference bit for bit,
    the attention output within one bf16 ulp on a rare element (a bf16
    product sum would differ on most)."""
    bf = functools.partial(torch.tensor, dtype=torch.bfloat16)
    q, k, v = _flash_inputs(5, 64, 64)
    ref = _np(jax.jit(functools.partial(r_layers.flash_attention, causal=True,
                                        block=16))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))))
    ours = _t(layers.flash_attention(bf(q), bf(k), bf(v), causal=True,
                                     block=16))
    np.testing.assert_allclose(ours, ref, rtol=2 ** -8, atol=2 ** -10)
    assert np.mean(ours != ref) < 1e-2
    rng = np.random.default_rng(6)
    x = rng.normal(0, 3, (4, 16, 256)).astype(np.float32)
    w = rng.normal(1, 0.1, 256).astype(np.float32)
    ref = _np(jax.jit(r_layers.rmsnorm)(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(w)))
    np.testing.assert_array_equal(
        _t(layers.rmsnorm(bf(x), torch.from_numpy(w))), ref)


def _batch(cfg, seed, with_labels=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab - 1, (B, T)).astype(np.int32)
    batch = {"tokens": toks}
    if with_labels:
        batch["labels"] = rng.integers(0, cfg.vocab - 1, (B, T)).astype(
            np.int32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            0, 1, (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _grow(cache, extra=4):
    return tuple(np.pad(np.asarray(c, np.float32),
                        [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])
                 for c in cache)


@functools.lru_cache(maxsize=None)
def _r_model(arch, dtype="float32", pad_heads=0):
    """The reference's model and its jitted prefill."""
    cfg = dataclasses.replace(r_get_config(arch, smoke=True), dtype=dtype,
                              kv_cache_pad_heads=pad_heads)
    model = r_get_model(cfg)
    return model, jax.jit(model.prefill)


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype="float32", pad_heads=0):
    """The reference's params (numpy), and its prefill of all but the
    last token, one decode step of the last token against the grown
    cache, and (at the config's own dtype and heads) the loss."""
    model, prefill = _r_model(arch, dtype, pad_heads)
    cfg = model.cfg
    params = model.init(jax.random.key(11))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, 12).items()}
    head = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = prefill(params, dict(head, tokens=batch["tokens"][:,
                                                                       :-1]))
    plen = T - 1 + (cfg.n_patches if cfg.family == "vlm" else 0)
    grown = tuple(jnp.asarray(c, cache[0].dtype) for c in _grow(cache))
    dec_logits, dec_cache = jax.jit(model.decode)(
        params, grown, {"token": batch["tokens"][:, -1:],
                        "pos": jnp.asarray(plen, jnp.int32)})
    out = {"logits": logits, "cache": cache, "dec_logits": dec_logits,
           "dec_cache": dec_cache}
    if (dtype, pad_heads) == ("float32", 0):
        out["loss"] = jax.jit(model.loss)(params, batch)
    return (jax.tree.map(np.asarray, params),
            jax.tree.map(lambda a: np.asarray(a, np.float32), out), plen)


def _port_run(arch, dtype="float32", pad_heads=0):
    params, ref, plen = _reference(arch, dtype, pad_heads)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                              kv_cache_pad_heads=pad_heads)
    model = get_model(cfg, device="cpu")
    p = params_from_numpy(params, device="cpu")
    batch = _batch(cfg, 12)
    head = {k: v for k, v in batch.items() if k != "labels"}
    full_logits, _ = model.prefill(p, head)
    logits, cache = model.prefill(p, dict(head,
                                          tokens=batch["tokens"][:, :-1]))
    grown = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 4))
                  for c in cache)
    dec_logits, dec_cache = model.decode(
        p, grown, {"token": batch["tokens"][:, -1:], "pos": plen})
    out = {"full_logits": full_logits, "logits": logits, "cache": cache,
           "dec_logits": dec_logits, "dec_cache": dec_cache,
           "loss": model.loss(p, batch)}
    return out, ref, cfg


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_forward_matches_reference(arch):
    ours, ref, cfg = _port_run(arch)
    for name in ref:   # the port's full_logits: its own consistency below
        got = ours[name]
        got = [_t(c) for c in got] if isinstance(got, tuple) else _t(got)
        np.testing.assert_allclose(got, ref[name], atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    assert ours["cache"][0].shape == (cfg.n_layers, B, T - 1 + cfg.n_patches,
                                      cfg.kv_cache_heads, cfg.hd)
    # decode(token_T | cache(prompt[:T])) == prefill(prompt[:T+1])
    np.testing.assert_allclose(_t(ours["dec_logits"]),
                               _t(ours["full_logits"]), atol=2e-2, rtol=2e-2)


def test_qwen3_bfloat16_matches_reference():
    ours, ref, _ = _port_run("qwen3-1.7b", dtype="bfloat16")
    assert ours["logits"].dtype == torch.bfloat16
    for name in ("logits", "dec_logits"):
        np.testing.assert_allclose(_t(ours[name]), ref[name], atol=2e-2,
                                   rtol=2e-2, err_msg=name)


def test_kv_cache_head_padding_matches_unpadded_and_reference():
    """qwen2.5's 2 KV heads padded to 4 in the cache: the padded cache's
    first heads are the unpadded cache, the rest zeros, and decode gives
    the unpadded logits, as in the reference."""
    padded, ref, cfg = _port_run("qwen2.5-3b", pad_heads=4)
    plain, _, base = _port_run("qwen2.5-3b")
    assert cfg.kv_cache_heads == 4 and base.kv_cache_heads == 2
    assert padded["cache"][0].shape[-2] == 4
    for a, b in zip(padded["cache"], plain["cache"]):
        assert torch.equal(a[..., :2, :], b)
        assert not a[..., 2:, :].any()
    np.testing.assert_allclose(_t(padded["dec_logits"]),
                               _t(plain["dec_logits"]), atol=1e-4, rtol=1e-4)
    for name in ("dec_logits", "cache"):
        got = padded[name]
        got = [_t(c) for c in got] if isinstance(got, tuple) else _t(got)
        np.testing.assert_allclose(got, ref[name], atol=1e-4, rtol=1e-4)


def test_model_checkpoints_open_across_packages(tmp_path, monkeypatch):
    """The reference's checkpoint of qwen2.5 smoke params restored by the
    port gives the reference's prefill logits; the port's checkpoint of
    its own params restored by the reference gives the port's."""
    build = RBloomRF.build      # the shard filters' builds under jax.jit
    monkeypatch.setattr(RBloomRF, "build", lambda self, keys: jax.jit(
        functools.partial(build, self))(keys))
    arch = "qwen2.5-3b"
    params, ref, _ = _reference(arch)
    r_model, r_prefill = _r_model(arch)
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg, device="cpu")
    head = {"tokens": _batch(cfg, 12)["tokens"][:, :-1]}
    r_save(str(tmp_path / "ref"), 3, jax.tree.map(jnp.asarray, params),
           n_shards=2)
    like = model.init(torch.Generator().manual_seed(0))
    restored = restore_checkpoint(str(tmp_path / "ref"), 3, like)
    np.testing.assert_allclose(_t(model.prefill(restored, head)[0]),
                               ref["logits"], atol=1e-4, rtol=1e-4)

    ours = model.init(torch.Generator().manual_seed(5))
    save_checkpoint(str(tmp_path / "port"), 4, ours, n_shards=2,
                    device="cpu")
    back = r_restore(str(tmp_path / "port"), 4,
                     jax.tree.map(jnp.asarray, params))
    r_logits, _ = r_prefill(back, {"tokens": jnp.asarray(head["tokens"])})
    np.testing.assert_allclose(_t(model.prefill(ours, head)[0]),
                               _np(r_logits), atol=1e-4, rtol=1e-4)
