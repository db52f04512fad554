"""The port's serving loop (``repro_torch.serve.ServeLoop``) on the MoE,
SSM and hybrid families against ``repro.serve`` on the CPU: greedy tokens
and the prefix-cache stats over two batches equal the reference loop's on
the granite-moe, mamba2 and zamba2 smoke configs; and ROADMAP C.7, the
cache grow: at a prompt as long as ``ssm_heads`` the reference's loop
raises and at one of ``conv_kernel - 1`` tokens it returns other tokens
than a greedy prefill and decode, where the port's loop returns those
tokens.  Params are drawn by numpy (``test_torch_families.np_params``)
and carried over by ``params_from_numpy``; each reference loop runs once
per module."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import get_model as r_get_model
from repro.serve import ServeLoop as RServeLoop
from repro.serve.decode import Request as RRequest
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import Request, ServeLoop
from test_torch_families import np_params

SERVED = ["granite-moe-3b-a800m", "mamba2-130m", "zamba2-2.7b"]
MAX_SEQ, SLOTS, CHUNK, NEW = 32, 2, 8, 4


def _requests(cls, vocab):
    """Two batches of two: sessions 3 and 18 with prompts of 20 and 13
    tokens, then the same sessions with prompts of 20 and 9 tokens (each
    batch left-padded to 20, which no constant cache axis equals)."""
    rng = np.random.default_rng(41)
    return [cls(session=ses, max_new_tokens=NEW - (ses == 18),
                prompt=rng.integers(0, vocab - 1, n).astype(np.int32))
            for ses, n in ((3, 20), (18, 13), (3, 20), (18, 9))]


@functools.lru_cache(maxsize=None)
def _r_model(arch):
    model = r_get_model(r_get_config(arch, smoke=True))
    return model, np_params(model.table(), 7)


@functools.lru_cache(maxsize=None)
def _reference_loop(arch):
    model, params = _r_model(arch)
    loop = RServeLoop(model, jax.tree.map(jnp.asarray, params),
                      max_seq=MAX_SEQ, batch_slots=SLOTS, prefix_chunk=CHUNK)
    done = loop.run(_requests(RRequest, model.cfg.vocab))
    return [r.out_tokens for r in done], dict(loop.index.stats)


def _port(arch):
    model = get_model(get_config(arch, smoke=True), device="cpu")
    return model, params_from_numpy(_r_model(arch)[1], "cpu")


@pytest.mark.parametrize("arch", SERVED)
def test_serve_loop_matches_reference(arch):
    tokens, stats = _reference_loop(arch)
    model, params = _port(arch)
    loop = ServeLoop(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS,
                     prefix_chunk=CHUNK, device="cpu")
    done = loop.run(_requests(Request, model.cfg.vocab))
    assert [r.out_tokens for r in done] == tokens
    assert [len(t) for t in tokens] == [4, 3, 4, 3]
    assert dict(loop.index.stats) == stats
    # the second batch finds every whole chunk of the first's prompts
    # (2 + 1 chunks of 8) in the first batch's segment
    assert stats["map_hits"] == 3 and len(loop.index.segments) == 2


def _manual_greedy(prefill, decode, params, prompt, new, grow_kv):
    """Greedy prefill + decode of one prompt, the KV leaves padded to
    MAX_SEQ by hand and every other cache leaf kept as it is."""
    logits, cache = prefill(params, {"tokens": prompt[None]})
    cache = {k: grow_kv(v) if k.startswith("kv_") else v
             for k, v in cache.items()}
    out = []
    for t in range(new):
        nxt = int(np.argmax(np.asarray(logits, np.float32)[0, -1]))
        out.append(nxt)
        logits, cache = decode(params, cache, {
            "token": np.full((1, 1), nxt, np.int32),
            "pos": np.int32(len(prompt) + t)})
    return out


def _pad_seq_np(a):
    return jnp.pad(a, [(0, 0), (0, 0), (0, MAX_SEQ - a.shape[2]), (0, 0),
                       (0, 0)])


def _pad_seq(a):
    return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, MAX_SEQ - a.shape[2]))


@pytest.mark.parametrize("arch,where", [
    ("mamba2-130m", "ssm_heads"), ("mamba2-130m", "conv_tail"),
    ("zamba2-2.7b", "ssm_heads"), ("zamba2-2.7b", "conv_tail")])
def test_grow_keeps_constant_cache_leaves(arch, where):
    """ROADMAP C.7: ``repro``'s ``ServeLoop._grow_cache`` pads every cache
    leaf whose axis 2 equals the prompt length.  A prompt of ssm_heads (8)
    tokens pads the SSM state's head axis and the decode raises; one of
    conv_kernel - 1 (3) pads the conv tails, so decode convolves zeros and
    the tokens diverge.  The port grows each leaf to its decode spec."""
    model, params = _r_model(arch)
    cfg = model.cfg
    plen = cfg.ssm_heads if where == "ssm_heads" else cfg.conv_kernel - 1
    assert plen in (8, 3)
    prompt = np.random.default_rng(43).integers(
        0, cfg.vocab - 1, plen).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    loop = RServeLoop(model, jparams, max_seq=MAX_SEQ, batch_slots=1,
                      prefix_chunk=CHUNK)
    want = _manual_greedy(loop._prefill, loop._decode, jparams, prompt, NEW,
                          _pad_seq_np)
    req = RRequest(session=1, prompt=prompt, max_new_tokens=NEW)
    if where == "ssm_heads":
        with pytest.raises(TypeError):
            loop.run([req])
    else:
        assert loop.run([req])[0].out_tokens != want

    p_model, p_params = _port(arch)
    ours = _manual_greedy(p_model.prefill, p_model.decode, p_params, prompt,
                          NEW, _pad_seq)
    assert ours == want
    p_loop = ServeLoop(p_model, p_params, max_seq=MAX_SEQ, batch_slots=1,
                       prefix_chunk=CHUNK, device="cpu")
    [got] = p_loop.run([Request(session=1, prompt=prompt,
                                max_new_tokens=NEW)])
    assert got.out_tokens == want
