"""The port's serving loop and paged KV cache (``repro_torch.serve``)
against ``repro.serve`` on the CPU: ``PagedKVCache`` driven with the
reference's call sequence (pages, refs and tables equal, gathers bit for
bit), and ``ServeLoop`` on qwen3 smoke over two batches, the second
reusing the first's sessions (greedy tokens and the prefix-cache stats
equal the reference loop's), on the reference's weights carried over by
``params_from_numpy``.  The reference loop runs once per module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import get_model as r_get_model
from repro.serve import PagedKVCache as RPaged
from repro.serve import ServeLoop as RServeLoop
from repro.serve.decode import Request as RRequest
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import PagedKVCache, Request, ServeLoop

ARCH = "qwen3-1.7b"
MAX_SEQ, SLOTS, CHUNK, NEW = 40, 2, 8, 5


def _requests(cls, vocab):
    """Two batches of two: sessions 3 and 18 (tenants 3 and 2 of the
    index's 16) with prompts of 20 and 13 tokens, then the same sessions
    with new prompts of 20 and 9 tokens (left-padded to 20)."""
    rng = np.random.default_rng(31)
    out = []
    for ses, n in ((3, 20), (18, 13), (3, 20), (18, 9)):
        out.append(cls(session=ses, max_new_tokens=NEW - (ses == 18),
                       prompt=rng.integers(0, vocab - 1, n).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def reference():
    cfg = r_get_config(ARCH, smoke=True)
    model = r_get_model(cfg)
    params = jax.jit(model.init)(jax.random.key(4))   # one compile
    loop = RServeLoop(model, params, max_seq=MAX_SEQ, batch_slots=SLOTS,
                      prefix_chunk=CHUNK)
    done = loop.run(_requests(RRequest, cfg.vocab))
    return (jax.tree.map(np.asarray, params),
            [r.out_tokens for r in done], dict(loop.index.stats))


def _loop(params, **kw):
    cfg = get_config(ARCH, smoke=True)
    model = get_model(cfg, device="cpu")
    return cfg, model, ServeLoop(model, params_from_numpy(params, "cpu"),
                                 max_seq=MAX_SEQ, batch_slots=SLOTS,
                                 prefix_chunk=CHUNK, device="cpu", **kw)


def test_serve_loop_matches_reference(reference):
    params, tokens, stats = reference
    cfg, _, loop = _loop(params)
    done = loop.run(_requests(Request, cfg.vocab))
    assert [r.out_tokens for r in done] == tokens
    assert [len(t) for t in tokens] == [5, 4, 5, 4]
    assert dict(loop.index.stats) == stats
    # the second batch finds every whole chunk of the first's prompts
    # (2 + 1 chunks of 8) in the first batch's segment
    assert stats["map_hits"] == 3 and len(loop.index.segments) == 2


def test_serve_loop_matches_manual_greedy(reference):
    """The loop's tokens for one request equal a manual greedy prefill and
    decode of the port (the reference's own test, in the port)."""
    params = reference[0]
    cfg, model, loop = _loop(params)
    loop.slots = 1
    prompt = np.random.default_rng(5).integers(0, cfg.vocab - 1, 12).astype(
        np.int32)
    [req] = loop.run([Request(session=1, prompt=prompt, max_new_tokens=5)])
    p = loop.params
    logits, cache = model.prefill(p, {"tokens": prompt[None]})
    cache = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0,
                                              MAX_SEQ - len(prompt)))
                  for c in cache)
    want = []
    for t in range(5):
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        want.append(int(nxt[0]))
        logits, cache = model.decode(p, cache, {"token": nxt[:, None],
                                                "pos": len(prompt) + t})
    assert req.out_tokens == want


def test_temperature_sampling_draws_from_the_loop_generator(reference):
    params = reference[0]
    outs = []
    for seed in (0, 0, 1):
        cfg, _, loop = _loop(params, seed=seed)
        reqs = _requests(Request, cfg.vocab)[:2]
        for r in reqs:
            r.temperature = 1.5
        outs.append([r.out_tokens for r in loop.run(reqs)])
    assert outs[0] == outs[1] != outs[2]
    assert all(0 <= t < cfg.vocab for r in outs[2] for t in r)


def _paged_sequence(cls, arr, **dev):
    """The reference's paged-cache test as a call sequence: what every
    call returns, each gather, and the allocator's state."""
    rng = np.random.default_rng(8)
    pc = cls(n_layers=2, n_pages=16, page_size=8, n_kv=2, head_dim=4,
             **dev)
    k = rng.normal(0, 1, (2, 20, 2, 4)).astype(np.float32)
    v = rng.normal(0, 1, (2, 20, 2, 4)).astype(np.float32)
    out = [pc.alloc_seq(7, 20)]
    pc.write_prefill(7, arr(k), arr(v))
    out.append(pc.gather_cache([7], max_pages=3))
    pc.write_token(7, 20, arr(k[:, 3:4]), arr(v[:, 5:6]))
    out.append(pc.gather_cache([7], max_pages=3))
    pages = pc.alloc_seq(1, 16)
    pc.share_pages(2, pages)
    out.append(pages)
    pc.write_prefill(1, arr(k[:, :13]), arr(v[:, 7:]))
    pc.write_token(1, 13, arr(k[:, :1]), arr(v[:, :1]))   # extends seq 1
    out.append(pc.gather_cache([2, 1, 7], max_pages=3))
    out.append((list(pc.free), pc.refs.tolist(), dict(pc.tables)))
    pc.free_seq(7)
    pc.free_seq(1)
    out.append((list(pc.free), pc.refs.tolist(), dict(pc.tables)))
    pc.free_seq(2)
    out.append((list(pc.free), pc.refs.tolist()))
    return out, (pc.k, pc.v)


def _bits(x):
    """A bf16 array's bits (from either package)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def test_paged_kv_cache_matches_reference():
    ref, ref_pool = _paged_sequence(
        RPaged, lambda a: jnp.asarray(a, jnp.bfloat16))
    ours, pool = _paged_sequence(
        PagedKVCache, lambda a: torch.from_numpy(a).to(torch.bfloat16),
        device="cpu")
    assert pool[0].dtype == torch.bfloat16
    assert len(ours) == len(ref)
    for got, want in zip(ours, ref):
        if isinstance(want, tuple) and hasattr(want[0], "dtype"):
            assert [g.shape for g in got] == [w.shape for w in want]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_bits(g), _bits(w))
        else:
            assert got == want
    for g, w in zip(pool, ref_pool):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                          reference):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, model, _ = _loop(reference[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeLoop(model, {}, max_seq=MAX_SEQ)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(1, 2, 4, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
