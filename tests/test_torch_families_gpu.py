"""The MoE, Mamba2, hybrid and encoder-decoder families on a card, held
to the same code on the CPU: each non-dense smoke config's prefill and a
decode step against the grown cache (f32, TF32 off), and the
``ServeLoop`` on the mamba2 and granite-moe smoke configs with its
greedy tokens, prefix-cache stats and the index's launches: one stacked
point-kernel launch (B6) per lookup once a segment exists, none before,
and the insert kernel (B1) for each frozen segment's rows.  Marked
``gpu``: they skip where no CUDA device is present, and run with
``python -m pytest -m gpu tests/test_torch_families_gpu.py``.  This file
imports neither ``jax`` nor ``repro``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import insert_resident, point_probe_stacked_resident
from repro_torch.models import get_model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serve import Request, ServeLoop, grow_cache

pytestmark = pytest.mark.gpu

FAMILIES = ["granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "mamba2-130m",
            "zamba2-2.7b", "whisper-base"]


@pytest.fixture
def cuda():
    """The card; decided here, never at import, so every pytest-xdist
    worker collects the same tests.  TF32 stays off: the f32 products are
    compared with the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _models(arch, cuda, seed=0):
    """The smoke model on the CPU and on the card, with the same weights
    (drawn on the CPU, copied)."""
    cfg = get_config(arch, smoke=True)
    cpu, card = get_model(cfg, device="cpu"), get_model(cfg, device=cuda)
    params = cpu.init(torch.Generator().manual_seed(seed))
    return cfg, (cpu, params), (card, tree_map(lambda a: a.to(cuda), params))


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_on_the_card_equal_the_cpu(cuda, arch):
    cfg, (cpu, p_cpu), (card, p_card) = _models(arch, cuda)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab - 1, (2, 24))
    head = {"tokens": toks[:, :-1]}
    if cfg.family == "encdec":
        head["frames"] = rng.normal(0, 1, (2, cfg.enc_seq, cfg.d_model)
                                    ).astype(np.float32)
    out = []
    for model, p in ((cpu, p_cpu), (card, p_card)):
        logits, cache = model.prefill(p, head)
        cache = grow_cache(model, cache, 32, 2)
        dec, new = model.decode(p, cache, {"token": toks[:, -1:],
                                           "pos": 23})
        out.append([t.float().cpu()
                    for t in (logits, *tree_leaves(cache), dec,
                              *tree_leaves(new))])
    assert out[1][0].shape == (2, 1, cfg.vocab)
    for a, b in zip(*out):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def _requests(vocab):
    rng = np.random.default_rng(17)
    return [Request(session=s, max_new_tokens=6,
                    prompt=rng.integers(0, vocab - 1, n).astype(np.int32))
            for s, n in ((0, 40), (1, 33), (2, 17), (0, 40), (1, 24),
                         (2, 16))]


@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-moe-3b-a800m"])
def test_serve_loop_on_the_card_equals_the_cpu_with_one_b6_launch_a_lookup(
        cuda, arch):
    cfg, (cpu, p_cpu), (card, p_card) = _models(arch, cuda, seed=1)
    runs = []
    for model, p, dev in ((cpu, p_cpu, "cpu"), (card, p_card, cuda)):
        loop = ServeLoop(model, p, max_seq=64, batch_slots=3,
                         prefix_chunk=8, device=dev)
        insert_resident.launches = point_probe_stacked_resident.launches = 0
        done = loop.run(_requests(cfg.vocab))
        runs.append(([r.out_tokens for r in done], dict(loop.index.stats),
                     insert_resident.launches,
                     point_probe_stacked_resident.launches))
    (tok_cpu, st_cpu, b1_cpu, b6_cpu), (tok, st, b1, b6) = runs
    assert tok == tok_cpu and st == st_cpu
    assert (b1_cpu, b6_cpu) == (0, 0)
    # batch 1 (5 + 4 + 2 chunks) looks up against no segment, batch 2
    # (5 + 3 + 2) against batch 1's: one B6 launch each, all map hits
    assert b6 == 10 and st["map_hits"] == 10
    # each segment's 3 tenants own keys: 3 main and 3 meta row builds
    assert b1 == 2 * 6
