"""The training stratum on a card, held to the same code on the CPU (f32,
TF32 off, attention projections at their true fan-in, ROADMAP C.8/C.9):
one train step of each smoke family (loss, grad norm, the step's clipped
gradient and the params, by the rule of ``tests/test_torch_train.py``),
the rmsnorm and flash Functions' outputs and gradients, and a Trainer
that checkpoints through the insert kernel (B1, one launch a shard
filter) and resumes to the straight run's losses.  Marked ``gpu``: they
skip where no CUDA device is present, and run with ``python -m pytest -m
gpu tests/test_torch_train_gpu.py``.  This file imports neither ``jax``
nor ``repro``."""
import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist.compression import ef_init
from repro_torch.kernels import insert_resident
from repro_torch.models import get_model, layers
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import (OptConfig, TrainConfig, Trainer, adamw_init,
                               latest_step, make_train_step)

pytestmark = pytest.mark.gpu

TOL = 1e-4
RESOLVED = 1e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


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


def _tamed(tree):
    """Attention projections rescaled to their true fan-in (C.8)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("wq", "wk", "wv") and not isinstance(v, dict):
            out[k] = v * math.sqrt(v.shape[-2] / v.shape[-3])
        elif k == "wo" and not isinstance(v, dict):
            out[k] = v / math.sqrt(v.shape[-3])
        else:
            out[k] = _tamed(v)
    return out


def _batch(cfg, seed, B=4, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab - 1, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)
                                     ).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch,mb,ef", [
    ("qwen3-1.7b", 1, False), ("granite-moe-3b-a800m", 2, True),
    ("mamba2-130m", 1, False), ("zamba2-2.7b", 1, False),
    ("whisper-base", 2, False)])
def test_train_step_on_the_card_equals_the_cpu(cuda, arch, mb, ef):
    cfg = get_config(arch, smoke=True)
    base = _tamed(get_model(cfg, "cpu").init(
        torch.Generator().manual_seed(3)))
    batch = _batch(cfg, 4)
    runs = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.clone().to(dev), base)
        step = make_train_step(get_model(cfg, dev), OptConfig(**OPT),
                               TrainConfig(microbatches=mb,
                                           grad_compression=ef))
        p, o, e, m = step(p, adamw_init(p), ef_init(p) if ef else {}, batch)
        runs.append(([a.cpu().numpy() for a in tree_leaves(p)],
                     [a.cpu().numpy() for a in tree_leaves(o["m"])],
                     {k: float(v) for k, v in m.items()}))
    (p_cpu, m_cpu, met_cpu), (p_gpu, m_gpu, met_gpu) = runs
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(met_gpu[k], met_cpu[k], rtol=TOL)
    lr = met_cpu["lr"]
    for p0, pa, ma, pb, mb_ in zip(tree_leaves(base), p_gpu, m_gpu, p_cpu,
                                   m_cpu):
        ga, gb = ma / 0.1, mb_ / 0.1
        scale = float(np.abs(gb).max())
        quantum = scale / 127 if ef else 0.0
        assert np.abs(ga - gb).max() <= TOL * scale + quantum * (1 + 1e-3)
        d = np.abs(pa - pb)
        assert (d[np.abs(gb) > RESOLVED] <= TOL).all()
        assert (d <= 2 * lr * (1 + 0.1 * np.abs(p0.numpy())) + TOL).all()


def _grads(fn, inputs, dout):
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    out = fn(*xs)
    return [out.detach()] + list(torch.autograd.grad(out, xs, dout))


@pytest.mark.parametrize("causal,q_offset,skv", [(True, 0, 48),
                                                 (False, 0, 50),
                                                 (True, 6, 41)])
def test_layer_functions_on_the_card_equal_the_cpu(cuda, causal, q_offset,
                                                   skv):
    rng = np.random.default_rng(5)

    def pair(*shape):
        a = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        return a, a.to(cuda)

    q, qd = pair(2, 40, 2, 3, 32)
    k, kd = pair(2, skv, 2, 32)
    v, vd = pair(2, skv, 2, 32)
    do, dod = pair(2, 40, 2, 3, 32)
    x, xd = pair(3, 24, 96)
    w, wd = pair(96)

    def flash(a, b, c):
        return layers.flash_attention(a, b, c, causal=causal,
                                      q_offset=q_offset, block=16)

    def norm(a, b):
        return layers.rmsnorm(a, b, 1e-6)

    pairs = list(zip(_grads(flash, (qd, kd, vd), dod),
                     _grads(flash, (q, k, v), do)))
    pairs += list(zip(_grads(norm, (xd, wd), xd), _grads(norm, (x, w), x)))
    for got, want in pairs:
        assert got.device.type == "cuda"
        scale = max(1.0, float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale


def test_trainer_checkpoints_through_b1_and_resumes(cuda, tmp_path):
    """A Trainer on the card saves its checkpoints' shard filters through
    the insert kernel and a second Trainer resumes from the last one to
    the straight run's losses."""
    cfg = get_config("qwen2.5-3b", smoke=True)
    model = get_model(cfg, cuda)
    base = _tamed(model.init(torch.Generator(cuda).manual_seed(6)))
    batch = _batch(cfg, 7, S=32)

    def make(steps, ckpt=None):
        return Trainer(model, tree_map(torch.clone, base), OptConfig(**OPT),
                       TrainConfig(steps=steps, checkpoint_every=3,
                                   log_every=1),
                       itertools.repeat(batch), ckpt_dir=ckpt)

    straight = make(6).run()
    insert_resident.launches = 0
    make(3, str(tmp_path)).run()                 # saves step 2
    assert latest_step(str(tmp_path)) == 2
    assert insert_resident.launches == 2         # two shard filters
    resumed = make(6, str(tmp_path))
    assert resumed.start_step == 3
    log = resumed.run()
    np.testing.assert_allclose([r["loss"] for r in log],
                               [r["loss"] for r in straight[3:]], rtol=TOL)
