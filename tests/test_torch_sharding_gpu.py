"""The sharding layer on a card: moonshot smoke's expert-parallel dispatch
on a 1 x 1 CUDA ``DeviceMesh`` of an NCCL world of one (params placed by
``make_shardings`` under ``activation_mesh``) == its local dispatch, and
``pipeline_apply`` with one stage on CUDA tensors == the stage.  Marked
``gpu``: they skip where no CUDA device is present, and run with ``python
-m pytest -m gpu tests/test_torch_sharding_gpu.py``.  This file imports
neither ``jax`` nor ``repro``."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.dist.sharding import batch_axes_for, make_shardings, place
from repro_torch.models import get_model, moe
from repro_torch.models.act import activation_mesh
from repro_torch.models.config import Shape
from repro_torch.models.params import tree_map
from repro_torch.serve import grow_cache

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda_mesh(tmp_path_factory):
    """A 1 x 1 ("data", "model") mesh of an NCCL world of one; decided
    here, never at import, so every pytest-xdist worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.distributed.device_mesh import init_device_mesh

    path = tmp_path_factory.mktemp("nccl") / "init"
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def ep_vs_local(device, mesh, B=2, T=16):
    """Prefill of T tokens and one decode step of moonshot smoke, with and
    without the mesh; returns (local, mesh) logits pairs and the EP
    dispatch's call count."""
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    model = get_model(cfg, device)
    params = model.init(torch.Generator(device).manual_seed(5))
    rng = np.random.default_rng(17)
    toks = torch.tensor(rng.integers(0, cfg.vocab - 1, (B, T + 1)),
                        dtype=torch.int32, device=device)
    pre, dec = {"tokens": toks[:, :T]}, {"token": toks[:, T:], "pos": T}
    logits, cache = model.prefill(params, pre)
    dlog, _ = model.decode(params, grow_cache(model, cache, T + 1, B), dec)
    sh = make_shardings(model, mesh, Shape("p", T, B, "prefill"))
    sh_dec = make_shardings(model, mesh, Shape("d", T + 1, B, "decode"))
    placed = place(params, sh.params)
    calls, ep = [], moe._expert_apply_split

    def counted(*a, **kw):
        calls.append(1)
        return ep(*a, **kw)

    moe._expert_apply_split = counted
    try:
        with activation_mesh(mesh, batch_axes_for(mesh)):
            m_logits, m_cache = model.prefill(placed, place(pre, sh.batch))
            m_cache = place(grow_cache(model, tree_map(
                lambda t: t.full_tensor(), m_cache), T + 1, B),
                sh_dec.cache)
            m_dlog, _ = model.decode(placed, m_cache,
                                     place(dec, sh_dec.batch))
    finally:
        moe._expert_apply_split = ep
    return ((logits, m_logits.full_tensor()), (dlog, m_dlog.full_tensor()),
            len(calls), cfg.n_layers)


def test_expert_parallel_dispatch_on_a_cuda_mesh(cuda_mesh):
    pre, dec, calls, layers = ep_vs_local(torch.device("cuda"), cuda_mesh)
    assert calls == 2 * layers
    for a, b in (pre, dec):
        assert b.is_cuda
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
        assert torch.equal(a[:, -1].argmax(-1), b[:, -1].argmax(-1))


def test_pipeline_one_stage_on_cuda(cuda_mesh):
    from torch.distributed.device_mesh import init_device_mesh

    pod = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
    g = torch.Generator("cuda").manual_seed(3)
    w = torch.randn(1, 16, 16, generator=g, device="cuda")
    x = torch.randn(8, 16, generator=g, device="cuda")
    out = pipeline_apply(lambda w, x: torch.tanh(x @ w), w, x, pod, "pod",
                         n_microbatches=4)
    want = torch.cat([torch.tanh(mb @ w[0]) for mb in x.split(2)])
    assert out.is_cuda and torch.equal(out, want)


_FOUR = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.dist.sharding import batch_axes_for, make_shardings, place
from repro_torch.models import get_model
from repro_torch.models.act import activation_mesh
from repro_torch.models.config import Shape
from repro_torch.models.moe import moe_mlp
from repro_torch.models.params import tree_leaves, tree_map
rank, path, backend, kind = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             sys.argv[4])
if kind == "cuda":
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device(kind, rank) if kind == "cuda" else torch.device(kind)
dist.init_process_group(backend, init_method="file://" + path, rank=rank,
                        world_size=4)
errs = {}
pod = init_device_mesh(kind, (4,), mesh_dim_names=("pod",))
g = torch.Generator().manual_seed(0)
w = (0.5 * torch.randn(4, 16, 16, generator=g)).to(dev)
x = torch.randn(8, 16, generator=g).to(dev)
want = x
for s in range(4):
    want = torch.tanh(want @ w[s])
out = pipeline_apply(lambda w, x: torch.tanh(x @ w), w, x, pod, "pod", 4)
errs["pipeline"] = float((out - want).abs().max())
mesh = init_device_mesh(kind, (2, 2), mesh_dim_names=("data", "model"))
S, B = 32, 4
for arch in ("qwen3-1.7b", "moonshot-v1-16b-a3b", "granite-moe-3b-a800m",
             "mamba2-130m"):
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg, dev)
    raw = model.init(torch.Generator(dev).manual_seed(3))
    rng = np.random.default_rng(7)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, S + 1)),
                        dtype=torch.int32, device=dev)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
    leaves = [t.clone().requires_grad_() for t in tree_leaves(raw)]
    it = iter(leaves)
    loss = model.loss(tree_map(lambda _: next(it), raw), batch)
    grads = torch.autograd.grad(loss, leaves)
    sh = make_shardings(model, mesh, Shape("t", S, B, "train"))
    placed = [t.detach().requires_grad_()
              for t in tree_leaves(place(raw, sh.params))]
    it = iter(placed)
    with activation_mesh(mesh, batch_axes_for(mesh)):
        l2 = model.loss(tree_map(lambda _: next(it), raw),
                        place(batch, sh.batch))
        g2 = torch.autograd.grad(l2, placed)
    errs[arch + "/loss"] = abs(float(l2.full_tensor()) - float(loss))
    errs[arch + "/grad"] = max(
        float((a.full_tensor() - b).abs().max() / b.abs().max())
        for a, b in zip(g2, grads))
    if arch == "moonshot-v1-16b-a3b":
        p = tree_map(lambda t: t[0], raw["layers"]["moe"])
        sp = tree_map(lambda s: s[0], place(raw, sh.params)["layers"]["moe"])
        xm = torch.randn(B, S, cfg.d_model, generator=g).to(dev)
        y, _ = moe_mlp(p, cfg, xm)
        with activation_mesh(mesh, batch_axes_for(mesh)):
            y2, _ = moe_mlp(sp, cfg, distribute_tensor(
                xm, mesh, [Shard(0), Replicate()]))
        errs["moe_ep"] = float((y2.full_tensor() - y).abs().max())
dist.destroy_process_group()
if rank == 0:
    print(repr(errs))
print("ok", rank)
"""


def four_ranks(tmp, backend, kind):
    """The sharded paths on a world of 4 (``kind`` "cuda": one card a
    rank, NCCL): their errors against the same code unsharded, rank 0's
    dict."""
    import ast
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _FOUR, str(r),
                               str(tmp / "init"), backend, kind], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and out.strip().endswith(f"ok {r}"), \
            err[-3000:]
    return ast.literal_eval(outs[0][0].strip().splitlines()[0])


def test_sharded_paths_on_four_cards(tmp_path):
    """On 4 cards (NCCL, a (2, 2) mesh and a pipeline of 4): the pipeline,
    the smoke loss and every gradient of qwen3, moonshot (experts split
    over "model"), granite-moe (hidden units split) and mamba2 (channels
    split), and moonshot's EP ``moe_mlp`` == the same code unsharded on
    one card (f32, TF32 off)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    errs = four_ranks(tmp_path, "nccl", "cuda")
    assert errs["pipeline"] < 1e-6, errs
    assert errs["moe_ep"] < 1e-5, errs
    for arch in ("qwen3-1.7b", "moonshot-v1-16b-a3b", "granite-moe-3b-a800m",
                 "mamba2-130m"):
        assert errs[arch + "/loss"] < 1e-5, errs
        assert errs[arch + "/grad"] < 1e-4, errs
