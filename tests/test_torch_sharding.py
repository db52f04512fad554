"""The port's sharding layer against the reference's.

* Spec trees: ``repro_torch.dist.sharding.make_specs`` equals the
  reference's ``make_shardings(...)`` specs entry for entry on every config
  (smoke) x shape x mesh, the reference on an ``AbstractMesh`` in-process.
* Numbers on 4 ranks: two spawned JAX processes with 4 faked devices
  (pipelines, models) and one spawned gloo world of 4 for the port, all
  fed the same seeded numpy inputs: ``pipeline_apply``, moonshot smoke's
  expert-parallel ``moe_mlp`` under a (data=2, model=2) mesh, and the
  smoke losses and gradients of qwen3, moonshot and mamba2 with their
  params placed by ``make_shardings``.
* ``constrain`` with no mesh, and ``place`` / ``elastic_restore`` on an
  in-process gloo world of one.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES, get_config, shape_applicable
from repro.dist.sharding import make_shardings as ref_make_shardings
from repro.models import SHAPES, get_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.dist.sharding import make_specs
from repro_torch.models import get_model as t_get_model
from repro_torch.models.act import constrain, current_mesh
from repro_torch.models.moe import moe_mlp, moe_table
from repro_torch.models.params import PS, P, tree_leaves, tree_map

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_SRC = os.path.join(_ROOT, "src")

_MESHES = {(2, 4): ("data", "model"), (16, 16): ("data", "model"),
           (2, 16, 16): ("pod", "data", "model")}


def _norm(entry):
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 \
        else entry


@pytest.mark.parametrize("mesh_shape", list(_MESHES), ids=str)
def test_spec_trees_equal_the_reference(mesh_shape):
    names = _MESHES[mesh_shape]
    am = AbstractMesh(mesh_shape, names)
    n = 0
    for arch in ARCH_NAMES:
        model = get_model(get_config(arch, smoke=True))
        tmodel = t_get_model(t_get_config(arch, smoke=True), device="cpu")
        for name, shape in SHAPES.items():
            if not shape_applicable(model.cfg, shape):
                continue
            ref = ref_make_shardings(model, am, shape)
            port = make_specs(tmodel, dict(zip(names, mesh_shape)), shape)
            for part in ("params", "batch", "cache"):
                want = [tuple(_norm(e) for e in ns.spec)
                        for ns in jax.tree.leaves(
                            getattr(ref, part),
                            is_leaf=lambda x: hasattr(x, "spec"))]
                got = [tuple(_norm(e) for e in ps)
                       for ps in tree_leaves(getattr(port, part),
                                             is_leaf=lambda x:
                                             isinstance(x, PS))]
                assert got == want, (arch, name, part)
                n += len(got)
    assert n > 500


def test_constrain_without_a_mesh_is_the_identity():
    assert current_mesh() is None
    x = torch.randn(2, 3, 4)
    assert constrain(x, ("batch", None, "model")) is x


# ---------------------------------------------------------------------------
# 4 ranks: the reference on 4 faked devices, the port on a gloo world of 4
# ---------------------------------------------------------------------------

_QWEN_SHAPE = (32, 4)          # seq, batch: the batch divides data = 2
_MOE_X = (4, 16)               # batch, seq of moe_mlp's input
# the smoke models whose sharded loss and gradients on (data=2, model=2)
# are held against the reference's, by their inputs' prefix
_GRAD_ARCHS = {"gq": "qwen3-1.7b", "gm": "moonshot-v1-16b-a3b",
               "gs": "mamba2-130m"}


def _np_params(table, seed):
    """f32 params drawn by numpy leaf by leaf from a port table (the
    reference's inits; attention projections at their true fan-in)."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        if p.init in ("zeros", "ones"):
            return rng.normal(float(p.init == "ones"), 0.1,
                              p.shape).astype(np.float32)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale if p.scale is not None else fan_in ** -0.5
        return (np.clip(rng.normal(0, 1, p.shape), -2, 2) *
                scale).astype(np.float32)
    return tree_map(leaf, table, is_leaf=lambda x: isinstance(x, P))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, last = key[len(prefix):].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(25)
    qcfg = t_get_config("qwen3-1.7b", smoke=True)
    qmodel = t_get_model(qcfg, device="cpu")
    mcfg = t_get_config("moonshot-v1-16b-a3b", smoke=True)
    S, B = _QWEN_SHAPE
    tokens = rng.integers(0, qcfg.vocab, (B, S)).astype(np.int32)
    out = {
        "tanh_w": (rng.normal(0, 0.5, (4, 16, 16))).astype(np.float32),
        "tanh_x": rng.normal(0, 1, (8, 16)).astype(np.float32),
        "moe_x": rng.normal(0, 1, _MOE_X + (mcfg.d_model,)).astype(
            np.float32),
        "tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
    }
    out.update({"moe/" + k: v for k, v in
                _flat(_np_params(moe_table(mcfg), 1)).items()})
    out.update({"qwen/" + k: v for k, v in
                _flat(_np_params(qmodel.table(), 2)).items()})
    for seed, (key, arch) in enumerate(_GRAD_ARCHS.items(), 4):
        table = t_get_model(t_get_config(arch, smoke=True),
                            device="cpu").table()
        out.update({key + "/" + k: v for k, v in
                    _flat(_np_params(table, seed)).items()})
    return out


_DROP_CF = 0.5                 # moonshot smoke's capacity at which tokens drop

_REF = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.dist.pipeline import pipeline_apply
from repro.dist.sharding import make_shardings
from repro.models import get_model
from repro.models.act import activation_mesh
from repro.models.config import Shape
from repro.models.moe import moe_mlp, moe_table
from repro.models.params import pspecs
from jax.sharding import NamedSharding, PartitionSpec as PS
inp = dict(np.load(sys.argv[1]))
_DROP_CF = float(sys.argv[4])

def unflat(prefix):
    tree = {}
    for key, v in inp.items():
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(v)
    return tree

out = {}
if sys.argv[6] == "pipeline":
    pod = jax.make_mesh((4,), ("pod",))
    params = {"a": jnp.arange(1., 5., dtype=jnp.float32),
              "b": jnp.full((4,), 0.5, jnp.float32)}
    x = jnp.arange(8., dtype=jnp.float32).reshape(8, 1)
    out["pipe_affine"] = pipeline_apply(lambda w, x: x * w["a"] + w["b"],
                                        params, x, pod, "pod",
                                        n_microbatches=4)
    for mb in (2, 4):
        out[f"pipe_tanh_{mb}"] = pipeline_apply(
            lambda w, x: jnp.tanh(x @ w), jnp.asarray(inp["tanh_w"]),
            jnp.asarray(inp["tanh_x"]), pod, "pod", n_microbatches=mb)
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    print("REF-OK")
    sys.exit(0)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
msz = {"data": 2, "model": 2}
cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
p = unflat("moe/")
specs = pspecs(moe_table(cfg), msz, fsdp_axes=("data",))
named = lambda s: NamedSharding(mesh, s)
x_sh = named(PS("data", None, None))
with activation_mesh(mesh, ("data",)):
    y, aux = jax.jit(lambda p, x: moe_mlp(p, cfg, x),
                     in_shardings=(jax.tree.map(named, specs), x_sh))(
        p, jnp.asarray(inp["moe_x"]))
out["moe_y"], out["moe_aux"] = y, aux
drop = dataclasses.replace(cfg, moe_capacity_factor=_DROP_CF)
fn = jax.jit(lambda p, x: moe_mlp(p, drop, x)[0])
with activation_mesh(mesh, ("data",)):
    out["drop_ep"] = jax.jit(lambda p, x: moe_mlp(p, drop, x)[0],
                             in_shardings=(jax.tree.map(named, specs), x_sh))(
        p, jnp.asarray(inp["moe_x"]))
out["drop_local"] = fn(p, jnp.asarray(inp["moe_x"]))
qcfg = get_config("qwen3-1.7b", smoke=True)
model = get_model(qcfg)
S, B = [int(v) for v in sys.argv[3].split(",")]
sh = make_shardings(model, mesh, Shape("t", S, B, "train"))
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
with activation_mesh(mesh, ("data",)):
    out["qwen_loss"] = jax.jit(model.loss, in_shardings=(sh.params, sh.batch))(
        unflat("qwen/"), batch)
for key, arch in (a.split("=") for a in sys.argv[5].split(",")):
    m = get_model(get_config(arch, smoke=True))
    sh = make_shardings(m, mesh, Shape("t", S, B, "train"))
    with activation_mesh(mesh, ("data",)):
        loss, grad = jax.jit(jax.value_and_grad(m.loss),
                             in_shardings=(sh.params, sh.batch))(
            unflat(key + "/"), batch)
    out[key + "_loss"] = loss
    for path, g in jax.tree_util.tree_flatten_with_path(grad)[0]:
        out[key + "_grad/" + "/".join(k.key for k in path)] = g
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("REF-OK")
"""

_PORT = r"""
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.dist.pipeline import pipeline_apply
from repro_torch.dist.sharding import (NamedSharding, batch_axes_for,
                                       make_shardings, place)
from repro_torch.models import get_model
from repro_torch.models.act import activation_mesh
from repro_torch.models.config import Shape
from repro_torch.models.moe import moe_mlp, moe_table
from repro_torch.models.params import pspecs, tree_leaves, tree_map
rank, path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + path, rank=rank,
                        world_size=4)
inp = dict(np.load(sys.argv[4]))

def unflat(prefix):
    tree = {}
    for key, v in inp.items():
        if key.startswith(prefix):
            *p, last = key[len(prefix):].split("/")
            node = tree
            for k in p:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(v)
    return tree

out = {}
pod = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
params = {"a": torch.arange(1., 5.), "b": torch.full((4,), 0.5)}
x = torch.arange(8.).reshape(8, 1)
out["pipe_affine"] = pipeline_apply(lambda w, x: x * w["a"] + w["b"],
                                    params, x, pod, "pod", n_microbatches=4)
for mb in (2, 4):
    out[f"pipe_tanh_{mb}"] = pipeline_apply(
        lambda w, x: torch.tanh(x @ w), torch.from_numpy(inp["tanh_w"]),
        torch.from_numpy(inp["tanh_x"]), pod, "pod", n_microbatches=mb)
for bad, err in ((lambda: pipeline_apply(None, params, x, pod, "model", 4),
                  KeyError),
                 (lambda: pipeline_apply(None, params, x, pod, "pod", 3),
                  ValueError),
                 (lambda: pipeline_apply(None, {"a": torch.ones(3)}, x, pod,
                                         "pod", 4), ValueError)):
    try:
        bad()
        raise AssertionError("no error")
    except err:
        pass
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
specs = pspecs(moe_table(cfg), {"data": 2, "model": 2}, fsdp_axes=("data",))
p = place(unflat("moe/"), tree_map(lambda s: NamedSharding(mesh, s), specs))
xm = distribute_tensor(torch.from_numpy(inp["moe_x"]), mesh,
                       [Shard(0), Replicate()])
with activation_mesh(mesh, batch_axes_for(mesh)):
    y, aux = moe_mlp(p, cfg, xm)
out["moe_y"], out["moe_aux"] = y.full_tensor(), aux.full_tensor()
drop = dataclasses.replace(cfg, moe_capacity_factor=float(sys.argv[6]))
with activation_mesh(mesh, batch_axes_for(mesh)):
    out["drop_ep"] = moe_mlp(p, drop, xm)[0].full_tensor()
qcfg = get_config("qwen3-1.7b", smoke=True)
model = get_model(qcfg, device="cpu")
S, B = [int(v) for v in sys.argv[5].split(",")]
sh = make_shardings(model, mesh, Shape("t", S, B, "train"))
params = place(unflat("qwen/"), sh.params)
tokens = {"tokens": torch.from_numpy(inp["tokens"]),
          "labels": torch.from_numpy(inp["labels"])}
batch = place(tokens, sh.batch)

def flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from flat_paths(tree[k], prefix + k + "/")
    else:
        yield prefix[:-1], tree

with activation_mesh(mesh, batch_axes_for(mesh)):
    loss = model.loss(params, batch)
out["qwen_loss"] = loss.full_tensor()
for key, arch in (a.split("=") for a in sys.argv[7].split(",")):
    m = get_model(get_config(arch, smoke=True), device="cpu")
    sh = make_shardings(m, mesh, Shape("t", S, B, "train"))
    placed = place(unflat(key + "/"), sh.params)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(placed)]
    it = iter(leaves)
    with activation_mesh(mesh, batch_axes_for(mesh)):
        loss = m.loss(tree_map(lambda _: next(it), placed),
                      place(tokens, sh.batch))
        grads = torch.autograd.grad(loss, leaves)
    out[key + "_loss"] = loss.full_tensor()
    it = iter(grads)
    flat = tree_map(lambda _: next(it).full_tensor(), placed)
    out.update({key + "_grad/" + k: v for k, v in flat_paths(flat)})
wide = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))


def err(got, want):
    return max(float((g.full_tensor() - w).abs().max() / w.abs().max())
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


for arch, mesh in (("qwen3-1.7b", mesh), ("moonshot-v1-16b-a3b", mesh),
                   ("granite-moe-3b-a800m", mesh), ("qwen3-1.7b@1x4", wide),
                   ("qwen3-1.7b@6q2kv@1x4", wide), ("mamba2-130m", mesh),
                   ("mamba2-130m@1x4", wide)):
    cfg = get_config(arch.split("@")[0], smoke=True)
    if arch == "mamba2-130m@1x4":      # 2 heads: each straddles 2 ranks
        cfg = dataclasses.replace(cfg, ssm_head_dim=64)
    if arch == "qwen3-1.7b@6q2kv@1x4":  # 4 divides neither head count
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=2)
    m = get_model(cfg, device="cpu")
    toks = {k: v % cfg.vocab for k, v in tokens.items()}
    sh = make_shardings(m, mesh, Shape("t", S, B, "train"))
    raw = m.init(torch.Generator().manual_seed(3))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(raw)]
    it = iter(leaves)
    want = torch.autograd.grad(m.loss(tree_map(lambda _: next(it), raw),
                                      toks), leaves)
    placed = [t.detach().requires_grad_() for t in tree_leaves(
        place(raw, sh.params))]
    it = iter(placed)
    with activation_mesh(mesh, batch_axes_for(mesh)):
        got = torch.autograd.grad(m.loss(tree_map(lambda _: next(it), raw),
                                         place(toks, sh.batch)), placed)
    out["grad_err/" + arch] = torch.tensor(err(got, want))
    if cfg.family != "ssm":
        continue
    # prefill, then a decode step on the prefill's cache
    shp = make_shardings(m, mesh, Shape("p", S, B, "prefill"))
    shd = make_shardings(m, mesh, Shape("d", S, B, "decode"))
    pb = {"tokens": toks["tokens"]}
    db = {"token": toks["labels"][:, -1:], "pos": S}
    want = m.prefill(raw, pb)
    want = (want, m.decode(raw, want[1], db))
    with activation_mesh(mesh, batch_axes_for(mesh)):
        got = m.prefill(place(raw, shp.params), place(pb, shp.batch))
        got = (got, m.decode(place(raw, shd.params), got[1],
                             place(db, shd.batch)))
    out["serve_err/" + arch] = torch.tensor(err(got, want))
if rank == 0:
    np.savez(out_path, **{k: v.detach().numpy() for k, v in out.items()})
dist.destroy_process_group()
print("ok", rank)
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Both packages' results on 4 ranks, from JAX processes with 4
    faked devices and one gloo world of 4, run side by side."""
    tmp = tmp_path_factory.mktemp("four")
    inp = tmp / "inputs.npz"
    np.savez(inp, **_inputs())
    shape = ",".join(str(v) for v in _QWEN_SHAPE)
    env = {**os.environ, "PYTHONPATH": _SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "OMP_NUM_THREADS": "1"}
    archs = ",".join(f"{k}={a}" for k, a in _GRAD_ARCHS.items())
    # the reference's pipelines and its models in two processes, side by
    # side (its eager pipeline_apply takes most of a process's time)
    ref = [subprocess.Popen([sys.executable, "-c", _REF, str(inp),
                             str(tmp / f"ref_{part}.npz"), shape,
                             str(_DROP_CF), archs, part], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True) for part in ("pipeline", "models")]
    port = [subprocess.Popen([sys.executable, "-c", _PORT, str(r),
                              str(tmp / "init"), str(tmp / "port.npz"),
                              str(inp), shape, str(_DROP_CF), archs],
                             env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for r in range(4)]
    for r, p in enumerate(port):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0 and out.strip() == f"ok {r}", err[-3000:]
    for p in ref:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0 and "REF-OK" in out, err[-3000:]
    return ({**np.load(tmp / "ref_pipeline.npz"),
             **np.load(tmp / "ref_models.npz")},
            dict(np.load(tmp / "port.npz")))


def test_pipeline_four_stages_bit_for_bit(four_ranks):
    ref, port = four_ranks
    want = np.arange(8., dtype=np.float32).reshape(8, 1)
    for s in range(4):
        want = want * (s + 1.) + 0.5
    np.testing.assert_array_equal(port["pipe_affine"], ref["pipe_affine"])
    np.testing.assert_array_equal(port["pipe_affine"], want)


@pytest.mark.parametrize("mb", [2, 4])
def test_pipeline_tanh_stages(four_ranks, mb):
    ref, port = four_ranks
    inp = _inputs()
    want = inp["tanh_x"]
    for s in range(4):
        want = np.tanh(want @ inp["tanh_w"][s])
    np.testing.assert_allclose(port[f"pipe_tanh_{mb}"], ref[f"pipe_tanh_{mb}"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port[f"pipe_tanh_{mb}"], want, rtol=0,
                               atol=1e-6)


def test_expert_parallel_moe_matches_reference_and_local(four_ranks):
    """E = 4 experts over 2 model ranks: the port's EP dispatch == the
    reference's shard_map EP, and == the port's local dispatch of the
    same tokens (moonshot smoke's capacity factor 8 drops no token)."""
    ref, port = four_ranks
    np.testing.assert_allclose(port["moe_y"], ref["moe_y"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(port["moe_aux"], ref["moe_aux"], rtol=0,
                               atol=1e-5)
    cfg = t_get_config("moonshot-v1-16b-a3b", smoke=True)
    inp = _inputs()
    p = tree_map(torch.from_numpy, _unflat(inp, "moe/"))
    y, aux = moe_mlp(p, cfg, torch.from_numpy(inp["moe_x"]))
    np.testing.assert_allclose(port["moe_y"], y.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port["moe_aux"], aux.numpy(), rtol=0,
                               atol=1e-5)


def test_expert_parallel_moe_with_drops(four_ranks):
    """At a capacity that drops tokens the port's EP dispatch == its local
    dispatch == the reference's local dispatch; the reference's EP
    differs (ROADMAP C.10: its shard_map body scatters a dropped (token,
    k)'s row into its expert's last slot)."""
    ref, port = four_ranks
    cfg = dataclasses.replace(t_get_config("moonshot-v1-16b-a3b",
                                           smoke=True),
                              moe_capacity_factor=_DROP_CF)
    inp = _inputs()
    p = tree_map(torch.from_numpy, _unflat(inp, "moe/"))
    y, _ = moe_mlp(p, cfg, torch.from_numpy(inp["moe_x"]))
    np.testing.assert_allclose(port["drop_ep"], y.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(port["drop_ep"], ref["drop_local"], rtol=0,
                               atol=1e-5)
    assert np.abs(ref["drop_ep"] - ref["drop_local"]).max() > 1e-2


def test_sharded_qwen3_loss(four_ranks):
    """qwen3 smoke's loss with params and batch placed by make_shardings
    on (data=2, model=2) == the reference's sharded jitted loss == the
    port's unsharded loss."""
    ref, port = four_ranks
    inp = _inputs()
    model = t_get_model(t_get_config("qwen3-1.7b", smoke=True), device="cpu")
    loss = model.loss(tree_map(torch.from_numpy, _unflat(inp, "qwen/")),
                      {"tokens": torch.from_numpy(inp["tokens"]),
                       "labels": torch.from_numpy(inp["labels"])})
    assert abs(float(port["qwen_loss"]) - float(ref["qwen_loss"])) < 1e-5
    assert abs(float(port["qwen_loss"]) - float(loss)) < 1e-5


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "moonshot-v1-16b-a3b",
                                  "granite-moe-3b-a800m", "qwen3-1.7b@1x4",
                                  "qwen3-1.7b@6q2kv@1x4", "mamba2-130m",
                                  "mamba2-130m@1x4"])
def test_sharded_gradients(four_ranks, arch):
    """Every parameter's gradient of the smoke loss on (data=2, model=2)
    (FSDP gathers, products on local shards, the vocab-parallel embedding
    and cross entropy, moonshot's EP dispatch and aux loss, granite-moe's
    experts split by hidden units, mamba2's channel-split SSD blocks),
    and on (data=1, model=4): qwen3's, where the model axis divides its 4
    query heads but not its 2 KV heads; a qwen3 with 6 query and 2 KV
    heads, which it divides neither (one KV head on each of two ranks,
    none on the others); and mamba2's with 2 heads of 64 channels, each
    split over two ranks; == the unsharded gradient, within 1e-4 of each
    leaf's scale."""
    _, port = four_ranks
    assert float(port["grad_err/" + arch]) < 1e-4


@pytest.mark.parametrize("key", list(_GRAD_ARCHS))
def test_sharded_gradients_match_reference(four_ranks, key):
    """The sharded smoke loss and every parameter's gradient on (data=2,
    model=2), from the same numpy params and tokens, == the reference's
    ``jax.value_and_grad`` of its loss jitted with ``make_shardings``'
    shardings under its activation mesh, within 1e-4 of each leaf's
    scale (the loss within 1e-5)."""
    ref, port = four_ranks
    assert abs(float(port[key + "_loss"]) - float(ref[key + "_loss"])) < 1e-5
    names = sorted(k for k in ref if k.startswith(key + "_grad/"))
    assert names == sorted(k for k in port if k.startswith(key + "_grad/"))
    assert len(names) > 10
    for k in names:
        scale = np.abs(ref[k]).max()
        assert np.abs(port[k] - ref[k]).max() <= 1e-4 * scale, k


@pytest.mark.parametrize("arch", ["mamba2-130m", "mamba2-130m@1x4"])
def test_sharded_mamba2_prefill_and_decode(four_ranks, arch):
    """mamba2's channel-split blocks in prefill (logits and the cache:
    the state split by heads on (2, 2), gathered whole where 2 heads
    straddle 4 ranks) and a decode step on that cache == unsharded,
    within 1e-5 of each leaf's scale."""
    _, port = four_ranks
    assert float(port["serve_err/" + arch]) < 1e-5


# ---------------------------------------------------------------------------
# an in-process gloo world of one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_of_one(tmp_path_factory):
    from torch.distributed.device_mesh import init_device_mesh

    path = tmp_path_factory.mktemp("pg1") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def test_place_and_elastic_restore_on_a_mesh(mesh_of_one, tmp_path):
    """``place`` puts each leaf by its spec (on a 1x1 mesh every named axis
    shards, by one), and ``elastic_restore(..., shardings=)`` of a
    checkpoint gives the same leaves bit for bit, placed alike."""
    from repro_torch.dist.sharding import make_shardings, place
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.fault_tolerance import elastic_restore

    model = t_get_model(t_get_config("qwen3-1.7b", smoke=True), device="cpu")
    sh = make_shardings(model, mesh_of_one, SHAPES["train_4k"])
    params = tree_map(torch.from_numpy, _np_params(model.table(), 3))
    placed = place(params, sh.params)
    leaves = tree_leaves(placed)
    assert all(tuple(t.placements) == s.placements for t, s in
               zip(leaves, tree_leaves(sh.params)))
    save_checkpoint(str(tmp_path), 7, params, device="cpu")
    back = elastic_restore(str(tmp_path), 7, params, shardings=sh.params)
    for a, b, s in zip(tree_leaves(back), tree_leaves(params),
                       tree_leaves(sh.params)):
        assert tuple(a.placements) == s.placements
        assert torch.equal(a.full_tensor(), b)
