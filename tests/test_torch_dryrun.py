"""The port's per-device cost count and its dry-run CLI.

* ``launch/cost.py`` on the smoke losses of qwen3, moonshot and whisper
  (one device, a (t, 64, 8) train shape) against the reference's
  ``analyze_hlo`` on its jitted loss: FLOPs within 0.85-1.15, the band
  the reference holds its own count to.
* Per device: a product sharded 16 ways over "model" on a fake mesh
  counts 1/16 of its global FLOPs on rank 0.
* The CLI in a subprocess: qwen3 smoke x train_4k x single gives one
  ``ok`` record with the reference's keys and the argument bytes its spec
  tree implies; a cell that errors exits 1.
"""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config
from repro.launch.hlo_cost import analyze_hlo
from repro.models import get_model
from repro.models.config import Shape
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch.cost import measure
from repro_torch.models import get_model as t_get_model
from repro_torch.models.params import tree_map

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_SRC = os.path.join(_ROOT, "src")
_ENV = {**os.environ, "PYTHONPATH": _SRC}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "moonshot-v1-16b-a3b",
                                  "whisper-base"])
def test_cost_flops_match_analyze_hlo(arch):
    shape = Shape("t", 64, 8, "train")
    model = get_model(get_config(arch, smoke=True))
    psds = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32),
                        model.table(), is_leaf=lambda x: hasattr(x, "axes"))
    hc = analyze_hlo(jax.jit(model.loss).lower(
        psds, model.input_specs(shape)).compile().as_text())
    tm = t_get_model(t_get_config(arch, smoke=True), device="meta")
    params = tree_map(lambda p: torch.empty(p.shape, device="meta"),
                      tm.table(), is_leaf=lambda x: hasattr(x, "axes"))
    batch = {k: torch.zeros(s.shape, dtype=s.dtype, device="meta")
             for k, s in tm.input_specs(shape).items()}
    _, cost = measure(tm.loss, params, batch)
    assert 0.85 < cost.flops / hc.flops < 1.15, (cost.flops, hc.flops)
    assert cost.bytes > 0 and cost.collective_bytes == 0


_SHARDED_PRODUCT = r"""
import torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.cost import measure
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.act import activation_mesh, einsum
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_production_mesh(device_type="cpu")
x = distribute_tensor(torch.empty(64, 512, 1024, device="meta"), mesh,
                      [Shard(0), Replicate()])
w = distribute_tensor(torch.empty(1024, 2048, device="meta"), mesh,
                      [Replicate(), Shard(1)])
with activation_mesh(mesh, ("data",)):
    for fn in (lambda: x @ w, lambda: einsum("bsd,df->bsf", x, w)):
        y, c = measure(fn)
        assert c.flops == 2 * 64 * 512 * 1024 * 2048 / 256, c.flops
        assert tuple(y.to_local().shape) == (4, 512, 128), y.to_local().shape
print("PRODUCT-OK")
"""


def test_rank_zero_counts_its_shard():
    res = subprocess.run([sys.executable, "-c", _SHARDED_PRODUCT], env=_ENV,
                         capture_output=True, text=True, timeout=300)
    assert "PRODUCT-OK" in res.stdout, res.stderr[-3000:]


def _local_bytes(spec, shape, dtype, sizes) -> int:
    n = 1
    for d, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n *= d // math.prod(sizes[a] for a in axes)
    return n * torch.empty((), dtype=dtype).element_size()


def test_dryrun_cli_smoke_cell(tmp_path):
    from repro_torch.dist.sharding import make_specs
    from repro_torch.models import SHAPES
    from repro_torch.models.params import P, tree_leaves

    out = tmp_path / "dry.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--arch", "qwen3-1.7b", "--shape", "train_4k", "--mesh", "single",
         "--out", str(out)], env=_ENV, capture_output=True, text=True,
        timeout=600, cwd=_ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "collective_breakdown",
                "roofline_terms_s", "dominant", "memory_analysis",
                "trace_s"):
        assert key in rec, key
    assert rec["flops_per_device"] > 0 and rec["collective_bytes_per_device"] > 0
    assert set(rec["roofline_terms_s"]) == {"compute_s", "memory_s",
                                            "collective_s"}
    # the argument shards: params, AdamW's m and v, its count, the batch
    sizes = {"data": 16, "model": 16}
    model = t_get_model(t_get_config("qwen3-1.7b", smoke=True), device="meta")
    specs = make_specs(model, sizes, SHAPES["train_4k"])
    table = tree_leaves(model.table(), is_leaf=lambda x: isinstance(x, P))
    params = sum(_local_bytes(s, p.shape, torch.float32, sizes)
                 for s, p in zip(tree_leaves(specs.params), table))
    ins = model.input_specs(SHAPES["train_4k"])
    batch = sum(_local_bytes(specs.batch[k], ins[k].shape, ins[k].dtype,
                             sizes) for k in ins)
    assert rec["memory_analysis"]["argument_bytes"] == 3 * params + 4 + batch


def test_dryrun_cli_exits_1_on_an_error_cell(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--arch", "no-such-arch", "--shape", "decode_32k", "--mesh",
         "single", "--out", str(tmp_path / "d.json")], env=_ENV,
        capture_output=True, text=True, timeout=300, cwd=_ROOT)
    assert res.returncode == 1, res.stdout + res.stderr
    (rec,) = json.loads((tmp_path / "d.json").read_text())
    assert rec["status"] == "error" and "no-such-arch" in rec["error"]
