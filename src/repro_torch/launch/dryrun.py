"""Multi-pod dry run: trace every (arch x shape x mesh) cell per device.

Counterpart of ``repro/launch/dryrun.py``.  For each cell this:
  1. builds the step (the full train step with the AdamW update, or
     prefill / decode) on meta tensors placed by ``make_shardings`` on the
     production mesh (no allocation, no card);
  2. runs it once under the activation mesh and ``launch/cost.py``'s
     counting mode, on rank 0 of a **fake** process group of 256 or 512
     ranks (the counterpart of the reference's 512 faked host devices;
     its collectives move nothing);
  3. records rank 0's FLOPs, bytes and collective bytes by kind, the bytes
     of its argument shards, and the three roofline terms for H100
     constants.

The reference lowers and compiles; here ``trace_s`` (the eager traced run)
takes the place of its ``lower_s`` / ``compile_s``.  It has no
``while_trips``: eager torch runs every scan step as ops of its own, so
there are no loop bodies whose trip counts the count would need, and no
``xla_cost_analysis``.  ``memory_analysis`` holds ``argument_bytes`` only:
the local shards' bytes of the step's arguments.

The fake group is created by ``main()`` (and ``run_cell``), never on
import.  A fake group and a real one cannot share a process: run this in
a process of its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
      --shape all --mesh both --out dryrun.json [--smoke]
"""
import argparse
import dataclasses
import json
import time
import traceback

import torch

from ..configs import ARCH_NAMES, get_config, shape_applicable
from ..dist.sharding import (batch_axes_for, make_shardings,
                             mesh_axis_sizes, place)
from ..models import SHAPES, get_model
from ..models.act import activation_mesh
from ..models.params import P, tree_leaves, tree_map
from ..train.optimizer import OptConfig, adamw_update
from .cost import measure, roofline, shard_bytes
from .mesh import make_production_mesh

# H100 SXM roofline constants (NVIDIA's data sheet: dense rates, 700 W)
PEAK_FLOPS = 989e12         # dense bf16 FLOP/s / device
HBM_BW = 3.35e12            # bytes/s / device
# NVLink 4, bytes/s each way / device.  Optimistic for a 16-wide axis:
# one host holds 8 cards, so a 16-way group crosses the hosts' network.
LINK_BW = 450e9

# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def param_sds(model):
    """The model's params as f32 meta tensors."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                          device="meta"),
                    model.table(), is_leaf=lambda x: isinstance(x, P))


def opt_sds(psds):
    zeros = tree_map(lambda s: torch.empty(s.shape, dtype=torch.float32,
                                           device="meta"), psds)
    return {"m": zeros, "v": tree_map(torch.empty_like, zeros),
            "count": torch.zeros((), dtype=torch.int32, device="meta")}


def _meta(specs):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs,
                    is_leaf=lambda x: hasattr(x, "dtype"))


def build_cell(model, mesh, shape):
    """Returns (fn, args): the cell's step and its arguments, meta tensors
    placed by ``make_shardings``."""
    sh = make_shardings(model, mesh, shape)
    params = place(param_sds(model), sh.params)
    batch = place(_meta(model.input_specs(shape)), sh.batch)
    if shape.kind == "train":
        opt_cfg = OptConfig()
        opt = place(opt_sds(param_sds(model)),
                    {"m": sh.params, "v": sh.params,
                     "count": sh.out_scalar})

        def train_step(params, opt_state, batch):
            leaves = [p.detach().requires_grad_()
                      for p in tree_leaves(params)]
            it = iter(leaves)
            loss = model.loss(tree_map(lambda _: next(it), params), batch)
            grads = torch.autograd.grad(loss, leaves)
            # each gradient in its parameter's placements (the
            # reference's out_shardings)
            it = iter([g.redistribute(p.device_mesh, p.placements)
                       for g, p in zip(grads, leaves)])
            params, opt_state, om = adamw_update(
                opt_cfg, tree_map(lambda _: next(it), params), opt_state,
                params)
            return params, opt_state, {"loss": loss, **om}

        return train_step, (params, opt, batch)
    if shape.kind == "prefill":
        return model.prefill, (params, batch)
    cache = place(_meta(model.cache_specs(shape)), sh.cache)
    batch["pos"] = shape.seq - 1
    return model.decode, (params, cache, batch)


def _fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(arch: str, shape_name: str, multi_pod: bool, smoke: bool) -> dict:
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single",
           "kind": shape.kind, "status": "skipped"}
    if not shape_applicable(cfg, shape):
        rec["note"] = "long_500k skipped for full-attention arch (DESIGN.md)"
        return rec
    chips = 512 if multi_pod else 256
    _fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    model_axis = mesh_axis_sizes(mesh)["model"]
    if (shape.kind != "train" and cfg.n_kv_heads and
            cfg.n_kv_heads % model_axis != 0 and
            cfg.family in ("dense", "moe", "vlm", "hybrid")):
        # pad cached KV heads so the cache shards over the model axis
        cfg = dataclasses.replace(cfg, kv_cache_pad_heads=model_axis)
    model = get_model(cfg, device="meta")
    t0 = time.time()
    fn, args = build_cell(model, mesh, shape)
    with activation_mesh(mesh, batch_axes_for(mesh)):
        _, cost = measure(fn, *args)
    t_trace = time.time() - t0
    terms = roofline(cost, PEAK_FLOPS, HBM_BW, LINK_BW)
    rec.update({
        "status": "ok", "chips": chips, "trace_s": round(t_trace, 2),
        "flops_per_device": cost.flops, "bytes_per_device": cost.bytes,
        "collective_bytes_per_device": cost.collective_bytes,
        "collective_breakdown": cost.collective_breakdown,
        "memory_analysis": {"argument_bytes": shard_bytes(args)},
        "roofline_terms_s": terms, "dominant": max(terms, key=terms.get),
    })
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    archs = ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records = []
    for arch in archs:
        for shape_name in shapes:
            for multi in meshes:
                tag = f"{arch} x {shape_name} x {'multi' if multi else 'single'}"
                try:
                    rec = run_cell(arch, shape_name, multi, args.smoke)
                except Exception as e:  # noqa: BLE001
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi else "single",
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                records.append(rec)
                if rec["status"] == "ok":
                    t = rec["roofline_terms_s"]
                    print(f"[ok] {tag}: trace={rec['trace_s']:.1f}s "
                          f"compute={t['compute_s']:.3e}s "
                          f"mem={t['memory_s']:.3e}s "
                          f"coll={t['collective_s']:.3e}s "
                          f"dominant={rec['dominant']}", flush=True)
                else:
                    print(f"[{rec['status']}] {tag}"
                          f" {rec.get('error', rec.get('note', ''))}",
                          flush=True)
                if args.out:
                    with open(args.out, "w") as fh:
                        json.dump(records, fh, indent=1)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"dry-run: {n_ok} ok, {n_err} errors, "
          f"{len(records) - n_ok - n_err} skipped")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
