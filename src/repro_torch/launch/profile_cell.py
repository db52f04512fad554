"""The top byte-contributing ops of one dry-run cell, per device.

Counterpart of ``repro/launch/profile_cell.py``: the cell is traced as
``launch/dryrun.py`` traces it (meta tensors, a fake process group, rank
0's local ops) and its ops are ranked by bytes x count, grouped by op and
operand shapes.  Run it in a process of its own (it makes the fake group).

Usage: PYTHONPATH=src python -m repro_torch.launch.profile_cell \
    --arch X --shape train_4k [--multi] [--top 25] [--smoke]
"""
import argparse

from ..configs import get_config
from ..dist.sharding import batch_axes_for
from ..models import SHAPES, get_model
from ..models.act import activation_mesh
from . import dryrun as dr
from .cost import measure
from .mesh import make_production_mesh

__all__ = ["top_contributors", "main"]


def top_contributors(cost, top: int = 25):
    """Rows ``(bytes x count, count, op, shapes)`` of a ``StepCost``'s ops,
    largest first (a row's bytes are already summed over its count)."""
    rows = [(b, n, op, shapes) for (op, shapes), (n, b, _) in
            cost.ops.items()]
    rows.sort(key=lambda r: r[0], reverse=True)
    return rows[:top]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    shape = SHAPES[args.shape]
    dr._fake_world(512 if args.multi else 256)
    mesh = make_production_mesh(multi_pod=args.multi, device_type="cpu")
    model = get_model(cfg, device="meta")
    fn, fargs = dr.build_cell(model, mesh, shape)
    with activation_mesh(mesh, batch_axes_for(mesh)):
        _, cost = measure(fn, *fargs)
    for b, n, op, shapes in top_contributors(cost, args.top):
        print(f"{b/1e9:10.3f} GB x{n:6d} {op:22s} {shapes}")


if __name__ == "__main__":
    main()
