"""Production mesh construction.

Counterpart of ``repro/launch/mesh.py``.  Functions only: importing this
module touches no process group.  The shapes are the reference's, so the
port's spec trees compare with its entry for entry:

* single pod:  (data=16, model=16)          -- 256 devices
* multi-pod:   (pod=2, data=16, model=16)   -- 512 devices

Each builds an ``init_device_mesh`` over the default process group, whose
world size must be the mesh's size (the dry run makes a fake group of 256
or 512 ranks).  Logical use: batch/FSDP over ("pod", "data"); TP/EP over
"model"; the "pod" axis can alternatively drive the pipeline
(dist/pipeline.py).
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "make_smoke_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_smoke_mesh(device_type="cuda"):
    """A small (data, model) mesh over the default group's world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    shape = (2, n // 2) if n >= 4 else (1, n)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=("data", "model"))
