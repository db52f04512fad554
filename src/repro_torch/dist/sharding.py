"""Sharding trees for every registered model config.

Counterpart of ``repro/dist/sharding.py``.  ``make_specs(model,
mesh_shape, shape)`` turns a model's *logical* specs (``param_pspecs`` /
``batch_pspecs`` / ``cache_pspecs``) into physical :class:`PS` trees for a
mesh given only as ``{axis: size}``, with no process group: any axis that
does not divide its dim exactly is replicated.  ``make_shardings(model,
mesh, shape)`` pairs those specs with a ``DeviceMesh`` as
:class:`NamedSharding` leaves, whose ``placements`` are DTensor's, and
``place`` distributes a tree of tensors by them.

Mesh conventions (launch/mesh.py): batch/FSDP over ("pod", "data"); TP/EP
over "model"; "pod" alternatively drives the pipeline (dist/pipeline.py).

Uneven dims: DTensor splits a dim that does not divide as ``torch.chunk``
does (the last shards are short or empty), where GSPMD pads every shard
to one size.  ``_sanitize`` replicates every argument whose dim does not
divide, so argument shardings agree between the packages; only
``models.act.constrain`` can meet an uneven activation (see there).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..models.params import PS, tree_leaves, tree_map

__all__ = ["PS", "NamedSharding", "Shardings", "Specs", "batch_axes_for",
           "make_shardings", "make_specs", "mesh_axis_sizes", "place",
           "placements_for"]


def _names(mesh) -> tuple:
    if isinstance(mesh, dict):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (a dict passes through)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes_for(mesh):
    """Physical axes backing the logical batch/FSDP dim, as one PS entry."""
    if "pod" in _names(mesh):
        return ("pod", "data")
    return ("data",)


def _axes_size(mesh_shape: dict, axes) -> int:
    """Total device count of a spec entry (None/str/tuple).
    0 when any named axis is absent from the mesh (-> replicate)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    total = 1
    for a in axes:
        if a not in mesh_shape:
            return 0
        total *= mesh_shape[a]
    return total


def _is_ps(x) -> bool:
    return isinstance(x, PS)


def _is_spec(x) -> bool:
    # a TensorSpec (shape, dtype) is a NamedTuple: a leaf here
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _sanitize(mesh_shape: dict, specs, spec_tree):
    """Replicate every spec entry whose axes do not divide the dim exactly
    (``spec_tree``: the TensorSpecs the specs describe)."""
    def fix(ps: PS, s) -> PS:
        entries = tuple(ps) + (None,) * (len(s.shape) - len(ps))
        out = []
        for dim, entry in zip(s.shape, entries):
            sz = _axes_size(mesh_shape, entry)
            out.append(entry if entry is not None and sz > 0 and
                       dim % sz == 0 else None)
        return PS(*out)

    spec_leaves = tree_leaves(specs, is_leaf=_is_ps)
    shape_leaves = tree_leaves(spec_tree, is_leaf=_is_spec)
    assert len(spec_leaves) == len(shape_leaves), (specs, spec_tree)
    it = iter(shape_leaves)
    return tree_map(lambda ps: fix(ps, next(it)), specs, is_leaf=_is_ps)


def _drop_missing_axes(axis_names, specs):
    """Replicate spec entries naming axes this mesh does not have (the
    logical rules in models/params.py mention "model"/"pod"
    unconditionally)."""
    names = set(axis_names)

    def fix(ps: PS) -> PS:
        out = []
        for entry in ps:
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            out.append(entry if all(a in names for a in axes) else None)
        return PS(*out)

    return tree_map(fix, specs, is_leaf=_is_ps)


@dataclasses.dataclass(frozen=True)
class Specs:
    """The physical :class:`PS` trees of one (model, mesh, shape) cell."""
    params: Any          # matches model.table()
    batch: Any           # matches model.input_specs(shape)
    cache: Any           # matches model.cache_specs(shape)


def make_specs(model, mesh_shape: dict, shape) -> Specs:
    """The spec trees of ``model`` on a mesh of ``{axis: size}`` (in mesh
    order), computed with no process group."""
    msz = dict(mesh_shape)
    ba = batch_axes_for(msz)
    params = _drop_missing_axes(msz, model.param_pspecs(msz, fsdp_axes=ba))
    batch = _sanitize(msz, model.batch_pspecs(shape, ba),
                      model.input_specs(shape))
    # KV/state head dims shard over "model" when divisible; _sanitize drops
    # the axis per-leaf otherwise (e.g. whisper's 8 heads on a 16-way axis)
    cache = _sanitize(msz, model.cache_pspecs(shape, ba, "model"),
                      model.cache_specs(shape))
    return Specs(params, batch, cache)


def placements_for(spec: PS, axis_names: tuple) -> tuple:
    """DTensor placements of ``spec`` on a mesh with ``axis_names``: every
    mesh axis an entry names shards that entry's tensor dim, the others
    replicate.  An entry ("pod", "data") shards its dim over both, pod
    major, as in JAX.  DTensor orders two shardings of one tensor dim by
    mesh dim, and every spec here names its axes in mesh order, so no
    ``_StridedShard`` is needed."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(axis_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [axis_names.index(a) for a in axes]
        assert idx == sorted(idx), (spec, axis_names)
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (``jax.sharding.NamedSharding``'s
    counterpart)."""
    mesh: Any
    spec: PS

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, tuple(self.mesh.mesh_dim_names))


@dataclasses.dataclass(frozen=True)
class Shardings:
    """Shardings for one (model, mesh, shape) cell."""
    params: Any          # NamedSharding tree matching model.table()
    batch: Any           # NamedSharding tree matching model.input_specs(shape)
    cache: Any           # NamedSharding tree matching model.cache_specs(shape)
    out_scalar: Any      # replicated scalar (losses / metrics)
    mesh: Any


def make_shardings(model, mesh, shape) -> Shardings:
    """``make_specs`` on ``mesh`` (a ``DeviceMesh`` with named dims)."""
    specs = make_specs(model, mesh_axis_sizes(mesh), shape)

    def named(tree):
        return tree_map(lambda ps: NamedSharding(mesh, ps), tree,
                        is_leaf=_is_ps)

    return Shardings(params=named(specs.params), batch=named(specs.batch),
                     cache=named(specs.cache),
                     out_scalar=NamedSharding(mesh, PS()), mesh=mesh)


def place(tree, shardings):
    """Each tensor of ``tree`` distributed (``distribute_tensor``) by the
    matching :class:`NamedSharding` of ``shardings``; the tensor is taken
    to be the same on every rank (rank 0's is what each rank keeps a shard
    of).  Python scalars (a decode ``pos``) pass through."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    def one(t, s: NamedSharding):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, s.mesh, s.placements)

    return tree_map(one, tree, shardings)
