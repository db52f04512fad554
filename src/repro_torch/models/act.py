"""Activation annotations and the model scans.

Counterpart of ``repro/models/act.py``.  Model code annotates
activations with *logical* axes ("batch", "model", None).  When a
launcher installs an activation mesh (``activation_mesh``, a
``DeviceMesh`` and its batch axes), ``constrain`` redistributes a DTensor
activation to the placements those axes name; a plain tensor, or any call
with no mesh installed, passes through unchanged, so unit tests and
single-device paths are unaffected.  ``scan`` is the reference's
``lax.scan`` as an eager Python loop over the leading axis, and ``remat``
its ``jax.checkpoint``.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import sys

import torch
from torch.utils.checkpoint import checkpoint

from .params import tree_leaves, tree_map

__all__ = ["activation_mesh", "constrain", "current_mesh", "einsum",
           "from_local", "gather_fsdp", "grad_summed", "is_dtensor",
           "local_param", "local_shard", "row_placements", "scan", "remat",
           "legacy_f32_internals", "legacy_f32"]

# (mesh, batch_axes) of the installed activation mesh.  A module global
# and not a ContextVar: autograd runs a CUDA backward, and with it remat's
# recomputed forward, on threads of its own, which must see the mesh the
# forward saw.
_MESH = None


@contextlib.contextmanager
def activation_mesh(mesh, batch_axes):
    """Install (mesh, batch_axes) for the calls (forward and backward)
    made inside.  Plain tensors that the models create there (positions,
    masks, zero carries) meet DTensors as replicated tensors
    (``implicit_replication``): every rank makes the same ones."""
    from torch.distributed.tensor.experimental import implicit_replication

    global _MESH
    prev = _MESH
    _MESH = (mesh, (batch_axes,) if isinstance(batch_axes, str)
             else tuple(batch_axes))
    try:
        with implicit_replication():
            yield
    finally:
        _MESH = prev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor's module,
    which a process that never made one has not loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def current_mesh():
    """(mesh, batch_axes) when a launcher installed one, else None."""
    return _MESH


def scan(f, init, xs):
    """``carry, y = f(carry, x)`` over the leading axis of every leaf of
    ``xs``; returns the last carry and the ``y``s stacked along a new
    leading axis (``None`` when ``f`` returns no ``y``)."""
    # one unbind a leaf: its backward is one stack, where indexing a[i]
    # would add a zero tensor of the whole stack a step to the gradient
    slices = [torch.unbind(a) for a in tree_leaves(xs)]
    carry, ys = init, []
    for i in range(len(slices[0])):
        row = iter([s[i] for s in slices])
        carry, y = f(carry, tree_map(lambda _: next(row), xs))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *a: torch.stack(a), *ys)


_LEGACY_F32: contextvars.ContextVar = contextvars.ContextVar(
    "legacy_f32", default=False)


@contextlib.contextmanager
def legacy_f32_internals():
    """Ablation toggle: full-f32 norm/rope internals (the rotation of
    ``layers.rope`` runs in f32)."""
    token = _LEGACY_F32.set(True)
    try:
        yield
    finally:
        _LEGACY_F32.reset(token)


def remat(f):
    """``f`` recomputed in the backward pass instead of saving its
    intermediates (the reference's ``jax.checkpoint`` with
    ``nothing_saveable``); the models draw no random numbers, so no RNG
    state is stashed."""
    return functools.partial(checkpoint, f, use_reentrant=False,
                             preserve_rng_state=False)


def legacy_f32() -> bool:
    return _LEGACY_F32.get()


def _divides(mesh, axes, dim: int) -> bool:
    n = 1
    for a in axes:
        n *= mesh.size(tuple(mesh.mesh_dim_names).index(a))
    return dim % n == 0


def constrain(x, logical: tuple):
    """logical entries: "batch" | "model" | None per dim of ``x``.

    Under an installed mesh a DTensor ``x`` is redistributed so that each
    dim is sharded over the axes its entry names and replicated over the
    rest.  A dim that those axes do not divide stays replicated over
    them: DTensor would split it as ``torch.chunk`` does (short or empty
    last shards) where GSPMD pads every shard to one size (40 heads over
    a 16-way axis: 3 heads a device, 8 of them padding), so the reference
    shards such an activation and the port keeps it whole."""
    if _MESH is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh, batch_axes = _MESH
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, a in enumerate(logical):
        axes = batch_axes if a == "batch" else (("model",) if a == "model"
                                                else ())
        axes = tuple(ax for ax in axes if ax in names)
        if axes and _divides(mesh, axes, x.shape[d]):
            for ax in axes:
                out[names.index(ax)] = Shard(d)
    if tuple(x.placements) == tuple(out):
        return x
    return x.redistribute(mesh, out)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def row_placements(batch: int, heads=None) -> tuple:
    """Placements of a (B, S, heads, ...) activation on the installed mesh:
    B over the batch axes and the head dim over "model", each where the
    axes divide it (``heads`` None: heads whole)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, batch_axes = _MESH
    names = tuple(mesh.mesh_dim_names)
    size = dict(zip(names, mesh.mesh.shape))
    axes = [a for a in batch_axes if a in names]
    nb = 1
    for a in axes:
        nb *= size[a]
    out = []
    for n in names:
        if n in axes and batch % nb == 0:
            out.append(Shard(0))
        elif n == "model" and heads is not None and heads % size[n] == 0:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def local_shard(t, placements):
    """This rank's shard of the DTensor ``t`` redistributed to
    ``placements``."""
    return t.redistribute(t.device_mesh, placements).to_local()


def from_local(t, mesh, placements, shape):
    """A DTensor of global ``shape`` from this rank's shard ``t``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, placements, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``; when either operand is a DTensor, the
    product runs on the local shards, as the reference's GSPMD partitions
    it, and DTensor's own sharding propagation is not asked (its search
    over a product's strategies takes seconds per shape, minutes on a
    3-axis mesh).

    Per mesh axis: a letter sharded in one operand and absent from the
    other is sharded in the output; a letter sharded in both is sharded in
    the output if it stays there, else the output is a partial sum over
    that axis (reduced where a later op reads it).  An operand sharded on
    a letter the other also carries but holds whole is met by slicing the
    other (a redistribute); any other clash replicates the second
    operand.  A partial operand is reduced first."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = (a if is_dtensor(a) else b).device_mesh
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    ops = []
    for t in (a, b):
        if not is_dtensor(t):
            t = from_local(t, mesh, [Replicate()] * mesh.ndim, t.shape)
        ops.append(t)
    a, b = ops
    pa = [Replicate() if p.is_partial() else p for p in a.placements]
    pb = [Replicate() if p.is_partial() else p for p in b.placements]
    po = []
    for i in range(mesh.ndim):
        ca = la[pa[i].dim] if pa[i].is_shard() else None
        cb = lb[pb[i].dim] if pb[i].is_shard() else None
        if ca is not None and cb is not None and ca != cb:
            pb[i], cb = Replicate(), None
        if ca is not None and cb is None and ca in lb:
            pb[i], cb = Shard(lb.index(ca)), ca
        elif cb is not None and ca is None and cb in la:
            pa[i], ca = Shard(la.index(cb)), cb
        c = ca if ca is not None else cb
        if c is None:
            po.append(Replicate())
        elif c in out:
            po.append(Shard(out.index(c)))
        else:
            po.append(Partial())
    if tuple(pa) != tuple(a.placements):
        a = a.redistribute(mesh, pa)
    if tuple(pb) != tuple(b.placements):
        b = b.redistribute(mesh, pb)
    size = dict(zip(la, a.shape))
    size.update(zip(lb, b.shape))

    def grads(letters, pl):
        # an operand held whole where the output is split on a letter it
        # lacks (a weight against batch rows) gets a partial gradient
        return [p if p.is_shard() else Partial() if (
            o.is_shard() and out[o.dim] not in letters) else p
            for p, o in zip(pl, po)]

    y = torch.einsum(eq, a.to_local(grad_placements=grads(la, pa)),
                     b.to_local(grad_placements=grads(lb, pb)))
    return from_local(y, mesh, po, [size[c] for c in out])


def grad_summed(t, mesh, rows, axis):
    """The local shard ``t`` (placed by ``rows``) as read by a computation
    split over mesh dim ``axis``: each rank's gradient of it is a partial
    sum, which the backward sums over that axis (no-op with ``axis``
    None)."""
    if axis is None:
        return t
    from torch.distributed.tensor import DTensor, Partial

    summed = [Partial() if i == axis else q for i, q in enumerate(rows)]
    return DTensor.from_local(t, mesh, rows).to_local(grad_placements=summed)


def local_param(w, placements, rows):
    """This rank's shard of the parameter DTensor ``w`` redistributed to
    ``placements``, for use with activations placed by ``rows``: where the
    activations are split over a mesh dim that holds ``w`` whole, each
    rank's gradient of ``w`` is a partial sum, and ``to_local``'s backward
    is told so."""
    from torch.distributed.tensor import Partial

    grad = [Partial() if p.is_replicate() and r.is_shard() else p
            for p, r in zip(placements, rows)]
    if tuple(placements) != tuple(w.placements):
        w = w.redistribute(w.device_mesh, placements)
    return w.to_local(grad_placements=grad)


def gather_fsdp(w):
    """A parameter DTensor all-gathered over the installed mesh's batch
    (FSDP) axes, its "model" sharding kept: the layout a product with a
    batch-sharded activation reads, as GSPMD gathers FSDP weights before
    their use.  Anything else passes through."""
    if _MESH is None or not is_dtensor(w):
        return w
    out = fsdp_placements(w)
    return w if out == tuple(w.placements) else w.redistribute(
        w.device_mesh, out)


def fsdp_placements(w) -> tuple:
    """The parameter DTensor ``w``'s placements with the installed mesh's
    batch (FSDP) axes replicated and "model" kept."""
    from torch.distributed.tensor import Replicate

    names = tuple(w.device_mesh.mesh_dim_names)
    return tuple(Replicate() if n in _MESH[1] else p
                 for n, p in zip(names, w.placements))
