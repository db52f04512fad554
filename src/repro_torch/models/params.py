"""Parameter tables: the single source of truth for shapes and init.

Counterpart of ``repro/models/params.py``.  Each model defines a nested
dict of :class:`P` leaves; ``init_params`` turns the table into tensors.
``pspecs`` turns the *same* table into partition specs through the
logical-axis rules (``DEFAULT_RULES``), so shapes and sharding cannot
drift apart.

A tree here is a nested dict (keys visited sorted, as the reference's
pytrees flatten), tuple, list or ``NamedTuple``; ``None`` is an empty
subtree and anything else, a :class:`PS` included, a leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.bloomrf import resolve_device

__all__ = ["P", "PS", "init_params", "params_from_numpy", "count_params",
           "pspecs", "DEFAULT_RULES", "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter leaf: shape + logical axes + init spec."""
    shape: tuple
    axes: tuple                 # logical axis name per dim (or None)
    init: str = "normal"        # normal | zeros | ones | a_log | dt_bias
    scale: Optional[float] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


DEFAULT_RULES = {
    "embed": ("fsdp",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "ssm_inner": ("model",),
    "layers": (),
}


class PS(tuple):
    """A partition spec: one entry per tensor dim, each ``None``
    (replicated), a mesh axis name, or a tuple of axis names (major axis
    first), as ``jax.sharding.PartitionSpec``'s are.  A leaf of the trees
    here (``tree_map`` does not descend into it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PS{tuple.__repr__(self)}"


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), keeping the structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, PS):
        out = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, t in enumerate(tree)]
        return type(tree)(*out) if _is_namedtuple(tree) else type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in flatten order (dict keys sorted)."""
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def _is_p(x) -> bool:
    return isinstance(x, P)


def _leaf_init(p: P, generator: torch.Generator, dtype, device):
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    u = torch.empty(p.shape, dtype=torch.float32, device=device)
    if p.init == "a_log":  # mamba2 A: log-uniform over [1, 16]
        return torch.log(u.uniform_(1.0, 16.0, generator=generator)).to(dtype)
    if p.init == "dt_bias":  # softplus^-1 of dt ~ U[1e-3, 1e-1]
        u.uniform_(1e-3, 1e-1, generator=generator)
        return torch.log(torch.expm1(u)).to(dtype)
    # truncated-normal fan-in init
    fan_in = p.shape[-2] if len(p.shape) >= 2 else max(p.shape[-1], 1)
    scale = p.scale if p.scale is not None else 1.0 / math.sqrt(fan_in)
    torch.nn.init.trunc_normal_(u, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (u * scale).to(dtype)


def init_params(table, generator: torch.Generator, dtype=torch.float32,
                device=None):
    """Materialize a parameter table into tensors on ``device`` (default
    ``"cuda"``), drawing from ``generator`` (on that device) leaf by leaf in
    flatten order.  The inits are the reference's; the draws are torch's,
    so the values differ from ``repro``'s (carry those across with
    :func:`params_from_numpy`)."""
    device = resolve_device(device)
    return tree_map(lambda p: _leaf_init(p, generator, dtype, device), table,
                    is_leaf=_is_p)


def params_from_numpy(tree, device=None):
    """The reference's parameters, a nested dict of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as a tree of tensors on
    ``device`` (default ``"cuda"``) with the same paths, shapes and
    dtypes."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def _axis_ok(mesh_axes: tuple, dim: int, mesh_shape: dict) -> bool:
    """Argument shardings must divide the dim exactly; dims that do not
    are replicated here."""
    total = 1
    for a in mesh_axes:
        total *= mesh_shape.get(a, 1)
    return total > 0 and dim % total == 0


def pspecs(table, mesh_shape: dict, rules: dict | None = None,
           fsdp_axes: tuple = ("data",)):
    """A :class:`PS` tree of the table.

    ``mesh_shape``: {axis: size} of the target mesh.  ``fsdp_axes``: the
    physical axes behind the logical "fsdp" group (e.g. ("pod", "data")).
    A sharding that does not divide its dim is dropped (replicated), and
    no mesh axis shards two dims of one leaf."""
    rules = dict(DEFAULT_RULES if rules is None else rules)

    def spec_for(p: P) -> PS:
        used = set()
        out = []
        for dim, ax in zip(p.shape, p.axes):
            phys: tuple = ()
            if ax is not None and ax in rules:
                phys = tuple(fsdp_axes if a == "fsdp" else (a,)
                             for a in rules[ax])
                phys = tuple(x for grp in phys for x in grp)
            phys = tuple(a for a in phys if a not in used)
            if phys and _axis_ok(phys, dim, mesh_shape):
                used.update(phys)
                out.append(phys if len(phys) > 1 else phys[0])
            else:
                out.append(None)
        return PS(*out)

    return tree_map(spec_for, table, is_leaf=_is_p)


def count_params(table) -> int:
    return int(sum(np.prod(p.shape)
                   for p in tree_leaves(table, is_leaf=_is_p)))
