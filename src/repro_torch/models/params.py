"""Parameter tables: the single source of truth for shapes and init.

Counterpart of ``repro/models/params.py``.  Each model defines a nested
dict of :class:`P` leaves; ``init_params`` turns the table into tensors.
The logical axes ride along for the sharding rules (``DEFAULT_RULES``);
the port's ``pspecs`` comes with ``dist/sharding.py``.

A tree here is a nested dict (keys visited sorted, as the reference's
pytrees flatten), tuple, list or ``NamedTuple``; ``None`` is an empty
subtree and anything else a leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.bloomrf import resolve_device

__all__ = ["P", "init_params", "params_from_numpy", "count_params",
           "DEFAULT_RULES", "tree_map", "tree_leaves"]


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
    if isinstance(tree, (tuple, list)):
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


def count_params(table) -> int:
    return int(sum(np.prod(p.shape)
                   for p in tree_leaves(table, is_leaf=_is_p)))
