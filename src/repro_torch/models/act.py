"""Activation annotations and the model scans.

Counterpart of ``repro/models/act.py``.  ``constrain`` marks an
activation with logical axes ("batch", "model", None); while no mesh is
installed it returns the tensor as it is, so single-device paths are
unaffected.  The port's ``activation_mesh`` / ``current_mesh`` come with
``dist/sharding.py``.  ``scan`` is the reference's ``lax.scan`` as an eager
Python loop over the leading axis, and ``remat`` its ``jax.checkpoint``.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
from torch.utils.checkpoint import checkpoint

from .params import tree_leaves, tree_map

__all__ = ["constrain", "scan", "remat", "legacy_f32_internals",
           "legacy_f32"]


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


def constrain(x, logical: tuple):
    """logical entries: "batch" | "model" | None per dim of ``x``; the
    identity while no activation mesh is installed."""
    return x
