"""Microbatched pipeline parallelism over one mesh axis.

Counterpart of ``repro/dist/pipeline.py``.  ``pipeline_apply`` runs the
reference's GPipe schedule on each rank of a ``DeviceMesh`` axis: rank s
of the axis holds stage s's parameters (row s of the stacked params), the
input batch is split into microbatches, and activations flow stage to
stage through a ring shift, one ``batch_isend_irecv`` a tick that pairs
the send to the next stage with the receive from the previous one (so
gloo cannot deadlock on the ring).  The schedule is the reference's
unrolled one, ``n_microbatches + n_stages - 1`` ticks; only the last stage
writes the output buffer, and an ``all_reduce`` of the masked buffer over
the axis's group replicates it, as the reference's masked ``psum`` does.

The stage function must be shape-preserving: ``stage_fn(stage_params, x)
-> y`` with ``y.shape == x.shape`` (the residual-stream contract every
model in the zoo satisfies).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.params import tree_leaves, tree_map

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn, params, x, mesh, axis: str,
                   n_microbatches: int):
    """Apply ``n_stages`` chained stages to ``x`` with pipeline parallelism.

    Args:
      stage_fn: ``(stage_params, microbatch) -> microbatch`` (shape-preserving).
      params: tree whose leaves all have leading dim ``mesh.size(axis)``;
        leaf ``[s]`` holds stage ``s``'s parameters (the same tree on every
        rank; each rank reads its own row).
      x: batched input, the same on every rank; ``x.shape[0]`` must divide
        by ``n_microbatches``.
      mesh: a ``DeviceMesh`` with named dims; ``axis``: the pipeline axis.
    Returns:
      The sequential composition ``stage_{S-1}(... stage_0(x))`` on every
      rank.
    """
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise KeyError(f"mesh has no axis {axis!r}; axes: {names}")
    dim = names.index(axis)
    n_stages = mesh.size(dim)
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by {n_microbatches} "
                         "microbatches")
    for leaf in tree_leaves(params):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"param leading dim {leaf.shape[0]} != n_stages {n_stages}")
    mb_shape = (n_microbatches, B // n_microbatches) + tuple(x.shape[1:])
    idx = mesh.get_local_rank(dim)
    group = mesh.get_group(dim)
    nxt = dist.get_global_rank(group, (idx + 1) % n_stages)
    prv = dist.get_global_rank(group, (idx - 1) % n_stages)
    is_first, is_last = idx == 0, idx == n_stages - 1

    p = tree_map(lambda a: a[idx], params)   # this rank's stage
    mbs = x.reshape(mb_shape)
    out_buf = torch.zeros(mb_shape, dtype=x.dtype, device=x.device)
    carry = torch.zeros(mb_shape[1:], dtype=x.dtype, device=x.device)
    for t in range(n_microbatches + n_stages - 1):
        feed = mbs[min(t, n_microbatches - 1)]
        out = stage_fn(p, feed if is_first else carry).to(x.dtype)
        o = t - (n_stages - 1)
        if o >= 0 and is_last:  # drain: the last stage owns microbatch o
            out_buf[o] = out
        if n_stages == 1:       # the ring shift of one stage is the identity
            carry = out
            continue
        out = out.contiguous()
        carry = torch.empty_like(out)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, nxt, group),
            dist.P2POp(dist.irecv, carry, prv, group)])
        for r in reqs:
            r.wait()
    # only the last stage holds real outputs; mask + all_reduce replicates
    if not is_last:
        out_buf.zero_()
    dist.all_reduce(out_buf, group=group)
    return out_buf.reshape(x.shape)
