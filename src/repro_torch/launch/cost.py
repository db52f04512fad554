"""Per-device cost accounting of one eager step.

Counterpart of ``repro/launch/hlo_cost.py``.  There is no HLO here: the
port runs eagerly, so the count is taken op by op as the step runs, under
a ``TorchDispatchMode`` that sees the ops each rank executes.  Eager torch
runs every scan step (layers, KV blocks, SSD chunks) as ops of its own, so
no loop trip counts need recovering.  The categories are ``hlo_cost``'s:

* FLOPs: matrix products (``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``)
  count 2 * numel(result) * contraction size; elementwise math and
  reductions count numel(result) (a fused op such as ``silu`` or
  ``_softmax`` counts the elementwise ops XLA would split it into);
* bytes: each op's operands + result; slicing ops (``slice``, ``select``,
  ``index``, ``gather``, ...) read slice-sized data and count their
  result twice, and views (``view``, ``permute``, ``expand``, ...) move
  nothing, as XLA's bitcasts;
* collective bytes: the operand bytes of every collective, by kind
  (all-reduce, all-gather, reduce-scatter, all-to-all,
  collective-permute), as ``CommDebugMode`` classifies them.

The count is **per device**: under DTensor the mode returns
``NotImplemented`` for an op whose arguments are DTensors, so DTensor
dispatches it and the mode then sees the ops on this rank's local shards
and the collectives of their redistributions (``FlopCounterMode`` around
a DTensor product counts the global op instead).  Ops on fake tensors,
which DTensor's sharding propagation runs at global shapes to learn an
output's shape, are not counted.  On the meta device and
a fake process group the step allocates nothing and moves no data.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["StepCost", "CostMode", "measure", "roofline", "shard_bytes"]

_MATMUL = {"mm", "bmm", "addmm", "baddbmm"}

# elementwise / reduction ops -> the XLA elementwise ops they lower to
_ELEMENTWISE = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "maximum": 1,
    "minimum": 1, "abs": 1, "exp": 1, "log": 1, "tanh": 1, "rsqrt": 1,
    "sqrt": 1, "neg": 1, "pow": 1, "where": 1, "eq": 1, "ne": 1, "lt": 1,
    "le": 1, "gt": 1, "ge": 1, "logical_and": 1, "logical_or": 1,
    "logical_not": 1, "bitwise_and": 1, "bitwise_or": 1, "bitwise_xor": 1,
    "_to_copy": 1, "floor": 1, "ceil": 1, "sign": 1, "cos": 1, "sin": 1,
    "sigmoid": 1, "expm1": 1, "log1p": 1, "clamp": 1, "clamp_min": 1,
    "clamp_max": 1, "remainder": 1, "atan2": 1, "reciprocal": 1,
    "sum": 1, "mean": 2, "amax": 1, "amin": 1, "max": 1, "min": 1,
    "prod": 1, "silu": 2, "gelu": 8, "logaddexp": 4, "_softmax": 5,
    "_log_softmax": 5, "cumsum": 1, "lerp": 3, "addcmul": 2, "addcdiv": 2,
    "silu_backward": 4, "gelu_backward": 10, "sigmoid_backward": 3,
    "tanh_backward": 3, "_softmax_backward_data": 4, "threshold_backward": 1,
}

# ops that move nothing (XLA bitcasts) and ops that read slice-sized data
_VIEWS = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "unsqueeze", "squeeze", "alias", "detach", "as_strided",
    "unbind", "split", "split_with_sizes", "chunk", "view_as_real",
    "view_as_complex", "lift_fresh", "_reshape_alias", "unfold", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
    "wait_tensor",
}
_SLICES = {"slice", "select", "index", "gather", "narrow", "take",
           "index_select", "diagonal"}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}


def _tensors(tree):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class StepCost:
    """Per-device totals of one step (``ops``: per (op, shapes) row
    ``[count, bytes, flops]``, for ``profile_cell``)."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: dict = dataclasses.field(default_factory=dict)
    ops: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0, 0.0]))


class CostMode(TorchDispatchMode):
    """Counts the ops run inside it into ``self.cost`` (a
    :class:`StepCost`)."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # count the ops on the local shards
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs the global op on fake
            # tensors for its output's shape: no work of this rank's
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func.__name__.split(".")[0]
        base = name.rstrip("_") if name not in _COLLECTIVES else name
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        c = self.cost
        if name in _COLLECTIVES or base in _COLLECTIVES:
            kind = _COLLECTIVES.get(name, _COLLECTIVES.get(base))
            b = sum(_nbytes(t) for t in ins) or sum(_nbytes(t) for t in outs)
            c.collective_bytes += b
            c.collective_breakdown[kind] = \
                c.collective_breakdown.get(kind, 0.0) + b
            return
        if base in _VIEWS or name in _VIEWS or not outs:
            return
        flops = 0.0
        if base in _MATMUL:
            a = args[-2] if base in ("addmm", "baddbmm") else args[0]
            flops = 2.0 * outs[0].numel() * a.shape[-1]
        elif base in _ELEMENTWISE:
            flops = _ELEMENTWISE[base] * float(sum(t.numel() for t in outs))
        rb = sum(_nbytes(t) for t in outs)
        if base in _SLICES:
            b = 2 * rb
        else:
            b = sum(_nbytes(t) for t in ins) + rb
        c.flops += flops
        c.bytes += b
        key = (base, tuple(tuple(t.shape) for t in ins[:3]))
        row = c.ops[key]
        row[0] += 1
        row[1] += b
        row[2] += flops


def measure(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), StepCost)`` with every op ``fn`` runs
    counted, on this rank."""
    mode = CostMode()
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.cost


def roofline(cost: StepCost, peak_flops: float, hbm_bw: float,
             link_bw: float) -> dict:
    """The three roofline terms (seconds) of a step's per-device cost."""
    return {"compute_s": cost.flops / peak_flops,
            "memory_s": cost.bytes / hbm_bw,
            "collective_s": cost.collective_bytes / link_bw}


def shard_bytes(tree) -> int:
    """Bytes this rank holds of a tree of tensors / DTensors (each
    DTensor's local shard)."""
    total = 0
    for t in _tensors(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total
