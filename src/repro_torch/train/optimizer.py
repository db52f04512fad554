"""AdamW + cosine schedule with warmup and global-norm clipping.

Counterpart of ``repro/train/optimizer.py``: the state is ``{"m", "v",
"count"}``, f32 leaves shaped as the parameters and an int32 0-d count,
so ``train/checkpoint.py`` writes the reference's files.  The arithmetic
is the reference's, op for op in f32; ``adamw_update`` runs in place
under ``torch.no_grad()`` (the params, ``m`` and ``v`` are updated where
they lie), which saves a copy of each at full width.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.params import tree_leaves, tree_map

__all__ = ["OptConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), an f32 0-d
    tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params):
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": zeros,
            "v": tree_map(torch.clone, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2)
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, opt_state, params):
    """One AdamW step: returns ``(params, opt_state, {"lr", "grad_norm"})``.
    ``params`` and ``opt_state``'s ``m`` and ``v`` are updated in place and
    returned; ``count`` is a new tensor."""
    count = opt_state["count"] + 1
    cf = count.to(torch.float32)
    lr = cosine_lr(cfg, count)

    gnorm = global_norm(grads)
    # a tensor numerator: torch computes ``float / tensor`` as a
    # reciprocal times the float, the reference a true division
    scale = torch.clamp(torch.full_like(gnorm, cfg.clip_norm) /
                        torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=cf.device), cf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=cf.device), cf)

    def upd(p, m_, v_, g):
        g = g.float() * scale
        m_.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v_.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = m_ / bc1 / (torch.sqrt(v_ / bc2) + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (step + cfg.weight_decay * pf))

    for p, m_, v_, g in zip(tree_leaves(params), tree_leaves(opt_state["m"]),
                            tree_leaves(opt_state["v"]), tree_leaves(grads)):
        upd(p, m_, v_, g)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "count": count}, {"lr": lr, "grad_norm": gnorm}
