"""Train step factory + the host-side Trainer loop.

Counterpart of ``repro/train/train_loop.py``, eager.  ``make_train_step``
builds

    step(params, opt_state, ef_error, batch)
        -> (params, opt_state, ef_error, metrics)

with optional microbatch gradient accumulation (the reference's
``lax.scan`` over microbatches is a loop here) and optional int8
error-feedback gradient compression.  The step updates ``params`` and the
optimizer's moments in place (``optimizer.adamw_update``) and returns them.

``Trainer`` is the host loop: data iterator, metrics log, periodic
checkpoints through ``train/checkpoint.py``, straggler detection and
failure injection for restart tests (see ``fault_tolerance.py`` for the
supervisor).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..dist.compression import ef_compress, ef_init
from ..models.params import tree_leaves, tree_map
from .optimizer import OptConfig, adamw_init, adamw_update

__all__ = ["TrainConfig", "make_train_step", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    microbatches: int = 1           # gradient accumulation
    grad_compression: bool = False  # int8 error-feedback
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_zscore: float = 3.0
    seed: int = 0


def _microbatch(batch, mb: int, i: int):
    """Microbatch ``i`` of ``mb``: a leaf whose axis 0 divides by ``mb`` is
    sliced, any other leaf is passed whole (the reference broadcasts it)."""
    def split(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] % mb == 0:
            n = x.shape[0] // mb
            return x[i * n:(i + 1) * n]
        return x
    return tree_map(split, batch)


def make_train_step(model, opt_cfg: OptConfig, train_cfg: TrainConfig):
    """Returns step(params, opt_state, ef_error, batch) -> (...)."""

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        loss = model.loss(tree_map(lambda _: next(it), params), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, grads)])
        return loss.detach(), tree_map(lambda _: next(it), params)

    def grads_of(params, batch):
        mb = train_cfg.microbatches
        if mb <= 1:
            return value_and_grad(params, batch)
        acc_l = torch.zeros((), dtype=torch.float32,
                            device=tree_leaves(params)[0].device)
        acc_g = tree_map(torch.zeros_like, params)
        for i in range(mb):
            loss, g = value_and_grad(params, _microbatch(batch, mb, i))
            acc_l = acc_l + loss / mb
            # a + x / mb, as the reference sums, without a third copy
            tree_map(lambda a, x: a.add_(x.div_(mb)), acc_g, g)
            del g      # freed before the next microbatch's backward
        return acc_l, acc_g

    def step(params, opt_state, ef_error, batch):
        loss, grads = grads_of(params, batch)
        if train_cfg.grad_compression:
            grads, ef_error = ef_compress(grads, ef_error)
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state, params)
        metrics = {"loss": loss, **om}
        return params, opt_state, ef_error, metrics

    return step


class Trainer:
    """Host-side training loop with fault-tolerance hooks.  The default
    step trains ``params`` in place."""

    def __init__(self, model, params, opt_cfg: OptConfig,
                 train_cfg: TrainConfig, data_iter,
                 ckpt_dir: Optional[str] = None,
                 step_fn: Optional[Callable] = None,
                 fail_at_step: Optional[int] = None):
        from .checkpoint import latest_step, restore_checkpoint

        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.data_iter = data_iter
        self.ckpt_dir = ckpt_dir
        self.fail_at_step = fail_at_step  # failure injection (tests)
        self.metrics_log: list = []
        self.straggler_events: list = []

        self.step_fn = step_fn or make_train_step(model, opt_cfg, train_cfg)
        self.params = params
        self.opt_state = adamw_init(params)
        self.ef_error = ef_init(params) if train_cfg.grad_compression else {}
        self.start_step = 0
        if ckpt_dir and latest_step(ckpt_dir) is not None:
            st = latest_step(ckpt_dir)
            tree = restore_checkpoint(
                ckpt_dir, st,
                {"params": self.params, "opt": self.opt_state})
            self.params = tree["params"]
            self.opt_state = tree["opt"]
            self.start_step = st + 1

    # ------------------------------------------------------------------
    def _detect_straggler(self, times):
        if len(times) < 8:
            return None
        arr = np.asarray(times[-32:])
        mu, sd = arr[:-1].mean(), arr[:-1].std() + 1e-9
        z = (arr[-1] - mu) / sd
        if z > self.cfg.straggler_zscore:
            return {"step": len(times) - 1, "z": float(z),
                    "action": "flagged-for-rescheduling"}
        return None

    def run(self):
        from .checkpoint import save_checkpoint

        times = []
        step = self.start_step
        while step < self.cfg.steps:
            batch = next(self.data_iter)
            if self.fail_at_step is not None and step == self.fail_at_step:
                self.fail_at_step = None
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            self.params, self.opt_state, self.ef_error, metrics = \
                self.step_fn(self.params, self.opt_state, self.ef_error,
                             batch)
            if metrics["loss"].device.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            ev = self._detect_straggler(times)
            if ev:
                self.straggler_events.append(ev)
            if step % self.cfg.log_every == 0 or step == self.cfg.steps - 1:
                rec = {"step": step,
                       **{k: float(v) for k, v in metrics.items()},
                       "step_time_s": times[-1]}
                self.metrics_log.append(rec)
            if self.ckpt_dir and (
                    (step + 1) % self.cfg.checkpoint_every == 0 or
                    step == self.cfg.steps - 1):
                save_checkpoint(self.ckpt_dir, step,
                                {"params": self.params,
                                 "opt": self.opt_state},
                                device=metrics["loss"].device)
            step += 1
        return self.metrics_log
