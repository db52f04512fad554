"""Fault tolerance: crash/restart supervision and elastic restore.

Counterpart of ``repro/train/fault_tolerance.py``.

* :class:`Supervisor` (numpy, copied) -- wraps a Trainer factory; on
  worker failure (any exception from the step loop) it recreates the
  trainer, which restores from the latest checkpoint, and resumes.
  Bounded restarts with jittered exponential backoff between attempts
  (doubling base delay, capped, plus a seeded random jitter fraction so a
  fleet of supervisors never restarts in lockstep); every incident is
  logged with the delay it waited.
* :func:`elastic_restore` -- restore a checkpoint and place it on a
  (possibly different) mesh through a ``Shardings`` tree, on a device, or
  leaf by leaf on a tree of devices.
* Straggler mitigation lives in Trainer._detect_straggler (step-time
  z-score outliers flagged and surfaced for rescheduling).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.params import tree_map
from .checkpoint import restore_checkpoint

__all__ = ["Supervisor", "elastic_restore"]


class Supervisor:
    """Bounded-restart trainer supervision with jittered exponential backoff.

    ``backoff_base`` seconds doubles per consecutive failure up to
    ``backoff_cap``, then a uniform jitter of up to ``jitter`` of the delay
    is added (seeded -- deterministic in tests).  ``sleep`` is injectable so
    tests assert the schedule without waiting it out.  The restart budget
    counts *consecutive* failures within one :meth:`run` call; each call
    starts fresh, so a supervisor that recovered successfully can be reused
    with a full budget."""

    def __init__(self, trainer_factory: Callable, max_restarts: int = 3,
                 backoff_base: float = 0.5, backoff_cap: float = 30.0,
                 jitter: float = 0.25, seed: int = 0,
                 sleep: Optional[Callable[[float], None]] = None):
        if backoff_base < 0 or backoff_cap < 0 or not (0 <= jitter <= 1):
            raise ValueError("backoff_base/backoff_cap must be >= 0 and "
                             "jitter in [0, 1]")
        self.factory = trainer_factory
        self.max_restarts = max_restarts
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.jitter = jitter
        self._rng = np.random.default_rng(seed)
        self._sleep = sleep if sleep is not None else time.sleep
        self.incidents: List[dict] = []

    def _backoff(self, n_failures: int) -> float:
        """Delay before restart ``n_failures`` (1-based): capped doubling
        plus up to ``jitter`` fraction of uniform random spread."""
        base = min(self.backoff_base * (2.0 ** (n_failures - 1)),
                   self.backoff_cap)
        return base * (1.0 + self.jitter * float(self._rng.random()))

    def run(self):
        restarts = 0
        while True:
            trainer = self.factory()
            try:
                metrics = trainer.run()
                return {"metrics": metrics, "restarts": restarts,
                        "incidents": self.incidents,
                        "stragglers": trainer.straggler_events}
            except Exception as e:  # noqa: BLE001 -- any worker fault
                restarts += 1
                delay = self._backoff(restarts)
                self.incidents.append({
                    "time": time.time(), "error": repr(e),
                    "backoff_s": delay,
                    "resume_step": getattr(trainer, "start_step", 0)})
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                self._sleep(delay)


def elastic_restore(ckpt_dir: str, step: int, like, devices=None,
                    shardings=None):
    """Restore checkpoint ``step`` in the structure of ``like``, then place
    it: distributed by ``shardings`` (a tree of ``dist.sharding.
    NamedSharding`` shaped as ``like``, e.g. ``make_shardings(...).params``
    on a new mesh; every rank reads the whole checkpoint and keeps its
    shards) when given; else on ``devices`` when it is one device, leaf by
    leaf when it is a tree of devices shaped as ``like``; left as restored
    (each leaf as its like-leaf lies) when both are None."""
    if shardings is not None and devices is not None:
        raise ValueError("pass shardings or devices, not both")
    tree = restore_checkpoint(ckpt_dir, step, like)
    if shardings is not None:
        from ..dist.sharding import place

        return place(tree_map(torch.as_tensor, tree), shardings)
    if devices is None:
        return tree
    if isinstance(devices, (str, torch.device)):
        return tree_map(lambda a: torch.as_tensor(a).to(devices), tree)
    return tree_map(lambda a, d: torch.as_tensor(a).to(d), tree, devices)
