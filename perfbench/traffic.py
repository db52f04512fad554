"""The one generator of keys and traffic, driven by a configuration's and a
traffic mix's data files.

A configuration (``configs/<name>.json``) names its key domain by the
spec's ``dtype`` (``u<bits>``, ``bits`` up to 62 here) and its key
distribution under ``keys``; a traffic mix (``traffic/<name>.json``) names
the operations it takes in turns, the batch size, the pool of batches the
window cycles through, and the parameters of each operation:

* ``point``: ``present_share`` of the queries drawn from the inserted keys,
  the rest uniform over the domain, shuffled;
* ``range``: starts drawn like the keys (the paper's method queries ranges
  from the data's own distribution) and one length, ``2^len_log2``, cut at
  the top of the domain;
* ``insert``: a fresh key set of ``batch`` keys from the configuration's
  distribution per pool entry, inserted into a zeroed state.

A distribution is ``{"dist": "uniform"}`` over the domain, ``{"dist":
"normal", "mean": m, "sd": s}`` (as fractions of the domain, clipped to
it) or ``{"dist": "zipf", "s": s}`` (a discretised Pareto tail of exponent
``s - 1``, scaled into the domain, with low-bit jitter): the three the
paper's Fig. 9 and 11 draw keys from.

Everything is drawn on the device from one ``torch.Generator`` seeded with
the run's seed, in a fixed order, so a seed gives the same inputs and every
seed the same sizes.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

__all__ = ["Batch", "draw", "make_keys", "make_pool", "domain_bits"]

_UNSIGNED = re.compile(r"^u([0-9]+)$")


def domain_bits(config: dict) -> int:
    """The key domain's width in bits, from the spec's ``dtype``."""
    dtype = config["spec"]["dtype"]
    m = _UNSIGNED.match(dtype)
    if m is None or not 1 <= int(m.group(1)) <= 62:
        raise ValueError(f"the benchmark's generator draws unsigned keys of "
                         f"up to 62 bits (u8 ... u32), not {dtype!r}")
    return int(m.group(1))


@dataclasses.dataclass
class Batch:
    """One pool entry: its operation and its int64 operands on the device
    (``keys`` for point and insert, ``lo``/``hi`` for range)."""

    kind: str
    keys: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None
    hi: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return (self.keys if self.keys is not None else self.lo).numel()


def draw(dist: dict, n: int, bits: int, gen: torch.Generator,
         device) -> torch.Tensor:
    """``n`` int64 values of a ``bits``-bit domain from ``dist``."""
    top = (1 << bits) - 1
    kind = dist.get("dist", "uniform")
    if kind == "uniform":
        return torch.randint(0, top + 1, (n,), generator=gen, device=device,
                             dtype=torch.int64)
    if kind == "normal":
        g = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
        x = (dist.get("mean", 0.5) + dist.get("sd", 0.1) * g).clamp(0, 1)
        return (x * top).to(torch.int64)
    if kind == "zipf":
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
        z = torch.floor((1.0 - u) ** (-1.0 / (dist.get("s", 1.2) - 1.0)))
        x = z / (z.max() + 1.0) * (1 << (bits - 2))
        jitter = torch.randint(0, 1 << max(bits - 8, 1), (n,), generator=gen,
                               device=device, dtype=torch.int64)
        return (x.to(torch.int64) + jitter).clamp(0, top)
    raise ValueError(f"unknown distribution {kind!r}")


def make_keys(config: dict, n: int, gen, device) -> torch.Tensor:
    """``n`` keys of the configuration's distribution."""
    return draw(config.get("keys", {}), n, domain_bits(config), gen, device)


def make_pool(config: dict, traffic: dict, keys: torch.Tensor, gen,
              device) -> list:
    """The traffic mix's pool of batches: entry ``j`` is operation
    ``ops[j % len(ops)]`` over ``batch`` queries or keys."""
    bits = domain_bits(config)
    top = (1 << bits) - 1
    ops, n = traffic["ops"], traffic["batch"]
    pool = []
    for j in range(traffic["pool"]):
        kind = ops[j % len(ops)]
        if kind == "point":
            m = int(round(n * traffic["point"]["present_share"]))
            pick = torch.randint(0, keys.numel(), (m,), generator=gen,
                                 device=device)
            absent = draw({}, n - m, bits, gen, device)
            order = torch.randperm(n, generator=gen, device=device)
            pool.append(Batch("point",
                              keys=torch.cat([keys[pick], absent])[order]))
        elif kind == "range":
            lo = make_keys(config, n, gen, device)
            length = 1 << traffic["range"]["len_log2"]
            pool.append(Batch("range", lo=lo,
                              hi=(lo + (length - 1)).clamp(max=top)))
        elif kind == "insert":
            pool.append(Batch("insert", keys=make_keys(config, n, gen,
                                                       device)))
        else:
            raise ValueError(f"unknown operation {kind!r}")
    return pool
