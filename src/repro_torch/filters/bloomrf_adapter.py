"""bloomRF adapted to the common host-side filter API used by benchmarks.

A thin shim over the port's typed façade: ``build`` opens a
:class:`repro_torch.api.SingleFilter` from the equivalent
:class:`~repro_torch.api.FilterSpec` and every probe rides the façade's
shared chunked probe path, so a benchmark measures the production façade,
not a private side door.

The reference's adapter pins ``backend="xla"`` so that its benchmarks
measure the façade.  On the card the port's ``"xla"`` is the plain PyTorch
path, which would hide the CUDA kernels, so this adapter passes
``backend="auto"``: at d <= 32 on a CUDA device that launches the insert,
point and range kernels (one launch per chunk); on the CPU and at d = 64
it takes the plain path.  The verdicts and the state are bit-identical
either way.
"""
from __future__ import annotations

import math

import numpy as np

from ..api import FilterSpec, open_filter

__all__ = ["BloomRFAdapter"]


class BloomRFAdapter:
    """``mode``:
    * ``"basic"`` — tuning-free basic bloomRF (paper §3–§5), good to R<=2^14;
    * ``"tuned"`` — advisor-selected layout for the given R (paper §7);
    * ``"auto"``  — basic when R <= 2^14 else tuned.

    Maps onto ``FilterSpec.tuning`` = ``"basic"`` / ``"advised"`` /
    ``"auto"``.  The filter lives on ``device`` (default ``"cuda"``).
    """

    _TUNING = {"basic": "basic", "tuned": "advised", "auto": "auto"}

    def __init__(self, bits_per_key: float = 16.0, d: int = 64,
                 R: float = 2 ** 14, mode: str = "auto", delta: int = 7,
                 point_weight: float = 1.0, seed: int = 0x0B100F11,
                 chunk: int = 1 << 18, device=None):
        assert mode in ("basic", "tuned", "auto")
        self.bits_per_key = bits_per_key
        self.d = d
        self.R = R
        self.mode = mode
        self.delta = delta
        self.point_weight = point_weight
        self.seed = seed
        self.chunk = chunk
        self.device = device

    def build(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, np.uint64)
        range_log2 = max(int(math.ceil(math.log2(max(self.R, 2.0)))), 1)
        self.handle = open_filter(FilterSpec(
            dtype=f"u{self.d}", n=max(len(keys), 1),
            bits_per_key=self.bits_per_key,
            range_log2=min(range_log2, self.d),
            tuning=self._TUNING[self.mode], delta=self.delta,
            point_weight=self.point_weight, backend="auto",
            chunk=self.chunk, seed=self.seed), device=self.device)
        self.handle.insert(keys)
        self.layout = self.handle.layout
        self.filter = self.handle.filter

    @property
    def state(self):
        return self.handle.state

    def point(self, qs: np.ndarray) -> np.ndarray:
        return self.handle.point(np.asarray(qs, np.uint64))

    def range(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        return self.handle.range(np.asarray(lo, np.uint64),
                                 np.asarray(hi, np.uint64))

    def insert_more(self, keys: np.ndarray) -> None:
        """Online insertion (the paper's Problem 2: bloomRF is online)."""
        self.handle.insert(np.asarray(keys, np.uint64))

    def size_bits(self) -> int:
        return self.handle.size_bits()
