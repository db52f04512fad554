"""SuRF-lite: a truncated-trie point-range filter with SuRF's FPR behaviour.

SuRF (Zhang et al., SIGMOD 2018) stores the minimal distinguishing prefix of
every key in a fast succinct trie (LOUDS-DS) plus optional suffix bits
(SuRF-Real) or a key hash (SuRF-Hash).  We keep the *filtering semantics*
(truncated leaf intervals + suffixes) and replace the LOUDS encoding with
sorted interval arrays; reported size uses the SuRF paper's ~10 bits/key
structural cost plus suffix bits (see DESIGN.md §5.3).
"""
from __future__ import annotations

import numpy as np

from .api import mix64_np

__all__ = ["SuRFLite"]

_STRUCT_BPK = 10.0  # LOUDS-DS structural bits/key (SuRF paper, §6)


class SuRFLite:
    def __init__(self, suffix_bits: int = 4, mode: str = "real",
                 seed: int = 0x50F5):
        assert mode in ("real", "hash", "none")
        self.suffix_bits = suffix_bits if mode != "none" else 0
        self.mode = mode
        self.seed = seed

    @classmethod
    def for_budget(cls, bits_per_key: float, mode: str = "real") -> "SuRFLite":
        return cls(suffix_bits=max(0, int(round(bits_per_key - _STRUCT_BPK))),
                   mode=mode)

    def build(self, keys: np.ndarray) -> None:
        ks = np.unique(np.asarray(keys, np.uint64))
        self.n = len(ks)
        if self.n == 0:
            self.starts = np.zeros(0, np.uint64)
            self.ends = np.zeros(0, np.uint64)
            return
        # minimal distinguishing prefix length (bits from MSB)
        def lcp(a, b):
            x = a ^ b
            out = np.full(len(a), 64, np.int64)
            nz = x != 0
            # number of leading common bits = 64 - bit_length(xor)
            bl = np.zeros(len(a), np.int64)
            xv = x[nz]
            for shift in (32, 16, 8, 4, 2, 1):  # bit-length via binary steps
                big = xv >= (np.uint64(1) << np.uint64(shift))
                bl[np.nonzero(nz)[0][big]] += shift
                xv = np.where(big, xv >> np.uint64(shift), xv)
            out[nz] = 63 - bl[nz]
            return out

        left = np.full(self.n, 0, np.int64)
        right = np.full(self.n, 0, np.int64)
        if self.n > 1:
            lc = lcp(ks[1:], ks[:-1])
            left[1:] = lc
            right[:-1] = lc
        plen = np.minimum(np.maximum(left, right) + 1, 64)
        if self.mode == "real":
            plen = np.minimum(plen + self.suffix_bits, 64)
        rem = (64 - plen).astype(np.uint64)
        self.starts = np.where(plen == 64, ks, (ks >> rem) << rem)
        self.ends = np.where(
            plen == 64, ks,
            self.starts + ((np.uint64(1) << rem) - np.uint64(1)))
        self._plen_sum = int(plen.sum())
        if self.mode == "hash":
            mask = np.uint64((1 << self.suffix_bits) - 1)
            self.hashes = mix64_np(ks, self.seed) & mask

    # ------------------------------------------------------------------
    def _leaf_of(self, qs: np.ndarray) -> np.ndarray:
        i = np.searchsorted(self.starts, qs, side="right") - 1
        ok = i >= 0
        ok[ok] &= qs[ok] <= self.ends[np.maximum(i, 0)][ok]
        return np.where(ok, i, -1)

    def point(self, qs: np.ndarray) -> np.ndarray:
        qs = np.asarray(qs, np.uint64)
        leaf = self._leaf_of(qs)
        hit = leaf >= 0
        if self.mode == "hash" and self.suffix_bits > 0:
            mask = np.uint64((1 << self.suffix_bits) - 1)
            qh = mix64_np(qs, self.seed) & mask
            hit &= np.where(leaf >= 0,
                            self.hashes[np.maximum(leaf, 0)] == qh, False)
        return hit

    def range(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        i = np.searchsorted(self.starts, lo, side="right") - 1
        ok = np.zeros(len(lo), bool)
        valid = i >= 0
        ok[valid] = self.ends[np.maximum(i, 0)][valid] >= lo[valid]
        j = np.minimum(i + 1, len(self.starts) - 1)
        more = (i + 1) < len(self.starts)
        ok |= more & (self.starts[j] <= hi)
        return ok

    def size_bits(self) -> int:
        return int(_STRUCT_BPK * self.n + self.suffix_bits * self.n)
