"""Rosetta (Luo et al., SIGMOD 2020) — hierarchical dyadic Bloom filters.

First-cut flavour (the paper's variant F): one BF per dyadic level 0..L; the
bottom level is sized for the target FPR, upper levels for FPR ~ 1/(2-eps)
(~1.44 bits/key, k=1).  Range queries use the standard dyadic decomposition
and *doubting*: every positive above level 0 is re-checked through its
children until a level-0 positive survives (worst case linear in R, as the
bloomRF paper notes).
"""
from __future__ import annotations

import math

import numpy as np

from .api import mix64_np, seeds_np

__all__ = ["Rosetta"]

_UPPER_BPK = 1.44  # bits/key per upper level (FPR ~ 0.5, k=1)


class Rosetta:
    def __init__(self, bits_per_key: float = 16.0, max_range_log2: int = 14,
                 decompose_cap: int = 4096, frontier_cap: int = 1 << 22,
                 seed: int = 0x4057A):
        self.bits_per_key = bits_per_key
        self.L = max_range_log2
        self.decompose_cap = decompose_cap
        self.frontier_cap = frontier_cap
        self.seed = seed

    # ------------------------------------------------------------------
    def build(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, np.uint64)
        n = max(len(keys), 1)
        total = int(n * self.bits_per_key)
        upper = int(math.ceil(_UPPER_BPK * n))
        L = self.L
        # shrink the hierarchy if the budget cannot afford all upper levels
        while L > 1 and total - L * upper < 2 * n:
            L -= 1
        self.L = L
        m_bottom = max(64, (total - L * upper) // 64 * 64)
        m_upper = max(64, upper // 64 * 64)
        self.m_lvl = [m_bottom] + [m_upper] * L
        self.k_lvl = [max(1, int(math.log(2) * m_bottom / n))] + [1] * L
        self.off = np.cumsum([0] + self.m_lvl[:-1]).astype(np.int64)
        self.total_m = int(sum(self.m_lvl))
        self._seeds = {
            lvl: seeds_np(self.seed + 101 * lvl, self.k_lvl[lvl])
            for lvl in range(L + 1)
        }
        self.bits = np.zeros(self.total_m // 32, np.uint32)
        for lvl in range(L + 1):
            pref = keys >> np.uint64(lvl)
            pos = self._positions(lvl, pref).reshape(-1)
            np.bitwise_or.at(self.bits, pos >> 5,
                             np.uint32(1) << (pos & 31).astype(np.uint32))

    def _positions(self, lvl: int, prefixes: np.ndarray) -> np.ndarray:
        m = np.uint64(self.m_lvl[lvl])
        hs = [(mix64_np(prefixes, int(s)) % m).astype(np.int64) + self.off[lvl]
              for s in self._seeds[lvl]]
        return np.stack(hs, axis=-1)

    def _probe(self, lvl_arr: np.ndarray, prefixes: np.ndarray) -> np.ndarray:
        out = np.zeros(len(prefixes), bool)
        for lvl in np.unique(lvl_arr):
            sel = lvl_arr == lvl
            pos = self._positions(int(lvl), prefixes[sel])
            got = (self.bits[pos >> 5] >> (pos & 31).astype(np.uint32)) & 1
            out[sel] = got.all(axis=-1)
        return out

    # ------------------------------------------------------------------
    def point(self, qs: np.ndarray) -> np.ndarray:
        qs = np.asarray(qs, np.uint64)
        return self._probe(np.zeros(len(qs), np.int64), qs)

    @staticmethod
    def _decompose(lo: int, hi: int, L: int, cap: int):
        """Standard dyadic decomposition into <= 2 DIs per level <= L."""
        out = []
        a, b = lo, hi + 1
        lvl = 0
        while a < b:
            if lvl >= L:
                if ((b - a) >> lvl) > cap:
                    return out, True
                out.extend((lvl, p) for p in range(a >> lvl, b >> lvl))
                return out, False
            if a & (1 << lvl):
                out.append((lvl, a >> lvl))
                a += 1 << lvl
            if b & (1 << lvl):
                b -= 1 << lvl
                out.append((lvl, b >> lvl))
            lvl += 1
        return out, False

    def range(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        B = len(lo)
        out = np.zeros(B, bool)
        qid, lvl, pref = [], [], []
        for q in range(B):
            items, overflow = self._decompose(int(lo[q]), int(hi[q]), self.L,
                                              self.decompose_cap)
            if overflow:
                out[q] = True
                continue
            for (lv, p) in items:
                qid.append(q)
                lvl.append(lv)
                pref.append(p)
        qid = np.asarray(qid, np.int64)
        lvl = np.asarray(lvl, np.int64)
        pref = np.asarray(pref, np.uint64)
        # doubting BFS
        while len(qid):
            alive = self._probe(lvl, pref) & ~out[qid]
            hit0 = alive & (lvl == 0)
            out[qid[hit0]] = True
            expand = alive & (lvl > 0)
            qid, lvl, pref = qid[expand], lvl[expand], pref[expand]
            if len(qid) == 0:
                break
            qid = np.repeat(qid, 2)
            lvl = np.repeat(lvl, 2) - 1
            pref = np.repeat(pref << np.uint64(1), 2)
            pref[1::2] |= np.uint64(1)
            if len(qid) > self.frontier_cap:  # runaway doubting -> concede
                out[np.unique(qid)] = True
                break
            keep = ~out[qid]
            qid, lvl, pref = qid[keep], lvl[keep], pref[keep]
        return out

    def size_bits(self) -> int:
        return self.total_m
