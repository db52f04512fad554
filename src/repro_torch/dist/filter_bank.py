"""Range-partitioned bloomRF filter bank on one device, and its
``torch.distributed`` variant.

Counterpart of ``repro/dist/filter_bank.py``.  The global key domain
(``d`` bits) is range-partitioned by its top ``log2(n_shards)`` bits; shard
``s`` owns ``[s << d_local, (s+1) << d_local)`` and runs an independent
bloomRF over the low ``d_local = d - log2(n_shards)`` bits.  The state is
``int32[n_shards, total_u32]``: one row of uint32 lanes per shard.

Routing, as in the reference:

* insert -- each key is ORed into the row of the shard that owns it.  On a
  CUDA state whose shard layout the kernels take (``d_local <= 32``) the
  keys of a call are grouped by row on the card (a stable sort by row and
  one ``bincount`` read by the host) and each row that owns keys takes one
  launch of the insert kernel (``kernels/insert.py``, B1) on its
  contiguous row.  OR is commutative, so the state equals the reference's
  masked scatter bit for bit.  Otherwise the plain path ORs every owned
  position into the flat state at once.
* point -- every row's verdict AND the ownership mask, any-reduced.  On a
  CUDA state of such a layout, hashed (no exact layer), the verdicts of
  all rows come from the stacked point kernel (``kernels/probe.py::
  point_probe_stacked_resident``, B6): one launch per ``MAX_ROWS`` rows,
  one launch in all up to 65,535 rows; otherwise from the plain
  ``StackedProbe.point_all``, the reference's route.
* range -- ``[lo, hi]`` is clipped to each shard's interval
  (:meth:`FilterBank._clip_to_shard`) and every row answers its clipped
  sub-range through the plain ``StackedProbe.range_all`` with bounds per
  row, ``(B, S)``; no kernel takes bounds per row (the stacked range
  kernel shares one ``(B,)`` bound over its rows), so ranges launch none,
  as in the reference.

Everything runs where the state lies; ``use_kernels=False`` keeps a CUDA
bank on the plain path (the façade's ``backend="xla"``).  A failed build
or launch of a kernel propagates; no path falls back to the plain one.

:class:`ShardedFilterBank` lays the rows out over the ranks of a
``torch.distributed`` group: each rank holds consecutive rows and runs the
same per-row bodies; probe verdicts are any-reduced with an
``all_reduce``.
"""
from __future__ import annotations

import torch

from ..core import uint64 as u64
from ..core.bloomrf import resolve_device
from ..core.engine import _filter_for_layout, stacked_probe
from ..core.layout import basic_layout
from ..kernels import insert as _insert
from ..kernels import probe as _probe
from ..kernels._checks import MAX_ROWS

__all__ = ["FilterBank", "ShardedFilterBank", "kernel_rows", "insert_rows",
           "point_rows", "range_rows"]

#: plan cells (queries x gathered lanes) of one plain stacked range call;
#: larger batches are answered in slices, each query on its own
RANGE_CELLS = 1 << 24


def kernel_rows(layout, device: torch.device,
                use_kernels: bool = True) -> bool:
    """Whether rows of ``layout`` on ``device`` take the kernels: a CUDA
    device and a layout of ``d <= 32``.  Every such row builds through B1;
    :func:`point_rows` also needs a hashed layout for B6."""
    return use_kernels and device.type == "cuda" and layout.d <= 32


def insert_rows(layout, rows: torch.Tensor, keys: torch.Tensor,
                row: torch.Tensor, kernels: bool) -> torch.Tensor:
    """OR ``keys`` (int64 carriers) into ``rows`` (``int32[R, total_u32]``)
    in place, key ``i`` into row ``row[i]``; a ``row`` of ``R`` owns the key
    to no row.  Returns ``rows``.

    With ``kernels``, one insert-kernel launch per row that owns keys;
    otherwise the plain scatter of every owned position at once."""
    R, U = rows.shape
    if kernels:
        order = torch.sort(row, stable=True).indices
        grouped = keys[order]
        counts = torch.bincount(row, minlength=R + 1)[:R].tolist()
        off = 0
        for r, c in enumerate(counts):
            if c:
                _insert.insert_resident(layout, rows[r], grouped[off:off + c])
            off += c
        return rows
    own = row < R
    f = _filter_for_layout(layout, rows.device)
    pos = f.positions(keys[own]) + (row[own] * (U * 32))[:, None]
    return rows.copy_(f.scatter_or(rows.reshape(-1), pos).view(R, U))


def point_rows(layout, rows: torch.Tensor, keys: torch.Tensor, probe,
               kernels: bool) -> torch.Tensor:
    """``bool[B, R]`` point verdicts of every row of ``rows``: with
    ``kernels`` and a hashed layout, one B6 launch per ``MAX_ROWS`` rows
    (the kernel's row grid); else the plain ``probe.point_all``."""
    if not kernels or layout.has_exact:
        return probe.point_all(rows.reshape(-1), keys)
    if rows.shape[0] <= MAX_ROWS:
        return _probe.point_probe_stacked_resident(layout, rows, keys)
    return torch.cat([_probe.point_probe_stacked_resident(
        layout, rows[r:r + MAX_ROWS], keys)
        for r in range(0, rows.shape[0], MAX_ROWS)], dim=1)


def range_rows(probe, flat: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """``bool[B, R]`` range verdicts of ``probe``'s rows over ``flat`` for
    bounds per row ``(B, R)``, through the plain ``StackedProbe.range_all``
    in slices of at most :data:`RANGE_CELLS` plan cells."""
    step = max(1, RANGE_CELLS // max(probe.range_gather_width, 1))
    if lo.shape[0] <= step:
        return probe.range_all(flat, lo, hi)
    return torch.cat([probe.range_all(flat, lo[s:s + step], hi[s:s + step])
                      for s in range(0, lo.shape[0], step)])


def owned_any(hits: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``hits[i, row[i]]`` where ``0 <= row[i] < R``, else False: a verdict
    AND its ownership mask, any-reduced over the rows."""
    R = hits.shape[1]
    own = (row >= 0) & (row < R)
    at = torch.clamp(row, 0, R - 1)[:, None]
    return own & hits.gather(1, at)[:, 0]


def any_reduce(local: torch.Tensor, group) -> torch.Tensor:
    """Any-reduce ``bool`` verdicts over the ranks of ``group``."""
    import torch.distributed as dist

    t = local.to(torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t > 0


class FilterBank:
    """``n_shards`` independent bloomRFs over a range-partitioned domain,
    on ``device`` (default ``"cuda"``)."""

    def __init__(self, d: int, n_shards: int, n_keys: int,
                 bits_per_key: float = 16.0, delta: int = 6,
                 seed: int = 0x0B100F11, *, device=None,
                 use_kernels: bool = True, _warn: bool = True,
                 _layout=None):
        if _warn:
            from .._compat import warn_legacy

            warn_legacy("FilterBank(d, n_shards, ...)",
                        "dtype=..., n=..., placement='bank', shards=...")
        if n_shards < 1 or n_shards & (n_shards - 1):
            raise ValueError(f"n_shards must be a power of two, got {n_shards}")
        shard_bits = n_shards.bit_length() - 1
        if shard_bits >= d:
            raise ValueError(f"{n_shards} shards need more than d={d} bits")
        self.d = d
        self.n_shards = n_shards
        self.shard_bits = shard_bits
        self.d_local = d - shard_bits
        self.n_keys = n_keys
        self.bits_per_key = bits_per_key
        self.delta = delta
        self.seed = seed
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        if _layout is not None:           # in-place growth (core/dynamic.py)
            if _layout.d != self.d_local:
                raise ValueError(
                    f"_layout.d={_layout.d} != shard domain {self.d_local}")
            self.layout = _layout
        else:
            self.layout = basic_layout(self.d_local,
                                       max(n_keys // n_shards, 1),
                                       bits_per_key,
                                       delta=min(delta, self.d_local),
                                       seed=seed)
        U = self.layout.total_u32
        # all shard rows probed at once: one gather (core/engine.py)
        self._stacked = stacked_probe((self.layout,) * n_shards,
                                      tuple(s * U for s in range(n_shards)),
                                      self.device)
        self.kernels = kernel_rows(self.layout, self.device, use_kernels)

    # -- key routing -----------------------------------------------------
    def _route(self, keys):
        """(local keys in the shard sub-domain, owning shard index), both
        int64 carriers on the bank's device."""
        keys = torch.atleast_1d(torch.as_tensor(keys, dtype=torch.int64,
                                                device=self.device))
        if self.shard_bits == 0:     # shard 0 owns all
            return keys, torch.zeros_like(keys)
        low = keys & ((1 << self.d_local) - 1)
        return low, u64.shr(keys, self.d_local)

    def _clip_to_shard(self, s_idx, lo_low, lo_shard, hi_low, hi_shard):
        """Clip routed global ranges to the shards ``s_idx`` (an ``(n, 1)``
        column broadcasts against ``(B,)`` bounds to ``(n, B)``).

        Returns ``(nonempty, llo, lhi)``: whether the intersection with the
        shard's dyadic interval is non-empty, and the clipped local bounds.
        The tenant bank's meta path and skip accounting reuse it."""
        top = u64.signed((1 << self.d_local) - 1)
        nonempty = (s_idx >= lo_shard) & (s_idx <= hi_shard)
        llo = torch.where(lo_shard == s_idx, lo_low, 0)
        lhi = torch.where(hi_shard == s_idx, hi_low, top)
        return nonempty, llo, lhi

    # -- the per-row bodies (the bank and its sharded variant) ------------
    def _local_rows(self, shard, row0: int, n: int):
        """Row of each key among rows ``row0 .. row0 + n - 1``; ``n`` where
        none of them owns it."""
        loc = shard - row0
        return torch.where((loc >= 0) & (loc < n), loc, n)

    def _range_local(self, state, probe, row0: int, lo, hi):
        lo_low, lo_shard = self._route(lo)
        hi_low, hi_shard = self._route(hi)
        n = state.shape[0]
        ids = torch.arange(row0, row0 + n, device=state.device)[:, None]
        nonempty, llo, lhi = self._clip_to_shard(ids, lo_low, lo_shard,
                                                 hi_low, hi_shard)  # (n, B)
        hits = range_rows(probe, state.reshape(-1), llo.T, lhi.T)
        return (hits & nonempty.T).any(dim=1)

    # -- single-device API -------------------------------------------------
    def init_state(self) -> torch.Tensor:
        return torch.zeros((self.n_shards, self.layout.total_u32),
                           dtype=torch.int32, device=self.device)

    def insert(self, state: torch.Tensor, keys) -> torch.Tensor:
        """OR ``keys`` into ``state`` in place; returns ``state``."""
        low, shard = self._route(keys)
        row = self._local_rows(shard, 0, self.n_shards)
        return insert_rows(self.layout, state, low, row, self.kernels)

    def build(self, keys) -> torch.Tensor:
        return self.insert(self.init_state(), keys)

    def point(self, state: torch.Tensor, qs) -> torch.Tensor:
        low, shard = self._route(qs)
        hits = point_rows(self.layout, state, low, self._stacked,
                          self.kernels)                        # (B, S)
        return owned_any(hits, shard)

    def range(self, state: torch.Tensor, lo, hi) -> torch.Tensor:
        return self._range_local(state, self._stacked, 0, lo, hi)

    def size_bits(self) -> int:
        return self.n_shards * self.layout.total_bits


class ShardedFilterBank:
    """A :class:`FilterBank` with its rows laid out over the ranks of a
    ``torch.distributed`` group (default: the world).

    Each rank holds ``n_shards / world`` consecutive rows (its local state,
    ``int32[rows_per_rank, total_u32]``) and runs the bank's per-row bodies
    on them, B1 and B6 included on a CUDA state; probe verdicts are
    any-reduced with an ``all_reduce``, so they equal the single-device
    bank's bit for bit.  Every rank calls each method with the same
    arguments."""

    def __init__(self, bank: FilterBank, group=None):
        import torch.distributed as dist

        n = dist.get_world_size(group)
        if bank.n_shards % n:
            raise ValueError(f"{bank.n_shards} shards do not divide over "
                             f"{n} ranks")
        self.bank = bank
        self.group = group
        self.rows_per_rank = bank.n_shards // n
        self.row0 = dist.get_rank(group) * self.rows_per_rank
        U = bank.layout.total_u32
        self._stacked = stacked_probe(
            (bank.layout,) * self.rows_per_rank,
            tuple(r * U for r in range(self.rows_per_rank)), bank.device)

    # -- state placement -------------------------------------------------
    def init_state(self) -> torch.Tensor:
        return torch.zeros((self.rows_per_rank, self.bank.layout.total_u32),
                           dtype=torch.int32, device=self.bank.device)

    def shard_state(self, state: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full ``(n_shards, total_u32)`` state."""
        return state[self.row0:self.row0 + self.rows_per_rank].clone()

    def gather_state(self, local: torch.Tensor) -> torch.Tensor:
        """The full ``(n_shards, total_u32)`` state from every rank's rows."""
        import torch.distributed as dist

        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        return torch.cat(parts)

    # -- API (mirrors FilterBank) ----------------------------------------
    def insert(self, state: torch.Tensor, keys) -> torch.Tensor:
        bank = self.bank
        low, shard = bank._route(keys)
        row = bank._local_rows(shard, self.row0, self.rows_per_rank)
        return insert_rows(bank.layout, state, low, row, bank.kernels)

    def build(self, keys) -> torch.Tensor:
        return self.insert(self.init_state(), keys)

    def point(self, state: torch.Tensor, qs) -> torch.Tensor:
        bank = self.bank
        low, shard = bank._route(qs)
        hits = point_rows(bank.layout, state, low, self._stacked,
                          bank.kernels)
        return any_reduce(owned_any(hits, shard - self.row0), self.group)

    def range(self, state: torch.Tensor, lo, hi) -> torch.Tensor:
        return any_reduce(self.bank._range_local(state, self._stacked,
                                                 self.row0, lo, hi),
                          self.group)
