"""Multi-tenant bloomRF filter bank with Bloofi-style meta rows.

Counterpart of ``repro/dist/tenant_bank.py``.  One range-partitioned bank
(:class:`~repro_torch.dist.filter_bank.FilterBank`) per tenant, stacked on
a leading tenant dimension:

    state: int32[n_tenants, n_shards, total_u32]
    meta : int32[n_tenants, n_shards, meta_total_u32]

Row ``t * n_shards + s`` belongs to tenant ``t`` and shard ``s``; a key is
owned by the row of its tenant and shard, so a tenant that never inserted
answers from all-zero rows (no cross-tenant false positives, never a
false negative).  The meta row of each (tenant, shard) is a coarse bloomRF
over the dyadic prefixes ``key >> meta_level`` of the row's keys: a range
probe also asks it about the clipped range's prefixes, and its negative
proves the row's sub-range empty (``main & meta``, never a false
negative).  :meth:`TenantFilterBank.meta_skip_stats` counts the
(probe, row) pairs the meta rows prove empty.

Routing on a CUDA state follows the bank's (``dist/filter_bank.py``):
main and meta rows build through the insert kernel, one launch per row
that owns keys of a call; a point probe of a hashed layout is one launch
of the stacked point kernel over the ``T * S`` rows (one per 65,535 rows
above that), then the ownership mask by tenant and shard; ranges, with or without meta, run the plain ``StackedProbe`` with
bounds per row (with meta, the main and meta rows of two layouts sit in
one stack, as in the reference).  On a CPU state, or with
``use_kernels=False``, every path is plain.

:class:`AgingTenantBank` ages keys out through generation lanes
(``core.Generations``) of ``(state, meta)`` pairs, and
:class:`ShardedTenantFilterBank` lays tenants over the ranks of a
``torch.distributed`` group, optionally replicated ``r``-way with probe
batches split over the replicas.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.dynamic import Generations, promote_layout, promote_state
from ..core.engine import stacked_probe
from ..core.hashing import dyadic_prefixes
from ..core.layout import basic_layout
from .filter_bank import (FilterBank, any_reduce, insert_rows, kernel_rows,
                          owned_any, point_rows, range_rows)

__all__ = ["TenantFilterBank", "ShardedTenantFilterBank", "AgingTenantBank",
           "replica_groups"]

_NO_TENANT = 0xFFFFFFFF  # padding sentinel tenant id: owned by nobody


class TenantFilterBank:
    """``n_tenants`` independent :class:`FilterBank`\\ s stacked on a
    leading dimension, on ``device`` (default ``"cuda"``)."""

    def __init__(self, d: int, n_tenants: int, n_shards: int,
                 n_keys_per_tenant: int, bits_per_key: float = 16.0,
                 delta: int = 6, meta_level: Optional[int] = None,
                 meta_bits_per_prefix: float = 8.0, seed: int = 0x0B100F11,
                 *, device=None, use_kernels: bool = True,
                 _warn: bool = True, _layout=None, _meta_layout=None):
        if _warn:
            from .._compat import warn_legacy

            warn_legacy("TenantFilterBank(d, n_tenants, ...)",
                        "dtype=..., n=..., placement='tenant', tenants=..., "
                        "shards=...")
        if n_tenants < 1:
            raise ValueError(f"need >= 1 tenant, got {n_tenants}")
        self.bank = FilterBank(d, n_shards, n_keys_per_tenant, bits_per_key,
                               delta=delta, seed=seed, device=device,
                               use_kernels=use_kernels, _warn=False,
                               _layout=_layout)
        self.device = self.bank.device
        self.use_kernels = use_kernels
        self.d = d
        self.n_tenants = n_tenants
        self.n_shards = n_shards
        self.n_keys_per_tenant = n_keys_per_tenant
        self.bits_per_key = bits_per_key
        self.delta = delta
        self.meta_bits_per_prefix = meta_bits_per_prefix
        self.seed = seed
        d_local = self.bank.d_local
        if meta_level is None:
            # a ~12-bit prefix domain per shard; above 32 shard bits the
            # prefix domain stays on the same side of 32 bits as the main
            # rows (they share one stacked plan), so it widens to 33
            target = 12 if d_local <= 32 else 33
            meta_level = d_local - min(target, max(d_local - 1, 1))
        if not (0 < meta_level < d_local):
            raise ValueError(
                f"meta_level must be in (0, {d_local}), got {meta_level}")
        self.meta_level = meta_level
        d_meta = d_local - meta_level
        if (d_meta <= 32) != (d_local <= 32):
            raise ValueError(
                f"meta_level={meta_level} puts the {d_meta}-bit prefix "
                f"domain in a different key dtype than the {d_local}-bit "
                f"shard domain; the stacked main+meta plan needs one dtype "
                f"(keep d_meta on the same side of 32 bits as d_local)")
        if _meta_layout is not None:      # in-place growth (core/dynamic.py)
            if _meta_layout.d != d_meta:
                raise ValueError(
                    f"_meta_layout.d={_meta_layout.d} != prefix domain "
                    f"{d_meta}")
            self.meta_layout = _meta_layout
        else:
            n_prefixes = max(min(n_keys_per_tenant // n_shards,
                                 1 << min(d_meta, 24)), 1)
            self.meta_layout = basic_layout(
                d_meta, n_prefixes, meta_bits_per_prefix,
                delta=min(delta, max(d_meta, 1)), seed=seed ^ 0xB100F1)
        R = self.n_rows = n_tenants * n_shards
        self._stacked, self._stacked_meta, self._meta_rows = \
            self.row_probes(R)
        self.kernels = kernel_rows(self.bank.layout, self.device,
                                   use_kernels)
        self.meta_kernels = kernel_rows(self.meta_layout, self.device,
                                        use_kernels)

    def row_probes(self, n: int):
        """Stacked probes over ``n`` rows: the main rows, the main rows
        followed by their meta rows (one flat vector, main first), and the
        meta rows alone."""
        U = self.bank.layout.total_u32
        Um = self.meta_layout.total_u32
        main = tuple(r * U for r in range(n))
        meta = tuple(r * Um for r in range(n))
        lay, mlay = (self.bank.layout,) * n, (self.meta_layout,) * n
        return (stacked_probe(lay, main, self.device),
                stacked_probe(lay + mlay,
                              main + tuple(n * U + b for b in meta),
                              self.device),
                stacked_probe(mlay, meta, self.device))

    # -- layout ----------------------------------------------------------
    def init_state(self) -> torch.Tensor:
        return torch.zeros((self.n_tenants, self.n_shards,
                            self.bank.layout.total_u32), dtype=torch.int32,
                           device=self.device)

    def init_meta(self) -> torch.Tensor:
        return torch.zeros((self.n_tenants, self.n_shards,
                            self.meta_layout.total_u32), dtype=torch.int32,
                           device=self.device)

    # -- the per-row bodies (the bank and its sharded variant) ------------
    def _tenants(self, tenants) -> torch.Tensor:
        return torch.atleast_1d(torch.as_tensor(tenants, dtype=torch.int64,
                                                device=self.device))

    def _rows(self, tenants, shard, row0: int, n: int) -> torch.Tensor:
        """Row of each key among rows ``row0 .. row0 + n - 1`` (row ``t * S
        + s``); ``n`` where none of them owns it."""
        S = self.n_shards
        loc = tenants * S + shard - row0
        return torch.where((shard < S) & (loc >= 0) & (loc < n), loc, n)

    def _insert_local(self, rows, tenants, keys, row0: int, meta: bool,
                      kernels: bool):
        tenants = self._tenants(tenants)
        low, shard = self.bank._route(keys)
        n = rows.shape[0] * rows.shape[1]
        row = self._rows(tenants, shard, row0, n)
        if meta:
            low = dyadic_prefixes(low, self.meta_level, self.bank.d_local)
        layout = self.meta_layout if meta else self.bank.layout
        insert_rows(layout, rows.view(n, -1), low, row, kernels)
        return rows

    def _point_local(self, state, tenants, qs, row0: int, probe,
                     kernels: bool):
        tenants = self._tenants(tenants)
        low, shard = self.bank._route(qs)
        n = state.shape[0] * state.shape[1]
        hits = point_rows(self.bank.layout, state.view(n, -1), low, probe,
                          kernels)
        return owned_any(hits, self._rows(tenants, shard, row0, n))

    def _clip_rows(self, tenants, lo, hi, row0: int, n: int):
        """Per-row clipped bounds ``(B, n)`` of rows ``row0 ..`` and the
        ownership mask: the row's clipped interval is non-empty and the
        query's tenant is the row's."""
        bank = self.bank
        tenants = self._tenants(tenants)
        lo_low, lo_shard = bank._route(lo)
        hi_low, hi_shard = bank._route(hi)
        g = torch.arange(row0, row0 + n, device=self.device)
        nonempty, llo, lhi = bank._clip_to_shard(
            (g % self.n_shards)[:, None], lo_low, lo_shard, hi_low,
            hi_shard)                                           # (n, B)
        own = nonempty.T & (tenants[:, None] == (g // self.n_shards)[None])
        return llo.T, lhi.T, own

    def _prefixes(self, x):
        return dyadic_prefixes(x, self.meta_level, self.bank.d_local)

    def _range_local(self, state, meta, tenants, lo, hi, row0: int, probe,
                     probe_meta):
        n = state.shape[0] * state.shape[1]
        llo, lhi, own = self._clip_rows(tenants, lo, hi, row0, n)
        if meta is None:
            hits = range_rows(probe, state.reshape(-1), llo, lhi)
            return (hits & own).any(dim=1)
        # the meta rows join the same stack: main & meta in one gather
        flat = torch.cat([state.reshape(-1), meta.reshape(-1)])
        hits = range_rows(probe_meta, flat,
                          torch.cat([llo, self._prefixes(llo)], dim=1),
                          torch.cat([lhi, self._prefixes(lhi)], dim=1))
        return (hits[:, :n] & hits[:, n:] & own).any(dim=1)

    # -- single-device API -------------------------------------------------
    def insert(self, state: torch.Tensor, tenants, keys) -> torch.Tensor:
        """OR ``keys`` into their tenants' rows of ``state`` in place;
        returns ``state``."""
        return self._insert_local(state, tenants, keys, 0, False,
                                  self.kernels)

    def insert_meta(self, meta: torch.Tensor, tenants, keys) -> torch.Tensor:
        """OR the keys' dyadic prefixes into their meta rows in place."""
        return self._insert_local(meta, tenants, keys, 0, True,
                                  self.meta_kernels)

    def build(self, tenants, keys) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.insert(self.init_state(), tenants, keys),
                self.insert_meta(self.init_meta(), tenants, keys))

    def point(self, state: torch.Tensor, tenants, qs) -> torch.Tensor:
        return self._point_local(state, tenants, qs, 0, self._stacked,
                                 self.kernels)

    def range(self, state: torch.Tensor, tenants, lo, hi,
              meta: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._range_local(state, meta, tenants, lo, hi, 0,
                                 self._stacked, self._stacked_meta)

    def meta_skip_stats(self, meta: torch.Tensor, tenants, lo, hi):
        """(candidate row probes, meta-skipped row probes) over a range
        batch, as device scalars.  A candidate is a (probe, row) pair of
        the probe's tenant whose clipped interval is non-empty; it is
        skipped when the meta row proves it empty, which saves the row's
        main-filter word reads."""
        llo, lhi, cand = self._clip_rows(tenants, lo, hi, 0, self.n_rows)
        hit = range_rows(self._meta_rows, meta.reshape(-1),
                         self._prefixes(llo), self._prefixes(lhi))
        return cand.sum(), (cand & ~hit).sum()

    def record_meta_skips(self, meta: torch.Tensor, tenants, lo, hi) -> None:
        """Add :meth:`meta_skip_stats` to the ``tenant_bank/*`` counters of
        the obs registry; the device scalars settle at ``snapshot()``."""
        from ..obs import metrics as _obs_metrics

        cand, skip = self.meta_skip_stats(meta, tenants, lo, hi)
        reg = _obs_metrics.registry()
        reg.counter("tenant_bank/meta_candidates").add(cand)
        reg.counter("tenant_bank/meta_skipped").add(skip)

    def size_bits(self) -> int:
        return self.n_tenants * self.n_shards * (
            self.bank.layout.total_bits + self.meta_layout.total_bits)

    # -- in-place capacity growth (core/dynamic.py) ------------------------
    def grown(self, factor: int = 4) -> "TenantFilterBank":
        """A bank sized for ``factor`` times more keys per tenant whose
        layouts are the segment-tiled promotions of this bank's: existing
        state carries over through :meth:`promote`, no key re-hashed."""
        return TenantFilterBank(
            self.d, self.n_tenants, self.n_shards,
            n_keys_per_tenant=self.n_keys_per_tenant * factor,
            bits_per_key=self.bits_per_key, delta=self.delta,
            meta_level=self.meta_level,
            meta_bits_per_prefix=self.meta_bits_per_prefix, seed=self.seed,
            device=self.device, use_kernels=self.use_kernels, _warn=False,
            _layout=promote_layout(self.bank.layout, factor),
            _meta_layout=promote_layout(self.meta_layout, factor))

    def advise_promotion(self, workload, n_current: Optional[int] = None,
                         n_target: Optional[int] = None,
                         factors: Tuple[int, ...] = (2, 4, 8)):
        """Workload-advised promotion factor, as the reference's.

        Prices each candidate factor ``f``'s promoted layout under the
        sampled workload (``tune.cost.score_layout``) at ``f * n_current +
        (n_target - n_current)`` keys, with the workload's range lengths
        rescaled to the shard-local domain.  The smallest factor with
        enough headroom wins unless a larger one at least halves the
        predicted mixed FPR.  Returns ``(factor, {factor: CostReport})``."""
        from ..tune.cost import score_layout

        n_current = self.n_keys_per_tenant if n_current is None \
            else int(n_current)
        n_target = 2 * n_current if n_target is None else int(n_target)
        if n_current < 1 or n_target < n_current:
            raise ValueError(
                f"need 1 <= n_current <= n_target, got "
                f"n_current={n_current} n_target={n_target}")
        wl = workload.rescaled(
            -int(round(math.log2(self.n_shards)))) if self.n_shards > 1 \
            else workload
        reports, best = {}, None
        for f in sorted(set(int(f) for f in factors)):
            if f < 2 or self.n_keys_per_tenant * f < n_target:
                continue        # not enough headroom for the target
            try:
                lay = promote_layout(self.bank.layout, f)
            except ValueError:
                continue
            n_eff = f * n_current + (n_target - n_current)
            reports[f] = score_layout(lay, n_eff, wl)
            if best is None or \
                    reports[f].fpr_mix < 0.5 * reports[best].fpr_mix:
                best = f
        if best is None:
            raise ValueError(
                f"no promotion factor in {factors} reaches "
                f"n_target={n_target} from {self.n_keys_per_tenant} "
                f"keys/tenant")
        return best, reports

    def promote(self, state: torch.Tensor, meta: torch.Tensor,
                factor: int = 4):
        """Grow in place: ``(new_bank, new_state, new_meta)`` with every
        inserted key still probing positive under the ``factor``-times
        larger layouts, without the original keys."""
        nb = self.grown(factor)
        return (nb,
                promote_state(state, self.bank.layout, nb.bank.layout),
                promote_state(meta, self.meta_layout, nb.meta_layout))


class AgingTenantBank:
    """TTL over a :class:`TenantFilterBank`: sweep-free expiry through
    generation lanes (``core.Generations``) of ``(state, meta)`` pairs.

    Inserts land in the current generation; probes read the OR of all
    generations; :meth:`advance` retires the oldest.  A retired key
    probing absent is the TTL contract, not a false negative."""

    def __init__(self, bank: TenantFilterBank, n_generations: int = 4):
        self.bank = bank
        self.gens = Generations(
            lambda: (bank.init_state(), bank.init_meta()), n_generations)

    @property
    def n_generations(self) -> int:
        return self.gens.n_generations

    def insert(self, tenants, keys) -> None:
        self.gens.insert(
            lambda sm, t, k: (self.bank.insert(sm[0], t, k),
                              self.bank.insert_meta(sm[1], t, k)),
            tenants, keys)

    def point(self, tenants, qs) -> torch.Tensor:
        state, _ = self.gens.collapsed
        return self.bank.point(state, tenants, qs)

    def range(self, tenants, lo, hi, use_meta: bool = True) -> torch.Tensor:
        state, meta = self.gens.collapsed
        return self.bank.range(state, tenants, lo, hi,
                               meta if use_meta else None)

    def advance(self) -> None:
        """Retire the oldest generation's contributions."""
        self.gens.advance()

    def promoted(self, factor: int = 4) -> "AgingTenantBank":
        """Grow every generation in place to ``factor`` larger layouts."""
        nb = self.bank.grown(factor)
        ol, nl = self.bank.bank.layout, nb.bank.layout
        oml, nml = self.bank.meta_layout, nb.meta_layout
        out = AgingTenantBank.__new__(AgingTenantBank)
        out.bank = nb
        out.gens = self.gens.map(
            lambda sm: (promote_state(sm[0], ol, nl),
                        promote_state(sm[1], oml, nml)),
            zero_fn=lambda: (nb.init_state(), nb.init_meta()))
        return out

    def size_bits(self) -> int:
        return self.bank.size_bits() * self.n_generations


def replica_groups(n_replicas: int = 1):
    """``(data_group, replica_group)`` of this rank on a ``(replica,
    data)`` mesh over the default world, rank ``= replica * n_data +
    data``: the data group splits the tenants, the replica group holds the
    same tenants.  Every rank must call it, in the same order."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if n_replicas < 1 or world % n_replicas:
        raise ValueError(f"{n_replicas} replicas do not divide a world of "
                         f"{world}")
    n_data = world // n_replicas
    data = [dist.new_group([r * n_data + j for j in range(n_data)])
            for r in range(n_replicas)]
    reps = [dist.new_group([r * n_data + j for r in range(n_replicas)])
            for j in range(n_data)]
    rank = dist.get_rank()
    return data[rank // n_data], reps[rank % n_data]


class ShardedTenantFilterBank:
    """A :class:`TenantFilterBank` laid out over ``torch.distributed``
    groups.

    The tenants split over the ranks of ``data_group`` (each holds
    ``n_tenants / size`` consecutive tenants, ``int32[tenants_per_rank, S,
    U]``); with a ``replica_group``, the ranks in it hold the same tenants
    and each answers one contiguous block of every batch (padded with the
    no-tenant sentinel to a multiple of the replica count), the blocks'
    verdicts then gathered; a replica's inserts are ORed into every
    replica by ``all_gather`` and a bitwise OR.  Verdicts and states equal
    the single-device bank's bit for bit.  Every rank calls each method
    with the same arguments; :func:`replica_groups` builds the groups."""

    def __init__(self, tbank: TenantFilterBank, data_group=None,
                 replica_group=None):
        import torch.distributed as dist

        n_data = dist.get_world_size(data_group)
        if tbank.n_tenants % n_data:
            raise ValueError(f"{tbank.n_tenants} tenants do not divide over "
                             f"{n_data} ranks")
        self.tbank = tbank
        self.data_group = data_group
        self.replica_group = replica_group
        self.n_replicas = 1 if replica_group is None \
            else dist.get_world_size(replica_group)
        self.replica = 0 if replica_group is None \
            else dist.get_rank(replica_group)
        self.tenants_per_rank = tbank.n_tenants // n_data
        self.t0 = dist.get_rank(data_group) * self.tenants_per_rank
        n = self.tenants_per_rank * tbank.n_shards
        self.row0 = self.t0 * tbank.n_shards
        self._stacked, self._stacked_meta, _ = tbank.row_probes(n)

    # -- state placement --------------------------------------------------
    def init_state(self) -> torch.Tensor:
        return self.shard_state(self.tbank.init_state())

    def init_meta(self) -> torch.Tensor:
        return self.shard_state(self.tbank.init_meta())

    def shard_state(self, state: torch.Tensor) -> torch.Tensor:
        """This rank's tenants of a full ``[T, S, U]`` state (or meta)."""
        return state[self.t0:self.t0 + self.tenants_per_rank].clone()

    shard_meta = shard_state

    def gather_state(self, local: torch.Tensor) -> torch.Tensor:
        """The full ``[T, S, U]`` state (or meta) from the data group."""
        return torch.cat(self._all_gather(local, self.data_group))

    # -- collectives -------------------------------------------------------
    @staticmethod
    def _all_gather(t: torch.Tensor, group) -> list:
        import torch.distributed as dist

        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return parts

    def _pad(self, tenants, arrs):
        """Pad the batch to a multiple of the replica count with the
        no-tenant sentinel (owned by nobody) and zero keys, and cut this
        replica's block; returns ``(tenants, arrs, n)``."""
        tenants = self.tbank._tenants(tenants)
        n = tenants.shape[0]
        pad = (-n) % self.n_replicas
        if pad:
            tenants = torch.cat([tenants, tenants.new_full((pad,),
                                                           _NO_TENANT)])
            arrs = [torch.cat([a, a.new_zeros(pad)]) for a in arrs]
        b = tenants.shape[0] // self.n_replicas
        cut = slice(self.replica * b, (self.replica + 1) * b)
        return tenants[cut], [a[cut] for a in arrs], n

    def _verdicts(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """Any-reduce a block's verdicts over the data group, then gather
        the replicas' blocks into the batch."""
        v = any_reduce(local, self.data_group)
        if self.replica_group is not None:
            v = torch.cat(self._all_gather(v.to(torch.int32),
                                           self.replica_group)) > 0
        return v[:n]

    def _replica_or(self, state: torch.Tensor) -> torch.Tensor:
        if self.replica_group is None:
            return state
        parts = self._all_gather(state, self.replica_group)
        out = parts[0]
        for p in parts[1:]:
            out = out | p
        return state.copy_(out)

    # -- API (mirrors TenantFilterBank) -------------------------------------
    def _keys(self, keys):
        return torch.atleast_1d(torch.as_tensor(keys, dtype=torch.int64,
                                                device=self.tbank.device))

    def insert(self, state: torch.Tensor, tenants, keys) -> torch.Tensor:
        t, (k,), _ = self._pad(tenants, [self._keys(keys)])
        self.tbank._insert_local(state, t, k, self.row0, False,
                                 self.tbank.kernels)
        return self._replica_or(state)

    def insert_meta(self, meta: torch.Tensor, tenants, keys) -> torch.Tensor:
        t, (k,), _ = self._pad(tenants, [self._keys(keys)])
        self.tbank._insert_local(meta, t, k, self.row0, True,
                                 self.tbank.meta_kernels)
        return self._replica_or(meta)

    def build(self, tenants, keys):
        return (self.insert(self.init_state(), tenants, keys),
                self.insert_meta(self.init_meta(), tenants, keys))

    def point(self, state: torch.Tensor, tenants, qs) -> torch.Tensor:
        t, (q,), n = self._pad(tenants, [self._keys(qs)])
        return self._verdicts(self.tbank._point_local(
            state, t, q, self.row0, self._stacked, self.tbank.kernels), n)

    def range(self, state: torch.Tensor, tenants, lo, hi,
              meta: Optional[torch.Tensor] = None) -> torch.Tensor:
        t, (a, b), n = self._pad(tenants, [self._keys(lo), self._keys(hi)])
        return self._verdicts(self.tbank._range_local(
            state, meta, t, a, b, self.row0, self._stacked,
            self._stacked_meta), n)
