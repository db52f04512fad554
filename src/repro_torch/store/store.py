"""The LSM run-store: memtable + leveled runs + stacked filter probes.

Counterpart of ``repro/store/store.py``.

Write path: ``put``/``delete`` land in the memtable; at ``memtable_limit``
entries the memtable flushes to an immutable level-0 :class:`Run` carrying
a bloomRF filter block (layout from a capacity-class ladder) and min/max
fences.  When level 0 exceeds ``level0_runs`` runs, leveled compaction
merges them (plus the next level's run) downward: same-class filter blocks
merge with one ``bitwise_or``, class-graduating merges re-insert the keys.
Every filter build (flush or rebuild) goes through the insert kernel,
``kernels/insert.py::insert_resident``: one launch on a CUDA store, its
plain version on the CPU.

Read path: ``get``/``scan`` first consult the memtable, then probe **all**
live runs' filters at once.  The runs' states are concatenated into one
flat lane vector on the store's device.  Point lookups go through the
plain ``StackedProbe`` (one gather over the flat state); scans go through
the store-scan kernel (``kernels/store_scan.py``, one launch per scan
batch) or, with ``scan_backend="xla"`` or on the CPU, through the plain
``StackedProbe.touch_all``.  Only runs whose fences overlap *and* whose
filter says "maybe" have their data read; :class:`StoreStats` counts what
the filters saved.  A store of ``d > 32`` keys (int64 carriers of the
uint64 bits) builds, gets and scans on the plain path, as the reference's
does: no kernel takes its layouts.

Filters are insert-only at write time: a delete writes a tombstone entry
whose key is inserted like any other, so newer tombstones mask older runs
at read time.  With ``mutability="deletable"`` compaction fights the
resulting FPR drift: class-graduating merges *promote* source filters in
place (segment tiling, no kernel launch) instead of replaying keys, and a
merge whose dead-entry fraction exceeds ``purge_dead_frac`` rebuilds the
filter from the surviving keys (one insert-kernel launch), purging every
deleted key's bits.

Durability: with ``durability="wal"`` every ``put``/``delete``/
``delete_many`` appends a CRC-framed record to a write-ahead log
(``store/wal.py``) *before* the memtable acks it, and
:meth:`Store.checkpoint` publishes a checksummed snapshot + manifest via
atomic renames (``store/integrity.py``) before resetting the log;
:meth:`Store.open` recovers the acknowledged state after a crash at any
point, onto the device the caller names.  Snapshots hold host data only
(numpy arrays, Python objects), the reference's dict field for field, so
either package restores the other's.  Runs whose filter block fails its
checksum are *quarantined*: the probe plane (the store-scan kernel and the
plain path alike) degrades them to fence-only pruning, so scans stay exact
(``StoreStats.degraded_probes``).

The store lives on ``device``, ``"cuda"`` unless the caller asks for
another; without a card it raises.  With ``scan_backend="auto"`` a scan
batch is retried on the plain path only after an
:class:`~repro_torch.store.faults.InjectedDispatchFault` from the fault
seam; every other error of the kernel (a failed build or launch)
propagates.  Flushes, compactions, gets, scans, checkpoints, scrubs and
WAL replays report through ``obs`` (spans, and the store's
:class:`StoreStats` as a registered metric family).

``filter_backend`` may name a host baseline of ``filters/`` (``bloom``,
``prefix_bloom``, ``rosetta``, ``surf``): each run then carries a numpy
filter (``Run.alt``), built at flush and at every compaction (a rebuild
merge), probed column by column on the host; no kernel runs for it.

``tuning="adaptive"`` samples the scan workload (``tune/``): flushes take
each capacity class's standing decision, and a compaction consults the
solver where it pays for a rebuild anyway, re-inserting into the tuned
layout (``StoreStats.retunes``).  The tuned layouts, Δ = 1..7 ladders and
a replicated top layer at the class's bit budget, reach the insert and
store-scan kernels like any other.  The fitted workload model rides in
snapshots and checkpoints.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import warnings
import weakref
from typing import ClassVar, List, Optional, Tuple

import numpy as np
import torch

from ..core import uint64 as u64
from ..core.bloomrf import resolve_device
from ..core.engine import _filter_for_layout, fence_mask, stacked_probe
from ..core.layout import basic_layout
from ..kernels.insert import insert_resident
from ..kernels.store_scan import store_scan_probe_flat
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from .compaction import merge_filter_state, merge_sorted_runs
from .faults import FaultPlan, InjectedDispatchFault
from .integrity import (MANIFEST_FILENAME, atomic_write_bytes, crc32_bytes,
                        read_manifest, write_manifest)
from .memtable import TOMBSTONE, Memtable
from .run import Run
from .wal import WAL_FILENAME, Wal

__all__ = ["Store", "StoreConfig", "StoreStats"]


def _baseline_factory(name: str):
    from .. import filters as F

    return {
        "bloom": lambda bpk: F.BloomFilter(bits_per_key=bpk),
        "prefix_bloom": lambda bpk: F.PrefixBloomFilter(bits_per_key=bpk),
        "rosetta": lambda bpk: F.Rosetta(bits_per_key=bpk),
        "surf": lambda bpk: F.SuRFLite(),
    }[name]


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """The reference's configuration, field for field and check for check
    (so one config describes the same store in both packages)."""

    d: int = 32                     # key-domain bits
    memtable_limit: int = 4096      # entries per flush (= capacity class 0)
    bits_per_key: float = 14.0
    delta: int = 6
    fanout: int = 4                 # capacity-class / level size ratio
    level0_runs: int = 4            # level-0 run count that triggers compaction
    filter_backend: str = "bloomrf"  # "bloomrf" | "none" | a filters/ baseline
                                    # ("bloom", "prefix_bloom", "rosetta",
                                    # "surf"), built and probed on the host
    scan_backend: str = "auto"      # scan-pruning plane: "auto" | "kernel"
                                    # | "xla" — "kernel" runs the store-scan
                                    # kernel (kernels/store_scan.py), "xla"
                                    # the plain StackedProbe.touch_all,
                                    # "auto" the kernel on a CUDA device
    use_insert_kernels: bool = False  # the reference's Pallas-or-XLA build
                                    # switch; no effect in the port, whose
                                    # builds always take the insert kernel
    value_bytes: int = 64           # per-entry data-block size for accounting
    seed: int = 0x0B100F11
    mutability: str = "insert_only"  # "insert_only" | "deletable"
    tuning: str = "static"          # "static" | "adaptive" (tune/: retune
                                    # at class-graduating compactions)
    purge_dead_frac: float = 0.25   # deletable: dead fraction forcing a purge
    promote_max_hops: int = 1       # deletable: promote hops before a rebuild
    promote_density_slack: float = 1.5  # deletable: promote density guard
    durability: str = "none"        # "none" | "wal"
    wal_dir: Optional[str] = None   # durable root: WAL + snapshots + manifest
    wal_sync: str = "flush"         # "flush" | "always"

    def __post_init__(self):
        if not (1 <= self.d <= 64):
            raise ValueError(
                f"d must be in 1..64 (uint64 key domain), got {self.d}")
        if not self.bits_per_key > 0:
            raise ValueError(
                f"bits_per_key must be > 0, got {self.bits_per_key}")
        if self.memtable_limit < 1 or self.fanout < 2 or self.level0_runs < 1:
            raise ValueError("memtable_limit >= 1, fanout >= 2, "
                             "level0_runs >= 1 required")
        if self.mutability not in ("insert_only", "deletable"):
            raise ValueError(
                f"mutability must be 'insert_only' or 'deletable', "
                f"got {self.mutability!r}")
        if self.tuning not in ("static", "adaptive"):
            raise ValueError(f"tuning must be 'static' or 'adaptive', "
                             f"got {self.tuning!r}")
        if self.tuning == "adaptive" and self.filter_backend != "bloomrf":
            raise ValueError(
                f"tuning='adaptive' re-solves bloomRF layouts; it needs "
                f"filter_backend='bloomrf', not {self.filter_backend!r}")
        if not (0.0 < self.purge_dead_frac <= 1.0):
            raise ValueError(
                f"purge_dead_frac must be in (0, 1], got {self.purge_dead_frac}")
        if self.promote_max_hops < 0:
            raise ValueError(
                f"promote_max_hops must be >= 0, got {self.promote_max_hops}")
        if not self.promote_density_slack > 0:
            raise ValueError(f"promote_density_slack must be > 0, "
                             f"got {self.promote_density_slack}")
        if self.filter_backend not in ("bloomrf", "none"):
            try:
                _baseline_factory(self.filter_backend)
            except KeyError:
                raise ValueError(
                    f"unknown filter_backend {self.filter_backend!r}") from None
        if self.scan_backend not in ("auto", "kernel", "xla"):
            raise ValueError(f"scan_backend must be 'auto', 'kernel' or "
                             f"'xla', got {self.scan_backend!r}")
        if self.durability not in ("none", "wal"):
            raise ValueError(f"durability must be 'none' or 'wal', "
                             f"got {self.durability!r}")
        if self.durability == "wal" and not self.wal_dir:
            raise ValueError("durability='wal' requires wal_dir")
        if self.wal_sync not in ("flush", "always"):
            raise ValueError(f"wal_sync must be 'flush' or 'always', "
                             f"got {self.wal_sync!r}")


@dataclasses.dataclass
class StoreStats:
    """Counters for what the filter blocks saved on the read path.

    The reference's fields, in the reference's order, so ``as_dict()`` of
    the same op stream is equal in both packages.  :data:`DURABLE` names
    the counters a snapshot carries: they survive restore, checkpoint and
    recovery; the read-path counters describe this process's traffic."""

    puts: int = 0
    deletes: int = 0
    gets: int = 0
    scans: int = 0
    flushes: int = 0
    compactions: int = 0
    or_merges: int = 0              # same-layout filter merges (bitwise OR)
    rebuild_merges: int = 0         # cross-layout merges (key re-insert)
    promote_merges: int = 0         # in-place segment-tiled class promotions
    purge_rebuilds: int = 0         # rebuilds forced by the dead-frac policy
    retunes: int = 0                # compaction rebuilds into a tuned layout
    # point reads
    get_runs_considered: int = 0
    get_fence_skips: int = 0
    get_filter_skips: int = 0
    get_run_reads: int = 0
    get_fp_reads: int = 0           # run read, key absent
    # scans
    scan_runs_considered: int = 0
    scan_fence_skips: int = 0
    scan_filter_skips: int = 0
    scan_runs_touched: int = 0
    scan_fp_reads: int = 0          # run touched, empty slice
    # data-block bytes
    bytes_read: int = 0
    bytes_not_read: int = 0         # skipped runs' data bytes
    # durability / degradation
    wal_appends: int = 0            # records framed before acking a write
    wal_replayed: int = 0           # records recovered at the last open
    degraded_probes: int = 0        # (query, run) cells answered fence-only
                                    # because the run is quarantined
    kernel_fallbacks: int = 0       # scan batches retried on the plain path
                                    # after an InjectedDispatchFault

    DURABLE: ClassVar[Tuple[str, ...]] = (
        "puts", "deletes", "flushes", "compactions", "or_merges",
        "rebuild_merges", "promote_merges", "purge_rebuilds", "retunes",
        "kernel_fallbacks")

    @property
    def runs_probed_per_scan(self) -> float:
        return self.scan_runs_touched / max(self.scans, 1)

    @property
    def scan_fp_read_rate(self) -> float:
        return self.scan_fp_reads / max(self.scan_runs_touched, 1)

    @property
    def get_fp_read_rate(self) -> float:
        return self.get_fp_reads / max(self.get_run_reads, 1)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["runs_probed_per_scan"] = self.runs_probed_per_scan
        d["scan_fp_read_rate"] = self.scan_fp_read_rate
        d["get_fp_read_rate"] = self.get_fp_read_rate
        return d

    def snapshot(self) -> dict:
        """Flat counters + derived rates."""
        return self.as_dict()

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def durable_snapshot(self) -> dict:
        """The DURABLE subset, as a store snapshot carries it."""
        return {name: int(getattr(self, name)) for name in self.DURABLE}


class Store:
    """LSM key-value store with per-run bloomRF filter blocks on ``device``
    (default ``"cuda"``)."""

    def __init__(self, config: Optional[StoreConfig] = None, device=None, *,
                 faults: Optional[FaultPlan] = None, _open_wal: bool = True,
                 **kw):
        self.cfg = config if config is not None else StoreConfig(**kw)
        self.device = resolve_device(device)
        self.mem = Memtable()
        self.levels: List[List[Run]] = [[]]   # levels[0] newest-first
        self.stats = StoreStats()
        self.faults = faults                  # fault-injection seams (tests)
        self._runs: List[Run] = []
        self._flat = None                     # stacked filter lanes (device)
        self._bases: Tuple[int, ...] = ()     # row base lanes in _flat
        self._probe = None
        self._kmins = self._kmaxs = None      # per-run fences, np.uint64 (R,)
        self._quar = None                     # per-run quarantine mask (R,)
        self._dev = None                      # lazy device fences + mask
        self._dirty = True
        self.filter_builds = 0                # flush and rebuild filter builds
        self._wal: Optional[Wal] = None
        self._seq = 0                         # checkpoint sequence number
        self._tuner = None                    # workload-adaptive tuner
        if self.cfg.tuning == "adaptive":
            from ..tune import AdaptiveTuner

            self._tuner = AdaptiveTuner(self.cfg.d, seed=self.cfg.seed)
        if _obs_metrics.enabled():            # late joiners: register_obs()
            self.register_obs()
        if self.cfg.durability == "wal" and _open_wal:
            os.makedirs(self.cfg.wal_dir, exist_ok=True)
            wal_path = os.path.join(self.cfg.wal_dir, WAL_FILENAME)
            has_state = (
                os.path.exists(os.path.join(self.cfg.wal_dir,
                                            MANIFEST_FILENAME))
                or (os.path.exists(wal_path)
                    and os.path.getsize(wal_path) > 0))
            if has_state:
                raise ValueError(
                    f"{self.cfg.wal_dir!r} already holds store state; "
                    f"use Store.open({self.cfg.wal_dir!r}) to recover it")
            self._wal = Wal(wal_path, sync=self.cfg.wal_sync).open_for_append()

    def _fault(self, point: str) -> None:
        """Pass through a named fault-injection seam (no-op without a plan)."""
        if self.faults is not None:
            self.faults.hit(point)

    def register_obs(self, family: str = "store") -> str:
        """Join the obs registry as a metric family: the registry holds a
        weak reference, so a collected store drops out of the next
        ``snapshot()``.  Returns the assigned family name (auto-suffixed
        when taken).  Called at construction when obs is already on."""
        sref = weakref.ref(self)
        return _obs_metrics.registry().register_family(
            family,
            lambda: (lambda s: None if s is None
                     else s.stats.snapshot())(sref()))

    def _codes(self, a: np.ndarray) -> torch.Tensor:
        """Host uint codes -> an int64 carrier tensor on the store's device."""
        return u64.carrier(a, self.device)

    # ------------------------------------------------------------------
    # capacity classes and filter construction
    # ------------------------------------------------------------------
    def class_capacity(self, cls: int) -> int:
        return self.cfg.memtable_limit * self.cfg.fanout ** cls

    def class_layout(self, n_keys: int):
        """Layout of the smallest capacity class that fits ``n_keys``."""
        cls = 0
        while self.class_capacity(cls) < n_keys:
            cls += 1
        return basic_layout(self.cfg.d, self.class_capacity(cls),
                            self.cfg.bits_per_key,
                            delta=min(self.cfg.delta, self.cfg.d),
                            seed=self.cfg.seed)

    def _build_filter(self, layout, keys: np.ndarray) -> torch.Tensor:
        """Bulk filter build; the compaction rebuild path lands here too.
        The insert kernel builds every layout it takes (d <= 32, one launch
        on a CUDA store, its plain version on the CPU); wider layouts take
        the plain ``BloomRF.build``."""
        self.filter_builds += 1
        f = _filter_for_layout(layout, self.device)
        kt = self._codes(keys)
        if layout.d <= 32:
            return insert_resident(layout, f.init_state(), kt)
        return f.build(kt)

    def _make_run(self, keys: np.ndarray, vals: list, tombs: np.ndarray,
                  level: int) -> Run:
        layout = self.class_layout(len(keys))
        if self._tuner is not None:
            # flushes reuse the class's standing retune decision (no
            # re-solve here) so fresh runs join the tuned layout and
            # same-class compactions keep merging with a free OR
            layout = self._tuner.cached_layout(layout) or layout
        state = alt = None
        if self.cfg.filter_backend == "bloomrf":
            state = self._build_filter(layout, keys)
        elif self.cfg.filter_backend != "none":
            alt = self._build_alt(keys)
        return Run(keys, vals, tombs, level, layout, state, alt=alt)

    def _build_alt(self, keys: np.ndarray):
        """The run's host baseline filter over ``keys`` (numpy)."""
        alt = _baseline_factory(self.cfg.filter_backend)(
            self.cfg.bits_per_key)
        alt.build(keys)
        return alt

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def _check_key(self, key: int) -> int:
        key = int(key)
        if not (0 <= key < (1 << self.cfg.d)):
            raise ValueError(f"key {key} outside the {self.cfg.d}-bit domain")
        return key

    def _wal_append(self, op: str, key, value=None) -> None:
        """Frame a record before the memtable acks (durable stores only)."""
        if self._wal is None:
            return
        self._fault("wal.append")
        self._wal.append(op, key, value)
        self.stats.wal_appends += 1

    def put(self, key: int, value) -> None:
        key = self._check_key(key)
        self._wal_append("put", key, value)
        self.mem.put(key, value)
        self.stats.puts += 1
        if len(self.mem) >= self.cfg.memtable_limit:
            self.flush()

    def delete(self, key: int) -> None:
        key = self._check_key(key)
        self._wal_append("del", key)
        self.mem.delete(key)
        self.stats.deletes += 1
        if len(self.mem) >= self.cfg.memtable_limit:
            self.flush()

    def delete_many(self, keys) -> None:
        """Batched deletes: every tombstone lands in the memtable before the
        single flush decision, so a large sweep triggers at most one flush
        (plus its compaction cascade).  One ``"delm"`` WAL frame covers the
        batch, so replay applies the whole sweep or none of it."""
        keys = [self._check_key(k) for k in keys]
        self._wal_append("delm", keys)
        for key in keys:
            self.mem.delete(key)
        self.stats.deletes += len(keys)
        if len(self.mem) >= self.cfg.memtable_limit:
            self.flush()

    def flush(self) -> None:
        """Freeze the memtable into a new level-0 run."""
        if len(self.mem) == 0:
            return
        with _obs_trace.span("store/flush", entries=len(self.mem)):
            keys, vals, tombs = self.mem.sorted_entries()
            run = self._make_run(keys, vals, tombs, 0)
            run.checksums()             # cache the build-time reference
            self._fault("flush.after_run")
            self.levels[0].insert(0, run)
            self.mem.clear()
            self.stats.flushes += 1
            self._dirty = True
        self._maybe_compact()

    # ------------------------------------------------------------------
    # compaction
    # ------------------------------------------------------------------
    def _maybe_compact(self) -> None:
        if len(self.levels[0]) > self.cfg.level0_runs:
            self.compact(0)
        lvl = 1
        while lvl < len(self.levels):
            runs = self.levels[lvl]
            if runs and len(runs[0]) > self.class_capacity(lvl):
                self.compact(lvl)
            lvl += 1

    def compact(self, level: int) -> None:
        """Merge every run at ``level`` (plus the next level's run) down.

        The merged run — keys, values, filter state and checksums — is built
        before the level lists are swapped, so a crash at the
        ``compact.before_swap`` seam leaves every source run live."""
        if level >= len(self.levels) or not self.levels[level]:
            return
        with _obs_trace.span("store/compact", level=level):
            self._compact_inner(level)

    def _compact_inner(self, level: int) -> None:
        if level + 1 >= len(self.levels):
            self.levels.append([])
        sources = self.levels[level] + self.levels[level + 1]
        bottom = not any(self.levels[lv] for lv in
                         range(level + 2, len(self.levels)))
        keys, vals, tombs = merge_sorted_runs(sources,
                                              drop_tombstones=bottom)
        if len(keys) == 0:          # everything tombstoned away
            self._fault("compact.before_swap")
            self.levels[level] = []
            self.levels[level + 1] = []
            self.stats.compactions += 1
            self._dirty = True
            return
        target_layout = self.class_layout(len(keys))
        retuned = False
        if self._tuner is not None:
            # the retune point: a class-graduating merge already pays for
            # a rebuild, so consult the solver and re-insert into the
            # tuned layout instead of the ladder's
            tuned = self._tuner.advise_layout(target_layout, len(keys))
            retuned = tuned != target_layout
            target_layout = tuned
        state = alt = None
        promotions = 0
        if self.cfg.filter_backend == "bloomrf":
            # fraction of merged entries that did not survive (shadowed
            # duplicates + dropped tombstones): the bits those entries set
            # are dead weight in an OR- or promote-merged filter
            n_in = sum(len(r) for r in sources)
            deletable = self.cfg.mutability == "deletable"
            # cap promotion depth: a promoted filter still answers at its
            # source class's resolution, so hop-on-hop promotion compounds
            # FPR; once any source has used its hops, rebuild fresh
            hops = max((r.promotions for r in sources), default=0)
            state, how = merge_filter_state(
                sources, target_layout, keys, self._build_filter,
                dead_frac=1.0 - len(keys) / n_in,
                purge_dead_frac=(self.cfg.purge_dead_frac if deletable
                                 else None),
                allow_promote=deletable
                and hops < self.cfg.promote_max_hops,
                promote_density_slack=self.cfg.promote_density_slack)
            counter = {"or": "or_merges", "promote": "promote_merges",
                       "rebuild": "rebuild_merges",
                       "purge": "purge_rebuilds"}[how]
            setattr(self.stats, counter, getattr(self.stats, counter) + 1)
            if retuned and how in ("rebuild", "purge"):
                # count only retunes that re-inserted into the tuned layout
                # here; an OR over already-tuned sources did no such work
                self.stats.retunes += 1
            promotions = {"or": hops, "promote": hops + 1}.get(how, 0)
        elif self.cfg.filter_backend != "none":
            alt = self._build_alt(keys)
            self.stats.rebuild_merges += 1
        new_run = Run(keys, vals, tombs, level + 1, target_layout, state,
                      alt=alt, promotions=promotions)
        new_run.checksums()             # checksummed before it goes live
        self._fault("compact.before_swap")
        self.levels[level] = []
        self.levels[level + 1] = [new_run]
        self.stats.compactions += 1
        self._dirty = True

    # ------------------------------------------------------------------
    # stacked filter probes
    # ------------------------------------------------------------------
    def live_runs(self) -> List[Run]:
        """All runs, newest precedence first (L0 newest-first, then down)."""
        self._refresh()
        return self._runs

    def _refresh(self) -> None:
        if not self._dirty:
            return
        self._runs = [r for lvl in self.levels for r in lvl]
        self._flat = self._probe = self._dev = None
        self._bases = ()
        self._kmins = np.asarray([r.kmin for r in self._runs], np.uint64)
        self._kmaxs = np.asarray([r.kmax for r in self._runs], np.uint64)
        self._quar = np.asarray([r.quarantined for r in self._runs], bool)
        if self._runs and self.cfg.filter_backend == "bloomrf":
            # a quarantined run may have no state at all: stack zero lanes
            # in its place; the quarantine mask forces its verdict to
            # "maybe" so the zeros are never trusted
            states = [r.state if r.state is not None
                      else torch.zeros(r.layout.total_u32, dtype=torch.int32,
                                       device=self.device)
                      for r in self._runs]
            self._flat = (states[0] if len(states) == 1
                          else torch.cat(states)).contiguous()
            sizes = [r.layout.total_u32 for r in self._runs]
            self._bases = tuple(int(b) for b in
                                np.cumsum([0] + sizes[:-1], dtype=np.int64))
            self._probe = stacked_probe(
                tuple(r.layout for r in self._runs), self._bases,
                self.device)
        self._dirty = False

    def _device_rows(self):
        """``(kmin, kmax, quarantine)`` of the live runs on the device
        (int64, int64, bool or None when no run is quarantined), built once
        per refresh."""
        if self._dev is None:
            self._dev = (self._codes(self._kmins), self._codes(self._kmaxs),
                         torch.from_numpy(self._quar).to(self.device)
                         if self._quar.any() else None)
        return self._dev

    def _fence_mask(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """(B, R) bool: query interval overlaps the run's [kmin, kmax]."""
        return ((hi[:, None] >= self._kmins[None, :])
                & (lo[:, None] <= self._kmaxs[None, :]))

    def _filter_mask(self, lo: np.ndarray, hi: np.ndarray,
                     point: bool) -> np.ndarray:
        """(B, R) bool filter verdicts (True = run may hold a match), from
        the plain ``StackedProbe`` or, for a host baseline, each run's
        ``alt`` column by column; quarantined rows answer "maybe"."""
        if self.cfg.filter_backend == "none":
            return np.ones((len(lo), len(self._runs)), bool)
        if self.cfg.filter_backend == "bloomrf":
            if point:
                v = self._probe.point_all(self._flat, self._codes(lo))
            else:
                v = self._probe.range_all(self._flat, self._codes(lo),
                                          self._codes(hi))
            out = v.cpu().numpy()
        else:
            cols = [r.alt.point(lo) if point else r.alt.range(lo, hi)
                    for r in self._runs]
            out = np.stack(cols, axis=1)
        if self._quar.any():
            out = out | self._quar[None, :]
        return out

    def probe_runs(self, lo, hi, point: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched pruning verdicts over all live runs: ``(fence, filt)``,
        each (B, R) bool.  A run is touched only where both are True."""
        self._refresh()
        lo = np.atleast_1d(np.asarray(lo, np.uint64))
        hi = lo if point else np.atleast_1d(np.asarray(hi, np.uint64))
        if not self._runs:
            z = np.zeros((len(lo), 0), bool)
            return z, z
        fence = self._fence_mask(lo, hi)
        # clamp bounds into the d-bit domain before the filter probe: the
        # clamped interval is exactly `query ∩ domain`, and queries entirely
        # above the domain are already fenced off (kmax <= dmax < lo)
        dmax = np.uint64((1 << self.cfg.d) - 1)
        filt = self._filter_mask(np.minimum(lo, dmax), np.minimum(hi, dmax),
                                 point)
        if self._quar.any():
            self.stats.degraded_probes += int(
                (fence & self._quar[None, :]).sum())
        return fence, filt

    # ------------------------------------------------------------------
    # scan-pruning plane (fence ∧ filter in one device step)
    # ------------------------------------------------------------------
    def _scan_kernel_mode(self) -> str:
        """``cfg.scan_backend`` resolved for the current run stack: the
        kernel serves bloomRF stacks of ``d <= 32`` keys, on a CUDA device
        under ``auto``."""
        if (self.cfg.scan_backend == "xla"
                or self.cfg.filter_backend != "bloomrf"
                or self.cfg.d > 32 or not self._runs):
            return "xla"
        if self.cfg.scan_backend == "kernel":
            return "kernel"
        return "kernel" if self.device.type == "cuda" else "xla"

    def _kernel_scan(self, lo: torch.Tensor, hi: torch.Tensor):
        """One store-scan kernel launch over the live stack (its plain
        version on the CPU): ``(fence, touch)``.  ``None`` after an
        injected dispatch fault under ``scan_backend="auto"`` (counted in
        ``kernel_fallbacks``), where the caller takes the plain path; any
        other error propagates."""
        try:
            self._fault("kernel.dispatch")
        except InjectedDispatchFault:
            if self.cfg.scan_backend != "auto":
                raise
            self.stats.kernel_fallbacks += 1
            return None
        kmin, kmax, quar = self._device_rows()
        return store_scan_probe_flat(
            tuple(r.layout for r in self._runs), self._bases, self._flat,
            kmin, kmax, lo, hi, quar)

    def _touch_masks(self, lo: np.ndarray,
                     hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host scan pruning: ``(fence, touch)`` (B, R) bool, with
        ``touch = fence & filter-maybe``."""
        self._refresh()
        if not self._runs:
            z = np.zeros((len(lo), 0), bool)
            return z, z
        dmax = np.uint64((1 << self.cfg.d) - 1)
        masks = None
        if self._scan_kernel_mode() == "kernel":
            masks = self._kernel_scan(self._codes(np.minimum(lo, dmax)),
                                      self._codes(np.minimum(hi, dmax)))
        if masks is not None:
            fence, touch = masks[0].cpu().numpy(), masks[1].cpu().numpy()
            # the clamp is exact for every in-domain `lo`; intervals
            # entirely above the domain are fenced off here
            dead = lo > dmax
            if dead.any():
                fence[dead] = touch[dead] = False
            if self._quar.any():
                self.stats.degraded_probes += int(
                    (fence & self._quar[None, :]).sum())
            return fence, touch
        fence, filt = self.probe_runs(lo, hi, point=False)
        return fence, fence & filt

    def scan_probe_device(self, lo: torch.Tensor, hi: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident scan pruning: ``(fence, touch)`` (B, R) bool
        tensors, no host round-trip.  ``lo``/``hi`` are int64 carriers on
        the store's device, already inside the d-bit key domain.

        One store-scan kernel launch in ``kernel`` mode; the plain
        ``StackedProbe.touch_all`` in ``xla`` mode; fence-only verdicts for
        ``filter_backend="none"``.  A host baseline has no device probe
        and raises."""
        self._refresh()
        if _obs_metrics.enabled():
            # host-side batch odometer only: the launch stays async
            _obs_metrics.registry().counter(
                "store/scan_probe_batches").add(1)
        lo, hi = torch.atleast_1d(lo), torch.atleast_1d(hi)
        if not self._runs:
            z = torch.zeros((lo.shape[0], 0), dtype=torch.bool,
                            device=self.device)
            return z, z
        if self._scan_kernel_mode() == "kernel":
            masks = self._kernel_scan(lo, hi)
            if masks is not None:
                return masks
        kmin, kmax, quar = self._device_rows()
        if self.cfg.filter_backend == "bloomrf":
            return self._probe.touch_all(self._flat, kmin, kmax, lo, hi, quar)
        if self.cfg.filter_backend == "none":
            fence = fence_mask(kmin, kmax, lo, hi)
            return fence, fence
        raise ValueError(
            f"device scan probing needs the 'bloomrf' or 'none' backend, "
            f"not {self.cfg.filter_backend!r} (host-side baseline)")

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    def get(self, key: int):
        """Point lookup; None when absent or deleted."""
        return self.get_many(np.asarray([self._check_key(key)], np.uint64))[0]

    def get_many(self, keys) -> list:
        """Batched point lookups: one gather over the flat state."""
        keys = np.atleast_1d(np.asarray(keys, np.uint64))
        if self._tuner is not None:
            self._tuner.observe_points(len(keys))
        with _obs_trace.span("store/get", batch=len(keys)):
            return self._get_many_inner(keys)

    def _get_many_inner(self, keys: np.ndarray) -> list:
        st = self.stats
        st.gets += len(keys)
        fence, filt = self.probe_runs(keys, keys, point=True)
        dbytes = np.asarray([r.data_bytes(self.cfg.value_bytes)
                             for r in self._runs], np.int64)
        out = []
        for b, key in enumerate(keys):
            found, v = self.mem.get(int(key))
            if found:
                out.append(None if v is TOMBSTONE else v)
                continue
            result = None
            st.get_runs_considered += len(self._runs)
            st.get_fence_skips += int((~fence[b]).sum())
            st.get_filter_skips += int((fence[b] & ~filt[b]).sum())
            st.bytes_not_read += int(dbytes[~(fence[b] & filt[b])].sum())
            for r_idx in np.flatnonzero(fence[b] & filt[b]):
                run = self._runs[r_idx]
                st.get_run_reads += 1
                st.bytes_read += run.data_bytes(self.cfg.value_bytes)
                hit, val, tomb = run.lookup(int(key))
                if hit:
                    result = None if tomb else val
                    break
                st.get_fp_reads += 1
            out.append(result)
        return out

    def scan(self, lo: int, hi: int) -> list:
        """All live (key, value) pairs with lo <= key <= hi, ascending."""
        return self.scan_many([lo], [hi])[0]

    def scan_many(self, los, his) -> list:
        """Batched scans: the whole pruning plane (fence + filter) in one
        device step for the batch."""
        los = np.atleast_1d(np.asarray(los, np.uint64))
        his = np.atleast_1d(np.asarray(his, np.uint64))
        if self._tuner is not None:
            # host-side workload sampling (numpy histogram + reservoir);
            # the device probe below stays untouched
            self._tuner.observe_scan(los, his)
        with _obs_trace.span("store/scan", batch=len(los)):
            fence, touch = self._touch_masks(los, his)
            return [self._scan_one(int(lo), int(hi), fence[b], touch[b])
                    for b, (lo, hi) in enumerate(zip(los, his))]

    def _scan_one(self, lo: int, hi: int, fence: np.ndarray,
                  touch: np.ndarray) -> list:
        st = self.stats
        st.scans += 1
        seen = set()
        out = {}
        for k, v in self.mem.items():
            if lo <= k <= hi:
                seen.add(k)
                if v is not TOMBSTONE:
                    out[k] = v
        st.scan_runs_considered += len(self._runs)
        st.scan_fence_skips += int((~fence).sum())
        st.scan_filter_skips += int((fence & ~touch).sum())
        for r_idx, run in enumerate(self._runs):
            if not touch[r_idx]:
                st.bytes_not_read += run.data_bytes(self.cfg.value_bytes)
                continue
            st.scan_runs_touched += 1
            st.bytes_read += run.data_bytes(self.cfg.value_bytes)
            ks, vs, tbs = run.slice(lo, hi)
            if len(ks) == 0:
                st.scan_fp_reads += 1
                continue
            for k, v, t in zip(ks, vs, tbs):
                k = int(k)
                if k in seen:
                    continue        # masked by a newer source
                seen.add(k)
                if not t:
                    out[k] = v
        return sorted(out.items())


    # ------------------------------------------------------------------
    # introspection / snapshots
    # ------------------------------------------------------------------
    @property
    def n_runs(self) -> int:
        return sum(len(lvl) for lvl in self.levels)

    def filter_bits(self) -> int:
        return sum(r.layout.total_bits for r in self.live_runs()
                   if r.state is not None)

    def quarantined_runs(self) -> List[Run]:
        """Live runs whose filter block failed its checksum."""
        return [r for r in self.live_runs() if r.quarantined]

    def snapshot(self, flush_first: bool = True) -> dict:
        """Compressed snapshot of the store's full state: host data only
        (numpy arrays and Python objects), the reference's dict field for
        field.

        By default the memtable is flushed into a level-0 run first; with
        ``flush_first=False`` only the frozen runs are snapshot, which
        warns when no WAL holds the unflushed entries."""
        if flush_first:
            self.flush()
        elif len(self.mem) and self._wal is None:
            warnings.warn(
                f"snapshot(flush_first=False) with {len(self.mem)} unflushed "
                f"memtable entries and no WAL: those writes are not in the "
                f"snapshot and will not survive a restore",
                RuntimeWarning, stacklevel=2)
        snap = {"schema": "bloomrf-store/v3",
                "config": dataclasses.asdict(self.cfg),
                "stats": self.stats.durable_snapshot(),
                "levels": [[r.pack() for r in lvl] for lvl in self.levels]}
        if self._tuner is not None:
            # the fitted workload model (bloomrf-workload/v1) rides along
            # so a reopened store resumes tuning from its sample
            snap["workload"] = self._tuner.to_dict()
        return snap

    @classmethod
    def restore(cls, snap: dict, device=None) -> "Store":
        """Validated inverse of :meth:`snapshot`, the run states placed on
        ``device`` (default ``"cuda"``).  In memory only: a durable
        config's WAL is not attached here (recover through
        :meth:`Store.open` instead).

        Malformed or corrupted input raises a ``ValueError``; a run whose
        *filter block* alone is corrupt restores quarantined."""
        if not isinstance(snap, dict):
            raise ValueError(f"store snapshot must be a dict, "
                             f"got {type(snap).__name__}")
        if snap.get("schema") not in ("bloomrf-store/v1", "bloomrf-store/v2",
                                      "bloomrf-store/v3"):
            raise ValueError(f"not a store snapshot: {snap.get('schema')!r}")
        cfg_enc = snap.get("config")
        if not isinstance(cfg_enc, dict):
            raise ValueError("store snapshot: 'config' must be a dict")
        try:
            cfg = StoreConfig(**cfg_enc)
        except (TypeError, ValueError) as e:
            raise ValueError(f"store snapshot: bad config: {e}") from e
        store = cls(cfg, device, _open_wal=False)
        levels_enc = snap.get("levels")
        if (not isinstance(levels_enc, list)
                or not all(isinstance(lvl, list) for lvl in levels_enc)):
            raise ValueError("store snapshot: 'levels' must be a list of "
                             "run lists")
        store.levels = [[Run.unpack(enc, store.device) for enc in lvl]
                        for lvl in levels_enc]
        if not store.levels:
            store.levels = [[]]
        if store.cfg.filter_backend not in ("bloomrf", "none"):
            for lvl in store.levels:     # baselines don't snapshot: rebuild
                for r in lvl:
                    r.alt = store._build_alt(r.keys)
        stats_enc = snap.get("stats")    # optional: absent in v1/v2
        if stats_enc is not None:
            if (not isinstance(stats_enc, dict)
                    or not set(stats_enc) <= set(StoreStats.DURABLE)
                    or not all(isinstance(v, int) and not isinstance(v, bool)
                               and v >= 0 for v in stats_enc.values())):
                raise ValueError(
                    "store snapshot: 'stats' must map durable counter "
                    "names to non-negative ints")
            for k, v in stats_enc.items():
                setattr(store.stats, k, v)
        wl_enc = snap.get("workload")    # optional: adaptive-tuned stores
        if wl_enc is not None:
            from ..tune import WorkloadModel

            try:
                model = WorkloadModel.from_dict(wl_enc)
            except ValueError as e:
                raise ValueError(
                    f"store snapshot: bad workload model: {e}") from e
            if store._tuner is not None:
                if model.d != store.cfg.d:
                    raise ValueError(
                        f"store snapshot: workload model d={model.d} does "
                        f"not match config d={store.cfg.d}")
                store._tuner.load(wl_enc)
        store._dirty = True
        return store

    # ------------------------------------------------------------------
    # durability: checkpoint / recovery / scrub
    # ------------------------------------------------------------------
    def checkpoint(self) -> str:
        """Make the current state durable; returns the snapshot path.

        Flush the memtable, write ``snapshot-<seq>.bin`` atomically (temp
        file + rename), publish the self-checksummed manifest naming it
        (also atomic), and only then reset the WAL and drop older
        snapshots.  A crash at any point leaves a recoverable directory:
        before the manifest rename the old checkpoint and the full WAL
        recover everything; after it, WAL replay is idempotent."""
        if self._wal is None:
            raise ValueError("checkpoint() requires durability='wal' "
                             "(open the store with a durable StoreConfig "
                             "or Store.open)")
        with _obs_trace.span("store/checkpoint"):
            self.flush()
            snap = self.snapshot(flush_first=False)
            blob = pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL)
            self._seq += 1
            name = f"snapshot-{self._seq:08d}.bin"
            path = os.path.join(self.cfg.wal_dir, name)
            atomic_write_bytes(path, blob, fault=self.faults,
                               fault_point="snapshot.before_rename")
            write_manifest(self.cfg.wal_dir,
                           {"snapshot": name, "crc32": crc32_bytes(blob),
                            "seq": self._seq},
                           fault=self.faults)
            self._wal.reset()
            self._gc_snapshots(keep=name)
            return path

    def _gc_snapshots(self, keep: str) -> None:
        """Drop superseded or orphaned snapshot files (best effort)."""
        for fn in os.listdir(self.cfg.wal_dir):
            if (fn.startswith("snapshot-") and fn.endswith(".bin")
                    and fn != keep):
                try:
                    os.unlink(os.path.join(self.cfg.wal_dir, fn))
                except OSError:
                    pass

    @classmethod
    def open(cls, wal_dir: str, config: Optional[StoreConfig] = None,
             device=None, *, faults: Optional[FaultPlan] = None) -> "Store":
        """Open (or crash-recover) the durable store rooted at ``wal_dir``
        on ``device`` (default ``"cuda"``).

        Recovery trusts nothing unverified: the manifest's own CRC, then
        the snapshot file's CRC against the manifest's record, then every
        run's component CRCs (``Run.unpack``).  After the snapshot loads,
        the WAL is healed of any torn tail and its records replay into the
        memtable.  ``config`` seeds a fresh store when no checkpoint exists
        yet (its ``durability``/``wal_dir`` are forced to this directory
        either way)."""
        manifest = read_manifest(wal_dir)    # ValueError on corruption
        if manifest is not None:
            name = manifest.get("snapshot")
            path = os.path.join(wal_dir, str(name))
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError as e:
                raise ValueError(f"manifest names snapshot {name!r} but it "
                                 f"cannot be read: {e}") from e
            if crc32_bytes(blob) != int(manifest.get("crc32", -1)):
                raise ValueError(
                    f"snapshot {name!r} fails its manifest CRC — torn write "
                    f"or bit rot; restore from a previous checkpoint")
            try:
                snap = pickle.loads(blob)
            except Exception as e:
                raise ValueError(f"snapshot {name!r} passed its CRC but "
                                 f"does not unpickle: {e}") from e
            store = cls.restore(snap, device)
            store.cfg = dataclasses.replace(store.cfg, durability="wal",
                                            wal_dir=wal_dir)
            store._seq = int(manifest.get("seq", 0))
        else:
            cfg = config if config is not None else StoreConfig(
                durability="wal", wal_dir=wal_dir)
            cfg = dataclasses.replace(cfg, durability="wal", wal_dir=wal_dir)
            store = cls(cfg, device, _open_wal=False)
        store.faults = faults
        os.makedirs(wal_dir, exist_ok=True)
        store._wal = Wal(os.path.join(wal_dir, WAL_FILENAME),
                         sync=store.cfg.wal_sync).open_for_append()
        store._replay_wal()
        return store

    def _replay_wal(self) -> None:
        """Re-apply every intact WAL record through the memtable, with the
        normal flush trigger (so replaying more than ``memtable_limit``
        records rebuilds runs as the live path did).  Replayed records
        re-enter the durable ``puts``/``deletes`` counters."""
        n = 0
        with _obs_trace.span("wal/replay"):
            for op, key, value in self._wal.replay():
                if op == "put":
                    self.mem.put(int(key), value)
                    self.stats.puts += 1
                elif op == "del":
                    self.mem.delete(int(key))
                    self.stats.deletes += 1
                else:                   # "delm": one frame, many tombstones
                    for k in key:
                        self.mem.delete(int(k))
                    self.stats.deletes += len(key)
                n += 1
                if len(self.mem) >= self.cfg.memtable_limit:
                    self.flush()
        self.stats.wal_replayed = n

    def close(self) -> None:
        """Release the WAL file handle (the store stays readable)."""
        if self._wal is not None:
            self._wal.close()

    def scrub(self, sample_keys: int = 64, seed: int = 0) -> dict:
        """Full integrity pass over every live run.

        Re-checks each run's component CRCs against its build-time
        reference: a keys/fences/values mismatch raises, a filter-block
        mismatch quarantines the run in place.  Then re-asserts the
        no-false-negative contract on up to ``sample_keys`` sampled live
        keys per run (a quarantined row trivially passes).  Returns a
        report dict."""
        with _obs_trace.span("store/scrub"):
            return self._scrub_inner(sample_keys, seed)

    def _scrub_inner(self, sample_keys: int, seed: int) -> dict:
        self._refresh()
        rng = np.random.default_rng(seed)
        newly = 0
        for r in self._runs:
            res = r.verify()
            bad = [c for c in ("keys", "fences", "vals", "tombs")
                   if not res.get(c, True)]
            if bad:
                raise ValueError(
                    f"scrub: level-{r.level} run failed {bad} checksum(s) — "
                    f"data corruption; restore from a checkpoint")
            if not res.get("filter", True) and not r.quarantined:
                r.quarantined = True
                newly += 1
                self._dirty = True
        if newly:
            self._refresh()
        report = {"runs": len(self._runs),
                  "quarantined": int(sum(r.quarantined for r in self._runs)),
                  "newly_quarantined": newly,
                  "fn_checked": 0}
        for idx, r in enumerate(self._runs):
            live = r.keys[~r.tombs]
            if len(live) == 0:
                continue
            pick = (live if len(live) <= sample_keys
                    else rng.choice(live, sample_keys, replace=False))
            fence, filt = self.probe_runs(pick, pick, point=True)
            report["fn_checked"] += len(pick)
            if not (fence[:, idx] & filt[:, idx]).all():
                raise ValueError(
                    f"scrub: filter false negative on level-{r.level} run "
                    f"{idx} — filter block corrupt beyond its checksum")
        return report
