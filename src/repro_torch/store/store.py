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
the filters saved.

The store lives on ``device``, ``"cuda"`` unless the caller asks for
another; without a card it raises.  With ``scan_backend="auto"`` a scan
batch is retried on the plain path only after an
:class:`~repro_torch.store.faults.InjectedDispatchFault` from the fault
seam; every other error of the kernel (a failed build or launch)
propagates.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``d > 32`` (A.1), ``mutability="deletable"`` (A.2b), the
``repro.filters`` baselines as ``filter_backend`` (A.3c),
``durability="wal"`` with snapshots, checkpoints and scrubs (A.3b),
observability (A.7) and ``tuning="adaptive"`` (A.8).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, List, Optional, Tuple

import numpy as np
import torch

from ..core.bloomrf import resolve_device
from ..core.engine import _filter_for_layout, stacked_probe
from ..core.layout import basic_layout
from ..kernels.insert import insert_resident
from ..kernels.store_scan import store_scan_probe_flat
from .compaction import merge_filter_state, merge_sorted_runs
from .faults import FaultPlan, InjectedDispatchFault
from .memtable import TOMBSTONE, Memtable
from .run import Run

__all__ = ["Store", "StoreConfig", "StoreStats"]

#: the host-side baselines of repro.filters (not ported, ROADMAP A.3c)
_BASELINES = ("bloom", "prefix_bloom", "rosetta", "surf")


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
    filter_backend: str = "bloomrf"  # "bloomrf" | "none" | repro.filters name
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
    tuning: str = "static"          # "static" | "adaptive"
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
        if self.filter_backend not in ("bloomrf", "none") + _BASELINES:
            raise ValueError(
                f"unknown filter_backend {self.filter_backend!r}")
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


def _check_ported(cfg: StoreConfig) -> None:
    """Refuse the valid configurations the port cannot run yet."""
    if cfg.d > 32:
        raise NotImplementedError(
            f"d={cfg.d} needs a 64-bit key domain (ROADMAP A.1)")
    if cfg.mutability == "deletable":
        raise NotImplementedError(
            "mutability='deletable' needs promote merges and purges, "
            "which are not ported yet (ROADMAP A.2b)")
    if cfg.tuning == "adaptive":
        raise NotImplementedError(
            "tuning='adaptive' needs the tune/ package (ROADMAP A.8)")
    if cfg.filter_backend in _BASELINES:
        raise NotImplementedError(
            f"filter_backend={cfg.filter_backend!r} needs the repro.filters "
            f"baselines (ROADMAP A.3c)")
    if cfg.durability == "wal":
        raise NotImplementedError(
            "durability='wal' needs the WAL, snapshots and the manifest "
            "(ROADMAP A.3b)")


@dataclasses.dataclass
class StoreStats:
    """Counters for what the filter blocks saved on the read path.

    The reference's fields, in the reference's order, so ``as_dict()`` of
    the same op stream is equal in both packages.  :data:`DURABLE` names
    the counters a snapshot carries (snapshots: ROADMAP A.3b)."""

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
                 faults: Optional[FaultPlan] = None, **kw):
        self.cfg = config if config is not None else StoreConfig(**kw)
        _check_ported(self.cfg)
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

    def _fault(self, point: str) -> None:
        """Pass through a named fault-injection seam (no-op without a plan)."""
        if self.faults is not None:
            self.faults.hit(point)

    def _codes(self, a: np.ndarray) -> torch.Tensor:
        """Host uint codes -> an int64 carrier tensor on the store's device."""
        return torch.from_numpy(
            np.ascontiguousarray(a, np.uint64).astype(np.int64)).to(
                self.device)

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
        state = None
        if self.cfg.filter_backend == "bloomrf":
            state = self._build_filter(layout, keys)
        return Run(keys, vals, tombs, level, layout, state)

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def _check_key(self, key: int) -> int:
        key = int(key)
        if not (0 <= key < (1 << self.cfg.d)):
            raise ValueError(f"key {key} outside the {self.cfg.d}-bit domain")
        return key

    def put(self, key: int, value) -> None:
        key = self._check_key(key)
        self.mem.put(key, value)
        self.stats.puts += 1
        if len(self.mem) >= self.cfg.memtable_limit:
            self.flush()

    def delete(self, key: int) -> None:
        key = self._check_key(key)
        self.mem.delete(key)
        self.stats.deletes += 1
        if len(self.mem) >= self.cfg.memtable_limit:
            self.flush()

    def delete_many(self, keys) -> None:
        """Batched deletes: every tombstone lands in the memtable before the
        single flush decision, so a large sweep triggers at most one flush
        (plus its compaction cascade)."""
        keys = [self._check_key(k) for k in keys]
        for key in keys:
            self.mem.delete(key)
        self.stats.deletes += len(keys)
        if len(self.mem) >= self.cfg.memtable_limit:
            self.flush()

    def flush(self) -> None:
        """Freeze the memtable into a new level-0 run."""
        if len(self.mem) == 0:
            return
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
        state = None
        if self.cfg.filter_backend == "bloomrf":
            # fraction of merged entries that did not survive (shadowed
            # duplicates + dropped tombstones)
            n_in = sum(len(r) for r in sources)
            state, how = merge_filter_state(
                sources, target_layout, keys, self._build_filter,
                dead_frac=1.0 - len(keys) / n_in)
            counter = {"or": "or_merges", "rebuild": "rebuild_merges",
                       "purge": "purge_rebuilds"}[how]
            setattr(self.stats, counter, getattr(self.stats, counter) + 1)
        new_run = Run(keys, vals, tombs, level + 1, target_layout, state)
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
        the plain ``StackedProbe``; quarantined rows answer "maybe"."""
        if self.cfg.filter_backend == "none":
            return np.ones((len(lo), len(self._runs)), bool)
        if point:
            v = self._probe.point_all(self._flat, self._codes(lo))
        else:
            v = self._probe.range_all(self._flat, self._codes(lo),
                                      self._codes(hi))
        out = v.cpu().numpy()
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
        kernel serves bloomRF stacks, on a CUDA device under ``auto``."""
        if (self.cfg.scan_backend == "xla"
                or self.cfg.filter_backend != "bloomrf" or not self._runs):
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
        ``filter_backend="none"``."""
        self._refresh()
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
        fence = (hi[:, None] >= kmin[None, :]) & (lo[:, None] <= kmax[None, :])
        return fence, fence

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    def get(self, key: int):
        """Point lookup; None when absent or deleted."""
        return self.get_many(np.asarray([self._check_key(key)], np.uint64))[0]

    def get_many(self, keys) -> list:
        """Batched point lookups: one gather over the flat state."""
        keys = np.atleast_1d(np.asarray(keys, np.uint64))
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
    # introspection
    # ------------------------------------------------------------------
    @property
    def n_runs(self) -> int:
        return sum(len(lvl) for lvl in self.levels)

    def filter_bits(self) -> int:
        return sum(r.layout.total_bits for r in self.live_runs()
                   if r.state is not None)

    def close(self) -> None:
        """Nothing to release: the port's stores keep no WAL yet."""

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------
    def snapshot(self, flush_first: bool = True) -> dict:
        raise NotImplementedError(
            "store snapshots need Run.pack (ROADMAP A.3b)")

    @classmethod
    def restore(cls, snap: dict) -> "Store":
        raise NotImplementedError(
            "store snapshots need Run.unpack (ROADMAP A.3b)")

    def checkpoint(self) -> str:
        raise NotImplementedError(
            "checkpoints need the WAL and the manifest (ROADMAP A.3b)")

    @classmethod
    def open(cls, wal_dir: str, config: Optional[StoreConfig] = None,
             **kw) -> "Store":
        raise NotImplementedError(
            "recovery needs the WAL and the manifest (ROADMAP A.3b)")

    def scrub(self, sample_keys: int = 64, seed: int = 0) -> dict:
        raise NotImplementedError(
            "scrubs come with the durability item (ROADMAP A.3b)")

    def register_obs(self, family: str = "store") -> str:
        raise NotImplementedError(
            "the metrics registry needs obs/ (ROADMAP A.7)")
