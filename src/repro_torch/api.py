"""The typed filter façade: one ``FilterSpec -> open_filter()`` front door.

Counterpart of ``repro/api.py`` for every placement and every dtype:
``u8``, ``u16``, ``u32``, ``u64`` (the default), ``f32``, ``f64``, ``str``
and ``multiattr``.  A :class:`FilterSpec` is validated
exactly as in ``repro``, so the same spec describes the same filter in both
packages.  For ``placement="store"`` :func:`open_filter` returns a
:class:`TypedStore` (the LSM store of ``store/`` behind the codecs, with
string buckets and pair bounds for ``str`` and ``multiattr`` keys, and the
workload-adaptive tuner under ``tuning="adaptive"``); for ``"single"`` a
:class:`SingleFilter` that

* routes every insert/point/range through the order-preserving codecs of
  ``core/codecs.py``;
* chooses the layout through ``core/tuning.py`` (the paper's §7 advisor) or
  the tuning-free ``basic_layout``, as ``repro`` does;
* dispatches to the CUDA kernels (``kernels/ops.py``: the resident or the
  partitioned tier by size) or to the plain engine path, which serves
  every key domain above 32 bits, as the reference's XLA path does;
* deletes keys, ages them out, and grows in place through
  ``core/dynamic.py`` (``mutability="deletable"`` / ``"ttl"``, ``grow``).

Both handles report through ``obs`` as the reference's do: ``facade/*``
spans, the workload sample of their range queries, and
``observed_fpr()``, the live false-positive rate of a known-absent
reservoir (``obs/fpr.py``).  A :class:`TypedStore` passes the store's
``mutability="deletable"`` and ``durability="wal"`` through unchanged and
checkpoints and scrubs the store.

For ``placement="bank"`` it returns a :class:`BankFilter` (the
range-partitioned shard rows of ``dist/filter_bank.py``) and for
``"tenant"`` a :class:`TenantFilter` (per-tenant banks with their meta
rows, ``dist/tenant_bank.py``, aged out under ``mutability="ttl"`` and
grown in place, by a factor advised from the sampled workload under
``tuning="adaptive"``).  On the card both build through the insert kernel
(one launch per row that owns keys of a chunk) and answer points through
the stacked point kernel (one launch per chunk over all rows); ranges
carry clipped bounds per row and take the plain ``StackedProbe``, as in
the reference.  ``backend="xla"`` keeps them on the plain path.

The filter or store lives on ``device``, which is ``"cuda"`` unless the
caller asks for another; without a card :func:`open_filter` raises rather
than quietly picking the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .core import codecs as _cd
from .core import uint64 as _u64
from .core.bloomrf import resolve_device
from .core.layout import basic_layout
from .obs import metrics as _obs_metrics
from .obs import trace as _obs_trace

__all__ = ["FilterSpec", "open_filter", "chunked_probe", "SingleFilter",
           "BankFilter", "TenantFilter", "TypedStore"]

_DTYPES = ("u8", "u16", "u32", "u64", "f32", "f64", "str", "multiattr")
_PLACEMENTS = ("single", "bank", "tenant", "store")
_BACKENDS = ("auto", "xla", "resident", "partitioned", "stacked")
_TUNINGS = ("auto", "basic", "advised", "adaptive")
_MUTABILITIES = ("insert_only", "deletable", "ttl")

#: range budget (log2) up to which the tuning-free basic layout is advised
_BASIC_RANGE_LOG2 = 14

#: domain bits and codes per key of every dtype the spec accepts
_DOMAIN = {"u8": (8, 1), "u16": (16, 1), "u32": (32, 1), "u64": (64, 1),
           "f32": (32, 1), "f64": (64, 1), "str": (64, 1),
           "multiattr": (64, 2)}


# ---------------------------------------------------------------------------
# key codecs: typed keys <-> the integer filter domain
# ---------------------------------------------------------------------------

class _Codec:
    """Order-preserving map from a typed key space into a d-bit uint domain."""

    name: str
    d: int
    codes_per_key = 1

    def encode_insert(self, keys) -> np.ndarray:
        return self.encode_point(keys)

    def encode_point(self, qs) -> np.ndarray:
        raise NotImplementedError

    def encode_bounds(self, lo, hi) -> tuple:
        return self.encode_point(lo), self.encode_point(hi)


class _UIntCodec(_Codec):
    def __init__(self, bits: int):
        self.name = f"u{bits}"
        self.d = bits

    def encode_point(self, qs) -> np.ndarray:
        arr = np.atleast_1d(np.asarray(qs, np.uint64))
        if self.d < 64 and (arr >> np.uint64(self.d)).any():
            raise ValueError(
                f"{self.name} keys must fit the {self.d}-bit domain")
        return arr


class _Float64Codec(_Codec):
    name = "f64"
    d = 64

    def encode_point(self, qs) -> np.ndarray:
        arr = np.atleast_1d(np.asarray(qs, np.float64))
        if np.isnan(arr).any():
            raise ValueError("f64 keys must not be NaN (the order-preserving "
                             "φ map has no total order for NaN)")
        return _cd.float64_to_u64(arr)

    def decode(self, code):
        return _cd.u64_to_float64(np.asarray(code, np.uint64))


class _Float32Codec(_Codec):
    name = "f32"
    d = 32

    def encode_point(self, qs) -> np.ndarray:
        arr = np.atleast_1d(np.asarray(qs, np.float32))
        if np.isnan(arr).any():
            raise ValueError("f32 keys must not be NaN (the order-preserving "
                             "φ map has no total order for NaN)")
        return _cd.float32_to_u32(arr).astype(np.uint64)

    def decode(self, code):
        return _cd.u32_to_float32(np.asarray(code, np.uint32))


class _StrCodec(_Codec):
    """SuRF-Hash-style string codes (7-byte prefix + tail hash, paper §8).

    Codes are *not* injective (two strings may share a code), so range
    probes are FN-free supersets over the 7-byte prefix order."""

    name = "str"
    d = 64

    def encode_point(self, qs) -> np.ndarray:
        if isinstance(qs, (str, bytes)):
            qs = [qs]
        return np.asarray([_cd.string_point_code(s) for s in qs], np.uint64)

    def encode_bounds(self, lo, hi) -> tuple:
        if isinstance(lo, (str, bytes)):
            lo, hi = [lo], [hi]
        pairs = [_cd.string_range_bounds(a, b) for a, b in zip(lo, hi)]
        return (np.asarray([p[0] for p in pairs], np.uint64),
                np.asarray([p[1] for p in pairs], np.uint64))


class _MultiAttrCodec(_Codec):
    """Two reduced-precision 32-bit attributes, concatenated in both orders
    (paper §8).  Keys and query bounds are ``(a, b)`` pairs; inserts set
    both the <A,B> and <B,A> codes so conjunctive predicates on either
    attribute map to one range probe."""

    name = "multiattr"
    d = 64
    codes_per_key = 2

    @staticmethod
    def _pair(key) -> tuple:
        """``(a, b)`` uint64 vectors from a scalar pair ``(a, b)``, the
        column form ``(a_vector, b_vector)`` or ``(N, 2)`` rows; the
        ambiguous 2x2 case reads as the column form."""
        arr = np.asarray(key, np.uint64)
        if arr.ndim == 1 and arr.shape[0] == 2:        # one (a, b) pair
            a, b = arr[0:1], arr[1:2]
        elif arr.ndim == 2 and arr.shape[0] == 2:      # (a_vec, b_vec)
            a, b = arr[0], arr[1]
        elif arr.ndim == 2 and arr.shape[1] == 2:      # rows of (a, b)
            a, b = arr[:, 0], arr[:, 1]
        else:
            raise ValueError(
                f"multiattr keys are (a, b) pairs, column vectors, or "
                f"(N, 2) rows; got array of shape {arr.shape}")
        if (a >> np.uint64(32)).any() or (b >> np.uint64(32)).any():
            raise ValueError("multiattr attributes must fit 32 bits")
        return a, b

    def encode_insert(self, keys) -> np.ndarray:
        ab, ba = _cd.multiattr_insert_codes(*self._pair(keys))
        return np.concatenate([ab, ba])

    def encode_point(self, qs) -> np.ndarray:
        return _cd.pack2x32(*self._pair(qs))

    def mirrored_bounds(self, b_const, a_lo, a_hi) -> tuple:
        """<B,A> code bounds for ``B == b_const AND A in [a_lo, a_hi]``."""
        return _cd.multiattr_range_for_a_eq_b_range(
            np.atleast_1d(np.asarray(b_const, np.uint64)),
            np.asarray(a_lo, np.uint64), np.asarray(a_hi, np.uint64))

    def decode(self, code):
        return _cd.unpack2x32(np.asarray(code, np.uint64))


def _codec_for(dtype: str) -> _Codec:
    if dtype in ("u8", "u16", "u32", "u64"):
        return _UIntCodec(int(dtype[1:]))
    return {"f32": _Float32Codec, "f64": _Float64Codec,
            "str": _StrCodec, "multiattr": _MultiAttrCodec}[dtype]()


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """Declarative description of a point-range filter deployment.

    The same fields and validation as ``repro.FilterSpec``.  Exactly one of
    ``bits_per_key`` / ``target_fpr`` sizes the filter (neither -> 16
    bits/key).  ``range_log2`` is the log2 of the largest range the filter is
    tuned for (the paper's R); ``tuning='auto'`` picks the tuning-free basic
    layout up to R = 2^14 and the §7 advisor above.
    """

    dtype: str = "u64"                      # u8|u16|u32|u64|f32|f64|str|multiattr
    n: int = 1 << 16                        # expected keys (per tenant if tenant)
    bits_per_key: Optional[float] = None
    target_fpr: Optional[float] = None      # range-FPR target at R=2^range_log2
    range_log2: int = _BASIC_RANGE_LOG2     # log2 of the range budget R
    placement: str = "single"               # single|bank|tenant|store
    backend: str = "auto"                   # auto|xla|resident|partitioned|stacked
    tuning: str = "auto"                    # auto|basic|advised
    shards: int = 1                         # bank/tenant: power-of-two shard rows
    tenants: int = 1                        # tenant: tenant rows
    delta: Optional[int] = None             # layer distance override (1..7)
    point_weight: float = 1.0               # advisor's point-vs-range weight
    chunk: int = 1 << 18                    # host-side probe chunking
    seed: int = 0x0B100F11
    mutability: str = "insert_only"         # insert_only|deletable|ttl
    generations: int = 4                    # ttl: retained TTL windows (>= 2)
    store_backend: str = "bloomrf"
    memtable_limit: int = 4096
    fanout: int = 4
    level0_runs: int = 4
    purge_dead_frac: float = 0.25
    durability: str = "none"                # store: "none" | "wal"
    wal_dir: Optional[str] = None

    def __post_init__(self):
        def bad(msg):
            raise ValueError(f"FilterSpec: {msg}")

        if self.dtype not in _DTYPES:
            bad(f"dtype must be one of {_DTYPES}, got {self.dtype!r}")
        if self.placement not in _PLACEMENTS:
            bad(f"placement must be one of {_PLACEMENTS}, "
                f"got {self.placement!r}")
        if self.backend not in _BACKENDS:
            bad(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self.tuning not in _TUNINGS:
            bad(f"tuning must be one of {_TUNINGS}, got {self.tuning!r}")
        if self.n < 1:
            bad(f"n must be >= 1, got {self.n}")
        if self.bits_per_key is not None and self.target_fpr is not None:
            bad("give bits_per_key OR target_fpr, not both")
        if self.bits_per_key is not None and self.bits_per_key <= 0:
            bad(f"bits_per_key must be > 0, got {self.bits_per_key}")
        if self.target_fpr is not None and not (0 < self.target_fpr < 1):
            bad(f"target_fpr must be in (0, 1), got {self.target_fpr}")
        d = _DOMAIN[self.dtype][0]
        if not (0 <= self.range_log2 <= d):
            bad(f"range_log2 must be in [0, {d}] for {self.dtype} keys, "
                f"got {self.range_log2}")
        if self.delta is not None and not (1 <= self.delta <= 7):
            bad(f"delta must be in 1..7, got {self.delta}")
        if self.shards < 1 or self.shards & (self.shards - 1):
            bad(f"shards must be a power of two, got {self.shards}")
        if self.tenants < 1:
            bad(f"tenants must be >= 1, got {self.tenants}")
        if self.chunk < 1:
            bad(f"chunk must be >= 1, got {self.chunk}")
        if self.backend in ("resident", "partitioned") \
                and self.placement != "single":
            bad(f"backend={self.backend!r} is a single-filter kernel "
                f"dispatch; {self.placement!r} placements always probe "
                f"through the stacked engine")
        if self.backend == "stacked" and self.placement == "single":
            bad("backend='stacked' needs a multi-row placement "
                "(bank/tenant/store)")
        if self.tuning == "advised" and self.placement != "single":
            bad("tuning='advised' builds exact-bitmap layouts, which only "
                "the single placement's engine path can probe (the stacked "
                "plan and the kernels are hashed-layout only)")
        if self.tuning == "adaptive" \
                and self.placement not in ("store", "tenant"):
            bad("tuning='adaptive' fits a workload model from live scans; "
                "only the store placement (retune at compaction) and the "
                "tenant placement (retune on promote) sample one")
        if self.mutability not in _MUTABILITIES:
            bad(f"mutability must be one of {_MUTABILITIES}, "
                f"got {self.mutability!r}")
        if self.mutability == "deletable" \
                and self.placement not in ("single", "store"):
            bad("mutability='deletable' needs counting lanes (single) or "
                "compaction purges (store); bank/tenant placements age out "
                "keys with mutability='ttl' instead")
        if self.mutability == "ttl" \
                and self.placement not in ("single", "tenant"):
            bad("mutability='ttl' keeps generation lanes on the resident "
                "state (single/tenant); the store expires via tombstones "
                "plus mutability='deletable' compaction purges")
        if self.generations < 2:
            bad(f"generations must be >= 2 (current + retiring), "
                f"got {self.generations}")
        if not (0.0 < self.purge_dead_frac <= 1.0):
            bad(f"purge_dead_frac must be in (0, 1], "
                f"got {self.purge_dead_frac}")
        if self.durability not in ("none", "wal"):
            bad(f"durability must be 'none' or 'wal', "
                f"got {self.durability!r}")
        if self.durability == "wal" and self.placement != "store":
            bad("durability='wal' is a store placement feature (resident "
                "filters rebuild from their source of truth instead)")
        if self.durability == "wal" and not self.wal_dir:
            bad("durability='wal' requires wal_dir")

    # -- derived sizing ---------------------------------------------------
    def resolved_bits_per_key(self) -> float:
        """bits/key from the explicit knob or the §6 model's FPR target."""
        if self.bits_per_key is not None:
            return float(self.bits_per_key)
        if self.target_fpr is None:
            return 16.0
        from .core.model import basic_range_fpr

        d, codes_per_key = _DOMAIN[self.dtype]
        n = self.n * codes_per_key
        R = 2.0 ** self.range_log2
        delta = self.delta if self.delta is not None else 7
        for bpk in range(6, 41):
            if basic_range_fpr(d, n, bpk * n, R, delta=delta) \
                    <= self.target_fpr:
                return float(bpk)
        raise ValueError(
            f"FilterSpec: no bits_per_key <= 40 reaches target_fpr="
            f"{self.target_fpr} at R=2^{self.range_log2}; relax the target "
            f"or size with bits_per_key explicitly")

    def describe(self) -> str:
        bpk = self.resolved_bits_per_key()
        return (f"FilterSpec({self.dtype}, n={self.n}, {bpk:g} b/key, "
                f"R=2^{self.range_log2}, {self.placement}/{self.backend}"
                + (f", shards={self.shards}" if self.shards > 1 else "")
                + (f", tenants={self.tenants}" if self.tenants > 1 else "")
                + ")")


# ---------------------------------------------------------------------------
# shared probe plumbing
# ---------------------------------------------------------------------------

def _codes_tensor(codes: np.ndarray, device) -> torch.Tensor:
    """uint codes (held in uint64) -> an int64 carrier tensor on device."""
    return _u64.carrier(codes, device)


def chunked_probe(fn, state, arrays, device, chunk: int) -> np.ndarray:
    """Drive a probe over host code arrays in fixed-size chunks on
    ``device``; returns the verdicts as a numpy bool array."""
    outs = []
    B = len(arrays[0])
    for s in range(0, B, chunk):
        args = [_codes_tensor(a[s:s + chunk], device) for a in arrays]
        outs.append(fn(state, *args).cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros(0, bool)


def _lanes_tensor(lanes, shape: tuple, device) -> torch.Tensor:
    """Host ``uint32`` lanes of ``shape`` (e.g. a ``repro`` handle's
    ``np.asarray(handle.state)``) as an int32 tensor on ``device``."""
    lanes = np.asarray(lanes)
    if lanes.dtype != np.uint32 or lanes.shape != tuple(shape):
        raise ValueError(
            f"state must be uint32{list(shape)}, got "
            f"{lanes.dtype}{list(lanes.shape)}")
    return torch.from_numpy(lanes.view(np.int32).copy()).to(device)


def _lanes_numpy(state: torch.Tensor) -> np.ndarray:
    """A host copy of int32 lanes as ``uint32``."""
    return state.cpu().numpy().view(np.uint32).copy()


def _plan_layout(spec: FilterSpec, codec: _Codec):
    """Layout selection: tuning-free basic vs the §7 advisor."""
    from .core.tuning import advise

    n_codes = max(spec.n * codec.codes_per_key, 1)
    bpk = spec.resolved_bits_per_key()
    tuning = spec.tuning
    if tuning == "auto":
        tuning = "basic" if spec.range_log2 <= _BASIC_RANGE_LOG2 \
            else "advised"
    if tuning == "basic":
        delta = spec.delta if spec.delta is not None else min(7, codec.d)
        return basic_layout(codec.d, n_codes, bpk, delta=delta,
                            seed=spec.seed), "basic"
    return advise(codec.d, n_codes, int(n_codes * bpk),
                  R=2.0 ** spec.range_log2, point_weight=spec.point_weight,
                  seed=spec.seed).layout, "advised"


class _Observed:
    """The observability surface every handle shares: a lazy known-absent
    reservoir over the codec's domain, the range workload sample, and the
    ``obs/fpr/*`` gauges."""

    _fpr = None                 # lazy known-absent reservoir (obs/fpr.py)

    def _fpr_sampler(self, **kw):
        """This handle's known-absent reservoir, built on first use."""
        if self._fpr is None:
            from .obs.fpr import FprSampler

            self._fpr = FprSampler(self.codec.d,
                                   seed=self.spec.seed ^ 0xB10F, **kw)
        return self._fpr

    def _observe_ranges(self, clo, chi) -> None:
        """Feed the workload sampler (range-length distribution) when the
        obs plane is on; one boolean check otherwise."""
        if _obs_metrics.enabled():
            self._fpr_sampler().observe_ranges(clo, chi)

    def _require_multiattr(self) -> None:
        if self.codec.name != "multiattr":
            raise TypeError(
                f"conjunctive-predicate probes need dtype='multiattr', "
                f"this filter holds {self.codec.name} keys")

    def _record_fpr(self, out: dict) -> dict:
        """Publish an ``observed_fpr()`` result to the registry gauges."""
        reg = _obs_metrics.registry()
        if "range_fpr" in out:
            reg.gauge("obs/fpr/observed").set(out["range_fpr"])
        if "point_fpr" in out:
            reg.gauge("obs/fpr/point").set(out["point_fpr"])
        reg.gauge("obs/fpr/range_candidates").set(
            out.get("range_candidates", 0))
        return out


class SingleFilter(_Observed):
    """One bloomRF on one device: the CUDA kernels or the plain engine path.

    ``backend='auto'`` uses the kernels on a CUDA device wherever they
    apply (hashed layout, d <= 32) and the engine path otherwise (on the
    filter's device, CUDA included); the
    kernels' tier (resident or partitioned) follows the filter's size, as
    in ``repro``.  ``resident`` and ``partitioned`` force a tier (exact
    layouts' range queries still take the engine path); ``xla`` forces the
    plain engine path, on whatever device the filter lives on.

    ``mutability='deletable'`` keeps host counting lanes beside the state
    (:meth:`delete`); ``'ttl'`` keeps ``spec.generations`` generation
    states and probes their OR (:meth:`advance_generation`).  :meth:`grow`
    promotes any of them in place to a larger layout.
    """

    def __init__(self, spec: FilterSpec, codec: _Codec, device):
        from .core.dynamic import CountingLanes, Generations

        self.spec = spec
        self.codec = codec
        self.device = torch.device(device)
        layout, self.tuning = _plan_layout(spec, codec)
        backend = spec.backend
        if backend == "auto":
            backend = "kernels" if (self.device.type == "cuda"
                                    and codec.d <= 32
                                    and not layout.has_exact) else "xla"
        self.backend = backend
        self._bind_layout(layout)
        self.counts = None      # deletable: per-bit reference counters
        self.gens = None        # ttl: generation lanes
        self._state = self.filter.init_state()
        if spec.mutability == "deletable":
            self.counts = CountingLanes(layout.total_bits)
        elif spec.mutability == "ttl":
            self.gens = Generations(self.filter.init_state, spec.generations)

    def _bind_layout(self, layout) -> None:
        """(Re)build the filter and the kernel dispatch for ``layout``:
        shared by ``__init__`` and :meth:`grow`."""
        from .core.bloomrf import BloomRF
        from .kernels.ops import FilterOps

        self.layout = layout
        self.filter = BloomRF(layout, device=self.device)
        if self.backend == "xla":
            self.ops = None
            self._insert = self.filter.insert
            self._point = self.filter.point
            self._range = self.filter.range
        else:
            budget = (max(layout.total_u32, 1) if self.backend == "resident"
                      else 0 if self.backend == "partitioned" else None)
            self.ops = FilterOps(layout, vmem_budget_u32=budget)
            self._insert = self.ops.insert
            self._point = self.ops.point
            self._range = self.ops.range

    # -- state --------------------------------------------------------------
    @property
    def state(self) -> torch.Tensor:
        """The probed ``int32[total_u32]`` lanes (uint32 bits) on device:
        a TTL filter's is the OR of its generations."""
        return self.gens.collapsed if self.gens is not None else self._state

    def _lanes(self, lanes) -> torch.Tensor:
        return _lanes_tensor(lanes, (self.layout.total_u32,), self.device)

    def load_state(self, lanes=None, counts=None, generations=None,
                   current: int = 0) -> None:
        """Replace the state with ``uint32[total_u32]`` lanes, e.g. a
        ``repro`` filter's ``np.asarray(handle.state)`` for the same spec.

        A deletable filter also takes its ``uint8[total_bits]`` counters
        (``handle.counts.counts``).  A TTL filter takes its generation
        states instead of ``lanes`` (``[np.asarray(g) for g in
        handle.gens.gens]``) and the index of the ``current`` one."""
        from .core.dynamic import CountingLanes, Generations

        if (counts is not None) != (self.counts is not None):
            raise ValueError("counts go with mutability='deletable' and "
                             "only with it")
        if (generations is not None) != (self.gens is not None) \
                or (self.gens is not None and lanes is not None):
            raise ValueError("a TTL filter loads its generations (and no "
                             "lanes); other filters load lanes")
        if self.gens is not None:
            if len(generations) != self.gens.n_generations \
                    or not 0 <= current < len(generations):
                raise ValueError(
                    f"{len(generations)} generations (current {current}) "
                    f"for a filter of {self.gens.n_generations}")
            gens = Generations(self.filter.init_state, len(generations))
            gens.gens = [self._lanes(g) for g in generations]
            gens.current = current
            self.gens = gens
            return
        state = self._lanes(lanes)
        if counts is not None:
            self.counts = CountingLanes(self.layout.total_bits, counts=counts)
        self._state = state

    def state_numpy(self) -> np.ndarray:
        """A host copy of the probed state as ``uint32[total_u32]`` lanes."""
        return _lanes_numpy(self.state)

    # -- mutation -----------------------------------------------------------
    def _chunks(self, codes):
        for s in range(0, len(codes), self.spec.chunk):
            yield _codes_tensor(codes[s:s + self.spec.chunk], self.device)

    def _positions(self, cj: torch.Tensor) -> np.ndarray:
        return self.filter.positions(cj).cpu().numpy()

    def insert(self, keys) -> None:
        codes = self.codec.encode_insert(keys)
        if _obs_metrics.enabled():
            self._fpr_sampler().observe_insert(codes)
        with _obs_trace.span("facade/insert", n=len(codes)):
            for cj in self._chunks(codes):
                if self.gens is not None:
                    self.gens.insert(self._insert, cj)
                else:
                    self._state = self._insert(self._state, cj)
                if self.counts is not None:
                    self.counts.add(self._positions(cj))

    def delete(self, keys) -> None:
        """Remove previously inserted keys (``mutability='deletable'``).

        Decrements the counting lanes; bits whose counters drain to zero
        are cleared, so deleted keys stop costing false positives (up to
        counter saturation).  Deleting keys never inserted is a contract
        violation, as with any counting Bloom filter."""
        from .core.dynamic import clear_bits

        if self.counts is None:
            raise ValueError(
                "delete() needs FilterSpec(mutability='deletable')")
        for cj in self._chunks(self.codec.encode_insert(keys)):
            zeroed = self.counts.remove(self._positions(cj))
            self._state = clear_bits(self._state, zeroed)

    def advance_generation(self) -> None:
        """Close the current TTL window (``mutability='ttl'``): the oldest
        generation's keys stop costing false positives; keys not
        re-inserted within ``spec.generations`` windows expire."""
        if self.gens is None:
            raise ValueError(
                "advance_generation() needs FilterSpec(mutability='ttl')")
        self.gens.advance()

    def grow(self, factor: int = 4) -> None:
        """In-place capacity promotion (``core/dynamic.py``): segment-tile
        the state onto a ``factor``-times larger layout with no key
        re-hashing, and re-bind the kernel dispatch to it (a filter that
        outgrows the resident budget moves to the partitioned tier).
        Every inserted key keeps probing positive."""
        from .core.dynamic import promote_layout, promote_state

        old = self.layout
        new = promote_layout(old, factor)
        self._bind_layout(new)
        if self.gens is not None:
            self.gens = self.gens.map(
                lambda st: promote_state(st, old, new),
                zero_fn=self.filter.init_state)
        else:
            self._state = promote_state(self._state, old, new)
        if self.counts is not None:
            self.counts = self.counts.promoted(old, new)
        self.spec = dataclasses.replace(self.spec, n=self.spec.n * factor)

    # -- probes -------------------------------------------------------------
    def point(self, qs) -> np.ndarray:
        codes = self.codec.encode_point(qs)
        with _obs_trace.span("facade/point", n=len(codes)):
            return chunked_probe(self._point, self.state, [codes],
                                 self.device, self.spec.chunk)

    def range(self, lo, hi) -> np.ndarray:
        clo, chi = self.codec.encode_bounds(lo, hi)
        self._observe_ranges(clo, chi)
        with _obs_trace.span("facade/range", n=len(clo)):
            return chunked_probe(self._range, self.state, [clo, chi],
                                 self.device, self.spec.chunk)

    def observed_fpr(self) -> dict:
        """Re-probe the known-absent reservoir -> live observed FPR.

        Candidates are invalidated from the insert stream observed while
        observability was enabled, so enable obs before the first insert
        for an exact reservoir.  Publishes the ``obs/fpr/*`` gauges."""
        s = self._fpr_sampler()
        return self._record_fpr(s.sample(
            point_probe=lambda ks: chunked_probe(
                self._point, self.state, [ks], self.device, self.spec.chunk),
            range_probe=lambda lo, hi: chunked_probe(
                self._range, self.state, [lo, hi], self.device,
                self.spec.chunk)))

    def range_where_b(self, b_const, a_lo, a_hi) -> np.ndarray:
        """Multiattr: ``B == b_const AND A in [a_lo, a_hi]`` via <B,A>
        codes."""
        self._require_multiattr()
        clo, chi = self.codec.mirrored_bounds(b_const, a_lo, a_hi)
        return chunked_probe(self._range, self.state, [clo, chi],
                             self.device, self.spec.chunk)

    def size_bits(self) -> int:
        return self.layout.total_bits


class BankFilter(_Observed):
    """Range-partitioned shard rows (``dist/filter_bank.py``).

    On a CUDA device the rows build through the insert kernel (one launch
    per row that owns keys of a chunk) and the point probes of a chunk are
    one stacked point-kernel launch over all rows, where the shard layout
    takes the kernels (``d_local <= 32``); ranges, wider domains,
    ``backend="xla"`` and the CPU take the plain ``StackedProbe``."""

    def __init__(self, spec: FilterSpec, codec: _Codec, device):
        from .dist.filter_bank import FilterBank

        self.spec = spec
        self.codec = codec
        delta = spec.delta if spec.delta is not None else 6
        self.bank = FilterBank(codec.d, spec.shards,
                               max(spec.n * codec.codes_per_key, 1),
                               spec.resolved_bits_per_key(), delta=delta,
                               seed=spec.seed, device=device,
                               use_kernels=spec.backend != "xla",
                               _warn=False)
        self.state = self.bank.init_state()

    @property
    def device(self) -> torch.device:
        return self.bank.device

    def load_state(self, lanes) -> None:
        """Replace the state with ``uint32[shards, total_u32]`` lanes, e.g.
        a ``repro`` bank's ``np.asarray(handle.state)`` for the same spec."""
        self.state = _lanes_tensor(
            lanes, (self.bank.n_shards, self.bank.layout.total_u32),
            self.device)

    def state_numpy(self) -> np.ndarray:
        """A host copy of the state as ``uint32[shards, total_u32]``."""
        return _lanes_numpy(self.state)

    def insert(self, keys) -> None:
        codes = self.codec.encode_insert(keys)
        if _obs_metrics.enabled():
            self._fpr_sampler().observe_insert(codes)
        with _obs_trace.span("facade/insert", n=len(codes)):
            for s in range(0, len(codes), self.spec.chunk):
                self.state = self.bank.insert(
                    self.state, _codes_tensor(codes[s:s + self.spec.chunk],
                                              self.device))

    def _probe(self, fn, arrays) -> np.ndarray:
        return chunked_probe(fn, self.state, arrays, self.device,
                             self.spec.chunk)

    def point(self, qs) -> np.ndarray:
        codes = self.codec.encode_point(qs)
        with _obs_trace.span("facade/point", n=len(codes)):
            return self._probe(self.bank.point, [codes])

    def range(self, lo, hi) -> np.ndarray:
        clo, chi = self.codec.encode_bounds(lo, hi)
        self._observe_ranges(clo, chi)
        with _obs_trace.span("facade/range", n=len(clo)):
            return self._probe(self.bank.range, [clo, chi])

    def observed_fpr(self) -> dict:
        """Live observed FPR over the whole bank (see
        :meth:`SingleFilter.observed_fpr`)."""
        return self._record_fpr(self._fpr_sampler().sample(
            point_probe=lambda ks: self._probe(self.bank.point, [ks]),
            range_probe=lambda lo, hi: self._probe(self.bank.range,
                                                   [lo, hi])))

    def range_where_b(self, b_const, a_lo, a_hi) -> np.ndarray:
        """Multiattr: ``B == b_const AND A in [a_lo, a_hi]`` via <B,A>
        codes."""
        self._require_multiattr()
        clo, chi = self.codec.mirrored_bounds(b_const, a_lo, a_hi)
        return self._probe(self.bank.range, [clo, chi])

    def size_bits(self) -> int:
        return self.bank.size_bits()


class TenantFilter(_Observed):
    """Per-tenant banks with their Bloofi-style meta rows
    (``dist/tenant_bank.py``).

    Every probe takes a ``tenants`` vector (or one tenant) beside the typed
    keys; range probes AND the meta verdict in by default (fewer false
    positives, never a false negative).  The kernels serve it as they
    serve :class:`BankFilter`: the main and meta rows build through the
    insert kernel, points through one stacked point-kernel launch per
    chunk, ranges through the plain ``StackedProbe``."""

    #: tenants tracked with their own known-absent reservoir; per-tenant
    #: FPR telemetry over every tenant would cost O(tenants) probes per
    #: sample, so only the first few observed tenants are followed
    _MAX_FPR_TENANTS = 8

    def __init__(self, spec: FilterSpec, codec: _Codec, device):
        from .dist.tenant_bank import TenantFilterBank

        self.spec = spec
        self.codec = codec
        delta = spec.delta if spec.delta is not None else 6
        self.bank = TenantFilterBank(
            codec.d, spec.tenants, spec.shards,
            max(spec.n * codec.codes_per_key, 1),
            spec.resolved_bits_per_key(), delta=delta, seed=spec.seed,
            device=device, use_kernels=spec.backend != "xla", _warn=False)
        self.aging = None       # ttl: generation lanes over (state, meta)
        self._fpr_tenants: dict = {}    # per-tenant reservoirs (first <= 8)
        self._wl_sampler = None         # adaptive: live scan-bounds sample
        self._promote_events: list = []  # adaptive: advised promotions
        if spec.tuning == "adaptive":
            from .obs.fpr import FprSampler

            self._wl_sampler = FprSampler(codec.d, seed=spec.seed ^ 0xAD47)
        self._state = self.bank.init_state()
        self._meta = self.bank.init_meta()
        if spec.mutability == "ttl":
            from .dist.tenant_bank import AgingTenantBank

            self.aging = AgingTenantBank(self.bank, spec.generations)

    @property
    def device(self) -> torch.device:
        return self.bank.device

    # -- state (TTL filters probe the OR of their generations) -------------
    @property
    def state(self) -> torch.Tensor:
        return self.aging.gens.collapsed[0] if self.aging is not None \
            else self._state

    @property
    def meta(self) -> torch.Tensor:
        return self.aging.gens.collapsed[1] if self.aging is not None \
            else self._meta

    def load_state(self, state=None, meta=None, generations=None,
                   current: int = 0) -> None:
        """Replace the state with ``uint32[tenants, shards, total_u32]``
        lanes and the meta rows with ``uint32[tenants, shards,
        meta_total_u32]``, e.g. a ``repro`` handle's ``np.asarray(h._state)``
        and ``np.asarray(h._meta)``.  A TTL filter takes its generations
        instead (``[(state, meta), ...]``, a ``repro`` handle's
        ``h.gens.gens``) and the index of the ``current`` one."""
        from .dist.tenant_bank import AgingTenantBank

        bank = self.bank
        shape = (bank.n_tenants, bank.n_shards)
        main = shape + (bank.bank.layout.total_u32,)
        mshape = shape + (bank.meta_layout.total_u32,)
        if (generations is not None) != (self.aging is not None) \
                or (generations is not None
                    and (state is not None or meta is not None)):
            raise ValueError("a TTL filter loads its generations (and no "
                             "state or meta); other filters load both")
        if self.aging is None:
            self._state = _lanes_tensor(state, main, self.device)
            self._meta = _lanes_tensor(meta, mshape, self.device)
            return
        if len(generations) != self.aging.n_generations \
                or not 0 <= current < len(generations):
            raise ValueError(
                f"{len(generations)} generations (current {current}) for "
                f"a filter of {self.aging.n_generations}")
        gens = [(_lanes_tensor(s, main, self.device),
                 _lanes_tensor(m, mshape, self.device))
                for s, m in generations]
        self.aging = AgingTenantBank(bank, len(gens))
        self.aging.gens.gens, self.aging.gens.current = gens, current

    def state_numpy(self) -> np.ndarray:
        """Host copy of the probed state, ``uint32[tenants, shards,
        total_u32]``."""
        return _lanes_numpy(self.state)

    def meta_numpy(self) -> np.ndarray:
        """Host copy of the probed meta rows."""
        return _lanes_numpy(self.meta)

    def _tiled_tenants(self, tenants, n_codes: int) -> np.ndarray:
        """Tenant ids aligned 1:1 with the encoded codes: a scalar tenant
        broadcasts over the batch, and multiattr's dual codes repeat the
        whole vector (codes are [ab..., ba...])."""
        t = np.atleast_1d(np.asarray(tenants, np.uint32))
        reps = n_codes // max(len(t), 1)
        t = np.tile(t, reps) if reps > 1 else t
        if len(t) != n_codes:
            raise ValueError(
                f"tenants ({len(t)} after broadcast) do not align with "
                f"{n_codes} encoded keys")
        return t

    def _tenant_sampler(self, tid: int):
        s = self._fpr_tenants.get(tid)
        if s is None and len(self._fpr_tenants) < self._MAX_FPR_TENANTS:
            from .obs.fpr import FprSampler

            s = self._fpr_tenants[tid] = FprSampler(
                self.codec.d, seed=(self.spec.seed ^ 0xB10F) + tid)
        return s

    def _probe(self, fn, arrays) -> np.ndarray:
        """``fn(state, tenants, codes...)`` over the probed state, chunk by
        chunk; ``arrays`` starts with the tenant vector."""
        return chunked_probe(fn, self.state, arrays, self.device,
                             self.spec.chunk)

    def insert(self, tenants, keys) -> None:
        codes = self.codec.encode_insert(keys)
        t = self._tiled_tenants(tenants, len(codes))
        if _obs_metrics.enabled():
            for tid in np.unique(t):
                s = self._tenant_sampler(int(tid))
                if s is not None:
                    s.observe_insert(codes[t == tid])
        for s in range(0, len(codes), self.spec.chunk):
            tj, cj = (_codes_tensor(a[s:s + self.spec.chunk], self.device)
                      for a in (t, codes))
            if self.aging is not None:
                self.aging.insert(tj, cj)
            else:
                self._state = self.bank.insert(self._state, tj, cj)
                self._meta = self.bank.insert_meta(self._meta, tj, cj)

    def advance_generation(self) -> None:
        """Close the current TTL window (``mutability='ttl'``): tenants'
        cold keys expire after ``spec.generations`` windows without a
        re-insert and stop costing false positives, with no sweeps."""
        if self.aging is None:
            raise ValueError(
                "advance_generation() needs FilterSpec(mutability='ttl')")
        self.aging.advance()

    def grow(self, factor: Optional[int] = None) -> None:
        """In-place capacity promotion of every tenant row, the meta rows
        and every TTL generation: segment tiling, no key re-hashed.

        With ``FilterSpec(tuning='adaptive')`` and ``factor=None`` the
        factor is advised from the sampled workload
        (``TenantFilterBank.advise_promotion``); without a sample, or with
        static tuning, it is 4."""
        if factor is None:
            factor = 4
            if (self._wl_sampler is not None
                    and self._wl_sampler.workload_seen):
                from .tune import fit_workload

                wl = fit_workload(self.codec.d, sampler=self._wl_sampler)
                factor, reports = self.bank.advise_promotion(wl)
                self._promote_events.append({
                    "factor": factor,
                    "workload_seen": self._wl_sampler.workload_seen,
                    "reports": {f: r.as_dict() for f, r in reports.items()},
                })
        if self.aging is not None:
            self.aging = self.aging.promoted(factor)
            self.bank = self.aging.bank
        else:
            self.bank, self._state, self._meta = self.bank.promote(
                self._state, self._meta, factor)
        self.spec = dataclasses.replace(self.spec, n=self.spec.n * factor)

    def point(self, tenants, qs) -> np.ndarray:
        codes = self.codec.encode_point(qs)
        t = self._tiled_tenants(tenants, len(codes))
        with _obs_trace.span("facade/point", n=len(codes)):
            return self._probe(self.bank.point, [t, codes])

    def range(self, tenants, lo, hi, use_meta: bool = True) -> np.ndarray:
        clo, chi = self.codec.encode_bounds(lo, hi)
        t = self._tiled_tenants(tenants, len(clo))
        self._observe_ranges(clo, chi)
        if self._wl_sampler is not None:
            # adaptive tuning samples regardless of the obs-plane flag
            self._wl_sampler.observe_ranges(clo, chi)
        meta = self.meta if use_meta else None
        record_skips = _obs_metrics.enabled() and use_meta

        def probe(state, tj, lj, hj):
            if record_skips:
                # device scalars; they settle at the registry's snapshot,
                # never here
                self.bank.record_meta_skips(meta, tj, lj, hj)
            return self.bank.range(state, tj, lj, hj, meta)

        with _obs_trace.span("facade/range", n=len(clo)):
            return self._probe(probe, [t, clo, chi])

    def observed_fpr(self) -> dict:
        """Per-tenant live observed FPR for every tracked tenant.

        Tenants join the tracked set on their first ``insert`` while
        observability is enabled (at most ``_MAX_FPR_TENANTS``).  Returns
        ``{tenant_id: sample_dict}`` and publishes ``obs/fpr/tenant/<id>``
        gauges."""
        reg = _obs_metrics.registry()
        out = {}

        def ranges(state, tj, lj, hj):
            return self.bank.range(state, tj, lj, hj, self.meta)

        for tid, s in sorted(self._fpr_tenants.items()):
            def tids(n, tid=tid):
                return np.full(n, tid, np.uint32)

            r = s.sample(
                point_probe=lambda ks: self._probe(
                    self.bank.point, [tids(len(ks)), ks]),
                range_probe=lambda lo, hi: self._probe(
                    ranges, [tids(len(lo)), lo, hi]))
            out[tid] = r
            if "range_fpr" in r:
                reg.gauge(f"obs/fpr/tenant/{tid}").set(r["range_fpr"])
        return out

    def retune_report(self) -> dict:
        """Workload sample and advised promotions (``tuning='adaptive'``)."""
        if self._wl_sampler is None:
            return {"tuning": self.spec.tuning, "promotions": []}
        from .tune import fit_workload

        return {"tuning": "adaptive",
                "workload_seen": self._wl_sampler.workload_seen,
                "promotions": list(self._promote_events),
                "workload": fit_workload(
                    self.codec.d, sampler=self._wl_sampler).to_dict()}

    def size_bits(self) -> int:
        return self.bank.size_bits()


class TypedStore(_Observed):
    """The LSM run-store behind the codec boundary: typed put/get/scan.

    Integer and float keys are bijective codes, so scans decode back to the
    caller's key type exactly.  String codes are lossy (7-byte prefix + tail
    hash), so the store keeps a per-code *bucket* ``{key: value}`` and
    post-filters scans by true string order: collisions cost one bucket,
    never a lost key.  Multi-attribute keys are <A,B> concatenations;
    ``scan`` takes ``(a, b)`` pair bounds, so ``A == a AND B in [b_lo,
    b_hi]`` is ``scan((a, b_lo), (a, b_hi))``.

    The store runs its scans through the store-scan kernel on a CUDA device
    (``scan_backend="auto"``, d <= 32), or through the plain
    ``StackedProbe`` at d > 32 (``u64``, ``f64``, ``str``, ``multiattr``)
    or when ``spec.backend == "xla"``, as in ``repro``."""

    def __init__(self, spec: FilterSpec, codec: _Codec, device):
        from .store.store import Store, StoreConfig

        self.spec = spec
        self.codec = codec
        delta = spec.delta if spec.delta is not None else 6
        self.store = Store(StoreConfig(
            d=codec.d, memtable_limit=spec.memtable_limit,
            bits_per_key=spec.resolved_bits_per_key(),
            delta=min(delta, codec.d), fanout=spec.fanout,
            level0_runs=spec.level0_runs,
            filter_backend=spec.store_backend,
            # spec.backend='xla' pins the plain StackedProbe scan plane; any
            # other backend lets the store pick the store-scan kernel
            scan_backend="xla" if spec.backend == "xla" else "auto",
            seed=spec.seed,
            mutability=spec.mutability,
            purge_dead_frac=spec.purge_dead_frac,
            durability=spec.durability,
            wal_dir=spec.wal_dir,
            tuning="adaptive" if spec.tuning == "adaptive" else "static"),
            device=device)
        self._buckets = codec.name == "str"

    @property
    def device(self) -> torch.device:
        return self.store.device

    # -- write path -------------------------------------------------------
    def _code1(self, key) -> int:
        return int(self.codec.encode_point(key)[0])

    def put(self, key, value) -> None:
        code = self._code1(key)
        with _obs_trace.span("facade/put"):
            if self._buckets:
                bucket = dict(self.store.get(code) or {})
                bucket[key] = value
                self.store.put(code, bucket)
            else:
                self.store.put(code, value)

    def delete(self, key) -> None:
        code = self._code1(key)
        if self._buckets:
            bucket = dict(self.store.get(code) or {})
            bucket.pop(key, None)
            if bucket:
                self.store.put(code, bucket)
            else:
                self.store.delete(code)
        else:
            self.store.delete(code)

    def delete_many(self, keys) -> None:
        """Batched deletes: one memtable-flush decision for the batch
        (string buckets need a read-modify-write per key instead)."""
        if self._buckets:
            for k in keys:
                self.delete(k)
            return
        self.store.delete_many(self.codec.encode_point(keys))

    def flush(self) -> None:
        self.store.flush()

    # -- durability (FilterSpec(durability='wal', wal_dir=...)) -----------
    def checkpoint(self) -> str:
        """Publish a durable checkpoint (snapshot + manifest, WAL reset);
        see ``Store.checkpoint``.  Returns the snapshot path."""
        return self.store.checkpoint()

    def scrub(self, sample_keys: int = 64, seed: int = 0) -> dict:
        """Integrity pass over every live run (``Store.scrub``)."""
        return self.store.scrub(sample_keys=sample_keys, seed=seed)

    def close(self) -> None:
        """Release the WAL file handle (the store stays readable)."""
        self.store.close()

    # -- read path --------------------------------------------------------
    def get(self, key):
        code = self._code1(key)
        with _obs_trace.span("facade/get"):
            if self._buckets:
                bucket = self.store.get(code)
                return None if bucket is None else bucket.get(key)
            return self.store.get(code)

    def get_many(self, keys) -> list:
        if self._buckets:
            return [self.get(k) for k in keys]
        codes = self.codec.encode_point(keys)
        with _obs_trace.span("facade/get", batch=len(codes)):
            return self.store.get_many(codes)

    def scan(self, lo, hi) -> list:
        return self.scan_many([lo], [hi])[0]

    def scan_many(self, los, his) -> list:
        """Batched typed scans: one pruning step for the batch."""
        if self._buckets:
            clo, chi = self.codec.encode_bounds(los, his)
            self._observe_ranges(clo, chi)
            with _obs_trace.span("facade/scan", batch=len(clo)):
                raw = self.store.scan_many(clo, chi)
            # typed bounds ride along: buckets post-filter by string order
            return [self._decode_scan(rows, lo, hi)
                    for rows, lo, hi in zip(raw, los, his)]
        clo, chi = self.codec.encode_bounds(np.asarray(los), np.asarray(his))
        self._observe_ranges(clo, chi)
        # iterate the encoded bounds, not the caller's container: multiattr
        # column-form bounds are a (2, B) array whose first axis is (a, b)
        with _obs_trace.span("facade/scan", batch=len(clo)):
            raw = self.store.scan_many(clo, chi)
        return [self._decode_scan(rows, None, None) for rows in raw]

    def _decode_scan(self, rows: list, lo, hi) -> list:
        if self._buckets:
            out = []
            for _, bucket in rows:
                out.extend((k, v) for k, v in bucket.items() if lo <= k <= hi)
            return sorted(out)
        if self.codec.name == "multiattr":
            return [((int(a), int(b)), v) for (a, b), v in
                    ((self.codec.decode(np.uint64(c)), v) for c, v in rows)]
        if self.codec.name in ("f32", "f64"):
            return [(float(self.codec.decode(np.uint64(c))), v)
                    for c, v in rows]
        return rows

    # -- device-resident probe plane ----------------------------------------
    def encode_scan_bounds(self, los, his):
        """Typed scan bounds -> int64 carrier tensors of their codes on the
        store's device (the operands :meth:`scan_probe_device` takes)."""
        clo, chi = self.codec.encode_bounds(np.asarray(los), np.asarray(his))
        return (_codes_tensor(clo, self.device),
                _codes_tensor(chi, self.device))

    def scan_probe_device(self, clo, chi):
        """Device-resident scan pruning over encoded bounds: ``(fence,
        touch)`` (B, R) bool tensors, no host round-trip.  Verdicts are at
        code level (for lossy string codes a touched run may still
        post-filter to empty)."""
        return self.store.scan_probe_device(clo, chi)

    # -- introspection ----------------------------------------------------
    @property
    def stats(self):
        return self.store.stats

    @property
    def n_runs(self) -> int:
        return self.store.n_runs

    def size_bits(self) -> int:
        return self.store.filter_bits()

    def retune_report(self) -> dict:
        """What the adaptive tuner has seen and done.

        For ``tuning='adaptive'``: the retune counter (compaction rebuilds
        that landed in a tuner-advised layout), the solver's event log, the
        fitted ``bloomrf-workload/v1`` model, per-class standing decisions,
        and a model-vs-live cross-check for the largest live run's layout.
        Static stores report ``{'tuning': 'static', ...}``."""
        tuner = self.store._tuner
        if tuner is None:
            return {"tuning": self.spec.tuning, "retunes": 0, "events": []}
        out = {"tuning": "adaptive",
               "retunes": int(self.store.stats.retunes)}
        out.update(tuner.report())
        runs = self.store.live_runs()
        if runs:
            big = max(runs, key=len)
            out["cross_check"] = tuner.cross_check(big.layout, len(big))
        return out

    # -- observability ----------------------------------------------------
    def register_obs(self, family: str = "store") -> str:
        """Register the store's :class:`StoreStats` as a metric family."""
        return self.store.register_obs(family)

    def observed_fpr(self) -> dict:
        """Live observed FPR from ground truth.

        Reservoir candidates still present in the store are eliminated at
        sample time against the live key set, and the survivors re-probe
        through the run filters; any ``fence & filter`` positive is a
        certain false positive.  Returns aggregate point/range FPR plus
        per-run range rates, and publishes the ``obs/fpr/*`` gauges."""
        from .store.memtable import TOMBSTONE

        store = self.store
        s = self._fpr_sampler()
        present = [np.asarray([k for k, v in store.mem.items()
                               if v is not TOMBSTONE], np.uint64)]
        present += [r.keys[~r.tombs] for r in store.live_runs()]
        s.mark_present(np.concatenate(present))
        klive = s.live_points()
        rlo, rhi = s.live_ranges()
        out = {"point_candidates": int(klive.size),
               "range_candidates": int(rlo.size),
               "workload_seen": s.workload_seen}
        if klive.size:
            fence, filt = store.probe_runs(klive, klive, point=True)
            out["point_fpr"] = float((fence & filt).any(axis=1).mean())
        if rlo.size:
            fence, filt = store.probe_runs(rlo, rhi)
            pos = fence & filt
            out["range_fpr"] = float(pos.any(axis=1).mean())
            out["range_fpr_per_run"] = [float(x) for x in pos.mean(axis=0)]
        if store._tuner is not None:
            # the live sample is the cost model's cross-check input
            store._tuner.record_observed(out)
        return self._record_fpr(out)


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------

_PLACEMENT_HANDLES = {"single": SingleFilter, "bank": BankFilter,
                      "tenant": TenantFilter, "store": TypedStore}


def open_filter(spec: FilterSpec, device=None):
    """Build the filter deployment described by ``spec`` on ``device``
    (default ``"cuda"``; raises when no card is present): a
    :class:`SingleFilter`, :class:`BankFilter`, :class:`TenantFilter` or
    :class:`TypedStore` according to ``spec.placement``."""
    if not isinstance(spec, FilterSpec):
        raise TypeError(f"open_filter takes a FilterSpec, got {type(spec)}")
    return _PLACEMENT_HANDLES[spec.placement](spec, _codec_for(spec.dtype),
                                              resolve_device(device))
