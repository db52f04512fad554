"""The LSM store's scan-pruning plane in one CUDA kernel: ``csrc/store_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/store_scan.py::
store_scan_probe``.  For a batch of scans and a stack of run filters it
computes, per (scan, run) cell, the fence overlap and ``touch = fence &
(filter verdict | quarantine)``: the runs whose data blocks the scan must
read.  One launch per scan batch, whatever the mix of layouts.

The TPU kernel needs a padded ``(R, rowpad)`` stack.  The CUDA kernel reads
each row at its own base lane, so it takes either

* :func:`store_scan_probe`: the reference's padded stack
  (:func:`build_run_stack`), row ``r`` at lane ``r * rowpad``; or
* :func:`store_scan_probe_flat`: the flat state the store already
  concatenates for ``StackedProbe``, with the rows' base lanes.

On CPU tensors both take the plain version, ``StackedProbe._touch_all``.
Rows must share one key domain ``d <= 32`` and have no exact segment.  The
store's capacity-class ladder and the adaptive tuner's candidates
(``tune/solver.py``: hashed single-segment layouts) satisfy both; a tuned
row may have up to ``d`` layers and a replicated top layer, which the
kernel takes in more than one round of its four lanes.
"""
from __future__ import annotations

import torch

from ..core.engine import stacked_probe
from . import _build
from ._checks import check_keys
from .rangeprobe import _check_bounds, _check_range_kernel_layout

__all__ = ["store_scan_probe", "store_scan_probe_flat", "build_run_stack",
           "DEFAULT_TILE", "SCAN_THREADS", "SCAN_LANES", "scan_smem_bytes"]

#: the reference's default query tile; accepted by :func:`store_scan_probe`
#: and unused (every launch runs blocks of ``SCAN_THREADS`` threads)
DEFAULT_TILE = 256
#: threads per block of the kernel, ``SCAN_LANES`` of them per (scan, row)
#: cell (``csrc/store_scan.cu``)
SCAN_THREADS = 128
SCAN_LANES = 4
#: shared memory one block may hold on Hopper (bytes)
_MAX_SMEM = 232_448


def scan_smem_bytes(desc_words: int) -> int:
    """Shared memory of one block: a 32-byte record per staged row slot (one
    per thread) and the whole stack descriptor (``csrc/store_scan.cu``)."""
    return 32 * SCAN_THREADS + 4 * desc_words


def build_run_stack(states) -> torch.Tensor:
    """Pad per-run ``int32`` filter states to one ``(R, rowpad)`` stack.

    Zero padding is safe: padded lanes lie past every row's addressable
    lanes, so no planned read lands in them."""
    rowpad = max(int(s.shape[0]) for s in states)
    return torch.stack([torch.nn.functional.pad(s, (0, rowpad - s.shape[0]))
                        for s in states])


def _check_rows(layouts: tuple, bases: tuple, lanes: int) -> None:
    if not layouts:
        raise ValueError("need at least one run row")
    if len(bases) != len(layouts):
        raise ValueError(f"{len(layouts)} layouts vs {len(bases)} bases")
    d = layouts[0].d
    for lay, base in zip(layouts, bases):
        _check_range_kernel_layout(lay)
        if lay.d != d:
            raise ValueError("store-scan rows must share one key domain")
        if base < 0 or base + lay.total_u32 > lanes:
            raise ValueError(f"a row of {lay.total_u32} lanes at base {base} "
                             f"overruns the {lanes}-lane state")


def store_scan_probe_flat(layouts: tuple, bases: tuple, flat: torch.Tensor,
                          kmin: torch.Tensor, kmax: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor,
                          quarantine: torch.Tensor | None = None):
    """``(fence, touch)``, both ``bool[B, R]``, over run rows of ``flat``
    (``int32`` lanes; row ``r`` starts at lane ``bases[r]``).

    ``kmin``/``kmax`` are the rows' key fences and ``lo``/``hi`` the scan
    bounds, all int64 carriers of uint32 codes, the bounds already clamped
    into the ``d``-bit domain.  ``quarantine`` (optional ``bool[R]``) forces
    a row's filter verdict to "maybe"."""
    layouts, bases = tuple(layouts), tuple(int(b) for b in bases)
    if flat.dtype != torch.int32 or flat.dim() != 1 \
            or not flat.is_contiguous():
        raise ValueError(f"flat state must be a contiguous 1-d int32 tensor, "
                         f"got {flat.dtype}{list(flat.shape)}")
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bloomRF kernel for device {flat.device}")
    _check_rows(layouts, bases, flat.shape[0])
    _check_bounds(lo, hi, flat.device)
    check_keys("kmin", kmin, flat.device)
    check_keys("kmax", kmax, flat.device)
    R = len(layouts)
    if kmin.shape != (R,) or kmax.shape != (R,):
        raise ValueError(f"fences must be ({R},), got {list(kmin.shape)}, "
                         f"{list(kmax.shape)}")
    if quarantine is not None:
        if quarantine.dtype != torch.bool or quarantine.shape != (R,) \
                or quarantine.device != flat.device:
            raise ValueError(f"quarantine must be bool[{R}] on "
                             f"{flat.device}")
        quarantine = quarantine.contiguous()
    if flat.device.type == "cpu":
        probe = stacked_probe(layouts, bases, flat.device)
        return probe.touch_all(flat, kmin, kmax, lo, hi, quarantine)
    B = lo.shape[0]
    fence = torch.empty((B, R), dtype=torch.bool, device=flat.device)
    touch = torch.empty_like(fence)
    if B:
        if B * R >= 1 << 31:
            raise ValueError(f"{B} scans x {R} runs exceed the int32 cell "
                             f"index; scan in smaller batches")
        desc, rowtab = _build.stack_descriptor(layouts, bases, flat.device)
        if scan_smem_bytes(desc.numel()) > _MAX_SMEM:
            raise ValueError(f"a stack descriptor of {desc.numel()} words "
                             f"does not fit a block's shared memory")
        _build.launch("bloomrf_store_scan", flat.device, lo.data_ptr(),
                      hi.data_ptr(), B, flat.data_ptr(), desc.data_ptr(),
                      desc.numel(), rowtab.data_ptr(), kmin.data_ptr(),
                      kmax.data_ptr(),
                      None if quarantine is None else quarantine.data_ptr(),
                      R, fence.data_ptr(), touch.data_ptr(), SCAN_THREADS)
        store_scan_probe.launches += 1
    return fence, touch


def store_scan_probe(layouts: tuple, stack: torch.Tensor, kmin, kmax, lo, hi,
                     tile: int = DEFAULT_TILE, runs_per_block: int = 0,
                     quarantine: torch.Tensor | None = None):
    """Fused store-scan pruning over a padded ``int32[R, rowpad]`` stack
    (:func:`build_run_stack`): ``(fence, touch)``, both ``bool[B, R]``.

    The reference's signature.  ``tile`` and ``runs_per_block`` sized the
    TPU's VMEM blocks; here every block answers ``SCAN_THREADS //
    SCAN_LANES`` cells, so both are accepted and have no effect on the
    result."""
    if runs_per_block < 0:
        raise ValueError(f"runs_per_block must be >= 0, got {runs_per_block}")
    if stack.dim() != 2 or stack.shape[0] != len(layouts):
        raise ValueError(f"stack must be ({len(layouts)}, rowpad), "
                         f"got {list(stack.shape)}")
    rowpad = int(stack.shape[1])
    for lay in layouts:
        if lay.total_u32 > rowpad:
            raise ValueError(f"stack rowpad {rowpad} < layout lanes "
                             f"{lay.total_u32}")
    bases = tuple(r * rowpad for r in range(len(layouts)))
    return store_scan_probe_flat(layouts, bases, stack.reshape(-1), kmin,
                                 kmax, lo, hi, quarantine)


#: kernel launches so far, from either entry (a plain count; reset it by
#: assignment)
store_scan_probe.launches = 0
