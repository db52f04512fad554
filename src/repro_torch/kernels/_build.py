"""Build and bind the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at the first CUDA launch (never at import, so the package
imports on machines without a card or a compiler), starts one ``nvcc`` per
source at once, and writes into ``build/repro_torch/`` at the root of the
checkout (git-ignored).  A library's file name carries a hash of its
sources and flags, so an edited source is rebuilt and never mistaken for
a stale build.

Also here: the per-layout descriptor table the kernels read
(``csrc/bloomrf.cuh``), cached per layout and device, or, for the kernels
that take it as a launch parameter (insert, point probe, stacked),
per layout in host memory, padded to the parameter's fixed capacity; and
the stack descriptor of a row stack (the store-scan kernel), cached per
row stack and device.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..core.layout import FilterLayout

__all__ = ["build_all", "launch", "layout_descriptor", "device_descriptor",
           "param_descriptor", "stack_descriptor"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: each C entry point: its source ``csrc/<source>.cu`` and argument types,
#: the last of which is always the stream
_ENTRY = {
    "bloomrf_insert": ("insert", (_P, _I64, _P, _P, _P)),
    "bloomrf_point_probe": ("probe", (_P, _I64, _P, _P, _P, _P)),
    "bloomrf_store_scan": ("store_scan", (_P, _P, _I64, _P, _P, _I, _P, _P,
                                          _P, _P, _I, _P, _P, _I, _P)),
    "bloomrf_range_stacked": ("stacked", (_P, _P, _I64, _P, _I64, _I, _P, _P,
                                          _P)),
    "bloomrf_point_stacked": ("stacked", (_P, _I64, _P, _I64, _I, _P, _P,
                                          _P)),
    "bloomrf_range_partitioned": ("partitioned", (_P, _P, _I64, _P, _P, _I,
                                                  _P, _P)),
    "bloomrf_empty": ("floor", (_I, _I, _I, _I, _I, _P)),
}
SOURCES = tuple(dict.fromkeys(src for src, _ in _ENTRY.values()))

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build (sm_90a)")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    headers = sorted(CSRC.glob("*.cuh"))
    for part in ((CSRC / f"{name}.cu").read_bytes(),
                 *(p.read_bytes() for p in headers),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together; returns the seconds spent.  Each library is written
    to a temporary name and renamed into place, so a process that builds
    at the same time never loads a half-written file."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            os.unlink(tmp)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def _library(source: str):
    lib = _LIBS.get(source)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(source)))
        for fn, (src, argtypes) in _ENTRY.items():
            if src == source:
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        lib.bloomrf_error_string.argtypes = [ctypes.c_int]
        lib.bloomrf_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point ``entry`` on ``device``'s current stream
    (appended as the last argument); raises if the launch failed."""
    lib = _library(_ENTRY[entry][0])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({lib.bloomrf_error_string(rc).decode()})")


# ---------------------------------------------------------------------------
# layout descriptor (format: csrc/bloomrf.cuh, namespace bloomrf)
# ---------------------------------------------------------------------------

_HDR, _STRIDE = 8, 8
#: the descriptor rides in dynamic shared memory, below the 48 KB default
MAX_DESC_WORDS = 48 * 1024 // 4


def fastmod_magic(n: int) -> int:
    """Lemire's reciprocal of a word count ``n`` (1 <= n < 2^32) for
    ``csrc/rangeplan.cuh::fast_mod``: ``M = floor((2^64 - 1) / n) + 1``
    mod 2^64, so that ``h % n`` is the high 64 bits of ``((M * h) mod 2^64)
    * n`` for every 32-bit ``h``."""
    if not 1 <= n < 1 << 32:
        raise ValueError(f"word count {n} outside [1, 2^32)")
    return (((1 << 64) - 1) // n + 1) & ((1 << 64) - 1)


def layout_descriptor(layout: FilterLayout) -> np.ndarray:
    """The kernels' uint32 view of a layout: a header (d, k, top level,
    exact flag, exact offset, length), one record per layer (level, Δ, W,
    nwords, segment offset in bits, replicas, first seed, offset of its
    reciprocal), then every replica's seed cut to 32 bits as ``mix`` does,
    then each layer's :func:`fastmod_magic` of nwords (low word first)."""
    k = layout.k
    nseeds = sum(layout.replicas)
    seeds, layers, magic = [], [], []
    for i in range(k):
        layers += [layout.levels[i], layout.deltas[i], layout.word_bits(i),
                   layout.nwords(i),
                   layout.seg_off_bits[layout.seg_of_layer[i]],
                   layout.replicas[i], _HDR + _STRIDE * k + len(seeds),
                   _HDR + _STRIDE * k + nseeds + 2 * i]
        seeds += [int(s) & 0xFFFFFFFF
                  for s in layout.seeds[i, :layout.replicas[i]]]
        m = fastmod_magic(layout.nwords(i))
        magic += [m & 0xFFFFFFFF, m >> 32]
    n = _HDR + len(layers) + len(seeds) + len(magic)
    if n > MAX_DESC_WORDS:
        raise ValueError(f"layout descriptor of {n} words exceeds "
                         f"{MAX_DESC_WORDS}")
    header = [layout.d, k, layout.top_level, int(layout.has_exact),
              layout.exact_off_bits if layout.has_exact else 0, n, 0, 0]
    return np.asarray(header + layers + seeds + magic, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def device_descriptor(layout: FilterLayout, device: torch.device) -> torch.Tensor:
    """The layout descriptor as an int32 tensor on ``device``, built once per
    layout and device."""
    return torch.from_numpy(layout_descriptor(layout).view(np.int32)).to(device)


#: capacity in words of the descriptor launch parameter
#: (``csrc/bloomrf.cuh``: ``kParamDescWords``); every basic layout needs at
#: most 349
PARAM_DESC_WORDS = 512


@functools.lru_cache(maxsize=None)
def param_descriptor(layout: FilterLayout) -> np.ndarray:
    """The layout descriptor as a kernel's launch parameter: uint32 host
    words zero-padded to :data:`PARAM_DESC_WORDS`, built once per layout
    (each launch copies them into its parameters, so nothing is staged on
    the device).  Raises for a descriptor longer than the capacity."""
    desc = layout_descriptor(layout)
    if len(desc) > PARAM_DESC_WORDS:
        raise ValueError(f"layout descriptor of {len(desc)} words exceeds "
                         f"the {PARAM_DESC_WORDS}-word descriptor parameter")
    out = np.zeros(PARAM_DESC_WORDS, np.uint32)
    out[:len(desc)] = desc
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=8)
def stack_descriptor(layouts: tuple, bases: tuple, device: torch.device):
    """The store-scan kernel's view of a row stack, built once per row stack
    and device: ``(desc, rowtab)``.  The cache is bounded: a store scans
    only its current stack, and every flush or compaction makes a new one.

    ``desc`` concatenates the descriptors of the distinct layouts (int32 on
    ``device``; every block stages all of it in shared memory); ``rowtab``
    is ``int64[R, 2]``, per row the word offset of its layout's descriptor
    in ``desc`` and its base lane in the flat state.  The row fences and
    the quarantine mask change with the data, not the layouts, so they
    ride beside this as their own ``(R,)`` operands."""
    if len(layouts) != len(bases):
        raise ValueError(f"{len(layouts)} layouts vs {len(bases)} bases")
    distinct = list(dict.fromkeys(layouts))
    descs = [layout_descriptor(lay) for lay in distinct]
    offs = np.cumsum([0] + [len(d) for d in descs[:-1]])
    where = {lay: int(off) for lay, off in zip(distinct, offs)}
    rowtab = np.asarray([[where[lay], int(b)]
                         for lay, b in zip(layouts, bases)], np.int64)
    words = np.concatenate(descs)
    return (torch.from_numpy(words.view(np.int32)).to(device),
            torch.from_numpy(rowtab).to(device))
