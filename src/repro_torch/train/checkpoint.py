"""Sharded checkpointing with a bloomRF layer-range index per shard.

Counterpart of ``repro/train/checkpoint.py``, with the same files on disk,
so either package restores a checkpoint the other wrote:

    step_000123/
      manifest.json         -- leaf paths, shapes, dtypes, shard assignment,
                               bloomRF layout of each shard's filter
      shard_00.npz ...      -- stacked-layer leaves split by layer ranges
                               (non-layer leaves live in shard 0), and the
                               shard filter's uint32 lanes (``__bloomrf__``)

A tree is a nested dict (or list / tuple) of torch tensors, numpy arrays
or scalars; a leaf's path joins its keys and indices with ``/``, as the
reference's pytree paths do.  Every (layer, leaf) stored in a shard is
keyed ``ordinal << 7 | layer`` into that shard's bloomRF.  An elastic
restart that needs only a layer range asks each shard's filter one range
query per layered leaf, ``[ord << 7 | lo, ord << 7 | hi]``, and loads only
the shards that answer "maybe" (no false negatives: restores are always
complete).  The filters run through ``kernels/ops.py``'s ``FilterOps``:
the kernels on a CUDA device, their plain versions on the CPU.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from ..core import uint64 as u64
from ..core.bloomrf import resolve_device
from ..core.layout import basic_layout
from ..kernels.ops import FilterOps

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_layer_range",
           "latest_step", "AsyncSaver"]

_SEP = "/"


def _walk(tree, path=()):
    """(path, leaf) pairs in the reference's pytree order: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {k: _host(v) for k, v in _walk(tree)}


def _is_layer_leaf(key: str, arr) -> bool:
    return "layers" in key and arr.ndim >= 1 and arr.shape[0] > 1


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:06d}")


def _zeros(lay, device) -> torch.Tensor:
    return torch.zeros(lay.total_u32, dtype=torch.int32, device=device)


def save_checkpoint(ckpt_dir: str, step: int, tree, n_shards: int = 4,
                    device=None) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``ckpt_dir`` (the shard
    filters built on ``device``, default ``"cuda"``); returns its
    directory."""
    device = resolve_device(device)
    flat = _flatten(tree)
    keys = sorted(flat)
    n_layers = max((flat[k].shape[0] for k in keys
                    if _is_layer_leaf(k, flat[k])), default=1)
    n_shards = max(1, min(n_shards, n_layers))
    bounds = np.linspace(0, n_layers, n_shards + 1).astype(int)

    sdir = _step_dir(ckpt_dir, step)
    os.makedirs(sdir + ".tmp", exist_ok=True)
    shard_files: dict = {s: {} for s in range(n_shards)}
    shard_keys: dict = {s: [] for s in range(n_shards)}  # filter keys
    manifest = {"step": step, "n_shards": n_shards, "n_layers": int(n_layers),
                "leaves": {}, "bounds": bounds.tolist()}

    for ordinal, k in enumerate(keys):
        arr = flat[k]
        manifest["leaves"][k] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype),
            "ordinal": ordinal, "layered": _is_layer_leaf(k, arr)}
        if _is_layer_leaf(k, arr):
            for s in range(n_shards):
                lo, hi = bounds[s], bounds[s + 1]
                if hi > lo:
                    shard_files[s][k] = arr[lo:hi]
                    shard_keys[s].extend(
                        (ordinal << 7) | int(ly) for ly in range(lo, hi))
        else:
            shard_files[0][k] = arr
            shard_keys[0].append(ordinal << 7)  # layer 0 pseudo-key

    # the filter domain is sized to the actual key span (clustered keys in
    # an oversized domain saturate the upper dyadic levels, paper §7)
    max_key = max((max(v) for v in shard_keys.values() if v), default=1)
    dom = max(8, int(max_key).bit_length() + 1)
    filt_meta = []
    for s in range(n_shards):
        nkeys = max(len(shard_keys[s]), 1)
        lay = basic_layout(dom, nkeys, bits_per_key=20.0, delta=3)
        state = FilterOps(lay).insert(_zeros(lay, device), u64.carrier(
            shard_keys[s] or [0], device))
        shard_files[s]["__bloomrf__"] = state.cpu().numpy().view(np.uint32)
        filt_meta.append({"n_keys": nkeys, "bits_per_key": 20.0, "delta": 3,
                          "domain_bits": dom})
    manifest["filters"] = filt_meta

    for s in range(n_shards):
        np.savez(os.path.join(sdir + ".tmp", f"shard_{s:02d}.npz"),
                 **shard_files[s])
    with open(os.path.join(sdir + ".tmp", "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.exists(sdir):
        shutil.rmtree(sdir)
    os.rename(sdir + ".tmp", sdir)
    return sdir


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _load_manifest(ckpt_dir: str, step: int):
    sdir = _step_dir(ckpt_dir, step)
    with open(os.path.join(sdir, "manifest.json")) as fh:
        return sdir, json.load(fh)


def _shard_filter(sdir, manifest, s, device):
    meta = manifest["filters"][s]
    lay = basic_layout(meta.get("domain_bits", 32), meta["n_keys"],
                       meta["bits_per_key"], delta=meta["delta"])
    data = np.load(os.path.join(sdir, f"shard_{s:02d}.npz"))
    lanes = np.ascontiguousarray(data["__bloomrf__"]).view(np.int32)
    return FilterOps(lay), torch.from_numpy(lanes.copy()).to(device), data


def _like(template, arr: np.ndarray):
    """``arr`` in the form of the ``like`` tree's leaf: a tensor on the
    leaf's device, or a numpy array."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(template.device)
    return np.array(arr)


def _unflatten(like, values: dict, path=()):
    if isinstance(like, dict):
        return {k: _unflatten(v, values, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, values, path + (str(i),))
               for i, v in enumerate(like)]
        return type(like)(out)
    return _like(like, values[_SEP.join(path)])


def restore_checkpoint(ckpt_dir: str, step: int, like):
    """Full restore, reassembling the layer shards into the structure of
    ``like`` (each leaf a tensor on the like-leaf's device, or a numpy
    array)."""
    sdir, manifest = _load_manifest(ckpt_dir, step)
    shards = [np.load(os.path.join(sdir, f"shard_{s:02d}.npz"))
              for s in range(manifest["n_shards"])]
    out = {}
    for k, meta in manifest["leaves"].items():
        if meta["layered"]:
            parts = [sh[k] for sh in shards if k in sh.files]
            out[k] = np.concatenate(parts, axis=0)
        else:
            out[k] = shards[0][k]
    keys = [k for k, _ in _walk(like)]
    if sorted(keys) != sorted(out):
        raise ValueError("checkpoint/restore tree mismatch")
    return _unflatten(like, out)


def restore_layer_range(ckpt_dir: str, step: int, lo_layer: int,
                        hi_layer: int, device=None):
    """Elastic partial restore: one range query a layered leaf ordinal,
    ``[ord << 7 | lo, ord << 7 | hi]``, against each shard's bloomRF (on
    ``device``, default ``"cuda"``); only matching shards are loaded.
    Returns (flat dict of layer-sliced arrays, shards probed, shards
    loaded)."""
    device = resolve_device(device)
    sdir, manifest = _load_manifest(ckpt_dir, step)
    ordinals = [m["ordinal"] for m in manifest["leaves"].values()
                if m["layered"]]
    los = u64.carrier([(o << 7) | lo_layer for o in ordinals], device)
    his = u64.carrier([(o << 7) | hi_layer for o in ordinals], device)
    picked, probed = [], 0
    for s in range(manifest["n_shards"]):
        ops, state, data = _shard_filter(sdir, manifest, s, device)
        probed += 1
        if len(ordinals) and bool(ops.range(state, los, his).any()):
            picked.append((s, data))
    out = {}
    bounds = manifest["bounds"]
    for k, meta in manifest["leaves"].items():
        if not meta["layered"]:
            continue
        parts = []
        for s, data in picked:
            if k not in data.files:
                continue
            base = bounds[s]
            arr = data[k]
            a = max(lo_layer - base, 0)
            b = min(hi_layer + 1 - base, arr.shape[0])
            if b > a:
                parts.append(arr[a:b])
        if parts:
            out[k] = np.concatenate(parts, axis=0)
    return out, probed, len(picked)


class AsyncSaver:
    """Overlap checkpoint serialization with training: the device-to-host
    copy on the caller's thread, the file I/O in the background (read the
    result of a save with :meth:`wait`, which re-raises its error)."""

    def __init__(self, device=None):
        self.device = device
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, ckpt_dir: str, step: int, tree, n_shards: int = 4):
        # a flat {path: array} dict saves as the tree it came from
        host_tree = _flatten(tree)
        self.wait()

        def run():
            try:
                save_checkpoint(ckpt_dir, step, host_tree, n_shards,
                                device=self.device)
            except BaseException as e:   # handed to wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

