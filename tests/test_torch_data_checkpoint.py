"""The port's data pipeline (``repro_torch.data``) and sharded checkpoint
(``repro_torch.train.checkpoint``) against ``repro``'s: the same corpus,
dedup keep-masks, filter states and admitted shards, the same batches; and
checkpoints in the reference's on-disk format, each package restoring
(fully and by layer range) what the other wrote."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bloomrf import BloomRF as RBloomRF
from repro.data import ShardRangeIndex as RIndex
from repro.data import StreamDeduper as RDedup
from repro.data import SyntheticCorpus as RCorpus
from repro.data import batch_iterator as rbatches
from repro.train import checkpoint as rckpt
from repro_torch.data import (ShardRangeIndex, StreamDeduper,
                              SyntheticCorpus, batch_iterator)
from repro_torch.train import (AsyncSaver, latest_step, restore_checkpoint,
                               restore_layer_range, save_checkpoint)


@pytest.fixture(autouse=True)
def _jit_reference_filters(monkeypatch):
    """The reference's filter calls of these modules under ``jax.jit``:
    one compile a call instead of one dispatch and compile a primitive
    (the same functions, the same bits)."""
    for name in ("build", "insert_online", "point", "range"):
        orig = getattr(RBloomRF, name)
        monkeypatch.setattr(RBloomRF, name, lambda self, *a, _f=orig:
                            jax.jit(functools.partial(_f, self))(*a))


def _corpus(cls):
    return cls(vocab=1000, seed=3, dup_rate=0.3, mean_len=24, n_shards=2,
               docs_per_shard=64)


def test_pipeline_matches_reference():
    ref_shards = list(_corpus(RCorpus).shards())
    port_shards = list(_corpus(SyntheticCorpus).shards())
    for a, b in zip(ref_shards, port_shards):
        np.testing.assert_array_equal(a["doc_ids"], b["doc_ids"])
        np.testing.assert_array_equal(a["timestamps"], b["timestamps"])
        assert all(np.array_equal(x, y) for x, y in zip(a["docs"],
                                                        b["docs"]))
    rd, pd = RDedup(256), StreamDeduper(256, device="cpu")
    for sh in port_shards:
        np.testing.assert_array_equal(pd.admit(sh["doc_ids"]),
                                      rd.admit(sh["doc_ids"]))
    assert pd.stats == rd.stats and pd.stats["dropped"] > 0
    np.testing.assert_array_equal(pd.state.numpy().view(np.uint32),
                                  np.asarray(rd.state))
    ri, pi = RIndex(), ShardRangeIndex(device="cpu")
    for sh in port_shards:
        ri.add_shard(sh["shard"], sh["timestamps"])
        pi.add_shard(sh["shard"], sh["timestamps"])
        np.testing.assert_array_equal(
            pi.shards[sh["shard"]][1].numpy().view(np.uint32),
            np.asarray(ri.shards[sh["shard"]][1]))
    t_end = int(port_shards[-1]["timestamps"][-1])
    w = (t_end // 2, t_end // 2 + 30)
    assert pi.shards_in_window(*w) == ri.shards_in_window(*w)
    # the dedup and the window above, the packing here
    it, rit = (batch_iterator(_corpus(SyntheticCorpus), 2, 16, device="cpu"),
               rbatches(_corpus(RCorpus), 2, 16))
    for _ in range(3):
        a, b = next(it), next(rit)
        assert a["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"])
        np.testing.assert_array_equal(a["labels"].numpy(), b["labels"])


def _tree(rng):
    return {"embed": rng.normal(0, 1, (16, 8)).astype(np.float32),
            "layers": {"w": rng.normal(0, 1, (6, 4, 4)).astype(np.float32),
                       "b": rng.integers(0, 9, (6, 4)).astype(np.int32)},
            "step": np.asarray(7, np.int64)}


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoints_restore_across_packages(tmp_path):
    tree = _tree(np.random.default_rng(5))
    jtree = {"embed": jnp.asarray(tree["embed"]),
             "layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()},
             "step": jnp.asarray(tree["step"])}
    ttree = {"embed": torch.from_numpy(tree["embed"]),
             "layers": {k: torch.from_numpy(v)
                        for k, v in tree["layers"].items()},
             "step": torch.from_numpy(tree["step"])}
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    rckpt.save_checkpoint(rdir, 3, jtree, n_shards=2)
    save_checkpoint(pdir, 3, ttree, n_shards=2, device="cpu")
    # the same files: manifest, shard arrays and filter lanes
    for name in ["manifest.json"] + [f"shard_{s:02d}.npz" for s in range(2)]:
        a, b = (tmp_path / d / "step_000003" / name for d in ("ref", "port"))
        if name.endswith(".json"):
            assert a.read_text() == b.read_text()
        else:
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for f in za.files:
                np.testing.assert_array_equal(za[f], zb[f])
                assert za[f].dtype == zb[f].dtype
    assert latest_step(pdir) == rckpt.latest_step(pdir) == 3
    # each package restores the other's checkpoint
    back = restore_checkpoint(rdir, 3, ttree)
    assert isinstance(back["layers"]["w"], torch.Tensor)
    _equal(back, tree)
    _equal(restore_checkpoint(rdir, 3, tree), tree)
    _equal(rckpt.restore_checkpoint(pdir, 3, jtree), tree)
    got = restore_layer_range(rdir, 3, 1, 2, device="cpu")
    want = rckpt.restore_layer_range(pdir, 3, 1, 2)
    assert got[1:] == want[1:] and got[1] == 2
    _equal(got[0], want[0])
    _equal(got[0], {f"layers/{k}": v[1:3] for k, v in tree["layers"].items()})
    saver = AsyncSaver(device="cpu")
    saver.save(pdir, 4, ttree, n_shards=2)
    saver.wait()
    _equal(rckpt.restore_checkpoint(pdir, 4, jtree), tree)
