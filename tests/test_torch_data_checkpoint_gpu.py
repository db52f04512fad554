"""The data pipeline's filters and the checkpoint on a card, held to the
same sequence on the CPU: the stream deduper's keep masks, stats and
state, the shard range index's states and windows, a checkpoint saved on
the card (the same files as one saved on the CPU) and its layer-range
restore.  On the card they run the insert, point and range kernels
through ``FilterOps``.  Marked ``gpu``: they skip where no CUDA device is
present.  This file imports neither ``jax`` nor ``repro``."""
import numpy as np
import pytest
import torch

from repro_torch.data import ShardRangeIndex, StreamDeduper, SyntheticCorpus
from repro_torch.kernels import (insert_resident, point_probe_partitioned,
                                 point_probe_resident,
                                 range_probe_partitioned,
                                 range_probe_resident)
from repro_torch.train import restore_layer_range, save_checkpoint

pytestmark = pytest.mark.gpu

_KERNELS = (insert_resident, point_probe_resident, point_probe_partitioned,
            range_probe_resident, range_probe_partitioned)


@pytest.fixture
def cuda():
    """The card; decided here, never at import, so every pytest-xdist
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches():
    for fn in _KERNELS:
        fn.launches = 0
    return lambda: [fn.launches for fn in _KERNELS]


def test_pipeline_filters_equal_cpu_run(cuda):
    shards = list(SyntheticCorpus(vocab=500, seed=3, n_shards=6,
                                  docs_per_shard=96).shards())
    read = _launches()
    dd, hd = StreamDeduper(512, device=cuda), StreamDeduper(512,
                                                            device="cpu")
    for sh in shards:
        np.testing.assert_array_equal(dd.admit(sh["doc_ids"]),
                                      hd.admit(sh["doc_ids"]))
    assert dd.stats == hd.stats and dd.stats["dropped"] > 0
    assert torch.equal(dd.state.cpu(), hd.state)
    di, hi = ShardRangeIndex(device=cuda), ShardRangeIndex(device="cpu")
    for sh in shards:
        for idx in (di, hi):
            idx.add_shard(sh["shard"], sh["timestamps"])
        assert torch.equal(di.shards[sh["shard"]][1].cpu(),
                           hi.shards[sh["shard"]][1])
    t_end = int(shards[-1]["timestamps"][-1])
    for w in ((0, 40), (t_end // 2, t_end // 2 + 30), (t_end, 1 << 31)):
        assert di.shards_in_window(*w) == hi.shards_in_window(*w)
    ins, pr, pp, rr, rp = read()
    assert ins > 0 and pr + pp > 0 and rr + rp > 0


def test_checkpoint_on_card_equals_cpu(cuda, tmp_path):
    rng = np.random.default_rng(5)
    tree = {"embed": torch.from_numpy(
                rng.normal(0, 1, (16, 8)).astype(np.float32)).to(cuda),
            "layers": {"w": torch.from_numpy(rng.normal(
                0, 1, (6, 4, 4)).astype(np.float32)).to(cuda)}}
    read = _launches()
    gdir, hdir = str(tmp_path / "gpu"), str(tmp_path / "cpu")
    save_checkpoint(gdir, 1, tree, n_shards=2)
    assert read()[0] > 0
    save_checkpoint(hdir, 1, {"embed": tree["embed"].cpu(),
                              "layers": {"w": tree["layers"]["w"].cpu()}},
                    n_shards=2, device="cpu")
    for name in ["manifest.json", "shard_00.npz", "shard_01.npz"]:
        a, b = (tmp_path / d / "step_000001" / name for d in ("gpu", "cpu"))
        if name.endswith(".json"):
            assert a.read_text() == b.read_text()
        else:
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for f in za.files:
                np.testing.assert_array_equal(za[f], zb[f])
    _launches()
    got = restore_layer_range(gdir, 1, 1, 3)
    want = restore_layer_range(hdir, 1, 1, 3, device="cpu")
    assert got[1:] == want[1:]
    assert sorted(got[0]) == sorted(want[0])
    for k in got[0]:
        np.testing.assert_array_equal(np.asarray(got[0][k]),
                                      np.asarray(want[0][k]))
    assert sum(read()[3:]) > 0
