"""The port's range-partitioned filter bank (``repro_torch.dist.
filter_bank``) against ``repro.dist.filter_bank`` on the same seeded keys:
the state bit for bit, point and range verdicts exactly, at d = 16 and 24
over 1, 2 and 4 shards (ranges across shards and the domain's edges) and
one d = 40 bank on the plain 64-bit path; ``ShardedFilterBank`` on a
``torch.distributed`` world of 1 in this process, and both sharded classes
on a spawned gloo world of 2 (a replica axis of 2 included) held to the
unsharded bank.  Each reference bank is built once per module."""
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist

from conftest import brute_force_range_truth
from repro.dist.filter_bank import FilterBank as RBank
from repro_torch import dist as tdist
from repro_torch._compat import LegacyAPIWarning
from repro_torch.core import FilterLayout
from repro_torch.core import uint64 as u64
from repro_torch.dist import FilterBank, ShardedFilterBank

_SRC = Path(__file__).resolve().parent.parent / "src"
_CASES = {"d16_s4": (16, 4), "d24_s1": (24, 1), "d40_s2": (40, 2)}
_N = 600


def _inputs(d, S, seed):
    """Keys, points (half present) and ranges of every length class,
    ranges that span shards, and the domain's and shards' edges."""
    rng = np.random.default_rng(seed)
    top = (1 << d) - 1
    keys = rng.integers(0, 1 << d, _N, dtype=np.uint64)
    pts = np.concatenate([keys[:128],
                          rng.integers(0, 1 << d, 128, dtype=np.uint64)])
    lo = rng.integers(0, 1 << d, 256, dtype=np.uint64)
    span = np.uint64(1) << rng.integers(0, d - 1, 256).astype(np.uint64)
    hi = np.minimum(lo + span - np.uint64(1), np.uint64(top))
    edge = 1 << min(d - S.bit_length() + 1, d - 1)   # a shard boundary
    elo = np.asarray([0, 0, top, 0, edge - 1, edge - 3, top - 7], np.uint64)
    ehi = np.asarray([top, 0, top, 5, edge, edge + 3, top], np.uint64)
    return (keys, pts, np.concatenate([lo, elo]),
            np.concatenate([hi, ehi]))


@pytest.fixture(scope="module")
def reference():
    """One reference build, point and range per case."""
    out = {}
    for name, (d, S) in _CASES.items():
        keys, pts, lo, hi = _inputs(d, S, seed=d * 10 + S)
        rb = RBank(d, S, _N, 14.0, delta=6, _warn=False)
        kd = rb.kdtype
        state = rb.build(jnp.asarray(keys, kd))
        out[name] = dict(
            layout=FilterLayout.from_dict(
                dataclasses.asdict(rb.layout)),
            state=np.asarray(state),
            point=np.asarray(rb.point(state, jnp.asarray(pts, kd))),
            range=np.asarray(rb.range(state, jnp.asarray(lo, kd),
                                      jnp.asarray(hi, kd))),
            inputs=(keys, pts, lo, hi))
    return out


def _port(d, S):
    return FilterBank(d, S, _N, 14.0, delta=6, device="cpu", _warn=False)


@pytest.mark.parametrize("name", list(_CASES))
def test_bank_matches_reference(reference, name):
    d, S = _CASES[name]
    ref = reference[name]
    keys, pts, lo, hi = ref["inputs"]
    bank = _port(d, S)
    assert bank.layout == ref["layout"]
    assert not bank.kernels             # a CPU bank takes the plain path
    state = bank.build(u64.carrier(keys))
    assert state.shape == (S, bank.layout.total_u32)
    np.testing.assert_array_equal(state.numpy().view(np.uint32),
                                  ref["state"])
    pv = bank.point(state, u64.carrier(pts)).numpy()
    np.testing.assert_array_equal(pv, ref["point"])
    assert pv[:128].all()
    rv = bank.range(state, u64.carrier(lo), u64.carrier(hi)).numpy()
    np.testing.assert_array_equal(rv, ref["range"])
    assert not (brute_force_range_truth(keys, lo, hi) & ~rv).any()
    assert bank.size_bits() == S * bank.layout.total_bits
    # inserting in two calls ORs into the same state
    half = bank.insert(bank.insert(bank.init_state(),
                                   u64.carrier(keys[:_N // 2])),
                       u64.carrier(keys[_N // 2:]))
    np.testing.assert_array_equal(half.numpy(), state.numpy())


def test_bank_validates_like_reference():
    for bad in ((16, 3), (16, 0), (2, 4)):
        with pytest.raises(ValueError):
            RBank(*bad, 100, _warn=False)
        with pytest.raises(ValueError):
            FilterBank(*bad, 100, device="cpu", _warn=False)
    lay = _port(24, 2).layout
    with pytest.raises(ValueError, match="shard domain"):
        FilterBank(24, 4, 100, device="cpu", _warn=False, _layout=lay)


def test_constructors_warn_like_reference():
    """Constructing a bank directly warns (``LegacyAPIWarning``, attributed
    to the caller); ``_warn=False`` and the façade do not."""
    with pytest.warns(LegacyAPIWarning, match="placement='bank'") as rec:
        FilterBank(16, 2, 100, device="cpu")
    assert rec[0].filename == __file__
    with pytest.warns(LegacyAPIWarning, match="placement='tenant'"):
        tdist.TenantFilterBank(16, 2, 2, 100, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", LegacyAPIWarning)
        FilterBank(16, 2, 100, device="cpu", _warn=False)


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    """A gloo process group of one rank in this process."""
    path = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["d16_s4", "d40_s2"])
def test_sharded_bank_world_of_one(reference, world_of_one, name):
    d, S = _CASES[name]
    keys, pts, lo, hi = reference[name]["inputs"]
    sb = ShardedFilterBank(_port(d, S))
    assert sb.rows_per_rank == S and sb.row0 == 0
    state = sb.build(u64.carrier(keys))
    np.testing.assert_array_equal(
        sb.gather_state(state).numpy().view(np.uint32),
        reference[name]["state"])
    np.testing.assert_array_equal(
        sb.point(state, u64.carrier(pts)).numpy(), reference[name]["point"])
    np.testing.assert_array_equal(
        sb.range(state, u64.carrier(lo), u64.carrier(hi)).numpy(),
        reference[name]["range"])


_WORLD2 = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core import uint64 as u64
from repro_torch.dist import (FilterBank, ShardedFilterBank,
                              ShardedTenantFilterBank, TenantFilterBank,
                              replica_groups)
rank, path = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + path, rank=rank,
                        world_size=2)
rng = np.random.default_rng(7)
keys = u64.carrier(rng.integers(0, 1 << 24, 801, dtype=np.uint64))
lo = rng.integers(0, 1 << 24, 301, dtype=np.uint64)
hi = u64.carrier(np.minimum(lo + np.uint64(1 << 20), np.uint64((1 << 24) - 1)))
lo = u64.carrier(lo)
ten = torch.from_numpy(rng.integers(0, 5, 801))   # tenant 4: owned by none
bank = FilterBank(24, 4, 800, 14.0, device="cpu", _warn=False)
full = bank.build(keys)
sb = ShardedFilterBank(bank)
st = sb.build(keys)
assert sb.rows_per_rank == 2 and sb.row0 == 2 * rank
assert torch.equal(sb.gather_state(st), full)
assert torch.equal(sb.point(st, keys), bank.point(full, keys))
assert torch.equal(sb.range(st, lo, hi), bank.range(full, lo, hi))
tb = TenantFilterBank(24, 4, 2, 400, 14.0, device="cpu", _warn=False)
fs, fm = tb.build(ten, keys)
for n_rep in (1, 2):
    data, rep = replica_groups(n_rep)
    stb = ShardedTenantFilterBank(tb, data, rep if n_rep > 1 else None)
    s, m = stb.build(ten, keys)                  # 801 keys: a padded batch
    if n_rep == 1:
        assert stb.tenants_per_rank == 2
        s, m = stb.gather_state(s), stb.gather_state(m)
    assert torch.equal(s, fs) and torch.equal(m, fm), n_rep
    s, m = stb.shard_state(fs), stb.shard_meta(fm)
    t = ten[:301]
    assert torch.equal(stb.point(s, ten, keys), tb.point(fs, ten, keys))
    for meta in (None, m):
        got = stb.range(s, t, lo, hi, meta)
        want = tb.range(fs, t, lo, hi, None if meta is None else fm)
        assert torch.equal(got, want), (n_rep, meta is None)
dist.destroy_process_group()
print("ok", rank)
"""


def test_sharded_classes_on_a_spawned_gloo_world_of_two(tmp_path):
    """Both sharded classes on two processes: a bank's rows split 2 + 2, a
    tenant bank's tenants split over the data axis, then replicated on a
    replica axis of 2 (each replica answers half of every batch), each
    equal to the unsharded bank."""
    env = {**os.environ, "PYTHONPATH": str(_SRC)}
    init = tmp_path / "init"
    procs = [subprocess.Popen([sys.executable, "-c", _WORLD2, str(r),
                               str(init)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert out.strip() == f"ok {r}"
