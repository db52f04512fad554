"""The port's multi-tenant bank (``repro_torch.dist.tenant_bank``) against
``repro.dist.tenant_bank`` on the same seeded keys: main and meta states
bit for bit, point verdicts, range verdicts with and without the meta
rows, ``meta_skip_stats`` and the obs counters ``record_meta_skips``
feeds, the advised promotion factor with its ``CostReport``\\ s, promoted
states, ``AgingTenantBank`` over generations, and
``ShardedTenantFilterBank`` on a ``torch.distributed`` world of 1.  Each
reference bank is built once per module."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.dist.tenant_bank import AgingTenantBank as RAging
from repro.dist.tenant_bank import TenantFilterBank as RTenant
from repro.obs import metrics as rmetrics
from repro.obs.fpr import FprSampler as RSampler
from repro.tune import WorkloadModel as RWorkload
from repro.tune import fit_workload as rfit
from repro_torch.core import uint64 as u64
from repro_torch.dist import (AgingTenantBank, ShardedTenantFilterBank,
                              TenantFilterBank)
from repro_torch.obs import metrics
from repro_torch.tune import WorkloadModel

#: (d, tenants, shards, keys per tenant)
_CASES = {"d24_t4_s2": (24, 4, 2, 300)}


def _inputs(d, T, seed):
    """Keys with tenants (one id past the last: owned by none), points
    half present, and ranges from one code to a quarter of the domain,
    across shards, with the domain's edges."""
    rng = np.random.default_rng(seed)
    top = (1 << d) - 1
    keys = rng.integers(0, 1 << d, 600, dtype=np.uint64)
    ten = rng.integers(0, T, 600).astype(np.uint32)
    pts = np.concatenate([keys[:128],
                          rng.integers(0, 1 << d, 128, dtype=np.uint64)])
    pten = np.concatenate([ten[:128], rng.integers(0, T + 1, 128)]
                          ).astype(np.uint32)
    lo = rng.integers(0, 1 << d, 250, dtype=np.uint64)
    span = np.uint64(1) << rng.integers(0, d - 2, 250).astype(np.uint64)
    hi = np.minimum(lo + span - np.uint64(1), np.uint64(top))
    lo = np.concatenate([lo, np.asarray([0, 0, top, 0, 1 << (d - 1)],
                                        np.uint64)])
    hi = np.concatenate([hi, np.asarray([top, 0, top, 5, top], np.uint64)])
    rten = rng.integers(0, T, len(lo)).astype(np.uint32)
    return keys, ten, pts, pten, lo, hi, rten


def _workload_dict(d, lo, hi):
    """The reference's workload fitted from these ranges."""
    s = RSampler(d, seed=3)
    s.observe_ranges(lo, hi)
    return rfit(d, sampler=s).to_dict()


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name, (d, T, S, n) in _CASES.items():
        keys, ten, pts, pten, lo, hi, rten = inp = _inputs(d, T, d + T + S)
        rb = RTenant(d, T, S, n, 14.0, delta=6, _warn=False)
        kd = rb.bank.kdtype
        J = dict(k=jnp.asarray(keys, kd), t=jnp.asarray(ten),
                 p=jnp.asarray(pts, kd), pt=jnp.asarray(pten),
                 lo=jnp.asarray(lo, kd), hi=jnp.asarray(hi, kd),
                 rt=jnp.asarray(rten))
        state, meta = rb.build(J["t"], J["k"])
        wl = _workload_dict(d, lo, hi)
        factor, reports = rb.advise_promotion(RWorkload.from_dict(wl))
        nb, pst, pme = rb.promote(state, meta, 2)
        aging = RAging(rb, 3)
        for step in range(4):           # three windows, then one retired
            aging.insert(J["t"][step::4], J["k"][step::4])
            aging.advance()
        # the collapsed generations probe like any state: the verdicts of
        # the aged bank come from the port's own bank below
        out[name] = dict(
            inputs=inp, wl=wl,
            layouts=(dataclasses.asdict(rb.bank.layout),
                     dataclasses.asdict(rb.meta_layout)),
            state=np.asarray(state), meta=np.asarray(meta),
            point=np.asarray(rb.point(state, J["pt"], J["p"])),
            range=np.asarray(rb.range(state, J["rt"], J["lo"], J["hi"])),
            range_meta=np.asarray(rb.range(state, J["rt"], J["lo"], J["hi"],
                                           meta)),
            skips=[int(x) for x in rb.meta_skip_stats(meta, J["rt"],
                                                      J["lo"], J["hi"])],
            factor=factor, reports={f: r.as_dict()
                                    for f, r in reports.items()},
            promoted=(np.asarray(pst), np.asarray(pme),
                      dataclasses.asdict(nb.bank.layout)),
            aging=(np.asarray(aging.gens.collapsed[0]),
                   np.asarray(aging.gens.collapsed[1])),
            size_bits=rb.size_bits(), meta_level=rb.meta_level)
    return out


def _port(name):
    d, T, S, n = _CASES[name]
    return TenantFilterBank(d, T, S, n, 14.0, delta=6, device="cpu",
                            _warn=False)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name", list(_CASES))
def test_tenant_bank_matches_reference(reference, name):
    ref = reference[name]
    keys, ten, pts, pten, lo, hi, rten = ref["inputs"]
    tb = _port(name)
    assert (dataclasses.asdict(tb.bank.layout),
            dataclasses.asdict(tb.meta_layout)) == ref["layouts"]
    assert tb.meta_level == ref["meta_level"]
    assert tb.size_bits() == ref["size_bits"]
    state, meta = tb.build(_t(ten), u64.carrier(keys))
    np.testing.assert_array_equal(_u32(state), ref["state"])
    np.testing.assert_array_equal(_u32(meta), ref["meta"])
    pv = tb.point(state, _t(pten), u64.carrier(pts)).numpy()
    np.testing.assert_array_equal(pv, ref["point"])
    assert pv[:128].all()
    lo_t, hi_t = u64.carrier(lo), u64.carrier(hi)
    plain = tb.range(state, _t(rten), lo_t, hi_t).numpy()
    gated = tb.range(state, _t(rten), lo_t, hi_t, meta).numpy()
    np.testing.assert_array_equal(plain, ref["range"])
    np.testing.assert_array_equal(gated, ref["range_meta"])
    assert not (gated & ~plain).any()           # meta only ever narrows
    cand, skip = tb.meta_skip_stats(meta, _t(rten), lo_t, hi_t)
    assert [int(cand), int(skip)] == ref["skips"]


@pytest.mark.parametrize("name", list(_CASES))
def test_advised_promotion_and_promote_match_reference(reference, name):
    ref = reference[name]
    keys, ten, *_ = ref["inputs"]
    tb = _port(name)
    factor, reports = tb.advise_promotion(WorkloadModel.from_dict(ref["wl"]))
    assert factor == ref["factor"]
    assert {f: r.as_dict() for f, r in reports.items()} == ref["reports"]
    state, meta = tb.build(_t(ten), u64.carrier(keys))
    nb, pst, pme = tb.promote(state, meta, 2)
    want_state, want_meta, want_layout = ref["promoted"]
    assert dataclasses.asdict(nb.bank.layout) == want_layout
    np.testing.assert_array_equal(_u32(pst), want_state)
    np.testing.assert_array_equal(_u32(pme), want_meta)
    # every inserted key still probes positive on the grown bank
    assert nb.point(pst, _t(ten), u64.carrier(keys)).all()
    with pytest.raises(ValueError, match="n_target"):
        tb.advise_promotion(WorkloadModel.from_dict(ref["wl"]),
                            n_target=100 * tb.n_keys_per_tenant)


@pytest.mark.parametrize("name", list(_CASES))
def test_aging_bank_matches_reference(reference, name):
    ref = reference[name]
    keys, ten, pts, pten, lo, hi, rten = ref["inputs"]
    tb = _port(name)
    aging = AgingTenantBank(tb, 3)
    kt, tt = u64.carrier(keys), _t(ten)
    for step in range(4):
        aging.insert(tt[step::4].contiguous(), kt[step::4].contiguous())
        aging.advance()
    state, meta = ref["aging"]
    np.testing.assert_array_equal(_u32(aging.gens.collapsed[0]), state)
    np.testing.assert_array_equal(_u32(aging.gens.collapsed[1]), meta)
    # the aged bank answers from the OR of its generations
    st = torch.from_numpy(state.view(np.int32).copy())
    me = torch.from_numpy(meta.view(np.int32).copy())
    np.testing.assert_array_equal(
        aging.point(_t(pten), u64.carrier(pts)).numpy(),
        tb.point(st, _t(pten), u64.carrier(pts)).numpy())
    np.testing.assert_array_equal(
        aging.range(_t(rten), u64.carrier(lo), u64.carrier(hi)).numpy(),
        tb.range(st, _t(rten), u64.carrier(lo), u64.carrier(hi), me).numpy())
    # the retired first window's keys are gone from every row
    assert not aging.point(tt[0::4], kt[0::4]).all()
    assert aging.size_bits() == 3 * tb.size_bits()
    grown = aging.promoted(2)
    assert grown.point(tt[3::4], kt[3::4]).all()


def test_record_meta_skips_feeds_the_obs_counters(reference, monkeypatch):
    name = "d24_t4_s2"
    keys, ten, pts, pten, lo, hi, rten = reference[name]["inputs"]
    for m in (metrics, rmetrics):
        monkeypatch.setattr(m, "_REGISTRY", m.MetricsRegistry())
    tb = _port(name)
    _, meta = tb.build(_t(ten), u64.carrier(keys))
    for _ in range(2):
        tb.record_meta_skips(meta, _t(rten), u64.carrier(lo), u64.carrier(hi))
    snap = metrics.registry().snapshot()
    cand, skip = reference[name]["skips"]
    assert snap["tenant_bank/meta_candidates"] == 2 * cand
    assert snap["tenant_bank/meta_skipped"] == 2 * skip > 0


def test_tenant_bank_validates_like_reference():
    for kw in (dict(n_tenants=0), dict(meta_level=0), dict(meta_level=24)):
        args = dict(d=24, n_tenants=2, n_shards=1, n_keys_per_tenant=100)
        args.update(kw)
        with pytest.raises(ValueError):
            RTenant(**args, _warn=False)
        with pytest.raises(ValueError):
            TenantFilterBank(**args, device="cpu", _warn=False)
    # a 40-bit shard domain with a 31-bit prefix domain: two key dtypes
    with pytest.raises(ValueError, match="dtype"):
        TenantFilterBank(40, 2, 1, 100, meta_level=9, device="cpu",
                         _warn=False)


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    path = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_sharded_tenant_bank_world_of_one(reference, world_of_one):
    """On one rank the sharded bank holds every tenant; a batch of odd size
    with a replica group of one equals the reference's verdicts."""
    name = "d24_t4_s2"
    ref = reference[name]
    keys, ten, pts, pten, lo, hi, rten = ref["inputs"]
    sb = ShardedTenantFilterBank(_port(name), None, dist.new_group([0]))
    assert sb.tenants_per_rank == 4 and sb.n_replicas == 1
    state, meta = sb.build(_t(ten), u64.carrier(keys))
    np.testing.assert_array_equal(_u32(sb.gather_state(state)), ref["state"])
    np.testing.assert_array_equal(_u32(meta), ref["meta"])
    np.testing.assert_array_equal(
        sb.point(state, _t(pten), u64.carrier(pts)).numpy(), ref["point"])
    lo_t, hi_t = u64.carrier(lo), u64.carrier(hi)
    np.testing.assert_array_equal(
        sb.range(state, _t(rten), lo_t, hi_t).numpy(), ref["range"])
    np.testing.assert_array_equal(
        sb.range(state, _t(rten), lo_t, hi_t, meta).numpy(),
        ref["range_meta"])
