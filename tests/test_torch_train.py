"""The port's training stratum (``repro_torch.train``: ``optimizer``,
``train_loop``, ``fault_tolerance``; the int8 error feedback of
``repro_torch.dist.compression``) against ``repro.train`` on the CPU.

Parameters are drawn by numpy from the reference's tables (no
``jax.random`` init) and carried over by ``params_from_numpy``; each
reference step is jitted once per module.

Tolerances.  ``ef_compress`` bit for bit.  The optimizer within 1e-6
relative (the same f32 ops; XLA may contract a multiply-add).  A train
step: loss and grad norm within 1e-4 relative; the step's clipped
gradient, read from the optimizer's first moment (``m = 0.1 g`` after one
step from zero), within 1e-4 of each leaf's scale (plus one int8 quantum
under error feedback: a value at a half quantum may round either way);
the params within 1e-4 wherever that gradient is resolved, |g| > 1e-5.
Below it, f32 rounding noise (~1e-8) is of the order of Adam's ``eps``
and decides the sign of the first update ``g / (|g| + eps)``; there the
params are held to the bound every Adam step obeys, ``lr (1 + wd |p|)``
on each side."""
import dataclasses
import functools
import itertools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.dist import compression as r_comp
from repro.models import get_model as r_get_model
from repro.models.params import P as RP
from repro.train import OptConfig as ROptConfig
from repro.train import TrainConfig as RTrainConfig
from repro.train import Trainer as RTrainer
from repro.train import make_train_step as r_make_train_step
from repro.train import optimizer as r_opt
from repro.train.fault_tolerance import Supervisor as RSupervisor
from repro_torch.configs import get_config
from repro_torch.dist.compression import ef_compress, ef_init
from repro_torch.models import get_model
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map
from repro_torch.train import (OptConfig, TrainConfig, Trainer, adamw_init,
                               adamw_update, cosine_lr, latest_step,
                               make_train_step, restore_layer_range)
from repro_torch.train.fault_tolerance import Supervisor, elastic_restore

CPU = "cpu"
STEP_TOL = 1e-4
RESOLVED = 1e-5      # |g| above which Adam's first update is determined


def _leaves_np(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _t(tree):
    return [a.detach().numpy() for a in tree_leaves(tree)]


def np_params(table, seed):
    """The reference's inits drawn by numpy, leaf by leaf."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        if p.init in ("zeros", "ones"):
            a = np.full(p.shape, float(p.init == "ones"))
        elif p.init == "a_log":
            a = np.log(rng.uniform(1.0, 16.0, p.shape))
        elif p.init == "dt_bias":
            a = np.log(np.expm1(rng.uniform(1e-3, 1e-1, p.shape)))
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            scale = p.scale if p.scale is not None else fan_in ** -0.5
            a = np.clip(rng.normal(0, 1, p.shape), -2, 2) * scale
        return a.astype(np.float32)
    return jax.tree.map(leaf, table, is_leaf=lambda x: isinstance(x, RP))


def _tamed(tree):
    """``tree`` with every 3-D attention projection rescaled from the
    reference's init fan-in to the true one (ROADMAP C.8): ``wq`` / ``wk``
    / ``wv`` (..., D, H, hd) drawn at 1/sqrt(H), ``wo`` (..., H, hd, D) at
    1/sqrt(hd).  At the reference's scales an attention layer without
    qk-norm saturates its softmax and training amplifies f32 roundings
    from step to step (ROADMAP C.9): the parity tests hold the code on
    tamed weights, ``test_reference_init_amplifies_roundings`` pins the
    amplification."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("wq", "wk", "wv") and not isinstance(v, dict):
            out[k] = (v * np.sqrt(v.shape[-2] / v.shape[-3])
                      ).astype(np.float32)
        elif k == "wo" and not isinstance(v, dict):
            out[k] = (v / np.sqrt(v.shape[-3])).astype(np.float32)
        else:
            out[k] = _tamed(v)
    return out


def _batch(cfg, seed, B=4, S=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab - 1, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)
                                     ).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# int8 error feedback
# ---------------------------------------------------------------------------

def test_ef_compress_matches_reference_bit_for_bit():
    rng = np.random.default_rng(31)
    grads = {"a": rng.normal(0, 1, (7, 5)).astype(np.float32),
             "b": {"c": np.zeros((4,), np.float32),          # scale floor
                   "d": (rng.normal(0, 1e-3, (3, 3, 2)) *
                         rng.integers(0, 2, (3, 3, 2))).astype(np.float32)},
             "e": rng.standard_cauchy((64,)).astype(np.float32)}
    r_err = r_comp.ef_init(grads)
    err = ef_init(params_from_numpy(grads, CPU))
    for _ in range(3):         # the residual carries into the next step
        r_deq, r_err = r_comp.ef_compress(
            jax.tree.map(jnp.asarray, grads), r_err)
        deq, err = ef_compress(params_from_numpy(grads, CPU), err)
        for ours, ref in zip(_t(deq) + _t(err),
                             _leaves_np(r_deq) + _leaves_np(r_err)):
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)
        grads = jax.tree.map(lambda g: g * 0.5 + 0.25, grads)


def test_grad_compression_error_feedback_converges():
    """EF-int8 SGD still converges on a quadratic (the reference's test,
    on the port)."""
    target = torch.tensor([1.5, -2.0, 0.25, 7.0])
    x = {"w": torch.zeros(4)}
    err = ef_init(x)
    for _ in range(300):
        g = {"w": 2 * (x["w"] - target)}
        cg, err = ef_compress(g, err)
        x = {"w": x["w"] - 0.05 * cg["w"]}
    np.testing.assert_allclose(x["w"].numpy(), target.numpy(), atol=1e-2)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

OPT = dict(lr=2e-3, warmup_steps=4, total_steps=20)


def test_cosine_lr_matches_reference():
    r_cfg, cfg = ROptConfig(**OPT), OptConfig(**OPT)
    for step in (0, 1, 3, 4, 5, 11, 19, 20, 27):
        ref = float(r_opt.cosine_lr(r_cfg, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(float(cosine_lr(cfg, step)), ref,
                                   rtol=1e-7)
        np.testing.assert_allclose(
            float(cosine_lr(cfg, torch.tensor(step, dtype=torch.int32))),
            ref, rtol=1e-7)


def test_adamw_update_matches_reference():
    """Three updates of a small tree (a stacked leaf among them), the
    first with the clip active."""
    rng = np.random.default_rng(32)
    params = {"layers": {"w": rng.normal(0, 1, (3, 6, 4)).astype(np.float32)},
              "b": rng.normal(0, 1, (9,)).astype(np.float32)}
    r_cfg, cfg = ROptConfig(**OPT), OptConfig(**OPT)
    r_params = jax.tree.map(jnp.asarray, params)
    r_state = r_opt.adamw_init(r_params)
    ours = params_from_numpy(params, CPU)
    state = adamw_init(ours)
    assert state["count"].dtype == torch.int32 and state["count"].ndim == 0
    update = jax.jit(functools.partial(r_opt.adamw_update, r_cfg))
    for scale in (3.0, 0.1, 0.05):
        grads = jax.tree.map(
            lambda p: (rng.normal(0, scale, p.shape)).astype(np.float32),
            params)
        r_params, r_state, r_m = update(
            jax.tree.map(jnp.asarray, grads), r_state, r_params)
        ours, state, m = adamw_update(cfg, params_from_numpy(grads, CPU),
                                      state, ours)
        for a, b in zip(_t(ours) + _t(state["m"]) + _t(state["v"]),
                        _leaves_np(r_params) + _leaves_np(r_state["m"]) +
                        _leaves_np(r_state["v"])):
            # relative to the leaf: an updated param is a difference of
            # terms up to the leaf's scale
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())
        assert int(state["count"]) == int(r_state["count"])
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(r_m[k]),
                                       rtol=1e-6)


# ---------------------------------------------------------------------------
# one train step of each family against the reference's jitted step
# ---------------------------------------------------------------------------

STEP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
#: (arch, microbatches, grad_compression): the reference's own
#: compressed-step test on granite-moe
STEP_CASES = [("qwen3-1.7b", 1, False),
              ("granite-moe-3b-a800m", 2, True),
              ("zamba2-2.7b", 1, False),
              ("whisper-base", 1, False)]


@pytest.mark.parametrize("arch,mb,ef", STEP_CASES)
def test_train_step_matches_reference(arch, mb, ef):
    r_cfg = r_get_config(arch, smoke=True)
    r_model = r_get_model(r_cfg)
    params = _tamed(np_params(r_model.table(), 33))
    batch = _batch(r_cfg, 34, B=4, S=16)
    tc = dict(steps=1, microbatches=mb, grad_compression=ef)
    r_step = jax.jit(r_make_train_step(r_model, ROptConfig(**STEP_OPT),
                                       RTrainConfig(**tc)))
    r_params = jax.tree.map(jnp.asarray, params)
    r_p, r_o, _, r_m = r_step(
        r_params, r_opt.adamw_init(r_params),
        r_comp.ef_init(r_params) if ef else {},
        jax.tree.map(jnp.asarray, batch))

    model = get_model(get_config(arch, smoke=True), CPU)
    ours = params_from_numpy(params, CPU)
    before = _t(tree_map(torch.clone, ours))
    step = make_train_step(model, OptConfig(**STEP_OPT), TrainConfig(**tc))
    p, o, e, m = step(ours, adamw_init(ours), ef_init(ours) if ef else {},
                      batch)
    assert (e == {}) == (not ef)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(r_m[k]),
                                   rtol=STEP_TOL)
    lr = float(r_m["lr"])
    wd = OptConfig().weight_decay
    for p0, pa, ma, pb, mb_ in zip(before, _t(p), _t(o["m"]),
                                   _leaves_np(r_p), _leaves_np(r_o["m"])):
        g_ours, g_ref = ma / 0.1, mb_ / 0.1
        scale = float(np.abs(g_ref).max())
        quantum = scale / 127 if ef else 0.0
        assert np.abs(g_ours - g_ref).max() <= STEP_TOL * scale + \
            quantum * (1 + 1e-3), arch
        resolved = np.abs(g_ref) > RESOLVED
        d = np.abs(pa - pb)
        assert (d[resolved] <= STEP_TOL).all(), arch
        assert (d <= 2 * lr * (1 + wd * np.abs(p0)) + STEP_TOL).all(), arch
        assert not np.array_equal(pa, p0) or scale == 0.0


# ---------------------------------------------------------------------------
# the Trainer: a reference run, then the port straight and resumed
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2.5-3b"
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
TRAIN_STEPS, TRAIN_EVERY = 8, 4


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's Trainer on qwen2.5-3b smoke, one fixed batch, 8
    steps with a checkpoint every 4 (steps 3 and 7)."""
    cfg = r_get_config(TRAIN_ARCH, smoke=True)
    model = r_get_model(cfg)
    params = _tamed(np_params(model.table(), 35))
    batch = _batch(cfg, 36)
    ckpt = tmp_path_factory.mktemp("reference_ckpt")
    tr = RTrainer(model, jax.tree.map(jnp.asarray, params),
                  ROptConfig(**TRAIN_OPT),
                  RTrainConfig(steps=TRAIN_STEPS, log_every=1,
                               checkpoint_every=TRAIN_EVERY),
                  itertools.repeat(jax.tree.map(jnp.asarray, batch)),
                  ckpt_dir=str(ckpt))
    log = tr.run()
    return {"params": params, "batch": batch, "ckpt": ckpt,
            "losses": [r["loss"] for r in log]}


def _port_trainer(params, batch, ckpt_dir=None, steps=TRAIN_STEPS,
                  every=TRAIN_EVERY, fail=None, arch=TRAIN_ARCH,
                  opt=TRAIN_OPT):
    model = get_model(get_config(arch, smoke=True), CPU)
    return Trainer(model, params_from_numpy(params, CPU), OptConfig(**opt),
                   TrainConfig(steps=steps, log_every=1,
                               checkpoint_every=every),
                   itertools.repeat(batch), ckpt_dir=ckpt_dir,
                   fail_at_step=fail)


def test_trainer_straight_run_matches_reference(reference_run):
    log = _port_trainer(reference_run["params"], reference_run["batch"]).run()
    assert [r["step"] for r in log] == list(range(TRAIN_STEPS))
    np.testing.assert_allclose([r["loss"] for r in log],
                               reference_run["losses"], rtol=STEP_TOL)


def test_trainer_resumes_from_reference_checkpoint(reference_run, tmp_path):
    """The port's Trainer restores the reference's step-3 files (params and
    the optimizer's m, v, count) and continues with its losses."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    shutil.copytree(reference_run["ckpt"] / "step_000003",
                    ckpt / "step_000003")
    tr = _port_trainer(reference_run["params"], reference_run["batch"],
                       ckpt_dir=str(ckpt))
    assert tr.start_step == 4
    assert int(tr.opt_state["count"]) == 4
    log = tr.run()
    assert [r["step"] for r in log] == [4, 5, 6, 7]
    np.testing.assert_allclose([r["loss"] for r in log],
                               reference_run["losses"][4:], rtol=STEP_TOL)
    assert latest_step(str(ckpt)) == 7
    part, probed, loaded = restore_layer_range(str(ckpt), 7, 1, 1, device=CPU)
    assert probed >= 1 and loaded >= 1
    for k, v in part.items():
        assert v.shape[0] == 1, k


# ---------------------------------------------------------------------------
# port-only: memorization, supervision, stragglers, elastic restore
# ---------------------------------------------------------------------------

def test_loss_decreases_on_memorization():
    """The reference's memorization test on the port: qwen3 smoke, one
    fixed batch, 60 steps."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = get_model(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(0))
    tr = Trainer(model, params, OptConfig(lr=3e-3, warmup_steps=5,
                                          total_steps=60),
                 TrainConfig(steps=60, log_every=1, checkpoint_every=1000),
                 itertools.repeat(_batch(cfg, 37)))
    log = tr.run()
    assert log[-1]["loss"] < 0.6 * log[0]["loss"], (log[0], log[-1])


def test_supervisor_restart_resumes_to_the_straight_loss(reference_run,
                                                         tmp_path):
    """The reference's restart test on the port: 14 steps, a checkpoint
    every 7, a failure injected at step 10 of the first attempt."""
    params, batch = reference_run["params"], reference_run["batch"]
    straight = _port_trainer(params, batch, str(tmp_path / "a"), steps=14,
                             every=7).run()
    ckpt = str(tmp_path / "b")
    sleeps = []
    sup = Supervisor(lambda: _port_trainer(
        params, batch, ckpt, steps=14, every=7,
        fail=10 if latest_step(ckpt) is None else None),
        max_restarts=2, sleep=sleeps.append)
    res = sup.run()
    assert res["restarts"] == 1 and len(sleeps) == 1
    assert res["incidents"][0]["resume_step"] == 0
    assert "injected failure at step 10" in res["incidents"][0]["error"]
    assert [r["step"] for r in res["metrics"]] == list(range(7, 14))
    np.testing.assert_allclose(res["metrics"][-1]["loss"],
                               straight[-1]["loss"], rtol=STEP_TOL)


class _Failing:
    """A trainer that fails ``n`` times in all, then returns."""

    def __init__(self, budget):
        self.budget = budget
        self.start_step = 3
        self.straggler_events = []

    def run(self):
        if self.budget[0] > 0:
            self.budget[0] -= 1
            raise RuntimeError("boom")
        return ["done"]


@pytest.mark.parametrize("seed", [0, 7])
def test_supervisor_backoff_schedule_matches_reference(seed):
    got = []
    for cls in (Supervisor, RSupervisor):
        sleeps, budget = [], [4]
        sup = cls(lambda: _Failing(budget), max_restarts=5,
                  backoff_base=0.5, backoff_cap=3.0, jitter=0.25, seed=seed,
                  sleep=sleeps.append)
        res = sup.run()
        assert res["restarts"] == 4 and res["metrics"] == ["done"]
        got.append((sleeps, [i["backoff_s"] for i in res["incidents"]]))
    assert got[0] == got[1]
    assert got[0][0] == got[0][1]
    with pytest.raises(RuntimeError, match="exceeded 1 restarts"):
        Supervisor(lambda: _Failing([5]), max_restarts=1,
                   sleep=lambda s: None).run()
    with pytest.raises(ValueError):
        Supervisor(lambda: None, jitter=2.0)


def test_straggler_detection():
    tr = Trainer.__new__(Trainer)
    tr.cfg = TrainConfig(straggler_zscore=3.0)
    times = [0.10 + 0.001 * i for i in range(20)]
    assert tr._detect_straggler(times[:7]) is None
    assert tr._detect_straggler(times) is None
    ev = tr._detect_straggler(times + [1.5])
    assert ev is not None and ev["z"] > 3.0 and ev["step"] == 20
    assert ev["action"] == "flagged-for-rescheduling"


def test_elastic_restore_places_on_a_device_or_a_tree(reference_run):
    params = reference_run["params"]
    like = {"params": params_from_numpy(params, CPU),
            "opt": adamw_init(params_from_numpy(params, CPU))}
    ckpt = str(reference_run["ckpt"])
    back = elastic_restore(ckpt, 7, like, CPU)
    placed = elastic_restore(ckpt, 7, like,
                             tree_map(lambda _: torch.device(CPU), like))
    ref = elastic_restore(ckpt, 7, like)
    assert int(back["opt"]["count"]) == TRAIN_STEPS
    for a, b, c in zip(tree_leaves(back), tree_leaves(placed),
                       tree_leaves(ref)):
        assert a.device.type == CPU and torch.equal(a, b)
        assert torch.equal(a, c)


def test_compressed_trainer_carries_the_error():
    """With ``grad_compression`` the Trainer starts from zero error leaves
    shaped as the params and carries the step's residual; without it the
    error is ``{}``."""
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    model = get_model(cfg, CPU)
    params = model.init(torch.Generator().manual_seed(1))
    batch = _batch(cfg, 38, B=4, S=8)
    tr = Trainer(model, params, OptConfig(**STEP_OPT),
                 TrainConfig(steps=2, microbatches=2, grad_compression=True,
                             log_every=1), itertools.repeat(batch))
    assert [a.shape for a in tree_leaves(tr.ef_error)] == \
        [a.shape for a in tree_leaves(params)]
    log = tr.run()
    assert all(np.isfinite(r["loss"]) for r in log)
    assert any(bool(e.abs().max() > 0) for e in tree_leaves(tr.ef_error))
    plain = Trainer(model, params, OptConfig(**STEP_OPT),
                    TrainConfig(steps=1), itertools.repeat(batch))
    assert plain.ef_error == {}
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        RTrainConfig())
    assert dataclasses.asdict(OptConfig()) == dataclasses.asdict(
        ROptConfig())


def test_reference_init_amplifies_roundings(reference_run):
    """ROADMAP C.9: at the reference's init (attention projections at the
    head count's fan-in, C.8) training qwen2.5 smoke amplifies a one-ulp
    change of the 3-D weights some thousandfold in 8 steps; at the true
    fan-in it stays at rounding level.  So a step-for-step comparison with
    the reference holds at the true fan-in (``_tamed``) and drifts at the
    reference's, where Adam's first update already flips on the elements
    whose gradient is at rounding level."""
    cfg = r_get_config(TRAIN_ARCH, smoke=True)
    raw = np_params(r_get_model(cfg).table(), 35)
    drift = {}
    for name, params in (("reference_init", raw), ("tamed", _tamed(raw))):
        bumped = jax.tree.map(
            lambda a: np.nextafter(a, np.float32(np.inf)) if a.ndim == 3
            else a, params)
        a, b = ([r["loss"] for r in _port_trainer(
            p, reference_run["batch"]).run()] for p in (params, bumped))
        drift[name] = max(abs(x - y) / x for x, y in zip(a, b))
    assert drift["reference_init"] > 1e-5, drift
    assert drift["tamed"] < 1e-6, drift
