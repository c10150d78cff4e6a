"""The modules of the port's compact-pick-grow cycle against `cpg_tpu`, on
the CPU, bit for bit: the sparsity schedule, the gradual pruner, growth,
`visible_mask`, the invariant audit, the LR schedules, the CIFAR-100 data
module, checkpoints (and a bridge from an orbax checkpoint) and the CLI's
shared flags. Inputs come from a numpy seed and go through both packages.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu import cli as j_cli
from cpg_tpu.core import grow as j_grow
from cpg_tpu.core import invariants as j_inv
from cpg_tpu.core import ownership as j_own
from cpg_tpu.core import pruner as j_pruner
from cpg_tpu.core import schedule as j_sched
from cpg_tpu.core.state import CPGState as JState
from cpg_tpu.core.state import TaskEntry as JTask
from cpg_tpu.data import cifar as j_cifar
from cpg_tpu.train import manager as j_manager
from cpg_tpu.utils import checkpoint as j_ckpt
from cpg_tpu_torch import cli as t_cli
from cpg_tpu_torch import models as t_models
from cpg_tpu_torch.core import grow as t_grow
from cpg_tpu_torch.core import invariants as t_inv
from cpg_tpu_torch.core import ownership as t_own
from cpg_tpu_torch.core import pruner as t_pruner
from cpg_tpu_torch.core import schedule as t_sched
from cpg_tpu_torch.core.state import (CPGState, TaskEntry, state_from_numpy,
                                      state_to_numpy)
from cpg_tpu_torch.data import cifar as t_cifar
from cpg_tpu_torch.train import manager as t_manager
from cpg_tpu_torch.utils import Metric
from cpg_tpu_torch.utils import checkpoint as t_ckpt

torch.set_num_threads(1)


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ------------------------------------------------------------ schedule ----

@pytest.mark.parametrize("begin,end,freq", [(5, 25, 1), (5, 25, 3),
                                            (0, 7, 4), (4, 4, 2), (3, 9, 0)])
def test_schedule_bit_exact(begin, end, freq):
    """Every step of a grid that runs past both window edges."""
    for si, sf in ((0.0, 0.75), (0.1, 0.5), (0.3333, 0.9)):
        for step in range(-2, end + 4):
            _eq(t_sched.cubic_sparsity(step, begin, end, si, sf),
                j_sched.cubic_sparsity(step, begin, end, si, sf),
                (step, si, sf))
    steps = np.arange(-2, end + 4)
    _eq(t_sched.is_prune_step(torch.from_numpy(steps), begin, end, freq),
        j_sched.is_prune_step(jnp.asarray(steps), begin, end, freq))
    for step in (begin, end, end + 1):
        assert bool(t_sched.is_prune_step(step, begin, end, freq)) == bool(
            j_sched.is_prune_step(step, begin, end, freq))


# -------------------------------------------------------------- pruner ----

def _layer(seed, shape=(3, 3, 6, 10), tasks=(0, 1, 2)):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    own = rng.choice(tasks, size=shape).astype(np.int8)
    # ties: a block of equal magnitudes, both signs
    w.ravel()[:30] = np.float32(0.25) * np.where(np.arange(30) % 2, 1, -1)
    return w, own


@pytest.mark.parametrize("target,n0_shift", [(0.5, 0), (0.37, 0), (0.0, 0),
                                             (1.0, 0), (0.2, 40), (0.6, 7)])
def test_prune_layer_to_total_bit_exact(target, n0_shift):
    """Ties at the cutoff (all pruned), a shortfall of 0 (n0 below the
    owned count, or a target already met) and full pruning; the prune is
    written into the tensors it was given."""
    w, own = _layer(1)
    n0 = int((own == 1).sum()) + n0_shift
    jw, jo = j_pruner.prune_layer_to_total(w, own, 1, target, n0)
    lw, lo = torch.from_numpy(w.copy()), torch.from_numpy(own.copy())
    ptr = (lw.data_ptr(), lo.data_ptr())
    t_pruner.prune_layer_to_total_(lw, lo, 1, target, n0)
    assert (lw.data_ptr(), lo.data_ptr()) == ptr
    _eq(lw, jw)
    _eq(lo, jo)


def test_gradual_prune_event_sequence_bit_exact():
    """A cubic schedule's events over a two-layer tree from the snapshot
    counts, pruned in place; counts and achieved sparsity."""
    trees = [_layer(2), _layer(3, shape=(40, 12))]
    shared = {f"l{i}/kernel": w for i, (w, _) in enumerate(trees)}
    own = {f"l{i}/kernel": o for i, (_, o) in enumerate(trees)}
    jn0 = jax.tree.map(int, j_pruner.snapshot_owned_counts(own, 2))
    tn0 = {k: int(v) for k, v in t_pruner.snapshot_owned_counts(
        _t(own), 2).items()}
    assert tn0 == jn0
    js, jo = shared, own
    ls, lo = _t(shared), _t(own)
    init = float(j_pruner.task_sparsity(own, 2, jn0))
    assert float(t_pruner.task_sparsity(_t(own), 2, tn0)) == init
    for step in range(0, 13, 3):
        jt = j_sched.cubic_sparsity(step, 0, 12, init, 0.8)
        tt = t_sched.cubic_sparsity(step, 0, 12, init, 0.8)
        js, jo = j_pruner.gradual_prune(js, jo, 2, jt, jn0)
        t_pruner.gradual_prune_(ls, lo, 2, tt, tn0)
        for k in shared:
            _eq(ls[k], js[k], (step, k))
            _eq(lo[k], jo[k], (step, k))
        _eq(t_pruner.task_sparsity(lo, 2, tn0),
            j_pruner.task_sparsity(jo, 2, jn0))
        for k, v in t_pruner.snapshot_owned_counts(lo, 2).items():
            _eq(v, j_pruner.snapshot_owned_counts(jo, 2)[k])
    # other tasks' entries never move
    for k in shared:
        keep = own[k] != 2
        _eq(lo[k].numpy()[keep], own[k][keep])
        _eq(ls[k].numpy()[keep], shared[k][keep])


def test_visible_mask_bit_exact():
    _, own = _layer(4, tasks=(0, 1, 2, 3, 4))
    for tid in range(0, 6):
        _eq(t_own.visible_mask(torch.from_numpy(own), tid),
            j_own.visible_mask(own, tid))
    assert t_own.OWN_DTYPE == torch.int8 and j_own.OWN_DTYPE == jnp.int8


# --------------------------------------------------------------- grow ----

SUFFIXES = ["scale", "bias", "slope", "kernel", "mean", "var", "gate_bias",
            "other"]


def _grow_inputs(seed):
    """Old trees at a narrow width, fresh ones wider: a conv, a plain dense,
    a dense fed by a (2, 3, C) flatten, one layer that does not grow; a
    private tree with every fill suffix."""
    rng = np.random.RandomState(seed)
    c_old, c_new = 4, 6
    old = {"conv/kernel": (3, 3, 3, c_old), "dense/kernel": (c_old, 5),
           "fc5/kernel": (2 * 3 * c_old, 7), "same/kernel": (2, 2)}
    new = {"conv/kernel": (3, 3, 3, c_new), "dense/kernel": (c_new, 8),
           "fc5/kernel": (2 * 3 * c_new, 9), "same/kernel": (2, 2)}
    shared = {k: rng.randn(*s).astype(np.float32) for k, s in old.items()}
    fresh = {k: rng.randn(*s).astype(np.float32) for k, s in new.items()}
    own = {k: rng.choice([0, 1, 2], size=s).astype(np.int8)
           for k, s in old.items()}
    pms = {1: None, 2: {k: rng.randn(*s).astype(np.float32)
                        for k, s in old.items()}}
    priv = {f"p{i}/{s}": rng.randn(c_old).astype(np.float32)
            for i, s in enumerate(SUFFIXES)}
    priv["head/kernel"] = rng.randn(c_old, 3).astype(np.float32)
    fresh_priv = {k: rng.randn(*((c_new, 3) if k == "head/kernel"
                                 else (c_new,))).astype(np.float32)
                  for k in priv}
    priv["fixed/bias"] = rng.randn(3).astype(np.float32)
    fresh_priv["fixed/bias"] = rng.randn(3).astype(np.float32)
    return shared, own, fresh, pms, priv, fresh_priv


def test_grow_shared_and_private_bit_exact(monkeypatch):
    """Top-left block and flatten-permutation embeddings of weights,
    ownership and piggymasks; every `_PRIVATE_FILL` key (and the 0.0
    default) on the private tree. The flatten layer comes from a
    test-registered arch's `flatten_dims`."""
    shared, own, fresh, pms, priv, fresh_priv = _grow_inputs(5)
    monkeypatch.setitem(t_models.REGISTRY, "flat_test", (None, (2, 3, 3)))
    monkeypatch.setattr(t_models, "FLATTEN_DIMS", dict(t_models.FLATTEN_DIMS))
    t_models.register("flat_test", None, (2, 3, 3),
                      flatten_dims={"fc5/kernel": (2, 3)})
    fd = t_models.get_flatten_dims("flat_test")
    assert fd == {"fc5/kernel": (2, 3)}
    assert t_models.get_flatten_dims("vgg16_bn_cifar") is None
    assert t_grow._PRIVATE_FILL == j_grow._PRIVATE_FILL
    assert set(SUFFIXES[:-1]) == set(t_grow._PRIVATE_FILL)
    js, jo, jp = j_grow.grow_shared(
        _j(shared), _j(own), _j(fresh),
        {t: None if p is None else _j(p) for t, p in pms.items()}, fd)
    ts, to, tp = t_grow.grow_shared(
        _t(shared), _t(own), _t(fresh),
        {t: None if p is None else _t(p) for t, p in pms.items()}, fd)
    for k in shared:
        _eq(ts[k], js[k], k)
        _eq(to[k], jo[k], k)
        _eq(tp[2][k], jp[2][k], k)
    assert tp[1] is None and jp[1] is None
    got = t_grow.grow_private(_t(priv), _t(fresh_priv))
    want = j_grow.grow_private(_j(priv), _j(fresh_priv))
    for k in priv:
        _eq(got[k], want[k], k)
    assert float(got["p6/gate_bias"][-1]) == -1e9
    # plain block embedding without flatten_dims differs on fc5
    ts2, _, _ = t_grow.grow_shared(_t(shared), _t(own), _t(fresh), {}, None)
    js2, _, _ = j_grow.grow_shared(_j(shared), _j(own), _j(fresh), {}, None)
    _eq(ts2["fc5/kernel"], js2["fc5/kernel"])
    assert not np.array_equal(ts2["fc5/kernel"].numpy(), js["fc5/kernel"])


# ---------------------------------------------------------- invariants ----

def _states(seed=6):
    """The same small two-task state in both packages (numpy leaves for
    JAX, torch tensors for the port)."""
    shared, own, fresh, pms, priv, _ = _grow_inputs(seed)
    del fresh
    shared = {k: np.where(own[k] == 0, 0, w).astype(np.float32)
              for k, w in shared.items()}
    tasks = {1: (None, priv), 2: (pms[2], priv)}
    js = JState("vgg16_bn_cifar", 1.0, shared, own,
                {t: JTask(f"t{t}", 3, pm, dict(p), {}) for t, (pm, p)
                 in tasks.items()})
    ts = CPGState("vgg16_bn_cifar", 1.0, _t(shared), _t(own),
                  {t: TaskEntry(f"t{t}", 3, None if pm is None else _t(pm),
                                _t(p), {}) for t, (pm, p) in tasks.items()})
    return js, ts


CORRUPTIONS = {
    "clean": lambda s, a: None,
    "I1": lambda s, a: s.ownership.__setitem__(
        "dense/kernel", a(np.full((4, 5), 3, np.int8))),
    "I1_negative": lambda s, a: s.ownership.__setitem__(
        "dense/kernel", a(np.full((4, 5), -1, np.int8))),
    "I2": lambda s, a: s.shared.__setitem__(
        "conv/kernel", a(np.full((3, 3, 3, 4), 0.5, np.float32))),
    "I3": lambda s, a: s.shared.__setitem__(
        "fc5/kernel", a(np.where(np.arange(24 * 7).reshape(24, 7) == 5,
                                 np.nan, 1.0).astype(np.float32))),
    "I3_piggymask": lambda s, a: s.tasks[2].piggymask.__setitem__(
        "dense/kernel", a(np.full((4, 5), np.inf, np.float32))),
    "I4_shape": lambda s, a: s.tasks[2].piggymask.__setitem__(
        "dense/kernel", a(np.zeros((4, 6), np.float32))),
    "I4_key": lambda s, a: s.tasks[2].piggymask.__setitem__(
        "ghost/kernel", a(np.zeros((2,), np.float32))),
    "I5_key": lambda s, a: s.ownership.__setitem__(
        "ghost/kernel", a(np.zeros((2,), np.int8))),
    "I5_shape": lambda s, a: s.ownership.__setitem__(
        "same/kernel", a(np.zeros((2, 3), np.int8))),
}


@pytest.mark.parametrize("what", list(CORRUPTIONS))
@pytest.mark.parametrize("expect_zero_free", [None, True, False])
def test_check_state_matches_jax(what, expect_zero_free):
    """Each of I1-I5 triggered (and a clean state), with `expect_zero_free`
    on auto and explicit: the same violation strings, and strict mode
    raises InvariantViolation."""
    js, ts = _states()
    CORRUPTIONS[what](js, np.asarray)
    CORRUPTIONS[what](ts, torch.from_numpy)
    want = j_inv.check_state(js, strict=False,
                             expect_zero_free=expect_zero_free)
    got = t_inv.check_state(ts, strict=False,
                            expect_zero_free=expect_zero_free)
    assert got == want
    if what == "clean" or (what == "I2" and expect_zero_free is False):
        assert got == []
    else:
        assert any(v.startswith(what[:2]) for v in got)
        with pytest.raises(t_inv.InvariantViolation):
            t_inv.check_state(ts, expect_zero_free=expect_zero_free)


def test_check_state_auto_skips_free_check_before_any_task():
    js, ts = _states()
    js.tasks, ts.tasks = {}, {}
    js.ownership = {k: np.zeros_like(v) for k, v in js.ownership.items()}
    ts.ownership = {k: torch.zeros_like(v) for k, v in ts.ownership.items()}
    CORRUPTIONS["I2"](js, np.asarray)
    CORRUPTIONS["I2"](ts, torch.from_numpy)
    assert t_inv.check_state(ts) == j_inv.check_state(js) == []
    assert t_inv.check_state(ts, strict=False, expect_zero_free=True) == \
        j_inv.check_state(js, strict=False, expect_zero_free=True) != []


# ----------------------------------------------------------- schedules ----

@pytest.mark.parametrize("schedule", ["cosine", "warmup_cosine", "constant",
                                      "step"])
def test_lr_at_matches_jax(schedule):
    for total in (1, 3, 10, 31):
        for epoch in range(total + 1):
            assert t_manager._lr_at(0.013, epoch, total, schedule) == \
                j_manager._lr_at(0.013, epoch, total, schedule)
    with pytest.raises(ValueError):
        t_manager._lr_at(0.1, 0, 1, "linear")


def test_metric_running_average():
    m = Metric("acc")
    m.update(0.5, 2)
    m.update(1.0)
    assert m.avg == pytest.approx(2 / 3) and Metric().avg == 0.0


# ---------------------------------------------------------------- data ----

def test_cifar_synthetic_splits_and_batches_bit_exact(tmp_path, monkeypatch):
    kw = dict(n_train_per_class=6, n_test_per_class=3, seed=3, noise=0.7)
    want = j_cifar.synthetic_cifar100(**kw)
    got = t_cifar.synthetic_cifar100(**kw)
    for g, w in zip(got, want):
        _eq(g, w)
    jt = j_cifar.task_splits(want)
    tt = t_cifar.task_splits(got)
    assert list(tt) == list(jt) == t_cifar.SUPERCLASS_NAMES
    for name in jt:
        for k in ("train_x", "train_y", "test_x", "test_y"):
            _eq(tt[name][k], jt[name][k], (name, k))
        assert tt[name]["num_classes"] == jt[name]["num_classes"] == 5
    _eq(t_cifar.FINE_TO_COARSE, j_cifar.FINE_TO_COARSE)
    d = jt["fish"]
    for train, bs in ((True, 4), (False, 4), (False, 7)):
        jb = list(j_cifar.iterate_batches(
            d["train_x"], d["train_y"], bs, np.random.RandomState(9),
            train=train, drop_remainder=False))
        tb = list(t_cifar.iterate_batches(
            d["train_x"], d["train_y"], bs, np.random.RandomState(9),
            train=train, drop_remainder=False))
        assert len(tb) == len(jb) > 0
        for (tx, ty), (jx, jy) in zip(tb, jb):
            _eq(tx, jx)
            _eq(ty, jy)
    # the pickle reader under $CPG_DATA_DIR; without it, the synthetic set
    monkeypatch.delenv("CPG_DATA_DIR", raising=False)
    assert t_cifar.find_cifar100_dir() is None
    d = tmp_path / "cifar-100-python"
    d.mkdir()
    x = np.arange(4 * 3072, dtype=np.uint8).reshape(4, 3072)
    for split in ("train", "test"):
        with open(d / split, "wb") as f:
            import pickle
            pickle.dump({b"data": x, b"fine_labels": [3, 1, 4, 1]}, f)
    monkeypatch.setenv("CPG_DATA_DIR", str(tmp_path))
    assert t_cifar.find_cifar100_dir() == str(d)
    loaded = t_cifar.load_cifar100()
    for g, w in zip(loaded, j_cifar.load_cifar100(str(d))):
        _eq(g, w)
    assert loaded[0].shape == (4, 32, 32, 3)


# --------------------------------------------------------- checkpoints ----

def _ckpt_state():
    js, _ = _states(seed=8)
    js.tasks[2].bn_state = {"bn/mean": np.arange(4, dtype=np.float32)}
    js.tasks[2].meta = {"pick_acc": 0.5, "ratio_to_acc": {"0.5": 0.4},
                        "model_kwargs": {"x": 1}}
    js.model_kwargs = {"depth": 2}
    js.in_shape = (16, 16, 3)
    js.mask_mode = "ternary"
    js.width_mult = 1.5
    return js


def _assert_states_equal(a, b):
    """Every field and every array leaf equal, dtypes included."""
    for f in ("arch", "width_mult", "threshold", "mask_mode",
              "model_kwargs"):
        assert getattr(a, f) == getattr(b, f), f
    assert tuple(a.in_shape or ()) == tuple(b.in_shape or ())
    assert list(a.tasks) == list(b.tasks)
    pairs = [(a.shared, b.shared), (a.ownership, b.ownership)]
    for tid, t in a.tasks.items():
        u = b.tasks[tid]
        assert (t.name, t.num_classes, t.meta) == (u.name, u.num_classes,
                                                   u.meta)
        assert (t.piggymask is None) == (u.piggymask is None)
        pairs += [(t.private, u.private), (t.bn_state, u.bn_state),
                  (t.piggymask or {}, u.piggymask or {})]
    for x, y in pairs:
        assert sorted(x) == sorted(y)
        for k in x:
            xv = x[k].numpy() if isinstance(x[k], torch.Tensor) else x[k]
            yv = y[k].numpy() if isinstance(y[k], torch.Tensor) else y[k]
            _eq(xv, yv, k)


def test_checkpoint_round_trip_and_orbax_bridge(tmp_path):
    """Port save -> load is bit-exact; an orbax checkpoint of `cpg_tpu`
    crosses into the port's format through `state_from_numpy` and back
    through `state_to_numpy`, bit for bit."""
    js = _ckpt_state()
    ts = state_from_numpy(js, "cpu")
    p = t_ckpt.save_state(ts, str(tmp_path / "port"), block=False)
    assert p == str(tmp_path / "port")
    back = t_ckpt.load_state(p, device="cpu")
    _assert_states_equal(back, ts)
    assert all(v.dtype == torch.int8 for v in back.ownership.values())
    with open(tmp_path / "port" / "cpg_meta.json") as f:
        assert json.load(f)["tasks"]["2"]["meta"]["pick_acc"] == 0.5
    assert t_ckpt.latest_checkpoint(str(tmp_path)) == p
    # orbax -> port
    jp = j_ckpt.save_state(js, str(tmp_path / "orbax"))
    jback = j_ckpt.load_state(jp)
    _assert_states_equal(jback, js)
    bridged = t_ckpt.load_state(t_ckpt.save_state(
        state_from_numpy(jback, "cpu"), str(tmp_path / "bridged")), "cpu")
    _assert_states_equal(bridged, js)
    # port -> orbax
    j2 = j_ckpt.load_state(j_ckpt.save_state(
        state_to_numpy(back), str(tmp_path / "orbax2")))
    _assert_states_equal(j2, js)
    # a re-save over an existing checkpoint, and removal
    t_ckpt.save_state(back, p)
    _assert_states_equal(t_ckpt.load_state(p, "cpu"), ts)
    t_ckpt.remove_after_save(p)
    t_ckpt.wait_for_saves()
    assert not (tmp_path / "port").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_ckpt.load_state(str(tmp_path / "bridged"))


# ----------------------------------------------------------------- cli ----

def _dests(parser, cmd):
    sub = next(a for a in parser._actions
               if isinstance(a, type(parser._subparsers._group_actions[0])))
    return {a.dest: a.default for a in sub.choices[cmd]._actions
            if a.dest != "help"}


@pytest.mark.parametrize("cmd", ["sequence", "baseline", "packnet", "pae"])
def test_cli_shared_flags_defaults_and_presets_match_jax(cmd):
    got = _dests(t_cli.build_parser(), cmd)
    want = _dests(j_cli.build_parser(), cmd)
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"device"} and got["device"] == "cuda"
    for k in want:
        assert got[k] == want[k], k
    assert t_cli.EXPERIMENT_PRESETS == j_cli.EXPERIMENT_PRESETS
    argv = [cmd, "--preset", "--lr", "0.05", "--finetune-epochs", "7"]
    ta = t_cli.build_parser().parse_args(argv)
    ja = j_cli.build_parser().parse_args(argv)
    t_cli._apply_preset(ta)
    j_cli._apply_preset(ja)
    for k in want:
        assert getattr(ta, k) == getattr(ja, k), k
    assert ta.lr == 0.05 and ta.finetune_epochs == 7 and ta.prune_epochs == 30
    tseq, jseq = t_cli._seq_cfg(ta), j_cli._seq_cfg(ja)
    assert dataclasses.asdict(tseq) == dataclasses.asdict(jseq)
    tcfg, jcfg = t_cli._train_cfg(ta), j_cli._train_cfg(ja)
    for f in dataclasses.fields(tcfg):
        if f.name != "compute_dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("argv,match", [
    (["--experiment", "face", "--memmap-dir", "/nowhere"], "--memmap-dir"),
    (["--parallel", "2"], "--parallel: multi-device"),
    (["--parallel-model", "2"], "--parallel-model: model-axis"),
    (["--shard-activations"], "--shard-activations"),
    (["--memmap-dir", "/nowhere"], "--memmap-dir"),
    (["--pretrained-npz", "w.npz", "--init-from", "ck"], "--pretrained-npz"),
    (["--native-loader"], "--native-loader"),
    (["--remat"], "--remat: XLA"),
    (["--remat-policy", "convs"], "--remat-policy: XLA"),
    (["--scan-blocks"], "--scan-blocks: lax.scan"),
    (["--experiment", "finegrained", "--remat"], "--remat: XLA"),
])
def test_cli_refuses_unported_options(argv, match):
    with pytest.raises(SystemExit, match=match):
        t_cli.main(["sequence", "--device", "cpu", *argv])


@pytest.mark.parametrize("argv", [
    [], ["--text-causal"], ["--text-vocab", "512"], ["--text-seq-len", "32"],
    ["--text-tokenizer", "hash"], ["--text-order-frac", "0.5"]])
def test_cli_text_options_match_jax(argv, monkeypatch):
    """`--experiment textcls` and its five flags (synthetic tasks: no
    `CPG_DATA_DIR`): the port's `_experiment_tasks` gives `cpg_tpu.cli`'s
    arch, task names, arrays and per-task model_kwargs, no eval
    preprocess, and the identity augmentation."""
    monkeypatch.delenv("CPG_DATA_DIR", raising=False)
    full = ["sequence", "--experiment", "textcls", *argv]
    t_arch, t_tasks, t_aug, t_prep = t_cli._experiment_tasks(
        t_cli.build_parser().parse_args(full))
    j_arch, j_tasks, j_aug, j_prep = j_cli._experiment_tasks(
        j_cli.build_parser().parse_args(full))
    assert t_arch == j_arch == "textcls"
    assert list(t_tasks) == list(j_tasks) == [f"text{i:02d}"
                                             for i in range(1, 5)]
    for name, jt in j_tasks.items():
        tt = t_tasks[name]
        assert set(tt) == set(jt)
        for k in ("train_x", "train_y", "test_x", "test_y"):
            np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
        assert tt["num_classes"] == jt["num_classes"]
        assert tt.get("model_kwargs") == jt.get("model_kwargs")
    x = t_tasks["text01"]["train_x"]
    assert t_prep is j_prep is None and t_aug(x, None) is x
    assert ("--text-causal" in argv) == (
        t_tasks["text01"].get("model_kwargs") == {"causal": True})


@pytest.mark.parametrize("cmd", ["sequence", "baseline", "packnet", "pae"])
def test_cli_arch_vit_moe_cifar_matches_jax(cmd):
    """`--arch vit_moe_cifar` swaps the cifar100 experiment's architecture
    in both packages' cycle subcommands (the port stopped with "unknown
    --arch" before it had the model)."""
    argv = [cmd, "--arch", "vit_moe_cifar", "--num-tasks", "2",
            "--synthetic-train-per-class", "2",
            "--synthetic-test-per-class", "1"]
    t_arch, t_tasks, _, _ = t_cli._experiment_tasks(
        t_cli.build_parser().parse_args(argv))
    j_arch, j_tasks, _, _ = j_cli._experiment_tasks(
        j_cli.build_parser().parse_args(argv))
    assert t_arch == j_arch == "vit_moe_cifar"
    assert list(t_tasks) == list(j_tasks) and len(t_tasks) == 2
    np.testing.assert_array_equal(t_tasks["aquatic_mammals"]["train_x"],
                                  j_tasks["aquatic_mammals"]["train_x"])


@pytest.mark.parametrize("arch", ["textcls", "vit_moe_cifar"])
def test_export_torch_refuses_text_and_moe(arch, tmp_path):
    """`export-torch` refuses both archs, with `cpg_tpu`'s message: the
    reference's torch layout has no text or MoE modules."""
    from cpg_tpu.train.export_torch import export_torch_cpg_checkpoint as j_x
    from cpg_tpu_torch.train.sequence import init_state, start_task

    g = torch.Generator().manual_seed(0)
    kw = {"textcls": dict(depth=1, dim=32, heads=2, vocab=16),
          "vit_moe_cifar": dict(depth=2, dim=32, heads=2, patch=8)}[arch]
    st = init_state(arch, g, model_kwargs=kw, device="cpu")
    start_task(st, "t1", 3, g)
    t_ckpt.save_state(st, str(tmp_path / "ck"))
    with pytest.raises(NotImplementedError) as got:
        t_cli.main(["export-torch", "--ckpt", str(tmp_path / "ck"), "--out",
                    str(tmp_path / "x.pth"), "--device", "cpu"])
    with pytest.raises(NotImplementedError) as want:
        j_x(state_to_numpy(st))
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "x.pth").exists()


def test_cycle_entry_points_default_to_the_card():
    """run_sequence, Manager, predict, init_state, grow_state, load_state,
    the ResNet-50 and SphereNet-20 converters and the CLI (the finegrained,
    face and textcls experiments and `--arch vit_moe_cifar` too) run on the
    card unless told otherwise, and raise without one (this test runs where
    CUDA is absent)."""
    from cpg_tpu_torch.inference import predict
    from cpg_tpu_torch.models import get_model
    from cpg_tpu_torch.train.manager import Manager
    from cpg_tpu_torch.train.sequence import (grow_state, init_state,
                                              run_sequence, start_task)
    from cpg_tpu_torch.train.pretrained import convert_torch_cpg_checkpoint
    from cpg_tpu_torch.train.step import TrainConfig

    g = torch.Generator().manual_seed(0)
    state = init_state("vgg16_bn_cifar", g, 0.125, device="cpu")
    start_task(state, "t1", 5, g)
    data = t_cifar.task_splits(t_cifar.synthetic_cifar100(2, 1))["fish"]
    calls = [
        lambda: run_sequence("vgg16_bn_cifar", {"fish": data}),
        lambda: Manager(state, get_model("vgg16_bn_cifar")[0], 1, data,
                        TrainConfig()),
        lambda: predict(state, 1, torch.zeros((1, 32, 32, 3))),
        lambda: init_state("vgg16_bn_cifar", g, 0.125),
        lambda: grow_state(state, 0.25, g),
        lambda: t_cli.main(["sequence", "--num-tasks", "1"]),
        lambda: init_state("resnet50", g, 0.125),
        lambda: t_cli.main(["sequence", "--experiment", "finegrained",
                            "--num-tasks", "1", "--max-classes", "2"]),
        lambda: t_cli.main(["inference", "--checkpoint", "ck", "--task-id",
                            "1", "--experiment", "finegrained",
                            "--num-tasks", "1", "--max-classes", "2"]),
        lambda: convert_torch_cpg_checkpoint(
            {"state_dict": {}, "dataset_history": ["a"]}, arch="resnet50"),
        lambda: init_state("spherenet20", g, 0.125),
        lambda: t_cli.main(["sequence", "--experiment", "face",
                            "--num-tasks", "1"]),
        lambda: t_cli.main(["inference", "--checkpoint", "ck", "--task-id",
                            "1", "--experiment", "face", "--num-tasks",
                            "1"]),
        lambda: convert_torch_cpg_checkpoint(
            {"state_dict": {}, "dataset_history": ["a"]},
            arch="spherenet20"),
        lambda: init_state("textcls", g),
        lambda: init_state("vit_moe_cifar", g, 0.5),
        lambda: t_cli.main(["sequence", "--experiment", "textcls",
                            "--num-tasks", "1", "--text-causal"]),
        lambda: t_cli.main(["sequence", "--arch", "vit_moe_cifar",
                            "--num-tasks", "1"]),
        lambda: t_cli.main(["inference", "--checkpoint", "ck", "--task-id",
                            "1", "--experiment", "textcls", "--num-tasks",
                            "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    grown = grow_state(state, 0.25, g, device="cpu")
    assert grown.width_mult == 0.25
    assert all(v.device.type == "cpu" for v in grown.shared.values())


# ------------------------------------------- baselines and the cli cycle ----

def _tiny_tasks(n):
    data = t_cifar.synthetic_cifar100(n_train_per_class=8, n_test_per_class=2)
    return dict(list(t_cifar.task_splits(data).items())[:n])


def test_baselines_and_packnet_rows(tmp_path):
    """The individual-model baseline writes its goals file; PackNet runs
    with no piggymask on any task; PAE refuses a fixed capacity."""
    from cpg_tpu_torch.train.baselines import (run_packnet_sequence,
                                               run_pae_sequence,
                                               train_individual_baselines)
    from cpg_tpu_torch.train.sequence import SequenceConfig
    from cpg_tpu_torch.train.step import TrainConfig

    tasks = _tiny_tasks(2)
    cfg = TrainConfig(compute_dtype=torch.float32)
    acc_file = tmp_path / "goals.json"
    goals = train_individual_baselines(
        "vgg16_bn_cifar", dict(list(tasks.items())[:1]), cfg, epochs=1,
        batch_size=40, acc_file=str(acc_file), device="cpu")
    assert json.loads(acc_file.read_text()) == goals and len(goals) == 1
    seq = SequenceConfig(finetune_epochs=1, prune_epochs=1, retrain_epochs=1,
                         prune_ratios=(0.5,), batch_size=40, prune_freq=1,
                         max_width_mult=1.0)
    state, reports = run_packnet_sequence(
        "vgg16_bn_cifar", tasks, cfg, seq, width_mult=0.125, device="cpu")
    assert state.mask_mode == "packnet" and len(reports) == 2
    assert all(t.piggymask is None for t in state.tasks.values())
    with pytest.raises(ValueError, match="pack-AND-expand"):
        run_pae_sequence("vgg16_bn_cifar", tasks, cfg, seq, device="cpu")


def test_cli_sequence_runs_and_continues_from_a_checkpoint(tmp_path, capsys):
    argv = ["sequence", "--device", "cpu", "--num-tasks", "2",
            "--synthetic-train-per-class", "8",
            "--synthetic-test-per-class", "2", "--batch-size", "40",
            "--finetune-epochs", "1", "--prune-epochs", "1",
            "--retrain-epochs", "1", "--prune-ratios", "0.5",
            "--dtype", "float32", "--network_width_multiplier", "0.125",
            "--use-pallas-conv", "--fused-chain",
            "--record-dir", str(tmp_path / "rec")]
    assert t_cli.main(argv + ["--num-tasks", "1", "--checkpoint-dir",
                              str(tmp_path / "ck")]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [t["name"] for t in first["tasks"]] == ["aquatic_mammals"]
    ck = t_ckpt.latest_checkpoint(str(tmp_path / "ck"))
    assert ck.endswith("task01_aquatic_mammals")
    assert t_cli.main(argv + ["--init-from", ck]) == 0
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [t["name"] for t in second["tasks"]] == ["fish"]
    assert second["final_width_mult"] == 0.125
    assert (tmp_path / "rec" / "ratio_acc_fish.json").exists()


def test_on_device_leaves_a_state_in_place():
    """A state already on the device keeps its dicts and entries (the
    optimizers hold its tensors); `cuda` without an index matches any
    card index, and a state elsewhere is moved."""
    from cpg_tpu_torch.train.manager import _elsewhere, on_device

    _, ts = _states()
    shared, task = ts.shared, ts.tasks[2]
    on_device(ts, torch.device("cpu"))
    assert ts.shared is shared and ts.tasks[2] is task
    t = torch.empty(2, device="meta")
    assert _elsewhere(t, torch.device("cpu"))
    assert not _elsewhere(t, torch.device("meta"))
    on_card = SimpleNamespace(device=torch.device("cuda", 1))
    assert not _elsewhere(on_card, torch.device("cuda"))
    assert not _elsewhere(on_card, torch.device("cuda", 1))
    assert _elsewhere(on_card, torch.device("cuda", 0))
    on_device(ts, torch.device("meta"))
    assert ts.shared is not shared
    assert all(v.device.type == "meta" for v in ts.shared.values())


# ------------------------------------------------ the two cycle repairs ----

# (arch, dtype, fused chain, masked conv, width mult, input width, refused)
WIDTH_CASES = {
    "fused_bf16_wide": ("vgg16_bn_cifar", "bf16", True, False, 0.125, 160,
                        "128"),
    "fused_f32_wide": ("vgg16_bn_cifar", "f32", True, False, 0.125, 160,
                       "128"),
    "conv_bf16_wide": ("vgg16_bn_cifar", "bf16", False, True, 0.125, 160,
                       None),
    "vit_b16_224_conv": ("vit_b16", "bf16", False, True, 1.0, 224, None),
    "vit_b16_224_both": ("vit_b16", "bf16", True, True, 0.3, 224, None),
    "fused_bf16_off_8": ("vgg16_bn_cifar", "bf16", True, True, 0.1875, 32,
                         "multiples of 8"),
    "conv_bf16_on_4": ("vgg16_bn_cifar", "bf16", False, True, 0.1875, 32,
                       None),
    "conv_bf16_off_4": ("vgg16_bn_cifar", "bf16", False, True, 0.3, 32,
                        "multiples of 4"),
    "kernels_f32_off_grid": ("vgg16_bn_cifar", "f32", True, True, 0.3, 32,
                             None),
    "no_kernels_bf16": ("vgg16_bn_cifar", "bf16", False, False, 0.3, 32,
                        None),
    "fused_bf16_on_grid": ("vgg16_bn_cifar", "bf16", True, True, 1.5, 32,
                           None),
    "resnet50_224_both": ("resnet50", "bf16", True, True, 1.0, 224, None),
    "resnet50_224_grown": ("resnet50", "bf16", True, True, 1.5, 224, None),
    "resnet50_off_8": ("resnet50", "bf16", True, True, 0.3, 224,
                       "multiples of 8"),
    "resnet50_seam_wide": ("resnet50", "bf16", True, True, 1.0, 576, "128"),
}


@pytest.mark.parametrize("case", list(WIDTH_CASES))
def test_refuse_kernel_widths(case):
    """Each refusal is keyed to the flag and dtype that need it: a fused
    seam W <= 128 to the fused chain (any dtype; VGG16-BN's widest seam is
    the input's width, ResNet-50's a quarter of it: 56 at 224 px, 144 at
    576), channel multiples of 8 to the fused chain in bf16 and a Cout
    multiple of 4 to the masked conv in bf16; f32 steps and the ViTs'
    fixed-width patch conv are never refused."""
    from cpg_tpu_torch.train.sequence import refuse_kernel_widths
    from cpg_tpu_torch.train.step import TrainConfig

    arch, dt, fused, conv, mult, wd, refused = WIDTH_CASES[case]
    cfg = TrainConfig(compute_dtype={"bf16": torch.bfloat16,
                                     "f32": torch.float32}[dt],
                      use_fused_chain=fused, use_pallas_conv=conv)

    def call():
        refuse_kernel_widths(cfg, arch, [mult], (wd, wd, 3))

    if refused is None:
        call()
    else:
        with pytest.raises(ValueError, match=refused):
            call()


def _check_dense_widths(arch, mult, refused, model_kwargs=None):
    from cpg_tpu_torch.train.sequence import refuse_kernel_widths
    from cpg_tpu_torch.train.step import TrainConfig

    shape = t_models.get_model(arch)[1]
    refuse_kernel_widths(TrainConfig(compute_dtype=torch.float32,
                                     use_pallas=True), arch, [mult], shape,
                         model_kwargs)
    cfg = TrainConfig(use_pallas=True)
    if refused:
        with pytest.raises(ValueError, match="use_pallas needs multiples of 4"):
            refuse_kernel_widths(cfg, arch, [mult], shape, model_kwargs)
    else:
        refuse_kernel_widths(cfg, arch, [mult], shape, model_kwargs)


@pytest.mark.parametrize("arch,mult,refused", [
    ("textcls", 1.5, False), ("textcls", 1.01, True),
    ("vit_moe_cifar", 1.5, False), ("vit_moe_cifar", 1.001, True),
    ("vit_cifar", 1.5, False), ("vit_cifar", 1.001, True),
    ("vit_b16", 1.5, False), ("vit_b16", 1.001, True)])
def test_refuse_kernel_widths_dense_outputs(arch, mult, refused):
    """Under `use_pallas` in bf16 the transformers' dense outputs (heads x
    32 or 64, the MLP's hidden units: int(512 x 1.01) = 517 for textcls,
    int(1024 x 1.001) = 1025 for vit_moe_cifar and vit_cifar, int(3072 x
    1.001) = 3075 for vit_b16) must be multiples of 4; f32 steps are never
    refused."""
    _check_dense_widths(arch, mult, refused)


@pytest.mark.parametrize("arch,model_kwargs,refused", [
    ("vit_cifar", None, False), ("vit_cifar", {"dim": 36}, True),
    ("textcls", {"dim": 36, "vocab": 64}, True),
    ("vit_moe_cifar", {"dim": 36}, True),
    ("vit_moe_cifar", {"dim": 36, "heads": 9}, False)])
def test_refuse_kernel_widths_reads_model_kwargs(arch, model_kwargs, refused):
    """The transformers' dense widths follow the state's model_kwargs: at
    width 1.25 the default heads give 5 x 64 and 5 x 32 outputs, dim 36 on
    4 heads gives 5 x 9 = 45 (refused), on 9 heads 11 x 4 = 44."""
    _check_dense_widths(arch, 1.25, refused, model_kwargs)


def test_multi_draw_inits_take_a_fresh_generator_each():
    """`start_task(reinit_free=True)` and `grow_state` draw more than once;
    every draw equals a standalone `fw.init` (the port's own) from a fresh
    generator at the caller's seed, whatever was drawn before it."""
    from cpg_tpu_torch.models import framework as t_fw
    from cpg_tpu_torch.models import get_model as t_get_model
    from cpg_tpu_torch.train.sequence import (grow_state, init_state,
                                              start_task)

    arch, seed = "vgg16_bn_cifar", 11
    model_fn = t_get_model(arch)[0]
    x = torch.zeros((1, 32, 32, 3))

    def alone(nc, mult):
        return t_fw.init(torch.Generator().manual_seed(seed), model_fn, x,
                         num_classes=nc, mult=mult)

    state = init_state(arch, torch.Generator().manual_seed(0), 0.125,
                       device="cpu")
    start_task(state, "t1", 5, torch.Generator().manual_seed(1))
    state.shared, state.ownership = t_pruner.one_shot_prune(
        state.shared, state.ownership, 1, 0.5)
    g = torch.Generator().manual_seed(seed)
    torch.randn(7, generator=g)  # a used generator: its seed still rules
    start_task(state, "t2", 3, g, reinit_free=True)
    shared0, private0, _ = alone(3, 0.125)
    for k, v in private0.items():  # the call's second draw
        assert torch.equal(state.tasks[2].private[k], v), k
    for k, w in state.shared.items():
        fresh = (state.ownership[k] == 2) & (w != 0)
        assert torch.equal(w[fresh], shared0[k][fresh]), k

    draws = []

    def spy(gen, model_fn, sample_x, **kw):
        out = t_fw.init(gen, model_fn, sample_x, **kw)
        draws.append((kw["num_classes"], out))
        return out

    grown = grow_state(state, 0.25, g, device="cpu", init_fn=spy)
    assert [nc for nc, _ in draws] == [2, 5, 3]  # shared, then each task
    for nc, out in draws:
        for got, want in zip(out, alone(nc, 0.25)):
            for k in want:
                assert torch.equal(got[k], want[k]), (nc, k)
    shared1 = alone(2, 0.25)[0]
    for k, w in grown.shared.items():
        free = grown.ownership[k] == 0
        assert torch.equal(w[free], shared1[k][free]), k
