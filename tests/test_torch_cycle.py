"""The port's compact-pick-grow cycle against `cpg_tpu`'s, on the CPU.

VGG16-BN at width 0.125, f32, three synthetic CIFAR-100 tasks of 5 classes
(8 training images a class, one batch an epoch): pick 2 epochs, each prune
ratio 1 + 1 epochs with a prune event every step, task 3 given the
unreachable goal 1.01 so that it grows once, 0.125 -> 0.25. The JAX cycle
runs once (module fixture) on its default step; the port's cycle runs its
kernel step (`use_pallas_conv`, `use_fused_chain`: the plain versions on
the CPU) with `cpg_tpu`'s init trees and augmentation draws handed in
through the `init_fn` and `draws` seams.

Tolerances: per-layer owned counts, the chosen ratios, the growth count and
the width are equal exactly. Ownership is equal entry for entry except for
entries whose |w| lay within 1e-5 * max|w| of their layer's cutoff, in both
packages, at a prune event (the band; the test prints its size): the two
packages' f32 convolutions and BatchNorm reductions sum in different
orders, so such an entry's side of the cutoff is decided by that noise.
Final logits of every task: rtol 1e-4 (the train tests' loss tolerance),
atol 1e-5 (their logits are ~2e-2 in magnitude). The port's own invariants
are bit-exact: old-task logits across add-task and prune, grown channels
0, free entries 0, and a resume from the final checkpoints.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.core import pruner as j_pruner_mod
from cpg_tpu.data import augment as j_aug
from cpg_tpu.inference import predict as j_predict
from cpg_tpu.models import framework as j_fw
from cpg_tpu.models import get_model as j_get_model
from cpg_tpu.train.sequence import SequenceConfig as JSeq
from cpg_tpu.train.sequence import run_sequence as j_run_sequence
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu_torch.core import pruner as t_pruner_mod
from cpg_tpu_torch.core.invariants import check_state
from cpg_tpu_torch.data import augment as t_aug
from cpg_tpu_torch.data.cifar import synthetic_cifar100, task_splits
from cpg_tpu_torch.inference import predict
from cpg_tpu_torch.models import get_model
from cpg_tpu_torch.ops.masked import effective_params
from cpg_tpu_torch.train import sequence as t_seq
from cpg_tpu_torch.train.manager import Manager
from cpg_tpu_torch.train.sequence import (SequenceConfig, grow_state,
                                          init_state, run_sequence,
                                          start_task)
from cpg_tpu_torch.train.step import TrainConfig
from cpg_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)
ARCH = "vgg16_bn_cifar"
LR = 2e-3
SEQ = dict(finetune_epochs=2, prune_epochs=1, retrain_epochs=1,
           prune_ratios=(0.5, 0.75), batch_size=40, prune_freq=1,
           growth_step=0.125, max_width_mult=0.25, seed=0, lr=LR)
KERNELS = dict(use_pallas_conv=True, use_fused_chain=True)
BAND = 1e-5


def _tasks():
    data = synthetic_cifar100(n_train_per_class=8, n_test_per_class=4, seed=0)
    return dict(list(task_splits(data).items())[:3])


TASKS = _tasks()
NAMES = list(TASKS)
GOALS = {NAMES[2]: 1.01}


def jax_init(gen, model_fn, sample_x, **kw):
    """The init seam: `cpg_tpu`'s `fw.init` under the key the JAX cycle
    uses at this point (`PRNGKey(seed)`, the port's generator's seed)."""
    out = j_fw.init(jax.random.PRNGKey(gen.initial_seed()),
                    j_get_model(ARCH)[0], jnp.zeros(tuple(sample_x.shape)),
                    **kw)
    return tuple({k: torch.from_numpy(np.array(v)) for k, v in t.items()}
                 for t in out)


def jax_draws(seed):
    """The draws seam: the crop offsets and flips the JAX Manager's
    augmentation takes at each step (its key split once a step)."""
    key = [jax.random.PRNGKey(seed)]

    def draw(n):
        key[0], sub = jax.random.split(key[0])
        kc, kf = jax.random.split(sub)
        offs = jax.random.randint(kc, (n, 2), 0, 9)
        flips = jax.random.bernoulli(kf, 0.5, (n, 1, 1, 1))
        return np.array(offs), np.array(flips).reshape(n)

    return draw


def _record(w, own, tid, own_after):
    """One layer of a prune event: the owned |w| near the cutoff."""
    w, own, own_after = (np.array(a) for a in (w, own, own_after))
    owned = own == tid
    removed = owned & (own_after == 0)
    if not removed.any():
        return None
    cut = np.abs(w[removed]).max()
    return owned & (np.abs(np.abs(w) - cut) <= BAND * np.abs(w).max())


@pytest.fixture(scope="module")
def jax_run():
    events = []
    orig = j_pruner_mod.gradual_prune

    def spy(shared, ownership, task_id, target, n0):
        out = orig(shared, ownership, task_id, target, n0)
        events.append({k: _record(shared[k], ownership[k], task_id,
                                  out[1][k]) for k in shared})
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pruner_mod, "gradual_prune", spy)
        state, reports = j_run_sequence(
            ARCH, TASKS, JConfig(compute_dtype=jnp.float32, lr=LR),
            JSeq(**SEQ, verify_growth=False), goals=GOALS,
            augment_fn=j_aug.cifar_train_augment,
            preprocess_fn=j_aug.cifar_eval_preprocess, width_mult=0.125)
    return state, reports, events


def _port(ckdir):
    return run_sequence(
        ARCH, TASKS, TrainConfig(compute_dtype=torch.float32, lr=LR,
                                 **KERNELS),
        SequenceConfig(**SEQ, checkpoint_dir=str(ckdir)), goals=GOALS,
        augment_fn=t_aug.cifar_train_augment,
        preprocess_fn=t_aug.cifar_eval_preprocess, width_mult=0.125,
        device="cpu", init_fn=jax_init, draws=jax_draws)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's cycle with checkpoints; the phase checkpoints (`.pick`)
    are kept, as a crash before the final save would keep them."""
    ckdir = tmp_path_factory.mktemp("cycle")
    events = []
    orig = t_pruner_mod.gradual_prune_

    def spy(shared, ownership, task_id, target, n0):
        before = {k: (shared[k].clone(), ownership[k].clone())
                  for k in shared}
        orig(shared, ownership, task_id, target, n0)
        events.append({k: _record(*before[k], task_id, ownership[k])
                       for k in shared})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_pruner_mod, "gradual_prune_", spy)
        mp.setattr(t_seq, "remove_after_save", lambda path: None)
        state, reports = _port(ckdir)
    return state, reports, events, ckdir


def _x(name):
    return TASKS[name]["test_x"]


def _logits(state, tid):
    x = t_aug.cifar_eval_preprocess(torch.from_numpy(_x(state.tasks[tid].name)))
    return predict(state, tid, x, device="cpu")


def _embed(mask, shape):
    out = np.zeros(shape, bool)
    out[tuple(slice(0, s) for s in mask.shape)] = mask
    return out


def test_cycle_matches_jax(jax_run, port_run):
    jst, jrep, jev = jax_run
    tst, trep, tev, _ = port_run
    assert [r.name for r in trep] == [r.name for r in jrep] == NAMES
    for j, t in zip(jrep, trep):
        assert (t.chosen_ratio, t.grew, t.width_mult) == (
            j.chosen_ratio, j.grew, j.width_mult), t.name
    assert (trep[2].grew, tst.width_mult) == (1, jst.width_mult) == (1, 0.25)
    assert trep[2].growth_audit  # the port's audit ran on both old tasks
    # the same prune events, in order
    assert len(tev) == len(jev) > 0
    band_total = mismatch_total = 0
    for k in jst.shared:
        jo, to = np.asarray(jst.ownership[k]), tst.ownership[k].numpy()
        assert jo.shape == to.shape, k
        for tid in range(0, 4):
            assert int((to == tid).sum()) == int((jo == tid).sum()), (k, tid)
        band = np.zeros(jo.shape, bool)
        for je, te in zip(jev, tev):
            if je[k] is not None and te[k] is not None:
                band |= _embed(je[k] & te[k], jo.shape)
        off = jo != to
        assert not (off & ~band).any(), (k, int((off & ~band).sum()))
        band_total += int(band.sum())
        mismatch_total += int(off.sum())
        jw, tw = np.asarray(jst.shared[k]), tst.shared[k].numpy()
        np.testing.assert_allclose(tw[~off], jw[~off], rtol=1e-4, atol=5e-5,
                                   err_msg=k)
    n = sum(v.numel() for v in tst.ownership.values())
    print(f"\nownership: {mismatch_total} of {n} entries differ, all inside "
          f"the cutoff band of {band_total} entries")
    assert mismatch_total <= 1e-3 * n
    for tid in jst.tasks:
        x = _x(jst.tasks[tid].name)
        want = np.asarray(j_predict(jst, tid, j_aug.cifar_eval_preprocess(
            jnp.asarray(x))))
        np.testing.assert_allclose(_logits(tst, tid).numpy(), want,
                                   rtol=1e-4, atol=1e-5, err_msg=str(tid))


def _ck(ckdir, tid, suffix=""):
    return load_state(os.path.join(ckdir, f"task{tid:02d}_{NAMES[tid - 1]}"
                                   + suffix), device="cpu")


def test_old_task_logits_bit_exact_across_add_task_and_prune(port_run):
    """Task 1's logits after its compaction, after task 2's pick (add-task)
    and after task 2's compaction (prune) are the same bits; tasks 1 and 2
    across task 3's compaction at the grown width too."""
    _, _, _, ckdir = port_run
    t1 = _logits(_ck(ckdir, 1), 1)
    for st in (_ck(ckdir, 2, ".pick"), _ck(ckdir, 2)):
        assert torch.equal(_logits(st, 1), t1)
    grown, final = _ck(ckdir, 3, ".pick"), _ck(ckdir, 3)
    assert grown.width_mult == final.width_mult == 0.25
    for tid in (1, 2):
        assert torch.equal(_logits(final, tid), _logits(grown, tid))


def test_growth_keeps_old_tasks(port_run):
    """After growth: old-task logits within the audit's bound, and every
    grown channel inert for the old tasks: effective weights 0 outside the
    old block, BN padding (1, 0, 0, 1), head rows 0."""
    state, reports, _, ckdir = port_run
    audit = reports[2].growth_audit
    assert [a["task_id"] for a in audit] == [1, 2]
    for a in audit:
        assert a["width_mult"] == 0.25 and a["max_abs_diff"] <= a["bound"]
    before, after = _ck(ckdir, 2), _ck(ckdir, 3)
    for tid in (1, 2):
        np.testing.assert_allclose(_logits(after, tid), _logits(before, tid),
                                   rtol=1e-2, atol=1e-3)
        old, new = before.tasks[tid], after.tasks[tid]
        eff = effective_params(after.shared, after.ownership, new.piggymask,
                               tid, after.threshold)
        for k, w in eff.items():
            inner = _embed(np.ones(before.shared[k].shape, bool), w.shape)
            assert not w.numpy()[~inner].any(), (tid, k)
        for tree_old, tree_new in ((old.private, new.private),
                                   (old.bn_state, new.bn_state)):
            for k, v in tree_new.items():
                inner = _embed(np.ones(tree_old[k].shape, bool), v.shape)
                fill = {"scale": 1.0, "var": 1.0}.get(k.rsplit("/", 1)[-1],
                                                      0.0)
                assert (v.numpy()[~inner] == fill).all(), (tid, k)
                assert torch.equal(v[tuple(slice(0, s) for s in
                                           tree_old[k].shape)], tree_old[k])


def test_check_state_and_free_zeros_at_every_boundary(port_run):
    state, _, _, ckdir = port_run
    for st in (_ck(ckdir, 1), _ck(ckdir, 2, ".pick"), _ck(ckdir, 2),
               _ck(ckdir, 3, ".pick"), _ck(ckdir, 3), state):
        assert check_state(st) == []
        for k, own in st.ownership.items():
            assert not st.shared[k][own == 0].any(), k


def test_resume_from_final_checkpoints_reproduces_the_state(port_run,
                                                            monkeypatch):
    state, reports, _, ckdir = port_run
    monkeypatch.setattr(Manager, "train", lambda *a, **k: pytest.fail(
        "a resumed task trained"))
    again, rep2 = _port(ckdir)
    assert [r.chosen_ratio for r in rep2] == [r.chosen_ratio for r in reports]
    _assert_same_state(again, state)


def _assert_same_state(a, b):
    assert (a.arch, a.width_mult, a.num_tasks) == (b.arch, b.width_mult,
                                                   b.num_tasks)
    trees = [(a.shared, b.shared), (a.ownership, b.ownership)]
    for tid in a.tasks:
        ta, tb = a.tasks[tid], b.tasks[tid]
        trees += [(ta.private, tb.private), (ta.bn_state, tb.bn_state),
                  (ta.piggymask or {}, tb.piggymask or {})]
    for x, y in trees:
        assert sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_resume_from_pick_checkpoint(port_run, tmp_path, monkeypatch):
    """With task 3's final checkpoint gone, a rerun re-enters task 3's
    compact walk from its `.pick` checkpoint (no pick epochs), starts from
    that state bit for bit, and two such resumes end in the same state."""
    state, reports, _, ckdir = port_run
    pick = _ck(ckdir, 3, ".pick")
    seen, starts = [], []
    orig_train, orig_compact = Manager.train, t_seq._compact

    def spy_train(self, epochs, **kw):
        seen.append(epochs)
        return orig_train(self, epochs, **kw)

    def spy_compact(state, *a, **k):
        starts.append(t_seq.snapshot(state))
        return orig_compact(state, *a, **k)

    monkeypatch.setattr(Manager, "train", spy_train)
    monkeypatch.setattr(t_seq, "_compact", spy_compact)
    finals = []
    for i in range(2):
        d = tmp_path / f"resume{i}"
        shutil.copytree(ckdir, d)
        shutil.rmtree(d / f"task03_{NAMES[2]}")
        st, rep = _port(d)
        assert rep[2].pick_acc == reports[2].pick_acc
        assert rep[2].grew == 1 and st.width_mult == 0.25
        assert not (d / f"task03_{NAMES[2]}.pick").exists()
        finals.append(st)
    assert seen and all(e == 2 for e in seen), seen
    for s in starts:
        _assert_same_state(s, pick)
    _assert_same_state(finals[0], finals[1])
    assert check_state(finals[0]) == []


def test_prune_event_writes_into_the_live_tensors():
    """The in-place trap: a prune event in the middle of a phase, then a
    step, must change the tensors that `state.shared` and the optimizer
    hold (an event that replaced them would leave the steps updating
    orphans)."""
    g = torch.Generator().manual_seed(3)
    state = init_state(ARCH, g, 0.125, device="cpu")
    start_task(state, NAMES[0], 5, g)
    mgr = Manager(state, get_model(ARCH)[0], 1, TASKS[NAMES[0]],
                  TrainConfig(compute_dtype=torch.float32, **KERNELS),
                  batch_size=8, device="cpu")
    live = dict(state.shared)
    opt_params = {id(p) for grp in mgr.opt_w_state.param_groups
                  for p in grp["params"]}
    snaps = []
    orig = t_pruner_mod.gradual_prune_

    def spy(shared, ownership, *a):
        orig(shared, ownership, *a)
        snaps.append({k: v.clone() for k, v in shared.items()})

    mp = pytest.MonkeyPatch()
    mp.setattr(t_pruner_mod, "gradual_prune_", spy)
    try:
        mgr.train(1, prune_to=0.5, prune_freq=2, prune_end_frac=0.6)
    finally:
        mp.undo()
    assert len(snaps) >= 3  # events at steps 0 and 2, the forced one, the net
    for k, w in state.shared.items():
        assert w is live[k] and id(w) in opt_params, k
    # a step after the first event moved the live weights past that event's
    k = "features/conv3/kernel"
    assert not torch.equal(snaps[0][k], live[k])
    own = state.ownership[k]
    assert not live[k][own == 0].any() and (own == 0).float().mean() >= 0.49


def test_manager_one_shot_prune_writes_into_the_live_tensors():
    """`Manager.one_shot_prune` prunes the live tensors in place, bit for
    bit as `cpg_tpu`'s out-of-place `one_shot_prune`."""
    g = torch.Generator().manual_seed(4)
    state = init_state(ARCH, g, 0.125, device="cpu")
    start_task(state, NAMES[0], 5, g)
    mgr = Manager(state, get_model(ARCH)[0], 1, TASKS[NAMES[0]],
                  TrainConfig(compute_dtype=torch.float32, **KERNELS),
                  batch_size=8, device="cpu")
    live, live_own = dict(state.shared), dict(state.ownership)
    want_w, want_own = j_pruner_mod.one_shot_prune(
        {k: v.numpy().copy() for k, v in live.items()},
        {k: v.numpy().copy() for k, v in live_own.items()}, 1, 0.5)
    mgr.one_shot_prune(0.5)
    for k in live:
        assert state.shared[k] is live[k], k
        assert state.ownership[k] is live_own[k], k
        np.testing.assert_array_equal(live[k].numpy(), np.asarray(want_w[k]))
        np.testing.assert_array_equal(live_own[k].numpy(),
                                      np.asarray(want_own[k]))


@pytest.mark.parametrize("case", ["wide_input", "growth_step", "start_width",
                                  "init_state", "grow_state"])
def test_kernel_widths_refused_up_front(case):
    """With the conv kernels on, widths they would reject mid-cycle are
    refused before any training: an input wider than 128 and width
    multipliers off the 1/8 grid. Without the kernels they are taken."""
    cfg = TrainConfig(compute_dtype=torch.float32, **KERNELS)
    seq = SequenceConfig(**SEQ)
    g = torch.Generator().manual_seed(0)
    calls = {
        "wide_input": lambda c: run_sequence(
            ARCH, TASKS, c, seq, batch_hw=(32, 160, 3), width_mult=0.125,
            device="cpu"),
        "growth_step": lambda c: run_sequence(
            ARCH, TASKS, c, dataclasses.replace(seq, growth_step=0.1),
            width_mult=0.125, device="cpu"),
        "start_width": lambda c: run_sequence(
            ARCH, TASKS, c, seq, width_mult=0.3, device="cpu"),
        "init_state": lambda c: init_state(ARCH, g, 0.3, device="cpu",
                                           cfg=c),
        "grow_state": lambda c: grow_state(
            init_state(ARCH, g, 0.125, device="cpu"), 0.2, g, device="cpu",
            cfg=c),
    }
    trained = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Manager, "train", lambda *a, **k: trained.append(1))
        with pytest.raises(ValueError, match="128|1/8 grid"):
            calls[case](cfg)
    assert not trained
    if case in ("init_state", "grow_state"):
        calls[case](TrainConfig(compute_dtype=torch.float32))
