"""The port's model axis (cpg_tpu_torch/parallel/*) against `cpg_tpu`, on
the CPU.

Two gloo worlds of CPU ranks are spawned once for the module
(tests/torch_dist_worker.py, a file store under tmp_path): one of 4 ranks
as (data=2, model=2) and one of 2 as (data=1, model=2), and
`sequence --parallel 2 --parallel-model 2 --device cpu` runs as a user
runs it (a subprocess spawning its 4 ranks); the JAX references are
computed here meanwhile, `cpg_tpu`'s on its 8 fake devices where they need
a mesh. Every state is built from a numpy seed and carried into both
packages. Tolerances are `tests/test_parallel_tp.py`'s: a step's loss
rtol 1e-5, its shared and piggymask updates rtol 3e-4 / atol 3e-6; a
Manager's accuracy atol 1e-6 and loss rtol 1e-4; a cycle's accuracies atol
1e-6 with the same chosen ratios, weights rtol 5e-3 / atol 1e-4 and
ownership agreement above 0.995. The checks:

  * `shared_shardings` key by key against `cpg_tpu`'s (VGG16-BN at width
    0.125, a small vit_cifar, vit_moe_cifar's experts on axis 0, a grown
    vit_moe_cifar whose experts no longer divide, and a kernel that does
    not divide, which stays replicated);
  * the split train step (tiny_cnn; VGG16-BN at width 0.125, task 2,
    default and kernel flags, `cpg_tpu`'s draws; vit_cifar, default and
    kernel flags; textcls; vit_moe_cifar, its experts split) against
    `cpg_tpu`'s single-device step and the port's one-process step, each
    rank holding half of every divisible kernel, ownership, piggymask and
    optimizer moment (VGG16-BN's loss and piggymasks against `cpg_tpu`
    looser, with the measured reason in the test); the negative control
    (`to_model_group`'s backward made the identity) must miss;
  * `Manager(mesh=)` over (2,2) against `cpg_tpu`'s Manager over (2,2);
  * `run_sequence` over (2,2) against `cpg_tpu`'s single-device cycle, its
    checkpoints in the one-process format, a rerun resumed bit-equal and a
    Manager re-splitting the last checkpoint;
  * the pruner on split layers bit-equal to one process (and `cpg_tpu`);
  * the CLI over 2 x 2 CPU ranks against the one-process command, and the
    server over a mesh with a model axis.
"""

import contextlib
import io
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.core import pruner as j_pruner
from cpg_tpu.core.pruner import one_shot_prune as j_one_shot_prune
from cpg_tpu.data import augment as j_aug
from cpg_tpu.models import framework as j_fw
from cpg_tpu.models import get_model as j_get_model
from cpg_tpu.parallel import mesh as j_mesh
from cpg_tpu.train.manager import Manager as JManager
from cpg_tpu.train.sequence import SequenceConfig as JSeq
from cpg_tpu.train.sequence import init_state as j_init_state
from cpg_tpu.train.sequence import run_sequence as j_run_sequence
from cpg_tpu.train.sequence import start_task as j_start_task
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu_torch import cli
from cpg_tpu_torch.core import pruner as t_pruner
from cpg_tpu_torch.data.augment import cifar_eval_preprocess as prep
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.models import get_model as t_get_model
from cpg_tpu_torch.parallel import distributed as t_dist
from cpg_tpu_torch.parallel import mesh as t_mesh
from cpg_tpu_torch.serve import TaskServer
from cpg_tpu_torch.train import sequence as t_seq
from cpg_tpu_torch.utils.checkpoint import load_state

from . import torch_dist_worker as W
from .helpers import norm_augment, normalize01, synthetic_task, tiny_cnn
from .test_torch_port_parallel import (MULT, NC, VIT, _jax_draws, _jax_steps,
                                       _plain, _port_state, _vgg_state)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 3e-4, 3e-6  # tests/test_parallel_tp.py's
TXT = dict(depth=2, dim=64, heads=2, vocab=64)
MOE = dict(depth=2, dim=64, heads=2, patch=8, n_experts=4)
SEQ = dict(finetune_epochs=4, prune_epochs=1, retrain_epochs=1,
           prune_ratios=(0.3,), batch_size=32, lr=0.05, prune_freq=5,
           seed=0, lr_schedule="constant")
CLI_ARGV = ["sequence", "--num-tasks", "2", "--network_width_multiplier",
            "0.125", "--synthetic-train-per-class", "8",
            "--synthetic-test-per-class", "4", "--batch-size", "8",
            "--finetune-epochs", "1", "--prune-epochs", "1",
            "--retrain-epochs", "0", "--prune-ratios", "0.5",
            "--allow_acc_diff", "1.0", "--dtype", "float32",
            "--lr-schedule", "constant", "--use-pallas-conv", "--fused-chain",
            "--device", "cpu"]
CLI_FINAL = "task02_fish"


def _tp_state():
    """`tests/test_parallel_tp.py`'s state: task 1 half pruned, task 2."""
    st = j_init_state("tiny_cnn", jax.random.PRNGKey(0))
    j_start_task(st, "a", 4, jax.random.PRNGKey(1))
    st.shared, st.ownership = j_one_shot_prune(st.shared, st.ownership, 1,
                                               jnp.float32(0.5))
    j_start_task(st, "b", 3, jax.random.PRNGKey(2))
    return _plain(st)


def _tp_data():
    data = synthetic_task(0)
    return dict(data, train_y=data["train_y"] % 3, test_y=data["test_y"] % 3,
                num_classes=3)


def _cycle_tasks():
    return {"t1": synthetic_task(0), "t2": synthetic_task(5, num_classes=3)}


def _cycle_inits():
    """`cpg_tpu`'s init trees for the cycle's three draws (the state, then
    each task's head), keyed as the port's `init_fn` seam asks."""
    out = {}
    for seed, nc in ((0, 2), (1, 4), (2, 3)):
        trees = j_fw.init(jax.random.PRNGKey(seed), tiny_cnn,
                          jnp.zeros((1, 16, 16, 3)), num_classes=nc, mult=1.0)
        out[(seed, nc, 1.0)] = tuple({k: np.array(v) for k, v in t.items()}
                                     for t in trees)
    return out


def _prune_layers(seed=3):
    """Two layers, one split (its last axis even) and one replicated (odd),
    with ties at every magnitude: quantised weights."""
    rng = np.random.RandomState(seed)
    w = {k: (np.round(rng.randn(*s) * 8) / 8).astype(np.float32)
         for k, s in (("a/kernel", (3, 3, 4, 8)), ("b/kernel", (6, 5)))}
    own = {k: rng.choice([0, 1, 2], p=[0.2, 0.3, 0.5], size=v.shape)
           .astype(np.int8) for k, v in w.items()}
    n0 = {k: int((v == 2).sum()) for k, v in own.items()}
    return w, own, n0


PRUNE_TARGETS = (0.25, 0.5)


def _owned(state, seed=1):
    """`_port_state` given task-2 entries to train: random ownership with
    free entries and task 2's piggymask at least 2e-3 from the threshold,
    as `_vgg_state` (a fresh task 2 owns nothing of an unpruned state)."""
    rng = np.random.RandomState(seed)
    state["ownership"] = {k: rng.choice([0, 1, 2], p=[0.1, 0.45, 0.45],
                                        size=w.shape).astype(np.int8)
                          for k, w in state["shared"].items()}
    state["tasks"][2]["piggymask"] = {
        k: np.where(rng.uniform(size=w.shape) < 0.7,
                    rng.uniform(0.007, 0.03, w.shape),
                    rng.uniform(-0.02, 0.003, w.shape)).astype(np.float32)
        for k, w in state["shared"].items()}
    return state


def _pool_gaps(state, x, draws):
    """The smallest gap between the two largest entries of a 2x2 max-pool
    window (its largest positive, the two not equal) at each of VGG16-BN's
    five pools in the port's train-mode forward of task 2: where it is
    within f32 rounding, summation order decides which entry the pool's
    gradient reaches."""
    from cpg_tpu_torch.core.state import state_from_numpy
    from cpg_tpu_torch.data.augment import cifar_train_augment
    from cpg_tpu_torch.models import vgg as t_vgg
    from cpg_tpu_torch.ops.masked import effective_params

    st = state_from_numpy(W.np_state(state), "cpu")
    t2, seen, pool = st.tasks[2], [], t_vgg.maxpool

    def spy(v):
        seen.append(v)
        return pool(v)

    t_vgg.maxpool = spy
    try:
        with torch.no_grad():
            t_fw.apply(t_vgg.vgg16_bn_cifar, effective_params(
                st.shared, st.ownership, t2.piggymask, 2, st.threshold),
                t2.private, t2.bn_state,
                cifar_train_augment(torch.from_numpy(x), draws), train=True,
                compute_dtype=torch.float32, num_classes=NC,
                mult=st.width_mult)
    finally:
        t_vgg.maxpool = pool
    out = []
    for y in seen:
        n, h, w, c = y.shape
        top = (y.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
               .reshape(-1, 4).sort(dim=1, descending=True).values)
        gap = top[:, 0] - top[:, 1]
        out.append(float(gap[(top[:, 0] > 0) & (gap > 0)].min()))
    return out


def _vgg_batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8),
            rng.randint(0, NC, 8))


def _jobs(tmp):
    data = _tp_data()
    tiny = _tp_state()
    x, y = data["train_x"][:32], data["train_y"][:32]
    vgg = _vgg_state()
    key = jax.random.PRNGKey(20)
    # VGG16-BN's batch: RandomState(10); RandomState(9)'s (the data-parallel
    # tests') holds a max-pool near-tie (test_vgg_default_gap_...)
    vx, vy = _vgg_batch(10)
    draws = _jax_draws(key, 8)
    kernels = dict(use_pallas_conv=True, use_fused_chain=True)
    tokens = np.random.RandomState(9).randint(0, 64, (8, 16))
    w, own, n0 = _prune_layers()
    job4 = {
        "tiny": ("step", dict(state=tiny, tid=2, batches=[(x, y, None, 0)],
                              tp=True, control=True)),
        "manager": ("tp_manager", dict(state=tiny, data=data, epochs=1)),
        "sequence": ("tp_sequence", dict(tasks=_cycle_tasks(),
                                         ckdir=str(tmp / "ck"), seq_kw=SEQ,
                                         inits=_cycle_inits())),
    }
    states = {"vgg": vgg, "vit": _owned(_port_state("vit_cifar", VIT)),
              "textcls": _owned(_port_state("textcls", TXT, (16,),
                                            {"causal": True})),
              "moe": _owned(_port_state("vit_moe_cifar", MOE))}
    images = [(vx, vy, draws, 0)]
    step = dict(tid=2, lr=2e-3, tp=True, single=True)
    job2 = {
        "vgg_default": ("step", dict(state=vgg, batches=images, **step)),
        "vgg_kernels": ("step", dict(state=vgg, batches=images,
                                     flags=kernels, **step)),
        "vit": ("step", dict(state=states["vit"], batches=images, **step)),
        "vit_kernels": ("step", dict(
            state=states["vit"], batches=images, **step,
            flags=dict(use_pallas=True, flash_attention=True))),
        "textcls": ("step", dict(state=states["textcls"],
                                 batches=[(tokens, vy, None, 0)], **step)),
        "moe": ("step", dict(state=states["moe"], batches=images, **step)),
        "prune": ("prune", dict(w=w, own=own, tid=2, targets=PRUNE_TARGETS,
                                n0=n0, ratio=0.3)),
    }
    refs = dict(tiny=tiny, x=x, y=y, states=states, key=key, vx=vx, vy=vy,
                tokens=tokens, data=data, prune=(w, own, n0))
    return {(4, 2): job4, (2, 2): job2}, refs


def _cli_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="4", PYTHONPATH=ROOT)
    return env


def _references(r):
    cfg = JConfig(lr=0.05, compute_dtype=jnp.float32)
    aug = lambda v, k: normalize01(v)  # noqa: E731
    out = {"tiny": _jax_steps(r["tiny"], [(r["x"], r["y"], None, 0)], cfg,
                              tiny_cnn, tid=2, augment=aug)}
    # cpg_tpu's one-device step on each model-axis arch's state and batch
    images = [(r["vx"], r["vy"], r["key"], 0)]
    for name, st in r["states"].items():
        text = name == "textcls"
        out[name] = _jax_steps(
            st, [(r["tokens"], r["vy"], r["key"], 0)] if text else images,
            JConfig(lr=2e-3, compute_dtype=jnp.float32),
            j_get_model(st["arch"])[0], tid=2,
            augment=(lambda v, k: v) if text else j_aug.cifar_train_augment)
    # cpg_tpu's Manager over (data=2, model=2) on its fake devices
    from cpg_tpu.core.state import CPGState as JState
    from cpg_tpu.core.state import TaskEntry as JTask

    def jstate(s):
        return JState(arch=s["arch"], width_mult=s["width_mult"],
                      shared=dict(s["shared"]), ownership=dict(s["ownership"]),
                      tasks={t: JTask(**v) for t, v in s["tasks"].items()})

    st = jstate(r["tiny"])
    mesh = j_mesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    res = JManager(st, tiny_cnn, 2, r["data"], cfg, batch_size=32,
                   augment_fn=norm_augment, seed=5, lr_schedule="constant",
                   mesh=mesh).train(1)
    out["manager"] = dict(acc=res.acc, loss=res.loss, steps=res.steps,
                          shared={k: np.asarray(v)
                                  for k, v in st.shared.items()},
                          piggymask={k: np.asarray(v) for k, v in
                                     st.tasks[2].piggymask.items()})
    s1, reps = j_run_sequence("tiny_cnn", _cycle_tasks(), cfg, JSeq(**SEQ),
                              augment_fn=norm_augment,
                              preprocess_fn=normalize01)
    out["sequence"] = dict(
        reports=[(p.pick_acc, p.final_acc, p.chosen_ratio) for p in reps],
        shared={k: np.asarray(v) for k, v in s1.shared.items()},
        ownership={k: np.asarray(v) for k, v in s1.ownership.items()})
    w, own, n0 = r["prune"]
    sh, ow = dict(w), dict(own)
    events = []
    for t in PRUNE_TARGETS:
        sh, ow = j_pruner.gradual_prune(sh, ow, 2, t, n0)
        events.append({f"w/{k}": np.asarray(v) for k, v in sh.items()})
    out["prune"] = events
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_worlds")
    jobs, refs = _jobs(tmp)
    env = _cli_env()
    env["OMP_NUM_THREADS"] = "1"
    procs = {}
    for (world, n_model), job in jobs.items():
        d = tmp / f"w{world}"
        d.mkdir()
        with open(d / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
             str(r), str(world), str(d / "store"), str(d / "job.pkl"), str(d),
             str(n_model)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    ref = _references(refs)
    out = {}
    for world, ps in procs.items():
        logs = [p.communicate(timeout=900)[0] for p in ps]
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"rank {r}/{world}:\n{logs[r][-4000:]}"
        out[world] = []
        for r in range(world):
            with open(tmp / f"w{world}" / f"rank{r}.pkl", "rb") as f:
                out[world].append(pickle.load(f))
    return out, ref, refs


@pytest.fixture(scope="module")
def cli_runs(worlds, tmp_path_factory):
    """`sequence --parallel 2 --parallel-model 2` (its 4 ranks spawned by
    the command) and the one-process command, after the worlds."""
    tmp = tmp_path_factory.mktemp("tp_cli")
    spawned = subprocess.Popen(
        [sys.executable, "-m", "cpg_tpu_torch", *CLI_ARGV, "--parallel", "2",
         "--parallel-model", "2", "--checkpoint-dir", str(tmp / "tp")],
        cwd=str(tmp), env=_cli_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([*CLI_ARGV, "--checkpoint-dir", str(tmp / "p0")]) == 0
    out = {"p0": json.loads(buf.getvalue().strip().splitlines()[-1])}
    stdout, stderr = spawned.communicate(timeout=600)
    assert spawned.returncode == 0, stderr[-4000:]
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, stdout  # rank 0 alone prints the summary
    out["tp"] = json.loads(lines[0])
    states = {k: load_state(str(tmp / k / CLI_FINAL), device="cpu")
              for k in ("p0", "tp")}
    return out, states


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _assert_step_matches(got, ref, what, rtol=RTOL, atol=ATOL,
                         loss_rtol=1e-5, groups=("shared", "piggymask")):
    _close(got["losses"], ref["losses"], f"{what} loss", loss_rtol, 0)
    for group in groups:
        for k, v in (ref[group] or {}).items():
            _close(got[group][k], v, f"{what} {group}/{k}", rtol, atol)


def _halves(held, split, what):
    """Every split kernel held as its half along its axis, the rest
    whole."""
    assert split, what
    for k, shape in held.items():
        if k in split:
            axis, size = split[k]
            assert shape[axis] * 2 == size, (what, k, shape, split[k])


# ------------------------------------------------------------ shardings

def _axis_of(spec):
    """The axis a `cpg_tpu` PartitionSpec puts on "model", or None."""
    axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    return axes[0] if axes else None


def _shared_tree(arch, mult=1.0, **kw):
    model_fn, in_shape = t_get_model(arch)
    shared, _, _ = t_fw.init(torch.Generator().manual_seed(0), model_fn,
                             torch.zeros((1, *in_shape)), num_classes=NC,
                             mult=mult, **kw)
    return shared


@pytest.mark.parametrize("case", ["vgg", "vit", "moe", "moe_grown", "odd"])
def test_shared_shardings_match_jax(case):
    """Key by key, the axis the port splits along (or none) is the one
    `cpg_tpu`'s spec puts on the model axis, on (2,2) and (2,4) meshes."""
    shared = {
        "vgg": lambda: _shared_tree("vgg16_bn_cifar", MULT),
        "vit": lambda: _shared_tree("vit_cifar", **VIT),
        "moe": lambda: _shared_tree("vit_moe_cifar", **MOE),
        "moe_grown": lambda: _shared_tree("vit_moe_cifar", 1.5, **MOE),
        "odd": lambda: {"a/kernel": torch.zeros(3, 3, 4, 6),
                        "b/kernel": torch.zeros(3, 3, 4, 5),
                        "c/experts/fc1/kernel": torch.zeros(3, 8, 8)},
    }[case]()
    for n_model in (2, 4):
        tm = t_mesh.make_mesh(n_model=n_model,
                              devices=[torch.device("cpu")] * 8)
        jm = j_mesh.make_mesh(n_model=n_model)
        got = t_mesh.shared_shardings(tm, shared, model_sharded=True)
        want = j_mesh.shared_shardings(
            jm, {k: jnp.zeros(tuple(v.shape)) for k, v in shared.items()},
            model_sharded=True)
        assert sorted(got) == sorted(want)
        for k, spec in got.items():
            axis = None if spec is None else spec.axis
            assert axis == _axis_of(want[k].spec), (case, n_model, k)
            if spec is not None:
                assert spec.size == shared[k].shape[axis]
                assert spec.parts == n_model and spec.width * n_model == spec.size
        assert all(v is None for v in t_mesh.shared_shardings(
            tm, shared).values())
    if case == "moe":
        assert got["blocks/1/moe/experts/fc1/kernel"].axis == 0
    if case == "moe_grown":  # 6 experts: over 4 ranks split along F and D
        assert got["blocks/1/moe/experts/fc1/kernel"].axis == 2
    if case == "odd":
        assert got["b/kernel"] is None and got["a/kernel"] is None
        assert got["c/experts/fc1/kernel"].axis == 2


def test_model_axis_meshes_match_jax():
    devs = [torch.device("cpu")] * 8
    for kw in ({"n_model": 2}, {"n_model": 4}, {"n_data": 2, "n_model": 2},
               {"n_model": 2, "n_dcn": 2}):
        got, want = t_mesh.make_mesh(devices=devs, **kw), j_mesh.make_mesh(**kw)
        assert got.axis_names == want.axis_names, kw
        assert got.shape == dict(want.shape), kw
        assert got.devices.shape == want.devices.shape
        assert got.model_size == kw["n_model"]
        assert got.group is None and got.model_group is None
    with pytest.raises(ValueError):
        t_mesh.make_mesh(devices=devs, n_model=0)


def test_ranks_sit_at_data_and_model_indices(worlds):
    """Rank r is (r // 2, r % 2): the ranks of one model group take the
    same rows of the global batch."""
    out, _, _ = worlds
    for world, ranks in out.items():
        for r, res in enumerate(ranks):
            m = res["mesh"]
            assert m["shape"] == {"data": world // 2, "model": 2}
            assert (m["data_rank"], m["model_rank"]) == divmod(r, 2)
            per = 8 * world // (world // 2)
            assert m["rows"] == slice(per * (r // 2), per * (r // 2 + 1))


# ------------------------------------------------------------ the steps

def test_tp_step_matches_single_device(worlds):
    """tiny_cnn over (2,2) against `cpg_tpu`'s one-device step; every rank
    ends with the same whole trees, each holding half of every kernel, its
    ownership, piggymask and momentum."""
    out, ref, _ = worlds
    res = out[4][0]["tiny"]["dp"]
    _assert_step_matches(res, ref["tiny"], "tiny over (2,2)")
    held, split = res["held"], res["split"]
    assert set(split) == set(ref["tiny"]["shared"])
    for tree in ("shared", "ownership", "piggymask"):
        _halves(held[tree], split, f"tiny {tree}")
    # optimizer moments in parameter order: the shared kernels first
    for i, k in enumerate(res["shared"]):
        assert held["moments_w"][i]["momentum_buffer"] == held["shared"][k]
    for i, k in enumerate(res["piggymask"]):
        assert held["moments_pm"][i]["exp_avg"] == held["piggymask"][k]
    for r in out[4][1:]:
        for k, v in r["tiny"]["dp"]["shared"].items():
            np.testing.assert_array_equal(v, res["shared"][k], err_msg=k)


def test_tp_step_needs_the_summed_input_gradient(worlds):
    """The negative control: with `to_model_group`'s backward the identity
    (each rank keeps its partial input gradient) the step must miss."""
    out, ref, _ = worlds
    with pytest.raises(AssertionError):
        _assert_step_matches(out[4][0]["tiny"]["control"], ref["tiny"],
                             "tiny, control")


@pytest.mark.parametrize("flags", ["default", "kernels"])
def test_tp_vgg_step_matches_single_device(worlds, flags):
    """VGG16-BN at width 0.125, task 2, over (1,2) (every layer split: K1-K6
    on each rank's half of the output channels under the kernel flags)
    against `cpg_tpu`'s one-device default step and the port's one-process
    step, at `tests/test_parallel_tp.py`'s tolerances but two, each
    measured: the loss at rtol 1e-4 against `cpg_tpu` (the packages' f32
    convolutions and batch statistics sum in different orders over 13
    batch-normalised layers of 8 rows: 1.05e-5 on this batch, as in
    tests/test_torch_port_parallel.py), and the piggymasks against
    `cpg_tpu` by that file's Adam rule (Adam divides each gradient by its
    own size, so where one is near its eps summation order moves the update
    by up to lr_mask: 1 entry of 230,040 here).

    One model group: over two data ranks the default step's batch of 4 rows
    a rank moves conv0's update by 0.6% of its largest entry through
    summation order alone (so does the data-parallel step without a model
    axis), beyond these tolerances."""
    from .test_torch_port_parallel import \
        _assert_step_matches as dp_assert

    out, ref, _ = worlds
    res = out[2][0][f"vgg_{flags}"]
    _assert_step_matches(res["dp"], res["single"], f"vgg {flags}",
                         groups=("shared", "piggymask", "private", "bn"))
    dp_assert(res["dp"], ref["vgg"], f"vgg {flags} against cpg_tpu",
              rtol=RTOL, atol=ATOL, loss_rtol=1e-4, adam_masks=True)
    assert len(res["dp"]["split"]) == len(ref["vgg"]["shared"])
    for tree in ("shared", "ownership", "piggymask"):
        _halves(res["dp"]["held"][tree], res["dp"]["split"], f"vgg {tree}")
    for k, v in out[2][1][f"vgg_{flags}"]["dp"]["shared"].items():
        np.testing.assert_array_equal(v, res["dp"]["shared"][k], err_msg=k)


def test_vgg_default_gap_is_a_max_pool_near_tie():
    """Why the VGG16-BN steps run on RandomState(10)'s batch: on
    RandomState(9)'s (tests/test_torch_port_parallel.py's) the fourth pool
    holds a window whose two largest entries are 1.6e-6 apart, within f32
    rounding of conv9's sums, so summation order decides which one the
    pool's gradient reaches: the port's one-process default step (library
    convolutions) and `cpg_tpu`'s default step part there by up to 26% of
    conv9's gradient, and so does the port's default step against itself on
    the input moved by 1e-7 of its size. RandomState(10)'s batch has no
    window closer than 1.6e-5."""
    from cpg_tpu_torch.core.state import state_from_numpy
    from cpg_tpu_torch.data.augment import cifar_train_augment
    from cpg_tpu_torch.models import vgg as t_vgg
    from cpg_tpu_torch.ops.masked import effective_params

    state, draws = _vgg_state(), _jax_draws(jax.random.PRNGKey(20), 8)
    assert min(_pool_gaps(state, _vgg_batch(9)[0], draws)) < 2e-6
    assert min(_pool_gaps(state, _vgg_batch(10)[0], draws)) > 1e-5
    st = state_from_numpy(W.np_state(state), "cpu")
    t2 = st.tasks[2]
    vx, vy = _vgg_batch(9)
    x = cifar_train_augment(torch.from_numpy(vx), draws)
    grads = []
    for scale in (0.0, 1e-7):
        xs = x * (1 + scale * torch.randn(x.shape, generator=torch.Generator()
                                          .manual_seed(1)))
        sh = {k: v.clone().requires_grad_(True) for k, v in st.shared.items()}
        logits, _ = t_fw.apply(
            t_vgg.vgg16_bn_cifar, effective_params(
                sh, st.ownership, t2.piggymask, 2, st.threshold),
            t2.private, t2.bn_state, xs, train=True,
            compute_dtype=torch.float32, num_classes=NC, mult=st.width_mult)
        torch.nn.functional.cross_entropy(logits, torch.from_numpy(vy)
                                          ).backward()
        grads.append(sh["features/conv9/kernel"].grad)
    moved = (grads[1] - grads[0]).abs().max() / grads[0].abs().max()
    assert moved > 0.1, float(moved)


@pytest.mark.parametrize("arch", ["vit", "vit_kernels", "textcls", "moe"])
def test_tp_transformer_steps_match_the_one_process_step(worlds, arch):
    """vit_cifar (default; `use_pallas` + `flash_attention`: dense K1-K3
    on each rank's slice, K7 on all heads), textcls (the embedding split on
    its features) and vit_moe_cifar (its experts split on axis 0) over
    (1,2), task 2 owning entries of every kernel, against `cpg_tpu`'s
    one-device default step and the port's one-process step at
    `tests/test_parallel_tp.py`'s tolerances; both ranks end equal."""
    out, ref, _ = worlds
    res = out[2][0][arch]
    groups = ("shared", "piggymask", "private", "bn")
    _assert_step_matches(res["dp"], res["single"], arch, groups=groups)
    _assert_step_matches(res["dp"], ref[arch.replace("_kernels", "")],
                         f"{arch} against cpg_tpu", groups=groups)
    split = res["dp"]["split"]
    for tree in ("shared", "ownership", "piggymask"):
        _halves(res["dp"]["held"][tree], split, f"{arch} {tree}")
    if arch == "moe":
        assert split["blocks/1/moe/experts/fc1/kernel"] == (0, 4)
        assert split["blocks/1/moe/experts/fc2/kernel"] == (0, 4)
    if arch == "textcls":
        assert split["embed/kernel"] == (1, 64)
    for k, v in out[2][1][arch]["dp"]["shared"].items():
        np.testing.assert_array_equal(v, res["dp"]["shared"][k], err_msg=k)


# ------------------------------------------------ Manager and the cycle

def test_tp_manager_matches_jax_manager(worlds):
    """`Manager(mesh=)` over (2,2) against `cpg_tpu`'s Manager over (2,2):
    each rank's live kernels, ownership and piggymasks (every task's) and
    its optimizer moments have the slices' shapes."""
    out, ref, _ = worlds
    want = ref["manager"]
    for r in out[4]:
        got = r["manager"]
        assert got["steps"] == want["steps"]
        np.testing.assert_allclose(got["acc"], want["acc"], atol=1e-6)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                                   atol=1e-6)
        for group in ("shared", "piggymask"):
            for k, v in want[group].items():
                _close(got[group][k], v, f"manager {group}/{k}")
        for key in ("placed", "held"):
            for tree in ("shared", "ownership", "piggymask2"):
                _halves(got[key][tree], got["split"], f"manager {tree}")
        moments = [m["momentum_buffer"] for m in got["moments_w"].values()]
        assert moments[:len(got["held"]["shared"])] == list(
            got["held"]["shared"].values())
        assert [m["exp_avg"] for m in got["moments_pm"].values()] == list(
            got["held"]["piggymask2"].values())


def test_tp_run_sequence_matches_jax(worlds):
    """`run_sequence` over (2,2) against the port's one-process cycle from
    the same inits, as `tests/test_parallel_tp.py` holds `cpg_tpu`'s
    (accuracies atol 1e-6, the same ratios; weights rtol 5e-3 / atol 1e-4;
    ownership agreement above 0.995), and against `cpg_tpu`'s one-device
    cycle (its inits through the seam): the same accuracies and ratios
    (the two packages' one-process cycles part by up to 1.2e-2 in two
    entries of conv1 after its ~100 steps, so their weights are not held
    to these tolerances). The four ranks end with the same whole state, a
    rerun resumes it bit for bit, and only rank 0 writes."""
    out, ref, _ = worlds
    r0 = out[4][0]["sequence"]
    one = r0["single"]
    for want in (one["reports"], ref["sequence"]["reports"]):
        for got, w in zip(r0["reports"], want):
            np.testing.assert_allclose(got[:2], w[:2], atol=1e-6)
            assert got[2] == w[2] and got[3] == 0
    total = same = 0
    for k, v in one["shared"].items():
        _close(r0["first"][f"shared/{k}"], v, k, 5e-3, 1e-4)
        a, b = r0["first"][f"own/{k}"], one["ownership"][k]
        total, same = total + a.size, same + int((a == b).sum())
    assert same / total > 0.995, same / total
    for r in out[4]:
        for k, v in r0["first"].items():
            np.testing.assert_array_equal(r["sequence"]["first"][k], v, k)
            np.testing.assert_array_equal(r["sequence"]["resumed"][k], v, k)
    assert {"task01_t1", "task02_t2", "task01_t1.pick",
            "task02_t2.pick"} <= set(r0["writes"])
    assert all(r["sequence"]["writes"] == [] for r in out[4][1:])


def test_tp_checkpoint_is_whole_and_a_resume_resplits(worlds):
    """The checkpoint a (2,2) run writes is the one-process format (whole
    shapes, the keys of a one-process state); a Manager over the mesh
    splits it again, each rank's slices bit-equal to the checkpoint's, and
    its eval is the one-process Manager's on the same checkpoint."""
    out, ref, _ = worlds
    for r in out[4]:
        seq = r["sequence"]
        assert seq["loaded"]["shared"] == {
            k: v.shape for k, v in ref["sequence"]["shared"].items()}
        assert seq["resplit"] and seq["n_split"] == 2
        for tree in ("shared", "ownership", "piggymask2"):
            for k, shape in seq["placed"][tree].items():
                whole = seq["loaded"][tree][k]
                assert shape[-1] * 2 == whole[-1] and shape[:-1] == whole[:-1]
    for r in out[4]:
        assert r["sequence"]["resumed_eval"] == out[4][0]["sequence"][
            "single"]["eval"]


def test_pruner_on_split_layers_is_bit_equal_to_one_process(worlds):
    """Gradual events and a one-shot prune on a split layer (and a
    replicated one beside it), weights with ties at every magnitude: the
    whole layers bit-equal to the one-process pruner's and `cpg_tpu`'s,
    the counts and the sparsity the whole layers'."""
    out, ref, _ = worlds
    r0 = out[2][0]["prune"]
    got, single = r0["split"], r0["single"]
    assert got["split"] == {"a/kernel": (3, 8)}
    assert got["counts"] == single["counts"]
    for a, b in zip(got["events"], single["events"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(got["events"], ref["prune"]):
        for k, v in b.items():
            np.testing.assert_array_equal(a[k], v, err_msg=k)
    for r in out[2][1:]:
        for a, b in zip(r["prune"]["split"]["events"], got["events"]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------ CLI and serving

def test_tp_cli_matches_the_one_process_run(cli_runs):
    """`sequence --parallel 2 --parallel-model 2` on CPU ranks against the
    one-process command: the same summary; ownership equal but for at most
    0.1% of a layer's entries (those at the prune cutoff), the weights
    where it agrees and the BN statistics within 1e-5 of the tensor's
    largest magnitude, as tests/test_torch_port_parallel_cli.py holds
    `--parallel 2`."""
    out, st = cli_runs
    assert out["tp"] == out["p0"]
    a, b = st["tp"], st["p0"]
    assert not a.shards
    for k, w in b.shared.items():
        assert a.shared[k].shape == w.shape
        same = a.ownership[k] == b.ownership[k]
        assert same.float().mean() >= 0.999, k
        err = (a.shared[k] - w).abs()[same].max()
        assert err <= 1e-5 * w.abs().max(), (k, float(err))
    for tid, t in b.tasks.items():
        for k, v in t.bn_state.items():
            err = (a.tasks[tid].bn_state[k] - v).abs().max()
            assert err <= 1e-5 * max(1.0, float(v.abs().max())), (tid, k)


def test_server_over_a_model_axis_serves_on_every_device():
    """A mesh with a model axis serves data-parallel over all its devices,
    as `cpg_tpu`'s: the floor raised to the mesh size, the unmeshed
    server's answers."""
    g = torch.Generator().manual_seed(0)
    s = t_seq.init_state("vgg16_bn_cifar", g, 0.125, device="cpu")
    t_seq.start_task(s, "t1", 4, g)
    s.shared, s.ownership = t_pruner.one_shot_prune(s.shared, s.ownership, 1,
                                                    0.5)
    mesh = t_mesh.make_mesh(n_model=2, devices=[torch.device("cpu")] * 4)
    kw = dict(compute_dtype=torch.float32, min_bucket=1)
    ref = TaskServer(s, prep, device="cpu", **kw)
    srv = TaskServer(s, prep, mesh=mesh, **kw)
    try:
        assert srv.min_bucket == 4
        x = np.random.RandomState(3).randint(0, 256, (5, 32, 32, 3)).astype(
            np.uint8)
        np.testing.assert_allclose(srv.predict(1, x), ref.predict(1, x),
                                   rtol=1e-5, atol=1e-5)
    finally:
        srv.close()


def test_model_axis_entry_points_default_to_the_card(monkeypatch):
    """Without a usable card the model-axis meshes' defaults raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: t_mesh.make_mesh(n_model=2),
                 lambda: t_dist.make_pod_mesh(n_model=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_kernel_width_rules_hold_for_the_slices():
    """`refuse_kernel_widths` over a model axis keys its bf16 rules to each
    rank's slice: VGG16-BN at 0.5625 has a 36-channel conv, a multiple of
    4 whole but 18 a slice; a count that does not divide stays whole."""
    from cpg_tpu_torch.train.step import TrainConfig

    cfg = TrainConfig(use_pallas_conv=True)
    t_seq.refuse_kernel_widths(cfg, "vgg16_bn_cifar", [0.5625], (32, 32, 3))
    with pytest.raises(ValueError, match=r"split over 2 ranks: \[18\]"):
        t_seq.refuse_kernel_widths(cfg, "vgg16_bn_cifar", [0.5625],
                                   (32, 32, 3), n_model=2)
    t_seq.refuse_kernel_widths(cfg, "vgg16_bn_cifar", [0.5625], (32, 32, 3),
                               n_model=5)  # no count divides by 5: whole
    t_seq.refuse_kernel_widths(TrainConfig(use_pallas_conv=True,
                                           compute_dtype=torch.float32),
                               "vgg16_bn_cifar", [0.5625], (32, 32, 3),
                               n_model=2)  # f32: no channel rule


def test_shard_activations_still_refuses():
    """`--shard-activations` was refused until its seams were ported
    (parallel/mesh.py `act_sharder`): with a model axis it now passes the
    refusals, and no refusal names it."""
    args = cli._parse([*CLI_ARGV, "--parallel", "2", "--parallel-model",
                       "2", "--shard-activations"])
    cli._refuse_unported(args)
    assert args.shard_activations
    assert all(attr != "shard_activations" for attr, _, _ in cli.UNPORTED)

