"""The port's data parallelism (cpg_tpu_torch/parallel/*) against `cpg_tpu`,
on the CPU.

Two gloo worlds of CPU ranks, one of 2 and one of 4, are spawned once for
the module (tests/torch_dist_worker.py, through a file store under
tmp_path) and run every check of the module's job while the JAX references
are computed here. The checks:

  * the port's DP step (tiny_cnn; VGG16-BN at width 0.125, task 2, with
    the masked-conv and fused-chain flags, `cpg_tpu`'s crop and flip
    draws injected) at 2 and 4 ranks against `cpg_tpu`'s single-device
    `build_train_step` on the global batch, at `tests/test_parallel.py`'s
    tolerances (loss rtol 1e-5; weights and BN running statistics rtol
    2e-4, atol 2e-6; VGG16-BN's loss and piggymasks looser against
    `cpg_tpu`, with the reason in the test), `it` carried;
  * BatchNorm over skewed shards (one rank's rows bright, the other's
    dark): synced, the step holds those tolerances; with the sync removed
    (the worker's copy of the step takes each rank's statistics over its
    own rows) it must not;
  * the eval step's global `acc_sum` and `loss`; `Manager(mesh=)` against
    the one-process Manager; `run_sequence(mesh=)` over two tasks with a
    prune and a growth: replicas bit-equal, a resume bit-equal, only rank
    0 writing; vit_cifar and textcls DP steps against the one-process
    step (LayerNorm needs no sync);
  * the meshes' axes and shapes against `cpg_tpu`'s on its 8 fake devices,
    the rows each rank takes, and the refusals (a mesh of several devices
    in one process for training; the model axis is in
    tests/test_torch_port_parallel_tp.py).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.data import augment as j_aug
from cpg_tpu.models import get_model as j_get_model
from cpg_tpu.parallel import distributed as j_dist
from cpg_tpu.parallel import mesh as j_mesh
from cpg_tpu.train.sequence import init_state as j_init_state
from cpg_tpu.train.sequence import start_task as j_start_task
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu.train.step import build_eval_step as j_build_eval_step
from cpg_tpu.train.step import build_train_step as j_build_train_step
from cpg_tpu_torch.core.state import state_to_numpy
from cpg_tpu_torch.data.stream import DevicePrefetcher
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.models import get_model as t_get_model
from cpg_tpu_torch.parallel import distributed as t_dist
from cpg_tpu_torch.parallel import mesh as t_mesh
from cpg_tpu_torch.train import sequence as t_seq
from cpg_tpu_torch.train import step as t_step
from cpg_tpu_torch.train.manager import Manager

from . import torch_dist_worker as W
from .helpers import normalize01, synthetic_task, tiny_cnn

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC, MULT = 5, 0.125
VIT = dict(depth=2, dim=64, heads=2, patch=8)
TXT = dict(depth=2, dim=64, heads=2, vocab=64)
RTOL, ATOL = 2e-4, 2e-6  # tests/test_parallel.py's


def _jax_draws(key, n, pad=4):
    """`cpg_tpu.data.augment`'s crop offsets and flip bits from `key`."""
    kc, kf = jax.random.split(key)
    offs = jax.random.randint(kc, (n, 2), 0, 2 * pad + 1)
    flip = jax.random.bernoulli(kf, 0.5, (n, 1, 1, 1))
    return np.array(offs), np.array(flip).reshape(n)


def _plain(s):
    """A state (either package's) as the job's plain dict of numpy."""
    return dict(arch=s.arch, width_mult=float(s.width_mult),
                shared={k: np.asarray(v) for k, v in s.shared.items()},
                ownership={k: np.asarray(v) for k, v in s.ownership.items()},
                tasks={tid: dict(name=t.name, num_classes=t.num_classes,
                                 piggymask=None if t.piggymask is None else {
                                     k: np.asarray(v)
                                     for k, v in t.piggymask.items()},
                                 private={k: np.asarray(v)
                                          for k, v in t.private.items()},
                                 bn_state={k: np.asarray(v)
                                           for k, v in t.bn_state.items()},
                                 meta=dict(t.meta or {}))
                       for tid, t in s.tasks.items()},
                model_kwargs=dict(getattr(s, "model_kwargs", None) or {}),
                in_shape=getattr(s, "in_shape", None))


def _tiny_state():
    st = j_init_state("tiny_cnn", jax.random.PRNGKey(0))
    j_start_task(st, "a", 4, jax.random.PRNGKey(1))
    return _plain(st)


def _vgg_state(seed=0):
    """Two VGG16-BN tasks at width 0.125: random ownership with free
    entries, task 2's piggymask at least 2e-3 from the threshold."""
    rng = np.random.RandomState(seed)
    model_fn, in_shape = t_get_model("vgg16_bn_cifar")
    shared, private, bn = t_fw.init(torch.Generator().manual_seed(0),
                                    model_fn, torch.zeros((1, *in_shape)),
                                    num_classes=NC, mult=MULT)
    sh = {k: (rng.randn(*w.shape) * np.sqrt(2.0 / (9 * w.shape[-1])))
          .astype(np.float32) for k, w in shared.items()}
    own = {k: rng.choice([0, 1, 2], p=[0.1, 0.45, 0.45], size=w.shape)
           .astype(np.int8) for k, w in shared.items()}

    def private_tree():
        return {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("/scale")
                    else rng.randn(*v.shape) * (0.3 if "classifier" in k
                                                else 0.1)).astype(np.float32)
                for k, v in private.items()}

    def bn_tree():
        return {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("/var")
                    else rng.randn(*v.shape) * 0.1).astype(np.float32)
                for k, v in bn.items()}

    def pm(shape):
        return np.where(rng.uniform(size=shape) < 0.7,
                        rng.uniform(0.007, 0.03, shape),
                        rng.uniform(-0.02, 0.003, shape)).astype(np.float32)

    tasks = {1: dict(name="t1", num_classes=NC, piggymask=None,
                     private=private_tree(), bn_state=bn_tree(), meta={}),
             2: dict(name="t2", num_classes=NC,
                     piggymask={k: pm(w.shape) for k, w in sh.items()},
                     private=private_tree(), bn_state=bn_tree(), meta={})}
    return dict(arch="vgg16_bn_cifar", width_mult=MULT, shared=sh,
                ownership=own, tasks=tasks, model_kwargs={}, in_shape=None)


def _port_state(arch, model_kwargs, batch_hw=None, task_kwargs=None):
    g = torch.Generator().manual_seed(4)
    st = t_seq.init_state(arch, g, model_kwargs=model_kwargs,
                          batch_hw=batch_hw, device="cpu")
    for name in ("t1", "t2"):
        t_seq.start_task(st, name, NC, g, model_kwargs=task_kwargs)
    return _plain(state_to_numpy(st))


def _skewed(x):
    """The first half of the rows bright, the second dark."""
    x = x.astype(np.int32) // 4
    half = len(x) // 2
    x[:half] += 192
    return x.astype(np.uint8)


# ------------------------------------------------------- the references

def _jax_steps(state, batches, cfg, model_fn, tid=1, augment=None, loss=None):
    from cpg_tpu.core.state import CPGState as JState
    from cpg_tpu.core.state import TaskEntry as JTask

    st = JState(arch=state["arch"], width_mult=state["width_mult"],
                shared=state["shared"], ownership=state["ownership"],
                tasks={t: JTask(**v) for t, v in state["tasks"].items()},
                model_kwargs=dict(state.get("model_kwargs") or {}))
    task = st.tasks[tid]
    has_pm = task.piggymask is not None
    extra = {} if loss is None else {"loss_fn": loss}
    step, (opt_w, opt_pm) = j_build_train_step(
        model_fn, num_classes=task.num_classes, mult=st.width_mult,
        has_piggymask=has_pm, cfg=cfg, augment_fn=augment,
        model_kwargs=st.forward_kwargs(tid) or None, **extra)
    carry = [st.shared, task.piggymask if has_pm else {}, task.private,
             task.bn_state,
             opt_w.init({"shared": st.shared, "private": task.private}),
             opt_pm.init(task.piggymask if has_pm else {})]
    jstep = jax.jit(step)
    losses = []
    for x, y, key, it in batches:
        out = jstep(*carry, st.ownership, tid, jnp.asarray(x), jnp.asarray(y),
                    key, it)
        carry = list(out[:6])
        losses.append(float(out[6]["loss"]))
    return dict(losses=losses, shared=carry[0], piggymask=carry[1],
                private=carry[2], bn=carry[3])


def _jobs(tmp):
    """The two worlds' jobs, and what the references need of them."""
    data = synthetic_task(0)
    tiny = _tiny_state()
    x, y = data["train_x"][:64], data["train_y"][:64]
    vgg = _vgg_state()
    rng = np.random.RandomState(9)
    keys = [jax.random.PRNGKey(20 + i) for i in range(2)]
    vx = [rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8) for _ in keys]
    vy = [rng.randint(0, NC, 8) for _ in keys]
    vgg_batches = [(vx[i], vy[i], _jax_draws(keys[i], 8), i)
                   for i in range(1)]
    kernels = dict(use_pallas_conv=True, use_fused_chain=True)
    vgg_job = ("step", dict(state=vgg, tid=2, batches=vgg_batches,
                            flags=kernels, lr=2e-3, single=True))
    common = {
        "tiny": ("step", dict(state=tiny, tid=1, batches=[(x, y, None, 0)])),
        "vgg": vgg_job,
    }
    draws8 = (rng.randint(0, 9, (8, 2)), rng.randint(0, 2, 8).astype(bool))
    tasks = {"a": synthetic_task(0), "b": synthetic_task(1)}
    job2 = dict(common, **{
        "tiny_it7": ("step", dict(state=tiny, tid=1,
                                  batches=[(x, y, None, 7)],
                                  annealed_loss=True)),
        "skew": ("skew", dict(state=tiny, batches=[(_skewed(x), y, None,
                                                    0)])),
        "eval": ("eval", dict(state=tiny, x=data["test_x"][:64],
                              y=data["test_y"][:64])),
        "manager": ("manager", dict(state=tiny, data=data, epochs=1)),
        "sequence": ("sequence", dict(tasks=tasks,
                                      ckdir=str(tmp / "ck"))),
        "vit": ("step", dict(state=_port_state("vit_cifar", VIT), tid=2,
                             batches=[(vx[0], vy[0], draws8, 0)],
                             single=True, lr=2e-3)),
        "textcls": ("step", dict(
            state=_port_state("textcls", TXT, (16,), {"causal": True}),
            tid=2, batches=[(rng.randint(0, 64, (8, 16)), vy[0], None, 0)],
            single=True, lr=2e-3)),
    })
    refs = dict(tiny=tiny, x=x, y=y, vgg=vgg, vgg_batches=vgg_batches,
                keys=keys, data=data)
    return {2: job2, 4: common}, refs


def _references(r):
    cfg = JConfig(lr=0.05, compute_dtype=jnp.float32)
    aug = lambda v, k: normalize01(v)  # noqa: E731
    out = {"tiny": _jax_steps(r["tiny"], [(r["x"], r["y"], None, 0)], cfg,
                              tiny_cnn, augment=aug),
           "skew": _jax_steps(r["tiny"], [(_skewed(r["x"]), r["y"], None,
                                           0)], cfg, tiny_cnn, augment=aug)}
    vb = [(x, y, r["keys"][i], it)
          for i, (x, y, _, it) in enumerate(r["vgg_batches"])]
    out["vgg"] = _jax_steps(
        r["vgg"], vb, JConfig(lr=2e-3, compute_dtype=jnp.float32),
        j_get_model("vgg16_bn_cifar")[0], tid=2,
        augment=j_aug.cifar_train_augment)
    from cpg_tpu.core.state import CPGState as JState
    from cpg_tpu.core.state import TaskEntry as JTask

    t = r["tiny"]
    task = JTask(**t["tasks"][1])
    ev = jax.jit(j_build_eval_step(
        tiny_cnn, num_classes=4, mult=1.0, has_piggymask=False, cfg=cfg,
        preprocess_fn=normalize01))
    _, m = ev(t["shared"], {}, task.private, task.bn_state, t["ownership"],
              1, jnp.asarray(r["data"]["test_x"][:64]),
              jnp.asarray(r["data"]["test_y"][:64]))
    out["eval"] = {"acc_sum": int(m["acc_sum"]), "loss": float(m["loss"])}
    del JState
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("worlds")
    jobs, refs = _jobs(tmp)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    procs = {}
    for world, job in jobs.items():
        d = tmp / f"w{world}"
        d.mkdir()
        with open(d / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
             str(r), str(world), str(d / "store"), str(d / "job.pkl"), str(d)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    ref = _references(refs)
    out = {}
    for world, ps in procs.items():
        logs = [p.communicate(timeout=600)[0] for p in ps]
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"rank {r}/{world}:\n{logs[r][-4000:]}"
        out[world] = []
        for r in range(world):
            with open(tmp / f"w{world}" / f"rank{r}.pkl", "rb") as f:
                out[world].append(pickle.load(f))
    return out, ref, refs


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _assert_step_matches(dp, ref, what, rtol=RTOL, atol=ATOL,
                         loss_rtol=1e-5, adam_masks=False):
    """The losses and every trained tree within the tolerances. With
    `adam_masks` the piggymasks follow tests/test_torch_port_train.py's
    rule: Adam divides each gradient by its own magnitude, so where a
    gradient is near its eps summation order moves the update by up to
    ~lr_mask; at most 0.05% of the entries may miss the tolerances, each
    by at most 3 * lr_mask."""
    _close(dp["losses"], ref["losses"], f"{what} loss", loss_rtol, 0)
    for group in ("shared", "private", "bn"):
        for k, v in (ref[group] or {}).items():
            _close(dp[group][k], v, f"{what} {group}/{k}", rtol, atol)
    bad = total = 0
    for k, v in (ref["piggymask"] or {}).items():
        if not adam_masks:
            _close(dp["piggymask"][k], v, f"{what} piggymask/{k}", rtol, atol)
            continue
        got, want = dp["piggymask"][k], np.asarray(v)
        off = ~np.isclose(got, want, rtol=rtol, atol=atol)
        bad, total = bad + int(off.sum()), total + off.size
        assert np.abs(got - want).max() <= 3 * 1e-4, f"{what} {k}"
    assert bad <= 5e-4 * max(total, 1), (what, bad, total)


def _same_replicas(ranks, name):
    """Every rank's result of a check equals rank 0's bit for bit."""
    def flat(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}/")
            else:
                yield pre + k, v
    first = dict(flat(ranks[0][name]["dp"]))
    for r in ranks[1:]:
        for k, v in flat(r[name]["dp"]):
            np.testing.assert_array_equal(v, first[k], err_msg=k)


# ------------------------------------------------------------ the steps

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("model", ["tiny", "vgg"])
def test_dp_step_matches_single_device(worlds, world, model):
    """2 and 4 ranks against `cpg_tpu`'s one-device step on the global
    batch (VGG16-BN: the port's kernel flags, JAX's default step, its draws
    handed to the port); every rank holds the same replica after it.

    VGG16-BN's loss is held at rtol 1e-4 against `cpg_tpu` (as in
    tests/test_torch_port_train.py: the packages' f32 convolutions and
    batch statistics sum in different orders, and 13 batch-normalised
    layers over 8 rows amplify it; the port's own one-process step is
    1.2e-5 off too) and at 1e-5 against the port's one-process step; its
    piggymasks by `_assert_step_matches`'s Adam rule against `cpg_tpu`."""
    out, ref, _ = worlds
    res = out[world][0][model]
    _assert_step_matches(res["dp"], ref[model], f"{model} at {world} ranks",
                         loss_rtol=1e-4 if model == "vgg" else 1e-5,
                         adam_masks=model == "vgg")
    if model == "vgg":
        _assert_step_matches(res["dp"], res["single"],
                             f"vgg at {world} ranks, one-process port step",
                             adam_masks=True)
    _same_replicas(out[world], model)


def test_dp_step_carries_global_step(worlds):
    out, _, _ = worlds
    l0 = out[2][0]["tiny"]["dp"]["losses"][0]
    l7 = out[2][0]["tiny_it7"]["dp"]["losses"][0]
    np.testing.assert_allclose(l7 - l0, 7.0, atol=1e-4)


def test_skewed_shards_need_the_batchnorm_sync(worlds):
    """Rank 0's rows bright, rank 1's dark: the synced step matches the
    one-device step; the same step with each rank's statistics over its
    own rows (the negative control) must not."""
    out, ref, _ = worlds
    skew = out[2][0]["skew"]
    _assert_step_matches(skew["dp"], ref["skew"], "skewed, synced")
    with pytest.raises(AssertionError):
        _assert_step_matches(skew["unsynced"], ref["skew"],
                             "skewed, unsynced")
    bn = "features/bn0/mean"
    off = np.abs(skew["unsynced"]["bn"][bn] - np.asarray(ref["skew"]["bn"][bn]))
    assert off.max() > 100 * (RTOL * np.abs(ref["skew"]["bn"][bn]).max()
                              + ATOL)


def test_parallel_eval_step_sums_the_ranks(worlds):
    out, ref, _ = worlds
    for r in out[2]:
        assert r["eval"]["acc_sum"] == ref["eval"]["acc_sum"]
        _close(r["eval"]["loss"], ref["eval"]["loss"], "eval loss", 1e-5, 0)


@pytest.mark.parametrize("arch", ["vit", "textcls"])
def test_transformer_dp_steps_match_the_one_process_step(worlds, arch):
    """vit_cifar and textcls (LayerNorm: nothing to sync) at 2 ranks
    against the one-process step on the global batch."""
    out, _, _ = worlds
    _assert_step_matches(out[2][0][arch]["dp"], out[2][0][arch]["single"],
                         arch)
    _same_replicas(out[2], arch)


# ------------------------------------------------ Manager and the cycle

def test_manager_over_a_mesh_matches_the_one_process_manager(worlds):
    """One epoch of `Manager(mesh=)` on 2 ranks (each loading its rows of
    the global batches) against the one-process Manager: same steps and
    accuracy, the loss and weights within the step's tolerances relaxed
    to rtol 1e-3 / atol 1e-5 (8 steps at lr 0.05 carry the summation-order
    differences of each step into the next)."""
    out, _, refs = worlds
    st = t_seq.snapshot(W.state_from_numpy(W.np_state(refs["tiny"]), "cpu"))
    mgr = Manager(st, W.tiny_cnn, 1, refs["data"],
                  t_step.TrainConfig(lr=0.05, compute_dtype=torch.float32),
                  batch_size=32, augment_fn=W.norm_augment,
                  preprocess_fn=lambda v: W.norm_augment(v, None), seed=5,
                  lr_schedule="constant", device="cpu")
    res = mgr.train(1)
    for r in out[2]:
        got = r["manager"]
        assert "batch_size 33 not divisible by data-axis size 2" in (
            got["refused"] or "")
        assert got["steps"] == res.steps == 8
        assert got["acc"] == res.acc
        _close(got["loss"], res.loss, "manager loss", 1e-3, 0)
        for k, v in st.shared.items():
            _close(got["shared"][k], v.numpy(), k, 1e-3, 1e-5)
        for k, v in st.tasks[1].bn_state.items():
            _close(got["bn"][k], v.numpy(), k, 1e-3, 1e-5)


def test_run_sequence_over_a_mesh(worlds):
    """Two tasks, the second growing once (goal 1.01) and both pruned to
    0.5: the ranks end bit-equal (run_sequence's `check_replicas` ran at
    each boundary; here every tensor is compared), the resumed run gives
    the same state bit for bit, and only rank 0 wrote checkpoints."""
    out, _, _ = worlds
    r0, r1 = (r["sequence"] for r in out[2])
    assert r0["width"] == 1.5 and r0["grew"] == [0, 1]
    assert r0["ratios"] == [0.5, 0.5]
    assert sorted(r0["first"]) == sorted(r1["first"])
    for k, v in r0["first"].items():
        np.testing.assert_array_equal(r1["first"][k], v, err_msg=k)
        np.testing.assert_array_equal(r0["resumed"][k], v, err_msg=k)
    assert {"task01_a", "task02_b", "task01_a.pick",
            "task02_b.pick"} <= set(r0["writes"])
    assert r1["writes"] == []


# ----------------------------------------------------- meshes, refusals

def test_mesh_axes_and_shapes_match_jax():
    devs = [torch.device("cpu")] * 8
    assert jax.device_count() == 8
    for kw in ({}, {"n_data": 2}, {"n_dcn": 2}, {"n_data": 2, "n_dcn": 2}):
        got, want = t_mesh.make_mesh(devices=devs, **kw), j_mesh.make_mesh(**kw)
        assert got.axis_names == want.axis_names, kw
        assert got.shape == dict(want.shape), kw
        assert got.size == want.size and got.devices.shape == want.devices.shape
        assert got.group is None and got.rank is None and got.is_main
    assert j_dist.make_pod_mesh().axis_names == ("data", "model")
    for n in (8, 64):
        assert (t_mesh.local_batch_slice(t_mesh.make_mesh(devices=devs), n)
                == j_dist.local_batch_slice(j_mesh.make_mesh(), n))


def test_each_rank_takes_its_rows(worlds):
    out, _, _ = worlds
    for world, ranks in out.items():
        for r, res in enumerate(ranks):
            assert res["mesh"]["shape"] == {"data": world, "model": 1}
            assert res["mesh"]["rows"] == slice(8 * r, 8 * (r + 1))


def test_model_axis_and_one_process_training_meshes_are_refused():
    """The one-process refusals (a mesh of several devices in one process
    does not train); the model axis runs (tests/test_torch_port_parallel_tp.py)."""
    devs = [torch.device("cpu")] * 2
    mesh = t_mesh.make_mesh(devices=devs)
    with pytest.raises(ValueError, match="one process a device"):
        t_mesh.make_parallel_train_step(lambda *a, **k: None, mesh)
    with pytest.raises(ValueError, match="one process a device"):
        DevicePrefetcher(iter([]), sharding=t_mesh.batch_sharding(mesh))
    with pytest.raises(ValueError, match="one process a device"):
        t_mesh.shard_batch(mesh, np.zeros((4, 2)), np.zeros(4))
    data = synthetic_task(0)
    st = W.state_from_numpy(W.np_state(_tiny_state()), "cpu")
    with pytest.raises(ValueError, match="one process a device"):
        Manager(st, W.tiny_cnn, 1, data, t_step.TrainConfig(), mesh=mesh)
    # a one-device mesh without a group is the single-device run
    one = t_mesh.make_mesh(devices=devs[:1])
    assert t_mesh.local_batch_slice(one, 6) == slice(0, 6)
    assert t_dist.initialize() is None  # nothing configured: a no-op


def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a usable card the meshes' and ranks' defaults raise; none
    falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (t_mesh.make_mesh, t_dist.make_pod_mesh,
                 lambda: t_dist.initialize(f"file://{tmp_path}/store", 1, 0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not torch.distributed.is_initialized()
