"""The port's streaming data path (data/stream.py, data/native_loader.py,
`--memmap-dir`, `--native-loader`) against `cpg_tpu`'s, on the CPU.

Memmap directories load across the packages; the port's `NativeBatcher`
(built with g++ into build/native/) gives `cpg_tpu`'s batches bit for bit;
`DevicePrefetcher` passes CPU batches through in order; a missing compiler
raises. The Manager parity test trains VGG16-BN at width 0.125 in f32 for
three epochs of the C++ loader over a memmapped task in both packages
from one state (`cpg_tpu`'s default step, the port's kernel step, as
tests/test_torch_cycle.py runs them), the port taking `cpg_tpu`'s
augmentation draws: losses and
logits rtol 1e-4, atol 1e-5, weights rtol 1e-4, atol 5e-5
(`tests/test_torch_cycle.py`'s tolerances), accuracy equal. The CLI runs
the port's cycle from a memmap directory, bit-equal to the in-memory run
without the loader.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu import cli as j_cli
from cpg_tpu.core.state import CPGState as JState
from cpg_tpu.core.state import TaskEntry as JTask
from cpg_tpu.data import augment as j_aug
from cpg_tpu.data import native_loader as j_nl
from cpg_tpu.data import stream as j_stream
from cpg_tpu.models import get_model as j_get_model
from cpg_tpu.train.manager import Manager as JManager
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu_torch import cli
from cpg_tpu_torch.core.invariants import check_state
from cpg_tpu_torch.core.state import state_to_numpy
from cpg_tpu_torch.data import augment as t_aug
from cpg_tpu_torch.data import native_loader as t_nl
from cpg_tpu_torch.data import stream as t_stream
from cpg_tpu_torch.data.cifar import synthetic_cifar100, task_splits
from cpg_tpu_torch.inference import predict
from cpg_tpu_torch.models import get_model
from cpg_tpu_torch.train import sequence as t_seq
from cpg_tpu_torch.train.manager import Manager
from cpg_tpu_torch.train.sequence import init_state, start_task
from cpg_tpu_torch.train.step import TrainConfig

from .test_torch_cycle import KERNELS, _assert_same_state, jax_draws

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 2e-3


def _task(seed=0, n=10, hw=4):
    rng = np.random.RandomState(seed)
    return {"train_x": rng.randint(0, 256, (n, hw, hw, 3)).astype(np.uint8),
            "train_y": rng.randint(0, 5, n).astype(np.int32),
            "test_x": rng.randint(0, 256, (4, hw, hw, 3)).astype(np.uint8),
            "test_y": rng.randint(0, 5, 4).astype(np.int32),
            "num_classes": 5, "loss": "angle",
            "model_kwargs": {"head_type": "linear"},
            "loss_fn": lambda logits, y: 0.0}


# ----------------------------------------------------------- memmaps ----

@pytest.mark.parametrize("writer,reader", [
    (j_stream, t_stream), (t_stream, j_stream)], ids=["jax->port",
                                                      "port->jax"])
def test_memmap_directories_load_across_the_packages(tmp_path, writer,
                                                     reader):
    data = _task()
    writer.save_memmap_dataset(str(tmp_path / "w"), data)
    got = reader.load_memmap_dataset(str(tmp_path / "w"))
    assert set(got) == set(data) - {"loss_fn"}
    for k in ("train_x", "train_y", "test_x", "test_y"):
        assert isinstance(got[k], np.memmap) and got[k].dtype == data[k].dtype
        np.testing.assert_array_equal(got[k], data[k])
    assert got["num_classes"] == 5 and got["loss"] == "angle"
    assert got["model_kwargs"] == {"head_type": "linear"}
    # both packages write the same meta.json
    reader.save_memmap_dataset(str(tmp_path / "r"), data)
    assert (json.loads((tmp_path / "w" / "meta.json").read_text())
            == json.loads((tmp_path / "r" / "meta.json").read_text()))


def test_cli_memmap_tasks_match_jax(tmp_path):
    """--memmap-dir: one directory a task in name order, the angle marker
    reattached as a loss, --num-tasks cutting the list; as `cpg_tpu.cli`."""
    for i, name in enumerate(["b_task", "a_task", "c_task"]):
        d = _task(seed=i)
        if name != "b_task":
            del d["loss"]
        t_stream.save_memmap_dataset(str(tmp_path / name), d)
    (tmp_path / "not_a_dataset").mkdir()
    argv = ["sequence", "--memmap-dir", str(tmp_path), "--num-tasks", "2",
            "--synthetic-train-per-class", "2",
            "--synthetic-test-per-class", "1"]
    t_arch, t_tasks, _, _ = cli._experiment_tasks(
        cli.build_parser().parse_args(argv))
    j_arch, j_tasks, _, _ = j_cli._experiment_tasks(
        j_cli.build_parser().parse_args(argv))
    assert t_arch == j_arch == "vgg16_bn_cifar"
    assert list(t_tasks) == list(j_tasks) == ["a_task", "b_task"]
    for name in t_tasks:
        t, j = t_tasks[name], j_tasks[name]
        assert set(t) == set(j)
        assert ("loss_fn" in t) == (name == "b_task")
        np.testing.assert_array_equal(t["train_x"], j["train_x"])
    with pytest.raises(SystemExit, match="no datasets"):
        cli._experiment_tasks(cli.build_parser().parse_args(
            ["sequence", "--memmap-dir", str(tmp_path / "not_a_dataset")]))


# ------------------------------------------------------- prefetcher ----

@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 7])
def test_device_prefetcher_on_the_cpu_keeps_order_and_content(depth, n):
    xs = [np.full((4, 2), i, np.uint8) for i in range(n)]
    ys = [np.full((4,), i, np.int32) for i in range(n)]
    out = list(t_stream.DevicePrefetcher(zip(xs, ys), "cpu", depth=depth))
    assert len(out) == n
    for i, (bx, by) in enumerate(out):
        assert bx is xs[i] and by is ys[i]  # unchanged


def test_device_prefetcher_refuses_a_mesh():
    """A sharding over a mesh of several devices in this one process is
    refused: training runs one process a device (the prefetcher over
    ranks: tests/test_torch_port_parallel.py's Manager check)."""
    from cpg_tpu_torch.parallel import mesh as t_mesh

    mesh = t_mesh.make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="one process a device"):
        t_stream.DevicePrefetcher(iter([]), "cpu",
                                  sharding=t_mesh.batch_sharding(mesh))
    one = t_mesh.make_mesh(devices=["cpu"])
    xs = [np.full((4, 2), i, np.uint8) for i in range(3)]
    ys = [np.full((4,), i, np.int32) for i in range(3)]
    out = list(t_stream.DevicePrefetcher(
        zip(xs, ys), sharding=t_mesh.batch_sharding(one)))
    assert [int(bx[0, 0]) for bx, _ in out] == [0, 1, 2]


# ------------------------------------------------------ the loader ----

@pytest.fixture(scope="module")
def mm(tmp_path_factory):
    """A 50-row uint8 dataset, memory-mapped."""
    d = tmp_path_factory.mktemp("mm")
    t_stream.save_memmap_dataset(str(d), {
        "train_x": np.random.RandomState(3).randint(
            0, 256, (50, 6, 5, 3)).astype(np.uint8),
        "train_y": np.arange(50, dtype=np.int32)})
    return t_stream.load_memmap_dataset(str(d))


@pytest.mark.parametrize("shuffle", [True, False])
def test_native_batcher_matches_jax_bit_for_bit(mm, shuffle):
    """Eight batches of 16 from 50 rows: two epoch wraps inside the
    loader, read through the map."""
    t = t_nl.NativeBatcher(mm["train_x"], mm["train_y"], 16, seed=7,
                           shuffle=shuffle)
    j = j_nl.NativeBatcher(mm["train_x"], mm["train_y"], 16, seed=7,
                           shuffle=shuffle)
    assert isinstance(t.x, np.memmap)  # not copied into RAM
    seen = []
    for (tx, ty), (jx, jy) in zip(t.batches(8), j.batches(8)):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tx, np.asarray(mm["train_x"])[ty])
        seen += ty.tolist()
    assert sorted(seen[:50]) == list(range(50))  # first epoch: each row once
    assert (seen[:50] == list(range(50))) == (not shuffle)
    t.close()
    j.close()


def test_native_loader_builds_only_under_build_native(tmp_path, monkeypatch):
    """The library goes to build/native/libcpgloader-<hash>.so; the source
    directory is left as it was (no `make`, no object files)."""
    assert t_nl.SOURCE == t_nl.ROOT / "native" / "loader.cc"
    assert t_nl.BUILD_DIR == t_nl.ROOT / "build" / "native"
    assert t_nl.lib_path().parent == t_nl.BUILD_DIR
    assert set(os.listdir(os.path.join(ROOT, "native"))) <= {
        "Makefile", "loader.cc", "libcpgloader.so"}  # the JAX side's build
    src = tmp_path / "native"
    src.mkdir()
    shutil.copy(t_nl.SOURCE, src / "loader.cc")
    shutil.copy(t_nl.SOURCE.parent / "Makefile", src / "Makefile")
    monkeypatch.setattr(t_nl, "SOURCE", src / "loader.cc")
    monkeypatch.setattr(t_nl, "BUILD_DIR", tmp_path / "build" / "native")
    lib = t_nl.build()
    assert lib.parent == tmp_path / "build" / "native" and lib.exists()
    assert sorted(os.listdir(src)) == ["Makefile", "loader.cc"]
    assert os.listdir(lib.parent) == [lib.name]
    assert t_nl.build() == lib  # built once, then reused


def test_native_loader_without_a_compiler_raises(tmp_path, monkeypatch, mm):
    monkeypatch.setattr(t_nl, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_nl, "cxx_path", lambda: None)
    monkeypatch.setattr(t_nl, "_lib", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        t_nl.NativeBatcher(mm["train_x"], mm["train_y"], 16)
    monkeypatch.setattr(t_nl, "cxx_path", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="exited 1"):
        t_nl.build()
    assert os.listdir(tmp_path) == []


# --------------------------------------------------------- Manager ----

def _vgg_task():
    data = synthetic_cifar100(n_train_per_class=8, n_test_per_class=4, seed=0)
    return next(iter(task_splits(data).values()))


def _to_jax(st):
    """`cpg_tpu`'s state holding the arrays of a port state."""
    ns = state_to_numpy(st)

    def tree(t):
        return None if t is None else {k: jnp.asarray(v) for k, v in t.items()}

    return JState(arch=ns.arch, width_mult=ns.width_mult,
                  shared=tree(ns.shared), ownership=tree(ns.ownership),
                  tasks={tid: JTask(t.name, t.num_classes, tree(t.piggymask),
                                    tree(t.private), tree(t.bn_state),
                                    dict(t.meta))
                         for tid, t in ns.tasks.items()},
                  threshold=ns.threshold, mask_mode=ns.mask_mode,
                  model_kwargs=dict(ns.model_kwargs))


@pytest.fixture(scope="module")
def manager_runs(tmp_path_factory):
    """Three epochs of batch 16 over a memmapped 40-image task (two loader
    epochs wrap inside the six steps) through both packages' Managers with
    the native loader, from one state: `cpg_tpu`'s default step, the
    port's kernel step (plain versions here), as tests/test_torch_cycle.py
    runs them."""
    d = str(tmp_path_factory.mktemp("vgg_task"))
    task = _vgg_task()
    t_stream.save_memmap_dataset(d, task)
    g = torch.Generator().manual_seed(0)
    tst = init_state("vgg16_bn_cifar", g, width_mult=0.125, device="cpu")
    start_task(tst, "t", task["num_classes"], g)
    jst = _to_jax(tst)
    jm = JManager(jst, j_get_model("vgg16_bn_cifar")[0], 1,
                  j_stream.load_memmap_dataset(d),
                  JConfig(compute_dtype=jnp.float32, lr=LR), batch_size=16,
                  augment_fn=j_aug.cifar_train_augment,
                  preprocess_fn=j_aug.cifar_eval_preprocess, seed=0,
                  native_loader=True)
    assert jm._batcher is not None  # the C++ loader, not the NumPy gather
    jres = jm.train(epochs=3)
    tdata = t_stream.load_memmap_dataset(d)
    tm = Manager(tst, get_model("vgg16_bn_cifar")[0], 1, tdata,
                 TrainConfig(compute_dtype=torch.float32, lr=LR, **KERNELS),
                 batch_size=16, augment_fn=t_aug.cifar_train_augment,
                 preprocess_fn=t_aug.cifar_eval_preprocess, seed=0,
                 native_loader=True, draws=jax_draws, device="cpu")
    assert isinstance(tm._batcher.x, np.memmap)
    tres = tm.train(epochs=3)
    return jm, jres, tm, tres, task


def test_manager_with_native_loader_from_memmap_matches_jax(manager_runs):
    jm, jres, tm, tres, task = manager_runs
    assert tres.steps == jres.steps == 6
    np.testing.assert_allclose(tres.loss, jres.loss, rtol=1e-4, atol=1e-6)
    assert tres.acc == jres.acc
    jst, tst = jm.state, tm.state
    for k in jst.shared:
        np.testing.assert_allclose(tst.shared[k].numpy(),
                                   np.asarray(jst.shared[k]), rtol=1e-4,
                                   atol=5e-5, err_msg=k)
    for k, v in jst.tasks[1].private.items():
        np.testing.assert_allclose(tst.tasks[1].private[k].numpy(),
                                   np.asarray(v), rtol=1e-4, atol=5e-5,
                                   err_msg=k)
    from cpg_tpu.inference import predict as j_predict

    x = task["test_x"]
    want = j_predict(jst, 1, j_aug.cifar_eval_preprocess(jnp.asarray(x)))
    got = predict(tst, 1, t_aug.cifar_eval_preprocess(torch.from_numpy(x)),
                  device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_manager_native_loader_raises_without_a_compiler(
        manager_runs, tmp_path, monkeypatch):
    """No NumPy fallback: a Manager asked for the loader that cannot build
    it raises."""
    _, _, tm, _, task = manager_runs
    monkeypatch.setattr(t_nl, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_nl, "cxx_path", lambda: None)
    monkeypatch.setattr(t_nl, "_lib", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        Manager(tm.state, get_model("vgg16_bn_cifar")[0], 1, task,
                TrainConfig(compute_dtype=torch.float32), batch_size=16,
                native_loader=True, device="cpu")


# -------------------------------------------------------------- CLI ----

def _cli_run(argv):
    runs = []
    orig = t_seq.run_sequence

    def recorded(*a, **k):
        runs.append(orig(*a, **k))
        return runs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_seq, "run_sequence", recorded)
        assert cli.main(argv) == 0
    return runs[0][0]


def test_cli_sequence_from_a_memmap_dir(tmp_path, capsys):
    """`sequence --memmap-dir` over the experiment's own two tasks gives
    the in-memory run's state bit for bit; with --native-loader it trains
    the same tasks to a clean state."""
    base = ["sequence", "--experiment", "cifar100", "--num-tasks", "2",
            "--synthetic-train-per-class", "8", "--synthetic-test-per-class",
            "4", "--network_width_multiplier", "0.125",
            "--max_allowed_network_width_multiplier", "0.125",
            "--dtype", "float32", "--batch-size", "16", "--lr", str(LR),
            "--finetune-epochs", "1", "--prune-epochs", "1",
            "--retrain-epochs", "1", "--prune-ratios", "0.5", "--device",
            "cpu"]
    _, tasks, _, _ = cli._experiment_tasks(cli.build_parser().parse_args(
        base))
    for name, data in tasks.items():
        t_stream.save_memmap_dataset(str(tmp_path / name), data)
    mem = _cli_run(base)
    from_map = _cli_run(base + ["--memmap-dir", str(tmp_path)])
    assert [t.name for t in from_map.tasks.values()] == list(tasks)
    _assert_same_state(from_map, mem)
    native = _cli_run(base + ["--memmap-dir", str(tmp_path),
                              "--native-loader"])
    assert native.num_tasks == 2 and not check_state(native, strict=False)
    summaries = [json.loads(line) for line in
                 capsys.readouterr().out.strip().splitlines()]
    assert summaries[0] == summaries[1]
