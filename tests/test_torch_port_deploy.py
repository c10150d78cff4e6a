"""The port's checkpoint-to-artifact commands against `cpg_tpu`'s, on the
CPU: `export-torch` and `import-torch` (the reference's torch.save layout)
bit for bit against `cpg_tpu`'s converters, their round trip, the JSON of
`stats` and `check` (a dirty checkpoint exits 1), and the chain
checkpoint -> `export` (bf16 and calibrated int8) -> `serve` and
`inference`, all through `cli.main([..., "--device", "cpu"])`. The state
is VGG16-BN at width 0.125 with two tasks (task 1 pruned to 50%).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from cpg_tpu import cli as j_cli
from cpg_tpu.core.state import CPGState as JState
from cpg_tpu.core.state import TaskEntry as JTask
from cpg_tpu.train.export_torch import \
    export_torch_cpg_checkpoint as j_export_torch
from cpg_tpu.train.pretrained import \
    convert_torch_cpg_checkpoint as j_convert
from cpg_tpu.utils import checkpoint as j_ckpt
from cpg_tpu_torch import cli
from cpg_tpu_torch.core.pruner import one_shot_prune
from cpg_tpu_torch.core.state import state_from_numpy, state_to_numpy
from cpg_tpu_torch.data.augment import cifar_eval_preprocess as prep
from cpg_tpu_torch.serve import TaskServer
from cpg_tpu_torch.train.export_torch import export_torch_cpg_checkpoint
from cpg_tpu_torch.train.pretrained import (convert_torch_cpg_checkpoint,
                                            load_torch_checkpoint)
from cpg_tpu_torch.train.sequence import init_state, start_task
from cpg_tpu_torch.utils.checkpoint import load_state, save_state

from .test_import_cpg import _torch_fixture
from .test_torch_port_face import _np_state as _sphere_np_state
from .test_torch_port_face import _to_jax as _sphere_to_jax

torch.set_num_threads(1)
NAMES = ("aquatic_mammals", "fish")  # CIFAR-100 superclass tasks 1 and 2


@pytest.fixture(scope="module")
def np_state():
    g = torch.Generator().manual_seed(0)
    s = init_state("vgg16_bn_cifar", g, 0.125, device="cpu")
    start_task(s, NAMES[0], 5, g)
    s.shared, s.ownership = one_shot_prune(s.shared, s.ownership, 1, 0.5)
    start_task(s, NAMES[1], 5, g)
    for k, pm in s.tasks[2].piggymask.items():
        s.tasks[2].piggymask[k] = pm + torch.randn(pm.shape, generator=g) * 0.01
    for tid, t in s.tasks.items():  # distinct per-task BN, unit-scale heads
        t.bn_state = {k: v + 0.01 * tid for k, v in t.bn_state.items()}
        t.private["classifier/kernel"] = torch.randn(
            t.private["classifier/kernel"].shape, generator=g)
    s.tasks[1].meta = {"final_acc": 0.5, "chosen_ratio": 0.5, "grew": 0}
    return state_to_numpy(s)


def _to_jax(s) -> JState:
    return JState(arch=s.arch, width_mult=s.width_mult, shared=s.shared,
                  ownership=s.ownership,
                  tasks={tid: JTask(**dataclasses.asdict(t))
                         for tid, t in s.tasks.items()},
                  threshold=s.threshold, mask_mode=s.mask_mode,
                  model_kwargs=dict(s.model_kwargs))


def _tree_eq(got, want, what):
    assert (got is None) == (want is None), what
    if want is None:
        return
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def _states_eq(got, want):
    """Two states (numpy arrays, or `cpg_tpu`'s) field by field, bit for
    bit."""
    assert (got.arch, got.width_mult, got.threshold) == (
        want.arch, want.width_mult, want.threshold)
    _tree_eq(got.shared, want.shared, "shared")
    _tree_eq(got.ownership, want.ownership, "ownership")
    assert sorted(got.tasks) == sorted(want.tasks)
    for tid, w in want.tasks.items():
        g = got.tasks[tid]
        assert (g.name, g.num_classes) == (w.name, w.num_classes)
        for f in ("piggymask", "private", "bn_state"):
            _tree_eq(getattr(g, f), getattr(w, f), f"task {tid} {f}")


def _ckpt_eq(got, want, what="ckpt"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _ckpt_eq(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def test_export_torch_matches_jax(np_state, tmp_path):
    """The port's export (and `export-torch` through the CLI) writes
    `cpg_tpu`'s dict: the same keys, bit-equal arrays."""
    want = j_export_torch(_to_jax(np_state))
    got = export_torch_cpg_checkpoint(state_from_numpy(np_state, "cpu"))
    _ckpt_eq(got, want)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "ref.pth")
    save_state(state_from_numpy(np_state, "cpu"), ck)
    assert cli.main(["export-torch", "--ckpt", ck, "--out", out,
                     "--device", "cpu"]) == 0
    _ckpt_eq(torch.load(out, weights_only=False), want)
    with pytest.raises(NotImplementedError, match="supports"):
        export_torch_cpg_checkpoint(dataclasses.replace(
            state_from_numpy(np_state, "cpu"), arch="vit_cifar"))
    # SphereNet-20 is ported: `cpg_tpu`'s dict for an AngleLinear state
    sphere = _sphere_np_state(seed=1, heads={1: "angle", 2: "angle"})
    _ckpt_eq(export_torch_cpg_checkpoint(state_from_numpy(sphere, "cpu")),
             j_export_torch(_sphere_to_jax(sphere)))


@pytest.mark.parametrize("piggymask", [True, False],
                         ids=["piggymask", "missing_piggymask"])
def test_import_torch_matches_jax(np_state, tmp_path, piggymask):
    """A reference checkpoint with genuine torch VGG16-BN module names
    (written by the JAX suite's fixture, as torch tensors through
    torch.save): `import-torch` gives `cpg_tpu`'s converted state bit for
    bit; a missing piggymask gets the reference init."""
    ckpt = _torch_fixture(_to_jax(np_state))
    if not piggymask:
        for info in ckpt["shared_layer_info"].values():
            info.pop("piggymask", None)
    want = j_convert(ckpt)
    as_torch = {**ckpt, "state_dict": {k: torch.from_numpy(np.array(v))
                                       for k, v in ckpt["state_dict"].items()}}
    path, out = str(tmp_path / "ref.pth"), str(tmp_path / "ck")
    torch.save(as_torch, path)
    assert cli.main(["import-torch", "--ckpt", path, "--out", out,
                     "--device", "cpu"]) == 0
    got = state_to_numpy(load_state(out, device="cpu"))
    _states_eq(got, want)
    if not piggymask:
        for v in got.tasks[2].piggymask.values():
            assert (v == np.float32(1e-2)).all()
    assert sorted(load_torch_checkpoint(path)) == sorted(ckpt["state_dict"])
    with pytest.raises(NotImplementedError, match="supports"):
        convert_torch_cpg_checkpoint(ckpt, arch="vit_cifar", device="cpu")
    # SphereNet-20 is ported: a reference checkpoint of it comes back whole
    sphere = _sphere_np_state(seed=1)
    back = convert_torch_cpg_checkpoint(
        export_torch_cpg_checkpoint(state_from_numpy(sphere, "cpu")),
        arch="spherenet20", device="cpu")
    _states_eq(state_to_numpy(back), sphere)


def test_export_import_round_trip(np_state):
    """export-torch then import-torch gives the state back bit for bit."""
    back = convert_torch_cpg_checkpoint(
        export_torch_cpg_checkpoint(state_from_numpy(np_state, "cpu")),
        device="cpu")
    _states_eq(state_to_numpy(back), np_state)


def _json_of(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("dirty", [False, True], ids=["clean", "dirty"])
def test_stats_and_check_match_jax(np_state, tmp_path, capsys, dirty):
    """`stats --per-layer` and `check` print `cpg_tpu`'s JSON for the same
    state; a checkpoint with a nonzero free weight and a task id past the
    task count exits 1 from `check`, naming I1 and I2."""
    st = np_state
    if dirty:
        st = dataclasses.replace(st, shared=dict(st.shared),
                                 ownership=dict(st.ownership))
        k = "features/conv3/kernel"
        own = st.ownership[k].copy()
        own.flat[0], own.flat[1] = 0, 3
        w = st.shared[k].copy()
        w.flat[0] = 0.25
        st.ownership[k], st.shared[k] = own, w
    ck, jck = str(tmp_path / "ck"), str(tmp_path / "orbax")
    save_state(state_from_numpy(st, "cpu"), ck)
    j_ckpt.save_state(_to_jax(st), jck)
    for argv in (["stats", "--per-layer"], ["check"],
                 ["check", "--allow-transient"]):
        rc, got = _json_of(cli.main, [*argv, "--checkpoint", ck,
                                      "--device", "cpu"], capsys)
        jrc, want = _json_of(j_cli.main, [*argv, "--checkpoint", jck],
                             capsys)
        got.pop("checkpoint", None)
        want.pop("checkpoint", None)
        assert (rc, got) == (jrc, want), argv
    if dirty:
        assert rc == 1 and any(v.startswith("I1") for v in got["violations"])
        _, got = _json_of(cli.main, ["check", "--checkpoint", ck,
                                     "--device", "cpu"], capsys)
        assert any(v.startswith("I2") for v in got["violations"])


def test_export_serve_and_inference_through_the_cli(np_state, tmp_path,
                                                    capsys):
    """checkpoint -> `export` (bf16; int8 calibrated from an npz) ->
    `serve` equals the in-process servers, and `inference` scores the
    padded test split as `cpg_tpu`'s does."""
    st = state_from_numpy(np_state, "cpu")
    ck = str(tmp_path / "ck")
    save_state(st, ck)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (7, 32, 32, 3)).astype(np.uint8)
    calib = rng.randint(0, 256, (16, 32, 32, 3)).astype(np.uint8)
    req, cal = str(tmp_path / "req.npz"), str(tmp_path / "cal.npz")
    np.savez(req, x=x)
    np.savez(cal, task1=calib[:8], task2=calib[8:])
    q8 = TaskServer(st, prep, quantize="int8", device="cpu")
    q8.calibrate({1: calib[:8], 2: calib[8:]})
    servers = {"bf16": TaskServer(st, prep, device="cpu"), "int8": q8}
    for label, extra in (("bf16", []), ("int8", ["--int8", "--calibrate",
                                                 cal])):
        art, out = str(tmp_path / label), str(tmp_path / f"{label}.npz")
        rc, rep = _json_of(cli.main, ["export", "--checkpoint", ck, "--out",
                                      art, "--device", "cpu", *extra],
                           capsys)
        assert rc == 0 and rep["quantize"] == (label if extra else None)
        assert rep["calibrated_tasks"] == (2 if extra else 0)
        assert cli.main(["serve", "--artifact", art, "--requests", req,
                         "--task-id", "2", "--out", out, "--fused-chain",
                         "--device", "cpu"]) == 0
        capsys.readouterr()
        np.testing.assert_array_equal(np.load(out)["logits"],
                                      servers[label].predict(2, x))
    jck = str(tmp_path / "orbax")
    j_ckpt.save_state(_to_jax(np_state), jck)
    flags = ["--task-id", "2", "--synthetic-train-per-class", "1",
             "--synthetic-test-per-class", "3", "--batch-size", "8"]
    rc, got = _json_of(cli.main, ["inference", "--checkpoint", ck,
                                  "--device", "cpu", *flags], capsys)
    _, want = _json_of(j_cli.main, ["inference", "--checkpoint", jck,
                                    *flags], capsys)
    assert rc == 0 and got == want and got["n"] == 15
