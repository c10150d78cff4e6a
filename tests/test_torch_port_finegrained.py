"""The port's fine-grained experiment against `cpg_tpu`'s, on the CPU: the
data (synthetic stand-ins, the .npz and ImageFolder layouts under
`CPG_DATA_DIR`, the ImageNet augmentation), the pretrained and export
converters, one cross-package `run_sequence` on ResNet-50, and the CLI
(`sequence --experiment finegrained` with `--pretrained-npz` and
`--max-classes`, then `export`, `serve` and `inference`).

Data, converters and the exported dicts are held bit for bit. The cycle
runs ResNet-50 at width 0.125 on 32-px synthetic images from an adopted
(pretrained) task 1 pruned to half, with one fine-grained task on top;
the port takes `cpg_tpu`'s init trees and augmentation draws through the
`init_fn` and `draws` seams and runs its kernel step (the plain versions
on the CPU) against `cpg_tpu`'s default step; what it holds is stated in
`test_cycle_matches_jax`.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu import cli as j_cli
from cpg_tpu.core import pruner as j_pruner_mod
from cpg_tpu.core.pruner import one_shot_prune as j_one_shot_prune
from cpg_tpu.data import augment as j_aug
from cpg_tpu.data import finegrained as j_fg
from cpg_tpu.data import imagefolder as j_if
from cpg_tpu.inference import predict as j_predict
from cpg_tpu.models import framework as j_fw
from cpg_tpu.models import get_model as j_get_model
from cpg_tpu.train import pretrained as j_pre
from cpg_tpu.train.export_torch import \
    export_torch_cpg_checkpoint as j_export_torch
from cpg_tpu.train.sequence import SequenceConfig as JSeq
from cpg_tpu.train.sequence import init_state as j_init_state
from cpg_tpu.train.sequence import run_sequence as j_run_sequence
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu_torch import cli
from cpg_tpu_torch.core import pruner as t_pruner_mod
from cpg_tpu_torch.core.invariants import check_state
from cpg_tpu_torch.core.pruner import one_shot_prune
from cpg_tpu_torch.core.state import state_from_numpy, state_to_numpy
from cpg_tpu_torch.data import augment as t_aug
from cpg_tpu_torch.data import finegrained as t_fg
from cpg_tpu_torch.data import imagefolder as t_if
from cpg_tpu_torch.inference import predict
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.models import get_model
from cpg_tpu_torch.train import pretrained as t_pre
from cpg_tpu_torch.train.export_torch import (export_torch_cpg_checkpoint,
                                              torch_resnet50_state_dict)
from cpg_tpu_torch.train.sequence import (SequenceConfig, init_state,
                                          run_sequence)
from cpg_tpu_torch.train.step import TrainConfig
from cpg_tpu_torch.utils.checkpoint import load_state

from .test_torch_port_deploy import _ckpt_eq, _states_eq, _to_jax
from .test_torch_cycle import _record
from .test_torch_port_resnet import _images, _settle
from .test_torch_port_resnet import _np_state as _resnet_np_state
from .test_torch_port_train import _jax_draws

torch.set_num_threads(1)
ARCH, MULT = "resnet50", 0.125


def _eq(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------- data ----

def test_synthetic_data_bytes_match_jax():
    """synthetic_imagefolder and finegrained_task (class cap, seed, image
    size) give `cpg_tpu`'s bytes; the specs are the same."""
    assert t_fg.FINEGRAINED_SPECS == j_fg.FINEGRAINED_SPECS
    assert t_fg.IMAGE_HW == j_fg.IMAGE_HW == (224, 224)
    for got, want in zip(t_fg.synthetic_imagefolder(3, 4, 2, (32, 48), 7),
                         j_fg.synthetic_imagefolder(3, 4, 2, (32, 48), 7)):
        _eq(got, want)
    for name, cap in (("flowers", 4), ("sketches", None)):
        got = t_fg.finegrained_task(name, max_classes=cap, seed=2,
                                    hw=(32, 32))
        want = j_fg.finegrained_task(name, max_classes=cap, seed=2,
                                     hw=(32, 32))
        assert sorted(got) == sorted(want)
        assert got["num_classes"] == want["num_classes"] == (
            cap or t_fg.FINEGRAINED_SPECS[name])
        for k in ("train_x", "train_y", "test_x", "test_y"):
            _eq(got[k], want[k], f"{name} {k}")
    with pytest.raises(KeyError, match="unknown fine-grained"):
        t_fg.finegrained_task("imagenet")


def _write_images(root, fmt, rng, classes=("b_cls", "a_cls"),
                  test_dir="test"):
    """A small ImageFolder tree of PNG or JPEG files of assorted sizes."""
    from PIL import Image

    ext = {"PNG": ".png", "JPEG": ".jpg"}[fmt]
    for split, n in (("train", 3), (test_dir, 2)):
        for c in classes:
            d = os.path.join(root, split, c)
            os.makedirs(d)
            for i in range(n):
                h, w = rng.randint(20, 60), rng.randint(20, 60)
                a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                Image.fromarray(a).save(os.path.join(d, f"{i}{ext}"), fmt)
            open(os.path.join(d, "notes.txt"), "w").close()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_imagefolder_decodes_like_jax(tmp_path, fmt):
    """Listing, decoding (resize of the shorter side, or to the size;
    centre crop or zero pad), whole splits with a per-class limit and a
    `val` test folder: the same arrays as `cpg_tpu`'s."""
    root = str(tmp_path / "ds")
    _write_images(root, fmt, np.random.RandomState(1), test_dir="val")
    split = os.path.join(root, "train")
    got, want = t_if.list_imagefolder(split), j_if.list_imagefolder(split)
    assert got == want and got[1] == ["a_cls", "b_cls"] and len(got[0]) == 6
    for path, _ in got[0][:3]:
        for hw, resize in (((32, 32), 40), ((24, 40), None),
                           ((64, 64), 16)):
            _eq(t_if.decode_image(path, hw, resize),
                j_if.decode_image(path, hw, resize), path)
    for g, w in zip(t_if.load_imagefolder(split, (32, 32), 36, 2),
                    j_if.load_imagefolder(split, (32, 32), 36, 2)):
        if isinstance(w, list):
            assert g == w
        else:
            _eq(g, w)
    got = t_if.imagefolder_splits(root, hw=(32, 32))
    want = j_if.imagefolder_splits(root, hw=(32, 32))
    assert sorted(got) == sorted(want)
    for k in ("train_x", "train_y", "test_x", "test_y"):
        _eq(got[k], want[k], k)
    assert got["num_classes"] == 2 and got["class_names"] == ["a_cls",
                                                              "b_cls"]
    assert t_if.imagefolder_splits(str(tmp_path)) is None


def test_finegrained_task_reads_cpg_data_dir_like_jax(tmp_path, monkeypatch):
    """Under CPG_DATA_DIR an ImageFolder tree wins, then the .npz pair;
    both packages read the same arrays and class counts."""
    monkeypatch.setenv("CPG_DATA_DIR", str(tmp_path))
    _write_images(str(tmp_path / "flowers"), "PNG", np.random.RandomState(2))
    rng = np.random.RandomState(3)
    os.makedirs(tmp_path / "wikiart")
    for split, n in (("train", 6), ("test", 3)):
        np.savez(tmp_path / "wikiart" / f"{split}.npz",
                 x=rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8),
                 y=rng.randint(0, 195, n).astype(np.int64))
    for name in ("flowers", "wikiart", "sketches"):
        got = t_fg.finegrained_task(name, max_classes=3, hw=(32, 32))
        want = j_fg.finegrained_task(name, max_classes=3, hw=(32, 32))
        assert got["num_classes"] == want["num_classes"], name
        for k in ("train_x", "train_y", "test_x", "test_y"):
            _eq(got[k], want[k], f"{name} {k}")
    assert t_fg.finegrained_task("flowers")["num_classes"] == 2
    assert t_fg.finegrained_task("wikiart", max_classes=3)["num_classes"] \
        == 195


def test_imagenet_augment_bit_exact_with_jax_draws():
    """The pad-16 crop, flip and ImageNet normalisation under `cpg_tpu`'s
    draws, and the eval preprocess: the same bits."""
    x = np.random.RandomState(4).randint(0, 256, (6, 40, 36, 3)).astype(
        np.uint8)
    key = jax.random.PRNGKey(11)
    want = j_aug.imagenet_train_augment(jnp.asarray(x), key)
    got = t_aug.imagenet_train_augment(torch.from_numpy(x),
                                       _jax_draws(key, 6, pad=16))
    _eq(got.numpy(), want)
    _eq(t_aug.imagenet_eval_preprocess(torch.from_numpy(x)).numpy(),
        j_aug.imagenet_eval_preprocess(jnp.asarray(x)))
    assert (t_aug.IMAGENET_MEAN, t_aug.IMAGENET_STD) == (j_aug.IMAGENET_MEAN,
                                                         j_aug.IMAGENET_STD)


# ---------------------------------------------------------- converters ----

def _torchvision_sd(seed, mult=MULT, num_classes=1000):
    """A torchvision-keyed ResNet-50 state_dict of random numpy arrays
    (with the BN `num_batches_tracked` counters a real one carries)."""
    rng = np.random.RandomState(seed)
    shared, private, bn = t_fw.init(
        torch.Generator().manual_seed(seed), get_model(ARCH)[0],
        torch.zeros((1, 32, 32, 3)), num_classes=num_classes, mult=mult)
    sd = torch_resnet50_state_dict(
        {k: rng.randn(*v.shape).astype(np.float32) * 0.1
         for k, v in shared.items()},
        {k: (rng.uniform(0.5, 1.0, v.shape) if k.endswith("/scale")
             else rng.randn(*v.shape) * 0.1).astype(np.float32)
         for k, v in private.items()},
        {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("/var")
             else rng.randn(*v.shape) * 0.1).astype(np.float32)
         for k, v in bn.items()})
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k[:-len("running_mean")] + "num_batches_tracked"] = np.array(7)
    return sd


@pytest.fixture(scope="module")
def adopted():
    """Task 1 adopted in both packages from one torchvision state_dict:
    the ResNet tests' well-conditioned net (settled BN statistics, the
    residual branches' last BN scales at 0.1-0.3; at random BN values the
    16-block net is chaotic under training, and the packages' summation-
    order differences grow to the size of the updates) with a 1000-class
    head. Returns the port's converted trees and both states."""
    net = _resnet_np_state(seed=4)
    t1 = net.tasks[1]
    priv = dict(t1.private, **{
        "classifier/kernel": np.random.RandomState(5).randn(256, 1000)
        .astype(np.float32) * 0.1,
        "classifier/bias": np.zeros(1000, np.float32)})
    trees = t_pre.convert_torch_resnet50(torch_resnet50_state_dict(
        net.shared, priv, t1.bn_state))
    tst = init_state(ARCH, torch.Generator().manual_seed(0), MULT,
                     device="cpu")
    tst.in_shape = (HW, HW, 3)
    assert t_pre.adopt_pretrained_task1(tst, "imagenet", 1000, *trees) == 1
    jst = j_init_state(ARCH, jax.random.PRNGKey(0), MULT, batch_hw=(HW, HW, 3))
    _jax_adopt(jst, *trees)
    return trees, tst, jst


def test_convert_and_adopt_pretrained_match_jax(adopted):
    """convert_torch_resnet50 gives `cpg_tpu`'s three trees; adopting them
    as task 1 (every entry owned by task 1, all three trees supplied)
    gives `cpg_tpu`'s state bit for bit. A head of another class count is
    skipped (the fresh one kept); unknown keys and wrong shapes raise."""
    sd = _torchvision_sd(1)
    got, want = t_pre.convert_torch_resnet50(sd), j_pre.convert_torch_resnet50(sd)
    assert len(got[0]) == 53
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            _eq(g[k], w[k], k)
    (shared, _, _), tst, jst = adopted
    _states_eq(state_to_numpy(tst), jst)
    assert all(bool((o == 1).all()) for o in tst.ownership.values())
    # the converter hands over transposed views; the kernels take
    # contiguous weights only
    assert all(t.is_contiguous() for tree in (tst.shared, tst.ownership,
                                              tst.tasks[1].private,
                                              tst.tasks[1].bn_state)
               for t in tree.values())
    with pytest.raises(ValueError, match="fresh state"):
        t_pre.adopt_pretrained_task1(tst, "again", 10, shared)
    # a 7-class head does not fit a 10-class task: the fresh head stays
    fresh = init_state(ARCH, torch.Generator().manual_seed(0), MULT,
                       device="cpu")
    fresh.in_shape = (32, 32, 3)
    _, p7, _ = t_pre.convert_torch_resnet50(_torchvision_sd(2,
                                                            num_classes=7))
    t_pre.adopt_pretrained_task1(fresh, "x", 10, shared, p7)
    _, p0, _ = t_fw.init(torch.Generator().manual_seed(0), get_model(ARCH)[0],
                         torch.zeros((1, 32, 32, 3)), num_classes=10,
                         mult=MULT)
    assert torch.equal(fresh.tasks[1].private["classifier/kernel"],
                       p0["classifier/kernel"])
    _eq(fresh.tasks[1].private["layer1/block0/bn1/scale"].numpy(),
        p7["layer1/block0/bn1/scale"])
    for bad, err in (({"nope/kernel": shared["conv1/kernel"]}, KeyError),
                     ({"conv1/kernel": shared["conv1/kernel"][:1]},
                      ValueError)):
        st = init_state(ARCH, torch.Generator().manual_seed(0), MULT,
                        device="cpu")
        with pytest.raises(err):
            t_pre.adopt_pretrained_task1(st, "x", 10, bad)


def test_export_torch_and_round_trip_match_jax(tmp_path):
    """A two-task ResNet-50 state: the port's torch export is
    `cpg_tpu`'s dict (torchvision module names, OIHW tensors) bit for
    bit; `export-torch` -> `import-torch` through the CLI gives the state
    back bit for bit."""
    np_state = _resnet_np_state(seed=2)
    st = state_from_numpy(np_state, "cpu")
    want = j_export_torch(_to_jax(np_state))
    got = export_torch_cpg_checkpoint(st)
    _ckpt_eq(got, want)
    back = t_pre.convert_torch_cpg_checkpoint(got, arch=ARCH, device="cpu")
    assert all(t.is_contiguous() for tree in (back.shared, back.ownership)
               for t in tree.values())
    for task in back.tasks.values():
        assert all(t.is_contiguous() for tree in (
            task.private, task.bn_state, task.piggymask or {})
            for t in tree.values())
    assert "layer2.0.downsample.1.running_var" in got["state_dict"]
    assert got["masks"]["layer4.0.downsample.0"].shape == (256, 128, 1, 1)
    from cpg_tpu_torch.utils.checkpoint import save_state

    ck, pth, back = (str(tmp_path / n) for n in ("ck", "ref.pth", "back"))
    save_state(st, ck)
    assert cli.main(["export-torch", "--ckpt", ck, "--out", pth,
                     "--device", "cpu"]) == 0
    assert cli.main(["import-torch", "--ckpt", pth, "--arch", ARCH, "--out",
                     back, "--device", "cpu"]) == 0
    _states_eq(state_to_numpy(load_state(back, device="cpu")), np_state)


# ---------------------------------------------------------- the cycle ----

HW = 32
SEQ = dict(finetune_epochs=1, prune_epochs=1, retrain_epochs=1,
           prune_ratios=(0.5,), batch_size=20, prune_freq=1, seed=0, lr=2e-4,
           max_width_mult=MULT)
KERNELS = dict(use_pallas_conv=True, use_fused_chain=True)
TASKS = {"cubs_cropped": t_fg.finegrained_task("cubs_cropped", max_classes=5,
                                               seed=0, hw=(HW, HW))}


def _jax_adopt(jst, *trees):
    """`cpg_tpu`'s adopt_pretrained_task1, its fresh init (discarded: every
    tree is supplied) drawn at 32 px rather than the registry's 224."""
    from cpg_tpu import models as j_models

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(j_models.REGISTRY, ARCH, (j_get_model(ARCH)[0],
                                             (32, 32, 3)))
        j_pre.adopt_pretrained_task1(jst, "imagenet", 1000, *trees)


def _damped(init):
    """`cpg_tpu`'s fw.init with every residual branch's last BN scale set
    to U(0.1, 0.3) (one draw per shape, the same in both packages): the
    fine-grained task's fresh BN affines damped as the ResNet tests' state
    is (at scale 1 the random 16-block net is chaotic under training)."""
    def init_fn(*args, **kw):
        shared, private, bn = init(*args, **kw)
        private = dict(private)
        for k, v in private.items():
            if k.endswith("/bn3/scale"):
                private[k] = jnp.asarray(np.random.RandomState(v.size).uniform(
                    0.1, 0.3, v.shape).astype(np.float32))
        return shared, private, bn

    return init_fn


def jax_init(gen, model_fn, sample_x, **kw):
    """The init seam: `cpg_tpu`'s `fw.init` (damped by `cycles`) under the
    key its cycle uses at this point (`PRNGKey` of the port's generator's
    seed)."""
    out = j_fw.init(jax.random.PRNGKey(gen.initial_seed()),
                    j_get_model(ARCH)[0], jnp.zeros(tuple(sample_x.shape)),
                    **kw)
    return tuple({k: torch.from_numpy(np.array(v)) for k, v in t.items()}
                 for t in out)


def jax_draws(seed):
    """The draws seam: the pad-16 crop offsets and flips of the JAX
    Manager's key, split once a step."""
    key = [jax.random.PRNGKey(seed)]

    def draw(n):
        key[0], sub = jax.random.split(key[0])
        return _jax_draws(sub, n, pad=16)

    return draw


@pytest.fixture(scope="module")
def start(adopted):
    """The adopted states (copies) with task 1 pruned to half, in both
    packages (bit-equal), then task 1's BN running statistics settled on
    the pruned net (`_settle`; the adopted ones are the masked two-task
    net's) and set in both."""
    _, tst, jst = adopted
    tst = state_from_numpy(state_to_numpy(tst), "cpu")
    jst = dataclasses.replace(jst, tasks=dict(jst.tasks))
    tst.shared, tst.ownership = one_shot_prune(tst.shared, tst.ownership, 1,
                                               0.5)
    jst.shared, jst.ownership = j_one_shot_prune(jst.shared, jst.ownership, 1,
                                                 0.5)
    _states_eq(state_to_numpy(tst), jst)
    np_state = state_to_numpy(tst)
    _settle(np_state, 1, _images(20, 40, HW))
    bn = np_state.tasks[1].bn_state
    tst.tasks[1].bn_state = {k: torch.from_numpy(v) for k, v in bn.items()}
    jst.tasks[1] = dataclasses.replace(
        jst.tasks[1], bn_state={k: jnp.asarray(v) for k, v in bn.items()})
    return tst, jst


@pytest.fixture(scope="module")
def cycles(start):
    """Both cycles under the damped init, with every prune event's cutoff
    band recorded (`tests/test_torch_cycle.py`'s spies)."""
    tst, jst = start
    jev, tev = [], []
    j_orig, t_orig = j_pruner_mod.gradual_prune, t_pruner_mod.gradual_prune_

    def j_spy(shared, ownership, task_id, target, n0):
        out = j_orig(shared, ownership, task_id, target, n0)
        jev.append({k: _record(shared[k], ownership[k], task_id, out[1][k])
                    for k in shared})
        return out

    def t_spy(shared, ownership, task_id, target, n0):
        before = {k: (shared[k].clone(), ownership[k].clone())
                  for k in shared}
        t_orig(shared, ownership, task_id, target, n0)
        tev.append({k: _record(*before[k], task_id, ownership[k])
                    for k in shared})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fw, "init", _damped(j_fw.init))
        mp.setattr(j_pruner_mod, "gradual_prune", j_spy)
        mp.setattr(t_pruner_mod, "gradual_prune_", t_spy)
        jst, jrep = j_run_sequence(
            ARCH, TASKS, JConfig(compute_dtype=jnp.float32, lr=SEQ["lr"]),
            JSeq(**SEQ), augment_fn=j_aug.imagenet_train_augment,
            preprocess_fn=j_aug.imagenet_eval_preprocess, state=jst)
        before = {k: v.clone() for k, v in tst.shared.items()}
        tst, trep = run_sequence(
            ARCH, TASKS, TrainConfig(compute_dtype=torch.float32,
                                     lr=SEQ["lr"], **KERNELS),
            SequenceConfig(**SEQ), augment_fn=t_aug.imagenet_train_augment,
            preprocess_fn=t_aug.imagenet_eval_preprocess, state=tst,
            device="cpu", init_fn=jax_init, draws=jax_draws)
    return jst, jrep, tst, trep, before, jev, tev


def test_cycle_matches_jax(cycles):
    """One fine-grained task picked and compacted on top of the adopted,
    half-pruned task 1 (settled statistics, damped residual branches), at
    the reference's allow_acc_diff (0.005: ratio 0.5 is kept only if its
    accuracy holds the pick's). Held as the VGG16-BN cycle test holds its
    cycle: the task list, the pick and compaction accuracies and the
    chosen ratio exactly; the same prune events; the owned count of every
    layer for the free pool and each task exactly; ownership entry for
    entry except inside the prune events' cutoff band (|w| within 1e-5 x
    the layer's max|w| of the cutoff in both packages: here most of task
    2's entries, claimed zeros grown to 1e-7..2e-4, far smaller than the
    adopted weights; 30 of 367,512 entries differ, measured); every weight outside the
    differing entries at rtol 1e-4, atol 5e-5; task 1's entries bit for bit
    in the port, free entries zero, a clean check_state; both tasks' logits
    at rtol 1e-4, atol 1e-5."""
    jst, jrep, tst, trep, before, jev, tev = cycles
    assert [r.name for r in trep] == [r.name for r in jrep] == list(TASKS)
    for j, t in zip(jrep, trep):
        assert (t.pick_acc, t.final_acc, t.chosen_ratio, t.ratio_to_acc) == (
            j.pick_acc, j.final_acc, j.chosen_ratio, j.ratio_to_acc)
    assert len(tev) == len(jev) > 0
    assert check_state(tst) == []
    band_total = mismatch_total = 0
    for k in jst.shared:
        jo, to = np.asarray(jst.ownership[k]), tst.ownership[k].numpy()
        for tid in (0, 1, 2):
            assert int((to == tid).sum()) == int((jo == tid).sum()), (k, tid)
        band = np.zeros(jo.shape, bool)
        for je, te in zip(jev, tev):
            if je[k] is not None and te[k] is not None:
                band |= je[k] & te[k]
        off = jo != to
        assert not (off & ~band).any(), (k, int((off & ~band).sum()))
        band_total += int(band.sum())
        mismatch_total += int(off.sum())
        one = to == 1
        _eq(one, jo == 1, k)
        _eq(tst.shared[k].numpy()[one], before[k].numpy()[one], k)
        assert not tst.shared[k].numpy()[to == 0].any(), k
        np.testing.assert_allclose(tst.shared[k].numpy()[~off],
                                   np.asarray(jst.shared[k])[~off],
                                   rtol=1e-4, atol=5e-5, err_msg=k)
    n = sum(v.numel() for v in tst.ownership.values())
    print(f"\nownership: {mismatch_total} of {n} entries differ, all inside "
          f"the cutoff band of {band_total} entries; chosen ratio "
          f"{trep[0].chosen_ratio}")
    assert mismatch_total <= 1e-3 * n
    x = TASKS["cubs_cropped"]["test_x"]
    for tid in (1, 2):
        want = np.asarray(j_predict(jst, tid, j_aug.imagenet_eval_preprocess(
            jnp.asarray(x))))
        got = predict(tst, tid, t_aug.imagenet_eval_preprocess(
            torch.from_numpy(x)), device="cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5,
                                   err_msg=str(tid))


# ---------------------------------------------------------------- cli ----

def test_cli_experiment_tasks_match_jax():
    """`--experiment finegrained` and `--experiment face` resolve to
    `cpg_tpu`'s arch, task names and bytes, with --max-classes and
    --num-tasks; textcls resolves to its own arch."""
    argv = ["sequence", "--experiment", "finegrained", "--num-tasks", "2",
            "--max-classes", "3"]
    ta, ja = cli.build_parser().parse_args(argv), j_cli.build_parser(
    ).parse_args(argv)
    tarch, ttasks, taug, tprep = cli._experiment_tasks(ta)
    jarch, jtasks, _, _ = j_cli._experiment_tasks(ja)
    assert tarch == jarch == ARCH and list(ttasks) == list(jtasks)
    for name in jtasks:
        for k in ("train_x", "train_y", "test_x", "test_y", "num_classes"):
            _eq(ttasks[name][k], jtasks[name][k], f"{name} {k}")
    assert (taug, tprep) == (t_aug.imagenet_train_augment,
                             t_aug.imagenet_eval_preprocess)
    # textcls is ported too (tests/test_torch_port_text.py): its own arch
    args = cli.build_parser().parse_args(["sequence", "--experiment",
                                          "textcls", "--num-tasks", "1"])
    assert cli._experiment_tasks(args)[0] == "textcls"
    # the face experiment is ported: `cpg_tpu`'s arch, tasks and bytes
    argv = ["sequence", "--experiment", "face", "--num-tasks", "2"]
    ta, ja = cli.build_parser().parse_args(argv), j_cli.build_parser(
    ).parse_args(argv)
    tarch, ttasks, taug, tprep = cli._experiment_tasks(ta)
    jarch, jtasks, _, _ = j_cli._experiment_tasks(ja)
    assert tarch == jarch == "spherenet20"
    assert list(ttasks) == list(jtasks) == ["casia", "expressions"]
    for name in jtasks:
        for k in ("train_x", "train_y", "test_x", "test_y", "num_classes",
                  "model_kwargs"):
            _eq(ttasks[name][k], jtasks[name][k], f"{name} {k}")
    assert ttasks["casia"]["loss_fn"].wants_step
    assert (taug, tprep) == (t_aug.face_train_augment,
                             t_aug.face_eval_preprocess)


def test_cli_finegrained_sequence_end_to_end(tmp_path, capsys):
    """`sequence --experiment finegrained` on the CPU at width 0.125 with a
    torchvision-keyed --pretrained-npz, --max-classes and both kernel
    flags: the JSON summary, a clean final checkpoint whose task 1 is the
    converted net (its logits equal the converted weights' forward, bit
    for bit), then `export` (f32 and calibrated int8), `serve` and
    `inference` on the fine-grained preprocess."""
    npz = str(tmp_path / "pre.npz")
    sd = _torchvision_sd(4)
    np.savez(npz, **sd)
    ck = str(tmp_path / "ck")
    argv = ["sequence", "--experiment", "finegrained", "--device", "cpu",
            "--num-tasks", "1", "--max-classes", "3", "--pretrained-npz",
            npz, "--use-pallas-conv", "--fused-chain", "--dtype", "float32",
            "--network_width_multiplier", str(MULT),
            "--max_allowed_network_width_multiplier", str(MULT),
            "--finetune-epochs", "1", "--prune-epochs", "1",
            "--retrain-epochs", "1", "--prune-ratios", "0.5",
            "--batch-size", "12", "--checkpoint-dir", ck]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [t["name"] for t in out["tasks"]] == ["cubs_cropped"]
    assert out["final_width_mult"] == MULT
    path = os.path.join(ck, "task02_cubs_cropped")
    st = load_state(path, device="cpu")
    assert [t.name for t in st.tasks.values()] == ["imagenet", "cubs_cropped"]
    assert check_state(st) == []
    shared, private, bn = t_pre.convert_torch_resnet50(sd)
    x = t_aug.imagenet_eval_preprocess(torch.from_numpy(
        np.random.RandomState(5).randint(0, 256, (2, 224, 224, 3))
        .astype(np.uint8)))
    want, _ = t_fw.apply(get_model(ARCH)[0],
                         {k: torch.from_numpy(v) for k, v in shared.items()},
                         {k: torch.from_numpy(v) for k, v in private.items()},
                         {k: torch.from_numpy(v) for k, v in bn.items()}, x,
                         train=False, num_classes=1000, mult=MULT)
    assert torch.equal(predict(st, 1, x, device="cpu"), want)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(argv + ["--init-from", path])

    calib = str(tmp_path / "calib.npz")
    np.savez(calib, x=np.random.RandomState(6).randint(
        0, 256, (4, 224, 224, 3)).astype(np.uint8))
    req = str(tmp_path / "req.npz")
    np.savez(req, x=np.random.RandomState(7).randint(
        0, 256, (3, 224, 224, 3)).astype(np.uint8))
    for q in ([], ["--int8", "--calibrate", calib]):
        art = str(tmp_path / f"art{len(q)}")
        assert cli.main(["export", "--checkpoint", path, "--out", art,
                         "--experiment", "finegrained", "--device", "cpu",
                         *q]) == 0
        rep = json.loads(capsys.readouterr().out)
        assert rep["calibrated_tasks"] == (2 if q else 0)
        res = str(tmp_path / f"out{len(q)}.npz")
        assert cli.main(["serve", "--artifact", art, "--requests", req,
                         "--task-id", "2", "--out", res, "--experiment",
                         "finegrained", "--device", "cpu"]) == 0
        capsys.readouterr()
        assert np.load(res)["logits"].shape == (3, 3)
    assert cli.main(["inference", "--checkpoint", path, "--task-id", "2",
                     "--experiment", "finegrained", "--max-classes", "3",
                     "--num-tasks", "1", "--batch-size", "4",
                     "--device", "cpu"]) == 0
    inf = json.loads(capsys.readouterr().out)
    assert inf["task"] == "cubs_cropped" and inf["n"] == 6
