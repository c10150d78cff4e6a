"""The port's ResNet-50 against `cpg_tpu`'s, on the CPU: the model, its
kernels at ResNet-50's geometries, serving, the eval step, the train step
and growth.

One two-task numpy state (width 0.125, random ownership over tasks 1-2 with
some entries free, task 2's piggymask around the threshold) goes into both
packages. On the JAX side the masked-conv and fused-chain Pallas kernels
run in interpret mode where an op is compared; whole models, servers and
steps run on `cpg_tpu`'s default path (the masked-conv and fused-chain
kernels are the same functions as its default layers within the op tests'
tolerances, and compiling ResNet-50's 53 interpreted kernels, forward and
backward, takes minutes on the CPU). The port runs its kernel flags (the
plain versions on the CPU) and its default path against it.

Tolerances: f32 logits rtol 1e-4, atol 1e-5 and the ops' gradients as in
`tests/test_torch_port_train.py`; train-mode BatchNorm, the train steps and
the int8 servers are looser, each with its reason where it is held.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.core.state import CPGState as JState
from cpg_tpu.core.state import TaskEntry as JTask
from cpg_tpu.data import augment as j_aug
from cpg_tpu.models import framework as j_fw
from cpg_tpu.models import get_model as j_get_model
from cpg_tpu.models.resnet import _maxpool_3x3_s2 as j_maxpool
from cpg_tpu.ops.masked import effective_params as j_eff
from cpg_tpu.ops.pallas.fused_chain import \
    fused_affine_relu_conv as j_fused_affine_relu_conv
from cpg_tpu.ops.pallas.masked_conv import masked_conv2d as j_masked_conv2d
from cpg_tpu.serve import TaskServer as JServer
from cpg_tpu.train.sequence import grow_state as j_grow_state
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu.train.step import build_train_step as j_build_train_step
from cpg_tpu_torch.core.state import (CPGState, TaskEntry, state_from_numpy,
                                      state_to_numpy)
from cpg_tpu_torch.data import augment as t_aug
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.models import get_model as t_get_model
from cpg_tpu_torch.models.resnet import _maxpool_3x3_s2 as t_maxpool
from cpg_tpu_torch.ops import fused_chain as t_fc
from cpg_tpu_torch.ops import masked_conv as t_mc
from cpg_tpu_torch.ops.masked import effective_params as t_eff
from cpg_tpu_torch.serve import TaskServer
from cpg_tpu_torch.train import step as t_step
from cpg_tpu_torch.train.sequence import grow_state

from .test_torch_port_train import _jax_draws, _piggymask

torch.set_num_threads(1)
ARCH, MULT, NC, HW = "resnet50", 0.125, 5, 64
BATCH, STEPS = 8, 2
INT8_TOL = 2e-2  # max|diff| <= INT8_TOL * max|ref|, as the int8 tests


def _close(got, want, rtol=1e-4, atol=1e-5, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _np_state(seed=0, mult=MULT) -> CPGState:
    """Two tasks of numpy arrays: He-scaled weights, ownership 10% free and
    45% each task, BN affines off their init (the residual branches' last
    BN scales at 0.1-0.3, see test_train_steps_match_jax) and running
    statistics those of a batch (`_settle`, so that eval-mode activations
    stay normalised through 16 residual blocks), heads N(0, 0.1^2), task
    2's piggymask around the threshold."""
    rng = np.random.RandomState(seed)
    model_fn, _ = t_get_model(ARCH)
    shared, private, bn = t_fw.init(torch.Generator().manual_seed(0),
                                    model_fn, torch.zeros((1, 32, 32, 3)),
                                    num_classes=NC, mult=mult)
    sh = {k: (rng.randn(*w.shape) * np.sqrt(
        2.0 / (w.shape[0] * w.shape[1] * w.shape[3]))).astype(np.float32)
        for k, w in shared.items()}
    own = {k: rng.choice([0, 1, 2], p=[0.1, 0.45, 0.45], size=w.shape)
           .astype(np.int8) for k, w in shared.items()}

    def task_private():
        out = {}
        for k, v in private.items():
            if k.endswith("/bn3/scale"):
                out[k] = rng.uniform(0.1, 0.3, v.shape)
            elif k.endswith("/scale"):
                out[k] = rng.uniform(0.5, 1.0, v.shape)
            elif k == "classifier/kernel":
                out[k] = rng.randn(*v.shape) * 0.1
            else:
                out[k] = rng.randn(*v.shape) * 0.1
        return {k: v.astype(np.float32) for k, v in out.items()}

    tasks = {1: TaskEntry("t1", NC, None, task_private(), dict(bn)),
             2: TaskEntry("t2", NC, {k: _piggymask(rng, w.shape)
                                     for k, w in sh.items()},
                          task_private(), dict(bn))}
    state = CPGState(ARCH, mult, sh, own, tasks)
    for tid in tasks:
        _settle(state, tid, _images(16, 30 + tid))
    return state


def _settle(state, tid, x):
    """Set task `tid`'s BN running statistics to those of one train-mode
    forward of x (from mean 0, var 1 at momentum 0.1: batch = (new - 0.9 *
    old) / 0.1)."""
    t = state.tasks[tid]
    st = state_from_numpy(state, "cpu")
    task = st.tasks[tid]
    with torch.no_grad():
        _, new = t_fw.apply(t_get_model(ARCH)[0],
                            t_eff(st.shared, st.ownership, task.piggymask,
                                  tid), task.private,
                            {k: torch.zeros_like(v) if k.endswith("/mean")
                             else torch.ones_like(v)
                             for k, v in task.bn_state.items()},
                            t_aug.imagenet_eval_preprocess(
                                torch.from_numpy(x)),
                            train=True, num_classes=t.num_classes,
                            mult=state.width_mult)
    t.bn_state = {k: ((v - (0.9 if k.endswith("/var") else 0.0)) / 0.1)
                  .numpy().astype(np.float32) for k, v in new.items()}


def _to_jax(s) -> JState:
    return JState(arch=s.arch, width_mult=s.width_mult, shared=s.shared,
                  ownership=s.ownership,
                  tasks={tid: JTask(**dataclasses.asdict(t))
                         for tid, t in s.tasks.items()},
                  threshold=s.threshold, mask_mode=s.mask_mode,
                  in_shape=s.in_shape)


def _images(n, seed, hw=HW):
    return np.random.RandomState(seed).randint(0, 256, (n, hw, hw, 3)).astype(
        np.uint8)


@pytest.fixture(scope="module")
def np_state():
    return _np_state()


@pytest.fixture(scope="module")
def jax_logits(np_state):
    """`cpg_tpu`'s eval-mode logits of both tasks on one batch (eager)."""
    model_fn = j_get_model(ARCH)[0]
    x = j_aug.imagenet_eval_preprocess(jnp.asarray(_images(8, 1)))
    out = {}
    for tid, t in np_state.tasks.items():
        eff = j_eff(np_state.shared, np_state.ownership, t.piggymask, tid)
        out[tid] = np.asarray(j_fw.apply(model_fn, eff, t.private, t.bn_state,
                                         x, train=False, num_classes=NC,
                                         mult=MULT)[0])
    return out


# ------------------------------------------------------------- model ----

def test_params_keys_shapes_and_order_match_jax():
    """The same 53 sharable kernels, private and BN keys, in the same
    registration order and shapes; a state crosses state_to_numpy /
    state_from_numpy unchanged."""
    order = []

    def j_init(key):  # traced only: the registration order, no compute
        out = j_fw.init(key, j_get_model(ARCH)[0], jnp.zeros((1, 32, 32, 3)),
                        num_classes=NC, mult=MULT)
        order.extend(list(t) for t in out)
        return out

    shapes = jax.eval_shape(j_init, jax.random.PRNGKey(0))
    got = t_fw.init(torch.Generator().manual_seed(0), t_get_model(ARCH)[0],
                    torch.zeros((1, 32, 32, 3)), num_classes=NC, mult=MULT)
    for g, keys, w in zip(got, order, shapes):
        assert list(g) == keys
        assert {k: tuple(v.shape) for k, v in g.items()} == {
            k: v.shape for k, v in w.items()}
    assert len(got[0]) == 53
    assert t_get_model(ARCH)[1] == j_get_model(ARCH)[1] == (224, 224, 3)
    s = _np_state(seed=3)
    back = state_to_numpy(state_from_numpy(s, "cpu"))
    for k in s.shared:
        _eq(back.shared[k], s.shared[k], k)
        _eq(back.ownership[k], s.ownership[k], k)
    for tid, t in s.tasks.items():
        for f in ("private", "bn_state", "piggymask"):
            for k, v in (getattr(t, f) or {}).items():
                _eq(getattr(back.tasks[tid], f)[k], v, f"{tid} {f} {k}")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_bn"])
def test_forward_matches_jax(np_state, train):
    """Task 2's effective params, f32, batch 8. In train mode each of the
    53 BatchNorms normalises by its batch's statistics, so a summation-
    order difference upstream moves every later layer's mean and variance
    too, and the relative difference grows from block to block (~3e-5 at
    layer4, measured): train-mode logits and running statistics hold at
    atol 1e-4 (logits of magnitude ~1), eval-mode ones at 1e-5."""
    t = np_state.tasks[2]
    x = np.random.RandomState(0).randn(8, HW, HW, 3).astype(np.float32)
    want = j_fw.apply(j_get_model(ARCH)[0],
                      j_eff(np_state.shared, np_state.ownership, t.piggymask,
                            2), t.private, t.bn_state, jnp.asarray(x),
                      train=train, num_classes=NC, mult=MULT)
    st = state_from_numpy(np_state, "cpu")
    task = st.tasks[2]
    got = t_fw.apply(t_get_model(ARCH)[0],
                     t_eff(st.shared, st.ownership, task.piggymask, 2),
                     task.private, task.bn_state, torch.from_numpy(x),
                     train=train, num_classes=NC, mult=MULT)
    _close(got[0], want[0], atol=1e-4 if train else 1e-5, what="logits")
    if train:
        assert set(got[1]) == set(want[1])
        for k in want[1]:
            _close(got[1][k], want[1][k], atol=1e-5, what=k)


def test_maxpool_ties_send_the_gradient_to_the_first_maximum():
    """The 3x3/2 pad-1 max pool and its gradient against XLA's
    reduce_window / select_and_scatter on inputs full of ties (values in
    {0, 1, 2}, integer cotangents, so every sum is exact): equal bits. On
    a constant input every window's gradient lands on its first (top-left
    in-bounds) element."""
    rng = np.random.RandomState(4)
    for x in (rng.randint(0, 3, (2, 9, 8, 3)).astype(np.float32),
              np.ones((1, 7, 7, 2), np.float32)):
        out = j_maxpool(jnp.asarray(x))
        g = rng.randint(1, 5, out.shape).astype(np.float32)
        want = jax.grad(lambda v: jnp.sum(j_maxpool(v) * g))(jnp.asarray(x))
        tx = torch.tensor(x, requires_grad=True)
        y = t_maxpool(tx)
        _eq(y.detach(), out, "pool")
        (y * torch.from_numpy(g)).sum().backward()
        _eq(tx.grad, want, "pool gradient")
    first = np.zeros((1, 7, 7, 2), np.float32)
    for i in range(4):
        for j in range(4):
            first[0, max(2 * i - 1, 0), max(2 * j - 1, 0)] += g[0, i, j]
    _eq(tx.grad, first, "first maximum")


def test_relu_gradient_at_zero_matches_jax():
    """`relu` is `cpg_tpu`'s jnp.maximum(x, 0): where x == 0 exactly it
    passes half the gradient (torch.relu passes none). A fresh task's zero
    BN bias over an all-zero pruned channel makes such ties, and at a
    residual sum they reach every later gradient of that BN."""
    x = np.array([-1.0, -0.0, 0.0, 0.5, 2.0], np.float32)
    g = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(j_fw.relu(v) * g))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    y = t_fw.relu(tx)
    _eq(y.detach(), j_fw.relu(jnp.asarray(x)), "relu")
    (y * torch.from_numpy(g)).sum().backward()
    _eq(tx.grad, want, "relu gradient")


# (name, input (N, H, W, Cin), kernel, Cout, stride, JAX padding, port padding)
CONV_GEOMETRIES = {
    "stem_7x7_s2": ((2, 15, 14, 3), 7, 8, 2, [(3, 3), (3, 3)],
                    ((3, 3), (3, 3))),
    "conv2_3x3_s2": ((2, 9, 8, 6), 3, 8, 2, [(1, 1), (1, 1)], 1),
    "downsample_1x1_s2": ((2, 9, 8, 6), 1, 12, 2, "SAME", "SAME"),
    "conv1_1x1": ((2, 7, 7, 8), 1, 12, 1, "SAME", "SAME"),
}


@pytest.mark.parametrize("geo", list(CONV_GEOMETRIES))
def test_masked_conv_resnet_geometries_match_jax(geo):
    """y, dx, dw and dpm of the masked conv at ResNet-50's geometries
    against `cpg_tpu`'s Pallas kernel and its VJP (interpret mode), at the
    masked-conv gradient tolerances of the train tests."""
    shape, k, cout, stride, jpad, tpad = CONV_GEOMETRIES[geo]
    rng = np.random.RandomState(len(geo))
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(k, k, shape[-1], cout) * 0.3).astype(np.float32)
    own = rng.choice([0, 1, 2, 3], size=w.shape).astype(np.int8)
    pm = (rng.randn(*w.shape) * 0.01).astype(np.float32)
    jy = j_masked_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(own),
                         jnp.asarray(pm), 2, stride=stride, padding=jpad)
    gref = rng.randn(*jy.shape).astype(np.float32)

    def j_loss(x, w, pm):
        return jnp.sum(j_masked_conv2d(x, w, jnp.asarray(own), pm, 2,
                                       stride=stride, padding=jpad) * gref)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(pm))
    tx, tw, tpm = (torch.tensor(v, requires_grad=True) for v in (x, w, pm))
    y = t_mc.masked_conv2d(tx, tw, torch.from_numpy(own), tpm, 2,
                           stride=stride, padding=tpad)
    _close(y, jy, what="y")
    (y * torch.from_numpy(gref)).sum().backward()
    for got, ref, what in zip((tx.grad, tw.grad, tpm.grad), want,
                              ("dx", "dw", "dpm")):
        _close(got, ref, what=what)


def test_fused_chain_at_a_7px_seam_matches_jax():
    """The fused BN+ReLU+conv3x3 at layer4's odd 7x7 grid, forward and
    gradients, against `cpg_tpu`'s Pallas kernel and its VJP (interpret
    mode), at the fused chain's tolerances (rtol / atol 2e-4)."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 7, 7, 16).astype(np.float32)
    a = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    b = (rng.randn(16) * 0.3).astype(np.float32)
    w = (rng.randn(3, 3, 16, 8) * 0.2).astype(np.float32)
    jy = j_fused_affine_relu_conv(*(jnp.asarray(v) for v in (x, a, b, w)),
                                  jnp.float32)
    gref = rng.randn(*jy.shape).astype(np.float32)
    want = jax.grad(lambda *v: jnp.sum(j_fused_affine_relu_conv(
        *v, jnp.float32) * gref), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (x, a, b, w)))
    tv = [torch.tensor(v, requires_grad=True) for v in (x, a, b, w)]
    y = t_fc.fused_affine_relu_conv(*tv, torch.float32)
    _close(y, jy, 2e-4, 2e-4, "y")
    (y * torch.from_numpy(gref)).sum().backward()
    for t, ref, what in zip(tv, want, ("dx", "da", "db", "dw")):
        _close(t.grad, ref, 2e-4, 2e-4, what)


# ------------------------------------------------------------- serving ----

@pytest.fixture(scope="module")
def calibrated(np_state):
    """Both packages' int8 servers in f32, calibrated on the same batches
    (one bucket of 8)."""
    jsrv = JServer(_to_jax(np_state), j_aug.imagenet_eval_preprocess,
                   quantize="int8", compute_dtype=jnp.float32)
    tsrv = TaskServer(state_from_numpy(np_state, "cpu"),
                      t_aug.imagenet_eval_preprocess, quantize="int8",
                      compute_dtype=torch.float32, device="cpu")
    calib = {1: _images(8, 2), 2: _images(8, 3)}
    return jsrv, tsrv, jsrv.calibrate(calib), tsrv.calibrate(calib)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_f32_server_matches_jax(np_state, jax_logits, fused):
    """The f32 TaskServer, with and without the fused chain, against
    `cpg_tpu`'s forward of the same effective params, both tasks."""
    srv = TaskServer(state_from_numpy(np_state, "cpu"),
                     t_aug.imagenet_eval_preprocess,
                     compute_dtype=torch.float32, fused_chain=fused,
                     device="cpu")
    for tid in (1, 2):
        _close(srv.predict(tid, _images(8, 1)), jax_logits[tid],
               what=f"task {tid}")


def test_calibrated_int8_server_matches_jax(calibrated):
    """Static activation scales at rtol 1e-5 and the calibrated int8
    logits within INT8_TOL x max|ref| with equal argmax (a last-bit f32
    difference before a quantization can flip one int8 step, as in
    `tests/test_torch_port_int8.py`)."""
    jsrv, tsrv, want, got = calibrated
    for tid in (1, 2):
        assert set(got[tid]) == set(want[tid]) and len(got[tid]) == 53
        for k, v in want[tid].items():
            np.testing.assert_allclose(got[tid][k].numpy(), np.asarray(v),
                                       rtol=1e-5, err_msg=k)
    x = _images(8, 4)
    for tid in (1, 2):
        g, w = tsrv.predict(tid, x), jsrv.predict(tid, x)
        assert np.abs(g - w).max() <= INT8_TOL * np.abs(w).max()
        np.testing.assert_array_equal(g.argmax(1), w.argmax(1))


def test_artifacts_load_across_packages(np_state, calibrated, tmp_path):
    """int8 (calibrated) and f32 artifacts exported by either package load
    in the other bit for bit, and serve the same logits."""
    jsrv, tsrv, _, _ = calibrated
    jsrv.export(str(tmp_path / "jax8"))
    tsrv.export(str(tmp_path / "port8"))
    from_jax = TaskServer.load(str(tmp_path / "jax8"),
                               t_aug.imagenet_eval_preprocess, device="cpu")
    from_port = JServer.load(str(tmp_path / "port8"),
                             j_aug.imagenet_eval_preprocess)
    for tid in (1, 2):
        for k, v in jsrv._eff[tid].items():
            _eq(from_jax._eff[tid][k], v, k)
            _eq(from_jax._scales[tid][k], jsrv._scales[tid][k], k)
        for k, v in jsrv._act_scales[tid].items():
            _eq(from_jax._act_scales[tid][k], v, k)
        for k, v in tsrv._eff[tid].items():
            _eq(v, from_port._eff[tid][k], k)
        for k, v in tsrv._act_scales[tid].items():
            _eq(v, from_port._act_scales[tid][k], k)
    x = _images(8, 5)
    _eq(TaskServer.load(str(tmp_path / "port8"),
                        t_aug.imagenet_eval_preprocess,
                        device="cpu").predict(2, x), tsrv.predict(2, x))
    f32 = TaskServer(state_from_numpy(np_state, "cpu"),
                     t_aug.imagenet_eval_preprocess,
                     compute_dtype=torch.float32, device="cpu")
    f32.export(str(tmp_path / "port32"))
    back = JServer.load(str(tmp_path / "port32"),
                        j_aug.imagenet_eval_preprocess)
    for k, v in f32._eff[2].items():
        _eq(v, back._eff[2][k], k)


# ------------------------------------------------------------ the steps ----

@pytest.mark.parametrize("flags", [{}, dict(use_pallas_conv=True,
                                            use_fused_chain=True)],
                         ids=["default", "kernels"])
def test_eval_step_matches_jax(np_state, jax_logits, flags):
    """The masked eval step (default, and with the masked-conv and fused
    chain kernels) against `cpg_tpu`'s forward of the effective params."""
    st = state_from_numpy(np_state, "cpu")
    t = st.tasks[2]
    step = t_step.make_eval_step(
        t_get_model(ARCH)[0], num_classes=NC, mult=MULT, has_piggymask=True,
        cfg=t_step.TrainConfig(compute_dtype=torch.float32, **flags),
        preprocess_fn=t_aug.imagenet_eval_preprocess, device="cpu")
    y = np.arange(8) % NC
    logits, m = step(st.shared, t.piggymask, t.private, t.bn_state,
                     st.ownership, 2, _images(8, 1), y)
    _close(logits, jax_logits[2], what="logits")
    assert int(m["acc_sum"]) == int((jax_logits[2].argmax(1) == y).sum())


BASE = dict(lr=2e-4, lr_mask=1e-4, label_smoothing=0.1)


def _batches():
    rng = np.random.RandomState(9)
    return [(_images(BATCH, 10 + i), rng.randint(0, NC, BATCH),
             jax.random.PRNGKey(20 + i)) for i in range(STEPS)]


@pytest.fixture(scope="module")
def jax_steps(np_state):
    """`cpg_tpu`'s default train step on task 2, compiled once."""
    st = _to_jax(np_state)
    task = st.tasks[2]
    step, (opt_w, opt_pm) = j_build_train_step(
        j_get_model(ARCH)[0], num_classes=NC, mult=MULT, has_piggymask=True,
        augment_fn=j_aug.imagenet_train_augment,
        cfg=JConfig(compute_dtype=jnp.float32, **BASE))
    shared, pm, priv, bn = st.shared, task.piggymask, task.private, task.bn_state
    ows, opms = opt_w.init({"shared": shared, "private": priv}), opt_pm.init(pm)
    jstep = jax.jit(step)
    losses = []
    for i, (x, y, key) in enumerate(_batches()):
        shared, pm, priv, bn, ows, opms, m = jstep(
            shared, pm, priv, bn, ows, opms, st.ownership, 2, jnp.asarray(x),
            jnp.asarray(y), key, i)
        losses.append(float(m["loss"]))
    return losses, shared, pm, priv, bn


@pytest.mark.parametrize("flags", [{}, dict(use_pallas_conv=True,
                                            use_fused_chain=True)],
                         ids=["default", "kernels"])
def test_train_steps_match_jax(np_state, jax_steps, flags):
    """Two steps of task 2 (augmentation draws of `cpg_tpu`'s keys handed
    in). Looser than the VGG16-BN steps, with the reasons: batch-4
    BatchNorm over 53 layers amplifies the packages' f32 summation-order
    differences from layer to layer (ResNet-50's train-mode logits alone
    differ by ~4e-5, see test_forward_matches_jax), so the losses hold at
    rtol 1e-4, the weights and BN entries at atol 1e-4, and each group's
    update (new - old, over all its tensors) within 1e-4 (shared), 2e-2
    (private: BN affines and head; 4e-3 measured) and 1e-3 (BN running
    statistics) of the JAX update's norm; the piggymasks as
    in `tests/test_torch_port_train.py` (Adam turns near-zero gradients'
    noise into updates of up to ~lr_mask, and ResNet-50's cross-package
    gradient noise, up to ~2e-3 of a tensor's gradient norm at this state,
    decides the sign of 2.8% of the entries' first updates: at most 5% may
    differ, by at most 3 * lr_mask, and no binarized mask bit may). The
    state keeps the residual branches' last BN scales at 0.1-0.3: at
    0.5-1.0 the random 16-block net amplifies a 1e-6 difference by ~1.4x a
    block and its gradients differ across the packages by 4%. Ownership
    gating holds exactly: prior entries unchanged, free entries zero."""
    st = state_from_numpy(np_state, "cpu")
    task = st.tasks[2]
    step, (opt_w, opt_pm) = t_step.build_train_step(
        t_get_model(ARCH)[0], num_classes=NC, mult=MULT, has_piggymask=True,
        augment_fn=t_aug.imagenet_train_augment, device="cpu",
        cfg=t_step.TrainConfig(compute_dtype=torch.float32, **BASE, **flags))
    shared, pm, priv, bn = st.shared, task.piggymask, task.private, task.bn_state
    ows, opms = opt_w.init({"shared": shared, "private": priv}), opt_pm.init(pm)
    losses = []
    for i, (x, y, key) in enumerate(_batches()):
        draws = _jax_draws(key, BATCH, pad=16)
        shared, pm, priv, bn, ows, opms, m = step(
            shared, pm, priv, bn, ows, opms, st.ownership, 2, x, y, draws, i)
        losses.append(float(m["loss"]))
    jl, jsh, jpm, jpr, jbn = jax_steps
    _close(np.array(losses), np.array(jl), 1e-4, 1e-6, "losses")
    for k in jsh:
        _close(shared[k], jsh[k], 1e-4, 1e-4, k)
        own = np_state.ownership[k]
        _eq(shared[k][own == 1], np_state.shared[k][own == 1], k)
        assert not shared[k][own == 0].any(), k
    bad = total = 0
    for k in jpm:
        got, want = pm[k].numpy(), np.asarray(jpm[k])
        _eq(got > np_state.threshold, np.asarray(want) > np_state.threshold,
            k)
        off = ~np.isclose(got, want, rtol=1e-4, atol=1e-7)
        bad, total = bad + int(off.sum()), total + off.size
        assert np.abs(got - want).max() <= 3 * BASE["lr_mask"], k
    assert bad <= 5e-2 * total, (bad, total)
    for k in jpr:
        _close(priv[k], jpr[k], 1e-4, 1e-4, k)
    for k in jbn:
        _close(bn[k], jbn[k], 1e-4, 1e-4, k)
    t2 = np_state.tasks[2]
    for got, want, old, bound in ((shared, jsh, np_state.shared, 1e-4),
                                  (priv, jpr, t2.private, 2e-2),
                                  (bn, jbn, t2.bn_state, 1e-3)):
        u = np.concatenate([(np.asarray(want[k]) - old[k]).ravel()
                            for k in want])
        v = np.concatenate([(got[k].numpy() - old[k]).ravel() for k in want])
        assert np.linalg.norm(u - v) <= bound * np.linalg.norm(u)


def test_grow_state_matches_jax():
    """grow_state 0.25 -> 0.375 (the 1.0 -> 1.5 step at a quarter of the
    width, which keeps the four fresh inits of 23.5M-parameter nets off the
    CPU) on a two-task ResNet-50 (32-px probe input):
    every shared kernel (the downsample convs too), ownership, piggymask,
    private entry (the block-output and downsample BNs, the head's 2048*m
    input rows) and BN statistic equals `cpg_tpu`'s bit for bit, the
    port's fresh values drawn by `cpg_tpu`'s init through the init_fn
    seam."""
    s = _np_state(seed=1, mult=0.25)
    s.in_shape = (32, 32, 3)
    key = jax.random.PRNGKey(3)

    def jax_init(gen, model_fn, sample_x, **kw):
        out = j_fw.init(key, j_get_model(ARCH)[0],
                        jnp.zeros(tuple(sample_x.shape)), **kw)
        return tuple({k: torch.from_numpy(np.array(v)) for k, v in t.items()}
                     for t in out)

    want = j_grow_state(_to_jax(s), 0.375, key)
    got = state_to_numpy(grow_state(state_from_numpy(s, "cpu"), 0.375,
                                    torch.Generator().manual_seed(3),
                                    device="cpu", init_fn=jax_init))
    assert got.width_mult == want.width_mult == 0.375
    assert got.shared["layer4/block2/conv3/kernel"].shape[-1] == 768
    for k in want.shared:
        _eq(got.shared[k], want.shared[k], k)
        _eq(got.ownership[k], want.ownership[k], k)
    for tid, w in want.tasks.items():
        g = got.tasks[tid]
        assert g.private["classifier/kernel"].shape == (768, NC)
        for f in ("private", "bn_state", "piggymask"):
            wt, gt = getattr(w, f), getattr(g, f)
            assert (gt is None) == (wt is None)
            for k, v in (wt or {}).items():
                _eq(gt[k], v, f"{tid} {f} {k}")
