"""The port's MoE family (`smoe`, `vit_moe_cifar`: routing, the model,
serving, the eval and train steps, growth by whole experts) against
`cpg_tpu`, on the CPU.

Inputs are made from a numpy seed and states go from one package to the
other with `state_from_numpy`; both run in f32. The model is
`vit_moe_cifar` cut to depth 2 (block 1 the MoE), dim 64, 2 heads of 32,
4 experts of 256 hidden units, patch 8 (16 tokens, capacity 5), batch 4.
The kernel flags (`use_pallas`, `flash_attention`) run the plain versions
here, held to JAX's default step; the expert products are einsums in both
packages.

Tolerances: logits rtol 1e-4, atol 1e-5; routing (choices, slots, dropped
tokens) exact; three train steps as tests/test_torch_port_vit.py
`_assert_runs_match`; growth bit for bit; int8 within `cpg_tpu`'s bound of
the f32 server.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.core.state import CPGState as JState
from cpg_tpu.core.state import TaskEntry as JTask
from cpg_tpu.data.augment import cifar_eval_preprocess as j_prep
from cpg_tpu.models import framework as j_fw
from cpg_tpu.models.moe import smoe as j_smoe
from cpg_tpu.models.moe import vit_moe_cifar as j_vit_moe
from cpg_tpu.ops.masked import effective_params as j_eff
from cpg_tpu.serve import TaskServer as JServer
from cpg_tpu.train import sequence as j_seq
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu.train.step import build_eval_step as j_build_eval_step
from cpg_tpu.train.step import build_train_step as j_build_train_step
from cpg_tpu_torch.core.state import (CPGState, TaskEntry, state_from_numpy,
                                      state_to_numpy)
from cpg_tpu_torch.data.augment import cifar_eval_preprocess as t_prep
from cpg_tpu_torch.inference import predict
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.models import moe as t_moe
from cpg_tpu_torch.ops.masked import effective_params as t_eff
from cpg_tpu_torch.serve import TaskServer
from cpg_tpu_torch.train import sequence as t_seq
from cpg_tpu_torch.train import step as t_step

from .test_torch_port_vit import _assert_runs_match, _piggymask

torch.set_num_threads(1)
MOE = dict(depth=2, dim=64, heads=2, patch=8)
NC, BATCH, STEPS = 5, 4, 3


def _close(got, want, rtol=1e-4, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=str(what))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=str(what))


def _images(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3)).astype(
        np.uint8)


def port_init(key, model_fn, sample_x, compute_dtype=None, **kw):
    """In place of `cpg_tpu`'s fw.init: the port's vit_moe_cifar init from
    a generator seeded as `key` (`PRNGKey(seed)`), as jnp trees."""
    seed = int(np.asarray(key).ravel()[-1])
    out = t_fw.init(torch.Generator().manual_seed(seed), t_moe.vit_moe_cifar,
                    torch.zeros(tuple(sample_x.shape)), **kw)
    return tuple({k: jnp.asarray(v.numpy()) for k, v in t.items()}
                 for t in out)


# ------------------------------------------------------------ routing ----

def _j_route(x, wr, br, cap):
    """`cpg_tpu`'s routing ops (models/moe.py smoe): choice and slot."""
    probs = jax.nn.softmax(jnp.einsum("ntd,de->nte", x, wr) + br, axis=-1)
    choice = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(choice, wr.shape[1], dtype=jnp.float32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=1) * onehot, axis=-1) - 1.0
    slot = jax.nn.one_hot(pos.astype(jnp.int32), cap, dtype=jnp.float32)
    return jnp.max(probs, axis=-1), onehot, slot


def _smoe_both(x, wr, br, w1, w2, mult=1.0):
    """smoe of both packages on the same parameters (f32)."""
    p = {"m/router/kernel": wr, "m/router/gate_bias": br}
    s = {"m/experts/fc1/kernel": w1, "m/experts/fc2/kernel": w2}
    jctx = j_fw.Ctx(mode="apply", train=False, shared=s, private=p,
                    compute_dtype=jnp.float32)
    tctx = t_fw.Ctx(mode="apply", train=False,
                    shared={k: torch.from_numpy(v) for k, v in s.items()},
                    private={k: torch.from_numpy(v) for k, v in p.items()})
    want = j_smoe(jctx, "m", jnp.asarray(x), 4, w1.shape[-1], mult)
    got = t_moe.smoe(tctx, "m", torch.from_numpy(x), 4, w1.shape[-1], mult)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("case", ["random", "overflow", "ties"])
def test_smoe_routing_matches_jax(case):
    """Expert choices, capacity slots and dropped tokens equal exactly, and
    smoe's outputs within rtol 1e-4: random routing; one expert favoured so
    that 11 of an example's 16 tokens overflow its capacity of 5 (their
    outputs exactly 0 in both); all logits tied (the first expert, as
    jnp.argmax, and its first 5 tokens)."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 16, 8).astype(np.float32)
    wr = (rng.randn(8, 4) * 0.5).astype(np.float32)
    br = np.zeros(4, np.float32)
    if case == "overflow":
        br[2] = 20.0
    if case == "ties":
        wr[:] = 0.0
    w1 = (rng.randn(4, 8, 12) * 0.3).astype(np.float32)
    w2 = (rng.randn(4, 12, 8) * 0.3).astype(np.float32)
    cap = t_moe.capacity(16, 4, 1.25)
    assert cap == 5
    gate, onehot, slot = t_moe.route(torch.from_numpy(x), torch.from_numpy(wr),
                                     torch.from_numpy(br), cap)
    jg, jon, jslot = _j_route(jnp.asarray(x), jnp.asarray(wr),
                              jnp.asarray(br), cap)
    _eq(onehot.numpy(), jon, "choice")
    _eq(slot.numpy(), jslot, "slot")
    _close(gate.numpy(), jg, 1e-6, 1e-7, "gate")
    got, want = _smoe_both(x, wr, br, w1, w2)
    _close(got, want)
    dropped = slot.sum(-1).numpy() == 0
    _eq(dropped, np.asarray(jslot).sum(-1) == 0)
    assert not got[dropped].any() and not want[dropped].any()
    if case == "overflow":
        assert dropped.sum() == 3 * 11
    if case == "ties":
        assert (onehot.numpy().argmax(-1) == 0).all()
        _eq(dropped[0], np.arange(16) >= 5)


def test_smoe_is_batching_invariant():
    """Routing and capacity are per example: each example's routing is the
    same alone as in a batch, bit for bit, and so is its output up to the
    batched product's summation order (rtol 1e-6): a token's answer never
    depends on what shares its batch. The batch holds one example whose
    tokens all pick one expert, which overflows only its own capacity."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, 16, 8).astype(np.float32))
    x[3] = x[3].abs()
    wr = torch.from_numpy((rng.randn(8, 4) * 0.5).astype(np.float32))
    wr[:, 1] = 5.0  # example 3: every token to expert 1
    br = torch.zeros(4)
    p = {"m/router/kernel": wr, "m/router/gate_bias": br}
    s = {"m/experts/fc1/kernel": torch.from_numpy(
             (rng.randn(4, 8, 12) * 0.3).astype(np.float32)),
         "m/experts/fc2/kernel": torch.from_numpy(
             (rng.randn(4, 12, 8) * 0.3).astype(np.float32))}

    def run(xs):
        ctx = t_fw.Ctx(mode="apply", train=False, shared=s, private=p)
        return (t_moe.smoe(ctx, "m", xs, 4, 12),
                t_moe.route(xs, wr, br, t_moe.capacity(16, 4, 1.25)))

    batch, routed = run(x)
    assert routed[2][3].sum() == 5  # 11 of example 3's tokens dropped
    for i in range(4):
        alone, routed1 = run(x[i:i + 1])
        for a, b in zip(routed, routed1):
            _eq(a[i:i + 1], b, i)
        _close(batch[i:i + 1], alone, 1e-6, 1e-7, i)


# ------------------------------------------------------- model, state ----

def test_vit_moe_params_match_jax_keys_and_shapes():
    """Same shared/private keys and shapes as `cpg_tpu` at full width (the
    experts' stacked kernels shared, the router private), through
    init_state/start_task."""
    shapes = jax.eval_shape(lambda: j_fw.init(
        jax.random.PRNGKey(0), j_vit_moe, jnp.zeros((1, 32, 32, 3)),
        num_classes=NC))
    g = torch.Generator().manual_seed(0)
    state = t_seq.init_state("vit_moe_cifar", g, device="cpu")
    t_seq.start_task(state, "t1", NC, g)
    assert {k: tuple(v.shape) for k, v in state.shared.items()} == {
        k: v.shape for k, v in shapes[0].items()}
    assert {k: tuple(v.shape) for k, v in state.tasks[1].private.items()} \
        == {k: v.shape for k, v in shapes[1].items()}
    assert state.shared["blocks/1/moe/experts/fc1/kernel"].shape == (
        4, 256, 1024)
    assert state.tasks[1].private["blocks/1/moe/router/kernel"].shape == (
        256, 4)


def _np_state(seed=0) -> CPGState:
    """A two-task cut-down vit_moe_cifar state of numpy arrays (ownership
    over tasks 1-2 with some entries free, task 2's piggymask around the
    threshold, private params off their init, routers at unit scale so
    that every expert takes tokens)."""
    rng = np.random.RandomState(seed)
    shared, private, _ = t_fw.init(torch.Generator().manual_seed(0),
                                   t_moe.vit_moe_cifar,
                                   torch.zeros((1, 32, 32, 3)),
                                   num_classes=NC, **MOE)
    sh = {k: w.numpy() for k, w in shared.items()}
    own = {k: rng.choice([0, 1, 2], p=[0.1, 0.45, 0.45], size=w.shape)
           .astype(np.int8) for k, w in sh.items()}
    for k in sh:
        sh[k] = np.where(own[k] == 0, 0, sh[k]).astype(np.float32)

    def task_private():
        out = {}
        for k, v in private.items():
            if k.endswith("/scale"):
                out[k] = rng.uniform(0.5, 1.5, v.shape)
            elif k in ("classifier/kernel", "blocks/1/moe/router/kernel"):
                out[k] = rng.randn(*v.shape)
            else:
                out[k] = rng.randn(*v.shape) * 0.1
        return {k: v.astype(np.float32) for k, v in out.items()}

    tasks = {1: TaskEntry("t1", NC, None, task_private(), {}),
             2: TaskEntry("t2", NC, {k: _piggymask(rng, w.shape)
                                     for k, w in sh.items()},
                          task_private(), {})}
    return CPGState("vit_moe_cifar", 1.0, sh, own, tasks,
                    model_kwargs=dict(MOE))


def _to_jax(s: CPGState) -> JState:
    return JState(arch=s.arch, width_mult=s.width_mult, shared=s.shared,
                  ownership=s.ownership,
                  tasks={tid: JTask(**dataclasses.asdict(t))
                         for tid, t in s.tasks.items()},
                  threshold=s.threshold, mask_mode=s.mask_mode,
                  model_kwargs=dict(s.model_kwargs))


@pytest.fixture(scope="module")
def np_state():
    return _np_state()


@pytest.mark.parametrize("flash", [False, True])
def test_vit_moe_forward_matches_jax(np_state, flash):
    """Task 2's logits from effective weights; the port's flash path held
    to JAX's einsum attention; some tokens dropped by the MoE block."""
    x = _images(BATCH, 5).astype(np.float32) / 255.0
    t2 = np_state.tasks[2]
    want, _ = jax.jit(functools.partial(
        j_fw.apply, j_vit_moe, train=False, num_classes=NC, **MOE))(
        j_eff(np_state.shared, np_state.ownership, t2.piggymask, 2),
        t2.private, {}, jnp.asarray(x))
    st = state_from_numpy(np_state, "cpu")
    got, _ = t_fw.apply(t_moe.vit_moe_cifar,
                        t_eff(st.shared, st.ownership, st.tasks[2].piggymask,
                              2), st.tasks[2].private, {},
                        torch.from_numpy(x), train=False,
                        flash_attention=flash, num_classes=NC, **MOE)
    assert got.shape == (BATCH, NC)
    _close(got.numpy(), want)


# ------------------------------------------------------- eval, train ----

KERNELS = dict(use_pallas=True, flash_attention=True)
STEP_KW = dict(num_classes=NC, mult=1.0, has_piggymask=True,
               model_kwargs=MOE)


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["default", "kernels"])
def test_eval_step_matches_jax(np_state, flags):
    """The port's eval step, default and with the dense route and flash
    attention, against JAX's default step."""
    x, y = _images(BATCH, 7), np.arange(BATCH) % NC
    jst = _to_jax(np_state)
    jstep = jax.jit(j_build_eval_step(
        j_vit_moe, preprocess_fn=j_prep,
        cfg=JConfig(compute_dtype=jnp.float32), **STEP_KW))
    t2 = jst.tasks[2]
    want, jm = jstep(jst.shared, t2.piggymask, t2.private, {}, jst.ownership,
                     2, jnp.asarray(x), jnp.asarray(y))
    st = state_from_numpy(np_state, "cpu")
    tstep = t_step.make_eval_step(
        t_moe.vit_moe_cifar, preprocess_fn=t_prep, device="cpu",
        cfg=t_step.TrainConfig(compute_dtype=torch.float32, **flags),
        **STEP_KW)
    s2 = st.tasks[2]
    got, tm = tstep(st.shared, s2.piggymask, s2.private, {}, st.ownership, 2,
                    x, y)
    _close(got.numpy(), want)
    assert int(tm["acc_sum"]) == int(jm["acc_sum"])


BASE = dict(lr=2e-3, lr_mask=1e-4, label_smoothing=0.1)


def _ident(x, rng):
    return x


def _batches():
    rng = np.random.RandomState(9)
    return [(rng.randint(0, 256, (BATCH, 32, 32, 3)).astype(np.uint8),
             rng.randint(0, NC, BATCH)) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_run(np_state):
    """Three task-2 steps of JAX's default step (preprocess as the only
    augmentation, so that the draws play no part)."""
    st = _to_jax(np_state)
    task = st.tasks[2]
    step, (opt_w, opt_pm) = j_build_train_step(
        j_vit_moe, augment_fn=lambda x, rng: j_prep(x),
        cfg=JConfig(compute_dtype=jnp.float32, **BASE), **STEP_KW)
    shared, pm, priv = st.shared, task.piggymask, task.private
    ows, opms = opt_w.init({"shared": shared, "private": priv}), opt_pm.init(pm)
    jstep = jax.jit(step)
    losses = []
    for i, (x, y) in enumerate(_batches()):
        shared, pm, priv, _, ows, opms, m = jstep(
            shared, pm, priv, {}, ows, opms, st.ownership, 2,
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(i), i)
        losses.append(float(m["loss"]))
    return losses, shared, pm, priv


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["default", "kernels"])
def test_train_steps_match_jax(np_state, jax_run, flags):
    """Three task-2 steps of the port, default and with the dense route and
    flash attention, against JAX's default step (the experts' kernels
    trained through the select, their task-1 entries bit-frozen)."""
    st = state_from_numpy(np_state, "cpu")
    task = st.tasks[2]
    step, (opt_w, opt_pm) = t_step.build_train_step(
        t_moe.vit_moe_cifar, augment_fn=lambda x, rng: t_prep(x),
        device="cpu",
        cfg=t_step.TrainConfig(compute_dtype=torch.float32, **BASE, **flags),
        **STEP_KW)
    shared, pm, priv = st.shared, task.piggymask, task.private
    ows = opt_w.init({"shared": shared, "private": priv})
    opms = opt_pm.init(pm)
    losses = []
    for i, (x, y) in enumerate(_batches()):
        shared, pm, priv, _, ows, opms, m = step(
            shared, pm, priv, {}, ows, opms, st.ownership, 2, x, y, None, i)
        losses.append(float(m["loss"]))
    _assert_runs_match(jax_run, (losses, shared, pm, priv))
    k = "blocks/1/moe/experts/fc1/kernel"
    own, w0 = np_state.ownership[k], np_state.shared[k]
    _eq(shared[k].numpy()[own == 1], w0[own == 1])
    assert (shared[k].numpy()[own == 2] != w0[own == 2]).any()


# ------------------------------------------------------------- growth ----

def test_grow_state_adds_whole_experts_as_jax(np_state):
    """grow_state 1.0 -> 1.5 in both packages from one state, the fresh
    values from the port's init at one seed: 4 -> 6 experts, the old ones
    in the leading block, the new entries free; the router kernel padded
    with 0 and `gate_bias` with -1e9; every grown tree bit for bit, and
    both tasks' logits bit-equal across the growth (a grown expert gets
    exactly 0.0 of an old task's softmax)."""
    jst = _to_jax(state_to_numpy(state_from_numpy(np_state, "cpu")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fw, "init", port_init)
        j_seq.grow_state(jst, 1.5, jax.random.PRNGKey(7))
    st = state_from_numpy(np_state, "cpu")
    x = t_prep(torch.from_numpy(_images(6, 11)))
    before = {tid: predict(st, tid, x, device="cpu") for tid in (1, 2)}
    t_seq.grow_state(st, 1.5, torch.Generator().manual_seed(7),
                     device="cpu")
    k = "blocks/1/moe/experts/fc1/kernel"
    assert st.shared[k].shape == (6, 64, 256)
    _eq(st.shared[k][:4].numpy(), np_state.shared[k])
    assert not st.ownership[k][4:].any()
    for t in st.tasks.values():
        assert (t.private["blocks/1/moe/router/gate_bias"][4:] == -1e9).all()
        assert not t.private["blocks/1/moe/router/kernel"][:, 4:].any()
    for k in st.shared:
        _eq(st.shared[k].numpy(), jst.shared[k], k)
        _eq(st.ownership[k].numpy(), jst.ownership[k], k)
    for tid, t in st.tasks.items():
        for k, v in t.private.items():
            _eq(v.numpy(), jst.tasks[tid].private[k], k)
        for k, v in (t.piggymask or {}).items():
            _eq(v.numpy(), jst.tasks[tid].piggymask[k], k)
    for tid in (1, 2):
        _eq(predict(st, tid, x, device="cpu"), before[tid], tid)


# ------------------------------------------------------------ serving ----

def test_servers_match_jax_through_export_and_load(np_state, tmp_path):
    """f32 servers of both packages and artifacts loaded both ways; an int8
    server (the experts dequantized with one scale per output feature,
    shared across experts) within `cpg_tpu`'s bound |int8 - ref| <= 0.5 +
    0.2 |ref| of the f32 server and within 2e-2 x max|ref| of `cpg_tpu`'s
    int8 server, calibrated int8 bit-equal alone and co-batched."""
    jst, st = _to_jax(np_state), state_from_numpy(np_state, "cpu")
    x = _images(5, 6)
    jsrv = JServer(jst, j_prep, compute_dtype=jnp.float32)
    tsrv = TaskServer(st, t_prep, compute_dtype=torch.float32, device="cpu")
    for tid in (1, 2):
        _close(tsrv.predict(tid, x), jsrv.predict(tid, x), what=tid)
    jsrv.export(str(tmp_path / "jax"))
    tsrv.export(str(tmp_path / "port"))
    _close(TaskServer.load(str(tmp_path / "jax"), t_prep,
                           device="cpu").predict(2, x), jsrv.predict(2, x))
    _close(JServer.load(str(tmp_path / "port"), j_prep).predict(2, x),
           tsrv.predict(2, x))
    t8 = TaskServer(st, t_prep, quantize="int8", compute_dtype=torch.float32,
                    min_bucket=4, device="cpu")
    j8 = JServer(jst, j_prep, quantize="int8", compute_dtype=jnp.float32,
                 min_bucket=4)
    assert t8._scales[2]["blocks/1/moe/experts/fc1/kernel"].shape == (256,)
    for tid in (1, 2):
        got, want = t8.predict(tid, x), j8.predict(tid, x)
        np.testing.assert_allclose(got, tsrv.predict(tid, x), rtol=0.2,
                                   atol=0.5)
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    t8.calibrate({1: _images(8, 2), 2: _images(8, 3)})
    alone = t8.predict(2, x[:1])
    co = t8.predict(2, np.concatenate([x[:1], np.full((8, 32, 32, 3), 255,
                                                      np.uint8)]))
    _eq(co[:1], alone)
