"""The port's text family (`sembed`, `textcls`, the text data, serving, the
eval and train steps, growth and `--experiment textcls`) against
`cpg_tpu`, on the CPU.

Inputs are made from a numpy seed and states go from one package to the
other with `state_from_numpy`; both run in f32. The model is `textcls` cut
to depth 2, dim 64, 2 heads of 32, vocab 64, 16 tokens, batch 4. The
port's kernel flags (`use_pallas`, `flash_attention`) run the plain
versions here, held to JAX's default step, whose Pallas kernels JAX's own
tests hold to it (the flash kernel in interpret mode is held to the port's
in tests/test_torch_port_vit.py).

Tolerances: logits rtol 1e-4, atol 1e-5; three train steps as
tests/test_torch_port_vit.py `_assert_runs_match`; the data, the
tokenizers, the embedding's gather and int8 lookup bit for bit; growth
bit for bit (both packages draw the fresh values from the port's init at
one seed); int8 servers within `cpg_tpu`'s bound of the f32 server,
calibrated int8 bit-equal alone and co-batched; the CLIs' summaries equal.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu import cli as j_cli
from cpg_tpu.core.state import CPGState as JState
from cpg_tpu.core.state import TaskEntry as JTask
from cpg_tpu.data import text as j_text
from cpg_tpu.data import textfolder as j_textfolder
from cpg_tpu.models import framework as j_fw
from cpg_tpu.models.text import textcls as j_textcls
from cpg_tpu.ops.masked import effective_params as j_eff
from cpg_tpu.serve import TaskServer as JServer
from cpg_tpu.serve import _quantize_tree as j_quantize_tree
from cpg_tpu.train import sequence as j_seq
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu.train.step import build_eval_step as j_build_eval_step
from cpg_tpu.train.step import build_train_step as j_build_train_step
from cpg_tpu_torch import cli
from cpg_tpu_torch.core.invariants import check_state
from cpg_tpu_torch.core.state import (CPGState, TaskEntry, state_from_numpy,
                                      state_to_numpy)
from cpg_tpu_torch.data import text as t_text
from cpg_tpu_torch.data import textfolder as t_textfolder
from cpg_tpu_torch.inference import predict
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.models.text import textcls as t_textcls
from cpg_tpu_torch.ops.masked import effective_params as t_eff
from cpg_tpu_torch.serve import TaskServer, _quantize_tree
from cpg_tpu_torch.server_http import _as_batch
from cpg_tpu_torch.train import sequence as t_seq
from cpg_tpu_torch.train import step as t_step
from cpg_tpu_torch.train.manager import Manager
from cpg_tpu_torch.utils.checkpoint import load_state

from .test_torch_port_vit import _assert_runs_match, _piggymask

torch.set_num_threads(1)
TXT = dict(depth=2, dim=64, heads=2, vocab=64)
T, NC, BATCH, STEPS = 16, 5, 4, 3


def _close(got, want, rtol=1e-4, atol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=str(what))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=str(what))


def _tokens(n, seed, vocab=TXT["vocab"]):
    return np.random.RandomState(seed).randint(0, vocab, (n, T)).astype(
        np.int32)


def port_init(key, model_fn, sample_x, compute_dtype=None, **kw):
    """In place of `cpg_tpu`'s fw.init: the port's textcls init from a
    generator seeded as `key` (`PRNGKey(seed)`), as jnp trees (the same
    keys and shapes: test_textcls_params_match_jax_keys_and_shapes)."""
    seed = int(np.asarray(key).ravel()[-1])
    out = t_fw.init(torch.Generator().manual_seed(seed), t_textcls,
                    torch.zeros(tuple(sample_x.shape)), **kw)
    return tuple({k: jnp.asarray(v.numpy()) for k, v in t.items()}
                 for t in out)


# ------------------------------------------------------------ sembed ----

@pytest.mark.parametrize("kind", ["f32", "masked", "int8", "bf16"])
def test_sembed_matches_jax(kind):
    """The gather (repeated ids, f32 ids from init's sample batch), its
    gradient, the masked table of task 2, and the int8 lookup with its
    per-feature scale, against `framework.sembed`; in bf16 the table is
    cast before the gather, so a repeated row's gradient sums in bf16 as
    `cpg_tpu`'s does (bit for bit here)."""
    rng = np.random.RandomState(0)
    w = rng.randn(20, 8).astype(np.float32)
    ids = rng.randint(0, 20, (3, 7))
    ids[0, :3] = 5  # repeated rows: their gradients sum
    if kind == "bf16":
        ids[0, :6] = 5
        g = rng.randn(3, 7, 8).astype(np.float32)
        jctx = j_fw.Ctx(mode="apply", train=False, shared={"e/kernel": w},
                        compute_dtype=jnp.bfloat16)

        def j_loss(w):
            jctx.shared = {"e/kernel": w}
            y = j_fw.sembed(jctx, "e", jnp.asarray(ids), 20, 8)
            return jnp.sum(y.astype(jnp.float32) * g), y

        (_, want), dw = jax.value_and_grad(j_loss, has_aux=True)(
            jnp.asarray(w))
        tw = torch.from_numpy(w).requires_grad_(True)
        got = t_fw.sembed(t_fw.Ctx(mode="apply", train=False,
                                   shared={"e/kernel": tw},
                                   compute_dtype=torch.bfloat16), "e",
                          torch.from_numpy(ids), 20, 8)
        assert got.dtype == torch.bfloat16
        (got.float() * torch.from_numpy(g)).sum().backward()
        _eq(got.float().detach().numpy(), want.astype(jnp.float32))
        _eq(tw.grad.numpy(), dw)
        return
    own = rng.choice([0, 1, 2, 3], size=w.shape).astype(np.int8)
    pm = (rng.randn(*w.shape) * 0.01).astype(np.float32)
    jctx = j_fw.Ctx(mode="apply", train=False, shared={"e/kernel": w},
                    compute_dtype=jnp.float32)
    tctx = t_fw.Ctx(mode="apply", train=False,
                    shared={"e/kernel": torch.from_numpy(w)})
    if kind == "masked":
        jctx.masking = j_fw.Masking(ownership={"e/kernel": own},
                                    piggymask={"e/kernel": pm}, task_id=2)
        tctx.masking = t_fw.Masking(
            ownership={"e/kernel": torch.from_numpy(own)},
            piggymask={"e/kernel": torch.from_numpy(pm)}, task_id=2)
    if kind == "int8":
        jq, js = j_quantize_tree({"e/kernel": jnp.asarray(w)})
        tq, ts = _quantize_tree({"e/kernel": torch.from_numpy(w)})
        _eq(tq["e/kernel"], jq["e/kernel"])
        _eq(ts["e/kernel"], js["e/kernel"])
        assert ts["e/kernel"].shape == (8,)  # one scale a feature
        jctx.shared, jctx.quant_scales = jq, js
        tctx.shared, tctx.quant_scales = tq, ts
    want = j_fw.sembed(jctx, "e", jnp.asarray(ids, jnp.float32), 20, 8)
    got = t_fw.sembed(tctx, "e", torch.from_numpy(ids).float(), 20, 8)
    assert got.dtype == torch.float32 and got.shape == (3, 7, 8)
    _eq(got.numpy(), want, kind)
    if kind != "f32":
        return
    g = rng.randn(3, 7, 8).astype(np.float32)

    def j_loss(w):
        jctx.shared = {"e/kernel": w}
        return jnp.sum(j_fw.sembed(jctx, "e", jnp.asarray(ids), 20, 8) * g)

    tw = torch.from_numpy(w).requires_grad_(True)
    tctx.shared = {"e/kernel": tw}
    (t_fw.sembed(tctx, "e", torch.from_numpy(ids), 20, 8)
     * torch.from_numpy(g)).sum().backward()
    _close(tw.grad.numpy(), jax.grad(j_loss)(jnp.asarray(w)), 1e-6, 1e-6)


# ------------------------------------------------------- model, state ----

def test_textcls_params_match_jax_keys_and_shapes():
    """Same shared/private keys and shapes as `cpg_tpu` (traced by
    jax.eval_shape) at the registry's default width, and for the cut-down
    model through init_state/start_task with model_kwargs and batch_hw."""
    shapes = jax.eval_shape(lambda: j_fw.init(
        jax.random.PRNGKey(0), j_textcls, jnp.zeros((1, 64)), num_classes=NC))
    g = torch.Generator().manual_seed(0)
    state = t_seq.init_state("textcls", g, device="cpu")
    t_seq.start_task(state, "t1", NC, g, model_kwargs={"causal": True})
    assert {k: tuple(v.shape) for k, v in state.shared.items()} == {
        k: v.shape for k, v in shapes[0].items()}
    assert {k: tuple(v.shape) for k, v in state.tasks[1].private.items()} \
        == {k: v.shape for k, v in shapes[1].items()}
    assert state.shared["embed/kernel"].shape == (256, 128)
    assert state.forward_kwargs(1) == {"causal": True}
    small = t_seq.init_state("textcls", g, batch_hw=(T,), device="cpu",
                             model_kwargs=TXT)
    t_seq.start_task(small, "t1", NC, g)
    assert small.tasks[1].private["embed/pos"].shape == (T, 64)
    assert small.shared["embed/kernel"].shape == (64, 64)


def _np_state(seed=0) -> CPGState:
    """A two-task cut-down textcls state of numpy arrays: ownership over
    tasks 1-2 with some entries free, task 2's piggymask around the
    threshold, LayerNorm affines, positions and heads off their init, task
    2 causal."""
    rng = np.random.RandomState(seed)
    shared, private, _ = t_fw.init(torch.Generator().manual_seed(0),
                                   t_textcls, torch.zeros((1, T)),
                                   num_classes=NC, **TXT)
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
            elif k == "classifier/kernel":
                out[k] = rng.randn(*v.shape)
            else:
                out[k] = rng.randn(*v.shape) * 0.1
        return {k: v.astype(np.float32) for k, v in out.items()}

    tasks = {1: TaskEntry("t1", NC, None, task_private(), {}),
             2: TaskEntry("t2", NC, {k: _piggymask(rng, w.shape)
                                     for k, w in sh.items()},
                          task_private(), {},
                          {"model_kwargs": {"causal": True}})}
    return CPGState("textcls", 1.0, sh, own, tasks, model_kwargs=dict(TXT),
                    in_shape=(T,))


def _to_jax(s: CPGState) -> JState:
    return JState(arch=s.arch, width_mult=s.width_mult, shared=s.shared,
                  ownership=s.ownership,
                  tasks={tid: JTask(**dataclasses.asdict(t))
                         for tid, t in s.tasks.items()},
                  threshold=s.threshold, mask_mode=s.mask_mode,
                  model_kwargs=dict(s.model_kwargs), in_shape=s.in_shape)


@pytest.fixture(scope="module")
def np_state():
    return _np_state()


@pytest.mark.parametrize("causal,flash", [(False, False), (True, False),
                                          (True, True)])
def test_textcls_forward_matches_jax(np_state, causal, flash):
    """Task 2's logits from effective weights, causal and not; the port's
    flash path held to JAX's einsum attention."""
    x = _tokens(BATCH, 5)
    t2 = np_state.tasks[2]
    kw = dict(TXT, causal=causal)
    want, _ = jax.jit(functools.partial(
        j_fw.apply, j_textcls, train=False, num_classes=NC, **kw))(
        j_eff(np_state.shared, np_state.ownership, t2.piggymask, 2),
        t2.private, {}, jnp.asarray(x))
    st = state_from_numpy(np_state, "cpu")
    got, _ = t_fw.apply(t_textcls, t_eff(st.shared, st.ownership,
                                         st.tasks[2].piggymask, 2),
                        st.tasks[2].private, {}, torch.from_numpy(x),
                        train=False, flash_attention=flash, num_classes=NC,
                        **kw)
    assert got.shape == (BATCH, NC)
    _close(got.numpy(), want)


# ------------------------------------------------------- eval, train ----

KERNELS = dict(use_pallas=True, flash_attention=True)
STEP_KW = dict(num_classes=NC, mult=1.0, has_piggymask=True,
               model_kwargs=dict(TXT, causal=True))


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["default", "kernels"])
def test_eval_step_matches_jax(np_state, flags):
    """The port's eval step, default and with the dense route and flash
    attention, against JAX's default step (causal, no preprocess)."""
    x, y = _tokens(BATCH, 7), np.arange(BATCH) % NC
    jst = _to_jax(np_state)
    jstep = jax.jit(j_build_eval_step(
        j_textcls, cfg=JConfig(compute_dtype=jnp.float32), **STEP_KW))
    t2 = jst.tasks[2]
    want, jm = jstep(jst.shared, t2.piggymask, t2.private, {}, jst.ownership,
                     2, jnp.asarray(x), jnp.asarray(y))
    st = state_from_numpy(np_state, "cpu")
    tstep = t_step.make_eval_step(
        t_textcls, device="cpu",
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
    return [(rng.randint(0, TXT["vocab"], (BATCH, T)).astype(np.int32),
             rng.randint(0, NC, BATCH)) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_run(np_state):
    """Three task-2 steps of JAX's default step."""
    st = _to_jax(np_state)
    task = st.tasks[2]
    step, (opt_w, opt_pm) = j_build_train_step(
        j_textcls, augment_fn=_ident,
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


def _run_port(np_state, flags):
    st = state_from_numpy(np_state, "cpu")
    task = st.tasks[2]
    step, (opt_w, opt_pm) = t_step.build_train_step(
        t_textcls, augment_fn=_ident, device="cpu",
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
    return losses, shared, pm, priv


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["default", "kernels"])
def test_train_steps_match_jax(np_state, jax_run, flags):
    """Three causal task-2 steps of the port, default and with the dense
    route and flash attention, against JAX's default step, at
    tests/test_torch_port_vit.py's tolerances; the embedding table trains
    like any kernel (its task-1 rows bit-frozen, free entries zero)."""
    port = _run_port(np_state, flags)
    _assert_runs_match(jax_run, port)
    shared = port[1]
    for k, w0 in np_state.shared.items():
        own = np_state.ownership[k]
        w = shared[k].numpy()
        _eq(w[own == 1], w0[own == 1], k)
        assert not w[own == 0].any()
    emb = np_state.ownership["embed/kernel"] == 2
    assert (shared["embed/kernel"].numpy()[emb]
            != np_state.shared["embed/kernel"][emb]).any()


# ------------------------------------------------------------- growth ----

def test_grow_state_matches_jax_and_keeps_old_tasks(np_state):
    """grow_state 1.0 -> 1.5 in both packages from one state, the fresh
    values from the port's init at one seed (`init_fn` here, `port_init`
    in place of JAX's fw.init): every grown tree bit for bit (q/k/v gain a
    head's columns, proj its rows, the MLP its units; the table and the
    positions keep their shapes), and both tasks' logits bit-equal across
    the growth."""
    jst = _to_jax(state_to_numpy(state_from_numpy(np_state, "cpu")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fw, "init", port_init)
        j_seq.grow_state(jst, 1.5, jax.random.PRNGKey(7))
    st = state_from_numpy(np_state, "cpu")
    x = torch.from_numpy(_tokens(6, 11))
    before = {tid: predict(st, tid, x, device="cpu") for tid in (1, 2)}
    t_seq.grow_state(st, 1.5, torch.Generator().manual_seed(7),
                     device="cpu")
    assert st.shared["blocks/0/attn/q/kernel"].shape == (64, 96)
    assert st.shared["blocks/0/mlp/fc1/kernel"].shape == (64, 384)
    assert st.shared["embed/kernel"].shape == (64, 64)
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

@pytest.fixture(scope="module")
def servers(np_state):
    """f32 servers of both packages, and both packages' int8 servers
    calibrated on the same token batches."""
    jst, st = _to_jax(np_state), state_from_numpy(np_state, "cpu")
    calib = {1: _tokens(8, 2), 2: _tokens(8, 3)}
    j32 = JServer(jst, None, compute_dtype=jnp.float32, min_bucket=4)
    t32 = TaskServer(st, None, compute_dtype=torch.float32, min_bucket=4,
                     device="cpu")
    j8 = JServer(jst, None, quantize="int8", compute_dtype=jnp.float32,
                 min_bucket=4)
    t8 = TaskServer(st, None, quantize="int8", compute_dtype=torch.float32,
                    min_bucket=4, device="cpu")
    j8.calibrate(calib)
    t8.calibrate(calib)
    return j32, t32, j8, t8


def test_servers_match_jax(servers):
    """f32 servers against `cpg_tpu`'s, and `inference.predict`; int8
    within `cpg_tpu`'s bound |int8 - ref| <= 0.5 + 0.2 |ref| of the f32
    server, and against JAX's int8 within 2e-2 x max|ref| (one int8 step
    can flip where f32 summation order moves a value across a rounding
    boundary, tests/test_torch_port_int8.py)."""
    j32, t32, j8, t8 = servers
    x = _tokens(5, 6)
    for tid in (1, 2):
        ref = j32.predict(tid, x)
        _close(t32.predict(tid, x), ref, what=tid)
        got = t8.predict(tid, x)
        np.testing.assert_allclose(got, ref, rtol=0.2, atol=0.5)
        want = j8.predict(tid, x)
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    _close(predict(t32.state, 2, torch.from_numpy(x), device="cpu").numpy(),
           j32.predict(2, x), what="inference.predict")
    assert t32.in_shape == (T,)


def test_calibrated_int8_is_batching_invariant(servers):
    """A request's calibrated int8 logits are the same bits alone, in a
    mixed list and beside extreme-id rows in a larger bucket."""
    _, _, _, t8 = servers
    probe = _tokens(1, 9)
    alone = t8.predict(2, probe)
    co = t8.predict(2, np.concatenate([probe, np.full((9, T), 63, np.int32)]))
    _eq(co[:1], alone)
    mixed = t8.predict_mixed([(1, probe[0]), (2, probe[0]), (1, probe[0])])
    _eq(mixed[1], alone[0])


def test_artifacts_load_across_packages(servers, tmp_path):
    """f32 and int8 artifacts exported by either package load in the
    other: `in_shape` (T,) and each task's model_kwargs (vocab, causal)
    ride the meta; the loaded servers answer as the exporting ones (int8
    across the packages within 2e-2 x max|ref|, as
    test_servers_match_jax; the port's own artifact bit for bit)."""
    j32, t32, j8, t8 = servers
    x = _tokens(5, 8)
    for q, (jsrv, tsrv) in {"f32": (j32, t32), "int8": (j8, t8)}.items():
        jsrv.export(str(tmp_path / f"jax_{q}"))
        tsrv.export(str(tmp_path / f"port_{q}"))
        with open(tmp_path / f"port_{q}" / "serving_meta.json") as f:
            meta = json.load(f)
        assert meta["in_shape"] == [T]
        assert meta["tasks"]["2"]["model_kwargs"] == dict(TXT, causal=True)
        from_jax = TaskServer.load(str(tmp_path / f"jax_{q}"), None,
                                   device="cpu")
        from_port = JServer.load(str(tmp_path / f"port_{q}"), None)
        for tid in (1, 2):
            for got, want in ((from_jax.predict(tid, x), jsrv.predict(tid, x)),
                              (from_port.predict(tid, x),
                               tsrv.predict(tid, x))):
                if q == "f32":
                    _close(got, want, what=tid)
                else:  # across the packages, an int8 step may flip
                    assert np.abs(got - want).max() <= 2e-2 * np.abs(
                        want).max(), tid
        back = TaskServer.load(str(tmp_path / f"port_{q}"), None, device="cpu")
        _eq(back.predict(2, x), tsrv.predict(2, x), q)


def test_out_of_range_ids_raise(servers, np_state):
    """Ids outside [0, vocab) raise ValueError at the entry points
    (`cpg_tpu` clamps or fills them without an error: a known
    divergence): TaskServer.predict and predict_mixed, inference.predict,
    the Manager's data."""
    _, t32, _, _ = servers
    bad = _tokens(2, 1)
    bad[1, 3] = TXT["vocab"]
    neg = _tokens(2, 1)
    neg[0, 0] = -1
    for x in (bad, neg):
        with pytest.raises(ValueError, match="outside the embedding"):
            t32.predict(2, x)
        with pytest.raises(ValueError, match="outside the embedding"):
            t32.predict_mixed([(1, x[0]), (2, x[1])])
        with pytest.raises(ValueError, match="outside the embedding"):
            predict(t32.state, 1, torch.from_numpy(x), device="cpu")
    st = state_from_numpy(np_state, "cpu")
    data = {"train_x": bad, "train_y": np.zeros(2, np.int32),
            "test_x": _tokens(2, 2), "test_y": np.zeros(2, np.int32),
            "num_classes": NC}
    with pytest.raises(ValueError, match="outside the embedding"):
        Manager(st, t_textcls, 2, data, t_step.TrainConfig(), device="cpu")


def test_http_types_token_payloads_int32():
    """The HTTP front end keeps integer token payloads integral (int32)
    for a (T,) input shape, one example or a batch."""
    one = _as_batch(list(range(T)), (T,))
    assert one.dtype == np.int32 and one.shape == (1, T)
    many = _as_batch([[1] * T, [2] * T], (T,))
    assert many.dtype == np.int32 and many.shape == (2, T)


# --------------------------------------------------------------- data ----

@pytest.mark.parametrize("order_frac", [0.0, 0.25])
def test_synthetic_text_stream_bit_equal(order_frac):
    """`synthetic_text_task` and `text_task_splits`: the same arrays, bit
    for bit, with and without the ordered pairs."""
    kw = dict(vocab=64, seq_len=T, n_train=48, n_test=12,
              order_frac=order_frac)
    want = j_text.text_task_splits(n_tasks=2, seed=3, **kw)
    got = t_text.text_task_splits(n_tasks=2, seed=3, **kw)
    assert list(got) == list(want) == ["text01", "text02"]
    for name in want:
        for k in ("train_x", "train_y", "test_x", "test_y"):
            assert got[name][k].dtype == want[name][k].dtype
            _eq(got[name][k], want[name][k], (name, k))
        assert got[name]["num_classes"] == want[name]["num_classes"]


@pytest.mark.parametrize("tokenizer", ["byte", "hash"])
def test_textfolder_tokenizers_bit_equal(tmp_path, tokenizer):
    """Both tokenizers over a folder the test writes (UTF-8, a long file
    truncated, an empty one, mixed case for the hash), through
    `textfolder_task_splits` under CPG_DATA_DIR: the same tokens, labels,
    classes and vocab."""
    texts = {"neg": ["bad awful Terrible", "", "nö ünïcode 😀 " * 20],
             "pos": ["Good great good", "fine  and\twell"]}
    for task in ("alpha", "beta"):
        for split in ("train", "test"):
            for cname, docs in texts.items():
                d = tmp_path / "textcls" / task / split / cname
                d.mkdir(parents=True)
                for i, doc in enumerate(docs):
                    (d / f"{i}.txt").write_text(doc, encoding="utf-8")
                (d / "skip.md").write_text("not a document")
    kw = dict(data_dir=str(tmp_path), seq_len=12, tokenizer=tokenizer,
              vocab=32)
    want = j_textfolder.textfolder_task_splits(**kw)
    got = t_textfolder.textfolder_task_splits(**kw)
    assert list(got) == list(want) == ["alpha", "beta"]
    for name in want:
        for k in ("train_x", "train_y", "test_x", "test_y"):
            _eq(got[name][k], want[name][k], (name, k))
        assert got[name]["classes"] == ["neg", "pos"]
        assert got[name]["vocab"] == want[name]["vocab"]
    assert t_textfolder.textfolder_task_splits(
        data_dir=str(tmp_path / "none")) is None


# ---------------------------------------------------------------- cli ----

FLAGS = ["--num-tasks", "2", "--text-causal", "--text-seq-len", str(T),
         "--text-vocab", "64", "--finetune-epochs", "1", "--prune-epochs",
         "1", "--retrain-epochs", "1", "--prune-ratios", "0.5",
         "--batch-size", "128", "--dtype", "float32"]


def _quiet(main, argv):
    """(exit code, the last line of stdout as JSON) of a CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """`sequence --experiment textcls` through both CLIs from one seed
    (synthetic tasks, causal, 16 tokens, vocab 64; `cpg_tpu`'s fw.init
    replaced by `port_init`, as tests/test_torch_port_face_cli.py does);
    the port's run with its kernel flags and a checkpoint directory."""
    tmp = tmp_path_factory.mktemp("textcls")
    ck = str(tmp / "ck")
    argv = ["sequence", "--experiment", "textcls", *FLAGS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fw, "init", port_init)
        mp.delenv("CPG_DATA_DIR", raising=False)
        want = _quiet(j_cli.main, argv)
        got = _quiet(cli.main, [*argv, "--device", "cpu", "--use-pallas",
                                "--flash-attention", "--checkpoint-dir", ck])
    return tmp, ck, want, got


def test_textcls_sequence_matches_jax(cli_runs):
    """The two CLIs' JSON summaries are equal."""
    _, _, (rc_j, want), (rc_t, got) = cli_runs
    assert rc_j == rc_t == 0
    assert got == want
    assert [t["name"] for t in got["tasks"]] == ["text01", "text02"]


def test_textcls_checkpoint_tools(cli_runs):
    """The port's final checkpoint: sized by the task data (vocab 64, 16
    tokens), every task causal; `check` clean; `export` f32 and calibrated
    int8 (token batches), `serve`, and `inference` of both tasks (with the
    run's text flags: the port's inference takes them, `cpg_tpu`'s
    generates its default 64-token tasks)."""
    tmp, ck, _, _ = cli_runs
    final = os.path.join(ck, "task02_text02")
    state = load_state(final, device="cpu")
    assert check_state(state, strict=False) == []
    assert state.model_kwargs == {"vocab": 64} and state.in_shape == (T,)
    assert all(state.forward_kwargs(t) == {"vocab": 64, "causal": True}
               for t in (1, 2))
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["check", "--checkpoint", final, "--device",
                         "cpu"]) == 0
    x = _tokens(5, 12)
    req, cal = str(tmp / "req.npz"), str(tmp / "cal.npz")
    np.savez(req, x=x)
    np.savez(cal, x=x)
    for q, flags in (("f32", []), ("int8", ["--int8", "--calibrate", cal])):
        art = str(tmp / f"art_{q}")
        rc, rep = _quiet(cli.main, ["export", "--checkpoint", final, "--out",
                                    art, "--experiment", "textcls",
                                    "--device", "cpu", *flags])
        assert rc == 0 and rep["calibrated_tasks"] == (2 if flags else 0)
        rc, rep = _quiet(cli.main, ["serve", "--artifact", art, "--requests",
                                    req, "--task-id", "2", "--experiment",
                                    "textcls", "--device", "cpu"])
        assert rc == 0 and rep["n"] == 5
    for tid in (1, 2):
        rc, rep = _quiet(cli.main, ["inference", "--checkpoint", final,
                                    "--task-id", str(tid), "--experiment",
                                    "textcls", *FLAGS[:7], "--device",
                                    "cpu"])
        assert rc == 0 and rep["n"] == 128 and 0.0 <= rep["top1"] <= 1.0
