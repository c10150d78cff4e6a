"""The port's ViT path (layers, the dense masked route, flash attention, the
model, serving, the eval and train steps) against `cpg_tpu`, on the CPU.

Inputs are made from a numpy seed, weights go from one package to the other
with `state_from_numpy`, and both run in f32. On the JAX side the masked
matmul runs its Pallas kernels in interpret mode (custom VJP included), and
`flash_mha` runs the stock Pallas flash kernel under the TPU interpreter
inside one `jax.jit` (eager dispatch of the interpreted kernel deadlocks,
`cpg_tpu/ops/flash.py`); `tests/test_flash_attention.py` holds it against
the einsum attention. On the port's side the autograd Functions run their
plain forward and backward, which is what the CUDA kernels are held against
on the card.

The model is `vit_cifar` cut to depth 2, dim 64, 2 heads of 32, patch 8
(16 tokens, MLP 256), batch 4. Tolerances: layers and logits rtol 1e-4,
atol 1e-5; the masked matmul's gradients rtol 1e-4 / atol 1e-5 as
`tests/test_pallas.py`; flash rtol / atol 1e-4, tighter than the JAX
tests' 2e-3 / 5e-3; three train steps as `tests/test_torch_port_train.py`,
the departures stated in `_assert_runs_match`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cpg_tpu.core.state import CPGState as JState
from cpg_tpu.core.state import TaskEntry as JTask
from cpg_tpu.models import framework as j_fw
from cpg_tpu.models.vit import vit_cifar as j_vit_cifar
from cpg_tpu.ops.flash import flash_mha as j_flash_mha
from cpg_tpu.ops.pallas.masked_matmul import masked_matmul as j_masked_matmul
from cpg_tpu.serve import TaskServer as JServer
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu.train.step import build_eval_step as j_build_eval_step
from cpg_tpu.train.step import build_train_step as j_build_train_step
from cpg_tpu_torch import cli
from cpg_tpu_torch import inference as t_inference
from cpg_tpu_torch.core.state import CPGState, TaskEntry, state_from_numpy
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.models.vit import vit_cifar as t_vit_cifar
from cpg_tpu_torch.ops import flash as t_flash
from cpg_tpu_torch.ops import masked_matmul as t_mm
from cpg_tpu_torch.serve import TaskServer
from cpg_tpu_torch.train import step as t_step
from cpg_tpu_torch.train.sequence import init_state, start_task

torch.set_num_threads(1)
VIT = dict(depth=2, dim=64, heads=2, patch=8)
NC, BATCH, STEPS = 5, 4, 3


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _j_ctx(shared, private):
    return j_fw.Ctx(mode="apply", train=False, shared=shared, private=private,
                    compute_dtype=jnp.float32)


def _t_ctx(shared, private):
    return t_fw.Ctx(mode="apply", train=False, shared=shared, private=private)


# ------------------------------------------------------------ layers ----

def test_sdense_layernorm_gelu_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 24) * 2).astype(np.float32)
    p = {"d/kernel": rng.randn(24, 12).astype(np.float32) * 0.3,
         "d/bias": rng.randn(12).astype(np.float32),
         "ln/scale": rng.uniform(0.5, 1.5, 24).astype(np.float32),
         "ln/bias": rng.randn(24).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jshared = {"d/kernel": jp["d/kernel"]}
    tshared = {"d/kernel": tp["d/kernel"]}
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(t_fw.sdense(_t_ctx(tshared, tp), "d", tx, 12).numpy(),
           j_fw.sdense(_j_ctx(jshared, jp), "d", jx, 12), 1e-4, 1e-5, "sdense")
    _close(t_fw.layernorm(_t_ctx({}, tp), "ln", tx).numpy(),
           j_fw.layernorm(_j_ctx({}, jp), "ln", jx), 1e-4, 1e-5, "layernorm")
    _close(t_fw.gelu(tx).numpy(), j_fw.gelu(jx), 1e-4, 1e-5, "gelu")
    assert t_fw.gelu(torch.zeros(3)).eq(0).all()  # the growth law's gelu(0)
    bf = t_fw.layernorm(_t_ctx({}, tp), "ln", tx.to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16  # f32 moments, output in x's dtype


def test_patch_embedding_matches_jax_conv():
    """kernel == stride, VALID: space-to-depth + one product."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    w = rng.randn(8, 8, 3, 10).astype(np.float32) * 0.1
    want = j_fw.sconv(_j_ctx({"p/kernel": jnp.asarray(w)}, {}), "p",
                      jnp.asarray(x), 10, kernel=8, stride=8, padding="VALID")
    got = t_fw.sconv(_t_ctx({"p/kernel": torch.from_numpy(w)}, {}), "p",
                     torch.from_numpy(x), 10, kernel=8, stride=8,
                     padding="VALID")
    assert got.shape == (2, 2, 2, 10)
    _close(got.numpy(), want, 1e-4, 1e-5)


def test_vit_params_match_jax_keys_and_shapes():
    """Same shared/private keys and shapes as `cpg_tpu` (no BN state), for
    the model and for `init_state`/`start_task` at full width; xavier
    draws at the xavier scale."""
    shapes = jax.eval_shape(lambda: j_fw.init(
        jax.random.PRNGKey(0), j_vit_cifar, jnp.zeros((1, 32, 32, 3)),
        num_classes=NC))
    g = torch.Generator().manual_seed(0)
    state = init_state("vit_cifar", g, device="cpu")
    start_task(state, "t1", NC, g)
    start_task(state, "t2", NC, g)
    assert {k: tuple(v.shape) for k, v in state.shared.items()} == {
        k: v.shape for k, v in shapes[0].items()}
    for t in state.tasks.values():
        assert {k: tuple(v.shape) for k, v in t.private.items()} == {
            k: v.shape for k, v in shapes[1].items()}
        assert t.bn_state == {} and shapes[2] == {}
    assert sum(w.numel() for w in state.shared.values()) == 4_730_880
    w = state.shared["blocks/0/mlp/fc1/kernel"]
    assert abs(w.std().item() / np.sqrt(2.0 / (256 + 1024)) - 1) < 0.02
    assert set(state.tasks[2].piggymask) == set(state.shared)


# ------------------------------------------------------ masked matmul ----

@pytest.mark.parametrize("mode", ["binary", "ternary"])
def test_masked_matmul_and_grads_match_jax(mode):
    rng = np.random.RandomState(2)
    x = rng.randn(40, 24).astype(np.float32)
    w = (rng.randn(24, 36) * 0.3).astype(np.float32)
    own = rng.choice([0, 1, 2, 3], size=w.shape).astype(np.int8)
    pm = (rng.randn(*w.shape) * 0.01).astype(np.float32)
    gref = rng.randn(40, 36).astype(np.float32)

    def j_loss(x, w, pm):
        y = j_masked_matmul(x, w, jnp.asarray(own), pm, 2, 5e-3, mode)
        return jnp.sum(y * gref), y

    (_, want_y), want = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(pm))
    tx, tw, tpm = (torch.tensor(v, requires_grad=True) for v in (x, w, pm))
    y = t_mm.masked_matmul(tx, tw, torch.from_numpy(own), tpm, 2,
                           mask_mode=mode)
    assert type(y.grad_fn).__name__ == "_MaskedMatmulBackward"
    _close(y.detach().numpy(), want_y, 1e-4, 1e-5, "y")
    (y * torch.from_numpy(gref)).sum().backward()
    for got, wv, name in zip((tx.grad, tw.grad, tpm.grad), want, "x w pm".split()):
        _close(got.numpy(), wv, 1e-4, 1e-5, name)
    assert not tw.grad[torch.from_numpy(own) != 2].any()  # dw pre-gated


def test_sdense_dense_route_matches_jax():
    """sdense under Masking(pallas_dense) on (N, T, D): the leading dims
    flatten to (M, K) for the masked matmul, bias added after."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 7, 16).astype(np.float32)
    p = {"d/kernel": rng.randn(16, 8).astype(np.float32),
         "d/bias": rng.randn(8).astype(np.float32)}
    own = {"d/kernel": rng.choice([0, 1, 2], size=(16, 8)).astype(np.int8)}
    pm = {"d/kernel": (rng.randn(16, 8) * 0.01).astype(np.float32)}
    jmask = j_fw.Masking(ownership={k: jnp.asarray(v) for k, v in own.items()},
                         piggymask={k: jnp.asarray(v) for k, v in pm.items()},
                         task_id=2, pallas_dense=True)
    jctx = _j_ctx({"d/kernel": jnp.asarray(p["d/kernel"])},
                  {"d/bias": jnp.asarray(p["d/bias"])})
    jctx.masking = jmask
    want = j_fw.sdense(jctx, "d", jnp.asarray(x), 8)
    tmask = t_fw.Masking(
        ownership={k: torch.from_numpy(v) for k, v in own.items()},
        piggymask={k: torch.from_numpy(v) for k, v in pm.items()},
        task_id=2, pallas_dense=True)
    tctx = _t_ctx({"d/kernel": torch.from_numpy(p["d/kernel"])},
                  {"d/bias": torch.from_numpy(p["d/bias"])})
    tctx.masking = tmask
    before = t_mm.LAUNCHES
    got = t_fw.sdense(tctx, "d", torch.from_numpy(x), 8)
    assert got.shape == (2, 7, 8) and t_mm.LAUNCHES == before  # CPU: plain
    _close(got.numpy(), want, 1e-4, 1e-5)


# ---------------------------------------------------- flash attention ----

@pytest.mark.parametrize("causal", [False, True])
def test_flash_mha_and_grads_match_jax(causal):
    """T = 70: one full and one ragged 64-key tile in the port's kernels,
    the padded segment-id seam in the stock kernel."""
    rng = np.random.RandomState(4)
    q, k, v, g = (rng.randn(1, 70, 1, 64).astype(np.float32) for _ in range(4))

    def fwd_vjp(q, k, v):
        o, vjp = jax.vjp(functools.partial(j_flash_mha, causal=causal),
                         q, k, v)
        return o, vjp(jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        want_o, want = jax.jit(fwd_vjp)(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = t_flash.flash_mha(*ts, causal=causal)
    assert type(o.grad_fn).__name__ == "_FlashMHABackward"
    _close(o.detach().numpy(), want_o, 1e-4, 1e-4, "o")
    (o * torch.from_numpy(g)).sum().backward()
    for t, wv, name in zip(ts, want, "qkv"):
        _close(t.grad.numpy(), wv, 1e-4, 1e-4, f"d{name}")


# ------------------------------------------------------- model, state ----

def _piggymask(rng, shape):
    """Values at least 2e-3 from the 5e-3 threshold, 70% above it (three
    Adam steps at lr_mask 1e-4 flip no binarized bit)."""
    above = rng.uniform(0.007, 0.03, shape)
    below = rng.uniform(-0.02, 0.003, shape)
    return np.where(rng.uniform(size=shape) < 0.7, above, below).astype(
        np.float32)


def _np_state(seed=0) -> CPGState:
    """A two-task cut-down vit_cifar state of numpy arrays: random
    ownership over tasks 1-2 with some entries free, task 2's piggymask
    around the threshold, LayerNorm affines and positions away from their
    init."""
    rng = np.random.RandomState(seed)
    shared, private, _ = t_fw.init(torch.Generator().manual_seed(0),
                                   t_vit_cifar, torch.zeros((1, 32, 32, 3)),
                                   num_classes=NC, **VIT)
    sh = {k: w.numpy() for k, w in shared.items()}
    own = {k: rng.choice([0, 1, 2], p=[0.1, 0.45, 0.45], size=w.shape)
           .astype(np.int8) for k, w in sh.items()}

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
                          task_private(), {})}
    return CPGState("vit_cifar", 1.0, sh, own, tasks, model_kwargs=dict(VIT))


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


def _images(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("flash", [False, True])
def test_vit_forward_matches_jax(np_state, flash):
    """Task 2's logits from effective weights; the port's flash path is
    held to JAX's einsum attention."""
    from cpg_tpu.ops.masked import effective_params as j_eff
    from cpg_tpu_torch.ops.masked import effective_params as t_eff

    x = _images(BATCH, 5).astype(np.float32) / 255.0
    t2 = np_state.tasks[2]
    want, _ = jax.jit(functools.partial(
        j_fw.apply, j_vit_cifar, train=False, num_classes=NC, **VIT))(
        j_eff(np_state.shared, np_state.ownership, t2.piggymask, 2),
        t2.private, {}, jnp.asarray(x))
    st = state_from_numpy(np_state, "cpu")
    got, _ = t_fw.apply(t_vit_cifar, t_eff(st.shared, st.ownership,
                                           st.tasks[2].piggymask, 2),
                        st.tasks[2].private, {}, torch.from_numpy(x),
                        train=False, flash_attention=flash, num_classes=NC,
                        **VIT)
    assert got.shape == (BATCH, NC)
    _close(got.numpy(), want, 1e-4, 1e-5)


def test_serving_matches_jax_through_export_and_load(np_state, tmp_path):
    """f32 TaskServers of both packages on the same state; the port loads
    the JAX artifact and the JAX server loads the port's."""
    from cpg_tpu.data.augment import cifar_eval_preprocess as j_prep
    from cpg_tpu_torch.data.augment import cifar_eval_preprocess as t_prep

    x = _images(5, 6)
    jsrv = JServer(_to_jax(np_state), j_prep, compute_dtype=jnp.float32)
    tsrv = TaskServer(state_from_numpy(np_state, "cpu"), t_prep,
                      compute_dtype=torch.float32, device="cpu")
    for tid in (1, 2):
        _close(tsrv.predict(tid, x), jsrv.predict(tid, x), 1e-4, 1e-5, tid)
    _close(t_inference.predict(tsrv.state, 2, t_prep(torch.from_numpy(x)),
                               device="cpu").numpy(),
           jsrv.predict(2, x), 1e-4, 1e-5, "inference.predict")
    tsrv.export(str(tmp_path / "port"))
    jsrv.export(str(tmp_path / "jax"))
    loaded = TaskServer.load(str(tmp_path / "jax"), t_prep, device="cpu")
    assert loaded.state.tasks[2].bn_state == {}
    _close(loaded.predict(2, x), jsrv.predict(2, x), 1e-4, 1e-5, "jax art")
    back = JServer.load(str(tmp_path / "port"), j_prep)
    _close(back.predict(2, x), tsrv.predict(2, x), 1e-4, 1e-5, "port art")
    req, out = str(tmp_path / "req.npz"), str(tmp_path / "out.npz")
    np.savez(req, x=x)
    assert cli.main(["serve", "--artifact", str(tmp_path / "jax"),
                     "--requests", req, "--task-id", "2", "--out", out,
                     "--device", "cpu"]) == 0
    _close(np.load(out)["logits"], jsrv.predict(2, x), 1e-4, 1e-5, "cli")


# ------------------------------------------------------- eval, train ----

KERNELS = dict(use_pallas=True, flash_attention=True)


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["default", "kernels"])
def test_eval_step_matches_jax(np_state, flags):
    """The port's eval step, default and with the dense route and flash,
    against JAX's default step (whose kernel paths JAX's own tests hold to
    it)."""
    from cpg_tpu.data.augment import cifar_eval_preprocess as j_prep
    from cpg_tpu_torch.data.augment import cifar_eval_preprocess as t_prep

    x, y = _images(BATCH, 7), np.arange(BATCH) % NC
    kw = dict(num_classes=NC, mult=1.0, has_piggymask=True, model_kwargs=VIT)
    jst = _to_jax(np_state)
    jstep = jax.jit(j_build_eval_step(j_vit_cifar, preprocess_fn=j_prep,
                                      cfg=JConfig(compute_dtype=jnp.float32),
                                      **kw))
    t2 = jst.tasks[2]
    want, jm = jstep(jst.shared, t2.piggymask, t2.private, {}, jst.ownership,
                     2, jnp.asarray(x), jnp.asarray(y))
    st = state_from_numpy(np_state, "cpu")
    tstep = t_step.make_eval_step(
        t_vit_cifar, preprocess_fn=t_prep, device="cpu",
        cfg=t_step.TrainConfig(compute_dtype=torch.float32, **flags), **kw)
    s2 = st.tasks[2]
    got, tm = tstep(st.shared, s2.piggymask, s2.private, {}, st.ownership, 2,
                    x, y)
    _close(got.numpy(), want, 1e-4, 1e-5)
    assert int(tm["acc_sum"]) == int(jm["acc_sum"])


BASE = dict(lr=2e-3, lr_mask=1e-4, label_smoothing=0.1)


def _batches():
    rng = np.random.RandomState(9)
    return [(rng.randint(0, 256, (BATCH, 32, 32, 3)).astype(np.uint8),
             rng.randint(0, NC, BATCH), jax.random.PRNGKey(20 + i))
            for i in range(STEPS)]


def _jax_draws(key, n, pad=4):
    """The crop offsets and flip bits `cpg_tpu.data.augment` draws."""
    kc, kf = jax.random.split(key)
    offs = jax.random.randint(kc, (n, 2), 0, 2 * pad + 1)
    flip = jax.random.bernoulli(kf, 0.5, (n, 1, 1, 1))
    return np.array(offs), np.array(flip).reshape(n)


@pytest.fixture(scope="module")
def jax_run(np_state):
    """Three task-2 steps of JAX's default step."""
    from cpg_tpu.data.augment import cifar_train_augment as j_aug

    st = _to_jax(np_state)
    task = st.tasks[2]
    step, (opt_w, opt_pm) = j_build_train_step(
        j_vit_cifar, num_classes=NC, mult=1.0, has_piggymask=True,
        augment_fn=j_aug, model_kwargs=VIT,
        cfg=JConfig(compute_dtype=jnp.float32, **BASE))
    shared, pm, priv = st.shared, task.piggymask, task.private
    ows = opt_w.init({"shared": shared, "private": priv})
    opms = opt_pm.init(pm)
    jstep = jax.jit(step)
    losses = []
    for i, (x, y, key) in enumerate(_batches()):
        shared, pm, priv, _, ows, opms, m = jstep(
            shared, pm, priv, {}, ows, opms, st.ownership, 2,
            jnp.asarray(x), jnp.asarray(y), key, i)
        losses.append(float(m["loss"]))
    return losses, shared, pm, priv


def _run_port(np_state, flags, tid):
    from cpg_tpu_torch.data.augment import cifar_train_augment as t_aug

    st = state_from_numpy(np_state, "cpu")
    task = st.tasks[tid]
    has_pm = task.piggymask is not None
    step, (opt_w, opt_pm) = t_step.build_train_step(
        t_vit_cifar, num_classes=NC, mult=1.0, has_piggymask=has_pm,
        augment_fn=t_aug, model_kwargs=VIT, device="cpu",
        cfg=t_step.TrainConfig(compute_dtype=torch.float32, **BASE, **flags))
    shared, pm, priv = st.shared, task.piggymask, task.private
    ows = opt_w.init({"shared": shared, "private": priv})
    opms = opt_pm.init(pm) if has_pm else None
    losses = []
    for i, (x, y, key) in enumerate(_batches()):
        shared, pm, priv, _, ows, opms, m = step(
            shared, pm, priv, {}, ows, opms, st.ownership, tid, x, y,
            _jax_draws(key, BATCH), i)
        losses.append(float(m["loss"]))
    return losses, shared, pm, priv


def _assert_runs_match(jax_run, port_run):
    """Three steps of both packages agree: losses rtol 1e-4, weights and
    private params rtol 1e-4 with atol 5e-6 (the f32 products sum in
    different orders in the two packages; one step moves a weight by
    lr * g, about 1e-5 to 1e-3); piggymasks as in
    `tests/test_torch_port_train.py`: Adam divides each gradient by its own
    magnitude, so an entry whose gradient is near 1e-8 turns summation-order
    noise into an update difference of up to ~lr_mask; at most 0.05% of the
    entries may differ, by at most 3 * lr_mask, the rest hold rtol 1e-4,
    atol 1e-7."""
    jl, jsh, jpm, jpr = jax_run
    tl, tsh, tpm, tpr = port_run
    _close(tl, jl, 1e-4, 1e-6, "losses")
    for k in jsh:
        _close(tsh[k].numpy(), jsh[k], 1e-4, 5e-6, k)
    bad = total = 0
    for k in (jpm or {}):
        got, want = tpm[k].numpy(), np.asarray(jpm[k])
        off = ~np.isclose(got, want, rtol=1e-4, atol=1e-7)
        bad, total = bad + int(off.sum()), total + off.size
        assert np.abs(got - want).max() <= 3 * BASE["lr_mask"], k
    assert bad <= 5e-4 * total, (bad, total)
    for k in jpr:
        _close(tpr[k].numpy(), jpr[k], 1e-4, 5e-6, k)


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["default", "kernels"])
def test_train_steps_match_jax(np_state, jax_run, flags):
    """Three task-2 steps of the port, default and with the dense route and
    flash attention, against JAX's default step. JAX's own tests hold its
    Pallas masked-matmul step (`tests/test_pallas_step.py`) and its flash
    attention (`tests/test_flash_attention.py`) to that step; running them
    here in interpret mode would cost this file 40 s of CPU time."""
    port = _run_port(np_state, flags, 2)
    _assert_runs_match(jax_run, port)
    _, shared, pm, _ = port
    moved = 0
    for k, w0 in np_state.shared.items():
        own = np_state.ownership[k]
        w = shared[k].numpy()
        np.testing.assert_array_equal(w[own == 1], w0[own == 1])  # bit-frozen
        assert not w[own == 0].any()  # free entries exactly zero
        moved += int((w[own == 2] != w0[own == 2]).sum())
        pm0 = np_state.tasks[2].piggymask[k]
        np.testing.assert_array_equal(pm[k].numpy()[own != 1], pm0[own != 1])
    assert moved > 0


def test_vit_entry_points_default_to_the_card(np_state, monkeypatch):
    """The ViT entry points, kernel flags included, raise without a usable
    card unless the caller passes device='cpu'."""
    st = state_from_numpy(np_state, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(num_classes=NC, mult=1.0, has_piggymask=True, model_kwargs=VIT,
              cfg=t_step.TrainConfig(**KERNELS))
    calls = [lambda: TaskServer(st),
             lambda: t_step.make_eval_step(t_vit_cifar, **kw),
             lambda: t_step.make_train_step(t_vit_cifar, **kw),
             lambda: init_state("vit_cifar", torch.Generator())]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------- qkv_fused ----

def _fused_forward(np_state):
    """Task 2's logits and the gradients of their sum with respect to the
    effective shared kernels and the private params, through `cpg_tpu`'s
    fused path and the port's fused and unfused paths."""
    from cpg_tpu.ops.masked import effective_params as j_eff
    from cpg_tpu_torch.ops.masked import effective_params as t_eff

    x = _images(BATCH, 11).astype(np.float32) / 255.0
    t2 = np_state.tasks[2]

    def j_loss(shared, private):
        out, _ = j_fw.apply(j_vit_cifar, shared, private, {}, jnp.asarray(x),
                            train=False, qkv_fused=True, num_classes=NC,
                            **VIT)
        return out.sum(), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(
        j_eff(np_state.shared, np_state.ownership, t2.piggymask, 2),
        t2.private)
    st = state_from_numpy(np_state, "cpu")
    runs = {}
    for fused in (True, None):
        eff = {k: v.detach().requires_grad_(True) for k, v in t_eff(
            st.shared, st.ownership, st.tasks[2].piggymask, 2).items()}
        priv = {k: v.detach().clone().requires_grad_(True)
                for k, v in st.tasks[2].private.items()}
        out, _ = t_fw.apply(t_vit_cifar, eff, priv, {}, torch.from_numpy(x),
                            train=False, qkv_fused=fused, num_classes=NC,
                            **VIT)
        out.sum().backward()
        runs[fused] = (out.detach(), {k: v.grad for k, v in eff.items()},
                       {k: v.grad for k, v in priv.items()})
    return want, jgrads, runs


def test_qkv_fused_forward_and_grads_match_jax(np_state):
    """`qkv_fused=True` on the effective-params path: logits rtol 1e-4,
    atol 1e-5 and gradients rtol 1e-4, atol 1e-6 against `cpg_tpu`'s fused
    path (f32 products summed in different orders); against the port's
    three products rtol 1e-5, atol 1e-6 (one product of the concatenated
    kernels: each column's sum is the same as in its own product); every
    q/k/v kernel and bias receives its own gradient."""
    want, (jg_shared, jg_priv), runs = _fused_forward(np_state)
    got, g_shared, g_priv = runs[True]
    _close(got.numpy(), want, 1e-4, 1e-5, "fused logits")
    for k in jg_shared:
        _close(g_shared[k].numpy(), jg_shared[k], 1e-4, 1e-6, k)
    for k in jg_priv:
        _close(g_priv[k].numpy(), jg_priv[k], 1e-4, 1e-6, k)
    ref, r_shared, r_priv = runs[None]
    _close(got.numpy(), ref.numpy(), 1e-5, 1e-6, "fused vs unfused")
    for k in r_shared:
        _close(g_shared[k].numpy(), r_shared[k].numpy(), 1e-5, 1e-6, k)
    for k in r_priv:
        _close(g_priv[k].numpy(), r_priv[k].numpy(), 1e-5, 1e-6, k)
    for p in "qkv":
        assert g_shared[f"blocks/0/attn/{p}/kernel"].abs().max() > 0
        assert g_priv[f"blocks/1/attn/{p}/bias"].abs().max() > 0


@pytest.fixture(scope="module")
def jax_fused_run(np_state):
    """Three task-2 steps of JAX's default step with `qkv_fused=True`."""
    from cpg_tpu.data.augment import cifar_train_augment as j_aug

    st = _to_jax(np_state)
    task = st.tasks[2]
    step, (opt_w, opt_pm) = j_build_train_step(
        j_vit_cifar, num_classes=NC, mult=1.0, has_piggymask=True,
        augment_fn=j_aug, model_kwargs=VIT,
        cfg=JConfig(compute_dtype=jnp.float32, qkv_fused=True, **BASE))
    shared, pm, priv = st.shared, task.piggymask, task.private
    ows = opt_w.init({"shared": shared, "private": priv})
    opms = opt_pm.init(pm)
    jstep = jax.jit(step)
    losses = []
    for i, (x, y, key) in enumerate(_batches()):
        shared, pm, priv, _, ows, opms, m = jstep(
            shared, pm, priv, {}, ows, opms, st.ownership, 2,
            jnp.asarray(x), jnp.asarray(y), key, i)
        losses.append(float(m["loss"]))
    return losses, shared, pm, priv


def test_qkv_fused_train_steps_match_jax(np_state, jax_fused_run):
    """Three default task-2 steps with `qkv_fused=True`: against
    `cpg_tpu`'s fused steps at `_assert_runs_match`'s tolerances, and
    against the port's unfused steps at the same tolerances."""
    fused = _run_port(np_state, {"qkv_fused": True}, 2)
    _assert_runs_match(jax_fused_run, fused)
    _assert_runs_match(_run_port(np_state, {}, 2), fused)


@pytest.mark.parametrize("case", ["init", "masking", "int8", "none", "false",
                                  "fused"])
def test_qkv_fused_only_on_the_effective_params_path(case):
    """The fused product runs only outside init, without a Masking and
    without int8 scales, with `qkv_fused=True`; everywhere else q, k and v
    are three `sdense` products, as in `cpg_tpu`."""
    from cpg_tpu_torch.models import vit as t_vit

    d, heads, hd, n, t = 16, 2, 8, 2, 5
    g = torch.Generator().manual_seed(0)
    ctx = t_fw.Ctx(mode="init", train=False, generator=g)
    x = torch.randn(n, t, d, generator=g)
    t_vit.attention(ctx, "a", x, heads, hd)
    kw = {"init": dict(mode="init", generator=g, qkv_fused=True),
          "masking": dict(masking=object(), qkv_fused=True),
          "int8": dict(quant_scales={}, qkv_fused=True),
          "none": dict(qkv_fused=None), "false": dict(qkv_fused=False),
          "fused": dict(qkv_fused=True)}[case]
    kw = {"mode": "apply", **kw}
    if kw["mode"] == "apply":
        kw.update(shared=ctx.shared, private=ctx.private)
    names = []

    def spy(c, name, inp, features, **k):
        names.append(name)
        return torch.zeros((*inp.shape[:-1], features))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_vit, "sdense", spy)
        t_vit.attention(t_fw.Ctx(train=False, **kw), "a", x, heads, hd)
    qkv = [s for s in names if s.split("/")[-1] in "qkv"]
    assert qkv == ([] if case == "fused" else ["a/q", "a/k", "a/v"])
    assert names[-1] == "a/proj"
