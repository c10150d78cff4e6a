"""The port's SphereNet-20 against `cpg_tpu`'s, on the CPU: PReLU, the
A-Softmax head and loss, the model with all three heads, the masked
kernels at SphereNet's geometries, serving, the eval step and the train
steps of both face tasks.

One two-task numpy state (width 0.125: channels 8/16/32/64, fc5 2688 -> 64;
112x96 input, which the (7, 6) flatten needs) goes into both packages:
task 1 the CASIA task with the AngleLinear head, task 2 an expression
task with a linear head, ownership random over tasks 1-2 with some entries
free, task 2's piggymask around the threshold. On the JAX side the masked
conv and masked matmul Pallas kernels run in interpret mode where an op is
compared; whole models, servers and steps run on `cpg_tpu`'s default path
(its kernels are the same functions within the op tests' tolerances). The
port runs its kernel flags (the plain versions on the CPU) and its default
path against it.

Tolerances: f32 logits rtol 1e-4, atol 1e-5; the ops' gradients as in
`tests/test_torch_port_train.py`; the train steps at that file's
tolerances (`_assert_runs_match`); int8 servers within 2e-2 x max|ref|
with equal argmax.
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
from cpg_tpu.ops.masked import effective_params as j_eff
from cpg_tpu.ops.pallas.masked_conv import masked_conv2d as j_masked_conv2d
from cpg_tpu.ops.pallas.masked_matmul import masked_matmul as j_masked_matmul
from cpg_tpu.serve import TaskServer as JServer
from cpg_tpu.train.losses import make_angle_loss as j_make_angle_loss
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu.train.step import build_train_step as j_build_train_step
from cpg_tpu_torch.core.state import CPGState, TaskEntry, state_from_numpy
from cpg_tpu_torch.data import augment as t_aug
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.models import get_model as t_get_model
from cpg_tpu_torch.models.spherenet import angle_linear as t_angle_linear
from cpg_tpu_torch.ops import masked_conv as t_mc
from cpg_tpu_torch.ops import masked_matmul as t_mm
from cpg_tpu_torch.serve import TaskServer
from cpg_tpu_torch.train import step as t_step
from cpg_tpu_torch.train.losses import make_angle_loss

from .test_torch_port_train import _assert_runs_match, _piggymask

torch.set_num_threads(1)
ARCH, MULT, HW = "spherenet20", 0.125, (112, 96)
NC = {1: 6, 2: 7}
HEADS = {1: "angle", 2: "linear"}
BATCH, STEPS = 4, 3
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


def _images(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, *HW, 3)).astype(
        np.uint8)


def _np_state(seed=0, mult=MULT, heads=None) -> CPGState:
    """Two tasks of numpy arrays: the stride-2 downs and fc5 He-scaled, the
    unit convs at half that (a residual unit then adds a fraction of its
    input), ownership 10% free and 45% each task, PReLU slopes U(0.1, 0.4),
    fc5's bias and the heads N(0, 0.1^2), task 2's piggymask around the
    threshold. `heads` overrides the tasks' head types."""
    heads = heads or HEADS
    rng = np.random.RandomState(seed)
    model_fn, _ = t_get_model(ARCH)
    shared, _, _ = t_fw.init(torch.Generator().manual_seed(0), model_fn,
                             torch.zeros((1, *HW, 3)), num_classes=2,
                             mult=mult)
    sh = {}
    for k, w in shared.items():
        fan_in = int(np.prod(w.shape[:-1]))
        gain = 0.5 if "/unit" in k else 1.0
        sh[k] = (rng.randn(*w.shape) * gain * np.sqrt(2.0 / fan_in)).astype(
            np.float32)
    own = {k: rng.choice([0, 1, 2], p=[0.1, 0.45, 0.45], size=w.shape)
           .astype(np.int8) for k, w in sh.items()}

    def task_private(tid):
        _, private, _ = t_fw.init(torch.Generator().manual_seed(tid),
                                  model_fn, torch.zeros((1, *HW, 3)),
                                  num_classes=NC[tid], mult=mult,
                                  head_type=heads[tid])
        return {k: (rng.uniform(0.1, 0.4, v.shape) if k.endswith("/slope")
                    else rng.randn(*v.shape) * 0.1).astype(np.float32)
                for k, v in private.items()}

    tasks = {tid: TaskEntry(
        f"t{tid}", NC[tid],
        None if tid == 1 else {k: _piggymask(rng, w.shape)
                               for k, w in sh.items()},
        task_private(tid), {}, {"model_kwargs": {"head_type": heads[tid]}})
        for tid in (1, 2)}
    return CPGState(ARCH, mult, sh, own, tasks)


def _to_jax(s) -> JState:
    return JState(arch=s.arch, width_mult=s.width_mult, shared=s.shared,
                  ownership=s.ownership,
                  tasks={tid: JTask(**dataclasses.asdict(t))
                         for tid, t in s.tasks.items()},
                  threshold=s.threshold, mask_mode=s.mask_mode,
                  in_shape=s.in_shape)


@pytest.fixture(scope="module")
def np_state():
    return _np_state()


@pytest.fixture(scope="module")
def jax_forward():
    """`cpg_tpu`'s eval-mode forward of effective params, jitted once per
    head type."""
    model_fn = j_get_model(ARCH)[0]
    fns = {}

    def run(eff, private, x, nc, head_type):
        key = (nc, head_type)
        if key not in fns:
            fns[key] = jax.jit(lambda e, p, xx: j_fw.apply(
                model_fn, e, p, {}, xx, train=False, num_classes=nc,
                mult=MULT, head_type=head_type)[0])
        return fns[key](eff, private, jnp.asarray(x))

    return run


@pytest.fixture(scope="module")
def jax_logits(np_state, jax_forward):
    """`cpg_tpu`'s eval-mode outputs of both tasks on one batch (task 1:
    the AngleLinear pair)."""
    x = j_aug.face_eval_preprocess(jnp.asarray(_images(6, 1)))
    out = {}
    for tid, t in np_state.tasks.items():
        eff = j_eff(np_state.shared, np_state.ownership, t.piggymask, tid)
        out[tid] = jax.tree_util.tree_map(
            np.asarray, jax_forward(eff, t.private, x, NC[tid], HEADS[tid]))
    return out


# ------------------------------------------------------------- layers ----

def test_prelu_matches_jax():
    """PReLU's output (f32 from a bf16 input too) and its gradients,
    including x == 0 exactly, against `cpg_tpu`'s."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 4, 6).astype(np.float32)
    x[0, 0, 0] = 0.0
    a = rng.uniform(0.1, 0.4, 6).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)

    def j_apply(x, a):
        ctx = j_fw.Ctx(mode="apply", train=False, private={"p/slope": a})
        return j_fw.prelu(ctx, "p", x)

    want = j_apply(jnp.asarray(x), jnp.asarray(a))
    jdx, jda = jax.grad(lambda x, a: jnp.sum(j_apply(x, a) * g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(a))
    tx, ta = (torch.tensor(v, requires_grad=True) for v in (x, a))
    ctx = t_fw.Ctx(mode="apply", train=False, private={"p/slope": ta})
    y = t_fw.prelu(ctx, "p", tx)
    _eq(y.detach(), want)
    (y * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, jdx, what="dx")
    _close(ta.grad, jda, what="da")
    xb = torch.from_numpy(x).bfloat16()
    yb = t_fw.prelu(ctx, "p", xb)
    assert yb.dtype == torch.float32
    _eq(yb.detach(), j_apply(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a)))


def _angle_inputs(case):
    """(x, w) of an AngleLinear head: random, or an embedding exactly
    parallel (and antiparallel) to a head column, so cos is exactly +-1."""
    rng = np.random.RandomState(2)
    x = rng.randn(5, 8).astype(np.float32)
    w = rng.randn(8, 4).astype(np.float32)
    if case == "parallel":
        x[0], x[1] = 0.0, 0.0
        x[0, 2], x[1, 2] = 3.0, -2.0
        w[:, 1] = 0.0
        w[2, 1] = 0.5
    return x, w


@pytest.mark.parametrize("case", ["random", "parallel"])
def test_angle_linear_matches_jax(case):
    """(cos * |x|, phi * |x|) and the gradients of a weighted sum of both
    against x and the head weight. With an embedding parallel to a column
    (cos exactly 1, and -1 for an antiparallel one) the gradient is finite
    and equals `cpg_tpu`'s: theta and k take no gradient, and the clip
    passes half at the boundary, as jnp.clip's."""
    from cpg_tpu.models.spherenet import angle_linear as j_angle_linear

    x, w = _angle_inputs(case)
    rng = np.random.RandomState(3)
    gc, gp = (rng.randn(5, 4).astype(np.float32) for _ in range(2))

    def j_apply(x, w):
        ctx = j_fw.Ctx(mode="apply", train=False,
                       private={"h/kernel": w})
        return j_angle_linear(ctx, "h", x, 4)

    jc, jp = j_apply(jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = jax.grad(
        lambda x, w: sum(jnp.sum(o * g) for o, g in zip(j_apply(x, w),
                                                         (gc, gp))),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.tensor(v, requires_grad=True) for v in (x, w))
    ctx = t_fw.Ctx(mode="apply", train=False, private={"h/kernel": tw})
    tc, tp = t_angle_linear(ctx, "h", tx, 4)
    if case == "parallel":
        assert tc[0, 1].item() == 3.0 and tc[1, 1].item() == -2.0
    _close(tc, jc, what="cos")
    _close(tp, jp, what="phi")
    ((tc * torch.from_numpy(gc)).sum()
     + (tp * torch.from_numpy(gp)).sum()).backward()
    assert torch.isfinite(tx.grad).all() and torch.isfinite(tw.grad).all()
    _close(tx.grad, jdx, what="dx")
    _close(tw.grad, jdw, what="dw")


@pytest.mark.parametrize("it", [0, 7, 1000, 10**6])
def test_angle_loss_matches_jax(it):
    """The annealed A-Softmax loss and its gradients at several global
    steps (lambda from 1500 down to its floor of 5)."""
    rng = np.random.RandomState(4)
    cos = (rng.randn(6, 5) * 2).astype(np.float32)
    phi = (rng.randn(6, 5) * 2).astype(np.float32)
    y = rng.randint(0, 5, 6)
    jl = j_make_angle_loss()
    want = jl((jnp.asarray(cos), jnp.asarray(phi)), jnp.asarray(y), it)
    jg = jax.grad(lambda c, p: jl((c, p), jnp.asarray(y), it),
                  argnums=(0, 1))(jnp.asarray(cos), jnp.asarray(phi))
    loss = make_angle_loss()
    assert loss.wants_step
    tc, tp = (torch.tensor(v, requires_grad=True) for v in (cos, phi))
    got = loss((tc, tp), torch.from_numpy(y), it)
    _close(got, want, 1e-6, 1e-6, "loss")
    got.backward()
    _close(tc.grad, jg[0], 1e-5, 1e-7, "dcos")
    _close(tp.grad, jg[1], 1e-5, 1e-7, "dphi")


# -------------------------------------------------------------- model ----

@pytest.mark.parametrize("head_type", ["angle", "linear", "none"])
def test_params_keys_shapes_and_order_match_jax(head_type):
    """The same 21 sharable kernels (20 convs and fc5), private keys (22
    PReLU slopes, fc5's bias, the head), shapes and registration order."""
    kw = dict(num_classes=5, mult=MULT, head_type=head_type)
    tsh, tpr, tbn = t_fw.init(torch.Generator().manual_seed(0),
                              t_get_model(ARCH)[0], torch.zeros((1, *HW, 3)),
                              **kw)
    trees = []

    def j_init(key):  # `cpg_tpu`'s fw.init, its dicts kept in order
        ctx = j_fw.Ctx(mode="init", train=False, rng=key)
        j_get_model(ARCH)[0](ctx, jnp.zeros((1, *HW, 3)), **kw)
        trees.extend((ctx.shared, ctx.private, ctx.bn_state))

    jax.eval_shape(j_init, jax.random.PRNGKey(0))  # traced, not computed
    jsh, jpr, jbn = trees
    assert list(tsh) == list(jsh) and len(tsh) == 21
    assert list(tpr) == list(jpr) and not tbn and not jbn
    assert tsh["fc5/kernel"].shape == (2688, 64)
    for tree_t, tree_j in ((tsh, jsh), (tpr, jpr)):
        for k in tree_j:
            assert tuple(tree_t[k].shape) == tuple(tree_j[k].shape), k
    assert (tpr["stage1/down_prelu/slope"] == 0.25).all()


@pytest.mark.parametrize("tid", [1, 2], ids=["angle", "linear"])
def test_forward_matches_jax(np_state, jax_logits, tid):
    """Eval-mode outputs of each task's view (task 1 both AngleLinear
    outputs, task 2 the linear head's logits) and task 1's embedding."""
    t = np_state.tasks[tid]
    st = state_from_numpy(np_state, "cpu")
    eff = {k: v for k, v in j_eff(np_state.shared, np_state.ownership,
                                  t.piggymask, tid).items()}
    teff = {k: torch.from_numpy(np.array(v)) for k, v in eff.items()}
    x = t_aug.face_eval_preprocess(torch.from_numpy(_images(6, 1)))
    out, _ = t_fw.apply(t_get_model(ARCH)[0], teff, st.tasks[tid].private,
                        {}, x, train=False, num_classes=NC[tid], mult=MULT,
                        head_type=HEADS[tid])
    want = jax_logits[tid]
    if tid == 1:
        assert isinstance(out, tuple) and len(out) == 2
        for o, w in zip(out, want):
            _close(o, w)
    else:
        _close(out, want)


# ------------------------------------------------------------ kernels ----

# SphereNet's masked-conv geometries at a small size: (input NHWC,
# Cout, stride, padding)
CONV_GEOMETRIES = {
    "stem_3x3_s2_pad1": ((2, 14, 12, 3), 8, 2, 1),
    "down_3x3_s2_pad1": ((2, 14, 12, 8), 16, 2, 1),
    "unit_3x3": ((2, 7, 6, 16), 16, 1, "SAME"),
}


@pytest.mark.parametrize("geo", list(CONV_GEOMETRIES))
def test_masked_conv_sphere_geometries_match_jax(geo):
    """y, dx, dw and dpm of the masked conv at SphereNet's geometries
    (stride-2 downs with explicit padding 1 on a non-square grid, the
    stride-1 units) against `cpg_tpu`'s Pallas kernel and its VJP
    (interpret mode)."""
    shape, cout, stride, pad = CONV_GEOMETRIES[geo]
    jpad = [(pad, pad), (pad, pad)] if isinstance(pad, int) else pad
    rng = np.random.RandomState(len(geo))
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, shape[-1], cout) * 0.3).astype(np.float32)
    own = rng.choice([0, 1, 2, 3], size=w.shape).astype(np.int8)
    pm = (rng.randn(*w.shape) * 0.01).astype(np.float32)

    def j_conv(x, w, pm):
        return j_masked_conv2d(x, w, jnp.asarray(own), pm, 2, stride=stride,
                               padding=jpad)

    jy = j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(pm))
    gref = rng.randn(*jy.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(j_conv(*a) * gref),
                    argnums=(0, 1, 2))(*(jnp.asarray(v) for v in (x, w, pm)))
    tx, tw, tpm = (torch.tensor(v, requires_grad=True) for v in (x, w, pm))
    y = t_mc.masked_conv2d(tx, tw, torch.from_numpy(own), tpm, 2,
                           stride=stride, padding=pad)
    _close(y, jy, what="y")
    (y * torch.from_numpy(gref)).sum().backward()
    for got, ref, what in zip((tx.grad, tw.grad, tpm.grad), want,
                              ("dx", "dw", "dpm")):
        _close(got, ref, what=what)


def test_masked_matmul_fc5_matches_jax():
    """fc5's dense product at width 0.125, (M, 2688) x (2688, 64): y, dx,
    dw and dpm against `cpg_tpu`'s Pallas masked matmul and its VJP
    (interpret mode)."""
    rng = np.random.RandomState(5)
    x = rng.randn(6, 2688).astype(np.float32)
    w = (rng.randn(2688, 64) * 0.02).astype(np.float32)
    own = rng.choice([0, 1, 2, 3], size=w.shape).astype(np.int8)
    pm = (rng.randn(*w.shape) * 0.01).astype(np.float32)

    def j_mm(x, w, pm):
        return j_masked_matmul(x, w, jnp.asarray(own), pm, 2)

    jy = j_mm(*(jnp.asarray(v) for v in (x, w, pm)))
    gref = rng.randn(*jy.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(j_mm(*a) * gref),
                    argnums=(0, 1, 2))(*(jnp.asarray(v) for v in (x, w, pm)))
    tx, tw, tpm = (torch.tensor(v, requires_grad=True) for v in (x, w, pm))
    y = t_mm.masked_matmul(tx, tw, torch.from_numpy(own), tpm, 2)
    _close(y, jy, what="y")
    (y * torch.from_numpy(gref)).sum().backward()
    for got, ref, what in zip((tx.grad, tw.grad, tpm.grad), want,
                              ("dx", "dw", "dpm")):
        _close(got, ref, what=what)


# (dtype, use_pallas_conv, use_pallas, width, refused)
WIDTH_CASES = {
    "conv_bf16_full": ("bf16", True, True, 1.0, None),
    "conv_bf16_grown": ("bf16", True, True, 1.5, None),
    "conv_bf16_w0.125": ("bf16", True, True, 0.125, None),
    "conv_bf16_off_4": ("bf16", True, False, 0.1, "use_pallas_conv needs "
                        "multiples of 4"),
    "dense_bf16_off_4": ("bf16", False, True, 0.1, "use_pallas needs "
                         "multiples of 4"),
    "f32_off_4": ("f32", True, True, 0.1, None),
}


@pytest.mark.parametrize("case", list(WIDTH_CASES))
def test_refuse_kernel_widths_checks_spherenet(case):
    """`refuse_kernel_widths` checks SphereNet-20 (it used to pass every
    arch it did not know): in bf16 a conv Cout off a multiple of 4 under
    the masked conv (width 0.1: 6 channels), fc5's output off a multiple
    of 4 under the dense route (0.1: 51); no fused-seam limit (no seams,
    so `use_fused_chain` adds no check), nothing in f32."""
    from cpg_tpu_torch.train.sequence import refuse_kernel_widths

    dt, conv, dense, mult, refused = WIDTH_CASES[case]
    for fused in (False, True):
        cfg = t_step.TrainConfig(
            compute_dtype={"bf16": torch.bfloat16, "f32": torch.float32}[dt],
            use_pallas_conv=conv, use_pallas=dense, use_fused_chain=fused)

        def call():
            refuse_kernel_widths(cfg, ARCH, [mult], (*HW, 3))

        if refused is None:
            call()
        else:
            with pytest.raises(ValueError, match=refused):
                call()


# ------------------------------------------------------------ serving ----

@pytest.fixture(scope="module")
def calibrated(np_state):
    """Both packages' int8 servers in f32, calibrated on the same batches."""
    jsrv = JServer(_to_jax(np_state), j_aug.face_eval_preprocess,
                   quantize="int8", compute_dtype=jnp.float32)
    tsrv = TaskServer(state_from_numpy(np_state, "cpu"),
                      t_aug.face_eval_preprocess, quantize="int8",
                      compute_dtype=torch.float32, device="cpu")
    calib = {1: _images(8, 2), 2: _images(8, 3)}
    return jsrv, tsrv, jsrv.calibrate(calib), tsrv.calibrate(calib)


def test_f32_server_matches_jax(np_state, jax_logits):
    """The f32 TaskServer of both tasks against `cpg_tpu`'s forward (task
    1 serves the AngleLinear head's cos part, as `cpg_tpu`'s server)."""
    srv = TaskServer(state_from_numpy(np_state, "cpu"),
                     t_aug.face_eval_preprocess, compute_dtype=torch.float32,
                     device="cpu")
    _close(srv.predict(1, _images(6, 1)), jax_logits[1][0], what="task 1")
    _close(srv.predict(2, _images(6, 1)), jax_logits[2], what="task 2")


def test_calibrated_int8_server_matches_jax(calibrated):
    """Static activation scales (21 products a task) at rtol 1e-5 and the
    calibrated int8 outputs within INT8_TOL x max|ref| with equal argmax."""
    jsrv, tsrv, want, got = calibrated
    for tid in (1, 2):
        assert set(got[tid]) == set(want[tid]) and len(got[tid]) == 21
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
    in the other bit for bit, the heads' forward kwargs with them, and
    serve the same outputs."""
    jsrv, tsrv, _, _ = calibrated
    jsrv.export(str(tmp_path / "jax8"))
    tsrv.export(str(tmp_path / "port8"))
    from_jax = TaskServer.load(str(tmp_path / "jax8"),
                               t_aug.face_eval_preprocess, device="cpu")
    from_port = JServer.load(str(tmp_path / "port8"),
                             j_aug.face_eval_preprocess)
    for tid in (1, 2):
        assert from_jax.state.forward_kwargs(tid) == {
            "head_type": HEADS[tid]}
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
    for tid in (1, 2):
        _eq(TaskServer.load(str(tmp_path / "port8"),
                            t_aug.face_eval_preprocess,
                            device="cpu").predict(tid, x),
            tsrv.predict(tid, x))
    f32 = TaskServer(state_from_numpy(np_state, "cpu"),
                     t_aug.face_eval_preprocess, compute_dtype=torch.float32,
                     device="cpu")
    f32.export(str(tmp_path / "port32"))
    back = JServer.load(str(tmp_path / "port32"), j_aug.face_eval_preprocess)
    for k, v in f32._eff[2].items():
        _eq(v, back._eff[2][k], k)


# ---------------------------------------------------------- the steps ----

KERNELS = dict(use_pallas_conv=True, use_pallas=True)


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["default", "kernels"])
def test_eval_step_matches_jax(np_state, jax_logits, flags):
    """The masked eval step of task 2 (default, and with the masked-conv
    and dense kernels) against `cpg_tpu`'s forward of the effective
    params; task 1's angle head through the step's accuracy."""
    st = state_from_numpy(np_state, "cpu")
    for tid in (1, 2):
        t = st.tasks[tid]
        step = t_step.make_eval_step(
            t_get_model(ARCH)[0], num_classes=NC[tid], mult=MULT,
            has_piggymask=tid > 1, model_kwargs={"head_type": HEADS[tid]},
            cfg=t_step.TrainConfig(compute_dtype=torch.float32, **flags),
            preprocess_fn=t_aug.face_eval_preprocess, device="cpu")
        y = np.arange(6) % NC[tid]
        logits, m = step(st.shared, t.piggymask, t.private, t.bn_state,
                         st.ownership, tid, _images(6, 1), y)
        want = jax_logits[tid][0] if tid == 1 else jax_logits[tid]
        _close(logits[0] if tid == 1 else logits, want, what=f"task {tid}")
        assert int(m["acc_sum"]) == int((want.argmax(1) == y).sum())


BASE = dict(lr=2e-3, lr_mask=1e-4)


def _batches(tid):
    rng = np.random.RandomState(9 + tid)
    return [(_images(BATCH, 10 + i), rng.randint(0, NC[tid], BATCH),
             jax.random.PRNGKey(20 + i)) for i in range(STEPS)]


def _face_draws(key, n):
    """The flips `cpg_tpu.data.augment.face_train_augment` draws from
    `key`."""
    return np.array(jax.random.bernoulli(key, 0.5, (n, 1, 1, 1))).reshape(n)


def _loss_kw(tid, make):
    return ({"loss_fn": make()} if HEADS[tid] == "angle" else {})


@pytest.fixture(scope="module")
def jax_steps(np_state):
    """`cpg_tpu`'s default train step on each task (task 1 under the
    annealed A-Softmax loss, no piggymask), three steps, jitted once."""
    out = {}
    for tid in (1, 2):
        st = _to_jax(np_state)
        task = st.tasks[tid]
        has_pm = task.piggymask is not None
        step, (opt_w, opt_pm) = j_build_train_step(
            j_get_model(ARCH)[0], num_classes=NC[tid], mult=MULT,
            has_piggymask=has_pm, augment_fn=j_aug.face_train_augment,
            model_kwargs={"head_type": HEADS[tid]},
            cfg=JConfig(compute_dtype=jnp.float32, **BASE),
            **_loss_kw(tid, j_make_angle_loss))
        shared, pm, priv, bn = (st.shared, task.piggymask, task.private,
                                task.bn_state)
        ows = opt_w.init({"shared": shared, "private": priv})
        opms = opt_pm.init(pm) if has_pm else None
        jstep = jax.jit(step)
        losses = []
        for i, (x, y, key) in enumerate(_batches(tid)):
            shared, pm, priv, bn, ows, opms, m = jstep(
                shared, pm, priv, bn, ows, opms, st.ownership, tid,
                jnp.asarray(x), jnp.asarray(y), key, i)
            losses.append(float(m["loss"]))
        out[tid] = (losses, shared, pm, priv, bn)
    return out


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["default", "kernels"])
@pytest.mark.parametrize("tid", [1, 2], ids=["task1_angle", "task2_linear"])
def test_train_steps_match_jax(np_state, jax_steps, tid, flags):
    """Three steps of each task (task 1 under the A-Softmax loss, its
    global step annealing lambda; task 2 with the linear head and a
    piggymask), `cpg_tpu`'s flip draws handed in, at the tolerances of
    `tests/test_torch_port_train.py` (`_assert_runs_match`); ownership
    gating exact: prior-task entries unchanged, free entries zero."""
    st = state_from_numpy(np_state, "cpu")
    task = st.tasks[tid]
    has_pm = task.piggymask is not None
    step, (opt_w, opt_pm) = t_step.build_train_step(
        t_get_model(ARCH)[0], num_classes=NC[tid], mult=MULT,
        has_piggymask=has_pm, augment_fn=t_aug.face_train_augment,
        model_kwargs={"head_type": HEADS[tid]}, device="cpu",
        cfg=t_step.TrainConfig(compute_dtype=torch.float32, **BASE, **flags),
        **_loss_kw(tid, make_angle_loss))
    shared, pm, priv, bn = st.shared, task.piggymask, task.private, task.bn_state
    ows = opt_w.init({"shared": shared, "private": priv})
    opms = opt_pm.init(pm) if has_pm else None
    losses = []
    for i, (x, y, key) in enumerate(_batches(tid)):
        shared, pm, priv, bn, ows, opms, m = step(
            shared, pm, priv, bn, ows, opms, st.ownership, tid, x, y,
            _face_draws(key, BATCH), i)
        losses.append(float(m["loss"]))
    _assert_runs_match(jax_steps[tid], (losses, shared, pm, priv, bn))
    for k, w0 in np_state.shared.items():
        own = np_state.ownership[k]
        prior = (own > 0) & (own < tid)
        _eq(shared[k][prior], w0[prior], k)
        assert not shared[k][own == 0].any(), k


def test_face_augment_bit_exact_with_jax_draws():
    """(x - 127.5) / 128 and `cpg_tpu`'s flips, bit for bit; a generator's
    draws are a function of its seed."""
    x = _images(6, 6)
    key = jax.random.PRNGKey(12)
    want = np.asarray(j_aug.face_train_augment(jnp.asarray(x), key))
    flips = _face_draws(key, 6)
    assert flips.any() and not flips.all()
    got = t_aug.face_train_augment(torch.from_numpy(x), flips)
    assert got.dtype == torch.float32
    _eq(got, want)
    _eq(t_aug.face_eval_preprocess(torch.from_numpy(x)),
        j_aug.face_eval_preprocess(jnp.asarray(x)))
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    _eq(t_aug.face_train_augment(torch.from_numpy(x), g1),
        t_aug.face_train_augment(torch.from_numpy(x), g2).numpy())
    assert t_aug.AUGMENTS["face"] == (t_aug.face_train_augment,
                                      t_aug.face_eval_preprocess)
