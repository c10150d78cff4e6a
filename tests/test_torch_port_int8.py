"""The port's int8 serving against `cpg_tpu`'s, on the CPU.

The same numpy states (VGG16-BN at width 0.125; vit_cifar cut to depth 2,
dim 64) go into both packages' int8 TaskServers. Held bit for bit: the
weight quantization (`_quantize_tree`), the int8 `sconv`/`sdense` on the
same f32 input and int8 weights (dynamic and static activation scales),
and int8 artifacts loaded across the packages. Whole servers agree within
2e-2 x max|ref| with equal argmax: the layers before a quantization differ
in f32 summation order, and such a difference can move a value across a
rounding boundary, which flips one int8 step there. Calibrated scales
agree at rtol 1e-5 (f32 servers). On the CPU the int8 products take their
plain version (an int32 matmul over the same patches).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.core.state import CPGState as JState
from cpg_tpu.core.state import TaskEntry as JTask
from cpg_tpu.data.augment import cifar_eval_preprocess as j_prep
from cpg_tpu.models import framework as j_fw
from cpg_tpu.ops.masked import effective_params as j_eff
from cpg_tpu.serve import TaskServer as JServer
from cpg_tpu.serve import _quantize_tree as j_quantize_tree
from cpg_tpu_torch.core.pruner import one_shot_prune
from cpg_tpu_torch.core.state import state_from_numpy, state_to_numpy
from cpg_tpu_torch.data.augment import cifar_eval_preprocess as t_prep
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.ops import int8 as t_int8
from cpg_tpu_torch.ops.masked import effective_params as t_eff
from cpg_tpu_torch.serve import TaskServer, _quantize_tree
from cpg_tpu_torch.train.sequence import init_state, start_task

from .test_torch_port_vit import _np_state as _vit_np_state

torch.set_num_threads(1)
TOL = 2e-2  # max|diff| <= TOL * max|ref|, see the module docstring


def _vgg_np_state():
    g = torch.Generator().manual_seed(0)
    s = init_state("vgg16_bn_cifar", g, 0.125, device="cpu")
    start_task(s, "t1", 5, g)
    s.shared, s.ownership = one_shot_prune(s.shared, s.ownership, 1, 0.5)
    start_task(s, "t2", 5, g)
    for k, pm in s.tasks[2].piggymask.items():
        s.tasks[2].piggymask[k] = pm + torch.randn(pm.shape, generator=g) * 0.01
    for t in s.tasks.values():  # unit-scale heads, BN stats off their init
        t.private["classifier/kernel"] = torch.randn(
            t.private["classifier/kernel"].shape, generator=g)
        t.bn_state = {k: v + 0.1 * torch.rand(v.shape, generator=g)
                      for k, v in t.bn_state.items()}
    return state_to_numpy(s)


STATES = {"vgg16_bn_cifar": _vgg_np_state, "vit_cifar": _vit_np_state}


@pytest.fixture(scope="module", params=list(STATES))
def np_state(request):
    return STATES[request.param]()


def _to_jax(s) -> JState:
    return JState(arch=s.arch, width_mult=s.width_mult, shared=s.shared,
                  ownership=s.ownership,
                  tasks={tid: JTask(**dataclasses.asdict(t))
                         for tid, t in s.tasks.items()},
                  threshold=s.threshold, mask_mode=s.mask_mode,
                  model_kwargs=dict(s.model_kwargs))


def _images(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3)).astype(
        np.uint8)


def _servers(np_state, **kw):
    return (JServer(_to_jax(np_state), j_prep, quantize="int8", **kw),
            TaskServer(state_from_numpy(np_state, "cpu"), t_prep,
                       quantize="int8", device="cpu", **kw))


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _close_rel(got, want, what=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= TOL * np.abs(want).max(), (what, err, np.abs(want).max())
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1),
                                  err_msg=what)


def test_quantize_tree_matches_jax(np_state):
    """Per-output-channel int8 weights equal, scales bit-equal."""
    t2 = np_state.tasks[2]
    eff = j_eff(np_state.shared, np_state.ownership, t2.piggymask, 2)
    jq, js = j_quantize_tree(eff)
    tq, ts = _quantize_tree({k: torch.from_numpy(np.array(v))
                             for k, v in eff.items()})
    assert set(tq) == set(jq)
    for k in jq:
        _eq(tq[k], jq[k], k)
        _eq(ts[k], js[k], k)


# (name, input NHWC, features, kernel, stride, padding)
CONV_CASES = [("conv3x3_same", (3, 8, 8, 16), 32, 3, 1, "SAME"),
              ("conv0", (2, 8, 8, 3), 8, 3, 1, "SAME"),
              ("conv3x3_s2", (2, 9, 9, 8), 16, 3, 2, "SAME"),
              ("patch_embed", (2, 16, 16, 3), 64, 8, 8, "VALID")]
# (name, input shape, features)
DENSE_CASES = [("dense_2d", (6, 40), 24), ("dense_tokens", (2, 5, 64), 48)]


def _layer_inputs(shape, wshape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    x.flat[0] = 0.5 * np.abs(x).max() / 127 * 3  # an exact .5 rounding tie
    wq = rng.randint(-127, 128, wshape).astype(np.int8)
    s_w = rng.uniform(1e-3, 2e-2, wshape[-1]).astype(np.float32)
    b = rng.randn(wshape[-1]).astype(np.float32)
    return x, wq, s_w, b


def _run_layer(fw, lib, kind, case, x, wq, s_w, b, static):
    """The layer's int8 output and its activation scale."""
    key = "l/kernel"
    scales = {key: lib(s_w)}
    ctx = fw.Ctx(mode="apply", train=False, shared={key: lib(wq)},
                 private={"l/bias": lib(b)}, quant_scales=scales,
                 act_scales={key: lib(np.float32(0.03))} if static else None)
    if kind == "conv":
        _, _, feat, k, stride, pad = case
        y = fw.sconv(ctx, "l", lib(x), feat, kernel=k, stride=stride,
                     padding=pad)
    else:
        y = fw.sdense(ctx, "l", lib(x), case[2])
    return y, ctx.act_scales[key] if static else _dyn_scale(fw, lib(x))


def _dyn_scale(fw, x):
    return fw._quantize_activation(x)[1]


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("kind,case", [("conv", c) for c in CONV_CASES]
                         + [("dense", c) for c in DENSE_CASES],
                         ids=[c[0] for c in CONV_CASES + DENSE_CASES])
def test_int8_layers_bit_equal_to_jax(kind, case, static):
    """`sconv` and `sdense` under int8 on the same f32 input and the same
    int8 weights and scales: the same bits as `cpg_tpu`'s, and the same
    recorded activation scale."""
    if kind == "conv":
        wshape = (case[3], case[3], case[1][-1], case[2])
    else:
        wshape = (case[1][-1], case[2])
    args = _layer_inputs(case[1], wshape, len(case[0]))
    # op by op, as `cpg_tpu`'s calibrate runs it: each op rounds once as
    # written (a jitted XLA CPU program fuses the rescale and the bias add
    # into one FMA, a last-bit difference)
    jy, js = _run_layer(j_fw, jnp.asarray, kind, case, *args, static)
    ty, ts = _run_layer(t_fw, lambda a: torch.from_numpy(np.array(a)),
                        kind, case, *args, static)
    _eq(ty, jy, case[0])
    _eq(ts, js, case[0])


def test_int_mm_plain_and_patches():
    """The plain int32 product and the patch gather the conv runs on."""
    rng = np.random.RandomState(0)
    a = rng.randint(-127, 128, (33, 27)).astype(np.int8)
    b = rng.randint(-127, 128, (27, 5)).astype(np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    _eq(t_int8.int_mm(torch.from_numpy(a), torch.from_numpy(b)),
        want.astype(np.int32))
    x = torch.arange(2 * 3 * 3 * 2, dtype=torch.int8).reshape(2, 3, 3, 2)
    p = t_int8.patches(x, 3, 3, 1, (1, 1, 1, 1))
    assert p.shape == (18, 18)
    # pixel (0, 0) of image 0: its 3x3 window, zero outside
    win = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))[0, :3, :3]
    assert torch.equal(p[0], win.reshape(-1))
    with pytest.raises(TypeError):
        t_int8.int_mm(torch.from_numpy(a).float(), torch.from_numpy(b))


def test_int8_servers_match_jax(np_state):
    """Whole int8 servers (dynamic scales) against `cpg_tpu`'s; the fused
    chain and flash attention stay off under int8."""
    jsrv, tsrv = _servers(np_state)
    for w in tsrv._eff[2].values():
        assert w.dtype == torch.int8
    x = _images(8, 1)
    for tid in (1, 2):
        _close_rel(tsrv.predict(tid, x), jsrv.predict(tid, x), tid)
    fused = TaskServer(state_from_numpy(np_state, "cpu"), t_prep,
                       quantize="int8", fused_chain=True, device="cpu")
    _eq(fused.predict(2, x), tsrv.predict(2, x), "fused_chain under int8")


@pytest.fixture(scope="module")
def calibrated(np_state):
    """Both packages' int8 servers in f32, calibrated on the same batches.
    (In bf16 the ViT's tokens round to bf16 before block 0's products, so
    a last-bit f32 difference upstream can flip a bf16 rounding, and with
    it a layer's max |x|, by a bf16 step.)"""
    jsrv = JServer(_to_jax(np_state), j_prep, quantize="int8",
                   compute_dtype=jnp.float32, min_bucket=4)
    tsrv = TaskServer(state_from_numpy(np_state, "cpu"), t_prep,
                      quantize="int8", compute_dtype=torch.float32,
                      min_bucket=4, device="cpu")
    calib = {1: _images(8, 2), 2: _images(8, 3)}
    return jsrv, tsrv, jsrv.calibrate(calib), tsrv.calibrate(calib)


def test_calibrate_matches_jax(calibrated):
    """Static activation scales from the same calibration batches, and the
    calibrated servers' logits."""
    jsrv, tsrv, want, got = calibrated
    for tid in (1, 2):
        assert set(got[tid]) == set(want[tid])
        for k, v in want[tid].items():
            np.testing.assert_allclose(got[tid][k].numpy(), np.asarray(v),
                                       rtol=1e-5, err_msg=k)
    x = _images(6, 4)
    _close_rel(tsrv.predict(2, x), jsrv.predict(2, x), "calibrated")


def test_int8_artifacts_load_across_packages(calibrated, tmp_path):
    """An int8 artifact (weights, weight scales, calibrated activation
    scales) exported by either package loads in the other bit for bit."""
    jsrv, tsrv, _, _ = calibrated
    jsrv.export(str(tmp_path / "jax"))
    tsrv.export(str(tmp_path / "port"))
    from_jax = TaskServer.load(str(tmp_path / "jax"), t_prep, device="cpu")
    from_port = JServer.load(str(tmp_path / "port"), j_prep)
    assert from_jax.quantize == from_port.quantize == "int8"
    for tid in (1, 2):
        for k, v in jsrv._eff[tid].items():
            _eq(from_jax._eff[tid][k], v, k)
            _eq(from_jax._scales[tid][k], jsrv._scales[tid][k], k)
        for k, v in jsrv._act_scales[tid].items():
            _eq(from_jax._act_scales[tid][k], v, k)
        for k, v in tsrv._eff[tid].items():
            _eq(v, from_port._eff[tid][k], k)
            _eq(tsrv._scales[tid][k], from_port._scales[tid][k], k)
        for k, v in tsrv._act_scales[tid].items():
            _eq(v, from_port._act_scales[tid][k], k)
    x = _images(5, 6)
    _close_rel(from_jax.predict(2, x), jsrv.predict(2, x), "jax artifact")
    _eq(TaskServer.load(str(tmp_path / "port"), t_prep,
                        device="cpu").predict(2, x), tsrv.predict(2, x))


def test_calibrated_int8_is_batching_invariant(np_state, tmp_path):
    """After calibrate(), a request's int8 logits are the same bits alone
    and next to saturated rows (in its bucket and a larger one), stay near
    the bf16 server's (`cpg_tpu`'s bound: rtol 0.2, atol 0.5, equal
    argmax), and survive export/load."""
    st = state_from_numpy(np_state, "cpu")
    srv = TaskServer(st, t_prep, min_bucket=4, quantize="int8", device="cpu")
    srv.calibrate({1: _images(32, 7), 2: _images(32, 8)})
    probe = _images(1, 9)
    outlier = np.full_like(probe, 255)
    alone = srv.predict(1, probe)
    co = srv.predict(1, np.concatenate([probe, outlier, outlier, outlier]))
    _eq(co[:1], alone)
    # another bucket: the head's fixed row blocks keep the bits too
    co = srv.predict(1, np.concatenate([probe, np.repeat(outlier, 40, 0)]))
    _eq(co[:1], alone)
    ref = TaskServer(st, t_prep, min_bucket=4, device="cpu").predict(1, probe)
    np.testing.assert_allclose(alone, ref, rtol=0.2, atol=0.5)
    assert (np.argmax(alone, 1) == np.argmax(ref, 1)).all()
    srv.export(str(tmp_path / "art"))
    srv2 = TaskServer.load(str(tmp_path / "art"), t_prep, device="cpu")
    assert srv2._act_scales[1]
    _eq(srv2.predict(1, probe), alone)


def test_lru_int8_matches_precompute(np_state, tmp_path):
    """cache='lru' under int8: the same logits as precompute, weights and
    scales evicted together, and export still writes every task."""
    st = state_from_numpy(np_state, "cpu")
    pre = TaskServer(st, t_prep, quantize="int8", device="cpu")
    lru = TaskServer(st, t_prep, quantize="int8", cache="lru", max_cached=1,
                     device="cpu")
    assert not lru._eff
    x = _images(5, 10)
    for tid in (1, 2, 1):
        _eq(lru.predict(tid, x), pre.predict(tid, x))
        assert list(lru._eff) == list(lru._scales) == [tid]
    lru.export(str(tmp_path / "art"))
    back = TaskServer.load(str(tmp_path / "art"), t_prep, device="cpu")
    _eq(back.predict(2, x), pre.predict(2, x))
