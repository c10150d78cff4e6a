"""The port's face data, converters and growth against `cpg_tpu`'s, on the
CPU: the synthetic identities, verification pairs and CASIA task (and its
`CPG_DATA_DIR` layouts), the LFW protocol (pairs.txt parsing, image
loading, the 10-fold threshold, `eval_pairs`), the sphere20a converter and
the pretrained adoption, the reference CPG checkpoint's import and export
(`import-torch`, `export-torch`) and `grow_state` on SphereNet-20, whose
fc5 takes a spatial flatten.

Data, converters and exported dicts are held bit for bit. Where
`cpg_tpu`'s fresh inits are compared (its checkpoint import and
`grow_state`), its `fw.init` runs jitted (`_jit_init`: the same function,
compiled once per signature instead of op by op); the port takes those
trees through the `init_fn` seam.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.data import face as j_face
from cpg_tpu.inference import make_predict_fn as j_make_predict_fn
from cpg_tpu.models import framework as j_fw
from cpg_tpu.models import get_model as j_get_model
from cpg_tpu.train import pretrained as j_pre
from cpg_tpu.train.export_torch import \
    export_torch_cpg_checkpoint as j_export_torch
from cpg_tpu.train.sequence import grow_state as j_grow_state
from cpg_tpu_torch import cli
from cpg_tpu_torch.core.state import state_from_numpy, state_to_numpy
from cpg_tpu_torch.data import augment as t_aug
from cpg_tpu_torch.data import face as t_face
from cpg_tpu_torch.inference import predict
from cpg_tpu_torch.train import pretrained as t_pre
from cpg_tpu_torch.train.export_torch import export_torch_cpg_checkpoint
from cpg_tpu_torch.train.sequence import grow_state, init_state
from cpg_tpu_torch.utils.checkpoint import load_state, save_state

from .test_torch_parity import TorchSphere20
from .test_torch_port_deploy import _ckpt_eq, _states_eq
from .test_torch_port_face import HW, _images, _np_state, _to_jax

torch.set_num_threads(1)
ANGLE_BOTH = {1: "angle", 2: "angle"}


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


_J_INIT = j_fw.init
_JITTED = {}


def _jit_init(key, model_fn, sample_x, compute_dtype=jnp.float32, **kw):
    """`cpg_tpu`'s fw.init, jitted once per (model, input shape, kwargs)."""
    sig = (model_fn, tuple(sample_x.shape), tuple(sorted(kw.items())))
    if sig not in _JITTED:
        shape = tuple(sample_x.shape)
        _JITTED[sig] = jax.jit(lambda k: _J_INIT(
            k, model_fn, jnp.zeros(shape), compute_dtype, **kw))
    return _JITTED[sig](key)


@pytest.fixture
def jit_init(monkeypatch):
    monkeypatch.setattr(j_fw, "init", _jit_init)


def _jax_init_fn(key):
    """The port's init seam, handing in `_jit_init`'s trees under `key`."""

    def init(gen, model_fn, sample_x, **kw):
        out = _jit_init(key, j_get_model("spherenet20")[0],
                        jnp.zeros(tuple(sample_x.shape)), **kw)
        return tuple({k: torch.from_numpy(np.array(v)) for k, v in t.items()}
                     for t in out)

    return init


# --------------------------------------------------------------- data ----

def test_synthetic_faces_and_pairs_match_jax():
    for kw in ({}, dict(num_ids=7, per_id=24, seed=11)):
        for got, want in zip(t_face.synthetic_faces(**kw),
                             j_face.synthetic_faces(**kw)):
            _eq(got, want)
    x, y = t_face.synthetic_faces(num_ids=10, per_id=8, seed=5)
    for got, want in zip(t_face.make_pairs(x, y, n_pairs=200, seed=2),
                         j_face.make_pairs(x, y, n_pairs=200, seed=2)):
        _eq(got, want)


def _write_faces(root, rng, ids=("b_id", "a_id"), per=3):
    from PIL import Image

    for name in ids:
        os.makedirs(os.path.join(root, name))
        for i in range(per):
            Image.fromarray(rng.randint(0, 256, (*HW, 3)).astype(np.uint8)) \
                .save(os.path.join(root, name, f"{name}_{i + 1:04d}.jpg"))


@pytest.mark.parametrize("layout", ["synthetic", "npz", "imagefolder"])
def test_casia_task_matches_jax(tmp_path, monkeypatch, layout):
    """`casia_task` through each layout `cpg_tpu` reads: the seeded
    synthetic identities, `$CPG_DATA_DIR/casia_train.npz` and the
    identity-per-folder JPEG tree, bit for bit."""
    rng = np.random.RandomState(3)
    if layout == "npz":
        np.savez(tmp_path / "casia_train.npz",
                 x=rng.randint(0, 256, (20, *HW, 3)).astype(np.uint8),
                 y=np.arange(20) % 4)
    elif layout == "imagefolder":
        _write_faces(str(tmp_path / "casia"), rng)
    if layout != "synthetic":
        monkeypatch.setenv("CPG_DATA_DIR", str(tmp_path))
    got, want = t_face.casia_task(seed=1), j_face.casia_task(seed=1)
    assert sorted(got) == sorted(want)
    for k in ("train_x", "train_y", "test_x", "test_y"):
        _eq(got[k], want[k], k)
    assert got["num_classes"] == want["num_classes"]
    assert got["model_kwargs"] == want["model_kwargs"] == {
        "head_type": "angle"}


def _pairs_txt(path, folds=2, per=2):
    """A small official-format pairs.txt over a_id and b_id (3 images
    each)."""
    lines = [f"{folds}\t{per}"]
    for _ in range(folds):
        lines += ["a_id\t1\t2", "b_id\t2\t3"][:per]
        lines += ["a_id\t1\tb_id\t3", "b_id\t1\ta_id\t3"][:per]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_lfw_pairs_parse_and_load_match_jax(tmp_path):
    """pairs.txt parsing (header, same and different lines, relative
    paths) and `load_lfw_pairs` (each image decoded once) bit for bit; a
    short file raises as `cpg_tpu`'s does."""
    _write_faces(str(tmp_path), np.random.RandomState(4))
    _pairs_txt(tmp_path / "pairs.txt")
    want = j_face.parse_lfw_pairs(str(tmp_path / "pairs.txt"))
    assert t_face.parse_lfw_pairs(str(tmp_path / "pairs.txt")) == want
    assert len(want) == 8 and [p[2] for p in want[:4]] == [1, 1, 0, 0]
    for got, ref in zip(t_face.load_lfw_pairs(str(tmp_path)),
                        j_face.load_lfw_pairs(str(tmp_path))):
        _eq(got, ref)
    _pairs_txt(tmp_path / "short.txt", folds=3)
    with open(tmp_path / "short.txt") as f:
        body = f.read().splitlines()[:-1]
    with open(tmp_path / "short.txt", "w") as f:
        f.write("\n".join(body))
    for mod in (t_face, j_face):
        with pytest.raises(ValueError, match="pair lines"):
            mod.parse_lfw_pairs(str(tmp_path / "short.txt"))


def test_verification_and_eval_pairs_match_jax():
    """The 10-fold threshold selection on cosine similarities, and the whole
    protocol (features of the image and its flip, normalised, pair
    cosines) with one embedding function in both packages."""
    rng = np.random.RandomState(6)
    sims = rng.uniform(-1, 1, 200).astype(np.float32)
    labels = (sims + rng.randn(200) * 0.5 > 0).astype(np.int32)
    assert t_face.verification_accuracy(sims, labels) == \
        j_face.verification_accuracy(sims, labels)
    x, yid = t_face.synthetic_faces(num_ids=10, per_id=8, seed=5)
    i1, i2, same = t_face.make_pairs(x, yid, n_pairs=200, seed=2)
    proj = rng.randn(48, 16).astype(np.float32)

    def feats(a):  # a fixed projection of each image's first 48 values
        return a.reshape(len(a), -1)[:, :48].astype(np.float32) @ proj

    got = t_face.eval_pairs(lambda b: torch.from_numpy(feats(b.numpy())),
                            x, i1, i2, same)
    want = j_face.eval_pairs(lambda b: jnp.asarray(feats(np.asarray(b))),
                             x, i1, i2, same)
    assert got == want and 0.0 <= got[0] <= 1.0


# --------------------------------------------------------- converters ----

@pytest.fixture(scope="module")
def sphere_sd():
    """A seeded sphere20a torch model at full width and its state_dict as
    numpy arrays."""
    torch.manual_seed(0)
    tm = TorchSphere20().eval()
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.startswith("relu"):
                p.uniform_(0.1, 0.4)
    return tm, {k: v.detach().numpy() for k, v in tm.state_dict().items()}


def test_convert_torch_spherenet20_matches_jax(sphere_sd):
    """The converter's three trees bit for bit (fc5's rows permuted from
    torch's (C, H, W) flatten to (H, W, C)), and the adopted net's
    embedding equals the torch model's forward."""
    tm, sd = sphere_sd
    got = t_pre.convert_torch_spherenet20(sd)
    want = j_pre.convert_torch_spherenet20(sd)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            _eq(g[k], w[k], k)
    assert got[0]["fc5/kernel"].shape == (21504, 512)
    st = init_state("spherenet20", torch.Generator().manual_seed(0),
                    device="cpu")
    t_pre.adopt_pretrained_task1(st, "casia", 8, got[0], private=got[1],
                                 bn_state=got[2])
    x = np.random.RandomState(1).randn(2, *HW, 3).astype(np.float32) * 0.5
    with torch.no_grad():
        ref = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    emb = predict(st, 1, torch.from_numpy(x), device="cpu",
                  model_kwargs={"head_type": "none"})
    np.testing.assert_allclose(emb.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_import_torch_matches_jax(tmp_path, jit_init):
    """A reference CPG checkpoint of a two-task SphereNet (AngleLinear
    heads, PReLU slopes and fc5 biases per dataset, as `cpg_tpu`'s export
    writes it), saved with torch.save: `import-torch --arch spherenet20`
    gives `cpg_tpu`'s converted state bit for bit."""
    ckpt = j_export_torch(_to_jax(_np_state(seed=2, heads=ANGLE_BOTH)))
    want = j_pre.convert_torch_cpg_checkpoint(ckpt, arch="spherenet20")
    path, out = str(tmp_path / "ref.pth"), str(tmp_path / "ck")
    torch.save(ckpt, path)
    assert cli.main(["import-torch", "--ckpt", path, "--arch", "spherenet20",
                     "--out", out, "--device", "cpu"]) == 0
    got = state_to_numpy(load_state(out, device="cpu"))
    _states_eq(got, want)
    assert got.tasks[2].piggymask["fc5/kernel"].shape == (2688, 64)


def test_export_torch_matches_jax(tmp_path):
    """`export-torch` of a SphereNet state with AngleLinear heads writes
    `cpg_tpu`'s dict (sphere20a names, fc5 NCHW-flat, heads (in, out),
    `prelu_layer_weight` and `bias` per dataset, fc6) bit for bit."""
    np_state = _np_state(seed=3, heads=ANGLE_BOTH)
    want = j_export_torch(_to_jax(np_state))
    _ckpt_eq(export_torch_cpg_checkpoint(state_from_numpy(np_state, "cpu")),
             want)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "ref.pth")
    save_state(state_from_numpy(np_state, "cpu"), ck)
    assert cli.main(["export-torch", "--ckpt", ck, "--out", out,
                     "--device", "cpu"]) == 0
    _ckpt_eq(torch.load(out, weights_only=False), want)
    assert want["state_dict"]["fc5.weight"].shape == (64, 2688)


def test_face_state_round_trips_with_its_linear_head():
    """The face sequence's state (task 2 an expression task with a linear
    head, which `cpg_tpu`'s export cannot write: it takes every SphereNet
    head as AngleLinear) goes out as a torch Linear (weight (out, in) and
    bias) and comes back bit for bit, task 2 again a linear-head task."""
    np_state = _np_state(seed=4)
    with pytest.raises(KeyError, match="classifier_angle"):
        j_export_torch(_to_jax(np_state))
    ckpt = export_torch_cpg_checkpoint(state_from_numpy(np_state, "cpu"))
    assert ckpt["state_dict"]["classifiers.1.weight"].shape == (7, 64)
    assert "fc6.weight" not in ckpt["state_dict"]
    back = t_pre.convert_torch_cpg_checkpoint(ckpt, arch="spherenet20",
                                              device="cpu")
    _states_eq(state_to_numpy(back), np_state)
    assert back.forward_kwargs(2) == {"head_type": "linear"}
    assert back.forward_kwargs(1) == {}  # the default, AngleLinear
    x = torch.from_numpy(_images(2, 7))
    st = state_from_numpy(np_state, "cpu")
    for tid in (1, 2):
        a, b = (predict(s, tid, x, t_aug.face_eval_preprocess, device="cpu")
                for s in (st, back))
        for u, v in zip(*((o,) if not isinstance(o, tuple) else o
                          for o in (a, b))):
            _eq(u, v, f"task {tid}")


# ------------------------------------------------------------- growth ----

@pytest.fixture(scope="module")
def grown():
    """A two-task face state (task 1 AngleLinear, task 2 linear) grown
    0.125 -> 0.1875 by both packages, the flatten dims resolved from the
    registry ("auto") and, as a control, not at all (None)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fw, "init", _jit_init)
        src = _np_state(seed=5)
        key = jax.random.PRNGKey(8)
        out = {"src": src,
               "jax": j_grow_state(_to_jax(_np_state(seed=5)), 0.1875, key)}
        for dims in ("auto", None):
            out[dims] = grow_state(state_from_numpy(src, "cpu"), 0.1875,
                                   torch.Generator().manual_seed(8),
                                   flatten_dims=dims, device="cpu",
                                   init_fn=_jax_init_fn(key))
    return out


def _outputs(st, tid, x):
    """Task `tid`'s embedding and head outputs (AngleLinear: cos, phi)."""
    emb = predict(st, tid, x, t_aug.face_eval_preprocess, device="cpu",
                  model_kwargs={"head_type": "none"})
    out = predict(st, tid, x, t_aug.face_eval_preprocess, device="cpu")
    return [emb, *(out if isinstance(out, tuple) else (out,))]


def _jax_embed(jst, tid):
    """`cpg_tpu`'s jitted predict of task `tid`'s embedding."""
    t = jst.tasks[tid]
    meta, t.meta = t.meta, {"model_kwargs": {"head_type": "none"}}
    try:
        return j_make_predict_fn(jst, tid)
    finally:
        t.meta = meta


def test_grow_state_matches_jax(grown):
    """`grow_state` on SphereNet-20 equals `cpg_tpu`'s bit for bit: every
    shared kernel (fc5's input rows block-permuted by the (7, 6) flatten),
    ownership, piggymask, PReLU slope (grown channels 0.25), fc5 bias and
    head."""
    got, want = state_to_numpy(grown["auto"]), grown["jax"]
    assert got.width_mult == want.width_mult == 0.1875
    assert got.shared["fc5/kernel"].shape == (42 * 96, 96)
    _states_eq(got, want)
    slope = got.tasks[1].private["stage4/unit0/prelu2/slope"]
    assert (slope[64:] == 0.25).all()
    head = got.tasks[1].private["classifier_angle/kernel"]
    assert head.shape == (96, 6) and not head[64:].any()


def test_growth_keeps_old_tasks_only_with_the_flatten_permutation(grown):
    """Across the growth every task's embedding (its first 64 entries; the
    32 grown ones are exactly 0) and head outputs stay (rtol 1e-5, atol
    1e-6: the wider convolutions sum the same terms plus exact zeros, in
    another order), in both packages. Growing fc5 as a plain block embed
    (flatten_dims=None) puts old activations on the wrong rows: task 1's
    embedding then moves by more than 10% of its size, so this test
    catches that fault."""
    x = torch.from_numpy(_images(4, 9))
    jx = jnp.asarray(t_aug.face_eval_preprocess(x).numpy())
    src = state_from_numpy(grown["src"], "cpu")
    for tid in (1, 2):
        before = _outputs(src, tid, x)
        after = _outputs(grown["auto"], tid, x)
        jemb = np.asarray(_jax_embed(grown["jax"], tid)(jx))
        assert after[0].shape == jemb.shape == (4, 96)
        assert not after[0][:, 64:].any() and not jemb[:, 64:].any()
        for a, b, what in ((after[0][:, :64], before[0], "embedding"),
                           (jemb[:, :64], before[0], "jax embedding"),
                           *zip(after[1:], before[1:], ("head", "phi"))):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"task {tid} {what}")
    emb = _outputs(src, 1, x)[0]
    emb_bad = _outputs(grown[None], 1, x)[0][:, :64]
    assert float((emb_bad - emb).norm()) > 0.1 * float(emb.norm())
