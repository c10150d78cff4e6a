"""The port's serving, state building and entry points, on the CPU.

Behaviour that `cpg_tpu`'s own serving tests check (bucket padding, mixed
routing, LRU eviction, artifact round trip, the offline CLI), here for
`cpg_tpu_torch`, plus: state building mirrors `cpg_tpu`'s parameter keys and
shapes, every entry point defaults to the card and raises without one, and
the unported serving options (`mesh`, XLA's compiler options) are
refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.models import framework as j_fw
from cpg_tpu.models import get_model as j_get_model
from cpg_tpu_torch import cli
from cpg_tpu_torch import inference as t_inference
from cpg_tpu_torch.core.pruner import one_shot_prune
from cpg_tpu_torch.data.augment import cifar_eval_preprocess as prep
from cpg_tpu_torch.data.augment import face_eval_preprocess
from cpg_tpu_torch.models import get_model
from cpg_tpu_torch.serve import TaskServer, _next_bucket
from cpg_tpu_torch.train.sequence import init_state, start_task
from cpg_tpu_torch.train.step import (TrainConfig, make_eval_step,
                                      make_train_step)

torch.set_num_threads(1)
MULT = 0.125


@pytest.fixture(scope="module")
def state():
    g = torch.Generator().manual_seed(0)
    s = init_state("vgg16_bn_cifar", g, MULT, device="cpu")
    start_task(s, "t1", 4, g)
    s.shared, s.ownership = one_shot_prune(s.shared, s.ownership, 1, 0.5)
    start_task(s, "t2", 6, g)
    for k, pm in s.tasks[2].piggymask.items():
        s.tasks[2].piggymask[k] = pm + torch.randn(pm.shape, generator=g) * 0.01
    for t in s.tasks.values():  # heads at unit scale: logits well above atol
        t.private["classifier/kernel"] = torch.randn(
            t.private["classifier/kernel"].shape, generator=g)
    return s


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(3).randint(0, 256, (11, 32, 32, 3)).astype(np.uint8)


def test_state_keys_and_shapes_match_jax(state):
    model_fn, _ = j_get_model("vgg16_bn_cifar")
    shapes = jax.eval_shape(lambda: j_fw.init(
        jax.random.PRNGKey(0), model_fn, jnp.zeros((1, 32, 32, 3)),
        num_classes=6, mult=MULT))
    j_shared, j_private, j_bn = shapes
    assert sorted(state.shared) == sorted(j_shared)
    for k, v in j_shared.items():
        assert tuple(state.shared[k].shape) == v.shape
        assert state.ownership[k].dtype == torch.int8
        assert tuple(state.tasks[2].piggymask[k].shape) == v.shape
    t2 = state.tasks[2]
    assert {k: tuple(v.shape) for k, v in t2.private.items()} == {
        k: v.shape for k, v in j_private.items()}
    assert set(t2.bn_state) == set(j_bn)
    assert state.tasks[1].piggymask is None
    # task 1 owns what survived the prune; task 2 claimed the rest
    own = torch.cat([o.ravel() for o in state.ownership.values()])
    assert set(own.unique().tolist()) == {1, 2}
    assert abs((own == 1).float().mean().item() - 0.5) < 0.01


def test_init_is_seeded():
    a = init_state("vgg16_bn_cifar", torch.Generator().manual_seed(5), MULT,
                   device="cpu")
    b = init_state("vgg16_bn_cifar", torch.Generator().manual_seed(5), MULT,
                   device="cpu")
    for k in a.shared:
        assert torch.equal(a.shared[k], b.shared[k])


def test_buckets_pad_and_chunk(state, images):
    assert [_next_bucket(n, 8, 32) for n in (1, 8, 9, 33)] == [8, 8, 16, 32]
    srv = TaskServer(state, prep, compute_dtype=torch.float32, min_bucket=4,
                     max_bucket=8, device="cpu")
    whole = srv.predict(2, images)  # 11 rows -> chunks of 8 (last padded)
    assert whole.shape == (11, 6)
    for i in (0, 5, 10):
        np.testing.assert_allclose(srv.predict(2, images[i:i + 1])[0],
                                   whole[i], rtol=1e-5, atol=1e-5)


def test_predict_mixed_routes_in_order(state, images):
    srv = TaskServer(state, prep, compute_dtype=torch.float32, device="cpu")
    reqs = [(1 + i % 2, images[i]) for i in range(6)]
    outs = srv.predict_mixed(reqs)
    for (tid, x), out in zip(reqs, outs):
        assert out.shape == (state.tasks[tid].num_classes,)
        np.testing.assert_allclose(out, srv.predict(tid, x[None])[0],
                                   rtol=1e-5, atol=1e-5)


def test_lru_cache_matches_precompute(state, images):
    pre = TaskServer(state, prep, compute_dtype=torch.float32, device="cpu")
    lru = TaskServer(state, prep, compute_dtype=torch.float32, cache="lru",
                     max_cached=1, device="cpu")
    assert not lru._eff
    for tid in (1, 2, 1):
        np.testing.assert_array_equal(lru.predict(tid, images[:3]),
                                      pre.predict(tid, images[:3]))
        assert list(lru._eff) == [tid]


def test_predict_api_matches_server(state, images):
    srv = TaskServer(state, prep, compute_dtype=torch.float32, device="cpu")
    got = t_inference.predict(state, 2, torch.from_numpy(images), prep,
                              device="cpu")
    np.testing.assert_allclose(got.numpy(), srv.predict(2, images),
                               rtol=1e-5, atol=1e-5)


def test_export_load_and_cli(state, images, tmp_path):
    srv = TaskServer(state, prep, compute_dtype=torch.float32, device="cpu")
    art = str(tmp_path / "art")
    srv.export(art)
    meta = json.loads((tmp_path / "art" / "serving_meta.json").read_text())
    assert meta["compute_dtype"] == "float32" and meta["quantize"] is None
    want = srv.predict(2, images)
    loaded = TaskServer.load(art, prep, fused_chain=True, device="cpu")
    np.testing.assert_allclose(loaded.predict(2, images), want, rtol=1e-5,
                               atol=1e-5)
    req = str(tmp_path / "req.npz")
    np.savez(req, x=images, task_ids=np.array([1, 2] * 5 + [2], np.int32))
    out = str(tmp_path / "out.npz")
    assert cli.main(["serve", "--artifact", art, "--requests", req,
                     "--out", out, "--fused-chain", "--device", "cpu"]) == 0
    z = np.load(out)
    np.testing.assert_allclose(z["logits_1"], want[1], rtol=1e-5, atol=1e-5)
    assert z["logits_0"].shape == (4,)
    assert cli.main(["serve", "--artifact", art, "--requests", req,
                     "--task-id", "2", "--out", out, "--device", "cpu"]) == 0
    np.testing.assert_allclose(np.load(out)["logits"], want, rtol=1e-5,
                               atol=1e-5)


def test_unported_options_are_refused(state, tmp_path):
    """`mesh` serving (ROADMAP Queue 1, item 12) and XLA's compiler
    options are refused; int8 is ported (tests/test_torch_port_int8.py),
    and so are the textcls experiment (no preprocess: tokens) and the face
    experiment's preprocess."""
    with pytest.raises(NotImplementedError, match="mesh"):
        TaskServer(state, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="XLA"):
        TaskServer(state, compiler_options={}, device="cpu")
    with pytest.raises(ValueError):
        TaskServer(state, quantize="fp4", device="cpu")
    with pytest.raises(ValueError):
        TaskServer(state, cache="fifo", device="cpu")
    art = str(tmp_path / "art")
    TaskServer(state, prep, compute_dtype=torch.float32, device="cpu").export(art)
    with pytest.raises(NotImplementedError, match="mesh"):
        TaskServer.load(art, mesh=object(), device="cpu")
    with pytest.raises(SystemExit, match="XLA"):
        cli.main(["serve", "--artifact", art, "--scoped-vmem-kib", "1024",
                  "--device", "cpu"])
    # the textcls experiment is ported: tokens take no eval preprocess
    for argv in (["serve", "--artifact", art], ["export", "--checkpoint",
                                                art, "--out", art]):
        args = cli.build_parser().parse_args([*argv, "--experiment",
                                              "textcls"])
        assert cli._prep(args) is None
    # the face experiment is ported: its eval preprocess serves and exports
    req = str(tmp_path / "req.npz")
    np.savez(req, x=np.zeros((2, 32, 32, 3), np.uint8))
    assert cli.main(["serve", "--artifact", art, "--requests", req,
                     "--task-id", "2", "--experiment", "face",
                     "--device", "cpu"]) == 0
    args = cli.build_parser().parse_args(
        ["export", "--checkpoint", art, "--out", art, "--experiment", "face"])
    assert cli._prep(args) is face_eval_preprocess


def test_entry_points_default_to_the_card(state, images, tmp_path,
                                          monkeypatch):
    """Without a usable card every entry point raises unless the caller
    passes device='cpu'; none falls back to the CPU on its own."""
    from cpg_tpu_torch.utils.checkpoint import save_state

    art = str(tmp_path / "art")
    TaskServer(state, prep, compute_dtype=torch.float32, device="cpu").export(art)
    ck = save_state(state, str(tmp_path / "ck"))
    req = str(tmp_path / "req.npz")
    np.savez(req, x=images[:2])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model_fn, _ = get_model("vgg16_bn_cifar")
    t2 = state.tasks[2]
    calls = [
        lambda: TaskServer(state, prep),
        lambda: TaskServer.load(art, prep),
        lambda: t_inference.predict(state, 2, torch.from_numpy(images)),
        lambda: t_inference.make_predict_fn(state, 2),
        lambda: make_eval_step(model_fn, num_classes=6, mult=MULT,
                               has_piggymask=True, cfg=TrainConfig()),
        lambda: make_train_step(model_fn, num_classes=6, mult=MULT,
                                has_piggymask=True, cfg=TrainConfig()),
        lambda: init_state("vgg16_bn_cifar", torch.Generator(), MULT),
        lambda: cli.main(["serve", "--artifact", art, "--requests", req,
                          "--task-id", "2"]),
        lambda: cli.main(["serve", "--artifact", art, "--http-port", "0"]),
        lambda: TaskServer(state, prep, quantize="int8"),
        lambda: cli.main(["export", "--checkpoint", ck, "--out",
                          str(tmp_path / "a2")]),
        lambda: cli.main(["export", "--checkpoint", ck, "--int8", "--out",
                          str(tmp_path / "a3")]),
        lambda: cli.main(["inference", "--checkpoint", ck, "--task-id", "2"]),
        lambda: cli.main(["stats", "--checkpoint", ck]),
        lambda: cli.main(["check", "--checkpoint", ck]),
        lambda: cli.main(["export-torch", "--ckpt", ck, "--out",
                          str(tmp_path / "x.pth")]),
        lambda: cli.main(["import-torch", "--ckpt", str(tmp_path / "x.pth"),
                          "--out", str(tmp_path / "ck2")]),
        lambda: cli.main(["import-torch", "--ckpt", str(tmp_path / "x.pth"),
                          "--arch", "spherenet20", "--out",
                          str(tmp_path / "ck3")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    step = make_eval_step(model_fn, num_classes=6, mult=MULT,
                          has_piggymask=True, device="cpu",
                          cfg=TrainConfig(compute_dtype=torch.float32))
    logits, _ = step(state.shared, t2.piggymask, t2.private, t2.bn_state,
                     state.ownership, 2, images[:2], np.zeros(2, np.int64))
    assert logits.shape == (2, 6) and logits.device.type == "cpu"
    q8 = TaskServer(state, prep, quantize="int8", device="cpu")
    assert q8.predict(2, images[:2]).shape == (2, 6)
    assert cli.main(["check", "--checkpoint", ck, "--device", "cpu"]) == 0
