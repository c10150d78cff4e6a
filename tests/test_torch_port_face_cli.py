"""`sequence --experiment face` through both packages' command lines, on the
CPU, and the port's checkpoint tools on its result.

Both CLIs run the face sequence from one seed at width 0.125 (CASIA under
the A-Softmax loss, then the expression task with a linear head, which
misses the unreachable goal 1.01 and grows once to 0.1875), f32, one
epoch a phase, one prune ratio. The port runs its kernel flags
(`--use-pallas-conv --use-pallas`: the plain versions on the CPU) and
takes `cpg_tpu`'s flip draws through the `draws` seam of `run_sequence`.
Both start from the same init trees: `cpg_tpu`'s `fw.init` is replaced by
the port's (`port_init`: the same keys and shapes, see
tests/test_torch_port_face.py, drawn from a torch generator at the seed of
`cpg_tpu`'s key; its op-by-op JAX init would take 40 s of compiles here),
which the port takes as it is. The JSON summaries must be equal, the LFW
verification block (`lfw_verification`: synthetic pairs here) included.

Then the port's final checkpoint: `check` clean, task 1's outputs across
task 2's compaction and its growth, `export` (f32 and calibrated int8),
`serve` and `inference` with the face preprocess.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu import cli as j_cli
from cpg_tpu.models import framework as j_fw
from cpg_tpu_torch import cli
from cpg_tpu_torch.core.invariants import check_state
from cpg_tpu_torch.data import augment as t_aug
from cpg_tpu_torch.inference import predict
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.models import get_model as t_get_model
from cpg_tpu_torch.train import sequence as t_seq
from cpg_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)
FLAGS = ["--num-tasks", "2", "--network_width_multiplier", "0.125",
         "--growth-step", "0.0625",
         "--max_allowed_network_width_multiplier", "0.1875",
         "--finetune-epochs", "1", "--prune-epochs", "1",
         "--retrain-epochs", "1", "--prune-ratios", "0.5",
         "--batch-size", "128", "--lr", "0.002", "--dtype", "float32"]


def port_init(key, model_fn, sample_x, compute_dtype=None, **kw):
    """In place of `cpg_tpu`'s fw.init: the port's init of SphereNet-20
    from a generator seeded as `key` (`PRNGKey(seed)`), as jnp trees."""
    seed = int(np.asarray(key).ravel()[-1])
    out = t_fw.init(torch.Generator().manual_seed(seed),
                    t_get_model("spherenet20")[0],
                    torch.zeros(tuple(sample_x.shape)), **kw)
    return tuple({k: jnp.asarray(v.numpy()) for k, v in t.items()}
                 for t in out)


def jax_draws(seed):
    """The draws seam: the flips `cpg_tpu`'s Manager draws for the face
    augment at each step (its key split once a step)."""
    key = [jax.random.PRNGKey(seed)]

    def draw(n):
        key[0], sub = jax.random.split(key[0])
        return np.array(jax.random.bernoulli(sub, 0.5, (n, 1, 1, 1))
                        ).reshape(n)

    return draw


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _quiet(main, argv):
    """(exit code, the last line of stdout as JSON) of a CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' runs; the port's keeps its `.pick` checkpoints."""
    tmp = tmp_path_factory.mktemp("face")
    goals = str(tmp / "goals.json")
    with open(goals, "w") as f:
        json.dump({"expressions": 1.01}, f)
    argv = ["sequence", "--experiment", "face", *FLAGS, "--goals-file", goals]
    ck = str(tmp / "ck")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fw, "init", port_init)
        mp.delenv("CPG_DATA_DIR", raising=False)
        orig = t_seq.run_sequence
        mp.setattr(t_seq, "run_sequence", lambda *a, **k: orig(
            *a, **k, draws=jax_draws))
        mp.setattr(t_seq, "remove_after_save", lambda path: None)
        want = _quiet(j_cli.main, argv)
        got = _quiet(cli.main, [*argv, "--device", "cpu", "--use-pallas-conv",
                                "--use-pallas", "--checkpoint-dir", ck])
    return {"tmp": tmp, "ck": ck, "jax": want, "port": got}


def test_face_sequence_matches_jax(runs):
    """The two CLIs' JSON summaries are equal: per-task accuracy, chosen
    ratio and growth, the final width, and the LFW verification block."""
    (rc_j, want), (rc_t, got) = runs["jax"], runs["port"]
    assert rc_j == rc_t == 0
    assert set(want) == set(got) == {"avg_top1", "final_width_mult", "tasks",
                                     "lfw_verification"}
    assert got == want
    assert [t["grew"] for t in got["tasks"]] == [0, 1]
    assert got["final_width_mult"] == 0.1875
    lfw = got["lfw_verification"]
    assert lfw["source"] == "synthetic" and lfw["n_pairs"] == 200
    assert np.isfinite(lfw["acc"]) and np.isfinite(lfw["std"])


def test_face_checkpoint_tools(runs, capsys):
    """The port's final face checkpoint: `check` clean; task 1's embedding
    and AngleLinear outputs bit-equal across task 2's compaction (its
    `.pick` checkpoint against the final one) and within rtol 1e-5 across
    the growth (the wider convolutions sum exact zeros too, in another
    order); `export` f32 and calibrated int8, `serve` on both and
    `inference` of both tasks, with the face preprocess."""
    ck, tmp = runs["ck"], runs["tmp"]
    final = os.path.join(ck, "task02_expressions")
    state = load_state(final, device="cpu")
    assert check_state(state, strict=False) == []
    assert cli.main(["check", "--checkpoint", final, "--device", "cpu"]) == 0
    capsys.readouterr()
    x = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (5, 112, 96, 3)).astype(np.uint8))

    def task1(st, mkw):  # task 1's embedding, or its AngleLinear pair
        out = predict(st, 1, x, t_aug.face_eval_preprocess, device="cpu",
                      model_kwargs=mkw)
        return out if isinstance(out, tuple) else (out,)

    before = load_state(os.path.join(ck, "task01_casia"), device="cpu")
    picked = load_state(final + ".pick", device="cpu")
    assert (before.width_mult, picked.width_mult) == (0.125, 0.1875)
    for mkw in ({"head_type": "none"}, None):
        for u, v, w in zip(task1(before, mkw), task1(picked, mkw),
                           task1(state, mkw)):
            assert torch.equal(v, w), mkw  # across task 2's compaction
            n = u.shape[-1]  # across the growth: 32 more embedding zeros
            np.testing.assert_allclose(w[..., :n].numpy(), u.numpy(),
                                       rtol=1e-5, atol=1e-6)
            assert not w[..., n:].any()
    req, cal = str(tmp / "req.npz"), str(tmp / "cal.npz")
    np.savez(req, x=x.numpy())
    np.savez(cal, x=x.numpy())
    for q, flags in (("f32", ["--device", "cpu"]),
                     ("int8", ["--int8", "--calibrate", cal, "--device",
                               "cpu"])):
        art = str(tmp / f"art_{q}")
        rc, rep = _run(cli.main, ["export", "--checkpoint", final, "--out",
                                  art, "--experiment", "face", *flags], capsys)
        assert rc == 0 and rep["calibrated_tasks"] == (2 if q == "int8"
                                                       else 0)
        for tid in (1, 2):
            rc, rep = _run(cli.main, ["serve", "--artifact", art,
                                      "--requests", req, "--task-id",
                                      str(tid), "--experiment", "face",
                                      "--device", "cpu"], capsys)
            assert rc == 0 and rep["n"] == 5
    for tid, n in ((1, 39), (2, 26)):
        rc, rep = _run(cli.main, ["inference", "--checkpoint", final,
                                  "--task-id", str(tid), "--experiment",
                                  "face", "--num-tasks", "2", "--device",
                                  "cpu"], capsys)
        assert rc == 0 and rep["n"] == n and 0.0 <= rep["top1"] <= 1.0
