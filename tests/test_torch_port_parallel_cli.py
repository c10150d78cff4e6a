"""`sequence --parallel N` and the meshed `TaskServer`, on the CPU.

The CLI's data-parallel cycle: `sequence --parallel 2 --device cpu` spawns
two gloo ranks itself (a subprocess here, as a user runs it) and is held
against the one-process command with the same flags: the same summary, and
final states within f32 summation order (entries at the prune cutoff may
flip owner: the cutoff orders weights by magnitude). `--parallel 1` (a
world of one rank in this process) must give the one-process run bit for
bit. The server over a mesh of four CPU "devices" (one device repeated,
the seam that lets a bucket split run on one device) against the unmeshed
server: the bucket floor raised to the mesh size, f32 answers within
rtol/atol 1e-5 (each shard is a quarter of the bucket), calibrated int8
bit for bit, through `load` too.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpg_tpu_torch import cli
from cpg_tpu_torch.core.pruner import one_shot_prune
from cpg_tpu_torch.data.augment import cifar_eval_preprocess as prep
from cpg_tpu_torch.parallel.mesh import make_mesh
from cpg_tpu_torch.serve import TaskServer
from cpg_tpu_torch.train.sequence import init_state, start_task
from cpg_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["sequence", "--num-tasks", "2", "--network_width_multiplier", "0.125",
        "--synthetic-train-per-class", "8", "--synthetic-test-per-class", "4",
        "--batch-size", "8", "--finetune-epochs", "1", "--prune-epochs", "1",
        "--retrain-epochs", "0", "--prune-ratios", "0.5", "--allow_acc_diff",
        "1.0", "--dtype", "float32", "--lr-schedule", "constant",
        "--use-pallas-conv", "--fused-chain", "--device", "cpu"]
FINAL = "task02_fish"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    spawned = subprocess.Popen(
        [sys.executable, "-m", "cpg_tpu_torch", *ARGV, "--parallel", "2",
         "--checkpoint-dir", str(tmp / "p2")], cwd=str(tmp), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, extra in (("p0", []), ("p1", ["--parallel", "1"])):
        cap = tmp / f"{name}.json"
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main([*ARGV, *extra, "--checkpoint-dir",
                             str(tmp / name)]) == 0
        cap.write_text(buf.getvalue())
        out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    stdout, stderr = spawned.communicate(timeout=600)
    assert spawned.returncode == 0, stderr[-4000:]
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, stdout  # rank 0 alone prints the summary
    out["p2"] = json.loads(lines[0])
    assert not torch.distributed.is_initialized()  # --parallel 1 left it
    states = {k: load_state(str(tmp / k / FINAL), device="cpu")
              for k in ("p0", "p1", "p2")}
    return out, states


def test_parallel_cli_summary_matches_the_one_process_run(runs):
    out, _ = runs
    assert out["p2"] == out["p1"] == out["p0"]
    assert [t["ratio"] for t in out["p0"]["tasks"]] == [0.5, 0.5]


def test_parallel_cli_state_matches_the_one_process_run(runs):
    """Two ranks against one process: ownership equal but for at most
    0.1% of a layer's entries (those at the prune cutoff), the weights
    where it agrees and the BN running statistics within 1e-5 of the
    tensor's largest magnitude."""
    _, st = runs
    a, b = st["p2"], st["p0"]
    for k, w in b.shared.items():
        same = a.ownership[k] == b.ownership[k]
        assert same.float().mean() >= 0.999, k
        err = (a.shared[k] - w).abs()[same].max()
        assert err <= 1e-5 * w.abs().max(), (k, float(err))
    for tid, t in b.tasks.items():
        for k, v in t.bn_state.items():
            err = (a.tasks[tid].bn_state[k] - v).abs().max()
            assert err <= 1e-5 * max(1.0, float(v.abs().max())), (tid, k)


def test_parallel_1_is_the_one_process_run_bit_for_bit(runs):
    _, st = runs
    a, b = st["p1"], st["p0"]
    for k in b.shared:
        assert torch.equal(a.shared[k], b.shared[k]), k
        assert torch.equal(a.ownership[k], b.ownership[k]), k
    for tid, t in b.tasks.items():
        for tree in ("private", "bn_state", "piggymask"):
            for k, v in (getattr(t, tree) or {}).items():
                assert torch.equal(getattr(a.tasks[tid], tree)[k], v), k


def test_parallel_cli_refusals():
    with pytest.raises(SystemExit, match="--parallel-model: model-axis"):
        cli.main([*ARGV, "--parallel-model", "2"])  # without --parallel
    with pytest.raises(SystemExit, match="baseline"):
        cli.main(["baseline", "--device", "cpu", "--parallel", "2"])


# ------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def state():
    g = torch.Generator().manual_seed(0)
    s = init_state("vgg16_bn_cifar", g, 0.125, device="cpu")
    start_task(s, "t1", 4, g)
    s.shared, s.ownership = one_shot_prune(s.shared, s.ownership, 1, 0.5)
    start_task(s, "t2", 6, g)
    for k, pm in s.tasks[2].piggymask.items():
        s.tasks[2].piggymask[k] = pm + torch.randn(pm.shape, generator=g) * 0.01
    for t in s.tasks.values():  # heads at unit scale: logits well above atol
        t.private["classifier/kernel"] = torch.randn(
            t.private["classifier/kernel"].shape, generator=g)
    return s


MESH4 = [torch.device("cpu")] * 4


def _requests():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
            for n in (1, 5, 11)]


def test_meshed_server_matches_the_unmeshed_one(state, tmp_path):
    mesh = make_mesh(devices=MESH4)
    kw = dict(compute_dtype=torch.float32, min_bucket=1, device="cpu")
    ref = TaskServer(state, prep, **kw)
    srv = TaskServer(state, prep, mesh=mesh, **kw)
    assert srv.min_bucket == 4 and ref.min_bucket == 1
    art = str(tmp_path / "art")
    srv.export(art)
    loaded = TaskServer.load(art, prep, min_bucket=1, mesh=mesh)
    assert loaded.min_bucket == 4
    for x in _requests():
        for tid in (1, 2):
            want = ref.predict(tid, x)
            for got in (srv.predict(tid, x), loaded.predict(tid, x)):
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    reqs = [(tid, x[0]) for x in _requests() for tid in (2, 1)]
    for got, want in zip(srv.predict_mixed(reqs), ref.predict_mixed(reqs)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for s in (srv, loaded):
        s.close()
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        TaskServer(state, prep, mesh=make_mesh(devices=MESH4[:3]),
                   device="cpu")


def test_meshed_calibrated_int8_server_is_bit_equal(state):
    """Static activation scales: each shard quantizes as the whole bucket
    does, so the answers are the unmeshed server's bit for bit."""
    calib = _requests()[2]
    ref = TaskServer(state, prep, quantize="int8", device="cpu")
    srv = TaskServer(state, prep, quantize="int8",
                     mesh=make_mesh(devices=MESH4))
    ref.calibrate(calib)
    srv.calibrate(calib)
    for x in _requests():
        for tid in (1, 2):
            np.testing.assert_array_equal(srv.predict(tid, x),
                                          ref.predict(tid, x))
    srv.close()
