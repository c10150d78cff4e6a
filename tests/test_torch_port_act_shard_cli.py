"""`sequence --parallel 1 --parallel-model 2 --shard-activations` on CPU
ranks (the command spawns its two ranks, a subprocess here, as a user runs
it), f32, vit_cifar and `--experiment textcls --text-causal`, against the
same command without `--shard-activations`: the same cycle (widths, task
names, ratios, growths), and final states no further apart than
`chip_smoke.py`'s CLI yardstick allows (`_cli_states_agree`: owners that
differ, weights where they agree, BN statistics; at most
`UPDATE_RATIO` x the widest spread of three one-process orders of the
command, `PAR_CLI_ORDERS`' counterpart for the transformers: the dense
route, flash attention, neither; or within `PAR_CLI_FLOOR`).
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke as cs
from cpg_tpu_torch import cli
from cpg_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["sequence", "--num-tasks", "2", "--synthetic-train-per-class", "8",
          "--synthetic-test-per-class", "4", "--batch-size", "8",
          "--finetune-epochs", "1", "--prune-epochs", "1",
          "--retrain-epochs", "0", "--prune-ratios", "0.5",
          "--allow_acc_diff", "1.0", "--dtype", "float32", "--lr-schedule",
          "constant", "--device", "cpu"]
ARCHS = {"vit_cifar": ["--arch", "vit_cifar", "--network_width_multiplier",
                       "0.25", "--synthetic-train-per-class", "4",
                       "--synthetic-test-per-class", "2"],
         # 512 synthetic sequences a task: 8 steps an epoch
         "textcls": ["--experiment", "textcls", "--text-causal",
                     "--text-seq-len", "16", "--text-vocab", "64",
                     "--batch-size", "64"]}
ORDERS = {"kernels": ["--use-pallas", "--flash-attention"],
          "dense": ["--use-pallas"], "default": []}
MODEL_AXIS = ["--parallel", "1", "--parallel-model", "2"]


def _spawn(argv, ck, env):
    return subprocess.Popen(
        [sys.executable, "-m", "cpg_tpu_torch", *argv, "--checkpoint-dir",
         ck], cwd=os.path.dirname(ck), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _summary(proc):
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, stdout  # rank 0 alone prints the summary
    return json.loads(lines[0])


@pytest.fixture(scope="module", params=list(ARCHS))
def runs(request, tmp_path_factory):
    arch = request.param
    tmp = tmp_path_factory.mktemp(f"act_cli_{arch}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    base = [*COMMON, *ARCHS[arch], *ORDERS["kernels"]]
    procs = {"sharded": _spawn([*base, *MODEL_AXIS, "--shard-activations"],
                               str(tmp / "sharded"), env),
             "whole": _spawn([*base, *MODEL_AXIS], str(tmp / "whole"), env)}
    out = {}
    for order, flags in ORDERS.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main([*COMMON, *ARCHS[arch], *flags,
                             "--checkpoint-dir", str(tmp / order)]) == 0
        out[order] = json.loads(buf.getvalue().strip().splitlines()[-1])
    out.update({k: _summary(p) for k, p in procs.items()})
    states = {}
    for i, t in enumerate(out["kernels"]["tasks"]):
        name = f"task{i + 1:02d}_{t['name']}"
        states[name] = {k: load_state(str(tmp / k / name), device="cpu")
                        for k in out}
    return arch, out, states


def test_shard_activations_runs_the_same_cycle(runs):
    arch, out, _ = runs
    want = cs._cycle_of(out["whole"])
    assert cs._cycle_of(out["sharded"]) == want, arch
    assert all(cs._cycle_of(out[o]) == want for o in ORDERS), arch


def test_shard_activations_state_within_the_one_process_orders(runs):
    """The final states of the split-token run and the run without the
    flag, each task's, at most twice as far apart as the farthest two of
    the one-process orders (or within the floors)."""
    arch, _, states = runs
    orders = list(ORDERS)
    yard, apart = [], {}
    for name, st in states.items():
        for i, a in enumerate(orders):
            for b in orders[i + 1:]:
                yard.append(cs._cli_states_agree(torch, st[a], st[b]))
        apart[name] = cs._cli_states_agree(torch, st["sharded"], st["whole"])
        assert not st["sharded"].shards
    bound = {m: max(floor, cs.UPDATE_RATIO * max(y[m] for y in yard))
             for m, floor in cs.PAR_CLI_FLOOR.items()}
    for name, d in apart.items():
        for m in bound:
            assert d[m] <= bound[m], (arch, name, d, bound, yard)
