"""The port's activation sharding (parallel/mesh.py `act_sharder`, the
models' "tokens" and "experts" seams) against `cpg_tpu`, on the CPU.

Two gloo worlds of CPU ranks are spawned once for the module
(tests/torch_dist_worker.py, a file store under tmp_path): one of 4 ranks
and one of 2 as (data=1, model=2); the JAX references are computed here
meanwhile. Every state comes from `cpg_tpu`'s init and is carried into the
port as numpy. The checks, `tests/test_moe_pp_sp_ep.py`'s and
`tests/test_parallel_tp.py`'s counterparts:

  * split-token forwards (tiny_vit and tiny_textcls as (2,2), the tokens
    split; vit_moe_cifar as (1,4) with its experts split, kernels and
    dispatch alike): logits within rtol 1e-4 / atol 1e-5 of `cpg_tpu`'s
    unsharded `fw.apply` and within 2e-5 of the port's one-process
    forward; every "tokens" seam past the first hands on T/M rows, and a
    stream whose T does not divide stays whole;
  * split-token f32 train steps as (1,2) (tiny_vit and tiny_textcls with
    replicated kernels; tiny_moe with its kernels split too) against
    `cpg_tpu`'s one-device step and the port's one-process step at
    `tests/test_parallel_tp.py`'s tolerances (loss rtol 1e-5, updates
    rtol 3e-4 / atol 3e-6), both ranks equal;
  * the negative control: `gather_tokens`' backward made
    `gather_from_model_group`'s (no sum over the ranks of the partial
    input gradients of a split product) must miss.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.core.pruner import one_shot_prune as j_one_shot_prune
from cpg_tpu.models import framework as j_fw
from cpg_tpu.models.moe import vit_moe_cifar as j_vit_moe_cifar
from cpg_tpu.train.sequence import init_state as j_init_state
from cpg_tpu.train.sequence import start_task as j_start_task
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu_torch import cli

from .helpers import (normalize01, synthetic_task, tiny_moe, tiny_textcls,
                      tiny_vit)
from .test_torch_port_parallel import _jax_steps, _plain

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_KW = dict(depth=2, dim=32, heads=2, patch=8, n_experts=4)
NC = 4
JAX_FNS = {"tiny_vit": tiny_vit, "tiny_textcls": tiny_textcls,
           "tiny_moe": tiny_moe}


def _trees(model_fn, x, **kw):
    return tuple({k: np.asarray(v) for k, v in t.items()}
                 for t in j_fw.init(jax.random.PRNGKey(0), model_fn,
                                    jnp.asarray(x), num_classes=NC, **kw))


def _forward(model_fn, trees, x, **kw):
    return np.asarray(j_fw.apply(model_fn, *trees, jnp.asarray(x),
                                 train=False, num_classes=NC, **kw)[0])


def _forward_cases():
    """{name: (worker kwargs, cpg_tpu's unsharded logits)}."""
    images = np.random.RandomState(1).rand(8, 16, 16, 3).astype(np.float32)
    toks = np.random.RandomState(2).randint(0, 64, (8, 16)).astype(np.int32)
    odd = np.random.RandomState(3).randint(0, 64, (8, 15)).astype(np.int32)
    moe_x = np.random.RandomState(0).rand(8, 32, 32, 3).astype(np.float32)
    out = {}
    for name, fn, arch, x, n_model, extra in (
            ("vit", tiny_vit, "tiny_vit", images, 2, {}),
            ("text", tiny_textcls, "tiny_textcls", toks, 2, {}),
            ("text_odd", tiny_textcls, "tiny_textcls", odd, 2, {}),
            ("moe", j_vit_moe_cifar, "vit_moe_cifar", moe_x, 4,
             dict(kw=MOE_KW, experts=True, model_sharded=True))):
        kw = extra.get("kw", {})
        trees = _trees(fn, x, **kw)
        out[name] = (dict(arch=arch, trees=trees, x=x, n_model=n_model,
                          num_classes=NC, **extra),
                     _forward(fn, trees, x, **kw))
    return out


def _two_task_state(arch):
    """Task 1 half pruned, task 2 fresh (tests/test_parallel_tp.py's
    state), of a transformer arch."""
    st = j_init_state(arch, jax.random.PRNGKey(0))
    j_start_task(st, "a", 4, jax.random.PRNGKey(1))
    st.shared, st.ownership = j_one_shot_prune(st.shared, st.ownership, 1,
                                               jnp.float32(0.5))
    j_start_task(st, "b", 3, jax.random.PRNGKey(2))
    return _plain(st)


def _step_cases():
    data = synthetic_task(0)
    images = [(data["train_x"][i:i + 16], data["train_y"][i:i + 16] % 3,
               None, it) for it, i in enumerate((0, 16))]
    rng = np.random.RandomState(9)
    tokens = [(rng.randint(0, 64, (16, 16)).astype(np.int32),
               rng.randint(0, 3, 16), None, it) for it in range(2)]
    return {"vit": ("tiny_vit", images, {}),
            "text": ("tiny_textcls", tokens, {}),
            "moe": ("tiny_moe", images, dict(tp=True, control_gather=True))}


def _jobs():
    forwards = _forward_cases()
    job4 = {f"fwd_{name}": ("sp_forward", kw)
            for name, (kw, _) in forwards.items()}
    states, job2 = {}, {}
    for name, (arch, batches, extra) in _step_cases().items():
        states[name] = _two_task_state(arch)
        job2[f"step_{name}"] = ("step", dict(
            state=states[name], tid=2, batches=batches, single=True,
            lr=0.05, act=True, **extra))
    refs = dict(forwards={k: v[1] for k, v in forwards.items()},
                states=states, steps=_step_cases())
    return {(4, 2): job4, (2, 2): job2}, refs


def _references(refs):
    out = {}
    for name, (arch, batches, _) in refs["steps"].items():
        aug = (lambda v, k: v) if arch == "tiny_textcls" else (
            lambda v, k: normalize01(v))
        out[name] = _jax_steps(
            refs["states"][name],
            [(x, y, jax.random.PRNGKey(0), it) for x, y, _, it in batches],
            JConfig(lr=0.05, compute_dtype=jnp.float32), JAX_FNS[arch],
            tid=2, augment=aug)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("act_shard_worlds")
    jobs, refs = _jobs()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = {}
    for (world, n_model), job in jobs.items():
        d = tmp / f"w{world}"
        d.mkdir()
        with open(d / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
             str(r), str(world), str(d / "store"), str(d / "job.pkl"), str(d),
             str(n_model)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    ref = _references(refs)
    out = {}
    for world, ps in procs.items():
        logs = [p.communicate(timeout=600)[0] for p in ps]
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"rank {r}/{world}:\n{logs[r][-4000:]}"
        out[world] = []
        for r in range(world):
            with open(tmp / f"w{world}" / f"rank{r}.pkl", "rb") as f:
                out[world].append(pickle.load(f))
    return out, ref, refs


def _whole_logits(ranks, name):
    """The forward's logits of the whole batch from the ranks' rows (the
    ranks of one model group hold the same rows, bit for bit)."""
    got = {}
    for r in ranks:
        res = r[f"fwd_{name}"]
        sl = res["rows"]
        if sl.start in got:
            np.testing.assert_array_equal(got[sl.start], res["logits"])
        got[sl.start] = res["logits"]
    return np.concatenate([got[k] for k in sorted(got)])


def _forward_matches(worlds, name):
    """The ranks' logits against `cpg_tpu`'s unsharded forward and the
    port's one-process forward."""
    out, _, refs = worlds
    got = _whole_logits(out[4], name)
    np.testing.assert_allclose(got, refs["forwards"][name], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got, out[4][0][f"fwd_{name}"]["one"],
                               rtol=2e-5, atol=2e-5)


def test_sp_token_sharding_matches_replicated(worlds):
    """tiny_vit's tokens split over the model axis of (2,2), kernels
    whole."""
    _forward_matches(worlds, "vit")


def test_sp_text_family_matches_replicated(worlds):
    """tiny_textcls (causal, integer tokens) under the same seams."""
    _forward_matches(worlds, "text")


def test_ep_sp_sharded_matches_replicated(worlds):
    """vit_moe_cifar as (1,4): its kernels split (the experts one a rank),
    the tokens and the dispatched experts split at the seams."""
    _forward_matches(worlds, "moe")
    assert worlds[0][4][0]["fwd_moe"]["n_split"] > 0


@pytest.mark.parametrize("name,t,m,n_seams", [("vit", 4, 2, 3),
                                              ("text", 16, 2, 4),
                                              ("moe", 16, 4, 3)])
def test_block_boundaries_hold_this_ranks_rows(worlds, name, t, m, n_seams):
    """The "tokens" seams (the entry and the two block boundaries; textcls
    also its ids) hand on T/M rows on every rank."""
    out, _, _ = worlds
    for r in out[4]:
        seams = r[f"fwd_{name}"]["seams"]
        tokens = [s for s in seams if s[0] == "tokens"]
        assert len(tokens) == n_seams, seams
        assert tokens[0][1][1] == t
        assert all(s[2][1] == t // m for s in tokens), seams
        if name == "moe":
            assert r["fwd_moe"]["model_rank"] == out[4].index(r) % 4


def test_tokens_that_do_not_divide_stay_whole(worlds):
    """T = 15 over two model ranks: every seam passes the whole stream
    (`cpg_tpu`'s skip rule), and each rank computes the whole forward."""
    _forward_matches(worlds, "text_odd")
    out, _, _ = worlds
    for r in out[4]:
        seams = r["fwd_text_odd"]["seams"]
        assert seams and all(s[1] == s[2] and s[2][1] == 15 for s in seams)


@pytest.mark.parametrize("name", ["vit", "text", "moe"])
def test_sp_step_matches_single_device(worlds, name):
    """The split-token f32 train step as (1,2) (tiny_moe's kernels split
    too) against `cpg_tpu`'s one-device step and the port's one-process
    step, two steps; both ranks end with the same whole trees."""
    from .test_torch_port_parallel_tp import _assert_step_matches

    out, ref, _ = worlds
    res = out[2][0][f"step_{name}"]
    groups = ("shared", "piggymask", "private")
    _assert_step_matches(res["dp"], ref[name], f"{name} against cpg_tpu",
                         groups=groups)
    _assert_step_matches(res["dp"], res["single"], f"{name} against one "
                         "process", groups=groups)
    if name == "moe":
        assert res["dp"]["split"]["blocks/1/moe/experts/fc1/kernel"] == (0, 4)
    for k, v in out[2][1][f"step_{name}"]["dp"]["shared"].items():
        np.testing.assert_array_equal(v, res["dp"]["shared"][k], err_msg=k)


def test_sp_step_needs_the_summed_gather_gradient(worlds):
    """The negative control: `gather_tokens`' backward without the sum over
    the ranks (`gather_from_model_group`'s) must miss `cpg_tpu`'s step."""
    from .test_torch_port_parallel_tp import _assert_step_matches

    out, ref, _ = worlds
    with pytest.raises(AssertionError):
        _assert_step_matches(out[2][0]["step_moe"]["control_gather"],
                             ref["moe"], "moe, control",
                             groups=("shared", "piggymask", "private"))


def test_shard_activations_needs_no_parallel():
    """Without `--parallel` the flag does nothing, as in `cpg_tpu`: the
    refusals pass it, and the flag is no longer among the unported."""
    args = cli._parse(["sequence", "--device", "cpu", "--shard-activations"])
    cli._refuse_unported(args)
    assert args.shard_activations
    assert "shard_activations" not in {a for a, _, _ in cli.UNPORTED}
