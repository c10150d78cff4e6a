"""The port's pipeline (parallel/pipeline.py: GPipe over stage ranks)
against `cpg_tpu`, on the CPU.

Two gloo worlds of CPU ranks are spawned once for the module
(tests/torch_dist_worker.py, a file store under tmp_path), one of 4 ranks
and one of 2; the JAX references are computed here meanwhile, from the
same `cpg_tpu` init trees carried into the port as numpy. The checks,
`tests/test_moe_pp_sp_ep.py`'s and `tests/test_pipeline_train.py`'s
counterparts:

  * four stages over four real ViT blocks (n_micro 4, and 2 with a
    bubble) against `cpg_tpu`'s blocks run in order: the output (1e-5) and
    the gradients of every stacked parameter and of the tokens (rtol
    2e-4, atol 1e-6), the same on every stage; bf16 tokens through f32
    blocks (the carries in the block output's dtype);
  * the negative control: `psum_replicated`'s backward made
    `all_reduce_sum`'s (every gradient S times too large) must miss;
  * too few ranks and shapes that do not divide are refused;
  * `cpg_tpu`'s full train step (gating, piggymask Adam) against the
    port's through `TrainConfig.pipeliner` over four stages, 3 steps:
    updates rtol 5e-4 / atol 1e-5, losses rtol 1e-4, every stage
    bit-equal;
  * a `Manager` a stage over a 2-stage pipeline learns (acc > 0.7), every
    stage ending bit-equal, and only the pipe group's rank 0 writes.
"""

import functools
import json
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
from cpg_tpu.models import REGISTRY as J_REGISTRY
from cpg_tpu.models import framework as j_fw
from cpg_tpu.models.vit import vit_cifar as j_vit_cifar
from cpg_tpu.parallel.pipeline import _default_block_fn as j_block_fn
from cpg_tpu.parallel.pipeline import stack_block_params as j_stack
from cpg_tpu.train.sequence import init_state as j_init_state
from cpg_tpu.train.sequence import start_task as j_start_task
from cpg_tpu.train.step import TrainConfig as JConfig
from cpg_tpu_torch.parallel import pipeline as t_pipeline

from .helpers import norm_augment, synthetic_task
from .test_torch_port_parallel import _jax_steps, _plain

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BKW = dict(heads_n=2, head_dim=16, hidden=128)


def tiny_vit4(ctx, x, num_classes, mult=1.0):
    """tests/test_pipeline_train.py's 4-block ViT on 16x16 inputs."""
    return j_vit_cifar(ctx, x, num_classes, mult, depth=4, dim=32, heads=2,
                       patch=8)


J_REGISTRY.setdefault("tiny_vit4", (tiny_vit4, (16, 16, 3)))


def _stacked_and_tokens():
    """`cpg_tpu`'s four blocks stacked, and the tokens (the JAX tests')."""
    x = jnp.asarray(np.random.RandomState(0).rand(8, 16, 16, 3), jnp.float32)
    shared, private, _ = j_fw.init(jax.random.PRNGKey(0), tiny_vit4, x,
                                   num_classes=4)
    stacked, rest = j_stack({**shared, **private}, 4)
    assert "patch/proj/kernel" in rest and "attn/q/kernel" in stacked
    tokens = np.random.RandomState(1).randn(8, 4, 32).astype(np.float32)
    return {k: np.asarray(v) for k, v in stacked.items()}, tokens


def _sequential(stacked, tokens, dtype=jnp.float32):
    y = jnp.asarray(tokens, dtype)
    for i in range(4):
        y = j_block_fn({k: jnp.asarray(v[i]) for k, v in stacked.items()}, y,
                       jnp.float32, BKW)
    return y


def _two_task_state():
    """tests/test_pipeline_train.py's state: task 1 half pruned, task 2."""
    st = j_init_state("tiny_vit4", jax.random.PRNGKey(0))
    j_start_task(st, "a", 4, jax.random.PRNGKey(1))
    st.shared, st.ownership = j_one_shot_prune(st.shared, st.ownership, 1,
                                               jnp.float32(0.5))
    j_start_task(st, "b", 4, jax.random.PRNGKey(2))
    return _plain(st)


def _step_batches():
    x = (np.random.RandomState(2).rand(16, 16, 16, 3) * 255).astype(np.uint8)
    y = np.random.RandomState(3).randint(0, 4, 16).astype(np.int32)
    return [(x, y)] * 3


def _manager_state():
    st = j_init_state("tiny_vit", jax.random.PRNGKey(0))
    j_start_task(st, "a", 4, jax.random.PRNGKey(1))
    return _plain(st)


def _jobs(tmp):
    stacked, tokens = _stacked_and_tokens()
    state = _two_task_state()
    job4 = {
        "pipe": ("pipeline", dict(stacked=stacked, tokens=tokens, bkw=BKW,
                                  n_stages=4)),
        "step": ("pipeline_step", dict(state=state, batches=_step_batches(),
                                       n_stages=4, n_micro=4, depth=4)),
    }
    job2 = {"manager": ("pipeline_manager", dict(
        state=_manager_state(), data=synthetic_task(0), n_stages=2,
        n_micro=4, depth=2, epochs=8, jsonl=str(tmp / "phases.jsonl")))}
    return {(4, 1): job4, (2, 1): job2}, dict(stacked=stacked, tokens=tokens,
                                              state=state)


def _references(r):
    stacked, tokens = r["stacked"], r["tokens"]
    seq = _sequential(stacked, tokens)
    grads = jax.grad(
        lambda s, t: jnp.mean(_sequential(s, t) ** 2), argnums=(0, 1))(
            {k: jnp.asarray(v) for k, v in stacked.items()},
            jnp.asarray(tokens))
    step = _jax_steps(
        r["state"], [(x, y, jax.random.PRNGKey(4), it)
                     for it, (x, y) in enumerate(_step_batches())],
        JConfig(lr=0.05, lr_mask=1e-3, compute_dtype=jnp.float32), tiny_vit4,
        tid=2, augment=norm_augment)
    return dict(seq=np.asarray(seq),
                grads=[np.asarray(grads[0][k]) for k in stacked]
                + [np.asarray(grads[1])],
                bf16=np.asarray(_sequential(stacked, tokens, jnp.bfloat16),
                                np.float32), step=step)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_worlds")
    jobs, refs = _jobs(tmp)
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
    return out, ref, tmp


def _close_grads(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6,
                                   err_msg=f"{what}, leaf {i}")


@pytest.mark.parametrize("n_micro", [4, 2])
def test_pipeline_matches_sequential(worlds, n_micro):
    """Four stages over four ViT blocks, a full schedule and a bubbled one
    (n_micro 2): `cpg_tpu`'s blocks run in order, on every stage."""
    out, ref, _ = worlds
    for r, res in enumerate(out[4]):
        assert res["pipe"]["stage"] == r
        assert res["pipe"]["mesh"] == dict(axes=("pipe",),
                                           shape={"pipe": 4})
        np.testing.assert_allclose(res["pipe"][n_micro][0], ref["seq"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_micro", [4, 2])
def test_pipeline_grad_matches_sequential(worlds, n_micro):
    """The gradients of every stacked parameter and of the tokens through
    the pipeline: `cpg_tpu`'s sequential ones on every stage (the dead
    ticks add exactly nothing)."""
    out, ref, _ = worlds
    for r, res in enumerate(out[4]):
        _close_grads(res["pipe"][n_micro][1], ref["grads"],
                     f"stage {r}, n_micro {n_micro}")


def test_pipeline_needs_the_identity_backward_of_its_sum(worlds):
    """The negative control: the final sum with `all_reduce_sum`'s
    backward (the gradient summed over the stages again) makes every
    gradient 4 times too large."""
    out, ref, _ = worlds
    got = out[4][0]["pipe"]["control"][1]
    with pytest.raises(AssertionError):
        _close_grads(got, ref["grads"], "control")
    np.testing.assert_allclose(got[-1], 4 * ref["grads"][-1], rtol=2e-4,
                               atol=4e-6)


def test_pipeline_bf16_tokens(worlds):
    """bf16 tokens through f32 blocks: the output takes the block output's
    dtype (f32), at bf16 noise from `cpg_tpu`'s sequential bf16 run."""
    out, ref, _ = worlds
    dtype, got = out[4][0]["pipe"]["bf16"]
    assert dtype == "torch.float32"
    np.testing.assert_allclose(got, ref["bf16"], rtol=0.05, atol=0.05)


def test_pipeline_mesh_rejects_too_few_devices(worlds):
    out, _, _ = worlds
    assert "5 ranks" in out[4][0]["pipe"]["refused"]["mesh"]
    with pytest.raises(ValueError, match="devices"):
        t_pipeline.make_pipeline_mesh(2, devices=[torch.device("cpu")])
    one = t_pipeline.make_pipeline_mesh(1, devices=[torch.device("cpu")])
    assert one.shape == {"pipe": 1} and one.group is None


def test_pipeline_rejects_bad_shapes(worlds):
    """depth 3 over 2 stages; batch 4 in 3 microbatches."""
    out, _, _ = worlds
    for r in out[4]:
        refused = r["pipe"]["refused"]
        assert "depth 3 not divisible by 2" in refused["depth"]
        assert "batch 4 not divisible by n_micro 3" in refused["batch"]


def test_pipeline_full_train_step_parity(worlds):
    """`cpg_tpu`'s train step (gating, decay, piggymask Adam) on the
    inline blocks against the port's through `TrainConfig.pipeliner` over
    four stages: task 2 over a half-pruned task 1, 3 steps; every stage
    ends bit-equal."""
    out, ref, _ = worlds
    want, got = ref["step"], out[4][0]["step"]
    for group in ("shared", "piggymask", "private"):
        for k, v in want[group].items():
            np.testing.assert_allclose(got[group][k], np.asarray(v),
                                       rtol=5e-4, atol=1e-5,
                                       err_msg=f"{group}/{k}")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for r in out[4][1:]:
        for group in ("shared", "piggymask", "private"):
            for k, v in got[group].items():
                np.testing.assert_array_equal(r["step"][group][k], v, k)


def test_pipeline_reachable_from_manager(worlds):
    """`Manager` a stage process over a 2-stage pipeline (tiny_vit, depth
    2) learns; the stages end bit-equal and one record is written."""
    out, _, tmp = worlds
    res = [r["manager"] for r in out[2]]
    assert res[0]["acc"] > 0.7, res[0]["acc"]
    assert res[1]["acc"] == res[0]["acc"] and res[1]["steps"] == 64
    for k, v in res[0]["shared"].items():
        np.testing.assert_array_equal(res[1]["shared"][k], v, k)
    with open(tmp / "phases.jsonl") as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert len(lines) == 1 and lines[0]["acc"] == res[0]["acc"]


def test_pipeline_requires_effective_params():
    """vit_cifar's pipeline branch refuses raw-weight Masking, as
    `cpg_tpu`'s; on effective params the hook runs in place of the blocks
    with the blocks' kwargs."""
    from cpg_tpu_torch.models import framework as fw
    from cpg_tpu_torch.models.vit import vit_cifar

    x = torch.zeros(2, 16, 16, 3)
    fn = functools.partial(vit_cifar, depth=2, dim=32, heads=2, patch=8)
    sh, pr, bn = fw.init(torch.Generator().manual_seed(0), fn, x,
                         num_classes=4)
    own = {k: torch.ones_like(v, dtype=torch.int8) for k, v in sh.items()}
    calls = []

    def hook(merged, tokens, block_kwargs, compute_dtype):
        calls.append((sorted(merged) == sorted({**sh, **pr}), block_kwargs,
                      tuple(tokens.shape)))
        return tokens

    with pytest.raises(ValueError, match="effective-params"):
        fw.apply(fn, sh, pr, bn, x, train=False, pipeline=hook,
                 masking=fw.Masking(ownership=own, piggymask=None, task_id=1),
                 num_classes=4)
    fw.apply(fn, sh, pr, bn, x, train=False, pipeline=hook, num_classes=4)
    assert calls == [(True, dict(heads_n=2, head_dim=16, hidden=128),
                      (2, 4, 32))]
