"""One rank of a parallel world for tests/test_torch_port_parallel.py,
tests/test_torch_port_parallel_tp.py, tests/test_torch_port_act_shard.py
and tests/test_torch_port_pipeline.py.

    python tests/torch_dist_worker.py <rank> <world> <store> <job.pkl> <out_dir> [<n_model>]

Joins a gloo world on the CPU through the file store `<store>`, builds the
mesh of the world (`n_model` ranks a model group, default 1: data-parallel
only), runs every check listed in the job (written by the test itself)
with the port's parallel entry points, and writes this rank's results to
`<out_dir>/rank<r>.pkl`. A check may build other meshes of the world
(every rank runs the job's checks in one order, so every rank creates
their groups alike). Imports torch, numpy and cpg_tpu_torch only.
"""

import dataclasses
import functools
import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cpg_tpu_torch.core.state import CPGState, TaskEntry, state_from_numpy  # noqa: E402
from cpg_tpu_torch.models import REGISTRY, framework as fw, get_model  # noqa: E402
from cpg_tpu_torch.models.framework import (batchnorm, head, maxpool, relu,  # noqa: E402
                                            sconv)
from cpg_tpu_torch.parallel import collectives as pc  # noqa: E402
from cpg_tpu_torch.parallel import distributed as pd  # noqa: E402
from cpg_tpu_torch.parallel import mesh as pm  # noqa: E402
from cpg_tpu_torch.parallel import pipeline as pp  # noqa: E402
from cpg_tpu_torch.train import step as t_step  # noqa: E402

torch.set_num_threads(1)


def tiny_cnn(ctx, x, num_classes, mult=1.0):
    """`tests/helpers.py`'s tiny_cnn in the port's layers."""
    c1, c2 = max(1, int(8 * mult)), max(1, int(16 * mult))
    x = sconv(ctx, "features/conv0", x, c1, kernel=3)
    x = relu(batchnorm(ctx, "features/bn0", x))
    x = maxpool(x)
    x = sconv(ctx, "features/conv1", x, c2, kernel=3)
    x = relu(batchnorm(ctx, "features/bn1", x))
    return head(ctx, "classifier", x.mean(dim=(1, 2)), num_classes)


REGISTRY.setdefault("tiny_cnn", (tiny_cnn, (16, 16, 3)))


def tiny_vit(ctx, x, num_classes, mult=1.0, depth=2):
    """`tests/helpers.py`'s tiny_vit (depth 4: tests/test_pipeline_train.py's
    tiny_vit4) in the port's layers."""
    from cpg_tpu_torch.models.vit import vit_cifar

    return vit_cifar(ctx, x, num_classes, mult, depth=depth, dim=32,
                     heads=2, patch=8)


def tiny_moe(ctx, x, num_classes, mult=1.0):
    from cpg_tpu_torch.models.moe import vit_moe_cifar

    return vit_moe_cifar(ctx, x, num_classes, mult, depth=2, dim=32,
                         heads=2, patch=8, n_experts=4)


def tiny_textcls(ctx, x, num_classes, mult=1.0):
    from cpg_tpu_torch.models.text import textcls

    return textcls(ctx, x, num_classes, mult, depth=2, dim=32, heads=2,
                   vocab=64, causal=True)


REGISTRY.setdefault("tiny_vit", (tiny_vit, (16, 16, 3)))
REGISTRY.setdefault("tiny_vit4", (functools.partial(tiny_vit, depth=4),
                                  (16, 16, 3)))
REGISTRY.setdefault("tiny_moe", (tiny_moe, (16, 16, 3)))
REGISTRY.setdefault("tiny_textcls", (tiny_textcls, (16,)))


def norm_augment(x, rng):
    return x.float() / 255.0 - 0.5


def annealed(logits, labels, it):
    """A loss that visibly depends on the global step."""
    return t_step.cross_entropy(logits, labels) + 1.0 * it


annealed.wants_step = True


def np_state(s) -> CPGState:
    """A CPGState of numpy arrays from the job's plain dict."""
    return CPGState(s["arch"], s["width_mult"], s["shared"], s["ownership"],
                    {tid: TaskEntry(**t) for tid, t in s["tasks"].items()},
                    model_kwargs=dict(s.get("model_kwargs") or {}),
                    in_shape=s.get("in_shape"))


def _np(tree):
    return {k: v.detach().cpu().numpy().copy() for k, v in (tree or {}).items()}


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in (tree or {}).items()}


def _moments(opt):
    """{parameter index: {moment: shape}} of an optimizer after a step (the
    moments made so far; torch.optim makes each like its parameter)."""
    if opt is None:
        return {}
    params = [p for g in opt.param_groups for p in g["params"]]
    return {i: {name: tuple(v.shape)
                for name, v in opt.state.get(p, {}).items()
                if torch.is_tensor(v) and v.dim()}
            for i, p in enumerate(params)}


def _steps(mesh, state, tid, batches, cfg, augment, loss_fn=None,
           group=True, tp=False, act=False, **kw):
    """Task `tid`'s train step over the global batches [(x, y, rng, it)],
    data-parallel over the mesh (`group=False`: the one-process step on
    the whole batch; `tp`: the kernels split over the model groups too;
    `act`: the tokens and experts split over them, `act_sharder`);
    returns the losses, accuracies and trained trees (whole)."""
    st = state_from_numpy(state, "cpu")
    if act and group:
        cfg = dataclasses.replace(cfg, act_sharder=pm.act_sharder(
            mesh, tokens=True, experts=True))
    task = st.tasks[tid]
    model_fn, _ = get_model(st.arch)
    extra = {} if loss_fn is None else {"loss_fn": loss_fn}
    step, (opt_w, opt_pm) = t_step.build_train_step(
        model_fn, num_classes=task.num_classes, mult=st.width_mult,
        has_piggymask=task.piggymask is not None, cfg=cfg,
        augment_fn=augment, device="cpu",
        model_kwargs=st.forward_kwargs(tid) or None, **extra, **kw)
    specs = pm.shared_shardings(mesh, st.shared, True) if tp else None
    if group:
        st.shared = pm.place_state(mesh, st.shared, specs)
        st.ownership = pm.place_state(mesh, st.ownership, specs)
        task.piggymask = pm.place_state(mesh, task.piggymask, specs)
        for tree in (task.private, task.bn_state):
            pm.place_state(mesh, tree)
        if tp:
            st.shards = {k: v for k, v in specs.items() if v is not None}
        step = pm.make_parallel_train_step(step, mesh, model_sharded=tp,
                                           shards=st.shards)
    carry = [st.shared, task.piggymask, task.private, task.bn_state,
             opt_w.init({"shared": st.shared, "private": task.private}),
             opt_pm.init(task.piggymask) if task.piggymask else None]
    losses, accs = [], []
    for x, y, rng, it in batches:
        if group:
            x, y = pm.shard_batch(mesh, x, y)
        out = step(*carry, st.ownership, tid, x, y, rng, it)
        carry = list(out[:6])
        losses.append(float(out[6]["loss"]))
        accs.append(float(out[6]["acc"]))
    held = dict(shared=_shapes(carry[0]), ownership=_shapes(st.ownership),
                piggymask=_shapes(carry[1]), moments_w=_moments(carry[4]),
                moments_pm=_moments(carry[5]))
    st.shared, task.piggymask = carry[0], carry[1]
    if tp:
        st = pc.gather_state(st)
        task = st.tasks[tid]
    return dict(losses=losses, accs=accs, shared=_np(st.shared),
                piggymask=_np(task.piggymask), private=_np(carry[2]),
                bn=_np(carry[3]), held=held,
                split={k: (v.axis, v.size) for k, v in (specs or {}).items()
                       if v is not None})


def check_step(mesh, state, tid, batches, flags=None, single=False,
               annealed_loss=False, dtype="float32", lr=0.05, lr_mask=1e-4,
               tp=False, control=False, act=False, control_gather=False):
    """The DP step (and, with `single`, the one-process step on rank 0);
    `tp`: the kernels split over the model groups; `act`: the tokens and
    experts too (`act_sharder`); `control`: also the same with
    `to_model_group`'s backward made the identity (the ranks' partial
    input gradients then never summed); `control_gather`: also the same
    with `gather_tokens`' backward made `gather_from_model_group`'s (this
    rank's rows of the gradient, no sum over the ranks)."""
    cfg = t_step.TrainConfig(lr=lr, lr_mask=lr_mask,
                             compute_dtype=getattr(torch, dtype),
                             **(flags or {}))
    aug = None
    if batches[0][2] is not None:
        from cpg_tpu_torch.data.augment import cifar_train_augment as aug
    elif state["arch"] in ("tiny_cnn", "tiny_vit", "tiny_moe"):
        aug = norm_augment
    loss_fn = annealed if annealed_loss else None
    out = {"dp": _steps(mesh, np_state(state), tid, batches, cfg, aug,
                        loss_fn, tp=tp, act=act)}
    if single and mesh.rank == 0:
        out["single"] = _steps(mesh, np_state(state), tid, batches, cfg, aug,
                               loss_fn, group=False)
    if control:
        keep = pc._ToModelGroup.backward
        pc._ToModelGroup.backward = staticmethod(lambda ctx, g: (g, None))
        try:
            out["control"] = _steps(mesh, np_state(state), tid, batches, cfg,
                                    aug, loss_fn, tp=tp)
        finally:
            pc._ToModelGroup.backward = keep
    if control_gather:
        keep = pc._GatherTokens.backward
        pc._GatherTokens.backward = staticmethod(lambda ctx, g: (
            g.narrow(1, pc.rank(ctx.group) * ctx.width,
                     ctx.width).contiguous(), None))
        try:
            out["control_gather"] = _steps(mesh, np_state(state), tid,
                                           batches, cfg, aug, loss_fn,
                                           tp=tp, act=act)
        finally:
            pc._GatherTokens.backward = keep
    return out


def check_skew(mesh, state, batches):
    """The DP step on skewed shards, then the same with BatchNorm's sync
    removed (each rank's statistics over its own rows)."""
    out = check_step(mesh, state, 1, batches)
    keep = fw.all_reduce_sum, fw.world_size
    fw.all_reduce_sum, fw.world_size = (lambda x, g: x), (lambda g: 1)
    try:
        out["unsynced"] = check_step(mesh, state, 1, batches)["dp"]
    finally:
        fw.all_reduce_sum, fw.world_size = keep
    return out


def check_eval(mesh, state, x, y):
    """The parallel eval step on this rank's rows."""
    st = state_from_numpy(np_state(state), "cpu")
    t = st.tasks[1]
    ev = t_step.make_eval_step(
        tiny_cnn, num_classes=t.num_classes, mult=1.0, has_piggymask=False,
        cfg=t_step.TrainConfig(compute_dtype=torch.float32),
        preprocess_fn=lambda v: norm_augment(v, None), device="cpu")
    xs, ys = pm.shard_batch(mesh, x, y)
    _, m = pm.make_parallel_eval_step(ev, mesh)(
        st.shared, None, t.private, t.bn_state, st.ownership, 1, xs, ys)
    return {"acc_sum": int(m["acc_sum"]), "loss": float(m["loss"])}


def check_manager(mesh, state, data, epochs):
    from cpg_tpu_torch.train.manager import Manager

    st = state_from_numpy(np_state(state), "cpu")
    kw = dict(augment_fn=norm_augment, seed=5, lr_schedule="constant",
              preprocess_fn=lambda v: norm_augment(v, None), mesh=mesh)
    cfg = t_step.TrainConfig(lr=0.05, compute_dtype=torch.float32)
    try:
        Manager(st, tiny_cnn, 1, data, cfg, batch_size=33, **kw)
        refused = None
    except ValueError as e:
        refused = str(e)
    res = Manager(st, tiny_cnn, 1, data, cfg, batch_size=32,
                  **kw).train(epochs)
    return dict(loss=res.loss, acc=res.acc, steps=res.steps, refused=refused,
                shared=_np(st.shared), bn=_np(st.tasks[1].bn_state))


def check_sequence(mesh, tasks, ckdir):
    """run_sequence over two tiny_cnn tasks with pruning and one growth,
    then again over its checkpoints (every task resumed)."""
    from cpg_tpu_torch.train import sequence as seqm

    writes = []
    keep = seqm.save_state
    seqm.save_state = lambda st, path: (writes.append(os.path.basename(path)),
                                        keep(st, path))[1]
    seq = seqm.SequenceConfig(
        finetune_epochs=1, prune_epochs=1, retrain_epochs=1,
        prune_ratios=(0.5,), batch_size=32, lr=0.05, growth_step=0.5,
        max_width_mult=1.5, prune_freq=2, seed=3, lr_schedule="constant",
        checkpoint_dir=ckdir)
    cfg = t_step.TrainConfig(lr=0.05, compute_dtype=torch.float32)
    kw = dict(goals={"b": 1.01}, augment_fn=norm_augment,
              preprocess_fn=lambda v: norm_augment(v, None), mesh=mesh)
    try:
        state, reps = seqm.run_sequence("tiny_cnn", tasks, cfg, seq, **kw)
        again, _ = seqm.run_sequence("tiny_cnn", tasks, cfg, seq, **kw)
    finally:
        seqm.save_state = keep
    flat = {}
    for name, st in (("first", state), ("resumed", again)):
        flat[name] = {f"shared/{k}": v for k, v in _np(st.shared).items()}
        flat[name].update({f"own/{k}": v
                           for k, v in _np(st.ownership).items()})
        for tid, t in st.tasks.items():
            for group, tree in (("pm", t.piggymask), ("private", t.private),
                                ("bn", t.bn_state)):
                flat[name].update({f"{tid}/{group}/{k}": v
                                   for k, v in _np(tree).items()})
    return dict(writes=writes, width=state.width_mult,
                grew=[r.grew for r in reps],
                ratios=[r.chosen_ratio for r in reps], **flat)


def _whole_trees(st, tid):
    """Task `tid`'s trained trees of a (possibly split) state, whole."""
    w = pc.gather_state(st)
    return dict(shared=_np(w.shared), ownership=_np(w.ownership),
                piggymask=_np(w.tasks[tid].piggymask),
                private=_np(w.tasks[tid].private),
                bn=_np(w.tasks[tid].bn_state))


def _held(st):
    """The shapes this rank holds of shared, ownership and every task's
    piggymask."""
    return dict(shared=_shapes(st.shared), ownership=_shapes(st.ownership),
                **{f"piggymask{tid}": _shapes(t.piggymask)
                   for tid, t in st.tasks.items()})


def check_tp_manager(mesh, state, data, epochs):
    """`Manager(mesh=)` over a mesh with a model axis, task 2 (the cpg_tpu
    test's settings): what each rank holds before and after, the moments'
    shapes, the phase's result and the whole trained trees."""
    from cpg_tpu_torch.train.manager import Manager

    st = state_from_numpy(np_state(state), "cpu")
    mgr = Manager(st, tiny_cnn, 2, data,
                  t_step.TrainConfig(lr=0.05, compute_dtype=torch.float32),
                  batch_size=32, augment_fn=norm_augment, seed=5,
                  lr_schedule="constant", mesh=mesh)
    placed = _held(st)
    res = mgr.train(epochs)
    return dict(loss=res.loss, acc=res.acc, steps=res.steps, placed=placed,
                held=_held(st), moments_w=_moments(mgr.opt_w_state),
                moments_pm=_moments(mgr.opt_pm_state),
                split={k: (v.axis, v.size) for k, v in st.shards.items()},
                **_whole_trees(st, 2))


def _table_init(table):
    """The init seam from a table of another package's init trees, keyed
    (seed, num_classes, mult) as the cycle asks for them."""
    def init_fn(gen, model_fn, sample_x, num_classes, mult, **kw):
        trees = table[(gen.initial_seed(), num_classes, mult)]
        return tuple({k: torch.from_numpy(v.copy()) for k, v in t.items()}
                     for t in trees)
    return init_fn


def check_tp_sequence(mesh, tasks, ckdir, seq_kw, inits):
    """run_sequence over the mesh with checkpoints (cpg_tpu's inits through
    the `init_fn` seam), again over its checkpoints (every task resumed),
    and a Manager placed from the last checkpoint (re-split)."""
    from cpg_tpu_torch.train import sequence as seqm
    from cpg_tpu_torch.train.manager import Manager
    from cpg_tpu_torch.utils.checkpoint import load_state

    writes = []
    keep = seqm.save_state
    seqm.save_state = lambda st, path: (writes.append(os.path.basename(path)),
                                        keep(st, path))[1]
    seq = seqm.SequenceConfig(**seq_kw, checkpoint_dir=ckdir)
    cfg = t_step.TrainConfig(lr=0.05, compute_dtype=torch.float32)
    kw = dict(augment_fn=norm_augment, mesh=mesh, init_fn=_table_init(inits),
              preprocess_fn=lambda v: norm_augment(v, None))
    try:
        state, reps = seqm.run_sequence("tiny_cnn", tasks, cfg, seq, **kw)
        again, _ = seqm.run_sequence("tiny_cnn", tasks, cfg, seq, **kw)
    finally:
        seqm.save_state = keep
    last = os.path.join(ckdir, f"task{len(tasks):02d}_{list(tasks)[-1]}")
    whole = load_state(last, device="cpu")
    st = load_state(last, device="cpu")
    mgr = Manager(st, tiny_cnn, len(tasks), list(tasks.values())[-1], cfg,
                  batch_size=32, mesh=mesh,
                  preprocess_fn=lambda v: norm_augment(v, None))
    want = pc.shard_state(whole, st.shards)
    resplit = all(torch.equal(a[k], b[k])
                  for a, b in ((st.shared, want.shared),
                               (st.ownership, want.ownership),
                               (st.tasks[2].piggymask,
                                want.tasks[2].piggymask))
                  for k in st.shards)
    single = {}
    if mesh.rank == 0:  # the one-process Manager on the same checkpoint,
        # and the one-process cycle
        single["eval"] = Manager(
            load_state(last, device="cpu"), tiny_cnn, len(tasks),
            list(tasks.values())[-1], cfg, batch_size=32, device="cpu",
            preprocess_fn=lambda v: norm_augment(v, None)).eval()
        one, reps1 = seqm.run_sequence(
            "tiny_cnn", tasks, cfg, seqm.SequenceConfig(**seq_kw),
            device="cpu", **{k: v for k, v in kw.items() if k != "mesh"})
        single.update(reports=[(r.pick_acc, r.final_acc, r.chosen_ratio,
                                r.grew) for r in reps1],
                      shared=_np(one.shared), ownership=_np(one.ownership))
    flat = {}
    for name, s in (("first", state), ("resumed", again)):
        flat[name] = {f"shared/{k}": v for k, v in _np(s.shared).items()}
        flat[name].update({f"own/{k}": v for k, v in _np(s.ownership).items()})
        for tid, t in s.tasks.items():
            for group, tree in (("pm", t.piggymask), ("private", t.private),
                                ("bn", t.bn_state)):
                flat[name].update({f"{tid}/{group}/{k}": v
                                   for k, v in _np(tree).items()})
    return dict(writes=writes, reports=[
        (r.pick_acc, r.final_acc, r.chosen_ratio, r.grew) for r in reps],
        resplit=resplit, n_split=len(st.shards), loaded=_held(whole),
        placed=_held(st), resumed_eval=mgr.eval(), single=single, **flat)


def check_prune(mesh, w, own, tid, targets, n0, ratio):
    """The pruner on layers split over the model group: gradual events at
    `targets`, then a one-shot prune; the whole layers after each, and the
    one-process pruner's on rank 0."""
    from cpg_tpu_torch.core import pruner

    def run(split):
        sh = {k: torch.from_numpy(v.copy()) for k, v in w.items()}
        ow = {k: torch.from_numpy(v.copy()) for k, v in own.items()}
        specs = pm.shared_shardings(mesh, sh, True) if split else {}
        specs = {k: s for k, s in specs.items() if s is not None}
        sh = {k: specs[k].take(v) if k in specs else v for k, v in sh.items()}
        ow = {k: specs[k].take(v) if k in specs else v for k, v in ow.items()}
        counts = {k: int(v) for k, v in pruner.snapshot_owned_counts(
            ow, tid, specs).items()}
        def whole(pre, tree):
            return {f"{pre}/{k}": (specs[k].gather(v) if k in specs
                                   else v).numpy().copy()
                    for k, v in tree.items()}

        out = []
        for t in targets:
            pruner.gradual_prune_(sh, ow, tid, t, n0, specs)
            out.append(dict(
                sparsity=float(pruner.task_sparsity(ow, tid, n0, specs)),
                **whole("w", sh), **whole("own", ow)))
        pruner.one_shot_prune_(sh, ow, tid, ratio, specs)
        out.append(whole("w", sh))
        return dict(counts=counts, events=out,
                    split={k: (s.axis, s.size) for k, s in specs.items()})

    res = {"split": run(True)}
    if mesh.rank == 0:
        res["single"] = run(False)
    return res


def _tensors(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def check_sp_forward(mesh, arch, trees, x, n_model, num_classes, kw=None,
                     tokens=True, experts=False, model_sharded=False):
    """`arch`'s eval forward over a (data, model) mesh of `n_model` model
    ranks with `act_sharder(tokens, experts)` (and with `model_sharded`
    each rank's slices of the kernels): this rank's rows of the logits,
    what each seam took and gave (shapes), and on rank 0 the one-process
    forward of the whole batch."""
    m = pm.make_mesh(n_model=n_model)
    fn = functools.partial(get_model(arch)[0], **(kw or {}))
    shared, private, bn = (_tensors(t) for t in trees)
    sl = pm.local_batch_slice(m, len(x))
    specs = {}
    if model_sharded:
        specs = {k: s for k, s in pm.shared_shardings(m, shared, True).items()
                 if s is not None}
    mine = {k: specs[k].take(v) if k in specs else v
            for k, v in shared.items()}
    seams, keep = [], fw.Ctx.constrain

    def spy(ctx, v, tag):
        out = keep(ctx, v, tag)
        seams.append((tag, tuple(v.shape), tuple(out.shape)))
        return out

    fw.Ctx.constrain = spy
    try:
        with torch.no_grad():
            y, _ = fw.apply(fn, mine, private, bn, torch.from_numpy(x[sl]),
                            train=False, shards=specs,
                            act_sharder=pm.act_sharder(m, tokens, experts),
                            num_classes=num_classes)
    finally:
        fw.Ctx.constrain = keep
    out = dict(logits=y.numpy(), rows=sl, seams=seams, n_split=len(specs),
               model_rank=m.model_rank)
    if m.rank == 0:
        with torch.no_grad():
            out["one"] = fw.apply(fn, shared, private, bn, torch.from_numpy(x),
                                  train=False, num_classes=num_classes
                                  )[0].numpy()
    return out


def check_pipeline(mesh, stacked, tokens, bkw, n_stages, micro=(4, 2)):
    """The blocks `stacked` (numpy, depth-first) over `tokens` as a
    `n_stages`-stage pipeline, n_micro in `micro`: the output and the
    gradients of mean(out^2) (stacked leaves, then tokens); bf16 tokens
    through f32 blocks; the control (`psum_replicated`'s backward made
    `all_reduce_sum`'s); the refusals."""
    pmesh = pp.make_pipeline_mesh(n_stages)
    st = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in stacked.items()}
    tk = torch.from_numpy(tokens.copy()).requires_grad_(True)

    def run(n_micro):
        o = pp.pipeline_blocks(pmesh, st, tk, n_micro, block_kwargs=bkw)
        g = torch.autograd.grad(o.square().mean(), [*st.values(), tk])
        return o.detach().numpy(), [v.numpy() for v in g]

    out = {"stage": pmesh.rank, "mesh": dict(axes=pmesh.axis_names,
                                             shape=pmesh.shape)}
    for n_micro in micro:
        out[n_micro] = run(n_micro)
    with torch.no_grad():
        bf = pp.pipeline_blocks(pmesh, st, tk.detach().bfloat16(), micro[0],
                                block_kwargs=bkw,
                                compute_dtype=torch.float32)
    out["bf16"] = (str(bf.dtype), bf.float().numpy())
    keep = pc._PsumReplicated.backward
    pc._PsumReplicated.backward = pc._AllReduceSum.backward
    try:
        out["control"] = run(micro[0])
    finally:
        pc._PsumReplicated.backward = keep
    refused = {}
    try:
        pp.make_pipeline_mesh(pc.world_size(pmesh.group) + 1)
    except ValueError as e:
        refused["mesh"] = str(e)
    three = {k: v[:3] for k, v in st.items()}
    for name, (s, m) in (("depth", (2, 2)), ("batch", (3, 3))):
        try:
            pp.pipeline_blocks(pp.make_pipeline_mesh(s), three,
                               tk.detach()[:4], m, block_kwargs=bkw)
        except ValueError as e:
            refused[name] = str(e)
    out["refused"] = refused
    return out


def _pipeliner(n_stages, n_micro, depth):
    return pp.make_pipeliner(pp.make_pipeline_mesh(n_stages), n_micro, depth)


def check_pipeline_step(mesh, state, batches, n_stages, n_micro, depth):
    """Task 2's f32 train step through `TrainConfig.pipeliner` (an
    `n_stages`-stage pipeline), over the global batches [(x, y)]:
    losses and trained trees of this stage."""
    cfg = t_step.TrainConfig(lr=0.05, lr_mask=1e-3,
                             compute_dtype=torch.float32,
                             pipeliner=_pipeliner(n_stages, n_micro, depth))
    st = state_from_numpy(np_state(state), "cpu")
    task = st.tasks[2]
    step, (opt_w, opt_pm) = t_step.build_train_step(
        get_model(st.arch)[0], num_classes=task.num_classes,
        mult=st.width_mult, has_piggymask=True, cfg=cfg,
        augment_fn=norm_augment, device="cpu")
    carry = [st.shared, task.piggymask, task.private, task.bn_state,
             opt_w.init({"shared": st.shared, "private": task.private}),
             opt_pm.init(task.piggymask)]
    losses = []
    for it, (x, y) in enumerate(batches):
        out = step(*carry, st.ownership, 2, x, y, None, it)
        carry = list(out[:6])
        losses.append(float(out[6]["loss"]))
    return dict(losses=losses, shared=_np(carry[0]), piggymask=_np(carry[1]),
                private=_np(carry[2]))


def check_pipeline_manager(mesh, state, data, n_stages, n_micro, depth,
                           epochs, jsonl):
    """`Manager` over a pipeline, one a stage, every stage the same state,
    data and seed (`tests/test_pipeline_train.py`'s settings), with a
    JSONL record at `jsonl`: the phase's result and the trained kernels."""
    from cpg_tpu_torch.train.manager import Manager

    cfg = t_step.TrainConfig(lr=0.05, lr_mask=1e-3,
                             compute_dtype=torch.float32,
                             pipeliner=_pipeliner(n_stages, n_micro, depth))
    st = state_from_numpy(np_state(state), "cpu")
    res = Manager(st, get_model(st.arch)[0], 1, data, cfg, batch_size=32,
                  lr_schedule="constant", augment_fn=norm_augment,
                  preprocess_fn=lambda v: norm_augment(v, None), seed=0,
                  jsonl_path=jsonl, device="cpu").train(epochs)
    return dict(acc=res.acc, loss=res.loss, steps=res.steps,
                shared=_np(st.shared))


CHECKS = {"step": check_step, "skew": check_skew, "eval": check_eval,
          "manager": check_manager, "sequence": check_sequence,
          "tp_manager": check_tp_manager, "tp_sequence": check_tp_sequence,
          "prune": check_prune, "sp_forward": check_sp_forward,
          "pipeline": check_pipeline, "pipeline_step": check_pipeline_step,
          "pipeline_manager": check_pipeline_manager}


def main(rank, world, store, job_path, out_dir, n_model=1):
    pd.initialize(f"file://{store}", world, rank, device="cpu")
    try:
        mesh = pm.make_mesh(n_model=n_model)
        assert mesh.size == world and mesh.rank == rank, mesh
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        out = {"mesh": dict(shape=mesh.shape, axes=mesh.axis_names,
                            rows=pm.local_batch_slice(mesh, 8 * world),
                            data_rank=mesh.data_rank,
                            model_rank=mesh.model_rank)}
        for name, (check, kwargs) in job.items():
            out[name] = CHECKS[check](mesh, **kwargs)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        pd.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5], *map(int, sys.argv[6:]))
