"""Torch-keyed ViT checkpoints into the port (`convert_torch_vit`), held
against `cpg_tpu`'s converter and CLI.

The state dicts are synthetic (numpy, from a seed), in both layouts
`cpg_tpu.train.pretrained.convert_torch_vit` takes: separate q/k/v/proj
projections with ln1/ln2, fc1/fc2, a biased patch conv and a (T, D)
pos_embed; and timm's names (`patch_embed.proj`, `attn.qkv` packed q | k |
v on the out axis, `attn.proj`, `norm1`/`norm2`, `mlp.fc*`, a (1, T, D)
pos_embed). Both packages' trees must be equal key for key and bit for
bit; a CLS-token checkpoint is refused by both with the same message; and
`sequence --arch vit_cifar --pretrained-npz` adopts task 1 as the
converted weights, its logits equal to their forward bit for bit.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from cpg_tpu.train import pretrained as j_pre
from cpg_tpu_torch import cli
from cpg_tpu_torch.core.invariants import check_state
from cpg_tpu_torch.inference import predict
from cpg_tpu_torch.models import framework as t_fw
from cpg_tpu_torch.models import get_model
from cpg_tpu_torch.train import pretrained as t_pre
from cpg_tpu_torch.train.sequence import init_state
from cpg_tpu_torch.utils.checkpoint import load_state

MULT = 0.25


def _separate_sd(shapes, seed):
    """A state dict in the separate-projection layout with the port's
    shapes (`shapes`: the shared and private trees of a vit_cifar state);
    the patch conv biased, so its bias folds into pos_embed."""
    rng = np.random.RandomState(seed)

    def r(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    sh, pr = shapes
    kh, kw, cin, dim = sh["patch/proj/kernel"]
    sd = {"patch.weight": r(dim, cin, kh, kw), "patch.bias": r(dim),
          "pos": r(*pr["patch/pos_embed"])}
    depth = len({k.split("/")[1] for k in sh if k.startswith("blocks/")})
    for i in range(depth):
        for nm in ("q", "k", "v", "proj"):
            d_in, d_out = sh[f"blocks/{i}/attn/{nm}/kernel"]
            sd[f"blocks.{i}.{nm}.weight"] = r(d_out, d_in)
            sd[f"blocks.{i}.{nm}.bias"] = r(d_out)
        for nm in ("fc1", "fc2"):
            d_in, d_out = sh[f"blocks/{i}/mlp/{nm}/kernel"]
            sd[f"blocks.{i}.{nm}.weight"] = r(d_out, d_in)
            sd[f"blocks.{i}.{nm}.bias"] = r(d_out)
        for ln in ("ln1", "ln2"):
            sd[f"blocks.{i}.{ln}.weight"] = 1 + r(dim)
            sd[f"blocks.{i}.{ln}.bias"] = r(dim)
    sd["norm.weight"], sd["norm.bias"] = 1 + r(dim), r(dim)
    sd["head.weight"], sd["head.bias"] = r(1000, dim), r(1000)
    return sd


def _timm_sd(sd):
    """The same weights under timm's names."""
    out = {"patch_embed.proj.weight": sd["patch.weight"],
           "patch_embed.proj.bias": sd["patch.bias"],
           "pos_embed": sd["pos"][None]}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] != "blocks":
            continue
        i, nm, leaf = parts[1], parts[2], parts[3]
        if nm in ("q", "k", "v"):
            if nm == "q":
                out[f"blocks.{i}.attn.qkv.{leaf}"] = np.concatenate(
                    [sd[f"blocks.{i}.{p}.{leaf}"] for p in "qkv"], 0)
            continue
        name = {"proj": "attn.proj", "ln1": "norm1", "ln2": "norm2",
                "fc1": "mlp.fc1", "fc2": "mlp.fc2"}[nm]
        out[f"blocks.{i}.{name}.{leaf}"] = v
    for k in ("norm.weight", "norm.bias", "head.weight", "head.bias"):
        out[k] = sd[k]
    return out


@pytest.fixture(scope="module")
def vit_sd():
    st = init_state("vit_cifar", torch.Generator().manual_seed(0),
                    width_mult=MULT, device="cpu")
    _, priv, _ = t_fw.init(torch.Generator().manual_seed(0),
                           get_model("vit_cifar")[0],
                           torch.zeros((1, 32, 32, 3)), num_classes=1000,
                           mult=MULT)
    shapes = ({k: tuple(v.shape) for k, v in st.shared.items()},
              {k: tuple(v.shape) for k, v in priv.items()})
    return _separate_sd(shapes, seed=3), shapes


def _trees_eq(got, want):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("layout", ["separate", "timm"])
def test_convert_torch_vit_matches_jax(vit_sd, layout):
    """Both layouts give `cpg_tpu`'s trees, and the two layouts one tree:
    the fused qkv split row-wise, the patch bias folded into pos_embed,
    the (1, T, D) pos_embed squeezed; every shared kernel has the shape the
    port's vit_cifar state holds."""
    sd, (shared_shapes, private_shapes) = vit_sd
    sd = sd if layout == "separate" else _timm_sd(sd)
    got = t_pre.convert_torch_vit(sd)
    _trees_eq(got, j_pre.convert_torch_vit(sd))
    if layout == "timm":
        _trees_eq(got, t_pre.convert_torch_vit(vit_sd[0]))
    assert {k: v.shape for k, v in got[0].items()} == shared_shapes
    assert set(got[1]) <= set(private_shapes)


@pytest.mark.parametrize("bad", [
    {"cls_token": np.zeros((1, 1, 8), np.float32)},
    {"blocks.0.attn.rel_pos.weight": np.zeros((4, 4), np.float32)},
    {"pos_embed": np.zeros((2, 3, 4, 5), np.float32)},
])
def test_convert_torch_vit_refuses_what_jax_refuses(vit_sd, bad):
    """A CLS-token checkpoint, a block parameter the layout does not name
    and a pos_embed of another rank: refused by both converters with the
    same message."""
    sd = {**vit_sd[0], **bad}
    with pytest.raises(ValueError) as want:
        j_pre.convert_torch_vit(sd)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        t_pre.convert_torch_vit(sd)


def test_task_ids_are_sorted():
    st = init_state("vit_cifar", torch.Generator().manual_seed(0),
                    width_mult=MULT, device="cpu")
    assert st.task_ids() == []
    for tid in (3, 1, 2):
        st.tasks[tid] = None
    assert st.task_ids() == [1, 2, 3]


def test_cli_vit_sequence_adopts_the_converted_task1(vit_sd, tmp_path,
                                                     capsys):
    """`sequence --arch vit_cifar --pretrained-npz` with a timm-keyed npz on
    the CPU: task 1 ("imagenet", 1000 classes) is the converted net (its
    logits equal the converted trees' forward bit for bit) and the final
    checkpoint is clean; `--arch vit_b16` now finds its converter (the
    shapes differ, so adoption refuses the vit_cifar weights)."""
    sd = _timm_sd(vit_sd[0])
    npz = str(tmp_path / "vit.npz")
    np.savez(npz, **sd)
    ck = str(tmp_path / "ck")
    argv = ["sequence", "--arch", "vit_cifar", "--device", "cpu",
            "--pretrained-npz", npz, "--network_width_multiplier", str(MULT),
            "--max_allowed_network_width_multiplier", str(MULT),
            "--num-tasks", "1", "--synthetic-train-per-class", "4",
            "--synthetic-test-per-class", "2", "--batch-size", "8",
            "--finetune-epochs", "1", "--prune-epochs", "1",
            "--retrain-epochs", "0", "--prune-ratios", "0.5",
            "--dtype", "float32", "--checkpoint-dir", ck]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["tasks"]) == 1
    names = sorted(os.listdir(ck))
    st = load_state(os.path.join(ck, names[-1]), device="cpu")
    assert st.task_ids() == [1, 2] and st.tasks[1].name == "imagenet"
    assert check_state(st) == []
    shared, private, bn = t_pre.convert_torch_vit(sd)
    x = torch.from_numpy(np.random.RandomState(5).randn(
        3, 32, 32, 3).astype(np.float32))
    # the trees as the state holds them: contiguous (a transposed view
    # takes another BLAS path, whose sums round otherwise)
    t = lambda tree: {k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in tree.items()}
    with torch.inference_mode():
        want, _ = t_fw.apply(get_model("vit_cifar")[0], t(shared),
                             t(private), bn, x, train=False,
                             num_classes=1000, mult=MULT)
    assert torch.equal(predict(st, 1, x, device="cpu"), want)
    with pytest.raises(ValueError, match="patch/proj/kernel"):
        cli.main(["sequence", "--arch", "vit_b16", "--device", "cpu",
                  "--pretrained-npz", npz, "--num-tasks", "1",
                  "--checkpoint-dir", str(tmp_path / "ck16")])
