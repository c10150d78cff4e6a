"""The input builders of the port's profile scripts
(scripts/torch_train_profile.py `train_batch`, scripts/torch_serve_profile.py
`serve_batch`) give every architecture they take a batch of the model
registry's per-example shape, in the dtype the model reads, that its
augmentation or eval preprocess accepts. Both scripts build their inputs
from chip_smoke.py's `_arch_io` and `_inputs`; these tests catch a change
there that the scripts, which run only on the card, would not show here."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from cpg_tpu_torch.models import get_model

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("vgg16_bn_cifar", "vit_cifar", "textcls", "vit_moe_cifar",
         "resnet50", "spherenet20")
N = 3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _script("torch_train_profile"), _script("torch_serve_profile")


def _want(arch):
    shape = get_model(arch)[1]
    return (N, *shape), (np.int32 if len(shape) == 1 else np.uint8)


def test_scripts_take_every_arch(scripts):
    for mod in scripts:
        assert mod.ARCHS == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_train_batch(scripts, arch):
    import chip_smoke as cs

    x, y, draws = scripts[0].train_batch(torch, arch, N)
    shape, dtype = _want(arch)
    assert tuple(x.shape) == shape
    assert x.numpy().dtype == dtype
    assert tuple(y.shape) == (N,) and int(y.max()) < 5
    augment = cs._arch_io(arch)[2]
    assert tuple(augment(x, draws).shape) == shape


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch(scripts, arch):
    import chip_smoke as cs

    x = scripts[1].serve_batch(arch, N)
    shape, dtype = _want(arch)
    assert x.shape == shape and x.dtype == dtype
    prep = cs._arch_io(arch)[1]
    if prep is not None:
        assert tuple(prep(torch.from_numpy(x)).shape) == shape
