"""Model registry (arch name -> (model_fn, default input shape: HWC, or
(T,) for a token sequence)).

The port carries every architecture of `cpg_tpu`: VGG16-BN, ResNet-50,
SphereNet-20, the ViT family (`vit_cifar`, `vit_b16`), the MoE ViT
(`vit_moe_cifar`) and the text classifier (`textcls`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .moe import vit_moe_cifar
from .resnet import resnet50
from .spherenet import spherenet20, spherenet_flatten_dims
from .text import VOCAB, textcls
from .vgg import vgg16_bn_cifar
from .vit import vit_b16, vit_cifar

REGISTRY: Dict[str, tuple] = {
    "vgg16_bn_cifar": (vgg16_bn_cifar, (32, 32, 3)),
    "resnet50": (resnet50, (224, 224, 3)),
    "spherenet20": (spherenet20, (112, 96, 3)),
    "vit_cifar": (vit_cifar, (32, 32, 3)),
    "vit_b16": (vit_b16, (224, 224, 3)),
    "vit_moe_cifar": (vit_moe_cifar, (32, 32, 3)),
    "textcls": (textcls, (64,)),
}

# arch name -> {layer: (H, W)} for dense kernels fed by a spatial flatten.
# Growth must block-permute those kernels' input axes (core/grow.py), or
# old-task activations land on the wrong rows. VGG (1x1 after five pools),
# ResNet-50 (global average pool) and the ViTs flatten trivially;
# SphereNet-20's fc5 takes the (7, 6, C) flatten of its last stage.
FLATTEN_DIMS: Dict[str, Dict[str, Tuple[int, int]]] = {
    "spherenet20": spherenet_flatten_dims(),
}


def register(name: str, fn: Callable, input_shape, flatten_dims=None):
    REGISTRY[name] = (fn, tuple(input_shape))
    if flatten_dims:
        FLATTEN_DIMS[name] = dict(flatten_dims)


def get_model(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_flatten_dims(name: str) -> Optional[Dict[str, Tuple[int, int]]]:
    """flatten_dims for grow_state, or None for plain block embedding."""
    return FLATTEN_DIMS.get(name)


def takes_tokens(name: str) -> bool:
    """Whether the arch's input is a token sequence ((T,), not HWC)."""
    return len(get_model(name)[1]) == 1


def check_token_ids(name: str, model_kwargs, x) -> None:
    """For a token arch, raise ValueError unless every id of `x` (an array
    or tensor) lies in [0, vocab), vocab from `model_kwargs` or the
    model's default. `cpg_tpu`'s gather clamps or fills an id outside it
    without an error; torch's raises, and on the card ends the CUDA
    context, so the entry points check on the host first."""
    if not takes_tokens(name) or not len(x):
        return
    vocab = int((model_kwargs or {}).get("vocab", VOCAB))
    if isinstance(x, torch.Tensor):
        lo, hi = (int(v) for v in torch.aminmax(x.detach()))
    else:
        x = np.asarray(x)
        lo, hi = int(x.min()), int(x.max())
    if lo < 0 or hi >= vocab:
        raise ValueError(f"{name}: token ids span [{lo}, {hi}], outside "
                         f"the embedding table's [0, {vocab})")
