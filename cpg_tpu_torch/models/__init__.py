"""Model registry (arch name -> (model_fn, default input shape HWC)).

The port carries VGG16-BN and the ViT family (`vit_cifar`, `vit_b16`); the
other `cpg_tpu` architectures come in later slices.
"""

from __future__ import annotations

from typing import Callable, Dict

from .vgg import vgg16_bn_cifar
from .vit import vit_b16, vit_cifar

REGISTRY: Dict[str, tuple] = {
    "vgg16_bn_cifar": (vgg16_bn_cifar, (32, 32, 3)),
    "vit_cifar": (vit_cifar, (32, 32, 3)),
    "vit_b16": (vit_b16, (224, 224, 3)),
}


def register(name: str, fn: Callable, input_shape):
    REGISTRY[name] = (fn, tuple(input_shape))


def get_model(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
