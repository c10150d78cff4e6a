"""Model registry (arch name -> (model_fn, default input shape HWC)).

The port carries VGG16-BN and the ViT family (`vit_cifar`, `vit_b16`); the
other `cpg_tpu` architectures come in later slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from .vgg import vgg16_bn_cifar
from .vit import vit_b16, vit_cifar

REGISTRY: Dict[str, tuple] = {
    "vgg16_bn_cifar": (vgg16_bn_cifar, (32, 32, 3)),
    "vit_cifar": (vit_cifar, (32, 32, 3)),
    "vit_b16": (vit_b16, (224, 224, 3)),
}

# arch name -> {layer: (H, W)} for dense kernels fed by a spatial flatten.
# Growth must block-permute those kernels' input axes (core/grow.py), or
# old-task activations land on the wrong rows. VGG (1x1 after five pools)
# and the ViTs flatten trivially; SphereNet's fc5 arrives with its model.
FLATTEN_DIMS: Dict[str, Dict[str, Tuple[int, int]]] = {}


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
