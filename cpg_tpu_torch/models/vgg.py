"""VGG16-BN (CIFAR variant), width-multiplier-aware, multi-head.

Same layer names, registration order and math as `cpg_tpu.models.vgg`.
Input (N, 32, 32, 3) NHWC; five 2x2 max-pools reduce to 1x1x(512*m); the
head is Linear(512*m -> num_classes). The eight intra-block
conv -> BN -> ReLU -> conv seams go through `fused_bn_relu_sconv`.
"""

from __future__ import annotations

from .framework import (Ctx, batchnorm, fused_bn_relu_sconv, head, maxpool,
                        relu, sconv)

CFG_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
             512, 512, 512, "M"]


def scale_channels(c: int, mult: float) -> int:
    """ref: make_layers scales each cfg entry by the width multiplier."""
    return max(1, int(c * mult))


def conv_channels(mult: float):
    """The channel counts of the 13 convs' outputs at `mult`."""
    return [scale_channels(v, mult) for v in CFG_VGG16 if v != "M"]


def vgg16_bn_cifar(ctx: Ctx, x, num_classes: int, mult: float = 1.0):
    """Forward. x: (N, 32, 32, 3) NHWC. Returns logits (N, num_classes)."""
    i = 0
    prev = None  # index of a conv whose raw output awaits its BN+ReLU
    for v in CFG_VGG16:
        if v == "M":
            x = maxpool(relu(batchnorm(ctx, f"features/bn{prev}", x)))
            prev = None
            continue
        c = scale_channels(v, mult)
        if prev is None:
            x = sconv(ctx, f"features/conv{i}", x, c, kernel=3, stride=1,
                      padding="SAME")
        else:
            x = fused_bn_relu_sconv(ctx, f"features/bn{prev}",
                                    f"features/conv{i}", x, c)
        prev = i
        i += 1
    x = x.reshape(x.shape[0], -1)  # (N, 512*m) after 5 pools on 32x32
    return head(ctx, "classifier", x, num_classes)
