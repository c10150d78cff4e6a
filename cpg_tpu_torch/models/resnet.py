"""ResNet-50 with sharable convs, width-multiplier-aware, multi-head.

Same layer names, registration order and math as `cpg_tpu.models.resnet`:
a torchvision-style ResNet-50 (stride on the 3x3 conv) whose 53 convs are
sharable kernels, with the BN affines and running stats (the downsample
BNs too) and the classifier head task-private; every channel count scales
with the width multiplier. Input (N, 224, 224, 3) NHWC; the global average
pool feeds the head, so growth is a plain block embed.

The 13 stride-1 bottleneck 3x3 convs are BN+ReLU+conv seams and go through
`fused_bn_relu_sconv`; the three stride-2 ones take an explicit pad of 1
(torch's Conv2d(padding=1): "SAME" would pad (0, 1) at stride 2 and sample
a shifted grid).
"""

from __future__ import annotations

import torch.nn.functional as F

from .framework import (Ctx, avgpool_global, batchnorm, fused_bn_relu_sconv,
                        head, relu, sconv)
from .vgg import scale_channels

# (blocks, base planes) per stage: ResNet-50's 3, 4, 6, 3 bottlenecks
STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]
EXPANSION = 4


def conv_channels(mult: float):
    """The channel counts of the sharable convs' outputs at `mult`: the
    stem, each stage's planes and its blocks' outputs (4x the planes)."""
    planes = [scale_channels(p, mult) for _, p in STAGES]
    return [scale_channels(64, mult), *planes, *(EXPANSION * p for p in planes)]


def widest_seam(in_shape) -> int:
    """The width of the widest fused seam for an (H, W, C) input: layer1's,
    after the stride-2 stem (pad 3) and the 3x3/2 max pool (pad 1), each of
    which takes W to ceil(W / 2)."""
    w = in_shape[1]
    return -(-(-(-w // 2)) // 2)


def _torch_modules():
    """Layer base -> torchvision resnet50 module name, for every conv and
    BN: `layerL/blockB/convN` <-> `layerL.B.convN`, `.../downsample` and
    `.../downsample_bn` <-> `layerL.B.downsample.0` and `.1`."""
    out = {"conv1": "conv1", "bn1": "bn1"}
    for si, (blocks, _) in enumerate(STAGES):
        for bi in range(blocks):
            for n in ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3"):
                out[f"layer{si + 1}/block{bi}/{n}"] = f"layer{si + 1}.{bi}.{n}"
        for i, n in enumerate(("downsample", "downsample_bn")):
            out[f"layer{si + 1}/block0/{n}"] = f"layer{si + 1}.0.downsample.{i}"
    return out


# the one naming table of the torchvision converters (train/pretrained.py
# reads it inverted, train/export_torch.py as is)
TORCH_MODULES = _torch_modules()


def _maxpool_3x3_s2(x):
    """3x3/2 max pool with padding 1, the padding -inf (as `cpg_tpu`'s
    reduce_window). Where a window holds ties the gradient goes to the
    first maximum in the window, as XLA's select_and_scatter sends it."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2,
                        padding=1).permute(0, 2, 3, 1)


def _bottleneck(ctx: Ctx, name: str, x, planes: int, stride: int):
    cin = x.shape[-1]
    cout = planes * EXPANSION
    identity = x
    y = sconv(ctx, f"{name}/conv1", x, planes, kernel=1)
    if stride == 1:
        y = fused_bn_relu_sconv(ctx, f"{name}/bn1", f"{name}/conv2", y,
                                planes)
    else:
        y = relu(batchnorm(ctx, f"{name}/bn1", y))
        y = sconv(ctx, f"{name}/conv2", y, planes, kernel=3, stride=stride,
                  padding=1)
    y = relu(batchnorm(ctx, f"{name}/bn2", y))
    y = sconv(ctx, f"{name}/conv3", y, cout, kernel=1)
    y = batchnorm(ctx, f"{name}/bn3", y)
    if stride != 1 or cin != cout:
        identity = sconv(ctx, f"{name}/downsample", x, cout, kernel=1,
                         stride=stride)
        identity = batchnorm(ctx, f"{name}/downsample_bn", identity)
    return relu(y + identity)


def resnet50(ctx: Ctx, x, num_classes: int, mult: float = 1.0):
    """Forward. x: (N, H, W, 3) NHWC (224x224 for the fine-grained tasks).
    Returns logits (N, num_classes) in f32."""
    x = sconv(ctx, "conv1", x, scale_channels(64, mult), kernel=7, stride=2,
              padding=((3, 3), (3, 3)))
    x = relu(batchnorm(ctx, "bn1", x))
    x = _maxpool_3x3_s2(x)
    for si, (blocks, planes) in enumerate(STAGES):
        p = scale_channels(planes, mult)
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            x = _bottleneck(ctx, f"layer{si + 1}/block{bi}", x, p, stride)
    return head(ctx, "classifier", avgpool_global(x), num_classes)
