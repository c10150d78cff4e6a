"""SphereNet-20 with sharable convs and an A-Softmax (AngleLinear) head, for
face verification.

Same layer names, registration order and math as `cpg_tpu.models.
spherenet`: the SphereFace 20-layer residual CNN for 112x96 aligned face
crops, four stages of (stride-2 conv + PReLU, then residual units of two
conv + PReLU pairs), every conv a sharable kernel, every PReLU slope
task-private; fc5, a sharable dense layer over the (7, 6, C) NHWC flatten,
gives the 512-d embedding. The first task (CASIA-WebFace identities)
trains the `angle_linear` head (m = 4 angular margin); later tasks
(expression, gender, age) take a plain linear head on the same trunk, and
`head_type="none"` returns the embedding for LFW verification.

fc5's input is a spatial flatten, so growth embeds its kernel by the
flatten permutation (`spherenet_flatten_dims`, core/grow.py).
"""

from __future__ import annotations

import math

import torch

from .framework import (Ctx, head, head_product, normal_init, prelu, sconv,
                        sdense, xavier_normal)
from .vgg import scale_channels

# stage -> (channels, residual units); SphereFace-20: 64/128/256/512, 1/2/4/1
STAGES = [(64, 1), (128, 2), (256, 4), (512, 1)]
EMBED_DIM = 512
INPUT_HW = (112, 96)
_FLAT_HW = (7, 6)  # 112/16 x 96/16 after four stride-2 convs


def conv_channels(mult: float):
    """The output channel counts of the sharable convs at `mult`, one a
    stage."""
    return [scale_channels(c, mult) for c, _ in STAGES]


def embed_dim(mult: float) -> int:
    """fc5's output width at `mult`."""
    return scale_channels(EMBED_DIM, mult)


def _torch_modules():
    """sphere20a module -> this package's layer base, for every conv and
    PReLU: `conv{s}_1`/`relu{s}_1` are stage s's stride-2 down and its
    PReLU; `conv{s}_{j}`/`relu{s}_{j}`, j = 2 + 2u + (h - 1), unit u's h-th
    conv and PReLU."""
    convs, prelus = {}, {}
    for si, (_, units) in enumerate(STAGES):
        s = si + 1
        convs[f"conv{s}_1"] = f"stage{s}/down"
        prelus[f"relu{s}_1"] = f"stage{s}/down_prelu"
        for u in range(units):
            for half in (1, 2):
                j = 2 + 2 * u + (half - 1)
                convs[f"conv{s}_{j}"] = f"stage{s}/unit{u}/conv{half}"
                prelus[f"relu{s}_{j}"] = f"stage{s}/unit{u}/prelu{half}"
    return convs, prelus


# the one naming table of the sphere20a converters (train/pretrained.py
# reads it as is, train/export_torch.py inverted)
TORCH_CONVS, TORCH_PRELUS = _torch_modules()


def _unit(ctx: Ctx, name: str, x, c: int):
    y = sconv(ctx, f"{name}/conv1", x, c, kernel=3,
              kernel_init=normal_init(0.01))
    y = prelu(ctx, f"{name}/prelu1", y)
    y = sconv(ctx, f"{name}/conv2", y, c, kernel=3,
              kernel_init=normal_init(0.01))
    y = prelu(ctx, f"{name}/prelu2", y)
    return x + y  # f32: both PReLU outputs are f32


def spherenet20(ctx: Ctx, x, num_classes: int, mult: float = 1.0,
                head_type: str = "angle"):
    """x: (N, 112, 96, 3) NHWC, preprocessed (x - 127.5) / 128.

    head_type: 'angle' -> the (cos_theta, phi_theta) AngleLinear outputs;
    'linear' -> a plain task head's logits; 'none' -> the embedding."""
    for si, (c0, units) in enumerate(STAGES):
        c = scale_channels(c0, mult)
        # explicit pad 1 (torch Conv2d(padding=1)): "SAME" at stride 2 pads
        # (0, 1) and samples a grid one pixel off the reference's
        x = sconv(ctx, f"stage{si + 1}/down", x, c, kernel=3, stride=2,
                  padding=1, kernel_init=xavier_normal)
        x = prelu(ctx, f"stage{si + 1}/down_prelu", x)
        for ui in range(units):
            x = _unit(ctx, f"stage{si + 1}/unit{ui}", x, c)
    x = x.reshape(x.shape[0], -1)  # (N, 7*6*C), NHWC order
    emb = sdense(ctx, "fc5", x, embed_dim(mult), kernel_init=xavier_normal)
    if head_type == "none":
        return emb
    if head_type == "linear":
        return head(ctx, "classifier", emb, num_classes)
    return angle_linear(ctx, "classifier_angle", emb, num_classes)


def spherenet_flatten_dims(mult: float = 1.0):
    """grow_state's flatten_dims entry for fc5 (channels interleave in the
    flattened index; see core/grow.py)."""
    return {"fc5/kernel": _FLAT_HW}


def angle_linear(ctx: Ctx, name: str, x, num_classes: int, m: int = 4):
    """A-Softmax head: (cos_theta * |x|, phi_theta * |x|), both (N, C) f32.

    psi(theta) = (-1)^k cos(m theta) - 2k on [k pi/m, (k+1) pi/m]; for
    m = 4, cos(4 theta) = 8c^4 - 8c^2 + 1 with c = cos(theta). The head
    weight is task-private and normalised by column at every forward.

    theta and k are piecewise constant in c and take no gradient: they are
    computed from a detached c (`cpg_tpu`'s floor sends none, but arccos's
    derivative at c = +-1 times a zero would be NaN here). The clip is
    min(max(c, -1), 1), as jnp.clip, so a c exactly at +-1 passes half
    its gradient."""
    w = ctx.private_param(f"{name}/kernel", (x.shape[-1], num_classes),
                          xavier_normal)
    if m != 4:
        raise NotImplementedError("the reference uses m=4")
    xf = x.float()
    x_norm = xf.square().sum(1, keepdim=True).sqrt()
    w_unit = w / (w.square().sum(0, keepdim=True).sqrt() + 1e-12)
    one = torch.ones((), dtype=torch.float32, device=xf.device)
    cos = torch.minimum(torch.maximum(
        head_product(ctx, xf / (x_norm + 1e-12), w_unit), -one), one)
    cos_m = 8.0 * cos**4 - 8.0 * cos**2 + 1.0
    with torch.no_grad():
        k = torch.floor(torch.arccos(cos) * m / math.pi)
        sign = 1.0 - 2.0 * torch.remainder(k, 2.0)  # (-1)^k, exact
    phi = sign * cos_m - 2.0 * k
    return cos * x_norm, phi * x_norm
