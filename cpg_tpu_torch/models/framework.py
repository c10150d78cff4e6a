"""Functional layer framework for CPG models (VGG and ViT subset).

The counterpart of `cpg_tpu.models.framework`: a flat parameter dict keyed by
layer name, split into *shared* sharable kernels (governed by ownership) and
task-*private* params (BN and LayerNorm affines, BN running stats, biases,
positional embeddings, heads). Layers take and return NHWC (or (N, T, D))
tensors; conv kernels are HWIO, dense kernels (in, out); torch layouts appear
only inside ops.

Usage:
    shared, private, bn_state = init(generator, model_fn, sample_x)
    y, new_bn = apply(model_fn, eff_shared, private, bn_state, x, train=False)

`init` draws every parameter from the given `torch.Generator` on the CPU, in
registration order; the caller moves the dicts to its device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.conv import conv2d_nhwc, resolve_padding


@dataclass
class Masking:
    """Raw-weight mode: `shared` holds RAW weights and each sharable layer
    applies the CPG effective-weight selection itself, as a per-layer select
    or inside the masked kernels: `pallas_dense` (the names `cpg_tpu` uses)
    routes `sdense` to ops/masked_matmul.py, `pallas_conv` routes `sconv` to
    ops/masked_conv.py. Numerically the same as consuming pre-masked
    effective params."""

    ownership: Dict[str, torch.Tensor]
    piggymask: Optional[Dict[str, torch.Tensor]]
    task_id: int
    threshold: float = 5e-3
    mask_mode: str = "binary"
    pallas_dense: bool = False
    pallas_conv: bool = False


def he_normal_fan_out(gen, shape, dtype=torch.float32):
    """Kaiming-normal, fan_out, relu gain — torch's VGG conv init."""
    fan_out = shape[0] * shape[1] * shape[3] if len(shape) == 4 else shape[-1]
    return torch.randn(tuple(shape), generator=gen, dtype=dtype) * math.sqrt(
        2.0 / fan_out)


def xavier_normal(gen, shape, dtype=torch.float32):
    """Glorot-normal over (in, out) dense or HWIO conv kernels."""
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[-1]
    else:
        fan_in = shape[0] * shape[1] * shape[2]
        fan_out = shape[0] * shape[1] * shape[3]
    return torch.randn(tuple(shape), generator=gen, dtype=dtype) * math.sqrt(
        2.0 / (fan_in + fan_out))


def normal_init(std):
    def f(gen, shape, dtype=torch.float32):
        return torch.randn(tuple(shape), generator=gen, dtype=dtype) * std

    return f


def _zeros(gen, shape):
    return torch.zeros(tuple(shape))


def _ones(gen, shape):
    return torch.ones(tuple(shape))


@dataclass
class Ctx:
    """Per-call context threading params through a functional forward."""

    mode: str  # 'init' | 'apply'
    train: bool
    generator: Optional[torch.Generator] = None
    shared: Dict[str, torch.Tensor] = field(default_factory=dict)
    private: Dict[str, torch.Tensor] = field(default_factory=dict)
    bn_state: Dict[str, torch.Tensor] = field(default_factory=dict)
    new_bn_state: Dict[str, torch.Tensor] = field(default_factory=dict)
    compute_dtype: torch.dtype = torch.float32
    masking: Optional[Masking] = None
    # route BN+ReLU+conv3x3 chains through the fused kernel
    # (ops/fused_chain.py); honoured by fused_bn_relu_sconv outside init
    fused_chain: bool = False
    # route transformer attention through the flash kernels (ops/flash.py);
    # honoured by models/vit.py attention() outside init
    flash_attention: bool = False

    def shared_param(self, name, shape, init_fn):
        if self.mode == "init":
            if name in self.shared:
                raise ValueError(f"duplicate shared param {name}")
            self.shared[name] = init_fn(self.generator, shape)
        w = self.shared[name]
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"{name}: {tuple(w.shape)} != {tuple(shape)}")
        return w

    def private_param(self, name, shape, init_fn):
        if self.mode == "init":
            if name in self.private:
                raise ValueError(f"duplicate private param {name}")
            self.private[name] = init_fn(self.generator, shape)
        return self.private[name]

    def bn_running(self, name, shape):
        if self.mode == "init":
            self.bn_state[name + "/mean"] = torch.zeros(shape)
            self.bn_state[name + "/var"] = torch.ones(shape)
        return self.bn_state[name + "/mean"], self.bn_state[name + "/var"]

    def mask_entries(self, key):
        """(ownership, piggymask-or-None) for a shared kernel in raw mode."""
        mk = self.masking
        pm = mk.piggymask[key] if mk.piggymask is not None else None
        return mk.ownership[key], pm

    def masked_weight(self, key, w):
        """Per-layer effective-weight select (raw mode, no kernel)."""
        from ..ops.masked import effective_kernel

        mk = self.masking
        own, pm = self.mask_entries(key)
        return effective_kernel(w, own, pm, mk.task_id, mk.threshold,
                                mk.mask_mode)


def _patchify_dot(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """kernel == stride == k VALID conv as space-to-depth + one product. The
    patch flatten order (kh, kw, cin) is HWIO's row-major flatten, so
    `w.reshape(k*k*C, F)` pairs elements as the strided conv does."""
    n, hh, ww, c = x.shape
    f = w.shape[-1]
    x = x.reshape(n, hh // k, k, ww // k, k, c).permute(0, 1, 3, 2, 4, 5)
    y = x.reshape(n, (hh // k) * (ww // k), k * k * c) @ w.reshape(k * k * c, f)
    return y.reshape(n, hh // k, ww // k, f)


def sconv(ctx: Ctx, name: str, x: torch.Tensor, features: int,
          kernel: int = 3, stride: int = 1, padding="SAME",
          kernel_init=he_normal_fan_out) -> torch.Tensor:
    """Sharable 2D conv (ref:models/layers.py SharableConv2d). NHWC/HWIO,
    output in the compute dtype. With a Masking whose `pallas_conv` is set
    and a piggymask present, the masked-conv kernel selects the weight. A
    non-overlapping patch embedding (kernel == stride, VALID, as in the ViT
    stems) runs as space-to-depth + one matmul, as `cpg_tpu` computes it."""
    cin = x.shape[-1]
    key = f"{name}/kernel"
    w = ctx.shared_param(key, (kernel, kernel, cin, features), kernel_init)
    mk = ctx.masking
    if mk is not None and ctx.mode != "init":
        own, pm = ctx.mask_entries(key)
        if mk.pallas_conv and pm is not None:
            from ..ops.masked_conv import masked_conv2d

            return masked_conv2d(x.to(ctx.compute_dtype).contiguous(), w, own,
                                 pm, mk.task_id, stride=stride,
                                 padding=padding, threshold=mk.threshold,
                                 mask_mode=mk.mask_mode)
        w = ctx.masked_weight(key, w)
    if (kernel == stride and kernel > 1 and padding == "VALID"
            and x.shape[1] % kernel == 0 and x.shape[2] % kernel == 0):
        return _patchify_dot(x.to(ctx.compute_dtype),
                             w.to(ctx.compute_dtype), kernel)
    pads = resolve_padding(padding, x.shape[1], x.shape[2], kernel, kernel,
                           stride)
    return conv2d_nhwc(x.to(ctx.compute_dtype), w.to(ctx.compute_dtype),
                       stride, pads)


def sdense(ctx: Ctx, name: str, x: torch.Tensor, features: int,
           use_bias: bool = True, kernel_init=normal_init(0.01)
           ) -> torch.Tensor:
    """Sharable dense layer (ref:models/layers.py SharableLinear) over any
    leading shape, output and bias add in the compute dtype. With a Masking
    whose `pallas_dense` is set and a piggymask present, the leading dims
    flatten to (M, K) and the masked-matmul kernels select the weight."""
    key = f"{name}/kernel"
    w = ctx.shared_param(key, (x.shape[-1], features), kernel_init)
    mk = ctx.masking
    if mk is not None and ctx.mode != "init":
        own, pm = ctx.mask_entries(key)
        if mk.pallas_dense and pm is not None:
            from ..ops.masked_matmul import masked_matmul

            x2 = x.reshape(-1, x.shape[-1]).to(ctx.compute_dtype).contiguous()
            y = masked_matmul(x2, w, own, pm, mk.task_id, mk.threshold,
                              mk.mask_mode).reshape(*x.shape[:-1], features)
            return _dense_bias(ctx, name, y, features, use_bias)
        w = ctx.masked_weight(key, w)
    y = x.to(ctx.compute_dtype) @ w.to(ctx.compute_dtype)
    return _dense_bias(ctx, name, y, features, use_bias)


def _dense_bias(ctx: Ctx, name: str, y: torch.Tensor, features: int,
                use_bias: bool) -> torch.Tensor:
    if not use_bias:
        return y
    b = ctx.private_param(f"{name}/bias", (features,), _zeros)
    return y + b.to(y.dtype)


BN_MOMENTUM = 0.1  # torch default: running = (1-m)*running + m*batch
BN_EPS = 1e-5


def _bn_moments(ctx: Ctx, name: str, x: torch.Tensor):
    """Register affine + running params; return (mean, var, scale, bias) for
    this call (batch stats in train, running stats in eval) and record the
    running-stat updates. Batch stats use the one-pass E[x^2] - mean^2."""
    c = x.shape[-1]
    scale = ctx.private_param(f"{name}/scale", (c,), _ones)
    bias = ctx.private_param(f"{name}/bias", (c,), _zeros)
    rmean, rvar = ctx.bn_running(name, (c,))
    if ctx.train:
        dims = tuple(range(x.dim() - 1))
        xf = x.float()
        mean = xf.mean(dims)
        var = torch.clamp_min(xf.square().mean(dims) - mean.square(), 0.0)
        n = math.prod(x.shape[d] for d in dims)
        unbiased = var * (n / max(n - 1, 1))
        ctx.new_bn_state[name + "/mean"] = (1 - BN_MOMENTUM) * rmean + BN_MOMENTUM * mean
        ctx.new_bn_state[name + "/var"] = (1 - BN_MOMENTUM) * rvar + BN_MOMENTUM * unbiased
    else:
        mean, var = rmean, rvar
        ctx.new_bn_state[name + "/mean"] = rmean
        ctx.new_bn_state[name + "/var"] = rvar
    return mean, var, scale, bias


def batchnorm(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm with task-private affine and running stats; f32 math,
    output in x's dtype."""
    mean, var, scale, bias = _bn_moments(ctx, name, x)
    y = (x.float() - mean) * torch.rsqrt(var + BN_EPS) * scale + bias
    return y.to(x.dtype)


def batchnorm_affine(ctx: Ctx, name: str, x: torch.Tensor):
    """BN folded to a per-channel affine (a, b) with BN(x) = a*x + b; same
    params and stats as `batchnorm`, nothing materialised."""
    mean, var, scale, bias = _bn_moments(ctx, name, x)
    a = torch.rsqrt(var + BN_EPS) * scale
    return a, bias - mean * a


def fused_bn_relu_sconv(ctx: Ctx, bn_name: str, conv_name: str,
                        x: torch.Tensor, features: int) -> torch.Tensor:
    """conv3x3(relu(BN(x))). Under `ctx.fused_chain` (outside init) this runs
    the fused kernel, the normalised activation never leaving shared memory;
    otherwise it is exactly the unfused composition. Same param names and
    registration order either way."""
    if not (ctx.fused_chain and ctx.mode != "init"):
        return sconv(ctx, conv_name, relu(batchnorm(ctx, bn_name, x)),
                     features, kernel=3, stride=1, padding="SAME")
    from ..ops.fused_chain import fused_affine_relu_conv

    a, b = batchnorm_affine(ctx, bn_name, x)
    key = f"{conv_name}/kernel"
    w = ctx.shared_param(key, (3, 3, x.shape[-1], features), he_normal_fan_out)
    if ctx.masking is not None:
        w = ctx.masked_weight(key, w)
    return fused_affine_relu_conv(x.contiguous(), a.contiguous(),
                                  b.contiguous(), w, ctx.compute_dtype)


LN_EPS = 1e-6


def layernorm(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with a task-private affine; two-pass f32
    moments, output in x's dtype."""
    c = x.shape[-1]
    scale = ctx.private_param(f"{name}/scale", (c,), _ones)
    bias = ctx.private_param(f"{name}/bias", (c,), _zeros)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS) * scale + bias
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU; gelu(0) == 0 exactly (the growth law needs a
    grown hidden unit to stay 0). On bf16 input torch evaluates in f32 and
    rounds once, where XLA rounds after each elementwise op."""
    return F.gelu(x, approximate="tanh")


def head(ctx: Ctx, name: str, x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Task-private classifier head, f32, initialised N(0, 0.01^2)."""
    w = ctx.private_param(f"{name}/kernel", (x.shape[-1], num_classes),
                          normal_init(0.01))
    b = ctx.private_param(f"{name}/bias", (num_classes,), _zeros)
    return x.float() @ w + b


def maxpool(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2/2 max pool, VALID."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def init(generator: torch.Generator, model_fn: Callable, sample_x,
         **kwargs) -> Tuple[Dict, Dict, Dict]:
    """(shared, private, bn_state) on the CPU, drawn from `generator`."""
    ctx = Ctx(mode="init", train=False, generator=generator)
    with torch.no_grad():
        model_fn(ctx, sample_x, **kwargs)
    return ctx.shared, ctx.private, ctx.bn_state


def apply(model_fn: Callable, shared: Dict, private: Dict, bn_state: Dict, x,
          train: bool, compute_dtype=torch.float32,
          masking: Optional[Masking] = None, fused_chain: bool = False,
          flash_attention: bool = False, **kwargs):
    """Run the model. With `masking=None`, `shared` holds pre-masked
    effective params; with a Masking, `shared` holds RAW weights."""
    ctx = Ctx(mode="apply", train=train, shared=shared, private=private,
              bn_state=bn_state, compute_dtype=compute_dtype,
              masking=masking, fused_chain=fused_chain,
              flash_attention=flash_attention)
    out = model_fn(ctx, x, **kwargs)
    return out, ctx.new_bn_state
