"""Sharable Vision Transformer (`vit_cifar`, `vit_b16`).

Same layer names, shapes and math as `cpg_tpu.models.vit`: every q/k/v/proj
and MLP kernel is a sharable dense kernel (`sdense`), the patch embedding is
a sharable conv, and the LayerNorm affines, positional embedding and head
are task-private. Activations are (N, T, D) in the compute dtype, with f32
LayerNorm moments and f32 attention scores and softmax.

Attention runs one of two ways, the same math:
  * default: the scores (N, H, T, T) are materialised in f32 (q and k are
    cast to f32 first, so a bf16 product is exact, as JAX's einsum with
    preferred_element_type=f32 gives it), softmax in f32, probabilities
    cast to the compute dtype before P.V;
  * `ctx.flash_attention` (outside init and int8): the flash kernels of
    ops/flash.py, where the scores never reach device memory.

Left out from `cpg_tpu`: `qkv_fused`, `scan_blocks`/`scan_vit_blocks`, the
`pipeline` hook and `act_sharder` seams (XLA and mesh levers, all off by
default there); the port's Ctx has no such fields.
"""

from __future__ import annotations

import torch

from .framework import (Ctx, gelu, head, layernorm, normal_init, sconv,
                        sdense, xavier_normal)


def _heads(heads: int, mult: float) -> int:
    return max(1, int(heads * mult))


def attention(ctx: Ctx, name: str, x, heads_n: int, head_dim: int,
              causal: bool = False):
    """Multi-head self-attention over (N, T, D) with sharable q/k/v/proj;
    `causal=True` lets token t attend to tokens <= t only."""
    n, t, d = x.shape
    inner = heads_n * head_dim
    q, k, v = (sdense(ctx, f"{name}/{p}", x, inner, kernel_init=xavier_normal)
               .reshape(n, t, heads_n, head_dim) for p in "qkv")
    if (ctx.flash_attention and ctx.mode != "init"
            and ctx.quant_scales is None):
        from ..ops.flash import flash_mha

        out = flash_mha(q, k, v, causal=causal)
    else:
        scores = torch.einsum("nthd,nshd->nhts", q.float(), k.float())
        scores = scores * (1.0 / head_dim ** 0.5)
        if causal:
            tri = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
            scores = torch.where(tri, scores, -1e30)
        att = torch.softmax(scores, dim=-1).to(ctx.compute_dtype)
        # under int8, v arrives in f32: XLA's mixed product rounds it to
        # the probabilities' dtype first
        out = torch.einsum("nhts,nshd->nthd", att, v.to(att.dtype))
    return sdense(ctx, f"{name}/proj", out.reshape(n, t, inner), d,
                  kernel_init=xavier_normal)


def mlp(ctx: Ctx, name: str, x, hidden: int):
    d = x.shape[-1]
    h = gelu(sdense(ctx, f"{name}/fc1", x, hidden, kernel_init=xavier_normal))
    return sdense(ctx, f"{name}/fc2", h, d, kernel_init=xavier_normal)


def vit_block(ctx: Ctx, x, heads_n: int, head_dim: int, hidden: int,
              causal: bool = False, prefix: str = ""):
    """One pre-LN encoder block; param names `{prefix}attn/...`,
    `{prefix}ln1/...`, `{prefix}mlp/...`, `{prefix}ln2/...`."""
    x = x + attention(ctx, f"{prefix}attn", layernorm(ctx, f"{prefix}ln1", x),
                      heads_n, head_dim, causal=causal)
    return x + mlp(ctx, f"{prefix}mlp", layernorm(ctx, f"{prefix}ln2", x),
                   hidden)


def vit_cifar(ctx: Ctx, x, num_classes: int, mult: float = 1.0,
              depth: int = 6, dim: int = 256, heads: int = 4,
              patch: int = 4, mlp_ratio: int = 4):
    """ViT for 32x32 inputs. x: (N, 32, 32, 3) NHWC -> logits. Pre-LN
    blocks, mean-pooled tokens (no CLS token); the width multiplier scales
    the heads and the MLP hidden units, the embed dim stays fixed."""
    head_dim = dim // heads
    heads_n = _heads(heads, mult)
    hidden = max(1, int(dim * mlp_ratio * mult))
    x = sconv(ctx, "patch/proj", x, dim, kernel=patch, stride=patch,
              padding="VALID", kernel_init=xavier_normal)
    n, t = x.shape[0], x.shape[1] * x.shape[2]
    pos = ctx.private_param("patch/pos_embed", (t, dim), normal_init(0.02))
    x = (x.reshape(n, t, dim) + pos).to(ctx.compute_dtype)
    for i in range(depth):
        x = vit_block(ctx, x, heads_n, head_dim, hidden,
                      prefix=f"blocks/{i}/")
    x = layernorm(ctx, "norm", x)
    return head(ctx, "classifier", x.float().mean(1), num_classes)


def dense_outputs(mult: float, dim: int, heads: int, mlp_ratio: int = 4):
    """The output widths of a transformer's sharable dense layers at a
    width (vit_cifar, vit_b16, textcls, vit_moe_cifar, whose experts run no
    dense layer): q/k/v (the heads), proj and fc2 (dim), fc1 (the MLP's
    hidden units)."""
    return [_heads(heads, mult) * (dim // heads), dim,
            max(1, int(dim * mlp_ratio * mult))]


def vit_b16(ctx: Ctx, x, num_classes: int, mult: float = 1.0):
    """ViT-B/16 at 224x224 (depth 12, dim 768, 12 heads; T = 196)."""
    return vit_cifar(ctx, x, num_classes, mult, depth=12, dim=768, heads=12,
                     patch=16)
