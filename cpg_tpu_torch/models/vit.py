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

With `ctx.qkv_fused` (off by default, as in `cpg_tpu`), q, k and v come
from one product on the effective-params path of a whole state; under a
model axis (`ctx.shards`) the three products run, each gathered.

The "tokens" seams sit where `cpg_tpu` has them: after the positional
embedding and at every block boundary. Under `act_sharder` the stream
between them is this rank's T/M tokens; attention gathers its normalised
input whole, forms q, k and v and runs softmax(qk^T)v (K7 under
`flash_attention`) at whole T on every rank of the model group, and
takes this rank's rows before `proj` (after it when `proj`'s kernel is
split); the mean pool gathers the tokens again (models/framework.py).
`ctx.pipeline` runs the block stack as a GPipe over stage ranks
(parallel/pipeline.py), as `cpg_tpu`'s pipeline branch.

Left out from `cpg_tpu`: `scan_blocks`/`scan_vit_blocks` (an XLA lever).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import split_tokens
from .framework import (Ctx, _zeros, gelu, head, layernorm, normal_init,
                        sconv, sdense, xavier_normal)


def _heads(heads: int, mult: float) -> int:
    return max(1, int(heads * mult))


def attention(ctx: Ctx, name: str, x, heads_n: int, head_dim: int,
              causal: bool = False):
    """Multi-head self-attention over (N, T, D) with sharable q/k/v/proj;
    `causal=True` lets token t attend to tokens <= t only. On this rank's
    rows of a split token stream, every token on every rank of the model
    group, and this rank's rows out."""
    rows = ctx.rows(x)
    x = ctx.whole_tokens(x)
    n, t, d = x.shape
    inner = heads_n * head_dim
    if (ctx.qkv_fused and ctx.mode != "init" and ctx.masking is None
            and ctx.quant_scales is None and not ctx.shards):
        # one (D, 3*inner) product of the concatenated effective kernels;
        # they stay separate params, so autograd splits the gradient back
        ws = [ctx.shared_param(f"{name}/{p}/kernel", (d, inner),
                               xavier_normal) for p in "qkv"]
        bs = [ctx.private_param(f"{name}/{p}/bias", (inner,), _zeros)
              for p in "qkv"]
        w3 = torch.cat(ws, 1).to(ctx.compute_dtype)
        qkv = x.to(ctx.compute_dtype) @ w3
        qkv = qkv + torch.cat(bs).to(qkv.dtype)
        q, k, v = (qkv[..., i * inner:(i + 1) * inner]
                   .reshape(n, t, heads_n, head_dim) for i in range(3))
    else:
        q, k, v = (sdense(ctx, f"{name}/{p}", x, inner,
                          kernel_init=xavier_normal)
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
    out = out.reshape(n, t, inner)
    proj = f"{name}/proj"
    if rows is None:
        return sdense(ctx, proj, out, d, kernel_init=xavier_normal)
    if f"{proj}/kernel" in ctx.shards:  # a split product takes every token
        return split_tokens(sdense(ctx, proj, out, d,
                                   kernel_init=xavier_normal), rows.group)
    return sdense(ctx, proj, split_tokens(out, rows.group), d,
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
    x = ctx.constrain(x, "tokens")
    if ctx.pipeline is not None and ctx.mode == "apply":
        # the stages select no weight and hold whole kernels
        if (ctx.masking is not None or ctx.quant_scales is not None
                or ctx.shards):
            raise ValueError("pipeline requires the default effective-"
                             "params path (no Masking / int8 serving / "
                             "split kernels)")
        x = ctx.pipeline({**ctx.shared, **ctx.private}, ctx.whole_tokens(x),
                         dict(heads_n=heads_n, head_dim=head_dim,
                              hidden=hidden), ctx.compute_dtype)
        x = ctx.constrain(x, "tokens")
    else:
        for i in range(depth):
            x = vit_block(ctx, x, heads_n, head_dim, hidden,
                          prefix=f"blocks/{i}/")
            x = ctx.constrain(x, "tokens")
    x = layernorm(ctx, "norm", x)
    return head(ctx, "classifier", ctx.whole_tokens(x).float().mean(1),
                num_classes)


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
