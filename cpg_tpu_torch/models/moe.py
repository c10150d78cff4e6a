"""Sharable Mixture-of-Experts (`smoe`, `vit_moe_cifar`).

Same layer names, shapes and math as `cpg_tpu.models.moe`:

  * top-1 token-choice routing with a fixed capacity per expert, all in
    static shapes: one-hot dispatch and combine products, no sort;
  * routing and capacity are per example (a cumsum over each example's own
    tokens), so a token's output never depends on what shares its batch;
  * the stacked expert kernels (E, D, F) and (E, F, D) are ordinary
    sharable kernels, selected by `masked_weight`;
  * growth adds whole experts: (E, D, F) -> (E', D, F), the old experts in
    the leading block (core/grow.py); the router is task-private, its
    kernel padded with 0 and its `gate_bias` with -1e9, so an old task can
    never route to a grown expert and exp(-1e9 - max) is exactly 0.0 in
    f32: old-task outputs stay bit-identical;
  * the capacity comes from the BASE expert count, never from E, so old
    experts drop the same tokens at any width.

The expert products are plain einsums (`cpg_tpu` leaves them to XLA; no
Pallas kernel). Under a model axis (`ctx.shards`) stacked kernels split
along their experts take each rank's experts' slots of the dispatched
tokens, run both products on them and gather the experts' outputs before
the combine; kernels split along their last axis (when the experts do not
divide) gather each product's output, as `sdense`.

The seams sit where `cpg_tpu` has them. Under `act_sharder` the "tokens"
seams split the stream as in models/vit.py; `smoe` gathers its input's
tokens whole (the capacity counts an example's tokens in order), routes
and dispatches them whole on every rank of the model group and returns
this rank's rows. The "experts" seam on the dispatched tokens gives each
rank its experts' slots (of replicated kernels, its experts of them) and
the experts' outputs are gathered before the combine.
"""

from __future__ import annotations

import math

import torch

from ..parallel.collectives import (gather_from_model_group, split_tokens,
                                    to_model_group)
from .framework import (Ctx, _zeros, gelu, head, layernorm, normal_init,
                        sconv, xavier_normal)
from .vit import _heads, attention, mlp


def _expert_init(gen, shape, dtype=torch.float32):
    """Xavier-normal per expert for stacked (E, fan_in, fan_out) kernels."""
    std = math.sqrt(2.0 / (shape[-2] + shape[-1]))
    return torch.randn(tuple(shape), generator=gen, dtype=dtype) * std


def capacity(t: int, n_experts_base: int, capacity_factor: float) -> int:
    """Tokens an expert takes per example: ceil(T / base experts x
    factor), at least 1."""
    return max(1, int(math.ceil(t / n_experts_base * capacity_factor)))


def route(x, wr, br, n_cap: int):
    """Top-1 routing of (N, T, D) tokens in f32: (gate (N, T), the expert
    one-hot (N, T, E), the capacity slot one-hot (N, T, C)). The choice is
    the first maximal probability (jnp.argmax); a token past its expert's
    capacity gets an all-zero slot row (jax.nn.one_hot of an index >= C),
    so it is dropped and the residual carries it."""
    probs = torch.softmax(torch.einsum("ntd,de->nte", x.float(), wr) + br,
                          dim=-1)
    gate = probs.amax(-1)
    choice = probs.argmax(-1)
    e = probs.shape[-1]
    onehot = (choice[..., None] == torch.arange(e, device=x.device)).float()
    # position of each token in its expert's queue, per example
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1.0
    slot = (pos.long()[..., None]
            == torch.arange(n_cap, device=x.device)).float()
    return gate, onehot, slot


def smoe(ctx: Ctx, name: str, x, n_experts_base: int, hidden: int,
         mult: float = 1.0, capacity_factor: float = 1.25):
    """Sharable MoE FFN over (N, T, D): E = max(1, int(base * mult))
    experts, each a gelu MLP D -> hidden -> D. Router (task-private, f32):
    logits = x @ W_r + b_r. Tokens over capacity give 0. The combine sums
    in f32, the gate multiplies in f32, then the result takes x's dtype.
    On this rank's rows of a split token stream, every token on every
    rank of the model group, and this rank's rows out."""
    rows = ctx.rows(x)
    x = ctx.whole_tokens(x)
    n, t, d = x.shape
    e = max(1, int(n_experts_base * mult))
    cap = capacity(t, n_experts_base, capacity_factor)
    wr = ctx.private_param(f"{name}/router/kernel", (d, e), normal_init(0.02))
    br = ctx.private_param(f"{name}/router/gate_bias", (e,), _zeros)
    gate, onehot, slot = route(x, wr, br, cap)
    disp = (onehot[..., None] * slot[:, :, None, :]).to(ctx.compute_dtype)

    def kernel(key):
        shape = ((e, d, hidden) if key.endswith("fc1/kernel")
                 else (e, hidden, d))
        w = ctx.shared_param(key, shape, _expert_init)
        if ctx.masking is not None and ctx.mode != "init":
            w = ctx.masked_weight(key, w)
        if ctx.quant_scales is not None and key in ctx.quant_scales:
            # int8 serving: dequantize (one scale per output feature,
            # shared across experts) and run in the compute dtype
            w = w.float() * ctx.quant_scales[key]
        return w.to(ctx.compute_dtype)

    k1, k2 = f"{name}/experts/fc1/kernel", f"{name}/experts/fc2/kernel"
    w1, w2 = kernel(k1), kernel(k2)
    xe = torch.einsum("ntec,ntd->necd", disp, x.to(ctx.compute_dtype))
    spec = ctx.shards.get(k1)
    part = spec if spec is not None and spec.axis == 0 else ctx.seam(
        xe, "experts")
    if part is not None:  # this rank's whole experts
        # the "experts" seam; kernels split by expert hold this rank's
        # experts, and so does the seam's split of replicated ones
        xe = split_tokens(xe, part.group)
        if part is not spec:
            w1, w2 = (to_model_group(w, part.group).narrow(
                0, part.index * part.width, part.width) for w in (w1, w2))
        he = gelu(torch.einsum("necd,edf->necf", xe, w1))
        # `cpg_tpu`'s second "experts" seam: whole before the combine
        ye = gather_from_model_group(torch.einsum("necf,efd->necd", he, w2),
                                     part.group, 1)
    else:
        he = gelu(ctx.out_of_shard(k1, torch.einsum(
            "necd,edf->necf", ctx.into_shard(k1, xe), w1)))
        ye = ctx.out_of_shard(k2, torch.einsum(
            "necf,efd->necd", ctx.into_shard(k2, he), w2))
    y = torch.einsum("ntec,necd->ntd", disp.float(), ye.float())
    y = (y * gate[..., None]).to(x.dtype)
    return y if rows is None else split_tokens(y, rows.group)


def vit_moe_cifar(ctx: Ctx, x, num_classes: int, mult: float = 1.0,
                  depth: int = 6, dim: int = 256, heads: int = 4,
                  patch: int = 4, mlp_ratio: int = 4, n_experts: int = 4,
                  capacity_factor: float = 1.25):
    """ViT for 32x32 inputs with an MoE FFN on every odd block. Heads and
    the dense MLPs grow by models/vit.py's law; the MoE grows by whole
    experts, each of fixed hidden width dim * mlp_ratio."""
    head_dim = dim // heads
    heads_n = _heads(heads, mult)
    hidden = max(1, int(dim * mlp_ratio * mult))
    x = sconv(ctx, "patch/proj", x, dim, kernel=patch, stride=patch,
              padding="VALID", kernel_init=xavier_normal)
    n, t = x.shape[0], x.shape[1] * x.shape[2]
    pos = ctx.private_param("patch/pos_embed", (t, dim), normal_init(0.02))
    x = ctx.constrain((x.reshape(n, t, dim) + pos).to(ctx.compute_dtype),
                      "tokens")
    for i in range(depth):
        x = x + attention(ctx, f"blocks/{i}/attn",
                          layernorm(ctx, f"blocks/{i}/ln1", x),
                          heads_n, head_dim)
        xn = layernorm(ctx, f"blocks/{i}/ln2", x)
        if i % 2 == 1:
            x = x + smoe(ctx, f"blocks/{i}/moe", xn, n_experts,
                         dim * mlp_ratio, mult, capacity_factor)
        else:
            x = x + mlp(ctx, f"blocks/{i}/mlp", xn, hidden)
        x = ctx.constrain(x, "tokens")
    x = layernorm(ctx, "norm", x)
    return head(ctx, "classifier", ctx.whole_tokens(x).float().mean(1),
                num_classes)
