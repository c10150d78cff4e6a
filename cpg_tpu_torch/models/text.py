"""Sharable text-classification transformer (`textcls`).

Same layer names, shapes and math as `cpg_tpu.models.text`: the token
embedding table is a sharable kernel (`framework.sembed`: its vocab rows
are owned, pruned and picked like any kernel), the blocks are the ViT's
(models/vit.py: sharable q/k/v/proj and MLP kernels, task-private
LayerNorms; the same growth law, embed dim fixed, new heads and MLP units),
and the positional embedding and head are task-private. Tokens (N, T) ->
logits (N, C); `causal=True` masks attention to tokens <= t.

The "tokens" seams sit where `cpg_tpu` has them (after the positional
embedding, at every block boundary; models/vit.py), and one more on the
ids: the lookup is per token, so under `act_sharder` each rank embeds its
own rows (the table's and the positions' gradients summed over the model
group) and no rank runs torch's embedding backward, whose sums of
repeated ids need not give two ranks the same bits, on the whole batch.
Left out from `cpg_tpu`: `scan_blocks`, as for the ViT.
"""

from __future__ import annotations

from .framework import Ctx, head, layernorm, normal_init, sembed
from .vit import _heads, vit_block

DEPTH, DIM, HEADS, VOCAB = 4, 128, 4, 256


def textcls(ctx: Ctx, tokens, num_classes: int, mult: float = 1.0,
            depth: int = DEPTH, dim: int = DIM, heads: int = HEADS,
            vocab: int = VOCAB, causal: bool = False):
    """tokens: (N, T) int -> logits (N, num_classes). The embedding plus
    the f32 positions is rounded once to the compute dtype; the mean over
    T is taken in f32."""
    t = tokens.shape[1]
    head_dim = dim // heads
    heads_n = _heads(heads, mult)
    hidden = max(1, int(dim * 4 * mult))
    x = sembed(ctx, "embed", ctx.constrain(tokens, "tokens"), vocab, dim)
    pos = ctx.private_param("embed/pos", (t, dim), normal_init(0.02))
    x = ctx.constrain((x + ctx.token_rows(pos)).to(ctx.compute_dtype),
                      "tokens")
    for i in range(depth):
        x = vit_block(ctx, x, heads_n, head_dim, hidden, causal=causal,
                      prefix=f"blocks/{i}/")
        x = ctx.constrain(x, "tokens")
    x = layernorm(ctx, "norm", x)
    return head(ctx, "classifier", ctx.whole_tokens(x).float().mean(1),
                num_classes)
