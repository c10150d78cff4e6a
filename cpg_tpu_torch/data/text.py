"""Synthetic text-classification tasks (models/text.py family).

The port's copy of `cpg_tpu.data.text` (numpy only; the same RandomState
draws in the same order, so the arrays are bit-equal for a seed). A
deterministic generator with learnable class structure, as
data/cifar.synthetic_cifar100:
each class draws tokens from a class-specific multinomial (a preferred
subset of the vocabulary) mixed with uniform noise; a transformer separates
classes from token statistics in a few epochs, and `order_frac` optionally
plants class-oriented token pairs (identical marginals, class-dependent
order) so causal attention has something positional to learn.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_text_task(seed: int, num_classes: int = 4, vocab: int = 256,
                        seq_len: int = 64, n_train: int = 512,
                        n_test: int = 128, noise: float = 0.5,
                        order_frac: float = 0.0):
    """One task: {train_x/train_y/test_x/test_y/num_classes}, tokens int32.

    `order_frac > 0` overwrites ~order_frac of each sequence with adjacent
    ORIENTED pairs from a reserved band at the top of the vocab: pair j is
    the token pair (vocab-2j-2, vocab-2j-1), and bit j of the class id
    decides which of the two comes first. Both tokens of a pair appear
    equally often for every class — the token MARGINALS carry no class
    signal, only the within-pair order does — so bag-of-tokens pooling
    can't exploit it but causal/positional attention can. order_frac=0.0
    (default) draws no extra randoms: output is bit-identical to the
    pre-order_frac generator."""
    rng = np.random.RandomState(seed)
    n_bits = max(1, int(np.ceil(np.log2(max(num_classes, 2)))))
    if order_frac > 0 and vocab < 2 * n_bits + 8:
        raise ValueError(f"vocab {vocab} too small for {n_bits} ordered "
                         "pairs plus class token subsets")
    # each class prefers a random 8-token subset of the vocab. When the
    # ordered-pair channel is on, the reserved top-of-vocab pair band is
    # EXCLUDED from the subsets — a preferred pair token would put class
    # signal back into the marginals, breaking the documented
    # "only order carries class signal" property. With
    # order_frac=0 the full vocab keeps the stream bit-identical to the
    # pre-order_frac generator (same draw count, same bounds).
    prefer_hi = vocab - 2 * n_bits if order_frac > 0 else vocab
    prefer = np.stack([rng.choice(prefer_hi, 8, replace=False)
                       for _ in range(num_classes)])
    pair_a = vocab - 2 - 2 * np.arange(n_bits)
    pair_b = vocab - 1 - 2 * np.arange(n_bits)

    def make(n):
        y = rng.randint(0, num_classes, n).astype(np.int32)
        pick = rng.rand(n, seq_len) >= noise
        toks = np.where(
            pick,
            prefer[y][np.arange(n)[:, None],
                      rng.randint(0, 8, (n, seq_len))],
            rng.randint(0, vocab, (n, seq_len)),
        ).astype(np.int32)
        if order_frac > 0:
            k = max(1, int(seq_len * order_frac / 2))
            for i in range(n):
                slots = rng.choice(seq_len // 2, k, replace=False)
                js = rng.randint(0, n_bits, k)
                bits = (y[i] >> js) & 1
                toks[i, 2 * slots] = np.where(bits == 0,
                                              pair_a[js], pair_b[js])
                toks[i, 2 * slots + 1] = np.where(bits == 0,
                                                  pair_b[js], pair_a[js])
        return toks, y

    tx, ty = make(n_train)
    vx, vy = make(n_test)
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy,
            "num_classes": num_classes}


def text_task_splits(n_tasks: int = 4, seed: int = 0, **kwargs
                     ) -> Dict[str, Dict]:
    return {f"text{t:02d}": synthetic_text_task(seed + 31 * t, **kwargs)
            for t in range(1, n_tasks + 1)}
