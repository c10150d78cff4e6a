"""Image preprocessing on the device (uint8 NHWC in, f32 out).

Same math as `cpg_tpu.data.augment`: eval is x / 255, then per-channel
(x - mean) / std; CIFAR training first takes a zero-pad-4 random crop and a
random horizontal flip per sample. The crop indexes the raw 0..255 values,
so it is exact.

The random draws come from an explicit `torch.Generator`, or are handed in
as arrays: `rng` may be a `(offsets, flips)` pair, offsets (N, 2) integers
in [0, 2*pad] (row, column) and flips (N,) booleans, so a test can give the
port `cpg_tpu`'s own draws.
"""

from __future__ import annotations

import torch

# CIFAR-100 channel statistics (torchvision convention)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)


def normalize(x_f32: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=torch.float32, device=x_f32.device)
    s = torch.tensor(std, dtype=torch.float32, device=x_f32.device)
    return (x_f32 - m) / s


def crop_flip_draws(n: int, generator: torch.Generator, pad: int):
    """(offsets (N, 2) int64, flips (N,) bool) drawn from `generator`."""
    offs = torch.randint(0, 2 * pad + 1, (n, 2), generator=generator,
                         device=generator.device)
    flips = torch.randint(0, 2, (n,), generator=generator,
                          device=generator.device).bool()
    return offs, flips


def random_crop_flip(x: torch.Tensor, rng, pad: int) -> torch.Tensor:
    """Per-sample zero-pad random crop + horizontal flip. x: (N,H,W,C)."""
    n, h, w, _ = x.shape
    offs, flips = (crop_flip_draws(n, rng, pad)
                   if isinstance(rng, torch.Generator) else rng)
    offs = torch.as_tensor(offs, device=x.device).long()
    flips = torch.as_tensor(flips, device=x.device).bool().reshape(n)
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    rows = offs[:, 0, None] + torch.arange(h, device=x.device)   # (N, H)
    cols = offs[:, 1, None] + torch.arange(w, device=x.device)   # (N, W)
    cols = torch.where(flips[:, None], cols.flip(1), cols)
    idx = torch.arange(n, device=x.device)[:, None, None]
    return xp[idx, rows[:, :, None], cols[:, None, :]]


def cifar_train_augment(x_uint8: torch.Tensor, rng) -> torch.Tensor:
    """Pad-4 random crop, horizontal flip, then CIFAR-100 normalisation."""
    x = random_crop_flip(x_uint8.to(torch.float32), rng, pad=4) / 255.0
    return normalize(x, CIFAR100_MEAN, CIFAR100_STD)


def cifar_eval_preprocess(x_uint8: torch.Tensor) -> torch.Tensor:
    return normalize(x_uint8.to(torch.float32) / 255.0, CIFAR100_MEAN,
                     CIFAR100_STD)
