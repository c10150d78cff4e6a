"""Image preprocessing on the device (uint8 NHWC in, f32 out).

Same math as `cpg_tpu.data.augment`: eval is x / 255, then per-channel
(x - mean) / std; CIFAR training first takes a zero-pad-4 random crop and a
random horizontal flip per sample (the fine-grained 224-px images a pad-16
one, with ImageNet statistics). The crop indexes the raw 0..255 values, so
it is exact. Face crops (112x96) are scaled (x - 127.5) / 128, and in
training flipped at random, uncropped.

The random draws come from an explicit `torch.Generator`, or are handed in
as arrays: `rng` may be a `(offsets, flips)` pair, offsets (N, 2) integers
in [0, 2*pad] (row, column) and flips (N,) booleans (the face augment:
the flips alone), so a test can give the port `cpg_tpu`'s own draws. In
data-parallel training `rng` is a `Rows`: the draws of the global batch,
of which each rank keeps its rows, so the ranks together augment exactly
as one process would.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Rows:
    """`rng`'s draws for a global batch of `n` rows, of which this rank's
    batch is `rows`."""

    rng: object
    n: int
    rows: slice


# CIFAR-100 channel statistics (torchvision convention)
CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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


def _crop_flips(rng, n: int, pad: int):
    """(offsets, flips) for n rows: drawn from a generator, this rank's
    rows of the global draws from a `Rows`, else `rng` itself (injected
    draws)."""
    if isinstance(rng, Rows):
        offs, flips = _crop_flips(rng.rng, rng.n, pad)
        return offs[rng.rows], flips[rng.rows]
    if isinstance(rng, torch.Generator):
        return crop_flip_draws(n, rng, pad)
    return rng


def random_crop_flip(x: torch.Tensor, rng, pad: int) -> torch.Tensor:
    """Per-sample zero-pad random crop + horizontal flip. x: (N,H,W,C)."""
    n, h, w, _ = x.shape
    offs, flips = _crop_flips(rng, n, pad)
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


def imagenet_train_augment(x_uint8: torch.Tensor, rng,
                           pad: int = 16) -> torch.Tensor:
    """The fine-grained 224-px path: pad-crop, horizontal flip, then
    ImageNet normalisation."""
    x = random_crop_flip(x_uint8.to(torch.float32), rng, pad=pad) / 255.0
    return normalize(x, IMAGENET_MEAN, IMAGENET_STD)


def imagenet_eval_preprocess(x_uint8: torch.Tensor) -> torch.Tensor:
    return normalize(x_uint8.to(torch.float32) / 255.0, IMAGENET_MEAN,
                     IMAGENET_STD)


def _face_flips(rng, n: int):
    if isinstance(rng, Rows):
        return _face_flips(rng.rng, rng.n)[rng.rows]
    if isinstance(rng, torch.Generator):
        return torch.randint(0, 2, (n,), generator=rng,
                             device=rng.device).bool()
    return rng


def face_train_augment(x_uint8: torch.Tensor, rng) -> torch.Tensor:
    """Face crops: (x - 127.5) / 128 and a random horizontal flip per
    sample (`rng`: a torch.Generator, or the (N,) flips)."""
    x = (x_uint8.to(torch.float32) - 127.5) / 128.0
    n = x.shape[0]
    flips = _face_flips(rng, n)
    flips = torch.as_tensor(flips, device=x.device).bool().reshape(n, 1, 1, 1)
    return torch.where(flips, x.flip(2), x)


def face_eval_preprocess(x_uint8: torch.Tensor) -> torch.Tensor:
    return (x_uint8.to(torch.float32) - 127.5) / 128.0


AUGMENTS = {
    "cifar": (cifar_train_augment, cifar_eval_preprocess),
    "imagenet": (imagenet_train_augment, imagenet_eval_preprocess),
    "face": (face_train_augment, face_eval_preprocess),
}
