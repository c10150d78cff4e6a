"""Plain NHWC/HWIO convolution helpers shared by the layers and the kernels'
plain versions.

`resolve_padding` turns "SAME" into explicit pads the XLA way: total =
max((ceil(H/s) - 1) * s + k - H, 0), top = total // 2. That differs from
torch's symmetric `padding=k//2` at stride 2, so a strided conv here matches
`cpg_tpu`. `conv2d_nhwc` runs F.conv2d on the NCHW view of an NHWC tensor: the
view has channels-last strides, so on the card cuDNN reads it in place.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Pads = Tuple[int, int, int, int]  # (top, bottom, left, right)


def _same(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def resolve_padding(padding, h: int, w: int, kh: int, kw: int,
                    stride: int) -> Pads:
    """"SAME" | "VALID" | int | ((top, bottom), (left, right)) -> pads."""
    if padding == "SAME":
        return (*_same(h, kh, stride), *_same(w, kw, stride))
    if padding == "VALID":
        return (0, 0, 0, 0)
    if isinstance(padding, int):
        return (padding,) * 4
    (t, b), (l, r) = padding
    return (int(t), int(b), int(l), int(r))


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
                pads: Pads) -> torch.Tensor:
    """NHWC x, HWIO w -> NHWC y, in x's dtype (w must match it)."""
    t, b, l, r = pads
    xt = x.permute(0, 3, 1, 2)
    wt = w.permute(3, 2, 0, 1)
    if t == b and l == r:
        y = F.conv2d(xt, wt, stride=stride, padding=(t, l))
    else:
        y = F.conv2d(F.pad(xt, (l, r, t, b)), wt, stride=stride)
    return y.permute(0, 2, 3, 1)


def out_size(size: int, k: int, stride: int, lo: int, hi: int) -> int:
    return (size + lo + hi - k) // stride + 1


# The wgrad kernels (csrc/conv_bwd.cuh) split their reduction over output
# pixels across blocks: aim for this many blocks in flight, each split
# reducing at least _MIN_ROWS pixels; _BKO x _BNO is their output tile.
_TARGET_BLOCKS, _MIN_ROWS = 264, 256
_BKO, _BNO = 128, 64


def wgrad_splits(m_rows: int, k: int, cout: int) -> int:
    """Number of split-K partials for a weight gradient of shape (k, cout)
    reduced over m_rows output pixels."""
    tiles = -(-k // _BKO) * -(-cout // _BNO)
    want = max(1, -(-_TARGET_BLOCKS // tiles))
    return max(1, min(want, m_rows // _MIN_ROWS))
