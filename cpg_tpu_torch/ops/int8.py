"""int8 x int8 -> int32 products for int8 serving.

`cpg_tpu` runs its int8 convs and matmuls as XLA ops
(`lax.conv_general_dilated` and `jnp.dot` with an int32 accumulator), not
as Pallas kernels, so this module is a library route, not a port of a TPU
kernel. On the card the product is `torch._int_mm` (cuBLASLt's integer
tensor-core GEMM): exact, since every partial sum of int8 products stays
far inside int32 (K * 127 * 127 < 2^31 for K < 133,000). A convolution is
an NHWC patch gather of the int8 activation (torch indexing: one pad and
one strided copy; the quantized zero is exactly 0, so SAME padding fills
0) times the HWIO weight flattened to (kh * kw * Cin, Cout), the patch
order (kh, kw, cin) being HWIO's row-major flatten. The copy moves each
pixel's channels in 8-, 4- or 2-byte words where Cin allows.

`_int_mm` takes M > 16 and K, N multiples of 8, with the second operand
column-major: the wrapper pads M, K and N with zero rows and columns
(exact) and slices the result. A CPU tensor takes the plain version, the
exact integer product over the same operands (`int_mm_plain`); a CUDA
tensor takes `_int_mm` or raises. `LAUNCHES` counts the `_int_mm` calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import out_size

LAUNCHES = 0


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric int8 scale of a max |x|: max(amax, 1e-8) / 127, as XLA
    compiles `cpg_tpu`'s division by the constant 127 (a multiply by its
    f32 reciprocal), so scales match its serving program bit for bit."""
    return torch.clamp_min(amax.float(), 1e-8) * (1.0 / 127.0)


def quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(x / s), -127, 127) as int8: a true division, rounding
    half to even."""
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def int_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, the exact integer
    product on any device: accumulated in f64, where every partial sum of
    int8 products is an integer below 2^53 (K * 127 * 127 < 2^53), so no
    sum rounds (the card has no int32 matmul)."""
    return (a.double() @ b.double()).to(torch.int32)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact."""
    global LAUNCHES
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int_mm takes int8 operands, got {a.dtype}, {b.dtype}")
    if a.device.type == "cpu":
        return int_mm_plain(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"int_mm: no route for device {a.device}")
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(_up(m, 8), 32), _up(k, 8), _up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    # the second operand column-major: (N, K) rows, viewed as (K, N)
    bt = F.pad(b.t(), (0, kp - k, 0, np_ - n))
    y = torch._int_mm(a.contiguous(), bt.contiguous().t())
    LAUNCHES += 1
    return y[:m, :n]


_UNITS = ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2),
          (torch.int8, 1))


def patches(xq: torch.Tensor, kh: int, kw: int, stride: int,
            pads) -> torch.Tensor:
    """NHWC x -> (N * Ho * Wo, kh * kw * C) rows, zero-padded by `pads`
    (top, bottom, left, right); the column order is (kh, kw, c)."""
    t, b, l, r = pads
    if t or b or l or r:
        xq = F.pad(xq, (0, 0, l, r, t, b))
    n, h, w, c = xq.shape
    ho = out_size(h, kh, stride, 0, 0)
    wo = out_size(w, kw, stride, 0, 0)
    # copy each pixel's channels in the widest unit that divides them:
    # the strided copy then moves 8-byte words instead of bytes
    unit, size = next((d, k) for d, k in _UNITS if c % k == 0)
    xv = xq.contiguous().view(unit)
    sn, sh, sw, sc = xv.stride()
    view = xv.as_strided((n, ho, wo, kh, kw, c // size),
                         (sn, stride * sh, stride * sw, sh, sw, sc))
    return view.reshape(n * ho * wo, kh * kw * c // size).view(torch.int8)


def conv2d_int8(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                pads) -> torch.Tensor:
    """NHWC int8 x, HWIO int8 w -> NHWC int32 y."""
    kh, kw, cin, cout = wq.shape
    n = xq.shape[0]
    p = patches(xq.contiguous(), kh, kw, stride, pads)
    y = int_mm(p, wq.reshape(kh * kw * cin, cout))
    ho = out_size(xq.shape[1], kh, stride, pads[0], pads[1])
    wo = out_size(xq.shape[2], kw, stride, pads[2], pads[3])
    return y.reshape(n, ho, wo, cout)


def matmul_int8(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int32."""
    y = int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    return y.reshape(*xq.shape[:-1], wq.shape[-1])
