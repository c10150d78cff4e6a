"""Fused BN-affine + ReLU + 3x3 conv — the cross-layer chain, forward and
backward.

    y = conv3x3_same(relu(a * x + b), w)

with (a, b) the folded BatchNorm affine. `fused_affine_relu_conv` is the
counterpart of `cpg_tpu.ops.pallas.fused_chain.fused_affine_relu_conv` and
its `custom_vjp`: a `torch.autograd.Function` that saves x, a, b and w (not
the activation) and returns dx in x's dtype and da, db, dW in f32.

On CUDA tensors it launches hand-written kernels, in which the normalised
activation never reaches device memory: K4 (`csrc/fused_chain_fwd.cu`, y),
K5 (`csrc/fused_chain_bwd_dx.cu`: dx, and da, db from per-tile partials
summed in tile order; the ReLU mask recomputed from x in the epilogue) and
K6 (`csrc/fused_chain_bwd_dw.cu`: dW with relu(a*x+b) recomputed in the
operand load). K4 and K5 each take one of three routes, named by
`fwd_route` and `dx_route` before any launch:

* "gemm": bf16 seams with Cin and Cout multiples of 64 on a grid that
  `masked_conv.conv_box` tiles (every VGG16-BN seam at width 1.0, and the
  64-channel seams at width 0.125): TMA + wgmma implicit GEMMs. K4 loads
  the halo of raw x a 64-channel block, activates it once in shared memory
  and runs the nine taps as wgmma with A from registers
  (`masked_matmul.fused_fwd_plan`; the halo tiles must fit, which a 1x1
  grid's do not); K5 is the conv GEMM's CONV_DGRAD walk over g's boxes and
  the seam's weight with K5's epilogue (`masked_matmul.fused_dx_plan`).
* "im2col": the same seams on any other grid (ResNet-50's 56, 28, 14 and
  7-pixel seams), whose 128-pixel tiles start mid-row and cross images.
  K4 is the same kernel on such tiles: its halo is the rows of one image a
  tile touches, and a second box where it runs into the next image, or
  whole images (`masked_matmul.fused_fwd_halo`). K5 is the conv GEMM's
  im2col walk (the stride-1 dgrad's one phase over g) with K5's epilogue
  (`masked_matmul.fused_dx_im2col_plan`).
* None, every other shape (f32, narrow widths): the earlier kernels (K4
  stages the activation in shared memory with mma.sync; K5 is
  conv_bwd.cuh's dgrad with the mask in its epilogue).

A route kernel that fails to build or launch raises; it never gives way to
the other route or to the plain version. On CPU tensors the plain versions
`fused_oracle` and `fused_bwd_plain` run.

The off-route forward kernel's shape predicate (`supported`) is its own,
derived from its shared-memory tiles; it covers every VGG16-BN seam at
width mult <= 2, including the 2x2 seams that the TPU kernels left to XLA,
and the backward kernels take every shape it admits, so no seam falls back
to a plain version. A CUDA call outside a predicate raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import masked_conv as _mc
from . import masked_matmul as _mm
from ..utils.roofline import SPEC
from .conv import conv2d_nhwc, wgrad_splits

# kernel launches since the last reset (set to 0 to start counting)
LAUNCHES = 0          # K4, forward
LAUNCHES_BWD_DX = 0   # K5
LAUNCHES_BWD_DW = 0   # K6

# tile constants of csrc/fused_chain_fwd.cu (BM, BN, BKC) and the card's
# per-block shared-memory limit (H100: 227 KB)
_BM, _BN, _BKC = 128, 64, 32
_SMEM_LIMIT = 232448
_DOT_DTYPES = (torch.bfloat16, torch.float32)


def fused_oracle(x, a, b, w, dot_dtype=torch.float32):
    """Plain version: act = relu(a*x + b) in f32, cast to the dot dtype, then
    a SAME 3x3 conv in the dot dtype."""
    act = torch.relu(x.float() * a + b).to(dot_dtype)
    return conv2d_nhwc(act, w.to(dot_dtype), 1, (1, 1, 1, 1))


def _smem_bytes(width: int, dtype) -> int:
    """Shared memory of one block, as the CUDA source lays it out."""
    staged = (_BM // width + 2) * width + 1  # halo rows + the zero row
    if dtype == torch.bfloat16:
        return (staged * (_BKC + 8) + 9 * _BKC * (_BN + 8)) * 2
    return (staged + 9 * _BN) * (_BKC + 1) * 4


def supported(x, w, dot_dtype) -> bool:
    """Shapes and dtypes the CUDA kernel takes: a 3x3 kernel, x in the dot
    dtype (bf16 or f32), W <= 128, and in bf16 channel counts that are
    multiples of 8 (16-byte loads)."""
    if x.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        return False
    n, h, wd, c = x.shape
    cout = w.shape[3]
    if dot_dtype == torch.bfloat16 and (c % 8 or cout % 8):
        return False
    return (dot_dtype in _DOT_DTYPES and x.dtype == dot_dtype and 1 <= wd <= _BM
            and min(n, h, c, cout) >= 1
            and _smem_bytes(wd, dot_dtype) <= _SMEM_LIMIT)


def dx_route(x, w, dot_dtype):
    """K5's route on the card (module docstring) for a seam with bf16 x, w
    and dot dtype, a 3x3 kernel over x's Cin, Cin and Cout multiples of 64
    (a k-step is one tap's 64 channels), x and w 16-byte aligned: "gemm" on
    a grid that `masked_conv.conv_box` tiles, "im2col" on any other; else
    None (the earlier kernel). w is the (3, 3, Cin, Cout) weight the launch
    reads."""
    if (dot_dtype != torch.bfloat16 or x.dtype != torch.bfloat16
            or w.dtype != torch.bfloat16 or x.dim() != 4 or w.dim() != 4
            or tuple(w.shape[:3]) != (3, 3, x.shape[3]) or w.shape[2] % 64
            or w.shape[3] % 64 or x.data_ptr() % 16 or w.data_ptr() % 16):
        return None
    return "gemm" if _mc.conv_box(*x.shape[1:3]) is not None else "im2col"


def fwd_route(x, w, dot_dtype):
    """K4's route on the card: `dx_route`'s where the halo tiles fit
    (`masked_matmul.fused_fwd_fits`: every VGG16-BN and ResNet-50 seam
    grid, not 1x1); else None (the earlier kernel)."""
    route = dx_route(x, w, dot_dtype)
    return route if route and _mm.fused_fwd_fits(*x.shape[1:3]) else None


def fused_bwd_dx_plain(x, a, b, w, g, dot_dtype=torch.float32):
    """Plain version of K5, as `cpg_tpu`'s `_fused_bwd_xla`: pre = a*x + b
    in f32; dact = conv_transpose(g, w) with g and w in the dot dtype and
    f32 sums; dmasked = dact * 1[pre > 0]; returns dx = dmasked * a in x's
    dtype, da = sum dmasked * x and db = sum dmasked in f32."""
    n, h, wd, cin = x.shape
    xf = x.float()
    mask = xf * a + b > 0
    gt = g.to(dot_dtype).float().permute(0, 3, 1, 2)
    wt = w.to(dot_dtype).float().permute(3, 2, 0, 1)
    dact = torch.nn.grad.conv2d_input((n, cin, h, wd), wt, gt, 1, 1)
    dmasked = torch.where(mask, dact.permute(0, 2, 3, 1), 0.0)
    return ((dmasked * a).to(x.dtype), (dmasked * xf).sum((0, 1, 2)),
            dmasked.sum((0, 1, 2)))


def fused_bwd_dw_plain(x, a, b, g, dot_dtype=torch.float32):
    """Plain version of K6: dW (f32, HWIO) = the weight gradient of
    act = relu(a*x + b) (f32, cast to the dot dtype) against g."""
    cout = g.shape[3]
    pre = x.float() * a + b
    act = torch.where(pre > 0, pre, 0.0).to(dot_dtype).float()
    gt = g.to(dot_dtype).float().permute(0, 3, 1, 2)
    dw = torch.nn.grad.conv2d_weight(act.permute(0, 3, 1, 2),
                                     (cout, x.shape[3], 3, 3), gt, 1, 1)
    return dw.permute(2, 3, 1, 0).contiguous()


def fused_bwd_plain(x, a, b, w, g, dot_dtype=torch.float32):
    """Plain backward, as `cpg_tpu`'s `_fused_bwd_xla`: (dx, da, db, dw)."""
    return (*fused_bwd_dx_plain(x, a, b, w, g, dot_dtype),
            fused_bwd_dw_plain(x, a, b, g, dot_dtype))


class _FusedAffineReluConv(torch.autograd.Function):
    """y = conv3x3_same(relu(a*x + b), w); residuals x, a, b, w (as the JAX
    custom_vjp), never the activation."""

    @staticmethod
    def forward(ctx, x, a, b, w, dot_dtype):
        ctx.save_for_backward(x, a, b, w)
        ctx.dot_dtype = dot_dtype
        if x.device.type == "cpu":
            return fused_oracle(x, a, b, w, dot_dtype)
        return _launch_fwd(x, a, b, w, dot_dtype)

    @staticmethod
    def backward(ctx, g):
        x, a, b, w = ctx.saved_tensors
        dot = ctx.dot_dtype
        need = ctx.needs_input_grad
        g = g.to(dot).contiguous()
        dx = da = db = dw = None
        if any(need[:3]):
            dx, da, db = fused_bwd_dx(x, a, b, w, g, dot)
        if need[3]:
            dw = fused_bwd_dw(x, a, b, g, dot).to(w.dtype)
        return dx, da, db, dw, None


def fused_affine_relu_conv(x, a, b, w, dot_dtype=torch.bfloat16):
    """y = conv3x3_same(relu(a*x + b), w): K4 on CUDA tensors, the plain
    version on CPU tensors. x: (N,H,W,Cin) in the dot dtype;
    a, b: (Cin,) f32 folded-BN affine; w: (3,3,Cin,Cout) effective weight,
    cast to the dot dtype. Output in the dot dtype. Differentiable in x, a,
    b and w: dx in x's dtype, da, db and dw in f32 (`fused_bwd_plain`); BN
    train-mode statistics get their gradients through a(x), b(x) at the
    call site."""
    return _FusedAffineReluConv.apply(x, a, b, w, dot_dtype)


def fused_bwd_dx(x, a, b, w, g, dot_dtype=torch.bfloat16):
    """(dx, da, db) for output gradient g: K5 on CUDA tensors, the plain
    version on CPU tensors."""
    if x.device.type == "cpu":
        return fused_bwd_dx_plain(x, a, b, w, g, dot_dtype)
    return _launch_bwd_dx(x, a, b, w, g, dot_dtype)


def fused_bwd_dw(x, a, b, g, dot_dtype=torch.bfloat16):
    """dW (f32) for output gradient g: K6 on CUDA tensors, the plain version
    on CPU tensors."""
    if x.device.type == "cpu":
        return fused_bwd_dw_plain(x, a, b, g, dot_dtype)
    return _launch_bwd_dw(x, a, b, g, dot_dtype)


# ------------------------------------------------------------- kernels ----

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# C signatures: the pointers, the ints, the stream
_ARGTYPES = {
    "fused_chain_fwd": [_P] * 5 + [_I] * 5 + [_P],
    "fused_chain_bwd_dx": [_P] * 10 + [_I] * 5 + [_P],
    "fused_chain_bwd_dw": [_P] * 6 + [_I] * 6 + [_P],
    "fused_chain_bwd_dw_bf16": [_P] * 6 + [_I] * 7 + [_P],  # + rows
    # the routes: K4 + the halo's rows, imgs, split; K5 + its box's rows
    # and images, or the im2col walk's phase table; then bn, stages, grid
    "fused_chain_fwd_gemm_bf16": [_P] * 5 + [_I] * 11 + [_P],
    "fused_chain_bwd_dx_gemm_bf16": [_P] * 10 + [_I] * 10 + [_P],
    "fused_chain_bwd_dx_im2col_bf16": ([_P] * 10 + [_I] * 5
                                       + [ctypes.POINTER(_I)] + [_I] * 3
                                       + [_P]),
}
_BM_BWD = 128  # pixels a tile of every dx kernel (da/db partials)


def _fn(lib_name, dtype, route=None):
    name = f"{lib_name}_{route + '_' if route else ''}{_SUFFIX[dtype]}"
    f = getattr(_build.load(lib_name), name)
    if f.argtypes is None:
        f.argtypes = _ARGTYPES.get(name, _ARGTYPES[lib_name])
        f.restype = ctypes.c_int
    return f


# K6's bf16 tiling (csrc/fused_chain_bwd_dw.cu): a block owns 32 input x 64
# output channels of dW, all nine taps, and walks steps of whole image rows,
# at most 128 pixels a step. The split count per seam comes from a cost
# model: waves of blocks times steps a split, at _K6_STEP_US a 128-pixel
# step with _K6_SLOTS blocks in flight (an H100: 132 SMs, one 9-warp block
# each; two would cap the registers at 96 a thread and spill), plus writing
# and reading the f32 partials at the card's memory rate. One full wave of
# equal blocks has no tail, so the model takes fewer splits (less scratch)
# where more would only add waves.
_K6_CB, _K6_OB, _K6_PIX = 32, 64, 128
_K6_SLOTS = 132
_K6_STEP_US = 3.1
_HBM_BYTES_PER_US = SPEC["hbm_gbps"] * 1e3
_GRID_Y_MAX = 65535


def k6_rows(h: int, w: int):
    """Image rows a K6 step covers: the most whose pixels fit in 128, among
    the divisors of H below H (a halo row above and below is staged) and
    the multiples of H (whole images, no halo). None when W > 128."""
    best = None
    for r in range(1, _K6_PIX // w + 1):
        if (r < h and h % r == 0) or r % h == 0:
            best = r
    return best


@functools.lru_cache(maxsize=None)
def k6_plan(n: int, h: int, w: int, cin: int, cout: int):
    """(rows a step, split count) of K6 in bf16; raises when W > 128."""
    rows = k6_rows(h, w)
    if rows is None:
        raise ValueError(f"fused_chain_bwd_dw: bf16 needs W <= {_K6_PIX}, got {w}")
    chunks = -(-n * h // rows)
    tiles = -(-cin // _K6_CB) * -(-cout // _K6_OB)
    step_us = _K6_STEP_US * (-(-rows * w // 16) * 16) / _K6_PIX
    partial_bytes = 9 * cin * cout * 4
    best = None
    for per in range(1, chunks + 1):
        splits = -(-chunks // per)
        if splits > _GRID_Y_MAX:
            continue
        waves = -(-tiles * splits // _K6_SLOTS)
        cost = waves * per * step_us
        if splits > 1:  # each partial written once and read once
            cost += 2 * splits * partial_bytes / _HBM_BYTES_PER_US
        if best is None or cost < best[0] or (cost == best[0] and splits < best[2]):
            best = (cost, rows, splits)
    return best[1], best[2]


def _bwd_supported(x, cout, dot_dtype) -> bool:
    """Shapes the backward kernels take: a superset of `supported` (any
    width; in bf16 channel counts in multiples of 8, for 16-byte loads)."""
    return (dot_dtype in _DOT_DTYPES and x.dtype == dot_dtype and x.dim() == 4
            and min(*x.shape, cout) >= 1
            and not (dot_dtype == torch.bfloat16
                     and (x.shape[3] % 8 or cout % 8)))


def _checked(x, a, b, w_shape, dot_dtype, fwd: bool, tensors):
    """Device, dtype, shape and alignment checks of a launch."""
    if not x.is_cuda:
        raise ValueError(f"fused_chain kernel: x must be a CUDA tensor, got {x.device}")
    w_meta = torch.empty(w_shape, device="meta")
    ok = (tuple(w_shape[:3]) == (3, 3, x.shape[-1]) and
          (supported(x, w_meta, dot_dtype) if fwd
           else _bwd_supported(x, w_shape[3], dot_dtype)))
    if not ok:
        raise ValueError(
            f"fused_chain kernel: unsupported x {tuple(x.shape)} {x.dtype}, "
            f"w {tuple(w_shape)}, dot dtype {dot_dtype} (needs x in the dot "
            f"dtype, bf16 or f32, a 3x3 kernel, in bf16 channels in "
            f"multiples of 8" + (f", and W <= {_BM}" if fwd else "") + ")")
    cin = x.shape[3]
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.shape != (cin,):
            raise ValueError(f"fused_chain kernel: {name} must be f32 ({cin},)")
    for name, t in (("x", x), ("a", a), ("b", b), *tensors.items()):
        if t.device != x.device:
            raise ValueError(f"fused_chain kernel: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_chain kernel: {name} must be contiguous")
    for name, t in (("x", x), *tensors.items()):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_chain kernel: {name} must be 16-byte aligned")


def _launch_fwd(x, a, b, w, dot_dtype):
    """K4: y, on its route (`fwd_route`: one kernel on "gemm" and "im2col")
    or the earlier kernel."""
    global LAUNCHES
    w = w.to(dot_dtype).contiguous()
    _checked(x, a, b, w.shape, dot_dtype, True, {"w": w})
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((n, h, wd, cout), dtype=dot_dtype, device=x.device)
    ptrs = (x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
            y.data_ptr())
    if fwd_route(x, w, dot_dtype):
        (_, _, rows, imgs), split = _mm.fused_fwd_halo(h, wd)
        _, bn, stages, grid, _ = _mm.fused_fwd_plan(
            n, h, wd, cin, cout, _mm._sms(x.device.index or 0))
        err = _build.launch(_fn("fused_chain_fwd", dot_dtype, "gemm"), x,
            *ptrs, n, h, wd, cin, cout, rows, imgs, split, bn, stages, grid)
    else:
        err = _build.launch(_fn("fused_chain_fwd", dot_dtype), x, *ptrs, n,
                            h, wd, cin, cout)
    if err:
        raise RuntimeError(f"fused_chain_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y


def _launch_bwd_dx(x, a, b, w, g, dot_dtype):
    """K5: dx, da, db, on its route (`dx_route`) or the earlier kernel; da
    and db from 128-pixel tiles' partials summed in tile order."""
    global LAUNCHES_BWD_DX
    w = w.to(dot_dtype).contiguous()
    _checked(x, a, b, w.shape, dot_dtype, False, {"w": w, "g": g})
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if g.shape != (n, h, wd, cout) or g.dtype != dot_dtype:
        raise ValueError(f"fused_chain kernel: g must be {(n, h, wd, cout)} "
                         f"in {dot_dtype}")
    f32 = dict(dtype=torch.float32, device=x.device)
    tiles = -(-n * h * wd // _BM_BWD)
    ws = torch.empty((2, tiles, cin), **f32)
    dx = torch.empty_like(x)
    da = torch.empty((cin,), **f32)
    db = torch.empty((cin,), **f32)
    ptrs = (x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(),
            w.data_ptr(), dx.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
            da.data_ptr(), db.data_ptr())
    route = dx_route(x, w, dot_dtype)
    if route:
        if a.data_ptr() % 8 or b.data_ptr() % 8:  # the epilogue's pair loads
            raise ValueError("fused_chain_bwd_dx: a and b must be 8-byte "
                             f"aligned on the {route} route")
        sms = _mm._sms(x.device.index or 0)
        if route == "gemm":
            (_, _, box_h, box_n), bn, stages, grid = _mm.fused_dx_plan(
                n, h, wd, cin, cout, sms)
            walk = (box_h, box_n)
        else:
            phases, bn, stages, grid = _mm.fused_dx_im2col_plan(
                n, h, wd, cin, cout, sms)
            walk = (_mm.phase_table(phases),)
        err = _build.launch(_fn("fused_chain_bwd_dx", dot_dtype, route), x,
            *ptrs, n, h, wd, cin, cout, *walk, bn, stages, grid)
    else:
        err = _build.launch(_fn("fused_chain_bwd_dx", dot_dtype), x, *ptrs,
                            n, h, wd, cin, cout)
    if err:
        raise RuntimeError(f"fused_chain_bwd_dx launch failed: CUDA error {err}")
    LAUNCHES_BWD_DX += 1
    return dx, da, db


def _launch_bwd_dw(x, a, b, g, dot_dtype):
    """K6: dW = act^T shift(g) in f32, act = relu(a*x+b) formed on chip
    (bf16: once per element in shared memory, `k6_plan`'s tiling; f32: in
    the operand load); split-K partials summed in a fixed order."""
    global LAUNCHES_BWD_DW
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    _checked(x, a, b, (3, 3, cin, cout), dot_dtype, False, {"g": g})
    if g.shape != (n, h, wd, cout) or g.dtype != dot_dtype:
        raise ValueError(f"fused_chain kernel: g must be {(n, h, wd, cout)} "
                         f"in {dot_dtype}")
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    if dot_dtype == torch.bfloat16:
        rows, s = k6_plan(n, h, wd, cin, cout)
        extra = (rows, s)
    else:
        s = wgrad_splits(n * h * wd, 9 * cin, cout)
        extra = (s,)
    # f32 partials of the split-K reduction; with one split K6 writes dw
    ws = (torch.empty((s, 9 * cin, cout), dtype=torch.float32, device=x.device)
          if s > 1 or dot_dtype != torch.bfloat16 else dw)
    err = _build.launch(_fn("fused_chain_bwd_dw", dot_dtype), x,
        x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(), ws.data_ptr(),
        dw.data_ptr(), n, h, wd, cin, cout, *extra)
    if err:
        raise RuntimeError(f"fused_chain_bwd_dw launch failed: CUDA error {err}")
    LAUNCHES_BWD_DW += 1
    return dw
