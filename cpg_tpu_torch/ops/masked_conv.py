"""Masked conv: the CPG SharableConv2d with the ownership/piggymask select
inside the GEMM's weight-tile load, forward and backward.

`masked_conv2d` is the counterpart of `cpg_tpu.ops.pallas.masked_conv.
masked_conv2d` and its `custom_vjp` (`masked_matmul.py`): a
`torch.autograd.Function` that saves `x, w, own, pm` (never the effective
weight) and returns

    dx  = conv_transpose(g, w_eff)                       in x's dtype
    dw  = G       where own == task_id, else 0           f32, HWIO
    dpm = G * w   where 0 < own < task_id, else 0        f32, HWIO

with G the weight gradient of the convolution. `dpm` is the same formula in
the binary and the ternary mode (straight-through estimator); `own`, the
task id, the threshold and the mode get no gradient, and `dx` is computed
only when x needs it (conv0's input is the image).

On CUDA tensors the three products are hand-written implicit-GEMM kernels.
y and dx take one of two routes, chosen by `conv_route` (a shape predicate)
before any launch:

* bf16, stride 1, Cin and Cout multiples of 64, and output and input grids
  whose 128-pixel tiles are each one TMA box (`conv_box`; VGG16-BN's conv2,
  4, 7 and 10 at width 1.0): the select pass of `csrc/masked_matmul.cu`
  (w, own and pm read once; the bf16 effective weight of the (kh*kw*Cin,
  Cout) view written to a per-call scratch, transposed for the forward,
  counted in `LAUNCHES_SELECT`), then that file's TMA + wgmma GEMM walking
  the taps as an implicit GEMM (`masked_matmul.launch_conv_gemm`). The
  scratch is not saved for the backward.
* otherwise (conv0's Cin = 3, narrow widths, f32, stride 2):
  `csrc/masked_conv_fwd.cu` (K1) and `csrc/masked_conv_bwd_dx.cu` (K2),
  the select in the (transposed) weight-tile load.

dw and dpm (K3) take one of three routes, chosen by shape predicates:

* `conv_route`: `csrc/masked_matmul_wgrad.cu`'s split-M TMA + wgmma GEMM,
  the k tile's x read as per-tap 4-D TMA boxes of the NHWC input, both
  operands MN-major, the splits summed in a fixed order and the gating in
  the epilogue (`masked_matmul.launch_wgrad_conv`);
* `im2col_route` (bf16, kh*kw*Cin <= 64: VGG16-BN's conv0): that file's
  im2col kernel writes the patches, K rounded up to 8 columns (counted in
  `LAUNCHES_IM2COL`), and the same GEMM reduces them as a dense product
  (`masked_matmul.launch_wgrad`);
* otherwise (f32, narrow widths, stride 2): `csrc/masked_conv_bwd_dw.cu`
  (split-K f32 partials summed in a fixed order by a second pass that
  applies the gating).

On CPU tensors the plain versions `masked_conv2d_plain` and
`masked_conv2d_bwd_plain` run. Every kernel keeps its own launch counter.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .binarize import DEFAULT_THRESHOLD
from .conv import conv2d_nhwc, out_size, resolve_padding, wgrad_splits
from .masked import effective_kernel

# kernel launches since the last reset (set to 0 to start counting)
LAUNCHES = 0          # K1, forward
LAUNCHES_BWD_DX = 0   # K2
LAUNCHES_BWD_DW = 0   # K3
LAUNCHES_SELECT = 0   # the select pass before the GEMM route's y and dx
LAUNCHES_IM2COL = 0   # the patches before conv0's K3

_MODES = ("binary", "ternary")
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def masked_conv2d_plain(x, w, own, pm, task_id, stride: int = 1,
                        padding="SAME", threshold: float = DEFAULT_THRESHOLD,
                        mask_mode: str = "binary"):
    """Plain PyTorch version: effective kernel in f32, f32 conv, x's dtype."""
    pads = resolve_padding(padding, x.shape[1], x.shape[2], w.shape[0],
                           w.shape[1], stride)
    weff = effective_kernel(w.float(), own, pm, task_id, threshold, mask_mode)
    return conv2d_nhwc(x.float(), weff, stride, pads).to(x.dtype)


def masked_conv2d_bwd_dx_plain(g, x, w, own, pm, task_id, stride: int = 1,
                               padding="SAME",
                               threshold: float = DEFAULT_THRESHOLD,
                               mask_mode: str = "binary"):
    """Plain version of K2: dx = conv_transpose(g, w_eff), with g and the
    effective kernel in x's dtype, f32 sums, dx cast to x's dtype last."""
    kh, kw, cin, _ = w.shape
    n, h, wd, _ = x.shape
    pt, pb, pl, pr = resolve_padding(padding, h, wd, kh, kw, stride)
    gt = g.to(x.dtype).float().permute(0, 3, 1, 2)
    weff = effective_kernel(w.float(), own, pm, task_id, threshold,
                            mask_mode).to(x.dtype).float()
    dxp = torch.nn.grad.conv2d_input((n, cin, h + pt + pb, wd + pl + pr),
                                     weff.permute(3, 2, 0, 1), gt, stride)
    dx = dxp[:, :, pt:pt + h, pl:pl + wd].permute(0, 2, 3, 1)
    return dx.to(x.dtype).contiguous()


def masked_conv2d_bwd_dw_plain(g, x, w, own, task_id, stride: int = 1,
                               padding="SAME", acc_dtype=torch.float32):
    """Plain version of K3: G = the conv's weight gradient (x and g in x's
    dtype, sums in `acc_dtype`), then dw = G on own == task, dpm = G * w on
    0 < own < task, both f32 HWIO. `acc_dtype=torch.float64` gives the
    exact reference of a long reduction: summed in f32 (cuDNN, TF32 off)
    over SphereNet's 688,128 pixels a weight, G is 1.1e-4 of max|G| off."""
    kh, kw, cin, cout = w.shape
    pt, pb, pl, pr = resolve_padding(padding, x.shape[1], x.shape[2], kh, kw,
                                     stride)
    gt = g.to(x.dtype).to(acc_dtype).permute(0, 3, 1, 2)
    xp = F.pad(x.to(acc_dtype).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    G = torch.nn.grad.conv2d_weight(xp, (cout, cin, kh, kw), gt, stride)
    G = G.permute(2, 3, 1, 0)  # OIHW -> HWIO
    tid = int(task_id)
    zero = torch.zeros((), dtype=acc_dtype, device=G.device)
    dw = torch.where(own == tid, G, zero).float().contiguous()
    dpm = torch.where((own > 0) & (own < tid), G * w.to(acc_dtype),
                      zero).float().contiguous()
    return dw, dpm


def masked_conv2d_bwd_plain(g, x, w, own, pm, task_id, stride: int = 1,
                            padding="SAME",
                            threshold: float = DEFAULT_THRESHOLD,
                            mask_mode: str = "binary", need_dx: bool = True):
    """Plain backward: (dx or None, dw, dpm) for output gradient g (NHWC),
    with the kernels' rounding points (see the two parts)."""
    dx = (masked_conv2d_bwd_dx_plain(g, x, w, own, pm, task_id, stride,
                                     padding, threshold, mask_mode)
          if need_dx else None)
    return (dx, *masked_conv2d_bwd_dw_plain(g, x, w, own, task_id, stride,
                                            padding))


class _MaskedConv2d(torch.autograd.Function):
    """y = conv(x, w_eff); residuals x, w, own, pm (as the JAX custom_vjp)."""

    @staticmethod
    def forward(ctx, x, w, own, pm, task_id, stride, padding, threshold,
                mask_mode):
        ctx.save_for_backward(x, w, own, pm)
        ctx.conf = (task_id, stride, padding, threshold, mask_mode)
        if x.device.type == "cpu":
            return masked_conv2d_plain(x, w, own, pm, task_id, stride,
                                       padding, threshold, mask_mode)
        global LAUNCHES
        if conv_route(x, w, stride, padding):
            y = _select_then_gemm(x, x, w, own, pm, task_id, padding,
                                  threshold, mask_mode, dgrad=False)
        else:
            y = launch_fwd(x, w, own, pm, task_id, stride, padding,
                           threshold, mask_mode)
        LAUNCHES += 1
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, own, pm = ctx.saved_tensors
        task_id, stride, padding, threshold, mask_mode = ctx.conf
        g = g.to(x.dtype).contiguous()
        dx = (masked_conv2d_bwd_dx(g, x, w, own, pm, task_id, stride, padding,
                                   threshold, mask_mode)
              if ctx.needs_input_grad[0] else None)
        dw, dpm = masked_conv2d_bwd_dw(g, x, w, own, task_id, stride, padding)
        return dx, dw, None, dpm, None, None, None, None, None


def masked_conv2d(x, w, own, pm, task_id, stride: int = 1, padding="SAME",
                  threshold: float = DEFAULT_THRESHOLD,
                  mask_mode: str = "binary"):
    """NHWC conv with HWIO weight; ownership (int8) and piggymask (f32)
    shaped like w. Output in x's dtype, f32 accumulation. Differentiable in
    x, w and pm (see the module docstring).

    y[n,i,j,o] = sum_{dh,dw,c} x_pad[n, i*s+dh, j*s+dw, c] * w_eff[dh,dw,c,o]
    """
    if mask_mode not in _MODES:
        raise ValueError(f"masked_conv2d: mask_mode {mask_mode!r} not in {_MODES}")
    return _MaskedConv2d.apply(x, w, own, pm, int(task_id), stride, padding,
                               float(threshold), mask_mode)


def masked_conv2d_bwd_dx(g, x, w, own, pm, task_id, stride: int = 1,
                         padding="SAME", threshold: float = DEFAULT_THRESHOLD,
                         mask_mode: str = "binary"):
    """dx for output gradient g: on CUDA tensors the select pass and the
    implicit GEMM (`conv_route`) or K2, on CPU tensors the plain version."""
    if x.device.type == "cpu":
        return masked_conv2d_bwd_dx_plain(g, x, w, own, pm, task_id, stride,
                                          padding, threshold, mask_mode)
    global LAUNCHES_BWD_DX
    if conv_route(x, w, stride, padding):
        dx = _select_then_gemm(g, x, w, own, pm, int(task_id), padding,
                               threshold, mask_mode, dgrad=True)
    else:
        dx = launch_bwd_dx(g, x, w, own, pm, int(task_id), stride, padding,
                           threshold, mask_mode)
    LAUNCHES_BWD_DX += 1
    return dx


def masked_conv2d_bwd_dw(g, x, w, own, task_id, stride: int = 1,
                         padding="SAME"):
    """(dw, dpm) for output gradient g: on CUDA tensors the wgrad GEMM
    (`conv_route`, or over conv0's patches by `im2col_route`) or the old K3,
    on CPU tensors the plain version."""
    if x.device.type == "cpu":
        return masked_conv2d_bwd_dw_plain(g, x, w, own, task_id, stride,
                                          padding)
    from . import masked_matmul as mm  # imports this module: not at the top

    global LAUNCHES_BWD_DW
    if conv_route(x, w, stride, padding):
        pt, pl, _, _ = _stride1_grid(x, w, padding)
        out = mm.launch_wgrad_conv(g, x, w, own, int(task_id), pt, pl)
    elif im2col_route(x, w):
        out = _im2col_then_wgrad(g, x, w, own, int(task_id), stride, padding)
    else:
        out = launch_bwd_dw(g, x, w, own, int(task_id), stride, padding)
    LAUNCHES_BWD_DW += 1
    return out


# ------------------------------------------------------------ GEMM route ----

def conv_box(ho: int, wo: int):
    """The TMA box (channels, columns, rows, images) that holds one
    128-pixel output tile of an (ho, wo) grid in NHWC order: whole rows of
    one image, or whole images; None when no box does (128 % wo != 0, or
    neither whole rows nor whole images make 128)."""
    if wo <= 0 or ho <= 0 or 128 % wo:
        return None
    rows = 128 // wo
    if ho % rows == 0:
        return (64, wo, rows, 1)
    if rows % ho == 0:
        return (64, wo, ho, rows // ho)
    return None


def conv_route(x, w, stride, padding) -> bool:
    """Whether a conv's y and dx on the card take the select pass + TMA/wgmma
    implicit GEMM: bf16, stride 1, Cin and Cout multiples of 64 (a k-step is
    one tap's 64 channels of the reduction: Cin for y, Cout for dx), output
    and input grids tiled by `conv_box`, x and w 16-byte aligned. The launch
    checks the rest (contiguity, g and pm alignment) and raises; every other
    shape takes K1 and K2."""
    if (x.dtype != torch.bfloat16 or stride != 1 or x.dim() != 4
            or w.dim() != 4):
        return False
    _, h, wd, _ = x.shape
    _, _, ho, wo = _stride1_grid(x, w, padding)
    return (w.shape[2] % 64 == 0 and w.shape[3] % 64 == 0
            and conv_box(ho, wo) is not None and conv_box(h, wd) is not None
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def im2col_route(x, w) -> bool:
    """Whether a conv's K3 on the card reduces its patches on the wgrad
    GEMM: bf16 with kh*kw*Cin <= 64 (the patches, rounded up to 8 columns,
    fit one 128-byte TMA row: VGG16-BN's conv0, K = 27) and Cout a multiple
    of 8; any stride and padding. The launch checks alignment and raises."""
    return (x.dtype == torch.bfloat16 and x.dim() == 4 and w.dim() == 4
            and w.shape[0] * w.shape[1] * w.shape[2] <= 64
            and w.shape[3] % 8 == 0)


def _im2col_then_wgrad(g, x, w, own, task_id, stride, padding):
    """The `im2col_route` path: conv0's patches (N*Ho*Wo, K rounded up to 8)
    by the im2col kernel, then the dense wgrad GEMM over them against g
    viewed as (N*Ho*Wo, Cout); dw and dpm HWIO."""
    from . import masked_matmul as mm

    global LAUNCHES_IM2COL
    kh, kw, cin, cout = w.shape
    k = kh * kw * cin
    pads = resolve_padding(padding, x.shape[1], x.shape[2], kh, kw, stride)
    _check(g.dim() == 4 and g.shape[-1] == cout and g.dtype == x.dtype,
           f"g must be NHWC with {cout} channels in x's dtype")
    patches = mm.launch_im2col(x, kh, kw, stride, pads, -(-k // 8) * 8)
    LAUNCHES_IM2COL += 1
    _check(g.shape[0] * g.shape[1] * g.shape[2] == patches.shape[0],
           f"g {tuple(g.shape)} does not match the output grid")
    dw, dpm = mm.launch_wgrad(patches, g.reshape(-1, cout), w.reshape(k, cout),
                              own.reshape(k, cout), task_id)
    return dw.reshape(w.shape), dpm.reshape(w.shape)


def _stride1_grid(x, w, padding):
    """(pad_top, pad_left, Ho, Wo) of a stride-1 conv of x with w."""
    kh, kw = w.shape[:2]
    _, h, wd, _ = x.shape
    pt, pb, pl, pr = resolve_padding(padding, h, wd, kh, kw, 1)
    return pt, pl, out_size(h, kh, 1, pt, pb), out_size(wd, kw, 1, pl, pr)


def _select_then_gemm(a, x, w, own, pm, task_id, padding, threshold,
                      mask_mode, dgrad):
    """The `conv_route` path: the select pass over w viewed as (kh*kw*Cin,
    Cout), transposed for the forward, then the implicit GEMM over it; a is
    x (forward) or g (dgrad)."""
    from . import masked_matmul as mm  # imports this module: not at the top

    global LAUNCHES_SELECT
    kh, kw, _, cout = w.shape
    n, h, wd, _ = x.shape
    pt, pl, ho, wo = _stride1_grid(x, w, padding)
    if dgrad:
        _check(a.shape == (n, ho, wo, cout) and a.dtype == x.dtype,
               f"g must be {(n, ho, wo, cout)} in x's dtype")
    weff = mm.launch_select(*(t.reshape(-1, cout) for t in (w, own, pm)),
                            task_id, threshold, mask_mode, not dgrad)
    LAUNCHES_SELECT += 1
    return mm.launch_conv_gemm(a, weff, (h, wd) if dgrad else (ho, wo), kh,
                               kw, pt, pl, dgrad)


# ------------------------------------------------------------- kernels ----
# `launch_*` check their inputs and launch one kernel (K3: and its second
# pass) on the current stream; they count nothing: the op that calls them
# (this module's conv, or ops/masked_matmul.py's dense product at the 1x1
# geometry) adds to its own counter.

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the libraries' entry points: pointers, the 12 geometry
# ints and the task id, the rest, the stream
_ARGTYPES = {
    "masked_conv_fwd": [_P] * 5 + [_I] * 13 + [_F, _I, _P],
    "masked_conv_bwd_dx": [_P] * 5 + [_I] * 13 + [_F, _I, _P],
    "masked_conv_bwd_dw": [_P] * 7 + [_I] * 13 + [_I, _P],
}


def _fn(lib_name, dtype):
    f = getattr(_build.load(lib_name), f"{lib_name}_{_DTYPES[dtype]}")
    if f.argtypes is None:
        f.argtypes = _ARGTYPES[lib_name]
        f.restype = ctypes.c_int
    return f


def supported(x, w) -> bool:
    """The channel predicate of the three kernels: any Cin and Cout in f32;
    in bf16 a Cout in multiples of 4 (8-byte loads of g and 16-byte loads of
    four weight entries). Every VGG16-BN width multiple of 0.125 meets it."""
    return x.dtype == torch.float32 or (x.dtype == torch.bfloat16
                                        and w.shape[-1] % 4 == 0)


def _check(cond, msg):
    if not cond:
        raise ValueError(f"masked_conv2d kernel: {msg}")


def _geometry(x, w, own, stride, padding, tensors):
    """Checks shared by the three kernels; returns the conv geometry
    (n, h, w, cin, ho, wo, cout, kh, kw, stride, pad_top, pad_left)."""
    _check(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    _check(x.dtype in _DTYPES, f"x dtype {x.dtype} not in {list(_DTYPES)}")
    _check(x.dim() == 4 and w.dim() == 4, "x must be NHWC and w HWIO")
    kh, kw, cin, cout = w.shape
    n, h, wd, c = x.shape
    _check(c == cin, f"x has {c} channels, w expects {cin}")
    _check(w.dtype == torch.float32, "w must be float32")
    _check(own.dtype == torch.int8 and own.shape == w.shape,
           "own must be int8 with w's shape")
    for name, t in tensors.items():
        _check(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(stride >= 1, f"stride {stride}")
    if x.dtype == torch.bfloat16:  # the bf16 kernels' vector loads
        _check(supported(x, w), f"bf16 needs Cout % 4 == 0, got {cout}")
        _check(all(t.data_ptr() % 16 == 0 for t in tensors.values()
                   if t.dtype != torch.int8)
               and own.data_ptr() % 4 == 0,
               "bf16 needs 16-byte aligned tensors (4-byte own)")
    pt, pb, pl, pr = resolve_padding(padding, h, wd, kh, kw, stride)
    ho, wo = out_size(h, kh, stride, pt, pb), out_size(wd, kw, stride, pl, pr)
    _check(ho > 0 and wo > 0, f"empty output {ho}x{wo}")
    return (n, h, wd, cin, ho, wo, cout, kh, kw, stride, pt, pl)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def launch_fwd(x, w, own, pm, task_id, stride, padding, threshold,
               mask_mode):
    """K1: y = conv(x, w_eff), the select in the weight-tile load."""
    _check(pm.dtype == torch.float32 and pm.shape == w.shape,
           "pm must be float32 with w's shape")
    geo = _geometry(x, w, own, stride, padding,
                    {"x": x, "w": w, "own": own, "pm": pm})
    n, _, _, _, ho, wo, cout = geo[:7]
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    err = _fn("masked_conv_fwd", x.dtype)(
        x.data_ptr(), w.data_ptr(), own.data_ptr(), pm.data_ptr(),
        y.data_ptr(), *geo, task_id, float(threshold),
        int(mask_mode == "ternary"), _stream(x))
    _raise_on(err, "masked_conv_fwd")
    return y


def launch_bwd_dx(g, x, w, own, pm, task_id, stride, padding, threshold,
                  mask_mode):
    """K2: dx = conv_transpose(g, w_eff), the select in the weight tile."""
    _check(pm.dtype == torch.float32 and pm.shape == w.shape,
           "pm must be float32 with w's shape")
    geo = _geometry(x, w, own, stride, padding,
                    {"g": g, "x": x, "w": w, "own": own, "pm": pm})
    n, _, _, _, ho, wo, cout = geo[:7]
    _check(g.shape == (n, ho, wo, cout) and g.dtype == x.dtype,
           f"g must be {(n, ho, wo, cout)} in x's dtype")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    err = _fn("masked_conv_bwd_dx", x.dtype)(
        g.data_ptr(), w.data_ptr(), own.data_ptr(), pm.data_ptr(),
        dx.data_ptr(), *geo, task_id, float(threshold),
        int(mask_mode == "ternary"), _stream(x))
    _raise_on(err, "masked_conv_bwd_dx")
    return dx


def launch_bwd_dw(g, x, w, own, task_id, stride, padding):
    """K3: G = x_patches^T g in f32 (split-K partials summed in a fixed
    order), then dw = G on own == task, dpm = G * w on prior entries."""
    geo = _geometry(x, w, own, stride, padding,
                    {"g": g, "x": x, "w": w, "own": own})
    n, _, _, cin, ho, wo, cout, kh, kw = geo[:9]
    _check(g.shape == (n, ho, wo, cout) and g.dtype == x.dtype,
           f"g must be {(n, ho, wo, cout)} in x's dtype")
    s = wgrad_splits(n * ho * wo, kh * kw * cin, cout)
    ws = torch.empty((s, kh * kw * cin, cout), dtype=torch.float32,
                     device=x.device)
    dw = torch.empty(w.shape, dtype=torch.float32, device=x.device)
    dpm = torch.empty_like(dw)
    err = _fn("masked_conv_bwd_dw", x.dtype)(
        x.data_ptr(), g.data_ptr(), w.data_ptr(), own.data_ptr(),
        ws.data_ptr(), dw.data_ptr(), dpm.data_ptr(), *geo, task_id, s,
        _stream(x))
    _raise_on(err, "masked_conv_bwd_dw")
    return dw, dpm
