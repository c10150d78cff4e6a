"""Masked matmul: the CPG SharableLinear with the ownership/piggymask select,
forward and backward.

`masked_matmul` is the counterpart of `cpg_tpu.ops.pallas.masked_matmul.
masked_matmul` and its `custom_vjp`: a `torch.autograd.Function` that saves
`x, w, own, pm` (never the effective weight) and returns

    y   = x @ w_eff                                    in x's dtype
    dx  = g @ w_eff^T                                  in x's dtype
    dw  = G       where own == task_id, else 0         f32
    dpm = G * w   where 0 < own < task_id, else 0      f32

with G = x^T g; `dpm` is the same formula in the binary and the ternary
mode (straight-through estimator), and `dx` is computed only when x needs
it.

On CUDA tensors two routes, chosen by `gemm_route` (a shape predicate)
before any launch:

* bf16 with K and N multiples of 8 (every ViT and MoE width): y and dx run
  `csrc/masked_matmul.cu`, a select pass (`masked_matmul_select`: w, own
  and pm read once, the bf16 effective weight written to a per-call
  scratch, transposed for the forward) and then a TMA + wgmma GEMM
  (`launch_gemm_tn`, C = A @ Bt^T) over that scratch. The scratch is not
  saved for the backward.
* otherwise (f32, or a width that is not a multiple of 8): the masked-conv
  kernels K1 and K2 (`csrc/masked_conv_{fwd,bwd_dx}.cu`) at the 1x1,
  stride-1, unpadded geometry: x (M, K) viewed as (M, 1, 1, K) and w (K, N)
  as (1, 1, K, N), the same GEMM with the select in the weight-tile load.

dw and dpm run K3 (`csrc/masked_conv_bwd_dw.cu`) at the 1x1 geometry on
either route. On CPU tensors the plain versions run. This module keeps its
own launch counters.

The masked conv's GEMM route (`masked_conv.conv_route`) launches the same
select pass and the same GEMM, whose producer walks the conv's taps
(`launch_conv_gemm`, planned by `conv_plan`); it counts in `masked_conv`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import masked_conv as _mc
from .binarize import DEFAULT_THRESHOLD
from .masked import effective_kernel

# kernel launches of the dense route since the last reset
LAUNCHES = 0          # forward: the TN GEMM, or K1 at 1x1
LAUNCHES_BWD_DX = 0   # dx: the TN GEMM, or K2 at 1x1
LAUNCHES_BWD_DW = 0   # K3 at 1x1
LAUNCHES_SELECT = 0   # the select pass (one before each GEMM)

# the GEMM's tiles: 128 rows (two consumer warpgroups of 64), 64 deep a
# stage, BN wide; shared memory a block on the H100
GEMM_BM, GEMM_BK = 128, 64
GEMM_BNS = (192, 128, 64)
GEMM_MAX_STAGES = 5
SMEM_PER_BLOCK = 232448

_MODES = ("binary", "ternary")


def masked_matmul_plain(x, w, own, pm, task_id,
                        threshold: float = DEFAULT_THRESHOLD,
                        mask_mode: str = "binary"):
    """Plain PyTorch version: effective weight in f32, f32 product, x's
    dtype (as `masked_conv2d_plain`)."""
    weff = effective_kernel(w.float(), own, pm, task_id, threshold, mask_mode)
    return (x.float() @ weff).to(x.dtype)


def masked_matmul_bwd_dx_plain(g, x, w, own, pm, task_id,
                               threshold: float = DEFAULT_THRESHOLD,
                               mask_mode: str = "binary"):
    """Plain version of K2 at 1x1: g and the effective weight in x's dtype,
    f32 sums, dx cast to x's dtype last."""
    weff = effective_kernel(w.float(), own, pm, task_id, threshold,
                            mask_mode).to(x.dtype).float()
    return (g.to(x.dtype).float() @ weff.t()).to(x.dtype)


def masked_matmul_bwd_dw_plain(g, x, w, own, task_id):
    """Plain version of K3 at 1x1: G = x^T g (operands in x's dtype, f32
    sums), dw = G on own == task, dpm = G * w on 0 < own < task, f32."""
    G = x.float().t() @ g.to(x.dtype).float()
    tid = int(task_id)
    zero = torch.zeros((), dtype=torch.float32, device=G.device)
    dw = torch.where(own == tid, G, zero)
    dpm = torch.where((own > 0) & (own < tid), G * w.float(), zero)
    return dw, dpm


def masked_matmul_select_plain(w, own, pm, task_id,
                               threshold: float = DEFAULT_THRESHOLD,
                               mask_mode: str = "binary",
                               transpose: bool = False):
    """Plain version of the select pass: `_mask_tile`'s select in f32, then
    bf16; (K, N), or (N, K) with `transpose`."""
    wf = w.float()
    tid = int(task_id)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    neg = torch.where(pm < 0, -wf, zero) if mask_mode == "ternary" else zero
    picked = torch.where(pm > threshold, wf, neg)
    prior = (own > 0) & (own < tid)
    weff = torch.where(own == tid, wf, torch.where(prior, picked, zero))
    weff = weff.to(torch.bfloat16)
    return weff.t().contiguous() if transpose else weff


def gemm_tn_plain(a, bt):
    """Plain version of the TN GEMM: C = A @ Bt^T, f32 sums, A's dtype."""
    return (a.float() @ bt.float().t()).to(a.dtype)


def gemm_smem_bytes(bn: int, stages: int) -> int:
    """Dynamic shared memory of one GEMM block, as `gemm_smem_bytes` in
    csrc/masked_matmul.cu lays it out: 1 KB of alignment slack, the ring
    of {A 128 x 64, B bn x 64} bf16 stages, the 128 x bn bf16 output
    staging, two barriers a stage."""
    return (1024 + stages * (GEMM_BM + bn) * GEMM_BK * 2 + GEMM_BM * bn * 2
            + 16 * stages)


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, r: int, nout: int, sms: int):
    """(bn, stages, grid) of the TN GEMM: the tile width that finishes the
    output in the least work a block, counted as the waves of tiles a
    block walks times the rows it loads a stage (128 of A and bn of B),
    ties to the wider tile (fewer A passes); as many ring stages as fit, up
    to GEMM_MAX_STAGES; one persistent block an SM, no more than the
    tiles."""
    tiles_m = -(-m // GEMM_BM)

    def cost(bn):
        tiles = tiles_m * -(-nout // bn)
        return -(-tiles // sms) * (GEMM_BM + bn), -bn

    bn = min(GEMM_BNS, key=cost)
    stages = GEMM_MAX_STAGES
    while gemm_smem_bytes(bn, stages) > SMEM_PER_BLOCK:
        stages -= 1
    return bn, stages, min(tiles_m * -(-nout // bn), sms)


@functools.lru_cache(maxsize=None)
def conv_plan(n: int, ho: int, wo: int, c: int, nout: int, taps: int,
              sms: int):
    """(box, bn, stages, grid) of the masked conv's implicit GEMM
    (`launch_conv_gemm`) with an output grid of n images of ho x wo, c
    reduction channels a tap and nout output channels: the A tile's TMA box
    (64 channels, wo, rows, images), 128 consecutive output pixels
    (`masked_conv.conv_box`), and the TN GEMM's plan (`gemm_plan`) for M =
    n*ho*wo rows and R = taps * c."""
    box = _mc.conv_box(ho, wo)
    _check(box is not None, f"no 128-pixel TMA box tiles a {ho}x{wo} grid")
    return (box, *gemm_plan(n * ho * wo, taps * c, nout, sms))


def gemm_route(a, w, own, pm) -> bool:
    """Whether a dense-route product on the card takes the select pass +
    TN GEMM, where a is the GEMM's activation operand (x (M, K) for the
    forward, g (M, N) for dx) and w, own, pm are (K, N): bf16 activations,
    K and N multiples of 8 (TMA's 16-byte row strides, for the forward's
    R = K, Nout = N and dx's R = N, Nout = K), a, w and pm 16-byte and own
    4-byte aligned. Otherwise the 1x1 masked-conv kernels run."""
    return (a.dtype == torch.bfloat16 and w.shape[0] % 8 == 0
            and w.shape[1] % 8 == 0 and a.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0 and pm.data_ptr() % 16 == 0
            and own.data_ptr() % 4 == 0)


def _as_conv(x, w, own, pm=None):
    """(M, K) x and (K, N) weights as the 1x1 conv's NHWC / HWIO views."""
    views = [x.reshape(x.shape[0], 1, 1, x.shape[1]),
             *(t.reshape(1, 1, *t.shape) for t in (w, own))]
    if pm is not None:
        views.append(pm.reshape(1, 1, *pm.shape))
    return views


def masked_matmul_bwd_dx(g, x, w, own, pm, task_id,
                         threshold: float = DEFAULT_THRESHOLD,
                         mask_mode: str = "binary"):
    """dx for output gradient g (M, N): on CUDA tensors the select pass and
    the TN GEMM (`gemm_route`) or K2 at 1x1, on CPU tensors the plain
    version."""
    if x.device.type == "cpu":
        return masked_matmul_bwd_dx_plain(g, x, w, own, pm, task_id,
                                          threshold, mask_mode)
    global LAUNCHES_BWD_DX
    if gemm_route(g, w, own, pm):
        weff = masked_matmul_select(w, own, pm, task_id, threshold,
                                    mask_mode)
        dx = launch_gemm_tn(g, weff)
    else:
        x4, w4, own4, pm4 = _as_conv(x, w, own, pm)
        dx = _mc.launch_bwd_dx(g.reshape(g.shape[0], 1, 1, g.shape[1]), x4,
                               w4, own4, pm4, int(task_id), 1, "VALID",
                               float(threshold), mask_mode).reshape(x.shape)
    LAUNCHES_BWD_DX += 1
    return dx


def masked_matmul_bwd_dw(g, x, w, own, task_id):
    """(dw, dpm) for output gradient g (M, N): K3 on CUDA tensors, the
    plain version on CPU tensors."""
    if x.device.type == "cpu":
        return masked_matmul_bwd_dw_plain(g, x, w, own, task_id)
    global LAUNCHES_BWD_DW
    x4, w4, own4 = _as_conv(x, w, own)
    dw, dpm = _mc.launch_bwd_dw(g.reshape(g.shape[0], 1, 1, g.shape[1]), x4,
                                w4, own4, int(task_id), 1, "VALID")
    LAUNCHES_BWD_DW += 1
    return dw.reshape(w.shape), dpm.reshape(w.shape)


def masked_matmul_select(w, own, pm, task_id,
                         threshold: float = DEFAULT_THRESHOLD,
                         mask_mode: str = "binary", transpose: bool = False):
    """The bf16 effective weight of w (K, N): the select kernel on CUDA
    tensors, the plain version on CPU tensors. (K, N), or (N, K) with
    `transpose` (the forward GEMM's operand)."""
    if w.device.type == "cpu":
        return masked_matmul_select_plain(w, own, pm, task_id, threshold,
                                          mask_mode, transpose)
    global LAUNCHES_SELECT
    out = launch_select(w, own, pm, task_id, threshold, mask_mode, transpose)
    LAUNCHES_SELECT += 1
    return out


class _MaskedMatmul(torch.autograd.Function):
    """y = x @ w_eff; residuals x, w, own, pm (as the JAX custom_vjp)."""

    @staticmethod
    def forward(ctx, x, w, own, pm, task_id, threshold, mask_mode):
        ctx.save_for_backward(x, w, own, pm)
        ctx.conf = (task_id, threshold, mask_mode)
        if x.device.type == "cpu":
            return masked_matmul_plain(x, w, own, pm, task_id, threshold,
                                       mask_mode)
        global LAUNCHES
        if gemm_route(x, w, own, pm):
            wt = masked_matmul_select(w, own, pm, task_id, threshold,
                                      mask_mode, transpose=True)
            y = launch_gemm_tn(x, wt)
        else:
            x4, w4, own4, pm4 = _as_conv(x, w, own, pm)
            y = _mc.launch_fwd(x4, w4, own4, pm4, task_id, 1, "VALID",
                               threshold, mask_mode).reshape(
                                   x.shape[0], w.shape[1])
        LAUNCHES += 1
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, own, pm = ctx.saved_tensors
        task_id, threshold, mask_mode = ctx.conf
        g = g.to(x.dtype).contiguous()
        dx = (masked_matmul_bwd_dx(g, x, w, own, pm, task_id, threshold,
                                   mask_mode)
              if ctx.needs_input_grad[0] else None)
        dw, dpm = masked_matmul_bwd_dw(g, x, w, own, task_id)
        return dx, dw, None, dpm, None, None, None


def masked_matmul(x, w, own, pm, task_id,
                  threshold: float = DEFAULT_THRESHOLD,
                  mask_mode: str = "binary"):
    """y = x @ w_eff with the ownership/piggymask select fused into the
    weight tiles. x: (M, K) contiguous; w, pm: (K, N) f32; own: (K, N)
    int8. Returns (M, N) in x's dtype, f32 accumulation. Differentiable in
    x, w and pm (see the module docstring)."""
    if mask_mode not in _MODES:
        raise ValueError(f"masked_matmul: mask_mode {mask_mode!r} not in {_MODES}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"masked_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (M, K) and (K, N)")
    return _MaskedMatmul.apply(x, w, own, pm, int(task_id), float(threshold),
                               mask_mode)


# ------------------------------------------------------------- kernels ----
# `launch_*` check their inputs and launch one kernel of
# csrc/masked_matmul.cu on the current stream; they count nothing (the ops
# above add to their counters).

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = _build.load("masked_matmul")
    if lib.masked_matmul_select_bf16.argtypes is None:
        lib.masked_matmul_select_bf16.argtypes = [_P] * 4 + [_I] * 3 + [
            _F, _I, _I, _P]
        lib.masked_matmul_select_bf16.restype = ctypes.c_int
        lib.masked_matmul_gemm_tn_bf16.argtypes = [_P] * 3 + [_I] * 6 + [_P]
        lib.masked_matmul_gemm_tn_bf16.restype = ctypes.c_int
        lib.masked_conv_gemm_bf16.argtypes = [_P] * 3 + [_I] * 17 + [_P]
        lib.masked_conv_gemm_bf16.restype = ctypes.c_int
    return lib


def _check(cond, msg):
    if not cond:
        raise ValueError(f"masked_matmul kernel: {msg}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_select(w, own, pm, task_id, threshold, mask_mode, transpose):
    """The select pass: bf16 w_eff (K, N), or w_eff^T (N, K)."""
    _check(w.is_cuda, f"w must be a CUDA tensor, got {w.device}")
    _check(w.dim() == 2 and w.dtype == torch.float32, "w must be (K, N) f32")
    _check(own.dtype == torch.int8 and own.shape == w.shape,
           "own must be int8 with w's shape")
    _check(pm.dtype == torch.float32 and pm.shape == w.shape,
           "pm must be float32 with w's shape")
    k, n = w.shape
    _check(k % 8 == 0 and n % 8 == 0, f"K and N must be multiples of 8, "
           f"got {(k, n)}")
    for name, t in (("w", w), ("own", own), ("pm", pm)):
        _check(t.device == w.device, f"{name} is on {t.device}, w on {w.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(w.data_ptr() % 16 == 0 and pm.data_ptr() % 16 == 0
           and own.data_ptr() % 4 == 0,
           "w and pm must be 16-byte aligned, own 4-byte")
    out = torch.empty((n, k) if transpose else (k, n), dtype=torch.bfloat16,
                      device=w.device)
    if out.numel() == 0:
        return out
    err = _lib().masked_matmul_select_bf16(
        w.data_ptr(), own.data_ptr(), pm.data_ptr(), out.data_ptr(), k, n,
        int(task_id), float(threshold), int(mask_mode == "ternary"),
        int(transpose), _stream(w))
    if err:
        raise RuntimeError(f"masked_matmul_select launch failed: CUDA error {err}")
    return out


def launch_gemm_tn(a, bt):
    """The TN GEMM: C (M, Nout) = A (M, R) @ Bt (Nout, R)^T, bf16, f32
    sums, planned by `gemm_plan`."""
    _check(a.is_cuda and bt.device == a.device,
           f"a and bt must be on one CUDA device, got {a.device}, {bt.device}")
    _check(a.dtype == bt.dtype == torch.bfloat16, "a and bt must be bf16")
    _check(a.dim() == 2 and bt.dim() == 2 and a.shape[1] == bt.shape[1],
           f"a {tuple(a.shape)} and bt {tuple(bt.shape)} are not (M, R) and "
           "(Nout, R)")
    _check(a.is_contiguous() and bt.is_contiguous(), "a and bt must be contiguous")
    (m, r), nout = a.shape, bt.shape[0]
    _check(r % 8 == 0 and nout % 8 == 0,
           f"R and Nout must be multiples of 8, got {(r, nout)}")
    _check(a.data_ptr() % 16 == 0 and bt.data_ptr() % 16 == 0,
           "a and bt must be 16-byte aligned")
    c = torch.empty((m, nout), dtype=torch.bfloat16, device=a.device)
    if c.numel() == 0 or r == 0:
        return c.zero_()
    bn, stages, grid = gemm_plan(m, r, nout, _sms(a.device.index or 0))
    err = _lib().masked_matmul_gemm_tn_bf16(
        a.data_ptr(), bt.data_ptr(), c.data_ptr(), m, r, nout, bn, stages,
        grid, _stream(a))
    if err:
        raise RuntimeError(f"masked_matmul_gemm_tn launch failed: CUDA error {err}")
    return c


def launch_conv_gemm(a, bt, grid_hw, kh, kw, pad_top, pad_left, dgrad):
    """The masked conv's implicit GEMM over the selected weight (stride 1),
    planned by `conv_plan`. Forward: y (N, Ho, Wo, Cout) from a = x (N, H,
    W, Cin) and bt = w_eff^T (Cout, kh*kw*Cin). dgrad: dx (N, H, W, Cin)
    from a = g (N, Ho, Wo, Cout) and bt = w_eff (kh*kw*Cin, Cout). grid_hw
    is the output's (rows, columns); the pads are the forward's."""
    _check(a.is_cuda and bt.device == a.device,
           f"a and bt must be on one CUDA device, got {a.device}, {bt.device}")
    _check(a.dtype == bt.dtype == torch.bfloat16, "a and bt must be bf16")
    _check(a.dim() == 4 and bt.dim() == 2, "a must be NHWC and bt 2-D")
    _check(a.is_contiguous() and bt.is_contiguous(), "a and bt must be contiguous")
    n, ah, aw, ch = a.shape
    taps = kh * kw
    nout = bt.shape[0] // taps if dgrad else bt.shape[0]
    want = (taps * nout, ch) if dgrad else (nout, taps * ch)
    _check(tuple(bt.shape) == want, f"bt {tuple(bt.shape)} is not {want}")
    _check(ch % 64 == 0 and nout % 8 == 0,
           f"reduction channels must be a multiple of 64 and output channels "
           f"of 8, got {(ch, nout)}")
    _check(a.data_ptr() % 16 == 0 and bt.data_ptr() % 16 == 0,
           "a and bt must be 16-byte aligned")
    oh, ow = grid_hw
    out = torch.empty((n, oh, ow, nout), dtype=torch.bfloat16, device=a.device)
    if out.numel() == 0:
        return out
    (_, _, box_h, box_n), bn, stages, grid = conv_plan(
        n, oh, ow, ch, nout, taps, _sms(a.device.index or 0))
    err = _lib().masked_conv_gemm_bf16(
        a.data_ptr(), bt.data_ptr(), out.data_ptr(), n, ah, aw, ch, oh, ow,
        nout, kh, kw, pad_top, pad_left, int(dgrad), box_h, box_n, bn,
        stages, grid, _stream(a))
    if err:
        raise RuntimeError(f"masked_conv_gemm launch failed: CUDA error {err}")
    return out
