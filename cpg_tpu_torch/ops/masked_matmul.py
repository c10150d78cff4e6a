"""Masked matmul: the CPG SharableLinear with the ownership/piggymask select
inside the GEMM's weight-tile load, forward and backward.

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

On CUDA tensors the three products run the masked-conv kernels K1, K2 and
K3 (`csrc/masked_conv_{fwd,bwd_dx,bwd_dw}.cu`) at the 1x1, stride-1,
unpadded geometry: x (M, K) is viewed as (M, 1, 1, K) and w (K, N) as
(1, 1, K, N), which is the same GEMM, so one kernel family serves conv and
dense, as it did on the TPU. The kernels' predicates hold: bf16 needs
N % 4 == 0 and 16-byte aligned tensors (every ViT width meets them; any M
is taken, ragged M = N*196 of vit_b16 included). On CPU tensors the plain
versions run. This module keeps its own launch counters.
"""

from __future__ import annotations

import torch

from . import masked_conv as _mc
from .binarize import DEFAULT_THRESHOLD
from .masked import effective_kernel

# kernel launches of the dense route since the last reset
LAUNCHES = 0          # K1 at 1x1, forward
LAUNCHES_BWD_DX = 0   # K2 at 1x1
LAUNCHES_BWD_DW = 0   # K3 at 1x1

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
    """dx for output gradient g (M, N): K2 on CUDA tensors, the plain
    version on CPU tensors."""
    if x.device.type == "cpu":
        return masked_matmul_bwd_dx_plain(g, x, w, own, pm, task_id,
                                          threshold, mask_mode)
    global LAUNCHES_BWD_DX
    x4, w4, own4, pm4 = _as_conv(x, w, own, pm)
    dx = _mc.launch_bwd_dx(g.reshape(g.shape[0], 1, 1, g.shape[1]), x4, w4,
                           own4, pm4, int(task_id), 1, "VALID",
                           float(threshold), mask_mode)
    LAUNCHES_BWD_DX += 1
    return dx.reshape(x.shape)


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
        x4, w4, own4, pm4 = _as_conv(x, w, own, pm)
        y = _mc.launch_fwd(x4, w4, own4, pm4, task_id, 1, "VALID", threshold,
                           mask_mode)
        LAUNCHES += 1
        return y.reshape(x.shape[0], w.shape[1])

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

