#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`cpg_tpu_torch`), end to end.

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one. It
  1. prints the card (nvidia-smi name and power limit) and builds the CUDA
     kernels from `cpg_tpu_torch/csrc` (one nvcc per source, in parallel);
  2. holds each of the six kernels against its plain PyTorch version on the
     card at the shapes VGG16-BN (width 1.0) gives it at batch 256, and
     times kernel, plain version and a library yardstick with CUDA events
     (TF32 off), and kernel and yardstick again by torch.profiler's device
     time (`device_ms`, `library_device_ms`: no host gaps between calls):
     the masked conv forward (K1) and its backward (K2 dx, K3
     gated dw/dpm), the fused BN+ReLU+conv3x3 forward (K4) and its backward
     (K5 dx/da/db, K6 dW). K4 and K5 at the eight bf16 seams take the
     TMA/wgmma GEMM route (`route` "gemm", with the `plan`, the route
     kernel's own device time `gemm_kernel_device_ms`, K5's tile-sum pass
     `colsum_device_ms`, and cuDNN's product alone on the materialised
     activation or on g as `cudnn_device_ms`; two launches equal bits);
     a width-0.125 conv3 (16 channels, bf16) and the f32 conv3 rows hold
     the earlier K4 and K5 (each row fails on another route). K1 and K2 at
     conv2/4/7/10 (binary and ternary)
     take the GEMM route (`route`: the select pass, held alone against its
     plain version bit for bit in `masked_conv_select` rows, then the
     TMA/wgmma implicit GEMM of csrc/masked_matmul.cu; `select_device_ms`
     and `gemm_kernel_device_ms` are the two launches' own device times);
     conv0, a width-0.125 conv2 (Cin 8, Cout 16) and the f32 conv7 hold
     the old K1 and K2. K3 takes csrc/masked_matmul_wgrad.cu's split-M
     wgmma wgrad GEMM at conv2/4/7/10 (`route` "wgmma") and over conv0's
     im2col patches ("im2col+wgmma"; the im2col kernel also alone, bit for
     bit, in a `masked_conv_im2col` row), with the device ms of the GEMM,
     the gate pass and the im2col, cuDNN's weight gradient alone
     (`cudnn_device_ms`), the plan and its partials' bytes; the
     width-0.125 conv2 and the f32 conv7 hold the old K3. Every K1, K2 and
     K3 row checks that two launches give the same bits;
  3. serve phase: builds a seeded two-task VGG16-BN state at full width
     (init_state -> start_task -> one_shot_prune 0.5 -> start_task, task 2's
     piggymask perturbed so some entries fall below the threshold), runs a
     bf16 `TaskServer(fused_chain=True)` through export -> load, answers
     requests of 1, 8, 37, 256 and 1024 rows plus one mixed-task list, and
     compares every answer with the unfused server;
  4. masked eval phase: the eval step with the masked-conv and fused-chain
     kernels against the default effective-params step, on task 2;
  5. train phase: the bf16 train step of task 2 with all six kernels
     (`use_pallas_conv`, `use_fused_chain`) against the default step
     (effective weights, cuDNN, autograd) from copies of one state with the
     same batches and augmentation draws: the update of every tensor after
     one step, the losses over three, the no-forgetting invariants, each
     kernel's launches in one step, and ms/step at batch 256 and 1024;
  6. ViT kernel phases: the flash-attention kernels (K7 forward; the
     one-launch backward `flash_bwd`, csrc/flash_bwd_wgmma.cu, where
     `bwd_route` takes the shape, two launches equal bits, its walk and
     ring in `plan` and the pair's device time beside it; the dQ + dK/dV
     pair at every shape) at vit_cifar's batch-256 shape (256, 64, 4, 64),
     vit_b16's (64, 196, 12, 64), a causal T = 70, T = 320 (off the
     route) and in f32, and the dense route
     (masked_matmul; bf16: the select pass and TN GEMM of
     csrc/masked_matmul.cu for y and dx, each also alone against its plain
     version, two launches equal bits; f32: K1-K2 at the 1x1 geometry; dw:
     the wgrad GEMM in bf16, with the columns of the conv rows and cuBLAS
     x^T g alone as `gemm_device_ms`, K3 at 1x1 in f32) at vit_cifar's
     three projection shapes and one ragged
     vit_b16 shape, each against its plain version and timed beside a
     library yardstick (`scaled_dot_product_attention`, forward and its
     autograd backward alone; `effective_kernel` + `torch.matmul`, and
     `torch.matmul` on the pre-selected weight);
  7. ViT serve phase: a seeded two-task vit_cifar state at full width, a
     bf16 `TaskServer` through export -> load (the effective-params einsum
     path, as in `cpg_tpu`) against the f32 server, p50 and img/s at
     bucket 256;
  8. ViT eval phase: the eval step with the dense route and flash
     attention (`use_pallas`, `flash_attention`) against the default step;
  9. ViT train phase: task 2 as for VGG16-BN, with `use_pallas` and
     `flash_attention` (exact launches per step: flash forward 6 and the
     one-launch backward 6, no dQ or dK/dV, dense
     36 + 36 + 36 and 72 select passes);
 10. cycle phase: `run_sequence` over three synthetic CIFAR-100 tasks of
     5 classes on the bf16 kernel step, VGG16-BN at width 1.0, task 3
     growing once to 1.5 under an unreachable goal; per phase steps,
     ms/step and img/s, `check_state` at every task boundary, old-task
     logits across add-task and prune (max|diff| must be 0), the growth
     audit against its bound, a second `run_sequence` over the checkpoints
     (every task resumed, the same state bit for bit), ms per prune event
     at width 1.0 and seconds for `grow_state`;
 11. checks that each phase reached its kernels (the serve and eval phases
     their forwards, the train phases their backwards, the cycle K1-K6),
     prints the kernels' JSON line (launch counts from the serve, eval,
     train and cycle phases, errors, times, bounds), the card line, and
     last the result line.
Each phase raises on failure. Per-shape results also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
BATCH = 256
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published peaks
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor cores
              "float32": 67e12}    # f32 outside the tensor cores
BF16_TOL = 2e-2                    # max|diff| <= BF16_TOL * max|ref|
F32_TOL = 1e-4                     # rtol and atol
SUM_TOL = 1e-4                     # f32 results of long f32 sums (dW, dpm):
                                   # max|diff| <= SUM_TOL * max|ref|, the
                                   # kernel and the plain version differing
                                   # only in summation order
AFFINE_SUM_TOL = 1e-3              # da, db: sums of dact * x with
                                   # cancellation, relative to max|ref|
THR = 5e-3                         # the piggymask threshold

# (layer, H=W, Cin, Cout) of VGG16-BN at width 1.0, CIFAR 32x32 input
MASKED_CONV_SHAPES = [("conv0", 32, 3, 64), ("conv2", 16, 64, 128),
                      ("conv4", 8, 128, 256), ("conv7", 4, 256, 512),
                      ("conv10", 2, 512, 512)]
CHAIN_SHAPES = [("conv1", 32, 64, 64), ("conv3", 16, 128, 128),
                ("conv5", 8, 256, 256), ("conv6", 8, 256, 256),
                ("conv8", 4, 512, 512), ("conv9", 4, 512, 512),
                ("conv11", 2, 512, 512), ("conv12", 2, 512, 512)]
# flash attention (name, N, T, H, hd, causal, dtype, launches per vit_cifar
# train step at batch 256; 0 = an extra shape, not on the timed step). The
# backward takes `flash.bwd_route`'s one-launch kernel at the bf16 hd-64
# shapes up to T = 256; T = 320 and f32 keep the dQ + dK/dV pair on the
# path, which every shape also times beside it.
FLASH_SHAPES = [("vit_cifar", BATCH, 64, 4, 64, False, "bfloat16", 6),
                ("vit_b16", 64, 196, 12, 64, False, "bfloat16", 0),
                ("causal_t70", BATCH, 70, 4, 64, True, "bfloat16", 0),
                ("off_route_t320", 32, 320, 4, 64, False, "bfloat16", 0),
                ("vit_cifar_f32", 32, 64, 4, 64, False, "float32", 0)]
# dense route (name, M, K, N, dtype, mode, launches per vit_cifar step)
DENSE_SHAPES = [("qkv_proj", BATCH * 64, 256, 256, "bfloat16", "binary", 24),
                ("fc1", BATCH * 64, 256, 1024, "bfloat16", "binary", 6),
                ("fc2", BATCH * 64, 1024, 256, "bfloat16", "binary", 6),
                ("fc2_ternary", BATCH * 64, 1024, 256, "bfloat16", "ternary", 0),
                ("vit_b16_qkv", 64 * 196, 768, 768, "bfloat16", "binary", 0),
                ("qkv_proj_f32", 2048, 256, 256, "float32", "binary", 0)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(fn, iters, warmup, tries):
    """{kernel name: device us} over `iters` calls of fn by torch.profiler,
    or None when the profiler records no device time in `tries` profiles,
    which CUPTI does now and then in a long run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us[e.key] = us.get(e.key, 0.0) + e.self_device_time_total
        if sum(us.values()) > 0:
            return us
    print("device_ms: the profiler recorded no device time", flush=True)
    return None


def device_ms(fn, iters=20, warmup=3, tries=5):
    """Device time per call of fn by torch.profiler: the summed time of the
    kernels (and copies) it puts on the card, without host gaps. None
    ("not measured") when the profiler records nothing."""
    us = _device_us(fn, iters, warmup, tries)
    return None if us is None else sum(us.values()) / 1e3 / iters


def kernel_device_ms(fn, keys, iters=20, warmup=3, tries=5):
    """Device ms per call of fn of the kernels whose names contain each
    key (0.0 for a key no kernel matches; None when nothing was
    recorded)."""
    us = _device_us(fn, iters, warmup, tries)
    return {k: None if us is None else
            sum(v for name, v in us.items() if k in name) / 1e3 / iters
            for k in keys}


def timed(kern, plain, library) -> dict:
    """CUDA-event ms of the kernel, its plain version and the library call,
    and the profiler's device ms of the kernel and the library call."""
    return dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                library_ms=time_ms(library), device_ms=device_ms(kern),
                library_device_ms=device_ms(library))


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(got, want, dtype_name: str, what: str, rel=None) -> float:
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (g - w).abs().max().item()
    if rel is not None:
        ok = err <= rel * w.abs().max().item() + 1e-6
    elif dtype_name == "float32":
        ok = bool(((g - w).abs() <= F32_TOL + F32_TOL * w.abs()).all())
    else:
        ok = err <= BF16_TOL * w.abs().max().item()
    if not ok:
        raise AssertionError(f"{what}: max|diff| {err} (max|ref| "
                             f"{w.abs().max().item()}) outside tolerance")
    return err


def twice(torch, fn, what):
    """fn's result (a tensor or a tuple of them), after checking that a
    second launch gives its bits."""
    a, b = fn(), fn()
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    if not all(torch.equal(u, v) for u, v in pairs):
        raise AssertionError(f"{what}: two launches differ")
    return a


# the wgrad GEMM's kernels by name (csrc/masked_matmul_wgrad.cu)
WGRAD_KERNELS = ("wgrad_wgmma_kernel", "wgrad_gate_kernel",
                 "im2col_bf16_kernel")


def wgrad_cols(kern, plan, k, n):
    """Per-layer columns of a K3 row on the wgrad GEMM: the device ms of
    its kernels in the op (the GEMM, the gate pass that sums the splits
    and gates, the im2col), the plan and the bytes of the f32 partials
    (written once, read once)."""
    from cpg_tpu_torch.ops import masked_matmul as mm

    parts = kernel_device_ms(kern, WGRAD_KERNELS)
    bn, splits = plan[-4], plan[-3]
    tiles = -(-k // mm.WGRAD_BK) * -(-n // bn)
    return {"gemm_kernel_device_ms": parts["wgrad_wgmma_kernel"],
            "gate_device_ms": parts["wgrad_gate_kernel"],
            "im2col_device_ms": parts["im2col_bf16_kernel"],
            "plan": [list(p) if isinstance(p, tuple) else p for p in plan],
            "partial_bytes": (splits * tiles * mm.WGRAD_BK * bn * 4
                              if splits > 1 else 0)}


def conv_route_rows(torch, w, own, pm, mode, gemm, cudnn, dgrad, common):
    """On the masked conv's GEMM route: the select pass alone against its
    plain version (bit for bit; a `masked_conv_select` row), and for the
    op's row the select's and the implicit GEMM's own device times and
    cuDNN's on the pre-selected weight (`cudnn(weff)`, the GEMM half's
    yardstick)."""
    from cpg_tpu_torch.ops import masked_matmul as mm

    views = [t.reshape(-1, w.shape[-1]) for t in (w, own, pm)]
    kern = lambda: mm.launch_select(*views, 2, THR, mode, not dgrad)
    plain = lambda: mm.masked_matmul_select_plain(*views, 2, THR, mode,
                                                  transpose=not dgrad)
    weff, want = kern(), plain()
    if not torch.equal(weff.view(torch.int16), want.view(torch.int16)):
        raise AssertionError(f"masked_conv select {common['layer']}: bits "
                             "differ from the plain version")
    b_ms, b_by = bound(11 * w.numel(), 0.0, "bfloat16")
    sel_dev = device_ms(kern)
    row = dict(kernel="masked_conv_select", **common,
               layout="dx" if dgrad else "fwd", max_abs_err=0.0,
               ms=time_ms(kern), device_ms=sel_dev, plain_ms=time_ms(plain),
               library_ms=None, library_device_ms=None, bound_ms=b_ms,
               bound_by=b_by)
    w_sel = (weff.reshape(w.shape) if dgrad else weff.reshape(
        w.shape[-1], *w.shape[:-1]).permute(1, 2, 3, 0)).contiguous()  # HWIO
    return row, dict(select_device_ms=sel_dev,
                     gemm_kernel_device_ms=device_ms(lambda: gemm(weff)),
                     cudnn_device_ms=device_ms(lambda: cudnn(w_sel)))


def masked_conv_phase(torch, dev, name, hw, cin, cout, dtype_name, mode,
                      per_step=None):
    """K1 at one shape (the GEMM route or the old kernel, as `conv_route`
    decides), two launches equal bits; on the route also its select row."""
    from cpg_tpu_torch.ops import masked_conv as mc
    from cpg_tpu_torch.ops import masked_matmul as mm
    from cpg_tpu_torch.ops.conv import conv2d_nhwc
    from cpg_tpu_torch.ops.masked import effective_kernel

    dt = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn((BATCH, hw, hw, cin), generator=g).to(dev, dt)
    w = (torch.randn((3, 3, cin, cout), generator=g)
         * (2.0 / (9 * cout)) ** 0.5).to(dev)
    own = torch.randint(0, 4, w.shape, generator=g, dtype=torch.int8).to(dev)
    pm = (torch.randn(w.shape, generator=g) * 1e-2).to(dev)
    kern = lambda: mc.masked_conv2d(x, w, own, pm, 2, mask_mode=mode)
    plain = lambda: mc.masked_conv2d_plain(x, w, own, pm, 2, mask_mode=mode)
    library = lambda: conv2d_nhwc(
        x, effective_kernel(w, own, pm, 2, mask_mode=mode).to(dt), 1,
        (1, 1, 1, 1))
    err = compare(twice(torch, kern, f"masked_conv {name}"), plain(),
                  dtype_name, f"masked_conv {name}")
    elt = x.element_size()
    nbytes = x.numel() * elt + w.numel() * 9 + BATCH * hw * hw * cout * elt
    flops = 2.0 * BATCH * hw * hw * 9 * cin * cout
    b_ms, b_by = bound(nbytes, flops, dtype_name)
    common = dict(layer=name, dtype=dtype_name, mode=mode,
                  shape=[BATCH, hw, hw, cin, cout],
                  **({} if per_step is None else {"per_step": per_step}))
    route = mc.conv_route(x, w, 1, "SAME")
    rows, extra = [], {}
    if route:
        sel, extra = conv_route_rows(
            torch, w, own, pm, mode,
            lambda wt: mm.launch_conv_gemm(x, wt, (hw, hw), 3, 3, 1, 1, False),
            lambda w_sel: conv2d_nhwc(x, w_sel, 1, (1, 1, 1, 1)), False,
            common)
        rows.append(sel)
    rows.insert(0, dict(kernel="masked_conv_fwd", **common,
                        route="select+gemm" if route else "k1",
                        max_abs_err=err, **timed(kern, plain, library),
                        bound_ms=b_ms, bound_by=b_by, **extra))
    return rows


def fused_chain_phase(torch, dev, name, hw, cin, cout, dtype_name,
                      want_route, per_step=None):
    """K4 at one seam (the GEMM route or the earlier kernel, as
    `fused_chain.fwd_route` decides; fails unless it is `want_route`), two
    launches equal bits; on the route its plan and the kernel's own device
    time; cuDNN's conv alone on the materialised activation beside it."""
    from cpg_tpu_torch.ops import fused_chain as fc
    from cpg_tpu_torch.ops import masked_matmul as mm
    from cpg_tpu_torch.ops.conv import conv2d_nhwc

    dt = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((BATCH, hw, hw, cin), generator=g).to(dev, dt)
    a = (torch.rand((cin,), generator=g) + 0.5).to(dev)
    b = (torch.randn((cin,), generator=g) * 0.3).to(dev)
    w = (torch.randn((3, 3, cin, cout), generator=g)
         * (2.0 / (9 * cout)) ** 0.5).to(dev)
    wd = w.to(dt)
    kern = lambda: fc.fused_affine_relu_conv(x, a, b, wd, dt)
    plain = lambda: fc.fused_oracle(x, a, b, wd, dt)
    ad, bd = a.to(dt), b.to(dt)
    library = lambda: conv2d_nhwc(torch.relu(x * ad + bd), wd, 1, (1, 1, 1, 1))
    err = compare(twice(torch, kern, f"fused_chain {name}"), plain(),
                  dtype_name, f"fused_chain {name}")
    elt = x.element_size()
    nbytes = (x.numel() * elt + 8 * cin + wd.numel() * elt
              + BATCH * hw * hw * cout * elt)
    flops = 2.0 * BATCH * hw * hw * 9 * cin * cout
    b_ms, b_by = bound(nbytes, flops, dtype_name)
    act = torch.relu(x * ad + bd)
    extra = dict(route="k4")
    if fc.fwd_route(x, wd, dt):
        plan = mm.fused_fwd_plan(BATCH, hw, hw, cin, cout, mm._sms(0))
        extra = dict(route="gemm", plan=[list(p) if isinstance(p, tuple)
                                         else p for p in plan],
                     gemm_kernel_device_ms=kernel_device_ms(
                         kern, ("fwd_wgmma_kernel",))["fwd_wgmma_kernel"])
    if extra["route"] != want_route:
        raise AssertionError(f"fused_chain {name}: route {extra['route']}, "
                             f"expected {want_route}")
    # cuDNN's product alone on the materialised activation: the GEMM half's
    # yardstick
    extra["cudnn_device_ms"] = device_ms(
        lambda: conv2d_nhwc(act, wd, 1, (1, 1, 1, 1)))
    return dict(kernel="fused_chain_fwd", layer=name, dtype=dtype_name,
                shape=[BATCH, hw, hw, cin, cout], max_abs_err=err,
                **timed(kern, plain, library), bound_ms=b_ms, bound_by=b_by,
                **extra, **({} if per_step is None else {"per_step": per_step}))


def _conv_inputs(torch, dev, hw, cin, cout, dt, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((BATCH, hw, hw, cin), generator=g).to(dev, dt)
    w = (torch.randn((3, 3, cin, cout), generator=g)
         * (2.0 / (9 * cout)) ** 0.5).to(dev)
    gy = (torch.randn((BATCH, hw, hw, cout), generator=g) * 0.1).to(dev, dt)
    return g, x, w, gy


def masked_conv_bwd_phases(torch, dev, name, hw, cin, cout, dtype_name, mode,
                           with_dx=True, per_step=None):
    """K2 (when the layer's input needs a gradient; the GEMM route or the
    old kernel, two launches equal bits) and K3 at one shape."""
    from cpg_tpu_torch.ops import masked_conv as mc
    from cpg_tpu_torch.ops import masked_matmul as mm
    from cpg_tpu_torch.ops.masked import effective_kernel

    dt = getattr(torch, dtype_name)
    gen, x, w, gy = _conv_inputs(torch, dev, hw, cin, cout, dt, SEED + 4)
    own = torch.randint(0, 4, w.shape, generator=gen, dtype=torch.int8).to(dev)
    pm = (torch.randn(w.shape, generator=gen) * 1e-2).to(dev)
    elt, n_w = x.element_size(), w.numel()
    flops = 2.0 * BATCH * hw * hw * 9 * cin * cout
    gt, xt = gy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2)
    common = dict(layer=name, dtype=dtype_name, mode=mode,
                  shape=[BATCH, hw, hw, cin, cout],
                  **({} if per_step is None else {"per_step": per_step}))
    rows = []
    if with_dx:
        kern = lambda: mc.masked_conv2d_bwd_dx(gy, x, w, own, pm, 2,
                                               mask_mode=mode)
        plain = lambda: mc.masked_conv2d_bwd_dx_plain(gy, x, w, own, pm, 2,
                                                      mask_mode=mode)
        library = lambda: torch.nn.grad.conv2d_input(
            xt.shape, effective_kernel(w, own, pm, 2, mask_mode=mode)
            .to(dt).permute(3, 2, 0, 1), gt, 1, 1)
        err = compare(twice(torch, kern, f"masked_conv_bwd_dx {name}"),
                      plain(), dtype_name, f"masked_conv_bwd_dx {name}")
        b_ms, b_by = bound(gy.numel() * elt + 9 * n_w + x.numel() * elt,
                           flops, dtype_name)
        route = mc.conv_route(x, w, 1, "SAME")
        extra = {}
        if route:
            sel, extra = conv_route_rows(
                torch, w, own, pm, mode,
                lambda weff: mm.launch_conv_gemm(gy, weff, (hw, hw), 3, 3, 1,
                                                 1, True),
                lambda w_sel: torch.nn.grad.conv2d_input(
                    xt.shape, w_sel.permute(3, 2, 0, 1), gt, 1, 1),
                True, common)
        rows.append(dict(kernel="masked_conv_bwd_dx", **common,
                         route="select+gemm" if route else "k2",
                         max_abs_err=err, **timed(kern, plain, library),
                         bound_ms=b_ms, bound_by=b_by, **extra))
        if route:
            rows.append(sel)

    kern = lambda: mc.masked_conv2d_bwd_dw(gy, x, w, own, 2)
    plain = lambda: mc.masked_conv2d_bwd_dw_plain(gy, x, w, own, 2)
    cudnn = lambda: torch.nn.grad.conv2d_weight(xt, (cout, cin, 3, 3), gt, 1, 1)

    def library():
        G = cudnn().permute(2, 3, 1, 0).float()
        return (torch.where(own == 2, G, 0.0),
                torch.where((own > 0) & (own < 2), G * w, 0.0))

    got = twice(torch, kern, f"masked_conv_bwd_dw {name}")
    want = plain()
    err = max(compare(got[0], want[0], "float32", f"masked_conv_bwd_dw dw {name}",
                      rel=SUM_TOL),
              compare(got[1], want[1], "float32", f"masked_conv_bwd_dw dpm {name}",
                      rel=SUM_TOL))
    b_ms, b_by = bound(x.numel() * elt + gy.numel() * elt + 5 * n_w + 8 * n_w,
                       flops, dtype_name)
    extra, route = {}, "k3"
    if mc.conv_route(x, w, 1, "SAME"):
        route = "wgmma"
        plan = mm.wgrad_conv_plan(BATCH, hw, hw, cin, cout, 9, mm._sms(0))
        extra = wgrad_cols(kern, plan, 9 * cin, cout)
    elif mc.im2col_route(x, w):
        route = "im2col+wgmma"
        plan = mm.wgrad_plan(BATCH * hw * hw, 9 * cin, cout, mm._sms(0))
        extra = wgrad_cols(kern, plan, 9 * cin, cout)
        rows.append(im2col_row(torch, x, -(-9 * cin // 8) * 8, common))
    if extra:  # cuDNN's weight gradient alone: the GEMM's yardstick
        extra["cudnn_device_ms"] = device_ms(cudnn)
    rows.append(dict(kernel="masked_conv_bwd_dw", **common, route=route,
                     max_abs_err=err, **timed(kern, plain, library),
                     bound_ms=b_ms, bound_by=b_by, **extra))
    return rows


def im2col_row(torch, x, kp, common):
    """conv0's im2col kernel alone against its plain version, bit for bit;
    bound by its bytes (x read once, the patches written once)."""
    from cpg_tpu_torch.ops import masked_matmul as mm

    kern = lambda: mm.launch_im2col(x, 3, 3, 1, (1, 1, 1, 1), kp)
    plain = lambda: mm.im2col_plain(x, 3, 3, 1, (1, 1, 1, 1), kp)
    got = kern()
    if not torch.equal(got.view(torch.int16), plain().view(torch.int16)):
        raise AssertionError(f"masked_conv_im2col {common['layer']}: bits "
                             "differ from the plain version")
    b_ms, b_by = bound((x.numel() + got.numel()) * x.element_size(), 0.0,
                       "bfloat16")
    return dict(kernel="masked_conv_im2col", **common, max_abs_err=0.0,
                ms=time_ms(kern), device_ms=device_ms(kern),
                plain_ms=time_ms(plain), library_ms=None,
                library_device_ms=None, bound_ms=b_ms, bound_by=b_by)


def fused_chain_bwd_phases(torch, dev, name, hw, cin, cout, dtype_name,
                           want_route, per_step=None):
    """K5 (the GEMM route or the earlier kernel, as `fused_chain.gemm_route`
    decides; fails unless it is `want_route`; two launches equal bits, with
    its plan, kernels' device times and cuDNN's dgrad alone on the route)
    and K6 at one shape."""
    from cpg_tpu_torch.ops import fused_chain as fc
    from cpg_tpu_torch.ops import masked_matmul as mm

    dt = getattr(torch, dtype_name)
    gen, x, w, gy = _conv_inputs(torch, dev, hw, cin, cout, dt, SEED + 5)
    a = (torch.rand((cin,), generator=gen) + 0.5).to(dev)
    b = (torch.randn((cin,), generator=gen) * 0.3).to(dev)
    wd = w.to(dt)
    elt = x.element_size()
    flops = 2.0 * BATCH * hw * hw * 9 * cin * cout
    gt, xt = gy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2)
    common = dict(layer=name, dtype=dtype_name, shape=[BATCH, hw, hw, cin, cout],
                  **({} if per_step is None else {"per_step": per_step}))

    kern = lambda: fc.fused_bwd_dx(x, a, b, wd, gy, dt)
    plain = lambda: fc.fused_bwd_dx_plain(x, a, b, wd, gy, dt)

    def library():
        dact = torch.nn.grad.conv2d_input(xt.shape, wd.permute(3, 2, 0, 1),
                                          gt, 1, 1).permute(0, 2, 3, 1)
        xf = x.float()
        dm = torch.where(xf * a + b > 0, dact.float(), 0.0)
        return (dm * a).to(dt), (dm * xf).sum((0, 1, 2)), dm.sum((0, 1, 2))

    got = twice(torch, kern, f"fused_chain_bwd_dx {name}")
    want = plain()
    err = max(compare(got[0], want[0], dtype_name, f"fused_chain_bwd_dx dx {name}"),
              compare(got[1], want[1], "float32", f"fused_chain_bwd_dx da {name}",
                      rel=AFFINE_SUM_TOL),
              compare(got[2], want[2], "float32", f"fused_chain_bwd_dx db {name}",
                      rel=AFFINE_SUM_TOL))
    b_ms, b_by = bound((x.numel() + gy.numel() + wd.numel() + x.numel()) * elt,
                       flops, dtype_name)
    extra = dict(route="k5")
    if fc.gemm_route(x, wd, dt):
        plan = mm.fused_dx_plan(BATCH, hw, hw, cin, cout, mm._sms(0))
        parts = kernel_device_ms(kern, ("gemm_tn_bf16_kernel",
                                        "colsum_kernel"))
        extra = dict(route="gemm", plan=[list(p) if isinstance(p, tuple)
                                         else p for p in plan],
                     gemm_kernel_device_ms=parts["gemm_tn_bf16_kernel"],
                     colsum_device_ms=parts["colsum_kernel"])
    if extra["route"] != want_route:
        raise AssertionError(f"fused_chain_bwd_dx {name}: route "
                             f"{extra['route']}, expected {want_route}")
    # cuDNN's dgrad alone: the GEMM half's yardstick
    extra["cudnn_device_ms"] = device_ms(lambda: torch.nn.grad.conv2d_input(
        xt.shape, wd.permute(3, 2, 0, 1), gt, 1, 1))
    rows = [dict(kernel="fused_chain_bwd_dx", **common, max_abs_err=err,
                 **timed(kern, plain, library), bound_ms=b_ms, bound_by=b_by,
                 **extra)]

    kern = lambda: fc.fused_bwd_dw(x, a, b, gy, dt)
    plain = lambda: fc.fused_bwd_dw_plain(x, a, b, gy, dt)

    def library():
        act = torch.relu(x.float() * a + b).to(dt).permute(0, 3, 1, 2)
        return torch.nn.grad.conv2d_weight(act, (cout, cin, 3, 3), gt, 1, 1)

    got = kern()
    err = compare(got, plain(), "float32", f"fused_chain_bwd_dw {name}",
                  rel=SUM_TOL)
    if not torch.equal(got, kern()):
        raise AssertionError(f"fused_chain_bwd_dw {name}: two launches differ")
    b_ms, b_by = bound((x.numel() + gy.numel()) * elt + 4 * w.numel(), flops,
                       dtype_name)
    rows.append(dict(kernel="fused_chain_bwd_dw", **common, max_abs_err=err,
                     **timed(kern, plain, library), bound_ms=b_ms, bound_by=b_by))
    return rows


def flash_phases(torch, dev, name, n, t, h, hd, causal, dtype_name, per_step):
    """K7 forward, the one-launch backward (`flash_bwd`, on its route) and
    the dQ + dK/dV pair at one shape against the plain versions, with
    `scaled_dot_product_attention` (forward; its autograd backward alone,
    over one retained graph) as the library yardstick. `on_path`: the
    backward the model's autograd takes at this shape; the pair's rows
    carry per_step 0 where the one-launch kernel is on the path."""
    import torch.nn.functional as F
    from cpg_tpu_torch.ops import flash as fl

    dt = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(SEED + 6)
    q, k, v, do = (torch.randn((n, t, h, hd), generator=g).to(dev, dt)
                   for _ in range(4))
    elt = q.element_size()
    nqkv = q.numel() * elt                       # one (N, T, H, hd) tensor
    nrow = n * h * t * 4                         # one f32 (N, H, T) row stat
    work = n * h * t * t * hd * (0.5 if causal else 1.0)
    common = dict(layer=name, dtype=dtype_name, shape=[n, t, h, hd],
                  causal=causal)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    rows = []

    o, lse = fl.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fl.flash_mha_plain(q, k, v, causal)
    err = max(compare(o, o_ref, dtype_name, f"flash_fwd o {name}"),
              compare(lse, lse_ref, "float32", f"flash_fwd lse {name}"))
    o2, lse2 = fl.flash_fwd(q, k, v, causal)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"flash_fwd {name}: two launches differ")
    b_ms, b_by = bound(4 * nqkv + nrow, 4 * work, dtype_name)
    rows.append(dict(kernel="flash_fwd", **common, per_step=per_step,
                     max_abs_err=err,
                     **timed(lambda: fl.flash_fwd(q, k, v, causal),
                             lambda: fl.flash_mha_plain(q, k, v, causal), sdpa),
                     bound_ms=b_ms, bound_by=b_by))

    # library backward: SDPA's autograd backward (dq, dk, dv together),
    # alone: one saved forward, its graph retained, differentiated per call
    qg, kg, vg = (a.detach().clone().requires_grad_(True) for a in (qt, kt, vt))
    dot = do.transpose(1, 2)
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    sdpa_bwd = lambda: torch.autograd.grad(out, (qg, kg, vg), dot,
                                           retain_graph=True)
    lib_bwd, lib_bwd_dev = time_ms(sdpa_bwd), device_ms(sdpa_bwd)
    route = fl.bwd_route(q)
    pair_step = 0 if route else per_step

    if route:
        grads = twice(torch, lambda: fl.flash_bwd(q, k, v, o, lse, do, causal),
                      f"flash_bwd {name}")
        want = fl.flash_mha_bwd_plain(q, k, v, o, lse, do, causal)
        err = max(compare(g_, w_, dtype_name, f"flash_bwd d{x} {name}")
                  for g_, w_, x in zip(grads, want, "qkv"))
        b_ms, b_by = bound(8 * nqkv + nrow, 10 * work, dtype_name)
        kern = lambda: fl.flash_bwd(q, k, v, o, lse, do, causal)
        plan = fl.bwd_plan(n, t, h, hd, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        rows.append(dict(kernel="flash_bwd", **common, per_step=per_step,
                         on_path=True, max_abs_err=err, plan=list(plan),
                         ms=time_ms(kern), device_ms=device_ms(kern),
                         plain_ms=time_ms(lambda: fl.flash_mha_bwd_plain(
                             q, k, v, o, lse, do, causal)),
                         library_ms=lib_bwd, library_device_ms=lib_bwd_dev,
                         bound_ms=b_ms, bound_by=b_by))

    dq, d = fl.flash_bwd_dq(q, k, v, o, lse, do, causal)
    dq_ref, d_ref = fl.flash_mha_bwd_dq_plain(q, k, v, o, lse, do, causal)
    err = max(compare(dq, dq_ref, dtype_name, f"flash_bwd_dq dq {name}"),
              compare(d, d_ref, "float32", f"flash_bwd_dq D {name}",
                      rel=SUM_TOL))
    b_ms, b_by = bound(5 * nqkv + nrow + nqkv + nrow, 6 * work, dtype_name)
    kern = lambda: fl.flash_bwd_dq(q, k, v, o, lse, do, causal)
    rows.append(dict(kernel="flash_bwd_dq", **common, per_step=pair_step,
                     on_path=not route, max_abs_err=err,
                     ms=time_ms(kern), device_ms=device_ms(kern),
                     plain_ms=time_ms(lambda: fl.flash_mha_bwd_dq_plain(
                         q, k, v, o, lse, do, causal)),
                     library_ms=lib_bwd, library_device_ms=lib_bwd_dev,
                     bound_ms=b_ms, bound_by=b_by))

    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, d, causal)
    dk_ref, dv_ref = fl.flash_mha_bwd_dkv_plain(q, k, v, do, lse, d, causal)
    err = max(compare(dk, dk_ref, dtype_name, f"flash_bwd_dkv dk {name}"),
              compare(dv, dv_ref, dtype_name, f"flash_bwd_dkv dv {name}"))
    b_ms, b_by = bound(4 * nqkv + 2 * nrow + 2 * nqkv, 8 * work, dtype_name)
    kern = lambda: fl.flash_bwd_dkv(q, k, v, do, lse, d, causal)
    rows.append(dict(kernel="flash_bwd_dkv", **common, per_step=pair_step,
                     on_path=not route, max_abs_err=err,
                     ms=time_ms(kern), device_ms=device_ms(kern),
                     plain_ms=time_ms(lambda: fl.flash_mha_bwd_dkv_plain(
                         q, k, v, do, lse, d, causal)),
                     library_ms=lib_bwd, library_device_ms=lib_bwd_dev,
                     bound_ms=b_ms, bound_by=b_by))
    if route:  # the pair beside the kernel, in device time
        pair = [r["device_ms"] for r in rows[-2:]]
        rows[-3]["pair_device_ms"] = (None if None in pair else sum(pair))
    return rows


def dense_phases(torch, dev, name, m, kd, nd, dtype_name, mode, per_step):
    """The dense route (masked_matmul) at one shape, with `effective_kernel`
    + `torch.matmul` as the yardstick and `torch.matmul` on the
    pre-selected bf16 weight (`gemm_ms`, `gemm_device_ms`) as the GEMM
    half's. bf16 rows take the select pass + TN GEMM of
    csrc/masked_matmul.cu for y and dx (each of the two kernels also held
    alone against its plain version: `masked_matmul_select` rows and
    `gemm_kernel_*`), the f32 row the 1x1 masked-conv kernels; dw is K3 at
    1x1 on both."""
    from cpg_tpu_torch.ops import masked_matmul as mm
    from cpg_tpu_torch.ops.masked import effective_kernel

    dt = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(SEED + 7)
    x = torch.randn((m, kd), generator=g).to(dev, dt)
    w = (torch.randn((kd, nd), generator=g) * (1.0 / kd) ** 0.5).to(dev)
    own = torch.randint(0, 4, w.shape, generator=g, dtype=torch.int8).to(dev)
    pm = (torch.randn(w.shape, generator=g) * 1e-2).to(dev)
    gy = (torch.randn((m, nd), generator=g) * 0.1).to(dev, dt)
    elt, n_w = x.element_size(), w.numel()
    flops = 2.0 * m * kd * nd
    common = dict(layer=name, dtype=dtype_name, mode=mode, shape=[m, kd, nd],
                  per_step=per_step)
    weff = lambda: effective_kernel(w, own, pm, 2, mask_mode=mode).to(dt)
    gemm = mm.gemm_route(x, w, own, pm)
    rows = []

    if gemm:  # the select pass alone, in both layouts
        for transpose, kind in ((True, "fwd"), (False, "dx")):
            kern = lambda: mm.masked_matmul_select(w, own, pm, 2, mask_mode=mode,
                                                   transpose=transpose)
            plain = lambda: mm.masked_matmul_select_plain(
                w, own, pm, 2, mask_mode=mode, transpose=transpose)
            got, want = kern(), plain()
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"masked_matmul_select {name} {kind}: "
                                     "bits differ from the plain version")
            b_ms, b_by = bound(11 * n_w, 0.0, dtype_name)
            rows.append(dict(kernel="masked_matmul_select", **common,
                             layout=kind, max_abs_err=0.0, ms=time_ms(kern),
                             device_ms=device_ms(kern), plain_ms=time_ms(plain),
                             library_ms=None, library_device_ms=None,
                             bound_ms=b_ms, bound_by=b_by))
    w_dt = weff()

    def gemm_cols(a, bt):
        """The GEMM half: cuBLAS on the pre-selected weight; and, on the
        kernel route, the TN GEMM alone against its plain version."""
        lib = lambda: a @ bt.t()
        cols = dict(gemm_ms=time_ms(lib), gemm_device_ms=device_ms(lib))
        if gemm:
            kern = lambda: mm.launch_gemm_tn(a, bt)
            cols["gemm_kernel_err"] = compare(kern(), mm.gemm_tn_plain(a, bt),
                                              dtype_name, f"gemm_tn {name}")
            cols.update(gemm_kernel_ms=time_ms(kern),
                        gemm_kernel_device_ms=device_ms(kern))
        return cols

    kern = lambda: mm.masked_matmul(x, w, own, pm, 2, mask_mode=mode)
    plain = lambda: mm.masked_matmul_plain(x, w, own, pm, 2, mask_mode=mode)
    err = compare(twice(torch, kern, f"masked_matmul {name}"), plain(),
                  dtype_name, f"masked_matmul {name}")
    b_ms, b_by = bound(x.numel() * elt + 9 * n_w + m * nd * elt, flops,
                       dtype_name)
    rows.append(dict(kernel="masked_matmul_fwd", **common, max_abs_err=err,
                     **timed(kern, plain, lambda: x @ weff()), bound_ms=b_ms,
                     bound_by=b_by, **gemm_cols(x, w_dt.t().contiguous())))

    kern = lambda: mm.masked_matmul_bwd_dx(gy, x, w, own, pm, 2, mask_mode=mode)
    plain = lambda: mm.masked_matmul_bwd_dx_plain(gy, x, w, own, pm, 2,
                                                  mask_mode=mode)
    err = compare(twice(torch, kern, f"masked_matmul_bwd_dx {name}"),
                  plain(), dtype_name, f"masked_matmul_bwd_dx {name}")
    b_ms, b_by = bound(gy.numel() * elt + 9 * n_w + x.numel() * elt, flops,
                       dtype_name)
    rows.append(dict(kernel="masked_matmul_bwd_dx", **common, max_abs_err=err,
                     **timed(kern, plain, lambda: gy @ weff().t()),
                     bound_ms=b_ms, bound_by=b_by, **gemm_cols(gy, w_dt)))

    kern = lambda: mm.masked_matmul_bwd_dw(gy, x, w, own, 2)
    plain = lambda: mm.masked_matmul_bwd_dw_plain(gy, x, w, own, 2)

    def library():
        G = (x.t() @ gy).float()
        return (torch.where(own == 2, G, 0.0),
                torch.where((own > 0) & (own < 2), G * w, 0.0))

    got = twice(torch, kern, f"masked_matmul_bwd_dw {name}")
    want = plain()
    err = max(compare(got[0], want[0], "float32", f"masked_matmul_bwd_dw dw {name}",
                      rel=SUM_TOL),
              compare(got[1], want[1], "float32", f"masked_matmul_bwd_dw dpm {name}",
                      rel=SUM_TOL))
    b_ms, b_by = bound(x.numel() * elt + gy.numel() * elt + 5 * n_w + 8 * n_w,
                       flops, dtype_name)
    lib = lambda: x.t() @ gy
    extra, route = {}, "k3_1x1"
    if mm.wgrad_route(x, gy, w, own):
        route = "wgmma"
        extra = wgrad_cols(kern, mm.wgrad_plan(m, kd, nd, mm._sms(0)), kd, nd)
    rows.append(dict(kernel="masked_matmul_bwd_dw", **common, route=route,
                     max_abs_err=err, **timed(kern, plain, library),
                     bound_ms=b_ms, bound_by=b_by, gemm_ms=time_ms(lib),
                     gemm_device_ms=device_ms(lib), **extra))
    return rows


def build_state(torch, dev, arch="vgg16_bn_cifar"):
    from cpg_tpu_torch.core.pruner import one_shot_prune
    from cpg_tpu_torch.train.sequence import init_state, start_task

    g = torch.Generator().manual_seed(SEED)
    state = init_state(arch, g, width_mult=1.0, device=dev)
    start_task(state, "task1", 5, g)
    state.shared, state.ownership = one_shot_prune(state.shared,
                                                   state.ownership, 1, 0.5)
    start_task(state, "task2", 5, g)
    pm = state.tasks[2].piggymask
    for k in pm:  # some entries now fall below the 5e-3 threshold
        pm[k] = pm[k] + (torch.randn(pm[k].shape, generator=g) * 1e-2).to(dev)
    below = sum(int((v <= state.threshold).sum()) for v in pm.values())
    total = sum(v.numel() for v in pm.values())
    n_shared = sum(v.numel() for v in state.shared.values())
    print(f"state: {arch} width 1.0, {n_shared} sharable weights, task-2 "
          f"piggymask {below / total:.3f} below threshold", flush=True)
    return state


def serve_phase(torch, dev, state):
    from cpg_tpu_torch.data.augment import cifar_eval_preprocess as prep
    from cpg_tpu_torch.serve import TaskServer

    rng = np.random.RandomState(SEED)
    ref = TaskServer(state, prep, compute_dtype=torch.bfloat16, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        TaskServer(state, prep, compute_dtype=torch.bfloat16,
                   fused_chain=True, device=dev).export(tmp)
        srv = TaskServer.load(tmp, prep, fused_chain=True, device=dev)
    srv.warmup()
    errs = []
    for n in (1, 8, 37, 256, 1024):
        x = rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
        got = torch.from_numpy(srv.predict(2, x))
        want = torch.from_numpy(ref.predict(2, x))
        if got.shape != (n, 5):
            raise AssertionError(f"serve: shape {tuple(got.shape)} for {n} rows")
        errs.append(compare(got, want, "bfloat16", f"serve {n} rows"))
    reqs = [(1 + i % 2, rng.randint(0, 256, (32, 32, 3)).astype(np.uint8))
            for i in range(24)]
    for i, (got, want) in enumerate(zip(srv.predict_mixed(reqs),
                                        ref.predict_mixed(reqs))):
        errs.append(compare(torch.from_numpy(got), torch.from_numpy(want),
                            "bfloat16", f"predict_mixed request {i}"))
    x = rng.randint(0, 256, (256, 32, 32, 3)).astype(np.uint8)
    lat = {}
    for label, s in (("fused", srv), ("unfused", ref)):
        s.predict(2, x)
        ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            s.predict(2, x)
            ts.append(time.perf_counter() - t0)
        p50 = float(np.median(ts))
        lat[label] = {"p50_ms": p50 * 1e3, "img_per_s": 256 / p50}
    return max(errs), lat


def vit_serve_phase(torch, dev, state):
    """bf16 ViT server through export -> load against the f32 server (both
    the effective-params einsum path; serving runs no port kernel, as
    `cpg_tpu`'s server has no flash route)."""
    from cpg_tpu_torch.data.augment import cifar_eval_preprocess as prep
    from cpg_tpu_torch.serve import TaskServer

    rng = np.random.RandomState(SEED + 8)
    ref = TaskServer(state, prep, compute_dtype=torch.float32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        TaskServer(state, prep, compute_dtype=torch.bfloat16,
                   device=dev).export(tmp)
        srv = TaskServer.load(tmp, prep, device=dev)
    srv.warmup()
    errs = []
    for n in (1, 37, 256):
        x = rng.randint(0, 256, (n, 32, 32, 3)).astype(np.uint8)
        got = torch.from_numpy(srv.predict(2, x))
        want = torch.from_numpy(ref.predict(2, x))
        if got.shape != (n, 5):
            raise AssertionError(f"vit serve: shape {tuple(got.shape)} for {n} rows")
        errs.append(compare(got, want, "bfloat16", f"vit serve {n} rows"))
    reqs = [(1 + i % 2, rng.randint(0, 256, (32, 32, 3)).astype(np.uint8))
            for i in range(12)]
    for i, (got, want) in enumerate(zip(srv.predict_mixed(reqs),
                                        ref.predict_mixed(reqs))):
        errs.append(compare(torch.from_numpy(got), torch.from_numpy(want),
                            "bfloat16", f"vit predict_mixed request {i}"))
    x = rng.randint(0, 256, (256, 32, 32, 3)).astype(np.uint8)
    srv.predict(2, x)
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        srv.predict(2, x)
        ts.append(time.perf_counter() - t0)
    p50 = float(np.median(ts))
    return max(errs), {"bf16": {"p50_ms": p50 * 1e3, "img_per_s": 256 / p50}}


# the kernel flags of each architecture's eval and train phases
KERNEL_FLAGS = {"vgg16_bn_cifar": dict(use_pallas_conv=True,
                                       use_fused_chain=True),
                "vit_cifar": dict(use_pallas=True, flash_attention=True)}


def eval_phase(torch, dev, state, counts):
    from cpg_tpu_torch.data.augment import cifar_eval_preprocess as prep
    from cpg_tpu_torch.models import get_model
    from cpg_tpu_torch.train.step import TrainConfig, make_eval_step

    model_fn, _ = get_model(state.arch)
    kw = dict(num_classes=5, mult=1.0, has_piggymask=True,
              preprocess_fn=prep, device=dev)
    rng = np.random.RandomState(SEED + 2)
    x = rng.randint(0, 256, (BATCH, 32, 32, 3)).astype(np.uint8)
    y = rng.randint(0, 5, (BATCH,))
    t = state.tasks[2]
    args = (state.shared, t.piggymask, t.private, t.bn_state, state.ownership,
            2, x, y)
    ref = make_eval_step(model_fn, cfg=TrainConfig(), **kw)(*args)[0]
    torch.cuda.synchronize()
    counts.reset()
    got = make_eval_step(model_fn, cfg=TrainConfig(
        **KERNEL_FLAGS[state.arch]), **kw)(*args)[0]
    torch.cuda.synchronize()
    launched = counts.read()
    return compare(got, ref, "bfloat16", f"{state.arch} masked eval step"), launched


# launches of each kernel in one train step of task 2 with the kernel flags:
# VGG16-BN's five masked convs (conv0's input is the image, so no dx; a
# select pass before the forward and dx of conv2, 4, 7 and 10, the GEMM
# route) and eight fused seams; vit_cifar's six blocks of six sdense layers and one
# attention (its patch stem is a plain product), a select pass before each
# forward and dx GEMM; zero for every other kernel
TRAIN_LAUNCHES = {
    "vgg16_bn_cifar": {"masked_conv_fwd": 5, "masked_conv_bwd_dx": 4,
                       "masked_conv_bwd_dw": 5, "masked_conv_select": 8,
                       "masked_conv_im2col": 1,
                       "fused_chain_fwd": 8,
                       "fused_chain_bwd_dx": 8, "fused_chain_bwd_dw": 8},
    "vit_cifar": {"flash_fwd": 6, "flash_bwd": 6,
                  "masked_matmul_fwd": 36, "masked_matmul_bwd_dx": 36,
                  "masked_matmul_bwd_dw": 36, "masked_matmul_select": 72},
}
TRAIN_STEPS = 3
TRAIN_TIMING_BATCHES = (BATCH, 1024)  # bench.py's batch is 1024
# Tolerances of the kernel step (bf16) against the default step (bf16). The
# two round at different points: the default step's cuDNN convolutions
# round every output, dgrad and wgrad to bf16; the kernel step keeps dact,
# dW and dpm in f32 until the end. At a random init the gradients are
# dominated by cancelling terms, so bf16 moves the update a long way (the
# default bf16 step's BatchNorm-parameter updates differ by 60-77% from the
# same step in f32 on the CPU at width 0.125). The yardstick is therefore
# the default step in f32 (TF32 off): per group of tensors (shared,
# private, piggymask), the kernel step's update may be at most
# UPDATE_RATIO times as far from the f32 update as the default bf16
# step's is; the losses agree within LOSS_RTOL.
LOSS_RTOL = 2e-2
UPDATE_RATIO = 2.0


def _train_tensors(st, fn):
    """Task 2's trained tensors of a state, keyed 'group/name'."""
    t2 = st.tasks[2]
    out = {f"shared/{k}": fn(v) for k, v in st.shared.items()}
    out.update({f"piggymask/{k}": fn(v) for k, v in t2.piggymask.items()})
    out.update({f"private/{k}": fn(v) for k, v in t2.private.items()})
    return out


def train_phase(torch, dev, state, counts):
    """Task 2's bf16 train step with the six kernels against the default
    step. Returns the comparison, the per-step launches and the timings."""
    from cpg_tpu_torch.data.augment import cifar_train_augment, crop_flip_draws
    from cpg_tpu_torch.models import get_model
    from cpg_tpu_torch.train.step import TrainConfig, make_train_step

    model_fn, _ = get_model(state.arch)
    gen = torch.Generator().manual_seed(SEED + 3)
    base = state.map_arrays(lambda t: t.clone())
    # release 2% of task 2's entries so the free-entry invariant has entries
    for k, own in base.ownership.items():
        sel = (own == 2) & (torch.rand(own.shape, generator=gen) < 0.02).to(dev)
        base.ownership[k] = own.masked_fill(sel, 0)
        base.shared[k] = base.shared[k].masked_fill(sel, 0.0)
    n_free = sum(int((o == 0).sum()) for o in base.ownership.values())

    def batch(n):
        x = torch.randint(0, 256, (n, 32, 32, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
        y = torch.randint(0, 5, (n,), generator=gen).to(dev)
        return x, y, crop_flip_draws(n, gen, 4)

    batches = [batch(TRAIN_TIMING_BATCHES[0]) for _ in range(TRAIN_STEPS)]

    def stepper(kernels, dtype=torch.bfloat16):
        st = base.map_arrays(lambda t: t.clone())
        task = st.tasks[2]
        cfg = TrainConfig(compute_dtype=dtype,
                          **(KERNEL_FLAGS[state.arch] if kernels else {}))
        step, (opt_w, opt_pm) = make_train_step(
            model_fn, num_classes=5, mult=base.width_mult, has_piggymask=True,
            cfg=cfg, augment_fn=cifar_train_augment, device=dev)
        carry = [st.shared, task.piggymask, task.private, task.bn_state,
                 opt_w.init({"shared": st.shared, "private": task.private}),
                 opt_pm.init(task.piggymask)]

        def run(x, y, draws, it):
            out = step(*carry[:6], st.ownership, 2, x, y, draws, it)
            carry[:6] = out[:6]
            return out[6]
        return st, run

    runs = {}
    launched = None
    for label, kernels, dtype in (("f32", False, torch.float32),
                                  ("default", False, torch.bfloat16),
                                  ("kernels", True, torch.bfloat16)):
        st, run = stepper(kernels, dtype)
        losses, first = [], None
        for i, (x, y, draws) in enumerate(batches):
            if kernels and i == 0:
                torch.cuda.synchronize()
                counts.reset()
            m = run(x, y, draws, i)
            losses.append(float(m["loss"]))
            if kernels and i == 0:
                torch.cuda.synchronize()
                launched = counts.read()
            if i == 0:
                first = _train_tensors(st, lambda t: t.clone())
        runs[label] = (st, losses, first)

    init = _train_tensors(base, lambda t: t)
    dist = {}  # label -> group -> ||update - f32 update||
    ref_norm = {}
    for group in ("shared", "private", "piggymask"):
        keys = [k for k in init if k.startswith(group + "/")]
        u32 = torch.cat([(runs["f32"][2][k] - init[k]).ravel() for k in keys])
        ref_norm[group] = u32.norm().item()
        for label in ("default", "kernels"):
            u = torch.cat([(runs[label][2][k] - init[k]).ravel() for k in keys])
            if not torch.isfinite(u).all():
                raise AssertionError(f"train {label}: non-finite {group} update")
            dist.setdefault(label, {})[group] = (u - u32).norm().item()
    ld, lk, l32 = (runs[k][1] for k in ("default", "kernels", "f32"))
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(ld, lk))
    stats = dict(losses_f32=l32, losses_default=ld, losses_kernels=lk,
                 loss_max_rel=loss_rel, update_dist_to_f32=dist,
                 f32_update_norm=ref_norm, free_entries=n_free)
    if not all(np.isfinite(ld + lk + l32)):
        raise AssertionError(f"train: non-finite losses {ld} {lk} {l32}")
    if loss_rel > LOSS_RTOL:
        raise AssertionError(f"train: losses {lk} vs default {ld}")
    for group, d in dist["kernels"].items():
        if d > UPDATE_RATIO * dist["default"][group] + 1e-6 * ref_norm[group]:
            raise AssertionError(
                f"train: the kernel step's {group} update is {d} from the f32 "
                f"step's, the default step's {dist['default'][group]}")
    # no forgetting: prior-task entries bit-unchanged, free entries zero,
    # piggymask entries outside the prior domain unchanged
    t0 = base.tasks[2]
    for label, (st, _, _) in runs.items():
        for k, own in base.ownership.items():
            w, w0 = st.shared[k], base.shared[k]
            if not torch.equal(w[own == 1], w0[own == 1]):
                raise AssertionError(f"train {label}: task-1 entries of {k} moved")
            if (w[own == 0] != 0).any():
                raise AssertionError(f"train {label}: free entries of {k} nonzero")
            pm, pm0 = st.tasks[2].piggymask[k], t0.piggymask[k]
            if not torch.equal(pm[own != 1], pm0[own != 1]):
                raise AssertionError(f"train {label}: piggymask of {k} moved "
                                     "outside the prior-task entries")
    expected = TRAIN_LAUNCHES[state.arch]
    for k, n in launched.items():
        if n != expected.get(k, 0):
            raise AssertionError(f"train {state.arch}: {k} launched {n} times "
                                 f"in one step, expected {expected.get(k, 0)}")

    # ms/step by host clock around steps that end in a synchronize; the two
    # steps in turns (default, kernels, kernels, default), 10 steps a round
    timing = {}
    for n in TRAIN_TIMING_BATCHES:
        x, y, draws = batch(n)
        steppers = {"default": stepper(False)[1], "kernels": stepper(True)[1]}
        rounds = {"default": [], "kernels": []}
        for label in ("default", "kernels", "kernels", "default"):
            run = steppers[label]
            for i in range(2):
                run(x, y, draws, i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(10):
                run(x, y, draws, i)
            torch.cuda.synchronize()
            rounds[label].append((time.perf_counter() - t) / 10 * 1e3)
        for label, ms in rounds.items():
            mean = sum(ms) / len(ms)
            timing[f"{label}_b{n}"] = {"ms_per_step": mean,
                                       "img_per_s": n / mean * 1e3,
                                       "rounds_ms": ms}
    return dict(stats, timing=timing), launched


# The cycle phase: run_sequence over three synthetic CIFAR-100 tasks of 5
# classes (128 training images a class, batch 128: 5 steps an epoch) on the
# bf16 kernel step, VGG16-BN at width 1.0; task 3's goal 1.01 cannot be met,
# so it grows once, 1.0 -> 1.5 (on_goal_miss "accept"), with the growth audit
# on. The `.pick` checkpoints are kept (as a crash before the final save
# would keep them) so that every task boundary can be audited.
CYCLE = dict(finetune_epochs=2, prune_epochs=1, retrain_epochs=1,
             prune_ratios=(0.5, 0.75), prune_freq=2, batch_size=128,
             growth_step=0.5, max_width_mult=1.5, on_goal_miss="accept",
             seed=SEED)
CYCLE_TRAIN_PER_CLASS, CYCLE_TEST_PER_CLASS = 128, 20
PRUNE_TIMING_EVENTS = 5


def _same_state(torch, a, b) -> bool:
    """Every tensor of two states equal, bit for bit."""
    if (a.width_mult, list(a.tasks)) != (b.width_mult, list(b.tasks)):
        return False
    trees = [(a.shared, b.shared), (a.ownership, b.ownership)]
    for tid, t in a.tasks.items():
        u = b.tasks[tid]
        trees += [(t.private, u.private), (t.bn_state, u.bn_state),
                  (t.piggymask or {}, u.piggymask or {})]
    return all(sorted(x) == sorted(y)
               and all(torch.equal(x[k], y[k]) for k in x) for x, y in trees)


def _timed(torch, spent, owner, attr, label):
    """Wrap `owner.attr` so that each call adds its device-synchronised
    seconds to spent[label]; returns the undo."""
    orig = getattr(owner, attr)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            torch.cuda.synchronize()
            spent[label] = spent.get(label, 0.0) + time.perf_counter() - t

    setattr(owner, attr, wrapper)
    return lambda: setattr(owner, attr, orig)


def cycle_phase(torch, dev, counts):
    """The compact-pick-grow cycle through `run_sequence` on the card, then
    its audits: check_state at every task boundary, old-task logits across
    add-task and prune (max|diff| must be 0), the growth audit against its
    bound, a second run_sequence over the checkpoints (must resume every
    task and give the same state bit for bit), ms per prune event at width
    1.0 and seconds for grow_state. The first run_sequence's wall time is
    split by synchronised timers around the cycle's parts outside the
    train loops (evals, snapshots and restores, checkpoint saves, Manager
    set-up, start_task, growth with its audit). The prune events inside
    the loops get no timer, so the loops keep the host running ahead of
    the card; their cost is the separate ms-per-event measurement. Returns the results and the launches of the first
    run_sequence."""
    from cpg_tpu_torch.core import pruner
    from cpg_tpu_torch.core.invariants import check_state
    from cpg_tpu_torch.data.augment import (cifar_eval_preprocess,
                                            cifar_train_augment)
    from cpg_tpu_torch.data.cifar import synthetic_cifar100, task_splits
    from cpg_tpu_torch.inference import predict
    from cpg_tpu_torch.train import sequence as seq_mod
    from cpg_tpu_torch.train.manager import Manager
    from cpg_tpu_torch.train.step import TrainConfig
    from cpg_tpu_torch.utils.checkpoint import load_state

    data = synthetic_cifar100(n_train_per_class=CYCLE_TRAIN_PER_CLASS,
                              n_test_per_class=CYCLE_TEST_PER_CLASS, seed=SEED)
    tasks = dict(list(task_splits(data).items())[:3])
    names = list(tasks)
    cfg = TrainConfig(**KERNEL_FLAGS["vgg16_bn_cifar"])
    tmp = tempfile.mkdtemp(prefix="cycle_")
    try:
        seq = seq_mod.SequenceConfig(**CYCLE,
                                     checkpoint_dir=os.path.join(tmp, "ck"),
                                     jsonl_path=os.path.join(tmp, "ph.jsonl"))

        def run():
            return seq_mod.run_sequence(
                "vgg16_bn_cifar", tasks, cfg, seq, goals={names[2]: 1.01},
                augment_fn=cifar_train_augment,
                preprocess_fn=cifar_eval_preprocess, width_mult=1.0,
                device=dev)

        keep = seq_mod.remove_after_save
        seq_mod.remove_after_save = lambda path: None
        spent = {}
        undo = [_timed(torch, spent, owner, attr, label)
                for owner, attr, label in (
                    (Manager, "eval", "eval"),
                    (Manager, "__init__", "manager_setup"),
                    (seq_mod, "snapshot", "snapshot"),
                    (seq_mod, "_restore", "restore"),
                    (seq_mod, "save_state", "checkpoint_save"),
                    (seq_mod, "start_task", "start_task"),
                    (seq_mod, "_growth_audit", "growth_and_audit"))]
        try:
            torch.cuda.synchronize()
            counts.reset()
            t0 = time.perf_counter()
            state, reports = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = counts.read()
        finally:
            seq_mod.remove_after_save = keep
            for u in undo:
                u()
        with open(seq.jsonl_path) as f:
            phases = [json.loads(line) for line in f]
        for ph in phases:
            ph["ms_per_step"] = ph["seconds"] / max(ph["steps"], 1) * 1e3
        loops = sum(ph["seconds"] for ph in phases)
        outside = sum(spent.values())
        split = dict(wall_s=wall, train_loops_s=loops, **spent,
                     other_s=wall - loops - outside)

        def ck(tid, suffix=""):
            return load_state(os.path.join(
                seq.checkpoint_dir, f"task{tid:02d}_{names[tid - 1]}{suffix}"),
                device=dev)

        boundaries = [("task1", ck(1)), ("task2.pick", ck(2, ".pick")),
                      ("task2", ck(2)), ("task3.pick", ck(3, ".pick")),
                      ("task3", ck(3)), ("final", state)]
        audits = {}
        for label, st in boundaries:
            audits[label] = check_state(st)  # raises on a violation
            for k, own in st.ownership.items():
                if st.shared[k][own == 0].any():
                    raise AssertionError(f"cycle {label}: free entries of "
                                         f"{k} nonzero")

        px = cifar_eval_preprocess(torch.from_numpy(
            tasks[names[0]]["test_x"][:64]).to(dev))
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            def logits(st, tid):
                return predict(st, tid, px, device=dev)

            old = {}
            by = dict(boundaries)
            # task 1 across task 2's add-task and pick, then its prune; tasks
            # 1 and 2 across task 3's prune at the grown width
            for tid, labels in ((1, ("task1", "task2.pick", "task2")),
                                (1, ("task3.pick", "task3", "final")),
                                (2, ("task3.pick", "task3", "final"))):
                ref = logits(by[labels[0]], tid)
                d = max(float((logits(by[lb], tid) - ref).abs().max())
                        for lb in labels[1:])
                old[f"task{tid} {' -> '.join(labels)}"] = d
                if d != 0.0:
                    raise AssertionError(f"cycle: task {tid} logits moved by "
                                         f"{d} across {labels}")
        finally:
            torch.backends.cudnn.deterministic = det
        audit = reports[2].growth_audit
        if not audit or any(a["max_abs_diff"] > a["bound"] for a in audit):
            raise AssertionError(f"cycle: growth audit {audit}")
        if [r.grew for r in reports] != [0, 0, 1] or state.width_mult != 1.5:
            raise AssertionError(f"cycle: grew {[r.grew for r in reports]}, "
                                 f"width {state.width_mult}")

        # resume: every task from its final checkpoint, the same state
        trained = []
        orig_train = Manager.train
        Manager.train = lambda *a, **k: trained.append(1)
        try:
            again, _ = run()
        finally:
            Manager.train = orig_train
        if trained or not _same_state(torch, again, state):
            raise AssertionError("cycle: resume did not reproduce the state")

        # one prune event at width 1.0: task 2's 13 layers to 0.5 of their
        # post-pick counts, device-synchronised, each on a fresh copy
        base = ck(2, ".pick")
        n0 = {k: int(v) for k, v in pruner.snapshot_owned_counts(
            base.ownership, 2).items()}
        prune_ms = []
        for i in range(PRUNE_TIMING_EVENTS + 1):
            sh = {k: v.clone() for k, v in base.shared.items()}
            own = {k: v.clone() for k, v in base.ownership.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            pruner.gradual_prune_(sh, own, 2, 0.5, n0)
            torch.cuda.synchronize()
            if i:  # the first is a warm-up
                prune_ms.append((time.perf_counter() - t) * 1e3)
        grow_base = ck(2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        seq_mod.grow_state(grow_base, 1.5, torch.Generator().manual_seed(SEED),
                           device=dev, cfg=cfg)
        torch.cuda.synchronize()
        grow_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(
        wall_s=wall, wall_split_s=split, phases=phases, check_state=audits,
        old_task_max_abs_diff=old, growth_audit=audit,
        reports=[{"task": r.name, "pick_acc": r.pick_acc,
                  "final_acc": r.final_acc, "chosen_ratio": r.chosen_ratio,
                  "ratio_to_acc": r.ratio_to_acc, "width_mult": r.width_mult,
                  "grew": r.grew} for r in reports],
        resume_equal=True,
        prune_event_ms=dict(median=float(np.median(prune_ms)),
                            all=prune_ms, layers=len(n0)),
        grow_state_s=grow_s), launched


def _per_step(row) -> int:
    """Launches of a phase row's shape in one train step at batch 256: the
    ViT rows say so; a VGG16-BN row's layer runs once a step in bf16 binary
    (its ternary and f32 rows are extra checks)."""
    if "per_step" in row:
        return row["per_step"]
    return int(row["dtype"] == "bfloat16"
               and row.get("mode", "binary") == "binary")


def _step_sum(step, key):
    """Sum of a per-shape time over one train step's launches; None when a
    shape's time was not measured."""
    vals = [(r[key], k) for r, k in step]
    if any(v is None for v, _ in vals):
        return None
    return sum(k * v for v, k in vals)


class Counts:
    """The kernel wrappers' launch counters."""

    def __init__(self):
        from cpg_tpu_torch.ops import (flash, fused_chain, masked_conv,
                                       masked_matmul)

        self.where = {
            "masked_conv_fwd": (masked_conv, "LAUNCHES"),
            "masked_conv_bwd_dx": (masked_conv, "LAUNCHES_BWD_DX"),
            "masked_conv_bwd_dw": (masked_conv, "LAUNCHES_BWD_DW"),
            "masked_conv_select": (masked_conv, "LAUNCHES_SELECT"),
            "masked_conv_im2col": (masked_conv, "LAUNCHES_IM2COL"),
            "fused_chain_fwd": (fused_chain, "LAUNCHES"),
            "fused_chain_bwd_dx": (fused_chain, "LAUNCHES_BWD_DX"),
            "fused_chain_bwd_dw": (fused_chain, "LAUNCHES_BWD_DW"),
            "flash_fwd": (flash, "LAUNCHES"),
            "flash_bwd_dq": (flash, "LAUNCHES_BWD_DQ"),
            "flash_bwd_dkv": (flash, "LAUNCHES_BWD_DKV"),
            "flash_bwd": (flash, "LAUNCHES_BWD"),
            "masked_matmul_fwd": (masked_matmul, "LAUNCHES"),
            "masked_matmul_bwd_dx": (masked_matmul, "LAUNCHES_BWD_DX"),
            "masked_matmul_bwd_dw": (masked_matmul, "LAUNCHES_BWD_DW"),
            "masked_matmul_select": (masked_matmul, "LAUNCHES_SELECT"),
        }

    def reset(self):
        for mod, attr in self.where.values():
            setattr(mod, attr, 0)

    def read(self):
        return {k: getattr(mod, attr) for k, (mod, attr) in self.where.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs the card",
              file=sys.stderr)
        return 1
    from cpg_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"build: {_build.build_all():.1f} s (nvcc, parallel)", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    t_start = time.perf_counter()
    rows = []
    for name, hw, cin, cout in MASKED_CONV_SHAPES:
        rows += masked_conv_phase(torch, dev, name, hw, cin, cout,
                                  "bfloat16", "binary")
        rows += masked_conv_bwd_phases(torch, dev, name, hw, cin, cout,
                                       "bfloat16", "binary",
                                       with_dx=name != "conv0")
    for name, hw, cin, cout in MASKED_CONV_SHAPES[1:]:
        rows += masked_conv_phase(torch, dev, name, hw, cin, cout,
                                  "bfloat16", "ternary")
        rows += masked_conv_bwd_phases(torch, dev, name, hw, cin, cout,
                                       "bfloat16", "ternary")
    # conv2 at width 0.125 holds the old bf16 K1 and K2 (off the route)
    rows += masked_conv_phase(torch, dev, "conv2_w0.125", 16, 8, 16,
                              "bfloat16", "binary", per_step=0)
    rows += masked_conv_bwd_phases(torch, dev, "conv2_w0.125", 16, 8, 16,
                                   "bfloat16", "binary", per_step=0)
    rows += masked_conv_phase(torch, dev, "conv7", 4, 256, 512, "float32",
                              "binary")
    rows += masked_conv_bwd_phases(torch, dev, "conv7", 4, 256, 512,
                                   "float32", "binary")
    for name, hw, cin, cout in CHAIN_SHAPES:
        rows.append(fused_chain_phase(torch, dev, name, hw, cin, cout,
                                      "bfloat16", "gemm"))
        rows += fused_chain_bwd_phases(torch, dev, name, hw, cin, cout,
                                       "bfloat16", "gemm")
    # conv3 at width 0.125 holds the earlier bf16 K4 and K5 (off the route:
    # 16 channels), which width-0.125 seams conv1-6 run
    rows.append(fused_chain_phase(torch, dev, "conv3_w0.125", 16, 16, 16,
                                  "bfloat16", "k4", per_step=0))
    rows += fused_chain_bwd_phases(torch, dev, "conv3_w0.125", 16, 16, 16,
                                   "bfloat16", "k5", per_step=0)
    rows.append(fused_chain_phase(torch, dev, "conv3", 16, 128, 128,
                                  "float32", "k4"))
    rows += fused_chain_bwd_phases(torch, dev, "conv3", 16, 128, 128,
                                   "float32", "k5")
    for name, n, t, h, hd, causal, dname, per_step in FLASH_SHAPES:
        rows += flash_phases(torch, dev, name, n, t, h, hd, causal, dname,
                             per_step)
    for name, m, kd, nd, dname, mode, per_step in DENSE_SHAPES:
        rows += dense_phases(torch, dev, name, m, kd, nd, dname, mode,
                             per_step)
    for r in rows:
        print("phase " + json.dumps(r), flush=True)
    t_kernels = time.perf_counter() - t_start

    counts = Counts()
    launched = {}  # phase -> kernel -> launches
    results = {}
    for arch in ("vgg16_bn_cifar", "vit_cifar"):
        state = build_state(torch, dev, arch)
        torch.cuda.synchronize()
        counts.reset()
        if arch == "vit_cifar":
            serve_err, lat = vit_serve_phase(torch, dev, state)
            what = "the f32 server"
        else:
            serve_err, lat = serve_phase(torch, dev, state)
            what = "the unfused server"
        torch.cuda.synchronize()
        launched[f"{arch}/serve"] = counts.read()
        print(f"serve {arch}: max|diff| vs {what} {serve_err}; bucket 256 "
              f"{json.dumps(lat)} on {card}", flush=True)
        eval_err, launched[f"{arch}/eval"] = eval_phase(torch, dev, state,
                                                        counts)
        print(f"eval {arch}: max|diff| vs effective-params step {eval_err}",
              flush=True)
        train, launched[f"{arch}/train"] = train_phase(torch, dev, state,
                                                       counts)
        print(f"train {arch}: {json.dumps(train)} on {card}", flush=True)
        results[arch] = dict(serve_max_abs_err=serve_err, serve_latency=lat,
                             eval_max_abs_err=eval_err, train=train)
        del state
        torch.cuda.empty_cache()
    cycle, launched["vgg16_bn_cifar/cycle"] = cycle_phase(torch, dev, counts)
    results["vgg16_bn_cifar"]["cycle"] = cycle
    print(f"cycle vgg16_bn_cifar: {json.dumps(cycle)} on {card}", flush=True)
    torch.cuda.empty_cache()
    # every phase that should reach a kernel did
    need = {"vgg16_bn_cifar/serve": ["fused_chain_fwd"],
            "vgg16_bn_cifar/eval": ["masked_conv_fwd", "masked_conv_select",
                                    "fused_chain_fwd"],
            "vgg16_bn_cifar/train": ["masked_conv_bwd_dx",
                                     "masked_conv_bwd_dw",
                                     "masked_conv_im2col",
                                     "fused_chain_bwd_dx",
                                     "fused_chain_bwd_dw"],
            "vit_cifar/eval": ["flash_fwd", "masked_matmul_fwd",
                               "masked_matmul_select"],
            "vit_cifar/train": ["flash_bwd", "masked_matmul_bwd_dx",
                                "masked_matmul_bwd_dw"],
            "vgg16_bn_cifar/cycle": ["masked_conv_fwd", "masked_conv_bwd_dx",
                                     "masked_conv_bwd_dw", "fused_chain_fwd",
                                     "fused_chain_bwd_dx",
                                     "fused_chain_bwd_dw"]}
    for phase, names in need.items():
        for k in names:
            if launched[phase][k] == 0:
                raise AssertionError(f"{phase} phase launched no {k} kernel")
    print(f"launches: {json.dumps(launched)}", flush=True)

    # conv K1 and K2: the GEMM route's file (conv2/4/7/10), then the old
    # kernel's (conv0, narrow widths, f32) under "sources"; K3 likewise:
    # the wgrad GEMM's file (conv0 by im2col, conv2/4/7/10, dense bf16),
    # then the old kernel's (narrow widths, f32); K5: its file, then the
    # GEMM's header that holds its route's kernel
    meta = {
        "masked_conv_fwd": (("cpg_tpu_torch/csrc/masked_matmul.cu",
                             "cpg_tpu_torch/csrc/masked_conv_fwd.cu"),
                            "cpg_tpu/ops/pallas/masked_matmul.py:97"),
        "masked_conv_bwd_dx": (("cpg_tpu_torch/csrc/masked_matmul.cu",
                                "cpg_tpu_torch/csrc/masked_conv_bwd_dx.cu"),
                               "cpg_tpu/ops/pallas/masked_matmul.py:173"),
        "masked_conv_select": ("cpg_tpu_torch/csrc/masked_matmul.cu",
                               "cpg_tpu/ops/pallas/masked_matmul.py:56"),
        "masked_conv_bwd_dw": (("cpg_tpu_torch/csrc/masked_matmul_wgrad.cu",
                                "cpg_tpu_torch/csrc/masked_conv_bwd_dw.cu"),
                               "cpg_tpu/ops/pallas/masked_matmul.py:244"),
        "masked_conv_im2col": ("cpg_tpu_torch/csrc/masked_matmul_wgrad.cu",
                               "cpg_tpu/ops/pallas/masked_matmul.py:244"),
        "fused_chain_fwd": ("cpg_tpu_torch/csrc/fused_chain_fwd.cu",
                            "cpg_tpu/ops/pallas/fused_chain.py:134"),
        "fused_chain_bwd_dx": (("cpg_tpu_torch/csrc/fused_chain_bwd_dx.cu",
                                "cpg_tpu_torch/csrc/tma_gemm.cuh"),
                               "cpg_tpu/ops/pallas/fused_chain.py:233"),
        "fused_chain_bwd_dw": ("cpg_tpu_torch/csrc/fused_chain_bwd_dw.cu",
                               "cpg_tpu/ops/pallas/fused_chain.py:276"),
        "flash_fwd": ("cpg_tpu_torch/csrc/flash_fwd.cu",
                      "cpg_tpu/ops/flash.py:97"),
        "flash_bwd_dq": ("cpg_tpu_torch/csrc/flash_bwd.cu",
                         "cpg_tpu/ops/flash.py:97"),
        "flash_bwd_dkv": ("cpg_tpu_torch/csrc/flash_bwd.cu",
                          "cpg_tpu/ops/flash.py:97"),
        "flash_bwd": ("cpg_tpu_torch/csrc/flash_bwd_wgmma.cu",
                      "cpg_tpu/ops/flash.py:97"),
        "masked_matmul_fwd": ("cpg_tpu_torch/csrc/masked_matmul.cu",
                              "cpg_tpu/ops/pallas/masked_matmul.py:97"),
        "masked_matmul_bwd_dx": ("cpg_tpu_torch/csrc/masked_matmul.cu",
                                 "cpg_tpu/ops/pallas/masked_matmul.py:173"),
        "masked_matmul_select": ("cpg_tpu_torch/csrc/masked_matmul.cu",
                                 "cpg_tpu/ops/pallas/masked_matmul.py:56"),
        "masked_matmul_bwd_dw": (("cpg_tpu_torch/csrc/masked_matmul_wgrad.cu",
                                  "cpg_tpu_torch/csrc/masked_conv_bwd_dw.cu"),
                                 "cpg_tpu/ops/pallas/masked_matmul.py:244"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        # the shapes of one train step at batch 256 (VGG16-BN for the conv
        # kernels, vit_cifar for the rest), each times its launches there;
        # a kernel that step does not launch (K7's dQ + dK/dV pair) sums
        # its shapes where the path takes it, once each
        step = [(r, _per_step(r)) for r in mine if _per_step(r)]
        if not step:
            step = [(r, 1) for r in mine if r.get("on_path")]
        by = {}
        for r, k in step:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + k * r["bound_ms"]
        sources = (source,) if isinstance(source, str) else source
        kernels.append({
            "name": name, "route": "cuda", "source": sources[0],
            **({"sources": list(sources)} if len(sources) > 1 else {}),
            "replaces": replaces,
            "launches": sum(c[name] for c in launched.values()),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(k * r["ms"] for r, k in step),
            "device_ms": _step_sum(step, "device_ms"),
            "plain_ms": sum(k * r["plain_ms"] for r, k in step),
            "bound_ms": sum(k * r["bound_ms"] for r, k in step),
            "bound_by": max(by, key=by.get),
            "library_ms": _step_sum(step, "library_ms"),
            "library_device_ms": _step_sum(step, "library_device_ms"),
        })
    wall = time.perf_counter() - t_start
    print(f"wall: {wall:.1f} s after the build ({t_kernels:.1f} s kernel "
          f"phases)", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "phases": rows, "results": results,
                   "launches": launched, "kernels": kernels, "wall_s": wall},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
