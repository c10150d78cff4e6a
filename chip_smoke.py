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
     conv0's y takes K1's stem route (csrc/masked_conv_stem.cu; a
     `masked_conv_stem` row, route "stem", with its `plan`, cuDNN's
     product alone on the pre-selected weight and the earlier K1 on the
     same inputs, `earlier_ms`, `earlier_device_ms`); conv0 in f32, a
     width-0.125 conv2 (Cin 8, Cout 16) and the f32 conv7 hold the old K1
     and K2. K3 takes csrc/masked_matmul_wgrad.cu's split-M
     wgmma wgrad GEMM at conv2/4/7/10 (`route` "wgmma") and over conv0's
     im2col patches ("im2col+wgmma"; the im2col kernel also alone, bit for
     bit, in a `masked_conv_im2col` row, beside `F.unfold` as its library
     call), each row failing on another route, with the device ms of the GEMM,
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
     every train phase also prints the kernel step's roofline block at the
     compared batch (utils/roofline.py: the FLOPs of one default step,
     counted by FlopCounterMode, over the kernel step's ms/step:
     `tflop_per_step`, `mfu_vs_spec`, `fraction_of_spec_floor`) beside the
     card's name and power limit;
  6. ViT kernel phases: the flash-attention kernels (K7 forward; the
     one-launch backward `flash_bwd`, csrc/flash_bwd_wgmma.cu, where
     `bwd_route` takes the shape, two launches equal bits, its walk and
     ring in `plan` and the pair's device time beside it; the dQ + dK/dV
     pair at every shape) at vit_cifar's batch-256 shape (256, 64, 4, 64),
     vit_b16's (64, 196, 12, 64), a causal T = 70, T = 320 (off the
     route), in f32 and at textcls's causal (256, 64, 4, 32) (hd 32, on
     the one-launch backward too), and the dense route
     (masked_matmul; bf16: the select pass and TN GEMM of
     csrc/masked_matmul.cu for y and dx, each also alone against its plain
     version, two launches equal bits; f32: K1-K2 at the 1x1 geometry; dw:
     the wgrad GEMM in bf16, with the columns of the conv rows and cuBLAS
     x^T g alone as `gemm_device_ms`, K3 at 1x1 in f32) at vit_cifar's
     three projection shapes, textcls's three ((16384, 128, 128), (16384,
     128, 512), (16384, 512, 128); textcls's rows sum in the kernels
     line's `textcls_step`) and one ragged
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
     36 + 36 + 36 and 72 select passes); steps 7-9 again for textcls
     (depth 4, dim 128, 4 heads of 32, vocab 256, 64 tokens, both tasks
     causal; token batches: a forward of the server launches nothing; the
     eval step flash 4, dense 24, selects 24; a train step flash forward 4
     and the one-launch backward 4 (no dQ or dK/dV launch), dense 24 + 24
     + 24, 48 selects) and
     vit_moe_cifar (depth 6, dim 256, 4 heads, 4 experts at capacity
     factor 1.25 on the odd blocks; eval flash 6, dense 30, selects 30;
     train flash forward 6 and the one-launch backward 6, dense 30 + 30 +
     30, 60 selects), each train phase with ms/step and device ms a step
     at batch 256; and for vit_cifar the fused q|k|v phase (`qkv_phase`):
     three default bf16 steps with flash attention, `qkv_fused=True` and
     not, losses within 2e-2 relative, the fused step's one-step update at
     most 2x as far from the f32 default step's as the unfused step's,
     exactly flash forward 6 and the one-launch backward 6 a fused step,
     ms/step both ways at batch 256 in turns;
 10. cycle phase: `run_sequence` over three synthetic CIFAR-100 tasks of
     5 classes on the bf16 kernel step, VGG16-BN at width 1.0, task 3
     growing once to 1.5 under an unreachable goal; per phase steps,
     ms/step and img/s, `check_state` at every task boundary, old-task
     logits across add-task and prune (max|diff| must be 0), the growth
     audit against its bound, a second `run_sequence` over the checkpoints
     (every task resumed, the same state bit for bit), ms per prune event
     at width 1.0 and seconds for `grow_state`;
 11. deploy phase, the serving side from a checkpoint through the CLI:
     VGG16-BN at width 1.0 (step 3's state, tasks named as CIFAR-100
     superclass tasks) saved with utils/checkpoint; `check` (clean) and
     `stats`; `export` bf16 and `export --int8 --calibrate` (64 synthetic
     images a task); `serve` offline on both artifacts at bucket 256 (bf16
     with --fused-chain launches K4 8 times; int8 launches no fused chain
     and 13 int8 products); every int8 product of a forward at bucket 256
     (VGG16-BN's 13 convs; vit_cifar's patch conv and 36 dense layers) on
     the card's `torch._int_mm` route, bit for bit against the exact plain
     product on the same patches, with its device ms, the patch gather's
     alone, the bf16 library call on the same shapes (cuDNN, cuBLAS) and
     the bound at the int8 peak; int8 against bf16 at `cpg_tpu`'s bound
     (rtol 0.2, atol 0.5); calibrated int8 bit-equal alone and co-batched
     with saturated rows; `serve_http` in-process on 127.0.0.1:0, 256
     single-image requests from 32 client threads at batch windows 0 and
     3 ms (bf16 against in-process predict at the bf16 tolerance, bit
     equality reported; calibrated int8 bit-equal at 3 ms), with p50/p99,
     img/s and predict calls per request; `export-torch` ->
     `import-torch` bit for bit; `inference` on the synthetic test split;
     then an int8 vit_cifar server at full width against its f32 server;
 12. ResNet-50 (224 px, batch 32): K1-K3 at its 19 conv geometries (K1
     and K2 past the stem on `masked_conv.fwd_dx_route`'s select pass and
     dense GEMM or im2col walk, each row with its `route` and the two
     launches' own device ms; the stem's y on K1's stem route, a
     `masked_conv_stem` row as conv0's) and K4-K6 at its 4 seams (K4 and K5 on
     their "im2col" routes: K4's halo tiles over 128 consecutive pixels,
     K5's im2col dgrad walk with its fused epilogue; each row with its
     `plan`, the route kernel's device ms and cuDNN's alone), serving, the eval
     and train steps (conv selects 39 and 78), and the
     finegrained CLI cycle (`finegrained_phase`); K3 of every conv on
     the wgrad GEMM (1x1/1 x and g as matrices, the rest TMA im2col loads,
     the stem its patches: im2col 1 a train step); SphereNet-20 (112x96,
     batch 256): K1, K2 and K3 at its 8 conv geometries
     (`SPHERE_CONV_SHAPES`; K1, K2 and K3 past the stem on the im2col walk,
     the stem's y on K1's stem route;
     K3 held against the plain version summed in
     f64) and fc5 on the dense route, a bf16 server against the f32
     server, the eval step, the train step with task 2 under the A-Softmax
     loss (exact launches: K1 20 of which the stem route 1, K2 19, K3 20,
     conv selects 38, im2col 1, dense 1 + 1 + 1, select 2), and the face
     CLI cycle (`face_phase`:
     `sequence --experiment face`, growth to 1.5, LFW verification, task 1 across
     compaction and growth, resume, export/serve bf16 and calibrated
     int8, export-torch/import-torch); then the textcls cycle
     (`text_phase`: `sequence --experiment textcls --text-causal` over
     three synthetic token tasks on the kernel step, task 3 growing once to
     1.5; check_state at every boundary, old-task logits across add-task
     and prune bit-equal, the growth audit, resume bit-equal, export bf16
     and calibrated int8, serve, `inference`); the stream phase
     (`stream_phase`, after the finegrained one): two synthetic
     finegrained tasks of 20 classes written by `save_memmap_dataset`,
     `sequence --experiment finegrained --memmap-dir D --native-loader`
     with the kernel flags at width 1.0, 224 px, batch 32 (5 steps an
     epoch), check_state at every boundary, every batch the step received
     on the card byte-equal to a fresh `NativeBatcher`'s host batch with
     the device prefetcher's staging pairs written again (some must be),
     the prefetcher at depths 1-3 over 12 loader batches with its copies
     held back on the card (byte-equal; with the waits skipped, a control,
     some batch must differ), a `--memmap-dir` run without the loader
     bit-equal to the in-memory run, the loader's batches/s alone and the
     loop's ms/step with the loader and prefetcher, with the NumPy gather
     and prefetcher and with the NumPy gather and no prefetch; last, `python -m cpg_tpu_torch doctor --json` in a
     subprocess (exit 0 with the card's name, count, capability 9.0 and
     power limit; exit 1 with CUDA_VISIBLE_DEVICES empty);
 13. parallel phase (`parallel_phase`, after the text cycle): VGG16-BN's
     task-2 kernel step (K1-K6) data-parallel over two ranks spawned on the
     one card and joined over gloo (NCCL refuses two ranks on one GPU), at
     a global batch of 256 (128 rows a rank) from `build_state`'s state
     with 2% of task 2's entries released and its piggymask kept 1e-3 from
     the threshold, f32 then bf16, three steps each on the same batches and
     crop/flip draws as the one-process kernel step (run by rank 0): f32
     losses within 1e-4 relative and shared and private one-step updates
     within 1e-2 of the update's norm; bf16 losses within 2e-2 and each
     group's update at most 2x as far from the f32 update as the
     one-process bf16 step's; the replicas bit-equal after every step
     (`check_replicas`), task-1 entries bit-unchanged and free entries 0;
     each rank's launches a step equal to the one-process step's
     (`TRAIN_LAUNCHES` in bf16); ms/step of the two-rank step and of the
     one-process step (time-slicing one card: no speed result); then the
     model axis on the same two ranks as (data=1, model=2)
     (`dp_ranks_check` with n_model 2): VGG16-BN's and vit_cifar's kernel
     steps at width 1.0 with each rank holding its half of every kernel
     that divides (and of its ownership, piggymask and optimizer moments;
     the bytes held printed), under the same rules but the f32 updates'
     (within 1e-4 of the update's norm: no data ranks), the replicated
     tensors bit-equal
     across the ranks and the split ones over the data group, the
     products (K1-K6; vit_cifar's dense K1-K3 and K7) launched a step as
     often as in the one-process step, and the route each kernel's slice
     takes (`tp_routes`); then
     `sequence --parallel 1` through `cli.main` (NCCL, a world of one rank)
     over two synthetic tasks with the kernel flags, `check_state` at both
     boundaries and both checkpoints bit-equal to the run without the
     flag; a bf16 `TaskServer(mesh=make_mesh(devices=[cuda:0, cuda:0]),
     fused_chain=True)` against the unmeshed server at 1, 37 and 256 rows
     of both tasks and a mixed list (within 2e-2 x max|ref|, bit equality
     recorded); and `sequence --parallel 2` over NCCL where two cards are
     visible (one line saying it did not run otherwise);
 13b. act_shard phase (`act_shard_phase`): vit_cifar's, textcls's and
     vit_moe_cifar's bf16 kernel steps (`use_pallas` + `flash_attention`)
     at width 1.0 and batch 256 on the same two gloo ranks as (data=1,
     model=2) with `act_sharder(tokens=True, experts=True)`: the kernels
     whole on each rank, the tokens split (32 of 64 a rank between the
     layers that mix them; the rows each rank holds at every "tokens" seam
     printed and held to T/2) and vit_moe_cifar's experts (two a rank),
     under the model axis's rules (`dp_ranks_check` with "act_shard"):
     dense K1-K3 (proj, fc1 and fc2 on a rank's rows) and K7 at whole T
     (the one-launch backward, textcls's hd 32 too) launched a step as
     often as in one process; then the pipeline
     phase (`pipeline_phase`): vit_cifar's train step through
     `TrainConfig.pipeliner`, its 6 blocks as 2 stages on two gloo ranks
     sharing the card, 4 microbatches of 64, K7 in the blocks
     (`_default_block_fn(flash_attention=True)`), against the one-process
     inline step with K7 by the data-parallel rules (f32, bf16), replicas
     bit-equal after every step, each stage launching K7 15 times a step
     forward and backward (5 ticks of 3 blocks, dead ticks included)
     against the one process's 6;
 14. checks that each phase reached its kernels (the serve and eval phases
     their forwards, the train phases their backwards, the cycles K1-K6,
     the deploy phase K4, the stream phase K1-K6 and the conv selects,
     each rank of the parallel phase and its `--parallel 1` run K1-K6, its
     meshed server K4, each rank of the model axis's steps K1-K6 and the
     dense K1-K3 and K7,
     the fused q|k|v phase K7, the SphereNet phases K1-K3 and the dense
     route,
     textcls's phases K7 forward and its one-launch backward and the
     dense route,
     vit_moe_cifar's K7 and the dense route, each rank of the act_shard
     steps the dense K1-K3 and K7, each pipeline stage K7),
     prints the kernels' JSON line (launch counts from every phase,
     errors, times, bounds; ResNet-50's and SphereNet-20's train steps in
     `resnet50_step` and `spherenet20_step`; K1's and K2's VGG16-BN rows on
     the conv boxes beside cuDNN alone in `boxes_step`), the card line,
     and last the result line.
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

from cpg_tpu_torch.utils.roofline import SPEC

SEED = 0
BATCH = 256
# H100 SXM published peaks (utils/roofline.py SPEC): HBM bytes a second,
# dense tensor-core bf16 and int8 operations, f32 outside the tensor cores
HBM_BYTES_PER_S = SPEC["hbm_gbps"] * 1e9
PEAK_FLOPS = {"bfloat16": SPEC["bf16_tflops"] * 1e12,
              "int8": SPEC["int8_tops"] * 1e12,
              "float32": SPEC["f32_tflops"] * 1e12}
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
# flash attention (name, N, T, H, hd, causal, dtype, launches per train
# step at batch 256, the arch whose step that is: vit_cifar's, or textcls's,
# counted in the kernels line's `textcls_step`, or one of SPLIT_STEPS; 0
# launches = an extra shape, not on the timed step). The backward takes
# `flash.bwd_route`'s one-launch kernel at the bf16 shapes up to T = 256
# (hd 64, and textcls's hd 32); T = 320 and f32 keep the dQ + dK/dV pair on
# the path, which every shape also times beside it.
FLASH_SHAPES = [
    ("vit_cifar", BATCH, 64, 4, 64, False, "bfloat16", 6, "vit_cifar"),
    ("vit_b16", 64, 196, 12, 64, False, "bfloat16", 0, "vit_b16"),
    ("causal_t70", BATCH, 70, 4, 64, True, "bfloat16", 0, None),
    ("off_route_t320", 32, 320, 4, 64, False, "bfloat16", 0, None),
    ("vit_cifar_f32", 32, 64, 4, 64, False, "float32", 0, "vit_cifar"),
    ("textcls", BATCH, 64, 4, 32, True, "bfloat16", 4, "textcls"),
    # the pipeline phase's stages: a microbatch of BATCH / PP_MICRO rows,
    # 3 blocks x (PP_MICRO + PP_STAGES - 1) ticks a stage, bf16 and f32
    ("vit_cifar_pp", BATCH // 4, 64, 4, 64, False, "bfloat16", 15,
     "vit_cifar_pp"),
    ("vit_cifar_pp_f32", BATCH // 4, 64, 4, 64, False, "float32", 15,
     "vit_cifar_pp")]
# dense route (name, M, K, N, dtype, mode, launches per step, the arch whose
# step: vit_cifar's, or textcls's 4 blocks' q/k/v/proj, fc1 and fc2, or one
# of SPLIT_STEPS)
DENSE_SHAPES = [
    ("qkv_proj", BATCH * 64, 256, 256, "bfloat16", "binary", 24, "vit_cifar"),
    ("fc1", BATCH * 64, 256, 1024, "bfloat16", "binary", 6, "vit_cifar"),
    ("fc2", BATCH * 64, 1024, 256, "bfloat16", "binary", 6, "vit_cifar"),
    ("fc2_ternary", BATCH * 64, 1024, 256, "bfloat16", "ternary", 0,
     "vit_cifar"),
    ("vit_b16_qkv", 64 * 196, 768, 768, "bfloat16", "binary", 0, "vit_b16"),
    ("qkv_proj_f32", 2048, 256, 256, "float32", "binary", 0, "vit_cifar"),
    ("textcls_qkv_proj", BATCH * 64, 128, 128, "bfloat16", "binary", 16,
     "textcls"),
    ("textcls_fc1", BATCH * 64, 128, 512, "bfloat16", "binary", 4, "textcls"),
    ("textcls_fc2", BATCH * 64, 512, 128, "bfloat16", "binary", 4,
     "textcls"),
    # the model axis: one rank's slice of vit_cifar's products over two
    ("qkv_proj_tp2", BATCH * 64, 256, 128, "bfloat16", "binary", 0,
     "vit_cifar"),
    ("fc1_tp2", BATCH * 64, 256, 512, "bfloat16", "binary", 0, "vit_cifar"),
    # split tokens (the act_shard phase, (data=1, model=2)): proj, fc1 and
    # fc2 on a rank's 32 of 64 tokens (vit_moe_cifar's are vit_cifar's);
    # q/k/v run on the gathered tokens, at the rows above
    ("proj_sp2", BATCH * 32, 256, 256, "bfloat16", "binary", 6,
     "vit_cifar_sp"),
    ("fc1_sp2", BATCH * 32, 256, 1024, "bfloat16", "binary", 6,
     "vit_cifar_sp"),
    ("fc2_sp2", BATCH * 32, 1024, 256, "bfloat16", "binary", 6,
     "vit_cifar_sp"),
    ("textcls_proj_sp2", BATCH * 32, 128, 128, "bfloat16", "binary", 4,
     "textcls_sp"),
    ("textcls_fc1_sp2", BATCH * 32, 128, 512, "bfloat16", "binary", 4,
     "textcls_sp"),
    ("textcls_fc2_sp2", BATCH * 32, 512, 128, "bfloat16", "binary", 4,
     "textcls_sp")]
# the steps of the act_shard and pipeline phases: their rows' launches a
# step are a rank's on that step, kept out of the one-process steps' sums
SPLIT_STEPS = ("vit_cifar_sp", "textcls_sp", "vit_cifar_pp")
# the model axis: one rank's slice of VGG16-BN's convs over two ranks,
# where the slice's shape leaves the GEMM routes (conv1's seam at 32
# channels: the earlier K4 and K5) or keeps them (conv2, conv3), and conv0's
# (the old K1, K3 over im2col patches); (name, hw, cin, cout), and the
# seams' K4 and K5 routes
TP_MASKED_SHAPES = [("conv0_tp2", 32, 3, 32), ("conv2_tp2", 16, 64, 64)]
TP_CHAIN_SHAPES = [("conv1_tp2", 32, 64, 32, "k4", "k5"),
                   ("conv3_tp2", 16, 128, 64, "gemm", "gemm")]


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


# K3's route labels in the rows, by `masked_conv.wgrad_conv_route`: the
# wgrad GEMM over the conv boxes, over x and g as matrices (1x1 at stride
# 1), over TMA im2col loads (any grid, stride 1 or 2), over the im2col
# kernel's patches (the stems, conv0); the old K3
K3_LABELS = {"gemm": "wgmma", "dense": "dense+wgmma",
             "im2col": "tma_im2col+wgmma", "patches": "im2col+wgmma",
             None: "k3"}


def k3_plan(route, n, ho, wo, k, cin, cout):
    """The wgrad GEMM's plan on K3's route at a k x k conv of an n x ho x
    wo output grid (None off the GEMM): the boxes' `wgrad_conv_plan`, or
    `wgrad_plan` in 128-pixel steps (im2col loads) or 64-row steps (x as a
    matrix, the patches)."""
    from cpg_tpu_torch.ops import masked_matmul as mm

    sms, m = mm._sms(0), n * ho * wo
    if route == "gemm":
        return mm.wgrad_conv_plan(n, ho, wo, cin, cout, k * k, sms)
    if route == "im2col":
        return mm.wgrad_plan(m, k * k * cin, cout, sms, mm.WGRAD_CONV_ROWS)
    if route in ("dense", "patches"):
        return mm.wgrad_plan(m, k * k * cin, cout, sms)
    return None


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


def stem_cols(torch, x, w, own, pm, stride, pad, mode, cudnn, plain):
    """On K1's stem route (csrc/masked_conv_stem.cu): its plan, cuDNN's
    product alone on the pre-selected weight (`cudnn`, as
    `cudnn_device_ms`) and the earlier K1 (csrc/masked_conv_fwd.cu) on the
    same inputs, held against the plain version too
    (`earlier_max_abs_err`, `earlier_ms`, `earlier_device_ms`)."""
    from cpg_tpu_torch.ops import masked_conv as mc
    from cpg_tpu_torch.ops.conv import resolve_padding

    kh, kw, cin, cout = w.shape
    n, h, wd, _ = x.shape
    pads = resolve_padding(pad, h, wd, kh, kw, stride)
    plan = mc.stem_plan(n, h, wd, cin, cout, kh, kw, stride, pads,
                        torch.cuda.get_device_properties(
                            x.device).multi_processor_count)
    old = lambda: mc.launch_fwd(x, w, own, pm, 2, stride, pad, THR, mode)
    return dict(route="stem", plan=list(plan),
                cudnn_device_ms=device_ms(cudnn),
                earlier_max_abs_err=compare(old(), plain, "bfloat16",
                                            "earlier masked_conv_fwd"),
                earlier_ms=time_ms(old), earlier_device_ms=device_ms(old))


def masked_conv_phase(torch, dev, name, hw, cin, cout, dtype_name, mode,
                      per_step=None):
    """K1 at one shape (the GEMM route, the stem route or the old kernel,
    as `conv_route` and `stem_route` decide; a bf16 conv with Cin < 8 and
    Cout a multiple of 64 fails off the stem route), two launches equal
    bits; on the GEMM route also its select row, on the stem route its
    `stem_cols`."""
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
    stem = mc.stem_route(x, w, 1, "SAME")
    if stem != (dtype_name == "bfloat16" and cin < 8 and cout % 64 == 0):
        raise AssertionError(f"masked_conv {name}: stem route {stem}")
    rows, extra = [], {}
    if stem:
        w_sel = effective_kernel(w, own, pm, 2, mask_mode=mode).to(dt)
        extra = stem_cols(torch, x, w, own, pm, 1, "SAME", mode,
                          lambda: conv2d_nhwc(x, w_sel, 1, (1, 1, 1, 1)),
                          plain())
    elif route:
        sel, extra = conv_route_rows(
            torch, w, own, pm, mode,
            lambda wt: mm.launch_conv_gemm(x, wt, (hw, hw), 3, 3, 1, 1, False),
            lambda w_sel: conv2d_nhwc(x, w_sel, 1, (1, 1, 1, 1)), False,
            common)
        rows.append(sel)
    rows.insert(0, dict(kernel="masked_conv_stem" if stem
                        else "masked_conv_fwd", **common,
                        **{"route": "select+gemm" if route else "k1",
                           **extra},
                        max_abs_err=err, **timed(kern, plain, library),
                        bound_ms=b_ms, bound_by=b_by))
    return rows


def fused_chain_phase(torch, dev, name, hw, cin, cout, dtype_name,
                      want_route, per_step=None, batch=BATCH):
    """K4 at one seam (its "gemm" or "im2col" route, or the earlier kernel
    "k4", as `fused_chain.fwd_route` decides; fails unless it is
    `want_route`), two launches equal bits; on a route its plan and the
    kernel's own device time; cuDNN's conv alone on the materialised
    activation beside it."""
    from cpg_tpu_torch.ops import fused_chain as fc
    from cpg_tpu_torch.ops import masked_matmul as mm
    from cpg_tpu_torch.ops.conv import conv2d_nhwc

    dt = getattr(torch, dtype_name)
    g = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((batch, hw, hw, cin), generator=g).to(dev, dt)
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
              + batch * hw * hw * cout * elt)
    flops = 2.0 * batch * hw * hw * 9 * cin * cout
    b_ms, b_by = bound(nbytes, flops, dtype_name)
    act = torch.relu(x * ad + bd)
    route = fc.fwd_route(x, wd, dt)
    extra = dict(route="k4")
    if route:
        plan = (*mm.fused_fwd_plan(batch, hw, hw, cin, cout, mm._sms(0)),
                mm.fused_fwd_halo(hw, hw)[1])  # + the second box's split
        extra = dict(route=route, plan=[list(p) if isinstance(p, tuple)
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
                shape=[batch, hw, hw, cin, cout], max_abs_err=err,
                **timed(kern, plain, library), bound_ms=b_ms, bound_by=b_by,
                **extra, **({} if per_step is None else {"per_step": per_step}))


def _conv_inputs(torch, dev, hw, cin, cout, dt, seed, batch=BATCH, k=3,
                 hwo=None):
    """(generator, x, w, g) of a conv; hw and hwo (the output grid, hw by
    default) are a side or an (H, W) pair."""
    g = torch.Generator().manual_seed(seed)
    hw = (hw, hw) if isinstance(hw, int) else tuple(hw)
    x = torch.randn((batch, *hw, cin), generator=g).to(dev, dt)
    w = (torch.randn((k, k, cin, cout), generator=g)
         * (2.0 / (k * k * cout)) ** 0.5).to(dev)
    hwo = hw if hwo is None else (hwo, hwo) if isinstance(hwo, int) else hwo
    gy = (torch.randn((batch, *hwo, cout), generator=g) * 0.1).to(dev, dt)
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
    # VGG16-BN's K3 routes: conv0 its patches, the convs with Cin and Cout
    # multiples of 64 the boxes, the rest (narrow, f32) the old K3
    route = mc.wgrad_conv_route(x, w, 1, "SAME")
    bf16 = dtype_name == "bfloat16"
    want = ("patches" if bf16 and cin == 3 else "gemm" if bf16
            and cin % 64 == 0 and cout % 64 == 0 else None)
    if route != want:
        raise AssertionError(f"masked_conv_bwd_dw {name}: route {route}, "
                             f"expected {want}")
    extra = {}
    if route:
        extra = wgrad_cols(kern, k3_plan(route, BATCH, hw, hw, 3, cin, cout),
                           9 * cin, cout)
        # cuDNN's weight gradient alone: the GEMM's yardstick
        extra["cudnn_device_ms"] = device_ms(cudnn)
    if route == "patches":
        rows.append(im2col_row(torch, x, -(-9 * cin // 8) * 8, common))
    rows.append(dict(kernel="masked_conv_bwd_dw", **common,
                     route=K3_LABELS[route], max_abs_err=err,
                     **timed(kern, plain, library), bound_ms=b_ms,
                     bound_by=b_by, **extra))
    return rows


def im2col_row(torch, x, kp, common, k=3, stride=1, pads=(1, 1, 1, 1)):
    """A conv's im2col kernel alone against its plain version, bit for bit;
    bound by its bytes (x read once, the patches written once). Library:
    `F.unfold` on x's NCHW view, the one call that forms the same patches,
    as (N, C*kh*kw, L) in (c, dh, dw) column order (timed, not compared;
    symmetric padding only, as every conv here has)."""
    from cpg_tpu_torch.ops import masked_matmul as mm

    kern = lambda: mm.launch_im2col(x, k, k, stride, pads, kp)
    plain = lambda: mm.im2col_plain(x, k, k, stride, pads, kp)
    got = kern()
    if not torch.equal(got.view(torch.int16), plain().view(torch.int16)):
        raise AssertionError(f"masked_conv_im2col {common['layer']}: bits "
                             "differ from the plain version")
    b_ms, b_by = bound((x.numel() + got.numel()) * x.element_size(), 0.0,
                       "bfloat16")
    lib = {"library_ms": None, "library_device_ms": None}
    pt, pb, pl, pr = pads
    if (pt, pl) == (pb, pr):
        xt = x.permute(0, 3, 1, 2)
        unfold = lambda: torch.nn.functional.unfold(
            xt, k, padding=(pt, pl), stride=stride)
        lib = {"library_ms": time_ms(unfold),
               "library_device_ms": device_ms(unfold),
               "library": "F.unfold, NCHW view, (c, dh, dw) columns"}
    return dict(kernel="masked_conv_im2col", **common, max_abs_err=0.0,
                ms=time_ms(kern), device_ms=device_ms(kern),
                plain_ms=time_ms(plain), **lib, bound_ms=b_ms, bound_by=b_by)


def fused_chain_bwd_phases(torch, dev, name, hw, cin, cout, dtype_name,
                           want_route, per_step=None, batch=BATCH):
    """K5 (its "gemm" or "im2col" route, or the earlier kernel "k5", as
    `fused_chain.dx_route` decides; fails unless it is `want_route`; two
    launches equal bits, with its plan, kernels' device times and cuDNN's
    dgrad alone on a route) and K6 at one shape."""
    from cpg_tpu_torch.ops import fused_chain as fc
    from cpg_tpu_torch.ops import masked_matmul as mm

    dt = getattr(torch, dtype_name)
    gen, x, w, gy = _conv_inputs(torch, dev, hw, cin, cout, dt, SEED + 5,
                                  batch)
    a = (torch.rand((cin,), generator=gen) + 0.5).to(dev)
    b = (torch.randn((cin,), generator=gen) * 0.3).to(dev)
    wd = w.to(dt)
    elt = x.element_size()
    flops = 2.0 * batch * hw * hw * 9 * cin * cout
    gt, xt = gy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2)
    common = dict(layer=name, dtype=dtype_name, shape=[batch, hw, hw, cin, cout],
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
    route = fc.dx_route(x, wd, dt)
    extra = dict(route="k5")
    if route:
        if route == "gemm":
            plan = mm.fused_dx_plan(batch, hw, hw, cin, cout, mm._sms(0))
            gemm = "gemm_tn_bf16_kernel"
        else:  # the phase's taps dropped: (rows, cols, lower_w, lower_h)
            plan = mm.fused_dx_im2col_plan(batch, hw, hw, cin, cout,
                                           mm._sms(0))
            plan = (plan[0][0][:4], *plan[1:])
            gemm = "conv_im2col_kernel"
        parts = kernel_device_ms(kern, (gemm, "colsum_kernel"))
        extra = dict(route=route, plan=[list(p) if isinstance(p, tuple)
                                        else p for p in plan],
                     gemm_kernel_device_ms=parts[gemm],
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
    act = torch.relu(x.float() * a + b).to(dt).permute(0, 3, 1, 2)
    rows.append(dict(kernel="fused_chain_bwd_dw", **common, max_abs_err=err,
                     **timed(kern, plain, library), bound_ms=b_ms,
                     bound_by=b_by, cudnn_device_ms=device_ms(
                         lambda: torch.nn.grad.conv2d_weight(
                             act, (cout, cin, 3, 3), gt, 1, 1))))
    return rows


# ResNet-50 at width 1.0, 224 px, batch 32 (the finegrained preset): every
# distinct masked-conv geometry of a train step (name, input H=W, kernel,
# stride, Cin, Cout, convs of that geometry in one forward: 40 in all)
RESNET_BATCH = 32
RESNET_CONV_SHAPES = [
    ("stem_7x7s2", 224, 7, 2, 3, 64, 1),
    ("l1b0_conv1", 56, 1, 1, 64, 64, 1),
    ("l1_conv1", 56, 1, 1, 256, 64, 2),
    ("l1_conv3_ds", 56, 1, 1, 64, 256, 4),
    ("l2b0_conv1", 56, 1, 1, 256, 128, 1),
    ("l2_conv2_s2", 56, 3, 2, 128, 128, 1),
    ("l2_conv3", 28, 1, 1, 128, 512, 4),
    ("l2_ds_s2", 56, 1, 2, 256, 512, 1),
    ("l2_conv1", 28, 1, 1, 512, 128, 3),
    ("l3b0_conv1", 28, 1, 1, 512, 256, 1),
    ("l3_conv2_s2", 28, 3, 2, 256, 256, 1),
    ("l3_conv3", 14, 1, 1, 256, 1024, 6),
    ("l3_ds_s2", 28, 1, 2, 512, 1024, 1),
    ("l3_conv1", 14, 1, 1, 1024, 256, 5),
    ("l4b0_conv1", 14, 1, 1, 1024, 512, 1),
    ("l4_conv2_s2", 14, 3, 2, 512, 512, 1),
    ("l4_conv3", 7, 1, 1, 512, 2048, 3),
    ("l4_ds_s2", 14, 1, 2, 1024, 2048, 1),
    ("l4_conv1", 7, 1, 1, 2048, 512, 2),
]
# the 13 stride-1 bottleneck seams: (name, H=W, channels, seams a forward);
# no 128-pixel box of whole rows or images tiles their grids, so K4 and K5
# take the "im2col" routes
RESNET_SEAMS = [("l1_seam", 56, 64, 3), ("l2_seam", 28, 128, 3),
                ("l3_seam", 14, 256, 5), ("l4_seam", 7, 512, 2)]


def _resnet_pads(k, stride):
    """ResNet-50's padding of a conv: the stem's 3, the 3x3s' 1, none for
    the 1x1s."""
    return {7: ((3, 3), (3, 3)), 3: 1, 1: "SAME"}[k]


def conv_geometry_rows(torch, dev, arch, batch, name, hw, k, stride, pad,
                       cin, cout, per_step, with_dx=True):
    """K1, K2 (with_dx: not at a stem, whose input is the image) and K3 at
    one conv geometry of a model (input (H, W), kernel k, stride, padding
    `pad` as the model gives it), bf16 binary, each against its plain
    version with two launches giving the same bits. Used for the ResNet-50
    and SphereNet-20 geometries, none of which is on the conv boxes (128 %
    W != 0, or stride 2): K1 and K2 must take `masked_conv.fwd_dx_route`'s
    select pass and GEMM ("select+dense" at the 1x1 convs at stride 1,
    "select+im2col" elsewhere) at every geometry but the stems, which stay
    on the earlier kernels ("k1"; the row fails on another route); their
    rows add the select's and the GEMM's own device ms
    (`select_device_ms`, `gemm_kernel_device_ms`; the op's `device_ms`
    holds both). K3 must take the wgrad GEMM on `masked_conv.
    wgrad_conv_route`'s route: "dense+wgmma" (x and g as matrices) at the
    1x1 convs at stride 1, "tma_im2col+wgmma" (TMA im2col loads) at the
    rest past the stems, "im2col+wgmma" (the patches; the im2col kernel
    alone in a `masked_conv_im2col` row) at the stems; the row fails on
    another route. Its row adds the GEMM's, the gate pass's and the
    im2col's own device ms, the plan and the partials' bytes
    (`wgrad_cols`); K3 is held against its plain version summed in f64
    (`f32_plain_max_abs_err`: the kernel against the f32 plain version,
    reported). Besides the CUDA-event and profiler times, cuDNN's product
    alone on the pre-selected weight (`cudnn_device_ms`)."""
    from cpg_tpu_torch.ops import masked_conv as mc
    from cpg_tpu_torch.ops import masked_matmul as mm
    from cpg_tpu_torch.ops.conv import conv2d_nhwc, out_size, resolve_padding
    from cpg_tpu_torch.ops.masked import effective_kernel

    dt, n = torch.bfloat16, batch
    h, wd = hw
    pt, pb, pl, pr = resolve_padding(pad, h, wd, k, k, stride)
    ho, wo = out_size(h, k, stride, pt, pb), out_size(wd, k, stride, pl, pr)
    gen, x, w, gy = _conv_inputs(torch, dev, hw, cin, cout, dt, SEED + 9,
                                 n, k, (ho, wo))
    own = torch.randint(0, 4, w.shape, generator=gen, dtype=torch.int8).to(dev)
    pm = (torch.randn(w.shape, generator=gen) * 1e-2).to(dev)
    route = mc.fwd_dx_route(x, w, stride, pad)
    if route != (None if cin == 3 else "dense" if (k, stride) == (1, 1)
                 else "im2col"):
        raise AssertionError(f"{arch} {name}: y and dx on route {route}")
    stem = mc.stem_route(x, w, stride, pad)
    if stem != (cin == 3):
        raise AssertionError(f"{arch} {name}: stem route {stem}")
    gemm_name = {"dense": "gemm_tn_bf16_kernel",
                 "im2col": "conv_im2col_kernel"}.get(route)

    def route_cols(kern):
        """The route's `route` and its two launches' own device ms."""
        if route is None:
            return {}
        parts = kernel_device_ms(kern, ("select_bf16_kernel", gemm_name))
        return dict(route=f"select+{route}",
                    select_device_ms=parts["select_bf16_kernel"],
                    gemm_kernel_device_ms=parts[gemm_name])

    w_sel = effective_kernel(w, own, pm, 2).to(dt)
    xt, gt = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
    elt, n_w = 2, w.numel()
    flops = 2.0 * n * ho * wo * k * k * cin * cout
    common = dict(layer=name, dtype="bfloat16", mode="binary", arch=arch,
                  shape=[n, h, wd, cin, cout], kernel_size=k, stride=stride,
                  per_step=per_step)

    def pad_x():
        return torch.nn.functional.pad(xt, (pl, pr, pt, pb))

    rows = []
    kern = lambda: mc.masked_conv2d(x, w, own, pm, 2, stride=stride,
                                    padding=pad)
    plain = lambda: mc.masked_conv2d_plain(x, w, own, pm, 2, stride, pad)
    cudnn = lambda: conv2d_nhwc(x, w_sel, stride, (pt, pb, pl, pr))
    library = lambda: conv2d_nhwc(
        x, effective_kernel(w, own, pm, 2).to(dt), stride, (pt, pb, pl, pr))
    want = plain()
    err = compare(twice(torch, kern, f"{arch} masked_conv {name}"), want,
                  "bfloat16", f"{arch} masked_conv {name}")
    b_ms, b_by = bound(x.numel() * elt + 9 * n_w + gy.numel() * elt, flops,
                       "bfloat16")
    cols = (stem_cols(torch, x, w, own, pm, stride, pad, "binary", cudnn,
                      want) if stem
            else {"route": "k1", **route_cols(kern),
                  "cudnn_device_ms": device_ms(cudnn)})
    rows.append(dict(kernel="masked_conv_stem" if stem else "masked_conv_fwd",
                     **common, **cols, max_abs_err=err,
                     **timed(kern, plain, library), bound_ms=b_ms,
                     bound_by=b_by))
    if with_dx:
        kern = lambda: mc.masked_conv2d_bwd_dx(gy, x, w, own, pm, 2, stride,
                                               pad)
        plain = lambda: mc.masked_conv2d_bwd_dx_plain(gy, x, w, own, pm, 2,
                                                      stride, pad)

        def cudnn():
            dxp = torch.nn.grad.conv2d_input(
                (n, cin, h + pt + pb, wd + pl + pr),
                w_sel.permute(3, 2, 0, 1), gt, stride)
            return dxp[:, :, pt:pt + h, pl:pl + wd]

        def library():
            dxp = torch.nn.grad.conv2d_input(
                (n, cin, h + pt + pb, wd + pl + pr),
                effective_kernel(w, own, pm, 2).to(dt).permute(3, 2, 0, 1),
                gt, stride)
            return dxp[:, :, pt:pt + h, pl:pl + wd]

        err = compare(twice(torch, kern, f"{arch} masked_conv_bwd_dx {name}"),
                      plain(), "bfloat16",
                      f"{arch} masked_conv_bwd_dx {name}")
        rows.append(dict(kernel="masked_conv_bwd_dx", **common,
                         **{"route": "k2", **route_cols(kern)},
                         max_abs_err=err, **timed(kern, plain, library),
                         cudnn_device_ms=device_ms(cudnn), bound_ms=b_ms,
                         bound_by=b_by))
    kern = lambda: mc.masked_conv2d_bwd_dw(gy, x, w, own, 2, stride, pad)
    plain = lambda: mc.masked_conv2d_bwd_dw_plain(gy, x, w, own, 2, stride, pad)
    cudnn = lambda: torch.nn.grad.conv2d_weight(pad_x(), (cout, cin, k, k),
                                                gt, stride)

    def library():
        G = cudnn().permute(2, 3, 1, 0).float()
        return (torch.where(own == 2, G, 0.0),
                torch.where((own > 0) & (own < 2), G * w, 0.0))

    # held against the plain version summed in f64: at SphereNet's
    # 688,128-pixel reductions the f32 plain version is itself 1.1e-4 of
    # max|G| off (`f32_plain_max_abs_err`), the kernel 1.4e-5 (my chip
    # run, PR 13)
    got = twice(torch, kern, f"{arch} masked_conv_bwd_dw {name}")
    want = mc.masked_conv2d_bwd_dw_plain(gy, x, w, own, 2, stride, pad,
                                         acc_dtype=torch.float64)
    err = max(compare(got[0], want[0], "float32",
                      f"{arch} masked_conv_bwd_dw dw {name}", rel=SUM_TOL),
              compare(got[1], want[1], "float32",
                      f"{arch} masked_conv_bwd_dw dpm {name}", rel=SUM_TOL))
    f32 = plain()
    f32_err = max(float((u - v).abs().max()) for u, v in zip(got, f32))
    b_ms, b_by = bound(x.numel() * elt + gy.numel() * elt + 13 * n_w, flops,
                       "bfloat16")
    route = mc.wgrad_conv_route(x, w, stride, pad)
    want = ("patches" if cin == 3 else "dense" if (k, stride) == (1, 1)
            else "im2col")
    if route != want:
        raise AssertionError(f"{arch} {name}: K3 on route {route}, expected "
                             f"{want}")
    kk = k * k * cin
    extra = wgrad_cols(kern, k3_plan(route, n, ho, wo, k, cin, cout), kk,
                       cout)
    rows.append(dict(kernel="masked_conv_bwd_dw", **common,
                     route=K3_LABELS[route], max_abs_err=err,
                     f32_plain_max_abs_err=f32_err,
                     **timed(kern, plain, library),
                     cudnn_device_ms=device_ms(cudnn), bound_ms=b_ms,
                     bound_by=b_by, **extra))
    if route == "patches":
        rows.append(im2col_row(torch, x, -(-kk // 8) * 8, common, k, stride,
                               (pt, pb, pl, pr)))
    return rows


# SphereNet-20 at width 1.0, 112x96, batch 256 (the face preset): every
# distinct masked-conv geometry of a train step (name, input (H, W),
# stride, Cin, Cout, convs of that geometry in one forward: 20 in all;
# every conv 3x3 with padding 1), and fc5 (M, K, N)
SPHERE_BATCH = 256
SPHERE_CONV_SHAPES = [
    ("stem_s2", (112, 96), 2, 3, 64, 1),
    ("down2_s2", (56, 48), 2, 64, 128, 1),
    ("down3_s2", (28, 24), 2, 128, 256, 1),
    ("down4_s2", (14, 12), 2, 256, 512, 1),
    ("unit1", (56, 48), 1, 64, 64, 2),
    ("unit2", (28, 24), 1, 128, 128, 4),
    ("unit3", (14, 12), 1, 256, 256, 8),
    ("unit4", (7, 6), 1, 512, 512, 2),
]
SPHERE_FC5 = ("sphere_fc5", SPHERE_BATCH, 7 * 6 * 512, 512)


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


# the forward kwargs of build_state's two tasks: SphereNet-20's as the face
# experiment gives them (task 1 the CASIA task's AngleLinear head, task 2
# an expression task's linear head); textcls's as `--text-causal` does
TASK_KWARGS = {"spherenet20": ({"head_type": "angle"},
                               {"head_type": "linear"}),
               "textcls": ({"causal": True}, {"causal": True})}
# textcls's input: 64 token ids (the registry's, `--text-seq-len`'s default)
TEXT_SHAPE = (64,)


def build_state(torch, dev, arch="vgg16_bn_cifar", width_mult=1.0):
    from cpg_tpu_torch.core.pruner import one_shot_prune
    from cpg_tpu_torch.train.sequence import init_state, start_task

    kw1, kw2 = TASK_KWARGS.get(arch, (None, None))
    g = torch.Generator().manual_seed(SEED)
    state = init_state(arch, g, width_mult=width_mult, device=dev)
    start_task(state, "task1", 5, g, model_kwargs=kw1)
    state.shared, state.ownership = one_shot_prune(state.shared,
                                                   state.ownership, 1, 0.5)
    start_task(state, "task2", 5, g, model_kwargs=kw2)
    pm = state.tasks[2].piggymask
    for k in pm:  # some entries now fall below the 5e-3 threshold
        pm[k] = pm[k] + (torch.randn(pm[k].shape, generator=g) * 1e-2).to(dev)
    if arch == "resnet50":
        # damped residual branches (each block's last BN scale U(0.1, 0.3)),
        # as the CPU parity tests' state: at scale 1 the random 16-block
        # net is chaotic, and bf16 rounding alone moves the default step's
        # one-step update further than the update's own size
        for t in state.tasks.values():
            for k, v in t.private.items():
                if k.endswith("/bn3/scale"):
                    t.private[k] = (torch.rand(v.shape, generator=g) * 0.2
                                    + 0.1).to(dev)
    below = sum(int((v <= state.threshold).sum()) for v in pm.values())
    total = sum(v.numel() for v in pm.values())
    n_shared = sum(v.numel() for v in state.shared.values())
    print(f"state: {arch} width {width_mult}, {n_shared} sharable weights, task-2 "
          f"piggymask {below / total:.3f} below threshold", flush=True)
    return state


def _arch_io(arch):
    """(per-example input shape, eval preprocess, train augment, its
    draws(n, generator), batch) of an architecture's serve, eval and train
    phases: pad-crop and flip draws for CIFAR and ImageNet images, flips
    alone for the 112x96 face crops; textcls's 64 token ids take neither
    preprocess nor augmentation."""
    import torch

    from cpg_tpu_torch.cli import _identity_augment
    from cpg_tpu_torch.data import augment as A

    if arch in ("resnet50", "vit_b16"):
        return ((224, 224, 3), A.imagenet_eval_preprocess,
                A.imagenet_train_augment,
                lambda n, g: A.crop_flip_draws(n, g, 16), RESNET_BATCH)
    if arch == "spherenet20":
        return ((112, 96, 3), A.face_eval_preprocess, A.face_train_augment,
                lambda n, g: torch.randint(0, 2, (n,), generator=g).bool(),
                SPHERE_BATCH)
    if arch == "textcls":
        return (TEXT_SHAPE, None, _identity_augment, lambda n, g: None, BATCH)
    return ((32, 32, 3), A.cifar_eval_preprocess, A.cifar_train_augment,
            lambda n, g: A.crop_flip_draws(n, g, 4), BATCH)


def _inputs(shape, n, rng):
    """n random examples of an input shape from a numpy RandomState:
    uint8 images, or int32 token ids below textcls's vocab of 256."""
    return rng.randint(0, 256, (n, *shape)).astype(
        np.int32 if len(shape) == 1 else np.uint8)


def resnet_serve_phase(torch, dev, state, counts):
    """bf16 ResNet-50 `TaskServer(fused_chain=True)` through export -> load
    against the unfused server: requests of 1, 8, 37 and 64 rows and one
    mixed-task list, at the bf16 tolerance; the fused seams' launches in
    one forward (13); p50 and img/s at buckets 64 and 256, fused and
    unfused."""
    from cpg_tpu_torch.data.augment import imagenet_eval_preprocess as prep
    from cpg_tpu_torch.serve import TaskServer

    rng = np.random.RandomState(SEED + 12)
    ref = TaskServer(state, prep, compute_dtype=torch.bfloat16, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        TaskServer(state, prep, compute_dtype=torch.bfloat16,
                   fused_chain=True, device=dev).export(tmp)
        srv = TaskServer.load(tmp, prep, fused_chain=True, device=dev)
    srv.warmup()
    errs = []
    for n in (1, 8, 37, 64):
        x = rng.randint(0, 256, (n, 224, 224, 3)).astype(np.uint8)
        got = torch.from_numpy(srv.predict(2, x))
        want = torch.from_numpy(ref.predict(2, x))
        if got.shape != (n, 5):
            raise AssertionError(f"resnet50 serve: shape {tuple(got.shape)}")
        errs.append(compare(got, want, "bfloat16",
                            f"resnet50 serve {n} rows"))
    reqs = [(1 + i % 2, rng.randint(0, 256, (224, 224, 3)).astype(np.uint8))
            for i in range(12)]
    for i, (got, want) in enumerate(zip(srv.predict_mixed(reqs),
                                        ref.predict_mixed(reqs))):
        errs.append(compare(torch.from_numpy(got), torch.from_numpy(want),
                            "bfloat16", f"resnet50 predict_mixed {i}"))
    x = rng.randint(0, 256, (8, 224, 224, 3)).astype(np.uint8)
    before = counts.read()
    srv.predict(2, x)
    one = {k: v - before[k] for k, v in counts.read().items()}
    if one["fused_chain_fwd"] != 13 or one["masked_conv_fwd"] != 0:
        raise AssertionError(f"resnet50 serve: one forward launched {one}")
    lat = {}
    for n in (64, 256):
        x = rng.randint(0, 256, (n, 224, 224, 3)).astype(np.uint8)
        for label, s in (("fused", srv), ("unfused", ref)):
            lat[f"{label}_b{n}"] = _serve_latency(s, x, reps=10)
    return max(errs), lat, one


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


def vit_serve_phase(torch, dev, state, counts):
    """bf16 transformer server (vit_cifar, vit_moe_cifar, textcls's token
    batches) through export -> load against the f32 server, requests of 1,
    37 and 256 rows of both tasks and one mixed list (both the
    effective-params einsum path: a forward launches no port kernel, as
    `cpg_tpu`'s server has no flash route); then a calibrated int8 server
    (CALIB_PER_TASK inputs a task; vit_moe_cifar's experts dequantized, as
    `cpg_tpu`'s) against the f32 server at `cpg_tpu`'s bound on both tasks
    at bucket 256, bit-equal alone and co-batched with saturated rows in a
    bucket of 8, each int8 product against its plain version bit for bit;
    p50 and img/s at bucket 256, bf16 and int8."""
    from cpg_tpu_torch.serve import TaskServer

    shape, prep, _, _, _ = _arch_io(state.arch)
    rng = np.random.RandomState(SEED + 8)
    ref = TaskServer(state, prep, compute_dtype=torch.float32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        TaskServer(state, prep, compute_dtype=torch.bfloat16,
                   device=dev).export(tmp)
        srv = TaskServer.load(tmp, prep, device=dev)
    srv.warmup()
    errs = []
    for n in (1, 37, 256):
        x = _inputs(shape, n, rng)
        for tid in (1, 2):
            got = torch.from_numpy(srv.predict(tid, x))
            want = torch.from_numpy(ref.predict(tid, x))
            if got.shape != (n, 5):
                raise AssertionError(f"{state.arch} serve: shape "
                                     f"{tuple(got.shape)} for {n} rows")
            errs.append(compare(got, want, "bfloat16",
                                f"{state.arch} serve task {tid} {n} rows"))
    reqs = [(1 + i % 2, _inputs(shape, 1, rng)[0]) for i in range(12)]
    for i, (got, want) in enumerate(zip(srv.predict_mixed(reqs),
                                        ref.predict_mixed(reqs))):
        errs.append(compare(torch.from_numpy(got), torch.from_numpy(want),
                            "bfloat16",
                            f"{state.arch} predict_mixed request {i}"))
    before = counts.read()
    srv.predict(2, _inputs(shape, 8, rng))
    one = {k: v - before[k] for k, v in counts.read().items()}
    if any(one.values()):
        raise AssertionError(f"{state.arch} serve: one forward launched {one}")
    x = _inputs(shape, BATCH, rng)
    lat = {"bf16": _serve_latency(srv, x)}

    q8 = TaskServer(state, prep, quantize="int8", device=dev)
    q8.calibrate({tid: _inputs(shape, CALIB_PER_TASK, rng) for tid in (1, 2)})
    for tid in (1, 2):
        err, agree = _int8_bound(torch, q8.predict(tid, x),
                                 ref.predict(tid, x),
                                 f"{state.arch} int8 task {tid} vs f32")
        lat[f"int8_vs_f32_task{tid}"] = {"max_abs_diff": err,
                                         "argmax_agree": agree}
    # one bucket of 8 rows alone and beside saturated rows (bit-equal: the
    # calibrated scales do not see the batch); at bucket 256 the library's
    # float products may take another algorithm, so that equality is
    # reported, as the deploy phase does
    probe = x[:1]
    sat = np.full((BATCH - 1, *shape), 255, probe.dtype)
    alone = q8.predict(2, probe)
    if not np.array_equal(alone, q8.predict(
            2, np.concatenate([probe, sat[:3]]))[:1]):
        raise AssertionError(f"{state.arch}: calibrated int8 logits moved "
                             "when co-batched with saturated rows")
    lat["int8_co_batched_bucket256_bit_equal"] = bool(np.array_equal(
        alone, q8.predict(2, np.concatenate([probe, sat]))[:1]))
    with _Int8Calls() as rec:
        q8.predict(2, x)
    rows = int8_route_rows(torch, rec.calls, state.arch)
    if not rows:
        raise AssertionError(f"{state.arch}: an int8 forward ran no int8 "
                             "product")
    lat["int8"] = _serve_latency(q8, x)
    lat["int8_route"] = _route_totals(rows)
    return max(errs), lat


def sphere_serve_phase(torch, dev, state, counts):
    """bf16 SphereNet-20 server through export -> load against the f32
    server (both serve precomputed effective weights, as `cpg_tpu`'s, so a
    forward launches no port kernel): requests of 1, 8, 37, 64 and 256
    rows of both tasks (task 1 answers its AngleLinear head's cos part,
    task 2 its linear head) and one mixed list, at the bf16 tolerance; p50
    and img/s at buckets 64 and 256."""
    from cpg_tpu_torch.data.augment import face_eval_preprocess as prep
    from cpg_tpu_torch.serve import TaskServer

    rng = np.random.RandomState(SEED + 16)
    ref = TaskServer(state, prep, compute_dtype=torch.float32, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        TaskServer(state, prep, compute_dtype=torch.bfloat16,
                   device=dev).export(tmp)
        srv = TaskServer.load(tmp, prep, device=dev)
    srv.warmup()
    errs = []
    for n in (1, 8, 37, 64, 256):
        x = rng.randint(0, 256, (n, 112, 96, 3)).astype(np.uint8)
        for tid in (1, 2):
            got = torch.from_numpy(srv.predict(tid, x))
            want = torch.from_numpy(ref.predict(tid, x))
            if got.shape != (n, 5):
                raise AssertionError(f"spherenet20 serve: shape "
                                     f"{tuple(got.shape)}")
            errs.append(compare(got, want, "bfloat16",
                                f"spherenet20 serve task {tid} {n} rows"))
    reqs = [(1 + i % 2, rng.randint(0, 256, (112, 96, 3)).astype(np.uint8))
            for i in range(12)]
    for i, (got, want) in enumerate(zip(srv.predict_mixed(reqs),
                                        ref.predict_mixed(reqs))):
        errs.append(compare(torch.from_numpy(got), torch.from_numpy(want),
                            "bfloat16", f"spherenet20 predict_mixed {i}"))
    before = counts.read()
    srv.predict(2, rng.randint(0, 256, (8, 112, 96, 3)).astype(np.uint8))
    one = {k: v - before[k] for k, v in counts.read().items()}
    if any(one.values()):
        raise AssertionError(f"spherenet20 serve: one forward launched {one}")
    lat = {}
    for n in (64, 256):
        x = rng.randint(0, 256, (n, 112, 96, 3)).astype(np.uint8)
        lat[f"bf16_b{n}"] = _serve_latency(srv, x, reps=10)
        lat[f"f32_b{n}"] = _serve_latency(ref, x, reps=10)
    return max(errs), lat


# the kernel flags of each architecture's eval and train phases
KERNEL_FLAGS = {"vgg16_bn_cifar": dict(use_pallas_conv=True,
                                       use_fused_chain=True),
                "resnet50": dict(use_pallas_conv=True, use_fused_chain=True),
                "vit_cifar": dict(use_pallas=True, flash_attention=True),
                "textcls": dict(use_pallas=True, flash_attention=True),
                "vit_moe_cifar": dict(use_pallas=True, flash_attention=True),
                "spherenet20": dict(use_pallas_conv=True, use_pallas=True)}
# launches of one masked eval step with the kernel flags (VGG16-BN: its 5
# masked convs, conv0 on the stem route, a select pass before each of the
# other four, and 8 fused seams; ResNet-50: its 40 masked convs, the stem
# on the stem route, a select pass before each of the others, and 13 fused
# seams; SphereNet-20: its 20 masked convs, the stem on the stem route, a
# select pass before each of the others, and fc5 on the dense route, a
# select pass and the TN GEMM; the masked convs' counter counts every
# route's launch, `masked_conv_stem` the stem route's alone;
# textcls: 4 blocks of q/k/v/proj, fc1 and fc2 and one attention;
# vit_moe_cifar: 6 blocks of q/k/v/proj and attention, the 3 even blocks'
# fc1 and fc2 (the odd blocks' experts are einsums); no other kernel)
EVAL_LAUNCHES = {"vgg16_bn_cifar": {"masked_conv_fwd": 5,
                                    "masked_conv_select": 4,
                                    "masked_conv_stem": 1,
                                    "fused_chain_fwd": 8},
                 "resnet50": {"masked_conv_fwd": 40, "masked_conv_select": 39,
                              "masked_conv_stem": 1, "fused_chain_fwd": 13},
                 "textcls": {"flash_fwd": 4, "masked_matmul_fwd": 24,
                             "masked_matmul_select": 24},
                 "vit_moe_cifar": {"flash_fwd": 6, "masked_matmul_fwd": 30,
                                   "masked_matmul_select": 30},
                 "spherenet20": {"masked_conv_fwd": 20,
                                 "masked_conv_select": 19,
                                 "masked_conv_stem": 1,
                                 "masked_matmul_fwd": 1,
                                 "masked_matmul_select": 1}}


def eval_phase(torch, dev, state, counts):
    from cpg_tpu_torch.models import get_model
    from cpg_tpu_torch.train.step import TrainConfig, make_eval_step

    model_fn, _ = get_model(state.arch)
    shape, prep, _, _, n = _arch_io(state.arch)
    kw = dict(num_classes=5, mult=state.width_mult, has_piggymask=True,
              preprocess_fn=prep, model_kwargs=state.forward_kwargs(2),
              device=dev)
    rng = np.random.RandomState(SEED + 2)
    x = _inputs(shape, n, rng)
    y = rng.randint(0, 5, (n,))
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
    want = EVAL_LAUNCHES.get(state.arch)
    if want is not None and any(v != want.get(k, 0)
                                for k, v in launched.items()):
        raise AssertionError(f"eval {state.arch}: launches {launched}, "
                             f"expected {want}")
    return compare(got, ref, "bfloat16", f"{state.arch} masked eval step"), launched


# launches of each kernel in one train step of task 2 with the kernel flags:
# VGG16-BN's five masked convs (conv0's input is the image, so no dx; its
# y on the stem route; a select pass before the forward and dx of conv2,
# 4, 7 and 10, the GEMM route) and eight fused seams; vit_cifar's six blocks of six sdense layers and one
# attention (its patch stem is a plain product), a select pass before each
# forward and dx GEMM; zero for every other kernel
TRAIN_LAUNCHES = {
    "vgg16_bn_cifar": {"masked_conv_fwd": 5, "masked_conv_bwd_dx": 4,
                       "masked_conv_bwd_dw": 5, "masked_conv_select": 8,
                       "masked_conv_stem": 1,
                       "masked_conv_im2col": 1,
                       "fused_chain_fwd": 8,
                       "fused_chain_bwd_dx": 8, "fused_chain_bwd_dw": 8},
    "vit_cifar": {"flash_fwd": 6, "flash_bwd": 6,
                  "masked_matmul_fwd": 36, "masked_matmul_bwd_dx": 36,
                  "masked_matmul_bwd_dw": 36, "masked_matmul_select": 72},
    # textcls: 4 blocks of six sdense layers and one causal attention at hd
    # 32, on `flash.bwd_route`: its backward is the one-launch kernel, the
    # dQ + dK/dV pair at 0; vit_moe_cifar: as vit_cifar without the odd
    # blocks' MLPs
    "textcls": {"flash_fwd": 4, "flash_bwd": 4,
                "masked_matmul_fwd": 24, "masked_matmul_bwd_dx": 24,
                "masked_matmul_bwd_dw": 24, "masked_matmul_select": 48},
    "vit_moe_cifar": {"flash_fwd": 6, "flash_bwd": 6,
                      "masked_matmul_fwd": 30, "masked_matmul_bwd_dx": 30,
                      "masked_matmul_bwd_dw": 30,
                      "masked_matmul_select": 60},
    # ResNet-50: 40 masked convs (no dx for the stem, whose input is the
    # image; its y on the stem route; y, dx and K3 of the other 39 on the
    # dense or im2col route, a select pass before y and dx; the stem's K3
    # over its patches, one im2col) and 13 fused seams
    "resnet50": {"masked_conv_fwd": 40, "masked_conv_bwd_dx": 39,
                 "masked_conv_bwd_dw": 40, "masked_conv_select": 78,
                 "masked_conv_stem": 1,
                 "masked_conv_im2col": 1,
                 "fused_chain_fwd": 13, "fused_chain_bwd_dx": 13,
                 "fused_chain_bwd_dw": 13},
    # SphereNet-20: 20 masked convs (no dx for the stem, its y on the stem
    # route; y and dx of the other 19 on the im2col route, a select pass
    # each; the stem's K3 over im2col patches, K = 27) and fc5 on the dense
    # route (a select pass before the forward and dx GEMMs, K3 on the wgrad
    # GEMM)
    "spherenet20": {"masked_conv_fwd": 20, "masked_conv_bwd_dx": 19,
                    "masked_conv_bwd_dw": 20, "masked_conv_select": 38,
                    "masked_conv_stem": 1,
                    "masked_conv_im2col": 1,
                    "masked_matmul_fwd": 1, "masked_matmul_bwd_dx": 1,
                    "masked_matmul_bwd_dw": 1, "masked_matmul_select": 2},
}
TRAIN_STEPS = 3
# (batch sizes timed, steps a timed round): the first batch is also the
# compared steps'; bench.py's VGG16-BN batch is 1024, the finegrained
# preset's 32
TRAIN_TIMING = {"resnet50": ((RESNET_BATCH, 128), 5),
                "spherenet20": ((SPHERE_BATCH,), 5),
                "textcls": ((BATCH,), 5), "vit_moe_cifar": ((BATCH,), 5)}
TRAIN_TIMING_DEFAULT = ((BATCH, 1024), 10)
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
# step's is; the losses agree within LOSS_RTOL. ResNet-50 trains at the
# finegrained preset's learning rate (1e-3; the others at TrainConfig's
# 0.01), from the damped state of `build_state`. bf16 noise leaves that
# rule little power (a ResNet-50 K2 that drops the first row of every
# stride-2 dx passes it), so the kernel step also runs in f32 against the
# default f32 step, where only summation order and the fused seams' ReLU
# gradient at exact zeros differ: its shared and private one-step updates
# within F32_UPDATE_RTOL of the f32 update's norm (the piggymask's is left
# out: Adam turns near-zero gradients' rounding into lr-sized steps of
# either sign). Its losses are reported, not held: a sound ResNet-50's
# third loss moves by 1.2e-3 in f32, more than some faults move it.
LOSS_RTOL = 2e-2
UPDATE_RATIO = 2.0
F32_UPDATE_RTOL = 1e-2


def _train_tensors(st, fn):
    """Task 2's trained tensors of a state, keyed 'group/name'."""
    t2 = st.tasks[2]
    out = {f"shared/{k}": fn(v) for k, v in st.shared.items()}
    out.update({f"piggymask/{k}": fn(v) for k, v in t2.piggymask.items()})
    out.update({f"private/{k}": fn(v) for k, v in t2.private.items()})
    return out


def _stepper(torch, base, model_fn, augment, dev, cfg, mesh=None,
             model_sharded=False, **step_kw):
    """(a copy of `base`, run(x, y, draws, it) -> metrics): task 2's train
    step under `cfg` on the copy, its parameters and optimizer states
    carried from call to call. With `mesh` (over the ranks) the step is
    data-parallel: the copy broadcast from rank 0, each call given the
    global batch and its draws, of which this rank takes its rows; with
    `model_sharded` too, each rank keeps its slice of every kernel that
    divides over the model axis (`copy.shards` records them)."""
    from cpg_tpu_torch.parallel.mesh import (make_parallel_train_step,
                                             place_state, shard_batch,
                                             shared_shardings)
    from cpg_tpu_torch.train.step import make_train_step

    st = base.map_arrays(lambda t: t.clone())
    task = st.tasks[2]
    step, (opt_w, opt_pm) = make_train_step(
        model_fn, num_classes=5, mult=base.width_mult, has_piggymask=True,
        cfg=cfg, augment_fn=augment, device=dev, **step_kw)
    if mesh is not None:
        specs = (shared_shardings(mesh, st.shared, True) if model_sharded
                 else None)
        st.shared = place_state(mesh, st.shared, specs)
        st.ownership = place_state(mesh, st.ownership, specs)
        task.piggymask = place_state(mesh, task.piggymask, specs)
        for tree in (task.private, task.bn_state):
            place_state(mesh, tree)
        if specs is not None:
            st.shards = {k: v for k, v in specs.items() if v is not None}
        step = make_parallel_train_step(step, mesh,
                                        model_sharded=model_sharded,
                                        shards=st.shards)
    carry = [st.shared, task.piggymask, task.private, task.bn_state,
             opt_w.init({"shared": st.shared, "private": task.private}),
             opt_pm.init(task.piggymask)]

    def run(x, y, draws, it):
        if mesh is not None:
            x, y = shard_batch(mesh, x, y)
        out = step(*carry[:6], st.ownership, 2, x, y, draws, it)
        carry[:6] = out[:6]
        return out[6]
    return st, run


def _no_forgetting(torch, base, st, label):
    """Task 2's training left task 1's entries bit-unchanged, free entries
    zero and piggymask entries outside the prior domain unchanged."""
    t0 = base.tasks[2]
    for k, own in base.ownership.items():
        w, w0 = st.shared[k], base.shared[k]
        if not torch.equal(w[own == 1], w0[own == 1]):
            raise AssertionError(f"{label}: task-1 entries of {k} moved")
        if (w[own == 0] != 0).any():
            raise AssertionError(f"{label}: free entries of {k} nonzero")
        pm, pm0 = st.tasks[2].piggymask[k], t0.piggymask[k]
        if not torch.equal(pm[own != 1], pm0[own != 1]):
            raise AssertionError(f"{label}: piggymask of {k} moved outside "
                                 "the prior-task entries")


def _train_base(torch, dev, state, gen):
    """A copy of `state` with 2% of task 2's entries released (zero and
    free), so the free-entry invariant has entries to hold."""
    base = state.map_arrays(lambda t: t.clone())
    for k, own in base.ownership.items():
        sel = (own == 2) & (torch.rand(own.shape, generator=gen) < 0.02).to(dev)
        base.ownership[k] = own.masked_fill(sel, 0)
        base.shared[k] = base.shared[k].masked_fill(sel, 0.0)
    return base


def _update_dists(torch, init, firsts):
    """{label: {group: ||update - f32 update||}} and {group: ||f32
    update||} of the one-step updates `firsts[label]` (tensors after one
    step, keyed as `_train_tensors`) from `init`, the yardstick being
    firsts["f32"]."""
    dist, ref_norm = {}, {}
    for group in ("shared", "private", "piggymask"):
        keys = [k for k in init if k.startswith(group + "/")]
        u32 = torch.cat([(firsts["f32"][k] - init[k]).ravel() for k in keys])
        ref_norm[group] = u32.norm().item()
        for label, first in firsts.items():
            if label == "f32":
                continue
            u = torch.cat([(first[k] - init[k]).ravel() for k in keys])
            if not torch.isfinite(u).all():
                raise AssertionError(f"train {label}: non-finite {group} "
                                     "update")
            dist.setdefault(label, {})[group] = (u - u32).norm().item()
    return dist, ref_norm


def train_phase(torch, dev, state, counts):
    """Task 2's bf16 train step with the six kernels against the default
    step, and the kernel step in f32 against the f32 default step. Returns
    the comparison, the per-step launches and the timings."""
    from cpg_tpu_torch.cli import EXPERIMENT_PRESETS
    from cpg_tpu_torch.models import get_model
    from cpg_tpu_torch.train.losses import make_angle_loss
    from cpg_tpu_torch.train.step import TrainConfig
    from cpg_tpu_torch.utils.roofline import cost_of, roofline

    model_fn, _ = get_model(state.arch)
    shape, _, augment, draw_fn, _ = _arch_io(state.arch)
    timing_batches, round_steps = TRAIN_TIMING.get(state.arch,
                                                   TRAIN_TIMING_DEFAULT)
    gen = torch.Generator().manual_seed(SEED + 3)
    base = _train_base(torch, dev, state, gen)
    n_free = sum(int((o == 0).sum()) for o in base.ownership.values())
    step_kw = {}
    if state.arch == "spherenet20":
        # task 2 trains an AngleLinear head under the annealed A-Softmax
        # loss, so that the loss's backward runs over the kernels (the face
        # phase trains the linear head of the expression task)
        t2 = base.tasks[2]
        emb = base.shared["fc5/kernel"].shape[1]
        t2.private = {k: v for k, v in t2.private.items()
                      if not k.startswith("classifier/")}
        t2.private["classifier_angle/kernel"] = (
            torch.randn((emb, 5), generator=gen) * (2.0 / (emb + 5)) ** 0.5
        ).to(dev)
        t2.meta = {"model_kwargs": {"head_type": "angle"}}
        step_kw = dict(loss_fn=make_angle_loss(),
                       model_kwargs={"head_type": "angle"})

    def batch(n):
        x = torch.randint(0, 256, (n, *shape), generator=gen,
                          dtype=torch.int32 if len(shape) == 1
                          else torch.uint8).to(dev)
        y = torch.randint(0, 5, (n,), generator=gen).to(dev)
        return x, y, draw_fn(n, gen)

    batches = [batch(timing_batches[0]) for _ in range(TRAIN_STEPS)]

    hyper = ({"lr": EXPERIMENT_PRESETS["finegrained"]["lr"]}
             if state.arch == "resnet50" else {})

    def stepper(kernels, dtype=torch.bfloat16):
        return _stepper(torch, base, model_fn, augment, dev, TrainConfig(
            compute_dtype=dtype, **hyper,
            **(KERNEL_FLAGS[state.arch] if kernels else {})), **step_kw)

    runs = {}
    launched = None
    for label, kernels, dtype in (("f32", False, torch.float32),
                                  ("default", False, torch.bfloat16),
                                  ("kernels", True, torch.bfloat16),
                                  ("kernels_f32", True, torch.float32)):
        st, run = stepper(kernels, dtype)
        losses, first = [], None
        for i, (x, y, draws) in enumerate(batches):
            if label == "kernels" and i == 0:
                torch.cuda.synchronize()
                counts.reset()
            m = run(x, y, draws, i)
            losses.append(float(m["loss"]))
            if label == "kernels" and i == 0:
                torch.cuda.synchronize()
                launched = counts.read()
            if i == 0:
                first = _train_tensors(st, lambda t: t.clone())
        runs[label] = (st, losses, first)

    init = _train_tensors(base, lambda t: t)
    # label -> group -> ||update - f32 update||
    dist, ref_norm = _update_dists(torch, init, {k: v[2]
                                                 for k, v in runs.items()})
    ld, lk, l32, lk32 = (runs[k][1] for k in ("default", "kernels", "f32",
                                              "kernels_f32"))
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(ld, lk))
    f32_loss_rel = max(abs(a - b) / abs(a) for a, b in zip(l32, lk32))
    stats = dict(losses_f32=l32, losses_default=ld, losses_kernels=lk,
                 losses_kernels_f32=lk32, loss_max_rel=loss_rel,
                 f32_loss_max_rel=f32_loss_rel, update_dist_to_f32=dist,
                 f32_update_norm=ref_norm, free_entries=n_free)
    if not all(np.isfinite(ld + lk + l32 + lk32)):
        raise AssertionError(f"train: non-finite losses {ld} {lk} {l32} "
                             f"{lk32}")
    if loss_rel > LOSS_RTOL:
        raise AssertionError(f"train: losses {lk} vs default {ld}")
    for group, d in dist["kernels"].items():
        if d > UPDATE_RATIO * dist["default"][group] + 1e-6 * ref_norm[group]:
            raise AssertionError(
                f"train: the kernel step's {group} update is {d} from the f32 "
                f"step's, the default step's {dist['default'][group]}")
    for group in ("shared", "private"):
        d = dist["kernels_f32"][group]
        if d > F32_UPDATE_RTOL * ref_norm[group]:
            raise AssertionError(
                f"train: the f32 kernel step's {group} update is {d} from "
                f"the f32 default step's, of norm {ref_norm[group]}")
    for label, (st, _, _) in runs.items():
        _no_forgetting(torch, base, st, f"train {label}")
    expected = TRAIN_LAUNCHES[state.arch]
    for k, n in launched.items():
        if n != expected.get(k, 0):
            raise AssertionError(f"train {state.arch}: {k} launched {n} times "
                                 f"in one step, expected {expected.get(k, 0)}")

    # ms/step by host clock around steps that end in a synchronize; the two
    # steps in turns (default, kernels, kernels, default), round_steps a
    # round
    timing = {}
    for n in timing_batches:
        torch.cuda.reset_peak_memory_stats()
        x, y, draws = batch(n)
        steppers = {"default": stepper(False)[1], "kernels": stepper(True)[1]}
        rounds = {"default": [], "kernels": []}
        for label in ("default", "kernels", "kernels", "default"):
            run = steppers[label]
            for i in range(2):
                run(x, y, draws, i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(round_steps):
                run(x, y, draws, i)
            torch.cuda.synchronize()
            rounds[label].append((time.perf_counter() - t) / round_steps
                                 * 1e3)
        for label, ms in rounds.items():
            mean = sum(ms) / len(ms)
            timing[f"{label}_b{n}"] = {"ms_per_step": mean,
                                       "img_per_s": n / mean * 1e3,
                                       "rounds_ms": ms}
            if n == timing_batches[0]:  # the profiler's device ms a step
                timing[f"{label}_b{n}"]["device_ms"] = device_ms(
                    lambda run=steppers[label]: run(x, y, draws, 0), iters=5,
                    warmup=1)
        timing[f"peak_gib_b{n}"] = torch.cuda.max_memory_allocated() / 2**30
    # the kernel step's roofline at the compared batch: FLOPs counted on one
    # default step (the kernels' ctypes launches are invisible to the
    # counter; the default step does the same products)
    n = timing_batches[0]
    x, y, draws = batch(n)
    cost = cost_of(stepper(False)[1], x, y, draws, 0)
    line = roofline(timing[f"kernels_b{n}"]["ms_per_step"], cost)
    timing[f"roofline_kernels_b{n}"] = line
    return dict(stats, timing=timing), launched


# vit_cifar's fused q|k|v product (`TrainConfig.qkv_fused`): three default
# steps with flash attention, fused and not, against the f32 default step
QKV_STEPS, QKV_ROUND_STEPS = 3, 10
QKV_LAUNCHES = {"flash_fwd": 6, "flash_bwd": 6}


def qkv_phase(torch, dev, state, counts):
    """Task 2's default bf16 step of vit_cifar with `flash_attention`, with
    `qkv_fused=True` and without, three steps each from one state on the
    same batches: losses within LOSS_RTOL, and the one-step update rule of
    the train phases (per group, the fused step's update at most
    UPDATE_RATIO times as far from the f32 default step's as the unfused
    step's); the fused step launches exactly the flash kernels
    (QKV_LAUNCHES) and no dense-route kernel; ms/step of both at batch 256
    in turns (unfused, fused, fused, unfused)."""
    from cpg_tpu_torch.models import get_model
    from cpg_tpu_torch.train.step import TrainConfig

    model_fn, _ = get_model(state.arch)
    shape, _, augment, draw_fn, n = _arch_io(state.arch)
    gen = torch.Generator().manual_seed(SEED + 17)
    batches = [(torch.randint(0, 256, (n, *shape), generator=gen,
                              dtype=torch.uint8).to(dev),
                torch.randint(0, 5, (n,), generator=gen).to(dev),
                draw_fn(n, gen)) for _ in range(QKV_STEPS)]
    cfgs = {"f32": TrainConfig(compute_dtype=torch.float32),
            "unfused": TrainConfig(flash_attention=True),
            "fused": TrainConfig(flash_attention=True, qkv_fused=True)}
    runs, firsts, launched = {}, {}, None
    for label, cfg in cfgs.items():
        st, run = _stepper(torch, state, model_fn, augment, dev, cfg)
        losses = []
        for i, (x, y, draws) in enumerate(batches):
            if label == "fused" and i == 0:
                torch.cuda.synchronize()
                counts.reset()
            losses.append(float(run(x, y, draws, i)["loss"]))
            if label == "fused" and i == 0:
                torch.cuda.synchronize()
                launched = counts.read()
            if i == 0:
                firsts[label] = _train_tensors(st, lambda t: t.clone())
        runs[label] = losses
    if not all(np.isfinite(runs["fused"] + runs["unfused"])):
        raise AssertionError(f"qkv_fused: non-finite losses {runs}")
    loss_rel = max(abs(a - b) / abs(a)
                   for a, b in zip(runs["unfused"], runs["fused"]))
    if loss_rel > LOSS_RTOL:
        raise AssertionError(f"qkv_fused: losses {runs['fused']} vs unfused "
                             f"{runs['unfused']}")
    dist, ref_norm = _update_dists(torch, _train_tensors(state, lambda t: t),
                                   firsts)
    for group, d in dist["fused"].items():
        if d > UPDATE_RATIO * dist["unfused"][group] + 1e-6 * ref_norm[group]:
            raise AssertionError(
                f"qkv_fused: the fused step's {group} update is {d} from the "
                f"f32 step's, the unfused step's {dist['unfused'][group]}")
    if any(v != QKV_LAUNCHES.get(k, 0) for k, v in launched.items()):
        raise AssertionError(f"qkv_fused: launches {launched}, expected "
                             f"{QKV_LAUNCHES}")
    x, y, draws = batches[0]
    steppers = {k: _stepper(torch, state, model_fn, augment, dev, cfgs[k])[1]
                for k in ("unfused", "fused")}
    rounds = {"unfused": [], "fused": []}
    for label in ("unfused", "fused", "fused", "unfused"):
        run = steppers[label]
        for i in range(2):
            run(x, y, draws, i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(QKV_ROUND_STEPS):
            run(x, y, draws, i)
        torch.cuda.synchronize()
        rounds[label].append((time.perf_counter() - t) / QKV_ROUND_STEPS
                             * 1e3)
    timing = {f"{k}_b{n}": {"ms_per_step": sum(v) / len(v), "rounds_ms": v}
              for k, v in rounds.items()}
    return dict(losses=runs, loss_max_rel=loss_rel, update_dist_to_f32=dist,
                f32_update_norm=ref_norm, timing=timing), launched


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


# --------------------------------------------------------- finegrained ----

# The fine-grained cycle from the CLI: two synthetic fine-grained tasks of 5
# classes (8 training images a class) on top of an adopted ResNet-50 task 1,
# at width 1.0 and 224 px, one epoch a phase, the second task grown once to
# 1.5 under an unreachable goal; its checkpoints inside the checkout
FG_DIR = os.path.join("build", "smoke_finegrained")
FG_TASKS = ("cubs_cropped", "stanford_cars_cropped")
FG_MULT = 1.0


def finegrained_phase(torch, dev, counts, card):
    """`python -m cpg_tpu_torch sequence --experiment finegrained` through
    cli.main with --pretrained-npz (a torchvision-keyed npz written from a
    seeded ResNet-50), --max-classes 5, --num-tasks 2 and both kernel
    flags, then: check_state at every task boundary; task 1's logits right
    after adoption equal to the converted weights' forward, bit for bit;
    the growth audit within its bound; a second run that resumes every
    task and gives the same state bit for bit; `export` bf16 and int8
    (calibrated), `serve` on both at bucket 64 (p50, img/s), every int8
    product of a forward bit-equal to `int8.int_mm_plain`; `export-torch`
    -> `import-torch` bit for bit. Returns the results and the launches of
    the first run."""
    from cpg_tpu_torch.core.invariants import check_state
    from cpg_tpu_torch.data.augment import imagenet_eval_preprocess as prep
    from cpg_tpu_torch.inference import predict
    from cpg_tpu_torch.models import framework as fw
    from cpg_tpu_torch.models import get_model
    from cpg_tpu_torch.ops import int8
    from cpg_tpu_torch.serve import TaskServer
    from cpg_tpu_torch.train import pretrained
    from cpg_tpu_torch.train import sequence as seq_mod
    from cpg_tpu_torch.train.export_torch import torch_resnet50_state_dict
    from cpg_tpu_torch.train.manager import Manager
    from cpg_tpu_torch.utils.checkpoint import load_state

    shutil.rmtree(FG_DIR, ignore_errors=True)
    os.makedirs(FG_DIR)
    out = {}
    try:
        model_fn, _ = get_model("resnet50")
        sd = torch_resnet50_state_dict(*fw.init(
            torch.Generator().manual_seed(SEED + 13), model_fn,
            torch.zeros((1, 224, 224, 3)), num_classes=1000, mult=FG_MULT))
        npz = os.path.join(FG_DIR, "pretrained.npz")
        np.savez(npz, **sd)
        goals = os.path.join(FG_DIR, "goals.json")
        with open(goals, "w") as f:
            json.dump({FG_TASKS[1]: 1.01}, f)
        ck = os.path.join(FG_DIR, "ck")
        argv = ["sequence", "--experiment", "finegrained", "--num-tasks", "2",
                "--max-classes", "5", "--use-pallas-conv", "--fused-chain",
                "--finetune-epochs", "1", "--prune-epochs", "1",
                "--retrain-epochs", "1", "--prune-ratios", "0.5",
                "--batch-size", str(RESNET_BATCH), "--pretrained-npz", npz,
                "--goals-file", goals, "--growth-step", str(FG_MULT / 2),
                "--network_width_multiplier", str(FG_MULT),
                "--max_allowed_network_width_multiplier", str(FG_MULT * 1.5),
                "--checkpoint-dir", ck,
                "--jsonl", os.path.join(FG_DIR, "phases.jsonl")]
        runs = []
        orig_run = seq_mod.run_sequence

        def recorded(*a, **k):
            runs.append(orig_run(*a, **k))
            return runs[-1]

        keep = seq_mod.remove_after_save
        seq_mod.run_sequence = recorded
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
            rc, summary = _cli(argv)
            torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t0
            launched = counts.read()
            for u in undo:
                u()
            undo = []
            trained = []
            orig_train = Manager.train
            Manager.train = lambda *a, **k: trained.append(1)
            try:
                rc2, _ = _cli(argv)
            finally:
                Manager.train = orig_train
        finally:
            seq_mod.run_sequence = orig_run
            seq_mod.remove_after_save = keep
            for u in undo:
                u()
        state, reports = runs[0]
        if rc != 0 or rc2 != 0 or [t["grew"] for t in summary["tasks"]] \
                != [0, 1] or summary["final_width_mult"] != FG_MULT * 1.5:
            raise AssertionError(f"finegrained: sequence {rc} {summary}")
        if trained or not _same_state(torch, runs[1][0], state):
            raise AssertionError("finegrained: resume did not reproduce the "
                                 "state")
        out["summary"] = summary
        with open(os.path.join(FG_DIR, "phases.jsonl")) as f:
            out["phases"] = [json.loads(line) for line in f]
        for ph in out["phases"]:
            ph["ms_per_step"] = ph["seconds"] / max(ph["steps"], 1) * 1e3
        loops = sum(ph["seconds"] for ph in out["phases"])
        out["wall_split_s"] = dict(
            train_loops_s=loops, **spent,
            other_s=out["wall_s"] - loops - sum(spent.values()))

        def ckpt(tid, suffix=""):
            return load_state(os.path.join(
                ck, f"task{tid:02d}_{FG_TASKS[tid - 2]}{suffix}"), device=dev)

        audits = {}
        for label, st in (("task2.pick", ckpt(2, ".pick")),
                          ("task2", ckpt(2)), ("task3.pick", ckpt(3, ".pick")),
                          ("task3", ckpt(3)), ("final", state)):
            audits[label] = check_state(st)  # raises on a violation
        out["check_state"] = audits
        audit = reports[1].growth_audit
        if not audit or any(a["max_abs_diff"] > a["bound"] for a in audit):
            raise AssertionError(f"finegrained: growth audit {audit}")
        out["growth_audit"] = audit

        # task 1 right after adoption (task 2's pick checkpoint, before any
        # growth) against the converted weights' forward
        shared, private, bn = pretrained.convert_torch_resnet50(sd)
        px = prep(torch.from_numpy(np.random.RandomState(SEED + 14).randint(
            0, 256, (16, 224, 224, 3)).astype(np.uint8)).to(dev))
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            want, _ = fw.apply(
                model_fn, *({k: torch.from_numpy(np.ascontiguousarray(v))
                             .to(dev) for k, v in tree.items()}
                            for tree in (shared, private, bn)),
                px, train=False, num_classes=1000, mult=FG_MULT)
            got = predict(ckpt(2, ".pick"), 1, px, device=dev)
        finally:
            torch.backends.cudnn.deterministic = det
        out["adopted_task1_max_abs_diff"] = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError("finegrained: adopted task 1's logits differ "
                                 "from the converted weights' forward by "
                                 f"{out['adopted_task1_max_abs_diff']}")

        # export bf16 and calibrated int8, serve both at bucket 64
        final = os.path.join(ck, f"task03_{FG_TASKS[1]}")
        rng = np.random.RandomState(SEED + 15)
        cal = os.path.join(FG_DIR, "calib.npz")
        np.savez(cal, x=rng.randint(0, 256, (32, 224, 224, 3))
                 .astype(np.uint8))
        x = rng.randint(0, 256, (64, 224, 224, 3)).astype(np.uint8)
        req = os.path.join(FG_DIR, "req.npz")
        np.savez(req, x=x)
        served = {}
        for q, flags in (("bf16", []), ("int8", ["--int8", "--calibrate",
                                                 cal])):
            art = os.path.join(FG_DIR, f"art_{q}")
            rc, rep = _cli(["export", "--checkpoint", final, "--out", art,
                            "--experiment", "finegrained", *flags])
            if rc != 0 or rep["calibrated_tasks"] != (3 if q == "int8"
                                                      else 0):
                raise AssertionError(f"finegrained: export {q} {rc} {rep}")
            res = os.path.join(FG_DIR, f"out_{q}.npz")
            rc, rep = _cli(["serve", "--artifact", art, "--requests", req,
                            "--task-id", "3", "--out", res, "--experiment",
                            "finegrained"]
                           + (["--fused-chain"] if q == "bf16" else []))
            if rc != 0 or rep["n"] != 64:
                raise AssertionError(f"finegrained: serve {q} {rc} {rep}")
            with np.load(res) as z:
                served[q] = z["logits"]
            srv = TaskServer.load(art, prep, fused_chain=q == "bf16",
                                  device=dev)
            out[f"serve_{q}_b64"] = _serve_latency(srv, x, reps=10)
            if q == "int8":
                with _Int8Calls() as rec:
                    srv.predict(3, x)
                rows = int8_route_rows(torch, rec.calls, "resnet50")
                del rec
                if sum(r["count"] for r in rows) != 53:
                    raise AssertionError("finegrained: an int8 forward ran "
                                         f"{sum(r['count'] for r in rows)} "
                                         "products, want 53")
                out["int8_route"] = _route_totals(rows)
                out["int8_route_rows"] = rows
            del srv
        out["int8_vs_bf16"] = dict(zip(("max_abs_diff", "argmax_agree"),
                                       _int8_bound(torch, served["int8"],
                                                   served["bf16"],
                                                   "finegrained: int8 vs bf16")))

        # export-torch -> import-torch
        pth = os.path.join(FG_DIR, "ref.pth")
        back = os.path.join(FG_DIR, "back")
        rc, rep = _cli(["export-torch", "--ckpt", final, "--out", pth])
        rc2, rep2 = _cli(["import-torch", "--ckpt", pth, "--arch", "resnet50",
                          "--out", back])
        a, b = load_state(final, device=dev), load_state(back, device=dev)
        for tid in b.tasks:
            b.tasks[tid].meta = a.tasks[tid].meta
        if rc or rc2 or not _same_state(torch, a, b):
            raise AssertionError("finegrained: export-torch -> import-torch "
                                 "changed the state")
        out["torch_round_trip_bit_equal"] = True
        print("finegrained resnet50: " + json.dumps(
            {k: v for k, v in out.items() if k != "int8_route_rows"})
            + f" on {card}", flush=True)
    finally:
        shutil.rmtree(FG_DIR, ignore_errors=True)
    return out, launched


# ------------------------------------------------------------ stream ----

# The data path of datasets larger than RAM: the finegrained CLI cycle over
# two memmapped synthetic tasks (STREAM_CLASSES classes, 8 training images
# a class: 5 steps an epoch, so each epoch's prefetcher writes some staging
# pairs again) with the C++ loader and the device prefetcher, ResNet-50 at
# width 1.0, 224 px, batch 32 with the finegrained phase's kernel flags,
# one epoch a phase, no growth; the prefetcher alone over STREAM_RACE_N
# loader batches with its side stream held STREAM_RACE_CYCLES clock cycles
# before each copy; then the loader alone and the loop's ms/step over a
# larger memmapped task (STREAM_TIMING_N images, STREAM_TIMING_N / 32 steps
# an epoch) in three arms, in turns
STREAM_DIR = os.path.join("build", "smoke_stream")
STREAM_MULT = 1.0
STREAM_CLASSES = 20
STREAM_RACE_N = 12
STREAM_RACE_CYCLES = 100_000_000  # ~50 ms at the H100's clock, several
# times the host's time to gather and stage a batch of 4.8 MB
STREAM_TIMING_N = 384
STREAM_LOADER_BATCHES = 200
STREAM_ARMS = ("native_prefetch", "numpy_prefetch", "numpy_no_prefetch")


def _stream_argv(extra):
    return ["sequence", "--experiment", "finegrained", "--num-tasks", "2",
            "--max-classes", str(STREAM_CLASSES), "--use-pallas-conv",
            "--fused-chain",
            "--finetune-epochs", "1", "--prune-epochs", "1",
            "--retrain-epochs", "1", "--prune-ratios", "0.5",
            "--batch-size", str(RESNET_BATCH), "--network_width_multiplier",
            str(STREAM_MULT), "--seed", str(SEED), *extra]


def _recorded_runs(seq_mod, argv):
    """(exit code, summary, final state) of a CLI run, with run_sequence
    wrapped to keep its result."""
    runs = []
    orig = seq_mod.run_sequence

    def recorded(*a, **k):
        runs.append(orig(*a, **k))
        return runs[-1]

    seq_mod.run_sequence = recorded
    try:
        rc, summary = _cli(argv)
    finally:
        seq_mod.run_sequence = orig
    return rc, summary, runs[0][0]


def _prefetched(torch, dev, x, y, seed, depth, skip_waits=False):
    """The STREAM_RACE_N batches of a fresh `NativeBatcher` over (x, y) at
    batch 32 as a `DevicePrefetcher` at `depth` hands them to the consuming
    stream, cloned there, with the prefetcher's side stream held
    STREAM_RACE_CYCLES clock cycles before each copy: a staging pair
    written again before its copy ran would hand over another batch's
    rows. `skip_waits` drops the pairs' events before each write, the
    control that shows such a race is caught. Returns (the clones, the
    prefetcher's rewrites)."""
    from cpg_tpu_torch.data.native_loader import NativeBatcher
    from cpg_tpu_torch.data.stream import DevicePrefetcher

    nb = NativeBatcher(x, y, RESNET_BATCH, seed=seed)
    pf = None

    def held_back():
        for xy in nb.batches(STREAM_RACE_N):
            with torch.cuda.stream(pf._stream):
                torch.cuda._sleep(STREAM_RACE_CYCLES)
            if skip_waits:
                for slot in pf._slots:
                    slot.done = None
            yield xy

    pf = DevicePrefetcher(held_back(), dev, depth=depth)
    got = [(bx.clone(), by.clone()) for bx, by in pf]
    torch.cuda.synchronize()
    nb.close()
    return got, pf.rewrites


def prefetch_race_check(torch, dev, x, y, seed):
    """The prefetcher at depths 1-3 against a fresh loader's host batches:
    byte-equal with every expected pair written again; the control (waits
    skipped) must differ somewhere."""
    from cpg_tpu_torch.data.native_loader import NativeBatcher

    ref = NativeBatcher(x, y, RESNET_BATCH, seed=seed)
    host = [ref.next() for _ in range(STREAM_RACE_N)]
    ref.close()

    def differing(got):
        return [i for i, ((bx, by), (hx, hy)) in enumerate(zip(got, host))
                if not (np.array_equal(bx.cpu().numpy(), hx)
                        and np.array_equal(by.cpu().numpy(), hy))]

    out = {}
    for depth in (1, 2, 3):
        got, rewrites = _prefetched(torch, dev, x, y, seed, depth)
        bad = differing(got)
        want = STREAM_RACE_N - (depth + 1)
        if len(got) != STREAM_RACE_N or bad or rewrites != want:
            raise AssertionError(
                f"stream: prefetcher at depth {depth}: {len(got)} batches, "
                f"{bad} differ from the loader's, {rewrites} pairs written "
                f"again (expected {want})")
        ctl, _ = _prefetched(torch, dev, x, y, seed, depth, skip_waits=True)
        caught = differing(ctl)
        if not caught:
            raise AssertionError(
                f"stream: prefetcher at depth {depth} with its waits skipped "
                "gave every batch right: the check cannot see a race")
        out[f"depth{depth}"] = {"batches_byte_equal": len(got),
                                "pairs_written_again": rewrites,
                                "control_batches_differing": len(caught)}
    return out


def stream_phase(torch, dev, counts, card):
    """`sequence --experiment finegrained --memmap-dir D --native-loader`
    through cli.main, the tasks written by `save_memmap_dataset`; then:
    check_state at every task boundary (its `.pick` and final
    checkpoints); every batch the prefetched native run handed to the step
    on the card equal, byte for byte, to the host batch of a fresh
    `NativeBatcher` with the same seed, with some staging pair written
    again (a pair written before its copy read it would show here);
    `prefetch_race_check`; a `--memmap-dir` run without the loader ending
    in the state of the in-memory run on the same arrays and seed, bit for
    bit; the loader's batches/s alone at batch 32, and the loop's ms/step
    in STREAM_ARMS (recorded, no claim). Returns the results and the
    launches of the first run."""
    from cpg_tpu_torch.core.invariants import check_state
    from cpg_tpu_torch.data.augment import imagenet_train_augment
    from cpg_tpu_torch.data.finegrained import (FINEGRAINED_SPECS,
                                                finegrained_task,
                                                synthetic_imagefolder)
    from cpg_tpu_torch.data.native_loader import NativeBatcher
    from cpg_tpu_torch.data.stream import (load_memmap_dataset,
                                           save_memmap_dataset)
    from cpg_tpu_torch.models import get_model
    from cpg_tpu_torch.train import manager as mgr_mod
    from cpg_tpu_torch.train import sequence as seq_mod
    from cpg_tpu_torch.train.manager import Manager
    from cpg_tpu_torch.train.sequence import init_state, start_task
    from cpg_tpu_torch.train.step import TrainConfig
    from cpg_tpu_torch.utils.checkpoint import load_state

    shutil.rmtree(STREAM_DIR, ignore_errors=True)
    mm = os.path.join(STREAM_DIR, "tasks")
    out = {}
    try:
        names = list(FINEGRAINED_SPECS)[:2]
        for i, name in enumerate(names):
            save_memmap_dataset(os.path.join(mm, name), finegrained_task(
                name, max_classes=STREAM_CLASSES, seed=i))
        ck = os.path.join(STREAM_DIR, "ck")
        # the native run, every batch its steps receive kept on the card
        # and every prefetcher kept
        seen, prefetchers = [], []
        orig_init = Manager.__init__
        prefetcher = mgr_mod.DevicePrefetcher

        def recording_prefetcher(it, device):
            prefetchers.append(prefetcher(it, device))
            return prefetchers[-1]

        def recording_init(self, *a, **k):
            orig_init(self, *a, **k)
            step, kept = self.train_step, []
            seen.append((self._batcher, kept))

            def step_and_keep(*args):
                kept.append((torch.as_tensor(args[8]).clone(),
                             torch.as_tensor(args[9]).clone()))
                return step(*args)
            self.train_step = step_and_keep

        keep = seq_mod.remove_after_save
        Manager.__init__ = recording_init
        mgr_mod.DevicePrefetcher = recording_prefetcher
        seq_mod.remove_after_save = lambda path: None
        try:
            torch.cuda.synchronize()
            counts.reset()
            t0 = time.perf_counter()
            rc, summary, native = _recorded_runs(seq_mod, _stream_argv(
                ["--memmap-dir", mm, "--native-loader", "--checkpoint-dir",
                 ck]))
            torch.cuda.synchronize()
            out["native_wall_s"] = time.perf_counter() - t0
            launched = counts.read()
        finally:
            Manager.__init__ = orig_init
            mgr_mod.DevicePrefetcher = prefetcher
            seq_mod.remove_after_save = keep
        if rc != 0 or [t["name"] for t in summary["tasks"]] != names:
            raise AssertionError(f"stream: sequence {rc} {summary}")
        out["summary"] = summary
        audits = {}
        for tid, name in enumerate(names, 1):
            for suffix in (".pick", ""):
                label = f"task{tid}{suffix}"
                audits[label] = check_state(load_state(os.path.join(
                    ck, f"task{tid:02d}_{name}{suffix}"), device=dev))
        audits["final"] = check_state(native)
        out["check_state"] = audits
        n_batches = 0
        for batcher, kept in seen:
            if batcher is None:
                raise AssertionError("stream: a Manager of the native run "
                                     "has no C++ loader")
            fresh = NativeBatcher(batcher.x, batcher.y, batcher.batch_size,
                                  seed=batcher.seed)
            for i, (x, y) in enumerate(kept):
                hx, hy = fresh.next()
                if not (np.array_equal(x.cpu().numpy(), hx)
                        and np.array_equal(y.cpu().numpy(), hy)):
                    raise AssertionError(
                        f"stream: batch {i} on the card differs from the "
                        "loader's host batch")
                n_batches += 1
            fresh.close()
        out["batches_byte_equal"] = n_batches
        out["prefetchers"] = len(prefetchers)
        out["pairs_written_again"] = sum(p.rewrites for p in prefetchers)
        if not out["pairs_written_again"]:
            raise AssertionError("stream: no staging pair of the native run "
                                 "was written again, so none was checked")
        del seen, native, prefetchers
        torch.cuda.empty_cache()

        # the memmap run without the loader against the in-memory run
        t0 = time.perf_counter()
        rc1, s1, from_map = _recorded_runs(seq_mod, _stream_argv(
            ["--memmap-dir", mm]))
        out["memmap_wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc2, s2, in_memory = _recorded_runs(seq_mod, _stream_argv([]))
        out["in_memory_wall_s"] = time.perf_counter() - t0
        if rc1 or rc2 or s1 != s2 or not _same_state(torch, from_map,
                                                      in_memory):
            raise AssertionError("stream: the --memmap-dir run differs from "
                                 f"the in-memory run ({s1} vs {s2})")
        out["memmap_bit_equal_to_in_memory"] = True
        del from_map, in_memory
        torch.cuda.empty_cache()

        # the loader alone, then the loop's ms/step both ways
        tx, ty, vx, vy = synthetic_imagefolder(
            STREAM_TIMING_N // 8, n_train_per=8, n_test_per=1, seed=SEED + 20)
        big = os.path.join(STREAM_DIR, "timing")
        save_memmap_dataset(big, {"train_x": tx, "train_y": ty,
                                  "test_x": vx, "test_y": vy,
                                  "num_classes": STREAM_TIMING_N // 8})
        data = load_memmap_dataset(big)
        out["prefetch_race"] = prefetch_race_check(
            torch, dev, data["train_x"], data["train_y"], SEED)
        nb = NativeBatcher(data["train_x"], data["train_y"], RESNET_BATCH,
                           seed=SEED)
        nb.next()
        t = time.perf_counter()
        for _ in range(STREAM_LOADER_BATCHES):
            nb.next()
        out["loader_batches_per_s"] = STREAM_LOADER_BATCHES / (
            time.perf_counter() - t)
        nb.close()
        gen = torch.Generator().manual_seed(SEED + 21)
        st = init_state("resnet50", gen, width_mult=STREAM_MULT, device=dev)
        start_task(st, "timing", data["num_classes"], gen)
        model_fn, _ = get_model("resnet50")
        cfg = TrainConfig(**KERNEL_FLAGS["resnet50"])
        managers = {
            label: Manager(st, model_fn, 1, data, cfg,
                           batch_size=RESNET_BATCH,
                           augment_fn=imagenet_train_augment, seed=SEED,
                           native_loader=label.startswith("native"),
                           device=dev)
            for label in STREAM_ARMS}
        rounds = {k: [] for k in managers}
        for label in (*STREAM_ARMS, *STREAM_ARMS[::-1], *STREAM_ARMS,
                      *STREAM_ARMS[::-1]):
            if label == "numpy_no_prefetch":  # pageable copies in the step
                mgr_mod.DevicePrefetcher = lambda it, device: it
            try:
                res = managers[label].train(1, base_lr=1e-3)
            finally:
                mgr_mod.DevicePrefetcher = prefetcher
            rounds[label].append(res.seconds / res.steps * 1e3)
        # the first round of each warms its path up
        out["loop_ms_per_step_b32"] = {
            k: {"ms_per_step": sum(v[1:]) / len(v[1:]), "rounds_ms": v}
            for k, v in rounds.items()}
        print("stream resnet50: " + json.dumps(out) + f" on {card}",
              flush=True)
    finally:
        shutil.rmtree(STREAM_DIR, ignore_errors=True)
    return out, launched


FACE_DIR = os.path.join("build", "smoke_face")
FACE_BATCH = 128
FACE_MULT = 1.0


def _embeddings(torch, st, x, dev):
    """Task 1's embedding (head_type 'none') and AngleLinear outputs of a
    state on x, with cuDNN deterministic."""
    from cpg_tpu_torch.data.augment import face_eval_preprocess as prep
    from cpg_tpu_torch.inference import predict

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        emb = predict(st, 1, x, prep, device=dev,
                      model_kwargs={"head_type": "none"})
        return [emb, *predict(st, 1, x, prep, device=dev)]
    finally:
        torch.backends.cudnn.deterministic = det


def face_phase(torch, dev, counts, card):
    """`python -m cpg_tpu_torch sequence --experiment face` through cli.main
    at full width (the synthetic CASIA identities under the A-Softmax loss,
    then the expression task with its linear head, which misses the
    unreachable goal 1.01 and grows once to 1.5) with both kernel flags
    (`--use-pallas-conv --use-pallas`), then: the summary's LFW
    verification present and finite; check_state at every task boundary;
    task 1's embedding and AngleLinear outputs bit-equal across task 2's
    compaction (its `.pick` checkpoint against the final one), and across
    the growth within the growth audit's bound (max|diff| and bit equality
    reported); the growth audit; a second run that resumes every task and
    gives the same state bit for bit; `export` bf16 and int8 (calibrated),
    `serve` on both at bucket 64 (p50, img/s), every int8 product of a
    forward bit-equal to `int8.int_mm_plain`; `export-torch` ->
    `import-torch --arch spherenet20` bit for bit. Returns the results and
    the launches of the first run."""
    from cpg_tpu_torch.core.invariants import check_state
    from cpg_tpu_torch.data.augment import face_eval_preprocess as prep
    from cpg_tpu_torch.serve import TaskServer
    from cpg_tpu_torch.train import sequence as seq_mod
    from cpg_tpu_torch.train.manager import Manager
    from cpg_tpu_torch.utils.checkpoint import load_state

    shutil.rmtree(FACE_DIR, ignore_errors=True)
    os.makedirs(FACE_DIR)
    out = {}
    try:
        goals = os.path.join(FACE_DIR, "goals.json")
        with open(goals, "w") as f:
            json.dump({"expressions": 1.01}, f)
        ck = os.path.join(FACE_DIR, "ck")
        argv = ["sequence", "--experiment", "face", "--num-tasks", "2",
                "--use-pallas-conv", "--use-pallas",
                "--finetune-epochs", "1", "--prune-epochs", "1",
                "--retrain-epochs", "1", "--prune-ratios", "0.5",
                "--batch-size", str(FACE_BATCH), "--goals-file", goals,
                "--network_width_multiplier", str(FACE_MULT),
                "--growth-step", str(FACE_MULT / 2),
                "--max_allowed_network_width_multiplier", str(FACE_MULT * 1.5),
                "--checkpoint-dir", ck,
                "--jsonl", os.path.join(FACE_DIR, "phases.jsonl")]
        runs = []
        orig_run = seq_mod.run_sequence

        def recorded(*a, **k):
            runs.append(orig_run(*a, **k))
            return runs[-1]

        keep = seq_mod.remove_after_save
        seq_mod.run_sequence = recorded
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
            rc, summary = _cli(argv)
            torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t0
            launched = counts.read()
            for u in undo:
                u()
            undo = []
            trained = []
            orig_train = Manager.train
            Manager.train = lambda *a, **k: trained.append(1)
            try:
                rc2, summary2 = _cli(argv)
            finally:
                Manager.train = orig_train
        finally:
            seq_mod.run_sequence = orig_run
            seq_mod.remove_after_save = keep
            for u in undo:
                u()
        state, reports = runs[0]
        if rc != 0 or rc2 != 0 or [t["grew"] for t in summary["tasks"]] \
                != [0, 1] or summary["final_width_mult"] != FACE_MULT * 1.5:
            raise AssertionError(f"face: sequence {rc} {summary}")
        lfw = summary.get("lfw_verification") or {}
        if not (np.isfinite(lfw.get("acc", np.nan))
                and np.isfinite(lfw.get("std", np.nan))
                and lfw.get("n_pairs") == 200):
            raise AssertionError(f"face: lfw_verification {lfw}")
        if trained or not _same_state(torch, runs[1][0], state):
            raise AssertionError("face: resume did not reproduce the state")
        out["summary"] = summary
        out["resumed_summary_equal"] = summary2 == summary
        with open(os.path.join(FACE_DIR, "phases.jsonl")) as f:
            out["phases"] = [json.loads(line) for line in f]
        for ph in out["phases"]:
            ph["ms_per_step"] = ph["seconds"] / max(ph["steps"], 1) * 1e3
        loops = sum(ph["seconds"] for ph in out["phases"])
        out["wall_split_s"] = dict(
            train_loops_s=loops, **spent,
            other_s=out["wall_s"] - loops - sum(spent.values()))

        names = {1: "task01_casia", 2: "task02_expressions"}

        def ckpt(tid, suffix=""):
            return load_state(os.path.join(ck, names[tid] + suffix),
                              device=dev)

        audits = {}
        for label, st in (("task1.pick", ckpt(1, ".pick")),
                          ("task1", ckpt(1)), ("task2.pick", ckpt(2, ".pick")),
                          ("task2", ckpt(2)), ("final", state)):
            audits[label] = check_state(st)  # raises on a violation
        out["check_state"] = audits
        audit = reports[1].growth_audit
        if not audit or any(a["max_abs_diff"] > a["bound"] for a in audit):
            raise AssertionError(f"face: growth audit {audit}")
        out["growth_audit"] = audit

        # task 1 across task 2's compaction (bit for bit) and its growth
        x = torch.from_numpy(np.random.RandomState(SEED + 17).randint(
            0, 256, (16, 112, 96, 3)).astype(np.uint8)).to(dev)
        before, picked, final_st = (_embeddings(torch, st, x, dev) for st in
                                    (ckpt(1), ckpt(2, ".pick"), ckpt(2)))
        for u, v in zip(picked, final_st):
            if not torch.equal(u, v):
                raise AssertionError("face: task 1's outputs moved across "
                                     "task 2's compaction")
        n = before[0].shape[-1]
        grow_diff = max(float((v[..., :n] - u).abs().max())
                        for u, v in zip(before, picked))
        bound = max(a["bound"] for a in audit)
        if grow_diff > bound or bool(picked[0][..., n:].any()):
            raise AssertionError(f"face: task 1's outputs moved by "
                                 f"{grow_diff} across the growth")
        out["task1_across_growth"] = {
            "max_abs_diff": grow_diff, "bound": bound,
            "bit_equal": all(torch.equal(v[..., :n], u)
                             for u, v in zip(before, picked))}

        # export bf16 and calibrated int8, serve both at bucket 64
        final = os.path.join(ck, names[2])
        rng = np.random.RandomState(SEED + 18)
        cal = os.path.join(FACE_DIR, "calib.npz")
        np.savez(cal, x=rng.randint(0, 256, (64, 112, 96, 3))
                 .astype(np.uint8))
        xq = rng.randint(0, 256, (64, 112, 96, 3)).astype(np.uint8)
        req = os.path.join(FACE_DIR, "req.npz")
        np.savez(req, x=xq)
        served = {}
        for q, flags in (("bf16", []), ("int8", ["--int8", "--calibrate",
                                                 cal])):
            art = os.path.join(FACE_DIR, f"art_{q}")
            rc, rep = _cli(["export", "--checkpoint", final, "--out", art,
                            "--experiment", "face", *flags])
            if rc != 0 or rep["calibrated_tasks"] != (2 if q == "int8"
                                                      else 0):
                raise AssertionError(f"face: export {q} {rc} {rep}")
            res = os.path.join(FACE_DIR, f"out_{q}.npz")
            rc, rep = _cli(["serve", "--artifact", art, "--requests", req,
                            "--task-id", "2", "--out", res, "--experiment",
                            "face"])
            if rc != 0 or rep["n"] != 64:
                raise AssertionError(f"face: serve {q} {rc} {rep}")
            with np.load(res) as z:
                served[q] = z["logits"]
            srv = TaskServer.load(art, prep, device=dev)
            out[f"serve_{q}_b64"] = _serve_latency(srv, xq, reps=10)
            if q == "int8":
                with _Int8Calls() as rec:
                    srv.predict(2, xq)
                rows = int8_route_rows(torch, rec.calls, "spherenet20")
                del rec
                if sum(r["count"] for r in rows) != 21:
                    raise AssertionError("face: an int8 forward ran "
                                         f"{sum(r['count'] for r in rows)} "
                                         "products, want 21")
                out["int8_route"] = _route_totals(rows)
                out["int8_route_rows"] = rows
            del srv
        out["int8_vs_bf16"] = dict(zip(("max_abs_diff", "argmax_agree"),
                                       _int8_bound(torch, served["int8"],
                                                   served["bf16"],
                                                   "face: int8 vs bf16")))

        # export-torch -> import-torch
        pth = os.path.join(FACE_DIR, "ref.pth")
        back = os.path.join(FACE_DIR, "back")
        rc, rep = _cli(["export-torch", "--ckpt", final, "--out", pth])
        rc2, rep2 = _cli(["import-torch", "--ckpt", pth, "--arch",
                          "spherenet20", "--out", back])
        a, b = load_state(final, device=dev), load_state(back, device=dev)
        if b.forward_kwargs(2) != {"head_type": "linear"}:
            raise AssertionError("face: import-torch lost task 2's linear "
                                 "head")
        for tid in b.tasks:
            b.tasks[tid].meta = a.tasks[tid].meta
        if rc or rc2 or not _same_state(torch, a, b):
            raise AssertionError("face: export-torch -> import-torch "
                                 "changed the state")
        out["torch_round_trip_bit_equal"] = True
        print("face spherenet20: " + json.dumps(
            {k: v for k, v in out.items() if k != "int8_route_rows"})
            + f" on {card}", flush=True)
    finally:
        shutil.rmtree(FACE_DIR, ignore_errors=True)
    return out, launched


# ------------------------------------------------------------- textcls ----

# The text cycle from the CLI: three synthetic token tasks (512 training
# sequences of 64 ids each, batch 128: 4 steps an epoch), causal, at width
# 1.0 on the bf16 kernel step (`--use-pallas --flash-attention`), one epoch
# a phase; task 3 misses the unreachable goal 1.01 and grows once to 1.5;
# its checkpoints inside the checkout
TEXT_DIR = os.path.join("build", "smoke_textcls")
TEXT_BATCH = 128
TEXT_TASKS = ("text01", "text02", "text03")


def text_phase(torch, dev, counts, card):
    """`python -m cpg_tpu_torch sequence --experiment textcls --text-causal`
    through cli.main, then: check_state at every task boundary; old-task
    logits bit-equal (max|diff| 0) across add-task and prune (task 1 across
    task 2's, tasks 1 and 2 across task 3's prune at the grown width); the
    growth audit; a second run that resumes every task and gives the same
    state bit for bit; `export` bf16 and calibrated int8 and `serve` on
    both at bucket 64 (int8 within `cpg_tpu`'s bound of bf16, p50 and
    img/s); `inference` of every task. Returns the results and the
    launches of the first run."""
    from cpg_tpu_torch.core.invariants import check_state
    from cpg_tpu_torch.inference import predict
    from cpg_tpu_torch.serve import TaskServer
    from cpg_tpu_torch.train import sequence as seq_mod
    from cpg_tpu_torch.train.manager import Manager
    from cpg_tpu_torch.utils.checkpoint import load_state

    shutil.rmtree(TEXT_DIR, ignore_errors=True)
    os.makedirs(TEXT_DIR)
    out = {}
    try:
        goals = os.path.join(TEXT_DIR, "goals.json")
        with open(goals, "w") as f:
            json.dump({TEXT_TASKS[2]: 1.01}, f)
        ck = os.path.join(TEXT_DIR, "ck")
        argv = ["sequence", "--experiment", "textcls", "--text-causal",
                "--num-tasks", "3", "--use-pallas", "--flash-attention",
                "--finetune-epochs", "1", "--prune-epochs", "1",
                "--retrain-epochs", "1", "--prune-ratios", "0.5",
                "--batch-size", str(TEXT_BATCH), "--goals-file", goals,
                "--growth-step", "0.5",
                "--max_allowed_network_width_multiplier", "1.5",
                "--checkpoint-dir", ck,
                "--jsonl", os.path.join(TEXT_DIR, "phases.jsonl")]
        runs = []
        orig_run = seq_mod.run_sequence

        def recorded(*a, **k):
            runs.append(orig_run(*a, **k))
            return runs[-1]

        keep = seq_mod.remove_after_save
        seq_mod.run_sequence = recorded
        seq_mod.remove_after_save = lambda path: None
        try:
            torch.cuda.synchronize()
            counts.reset()
            t0 = time.perf_counter()
            rc, summary = _cli(argv)
            torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t0
            launched = counts.read()
            trained = []
            orig_train = Manager.train
            Manager.train = lambda *a, **k: trained.append(1)
            try:
                rc2, summary2 = _cli(argv)
            finally:
                Manager.train = orig_train
        finally:
            seq_mod.run_sequence = orig_run
            seq_mod.remove_after_save = keep
        state, reports = runs[0]
        if rc != 0 or rc2 != 0 or [t["grew"] for t in summary["tasks"]] \
                != [0, 0, 1] or summary["final_width_mult"] != 1.5:
            raise AssertionError(f"textcls: sequence {rc} {summary}")
        if trained or not _same_state(torch, runs[1][0], state):
            raise AssertionError("textcls: resume did not reproduce the "
                                 "state")
        if state.forward_kwargs(3) != {"vocab": 256, "causal": True}:
            raise AssertionError(f"textcls: task 3 runs with "
                                 f"{state.forward_kwargs(3)}")
        out["summary"] = summary
        out["resumed_summary_equal"] = summary2 == summary
        with open(os.path.join(TEXT_DIR, "phases.jsonl")) as f:
            out["phases"] = [json.loads(line) for line in f]
        for ph in out["phases"]:
            ph["ms_per_step"] = ph["seconds"] / max(ph["steps"], 1) * 1e3

        def ckpt(tid, suffix=""):
            return load_state(os.path.join(
                ck, f"task{tid:02d}_{TEXT_TASKS[tid - 1]}{suffix}"),
                device=dev)

        by = {"task1": ckpt(1), "task2.pick": ckpt(2, ".pick"),
              "task2": ckpt(2), "task3.pick": ckpt(3, ".pick"),
              "task3": ckpt(3), "final": state}
        out["check_state"] = {label: check_state(st)  # raises if dirty
                              for label, st in by.items()}
        x = torch.from_numpy(_inputs(TEXT_SHAPE, 64, np.random.RandomState(
            SEED + 19))).to(dev)
        old = {}
        for tid, labels in ((1, ("task1", "task2.pick", "task2")),
                            (1, ("task3.pick", "task3", "final")),
                            (2, ("task3.pick", "task3", "final"))):
            ref = predict(by[labels[0]], tid, x, device=dev)
            d = max(float((predict(by[lb], tid, x, device=dev) - ref)
                          .abs().max()) for lb in labels[1:])
            old[f"task{tid} {' -> '.join(labels)}"] = d
            if d != 0.0:
                raise AssertionError(f"textcls: task {tid} logits moved by "
                                     f"{d} across {labels}")
        out["old_task_max_abs_diff"] = old
        audit = reports[2].growth_audit
        if not audit or any(a["max_abs_diff"] > a["bound"] for a in audit):
            raise AssertionError(f"textcls: growth audit {audit}")
        out["growth_audit"] = audit

        # export bf16 and calibrated int8, serve both at bucket 64
        final = os.path.join(ck, f"task03_{TEXT_TASKS[2]}")
        rng = np.random.RandomState(SEED + 20)
        cal = os.path.join(TEXT_DIR, "calib.npz")
        np.savez(cal, x=_inputs(TEXT_SHAPE, 64, rng))
        xq = _inputs(TEXT_SHAPE, 64, rng)
        req = os.path.join(TEXT_DIR, "req.npz")
        np.savez(req, x=xq)
        served = {}
        for q, flags in (("bf16", []), ("int8", ["--int8", "--calibrate",
                                                 cal])):
            art = os.path.join(TEXT_DIR, f"art_{q}")
            rc, rep = _cli(["export", "--checkpoint", final, "--out", art,
                            "--experiment", "textcls", *flags])
            if rc != 0 or rep["calibrated_tasks"] != (3 if flags else 0):
                raise AssertionError(f"textcls: export {q} {rc} {rep}")
            res = os.path.join(TEXT_DIR, f"out_{q}.npz")
            rc, rep = _cli(["serve", "--artifact", art, "--requests", req,
                            "--task-id", "2", "--out", res, "--experiment",
                            "textcls"])
            if rc != 0 or rep["n"] != 64:
                raise AssertionError(f"textcls: serve {q} {rc} {rep}")
            with np.load(res) as z:
                served[q] = z["logits"]
            srv = TaskServer.load(art, None, device=dev)
            out[f"serve_{q}_b64"] = _serve_latency(srv, xq, reps=10)
            del srv
        out["int8_vs_bf16"] = dict(zip(("max_abs_diff", "argmax_agree"),
                                       _int8_bound(torch, served["int8"],
                                                   served["bf16"],
                                                   "textcls: int8 vs bf16")))
        out["inference"] = {}
        for tid in (1, 2, 3):
            rc, rep = _cli(["inference", "--checkpoint", final, "--task-id",
                            str(tid), "--experiment", "textcls",
                            "--num-tasks", "3"])
            if rc != 0 or rep["n"] != 128 or not 0.0 <= rep["top1"] <= 1.0:
                raise AssertionError(f"textcls: inference {tid} {rc} {rep}")
            out["inference"][TEXT_TASKS[tid - 1]] = rep["top1"]
        print("text textcls: " + json.dumps(out) + f" on {card}", flush=True)
    finally:
        shutil.rmtree(TEXT_DIR, ignore_errors=True)
    return out, launched


# -------------------------------------------------------------- deploy ----

# the deploy phase's two tasks, named as CIFAR-100 superclass tasks so that
# `inference` finds their synthetic test splits
DEPLOY_NAMES = ("aquatic_mammals", "fish")
CALIB_PER_TASK = 64
HTTP_REQUESTS, HTTP_CLIENTS = 256, 32
HTTP_WINDOWS_MS = (0.0, 3.0)
INT8_RTOL, INT8_ATOL = 0.2, 0.5  # cpg_tpu's int8-vs-bf16 bound
                                 # (tests/test_serve.py, calibrated int8)


def _cli(argv):
    """(exit code, printed JSON) of `python -m cpg_tpu_torch <argv>`."""
    import contextlib
    import io

    from cpg_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, json.loads(buf.getvalue())


def _serve_latency(srv, x, reps=20):
    """p50 ms and img/s of srv.predict(2, x), host clock (predict returns
    host arrays, so every call ends synchronised)."""
    srv.predict(2, x)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        srv.predict(2, x)
        ts.append(time.perf_counter() - t0)
    p50 = float(np.median(ts))
    return {"p50_ms": p50 * 1e3, "img_per_s": len(x) / p50}


class _Int8Calls:
    """Records the operands of every int8 conv and matmul of ops/int8.py
    while active (the model layers import them at call time)."""

    def __init__(self):
        from cpg_tpu_torch.ops import int8

        self.mod, self.calls = int8, []
        self.orig = (int8.conv2d_int8, int8.matmul_int8)

    def __enter__(self):
        conv, mm = self.orig

        def rec_conv(xq, wq, stride, pads):
            self.calls.append(("conv", xq, wq, stride, tuple(pads)))
            return conv(xq, wq, stride, pads)

        def rec_mm(xq, wq):
            self.calls.append(("dense", xq, wq, 1, (0, 0, 0, 0)))
            return mm(xq, wq)

        self.mod.conv2d_int8, self.mod.matmul_int8 = rec_conv, rec_mm
        return self

    def __exit__(self, *exc):
        self.mod.conv2d_int8, self.mod.matmul_int8 = self.orig


def int8_route_rows(torch, calls, arch):
    """Each distinct int8 product of a forward at bucket 256: the route
    (patch gather + `torch._int_mm`) held bit for bit against the plain
    exact product on the same patches, its device ms, the gather's alone,
    the bf16 library call on the same shapes (cuDNN conv, cuBLAS matmul),
    and the bound at int8 operand bytes and the card's int8 peak."""
    from cpg_tpu_torch.ops import int8
    from cpg_tpu_torch.ops.conv import conv2d_nhwc

    groups = {}
    for kind, xq, wq, stride, pads in calls:
        key = (kind, tuple(xq.shape), tuple(wq.shape), stride, pads)
        groups.setdefault(key, [kind, xq, wq, stride, pads, 0])[5] += 1
    rows = []
    for (kind, xs, ws, stride, pads), (_, xq, wq, _, _, count) in \
            groups.items():
        k2, n = int(np.prod(ws[:-1])), ws[-1]
        if kind == "conv":
            kh, kw = ws[0], ws[1]
            xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)

            def gather(xq=xq, kh=kh, kw=kw, stride=stride, pads=pads):
                return int8.patches(xq, kh, kw, stride, pads)

            def route(xq=xq, wq=wq, stride=stride, pads=pads):
                return int8.conv2d_int8(xq, wq, stride, pads)

            def library(xb=xb, wb=wb, stride=stride, pads=pads):
                return conv2d_nhwc(xb, wb, stride, pads)
        else:
            xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
            gather = None

            def route(xq=xq, wq=wq):
                return int8.matmul_int8(xq, wq)

            def library(xb=xb, wb=wb):
                return xb @ wb
        a = gather() if gather else xq.reshape(-1, k2)
        m = a.shape[0]
        want = int8.int_mm_plain(a, wq.reshape(k2, n))
        got = twice(torch, route, f"int8 {arch} {kind} {xs}").reshape(m, n)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"int8 route {arch} {kind} {xs} x {ws}: "
                                 f"{bad} entries differ from the plain "
                                 "product")
        b_ms, b_by = bound(xq.numel() + wq.numel() + m * n * 4,
                           2.0 * m * n * k2, "int8")
        row = dict(arch=arch, kind=kind, x=list(xs), w=list(ws),
                   stride=stride, pads=list(pads), count=count, m=m, k=k2,
                   n=n, bit_equal=True, route_ms=time_ms(route),
                   route_device_ms=device_ms(route),
                   library_bf16_device_ms=device_ms(library),
                   bound_ms=b_ms, bound_by=b_by)
        if gather:
            row["gather_device_ms"] = device_ms(gather)
        rows.append(row)
    return rows


def _route_totals(rows):
    """Per-forward sums over the products (each distinct one times its
    count) and the patch gather's share of the route's device time."""
    out = {"products": sum(r["count"] for r in rows)}
    for key in ("route_device_ms", "library_bf16_device_ms", "bound_ms",
                "gather_device_ms"):
        vals = [(r[key], r["count"]) for r in rows if key in r]
        out[key] = (None if not vals or any(v is None for v, _ in vals)
                    else sum(v * c for v, c in vals))
    if out["route_device_ms"] and out["gather_device_ms"] is not None:
        out["gather_share"] = out["gather_device_ms"] / out["route_device_ms"]
    return out


def _post(port, payload):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def http_run(srv, x, window_ms):
    """HTTP_REQUESTS single-image POSTs to /v1/predict (task 2) from
    HTTP_CLIENTS client threads against serve_http(srv) on 127.0.0.1:0:
    the logits (f32, row i for x[i]), client latency p50/p99, img/s over
    the wall time, and predict calls per request."""
    import concurrent.futures

    from cpg_tpu_torch.server_http import serve_http

    calls = []
    real = srv.predict
    srv.predict = lambda tid, xs: (calls.append(len(xs)), real(tid, xs))[1]
    httpd = serve_http(srv, port=0, batch_window_ms=window_ms)
    port = httpd.server_address[1]
    try:
        for i in range(4):  # warm the handler threads and the batcher
            _post(port, {"task_id": 2, "inputs": x[i].tolist()})
        calls.clear()
        lat = [0.0] * len(x)

        def one(i):
            t0 = time.perf_counter()
            out = _post(port, {"task_id": 2, "inputs": x[i].tolist()})
            lat[i] = time.perf_counter() - t0
            return np.asarray(out["logits"], np.float32)[0]

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as ex:
            logits = np.stack(list(ex.map(one, range(len(x)))))
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        del srv.predict
    ms = np.asarray(lat) * 1e3
    return logits, {"window_ms": window_ms, "requests": len(x),
                    "clients": HTTP_CLIENTS,
                    "p50_ms": float(np.percentile(ms, 50)),
                    "p99_ms": float(np.percentile(ms, 99)),
                    "img_per_s": len(x) / wall,
                    "predict_calls_per_request": len(calls) / len(x),
                    "rows_per_predict": float(np.mean(calls))}


def _alone(srv, x):
    """srv.predict of each row of x on its own."""
    return np.concatenate([srv.predict(2, x[i:i + 1]) for i in range(len(x))])


def _int8_bound(torch, got, ref, what):
    """cpg_tpu's int8 bound against the float server: |int8 - ref| <= atol
    + rtol |ref| everywhere. Returns (max|diff|, argmax agreement)."""
    g, r = torch.from_numpy(got), torch.from_numpy(ref)
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite int8 logits")
    if not bool(((g - r).abs() <= INT8_ATOL + INT8_RTOL * r.abs()).all()):
        raise AssertionError(f"{what}: int8 logits outside rtol {INT8_RTOL} "
                             f"atol {INT8_ATOL} of the float server")
    return (float((g - r).abs().max()),
            float((g.argmax(1) == r.argmax(1)).float().mean()))


def deploy_phase(torch, dev, counts, card):
    """The serving side of the main path from a checkpoint, through the
    CLI on the card: VGG16-BN at width 1.0 (build_state's two tasks) saved
    with utils/checkpoint; `check` (must be clean) and `stats`; `export`
    bf16 and `export --int8 --calibrate` (CALIB_PER_TASK synthetic images
    a task); `serve` offline on both artifacts at bucket 256 (bf16 with
    --fused-chain: K4 launches; int8: no fused-chain launch, the int8
    counter rises); the int8 route at each product against its plain
    version, bit for bit; int8 against bf16 at cpg_tpu's bound; calibrated
    int8 bit-equal alone and co-batched with saturated rows; serve_http
    in-process at windows 0 and 3 ms (bf16 against in-process predict at
    the bf16 tolerance, calibrated int8 bit-equal at 3 ms); `export-torch`
    -> `import-torch` bit for bit; `inference` on the synthetic test
    split. Then an int8 vit_cifar server at full width against its f32
    server. Returns the results and the launches of the bf16 serve."""
    from cpg_tpu_torch.data.augment import cifar_eval_preprocess as prep
    from cpg_tpu_torch.ops import int8
    from cpg_tpu_torch.serve import TaskServer
    from cpg_tpu_torch.utils.checkpoint import load_state, save_state

    out = {}
    tmp = tempfile.mkdtemp(prefix="deploy_")
    try:
        state = build_state(torch, dev)
        for tid, name in zip((1, 2), DEPLOY_NAMES):
            state.tasks[tid].name = name
        ck = save_state(state, os.path.join(tmp, "ck"))
        del state
        rc, chk = _cli(["check", "--checkpoint", ck])
        if rc != 0 or not chk["clean"]:
            raise AssertionError(f"deploy: check {rc} {chk['violations']}")
        rc, stats = _cli(["stats", "--checkpoint", ck])
        if rc != 0 or abs(sum(t["owned_ratio"] for t in stats["tasks"]
                              .values()) + stats["free_ratio"] - 1) > 1e-9:
            raise AssertionError(f"deploy: stats {rc} {stats}")
        out["stats"] = stats

        rng = np.random.RandomState(SEED + 11)
        calib = {tid: rng.randint(0, 256, (CALIB_PER_TASK, 32, 32, 3))
                 .astype(np.uint8) for tid in (1, 2)}
        cal = os.path.join(tmp, "calib.npz")
        np.savez(cal, **{f"task{tid}": v for tid, v in calib.items()})
        art = {q: os.path.join(tmp, f"art_{q}") for q in ("bf16", "int8")}
        t0 = time.perf_counter()
        rc, rep = _cli(["export", "--checkpoint", ck, "--out", art["bf16"]])
        out["export_bf16_s"] = time.perf_counter() - t0
        if rc != 0 or rep["quantize"] is not None:
            raise AssertionError(f"deploy: export {rc} {rep}")
        t0 = time.perf_counter()
        rc, rep = _cli(["export", "--checkpoint", ck, "--out", art["int8"],
                        "--int8", "--calibrate", cal])
        out["export_int8_calibrated_s"] = time.perf_counter() - t0
        if rc != 0 or rep["quantize"] != "int8" or \
                rep["calibrated_tasks"] != 2:
            raise AssertionError(f"deploy: export --int8 {rc} {rep}")

        # offline `serve` through the CLI at bucket 256
        x = rng.randint(0, 256, (BATCH, 32, 32, 3)).astype(np.uint8)
        req = os.path.join(tmp, "req.npz")
        np.savez(req, x=x)
        served, launched = {}, {}
        for q, flags in (("bf16", ["--fused-chain"]), ("int8", [])):
            res = os.path.join(tmp, f"out_{q}.npz")
            torch.cuda.synchronize()
            counts.reset()
            int8.LAUNCHES = 0
            rc, rep = _cli(["serve", "--artifact", art[q], "--requests", req,
                            "--task-id", "2", "--out", res, *flags])
            torch.cuda.synchronize()
            launched[q] = {**counts.read(), "int8_mm": int8.LAUNCHES}
            if rc != 0 or rep["n"] != BATCH:
                raise AssertionError(f"deploy: serve {q} {rc} {rep}")
            with np.load(res) as z:
                served[q] = z["logits"]
        if launched["bf16"]["fused_chain_fwd"] != 8 or \
                launched["bf16"]["int8_mm"] != 0:
            raise AssertionError(f"deploy: bf16 serve launches "
                                 f"{launched['bf16']}")
        if launched["int8"]["fused_chain_fwd"] != 0 or \
                launched["int8"]["int8_mm"] != 13:
            raise AssertionError(f"deploy: int8 serve launches "
                                 f"{launched['int8']}")
        out["serve_launches"] = launched

        bf = TaskServer.load(art["bf16"], prep, fused_chain=True, device=dev)
        q8 = TaskServer.load(art["int8"], prep, device=dev)
        if not q8._act_scales[2]:
            raise AssertionError("deploy: the int8 artifact lost its "
                                 "activation scales")
        if not np.array_equal(q8.predict(2, x), served["int8"]):
            raise AssertionError("deploy: int8 CLI serve != predict")
        compare(torch.from_numpy(served["bf16"]),
                torch.from_numpy(bf.predict(2, x)), "bfloat16",
                "deploy: bf16 CLI serve vs predict")
        out["bucket256"] = {"bf16_fused_chain": _serve_latency(bf, x),
                            "int8": _serve_latency(q8, x)}
        print(f"deploy vgg16_bn_cifar: serve at bucket 256 "
              f"{json.dumps(out['bucket256'])} on {card}", flush=True)

        # the int8 route at every product of one forward at bucket 256
        with _Int8Calls() as rec:
            q8.predict(2, x)
        vgg_rows = int8_route_rows(torch, rec.calls, "vgg16_bn_cifar")
        del rec
        if sum(r["count"] for r in vgg_rows) != 13:
            raise AssertionError("deploy: int8 forward ran "
                                 f"{sum(r['count'] for r in vgg_rows)} "
                                 "products, want 13")
        out["int8_route"] = {"vgg16_bn_cifar": _route_totals(vgg_rows)}

        # int8 against bf16; calibrated int8 alone and co-batched
        err, agree = _int8_bound(torch, served["int8"], served["bf16"],
                                 "deploy: int8 vs bf16")
        probe = x[:1]
        sat = np.full((3, 32, 32, 3), 255, np.uint8)
        alone = q8.predict(2, probe)
        co = q8.predict(2, np.concatenate([probe, sat]))[:1]
        co256 = q8.predict(2, np.concatenate(
            [probe, np.repeat(sat[:1], BATCH - 1, 0)]))[:1]
        if not np.array_equal(alone, co):
            raise AssertionError("deploy: calibrated int8 logits moved when "
                                 "co-batched with saturated rows")
        if np.argmax(alone) != np.argmax(bf.predict(2, probe)):
            raise AssertionError("deploy: int8 and bf16 top-1 differ on the "
                                 "probe")
        out["int8_vs_bf16"] = {"max_abs_diff": err, "argmax_agree": agree,
                               "co_batched_bucket8_bit_equal": True,
                               "co_batched_bucket256_bit_equal":
                                   bool(np.array_equal(alone, co256))}

        # HTTP front end, in-process, windows 0 and 3 ms
        want = {"bf16": _alone(bf, x), "int8": _alone(q8, x)}
        http = {}
        for q, srv in (("bf16", bf), ("int8", q8)):
            for w in HTTP_WINDOWS_MS:
                got, stat = http_run(srv, x, w)
                if q == "bf16":
                    stat["max_abs_err"] = compare(
                        torch.from_numpy(got), torch.from_numpy(want[q]),
                        "bfloat16", f"deploy: bf16 over HTTP, window {w}")
                stat["bit_equal_to_predict"] = bool(np.array_equal(
                    got, want[q]))
                if q == "int8" and w > 0 and not stat["bit_equal_to_predict"]:
                    raise AssertionError(
                        f"deploy: calibrated int8 over HTTP (window {w} ms) "
                        "differs from predict")
                http[f"{q}_window_{w:g}ms"] = stat
        out["http"] = http
        print(f"deploy http: {json.dumps(http)} on {card}", flush=True)

        # export-torch -> import-torch, then inference
        pth = os.path.join(tmp, "ref.pth")
        rc, rep = _cli(["export-torch", "--ckpt", ck, "--out", pth])
        if rc != 0:
            raise AssertionError(f"deploy: export-torch {rc} {rep}")
        ck2 = os.path.join(tmp, "ck2")
        rc, rep = _cli(["import-torch", "--ckpt", pth, "--out", ck2])
        if rc != 0:
            raise AssertionError(f"deploy: import-torch {rc} {rep}")
        a, b = load_state(ck, device=dev), load_state(ck2, device=dev)
        b.tasks[1].meta, b.tasks[2].meta = a.tasks[1].meta, a.tasks[2].meta
        if not _same_state(torch, a, b):
            raise AssertionError("deploy: export-torch -> import-torch "
                                 "changed the state")
        del a, b
        out["torch_round_trip_bit_equal"] = True
        rc, inf = _cli(["inference", "--checkpoint", ck, "--task-id", "2",
                        "--synthetic-train-per-class", "1"])
        if rc != 0 or inf["n"] != 100 or not 0.0 <= inf["top1"] <= 1.0:
            raise AssertionError(f"deploy: inference {rc} {inf}")
        out["inference"] = inf
        del bf, q8
        torch.cuda.empty_cache()

        # vit_cifar at full width: an int8 server against its f32 server
        vstate = build_state(torch, dev, "vit_cifar")
        vx = rng.randint(0, 256, (BATCH, 32, 32, 3)).astype(np.uint8)
        f32 = TaskServer(vstate, prep, compute_dtype=torch.float32,
                         device=dev)
        v8 = TaskServer(vstate, prep, quantize="int8", device=dev)
        v8.calibrate({tid: v for tid, v in calib.items()})
        ref, got = f32.predict(2, vx), v8.predict(2, vx)
        err, agree = _int8_bound(torch, got, ref, "deploy: vit int8 vs f32")
        with _Int8Calls() as rec:
            v8.predict(2, vx)
        vit_rows = int8_route_rows(torch, rec.calls, "vit_cifar")
        del rec
        out["int8_route"]["vit_cifar"] = _route_totals(vit_rows)
        out["vit_cifar"] = {"int8_vs_f32": {"max_abs_diff": err,
                                            "max_abs_ref":
                                                float(np.abs(ref).max()),
                                            "argmax_agree": agree},
                            "bucket256": {"f32": _serve_latency(f32, vx),
                                          "int8": _serve_latency(v8, vx)}}
        out["int8_route_rows"] = vgg_rows + vit_rows
        print(f"deploy int8 route: {json.dumps(out['int8_route'])}; vit "
              f"{json.dumps(out['vit_cifar'])} on {card}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launched["bf16"]


# the kernels SphereNet-20's eval and train phases must reach
SPHERE_EVAL_KERNELS = ["masked_conv_fwd", "masked_conv_select",
                       "masked_conv_stem", "masked_matmul_fwd",
                       "masked_matmul_select"]
SPHERE_TRAIN_KERNELS = ["masked_conv_bwd_dx", "masked_conv_bwd_dw",
                        "masked_conv_im2col", "masked_matmul_bwd_dx",
                        "masked_matmul_bwd_dw"]
# the kernels textcls's and vit_moe_cifar's eval phases must reach, and
# textcls's train phase (its hd-32 attention's backward: the one-launch
# kernel)
DENSE_EVAL_KERNELS = ["flash_fwd", "masked_matmul_fwd", "masked_matmul_select"]
TEXT_TRAIN_KERNELS = ["flash_bwd", "masked_matmul_bwd_dx",
                      "masked_matmul_bwd_dw"]
# the archs whose kernel rows count in their own train step (the kernels
# line's `<arch>_step`)
OWN_STEPS = ("resnet50", "spherenet20", "textcls")


def _per_step(row) -> int:
    """Launches of a phase row's shape in one train step at batch 256: the
    ViT rows say so; a VGG16-BN row's layer runs once a step in bf16 binary
    (its ternary and f32 rows are extra checks); ResNet-50's,
    SphereNet-20's and textcls's rows count in their own steps (the kernels
    line's `resnet50_step`, `spherenet20_step`, `textcls_step`), and
    SPLIT_STEPS' rows in none."""
    if row.get("arch") in OWN_STEPS + SPLIT_STEPS:
        return 0
    if "per_step" in row:
        return row["per_step"]
    return int(row["dtype"] == "bfloat16"
               and row.get("mode", "binary") == "binary")


def _step_sum(step, key):
    """Sum of a per-shape time over one train step's launches; None when a
    shape's time was not measured."""
    vals = [(r.get(key), k) for r, k in step]
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
            "masked_conv_stem": (masked_conv, "LAUNCHES_STEM"),
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


# the parallel phase (parallel/*): VGG16-BN's data-parallel kernel step on
# two ranks sharing the card over gloo (NCCL refuses two ranks on one GPU),
# the model axis's steps (VGG16-BN, vit_cifar) on the same two ranks,
# `sequence --parallel 1` over NCCL against the run without the flag, the
# server over the mesh [cuda:0, cuda:0], and `sequence --parallel 2` over
# NCCL across cards where two are visible
PAR_RANKS = 2
PAR_MULT = 1.0
PAR_STEPS = 3
PAR_ROUND_STEPS = 5
PAR_TIMEOUT_S = 300            # a collective that waits longer raises
PAR_F32_LOSS_RTOL = 1e-4       # f32: the DP step's losses against the
                               # one-process step's
PAR_MASK_MARGIN = 1e-3         # task 2's piggymask this far from the
                               # threshold (see `_parallel_rank_run`)
PAR_MASK_OFF_SHARE = 5e-4      # f32: the piggymask entries whose update
                               # misses the one-process kernel step's (rtol
                               # 1e-4 / atol 1e-7; Adam turns summation
                               # order into a sign where a gradient is near
                               # 0): at most UPDATE_RATIO x those of the
                               # f32 default step plus this share of the
                               # entries moved, each within 3 lr_mask
TP_F32_UPDATE_RTOL = 1e-4      # f32 under a model axis alone or a
                               # pipeline (no data ranks summing in another
                               # order): the shared and private updates
                               # within this share of the update's norm of
                               # the one-process step's (the model group's
                               # f32 sum of partial input gradients, or the
                               # stages' sum of one non-zero gradient and
                               # zeros, moves them by about 1e-6 of it on an
                               # H100; either sum done in bf16, or the
                               # pipeline's ring carried in bf16, must miss
                               # it: scripts/torch_tp_controls.py)
ACT_SHARD_ARCHS = ("vit_cifar", "textcls", "vit_moe_cifar")
                               # the act_shard phase's kernel steps, as
                               # (data=1, model=2) with the tokens and the
                               # experts split over the model group
PP_STAGES, PP_MICRO = 2, 4     # the pipeline phase: vit_cifar's 6 blocks
                               # as 2 stages of 3, 4 microbatches of 64
PP_FLAGS = dict(flash_attention=True)  # the pipeline's blocks take whole
                               # (effective) weights: K7 alone in them
PAR_SERVE_ROWS = (1, 37, 256)
PAR_CLI_PER_CLASS = 64         # 5 classes: 320 images, 2 steps an epoch
PAR_CLI_FLOOR = {"own_flip": 1e-3, "shared": 1e-5, "bn": 1e-5}
                               # f32 `sequence --parallel n` against one
                               # rank (owner flips at the prune cutoff,
                               # weights and BN statistics, relative): at
                               # most UPDATE_RATIO x the largest spread of
                               # the one-rank runs under PAR_CLI_ORDERS,
                               # or these
PAR_CLI_ORDERS = {"kernels": (), "masked_conv": ("--fused-chain",),
                  "default": ("--use-pallas-conv", "--fused-chain")}
                               # one process's summation orders: the flags
                               # each one-rank run drops (the first is the
                               # run the parallel runs are held against)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _par_batches(torch, dev, n, arch="vgg16_bn_cifar"):
    """PAR_STEPS global batches (uint8 images or textcls's token ids,
    labels, the arch's augmentation draws) of n rows, the same in every
    process."""
    shape, _, _, draws, _ = _arch_io(arch)
    gen = torch.Generator().manual_seed(SEED + 7)
    out = []
    for _ in range(PAR_STEPS):
        x = torch.randint(0, 256, (n, *shape), generator=gen,
                          dtype=torch.int32 if len(shape) == 1
                          else torch.uint8).to(dev)
        y = torch.randint(0, 5, (n,), generator=gen).to(dev)
        out.append((x, y, draws(n, gen)))
    return out


def _parallel_rank(rank, world, store, cfg, out_dir):
    """One rank of `dp_ranks_check`, in a spawned process: joins the world
    over cfg["backend"] on cfg["devices"][rank], runs `_parallel_rank_run`
    and writes its results to <out_dir>/rank<r>.json."""
    import torch

    from cpg_tpu_torch.parallel import distributed as pd

    dev = torch.device(cfg["devices"][rank])
    torch.backends.cudnn.allow_tf32 = False  # as `main` sets them
    torch.set_float32_matmul_precision("highest")
    pd.initialize(store, world, rank, backend=cfg["backend"], device=dev,
                  timeout=PAR_TIMEOUT_S)
    try:
        out = _parallel_rank_run(torch, dev, rank, cfg)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        pd.shutdown()


def _held(st):
    """What a rank holds of a (possibly split) state's shared, ownership
    and task-2 piggymask trees: their bytes, and whether each split kernel
    is its 1 / parts slice along its axis."""
    trees = (st.shared, st.ownership, st.tasks[2].piggymask)
    nbytes = sum(v.numel() * v.element_size() for t in trees
                 for v in t.values())
    whole = sum(int(np.prod(st.shards[k].whole_shape(v.shape)
                            if k in st.shards else v.shape))
                * v.element_size() for t in trees for k, v in t.items())
    slices = all(v.shape[s.axis] * s.parts == s.size
                 for t in trees for k, v in t.items()
                 for s in [st.shards.get(k)] if s is not None)
    return dict(bytes=nbytes, whole_bytes=whole, slices=slices,
                split=len(st.shards), kernels=len(st.shared),
                unsplit=sorted(k for k in st.shared if k not in st.shards))


def _seam_spy():
    """(install, seams): `install(on)` wraps `Ctx.constrain` so each seam
    appends (tag, shape in, shape out) to `seams` (off: unwraps)."""
    from cpg_tpu_torch.models import framework as fw

    keep, seams = fw.Ctx.constrain, []

    def spy(ctx, x, tag):
        y = keep(ctx, x, tag)
        seams.append((tag, list(x.shape), list(y.shape)))
        return y

    def install(on):
        fw.Ctx.constrain = spy if on else keep
    return install, seams


def _parallel_rank_run(torch, dev, rank, cfg):
    """Task 2's kernel step of cfg["arch"] (default VGG16-BN; `_train_base`
    of `build_state`) over the mesh of every rank, cfg["n_model"] of them a
    model group (default 1: data-parallel alone; more: each rank holds its
    slice of every kernel that divides; with cfg["act_shard"] the kernels
    stay whole and `act_sharder` splits the tokens and the experts over
    the group instead), or with cfg["pipeline"] = (stages, n_micro) through
    `make_pipeliner` over every rank (a stage a rank, the blocks' K7 by
    `_default_block_fn(flash_attention=True)`), f32 then bf16, PAR_STEPS
    steps each on the same global batches and draws, the replicas held
    bit-equal after every step (`check_replicas`: split tensors over the
    data group, the rest over every rank) and the no-forgetting invariants
    on the gathered state after the last. Rank 0 also runs the one-process
    kernel step (and in f32 the default step) on the same batches and
    compares the one-step updates (`_update_dists`, the f32 one-process
    step as yardstick). Then ms/step of the bf16 step: all ranks at once,
    then rank 0's one-process step alone."""
    import dataclasses
    import functools

    from cpg_tpu_torch.models import get_model
    from cpg_tpu_torch.parallel.collectives import barrier, gather_state
    from cpg_tpu_torch.parallel.mesh import act_sharder, make_mesh
    from cpg_tpu_torch.parallel.pipeline import (_default_block_fn,
                                                 make_pipeline_mesh,
                                                 make_pipeliner)
    from cpg_tpu_torch.train.sequence import check_replicas
    from cpg_tpu_torch.train.step import TrainConfig

    n_model = cfg.get("n_model", 1)
    arch = cfg.get("arch", "vgg16_bn_cifar")
    act, pipe = cfg.get("act_shard", False), cfg.get("pipeline")
    par = _par_label(cfg)
    split = n_model > 1 and not act
    mesh = (make_pipeline_mesh(pipe[0]) if pipe
            else make_mesh(n_model=n_model))
    counts = Counts()
    model_fn, _ = get_model(arch)
    _, _, augment, _, _ = _arch_io(arch)
    base = _train_base(torch, dev,
                       build_state(torch, dev, arch, width_mult=cfg["mult"]),
                       torch.Generator().manual_seed(SEED + 3))
    # task 2's piggymask kept PAR_MASK_MARGIN from the threshold: Adam
    # moves an entry by about lr_mask a step whatever its gradient, so an
    # entry nearer than PAR_STEPS * lr_mask flips its mask bit on the sign
    # of a near-zero gradient, which summation order decides (the f32
    # kernel and default one-process steps, two orders of the same step,
    # part by 7.0e-4 in the third loss on `build_state`'s piggymask)
    thr = base.threshold
    for k, v in base.tasks[2].piggymask.items():
        near = (v - thr).abs() < PAR_MASK_MARGIN
        side = torch.where(v >= thr, 1.0, -1.0)
        base.tasks[2].piggymask[k] = torch.where(
            near, thr + side * PAR_MASK_MARGIN, v)
    batches = _par_batches(torch, dev, cfg["batch"], arch)
    out = {"rank": rank, "mesh": repr(mesh), "launches_step": {},
           "losses": {}}
    total, firsts, steppers = None, {}, {}
    spy, seams = _seam_spy()

    def steps(run, st, label, check):
        losses = []
        _sync(torch, dev)
        counts.reset()
        for i, (x, y, draws) in enumerate(batches):
            spy(act and i == 0 and label == f"{par}_float32")
            try:
                losses.append(float(run(x, y, draws, i)["loss"]))
            finally:
                spy(False)
            if i == 0:
                _sync(torch, dev)
                out["launches_step"][label] = counts.read()
                firsts[label] = _train_tensors(gather_state(st),
                                               lambda t: t.clone())
            if check:
                check_replicas(st, mesh)
        _sync(torch, dev)
        out["losses"][label] = losses
        _no_forgetting(torch, base, gather_state(st), f"parallel {label}")
        return counts.read()

    flags = PP_FLAGS if pipe else KERNEL_FLAGS[arch]
    for dname in ("float32", "bfloat16"):
        tcfg = TrainConfig(compute_dtype=getattr(torch, dname), **flags)
        pcfg = tcfg
        if act:
            pcfg = dataclasses.replace(tcfg, act_sharder=act_sharder(
                mesh, tokens=True, experts=True))
        if pipe:
            depth = len({k.split("/")[1] for k in base.shared
                         if k.startswith("blocks/")})
            pcfg = dataclasses.replace(tcfg, pipeliner=make_pipeliner(
                mesh, pipe[1], depth, block_fn=functools.partial(
                    _default_block_fn, flash_attention=True)))
        st, run = _stepper(torch, base, model_fn, augment, dev, pcfg,
                           mesh=None if pipe else mesh, model_sharded=split)
        if split:
            out["held"] = _held(st)
        c = steps(run, st, f"{par}_{dname}", True)
        if act and dname == "float32":
            out["seams"] = list(seams)
        total = c if total is None else {k: total[k] + c[k] for k in c}
        steppers[dname] = run
        if rank == 0:
            st1, run1 = _stepper(torch, base, model_fn, augment, dev, tcfg)
            steps(run1, st1, f"single_{dname}", False)
            steppers[f"single_{dname}"] = run1
        if rank == 0 and dname == "float32":  # the yardstick's other order
            st1, run1 = _stepper(torch, base, model_fn, augment, dev,
                                 TrainConfig(compute_dtype=torch.float32))
            steps(run1, st1, "default_float32", False)
        barrier(mesh.group)
    out["launches"] = total
    if rank == 0:
        init = _train_tensors(base, lambda t: t)
        dist, ref_norm = _update_dists(torch, init, {
            "f32": firsts["single_float32"],
            f"{par}_float32": firsts[f"{par}_float32"],
            "single_bfloat16": firsts["single_bfloat16"],
            f"{par}_bfloat16": firsts[f"{par}_bfloat16"]})
        out.update(update_dist_to_f32=dist, f32_update_norm=ref_norm)
        # the piggymask's one-step update: Adam moves an entry by about
        # lr_mask whatever its gradient's size, so the update's sign shows
        # a wrong or missing reduction of the piggymask gradient; the f32
        # default step against the f32 kernel step (two summation orders
        # of one process) is the yardstick
        pm = {"moved": 0, "off": 0, "off_default": 0, "max_abs_diff": 0.0,
              "lr_mask": tcfg.lr_mask}
        for k, v in init.items():
            if k.startswith("piggymask/"):
                b = firsts["single_float32"][k]
                pm["moved"] += int((b != v).sum())
                for key, a in (("off", firsts[f"{par}_float32"][k]),
                               ("off_default", firsts["default_float32"][k])):
                    pm[key] += int((~torch.isclose(a, b, rtol=1e-4,
                                                   atol=1e-7)).sum())
                pm["max_abs_diff"] = max(pm["max_abs_diff"], float(
                    (firsts[f"{par}_float32"][k] - b).abs().max()))
        out["f32_piggymask"] = pm
    firsts.clear()

    def ms_per_step(run):
        x, y, draws = batches[0]
        for i in range(2):
            run(x, y, draws, i)
        _sync(torch, dev)
        t = time.perf_counter()
        for i in range(PAR_ROUND_STEPS):
            run(x, y, draws, i)
        _sync(torch, dev)
        return (time.perf_counter() - t) / PAR_ROUND_STEPS * 1e3

    barrier(mesh.group)
    out["ms_per_step_ranks"] = ms_per_step(steppers["bfloat16"])
    barrier(mesh.group)
    if rank == 0:  # the other ranks wait at the barrier
        out["ms_per_step_one_process"] = ms_per_step(
            steppers["single_bfloat16"])
    barrier(mesh.group)
    return out


# the launch counters of the products themselves (K1-K7); the select
# passes and the im2col pass are a route's, which a slice's shape may
# change (conv1's seam at 32 channels leaves the GEMM routes)
PRODUCT_KERNELS = ("masked_conv_fwd", "masked_conv_bwd_dx",
                   "masked_conv_bwd_dw", "fused_chain_fwd",
                   "fused_chain_bwd_dx", "fused_chain_bwd_dw",
                   "masked_matmul_fwd", "masked_matmul_bwd_dx",
                   "masked_matmul_bwd_dw", "flash_fwd", "flash_bwd",
                   "flash_bwd_dq", "flash_bwd_dkv")


def _par_label(cfg):
    """The steps' label of a `dp_ranks_check` configuration: "pp" (the
    pipeline), "sp" (split activations), "tp" (split kernels), "dp"."""
    if cfg.get("pipeline"):
        return "pp"
    if cfg.get("act_shard"):
        return "sp"
    return "tp" if cfg.get("n_model", 1) > 1 else "dp"


def _pp_launches(cfg, single):
    """The launches a pipeline step makes on each stage, from the
    one-process step's (`single`, its blocks' K7 once a block): every tick
    runs the stage's depth / S blocks (dead ticks too, masked), forward
    and backward, n_micro + S - 1 ticks."""
    stages, n_micro = cfg["pipeline"]
    return {k: v * (n_micro + stages - 1) // stages
            for k, v in single.items() if v}


def dp_ranks_check(torch, cfg, card):
    """Spawn one rank a device of cfg["devices"] (`_parallel_rank`), joined
    over cfg["backend"] (cfg["n_model"] ranks a model group, default 1), and
    hold their kernel steps (of cfg["arch"], default VGG16-BN) against the
    one-process step run by rank 0: f32 losses within PAR_F32_LOSS_RTOL and
    shared and private one-step updates within F32_UPDATE_RTOL of the
    update's norm (TP_F32_UPDATE_RTOL when every rank is in one model
    group or one pipeline), the piggymask's by PAR_MASK_OFF_SHARE against the f32
    default step's; bf16 losses within LOSS_RTOL and each group's update at
    most UPDATE_RATIO times as far from the f32 update as the one-process
    bf16 step's; every rank's losses equal, its launches a step the
    one-process step's (all counters data-parallel, the products K1-K7
    under a model axis; TRAIN_LAUNCHES in bf16); under a model axis each
    rank holding the slices of the split kernels. With cfg["act_shard"]
    (the tokens and experts split, `_parallel_rank_run`) every "tokens"
    seam must hand on T / n_model rows; with cfg["pipeline"] the data-
    parallel rules hold but the f32 updates' (TP_F32_UPDATE_RTOL: no data
    axis), and each stage's launches a step must be `_pp_launches` of the
    one-process step's. Returns the results and
    {"<arch>/parallel_rank<r>" (tp_rank<r>, sp_rank<r>, pp_rank<r>):
    launches}."""
    import torch.multiprocessing as mp

    world = len(cfg["devices"])
    arch = cfg.get("arch", "vgg16_bn_cifar")
    tp = cfg.get("n_model", 1) > 1
    par, pipe = _par_label(cfg), cfg.get("pipeline")
    launched = {}
    tmp = tempfile.mkdtemp(prefix="par_")
    try:
        mp.start_processes(_parallel_rank, args=(world, f"file://{tmp}/store",
                                                 cfg, tmp),
                           nprocs=world, start_method="spawn")
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    what = f"parallel {par} {arch}"
    for r in ranks[1:]:
        if r["losses"] != {k: v for k, v in r0["losses"].items()
                           if k.startswith(par + "_")}:
            raise AssertionError(f"{what}: rank {r['rank']}'s losses "
                                 f"{r['losses']} differ from rank 0's")
    lo = r0["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(lo[f"{par}_float32"], lo["single_float32"]))
    bf16_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(lo[f"{par}_bfloat16"], lo["single_bfloat16"]))
    if not all(np.isfinite(sum(lo.values(), []))):
        raise AssertionError(f"{what}: non-finite losses {lo}")
    if loss_rel > PAR_F32_LOSS_RTOL or bf16_rel > LOSS_RTOL:
        raise AssertionError(f"{what}: losses {lo}")
    dist, ref_norm = r0["update_dist_to_f32"], r0["f32_update_norm"]
    # a model axis alone or a pipeline sums no rows in another order: its
    # own bound
    rtol = (TP_F32_UPDATE_RTOL if pipe or (tp and world == cfg["n_model"])
            else F32_UPDATE_RTOL)
    f32_rel = {group: dist[f"{par}_float32"][group] / ref_norm[group]
               for group in ("shared", "private")}
    for group, rel in f32_rel.items():
        if rel > rtol:
            raise AssertionError(
                f"{what}: the f32 step's {group} update is "
                f"{dist[f'{par}_float32'][group]} from the one-process "
                f"step's, of norm {ref_norm[group]} (bound {rtol} of it)")
    pm = r0["f32_piggymask"]
    if (not pm["moved"]
            or pm["off"] > (UPDATE_RATIO * pm["off_default"]
                            + PAR_MASK_OFF_SHARE * pm["moved"])
            or pm["max_abs_diff"] > 3 * pm["lr_mask"]):
        raise AssertionError(f"{what}: the f32 step's piggymask update "
                             f"against the one-process step's: {pm}")
    for group, d in dist[f"{par}_bfloat16"].items():
        if d > (UPDATE_RATIO * dist["single_bfloat16"][group]
                + 1e-6 * ref_norm[group]):
            raise AssertionError(
                f"{what}: the bf16 step's {group} update is {d} from "
                "the f32 one-process step's, the bf16 one-process step's "
                f"{dist['single_bfloat16'][group]}")
    keys = PRODUCT_KERNELS if tp else None
    rows = {}
    for r in ranks:
        steps = r["launches_step"]
        if pipe:
            for dname in ("float32", "bfloat16"):
                want = _pp_launches(
                    cfg, r0["launches_step"][f"single_{dname}"])
                got = {k: v for k, v in steps[f"pp_{dname}"].items() if v}
                if got != want:
                    raise AssertionError(
                        f"{what}: rank {r['rank']}'s {dname} step launched "
                        f"{got}, not {want}")
            launched[f"{arch}/pp_rank{r['rank']}"] = r["launches"]
            continue
        if par == "sp":
            tokens = [sm for sm in r["seams"] if sm[0] == "tokens"]
            t = tokens[0][1][1]
            rows[r["rank"]] = {"T": t, "held": sorted({sm[2][1]
                                                       for sm in tokens}),
                               "seams": len(tokens)}
            if rows[r["rank"]]["held"] != [t // cfg["n_model"]]:
                raise AssertionError(f"{what}: rank {r['rank']}'s seams "
                                     f"{tokens}")
        for dname in ("float32", "bfloat16"):
            got, want = (
                {k: v for k, v in c.items() if keys is None or k in keys}
                for c in (steps[f"{par}_{dname}"],
                          r0["launches_step"][f"single_{dname}"]))
            if got != want:
                raise AssertionError(
                    f"{what}: rank {r['rank']}'s {dname} step launched "
                    f"{got}, the one-process step {want}")
        want = TRAIN_LAUNCHES[arch]
        if any(n != want.get(k, 0) for k, n in steps[f"{par}_bfloat16"].items()
               if keys is None or k in keys):
            raise AssertionError(f"{what}: rank {r['rank']}'s bf16 step "
                                 f"launched {steps[f'{par}_bfloat16']}")
        if par == "tp" and not (r["held"]["slices"] and r["held"]["split"]):
            raise AssertionError(f"{what}: rank {r['rank']} holds "
                                 f"{r['held']}")
        label = f"{par}_rank" if tp else "parallel_rank"
        launched[f"{arch}/{label}{r['rank']}"] = r["launches"]
    out = dict(
        devices=cfg["devices"], backend=cfg["backend"], arch=arch,
        n_model=cfg.get("n_model", 1), losses=lo,
        f32_loss_max_rel=loss_rel, bf16_loss_max_rel=bf16_rel,
        update_dist_to_f32=dist, f32_update_norm=ref_norm,
        f32_update_rel=f32_rel, f32_update_rtol=rtol,
        f32_piggymask=pm,
        ms_per_step_ranks={r["rank"]: r["ms_per_step_ranks"] for r in ranks},
        ms_per_step_one_process=r0["ms_per_step_one_process"],
        batch=cfg["batch"], card=card)
    if par == "tp":
        out["held"] = {r["rank"]: r["held"] for r in ranks}
    if par in ("tp", "sp", "pp"):
        out[f"launches_step_{par}_bf16"] = r0["launches_step"][
            f"{par}_bfloat16"]
    if par == "sp":
        out["rows"] = rows
    if pipe:
        out.update(pipeline=list(pipe), k7_launches_step_one_process={
            k: v for k, v in r0["launches_step"]["single_bfloat16"].items()
            if v})
    print(f"parallel ranks: {json.dumps(out)}", flush=True)
    out["launches_step"] = r0["launches_step"]
    return out, launched


def tp_routes(torch, dev, n_model=PAR_RANKS):
    """The route each kernel takes at VGG16-BN's 13 convs (width 1.0, batch
    BATCH) and vit_cifar's dense products, for the whole kernel and for one
    rank's slice over `n_model` ranks (a count that does not divide stays
    whole), as the route predicates decide from the shapes alone."""
    from cpg_tpu_torch.models.vgg import CFG_VGG16
    from cpg_tpu_torch.ops import fused_chain as fc
    from cpg_tpu_torch.ops import masked_conv as mc
    from cpg_tpu_torch.ops import masked_matmul as mm

    def part(c):
        return c // n_model if c % n_model == 0 else c

    bf, f32 = torch.bfloat16, torch.float32
    out, hw, cin, i, seam = {}, 32, 3, 0, False
    for v in CFG_VGG16:
        if v == "M":
            hw, seam = hw // 2, False
            continue
        x = torch.zeros((BATCH, hw, hw, cin), dtype=bf, device=dev)
        row = {}
        for label, cout in (("whole", v), ("slice", part(v))):
            # the weight each launch reads: the fused chain's selected bf16
            # weight, the masked conv's raw f32 one
            w = torch.zeros((3, 3, cin, cout), dtype=bf if seam else f32,
                            device=dev)
            if seam:
                row[label] = dict(
                    cout=cout, k4=fc.fwd_route(x, w, bf) or "k4",
                    k5=fc.dx_route(x, w, bf) or "k5", k6="k6")
            else:
                row[label] = dict(
                    cout=cout, k1_k2=mc.fwd_dx_route(x, w, 1, "SAME") or (
                        "stem+k2" if mc.stem_route(x, w, 1, "SAME")
                        else "k1"),
                    k3=mc.wgrad_conv_route(x, w, 1, "SAME") or "k3")
        out[f"vgg16_bn_cifar/conv{i}"] = row
        cin, seam, i = v, True, i + 1
    m = BATCH * 64
    for name, k, n in (("q|k|v|proj", 256, 256), ("fc1", 256, 1024),
                       ("fc2", 1024, 256)):
        x = torch.zeros((m, k), dtype=bf, device=dev)
        row = {}
        for label, nn in (("whole", n), ("slice", part(n))):
            w = torch.zeros((k, nn), dtype=f32, device=dev)
            own = torch.zeros((k, nn), dtype=torch.int8, device=dev)
            g = torch.zeros((m, nn), dtype=bf, device=dev)
            row[label] = dict(
                n=nn, k1=("select+gemm" if mm.gemm_route(x, w, own, w)
                          else "1x1"),
                k2="select+gemm" if mm.gemm_route(g, w, own, w) else "1x1",
                k3="wgmma" if mm.wgrad_route(x, g, w, own) else "1x1")
        out[f"vit_cifar/{name}"] = row
    return out


def _par_cli_argv(ck, extra=()):
    return ["sequence", "--num-tasks", "2", "--use-pallas-conv",
            "--fused-chain", "--synthetic-train-per-class",
            str(PAR_CLI_PER_CLASS), "--synthetic-test-per-class", "20",
            "--batch-size", str(BATCH // 2), "--finetune-epochs", "1",
            "--prune-epochs", "1", "--retrain-epochs", "1",
            "--prune-ratios", "0.5", "--network_width_multiplier",
            str(PAR_MULT), "--seed", str(SEED), "--checkpoint-dir", ck,
            *extra]


def parallel_phase(torch, dev, counts, card):
    """parallel/* on the card: the data axes, and the model axis on two
    ranks sharing the card (`dp_ranks_check` as (1, 2) for VGG16-BN and
    vit_cifar, and the route of each kernel's slice, `tp_routes`). Returns the
    results and {label: launches}: each rank's DP and TP steps, the
    `--parallel 1` run and the meshed server's requests."""
    from cpg_tpu_torch.core.invariants import check_state
    from cpg_tpu_torch.data.augment import cifar_eval_preprocess
    from cpg_tpu_torch.parallel.mesh import make_mesh
    from cpg_tpu_torch.serve import TaskServer
    from cpg_tpu_torch.utils.checkpoint import load_state

    t0 = time.perf_counter()
    # 1. two gloo ranks sharing the card
    rank_dev = (torch.device("cuda", torch.cuda.current_device())
                if dev.type == "cuda" else dev)
    two, launched = dp_ranks_check(torch, {
        "devices": [str(rank_dev)] * PAR_RANKS, "backend": "gloo",
        "mult": PAR_MULT, "batch": BATCH}, card)
    res = {"two_ranks": two}
    print(f"parallel ms/step, bf16 VGG16-BN kernel step at batch {BATCH}: "
          f"two gloo ranks sharing the card {two['ms_per_step_ranks']}, "
          f"one process {two['ms_per_step_one_process']:.2f} on {card}",
          flush=True)
    t_tp = time.perf_counter()

    # 1b. the model axis: the same two ranks as (data=1, model=2), each
    # holding its half of every kernel that divides; VGG16-BN's K1-K6 and
    # vit_cifar's dense K1-K3 and K7 on the slices
    res["tp"] = {"routes": tp_routes(torch, rank_dev)}
    for arch in ("vgg16_bn_cifar", "vit_cifar"):
        res["tp"][arch], more = dp_ranks_check(torch, {
            "devices": [str(rank_dev)] * PAR_RANKS, "backend": "gloo",
            "mult": PAR_MULT, "batch": BATCH, "arch": arch,
            "n_model": PAR_RANKS}, card)
        launched.update(more)
        held = res["tp"][arch]["held"][0]
        print(f"parallel tp {arch} (data=1, model={PAR_RANKS}, gloo, one "
              f"card): rank 0 holds {held['bytes']} of {held['whole_bytes']} "
              f"bytes of shared, ownership and piggymask ({held['split']} "
              f"of {held['kernels']} kernels split); ms/step, bf16 kernel "
              f"step at batch {BATCH}: two ranks "
              f"{res['tp'][arch]['ms_per_step_ranks']}, one process "
              f"{res['tp'][arch]['ms_per_step_one_process']:.2f} on {card}",
              flush=True)
    print(f"parallel tp routes (whole kernel, one rank's slice): "
          f"{json.dumps(res['tp']['routes'])}", flush=True)
    t1 = time.perf_counter()

    # 2. `sequence --parallel 1` over NCCL against the run without it
    tmp = tempfile.mkdtemp(prefix="par_cli_")
    try:
        _sync(torch, dev)
        counts.reset()
        rc1, s1 = _cli(_par_cli_argv(os.path.join(tmp, "p1"),
                                     ["--parallel", "1"]))
        _sync(torch, dev)
        launched["vgg16_bn_cifar/parallel_cli"] = counts.read()
        rc0, s0 = _cli(_par_cli_argv(os.path.join(tmp, "p0")))
        if rc1 or rc0 or s1 != s0:
            raise AssertionError(f"sequence --parallel 1: exit {rc1}, {s1}; "
                                 f"without it: exit {rc0}, {s0}")
        audits = {}
        for i, t in enumerate(s0["tasks"]):
            name = f"task{i + 1:02d}_{t['name']}"
            a, b = (load_state(os.path.join(tmp, d, name), device=dev)
                    for d in ("p1", "p0"))
            audits[name] = check_state(a)  # raises on a violation
            if not _same_state(torch, a, b):
                raise AssertionError(f"sequence --parallel 1: {name} differs "
                                     "from the run without the flag")
        res["cli_parallel_1"] = dict(summary=s1, check_state=audits,
                                     bit_equal=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"parallel sequence --parallel 1 (NCCL, one rank): "
          f"{json.dumps(res['cli_parallel_1'])}", flush=True)
    t2 = time.perf_counter()

    # 3. the server over [cuda:0, cuda:0] against the unmeshed one: the
    # unmeshed answers and launches first, then the meshed server's alone
    state = build_state(torch, dev, width_mult=PAR_MULT)
    ref = TaskServer(state, cifar_eval_preprocess, fused_chain=True,
                     device=dev)
    srv = TaskServer(state, cifar_eval_preprocess, fused_chain=True,
                     mesh=make_mesh(devices=[rank_dev] * 2))
    rng = np.random.RandomState(SEED + 11)
    reqs = [(tid, _inputs((32, 32, 3), n, rng))
            for n in PAR_SERVE_ROWS for tid in (1, 2)]
    mixed = [(1 + i % 2, reqs[2][1][i]) for i in range(len(reqs[2][1]))]
    serve = {"rows": {}, "bit_equal": True}
    try:
        for srv_ in (ref, srv):  # each task's effective weights, once
            srv_.warmup()
        _sync(torch, dev)
        counts.reset()
        wants = [ref.predict(tid, x) for tid, x in reqs]
        want_mixed = ref.predict_mixed(mixed)
        _sync(torch, dev)
        ref_launched = counts.read()
        counts.reset()
        gots = [srv.predict(tid, x) for tid, x in reqs]
        got_mixed = srv.predict_mixed(mixed)
        _sync(torch, dev)
        launched["vgg16_bn_cifar/parallel_serve"] = counts.read()
    finally:
        srv.close()
    # the same buckets as the unmeshed server's, each run as a shard on
    # each of the mesh's two devices
    got_launched = launched["vgg16_bn_cifar/parallel_serve"]
    if got_launched != {k: srv.mesh.size * n for k, n in ref_launched.items()}:
        raise AssertionError(
            f"meshed server launched {got_launched}, not {srv.mesh.size} x "
            f"the unmeshed server's {ref_launched}")
    for (tid, x), got, want in zip(reqs, gots, wants):
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        if got.shape != want.shape or err > 2e-2 * scale:
            raise AssertionError(f"meshed server: {len(x)} rows of "
                                 f"task {tid}: {err} of {scale}")
        serve["rows"][f"{len(x)}/task{tid}"] = err
        serve["bit_equal"] &= bool(np.array_equal(got, want))
    for got, want in zip(got_mixed, want_mixed):
        if np.abs(got - want).max() > 2e-2 * np.abs(want).max():
            raise AssertionError("meshed server: a mixed-task request")
    res["serve_mesh"] = dict(serve, min_bucket=srv.min_bucket)
    print(f"parallel server over [{rank_dev}, {rank_dev}]: "
          f"{json.dumps(res['serve_mesh'])}", flush=True)
    del state, ref, srv

    # 4. NCCL across cards
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards >= 2:
        res["nccl_cards"], more = nccl_cards_check(
            torch, ["cuda:0", "cuda:1"], card)
        launched.update(more)
    else:
        res["nccl_cards"] = (f"not run: {n_cards} card(s) visible; NCCL "
                             "across cards needs two")
        print(f"parallel NCCL across cards: {res['nccl_cards']}", flush=True)
    res["wall_s"] = {"two_ranks": t_tp - t0, "tp": t1 - t_tp, "cli": t2 - t1,
                     "serve_and_nccl": time.perf_counter() - t2}
    return res, launched


def act_shard_phase(torch, dev, card):
    """`act_sharder` on the card: each of ACT_SHARD_ARCHS' bf16 kernel
    steps (`use_pallas` + `flash_attention`: dense K1-K3 and K7) as (data=1,
    model=2) on two gloo ranks sharing the card, the kernels whole and the
    tokens (and vit_moe_cifar's experts, two a rank) split over the model
    group, held to the model axis's rules (`dp_ranks_check`). Returns the
    results and {label: launches}."""
    rank_dev = (torch.device("cuda", torch.cuda.current_device())
                if dev.type == "cuda" else dev)
    res, launched = {}, {}
    for arch in ACT_SHARD_ARCHS:
        res[arch], more = dp_ranks_check(torch, {
            "devices": [str(rank_dev)] * PAR_RANKS, "backend": "gloo",
            "mult": PAR_MULT, "batch": BATCH, "arch": arch,
            "n_model": PAR_RANKS, "act_shard": True}, card)
        launched.update(more)
        print(f"act_shard {arch} (data=1, model={PAR_RANKS}, gloo, one "
              f"card): rows a rank holds at the block boundaries "
              f"{json.dumps(res[arch]['rows'])}; ms/step, bf16 kernel step "
              f"at batch {BATCH}: two ranks {res[arch]['ms_per_step_ranks']}"
              f", one process {res[arch]['ms_per_step_one_process']:.2f} on "
              f"{card}", flush=True)
    return res, launched


def pipeline_phase(torch, dev, card):
    """`pipeline.py` on the card: vit_cifar's train step at width 1.0
    through `TrainConfig.pipeliner`, its 6 blocks as PP_STAGES stages of
    two gloo ranks sharing the card, PP_MICRO microbatches of the batch of
    BATCH, K7 in the blocks (`_default_block_fn(flash_attention=True)`),
    against the one-process inline step with K7, f32 (the data-parallel
    rules, the updates by TP_F32_UPDATE_RTOL) and bf16 (the 2x rule),
    replicas bit-equal after every step,
    K7's launches a step counted. Returns the results and {label:
    launches}."""
    rank_dev = (torch.device("cuda", torch.cuda.current_device())
                if dev.type == "cuda" else dev)
    res, launched = dp_ranks_check(torch, {
        "devices": [str(rank_dev)] * PP_STAGES, "backend": "gloo",
        "mult": PAR_MULT, "batch": BATCH, "arch": "vit_cifar",
        "pipeline": (PP_STAGES, PP_MICRO)}, card)
    print(f"pipeline vit_cifar ({PP_STAGES} stages, {PP_MICRO} "
          f"microbatches, gloo, one card): K7 launches a step per stage "
          f"{json.dumps({k: v for k, v in res['launches_step_pp_bf16'].items() if v})}, one process "
          f"{json.dumps(res['k7_launches_step_one_process'])}; ms/step, "
          f"bf16 at batch {BATCH}: two ranks {res['ms_per_step_ranks']}, "
          f"one process {res['ms_per_step_one_process']:.2f} on {card}",
          flush=True)
    return res, launched


def _cycle_of(summary):
    """A `sequence` summary's cycle: widths, names, ratios and growths."""
    return (summary["final_width_mult"],
            [(t["name"], t["ratio"], t["grew"]) for t in summary["tasks"]])


def _cli_states_agree(torch, a, b):
    """How far two runs' final states are apart, as
    tests/test_torch_port_parallel_cli.py measures it: the largest share
    of a layer's entries whose owner differs (entries at the prune cutoff
    may flip: the cutoff orders weights by magnitude), the largest
    difference of weights where the owners agree, over the layer's largest
    magnitude, and of BN statistics over max(1, their largest magnitude).
    The bounds are in PAR_CLI_FLOOR."""
    out = {"own_flip": 0.0, "shared": 0.0, "bn": 0.0}
    for k, w in b.shared.items():
        same = a.ownership[k] == b.ownership[k]
        out["own_flip"] = max(out["own_flip"],
                              1.0 - same.float().mean().item())
        err = (a.shared[k] - w).abs()[same].max() / w.abs().max()
        out["shared"] = max(out["shared"], err.item())
    for tid, t in b.tasks.items():
        for k, v in t.bn_state.items():
            err = (a.tasks[tid].bn_state[k] - v).abs().max()
            out["bn"] = max(out["bn"],
                            err.item() / max(1.0, v.abs().max().item()))
    return out


PP_CARDS = dict(arch="vit_b16", batch=64, pipeline=(4, 8))
                               # four cards: vit_b16's 12 blocks as 4
                               # stages of 3, 8 microbatches of 8
ACT_CLI_ORDERS = {"kernels": (), "dense": ("--flash-attention",),
                  "default": ("--use-pallas", "--flash-attention")}
                               # PAR_CLI_ORDERS for the transformers


def _act_cli_argv(ck, extra=()):
    return ["sequence", "--arch", "vit_moe_cifar", "--num-tasks", "2",
            "--use-pallas", "--flash-attention",
            "--synthetic-train-per-class", str(PAR_CLI_PER_CLASS),
            "--synthetic-test-per-class", "20", "--batch-size",
            str(BATCH // 2), "--finetune-epochs", "1", "--prune-epochs", "1",
            "--retrain-epochs", "1", "--prune-ratios", "0.5",
            "--network_width_multiplier", str(PAR_MULT), "--seed", str(SEED),
            "--checkpoint-dir", ck, *extra]


def _cli_against_orders(torch, devices, argv_of, orders, runs, card, what):
    """f32 `sequence` runs against `--parallel 1`'s: each of `runs`
    ({label: the flags beside --parallel}) spawned as a user runs it, the
    one-process orders in this process (`orders`: {label: flags dropped};
    the first is the run held against). The same cycle, and final states
    (`_cli_states_agree`) at most UPDATE_RATIO x as far apart as the
    farthest two orders, or within PAR_CLI_FLOOR. Returns the results."""
    from cpg_tpu_torch.utils.checkpoint import load_state

    f32 = ["--dtype", "float32", "--allow_acc_diff", "1.0"]
    tmp = tempfile.mkdtemp(prefix="par_nccl_")
    try:
        ones = {}
        for order, drop in orders.items():
            rc, ones[order] = _cli([a for a in argv_of(
                os.path.join(tmp, order), ["--parallel", "1", *f32])
                if a not in drop])
            if rc:
                raise AssertionError(f"{what} --parallel 1 ({order}): "
                                     f"exit {rc}")
        first = next(iter(orders))
        s1, summaries = ones[first], {}
        for label, flags in runs.items():
            p = subprocess.run(
                [sys.executable, "-m", "cpg_tpu_torch",
                 *argv_of(os.path.join(tmp, label), [*flags, *f32])],
                capture_output=True, text=True, timeout=900)
            if p.returncode:
                raise AssertionError(f"{what} {label} over NCCL: exit "
                                     f"{p.returncode}\n{p.stderr[-3000:]}")
            summaries[label] = json.loads(p.stdout.strip().splitlines()[-1])
            if _cycle_of(summaries[label]) != _cycle_of(s1):
                raise AssertionError(f"{what} {label}: {summaries[label]} "
                                     f"against {s1}")
        apart, yard = {label: {} for label in runs}, {}
        for i, t in enumerate(s1["tasks"]):
            name = f"task{i + 1:02d}_{t['name']}"
            st = {d: load_state(os.path.join(tmp, d, name),
                                device=devices[0])
                  for d in (*runs, *orders)}
            for label in runs:
                apart[label][name] = _cli_states_agree(torch, st[label],
                                                       st[first])
            names = list(orders)
            for j, a in enumerate(names):
                for b in names[j + 1:]:
                    yard[f"{name}/{a}-{b}"] = _cli_states_agree(
                        torch, st[a], st[b])
            del st
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bound = {m: max(floor, UPDATE_RATIO * max(y[m] for y in yard.values()))
             for m, floor in PAR_CLI_FLOOR.items()}
    print(f"parallel NCCL {what}, final states from --parallel 1's: "
          f"{json.dumps(apart)}, bound {json.dumps(bound)}, one process's "
          f"orders {json.dumps(yard)} on {card}", flush=True)
    for label, got in apart.items():
        if any(d[m] > bound[m] for d in got.values() for m in bound):
            raise AssertionError(f"{what} {label}: {got} from --parallel "
                                 f"1's, bound {bound} (one process's "
                                 f"orders: {yard})")
    return dict(summaries=summaries, against_parallel_1=s1,
                states_apart=apart, one_process_orders_apart=yard,
                bound=bound)


def nccl_cards_check(torch, devices, card, backend="nccl"):
    """Data, model and pipeline parallelism over NCCL across the cards
    `devices` (cuda:0..n-1):
      * "dp": the DP kernel step on one rank a card against the one-process
        step (`dp_ranks_check`);
      * "tp": the model axis's kernel step (`dp_ranks_check`: VGG16-BN as
        (n/2, 2), and with four cards vit_moe_cifar as (1, 4), each card
        one whole expert);
      * "pp" (four cards): vit_b16's pipeline over four NCCL ranks
        (PP_CARDS: 4 stages of 3 blocks, 8 microbatches, batch 64; K7 in
        the blocks) against the one-process inline step (`dp_ranks_check`
        with "pipeline");
      * "cli": f32 `sequence --parallel n` (the command spawns its ranks;
        every boundary's `check_replicas` runs in it) and
        `sequence --parallel n/2 --parallel-model 2` against `sequence
        --parallel 1`: the same cycle, and final states
        (`_cli_states_agree`) at most UPDATE_RATIO x as far apart as the
        farthest two of the one-rank runs under PAR_CLI_ORDERS (three
        summation orders of one process: a steadier yardstick than one
        pair, each pair's distance varying from call to call) or within
        PAR_CLI_FLOOR;
      * "act_shard_cli" (four cards): f32 `sequence --arch vit_moe_cifar
        --parallel 2 --parallel-model 2 --shard-activations` against
        `--parallel 1` by the "cli" rule, its orders ACT_CLI_ORDERS;
      * "serve": a bf16 server over the n cards (a weight replica a card)
        against the unmeshed one on the first at 1, 37 and 256 rows.
    With fewer than four cards the four-card parts print that they did not
    run. Returns the results and the ranks' launches. (`backend` "gloo"
    with CPU devices rehearses the steps.)"""
    from cpg_tpu_torch.data.augment import cifar_eval_preprocess
    from cpg_tpu_torch.parallel.mesh import make_mesh
    from cpg_tpu_torch.serve import TaskServer

    n = len(devices)
    out, launched = {}, {}
    out["dp"], ranks = dp_ranks_check(torch, {
        "devices": devices, "backend": backend, "mult": PAR_MULT,
        "batch": BATCH}, card)
    launched.update({k.replace("parallel_rank", "parallel_nccl_rank"): v
                     for k, v in ranks.items()})
    # the model axis over NCCL: VGG16-BN's kernel step as (n / 2, 2), and
    # with four cards vit_moe_cifar as (1, 4), one whole expert a card
    tp = {}
    tp["vgg16_bn_cifar"], ranks = dp_ranks_check(torch, {
        "devices": devices, "backend": backend, "mult": PAR_MULT,
        "batch": BATCH, "n_model": 2}, card)
    launched.update({k.replace("tp_rank", "tp_nccl_rank"): v
                     for k, v in ranks.items()})
    if n >= 4:
        tp["vit_moe_cifar"], ranks = dp_ranks_check(torch, {
            "devices": devices[:4], "backend": backend,
            "mult": PAR_MULT, "batch": BATCH, "arch": "vit_moe_cifar",
            "n_model": 4}, card)
        launched.update({k.replace("tp_rank", "tp_nccl_rank"): v
                         for k, v in ranks.items()})
        out["pp"], ranks = dp_ranks_check(torch, {
            "devices": devices[:4], "backend": backend, "mult": PAR_MULT,
            **PP_CARDS}, card)
        launched.update({k.replace("pp_rank", "pp_nccl_rank"): v
                         for k, v in ranks.items()})
    else:
        print(f"parallel NCCL: {n} cards, not four: vit_moe_cifar as "
              "(1, 4), the vit_b16 pipeline and the --shard-activations "
              "CLI did not run", flush=True)
    out["tp"] = tp
    tp_argv = ["--parallel", str(n // 2), "--parallel-model", "2"]
    cli = _cli_against_orders(
        torch, devices, _par_cli_argv, PAR_CLI_ORDERS,
        {"pn": ["--parallel", str(n)], "pt": tp_argv}, card, "sequence")
    out["cli"] = dict(cli, argv={"pn": f"--parallel {n}",
                                 "pt": " ".join(tp_argv)})
    if n >= 4:
        out["act_shard_cli"] = _cli_against_orders(
            torch, devices, _act_cli_argv, ACT_CLI_ORDERS,
            {"pa": ["--parallel", "2", "--parallel-model", "2",
                    "--shard-activations"]}, card,
            "sequence --arch vit_moe_cifar")
    state = build_state(torch, torch.device(devices[0]),
                        width_mult=PAR_MULT)
    ref = TaskServer(state, cifar_eval_preprocess, fused_chain=True,
                     device=devices[0])
    srv = TaskServer(state, cifar_eval_preprocess, fused_chain=True,
                     mesh=make_mesh(devices=devices))
    rng = np.random.RandomState(SEED + 11)
    serve = {}
    try:
        for rows in PAR_SERVE_ROWS:
            x = _inputs((32, 32, 3), rows, rng)
            got, want = srv.predict(2, x), ref.predict(2, x)
            err, scale = float(np.abs(got - want).max()), float(
                np.abs(want).max())
            if got.shape != want.shape or err > 2e-2 * scale:
                raise AssertionError(f"server over {devices}: {rows} "
                                     f"rows: {err} of {scale}")
            serve[rows] = dict(max_abs_err=err,
                               bit_equal=bool(np.array_equal(got, want)))
    finally:
        srv.close()
    out["serve"] = serve
    print(f"parallel NCCL across {n} cards: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("dp", "tp", "pp")})
        + f" on {card}", flush=True)
    return out, launched


def doctor_phase(card):
    """`python -m cpg_tpu_torch doctor --json` in a subprocess: exit 0 with
    the card's name, count, capability 9.0 and power limit in the report;
    the same command with no card visible (CUDA_VISIBLE_DEVICES empty)
    exits 1."""
    cmd = [sys.executable, "-m", "cpg_tpu_torch", "doctor", "--json",
           "--timeout", "120"]
    # both at once: each starts interpreters that take seconds to import
    # torch and reach the card
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                              env={**os.environ, **env})
             for env in ({}, {"CUDA_VISIBLE_DEVICES": ""})]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    (rc, rep), (rc0, rep0) = [
        (p.returncode, json.loads(o.strip().splitlines()[-1]))
        for p, o in zip(procs, outs)]
    d = rep.get("device", {})
    if (rc != 0 or d.get("count", 0) < 1 or d.get("capability") != [9, 0]
            or not d.get("name")
            or not any(card.split(",")[-1].strip() in line
                       for line in d.get("nvidia_smi") or [])):
        raise AssertionError(f"doctor: exit {rc}, {rep}")
    if rc0 != 1 or "CUDA" not in rep0["verdict"]:
        raise AssertionError(f"doctor without a visible card: exit {rc0}, "
                             f"{rep0['verdict']}")
    out = {"exit": rc, "device": d, "toolchains": rep["toolchains"],
           "verdict": rep["verdict"], "no_card_exit": rc0,
           "no_card_verdict": rep0["verdict"]}
    print("doctor: " + json.dumps(out), flush=True)
    return out


def kernels_line(rows, launched):
    """The kernels JSON line: each kernel's source, the TPU function it
    replaces, its launches over the phases, its largest error and its
    times and bound summed over one train step's shapes (VGG16-BN for
    the conv kernels, vit_cifar for the rest; ResNet-50's and
    SphereNet-20's steps apart in `resnet50_step` and `spherenet20_step`,
    with the library's product alone: `cudnn_device_ms` for the convs,
    `gemm_device_ms` for fc5)."""
    # conv K1 and K2: the GEMM routes' file (conv2/4/7/10 on the boxes;
    # ResNet-50's and SphereNet-20's convs past the stems on the dense GEMM
    # or the im2col walk), its header that holds the walk's kernel, then
    # the old kernel's (the stems, conv0, narrow widths, f32) under
    # "sources"; K3 likewise:
    # the wgrad GEMM's file (conv0 by im2col, conv2/4/7/10, dense bf16),
    # then the old kernel's (narrow widths, f32); K5: its file, then the
    # GEMM's header that holds its route's kernel
    meta = {
        "masked_conv_fwd": (("cpg_tpu_torch/csrc/masked_matmul.cu",
                             "cpg_tpu_torch/csrc/tma_gemm.cuh",
                             "cpg_tpu_torch/csrc/masked_conv_fwd.cu"),
                            "cpg_tpu/ops/pallas/masked_matmul.py:97"),
        "masked_conv_stem": ("cpg_tpu_torch/csrc/masked_conv_stem.cu",
                             "cpg_tpu/ops/pallas/masked_matmul.py:97"),
        "masked_conv_bwd_dx": (("cpg_tpu_torch/csrc/masked_matmul.cu",
                                "cpg_tpu_torch/csrc/tma_gemm.cuh",
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
            step = [(r, 1) for r in mine if r.get("on_path")
                    and r.get("arch") not in OWN_STEPS + SPLIT_STEPS]
        by = {}
        for r, k in step:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + k * r["bound_ms"]
        sources = (source,) if isinstance(source, str) else source
        own_steps = {}
        for arch in OWN_STEPS:
            rn = [(r, r["per_step"]) for r in mine if r.get("arch") == arch]
            # the launches of the arch's train step, as its train phase
            # counted them
            n = launched.get(f"{arch}/train", {}).get(name, 0)
            if rn or n:
                own_steps[f"{arch}_step"] = {
                    "launches": n, **{key: _step_sum(rn, key) for key in (
                        "ms", "device_ms", "plain_ms", "bound_ms",
                        "library_ms", "library_device_ms",
                        "cudnn_device_ms", "gemm_device_ms",
                        "gemm_kernel_device_ms", "gate_device_ms",
                        "im2col_device_ms") if rn}}
        # the VGG16-BN step's rows on the conv boxes (conv2/4/7/10) alone,
        # beside cuDNN's product on their pre-selected weights
        boxes = [(r, k) for r, k in step if r.get("route") == "select+gemm"]
        if boxes:
            own_steps["boxes_step"] = {key: _step_sum(boxes, key) for key in (
                "device_ms", "cudnn_device_ms")}
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
            **own_steps,
        })
    return kernels


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
    # conv0 in f32 holds the old K1 (off the stem route)
    rows += masked_conv_phase(torch, dev, "conv0", 32, 3, 64, "float32",
                              "binary", per_step=0)
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
    for name, hw, cin, cout in TP_MASKED_SHAPES:
        rows += masked_conv_phase(torch, dev, name, hw, cin, cout,
                                  "bfloat16", "binary", per_step=0)
        rows += masked_conv_bwd_phases(torch, dev, name, hw, cin, cout,
                                       "bfloat16", "binary",
                                       with_dx=name != "conv0_tp2",
                                       per_step=0)
    for name, hw, cin, cout, route4, route5 in TP_CHAIN_SHAPES:
        rows.append(fused_chain_phase(torch, dev, name, hw, cin, cout,
                                      "bfloat16", route4, per_step=0))
        rows += fused_chain_bwd_phases(torch, dev, name, hw, cin, cout,
                                       "bfloat16", route5, per_step=0)
    t_resnet = time.perf_counter()
    for name, hw, k, stride, cin, cout, per_step in RESNET_CONV_SHAPES:
        rows += conv_geometry_rows(torch, dev, "resnet50", RESNET_BATCH, name,
                                   (hw, hw), k, stride, _resnet_pads(k, stride),
                                   cin, cout, per_step,
                                   with_dx=name != "stem_7x7s2")
    for name, hw, c, per_step in RESNET_SEAMS:
        seam = [fused_chain_phase(torch, dev, name, hw, c, c, "bfloat16",
                                  "im2col", per_step, RESNET_BATCH)]
        seam += fused_chain_bwd_phases(torch, dev, name, hw, c, c, "bfloat16",
                                       "im2col", per_step, RESNET_BATCH)
        rows += [dict(r, arch="resnet50") for r in seam]
    t_resnet = time.perf_counter() - t_resnet
    t_sphere = time.perf_counter()
    for name, hw, stride, cin, cout, per_step in SPHERE_CONV_SHAPES:
        rows += conv_geometry_rows(torch, dev, "spherenet20", SPHERE_BATCH,
                                   name, hw, 3, stride,
                                   1 if stride == 2 else "SAME", cin, cout,
                                   per_step, with_dx=name != "stem_s2")
    name, m, kd, nd = SPHERE_FC5
    rows += [dict(r, arch="spherenet20") for r in dense_phases(
        torch, dev, name, m, kd, nd, "bfloat16", "binary", 1)]
    t_sphere = time.perf_counter() - t_sphere
    for name, n, t, h, hd, causal, dname, per_step, arch in FLASH_SHAPES:
        rows += [dict(r, arch=arch) for r in flash_phases(
            torch, dev, name, n, t, h, hd, causal, dname, per_step)]
    for name, m, kd, nd, dname, mode, per_step, arch in DENSE_SHAPES:
        rows += [dict(r, arch=arch) for r in dense_phases(
            torch, dev, name, m, kd, nd, dname, mode, per_step)]
    for r in rows:
        print("phase " + json.dumps(r), flush=True)
    t_kernels = time.perf_counter() - t_start

    counts = Counts()
    launched = {}  # phase -> kernel -> launches
    results = {}
    one_forward = {}
    spent = {}  # phase group -> wall seconds

    def lap(label, t0):
        spent[label] = time.perf_counter() - t0
        return time.perf_counter()

    for arch in ("vgg16_bn_cifar", "vit_cifar", "textcls", "vit_moe_cifar",
                 "resnet50", "spherenet20"):
        t_arch = time.perf_counter()
        state = build_state(torch, dev, arch)
        torch.cuda.synchronize()
        counts.reset()
        what = "the unfused server"
        if arch in ("vit_cifar", "textcls", "vit_moe_cifar"):
            serve_err, lat = vit_serve_phase(torch, dev, state, counts)
            what = "the f32 server"
        elif arch == "spherenet20":
            serve_err, lat = sphere_serve_phase(torch, dev, state, counts)
            what = "the f32 server"
        elif arch == "resnet50":
            serve_err, lat, one_forward = resnet_serve_phase(torch, dev,
                                                             state, counts)
        else:
            serve_err, lat = serve_phase(torch, dev, state)
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
        for key, line in train["timing"].items():
            if key.startswith("roofline_"):
                print(f"roofline {arch} {key[9:]}: " + json.dumps(
                    {k: line.get(k) for k in ("tflop_per_step",
                                              "mfu_vs_spec",
                                              "fraction_of_spec_floor")})
                    + f" on {card}", flush=True)
        results[arch] = dict(serve_max_abs_err=serve_err, serve_latency=lat,
                             eval_max_abs_err=eval_err, train=train)
        if arch == "resnet50":
            results[arch]["serve_one_forward_launches"] = one_forward
        if arch == "vit_cifar":
            qkv, launched[f"{arch}/qkv_fused"] = qkv_phase(torch, dev, state,
                                                           counts)
            results[arch]["qkv_fused"] = qkv
            print(f"qkv_fused {arch}: {json.dumps(qkv)} on {card}",
                  flush=True)
        del state
        torch.cuda.empty_cache()
        lap(arch, t_arch)
    t = time.perf_counter()
    cycle, launched["vgg16_bn_cifar/cycle"] = cycle_phase(torch, dev, counts)
    results["vgg16_bn_cifar"]["cycle"] = cycle
    print(f"cycle vgg16_bn_cifar: {json.dumps(cycle)} on {card}", flush=True)
    torch.cuda.empty_cache()
    deploy, launched["vgg16_bn_cifar/deploy"] = deploy_phase(torch, dev,
                                                             counts, card)
    results["vgg16_bn_cifar"]["deploy"] = deploy
    torch.cuda.empty_cache()
    t = lap("cycle+deploy", t)
    fg, launched["resnet50/finegrained"] = finegrained_phase(torch, dev,
                                                             counts, card)
    results["resnet50"]["finegrained"] = fg
    torch.cuda.empty_cache()
    t = lap("finegrained", t)
    stream, launched["resnet50/stream"] = stream_phase(torch, dev, counts,
                                                       card)
    results["resnet50"]["stream"] = stream
    torch.cuda.empty_cache()
    t = lap("stream", t)
    face, launched["spherenet20/face"] = face_phase(torch, dev, counts, card)
    results["spherenet20"]["face"] = face
    torch.cuda.empty_cache()
    t = lap("face", t)
    text, launched["textcls/cycle"] = text_phase(torch, dev, counts, card)
    results["textcls"]["cycle"] = text
    torch.cuda.empty_cache()
    t = lap("textcls_cycle", t)
    par, par_launched = parallel_phase(torch, dev, counts, card)
    launched.update(par_launched)
    results["vgg16_bn_cifar"]["parallel"] = par
    torch.cuda.empty_cache()
    t = lap("parallel", t)
    act, act_launched = act_shard_phase(torch, dev, card)
    launched.update(act_launched)
    results["act_shard"] = act
    t = lap("act_shard", t)
    pipe, pipe_launched = pipeline_phase(torch, dev, card)
    launched.update(pipe_launched)
    results["vit_cifar"]["pipeline"] = pipe
    t = lap("pipeline", t)
    results["doctor"] = doctor_phase(card)
    lap("doctor", t)
    # every phase that should reach a kernel did
    need = {"vgg16_bn_cifar/serve": ["fused_chain_fwd"],
            "vgg16_bn_cifar/eval": ["masked_conv_fwd", "masked_conv_select",
                                    "masked_conv_stem", "fused_chain_fwd"],
            "vgg16_bn_cifar/train": ["masked_conv_stem", "masked_conv_bwd_dx",
                                     "masked_conv_bwd_dw",
                                     "masked_conv_im2col",
                                     "fused_chain_bwd_dx",
                                     "fused_chain_bwd_dw"],
            "vit_cifar/eval": ["flash_fwd", "masked_matmul_fwd",
                               "masked_matmul_select"],
            "vit_cifar/train": ["flash_bwd", "masked_matmul_bwd_dx",
                                "masked_matmul_bwd_dw"],
            "vgg16_bn_cifar/deploy": ["fused_chain_fwd"],
            "resnet50/serve": ["fused_chain_fwd"],
            "resnet50/eval": ["masked_conv_fwd", "masked_conv_select",
                              "masked_conv_stem", "fused_chain_fwd"],
            "resnet50/train": ["masked_conv_stem", "masked_conv_bwd_dx",
                               "masked_conv_bwd_dw",
                               "masked_conv_select", "fused_chain_bwd_dx",
                               "fused_chain_bwd_dw"],
            "resnet50/finegrained": ["masked_conv_fwd", "masked_conv_stem",
                                     "masked_conv_bwd_dx",
                                     "masked_conv_bwd_dw",
                                     "masked_conv_select", "fused_chain_fwd",
                                     "fused_chain_bwd_dx",
                                     "fused_chain_bwd_dw"],
            "resnet50/stream": ["masked_conv_fwd", "masked_conv_stem",
                                "masked_conv_bwd_dx",
                                "masked_conv_bwd_dw", "masked_conv_select",
                                "fused_chain_fwd", "fused_chain_bwd_dx",
                                "fused_chain_bwd_dw"],
            "vit_cifar/qkv_fused": ["flash_fwd", "flash_bwd"],
            "vgg16_bn_cifar/cycle": ["masked_conv_fwd", "masked_conv_stem",
                                     "masked_conv_bwd_dx",
                                     "masked_conv_bwd_dw", "fused_chain_fwd",
                                     "fused_chain_bwd_dx",
                                     "fused_chain_bwd_dw"],
            "spherenet20/eval": SPHERE_EVAL_KERNELS,
            "spherenet20/train": SPHERE_TRAIN_KERNELS,
            "spherenet20/face": SPHERE_EVAL_KERNELS + SPHERE_TRAIN_KERNELS,
            # the transformers' servers run no port kernel (their serve
            # phases hold a forward to zero launches)
            "textcls/serve": [], "vit_moe_cifar/serve": [],
            "textcls/eval": DENSE_EVAL_KERNELS,
            "textcls/train": TEXT_TRAIN_KERNELS,
            "textcls/cycle": DENSE_EVAL_KERNELS + TEXT_TRAIN_KERNELS,
            "vit_moe_cifar/eval": DENSE_EVAL_KERNELS,
            "vit_moe_cifar/train": ["flash_bwd", "masked_matmul_bwd_dx",
                                    "masked_matmul_bwd_dw"],
            # each rank of the two-rank step, and `--parallel 1`: K1-K6
            **{f"vgg16_bn_cifar/parallel_{who}": [
                "masked_conv_fwd", "masked_conv_stem", "masked_conv_bwd_dx",
                "masked_conv_bwd_dw",
                "masked_conv_select", "masked_conv_im2col", "fused_chain_fwd",
                "fused_chain_bwd_dx", "fused_chain_bwd_dw"]
               for who in [f"rank{r}" for r in range(PAR_RANKS)] + ["cli"]},
            # each rank of the model axis's steps: VGG16-BN's K1-K6 and
            # vit_cifar's dense K1-K3 and K7, on the slices
            **{f"vgg16_bn_cifar/tp_rank{r}": [
                "masked_conv_fwd", "masked_conv_bwd_dx", "masked_conv_bwd_dw",
                "fused_chain_fwd", "fused_chain_bwd_dx", "fused_chain_bwd_dw"]
               for r in range(PAR_RANKS)},
            **{f"vit_cifar/tp_rank{r}": [
                "flash_fwd", "flash_bwd", "masked_matmul_fwd",
                "masked_matmul_bwd_dx", "masked_matmul_bwd_dw"]
               for r in range(PAR_RANKS)},
            # each rank of the act_shard phase's steps: the dense K1-K3
            # (proj, fc1, fc2 on its rows) and K7 at whole T (textcls's
            # hd 32 too on the one-launch backward); the pipeline's
            # stages: K7
            **{f"{arch}/sp_rank{r}": [
                "flash_fwd", "masked_matmul_fwd", "masked_matmul_bwd_dx",
                "masked_matmul_bwd_dw", "flash_bwd"]
               for arch in ACT_SHARD_ARCHS for r in range(PAR_RANKS)},
            **{f"vit_cifar/pp_rank{r}": ["flash_fwd", "flash_bwd"]
               for r in range(PP_STAGES)},
            "vgg16_bn_cifar/parallel_serve": ["fused_chain_fwd"]}
    for phase, names in need.items():
        for k in names:
            if launched[phase][k] == 0:
                raise AssertionError(f"{phase} phase launched no {k} kernel")
    print(f"launches: {json.dumps(launched)}", flush=True)

    kernels = kernels_line(rows, launched)
    wall = time.perf_counter() - t_start
    print(f"wall: {wall:.1f} s after the build ({t_kernels:.1f} s kernel "
          f"phases, {t_resnet:.1f} s of them ResNet-50's, {t_sphere:.1f} s "
          f"SphereNet-20's; then, s: "
          f"{json.dumps({k: round(v, 1) for k, v in spent.items()})})",
          flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "phases": rows, "results": results,
                   "launches": launched, "kernels": kernels, "wall_s": wall,
                   "phase_s": spent},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
