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

dw and dpm (K3) take, for bf16 x and g with K and N multiples of 8
(`wgrad_route`), `csrc/masked_matmul_wgrad.cu`: a split-M TMA + wgmma GEMM
G = x^T g with both operands MN-major, the splits summed in a fixed order
by a gate pass that applies the ownership gating (with one split, the
GEMM's epilogue gates) (`launch_wgrad`, planned by `wgrad_plan`);
otherwise (f32, other widths) `csrc/masked_conv_bwd_dw.cu` at the 1x1
geometry. On CPU tensors
the plain versions run. This module keeps its own launch counters.

The masked conv's GEMM route (`masked_conv.conv_route`) launches the same
select pass and the same GEMM, whose producer walks the conv's taps
(`launch_conv_gemm`, planned by `conv_plan`), and the same weight-gradient
GEMM over per-tap boxes of x (`launch_wgrad_conv`); its im2col route
(`masked_conv.fwd_dx_route`) the same select pass and the GEMM's sibling
over TMA im2col loads (`launch_conv_im2col`, planned by `im2col_plan`), and
the weight-gradient GEMM over the same loads (`launch_wgrad_im2col`); it
counts in `masked_conv`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from . import masked_conv as _mc
from ..utils.roofline import SPEC
from .binarize import DEFAULT_THRESHOLD
from .masked import effective_kernel

# kernel launches of the dense route since the last reset
LAUNCHES = 0          # forward: the TN GEMM, or K1 at 1x1
LAUNCHES_BWD_DX = 0   # dx: the TN GEMM, or K2 at 1x1
LAUNCHES_BWD_DW = 0   # K3: the wgrad GEMM, or K3 at 1x1
LAUNCHES_SELECT = 0   # the select pass (one before each GEMM)

# the GEMM's tiles: 128 rows (two consumer warpgroups of 64), 64 deep a
# stage, BN wide; shared memory a block on the H100
GEMM_BM, GEMM_BK = 128, 64
GEMM_BNS = (192, 128, 64)
GEMM_MAX_STAGES = 5
SMEM_PER_BLOCK = 232448

# K4 and K5 on the conv GEMM route: their tile widths (192 would spill in
# K5's epilogue at the 168 registers nine warps leave), the deepest rings
# (deeper ones gained nothing in scripts/torch_fused_chain_plans.py's
# sweep) and K4's activated halo buffers
FUSED_BNS = (128, 64)
FWD_MAX_STAGES = 6
DX_MAX_STAGES = 8
FWD_HALOS = 2
# the most halo pixels K4's CUDA entry takes (its pixel division is exact
# below 2,048)
FWD_MAX_HALO_PX = 2048

# the weight-gradient GEMM's tiles: 128 k-rows (two consumer warpgroups of
# 64) by BN output columns; a stage reduces 64 rows of a dense product or
# 128 pixels of a conv (one 4-D box, or one im2col load a 64-row half)
WGRAD_BK = 128
WGRAD_BNS = (128, 64)
WGRAD_DENSE_ROWS, WGRAD_CONV_ROWS = 64, 128
WGRAD_MAX_STAGES = 6
# at most this many pixels a split: one f32 accumulator chain (a 262,144-
# pixel chain at conv0 was 3e-4 of max|G| from the plain version)
WGRAD_MAX_SPLIT_ROWS = 16384
# the split counts a plan may take (the ladder the cost model was fitted on)
WGRAD_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
# `wgrad_plan`'s cost model, fitted to scripts/torch_wgrad_plans.py's sweep
# on an H100 (every product there was bound by its operand loads): the
# operand bytes an SM loads a second from L2, alone and all active SMs
# together, and the HBM rate at which the partials (written, then read by
# the gate pass) and the gated outputs (w and own read, dw and dpm
# written: 13 B an entry) move
_WG_SM_BPS = 60e9
_WG_L2_BPS = 7e12
_HBM_BPS = SPEC["hbm_gbps"] * 1e9

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
def gemm_plan(m: int, r: int, nout: int, sms: int, bns=GEMM_BNS,
              max_stages: int = GEMM_MAX_STAGES, smem=gemm_smem_bytes):
    """(bn, stages, grid) of the TN GEMM: of the tile widths `bns`, the one
    that finishes the output in the least work a block, counted as the
    waves of tiles a block walks times the rows it loads a stage (128 of A
    and bn of B), ties to the wider tile (fewer A passes); as many ring
    stages as `smem(bn, stages)` fits, up to `max_stages` and no fewer than
    2; one persistent block an SM, no more than the tiles. The defaults
    are K1/K2's; K4 and K5 pass their own widths, rings and layouts
    (`fused_fwd_plan`, `fused_dx_plan`)."""
    tiles_m = -(-m // GEMM_BM)

    def cost(bn):
        tiles = tiles_m * -(-nout // bn)
        return -(-tiles // sms) * (GEMM_BM + bn), -bn

    bn = min(bns, key=cost)
    stages = max_stages
    while stages > 2 and smem(bn, stages) > SMEM_PER_BLOCK:
        stages -= 1
    _check(smem(bn, stages) <= SMEM_PER_BLOCK,
           f"no {bn}-wide GEMM plan fits shared memory")
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


@functools.lru_cache(maxsize=None)
def im2col_plan(n: int, ah: int, aw: int, oh: int, ow: int, kh: int,
                kw: int, stride: int, pads: tuple, c: int, nout: int,
                dgrad: bool, sms: int):
    """(phases, bn, stages, grid) of the masked conv's implicit GEMM over
    im2col loads (`launch_conv_im2col`): the activation (n, ah, aw, c), the
    output grid (oh, ow) with nout channels, the forward's `pads` (top,
    bottom, left, right).

    A phase is (rows, columns, lower_w, lower_h, row0, col0, taps), each tap
    (id = dh * kw + dw, offset_w, offset_h): its output pixel (img, i, j)
    reads the activation at (lower_h + i * t + offset_h, lower_w + j * t +
    offset_w), t the traversal stride (the conv's for the forward, 1 for
    dx). The forward is one phase over (oh, ow) with lower corner (-pad_left,
    -pad_top) and the taps in order. dx at stride 1 is one phase over (oh,
    ow) = (H, W) reading g with the taps mirrored: offsets (kw - 1 - dw,
    kh - 1 - dh), lower corner (pad_left - kw + 1, pad_top - kh + 1). dx at
    stride 2 is four phases (a, b) = (ih % 2, iw % 2), most taps first, each
    (ceil((H - a) / 2), ceil((W - b) / 2)) pixels stored at dx's (a + 2 i,
    b + 2 j), reduced over the taps with (a + pad_top - dh) and (b +
    pad_left - dw) even: g row (a + pad_top - dh) / 2 + i, so the lower
    corner is the least of those offsets and each tap's offset the rest; a
    phase no tap reaches (1x1 at 2: three of four) is zeros. bn, stages and
    grid are `gemm_plan`'s over every phase's 128-pixel tiles and R =
    kh * kw * c."""
    pt, _, pl, _ = pads
    if not dgrad:
        phases = [(oh, ow, -pl, -pt, 0, 0,
                   tuple((dh * kw + dw, dw, dh) for dh in range(kh)
                         for dw in range(kw)))]
    elif stride == 1:
        phases = [(oh, ow, pl - kw + 1, pt - kh + 1, 0, 0,
                   tuple((dh * kw + dw, kw - 1 - dw, kh - 1 - dh)
                         for dh in range(kh) for dw in range(kw)))]
    else:
        phases = []
        for a in range(stride):
            for b in range(stride):
                dhs = [(dh, (a + pt - dh) // stride) for dh in range(kh)
                       if (a + pt - dh) % stride == 0]
                dws = [(dw, (b + pl - dw) // stride) for dw in range(kw)
                       if (b + pl - dw) % stride == 0]
                lh = min((e for _, e in dhs), default=0)
                lw = min((e for _, e in dws), default=0)
                phases.append((-(-(oh - a) // stride), -(-(ow - b) // stride),
                               lw, lh, a, b,
                               tuple((dh * kw + dw, ew - lw, eh - lh)
                                     for dh, eh in dhs for dw, ew in dws)))
        # the most taps first: the persistent blocks end on the light tiles
        phases.sort(key=lambda ph: -len(ph[-1]))
    tiles_m = sum(-(-n * r * q // GEMM_BM) for r, q, *_ in phases)
    return (tuple(phases),
            *gemm_plan(max(tiles_m, 1) * GEMM_BM, kh * kw * c, nout, sms))


def fused_dx_smem_bytes(bn: int, stages: int) -> int:
    """Dynamic shared memory of one K5 block on the conv GEMM route, as
    `gemm_smem_bytes(bn, stages, EPI_FUSED_DX)` in csrc/tma_gemm.cuh lays
    it out: the GEMM's, plus x's 128 x bn bf16 tile and its two
    barriers."""
    return gemm_smem_bytes(bn, stages) + GEMM_BM * bn * 2 + 16


@functools.lru_cache(maxsize=None)
def fused_dx_im2col_plan(n: int, h: int, w: int, cin: int, cout: int,
                         sms: int):
    """(phases, bn, stages, grid) of K5 on its im2col route, at any grid:
    `im2col_plan`'s stride-1 dgrad phase over g (one phase of the h x w
    grid, the taps mirrored), Cout reduction channels a tap and Cin output
    channels; `gemm_plan` over FUSED_BNS with up to DX_MAX_STAGES ring
    stages beside x's tile (`fused_dx_smem_bytes`). The cost model takes BN
    = 64 where the 128-wide tiles would leave most SMs idle: at ResNet-50's
    7x7 seam at batch 32, 13 pixel tiles x 4 channel tiles of 128 are 52
    blocks for 132 SMs, and 8 of 64 are 104, one wave either way, each
    block loading 192 rather than 256 rows a stage."""
    phases = im2col_plan(n, h, w, h, w, 3, 3, 1, (1, 1, 1, 1), cout, cin,
                         True, sms)[0]
    return (phases, *gemm_plan(n * h * w, 9 * cout, cin, sms, FUSED_BNS,
                               DX_MAX_STAGES, fused_dx_smem_bytes))


@functools.lru_cache(maxsize=None)
def fused_dx_plan(n: int, h: int, w: int, cin: int, cout: int, sms: int):
    """(box, bn, stages, grid) of K5 on the conv GEMM route: the dgrad
    product over g's box (`masked_conv.conv_box` of the n x h x w grid),
    Cout reduction channels a tap and Cin output channels; `gemm_plan`
    over FUSED_BNS with up to DX_MAX_STAGES ring stages beside x's tile
    (`fused_dx_smem_bytes`)."""
    box = _mc.conv_box(h, w)
    _check(box is not None, f"no 128-pixel TMA box tiles a {h}x{w} grid")
    return (box, *gemm_plan(n * h * w, 9 * cout, cin, sms, FUSED_BNS,
                            DX_MAX_STAGES, fused_dx_smem_bytes))


@functools.lru_cache(maxsize=None)
def fused_fwd_halo(h: int, w: int):
    """(box, split) of K4's halo at an h x w grid. A tile is 128 consecutive
    output pixels, starting at a multiple of 128: within its row at a
    multiple of gcd(128, w), within its image at one of gcd(128, h * w).
    `rows` is the most rows of one image a tile touches; where that is all
    h rows the box (64, w, h, imgs) holds the most images a tile touches,
    whole, loaded from row -1 (split 0). Otherwise the box (64, w, rows, 1)
    holds one image's rows from the tile's first row - 1, and where a tile
    can run into the next image (h * w not a multiple of 128) a second box
    of that image's first rows lands `split` pixels after the first one's
    start (the first box's pixels rounded up to 8, one 1,024-byte swizzle
    phase). On every grid `masked_conv.conv_box` tiles this is its box with
    split 0. ResNet-50's seams: 56x56 (rows 4, split 352), 28x28 (6, 240),
    14x14 (10, 192), 7x7 (whole images, 4 a box)."""
    rows = min(h, 1 + (w - math.gcd(GEMM_BM, w) + GEMM_BM - 1) // w)
    if rows == h:
        hw = h * w
        return (GEMM_BK, w, h, 1 + (hw - math.gcd(GEMM_BM, hw)
                                    + GEMM_BM - 1) // hw), 0
    split = -(-(w + 2) * (rows + 2) // 8) * 8 if (h * w) % GEMM_BM else 0
    return (GEMM_BK, w, rows, 1), split


def fused_halo_px(box, split: int = 0) -> int:
    """Pixels of one K4 halo buffer: the box's (w + 2) x (rows + 2) x
    images, or with a split the second box's after it."""
    _, w, rows, imgs = box
    px = (w + 2) * (rows + 2)
    return split + px if split else px * imgs


def fused_halo_bytes(box, split: int = 0) -> int:
    """Bytes of one K4 halo buffer for the output tile's TMA box (64, w,
    rows, images) and split (`fused_fwd_halo`): `fused_halo_px` pixels of
    128 B, rounded up to the 128-byte swizzle's 1,024 B."""
    return -(-fused_halo_px(box, split) * 128 // 1024) * 1024


def fused_fwd_smem_bytes(bn: int, stages: int, halo: int) -> int:
    """Dynamic shared memory of one K4 block on the route, as
    `fwd_smem_bytes` in csrc/fused_chain_fwd.cu lays it out: 1 KB of
    alignment slack, FWD_HALOS halo buffers, the ring of bn x 64 weight
    stages, the 128 x bn bf16 output staging, two barriers a stage and
    three a halo buffer (landed, activated, read)."""
    return (1024 + FWD_HALOS * halo + stages * bn * GEMM_BK * 2
            + GEMM_BM * bn * 2 + 16 * stages + 24 * FWD_HALOS)


def _fused_fwd_bns(h: int, w: int):
    """K4's tile widths whose two-stage ring fits beside two halo buffers
    of an h x w grid (56x56: 64 only)."""
    halo = fused_halo_bytes(*fused_fwd_halo(h, w))
    return tuple(bn for bn in FUSED_BNS
                 if fused_fwd_smem_bytes(bn, 2, halo) <= SMEM_PER_BLOCK)


def fused_fwd_fits(h: int, w: int) -> bool:
    """Whether K4's route can run an h x w grid: the halo box
    (`fused_fwd_halo`) is within TMA's 256 a dimension and the CUDA
    entry's FWD_MAX_HALO_PX pixels, and two halo buffers with a two-stage
    ring of some tile width fit shared memory, so that `fused_fwd_plan`
    finds a plan. Every VGG16-BN and ResNet-50 seam grid does; a 1x1 grid
    (128 images a box, 147,456 B a halo) does not."""
    box, split = fused_fwd_halo(h, w)
    _, bw, rows, imgs = box
    return (max(bw, rows) + 2 <= 256 and imgs <= 256
            and fused_halo_px(box, split) <= FWD_MAX_HALO_PX
            and bool(_fused_fwd_bns(h, w)))


@functools.lru_cache(maxsize=None)
def fused_fwd_plan(n: int, h: int, w: int, cin: int, cout: int, sms: int):
    """(box, bn, stages, grid, halo bytes) of K4 on its route
    (`csrc/fused_chain_fwd.cu` `fused_chain_fwd_gemm_bf16`): the halo's box
    (`fused_fwd_halo`; on the grids `masked_conv.conv_box` tiles, its box),
    FWD_HALOS buffers of it; `gemm_plan` over the tile widths that fit
    (FUSED_BNS, at 56x56 64 alone) with up to FWD_MAX_STAGES weight stages
    beside the halos (`fused_fwd_smem_bytes`). Raises where
    `fused_fwd_fits` is false."""
    _check(fused_fwd_fits(h, w), f"no K4 plan fits a {h}x{w} grid")
    box, split = fused_fwd_halo(h, w)
    halo = fused_halo_bytes(box, split)
    return (box, *gemm_plan(n * h * w, 9 * cin, cout, sms,
                            _fused_fwd_bns(h, w), FWD_MAX_STAGES,
                            lambda bn, st: fused_fwd_smem_bytes(bn, st, halo)),
            halo)


def wgrad_smem_bytes(bn: int, rows: int, stages: int) -> int:
    """Dynamic shared memory of one wgrad block, as `wgrad_smem_bytes` in
    csrc/masked_matmul_wgrad.cu lays it out: 1 KB of alignment slack, the
    ring of {A 2 x 64 x rows, B bn x rows} bf16 stages, two barriers a
    stage."""
    return 1024 + stages * (WGRAD_BK + bn) * rows * 2 + 16 * stages


@functools.lru_cache(maxsize=None)
def wgrad_plan(m: int, k: int, n: int, sms: int,
               rows: int = WGRAD_DENSE_ROWS):
    """(bn, splits, stages, grid) of the weight-gradient GEMM G (k, n) =
    x^T g reduced over m pixels, `rows` a step (64 dense, 128 conv).

    Items are (128 x bn tile, split of the steps); one persistent block an
    SM walks them. The plan takes the (bn, split count) of least estimated
    time: for each round of items the blocks walk together, the steps of a
    split times a step's operand bytes over the rate each active SM gets
    from L2 (its own limit, or its share of the whole); plus the gated
    outputs and, with more than one split, the f32 partials written and
    read again by the gate pass, at the HBM rate. The split count comes
    from WGRAD_SPLITS (or the fewest that keep each split within
    WGRAD_MAX_SPLIT_ROWS pixels); splits are whole steps and none is
    empty; ties go to fewer splits, then the wider tile. As many ring
    stages as fit, up to WGRAD_MAX_STAGES; the grid is at most the SM
    count."""
    steps = -(-m // rows)
    tiles_k = -(-k // WGRAD_BK)
    least = -(-steps // (WGRAD_MAX_SPLIT_ROWS // rows))
    best = None
    for bn in WGRAD_BNS:
        tiles = tiles_k * -(-n // bn)
        step_bytes = rows * (WGRAD_BK + bn) * 2
        for want in sorted({max(least, s) for s in WGRAD_SPLITS}):
            per = -(-steps // min(want, steps))
            splits = -(-steps // per)  # none empty
            items = tiles * splits
            grid = min(items, sms)
            t = k * n * 13 / _HBM_BPS
            for r0 in range(0, items, grid):  # the rounds of items
                active = min(grid, items - r0)
                t += per * step_bytes / min(_WG_SM_BPS, _WG_L2_BPS / active)
            if splits > 1:
                t += 2 * items * WGRAD_BK * bn * 4 / _HBM_BPS
            key = (t, splits, -bn)
            if best is None or key < best[0]:
                best = (key, bn, splits, grid)
    _, bn, splits, grid = best
    stages = WGRAD_MAX_STAGES
    while wgrad_smem_bytes(bn, rows, stages) > SMEM_PER_BLOCK - 1024:
        stages -= 1
    return bn, splits, stages, grid


def wgrad_route(x, g, w, own) -> bool:
    """Whether dense K3 on the card takes the wgrad GEMM: bf16 x and g, K
    and N multiples of 8 (TMA's 16-byte row strides), x and g 16-byte, w
    8-byte and own 2-byte aligned (the epilogue's pair loads). Otherwise
    K3 runs at the 1x1 geometry."""
    return (x.dtype == torch.bfloat16 and g.dtype == torch.bfloat16
            and w.shape[0] % 8 == 0 and w.shape[1] % 8 == 0
            and x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
            and w.data_ptr() % 8 == 0 and own.data_ptr() % 2 == 0)


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
    """(dw, dpm) for output gradient g (M, N): on CUDA tensors the wgrad
    GEMM (`wgrad_route`) or K3 at 1x1, on CPU tensors the plain version."""
    if x.device.type == "cpu":
        return masked_matmul_bwd_dw_plain(g, x, w, own, task_id)
    global LAUNCHES_BWD_DW
    if wgrad_route(x, g, w, own):
        dw, dpm = launch_wgrad(x, g, w, own, int(task_id))
    else:
        x4, w4, own4 = _as_conv(x, w, own)
        dw, dpm = _mc.launch_bwd_dw(g.reshape(g.shape[0], 1, 1, g.shape[1]),
                                    x4, w4, own4, int(task_id), 1, "VALID")
        dw, dpm = dw.reshape(w.shape), dpm.reshape(w.shape)
    LAUNCHES_BWD_DW += 1
    return dw, dpm


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
        lib.masked_conv_im2col_gemm_bf16.argtypes = (
            [_P] * 3 + [_I] * 10 + [ctypes.POINTER(_I)] + [_I] * 4 + [_P])
        lib.masked_conv_im2col_gemm_bf16.restype = ctypes.c_int
    return lib


def _check(cond, msg):
    if not cond:
        raise ValueError(f"masked_matmul kernel: {msg}")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    err = _build.launch(_lib().masked_matmul_select_bf16, w,
        w.data_ptr(), own.data_ptr(), pm.data_ptr(), out.data_ptr(), k, n,
        int(task_id), float(threshold), int(mask_mode == "ternary"),
        int(transpose))
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
    err = _build.launch(_lib().masked_matmul_gemm_tn_bf16, a,
        a.data_ptr(), bt.data_ptr(), c.data_ptr(), m, r, nout, bn, stages,
        grid)
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
    err = _build.launch(_lib().masked_conv_gemm_bf16, a,
        a.data_ptr(), bt.data_ptr(), out.data_ptr(), n, ah, aw, ch, oh, ow,
        nout, kh, kw, pad_top, pad_left, int(dgrad), box_h, box_n, bn,
        stages, grid)
    if err:
        raise RuntimeError(f"masked_conv_gemm launch failed: CUDA error {err}")
    return out


# a phase's row in csrc/tma_gemm.cuh's table (`make_im2col_walk`): rows,
# columns, the lower corner (w, h), dx's first row and column, the tap
# count, then nine taps
_MAX_TAPS = 9


def phase_table(phases):
    """`im2col_plan`'s phases as the C table of the im2col walks."""
    flat = []
    for rows, cols, lw, lh, r0, c0, tp in phases:
        flat += [rows, cols, lw, lh, r0, c0, len(tp)]
        flat += [i | o_w << 8 | o_h << 16 for i, o_w, o_h in tp]
        flat += [0] * (_MAX_TAPS - len(tp))
    return (_I * len(flat))(*flat)


def launch_conv_im2col(a, bt, grid_hw, kh, kw, stride, pads, dgrad):
    """The masked conv's implicit GEMM over im2col loads, any output grid,
    stride 1 or 2, planned by `im2col_plan`. Forward: y (N, Ho, Wo, Cout)
    from a = x (N, H, W, Cin) and bt = w_eff^T (Cout, kh*kw*Cin). dgrad: dx
    (N, H, W, Cin) from a = g (N, Ho, Wo, Cout) and bt = w_eff (kh*kw*Cin,
    Cout). grid_hw is the output's (rows, columns); pads and stride are the
    forward's."""
    _check(a.is_cuda and bt.device == a.device,
           f"a and bt must be on one CUDA device, got {a.device}, {bt.device}")
    _check(a.dtype == bt.dtype == torch.bfloat16, "a and bt must be bf16")
    _check(a.dim() == 4 and bt.dim() == 2, "a must be NHWC and bt 2-D")
    _check(a.is_contiguous() and bt.is_contiguous(), "a and bt must be contiguous")
    _check(stride in (1, 2) and kh * kw <= _MAX_TAPS,
           f"stride {stride} and {kh}x{kw} taps: the walk takes stride 1 or "
           f"2 and at most {_MAX_TAPS} taps")
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
    phases, bn, stages, grid = im2col_plan(
        n, ah, aw, oh, ow, kh, kw, stride, tuple(pads), ch, nout, bool(dgrad),
        _sms(a.device.index or 0))
    err = _build.launch(_lib().masked_conv_im2col_gemm_bf16, a,
        a.data_ptr(), bt.data_ptr(), out.data_ptr(), n, ah, aw, ch, oh, ow,
        nout, taps, stride, int(dgrad), phase_table(phases), len(phases), bn,
        stages, grid)
    if err:
        raise RuntimeError(f"masked_conv_im2col_gemm launch failed: CUDA error {err}")
    return out


# ------------------------------------------------ weight-gradient GEMM ----
# `launch_wgrad*` check their inputs and launch csrc/masked_matmul_wgrad.cu's
# GEMM (and, with more than one split, its gate pass) on the current stream;
# they count nothing.

def _wlib():
    lib = _build.load("masked_matmul_wgrad")
    if lib.masked_matmul_wgrad_bf16.argtypes is None:
        lib.masked_matmul_wgrad_bf16.argtypes = [_P] * 7 + [_I] * 9 + [_P]
        lib.masked_matmul_wgrad_bf16.restype = ctypes.c_int
        lib.masked_conv_wgrad_bf16.argtypes = [_P] * 7 + [_I] * 18 + [_P]
        lib.masked_conv_wgrad_bf16.restype = ctypes.c_int
        lib.masked_conv_wgrad_im2col_bf16.argtypes = [_P] * 7 + [_I] * 17 + [_P]
        lib.masked_conv_wgrad_im2col_bf16.restype = ctypes.c_int
        lib.masked_conv_im2col_bf16.argtypes = [_P] * 2 + [_I] * 12 + [_P]
        lib.masked_conv_im2col_bf16.restype = ctypes.c_int
    return lib


def _wgrad_buffers(w, k, n, bn, splits):
    """dw, dpm (w's shape, f32) and the partials' scratch."""
    tiles = -(-k // WGRAD_BK) * -(-n // bn)
    ws = torch.empty(splits * tiles * WGRAD_BK * bn if splits > 1 else 4,
                     dtype=torch.float32, device=w.device)
    dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    return dw, torch.empty_like(dw), ws


def _check_wgrad(x, g, w, own):
    _check(x.is_cuda, f"x must be a CUDA tensor, got {x.device}")
    _check(x.dtype == g.dtype == torch.bfloat16, "x and g must be bf16")
    _check(w.dtype == torch.float32 and own.dtype == torch.int8
           and own.shape == w.shape, "w must be f32 and own int8 of w's shape")
    for name, t in (("g", g), ("w", w), ("own", own)):
        _check(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("g", g), ("w", w), ("own", own)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
           and w.data_ptr() % 8 == 0 and own.data_ptr() % 2 == 0,
           "x and g must be 16-byte aligned, w 8-byte, own 2-byte")


def launch_wgrad(x, g, w, own, task_id, plan=None):
    """Dense K3 on the wgrad GEMM: G = x[:, :K]^T g, f32 sums, then dw = G on
    own == task, dpm = G * w on 0 < own < task. x (M, Kx) with Kx >= K (the
    columns past K are conv0's zero padding), g (M, N), bf16; w, own (K, N).
    `plan` overrides `wgrad_plan` (the tests' other grids)."""
    _check_wgrad(x, g, w, own)
    _check(x.dim() == 2 and g.dim() == 2 and w.dim() == 2
           and x.shape[0] == g.shape[0] and x.shape[1] >= w.shape[0]
           and g.shape[1] == w.shape[1],
           f"x {tuple(x.shape)}, g {tuple(g.shape)} and w {tuple(w.shape)} "
           "are not (M, Kx >= K), (M, N) and (K, N)")
    (m, kx), (k, n) = x.shape, w.shape
    _check(kx % 8 == 0 and n % 8 == 0,
           f"x's columns and N must be multiples of 8, got {(kx, n)}")
    if m == 0 or k == 0 or n == 0:
        z = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        return z, z.clone()
    bn, splits, stages, grid = plan or wgrad_plan(
        m, k, n, _sms(x.device.index or 0), WGRAD_DENSE_ROWS)
    dw, dpm, ws = _wgrad_buffers(w, k, n, bn, splits)
    err = _build.launch(_wlib().masked_matmul_wgrad_bf16, x,
        x.data_ptr(), g.data_ptr(), w.data_ptr(), own.data_ptr(),
        ws.data_ptr(), dw.data_ptr(), dpm.data_ptr(), m, kx, k, n,
        int(task_id), bn, splits, stages, grid)
    if err:
        raise RuntimeError(f"masked_matmul_wgrad launch failed: CUDA error {err}")
    return dw, dpm


def wgrad_conv_plan(n: int, ho: int, wo: int, cin: int, cout: int,
                    taps: int, sms: int):
    """(box, bn, splits, stages, grid) of the conv's weight-gradient
    GEMM: x's TMA box (64 channels, wo, rows, images) of 128 output pixels
    (`masked_conv.conv_box`) and `wgrad_plan` over M = n*ho*wo pixels in
    128-pixel steps, K = taps * cin, N = cout."""
    box = _mc.conv_box(ho, wo)
    _check(box is not None, f"no 128-pixel TMA box tiles a {ho}x{wo} grid")
    return (box, *wgrad_plan(n * ho * wo, taps * cin, cout, sms,
                             WGRAD_CONV_ROWS))


def launch_wgrad_conv(g, x, w, own, task_id, pad_top, pad_left, plan=None):
    """Conv K3 at stride 1 on the wgrad GEMM, each k tile's x read as per-tap
    4-D TMA boxes of the NHWC input (the padding by TMA's zero fill): x (N,
    H, W, Cin), g (N, Ho, Wo, Cout) bf16, w, own HWIO. Cin % 64 == 0, Cout %
    8 == 0, the output grid tiled by `masked_conv.conv_box`. Returns dw, dpm
    HWIO f32. `plan` overrides `wgrad_conv_plan`."""
    _check_wgrad(x, g, w, own)
    _check(x.dim() == 4 and g.dim() == 4 and w.dim() == 4,
           "x and g must be NHWC and w HWIO")
    kh, kw, cin, cout = w.shape
    n, h, wd, c = x.shape
    ho, wo = g.shape[1:3]
    _check(c == cin and g.shape[0] == n and g.shape[3] == cout,
           f"x {tuple(x.shape)}, g {tuple(g.shape)} and w {tuple(w.shape)} "
           "do not match")
    _check(cin % 64 == 0 and cout % 8 == 0,
           f"Cin must be a multiple of 64 and Cout of 8, got {(cin, cout)}")
    (_, _, box_h, box_n), bn, splits, stages, grid = plan or \
        wgrad_conv_plan(n, ho, wo, cin, cout, kh * kw, _sms(x.device.index or 0))
    dw, dpm, ws = _wgrad_buffers(w, kh * kw * cin, cout, bn, splits)
    err = _build.launch(_wlib().masked_conv_wgrad_bf16, x,
        x.data_ptr(), g.data_ptr(), w.data_ptr(), own.data_ptr(),
        ws.data_ptr(), dw.data_ptr(), dpm.data_ptr(), n, h, wd, cin, ho, wo,
        cout, kh, kw, pad_top, pad_left, box_h, box_n, int(task_id), bn,
        splits, stages, grid)
    if err:
        raise RuntimeError(f"masked_conv_wgrad launch failed: CUDA error {err}")
    return dw, dpm


def launch_wgrad_im2col(g, x, w, own, task_id, stride, pads, plan=None):
    """Conv K3 at any output grid, stride 1 or 2, on the wgrad GEMM, each
    k tile's x read by TMA im2col loads of 128 consecutive output pixels
    (the forward's map; the padding and the pixels past the last image by
    TMA's zero fill): x (N, H, W, Cin), g (N, Ho, Wo, Cout) bf16, w, own
    HWIO, pads the forward's (top, bottom, left, right). Cin % 64 == 0, Cout
    % 8 == 0. Returns dw, dpm HWIO f32. `plan` overrides `wgrad_plan` over M
    = N*Ho*Wo pixels in 128-pixel steps, K = kh*kw*Cin, N = Cout."""
    _check_wgrad(x, g, w, own)
    _check(x.dim() == 4 and g.dim() == 4 and w.dim() == 4,
           "x and g must be NHWC and w HWIO")
    kh, kw, cin, cout = w.shape
    n, h, wd, c = x.shape
    pt, pb, pl, pr = pads
    ho, wo = (h + pt + pb - kh) // stride + 1, (wd + pl + pr - kw) // stride + 1
    _check(c == cin and tuple(g.shape) == (n, ho, wo, cout),
           f"x {tuple(x.shape)}, g {tuple(g.shape)} and w {tuple(w.shape)} "
           f"do not match at stride {stride} and pads {tuple(pads)}")
    _check(cin % 64 == 0 and cout % 8 == 0,
           f"Cin must be a multiple of 64 and Cout of 8, got {(cin, cout)}")
    _check(stride in (1, 2), f"stride {stride}: the walk takes 1 or 2")
    bn, splits, stages, grid = plan or wgrad_plan(
        n * ho * wo, kh * kw * cin, cout, _sms(x.device.index or 0),
        WGRAD_CONV_ROWS)
    dw, dpm, ws = _wgrad_buffers(w, kh * kw * cin, cout, bn, splits)
    err = _build.launch(_wlib().masked_conv_wgrad_im2col_bf16, x,
        x.data_ptr(), g.data_ptr(), w.data_ptr(), own.data_ptr(),
        ws.data_ptr(), dw.data_ptr(), dpm.data_ptr(), n, h, wd, cin, ho, wo,
        cout, kh, kw, stride, pt, pl, int(task_id), bn, splits, stages, grid)
    if err:
        raise RuntimeError(f"masked_conv_wgrad_im2col launch failed: CUDA error {err}")
    return dw, dpm


def launch_im2col(x, kh, kw, stride, pads, kp):
    """The patches of x (N, H, W, C) bf16 as (N*Ho*Wo, kp) bf16: column k =
    (dh*kw + dw)*C + c, zero in the padding and past kh*kw*C (kp a multiple
    of 8)."""
    _check(x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4
           and x.is_contiguous(), "x must be a contiguous NHWC bf16 CUDA tensor")
    n, h, wd, c = x.shape
    pt, pb, pl, pr = pads
    ho, wo = (h + pt + pb - kh) // stride + 1, (wd + pl + pr - kw) // stride + 1
    _check(kp % 8 == 0 and kp >= kh * kw * c,
           f"kp {kp} must be a multiple of 8 and >= {kh * kw * c}")
    out = torch.empty((n * ho * wo, kp), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    err = _build.launch(_wlib().masked_conv_im2col_bf16, x,
        x.data_ptr(), out.data_ptr(), n, h, wd, c, ho, wo, kh, kw, stride, pt,
        pl, kp)
    if err:
        raise RuntimeError(f"masked_conv_im2col launch failed: CUDA error {err}")
    return out


def im2col_plain(x, kh, kw, stride, pads, kp):
    """Plain version of `launch_im2col`."""
    n, h, wd, c = x.shape
    pt, pb, pl, pr = pads
    ho, wo = (h + pt + pb - kh) // stride + 1, (wd + pl + pr - kw) // stride + 1
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    cols = [xp[:, dh:dh + stride * (ho - 1) + 1:stride,
               dw:dw + stride * (wo - 1) + 1:stride] for dh in range(kh)
            for dw in range(kw)]
    p = torch.cat(cols, -1).reshape(n * ho * wo, kh * kw * c)
    return torch.nn.functional.pad(p, (0, kp - kh * kw * c))
