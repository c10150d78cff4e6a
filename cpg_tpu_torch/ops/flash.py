"""Flash attention: softmax(q k^T / sqrt(hd)) v without the score matrix in
device memory, forward and backward.

`flash_mha(q, k, v, causal=False)` is the counterpart of `cpg_tpu.ops.flash.
flash_mha` (the stock Pallas TPU flash-attention kernel with its custom
VJP): q, k, v are (N, T, H, hd), as models/vit.py's attention reshapes the
sdense outputs, and the result is (N, T, H, hd) in q's dtype. A
`torch.autograd.Function` saves q, k, v, the output o and the f32
log-sum-exp lse (N, H, T) of each query row, and the backward recomputes
the probabilities tile by tile from them.

On CUDA tensors it launches hand-written kernels that read (N, T, H, hd)
in place (a row of T is H*hd elements apart; no transpose to (N, H, T, hd)
and no padding copy: keys >= T are masked inside the kernel):

  * `csrc/flash_fwd.cu` (K7 forward): online softmax over 64-key tiles,
    writes o and lse; in bf16 a persistent grid (`fwd_grid`) whose blocks
    load the next tiles under the current ones' products;
  * `csrc/flash_bwd_wgmma.cu` (K7 backward on `bwd_route`: bf16, hd 32 or
    64, T <= 256): `flash_bwd`, one TMA + wgmma launch that forms S and dP
    once a tile, D inside, and writes dq, dk and dv, dq summed over
    128-key blocks in their order (`bwd_plan`: the walk, ring and
    persistent grid);
  * `csrc/flash_bwd.cu` (K7 backward off that route: f32, head dims 16
    and 128, T > 256): `flash_bwd_dq` (one block per 64-row query tile, looping over
    key tiles; it also writes D = rowsum(dO * o), which the second kernel
    reads) and `flash_bwd_dkv` (one block per 64-key tile, looping over
    query tiles).
  No float atomics: two runs give the same bits.

Rounding points follow the stock kernel: scores and softmax in f32, the
probabilities cast to v's dtype before P.V; in the backward p and ds are
cast to dO's dtype before each product, every sum in f32, and the results
cast to the inputs' dtypes last. Masked scores take the stock kernel's
mask value -0.7 * FLT_MAX. On CPU tensors the plain versions
`flash_mha_plain` and `flash_mha_bwd_plain` run; they materialise the f32
scores.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

# kernel launches since the last reset (set to 0 to start counting)
LAUNCHES = 0           # K7 forward
LAUNCHES_BWD_DQ = 0    # K7 backward, dQ (and D)
LAUNCHES_BWD_DKV = 0   # K7 backward, dK and dV
LAUNCHES_BWD = 0       # K7 backward on `bwd_route`: dQ, dK and dV in one

MASK_VALUE = -0.7 * torch.finfo(torch.float32).max
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_HEAD_DIMS = (16, 32, 64, 128)


def _scores(q, k, causal: bool):
    """f32 scaled scores (N, H, T, T) with masked entries at MASK_VALUE."""
    t, hd = q.shape[1], q.shape[3]
    s = torch.einsum("nthd,nshd->nhts", q.float(), k.float()) * (
        1.0 / math.sqrt(hd))
    if causal:
        tri = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(tri, s, MASK_VALUE)
    return s


def flash_mha_plain(q, k, v, causal: bool = False):
    """Plain version: (o, lse) with o (N, T, H, hd) in q's dtype and lse
    (N, H, T) f32; the probabilities exp(s - m) rounded to v's dtype before
    the product, the row sum and the normalisation in f32."""
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("nhts,nshd->nhtd", p.to(v.dtype).float(), v.float()) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


def _p_dp(q, k, v, lse, do, causal):
    """p and dp = dO v^T of the backward in f32, as the kernels form them."""
    p = torch.exp(_scores(q, k, causal) - lse.unsqueeze(-1))
    return p, torch.einsum("nthd,nshd->nhts", do.float(), v.float())


def _ds(p, dp, d, q, do):
    """ds rounded to dO's dtype, as the kernels round it before a product."""
    ds = (dp - d.unsqueeze(-1)) * p * (1.0 / math.sqrt(q.shape[3]))
    return ds.to(do.dtype).float()


def flash_mha_bwd_dq_plain(q, k, v, o, lse, do, causal: bool = False):
    """Plain version of the dQ kernel: (dq in q's dtype, D = rowsum(dO * o)
    f32 (N, H, T))."""
    d = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    p, dp = _p_dp(q, k, v, lse, do, causal)
    dq = torch.einsum("nhts,nshd->nthd", _ds(p, dp, d, q, do), k.float())
    return dq.to(q.dtype), d


def flash_mha_bwd_dkv_plain(q, k, v, do, lse, d, causal: bool = False):
    """Plain version of the dK/dV kernel: (dk, dv) in k's and v's dtypes."""
    p, dp = _p_dp(q, k, v, lse, do, causal)
    dv = torch.einsum("nhts,nthd->nshd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("nhts,nthd->nshd", _ds(p, dp, d, q, do), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_mha_bwd_plain(q, k, v, o, lse, do, causal: bool = False):
    """Plain backward: (dq, dk, dv) in the inputs' dtypes, with the stock
    kernel's rounding points (p, ds cast to dO's dtype before the
    products, f32 sums)."""
    dq, d = flash_mha_bwd_dq_plain(q, k, v, o, lse, do, causal)
    return (dq, *flash_mha_bwd_dkv_plain(q, k, v, do, lse, d, causal))


class _FlashMHA(torch.autograd.Function):
    """o = softmax(q k^T * s) v; residuals q, k, v, o and the f32 lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if bwd_route(q):
            return (*flash_bwd(q, k, v, o, lse, do, ctx.causal), None)
        dq, d = flash_bwd_dq(q, k, v, o, lse, do, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, d, ctx.causal)
        return dq, dk, dv, None


def flash_mha(q, k, v, *, causal: bool = False):
    """Multi-head attention, q, k, v (N, T, H, hd) -> (N, T, H, hd) in q's
    dtype, scores scaled by 1/sqrt(hd); `causal` lets query t see keys
    <= t. Differentiable in q, k and v."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_mha: q, k, v must share one (N, T, H, hd) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_mha: q, k, v must share one dtype")
    return _FlashMHA.apply(q, k, v, bool(causal))


# ------------------------------------------------------------- kernels ----

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: tensor pointers, then N, T, H, hd, causal, the stream
_ARGTYPES = {
    "flash_fwd": [_P] * 5 + [_I] * 5 + [_P],
    "flash_fwd_bf16": [_P] * 5 + [_I] * 6 + [_P],  # + the persistent grid
    "flash_bwd_dq": [_P] * 8 + [_I] * 5 + [_P],
    "flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_P],
    "flash_bwd_wgmma": [_P] * 9 + [_I] * 7 + [_P],  # + stages, grid
}
_LIBS = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd",
         "flash_bwd_dkv": "flash_bwd", "flash_bwd_wgmma": "flash_bwd_wgmma"}


def _fn(name, dtype):
    full = f"{name}_{_DTYPES[dtype]}"
    f = getattr(_build.load(_LIBS[name]), full)
    if f.argtypes is None:
        f.argtypes = _ARGTYPES.get(full, _ARGTYPES[name])
        f.restype = ctypes.c_int
    return f


# The bf16 forward kernel is persistent: a work item is one (image, query
# tile, head), and each block takes every grid-th item. A query tile is 16
# rows a warp: 8 warps (128 rows sharing each 64-key tile) when T > 64 and
# hd <= 64, else 4. Blocks an SM holds: its launch bound (3 blocks of 4
# warps at hd <= 64, else 2), or fewer where its shared memory (csrc/flash_fwd.cu
# `fwd_smem_bf16`: 2 stages of query + 128 key rows of hd + 8 bf16) does
# not fit 227 KB.
_KEY_ROWS, _STAGES_FWD, _SMEM_LIMIT = 64, 2, 232448


def fwd_warps(t: int, hd: int) -> int:
    return 8 if t > _KEY_ROWS and hd <= 64 else 4


def fwd_blocks_per_sm(t: int, hd: int) -> int:
    warps = fwd_warps(t, hd)
    smem = _STAGES_FWD * (16 * warps + 2 * _KEY_ROWS) * (hd + 8) * 2
    return max(1, min(3 if warps == 4 and hd <= 64 else 2,
                      _SMEM_LIMIT // (smem + 1024)))


@functools.lru_cache(maxsize=None)
def fwd_grid(n: int, t: int, h: int, hd: int, sms: int):
    """(work items, persistent grid) of the bf16 forward kernel on a card
    with `sms` SMs: at most blocks-per-SM x SMs blocks, cut so that every
    block takes the same number of items (the last one fewer)."""
    items = n * -(-t // (16 * fwd_warps(t, hd))) * h
    per = -(-items // (sms * fwd_blocks_per_sm(t, hd)))
    return items, -(-items // per)


# The one-launch backward (csrc/flash_bwd_wgmma.cu): two consumer
# warpgroups of 64 keys each and one producer warp a block, one block an
# SM. T <= 64: the PAIR walk, an item is two (image, head)s, one a
# warpgroup; else the BLOCK walk, an item is one (image, head) whose keys
# are walked in 128-key blocks, each over every 64-query tile. Shared
# memory: `bwd_smem_bytes`, the CUDA function of the same name, its tiles
# 64 rows of the head dim (hd 64: 128-byte rows; hd 32: 64-byte rows). The
# ring holds BWD_STAGES query tiles: scripts/torch_flash_bwd_plans.py
# found no deeper ring faster at vit_cifar, vit_b16 or the causal T = 70
# (deeper rings fit only at T <= 128).
BWD_HDS, _BWD_MAX_T, BWD_STAGES = (32, 64), 256, 2
_DS_TILE = 64 * 128  # bytes of the 64 x 64 bf16 dS^T tile


def bwd_route(q) -> bool:
    """Whether `flash_bwd` (the one-launch kernel) takes q's backward:
    bf16, hd 32 or 64, T <= 256 (vit_cifar's 64 and vit_b16's 196 at hd
    64, textcls's 64 at hd 32), causal or not. Everything else (f32, other
    head dims, longer T) runs `flash_bwd_dq` + `flash_bwd_dkv`."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] in BWD_HDS
            and q.shape[1] <= _BWD_MAX_T)


def bwd_smem_bytes(pair: bool, n_kb: int, n_qt: int, stages: int,
                   hd: int = 64) -> int:
    """Dynamic shared memory of the one-launch backward at head dim hd:
    alignment slack, K/V x 2, the ring, each warpgroup's dS^T, the dq
    staging tiles, BLOCK's f32 dQ hand-over and first-key-block dQ tiles
    (two key blocks), lse and D, the mbarriers."""
    tile = 64 * 2 * hd  # one 64-row bf16 tile of the head dim
    stage = (2 if pair else 1) * 3 * tile
    part = n_qt * 2 * tile if n_kb > 1 else 0
    return (1024 + 8 * tile + stages * stage + 2 * _DS_TILE
            + (2 if pair else 1) * tile + (0 if pair else 2 * tile) + part
            + 2 * _BWD_MAX_T * 4 + 2 * 2 * 64 * 4 + 16 * stages + 32)


class BwdPlan(NamedTuple):
    pair: bool   # the PAIR walk (T <= 64)
    n_kb: int    # 128-key blocks an item (PAIR: 1)
    n_qt: int    # 64-query tiles an item
    items: int   # PAIR: (image, head) pairs; else (image, head)s
    stages: int  # query tiles in the ring
    grid: int    # persistent blocks, each taking every grid-th item
    smem: int


@functools.lru_cache(maxsize=None)
def bwd_plan(n: int, t: int, h: int, hd: int, sms: int) -> BwdPlan:
    """The one-launch backward's walk and persistent grid on a card with
    `sms` SMs (at most one block an SM, cut so that every block takes the
    same number of items, the last ones fewer)."""
    if hd not in BWD_HDS or not 1 <= t <= _BWD_MAX_T:
        raise ValueError(f"flash_bwd: no plan for T = {t}, hd = {hd}")
    pair = t <= 64
    n_qt = -(-t // 64)
    n_kb = 1 if pair else -(-t // 128)
    items = -(-(n * h) // 2) if pair else n * h
    per = -(-items // sms)
    return BwdPlan(pair, n_kb, n_qt, items, BWD_STAGES, -(-items // per),
                   bwd_smem_bytes(pair, n_kb, n_qt, BWD_STAGES, hd))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def supported(q) -> bool:
    """The kernels' predicate: bf16 or f32, a head dim of 16, 32, 64 or
    128 (vit_cifar and vit_b16: 64)."""
    return q.dtype in _DTYPES and q.shape[-1] in _HEAD_DIMS


def _checked(**tensors):
    """Contiguous views of the (N, T, H, hd) tensors after the kernels'
    checks; raises on what the kernels do not take."""
    q = tensors["q"]
    if not q.is_cuda:
        raise ValueError(f"flash kernel: q must be a CUDA tensor, got {q.device}")
    if not supported(q):
        raise ValueError(f"flash kernel: unsupported {q.dtype}, head dim "
                         f"{q.shape[-1]} (needs bf16 or f32, hd in {_HEAD_DIMS})")
    out = {}
    for name, t in tensors.items():
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"flash kernel: {name} must match q "
                             f"({tuple(q.shape)} {q.dtype} on {q.device})")
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel: {name} must be 16-byte aligned")
        out[name] = t
    return out


def _checked_lse(q, a):
    """An (N, H, T) f32 row statistic (lse or D) of q's attention."""
    n, tt, h, _ = q.shape
    if a.shape != (n, h, tt) or a.dtype != torch.float32 or a.device != q.device:
        raise ValueError(f"flash kernel: lse and D must be f32 {(n, h, tt)} "
                         f"on {q.device}")
    return a.contiguous()


def _raise_on(err, name):
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def flash_fwd(q, k, v, causal: bool = False):
    """K7 forward: (o, lse); the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, causal)
    t = _checked(q=q, k=k, v=v)
    n, tt, h, hd = q.shape
    o = torch.empty((n, tt, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, tt), dtype=torch.float32, device=q.device)
    if o.numel():
        grid = ()
        if q.dtype == torch.bfloat16:
            grid = (fwd_grid(n, tt, h, hd, _sm_count(q.device.index))[1],)
        err = _build.launch(_fn("flash_fwd", q.dtype), q,
            t["q"].data_ptr(), t["k"].data_ptr(), t["v"].data_ptr(),
            o.data_ptr(), lse.data_ptr(), n, tt, h, hd, int(causal), *grid)
        _raise_on(err, "flash_fwd")
        LAUNCHES += 1
    return o, lse


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool = False):
    """The dQ kernel: (dq in q's dtype, D = rowsum(dO * o) f32 (N, H, T),
    which the dK/dV kernel reads); the plain version on CPU tensors."""
    global LAUNCHES_BWD_DQ
    if q.device.type == "cpu":
        return flash_mha_bwd_dq_plain(q, k, v, o, lse, do, causal)
    t = _checked(q=q, k=k, v=v, o=o, do=do)
    lse = _checked_lse(q, lse)
    n, tt, h, hd = q.shape
    dq = torch.empty_like(t["q"])
    d = torch.empty((n, h, tt), dtype=torch.float32, device=q.device)
    if dq.numel():
        err = _build.launch(_fn("flash_bwd_dq", q.dtype), q,
            t["q"].data_ptr(), t["k"].data_ptr(), t["v"].data_ptr(),
            t["o"].data_ptr(), t["do"].data_ptr(), lse.data_ptr(),
            dq.data_ptr(), d.data_ptr(), n, tt, h, hd, int(causal))
        _raise_on(err, "flash_bwd_dq")
        LAUNCHES_BWD_DQ += 1
    return dq, d


def flash_bwd_dkv(q, k, v, do, lse, d, causal: bool = False):
    """The dK/dV kernel: (dk, dv) in k's and v's dtypes, from D of
    `flash_bwd_dq`; the plain version on CPU tensors."""
    global LAUNCHES_BWD_DKV
    if q.device.type == "cpu":
        return flash_mha_bwd_dkv_plain(q, k, v, do, lse, d, causal)
    t = _checked(q=q, k=k, v=v, do=do)
    lse, d = _checked_lse(q, lse), _checked_lse(q, d)
    n, tt, h, hd = q.shape
    dk, dv = torch.empty_like(t["k"]), torch.empty_like(t["v"])
    if dk.numel():
        err = _build.launch(_fn("flash_bwd_dkv", q.dtype), q,
            t["q"].data_ptr(), t["k"].data_ptr(), t["v"].data_ptr(),
            t["do"].data_ptr(), lse.data_ptr(), d.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), n, tt, h, hd, int(causal))
        _raise_on(err, "flash_bwd_dkv")
        LAUNCHES_BWD_DKV += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal: bool = False):
    """K7 backward in one launch on `bwd_route` shapes: (dq, dk, dv) in the
    inputs' dtype; the plain version on CPU tensors. Raises on a CUDA
    tensor off the route."""
    global LAUNCHES_BWD
    if q.device.type == "cpu":
        return flash_mha_bwd_plain(q, k, v, o, lse, do, causal)
    if not bwd_route(q):
        raise ValueError(f"flash_bwd: off its route ({q.dtype}, T = "
                         f"{q.shape[1]}, hd = {q.shape[-1]}): needs bf16, "
                         f"hd in {BWD_HDS}, T <= {_BWD_MAX_T}")
    t = _checked(q=q, k=k, v=v, o=o, do=do)
    lse = _checked_lse(q, lse)
    n, tt, h, hd = q.shape
    dq, dk, dv = (torch.empty_like(t[x]) for x in ("q", "k", "v"))
    if dq.numel():
        plan = bwd_plan(n, tt, h, hd, _sm_count(q.device.index))
        err = _build.launch(_fn("flash_bwd_wgmma", q.dtype), q,
            t["q"].data_ptr(), t["k"].data_ptr(), t["v"].data_ptr(),
            t["o"].data_ptr(), t["do"].data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), n, tt, h, hd,
            int(causal), plan.stages, plan.grid)
        _raise_on(err, "flash_bwd")
        LAUNCHES_BWD += 1
    return dq, dk, dv
