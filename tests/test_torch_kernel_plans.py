"""The Python planning of the redesigned kernels, on the CPU.

K6 (`fused_chain.k6_plan`) picks the image rows a step and the split count
of the bf16 dW kernel; K7 forward (`flash.fwd_grid`) sizes the persistent
grid of the bf16 flash forward; K7's one-launch backward (`flash.bwd_plan`)
picks its walk, ring depth and persistent grid, and `flash.bwd_route`
decides which backward passes take it; the dense route's TN GEMM
(`masked_matmul.gemm_plan`) picks its tile width, ring depth and
persistent grid, and `masked_matmul.gemm_route` decides which products
take it; the masked conv's implicit GEMM (`masked_matmul.conv_plan`) adds
the TMA box of 128 output pixels, and `masked_conv.conv_route` decides
which convs take it; the weight-gradient GEMM (`masked_matmul.wgrad_plan`,
`wgrad_conv_plan`) picks its tile width, split count, ring depth and grid,
and `wgrad_route`, `masked_conv.conv_route` and
`masked_conv.im2col_route` decide which weight gradients take it. All feed
launch parameters straight to a CUDA kernel, so these
tests hold them, for every VGG16-BN seam and the ViT shapes, to what the
kernels assume: steps of whole image rows that never straddle an image
where a halo is staged, every row, work item and output tile covered
exactly once, a grid within CUDA's limits and the SM count, and scratch
and shared memory within the card's.
"""

import pytest
import torch

from cpg_tpu_torch.ops import flash as fl
from cpg_tpu_torch.models import vgg
from cpg_tpu_torch.ops import fused_chain as fc
from cpg_tpu_torch.ops import masked_conv as mc
from cpg_tpu_torch.ops import masked_matmul as mm

H100_SMS = 132
SMEM_PER_SM = 233472      # 228 KB, of which 1 KB is reserved per block
SMEM_PER_BLOCK = 232448   # 227 KB

# (n, h = w, cin, cout) of VGG16-BN's eight fused seams at batch 256
VGG_SEAMS = [(256, 32, 64, 64), (256, 16, 128, 128), (256, 8, 256, 256),
             (256, 4, 512, 512), (256, 2, 512, 512)]
K6_EDGES = [(3, 3, 5, 24, 72), (2, 1, 1, 8, 8), (1, 5, 7, 8, 24),
            (1, 3, 5, 520, 24), (2, 7, 5, 520, 8), (1, 32, 32, 64, 64),
            (4, 2, 128, 8, 8)]


def _k6_smem(rows, h, w):
    """Shared memory of one K6 block, as csrc/fused_chain_bwd_dw.cu's
    `smem_bytes` lays it out (3 stages of g [pk][72] and raw x [staged][32]
    bf16, act [staged + 1][40] bf16, a and b for 32 channels)."""
    staged = (rows + (2 if rows < h else 0)) * w
    pk = -(-rows * w // 16) * 16
    return (3 * (pk * 72 + staged * 32) + (staged + 1) * 40) * 2 + 2 * 32 * 4


def _k6_cases():
    return ([(n, hw, hw, ci, co) for n, hw, ci, co in VGG_SEAMS] + K6_EDGES)


@pytest.mark.parametrize("case", _k6_cases())
def test_k6_plan_covers_every_row_once(case):
    n, h, w, cin, cout = case
    rows, splits = fc.k6_plan(n, h, w, cin, cout)
    assert 1 <= rows * w <= 128
    # a step is within one image (halo form) or whole images
    assert (rows < h and h % rows == 0) or rows % h == 0
    G = n * h
    chunks = -(-G // rows)
    per = -(-chunks // splits)
    covered = []
    for split in range(splits):
        steps = range(split * per, min(chunks, (split + 1) * per))
        assert len(steps) > 0, "an empty split"
        for c in steps:
            covered += [r for r in range(c * rows, (c + 1) * rows) if r < G]
            if rows < h:
                assert (c * rows) // h == (c * rows + rows - 1) // h
    assert covered == list(range(G))


@pytest.mark.parametrize("case", _k6_cases())
def test_k6_plan_fits_the_card(case):
    n, h, w, cin, cout = case
    rows, splits = fc.k6_plan(n, h, w, cin, cout)
    tiles = -(-cin // 32) * -(-cout // 64)
    assert 1 <= splits <= 65535 and tiles <= 2 ** 31 - 1
    assert _k6_smem(rows, h, w) <= SMEM_PER_BLOCK
    # f32 partials: at most 64 MiB of scratch
    if splits > 1:
        assert splits * 9 * cin * cout * 4 <= 64 * 2 ** 20


def test_k6_plan_fills_the_card_at_every_vgg_seam():
    """At batch 256 every seam runs a wave of blocks that fills at least 95%
    of the card (one block an SM), and at most two waves."""
    for n, hw, cin, cout in VGG_SEAMS:
        rows, splits = fc.k6_plan(n, hw, hw, cin, cout)
        blocks = -(-cin // 32) * -(-cout // 64) * splits
        assert blocks >= 0.95 * H100_SMS, (hw, blocks)
        assert blocks <= 2 * fc._K6_SLOTS, (hw, blocks)


def test_k6_plan_refuses_rows_wider_than_a_step():
    assert fc.k6_rows(2, 129) is None
    with pytest.raises(ValueError, match="W <= 128"):
        fc.k6_plan(1, 2, 129, 8, 8)


# (n, t, h, hd, causal): vit_cifar and vit_b16 at their batch, the causal
# T = 70 shape, and the GPU tests' edges
FLASH_CASES = [(256, 64, 4, 64, False), (64, 196, 12, 64, False),
               (256, 70, 4, 64, True), (32, 64, 4, 64, False),
               (2, 1, 1, 16, True), (3, 63, 3, 32, False),
               (2, 257, 3, 128, True), (5, 70, 3, 64, False),
               (201, 64, 3, 64, False), (67, 196, 12, 64, False)]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_flash_fwd_grid_covers_every_item_once(case, sms):
    n, t, h, hd, _ = case
    items, grid = fl.fwd_grid(n, t, h, hd, sms)
    warps = fl.fwd_warps(t, hd)
    assert items == n * -(-t // (16 * warps)) * h
    assert 1 <= grid <= min(items, sms * fl.fwd_blocks_per_sm(t, hd))
    walked = sorted(i for b in range(grid) for i in range(b, items, grid))
    assert walked == list(range(items))
    # every block takes the same number of items, give or take one
    counts = [len(range(b, items, grid)) for b in range(grid)]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [64, 196])
def test_flash_fwd_blocks_fit_in_shared_memory(hd, t):
    warps = fl.fwd_warps(t, hd)
    smem = 2 * (16 * warps + 128) * (hd + 8) * 2
    assert smem <= SMEM_PER_BLOCK
    assert fl.fwd_blocks_per_sm(t, hd) * (smem + 1024) <= SMEM_PER_SM
    assert warps == (8 if t > 64 and hd <= 64 else 4)


def test_flash_fwd_grid_at_the_vit_shapes():
    """vit_cifar: 1,024 items of one 64-key tile, 342 blocks of 3 items on
    132 SMs; vit_b16: 1,536 items of 128 queries, 256 blocks of 6."""
    assert fl.fwd_grid(256, 64, 4, 64, H100_SMS) == (1024, 342)
    assert fl.fwd_grid(64, 196, 12, 64, H100_SMS) == (1536, 256)


@pytest.mark.parametrize("case", [(201, 64, 3), (67, 196, 12)])
def test_flash_fwd_grid_need_not_divide_the_items(case):
    """The GPU tests' shapes whose item count the persistent grid does not
    divide (the last block takes fewer items)."""
    n, t, h = case
    items, grid = fl.fwd_grid(n, t, h, 64, H100_SMS)
    assert items % grid


# ------------------------------------------- K7 backward, one launch ----
# (n, t, h): vit_cifar, vit_b16, the causal T = 70 shape and the walks'
# edges (one query tile; one and two key blocks; an odd (image, head) count)
FLASH_BWD_CASES = [(256, 64, 4), (64, 196, 12), (256, 70, 4), (3, 1, 3),
                   (3, 63, 3), (5, 64, 3), (2, 65, 3), (2, 128, 3),
                   (2, 129, 2), (1, 196, 3), (2, 255, 2), (2, 256, 3)]


def _bwd_walk(plan, n, h):
    """(block, image, head, key block) as csrc/flash_bwd_wgmma.cu walks
    them: block b takes items b, b + grid, ...; a PAIR item is two (image,
    head)s, of which the second may be past N * H (not stored)."""
    for b in range(plan.grid):
        for it in range(b, plan.items, plan.grid):
            for item in ([2 * it, 2 * it + 1] if plan.pair else [it]):
                if item < n * h:
                    for kb in range(plan.n_kb):
                        yield b, item // h, item % h, kb


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_flash_bwd_plan_covers_every_image_head_key_block_once(case, sms):
    n, t, h = case
    plan = fl.bwd_plan(n, t, h, 64, sms)
    assert plan.pair == (t <= 64)
    assert plan.n_qt == -(-t // 64)
    assert plan.n_kb == (1 if plan.pair else -(-t // 128))
    assert 1 <= plan.grid <= min(plan.items, sms)
    walked = [(i, hh, kb) for _, i, hh, kb in _bwd_walk(plan, n, h)]
    assert sorted(walked) == [(i, hh, kb) for i in range(n) for hh in range(h)
                              for kb in range(plan.n_kb)]
    # every block takes the same number of items, give or take one
    counts = [len(range(b, plan.items, plan.grid)) for b in range(plan.grid)]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("t", range(1, 257))
def test_flash_bwd_plan_fits_the_card_at_every_t_the_route_takes(t):
    """Shared memory within a block's 232,448 B with the plan's two-stage
    ring, for every T <= 256; no third stage fits past T = 128."""
    plan = fl.bwd_plan(64, t, 12, 64, H100_SMS)
    assert plan.stages == fl.BWD_STAGES == 2
    assert plan.smem == fl.bwd_smem_bytes(plan.pair, plan.n_kb, plan.n_qt,
                                          plan.stages) <= SMEM_PER_BLOCK
    if t > 128:
        assert fl.bwd_smem_bytes(plan.pair, plan.n_kb, plan.n_qt,
                                 3) > SMEM_PER_BLOCK


def test_flash_bwd_plan_at_the_vit_shapes():
    """vit_cifar: 512 pairs of (image, head)s, 128 blocks of 4, 2 stages;
    vit_b16: 768 (image, head)s in two key blocks of four query tiles, 128
    blocks of 6, 2 stages."""
    cifar = fl.bwd_plan(256, 64, 4, 64, H100_SMS)
    assert (cifar.pair, cifar.n_kb, cifar.n_qt, cifar.items, cifar.stages,
            cifar.grid) == (True, 1, 1, 512, 2, 128)
    b16 = fl.bwd_plan(64, 196, 12, 64, H100_SMS)
    assert (b16.pair, b16.n_kb, b16.n_qt, b16.items, b16.stages,
            b16.grid) == (False, 2, 4, 768, 2, 128)


@pytest.mark.parametrize("case", [
    # (t, hd, dtype, taken)
    (64, 64, torch.bfloat16, True), (196, 64, torch.bfloat16, True),
    (1, 64, torch.bfloat16, True), (256, 64, torch.bfloat16, True),
    (257, 64, torch.bfloat16, False), (320, 64, torch.bfloat16, False),
    (64, 64, torch.float32, False), (70, 64, torch.float32, False),
    (64, 16, torch.bfloat16, False), (64, 32, torch.bfloat16, True),
    (64, 128, torch.bfloat16, False)])
def test_flash_bwd_route_predicate(case):
    """The one-launch backward takes bf16 at hd 32 and 64 up to T = 256;
    f32, T > 256 and the other head dims keep the dQ + dK/dV pair."""
    t, hd, dtype, taken = case
    q = torch.zeros((2, t, 3, hd), dtype=dtype)
    assert fl.bwd_route(q) == taken
    if not taken and hd in (32, 64) and t <= 256:
        assert fl.bwd_plan(2, t, 3, hd, H100_SMS)  # f32: a plan, no route
    if hd not in (32, 64) or t > 256:
        with pytest.raises(ValueError, match="no plan"):
            fl.bwd_plan(2, t, 3, hd, H100_SMS)


@pytest.mark.parametrize("case", [
    # (t, hd, dtype, taken): hd 32 as the route takes it
    (1, 32, torch.bfloat16, True), (70, 32, torch.bfloat16, True),
    (256, 32, torch.bfloat16, True), (257, 32, torch.bfloat16, False),
    (64, 32, torch.float32, False)])
def test_flash_bwd_route_at_hd_32(case):
    """textcls's head dim: bf16 up to T = 256 on the one-launch kernel,
    f32 (the f32 rows of the card tests) and T > 256 on the pair."""
    t, hd, dtype, taken = case
    assert fl.bwd_route(torch.zeros((2, t, 3, hd), dtype=dtype)) == taken


@pytest.mark.parametrize("t", range(1, 257))
def test_flash_bwd_plan_at_hd_32_fits_the_card(t):
    """At hd 32 a 64-row tile is 4 KB (64-byte rows): the walk is hd 64's
    and the plan's shared memory, each tile half hd 64's, is within a
    block's 232,448 B at every T the route takes."""
    p32, p64 = fl.bwd_plan(64, t, 12, 32, H100_SMS), fl.bwd_plan(64, t, 12,
                                                                 64, H100_SMS)
    assert p32[:6] == p64[:6]  # pair, n_kb, n_qt, items, stages, grid
    assert p32.smem == fl.bwd_smem_bytes(p32.pair, p32.n_kb, p32.n_qt,
                                         p32.stages, 32) <= SMEM_PER_BLOCK
    assert p32.smem < p64.smem


def test_flash_bwd_plan_at_textcls():
    """textcls (batch 256, T = 64 causal, 4 heads of 32): the PAIR walk,
    512 pairs, 128 blocks of 4, 2 stages in 110,656 B; T = 70 and 130 take
    the BLOCK walk with one and two key blocks."""
    p = fl.bwd_plan(256, 64, 4, 32, H100_SMS)
    assert (p.pair, p.n_kb, p.n_qt, p.items, p.stages, p.grid,
            p.smem) == (True, 1, 1, 512, 2, 128, 110656)
    assert fl.bwd_plan(2, 70, 2, 32, H100_SMS)[:3] == (False, 1, 2)
    assert fl.bwd_plan(1, 130, 2, 32, H100_SMS)[:3] == (False, 2, 3)


# ------------------------------------------------------ dense TN GEMM ----
# (m, r, nout) of the GEMM: vit_cifar at batch 256 (forward: R = K,
# Nout = N; dx: R = N, Nout = K), vit_b16 at batch 64, and ragged edges
GEMM_CASES = [(16384, 256, 256), (16384, 256, 1024), (16384, 1024, 256),
              (12544, 768, 768), (12544, 768, 3072), (12544, 3072, 768),
              (1000, 200, 72), (333, 40, 8), (1, 8, 8), (129, 64, 264),
              (4096, 1024, 1024)]


def _gemm_walk(m, nout, bn, grid):
    """The output tiles each block walks, as gemm_tn_bf16_kernel does:
    t = blockIdx.x, + gridDim.x, ...; M fastest."""
    tiles_m = -(-m // mm.GEMM_BM)
    tiles = tiles_m * -(-nout // bn)
    return [(t % tiles_m, t // tiles_m) for b in range(grid)
            for t in range(b, tiles, grid)]


@pytest.mark.parametrize("case", GEMM_CASES)
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_gemm_plan_covers_every_output_tile_once(case, sms):
    m, r, nout = case
    bn, stages, grid = mm.gemm_plan(m, r, nout, sms)
    walked = _gemm_walk(m, nout, bn, grid)
    tiles_m, tiles_n = -(-m // mm.GEMM_BM), -(-nout // bn)
    assert sorted(walked) == [(i, j) for i in range(tiles_m)
                              for j in range(tiles_n)]
    # the tiles reach past the output by less than one tile (clipped stores)
    assert (tiles_m - 1) * mm.GEMM_BM < m and (tiles_n - 1) * bn < nout


@pytest.mark.parametrize("case", GEMM_CASES)
def test_gemm_plan_fits_the_card(case):
    bn, stages, grid = mm.gemm_plan(*case, H100_SMS)
    assert bn in mm.GEMM_BNS and bn % 64 == 0 and bn <= 256  # wgmma N, TMA box
    assert 2 <= stages <= mm.GEMM_MAX_STAGES
    assert mm.gemm_smem_bytes(bn, stages) <= SMEM_PER_BLOCK
    assert 1 <= grid <= H100_SMS


def test_gemm_plan_at_the_vit_shapes():
    """vit_cifar: 128 x 128 tiles at Nout = 256 (256 tiles on 132 blocks, 5
    stages), 128 x 192 at Nout = 1024 (768 tiles, 4 stages); vit_b16:
    128 x 192 (392 tiles, three waves with all but 4 blocks full)."""
    assert mm.gemm_plan(16384, 256, 256, H100_SMS) == (128, 5, H100_SMS)
    assert mm.gemm_plan(16384, 1024, 256, H100_SMS) == (128, 5, H100_SMS)
    assert mm.gemm_plan(16384, 256, 1024, H100_SMS) == (192, 4, H100_SMS)
    assert mm.gemm_plan(12544, 768, 768, H100_SMS) == (192, 4, H100_SMS)


def _route(dtype, k, n, offset=0):
    x = torch.zeros(64 * k + offset, dtype=dtype)[offset:].view(64, k)
    w = torch.zeros(k, n)
    own = torch.zeros(k, n, dtype=torch.int8)
    return mm.gemm_route(x, w, own, torch.zeros(k, n))


@pytest.mark.parametrize("case", [
    # (dtype, K, N, storage offset of x, takes the TN GEMM)
    (torch.bfloat16, 256, 256, 0, True),    # vit_cifar q/k/v/proj
    (torch.bfloat16, 256, 1024, 0, True),   # fc1
    (torch.bfloat16, 768, 3072, 0, True),   # vit_b16 fc1
    (torch.bfloat16, 200, 72, 0, True),     # ragged, multiples of 8
    (torch.bfloat16, 8, 8, 0, True),
    (torch.float32, 256, 256, 0, False),    # f32: the 1x1 route
    (torch.bfloat16, 40, 36, 0, False),     # N % 8 != 0
    (torch.bfloat16, 70, 64, 0, False),     # K % 8 != 0
    (torch.bfloat16, 48, 3, 0, False),
    (torch.bfloat16, 256, 256, 4, False),   # x not 16-byte aligned
])
def test_gemm_route_predicate(case):
    dtype, k, n, offset, want = case
    assert _route(dtype, k, n, offset) is want


# ------------------------------------------ masked conv's GEMM route ----
# (layer, H = W, Cin, Cout) of VGG16-BN's 13 convs at width 1.0; the eight
# seams (conv1, 3, 5, 6, 8, 9, 11, 12) run the fused chain in the kernel
# step, so its masked convs are conv0, 2, 4, 7 and 10
VGG_CONVS = [("conv0", 32, 3, 64), ("conv1", 32, 64, 64),
             ("conv2", 16, 64, 128), ("conv3", 16, 128, 128),
             ("conv4", 8, 128, 256), ("conv5", 8, 256, 256),
             ("conv6", 8, 256, 256), ("conv7", 4, 256, 512),
             ("conv8", 4, 512, 512), ("conv9", 4, 512, 512),
             ("conv10", 2, 512, 512), ("conv11", 2, 512, 512),
             ("conv12", 2, 512, 512)]
MASKED_CONVS = ("conv0", "conv2", "conv4", "conv7", "conv10")


def _conv_route(dtype, hw, cin, cout, stride=1, offset=0, k=3):
    x = torch.zeros(hw * hw * cin + offset, dtype=dtype)[offset:]
    w = torch.zeros(k, k, cin, cout)
    return mc.conv_route(x.view(1, hw, hw, cin), w, stride, "SAME")


@pytest.mark.parametrize("mult", [1.0, 0.125])
@pytest.mark.parametrize("layer", VGG_CONVS, ids=[c[0] for c in VGG_CONVS])
def test_conv_route_at_every_vgg_conv(layer, mult):
    """bf16 at width 1.0: every conv but conv0 (Cin = 3) takes the GEMM
    route; of the kernel step's masked convs that is conv2, 4, 7 and 10. At
    width 0.125 (channels 8-64) only the convs with 64 input and output
    channels take it: conv8-12 (64 -> 64 at 4x4 and 2x2); conv0, 2, 4 and 7
    keep K1 and K2. f32 never takes it."""
    name, hw, cin, cout = layer
    cin, cout = (vgg.scale_channels(c, mult) if c != 3 else 3
                 for c in (cin, cout))
    want = cin % 64 == 0 and cout % 64 == 0
    assert _conv_route(torch.bfloat16, hw, cin, cout) is want
    assert _conv_route(torch.float32, hw, cin, cout) is False
    if mult == 1.0 and name in MASKED_CONVS:
        assert want is (name != "conv0")
    if mult == 0.125 and name in MASKED_CONVS:
        assert want is (name == "conv10")


@pytest.mark.parametrize("case", [
    # (dtype, H = W, Cin, Cout, stride, storage offset of x, kernel, takes it)
    (torch.bfloat16, 16, 64, 128, 2, 0, 3, False),   # stride 2
    (torch.bfloat16, 16, 64, 128, 1, 4, 3, False),   # x not 16-byte aligned
    (torch.bfloat16, 16, 64, 72, 1, 0, 3, False),    # Cout % 64 != 0
    (torch.bfloat16, 16, 96, 128, 1, 0, 3, False),   # Cin % 64 != 0
    (torch.bfloat16, 12, 64, 64, 1, 0, 3, False),    # 128 % 12 != 0
    (torch.bfloat16, 32, 64, 64, 1, 0, 3, True),     # rows of one image
    (torch.bfloat16, 1, 64, 64, 1, 0, 3, True),      # 128 images a box
    (torch.bfloat16, 8, 64, 64, 1, 0, 1, True),      # 1x1
    (torch.bfloat16, 256, 64, 64, 1, 0, 3, False),   # a row wider than 128
])
def test_conv_route_predicate(case):
    dtype, hw, cin, cout, stride, offset, k, want = case
    assert _conv_route(dtype, hw, cin, cout, stride, offset, k) is want


def _conv_walk(n, ho, wo, nout, plan):
    """The (output pixel, output channel tile) pairs each block of the
    conv's implicit GEMM stores, as gemm_tn_bf16_kernel walks them: tile t
    = blockIdx.x, + gridDim.x, ...; M fastest; a tile's box of (images,
    rows, columns) starting at its first pixel; rows past N*Ho*Wo
    clipped."""
    (_, bw, bh, bn_img), bn, _, grid = plan
    m = n * ho * wo
    tiles_m = -(-m // mm.GEMM_BM)
    tiles = tiles_m * -(-nout // bn)
    out = []
    for b in range(grid):
        for t in range(b, tiles, grid):
            m0, j = (t % tiles_m) * mm.GEMM_BM, t // tiles_m
            img, rem = divmod(m0, ho * wo)
            oh0, ow0 = divmod(rem, wo)
            r = 0
            for i in range(bn_img):
                for h in range(bh):
                    for c in range(bw):
                        pix = (img + i) * ho * wo + (oh0 + h) * wo + ow0 + c
                        assert pix == m0 + r, "box rows out of pixel order"
                        assert bn_img == 1 or (oh0, ow0) == (0, 0)
                        assert oh0 + h < ho and ow0 + c < wo
                        if pix < m:
                            out.append((pix, j))
                        r += 1
    return out


# (n, H = W, C, Nout) of the route's products: conv2/4/7/10 forward (C =
# Cin) and dgrad (C = Cout, Nout = Cin) at batch 256 and 3
CONV_PLAN_CASES = [(n, hw, c, nout) for n in (256, 3)
                   for hw, cin, cout in ((16, 64, 128), (8, 128, 256),
                                         (4, 256, 512), (2, 512, 512))
                   for c, nout in ((cin, cout), (cout, cin))]


@pytest.mark.parametrize("case", CONV_PLAN_CASES)
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_conv_plan_covers_every_output_pixel_once(case, sms):
    n, hw, c, nout = case
    plan = mm.conv_plan(n, hw, hw, c, nout, 9, sms)
    bn = plan[1]
    walked = sorted(_conv_walk(n, hw, hw, nout, plan))
    assert walked == [(p, j) for p in range(n * hw * hw)
                      for j in range(-(-nout // bn))]


@pytest.mark.parametrize("case", CONV_PLAN_CASES)
def test_conv_plan_fits_the_card(case):
    n, hw, c, nout = case
    box, bn, stages, grid = mm.conv_plan(n, hw, hw, c, nout, 9, H100_SMS)
    assert box[0] == mm.GEMM_BK and box[1] * box[2] * box[3] == mm.GEMM_BM
    assert all(1 <= d <= 256 for d in box)       # TMA's box limit
    assert bn in mm.GEMM_BNS and 2 <= stages <= mm.GEMM_MAX_STAGES
    assert mm.gemm_smem_bytes(bn, stages) <= SMEM_PER_BLOCK
    assert 1 <= grid <= H100_SMS


def test_conv_plan_boxes_at_the_vgg_shapes():
    """The A boxes (C, W, rows, images) of conv2/4/7/10 as the design
    table gives them, and a grid that has no box."""
    boxes = {hw: mm.conv_plan(256, hw, hw, 64, 64, 9, H100_SMS)[0]
             for hw in (16, 8, 4, 2)}
    assert boxes == {16: (64, 16, 8, 1), 8: (64, 8, 8, 2),
                     4: (64, 4, 4, 8), 2: (64, 2, 2, 32)}
    with pytest.raises(ValueError, match="TMA box"):
        mm.conv_plan(2, 3, 3, 64, 64, 9, H100_SMS)


# ------------------------------------------------ weight-gradient GEMM ----
# (m, k, n, rows) of K3: vit_cifar's dense products at batch 256, vit_b16's
# at 64, VGG16-BN's route convs at batch 256 and 3 (rows = one 128-pixel
# box, k = 9 * Cin) and conv0's patches (k = 27), ragged edges
WGRAD_CASES = ([(16384, 256, 256, 64), (16384, 256, 1024, 64),
                (16384, 1024, 256, 64), (12544, 768, 768, 64),
                (12544, 768, 3072, 64), (12544, 3072, 768, 64),
                (262144, 27, 64, 64), (300, 200, 72, 64), (1, 8, 8, 64),
                (65, 136, 264, 64)]
               + [(n * hw * hw, 9 * cin, cout, 128) for n in (256, 3)
                  for hw, cin, cout in ((16, 64, 128), (8, 128, 256),
                                        (4, 256, 512), (2, 512, 512))])


def _wgrad_items(m, k, n, rows, plan):
    """The (tile, pixel step) pairs the blocks reduce, as wgrad_wgmma_kernel
    walks them: item it = blockIdx.x, + gridDim.x, ...; tile it % tiles,
    split it // tiles, split z's steps z*per .. min((z+1)*per, steps)."""
    bn, splits, _, grid = plan
    steps = -(-m // rows)
    per = -(-steps // splits)
    tiles = -(-k // mm.WGRAD_BK) * -(-n // bn)
    out, per_split = [], {}
    for b in range(grid):
        for it in range(b, tiles * splits, grid):
            t, z = it % tiles, it // tiles
            span = range(z * per, min((z + 1) * per, steps))
            per_split[z] = len(span)
            out += [(t, st) for st in span]
    return out, tiles, steps, per_split


@pytest.mark.parametrize("case", WGRAD_CASES)
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_wgrad_plan_covers_every_tile_and_step_once(case, sms):
    """Every (output tile, step) is reduced by exactly one item, the splits
    are runs of whole steps (64 rows or one 128-pixel box) and none is
    empty; no split is a longer f32 chain than WGRAD_MAX_SPLIT_ROWS
    pixels."""
    m, k, n, rows = case
    plan = mm.wgrad_plan(m, k, n, sms, rows)
    walked, tiles, steps, per_split = _wgrad_items(m, k, n, rows, plan)
    assert sorted(walked) == [(t, s) for t in range(tiles)
                              for s in range(steps)]
    assert len(per_split) == plan[1] and min(per_split.values()) >= 1
    assert max(per_split.values()) * rows <= mm.WGRAD_MAX_SPLIT_ROWS


@pytest.mark.parametrize("case", WGRAD_CASES)
def test_wgrad_plan_fits_the_card(case):
    m, k, n, rows = case
    bn, splits, stages, grid = mm.wgrad_plan(m, k, n, H100_SMS, rows)
    assert bn in mm.WGRAD_BNS and bn % 64 == 0 and bn <= 128  # wgmma N
    assert 2 <= stages <= mm.WGRAD_MAX_STAGES
    assert mm.wgrad_smem_bytes(bn, rows, stages) <= SMEM_PER_BLOCK
    assert 1 <= grid <= H100_SMS and grid <= -(-k // 128) * -(-n // bn) * splits
    assert 1 <= splits <= -(-m // rows)


def test_wgrad_plan_at_the_vit_and_vgg_shapes():
    """The picks of the cost model, each the fastest or within 6% of the
    fastest plan of scripts/torch_wgrad_plans.py's sweep on the H100:
    vit_cifar q/k/v/proj 128 x 64 tiles in 16 splits (128 items), fc1 and
    fc2 128 x 128 in 8; vit_b16's q/k/v 128 x 128 in 3 (108 items); conv0's
    patches one 128 x 64 tile in 128 splits; conv2 in 24 splits, conv4 in
    6, conv7 in 3 (216 items: two rounds), conv10 in one (144 tiles)."""
    def plan(m, k, n, rows=64):
        return mm.wgrad_plan(m, k, n, H100_SMS, rows)
    assert plan(16384, 256, 256) == (64, 16, 6, 128)
    assert plan(16384, 256, 1024) == (128, 8, 6, 128)
    assert plan(16384, 1024, 256) == (128, 8, 6, 128)
    assert plan(12544, 768, 768) == (128, 3, 6, 108)
    assert plan(262144, 27, 64) == (64, 128, 6, 128)
    convs = {hw: mm.wgrad_conv_plan(256, hw, hw, cin, cout, 9, H100_SMS)
             for hw, cin, cout in ((16, 64, 128), (8, 128, 256),
                                   (4, 256, 512), (2, 512, 512))}
    assert convs == {16: ((64, 16, 8, 1), 128, 24, 3, 120),
                     8: ((64, 8, 8, 2), 128, 6, 3, 108),
                     4: ((64, 4, 4, 8), 128, 3, 3, 132),
                     2: ((64, 2, 2, 32), 128, 1, 3, 132)}


@pytest.mark.parametrize("mult", [1.0, 0.125])
@pytest.mark.parametrize("layer", VGG_CONVS, ids=[c[0] for c in VGG_CONVS])
def test_wgrad_routes_at_every_vgg_conv(layer, mult):
    """bf16 K3: the convs on `conv_route` (Cin and Cout multiples of 64)
    take the per-tap wgrad GEMM; conv0 (K = 27) the im2col route at both
    widths; the rest at width 0.125 (conv1-7: K = 72-576 with Cin of 8-32)
    keep the old kernel. f32 takes neither."""
    name, hw, cin, cout = layer
    cin, cout = (vgg.scale_channels(c, mult) if c != 3 else 3
                 for c in (cin, cout))
    x = torch.zeros((1, hw, hw, cin), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, cin, cout))
    gemm = mc.conv_route(x, w, 1, "SAME")
    im2col = mc.im2col_route(x, w)
    assert gemm is (cin % 64 == 0 and cout % 64 == 0)
    assert im2col is (name == "conv0")
    assert not (gemm and im2col)
    assert not mc.im2col_route(x.float(), w)
    if name in MASKED_CONVS and name != "conv0":
        assert gemm is (mult == 1.0 or name == "conv10")


@pytest.mark.parametrize("case", [
    # (dtype, K, N, storage offset of x, takes the wgrad GEMM)
    (torch.bfloat16, 256, 256, 0, True),    # vit_cifar q/k/v/proj
    (torch.bfloat16, 1024, 256, 0, True),   # fc2
    (torch.bfloat16, 200, 72, 0, True),     # ragged, multiples of 8
    (torch.float32, 256, 256, 0, False),    # f32: K3 at 1x1
    (torch.bfloat16, 70, 64, 0, False),     # K % 8 != 0
    (torch.bfloat16, 64, 36, 0, False),     # N % 8 != 0
    (torch.bfloat16, 256, 256, 4, False),   # x not 16-byte aligned
])
def test_wgrad_route_predicate(case):
    dtype, k, n, offset, want = case
    x = torch.zeros(64 * k + offset, dtype=dtype)[offset:].view(64, k)
    g = torch.zeros((64, n), dtype=dtype)
    own = torch.zeros(k, n, dtype=torch.int8)
    assert mm.wgrad_route(x, g, torch.zeros(k, n), own) is want


def test_im2col_route_predicate():
    """Cout % 8 == 0 and Cin < 8 or kh*kw*Cin <= 64, any stride: 3x3 with
    Cin <= 7, 1x1 with Cin <= 64, ResNet-50's 7x7 stem (K = 147)."""
    def route(k, cin, cout):
        x = torch.zeros((1, 4, 4, cin), dtype=torch.bfloat16)
        return mc.im2col_route(x, torch.zeros((k, k, cin, cout)))
    assert route(3, 7, 8) and route(1, 64, 64) and route(3, 3, 64)
    assert route(7, 3, 64)
    assert not route(3, 8, 16) and not route(3, 3, 60) and not route(7, 3, 60)


# ------------------------------------ K4 and K5 on the conv GEMM route ----
# VGG16-BN's eight fused seams (BN -> ReLU -> conv): every conv but the
# first of each block
FUSED_SEAMS = [c for c in VGG_CONVS if c[0] not in MASKED_CONVS]


@pytest.mark.parametrize("mult", [1.0, 0.125])
@pytest.mark.parametrize("seam", FUSED_SEAMS, ids=[c[0] for c in FUSED_SEAMS])
def test_fused_route_at_every_vgg_seam(seam, mult):
    """bf16 at width 1.0: all eight seams take K4's and K5's GEMM route. At
    width 0.125 only the 64 -> 64 seams (conv8/9 at 4x4, conv11/12 at
    2x2) do; conv1-6 (8-32 channels) keep the earlier kernels. f32 and a
    bf16 x with an f32 dot dtype never take it."""
    name, hw, cin, cout = seam
    cin, cout = (vgg.scale_channels(c, mult) for c in (cin, cout))
    x = torch.zeros((1, hw, hw, cin), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, cin, cout), dtype=torch.bfloat16)
    want = ("gemm" if mult == 1.0 or name in ("conv8", "conv9", "conv11",
                                              "conv12") else None)
    for route in (fc.dx_route, fc.fwd_route):
        assert route(x, w, torch.bfloat16) == want
        assert route(x, w, torch.float32) is None
        assert route(x.float(), w.float(), torch.float32) is None


@pytest.mark.parametrize("case", [
    # (H = W, Cin, Cout, storage offset of x, K4's route, K5's route)
    (16, 64, 64, 0, "gemm", "gemm"),
    (16, 64, 64, 4, None, None),      # x not 16-byte aligned
    (16, 64, 96, 0, None, None),      # Cout % 64 != 0
    (16, 32, 64, 0, None, None),      # Cin % 64 != 0
    (12, 64, 64, 0, "im2col", "im2col"),  # no 128-pixel box tiles 12x12
    # 128 images a box: K5's dgrad box is one pixel a image, but K4's
    # two halo buffers of 3 x 3 x 128 pixels (147,456 B each) do not fit
    (1, 64, 64, 0, None, "gemm"),
])
def test_fused_route_predicate(case):
    hw, cin, cout, offset, fwd, dx = case
    x = torch.zeros(hw * hw * cin + offset, dtype=torch.bfloat16)[offset:]
    x = x.view(1, hw, hw, cin)
    w = torch.zeros((3, 3, cin, cout), dtype=torch.bfloat16)
    assert fc.fwd_route(x, w, torch.bfloat16) == fwd
    assert fc.dx_route(x, w, torch.bfloat16) == dx


@pytest.mark.parametrize("hw", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 3, 256])
def test_fused_plans_exist_wherever_their_route_is_taken(hw, n):
    """On every square grid that `conv_box` tiles, the predicates and the
    plans agree: K4's plan is found exactly where `fused_fwd_fits` holds
    (so a routed shape is never refused at launch), and then fits the
    CUDA entry's limits; K5's plan is found on every such grid."""
    cin = cout = 64
    if mm.fused_fwd_fits(hw, hw):
        box, bn, stages, grid, halo = mm.fused_fwd_plan(n, hw, hw, cin,
                                                        cout, H100_SMS)
        _, bw, rows, imgs = box
        assert (bw + 2) * (rows + 2) * imgs <= mm.FWD_MAX_HALO_PX
        assert mm.fused_fwd_smem_bytes(bn, stages, halo) <= SMEM_PER_BLOCK
    else:
        assert hw == 1
        with pytest.raises(ValueError, match="no K4 plan"):
            mm.fused_fwd_plan(n, hw, hw, cin, cout, H100_SMS)
    box, bn, stages, grid = mm.fused_dx_plan(n, hw, hw, cin, cout, H100_SMS)
    assert mm.fused_dx_smem_bytes(bn, stages) <= SMEM_PER_BLOCK


# (n, H = W, Cin, Cout) of the eight seams' grids at batch 256 and 3
FUSED_PLAN_CASES = [(n, hw, cin, cout) for n in (256, 3)
                    for _, hw, cin, cout in FUSED_SEAMS]


def _fused_fwd_walk(n, h, w, cout, plan):
    """The (output pixel, output channel tile) pairs K4's blocks store, and
    for each stored pixel the halo-box pixel of its centre tap, which must
    hold that pixel with all eight neighbours inside the box."""
    (_, bw, rows, imgs), bn, _, grid, _ = plan
    pw, ph = bw + 2, rows + 2
    m = n * h * w
    tiles_m = -(-m // mm.GEMM_BM)
    out = []
    for b in range(grid):
        for t in range(b, tiles_m * -(-cout // bn), grid):
            m0, j = (t % tiles_m) * mm.GEMM_BM, t // tiles_m
            img, rem = divmod(m0, h * w)
            oh0 = rem // w
            assert rem % w == 0 and (imgs == 1 or oh0 == 0)
            for r in range(mm.GEMM_BM):
                rq, ri = r // bw, r // (bw * rows)
                p0 = (ri * ph + rq - ri * rows + 1) * pw + r % bw + 1
                col, q = p0 % pw, p0 // pw
                assert 1 <= col <= bw and 1 <= q % ph <= rows   # not a halo
                assert (img + q // ph, oh0 + q % ph - 1, col - 1) == (
                    img + ri, oh0 + rq - ri * rows, r % bw)
                if m0 + r < m:
                    out.append((m0 + r, j))
    return out


@pytest.mark.parametrize("case", FUSED_PLAN_CASES)
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_fused_fwd_plan_covers_every_output_pixel_once(case, sms):
    n, hw, cin, cout = case
    plan = mm.fused_fwd_plan(n, hw, hw, cin, cout, sms)
    walked = sorted(_fused_fwd_walk(n, hw, hw, cout, plan))
    assert walked == [(p, j) for p in range(n * hw * hw)
                      for j in range(-(-cout // plan[1]))]


@pytest.mark.parametrize("case", FUSED_PLAN_CASES)
def test_fused_dx_plan_covers_every_input_pixel_once(case):
    """K5's tiles are the conv GEMM's dgrad tiles: 128 input pixels x BN
    input channels, walked as `conv_plan`'s."""
    n, hw, cin, cout = case
    box, bn, stages, grid = mm.fused_dx_plan(n, hw, hw, cin, cout, H100_SMS)
    walked = sorted(_conv_walk(n, hw, hw, cin, (box, bn, stages, grid)))
    assert walked == [(p, j) for p in range(n * hw * hw)
                      for j in range(-(-cin // bn))]


@pytest.mark.parametrize("case", FUSED_PLAN_CASES)
def test_fused_plans_fit_the_card(case):
    n, hw, cin, cout = case
    box, bn, stages, grid, halo = mm.fused_fwd_plan(n, hw, hw, cin, cout,
                                                    H100_SMS)
    _, bw, rows, imgs = box
    halo_box = (mm.GEMM_BK, bw + 2, rows + 2, imgs)
    assert all(1 <= d <= 256 for d in halo_box)        # TMA's box limit
    assert halo % 1024 == 0 and halo >= 128 * (bw + 2) * (rows + 2) * imgs
    assert bn in mm.FUSED_BNS and 2 <= stages <= mm.FWD_MAX_STAGES
    assert mm.fused_fwd_smem_bytes(bn, stages, halo) <= SMEM_PER_BLOCK
    assert 1 <= grid <= H100_SMS
    box, bn, stages, grid = mm.fused_dx_plan(n, hw, hw, cin, cout, H100_SMS)
    assert box == mm.conv_plan(n, hw, hw, cout, cin, 9, H100_SMS)[0]
    assert bn in mm.FUSED_BNS and 2 <= stages <= mm.DX_MAX_STAGES
    assert mm.fused_dx_smem_bytes(bn, stages) <= SMEM_PER_BLOCK
    assert 1 <= grid <= H100_SMS


@pytest.mark.parametrize("hw", [32, 16, 8, 4, 2])
def test_fused_fwd_fits_at_both_tile_widths_on_every_seam_grid(hw):
    """Two halo buffers, a ring of at least 4 weight stages, the output
    staging and the barriers fit 232,448 B at both tile widths on every
    seam grid; at 2x2 (32 images a box, 65,536 B a halo) BN = 128 leaves 4
    stages and 1,936 B: 230,512 B in all."""
    halo = mm.fused_halo_bytes(mm.conv_plan(3, hw, hw, 64, 64, 9, 7)[0])
    for bn in mm.FUSED_BNS:
        assert mm.fused_fwd_smem_bytes(bn, 4, halo) <= SMEM_PER_BLOCK
    if hw == 2:
        assert halo == 65536
        assert mm.fused_fwd_smem_bytes(128, 4, halo) == 230512
        assert mm.fused_fwd_smem_bytes(128, 5, halo) > SMEM_PER_BLOCK


def test_fused_plans_at_the_vgg_seams():
    """The tile widths at batch 256: BN = 64 where Cout (K4) or Cin (K5) is
    64 (conv1) and at 2x2, whose 8 row tiles fill more SMs at 64; 128
    elsewhere."""
    fwd = {hw: mm.fused_fwd_plan(256, hw, hw, cin, cout, H100_SMS)[1]
           for _, hw, cin, cout in FUSED_SEAMS}
    dx = {hw: mm.fused_dx_plan(256, hw, hw, cin, cout, H100_SMS)[1]
          for _, hw, cin, cout in FUSED_SEAMS}
    assert fwd == dx == {32: 64, 16: 128, 8: 128, 4: 128, 2: 64}


# (H = W, channels) of ResNet-50's four seam grids (the 13 stride-1
# bottleneck 3x3 convs), at the chip's batch 32 and at 128
RESNET_SEAM_GRIDS = [(56, 64), (28, 128), (14, 256), (7, 512)]
RESNET_PLAN_CASES = [(n, hw, c) for n in (32, 128)
                     for hw, c in RESNET_SEAM_GRIDS]


@pytest.mark.parametrize("case", RESNET_PLAN_CASES,
                         ids=[f"n{n}_{hw}" for n, hw, _ in RESNET_PLAN_CASES])
def test_fused_im2col_plans_fit_the_card(case):
    """K4's halo plan and K5's im2col plan at ResNet-50's seams: the halo
    boxes within TMA's 256 a dimension and the CUDA entry's
    FWD_MAX_HALO_PX, the second box (where tiles cross images) after the
    first on a 1,024-byte boundary, two halo buffers with the ring in the
    H100's 232,448 B; K5's ring beside x's tile too, its one phase the
    stride-1 dgrad's with the im2col map's corners in [-128, 127]; no more
    blocks than tiles or SMs."""
    n, hw, c = case
    box, split = mm.fused_fwd_halo(hw, hw)
    _, bw, rows, imgs = box
    assert all(1 <= d <= 256 for d in (mm.GEMM_BK, bw + 2, rows + 2, imgs))
    assert mm.fused_halo_px(box, split) <= mm.FWD_MAX_HALO_PX
    assert split == 0 or (split % 8 == 0 and split >= (bw + 2) * (rows + 2))
    plan_box, bn, stages, grid, halo = mm.fused_fwd_plan(n, hw, hw, c, c,
                                                         H100_SMS)
    assert plan_box == box and mc.conv_box(hw, hw) is None
    assert bn in mm.FUSED_BNS and 2 <= stages <= mm.FWD_MAX_STAGES
    assert mm.fused_fwd_smem_bytes(bn, stages, halo) <= SMEM_PER_BLOCK
    tiles_m = -(-n * hw * hw // mm.GEMM_BM)
    assert 1 <= grid <= min(tiles_m * -(-c // bn), H100_SMS)
    phases, bn, stages, grid = mm.fused_dx_im2col_plan(n, hw, hw, c, c,
                                                       H100_SMS)
    assert phases == mm.im2col_plan(n, hw, hw, hw, hw, 3, 3, 1, (1, 1, 1, 1),
                                    c, c, True, H100_SMS)[0]
    ((h_, w_, lw, lh, row0, col0, taps),) = phases
    assert (h_, w_, lw, lh, row0, col0, len(taps)) == (hw, hw, -1, -1, 0, 0,
                                                       9)
    assert bn in mm.FUSED_BNS and 2 <= stages <= mm.DX_MAX_STAGES
    assert mm.fused_dx_smem_bytes(bn, stages) <= SMEM_PER_BLOCK
    assert 1 <= grid <= min(tiles_m * -(-c // bn), H100_SMS)


def test_fused_im2col_plans_at_the_resnet_seams():
    """The halo geometry and tile widths at batch 32: 56x56 keeps 4 rows of
    one image and a second box at 352 (64 wide: at 128 the two 90,112-B
    halo buffers leave no room for a ring), 28x28 6 rows, 14x14 10 rows,
    7x7 whole images, 4 a box; K4 and K5 take BN 64 at 7x7, where 13 pixel
    tiles by 4 channel tiles of 128 would leave 80 of 132 SMs idle."""
    halo = {hw: mm.fused_fwd_halo(hw, hw) for hw, _ in RESNET_SEAM_GRIDS}
    assert halo == {56: ((64, 56, 4, 1), 352), 28: ((64, 28, 6, 1), 240),
                    14: ((64, 14, 10, 1), 192), 7: ((64, 7, 7, 4), 0)}
    assert mm._fused_fwd_bns(56, 56) == (64,)
    fwd = {hw: mm.fused_fwd_plan(32, hw, hw, c, c, H100_SMS)[1]
           for hw, c in RESNET_SEAM_GRIDS}
    dx = {hw: mm.fused_dx_im2col_plan(32, hw, hw, c, c, H100_SMS)[1]
          for hw, c in RESNET_SEAM_GRIDS}
    assert fwd == dx == {56: 64, 28: 128, 14: 128, 7: 64}


@pytest.mark.parametrize("hw", [1, 2, 3, 4, 5, 6, 7, 8, 12, 14, 16, 28, 32,
                                56, 64, 112, 128])
def test_fused_fwd_halo_holds_every_tile(hw):
    """Walking every 128-pixel tile of 3 images of an hw x hw grid: each
    tile touches at most `rows` rows of one image and, with whole images,
    at most `imgs` images; a tile touches two images only where a split
    is set; on the grids `conv_box` tiles the halo is its box."""
    box, split = mm.fused_fwd_halo(hw, hw)
    _, _, rows, imgs = box
    if mc.conv_box(hw, hw) is not None:
        assert (box, split) == (mc.conv_box(hw, hw), 0)
    n, area = 3, hw * hw
    for m0 in range(0, n * area, mm.GEMM_BM):
        pix = range(m0, min(m0 + mm.GEMM_BM, n * area))
        images = {p // area for p in pix}
        for im in images:
            touched = {p % area // hw for p in pix if p // area == im}
            assert len(touched) <= rows
        if rows == hw:
            assert len(images) <= imgs
        else:
            assert imgs == 1 and len(images) <= 1 + (split > 0)


# --------------------------------------------------- K1's stem route ----
# (name, n, h, w, k, stride, padding, Cout, tiles, halo rows) of the three
# Cin = 3 convs at the chip's batches: ResNet-50's 7x7/2 stem (batch 32),
# SphereNet-20's 3x3/2 stem (256, 112x96), VGG16-BN's conv0 (256)
STEM_CONVS = [("resnet50_stem", 32, 224, 224, 7, 2, ((3, 3), (3, 3)), 64,
               3136, 9),
              ("spherenet20_stem", 256, 112, 96, 3, 2, 1, 64, 5376, 9),
              ("vgg16_conv0", 256, 32, 32, 3, 1, "SAME", 64, 2048, 6)]


def _stem_geometry(n, h, w, k, stride, pad):
    pads = mc.resolve_padding(pad, h, w, k, k, stride)
    ho = mc.out_size(h, k, stride, pads[0], pads[1])
    wo = mc.out_size(w, k, stride, pads[2], pads[3])
    return pads, ho, wo


@pytest.mark.parametrize("conv", STEM_CONVS, ids=[c[0] for c in STEM_CONVS])
def test_stem_plan_at_the_three_convs(conv):
    """The route holds in bf16 (not f32, not at width 0.125's Cout 8); the
    tiles divide M; the halo holds the most rows any tile reads, each span
    inside its image; shared memory within 227 KB and two blocks an SM."""
    name, n, h, w, k, stride, pad, cout, tiles, rows = conv
    x = torch.zeros((1, h, w, 3), dtype=torch.bfloat16)
    wt = torch.zeros((k, k, 3, cout))
    assert mc.stem_route(x, wt, stride, pad)
    assert not mc.stem_route(x.float(), wt, stride, pad)
    assert not mc.stem_route(x, torch.zeros((k, k, 3, cout // 8)), stride,
                             pad)
    pads, ho, wo = _stem_geometry(n, h, w, k, stride, pad)
    plan = mc.stem_plan(n, h, w, 3, cout, k, k, stride, pads, H100_SMS)
    assert plan.tiles == tiles and n * ho * wo == tiles * 128
    assert plan.kp == -(-k * k * 3 // 16) * 16 and plan.halo_rows == rows
    most = 0
    for t in range(plan.tiles):
        a, b = mc.stem_spans(t * 128, n, h, ho, wo, k, stride, pads[0])
        for img, lo, r in [a] + ([b] if b else []):
            assert 0 <= img < n and 0 <= lo and lo + r <= h and r >= 1
        most = max(most, a[2] + (b[2] if b else 0))
    assert most == plan.halo_rows
    assert plan.halo_bytes >= rows * w * 3 * 2 and plan.halo_bytes % 128 == 0
    assert plan.smem == mc.stem_smem_bytes(plan.kp, cout, plan.halo_bytes)
    assert 2 * (plan.smem + 1024) <= SMEM_PER_SM
    assert plan.grid == min(plan.tiles, 2 * H100_SMS)


@pytest.mark.parametrize("case", [
    # (n, h, w, k, stride, pad): tiles that start mid-row and cross images
    (3, 24, 24, 7, 2, 3), (2, 26, 24, 3, 2, 1), (3, 12, 16, 3, 1, "SAME"),
    (5, 9, 16, 3, 1, 1)])
def test_stem_spans_hold_every_row_each_tile_reads(case):
    """Every input row a tile's windows touch lies in one of its spans:
    the image's own span for its pixels, the next image's first rows for
    the pixels past it."""
    n, h, w, k, stride, pad = case
    pads, ho, wo = _stem_geometry(n, h, w, k, stride, pad)
    tiles = -(-n * ho * wo // 128)
    crossed = 0
    for t in range(tiles):
        a, b = mc.stem_spans(t * 128, n, h, ho, wo, k, stride, pads[0])
        crossed += b is not None
        for m in range(t * 128, min(t * 128 + 128, n * ho * wo)):
            img, rem = divmod(m, ho * wo)
            oh = rem // wo
            need = {r for r in range(oh * stride - pads[0],
                                     oh * stride - pads[0] + k)
                    if 0 <= r < h}
            span = a if img == a[0] else b
            assert span is not None and span[0] == img
            assert need <= set(range(span[1], span[1] + span[2]))
    assert crossed > 0


@pytest.mark.parametrize("case", [
    # (dtype, n, h, w, cin, k, stride, pad, cout): off the route
    (torch.float32, 2, 32, 32, 3, 3, 1, "SAME", 64),   # f32
    (torch.bfloat16, 2, 32, 32, 3, 3, 1, "SAME", 32),  # Cout 32
    (torch.bfloat16, 2, 32, 32, 8, 3, 1, "SAME", 64),  # Cin 8
    (torch.bfloat16, 2, 32, 30, 3, 3, 1, "SAME", 64),  # rows of 180 B
    (torch.bfloat16, 2, 8, 8, 3, 3, 1, "SAME", 64),    # 64 pixels an image
    (torch.bfloat16, 2, 64, 64, 3, 7, 2, 7, 64),       # pad past k - 1
    (torch.bfloat16, 2, 64, 64, 6, 7, 1, 3, 64),       # K = 294
    (torch.bfloat16, 2, 64, 64, 3, 3, 1, 1, 320)])     # Cout past 256
def test_stem_route_refuses_what_the_kernel_does_not_take(case):
    dtype, n, h, w, cin, k, stride, pad, cout = case
    assert not mc.stem_route(torch.zeros((n, h, w, cin), dtype=dtype),
                             torch.zeros((k, k, cin, cout)), stride, pad)
