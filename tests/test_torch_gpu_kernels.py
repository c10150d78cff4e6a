"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips (with its reason) when CUDA is not available;
the decision is made inside the fixture, so every worker collects the same
tests. Run on a machine with the card:

    python -m pytest -m gpu tests/test_torch_gpu_kernels.py -q

Tolerances: f32 kernels rtol/atol 1e-4 against the plain version with TF32
off (exact f32 FMA in a different summation order); bf16 kernels
max|diff| <= 2e-2 * max|ref| (bf16 operands, f32 accumulation).
"""

import numpy as np
import pytest
import torch

from cpg_tpu_torch.ops import flash as fl
from cpg_tpu_torch.ops import fused_chain as fc
from cpg_tpu_torch.ops import masked_conv as mc
from cpg_tpu_torch.ops import masked_matmul as mm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    old = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = old[0]
    torch.set_float32_matmul_precision(old[1])


def _check(got, want, dtype):
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)
    else:
        err, scale = (got - want).abs().max().item(), want.abs().max().item()
        assert err <= 2e-2 * scale, (err, scale)


def _conv_case(n, h, w, cin, cout, k, device, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32))
    wt = torch.from_numpy((rng.randn(k, k, cin, cout)
                           * np.sqrt(2.0 / (k * k * cout))).astype(np.float32))
    own = torch.from_numpy(rng.choice([0, 1, 2, 3], size=wt.shape).astype(np.int8))
    pm = torch.from_numpy(rng.randn(*wt.shape).astype(np.float32) * 0.01)
    return (x.to(device, dtype), wt.to(device), own.to(device), pm.to(device))


@pytest.mark.parametrize("case", [
    # (n, h, w, cin, cout, k, stride, dtype, mode)
    (4, 32, 32, 3, 64, 3, 1, "bfloat16", "binary"),     # VGG conv0, K=27
    (4, 16, 16, 64, 128, 3, 1, "bfloat16", "binary"),   # VGG conv2
    (4, 2, 2, 512, 512, 3, 1, "bfloat16", "binary"),    # VGG conv10
    (4, 8, 8, 128, 256, 3, 1, "bfloat16", "ternary"),   # VGG conv4
    (4, 4, 4, 256, 512, 3, 1, "float32", "binary"),     # VGG conv7
    (2, 7, 5, 5, 70, 3, 2, "float32", "ternary"),       # ragged, stride 2
    (2, 7, 5, 5, 72, 3, 2, "bfloat16", "ternary"),      # ragged K, stride 2
    (3, 9, 9, 16, 24, 1, 1, "bfloat16", "binary"),      # 1x1
    (1, 16, 16, 8, 16, 3, 2, "bfloat16", "binary"),     # asymmetric SAME pad
])
def test_masked_conv_kernel_matches_plain(cuda, case):
    n, h, w, cin, cout, k, s, dname, mode = case
    dtype = getattr(torch, dname)
    x, wt, own, pm = _conv_case(n, h, w, cin, cout, k, cuda, dtype)
    before = mc.LAUNCHES
    got = mc.masked_conv2d(x, wt, own, pm, 2, stride=s, mask_mode=mode)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == before + 1
    want = mc.masked_conv2d_plain(x, wt, own, pm, 2, stride=s, mask_mode=mode)
    _check(got, want, dtype)


@pytest.mark.parametrize("case", [
    # (n, h, w, cin, cout, dtype)
    (4, 32, 32, 64, 64, "bfloat16"),     # VGG conv1
    (4, 8, 8, 256, 256, "bfloat16"),     # VGG conv5/6
    (4, 4, 4, 512, 512, "bfloat16"),     # VGG conv8/9
    (4, 2, 2, 512, 512, "bfloat16"),     # VGG conv11/12 (H < 3)
    (4, 16, 16, 128, 128, "float32"),    # VGG conv3
    (3, 5, 7, 24, 70, "float32"),        # ragged channels, odd spatial
    (2, 3, 3, 40, 8, "bfloat16"),        # multi-image tiles
    (3, 5, 7, 24, 72, "bfloat16"),       # partial channel chunk, odd spatial
    (1, 2, 128, 32, 16, "float32"),      # widest supported row
])
def test_fused_chain_kernel_matches_plain(cuda, case):
    n, h, w, cin, cout, dname = case
    dtype = getattr(torch, dname)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32)).to(cuda, dtype)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(cin).astype(np.float32) * 0.3).to(cuda)
    wt = torch.from_numpy((rng.randn(3, 3, cin, cout)
                           * np.sqrt(2.0 / (9 * cout))).astype(np.float32)).to(cuda)
    before = fc.LAUNCHES
    got = fc.fused_affine_relu_conv(x, a, b, wt, dtype)
    torch.cuda.synchronize()
    assert fc.LAUNCHES == before + 1
    _check(got, fc.fused_oracle(x, a, b, wt, dtype), dtype)


def test_masked_conv_kernel_refuses_unsupported(cuda):
    x, wt, own, pm = _conv_case(1, 4, 4, 8, 70, 3, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="Cout % 4"):
        mc.masked_conv2d(x, wt, own, pm, 2)


def test_fused_chain_kernel_refuses_unsupported(cuda):
    x = torch.zeros((1, 2, 200, 8), device=cuda)
    w = torch.zeros((3, 3, 8, 8), device=cuda)
    a = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        fc.fused_affine_relu_conv(x, a, a, w, torch.float32)
    # bf16 takes channel counts in multiples of 8 only
    x = torch.zeros((1, 4, 4, 8), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 8, 12), device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        fc.fused_affine_relu_conv(x, a, a, w, torch.bfloat16)


# ------------------------------------------------------------ backward ----

def _check_sum(got, want, rel=1e-4):
    """f32 outputs of long f32 sums (weight gradients, da/db): the kernel
    and the plain version differ only in summation order."""
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    got, want = got.cpu(), want.cpu()
    assert torch.isfinite(got).all()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= rel * scale + 1e-6, (err, scale)


@pytest.mark.parametrize("case", [
    # (n, h, w, cin, cout, k, stride, dtype, mode)
    (4, 32, 32, 3, 64, 3, 1, "bfloat16", "binary"),     # VGG conv0, K=27
    (4, 16, 16, 64, 128, 3, 1, "bfloat16", "binary"),   # VGG conv2
    (4, 2, 2, 512, 512, 3, 1, "bfloat16", "binary"),    # VGG conv10
    (4, 8, 8, 128, 256, 3, 1, "bfloat16", "ternary"),   # VGG conv4
    (4, 4, 4, 256, 512, 3, 1, "float32", "binary"),     # VGG conv7
    (2, 7, 5, 5, 70, 3, 2, "float32", "ternary"),       # ragged, stride 2
    (2, 7, 5, 5, 72, 3, 2, "bfloat16", "ternary"),      # ragged, odd Cin
    (1, 16, 16, 8, 16, 3, 2, "bfloat16", "binary"),     # asymmetric SAME pad
    (3, 9, 9, 16, 24, 1, 1, "bfloat16", "binary"),      # 1x1
])
def test_masked_conv_backward_kernels_match_plain(cuda, case):
    n, h, w, cin, cout, k, s, dname, mode = case
    dtype = getattr(torch, dname)
    x, wt, own, pm = _conv_case(n, h, w, cin, cout, k, cuda, dtype, seed=3)
    ho, wo = -(-h // s), -(-w // s)
    g = torch.randn((n, ho, wo, cout), generator=torch.Generator().manual_seed(4))
    g = g.to(cuda, dtype)
    before = (mc.LAUNCHES_BWD_DX, mc.LAUNCHES_BWD_DW)
    dx = mc.masked_conv2d_bwd_dx(g, x, wt, own, pm, 2, s, "SAME", 5e-3, mode)
    dw, dpm = mc.masked_conv2d_bwd_dw(g, x, wt, own, 2, s, "SAME")
    torch.cuda.synchronize()
    assert (mc.LAUNCHES_BWD_DX, mc.LAUNCHES_BWD_DW) == (before[0] + 1, before[1] + 1)
    want = mc.masked_conv2d_bwd_plain(g, x, wt, own, pm, 2, s, "SAME", 5e-3, mode)
    _check(dx, want[0], dtype)
    _check_sum(dw, want[1])
    _check_sum(dpm, want[2])
    assert not dw[own != 2].any() and not dpm[(own == 0) | (own >= 2)].any()
    # two launches give the same bits (split-K partials summed in order)
    dx2 = mc.masked_conv2d_bwd_dx(g, x, wt, own, pm, 2, s, "SAME", 5e-3, mode)
    dw2, dpm2 = mc.masked_conv2d_bwd_dw(g, x, wt, own, 2, s, "SAME")
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2) and torch.equal(dpm, dpm2)


@pytest.mark.parametrize("case", [
    # (n, h, w, cin, cout, dtype)
    (4, 32, 32, 64, 64, "bfloat16"),     # VGG conv1
    (4, 8, 8, 256, 256, "bfloat16"),     # VGG conv5/6
    (4, 2, 2, 512, 512, "bfloat16"),     # VGG conv11/12 (H < 3)
    (4, 16, 16, 128, 128, "float32"),    # VGG conv3
    (3, 5, 7, 24, 70, "float32"),        # ragged channels, odd spatial
    (2, 3, 3, 40, 8, "bfloat16"),        # several images per tile
    (3, 5, 7, 24, 72, "bfloat16"),       # partial channel tile
    (2, 2, 2, 8, 16, "float32"),         # 2x2, f32
])
def test_fused_chain_backward_kernels_match_plain(cuda, case):
    n, h, w, cin, cout, dname = case
    dtype = getattr(torch, dname)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32)).to(cuda, dtype)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(cin).astype(np.float32) * 0.3).to(cuda)
    wt = torch.from_numpy((rng.randn(3, 3, cin, cout)
                           * np.sqrt(2.0 / (9 * cout))).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(n, h, w, cout).astype(np.float32)).to(cuda, dtype)
    before = (fc.LAUNCHES_BWD_DX, fc.LAUNCHES_BWD_DW)
    dx, da, db = fc.fused_bwd_dx(x, a, b, wt, g, dtype)
    dw = fc.fused_bwd_dw(x, a, b, g, dtype)
    torch.cuda.synchronize()
    assert (fc.LAUNCHES_BWD_DX, fc.LAUNCHES_BWD_DW) == (before[0] + 1, before[1] + 1)
    want = fc.fused_bwd_plain(x, a, b, wt, g, dtype)
    _check(dx, want[0], dtype)
    _check_sum(da, want[1], 1e-3)
    _check_sum(db, want[2], 1e-3)
    _check_sum(dw, want[3])
    again = fc.fused_bwd_dx(x, a, b, wt, g, dtype) + (
        fc.fused_bwd_dw(x, a, b, g, dtype),)
    for first, second in zip((dx, da, db, dw), again):
        assert torch.equal(first, second)


# ------------------------------------- K4 and K5 on the conv GEMM route ----

@pytest.mark.parametrize("n,cin,cout", [
    (1, 64, 64), (1, 128, 64),        # one tile at BN 64, 1 and 2 blocks
    (68, 64, 128), (68, 128, 128),    # 68 tiles: the plan takes BN 128
])
def test_fused_fwd_tiles_of_small_integers_are_exact(cuda, n, cin, cout):
    """K4's wgmma with A from registers on 128-pixel tiles (8 rows of 16)
    at BN 64 and 128, one and two channel blocks: x in 0..3, a = 1, b = 0
    and w in -2..2 make every product and sum exact, so y must equal the
    plain version bit for bit, and a wrong fragment layout, tap shift or
    descriptor shows as a wrong integer."""
    rng = np.random.RandomState(cin + cout)
    x = torch.from_numpy(rng.randint(0, 4, (n, 8, 16, cin)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    wt = torch.from_numpy(rng.randint(-2, 3, (3, 3, cin, cout)).astype(
        np.float32)).to(cuda)
    a = torch.ones(cin, device=cuda)
    b = torch.zeros(cin, device=cuda)
    assert fc.fwd_route(x, wt.bfloat16(), torch.bfloat16)
    assert mm.fused_fwd_plan(n, 8, 16, cin, cout, mm._sms(0))[1] == cout
    before = fc.LAUNCHES
    got = fc.fused_affine_relu_conv(x, a, b, wt, torch.bfloat16)
    torch.cuda.synchronize()
    assert fc.LAUNCHES == before + 1
    want = fc.fused_oracle(x, a, b, wt, torch.bfloat16)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


# (H = W, Cin, Cout) of VGG16-BN's seam grids at width 1.0
FUSED_ROUTE_SEAMS = [(32, 64, 64), (16, 128, 128), (8, 256, 256),
                     (4, 512, 512), (2, 512, 512)]


@pytest.mark.parametrize("positive_b", [False, True])
@pytest.mark.parametrize("seam", FUSED_ROUTE_SEAMS,
                         ids=[f"{s[0]}x{s[0]}" for s in FUSED_ROUTE_SEAMS])
def test_fused_route_matches_plain(cuda, seam, positive_b):
    """K4 and K5 on the GEMM route at each seam grid with N = 3 (at 4x4
    and 2x2 a box of 8 and 32 images, partly past N), against the plain
    versions; with b > 0 in every channel a padding of relu(b) would show.
    Two launches give the same bits (K5's da and db too)."""
    hw, cin, cout = seam
    n = 3
    rng = np.random.RandomState(hw + positive_b)
    x = torch.from_numpy(rng.randn(n, hw, hw, cin).astype(np.float32)).to(
        cuda, torch.bfloat16)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32)).to(cuda)
    b = rng.randn(cin).astype(np.float32) * 0.3
    b = torch.from_numpy(np.abs(b) + 0.1 if positive_b else b).to(cuda)
    wt = torch.from_numpy((rng.randn(3, 3, cin, cout) * np.sqrt(
        2.0 / (9 * cout))).astype(np.float32)).to(cuda).bfloat16()
    g = torch.from_numpy(rng.randn(n, hw, hw, cout).astype(np.float32)).to(
        cuda, torch.bfloat16)
    assert fc.fwd_route(x, wt, torch.bfloat16)
    assert fc.gemm_route(x, wt, torch.bfloat16)
    before = (fc.LAUNCHES, fc.LAUNCHES_BWD_DX)
    y = fc.fused_affine_relu_conv(x, a, b, wt, torch.bfloat16)
    dx, da, db = fc.fused_bwd_dx(x, a, b, wt, g, torch.bfloat16)
    torch.cuda.synchronize()
    assert (fc.LAUNCHES, fc.LAUNCHES_BWD_DX) == (before[0] + 1, before[1] + 1)
    _check(y, fc.fused_oracle(x, a, b, wt, torch.bfloat16), torch.bfloat16)
    want = fc.fused_bwd_dx_plain(x, a, b, wt, g, torch.bfloat16)
    _check(dx, want[0], torch.bfloat16)
    _check_sum(da, want[1], 1e-3)
    _check_sum(db, want[2], 1e-3)
    assert torch.equal(y, fc.fused_affine_relu_conv(x, a, b, wt,
                                                    torch.bfloat16))
    for first, second in zip((dx, da, db),
                             fc.fused_bwd_dx(x, a, b, wt, g, torch.bfloat16)):
        assert torch.equal(first, second)


def test_fused_1x1_grid_takes_the_earlier_k4_and_k5s_route(cuda):
    """A bf16 1x1 grid with 64-multiple channels: K4's halo tile (128
    images a box) does not fit, so `fwd_route` sends it to the earlier
    K4, which still matches `fused_oracle`; K5 takes its GEMM route (one
    pixel a image a box) and matches its plain version."""
    rng = np.random.RandomState(11)
    n, c = 130, 64   # two 128-image tiles, the second partly past N
    x = torch.from_numpy(rng.randn(n, 1, 1, c).astype(np.float32)).to(
        cuda, torch.bfloat16)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(cuda)
    b = torch.from_numpy(np.abs(rng.randn(c)).astype(np.float32) * 0.3
                         + 0.1).to(cuda)
    wt = torch.from_numpy((rng.randn(3, 3, c, c) * np.sqrt(
        2.0 / (9 * c))).astype(np.float32)).to(cuda).bfloat16()
    g = torch.from_numpy(rng.randn(n, 1, 1, c).astype(np.float32)).to(
        cuda, torch.bfloat16)
    assert not fc.fwd_route(x, wt, torch.bfloat16)
    assert fc.gemm_route(x, wt, torch.bfloat16)
    y = fc.fused_affine_relu_conv(x, a, b, wt, torch.bfloat16)
    _check(y, fc.fused_oracle(x, a, b, wt, torch.bfloat16), torch.bfloat16)
    dx, da, db = fc.fused_bwd_dx(x, a, b, wt, g, torch.bfloat16)
    want = fc.fused_bwd_dx_plain(x, a, b, wt, g, torch.bfloat16)
    _check(dx, want[0], torch.bfloat16)
    _check_sum(da, want[1], 1e-3)
    _check_sum(db, want[2], 1e-3)


def test_fused_dx_mask_is_the_plain_versions_bit_for_bit(cuda):
    """K5's ReLU mask rounds a*x and + b apart, as the plain version does:
    with g's sums exact (small integers) dx equals the plain dx bit for
    bit, including at entries where a*x + b is exactly 0 and where an FMA
    would round the other way."""
    rng = np.random.RandomState(7)
    n, hw, c = 2, 8, 64
    x = torch.from_numpy(rng.randn(n, hw, hw, c).astype(np.float32)).to(
        cuda, torch.bfloat16)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(cuda)
    b = (-x[0, 0, 0].float() * a).contiguous()   # a*x + b == 0 at pixel 0
    wt = torch.from_numpy(rng.randint(-2, 3, (3, 3, c, c)).astype(
        np.float32)).to(cuda).bfloat16()
    g = torch.from_numpy(rng.randint(-2, 3, (n, hw, hw, c)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    dx = fc.fused_bwd_dx(x, a, b, wt, g, torch.bfloat16)[0]
    want = fc.fused_bwd_dx_plain(x, a, b, wt, g, torch.bfloat16)[0]
    assert not want[0, 0, 0].any()
    assert torch.equal(dx, want)


@pytest.mark.parametrize("case", [
    # (n, h, w, cin, cout): every VGG16-BN seam (halo steps at 32x32 and
    # 16x16, whole images below), N = 1, odd and 1x1 images (only the
    # centre tap sees data), Cin 8 and 520 (a partial 32-channel slice),
    # Cout 8 and 24 (a partial 64-channel slice), W = 128 (one row a step)
    (8, 32, 32, 64, 64), (8, 16, 16, 128, 128), (8, 8, 8, 256, 256),
    (8, 4, 4, 512, 512), (8, 2, 2, 512, 512), (1, 32, 32, 64, 64),
    (3, 3, 5, 24, 72), (2, 1, 1, 8, 8), (1, 5, 7, 8, 24),
    (1, 3, 5, 520, 24), (2, 7, 5, 520, 8), (1, 1, 1, 520, 24),
    (2, 2, 128, 8, 8),
])
def test_fused_chain_dw_tiling_edges_match_plain(cuda, case):
    """K6 in bf16 at the edges of its tiling: against the plain version
    (f32 sums in another order), and two launches give the same bits."""
    n, h, w, cin, cout = case
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32)).to(
        cuda, torch.bfloat16)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, cin).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(cin).astype(np.float32) * 0.3).to(cuda)
    g = torch.from_numpy(rng.randn(n, h, w, cout).astype(np.float32)).to(
        cuda, torch.bfloat16)
    before = fc.LAUNCHES_BWD_DW
    dw = fc.fused_bwd_dw(x, a, b, g, torch.bfloat16)
    torch.cuda.synchronize()
    assert fc.LAUNCHES_BWD_DW == before + 1
    _check_sum(dw, fc.fused_bwd_dw_plain(x, a, b, g, torch.bfloat16))
    assert torch.equal(dw, fc.fused_bwd_dw(x, a, b, g, torch.bfloat16))


def test_fused_chain_dw_refuses_rows_wider_than_a_step(cuda):
    x = torch.zeros((1, 2, 136, 8), device=cuda, dtype=torch.bfloat16)
    a = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="W <= 128"):
        fc.fused_bwd_dw(x, a, a, x, torch.bfloat16)


def test_autograd_reaches_every_input_through_the_kernels(cuda):
    """loss.backward() through both Functions on the card gives x, w, pm,
    a and b their gradients, equal to the plain path's on the CPU (f32:
    the masked conv takes K1 and K2, off the GEMM route)."""
    rng = np.random.RandomState(7)
    x0 = rng.randn(2, 8, 8, 16).astype(np.float32)
    w1 = (rng.randn(3, 3, 16, 32) * 0.2).astype(np.float32)
    own = rng.choice([0, 1, 2], size=w1.shape).astype(np.int8)
    pm = (rng.randn(*w1.shape) * 0.01 + 0.005).astype(np.float32)
    a = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    b = (rng.randn(32) * 0.3).astype(np.float32)
    w2 = (rng.randn(3, 3, 32, 24) * 0.2).astype(np.float32)
    gout = rng.randn(2, 8, 8, 24).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [torch.tensor(v, device=dev, requires_grad=True)
                  for v in (x0, w1, pm, a, b, w2)]
        tx, tw1, tpm, ta, tb, tw2 = leaves
        mc_before, fc_before = mc.LAUNCHES_BWD_DW, fc.LAUNCHES_BWD_DW
        y1 = mc.masked_conv2d(tx, tw1, torch.from_numpy(own).to(dev), tpm, 2)
        y2 = fc.fused_affine_relu_conv(y1, ta, tb, tw2, torch.float32)
        assert y1.grad_fn is not None and y2.grad_fn is not None
        (y2 * torch.from_numpy(gout).to(dev)).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert mc.LAUNCHES_BWD_DW == mc_before + 1
            assert fc.LAUNCHES_BWD_DW == fc_before + 1
        grads[str(dev)] = [t.grad.detach().cpu() for t in leaves]
    for name, got, want in zip("x w pm a b w2".split(), grads["cuda"], grads["cpu"]):
        assert got.abs().max() > 0, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# ----------------------------------------------- masked conv GEMM route ----

# (layer, H = W, Cin, Cout) of VGG16-BN's masked convs on the route
CONV_ROUTE_LAYERS = [("conv2", 16, 64, 128), ("conv4", 8, 128, 256),
                     ("conv7", 4, 256, 512), ("conv10", 2, 512, 512)]


@pytest.mark.parametrize("n", [256, 3])
@pytest.mark.parametrize("mode", ["binary", "ternary"])
@pytest.mark.parametrize("layer", CONV_ROUTE_LAYERS,
                         ids=[c[0] for c in CONV_ROUTE_LAYERS])
def test_conv_gemm_route_matches_plain(cuda, layer, mode, n):
    """conv2/4/7/10 in bf16 take the select pass + TMA/wgmma implicit GEMM
    for y and dx (one select each, no K1/K2 launch): within 2e-2 * max|ref|
    of the plain versions at batch 256 and at a ragged batch of 3, and two
    launches give the same bits."""
    _, hw, cin, cout = layer
    x, wt, own, pm = _conv_case(n, hw, hw, cin, cout, 3, cuda, torch.bfloat16,
                                seed=hw)
    g = torch.from_numpy(np.random.RandomState(hw + 1).randn(
        n, hw, hw, cout).astype(np.float32)).to(cuda, torch.bfloat16)
    assert mc.conv_route(x, wt, 1, "SAME")
    before = (mc.LAUNCHES, mc.LAUNCHES_BWD_DX, mc.LAUNCHES_SELECT)
    y = mc.masked_conv2d(x, wt, own, pm, 2, mask_mode=mode)
    dx = mc.masked_conv2d_bwd_dx(g, x, wt, own, pm, 2, mask_mode=mode)
    torch.cuda.synchronize()
    assert (mc.LAUNCHES, mc.LAUNCHES_BWD_DX, mc.LAUNCHES_SELECT) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    _check(y, mc.masked_conv2d_plain(x, wt, own, pm, 2, mask_mode=mode),
           torch.bfloat16)
    _check(dx, mc.masked_conv2d_bwd_dx_plain(g, x, wt, own, pm, 2,
                                             mask_mode=mode), torch.bfloat16)
    assert torch.equal(y, mc.masked_conv2d(x, wt, own, pm, 2, mask_mode=mode))
    assert torch.equal(dx, mc.masked_conv2d_bwd_dx(g, x, wt, own, pm, 2,
                                                   mask_mode=mode))


@pytest.mark.parametrize("case", [
    # (n, H = W, Cin, Cout, dtype): conv0 (Cin = 3), conv2 at width 0.125,
    # conv7 in f32
    (4, 32, 3, 64, "bfloat16"), (4, 16, 8, 16, "bfloat16"),
    (2, 4, 256, 512, "float32"),
])
def test_conv_off_the_route_takes_k1_and_k2(cuda, case):
    n, hw, cin, cout, dname = case
    dtype = getattr(torch, dname)
    x, wt, own, pm = _conv_case(n, hw, hw, cin, cout, 3, cuda, dtype, seed=5)
    g = torch.from_numpy(np.random.RandomState(6).randn(
        n, hw, hw, cout).astype(np.float32)).to(cuda, dtype)
    assert not mc.conv_route(x, wt, 1, "SAME")
    before = (mc.LAUNCHES, mc.LAUNCHES_BWD_DX, mc.LAUNCHES_SELECT)
    y = mc.masked_conv2d(x, wt, own, pm, 2)
    dx = mc.masked_conv2d_bwd_dx(g, x, wt, own, pm, 2)
    torch.cuda.synchronize()
    assert (mc.LAUNCHES, mc.LAUNCHES_BWD_DX, mc.LAUNCHES_SELECT) == (
        before[0] + 1, before[1] + 1, before[2])
    _check(y, mc.masked_conv2d_plain(x, wt, own, pm, 2), dtype)
    _check(dx, mc.masked_conv2d_bwd_dx_plain(g, x, wt, own, pm, 2), dtype)


@pytest.mark.parametrize("mode", ["binary", "ternary"])
@pytest.mark.parametrize("case", [
    # (n, H, W, k, stride, padding, Cin, Cout, route)
    (4, 28, 24, 3, 2, 1, 128, 128, "im2col"),      # 3x3/2, pad 1
    (3, 7, 6, 3, 1, "SAME", 64, 128, "im2col"),    # 3x3 at wo = 6
    (4, 14, 14, 1, 2, "SAME", 64, 128, "im2col"),  # 1x1/2
    (2, 9, 8, 3, 2, "SAME", 64, 64, "im2col"),     # pads (1, 1) and (0, 1)
    (2, 13, 11, 3, 2, "SAME", 128, 192, "im2col"),  # odd sides, 192 wide
    (4, 14, 14, 1, 1, "SAME", 128, 64, "dense"),   # 1x1 at stride 1
    (256, 14, 12, 3, 1, "SAME", 256, 256, "im2col"),  # SphereNet's unit3
], ids=["3x3s2", "wo6", "1x1s2", "3x3s2_mixed_pads", "3x3s2_odd",
        "1x1_dense", "sphere_unit3"])
def test_im2col_and_dense_routes_match_plain(cuda, case, mode):
    """bf16 convs off the boxes with Cin and Cout multiples of 64 take the
    select pass and the im2col walk (or, 1x1 at stride 1, the dense GEMM)
    for y and dx (one select each, no K1/K2 launch): within 2e-2 * max|ref|
    of the plain versions, two launches equal bits."""
    n, h, w, k, s, pad, cin, cout, route = case
    x, wt, own, pm = _conv_case(n, h, w, cin, cout, k, cuda, torch.bfloat16,
                                seed=h + w)
    y = mc.masked_conv2d_plain(x, wt, own, pm, 2, s, pad, mask_mode=mode)
    g = torch.from_numpy(np.random.RandomState(h).randn(
        *y.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    assert mc.fwd_dx_route(x, wt, s, pad) == route
    before = (mc.LAUNCHES, mc.LAUNCHES_BWD_DX, mc.LAUNCHES_SELECT)
    got_y = mc.masked_conv2d(x, wt, own, pm, 2, s, pad, mask_mode=mode)
    got_dx = mc.masked_conv2d_bwd_dx(g, x, wt, own, pm, 2, s, pad,
                                     mask_mode=mode)
    torch.cuda.synchronize()
    assert (mc.LAUNCHES, mc.LAUNCHES_BWD_DX, mc.LAUNCHES_SELECT) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    _check(got_y, y, torch.bfloat16)
    _check(got_dx, mc.masked_conv2d_bwd_dx_plain(g, x, wt, own, pm, 2, s, pad,
                                                 mask_mode=mode),
           torch.bfloat16)
    assert torch.equal(got_y, mc.masked_conv2d(x, wt, own, pm, 2, s, pad,
                                               mask_mode=mode))
    assert torch.equal(got_dx, mc.masked_conv2d_bwd_dx(
        g, x, wt, own, pm, 2, s, pad, mask_mode=mode))


def test_conv_gemm_route_refuses_a_misaligned_tensor(cuda):
    """On the route, a g (or pm) off a 16-byte boundary raises; nothing
    falls back to K2."""
    x, wt, own, pm = _conv_case(2, 8, 8, 128, 256, 3, cuda, torch.bfloat16)
    assert mc.conv_route(x, wt, 1, "SAME")
    flat = torch.zeros(2 * 8 * 8 * 256 + 4, device=cuda, dtype=torch.bfloat16)
    g = flat[4:].view(2, 8, 8, 256)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mc.masked_conv2d_bwd_dx(g, x, wt, own, pm, 2)
    pm_off = torch.zeros(pm.numel() + 1, device=cuda)[1:].view(pm.shape)
    with pytest.raises(ValueError, match="16-byte"):
        mc.masked_conv2d(x, wt, own, pm_off, 2)


def test_autograd_reaches_x_w_and_pm_through_the_conv_gemm_route(cuda):
    """loss.backward() through a bf16 masked conv on the route: two selects
    (y and dx), K3 for dw and dpm; the gradients match the plain path's
    on the CPU (bf16 y and dx: 2e-2 * max|ref|; dw, dpm: f32 sums of bf16
    terms in another order, 1e-3 * max|ref|)."""
    rng = np.random.RandomState(10)
    x0 = rng.randn(2, 8, 8, 64).astype(np.float32)
    w1 = (rng.randn(3, 3, 64, 64) * 0.06).astype(np.float32)
    own = rng.choice([0, 1, 2], size=w1.shape).astype(np.int8)
    pm = (rng.randn(*w1.shape) * 0.01 + 0.005).astype(np.float32)
    gout = rng.randn(2, 8, 8, 64).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        tx = torch.tensor(x0, device=dev).bfloat16().requires_grad_(True)
        tw = torch.tensor(w1, device=dev, requires_grad=True)
        tpm = torch.tensor(pm, device=dev, requires_grad=True)
        before = mc.LAUNCHES_SELECT
        y = mc.masked_conv2d(tx, tw, torch.from_numpy(own).to(dev), tpm, 2)
        (y.float() * torch.from_numpy(gout).to(dev)).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert mc.LAUNCHES_SELECT == before + 2
        grads[str(dev)] = [t.grad.detach().cpu() for t in (tx, tw, tpm)]
    for name, got, want, rel in zip(("x", "w", "pm"), grads["cuda"],
                                    grads["cpu"], (2e-2, 1e-3, 1e-3)):
        assert got.dtype == want.dtype and got.abs().max() > 0, name
        err = (got.float() - want.float()).abs().max().item()
        assert err <= rel * want.float().abs().max().item(), name


# ------------------------------------------------------ flash attention ----

def _qkv(n, t, h, hd, device, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(n, t, h, hd).astype(np.float32))
            .to(device, dtype) for _ in range(4)]


@pytest.mark.parametrize("case", [
    # (n, t, h, hd, causal, dtype)
    (8, 64, 4, 64, False, "bfloat16"),     # vit_cifar (batch cut to 8)
    (2, 196, 12, 64, False, "bfloat16"),   # vit_b16: ragged key tile
    (2, 70, 2, 64, True, "bfloat16"),      # the JAX tests' causal shape
    (2, 70, 2, 64, False, "float32"),
    (2, 70, 2, 64, True, "float32"),
    (3, 5, 2, 32, True, "bfloat16"),       # T < one tile, hd 32
    (256, 64, 4, 32, True, "bfloat16"),    # textcls: causal, hd 32
    (256, 64, 4, 32, False, "bfloat16"),
    (2, 130, 3, 16, False, "bfloat16"),    # three key tiles, hd 16
    (1, 40, 2, 128, True, "bfloat16"),     # hd 128
    (1, 40, 2, 128, False, "float32"),
])
def test_flash_kernels_match_plain(cuda, case):
    """Forward (o, lse), dq (with D) and dk/dv against the plain versions;
    two runs give the same bits. lse and the f32 runs at rtol/atol 1e-4
    (exp2 with pre-scaled scores against exp: f32 rounding only), bf16
    tensors at max|diff| <= 2e-2 * max|ref| (p and ds rounded to bf16
    inside 64-key tiles against the whole row)."""
    n, t, h, hd, causal, dname = case
    dtype = getattr(torch, dname)
    q, k, v, do = _qkv(n, t, h, hd, cuda, dtype)
    before = (fl.LAUNCHES, fl.LAUNCHES_BWD_DQ, fl.LAUNCHES_BWD_DKV)
    o, lse = fl.flash_fwd(q, k, v, causal)
    dq, d = fl.flash_bwd_dq(q, k, v, o, lse, do, causal)
    grads = (dq, *fl.flash_bwd_dkv(q, k, v, do, lse, d, causal))
    torch.cuda.synchronize()
    assert (fl.LAUNCHES, fl.LAUNCHES_BWD_DQ, fl.LAUNCHES_BWD_DKV) == tuple(
        b + 1 for b in before)
    o_ref, lse_ref = fl.flash_mha_plain(q, k, v, causal)
    _check(o, o_ref, dtype)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    want = fl.flash_mha_bwd_plain(q, k, v, o, lse, do, causal)
    for got, ref in zip(grads, want):
        _check(got, ref, dtype)
    _, d_ref = fl.flash_mha_bwd_dq_plain(q, k, v, o, lse, do, causal)
    _check_sum(d, d_ref)
    o2, lse2 = fl.flash_fwd(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    dq2, d2 = fl.flash_bwd_dq(q, k, v, o, lse, do, causal)
    assert torch.equal(dq, dq2) and torch.equal(d, d2)
    for first, second in zip(grads[1:], fl.flash_bwd_dkv(q, k, v, do, lse, d, causal)):
        assert torch.equal(first, second)


@pytest.mark.parametrize("case", [
    # (n, t, h, hd, causal): H 1, 3 and 12; T 1, 63, 65, 70, 196 and 257
    # (one query tile, ragged key tiles, 128-query items from T = 65 at hd
    # <= 64); hd 16, 32, 64 and 128; item counts that the persistent grid
    # does not divide (201 x 3 and 67 x 2 x 12 items)
    (2, 1, 1, 64, False), (2, 1, 3, 16, True), (3, 63, 3, 32, False),
    (3, 63, 1, 64, True), (2, 65, 12, 64, False), (2, 65, 3, 128, True),
    (2, 70, 3, 16, True), (1, 196, 12, 64, False), (1, 196, 12, 64, True),
    (2, 257, 3, 32, False), (2, 257, 1, 128, True), (5, 70, 3, 64, False),
    (201, 64, 3, 64, False), (67, 196, 12, 64, False),
])
def test_flash_fwd_persistent_grid_edges_match_plain(cuda, case):
    """K7 forward in bf16 at the edges of its persistent tiling: o and lse
    against the plain version, and two launches give the same bits."""
    n, t, h, hd, causal = case
    q, k, v, _ = _qkv(n, t, h, hd, cuda, torch.bfloat16, seed=3)
    before = fl.LAUNCHES
    o, lse = fl.flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fl.LAUNCHES == before + 1
    o_ref, lse_ref = fl.flash_mha_plain(q, k, v, causal)
    _check(o, o_ref, torch.bfloat16)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    o2, lse2 = fl.flash_fwd(q, k, v, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    if (n, h) in ((201, 3), (67, 12)):
        items, grid = fl.fwd_grid(n, t, h, hd, torch.cuda.get_device_properties(
            cuda).multi_processor_count)
        assert items % grid


# the cases of test_flash_kernels_match_plain that `bwd_route` takes, then
# ragged T around the walks' edges (one query tile, one and two key blocks,
# a slot past T), causal and not
FLASH_BWD_CASES = [(8, 64, 4, 64, False), (2, 196, 12, 64, False),
                   (2, 70, 2, 64, True)] + [
    (n, t, h, 64, causal)
    for n, t, h in [(3, 1, 3), (3, 63, 3), (5, 64, 3), (2, 65, 3),
                    (2, 127, 2), (2, 128, 3), (2, 129, 2), (1, 196, 3),
                    (2, 255, 2), (2, 256, 3)]
    for causal in (False, True)]


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_bwd_matches_plain(cuda, case):
    """The one-launch backward (csrc/flash_bwd_wgmma.cu) against
    flash_mha_bwd_plain at max|diff| <= 2e-2 * max|ref| + 1e-5 (p and ds
    rounded to bf16 in 64-query tiles against the whole row; the 1e-5
    floor is for T = 1, where dq and dk are exactly 0 in exact arithmetic,
    D = dO . o = dO . v, and both sides give f32 rounding noise of ~1e-6);
    one launch each, and two launches give the same bits (dq summed in
    key-block order)."""
    n, t, h, hd, causal = case
    q, k, v, do = _qkv(n, t, h, hd, cuda, torch.bfloat16, seed=5)
    assert fl.bwd_route(q)
    o, lse = fl.flash_fwd(q, k, v, causal)
    before = (fl.LAUNCHES_BWD, fl.LAUNCHES_BWD_DQ, fl.LAUNCHES_BWD_DKV)
    grads = fl.flash_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (fl.LAUNCHES_BWD, fl.LAUNCHES_BWD_DQ, fl.LAUNCHES_BWD_DKV) == (
        before[0] + 1, before[1], before[2])
    want = fl.flash_mha_bwd_plain(q, k, v, o, lse, do, causal)
    for got, ref in zip(grads, want):
        assert got.dtype == ref.dtype == torch.bfloat16
        got, ref = got.float().cpu(), ref.float().cpu()
        assert torch.isfinite(got).all()
        err = (got - ref).abs().max().item()
        assert err <= 2e-2 * ref.abs().max().item() + 1e-5, err
    for first, second in zip(grads, fl.flash_bwd(q, k, v, o, lse, do, causal)):
        assert torch.equal(first, second)


@pytest.mark.parametrize("case", [
    # (n, t, h, hd, dtype): T past the route, f32, head dims it does not take
    (2, 320, 2, 64, "bfloat16"), (2, 70, 2, 64, "float32"),
    (3, 5, 2, 32, "bfloat16"), (1, 40, 2, 128, "bfloat16"),
    (256, 64, 4, 32, "bfloat16")])  # textcls
def test_flash_backward_off_the_route_takes_the_pair(cuda, case):
    """Through flash_mha's autograd, a shape off `bwd_route` launches
    flash_bwd_dq and flash_bwd_dkv once each and not the one-launch kernel,
    which raises there."""
    n, t, h, hd, dname = case
    dtype = getattr(torch, dname)
    q, k, v, do = _qkv(n, t, h, hd, cuda, dtype, seed=6)
    assert not fl.bwd_route(q)
    qkv = [a.clone().requires_grad_(True) for a in (q, k, v)]
    out = fl.flash_mha(*qkv, causal=False)
    before = (fl.LAUNCHES_BWD, fl.LAUNCHES_BWD_DQ, fl.LAUNCHES_BWD_DKV)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fl.LAUNCHES_BWD, fl.LAUNCHES_BWD_DQ, fl.LAUNCHES_BWD_DKV) == (
        before[0], before[1] + 1, before[2] + 1)
    o, lse = fl.flash_fwd(q, k, v)
    want = fl.flash_mha_bwd_plain(q, k, v, o, lse, do)
    for a, ref in zip(qkv, want):
        _check(a.grad, ref, dtype)
    with pytest.raises(ValueError, match="off its route"):
        fl.flash_bwd(q, k, v, o, lse, do)


def test_flash_kernel_refuses_unsupported(cuda):
    q = torch.zeros((1, 8, 2, 24), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fl.flash_mha(q, q, q)


# ----------------------------------------------------- dense masked route ----

@pytest.mark.parametrize("case", [
    # (m, k, n, dtype, mode)
    (4096, 256, 256, "bfloat16", "binary"),    # vit_cifar q/k/v/proj, batch 64
    (4096, 256, 1024, "bfloat16", "binary"),   # fc1
    (4096, 1024, 256, "bfloat16", "ternary"),  # fc2
    (2 * 196, 768, 768, "bfloat16", "binary"),  # vit_b16 q/k/v/proj, ragged M
    (2 * 196, 768, 3072, "bfloat16", "binary"),  # vit_b16 fc1
    (2 * 196, 3072, 768, "bfloat16", "binary"),  # vit_b16 fc2
    (256 * 64, 128, 128, "bfloat16", "binary"),  # textcls q/k/v/proj
    (256 * 64, 128, 512, "bfloat16", "binary"),  # textcls fc1
    (256 * 64, 512, 128, "bfloat16", "binary"),  # textcls fc2
    (333, 40, 36, "bfloat16", "ternary"),      # ragged M, K, N
    (300, 70, 50, "float32", "binary"),        # f32, any width
])
def test_dense_route_matches_plain(cuda, case):
    """masked_matmul's three kernels (K1-K3 at the 1x1 geometry) against
    the plain versions; dw/dpm gated; two runs give the same bits."""
    m, kd, nd, dname, mode = case
    dtype = getattr(torch, dname)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(m, kd).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rng.randn(kd, nd) / np.sqrt(kd)).astype(np.float32)).to(cuda)
    own = torch.from_numpy(rng.choice([0, 1, 2, 3], size=(kd, nd)).astype(np.int8)).to(cuda)
    pm = torch.from_numpy((rng.randn(kd, nd) * 0.01).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(m, nd).astype(np.float32)).to(cuda, dtype)
    before = (mm.LAUNCHES, mm.LAUNCHES_BWD_DX, mm.LAUNCHES_BWD_DW)
    conv_before = (mc.LAUNCHES, mc.LAUNCHES_BWD_DX, mc.LAUNCHES_BWD_DW)
    y = mm.masked_matmul(x, w, own, pm, 2, mask_mode=mode)
    dx = mm.masked_matmul_bwd_dx(g, x, w, own, pm, 2, mask_mode=mode)
    dw, dpm = mm.masked_matmul_bwd_dw(g, x, w, own, 2)
    torch.cuda.synchronize()
    assert (mm.LAUNCHES, mm.LAUNCHES_BWD_DX, mm.LAUNCHES_BWD_DW) == tuple(
        b + 1 for b in before)
    assert (mc.LAUNCHES, mc.LAUNCHES_BWD_DX, mc.LAUNCHES_BWD_DW) == conv_before
    _check(y, mm.masked_matmul_plain(x, w, own, pm, 2, mask_mode=mode), dtype)
    _check(dx, mm.masked_matmul_bwd_dx_plain(g, x, w, own, pm, 2,
                                             mask_mode=mode), dtype)
    dw_ref, dpm_ref = mm.masked_matmul_bwd_dw_plain(g, x, w, own, 2)
    _check_sum(dw, dw_ref)
    _check_sum(dpm, dpm_ref)
    assert not dw[own != 2].any() and not dpm[(own == 0) | (own >= 2)].any()
    y2 = mm.masked_matmul(x, w, own, pm, 2, mask_mode=mode)
    dw2, dpm2 = mm.masked_matmul_bwd_dw(g, x, w, own, 2)
    assert torch.equal(y, y2) and torch.equal(dw, dw2) and torch.equal(dpm, dpm2)


def _dense_case(m, kd, nd, device, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, kd).astype(np.float32)).to(device, dtype)
    w = torch.from_numpy((rng.randn(kd, nd) / np.sqrt(kd)).astype(np.float32)).to(device)
    own = torch.from_numpy(rng.choice([0, 1, 2, 3], size=(kd, nd)).astype(np.int8)).to(device)
    pm = torch.from_numpy((rng.randn(kd, nd) * 0.01).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.randn(m, nd).astype(np.float32)).to(device, dtype)
    return x, w, own, pm, g


@pytest.mark.parametrize("case", [
    # (m, k, n, mode): ragged M, K not a multiple of 64, N = 8
    (1000, 200, 72, "binary"),
    (333, 40, 8, "ternary"),
    (129, 8, 264, "binary"),
    (4096, 256, 256, "ternary"),       # vit_cifar q/k/v/proj, batch 64
    (2 * 196, 768, 768, "binary"),     # vit_b16 q/k/v/proj, 128 x 192 tiles
])
def test_dense_gemm_route_matches_plain(cuda, case):
    """bf16 shapes with K, N multiples of 8 take the select pass + TN GEMM
    (`csrc/masked_matmul.cu`) for y and dx: one select and one GEMM a
    product, no 1x1 launch; y and dx agree with the plain versions and two
    runs give the same bits."""
    m, kd, nd, mode = case
    x, w, own, pm, g = _dense_case(m, kd, nd, cuda, torch.bfloat16, seed=11)
    assert mm.gemm_route(x, w, own, pm) and mm.gemm_route(g, w, own, pm)
    before = (mm.LAUNCHES, mm.LAUNCHES_BWD_DX, mm.LAUNCHES_SELECT)
    y = mm.masked_matmul(x, w, own, pm, 2, mask_mode=mode)
    dx = mm.masked_matmul_bwd_dx(g, x, w, own, pm, 2, mask_mode=mode)
    torch.cuda.synchronize()
    assert (mm.LAUNCHES, mm.LAUNCHES_BWD_DX, mm.LAUNCHES_SELECT) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    _check(y, mm.masked_matmul_plain(x, w, own, pm, 2, mask_mode=mode),
           torch.bfloat16)
    _check(dx, mm.masked_matmul_bwd_dx_plain(g, x, w, own, pm, 2,
                                             mask_mode=mode), torch.bfloat16)
    y2 = mm.masked_matmul(x, w, own, pm, 2, mask_mode=mode)
    dx2 = mm.masked_matmul_bwd_dx(g, x, w, own, pm, 2, mask_mode=mode)
    assert torch.equal(y, y2) and torch.equal(dx, dx2)


@pytest.mark.parametrize("case", [(64, 64), (200, 72), (768, 768), (8, 264)])
@pytest.mark.parametrize("mode", ["binary", "ternary"])
def test_dense_select_kernel_matches_plain_bit_for_bit(cuda, case, mode):
    kd, nd = case
    _, w, own, pm, _ = _dense_case(8, kd, nd, cuda, torch.bfloat16, seed=12)
    for transpose in (False, True):
        got = mm.masked_matmul_select(w, own, pm, 3, mask_mode=mode,
                                      transpose=transpose)
        want = mm.masked_matmul_select_plain(w, own, pm, 3, mask_mode=mode,
                                             transpose=transpose)
        torch.cuda.synchronize()
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("case", [(1, 8, 8), (127, 64, 64), (1000, 200, 72),
                                  (256, 520, 136), (16384, 256, 1024)])
def test_dense_gemm_kernel_matches_plain(cuda, case):
    """The TN GEMM alone, C = A @ Bt^T: one row, a tile edge, ragged M, R
    and Nout, more than four k-tiles per ring, and a persistent walk of
    four tiles a block."""
    m, r, nout = case
    rng = np.random.RandomState(13)
    a = torch.from_numpy(rng.randn(m, r).astype(np.float32)).to(cuda, torch.bfloat16)
    bt = torch.from_numpy((rng.randn(nout, r) / np.sqrt(r)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    got = mm.launch_gemm_tn(a, bt)
    torch.cuda.synchronize()
    _check(got, mm.gemm_tn_plain(a, bt), torch.bfloat16)
    assert torch.equal(got, mm.launch_gemm_tn(a, bt))


@pytest.mark.parametrize("case", [(300, 70, 64, "bfloat16"),
                                  (300, 64, 36, "bfloat16"),
                                  (300, 64, 64, "float32")])
def test_dense_route_off_the_gemm_takes_the_1x1_kernels(cuda, case):
    """A width that is not a multiple of 8, or f32, runs K1 and K2 at the
    1x1 geometry: no select launch, and y and dx match too."""
    m, kd, nd, dname = case
    dtype = getattr(torch, dname)
    x, w, own, pm, g = _dense_case(m, kd, nd, cuda, dtype, seed=14)
    assert not mm.gemm_route(x, w, own, pm)
    before = (mm.LAUNCHES, mm.LAUNCHES_BWD_DX, mm.LAUNCHES_SELECT)
    y = mm.masked_matmul(x, w, own, pm, 2)
    dx = mm.masked_matmul_bwd_dx(g, x, w, own, pm, 2)
    torch.cuda.synchronize()
    assert (mm.LAUNCHES, mm.LAUNCHES_BWD_DX, mm.LAUNCHES_SELECT) == (
        before[0] + 1, before[1] + 1, before[2])
    _check(y, mm.masked_matmul_plain(x, w, own, pm, 2), dtype)
    _check(dx, mm.masked_matmul_bwd_dx_plain(g, x, w, own, pm, 2), dtype)


def test_dense_kernels_refuse_unsupported(cuda):
    a = torch.zeros((16, 12), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        mm.launch_gemm_tn(a, torch.zeros((8, 12), device=cuda,
                                         dtype=torch.bfloat16))
    w = torch.zeros((12, 8), device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        mm.launch_select(w, w.to(torch.int8), w, 2, 5e-3, "binary", True)


@pytest.mark.parametrize("flash_dtype,hd", [("float32", 32),
                                             ("bfloat16", 64)])
def test_autograd_reaches_q_k_v_w_and_pm_through_dense_and_flash(
        cuda, flash_dtype, hd):
    """loss.backward() through masked_matmul and flash_mha on the card
    gives x, w, pm (and through them q, k, v) their gradients, equal to the
    plain path's on the CPU; dx is skipped when x needs no gradient. In f32
    at hd 32 flash's backward is the dQ + dK/dV pair (rtol/atol 1e-4); with
    q, k, v cast to bf16 at hd 64 it is the one-launch kernel on
    `bwd_route` (max|diff| <= 2e-2 * max|ref|: the two sides round p and ds
    to bf16 in different tiles)."""
    rng = np.random.RandomState(8)
    n, t, h = 2, 70, 2
    fdt = getattr(torch, flash_dtype)
    x0 = rng.randn(n * t, 48).astype(np.float32)
    ws = [(rng.randn(48, h * hd) * 0.2).astype(np.float32) for _ in range(3)]
    own = rng.choice([0, 1, 2], size=(48, h * hd)).astype(np.int8)
    pms = [(rng.randn(48, h * hd) * 0.01 + 0.005).astype(np.float32)
           for _ in range(3)]
    gout = rng.randn(n, t, h, hd).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in (x0, *ws, *pms)]
        town = torch.from_numpy(own).to(dev)
        q, k, v = (mm.masked_matmul(leaves[0], leaves[1 + i], town,
                                    leaves[4 + i], 2).reshape(n, t, h, hd)
                   .to(fdt) for i in range(3))
        out = fl.flash_mha(q, k, v, causal=True)
        assert fl.bwd_route(q) == (fdt == torch.bfloat16)
        before = (fl.LAUNCHES_BWD_DKV, fl.LAUNCHES_BWD, mm.LAUNCHES_BWD_DX)
        (out.float() * torch.from_numpy(gout).to(dev)).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            route = int(fdt == torch.bfloat16)
            assert fl.LAUNCHES_BWD_DKV == before[0] + 1 - route
            assert fl.LAUNCHES_BWD == before[1] + route
            assert mm.LAUNCHES_BWD_DX == before[2] + 3
        grads[str(dev)] = [a.grad.detach().cpu() for a in leaves]
    for i, (got, want) in enumerate(zip(grads["cuda"], grads["cpu"])):
        assert got.abs().max() > 0, i
        if fdt == torch.float32:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=str(i))
        else:
            err = (got - want).abs().max().item()
            assert err <= 2e-2 * want.abs().max().item(), (i, err)
    x = torch.tensor(x0, device=cuda)  # no gradient wanted: K2 is skipped
    w = torch.tensor(ws[0], device=cuda, requires_grad=True)
    before = mm.LAUNCHES_BWD_DX
    mm.masked_matmul(x, w, torch.from_numpy(own).to(cuda),
                     torch.tensor(pms[0], device=cuda), 2).sum().backward()
    torch.cuda.synchronize()
    assert mm.LAUNCHES_BWD_DX == before and x.grad is None


# --------------------------------------------------- wgrad GEMM (K3) ----

def _ints(shape, device, seed, lo=-3, hi=4):
    """Small integers as bf16: every product and sum is exact in f32."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(lo, hi, shape, generator=g).to(device, torch.bfloat16)


@pytest.mark.parametrize("bn", [64, 128])
def test_wgrad_one_tile_of_small_integers_is_exact(cuda, bn):
    """One 128 x bn output tile over 64 pixels of small integers, exact in
    f32: the MN-major descriptors (leading offset between 64-wide atoms
    along M or N, stride offset between 8-pixel atoms, a k16 step of
    2,048 B) must give x^T g to the bit, gated."""
    x, g = _ints((64, 128), cuda, 1), _ints((64, bn), cuda, 2)
    w = torch.randn((128, bn), generator=torch.Generator().manual_seed(3)).to(cuda)
    own = torch.randint(0, 4, (128, bn), generator=torch.Generator().manual_seed(4),
                        dtype=torch.int8).to(cuda)
    dw, dpm = mm.launch_wgrad(x, g, w, own, 2, (bn, 1, 4, 1))
    torch.cuda.synchronize()
    want = mm.masked_matmul_bwd_dw_plain(g, x, w, own, 2)
    assert torch.equal(dw, want[0]) and torch.equal(dpm, want[1])


def test_wgrad_conv_one_box_of_small_integers_is_exact(cuda):
    """The conv walk on one 128-pixel box (two 8x8 images, Cin = Cout =
    64, a k tile spanning two taps) with small integers: exact."""
    x = _ints((2, 8, 8, 64), cuda, 5)
    g = _ints((2, 8, 8, 64), cuda, 6)
    w = torch.randn((3, 3, 64, 64), generator=torch.Generator().manual_seed(7)).to(cuda)
    own = torch.randint(0, 4, w.shape, generator=torch.Generator().manual_seed(8),
                        dtype=torch.int8).to(cuda)
    dw, dpm = mm.launch_wgrad_conv(g, x, w, own, 2, 1, 1)
    torch.cuda.synchronize()
    # the reference by exact products (cuDNN's f32 weight gradient may take
    # an inexact algorithm): the patches' x^T g
    patches = mm.im2col_plain(x.float(), 3, 3, 1, (1, 1, 1, 1), 576)
    want = mm.masked_matmul_bwd_dw_plain(g.reshape(-1, 64), patches,
                                         w.reshape(576, 64),
                                         own.reshape(576, 64), 2)
    assert torch.equal(dw, want[0].reshape(w.shape))
    assert torch.equal(dpm, want[1].reshape(w.shape))


@pytest.mark.parametrize("case", [
    # (m, k, n, plan or None): ragged M, K and N; one split and several (the
    # gate pass), several rounds of items a block, BN 64 and 128
    (1000, 200, 72, None), (333, 40, 8, None), (129, 8, 264, None),
    (4096, 256, 256, None), (2 * 196, 768, 768, None),
    (1000, 200, 72, (64, 5, 6, 3)), (1000, 200, 72, (64, 1, 6, 1)),
    (777, 136, 264, (128, 3, 6, 2)), (777, 136, 264, (64, 4, 6, 132)),
])
def test_wgrad_dense_matches_plain(cuda, case):
    m, kd, nd, plan = case
    x, w, own, _, g = _dense_case(m, kd, nd, cuda, torch.bfloat16, seed=21)
    dw, dpm = mm.launch_wgrad(x, g, w, own, 2, plan)
    torch.cuda.synchronize()
    want = mm.masked_matmul_bwd_dw_plain(g, x, w, own, 2)
    _check_sum(dw, want[0])
    _check_sum(dpm, want[1])
    again = mm.launch_wgrad(x, g, w, own, 2, plan)
    assert torch.equal(dw, again[0]) and torch.equal(dpm, again[1])


def test_wgrad_bits_do_not_depend_on_the_grid(cuda):
    """One (BN, split) plan under grids of 1, 7 and 132 blocks: equal bits
    (each tile's partials summed in split order by the gate pass, whichever
    block wrote them when)."""
    x, w, own, _, g = _dense_case(3000, 256, 192, cuda, torch.bfloat16, seed=22)
    outs = [mm.launch_wgrad(x, g, w, own, 2, (64, 9, 6, grid))
            for grid in (1, 7, 132)]
    torch.cuda.synchronize()
    for dw, dpm in outs[1:]:
        assert torch.equal(dw, outs[0][0]) and torch.equal(dpm, outs[0][1])


@pytest.mark.parametrize("n", [256, 3])
@pytest.mark.parametrize("layer", CONV_ROUTE_LAYERS,
                         ids=[c[0] for c in CONV_ROUTE_LAYERS])
def test_wgrad_conv_route_matches_plain(cuda, layer, n):
    """conv2/4/7/10 in bf16: K3 on the per-tap wgrad GEMM (no im2col, the
    op counted once), within 1e-4 * max|ref| of the plain version, two
    launches equal bits."""
    _, hw, cin, cout = layer
    x, wt, own, _ = _conv_case(n, hw, hw, cin, cout, 3, cuda, torch.bfloat16,
                               seed=hw + 2)
    g = torch.from_numpy(np.random.RandomState(hw + 3).randn(
        n, hw, hw, cout).astype(np.float32)).to(cuda, torch.bfloat16)
    before = (mc.LAUNCHES_BWD_DW, mc.LAUNCHES_IM2COL)
    dw, dpm = mc.masked_conv2d_bwd_dw(g, x, wt, own, 2)
    torch.cuda.synchronize()
    assert (mc.LAUNCHES_BWD_DW, mc.LAUNCHES_IM2COL) == (before[0] + 1, before[1])
    want = mc.masked_conv2d_bwd_dw_plain(g, x, wt, own, 2)
    _check_sum(dw, want[0])
    _check_sum(dpm, want[1])
    again = mc.masked_conv2d_bwd_dw(g, x, wt, own, 2)
    assert torch.equal(dw, again[0]) and torch.equal(dpm, again[1])


@pytest.mark.parametrize("case", [
    # (n, h = w, cin, cout, k, stride): VGG16-BN's conv0 at batch 256, a
    # stride-2 ragged conv (K = 45), a 1x1 (K = 64)
    (256, 32, 3, 64, 3, 1), (2, 7, 5, 72, 3, 2), (3, 9, 64, 24, 1, 1),
])
def test_wgrad_im2col_route_matches_plain(cuda, case):
    """kh*kw*Cin <= 64: the im2col kernel (bit-equal to its plain version,
    one launch) and the dense wgrad GEMM over the patches."""
    n, hw, cin, cout, k, s = case
    x, wt, own, _ = _conv_case(n, hw, hw, cin, cout, k, cuda, torch.bfloat16,
                               seed=9)
    ho = -(-hw // s)
    g = torch.from_numpy(np.random.RandomState(10).randn(
        n, ho, ho, cout).astype(np.float32)).to(cuda, torch.bfloat16)
    assert mc.im2col_route(x, wt) and not mc.conv_route(x, wt, s, "SAME")
    pads = mc.resolve_padding("SAME", hw, hw, k, k, s)
    kp = -(-k * k * cin // 8) * 8
    got = mm.launch_im2col(x, k, k, s, pads, kp)
    assert torch.equal(got.view(torch.int16),
                       mm.im2col_plain(x, k, k, s, pads, kp).view(torch.int16))
    before = (mc.LAUNCHES_BWD_DW, mc.LAUNCHES_IM2COL)
    dw, dpm = mc.masked_conv2d_bwd_dw(g, x, wt, own, 2, s)
    torch.cuda.synchronize()
    assert (mc.LAUNCHES_BWD_DW, mc.LAUNCHES_IM2COL) == (before[0] + 1,
                                                        before[1] + 1)
    want = mc.masked_conv2d_bwd_dw_plain(g, x, wt, own, 2, s)
    _check_sum(dw, want[0])
    _check_sum(dpm, want[1])
    again = mc.masked_conv2d_bwd_dw(g, x, wt, own, 2, s)
    assert torch.equal(dw, again[0]) and torch.equal(dpm, again[1])


@pytest.mark.parametrize("case", [
    # (n, H, W, k, stride, padding, Cin, Cout): one 128-pixel step or less
    # (M = 84, 60, 96), k tiles spanning two taps and one past K
    (2, 7, 6, 3, 1, "SAME", 64, 64), (3, 9, 8, 3, 2, "SAME", 128, 128),
    (8, 7, 5, 1, 2, "SAME", 64, 64),
], ids=["3x3s1_7x6", "3x3s2_9x8", "1x1s2_7x5"])
def test_wgrad_im2col_tile_of_small_integers_is_exact(cuda, case):
    """The im2col walk over one step of small integers, exact in f32: each
    half's TMA im2col load (the map's corner, the stride, the tap's
    offsets, the zero fill past the grid and the last image) read MN-major
    must give the patches' x^T g to the bit, gated."""
    n, h, w, k, s, pad, cin, cout = case
    x = _ints((n, h, w, cin), cuda, 11)
    wt = torch.randn((k, k, cin, cout),
                     generator=torch.Generator().manual_seed(12)).to(cuda)
    own = torch.randint(0, 4, wt.shape, generator=torch.Generator().manual_seed(13),
                        dtype=torch.int8).to(cuda)
    pads = mc.resolve_padding(pad, h, w, k, k, s)
    ho, wo = mc.out_size(h, k, s, *pads[:2]), mc.out_size(w, k, s, *pads[2:])
    g = _ints((n, ho, wo, cout), cuda, 14)
    assert mc.wgrad_conv_route(x, wt, s, pad) == "im2col"
    dw, dpm = mm.launch_wgrad_im2col(g, x, wt, own, 2, s, pads, (64, 1, 4, 1))
    torch.cuda.synchronize()
    kk = k * k * cin
    patches = mm.im2col_plain(x.float(), k, k, s, pads, kk)
    want = mm.masked_matmul_bwd_dw_plain(g.reshape(-1, cout), patches,
                                         wt.reshape(kk, cout),
                                         own.reshape(kk, cout), 2)
    assert torch.equal(dw, want[0].reshape(wt.shape))
    assert torch.equal(dpm, want[1].reshape(wt.shape))


@pytest.mark.parametrize("case", [
    # (n, H, W, k, stride, padding, Cin, Cout, route, im2col launches)
    (4, 7, 6, 3, 1, "SAME", 512, 512, "im2col", 0),   # SphereNet's unit4
    (2, 56, 48, 3, 1, "SAME", 64, 64, "im2col", 0),   # unit1's grid
    (8, 28, 24, 3, 2, 1, 64, 128, "im2col", 0),       # a down, pad 1
    (3, 13, 11, 3, 2, "SAME", 128, 192, "im2col", 0),  # odd sides
    (4, 14, 14, 1, 2, "SAME", 256, 512, "im2col", 0),  # 1x1/2
    (4, 14, 14, 1, 1, "SAME", 128, 64, "dense", 0),   # x as a matrix
    (2, 56, 56, 1, 1, "SAME", 64, 64, "dense", 0),    # was on the patches
    (4, 64, 64, 7, 2, ((3, 3), (3, 3)), 3, 64, "patches", 1),  # 152 columns
    (4, 28, 24, 3, 2, 1, 3, 64, "patches", 1),        # SphereNet's stem
], ids=["unit4", "unit1_grid", "down_s2", "3x3s2_odd", "1x1s2", "1x1_dense",
        "1x1_dense_64", "stem_7x7s2", "stem_3x3s2"])
def test_wgrad_routes_off_the_boxes_match_the_f64_sum(cuda, case):
    """K3 at the ResNet-50 and SphereNet-20 geometries on `wgrad_conv_route`
    (one K3 launch; an im2col launch on the patches only): within 1e-4 *
    max|ref| of the plain version summed in f64, two launches equal
    bits."""
    n, h, w, k, s, pad, cin, cout, route, im2cols = case
    x, wt, own, _ = _conv_case(n, h, w, cin, cout, k, cuda, torch.bfloat16,
                               seed=h + cin)
    pads = mc.resolve_padding(pad, h, w, k, k, s)
    ho, wo = mc.out_size(h, k, s, *pads[:2]), mc.out_size(w, k, s, *pads[2:])
    g = torch.from_numpy(np.random.RandomState(w).randn(
        n, ho, wo, cout).astype(np.float32)).to(cuda, torch.bfloat16)
    assert mc.wgrad_conv_route(x, wt, s, pad) == route
    before = (mc.LAUNCHES_BWD_DW, mc.LAUNCHES_IM2COL)
    dw, dpm = mc.masked_conv2d_bwd_dw(g, x, wt, own, 2, s, pad)
    torch.cuda.synchronize()
    assert (mc.LAUNCHES_BWD_DW, mc.LAUNCHES_IM2COL) == (before[0] + 1,
                                                        before[1] + im2cols)
    want = mc.masked_conv2d_bwd_dw_plain(g, x, wt, own, 2, s, pad,
                                         acc_dtype=torch.float64)
    _check_sum(dw, want[0])
    _check_sum(dpm, want[1])
    again = mc.masked_conv2d_bwd_dw(g, x, wt, own, 2, s, pad)
    assert torch.equal(dw, again[0]) and torch.equal(dpm, again[1])


def test_wgrad_im2col_bits_do_not_depend_on_the_grid(cuda):
    """One (BN, split) plan of the im2col walk under grids of 1, 7 and 132
    blocks: equal bits."""
    x, wt, own, _ = _conv_case(6, 14, 12, 128, 128, 3, cuda, torch.bfloat16,
                               seed=15)
    g = torch.from_numpy(np.random.RandomState(16).randn(
        6, 7, 6, 128).astype(np.float32)).to(cuda, torch.bfloat16)
    outs = [mm.launch_wgrad_im2col(g, x, wt, own, 2, 2, (1, 1, 1, 1),
                                   (64, 2, 4, grid)) for grid in (1, 7, 132)]
    torch.cuda.synchronize()
    for dw, dpm in outs[1:]:
        assert torch.equal(dw, outs[0][0]) and torch.equal(dpm, outs[0][1])


def test_wgrad_refuses_a_misaligned_operand(cuda):
    """On the route a g off a 16-byte boundary raises; nothing falls back
    to the old K3."""
    x, w, own, _, _ = _dense_case(256, 64, 64, cuda, torch.bfloat16, seed=23)
    g = torch.zeros(256 * 64 + 4, device=cuda, dtype=torch.bfloat16)[4:].view(256, 64)
    with pytest.raises(ValueError, match="16-byte"):
        mm.launch_wgrad(x, g, w, own, 2)
    x4, wt, own4, _ = _conv_case(2, 8, 8, 64, 64, 3, cuda, torch.bfloat16)
    g4 = torch.zeros(2 * 8 * 8 * 64 + 4, device=cuda,
                     dtype=torch.bfloat16)[4:].view(2, 8, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        mc.masked_conv2d_bwd_dw(g4, x4, wt, own4, 2)


# ------------------------------------------------------- int8 route ----

@pytest.mark.parametrize("m,k,n", [(1, 27, 5), (8, 64, 64), (17, 40, 24),
                                   (300, 576, 64), (1024, 4608, 512)])
def test_int8_route_matches_the_exact_product(cuda, m, k, n):
    """`torch._int_mm` through the wrapper's padding (M to >= 32, K and N
    to multiples of 8) equals the exact product bit for bit, and counts
    one launch."""
    from cpg_tpu_torch.ops import int8

    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=cuda,
                      generator=g)
    b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=cuda,
                      generator=g)
    before = int8.LAUNCHES
    got = int8.int_mm(a, b)
    assert int8.LAUNCHES == before + 1
    assert torch.equal(got, int8.int_mm_plain(a, b))


@pytest.mark.parametrize("hw,cin,cout,k,stride,pads", [
    (32, 3, 64, 3, 1, (1, 1, 1, 1)), (16, 64, 128, 3, 1, (1, 1, 1, 1)),
    (9, 12, 16, 3, 2, (0, 1, 0, 1)), (32, 3, 256, 4, 4, (0, 0, 0, 0))])
def test_int8_conv_matches_the_exact_product(cuda, hw, cin, cout, k, stride,
                                             pads):
    from cpg_tpu_torch.ops import int8

    g = torch.Generator(device=cuda).manual_seed(hw + cin)
    x = torch.randint(-127, 128, (4, hw, hw, cin), dtype=torch.int8,
                      device=cuda, generator=g)
    w = torch.randint(-127, 128, (k, k, cin, cout), dtype=torch.int8,
                      device=cuda, generator=g)
    got = int8.conv2d_int8(x, w, stride, pads)
    p = int8.patches(x, k, k, stride, pads)
    want = int8.int_mm_plain(p, w.reshape(-1, cout)).reshape(got.shape)
    assert torch.equal(got, want)


def test_fused_chain_launches_from_many_threads(cuda):
    """Serving threads launch K4 at several seam sizes at once (each size
    its own shared memory): no launch fails, each answer is its plain
    version's."""
    import concurrent.futures

    cases = [_conv_case(n, hw, hw, c, c, 3, cuda, torch.bfloat16, seed=i)
             for i, (n, hw, c) in enumerate([(8, 32, 64), (8, 16, 128),
                                             (8, 8, 256), (8, 4, 512),
                                             (8, 2, 512), (256, 2, 512)])]
    args = [(x, torch.rand(x.shape[-1], device=cuda) + 0.5,
             torch.rand(x.shape[-1], device=cuda) - 0.5, w.to(torch.bfloat16))
            for x, w, _, _ in cases]
    want = [fc.fused_oracle(*a, dot_dtype=torch.bfloat16) for a in args]

    def one(i):
        a = args[i % len(args)]
        y = fc.fused_affine_relu_conv(*a, torch.bfloat16)
        torch.cuda.current_stream().synchronize()
        return i % len(args), y

    with concurrent.futures.ThreadPoolExecutor(16) as ex:
        for i, y in ex.map(one, range(192)):
            _check(y, want[i], torch.bfloat16)
