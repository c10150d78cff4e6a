"""K4 and K5 on the conv GEMM route, replayed in plain PyTorch on the CPU.

On the card a bf16 seam on `fused_chain.fwd_route` and `gemm_route` runs
two TMA + wgmma implicit GEMMs (csrc/fused_chain_fwd.cu,
csrc/fused_chain_bwd_dx.cu over csrc/tma_gemm.cuh). `_replay_fwd` walks
`masked_matmul.fused_fwd_plan`'s persistent grid as K4 does: for each
128-pixel output tile and 64-channel block, one halo box of raw x, (64, W
+ 2, rows + 2, images) at (c0, -1, oh0 - 1, n0), gathered with TMA's zero
fill; the activation relu(a*x + b) (product and sum rounded apart, then
bf16) with 0 written at every halo position outside its image; then the
nine taps, each a gather of the tile's pixel rows shifted by (dh, dw)
inside the halo, times the tap's 64 x BN weight box. `_replay_dx` walks
`masked_matmul.fused_dx_plan` as K5 does:
the CONV_DGRAD boxes of g (mirrored per tap, zero-filled) times the HWIO
weight's (tap, Cin tile, Cout block) box, then the epilogue: x's tile, the
mask pre = a*x + b > 0, dx = dm * a, and the tile's column partials of dm *
x and dm, which are summed in tile order.

Both must give the plain versions (`fused_oracle`, `fused_bwd_dx_plain`)
and `cpg_tpu`'s `fused_affine_relu_conv` and its custom VJP (Pallas in
interpret mode where the JAX kernel takes the shape; its XLA oracle at 2x2,
as `cpg_tpu` runs it). Inputs are chosen so that every value is exact in
bf16 and every product and sum exact in f32 (x and b multiples of 1/8, a in
{0.5, 1, 2}, w and g multiples of 1/16 and 1/8), so the f32 comparison at
rtol = atol = 1e-5 differs only in summation order. Some channels have b >
0, so a padding written as relu(b) would fail; some entries have a*x + b
exactly 0, which the mask's strict > 0 drops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.ops.pallas.fused_chain import \
    fused_affine_relu_conv as j_fused_affine_relu_conv
from cpg_tpu_torch.ops import fused_chain as fc
from cpg_tpu_torch.ops import masked_matmul as mm

TOL = 1e-5
BM, BK = mm.GEMM_BM, mm.GEMM_BK


def _box(a, coords, box):
    """TMA's tiled box of the NHWC tensor a at coordinates (c, w, h, n),
    innermost first: a (box pixels, box[0]) matrix with zeros wherever the
    box leaves a, below zero too."""
    out = torch.zeros(tuple(reversed(box)), dtype=a.dtype)  # (n, h, w, c)
    src, dst = [], []
    for lo, size, extent in zip(reversed(coords), reversed(box), a.shape):
        s0, s1 = max(lo, 0), min(lo + size, extent)
        if s1 <= s0:
            return out.reshape(-1, box[0])
        src.append(slice(s0, s1))
        dst.append(slice(s0 - lo, s1 - lo))
    out[tuple(dst)] = a[tuple(src)]
    return out.reshape(-1, box[0])


def _rows(t, r0, size):
    """Rows r0 .. r0 + size of t, zero past its end (a clipped TMA box)."""
    out = torch.zeros((size, t.shape[1]), dtype=t.dtype)
    part = t[r0:r0 + size]
    out[:part.shape[0]] = part
    return out


def _tiles(n, h, w, nout, bn, grid):
    """(m0, n0, image, first row) of each tile, as a persistent block walks
    them: block b takes tiles b, b + grid, ...; M fastest."""
    tiles_m = -(-n * h * w // BM)
    for b in range(grid):
        for t in range(b, tiles_m * -(-nout // bn), grid):
            m0, n0 = (t % tiles_m) * BM, (t // tiles_m) * bn
            img, rem = divmod(m0, h * w)
            yield m0, n0, img, rem // w


def _replay_fwd(x, a, b, w, sms):
    """K4's walk: y (N, H, W, Cout) in f32."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    (_, bw, rows, imgs), bn, _, grid, halo = mm.fused_fwd_plan(
        n, h, wd, cin, cout, sms)
    pw, ph = bw + 2, rows + 2
    assert halo >= pw * ph * imgs * 128
    # box pixel -> (column, row in its image, image) of the halo box
    px = torch.arange(pw * ph * imgs)
    col, q = px % pw, px // pw
    # the output tile's row r at the centre tap
    r = torch.arange(BM)
    rq, ri = r // bw, r // (bw * rows)
    p0 = (ri * ph + rq - ri * rows + 1) * pw + r % bw + 1
    w2 = w.reshape(9 * cin, cout)
    m = n * h * wd
    out = torch.full((m, cout), float("nan"))
    for m0, n0, img, oh0 in _tiles(n, h, wd, cout, bn, grid):
        ih = oh0 - 1 + q % ph
        inside = ((col >= 1) & (col <= wd) & (ih >= 0) & (ih < h)
                  & (img + q // ph < n))
        acc = torch.zeros((BM, bn))
        for cb in range(cin // BK):
            c0 = cb * BK
            raw = _box(x, (c0, -1, oh0 - 1, img), (BK, pw, ph, imgs))
            pre = raw * a[c0:c0 + BK] + b[c0:c0 + BK]
            act = torch.where(inside[:, None],
                              torch.relu(pre).bfloat16().float(), 0.0)
            for tap in range(9):
                dh, dw = tap // 3 - 1, tap % 3 - 1
                tile_a = act[p0 + dh * pw + dw]
                tile_b = _rows(w2[tap * cin + c0:tap * cin + c0 + BK].t(),
                               n0, bn).t()
                acc += tile_a @ tile_b
        rows_, cols = min(BM, m - m0), min(bn, cout - n0)
        out[m0:m0 + rows_, n0:n0 + cols] = acc[:rows_, :cols]
    return out.reshape(n, h, wd, cout)


def _replay_dx(x, a, b, w, g, sms):
    """K5's walk: (dx, da, db) in f32."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    box, bn, _, grid = mm.fused_dx_plan(n, h, wd, cin, cout, sms)
    w3 = w.reshape(9, cin, cout)
    m = n * h * wd
    tiles_m = -(-m // BM)
    x2 = x.reshape(m, cin)
    dx = torch.full((m, cin), float("nan"))
    parts = torch.full((2, tiles_m, cin), float("nan"))
    for m0, n0, img, oh0 in _tiles(n, h, wd, cin, bn, grid):
        acc = torch.zeros((BM, bn))
        for kt in range(9 * cout // BK):
            tap, c0 = divmod(kt, cout // BK)
            c0 *= BK
            dh, dw = tap // 3 - 1, tap % 3 - 1
            tile_a = _box(g, (c0, -dw, oh0 - dh, img), box)
            tile_b = _rows(w3[tap, :, c0:c0 + BK], n0, bn)
            acc += tile_a @ tile_b.t()
        xt = _rows(x2[:, n0:n0 + bn], m0, BM)
        cols = min(bn, cin - n0)
        at, bt = a[n0:n0 + cols], b[n0:n0 + cols]
        xt, acc = xt[:, :cols], acc[:, :cols]
        dm = torch.where(xt * at + bt > 0, acc, 0.0)
        rows_ = min(BM, m - m0)
        dx[m0:m0 + rows_, n0:n0 + cols] = (dm * at)[:rows_]
        parts[0, m0 // BM, n0:n0 + cols] = (dm * xt).sum(0)
        parts[1, m0 // BM, n0:n0 + cols] = dm.sum(0)
    da, db = torch.zeros(cin), torch.zeros(cin)
    for t in range(tiles_m):  # the tiles in order
        da += parts[0, t]
        db += parts[1, t]
    return dx.reshape(n, h, wd, cin), da, db


def _case(n, hw, cin, cout, seed):
    """Inputs exact in bf16 whose products and sums are exact in f32 (see
    the top): a in {0.5, 1, 2}, b multiples of 1/8 with b > 0 in some
    channels, x multiples of 1/8 with a*x + b == 0 at some entries."""
    rng = np.random.RandomState(seed)
    x = (rng.randint(-16, 17, (n, hw, hw, cin)) / 8).astype(np.float32)
    a = rng.choice([0.5, 1.0, 2.0], cin).astype(np.float32)
    b = (rng.randint(-4, 5, cin) / 8).astype(np.float32)
    b[:4] = [0.25, 0.5, 0.125, 0.375]       # relu(b) > 0 in the padding
    flat = x.reshape(-1, cin)
    flat[::5] = -b / a                      # a*x + b == 0 exactly
    w = (rng.randint(-8, 9, (3, 3, cin, cout)) / 16).astype(np.float32)
    g = (rng.randint(-8, 9, (n, hw, hw, cout)) / 8).astype(np.float32)
    return x, a, b, w, g


def _jax_fused(x, a, b, w, g):
    """cpg_tpu's fused chain in f32 and its custom VJP's (dx, da, db),
    under one jit."""
    @jax.jit
    def run(x, a, b, w, g):
        y, vjp = jax.vjp(lambda x_, a_, b_: j_fused_affine_relu_conv(
            x_, a_, b_, w, jnp.float32), x, a, b)
        return y, vjp(g)
    y, (dx, da, db) = run(*(jnp.asarray(v) for v in (x, a, b, w, g)))
    return [np.asarray(v) for v in (y, dx, da, db)]


# (N, H = W): rows of one image (16x16: 8 rows a box, 2 tiles an image),
# two images a box (8x8), and 8 and 32 images a box with N = 3, so that the
# box of images is partly zero-filled
CASES = [(2, 16), (3, 8), (3, 4), (3, 2)]


@pytest.mark.parametrize("case", CASES, ids=[f"{hw}x{hw}" for _, hw in CASES])
def test_fused_walks_are_the_fused_chain_and_its_dx(case):
    n, hw = case
    cin = cout = 64
    x, a, b, w, g = _case(n, hw, cin, cout, seed=hw)
    tx, ta, tb, tw, tg = (torch.from_numpy(v) for v in (x, a, b, w, g))
    for route in (fc.fwd_route, fc.gemm_route):
        assert route(tx.bfloat16(), tw.bfloat16(), torch.bfloat16)
    assert ((tx * ta + tb) == 0).any() and (tb > 0).any()
    y = _replay_fwd(tx, ta, tb, tw, 132)
    dx, da, db = _replay_dx(tx, ta, tb, tw, tg, 132)
    y_plain = fc.fused_oracle(tx, ta, tb, tw, torch.float32)
    dx_plain, da_plain, db_plain = fc.fused_bwd_dx_plain(tx, ta, tb, tw, tg,
                                                         torch.float32)
    y_jax, dx_jax, da_jax, db_jax = _jax_fused(x, a, b, w, g)
    pairs = [(y, y_plain.numpy()), (y, y_jax), (dx, dx_plain.numpy()),
             (dx, dx_jax), (da, da_plain.numpy()), (da, da_jax),
             (db, db_plain.numpy()), (db, db_jax)]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", [
    # (n, H = W, Cin, Cout, SMs): more than one channel block a tile, two
    # output-channel tiles, and 7 SMs walking several tiles a block
    (1, 16, 128, 64, 7), (3, 8, 64, 128, 7), (2, 4, 128, 128, 132),
])
def test_fused_walks_at_more_channels_match_the_plain_versions(case):
    n, hw, cin, cout, sms = case
    x, a, b, w, g = _case(n, hw, cin, cout, seed=n + hw)
    tx, ta, tb, tw, tg = (torch.from_numpy(v) for v in (x, a, b, w, g))
    y = _replay_fwd(tx, ta, tb, tw, sms)
    dx, da, db = _replay_dx(tx, ta, tb, tw, tg, sms)
    want = (fc.fused_oracle(tx, ta, tb, tw, torch.float32),
            *fc.fused_bwd_dx_plain(tx, ta, tb, tw, tg, torch.float32))
    for got, ref in zip((y, dx, da, db), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL,
                                   atol=TOL)


def test_padding_written_as_relu_b_would_fail():
    """The replay's zero at halo positions outside the image is what keeps
    it equal to the plain version: with relu(b) there instead, b > 0
    changes the border pixels."""
    x, a, b, w, _ = _case(1, 8, 64, 64, seed=5)
    tx, ta, tb, tw = (torch.from_numpy(v) for v in (x, a, b, w))
    xp = torch.nn.functional.pad(tx, (0, 0, 1, 1, 1, 1))  # raw zeros
    act = torch.relu(xp * ta + tb)                        # relu(b) there
    wrong = torch.nn.functional.conv2d(
        act.permute(0, 3, 1, 2), tw.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    want = fc.fused_oracle(tx, ta, tb, tw, torch.float32)
    assert not torch.allclose(wrong, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_replay_fwd(tx, ta, tb, tw, 132).numpy(),
                               want.numpy(), rtol=TOL, atol=TOL)
