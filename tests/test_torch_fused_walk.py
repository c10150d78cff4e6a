"""K4 and K5 on their TMA + wgmma routes, replayed in plain PyTorch on the
CPU.

On the card a bf16 seam on `fused_chain.fwd_route` and `dx_route` runs two
TMA + wgmma implicit GEMMs (csrc/fused_chain_fwd.cu,
csrc/fused_chain_bwd_dx.cu over csrc/tma_gemm.cuh). `_replay_fwd` walks
`masked_matmul.fused_fwd_plan`'s persistent grid as K4 does, on both
routes: for each tile of 128 consecutive output pixels and 64-channel
block, the halo of raw x that `fused_fwd_halo` gives, gathered with TMA's
zero fill (one box of (64, W + 2, rows + 2, images) at (c0, -1, row0 - 1,
image), and on a tile that runs into the next image a second box of its
first rows at `split`); the activation relu(a*x + b) (product and sum
rounded apart, then bf16) of the pixels the tile's taps read, with 0
written at every halo position outside its image, all other pixels NaN (a
stored row that reads one poisons y); then the nine taps, each a gather of
the tile's pixel rows shifted by (dh, dw) inside the halo from each row's
centre pixel, times the tap's 64 x BN weight box. `_replay_dx` walks
`masked_matmul.fused_dx_plan` (the "gemm" route: the CONV_DGRAD boxes of g,
mirrored per tap, zero-filled) or `fused_dx_im2col_plan` (the "im2col"
route: each k-step one TMA im2col load of g at the stride-1 dgrad phase's
mirrored tap, emulated by `tests/test_torch_conv_routes.py`'s
`_im2col_tile`) times the HWIO weight's (tap, Cin tile, Cout block) box,
then the epilogue: x's tile, the mask pre = a*x + b > 0, dx = dm * a, and
the tile's column partials of dm * x and dm, which are summed in tile
order.

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
from tests.test_torch_conv_routes import _im2col_tile

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


def _centre(h, w, rows, split, img0, row0, m):
    """The halo pixels of output pixels m (a tensor) at the centre tap, as
    K4's `centre_pixel`: in the first load's box of their image, or in the
    second box at `split`."""
    pw, hw = w + 2, h * w
    rem = m % hw
    i, j, b = rem // w, rem % w, m // hw - img0
    return torch.where((b > 0) & (split > 0), split + (i + 1) * pw,
                       (b * (rows + 2) + i - row0 + 1) * pw) + j + 1


def _halo_tile(n, h, w, rows, split, m0):
    """(image, first row, second box, lo, hi) of the tile at m0, as K4's
    `halo_tile`: the first row only where the box holds some rows of one
    image; the second box where that tile runs into the next image; the
    pixels lo .. hi - 1 its taps read, from its first pixel's up-left
    neighbour to its last pixel's down-right one."""
    hw, pw = h * w, w + 2
    img = m0 // hw
    last = min(m0 + BM, n * hw) - 1
    two = split > 0 and last // hw != img
    row0 = 0 if rows == h else (m0 - img * hw) // w
    ends = _centre(h, w, rows, split, img, row0, torch.tensor([m0, last]))
    return img, row0, two, int(ends[0]) - pw - 1, int(ends[1]) + pw + 2


def _replay_fwd(x, a, b, w, sms, pad_relu_b=False):
    """K4's walk: y (N, H, W, Cout) in f32, and how often each (output
    pixel, channel tile) was stored. With pad_relu_b, halo positions
    outside their image hold relu(b) instead of 0 (the fault the kernel
    avoids)."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    box, split = mm.fused_fwd_halo(h, wd)
    plan_box, bn, _, grid, halo = mm.fused_fwd_plan(n, h, wd, cin, cout, sms)
    assert plan_box == box
    _, bw, rows, imgs = box
    pw, ph = bw + 2, rows + 2
    npx = mm.fused_halo_px(box, split)
    assert halo % 1024 == 0 and halo >= npx * 128
    px = torch.arange(npx)
    w2 = w.reshape(9 * cin, cout)
    hw, m = h * wd, n * h * wd
    out = torch.full((m, cout), float("nan"))
    stored = torch.zeros((m, -(-cout // bn)), dtype=torch.int64)
    for m0, n0, _, _ in _tiles(n, h, wd, cout, bn, grid):
        img, row0, two, lo, hi = _halo_tile(n, h, wd, rows, split, m0)
        # box pixel -> (column, row in its image, image): activation_chunk
        second = (px >= split) if two else torch.zeros(npx, dtype=torch.bool)
        pl = torch.where(second, px - split, px)
        col, q = pl % pw, pl // pw
        i = q // ph
        ih = torch.where(second, 0, row0) - 1 + q - i * ph
        inside = ((col >= 1) & (col <= wd) & (ih >= 0) & (ih < h)
                  & (i < imgs) & (img + i + second.long() < n))
        # each tile row's halo pixel at the centre tap: centre_pixel
        mr = m0 + torch.arange(BM)
        p0 = torch.where(mr < m, _centre(h, wd, rows, split, img, row0, mr),
                         pw + 1)
        acc = torch.zeros((BM, bn))
        for cb in range(cin // BK):
            c0 = cb * BK
            raw = torch.full((npx, BK), float("nan"))
            raw[:pw * ph * imgs] = _box(x, (c0, -1, row0 - 1, img),
                                        (BK, pw, ph, imgs))
            if two:
                raw[split:split + pw * ph] = _box(x, (c0, -1, -1, img + 1),
                                                  (BK, pw, ph, 1))
            pre = raw * a[c0:c0 + BK] + b[c0:c0 + BK]
            pad = torch.relu(b[c0:c0 + BK]) if pad_relu_b else 0.0
            act = torch.where(inside[:, None],
                              torch.relu(pre).bfloat16().float(), pad)
            # only the pixels the taps read are activated; the rest hold
            # what an earlier step left there (NaN: no stored row reads it)
            act[:lo] = float("nan")
            act[hi:] = float("nan")
            for tap in range(9):
                dh, dw = tap // 3 - 1, tap % 3 - 1
                tile_a = act[p0 + dh * pw + dw]
                tile_b = _rows(w2[tap * cin + c0:tap * cin + c0 + BK].t(),
                               n0, bn).t()
                acc += tile_a @ tile_b
        rows_, cols = min(BM, m - m0), min(bn, cout - n0)
        out[m0:m0 + rows_, n0:n0 + cols] = acc[:rows_, :cols]
        stored[m0:m0 + rows_, n0 // bn] += 1
    return out.reshape(n, h, wd, cout), stored


def _replay_dx(x, a, b, w, g, sms, route="gemm"):
    """K5's walk on `route`: (dx, da, db) in f32, and how often each (x
    tile, channel tile) was loaded."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if route == "gemm":
        box, bn, _, grid = mm.fused_dx_plan(n, h, wd, cin, cout, sms)
    else:
        phases, bn, _, grid = mm.fused_dx_im2col_plan(n, h, wd, cin, cout,
                                                       sms)
        # the stride-1 dgrad's one phase over the whole grid, stored as y
        ((rows, cols, lw, lh, row0, col0, taps),) = phases
        assert (rows, cols, row0, col0, len(taps)) == (h, wd, 0, 0, 9)
        upper = (lw + cols - 1 - (wd - 1), lh + rows - 1 - (h - 1))
    w3 = w.reshape(9, cin, cout)
    m = n * h * wd
    tiles_m = -(-m // BM)
    x2 = x.reshape(m, cin)
    dx = torch.full((m, cin), float("nan"))
    parts = torch.full((2, tiles_m, cin), float("nan"))
    loaded = torch.zeros((tiles_m, -(-cin // bn)), dtype=torch.int64)
    for m0, n0, img, oh0 in _tiles(n, h, wd, cin, bn, grid):
        acc = torch.zeros((BM, bn))
        for kt in range(9 * cout // BK):
            j, c0 = divmod(kt, cout // BK)
            c0 *= BK
            if route == "gemm":
                dh, dw = j // 3 - 1, j % 3 - 1
                tile_a = _box(g, (c0, -dw, oh0 - dh, img), box)
                tap = j
            else:
                tap, o_w, o_h = taps[j]
                tile_a = _im2col_tile(g, c0, (lw + (m0 - img * h * wd) % wd,
                                              lh + oh0), img, (lw, lh),
                                      upper, 1, (o_w, o_h))
            tile_b = _rows(w3[tap, :, c0:c0 + BK], n0, bn)
            acc += tile_a @ tile_b.t()
        xt = _rows(x2[:, n0:n0 + bn], m0, BM)
        loaded[m0 // BM, n0 // bn] += 1
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
    return (dx.reshape(n, h, wd, cin), da, db), loaded


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
    for route in (fc.fwd_route, fc.dx_route):
        assert route(tx.bfloat16(), tw.bfloat16(), torch.bfloat16) == "gemm"
    assert ((tx * ta + tb) == 0).any() and (tb > 0).any()
    y, _ = _replay_fwd(tx, ta, tb, tw, 132)
    (dx, da, db), _ = _replay_dx(tx, ta, tb, tw, tg, 132)
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
    y, _ = _replay_fwd(tx, ta, tb, tw, sms)
    (dx, da, db), _ = _replay_dx(tx, ta, tb, tw, tg, sms)
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
    np.testing.assert_allclose(_replay_fwd(tx, ta, tb, tw, 132)[0].numpy(),
                               want.numpy(), rtol=TOL, atol=TOL)


# (N, H = W, Cin = Cout) on the "im2col" routes: 7x7 (whole images, 4 a
# box, tiles starting mid-image), 14x14 (10 rows of one image from the
# tile's first row, a second box where a tile runs into the next image),
# 12x12 (whole images, 2 a box) and 28x28 at N = 2 (6 rows, split 240)
IM2COL_CASES = [(3, 7, 64), (2, 14, 128), (2, 12, 64), (2, 28, 64)]


def _ids(cases):
    return [f"{hw}x{hw}x{c}" for _, hw, c in cases]


@pytest.mark.parametrize("case", IM2COL_CASES, ids=_ids(IM2COL_CASES))
def test_im2col_walks_are_the_fused_chain_and_its_dx(case):
    """K4's halo tiles and K5's im2col walk at grids whose 128-pixel tiles
    start mid-row and cross images: every output pixel stored once, every
    x tile loaded once, no lane reading a pixel its tile did not land, and
    y, dx, da, db equal to the plain versions and `cpg_tpu`'s fused chain
    and its VJP."""
    n, hw, c = case
    x, a, b, w, g = _case(n, hw, c, c, seed=hw + c)
    tx, ta, tb, tw, tg = (torch.from_numpy(v) for v in (x, a, b, w, g))
    for route in (fc.fwd_route, fc.dx_route):
        assert route(tx.bfloat16(), tw.bfloat16(), torch.bfloat16) == "im2col"
    y, stored = _replay_fwd(tx, ta, tb, tw, 132)
    (dx, da, db), loaded = _replay_dx(tx, ta, tb, tw, tg, 132, "im2col")
    assert (stored == 1).all() and (loaded == 1).all()
    y_jax, dx_jax, da_jax, db_jax = _jax_fused(x, a, b, w, g)
    plain = (fc.fused_oracle(tx, ta, tb, tw, torch.float32),
             *fc.fused_bwd_dx_plain(tx, ta, tb, tw, tg, torch.float32))
    for got, ref, jref in zip((y, dx, da, db), plain,
                              (y_jax, dx_jax, da_jax, db_jax)):
        for want in (ref.numpy(), jref):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", [(1, 14, 128, 64, 7), (3, 7, 64, 128, 7)])
def test_im2col_walks_at_more_channels_match_the_plain_versions(case):
    """Two channel blocks a tile, two output-channel tiles, and 7 SMs
    walking several tiles a block, each block's halo buffers reused."""
    n, hw, cin, cout, sms = case
    x, a, b, w, g = _case(n, hw, cin, cout, seed=n + hw + cin)
    tx, ta, tb, tw, tg = (torch.from_numpy(v) for v in (x, a, b, w, g))
    y, _ = _replay_fwd(tx, ta, tb, tw, sms)
    (dx, da, db), _ = _replay_dx(tx, ta, tb, tw, tg, sms, "im2col")
    want = (fc.fused_oracle(tx, ta, tb, tw, torch.float32),
            *fc.fused_bwd_dx_plain(tx, ta, tb, tw, tg, torch.float32))
    for got, ref in zip((y, dx, da, db), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL,
                                   atol=TOL)


def test_im2col_walk_at_56x56_lands_the_second_box_past_a_gap():
    """ResNet-50's layer-1 grid: 348 pixels a box, the second box at 352
    (the first rounded up to 8), so a lane of the next image that read the
    first box's layout would read the NaN gap or the wrong pixel. One tile
    of the two images crosses from the first into the second."""
    assert mm.fused_fwd_halo(56, 56) == ((64, 56, 4, 1), 352)
    x, a, b, w, g = _case(2, 56, 64, 64, seed=56)
    tx, ta, tb, tw, tg = (torch.from_numpy(v) for v in (x, a, b, w, g))
    y, stored = _replay_fwd(tx, ta, tb, tw, 132)
    (dx, da, db), loaded = _replay_dx(tx, ta, tb, tw, tg, 132, "im2col")
    assert (stored == 1).all() and (loaded == 1).all()
    want = (fc.fused_oracle(tx, ta, tb, tw, torch.float32),
            *fc.fused_bwd_dx_plain(tx, ta, tb, tw, tg, torch.float32))
    for got, ref in zip((y, dx, da, db), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("hw", [7, 14])
def test_im2col_route_padding_written_as_relu_b_would_fail(hw):
    """On the halo tiles of any tiling the zero written after the
    activation at every position outside its image (the halo columns, the
    rows above and below, images past N) is what keeps K4 right: the same
    walk with relu(b) there misses the plain version."""
    x, a, b, w, _ = _case(2, hw, 64, 64, seed=hw)
    tx, ta, tb, tw = (torch.from_numpy(v) for v in (x, a, b, w))
    want = fc.fused_oracle(tx, ta, tb, tw, torch.float32)
    wrong, _ = _replay_fwd(tx, ta, tb, tw, 132, pad_relu_b=True)
    assert not torch.allclose(wrong, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_replay_fwd(tx, ta, tb, tw, 132)[0].numpy(),
                               want.numpy(), rtol=TOL, atol=TOL)
