"""The masked conv's GEMM route, replayed in plain PyTorch on the CPU.

On the card a conv on `masked_conv.conv_route` runs the select pass and then
`csrc/masked_matmul.cu`'s TMA + wgmma GEMM, whose producer loads, for
k-step kt = (tap, channel block), one 4-D TMA box of the NHWC activation
per 128-pixel output tile: x at (c, ow0 + dw - pad_left, oh0 + dh -
pad_top, n0) for the forward, g at the mirrored (c, iw0 + pad_left - dw,
ih0 + pad_top - dh, n0) for dx, with zeros wherever the box leaves the
tensor, and one box of the selected weight (w_eff^T's (kt * 64, n0) for the
forward; w_eff as (taps, Cin, Cout) at (tap, n0, c) for dx). `_replay`
walks `masked_matmul.conv_plan`'s persistent grid exactly so, with the
boxes gathered here, and multiplies them by the plain select's output.

It must give the plain versions (`masked_conv2d_plain`,
`masked_conv2d_bwd_dx_plain`) and `cpg_tpu`'s `masked_conv2d` and its
custom VJP (Pallas in interpret mode, as the JAX tests run it). Inputs and
weights are bf16 values held in f32, so the bf16 select and the f32
products are exact and the comparison is f32 against f32 that differs only
in summation order: rtol = atol = 1e-5 (sums of at most 576 products of
unit-scale terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.ops.pallas.masked_conv import masked_conv2d as j_masked_conv2d
from cpg_tpu_torch.ops import masked_conv as mc
from cpg_tpu_torch.ops import masked_matmul as mm
from cpg_tpu_torch.ops.conv import resolve_padding

THR = 5e-3
TOL = 1e-5
BK = mm.GEMM_BK


def _box(a, coords, box):
    """TMA's tiled box of the NHWC tensor a at coordinates (c, w, h, n),
    innermost first: a (box rows, 64) matrix with zeros wherever the box
    leaves a, below zero too."""
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


def _replay(a, bt, grid_hw, kh, kw, pad_top, pad_left, dgrad, sms):
    """What the kernel computes, walked as it walks: a is x (N, H, W, Cin)
    or, with dgrad, g (N, Ho, Wo, Cout); bt is w_eff^T (Cout, taps * Cin) or
    w_eff (taps * Cin, Cout). f32 sums of each tile over its k-steps."""
    n, _, _, ch = a.shape
    taps = kh * kw
    nout = bt.shape[0] // taps if dgrad else bt.shape[0]
    oh, ow = grid_hw
    box, bn, _, grid = mm.conv_plan(n, oh, ow, ch, nout, taps, sms)
    m = n * oh * ow
    tiles_m = -(-m // mm.GEMM_BM)
    tiles = tiles_m * -(-nout // bn)
    w3 = bt.reshape(taps, nout, ch) if dgrad else None
    out = torch.full((m, nout), float("nan"))
    sgn = -1 if dgrad else 1
    for b in range(grid):
        for t in range(b, tiles, grid):
            m0, n0 = (t % tiles_m) * mm.GEMM_BM, (t // tiles_m) * bn
            img, rem = divmod(m0, oh * ow)
            oh0, ow0 = divmod(rem, ow)
            acc = torch.zeros((mm.GEMM_BM, bn))
            for kt in range(taps * ch // BK):
                tap, c0 = divmod(kt, ch // BK)
                c0 *= BK
                dh, dw = tap // kw - pad_top, tap % kw - pad_left
                tile_a = _box(a, (c0, ow0 + sgn * dw, oh0 + sgn * dh, img), box)
                if dgrad:
                    tile_b = _rows(w3[tap, :, c0:c0 + BK], n0, bn)
                else:
                    tile_b = _rows(bt[:, kt * BK:(kt + 1) * BK], n0, bn)
                acc += tile_a @ tile_b.t()
            rows, cols = min(mm.GEMM_BM, m - m0), min(bn, nout - n0)
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return out.reshape(n, oh, ow, nout)


def _bf16_values(a):
    """a rounded to bf16, held in f32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _case(n, hw, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = _bf16_values(rng.randn(n, hw, hw, cin).astype(np.float32))
    w = _bf16_values((rng.randn(3, 3, cin, cout) * 0.06).astype(np.float32))
    own = rng.choice([0, 1, 2, 3], size=w.shape).astype(np.int8)
    pm = (rng.randn(*w.shape) * 0.01).astype(np.float32)
    pm.reshape(-1)[::7] = np.float32(THR)   # on the threshold: not picked
    g = _bf16_values(rng.randn(n, hw, hw, cout).astype(np.float32))
    return x, w, own, pm, g


def _jax_conv_and_dx(x, w, own, pm, g, mode):
    """cpg_tpu's masked conv and its custom VJP's dx, under one jit."""
    @jax.jit
    def run(x, w, pm, g):
        y, vjp = jax.vjp(lambda x_: j_masked_conv2d(
            x_, w, jnp.asarray(own), pm, 2, threshold=THR, mask_mode=mode), x)
        return y, vjp(g)[0]
    y, dx = run(*(jnp.asarray(a) for a in (x, w, pm, g)))
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("mode", ["binary", "ternary"])
@pytest.mark.parametrize("hw", [4, 2])
def test_box_walk_is_the_masked_conv_and_its_dx(hw, mode):
    """N = 3, Cin = Cout = 64: one 128-pixel tile of whole images (boxes
    of 8 and 32 images, the second tile-free images zero-filled), every
    tap's box partly outside the image."""
    n, cin, cout = 3, 64, 64
    x, w, own, pm, g = _case(n, hw, cin, cout, seed=hw)
    tx, tw, town, tpm, tg = (torch.from_numpy(a) for a in (x, w, own, pm, g))
    assert mc.conv_route(tx.bfloat16(), tw, 1, "SAME")
    pt, _, pl, _ = resolve_padding("SAME", hw, hw, 3, 3, 1)
    wt = mm.masked_matmul_select_plain(tw.reshape(-1, cout),
                                       town.reshape(-1, cout),
                                       tpm.reshape(-1, cout), 2, THR, mode,
                                       transpose=True).float()
    weff = mm.masked_matmul_select_plain(tw.reshape(-1, cout),
                                         town.reshape(-1, cout),
                                         tpm.reshape(-1, cout), 2, THR,
                                         mode).float()
    y = _replay(tx, wt, (hw, hw), 3, 3, pt, pl, False, 132)
    dx = _replay(tg, weff, (hw, hw), 3, 3, pt, pl, True, 132)
    y_plain = mc.masked_conv2d_plain(tx, tw, town, tpm, 2, threshold=THR,
                                     mask_mode=mode)
    dx_plain = mc.masked_conv2d_bwd_dx_plain(tg, tx, tw, town, tpm, 2,
                                             threshold=THR, mask_mode=mode)
    y_jax, dx_jax = _jax_conv_and_dx(x, w, own, pm, g, mode)
    for got, want in ((y, y_plain.numpy()), (y, y_jax), (dx, dx_plain.numpy()),
                      (dx, dx_jax)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", [
    # (n, H = W, Cin, Cout, SMs): rows of one image (16x16: 8 rows a box,
    # two tiles an image) and two images a box (8x8) with more channels
    # than one k-step a tap and two output-channel tiles; 7 SMs walk
    # several tiles a block
    (1, 16, 64, 128, 7), (3, 8, 128, 64, 7), (2, 16, 64, 64, 132),
])
def test_box_walk_at_row_boxes_matches_the_plain_versions(case):
    n, hw, cin, cout, sms = case
    x, w, own, pm, g = _case(n, hw, cin, cout, seed=n + hw)
    tx, tw, town, tpm, tg = (torch.from_numpy(a) for a in (x, w, own, pm, g))
    views = [t.reshape(-1, cout) for t in (tw, town, tpm)]
    wt = mm.masked_matmul_select_plain(*views, 3, THR, "ternary",
                                       transpose=True).float()
    weff = mm.masked_matmul_select_plain(*views, 3, THR, "ternary").float()
    y = _replay(tx, wt, (hw, hw), 3, 3, 1, 1, False, sms)
    dx = _replay(tg, weff, (hw, hw), 3, 3, 1, 1, True, sms)
    y_plain = mc.masked_conv2d_plain(tx, tw, town, tpm, 3, threshold=THR,
                                     mask_mode="ternary")
    dx_plain = mc.masked_conv2d_bwd_dx_plain(tg, tx, tw, town, tpm, 3,
                                             threshold=THR,
                                             mask_mode="ternary")
    np.testing.assert_allclose(y.numpy(), y_plain.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dx.numpy(), dx_plain.numpy(), rtol=TOL,
                               atol=TOL)


def test_box_zero_fills_outside_the_tensor():
    a = torch.arange(2 * 3 * 3 * 64, dtype=torch.float32).reshape(2, 3, 3, 64)
    got = _box(a, (0, -1, -1, 1), (64, 3, 3, 2)).reshape(2, 3, 3, 64)
    assert got[1].abs().sum() == 0                  # image 2 is past N
    assert got[0, 0].abs().sum() == 0 and got[0, :, 0].abs().sum() == 0
    assert torch.equal(got[0, 1:, 1:], a[1, :2, :2])
