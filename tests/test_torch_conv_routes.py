"""The masked conv's routes off the conv boxes, replayed in plain PyTorch.

On the card `masked_conv.fwd_dx_route` sends a bf16 conv with Cin and Cout
multiples of 64 (1x1 or 3x3, stride 1 or 2, any grid) that `conv_route`'s
boxes cannot take to one of two GEMMs over the selected weight:

* "dense": a 1x1 conv at stride 1 is the dense TN GEMM of
  `csrc/masked_matmul.cu` over x as (N*H*W, Cin) (dx: g as (N*H*W, Cout)
  against w_eff);
* "im2col": `csrc/tma_gemm.cuh`'s `conv_im2col_kernel`. Its producer loads,
  for k-step kt = (tap j of the phase, channel block), one im2col TMA load
  of 128 pixels: the traversal of the map's bounding box (from the lower
  corner to the last column or row plus the upper corner, W fastest, then
  H, then the image, each step the traversal stride) from the tile's base
  coordinate on, each pixel read at the tap's offsets, zeros outside the
  tensor and past the last image. `_im2col_tile` emulates that load;
  `_replay` walks `masked_matmul.im2col_plan`'s phases, tiles and
  persistent grid exactly as the kernel does, multiplies by the plain
  select's output and stores each tile's rows where the kernel stores them
  (the TMA store, or dx's strided positions for the stride-2 phases).

Each walk must give the plain versions (`masked_conv2d_plain`,
`masked_conv2d_bwd_dx_plain`) and `cpg_tpu`'s `masked_conv2d` and its
custom VJP (Pallas in interpret mode, as the JAX tests run it). Inputs and
weights are bf16 values held in f32, so the select and the products are
exact and the sums differ only in order: rtol = atol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.ops.pallas.masked_conv import masked_conv2d as j_masked_conv2d
from cpg_tpu_torch.ops import fused_chain as fc
from cpg_tpu_torch.ops import masked_conv as mc
from cpg_tpu_torch.ops import masked_matmul as mm
from cpg_tpu_torch.ops.conv import out_size, resolve_padding

import chip_smoke as cs

THR = 5e-3
TOL = 1e-5
BK, BM = mm.GEMM_BK, mm.GEMM_BM


def _im2col_tile(a, c0, base, img, lower, upper, step, off):
    """One im2col TMA load of the NHWC tensor a: 128 pixels x 64 channels
    from channel c0, the traversal starting at base (w, h) of image img."""
    n, hh, ww, _ = a.shape
    out = torch.zeros((BM, BK), dtype=a.dtype)
    last_w, last_h = ww - 1 + upper[0], hh - 1 + upper[1]
    w, h = base
    for p in range(BM):
        y, x = h + off[1], w + off[0]
        if img < n and 0 <= y < hh and 0 <= x < ww:
            out[p] = a[img, y, x, c0:c0 + BK]
        w += step
        if w > last_w:
            w, h = lower[0], h + step
            if h > last_h:
                h, img = lower[1], img + 1
    return out


def _rows(t, r0, size):
    """Rows r0 .. r0 + size of t, zero past its end (a clipped TMA box)."""
    out = torch.zeros((size, t.shape[1]), dtype=t.dtype)
    part = t[r0:r0 + size]
    out[:part.shape[0]] = part
    return out


def _replay(a, bt, grid_hw, kh, kw, stride, pads, dgrad, sms):
    """What `conv_im2col_kernel` computes, walked as it walks: a is x (N, H,
    W, Cin) or, with dgrad, g (N, Ho, Wo, Cout); bt is w_eff^T (Cout, taps *
    Cin) or w_eff (taps * Cin, Cout). f32 sums of each tile over its
    k-steps."""
    n, ah, aw, ch = a.shape
    taps = kh * kw
    nout = bt.shape[0] // taps if dgrad else bt.shape[0]
    oh, ow = grid_hw
    phases, bn, _, grid = mm.im2col_plan(n, ah, aw, oh, ow, kh, kw, stride,
                                         tuple(pads), ch, nout, dgrad, sms)
    assert len(phases) == (stride * stride if dgrad else 1)
    tstep = 1 if dgrad else stride
    ostep = stride if len(phases) > 1 else 1
    cblocks, tiles_n = ch // BK, -(-nout // bn)
    tile0, tiles = [], 0
    for rows, cols, *_ in phases:
        tile0.append(tiles)
        tiles += -(-n * rows * cols // BM) * tiles_n
    w3 = bt.reshape(taps, nout, ch) if dgrad else None
    out = torch.full((n, oh, ow, nout), float("nan"))
    for b in range(grid):
        for t in range(b, tiles, grid):
            p = max(q for q in range(len(phases)) if t >= tile0[q])
            rows, cols, lw, lh, row0, col0, tp = phases[p]
            m, tiles_m = n * rows * cols, -(-n * rows * cols // BM)
            local = t - tile0[p]
            m0, n0 = (local % tiles_m) * BM, (local // tiles_m) * bn
            img, rem = divmod(m0, rows * cols)
            i0, j0 = divmod(rem, cols)
            upper = (lw + (cols - 1) * tstep - (aw - 1),
                     lh + (rows - 1) * tstep - (ah - 1))
            acc = torch.zeros((BM, bn))
            for kt in range(len(tp) * cblocks):
                j, cb = divmod(kt, cblocks)
                tap, o_w, o_h = tp[j]
                tile_a = _im2col_tile(a, cb * BK, (lw + j0 * tstep,
                                                   lh + i0 * tstep), img,
                                      (lw, lh), upper, tstep, (o_w, o_h))
                if dgrad:
                    tile_b = _rows(w3[tap, :, cb * BK:(cb + 1) * BK], n0, bn)
                else:
                    k0 = tap * ch + cb * BK
                    tile_b = _rows(bt[:, k0:k0 + BK], n0, bn)
                acc += tile_a @ tile_b.t()
            cw = min(bn, nout - n0)
            for r in range(min(BM, m - m0)):
                im, rem = divmod(m0 + r, rows * cols)
                i, jj = divmod(rem, cols)
                out[im, row0 + ostep * i, col0 + ostep * jj,
                    n0:n0 + cw] = acc[r, :cw]
    return out


def _bf16_values(a):
    """a rounded to bf16, held in f32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _case(n, h, w, k, stride, pad, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = _bf16_values(rng.randn(n, h, w, cin).astype(np.float32))
    wt = _bf16_values((rng.randn(k, k, cin, cout) * 0.06).astype(np.float32))
    own = rng.choice([0, 1, 2, 3], size=wt.shape).astype(np.int8)
    pm = (rng.randn(*wt.shape) * 0.01).astype(np.float32)
    pm.reshape(-1)[::7] = np.float32(THR)   # on the threshold: not picked
    pads = resolve_padding(pad, h, w, k, k, stride)
    ho, wo = out_size(h, k, stride, *pads[:2]), out_size(w, k, stride, *pads[2:])
    g = _bf16_values(rng.randn(n, ho, wo, cout).astype(np.float32))
    return x, wt, own, pm, g, pads


def _jax_conv_and_dx(x, w, own, pm, g, mode, stride, pads):
    """cpg_tpu's masked conv and its custom VJP's dx, under one jit."""
    padding = ((pads[0], pads[1]), (pads[2], pads[3]))

    @jax.jit
    def run(x, w, pm, g):
        y, vjp = jax.vjp(lambda x_: j_masked_conv2d(
            x_, w, jnp.asarray(own), pm, 2, stride=stride, padding=padding,
            threshold=THR, mask_mode=mode), x)
        return y, vjp(g)[0]
    y, dx = run(*(jnp.asarray(a) for a in (x, w, pm, g)))
    return np.asarray(y), np.asarray(dx)


def _selected(tw, town, tpm, mode):
    """The plain select pass's outputs: w_eff^T (the forward's bt) and
    w_eff (dx's), in f32."""
    views = [t.reshape(-1, tw.shape[-1]) for t in (tw, town, tpm)]
    return (mm.masked_matmul_select_plain(*views, 2, THR, mode,
                                          transpose=True).float(),
            mm.masked_matmul_select_plain(*views, 2, THR, mode).float())


def _check_walks(case, mode, sms):
    """Replays y and dx of one conv on the im2col route and holds them
    against the plain versions and cpg_tpu's."""
    n, h, w, k, stride, pad, cin, cout = case
    x, wt, own, pm, g, pads = _case(n, h, w, k, stride, pad, cin, cout,
                                    seed=h * 7 + w + stride)
    tx, tw, town, tpm, tg = (torch.from_numpy(a) for a in (x, wt, own, pm, g))
    assert mc.fwd_dx_route(tx.bfloat16(), tw, stride, pad) == "im2col"
    bt_fwd, bt_dx = _selected(tw, town, tpm, mode)
    y = _replay(tx, bt_fwd, g.shape[1:3], k, k, stride, pads, False, sms)
    dx = _replay(tg, bt_dx, (h, w), k, k, stride, pads, True, sms)
    y_plain = mc.masked_conv2d_plain(tx, tw, town, tpm, 2, stride, pad,
                                     threshold=THR, mask_mode=mode)
    dx_plain = mc.masked_conv2d_bwd_dx_plain(tg, tx, tw, town, tpm, 2,
                                             stride, pad, threshold=THR,
                                             mask_mode=mode)
    y_jax, dx_jax = _jax_conv_and_dx(x, wt, own, pm, g, mode, stride, pads)
    for got, want in ((y, y_plain.numpy()), (y, y_jax), (dx, dx_plain.numpy()),
                      (dx, dx_jax)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["binary", "ternary"])
@pytest.mark.parametrize("case", [
    # (n, H, W, k, stride, padding, Cin, Cout), 3x3 at stride 1 on grids
    # with 128 % wo != 0: tiles cross rows and images, the last tile runs
    # past the last image
    (2, 7, 6, 3, 1, "SAME", 64, 64),      # wo 6 (SphereNet's unit4)
    (1, 5, 7, 3, 1, "SAME", 64, 128),     # wo 7, two output tiles of 64
    (1, 6, 12, 3, 1, 1, 128, 64),         # wo 12, two channel blocks
    (1, 3, 14, 3, 1, "SAME", 64, 64),     # wo 14
], ids=["wo6", "wo7", "wo12", "wo14"])
def test_im2col_walk_at_any_grid_is_the_masked_conv_and_its_dx(case, mode):
    _check_walks(case, mode, 132)


@pytest.mark.parametrize("case", [
    # 3x3/2 with the models' explicit pad 1, on even and odd inputs
    (2, 8, 6, 3, 2, 1, 64, 64),
    (1, 7, 5, 3, 2, 1, 64, 128),
    # 3x3/2 SAME: even sides pad (0, 1), odd sides (1, 1); 9x8 has both
    (2, 8, 6, 3, 2, "SAME", 64, 64),
    (1, 9, 8, 3, 2, "SAME", 128, 64),
    # 1x1/2 SAME (no padding): three of dx's four phases are zeros
    (2, 8, 6, 1, 2, "SAME", 64, 64),
    (1, 7, 5, 1, 2, "SAME", 128, 64),
], ids=["3x3s2_even", "3x3s2_odd", "3x3s2_same_even", "3x3s2_same_mixed",
        "1x1s2_even", "1x1s2_odd"])
def test_im2col_walk_at_stride_2_forward_and_dx_phases(case):
    _check_walks(case, "ternary", 132)


def test_im2col_walk_with_few_blocks_walks_every_tile_once():
    """7 SMs: each block walks several tiles, across the four phases."""
    _check_walks((2, 7, 6, 3, 2, 1, 64, 128), "binary", 7)


def test_im2col_tile_wraps_rows_and_images_and_fills_zeros():
    """The emulated load at a 3x2 grid, 1x1 at stride 2 over a 2x5x4 input
    (bounding box W 0..2, H 0..4 at step 2): 12 pixels, then zeros past the
    last image."""
    a = torch.arange(2 * 5 * 4 * 64, dtype=torch.float32).reshape(2, 5, 4, 64)
    got = _im2col_tile(a, 0, (0, 0), 0, (0, 0), (-1, 0), 2, (0, 0))
    want = torch.stack([a[i, y, x] for i in range(2) for y in (0, 2, 4)
                        for x in (0, 2)])
    assert torch.equal(got[:12], want)
    assert got[12:].abs().sum() == 0


def test_im2col_plan_phases_cover_every_input_pixel_once():
    """dx's phases at stride 2 partition the input grid, and each takes the
    taps that reach its parity: 1, 2, 2, 4 for 3x3 pad 1; one tap in one
    phase for 1x1."""
    for h, w, k, pad in ((8, 6, 3, 1), (7, 5, 3, 1), (9, 8, 3, "SAME"),
                         (7, 5, 1, "SAME")):
        pads = resolve_padding(pad, h, w, k, k, 2)
        ho, wo = out_size(h, k, 2, *pads[:2]), out_size(w, k, 2, *pads[2:])
        phases, *_ = mm.im2col_plan(2, ho, wo, h, w, k, k, 2, pads, 64, 64,
                                    True, 132)
        seen = torch.zeros((h, w), dtype=torch.int64)
        for rows, cols, _, _, r0, c0, _ in phases:
            seen[r0::2, c0::2] += 1
            assert (rows, cols) == seen[r0::2, c0::2].shape
        assert bool((seen == 1).all())
        counts = sorted(len(p[-1]) for p in phases)
        assert counts == ([1, 2, 2, 4] if k == 3 else [0, 0, 0, 1])


def _dense_case(mode):
    n, h, w, cin, cout = 2, 5, 6, 64, 128
    x, wt, own, pm, g, _ = _case(n, h, w, 1, 1, "SAME", cin, cout, seed=3)
    return n, h, w, cin, cout, x, wt, own, pm, g


@pytest.mark.parametrize("mode", ["binary", "ternary"])
def test_1x1_stride_1_takes_the_dense_gemm(mode):
    """A 1x1 conv at stride 1 is (N*H*W, Cin) x w_eff(Cin, Cout): the
    select pass and the TN GEMM (its plain version), y and dx, against the
    plain versions and cpg_tpu's."""
    n, h, w, cin, cout, x, wt, own, pm, g = _dense_case(mode)
    tx, tw, town, tpm, tg = (torch.from_numpy(a) for a in (x, wt, own, pm, g))
    assert mc.fwd_dx_route(tx.bfloat16(), tw, 1, "SAME") == "dense"
    bt_fwd, bt_dx = _selected(tw, town, tpm, mode)
    y = (tx.reshape(-1, cin) @ bt_fwd.t()).reshape(n, h, w, cout)
    dx = (tg.reshape(-1, cout) @ bt_dx.t()).reshape(n, h, w, cin)
    y_jax, dx_jax = _jax_conv_and_dx(x, wt, own, pm, g, mode, 1, (0,) * 4)
    y_plain = mc.masked_conv2d_plain(tx, tw, town, tpm, 2, threshold=THR,
                                     mask_mode=mode)
    dx_plain = mc.masked_conv2d_bwd_dx_plain(tg, tx, tw, town, tpm, 2,
                                             threshold=THR, mask_mode=mode)
    for got, want in ((y, y_plain.numpy()), (y, y_jax), (dx, dx_plain.numpy()),
                      (dx, dx_jax)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _route(hw, k, stride, pad, cin, cout, dtype=torch.bfloat16):
    h, w = (hw, hw) if isinstance(hw, int) else hw
    x = torch.zeros((1, h, w, cin), dtype=dtype)
    wt = torch.zeros((k, k, cin, cout))
    return mc.fwd_dx_route(x, wt, stride, pad)


@pytest.mark.parametrize("geo", cs.RESNET_CONV_SHAPES,
                         ids=[g[0] for g in cs.RESNET_CONV_SHAPES])
def test_route_at_every_resnet50_conv(geo):
    """The 7x7/2 stem stays on K1/K2; the 33 1x1 convs at stride 1 take
    the dense GEMM; the three 3x3/2 convs and three 1x1/2 downsamples the
    im2col walk. f32 takes K1/K2 everywhere."""
    name, hw, k, stride, cin, cout, _ = geo
    pad = cs._resnet_pads(k, stride)
    want = (None if k == 7 else "dense" if (k, stride) == (1, 1)
            else "im2col")
    assert _route(hw, k, stride, pad, cin, cout) == want
    assert _route(hw, k, stride, pad, cin, cout, torch.float32) is None


def test_resnet50_dense_route_covers_33_convs():
    assert sum(g[-1] for g in cs.RESNET_CONV_SHAPES
               if _route(g[1], g[2], g[3], cs._resnet_pads(g[2], g[3]),
                         g[4], g[5]) == "dense") == 33


@pytest.mark.parametrize("geo", cs.SPHERE_CONV_SHAPES,
                         ids=[g[0] for g in cs.SPHERE_CONV_SHAPES])
def test_route_at_every_spherenet20_conv(geo):
    """Every SphereNet-20 conv past the stem (Cin = 3) takes the im2col
    walk: no grid (48, 24, 12, 6 wide) has a 128-pixel box of whole rows,
    and the downs have stride 2."""
    name, hw, stride, cin, cout, _ = geo
    pad = 1 if stride == 2 else "SAME"
    want = None if name == "stem_s2" else "im2col"
    assert _route(hw, 3, stride, pad, cin, cout) == want


@pytest.mark.parametrize("mult", [1.0, 0.125])
@pytest.mark.parametrize("layer", cs.MASKED_CONV_SHAPES,
                         ids=[c[0] for c in cs.MASKED_CONV_SHAPES])
def test_vgg16_routes_are_unchanged(layer, mult):
    """VGG16-BN's masked convs keep their routes: conv0 (Cin = 3) and the
    narrow convs at width 0.125 on K1/K2; conv2/4/7/10 at width 1.0 and
    conv10 at 0.125 (64 -> 64 channels) on the boxes."""
    name, hw, cin, cout = layer
    cin = cin if name == "conv0" else int(cin * mult)
    cout = int(cout * mult)
    want = "gemm" if cin % 64 == 0 and cout % 64 == 0 else None
    assert _route(hw, 3, 1, "SAME", cin, cout) == want


# every model's first conv (Cin = 3): (name, input (H, W), k, stride,
# padding, Cout at width 1.0)
FIRST_CONVS = [("resnet50_stem", (224, 224), 7, 2, ((3, 3), (3, 3)), 64),
               ("spherenet20_stem", (112, 96), 3, 2, 1, 64),
               ("vgg16_conv0", (32, 32), 3, 1, "SAME", 64)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mult", [1.0, 0.5, 0.125])
@pytest.mark.parametrize("conv", FIRST_CONVS, ids=[c[0] for c in FIRST_CONVS])
def test_first_conv_of_every_model_takes_the_stem_route(conv, mult, dtype):
    """y of ResNet-50's and SphereNet-20's stems and VGG16-BN's conv0 takes
    the stem kernel in bf16 at width 1.0; f32 and the narrower widths
    (Cout 32, 8) stay on the earlier K1. `fwd_dx_route` stays None at all
    of them (dx, when asked for, is K2's; K3 the patches')."""
    name, (h, w), k, stride, pad, cout = conv
    x = torch.zeros((2, h, w, 3), dtype=dtype)
    wt = torch.zeros((k, k, 3, int(cout * mult)))
    assert mc.stem_route(x, wt, stride, pad) == (
        dtype == torch.bfloat16 and mult == 1.0)
    assert mc.fwd_dx_route(x, wt, stride, pad) is None
    assert mc.wgrad_conv_route(x, wt, stride, pad) == (
        "patches" if dtype == torch.bfloat16 else None)


def _seam_routes(hw, cin, cout, dtype=torch.bfloat16):
    """(K4's route, K5's route) at a fused seam: x (1, hw, hw, Cin), the
    (3, 3, Cin, Cout) weight in the dot dtype."""
    x = torch.zeros((1, hw, hw, cin), dtype=dtype)
    w = torch.zeros((3, 3, cin, cout), dtype=dtype)
    return fc.fwd_route(x, w, dtype), fc.dx_route(x, w, dtype)


@pytest.mark.parametrize("seam", cs.RESNET_SEAMS,
                         ids=[s_[0] for s_ in cs.RESNET_SEAMS])
def test_fused_routes_at_every_resnet50_seam(seam):
    """ResNet-50's 13 stride-1 bottleneck seams (56, 28, 14, 7 px; no
    128-pixel box of whole rows or images) take K4's halo tiles and K5's
    im2col walk in bf16; f32 keeps the earlier kernels."""
    name, hw, c, _ = seam
    assert mc.conv_box(hw, hw) is None
    assert _seam_routes(hw, c, c) == ("im2col", "im2col")
    assert _seam_routes(hw, c, c, torch.float32) == (None, None)


def test_resnet50_seams_count_13():
    assert sum(s_[-1] for s_ in cs.RESNET_SEAMS) == 13


@pytest.mark.parametrize("mult", [1.0, 0.125])
@pytest.mark.parametrize("seam", cs.CHAIN_SHAPES,
                         ids=[s_[0] for s_ in cs.CHAIN_SHAPES])
def test_vgg16_fused_routes_are_unchanged(seam, mult):
    """VGG16-BN's eight seams keep the box route ("gemm") where Cin and
    Cout are multiples of 64; the narrow width-0.125 seams (16-32
    channels) keep the earlier K4 and K5."""
    name, hw, cin, cout = seam
    cin, cout = int(cin * mult), int(cout * mult)
    want = "gemm" if cin % 64 == 0 and cout % 64 == 0 else None
    assert _seam_routes(hw, cin, cout) == (want, want)


@pytest.mark.parametrize("shape", cs.TP_CHAIN_SHAPES,
                         ids=[s_[0] for s_ in cs.TP_CHAIN_SHAPES])
def test_tensor_parallel_seams_keep_their_routes(shape):
    """A rank's slice of a seam over two model ranks: the routes chip_smoke
    expects ("k4"/"k5": the earlier kernels)."""
    name, hw, cin, cout, route4, route5 = shape
    want = tuple(None if r in ("k4", "k5") else r for r in (route4, route5))
    assert _seam_routes(hw, cin, cout) == want


@pytest.mark.parametrize("case", [
    # (H = W, Cin, Cout): 16 channels at ResNet-50's and VGG16-BN's grids,
    # and a Cout that is no multiple of 64
    (56, 16, 16), (7, 16, 16), (16, 16, 16), (14, 64, 96)])
def test_narrow_seams_keep_the_earlier_kernels(case):
    hw, cin, cout = case
    assert _seam_routes(hw, cin, cout) == (None, None)
    assert _seam_routes(hw, cin, cout, torch.float32) == (None, None)


def _wgrad_route(hw, k, stride, pad, cin, cout, dtype=torch.bfloat16):
    h, w = (hw, hw) if isinstance(hw, int) else hw
    x = torch.zeros((1, h, w, cin), dtype=dtype)
    return mc.wgrad_conv_route(x, torch.zeros((k, k, cin, cout)), stride, pad)


@pytest.mark.parametrize("geo", cs.RESNET_CONV_SHAPES,
                         ids=[g[0] for g in cs.RESNET_CONV_SHAPES])
def test_wgrad_route_at_every_resnet50_conv(geo):
    """K3 follows y's and dx's route: the dense walk over x as a matrix at
    the 1x1 convs at stride 1, the im2col walk at the 3x3/2 and 1x1/2
    convs; the 7x7/2 stem (K = 147 -> 152) reduces its patches. f32 keeps
    the old K3 everywhere."""
    name, hw, k, stride, cin, cout, _ = geo
    pad = cs._resnet_pads(k, stride)
    want = ("patches" if k == 7 else "dense" if (k, stride) == (1, 1)
            else "im2col")
    assert _wgrad_route(hw, k, stride, pad, cin, cout) == want
    assert _wgrad_route(hw, k, stride, pad, cin, cout, torch.float32) is None


def test_resnet50_wgrad_routes_count_40_convs():
    """33 dense, 6 im2col, the stem's patches: ResNet-50's one im2col launch
    a train step (was 5)."""
    got = {}
    for _, hw, k, stride, cin, cout, per in cs.RESNET_CONV_SHAPES:
        r = _wgrad_route(hw, k, stride, cs._resnet_pads(k, stride), cin, cout)
        got[r] = got.get(r, 0) + per
    assert got == {"dense": 33, "im2col": 6, "patches": 1}


@pytest.mark.parametrize("geo", cs.SPHERE_CONV_SHAPES,
                         ids=[g[0] for g in cs.SPHERE_CONV_SHAPES])
def test_wgrad_route_at_every_spherenet20_conv(geo):
    """SphereNet-20's units and downs take the im2col walk (no grid has a
    128-pixel box of whole rows; the downs have stride 2), its 3x3/2 stem
    (K = 27 -> 32) its patches; f32 the old K3."""
    name, hw, stride, cin, cout, _ = geo
    pad = 1 if stride == 2 else "SAME"
    want = "patches" if name == "stem_s2" else "im2col"
    assert _wgrad_route(hw, 3, stride, pad, cin, cout) == want
    assert _wgrad_route(hw, 3, stride, pad, cin, cout, torch.float32) is None


@pytest.mark.parametrize("mult", [1.0, 0.125])
@pytest.mark.parametrize("layer", cs.MASKED_CONV_SHAPES,
                         ids=[c[0] for c in cs.MASKED_CONV_SHAPES])
def test_vgg16_wgrad_routes_are_unchanged(layer, mult):
    """VGG16-BN's K3: conv2/4/7/10 at width 1.0 and conv10 at 0.125 on the
    boxes, conv0 on its patches at both widths, the narrow convs at 0.125
    (Cin 8-32, K = 72-288) on the old K3."""
    name, hw, cin, cout = layer
    cin = cin if name == "conv0" else int(cin * mult)
    cout = int(cout * mult)
    want = ("patches" if name == "conv0" else
            "gemm" if cin % 64 == 0 and cout % 64 == 0 else None)
    assert _wgrad_route(hw, 3, 1, "SAME", cin, cout) == want


@pytest.mark.parametrize("case", [
    # (H, W, k, stride, pad, Cin, Cout, dtype): what keeps the old K3
    (16, 16, 3, 1, "SAME", 8, 16, torch.bfloat16),     # VGG conv2 at 0.125
    (8, 8, 3, 2, 1, 32, 64, torch.bfloat16),           # narrow, stride 2
    (7, 6, 3, 1, "SAME", 64, 72, torch.bfloat16),      # Cout % 64 != 0
    (7, 6, 5, 1, "SAME", 64, 64, torch.bfloat16),      # 5x5
    (7, 6, 3, 1, "SAME", 512, 512, torch.float32),     # f32
    (224, 224, 7, 2, 3, 3, 64, torch.float32),         # f32 stem
])
def test_wgrad_route_keeps_f32_and_narrow_widths_on_the_old_k3(case):
    h, w, k, stride, pad, cin, cout, dtype = case
    assert _wgrad_route((h, w), k, stride, pad, cin, cout, dtype) is None


def _wgrad_convs():
    """(name, n, H, W, k, stride, pads, Cin, Cout) of every ResNet-50 and
    SphereNet-20 conv on K3's im2col walk, at the chip's batch sizes."""
    out = []
    for name, hw, k, stride, cin, cout, _ in cs.RESNET_CONV_SHAPES:
        pad = cs._resnet_pads(k, stride)
        if _wgrad_route(hw, k, stride, pad, cin, cout) == "im2col":
            out.append((name, cs.RESNET_BATCH, hw, hw, k, stride,
                        resolve_padding(pad, hw, hw, k, k, stride), cin, cout))
    for name, (h, w), stride, cin, cout, _ in cs.SPHERE_CONV_SHAPES:
        pad = 1 if stride == 2 else "SAME"
        if _wgrad_route((h, w), 3, stride, pad, cin, cout) == "im2col":
            out.append((name, cs.SPHERE_BATCH, h, w, 3, stride,
                        resolve_padding(pad, h, w, 3, 3, stride), cin, cout))
    return out


@pytest.mark.parametrize("conv", _wgrad_convs(), ids=lambda c: c[0])
def test_wgrad_im2col_plan_fits_the_card_at_every_model_conv(conv):
    """K3's im2col walk at the models' convs: `wgrad_plan` over 128-pixel
    steps fits the H100's shared memory with a ring of 2-6 stages, no
    more blocks than items or SMs, every split within
    WGRAD_MAX_SPLIT_ROWS pixels and none empty; the map's corners within
    cuTensorMapEncodeIm2col's [-128, 127], the taps' offsets within the
    entry's 16."""
    name, n, h, w, k, stride, pads, cin, cout = conv
    ho = out_size(h, k, stride, *pads[:2])
    wo = out_size(w, k, stride, *pads[2:])
    m, kk = n * ho * wo, k * k * cin
    bn, splits, stages, grid = mm.wgrad_plan(m, kk, cout, 132,
                                             mm.WGRAD_CONV_ROWS)
    assert 2 <= stages <= mm.WGRAD_MAX_STAGES
    assert mm.wgrad_smem_bytes(bn, mm.WGRAD_CONV_ROWS, stages) <= \
        mm.SMEM_PER_BLOCK - 1024
    steps = -(-m // mm.WGRAD_CONV_ROWS)
    per = -(-steps // splits)
    assert per * mm.WGRAD_CONV_ROWS <= mm.WGRAD_MAX_SPLIT_ROWS
    assert (splits - 1) * per < steps
    items = splits * -(-kk // mm.WGRAD_BK) * -(-cout // bn)
    assert 0 < grid <= min(items, 132)
    lower = (-pads[2], -pads[0])
    upper = (lower[0] + (wo - 1) * stride - (w - 1),
             lower[1] + (ho - 1) * stride - (h - 1))
    assert all(-128 <= v <= 127 for v in (*lower, *upper))
    assert k <= 16 and cin % 64 == 0 and cout % 8 == 0


@pytest.mark.parametrize("case", [
    # (H, W, k, stride, pad, Cin, Cout): what stays off both walks
    (7, 6, 5, 1, "SAME", 64, 64),      # 5x5
    (8, 8, 3, 3, "SAME", 64, 64),      # stride 3
    (8, 8, 3, 1, "SAME", 96, 64),      # Cin not a multiple of 64
    (8, 8, 3, 2, "SAME", 64, 72),      # Cout not a multiple of 64
    (8, 8, 3, 1, 3, 64, 64),           # pad past k - 1
    (8, 8, 1, 1, 1, 64, 64),           # a padded 1x1
])
def test_route_refuses_what_the_walks_do_not_take(case):
    h, w, k, stride, pad, cin, cout = case
    assert _route((h, w), k, stride, pad, cin, cout) is None


def _model_convs():
    """(name, n, H, W, k, stride, pads, Cin, Cout) of every ResNet-50 and
    SphereNet-20 conv on the im2col walk, at the chip's batch sizes."""
    out = []
    for name, hw, k, stride, cin, cout, _ in cs.RESNET_CONV_SHAPES:
        pad = cs._resnet_pads(k, stride)
        if _route(hw, k, stride, pad, cin, cout) == "im2col":
            out.append((name, cs.RESNET_BATCH, hw, hw, k, stride,
                        resolve_padding(pad, hw, hw, k, k, stride), cin, cout))
    for name, (h, w), stride, cin, cout, _ in cs.SPHERE_CONV_SHAPES:
        pad = 1 if stride == 2 else "SAME"
        if _route((h, w), 3, stride, pad, cin, cout) == "im2col":
            out.append((name, cs.SPHERE_BATCH, h, w, 3, stride,
                        resolve_padding(pad, h, w, 3, 3, stride), cin, cout))
    return out


@pytest.mark.parametrize("conv", _model_convs(), ids=lambda c: c[0])
def test_im2col_plan_fits_the_card_at_every_model_conv(conv):
    """y's and dx's plans at the models' convs: a ring of 2-5 stages in the
    H100's 232,448 B, no more blocks than tiles or SMs, the im2col maps'
    bounding-box corners within cuTensorMapEncodeIm2col's [-128, 127] and each tap's
    offsets within the kernel."""
    name, n, h, w, k, stride, pads, cin, cout = conv
    ho = out_size(h, k, stride, *pads[:2])
    wo = out_size(w, k, stride, *pads[2:])
    for dgrad, (ah, aw, oh, ow, c, nout) in (
            (False, (h, w, ho, wo, cin, cout)),
            (True, (ho, wo, h, w, cout, cin))):
        phases, bn, stages, grid = mm.im2col_plan(
            n, ah, aw, oh, ow, k, k, stride, pads, c, nout, dgrad, 132)
        assert 2 <= stages <= mm.GEMM_MAX_STAGES
        assert mm.gemm_smem_bytes(bn, stages) <= mm.SMEM_PER_BLOCK
        tiles = sum(-(-n * r * q // BM) for r, q, *_ in phases) * -(-nout // bn)
        assert 0 < grid <= min(tiles, 132)
        t = 1 if dgrad else stride
        for rows, cols, lw, lh, _, _, taps in phases:
            upper = (lw + (cols - 1) * t - (aw - 1), lh + (rows - 1) * t - (ah - 1))
            assert all(-128 <= v <= 127 for v in (lw, lh, *upper))
            assert all(0 <= o_w < k and 0 <= o_h < k for _, o_w, o_h in taps)
