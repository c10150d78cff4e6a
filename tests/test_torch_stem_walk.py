"""K1's stem route, replayed in plain PyTorch on the CPU.

On the card a bf16 conv with Cin < 8 on `masked_conv.stem_route` (ResNet-
50's 7x7/2 stem, SphereNet-20's 3x3/2 stem, VGG16-BN's conv0) runs
`csrc/masked_conv_stem.cu`. Its persistent blocks walk 128-pixel output
tiles (`stem_plan`'s grid: block b takes tiles b, b + grid, ...). For each
tile one or two bulk copies land whole input rows in a halo buffer
(`stem_spans`: the rows of one image the tile's windows touch, and the next
image's first rows for a tile that runs into it); each output pixel's
patch is gathered from the halo in the (dh, dw, c) order of the HWIO
weight, zero where the window leaves the image and in the columns past K
(K = 147 -> 160, 27 -> 32; a thread whose two pixels' windows lie wholly
inside the image reads without checks, the columns past K at the window's
corner),
and multiplied by the weight selected once a block (rows past K zero);
each output pixel is stored once.

`_replay` walks the plan so, with every halo position the spans do not
fill NaN (a read of one would show in the output). Inputs and weights are
bf16 values held in f32, so the select and the products are exact and the
replay, `masked_conv2d_plain` and `cpg_tpu`'s `masked_conv2d` (Pallas in
interpret mode, as the JAX tests run it) differ only in summation order:
rtol = atol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.ops.pallas.masked_conv import masked_conv2d as j_masked_conv2d
from cpg_tpu_torch.ops import masked_conv as mc
from cpg_tpu_torch.ops import masked_matmul as mm
from cpg_tpu_torch.ops.conv import out_size, resolve_padding

THR = 5e-3
TOL = 1e-5
SMS = 3  # a small card: several tiles a block


def _bf16_values(a):
    """a rounded to bf16, held in f32."""
    return torch.from_numpy(a).bfloat16().float()


def _case(n, h, w, k, stride, pad, cout, seed, cin=3):
    rng = np.random.RandomState(seed)
    x = _bf16_values(rng.randn(n, h, w, cin).astype(np.float32))
    wt = _bf16_values((rng.randn(k, k, cin, cout) * 0.1).astype(np.float32))
    own = torch.from_numpy(rng.choice([0, 1, 2, 3], size=wt.shape)
                           .astype(np.int8))
    pm = rng.randn(*wt.shape).astype(np.float32) * 0.01
    pm.reshape(-1)[::7] = np.float32(THR)  # on the threshold: not picked
    return x, wt, own, torch.from_numpy(pm)


def _replay(x, wt, own, pm, task, mode, stride, pad, sms=SMS, stored=None):
    """y in f32 as the stem kernel walks it; `stored` counts each output
    pixel's stores."""
    n, h, w, cin = x.shape
    kh, kw, _, cout = wt.shape
    pads = resolve_padding(pad, h, w, kh, kw, stride)
    ho, wo = out_size(h, kh, stride, *pads[:2]), out_size(w, kw, stride,
                                                          *pads[2:])
    plan = mc.stem_plan(n, h, w, cin, cout, kh, kw, stride, pads, sms)
    k = kh * kw * cin
    # the weight, selected once a block, rows past K zero
    weff = torch.zeros((plan.kp, cout))
    weff[:k] = mm.masked_matmul_select_plain(
        wt.reshape(k, cout), own.reshape(k, cout), pm.reshape(k, cout), task,
        THR, mode).float()
    # the k table: (dh, dw) and the offset from the window's corner
    ks = torch.arange(k)
    tap, c = ks // cin, ks % cin
    dh, dw = tap // kw, tap % kw
    off = (dh * w + dw) * cin + c
    row = w * cin
    xf = x.reshape(n, h, row)
    m_end = n * ho * wo
    y = torch.full((m_end, cout), float("nan"))
    count = torch.zeros(m_end, dtype=torch.int64)
    for b in range(plan.grid):
        for t in range(b, plan.tiles, plan.grid):
            (ia, lo, ra), span_b = mc.stem_spans(t * 128, n, h, ho, wo, kh,
                                                 stride, pads[0])
            rb = span_b[2] if span_b else 0
            assert (ra + rb) * row * 2 <= plan.halo_bytes
            halo = torch.full((plan.halo_bytes // 2,), float("nan"))
            halo[:ra * row] = xf[ia, lo:lo + ra].reshape(-1)
            if span_b:
                halo[ra * row:(ra + rb) * row] = xf[span_b[0], :rb].reshape(-1)
            m = torch.arange(t * 128, t * 128 + 128)
            live = m < m_end
            img, rem = m // (ho * wo), m % (ho * wo)
            ih = (rem // wo) * stride - pads[0]
            iw = (rem % wo) * stride - pads[2]
            hrow = torch.where(img == ia, ih - lo, ra + ih)
            hb = (hrow * w + iw) * cin
            ok = (live[:, None] & (ih[:, None] + dh >= 0)
                  & (ih[:, None] + dh < h) & (iw[:, None] + dw >= 0)
                  & (iw[:, None] + dw < w))
            idx = torch.where(ok, hb[:, None] + off,
                              torch.zeros((), dtype=torch.int64))
            a = torch.zeros((128, plan.kp))
            a[:, :k] = torch.where(ok, halo[idx], torch.zeros(()))
            # a thread holds rows r and r + 8 of a 16-row group; where both
            # windows lie inside the image it reads without checks, the
            # columns past K at the window's corner (times the weight's
            # zero rows)
            inside = (live & (ih >= 0) & (ih + kh <= h) & (iw >= 0)
                      & (iw + kw <= w))
            inside = inside & inside[torch.arange(128) ^ 8]
            a[inside, :k] = halo[hb[inside][:, None] + off]
            a[inside, k:] = halo[hb[inside]][:, None]
            assert torch.isfinite(a).all(), "a read outside the spans"
            y[m[live]] = (a @ weff)[live]
            count[m[live]] += 1
    if stored is not None:
        stored.append(count)
    return y.reshape(n, ho, wo, cout)


def _jax_conv(x, wt, own, pm, task, mode, stride, pads):
    padding = ((pads[0], pads[1]), (pads[2], pads[3]))
    y = jax.jit(lambda x, w, pm: j_masked_conv2d(
        x, w, jnp.asarray(own.numpy()), pm, task, stride=stride,
        padding=padding, threshold=THR, mask_mode=mode))(
            *(jnp.asarray(a.numpy()) for a in (x, wt, pm)))
    return np.asarray(y)


STEM_CASES = [
    # (n, H, W, k, stride, padding, Cout): a 7x7/2 stem with pad 3 (12x12
    # outputs, 144 an image: tiles start mid-row and cross images), a 3x3/2
    # stem with pad 1 (13x12), 3x3/1 SAME (12x16; 16x16 with two channel
    # blocks), the last tile ragged
    (3, 24, 24, 7, 2, ((3, 3), (3, 3)), 64),
    (2, 26, 24, 3, 2, 1, 64),
    (3, 12, 16, 3, 1, "SAME", 64),
    (2, 16, 16, 3, 1, "SAME", 128),
]


@pytest.mark.parametrize("task", [1, 2, 3])
@pytest.mark.parametrize("mode", ["binary", "ternary"])
@pytest.mark.parametrize("case", STEM_CASES)
def test_stem_walk_is_the_masked_conv(case, mode, task):
    n, h, w, k, stride, pad, cout = case
    x, wt, own, pm = _case(n, h, w, k, stride, pad, cout, seed=h + 7 * k)
    assert mc.stem_route(x.bfloat16(), wt, stride, pad)
    stored = []
    got = _replay(x, wt, own, pm, task, mode, stride, pad, stored=stored)
    assert bool((stored[0] == 1).all())
    pads = resolve_padding(pad, h, w, k, k, stride)
    want = mc.masked_conv2d_plain(x, wt, own, pm, task, stride, pad,
                                  threshold=THR, mask_mode=mode)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(),
                               _jax_conv(x, wt, own, pm, task, mode, stride,
                                         pads), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sms", [1, 2, 132])
def test_stem_walk_at_any_grid_stores_every_pixel_once(sms):
    """One block walking every tile, two, and more blocks than tiles (the
    grid cut to the tile count): each output pixel stored once, the same
    values."""
    n, h, w, k, stride, pad, cout = STEM_CASES[0]
    x, wt, own, pm = _case(n, h, w, k, stride, pad, cout, seed=5)
    stored = []
    got = _replay(x, wt, own, pm, 2, "binary", stride, pad, sms, stored)
    assert bool((stored[0] == 1).all())
    want = _replay(x, wt, own, pm, 2, "binary", stride, pad)
    assert torch.equal(got, want)


def test_stem_walk_reads_only_its_spans():
    """The replay's NaN halo catches a walk that reads past what its spans
    load: with every tile's first span one row short, some patch reads a
    row that was never filled."""
    n, h, w, k, stride, pad, cout = STEM_CASES[1]
    x, wt, own, pm = _case(n, h, w, k, stride, pad, cout, seed=6)
    real = mc.stem_spans

    def short(*args):
        a, b = real(*args)
        return (a[0], a[1], a[2] - 1), b

    mc.stem_spans = short
    try:
        with pytest.raises(AssertionError, match="outside the spans"):
            _replay(x, wt, own, pm, 2, "binary", stride, pad)
    finally:
        mc.stem_spans = real
