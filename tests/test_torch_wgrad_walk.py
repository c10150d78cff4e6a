"""The weight-gradient GEMM (K3), replayed in plain PyTorch on the CPU.

On the card K3 runs `csrc/masked_matmul_wgrad.cu`: output tiles of 128
k-rows x BN columns, the reduction over pixels split into `splits` runs of
whole steps (64 rows of a dense product, one 128-pixel box of a conv), one
item (tile, split) at a time on a persistent grid. Each step loads A, two
64-wide boxes of x (dense: rows of x (M, Kx); conv: one 4-D TMA box of the
NHWC input per half, at the tap's offset, zeros wherever the box leaves the
tensor), and B, BN / 64 boxes of g's rows, and adds A^T B to the item's f32
sums. With one split the epilogue gates the sums; with more, every split
writes its partial tile as its block finishes, and the fix-up, a gate pass
after the GEMM, sums each tile's partials in split order z = 0 .. S-1 and
gates. conv0 and the stems (Cin = 3) are the dense walk over their
patches, written by an im2col kernel with K = 27 padded to 32 columns
(ResNet-50's 7x7 stem: 147 to 152, three 64-column boxes over two k
tiles); a 1x1 conv at stride 1 the dense walk over x and g as matrices.
WGRAD_IM2COL, every other conv with Cin and Cout multiples of 64 at any
grid and stride 1 or 2, loads each 64-row half of A by one TMA im2col
load of 128 consecutive output pixels (`tests/test_torch_conv_routes.py`'s
`_im2col_tile` emulates it) at the tap's offsets.

`_replay` walks `masked_matmul.wgrad_plan`'s items exactly so, the blocks
finishing in a given order. Inputs are bf16 values held in f32, so every
product is exact and the replay, the plain versions
(`masked_matmul_bwd_dw_plain`, `masked_conv2d_bwd_dw_plain`) and `cpg_tpu`'s `masked_matmul` /
`masked_conv2d` custom VJPs (Pallas in interpret mode, as the JAX tests run
it) differ only in summation order: rtol = atol = 1e-5 (sums of at most
600 products of terms of size ~0.1). Shuffled arrival orders must give
equal bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.ops.pallas.masked_conv import masked_conv2d as j_masked_conv2d
from cpg_tpu.ops.pallas.masked_matmul import masked_matmul as j_masked_matmul
from cpg_tpu_torch.ops import masked_conv as mc
from cpg_tpu_torch.ops import masked_matmul as mm
from cpg_tpu_torch.ops.conv import out_size, resolve_padding
from tests.test_torch_conv_routes import _im2col_tile

TOL = 1e-5
BK = mm.WGRAD_BK


def _bf16_values(a):
    """a rounded to bf16, held in f32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _block(t, r0, c0, rows, cols):
    """t[r0:r0 + rows, c0:c0 + cols], zero past t's edges (a TMA box)."""
    out = torch.zeros((rows, cols), dtype=t.dtype)
    part = t[r0:r0 + rows, c0:c0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _box(a, coords, box):
    """TMA's tiled box of the NHWC tensor a at coordinates (c, w, h, n),
    innermost first: a (box pixels, 64) matrix with zeros wherever the box
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


class _Walk:
    """The items of one plan: tiles, splits and each item's steps."""

    def __init__(self, m, k, n, rows, plan):
        self.bn, self.splits, _, self.grid = plan
        self.rows, self.k, self.n = rows, k, n
        self.steps = -(-m // rows)
        self.per = -(-self.steps // self.splits)
        self.tiles_k = -(-k // BK)
        self.tiles = self.tiles_k * -(-n // self.bn)

    def item(self, it):
        t, z = it % self.tiles, it // self.tiles
        k0, n0 = (t % self.tiles_k) * BK, (t // self.tiles_k) * self.bn
        return t, z, k0, n0, range(z * self.per,
                                   min((z + 1) * self.per, self.steps))

    def arrivals(self, rng=None):
        """Items in the order their blocks finish: block b walks b, b +
        grid, ...; rounds in order, blocks within a round in the given
        shuffle (or in block order)."""
        items = self.tiles * self.splits
        order = []
        for r in range(-(-items // self.grid)):
            rnd = [it for it in range(r * self.grid, min((r + 1) * self.grid,
                                                         items))]
            if rng is not None:
                rng.shuffle(rnd)
            order += rnd
        return order


def _partials(walk, a_tile, g2d):
    """Each item's f32 sums over its steps: {item: (128, bn)}; a_tile(m0,
    k0) is the step's A (rows, 128), g's B box the rows at m0."""
    out = {}
    for it in range(walk.tiles * walk.splits):
        _, _, k0, n0, steps = walk.item(it)
        acc = torch.zeros((BK, walk.bn))
        for st in steps:
            m0 = st * walk.rows
            acc += a_tile(m0, k0).t() @ _block(g2d, m0, n0, walk.rows, walk.bn)
        out[it] = acc
    return out


def _gate(walk, sums, w, own, task):
    """dw, dpm (k, n) from each tile's sums, clipped at k and n."""
    dw = torch.full((walk.k, walk.n), float("nan"))
    dpm = dw.clone()
    for t, G in sums.items():
        _, _, k0, n0, _ = walk.item(t)
        G = G[:walk.k - k0, :walk.n - n0]
        rs, cs = slice(k0, k0 + G.shape[0]), slice(n0, n0 + G.shape[1])
        o, wt = own[rs, cs], w[rs, cs]
        dw[rs, cs] = torch.where(o == task, G, torch.zeros(()))
        dpm[rs, cs] = torch.where((o > 0) & (o < task), G * wt, torch.zeros(()))
    return dw, dpm


def _write(walk, parts, order):
    """The scratch after the blocks write their partials in `order`."""
    ws = {}
    for it in order:
        ws[it] = parts[it]
    return ws


def _fixup(walk, ws):
    """The gate pass's sums: each tile's partials in split order."""
    if walk.splits == 1:  # no gate pass: the GEMM's epilogue gates
        return {t: ws[t] for t in range(walk.tiles)}
    sums = {}
    for t in range(walk.tiles):
        v = torch.zeros_like(ws[t])
        for z in range(walk.splits):
            v = v + ws[z * walk.tiles + t]
        sums[t] = v
    return sums


def _replay(walk, a_tile, g2d, w, own, task, rng=None):
    parts = _partials(walk, a_tile, g2d)
    sums = _fixup(walk, _write(walk, parts, walk.arrivals(rng)))
    return _gate(walk, sums, w, own, task)


def _dense_a(x, rows):
    return lambda m0, k0: _block(x, m0, k0, rows, BK)


def _conv_a(x, ho, wo, pad_top, pad_left, box):
    """A of a conv step: per 64-row half of the k tile, the tap's box."""
    cin, kx = x.shape[3], 9 * x.shape[3]

    def tile(m0, k0):
        img, rem = divmod(m0, ho * wo)
        oh0, ow0 = divmod(rem, wo)
        halves = []
        for h in range(2):
            kb = k0 // 64 + h
            if kb * 64 >= kx:  # not loaded: rows past K, never stored
                halves.append(torch.zeros((128, 64)))
                continue
            tap, c0 = divmod(kb, cin // 64)
            halves.append(_box(x, (c0 * 64, ow0 + tap % 3 - pad_left,
                                   oh0 + tap // 3 - pad_top, img), box))
        return torch.cat(halves, 1)
    return tile


def _weights(k, n, rng):
    w = (rng.randn(k, n) * 0.3).astype(np.float32)
    own = rng.choice([0, 1, 2, 3], size=(k, n)).astype(np.int8)
    pm = (rng.randn(k, n) * 0.01).astype(np.float32)
    return w, own, pm


def _jax_dense_grads(x, w, own, pm, g):
    @jax.jit
    def run(x, w, pm, g):
        _, vjp = jax.vjp(lambda w_, pm_: j_masked_matmul(
            x, w_, jnp.asarray(own), pm_, 2), w, pm)
        return vjp(g)
    return tuple(np.asarray(a) for a in run(*(jnp.asarray(a)
                                               for a in (x, w, pm, g))))


def _jax_conv_grads(x, w, own, pm, g, stride=1, padding="SAME"):
    @jax.jit
    def run(x, w, pm, g):
        _, vjp = jax.vjp(lambda w_, pm_: j_masked_conv2d(
            x, w_, jnp.asarray(own), pm_, 2, stride=stride, padding=padding),
            w, pm)
        return vjp(g)
    return tuple(np.asarray(a) for a in run(*(jnp.asarray(a)
                                               for a in (x, w, pm, g))))


def _assert_close(got, wants):
    for want in wants:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", [
    # (m, k, n, plan or None for wgrad_plan at 132 SMs): ragged M, K and N;
    # one and several splits, a grid that walks several rounds, BN 64 and
    # 128
    (300, 200, 72, None),
    (300, 200, 72, (64, 3, 6, 5)),
    (600, 256, 136, (128, 4, 6, 3)),
    (600, 136, 256, (128, 2, 6, 2)),
    (64, 8, 8, (64, 1, 6, 1)),
])
def test_dense_walk_is_the_masked_matmul_weight_gradient(case):
    m, k, n, plan = case
    rng = np.random.RandomState(m + k)
    x = _bf16_values(rng.randn(m, k).astype(np.float32))
    g = _bf16_values((rng.randn(m, n) * 0.1).astype(np.float32))
    w, own, pm = _weights(k, n, rng)
    tx, tg, tw, town = (torch.from_numpy(a) for a in (x, g, w, own))
    walk = _Walk(m, k, n, mm.WGRAD_DENSE_ROWS,
                 plan or mm.wgrad_plan(m, k, n, 132))
    dw, dpm = _replay(walk, _dense_a(tx, walk.rows), tg, tw, town, 2)
    pdw, pdpm = mm.masked_matmul_bwd_dw_plain(tg, tx, tw, town, 2)
    jdw, jdpm = _jax_dense_grads(x, w, own, pm, g)
    _assert_close(dw, (pdw, jdw))
    _assert_close(dpm, (pdpm, jdpm))


@pytest.mark.parametrize("case", [
    # (N, H = W, plan or None): 8x8 grids (two images a box, the second
    # box's last image past N) and 4x4 (eight a box); K = 576 = 4.5 k tiles,
    # so the last tile's second half spans no tap
    (3, 8, None), (3, 8, (64, 2, 3, 4)), (9, 4, (64, 2, 3, 132)),
    (2, 4, (128, 1, 3, 7)),
])
def test_conv_walk_is_the_masked_conv_weight_gradient(case):
    """Cin = Cout = 64 on `conv_route`: with Cin = 64 a 128-row k tile
    spans two taps, each half read as its own box."""
    n, hw, plan = case
    rng = np.random.RandomState(n * hw)
    x = _bf16_values(rng.randn(n, hw, hw, 64).astype(np.float32))
    g = _bf16_values((rng.randn(n, hw, hw, 64) * 0.1).astype(np.float32))
    w, own, pm = (a.reshape(3, 3, 64, 64) for a in _weights(576, 64, rng))
    tx, tg, tw, town = (torch.from_numpy(a) for a in (x, g, w, own))
    assert mc.conv_route(tx.bfloat16(), tw, 1, "SAME")
    box, *rest = mm.wgrad_conv_plan(n, hw, hw, 64, 64, 9, 132)
    walk = _Walk(n * hw * hw, 576, 64, mm.WGRAD_CONV_ROWS, plan or rest)
    pt, _, pl, _ = resolve_padding("SAME", hw, hw, 3, 3, 1)
    dw, dpm = _replay(walk, _conv_a(tx, hw, hw, pt, pl, box),
                      tg.reshape(-1, 64), tw.reshape(576, 64),
                      town.reshape(576, 64), 2)
    pdw, pdpm = mc.masked_conv2d_bwd_dw_plain(tg, tx, tw, town, 2)
    jdw, jdpm = _jax_conv_grads(x, w, own, pm, g)
    _assert_close(dw.reshape(w.shape), (pdw, jdw))
    _assert_close(dpm.reshape(w.shape), (pdpm, jdpm))


@pytest.mark.parametrize("case", [
    # (N, H = W, Cin, Cout, stride): VGG16-BN's conv0 (K = 27 -> 32
    # columns) and a ragged stride-2 conv (K = 45 -> 48)
    (2, 8, 3, 64, 1), (2, 7, 5, 72, 2),
])
def test_conv0_im2col_walk_is_the_masked_conv_weight_gradient(case):
    n, hw, cin, cout, stride = case
    rng = np.random.RandomState(cin)
    x = _bf16_values(rng.randn(n, hw, hw, cin).astype(np.float32))
    ho = -(-hw // stride)
    g = _bf16_values((rng.randn(n, ho, ho, cout) * 0.1).astype(np.float32))
    k = 9 * cin
    w, own, pm = (a.reshape(3, 3, cin, cout) for a in _weights(k, cout, rng))
    tx, tg, tw, town = (torch.from_numpy(a) for a in (x, g, w, own))
    assert mc.im2col_route(tx.bfloat16(), tw)
    assert not mc.conv_route(tx.bfloat16(), tw, stride, "SAME")
    pads = resolve_padding("SAME", hw, hw, 3, 3, stride)
    kp = -(-k // 8) * 8
    patches = mm.im2col_plain(tx, 3, 3, stride, pads, kp)
    assert patches.shape == (n * ho * ho, kp) and not patches[:, k:].any()
    m = patches.shape[0]
    walk = _Walk(m, k, cout, mm.WGRAD_DENSE_ROWS, mm.wgrad_plan(m, k, cout, 132))
    dw, dpm = _replay(walk, _dense_a(patches, walk.rows), tg.reshape(-1, cout),
                      tw.reshape(k, cout), town.reshape(k, cout), 2)
    pdw, pdpm = mc.masked_conv2d_bwd_dw_plain(tg, tx, tw, town, 2, stride)
    jdw, jdpm = _jax_conv_grads(x, w, own, pm, g, stride)
    _assert_close(dw.reshape(w.shape), (pdw, jdw))
    _assert_close(dpm.reshape(w.shape), (pdpm, jdpm))


def test_im2col_plain_columns_are_the_taps_in_hwio_order():
    """Column (dh*3 + dw)*C + c of pixel (i, j) is x at (i + dh - 1, j +
    dw - 1, c), zero outside, for the HWIO kernel's (K, Cout) view."""
    x = torch.arange(1 * 4 * 4 * 3, dtype=torch.float32).reshape(1, 4, 4, 3)
    p = mm.im2col_plain(x, 3, 3, 1, (1, 1, 1, 1), 32).reshape(4, 4, 32)
    assert torch.equal(p[0, 0, :3], torch.zeros(3))           # (-1, -1)
    assert torch.equal(p[1, 2, 4 * 3:5 * 3], x[0, 1, 2])       # centre tap
    assert torch.equal(p[1, 2, 8 * 3:9 * 3], x[0, 2, 3])       # (+1, +1)
    assert not p[..., 27:].any()


def test_fixup_gives_equal_bits_in_any_arrival_order():
    """The blocks write their partials in whatever order they finish; the
    fix-up sums each tile's partials in split order, so shuffled arrivals
    give equal bits. Summing in arrival order would not (checked: the data
    are not exact in f32)."""
    m, k, n = 1280, 256, 128
    rng = np.random.RandomState(7)
    x = torch.from_numpy(_bf16_values(rng.randn(m, k).astype(np.float32)))
    g = torch.from_numpy(_bf16_values(rng.randn(m, n).astype(np.float32)))
    walk = _Walk(m, k, n, mm.WGRAD_DENSE_ROWS, (128, 10, 6, 7))
    parts = _partials(walk, _dense_a(x, walk.rows), g)
    ref = _fixup(walk, _write(walk, parts, walk.arrivals()))
    shuffle = np.random.RandomState(0)
    by_arrival = []
    for _ in range(4):
        order = walk.arrivals(shuffle)
        got = _fixup(walk, _write(walk, parts, order))
        assert all(torch.equal(got[t], ref[t]) for t in range(walk.tiles))
        first = [it for it in order if it % walk.tiles == 0]
        v = torch.zeros_like(parts[0])
        for it in first:
            v = v + parts[it]
        by_arrival.append(v)
    assert any(not torch.equal(v, ref[0]) for v in by_arrival)


def _im2col_a(x, kh, kw, stride, pads):
    """A of a WGRAD_IM2COL step: per 64-row half of the k tile, (tap,
    channel block) = (kb / cblocks, kb % cblocks) and one im2col load of the
    128 output pixels from m0 on, through the forward's map: lower corner
    (-pad_left, -pad_top), base coordinate the corner plus (ow0, oh0) times
    the stride, offsets the tap's (dw, dh). Halves past K are not loaded."""
    n, h, wd, cin = x.shape
    pt, pb, pl, pr = pads
    ho, wo = out_size(h, kh, stride, pt, pb), out_size(wd, kw, stride, pl, pr)
    lower = (-pl, -pt)
    upper = (-pl + (wo - 1) * stride - (wd - 1),
             -pt + (ho - 1) * stride - (h - 1))
    cblocks, kx = cin // 64, kh * kw * cin

    def tile(m0, k0):
        img, rem = divmod(m0, ho * wo)
        oh0, ow0 = divmod(rem, wo)
        base = (lower[0] + ow0 * stride, lower[1] + oh0 * stride)
        halves = []
        for half in range(2):
            kb = k0 // 64 + half
            if kb * 64 >= kx:  # not loaded: rows past K, never stored
                halves.append(torch.zeros((128, 64)))
                continue
            tap, cb = divmod(kb, cblocks)
            halves.append(_im2col_tile(x, cb * 64, base, img, lower, upper,
                                       stride, (tap % kw, tap // kw)))
        return torch.cat(halves, 1)
    return tile


def _conv_case(n, h, w, k, cin, cout, stride, pad, seed):
    """Inputs of one conv as bf16 values in f32: x, g, w, own, pm and the
    forward's pads."""
    rng = np.random.RandomState(seed)
    pads = resolve_padding(pad, h, w, k, k, stride)
    ho, wo = out_size(h, k, stride, *pads[:2]), out_size(w, k, stride, *pads[2:])
    x = _bf16_values(rng.randn(n, h, w, cin).astype(np.float32))
    g = _bf16_values((rng.randn(n, ho, wo, cout) * 0.1).astype(np.float32))
    wt, own, pm = (a.reshape(k, k, cin, cout)
                   for a in _weights(k * k * cin, cout, rng))
    return x, g, wt, own, pm, pads


def _check_conv_walk(x, g, wt, own, pm, pads, stride, pad, walk, a_tile):
    """The replay's dw and dpm against the plain version and cpg_tpu's VJP."""
    k, cin, cout = wt.shape[0], wt.shape[2], wt.shape[3]
    tx, tg, tw, town = (torch.from_numpy(a) for a in (x, g, wt, own))
    dw, dpm = _replay(walk, a_tile, tg.reshape(-1, cout),
                      tw.reshape(-1, cout), town.reshape(-1, cout), 2)
    pdw, pdpm = mc.masked_conv2d_bwd_dw_plain(tg, tx, tw, town, 2, stride, pad)
    jpad = pad if isinstance(pad, str) else ((pads[0], pads[1]),
                                             (pads[2], pads[3]))
    jdw, jdpm = _jax_conv_grads(x, wt, own, pm, g, stride, jpad)
    _assert_close(dw.reshape(wt.shape), (pdw, jdw))
    _assert_close(dpm.reshape(wt.shape), (pdpm, jdpm))
    return dw, dpm


@pytest.mark.parametrize("case", [
    # (n, H, W, k, stride, padding, Cin, Cout, plan or None): 3x3/1 at odd
    # grids (M = 84 and 140: one step, two with a ragged second); 3x3/2 pad
    # 1 on even and odd inputs, SAME on mixed sides; 1x1/2; Cin and Cout 64
    # and 128; one split and several, a grid of fewer blocks than items
    (2, 7, 6, 3, 1, "SAME", 64, 64, None),
    (4, 5, 7, 3, 1, "SAME", 128, 128, None),
    (4, 5, 7, 3, 1, "SAME", 128, 128, (64, 2, 6, 3)),
    (3, 8, 6, 3, 2, 1, 64, 128, None),
    (5, 7, 5, 3, 2, 1, 128, 64, (128, 3, 6, 2)),
    (2, 9, 8, 3, 2, "SAME", 64, 64, None),
    (6, 8, 6, 1, 2, "SAME", 64, 64, None),
    (3, 7, 5, 1, 2, "SAME", 128, 128, (64, 2, 6, 1)),
], ids=["3x3s1_7x6", "3x3s1_5x7", "3x3s1_5x7_split", "3x3s2_even",
        "3x3s2_odd_split", "3x3s2_same_mixed", "1x1s2_even", "1x1s2_odd_split"])
def test_im2col_walk_is_the_masked_conv_weight_gradient(case):
    """WGRAD_IM2COL off the boxes (`wgrad_conv_route` "im2col"), replayed
    as the producer walks it, against the plain version and cpg_tpu's
    VJP."""
    n, h, w, k, stride, pad, cin, cout, plan = case
    x, g, wt, own, pm, pads = _conv_case(n, h, w, k, cin, cout, stride, pad,
                                         seed=n * h + w + k)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(wt)
    assert mc.wgrad_conv_route(tx, tw, stride, pad) == "im2col"
    m = g.shape[0] * g.shape[1] * g.shape[2]
    walk = _Walk(m, k * k * cin, cout, mm.WGRAD_CONV_ROWS,
                 plan or mm.wgrad_plan(m, k * k * cin, cout, 132,
                                       mm.WGRAD_CONV_ROWS))
    _check_conv_walk(x, g, wt, own, pm, pads, stride, pad, walk,
                     _im2col_a(torch.from_numpy(x), k, k, stride, pads))


def test_im2col_walk_gives_equal_bits_in_any_arrival_order():
    """Several splits over a few blocks: the gate pass's split order makes
    shuffled finish orders give equal bits."""
    x, g, wt, own, _, pads = _conv_case(5, 7, 5, 3, 128, 64, 2, 1, seed=11)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g).reshape(-1, 64)
    walk = _Walk(tg.shape[0], 9 * 128, 64, mm.WGRAD_CONV_ROWS, (64, 3, 6, 4))
    tw, town = torch.from_numpy(wt).reshape(-1, 64), torch.from_numpy(own).reshape(-1, 64)
    parts = _partials(walk, _im2col_a(tx, 3, 3, 2, pads), tg)
    ref = _gate(walk, _fixup(walk, _write(walk, parts, walk.arrivals())),
                tw, town, 2)
    shuffle = np.random.RandomState(1)
    for _ in range(3):
        got = _gate(walk, _fixup(walk, _write(walk, parts,
                                              walk.arrivals(shuffle))),
                    tw, town, 2)
        assert all(torch.equal(u, v) for u, v in zip(got, ref))


@pytest.mark.parametrize("case", [
    # (n, H, W, Cin, Cout, plan or None): M = 60 and 300 (ragged), Cin 64
    # and 128, Cout 64 and 128
    (2, 5, 6, 64, 128, None), (3, 10, 10, 128, 64, (64, 2, 6, 3)),
])
def test_1x1_dense_walk_over_x_as_a_matrix(case):
    """A 1x1 conv at stride 1 (`wgrad_conv_route` "dense"): the dense walk
    over x viewed as (N*H*W, Cin) and g as (N*H*W, Cout), nothing copied."""
    n, h, w, cin, cout, plan = case
    x, g, wt, own, pm, pads = _conv_case(n, h, w, 1, cin, cout, 1, "SAME",
                                         seed=cin + h)
    tx = torch.from_numpy(x)
    assert mc.wgrad_conv_route(tx.bfloat16(), torch.from_numpy(wt), 1,
                               "SAME") == "dense"
    m = n * h * w
    walk = _Walk(m, cin, cout, mm.WGRAD_DENSE_ROWS,
                 plan or mm.wgrad_plan(m, cin, cout, 132))
    _check_conv_walk(x, g, wt, own, pm, pads, 1, "SAME", walk,
                     _dense_a(tx.reshape(m, cin), walk.rows))


def test_7x7_stem_patches_take_152_columns_on_the_dense_walk():
    """ResNet-50's 7x7/2 stem (pad 3, Cin 3): K = 147 patches padded to 152
    columns; the dense walk's two k tiles load three 64-column boxes (the
    third zero-filled past column 152; the fourth, past Kx, not loaded)."""
    x, g, wt, own, pm, pads = _conv_case(2, 11, 9, 7, 3, 64, 2,
                                         ((3, 3), (3, 3)), seed=147)
    tx = torch.from_numpy(x)
    assert mc.wgrad_conv_route(tx.bfloat16(), torch.from_numpy(wt), 2,
                               ((3, 3), (3, 3))) == "patches"
    patches = mm.im2col_plain(tx, 7, 7, 2, pads, 152)
    m = patches.shape[0]
    assert patches.shape == (m, 152) and not patches[:, 147:].any()
    walk = _Walk(m, 147, 64, mm.WGRAD_DENSE_ROWS, mm.wgrad_plan(m, 147, 64, 132))
    assert walk.tiles_k == 2

    def a_tile(m0, k0):  # boxes that start at or past Kx are not loaded
        return torch.cat([_block(patches, m0, k0 + 64 * h, walk.rows, 64)
                          if k0 + 64 * h < 152 else
                          torch.zeros((walk.rows, 64)) for h in range(2)], 1)
    _check_conv_walk(x, g, wt, own, pm, pads, 2, ((3, 3), (3, 3)), walk,
                     a_tile)
