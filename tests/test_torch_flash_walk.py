"""K7's one-launch backward, replayed in plain PyTorch on the CPU.

On the card, `flash_bwd` on `bwd_route` shapes (bf16, hd 32 or 64, T <=
256) runs
`csrc/flash_bwd_wgmma.cu`: a consumer warpgroup owns a slot of 64 keys and
walks the 64-query tiles in order, each tile a TMA box with zeros past T.
For each tile it forms D = rowsum(dO o), S^T = K Q^T and dP^T = V dO^T,
then P^T = exp(S^T / sqrt(hd) - lse) and dS^T = P^T (dP^T - D) / sqrt(hd)
with masked
entries (keys or queries past T, keys after the query when causal) zero,
rounds P^T and dS^T to dO's dtype, adds P^T dO to dV and dS^T Q to dK, and
forms its slot's part of the tile's dQ = dS K (a slot past T is TMA's
zeros, its dS^T masked: it adds exact zeros). `bwd_plan`'s PAIR walk (T <=
64) gives each warpgroup a whole (image, head); its BLOCK walk gives a block
one (image, head) whose keys it walks in 128-key blocks (two slots), in
order: dq = (earlier key blocks) + (slot 0 + slot 1).

`_replay` walks the plan so. In f32 the rounding is a no-op and inputs are
bf16 values held in f32, so the replay, `flash_mha_bwd_plain` and
`cpg_tpu`'s `flash_mha` VJP (the stock Pallas kernel jitted in interpret
mode, as the JAX tests run it) differ only in summation order: rtol = atol =
1e-5. In bf16 the replay is held against the plain version at the card
tests' max|diff| <= 2e-2 * max|ref| (p and ds rounded in 64-query tiles
against whole rows).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cpg_tpu.ops.flash import flash_mha as j_flash_mha
from cpg_tpu_torch.ops import flash as fl

TOL = 1e-5
SMS = 7  # a small card: several items a block


def _inputs(n, t, h, seed, dtype=torch.float32, hd=64):
    """q, k, v, dO (N, T, H, hd): bf16 values, held in `dtype`."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(n, t, h, hd).astype(np.float32))
            .to(torch.bfloat16).to(dtype) for _ in range(4)]


def _tile(x, img, head, row0, rows=64):
    """The TMA box of rows row0 .. row0 + rows of one (image, head) in f32,
    zeros past T."""
    out = torch.zeros((rows, x.shape[3]))
    part = x[img, row0:row0 + rows, head].float()
    out[:part.shape[0]] = part
    return out


def _replay(q, k, v, o, lse, do, causal, sms=SMS, visits=None):
    """(dq, dk, dv) in f32 by the kernel's walk; `visits` collects (image,
    head, key block, query tile, slot)."""
    n, t, h, hd = q.shape
    plan = fl.bwd_plan(n, t, h, hd, sms)
    scale = 1.0 / np.sqrt(hd)
    rd = lambda x: x.to(do.dtype).float()  # the kernel's casts of p and ds
    dq, dk, dv = (torch.zeros((n, t, h, hd)) for _ in range(3))
    for block in range(plan.grid):
        for it in range(block, plan.items, plan.grid):
            heads = [2 * it, 2 * it + 1] if plan.pair else [it]
            for item in (i for i in heads if i < n * h):
                img, head = divmod(item, h)
                lrow = lse[img, head].float()
                carried = {}  # query tile -> the f32 dQ of earlier key blocks
                for kb in range(plan.n_kb):
                    # the warpgroups' keys: PAIR one slot, BLOCK two
                    slots = [kb * 128 + 64 * s
                             for s in range(1 if plan.pair else 2)]
                    ks = {s0: _tile(k, img, head, s0) for s0 in slots}
                    vs = {s0: _tile(v, img, head, s0) for s0 in slots}
                    dks = {s0: torch.zeros((64, hd)) for s0 in slots}
                    dvs = {s0: torch.zeros((64, hd)) for s0 in slots}
                    for qt in range(plan.n_qt):
                        q0 = 64 * qt
                        qs, dos, os_ = (_tile(x, img, head, q0)
                                        for x in (q, do, o))
                        d = (dos * os_).sum(-1)
                        qi = torch.arange(q0, q0 + 64)
                        l_q = torch.zeros(64)
                        l_q[:max(0, min(64, t - q0))] = lrow[q0:q0 + 64]
                        dsts = []
                        for s0 in slots:
                            if visits is not None and s0 < t:
                                visits.append((img, head, kb, qt, s0))
                            kj = torch.arange(s0, s0 + 64)[:, None]
                            mask = (kj < t) & (qi[None, :] < t)
                            if causal:
                                mask &= kj <= qi[None, :]
                            st = ks[s0] @ qs.T
                            dpt = vs[s0] @ dos.T
                            pt = torch.where(mask, torch.exp(st * scale - l_q),
                                             torch.zeros(()))
                            dst = torch.where(mask, pt * (dpt - d) * scale,
                                              torch.zeros(()))
                            dvs[s0] += rd(pt) @ dos
                            dks[s0] += rd(dst) @ qs
                            dsts.append(rd(dst))
                        # each slot's dQ, slot 0 + slot 1, added to the
                        # earlier key blocks' tile
                        part = dsts[0].T @ ks[slots[0]]
                        for dst, s0 in zip(dsts[1:], slots[1:]):
                            part = part + dst.T @ ks[s0]
                        carried[qt] = carried[qt] + part if kb else part
                        if kb + 1 == plan.n_kb:
                            rows = min(64, t - q0)
                            dq[img, q0:q0 + rows, head] = carried[qt][:rows]
                    for s0 in (s0 for s0 in slots if s0 < t):
                        rows = min(64, t - s0)
                        dk[img, s0:s0 + rows, head] = dks[s0][:rows]
                        dv[img, s0:s0 + rows, head] = dvs[s0][:rows]
    return dq, dk, dv


WALK_CASES = [(3, 64, 3, False), (2, 70, 2, True), (2, 70, 2, False),
              (1, 130, 2, True), (1, 196, 2, False)]


def _check_walk(n, t, h, causal, hd):
    """The replay against flash_mha_bwd_plain (same o, lse) and against
    cpg_tpu's flash_mha VJP (its own forward), f32, rtol = atol = 1e-5."""
    q, k, v, do = _inputs(n, t, h, seed=t, hd=hd)
    assert fl.bwd_route(q.bfloat16())
    o, lse = fl.flash_mha_plain(q, k, v, causal)
    got = _replay(q, k, v, o, lse, do, causal)
    for g, w, name in zip(got, fl.flash_mha_bwd_plain(q, k, v, o, lse, do,
                                                      causal), "qkv"):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"d{name} vs plain")

    def vjp(q, k, v, g):
        _, f = jax.vjp(functools.partial(j_flash_mha, causal=causal), q, k, v)
        return f(g)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(vjp)(*(jnp.asarray(a.numpy()) for a in (q, k, v, do)))
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"d{name} vs cpg_tpu")


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_matches_plain_and_jax(case):
    """hd 64: vit_cifar's T = 64, the causal T = 70, one and two key
    blocks."""
    _check_walk(*case, hd=64)


@pytest.mark.parametrize("case", [(3, 64, 3, True), (2, 70, 2, True),
                                  (2, 70, 2, False), (1, 130, 2, True)])
def test_walk_at_hd_32_matches_plain_and_jax(case):
    """hd 32 (textcls's head dim): its causal T = 64 (the PAIR walk), T =
    70 and two key blocks at T = 130; the scale 1/sqrt(32)."""
    _check_walk(*case, hd=32)


@pytest.mark.parametrize("case", [(5, 64, 3, False, 64), (2, 196, 2, True, 64),
                                  (5, 64, 3, True, 32)])
def test_walk_in_bf16_matches_plain(case):
    """With bf16 inputs the replay rounds P^T and dS^T where the kernel
    does; against flash_mha_bwd_plain at max|diff| <= 2e-2 * max|ref|."""
    n, t, h, causal, hd = case
    q, k, v, do = _inputs(n, t, h, seed=t + 1, dtype=torch.bfloat16, hd=hd)
    o, lse = fl.flash_mha_plain(q, k, v, causal)
    got = _replay(q, k, v, o, lse, do, causal)
    for g, w in zip(got, fl.flash_mha_bwd_plain(q, k, v, o, lse, do, causal)):
        err = (g.to(torch.bfloat16).float() - w.float()).abs().max().item()
        assert err <= 2e-2 * w.float().abs().max().item()


@pytest.mark.parametrize("t", [1, 64, 65, 128, 129, 193, 256])
def test_walk_visits_every_key_once_a_query_tile(t):
    """Over the plan's blocks and items, every (image, head) has each of
    its slots that hold keys visited once a query tile, in key-block
    order."""
    n, h = 3, 3
    visits = []
    q, k, v, do = _inputs(n, t, h, seed=0)
    o, lse = fl.flash_mha_plain(q, k, v)
    _replay(q, k, v, o, lse, do, False, visits=visits)
    plan = fl.bwd_plan(n, t, h, 64, SMS)
    slots = [s0 for s0 in range(0, 64 if plan.pair else 128 * plan.n_kb, 64)
             if s0 < t]
    want = sorted((img, head, s0 // 128, qt, s0)
                  for img in range(n) for head in range(h)
                  for qt in range(plan.n_qt) for s0 in slots)
    assert sorted(visits) == want and len(set(visits)) == len(visits)
    for img in range(n):
        for head in range(h):
            kbs = [kb for i, hh, kb, _, _ in visits if (i, hh) == (img, head)]
            assert kbs == sorted(kbs)
