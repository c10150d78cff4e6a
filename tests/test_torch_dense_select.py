"""The dense masked matmul's select pass and TN GEMM, their plain versions
on the CPU.

`masked_matmul_select_plain` is what the select kernel
(`csrc/masked_matmul.cu`) is held against on the card, bit for bit; here it
is held against `cpg_tpu`'s `_mask_tile` (`ops/pallas/masked_matmul.py`),
the select inside the TPU kernels' weight tiles, bit for bit in bf16: f32
select, then one rounding to the activation dtype. Binary and ternary mode,
task ids 1-3 (task 1 has no prior entries), both layouts the GEMM takes
(w_eff for dx, w_eff^T for the forward). The inputs put piggymask entries
exactly on the threshold and at 0, so the strict comparisons are tested.

`gemm_tn_plain` (C = A @ Bt^T, f32 sums, bf16 out) is held against numpy,
and the route the two compose, select + GEMM, against the dense route's
plain forward and dx at bf16 rounding: the plain forward keeps w_eff in f32,
the kernel route rounds it to bf16 first, as the TPU kernel does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.ops.pallas.masked_matmul import _mask_tile
from cpg_tpu_torch.ops import masked_matmul as mm

THR = 5e-3


def _weights(k, n, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(k, n).astype(np.float32)
    own = rng.choice([0, 1, 2, 3, 4], size=(k, n)).astype(np.int8)
    pm = (rng.randn(k, n) * 0.01).astype(np.float32)
    flat = pm.reshape(-1)
    flat[::7] = np.float32(THR)   # on the threshold: not picked
    flat[3::11] = 0.0             # zero: not picked, not flipped
    return w, own, pm


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("task_id", [1, 2, 3])
@pytest.mark.parametrize("mode", ["binary", "ternary"])
@pytest.mark.parametrize("shape", [(64, 72), (200, 24)])
def test_select_plain_matches_mask_tile_bit_for_bit(shape, mode, task_id,
                                                    transpose):
    w, own, pm = _weights(*shape, seed=sum(shape) + task_id)
    want = _mask_tile(jnp.asarray(w), jnp.asarray(own).astype(jnp.int32),
                      jnp.asarray(pm), task_id, THR, jnp.bfloat16, mode)
    want = np.asarray(want).view(np.int16)
    if transpose:
        want = want.T
    got = mm.masked_matmul_select(torch.from_numpy(w), torch.from_numpy(own),
                                  torch.from_numpy(pm), task_id, THR, mode,
                                  transpose=transpose)
    assert got.dtype == torch.bfloat16
    assert got.shape == (shape[::-1] if transpose else shape)
    np.testing.assert_array_equal(_bits(got), want)


def test_select_plain_is_the_cpu_wrapper_and_counts_nothing():
    w, own, pm = (torch.from_numpy(a) for a in _weights(16, 8, seed=0))
    before = mm.LAUNCHES_SELECT
    got = mm.masked_matmul_select(w, own, pm, 2, THR, "ternary", True)
    want = mm.masked_matmul_select_plain(w, own, pm, 2, THR, "ternary", True)
    assert torch.equal(got, want) and got.is_contiguous()
    assert mm.LAUNCHES_SELECT == before


@pytest.mark.parametrize("case", [(40, 24, 16), (7, 200, 72), (1, 8, 8)])
def test_gemm_tn_plain_is_a_times_bt_transposed(case):
    m, r, nout = case
    rng = np.random.RandomState(m)
    a = rng.randn(m, r).astype(np.float32)
    bt = rng.randn(nout, r).astype(np.float32)
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(bt).to(torch.bfloat16)
    got = mm.gemm_tn_plain(ta, tb)
    want = ta.float().numpy() @ tb.float().numpy().T
    assert got.dtype == torch.bfloat16 and got.shape == (m, nout)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("mode", ["binary", "ternary"])
def test_select_then_gemm_is_the_dense_forward_and_dx(mode):
    """What the kernel route composes on the card (select, then C = A @
    Bt^T) against the plain forward and dx, within bf16 rounding of w_eff:
    max|diff| <= 2e-2 * max|ref|, the limit `chip_smoke.py` holds the
    kernels to."""
    rng = np.random.RandomState(9)
    w, own, pm = (torch.from_numpy(a) for a in _weights(48, 32, seed=9))
    x = torch.from_numpy(rng.randn(30, 48).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.randn(30, 32).astype(np.float32)).bfloat16()
    y = mm.gemm_tn_plain(x, mm.masked_matmul_select_plain(
        w, own, pm, 3, THR, mode, transpose=True))
    dx = mm.gemm_tn_plain(g, mm.masked_matmul_select_plain(
        w, own, pm, 3, THR, mode))
    for got, want in ((y, mm.masked_matmul_plain(x, w, own, pm, 3, THR, mode)),
                      (dx, mm.masked_matmul_bwd_dx_plain(g, x, w, own, pm, 3,
                                                         THR, mode))):
        assert got.dtype == want.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * want.float().abs().max().item()
