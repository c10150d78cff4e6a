"""The PyTorch port's ops against `cpg_tpu`, on the CPU.

Inputs come from a numpy seed and go through both packages. Where the JAX
function reaches a Pallas kernel it runs in interpret mode (as the JAX
package's own tests run it); on CPU tensors the port's kernel wrappers run
their plain versions, which is what is compared here.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpg_tpu.core import ownership as j_own
from cpg_tpu.core import pruner as j_pruner
from cpg_tpu.data import augment as j_aug
from cpg_tpu.ops import binarize as j_bin
from cpg_tpu.ops import masked as j_masked
from cpg_tpu.ops.pallas.fused_chain import \
    fused_affine_relu_conv as j_fused_affine_relu_conv
from cpg_tpu.ops.pallas.masked_conv import masked_conv2d as j_masked_conv2d
from cpg_tpu.train import losses as j_losses
from cpg_tpu_torch.core import ownership as t_own
from cpg_tpu_torch.core import pruner as t_pruner
from cpg_tpu_torch.data import augment as t_aug
from cpg_tpu_torch.ops import binarize as t_bin
from cpg_tpu_torch.ops import fused_chain as t_fc
from cpg_tpu_torch.ops import masked as t_masked
from cpg_tpu_torch.ops import masked_conv as t_mc
from cpg_tpu_torch.ops.conv import resolve_padding
from cpg_tpu_torch.train import losses as t_losses

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _tree(seed=0, shapes=((3, 3, 4, 8), (16, 10)), tasks=(0, 1, 2, 3)):
    rng = np.random.RandomState(seed)
    shared = {f"l{i}/kernel": rng.randn(*s).astype(np.float32)
              for i, s in enumerate(shapes)}
    own = {k: rng.choice(tasks, size=w.shape).astype(np.int8)
           for k, w in shared.items()}
    pm = {k: (rng.randn(*w.shape) * 0.01).astype(np.float32)
          for k, w in shared.items()}
    return shared, own, pm


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("mode", ["binary", "ternary", "packnet", "no_pm"])
def test_effective_params_bit_exact(mode):
    shared, own, pm = _tree()
    use_pm = None if mode == "no_pm" else pm
    mask_mode = "binary" if mode == "no_pm" else mode
    want = j_masked.effective_params(shared, own, use_pm, 2,
                                     mask_mode=mask_mode)
    got = t_masked.effective_params(_t(shared), _t(own),
                                    None if use_pm is None else _t(use_pm), 2,
                                    mask_mode=mask_mode)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_binarize_ternarize_forward_and_ste():
    m = np.array([-0.2, -1e-4, 0.0, 5e-3, 5.1e-3, 0.3], np.float32)
    for j, t in ((j_bin.binarize, t_bin.binarize),
                 (j_bin.ternarize, t_bin.ternarize)):
        x = torch.tensor(m, requires_grad=True)
        y = t(x, 5e-3)
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(j(m, 5e-3)))
        g = torch.arange(6, dtype=torch.float32)
        y.backward(g)
        np.testing.assert_array_equal(x.grad.numpy(), g.numpy())
    np.testing.assert_array_equal(
        t_bin.init_piggymask((2, 3)).numpy(),
        np.asarray(j_bin.init_piggymask((2, 3))))


def test_ownership_transitions_and_ratios():
    _, own, _ = _tree(seed=1)
    want = j_own.assign_free_to_task(own, 4)
    got = t_own.assign_free_to_task(_t(own), 4)
    for k in own:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(
            t_own.owned_mask(torch.from_numpy(own[k]), 2).numpy(),
            np.asarray(j_own.owned_mask(own[k], 2)))
    for fn, args in (("free_ratio", ()), ("used_ratio", ()),
                     ("task_ratio", (2,))):
        assert float(getattr(t_own, fn)(_t(own), *args)) == float(
            getattr(j_own, fn)(own, *args))
    z = t_own.init_ownership({"a": torch.zeros(2, 3)})
    assert z["a"].dtype == torch.int8 and not z["a"].any()


@pytest.mark.parametrize("ratio", [0.5, 0.37, 0.0, 1.0])
def test_one_shot_prune_bit_exact(ratio):
    shared, own, _ = _tree(seed=2, tasks=(0, 1, 2))
    # ties at the cutoff magnitude are all pruned (`<=`)
    k = "l0/kernel"
    shared[k].ravel()[:40] = np.float32(0.25)
    want_w, want_own = j_pruner.one_shot_prune(shared, own, 1, ratio)
    got_w, got_own = t_pruner.one_shot_prune(_t(shared), _t(own), 1, ratio)
    for key in shared:
        np.testing.assert_array_equal(got_w[key].numpy(), np.asarray(want_w[key]))
        np.testing.assert_array_equal(got_own[key].numpy(),
                                      np.asarray(want_own[key]))


@pytest.mark.parametrize("cfg", [(2, 8, 8, 16, 32, 3, 1, "binary"),
                                 (1, 16, 16, 8, 16, 3, 2, "binary"),
                                 (2, 8, 8, 4, 8, 1, 1, "binary"),
                                 (2, 8, 8, 16, 32, 3, 1, "ternary"),
                                 (1, 9, 7, 3, 12, 3, 2, "ternary")])
def test_masked_conv_plain_matches_jax(cfg):
    n, h, w_, cin, cout, k, s, mode = cfg
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w_, cin).astype(np.float32)
    w = rng.randn(k, k, cin, cout).astype(np.float32)
    own = rng.choice([0, 1, 2, 3], size=w.shape).astype(np.int8)
    pm = (rng.randn(*w.shape) * 0.01).astype(np.float32)
    want = np.asarray(j_masked_conv2d(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(own), jnp.asarray(pm), 2,
                                      stride=s, mask_mode=mode))
    got = t_mc.masked_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(own), torch.from_numpy(pm), 2,
                             stride=s, mask_mode=mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_masked_conv_plain_keeps_bf16_and_rejects_packnet():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 4, 4, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 5).astype(np.float32))
    own = torch.ones(w.shape, dtype=torch.int8)
    y = t_mc.masked_conv2d(x.bfloat16(), w, own, w, 1)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 4, 4, 5)
    with pytest.raises(ValueError, match="mask_mode"):
        t_mc.masked_conv2d(x, w, own, w, 1, mask_mode="packnet")


def test_same_padding_is_xla_rule():
    # stride 2 on an even size pads (0, 1), not torch's symmetric (1, 1)
    assert resolve_padding("SAME", 16, 16, 3, 3, 2) == (0, 1, 0, 1)
    assert resolve_padding("SAME", 9, 7, 3, 3, 2) == (1, 1, 1, 1)
    assert resolve_padding("SAME", 32, 32, 3, 3, 1) == (1, 1, 1, 1)
    assert resolve_padding("VALID", 8, 8, 3, 3, 1) == (0, 0, 0, 0)
    assert resolve_padding(2, 8, 8, 3, 3, 1) == (2, 2, 2, 2)
    assert resolve_padding([(0, 1), (2, 3)], 8, 8, 3, 3, 1) == (0, 1, 2, 3)


@pytest.mark.parametrize("shape", [(4, 8, 8, 16, 32), (2, 5, 7, 8, 16),
                                   (3, 4, 4, 24, 8), (8, 3, 3, 4, 4),
                                   (4, 2, 2, 16, 16)])
def test_fused_chain_plain_matches_jax(shape):
    n, h, w, cin, cout = shape
    rng = np.random.RandomState(1)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    a = rng.uniform(0.5, 1.5, cin).astype(np.float32)
    b = (rng.randn(cin) * 0.3).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    want = np.asarray(j_fused_affine_relu_conv(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(wt),
        jnp.float32))
    got = t_fc.fused_affine_relu_conv(
        torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(wt), torch.float32)
    assert got.dtype == torch.float32 and got.shape == (n, h, w, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_chain_predicate_covers_vgg_seams():
    """The CUDA kernel's own shape predicate takes every VGG16-BN seam at
    width mult <= 2 (including the 2x2 seams), in bf16 and f32."""
    for mult in (0.5, 1.0, 1.5, 2.0):
        for hw, c in ((32, 64), (16, 128), (8, 256), (4, 512), (2, 512)):
            ch = int(c * mult)
            for dt in (torch.bfloat16, torch.float32):
                x = torch.empty((256, hw, hw, ch), dtype=dt)
                w = torch.empty((3, 3, ch, ch))
                assert t_fc.supported(x, w, dt), (mult, hw, ch, dt)
    x = torch.empty((1, 2, 200, 8))
    assert not t_fc.supported(x, torch.empty((3, 3, 8, 8)), torch.float32)
    assert not t_fc.supported(x[:, :, :8], torch.empty((3, 3, 8, 8)),
                              torch.bfloat16)  # x not in the dot dtype
    xb = torch.empty((1, 4, 4, 8), dtype=torch.bfloat16)
    assert t_fc.supported(xb, torch.empty((3, 3, 8, 16)), torch.bfloat16)
    assert not t_fc.supported(xb, torch.empty((3, 3, 8, 12)), torch.bfloat16)


@pytest.mark.parametrize("eighths", range(1, 17))
def test_backward_predicates_cover_vgg_widths(eighths):
    """Every VGG16-BN width multiple of 0.125 up to 2.0 meets the bf16
    predicates of the masked-conv kernels (K1-K3: Cout % 4) and of the
    fused-chain backward kernels (K5, K6: Cin, Cout % 8)."""
    from cpg_tpu_torch.models.vgg import CFG_VGG16, scale_channels

    chans = [scale_channels(v, eighths / 8) for v in CFG_VGG16 if v != "M"]
    opening = {0, 2, 4, 7, 10}  # the masked convs; the rest are fused seams
    cin = 3
    for i, cout in enumerate(chans):
        x = torch.empty((2, 4, 4, cin), dtype=torch.bfloat16)
        if i in opening:
            assert t_mc.supported(x, torch.empty((3, 3, cin, cout))), (i, cin)
        else:
            assert t_fc._bwd_supported(x, cout, torch.bfloat16), (i, cin, cout)
        cin = cout
    assert not t_mc.supported(torch.empty((1, 4, 4, 8), dtype=torch.bfloat16),
                              torch.empty((3, 3, 8, 70)))


@pytest.mark.parametrize("dim,heads", [(256, 4), (768, 12)])
def test_kernel_predicates_cover_vit_widths(dim, heads):
    """Every sharable dense kernel of vit_cifar (dim 256, 4 heads) and
    vit_b16 (768, 12) at width multiples of 0.25 up to 2.0 meets the dense
    route's bf16 predicate (N % 4 == 0), and the heads (hd = dim / heads =
    64) meet the flash kernels'."""
    from cpg_tpu_torch.models.vit import _heads
    from cpg_tpu_torch.ops import flash as t_flash

    def dense_ok(k, n):  # masked_matmul's kernels are the 1x1 conv's
        return t_mc.supported(torch.empty((2, 1, 1, k), dtype=torch.bfloat16),
                              torch.empty((1, 1, k, n)))

    hd = dim // heads
    for quarters in range(1, 9):
        inner = _heads(heads, quarters / 4) * hd
        hidden = max(1, int(dim * 4 * quarters / 4))
        for k, n in ((dim, inner), (inner, dim), (dim, hidden), (hidden, dim)):
            assert dense_ok(k, n), (quarters, k, n)
    assert not dense_ok(8, 70)
    assert t_flash.supported(torch.empty((1, 4, 2, hd), dtype=torch.bfloat16))
    assert not t_flash.supported(torch.empty((1, 4, 2, 24)))


def test_eval_preprocess_and_losses_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randint(0, 256, (3, 4, 4, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        t_aug.cifar_eval_preprocess(torch.from_numpy(x)).numpy(),
        np.asarray(j_aug.cifar_eval_preprocess(jnp.asarray(x))))
    logits = (rng.randn(6, 5) * 3).astype(np.float32)
    labels = rng.randint(0, 5, 6)
    np.testing.assert_allclose(
        float(t_losses.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels))),
        float(j_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    assert float(t_losses.accuracy(torch.from_numpy(logits),
                                   torch.from_numpy(labels))) == float(
        j_losses.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_cpg_tpu():
    files = sorted((ROOT / "cpg_tpu_torch").rglob("*.py")) + sorted(
        (ROOT / "scripts").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
    names = {f.name for f in files}
    assert {"gating.py", "step.py", "augment.py", "torch_train_profile.py",
            "vit.py", "flash.py", "masked_matmul.py", "int8.py",
            "server_http.py", "export_torch.py", "pretrained.py",
            "serve.py", "cli.py", "resnet.py", "finegrained.py",
            "imagefolder.py", "spherenet.py", "face.py", "losses.py",
            "text.py", "moe.py", "textfolder.py"} <= names
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "cpg_tpu", "flax", "optax",
                               "orbax"), f"{f.relative_to(ROOT)} imports {mod}"
