"""Functional layer framework for CPG models (VGG, ResNet, SphereNet, the
ViTs, the MoE ViT and the text classifier).

The counterpart of `cpg_tpu.models.framework`: a flat parameter dict keyed by
layer name, split into *shared* sharable kernels (governed by ownership) and
task-*private* params (BN and LayerNorm affines, BN running stats, biases,
positional embeddings, heads). Layers take and return NHWC (or (N, T, D))
tensors; conv kernels are HWIO, dense kernels (in, out); torch layouts appear
only inside ops.

Usage:
    shared, private, bn_state = init(generator, model_fn, sample_x)
    y, new_bn = apply(model_fn, eff_shared, private, bn_state, x, train=False)

`init` draws every parameter from the given `torch.Generator` on the CPU, in
registration order; the caller moves the dicts to its device.

Under a model axis (`apply(shards=...)`, parallel/mesh.py) `shared` holds
this rank's slice of each kernel named in `shards`: a sharable layer takes
its input through `to_model_group`, runs its product on the slice (the
same kernels: K1-K3 through `masked_conv2d`/`masked_matmul`, K4-K6 through
`fused_affine_relu_conv`) and gathers the output over the model group at
once, so everything after it runs whole on every rank of the group. A
layer whose kernel is not split runs whole, with no collective.

Activation sharding (`apply(act_sharder=...)`, parallel/mesh.py): the
transformers call `Ctx.constrain` at `cpg_tpu`'s seams. The first
`"tokens"` seam keeps this rank's T/M tokens of the stream (`Ctx.tokens`
records the split), and the stream stays split until the mean pool.
A layer that reads this rank's rows (`Ctx.rows`) runs on them and sums
its parameters' gradients over the model group (`to_model_group` on each
parameter it reads: every rank holds the whole parameter, but its rows
give a partial gradient). A product on a kernel shard takes every token
(`gather_tokens`, whose backward sums the ranks' partial input gradients)
and returns this rank's rows. Attention, the MoE layer and the pool
gather the tokens whole (`Ctx.whole_tokens`) and run whole on every rank
of the group. The `pipeline` hook runs a transformer's block stack as a
GPipe over stage ranks (parallel/pipeline.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.conv import conv2d_nhwc, resolve_padding
from ..parallel.collectives import (all_gather_along, all_reduce_sum,
                                    gather_from_model_group, gather_tokens,
                                    split_tokens, to_model_group, world_size)


@dataclass
class Masking:
    """Raw-weight mode: `shared` holds RAW weights and each sharable layer
    applies the CPG effective-weight selection itself, as a per-layer select
    or inside the masked kernels: `pallas_dense` (the names `cpg_tpu` uses)
    routes `sdense` to ops/masked_matmul.py, `pallas_conv` routes `sconv` to
    ops/masked_conv.py. Numerically the same as consuming pre-masked
    effective params."""

    ownership: Dict[str, torch.Tensor]
    piggymask: Optional[Dict[str, torch.Tensor]]
    task_id: int
    threshold: float = 5e-3
    mask_mode: str = "binary"
    pallas_dense: bool = False
    pallas_conv: bool = False


def he_normal_fan_out(gen, shape, dtype=torch.float32):
    """Kaiming-normal, fan_out, relu gain — torch's VGG conv init."""
    fan_out = shape[0] * shape[1] * shape[3] if len(shape) == 4 else shape[-1]
    return torch.randn(tuple(shape), generator=gen, dtype=dtype) * math.sqrt(
        2.0 / fan_out)


def xavier_normal(gen, shape, dtype=torch.float32):
    """Glorot-normal over (in, out) dense or HWIO conv kernels."""
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[-1]
    else:
        fan_in = shape[0] * shape[1] * shape[2]
        fan_out = shape[0] * shape[1] * shape[3]
    return torch.randn(tuple(shape), generator=gen, dtype=dtype) * math.sqrt(
        2.0 / (fan_in + fan_out))


def normal_init(std):
    def f(gen, shape, dtype=torch.float32):
        return torch.randn(tuple(shape), generator=gen, dtype=dtype) * std

    return f


def _zeros(gen, shape):
    return torch.zeros(tuple(shape))


def _ones(gen, shape):
    return torch.ones(tuple(shape))


@dataclass
class Ctx:
    """Per-call context threading params through a functional forward."""

    mode: str  # 'init' | 'apply'
    train: bool
    generator: Optional[torch.Generator] = None
    shared: Dict[str, torch.Tensor] = field(default_factory=dict)
    private: Dict[str, torch.Tensor] = field(default_factory=dict)
    bn_state: Dict[str, torch.Tensor] = field(default_factory=dict)
    new_bn_state: Dict[str, torch.Tensor] = field(default_factory=dict)
    compute_dtype: torch.dtype = torch.float32
    masking: Optional[Masking] = None
    # route BN+ReLU+conv3x3 chains through the fused kernel
    # (ops/fused_chain.py); honoured by fused_bn_relu_sconv outside init
    # and int8
    fused_chain: bool = False
    # route transformer attention through the flash kernels (ops/flash.py);
    # honoured by models/vit.py attention() outside init and int8
    flash_attention: bool = False
    # q|k|v as one (D, 3*inner) product in models/vit.py attention() on the
    # effective-params path (not init, no Masking, no int8); the three
    # kernels stay separate params. None and False: three products
    qkv_fused: Optional[bool] = None
    # int8 serving (serve.py), eval only: {kernel key -> per-output-channel
    # f32 weight scale}; when set, `shared` holds int8 kernels and
    # sconv/sdense run the int8 products (ops/int8.py)
    quant_scales: Optional[Dict[str, torch.Tensor]] = None
    # static per-layer activation scales (TaskServer.calibrate); a key
    # missing here quantizes with the batch's own max |x|
    act_scales: Optional[Dict[str, torch.Tensor]] = None
    # calibration collector: the int8 path records each layer's observed
    # activation scale (the max over calls) into this dict
    act_stats: Optional[Dict[str, float]] = None
    # data-parallel training: the process group whose ranks' batches make
    # the global batch (the mesh's data group); BatchNorm takes its
    # statistics over all of it
    sync_group: Optional[object] = None
    # the model axis: {kernel key: ShardSpec} of the kernels `shared` holds
    # this rank's slice of (parallel/collectives.py)
    shards: Dict[str, object] = field(default_factory=dict)
    # activation sharding (parallel/mesh.py act_sharder): the hook the
    # models' "tokens" and "experts" seams call; None: every seam whole
    act_sharder: Optional[Callable] = None
    # the ShardSpec of the token axis once a "tokens" seam split the
    # stream (axis 1, this rank's rows of the model group)
    tokens: Optional[object] = None
    # pipeline hook (parallel/pipeline.py make_pipeliner): (merged params,
    # tokens, block kwargs, compute dtype) -> tokens, run in place of a
    # transformer's block stack; None: the blocks run inline
    pipeline: Optional[Callable] = None

    def seam(self, x, tag):
        """The split `act_sharder` makes of x at the seam `tag` (a
        ShardSpec of axis 1), or None where x stays whole."""
        return None if self.act_sharder is None else self.act_sharder.spec(
            x, tag)

    def constrain(self, x, tag: str):
        """`cpg_tpu`'s seam `tag`: "tokens" on (N, T, D), "experts" on
        (N, E, C, D). Under `act_sharder`, where the axis divides over the
        model group, this rank's part of it (`split_tokens`); a token
        stream that is split already passes as it is."""
        if tag == "tokens" and self.rows(x) is not None:
            return x
        spec = self.seam(x, tag)
        if spec is None:
            return x
        if tag == "tokens":
            self.tokens = spec
        return split_tokens(x, spec.group)

    def rows(self, x):
        """The token split when x ((N, T, D), or (N, T) token ids) holds
        this rank's rows of it, else None."""
        spec = self.tokens
        if (spec is None or x.dim() not in (2, 3)
                or x.shape[1] != spec.width):
            return None
        return spec

    def token_rows(self, table):
        """This rank's rows of a per-position table (T, D) when the token
        stream is split (its gradient summed over the model group), else
        the table."""
        spec = self.tokens
        if spec is None or table.shape[0] != spec.size:
            return table
        return to_model_group(table, spec.group).narrow(
            0, spec.index * spec.width, spec.width)

    def whole_tokens(self, x):
        """x with every token, where tokens mix: this rank's rows gathered
        over the model group (the backward keeps this rank's rows of the
        gradient, whole on every rank); x itself when it is whole."""
        spec = self.rows(x)
        return x if spec is None else gather_from_model_group(
            x, spec.group, 1)

    def shared_param(self, name, shape, init_fn):
        """The kernel `name` of whole shape `shape` (its slice when
        `shards` splits it)."""
        if self.mode == "init":
            if name in self.shared:
                raise ValueError(f"duplicate shared param {name}")
            self.shared[name] = init_fn(self.generator, shape)
        w = self.shared[name]
        spec = self.shards.get(name)
        want = tuple(shape) if spec is None else spec.shard_shape(shape)
        if tuple(w.shape) != want:
            raise ValueError(f"{name}: {tuple(w.shape)} != {want}")
        return w

    def into_shard(self, key, *xs):
        """The inputs of a product on kernel `key`: through
        `to_model_group` when the kernel is split (their gradients then sum
        the ranks' partial ones), else as they are."""
        spec = self.shards.get(key)
        if spec is None:
            return xs if len(xs) > 1 else xs[0]
        out = tuple(to_model_group(x, spec.group) for x in xs)
        return out if len(out) > 1 else out[0]

    def out_of_shard(self, key, y, axis=-1):
        """A product's output on kernel `key` made whole: gathered along
        `axis` over the model group when the kernel is split."""
        spec = self.shards.get(key)
        return y if spec is None else gather_from_model_group(
            y, spec.group, axis)

    def private_param(self, name, shape, init_fn):
        if self.mode == "init":
            if name in self.private:
                raise ValueError(f"duplicate private param {name}")
            self.private[name] = init_fn(self.generator, shape)
        return self.private[name]

    def bn_running(self, name, shape):
        if self.mode == "init":
            self.bn_state[name + "/mean"] = torch.zeros(shape)
            self.bn_state[name + "/var"] = torch.ones(shape)
        return self.bn_state[name + "/mean"], self.bn_state[name + "/var"]

    def mask_entries(self, key):
        """(ownership, piggymask-or-None) for a shared kernel in raw mode."""
        mk = self.masking
        pm = mk.piggymask[key] if mk.piggymask is not None else None
        return mk.ownership[key], pm

    def masked_weight(self, key, w):
        """Per-layer effective-weight select (raw mode, no kernel)."""
        from ..ops.masked import effective_kernel

        mk = self.masking
        own, pm = self.mask_entries(key)
        return effective_kernel(w, own, pm, mk.task_id, mk.threshold,
                                mk.mask_mode)


def _quantize_activation(x: torch.Tensor, scale=None):
    """Per-tensor symmetric int8: s = max(max|x|, 1e-8) / 127 in f32 (or
    the static `scale`), q = clip(round(x / s), -127, 127), rounding half
    to even (ops/int8.py `scale_of`, `quantize`). Returns (q, s)."""
    from ..ops.int8 import quantize, scale_of

    s = (scale_of(x.float().abs().amax()) if scale is None
         else torch.as_tensor(scale, dtype=torch.float32, device=x.device))
    return quantize(x, s), s


def _act_scale_in(ctx: Ctx, key: str):
    """The static activation scale for a layer, if calibrated."""
    if ctx.act_scales is not None:
        return ctx.act_scales.get(key)
    return None


def _record_act(ctx: Ctx, key: str, s) -> None:
    """Calibration collection (eager): keep the max observed scale."""
    if ctx.act_stats is not None:
        ctx.act_stats[key] = max(float(s), ctx.act_stats.get(key, 0.0))


def _int8_product(ctx: Ctx, key: str, x: torch.Tensor, product):
    """Quantize x, run `product(xq)` (int32), rescale by s_x * s_w (the
    scale product formed first) in f32."""
    xq, s_x = _quantize_activation(x, _act_scale_in(ctx, key))
    _record_act(ctx, key, s_x)
    return product(xq).float() * (s_x * ctx.quant_scales[key])


def _patchify_dot(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """kernel == stride == k VALID conv as space-to-depth + one product. The
    patch flatten order (kh, kw, cin) is HWIO's row-major flatten, so
    `w.reshape(k*k*C, F)` pairs elements as the strided conv does."""
    n, hh, ww, c = x.shape
    f = w.shape[-1]
    x = x.reshape(n, hh // k, k, ww // k, k, c).permute(0, 1, 3, 2, 4, 5)
    y = x.reshape(n, (hh // k) * (ww // k), k * k * c) @ w.reshape(k * k * c, f)
    return y.reshape(n, hh // k, ww // k, f)


def sconv(ctx: Ctx, name: str, x: torch.Tensor, features: int,
          kernel: int = 3, stride: int = 1, padding="SAME",
          kernel_init=he_normal_fan_out) -> torch.Tensor:
    """Sharable 2D conv (ref:models/layers.py SharableConv2d). NHWC/HWIO,
    output in the compute dtype. With a Masking whose `pallas_conv` is set
    and a piggymask present, the masked-conv kernel selects the weight.
    Under int8 (`ctx.quant_scales` holds the key) the int8 conv of
    ops/int8.py runs and the output is f32. A
    non-overlapping patch embedding (kernel == stride, VALID, as in the ViT
    stems) runs as space-to-depth + one matmul, as `cpg_tpu` computes it.
    A split kernel (`ctx.shards`) gives this rank's output channels,
    gathered over the model group."""
    cin = x.shape[-1]
    key = f"{name}/kernel"
    w = ctx.shared_param(key, (kernel, kernel, cin, features), kernel_init)
    y = _conv_product(ctx, key, ctx.into_shard(key, x), w, kernel, stride,
                      padding)
    return ctx.out_of_shard(key, y)


def _conv_product(ctx: Ctx, key: str, x, w, kernel, stride, padding):
    mk = ctx.masking
    if mk is not None and ctx.mode != "init":
        own, pm = ctx.mask_entries(key)
        if mk.pallas_conv and pm is not None:
            from ..ops.masked_conv import masked_conv2d

            return masked_conv2d(x.to(ctx.compute_dtype).contiguous(), w, own,
                                 pm, mk.task_id, stride=stride,
                                 padding=padding, threshold=mk.threshold,
                                 mask_mode=mk.mask_mode)
        w = ctx.masked_weight(key, w)
    if ctx.quant_scales is not None and key in ctx.quant_scales:
        from ..ops.int8 import conv2d_int8

        pads = resolve_padding(padding, x.shape[1], x.shape[2], kernel,
                               kernel, stride)
        return _int8_product(ctx, key, x,
                             lambda xq: conv2d_int8(xq, w, stride, pads))
    if (kernel == stride and kernel > 1 and padding == "VALID"
            and x.shape[1] % kernel == 0 and x.shape[2] % kernel == 0):
        return _patchify_dot(x.to(ctx.compute_dtype),
                             w.to(ctx.compute_dtype), kernel)
    pads = resolve_padding(padding, x.shape[1], x.shape[2], kernel, kernel,
                           stride)
    return conv2d_nhwc(x.to(ctx.compute_dtype), w.to(ctx.compute_dtype),
                       stride, pads)


def sdense(ctx: Ctx, name: str, x: torch.Tensor, features: int,
           use_bias: bool = True, kernel_init=normal_init(0.01)
           ) -> torch.Tensor:
    """Sharable dense layer (ref:models/layers.py SharableLinear) over any
    leading shape, output and bias add in the compute dtype. With a Masking
    whose `pallas_dense` is set and a piggymask present, the leading dims
    flatten to (M, K) and the masked-matmul kernels select the weight.
    Under int8 the int8 matmul runs and the output is f32. A split kernel
    gives this rank's output features, gathered before the bias. On this
    rank's rows of a split token stream (`ctx.rows`), a whole kernel runs
    on the rows and its gradients are summed over the model group; a
    split one takes every token and gives back this rank's rows."""
    key = f"{name}/kernel"
    w = ctx.shared_param(key, (x.shape[-1], features), kernel_init)
    rows = ctx.rows(x)
    if rows is not None and key in ctx.shards:
        # the slice's product takes every token; `gather_tokens`' backward
        # sums the ranks' partial input gradients, as `into_shard`'s does
        y = ctx.out_of_shard(key, _dense_product(
            ctx, key, gather_tokens(x, rows.group), w))
        return split_tokens(_dense_bias(ctx, name, y, features, use_bias),
                            rows.group)
    y = ctx.out_of_shard(key, _dense_product(ctx, key, ctx.into_shard(key, x),
                                             w, rows))
    return _dense_bias(ctx, name, y, features, use_bias, rows)


def _row_sums(rows, *ts):
    """Parameters read on this rank's rows of a split token stream: their
    gradients summed over the model group (`to_model_group`); as they are
    without a split."""
    if rows is None:
        return ts if len(ts) > 1 else ts[0]
    out = tuple(to_model_group(t, rows.group) for t in ts)
    return out if len(out) > 1 else out[0]


def _dense_product(ctx: Ctx, key: str, x, w, rows=None):
    mk = ctx.masking
    if mk is not None and ctx.mode != "init":
        own, pm = ctx.mask_entries(key)
        if mk.pallas_dense and pm is not None:
            from ..ops.masked_matmul import masked_matmul

            w, pm = _row_sums(rows, w, pm)
            x2 = x.reshape(-1, x.shape[-1]).to(ctx.compute_dtype).contiguous()
            return masked_matmul(x2, w, own, pm, mk.task_id, mk.threshold,
                                 mk.mask_mode).reshape(*x.shape[:-1],
                                                       w.shape[-1])
        w = ctx.masked_weight(key, w)
    w = _row_sums(rows, w)
    if ctx.quant_scales is not None and key in ctx.quant_scales:
        from ..ops.int8 import matmul_int8

        return _int8_product(ctx, key, x, lambda xq: matmul_int8(xq, w))
    return x.to(ctx.compute_dtype) @ w.to(ctx.compute_dtype)


def sembed(ctx: Ctx, name: str, ids: torch.Tensor, vocab: int,
           features: int) -> torch.Tensor:
    """Sharable token embedding: a (vocab, features) kernel looked up by
    row, in the compute dtype. The CPG select runs over the whole table
    (`masked_weight`, as sdense's kernel), then the rows are gathered; ids
    may arrive as float zeros from `init`'s sample batch and are cast.
    Under int8 the int8 rows are gathered, then dequantized by the
    per-feature scale (f32 out). No kernel: `cpg_tpu` has no Pallas form.

    Ids must lie in [0, vocab): `jnp.take` clamps or fills an id outside
    it, torch raises (on the card, a device-side assert), so the entry
    points check them on the host (`models.check_token_ids`). The table
    keeps its shape across widths. A split table (on its features) gives
    this rank's features of each row, gathered over the model group.
    This rank's ids of a split token stream (`ctx.rows`) look up their
    rows of a whole table, whose gradient is summed over the model group;
    a split table takes every id and gives back this rank's rows."""
    key = f"{name}/kernel"
    w = ctx.shared_param(key, (vocab, features), normal_init(0.02))
    if ctx.masking is not None and ctx.mode != "init":
        w = ctx.masked_weight(key, w)
    ids = ids.long()
    rows = ctx.rows(ids)
    if rows is not None and key in ctx.shards:
        y = _sembed_rows(ctx, key, all_gather_along(ids, rows.group, 1), w,
                        features)
        return split_tokens(y, rows.group)
    return _sembed_rows(ctx, key, ids, _row_sums(rows, w), features)


def _sembed_rows(ctx: Ctx, key: str, ids, w, features: int):
    """The rows of `w` at `ids`, in the compute dtype (f32 under int8)."""
    if ctx.quant_scales is not None and key in ctx.quant_scales:
        rows = torch.index_select(w, 0, ids.reshape(-1))
        return (rows.float() * ctx.quant_scales[key]).reshape(
            *ids.shape, features)
    # the table is cast before the gather, as `cpg_tpu`'s: in bf16 the
    # gather's backward sums each row's gradient into a bf16 row
    return ctx.out_of_shard(key, F.embedding(ids, w.to(ctx.compute_dtype)))


def _dense_bias(ctx: Ctx, name: str, y: torch.Tensor, features: int,
                use_bias: bool, rows=None) -> torch.Tensor:
    if not use_bias:
        return y
    b = _row_sums(rows, ctx.private_param(f"{name}/bias", (features,),
                                          _zeros))
    return y + b.to(y.dtype)


BN_MOMENTUM = 0.1  # torch default: running = (1-m)*running + m*batch
BN_EPS = 1e-5


def _bn_moments(ctx: Ctx, name: str, x: torch.Tensor):
    """Register affine + running params; return (mean, var, scale, bias) for
    this call (batch stats in train, running stats in eval) and record the
    running-stat updates. Batch stats use the one-pass E[x^2] - mean^2;
    under `ctx.sync_group` over the global batch (the unbiased factor from
    its count), their gradients reaching every rank's rows. Under a model
    axis that group is the data group: the ranks of a model group see the
    same rows and, after the gathered product, all the channels."""
    c = x.shape[-1]
    scale = ctx.private_param(f"{name}/scale", (c,), _ones)
    bias = ctx.private_param(f"{name}/bias", (c,), _zeros)
    rmean, rvar = ctx.bn_running(name, (c,))
    if ctx.train:
        dims = tuple(range(x.dim() - 1))
        xf = x.float()
        n = math.prod(x.shape[d] for d in dims)
        if ctx.sync_group is None:
            mean = xf.mean(dims)
            msq = xf.square().mean(dims)
        else:  # [sum x, sum x^2] over the global batch, one all-reduce
            sums = all_reduce_sum(torch.stack(
                [xf.sum(dims), xf.square().sum(dims)]), ctx.sync_group)
            n *= world_size(ctx.sync_group)
            mean, msq = sums[0] / n, sums[1] / n
        var = torch.clamp_min(msq - mean.square(), 0.0)
        unbiased = var * (n / max(n - 1, 1))
        ctx.new_bn_state[name + "/mean"] = (1 - BN_MOMENTUM) * rmean + BN_MOMENTUM * mean
        ctx.new_bn_state[name + "/var"] = (1 - BN_MOMENTUM) * rvar + BN_MOMENTUM * unbiased
    else:
        mean, var = rmean, rvar
        ctx.new_bn_state[name + "/mean"] = rmean
        ctx.new_bn_state[name + "/var"] = rvar
    return mean, var, scale, bias


def batchnorm(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm with task-private affine and running stats; f32 math,
    output in x's dtype."""
    mean, var, scale, bias = _bn_moments(ctx, name, x)
    y = (x.float() - mean) * torch.rsqrt(var + BN_EPS) * scale + bias
    return y.to(x.dtype)


def batchnorm_affine(ctx: Ctx, name: str, x: torch.Tensor):
    """BN folded to a per-channel affine (a, b) with BN(x) = a*x + b; same
    params and stats as `batchnorm`, nothing materialised."""
    mean, var, scale, bias = _bn_moments(ctx, name, x)
    a = torch.rsqrt(var + BN_EPS) * scale
    return a, bias - mean * a


def fused_bn_relu_sconv(ctx: Ctx, bn_name: str, conv_name: str,
                        x: torch.Tensor, features: int) -> torch.Tensor:
    """conv3x3(relu(BN(x))). Under `ctx.fused_chain` (outside init) this runs
    the fused kernel, the normalised activation never leaving shared memory;
    otherwise (and under int8) it is exactly the unfused composition. Same
    param names and registration order either way. A split kernel takes
    x, a and b through `to_model_group` (K5's partial dx, da and db sum
    over the model group) and gathers its output channels."""
    if not (ctx.fused_chain and ctx.mode != "init"
            and ctx.quant_scales is None):
        return sconv(ctx, conv_name, relu(batchnorm(ctx, bn_name, x)),
                     features, kernel=3, stride=1, padding="SAME")
    from ..ops.fused_chain import fused_affine_relu_conv

    a, b = batchnorm_affine(ctx, bn_name, x)
    key = f"{conv_name}/kernel"
    w = ctx.shared_param(key, (3, 3, x.shape[-1], features), he_normal_fan_out)
    if ctx.masking is not None:
        w = ctx.masked_weight(key, w)
    x, a, b = ctx.into_shard(key, x, a, b)
    return ctx.out_of_shard(key, fused_affine_relu_conv(
        x.contiguous(), a.contiguous(), b.contiguous(), w, ctx.compute_dtype))


LN_EPS = 1e-6


def layernorm(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with a task-private affine; two-pass f32
    moments, output in x's dtype. Per token: on this rank's rows of a
    split stream the affine's gradients are summed over the model
    group."""
    c = x.shape[-1]
    scale, bias = _row_sums(
        ctx.rows(x), ctx.private_param(f"{name}/scale", (c,), _ones),
        ctx.private_param(f"{name}/bias", (c,), _zeros))
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS) * scale + bias
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximation GELU; gelu(0) == 0 exactly (the growth law needs a
    grown hidden unit to stay 0). On bf16 input torch evaluates in f32 and
    rounds once, where XLA rounds after each elementwise op."""
    return F.gelu(x, approximate="tanh")


HEAD_ROWS = 256


def head(ctx: Ctx, name: str, x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Task-private classifier head, f32, initialised N(0, 0.01^2).

    Under int8 the product runs on blocks of HEAD_ROWS rows (the last one
    zero-padded): calibrated int8 logits must not depend on what shares a
    request's bucket, every product before the head is exact, and a
    library GEMM picks its algorithm, and with it the summation order, by
    shape."""
    w = ctx.private_param(f"{name}/kernel", (x.shape[-1], num_classes),
                          normal_init(0.01))
    b = ctx.private_param(f"{name}/bias", (num_classes,), _zeros)
    return head_product(ctx, x.float(), w) + b


def head_product(ctx: Ctx, xf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xf @ w for a task-private head; under int8 on blocks of HEAD_ROWS
    rows (see `head`)."""
    if ctx.quant_scales is None:
        return xf @ w
    n = xf.shape[0]
    blocks = F.pad(xf, (0, 0, 0, -n % HEAD_ROWS)).split(HEAD_ROWS)
    return torch.cat([blk @ w for blk in blocks])[:n]


def prelu(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    """PReLU with a task-private slope (initialised to 0.25), computed and
    returned in f32 as `cpg_tpu`'s; the next sharable layer casts it to
    the compute dtype."""
    a = ctx.private_param(f"{name}/slope", (x.shape[-1],),
                          lambda gen, shape: torch.full(tuple(shape), 0.25))
    xf = x.float()
    return torch.where(xf >= 0, xf, a * xf)


def maxpool(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2/2 max pool, VALID."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def avgpool_global(x: torch.Tensor) -> torch.Tensor:
    """NHWC mean over H and W in f32, rounded once to x's dtype (as
    `cpg_tpu`'s jnp.mean on bf16)."""
    return x.float().mean((1, 2)).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) as `cpg_tpu`'s jnp.maximum: where x == 0 the gradient is
    split in half (torch.relu passes none). Such ties are common: a fresh
    task's zero BN bias over an all-zero (pruned) channel gives exact
    zeros, and a residual sum over them stays 0 where the identity is."""
    return torch.maximum(x, x.new_zeros(()))


def init(generator: torch.Generator, model_fn: Callable, sample_x,
         **kwargs) -> Tuple[Dict, Dict, Dict]:
    """(shared, private, bn_state) on the CPU, drawn from `generator`."""
    ctx = Ctx(mode="init", train=False, generator=generator)
    with torch.no_grad():
        model_fn(ctx, sample_x, **kwargs)
    return ctx.shared, ctx.private, ctx.bn_state


def apply(model_fn: Callable, shared: Dict, private: Dict, bn_state: Dict, x,
          train: bool, compute_dtype=torch.float32,
          masking: Optional[Masking] = None, fused_chain: bool = False,
          flash_attention: bool = False, quant_scales=None, act_scales=None,
          act_stats=None, qkv_fused: Optional[bool] = None,
          sync_group=None, shards=None,
          act_sharder: Optional[Callable] = None,
          pipeline: Optional[Callable] = None, **kwargs):
    """Run the model. With `masking=None`, `shared` holds pre-masked
    effective params; with a Masking, `shared` holds RAW weights. With
    `quant_scales` (eval only), `shared` holds int8 kernels. `sync_group`
    (training) synchronises BatchNorm's statistics over its ranks;
    `shards` names the kernels `shared` holds this rank's slice of;
    `act_sharder` splits the seams' activations over the model group
    (parallel/mesh.py); `pipeline` runs the block stack over stage ranks
    (parallel/pipeline.py)."""
    if quant_scales is not None and train:
        raise ValueError("int8 (quant_scales) is eval-only")
    ctx = Ctx(mode="apply", train=train, shared=shared, private=private,
              bn_state=bn_state, compute_dtype=compute_dtype,
              masking=masking, fused_chain=fused_chain,
              flash_attention=flash_attention, quant_scales=quant_scales,
              act_scales=act_scales, act_stats=act_stats,
              qkv_fused=qkv_fused, sync_group=sync_group,
              shards=dict(shards or {}), act_sharder=act_sharder,
              pipeline=pipeline)
    out = model_fn(ctx, x, **kwargs)
    return out, ctx.new_bn_state
