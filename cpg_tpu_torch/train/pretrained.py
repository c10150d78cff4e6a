"""Reference torch checkpoints into CPG states (VGG16-BN).

The counterpart of part of `cpg_tpu.train.pretrained`: `load_torch_checkpoint`
(a .pth/.pth.tar file as {key: ndarray}), `convert_torch_vgg16_bn` (a
VGG16-BN state_dict in this package's naming) and
`convert_torch_cpg_checkpoint` (the reference's whole CPG checkpoint:
backbone state_dict + pruner `masks` + per-dataset `shared_layer_info` +
dataset history + width multiplier -> a multi-task CPGState). Conv tensors
go torch OIHW -> HWIO, dense ones (out, in) -> (in, out). The ResNet-50
and SphereNet-20 converters, `adopt_pretrained_task1` and
`--pretrained-npz` come with their models (ROADMAP Queue 1, items 7 and 8).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.state import CPGState, TaskEntry, resolve_device
from ..models import framework as fw
from ..models import get_model
from ..ops.binarize import PIGGYMASK_INIT

_LATER = {"resnet50": "ROADMAP Queue 1, item 7",
          "spherenet20": "ROADMAP Queue 1, item 8"}


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read a reference .pth/.pth.tar checkpoint into {key: ndarray}: the
    `model_state_dict` | `state_dict` | `model` entry of a torch.save dict,
    or a bare state_dict; a leading 'module.' (DataParallel) is
    stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for k in ("model_state_dict", "state_dict", "model"):
        if isinstance(obj, dict) and k in obj and isinstance(obj[k], dict):
            obj = obj[k]
            break
    out = {}
    for k, v in obj.items():
        if not hasattr(v, "numpy"):
            continue
        out[k[len("module."):] if k.startswith("module.") else k] = _as_np(v)
    return out


def convert_torch_vgg16_bn(state_dict: Dict[str, np.ndarray]):
    """VGG16-BN state_dict (reference custom_vgg / torchvision layout:
    features.N.* with BN after each conv) -> (shared, private, bn_state) in
    this package's naming (models/vgg.py). Order-based: the i-th 4D
    features weight is conv i, the i-th BN parameter set is bn i. The last
    2D weight outside the trunk becomes the classifier head."""
    shared, private, bn = {}, {}, {}
    feats = {}
    for k, v in state_dict.items():
        v = np.asarray(v)
        parts = k.split(".")
        if parts[0] in ("features", "shared"):
            feats.setdefault(int(parts[1]), {})[parts[-1]] = v
    conv_i = bn_i = 0
    for idx in sorted(feats):
        p = feats[idx]
        if "weight" in p and p["weight"].ndim == 4:
            shared[f"features/conv{conv_i}/kernel"] = _t_conv(p["weight"])
            conv_i += 1
        elif "running_mean" in p:
            private[f"features/bn{bn_i}/scale"] = p["weight"]
            private[f"features/bn{bn_i}/bias"] = p["bias"]
            bn[f"features/bn{bn_i}/mean"] = p["running_mean"]
            bn[f"features/bn{bn_i}/var"] = p["running_var"]
            bn_i += 1
    heads = [(k, np.asarray(v)) for k, v in state_dict.items()
             if np.asarray(v).ndim == 2 and not k.startswith(("features.",
                                                              "shared."))]
    if heads:
        k, w = heads[-1]
        private["classifier/kernel"] = w.T
        bkey = k.rsplit(".", 1)[0] + ".bias"
        if bkey in state_dict:
            private["classifier/bias"] = np.asarray(state_dict[bkey])
    return shared, private, bn


def _vgg16_module_maps(state_dict: Dict[str, np.ndarray]):
    """torch module name -> layer base for the VGG16-BN trunk:
    ({'features.0': 'features/conv0', ...}, {'features.1':
    'features/bn0', ...}), order-based as in convert_torch_vgg16_bn."""
    conv_map, bn_map = {}, {}
    feats = {}
    for k, v in state_dict.items():
        parts = k.split(".")
        if parts[0] in ("features", "shared") and len(parts) >= 3:
            feats.setdefault(int(parts[1]),
                             {})[parts[-1]] = (k, np.asarray(v))
    ci = bi = 0
    for idx in sorted(feats):
        p = feats[idx]
        mod = next(iter(p.values()))[0].rsplit(".", 1)[0]
        if "weight" in p and p["weight"][1].ndim == 4:
            conv_map[mod] = f"features/conv{ci}"
            ci += 1
        elif "running_mean" in p:
            bn_map[mod] = f"features/bn{bi}"
            bi += 1
    return conv_map, bn_map


def _lookup(d: Dict, *names, default=None):
    for n in names:
        if isinstance(d, dict) and n in d:
            return d[n]
    return default


def _as_np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def _mod_key(d: Dict, mod: str):
    """A per-module entry keyed 'features.0', 'features.0.weight' or with a
    'module.' prefix."""
    for k in (mod, mod + ".weight", "module." + mod,
              "module." + mod + ".weight"):
        if k in d:
            return d[k]
    return None


def _t_conv(t) -> np.ndarray:
    """torch OIHW -> HWIO (also the conv's masks and piggymasks)."""
    return np.transpose(np.asarray(t), (2, 3, 1, 0))


def _vgg16_adapter(sd):
    conv_map, bn_map = _vgg16_module_maps(sd)
    return {
        "backbone": convert_torch_vgg16_bn(sd),
        "sharable": [(mod, f"{base}/kernel", _t_conv)
                     for mod, base in conv_map.items()],
        "bn_map": bn_map, "head": "classifier",
    }


def convert_torch_cpg_checkpoint(ckpt: Dict, arch: str = "vgg16_bn_cifar",
                                 threshold: float = 5e-3,
                                 device="cuda") -> CPGState:
    """Reference CPG checkpoint dict -> multi-task CPGState on `device`.

    Reads (names as `cpg_tpu` takes them): 'state_dict' |
    'model_state_dict' | 'model' (backbone; its BN entries belong to the
    last dataset), 'masks' ({module: ownership ints, 0 free, k task k}),
    'shared_layer_info' ({dataset: {'piggymask', 'bn_layer_weight',
    'bn_layer_bias', 'bn_layer_running_mean', 'bn_layer_running_var':
    {module: t}}}), 'dataset_history', 'dataset2num_classes',
    'network_width_multiplier' | 'width_mult', and per-dataset heads
    'classifiers.{i}.weight/bias' in the state_dict (else the backbone's
    head for the last task). Tasks are numbered 1.. in history order. A
    task (> 1) with no saved piggymask gets the reference init (1e-2 on
    every entry: it picks every prior weight)."""
    if arch in _LATER:
        raise NotImplementedError(
            f"CPG-checkpoint import of {arch} is not ported to cpg_tpu_torch "
            f"yet ({_LATER[arch]})")
    if arch != "vgg16_bn_cifar":
        raise NotImplementedError(
            f"CPG-checkpoint import supports vgg16_bn_cifar; got {arch!r}")
    dev = resolve_device(device)
    sd = _lookup(ckpt, "state_dict", "model_state_dict", "model",
                 default=ckpt)
    sd = {(k[7:] if k.startswith("module.") else k): _as_np(v)
          for k, v in sd.items() if hasattr(v, "shape")}
    masks = {k: _as_np(v)
             for k, v in (_lookup(ckpt, "masks", "mask") or {}).items()}
    sli = _lookup(ckpt, "shared_layer_info", default={}) or {}
    history = list(_lookup(ckpt, "dataset_history", "datasets",
                           default=list(sli.keys())))
    if not history:
        raise ValueError("checkpoint lists no datasets "
                         "(dataset_history/shared_layer_info empty)")
    d2nc = _lookup(ckpt, "dataset2num_classes", default={}) or {}
    wm = float(_lookup(ckpt, "network_width_multiplier", "width_mult",
                       default=1.0))

    ad = _vgg16_adapter(sd)
    shared, last_private, last_bn = ad["backbone"]
    head = ad["head"]

    def t(a, dtype=None):
        out = torch.from_numpy(np.array(a, copy=True))
        return (out if dtype is None else out.to(dtype)).to(dev)

    ownership = {}
    for mod, key, tr in ad["sharable"]:
        m = _mod_key(masks, mod)
        ownership[key] = (torch.ones(shared[key].shape, dtype=torch.int8,
                                     device=dev) if m is None
                          else t(tr(m).astype(np.int8)))
    state = CPGState(arch=arch, width_mult=wm,
                     shared={k: t(v, torch.float32) for k, v in shared.items()},
                     ownership=ownership, threshold=threshold)

    model_fn, in_shape = get_model(arch)
    for i, ds in enumerate(history):
        tid = i + 1
        info = sli.get(ds, {})
        nc = int(_lookup(d2nc, ds, default=0) or 0)
        hw = _lookup(sd, f"classifiers.{i}.weight")
        hb = _lookup(sd, f"classifiers.{i}.bias")
        if hw is not None:  # torch Linear is (out, in)
            hw = _as_np(hw).T
        if nc == 0 and hw is not None:
            nc = hw.shape[1]
        if nc == 0 and tid == len(history) \
                and f"{head}/kernel" in last_private:
            nc = last_private[f"{head}/kernel"].shape[1]
        if nc == 0:
            raise ValueError(f"cannot determine num_classes for {ds!r}")

        _, priv, bnst = fw.init(torch.Generator().manual_seed(tid), model_fn,
                                torch.zeros((1, *in_shape)), num_classes=nc,
                                mult=wm)
        for src, dst, into in (
                ("bn_layer_weight", "scale", priv),
                ("bn_layer_bias", "bias", priv),
                ("bn_layer_running_mean", "mean", bnst),
                ("bn_layer_running_var", "var", bnst)):
            for mod, ours in ad["bn_map"].items():
                v = _mod_key(_lookup(info, src, default={}) or {}, mod)
                if v is not None:
                    into[f"{ours}/{dst}"] = torch.from_numpy(_as_np(v).copy())
        if tid == len(history):  # backbone private entries: the active task's
            for k, v in last_private.items():
                if not k.startswith(head):
                    priv[k] = torch.from_numpy(np.array(v, copy=True))
            for k, v in last_bn.items():
                bnst[k] = torch.from_numpy(np.array(v, copy=True))
        if hw is not None:
            priv[f"{head}/kernel"] = torch.from_numpy(np.array(hw, copy=True))
            if hb is not None:
                priv[f"{head}/bias"] = torch.from_numpy(_as_np(hb).copy())
        elif tid == len(history) and f"{head}/kernel" in last_private:
            priv[f"{head}/kernel"] = torch.from_numpy(
                np.array(last_private[f"{head}/kernel"], copy=True))
            if f"{head}/bias" in last_private:
                priv[f"{head}/bias"] = torch.from_numpy(
                    np.array(last_private[f"{head}/bias"], copy=True))

        pm = None
        if tid > 1:  # missing -> the reference init (pick everything)
            pmsrc = _lookup(info, "piggymask", "piggymasks", default={}) or {}
            pm = {}
            for mod, key, tr in ad["sharable"]:
                v = _mod_key(pmsrc, mod)
                pm[key] = (t(tr(v), torch.float32) if v is not None else
                           torch.full(tuple(shared[key].shape),
                                      PIGGYMASK_INIT, device=dev))
        state.tasks[tid] = TaskEntry(
            name=str(ds), num_classes=nc, piggymask=pm,
            private={k: v.to(dev) for k, v in priv.items()},
            bn_state={k: v.to(dev) for k, v in bnst.items()},
            meta={"imported": "torch_cpg_checkpoint"})
    return state
