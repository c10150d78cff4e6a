"""Reference torch checkpoints and pretrained weights into CPG states
(VGG16-BN, ResNet-50 and SphereNet-20).

The counterpart of part of `cpg_tpu.train.pretrained`: `load_torch_checkpoint`
(a .pth/.pth.tar file as {key: ndarray}), `convert_torch_vgg16_bn`,
`convert_torch_resnet50` and `convert_torch_spherenet20` (a VGG16-BN,
torchvision ResNet-50 or sphere20a state_dict in this package's naming),
`adopt_pretrained_task1` (pretrained weights as a fresh state's task 1: the
fine-grained sequence's ImageNet task) and `convert_torch_cpg_checkpoint`
(the reference's whole CPG checkpoint: backbone state_dict + pruner `masks`
+ per-dataset `shared_layer_info` + dataset history + width multiplier ->
a multi-task CPGState). Conv tensors go torch OIHW -> HWIO, dense ones
(out, in) -> (in, out); SphereNet's fc5 also has its rows permuted from
torch's (C, H, W) flatten to this package's (H, W, C).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.ownership import assign_free_to_task
from ..core.state import CPGState, TaskEntry, resolve_device
from ..models import framework as fw
from ..models import get_model
from ..models.resnet import TORCH_MODULES
from ..models.spherenet import _FLAT_HW, TORCH_CONVS, TORCH_PRELUS
from ..ops.binarize import PIGGYMASK_INIT


def adopt_pretrained_task1(state: CPGState, name: str, num_classes: int,
                           shared: Dict[str, np.ndarray],
                           private: Optional[Dict[str, np.ndarray]] = None,
                           bn_state: Optional[Dict[str, np.ndarray]] = None
                           ) -> int:
    """Install pretrained weights as task 1 of a fresh state: every shared
    entry becomes owned by task 1 (the whole pretrained net belongs to the
    first task). Private and BN entries come from `private` and
    `bn_state` where given, a private entry whose shape differs from the
    model's (a head of another class count) is skipped, and the rest are
    this package's fresh init at generator seed 0."""
    if state.num_tasks != 0:
        raise ValueError("pretrained adoption requires a fresh state")
    dev = next(iter(state.shared.values())).device
    for k, w in shared.items():
        if k not in state.shared:
            raise KeyError(f"pretrained key {k} not in model: "
                           f"{sorted(state.shared)[:3]}...")
        if tuple(w.shape) != tuple(state.shared[k].shape):
            raise ValueError(f"{k}: {tuple(w.shape)} != "
                             f"{tuple(state.shared[k].shape)}")
        state.shared[k] = _tensor(w, torch.float32).to(dev)
    state.ownership = assign_free_to_task(state.ownership, 1)
    model_fn, in_shape = get_model(state.arch)
    _, priv0, bn0 = fw.init(torch.Generator().manual_seed(0), model_fn,
                            torch.zeros((1, *(state.in_shape or in_shape))),
                            num_classes=num_classes, mult=state.width_mult,
                            **state.forward_kwargs())
    for k, v in (private or {}).items():
        if k in priv0 and tuple(v.shape) != tuple(priv0[k].shape):
            continue
        priv0[k] = _tensor(v)
    for k, v in (bn_state or {}).items():
        bn0[k] = _tensor(v)
    state.tasks[1] = TaskEntry(
        name=name, num_classes=num_classes, piggymask=None,
        private={k: v.to(dev) for k, v in priv0.items()},
        bn_state={k: v.to(dev) for k, v in bn0.items()})
    return 1


def _tensor(v, dtype=None) -> torch.Tensor:
    """A contiguous CPU tensor copy of an array or tensor (its dtype unless
    given): the converters hand over transposed views, and the kernels
    take contiguous weights only."""
    t = torch.from_numpy(np.array(_as_np(v), copy=True, order="C"))
    return t if dtype is None else t.to(dtype)


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


_RN_BASE = {mod: base for base, mod in TORCH_MODULES.items()}


def convert_torch_resnet50(state_dict: Dict[str, np.ndarray]):
    """torchvision ResNet-50 state_dict -> (shared, private, bn_state) in
    this package's naming (models/resnet.py): `layerL.B.convN` ->
    `layerL/blockB/convN`, `layerL.B.downsample.0/.1` -> `.../downsample`
    and `.../downsample_bn`, `fc` -> the classifier head; keys of other
    modules are ignored."""
    shared, private, bn = {}, {}, {}
    for k, v in state_dict.items():
        v = np.asarray(v)
        if k.startswith("fc."):
            if k.endswith("weight"):
                private["classifier/kernel"] = v.T
            else:
                private["classifier/bias"] = v
            continue
        mod, _, leaf = k.rpartition(".")
        base = _RN_BASE.get(mod)
        if base is None:
            continue
        if leaf == "weight" and v.ndim == 4:
            shared[f"{base}/kernel"] = _t_conv(v)
        elif leaf == "weight":
            private[f"{base}/scale"] = v
        elif leaf == "bias":
            private[f"{base}/bias"] = v
        elif leaf == "running_mean":
            bn[f"{base}/mean"] = v
        elif leaf == "running_var":
            bn[f"{base}/var"] = v
    return shared, private, bn


def _t_fc5(t) -> np.ndarray:
    """SphereNet fc5 (its weight and masks): torch (out, c*h*w), flattened
    NCHW -> (h*w*c, out), flattened NHWC."""
    t = np.asarray(t)
    h, w = _FLAT_HW
    c = t.shape[1] // (h * w)
    return (t.T.reshape(c, h, w, t.shape[0]).transpose(1, 2, 0, 3)
            .reshape(h * w * c, t.shape[0]))


def convert_torch_spherenet20(state_dict: Dict[str, np.ndarray]):
    """sphere20a state_dict (`conv{s}_{j}`, `relu{s}_{j}`, fc5, fc6) ->
    (shared, private, bn_state={}) in this package's naming
    (models/spherenet.py): the 20 convs and fc5 shared, the PReLU slopes,
    fc5's bias and the AngleLinear head (fc6, kept (in, out) as the
    reference stores it) private. fc5's rows are permuted, not only
    transposed: torch flattens (c, h, w), this package (h, w, c)."""
    shared, private = {}, {}
    for mod, base in TORCH_CONVS.items():
        shared[f"{base}/kernel"] = _t_conv(state_dict[f"{mod}.weight"])
    for mod, base in TORCH_PRELUS.items():
        private[f"{base}/slope"] = np.asarray(state_dict[f"{mod}.weight"])
    fc5 = np.asarray(state_dict["fc5.weight"])
    shared["fc5/kernel"] = _t_fc5(fc5)
    if "fc5.bias" in state_dict:
        private["fc5/bias"] = np.asarray(state_dict["fc5.bias"])
    if "fc6.weight" in state_dict:
        w6 = np.asarray(state_dict["fc6.weight"])
        private["classifier_angle/kernel"] = (
            w6 if w6.shape[0] == fc5.shape[0] else w6.T)
    return shared, private, {}


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
        "bn_map": bn_map, "prelu_map": {}, "bias_map": {},
        "head": "classifier",
    }


def _resnet50_adapter(sd):
    """torchvision module names of ResNet-50's sharable convs and BNs."""
    sharable, bn_map = [], {}
    for k, v in sd.items():
        mod = k.rpartition(".")[0]
        base = _RN_BASE.get(mod)
        if base is None:
            continue
        if k.endswith(".weight") and np.asarray(v).ndim == 4:
            sharable.append((mod, f"{base}/kernel", _t_conv))
        elif k.endswith(".running_mean"):
            bn_map[mod] = base
    return {"backbone": convert_torch_resnet50(sd), "sharable": sharable,
            "bn_map": bn_map, "prelu_map": {}, "bias_map": {},
            "head": "classifier"}


def _sphere20_adapter(sd):
    """sphere20a's sharable modules (the 20 convs and fc5), PReLUs and
    fc5's bias; the heads are AngleLinear (`classifier_angle`)."""
    sharable = [(mod, f"{base}/kernel", _t_conv)
                for mod, base in TORCH_CONVS.items()]
    sharable.append(("fc5", "fc5/kernel", _t_fc5))
    return {"backbone": convert_torch_spherenet20(sd), "sharable": sharable,
            "bn_map": {},
            "prelu_map": {mod: f"{base}/slope"
                          for mod, base in TORCH_PRELUS.items()},
            "bias_map": {"fc5": "fc5/bias"}, "head": "classifier_angle"}


_ADAPTERS = {"vgg16_bn_cifar": _vgg16_adapter, "resnet50": _resnet50_adapter,
             "spherenet20": _sphere20_adapter}


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
    every entry: it picks every prior weight).

    SphereNet-20 (`cpg_tpu`'s adapter): PReLU slopes from
    `prelu_layer_weight`, fc5's bias from `bias`, and AngleLinear heads
    stored (in, out). A head with a `classifiers.{i}.bias` is a plain
    torch Linear (the face sequence's later tasks): it becomes the task's
    linear `classifier` head, the task's forward kwargs head_type
    'linear'; `cpg_tpu` reads every SphereNet head as AngleLinear."""
    if arch not in _ADAPTERS:
        raise NotImplementedError(
            f"CPG-checkpoint import supports {sorted(_ADAPTERS)}; got "
            f"{arch!r}")
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

    ad = _ADAPTERS[arch](sd)
    shared, last_private, last_bn = ad["backbone"]
    head = ad["head"]

    def t(a, dtype=None):
        return _tensor(a, dtype).to(dev)

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
    emb = shared["fc5/kernel"].shape[1] if "fc5/kernel" in shared else None
    for i, ds in enumerate(history):
        tid = i + 1
        info = sli.get(ds, {})
        nc = int(_lookup(d2nc, ds, default=0) or 0)
        hw = _lookup(sd, f"classifiers.{i}.weight")
        hb = _lookup(sd, f"classifiers.{i}.bias")
        thead, mkw = head, {}
        if head == "classifier_angle" and hb is not None:
            thead, mkw = "classifier", {"head_type": "linear"}
        if hw is not None:  # torch Linear is (out, in); AngleLinear may be
            hw = _as_np(hw)  # (in, out) already
            hw = hw if (thead == "classifier_angle"
                        and hw.shape[0] == emb) else hw.T
        if nc == 0 and hw is not None:
            nc = hw.shape[1]
        if nc == 0 and tid == len(history) \
                and f"{head}/kernel" in last_private:
            nc = last_private[f"{head}/kernel"].shape[1]
        if nc == 0:
            raise ValueError(f"cannot determine num_classes for {ds!r}")

        _, priv, bnst = fw.init(torch.Generator().manual_seed(tid), model_fn,
                                torch.zeros((1, *in_shape)), num_classes=nc,
                                mult=wm, **mkw)
        for src, dst, into in (
                ("bn_layer_weight", "scale", priv),
                ("bn_layer_bias", "bias", priv),
                ("bn_layer_running_mean", "mean", bnst),
                ("bn_layer_running_var", "var", bnst)):
            for mod, ours in ad["bn_map"].items():
                v = _mod_key(_lookup(info, src, default={}) or {}, mod)
                if v is not None:
                    into[f"{ours}/{dst}"] = _tensor(v)
        for src, names in ((("prelu_layer_weight", "prelu"), ad["prelu_map"]),
                           (("bias", "biases"), ad["bias_map"])):
            vals = _lookup(info, *src, default={}) or {}
            for mod, ours in names.items():
                v = _mod_key(vals, mod)
                if v is not None:
                    priv[ours] = _tensor(v)
        if tid == len(history):  # backbone private entries: the active task's
            for k, v in last_private.items():
                if not k.startswith(head):
                    priv[k] = _tensor(v)
            for k, v in last_bn.items():
                bnst[k] = _tensor(v)
        if hw is not None:
            priv[f"{thead}/kernel"] = _tensor(hw)
            if hb is not None and thead == "classifier":
                priv[f"{thead}/bias"] = _tensor(hb)
        elif tid == len(history) and f"{head}/kernel" in last_private:
            priv[f"{head}/kernel"] = _tensor(last_private[f"{head}/kernel"])
            if f"{head}/bias" in last_private:
                priv[f"{head}/bias"] = _tensor(last_private[f"{head}/bias"])

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
            meta={"imported": "torch_cpg_checkpoint",
                  **({"model_kwargs": mkw} if mkw else {})})
    return state
