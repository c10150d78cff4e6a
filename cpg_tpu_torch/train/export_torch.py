"""Export a CPGState into the reference's torch checkpoint layout.

The counterpart of `cpg_tpu.train.export_torch` for `vgg16_bn_cifar` and
`resnet50`, and the inverse of train/pretrained.convert_torch_cpg_checkpoint:
the dict the reference Managers `torch.save` (backbone `state_dict` +
pruner `masks` + per-dataset `shared_layer_info` + dataset history + width
multiplier), so a state can be evaluated by the original PyTorch code or
archived in the format its released checkpoints use. Module names are torchvision
vgg16_bn's `features.N` Sequential indices (conv, bn, relu triplets and
maxpool singletons from the cfg list) and torchvision resnet50's
(`layerL.B.convN`, `layerL.B.downsample.0/.1`); conv tensors go HWIO ->
OIHW, heads to torch Linear's (out, in). SphereNet-20 comes with its model
(ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.state import CPGState
from ..models.resnet import TORCH_MODULES
from ..models.vgg import CFG_VGG16

_LATER = {"spherenet20": "ROADMAP Queue 1, item 8"}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _inv_conv(t) -> np.ndarray:
    """HWIO -> torch OIHW (kernels, ownership masks, piggymasks alike)."""
    return np.transpose(_np(t), (3, 2, 0, 1))


def _vgg_mods():
    """cpg index -> torch Sequential module, from the shared cfg list."""
    conv_mods, bn_mods, idx = [], [], 0
    for v in CFG_VGG16:
        if v == "M":
            idx += 1
            continue
        conv_mods.append(f"features.{idx}")
        bn_mods.append(f"features.{idx + 1}")
        idx += 3  # conv, bn, relu
    return conv_mods, bn_mods


def _rn_conv_mod(key: str) -> str:
    """ResNet-50 shared key -> torchvision module name."""
    return TORCH_MODULES[key.rsplit("/", 1)[0]]


def _module_maps(arch: str):
    """(shared key -> conv module, BN layer -> BN module) for the arch."""
    if arch == "resnet50":
        return _rn_conv_mod, TORCH_MODULES.__getitem__
    conv_mods, bn_mods = _vgg_mods()

    def conv_mod(key):
        return conv_mods[int(key.split("/")[1][len("conv"):])]

    def bn_mod(base):
        return bn_mods[int(base.split("/")[1][len("bn"):])]

    return conv_mod, bn_mod


def torch_resnet50_state_dict(shared: Dict, private: Dict,
                              bn_state: Dict) -> Dict[str, np.ndarray]:
    """One ResNet-50 net's (shared, private, bn_state) in this package's
    naming -> a torchvision `resnet50` state_dict of numpy arrays (the
    inverse of pretrained.convert_torch_resnet50; the head becomes `fc`)."""
    sd: Dict[str, np.ndarray] = {}
    for key, w in shared.items():
        sd[f"{_rn_conv_mod(key)}.weight"] = _inv_conv(w)
    for key, v in private.items():
        if key.startswith("classifier/"):
            leaf = "weight" if key.endswith("/kernel") else "bias"
            sd[f"fc.{leaf}"] = _np(v).T if leaf == "weight" else _np(v)
        else:
            base, leaf = key.rsplit("/", 1)
            sd[f"{TORCH_MODULES[base]}.{'weight' if leaf == 'scale' else leaf}"] \
                = _np(v)
    for key, v in bn_state.items():
        base, leaf = key.rsplit("/", 1)
        sd[f"{TORCH_MODULES[base]}.running_{leaf}"] = _np(v)
    return sd


def export_torch_cpg_checkpoint(state: CPGState) -> Dict:
    """CPGState -> reference torch.save dict of numpy arrays (feed it to
    torch.save, or straight back to convert_torch_cpg_checkpoint).

    The backbone state_dict carries the last (active) task's BN values, as
    the reference Manager leaves them after training the newest task;
    every task's copies, piggymasks and heads ride `shared_layer_info` and
    `classifiers.{i}`, as the reference's save_checkpoint writes them."""
    if state.arch in _LATER:
        raise NotImplementedError(
            f"torch export of {state.arch} is not ported to cpg_tpu_torch "
            f"yet ({_LATER[state.arch]})")
    if state.arch not in ("vgg16_bn_cifar", "resnet50"):
        raise NotImplementedError(
            f"torch export supports vgg16_bn_cifar and resnet50; got "
            f"{state.arch!r}")
    conv_mod, bn_mod = _module_maps(state.arch)

    sd: Dict[str, np.ndarray] = {}
    masks: Dict[str, np.ndarray] = {}
    for key in sorted(state.shared):
        sd[f"{conv_mod(key)}.weight"] = _inv_conv(state.shared[key])
        masks[conv_mod(key)] = _inv_conv(state.ownership[key])

    task_ids = sorted(state.tasks)
    sli: Dict[str, Dict] = {}
    for tid in task_ids:
        t = state.tasks[tid]
        info: Dict[str, Dict] = {}
        for key in sorted(t.private):
            if key.endswith("/scale"):
                base = key[:-len("/scale")]
                mod = bn_mod(base)
                info.setdefault("bn_layer_weight", {})[mod] = _np(
                    t.private[key])
                info.setdefault("bn_layer_bias", {})[mod] = _np(
                    t.private[f"{base}/bias"])
                info.setdefault("bn_layer_running_mean", {})[mod] = _np(
                    t.bn_state[f"{base}/mean"])
                info.setdefault("bn_layer_running_var", {})[mod] = _np(
                    t.bn_state[f"{base}/var"])
        if t.piggymask is not None:
            info["piggymask"] = {conv_mod(key): _inv_conv(t.piggymask[key])
                                 for key in sorted(t.piggymask)}
        sli[t.name] = info
        sd[f"classifiers.{tid - 1}.weight"] = _np(
            t.private["classifier/kernel"]).T
        if "classifier/bias" in t.private:
            sd[f"classifiers.{tid - 1}.bias"] = _np(
                t.private["classifier/bias"])

    last = state.tasks[task_ids[-1]]
    for key in sorted(last.private):
        if key.endswith("/scale"):
            base = key[:-len("/scale")]
            mod = bn_mod(base)
            sd[f"{mod}.weight"] = _np(last.private[key])
            sd[f"{mod}.bias"] = _np(last.private[f"{base}/bias"])
            sd[f"{mod}.running_mean"] = _np(last.bn_state[f"{base}/mean"])
            sd[f"{mod}.running_var"] = _np(last.bn_state[f"{base}/var"])

    return {
        "state_dict": sd,
        "masks": masks,
        "shared_layer_info": sli,
        "dataset_history": [state.tasks[tid].name for tid in task_ids],
        "dataset2num_classes": {t.name: t.num_classes
                                for t in state.tasks.values()},
        "network_width_multiplier": state.width_mult,
    }
