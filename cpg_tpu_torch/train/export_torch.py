"""Export a CPGState into the reference's torch checkpoint layout.

The counterpart of `cpg_tpu.train.export_torch` for `vgg16_bn_cifar` and
`resnet50`, and the inverse of train/pretrained.convert_torch_cpg_checkpoint:
the dict the reference Managers `torch.save` (backbone `state_dict` +
pruner `masks` + per-dataset `shared_layer_info` + dataset history + width
multiplier), so a state can be evaluated by the original PyTorch code or
archived in the format its released checkpoints use. Module names are torchvision
vgg16_bn's `features.N` Sequential indices (conv, bn, relu triplets and
maxpool singletons from the cfg list) and torchvision resnet50's
(`layerL.B.convN`, `layerL.B.downsample.0/.1`) and sphere20a's
(`conv{s}_{j}`, `relu{s}_{j}`, fc5, fc6); conv tensors go HWIO -> OIHW,
SphereNet's fc5 rows from the (H, W, C) flatten back to torch's (C, H, W),
heads to torch Linear's (out, in) except AngleLinear's, which the
reference keeps (in, out). A SphereNet task with a linear head (the face
sequence's later tasks; `cpg_tpu`'s export takes only AngleLinear heads)
is written as a torch Linear, weight and bias.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.state import CPGState
from ..models.resnet import TORCH_MODULES
from ..models.spherenet import _FLAT_HW, TORCH_CONVS, TORCH_PRELUS
from ..models.vgg import CFG_VGG16

_SPH_CONV_MOD = {f"{base}/kernel": mod for mod, base in TORCH_CONVS.items()}
_SPH_SLOPE_MOD = {f"{base}/slope": mod for mod, base in TORCH_PRELUS.items()}
_ARCHS = ("vgg16_bn_cifar", "resnet50", "spherenet20")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _inv_conv(t) -> np.ndarray:
    """HWIO -> torch OIHW (kernels, ownership masks, piggymasks alike)."""
    return np.transpose(_np(t), (3, 2, 0, 1))


def _inv_fc5(t) -> np.ndarray:
    """(h*w*c, out), flattened NHWC -> torch (out, c*h*w), flattened NCHW
    (the kernel, its ownership and its piggymasks)."""
    t = _np(t)
    h, w = _FLAT_HW
    c = t.shape[0] // (h * w)
    return (t.reshape(h, w, c, t.shape[1]).transpose(2, 0, 1, 3)
            .reshape(c * h * w, t.shape[1]).T)


def _sph_conv_mod(key: str):
    """SphereNet-20 shared key -> (sphere20a module, inverse transform)."""
    if key == "fc5/kernel":
        return "fc5", _inv_fc5
    return _SPH_CONV_MOD[key], _inv_conv


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
    """(shared key -> (module, inverse transform), BN layer -> BN module)
    for the arch."""
    if arch == "resnet50":
        return (lambda key: (_rn_conv_mod(key), _inv_conv),
                TORCH_MODULES.__getitem__)
    if arch == "spherenet20":
        return _sph_conv_mod, None
    conv_mods, bn_mods = _vgg_mods()

    def conv_mod(key):
        return conv_mods[int(key.split("/")[1][len("conv"):])], _inv_conv

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
    if state.arch not in _ARCHS:
        raise NotImplementedError(
            f"torch export supports {'/'.join(_ARCHS)}; got "
            f"{state.arch!r}")
    conv_mod, bn_mod = _module_maps(state.arch)

    sd: Dict[str, np.ndarray] = {}
    masks: Dict[str, np.ndarray] = {}
    for key in sorted(state.shared):
        mod, inv = conv_mod(key)
        sd[f"{mod}.weight"] = inv(state.shared[key])
        masks[mod] = inv(state.ownership[key])

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
            elif key.endswith("/slope"):
                info.setdefault("prelu_layer_weight", {})[
                    _SPH_SLOPE_MOD[key]] = _np(t.private[key])
            elif key == "fc5/bias":
                info.setdefault("bias", {})["fc5"] = _np(t.private[key])
        if t.piggymask is not None:
            pm = {}
            for key in sorted(t.piggymask):
                mod, inv = conv_mod(key)
                pm[mod] = inv(t.piggymask[key])
            info["piggymask"] = pm
        sli[t.name] = info
        # per-dataset head: torch Linear (out, in); AngleLinear (in, out)
        if "classifier_angle/kernel" in t.private:
            sd[f"classifiers.{tid - 1}.weight"] = _np(
                t.private["classifier_angle/kernel"])
        else:
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
        elif key.endswith("/slope"):
            sd[f"{_SPH_SLOPE_MOD[key]}.weight"] = _np(last.private[key])
        elif key == "fc5/bias":
            sd["fc5.bias"] = _np(last.private[key])
    if "classifier_angle/kernel" in last.private:
        sd["fc6.weight"] = _np(last.private["classifier_angle/kernel"])

    return {
        "state_dict": sd,
        "masks": masks,
        "shared_layer_info": sli,
        "dataset_history": [state.tasks[tid].name for tid in task_ids],
        "dataset2num_classes": {t.name: t.num_classes
                                for t in state.tasks.values()},
        "network_width_multiplier": state.width_mult,
    }
