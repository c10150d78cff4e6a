"""Baselines: individual per-task models, PackNet, and PAE.

The counterparts of `cpg_tpu.train.baselines`, thin layers over
run_sequence and Manager:
  * individual models: one fresh model per task; the accuracies become the
    goals CPG must meet (the baseline-acc file);
  * PackNet: prune-and-freeze without piggyback masks (mask_mode
    'packnet': prior weights visible unmasked, none trained);
  * PAE ("pack and expand"): PackNet plus width expansion when a task's
    goal is out of reach — CPG minus the picking masks.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, Optional

from ..models import get_model
from ..utils import LOGGER
from .manager import Manager
from .sequence import (SequenceConfig, _generator, init_state, run_sequence,
                       start_task)
from .step import TrainConfig

log = logging.getLogger(LOGGER)


def train_individual_baselines(arch: str, tasks: Dict[str, Dict],
                               cfg: Optional[TrainConfig] = None,
                               epochs: int = 30, batch_size: int = 128,
                               lr: Optional[float] = None, augment_fn=None,
                               preprocess_fn=None, seed: int = 0,
                               acc_file: Optional[str] = None, *,
                               device="cuda") -> Dict[str, float]:
    """One fresh model per task -> {task: top1}; optionally writes the
    baseline-acc file (JSON)."""
    cfg = cfg or TrainConfig()
    goals = {}
    model_fn, _ = get_model(arch)
    for i, (name, data) in enumerate(tasks.items()):
        state = init_state(arch, _generator(seed + i), device=device, cfg=cfg)
        start_task(state, name, data["num_classes"], _generator(seed + 1000 + i),
                   model_kwargs=data.get("model_kwargs"))
        mgr = Manager(state, model_fn, 1, data, cfg, batch_size=batch_size,
                      augment_fn=augment_fn, preprocess_fn=preprocess_fn,
                      seed=seed, loss_fn=data.get("loss_fn"), device=device)
        res = mgr.train(epochs, base_lr=lr)
        goals[name] = res.acc
        log.info("baseline %s: acc=%.4f", name, res.acc)
    if acc_file:
        os.makedirs(os.path.dirname(acc_file) or ".", exist_ok=True)
        with open(acc_file, "w") as f:
            json.dump(goals, f, indent=1)
    return goals


def run_packnet_sequence(arch, tasks, cfg: Optional[TrainConfig] = None,
                         seq: Optional[SequenceConfig] = None, **kwargs):
    """PackNet comparison row: prune-and-freeze with NO piggyback masks
    (mask_mode 'packnet': every prior task's surviving weight is visible
    unmasked and start_task materialises no masks). The masked-conv and
    dense kernels select through piggymasks, so they refuse this mode."""
    cfg = dataclasses.replace(cfg or TrainConfig(), train_piggymask=False)
    seq = seq or SequenceConfig()
    state = kwargs.pop("state", None)
    mkw = kwargs.pop("model_kwargs", None)
    bhw = kwargs.pop("batch_hw", None)
    if state is None:
        state = init_state(arch, _generator(seq.seed),
                           width_mult=kwargs.pop("width_mult", 1.0),
                           mask_mode="packnet", model_kwargs=mkw,
                           batch_hw=bhw, device=kwargs.get("device", "cuda"),
                           cfg=cfg, init_fn=kwargs.get("init_fn"))
    else:
        state.mask_mode = "packnet"
    return run_sequence(arch, tasks, cfg, seq, state=state, **kwargs)


def run_pae_sequence(arch, tasks, cfg: Optional[TrainConfig] = None,
                     seq: Optional[SequenceConfig] = None, **kwargs):
    """PAE comparison row: PackNet-style prune-and-freeze with no piggyback
    masks, plus the width-expansion ladder when a task's goal is
    unreachable. The fixed-capacity PackNet row is run_packnet_sequence
    with `seq.max_width_mult = 1.0`."""
    seq = seq or SequenceConfig()
    if seq.max_width_mult <= 1.0:
        raise ValueError(
            "PAE is pack-AND-expand: seq.max_width_mult must exceed 1.0 "
            "(use run_packnet_sequence for the fixed-capacity PackNet row)")
    return run_packnet_sequence(arch, tasks, cfg, seq, **kwargs)
