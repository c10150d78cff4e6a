"""Fine-grained classification datasets (the ResNet-50 sequence).

The counterpart of `cpg_tpu.data.finegrained`, numpy only: CUBS (200
classes), Stanford Cars (196), Flowers (102), WikiArt (195) and Sketch
(250), added one after another on top of an ImageNet-pretrained task 1.
`finegrained_task` reads, in this order, an ImageFolder tree
`$CPG_DATA_DIR/<name>/{train,test}/<class>/*.jpg` (data/imagefolder.py),
then `$CPG_DATA_DIR/<name>/{train,test}.npz` (x uint8 NHWC, y int32), and
otherwise makes a synthetic stand-in with the right class count (capped by
`max_classes`), byte for byte `cpg_tpu`'s for the same seed.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

# dataset -> number of classes (the reference's five fine-grained tasks)
FINEGRAINED_SPECS = {
    "cubs_cropped": 200,
    "stanford_cars_cropped": 196,
    "flowers": 102,
    "wikiart": 195,
    "sketches": 250,
}
IMAGE_HW = (224, 224)


def _load_npz(d: str, name: str):
    """(train x, train y, test x, test y) from `d/name/{train,test}.npz`, or
    None when either file is missing."""
    p = os.path.join(d, name)
    tr, te = os.path.join(p, "train.npz"), os.path.join(p, "test.npz")
    if os.path.exists(tr) and os.path.exists(te):
        a, b = np.load(tr), np.load(te)
        return (a["x"], a["y"].astype(np.int32),
                b["x"], b["y"].astype(np.int32))
    return None


def synthetic_imagefolder(num_classes, n_train_per=8, n_test_per=2,
                          hw=IMAGE_HW, seed=0):
    """Seeded stand-in images: a blocky (16-px) prototype a class plus
    Gaussian noise, clipped to uint8; (train x, train y, test x, test y),
    each split shuffled."""
    rng = np.random.RandomState(seed)
    h, w = hw
    protos = rng.randn(num_classes, h // 16, w // 16, 3).astype(np.float32) * 3
    protos = np.repeat(np.repeat(protos, 16, axis=1), 16, axis=2)

    def make(n_per):
        xs, ys = [], []
        for c in range(num_classes):
            img = protos[c] + rng.randn(n_per, h, w, 3).astype(np.float32)
            xs.append(np.clip((img + 12.0) / 24.0 * 255, 0, 255)
                      .astype(np.uint8))
            ys.append(np.full(n_per, c, np.int32))
        x, y = np.concatenate(xs), np.concatenate(ys)
        p = rng.permutation(len(x))
        return x[p], y[p]

    tx, ty = make(n_train_per)
    vx, vy = make(n_test_per)
    return tx, ty, vx, vy


def finegrained_task(name: str, data_dir: Optional[str] = None,
                     max_classes: Optional[int] = None, seed: int = 0,
                     hw=IMAGE_HW) -> Dict:
    """One task's {train_x, train_y, test_x, test_y, num_classes}."""
    if name not in FINEGRAINED_SPECS:
        raise KeyError(f"unknown fine-grained dataset {name!r}")
    nc = FINEGRAINED_SPECS[name]
    d = data_dir or os.environ.get("CPG_DATA_DIR")
    if d and os.path.isdir(os.path.join(d, name)):
        from .imagefolder import imagefolder_splits

        fold = imagefolder_splits(os.path.join(d, name), hw=hw)
        if fold is not None:
            fold["num_classes"] = max(fold["num_classes"], 1)
            return {k: fold[k] for k in
                    ("train_x", "train_y", "test_x", "test_y", "num_classes")}
    data = _load_npz(d, name) if d else None
    if data is None:
        nc = min(nc, max_classes) if max_classes else nc
        data = synthetic_imagefolder(nc, hw=hw, seed=seed)
    tx, ty, vx, vy = data
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy,
            "num_classes": nc}
