"""CIFAR-100 20-task continual split + loaders (numpy only).

The counterpart of `cpg_tpu.data.cifar`, the same code: the 20 tasks are the
20 CIFAR-100 coarse superclasses, each holding its 5 fine classes relabeled
0..4, in superclass-name order. The same seed gives the same arrays, bit for
bit, and `iterate_batches` the same `np.random.RandomState` batch order.

Nothing is downloaded: `load_cifar100` parses the standard
`cifar-100-python` pickles under `$CPG_DATA_DIR` (the only place the port
looks); otherwise `synthetic_cifar100` generates a deterministic stand-in,
class-conditional blobs with enough structure that training and pruning
behave meaningfully. The pickles are the dataset's own files; unpickle only
a copy you trust.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

# Official CIFAR-100 fine-label -> coarse-label mapping (fine index 0..99).
FINE_TO_COARSE = np.array([
    4, 1, 14, 8, 0, 6, 7, 7, 18, 3,
    3, 14, 9, 18, 7, 11, 3, 9, 7, 11,
    6, 11, 5, 10, 7, 6, 13, 15, 3, 15,
    0, 11, 1, 10, 12, 14, 16, 9, 11, 5,
    5, 19, 8, 8, 15, 13, 14, 17, 18, 10,
    16, 4, 17, 4, 2, 0, 17, 4, 18, 17,
    10, 3, 2, 12, 12, 16, 12, 1, 9, 19,
    2, 10, 0, 1, 16, 12, 9, 13, 15, 13,
    16, 19, 2, 4, 6, 19, 5, 5, 8, 19,
    18, 1, 2, 15, 6, 0, 17, 8, 14, 13,
])

# The 20 superclass (task) names in coarse-label index order — these are the
# --dataset names the reference's experiment scripts loop over.
SUPERCLASS_NAMES = [
    "aquatic_mammals", "fish", "flowers", "food_containers",
    "fruit_and_vegetables", "household_electrical_devices",
    "household_furniture", "insects", "large_carnivores",
    "large_man-made_outdoor_things", "large_natural_outdoor_scenes",
    "large_omnivores_and_herbivores", "medium_mammals",
    "non-insect_invertebrates", "people", "reptiles", "small_mammals",
    "trees", "vehicles_1", "vehicles_2",
]

NUM_TASKS = 20
CLASSES_PER_TASK = 5


def find_cifar100_dir() -> Optional[str]:
    """`$CPG_DATA_DIR/cifar-100-python` when it holds the `train` pickle."""
    base = os.environ.get("CPG_DATA_DIR")
    if not base:
        return None
    d = os.path.join(base, "cifar-100-python")
    return d if os.path.exists(os.path.join(d, "train")) else None


def load_cifar100(path: Optional[str] = None):
    """Parse the standard cifar-100-python pickles (no torchvision needed).

    Returns (train_x u8 NHWC, train_fine, test_x, test_fine) or None.
    """
    d = path or find_cifar100_dir()
    if d is None:
        return None
    out = []
    for split in ("train", "test"):
        with open(os.path.join(d, split), "rb") as f:
            raw = pickle.load(f, encoding="bytes")
        x = raw[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC u8
        y = np.asarray(raw[b"fine_labels"], np.int32)
        out += [np.ascontiguousarray(x), y]
    return tuple(out)


def synthetic_cifar100(
    n_train_per_class: int = 100, n_test_per_class: int = 20, seed: int = 0,
    noise: float = 0.9,
):
    """Deterministic stand-in with learnable class structure.

    Each fine class gets a random low-frequency prototype image; samples are
    prototype + noise, quantized to uint8. Linearly separable enough that a
    CNN trains to high accuracy quickly, hard enough that pruning too far
    visibly drops accuracy. `noise` scales the per-sample Gaussian: the
    default 0.9 saturates in tens of steps; raising it stretches sample
    complexity so experiments that need a graded (non-saturated) accuracy
    regime — e.g. the width-aware post-growth budget study — have one.
    """
    rng = np.random.RandomState(seed)
    protos = rng.randn(100, 8, 8, 3).astype(np.float32)
    protos = np.repeat(np.repeat(protos, 4, axis=1), 4, axis=2)  # 32x32 blocks

    def make(n_per):
        xs, ys = [], []
        for c in range(100):
            eps = rng.randn(n_per, 32, 32, 3).astype(np.float32) * noise
            img = protos[c] * 0.6 + eps
            # fixed affine quantization: keep train/test contrast identical
            img = np.clip((img + 4.0) / 8.0 * 255.0, 0, 255).astype(np.uint8)
            xs.append(img)
            ys.append(np.full(n_per, c, np.int32))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        p = rng.permutation(len(x))
        return x[p], y[p]

    train_x, train_y = make(n_train_per_class)
    test_x, test_y = make(n_test_per_class)
    return train_x, train_y, test_x, test_y


def task_splits(
    data=None, synthetic_kwargs: Optional[Dict] = None
) -> Dict[str, Dict[str, np.ndarray]]:
    """Split CIFAR-100 into the 20 superclass tasks.

    Returns {task_name: {train_x, train_y, test_x, test_y}} with labels
    relabeled 0..4 inside each task (fine classes sorted by fine index,
    matching the reference's ImageFolder-alphabetical convention only up to
    task-internal ordering, which is irrelevant to accuracy).
    """
    if data is None:
        data = load_cifar100()
    if data is None:
        data = synthetic_cifar100(**(synthetic_kwargs or {}))
    train_x, train_y, test_x, test_y = data
    coarse_tr = FINE_TO_COARSE[train_y]
    coarse_te = FINE_TO_COARSE[test_y]
    tasks = {}
    for t in range(NUM_TASKS):
        fine_ids = np.sort(np.where(FINE_TO_COARSE == t)[0])
        relabel = {int(f): i for i, f in enumerate(fine_ids)}
        tr = coarse_tr == t
        te = coarse_te == t
        tasks[SUPERCLASS_NAMES[t]] = {
            "train_x": train_x[tr],
            "train_y": np.array([relabel[int(f)] for f in train_y[tr]], np.int32),
            "test_x": test_x[te],
            "test_y": np.array([relabel[int(f)] for f in test_y[te]], np.int32),
            "num_classes": CLASSES_PER_TASK,
        }
    return tasks


def iterate_batches(x, y, batch_size, rng: np.random.RandomState, train=True,
                    drop_remainder=True):
    """Host-side batch iterator (shuffled by `rng` when training); the
    evaluation padding keeps batch shapes static."""
    n = len(x)
    idx = rng.permutation(n) if train else np.arange(n)
    if not train and not drop_remainder and n % batch_size:
        pad = batch_size - n % batch_size
        idx = np.concatenate([idx, idx[:pad]])
    stop = len(idx) - (len(idx) % batch_size)
    for i in range(0, stop, batch_size):
        b = idx[i : i + batch_size]
        yield x[b], y[b]
