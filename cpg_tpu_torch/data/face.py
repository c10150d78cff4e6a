"""Face data: CASIA-style identity training and LFW pair verification.

The counterpart of `cpg_tpu.data.face`, numpy except `eval_pairs`: the
first face task trains on aligned 112x96 CASIA-WebFace crops, scaled
(x - 127.5) / 128 with a random flip (data/augment.py); verification runs
the LFW protocol: feature = concat(net(img), net(hflip(img))), cosine
similarity, a threshold chosen by 10-fold cross-validation.

`casia_task` reads `$CPG_DATA_DIR/casia/<identity>/*.jpg`, then
`$CPG_DATA_DIR/casia_train.npz` (x uint8 NHWC, y int32), and otherwise
makes seeded synthetic identities, byte for byte `cpg_tpu`'s for the same
seed. `load_lfw_pairs` reads the official pairs.txt beside the LFW image
tree.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

INPUT_HW = (112, 96)


def synthetic_faces(num_ids=32, per_id=12, hw=INPUT_HW, seed=0):
    """Identity-prototype faces: a blocky (8-px) template an identity plus
    per-image noise, clipped to uint8, shuffled."""
    rng = np.random.RandomState(seed)
    h, w = hw
    protos = rng.randn(num_ids, h // 8, w // 8, 3).astype(np.float32) * 2.5
    protos = np.repeat(np.repeat(protos, 8, axis=1), 8, axis=2)
    xs, ys = [], []
    for i in range(num_ids):
        jitter = rng.randn(per_id, h, w, 3).astype(np.float32)
        img = protos[i] + jitter
        img = np.clip((img + 10.0) / 20.0 * 255.0, 0, 255).astype(np.uint8)
        xs.append(img)
        ys.append(np.full(per_id, i, np.int32))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    p = rng.permutation(len(x))
    return x[p], y[p]


def make_pairs(x, y, n_pairs=300, seed=0):
    """LFW-style verification pairs (i1, i2, same): half of one identity,
    half of two."""
    rng = np.random.RandomState(seed)
    by_id: Dict[int, list] = {}
    for i, lab in enumerate(y):
        by_id.setdefault(int(lab), []).append(i)
    ids = [k for k, v in by_id.items() if len(v) >= 2]
    i1, i2, same = [], [], []
    for _ in range(n_pairs // 2):
        k = ids[rng.randint(len(ids))]
        a, b = rng.choice(by_id[k], 2, replace=False)
        i1.append(a)
        i2.append(b)
        same.append(1)
        ka, kb = rng.choice(len(ids), 2, replace=False)
        i1.append(rng.choice(by_id[ids[ka]]))
        i2.append(rng.choice(by_id[ids[kb]]))
        same.append(0)
    return np.array(i1), np.array(i2), np.array(same, np.int32)


def casia_task(seed=0, num_ids=32, per_id=12, data_dir: Optional[str] = None
               ) -> Dict:
    """The face-recognition task: {train_x, train_y, test_x, test_y,
    num_classes, model_kwargs: {head_type: angle}}, the last tenth of the
    images held out."""
    d = data_dir or os.environ.get("CPG_DATA_DIR")
    if d and os.path.isdir(os.path.join(d, "casia")):
        from .imagefolder import load_imagefolder

        x, y, _ = load_imagefolder(os.path.join(d, "casia"), hw=INPUT_HW,
                                   resize=None)
    elif d and os.path.exists(os.path.join(d, "casia_train.npz")):
        with np.load(os.path.join(d, "casia_train.npz")) as z:
            x, y = z["x"], z["y"].astype(np.int32)
    else:
        x, y = synthetic_faces(num_ids, per_id, seed=seed)
    cut = int(len(x) * 0.9)
    return {
        "train_x": x[:cut], "train_y": y[:cut],
        "test_x": x[cut:], "test_y": y[cut:],
        "num_classes": int(y.max()) + 1,
        "model_kwargs": {"head_type": "angle"},
    }


def parse_lfw_pairs(pairs_path: str):
    """The official LFW pairs.txt: a header "<n_folds>\\t<n_per_fold>" (or
    none: 10 folds of 300), then per fold n_per_fold same-identity lines
    "name idx1 idx2" and n_per_fold different-identity lines "name1 idx1
    name2 idx2". Returns [(rel_path1, rel_path2, same)] in file order."""
    with open(pairs_path) as f:
        lines = [ln.split() for ln in f.read().strip().splitlines()
                 if ln.strip()]
    header = lines[0]
    n_folds, n_per = ((int(header[0]), int(header[1])) if len(header) == 2
                      else (10, 300))
    body = lines[1:] if len(header) == 2 else lines
    if len(body) != n_folds * n_per * 2:
        raise ValueError(
            f"pairs.txt: expected {n_folds * n_per * 2} pair lines, "
            f"got {len(body)}")

    def rel(name, idx):
        return os.path.join(name, f"{name}_{int(idx):04d}.jpg")

    out = []
    for ln in body:
        if len(ln) == 3:
            out.append((rel(ln[0], ln[1]), rel(ln[0], ln[2]), 1))
        elif len(ln) == 4:
            out.append((rel(ln[0], ln[1]), rel(ln[2], ln[3]), 0))
        else:
            raise ValueError(f"bad pairs.txt line: {ln}")
    return out


def load_lfw_pairs(lfw_root: str, pairs_path: Optional[str] = None,
                   hw=INPUT_HW):
    """Decode every image pairs.txt names once -> (x uint8 (N, H, W, 3),
    i1, i2, same) for `eval_pairs`."""
    from .imagefolder import decode_image

    pairs_path = pairs_path or os.path.join(lfw_root, "pairs.txt")
    pairs = parse_lfw_pairs(pairs_path)
    paths = sorted({p for a, b, _ in pairs for p in (a, b)})
    index = {p: i for i, p in enumerate(paths)}
    x = np.stack([decode_image(os.path.join(lfw_root, p), hw, resize=None)
                  for p in paths])
    i1 = np.array([index[a] for a, _, _ in pairs])
    i2 = np.array([index[b] for _, b, _ in pairs])
    same = np.array([s for _, _, s in pairs], np.int32)
    return x, i1, i2, same


def verification_accuracy(sims: np.ndarray, labels: np.ndarray,
                          n_folds: int = 10) -> Tuple[float, float]:
    """10-fold cross-validated threshold: for each fold, the threshold
    (one of the similarities) with the best accuracy on the other folds,
    scored on the held-out fold. Returns (mean, std) of the fold
    accuracies."""
    n = len(sims)
    if n < n_folds:
        raise ValueError(f"{n} pairs cannot fill {n_folds} folds")
    folds = np.array_split(np.arange(n), n_folds)
    thresholds = np.unique(sims)
    accs = []
    for f in folds:
        mask = np.ones(n, bool)
        mask[f] = False
        train_s, train_l = sims[mask], labels[mask]
        accs_t = [((train_s > t).astype(int) == train_l).mean()
                  for t in thresholds]
        best_t = thresholds[int(np.argmax(accs_t))]
        accs.append(((sims[f] > best_t).astype(int) == labels[f]).mean())
    return float(np.mean(accs)), float(np.std(accs))


def eval_pairs(embed_fn: Callable, x: np.ndarray, i1, i2, same,
               batch_size: int = 64, n_folds: int = 10) -> Tuple[float, float]:
    """The LFW protocol over uint8 (N, 112, 96, 3) images: embed_fn maps a
    uint8 tensor batch to (N, D) embeddings (a SphereNet with
    head_type='none' through inference.predict); feature = concat(f(img),
    f(flipped img)), cosine similarity of each pair, then
    `verification_accuracy`."""
    import torch

    feats = []
    for s in range(0, len(x), batch_size):
        b = x[s:s + batch_size]
        f1, f2 = (embed_fn(torch.from_numpy(np.ascontiguousarray(v)))
                  .detach().float().cpu().numpy()
                  for v in (b, b[:, :, ::-1, :]))
        feats.append(np.concatenate([f1, f2], axis=1))
    feats = np.concatenate(feats)
    feats = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)
    sims = (feats[i1] * feats[i2]).sum(axis=1)
    return verification_accuracy(sims, np.asarray(same), n_folds)
