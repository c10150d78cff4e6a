"""ImageFolder ingestion: the reference's on-disk dataset layout.

The counterpart of `cpg_tpu.data.imagefolder`: torchvision ImageFolder trees
`root/{train,test}/<class_name>/*.jpg`, classes numbered in sorted folder
order, each image decoded by PIL on the host, its shorter side resized to
256 and centre-cropped (or zero-padded) to 224x224, into one contiguous
uint8 NHWC array a split. The random crop and flip happen later, on the
device (data/augment.py).

PIL is imported when an image is decoded, never with this module: without
it the loaders raise and point at the .npz layout of data/finegrained.py.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "PIL unavailable: provide datasets as pre-converted .npz "
            "(CPG_DATA_DIR/<name>/{train,test}.npz with x uint8 NHWC, "
            "y int32) instead of image folders") from e
    return Image


def list_imagefolder(split_dir: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """([(path, label)], class names): classes are the sorted folder names
    (torchvision ImageFolder's rule), files sorted within each."""
    classes = sorted(
        d for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d)))
    samples = []
    for label, cname in enumerate(classes):
        cdir = os.path.join(split_dir, cname)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(IMG_EXTS):
                samples.append((os.path.join(cdir, fn), label))
    return samples, classes


def decode_image(path: str, hw: Tuple[int, int], resize: Optional[int] = None
                 ) -> np.ndarray:
    """One image -> uint8 (H, W, 3). `resize` scales the shorter side first
    (the reference's eval Resize(256)), else the image is resized to `hw`;
    then a centre crop (or zero pad) to exactly `hw`."""
    Image = _pil()
    img = Image.open(path).convert("RGB")
    h, w = hw
    if resize:
        iw, ih = img.size
        scale = resize / min(iw, ih)
        img = img.resize((max(1, round(iw * scale)),
                          max(1, round(ih * scale))), Image.BILINEAR)
    else:
        img = img.resize((w, h), Image.BILINEAR)
    a = np.asarray(img, np.uint8)
    ah, aw = a.shape[:2]
    if ah < h or aw < w:
        pad = np.zeros((max(ah, h), max(aw, w), 3), np.uint8)
        pad[:ah, :aw] = a
        a = pad
        ah, aw = a.shape[:2]
    y0, x0 = (ah - h) // 2, (aw - w) // 2
    return a[y0:y0 + h, x0:x0 + w]


def load_imagefolder(
    split_dir: str,
    hw: Tuple[int, int] = (224, 224),
    resize: Optional[int] = 256,
    limit_per_class: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """A whole split -> (x uint8 (N, H, W, 3), y int32, class names)."""
    samples, classes = list_imagefolder(split_dir)
    if limit_per_class:
        kept, counts = [], {}
        for p, label in samples:
            if counts.get(label, 0) < limit_per_class:
                kept.append((p, label))
                counts[label] = counts.get(label, 0) + 1
        samples = kept
    if not samples:
        raise FileNotFoundError(f"no images under {split_dir}")
    x = np.empty((len(samples), hw[0], hw[1], 3), np.uint8)
    y = np.empty(len(samples), np.int32)
    for i, (p, label) in enumerate(samples):
        x[i] = decode_image(p, hw, resize)
        y[i] = label
    return x, y, classes


def imagefolder_splits(root: str, hw=(224, 224), resize: Optional[int] = 256,
                       limit_per_class: Optional[int] = None,
                       splits: Sequence[str] = ("train", "test")
                       ) -> Optional[Dict]:
    """root/{train, test|val|valid}/<class>/*.jpg -> a task dict of arrays,
    or None when the layout is not there (the caller then reads the .npz
    files or makes synthetic data)."""
    names = {}
    for want in splits:
        cands = [want] if want != "test" else ["test", "val", "valid"]
        found = next((c for c in cands
                      if os.path.isdir(os.path.join(root, c))), None)
        if found is None:
            return None
        names[want] = os.path.join(root, found)
    tx, ty, classes = load_imagefolder(names["train"], hw, resize,
                                       limit_per_class)
    vx, vy, vclasses = load_imagefolder(names["test"], hw, resize,
                                        limit_per_class)
    if classes != vclasses:
        raise ValueError(
            f"{root}: train/test class folders differ "
            f"({len(classes)} vs {len(vclasses)})")
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy,
            "num_classes": len(classes), "class_names": classes}
