"""TextFolder ingestion — folder-of-.txt-files per class, the text-modality
analogue of data/imagefolder.py.

The port's copy of `cpg_tpu.data.textfolder` (numpy and hashlib only; the
same tokens for the same files). The text family (models/text.py) takes
torchvision's ImageFolder convention for documents:

    root/{train,test}/<class_name>/*.txt

Tokenization is dependency-free and deterministic (no vocab download):

  * `byte`  — UTF-8 bytes shifted by +2 (PAD=0, BOS=1): vocab 258, no OOV,
    reversible.
  * `hash`  — whitespace tokens hashed (blake2b, stable across processes —
    NOT Python's seeded hash()) into [2, vocab): classic hashing-trick
    features, fixed table size for any corpus.

Sequences are truncated / zero-padded to a static seq_len.
Loaders return the same task-dict contract as data/text.py's synthetic
generator plus a "vocab" entry — the CLI threads it into
CPGState.model_kwargs so the sharable embedding table is sized to match.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

PAD, BOS = 0, 1
BYTE_VOCAB = 258  # PAD + BOS + 256 byte values


def tokenize_bytes(text: str, seq_len: int) -> np.ndarray:
    """UTF-8 bytes + 2 (PAD=0, BOS=1), BOS-prefixed, truncated/padded."""
    ids = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32) + 2
    out = np.zeros(seq_len, np.int32)
    out[0] = BOS
    n = min(len(ids), seq_len - 1)
    out[1:1 + n] = ids[:n]
    return out


def tokenize_hash(text: str, seq_len: int, vocab: int) -> np.ndarray:
    """Whitespace tokens -> stable blake2b hash into [2, vocab)."""
    if vocab < 16:
        raise ValueError(
            f"tokenize_hash needs vocab >= 16 (got {vocab}): ids land in "
            f"[2, vocab), and a tiny modulus aliases every token")
    out = np.zeros(seq_len, np.int32)
    out[0] = BOS
    for i, tok in enumerate(text.split()):
        if i + 1 >= seq_len:
            break
        h = hashlib.blake2b(tok.lower().encode("utf-8"),
                            digest_size=8).digest()
        out[i + 1] = 2 + int.from_bytes(h, "little") % (vocab - 2)
    return out


def list_textfolder(split_dir: str) -> Tuple[List[Tuple[str, int]],
                                             List[str]]:
    """[(path, label)], class_names — sorted folder names, the same class
    assignment rule as data/imagefolder.list_imagefolder."""
    classes = sorted(
        d for d in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, d)))
    samples = []
    for label, cname in enumerate(classes):
        cdir = os.path.join(split_dir, cname)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(".txt"):
                samples.append((os.path.join(cdir, fn), label))
    return samples, classes


def _encode_split(split_dir: str, seq_len: int, tokenizer: str,
                  vocab: int) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    samples, classes = list_textfolder(split_dir)
    if not samples:
        raise FileNotFoundError(f"no <class>/*.txt under {split_dir}")
    xs = np.zeros((len(samples), seq_len), np.int32)
    ys = np.zeros(len(samples), np.int32)
    for i, (path, label) in enumerate(samples):
        with open(path, encoding="utf-8", errors="replace") as f:
            text = f.read()
        xs[i] = (tokenize_bytes(text, seq_len) if tokenizer == "byte"
                 else tokenize_hash(text, seq_len, vocab))
        ys[i] = label
    return xs, ys, classes


def textfolder_task(root: str, seq_len: int = 128, tokenizer: str = "byte",
                    vocab: int = 4096) -> Dict:
    """One task from `root/{train,test}/<class>/*.txt`.

    Returns the data/text.py task-dict contract plus "vocab" (the embedding
    table size the model must be initialized with) and "classes"."""
    if tokenizer not in ("byte", "hash"):
        raise ValueError(f"tokenizer {tokenizer!r}: 'byte' or 'hash'")
    v = BYTE_VOCAB if tokenizer == "byte" else vocab
    tx, ty, classes = _encode_split(os.path.join(root, "train"),
                                    seq_len, tokenizer, v)
    vx, vy, vclasses = _encode_split(os.path.join(root, "test"),
                                     seq_len, tokenizer, v)
    if classes != vclasses:
        raise ValueError(f"train/test class mismatch under {root}: "
                         f"{classes} vs {vclasses}")
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy,
            "num_classes": len(classes), "vocab": v, "classes": classes}


def textfolder_task_splits(data_dir: Optional[str] = None,
                           seq_len: int = 128, tokenizer: str = "byte",
                           vocab: int = 4096) -> Optional[Dict[str, Dict]]:
    """The real-data path for `--experiment textcls`: every subdirectory of
    `$CPG_DATA_DIR/textcls/` that contains a train/ split becomes one task
    (sorted order = task order). Returns None when the layout is absent —
    the caller falls back to data/text.py's synthetic tasks, the same
    pattern as every vision loader."""
    d = data_dir or os.environ.get("CPG_DATA_DIR")
    root = os.path.join(d, "textcls") if d else None
    if not root or not os.path.isdir(root):
        return None
    names = sorted(
        t for t in os.listdir(root)
        if os.path.isdir(os.path.join(root, t, "train")))
    if not names:
        return None
    return {name: textfolder_task(os.path.join(root, name), seq_len,
                                  tokenizer, vocab)
            for name in names}
