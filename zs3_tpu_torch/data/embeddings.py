"""Class-embedding registry (a copy of zs3_tpu.data.embeddings).

Zero-shot transfer flows entirely through per-class word vectors: the
GMMN generates unseen-class features from their embeddings alone
(reference: zs3/dataloaders/datasets/pascal.py, 300-d word2vec).
`load_class_embeddings` reads a local (num_classes, dim) ``.npy``, or a
name -> vector ``.pkl``/``.npz`` (comma-separated paths concatenate
along the feature axis); without a path it returns deterministic
unit-norm pseudo-embeddings seeded per class name, so every pipeline
runs without files.  Numpy only.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np


def _fallback_embedding(name: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(dim).astype(np.float32)
    return v / np.linalg.norm(v)


def _load_embedding_file(path: str, class_names: Sequence[str]) -> np.ndarray:
    """Load a (num_classes, dim) matrix from .npy, or a name->vector dict
    from .pkl/.npz (the formats the reference ships word2vec/fasttext in).

    Multiple comma-separated paths concatenate along the feature axis
    (the reference's combined 'fastnvec' = fasttext + word2vec setting).
    """
    if "," in path:
        parts = [_load_embedding_file(p, class_names) for p in path.split(",")]
        return np.concatenate(parts, axis=1)
    if path.endswith((".pkl", ".pickle")):
        import pickle

        with open(path, "rb") as f:
            table = pickle.load(f)
        missing = [n for n in class_names if n not in table]
        if missing:
            raise ValueError(f"embeddings missing for classes: {missing}")
        return np.stack([np.asarray(table[n], np.float32) for n in class_names])
    if path.endswith(".npz"):
        data = np.load(path)
        missing = [n for n in class_names if n not in data]
        if missing:
            raise ValueError(f"embeddings missing for classes: {missing}")
        return np.stack([np.asarray(data[n], np.float32) for n in class_names])
    return np.load(path)


def load_class_embeddings(
    class_names: Sequence[str],
    path: Optional[str] = None,
    dim: int = 300,
    normalize: bool = True,
) -> np.ndarray:
    """(num_classes, dim) float32 embedding matrix."""
    if path is not None:
        emb = _load_embedding_file(path, class_names)
        if emb.shape[0] != len(class_names):
            raise ValueError(
                f"embedding file has {emb.shape[0]} rows, expected {len(class_names)}"
            )
        emb = emb.astype(np.float32)
    else:
        emb = np.stack([_fallback_embedding(n, dim) for n in class_names])
    if normalize:
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        emb = emb / np.maximum(norms, 1e-8)
    return emb
