"""Offline class-embedding registry builder, ``cli build-embeddings`` (a
copy of zs3_tpu.data.embedding_build, numpy only).

The reference ships prebuilt word2vec ``.npy``/``.pkl`` class embeddings
(SURVEY.md §1 layer 3; reference: zs3/dataloaders/datasets/pascal.py
load_embedding hooks) but no tooling to produce them — a real-data run
starts with hand-wrangling word-vector files into the right row order.
This module converts standard word-vector formats into the registry
``.npy`` the loaders consume (rows ordered by the dataset's class list):

  * word2vec/fasttext TEXT (``.vec``/``.txt``: optional "N dim" header,
    then ``token v1 .. vdim`` lines — GloVe's headerless form too);
  * word2vec BINARY (``.bin``: "N dim\\n" header, then
    ``token<space><dim float32s>`` records);
  * an existing registry/dict file (``.npy``/``.npz``/``.pkl``) for
    re-ordering or concatenation.

Multiple input files concatenate feature-wise per class — the
reference's combined "fastnvec" (fasttext ‖ word2vec) setting.

Lookup handles the dataset registries' compound names: exact match
first, then lowercase, then a built-in alias table (``tvmonitor`` →
``tv``, ``pottedplant`` → averaged ``potted``+``plant``, ...), then an
automatic compound split averaged over parts.  Anything still missing
raises with the full list — a silently wrong row would corrupt
zero-shot transfer with no error anywhere downstream.

The returned report carries vocab-coverage and norm sanity stats; the
CLI prints it as JSON.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# How each registry name that is not a plain vocabulary word resolves.
# Multi-token values average their parts (the standard compositional
# fallback for compound class names).
DEFAULT_ALIASES: Dict[str, str] = {
    # VOC
    "aeroplane": "airplane",
    "diningtable": "dining table",
    "motorbike": "motorcycle",
    "pottedplant": "potted plant",
    "tvmonitor": "tv monitor",
    # Pascal-Context extras
    "bedclothes": "bed clothes",
}


def read_word_vectors(path: str, vocab: Sequence[str]) -> Tuple[Dict[str, np.ndarray], int]:
    """Read vectors for `vocab` tokens from a word-vector file.

    Only requested tokens are kept (full files are millions of rows).
    Returns (token -> float32 vector, dim).
    """
    wanted = set(vocab)
    if path.endswith(".bin"):
        return _read_word2vec_binary(path, wanted)
    return _read_word_vector_text(path, wanted)


def _read_word_vector_text(path: str, wanted: set) -> Tuple[Dict[str, np.ndarray], int]:
    table: Dict[str, np.ndarray] = {}
    dim = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        first = f.readline().rstrip("\n")
        parts = first.split(" ")
        if len(parts) == 2 and all(p.isdigit() for p in parts):
            dim = int(parts[1])  # word2vec/fasttext header
        else:  # GloVe-style: the first line is already a vector row
            _consume_text_line(first, table, wanted)
        for line in f:
            _consume_text_line(line.rstrip("\n"), table, wanted)
    if table:
        dim = len(next(iter(table.values())))
    if dim is None:
        raise ValueError(f"{path!r}: no parseable vector rows")
    return table, dim


def _consume_text_line(line: str, table: Dict, wanted: set) -> None:
    if not line:
        return
    token, _, rest = line.partition(" ")
    if token in wanted and token not in table:
        table[token] = np.asarray(rest.split(), dtype=np.float32)


def _read_word2vec_binary(path: str, wanted: set) -> Tuple[Dict[str, np.ndarray], int]:
    """Original word2vec C binary format: ASCII "N dim\\n" header, then
    N records of ``token<space><dim little-endian float32s>[\\n]``."""
    table: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        header = f.readline().split()
        if len(header) != 2:
            raise ValueError(f"{path!r}: malformed word2vec binary header")
        count, dim = int(header[0]), int(header[1])
        vec_bytes = 4 * dim
        for _ in range(count):
            token_bytes = bytearray()
            while True:
                ch = f.read(1)
                if not ch:
                    raise ValueError(f"{path!r}: truncated word2vec binary")
                if ch == b" ":
                    break
                if ch != b"\n":  # some writers put \n before the token
                    token_bytes += ch
            vec = np.frombuffer(f.read(vec_bytes), dtype="<f4")
            if vec.size != dim:
                raise ValueError(f"{path!r}: truncated word2vec binary")
            token = token_bytes.decode("utf-8", errors="replace")
            if token in wanted and token not in table:
                table[token] = vec.astype(np.float32)
    return table, dim


def _candidate_tokens(name: str, aliases: Dict[str, str]) -> List[List[str]]:
    """Token lists to try for a class name, best first; each list is
    averaged if multi-token."""
    cands = [[name]]
    if name.lower() != name:
        cands.append([name.lower()])
    alias = aliases.get(name.lower())
    if alias:
        cands.append(alias.split(" "))
    if " " in name:
        cands.append(name.split(" "))
    return cands


def _resolve(
    name: str, table: Dict[str, np.ndarray], aliases: Dict[str, str]
) -> Optional[Tuple[np.ndarray, str]]:
    for tokens in _candidate_tokens(name, aliases):
        if all(t in table for t in tokens):
            vec = np.mean([table[t] for t in tokens], axis=0)
            how = "exact" if tokens == [name] else "+".join(tokens)
            return vec.astype(np.float32), how
    return None


def build_embedding_registry(
    class_names: Sequence[str],
    vector_paths: Sequence[str],
    output: str,
    normalize: bool = True,
    aliases: Optional[Dict[str, str]] = None,
) -> Dict:
    """Build and save the (num_classes, sum-of-dims) registry ``.npy``.

    Each path in `vector_paths` contributes its dims to every class
    (feature-wise concat = the reference's fastnvec mode).  Raises if
    any class resolves in no file.  Returns a coverage/norm report.
    """
    aliases = {**DEFAULT_ALIASES, **(aliases or {})}
    # every token any candidate might need, across all names
    vocab = sorted(
        {
            t
            for n in class_names
            for tokens in _candidate_tokens(n, aliases)
            for t in tokens
        }
    )
    blocks: List[np.ndarray] = []
    per_file = []
    for path in vector_paths:
        if path.endswith(".npy"):
            # an existing registry: rows already ordered by class list
            block = np.load(path).astype(np.float32)
            if block.shape[0] != len(class_names):
                raise ValueError(
                    f"{path!r} has {block.shape[0]} rows, expected "
                    f"{len(class_names)} (registry .npy must be "
                    "row-ordered by the dataset class list)"
                )
            blocks.append(block)
            per_file.append(
                {"path": path, "dim": int(block.shape[1]), "resolved_via": {}}
            )
            continue
        if path.endswith((".npz", ".pkl", ".pickle")):
            if path.endswith(".npz"):
                data = np.load(path)
                table = {k: np.asarray(data[k], np.float32) for k in data.files}
            else:
                import pickle

                with open(path, "rb") as f:
                    table = {
                        k: np.asarray(v, np.float32)
                        for k, v in pickle.load(f).items()
                    }
            dim = len(next(iter(table.values())))
        else:
            table, dim = read_word_vectors(path, vocab)
        rows, hows, missing = [], {}, []
        for name in class_names:
            got = _resolve(name, table, aliases)
            if got is None:
                missing.append(name)
                rows.append(np.zeros((dim,), np.float32))
            else:
                rows.append(got[0])
                hows[name] = got[1]
        if missing:
            raise ValueError(
                f"{os.path.basename(path)!r} has no vector for classes "
                f"{missing} (tried exact/lowercase/alias/compound-split; "
                f"extend aliases= or DEFAULT_ALIASES)"
            )
        block = np.stack(rows)
        blocks.append(block)
        per_file.append(
            {
                "path": path,
                "dim": dim,
                "resolved_via": {
                    k: v for k, v in hows.items() if v != "exact"
                },
            }
        )
    emb = np.concatenate(blocks, axis=1).astype(np.float32)
    norms = np.linalg.norm(emb, axis=1)
    zero_rows = [class_names[i] for i in np.nonzero(norms < 1e-8)[0]]
    if zero_rows:
        raise ValueError(
            f"zero embedding vectors for {zero_rows} — corrupt source file?"
        )
    if normalize:
        emb = emb / norms[:, None]
    np.save(output, emb)
    return {
        "output": output,
        "classes": len(class_names),
        "dim": int(emb.shape[1]),
        "normalized": bool(normalize),
        "files": per_file,
        "norm_min": float(norms.min()),
        "norm_mean": float(norms.mean()),
        "norm_max": float(norms.max()),
    }
