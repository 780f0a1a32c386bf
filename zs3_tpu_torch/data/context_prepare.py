"""Offline Pascal-Context label preparation, detail-API JSON -> PNGs (a
copy of zs3_tpu.data.context_prepare, numpy and json only).

The reference loads Pascal-Context through the 'detail' API at runtime
(reference: zs3/dataloaders/datasets/context.py, SURVEY.md §2.1); that
package is not installable here, and decoding JSON+RLE per sample would
be wasted host work on the input path.  This tool converts
`trainval_merged.json` (the PASCAL-in-Detail annotation file, COCO-style
RLE segment masks) ONCE into the layout
`zs3_tpu_torch.data.context.ContextSegmentation` reads:

    VOC2010/SegmentationClassContext/<name>.png   (uint8 label maps)
    VOC2010/ImageSets/SegmentationContext/{train,val}.txt

Label convention (data/classes.py): values 0..58 index CONTEXT_CLASSES
(the most-frequent-59 protocol); everything else -- background and the
remaining ~400 rare categories -- is 255 (ignore).

The COCO compressed-RLE string codec is implemented in pure
python/numpy (no pycocotools); masks decode column-major per the COCO
spec.

CLI: `python -m zs3_tpu_torch.cli prepare-context trainval_merged.json
--data-root /data`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from zs3_tpu_torch.data.classes import CONTEXT_CLASSES


def decode_rle_string(s: str) -> List[int]:
    """COCO compressed RLE string -> run counts (pycocotools
    rleFrString: LEB128-style 5-bit groups, 0x20 continuation, sign
    extension via 0x10, and 3rd-onward counts delta-coded against
    counts[i-2])."""
    counts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode_rle_string(counts: Sequence[int]) -> str:
    """Inverse of decode_rle_string (pycocotools rleToString)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_to_mask(segmentation: Dict, height: int, width: int) -> np.ndarray:
    """COCO RLE dict {'counts': str|list, 'size': [h, w]} -> bool (h, w).

    Runs alternate background/foreground starting with background and
    fill the mask COLUMN-major (Fortran order), per the COCO spec."""
    if not isinstance(segmentation, dict):
        # COCO-style JSON also allows polygon segmentations (a list of
        # coordinate lists); the detail API ships RLE dicts only, and
        # rasterizing polygons needs geometry code we don't carry.
        raise ValueError(
            "polygon segmentations (list form) are unsupported; expected "
            f"an RLE dict {{'counts', 'size'}}, got {type(segmentation).__name__}"
        )
    h, w = segmentation.get("size", (height, width))
    if (h, w) != (height, width):
        # Trusting a stale/swapped embedded size would produce a
        # wrong-shaped mask and an opaque IndexError at label assignment.
        raise ValueError(
            f"RLE size {[h, w]} disagrees with the image record's "
            f"height/width {[height, width]}"
        )
    counts = segmentation["counts"]
    if isinstance(counts, str):
        counts = decode_rle_string(counts)
    counts = np.asarray(counts, np.int64)
    if counts.sum() != h * w:
        raise ValueError(
            f"RLE runs sum to {int(counts.sum())}, expected {h}x{w}={h*w}"
        )
    flat = np.zeros(h * w, np.bool_)
    val = False
    pos = 0
    for run in counts:
        if val:
            flat[pos : pos + run] = True
        pos += int(run)
        val = not val
    return flat.reshape((w, h)).T  # column-major


def _index(items, *keys):
    out = {}
    for item in items:
        for key in keys:
            if key in item:
                out[item[key]] = item
                break
        else:
            raise KeyError(f"none of {keys} in {sorted(item)[:6]}")
    return out


def prepare_context(
    json_path: str, data_root: str, overwrite: bool = False
) -> Dict[str, int]:
    """Convert a detail-API annotation JSON into the precomputed-PNG
    layout.  Returns {'images': N, 'train': n, 'val': n, 'skipped': n}."""
    from PIL import Image

    with open(json_path) as f:
        data = json.load(f)
    name_to_idx = {n: i for i, n in enumerate(CONTEXT_CLASSES)}
    categories = _index(data["categories"], "category_id", "id")
    cat_to_label = {
        cid: name_to_idx.get(cat.get("name"), 255)
        for cid, cat in categories.items()
    }
    # Unmatched registry names would silently drop whole classes to 255
    # in every prepared label map (a partial naming drift between the
    # JSON's category names and CONTEXT_CLASSES is otherwise invisible:
    # only all-255 images get skipped). Surface it: report in stats,
    # warn on partial drift, and raise when nothing matches at all —
    # that can only be a wrong file or a wholesale naming scheme change.
    json_names = {cat.get("name") for cat in categories.values()}
    unmatched = [n for n in CONTEXT_CLASSES if n not in json_names]
    if len(unmatched) == len(CONTEXT_CLASSES):
        raise ValueError(
            f"none of the {len(CONTEXT_CLASSES)} registry class names "
            f"match any category in {os.path.basename(json_path)!r} "
            f"(sample JSON names: {sorted(n for n in json_names if n)[:6]}) "
            "— wrong annotation file, or the naming scheme drifted; fix "
            "zs3_tpu_torch/data/classes.py before preparing."
        )
    if unmatched:
        import warnings

        warnings.warn(
            f"{len(unmatched)} of {len(CONTEXT_CLASSES)} registry class "
            f"names have no category in the JSON and will be absent from "
            f"every prepared label map: {unmatched}",
            stacklevel=2,
        )
    annos = data.get("annos_segmentation", data.get("annotations", []))
    by_image: Dict = {}
    for anno in annos:
        by_image.setdefault(anno["image_id"], []).append(anno)

    base = os.path.join(data_root, "VOC2010")
    label_dir = os.path.join(base, "SegmentationClassContext")
    split_dir = os.path.join(base, "ImageSets", "SegmentationContext")
    os.makedirs(label_dir, exist_ok=True)
    os.makedirs(split_dir, exist_ok=True)

    splits: Dict[str, List[str]] = {}
    stats = {
        "images": 0,
        "skipped": 0,
        "matched_classes": len(CONTEXT_CLASSES) - len(unmatched),
        "unmatched_classes": len(unmatched),
    }
    for image in data["images"]:
        image_id = image.get("image_id", image.get("id"))
        name = os.path.splitext(image["file_name"])[0]
        segs = by_image.get(image_id, [])
        if not segs:
            stats["skipped"] += 1
            continue
        h, w = image["height"], image["width"]
        label = np.full((h, w), 255, np.uint8)
        for anno in segs:
            cls = cat_to_label.get(anno["category_id"], 255)
            if cls == 255:
                continue
            try:
                mask = rle_to_mask(anno["segmentation"], h, w)
            except ValueError as e:
                raise ValueError(
                    f"image {name!r} (id {image_id}), category "
                    f"{anno['category_id']}: {e}"
                ) from e
            label[mask] = cls
        if (label == 255).all():
            # Every annotation mapped to a rare (non-59) category: the
            # image would train as pure-ignore — skip it like the
            # zero-annotation case.
            stats["skipped"] += 1
            continue
        out = os.path.join(label_dir, name + ".png")
        if overwrite or not os.path.exists(out):
            Image.fromarray(label, mode="L").save(out)
        phase = str(image.get("phase", image.get("split", "train"))).lower()
        splits.setdefault(phase, []).append(name)
        stats["images"] += 1
    for phase, names in splits.items():
        with open(os.path.join(split_dir, f"{phase}.txt"), "w") as f:
            f.write("\n".join(sorted(names)) + "\n")
        stats[phase] = len(names)
    return stats
