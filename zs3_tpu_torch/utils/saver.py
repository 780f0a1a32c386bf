"""Checkpoints and experiment directories (port of zs3_tpu.utils.saver).

``<base_dir>/<dataset>/<checkname>/experiment_N/`` holds the run's
``config.json`` and one ``ckpt_{step:08d}`` file per save, a
``torch.save`` payload, beside a ``ckpt_{step:08d}.json`` sidecar of
``{step, best_metric, ...extra}``.  ``best`` is a symlink to the best
checkpoint; garbage collection keeps the newest `keep` checkpoints and
never the one ``best`` points at.  A save writes to a private name and
renames, so a reader never sees half a checkpoint.  zs3_tpu's orbax
checkpoints are not read here (that needs orbax).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import torch

from zs3_tpu_torch.core.config import Config


def _experiment_ids(root: str):
    return sorted(
        int(d.split("_")[-1])
        for d in os.listdir(root)
        if d.startswith("experiment_") and d.split("_")[-1].isdigit()
    )


def _checkpoints(directory: str):
    return sorted(
        d for d in os.listdir(directory) if d.startswith("ckpt_") and not d.endswith(".json")
    )


class Saver:
    def __init__(
        self,
        base_dir: str,
        dataset: str,
        checkname: str,
        config: Optional[Config] = None,
        keep: int = 3,
    ):
        root = os.path.join(base_dir, dataset, checkname)
        os.makedirs(root, exist_ok=True)
        runs = _experiment_ids(root)
        run_id = (runs[-1] + 1) if runs else 0
        while True:  # another Saver may take the same number at once
            self.directory = os.path.join(root, f"experiment_{run_id}")
            try:
                os.makedirs(self.directory)
                break
            except FileExistsError:
                run_id += 1
        self.keep = keep
        if config is not None:
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                f.write(config.to_json())

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}")

    def save_checkpoint(
        self,
        payload: Dict[str, Any],
        step: int,
        best_metric: float,
        is_best: bool = False,
        extra: Optional[Dict[str, Any]] = None,
    ) -> str:
        """torch.save(payload) as ckpt_{step}, its sidecar, `best` when
        is_best, then GC; returns the checkpoint's path."""
        path = self._path(step)
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix="tmp_ckpt_")
        os.close(fd)
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        with open(path + ".json", "w") as f:
            json.dump({"step": step, "best_metric": best_metric, **(extra or {})}, f)
        if is_best:
            link = os.path.join(self.directory, f".best-{os.getpid()}")
            os.symlink(os.path.basename(path), link)
            os.replace(link, os.path.join(self.directory, "best"))
        self._gc()
        return path

    def _gc(self):
        best = os.path.join(self.directory, "best")
        best_target = os.readlink(best) if os.path.islink(best) else None
        ckpts = _checkpoints(self.directory)
        for name in ckpts[: -self.keep] if self.keep > 0 else []:
            if name == best_target:
                continue
            for f in (name, name + ".json"):
                path = os.path.join(self.directory, f)
                if os.path.exists(path):
                    os.remove(path)

    @staticmethod
    def restore(path: str, map_location="cpu") -> Dict[str, Any]:
        """The payload saved at `path` (a ckpt_N file or `best`)."""
        return torch.load(path, map_location=map_location, weights_only=True)

    @staticmethod
    def read_meta(path: str) -> Dict[str, Any]:
        """The sidecar of a checkpoint ({} if absent); `best` resolves to
        its target's."""
        meta = os.path.realpath(path).rstrip("/") + ".json"
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f)
        return {}

    @staticmethod
    def latest_checkpoint(experiment_dir: str) -> Optional[str]:
        if not os.path.isdir(experiment_dir):
            return None
        ckpts = _checkpoints(experiment_dir)
        return os.path.join(experiment_dir, ckpts[-1]) if ckpts else None

    @staticmethod
    def best_checkpoint(experiment_dir: str) -> Optional[str]:
        best = os.path.join(experiment_dir, "best")
        return best if os.path.exists(best) else None

    @staticmethod
    def latest_experiment(base_dir: str, dataset: str, checkname: str) -> Optional[str]:
        """The newest experiment_N of (dataset, checkname) that holds a
        checkpoint, or None (what --auto-resume resumes from)."""
        root = os.path.join(base_dir, dataset, checkname)
        if not os.path.isdir(root):
            return None
        for run_id in reversed(_experiment_ids(root)):
            exp = os.path.join(root, f"experiment_{run_id}")
            if Saver.latest_checkpoint(exp):
                return exp
        return None
