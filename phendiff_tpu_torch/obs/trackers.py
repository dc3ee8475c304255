"""Experiment tracking, offline first.

Counterpart of ``phendiff_tpu/obs/trackers.py``: a small ``Tracker``
interface with a ``JSONLTracker`` (metrics to ``metrics.jsonl``, alerts
with a 6 h cooldown per title to ``alerts.log``, the run id kept in
``run_id.txt`` for resume, image panels as PNG files under
``images/step_<step>/``), a ``WandbTracker`` (the same calls on a wandb
run; ``wandb`` is imported only when one is made) and a ``NullTracker``.
``make_tracker("wandb", ...)`` falls back to the JSONL tracker where
``wandb`` cannot be imported, as offline machines have it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class Tracker:
    run_id: str = ""

    def log(self, metrics: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def log_images(self, name: str, images01, step: int) -> None:
        """A batch of [B, H, W, C] images in [0, 1]."""
        raise NotImplementedError

    def alert(self, title: str, text: str) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        pass


class NullTracker(Tracker):
    def log(self, metrics, step):
        pass

    def log_images(self, name, images01, step):
        pass

    def alert(self, title, text):
        pass


class JSONLTracker(Tracker):
    ALERT_COOLDOWN_S = 6 * 3600

    def __init__(self, run_dir: str, run_id: Optional[str] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        id_path = os.path.join(run_dir, "run_id.txt")
        if run_id is None and os.path.exists(id_path):
            with open(id_path) as f:
                run_id = f.read().strip()
        if not run_id:
            run_id = hex(int(time.time() * 1e6))[2:]
        with open(id_path, "w") as f:
            f.write(run_id)
        self.run_id = run_id
        self._metrics_f = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._alerts_path = os.path.join(run_dir, "alerts.log")
        self._last_alert: Dict[str, float] = {}

    def log(self, metrics, step):
        rec = {"step": int(step), "ts": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()

    def log_images(self, name, images01, step):
        from PIL import Image

        name = name.replace(os.sep, "_")  # names like "samples/DMSO"
        out_dir = os.path.join(self.run_dir, "images", f"step_{step:08d}")
        os.makedirs(out_dir, exist_ok=True)
        arr = (np.clip(np.asarray(images01), 0, 1) * 255).astype(np.uint8)
        for i, img in enumerate(arr):
            Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img).save(
                os.path.join(out_dir, f"{name}_{i:03d}.png"))

    def alert(self, title, text):
        now = time.time()
        if now - self._last_alert.get(title, -1e12) < self.ALERT_COOLDOWN_S:
            return
        self._last_alert[title] = now
        with open(self._alerts_path, "a") as f:
            f.write(f"{time.ctime()} [{title}] {text}\n")

    def finish(self):
        self._metrics_f.close()


class WandbTracker(Tracker):
    """A wandb run in ``run_dir`` (resumed when ``run_id`` is given)."""

    def __init__(self, project: str, run_dir: str, config: dict,
                 run_id: Optional[str] = None):
        import wandb  # optional: imported only for this tracker

        self._run = wandb.init(project=project, dir=run_dir, config=config, id=run_id,
                               resume="must" if run_id else None)
        self.run_id = self._run.id
        self._wandb = wandb

    def log(self, metrics, step):
        self._run.log(metrics, step=step)

    def log_images(self, name, images01, step):
        self._run.log({name: [self._wandb.Image(np.asarray(i)) for i in images01]}, step=step)

    def alert(self, title, text):
        self._wandb.alert(title=title, text=text, wait_duration=JSONLTracker.ALERT_COOLDOWN_S)

    def finish(self):
        self._run.finish()


def make_tracker(kind: str, run_dir: str, project: str = "phendiff-tpu",
                 config: Optional[dict] = None) -> Tracker:
    """``"jsonl"``, ``"wandb"`` (JSONL where ``wandb`` cannot be imported)
    or ``"none"``/``"no"``."""
    if kind in ("none", "no"):
        return NullTracker()
    if kind == "wandb":
        try:
            return WandbTracker(project, run_dir, config or {})
        except ImportError:
            return JSONLTracker(run_dir)
    if kind == "jsonl":
        return JSONLTracker(run_dir)
    raise ValueError(f"unknown tracker {kind!r}: this port has 'jsonl', 'wandb' and 'none'")
