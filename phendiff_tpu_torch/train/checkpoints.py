"""Training-state checkpoints with rotation and "latest" resume.

Counterpart of ``phendiff_tpu/train/checkpoints.py``, with its semantics:
one directory per step under the checkpoint root, ``total_limit`` rotation
that keeps the newest steps, ``latest_step`` / ``all_steps``, and
``restore(state, step=None)`` defaulting to the latest step.  The format
is the port's own (the Orbax format cannot be read without orbax): each
step directory holds ``state.pt``, a ``torch.save`` of
``TrainState.state_dict()`` (plus ``extra`` when given).  A step is
written to a temporary directory and renamed into place, so a reader never
sees half a checkpoint.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

import torch

from phendiff_tpu_torch.train.train_loop import TrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, total_limit: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.total_limit = total_limit
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: TrainState, extra: Optional[dict] = None) -> None:
        payload = {"state": state.state_dict()}
        if extra is not None:
            payload["extra"] = extra
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.total_limit is not None:
            for old in self.all_steps()[:-self.total_limit]:
                shutil.rmtree(self._step_dir(old))

    def all_steps(self) -> List[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, STATE_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load ``step`` (or the latest) into ``state``'s tensors, in place,
        and return it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        payload = torch.load(os.path.join(self._step_dir(step), STATE_FILE),
                             map_location="cpu", weights_only=True)
        state.load_state_dict(payload["state"])
        return state
