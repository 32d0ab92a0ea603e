"""Checkpoint save and resume (counterpart of
cddmsl_tpu/checkpoint/checkpointer.py `DetectionCheckpointer`).

A checkpoint is one `torch.save` file, `<save_dir>/<name>.pth`, holding the
training state's `state_dict()` (engine/train_loop.py `Trainer`): the model's
parameters and buffers, the SGD momentum buffers, the optimizer's own count
(the LR is read at it) and the iteration. A `last_checkpoint` marker names
the newest save, which `resume_or_load` restores. With `max_to_keep` > 0
only that many periodic saves stay on disk; `model_final` and the resume
target are never removed.
"""

import logging
import os
from typing import Dict, List, Optional

import torch
from torch import nn

logger = logging.getLogger(__name__)

_LAST = "last_checkpoint"
_PROTECTED = ("model_final",)


class DetectionCheckpointer:
    def __init__(self, save_dir: str, max_to_keep: int = 0):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._recent: List[str] = []  # the periodic saves, oldest first

    def save(self, name: str, state) -> str:
        """Writes `state.state_dict()` to `<name>.pth` (through a temporary
        file, so a cut save leaves the last one whole) and points the
        marker at it."""
        path = os.path.join(self.save_dir, name + ".pth")
        tmp = path + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        with open(os.path.join(self.save_dir, _LAST), "w") as f:
            f.write(name + ".pth")
        logger.info("Saved checkpoint to %s", path)
        if name not in _PROTECTED:
            self._recent.append(path)
            self._gc()
        return path

    def _gc(self) -> None:
        if self.max_to_keep <= 0:
            return
        while len(self._recent) > self.max_to_keep:
            victim = self._recent.pop(0)
            if victim != self.get_checkpoint_file() and os.path.exists(victim):
                os.remove(victim)
                logger.info("Removed old checkpoint %s (max_to_keep=%d)", victim, self.max_to_keep)

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.save_dir, _LAST))

    def get_checkpoint_file(self) -> Optional[str]:
        marker = os.path.join(self.save_dir, _LAST)
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            return os.path.join(self.save_dir, f.read().strip())

    @staticmethod
    def read(path: str, device) -> Dict:
        """A file written by `save`, its tensors on `device`."""
        saved = torch.load(path, map_location=device, weights_only=True)
        if not (isinstance(saved, dict) and {"model", "optimizer", "iteration"} <= saved.keys()):
            raise NotImplementedError(
                f"{path} was not written by this checkpointer; loading the reference's detector "
                "checkpoints through MODEL.WEIGHTS is not ported"
            )
        return saved

    def load(self, path: str, state) -> None:
        """Restores a file written by `save` into `state` on its devices."""
        state.load_state_dict(self.read(path, next(state.model.parameters()).device))
        logger.info("Restored checkpoint from %s", path)

    @classmethod
    def load_model(cls, path: str, model: nn.Module) -> None:
        """The model's own parameters and buffers from a file written by
        `save`: a serving build takes its subset of the training build's."""
        saved = cls.read(path, next(model.parameters()).device)["model"]
        missing = model.state_dict().keys() - saved.keys()
        if missing:
            raise KeyError(f"{path} lacks {sorted(missing)[:5]}")
        model.load_state_dict({k: saved[k] for k in model.state_dict()}, strict=True)
        logger.info("Loaded model weights from %s", path)

    def resume_or_load(self, weights_path: str, state, resume: bool = True) -> None:
        """With `resume` and a marker: the newest save. Otherwise
        MODEL.WEIGHTS when set: a file this checkpointer wrote (the whole
        training state, as the JAX package restores its own checkpoints).
        A path that is set but missing raises."""
        if resume and self.has_checkpoint():
            self.load(self.get_checkpoint_file(), state)
        elif weights_path:
            if not os.path.exists(weights_path):
                raise FileNotFoundError(f"MODEL.WEIGHTS: {weights_path} does not exist")
            self.load(weights_path, state)
