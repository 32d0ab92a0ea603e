"""Checkpoint save and resume (counterpart of
cddmsl_tpu/checkpoint/checkpointer.py `DetectionCheckpointer`).

A checkpoint is one `torch.save` file, `<save_dir>/<name>.pth`, holding the
training state's `state_dict()` (engine/train_loop.py `Trainer`): the model's
parameters and buffers, the SGD momentum buffers, the optimizer's own count
(the LR is read at it) and the iteration; a mean-teacher save
(engine/mean_teacher.py `MTState`) adds the teacher, the discriminator and
its optimizer. A `last_checkpoint` marker names
the newest save, which `resume_or_load` restores. With `max_to_keep` > 0 only
that many periodic saves stay on disk; `model_final` and the resume target
are never removed.

MODEL.WEIGHTS may name such a save or, ending in .pth, .pt or .pkl as the
JAX package routes them, a reference detector checkpoint, which
`convert_torch.load_rcnn_weights` converts. The two are told apart by
content (`is_port_save`), since both end in .pth and a detectron2
`model_final.pth` also holds "model", "optimizer" and "iteration".
"""

import logging
import os
import pickle
from typing import Dict, List, Optional

import torch
from torch import nn

from ..parallel import comm
from .convert_torch import load_rcnn_weights

logger = logging.getLogger(__name__)

_LAST = "last_checkpoint"
_PROTECTED = ("model_final",)
REFERENCE_SUFFIXES = (".pth", ".pt", ".pkl")


def is_port_save(obj) -> bool:
    """Whether `obj`, a loaded file, was written by `save`: it holds the
    optimizer entry of `solver.build.Optimizer.state_dict` ({"sgd",
    "count"}), which a detectron2 save (a torch optimizer's {"state",
    "param_groups"}) never holds."""
    if not isinstance(obj, dict):
        return False
    optimizer = obj.get("optimizer")
    return {"model", "iteration"} <= obj.keys() and isinstance(optimizer, dict) and optimizer.keys() == {"sgd", "count"}


def _check_exists(path: str) -> None:
    if not os.path.exists(path):
        raise FileNotFoundError(f"MODEL.WEIGHTS: {path} does not exist")


class DetectionCheckpointer:
    def __init__(self, save_dir: str, max_to_keep: int = 0):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._recent: List[str] = []  # the periodic saves, oldest first

    def save(self, name: str, state) -> str:
        """Writes `state.state_dict()` to `<name>.pth` (through a temporary
        file, so a cut save leaves the last one whole) and points the
        marker at it. Under a process group rank 0 writes (every rank holds
        the same state) and the ranks meet at a barrier after it."""
        path = os.path.join(self.save_dir, name + ".pth")
        if comm.is_main_process():
            tmp = path + ".tmp"
            torch.save(state.state_dict(), tmp)
            os.replace(tmp, path)
            with open(os.path.join(self.save_dir, _LAST), "w") as f:
                f.write(name + ".pth")
            logger.info("Saved checkpoint to %s", path)
        if name not in _PROTECTED:
            self._recent.append(path)
            self._gc()
        comm.synchronize()
        return path

    def _gc(self) -> None:
        if self.max_to_keep <= 0 or not comm.is_main_process():
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
    def read(path: str) -> Optional[Dict]:
        """A file written by `save`, read on the CPU (restoring copies it onto
        the model's and the optimizer's devices, each rank onto its own);
        None for any other file.
        `save` writes tensors, numbers and strings only, so the file is read
        with `weights_only`; one that needs more is not ours."""
        try:
            saved = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:
            return None
        return saved if is_port_save(saved) else None

    def load(self, path: str, state) -> None:
        """Restores a file written by `save` into `state` on its devices."""
        saved = self.read(path)
        if saved is None:
            raise ValueError(f"{path} was not written by this checkpointer")
        state.load_state_dict(saved)
        logger.info("Restored checkpoint from %s", path)

    @classmethod
    def _load_weights(cls, path: str, model: nn.Module) -> Optional[Dict]:
        """MODEL.WEIGHTS: a file `save` wrote is returned for the caller to
        restore; a reference checkpoint is converted into `model` and None
        returned. Any other file raises."""
        saved = cls.read(path)
        if saved is not None:
            return saved
        if not path.endswith(REFERENCE_SUFFIXES):
            raise ValueError(f"MODEL.WEIGHTS: {path} was not written by this checkpointer and does not end in "
                             f"{' or '.join(REFERENCE_SUFFIXES)}")
        dialect = load_rcnn_weights(model, path)
        logger.info("Loaded the %s checkpoint %s", dialect, path)
        return None

    @classmethod
    def load_model(cls, path: str, model: nn.Module) -> None:
        """MODEL.WEIGHTS into the model alone: from a file written by `save`
        its own parameters and buffers (a serving build takes its subset of
        the training build's), else a reference checkpoint."""
        _check_exists(path)
        saved = cls._load_weights(path, model)
        if saved is None:
            return
        saved = saved["model"]
        missing = model.state_dict().keys() - saved.keys()
        if missing:
            raise KeyError(f"{path} lacks {sorted(missing)[:5]}")
        model.load_state_dict({k: saved[k] for k in model.state_dict()}, strict=True)
        logger.info("Loaded model weights from %s", path)

    def load_weights(self, weights_path: str, state) -> None:
        """MODEL.WEIGHTS into `state`: a file this checkpointer wrote
        restores the whole training state (as the JAX package restores its
        own checkpoints); a reference checkpoint loads into the model. A
        missing file raises."""
        _check_exists(weights_path)
        saved = self._load_weights(weights_path, state.model)
        if saved is not None:
            state.load_state_dict(saved)
            logger.info("Restored checkpoint from %s", weights_path)

    def resume_or_load(self, weights_path: str, state, resume: bool = True) -> None:
        """With `resume` and a marker: the newest save. Otherwise
        MODEL.WEIGHTS when set (`load_weights`)."""
        if resume and self.has_checkpoint():
            self.load(self.get_checkpoint_file(), state)
        elif weights_path:
            self.load_weights(weights_path, state)
