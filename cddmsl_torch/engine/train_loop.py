"""The CDDMSL training step (counterpart of cddmsl_tpu/engine/train_loop.py
`make_train_step` without the language-free consistency branch and without
shardings).

One step: `GeneralizedRCNN.cddmsl_losses` with the caption branches on past
burn-up (`iteration > caption_burnup_iters`, a host comparison), the sum of
the losses, backward, the optimizer step, iteration + 1. With
`accum_steps` > 1 the batch is split along its first dimension into that
many equal microbatches, each with its own draws (JAX splits its key per
microbatch); their losses and gradients are summed, scaled by
1 / accum_steps, and the optimizer steps once: one iteration per call. The
InfoNCE losses then see microbatch-sized pools, as in JAX. The sampler draws
come from a `torch.Generator` on the model's device unless the caller hands
in a `Draw`.
"""

from typing import Dict, Optional, Sequence

import torch

from ..models.rcnn import DetBatch, GeneralizedRCNN
from ..models.sampling import Draw, generator_draw
from ..solver.build import Optimizer


def split_batch(batch: DetBatch, parts: int) -> Sequence[DetBatch]:
    """`parts` equal microbatches along the first dimension of every field."""
    b = batch.image.shape[0]
    if b % parts:
        raise ValueError(f"batch dim {b} not divisible by accum_steps={parts}")
    m = b // parts
    return [DetBatch(*(None if f is None else f[i * m : (i + 1) * m] for f in batch)) for i in range(parts)]


class Trainer:
    """The training state (model, optimizer, iteration) and its step: the
    counterpart of the JAX package's `TrainState` with `make_train_step`."""

    def __init__(
        self,
        model: GeneralizedRCNN,
        optimizer: Optimizer,
        caption_burnup_iters: int = 10000,
        iteration: int = 0,
        generator: Optional[torch.Generator] = None,
        kd_regularization: bool = True,
        enable_caption: bool = True,
        accum_steps: int = 1,
    ):
        self.model = model
        self.optimizer = optimizer
        self.caption_burnup_iters = caption_burnup_iters
        self.iteration = iteration
        self.draw = generator_draw(generator) if generator is not None else None
        self.kd_regularization = kd_regularization
        self.enable_caption = enable_caption
        self.accum_steps = accum_steps

    def train_step(self, batch: DetBatch, draw: Optional[Draw] = None) -> Dict[str, torch.Tensor]:
        """Runs one step; returns the losses, `total_loss` and `lr`: the
        schedule at this iteration, as the JAX step reports it, though the
        update uses the LR at the optimizer's own count. The microbatches
        draw from `draw` one after another. The losses stay on the device:
        reading them is the caller's sync."""
        draw = draw or self.draw
        if draw is None:
            raise ValueError("Trainer.train_step needs a draw or a generator")
        n = self.accum_steps
        micro = split_batch(batch, n) if n > 1 else [batch]
        caption_on = self.iteration > self.caption_burnup_iters
        self.optimizer.zero_grad()
        total, losses = None, None
        with torch.enable_grad():
            for mb in micro:
                ls = self.model.cddmsl_losses(mb, draw, caption_on, self.kd_regularization, self.enable_caption)
                t = torch.stack(list(ls.values())).sum()
                t.backward()
                ls = {k: v.detach() for k, v in ls.items()}
                total = t.detach() if total is None else total + t.detach()
                losses = ls if losses is None else {k: losses[k] + v for k, v in ls.items()}
        if n > 1:
            inv = 1.0 / n
            for p in self.optimizer.params:
                if p.grad is not None:
                    p.grad.mul_(inv)
            total = total * inv
            losses = {k: v * inv for k, v in losses.items()}
        self.optimizer.step()
        metrics = dict(losses)
        metrics["total_loss"] = total
        metrics["lr"] = torch.tensor(self.optimizer.schedule(self.iteration))
        self.iteration += 1
        return metrics

    def state_dict(self) -> Dict:
        """What a checkpoint holds: the model's parameters and buffers, the
        optimizer's momentum buffers and count, and the iteration."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "iteration": self.iteration}

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.iteration = int(state["iteration"])
