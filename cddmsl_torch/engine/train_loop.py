"""The CDDMSL training step (counterpart of cddmsl_tpu/engine/train_loop.py
`make_train_step` without shardings, and of `make_caption_pl_step`).

One step: `GeneralizedRCNN.cddmsl_losses` with the caption branches on past
burn-up (`iteration > caption_burnup_iters`, a host comparison), the sum of
the losses, backward, the optimizer step, iteration + 1. With
`accum_steps` > 1 the batch is split along its first dimension into that
many equal microbatches; their losses and gradients are summed, scaled by
1 / accum_steps, and the optimizer steps once: one iteration per call. The
InfoNCE losses then see microbatch-sized pools, as in JAX. The sampler draws
come from a `torch.Generator` on the model's device unless the caller hands
in a `Draw`; a split step draws each site once for the whole batch and
gives each microbatch its rows (`rank_draw`).

Under a process group each rank steps its rows of the global batch (its
block of each global microbatch): the draws are its rows of the global
draws, the losses divide by global counts and InfoNCE gathers every rank's
rows (parallel/comm.py), and `Optimizer.step` averages the gradients over
the ranks once, after the last microbatch, before clipping. The result is
the single process's step on the global batch.

With `consistency_branch` "image" or "image_region" every step, from step 0
(no burn-up), adds the language-free InfoNCE of that branch, times
`consistency_weight`, to the same loss dict and the same update, as
f"{branch}_cont_loss".

`make_caption_pl_step` is the pseudo-label caption step of the
"caption_pl_img" / "caption_pl_region" branches: a second update per
iteration, run after the main step on the same batch. The caption model is
frozen and lives outside the detector, so checkpoints do not hold it. The
optimizer steps again, so it counts two per iteration: the second update
reads the LR at the count after the main one, decays and applies momentum
again, and clips its own gradient, as optax does in the JAX step.
"""

from typing import Callable, Dict, Optional, Sequence

import torch

from ..models.caption import ClipCaptionModel, pseudo_labeling_loss, unsupervised_kl_loss
from ..models.rcnn import DetBatch, GeneralizedRCNN
from ..models.sampling import Draw, generator_draw, rank_draw
from ..solver.build import Optimizer


def split_batch(batch: DetBatch, parts: int) -> Sequence[DetBatch]:
    """`parts` equal microbatches along the first dimension of every field."""
    b = batch.image.shape[0]
    if b % parts:
        raise ValueError(f"batch dim {b} not divisible by accum_steps={parts}")
    m = b // parts
    return [DetBatch(*(None if f is None else f[i * m : (i + 1) * m] for f in batch)) for i in range(parts)]


def check_state_keys(state: Dict, want) -> None:
    """Raises ValueError unless the save `state` holds exactly the entries
    `want`: a save of the plain trainer and one of the mean-teacher trainer
    do not restore into each other."""
    if state.keys() != set(want):
        raise ValueError(f"the save holds {sorted(state)}, this training state {sorted(want)}: a mean-teacher "
                         f"save restores only into the mean-teacher trainer, and the reverse")


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
        consistency_branch: str = "",
        consistency_weight: float = 1.0,
    ):
        if consistency_branch not in ("", "image", "image_region"):
            raise ValueError(f"consistency_branch {consistency_branch!r} is not a branch of the step")
        self.model = model
        self.optimizer = optimizer
        self.caption_burnup_iters = caption_burnup_iters
        self.iteration = iteration
        self.draw = generator_draw(generator) if generator is not None else None
        self.kd_regularization = kd_regularization
        self.enable_caption = enable_caption
        self.accum_steps = accum_steps
        self.consistency_branch = consistency_branch
        self.consistency_weight = consistency_weight

    def _losses(self, batch: DetBatch, draw: Draw, caption_on: bool) -> Dict[str, torch.Tensor]:
        losses = self.model.cddmsl_losses(batch, draw, caption_on, self.kd_regularization, self.enable_caption)
        branch = self.consistency_branch
        if branch:
            model = self.model
            extra = model.image_consistency(batch) if branch == "image" else model.image_consistency_region(batch, draw)
            for k, v in extra.items():
                losses[f"{branch}_{k}"] = v * self.consistency_weight
        return losses

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
        draw = rank_draw(draw, batch.image.shape[0], n)
        caption_on = self.iteration > self.caption_burnup_iters
        self.optimizer.zero_grad()
        total, losses = None, None
        with torch.enable_grad():
            for mb in micro:
                ls = self._losses(mb, draw, caption_on)
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
        """Restores a `state_dict` of a training build, whatever branch it
        was trained under. A mean-teacher save holds more than this state
        and raises, as orbax refuses it in the JAX package's `TrainState`."""
        check_state_keys(state, self.state_dict().keys())
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.iteration = int(state["iteration"])


def make_caption_pl_step(
    model: GeneralizedRCNN,
    caption_model: ClipCaptionModel,
    optimizer: Optimizer,
    level: str = "img",
    loss_type: str = "pseudo_label",
    max_len: int = 20,
    loss_weight: float = 1.0,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """-> pl_step(batch, draw=None) -> {"token-pl_loss" or
    "token-pl-region_loss": loss}. One update of the detector by the
    pseudo-label loss (or with `loss_type` "kl" the KL loss) of the frozen
    caption model on the prefixes of `level` "img" (the views' CLIP
    embeddings) or "region" (region embeddings; its boxes come from `draw`),
    times `loss_weight`. It does not advance the trainer's iteration."""
    if level not in ("img", "region") or loss_type not in ("pseudo_label", "kl"):
        raise ValueError(f"caption pl step: level {level!r}, loss {loss_type!r}")
    loss_fn = pseudo_labeling_loss if loss_type == "pseudo_label" else unsupervised_kl_loss
    name = "token-pl_loss" if level == "img" else "token-pl-region_loss"

    def pl_step(batch: DetBatch, draw: Optional[Draw] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        with torch.enable_grad():
            if level == "img":
                p_src, p_trgt = model.caption_pl_prefixes(batch)
            else:
                p_src, p_trgt = model.caption_pl_region_prefixes(batch, rank_draw(draw, batch.image.shape[0]))
            loss = loss_fn(caption_model, p_src, p_trgt, max_len=max_len) * loss_weight
            loss.backward()
        optimizer.step()
        return {name: loss.detach()}

    return pl_step
