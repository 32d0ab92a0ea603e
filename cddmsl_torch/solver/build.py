"""Optimizer and LR schedule (counterpart of cddmsl_tpu/solver/build.py
`build_lr_schedule`, `path_is_frozen` and `build_optimizer`).

The JAX chain is: zero the frozen gradients, clip, coupled weight decay on
trainable parameters, momentum, LR. Here frozen parameters get
`requires_grad=False` and stay out of the optimizer; the rest runs in the
same order. Three details follow optax rather than torch's habits:

- the LR is read at the optimizer's own count, which starts at 0 whatever
  the training step is (`optax.scale_by_learning_rate` keeps its own
  counter);
- SOLVER.CLIP_GRADIENTS clips only when ENABLED. By value each element is
  clamped to [-clip_value, clip_value] (`optax.clip`); by norm every
  trainable gradient g becomes (g / n) * clip_value when their global norm
  n is at least clip_value (`optax.clip_by_global_norm`: no epsilon, unlike
  `torch.nn.utils.clip_grad_norm_`). Frozen gradients are zero in the JAX
  chain at that point, so the norm is the trainable gradients' alone;
- a parameter the loss did not reach has a zero gradient, not none.

Under a process group `step` first averages the gradients over the ranks
(one all-reduce per dtype), so clipping and the update read the global
batch's gradient, as JAX's chain does; every update goes through it (the
main step, the caption pl step, the discriminator's).
"""

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..config import SolverConfig
from ..parallel import comm

_ALWAYS_FROZEN = ("offline_backbone.", "v2l_mapper.")
_STEM = ("conv1", "conv2", "conv3", "bn1", "bn2", "bn3")


def _pow_f32(x: float, n: int) -> np.float32:
    """x ** n in float32 by square-and-multiply, rounded as XLA's power to
    an integer exponent rounds it (gamma ** milestones passed)."""
    acc, base = np.float32(1.0), np.float32(x)
    while n:
        if n & 1:
            acc = np.float32(acc * base)
        base = np.float32(base * base)
        n >>= 1
    return acc


def build_lr_schedule(cfg: SolverConfig) -> Callable[[int], float]:
    """step -> LR of WarmupMultiStepLR or WarmupCosineLR with a linear or
    constant warmup, in float32 as the JAX schedule computes it."""
    f32 = np.float32
    if cfg.warmup_method not in ("linear", "constant"):
        raise ValueError(cfg.warmup_method)
    if cfg.lr_scheduler_name not in ("WarmupMultiStepLR", "WarmupCosineLR"):
        raise ValueError(cfg.lr_scheduler_name)

    def schedule(step: int) -> float:
        s = f32(step)
        wf = f32(1.0)
        if s < cfg.warmup_iters:
            if cfg.warmup_method == "linear":
                alpha = f32(s / f32(max(cfg.warmup_iters, 1)))
                wf = f32(f32(f32(cfg.warmup_factor) * f32(f32(1.0) - alpha)) + alpha)
            else:
                wf = f32(cfg.warmup_factor)
        lr = f32(f32(cfg.base_lr) * wf)
        if cfg.lr_scheduler_name == "WarmupMultiStepLR":
            return float(f32(lr * _pow_f32(cfg.gamma, sum(int(s >= f32(m)) for m in cfg.steps))))
        # XLA's float32 cosine agrees with the float64 one rounded once far
        # more often than with numpy's float32 cosine
        cos = f32(np.cos(np.float64(f32(f32(f32(math.pi) * s) / f32(cfg.max_iter)))))
        return float(f32(f32(lr * f32(0.5)) * f32(f32(1.0) + cos)))

    return schedule


def parameter_is_frozen(name: str, freeze_at: int = 2) -> bool:
    """`path_is_frozen` on the port's parameter names: the offline backbone
    and the mapper always, the text-embedding classifier rows, and the
    backbone's stem (freeze_at >= 1) and first freeze_at - 1 stages.
    FrozenBN statistics are buffers, not parameters."""
    if name.startswith(_ALWAYS_FROZEN):
        return True
    if name == "roi_heads.box_predictor.cls_score.weight":
        return True
    parts = name.split(".")
    if parts[0] == "backbone" and len(parts) > 1:
        head = parts[1]
        if freeze_at >= 1 and head in _STEM:
            return True
        for stage in range(1, 5):
            if freeze_at >= stage + 1 and head == f"layer{stage}":
                return True
    return False


class Optimizer:
    """SGD with momentum, coupled weight decay and the optional clip over
    the trainable parameters, with the LR of `schedule` at its own count."""

    def __init__(self, params: List[nn.Parameter], cfg: SolverConfig):
        if cfg.clip_type not in ("value", "norm"):
            raise ValueError(cfg.clip_type)
        self.params = params
        self.cfg = cfg
        self.schedule = build_lr_schedule(cfg)
        self.count = 0
        self.sgd = torch.optim.SGD(params, lr=0.0, momentum=cfg.momentum, weight_decay=cfg.weight_decay)

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def _clip(self, grads: List[torch.Tensor]) -> None:
        c = self.cfg.clip_value
        if self.cfg.clip_type == "value":
            for g in grads:
                g.clamp_(-c, c)
            return
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < c
        for g in grads:
            # (g / n) * c, rounded as optax rounds it
            g.copy_(torch.where(keep, g, (g / norm) * c))

    def step(self) -> None:
        # a parameter the loss did not reach still decays and keeps its
        # momentum, as in optax: its gradient is zero, not absent
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        comm.all_reduce_mean_([p.grad for p in self.params])
        if self.cfg.clip_enabled:
            self._clip([p.grad for p in self.params])
        lr = self.schedule(self.count)
        for group in self.sgd.param_groups:
            group["lr"] = lr
        self.sgd.step()
        self.count += 1

    def state_dict(self) -> Dict:
        """The momentum buffers and the count the LR is read at."""
        return {"sgd": self.sgd.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.sgd.load_state_dict(state["sgd"])
        self.count = int(state["count"])


def build_optimizer(model: nn.Module, cfg: SolverConfig) -> Optimizer:
    """Marks the frozen parameters `requires_grad=False` and returns the
    optimizer of the others."""
    trainable = []
    for name, p in model.named_parameters():
        frozen = parameter_is_frozen(name, cfg.freeze_at)
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return Optimizer(trainable, cfg)


def split_parameters(model: nn.Module) -> Tuple[List[str], List[str]]:
    """(trainable names, frozen names) as `requires_grad` marks them."""
    names = [(n, p.requires_grad) for n, p in model.named_parameters()]
    return [n for n, t in names if t], [n for n, t in names if not t]
