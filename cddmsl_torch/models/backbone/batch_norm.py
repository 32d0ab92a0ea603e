"""The trainable norms and the state that trains without gradients
(counterpart of cddmsl_tpu/models/backbone/batch_norm.py `SyncBatchNorm`,
`update_bn_stats` and `GroupNorm32`).

JAX keeps running statistics in the flax `batch_stats` collection and
updates them only where the apply makes that collection mutable: the
supervised forward of the train step and PreciseBN's forwards. Every other
apply (eval, the consistency branches, the converters) reads them. Here the
same state lives in buffers of `RunningState` modules, which no optimizer
sees, and `updating_running_state(model)` is the mutable apply: inside it a
`SyncBatchNorm` normalizes by the batch's statistics and moves its running
ones, outside it normalizes by the running ones and changes nothing.
RetinaNet's EMA loss normalizer is such state too (models/retinanet.py).

`SyncBatchNorm` is written out rather than taken from `nn.BatchNorm2d` or
`nn.SyncBatchNorm`: torch weighs the new statistic by its momentum (0.1)
where JAX weighs the old one (0.9), and torch's running variance is the
unbiased one where JAX's is the batch's biased `mean2 - mean^2`. Either
convention parts from JAX's state at the first step.

Under a process group the batch's mean and mean of squares are averaged
over the ranks (`sync_mean`): every rank holds an equal share of the
global batch at the same padded shape, so that average is the global
batch's statistic, as JAX takes it inside its one program. The gradient
flows back through the same average, so the ranks' gradient mean is the
single process's gradient.
"""

import contextlib
from typing import Callable, Dict, Iterable, Iterator

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ...parallel import comm


class RunningState(nn.Module):
    """A module whose buffers are state a mutable apply updates: set
    `updating` through `updating_running_state`."""

    updating = False

    def running_state_names(self) -> Iterable[str]:
        """The names of the buffers that form the state (JAX's
        `batch_stats` leaves of this module)."""
        return ()


@contextlib.contextmanager
def updating_running_state(model: nn.Module) -> Iterator[None]:
    """Within the block every `RunningState` of `model` is in the mutable
    apply's mode and afterwards in the mode it had."""
    mods = [m for m in model.modules() if isinstance(m, RunningState)]
    before = [m.updating for m in mods]
    for m in mods:
        m.updating = True
    try:
        yield
    finally:
        for m, b in zip(mods, before):
            m.updating = b


def running_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{state-dict name: buffer} of every `RunningState` leaf of `model`:
    what JAX's `batch_stats` collection holds."""
    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, RunningState):
            for name in mod.running_state_names():
                out[f"{prefix}.{name}" if prefix else name] = getattr(mod, name)
    return out


class _SyncMean(torch.autograd.Function):
    """The mean over the ranks, forward and backward (the transpose of a
    mean is a mean)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out / comm.get_world_size()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g / comm.get_world_size()


def sync_mean(x: torch.Tensor) -> torch.Tensor:
    """x averaged over the ranks, with its gradient averaged back; x itself
    on one process."""
    return x if comm.get_world_size() == 1 else _SyncMean.apply(x)


class SyncBatchNorm(RunningState):
    """Batch norm over the global batch (JAX's `SyncBatchNorm`): in the
    mutable apply the float32 mean and mean of squares of the batch over
    every axis but the channels (synchronised over the ranks), the biased
    variance max(mean2 - mean^2, 0), and the running statistics moved to
    m * old + (1 - m) * new (m = 0.9); otherwise the running statistics.
    eps 1e-5; the result is cast back to the input's dtype. Inputs are
    (N, C, ...) channel-first."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def running_state_names(self):
        return ("running_mean", "running_var")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.updating:
            red = (0,) + tuple(range(2, x.dim()))
            mean = sync_mean(xf.mean(dim=red))
            mean2 = sync_mean(torch.square(xf).mean(dim=red))
            var = torch.clamp(mean2 - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean.reshape(shape)) * inv.reshape(shape) + self.bias.reshape(shape)).to(x.dtype)


class GroupNorm32(nn.Module):
    """detectron2's get_norm("GN"): min(32, C) groups, eps 1e-5, the
    statistics and the affine map in float32 whatever the input's dtype,
    the result cast back to it (as JAX's `GroupNorm32`). `F.group_norm`
    takes a contiguous copy: on an H100 over a channels_last map its
    gradient put a narrow GN Mask R-CNN's float32 step 8.2e-3 of the
    update's norm from the CPU's, on the copy 3.7e-6 (`chip_smoke.py`'s
    `check_tiny_norms_against_cpu`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.num_groups = min(32, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C, ...) -> the same shape and dtype."""
        y = F.group_norm(x.float().contiguous(), self.num_groups, self.weight.float(), self.bias.float(), 1e-5)
        return y.to(x.dtype)


def make_norm(norm: str, channels: int) -> nn.Module:
    """RESNETS/FPN/ROI_*_HEAD NORM as JAX's `_make_norm` reads it: "GN" is
    `GroupNorm32`, "SyncBN" `SyncBatchNorm`; "FrozenBN", "BN" and "" are
    FrozenBN (JAX's stand-in for an eval-mode "BN")."""
    from .clip_resnet import FrozenBatchNorm2d

    if norm in ("FrozenBN", "BN", ""):
        return FrozenBatchNorm2d(channels)
    if norm == "GN":
        return GroupNorm32(channels)
    if norm == "SyncBN":
        return SyncBatchNorm(channels)
    raise ValueError(f"unsupported norm {norm!r} (FrozenBN/BN/GN/SyncBN)")


def head_norm(norm: str, channels: int):
    """The norm after a head's conv (FPN.NORM, ROI_BOX_HEAD.NORM,
    ROI_MASK_HEAD.NORM): none for "", else GN or SyncBN."""
    if norm == "":
        return None
    if norm in ("GN", "SyncBN"):
        return make_norm(norm, channels)
    raise ValueError(f"unsupported head norm {norm!r} ('', GN, SyncBN)")


@torch.no_grad()
def update_bn_stats(model: nn.Module, forward: Callable[[object], object], batches: Iterable,
                    momentum: float = 0.9) -> Dict[str, torch.Tensor]:
    """PreciseBN (JAX's `update_bn_stats`): the running state re-estimated
    as the equal-weight mean of the batches' own statistics. Each batch's
    `forward(batch)` runs in the mutable apply from the same starting
    state; its raw statistic is recovered by inverting the EMA, (new - m *
    old) / (1 - m), as JAX recovers it, and the state is restored before
    the next. Returns {name: the mean}; the model's state is left as it
    was (with no batch, the state itself)."""
    state = running_state(model)
    orig = {k: v.clone() for k, v in state.items()}
    acc, n = None, 0
    for batch in batches:
        with updating_running_state(model):
            forward(batch)
        raw = {k: (state[k] - momentum * orig[k]) / (1.0 - momentum) for k in state}
        acc = raw if acc is None else {k: acc[k] + raw[k] for k in acc}
        n += 1
        for k, v in state.items():
            v.copy_(orig[k])
    if n == 0:
        return orig
    return {k: v / n for k, v in acc.items()}
