"""Data parallelism across processes (counterpart of
cddmsl_tpu/parallel/multihost.py: `initialize`, `get_world_size`,
`get_rank`, `is_main_process`, `synchronize`, `local_rows` and `fetch`).

One process per device, joined by `torch.distributed`: NCCL on the card,
gloo on the CPU (gloo also carries CUDA tensors, through the host, which
lets two processes share one card). Every rank holds the whole model and
the same parameters; each steps its contiguous row-block of the global
batch (`local_rows`). What makes a world of N ranks give the JAX package's
one global-batch program:

- the gradients are averaged over the ranks before clipping and the
  update (`all_reduce_mean_`, from `Optimizer.step`);
- a loss that is a mean over a count that differs per rank divides by the
  global count shared out over the ranks (`global_normalizer`), so the
  ranks' mean is the global loss;
- InfoNCE sees every rank's rows (`all_gather_with_grad`), each rank
  computes the whole loss, and the gradient flows back to each rank's rows;
- each draw site gives a rank its rows of the global draw
  (models/sampling.py `rank_draw`).

Without a process group (one process, as the tests and `--num-gpus 1` run)
every function here is the identity or a no-op. JAX's `warm_and_align`
has no counterpart: it works around a 30 s window of jaxlib's gloo cliques,
which torch.distributed does not have.
"""

import logging
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def initialize(backend: str, init_method: str, world_size: int, rank: int, local_rank: int = 0,
               device: str = "cuda") -> None:
    """Joins the process group as global `rank` of `world_size`. On the card
    the rank's device, cuda:(local_rank modulo the cards), becomes the
    current one before anything is launched. Raises if the group cannot be
    formed or a rank has no card: a distributed run never goes on as one
    process."""
    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(f"rank {rank}: CUDA is not available; pass device='cpu' to run on the CPU")
        if backend == "nccl" and local_rank >= n:
            raise RuntimeError(f"rank {rank}: NCCL needs a card per local rank, this machine has {n}")
        torch.cuda.set_device(local_rank % n)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    logger.info("process group (%s) initialized: rank %d/%d, local rank %d", backend, rank, world_size, local_rank)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def destroy() -> None:
    if _initialized():
        dist.destroy_process_group()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """A barrier across the ranks; nothing on one process."""
    if get_world_size() > 1:
        dist.barrier()


def local_rows(n: int, rank: Optional[int] = None, world: Optional[int] = None) -> Tuple[int, int]:
    """This rank's contiguous row-block [lo, hi) of an n-row global batch,
    so that the blocks in rank order are the global batch."""
    world = get_world_size() if world is None else world
    rank = get_rank() if rank is None else rank
    if n % world:
        raise ValueError(f"a global batch of {n} rows does not divide over {world} ranks")
    per = n // world
    return rank * per, (rank + 1) * per


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's `obj`, in rank order, on every rank (JAX's `fetch` of
    outputs that other processes hold)."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank `src`'s `obj` on every rank."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sums each tensor over the ranks, in place, through one flat buffer
    per dtype (one collective each)."""
    if get_world_size() == 1 or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset : offset + n].view(t.shape))
            offset += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Averages each tensor over the ranks, in place: the sum times 1 /
    world (a gradient's global mean; one flat buffer per dtype)."""
    world = get_world_size()
    if world == 1:
        return
    all_reduce_sum_(tensors)
    for t in tensors:
        t.mul_(1.0 / world)


def global_normalizer(count: torch.Tensor, min_value: float = 1.0) -> torch.Tensor:
    """The divisor of a loss that is a sum over this rank's rows divided by
    a count of rows (valid samples, live tokens) that can differ per rank:
    the global count, clamped to `min_value` as the single process clamps
    it, over the world. Each rank's loss is then its share of the global
    loss, and the ranks' mean (the gradient all-reduce) is the global-batch
    loss. On one process: the count clamped, as before."""
    world = get_world_size()
    if world == 1:
        return torch.clamp(count, min=min_value)
    total = count.detach().clone()
    dist.all_reduce(total)
    return torch.clamp(total, min=min_value) / world


class _AllGatherWithGrad(torch.autograd.Function):
    """All ranks' rows of x, in rank order; the backward gives each rank the
    sum over the ranks of the gradient of its own rows (the transpose of
    the gather, as XLA's all-gather has). Every rank holds the same rows
    per rank; the gather rides an all-reduce of a zero-padded buffer, which
    gloo carries on CUDA tensors too."""

    @staticmethod
    def forward(ctx, x):
        world, rank = get_world_size(), get_rank()
        n = x.shape[0]
        ctx.rows = (rank * n, (rank + 1) * n)
        out = x.new_zeros((world * n,) + tuple(x.shape[1:]))
        out[rank * n : (rank + 1) * n] = x
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        lo, hi = ctx.rows
        return g[lo:hi]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of x (the same number on each), in rank order, with
    the gradient flowing back to each rank's own rows; x itself on one
    process. When every rank computes the same loss of the gathered rows,
    a rank's rows get world times the loss's gradient, which the gradient
    mean over the ranks brings back to once: the global-batch gradient (the
    reference's GatherLayer keeps only its own rank's share, 1 / world of
    it)."""
    if get_world_size() == 1:
        return x
    return _AllGatherWithGrad.apply(x)
