"""Balanced positive/negative subsampling with fixed shapes (counterpart of
cddmsl_tpu/models/sampling.py `_select_k_smallest`, `subsample_labels` and
`gather_selected`).

Every candidate gets a uniform key; a group keeps its members whose key is
among the `count` smallest. The uniforms are arguments, never drawn here:
the model asks a `Draw` for them by the name of their draw site, so a test
can hand in the JAX package's own draws and the trainer those of a
`torch.Generator` (`generator_draw`). All functions take leading batch
dimensions.
"""

from typing import Callable, Dict, Sequence, Tuple

import torch

from ..parallel import comm

# (site name, shape) -> float32 uniforms in [0, 1) on the model's device
Draw = Callable[[str, Tuple[int, ...]], torch.Tensor]


def generator_draw(generator: torch.Generator) -> Draw:
    """A `Draw` that takes every site's uniforms from `generator`, on the
    generator's device."""

    def draw(site: str, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.rand(shape, generator=generator, device=generator.device)

    return draw


class BlockDraw:
    """A `Draw` for a step whose rows are rows of a global batch of `total`
    images: each site draws the global shape (total, ...) from `draw` once,
    and its k-th call gets the rows blocks[k] of that draw. The k-th call
    at a site is the k-th microbatch's, so a row of the global batch gets
    the same uniforms however the step is split, over ranks or
    microbatches. Every draw site's leading dimension is the batch: "rpn_pos"
    and "rpn_neg" (B, anchors), "roi_pos", "roi_neg" and "roi_gather" (B,
    proposals + ground truth), "region", "image_region" and
    "caption_pl_region" (B, proposals). The pseudo-label decode is greedy
    and draws nothing, and the mean teacher's strong augmentation draws on
    the loader, which every rank walks alike."""

    def __init__(self, draw: Draw, total: int, blocks: Sequence[Tuple[int, int]]):
        self._draw = draw
        self._total = total
        self._blocks = list(blocks)
        self._drawn: Dict[str, torch.Tensor] = {}
        self._calls: Dict[str, int] = {}

    def __call__(self, site: str, shape: Tuple[int, ...]) -> torch.Tensor:
        k = self._calls.get(site, 0)
        self._calls[site] = k + 1
        if k == 0:
            self._drawn[site] = self._draw(site, (self._total,) + tuple(shape[1:]))
        full = self._drawn[site]
        lo, hi = self._blocks[k]
        if full.shape[1:] != tuple(shape[1:]) or hi - lo != shape[0]:
            raise ValueError(f"draw site {site!r}: call {k} asks for {tuple(shape)}, the step's rows are "
                             f"{(lo, hi)} of {tuple(full.shape)}")
        return full[lo:hi]


def rank_draw(draw: Draw, rows: int, parts: int = 1) -> Draw:
    """`draw` for a step of this rank's `rows` rows in `parts` microbatches:
    a `BlockDraw` over the global batch, whose microbatch j is its rows
    [j * m, (j + 1) * m) and this rank's rows of it its `local_rows` block
    (as the loader gives them, data/build.py `_process_block`); or `draw`
    itself for one process stepping its batch whole."""
    world = comm.get_world_size()
    if parts == 1 and world == 1:
        return draw
    if rows % parts:
        raise ValueError(f"batch dim {rows} not divisible by accum_steps={parts}")
    m = rows // parts * world
    lo, hi = comm.local_rows(m)
    return BlockDraw(draw, rows * world, [(j * m + lo, j * m + hi) for j in range(parts)])


def _select_k_smallest(keys_masked: torch.Tensor, quota_cap: int, count: torch.Tensor) -> torch.Tensor:
    """keys (..., n) with +inf for non-members, count (...) <= quota_cap ->
    (..., n) bool: the keys not above the count-th smallest (`keys <= thr`,
    so a tie at the threshold keeps every tied key)."""
    k = min(quota_cap, keys_masked.shape[-1])
    if k == 0:
        return torch.zeros(keys_masked.shape, dtype=torch.bool, device=keys_masked.device)
    smallest = torch.sort(keys_masked, dim=-1, stable=True).values[..., :k]
    pos = torch.clamp(count - 1, 0, k - 1).to(torch.int64)
    thr = torch.gather(smallest, -1, pos[..., None])
    return (keys_masked <= thr) & (count > 0)[..., None]


def subsample_labels(
    positive: torch.Tensor,
    negative: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
    u_pos: torch.Tensor,
    u_neg: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to num_samples * positive_fraction random positives, the rest
    random negatives. positive/negative (..., n) bool and their uniforms
    (..., n) -> (pos_selected, neg_selected) bool masks."""
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=positive.device)
    rnd_pos = torch.where(positive, u_pos, inf)
    rnd_neg = torch.where(negative, u_neg, inf)
    num_pos_target = int(num_samples * positive_fraction)
    num_pos = torch.clamp(positive.sum(-1), max=num_pos_target)
    pos_sel = positive & _select_k_smallest(rnd_pos, num_pos_target, num_pos)
    num_neg = torch.minimum(negative.sum(-1), num_samples - num_pos)
    neg_sel = negative & _select_k_smallest(rnd_neg, num_samples, num_neg)
    return pos_sel, neg_sel


def gather_selected(
    pos_sel: torch.Tensor, neg_sel: torch.Tensor, capacity: int, u: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packs the selected indices into a fixed-size buffer, positives first,
    each group in the random order of its uniforms u (..., n). Returns idx
    (..., capacity) int64, 0 where padded, and valid (..., capacity)."""
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=pos_sel.device)
    sort_key = torch.where(pos_sel, u, torch.where(neg_sel, 1.0 + u, inf))
    keys, order = torch.sort(sort_key, dim=-1, stable=True)
    valid = keys[..., :capacity] < inf
    idx = torch.where(valid, order[..., :capacity], torch.zeros_like(order[..., :capacity]))
    n = pos_sel.shape[-1]
    if capacity > n:
        pad = pos_sel.shape[:-1] + (capacity - n,)
        idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(pad)], dim=-1)
    return idx, valid
