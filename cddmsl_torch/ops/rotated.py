"""Rotated-box operations in plain PyTorch (counterpart of
cddmsl_tpu/ops/rotated.py, which JAX computes in XLA, not in Pallas).

Boxes are (cx, cy, w, h, angle in degrees, counter-clockwise), detectron2's
XYWHA_ABS.

- `pairwise_iou_rotated`: the exact intersection by Sutherland-Hodgman
  clipping of one box's quad against each edge of the other's, as JAX
  packs it: each clip step packs the points it emits by their cumulative
  offsets and sends the entries that emit nothing to one index with the
  value 0, so a scatter-add gives JAX's values. JAX keeps 16 slots through
  every step and sends them to index 15; a convex polygon clipped by a
  half-plane gains at most one vertex, so here step k reads the 4 + k slots
  its input can hold and writes 5 + k, the entries that emit nothing sent
  to the last (adding 0 leaves a point there as it is): the same points in
  the same slots, with 4, 5, 6 and 7 slots read in place of 4 x 16 (two
  rectangles meet in at most 8 vertices: `clip_vertex_counts`). A pair whose circumscribed circles
  lie more than a pixel apart has no intersection and is not clipped (its
  IoU is 0, as the clip gives it); the rest are clipped in chunks of
  `_CHUNK` pairs, so matching 100 boxes against a quarter of a million
  anchors does not hold every pair's intermediates at once.
- `nms_rotated`: greedy NMS in descending score order, ties to the lower
  index (a stable sort), equal to JAX's fixpoint over `lax.top_k` order;
  `min(max_out, N)` indices, padded with 0, and their validity.
- `roi_align_rotated`: bilinear samples on the rotated grid of each box
  (the -0.5 offset, a sample counts where -1 < y < H and -1 < x < W before
  it is clipped, the mean over S x S samples per bin), in JAX's order of
  operations; the gradient reaches the features through autograd.
"""

import math
from typing import Optional, Tuple

import torch

from .nms import _greedy_keep

_CHUNK = 1 << 20  # pairs clipped at once


def box_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2) corner points, counter-clockwise."""
    cx, cy, w, h, a = (boxes[..., i] for i in range(5))
    theta = a * (math.pi / 180.0)
    c, s = torch.cos(theta), torch.sin(theta)
    dx = torch.stack([-w, w, w, -w], -1) * 0.5
    dy = torch.stack([-h, -h, h, h], -1) * 0.5
    x = cx[..., None] + dx * c[..., None] - dy * s[..., None]
    y = cy[..., None] + dx * s[..., None] + dy * c[..., None]
    return torch.stack([x, y], dim=-1)


def _clip_against_edge(pts: torch.Tensor, count: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Clips each padded polygon (P, S, 2) of `count` (P,) vertices to the
    half-plane left of its edge p1 -> p2 (P, 2); a point on the edge is
    inside. Returns the clipped polygons (P, S + 1, 2) and their counts."""
    edge = p2 - p1
    d = edge[:, None, 0] * (pts[..., 1] - p1[:, None, 1]) - edge[:, None, 1] * (pts[..., 0] - p1[:, None, 0])
    slots = pts.shape[1]
    idx = torch.arange(slots, device=pts.device)
    succ = torch.where(idx + 1 < count[:, None], idx + 1, torch.zeros_like(idx))
    p_nxt = torch.gather(pts, 1, succ[..., None].expand(-1, -1, 2))
    d_nxt = torch.gather(d, 1, succ)
    inside_cur, inside_nxt = d >= 0, d_nxt >= 0
    den = d - d_nxt
    t = d / torch.where(torch.abs(den) > 1e-12, den, torch.full_like(den, 1e-12))
    inter = pts + t[..., None] * (p_nxt - pts)
    seg_valid = idx < count[:, None]
    emit1 = seg_valid & inside_cur  # the current point
    emit2 = seg_valid & (inside_cur != inside_nxt)  # the crossing
    n1, n2 = emit1.to(torch.int64), emit2.to(torch.int64)
    offsets = torch.cumsum(n1 + n2, dim=1) - (n1 + n2)
    last = torch.full_like(offsets, slots)
    out = pts.new_zeros(pts.shape[0], slots + 1, 2)
    for emit, pos, val in ((emit1, offsets, pts), (emit2, offsets + n1, inter)):
        where = torch.where(emit, pos, last)[..., None].expand(-1, -1, 2)
        out.scatter_add_(1, where, torch.where(emit[..., None], val, torch.zeros_like(val)))
    return out, (n1 + n2).sum(dim=1)


def _clip_pairs(c1: torch.Tensor, c2: torch.Tensor):
    """Quads c1 (P, 4, 2) clipped by quads c2 (P, 4, 2): the padded
    polygons (P, 8, 2) and their vertex counts (P,)."""
    pts = c1
    count = torch.full((c1.shape[0],), 4, dtype=torch.int64, device=c1.device)
    for i in range(4):
        pts, count = _clip_against_edge(pts, count, c2[:, i], c2[:, (i + 1) % 4])
    return pts, count


def _intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Areas (P,) of the intersections of convex quads c1 and c2 (P, 4, 2):
    the shoelace sum over the clipped ring, 0 below 3 vertices."""
    pts, count = _clip_pairs(c1, c2)
    idx = torch.arange(pts.shape[1], device=pts.device)
    succ = torch.where(idx + 1 < count[:, None], idx + 1, torch.zeros_like(idx))
    x, y = pts[..., 0], pts[..., 1]
    cross = x * torch.gather(y, 1, succ) - torch.gather(x, 1, succ) * y
    area = 0.5 * torch.abs(torch.sum(torch.where(idx < count[:, None], cross, torch.zeros_like(cross)), dim=1))
    return torch.where(count >= 3, area, torch.zeros_like(area))


def clip_vertex_counts(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, M) vertex counts of every pair's clipped polygon (for checking
    that no clip step fills the capacity)."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    c1 = box_to_corners(boxes1)[:, None].expand(n, m, 4, 2).reshape(-1, 4, 2)
    c2 = box_to_corners(boxes2)[None].expand(n, m, 4, 2).reshape(-1, 4, 2)
    return _clip_pairs(c1, c2)[1].reshape(n, m)


def clip_work(boxes1: torch.Tensor, boxes2: torch.Tensor) -> Tuple[int, int, int, int]:
    """What the clip of `pairwise_iou_rotated` needs on these boxes (for a
    bound on its time): (pairs clipped, vertices its four steps read,
    crossings they emit, vertices of the clipped rings)."""
    i, j = near_pairs(boxes1, boxes2)
    c1, c2 = box_to_corners(boxes1), box_to_corners(boxes2)
    read = crossed = ring = 0
    for lo in range(0, i.numel(), _CHUNK):
        pts, b = c1[i[lo:lo + _CHUNK]], c2[j[lo:lo + _CHUNK]]
        count = torch.full((pts.shape[0],), 4, dtype=torch.int64, device=pts.device)
        for e in range(4):
            p1, p2 = b[:, e], b[:, (e + 1) % 4]
            edge = p2 - p1
            d = edge[:, None, 0] * (pts[..., 1] - p1[:, None, 1]) - edge[:, None, 1] * (pts[..., 0] - p1[:, None, 0])
            idx = torch.arange(pts.shape[1], device=pts.device)
            inside = int(((d >= 0) & (idx < count[:, None])).sum())
            read += int(count.sum())
            pts, count = _clip_against_edge(pts, count, p1, p2)
            crossed += int(count.sum()) - inside
        ring += int(count.sum())
    return int(i.numel()), read, crossed, ring


def near_pairs(boxes1: torch.Tensor, boxes2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pairs (i, j) that `pairwise_iou_rotated` clips: those whose
    circumscribed circles come within a pixel of each other (NaN boxes'
    pairs too, as JAX clips every pair)."""
    r1 = 0.5 * torch.hypot(boxes1[:, 2], boxes1[:, 3])
    r2 = 0.5 * torch.hypot(boxes2[:, 2], boxes2[:, 3])
    dist2 = (boxes1[:, None, 0] - boxes2[None, :, 0]) ** 2 + (boxes1[:, None, 1] - boxes2[None, :, 1]) ** 2
    far = dist2 > (r1[:, None] + r2[None, :] + 1.0) ** 2
    return torch.nonzero(~far, as_tuple=True)


def pairwise_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 5), (M, 5) XYWHA -> (N, M) IoU, 0 where the union is not
    positive."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    inter = torch.zeros(n, m, dtype=boxes1.dtype, device=boxes1.device)
    if n and m:
        i, j = near_pairs(boxes1, boxes2)
        c1, c2 = box_to_corners(boxes1), box_to_corners(boxes2)
        flat = inter.view(-1)
        for lo in range(0, i.numel(), _CHUNK):
            ii, jj = i[lo:lo + _CHUNK], j[lo:lo + _CHUNK]
            flat[ii * m + jj] = _intersection_area(c1[ii], c2[jj])
    a1 = (boxes1[:, 2] * boxes1[:, 3])[:, None]
    a2 = (boxes2[:, 2] * boxes2[:, 3])[None, :]
    union = a1 + a2 - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)), torch.zeros_like(union))


def nms_rotated(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of rotated boxes (N, 5) by scores (N,): the first
    min(max_out, N) kept indices (int64) in score order, 0 where padded, and
    their validity; a kept row whose score is -inf is not valid."""
    n = boxes.shape[0]
    dev = boxes.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    m = min(max_out, n)
    idx = torch.zeros(m, dtype=torch.int64, device=dev)
    out_valid = torch.zeros(m, dtype=torch.bool, device=dev)
    if m == 0:
        return idx, out_valid
    order = torch.sort(torch.where(valid, scores, float("-inf")), descending=True, stable=True).indices
    kept = _greedy_keep(boxes[order], valid[order], iou_threshold, m, iou=pairwise_iou_rotated)
    pos = torch.nonzero(kept).squeeze(1)[:m]
    k = pos.numel()
    idx[:k] = order[pos]
    out_valid[:k] = scores[idx[:k]] > float("-inf")
    idx[:k] = torch.where(out_valid[:k], idx[:k], torch.zeros_like(idx[:k]))
    return idx, out_valid


def rotated_samples(boxes: torch.Tensor, hw: Tuple[int, int], output_size: Tuple[int, int] = (7, 7),
                    spatial_scale: float = 1.0 / 16, sampling_ratio: int = 2):
    """The bilinear samples of `roi_align_rotated` for boxes (B, R, 5) on a
    map of `hw`: the corner indices y0, x0, y1, x1 (int64), the weights ly,
    lx (..., 1) and the validity `ok`, each (B, R, PH, PW, S, S)."""
    H, W = hw
    PH, PW = output_size
    S = max(sampling_ratio, 1)
    dev = boxes.device
    scale = torch.tensor([spatial_scale] * 4 + [1.0], dtype=boxes.dtype, device=dev)
    cx, cy, w, h, a = (v[..., None, None, None, None] for v in (boxes * scale).unbind(-1))  # (B, R, 1, 1, 1, 1)
    theta = a * (math.pi / 180.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    sy = (torch.arange(S, device=dev, dtype=boxes.dtype) + 0.5) / S
    ys = (torch.arange(PH, device=dev, dtype=boxes.dtype)[:, None] + sy[None, :])  # (PH, S)
    xs = (torch.arange(PW, device=dev, dtype=boxes.dtype)[:, None] + sy[None, :])  # (PW, S)
    yy = ys[:, None, :, None] * (h / PH) - h / 2  # (B, R, PH, 1, S, 1)
    xx = xs[None, :, None, :] * (w / PW) - w / 2  # (B, R, 1, PW, 1, S)
    gx = cx + xx * cos - yy * sin - 0.5  # (B, R, PH, PW, S, S)
    gy = cy + xx * sin + yy * cos - 0.5
    ok = (gy > -1.0) & (gy < H) & (gx > -1.0) & (gx < W)
    y = torch.clamp(gy, 0.0, H - 1)
    x = torch.clamp(gx, 0.0, W - 1)
    y0, x0 = torch.floor(y), torch.floor(x)
    ly, lx = (y - y0)[..., None], (x - x0)[..., None]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    y1, x1 = torch.clamp(y0 + 1, max=H - 1), torch.clamp(x0 + 1, max=W - 1)
    return y0, x0, y1, x1, ly, lx, ok


def roi_align_rotated(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: Tuple[int, int] = (7, 7),
    spatial_scale: float = 1.0 / 16,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """features (B, H, W, C), boxes (B, R, 5) XYWHA in image coordinates ->
    (B, R, PH, PW, C); one image's (H, W, C) and (R, 5) give (R, PH, PW, C).
    Bilinear weights are float32, so a bfloat16 map pools in float32."""
    if features.dim() == 3:
        return roi_align_rotated(features[None], boxes[None], output_size, spatial_scale, sampling_ratio)[0]
    B, H, W, C = features.shape
    y0, x0, y1, x1, ly, lx, ok = rotated_samples(boxes, (H, W), output_size, spatial_scale, sampling_ratio)
    flat = features.reshape(B * H * W, C)
    base = (torch.arange(B, device=features.device) * (H * W))[:, None, None, None, None, None]

    def at(yi, xi):
        return flat.index_select(0, (base + yi * W + xi).reshape(-1)).reshape(yi.shape + (C,))

    v = (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1) * (1 - ly) * lx
         + at(y1, x0) * ly * (1 - lx) + at(y1, x1) * ly * lx) * ok[..., None]
    return v.mean(dim=(4, 5))
