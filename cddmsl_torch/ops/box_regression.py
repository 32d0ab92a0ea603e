"""Box2BoxTransform: (dx, dy, dw, dh) delta encode/apply (counterpart of
cddmsl_tpu/ops/box_regression.py)."""

import math
from typing import Sequence

import torch

_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


class Box2BoxTransform:
    def __init__(self, weights: Sequence[float], scale_clamp: float = _DEFAULT_SCALE_CLAMP):
        self.weights = tuple(float(w) for w in weights)
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        """(..., 4),(..., 4) XYXY -> (..., 4) deltas; zero-size sources get a
        1e-4 floor so padded rows stay finite."""
        src_w = torch.clamp(src_boxes[..., 2] - src_boxes[..., 0], min=1e-4)
        src_h = torch.clamp(src_boxes[..., 3] - src_boxes[..., 1], min=1e-4)
        src_cx = src_boxes[..., 0] + 0.5 * src_w
        src_cy = src_boxes[..., 1] + 0.5 * src_h

        tgt_w = torch.clamp(target_boxes[..., 2] - target_boxes[..., 0], min=1e-4)
        tgt_h = torch.clamp(target_boxes[..., 3] - target_boxes[..., 1], min=1e-4)
        tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
        tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

        wx, wy, ww, wh = self.weights
        dx = wx * (tgt_cx - src_cx) / src_w
        dy = wy * (tgt_cy - src_cy) / src_h
        dw = ww * torch.log(tgt_w / src_w)
        dh = wh * torch.log(tgt_h / src_h)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """deltas (..., K*4), boxes (..., 4) -> (..., K*4) transformed XYXY."""
        boxes = boxes.to(deltas.dtype)
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        cx = boxes[..., 0] + 0.5 * w
        cy = boxes[..., 1] + 0.5 * h

        wx, wy, ww, wh = self.weights
        shape = deltas.shape
        d = deltas.reshape(shape[:-1] + (-1, 4))
        dx = d[..., 0] / wx
        dy = d[..., 1] / wy
        dw = torch.clamp(d[..., 2] / ww, max=self.scale_clamp)
        dh = torch.clamp(d[..., 3] / wh, max=self.scale_clamp)

        pred_cx = dx * w[..., None] + cx[..., None]
        pred_cy = dy * h[..., None] + cy[..., None]
        pred_w = torch.exp(dw) * w[..., None]
        pred_h = torch.exp(dh) * h[..., None]

        out = torch.stack(
            [
                pred_cx - 0.5 * pred_w,
                pred_cy - 0.5 * pred_h,
                pred_cx + 0.5 * pred_w,
                pred_cy + 0.5 * pred_h,
            ],
            dim=-1,
        )
        return out.reshape(shape)
