"""Box2BoxTransform: (dx, dy, dw, dh) delta encode/apply, and
Box2BoxTransformRotated for (cx, cy, w, h, angle) boxes (counterparts of
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


class Box2BoxTransformRotated:
    """5-parameter rotated-box deltas (counterpart of JAX's
    `Box2BoxTransformRotated`): boxes are (cx, cy, w, h, angle in degrees);
    the angle delta is the wrapped difference in radians times wa, and
    predicted angles are wrapped to [-180, 180). Both wraps are floor
    modulo (`torch.remainder`, as jnp's `%`; `fmod` keeps the sign of a
    negative angle)."""

    def __init__(self, weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0, 1.0),
                 scale_clamp: float = _DEFAULT_SCALE_CLAMP):
        self.weights = tuple(float(w) for w in weights)
        self.scale_clamp = scale_clamp

    def get_deltas(self, src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """(..., 5),(..., 5) XYWHA -> (..., 5) deltas; widths and heights
        get a 1e-4 floor so padded rows stay finite."""
        wx, wy, ww, wh, wa = self.weights
        sw = torch.clamp(src[..., 2], min=1e-4)
        sh = torch.clamp(src[..., 3], min=1e-4)
        dx = wx * (target[..., 0] - src[..., 0]) / sw
        dy = wy * (target[..., 1] - src[..., 1]) / sh
        dw = ww * torch.log(torch.clamp(target[..., 2], min=1e-4) / sw)
        dh = wh * torch.log(torch.clamp(target[..., 3], min=1e-4) / sh)
        da = torch.remainder(target[..., 4] - src[..., 4] + 180.0, 360.0) - 180.0
        da = da * (wa * math.pi / 180.0)
        return torch.stack([dx, dy, dw, dh, da], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """deltas (..., K*5), boxes (..., 5) -> (..., K*5)."""
        wx, wy, ww, wh, wa = self.weights
        boxes = boxes.to(deltas.dtype)
        shape = deltas.shape
        d = deltas.reshape(shape[:-1] + (-1, 5))
        cx, cy, w, h, a = (boxes[..., i][..., None] for i in range(5))
        pred_cx = d[..., 0] / wx * w + cx
        pred_cy = d[..., 1] / wy * h + cy
        pred_w = torch.exp(torch.clamp(d[..., 2] / ww, max=self.scale_clamp)) * w
        pred_h = torch.exp(torch.clamp(d[..., 3] / wh, max=self.scale_clamp)) * h
        pred_a = a + d[..., 4] * (180.0 / math.pi) / wa
        pred_a = torch.remainder(pred_a + 180.0, 360.0) - 180.0
        return torch.stack([pred_cx, pred_cy, pred_w, pred_h, pred_a], dim=-1).reshape(shape)
