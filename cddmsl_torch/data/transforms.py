"""Host-side geometric transforms of the training recipe (the port's copy of
the part of cddmsl_tpu/data/transforms.py that `build_augmentation` gives
the VOC recipe): `ResizeShortestEdge` (a choice of short sides, or a range,
at train time; one size at test time) and the horizontal `RandomFlip`; and
the strong photometric augmentation of the mean-teacher loader
(`build_strong_augmentation_fn`).

Augmentations draw from the caller's `np.random.RandomState` in the JAX
package's order, so the same state gives the same samples. Each returns a
deterministic `Transform` that is replayed on the paired translated view and
on the boxes. Images are resized with PIL's bilinear filter, as in JAX.
"""

from typing import List, Sequence, Tuple, Union

import numpy as np
from PIL import Image, ImageFilter


class Transform:
    def apply_image(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        """boxes: (N, 4) XYXY float."""
        raise NotImplementedError


class NoOpTransform(Transform):
    def apply_image(self, img):
        return img

    def apply_box(self, boxes):
        return boxes


class ResizeTransform(Transform):
    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        if img.shape[:2] != (self.h, self.w):
            raise ValueError(f"image {img.shape} is not {self.h}x{self.w}")
        pil = Image.fromarray(img.astype(np.uint8))
        return np.asarray(pil.resize((self.new_w, self.new_h), Image.BILINEAR))

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        boxes = boxes.astype(np.float32).copy()
        boxes[:, 0::2] *= self.new_w / self.w
        boxes[:, 1::2] *= self.new_h / self.h
        return boxes


class HFlipTransform(Transform):
    def __init__(self, width: int):
        self.width = width

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(img[:, ::-1])

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        boxes = boxes.astype(np.float32).copy()
        x1 = self.width - boxes[:, 2]
        x2 = self.width - boxes[:, 0]
        boxes[:, 0], boxes[:, 2] = x1, x2
        return boxes


class TransformList(Transform):
    def __init__(self, tfms: Sequence[Transform]):
        self.transforms = list(tfms)

    def apply_image(self, img):
        for t in self.transforms:
            img = t.apply_image(img)
        return img

    def apply_box(self, boxes):
        for t in self.transforms:
            boxes = t.apply_box(boxes)
        return boxes


class Augmentation:
    def get_transform(self, img: np.ndarray, rng: np.random.RandomState) -> Transform:
        raise NotImplementedError


class ResizeShortestEdge(Augmentation):
    """Scales the shorter side to one of `short_edge_length` (or a size in
    its range) and caps the longer side at `max_size`."""

    def __init__(self, short_edge_length: Union[int, Sequence[int]], max_size: int = 1333, sample_style: str = "choice"):
        if isinstance(short_edge_length, int):
            short_edge_length = (short_edge_length, short_edge_length)
        self.short_edge_length = tuple(short_edge_length)
        self.max_size = max_size
        self.sample_style = sample_style

    def get_transform(self, img, rng) -> Transform:
        h, w = img.shape[:2]
        if self.sample_style == "range":
            size = rng.randint(min(self.short_edge_length), max(self.short_edge_length) + 1)
        else:
            size = self.short_edge_length[rng.randint(len(self.short_edge_length))]
        if size == 0:
            return NoOpTransform()
        scale = size / min(h, w)
        if h < w:
            new_h, new_w = size, int(round(w * scale))
        else:
            new_h, new_w = int(round(h * scale)), size
        if max(new_h, new_w) > self.max_size:
            scale2 = self.max_size / max(new_h, new_w)
            new_h, new_w = int(round(new_h * scale2)), int(round(new_w * scale2))
        return ResizeTransform(h, w, new_h, new_w)


class RandomFlip(Augmentation):
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def get_transform(self, img, rng) -> Transform:
        if rng.rand() < self.prob:
            return HFlipTransform(img.shape[1])
        return NoOpTransform()


def build_augmentation(cfg, is_train: bool) -> List[Augmentation]:
    """Train: ResizeShortestEdge(MIN_SIZE_TRAIN, MAX_SIZE_TRAIN, sampling),
    then a horizontal flip unless INPUT.RANDOM_FLIP is "none". Test:
    ResizeShortestEdge(MIN_SIZE_TEST, MAX_SIZE_TEST)."""
    if not is_train:
        return [ResizeShortestEdge(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)]
    if cfg.INPUT.CROP.ENABLED:
        raise NotImplementedError("INPUT.CROP.ENABLED: RandomCrop is not ported")
    augs: List[Augmentation] = [
        ResizeShortestEdge(tuple(cfg.INPUT.MIN_SIZE_TRAIN), cfg.INPUT.MAX_SIZE_TRAIN, cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING)
    ]
    if cfg.INPUT.RANDOM_FLIP != "none":
        augs.append(RandomFlip(0.5))
    return augs


def apply_augmentations(
    augs: Sequence[Augmentation], img: np.ndarray, rng: np.random.RandomState
) -> Tuple[np.ndarray, TransformList]:
    tfms = []
    for aug in augs:
        t = aug.get_transform(img, rng)
        img = t.apply_image(img)
        tfms.append(t)
    return img, TransformList(tfms)


# ---------------- strong (photometric) augmentation ----------------
def _color_jitter(img: np.ndarray, rng):
    """ColorJitter(.4, .4, .4, .1): brightness, contrast, saturation and a
    cheap hue shift (a mix with the channels rotated by one), in an order
    drawn from `rng`; float32."""
    x = img.astype(np.float32)
    for op in rng.permutation(4):
        if op == 0:  # brightness
            x = x * rng.uniform(0.6, 1.4)
        elif op == 1:  # contrast
            mean = x.mean()
            x = (x - mean) * rng.uniform(0.6, 1.4) + mean
        elif op == 2:  # saturation
            gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
            f = rng.uniform(0.6, 1.4)
            x = x * f + gray[..., None] * (1 - f)
        else:  # hue
            f = rng.uniform(-0.1, 0.1)
            if abs(f) > 1e-3:
                x = x + np.roll(x, 1, axis=-1) * f - x * f
    return np.clip(x, 0, 255)


def build_strong_augmentation_fn():
    """fn(img_uint8, rng) -> img_uint8: ColorJitter(.4, .4, .4, .1) at p .8,
    grayscale at .2, PIL's GaussianBlur (radius drawn in [.1, 2)) at .5, then
    three RandomErasing of random values at p .7 / .5 / .3 (area fractions
    .05-.2 / .02-.2 / .02-.2, aspect ratios .3-3.3, up to 10 tries each).
    Every draw comes from `rng` in the JAX package's order."""

    def strong_aug(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        x = img.astype(np.float32)
        if rng.rand() < 0.8:
            x = _color_jitter(x, rng)
        if rng.rand() < 0.2:
            gray = x @ np.array([0.299, 0.587, 0.114], np.float32)
            x = np.repeat(gray[..., None], 3, axis=-1)
        if rng.rand() < 0.5:
            sigma = rng.uniform(0.1, 2.0)
            pil = Image.fromarray(np.clip(x, 0, 255).astype(np.uint8))
            x = np.asarray(pil.filter(ImageFilter.GaussianBlur(radius=sigma))).astype(np.float32)
        for p, scale in ((0.7, (0.05, 0.2)), (0.5, (0.02, 0.2)), (0.3, (0.02, 0.2))):
            if rng.rand() < p:
                h, w = x.shape[:2]
                for _ in range(10):
                    area = rng.uniform(*scale) * h * w
                    ratio = np.exp(rng.uniform(np.log(0.3), np.log(3.3)))
                    eh, ew = int(round(np.sqrt(area * ratio))), int(round(np.sqrt(area / ratio)))
                    if eh < h and ew < w:
                        y0, x0 = rng.randint(0, h - eh), rng.randint(0, w - ew)
                        x[y0 : y0 + eh, x0 : x0 + ew] = rng.rand(eh, ew, 3) * 255
                        break
        return np.clip(x, 0, 255).astype(np.uint8)

    return strong_aug
