"""Host-side geometric transforms of the training recipe (the port's copy of
the part of cddmsl_tpu/data/transforms.py that `build_augmentation` gives
the training recipes): `ResizeShortestEdge` (a choice of short sides, or a
range, at train time; one size at test time), the horizontal `RandomFlip`,
and under INPUT.CROP.ENABLED a `RandomCrop` of the image before the resize;
and the strong photometric augmentation of the mean-teacher loader
(`build_strong_augmentation_fn`).

Augmentations draw from the caller's `np.random.RandomState` in the JAX
package's order, so the same state gives the same samples. Each returns a
deterministic `Transform` that is replayed on the paired translated view,
on the boxes and on label maps. Images are resized with PIL's bilinear
filter, label and segment-id maps (`apply_segmentation`) with its nearest
one, as in JAX.
`transform_keypoint_annotations` moves an instance's keypoints through
them (`create_keypoint_hflip_indices` gives the flip's mirror indices).
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

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        """coords: (N, 2) float (x, y) points (polygon vertices)."""
        raise NotImplementedError

    def apply_segmentation(self, seg: np.ndarray) -> np.ndarray:
        """(H, W) integer label or segment-id map; a resize resamples it
        NEAREST."""
        return self.apply_image(seg)


class NoOpTransform(Transform):
    def apply_image(self, img):
        return img

    def apply_segmentation(self, seg):
        return seg

    def apply_box(self, boxes):
        return boxes

    def apply_coords(self, coords):
        return coords


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

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        coords = coords.astype(np.float32).copy()
        coords[:, 0] *= self.new_w / self.w
        coords[:, 1] *= self.new_h / self.h
        return coords

    def apply_segmentation(self, seg: np.ndarray) -> np.ndarray:
        """int32 through PIL's 32-bit mode, NEAREST."""
        pil = Image.fromarray(np.ascontiguousarray(seg, np.int32))
        return np.asarray(pil.resize((self.new_w, self.new_h), Image.NEAREST))


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

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        coords = coords.astype(np.float32).copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords


class CropTransform(Transform):
    """The (h, w) window at (y0, x0): boxes and points move by its corner;
    the mappers clip the boxes to the window afterwards."""

    def __init__(self, x0: int, y0: int, w: int, h: int):
        self.x0, self.y0, self.w, self.h = x0, y0, w, h

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return img[self.y0 : self.y0 + self.h, self.x0 : self.x0 + self.w]

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        boxes = boxes.astype(np.float32).copy()
        boxes[:, 0::2] -= self.x0
        boxes[:, 1::2] -= self.y0
        return boxes

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        coords = coords.astype(np.float32).copy()
        coords[:, 0] -= self.x0
        coords[:, 1] -= self.y0
        return coords


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

    def apply_coords(self, coords):
        for t in self.transforms:
            coords = t.apply_coords(coords)
        return coords

    def apply_segmentation(self, seg):
        for t in self.transforms:
            seg = t.apply_segmentation(seg)
        return seg


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


class RandomCrop(Augmentation):
    """A random window (detectron2's RandomCrop, JAX's draws in JAX's
    order): "relative" takes crop_size of each side, "relative_range" a
    fraction drawn per side (rand(2)) in [crop_size, 1], "absolute" crop_size
    pixels, "absolute_range" sides drawn in [crop_size[0], crop_size[1]]
    (randint per side); each side capped at the image's, the corner drawn
    uniformly (randint for y0, then x0)."""

    def __init__(self, crop_type: str, crop_size: Sequence[float]):
        if crop_type not in ("relative", "relative_range", "absolute", "absolute_range"):
            raise ValueError(f"RandomCrop type {crop_type!r}")
        self.crop_type = crop_type
        self.crop_size = tuple(crop_size)

    def _crop_hw(self, h: int, w: int, rng) -> Tuple[int, int]:
        ch, cw = self.crop_size
        if self.crop_type == "relative":
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "relative_range":
            lo = np.asarray(self.crop_size, np.float32)
            ch, cw = lo + rng.rand(2) * (1 - lo)
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "absolute":
            return min(h, int(ch)), min(w, int(cw))
        return (rng.randint(min(h, int(ch)), min(h, int(cw)) + 1),
                rng.randint(min(w, int(ch)), min(w, int(cw)) + 1))

    def get_transform(self, img, rng) -> Transform:
        h, w = img.shape[:2]
        ch, cw = self._crop_hw(h, w, rng)
        y0 = rng.randint(h - ch + 1)
        x0 = rng.randint(w - cw + 1)
        return CropTransform(x0, y0, cw, ch)


def create_keypoint_hflip_indices(meta) -> np.ndarray:
    """The metadata's keypoint_names and keypoint_flip_map -> for each
    keypoint the index of its mirror (itself where the map names none)."""
    names = list(meta.get("keypoint_names") or ())
    flip_map = dict(meta.get("keypoint_flip_map") or ())
    flip_map.update({v: k for k, v in flip_map.items()})
    return np.asarray([names.index(flip_map.get(n, n)) for n in names], np.int32)


def transform_keypoint_annotations(keypoints: np.ndarray, tfms: TransformList, image_hw,
                                   hflip_indices=None) -> np.ndarray:
    """(K, 3) keypoints (x, y, flag) through `tfms`: a point outside the
    transformed image [0, w] x [0, h] becomes unlabelled; an odd number of
    horizontal flips swaps each keypoint with its mirror (`hflip_indices`);
    an unlabelled keypoint is (0, 0, 0), COCO's convention."""
    kp = np.asarray(keypoints, np.float64).reshape(-1, 3).copy()
    xy = tfms.apply_coords(kp[:, :2].astype(np.float32)).astype(np.float64)
    h, w = image_hw
    inside = (xy[:, 0] >= 0) & (xy[:, 1] >= 0) & (xy[:, 0] <= w) & (xy[:, 1] <= h)
    kp[:, :2] = xy
    kp[~inside, 2] = 0
    if sum(isinstance(t, HFlipTransform) for t in tfms.transforms) % 2 == 1:
        if hflip_indices is None:
            raise ValueError("a horizontal flip of keypoints needs the set's keypoint_names metadata")
        kp = kp[np.asarray(hflip_indices, np.int32)]
    kp[kp[:, 2] == 0] = 0
    return kp.astype(np.float32)


def build_augmentation(cfg, is_train: bool) -> List[Augmentation]:
    """Train: RandomCrop(INPUT.CROP.TYPE, SIZE) first where INPUT.CROP.ENABLED,
    ResizeShortestEdge(MIN_SIZE_TRAIN, MAX_SIZE_TRAIN, sampling), then a
    horizontal flip unless INPUT.RANDOM_FLIP is "none". Test:
    ResizeShortestEdge(MIN_SIZE_TEST, MAX_SIZE_TEST)."""
    if not is_train:
        return [ResizeShortestEdge(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)]
    augs: List[Augmentation] = [
        ResizeShortestEdge(tuple(cfg.INPUT.MIN_SIZE_TRAIN), cfg.INPUT.MAX_SIZE_TRAIN, cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING)
    ]
    if cfg.INPUT.CROP.ENABLED:
        augs.insert(0, RandomCrop(cfg.INPUT.CROP.TYPE, cfg.INPUT.CROP.SIZE))
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
