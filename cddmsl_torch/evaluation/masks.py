"""Host-side mask utilities of COCO segm evaluation (the port's copy of
cddmsl_tpu/evaluation/masks.py): the paste of box-frame masks into the
image, polygon rasterisation, COCO's run-length encoding (uncompressed, and
the compressed string counts on decode) and mask IoU. numpy, no pycocotools.

`paste_masks_np` is the evaluator's paste. It runs the host library built
from csrc/maskops.cpp (`ops/_build.py` `HostLibrary`: the host C++
compiler, at first use, into csrc/build/), which evaluates only each box's
pixel window; a failed build raises. `paste_masks_full_grid` is its plain
version over the whole image, which the tests hold it against.
"""

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops._build import HostLibrary

_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.int64)

MASKOPS = HostLibrary("maskops.cpp", {
    "paste_masks": (
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # n m H W
        ctypes.POINTER(ctypes.c_float),  # masks (n, m, m)
        ctypes.POINTER(ctypes.c_double),  # boxes (n, 4)
        ctypes.c_double,  # threshold
        ctypes.POINTER(ctypes.c_uint8),  # out (n, H, W), zeroed by the caller
    ),
})


def paste_masks_np(masks: np.ndarray, boxes: np.ndarray, image_hw: Tuple[int, int],
                   threshold: float = 0.5) -> np.ndarray:
    """(N, M, M) probabilities in each box's frame and (N, 4) XYXY boxes in
    the image -> (N, H, W) bool: detectron2's `_do_paste_mask`
    (grid_sample with align_corners False and zero padding: unclamped sample
    coordinates, taps outside the mask weigh zero), then >= threshold.
    Needs threshold > 0 (the library skips pixels outside the box's window)."""
    H, W = int(image_hw[0]), int(image_hw[1])
    n, m = masks.shape[:2]
    buf = np.zeros((n, H, W), np.uint8)
    if n == 0:
        return buf.view(bool)
    masks = np.ascontiguousarray(masks, np.float32)
    boxes = np.ascontiguousarray(boxes, np.float64)
    MASKOPS.call(
        "paste_masks", n, m, H, W, masks.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), threshold,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return buf.view(bool)


def paste_masks_full_grid(masks: np.ndarray, boxes: np.ndarray, image_hw: Tuple[int, int],
                          threshold: float = 0.5) -> np.ndarray:
    """`paste_masks_np`'s function evaluated at every pixel of the image."""
    H, W = int(image_hw[0]), int(image_hw[1])
    n, m = masks.shape[:2]
    out = np.zeros((n, H, W), bool)
    ys_img = np.arange(H) + 0.5
    xs_img = np.arange(W) + 0.5

    def _taps(s):
        i0 = np.floor(s).astype(np.int64)
        f = s - i0
        w0 = (1 - f) * ((i0 >= 0) & (i0 <= m - 1))
        w1 = f * ((i0 + 1 >= 0) & (i0 + 1 <= m - 1))
        return np.clip(i0, 0, m - 1), w0, np.clip(i0 + 1, 0, m - 1), w1

    for i in range(n):
        x1, y1, x2, y2 = np.asarray(boxes[i], np.float64)
        w = max(x2 - x1, 1e-3)
        h = max(y2 - y1, 1e-3)
        r0, wy0, r1, wy1 = _taps((ys_img - y1) / h * m - 0.5)
        c0, wx0, c1, wx1 = _taps((xs_img - x1) / w * m - 0.5)
        mk = np.asarray(masks[i], np.float32)
        v = (mk[r0][:, c0] * wy0[:, None] * wx0[None, :] + mk[r0][:, c1] * wy0[:, None] * wx1[None, :]
             + mk[r1][:, c0] * wy1[:, None] * wx0[None, :] + mk[r1][:, c1] * wy1[:, None] * wx1[None, :])
        out[i] = v >= threshold
    return out


def polygons_to_bitmask(polygons: Sequence[np.ndarray], hw: Tuple[int, int]) -> np.ndarray:
    """Polygon rings (each (P, 2) float xy) -> (H, W) bool, filled by PIL."""
    from PIL import Image, ImageDraw

    H, W = int(hw[0]), int(hw[1])
    img = Image.new("L", (W, H), 0)
    draw = ImageDraw.Draw(img)
    for ring in polygons:
        pts = [(float(x), float(y)) for x, y in np.asarray(ring, np.float64).reshape(-1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, fill=1)
    return np.asarray(img, bool)


def coco_rle_to_bitmask(rle: Dict) -> np.ndarray:
    """A COCO RLE dict, its counts a list or pycocotools' compressed string
    -> (H, W) bool."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _decode_compressed_counts(counts.decode("ascii") if isinstance(counts, bytes) else counts)
    return rle_decode({"size": rle["size"], "counts": list(counts)})


def _decode_compressed_counts(s: str) -> List[int]:
    """pycocotools' string of run lengths: 5 bits a character, a
    continuation bit, the sign on the last; from the third run on each is
    stored as its difference to the run two before."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def segmentation_to_rle(seg, image_hw) -> Dict:
    """A COCO 'segmentation' (polygon rings, an RLE dict of either counts,
    an (H, W) array, or None for an empty mask) -> an uncompressed RLE."""
    if seg is None:
        return rle_encode(np.zeros((int(image_hw[0]), int(image_hw[1])), bool))
    if isinstance(seg, dict):
        return rle_encode(coco_rle_to_bitmask(seg))
    if isinstance(seg, np.ndarray):
        return rle_encode(seg.astype(bool))
    return rle_encode(polygons_to_bitmask([np.asarray(p, np.float64).reshape(-1, 2) for p in seg], image_hw))


def rle_encode(mask: np.ndarray) -> Dict:
    """(H, W) bool -> {'size': [H, W], 'counts': [...]}: COCO's uncompressed
    RLE, column-major, alternating run lengths from a run of zeros."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)
    if flat.size == 0:
        return {"size": [h, w], "counts": [0]}
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0]:  # the counts start with a run of zeros
        runs = [0] + runs
    return {"size": [h, w], "counts": runs}


def rle_decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    pos, val = 0, False
    for run in rle["counts"]:
        if val:
            flat[pos : pos + run] = True
        pos += run
        val = not val
    return flat.reshape(w, h).T


def rle_area(rle: Dict) -> int:
    return int(sum(rle["counts"][1::2]))


def mask_iou_matrix(det_rles: List[Dict], gt_rles: List[Dict], iscrowd: np.ndarray) -> np.ndarray:
    """(D,) and (G,) RLEs -> (D, G) mask IoU; against crowd ground truth the
    intersection over the detection's area (pycocotools' maskUtils.iou)."""
    d, g = len(det_rles), len(gt_rles)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    dm = np.stack([np.packbits(rle_decode(r).reshape(-1)) for r in det_rles])
    gm = np.stack([np.packbits(rle_decode(r).reshape(-1)) for r in gt_rles])
    area_d = np.array([rle_area(r) for r in det_rles], np.float64)
    area_g = np.array([rle_area(r) for r in gt_rles], np.float64)
    inter = np.zeros((d, g), np.float64)
    for j in range(g):
        inter[:, j] = _POPCOUNT[np.bitwise_and(dm, gm[j][None, :])].sum(axis=1)
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(np.asarray(iscrowd, bool)[None, :], area_d[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)
