"""Mask R-CNN's pieces and the GIoU losses in the port against cddmsl_tpu on
the CPU: the mask head, its loss, inference and targets, the paste, the RLE
codec, polygon rasterisation and the loader's canvases, mask IoU and segm
AP, `pairwise_giou` and both GIoU loss terms, the converters (the flax
deconv's flipped taps), and the configs the port accepts and refuses.

Every input is made with numpy from a seed; every weight is JAX's, carried
over by `convert_jax_params`. Tolerances, and why:
- the head's logits within 1e-5 of their largest value, `mask_rcnn_loss`
  and the head's gradients within 1e-5 relative: the same convolutions
  summed in another order;
- `crop_mask_targets` exactly, except pixels whose bilinear value lies
  within 1e-6 of 0.5 (both binarise at >= 0.5; the float order of the
  average may put such a value on either side);
- the paste (the host library and the full-grid plain version) exactly
  against JAX's `paste_masks_np`, with the same exception for pixels whose
  value lies within 1e-6 of the threshold; the torch paste against JAX's
  `paste_masks_in_image` likewise, the exception 1e-5 wide (both in
  float32);
- RLE encode, decode and the compressed decode, polygon rasterisation and
  the loader's canvases exactly;
- `mask_iou_matrix` and `COCOEvaluator`'s segm AP within 1e-9;
- `pairwise_giou` and the GIoU terms of the RPN and box-head losses within
  1e-6 (the RPN's with JAX's draws replayed).
"""

import ctypes
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.checkpoint.convert_torch import convert_d2_fpn_rcnn
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.data.build import pad_and_collate as jax_pad_and_collate
from cddmsl_tpu.data.build import rasterize_polygons as jax_rasterize_polygons
from cddmsl_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from cddmsl_tpu.data.dataset_mapper import DatasetMapper as JaxDatasetMapper
from cddmsl_tpu.data.datasets.coco import load_coco_json as jax_load_coco_json
from cddmsl_tpu.evaluation import coco_eval as jax_coco_eval
from cddmsl_tpu.evaluation import masks as jax_masks
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models import mask_head as jax_mask_head
from cddmsl_tpu.models.fast_rcnn import fast_rcnn_losses as jax_fast_rcnn_losses
from cddmsl_tpu.models.rpn import RPN as JaxRPN
from cddmsl_tpu.ops.box_regression import Box2BoxTransform as JaxBox2BoxTransform
from cddmsl_tpu.structures.boxes import pairwise_giou as jax_pairwise_giou
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.checkpoint.convert_torch import load_rcnn_weights
from cddmsl_torch.config import check_supported, get_cfg, model_config_from_cfg, model_family
from cddmsl_torch.data.build import pad_and_collate, rasterize_polygons
from cddmsl_torch.data.catalog import MetadataCatalog
from cddmsl_torch.data.dataset_mapper import DatasetMapper
from cddmsl_torch.data.datasets.coco import load_coco_json
from cddmsl_torch.data.datasets.synthetic import make_synthetic_coco
from cddmsl_torch.evaluation import coco_eval, masks
from cddmsl_torch.models import mask_head
from cddmsl_torch.models.build import build_detector, fpn_rcnn_fields
from cddmsl_torch.models.fast_rcnn import fast_rcnn_losses
from cddmsl_torch.models.fpn_rcnn import FPNRCNN
from cddmsl_torch.models.roi_heads import StandardROIHeads
from cddmsl_torch.models.rpn import RPN, Proposals
from cddmsl_torch.ops import _build
from cddmsl_torch.ops.box_regression import Box2BoxTransform
from cddmsl_torch.structures.boxes import pairwise_giou
from test_torch_port_backbone import fill_params
from torch_goldens import jax_draw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NEAR = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(r, n, w=160.0, h=120.0, min_size=2.0):
    x1, y1 = r.rand(n) * w * 0.8, r.rand(n) * h * 0.8
    bw, bh = min_size + r.rand(n) * w * 0.5, min_size + r.rand(n) * h * 0.5
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


# ---------------- the head, its loss and inference ----------------
HEADS = {"fpn": dict(num_conv=4, conv_dim=24, cls_agnostic=False, c=16, p=14),
         "c4": dict(num_conv=0, conv_dim=24, cls_agnostic=False, c=32, p=7),
         "agnostic": dict(num_conv=2, conv_dim=16, cls_agnostic=True, c=16, p=14)}


def _head_pair(kind, k=5, seed=0):
    spec = HEADS[kind]
    x = np.random.RandomState(seed).randn(6, spec["p"], spec["p"], spec["c"]).astype(np.float32)
    jm = jax_mask_head.MaskRCNNConvUpsampleHead(num_classes=k, num_conv=spec["num_conv"],
                                                conv_dim=spec["conv_dim"], cls_agnostic=spec["cls_agnostic"])
    params = fill_params(jax.eval_shape(lambda r: jm.init(r, jnp.asarray(x)), jax.random.PRNGKey(0)), seed=seed + 1)
    ours = mask_head.MaskRCNNConvUpsampleHead(spec["c"], k, spec["num_conv"], spec["conv_dim"], spec["cls_agnostic"])
    state = convert_jax_params({"roi_heads": {"mask_head": params["params"]}})
    ours.load_state_dict({n[len("roi_heads.mask_head."):]: v for n, v in state.items()}, strict=True)
    return jm, params, ours, x


@pytest.mark.parametrize("kind", list(HEADS))
def test_head_logits_loss_and_gradients_equal_jax(kind):
    """The head on pooled regions (FPN: 4 convs at 14x14; C4: the deconv
    alone on res5's 7x7; class-agnostic: one channel), `mask_rcnn_loss` on
    seeded targets over seeded foreground rows, and every head gradient."""
    k = 5
    jm, params, ours, x = _head_pair(kind, k)
    r = np.random.RandomState(7)
    n, m = x.shape[0], 2 * x.shape[1]
    targets = (r.rand(n, m, m) > 0.5).astype(np.float32)
    classes = r.randint(0, k + 1, n).astype(np.int32)  # k is background
    fg = (classes < k) & (r.rand(n) > 0.2)

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(x))
        return jax_mask_head.mask_rcnn_loss(logits, jnp.asarray(targets), jnp.asarray(classes), jnp.asarray(fg)), logits

    (want_loss, want_logits), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    logits = ours(_t(x))
    loss = mask_head.mask_rcnn_loss(logits, _t(targets), _t(classes), _t(fg))
    loss.backward()
    want_logits = np.asarray(want_logits)
    assert logits.shape == want_logits.shape == (n, m, m, 1 if kind == "agnostic" else k)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=0, atol=1e-5 * np.abs(want_logits).max())
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = convert_jax_params({"roi_heads": {"mask_head": want_grads["params"]}})
    for name, p in ours.named_parameters():
        w = grads[f"roi_heads.mask_head.{name}"].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)
    probs = mask_head.mask_rcnn_inference(logits.detach(), _t(classes))
    want_probs = jax_mask_head.mask_rcnn_inference(jnp.asarray(want_logits), jnp.asarray(classes))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), rtol=0, atol=1e-6)


def test_the_loss_without_foreground_is_zero_as_jax():
    logits = np.random.RandomState(1).randn(3, 14, 14, 4).astype(np.float32)
    args = (np.ones((3, 14, 14), np.float32), np.zeros(3, np.int32), np.zeros(3, bool))
    want = jax_mask_head.mask_rcnn_loss(jnp.asarray(logits), *map(jnp.asarray, args))
    assert mask_head.mask_rcnn_loss(_t(logits), *map(_t, args)).item() == float(want) == 0.0


def test_a_tie_at_the_positive_quota_keeps_every_foreground_row_in_loss_mask():
    """The sampler keeps every key tied at its threshold, as JAX's does, so
    an image can sample more positives than its quota int(S * fraction):
    here image 0 keeps 3 against a quota of 2. The mask branch still trains
    on every foreground row: `loss_mask` and the head's gradients equal
    JAX's, which runs the head on all S rows and masks the loss to the
    foreground (same tolerances as above)."""
    k, s, c, p = 3, 8, 8, 7
    rh = StandardROIHeads(num_classes=k, in_channels=c, pooler_scales=(1 / 4,), fc_dim=8, emb_dim=8,
                          batch_size_per_image=s, positive_fraction=0.25,
                          mask_head=dict(num_conv=1, conv_dim=8, cls_agnostic=False, canvas_stride=4.0))
    assert mask_head.foreground_rows(s, 0.25) == 2  # the quota
    r = np.random.RandomState(11)
    gt = np.tile(np.array([[[10, 10, 60, 50], [70, 40, 120, 100]]], np.float32), (2, 1, 1))  # (B, G, 4)
    near = gt[:, [0, 0, 1, 1]] + r.uniform(-2, 2, (2, 4, 4)).astype(np.float32)  # IoU >= 0.5: positives
    far = np.array([130, 5, 150, 20], np.float32) + r.uniform(0, 3, (2, 4, 4)).astype(np.float32)  # negatives
    proposals = Proposals(_t(np.concatenate([near, far], 1)), torch.zeros(2, 8), torch.ones(2, 8, dtype=torch.bool))
    # candidates: 8 proposals then the 2 ground-truth boxes; positives are 0-3 and 8-9
    u_pos = np.array([[0.1, 0.4, 0.9, 0.8, 0.5, 0.5, 0.5, 0.5, 0.4, 0.7],  # 0.4 twice at the 2nd smallest
                      [0.1, 0.2, 0.9, 0.8, 0.5, 0.5, 0.5, 0.5, 0.3, 0.7]], np.float32)
    uniforms = {"roi_pos": u_pos, "roi_neg": r.rand(2, 10), "roi_gather": r.rand(2, 10)}
    draw = lambda site, shape: _t(uniforms[site].astype(np.float32))  # noqa: E731
    boxes, classes, _, valid, matched_idx = rh.label_and_sample_proposals(
        proposals, _t(gt), _t(np.array([[0, 2], [1, 0]])), torch.ones(2, 2, dtype=torch.bool), draw)
    fg = valid & (classes >= 0) & (classes < k)
    assert fg.sum(1).tolist() == [3, 2] and bool(fg[:, :3].sum(1).eq(fg.sum(1)).all())
    canvas = np.zeros((2, 2, 32, 40), np.float32)
    canvas[:, 0] = 1.0  # constant per instance: every target is exact
    x = r.randn(2 * s, p, p, c).astype(np.float32)

    jm = jax_mask_head.MaskRCNNConvUpsampleHead(num_classes=k, num_conv=1, conv_dim=8)
    params = fill_params(jax.eval_shape(lambda q: jm.init(q, jnp.asarray(x)), jax.random.PRNGKey(0)), seed=5)
    state = convert_jax_params({"roi_heads": {"mask_head": params["params"]}})
    rh.mask_head.load_state_dict({n[len("roi_heads.mask_head."):]: v for n, v in state.items()}, strict=True)

    def jax_loss(q):  # JAX's roi_heads: the head on every row, the loss masked to the foreground
        logits = jm.apply(q, jnp.asarray(x))
        targets = jax.vmap(lambda cv, mi, bx: jax_mask_head.crop_mask_targets(cv, mi, bx, 2 * p, stride=4.0))(
            jnp.asarray(canvas), jnp.asarray(matched_idx.numpy()), jnp.asarray(boxes.numpy()))
        return jax_mask_head.mask_rcnn_loss(logits, targets.reshape(2 * s, 2 * p, 2 * p),
                                            jnp.asarray(classes.reshape(-1).numpy()), jnp.asarray(fg.reshape(-1).numpy()))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    crops = _t(x).reshape(2, s, p, p, c)
    assert rh._fg_rows(classes, valid) == 3
    loss = rh._mask_losses(lambda bx: crops[:, :bx.shape[1]].reshape(-1, p, p, c), boxes, classes, valid,
                           matched_idx, _t(canvas), rh._fg_rows(classes, valid))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = convert_jax_params({"roi_heads": {"mask_head": want_grads["params"]}})
    for name, q in rh.mask_head.named_parameters():
        w = grads[f"roi_heads.mask_head.{name}"].numpy()
        np.testing.assert_allclose(q.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_the_deconv_taps_are_flipped_from_the_flax_kernel():
    """An asymmetric flax deconv kernel: the converted ConvTranspose2d
    reproduces JAX's output only with both spatial axes flipped."""
    jm, params, ours, x = _head_pair("c4")
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(ours(_t(x)).numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
        ours.deconv.weight.copy_(ours.deconv.weight.flip(2, 3))  # unflipped: a head of the right shape, wrong
        assert np.abs(ours(_t(x)).numpy() - want).max() > 1e-2 * np.abs(want).max()


# ---------------- targets ----------------
def _canvas(r, b, g, hm, wm):
    return (r.rand(b, g, hm, wm) > 0.6).astype(np.float32)


def _near_half(canvas, gt_idx, boxes, out_size, stride):
    """Which target pixels' averaged bilinear value lies within NEAR of 0.5,
    in float64 from the same sample points."""
    b, g, hm, wm = canvas.shape
    n = out_size * 2
    out = np.zeros(gt_idx.shape + (out_size, out_size), bool)
    for i in range(b):
        for j in range(gt_idx.shape[1]):
            m = canvas[i, gt_idx[i, j]].astype(np.float64)
            x1, y1, x2, y2 = boxes[i, j].astype(np.float64) / stride
            bw, bh = max(x2 - x1, 1e-6), max(y2 - y1, 1e-6)
            ys = np.clip(y1 + (np.arange(n) + 0.5) * bh / n - 0.5, 0, hm - 1)
            xs = np.clip(x1 + (np.arange(n) + 0.5) * bw / n - 0.5, 0, wm - 1)
            y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
            y1i, x1i = np.minimum(y0 + 1, hm - 1), np.minimum(x0 + 1, wm - 1)
            ly, lx = (ys - y0)[:, None], (xs - x0)[None, :]
            v = (m[y0][:, x0] * (1 - ly) * (1 - lx) + m[y0][:, x1i] * (1 - ly) * lx + m[y1i][:, x0] * ly * (1 - lx)
                 + m[y1i][:, x1i] * ly * lx)
            out[i, j] = np.abs(v.reshape(out_size, 2, out_size, 2).mean((1, 3)) - 0.5) < NEAR
    return out


@pytest.mark.parametrize("out_size, stride", [(28, 4.0), (14, 4.0), (28, 1.0)])
def test_crop_mask_targets_equal_jax(out_size, stride):
    """Boxes inside, across and outside the canvas (clipped samples), tiny
    boxes, a box on the canvas's pixel grid; uint8 canvases as the loader
    gives them."""
    r = np.random.RandomState(int(stride * 100) + out_size)
    b, g, s = 2, 4, 40
    hm, wm = 30, 42
    canvas = _canvas(r, b, g, hm, wm)
    boxes = np.stack([_boxes(r, s, wm * stride * 1.2, hm * stride * 1.2) - 8 for _ in range(b)])
    boxes[0, :3] = [[0, 0, 4 * stride, 4 * stride], [5, 5, 5.5, 5.2], [-20, -20, 400, 400]]
    gt_idx = r.randint(0, g, (b, s))
    want = np.asarray(jax.jit(jax.vmap(lambda c, i, bx: jax_mask_head.crop_mask_targets(
        c, i, bx, out_size, stride=stride)))(jnp.asarray(canvas), jnp.asarray(gt_idx), jnp.asarray(boxes)))
    got = mask_head.crop_mask_targets(_t(canvas).to(torch.uint8), _t(gt_idx), _t(boxes), out_size, stride).numpy()
    assert got.shape == want.shape == (b, s, out_size, out_size) and 0.1 < want.mean() < 0.9
    differ = got != want
    assert not (differ & ~_near_half(canvas, gt_idx, boxes, out_size, stride)).any()


# ---------------- the paste ----------------
def _paste_case(seed, n=12, m=28, hw=(90, 130)):
    r = np.random.RandomState(seed)
    probs = r.rand(n, m, m).astype(np.float32)
    probs[0] = 0.5  # every pixel of the box at the threshold
    boxes = _boxes(r, n, hw[1] * 1.1, hw[0] * 1.1, min_size=0.5) - 5
    boxes[1] = [10.25, 20.75, 10.5, 21.0]  # under a pixel
    boxes[2] = [-30, -30, 300, 300]  # over the whole image
    return probs, boxes, hw


def _paste_values(probs, boxes, hw):
    """The paste's bilinear values in float64 (JAX's numpy formula)."""
    H, W = hw
    n, m, _ = probs.shape
    out = np.zeros((n, H, W))

    def taps(s):
        i0 = np.floor(s).astype(np.int64)
        f = s - i0
        return (np.clip(i0, 0, m - 1), (1 - f) * ((i0 >= 0) & (i0 <= m - 1)), np.clip(i0 + 1, 0, m - 1),
                f * ((i0 + 1 >= 0) & (i0 + 1 <= m - 1)))

    for i in range(n):
        x1, y1, x2, y2 = boxes[i].astype(np.float64)
        r0, wy0, r1, wy1 = taps((np.arange(H) + 0.5 - y1) / max(y2 - y1, 1e-3) * m - 0.5)
        c0, wx0, c1, wx1 = taps((np.arange(W) + 0.5 - x1) / max(x2 - x1, 1e-3) * m - 0.5)
        mk = probs[i].astype(np.float64)
        out[i] = (mk[r0][:, c0] * wy0[:, None] * wx0 + mk[r0][:, c1] * wy0[:, None] * wx1
                  + mk[r1][:, c0] * wy1[:, None] * wx0 + mk[r1][:, c1] * wy1[:, None] * wx1)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_the_paste_equals_jax(seed, monkeypatch):
    """The host library (window-only) and the full-grid plain version against
    JAX's `paste_masks_np` with and without its native helper, and the
    torch paste against JAX's `paste_masks_in_image`: equal but for pixels
    within 1e-6 of the threshold."""
    from cddmsl_tpu.csrc import build as jax_csrc_build

    probs, boxes, hw = _paste_case(seed)
    near = np.abs(_paste_values(probs, boxes, hw) - 0.5) < NEAR
    with_native = jax_masks.paste_masks_np(probs, boxes, hw)
    monkeypatch.setattr(jax_csrc_build, "load_native", lambda name="": None)
    want = jax_masks.paste_masks_np(probs, boxes, hw)
    assert want.shape == (12, *hw) and 0 < want.mean() < 1 and near.any()
    got_window, got_grid = masks.paste_masks_np(probs, boxes, hw), masks.paste_masks_full_grid(probs, boxes, hw)
    np.testing.assert_array_equal(got_window, got_grid)
    for ref in (want, with_native):
        assert not ((got_window != ref) & ~near).any()
    got_t = mask_head.paste_masks_in_image(_t(probs), _t(boxes), hw).numpy()
    want_t = np.asarray(jax_mask_head.paste_masks_in_image(jnp.asarray(probs), jnp.asarray(boxes), hw))
    values32 = _paste_values(probs, boxes, hw)
    assert not ((got_t != want_t) & (np.abs(values32 - 0.5) >= 1e-5)).any()
    assert masks.paste_masks_np(probs[:0], boxes[:0], hw).shape == (0, *hw)


def test_the_host_library_raises_when_it_cannot_build(tmp_path, monkeypatch):
    """No fallback: a failed build raises, and so does the paste."""
    lib = _build.HostLibrary("maskops.cpp", {"paste_masks": (ctypes.c_longlong,)})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_cxx", lambda: "false")
    with pytest.raises(RuntimeError, match="building maskops.cpp failed"):
        lib.library()
    monkeypatch.setattr(masks.MASKOPS, "_lib", None)
    monkeypatch.setattr(masks.MASKOPS, "library", lib.library)
    probs, boxes, hw = _paste_case(0)
    with pytest.raises(RuntimeError):
        masks.paste_masks_np(probs, boxes, hw)


# ---------------- RLE, polygons, canvases ----------------
def test_rle_codec_equals_jax():
    """Encode (a mask starting with a set pixel, an empty and a full one),
    decode, the area and pycocotools' compressed counts, exactly."""
    r = np.random.RandomState(3)
    ms = [r.rand(17, 23) > 0.5, np.zeros((5, 7), bool), np.ones((4, 6), bool), r.rand(1, 9) > 0.3]
    ms[0][0, 0] = True
    for m in ms:
        got, want = masks.rle_encode(m), jax_masks.rle_encode(m)
        assert got == want
        np.testing.assert_array_equal(masks.rle_decode(got), m)
        assert masks.rle_area(got) == jax_masks.rle_area(want) == int(m.sum())
    # compressed strings of pycocotools (leading zero run, long runs, a negative delta)
    for s, size in (("0<1", [2, 2]), ("4=3`0", [5, 5]), ("R1S1", [10, 10]), ("b0e0U1", [8, 12])):
        rle = {"size": size, "counts": s}
        np.testing.assert_array_equal(masks.coco_rle_to_bitmask(rle), jax_masks.coco_rle_to_bitmask(rle))
        np.testing.assert_array_equal(masks.coco_rle_to_bitmask({"size": size, "counts": s.encode()}),
                                      jax_masks.coco_rle_to_bitmask(rle))


def test_polygons_segmentations_and_canvases_equal_jax():
    r = np.random.RandomState(5)
    polys = [[(r.rand(int(r.randint(3, 9)), 2) * [150, 90]).astype(np.float32) for _ in range(int(r.randint(0, 3)))]
             for _ in range(5)]
    for stride in (1, 4):
        np.testing.assert_array_equal(rasterize_polygons(polys, (96, 160), stride),
                                      jax_rasterize_polygons(polys, (96, 160), stride))
    assert rasterize_polygons(polys, (96, 160), 4).dtype == np.uint8
    seg_poly = [list(p.reshape(-1)) for p in polys[1]] or [[1, 1, 20, 1, 20, 30]]
    for seg in (seg_poly, {"size": [10, 10], "counts": "R1S1"}, np.eye(6, dtype=bool), None):
        assert masks.segmentation_to_rle(seg, (40, 60)) == jax_masks.segmentation_to_rle(seg, (40, 60))


def test_the_mapper_and_collate_give_jax_canvases(tmp_path):
    """The COCO fixture's polygons through the mapper (resize and flip) and
    the training collate at stride 4, against JAX's loader pieces: the same
    rings and the same canvases (uint8 here, float32 there)."""
    json_path, img_root = make_synthetic_coco(str(tmp_path), n=6, seed=2)
    cfg, ref = get_cfg(), jax_get_cfg()
    for c in (cfg, ref):
        c.merge_from_list(["MODEL.MASK_ON", "True", "INPUT.MIN_SIZE_TRAIN", "(96, 120)", "INPUT.MAX_SIZE_TRAIN",
                           "200", "INPUT.RANDOM_FLIP", "horizontal"])
    try:
        dicts = load_coco_json(json_path, img_root, "port_test_mask_coco")
        assert dicts == jax_load_coco_json(json_path, img_root, "port_test_mask_coco")
        assert all("segmentation" in a for d in dicts for a in d["annotations"])
        ours, theirs = DatasetMapper(cfg, True), JaxDatasetMapper(ref, True)
        r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
        samples = [ours(d, r1) for d in dicts]
        want = [theirs(d, r2) for d in dicts]
        for s, w in zip(samples, want):
            assert len(s["polygons"]) == len(w["polygons"]) == len(s["boxes"])
            for a, b in zip(s["polygons"], w["polygons"]):
                assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        got = pad_and_collate(samples, (128, 208), 4, mask_stride=4)
        ref_batch = jax_pad_and_collate(want, (128, 208), 4, mask_stride=4)
        assert got.gt_masks.dtype == torch.uint8 and tuple(got.gt_masks.shape) == (6, 4, 32, 52)
        np.testing.assert_array_equal(got.gt_masks.numpy(), np.asarray(ref_batch.gt_masks))
        assert got.gt_masks.sum() > 0
    finally:
        MetadataCatalog.remove("port_test_mask_coco")
        JaxMetadataCatalog._registry.pop("port_test_mask_coco", None)


# ---------------- mask IoU and segm AP ----------------
def test_mask_iou_and_segm_ap_equal_jax(tmp_path):
    """Seeded detections with box-frame masks and polygon / crowd-RLE ground
    truth over three images: `mask_iou_matrix` and both tasks' AP dicts of
    `COCOEvaluator` within 1e-9, and the dumped json's RLEs equal."""
    r = np.random.RandomState(11)
    rles = [masks.rle_encode(r.rand(20, 30) > t) for t in (0.3, 0.5, 0.7, 0.9)]
    crowd = np.array([False, True, False])
    got = masks.mask_iou_matrix(rles[:2], rles[1:], crowd)
    np.testing.assert_allclose(got, jax_masks.mask_iou_matrix(rles[:2], rles[1:], crowd), rtol=0, atol=1e-9)
    assert masks.mask_iou_matrix([], rles, np.zeros(4, bool)).shape == (0, 4)

    for cat in (MetadataCatalog, JaxMetadataCatalog):
        cat.get("port_test_segm").set(thing_classes=["a", "b", "c"])
    try:
        ours = coco_eval.COCOEvaluator("port_test_segm", str(tmp_path / "ours.json"), tasks=("bbox", "segm"))
        ref = jax_coco_eval.COCOEvaluator("port_test_segm", tasks=("bbox", "segm"),
                                          output_json=str(tmp_path / "ref.json"))
        hw = (60, 80)
        for image_id in (1, 2, 3):
            g = int(r.randint(2, 5))
            gt = _boxes(r, g, 70, 50, min_size=16)
            gt_cls = r.randint(0, 3, g)
            segs = [[[b[0], b[1], b[2], b[1], b[2], b[3], b[0] + 2, b[3]]] for b in gt.tolist()]
            segs[0] = {"size": list(hw), "counts": masks.rle_encode(r.rand(*hw) > 0.8)["counts"]}
            crowd = np.zeros(g, bool)
            crowd[0] = True
            n = int(r.randint(3, 9))
            pick = r.randint(0, g, n)
            det = gt[pick] + r.randn(n, 4).astype(np.float32) * 1.5
            det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 2)
            scores, det_cls = r.rand(n).astype(np.float32), np.where(r.rand(n) < 0.8, gt_cls[pick], r.randint(0, 3, n))
            probs = (0.4 + 0.6 * r.rand(n, 28, 28)).astype(np.float32)  # mostly the box, a few holes
            for ev in (ours, ref):
                ev.process(image_id, det, scores, det_cls, masks=probs, image_hw=hw)
                ev.process_gt(image_id, gt, gt_cls, crowd, segmentations=segs, image_hw=hw)
        got, want = ours.evaluate(), ref.evaluate()
        assert set(got) == set(want) == {"bbox", "segm"}
        for task in want:
            assert got[task].keys() == want[task].keys()
            for k, v in want[task].items():
                assert (np.isnan(v) and np.isnan(got[task][k])) or abs(got[task][k] - v) <= 1e-9, (task, k)
        assert 0 < got["segm"]["AP"] < 100
        import json

        assert json.loads((tmp_path / "ours.json").read_text()) == json.loads((tmp_path / "ref.json").read_text())
    finally:
        MetadataCatalog.remove("port_test_segm")
        JaxMetadataCatalog._registry.pop("port_test_segm", None)


# ---------------- GIoU ----------------
def test_pairwise_giou_and_the_box_head_giou_loss_equal_jax():
    """`pairwise_giou` on disjoint, nested, touching and empty pairs; the box
    head's 1 - GIoU term (class-specific and class-agnostic deltas, weight
    10) and its gradient with respect to the deltas."""
    r = np.random.RandomState(9)
    a, b = _boxes(r, 64), _boxes(r, 64)
    a[:4] = [[0, 0, 10, 10], [2, 2, 4, 4], [0, 0, 10, 10], [5, 5, 5, 5]]
    b[:4] = [[20, 20, 30, 30], [0, 0, 10, 10], [10, 0, 20, 10], [5, 5, 5, 5]]
    np.testing.assert_allclose(pairwise_giou(_t(a), _t(b)).numpy(), np.asarray(jax_pairwise_giou(a, b)), rtol=0,
                               atol=1e-6)
    k, n = 4, 48
    boxes, gt = _boxes(r, n), _boxes(r, n)
    classes = r.randint(0, k + 1, n)
    valid = r.rand(n) > 0.1
    scores = r.randn(n, k + 1).astype(np.float32)
    for cols in (4 * k, 4):
        deltas = (r.randn(n, cols) * 0.3).astype(np.float32)

        def loss(d):
            return jax_fast_rcnn_losses(jnp.asarray(scores), d, jnp.asarray(boxes), jnp.asarray(gt),
                                        jnp.asarray(classes), jnp.asarray(valid), k,
                                        JaxBox2BoxTransform((10, 10, 5, 5)), box_reg_loss_type="giou",
                                        box_reg_loss_weight=10.0)["loss_box_reg"]

        want, want_grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(deltas))
        d = _t(deltas).requires_grad_(True)
        got = fast_rcnn_losses(_t(scores), d, _t(boxes), _t(gt), _t(classes), _t(valid), k,
                               Box2BoxTransform((10, 10, 5, 5)), box_reg_loss_weight=10.0,
                               box_reg_loss_type="giou")["loss_box_reg"]
        got.backward()
        assert float(want) > 0
        np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-6 * max(1.0, float(want)))
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)


def test_the_rpn_giou_loss_equals_jax():
    """The RPN's 1 - GIoU over positive anchors (weight 2) with JAX's draws
    replayed, and its gradient with respect to the deltas."""
    r = np.random.RandomState(12)
    b, h, w = 2, 6, 8
    jrpn = JaxRPN(in_channels=8, box_reg_loss_type="giou", box_reg_loss_weight=2.0)
    ours = RPN(8, box_reg_loss_type="giou", box_reg_loss_weight=2.0)
    anchors = ours._head(torch.zeros((b, h, w, 8)))[0]
    a = anchors.shape[0]
    logits = r.randn(b, a).astype(np.float32)
    deltas = (r.randn(b, a, 4) * 0.2).astype(np.float32)
    gt = np.stack([_boxes(r, 3, w * 16, h * 16, min_size=24) for _ in range(b)])
    gt_valid = np.array([[True, True, False], [True, False, False]])
    k_rpn, k_roi = jax.random.split(jax.random.PRNGKey(4))

    def loss(d):
        out = jrpn.apply({}, jnp.asarray(anchors.numpy()), jnp.asarray(logits), d, jnp.asarray(gt),
                         jnp.asarray(gt_valid), jax.random.split(k_rpn, b), method=lambda m, *x: m._losses(*x))
        return out["loss_rpn_loc"], out

    (want, want_all), want_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(deltas))
    d = _t(deltas).requires_grad_(True)
    got = ours._losses(anchors, _t(logits), d, _t(gt), _t(gt_valid), jax_draw(k_rpn, k_roi))
    got["loss_rpn_loc"].backward()
    assert float(want) > 0
    np.testing.assert_allclose(got["loss_rpn_loc"].item(), float(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["loss_rpn_cls"].item(), float(want_all["loss_rpn_cls"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)


# ---------------- converters ----------------
MASK_NARROW = dict(num_classes=6, depth=10, backbone_width=8, res2_out_channels=32, fpn_out_channels=32, fc_dim=32,
                   emb_dim=24, mask_on=True, mask_num_conv=2, mask_conv_dim=16)


def test_a_d2_fpn_file_gives_the_head_jax_converts_from_it(tmp_path):
    """A seeded detectron2 Mask R-CNN FPN file through `load_rcnn_weights`
    (d2_fpn) equals JAX's `convert_d2_fpn_rcnn` of it through
    `convert_jax_params`, every tensor exactly (the deconv flipped into the
    flax kernel and back); the same head from the JAX tree runs as JAX's."""
    ours = FPNRCNN(**MASK_NARROW)
    r = np.random.RandomState(0)
    sd = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32)) for k, v in ours.state_dict().items()}
    path = tmp_path / "model_final.pth"
    torch.save({"model": sd}, path)
    assert load_rcnn_weights(ours, str(path)) == "d2_fpn"
    want = convert_jax_params(convert_d2_fpn_rcnn({k: v.numpy() for k, v in sd.items()}))
    state = ours.state_dict()
    assert set(want) == set(state) and "roi_heads.mask_head.deconv.weight" in want
    for name, value in want.items():
        torch.testing.assert_close(state[name], value, rtol=0, atol=0, msg=name)
    for name in ("deconv.weight", "predictor.weight", "mask_fcn2.bias"):
        assert torch.equal(state[f"roi_heads.mask_head.{name}"], sd[f"roi_heads.mask_head.{name}"])


def test_a_d2_rcnn_file_loads_the_c4_mask_head(tmp_path):
    """A C4 model's file (d2_rcnn) carries roi_heads.mask_head.*: the port
    loads them as they are, the head of the JAX tree they were converted
    from (JAX's own d2_rcnn loader leaves the mask head out)."""
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / "quick_schedules" / "segm_training_acc_test.yaml"))
    config = model_config_from_cfg(cfg)
    model = build_detector(cfg, device="cpu")
    jm, params, head, x = _head_pair("c4", k=config.num_classes)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    head_state = {n[len("roi_heads.mask_head."):]: v for n, v in convert_jax_params(
        {"roi_heads": {"mask_head": fill_params(jax.eval_shape(lambda r: jax_mask_head.MaskRCNNConvUpsampleHead(
            num_classes=config.num_classes, conv_dim=256).init(r, jnp.zeros((1, 7, 7, 512))),
            jax.random.PRNGKey(0)), seed=3)["params"]}}).items()}
    sd.update({f"roi_heads.mask_head.{n}": v for n, v in head_state.items()})
    torch.save({"model": sd}, tmp_path / "c4.pth")
    assert load_rcnn_weights(model, str(tmp_path / "c4.pth")) == "d2_rcnn"
    for n, v in head_state.items():
        assert torch.equal(model.roi_heads.mask_head.state_dict()[n], v), n


# ---------------- the configs ----------------
def _cfg(path):
    ours, ref = get_cfg(), jax_get_cfg()
    ours.merge_from_file(str(REPO / "configs" / path))
    ref.merge_from_file(str(REPO / "configs" / path))
    return ours, ref


ACCEPTED = (
    "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml", "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml",
    "COCO-InstanceSegmentation/mask_rcnn_R_101_FPN_3x.yaml",
    "COCO-InstanceSegmentation/mask_rcnn_X_101_32x8d_FPN_3x.yaml",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x_giou.yaml", "Misc/mask_rcnn_R_50_FPN_1x_cls_agnostic.yaml",
    "Detectron1-Comparisons/mask_rcnn_R_50_FPN_noaug_1x.yaml", "quick_schedules/mask_rcnn_R_50_FPN_instant_test.yaml",
    "COCO-InstanceSegmentation/mask_rcnn_R_50_DC5_1x.yaml", "COCO-InstanceSegmentation/mask_rcnn_R_50_DC5_3x.yaml",
    "COCO-InstanceSegmentation/mask_rcnn_R_101_DC5_3x.yaml", "COCO-InstanceSegmentation/mask_rcnn_R_50_C4_3x.yaml",
    "COCO-InstanceSegmentation/mask_rcnn_R_101_C4_3x.yaml", "COCO-InstanceSegmentation/mask_rcnn_CLIP_R_50_C4_1x.yaml",
    "VOC-Experiments/mask_rcnn_CLIP_R_50_C4_1x.yaml", "quick_schedules/segm_training_acc_test.yaml",
    "quick_schedules/segm_inference_acc_test.yaml",
    # refused until the trainable norms, the RepeatFactor sampler and the CLIP FPN tower were ported
    "Misc/mask_rcnn_R_50_FPN_3x_gn.yaml", "Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml",
    "Misc/scratch_mask_rcnn_R_50_FPN_3x_gn.yaml", "Misc/scratch_mask_rcnn_R_50_FPN_9x_syncbn.yaml",
    "LVISv0.5-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml", "LVISv1-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml",
    "LVISv1-InstanceSegmentation/mask_rcnn_CLIP_R_50_FPN_1x.yaml",
)
C4_FIELDS = ("backbone_type", "num_classes", "use_text_emb", "pooler_resolution", "mask_on", "mask_num_conv",
             "mask_conv_dim", "mask_cls_agnostic", "mask_canvas_stride", "cls_agnostic_bbox_reg")


def _accepted_id(path):
    """The file's stem; an LVIS file's with its folder (the stems repeat)."""
    p = Path(path)
    return f"{p.parent.name}-{p.stem}" if p.parent.name.startswith("LVIS") else p.stem


@pytest.mark.parametrize("path", ACCEPTED, ids=_accepted_id)
def test_mask_configs_are_accepted_with_the_jax_builders_fields(path):
    """Accepted at world 1, every field the port's builder gives equal to
    JAX's module's (FPNRCNN, or GeneralizedRCNN's mask and head fields), and
    the detector built (on the meta device: full-width weights, no values)
    with its mask head."""
    ours, ref = _cfg(path)
    check_supported(ours, world=1)
    want = jax_build_model(ref)
    family = model_family(ours)
    assert want.mask_on
    if family == "c4":
        config = model_config_from_cfg(ours)
        for name in C4_FIELDS:
            assert getattr(config, name) == getattr(want, name), name
    else:
        assert type(want).__name__ == "FPNRCNN"
        for name, value in fpn_rcnn_fields(ours).items():
            expect = getattr(want, name)
            if name == "dtype":
                assert str(value).split(".")[-1] == jnp.dtype(expect).name
            elif name == "backbone_width":
                assert value == (expect or 64), name
            else:
                assert value == (tuple(expect) if isinstance(expect, (list, tuple)) else expect), name
    with torch.device("meta"):
        model = build_detector(ours, device="meta")
    head = model.roi_heads.mask_head
    k = 1 if ours.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK else ours.MODEL.ROI_HEADS.NUM_CLASSES
    assert head is not None and head.num_conv == ours.MODEL.ROI_MASK_HEAD.NUM_CONV and head.predictor.out_channels == k


@pytest.mark.parametrize("key", ["MODEL.RPN.BBOX_REG_LOSS_TYPE", "MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE"])
def test_faster_rcnn_takes_giou(key):
    """GIoU on either box loss of the FPN family, as JAX's FPNRCNN builds it;
    the C4 family accepts it and, as JAX's GeneralizedRCNN, does not read it."""
    ours, ref = _cfg("COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml")
    for c in (ours, ref):
        c.merge_from_list([key, "giou"])
    check_supported(ours, world=1)
    fields, want = fpn_rcnn_fields(ours), jax_build_model(ref)
    name = "rpn_box_reg_loss_type" if ".RPN." in key else "box_reg_loss_type"
    assert fields[name] == getattr(want, name) == "giou"
    c4 = get_cfg()
    c4.merge_from_list(["MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER", "True", key, "giou"])
    check_supported(c4, world=1)


# the two dconv_c3-c5 files and the panoptic dconv-GN-cascade one are accepted since the deformable stages were
# ported (test_torch_port_dconv.py, _dconv_panoptic.py); the X-152 file names its 32 groups (its id kept).
# Cityscapes' file is accepted since its instance sets were ported (test_torch_port_rotated.py); its id now
# holds the next file still refused, the rotated one
REFUSED = [
    pytest.param("Misc/cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml", "MODEL.RESNETS.NUM_GROUPS",
                 id="cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv-MODEL.RESNETS.DEFORM_ON_PER_STAGE"),
    pytest.param("Misc/rotated_faster_rcnn.yaml", "MODEL.META_ARCHITECTURE", id="mask_rcnn_R_50_FPN-DATASETS.TRAIN"),
    ("COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml", "TPU.ENABLE_CAPTION_CONSISTENCY"),
]


@pytest.mark.parametrize("path, key", REFUSED, ids=lambda v: Path(v).stem if v.endswith(".yaml") else v)
def test_mask_configs_the_port_refuses_name_their_key(path, key):
    cfg = get_cfg()
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        cfg.merge_from_file(str(REPO / "configs" / path))
        check_supported(cfg, world=1)


_MASK_KEYS = [
    ("MODEL.ROI_MASK_HEAD.NORM", "GN"), ("MODEL.ROI_MASK_HEAD.NORM", "SyncBN"),
    ("MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION", 28), ("MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO", 2),
    ("MODEL.ROI_MASK_HEAD.POOLER_TYPE", "ROIAlign"), ("MODEL.ROI_MASK_HEAD.NAME", "MaskRCNNConvGNHead"),
    ("MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE", "ROIPool"),
]
# FPNRCNN's mask head takes ROI_MASK_HEAD.NORM GN and SyncBN (the trainable norms are ported); the C4 head does not
_MASK_NORM_TAKEN = [("fpn", "MODEL.ROI_MASK_HEAD.NORM", "GN"), ("fpn", "MODEL.ROI_MASK_HEAD.NORM", "SyncBN")]
_MASK_REFUSED = [(f, k, v) for f in ("fpn", "c4") for k, v in _MASK_KEYS if (f, k, v) not in _MASK_NORM_TAKEN]


def _mask_key_cfg(family, key, value):
    path = ("COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml" if family == "fpn"
            else "COCO-InstanceSegmentation/mask_rcnn_CLIP_R_50_C4_1x.yaml")
    cfgs = _cfg(path)
    for cfg in cfgs:
        if key.startswith("MODEL.ROI_KEYPOINT_HEAD."):  # a keypoint head's key, under MODEL.KEYPOINT_ON
            cfg.merge_from_list(["MODEL.KEYPOINT_ON", "True"])
        cfg.merge_from_list([key, value if isinstance(value, str) else repr(value)])
    return cfgs


@pytest.mark.parametrize("family, key, value", _MASK_NORM_TAKEN, ids=lambda v: str(v))
def test_the_fpn_mask_head_takes_its_norm_as_jax_builds_it(family, key, value):
    ours, ref = _mask_key_cfg(family, key, value)
    check_supported(ours, world=1)
    assert fpn_rcnn_fields(ours)["mask_conv_norm"] == jax_build_model(ref).mask_conv_norm == value
    with torch.device("meta"):
        head = build_detector(ours, device="meta").roi_heads.mask_head
    assert head.conv_norm == value and head.mask_fcn1.bias is None and head.mask_fcn1.norm is not None


@pytest.mark.parametrize("family, key, value", _MASK_REFUSED, ids=lambda v: str(v))
def test_the_mask_keys_jax_does_not_compute_with_are_refused(family, key, value):
    cfg = _mask_key_cfg(family, key, value)[0]
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        check_supported(cfg, world=1)
