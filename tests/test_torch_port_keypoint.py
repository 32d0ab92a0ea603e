"""Keypoint R-CNN's pieces in the port against cddmsl_tpu on the CPU: the
keypoint head (its deconv's taps and padding, the 2x upsample), the loss
under both normalisers, the heatmap targets, the decode, the keypoint
transforms, the mapper, the collate, the MIN_KEYPOINTS_PER_IMAGE filter and
the COCO loader, OKS and keypoints AP, the converters, and the configs the
port accepts and refuses. Every input is made with numpy from a seed; every
weight is JAX's, carried over by `convert_jax_params`. Tolerances, and why:
- the head's logits within 1e-5 of their largest value, its gradients and
  the loss within 1e-5 relative (gradients never less than 1e-6, see
  GRAD_FLOOR): the same convolutions summed in another order; the upsample
  within 1e-6 (the same two-tap weights);
- the targets exactly (integer bins and flags of the same float32
  arithmetic);
- the decode: (x, y) within 1e-4 px and the score within 1e-6 (the same
  bicubic surface; its 24x24 argmax may only move on a float tie);
- the transforms, the mapper, the collate, the filter and the loader
  exactly;
- OKS and the keypoints AP dict within 1e-9 (float64 numpy both).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.checkpoint.convert_torch import convert_d2_fpn_rcnn
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.data import transforms as jax_transforms
from cddmsl_tpu.data.build import filter_images_with_few_keypoints as jax_filter
from cddmsl_tpu.data.build import pad_and_collate as jax_pad_and_collate
from cddmsl_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from cddmsl_tpu.data.dataset_mapper import DatasetMapper as JaxDatasetMapper
from cddmsl_tpu.data.datasets.coco import load_coco_json as jax_load_coco_json
from cddmsl_tpu.evaluation import coco_eval as jax_coco_eval
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models import keypoint_head as jax_kp
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params, init_random_
from cddmsl_torch.checkpoint.convert_torch import fc1_from_chw, load_rcnn_weights
from cddmsl_torch.config import check_supported, get_cfg, model_config_from_cfg, model_family
from cddmsl_torch.data import transforms
from cddmsl_torch.data.build import filter_images_with_few_keypoints, pad_and_collate
from cddmsl_torch.data.catalog import MetadataCatalog
from cddmsl_torch.data.dataset_mapper import DatasetMapper
from cddmsl_torch.data.datasets.coco import load_coco_json
from cddmsl_torch.data.datasets.synthetic import make_synthetic_coco
from cddmsl_torch.evaluation import coco_eval
from cddmsl_torch.models import keypoint_head
from cddmsl_torch.models.build import build_detector, fpn_rcnn_fields
from cddmsl_torch.models.fpn_rcnn import FPNRCNN
from cddmsl_torch.models.roi_heads import StandardROIHeads
from cddmsl_torch.models.rpn import Proposals
from test_torch_port_backbone import fill_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# score_lowres's bias gradient is 0 in exact arithmetic (the softmax over a
# heatmap's positions does not see a constant added to all of them): both
# packages give float noise below 1e-6 there
GRAD_FLOOR = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(r, n, w=160.0, h=120.0, min_size=4.0):
    x1, y1 = r.rand(n) * w * 0.7, r.rand(n) * h * 0.7
    bw, bh = min_size + r.rand(n) * w * 0.4, min_size + r.rand(n) * h * 0.4
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


# ---------------- the head and its loss ----------------
HEADS = {"narrow": dict(conv_dims=(16, 16), c=8, p=14, k=3), "one_conv": dict(conv_dims=(12,), c=6, p=7, k=5)}


def _head_pair(kind, seed=0):
    spec = HEADS[kind]
    jm = jax_kp.KRCNNConvDeconvUpsampleHead(num_keypoints=spec["k"], conv_dims=spec["conv_dims"])
    x = np.random.RandomState(seed).randn(4, spec["p"], spec["p"], spec["c"]).astype(np.float32)
    params = fill_params(jax.eval_shape(lambda r: jm.init(r, jnp.asarray(x)), jax.random.PRNGKey(0)), seed=seed + 1)
    head = keypoint_head.KRCNNConvDeconvUpsampleHead(spec["c"], spec["k"], spec["conv_dims"])
    state = convert_jax_params({"roi_heads": {"keypoint_branch": {"keypoint_head": params["params"]}}})
    head.load_state_dict({n[len("roi_heads.keypoint_head."):]: v for n, v in state.items()}, strict=True)
    return jm, params, head, x


@pytest.mark.parametrize("normalizer", [None, 40.0], ids=["visible", "fixed"])
@pytest.mark.parametrize("kind", list(HEADS))
def test_head_logits_loss_and_gradients_equal_jax(kind, normalizer):
    """(N, 4P, 4P, K) logits of the convs, the 4x4 stride-2 deconv (flax's
    "SAME" padding) and the 2x upsample; the cross-entropy loss by the
    visible count or a fixed normaliser, and the head's gradients."""
    jm, params, head, x = _head_pair(kind)
    n, p, k = x.shape[0], x.shape[1], HEADS[kind]["k"]
    r = np.random.RandomState(3)
    pos = r.randint(0, (4 * p) ** 2, (n, k))
    vis = r.rand(n, k) < 0.7

    def jax_loss(q):
        return jax_kp.keypoint_rcnn_loss(jm.apply(q, jnp.asarray(x)), jnp.asarray(pos), jnp.asarray(vis), normalizer)

    want_logits = np.asarray(jm.apply(params, jnp.asarray(x)))
    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    logits = head(_t(x))
    assert tuple(logits.shape) == (n, 4 * p, 4 * p, k) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=0, atol=1e-5 * np.abs(want_logits).max())
    loss = keypoint_head.keypoint_rcnn_loss(logits, _t(pos), _t(vis), normalizer)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    grads = convert_jax_params({"roi_heads": {"keypoint_branch": {"keypoint_head": want_grads["params"]}}})
    for name, prm in head.named_parameters():
        want = grads[f"roi_heads.keypoint_head.{name}"].numpy()
        np.testing.assert_allclose(prm.grad.numpy(), want, rtol=0, atol=max(1e-5 * np.abs(want).max(), GRAD_FLOOR),
                                   err_msg=name)


def test_the_deconv_is_flaxs_same_transposed_conv_with_flipped_taps():
    """One input pixel through `score_lowres` alone: flax's ConvTranspose
    (4x4, stride 2, "SAME", taps unflipped) and the port's ConvTranspose2d
    (padding 1) of the flipped kernel put the same 4x4 footprint at the same
    place, (2i - 1 .. 2i + 2), edges included."""
    rng = np.random.RandomState(5)
    kernel = rng.randn(4, 4, 1, 1).astype(np.float32)
    for i, j in ((0, 0), (2, 3), (4, 4)):
        x = np.zeros((1, 5, 5, 1), np.float32)
        x[0, i, j, 0] = 1.0
        want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(kernel), (2, 2), "SAME",
                                      dimension_numbers=("NHWC", "HWIO", "NHWC"))
        w = torch.from_numpy(np.ascontiguousarray(np.transpose(kernel[::-1, ::-1], (2, 3, 0, 1))))
        got = torch.nn.functional.conv_transpose2d(_t(x).permute(0, 3, 1, 2), w, stride=2, padding=1)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
        assert got.shape[-1] == 10


def test_the_upsample_equals_jax_image_resize_at_the_edges():
    """F.interpolate (bilinear, align_corners False) clamps the edge sample
    where jax.image.resize renormalises the edge weights: both give the
    edge pixel, and the interior's two-tap weights are the same."""
    x = np.random.RandomState(7).randn(2, 6, 9, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 12, 18, 3), method="bilinear"))
    got = torch.nn.functional.interpolate(_t(x).permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                                          align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], rtol=0, atol=1e-6)


# ---------------- the targets and the decode ----------------
def test_heatmap_targets_equal_jax_with_the_edge_cases():
    """Bins floor((x - x1) * S / w) clipped to [0, S-1]; a keypoint on the
    box's far edge or corner stays visible in the last bin; one just outside
    is invisible; a box thinner than 1e-4 takes the 1e-4 floor; a flag of
    0 is invisible."""
    r = np.random.RandomState(2)
    boxes = _boxes(r, 6)
    boxes[5, 2] = boxes[5, 0] + 5e-5  # below the 1e-4 width floor
    kps = np.zeros((6, 5, 3), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        kps[i, 0] = (x2, y2, 2)  # the far corner
        kps[i, 1] = (x2, y1 + 0.5 * (y2 - y1), 1)  # the far edge
        kps[i, 2] = (x1 + r.rand() * (x2 - x1), y1 + r.rand() * (y2 - y1), 0)  # unlabelled
        kps[i, 3] = (x2 + 0.5, y1, 2)  # just outside
        kps[i, 4] = (x1 + r.rand() * (x2 - x1), y1 + r.rand() * (y2 - y1), 2)
    want_pos, want_vis = jax_kp.KeypointROIHeads.keypoints_to_heatmap_targets(jnp.asarray(kps), jnp.asarray(boxes),
                                                                               56)
    pos, vis = keypoint_head.keypoints_to_heatmap_targets(_t(kps), _t(boxes), 56)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(want_vis))
    assert vis[:, 0].all() and vis[:, 1].all() and not vis[:, 2].any() and not vis[:, 3].any()
    assert (pos[:5, 0] == 56 * 56 - 1).all()


@pytest.mark.parametrize("size", [56, 28])
def test_the_decode_equals_jax(size):
    """Smooth peaked heatmaps (a peak per keypoint, some at the map's edge
    and corner, one flat map) and their boxes: JAX's static refinement,
    (x, y) within 1e-4 px, the score within 1e-6."""
    r = np.random.RandomState(size)
    b, d, k = 2, 5, 4
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    heat = np.zeros((b * d, size, size, k), np.float32)
    for n in range(b * d):
        for j in range(k):
            cy, cx = r.uniform(-1, size, 2) if (n + j) % 3 else (0.0, size - 1.0)
            s = r.uniform(1.0, 4.0)
            heat[n, :, :, j] = 6 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)) + 0.2 * r.randn(size, size)
    heat[3, :, :, 1] = 0.5  # flat: the first maximum, a flat surface
    boxes = _boxes(r, b * d).reshape(b, d, 4)
    want = np.asarray(jax_kp.decode_keypoint_heatmaps(jnp.asarray(heat), jnp.asarray(boxes)))
    got = keypoint_head.decode_keypoint_heatmaps(_t(heat), _t(boxes)).numpy()
    assert got.shape == (b, d, k, 3)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-6)
    a, offs, rpad = keypoint_head.refine_matrix(24)
    ja, joffs, jr = jax_kp._refine_matrix(size, 24)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(offs, joffs)
    assert rpad == jr == 3


def test_a_tie_at_the_positive_quota_keeps_every_foreground_row_in_loss_keypoint():
    """The sampler keeps every key tied at its threshold, as JAX's does, so
    an image can sample more positives than its quota int(S * fraction):
    here image 0 keeps 3 against a quota of 2. The keypoint branch still
    trains on every foreground row: `loss_keypoint` and the head's
    gradients equal JAX's, which runs the head on all S rows and masks the
    loss to the foreground (1e-5)."""
    k, s, c, p, kp = 3, 8, 8, 14, 3
    rh = StandardROIHeads(num_classes=k, in_channels=c, pooler_scales=(1 / 4,), fc_dim=8, emb_dim=8,
                          batch_size_per_image=s, positive_fraction=0.25,
                          keypoint_head=dict(num_keypoints=kp, conv_dims=(8,)))
    r = np.random.RandomState(11)
    gt = np.tile(np.array([[[10, 10, 60, 50], [70, 40, 120, 100]]], np.float32), (2, 1, 1))
    near = gt[:, [0, 0, 1, 1]] + r.uniform(-2, 2, (2, 4, 4)).astype(np.float32)
    far = np.array([130, 5, 150, 20], np.float32) + r.uniform(0, 3, (2, 4, 4)).astype(np.float32)
    proposals = Proposals(_t(np.concatenate([near, far], 1)), torch.zeros(2, 8), torch.ones(2, 8, dtype=torch.bool))
    u_pos = np.array([[0.1, 0.4, 0.9, 0.8, 0.5, 0.5, 0.5, 0.5, 0.4, 0.7],  # 0.4 twice at the 2nd smallest
                      [0.1, 0.2, 0.9, 0.8, 0.5, 0.5, 0.5, 0.5, 0.3, 0.7]], np.float32)
    uniforms = {"roi_pos": u_pos, "roi_neg": r.rand(2, 10), "roi_gather": r.rand(2, 10)}
    draw = lambda site, shape: _t(uniforms[site].astype(np.float32))  # noqa: E731
    boxes, classes, _, valid, matched_idx = rh.label_and_sample_proposals(
        proposals, _t(gt), _t(np.array([[0, 2], [1, 0]])), torch.ones(2, 2, dtype=torch.bool), draw)
    fg = valid & (classes >= 0) & (classes < k)
    assert fg.sum(1).tolist() == [3, 2] and rh._fg_rows(classes, valid) == 3
    gt_kps = np.zeros((2, 2, kp, 3), np.float32)
    for i in range(2):
        for j in range(2):
            x1, y1, x2, y2 = gt[i, j]
            gt_kps[i, j] = [(x1 + r.rand() * (x2 - x1), y1 + r.rand() * (y2 - y1), 2) for _ in range(kp)]
    x = r.randn(2 * s, p, p, c).astype(np.float32)
    jm = jax_kp.KRCNNConvDeconvUpsampleHead(num_keypoints=kp, conv_dims=(8,))
    params = fill_params(jax.eval_shape(lambda q: jm.init(q, jnp.asarray(x)), jax.random.PRNGKey(0)), seed=5)
    state = convert_jax_params({"roi_heads": {"keypoint_branch": {"keypoint_head": params["params"]}}})
    rh.keypoint_head.load_state_dict({n[len("roi_heads.keypoint_head."):]: v for n, v in state.items()}, strict=True)

    def jax_loss(q):  # JAX's roi_heads: the head on every row, the loss masked to the foreground
        heat = jm.apply(q, jnp.asarray(x))
        mk = np.take_along_axis(gt_kps, matched_idx.numpy()[..., None, None], 1).reshape(2 * s, kp, 3)
        pos, vis = jax_kp.KeypointROIHeads.keypoints_to_heatmap_targets(
            jnp.asarray(mk), jnp.asarray(boxes.numpy().reshape(2 * s, 4)), heat.shape[1])
        return jax_kp.keypoint_rcnn_loss(heat, pos, vis & jnp.asarray(fg.reshape(-1, 1).numpy()))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    crops = _t(x).reshape(2, s, p, p, c)
    loss = rh._keypoint_losses(lambda bx: crops[:, :bx.shape[1]].reshape(-1, p, p, c), boxes, classes, valid,
                               matched_idx, _t(gt_kps), rh._fg_rows(classes, valid))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    loss.backward()
    grads = convert_jax_params({"roi_heads": {"keypoint_branch": {"keypoint_head": want_grads["params"]}}})
    for name, prm in rh.keypoint_head.named_parameters():
        want = grads[f"roi_heads.keypoint_head.{name}"].numpy()
        np.testing.assert_allclose(prm.grad.numpy(), want, rtol=0, atol=max(1e-5 * np.abs(want).max(), GRAD_FLOOR),
                                   err_msg=name)


# ---------------- the data ----------------
def test_hflip_indices_and_keypoint_transforms_equal_jax():
    """A flip map of two pairs over five names; keypoints through a resize
    then a flip (mirrors swapped, points that leave the image unlabelled and
    zeroed), and through a resize alone."""
    meta = {"keypoint_names": ("nose", "l_eye", "r_eye", "l_ear", "r_ear"),
            "keypoint_flip_map": (("l_eye", "r_eye"), ("l_ear", "r_ear"))}
    np.testing.assert_array_equal(transforms.create_keypoint_hflip_indices(meta),
                                  jax_transforms.create_keypoint_hflip_indices(meta))
    idx = transforms.create_keypoint_hflip_indices(meta)
    assert idx.tolist() == [0, 2, 1, 4, 3]
    r = np.random.RandomState(4)
    kps = np.concatenate([r.rand(5, 2) * [140, 100], r.randint(0, 3, (5, 1))], 1).astype(np.float32)
    kps[4, :2] = (150.0, 20.0)  # outside the 140-wide image
    for flip in (True, False):
        ours = [transforms.ResizeTransform(100, 140, 120, 168)] + ([transforms.HFlipTransform(168)] if flip else [])
        ref = [jax_transforms.ResizeTransform(100, 140, 120, 168)] + (
            [jax_transforms.HFlipTransform(168)] if flip else [])
        got = transforms.transform_keypoint_annotations(kps, transforms.TransformList(ours), (120, 168), idx)
        want = jax_transforms.transform_keypoint_annotations(kps, jax_transforms.TransformList(ref), (120, 168), idx)
        np.testing.assert_array_equal(got, want)
        assert (got[got[:, 2] == 0] == 0).all()


def test_the_coco_loader_mapper_and_collate_give_jax_keypoints(tmp_path):
    """The keypoint fixture's json through both COCO loaders (keypoints kept
    raw: neither adds detectron2's +0.5), the MIN_KEYPOINTS_PER_IMAGE filter,
    the mapper (resize and flip, the fixture's empty flip map) and the
    training collate's (B, G, K, 3) against JAX's loader pieces."""
    json_path, img_root = make_synthetic_coco(str(tmp_path), n=6, seed=3, with_keypoints=True)
    cfg, ref = get_cfg(), jax_get_cfg()
    for c in (cfg, ref):
        c.merge_from_list(["MODEL.KEYPOINT_ON", "True", "MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS", "3",
                           "INPUT.MIN_SIZE_TRAIN", "(96, 120)", "INPUT.MAX_SIZE_TRAIN", "200",
                           "INPUT.RANDOM_FLIP", "horizontal", "DATASETS.TRAIN", "('port_test_kp',)"])
    names = ("kp_tl", "kp_center", "kp_br")
    for cat in (MetadataCatalog, JaxMetadataCatalog):
        cat.get("port_test_kp").set(keypoint_names=names, keypoint_flip_map=())
    try:
        dicts = load_coco_json(json_path, img_root, "port_test_kp")
        assert dicts == jax_load_coco_json(json_path, img_root, "port_test_kp")
        raw = [a["keypoints"] for d in dicts for a in d["annotations"]]
        with open(json_path) as f:
            written = [a["keypoints"] for a in json.load(f)["annotations"]]
        assert raw and sorted(raw) == sorted(written)  # the json's numbers as they are
        dicts[1]["annotations"][0]["keypoints"][2::3] = [0, 0, 0]
        for min_kp in (1, 4):
            assert filter_images_with_few_keypoints(dicts, min_kp) == jax_filter(dicts, min_kp)
        ours, theirs = DatasetMapper(cfg, True), JaxDatasetMapper(ref, True)
        r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
        samples = [ours(d, r1) for d in dicts]
        want = [theirs(d, r2) for d in dicts]
        for s, w in zip(samples, want):
            np.testing.assert_array_equal(s["keypoints"], w["keypoints"])
            assert s["keypoints"].shape == (len(s["boxes"]), 3, 3)
        got = pad_and_collate(samples, (128, 208), 4, num_keypoints=3)
        ref_batch = jax_pad_and_collate(want, (128, 208), 4, num_keypoints=3)
        assert tuple(got.gt_keypoints.shape) == (6, 4, 3, 3)
        np.testing.assert_array_equal(got.gt_keypoints.numpy(), np.asarray(ref_batch.gt_keypoints))
        assert got.gt_keypoints[..., 2].sum() > 0
    finally:
        MetadataCatalog.remove("port_test_kp")
        JaxMetadataCatalog._registry.pop("port_test_kp", None)


# ---------------- OKS and keypoints AP ----------------
def test_oks_and_keypoints_ap_equal_jax(tmp_path):
    """Seeded detections with keypoints near their ground truth's over three
    images and two classes, a ground truth without labelled keypoints, a
    crowd: `_oks_matrix` and the keypoints (and bbox) AP dicts of
    `COCOEvaluator` within 1e-9, sigmas from the metadata and from the
    evaluator's argument (TEST.KEYPOINT_OKS_SIGMAS)."""
    r = np.random.RandomState(12)
    k = 4
    gk = np.concatenate([r.rand(3, k, 2) * 50, np.full((3, k, 1), 2.0)], 2)
    gk[1, :, 2] = 0
    gb = _boxes(r, 3, 60, 60, min_size=20)
    dk = np.concatenate([gk[[0, 0, 2], :, :2] + r.randn(3, k, 2), r.rand(3, k, 1)], 2)
    sig = np.full(k, 0.07)
    np.testing.assert_allclose(coco_eval._oks_matrix(dk, gk, gb, sig), jax_coco_eval._oks_matrix(dk, gk, gb, sig),
                               rtol=0, atol=1e-9)
    for cat in (MetadataCatalog, JaxMetadataCatalog):
        cat.get("port_test_oks").set(thing_classes=["person", "cat"], keypoint_oks_sigmas=(0.05,) * k)
    try:
        for sigmas in (None, [0.09] * k):
            ours = coco_eval.COCOEvaluator("port_test_oks", tasks=("bbox", "keypoints"), kpt_oks_sigmas=sigmas)
            ref = jax_coco_eval.COCOEvaluator("port_test_oks", tasks=("bbox", "keypoints"), kpt_oks_sigmas=sigmas)
            rr = np.random.RandomState(5)
            for image_id in (1, 2, 3):
                g = int(rr.randint(2, 5))
                gt = _boxes(rr, g, 120, 90, min_size=34)
                cls = rr.randint(0, 2, g)
                kps = np.concatenate([gt[:, None, :2] + rr.rand(g, k, 2) * (gt[:, None, 2:] - gt[:, None, :2]),
                                      rr.randint(0, 3, (g, k, 1))], 2)
                kps[0, :, 2] = 0  # no labelled keypoint: ignored
                crowd = np.zeros(g, bool)
                crowd[-1] = image_id == 2
                n = int(rr.randint(3, 8))
                pick = rr.randint(0, g, n)
                det = gt[pick] + rr.randn(n, 4).astype(np.float32)
                dkp = np.concatenate([kps[pick, :, :2] + rr.randn(n, k, 2) * 2, rr.rand(n, k, 1)], 2)
                scores = rr.rand(n)
                det_cls = np.where(rr.rand(n) < 0.8, cls[pick], rr.randint(0, 2, n))
                for ev in (ours, ref):
                    ev.process(image_id, det, scores, det_cls, keypoints=dkp)
                    ev.process_gt(image_id, gt, cls, crowd, keypoints=list(kps))
            got, want = ours.evaluate(), ref.evaluate()
            assert set(got) == set(want) == {"bbox", "keypoints"}
            for task in want:
                assert got[task].keys() == want[task].keys()
                for key, v in want[task].items():
                    assert (np.isnan(v) and np.isnan(got[task][key])) or abs(got[task][key] - v) <= 1e-9, (task, key)
            assert 0 < got["keypoints"]["AP"] < 100 and np.isnan(got["keypoints"]["APs"])
    finally:
        MetadataCatalog.remove("port_test_oks")
        JaxMetadataCatalog._registry.pop("port_test_oks", None)


# ---------------- the converters ----------------
def test_neither_packages_d2_loaders_take_the_keypoint_head(tmp_path):
    """A detectron2 Keypoint R-CNN FPN file (d2_fpn) and a C4 one (d2_rcnn)
    with roi_heads.keypoint_head.*: JAX's `convert_d2_fpn_rcnn` makes no
    keypoint head of it, and the port's loaders leave the model's as it was
    (the rest of the FPN file loads)."""
    fpn = init_random_(FPNRCNN(num_classes=1, depth=10, backbone_width=8, res2_out_channels=32, fpn_out_channels=32,
                               fc_dim=16, emb_dim=16, keypoint_on=True, num_keypoints=3, keypoint_conv_dims=(8,)),
                       torch.Generator().manual_seed(0))
    r = np.random.RandomState(1)
    sd = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32)) for k, v in fpn.state_dict().items()}
    assert any(k.startswith("roi_heads.keypoint_head.") for k in sd)
    tree = convert_d2_fpn_rcnn({k: v.numpy() for k, v in sd.items()})
    assert "kp_head" not in tree["roi_heads"] and "box_head_fc1" in tree["roi_heads"]
    before = {k: v.clone() for k, v in fpn.state_dict().items()}
    torch.save({"model": sd}, tmp_path / "kp_fpn.pth")
    assert load_rcnn_weights(fpn, str(tmp_path / "kp_fpn.pth")) == "d2_fpn"
    after = fpn.state_dict()
    loaded = {**sd, "roi_heads.box_head.fc1.weight": fc1_from_chw(sd["roi_heads.box_head.fc1.weight"], 32, 7)}
    for name, value in after.items():
        assert torch.equal(value, before[name] if name.startswith("roi_heads.keypoint_head.") else loaded[name]), name

    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / "COCO-Keypoints" / "keypoint_rcnn_R_50_C4_1x.yaml"))
    cfg.merge_from_list(["TPU.ENABLE_CAPTION_CONSISTENCY", "False", "MODEL.RESNETS.DEPTH", "10",
                         "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", "[8]"])
    c4 = init_random_(build_detector(cfg, device="cpu"), torch.Generator().manual_seed(2))
    sd = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32)) for k, v in c4.state_dict().items()}
    before = {k: v.clone() for k, v in c4.state_dict().items()}
    torch.save({"model": sd}, tmp_path / "kp_c4.pth")
    assert load_rcnn_weights(c4, str(tmp_path / "kp_c4.pth")) == "d2_rcnn"
    after = c4.state_dict()
    assert all(torch.equal(after[n], before[n]) for n in after if n.startswith("roi_heads.keypoint_head."))
    assert not torch.equal(after["roi_heads.box_predictor.cls_score.weight"],
                           before["roi_heads.box_predictor.cls_score.weight"])


# ---------------- the configs ----------------
def _cfg(path, *opts):
    ours, ref = get_cfg(), jax_get_cfg()
    ours.merge_from_file(str(REPO / "configs" / path))
    ref.merge_from_file(str(REPO / "configs" / path))
    ours.merge_from_list(list(opts))
    ref.merge_from_list(list(opts))
    return ours, ref


ACCEPTED = (
    "COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml", "COCO-Keypoints/keypoint_rcnn_R_50_FPN_3x.yaml",
    "COCO-Keypoints/keypoint_rcnn_R_101_FPN_3x.yaml", "COCO-Keypoints/keypoint_rcnn_X_101_32x8d_FPN_3x.yaml",
    "Detectron1-Comparisons/keypoint_rcnn_R_50_FPN_1x.yaml", "quick_schedules/keypoint_rcnn_R_50_FPN_instant_test.yaml",
    "quick_schedules/keypoint_rcnn_training_acc_test.yaml", "quick_schedules/keypoint_rcnn_inference_acc_test.yaml",
    "COCO-Keypoints/keypoint_rcnn_R_50_C4_1x.yaml",
)
# the C4 file leaves TPU.ENABLE_CAPTION_CONSISTENCY at its default, on a tower
# without caption branches (refused as written, as mask_rcnn_R_50_C4_1x is)
C4_OPTS = ("TPU.ENABLE_CAPTION_CONSISTENCY", "False")
C4_FIELDS = ("backbone_type", "num_classes", "pooler_resolution", "keypoint_on", "num_keypoints",
             "keypoint_conv_dims", "keypoint_loss_weight", "keypoint_loss_normalizer")


@pytest.mark.parametrize("path", ACCEPTED, ids=lambda p: Path(p).stem)
def test_keypoint_configs_are_accepted_with_the_jax_builders_fields(path):
    """Accepted at world 1, every field the port's builder gives equal to
    JAX's module's (FPNRCNN, or GeneralizedRCNN's keypoint and head fields),
    and the detector built on the meta device with its keypoint head."""
    c4 = "C4" in path
    ours, ref = _cfg(path, *(C4_OPTS if c4 else ()))
    check_supported(ours, world=1)
    want = jax_build_model(ref)
    assert want.keypoint_on and model_family(ours) == ("c4" if c4 else "fpn")
    if c4:
        config = model_config_from_cfg(ours)
        for name in C4_FIELDS:
            expect = getattr(want, name)
            assert getattr(config, name) == (tuple(expect) if isinstance(expect, (list, tuple)) else expect), name
    else:
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
    head = model.roi_heads.keypoint_head
    spec = ours.MODEL.ROI_KEYPOINT_HEAD
    assert head.num_conv == len(spec.CONV_DIMS) and head.score_lowres.out_channels == spec.NUM_KEYPOINTS


def test_the_c4_keypoint_file_as_written_is_refused_naming_the_caption_gate():
    """keypoint_rcnn_R_50_C4_1x.yaml sets no TPU.ENABLE_CAPTION_CONSISTENCY:
    the plain tower has no caption branches to run (JAX's step cannot trace
    them there either)."""
    ours, _ = _cfg("COCO-Keypoints/keypoint_rcnn_R_50_C4_1x.yaml")
    with pytest.raises(NotImplementedError, match=r"TPU\.ENABLE_CAPTION_CONSISTENCY"):
        check_supported(ours, world=1)


@pytest.mark.parametrize("key, value", [
    ("MODEL.ROI_KEYPOINT_HEAD.NAME", "KRCNNConvDeconvHead"), ("MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE", "ROIPool"),
    ("MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO", 2), ("MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION", 7),
    ("MODEL.ROI_HEADS.NAME", "CascadeROIHeads"),
])
@pytest.mark.parametrize("family", ["fpn", "c4"])
def test_the_keypoint_keys_jax_does_not_compute_with_are_refused(family, key, value):
    """Under MODEL.KEYPOINT_ON: the head's name, pooler type, sampling ratio
    and a resolution other than JAX's (14 on FPN, the box pooler's on C4),
    and the cascade heads (JAX asserts they have no keypoint branch; on C4
    the cascade is its own arch, which has none)."""
    path = ("COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml" if family == "fpn"
            else "COCO-Keypoints/keypoint_rcnn_R_50_C4_1x.yaml")
    ours = _cfg(path, *(C4_OPTS if family == "c4" else ()))[0]
    ours.merge_from_list([key, value if isinstance(value, str) else repr(value)])
    refused = key if key != "MODEL.ROI_HEADS.NAME" else "MODEL.KEYPOINT_ON"
    with pytest.raises(NotImplementedError, match=refused.replace(".", r"\.")):
        check_supported(ours, world=1)
