"""cddmsl_torch ops against cddmsl_tpu on the CPU: box math, anchors,
Box2BoxTransform, the plain RoIAlign (against the XLA form, the gather
oracle and both Pallas kernels in interpret mode), its plain backward
(against `jax.vjp` of the XLA form and of both Pallas rules, and against
torch autograd of the plain forward) and the plain NMS (exactly equal
indices and validity masks). The same numpy inputs go through both
packages; every comparison is in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.ops import anchors as jax_anchors
from cddmsl_tpu.ops import box_regression as jax_b2b
from cddmsl_tpu.ops.nms import batched_nms as jax_batched_nms
from cddmsl_tpu.ops.nms import nms as jax_nms
from cddmsl_tpu.ops.nms import nms_mask as jax_nms_mask
from cddmsl_tpu.ops.roi_align import roi_align as jax_roi_align
from cddmsl_tpu.ops.roi_align import roi_align_gather as jax_roi_align_gather
from cddmsl_tpu.ops.pallas.roi_align_pallas import roi_align_pallas, roi_align_pallas_v2
from cddmsl_tpu.structures import boxes as jax_boxes
from cddmsl_torch.ops import anchors, box_regression, nms, roi_align
from cddmsl_torch.structures import boxes

torch.set_num_threads(1)

ROI_ATOL = 1e-5  # float32 sums of up to 2S x 2S taps of values in [0, 1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _random_boxes(r, n, w=800.0, h=640.0, min_size=2.0, max_size=300.0):
    x1 = r.rand(n) * w
    y1 = r.rand(n) * h
    bw = min_size + r.rand(n) * max_size
    bh = min_size + r.rand(n) * max_size
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


def _equal_within_ulp(got, want, maxulp):
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32), np.asarray(want, np.float32), maxulp=maxulp)


def _within_ulp_of_scale(got, want, n_ulp):
    """|got - want| <= n_ulp float32 ulps of the largest |want|: the two
    frameworks may fuse a multiply-add differently, which moves a result by an
    ulp of its operands, not of a smaller difference of them."""
    want = np.asarray(want, np.float32)
    atol = n_ulp * float(np.spacing(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=atol)


# ---------------- boxes, anchors, Box2BoxTransform ----------------
def test_box_math_matches_jax():
    r = np.random.RandomState(0)
    a = _random_boxes(r, 40)
    b = _random_boxes(r, 30)
    a[3] = [5, 5, 5, 9]  # zero width
    b[:2] = 0  # padded rows: zero union against each other
    a[:1] = 0
    np.testing.assert_array_equal(boxes.area(_t(a)).numpy(), np.asarray(jax_boxes.area(jnp.asarray(a))))
    np.testing.assert_array_equal(boxes.nonempty(_t(a)).numpy(), np.asarray(jax_boxes.nonempty(jnp.asarray(a))))
    shifted = a - 100.0
    np.testing.assert_array_equal(
        boxes.clip(_t(shifted), (600, 700)).numpy(), np.asarray(jax_boxes.clip(jnp.asarray(shifted), (600, 700)))
    )
    np.testing.assert_array_equal(
        boxes.pairwise_intersection(_t(a), _t(b)).numpy(),
        np.asarray(jax_boxes.pairwise_intersection(jnp.asarray(a), jnp.asarray(b))),
    )
    iou = boxes.pairwise_iou(_t(a), _t(b)).numpy()
    _equal_within_ulp(iou, jax_boxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)), 1)
    assert iou[0, 0] == 0.0 and np.all(np.isfinite(iou))


def test_clip_takes_per_image_sizes():
    r = np.random.RandomState(1)
    bx = _random_boxes(r, 12).reshape(2, 6, 4) - 50.0
    hw = np.array([[300, 400], [200, 250]], np.int32)
    got = boxes.clip(_t(bx), (_t(hw)[:, 0, None], _t(hw)[:, 1, None])).numpy()
    for i in range(2):
        want = jax_boxes.clip(jnp.asarray(bx[i]), (jnp.asarray(hw[i, 0]), jnp.asarray(hw[i, 1])))
        np.testing.assert_array_equal(got[i], np.asarray(want))


@pytest.mark.parametrize("offset", [0.0, 0.5])
def test_anchors_match_jax(offset):
    cell = anchors.generate_cell_anchors((32, 64, 128, 256, 512), (0.5, 1.0, 2.0))
    np.testing.assert_array_equal(cell, jax_anchors.generate_cell_anchors((32, 64, 128, 256, 512), (0.5, 1.0, 2.0)))
    got = anchors.anchor_grid(5, 7, 16, cell, offset).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_anchors.anchor_grid(5, 7, 16, cell, offset)))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_box2box_matches_jax(weights):
    r = np.random.RandomState(2)
    src = _random_boxes(r, 64)
    deltas = (r.randn(64, 3 * 4) * 2).astype(np.float32)
    deltas[0, 2] = 50.0  # beyond the log(1000/16) scale clamp
    tgt = _random_boxes(r, 64)
    ours, ref = box_regression.Box2BoxTransform(weights), jax_b2b.Box2BoxTransform(weights)
    _within_ulp_of_scale(
        ours.apply_deltas(_t(deltas), _t(src)).numpy(), ref.apply_deltas(jnp.asarray(deltas), jnp.asarray(src)), 1
    )
    _within_ulp_of_scale(ours.get_deltas(_t(src), _t(tgt)).numpy(), ref.get_deltas(jnp.asarray(src), jnp.asarray(tgt)), 1)


# ---------------- RoIAlign ----------------
@pytest.fixture(scope="module")
def roi_data():
    r = np.random.RandomState(3)
    feat = r.rand(24, 32, 8).astype(np.float32)
    rois = np.concatenate(
        [
            np.array(
                [
                    [0, 0, 320, 320],
                    [56, 35.2, 318.4, 192],
                    [100, 100, 101, 101],  # degenerate: smaller than a bin
                    [-50, -50, 10, 10],  # partly outside the map
                    [600, 450, 700, 500],  # wholly outside the map
                    [30, 40, 30, 40],  # zero size
                ],
                np.float32,
            ),
            _random_boxes(r, 10, w=512, h=384, max_size=200),
        ]
    )
    return feat, rois


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [0, 3])
def test_roi_align_matches_jax_xla_and_gather(roi_data, aligned, sampling_ratio):
    feat, rois = roi_data
    args = ((7, 7), 1 / 16, sampling_ratio, aligned)
    got = roi_align.roi_align(_t(feat), _t(rois), *args, chunk_size=4).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(rois), *args)), atol=ROI_ATOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jax_roi_align_gather(jnp.asarray(feat), jnp.asarray(rois), *args)), atol=ROI_ATOL, rtol=0
    )
    np.testing.assert_allclose(roi_align.roi_align_gather(_t(feat), _t(rois), *args).numpy(), got, atol=ROI_ATOL, rtol=0)


def test_roi_align_matches_pallas_kernels(roi_data):
    """K1 (`_fwd`) and K2 (`_fwd_v2`) in interpret mode; both are aligned."""
    feat, rois = roi_data
    got = roi_align.roi_align(_t(feat), _t(rois), (7, 7), 1 / 16, 0, True).numpy()
    k1 = roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois[:6]), (7, 7), 1 / 16, 0, True)
    np.testing.assert_allclose(got[:6], np.asarray(k1), atol=ROI_ATOL, rtol=0)
    k2 = roi_align_pallas_v2(jnp.asarray(feat), jnp.asarray(rois[:8]), (7, 7), 1 / 16, 0, 4, True)
    np.testing.assert_allclose(got[:8], np.asarray(k2), atol=ROI_ATOL, rtol=0)


def test_roi_align_batched_routes_rois_to_their_image(roi_data):
    feat, rois = roi_data
    r = np.random.RandomState(4)
    feats = np.stack([feat, r.rand(*feat.shape).astype(np.float32), feat[::-1].copy()])
    bidx = r.randint(0, 3, len(rois)).astype(np.int32)
    got = roi_align.roi_align_batched(_t(feats), _t(bidx), _t(rois), (14, 14), 1 / 16, 0, True).numpy()
    for i in range(len(rois)):
        want = jax_roi_align(jnp.asarray(feats[bidx[i]]), jnp.asarray(rois[i : i + 1]), (14, 14), 1 / 16, 0, True)
        np.testing.assert_allclose(got[i : i + 1], np.asarray(want), atol=ROI_ATOL, rtol=0)


# ---------------- RoIAlign backward ----------------
def _cotangent(n, ph, c, seed=9):
    return np.random.RandomState(seed).randn(n, ph, ph, c).astype(np.float32)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [0, 3])
def test_roi_align_backward_matches_jax_grad(roi_data, aligned, sampling_ratio):
    feat, rois = roi_data
    g = _cotangent(len(rois), 7, feat.shape[-1])
    args = ((7, 7), 1 / 16, sampling_ratio, aligned)
    _, vjp = jax.vjp(lambda f: jax_roi_align(f, jnp.asarray(rois), *args), jnp.asarray(feat))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    bidx = torch.zeros(len(rois), dtype=torch.int32)
    got = roi_align.roi_align_backward_plain(_t(g), bidx, _t(rois), (1,) + feat.shape, *args)
    assert got.shape == (1,) + feat.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want, atol=ROI_ATOL, rtol=0)
    assert np.abs(want).max() > 0.1


def test_roi_align_backward_matches_pallas_rules(roi_data):
    """v1's rule (`_bwd_rule`, XLA einsums) and K3 (`_bwd_rule_v2`, the
    Pallas kernel in interpret mode); both are aligned."""
    feat, rois = roi_data
    g = _cotangent(8, 7, feat.shape[-1])
    bidx = torch.zeros(8, dtype=torch.int32)
    got = roi_align.roi_align_backward_plain(_t(g), bidx, _t(rois[:8]), (1,) + feat.shape, (7, 7), 1 / 16, 0, True)[0]
    for fwd in (
        lambda f: roi_align_pallas(f, jnp.asarray(rois[:8]), (7, 7), 1 / 16, 0, True),
        lambda f: roi_align_pallas_v2(f, jnp.asarray(rois[:8]), (7, 7), 1 / 16, 0, 4, True),
    ):
        _, vjp = jax.vjp(fwd, jnp.asarray(feat))
        np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=ROI_ATOL, rtol=0)


def test_roi_align_batched_gradient_is_the_plain_autograd(roi_data):
    """`roi_align_batched`'s gradient (RoIAlignFunction, K3's plain version
    on the CPU) equals torch autograd through the plain forward, per image;
    the boxes get none."""
    feat, rois = roi_data
    r = np.random.RandomState(10)
    feats = np.stack([feat, r.rand(*feat.shape).astype(np.float32)])
    bidx = _t(r.randint(0, 2, len(rois)).astype(np.int32))
    g = _t(_cotangent(len(rois), 14, feat.shape[-1], seed=11))
    boxes = _t(rois).requires_grad_(False)
    grads = []
    for fn in (roi_align.roi_align_batched, roi_align.roi_align_batched_plain):
        f = _t(feats).requires_grad_(True)
        out = fn(f, bidx, boxes, (14, 14), 1 / 16, 0, True)
        (grad,) = torch.autograd.grad((out * g).sum(), f)
        grads.append(grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=ROI_ATOL, rtol=0)
    assert grads[0].is_contiguous() and np.abs(grads[0][1].numpy()).max() > 0


# ---------------- NMS ----------------
def _near_threshold_cluster(r, thr, n_groups=12):
    """Pairs of boxes whose IoU sits 1e-3 above or below `thr` (a base box
    and a copy widened so that iou = base_area / widened_area), plus pairs
    whose float32 IoU equals float32(thr) exactly (7 / 10 for thr 0.7):
    those must not suppress each other, as the test is `iou > thr`."""
    out = []
    for g in range(n_groups):
        x, y = r.rand() * 600, r.rand() * 400
        w, h = 40.0 + r.rand() * 60, 40.0 + r.rand() * 60
        target = thr + (1e-3 if g % 2 else -1e-3)
        out.append([x, y, x + w, y + h])
        out.append([x, y, x + w / target, y + h])
    assert thr == 0.7
    for x in (700.0, 720.0):
        out += [[x, 500.0, x + 7.0, 501.0], [x, 500.0, x + 10.0, 501.0]]
    return np.asarray(out, np.float32)


def _nms_case(kind):
    r = np.random.RandomState({"random": 5, "ties": 6, "cluster": 7}[kind])
    if kind == "cluster":
        bx = _near_threshold_cluster(r, 0.7)
        sc = r.rand(len(bx)).astype(np.float32)
    else:
        bx = _random_boxes(r, 300)
        sc = r.rand(300).astype(np.float32)
        if kind == "ties":
            sc = np.round(sc * 8) / 8  # heavy ties: order must go to the lower index
            bx[50:60] = bx[40]  # duplicates with tied scores
            sc[50:60] = sc[40]
    valid = r.rand(len(bx)) > 0.15  # padded rows
    return bx, sc, valid


@pytest.mark.parametrize("kind", ["random", "ties", "cluster"])
@pytest.mark.parametrize("max_out", [24, 400])  # kept-buffer branch, max_out >= n branch
def test_nms_equals_jax(kind, max_out):
    bx, sc, valid = _nms_case(kind)
    thr = 0.7
    want_idx, want_valid = jax_nms(jnp.asarray(bx), jnp.asarray(sc), thr, max_out, valid=jnp.asarray(valid))
    idx, out_valid = nms.nms_plain(_t(bx), _t(sc), thr, max_out, valid=_t(valid))
    np.testing.assert_array_equal(out_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert 0 < int(out_valid.sum()) and not np.any(np.asarray(valid)[idx.numpy()[out_valid.numpy()]] == 0)


@pytest.mark.parametrize("max_out", [2, 4, 6])  # kept-buffer branch; max_out >= n, where -inf rows drop out
def test_nms_drops_kept_rows_scored_minus_inf_as_jax_does(max_out):
    bx = np.asarray([[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50], [60, 60, 70, 70]], np.float32)
    sc = np.asarray([0.9, -np.inf, 0.5, -np.inf], np.float32)
    valid = np.asarray([True, True, True, False])
    want_idx, want_valid = jax_nms(jnp.asarray(bx), jnp.asarray(sc), 0.5, max_out, valid=jnp.asarray(valid))
    idx, out_valid = nms.nms_plain(_t(bx), _t(sc), 0.5, max_out, valid=_t(valid))
    np.testing.assert_array_equal(out_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert idx.tolist()[:2] == [0, 2] and out_valid.tolist()[:2] == [True, True]


def test_nms_mask_equals_jax():
    bx, sc, valid = _nms_case("ties")
    want = jax_nms_mask(jnp.asarray(bx), jnp.asarray(sc), 0.5, valid=jnp.asarray(valid))
    np.testing.assert_array_equal(nms.nms_mask(_t(bx), _t(sc), 0.5, valid=_t(valid)).numpy(), np.asarray(want))


def test_batched_nms_equals_jax():
    r = np.random.RandomState(8)
    bx = _random_boxes(r, 256, w=300, h=200, max_size=120)
    sc = r.rand(256).astype(np.float32)
    cls = r.randint(0, 5, 256).astype(np.int32)
    valid = sc > 0.2
    want_idx, want_valid = jax_batched_nms(
        jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(cls), 0.5, 40, valid=jnp.asarray(valid)
    )
    idx, out_valid = nms.batched_nms(_t(bx), _t(sc), _t(cls), 0.5, 40, valid=_t(valid))
    np.testing.assert_array_equal(out_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))

    # the batched form gives each image its own shift and its own result
    bx2, sc2, cls2, v2 = (np.stack([a, a[::-1]]) for a in (bx, sc, cls, valid))
    bidx, bvalid = nms.batched_nms(_t(bx2), _t(sc2), _t(cls2), 0.5, 40, valid=_t(v2))
    np.testing.assert_array_equal(bidx[0].numpy(), idx.numpy())
    np.testing.assert_array_equal(bvalid[0].numpy(), out_valid.numpy())
    flip, fvalid = nms.batched_nms(_t(bx[::-1].copy()), _t(sc[::-1].copy()), _t(cls[::-1].copy()), 0.5, 40, valid=_t(valid[::-1].copy()))
    np.testing.assert_array_equal(bidx[1].numpy(), flip.numpy())
    np.testing.assert_array_equal(bvalid[1].numpy(), fvalid.numpy())
