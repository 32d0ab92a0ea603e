"""The port's hand-written kernels on an NVIDIA GPU against their plain
PyTorch versions, at small shapes: K1 (RoIAlign forward), K3 (its backward,
and autograd through `roi_align_batched`) and K4 (NMS).

Every test is marked `cuda` (registered in tests/conftest.py) and skips
without a card. The card's machine has no JAX, so run them there without
the JAX package's conftest, registering the marker on the command line:

    python -m pytest --noconftest -p no:cacheprovider -o "markers=cuda: needs an NVIDIA GPU" \
        tests/test_torch_port_cuda.py -q

Tolerances: K1 in float32 (TF32 off) within 1e-4 absolute on values of
order 1; K3 in float32 within 1e-4 of the largest |dF| (its sums run in
another order than the plain version's); bfloat16 against the plain version
run in float32 on the same bfloat16 inputs, rtol 2e-2 (the kernels round
once, the plain forward rounds its first contraction); K3 against itself
bit for bit; K4 exactly, at the edges of its 64-row blocks (N of 1, 63, 64,
65; max_out reached inside a block and above N), at a threshold of 0, on
boxes off 16-byte alignment, with no valid row, with tied duplicates, over
a batch of images, class-shifted, and with scores of -inf where max_out
covers N. The panoptic and semantic models', RetinaNet's and the GN and
SyncBN Mask R-CNNs' steps on the card against the CPU at depth 10 (each
test says its tolerances), and K4 on RetinaNet's merged candidates.
"""

import pytest
import torch

from cddmsl_torch.ops import nms as nms_ops
from cddmsl_torch.ops import roi_align as roi_ops

pytestmark = pytest.mark.cuda

SHAPE = (2, 12, 16, 64)  # B, H, W, C
ARGS = ((7, 7), 1 / 16, 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _rois(dev, n=48):
    g = torch.Generator(device=dev).manual_seed(0)
    xy = torch.rand((n, 2), generator=g, device=dev) * torch.tensor([256.0, 192.0], device=dev) - 16
    wh = 2 + torch.rand((n, 2), generator=g, device=dev) * 120
    boxes = torch.cat([xy, xy + wh], 1)
    boxes[:8] = torch.tensor([40.0, 30.0, 120.0, 90.0], device=dev)  # the same pixels many times
    bidx = torch.randint(0, SHAPE[0], (n,), generator=g, device=dev, dtype=torch.int32)
    return bidx, boxes.contiguous()


@pytest.mark.parametrize("aligned", [True, False])
def test_k1_and_k3_match_plain_fp32(dev, aligned):
    bidx, boxes = _rois(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn(SHAPE, generator=g, device=dev)
    out = roi_ops.roi_align_forward(feats, bidx, boxes, *ARGS, aligned)
    want = roi_ops.roi_align_batched_plain(feats, bidx, boxes, *ARGS, aligned)
    assert (out - want).abs().max() <= 1e-4 * want.abs().max()
    grad = torch.randn(out.shape, generator=g, device=dev)
    df = roi_ops.roi_align_backward(grad, bidx, boxes, SHAPE, *ARGS, aligned)
    want_df = roi_ops.roi_align_backward_plain(grad, bidx, boxes, SHAPE, *ARGS, aligned)
    assert df.shape == SHAPE and df.is_contiguous()
    assert (df - want_df).abs().max() <= 1e-4 * want_df.abs().max()


def test_k1_and_k3_match_plain_bf16(dev):
    bidx, boxes = _rois(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    feats = torch.rand(SHAPE, generator=g, device=dev).bfloat16()
    out = roi_ops.roi_align_forward(feats, bidx, boxes, *ARGS, True)
    want = roi_ops.roi_align_batched_plain(feats.float(), bidx, boxes, *ARGS, True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=0)
    grad = torch.rand(out.shape, generator=g, device=dev).bfloat16()
    df = roi_ops.roi_align_backward(grad, bidx, boxes, SHAPE, *ARGS, True)
    want_df = roi_ops.roi_align_backward_plain(grad.float(), bidx, boxes, SHAPE, *ARGS, True)
    assert df.dtype == torch.bfloat16
    torch.testing.assert_close(df.float(), want_df, rtol=2e-2, atol=0)


def test_roi_align_batched_gradient_goes_through_k3(dev):
    bidx, boxes = _rois(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    feats = torch.randn(SHAPE, generator=g, device=dev)
    cot = torch.randn((len(boxes),) + ARGS[0] + (SHAPE[-1],), generator=g, device=dev)
    roi_ops.KERNEL.reset_launches()
    grads = []
    for fn in (roi_ops.roi_align_batched, roi_ops.roi_align_batched_plain):
        f = feats.clone().requires_grad_(True)
        b = boxes.clone().requires_grad_(True)
        (grad,) = torch.autograd.grad((fn(f, bidx, b, *ARGS, True) * cot).sum(), f)
        grads.append(grad)
    assert roi_ops.KERNEL.launches == {"cddmsl_roi_align_fwd": 1, "cddmsl_roi_align_bwd": 1}
    assert (grads[0] - grads[1]).abs().max() <= 1e-4 * grads[1].abs().max()


def _box_set(kind, dev, shape):
    """ROIs that stress the kernels' designs, in image coordinates at 1/16."""
    _, H, W, _ = shape
    g = torch.Generator(device=dev).manual_seed(7)
    full = torch.tensor([0.0, 0.0, 16.0 * W, 16.0 * H], device=dev)
    if kind == "whole_map":  # every tile and every column of the map
        boxes = full + torch.tensor([[-40.0, -40.0, 40.0, 40.0], [0.0, 0.0, 0.0, 0.0], [8.0, 8.0, -8.0, -8.0]],
                                    device=dev).repeat(4, 1)
    elif kind == "sub_pixel":  # many bins on one map pixel, on and off the grid lines
        xy = torch.rand((40, 2), generator=g, device=dev) * torch.tensor([16.0 * W, 16.0 * H], device=dev)
        boxes = torch.cat([xy, xy + torch.rand((40, 2), generator=g, device=dev) * 12], 1)
        boxes[:4] = torch.tensor([[32.0, 32.0, 40.0, 40.0], [0.0, 0.0, 0.5, 0.5], [16.0 * W - 1, 16.0 * H - 1,
                                 16.0 * W, 16.0 * H], [100.0, 60.0, 100.0, 60.0]], device=dev)
    elif kind == "same_pixels":  # 240 ROIs on almost the same pixels
        boxes = torch.tensor([60.0, 40.0, 150.0, 130.0], device=dev) + torch.rand(
            (240, 4), generator=g, device=dev) * 3
    else:
        raise ValueError(kind)
    bidx = torch.randint(0, shape[0], (len(boxes),), generator=g, device=dev, dtype=torch.int32)
    return bidx, boxes.contiguous()


RAGGED = (2, 13, 21, 72)  # H and W not multiples of the 8 x 8 tile, C not a multiple of the channel tile


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [0, 3])
@pytest.mark.parametrize("kind", ["whole_map", "sub_pixel", "same_pixels"])
def test_k1_and_k3_on_hard_rois(dev, kind, sampling_ratio, aligned, dtype):
    bidx, boxes = _box_set(kind, dev, RAGGED)
    g = torch.Generator(device=dev).manual_seed(5)
    args = ((14, 14), 1 / 16, sampling_ratio, aligned)
    rand = torch.rand if dtype == torch.bfloat16 else torch.randn
    feats = rand(RAGGED, generator=g, device=dev).to(dtype)
    grad = rand((len(boxes), 14, 14, RAGGED[-1]), generator=g, device=dev).to(dtype)
    out = roi_ops.roi_align_forward(feats, bidx, boxes, *args)
    want = roi_ops.roi_align_batched_plain(feats.float(), bidx, boxes, *args)
    df = roi_ops.roi_align_backward(grad, bidx, boxes, RAGGED, *args)
    want_df = roi_ops.roi_align_backward_plain(grad.float(), bidx, boxes, RAGGED, *args)
    assert out.dtype == dtype and df.dtype == dtype and df.shape == RAGGED
    if dtype == torch.float32:
        assert (out - want).abs().max() <= 1e-4
        assert (df - want_df).abs().max() <= 1e-4 * want_df.abs().max()
    else:
        torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=0)
        torch.testing.assert_close(df.float(), want_df, rtol=2e-2, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_is_the_same_bit_for_bit_on_every_call(dev, dtype):
    bidx, boxes = _box_set("same_pixels", dev, RAGGED)
    extra_bidx, extra = _rois(dev)
    bidx, boxes = torch.cat([bidx, extra_bidx]), torch.cat([boxes, extra]).contiguous()
    g = torch.Generator(device=dev).manual_seed(6)
    grad = torch.randn((len(boxes), 14, 14, RAGGED[-1]), generator=g, device=dev).to(dtype)
    first = roi_ops.roi_align_backward(grad, bidx, boxes, RAGGED, (14, 14), 1 / 16, 0, True)
    for _ in range(3):
        assert torch.equal(roi_ops.roi_align_backward(grad, bidx, boxes, RAGGED, (14, 14), 1 / 16, 0, True), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_roi_or_none_in_the_batch_gives_zeros(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(8)
    feats = torch.randn(RAGGED, generator=g, device=dev).to(dtype)
    empty = torch.zeros((0, 4), device=dev)
    df = roi_ops.roi_align_backward(torch.zeros((0, 7, 7, RAGGED[-1]), dtype=dtype, device=dev),
                                    torch.zeros(0, dtype=torch.int32, device=dev), empty, RAGGED, *ARGS, True)
    assert df.shape == RAGGED and not df.any()
    assert roi_ops.roi_align_forward(feats, torch.zeros(0, dtype=torch.int32, device=dev), empty, *ARGS).shape == (
        0, 7, 7, RAGGED[-1])
    _, boxes = _rois(dev, 16)
    outside = torch.tensor([-1, RAGGED[0]] * 8, dtype=torch.int32, device=dev)
    assert not roi_ops.roi_align_forward(feats, outside, boxes, *ARGS).any()
    grad = torch.randn((16, 7, 7, RAGGED[-1]), generator=g, device=dev).to(dtype)
    assert not roi_ops.roi_align_backward(grad, outside, boxes, RAGGED, *ARGS, True).any()


@pytest.mark.parametrize("aligned", [True, False])
def test_non_finite_boxes_pool_zeros_and_get_no_gradient(dev, aligned):
    bidx, boxes = _rois(dev, 24)
    nan, inf = float("nan"), float("inf")
    boxes[:4] = torch.tensor([[nan, 10.0, 50.0, 60.0], [10.0, 10.0, 50.0, nan], [-inf, 0.0, inf, 40.0],
                              [0.0, 0.0, 60.0, inf]], device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    feats = torch.randn(SHAPE, generator=g, device=dev)
    out = roi_ops.roi_align_forward(feats, bidx, boxes, *ARGS, aligned)
    assert not out[:4].any()
    want_out = roi_ops.roi_align_batched_plain(feats, bidx[4:], boxes[4:], *ARGS, aligned)
    assert (out[4:] - want_out).abs().max() <= 1e-4
    grad = torch.randn(out.shape, generator=g, device=dev)
    df = roi_ops.roi_align_backward(grad, bidx, boxes, SHAPE, *ARGS, aligned)
    want = roi_ops.roi_align_backward_plain(grad[4:], bidx[4:], boxes[4:], SHAPE, *ARGS, aligned)
    assert (df - want).abs().max() <= 1e-4 * want.abs().max()


def test_wrapper_refuses_channels_the_kernels_cannot_vectorize(dev):
    bidx, boxes = _rois(dev, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        roi_ops.roi_align_forward(torch.zeros((2, 12, 16, 12), device=dev), bidx, boxes, *ARGS, True)


def nms_case(b, n, seed, span=(1344.0, 800.0), size=400.0, p_valid=0.9):
    """B images of n random boxes, scores and validity, made on the CPU so
    that the same case can be read there."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((b, n, 2), generator=g) * torch.tensor(span)
    boxes = torch.cat([xy, xy + 4 + torch.rand((b, n, 2), generator=g) * size], -1)
    return boxes, torch.rand((b, n), generator=g), torch.rand((b, n), generator=g) < p_valid


def assert_k4_equals_plain(boxes, scores, valid, thr, max_out):
    idx, keep = nms_ops.nms(boxes, scores, thr, max_out, valid=valid)
    assert idx.dtype == torch.int64 and keep.dtype == torch.bool and idx.shape == (boxes.shape[0], max_out)
    for i in range(boxes.shape[0]):
        want_idx, want_keep = nms_ops.nms_plain(boxes[i], scores[i], thr, max_out, valid=valid[i])
        assert torch.equal(idx[i], want_idx) and torch.equal(keep[i], want_keep), i
    return idx, keep


# at a threshold of 0 the test always divides: any overlap suppresses
@pytest.mark.parametrize("thr, max_out", [(0.7, 300), (0.5, 40), (0.0, 300)])
def test_k4_equals_plain(dev, thr, max_out):
    boxes, scores, valid = (t.to(dev) for t in nms_case(2, 1500, 4, span=(600.0, 600.0), size=150.0))
    assert_k4_equals_plain(boxes, scores, valid, thr, max_out)


# max_out is reached inside a 64-row block: the walk stops at that row, not at the block's end
@pytest.mark.parametrize("n, max_out, size", [(1, 1, 400.0), (63, 20, 400.0), (65, 37, 400.0),
                                              (12000, 2000, 400.0), (5000, 700, 120.0)])
def test_k4_stops_where_max_out_is_reached(dev, n, max_out, size):
    boxes, scores, valid = (t.to(dev) for t in nms_case(1, n, n, size=size, p_valid=1.0))
    _, keep = assert_k4_equals_plain(boxes, scores, valid, 0.7, max_out)
    assert int(keep.sum()) == max_out


# heavy suppression: the walk reads rows far past the first 5/4 max_out
@pytest.mark.parametrize("max_out", [150, 1000])
def test_k4_with_heavy_suppression(dev, max_out):
    boxes, scores, valid = (t.to(dev) for t in nms_case(1, 3000, 21, span=(300.0, 200.0), size=150.0))
    idx, keep = assert_k4_equals_plain(boxes, scores, valid, 0.3, max_out)
    rank = torch.empty(3000, dtype=torch.int64, device=dev)
    rank[nms_ops._score_order(scores[0], valid[0]).indices] = torch.arange(3000, device=dev)
    assert int(rank[idx[0][keep[0]]].max()) >= 5 * max_out // 4 + 64


@pytest.mark.parametrize("n", [1, 63, 64, 65, 130])
def test_k4_with_max_out_above_n(dev, n):
    boxes, scores, valid = (t.to(dev) for t in nms_case(2, n, 10 + n, span=(200.0, 150.0), size=120.0))
    _, keep = assert_k4_equals_plain(boxes, scores, valid, 0.5, n + 70)
    assert not keep[:, n:].any()


def test_k4_reads_boxes_from_a_view_off_16_byte_alignment(dev):
    boxes, scores, valid = (t.to(dev) for t in nms_case(1, 700, 9, size=300.0))
    flat = torch.empty(700 * 4 + 1, device=dev)
    flat[1:] = boxes.reshape(-1)
    view = flat[1:].view(1, 700, 4)  # contiguous, 4 bytes past an aligned address
    assert view.is_contiguous() and view.data_ptr() % 16
    assert_k4_equals_plain(view, scores, valid, 0.7, 200)


def test_k4_with_no_valid_row(dev):
    boxes, scores, _ = (t.to(dev) for t in nms_case(2, 200, 3))
    idx, keep = nms_ops.nms(boxes, scores, 0.7, 50, valid=torch.zeros_like(scores, dtype=torch.bool))
    assert not keep.any() and not idx.any()


def test_k4_duplicates_with_tied_scores_keep_the_lower_index(dev):
    boxes, scores, valid = nms_case(1, 300, 4, span=(300.0, 200.0), size=150.0)
    boxes[0, 40:80] = boxes[0, 7]  # 41 identical boxes across a block edge
    scores = torch.round(scores * 8) / 8
    scores[0, 40:80] = scores[0, 7]
    valid[0, 7] = False  # the first of them is padding: the next index must win
    boxes, scores, valid = boxes.to(dev), scores.to(dev), valid.to(dev)
    for thr, max_out in ((0.7, 100), (0.5, 400)):
        idx, keep = assert_k4_equals_plain(boxes, scores, valid, thr, max_out)
        assert int(((idx[0] >= 40) & (idx[0] < 80) & keep[0]).sum()) == 1


def test_k4_batch_of_images_with_different_validity(dev):
    boxes, scores, valid = nms_case(3, 1000, 5)
    valid[0] = True
    valid[1] = torch.arange(1000) % 3 != 0
    valid[2, 100:] = False
    boxes, scores, valid = boxes.to(dev), scores.to(dev), valid.to(dev)
    idx, keep = assert_k4_equals_plain(boxes, scores, valid, 0.7, 300)
    assert int(keep[2].sum()) <= 100 and valid[1][idx[1][keep[1]]].all()


def test_k4_gives_the_same_result_on_a_second_call(dev):
    boxes, scores, valid = (t.to(dev) for t in nms_case(2, 6000, 6, size=300.0))
    first = nms_ops.nms(boxes, scores, 0.7, 1000, valid=valid)
    for _ in range(2):
        again = nms_ops.nms(boxes, scores, 0.7, 1000, valid=valid)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


def test_k4_class_shifted_boxes(dev):
    boxes, scores, valid = nms_case(2, 2048, 7, span=(800.0, 640.0), size=200.0)
    cls = torch.randint(0, 20, (2, 2048), generator=torch.Generator().manual_seed(7))
    boxes, scores, valid, cls = boxes.to(dev), scores.to(dev), valid.to(dev), cls.to(dev)
    idx, keep = nms_ops.batched_nms(boxes, scores, cls, 0.5, 100, valid=valid)
    for i in range(2):
        want = nms_ops.batched_nms(boxes[i].cpu(), scores[i].cpu(), cls[i].cpu(), 0.5, 100, valid=valid[i].cpu())
        assert torch.equal(idx[i].cpu(), want[0]) and torch.equal(keep[i].cpu(), want[1])


@pytest.mark.parametrize("max_out", [2, 4, 6, 300])
def test_k4_drops_kept_rows_scored_minus_inf_when_max_out_covers_n(dev, max_out):
    boxes, scores, valid = nms_case(1, 200, 8, span=(300.0, 200.0), size=150.0)
    boxes[0, :4] = torch.tensor([[0.0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50], [60, 60, 70, 70]]) + 1000
    scores[0, :4] = torch.tensor([2.0, float("-inf"), 1.5, float("-inf")])
    scores[0, 100:130] = float("-inf")
    valid[0, :4] = torch.tensor([True, True, True, False])
    n = 4 if max_out <= 6 else 200
    idx, keep = assert_k4_equals_plain(boxes[:, :n].to(dev), scores[:, :n].to(dev), valid[:, :n].to(dev), 0.5, max_out)
    assert torch.isfinite(scores[0, idx[0][keep[0]].cpu()]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_rows_pool_zeros_and_pass_no_gradient(dev, dtype):
    """The FPN pooler's masking: K1 pools zeros for a row with NaN
    coordinates, as the plain version does, and K3 on the rows with the NaN
    ones among them gives, bit for bit, K3 on the finite rows alone."""
    bidx, boxes = _rois(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    feats = torch.randn(SHAPE, generator=g, device=dev).to(dtype)
    masked = boxes.clone()
    masked[::3] = float("nan")
    keep = torch.isfinite(masked).all(1)
    out = roi_ops.roi_align_forward(feats, bidx, masked, *ARGS, True)
    plain = roi_ops.roi_align_batched_plain(feats.float(), bidx, masked, *ARGS, True)
    assert not out[~keep].any() and not plain[~keep].any()
    torch.testing.assert_close(out[keep].float(), plain[keep], rtol=2e-2 if dtype == torch.bfloat16 else 0,
                               atol=0 if dtype == torch.bfloat16 else 1e-4)
    grad = torch.randn((boxes.shape[0], 7, 7, SHAPE[3]), generator=g, device=dev).to(dtype)
    with_nan = roi_ops.roi_align_backward(grad, bidx, masked, SHAPE, *ARGS, True)
    finite = roi_ops.roi_align_backward(grad[keep].contiguous(), bidx[keep].contiguous(), boxes[keep].contiguous(),
                                        SHAPE, *ARGS, True)
    assert torch.equal(with_nan, finite)


def test_the_fpn_pooler_on_the_card_equals_the_plain_pooler(dev):
    """`ROIPooler` over four levels (one K1 launch a level, NaN-masked rows,
    then K3 a level in the backward) against the same pooler on the CPU's
    plain versions: values within 1e-4 and each level's gradient within
    1e-4 of its largest value, in float32."""
    from cddmsl_torch.models.poolers import ROIPooler

    g = torch.Generator().manual_seed(3)
    feats = [torch.randn((2, 112 // s, 176 // s, 16), generator=g) for s in (4, 8, 16, 32)]
    xy = torch.rand((2, 30, 2), generator=g) * torch.tensor([150.0, 90.0])
    boxes = torch.cat([xy, xy + 4 + torch.rand((2, 30, 2), generator=g) * 300], -1)
    cot = torch.randn((60, 7, 7, 16), generator=g)
    pooler = ROIPooler(7, (1 / 4, 1 / 8, 1 / 16, 1 / 32))
    runs = []
    for device in ("cpu", dev):
        fs = [f.detach().clone().to(device).requires_grad_(True) for f in feats]
        out = pooler(fs, boxes.to(device))
        out.backward(cot.to(device))
        runs.append((out.detach().cpu(), [f.grad.cpu() for f in fs]))
    (want, want_grads), (got, got_grads) = runs
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    for g_, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g_, w, rtol=0, atol=1e-4 * float(w.abs().max()))


def test_the_mask_pooler_and_head_on_the_card_equal_the_cpu(dev):
    """The FPN mask branch: a 14x14 `ROIPooler` over four levels (K1 a
    level, K3 a level in the backward) into the mask head (4 convs, the
    deconv, the predictor) and `mask_rcnn_loss` on seeded targets, on the
    card against the same on the CPU's plain versions, in float32: the
    logits within 1e-4 of their largest value, the loss within 1e-5
    relative, each level's gradient within 1e-4 of its largest value."""
    from cddmsl_torch.models.mask_head import MaskRCNNConvUpsampleHead, mask_rcnn_loss
    from cddmsl_torch.models.poolers import ROIPooler

    g = torch.Generator().manual_seed(4)
    feats = [torch.randn((2, 112 // s, 176 // s, 16), generator=g) for s in (4, 8, 16, 32)]
    xy = torch.rand((2, 12, 2), generator=g) * torch.tensor([150.0, 90.0])
    boxes = torch.cat([xy, xy + 4 + torch.rand((2, 12, 2), generator=g) * 300], -1)
    head = MaskRCNNConvUpsampleHead(16, 5, num_conv=4, conv_dim=16)
    targets = (torch.rand((24, 28, 28), generator=g) > 0.5).float()
    classes = torch.randint(0, 5, (24,), generator=g)
    fg = torch.rand((24,), generator=g) > 0.3
    pooler = ROIPooler(14, (1 / 4, 1 / 8, 1 / 16, 1 / 32))
    runs = []
    for device in ("cpu", dev):
        h = head.to(device)
        fs = [f.detach().clone().to(device).requires_grad_(True) for f in feats]
        logits = h(pooler(fs, boxes.to(device)))
        loss = mask_rcnn_loss(logits, targets.to(device), classes.to(device), fg.to(device))
        loss.backward()
        runs.append((logits.detach().cpu(), loss.item(), [f.grad.cpu() for f in fs]))
    (want, want_loss, want_grads), (got, got_loss, got_grads) = runs
    assert got.shape == (24, 28, 28, 5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    for g_, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g_, w, rtol=0, atol=1e-4 * float(w.abs().max()))


def test_the_keypoint_pooler_head_and_decode_on_the_card_equal_the_cpu(dev):
    """The FPN keypoint branch: a 14x14 `ROIPooler` over four levels (K1 a
    level, K3 a level in the backward) into the keypoint head (2 convs, the
    4x4 deconv, the 2x upsample), `keypoint_rcnn_loss` on seeded targets and
    the heatmaps' decode, on the card against the same on the CPU's plain
    versions, in float32: the logits within 1e-4 of their largest value,
    the loss within 1e-5 relative, each level's gradient within 1e-4 of its
    largest value, the decoded (x, y) within 1e-2 px where the coarse bin
    is the same (a logit within 1e-4 of another may win on either device)."""
    from cddmsl_torch.models.keypoint_head import (KRCNNConvDeconvUpsampleHead, decode_keypoint_heatmaps,
                                                   keypoint_rcnn_loss)
    from cddmsl_torch.models.poolers import ROIPooler

    g = torch.Generator().manual_seed(5)
    feats = [torch.randn((2, 112 // s, 176 // s, 16), generator=g) for s in (4, 8, 16, 32)]
    xy = torch.rand((2, 12, 2), generator=g) * torch.tensor([150.0, 90.0])
    boxes = torch.cat([xy, xy + 4 + torch.rand((2, 12, 2), generator=g) * 300], -1)
    head = KRCNNConvDeconvUpsampleHead(16, 4, conv_dims=(16, 16))
    pos = torch.randint(0, 56 * 56, (24, 4), generator=g)
    vis = torch.rand((24, 4), generator=g) > 0.3
    pooler = ROIPooler(14, (1 / 4, 1 / 8, 1 / 16, 1 / 32))
    runs = []
    for device in ("cpu", dev):
        h = head.to(device)
        fs = [f.detach().clone().to(device).requires_grad_(True) for f in feats]
        logits = h(pooler(fs, boxes.to(device)))
        loss = keypoint_rcnn_loss(logits, pos.to(device), vis.to(device))
        loss.backward()
        kps = decode_keypoint_heatmaps(logits.detach(), boxes.to(device))
        runs.append((logits.detach().cpu(), loss.item(), [f.grad.cpu() for f in fs], kps.cpu()))
    (want, want_loss, want_grads, want_kps), (got, got_loss, got_grads, got_kps) = runs
    assert got.shape == (24, 56, 56, 4) and got_kps.shape == (2, 12, 4, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    for g_, w in zip(got_grads, want_grads):
        torch.testing.assert_close(g_, w, rtol=0, atol=1e-4 * float(w.abs().max()))
    same_bin = (got.reshape(24, -1, 4).argmax(1) == want.reshape(24, -1, 4).argmax(1)).reshape(2, 12, 4)
    assert same_bin.float().mean() > 0.9
    torch.testing.assert_close(got_kps[..., :2][same_bin], want_kps[..., :2][same_bin], rtol=0, atol=1e-2)


def test_the_cascade_heads_on_the_card_equal_the_cpu(dev):
    """`CascadeROIHeads` on four levels (three stages' 7x7 pools, K1 and K3
    a level each, the mask branch's 14x14 pool) in training with a
    site-seeded draw, and at inference (the stages' mean softmax, the
    detection NMS, K4), on the card against the CPU's plain versions, in
    float32: the eight losses within 1e-4 relative, each level's gradient
    within 1e-4 of its largest value, the detections' boxes within 1e-3 px
    and scores within 1e-5, classes and validity equal."""
    import zlib

    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.models.cascade_rcnn import CascadeROIHeads
    from cddmsl_torch.models.rpn import Proposals

    def draw(site, shape):
        return torch.rand(shape, generator=torch.Generator().manual_seed(zlib.crc32(site.encode())))

    g = torch.Generator().manual_seed(6)
    feats = [torch.randn((2, 112 // s, 176 // s, 16), generator=g) for s in (4, 8, 16, 32)]
    xy = torch.rand((2, 40, 2), generator=g) * torch.tensor([150.0, 90.0])
    prop = torch.cat([xy, xy + 8 + torch.rand((2, 40, 2), generator=g) * 60], -1)
    gt = prop[:, :3] + torch.rand((2, 3, 4), generator=g) * 4
    sizes = torch.tensor([[112, 176], [96, 160]])
    canvas = (torch.rand((2, 3, 28, 44), generator=g) > 0.5).to(torch.uint8)
    heads = init_random_(CascadeROIHeads(num_classes=5, in_channels=16, pooler_scales=(1 / 4, 1 / 8, 1 / 16, 1 / 32),
                                         batch_size_per_image=16, fc_dim=32,
                                         mask_head=dict(num_conv=1, conv_dim=8, canvas_stride=4.0)),
                         torch.Generator().manual_seed(7))
    runs = []
    for device in ("cpu", dev):
        h = heads.to(device)
        fs = [f.detach().clone().to(device).requires_grad_(True) for f in feats]
        proposals = Proposals(prop.to(device), torch.zeros((2, 40), device=device),
                              torch.ones((2, 40), dtype=torch.bool, device=device))
        with torch.enable_grad():
            losses = h(fs, proposals, sizes.to(device), training=True, gt_boxes=gt.to(device),
                       gt_classes=torch.tensor([[0, 1, 2], [3, 4, 0]], device=device),
                       gt_valid=torch.ones((2, 3), dtype=torch.bool, device=device),
                       draw=lambda s, shape: draw(s, shape).to(device), gt_masks=canvas.to(device))
            sum(losses.values()).backward()
        with torch.no_grad():
            det = h([f.detach() for f in fs], proposals, sizes.to(device))
        runs.append(({k: v.item() for k, v in losses.items()}, [f.grad.cpu() for f in fs],
                     [t.cpu() for t in (det.boxes, det.scores, det.classes, det.valid)]))
    (want_l, want_g, want_d), (got_l, got_g, got_d) = runs
    assert len(got_l) == 7 and all(abs(got_l[k] - want_l[k]) <= 1e-4 * abs(want_l[k]) + 1e-7 for k in want_l)
    for g_, w in zip(got_g, want_g):
        torch.testing.assert_close(g_, w, rtol=0, atol=1e-4 * float(w.abs().max()))
    assert torch.equal(got_d[2], want_d[2]) and torch.equal(got_d[3], want_d[3])
    torch.testing.assert_close(got_d[0], want_d[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(got_d[1], want_d[1], rtol=0, atol=1e-5)


def _segmentation_runs(dev, model, batch, losses_of):
    """`losses_of(model, batch)` forward and backward and `model.inference`
    on the CPU and on the card, from the same weights: (losses, gradients
    by name, inference) per device."""
    runs = []
    for device in ("cpu", dev):
        m = model.to(device)
        m.zero_grad()
        b = type(batch)(*(None if f is None else f.to(device) for f in batch))
        with torch.enable_grad():
            losses = losses_of(m, b)
            sum(losses.values()).backward()
        with torch.no_grad():
            out = m.inference(b)
        runs.append(({k: v.item() for k, v in losses.items()},
                     {n: p.grad.cpu().clone() for n, p in m.named_parameters() if p.grad is not None},
                     out))
    return runs


def _label_batch(with_boxes):
    from cddmsl_torch.models.rcnn import DetBatch

    g = torch.Generator().manual_seed(8)
    image = torch.rand((2, 96, 160, 3), generator=g) * 255
    image[1, 80:], image[1, :, 128:] = 0, 0
    labels = torch.randint(0, 5, (2, 12, 20), generator=g).repeat_interleave(8, 1).repeat_interleave(8, 2)
    labels[1, 80:], labels[1, :, 128:] = 255, 255
    xy = torch.rand((2, 3, 2), generator=g) * 60
    boxes = torch.cat([xy, xy + 16 + torch.rand((2, 3, 2), generator=g) * 40], -1)
    canvas = (torch.rand((2, 3, 24, 40), generator=g) > 0.5).to(torch.uint8)
    sizes = torch.tensor([[96, 160], [80, 128]])
    return DetBatch(image, sizes, sizes * 2, boxes if with_boxes else None,
                    torch.tensor([[0, 1, 2], [1, 2, 0]]) if with_boxes else None,
                    torch.ones((2, 3), dtype=torch.bool) if with_boxes else None,
                    gt_masks=canvas if with_boxes else None, sem_seg=labels.to(torch.int32))


def test_the_panoptic_step_and_inference_on_the_card_equal_the_cpu(dev):
    """`PanopticFPN` at depth 10 (bottleneck 8, MASK_ON, the head's GN) in
    float32 on two 96x160 images with a site-seeded draw: the six losses
    within 1e-4 relative and every gradient within 1e-3 of its tensor's
    largest (the plain RoIAlign and K1/K3 sum in other orders, and the
    proposals move by float noise through the sampler's pools); the sem-seg
    argmax equal on at least 99.9% of pixels, the detections' classes and
    validity equal where both keep a box."""
    import zlib

    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.models.panoptic_fpn import PanopticFPN

    def draw(site, shape):
        return torch.rand(shape, generator=torch.Generator().manual_seed(zlib.crc32(site.encode())))

    model = init_random_(PanopticFPN(num_classes=3, sem_seg_classes=5, depth=10, backbone_width=8, mask_on=True,
                                     mask_num_conv=1, mask_conv_dim=8, sem_seg_norm="GN",
                                     pixel_std=(57.375, 57.12, 58.395)), torch.Generator().manual_seed(9))
    (want_l, want_g, (want_d, want_s)), (got_l, got_g, (got_d, got_s)) = _segmentation_runs(
        dev, model, _label_batch(True), lambda m, b: m.losses(b, lambda s, shape: draw(s, shape).to(b.image.device)))
    assert set(got_l) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask", "loss_sem_seg"}
    assert all(abs(got_l[k] - want_l[k]) <= 1e-4 * abs(want_l[k]) + 1e-7 for k in want_l), (got_l, want_l)
    assert got_g.keys() == want_g.keys()
    for name, w in want_g.items():
        torch.testing.assert_close(got_g[name], w, rtol=0, atol=1e-3 * float(w.abs().max()) + 1e-8, msg=name)
    assert (got_s.cpu() == want_s).float().mean() > 0.999
    assert torch.equal(got_d.valid.cpu(), want_d.valid)


def test_the_semantic_segmentor_on_the_card_equals_the_cpu(dev):
    """`SemanticSegmentor` at depth 10 (no norm, p2..p5) in float32: on the
    loader's kind of batch (the second image padded with zeros) the loss
    within 1e-5 relative and the argmax equal on at least 99.9% of pixels;
    on a batch without padding every gradient within 1e-4 of its tensor's
    largest. (On the padded batch the tower's gradients part by ~2e-3 of
    their norm: its activations are constant over the padding, cuDNN's
    sums leave them an ulp apart from pixel to pixel, and the max-pool and
    the ReLUs decide there on those ulps, where the CPU sees exact ties.
    Without padding the card lies within 7e-7 of the CPU's float64.)"""
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.models.semantic_seg import SemanticSegmentor

    model = init_random_(SemanticSegmentor(num_classes=5, depth=10, pixel_std=(57.375, 57.12, 58.395)),
                         torch.Generator().manual_seed(10))
    padded = _label_batch(False)
    (want_l, _, want_s), (got_l, _, got_s) = _segmentation_runs(dev, model, padded, lambda m, b: m.losses(b))
    assert abs(got_l["loss_sem_seg"] - want_l["loss_sem_seg"]) <= 1e-5 * abs(want_l["loss_sem_seg"])
    assert (got_s.cpu() == want_s).float().mean() > 0.999
    g = torch.Generator().manual_seed(3)
    unpadded = padded._replace(image=torch.rand(padded.image.shape, generator=g) * 255,
                               image_sizes=torch.tensor([[96, 160], [96, 160]]))
    (_, want_g, _), (_, got_g, _) = _segmentation_runs(dev, model, unpadded, lambda m, b: m.losses(b))
    assert got_g.keys() == want_g.keys()
    for name, w in want_g.items():
        torch.testing.assert_close(got_g[name], w, rtol=0, atol=1e-4 * float(w.abs().max()) + 1e-8, msg=name)


def _unpadded_detection_batch(seed, classes=20, masks=False, proposals=0):
    """Two 96x160 images without padding, three boxes each (with canvases
    of their rectangles where `masks`, and `proposals` precomputed
    proposals an image): the norms' statistics and the ReLUs see no
    constant padded region, where cuDNN's sums and the CPU's part by ulps
    that ties then decide (test_the_semantic_segmentor_...)."""
    from cddmsl_torch.models.rcnn import DetBatch

    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((2, 3, 2), generator=g) * torch.tensor([80.0, 48.0])
    boxes = torch.cat([xy, xy + 16 + torch.rand((2, 3, 2), generator=g) * torch.tensor([60.0, 40.0])], -1)
    canvas = torch.zeros((2, 3, 24, 40))
    for i in range(2):
        for j in range(3):
            x0, y0, x1, y1 = (boxes[i, j] / 4).round().int().tolist()
            canvas[i, j, y0:y1, x0:x1] = 1.0
    sizes = torch.tensor([[96, 160], [96, 160]])
    pxy = torch.rand((2, proposals, 2), generator=g) * torch.tensor([120.0, 70.0])
    props = torch.cat([pxy, pxy + 8 + torch.rand((2, proposals, 2), generator=g) * 40], -1)
    return DetBatch(torch.rand((2, 96, 160, 3), generator=g) * 255, sizes, sizes * 2, boxes,
                    torch.randint(0, classes, (2, 3), generator=g), torch.ones((2, 3), dtype=torch.bool),
                    gt_masks=canvas if masks else None, proposal_boxes=props if proposals else None,
                    proposal_scores=torch.zeros((2, proposals)) if proposals else None,
                    proposal_valid=torch.ones((2, proposals), dtype=torch.bool) if proposals else None)


def _site_draw(device):
    import zlib

    return lambda site, shape: torch.rand(shape, generator=torch.Generator().manual_seed(zlib.crc32(site.encode()))
                                          ).to(device)


def _step_update_apart(dev, model, batch, solver):
    """One `Trainer` step on the CPU and on the card from `model`'s state,
    the same batch and site-seeded draws: (losses per device, |card's
    update - CPU's| / |CPU's update| over the parameters and buffers)."""
    import copy

    from cddmsl_torch.engine.train_loop import Trainer
    from cddmsl_torch.solver.build import build_optimizer

    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = []
    for device in ("cpu", dev):
        m = copy.deepcopy(model).to(device)
        trainer = Trainer(m, build_optimizer(m, solver), enable_caption=False)
        b = type(batch)(*(None if f is None else f.to(device) for f in batch))
        losses = trainer.train_step(b, _site_draw(device))
        out.append(({k: v.item() for k, v in losses.items() if k.startswith("loss")},
                    {k: v.detach().cpu() for k, v in m.state_dict().items()}))
    (want_l, want), (got_l, got) = out
    keys = [k for k in want if want[k].is_floating_point()]
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in keys)
    den = sum(float(((want[k].double() - before[k].double()) ** 2).sum()) for k in keys)
    assert den > 0
    return want_l, got_l, (num / den) ** 0.5


@pytest.mark.parametrize("norm", ["GN", "SyncBN"])
def test_the_norm_mask_rcnns_step_on_the_card_as_on_the_cpu(dev, norm):
    """A narrow FPN Mask R-CNN with `norm` through the tower, the FPN, a
    conv box head and the mask head, one float32 step (TF32 off) on an
    unpadded batch with 40 precomputed proposals an image: the losses
    within 1e-4 relative, the update (the parameters and SyncBN's running
    statistics) within 1e-4 of its norm. Precomputed, because the RPN's
    top-k and NMS choose among proposals by scores that float noise
    reorders: with the RPN, the CPU's own float32 GN step lies 3e-3 of the
    update's norm from its float64 step, with precomputed proposals 6e-6."""
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.config import SolverConfig
    from cddmsl_torch.models.fpn_rcnn import FPNRCNN

    model = init_random_(FPNRCNN(num_classes=20, depth=10, backbone_width=8, res2_out_channels=32, fpn_out_channels=32,
                                 fc_dim=64, emb_dim=48, rpn_pre_nms_topk=(64, 48), rpn_post_nms_topk=(32, 24),
                                 roi_batch_size_per_image=32, pixel_std=(57.375, 57.12, 58.395), mask_on=True,
                                 mask_num_conv=2, mask_conv_dim=16, backbone_norm=norm, fpn_norm=norm, box_num_conv=2,
                                 box_conv_dim=16, box_num_fc=1, box_conv_norm=norm, mask_conv_norm=norm,
                                 load_proposals=True),
                         torch.Generator().manual_seed(21))
    want, got, apart = _step_update_apart(dev, model, _unpadded_detection_batch(4, masks=True, proposals=40),
                                          SolverConfig(base_lr=0.02, warmup_iters=0))
    assert set(got) == {"loss_cls", "loss_box_reg", "loss_mask"}
    assert all(abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) + 1e-7 for k in want), (got, want)
    assert apart <= 1e-4, apart


def test_retinanet_steps_on_the_card_as_on_the_cpu_and_k4_takes_its_candidates(dev):
    """A narrow RetinaNet, one float32 step on an unpadded batch: the
    focal and box losses within 1e-4 relative, the update (the normalizer
    too) within 1e-4 of its norm; then K4 on the merged candidates of its
    five levels, class-shifted, on seeded scores, exactly as the plain
    version keeps them."""
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.config import SolverConfig
    from cddmsl_torch.models.retinanet import RetinaNet
    from cddmsl_torch.ops.nms import class_shifted

    model = init_random_(RetinaNet(num_classes=20, depth=10, backbone_width=8, res2_out_channels=32,
                                   fpn_out_channels=32, head_conv_dims=(16, 16), topk_candidates=200,
                                   pixel_std=(57.375, 57.12, 58.395)), torch.Generator().manual_seed(22))
    batch = _unpadded_detection_batch(5)
    want, got, apart = _step_update_apart(dev, model, batch, SolverConfig(base_lr=0.01, warmup_iters=0))
    assert set(got) == {"loss_cls", "loss_box_reg"}
    assert all(abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) + 1e-7 for k in want), (got, want)
    assert apart <= 1e-4, apart
    cands = model.candidates(batch)
    boxes = torch.cat([c[0] for c in cands], 1)
    classes = torch.cat([c[2] for c in cands], 1)
    scores = 0.05 + 0.95 * torch.rand(classes.shape, generator=torch.Generator().manual_seed(23))
    valid = torch.ones(classes.shape, dtype=torch.bool)
    shifted = class_shifted(boxes, classes, valid)
    assert shifted.shape == (2, 5 * 200, 4)  # the top 200 of each of the five levels
    assert_k4_equals_plain(shifted.to(dev), scores.to(dev), valid.to(dev), 0.5, 100)
