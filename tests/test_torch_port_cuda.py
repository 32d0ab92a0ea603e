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
covers N.
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
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = tf32


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
