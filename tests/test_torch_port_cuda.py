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
bit for bit; K4 exactly.
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


@pytest.mark.parametrize("thr, max_out", [(0.7, 300), (0.5, 40)])
def test_k4_equals_plain(dev, thr, max_out):
    g = torch.Generator(device=dev).manual_seed(4)
    xy = torch.rand((2, 1500, 2), generator=g, device=dev) * 600
    boxes = torch.cat([xy, xy + 4 + torch.rand((2, 1500, 2), generator=g, device=dev) * 150], -1)
    scores = torch.rand((2, 1500), generator=g, device=dev)
    valid = torch.rand((2, 1500), generator=g, device=dev) > 0.1
    idx, keep = nms_ops.nms(boxes, scores, thr, max_out, valid=valid)
    for i in range(2):
        want_idx, want_keep = nms_ops.nms_plain(boxes[i], scores[i], thr, max_out, valid=valid[i])
        assert torch.equal(idx[i], want_idx) and torch.equal(keep[i], want_keep)
