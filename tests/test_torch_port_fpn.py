"""detectron2's FPN box detectors in the port against cddmsl_tpu on the CPU:
the FPN and the DC5 and ResNeXt towers, the multi-level pooler, `FPNRPN`,
the fc box head, the whole `FPNRCNN` (losses, every parameter's gradient,
inference), the JAX-tree and d2_fpn converters, and the configs the port
accepts and refuses for this family.

The same inputs, made with numpy from a seed, go through both packages in
float32: two 96x160 images (the second 80x128 inside the pad, their
originals twice their size, so inference rescales) and one 112x176 image, a
pad that is a multiple of 16 and not of 32 (p5 is 4x6 under p4's 7x11). The
towers are at depth 10 and narrow widths: bottleneck 8 per group, res2 32
channels out, FPN 32 channels, fcs of 64 and 48. Tolerances, and why:
- the towers' maps (p2..p6, or DC5's res5) within 1e-4 absolute: the same
  convolutions summed in another order through ten blocks;
- `resize_nearest` exactly against jax.image.resize ("nearest"), the
  levels of `assign_boxes_to_levels` exactly (boxes of sqrt(area) exactly
  112, 224 and 448 among them), the pooled values and each level's
  gradient within 1e-5 of their largest value against JAX's pooler and
  `jax.vjp` of it (JAX contracts the dense interpolation matrices, the port
  the separable ones: sums in another order);
- the whole detector, in one JAX program per tower (the FPN with NUM_GROUPS
  2, STRIDE_IN_1X1 false and Detectron1's smooth-L1 betas 0.1111 and 1.0;
  DC5 with the plain tower): the RPN's proposals as
  test_torch_port_inference.py ranks them (boxes within 1e-3 px, ties
  matched as a set), the detections so with scores within 5e-5 (ties 1e-4
  apart; see DET_SCORE_ATOL) and boxes within 1e-3 px of the resized frame,
  2e-3 px once rescaled to originals twice as large; `supervised_losses` with JAX's
  draws replayed, rtol 1e-4; each parameter's gradient within 1e-4 of its
  tensor's largest gradient and never less than 1e-5, as
  test_torch_port_ovd.py holds them;
- the converters: the port's state exactly what JAX's `convert_d2_fpn_rcnn`
  makes of the same detectron2 file (fc1 permuted from CHW to HWC).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.checkpoint.convert_torch import convert_d2_fpn_rcnn
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.models import DetBatch as JaxDetBatch
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.backbone.resnet import FPN as JaxFPN
from cddmsl_tpu.models.backbone.resnet import D2ResNet as JaxD2ResNet
from cddmsl_tpu.models.extra_meta_archs import FPNProposalNetwork as JaxFPNProposalNetwork
from cddmsl_tpu.models.extra_meta_archs import ProposalNetwork as JaxProposalNetwork
from cddmsl_tpu.models.fpn_rcnn import FPNRCNN as JaxFPNRCNN
from cddmsl_tpu.models.poolers import ROIPooler as JaxROIPooler
from cddmsl_tpu.models.poolers import assign_boxes_to_levels as jax_assign_boxes_to_levels
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.checkpoint.convert_torch import load_rcnn_weights
from cddmsl_torch.config import check_supported, get_cfg, model_family
from cddmsl_torch.models.backbone.resnet import FPN, D2ResNet, resize_nearest
from cddmsl_torch.models.build import build_detector, fpn_rcnn_fields, proposal_network_fields
from cddmsl_torch.models.fpn_rcnn import FPNRCNN
from cddmsl_torch.models.poolers import ROIPooler, assign_boxes_to_levels
from cddmsl_torch.models.rcnn import DetBatch
from test_torch_port_backbone import fill_params, port_tree_shapes
from test_torch_port_inference import BOX_ATOL, TIE_GAP, _assert_ranked_rows_match, inference_and_head_inputs
from torch_goldens import supervised_draw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
K = 20
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# the box head's class probabilities: two fcs over 7x7x32 pooled values that
# differ by ~1e-5 from JAX's (other sums through the ResNeXt tower and K1's
# separable contraction) move them by up to ~2e-5
DET_SCORE_ATOL, DET_TIE_GAP = 5e-5, 1e-4
NARROW = dict(num_classes=K, depth=10, backbone_width=8, res2_out_channels=32, fpn_out_channels=32, fc_dim=64,
              emb_dim=48, rpn_pre_nms_topk=(64, 48), rpn_post_nms_topk=(32, 24), roi_batch_size_per_image=32)
TOWERS = {
    "fpn_resnext": dict(num_groups=2, stride_in_1x1=False, rpn_smooth_l1_beta=0.1111, roi_smooth_l1_beta=1.0),
    "dc5": dict(dc5=True),
}
D2_PIXELS = dict(pixel_mean=(103.53, 116.28, 123.675), pixel_std=(57.375, 57.12, 58.395))


def _t(a):
    return torch.from_numpy(np.array(a))


def _under(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def make_batch(b, h, w, sizes, orig, seed, g=4):
    """A JAX DetBatch of `b` images padded to (h, w) with their true and
    original sizes; up to `g` ground-truth boxes inside each true size."""
    r = np.random.RandomState(seed)
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_valid = np.zeros((b, g), bool)
    for i, (th, tw) in enumerate(sizes):
        n = r.randint(2, g + 1)
        x1, y1 = r.rand(n) * tw * 0.5, r.rand(n) * th * 0.5
        bw, bh = 12 + r.rand(n) * tw * 0.45, 12 + r.rand(n) * th * 0.45
        gt_boxes[i, :n] = np.stack([x1, y1, np.minimum(x1 + bw, tw), np.minimum(y1 + bh, th)], 1)
        gt_valid[i, :n] = True
    image = r.rand(b, h, w, 3) * 255
    for i, (th, tw) in enumerate(sizes):
        image[i, th:], image[i, :, tw:] = 0, 0
    return JaxDetBatch(
        image=jnp.asarray(image, jnp.float32), image_sizes=jnp.asarray(sizes, jnp.int32),
        orig_sizes=jnp.asarray(orig, jnp.int32), gt_boxes=jnp.asarray(gt_boxes),
        gt_classes=jnp.asarray(r.randint(0, K, (b, g)), jnp.int32), gt_valid=jnp.asarray(gt_valid))


def torch_batch(jb, **extra):
    return DetBatch(*(None if f is None else _t(f) for f in (
        jb.image, jb.image_sizes, jb.orig_sizes, jb.gt_boxes, jb.gt_classes, jb.gt_valid, None)), **extra)


BATCH_A = make_batch(2, 96, 160, [[96, 160], [80, 128]], [[192, 320], [160, 256]], seed=1)
BATCH_B = make_batch(1, 112, 176, [[112, 176]], [[112, 176]], seed=2)


def filled(module, batch, seed, method="init_all", port=None):
    """The module's JAX tree, filled by `fill_params` (no compile), with the
    RPN head's outputs near the 0.01 std of its own init and the box
    regressor's kernel at the 0.001 std of its own. The tree's shapes come
    from `eval_shape` of the JAX module's `method`, or read off the port's
    `port` (`port_tree_shapes`: the same tree, without tracing JAX's)."""
    shapes = port_tree_shapes(port) if port is not None else jax.eval_shape(
        lambda r, b: module.init({"params": r}, b, r, method=getattr(module, method)), jax.random.PRNGKey(0), batch)
    params = fill_params(shapes, seed=seed)
    tree = params["params"]
    head = tree.get("proposal_generator", {}).get("head")
    if head is not None:
        for name in ("objectness_logits", "anchor_deltas"):
            head[name]["kernel"] = head[name]["kernel"] / 4
    if "roi_heads" in tree:
        bbox = tree["roi_heads"]["box_predictor"]["bbox_pred"]
        bbox["kernel"] = bbox["kernel"] * (0.001 / bbox["kernel"].std())
    return params


def assert_rows_match(got, want, kind, close):
    """Per image, the rows of `got` against `want` (proposals or detections)
    as test_torch_port_inference.py ranks them; valid masks exactly."""
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 0
    for i in range(got.valid.shape[0]):
        if kind == "proposal":
            rows = lambda d: np.asarray(d.boxes[i])  # noqa: E731
        else:
            rows = lambda d: [(int(c), np.asarray(b), float(s)) for c, b, s in  # noqa: E731
                              zip(np.asarray(d.classes[i]), np.asarray(d.boxes[i]), np.asarray(d.scores[i]))]
        _assert_ranked_rows_match(np.asarray(got.scores[i]), rows(got), np.asarray(want.scores[i]), rows(want),
                                  TIE_GAP[kind] if kind == "proposal" else DET_TIE_GAP, close)


def close_box(g, w):
    return np.abs(g - w).max() <= BOX_ATOL


def close_detection(scale):
    """Classes exactly, boxes within BOX_ATOL px of the resized frame (times
    the rescale to the original), scores within DET_SCORE_ATOL."""
    return lambda g, w: (g[0] == w[0] and np.abs(g[1] - w[1]).max() <= BOX_ATOL * scale
                         and abs(g[2] - w[2]) <= DET_SCORE_ATOL)


def assert_grads_match(model, want_grads, rtol=GRAD_RTOL):
    """Every trainable parameter's gradient against JAX's, within `rtol`
    (GRAD_RTOL) of its tensor's largest gradient and never less than
    GRAD_ATOL; some are not zero."""
    named = list(model.named_parameters())
    assert named and all(p.grad is not None for _, p in named)
    for name, p in named:
        want = want_grads[name].numpy()
        atol = max(GRAD_ATOL, rtol * np.abs(want).max())
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=atol, err_msg=name)
    assert any(np.abs(want_grads[n].numpy()).max() > 0 for n, _ in named)


# ---------------- the towers and the pooler ----------------
@pytest.mark.parametrize("groups, in_1x1", [(1, True), (2, False)], ids=["resnet", "resnext"])
def test_fpn_maps_equal_jax(groups, in_1x1):
    """p2..p6 of the FPN on both batches (112x176: p5 4x6 resized to p4's
    7x11), the ResNet and ResNeXt towers; eager JAX, no compile."""
    kw = dict(depth=10, num_groups=groups, width_per_group=8, stride_in_1x1=in_1x1, res2_out_channels=32)
    jt = JaxD2ResNet(out_features=("res2", "res3", "res4", "res5"), **kw)
    jf = JaxFPN(out_channels=32)

    def both(m, x):
        return jf(m(x))

    x = np.random.RandomState(3).randn(1, 112, 176, 3).astype(np.float32)
    t_params = fill_params(jax.eval_shape(lambda r: jt.init(r, jnp.asarray(x)), jax.random.PRNGKey(0)), seed=4)
    f_params = fill_params(jax.eval_shape(lambda r: jf.init(r, jt.apply(t_params, jnp.asarray(x))),
                                          jax.random.PRNGKey(0)), seed=5)
    ours = FPN(D2ResNet(10, num_groups=groups, width_per_group=8, stride_in_1x1=in_1x1, res2_out_channels=32), 32)
    state = convert_jax_params({"backbone": t_params["params"], "fpn": f_params["params"]})
    ours.load_state_dict(_under(state, "backbone."), strict=True)
    for batch in (BATCH_A, BATCH_B):
        want = jf.apply(f_params, jt.apply(t_params, batch.image / 64.0))
        with torch.no_grad():
            got = ours(_t(batch.image) / 64.0)
        assert set(got) == set(want) == {"p2", "p3", "p4", "p5", "p6"}
        for name in want:
            assert got[name].shape == want[name].shape, name
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=1e-4, err_msg=name)
    assert tuple(got["p5"].shape[1:3]) == (4, 6) and tuple(got["p4"].shape[1:3]) == (7, 11)


def test_dc5_tower_equals_jax():
    """RES5_DILATION 2: res5 at stride 16 with dilated 3x3s, against JAX's."""
    jt = JaxD2ResNet(depth=10, out_features=("res5",), res5_dilation=2, width_per_group=8, res2_out_channels=32)
    x = BATCH_B.image / 64.0
    params = fill_params(jax.eval_shape(lambda r: jt.init(r, x), jax.random.PRNGKey(0)), seed=6)
    ours = D2ResNet(10, width_per_group=8, res5_dilation=2, res2_out_channels=32)
    ours.load_state_dict(_under(convert_jax_params({"backbone": params["params"]}), "backbone."), strict=True)
    want = jt.apply(params, x)["res5"]
    with torch.no_grad():
        got = ours(_t(x), ("res5",))["res5"]
    assert got.shape == want.shape == (1, 7, 11, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("m, n", [(4, 7), (6, 11), (7, 14), (25, 50), (3, 5), (11, 22)])
def test_resize_nearest_takes_jax_rows(m, n):
    """jax.image.resize's rows exactly; torch's "nearest-exact" agrees on
    these sizes, its "nearest" does not where n is not 2m."""
    x = np.arange(m * m, dtype=np.float32).reshape(1, m, m, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, n, n, 1), "nearest"))[..., 0]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(resize_nearest(xt, (n, n))[:, 0].numpy(), want)
    exact = torch.nn.functional.interpolate(xt, size=(n, n), mode="nearest-exact")[:, 0].numpy()
    plain = torch.nn.functional.interpolate(xt, size=(n, n), mode="nearest")[:, 0].numpy()
    np.testing.assert_array_equal(exact, want)
    assert np.array_equal(plain, want) == (n == 2 * m)


def _pool_boxes(r, b, s):
    """Random boxes over a 112x176 canvas, with boxes of sqrt(area) exactly
    112, 224 and 448 (the level boundaries), just under them, and a zero box."""
    x1, y1 = r.rand(b, s) * 120, r.rand(b, s) * 80
    bw, bh = 2 + r.rand(b, s) * 300, 2 + r.rand(b, s) * 200
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    edges = [[0, 0, 112, 112], [10, 20, 234, 244], [0, 0, 448, 448], [0, 0, 111.9, 112], [5, 5, 229, 228.99],
             [0, 0, 56, 56], [0, 0, 0, 0]]
    boxes[0, :len(edges)] = edges
    return boxes


def test_pooler_levels_values_and_gradients_equal_jax():
    """`assign_boxes_to_levels` exactly, the pooled 7x7 values and each
    level's gradient (jax.vjp of JAX's pooler, per image as the heads vmap
    it) on four maps of strides 4..32; each box pools from its level only."""
    r = np.random.RandomState(7)
    b, s, c = 2, 40, 8
    boxes = _pool_boxes(r, b, s)
    feats = [r.randn(b, 112 // st, 176 // st, c).astype(np.float32) for st in (4, 8, 16, 32)]
    scales = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
    want_levels = np.asarray(jax_assign_boxes_to_levels(jnp.asarray(boxes), 2, 5))
    got_levels = assign_boxes_to_levels(_t(boxes), 2, 5)
    np.testing.assert_array_equal(got_levels.numpy(), want_levels)
    assert list(want_levels[0, :6]) == [3, 4, 5, 2, 3, 2] and set(want_levels.ravel()) == {2, 3, 4, 5}

    pooler = JaxROIPooler(7, scales)
    fn = jax.vmap(lambda *a: pooler(list(a[:-1]), a[-1]))
    cot = r.randn(b, s, 7, 7, c).astype(np.float32)
    want, vjp = jax.vjp(lambda *f: fn(*f, jnp.asarray(boxes)), *map(jnp.asarray, feats))
    want_grads = vjp(jnp.asarray(cot))
    tf = [_t(f).requires_grad_(True) for f in feats]
    got = ROIPooler(7, scales)(tf, _t(boxes))
    got.backward(_t(cot).reshape(b * s, 7, 7, c))
    want = np.asarray(want).reshape(b * s, 7, 7, c)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    for level, (g, w) in enumerate(zip(tf, want_grads)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=f"p{level + 2}")


def test_pooler_masks_other_levels_rows_with_nan():
    """Each level's K1 launch gets every row, the rows of other levels NaN;
    those pool zeros there."""
    boxes = _t(_pool_boxes(np.random.RandomState(8), 1, 12))
    pooler = ROIPooler(7, (1 / 4, 1 / 8, 1 / 16, 1 / 32))
    bidx, per_level = pooler.level_boxes(boxes)
    levels = assign_boxes_to_levels(boxes.reshape(-1, 4), 2, 5)
    assert bidx.dtype == torch.int32 and len(per_level) == 4
    for i, lb in enumerate(per_level):
        mine = levels == i + 2
        assert torch.equal(lb[mine], boxes.reshape(-1, 4)[mine]) and torch.isnan(lb[~mine]).all()
    single = ROIPooler(7, (1 / 16,))
    assert not torch.isnan(single.level_boxes(boxes)[1][0]).any()


# ---------------- the whole detector ----------------
@pytest.fixture(scope="module", params=list(TOWERS))
def fpn_runs(request):
    """One JAX program per tower: the gradient of `supervised_losses` on
    batch A, and on both batches the maps, the test proposals and the
    inference; the same in the port from the converted tree."""
    kw = {**NARROW, **TOWERS[request.param], **D2_PIXELS}
    model, ours = JaxFPNRCNN(**kw), FPNRCNN(**kw)
    params = filled(model, BATCH_A, seed=21, port=ours)
    rng = jax.random.PRNGKey(9)

    def total(p, b, r):
        losses = model.apply(p, b, r, method=model.supervised_losses)
        return sum(losses.values()), losses

    def forward(m, b):
        return inference_and_head_inputs(m, b)

    (grads, losses), out_a, out_b = jax.jit(lambda p, a, b, r: (
        jax.grad(total, has_aux=True)(p, a, r), model.apply(p, a, method=forward), model.apply(p, b, method=forward),
    ))(params, BATCH_A, BATCH_B, rng)

    ours.load_state_dict(convert_jax_params(params), strict=True)
    got = []
    with torch.no_grad():
        for jb in (BATCH_A, BATCH_B):
            tb = torch_batch(jb)
            head, proposals = ours.proposals(tb)
            got.append((head, proposals, ours.inference(tb)))
    with torch.enable_grad():
        got_losses = ours.supervised_losses(torch_batch(BATCH_A), supervised_draw(rng))
        sum(got_losses.values()).backward()
    return dict(tower=request.param, want=(out_a, out_b, losses, convert_jax_params(grads)),
                got=(*got, got_losses), model=ours)


def test_fpn_rcnn_maps_equal_jax(fpn_runs):
    for (want_head, _, _), (got_head, _, _) in zip(fpn_runs["want"][:2], fpn_runs["got"][:2]):
        assert len(got_head) == len(want_head) == (1 if fpn_runs["tower"] == "dc5" else 4)
        for g, w in zip(got_head, want_head):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_fpn_rpn_proposals_equal_jax(fpn_runs):
    """The cross-level NMS's proposals (one NMS over the levels moved apart
    by lvl * (max(h, w) + 1)) on both batches."""
    for (_, want, _), (_, got, _) in zip(fpn_runs["want"][:2], fpn_runs["got"][:2]):
        assert got.boxes.shape == want.boxes.shape == (got.boxes.shape[0], 24, 4)
        assert_rows_match(got, want, "proposal", close_box)


def test_fpn_rcnn_detections_equal_jax(fpn_runs):
    """Detections on both batches, batch A's rescaled to its originals."""
    for (_, _, want), (_, _, got), scale in zip(fpn_runs["want"][:2], fpn_runs["got"][:2], (2, 1)):
        assert_rows_match(got, want, "detection", close_detection(scale))
    assert fpn_runs["got"][0][2].boxes[0].max() > 160  # the rescale to 192x320 moved them


def test_fpn_rcnn_losses_and_gradients_equal_jax(fpn_runs):
    """The RPN's and the box head's losses (smooth-L1 at beta 0.1111 and 1.0
    on the ResNeXt tower) with JAX's draws, and every parameter's gradient."""
    want_losses, want_grads = fpn_runs["want"][2:]
    got_losses, model = fpn_runs["got"][2], fpn_runs["model"]
    assert set(got_losses) == set(want_losses) == {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc"}
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].item(), float(v), rtol=1e-4, err_msg=k)
        assert float(v) > 0, k
    assert_grads_match(model, want_grads)


# ---------------- converters ----------------
def test_a_d2_fpn_file_loads_as_jax_converts_it(tmp_path):
    """A seeded detectron2 FPN file (its names: backbone.bottom_up.*,
    backbone.fpn_lateral{l}, fpn_output{l}, the RPN head, box_head.fc1 on
    the CHW flatten, fc2, the linear predictor) through `load_rcnn_weights`
    equals JAX's `convert_d2_fpn_rcnn` of it through `convert_jax_params`,
    every tensor exactly: fc1 permuted once, CHW to HWC."""
    ours = FPNRCNN(**NARROW)
    r = np.random.RandomState(0)
    sd = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32)) for k, v in ours.state_dict().items()}
    path = tmp_path / "model_final.pth"
    torch.save({"model": sd}, path)
    assert load_rcnn_weights(ours, str(path)) == "d2_fpn"
    want = convert_jax_params(convert_d2_fpn_rcnn({k: v.numpy() for k, v in sd.items()}))
    state = ours.state_dict()
    assert set(want) == set(state)
    for name, value in want.items():
        torch.testing.assert_close(state[name], value, rtol=0, atol=0, msg=name)
    fc1 = "roi_heads.box_head.fc1.weight"
    assert not torch.equal(state[fc1], sd[fc1])
    assert torch.equal(state[fc1].reshape(64, 7, 7, 32).permute(0, 3, 1, 2).reshape(64, -1), sd[fc1])


@pytest.mark.parametrize("dc5", [False, True])
def test_jax_trees_convert_onto_every_tensor(dc5):
    """JAX's FPNRCNN tree (FPN or DC5) onto the port's, every tensor, by
    the family's rules."""
    model = JaxFPNRCNN(**NARROW, dc5=dc5)
    state = convert_jax_params(filled(model, BATCH_A, seed=3))
    ours = FPNRCNN(**NARROW, dc5=dc5)
    ours.load_state_dict(state, strict=True)
    assert ("backbone.res5.0.conv2.weight" if dc5 else "backbone.bottom_up.res5.0.conv2.weight") in state
    assert ours.roi_heads.box_head.fc1.in_features == 7 * 7 * (256 if dc5 else 32)


# ---------------- the configs ----------------
ACCEPTED = [REPO / "configs" / p for p in (
    "COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml", "COCO-Detection/faster_rcnn_R_50_FPN_3x.yaml",
    "COCO-Detection/faster_rcnn_R_101_FPN_3x.yaml", "COCO-Detection/faster_rcnn_X_101_32x8d_FPN_3x.yaml",
    "COCO-Detection/faster_rcnn_R_50_DC5_1x.yaml", "COCO-Detection/faster_rcnn_R_50_DC5_3x.yaml",
    "COCO-Detection/faster_rcnn_R_101_DC5_3x.yaml", "COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml",
    "COCO-Detection/rpn_R_50_FPN_1x.yaml", "COCO-Detection/rpn_R_50_C4_1x.yaml",
    "PascalVOC-Detection/faster_rcnn_R_50_FPN.yaml", "Detectron1-Comparisons/faster_rcnn_R_50_FPN_noaug_1x.yaml",
    "quick_schedules/rpn_R_50_FPN_instant_test.yaml", "quick_schedules/fast_rcnn_R_50_FPN_instant_test.yaml")]
JAX_CLASS = {"fpn": JaxFPNRCNN, "dc5": JaxFPNRCNN, "proposal_fpn": JaxFPNProposalNetwork,
             "proposal_c4": JaxProposalNetwork}


def _both(path):
    ours, ref = get_cfg(), jax_get_cfg()
    ours.merge_from_file(str(path))
    ref.merge_from_file(str(path))
    return ours, ref


@pytest.mark.parametrize("path", ACCEPTED, ids=lambda p: p.stem)
def test_the_config_is_accepted_and_takes_the_jax_builders_fields(path):
    """Accepted at world 1; every field the port's builder gives is the
    value of the same field of JAX's module (`build_fpn_rcnn`,
    `build_proposal_network`), and the detector is of JAX's class."""
    ours, ref = _both(path)
    check_supported(ours, world=1)
    family, want = model_family(ours), jax_build_model(ref)
    assert type(want) is JAX_CLASS[family]
    fields = fpn_rcnn_fields(ours) if family in ("fpn", "dc5") else proposal_network_fields(ours)
    for name, value in fields.items():
        expect = getattr(want, name)
        if name == "dtype":
            assert str(value).split(".")[-1] == jnp.dtype(expect).name
        elif name == "backbone_width":
            assert value == (expect or 64), name
        else:
            assert value == (tuple(expect) if isinstance(expect, (list, tuple)) else expect), name
    model = build_detector(ours, device="cpu")
    assert type(model).__name__ == type(want).__name__


# refused until the trainable norms, the conv box head and the CLIP FPN tower were ported; JAX's FPNRCNN builds them
_FPN_TAKEN = [
    ("MODEL.ROI_MASK_HEAD.NORM", "GN"), ("MODEL.BACKBONE.NAME", "build_clip_resnet_fpn_backbone"),
    ("MODEL.RESNETS.NORM", "GN"), ("MODEL.FPN.NORM", "GN"), ("MODEL.ROI_BOX_HEAD.NUM_CONV", 4),
    ("MODEL.ROI_BOX_HEAD.NUM_FC", 1), ("MODEL.ROI_BOX_HEAD.NORM", "GN"),
    # the deformable stages, ported since (test_torch_port_dconv.py)
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True]),
    # the BasicBlock towers, ported since (test_torch_port_rotated.py)
    ("MODEL.RESNETS.DEPTH", 18), ("MODEL.RESNETS.DEPTH", 34),
]


def _fpn_key_cfgs(key, value):
    cfgs = _both(ACCEPTED[0])
    for cfg in cfgs:
        if key.startswith("MODEL.ROI_MASK_HEAD."):
            cfg.merge_from_list(["MODEL.MASK_ON", "True"])
        if key.startswith("MODEL.ROI_KEYPOINT_HEAD."):
            cfg.merge_from_list(["MODEL.KEYPOINT_ON", "True"])
        if key.startswith("MODEL.ROI_BOX_CASCADE_HEAD."):
            cfg.merge_from_list(["MODEL.ROI_HEADS.NAME", "CascadeROIHeads"])
        cfg.merge_from_list([key, repr(value) if not isinstance(value, str) else value])
    return cfgs


@pytest.mark.parametrize("key, value", _FPN_TAKEN)
def test_the_fpn_family_takes_the_norms_and_the_clip_tower_with_the_jax_builders_fields(key, value):
    ours, ref = _fpn_key_cfgs(key, value)
    check_supported(ours, world=1)
    want = jax_build_model(ref)
    for name, got in fpn_rcnn_fields(ours).items():
        expect = getattr(want, name)
        if name == "dtype":
            assert str(got).split(".")[-1] == jnp.dtype(expect).name
        elif name == "backbone_width":
            assert got == (expect or 64), name
        else:
            assert got == (tuple(expect) if isinstance(expect, (list, tuple)) else expect), name
    with torch.device("meta"):
        assert type(build_detector(ours, device="meta")).__name__ == "FPNRCNN"


@pytest.mark.parametrize("key, value", [
    ("MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE", "ROIPool"),
    ("MODEL.ROI_BOX_CASCADE_HEAD.IOUS", [0.5, 0.55, 0.6]),
    ("MODEL.BACKBONE.NAME", "build_regnet_fpn_backbone"),
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", [True, True, True]),  # not one flag a stage (JAX indexes four)
    ("MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE", "diou"), ("MODEL.RPN.BBOX_REG_LOSS_TYPE", "diou"),
    # depths 18 and 34 are taken since the BasicBlock towers were ported: these ids now hold depths the
    # plain tower does not have
    pytest.param("MODEL.RESNETS.DEPTH", 26, id="MODEL.RESNETS.DEPTH-18"),
    pytest.param("MODEL.RESNETS.DEPTH", 200, id="MODEL.RESNETS.DEPTH-34"), ("MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 14 * 2),
    ("MODEL.CONSISTENCY_BRANCH", "image"), ("MODEL.CLIP.FOCAL_SCALED_LOSS", 0.5),
])
def test_the_fpn_family_refuses_what_it_leaves_out_naming_the_key(key, value):
    """GIoU, the mask and keypoint heads and the cascade are ported: their
    keys are refused at other values (a mask head's under MODEL.MASK_ON, a
    keypoint head's under MODEL.KEYPOINT_ON, the cascade's under
    ROI_HEADS.NAME CascadeROIHeads)."""
    cfg = _fpn_key_cfgs(key, value)[0]
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        check_supported(cfg, world=1)


# ---------------- chip_smoke.py's phase 16 ----------------
def _same(a, b):
    """Equal tensors, NaN where the other has NaN."""
    return a.shape == b.shape and torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def test_fpn_kernel_calls_are_the_steps_and_eval_batchs_own(monkeypatch):
    """Phase 16's rebuilt calls on a narrow FPNRCNN: the step's four
    per-level pools (`fpn_step_roi_align_calls`, the other levels' rows NaN)
    and the eval batch's four pools and two NMS calls
    (`fpn_eval_kernel_calls`: the RPN's over the level-shifted candidates,
    the detection NMS after the class shift) are what the model hands to
    `roi_align_batched` and `nms`."""
    import chip_smoke
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.config import SolverConfig
    from cddmsl_torch.engine.train_loop import Trainer
    from cddmsl_torch.models import poolers, rpn
    from cddmsl_torch.ops import nms as nms_ops
    from cddmsl_torch.solver.build import build_optimizer

    model = init_random_(FPNRCNN(**NARROW, **D2_PIXELS), torch.Generator().manual_seed(6))
    trainer = Trainer(model, build_optimizer(model, SolverConfig(warmup_iters=0)), enable_caption=False)
    batch = torch_batch(BATCH_A)
    draw = chip_smoke.site_draw("cpu")
    with torch.no_grad():
        rebuilt = chip_smoke.fpn_step_roi_align_calls(model, batch, draw)
    pools, nmss = [], []
    pool, nms = poolers.roi_align_batched, nms_ops.nms

    def pool_spy(features, batch_idx, boxes, *args):
        pools.append((features.detach().clone(), batch_idx.clone(), boxes.detach().clone(), *args))
        return pool(features, batch_idx, boxes, *args)

    def nms_spy(boxes, scores, iou_threshold, max_out, valid=None):
        nmss.append((boxes.clone(), scores.clone(), valid.clone(), iou_threshold, max_out))
        return nms(boxes, scores, iou_threshold, max_out, valid=valid)

    monkeypatch.setattr(poolers, "roi_align_batched", pool_spy)
    trainer.train_step(batch, draw)
    assert [label for label, *_ in rebuilt] == [f"supervised p{i}" for i in range(2, 6)] and len(pools) == 4
    for (_, feats, bidx, boxes, pooled, scale), (f, i, b, size, s, *_) in zip(rebuilt, pools):
        assert torch.equal(feats, f) and torch.equal(bidx, i) and _same(boxes, b) and (pooled, pooled) == size
        assert scale == s
    assert sum(int(b.isfinite().all(1).sum()) for *_, b, _, _ in rebuilt) == 2 * NARROW["roi_batch_size_per_image"]

    eval_calls, nms_calls = chip_smoke.fpn_eval_kernel_calls(model, batch)
    pools.clear()
    monkeypatch.setattr(rpn, "nms", nms_spy)
    monkeypatch.setattr(nms_ops, "nms", nms_spy)
    model.inference(batch)
    assert len(pools) == len(eval_calls) == 4 and len(nmss) == len(nms_calls) == 2
    for (_, feats, bidx, boxes, *_), (f, i, b, *_) in zip(eval_calls, pools):
        assert torch.equal(feats, f) and torch.equal(bidx, i) and _same(boxes, b)
    for got, want in zip(nms_calls, nmss):
        assert all(torch.equal(x, y) for x, y in zip(got[:3], want[:3])) and got[3:] == want[3:]
    assert nms_calls[0][0].shape[1] > nms_calls[0][4]  # the levels' candidates, more than it keeps
