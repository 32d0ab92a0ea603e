"""The rotated family and the BasicBlock towers in the port against
cddmsl_tpu on the CPU: the rotated ops (`pairwise_iou_rotated`,
`nms_rotated`, `roi_align_rotated`), `Box2BoxTransformRotated`,
`D2BasicBlock`, a depth-18 tower and a detectron2 R-18 file through both
loaders, `RotatedFastRCNN`'s four losses and
its inference from JAX's tree through `convert_jax_params` with JAX's
draws, `RotatedCOCOEvaluator`, the builder, and JAX's trainer failing on
the rotated file, which `check_supported` refuses.

One JAX program: the rotated model's losses and inference compiled
together, at depth 10, 5 classes, on two 64x64 images. The ops' JAX
references are jitted once each. Tolerances, and why:
- IoU within 1e-5 (the same clip in float32; the shoelace sum and the
  union in another order), on identical, nested, shared-edge, disjoint,
  touching and 0/45/90/180 degree boxes and on random ones; no clip step
  fills JAX's 16-vertex capacity;
- NMS indices and validity exactly (decisions on those IoUs);
- rotated RoIAlign and its feature gradient within 1e-5 of the largest
  magnitude (four bilinear terms and a mean of four, in JAX's order);
- the box transform within 1e-5 of each coordinate's magnitude (float32
  exp and log), angles wrapped by floor modulo (the `fmod` mutation lands
  at +180 and fails);
- the BasicBlock and the tower within 1e-5 of their largest magnitude
  (convolutions summed in another order); the detectron2 file's tensors
  through both loaders exactly;
- the losses within rtol 1e-5; the detections: the same classes,
  validity and order, scores within 1e-5, centers and sizes within 1e-3
  plus 1e-5 of the box's larger side (random weights decode boxes up to
  3000 px wide, and a center moves by the delta's float32 error times
  the size), angles within 1e-3 degrees;
- the evaluator's AP dictionary within 1e-9.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.engine.defaults import DefaultTrainer as JaxDefaultTrainer
from cddmsl_tpu.evaluation.rotated_coco_eval import RotatedCOCOEvaluator as JaxRotatedCOCOEvaluator
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.backbone.resnet import D2BasicBlock as JaxD2BasicBlock
from cddmsl_tpu.models.backbone.resnet import D2ResNet as JaxD2ResNet
from cddmsl_tpu.models.rotated_rcnn import RotatedDetBatch as JaxRotatedDetBatch
from cddmsl_tpu.models.rotated_rcnn import RotatedFastRCNN as JaxRotatedFastRCNN
from cddmsl_tpu.models.rotated_rcnn import rotated_anchor_grid as jax_rotated_anchor_grid
from cddmsl_tpu.ops import rotated as jax_rot
from cddmsl_tpu.ops.box_regression import Box2BoxTransformRotated as JaxBox2BoxRotated
from cddmsl_torch.checkpoint import convert_jax
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.config import check_supported, get_cfg
from cddmsl_torch.data.catalog import MetadataCatalog
from cddmsl_torch.evaluation.rotated_coco_eval import RotatedCOCOEvaluator
from cddmsl_torch.models.backbone.resnet import D2BasicBlock, D2ResNet
from cddmsl_torch.models.build import build_detector, rotated_fast_rcnn_fields
from cddmsl_torch.models.rotated_rcnn import RotatedDetBatch, RotatedFastRCNN, rotated_anchor_grid
from cddmsl_torch.ops import rotated as rot
from cddmsl_torch.ops.box_regression import Box2BoxTransformRotated
from test_torch_port_backbone import fill_params, port_tree_shapes
from test_torch_port_fpn import D2_PIXELS

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ROTATED_YAML = REPO / "configs" / "Misc" / "rotated_faster_rcnn.yaml"

jax_iou = jax.jit(jax_rot.pairwise_iou_rotated)
jax_nms = jax.jit(jax_rot.nms_rotated, static_argnums=(2, 3))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30))


def _random_boxes(r, n, extent=60.0, size=30.0):
    return np.stack([r.rand(n) * extent, r.rand(n) * extent, 2 + r.rand(n) * size, 2 + r.rand(n) * size,
                     r.uniform(-180, 180, n)], 1).astype(np.float32)


# identical, nested, shared-edge, disjoint, touching and 0/45/90/180 degree boxes
EDGE_A = np.array([
    [10, 10, 8, 4, 0], [10, 10, 8, 4, 0], [10, 10, 8, 4, 0], [10, 10, 8, 4, 0], [10, 10, 8, 4, 0],
    [10, 10, 8, 4, 0], [10, 10, 4, 4, 0], [0, 0, 2, 2, 0], [5, 5, 6, 2, 30],
], np.float32)
EDGE_B = np.array([
    [10, 10, 8, 4, 0], [10, 10, 4, 2, 0], [18, 10, 8, 4, 0], [40, 40, 8, 4, 0], [14, 10, 8, 4, 180],
    [10, 10, 8, 4, 90], [10, 10, 4, 4, 45], [2, 0, 2, 2, 0], [5, 5, 6, 2, -150],
], np.float32)


def test_the_rotated_iou_equals_jax_on_edge_cases_and_random_boxes():
    r = np.random.RandomState(0)
    b1 = np.concatenate([EDGE_A, _random_boxes(r, 40)])
    b2 = np.concatenate([EDGE_B, _random_boxes(r, 50)])
    got = rot.pairwise_iou_rotated(_t(b1), _t(b2)).numpy()
    want = np.asarray(jax_iou(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # identical, nested 1/4, half overlap, disjoint, the same box at 180, a cross, a square in its 45 twin
    np.testing.assert_allclose(np.diag(got[:9, :9])[:7], [1.0, 0.25, 0.0, 0.0, 1 / 3, 1 / 3, 2 ** -0.5],
                               atol=1e-5)
    assert got[2, 2] == 0.0 and got[7, 7] == 0.0  # a shared edge and a shared corner line: no area
    assert rot.clip_vertex_counts(_t(b1), _t(b2)).max() <= 8  # so index 15 of JAX's capacity only ever holds zeros


def test_nms_rotated_indices_equal_jax():
    r = np.random.RandomState(1)
    boxes = _random_boxes(r, 120, extent=40.0)
    boxes[60:70] = boxes[50:60] + np.float32([0.5, 0.5, 0, 0, 3])  # near duplicates
    scores = np.round(r.rand(120) * 20).astype(np.float32) / 20  # ties
    valid = r.rand(120) > 0.2
    scores[5] = -np.inf
    for thr, max_out in ((0.3, 40), (0.7, 200), (0.0, 10)):
        want_i, want_v = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), thr, max_out, valid=jnp.asarray(valid))
        got_i, got_v = rot.nms_rotated(_t(boxes), _t(scores), thr, max_out, valid=_t(valid))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_roi_align_rotated_and_its_gradient_equal_jax():
    r = np.random.RandomState(2)
    feats = r.randn(2, 12, 20, 8).astype(np.float32)
    boxes = _random_boxes(r, 2 * 6, extent=300.0, size=120.0).reshape(2, 6, 5)
    boxes[0, 0] = [-40, 50, 60, 30, 20]  # partly outside the map
    g = r.randn(2, 6, 7, 7, 8).astype(np.float32)

    def jax_pool(f):
        return jax.vmap(lambda fi, bi: jax_rot.roi_align_rotated(fi, bi, (7, 7), 1 / 16, 2))(f, jnp.asarray(boxes))

    want, vjp = jax.vjp(jax_pool, jnp.asarray(feats))
    f = _t(feats).requires_grad_(True)
    got = rot.roi_align_rotated(f, _t(boxes), (7, 7), 1 / 16, 2)
    got.backward(_t(g))
    _close(got.detach().numpy(), want)
    _close(f.grad.numpy(), vjp(jnp.asarray(g))[0])
    one = rot.roi_align_rotated(_t(feats[1]), _t(boxes[1]), (7, 7), 1 / 16, 2)  # one image's (H, W, C)
    torch.testing.assert_close(one, got[1].detach(), rtol=0, atol=0)


def test_the_rotated_box_transform_round_trips_and_wraps_angles_as_jax():
    r = np.random.RandomState(3)
    src = _random_boxes(r, 64, extent=200.0, size=80.0)
    tgt = _random_boxes(r, 64, extent=200.0, size=80.0)
    tgt[:8, 4] = [179.5, -179.5, 180.0, -180.0, 0.0, 90.0, -90.0, 135.0]
    src[:8, 4] = [-179.5, 179.5, -180.0, 180.0, 360.0, -270.0, 270.0, -225.0]
    ours, ref = Box2BoxTransformRotated(), JaxBox2BoxRotated()
    d = ours.get_deltas(_t(src), _t(tgt))
    want_d = np.asarray(ref.get_deltas(jnp.asarray(src), jnp.asarray(tgt)))
    for k in range(5):
        _close(d[:, k].numpy(), want_d[:, k])
    back = ours.apply_deltas(d, _t(src)).numpy()
    want_back = np.asarray(ref.apply_deltas(jnp.asarray(want_d), jnp.asarray(src)))
    for k in range(4):
        _close(back[:, k], want_back[:, k])
        _close(back[:, k], tgt[:, k], 1e-4)  # the round trip
    np.testing.assert_allclose(back[:, 4], want_back[:, 4], atol=1e-3)
    assert np.all(back[:, 4] >= -180.0) and np.all(back[:, 4] < 180.0)  # [-180, 180): fmod would keep +-180 signs
    wrapped = (tgt[:, 4] - back[:, 4] + 180.0) % 360.0 - 180.0
    np.testing.assert_allclose(wrapped, 0.0, atol=1e-3)
    k2 = r.randn(6, 2 * 5).astype(np.float32)  # two classes' deltas per box
    _close(ours.apply_deltas(_t(k2), _t(src[:6])).numpy()[:, :4],
           np.asarray(ref.apply_deltas(jnp.asarray(k2), jnp.asarray(src[:6])))[:, :4])


def _jax_module_params(module, seed, *args):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return fill_params(shapes, seed)


@pytest.mark.parametrize("cin, cout, stride", [(16, 16, 1), (16, 32, 2)])
def test_the_basic_block_equals_jax(cin, cout, stride):
    x = np.random.RandomState(4).randn(2, 10, 12, cin).astype(np.float32)
    block = JaxD2BasicBlock(out_channels=cout, stride=stride)
    params = _jax_module_params(block, 5, jnp.asarray(x))
    want = block.apply(params, jnp.asarray(x))
    state = convert_jax_params({"backbone": {"res2_0": params["params"]}})
    ours = D2BasicBlock(cin, cout, stride).eval()
    ours.load_state_dict({k[len("backbone.res2.0."):]: v for k, v in state.items()}, strict=True)
    got = ours(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.detach().numpy(), want)


def test_a_depth_18_tower_equals_jax():
    x = (np.random.RandomState(6).rand(1, 64, 96, 3).astype(np.float32) - 0.5) * 2
    tower = JaxD2ResNet(depth=18, out_features=("res2", "res4", "res5"))
    params = _jax_module_params(tower, 7, jnp.asarray(x))
    want = tower.apply(params, jnp.asarray(x))
    ours = D2ResNet(18).eval()
    state = convert_jax_params({"backbone": params["params"]})
    ours.load_state_dict({k[len("backbone."):]: v for k, v in state.items()}, strict=True)
    assert ours.out_channels == {"res2": 64, "res3": 128, "res4": 256, "res5": 512}
    got = ours(_t(x), ("res2", "res4", "res5"))
    for name in ("res2", "res4", "res5"):
        _close(got[name].detach().numpy(), want[name])


def test_a_d2_basic_block_file_loads_as_jax_loads_it(tmp_path):
    """A detectron2 R-18 FPN file (BasicBlocks: conv1, conv2 and shortcut
    with their norms, no conv3) with every tensor random: the port's
    `load_rcnn_weights` into a narrow depth-18 FPNRCNN equals JAX's
    `load_rcnn_weights` read through its modules, exactly."""
    from cddmsl_tpu.checkpoint.convert_torch import load_rcnn_weights as jax_load_rcnn_weights
    from cddmsl_torch.checkpoint.convert_torch import fc1_from_chw, load_rcnn_weights
    from cddmsl_torch.models.fpn_rcnn import FPNRCNN
    from test_torch_port_fpn import NARROW
    from test_torch_port_norms import _like

    ours = FPNRCNN(**{**NARROW, "depth": 18})
    assert ours.backbone.bottom_up.out_channels == {"res2": 64, "res3": 128, "res4": 256, "res5": 512}
    state = ours.state_dict()
    g = torch.Generator().manual_seed(4)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in state.items()}
    assert "backbone.bottom_up.res2.1.conv2.norm.running_var" in sd and not any(".conv3." in k for k in sd)
    fc1, c, r = "roi_heads.box_head.fc1.weight", NARROW["fpn_out_channels"], 7
    hwc = sd[fc1]
    sd[fc1] = hwc.reshape(-1, r, r, c).permute(0, 3, 1, 2).reshape(hwc.shape[0], -1)  # detectron2's CHW rows
    assert torch.equal(fc1_from_chw(sd[fc1], c, r), hwc)
    path = tmp_path / "r18_fpn.pth"
    torch.save({"model": sd}, path)
    assert load_rcnn_weights(ours, str(path)) == "d2_fpn"
    shapes = port_tree_shapes(ours)
    loaded = jax_load_rcnn_weights(fill_params(shapes, seed=5), str(path))
    want = convert_jax_params({"params": _like(loaded["params"], shapes["params"])})
    got = ours.state_dict()
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(got[fc1], hwc)


# ---------------- RotatedFastRCNN: one JAX program ----------------
B, HW, NUM_CLASSES, G = 2, 64, 5, 6


def _rotated_batch():
    r = np.random.RandomState(8)
    image = (r.rand(B, HW, HW, 3) * 255).astype(np.float32)
    gt = np.stack([r.uniform(12, 52, (B, G)), r.uniform(12, 52, (B, G)), r.uniform(12, 40, (B, G)),
                   r.uniform(8, 30, (B, G)), r.uniform(-180, 180, (B, G))], -1).astype(np.float32)
    valid = np.ones((B, G), bool)
    valid[1, 4:] = False
    gt[1, 4:] = 0.0
    classes = r.randint(0, NUM_CLASSES, (B, G)).astype(np.int32)
    sizes = np.full((B, 2), HW, np.int32)
    return image, sizes, gt, classes, valid


def _jax_draws(rng, n_anchors, n_proposals):
    """`RotatedFastRCNN.__call__(rng)`'s uniforms from the same key tree:
    k1, k2 = split(rng); the RRPN's split(k1, B), each split into its
    positive and negative uniforms; the heads' split(k2, B), each split
    into the sampler's key (itself split into two uniforms) and the
    gather's."""
    k1, k2 = jax.random.split(rng)
    out = {s: [] for s in ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg", "roi_gather")}
    for key in jax.random.split(k1, B):
        ka, kb = jax.random.split(key)
        out["rpn_pos"].append(jax.random.uniform(ka, (n_anchors,)))
        out["rpn_neg"].append(jax.random.uniform(kb, (n_anchors,)))
    n = n_proposals + G
    for key in jax.random.split(k2, B):
        ks, kg = jax.random.split(key)
        ka, kb = jax.random.split(ks)
        out["roi_pos"].append(jax.random.uniform(ka, (n,)))
        out["roi_neg"].append(jax.random.uniform(kb, (n,)))
        out["roi_gather"].append(jax.random.uniform(kg, (n,)))
    return {k: np.stack([np.asarray(a) for a in v]) for k, v in out.items()}


@pytest.fixture(scope="module")
def rotated_runs():
    image, sizes, gt, classes, valid = _rotated_batch()
    model = JaxRotatedFastRCNN(num_classes=NUM_CLASSES, depth=10, **D2_PIXELS)
    ours = RotatedFastRCNN(num_classes=NUM_CLASSES, depth=10, **D2_PIXELS).eval()
    params = fill_params(port_tree_shapes(ours, rules=convert_jax._ROTATED_RULES), seed=9)
    ours.load_state_dict(convert_jax_params(params), strict=True)
    jb = JaxRotatedDetBatch(*(jnp.asarray(a) for a in (image, sizes, gt, classes, valid)))
    rng = jax.random.PRNGKey(3)

    @jax.jit
    def run(p, b, key):
        return model.apply(p, b, key), model.apply(p, b, method=model.inference)

    losses, det = jax.device_get(run(params, jb, rng))
    n_anchors = (HW // 16) ** 2 * 60
    draws = _jax_draws(rng, n_anchors, 128)
    batch = RotatedDetBatch(*(_t(a) for a in (image, sizes, gt, classes, valid)))
    return dict(losses=losses, det=det, ours=ours, batch=batch, draws=draws)


def test_the_anchor_grid_equals_jax():
    np.testing.assert_array_equal(rotated_anchor_grid(3, 5, 16, (32, 64), (0.5, 1.0), (-90.0, 30.0)),
                                  jax_rotated_anchor_grid(3, 5, 16, (32, 64), (0.5, 1.0), (-90.0, 30.0)))


def test_the_rotated_losses_equal_jax(rotated_runs):
    draws = rotated_runs["draws"]

    def draw(site, shape):
        assert tuple(draws[site].shape) == tuple(shape), (site, shape)
        return _t(draws[site])

    got = rotated_runs["ours"](rotated_runs["batch"], draw)
    want = rotated_runs["losses"]
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]), rtol=1e-5, err_msg=name)
    assert all(float(v) > 0 for v in got.values())


def test_the_rotated_detections_equal_jax(rotated_runs):
    got = rotated_runs["ours"].inference(rotated_runs["batch"])
    want = rotated_runs["det"]
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)
    wb, gb = np.asarray(want.boxes), got.boxes.numpy()
    size = np.abs(wb[..., 2:4]).max(-1, keepdims=True)
    assert np.all(np.abs(gb[..., :4] - wb[..., :4]) <= 1e-3 + 1e-5 * size)
    np.testing.assert_allclose(gb[..., 4], wb[..., 4], rtol=0, atol=1e-3)
    assert got.valid.any()


def test_the_rotated_evaluator_equals_jax(monkeypatch):
    """Each image holds 5 ground-truth boxes and 9 detections of its one
    class, so JAX's IoU (jitted here: the same function) compiles once."""
    r = np.random.RandomState(10)
    name = "test_rotated_eval"
    MetadataCatalog.get(name).set(thing_classes=["a", "b"])
    from cddmsl_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog

    JaxMetadataCatalog.get(name).set(thing_classes=["a", "b"])
    monkeypatch.setattr(jax_rot, "pairwise_iou_rotated", jax_iou)
    ours, ref = RotatedCOCOEvaluator(name), JaxRotatedCOCOEvaluator(name)
    for img in range(4):
        gt = _random_boxes(r, 5, extent=400.0, size=120.0)
        gt[:, 2:4] *= [[1.0, 1.0], [0.2, 0.2], [2.0, 2.0], [1.0, 1.0], [0.5, 0.5]]  # small, medium and large
        gc = np.full(5, img % 2)
        det = np.concatenate([gt + r.randn(5, 5).astype(np.float32) * [2, 2, 2, 2, 5],
                              _random_boxes(r, 4, extent=400.0, size=120.0)])
        dc, ds = np.full(9, img % 2), r.rand(9)
        for ev in (ours, ref):
            ev.process_gt(img, gt, gc)
            ev.process(img, det, ds, dc)
    got, want = ours.evaluate(), ref.evaluate()
    assert set(got) == set(want) == {"bbox"}
    assert set(got["bbox"]) == set(want["bbox"])
    for k, v in want["bbox"].items():
        np.testing.assert_allclose(got["bbox"][k], v, atol=1e-9, err_msg=k)
    ours.process_gt(9, EDGE_A[:1], [0], iscrowd=[True])
    ours.process(9, EDGE_A[:1], [0.9], [0])
    with pytest.raises(NotImplementedError, match="crowd"):
        ours.evaluate()


def _rotated_cfgs():
    ours, ref = get_cfg(), jax_get_cfg()
    for cfg in (ours, ref):
        cfg.merge_from_file(str(ROTATED_YAML))
    return ours, ref


def test_the_rotated_file_builds_as_jax_and_is_refused_for_training():
    ours, ref = _rotated_cfgs()
    fields, want = rotated_fast_rcnn_fields(ours), jax_build_model(ref)
    assert type(want).__name__ == "RotatedFastRCNN"
    for name in ("num_classes", "depth", "pixel_mean", "pixel_std"):
        assert fields[name] == (tuple(getattr(want, name)) if name.startswith("pixel") else getattr(want, name))
    assert str(fields["dtype"]).split(".")[-1] == jnp.dtype(want.dtype).name
    with torch.device("meta"):
        model = build_detector(ours, device="meta")
    assert isinstance(model, RotatedFastRCNN) and model.backbone.out_channels["res4"] == 256
    assert model.proposal_generator.rpn_head.conv.weight.shape == (1024, 256, 3, 3)
    with pytest.raises(NotImplementedError, match=r"MODEL\.META_ARCHITECTURE"):
        check_supported(ours, world=1)


def test_jax_trainer_cannot_build_the_rotated_model():
    """JAX's DefaultTrainer calls the module's init_all, which RotatedFastRCNN lacks."""
    _, ref = _rotated_cfgs()
    ref.TPU.PAD_SIZE_TRAIN = [64, 64]
    with pytest.raises(AttributeError, match="init_all"):
        JaxDefaultTrainer(ref)
