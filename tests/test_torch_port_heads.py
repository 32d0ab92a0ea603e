"""The linear-head C4 detector of the port against cddmsl_tpu on the CPU:
the linear and class-agnostic box predictor, soft-NMS, the plain tower
(`D2ResNet`), the whole detector with the linear head on both towers, the
converters on the new names, the configs the port now accepts and the
FREEZE_AT fault both packages share.

The same inputs, made with numpy from a seed, go through the JAX function
and the port's counterpart, in float32. Tolerances, and why:
- `FastRCNNOutputLayers` (linear, class-agnostic), its losses and
  `fast_rcnn_inference_single_image`: atol 1e-5 (float32 matmuls and sums
  in another order); detections with equal valid masks and classes, boxes
  in pixels (up to 150) also within rtol 1e-6 (the exp of a delta rounds
  an ulp apart, 1.5e-5 at 128 px);
- soft-NMS, all three methods: the kept indices exactly, the decayed scores
  within 1e-6 (the same float32 IoUs and decay chain);
- `D2ResNet` at depth 10 and 50 on one small image: res4, res5 and
  `res5_forward` within 1e-4 (convolutions summed in another order, through
  up to 16 blocks);
- the whole tiny detector, linear head, on each tower: one inference
  (proposals within 1e-3 px, detections as test_torch_port_inference.py
  ranks them) and one step with JAX's draws replayed: losses rtol 1e-4,
  every parameter after the step within 1e-6, as
  `test_accum_steps_2_equals_jax` holds them (one JAX compile per tower:
  the step and the inference in one program).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg, _synthetic_batch
from cddmsl_tpu.checkpoint.convert_torch import convert_box_predictor, convert_d2_resnet
from cddmsl_tpu.config import add_ateacher_config as jax_add_ateacher_config
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.engine import TrainState, make_train_step
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.backbone.clip_resnet import ModifiedResNet as JaxModifiedResNet
from cddmsl_tpu.models.backbone.resnet import D2ResNet as JaxD2ResNet
from cddmsl_tpu.models.fast_rcnn import FastRCNNOutputLayers as JaxFastRCNNOutputLayers
from cddmsl_tpu.models.fast_rcnn import fast_rcnn_inference_single_image as jax_inference_single_image
from cddmsl_tpu.models.fast_rcnn import fast_rcnn_losses as jax_fast_rcnn_losses
from cddmsl_tpu.ops.box_regression import Box2BoxTransform as JaxBox2Box
from cddmsl_tpu.ops.soft_nms import batched_soft_nms as jax_batched_soft_nms
from cddmsl_tpu.ops.soft_nms import soft_nms as jax_soft_nms
from cddmsl_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_tpu.solver.build import path_is_frozen, trainable_mask
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.checkpoint.convert_torch import load_rcnn_weights
from cddmsl_torch.config import add_ateacher_config, check_supported, get_cfg, model_config_from_cfg
from cddmsl_torch.config import solver_config_from_cfg
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.models.backbone.clip_resnet import ModifiedResNet
from cddmsl_torch.models.backbone.resnet import D2ResNet
from cddmsl_torch.models.build import build_model
from cddmsl_torch.models.fast_rcnn import FastRCNNOutputLayers, fast_rcnn_inference, fast_rcnn_losses
from cddmsl_torch.ops.box_regression import Box2BoxTransform
from cddmsl_torch.ops.soft_nms import batched_soft_nms, soft_nms
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_backbone import fill_params, jax_param_shapes
from test_torch_port_inference import (
    BOX_ATOL, SCORE_ATOL, TIE_GAP, _assert_ranked_rows_match, inference_and_head_inputs,
)
from test_torch_port_train import _jax_draws, _replay, _torch_batch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
QUICK = REPO / "configs" / "quick_schedules"
K = 20
WEIGHTS = (10.0, 10.0, 5.0, 5.0)
D2_PIXELS = ([103.53, 116.28, 123.675], [57.375, 57.12, 58.395])  # unit-range inputs for the filled weights


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(r, shape, w=160.0, h=128.0):
    x1, y1 = r.rand(*shape) * w * 0.7, r.rand(*shape) * h * 0.7
    bw, bh = 4 + r.rand(*shape) * w * 0.5, 4 + r.rand(*shape) * h * 0.5
    return np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)


def tiny_linear_cfg(tower: str):
    """The JAX tree of the tests' tiny detector with the linear classifier on
    the CLIP tower ("clip") or on the plain ResNet at depth 10 ("d2")."""
    cfg = _flagship_cfg(tiny=True)
    cfg.MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER = False
    cfg.MODEL.CLIP.FOCAL_SCALED_LOSS = None
    cfg.MODEL.CLIP.BG_CLS_LOSS_WEIGHT = None
    if tower == "d2":
        cfg.MODEL.BACKBONE.NAME = "build_resnet_backbone"
        cfg.MODEL.RESNETS.DEPTH = 10
        cfg.TPU.BACKBONE_LAYERS, cfg.TPU.BACKBONE_WIDTH, cfg.TPU.EMBED_DIM = [], 0, 0
        cfg.TPU.ENABLE_CAPTION_CONSISTENCY = False
        cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD = D2_PIXELS
    return cfg


# ---------------- the box predictor ----------------
@pytest.mark.parametrize("agnostic", [False, True])
def test_linear_box_predictor_forward_and_losses_equal_jax(agnostic):
    r = np.random.RandomState(1)
    n, d = 96, 64
    x = r.randn(n, d).astype(np.float32)
    head = JaxFastRCNNOutputLayers(num_classes=K, input_size=d, use_text_emb=False, cls_agnostic_bbox_reg=agnostic)
    params = fill_params(jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=2)
    want_scores, want_deltas = head.apply(params, jnp.asarray(x))
    ours = FastRCNNOutputLayers(K, d, use_text_emb=False, cls_agnostic_bbox_reg=agnostic)
    state = convert_jax_params({"roi_heads": {"box_predictor": params["params"]}})
    ours.load_state_dict({k[len("roi_heads.box_predictor."):]: v for k, v in state.items()}, strict=True)
    scores, deltas = ours(_t(x))
    assert scores.shape == (n, K + 1) and deltas.shape == (n, 4 if agnostic else 4 * K)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(want_scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(deltas.detach().numpy(), np.asarray(want_deltas), rtol=0, atol=1e-5)

    props = _boxes(r, (n,))
    gts = props + (r.randn(n, 4) * 3).astype(np.float32)
    classes = r.randint(0, K + 1, n).astype(np.int32)
    valid = r.rand(n) > 0.2
    args = (np.asarray(want_scores), np.asarray(want_deltas), props, gts, classes, valid)
    want = jax_fast_rcnn_losses(*map(jnp.asarray, args), K, JaxBox2Box(WEIGHTS))
    got = fast_rcnn_losses(*map(_t, args), K, Box2BoxTransform(WEIGHTS))
    for name in ("loss_cls", "loss_box_reg"):
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=0, atol=1e-5)
    assert got["loss_box_reg"].item() > 0


@pytest.mark.parametrize("agnostic, soft", [(False, None), (True, None), (True, "gaussian"), (False, "linear")])
def test_detection_inference_equals_jax(agnostic, soft):
    """`fast_rcnn_inference` over two images against JAX's
    `fast_rcnn_inference_single_image` on each, with class-specific or
    class-agnostic deltas, through the NMS or the soft-NMS (its decayed
    scores are the detections')."""
    r = np.random.RandomState(3 + agnostic)
    b, n = 2, 64
    scores = (r.randn(b, n, K + 1) * 3).astype(np.float32)
    deltas = (r.randn(b, n, 4 if agnostic else 4 * K) * 0.3).astype(np.float32)
    props = _boxes(r, (b, n))
    valid = r.rand(b, n) > 0.1
    hw = np.array([[128, 160], [112, 150]], np.int32)
    kw = dict(score_thresh=0.05, nms_thresh=0.5, topk_per_image=100)
    got = fast_rcnn_inference(*map(_t, (scores, deltas, props, valid, hw)), Box2BoxTransform(WEIGHTS), K, **kw,
                              soft_nms=(soft, 0.5, 0.001) if soft else None)
    assert got.valid.sum() > 0
    for i in range(b):
        want = jax_inference_single_image(
            *map(jnp.asarray, (scores[i], deltas[i], props[i], valid[i], hw[i])), JaxBox2Box(WEIGHTS), K, **kw,
            soft_nms_enabled=soft is not None, soft_nms_method=soft or "gaussian")
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.classes[i].numpy(), np.asarray(want.classes))
        np.testing.assert_allclose(got.boxes[i].numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got.scores[i].numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)


# ---------------- soft-NMS ----------------
def _clustered(r, n=48, centers=6):
    c = r.rand(centers, 2) * 80
    pick = c[r.randint(centers, size=n)] + r.randn(n, 2) * 3
    wh = 10 + r.rand(n, 2) * 15
    return np.concatenate([pick, pick + wh], 1).astype(np.float32), (0.05 + r.rand(n) * 0.95).astype(np.float32)


@pytest.mark.parametrize("method", ["gaussian", "linear", "hard"])
def test_soft_nms_equals_jax(method):
    """Two images of clustered boxes (chains of decays), a row marked
    invalid, `max_out` above the boxes that survive the prune; then the
    class-aware form over 3 classes."""
    r = np.random.RandomState(7)
    boxes, scores = zip(*(_clustered(r) for _ in range(2)))
    boxes, scores = np.stack(boxes), np.stack(scores)
    valid = r.rand(*scores.shape) > 0.1
    kw = dict(method=method, gaussian_sigma=0.5, linear_threshold=0.3, prune_threshold=0.05, max_out=48)
    got = soft_nms(_t(boxes), _t(scores), valid=_t(valid), **kw)
    classes = r.randint(0, 3, scores.shape).astype(np.int32)
    got_b = batched_soft_nms(_t(boxes), _t(scores), _t(classes), valid=_t(valid), **kw)
    for i in range(2):
        bx, sc, cl, ok = (jnp.asarray(a[i]) for a in (boxes, scores, classes, valid))
        for ours, want in ((got, jax_soft_nms(bx, sc, valid=ok, **kw)),
                           (got_b, jax_batched_soft_nms(bx, sc, cl, valid=ok, **kw))):
            idx, new_scores, keep = (np.asarray(a) for a in want)
            np.testing.assert_array_equal(ours[2][i].numpy(), keep)
            np.testing.assert_array_equal(ours[0][i].numpy(), idx)
            np.testing.assert_allclose(ours[1][i].numpy(), new_scores, rtol=0, atol=1e-6)
            assert 0 < keep.sum() < kw["max_out"]  # the prune or the invalid rows end it early


# ---------------- the plain tower ----------------
@pytest.mark.parametrize("depth", [10, 50])
def test_d2_resnet_equals_jax(depth):
    """res4 and res5 of the tower asked for [res4, res5] and `res5_forward`
    on crops, on one 64x96 image; asked for nothing, it stops at res4."""
    r = np.random.RandomState(depth)
    x = r.randn(1, 64, 96, 3).astype(np.float32)
    crops = r.randn(3, 14, 14, 1024).astype(np.float32)
    ref = JaxD2ResNet(depth=depth, out_features=("res4", "res5"))

    def both(m, x, c):
        return m(x), m.res5_forward(c)

    params = fill_params(jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(crops),
                                                         method=both)), seed=depth)
    want, want_crops = jax.jit(lambda p, x, c: ref.apply(p, x, c, method=both))(params, x, crops)
    ours = D2ResNet(depth).eval()
    state = convert_jax_params({"backbone": params["params"]})
    ours.load_state_dict({k[len("backbone."):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got, got_crops = ours(_t(x), ("res4", "res5")), ours.res5_forward(_t(crops))
        assert set(ours(_t(x))) == {"res4"}
    assert set(got) == set(want) == {"res4", "res5"}
    assert got["res4"].shape == (1, 4, 6, 1024) and got["res5"].shape == (1, 2, 3, 2048)
    for name in ("res4", "res5"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got_crops.numpy(), np.asarray(want_crops), rtol=0, atol=1e-4)


def test_clip_tower_res5_output_equals_jax():
    """OUT_FEATURES [res4, res5] on the CLIP tower: both maps of the
    tower's forward against JAX's backbone dict; the detector asks for res4
    alone."""
    x = np.random.RandomState(5).randn(1, 64, 96, 3).astype(np.float32)
    ref = JaxModifiedResNet(layers=(1, 1, 1, 1), output_dim=128, heads=8, width=16, out_features=("res4", "res5"))
    params = fill_params(jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=4)
    want = jax.jit(ref.apply)(params, x)
    ours = ModifiedResNet((1, 1, 1, 1), 128, 8, 16).eval()
    state = convert_jax_params({"backbone": params["params"]})
    own = ours.state_dict()
    # JAX's tower here holds no attention pool
    ours.load_state_dict({k: state.get("backbone." + k, own[k]) for k in own}, strict=True)
    with torch.no_grad():
        got = ours(_t(x), ("res4", "res5"))
    assert set(got) == set(want) == {"res4", "res5"}
    for name in ("res4", "res5"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=1e-4, err_msg=name)

    cfg = tiny_linear_cfg("clip")
    cfg.MODEL.RESNETS.OUT_FEATURES = ["res4", "res5"]
    model = build_model(model_config_from_cfg(cfg), device="cpu")
    asked = []
    model.backbone.register_forward_hook(lambda m, args, out: asked.append(sorted(out)))
    model.extract_res4(torch.zeros(1, 64, 96, 3))
    assert asked == [["res4"]]


# ---------------- the whole detector ----------------
@pytest.fixture(scope="module", params=["clip", "d2"])
def detector_runs(request):
    """One JAX program per tower: the inference on two images (the second
    padded) and one training step past burn-up with the caption branches
    where the tower has them."""
    tower = request.param
    cfg = tiny_linear_cfg(tower)
    model = jax_build_model(cfg)
    b, h, w, g = 2, 64, 96, 8
    jb = _synthetic_batch(b, h, w, g=g, seed=2)
    jb = jb._replace(image_sizes=jnp.asarray([[64, 96], [56, 80]], jnp.int32))
    params = fill_params(jax_param_shapes(model_config_from_cfg(cfg)), seed=9)
    head = params["params"]["proposal_generator"]["head"]
    for name in ("objectness_logits", "anchor_deltas"):  # the 0.01 std of the RPN head's own init
        head[name]["kernel"] = head[name]["kernel"] / 4
    burnup = cfg.SOLVER.CAPTION_BURNUP_ITERS
    caption = cfg.TPU.ENABLE_CAPTION_CONSISTENCY
    optimizer = jax_build_optimizer(cfg, params)
    state = TrainState.create(params, optimizer).replace(step=jnp.asarray(burnup + 1, jnp.int32))
    step_fn = make_train_step(model, optimizer, enable_caption=caption, caption_burnup_iters=burnup,
                              lr_schedule=jax_build_lr_schedule(cfg), donate=False)

    def run(m, batch):
        return inference_and_head_inputs(m, batch)[1:]

    rng = jax.random.PRNGKey(3)
    (want_props, want_dets), (new_state, want_metrics) = jax.jit(
        lambda p, s, batch, r: (model.apply(p, batch, method=run), step_fn.__wrapped__(s, batch, r))
    )(params, state, jb, rng)

    config = model_config_from_cfg(cfg)
    serve = build_model(config, device="cpu")
    weights = convert_jax_params(params)
    serve.load_state_dict({k: v for k, v in weights.items() if k in serve.state_dict()}, strict=True)
    tb = _torch_batch(jb)
    got_props, got_dets = serve.proposals(tb)[1], serve.inference(tb)

    ours = build_model(config, device="cpu", training=True)
    ours.load_state_dict(weights, strict=True)
    before = {k: v.clone() for k, v in ours.state_dict().items()}
    trainer = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(cfg)), caption_burnup_iters=burnup,
                      iteration=burnup + 1, enable_caption=caption)
    draws = _jax_draws(rng, b, (h // 16) * (w // 16) * 15, cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN, g)
    got_metrics = trainer.train_step(tb, _replay(draws))
    mask = trainable_mask(params, use_text_emb=False)
    trainable = convert_jax_params(jax.tree_util.tree_map(lambda m, p: np.full(p.shape, m, np.float32), mask, params))
    return dict(tower=tower, want=(want_props, want_dets, want_metrics, convert_jax_params(new_state.params)),
                got=(got_props, got_dets, got_metrics, ours.state_dict()), before=before, trainable=trainable,
                model=ours)


def test_detector_inference_equals_jax(detector_runs):
    want_props, want_dets = detector_runs["want"][:2]
    got_props, got_dets = detector_runs["got"][:2]
    np.testing.assert_array_equal(got_props.valid.numpy(), np.asarray(want_props.valid))
    np.testing.assert_array_equal(got_dets.valid.numpy(), np.asarray(want_dets.valid))
    assert got_dets.valid.sum() > 0
    for i in range(2):
        _assert_ranked_rows_match(
            got_props.scores[i].numpy(), got_props.boxes[i].numpy(), np.asarray(want_props.scores[i]),
            np.asarray(want_props.boxes[i]), TIE_GAP["proposal"], lambda g, w: np.abs(g - w).max() <= BOX_ATOL)
        rows = lambda d: [(int(c), np.asarray(b), float(s)) for c, b, s in
                          zip(np.asarray(d.classes[i]), np.asarray(d.boxes[i]), np.asarray(d.scores[i]))]
        _assert_ranked_rows_match(
            got_dets.scores[i].numpy(), rows(got_dets), np.asarray(want_dets.scores[i]), rows(want_dets),
            TIE_GAP["detection"],
            lambda g, w: g[0] == w[0] and np.abs(g[1] - w[1]).max() <= BOX_ATOL and abs(g[2] - w[2]) <= SCORE_ATOL)


def test_detector_step_equals_jax(detector_runs):
    """The losses (with the caption branches' on the CLIP tower: the region
    branch pools with the attention pool whatever the classifier) and every
    parameter after the step; the linear classifier trains."""
    want_metrics, want_params = detector_runs["want"][2:]
    metrics, state = detector_runs["got"][2:]
    names = {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "total_loss", "lr"}
    if detector_runs["tower"] == "clip":
        names |= {"cont_loss", "kd_loss", "cont_loss_region"}
    assert set(metrics) == set(want_metrics) == names
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-4, err_msg=k)
    assert state.keys() == want_params.keys()
    before, trainable = detector_runs["before"], detector_runs["trainable"]
    for name, value in state.items():
        np.testing.assert_allclose(value.numpy(), want_params[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
        if not trainable[name].any():
            assert torch.equal(value, before[name]), f"frozen {name} changed"
    for name, p in detector_runs["model"].named_parameters():
        assert p.requires_grad == bool(trainable[name].all()), name
    assert detector_runs["model"].roi_heads.box_predictor.cls_score.bias.requires_grad


# ---------------- converters ----------------
@pytest.mark.parametrize("tower, agnostic", [("clip", False), ("d2", False), ("d2", True)])
def test_jax_trees_convert_both_ways(tower, agnostic):
    """The port's training build read back through the inverse of
    `convert_jax_params` is `eval_shape` of JAX's `init_all`, leaf for leaf,
    and a filled JAX tree converts onto every tensor of the build."""
    cfg = tiny_linear_cfg(tower)
    cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = agnostic
    model = jax_build_model(cfg)
    jb = _synthetic_batch(1, 64, 96, g=4, seed=0)
    want = jax.eval_shape(lambda r, b: model.init({"params": r}, b, r, method=model.init_all),
                          jax.random.PRNGKey(0), jb)
    got = jax_param_shapes(model_config_from_cfg(cfg))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    ours = build_model(model_config_from_cfg(cfg), device="cpu", training=True)
    ours.load_state_dict(convert_jax_params(fill_params(want)), strict=True)
    assert ours.roi_heads.box_predictor.bbox_pred.weight.shape[0] == (4 if agnostic else 4 * K)


def test_a_d2_rcnn_file_loads_the_plain_tower_and_the_linear_head(tmp_path):
    """detectron2's names (backbone.stem.conv1, its norm, backbone.res{s}.{i}
    convs, shortcut and norms) give what JAX's `convert_d2_resnet` makes of
    them, through `convert_jax_params`; the linear cls_score's weight and
    bias load as the file holds them (K + 1 rows, as `convert_box_predictor`
    reads the weight)."""
    cfg = tiny_linear_cfg("d2")
    ours = build_model(model_config_from_cfg(cfg), device="cpu")
    r = np.random.RandomState(0)
    # the plain tower's state names are detectron2's
    sd = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32)) for k, v in ours.state_dict().items()}
    path = tmp_path / "model_final.pth"
    torch.save({"model": sd}, path)
    assert load_rcnn_weights(ours, str(path)) == "d2_rcnn"
    numpy_sd = {k: v.numpy() for k, v in sd.items()}
    want = convert_jax_params({"backbone": convert_d2_resnet(numpy_sd)})
    state = ours.state_dict()
    assert {k for k in state if k.startswith("backbone.")} == set(want)
    for name, value in want.items():
        torch.testing.assert_close(state[name], value, rtol=0, atol=0, msg=name)
    box = convert_box_predictor(numpy_sd)["box_predictor"]
    np.testing.assert_array_equal(state["roi_heads.box_predictor.cls_score.weight"].numpy(), box["cls_score_weight"])
    np.testing.assert_array_equal(state["roi_heads.box_predictor.bbox_pred.weight"].numpy(),
                                  box["bbox_pred"]["kernel"].T)
    for name in ("roi_heads.box_predictor.cls_score.bias", "proposal_generator.rpn_head.conv.weight"):
        torch.testing.assert_close(state[name], sd[name], rtol=0, atol=0, msg=name)


# ---------------- the optimizer's frozen set ----------------
def test_freeze_at_does_not_reach_the_d2_tower_in_either_package():
    """A fault both packages share: FREEZE_AT names the CLIP tower's stem
    and `layer{i}_` stages only, so at FREEZE_AT 2 the plain tower's stem
    and res2 train (detectron2 freezes them); only its FrozenBN statistics
    stay. The CLIP tower's stem does freeze, in both."""
    for path in (("params", "backbone", "stem_conv1", "kernel"), ("params", "backbone", "res2_0", "conv1", "kernel"),
                 ("params", "backbone", "res3_0", "conv1", "kernel")):
        assert not path_is_frozen(path, 2, False, set())
    assert path_is_frozen(("params", "backbone", "conv1", "kernel"), 2, False, set())
    assert path_is_frozen(("params", "backbone", "layer1_0", "conv1", "kernel"), 2, False, set())
    cfg = tiny_linear_cfg("d2")
    assert cfg.MODEL.BACKBONE.FREEZE_AT == 2
    params = fill_params(jax_param_shapes(model_config_from_cfg(cfg)))
    mask = convert_jax_params(jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m, np.float32), trainable_mask(params, 2, use_text_emb=False), params))
    ours = build_model(model_config_from_cfg(cfg), device="cpu", training=True)
    build_optimizer(ours, solver_config_from_cfg(cfg))
    trainable = {n for n, p in ours.named_parameters() if p.requires_grad}
    assert trainable == {n for n, m in mask.items() if m.all()}
    assert {"backbone.stem.conv1.weight", "backbone.res2.0.conv1.weight",
            "roi_heads.box_predictor.cls_score.weight"} <= trainable
    assert all(not mask[n].any() for n in mask if ".norm." in n)  # FrozenBN: buffers here, frozen there


# ---------------- the configs the port accepts ----------------
ACCEPTED = [REPO / "configs" / p for p in (
    "VOC-Experiments/faster_rcnn_R_50_C4.yaml", "PascalVOC-Detection/faster_rcnn_R_50_C4.yaml",
    "VOC-Experiments/faster_rcnn_CLIP_R_50_C4_cap_gen.yaml")] + [QUICK / f"{n}.yaml" for n in (
        "rcnn_instant_test", "rcnn_training_acc_test", "rcnn_inference_acc_test", "mt_rcnn_instant_test",
        "mt_rcnn_training_acc_test", "rcnn_consistency_image_instant_test",
        "rcnn_consistency_image_region_instant_test", "rcnn_caption_pl_instant_test",
        "rcnn_caption_pl_region_instant_test")]


def _both(path):
    ours, ref = get_cfg(), jax_get_cfg()
    add_ateacher_config(ours)
    jax_add_ateacher_config(ref)
    ours.merge_from_file(str(path))
    ref.merge_from_file(str(path))
    return ours, ref


@pytest.mark.parametrize("path", ACCEPTED, ids=lambda p: p.stem)
def test_the_config_is_accepted_and_maps_to_the_jax_build(path):
    """Accepted at world 1 (TPU.MESH_SHAPE [8] and [4] included), and the
    fields JAX's builder derives are the port's."""
    ours, ref = _both(path)
    check_supported(ours, world=1)
    config, want = model_config_from_cfg(ours), jax_build_model(ref)
    assert config.backbone_type == want.backbone_type
    if config.backbone_type == "d2_resnet":
        assert config.backbone_depth == want.backbone_depth and config.embed_dim == want.embed_dim == 2048
    for field in ("backbone_width", "num_classes", "use_text_emb", "cls_agnostic_bbox_reg", "soft_nms_enabled",
                  "soft_nms_method", "soft_nms_sigma", "soft_nms_prune", "pixel_mean", "pixel_std",
                  "nms_thresh_test", "score_thresh_test"):
        assert getattr(config, field) == pytest.approx(getattr(want, field)), field


def _plain():
    cfg = get_cfg()
    cfg.merge_from_file(str(ACCEPTED[0]))
    check_supported(cfg, world=1)
    return cfg


@pytest.mark.parametrize("key, value", [
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True]), ("MODEL.RESNETS.DEPTH", 18),
    ("MODEL.RESNETS.DEPTH", 34), ("MODEL.RESNETS.STRIDE_IN_1X1", False), ("MODEL.RESNETS.NUM_GROUPS", 32),
    ("MODEL.RESNETS.WIDTH_PER_GROUP", 8), ("MODEL.RESNETS.RES5_DILATION", 4), ("MODEL.RESNETS.STEM_OUT_CHANNELS", 128),
    ("MODEL.RESNETS.RES2_OUT_CHANNELS", 64), ("MODEL.RESNETS.NORM", "GN"), ("MODEL.RESNETS.OUT_FEATURES", ["res5"]),
    ("TPU.ENABLE_CAPTION_CONSISTENCY", True), ("MODEL.CONSISTENCY_BRANCH", "image"), ("TPU.BACKBONE_WIDTH", 16),
    ("TPU.EMBED_DIM", 1024), ("MODEL.PRE_TRAINED_RCLIP_PATH", "rclip.pth"), ("MODEL.ROI_HEADS.SOFT_NMS_METHOD", "box"),
    ("MODEL.CLIP.BB_RPN_WEIGHTS", "rpn.pth"),
])
def test_the_plain_tower_refuses_what_it_does_not_compute_naming_the_key(key, value):
    cfg = _plain()
    cfg.merge_from_list([key, repr(value) if not isinstance(value, str) else value])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        check_supported(cfg, world=1)


# refused until the CLIP FPN bottom-up was ported: the name takes the file to JAX's FPNRCNN over CLIP's RN50
@pytest.mark.parametrize("key, value", [("MODEL.BACKBONE.NAME", "build_clip_resnet_fpn_backbone")])
def test_the_plain_tower_file_under_the_clip_fpn_name_builds_jax_fpnrcnn(key, value):
    from cddmsl_torch.config import model_family
    from cddmsl_torch.models.build import fpn_rcnn_fields

    ours, ref = _both(ACCEPTED[0])
    for c in (ours, ref):
        c.merge_from_list([key, value])
    check_supported(ours, world=1)
    want = jax_build_model(ref)
    assert model_family(ours) == "fpn" and type(want).__name__ == "FPNRCNN"
    fields = fpn_rcnn_fields(ours)
    assert fields["backbone_type"] == want.backbone_type == "clip"
    assert fields["num_classes"] == want.num_classes and fields["backbone_width"] == (want.backbone_width or 64)
