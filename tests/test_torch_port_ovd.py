"""RegionCLIP's open-vocabulary detector in the port against cddmsl_tpu on
the CPU: `CLIPFastRCNN` (the frozen offline RPN on a plain ResNet, the CLIP
recognition branch), its builder on the eight `CLIP_fast_rcnn_*` configs,
`load_bb_rpn_weights`, the NO_BOX_DELTA and MULTIPLY_RPN_SCORE options of
the detection stage, and four faults of the JAX package on this arch, each
shown in JAX beside what the port does.

The same inputs, made with numpy from a seed, go through both packages in
float32. Tolerances, and why:
- the tiny `CLIPFastRCNN` (CLIP tower (1, 1, 1, 1) at width 16, embedding
  512, offline ResNet at depth 10, 64 / 32 offline proposals) from JAX's
  filled tree through `convert_jax_params`, in one JAX program: inference
  (NO_BOX_DELTA, so the boxes are the offline RPN's proposals) with the
  classes exactly, the scores within 1e-5 and the boxes within 1e-3 px, as
  test_torch_port_inference.py ranks them (ties matched as a set): the
  objectness logits through ten layers of the plain ResNet differ by float
  order alone (~3e-6), and the decoded boxes up to 5e-4 px, so 1e-4 px
  does not hold; `supervised_losses` with JAX's draws replayed, losses
  rtol 1e-4 and each trainable parameter's gradient against `jax.grad`
  within 1e-4 of that tensor's largest gradient, and never less than 1e-5
  (the largest difference is 1.6e-5 on a tensor whose largest gradient is
  0.25); the offline modules get no gradient (exactly 0 in JAX);
- `load_bb_rpn_weights` from one seeded detectron2 file in both packages:
  the loaded tensors exactly, the offline proposals within 1e-3 px;
- `detection_candidates` / `fast_rcnn_inference` with the two options
  against JAX's `fast_rcnn_inference_single_image`: kept rows and classes
  exactly, boxes and scores within 1e-5.
"""

import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from cddmsl_tpu.checkpoint.convert_torch import load_bb_rpn_weights as jax_load_bb_rpn_weights
from cddmsl_tpu.checkpoint.convert_torch import load_rcnn_weights as jax_load_rcnn_weights
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.engine.defaults import DefaultTrainer as JaxDefaultTrainer
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.clip_rcnn import CLIPFastRCNN as JaxCLIPFastRCNN
from cddmsl_tpu.models.fast_rcnn import fast_rcnn_inference_single_image as jax_inference_single_image
from cddmsl_tpu.ops.box_regression import Box2BoxTransform as JaxBox2Box
from cddmsl_tpu.solver.build import path_is_frozen, trainable_mask
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params, init_random_
from cddmsl_torch.checkpoint.convert_torch import load_bb_rpn_weights, load_rcnn_weights, load_text_emb_classifier
from cddmsl_torch.config import SolverConfig, check_clip_fast_rcnn_supported, check_supported, get_cfg
from cddmsl_torch.engine.defaults import DefaultPredictor, DefaultTrainer, default_argument_parser
from cddmsl_torch.models.build import build_clip_fast_rcnn, clip_fast_rcnn_fields
from cddmsl_torch.models.clip_rcnn import CLIPFastRCNN
from cddmsl_torch.models.fast_rcnn import fast_rcnn_inference
from cddmsl_torch.ops.box_regression import Box2BoxTransform
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_backbone import fill_params
from test_torch_port_inference import SCORE_ATOL, TIE_GAP, _assert_ranked_rows_match
from test_torch_port_train import _torch_batch
from torch_goldens import jax_draw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
OVD_CONFIGS = sorted((REPO / "configs").glob("*/CLIP_fast_rcnn_*.yaml"))
K = 20
BOX_ATOL = 1e-3  # pixels
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # of each tensor's largest gradient, and the least
# the tiny detector: the ovd recipe's classifier options and the zsinf
# recipe's boxes, with unit-range inputs to the offline ResNet
TINY = dict(backbone_layers=(1, 1, 1, 1), backbone_width=16, embed_dim=512, num_classes=K, offline_depth=10,
            rpn_post_nms_topk=(64, 32), offline_rpn_nms_thresh=0.9, focal_gamma=0.5, bg_loss_weight=0.2,
            no_box_delta=True, cls_agnostic_bbox_reg=True, offline_pixel_std=(57.375, 57.12, 58.395))
OFFLINE = ("offline_backbone.", "offline_proposal_generator.")


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch():
    """Two 64x96 images, the second's true size 56x80 inside the pad, each
    original size its true size (JAX's CLIPFastRCNN does not rescale)."""
    jb = _synthetic_batch(2, 64, 96, g=4, seed=4, with_trgt=False)
    sizes = jnp.asarray([[64, 96], [56, 80]], jnp.int32)
    return jb._replace(image_sizes=sizes, orig_sizes=sizes)


@pytest.fixture(scope="module")
def tiny_tree():
    """JAX's tiny CLIPFastRCNN, its filled tree (eval_shape, no compile) and
    the batch."""
    model = JaxCLIPFastRCNN(**TINY)
    jb = _batch()
    shapes = jax.eval_shape(lambda r, b: model.init(r, b, r), jax.random.PRNGKey(0), jb)
    params = fill_params(shapes, seed=11)
    head = params["params"]["offline_proposal_generator"]["head"]
    for name in ("objectness_logits", "anchor_deltas"):  # near the 0.01 std of the RPN head's own init
        head[name]["kernel"] = head[name]["kernel"] / 4
    return model, params, jb


def _port_model(params):
    ours = CLIPFastRCNN(**TINY)
    ours.load_state_dict(convert_jax_params(params), strict=True)
    return ours.eval()


def _write_bb_rpn_file(path, seed):
    """A detectron2 R-CNN file of a seeded plain ResNet (depth 10) and RPN
    head under detectron2's names (backbone.stem.*, backbone.res{s}.*,
    proposal_generator.rpn_head.*)."""
    src = init_random_(CLIPFastRCNN(**TINY), torch.Generator().manual_seed(seed))
    sd = {}
    for k, v in src.state_dict().items():
        if k.startswith("offline_backbone."):
            sd["backbone." + k[len("offline_backbone."):]] = v
        elif k.startswith("offline_proposal_generator.rpn_head."):
            sd["proposal_generator." + k[len("offline_proposal_generator."):]] = v
    torch.save({"model": sd, "iteration": 0}, path)
    return sd


@pytest.fixture(scope="module")
def ovd_runs(tiny_tree, tmp_path_factory):
    """One JAX program: the gradient of `supervised_losses`, `inference`,
    and the offline proposals of the tree that `load_bb_rpn_weights` gave;
    the same in the port."""
    model, params, jb = tiny_tree
    path = str(tmp_path_factory.mktemp("bb_rpn") / "rpn.pth")
    sd = _write_bb_rpn_file(path, seed=3)
    bb_params = jax_load_bb_rpn_weights(params, path)
    rng = jax.random.PRNGKey(5)

    def total(p, b, r):
        losses = model.apply(p, b, r, method=model.supervised_losses)
        return sum(losses.values()), losses

    resized = _resized(jb)
    (grads, losses), dets, bb_props, resized_dets = jax.jit(lambda p, bbp, b, rb, r: (
        jax.grad(total, has_aux=True)(p, b, r), model.apply(p, b, method=model.inference),
        model.apply(bbp, b, False, method=model._proposals), model.apply(p, rb, method=model.inference),
    ))(params, bb_params, jb, resized, rng)

    tb = _torch_batch(jb)
    ours = _port_model(params)
    got_dets = ours.inference(tb)
    with torch.enable_grad():
        got_losses = ours.supervised_losses(tb, jax_draw(rng, rng))
        sum(got_losses.values()).backward()
    bb_ours = _port_model(params)
    n_loaded = load_bb_rpn_weights(bb_ours, path)
    return dict(want=(losses, convert_jax_params(grads), dets, bb_props, convert_jax_params(bb_params)),
                got=(got_losses, ours, got_dets, bb_ours.offline_proposals(tb), bb_ours), sd=sd, n_loaded=n_loaded,
                resized=(resized_dets, ours.inference(_torch_batch(resized))))


def _resized(jb):
    """The batch as resized images: each original twice its resized size."""
    return jb._replace(orig_sizes=jb.image_sizes * 2)


def _rows(d, i):
    return [(int(c), np.asarray(b), float(s)) for c, b, s in
            zip(np.asarray(d.classes[i]), np.asarray(d.boxes[i]), np.asarray(d.scores[i]))]


def test_clip_fast_rcnn_inference_equals_jax(ovd_runs):
    want, got = ovd_runs["want"][2], ovd_runs["got"][2]
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 0 and got.boxes.shape == (2, 100, 4)
    for i in range(2):
        _assert_ranked_rows_match(
            got.scores[i].numpy(), _rows(got, i), np.asarray(want.scores[i]), _rows(want, i), TIE_GAP["detection"],
            lambda g, w: g[0] == w[0] and np.abs(g[1] - w[1]).max() <= BOX_ATOL and abs(g[2] - w[2]) <= SCORE_ATOL)


def test_clip_fast_rcnn_losses_and_gradients_equal_jax(ovd_runs):
    want_losses, want_grads = ovd_runs["want"][:2]
    got_losses, ours = ovd_runs["got"][:2]
    assert set(got_losses) == set(want_losses) == {"loss_cls", "loss_box_reg"}
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    trainable = [(n, p) for n, p in ours.named_parameters() if p.requires_grad]
    assert len(trainable) > 20 and not any(n.startswith(OFFLINE) for n, _ in trainable)
    for name, p in trainable:
        want = want_grads[name].numpy()
        atol = max(GRAD_ATOL, GRAD_RTOL * np.abs(want).max())
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=atol, err_msg=name)
    assert any(np.abs(want_grads[n].numpy()).max() > 0 for n, _ in trainable)


def test_no_gradient_reaches_the_offline_modules(ovd_runs):
    """JAX's stop_gradient and the non-differentiable proposals give the
    offline tower and RPN an exact zero; the port's hold no trainable
    parameter and get no gradient."""
    want_grads, ours = ovd_runs["want"][1], ovd_runs["got"][1]
    offline = [n for n in want_grads if n.startswith(OFFLINE)]
    assert len(offline) > 20
    for name in offline:
        assert not want_grads[name].numpy().any(), name
    for name, p in ours.named_parameters():
        if name.startswith(OFFLINE):
            assert not p.requires_grad and p.grad is None, name


def test_bb_rpn_weights_load_as_in_jax(ovd_runs):
    """A detectron2 file's backbone.* and proposal_generator.rpn_head.* in
    both packages: every offline tensor equal to what JAX's loader made of
    it, and the offline proposals equal."""
    want_state, want_props = ovd_runs["want"][4], ovd_runs["want"][3]
    got_props, bb_ours = ovd_runs["got"][3:]
    state = bb_ours.state_dict()
    offline = [k for k in state if k.startswith(OFFLINE)]
    assert ovd_runs["n_loaded"] == len(ovd_runs["sd"]) == len(offline)
    for name in offline:
        torch.testing.assert_close(state[name], want_state[name], rtol=0, atol=0, msg=name)
    np.testing.assert_array_equal(got_props.valid.numpy(), np.asarray(want_props.valid))
    assert got_props.valid.sum() > 0
    for i in range(2):
        _assert_ranked_rows_match(
            got_props.scores[i].numpy(), got_props.boxes[i].numpy(), np.asarray(want_props.scores[i]),
            np.asarray(want_props.boxes[i]), TIE_GAP["proposal"], lambda g, w: np.abs(g - w).max() <= BOX_ATOL)


def test_the_port_rescales_where_jax_does_not(ovd_runs):
    """On resized images (originals twice the resized size) the detections
    of both packages stay in the resized frame, equal as on the unresized
    batch: JAX's CLIPFastRCNN.inference does not rescale, and the port
    keeps that for parity (ROADMAP §C), unlike GeneralizedRCNN in both."""
    want, got = ovd_runs["resized"]
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 0
    for i in range(2):
        _assert_ranked_rows_match(
            got.scores[i].numpy(), _rows(got, i), np.asarray(want.scores[i]), _rows(want, i), TIE_GAP["detection"],
            lambda g, w: g[0] == w[0] and np.abs(g[1] - w[1]).max() <= BOX_ATOL and abs(g[2] - w[2]) <= SCORE_ATOL)
    torch.testing.assert_close(got.boxes, ovd_runs["got"][2].boxes, rtol=0, atol=0)


# ---------------- the builder and its config ----------------
def _both(path):
    ours, ref = get_cfg(), jax_get_cfg()
    ours.merge_from_file(str(path))
    ref.merge_from_file(str(path))
    return ours, ref


@pytest.mark.parametrize("path", OVD_CONFIGS, ids=lambda p: f"{p.parent.name[:4]}-{p.stem}")
def test_build_clip_fast_rcnn_takes_the_jax_builders_fields(path):
    ours, ref = _both(path)
    fields, want = clip_fast_rcnn_fields(ours), jax_build_model(ref)
    assert isinstance(want, JaxCLIPFastRCNN)
    for name, value in fields.items():
        expect = getattr(want, name)
        if name == "dtype":
            assert str(value).split(".")[-1] == jnp.dtype(expect).name
        else:
            assert value == (tuple(expect) if isinstance(expect, (list, tuple)) else expect), name
    # what the builder leaves at the module's defaults, the same in both
    defaults = {k: p.default for k, p in inspect.signature(CLIPFastRCNN).parameters.items()}
    for name in ("offline_depth", "rpn_post_nms_topk", "offline_pixel_mean", "offline_pixel_std",
                 "offline_input_bgr"):
        expect = getattr(want, name)
        assert name not in fields and defaults[name] == (tuple(expect) if isinstance(expect, tuple) else expect)
    assert len(OVD_CONFIGS) == 8


def test_build_clip_fast_rcnn_builds_the_full_model_on_the_cpu():
    ours, _ = _both(REPO / "configs" / "LVISv1-InstanceSegmentation" / "CLIP_fast_rcnn_R_50_C4_zsinf.yaml")
    ours.merge_from_list(["TPU.COMPUTE_DTYPE", "float32"])
    with torch.device("meta"):
        model = CLIPFastRCNN(**clip_fast_rcnn_fields(ours))
    shapes = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    assert shapes["roi_heads.box_predictor.cls_score.weight"] == (1203, 1024)
    assert shapes["roi_heads.box_predictor.bbox_pred.weight"] == (4, 1024)
    assert shapes["offline_backbone.res4.5.conv3.weight"] == (1024, 256, 1, 1) and not any(k.startswith("offline_backbone.res5") for k in shapes)
    assert shapes["offline_proposal_generator.rpn_head.objectness_logits.weight"] == (15, 1024, 1, 1)
    assert model.offline_rpn_nms_thresh == 0.9 and model.roi_heads.no_box_delta
    assert build_clip_fast_rcnn.__defaults__ == ("cuda",)


@pytest.mark.parametrize("key, value", [
    ("MODEL.CLIP.MULTIPLY_RPN_SCORE", True), ("MODEL.ROI_HEADS.SOFT_NMS_ENABLED", True),
    ("TPU.BACKBONE_LAYERS", [1, 1, 1, 1]), ("TPU.BACKBONE_WIDTH", 16), ("TPU.EMBED_DIM", 512),
    ("MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 128), ("MODEL.RPN.POST_NMS_TOPK_TEST", 300),
    ("MODEL.RPN.NMS_THRESH", 0.5), ("MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER", False),
    ("MODEL.ANCHOR_GENERATOR.SIZES", [[64, 128, 256]]), ("MODEL.RESNETS.DEPTH", 10),
])
def test_clip_fast_rcnn_refuses_what_jax_ignores_naming_the_key(key, value):
    ours, _ = _both(OVD_CONFIGS[0])
    check_clip_fast_rcnn_supported(ours)
    ours.merge_from_list([key, repr(value)])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        clip_fast_rcnn_fields(ours)


# ---------------- the detection stage's options ----------------
# (no_box_delta, multiply, agnostic); NO_BOX_DELTA alone is the tiny CLIPFastRCNN's above
OPTION_CASES = [(False, True, False), (True, True, True)]


def _option_inputs(case):
    no_box_delta, multiply, agnostic = case
    r = np.random.RandomState(7 + 2 * no_box_delta + multiply)
    b, n, k = 2, 64, 5
    scores = (r.randn(b, n, k + 1) * 3).astype(np.float32)
    deltas = (r.randn(b, n, 4 if agnostic else 4 * k) * 0.2).astype(np.float32)
    x1, y1 = r.rand(b, n) * 60, r.rand(b, n) * 40
    props = np.stack([x1, y1, x1 + 8 + r.rand(b, n) * 40, y1 + 8 + r.rand(b, n) * 30], -1).astype(np.float32)
    valid = r.rand(b, n) > 0.1
    logits = (r.randn(b, n) * 2 + 1).astype(np.float32)
    return scores, deltas, props, valid, np.array([[64, 96], [56, 80]], np.int32), logits


@pytest.fixture(scope="module")
def option_runs():
    """JAX's `fast_rcnn_inference_single_image` on every case's two images,
    vmapped, all cases in one program."""

    def run(*args):
        out = []
        for (no_box_delta, multiply, _), inputs in zip(OPTION_CASES, args):
            out.append(jax.vmap(lambda s, d, p, v, h, lg, nbd=no_box_delta, m=multiply: jax_inference_single_image(
                s, d, p, v, h, JaxBox2Box((10, 10, 5, 5)), 5, score_thresh=0.05, nms_thresh=0.5, topk_per_image=20,
                no_box_delta=nbd, rpn_scores=lg, multiply_rpn_score=m))(*inputs))
        return out

    inputs = [_option_inputs(case) for case in OPTION_CASES]
    return inputs, jax.jit(run)(*[tuple(map(jnp.asarray, x)) for x in inputs])


@pytest.mark.parametrize("case", range(len(OPTION_CASES)),
                         ids=[f"no_box_delta={a}-multiply={b}-agnostic={c}" for a, b, c in OPTION_CASES])
def test_head_options_equal_jax(case, option_runs):
    """Two images' candidates through the NMS with NO_BOX_DELTA and / or
    MULTIPLY_RPN_SCORE, against JAX image by image. About a third of the
    proposals have a negative objectness logit: with MULTIPLY_RPN_SCORE
    their rows drop out in both (NaN scores), and no detection comes from
    one."""
    no_box_delta, multiply, _ = OPTION_CASES[case]
    (scores, deltas, props, valid, hw, logits), wants = option_runs[0][case], option_runs[1][case]
    got = fast_rcnn_inference(_t(scores), _t(deltas), _t(props), _t(valid), _t(hw), Box2BoxTransform((10, 10, 5, 5)),
                              5, score_thresh=0.05, nms_thresh=0.5, topk_per_image=20, no_box_delta=no_box_delta,
                              rpn_scores=_t(logits), multiply_rpn_score=multiply)
    for i in range(2):
        want = jax.tree_util.tree_map(lambda a: a[i], wants)
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.classes[i].numpy(), np.asarray(want.classes))
        np.testing.assert_allclose(got.boxes[i].numpy(), np.asarray(want.boxes), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.scores[i].numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)
        kept = got.valid[i].numpy()
        assert kept.sum() > 0 and np.isfinite(got.scores[i].numpy()).all()
        if multiply:
            assert (logits[i] < 0).sum() > 10
            # a kept score is sqrt(prob * logit) of a positive logit: its square is at most the logit
            assert (got.scores[i].numpy()[kept] ** 2 <= logits[i].max() + 1e-5).all()
        if no_box_delta:
            boxes = got.boxes[i].numpy()[kept]
            clipped = np.minimum(np.maximum(props[i], 0), [hw[i][1], hw[i][0]] * 2)
            assert all(np.abs(clipped - bx).max(axis=1).min() <= 1e-5 for bx in boxes)


# ---------------- the JAX package's faults on this arch ----------------
def test_jax_trainer_cannot_build_clip_fast_rcnn(tmp_path):
    """JAX's DefaultTrainer asks the module for init_all, which CLIPFastRCNN
    lacks; the port's trainer, predictor and train_net refuse the arch,
    naming the key."""
    _, ref = _both(OVD_CONFIGS[-1])
    ref.OUTPUT_DIR = str(tmp_path / "jax")
    with pytest.raises(AttributeError, match="init_all"):
        JaxDefaultTrainer(ref)
    ours, _ = _both(OVD_CONFIGS[-1])
    ours.OUTPUT_DIR = str(tmp_path / "port")
    for build in (lambda: check_supported(ours), lambda: DefaultTrainer(ours, device="cpu"),
                  lambda: DefaultPredictor(ours, device="cpu")):
        with pytest.raises(NotImplementedError, match=r"MODEL\.META_ARCHITECTURE.*JAX's trainer"):
            build()
    args = default_argument_parser().parse_args(
        ["--device", "cpu", "--eval-only", "--config-file", str(OVD_CONFIGS[-1]), "OUTPUT_DIR", str(tmp_path / "cli")])
    with pytest.raises(NotImplementedError, match=r"MODEL\.META_ARCHITECTURE"):
        train_net.main(args)


def test_jax_freeze_rules_miss_the_offline_rpn(tiny_tree):
    """JAX's optimizer mask freezes the offline tower but not the offline
    RPN head, so an optimizer built on this tree would decay it; the port
    freezes both."""
    _, params, _ = tiny_tree
    mask = convert_jax_params(jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m, np.float32), trainable_mask(params), params))
    assert not path_is_frozen(("params", "offline_proposal_generator", "head", "conv", "kernel"))
    assert path_is_frozen(("params", "offline_backbone", "res2_0", "conv1", "kernel"))
    rpn = [n for n in mask if n.startswith("offline_proposal_generator.")]
    assert len(rpn) == 6 and all(mask[n].all() for n in rpn)
    ours = _port_model(params)
    optimizer = build_optimizer(ours, SolverConfig())
    in_optimizer = {id(p) for p in optimizer.params}
    for name, p in ours.named_parameters():
        if name.startswith(OFFLINE):
            assert not p.requires_grad and id(p) not in in_optimizer, name
    assert {n for n, p in ours.named_parameters() if p.requires_grad} == {
        n for n in mask if mask[n].all() and not n.startswith(OFFLINE)}


def test_jax_load_rcnn_weights_fails_on_clip_fast_rcnn(tiny_tree, tmp_path):
    """A d2_rcnn file: JAX looks for `proposal_generator` in the tree and
    raises KeyError; the port raises naming the fault. An oai_clip file: JAX
    merges the CLIP names into the offline plain tower, where nothing reads
    them; the port loads the CLIP tower and leaves the offline tower as it
    was. The text-embedding file fills the classifier rows."""
    _, params, _ = tiny_tree
    ours = _port_model(params)
    before = {k: v.clone() for k, v in ours.state_dict().items()}
    r = np.random.RandomState(2)
    clip = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32)) for k, v in before.items()
            if k.startswith("backbone.")}
    d2 = {**clip, **{"proposal_generator." + k[len("offline_proposal_generator."):]: v for k, v in before.items()
                     if k.startswith("offline_proposal_generator.")}}
    torch.save({"model": d2}, tmp_path / "d2.pth")
    with pytest.raises(KeyError, match="proposal_generator"):
        jax_load_rcnn_weights(params, str(tmp_path / "d2.pth"))
    with pytest.raises(ValueError, match="d2_rcnn.*CLIPFastRCNN"):
        load_rcnn_weights(ours, str(tmp_path / "d2.pth"))

    torch.save({"visual." + k[len("backbone."):]: v for k, v in clip.items()}, tmp_path / "clip.pth")
    merged = jax_load_rcnn_weights(params, str(tmp_path / "clip.pth"))["params"]["offline_backbone"]
    assert {"conv1", "layer1_0"} <= set(merged) and {"stem_conv1", "res2_0"} <= set(merged)
    assert load_rcnn_weights(ours, str(tmp_path / "clip.pth")) == "oai_clip"
    state = ours.state_dict()
    for name, value in before.items():
        if name in clip:
            torch.testing.assert_close(state[name], clip[name], rtol=0, atol=0, msg=name)
        else:
            assert torch.equal(state[name], value), name

    emb = torch.from_numpy(r.randn(K, TINY["embed_dim"]).astype(np.float32))
    torch.save(emb, tmp_path / "emb.pth")
    load_text_emb_classifier(ours, str(tmp_path / "emb.pth"))
    assert torch.equal(ours.roi_heads.box_predictor.cls_score.weight, emb)
