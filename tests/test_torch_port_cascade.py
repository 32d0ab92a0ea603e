"""Cascade R-CNN in the port against cddmsl_tpu on the CPU: the stage head
and its fc1 layout, both cascade programs (losses, every gradient,
detections and masks), the configs the port accepts with JAX's fields and
the keys it refuses.

Two JAX programs, each compiled once for its module-scoped fixture:
- the FPN Cascade Mask R-CNN (`FPNRCNN(cascade=True)`) at RESNETS.DEPTH 10
  and test_torch_port_fpn.py's narrow tower (the stages keep JAX's fixed
  fcs of 1024), with a mask head of 2 convs of 16, on test_torch_port_fpn.py's
  batches with diamond canvases;
- the C4 `CascadeRCNN` at RESNETS.DEPTH 10 (its res4 is 1024 channels
  wide: JAX's module has no narrower tower), on two 64x96 images.
Tolerances, as test_torch_port_fpn.py states them: losses rtol 1e-4; each
gradient within 1e-4 of its tensor's largest and never less than 1e-5;
detections as that file ranks them (scores 5e-5, boxes 1e-3 px, times the
rescale); mask probabilities within 2e-4 (the mask pool reads the
detection boxes, which differ by up to 1e-3 px after three refinements,
through two 3x3 convs; the Mask R-CNN test's 1e-4 misses by 1.1e-4 on one
pixel of 784 here).
The C4 program runs full-width (1024-channel) res4 and stage fcs from
random weights: its gradients are held within 2e-4 of each tensor's
largest (fc2 of a stage misses 1e-4 by 2e-5 on 4 of 1M elements: sums of
1024 terms in another order), and the RPN conv within 1e-4 on every output
channel but one, where a ReLU input within float noise of 0 takes the
other branch in one package.
The stage head alone: scores and deltas within 1e-5 of their largest value.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.checkpoint.convert_torch import convert_d2_fpn_rcnn
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.cascade_rcnn import CascadeRCNN as JaxCascadeRCNN
from cddmsl_tpu.models.cascade_rcnn import _StageHead as JaxStageHead
from cddmsl_tpu.models.fpn_rcnn import FPNRCNN as JaxFPNRCNN
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params, init_random_
from cddmsl_torch.checkpoint.convert_torch import load_rcnn_weights
from cddmsl_torch.config import check_supported, get_cfg, model_family
from cddmsl_torch.models.build import build_detector, cascade_rcnn_fields, fpn_rcnn_fields
from cddmsl_torch.models.cascade_rcnn import CascadeRCNN, CascadeROIHeads
from cddmsl_torch.models.fpn_rcnn import FPNRCNN
from test_torch_port_backbone import fill_params, port_tree_shapes
from test_torch_port_fpn import (
    BATCH_A, BATCH_B, D2_PIXELS, NARROW, assert_grads_match, assert_rows_match, close_detection, make_batch,
    torch_batch,
)
from test_torch_port_mask_rcnn import assert_masks_match, diamond_canvases
from torch_goldens import supervised_draw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FPN_CASCADE = {**NARROW, **D2_PIXELS, "cascade": True, "mask_on": True, "mask_num_conv": 2, "mask_conv_dim": 16}
# the mask head's convs and deconv: in this program JAX's reverse-mode
# gradient departs from JAX's own central difference of loss_mask by 0.11%
# (deconv.bias, eps 3e-2), where the port's (float32, and float64 within
# 1e-6 of it) agrees with that difference; the predictor, the losses and the
# forward pass agree to 1e-6
MASK_GRAD_RTOL = 3e-3
C4_GRAD_RTOL = 2e-4
STAGE_NAMES = {f"loss_{kind}_stage{i}" for kind in ("cls", "box_reg") for i in range(3)}
RPN_NAMES = {"loss_rpn_cls", "loss_rpn_loc"}


def cascade_filled(module, batch, seed, port):
    """The module's JAX tree filled by `fill_params`, the RPN head's outputs
    near its init's 0.01 std and each stage's box regressor at its 0.001;
    the tree's shapes read off the port's `port` (`port_tree_shapes`: those
    of `eval_shape` of JAX's `init_all`, without tracing it)."""
    shapes = port_tree_shapes(port)
    params = fill_params(shapes, seed=seed)
    tree = params["params"]
    for name in ("objectness_logits", "anchor_deltas"):
        tree["proposal_generator"]["head"][name]["kernel"] = tree["proposal_generator"]["head"][name]["kernel"] / 4
    for name, stage in tree["roi_heads"].items():
        if name.startswith("stage"):
            stage["bbox_pred"]["kernel"] = stage["bbox_pred"]["kernel"] * (0.001 / stage["bbox_pred"]["kernel"].std())
    return params


# ---------------- the stage head ----------------
def test_the_stage_head_and_its_fc1_layout_equal_jax():
    """A stage on (N, 7, 7, C) pooled maps: JAX flattens them NHWC, and the
    converted fc1 reads them so (no permutation between the trees); the
    class scores (K + 1) and the one box's deltas."""
    head = JaxStageHead(num_classes=5)
    x = np.random.RandomState(0).randn(6, 7, 7, 8).astype(np.float32)
    params = fill_params(jax.eval_shape(lambda r: head.init(r, jnp.asarray(x)), jax.random.PRNGKey(0)), seed=1)
    want_scores, want_deltas = head.apply(params, jnp.asarray(x))
    rh = CascadeROIHeads(num_classes=5, in_channels=8)
    state = convert_jax_params({"roi_heads": {f"stage{i}": params["params"] for i in range(3)}})
    rh.load_state_dict({k[len("roi_heads."):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        for i in range(3):
            scores, deltas = rh.box_predictor[i](rh.box_head[i](torch.from_numpy(x)))
            for got, want in ((scores, want_scores), (deltas, want_deltas)):
                want = np.asarray(want)
                np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert tuple(rh.box_predictor[0].cls_score.weight.shape) == (6, 1024)
    assert tuple(rh.box_predictor[0].bbox_pred.weight.shape) == (4, 1024)
    assert tuple(rh.box_head[0].fc1.weight.shape) == (1024, 7 * 7 * 8)


# ---------------- the FPN program ----------------
@pytest.fixture(scope="module")
def fpn_cascade_runs():
    ba = BATCH_A._replace(gt_masks=jnp.asarray(diamond_canvases(BATCH_A)))
    model, ours = JaxFPNRCNN(**FPN_CASCADE), FPNRCNN(**FPN_CASCADE)
    params = cascade_filled(model, ba, seed=31, port=ours)
    rng = jax.random.PRNGKey(5)

    def total(p, b, r):
        losses = model.apply(p, b, r, method=model.supervised_losses)
        return sum(losses.values()), losses

    (grads, losses), out_a, out_b = jax.jit(lambda p, a, b, r: (
        jax.grad(total, has_aux=True)(p, a, r), model.apply(p, a, method=model.inference),
        model.apply(p, b, method=model.inference),
    ))(params, ba, BATCH_B, rng)
    ours.load_state_dict(convert_jax_params(params), strict=True)
    with torch.no_grad():
        got = [ours.inference(torch_batch(jb)) for jb in (BATCH_A, BATCH_B)]
    with torch.enable_grad():
        tb = torch_batch(BATCH_A, gt_masks=torch.from_numpy(np.array(ba.gt_masks)).to(torch.uint8))
        got_losses = ours.supervised_losses(tb, supervised_draw(rng))
        sum(got_losses.values()).backward()
    return dict(want=(out_a, out_b, losses, convert_jax_params(grads)), got=(*got, got_losses), model=ours)


def test_fpn_cascade_losses_and_gradients_equal_jax(fpn_cascade_runs):
    """Three stages' cross-entropy and box losses, the RPN's and
    `loss_mask` (the stage-0 samples' leading foreground rows), and every
    parameter's gradient: the refined boxes are detached between stages,
    so each stage's gradient comes from its own losses."""
    want_losses, want_grads = fpn_cascade_runs["want"][2:]
    got_losses, model = fpn_cascade_runs["got"][2], fpn_cascade_runs["model"]
    assert set(got_losses) == set(want_losses) == STAGE_NAMES | RPN_NAMES | {"loss_mask"}
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].item(), float(v), rtol=1e-4, err_msg=k)
        assert float(v) > 0, k
    mask = {n for n, _ in model.named_parameters() if ".mask_head." in n and ".predictor." not in n}
    named = dict(model.named_parameters())
    assert_grads_match(model, {n: (named[n].grad if n in mask else g) for n, g in want_grads.items() if n in named})
    for name, p in model.named_parameters():
        if name in mask:
            want = want_grads[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=MASK_GRAD_RTOL * np.abs(want).max(),
                                       err_msg=name)


def test_fpn_cascade_detections_and_masks_equal_jax(fpn_cascade_runs):
    """The stages' mean softmax decoded with the last stage's boxes, both
    batches rescaled to their originals, and the masks of the final boxes."""
    for want, got, scale in zip(fpn_cascade_runs["want"][:2], fpn_cascade_runs["got"][:2], (2.0, 1.0)):
        assert_rows_match(got, want, "detection", close_detection(scale))
        assert got.masks.shape[2:] == (28, 28)
        assert_masks_match(got, want, 2e-4)


# ---------------- the C4 program ----------------
C4_BATCH = make_batch(2, 64, 96, [[64, 96], [48, 80]], [[128, 192], [96, 160]], seed=4)


@pytest.fixture(scope="module")
def c4_cascade_runs():
    model = JaxCascadeRCNN(num_classes=NARROW["num_classes"], depth=10, pixel_std=D2_PIXELS["pixel_std"])
    ours = CascadeRCNN(num_classes=NARROW["num_classes"], depth=10, pixel_std=D2_PIXELS["pixel_std"])
    params = cascade_filled(model, C4_BATCH, seed=33, port=ours)
    rng = jax.random.PRNGKey(7)

    def total(p, b, r):
        losses = model.apply(p, b, r, method=model.losses)
        return sum(losses.values()), losses

    (grads, losses), det = jax.jit(lambda p, b, r: (
        jax.grad(total, has_aux=True)(p, b, r), model.apply(p, b, method=model.inference)))(params, C4_BATCH, rng)
    ours.load_state_dict(convert_jax_params(params), strict=True)
    tb = torch_batch(C4_BATCH)
    got = {}

    def infer():
        with torch.no_grad():
            got["det"] = ours.inference(tb)

    def step():
        with torch.enable_grad():
            got["losses"] = ours.losses(tb, supervised_draw(rng))
            sum(got["losses"].values()).backward()

    # the step and the eval batch, recorded as phase 18 records them (the C4
    # case of `test_kernel_calls_are_what_a_cascade_step_and_eval_batch_launch`)
    with pytest.MonkeyPatch.context() as mp:
        calls = (recorded_kernel_calls(mp, "step", step), recorded_kernel_calls(mp, "eval", infer))
    return dict(want=(det, losses, convert_jax_params(grads)), got=(got["det"], got["losses"]), model=ours,
                calls=calls)


def test_c4_cascade_losses_and_gradients_equal_jax(c4_cascade_runs):
    """The C4 CascadeRCNN on res4 (the RPN of the module's defaults, 128
    samples an image): eight losses and every parameter's gradient."""
    _, want_losses, want_grads = c4_cascade_runs["want"]
    got_losses, model = c4_cascade_runs["got"][1], c4_cascade_runs["model"]
    assert set(got_losses) == set(want_losses) == STAGE_NAMES | RPN_NAMES
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    assert model.roi_heads.batch_size_per_image == 128 and len(model.roi_heads.pooler.scales) == 1
    named = dict(model.named_parameters())
    conv = "proposal_generator.rpn_head.conv."
    assert_grads_match(model, {n: (named[n].grad if n.startswith(conv) else g) for n, g in want_grads.items()
                               if n in named}, rtol=C4_GRAD_RTOL)
    # the RPN conv: every output channel but at most one (a ReLU input
    # within float noise of 0 takes the other branch there) as the rest
    off = set()
    for part in ("weight", "bias"):
        got, want = named[conv + part].grad.numpy(), want_grads[conv + part].numpy()
        atol = max(1e-5, 1e-4 * np.abs(want).max())
        bad = np.abs(got - want).reshape(len(got), -1).max(1) > atol
        off |= set(np.nonzero(bad)[0].tolist())
    assert len(off) <= 1, sorted(off)


def test_c4_cascade_detections_equal_jax(c4_cascade_runs):
    """Its detections, rescaled to the originals (twice the images' size)."""
    want, got = c4_cascade_runs["want"][0], c4_cascade_runs["got"][0]
    assert_rows_match(got, want, "detection", close_detection(2.0))


# ---------------- the converters ----------------
def test_neither_packages_d2_loaders_take_the_cascade_stages(tmp_path):
    """A detectron2 Cascade Mask R-CNN FPN file (d2_fpn: roi_heads.box_head.
    {i}.fc1, box_predictor.{i}.*) and a C4 cascade one (d2_rcnn): JAX's
    `convert_d2_fpn_rcnn` makes no stage of it, and the port's loaders
    leave the stages as they were; the rest of the FPN file (mask head
    included) loads."""
    fpn = init_random_(FPNRCNN(num_classes=3, depth=10, backbone_width=8, res2_out_channels=32, fpn_out_channels=32,
                               cascade=True, mask_on=True, mask_num_conv=1, mask_conv_dim=8),
                       torch.Generator().manual_seed(0))
    r = np.random.RandomState(1)
    sd = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32)) for k, v in fpn.state_dict().items()}
    assert "roi_heads.box_head.2.fc1.weight" in sd and "roi_heads.box_predictor.0.cls_score.weight" in sd
    tree = convert_d2_fpn_rcnn({k: v.numpy() for k, v in sd.items()})
    assert not any(k.startswith(("stage", "box_head")) for k in tree["roi_heads"]) and "mask_head" in tree["roi_heads"]
    before = {k: v.clone() for k, v in fpn.state_dict().items()}
    torch.save({"model": sd}, tmp_path / "cascade_fpn.pth")
    assert load_rcnn_weights(fpn, str(tmp_path / "cascade_fpn.pth")) == "d2_fpn"
    for name, value in fpn.state_dict().items():
        stage = name.startswith(("roi_heads.box_head.", "roi_heads.box_predictor."))
        assert torch.equal(value, before[name] if stage else sd[name]), name

    c4 = init_random_(CascadeRCNN(num_classes=3, depth=10), torch.Generator().manual_seed(2))
    sd = {k: torch.from_numpy(r.randn(*v.shape).astype(np.float32)) for k, v in c4.state_dict().items()}
    before = {k: v.clone() for k, v in c4.state_dict().items()}
    torch.save({"model": sd}, tmp_path / "cascade_c4.pth")
    assert load_rcnn_weights(c4, str(tmp_path / "cascade_c4.pth")) == "d2_rcnn"
    after = c4.state_dict()
    for name in after:
        stage = name.startswith(("roi_heads.box_head.", "roi_heads.box_predictor."))
        assert torch.equal(after[name], before[name] if stage else sd[name]), name


# ---------------- the configs ----------------
def _cfg(path, *opts):
    ours, ref = get_cfg(), jax_get_cfg()
    for c in (ours, ref):
        c.merge_from_file(str(REPO / "configs" / path))
        c.merge_from_list(list(opts))
    return ours, ref


ACCEPTED = ("Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml", "Misc/cascade_mask_rcnn_R_50_FPN_3x.yaml",
            "quick_schedules/cascade_mask_rcnn_R_50_FPN_instant_test.yaml", "Misc/cascade_rcnn_R_50_C4_1x.yaml")


@pytest.mark.parametrize("path", ACCEPTED, ids=lambda p: Path(p).stem)
def test_cascade_configs_are_accepted_with_the_jax_builders_fields(path):
    """Accepted at world 1; the FPN files build FPNRCNN(cascade=True) with
    every field JAX's `build_fpn_rcnn` gives, the C4 file CascadeRCNN with
    `build_cascade_rcnn`'s; the detector built on the meta device with
    three stages (and a mask head on FPN)."""
    ours, ref = _cfg(path)
    check_supported(ours, world=1)
    want = jax_build_model(ref)
    c4 = model_family(ours) == "cascade_c4"
    assert type(want).__name__ == ("CascadeRCNN" if c4 else "FPNRCNN")
    fields = cascade_rcnn_fields(ours) if c4 else fpn_rcnn_fields(ours)
    assert c4 or fields["cascade"]
    for name, value in fields.items():
        expect = getattr(want, name)
        if name == "dtype":
            assert str(value).split(".")[-1] == jnp.dtype(expect).name
        elif name == "backbone_width":
            assert value == (expect or 64), name
        else:
            assert value == (tuple(expect) if isinstance(expect, (list, tuple)) else expect), name
    with torch.device("meta"):
        model = build_detector(ours, device="meta")
    assert type(model).__name__ == type(want).__name__ and len(model.roi_heads.box_head) == 3
    assert (model.roi_heads.mask_head is None) == c4


def test_the_cascade_meta_architecture_builds_the_c4_cascade():
    """MODEL.META_ARCHITECTURE CascadeRCNN, as JAX's registry maps it, and
    ROI_BOX_CASCADE_HEAD.IOUS of two stages, which JAX's C4 builder reads
    (the last stage's transform still decodes, as in JAX's module)."""
    ours, ref = _cfg("Misc/cascade_rcnn_R_50_C4_1x.yaml", "MODEL.META_ARCHITECTURE", "CascadeRCNN",
                     "MODEL.ROI_BOX_CASCADE_HEAD.IOUS", "[0.5, 0.65]")
    check_supported(ours, world=1)
    assert model_family(ours) == "cascade_c4" and type(jax_build_model(ref)).__name__ == "CascadeRCNN"
    assert cascade_rcnn_fields(ours)["stage_ious"] == tuple(jax_build_model(ref).stage_ious) == (0.5, 0.65)
    with torch.device("meta"):
        model = build_detector(ours, device="meta")
    assert len(model.roi_heads.box_head) == 2 and model.roi_heads.box2box[-1].weights == (30.0, 30.0, 15.0, 15.0)


@pytest.mark.parametrize("path, key, value", [
    ("Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml", "MODEL.KEYPOINT_ON", True),
    ("Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml", "MODEL.ROI_BOX_CASCADE_HEAD.IOUS", [0.5, 0.55, 0.6]),
    ("Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml", "MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS",
     [[10.0, 10.0, 5.0, 5.0], [20.0, 20.0, 10.0, 10.0], [40.0, 40.0, 20.0, 20.0]]),
    ("Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml", "MODEL.ROI_BOX_HEAD.FC_DIM", 512),
    ("Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml", "MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE", "giou"),
    ("Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml", "MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK", True),
    ("Misc/cascade_rcnn_R_50_C4_1x.yaml", "MODEL.MASK_ON", True),
    ("Misc/cascade_rcnn_R_50_C4_1x.yaml", "MODEL.KEYPOINT_ON", True),
    ("Misc/cascade_rcnn_R_50_C4_1x.yaml", "MODEL.ROI_BOX_CASCADE_HEAD.IOUS", [0.5, 0.6, 0.7, 0.8]),
    ("Misc/cascade_rcnn_R_50_C4_1x.yaml", "MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS",
     [[1.0, 1.0, 1.0, 1.0], [20.0, 20.0, 10.0, 10.0], [30.0, 30.0, 15.0, 15.0]]),
    ("Misc/cascade_rcnn_R_50_C4_1x.yaml", "MODEL.RESNETS.DEPTH", 18),
    ("Misc/cascade_rcnn_R_50_C4_1x.yaml", "MODEL.RPN.BBOX_REG_LOSS_TYPE", "giou"),
    ("COCO-Detection/faster_rcnn_R_50_DC5_1x.yaml", "MODEL.ROI_HEADS.NAME", "CascadeROIHeads"),
])
def test_the_cascade_refuses_what_jax_leaves_out_naming_the_key(path, key, value):
    """Keypoints on a cascade (JAX asserts on FPN; its C4 cascade has
    none), IOUS on FPN (not passed) and more than three stages on C4 (JAX's
    module has three transforms), other BBOX_REG_WEIGHTS (no builder reads
    them), the FPN stages' fixed fcs, box loss and class-specific masks,
    masks on C4 (not built), the RPN's loss on C4 (module defaults), and
    the DC5 file with the cascade heads, which JAX's `build_model` sends to
    the C4 cascade: its res4 has no dilation to take (RES5_DILATION 2 is
    named)."""
    ours = _cfg(path)[0]
    ours.merge_from_list([key, value if isinstance(value, str) else repr(value)])
    # DC5 with the cascade heads is JAX's C4 cascade, which reads no dilation
    refused = "MODEL.RESNETS.RES5_DILATION" if "DC5" in path else key
    with pytest.raises(NotImplementedError, match=refused.replace(".", r"\.")):
        check_supported(ours, world=1)


@pytest.mark.parametrize("path, key", [
    # the deformable stages are ported: the file is refused for its 32 groups, with which JAX's deformable block
    # fails at init (test_torch_port_dconv.py; its id kept from before). The panoptic dconv-GN-cascade file is
    # accepted (test_torch_port_dconv_panoptic.py)
    pytest.param("Misc/cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml", "MODEL.RESNETS.NUM_GROUPS",
                 id="cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv-MODEL.RESNETS.DEFORM_ON_PER_STAGE"),
])
def test_the_gn_and_deformable_cascade_files_stay_refused(path, key):
    cfg = get_cfg()
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        cfg.merge_from_file(str(REPO / "configs" / path))
        check_supported(cfg, world=1)


# ---------------- chip_smoke.py's phase 18 ----------------
def recorded_kernel_calls(monkeypatch, what, run, candidates_seed=3):
    """`run()` under `chip_smoke.KernelCalls.recording(what)`, the models'
    RoIAlign and RPN NMS wrapped (outside the recorder) to keep what they
    return. Each recorded RoIAlign call replayed through the plain version
    gives what the model got, bit for bit, and each recorded RPN NMS keeps
    what the model kept; the detection NMS is recorded on its
    class-shifted boxes with seeded scores, every candidate valid. The
    recorder puts the functions back. Returns the `KernelCalls`."""
    import chip_smoke
    from cddmsl_torch.models import fast_rcnn, poolers, roi_heads, rpn
    from cddmsl_torch.ops.roi_align import roi_align_batched_plain

    pooled, kept = [], []
    for module in (poolers, roi_heads):
        def keep(*args, _real=module.roi_align_batched):
            out = _real(*args)
            pooled.append(out.detach().clone())
            return out

        monkeypatch.setattr(module, "roi_align_batched", keep)

    def keep_nms(*args, _real=rpn.nms, **kwargs):
        out = _real(*args, **kwargs)
        kept.append(out)
        return out

    monkeypatch.setattr(rpn, "nms", keep_nms)
    wrapped = (poolers.roi_align_batched, roi_heads.roi_align_batched, rpn.nms, fast_rcnn.batched_nms)
    calls = chip_smoke.KernelCalls(candidates_seed)
    with calls.recording(what):
        run()
    assert (poolers.roi_align_batched, roi_heads.roi_align_batched, rpn.nms, fast_rcnn.batched_nms) == wrapped
    assert len(calls.pools) == len(pooled) and set(calls.k3) <= {call for call, *_ in calls.pools}
    for (call, features, batch_idx, boxes, size, scale), out in zip(calls.pools, pooled):
        assert call.startswith(what), call
        np.testing.assert_array_equal(
            roi_align_batched_plain(features, batch_idx, boxes, (size, size), scale, 0, True).numpy(), out.numpy())
    rpn_calls = calls.nms[:len(kept)]
    for (boxes, scores, valid, thr, k), (idx, ok) in zip(rpn_calls, kept):
        from cddmsl_torch.ops.nms import nms

        got_idx, got_ok = nms(boxes, scores, thr, k, valid=valid)
        assert torch.equal(got_ok, ok) and torch.equal(torch.where(ok, got_idx, 0), torch.where(ok, idx, 0))
    for boxes, scores, valid, thr, k in calls.nms[len(kept):]:
        assert bool(valid.all()) and bool(((scores >= 0.05) & (scores < 1)).all()) and boxes.shape[:2] == scores.shape
    return calls


@pytest.mark.parametrize("kind", ["fpn", "c4"])
def test_kernel_calls_are_what_a_cascade_step_and_eval_batch_launch(kind, monkeypatch, request):
    """Phase 18 checks K1, K3 and K4 at the calls that `KernelCalls` records
    (`recorded_kernel_calls` holds each against what the model got): a
    cascade step's three stage pools per level (each stage on the boxes the
    earlier stages refined) and the FPN's mask pool, all with a gradient,
    and its RPN NMS; an eval batch's pools without a gradient, its RPN NMS
    and its detection NMS. The FPN cascade takes a trainer's step from a
    seeded init; the full-width C4 cascade's step and eval batch are those
    of its JAX comparison (`c4_cascade_runs`), recorded there."""
    import chip_smoke
    from cddmsl_torch.config import SolverConfig
    from cddmsl_torch.engine.train_loop import Trainer
    from cddmsl_torch.solver.build import build_optimizer

    if kind == "fpn":
        model, batch = FPNRCNN(**FPN_CASCADE), BATCH_A
        tb = torch_batch(batch, gt_masks=torch.from_numpy(diamond_canvases(batch)).to(torch.uint8))
        init_random_(model, torch.Generator().manual_seed(6))
        trainer = Trainer(model, build_optimizer(model, SolverConfig(warmup_iters=0)), enable_caption=False)
        draw = chip_smoke.site_draw("cpu")
        step = recorded_kernel_calls(monkeypatch, "step", lambda: trainer.train_step(tb, draw))
        test = recorded_kernel_calls(monkeypatch, "eval", lambda: model.inference(tb))
    else:
        step, test = request.getfixturevalue("c4_cascade_runs")["calls"]
    pools = 16 if kind == "fpn" else 3  # 3 stages x 4 levels and the mask pooler's 4, or 3 stages on res4
    assert len(step.pools) == pools and step.k3 == [call for call, *_ in step.pools] and len(step.nms) == 1
    assert len(test.pools) == pools and test.k3 == [] and len(test.nms) == 2
