"""The FPN family's proposal paths in the port against cddmsl_tpu on the CPU:
both ProposalNetworks (on res4 and on the FPN), precomputed proposals
(MODEL.LOAD_PROPOSALS: the loaders' batches and FPNRCNN on them), and the
two quick schedules of the family through the port's `train_net`.

The same inputs, made with numpy from a seed (or the synthetic COCO fixture
and its proposal pickle), go through both packages in float32. Tolerances,
and why:
- the loaders' batches bit for bit (the same numpy decode, transforms,
  proposal ranking and collation);
- the ProposalNetworks (depth 10; on the FPN at the narrow widths of
  test_torch_port_fpn.py) and FPNRCNN on the precomputed proposals, in one
  JAX program each: losses with JAX's draws, rtol 1e-4; each parameter's
  gradient within 1e-4 of its tensor's largest gradient and never less than
  1e-5; proposals and detections as test_torch_port_fpn.py ranks them,
  the proposals' boxes within 2e-3 px (C4_BOX_ATOL) and their scores (the
  sigmoid of the objectness) within 1e-5.
"""

import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.data import build_detection_test_loader as jax_test_loader
from cddmsl_tpu.data import build_detection_train_loader as jax_train_loader
from cddmsl_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from cddmsl_tpu.data.datasets.synthetic import register_synthetic_coco as jax_register_synthetic_coco
from cddmsl_tpu.models.extra_meta_archs import FPNProposalNetwork as JaxFPNProposalNetwork
from cddmsl_tpu.models.extra_meta_archs import ProposalNetwork as JaxProposalNetwork
from cddmsl_tpu.models.fpn_rcnn import FPNRCNN as JaxFPNRCNN
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.config import get_cfg
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader
from cddmsl_torch.data import build_detection_train_loader
from cddmsl_torch.data.datasets.synthetic import make_synthetic_proposals, register_synthetic_coco
from cddmsl_torch.engine.defaults import DefaultPredictor, default_argument_parser
from cddmsl_torch.models.extra_meta_archs import FPNProposalNetwork, ProposalNetwork
from cddmsl_torch.models.fpn_rcnn import FPNRCNN
from cddmsl_torch.models.rcnn import DetBatch
from test_torch_port_fpn import (
    BATCH_A, BATCH_B, D2_PIXELS, NARROW, assert_grads_match, assert_rows_match, close_detection, filled,
    torch_batch,
)
from torch_goldens import jax_draw, supervised_draw, torch_threads

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
QUICK = REPO / "configs" / "quick_schedules"
FPN_PROPOSALS = dict(depth=10, backbone_width=8, fpn_out_channels=32, pre_nms_topk=(64, 48), post_nms_topk=(32, 24))
COCO_NAMES = ("synthetic_coco_train", "synthetic_coco_val")
# the proposals' boxes: ProposalNetwork's RPN conv reads res4 at full width
# (1024 channels, 9216 products an output), and its decoded boxes differ
# from JAX's by up to ~1.04e-3 px (rel. 1e-5)
C4_BOX_ATOL = 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------- the ProposalNetworks ----------------
@pytest.fixture(scope="module")
def proposal_runs():
    """One JAX program: each ProposalNetwork's loss gradient on batch A and
    its proposals-as-detections on both batches; the same in the port."""
    c4 = JaxProposalNetwork(depth=10, **D2_PIXELS)
    fpn = JaxFPNProposalNetwork(**FPN_PROPOSALS, **D2_PIXELS)
    params = {"c4": filled(c4, BATCH_A, seed=31), "fpn": filled(fpn, BATCH_A, seed=32)}
    rng = jax.random.PRNGKey(4)

    def run(model, p, a, b, r):
        def total(q):
            losses = model.apply(q, a, r, method=model.losses)
            return sum(losses.values()), losses

        grads, losses = jax.grad(total, has_aux=True)(p)
        return losses, grads, model.apply(p, a, method=model.inference), model.apply(p, b, method=model.inference)

    want = jax.jit(lambda ps, a, b, r: {"c4": run(c4, ps["c4"], a, b, r), "fpn": run(fpn, ps["fpn"], a, b, r)})(
        params, BATCH_A, BATCH_B, rng)
    got = {}
    for name, ours in (("c4", ProposalNetwork(depth=10, **D2_PIXELS)),
                       ("fpn", FPNProposalNetwork(**FPN_PROPOSALS, **D2_PIXELS))):
        ours.load_state_dict(convert_jax_params(params[name]), strict=True)
        dets = [ours.inference(torch_batch(jb)) for jb in (BATCH_A, BATCH_B)]
        with torch.enable_grad():
            losses = ours.losses(torch_batch(BATCH_A), jax_draw(rng, None))
            sum(losses.values()).backward()
        got[name] = (losses, ours, *dets)
    return want, got


@pytest.mark.parametrize("name", ["c4", "fpn"])
def test_proposal_network_losses_and_gradients_equal_jax(proposal_runs, name):
    (want_losses, want_grads, *_), (got_losses, model, *_) = proposal_runs[0][name], proposal_runs[1][name]
    assert set(got_losses) == set(want_losses) == {"loss_rpn_cls", "loss_rpn_loc"}
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    assert_grads_match(model, convert_jax_params(want_grads))


@pytest.mark.parametrize("name", ["c4", "fpn"])
def test_proposal_network_detections_equal_jax(proposal_runs, name):
    """The proposals as class-0 detections scored sigmoid(logit), in the
    resized frame (neither package rescales them), on both batches."""
    want, got = proposal_runs[0][name][2:], proposal_runs[1][name][2:]
    for w, g in zip(want, got):
        assert g.boxes.shape == w.boxes.shape and not g.classes.any()
        np.testing.assert_allclose(g.scores.numpy(), np.asarray(w.scores), rtol=0, atol=1e-5)
        assert_rows_match(g, w, "proposal", lambda a, b: np.abs(a - b).max() <= C4_BOX_ATOL)
    assert float(got[0].boxes[..., 2].max()) <= 160.0  # the resized frame, not the 320-wide originals


# ---------------- precomputed proposals ----------------
@pytest.fixture(scope="module")
def coco_fixture(tmp_path_factory):
    """The synthetic COCO fixture and its proposal pickle under both
    packages' names, removed from the catalogs afterwards."""
    root = str(tmp_path_factory.mktemp("coco"))
    register_synthetic_coco(root)
    jax_register_synthetic_coco(root)
    try:
        yield root, make_synthetic_proposals(root)
    finally:
        for name in COCO_NAMES:
            if name in DatasetCatalog:
                DatasetCatalog.remove(name)
                MetadataCatalog.remove(name)
            if name in JaxDatasetCatalog:  # JAX's metadata catalog removes nothing
                JaxDatasetCatalog.remove(name)


def _proposal_cfgs(pf):
    opts = ["DATASETS.PROPOSAL_FILES_TRAIN", f"('{pf}',)", "DATASETS.PROPOSAL_FILES_TEST", f"('{pf}',)",
            "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN", "14", "SOLVER.IMS_PER_BATCH", "3"]
    cfgs = []
    for cfg in (get_cfg(), jax_get_cfg()):
        cfg.merge_from_file(str(QUICK / "fast_rcnn_R_50_FPN_instant_test.yaml"))
        cfg.merge_from_list(opts)
        cfgs.append(cfg)
    return cfgs


def _jax_fields(jb):
    return [jb.image, jb.image_sizes, jb.orig_sizes, jb.gt_boxes, jb.gt_classes, jb.gt_valid, jb.proposal_boxes,
            jb.proposal_scores, jb.proposal_valid]


@pytest.fixture(scope="module")
def proposal_batches(coco_fixture):
    """Two training batches and the first test batch of both loaders."""
    ours_cfg, ref_cfg = _proposal_cfgs(coco_fixture[1])
    with build_detection_train_loader(ours_cfg, seed=0) as loader:
        got = [next(loader) for _ in range(2)]
    ref = jax_train_loader(ref_cfg, seed=0)
    want = [next(ref) for _ in range(2)]
    test_loader, _ = build_detection_test_loader(ours_cfg, COCO_NAMES[1])
    with test_loader:
        got_test = next(test_loader)[0]
    want_test = next(jax_test_loader(ref_cfg, COCO_NAMES[1])[0])[0]
    return list(zip(got + [got_test], want + [want_test]))


def test_the_proposal_loaders_batches_equal_jaxs(proposal_batches):
    """Images, sizes, ground truth and the precomputed proposals (moved with
    the image, clipped, the top 14 by objectness in training and 16 in the
    test, -inf and not valid past an image's own) bit for bit."""
    names = list(DetBatch._fields)
    names.remove("image_trgt")
    for got, want in proposal_batches:
        for name, w in zip(names, _jax_fields(want)):
            g = getattr(got, name)
            assert g is not None and tuple(g.shape) == tuple(w.shape), name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert got.proposal_valid.any()
    assert any(not got.proposal_valid.all() for got, _ in proposal_batches)  # an image with fewer than k
    assert proposal_batches[0][0].proposal_boxes.shape[1] == 14 and proposal_batches[-1][0].proposal_boxes.shape[1] == 16


def test_fpn_rcnn_on_precomputed_proposals_equals_jax(proposal_batches):
    """FPNRCNN without an RPN (LOAD_PROPOSALS): the box head's losses and
    every parameter's gradient on the loader's training batch, and its
    detections on the test batch, against JAX's on the same batches."""
    kw = {**NARROW, "num_classes": 2, "roi_batch_size_per_image": 16, "load_proposals": True}
    (train, jtrain), (test, jtest) = proposal_batches[0], proposal_batches[-1]
    model = JaxFPNRCNN(**kw)
    params = filled(model, jtrain, seed=41)
    rng = jax.random.PRNGKey(6)

    def total(p, b, r):
        losses = model.apply(p, b, r, method=model.supervised_losses)
        return sum(losses.values()), losses

    (grads, losses), dets = jax.jit(lambda p, a, b, r: (
        jax.grad(total, has_aux=True)(p, a, r), model.apply(p, b, method=model.inference)))(params, jtrain, jtest, rng)
    ours = FPNRCNN(**kw)
    assert not hasattr(ours, "proposal_generator")
    ours.load_state_dict(convert_jax_params(params), strict=True)
    assert_rows_match(ours.inference(test), dets, "detection", close_detection(1))
    with torch.enable_grad():
        got = ours.supervised_losses(train, supervised_draw(rng))
        sum(got.values()).backward()
    assert set(got) == set(losses) == {"loss_cls", "loss_box_reg"}
    for k, v in losses.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-4, err_msg=k)
    assert_grads_match(ours, convert_jax_params(grads))


# ---------------- the quick schedules through train_net ----------------
SCHEDULES = {
    "rpn_R_50_FPN_instant_test.yaml": {"loss_rpn_cls", "loss_rpn_loc"},
    "fast_rcnn_R_50_FPN_instant_test.yaml": {"loss_cls", "loss_box_reg"},
}


@pytest.mark.parametrize("name", SCHEDULES)
def test_instant_schedule_trains_and_tests(name, coco_fixture, tmp_path):
    """`python -m cddmsl_torch.train_net --device cpu --config-file
    configs/quick_schedules/<name>` on the synthetic COCO fixture (the
    fixture://proposals file resolved as tools/run_quick_schedules.py
    resolves it): 3 steps with the schedule's own losses and no other,
    model_final, the COCO evaluator's test; then `--eval-only` from that
    model_final gives the same AP."""
    pf = coco_fixture[1]
    opts = ["OUTPUT_DIR", str(tmp_path), "DATASETS.PROPOSAL_FILES_TRAIN", f"('{pf}',)",
            "DATASETS.PROPOSAL_FILES_TEST", f"('{pf}',)"]
    parse = default_argument_parser().parse_args
    with torch_threads(2):
        results = train_net.main(parse(["--device", "cpu", "--config-file", str(QUICK / name), *opts]))
        again = train_net.main(parse(["--device", "cpu", "--eval-only", "--config-file", str(QUICK / name), *opts,
                                      "MODEL.WEIGHTS", str(tmp_path / "model_final.pth")]))
    (test_set, res), = results.items()
    assert test_set == COCO_NAMES[1] and res["bbox"].keys() >= {"AP", "AP50", "AP75"}
    np.testing.assert_equal(again, results)  # NaN where no box of a size exists, in both
    last = json.loads((tmp_path / "metrics.json").read_text().splitlines()[-1])
    losses = {k: v for k, v in last.items() if k.startswith("loss")}
    assert set(losses) == SCHEDULES[name] and all(math.isfinite(v) for v in losses.values()), losses
    assert last["iteration"] == 3  # SOLVER.MAX_ITER


def test_the_predictor_builds_the_fpn_detector_and_rescales(coco_fixture):
    """`DefaultPredictor` on an FPN tree builds FPNRCNN with seeded random
    weights and gives boxes in the original image's coordinates."""
    cfg = get_cfg()
    cfg.merge_from_file(str(QUICK / "fast_rcnn_R_50_FPN_instant_test.yaml"))
    cfg.merge_from_list(["MODEL.LOAD_PROPOSALS", "False", "MODEL.PROPOSAL_GENERATOR.NAME", "RPN",
                         "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0"])
    predictor = DefaultPredictor(cfg, device="cpu")
    assert type(predictor.model).__name__ == "FPNRCNN"
    out = predictor(np.random.RandomState(0).randint(0, 255, (200, 280, 3), np.uint8))
    assert len(out["boxes"]) > 0 and out["boxes"][:, 2].max() > 160 and out["boxes"][:, 2].max() <= 280
