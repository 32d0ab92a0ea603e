"""The semantic segmentor in the port against cddmsl_tpu on the CPU: the
whole `SemanticSegmentor` (the FPN tower, `SemSegFPNHead` without a norm on
IN_FEATURES p3..p5, the bilinear resizes, the per-pixel cross entropy), the
bilinear resize itself, the sem-seg mapper with its NEAREST label maps, the
collate and the training loader, and `SemSegEvaluator` with
`inference_on_dataset_semseg` on the stripes fixture.

One JAX program, compiled once for its module-scoped fixture: JAX's
`SemanticSegmentor` (RESNETS.DEPTH 10; JAX's module takes no narrower
widths) on two 96x160 images (the second 80x128 inside the pad, labels 255
on the pad and on a band of the first), its gradient and its logits.
Tolerances, and why:
- `loss_sem_seg` within rtol 1e-4 and every parameter's gradient within
  1e-4 of its tensor's largest gradient (never less than 1e-5), as
  test_torch_port_fpn.py holds them: the same convolutions summed in
  another order through ten blocks;
- the logits within 1e-5 of their largest magnitude, and their argmax
  equal wherever the top two are further apart than that;
- `resize_bilinear_nchw` within 1e-6 of `jax.image.resize` (two taps a
  pixel, the same weights), and equal to it in bfloat16;
- the mapper, the collate and the loader exactly; the evaluator's metrics
  within 1e-9 (float64 numpy both).

Marked `slow`, outside Tier-1: the semantic golden
(semantic_training_acc_test.yaml) from JAX's initial tree, against the
schedule's own TEST.EXPECTED_RESULTS (mIoU 98.781 +/- 0.1).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.data.build import build_detection_test_loader as jax_test_loader
from cddmsl_tpu.data.build import build_detection_train_loader as jax_train_loader
from cddmsl_tpu.data.build import pad_and_collate as jax_pad_and_collate
from cddmsl_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from cddmsl_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from cddmsl_tpu.data.dataset_mapper import SemSegDatasetMapper as JaxSemSegDatasetMapper
from cddmsl_tpu.data.datasets.synthetic import register_synthetic_semseg as jax_register_synthetic_semseg
from cddmsl_tpu.evaluation.sem_seg_eval import SemSegEvaluator as JaxSemSegEvaluator
from cddmsl_tpu.evaluation.sem_seg_eval import inference_on_dataset_semseg as jax_inference_on_dataset_semseg
from cddmsl_tpu.models import DetBatch as JaxDetBatch
from cddmsl_tpu.models.extra_meta_archs import SemanticSegmentor as JaxSemanticSegmentor
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.config import get_cfg
from cddmsl_torch.data.build import build_detection_test_loader, build_detection_train_loader, pad_and_collate
from cddmsl_torch.data.catalog import DatasetCatalog, MetadataCatalog
from cddmsl_torch.data.dataset_mapper import SemSegDatasetMapper
from cddmsl_torch.data.datasets.synthetic import register_synthetic_semseg
from cddmsl_torch.evaluation import verify_results
from cddmsl_torch.evaluation.sem_seg_eval import SemSegEvaluator, inference_on_dataset_semseg
from cddmsl_torch.models.rcnn import DetBatch
from cddmsl_torch.models.semantic_seg import SemanticSegmentor
from cddmsl_torch.ops.resize import resize_bilinear_nchw
from test_torch_port_backbone import fill_params
from test_torch_port_fpn import D2_PIXELS, assert_grads_match
from torch_goldens import jax_initial_tree, replaying_trainers, run_schedule

torch.set_num_threads(1)

CLASSES = 7
SEMSEG = dict(num_classes=CLASSES, depth=10, in_features=("p3", "p4", "p5"), head_norm="", **D2_PIXELS)
LOGIT_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def label_batch(seed=4):
    """A JAX DetBatch of two 96x160 images (the second 80x128 inside the
    pad, its originals twice the size) with (2, 96, 160) int32 labels in
    8x8 blocks: 255 on the pad and on the first image's rows 40..47."""
    r = np.random.RandomState(seed)
    sizes = [[96, 160], [80, 128]]
    image = r.rand(2, 96, 160, 3) * 255
    labels = np.kron(r.randint(0, CLASSES, (2, 12, 20)), np.ones((8, 8), np.int64)).astype(np.int32)
    labels[0, 40:48] = 255
    for i, (h, w) in enumerate(sizes):
        image[i, h:], image[i, :, w:] = 0, 0
        labels[i, h:], labels[i, :, w:] = 255, 255
    z = jnp.zeros((2, 4, 4), jnp.float32)
    return JaxDetBatch(image=jnp.asarray(image, jnp.float32), image_sizes=jnp.asarray(sizes, jnp.int32),
                       orig_sizes=jnp.asarray(sizes, jnp.int32) * 2, gt_boxes=z, gt_classes=jnp.zeros((2, 4), jnp.int32),
                       gt_valid=jnp.zeros((2, 4), bool), sem_seg=jnp.asarray(labels))


def torch_batch(jb):
    return DetBatch(_t(jb.image), _t(jb.image_sizes), _t(jb.orig_sizes), sem_seg=_t(jb.sem_seg))


@pytest.fixture(scope="module")
def semseg_runs():
    """JAX's gradient of the loss and its logits of the batch; the port's
    from the converted tree."""
    jb = label_batch()
    model = JaxSemanticSegmentor(**SEMSEG)
    shapes = jax.eval_shape(lambda r, b: model.init({"params": r}, b, r, method=model.init_all),
                            jax.random.PRNGKey(0), jb)
    params = fill_params(shapes, seed=13)

    def loss(p, b):
        out = model.apply(p, b, jax.random.PRNGKey(0), method=model.cddmsl_losses)
        return out["loss_sem_seg"], out

    (grads, losses), logits = jax.jit(lambda p, b: (
        jax.grad(loss, has_aux=True)(p, b), model.apply(p, b.image, method=model._forward_logits)))(params, jb)
    ours = SemanticSegmentor(**SEMSEG)
    ours.load_state_dict(convert_jax_params(params), strict=True)
    tb = torch_batch(jb)
    with torch.enable_grad():
        got_losses = ours.cddmsl_losses(tb)
        got_losses["loss_sem_seg"].backward()
    with torch.no_grad():
        got_logits = ours.logits(tb.image)
    return dict(want=(losses, convert_jax_params(grads), np.asarray(logits)), got=(got_losses, got_logits),
                model=ours, batch=tb)


def test_semantic_segmentor_loss_and_gradients_equal_jax(semseg_runs):
    (want_losses, want_grads, _), (got_losses, _) = semseg_runs["want"], semseg_runs["got"]
    assert set(got_losses) == set(want_losses) == {"loss_sem_seg"}
    np.testing.assert_allclose(got_losses["loss_sem_seg"].item(), float(want_losses["loss_sem_seg"]), rtol=1e-4)
    assert float(want_losses["loss_sem_seg"]) > 0
    model = semseg_runs["model"]
    # p2's lateral and output convs feed nothing the head reads (IN_FEATURES p3..p5): JAX's gradient is zero
    unread = [n for n, p in model.named_parameters() if p.grad is None]
    assert sorted(unread) == [f"backbone.fpn_{k}2.{t}" for k in ("lateral", "output") for t in ("bias", "weight")]
    for n, p in model.named_parameters():
        if p.grad is None:
            assert not want_grads[n].any(), n
            p.grad = torch.zeros_like(p)
    assert_grads_match(model, want_grads)
    # the head's three levels, without a norm: convs with a bias, p3 upsampled once
    names = {n for n, _ in semseg_runs["model"].sem_seg_head.named_parameters()}
    assert {"head_0_conv0.bias", "head_2_conv2.weight", "predictor.weight"} <= names
    assert not any("gn" in n for n in names) and "head_0_conv1.weight" not in names


def assert_logits_and_argmax_match(got, want):
    """float32 logits (B, K, H, W) against JAX's (B, H, W, K); the argmax
    where the top two are apart by more than the tolerance."""
    want = np.moveaxis(want, -1, 1)
    atol = LOGIT_RTOL * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * atol
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(1).numpy()[clear], want.argmax(1)[clear])


def test_semantic_segmentor_logits_and_inference_equal_jax(semseg_runs):
    got_logits = semseg_runs["got"][1]
    assert got_logits.dtype == torch.float32 and tuple(got_logits.shape) == (2, CLASSES, 96, 160)
    assert_logits_and_argmax_match(got_logits, semseg_runs["want"][2])
    pred = semseg_runs["model"].inference(semseg_runs["batch"])
    assert torch.equal(pred, got_logits.argmax(1))


@pytest.mark.parametrize("hw, size", [((12, 20), (24, 40)), ((3, 5), (12, 20)), ((25, 42), (200, 336))])
def test_bilinear_resize_equals_jax(hw, size):
    """2x, 4x and 8x upsizes of a (B, C, h, w) map, as the head and the
    logits' resize take them, in float32 and in bfloat16, where each axis
    rounds once as JAX's einsum rounds its two contractions (W first):
    equal."""
    x = np.random.RandomState(hw[0]).randn(2, 3, *hw).astype(np.float32)
    want = jax.image.resize(jnp.asarray(np.moveaxis(x, 1, -1)), (2, *size, 3), "bilinear")
    got = resize_bilinear_nchw(torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 1), rtol=0, atol=1e-6)
    xb = jnp.asarray(np.moveaxis(x, 1, -1), jnp.bfloat16)
    want_b = np.asarray(jax.image.resize(xb, (2, *size, 3), "bilinear").astype(jnp.float32))
    got_b = resize_bilinear_nchw(torch.from_numpy(x).to(torch.bfloat16), size)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_b.float().numpy(), np.moveaxis(want_b, -1, 1))


# ---------------- data and evaluation ----------------
@pytest.fixture(scope="module")
def stripes(tmp_path_factory):
    """The stripes fixture registered in both packages' catalogs as
    port_semseg_{train,val}, removed afterwards."""
    root = tmp_path_factory.mktemp("semseg")
    register_synthetic_semseg(str(root / "ours"), prefix="port_semseg")
    jax_register_synthetic_semseg(str(root / "jax"), prefix="port_semseg")
    yield root
    for name in ("port_semseg_train", "port_semseg_val"):
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
        JaxDatasetCatalog._registry.pop(name, None)
        JaxMetadataCatalog._registry.pop(name, None)


def _cfgs(*opts):
    cfg, ref = get_cfg(), jax_get_cfg()
    for c in (cfg, ref):
        c.merge_from_list(["MODEL.META_ARCHITECTURE", "SemanticSegmentor", "DATASETS.TRAIN", "('port_semseg_train',)",
                           "DATASETS.TEST", "('port_semseg_val',)", "INPUT.MIN_SIZE_TRAIN", "(96, 120)",
                           "INPUT.MAX_SIZE_TRAIN", "200", "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "160",
                           "TPU.PAD_SIZE_TRAIN", "[128, 224]", "TPU.PAD_SIZE_TEST", "[96, 160]",
                           "SOLVER.IMS_PER_BATCH", "2", "MODEL.CLIP.IMS_PER_BATCH_TEST", "4", *opts])
    return cfg, ref


def test_the_fixture_mapper_collate_and_loader_give_jax_labels(stripes):
    """The fixture's files byte for byte; the sem-seg mapper's samples
    (resized, flipped; labels NEAREST) and the collate's labels (255 on the
    pad) equal JAX's; the training loader picks the sem-seg mapper and its
    first batches equal JAX's loader's."""
    for sub in ("leftImg8bit", "gtFine"):
        for p in sorted((stripes / "ours" / "semseg_synth" / sub).rglob("*.png")):
            assert p.read_bytes() == (stripes / "jax" / p.relative_to(stripes / "ours")).read_bytes(), p
    cfg, ref = _cfgs("INPUT.RANDOM_FLIP", "horizontal")
    dicts = DatasetCatalog.get("port_semseg_train")
    assert [{k: v for k, v in d.items()} for d in dicts] == [
        {k: v.replace(str(stripes / "jax"), str(stripes / "ours")) if isinstance(v, str) else v
         for k, v in d.items()} for d in JaxDatasetCatalog.get("port_semseg_train")]
    ours, theirs = SemSegDatasetMapper(cfg, True), JaxSemSegDatasetMapper(ref, True)
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    samples, want = [ours(d, r1) for d in dicts], [theirs(d, r2) for d in dicts]
    for s, w in zip(samples, want):
        assert set(s) == set(w)
        for k in ("image", "hw", "orig_hw", "sem_seg", "boxes", "classes"):
            np.testing.assert_array_equal(s[k], w[k], err_msg=k)
        assert s["sem_seg"].dtype == np.int32 and set(np.unique(s["sem_seg"])) <= set(range(5)) | {255}
    assert any(s["hw"][0] != 100 for s in samples)  # resized
    got = pad_and_collate(samples[:3], (128, 224), 4)
    ref_batch = jax_pad_and_collate(want[:3], (128, 224), 4)
    np.testing.assert_array_equal(got.sem_seg.numpy(), np.asarray(ref_batch.sem_seg))
    assert (got.sem_seg.numpy()[:, 120:] == 255).all()
    with build_detection_train_loader(cfg, seed=5) as loader:
        batches = [next(loader) for _ in range(3)]
    jax_loader = jax_train_loader(ref, seed=5)
    for b in batches:
        w = next(jax_loader)
        np.testing.assert_array_equal(b.image.numpy(), np.asarray(w.image))
        np.testing.assert_array_equal(b.sem_seg.numpy(), np.asarray(w.sem_seg))
        assert not b.gt_valid.any()


class _StripesModel(torch.nn.Module):
    """An argmax map from the image alone: the fixture's class is its
    intensity over 40 (pixels above 4 classes' worth clipped by the
    evaluator)."""

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def inference(self, batch):
        return (batch.image[..., 0] // 40).long()


def test_the_evaluator_and_its_loop_equal_jax(stripes):
    """`inference_on_dataset_semseg` (crop, NEAREST resize to the 100x140
    originals, the labelTrainIds PNGs) through `SemSegEvaluator`, and JAX's
    loop and evaluator on the same predictions: the metrics within 1e-9;
    then a crafted confusion with an unseen class."""
    cfg, ref = _cfgs()
    model = _StripesModel()
    loader, n = build_detection_test_loader(cfg, "port_semseg_val")
    with loader:
        got = inference_on_dataset_semseg(model, loader, SemSegEvaluator("port_semseg_val"), torch.device("cpu"))
    jax_loader, _ = jax_test_loader(ref, "port_semseg_val")
    want = jax_inference_on_dataset_semseg(lambda p, b: (b.image[..., 0] // 40).astype(jnp.int32), None, jax_loader,
                                           JaxSemSegEvaluator("port_semseg_val"))
    assert n == 6 and got.keys() == want.keys() == {"sem_seg"}
    assert list(got["sem_seg"]) == list(want["sem_seg"]) == ["mIoU", "fwIoU", "mACC", "pACC"] + [
        f"IoU-s{i}" for i in range(5)]
    np.testing.assert_allclose(list(got["sem_seg"].values()), list(want["sem_seg"].values()), rtol=0, atol=1e-9)
    assert 50 < got["sem_seg"]["mIoU"] < 100

    r = np.random.RandomState(2)
    ours, theirs = SemSegEvaluator(num_classes=4, class_names=list("abcd")), JaxSemSegEvaluator(
        num_classes=4, class_names=list("abcd"))
    for _ in range(3):
        gt = r.choice([0, 1, 2, 255], (20, 30))  # class 3 never labelled
        pred = r.randint(-1, 6, (20, 30))  # out of range: clipped
        ours.process(pred, gt)
        theirs.process(pred, gt)
    a, b = ours.evaluate()["sem_seg"], theirs.evaluate()["sem_seg"]
    assert list(a) == list(b)
    np.testing.assert_allclose(list(a.values()), list(b.values()), rtol=0, atol=1e-9)
    assert np.isnan(a["IoU-d"]) or a["IoU-d"] == b["IoU-d"]


@pytest.mark.slow
def test_the_semantic_golden_from_jax_initial_tree(tmp_path, monkeypatch):
    """semantic_training_acc_test.yaml (100 steps of the semantic segmentor
    at depth 10 on the stripes fixture, batch 2, clipping by norm; it
    samples nothing) from JAX's initial tree: mIoU 98.781 within 0.1."""
    name = "semantic_training_acc_test.yaml"
    monkeypatch.setattr(train_net, "DefaultTrainer", replaying_trainers(*jax_initial_tree(name))[0])
    register_synthetic_semseg(str(tmp_path / "fixture"))
    try:
        results = run_schedule(name, tmp_path / "out", "TEST.EXPECTED_RESULTS", "[]")["synthetic_semseg_val"]
    finally:
        for set_name in ("synthetic_semseg_train", "synthetic_semseg_val"):
            DatasetCatalog.remove(set_name)
            MetadataCatalog.remove(set_name)
    print(f"semantic golden: {results}")
    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parent.parent / "configs" / "quick_schedules" / name))
    assert verify_results(cfg, results), results


@pytest.mark.slow
@pytest.mark.parametrize("scale", [0.0, 1e-7], ids=["as_pinned", "moved"])
def test_jax_own_semantic_golden_from_its_tree_and_from_a_moved_tree(scale, tmp_path):
    """JAX's own trainer on semantic_training_acc_test.yaml from its initial
    tree, and from the tree with every leaf moved by one part in 1e7: its
    mIoU beside the golden (98.781 +/- 0.1), printed; JAX's final tree
    through the port's `test()` gives JAX's own results within 1e-9."""
    from cddmsl_torch.engine.defaults import DefaultTrainer
    from torch_goldens import jax_own_schedule

    name = "semantic_training_acc_test.yaml"
    jax_register_synthetic_semseg(str(tmp_path / "jax_fixture"))
    register_synthetic_semseg(str(tmp_path / "fixture"))
    try:
        results, params = jax_own_schedule(name, tmp_path / "jax", scale)
        cfg = get_cfg()
        cfg.merge_from_file(str(Path(__file__).resolve().parent.parent / "configs" / "quick_schedules" / name))
        cfg.merge_from_list(["OUTPUT_DIR", str(tmp_path / "port")])
        ours = DefaultTrainer(cfg, device="cpu")
        ours.model.load_state_dict(convert_jax_params(params), strict=True)
        port = ours.test()["synthetic_semseg_val"]["sem_seg"]
    finally:
        for set_name in ("synthetic_semseg_train", "synthetic_semseg_val"):
            DatasetCatalog.remove(set_name)
            MetadataCatalog.remove(set_name)
            JaxDatasetCatalog._registry.pop(set_name, None)
            JaxMetadataCatalog._registry.pop(set_name, None)
    want = results["synthetic_semseg_val"]["sem_seg"]
    print(f"JAX from its tree moved by {scale:g}: mIoU {want['mIoU']} (golden 98.781 +/- 0.1)")
    np.testing.assert_allclose([port[k] for k in want], list(want.values()), rtol=1e-9)


@pytest.mark.slow
def test_every_semantic_schedule_step_equals_jax_from_jax_state(tmp_path):
    """semantic_training_acc_test.yaml's 100 steps, each taken by the port
    from JAX's state beside JAX's own step from that state moved by 1e-7
    (`torch_goldens.schedule_lockstep`; the schedule samples nothing). The
    port departs no further than the control, with the bounds of the
    keypoint lockstep: at most 3 times its largest loss and update
    differences, and at no more steps past 1e-4 (the loss) or 1e-3 (the
    update) than twice the control's and 10. So the golden's miss (mIoU
    98.2554 against 98.781, where JAX from its tree moved by 1e-7 gives
    98.6866) is the float order compounding over 100 steps."""
    import torch_goldens

    jax_register_synthetic_semseg(str(tmp_path / "jax_fixture"), prefix="port_semseg_lockstep")
    register_synthetic_semseg(str(tmp_path / "fixture"))
    try:
        rows = torch_goldens.schedule_lockstep("semantic_training_acc_test.yaml", "port_semseg_lockstep_train",
                                               torch_goldens.step_draw)
    finally:
        for set_name in ("synthetic_semseg_train", "synthetic_semseg_val"):
            DatasetCatalog.remove(set_name)
            MetadataCatalog.remove(set_name)
        for set_name in ("port_semseg_lockstep_train", "port_semseg_lockstep_val"):
            JaxDatasetCatalog._registry.pop(set_name, None)
            JaxMetadataCatalog._registry.pop(set_name, None)
    port, control = torch_goldens.lockstep_summary(rows)
    print(f"over {len(rows)} steps, the port: loss rtol at most {port[0]:.3g}, the update at most {port[1]:.3g} apart, "
          f"{len(port[2])} steps past 1e-4 or 1e-3 {port[2]}; the control: {control[0]:.3g}, {control[1]:.3g}, "
          f"{len(control[2])} steps {control[2]}")
    assert len(rows) == 100
    assert port[0] <= 3 * control[0] and port[1] <= 3 * control[1], (port, control)
    assert len(port[2]) <= 2 * len(control[2]) + 10, (port, control)
