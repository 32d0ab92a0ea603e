"""Cityscapes' instance sets, the Cityscapes evaluators, test-time
augmentation, SOLVER.NESTEROV and TPU.PAD_BUCKETS in the port against
cddmsl_tpu on the CPU.

- Cityscapes' instance sets (cityscapes_fine_instance_seg_{train,val}):
  the train loader of Cityscapes/mask_rcnn_R_50_FPN.yaml (MASK_ON, at a
  CPU's size, with a pad ladder) and the test loader give JAX's batches
  exactly, their mask canvases all zero (the sets carry no polygons), and
  both packages score them with the VOC evaluator; the file passes
  `check_supported` with JAX's builder's fields.
- `_bucket_for` with a ladder picks JAX's bucket for every size.
- `CityscapesInstanceEvaluator` (bbox and segm) and
  `CityscapesSemSegEvaluator` give JAX's dicts on the same inputs, within
  1e-9; `build_evaluator` routes "cityscapes_instance" and "rotated_coco"
  as JAX's does.
- `GeneralizedRCNNWithTTA` merges a stub detector's plain and flipped
  detections as JAX's wrapper does: the same validity, classes and order,
  boxes and scores within 1e-5 of their largest magnitude (the stub's
  image means are float32 sums in another order). The stub keeps the JAX
  program to a few operations.
- A Nesterov step: three updates of the port's optimizer against optax's
  chain from JAX's `build_optimizer`, parameters within 1e-6 (float32
  updates of the same terms), and apart from the plain momentum's.
"""

from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.data import DatasetCatalog as JaxDatasetCatalog
from cddmsl_tpu.data import MetadataCatalog as JaxMetadataCatalog
from cddmsl_tpu.data import build_detection_test_loader as jax_test_loader
from cddmsl_tpu.data import build_detection_train_loader as jax_train_loader
from cddmsl_tpu.data.build import _bucket_for as jax_bucket_for
from cddmsl_tpu.data.datasets import builtin as jax_builtin
from cddmsl_tpu.engine.defaults import build_evaluator as jax_build_evaluator
from cddmsl_tpu.evaluation.cityscapes_eval import CityscapesInstanceEvaluator as JaxCityscapesInstanceEvaluator
from cddmsl_tpu.evaluation.cityscapes_eval import CityscapesSemSegEvaluator as JaxCityscapesSemSegEvaluator
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.fast_rcnn import DetectionResult as JaxDetectionResult
from cddmsl_tpu.models.rcnn import DetBatch as JaxDetBatch
from cddmsl_tpu.models.tta import GeneralizedRCNNWithTTA as JaxGeneralizedRCNNWithTTA
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_torch.config import check_supported, get_cfg, solver_config_from_cfg
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader, build_detection_train_loader
from cddmsl_torch.data.build import _bucket_for
from cddmsl_torch.data.datasets import builtin
from cddmsl_torch.data.datasets.synthetic import make_synthetic_cityscapes
from cddmsl_torch.engine.defaults import build_evaluator
from cddmsl_torch.evaluation.cityscapes_eval import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator
from cddmsl_torch.evaluation.rotated_coco_eval import RotatedCOCOEvaluator
from cddmsl_torch.models.build import fpn_rcnn_fields
from cddmsl_torch.models.fast_rcnn import DetectionResult
from cddmsl_torch.models.rcnn import DetBatch
from cddmsl_torch.models.tta import GeneralizedRCNNWithTTA
from cddmsl_torch.solver.build import Optimizer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CITY_YAML = REPO / "configs" / "Cityscapes" / "mask_rcnn_R_50_FPN.yaml"
HW = (64, 128)
LADDER = [[64, 128], [96, 160]]


def _both_cfgs(*opts):
    ours, ref = get_cfg(), jax_get_cfg()
    for cfg in (ours, ref):
        cfg.merge_from_file(str(CITY_YAML))
        cfg.merge_from_list(list(opts))
    return ours, ref


@pytest.fixture
def city_sets(tmp_path, monkeypatch):
    """The builtin names of both packages at a tiny Cityscapes root (4 train
    and 3 val images of 64x128), in empty catalogs put back after the test."""
    make_synthetic_cityscapes(str(tmp_path), n=4, seed=0, hw=HW, split="train", foggy=False)
    make_synthetic_cityscapes(str(tmp_path), n=3, seed=1, hw=HW, split="val", foggy=False)
    for module, catalogs in ((builtin, (DatasetCatalog, MetadataCatalog)),
                             (jax_builtin, (JaxDatasetCatalog, JaxMetadataCatalog))):
        monkeypatch.setattr(module, "_REGISTERED", False)
        for catalog in catalogs:
            monkeypatch.setattr(catalog, "_registry", {})
        module.register_all(str(tmp_path))
    return _both_cfgs("INPUT.MIN_SIZE_TRAIN", "(48, 64)", "INPUT.MAX_SIZE_TRAIN", "128", "INPUT.MIN_SIZE_TEST", "64",
                      "INPUT.MAX_SIZE_TEST", "128", "TPU.PAD_SIZE_TRAIN", "[96, 160]", "TPU.PAD_SIZE_TEST", "[64, 128]",
                      "TPU.PAD_BUCKETS", repr(LADDER), "SOLVER.IMS_PER_BATCH", "2", "MODEL.CLIP.IMS_PER_BATCH_TEST", "2",
                      "TPU.MASK_CANVAS_STRIDE", "4")


def _assert_batches_equal(got, want, fields):
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_the_cityscapes_instance_sets_load_and_score_as_jax(city_sets):
    ours, ref = city_sets
    check_supported(ours, world=1)
    names = ("image", "image_sizes", "orig_sizes", "gt_boxes", "gt_classes", "gt_valid", "gt_masks")
    want = jax_train_loader(ref, seed=3)
    with build_detection_train_loader(ours, seed=3) as got:
        shapes = set()
        for _ in range(4):
            g, w = next(got), next(want)
            _assert_batches_equal(g, w, names)
            assert g.gt_valid.any() and not g.gt_masks.any()  # boxes, and no masks to draw
            shapes.add(tuple(g.image.shape[1:3]))
    assert shapes <= {(64, 128), (96, 160)}  # ladder buckets, never the default pad
    name = "cityscapes_fine_instance_seg_val"
    want_loader, n_want = jax_test_loader(ref, name)
    got_loader, n = build_detection_test_loader(ours, name)
    with got_loader:
        pairs = list(zip(got_loader, want_loader, strict=True))
    assert n == n_want == 3
    for (g, g_meta), (w, w_meta) in pairs:
        _assert_batches_equal(g, w, names[:6])
        assert g_meta == w_meta
    assert MetadataCatalog.get(name).evaluator_type == JaxMetadataCatalog.get(name).evaluator_type == "pascal_voc"
    assert type(build_evaluator(ours, name)).__name__ == type(jax_build_evaluator(ref, name)).__name__ \
        == "PascalVOCDetectionEvaluator"


def test_the_cityscapes_file_is_accepted_with_the_jax_builders_fields():
    ours, ref = _both_cfgs()
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
    assert want.mask_on and want.num_classes == 8


def test_bucket_for_takes_the_ladder_as_jax():
    r = np.random.RandomState(0)
    ladder = [(800, 1088), (1344, 800), (640, 640), (1024, 2048)]
    for h, w in [(640, 640), (800, 1088), (1088, 800), (1024, 2048), (2048, 1024), (900, 2100), (10, 10)] + [
            tuple(int(v) for v in r.randint(100, 2200, 2)) for _ in range(200)]:
        sample = {"image": np.zeros((h, w, 1), np.uint8)}
        for buckets in (ladder, [], None):
            assert _bucket_for(sample, (800, 1344), buckets) == jax_bucket_for(sample, (800, 1344), buckets), (h, w)


# ---------------- the Cityscapes evaluators ----------------
def _square_masks(r, n, m=14):
    return (r.rand(n, m, m) > 0.4).astype(np.float32)


@pytest.mark.parametrize("task", ["bbox", "segm"])
def test_the_cityscapes_instance_evaluator_equals_jax(task):
    r = np.random.RandomState(1)
    ours, ref = CityscapesInstanceEvaluator(tasks=(task,)), JaxCityscapesInstanceEvaluator(tasks=(task,))
    hw = (60, 90)
    for img in range(3):
        x1, y1 = r.rand(4) * 50, r.rand(4) * 30
        gt = np.stack([x1, y1, x1 + 10 + r.rand(4) * 30, y1 + 10 + r.rand(4) * 25], 1)
        gc = r.randint(0, 8, 4)
        polys = [[[b[0], b[1], b[2], b[1], b[2], b[3], b[0], b[3]]] for b in gt]
        det = np.concatenate([gt + r.randn(4, 4) * 2, gt[:2] + 8])
        dc, ds = np.concatenate([gc, gc[:2]]), r.rand(6)
        masks = _square_masks(r, 6)
        for ev in (ours, ref):
            ev.process_gt(img, gt, gc, segmentations=polys, image_hw=hw)
            ev.process(img, det, ds, dc, masks=masks, image_hw=hw)
    got, want = ours.evaluate(), ref.evaluate()
    assert set(got) == set(want) == {task} and set(got[task]) == set(want[task]) == {"AP", "AP50"}
    for k, v in want[task].items():
        np.testing.assert_allclose(got[task][k], v, atol=1e-9, err_msg=k)
    assert ours.num_classes == ref.num_classes == 8


def test_the_cityscapes_sem_seg_evaluator_equals_jax():
    r = np.random.RandomState(2)
    ours, ref = CityscapesSemSegEvaluator(), JaxCityscapesSemSegEvaluator()
    for _ in range(3):
        gt = r.randint(0, 19, (20, 30))
        gt[r.rand(20, 30) < 0.2] = 255
        pred = np.where(r.rand(20, 30) < 0.7, gt, r.randint(0, 19, (20, 30)))
        for ev in (ours, ref):
            ev.process(pred, gt)
    got, want = ours.evaluate(), ref.evaluate()
    assert got.keys() == want.keys()
    for task in want:
        assert got[task].keys() == want[task].keys()
        for k, v in want[task].items():
            np.testing.assert_allclose(got[task][k], v, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("ev_type, mask_on, want", [
    ("cityscapes_instance", True, ("CityscapesInstanceEvaluator", ("segm",))),
    ("cityscapes_instance", False, ("CityscapesInstanceEvaluator", ("bbox",))),
    ("rotated_coco", False, ("RotatedCOCOEvaluator", ("bbox",))),
])
def test_build_evaluator_routes_the_new_types_as_jax(monkeypatch, ev_type, mask_on, want):
    name = f"test_{ev_type}"
    for catalog in (MetadataCatalog, JaxMetadataCatalog):
        monkeypatch.setattr(catalog, "_registry", {})
        catalog.get(name).set(thing_classes=["a", "b"], evaluator_type=ev_type)
    ours, ref = get_cfg(), jax_get_cfg()
    for cfg in (ours, ref):
        cfg.MODEL.MASK_ON = mask_on
    got, expect = build_evaluator(ours, name), jax_build_evaluator(ref, name)
    assert (type(got).__name__, got.tasks) == (type(expect).__name__, tuple(expect.tasks)) == want
    assert got.num_classes == expect.num_classes == 2
    assert isinstance(got, RotatedCOCOEvaluator) == (ev_type == "rotated_coco")


# ---------------- test-time augmentation ----------------
N = 16
_r = np.random.RandomState(3)
BASE = np.concatenate([_r.rand(N // 2, 2) * 40, _r.rand(N // 2, 2) * 40], 1).astype(np.float32)
BASE[:, 2:] += BASE[:, :2] + 8
BASE = np.concatenate([BASE, BASE + 1.5]).astype(np.float32)  # overlapping pairs for the merge
SHIFT = np.array([6.0, 1.0, 6.0, 1.0], np.float32)
LOGITS = _r.randn(N).astype(np.float32)
CLASSES = _r.randint(0, 3, N).astype(np.int32)


class _JaxStub(nn.Module):
    """Detections that move with the mean of the image's left half, so the
    flipped pass sees another image."""

    def __call__(self, batch):
        return self.inference(batch)

    def inference(self, batch):
        w = batch.image.shape[2]
        m = jnp.mean(batch.image[:, :, : w // 2], axis=(1, 2, 3)) / 255.0
        boxes = jnp.asarray(BASE)[None] + m[:, None, None] * jnp.asarray(SHIFT)
        scores = jax.nn.sigmoid(jnp.asarray(LOGITS)[None] + 4.0 * m[:, None] - 2.0)
        classes = jnp.broadcast_to(jnp.asarray(CLASSES), scores.shape)
        return JaxDetectionResult(boxes, scores, classes, scores > 0.3)


class _TorchStub:
    def inference(self, batch):
        w = batch.image.shape[2]
        m = batch.image[:, :, : w // 2].mean(dim=(1, 2, 3)) / 255.0
        boxes = torch.from_numpy(BASE)[None] + m[:, None, None] * torch.from_numpy(SHIFT)
        scores = torch.sigmoid(torch.from_numpy(LOGITS)[None] + 4.0 * m[:, None] - 2.0)
        classes = torch.from_numpy(CLASSES).expand(scores.shape)
        return DetectionResult(boxes, scores, classes, scores > 0.3)


def test_tta_merges_the_flipped_detections_as_jax():
    r = np.random.RandomState(4)
    image = np.zeros((2, 48, 80, 3), np.float32)
    image[0] = r.rand(48, 80, 3) * 255
    image[1, :40, :64] = r.rand(40, 64, 3) * 255
    sizes = np.array([[48, 80], [40, 64]], np.int32)
    orig = np.array([[48, 80], [40, 64]], np.int32)
    jb = JaxDetBatch(image=jnp.asarray(image), image_sizes=jnp.asarray(sizes), orig_sizes=jnp.asarray(orig),
                     gt_boxes=None, gt_classes=None, gt_valid=None)
    want = JaxGeneralizedRCNNWithTTA(_JaxStub(), {}, max_det=10)(jb)
    got = GeneralizedRCNNWithTTA(_TorchStub(), max_det=10)(
        DetBatch(torch.from_numpy(image), torch.from_numpy(sizes), torch.from_numpy(orig)))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    for g, w in ((got.boxes, want.boxes), (got.scores, want.scores)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    assert got.valid.sum() > 4 and not got.valid.all()  # the merge kept some and dropped others
    plain = _TorchStub().inference(DetBatch(torch.from_numpy(image), None, None))
    assert not torch.allclose(plain.boxes[0, :1], got.boxes[0, :1])  # the flipped pass counted


# ---------------- SOLVER.NESTEROV ----------------
@pytest.mark.parametrize("nesterov", [True, False])
def test_a_nesterov_step_equals_optax(nesterov):
    r = np.random.RandomState(5)
    ours, ref = get_cfg(), jax_get_cfg()
    for cfg in (ours, ref):
        cfg.merge_from_list(["SOLVER.NESTEROV", str(nesterov), "SOLVER.BASE_LR", "0.1", "SOLVER.WARMUP_ITERS", "0",
                             "SOLVER.MOMENTUM", "0.9", "SOLVER.WEIGHT_DECAY", "0.01"])
    check_supported(ours, world=1)
    shapes = {"kernel": (6, 4), "bias": (4,)}
    init = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: r.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    params = {"head": {k: jnp.asarray(v) for k, v in init.items()}}
    tx = jax_build_optimizer(ref, params)
    state = tx.init(params)
    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = Optimizer(list(torch_params.values()), solver_config_from_cfg(ours))
    for g in grads:
        updates, state = tx.update({"head": {k: jnp.asarray(v) for k, v in g.items()}}, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in torch_params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["head"][k]), rtol=0, atol=1e-6)
    if nesterov:  # the flag changes the update
        plain = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
        opt_plain = Optimizer(list(plain.values()), solver_config_from_cfg(get_cfg()))
        for g in grads:
            for k, p in plain.items():
                p.grad = torch.from_numpy(g[k].copy())
            opt_plain.step()
        assert not torch.allclose(plain["kernel"], torch_params["kernel"])


def test_the_keys_of_this_slice_are_taken_and_tta_stays_refused():
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER", "True", "SOLVER.NESTEROV", "True",
                         "TPU.PAD_BUCKETS", repr(LADDER)])
    check_supported(cfg, world=1)
    assert solver_config_from_cfg(cfg).nesterov
    cfg.merge_from_list(["TEST.AUG.ENABLED", "True"])
    with pytest.raises(NotImplementedError, match=r"TEST\.AUG\.ENABLED"):
        check_supported(cfg, world=1)
