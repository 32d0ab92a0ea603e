"""The open-vocabulary datasets and evaluation of the port against
cddmsl_tpu on the CPU: the LVIS loader, the builtin COCO, COCO-OVD and LVIS
names, `LVISEvaluator` and the 65-class COCO evaluator's
AP50_split_{target,base,all}, each fed through `inference_on_dataset` and
the test loader of its own package, and the open-set test head of
`DefaultTrainer.test` on the tiny detector.

The same seeded files and detections go through both packages. Tolerances:
the loaders' dicts and metadata exactly; every metric within 1e-9 (the
same float64 numpy on the same detections; NaN where both are NaN); the
open-set head's detections with equal classes, scores within 1e-5 and
boxes within 1e-3 px (test_torch_port_inference.py's ranking, ties matched
as a set: the tiny detector in float32 through both frameworks), and its
LVIS metrics within 1e-6.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.data import DatasetCatalog as JaxDatasetCatalog
from cddmsl_tpu.data import MetadataCatalog as JaxMetadataCatalog
from cddmsl_tpu.data import build_detection_test_loader as jax_test_loader
from cddmsl_tpu.data.datasets import builtin as jax_builtin
from cddmsl_tpu.data.datasets.coco import register_coco_instances as jax_register_coco
from cddmsl_tpu.data.datasets.coco_zeroshot_categories import COCO_OVD_ALL_CLS as JAX_OVD_ALL_CLS
from cddmsl_tpu.data.datasets.lvis import load_lvis_json as jax_load_lvis_json
from cddmsl_tpu.data.datasets.lvis import register_lvis_instances as jax_register_lvis
from cddmsl_tpu.engine import defaults as jax_defaults
from cddmsl_tpu.evaluation.coco_eval import COCOEvaluator as JaxCOCOEvaluator
from cddmsl_tpu.evaluation.evaluator import inference_on_dataset as jax_inference_on_dataset
from cddmsl_tpu.evaluation.lvis_eval import LVISEvaluator as JaxLVISEvaluator
from cddmsl_tpu.models.fast_rcnn import DetectionResult as JaxDetectionResult
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.config import get_cfg
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader
from cddmsl_torch.data.datasets import builtin
from cddmsl_torch.data.datasets.coco import register_coco_instances
from cddmsl_torch.data.datasets.coco_zeroshot_categories import COCO_OVD_ALL_CLS, COCO_SEEN_CLS, COCO_UNSEEN_CLS
from cddmsl_torch.data.datasets.lvis import load_lvis_json, register_lvis_instances
from cddmsl_torch.engine import defaults
from cddmsl_torch.evaluation import COCOEvaluator, LVISEvaluator, inference_on_dataset
from cddmsl_torch.models.fast_rcnn import DetectionResult
from test_torch_port_backbone import fill_params
from test_torch_port_inference import SCORE_ATOL, TIE_GAP, _assert_ranked_rows_match

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_IMAGES, N_CATS, MAX_DETS = 6, 12, 32
OPEN_SET = 7


def _image_hw(i):
    """Each image its own size, so a stand-in model can tell them apart."""
    return 40 + 2 * i, 64 + 3 * i


def write_lvis_fixture(root: Path, seed=0, n_images=N_IMAGES, n_cats=N_CATS):
    """An LVIS-format json (categories of sparse ids with image counts over
    the rare / common / frequent buckets, images named by coco_url or
    file_name, per-image negative and not-exhaustive ids, some of them
    unknown, boxes with segmentations) and its PNGs under root/coco/val2017;
    returns the json's path and the ground truth per image size."""
    r = np.random.RandomState(seed)
    counts = [3, 10, 11, 60, 100, 101, 900]  # rare, common and frequent, at the buckets' edges
    cats = [{"id": int(3 * c + 2), "name": f"thing_{c}", "image_count": int(r.choice(counts))}
            for c in r.permutation(n_cats)]
    ids = sorted(c["id"] for c in cats)
    images, annos, gt = [], [], {}
    (root / "coco" / "val2017").mkdir(parents=True, exist_ok=True)
    for i in range(n_images):
        h, w = _image_hw(i)
        name = f"{1000 + i:012d}.png"
        Image.fromarray((r.rand(h, w, 3) * 255).astype(np.uint8)).save(root / "coco" / "val2017" / name)
        pos = [int(c) for c in r.choice(ids, 3, replace=False)]
        rest = [c for c in ids if c not in pos]
        img = {"id": 1000 + i, "height": h, "width": w, "neg_category_ids": [int(rest[i % len(rest)]), 999],
               "not_exhaustive_category_ids": [pos[0], 998]}
        img.update({"coco_url": f"http://images.cocodataset.org/val2017/{name}"} if i % 2 else
                   {"file_name": f"val2017/{name}"})
        images.append(img)
        boxes = []
        for k in range(int(r.randint(1, 5))):
            x, y = r.rand() * w * 0.6, r.rand() * h * 0.6
            bw, bh = 4 + r.rand() * w * 0.4, 4 + r.rand() * h * 0.4
            cat = pos[k % len(pos)]
            annos.append({"id": len(annos) + 1, "image_id": 1000 + i, "category_id": int(cat), "area": bw * bh,
                          "bbox": [x, y, bw, bh], "segmentation": [[x, y, x + bw, y, x + bw, y + bh]]})
            boxes.append((ids.index(cat), [x, y, x + bw, y + bh]))
        gt[(h, w)] = boxes
    path = root / "lvis_fixture.json"
    path.write_text(json.dumps({"categories": cats, "images": images, "annotations": annos}))
    return path, gt


def seeded_detections(gt, n_classes, seed):
    """Per image size: the ground truth jittered, some at another class,
    and random boxes at random classes, with seeded scores (orig coords)."""
    r = np.random.RandomState(seed)
    out = {}
    for (h, w), boxes in gt.items():
        rows = []
        for c, b in boxes:
            for _ in range(2):
                jit = np.asarray(b) + r.randn(4) * 2
                rows.append((c if r.rand() > 0.2 else int(r.randint(n_classes)), jit, r.rand()))
        for _ in range(int(r.randint(3, 10))):
            x, y = r.rand() * w * 0.7, r.rand() * h * 0.7
            rows.append((int(r.randint(n_classes)), np.array([x, y, x + 5 + r.rand() * 20, y + 5 + r.rand() * 20]),
                         r.rand()))
        out[(h, w)] = rows[:MAX_DETS]
    return out


def _padded(rows_by_size, sizes):
    b = len(sizes)
    boxes, scores = np.zeros((b, MAX_DETS, 4), np.float32), np.zeros((b, MAX_DETS), np.float32)
    classes, valid = np.zeros((b, MAX_DETS), np.int32), np.zeros((b, MAX_DETS), bool)
    for i, (h, w) in enumerate(sizes):
        for j, (c, box, s) in enumerate(rows_by_size[(int(h), int(w))]):
            boxes[i, j], scores[i, j], classes[i, j], valid[i, j] = box, s, c, True
    return boxes, scores, classes, valid


class _StandIn:
    """A model whose `inference` returns the seeded detections of each
    row's original size."""

    def __init__(self, rows_by_size):
        self.rows = rows_by_size

    def inference(self, batch):
        return DetectionResult(*map(torch.from_numpy, _padded(self.rows, batch.orig_sizes.tolist())))


def _jax_stand_in(rows_by_size):
    return lambda params, batch: JaxDetectionResult(*_padded(rows_by_size, np.asarray(batch.orig_sizes).tolist()))


def _loader_cfgs():
    opts = ["INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96", "TPU.PAD_SIZE_TEST", "[64, 96]",
            "MODEL.CLIP.IMS_PER_BATCH_TEST", "4"]
    ours, ref = get_cfg(), jax_get_cfg()
    ours.merge_from_list(opts)
    ref.merge_from_list(opts)
    return ours, ref


@pytest.fixture
def registered():
    """Registers names in both packages' catalogs and takes them out after."""
    names = []

    def register(name, port_fn, jax_fn, *args):
        port_fn(name, *args)
        jax_fn(name, *args)
        names.append(name)

    yield register
    for name in names:
        for catalog in (DatasetCatalog, MetadataCatalog, JaxDatasetCatalog, JaxMetadataCatalog):
            catalog._registry.pop(name, None)


def _assert_metrics_equal(got, want, atol=1e-9):
    assert got.keys() == want.keys()
    for task in want:
        assert list(got[task]) == list(want[task]), task
        for k, v in want[task].items():
            g = got[task][k]
            assert (np.isnan(g) and np.isnan(v)) or abs(g - v) <= atol, (task, k, g, v)


# ---------------- the LVIS loader ----------------
def test_load_lvis_json_equals_jax(tmp_path, registered):
    path, _ = write_lvis_fixture(tmp_path)
    root = str(tmp_path / "coco")
    registered("port_test_lvis_load", register_lvis_instances, jax_register_lvis, str(path), root)
    got, want = DatasetCatalog.get("port_test_lvis_load"), JaxDatasetCatalog.get("port_test_lvis_load")
    assert got == want and len(got) == N_IMAGES
    assert got[0]["file_name"].endswith("val2017/000000001000.png") and got[1]["file_name"].endswith(
        "val2017/000000001001.png")
    assert all(d["neg_category_ids"] and d["not_exhaustive_category_ids"] for d in got)  # unknown ids dropped
    assert MetadataCatalog.get("port_test_lvis_load").as_dict() == JaxMetadataCatalog.get(
        "port_test_lvis_load").as_dict()
    meta = MetadataCatalog.get("port_test_lvis_load")
    assert meta.evaluator_type == "lvis" and len(meta.class_image_counts) == N_CATS
    assert load_lvis_json(str(path), root) == jax_load_lvis_json(str(path), root)


# ---------------- the builtin names ----------------
def test_registered_names_equal_jax(tmp_path, monkeypatch):
    """`register_all(root)` of both packages into empty catalogs: the COCO,
    COCO-OVD and LVIS names are JAX's, with JAX's files and evaluator type."""
    for module, catalogs in ((builtin, (DatasetCatalog, MetadataCatalog)),
                             (jax_builtin, (JaxDatasetCatalog, JaxMetadataCatalog))):
        monkeypatch.setattr(module, "_REGISTERED", False)
        for catalog in catalogs:
            monkeypatch.setattr(catalog, "_registry", {})
        module.register_all(str(tmp_path))
    names = [f"coco_2017_{s}" for s in ("train", "val")] + [
        f"coco_2017_ovd_{s}_{t}" for s in ("all", "b", "t") for t in ("train", "test")] + [
        f"lvis_{v}_{s}" for v in ("v1", "v0.5") for s in ("train", "val")]
    assert set(names) <= set(DatasetCatalog.list()) <= set(JaxDatasetCatalog.list())
    for name in names:
        got, want = MetadataCatalog.get(name), JaxMetadataCatalog.get(name)
        for key in ("json_file", "image_root", "evaluator_type"):
            assert got.get(key) == want.get(key), (name, key)
    assert MetadataCatalog.get("lvis_v1_val").evaluator_type == "lvis"
    assert COCO_OVD_ALL_CLS == JAX_OVD_ALL_CLS and len(COCO_SEEN_CLS) + len(COCO_UNSEEN_CLS) == 65


# ---------------- the evaluators through inference_on_dataset ----------------
def _evaluate_both(name, port_evaluator, jax_evaluator, rows):
    ours, ref = _loader_cfgs()
    loader, n = build_detection_test_loader(ours, name)
    with loader:
        got = inference_on_dataset(_StandIn(rows), loader, n, port_evaluator, torch.device("cpu"))
    jloader, jn = jax_test_loader(ref, name)
    want = jax_inference_on_dataset(_jax_stand_in(rows), None, jloader, jn, jax_evaluator)
    return got, want


def test_lvis_evaluator_equals_jax(tmp_path, registered):
    """Seeded detections, some on classes an image lists as negative or not
    exhaustive and some on classes it does not list, through each package's
    loader, `inference_on_dataset` and `LVISEvaluator`: every metric equal;
    without the ignore ids the AP would differ."""
    path, gt = write_lvis_fixture(tmp_path, seed=1)
    registered("port_test_lvis_eval", register_lvis_instances, jax_register_lvis, str(path), str(tmp_path / "coco"))
    rows = seeded_detections(gt, N_CATS, seed=2)
    DatasetCatalog.get("port_test_lvis_eval")  # the metadata's classes, before the evaluators read them
    JaxDatasetCatalog.get("port_test_lvis_eval")
    got, want = _evaluate_both("port_test_lvis_eval", LVISEvaluator("port_test_lvis_eval"),
                               JaxLVISEvaluator("port_test_lvis_eval"), rows)
    _assert_metrics_equal(got, want)
    assert list(got["bbox"]) == ["AP", "AP50", "AP75", "APr", "APc", "APf"] and 0 < got["bbox"]["AP50"] < 100

    class NoIgnore(LVISEvaluator):
        accepts_lvis_ignore = False

    loader, n = build_detection_test_loader(_loader_cfgs()[0], "port_test_lvis_eval")
    with loader:
        plain = inference_on_dataset(_StandIn(rows), loader, n, NoIgnore("port_test_lvis_eval"), torch.device("cpu"))
    assert plain["bbox"]["AP"] != got["bbox"]["AP"]


def write_ovd_coco_fixture(root: Path, seed=0):
    """A COCO json of the 65 open-vocabulary classes (ids in their order,
    with gaps), ground truth on novel and base classes, and its PNGs."""
    r = np.random.RandomState(seed)
    cats = [{"id": 2 * i + 1, "name": n} for i, n in enumerate(COCO_OVD_ALL_CLS)]
    (root / "val2017").mkdir(parents=True, exist_ok=True)
    images, annos, gt = [], [], {}
    for i in range(N_IMAGES):
        h, w = _image_hw(i)
        name = f"{2000 + i:012d}.png"
        Image.fromarray((r.rand(h, w, 3) * 255).astype(np.uint8)).save(root / "val2017" / name)
        images.append({"id": 2000 + i, "height": h, "width": w, "file_name": name})
        boxes = []
        for k in range(3):
            cls = COCO_UNSEEN_CLS[(2 * i + k) % 17] if k == 0 else COCO_SEEN_CLS[(5 * i + k) % 48]
            c = COCO_OVD_ALL_CLS.index(cls)
            x, y, bw, bh = r.rand() * w * 0.5, r.rand() * h * 0.5, 6 + r.rand() * w * 0.4, 6 + r.rand() * h * 0.4
            annos.append({"id": len(annos) + 1, "image_id": 2000 + i, "category_id": cats[c]["id"], "iscrowd": 0,
                          "area": bw * bh, "bbox": [x, y, bw, bh]})
            boxes.append((c, [x, y, x + bw, y + bh]))
        gt[(h, w)] = boxes
    path = root / "ovd.json"
    path.write_text(json.dumps({"categories": cats, "images": images, "annotations": annos}))
    return path, gt


def test_coco_ovd_split_metrics_equal_jax(tmp_path, registered):
    """The 65-class COCO evaluator of both packages on the same detections
    through their loaders: AP50_split_target, _base and _all first, then
    AP, AP50, ..., AP-<class>, every one equal."""
    path, gt = write_ovd_coco_fixture(tmp_path)
    registered("port_test_coco_ovd", register_coco_instances, jax_register_coco, str(path), str(tmp_path / "val2017"))
    DatasetCatalog.get("port_test_coco_ovd")
    JaxDatasetCatalog.get("port_test_coco_ovd")
    rows = seeded_detections(gt, 65, seed=3)
    got, want = _evaluate_both("port_test_coco_ovd", COCOEvaluator("port_test_coco_ovd"),
                               JaxCOCOEvaluator("port_test_coco_ovd"), rows)
    _assert_metrics_equal(got, want)
    splits = [k for k in got["bbox"] if k.startswith("AP50_split_")]
    assert splits == ["AP50_split_target", "AP50_split_base", "AP50_split_all"]
    assert all(0 <= got["bbox"][k] <= 100 for k in splits)


# ---------------- the open-set test head ----------------
class _Recording:
    """An evaluator that records what it is fed and hands everything on."""

    def __init__(self, inner, log):
        self._inner, self._log = inner, log

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def process(self, image_id, boxes, scores, classes, **kw):
        self._log[image_id] = (np.asarray(boxes), np.asarray(scores), np.asarray(classes))
        return self._inner.process(image_id, boxes, scores, classes, **kw)


def test_openset_test_head_equals_jax(tmp_path, registered, monkeypatch):
    """`DefaultTrainer.test` in both packages on the tiny detector (voc_tiny,
    class-agnostic boxes, MULTIPLY_RPN_SCORE) from one filled JAX tree, with
    OPENSET_TEST_NUM_CLASSES 7 from a seeded (7, 128) embedding file, on an
    LVIS-format set through the LVIS evaluator: the same detections, every
    class below 7, the same metrics."""
    path, _ = write_lvis_fixture(tmp_path, seed=4)
    registered("port_test_openset", register_lvis_instances, jax_register_lvis, str(path), str(tmp_path / "coco"))
    emb = torch.from_numpy(np.random.RandomState(5).randn(OPEN_SET, 128).astype(np.float32))
    torch.save(emb, tmp_path / "openset.pth")
    opts = ["MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", "True", "MODEL.CLIP.MULTIPLY_RPN_SCORE", "True",
            "MODEL.CLIP.OPENSET_TEST_NUM_CLASSES", str(OPEN_SET),
            "MODEL.CLIP.OPENSET_TEST_TEXT_EMB_PATH", str(tmp_path / "openset.pth"),
            "DATASETS.TEST", "('port_test_openset',)", "TPU.FAST_INIT", "True", "SEED", "0"]
    ours, ref = get_cfg(), jax_get_cfg()
    for cfg, out in ((ours, "port"), (ref, "jax")):
        cfg.merge_from_file(str(REPO / "cddmsl_torch" / "configs" / "voc_tiny.yaml"))
        cfg.merge_from_list(opts + ["OUTPUT_DIR", str(tmp_path / out)])
    logs = {"port": {}, "jax": {}}
    for module, key in ((defaults, "port"), (jax_defaults, "jax")):
        build = module.build_evaluator
        monkeypatch.setattr(module, "build_evaluator", lambda c, n, b=build, k=key: _Recording(b(c, n), logs[k]))

    jax_trainer = jax_defaults.DefaultTrainer(ref)
    shapes = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jax_trainer.state.params)
    params = fill_params(shapes, seed=6)
    head = params["params"]["proposal_generator"]["head"]
    for name in ("objectness_logits", "anchor_deltas"):  # near the 0.01 std of the RPN head's own init
        head[name]["kernel"] = head[name]["kernel"] / 4
    want = jax_trainer.test(state=params)["port_test_openset"]

    trainer = defaults.DefaultTrainer(ours, device="cpu")
    trainer.model.load_state_dict(convert_jax_params(params), strict=True)
    got = trainer.test()["port_test_openset"]
    assert trainer.model.roi_heads.box_predictor.cls_score.weight.shape[0] == 20  # the trained model is untouched
    _assert_metrics_equal(got, want, atol=1e-6)

    assert logs["port"].keys() == logs["jax"].keys() and len(logs["port"]) == N_IMAGES
    n_dets = 0
    for image_id, (boxes, scores, classes) in logs["jax"].items():
        g_boxes, g_scores, g_classes = logs["port"][image_id]
        assert len(g_scores) == len(scores) and (g_classes < OPEN_SET).all()
        n_dets += len(scores)
        order, g_order = np.argsort(-scores, kind="stable"), np.argsort(-g_scores, kind="stable")
        rows = lambda b, s, c, o: [(int(c[i]), b[i], float(s[i])) for i in o]  # noqa: E731
        _assert_ranked_rows_match(
            g_scores[g_order], rows(g_boxes, g_scores, g_classes, g_order), scores[order],
            rows(boxes, scores, classes, order), TIE_GAP["detection"],
            lambda g, w: g[0] == w[0] and np.abs(g[1] - w[1]).max() <= 1e-3 and abs(g[2] - w[2]) <= SCORE_ATOL)
    assert n_dets > 0
