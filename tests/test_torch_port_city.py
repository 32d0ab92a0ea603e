"""The adverse-weather slice of the port against cddmsl_tpu on the CPU: the
Cityscapes and COCO loaders, the builtin names, reference detector
checkpoints through MODEL.WEIGHTS, the COCO bbox evaluator, the predictor's
load order and `python -m cddmsl_torch.train_net` on the tiny recipe.

- Loaders: `load_cityscapes_instances`, `load_cityscapes_DG_instances` and
  `load_coco_json` give JAX's records on the fixtures (a "persongroup" and a
  label outside the 8 classes, a missing fog twin; non-contiguous category
  ids, a crowd box, an image without boxes). On the fog layout itself both
  packages' cityscapes_foggy set finds no image.
- Checkpoints: `load_rcnn_weights` gives the parameters of JAX's on
  d2_rcnn (with and without background rows), oai_clip and clipcap files,
  compared through `convert_jax_params`; a tensor of another shape raises
  where JAX skips it; MODEL.WEIGHTS is routed by content (a save of the
  port's against a detectron2 `model_final.pth`).
- The COCO evaluator gives JAX's dict and dump on seeded detections.
- The tiny adverse-weather recipe trains 2 steps with `train_net.main`,
  then evaluates `--eval-only` from a d2_rcnn file of its weights; the
  detections of every test batch, fed to JAX's loaders and evaluators,
  give the port's AP dicts.

No JAX step is compiled: the JAX parameters' shapes come from
`jax_param_shapes`, those of `eval_shape`. A test
that reads the builtin names registers them at its fixture's root into empty
catalogs (`builtins_at`), which are put back after it.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from cddmsl_tpu.checkpoint.convert_torch import detect_dialect as jax_detect_dialect
from cddmsl_tpu.checkpoint.convert_torch import load_rcnn_weights as jax_load_rcnn_weights
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.data import DatasetCatalog as JaxDatasetCatalog
from cddmsl_tpu.data import MetadataCatalog as JaxMetadataCatalog
from cddmsl_tpu.data import build_detection_test_loader as jax_test_loader
from cddmsl_tpu.data.datasets import builtin as jax_builtin
from cddmsl_tpu.data.datasets import cityscapes as jax_city
from cddmsl_tpu.data.datasets.coco import load_coco_json as jax_load_coco_json
from cddmsl_tpu.data.datasets.synthetic import make_synthetic_coco as jax_make_synthetic_coco
from cddmsl_tpu.engine.defaults import build_evaluator as jax_build_evaluator
from cddmsl_tpu.evaluation import COCOEvaluator as JaxCOCOEvaluator
from cddmsl_tpu.evaluation import inference_on_dataset as jax_inference_on_dataset
from cddmsl_tpu.models.fast_rcnn import DetectionResult
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.checkpointer import DetectionCheckpointer, is_port_save
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.checkpoint.convert_torch import detect_dialect, load_rcnn_weights
from cddmsl_torch.config import get_cfg, model_config_from_cfg, solver_config_from_cfg
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog
from cddmsl_torch.data.datasets import builtin, cityscapes
from cddmsl_torch.data.datasets.coco import load_coco_json
from cddmsl_torch.data.datasets.synthetic import make_synthetic_bdd, make_synthetic_cityscapes, make_synthetic_coco
from cddmsl_torch.engine.defaults import DefaultPredictor, build_evaluator, default_argument_parser
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.evaluation import COCOEvaluator
from cddmsl_torch.models.build import build_model
from cddmsl_torch.models.rcnn import GeneralizedRCNN
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_backbone import fill_params, jax_param_shapes

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CITY_TINY = REPO / "cddmsl_torch" / "configs" / "city_tiny.yaml"
HW = (64, 128)
K = 8  # Cityscapes classes
BOX = "roi_heads.box_predictor."


# ---------------- fixtures ----------------
@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    """The tiny Cityscapes train (with fog twins) and val (without) splits
    and the BDD-style COCO set, under one dataset root."""
    root = tmp_path_factory.mktemp("city")
    make_synthetic_cityscapes(str(root), n=4, seed=0, hw=HW, split="train")
    make_synthetic_cityscapes(str(root), n=4, seed=1, hw=HW, split="val", foggy=False)
    make_synthetic_bdd(str(root), n=4, seed=2, hw=(72, 128), classes=("person", "car", "bike"))
    return root


@pytest.fixture
def builtins_at(monkeypatch):
    """`register_all(root)` of both packages into empty catalogs, as a
    process started with $DETECTRON2_DATASETS=root registers them; the
    catalogs and the once-only flags are restored after the test."""
    def register(root):
        for module, catalogs in ((builtin, (DatasetCatalog, MetadataCatalog)),
                                 (jax_builtin, (JaxDatasetCatalog, JaxMetadataCatalog))):
            monkeypatch.setattr(module, "_REGISTERED", False)
            for catalog in catalogs:
                monkeypatch.setattr(catalog, "_registry", {})
            module.register_all(str(root))

    return register


def _tiny_cfg(**overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(CITY_TINY))
    cfg.merge_from_list([x for k, v in overrides.items() for x in (k, v)])
    return cfg


@pytest.fixture(scope="module")
def tiny_params():
    """The tiny adverse-weather model's JAX parameters: shapes of
    `jax_param_shapes` (those of `eval_shape`), seeded values."""
    ref = jax_get_cfg()
    ref.merge_from_file(str(CITY_TINY))
    return fill_params(jax_param_shapes(model_config_from_cfg(ref)), seed=11)


def _port_model(params):
    model = build_model(model_config_from_cfg(_tiny_cfg()), device="cpu", training=True)
    model.load_state_dict(convert_jax_params(params), strict=True)
    return model


# ---------------- datasets ----------------
def test_cityscapes_loaders_equal_jax(city_root):
    city = city_root / "cityscapes"
    img, gt, fog = (str(city / sub / "train") for sub in ("leftImg8bit", "gtFine", "leftImg8bit_foggy"))
    got = cityscapes.load_cityscapes_instances(img, gt)
    assert got == jax_city.load_cityscapes_instances(img, gt)
    dg = cityscapes.load_cityscapes_DG_instances(img, gt, fog)
    assert dg == jax_city.load_cityscapes_DG_instances(img, gt, fog)
    labels = [o["label"] for o in json.loads(next(Path(gt).rglob("*000000_000019_gtFine_polygons.json")).read_text())
              ["objects"]]
    first = next(r for r in got if r["image_id"].endswith("000000_000019"))
    assert labels[:2] == ["persongroup", "sky"] and len(first["annotations"]) == sum(x != "sky" for x in labels)
    assert first["annotations"][0]["category_id"] == 0  # the group counts as a person
    twins = [r["data_dt_file_name"] for r in dg]
    assert sum(t.endswith("_foggy_beta_0.02.png") for t in twins) == 3 and dg[-1]["image_id"].endswith("000003_000019")
    assert twins[-1] == dg[-1]["file_name"]  # no twin: the clear image


def test_the_foggy_sets_find_no_image_on_the_fog_layout_in_either_package(tmp_path, builtins_at):
    """A fault of both packages: cityscapes_foggy_<split> reads
    leftImg8bit_foggy/<split> when it exists, whose files do not end in
    'leftImg8bit.png'. The recipe's first test set is empty there."""
    make_synthetic_cityscapes(str(tmp_path), n=2, seed=3, hw=HW, split="val")
    fog, gt = str(tmp_path / "cityscapes" / "leftImg8bit_foggy" / "val"), str(tmp_path / "cityscapes" / "gtFine" / "val")
    assert cityscapes.load_cityscapes_instances(fog, gt) == jax_city.load_cityscapes_instances(fog, gt) == []
    builtins_at(tmp_path)
    for datasets, metadata in ((DatasetCatalog, MetadataCatalog), (JaxDatasetCatalog, JaxMetadataCatalog)):
        assert metadata.get("cityscapes_foggy_val").image_dir == fog
        assert datasets.get("cityscapes_foggy_val") == [] and len(datasets.get("cityscapes_val")) == 2


def test_coco_writer_and_loader_equal_jax(tmp_path):
    ours_json, ours_root = make_synthetic_coco(str(tmp_path / "port"), n=4, seed=3)
    want_json, want_root = jax_make_synthetic_coco(str(tmp_path / "jax"), n=4, seed=3)
    for name in sorted(os.listdir(want_root)):
        assert (Path(ours_root) / name).read_bytes() == (Path(want_root) / name).read_bytes(), name
    coco, want = json.loads(Path(ours_json).read_text()), json.loads(Path(want_json).read_text())
    for a in want["annotations"]:
        del a["segmentation"]  # the port's writer is boxes only
    assert coco == want
    # non-contiguous ids listed out of order, a crowd box, an image without boxes
    remap = {1: 17, 2: 5}
    coco["categories"] = [{"id": remap[c["id"]], "name": c["name"]} for c in reversed(coco["categories"])]
    for a in coco["annotations"]:
        a["category_id"] = remap[a["category_id"]]
    coco["annotations"][0]["iscrowd"] = 1
    coco["images"].append({"id": 99, "file_name": "000000.jpg", "height": 100, "width": 140})
    Path(ours_json).write_text(json.dumps(coco))
    try:
        got = load_coco_json(ours_json, ours_root, "port_test_coco")
        assert got == jax_load_coco_json(ours_json, ours_root, "port_test_coco")
        assert MetadataCatalog.get("port_test_coco").as_dict() == JaxMetadataCatalog.get("port_test_coco").as_dict()
        assert MetadataCatalog.get("port_test_coco").thing_classes == ["cat", "dog"]  # sorted by id: 5, 17
    finally:
        MetadataCatalog.remove("port_test_coco")
        JaxMetadataCatalog._registry.pop("port_test_coco", None)
    want_boxes = [[x, y, x + w, y + h] for a in coco["annotations"][1:] for x, y, w, h in [a["bbox"]]]
    assert [a["bbox"] for r in got for a in r["annotations"]] == want_boxes and got[-1]["annotations"] == []


def test_builtin_adverse_weather_names_equal_jax(city_root, builtins_at):
    builtins_at(city_root)
    names = ["cityscapes_train", "cityscapes_DG_train", "cityscapes_foggy_train", "cityscapes_val",
             "cityscapes_DG_val", "cityscapes_foggy_val", "bdd_100k_val"]
    assert set(names) <= set(DatasetCatalog.list()) <= set(JaxDatasetCatalog.list())
    for name in names:
        assert MetadataCatalog.get(name).as_dict() == JaxMetadataCatalog.get(name).as_dict(), name
    # the fixture's train split has fog twins, its val split none
    assert MetadataCatalog.get("cityscapes_foggy_train").image_dir.endswith("leftImg8bit_foggy/train")
    assert MetadataCatalog.get("cityscapes_foggy_val").image_dir.endswith("leftImg8bit/val")


# ---------------- reference checkpoints ----------------
def _detectron2_file(path, sd):
    """`sd` in a detectron2 `model_final.pth`: model, optimizer, scheduler
    and iteration."""
    torch.save({"model": sd, "optimizer": {"state": {}, "param_groups": [{"lr": 0.01, "params": []}]},
                "scheduler": {"last_epoch": 100}, "iteration": 100, "__author__": "a test"}, path)
    return str(path)


def _reference_sd(model, dialect, background, seed=0):
    """A random checkpoint of `dialect` with the model's shapes under the
    reference's names, and keys that no converter takes."""
    g = torch.Generator().manual_seed(seed)
    rand = lambda t: torch.randn(t.shape, generator=g)
    state = model.state_dict()
    if dialect == "clipcap":
        sd = {"clip_project." + k[len("v2l_mapper."):]: rand(v) for k, v in state.items() if k.startswith("v2l_mapper.")}
        sd["gpt.wte.weight"] = torch.randn(5, 3, generator=g)
        return sd
    prefix = "visual." if dialect == "oai_clip" else "backbone."
    sd = {prefix + k[len("backbone."):]: rand(v) for k, v in state.items() if k.startswith("backbone.")}
    sd[prefix + "bn1.num_batches_tracked"] = torch.tensor(7)
    if dialect == "oai_clip":
        sd["transformer.resblocks.0.ln_1.weight"] = torch.randn(8, generator=g)
        return sd
    sd.update({k: rand(v) for k, v in state.items() if k.startswith(("proposal_generator.", BOX))})
    if background:
        d = state[BOX + "cls_score.weight"].shape[1]
        sd[BOX + "cls_score.weight"] = torch.randn(K + 1, d, generator=g)
        sd[BOX + "bbox_pred.weight"] = torch.randn((K + 1) * 4, d, generator=g)
        sd[BOX + "bbox_pred.bias"] = torch.randn((K + 1) * 4, generator=g)
    sd["offline_backbone.conv1.weight"] = torch.randn(3, generator=g)
    sd["proposal_generator.anchor_generator.cell_anchors.0"] = torch.randn(15, 4, generator=g)
    return sd


@pytest.mark.parametrize("dialect, background", [("d2_rcnn", True), ("d2_rcnn", False), ("oai_clip", False),
                                                 ("clipcap", False)])
def test_load_rcnn_weights_equals_jax(tiny_params, tmp_path, dialect, background):
    model = _port_model(tiny_params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = _reference_sd(model, dialect, background)
    path = _detectron2_file(tmp_path / "ref.pth", sd)
    assert detect_dialect(sd) == jax_detect_dialect(sd) == dialect
    assert load_rcnn_weights(model, path) == dialect
    want = convert_jax_params(jax_load_rcnn_weights(tiny_params, path))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    towers = {"d2_rcnn": ("backbone.", "offline_backbone.", "proposal_generator.", BOX),
              "oai_clip": ("backbone.", "offline_backbone."), "clipcap": ("v2l_mapper.",)}[dialect]
    for k, v in got.items():
        assert torch.equal(v, before[k]) != k.startswith(towers), k  # every loaded tensor moved, no other
    if dialect == "d2_rcnn":
        cut = 1 if background else 0
        assert torch.equal(got[BOX + "cls_score.weight"], sd[BOX + "cls_score.weight"][cut:])
        assert torch.equal(got[BOX + "bbox_pred.bias"], sd[BOX + "bbox_pred.bias"][4 * cut:])
        assert torch.equal(got["offline_backbone.conv1.weight"], sd["backbone.conv1.weight"])


def test_a_tensor_of_another_shape_raises_where_jax_skips_it(tiny_params, tmp_path):
    model = _port_model(tiny_params)
    sd = _reference_sd(model, "d2_rcnn", False)
    sd[BOX + "bbox_pred.bias"] = torch.zeros(K * 4 + 3)
    path = _detectron2_file(tmp_path / "ref.pth", sd)
    with pytest.raises(ValueError, match="bbox_pred.bias"):
        load_rcnn_weights(model, path)
    want = convert_jax_params(jax_load_rcnn_weights(tiny_params, path))
    assert torch.equal(want[BOX + "bbox_pred.bias"], convert_jax_params(tiny_params)[BOX + "bbox_pred.bias"])


@pytest.mark.parametrize("dialect, key", [("d2_fpn", "backbone.bottom_up.stem.conv1.weight"),
                                          ("d2_retinanet", "head.cls_subnet.0.weight"),
                                          ("lang", "lang_encoder.token_embedding.weight"), ("unknown", "w")])
def test_other_dialects_raise_naming_the_dialect(tmp_path, dialect, key):
    sd = {key: torch.zeros(2)}
    assert detect_dialect(sd) == jax_detect_dialect(sd) == dialect
    model = build_model(model_config_from_cfg(_tiny_cfg()), device="cpu")
    error, match = (ValueError, "Cannot detect") if dialect == "unknown" else (NotImplementedError, dialect)
    with pytest.raises(error, match=match):
        load_rcnn_weights(model, _detectron2_file(tmp_path / "x.pth", sd))


def _trainer(cfg, seed):
    model = build_model(model_config_from_cfg(cfg), device="cpu", training=True)
    torch.manual_seed(seed)
    for p in model.parameters():
        p.data.normal_()
    optimizer = build_optimizer(model, solver_config_from_cfg(cfg))
    return Trainer(model, optimizer, caption_burnup_iters=0)


@pytest.mark.parametrize("kind", ["save", "detectron2"])
def test_model_weights_are_routed_by_content(tmp_path, kind):
    """A save of the port's (the layout of every save it has written)
    restores the whole state bit for bit; a detectron2 model_final.pth
    holding model, optimizer, scheduler and iteration loads as a reference
    checkpoint."""
    cfg = _tiny_cfg()
    src = _trainer(cfg, 0)
    for p in src.optimizer.sgd.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    src.optimizer.step()
    src.iteration = 7
    ckpt = DetectionCheckpointer(str(tmp_path / "out"))
    path = str(tmp_path / "weights.pth")
    if kind == "save":
        path = ckpt.save("model_0000006", src)
        assert torch.load(path, weights_only=False).keys() == {"model", "optimizer", "iteration"}
    else:
        path = _detectron2_file(path, _reference_sd(src.model, "d2_rcnn", True, seed=5))
    assert is_port_save(torch.load(path, weights_only=False)) == (kind != "detectron2")

    dst = _trainer(cfg, 1)
    before = {k: v.clone() for k, v in dst.model.state_dict().items()}
    DetectionCheckpointer(str(tmp_path / "fresh")).resume_or_load(path, dst, resume=True)
    got = dst.state_dict()
    if kind == "detectron2":
        assert got["iteration"] == 0 and got["optimizer"]["count"] == 0
        assert not torch.equal(got["model"]["backbone.conv1.weight"], before["backbone.conv1.weight"])
        assert torch.equal(got["model"]["projector.fc1.weight"], before["projector.fc1.weight"])
        return
    want = src.state_dict()
    assert got["iteration"] == 7 and got["optimizer"]["count"] == 1
    for name, value in want["model"].items():
        assert torch.equal(got["model"][name], value), name
    sgd = want["optimizer"]["sgd"]["state"]
    assert len(sgd) > 0
    for i in sgd:
        assert torch.equal(got["optimizer"]["sgd"]["state"][i]["momentum_buffer"], sgd[i]["momentum_buffer"])


def test_predictor_holds_the_text_file_rows_over_model_weights(tmp_path):
    model = build_model(model_config_from_cfg(_tiny_cfg()), device="cpu", training=True)
    sd = _reference_sd(model, "d2_rcnn", True, seed=2)
    weights = _detectron2_file(tmp_path / "ref.pth", sd)
    rows = torch.randn(K, sd[BOX + "cls_score.weight"].shape[1], generator=torch.Generator().manual_seed(3))
    torch.save(rows, tmp_path / "emb.pth")
    predictor = DefaultPredictor(_tiny_cfg(**{"MODEL.WEIGHTS": weights,
                                              "MODEL.CLIP.TEXT_EMB_PATH": str(tmp_path / "emb.pth")}), device="cpu")
    got = predictor.model.state_dict()
    assert torch.equal(got[BOX + "cls_score.weight"], rows)
    assert torch.equal(got[BOX + "bbox_pred.weight"], sd[BOX + "bbox_pred.weight"][4:])
    assert torch.equal(got["backbone.conv1.weight"], sd["backbone.conv1.weight"])


# ---------------- COCO evaluation ----------------
def test_coco_evaluator_equals_jax(tmp_path):
    r = np.random.RandomState(4)
    classes = ["a", "b", "c", "d"]
    for cat in (MetadataCatalog, JaxMetadataCatalog):
        cat.get("port_test_coco_eval").set(thing_classes=classes, evaluator_type="coco")
    try:
        ours = COCOEvaluator("port_test_coco_eval", output_json=str(tmp_path / "ours.json"))
        ref = JaxCOCOEvaluator("port_test_coco_eval", output_json=str(tmp_path / "ref.json"))
        for image_id in range(6):
            g = r.randint(0, 6)
            xy = r.rand(g, 2) * 200
            gt = np.concatenate([xy, xy + 8 + r.rand(g, 2) * 150], 1).astype(np.float32)
            gt_cls = r.choice([0, 1, 3], g)  # "c" has no ground truth
            crowd = r.rand(g) < 0.15
            n = r.randint(0, 15)
            pick = r.randint(0, max(g, 1), n)
            boxes = (gt[pick] if g else np.zeros((n, 4), np.float32)) + r.randn(n, 4).astype(np.float32) * 6
            boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
            scores, det_cls = r.rand(n).astype(np.float32), r.choice(4, n)
            for ev in (ours, ref):
                ev.process(image_id, boxes, scores, det_cls)
                ev.process_gt(image_id, gt, gt_cls, crowd)
        got, want = ours.evaluate(), ref.evaluate()
        np.testing.assert_equal(got, want)
        assert set(got) == {"bbox"} and 0 < got["bbox"]["AP"] < 100
        assert json.loads((tmp_path / "ours.json").read_text()) == json.loads((tmp_path / "ref.json").read_text())
    finally:
        MetadataCatalog.remove("port_test_coco_eval")
        JaxMetadataCatalog._registry.pop("port_test_coco_eval", None)


def test_build_evaluator_takes_coco_for_boxes_only(tmp_path):
    MetadataCatalog.get("port_test_coco_only").set(evaluator_type="coco", thing_classes=["a"])
    try:
        cfg = _tiny_cfg(OUTPUT_DIR=str(tmp_path))
        ev = build_evaluator(cfg, "port_test_coco_only")
        assert ev.output_json == str(tmp_path / "inference" / "coco_instances_results_port_test_coco_only.json")
        cfg.MODEL.MASK_ON = True
        with pytest.raises(NotImplementedError, match="segm"):
            build_evaluator(cfg, "port_test_coco_only")
    finally:
        MetadataCatalog.remove("port_test_coco_only")


# ---------------- the recipe end to end ----------------
def _flat(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_the_baseline_recipe_trains_the_supervised_losses_alone(city_root, tmp_path, builtins_at):
    recipes = REPO / "configs" / "AdverseWeather-Experiments"
    c4, baseline = get_cfg(), get_cfg()
    c4.merge_from_file(str(recipes / "faster_rcnn_CLIP_R_50_C4.yaml"))
    baseline.merge_from_file(str(recipes / "faster_rcnn_CLIP_R_50_baseline.yaml"))
    differ = {k for (k, v), (k2, v2) in zip(_flat(c4), _flat(baseline), strict=True) if (k, v) != (k2, v2)}
    assert differ == {"TPU.ENABLE_CAPTION_CONSISTENCY"} and baseline.MODEL.KD_REGULRAZIATION
    builtins_at(city_root)
    out = tmp_path / "baseline"
    argv = ["--device", "cpu", "--config-file", str(CITY_TINY), "TPU.ENABLE_CAPTION_CONSISTENCY", "False",
            "DATASETS.TEST", "('cityscapes_val',)", "OUTPUT_DIR", str(out)]
    results = train_net.main(default_argument_parser().parse_args(argv))
    assert list(results) == ["cityscapes_val"]
    logged = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
    losses = {k for k in logged[-1] if k.startswith("loss") or k.endswith("_loss") or "_loss_" in k}
    assert losses == {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "total_loss"}, logged[-1]


def _d2_from_port_save(port_path, path):
    """A port save's backbone, RPN head and box predictor as a d2_rcnn
    detector checkpoint, with a background row put back in front."""
    model = torch.load(port_path, weights_only=False)["model"]
    sd = {k: v for k, v in model.items() if k.startswith(("backbone.", "proposal_generator.", BOX))}
    for name, n in (("cls_score.weight", 1), ("bbox_pred.weight", 4), ("bbox_pred.bias", 4)):
        sd[BOX + name] = torch.cat([torch.full_like(sd[BOX + name][:n], 0.5), sd[BOX + name]])
    return _detectron2_file(path, sd)


def test_train_net_trains_then_evaluates_a_reference_checkpoint_as_jax_scores_it(city_root, tmp_path, monkeypatch,
                                                                                  builtins_at):
    builtins_at(city_root)
    argv = ["--device", "cpu", "--config-file", str(CITY_TINY), "OUTPUT_DIR", str(tmp_path / "train")]
    trained = train_net.main(default_argument_parser().parse_args(argv))
    assert list(trained) == ["cityscapes_foggy_val", "bdd_100k_val", "cityscapes_val"]
    weights = _d2_from_port_save(tmp_path / "train" / "model_final.pth", tmp_path / "model_final_d2.pth")

    batches = []
    inference = GeneralizedRCNN.inference

    def spy(self, batch):
        det = inference(self, batch)
        batches.append((batch.image.numpy(), det))
        return det

    monkeypatch.setattr(GeneralizedRCNN, "inference", spy)
    argv = ["--device", "cpu", "--eval-only", "--config-file", str(CITY_TINY), "MODEL.WEIGHTS", weights,
            "OUTPUT_DIR", str(tmp_path / "eval")]
    got = train_net.main(default_argument_parser().parse_args(argv))
    np.testing.assert_equal(got, trained)  # the same weights, through the reference dialect

    ref = jax_get_cfg()
    ref.merge_from_file(str(CITY_TINY))
    ref.OUTPUT_DIR = str(tmp_path / "jax")
    recorded = iter(batches)

    def replay(params, batch):
        image, det = next(recorded)
        np.testing.assert_array_equal(np.asarray(batch.image), image)
        return DetectionResult(*(t.numpy() for t in (det.boxes, det.scores, det.classes, det.valid)))

    for name in got:
        loader, n = jax_test_loader(ref, name)
        want = jax_inference_on_dataset(replay, None, loader, n, jax_build_evaluator(ref, name))
        np.testing.assert_equal(got[name], want, err_msg=name)
    assert next(recorded, None) is None
    assert 0 < got["bdd_100k_val"]["bbox"]["AP50"] and 0 < got["cityscapes_val"]["bbox"]["AP50"]
    dump = lambda root, name: json.loads((root / "inference" / f"coco_instances_results_{name}.json").read_text())
    assert dump(tmp_path / "eval", "bdd_100k_val") == dump(tmp_path / "jax", "bdd_100k_val")
