"""The port's configuration, data pipeline, evaluation and side-loads against
cddmsl_tpu on the CPU.

- Config: the VOC recipe and the tiny recipe (`cddmsl_torch/configs/
  voc_tiny.yaml`) load to the same values in both packages, and map to the
  fields the JAX builder derives; `_flagship_cfg` maps to the flagship
  dataclasses exactly; a value the port does not implement raises, naming
  its key.
- Data: the fixture writer writes the same bytes; the first train batches
  and every test batch with its metadata are equal bit for bit; the paired
  view shares the source's transforms.
- Evaluation: the VOC evaluator gives equal results on seeded detections
  (all classes and the 6-class subset, both AP metrics), and
  `inference_on_dataset` on the converted tiny JAX weights gives JAX's AP
  dict from the same detections (the module's one JAX compile: the tiny
  inference at 4x96x160).
- Solver: clipping by value and by norm, and the cosine and constant-warmup
  schedules, against optax and `build_lr_schedule`.
- The side-loads of RegionCLIP, ClipCap and text-embedding `.pth` files
  give the JAX converters' parameters; the positional-embedding resize is
  `jax.image.resize`.

Every catalog name a test registers is removed again.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.data import DatasetCatalog as JaxDatasetCatalog
from cddmsl_tpu.data import MetadataCatalog as JaxMetadataCatalog
from cddmsl_tpu.data import build_detection_test_loader as jax_test_loader
from cddmsl_tpu.data import build_detection_train_loader as jax_train_loader
from cddmsl_tpu.data import register_all as jax_register_all
from cddmsl_tpu.data.datasets.synthetic import make_synthetic_voc as jax_make_synthetic_voc
from cddmsl_tpu.data.datasets.voc import register_pascal_DG as jax_register_pascal_DG
from cddmsl_tpu.data.datasets.voc import register_pascal_voc as jax_register_pascal_voc
from cddmsl_tpu.engine.train_loop import make_eval_step
from cddmsl_tpu.evaluation import PascalVOCDetectionEvaluator as JaxVOCEvaluator
from cddmsl_tpu.evaluation import inference_on_dataset as jax_inference_on_dataset
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from cddmsl_tpu.checkpoint.convert_torch import load_clipcap_mapper as jax_load_clipcap_mapper
from cddmsl_tpu.checkpoint.convert_torch import load_offline_backbone as jax_load_offline_backbone
from cddmsl_tpu.checkpoint.convert_torch import load_text_emb_classifier as jax_load_text_emb_classifier
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.checkpoint.convert_torch import load_clipcap_mapper, load_offline_backbone, load_text_emb_classifier
from cddmsl_torch.config import (
    SolverConfig, add_ateacher_config, check_supported, flagship_config, flagship_solver_config, get_cfg,
    model_config_from_cfg, solver_config_from_cfg,
)
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader, build_detection_train_loader
from cddmsl_torch.data import register_all
from cddmsl_torch.data.dataset_mapper import DatasetMapper
from cddmsl_torch.data.datasets.synthetic import make_synthetic_voc
from cddmsl_torch.data.datasets.voc import ARTISTIC_6_CLASSES, register_pascal_DG, register_pascal_voc
from cddmsl_torch.engine.defaults import build_evaluator
from cddmsl_torch.evaluation import PascalVOCDetectionEvaluator, inference_on_dataset
from cddmsl_torch.models.build import build_model
from cddmsl_torch.ops.resize import resize_bilinear_grid
from cddmsl_torch.solver.build import Optimizer, build_lr_schedule
from test_torch_port_backbone import fill_params, jax_param_shapes

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
VOC_RECIPE = REPO / "configs" / "VOC-Experiments" / "faster_rcnn_CLIP_R_50_C4.yaml"
TINY_RECIPE = REPO / "cddmsl_torch" / "configs" / "voc_tiny.yaml"
CITY_RECIPES = [REPO / "configs" / "AdverseWeather-Experiments" / f"faster_rcnn_CLIP_R_50_{name}.yaml"
                for name in ("C4", "baseline")] + [REPO / "cddmsl_torch" / "configs" / "city_tiny.yaml"]


def _flat(node, prefix=""):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", list(v) if isinstance(v, tuple) else v


def _both_cfgs(path):
    ours, ref = get_cfg(), jax_get_cfg()
    ours.merge_from_file(str(path))
    ref.merge_from_file(str(path))
    return ours, ref


def _assert_port_keys_equal(ours, ref):
    """Every key of the port's tree holds the JAX tree's value."""
    ref_flat = dict(_flat(ref))
    for key, value in _flat(ours):
        want = ref_flat[key]
        if isinstance(value, list) and value and isinstance(value[0], (list, tuple)):
            value, want = [list(v) for v in value], [list(v) for v in want]
        assert value == want, key


# ---------------- config ----------------
@pytest.mark.parametrize("path", [VOC_RECIPE, TINY_RECIPE, *CITY_RECIPES],
                         ids=["voc_recipe", "voc_tiny", "city_recipe", "city_baseline", "city_tiny"])
def test_recipe_loads_to_the_jax_cfg(path):
    ours, ref = _both_cfgs(path)
    _assert_port_keys_equal(ours, ref)
    model, jax_model = model_config_from_cfg(ours), jax_build_model(ref)
    assert model.backbone_layers == tuple(jax_model.backbone_layers)
    assert (model.rpn_pre_nms_topk_train, model.rpn_pre_nms_topk_test) == tuple(jax_model.rpn_pre_nms_topk)
    assert (model.rpn_post_nms_topk_train, model.rpn_post_nms_topk_test) == tuple(jax_model.rpn_post_nms_topk)
    assert model.compute_dtype == jnp.dtype(jax_model.dtype).name
    for field in (
        "backbone_width", "embed_dim", "input_resolution", "anchor_sizes", "anchor_aspect_ratios", "rpn_nms_thresh",
        "rpn_batch_size_per_image", "rpn_positive_fraction", "rpn_loss_weight", "num_classes",
        "roi_batch_size_per_image", "roi_positive_fraction", "pooler_resolution", "use_text_emb", "temperature",
        "focal_gamma", "bg_loss_weight", "score_thresh_test", "nms_thresh_test", "detections_per_image",
        "pixel_mean", "pixel_std", "region_consistency_boxes", "v2l_image_size", "v2l_mapper_layers",
        "v2l_mapper_tokens",
    ):
        assert getattr(model, field) == pytest.approx(getattr(jax_model, field)), field
    solver = solver_config_from_cfg(ours)
    assert (solver.clip_enabled, solver.clip_type, solver.clip_value) == (True, "norm", 5.0)
    schedule, want = build_lr_schedule(solver), jax_build_lr_schedule(ref)
    for step in (0, 1, 50, 99, 100, 9999, 10000, 18000, 39000, 89999):
        assert schedule(step) == float(want(step)), step


@pytest.mark.parametrize("tiny", [False, True])
def test_flagship_cfg_maps_to_the_flagship_configs(tiny):
    """The mapping reads the JAX package's tree as well as the port's."""
    cfg = _flagship_cfg(tiny)
    assert model_config_from_cfg(cfg) == flagship_config(tiny)
    assert solver_config_from_cfg(cfg) == flagship_solver_config(tiny)


def _text_emb_cfg():
    cfg = get_cfg()
    cfg.MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER = True
    check_supported(cfg)
    return cfg


@pytest.mark.parametrize("key, value", [
    ("MODEL.MASK_ON", True), ("MODEL.KEYPOINT_ON", True), ("MODEL.LOAD_PROPOSALS", True),
    ("MODEL.ROI_HEADS.SOFT_NMS_ENABLED", True), ("MODEL.CONSISTENCY_BRANCH", "image_text"), ("TPU.FSDP", True),
    ("TPU.MOE.NUM_EXPERTS", 4), ("TEST.PRECISE_BN.ENABLED", True), ("TPU.QUANT_EVAL", True),
    ("TPU.PAD_BUCKETS", [[800, 1088], [800, 1344]]),
])
def test_unsupported_values_raise_naming_their_key(key, value):
    cfg = _text_emb_cfg()
    cfg.merge_from_list([key, repr(value)])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        check_supported(cfg)


def test_keys_the_port_does_not_read_raise():
    cfg = _text_emb_cfg()
    with pytest.raises(NotImplementedError, match="TPU.PALLAS_ROI_ALIGN"):
        cfg.merge_from_list(["TPU.PALLAS_ROI_ALIGN", "True"])
    add_ateacher_config(cfg)
    cfg.SEMISUPNET.Trainer = "baseline"  # "ateacher" is ported (tests/test_torch_port_mean_teacher.py)
    with pytest.raises(NotImplementedError, match="SEMISUPNET.Trainer"):
        check_supported(cfg)
    register_all()
    MetadataCatalog.get("port_test_lvis_like").set(evaluator_type="lvis", thing_classes=["a"])
    try:
        with pytest.raises(NotImplementedError, match="lvis"):
            build_evaluator(cfg, "port_test_lvis_like")
    finally:
        MetadataCatalog.remove("port_test_lvis_like")


# ---------------- fixture and loaders ----------------
def test_fixture_files_equal(tmp_path):
    jax_make_synthetic_voc(str(tmp_path / "jax"), n=4, seed=2)
    make_synthetic_voc(str(tmp_path / "port"), n=4, seed=2)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 4 * 3 + 2
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f


NAMES = ("port_test_voc_dg", "port_test_voc_test")


@pytest.fixture(scope="module")
def fixture_data(tmp_path_factory):
    voc = make_synthetic_voc(str(tmp_path_factory.mktemp("voc")), n=6)
    for dg, plain in ((jax_register_pascal_DG, jax_register_pascal_voc), (register_pascal_DG, register_pascal_voc)):
        dg(NAMES[0], voc, "trainval", 2007, "dt_clipart")
        plain(NAMES[1], voc, "test", 2007)
    yield voc
    for name in NAMES:
        JaxDatasetCatalog.remove(name)
        JaxMetadataCatalog._registry.pop(name, None)
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)


def _tiny_cfgs(**overrides):
    ours, ref = _both_cfgs(TINY_RECIPE)
    for cfg in (ours, ref):
        cfg.DATASETS.TRAIN, cfg.DATASETS.TEST = (NAMES[0],), (NAMES[1],)
        cfg.INPUT.MIN_SIZE_TRAIN = (64, 80, 96)
        for k, v in overrides.items():
            node = cfg
            *path, last = k.split(".")
            for p in path:
                node = node[p]
            node[last] = v
    return ours, ref


def _assert_batches_equal(got, want):
    for name in ("image", "image_sizes", "orig_sizes", "gt_boxes", "gt_classes", "gt_valid", "image_trgt"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_train_batches_equal_jax(fixture_data):
    ours, ref = _tiny_cfgs()
    want = jax_train_loader(ref, seed=3)
    with build_detection_train_loader(ours, seed=3) as got:
        for _ in range(3):
            g, w = next(got), next(want)
            assert g.image.shape == (2, 96, 160, 3)
            _assert_batches_equal(g, w)
    assert not got.thread.is_alive()


def test_test_batches_and_metas_equal_jax(fixture_data):
    ours, ref = _tiny_cfgs()
    want, n_want = jax_test_loader(ref, NAMES[1])
    got, n = build_detection_test_loader(ours, NAMES[1])
    with got:
        pairs = list(zip(got, want, strict=True))
    assert n == n_want == 6 and len(pairs) == 2
    for (g, g_meta), (w, w_meta) in pairs:
        _assert_batches_equal(g, w)
        assert g_meta == w_meta
    assert [len(m) for (_, m), _ in pairs] == [4, 2]  # the last batch repeats its last image


def test_the_paired_view_shares_the_source_transforms(fixture_data, tmp_path):
    """With the twin a copy of the source file, every flip and resize the
    mapper draws leaves the two views equal; boxes follow the flip."""
    ours, _ = _tiny_cfgs()
    d = dict(DatasetCatalog.get(NAMES[0])[0])
    d["data_dt_file_name"] = d["file_name"]
    mapper = DatasetMapper(ours, is_train=True)
    rng = np.random.RandomState(0)
    flips = set()
    for _ in range(8):
        state = rng.get_state()
        s = mapper(d, rng)
        np.testing.assert_array_equal(s["image_trgt"], s["image"])
        rng2 = np.random.RandomState()
        rng2.set_state(state)
        rng2.randint(3)  # the short side's choice
        flipped = rng2.rand() < 0.5
        flips.add(flipped)
        w = s["image"].shape[1]
        raw = np.array(d["annotations"][0]["bbox"], np.float32) * (w / 140.0)
        x1 = w - raw[2] if flipped else raw[0]
        assert abs(s["boxes"][0, 0] - x1) < 1e-3
    assert flips == {True, False}


# ---------------- evaluation ----------------
def _seeded_detections(seed, classes):
    r = np.random.RandomState(seed)
    images = []
    for i in range(5):
        g = r.randint(1, 5)
        xy = r.rand(g, 2) * 60
        gt = np.concatenate([xy, xy + 20 + r.rand(g, 2) * 40], 1).astype(np.float32)
        gt_cls = r.choice(classes, g)
        difficult = r.rand(g) < 0.2
        n = r.randint(0, 12)
        pick = r.randint(0, g, n)
        boxes = (gt[pick] + r.randn(n, 4).astype(np.float32) * 6).astype(np.float32)
        images.append((f"{i:06d}", gt, gt_cls, difficult, boxes, r.rand(n).astype(np.float32),
                       np.where(r.rand(n) < 0.7, gt_cls[pick], r.choice(classes, n))))
    return images


@pytest.mark.parametrize("dataset, target", [
    ("voc_2007_test", None), ("voc_2007_test", ARTISTIC_6_CLASSES), ("voc_2012_val", None),
])
def test_voc_evaluator_equals_jax(dataset, target):
    jax_register_all()
    register_all()
    ours, ref = PascalVOCDetectionEvaluator(dataset, target), JaxVOCEvaluator(dataset, target)
    for image_id, gt, gt_cls, difficult, boxes, scores, classes in _seeded_detections(7, [0, 1, 2, 6, 7, 11, 14]):
        for ev in (ours, ref):
            ev.process(image_id, boxes, scores, classes)
            ev.process_gt(image_id, gt, gt_cls, difficult)
    got, want = ours.evaluate(), ref.evaluate()
    assert got == want
    assert 0 < got["bbox"]["AP50"] < 100
    assert len(got["bbox"]) == 3 + (6 if target else 20)


@pytest.fixture(scope="module")
def tiny_jax_params():
    ours, ref = _both_cfgs(TINY_RECIPE)
    return jax_build_model(ref), fill_params(jax_param_shapes(model_config_from_cfg(ours)), seed=9)


def test_inference_on_dataset_equals_jax(fixture_data, tiny_jax_params):
    ours_cfg, ref_cfg = _tiny_cfgs(**{"MODEL.ROI_HEADS.SCORE_THRESH_TEST": 0.0})
    _, params = tiny_jax_params
    jax_model = jax_build_model(ref_cfg)
    want_ev = JaxVOCEvaluator(NAMES[1])
    loader, n = jax_test_loader(ref_cfg, NAMES[1])
    want = jax_inference_on_dataset(make_eval_step(jax_model), params, loader, n, want_ev)

    model = build_model(model_config_from_cfg(ours_cfg), device="cpu")
    state = convert_jax_params(params)
    model.load_state_dict({k: v for k, v in state.items() if k in model.state_dict()}, strict=True)
    got_ev = PascalVOCDetectionEvaluator(NAMES[1])
    loader, n = build_detection_test_loader(ours_cfg, NAMES[1])
    with loader:
        got = inference_on_dataset(model, loader, n, got_ev, "cpu")
    assert got == want and got["bbox"]["AP50"] > 0
    # the same detections reached the evaluator
    for c in range(20):
        g = sorted((d["image_id"], -d["score"]) for d in got_ev._dets_by_class.get(c, []))
        w = sorted((d["image_id"], -d["score"]) for d in want_ev._dets_by_class.get(c, []))
        assert [i for i, _ in g] == [i for i, _ in w], c
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=1e-5, err_msg=str(c))
    assert sum(len(v) for v in got_ev._dets_by_class.values()) > 0


# ---------------- solver ----------------
@pytest.mark.parametrize("clip_type, clip_value", [("value", 0.5), ("norm", 3.0), ("norm", 1e4)])
def test_clipping_steps_like_optax(clip_type, clip_value):
    """Two steps of the port's optimizer against the JAX chain: the clip
    (by value, by a global norm that bites, by one that does not), coupled
    decay, momentum, the LR at the optimizer's count."""
    r = np.random.RandomState(5)
    cfg = SolverConfig(base_lr=0.01, warmup_iters=0, clip_enabled=True, clip_type=clip_type, clip_value=clip_value)
    p0 = {"a": r.randn(6, 5).astype(np.float32), "b": r.randn(7).astype(np.float32)}
    grads = [{k: (r.randn(*v.shape) * 2).astype(np.float32) for k, v in p0.items()} for _ in range(2)]
    clip = optax.clip(clip_value) if clip_type == "value" else optax.clip_by_global_norm(clip_value)
    chain = optax.chain(clip, optax.add_decayed_weights(cfg.weight_decay), optax.trace(decay=cfg.momentum),
                        optax.scale_by_learning_rate(lambda s: cfg.base_lr))
    want = {k: jnp.asarray(v) for k, v in p0.items()}
    state = chain.init(want)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = Optimizer(list(params.values()), cfg)
    for g in grads:
        updates, state = chain.update({k: jnp.asarray(v) for k, v in g.items()}, state, want)
        want = optax.apply_updates(want, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name, method", [("WarmupCosineLR", "linear"), ("WarmupMultiStepLR", "constant"),
                                          ("WarmupCosineLR", "constant")])
def test_schedules_equal_build_lr_schedule(name, method):
    ref = jax_get_cfg()
    ref.SOLVER.LR_SCHEDULER_NAME, ref.SOLVER.WARMUP_METHOD = name, method
    ref.SOLVER.MAX_ITER, ref.SOLVER.WARMUP_ITERS, ref.SOLVER.STEPS = 5000, 200, (3000, 4000)
    ours = get_cfg()
    ours.merge_from_list(["SOLVER.LR_SCHEDULER_NAME", name, "SOLVER.WARMUP_METHOD", method, "SOLVER.MAX_ITER", "5000",
                          "SOLVER.WARMUP_ITERS", "200", "SOLVER.STEPS", "(3000, 4000)"])
    schedule, want = build_lr_schedule(solver_config_from_cfg(ours)), jax_build_lr_schedule(ref)
    for step in (0, 1, 100, 199, 200, 1234, 2999, 3000, 4000, 4999):
        # the cosine may differ by an ulp (6e-8), which 1 + cos near -1 magnifies
        np.testing.assert_allclose(schedule(step), float(want(step)), rtol=3e-7, atol=6e-8 * 0.002, err_msg=str(step))


# ---------------- side-loads ----------------
def _write(path, obj):
    torch.save(obj, path)
    return str(path)


def _port_model(params):
    ours, _ = _both_cfgs(TINY_RECIPE)
    model = build_model(model_config_from_cfg(ours), device="cpu", training=True)
    model.load_state_dict(convert_jax_params(params), strict=True)
    return model


@pytest.mark.parametrize("prefix", ["backbone.", "visual."])
def test_offline_backbone_side_load_equals_jax(tiny_jax_params, tmp_path, prefix):
    _, params = tiny_jax_params
    model = _port_model(params)
    g = torch.Generator().manual_seed(3)
    sd = {prefix + k: torch.randn(v.shape, generator=g) for k, v in model.offline_backbone.state_dict().items()}
    sd[prefix + "bn1.num_batches_tracked"] = torch.tensor(7)
    sd["proposal_generator.rpn_head.conv.weight"] = torch.randn(3, generator=g)  # another tower: left out
    path = _write(tmp_path / "rclip.pth", {"model": sd})
    load_offline_backbone(model, path)
    want = convert_jax_params(jax_load_offline_backbone(params, path))
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert torch.equal(got["offline_backbone.conv1.weight"], sd[prefix + "conv1.weight"])


def test_clipcap_and_text_embedding_side_loads_equal_jax(tiny_jax_params, tmp_path):
    _, params = tiny_jax_params
    model = _port_model(params)
    g = torch.Generator().manual_seed(4)
    sd = {"clip_project." + k: torch.randn(v.shape, generator=g) for k, v in model.v2l_mapper.state_dict().items()}
    sd["gpt.wte.weight"] = torch.randn(5, 3, generator=g)
    mapper = _write(tmp_path / "clipcap.pth", sd)
    emb = _write(tmp_path / "emb.pth", torch.randn(20, 128, generator=g))
    load_clipcap_mapper(model, mapper)
    load_text_emb_classifier(model, emb)
    want = convert_jax_params(jax_load_text_emb_classifier(jax_load_clipcap_mapper(params, mapper), emb))
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert torch.equal(got["v2l_mapper.prefix_const"], sd["clip_project.prefix_const"])
    with pytest.raises(FileNotFoundError):
        load_clipcap_mapper(model, str(tmp_path / "missing.pth"))
    with pytest.raises(ValueError, match="classifier"):
        load_text_emb_classifier(model, _write(tmp_path / "bad.pth", torch.zeros(19, 128)))


@pytest.mark.parametrize("grid, size", [((7, 7), (5, 6)), ((7, 7), (10, 12)), ((7, 7), (3, 14)), ((5, 9), (5, 4))])
def test_positional_embedding_resize_equals_jax_image_resize(grid, size):
    x = np.random.RandomState(1).randn(*grid, 16).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (*size, 16), method="bilinear")
    got = resize_bilinear_grid(torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
