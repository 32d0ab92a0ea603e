"""The port's region-language pretraining against cddmsl_tpu on the CPU, at
the width of tests/test_pretrain.py's `_tiny_cfg`, in float32: the TSV
corpus and its batches bit for bit, the three losses to rtol 1e-5, one step
(parameters within 1e-6, momentum within 1e-6 of each buffer's scale, the
frozen towers, the stem and layer1 bit-equal), `pretrain_loop`'s metrics to 1e-5, the frozen set equal
to JAX's optimizer mask, the CLI and its refusals, and
`extract_region_features` against the JAX tool."""

import base64
import io
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from cddmsl_tpu.data.clip_datasets import CLIPImgTxtPairTSVDataset as JaxDataset
from cddmsl_tpu.engine.pretrain import grid_region_boxes as jax_grid_region_boxes
from cddmsl_tpu.engine.pretrain import make_pretrain_step as jax_make_pretrain_step
from cddmsl_tpu.engine.pretrain import pretrain_loop as jax_pretrain_loop
from cddmsl_tpu.engine.train_loop import TrainState
from cddmsl_tpu.models.build import build_pretrain_fast_rcnn as jax_build_pretrain_fast_rcnn
from cddmsl_tpu.models.clip_rcnn import mil_cross_entropy as jax_mil_cross_entropy
from cddmsl_tpu.models.clip_rcnn import soft_target_cross_entropy as jax_soft_target_cross_entropy
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_tpu.solver.build import trainable_mask
from cddmsl_tpu.structures.tsv_file import TSVFile as JaxTSVFile
from cddmsl_tpu.structures.tsv_file import generate_lineidx as jax_generate_lineidx
from cddmsl_torch import pretrain_net
from cddmsl_torch.checkpoint.checkpointer import DetectionCheckpointer
from cddmsl_torch.checkpoint.convert_jax import convert_jax_pretrain_params, init_random_
from cddmsl_torch.checkpoint.convert_torch import load_rcnn_weights
from cddmsl_torch.config import check_supported, get_cfg, solver_config_from_cfg
from cddmsl_torch.data.clip_datasets import CLIPImgTxtPairTSVDataset
from cddmsl_torch.engine.pretrain import PretrainState, grid_region_boxes, make_pretrain_step, pretrain_loop
from cddmsl_torch.models.build import build_pretrain_fast_rcnn
from cddmsl_torch.models.clip_rcnn import mil_cross_entropy, soft_target_cross_entropy
from cddmsl_torch.solver.build import build_optimizer, parameter_is_frozen
from cddmsl_torch.structures.tsv_file import TSVFile, generate_lineidx
from test_pretrain import _tiny_cfg
from test_torch_port_backbone import fill_params

torch.set_num_threads(1)

RTOL = 1e-5
SIZE, GRID, BATCH, CONTEXT, VOCAB = 64, 2, 4, 8, 101
MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
CAPTIONS = ["a photo number 0", json.dumps({"captions": ["a dog on grass", "second"]}), json.dumps(["a red car", "x"]),
            json.dumps({"other": 1}), json.dumps([]), "42", "two cats; one box", json.dumps({"captions": []})]


def _port_cfg():
    """The port's tree with `_tiny_cfg`'s values; pretraining pools grid regions."""
    cfg = get_cfg()
    cfg.MODEL.META_ARCHITECTURE = "PretrainFastRCNN"
    cfg.MODEL.CLIP.CROP_REGION_TYPE = "GRID"
    jax_cfg = _tiny_cfg()
    for node, keys in ((("TPU",), ("BACKBONE_LAYERS", "BACKBONE_WIDTH", "EMBED_DIM", "COMPUTE_DTYPE")),
                       (("MODEL", "CLIP"), ("PRETRAIN_NUM_CONCEPTS", "TEXT_VOCAB_SIZE", "TEXT_CONTEXT_LENGTH",
                                            "TEXT_WIDTH", "TEXT_HEADS", "TEXT_LAYERS")),
                       (("SOLVER",), ("BASE_LR", "WARMUP_ITERS"))):
        ours, theirs = cfg, jax_cfg
        for n in node:
            ours, theirs = ours[n], theirs[n]
        for k in keys:
            ours[k] = theirs[k]
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = False
    return cfg


def _tokenize(captions):
    """A fixed map of words into the tests' vocabulary: SOT 99, up to 6
    words, EOT 100."""
    out = np.zeros((len(captions), CONTEXT), np.int32)
    for i, c in enumerate(captions):
        ids = [1 + zlib.crc32(w.encode()) % 98 for w in c.split()][: CONTEXT - 2]
        out[i, : len(ids) + 2] = [VOCAB - 2] + ids + [VOCAB - 1]
    return out


def _write_tsv(root, captions, seed, name):
    rng = np.random.RandomState(seed)
    img_tsv, txt_tsv = os.path.join(root, f"{name}_imgs.tsv"), os.path.join(root, f"{name}_texts.tsv")
    with open(img_tsv, "w") as fi, open(txt_tsv, "w") as ft:
        for i, cap in enumerate(captions):
            arr = (rng.rand(40 + 2 * i, 48, 3) * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG")
            fi.write(f"img{i}\t{base64.b64encode(buf.getvalue()).decode()}\n")
            ft.write(f"img{i}\t{cap}\n")
    return img_tsv, txt_tsv


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two shards: 8 pairs (plain, JSON-dict and JSON-list captions) and 4."""
    root = str(tmp_path_factory.mktemp("corpus"))
    a = _write_tsv(root, CAPTIONS, 0, "a")
    b = _write_tsv(root, ["a cat", "a bird", "a tree", "a boat"], 1, "b")
    return [a[0], b[0]], [a[1], b[1]]


def test_tsv_file_equals_jax(corpus, tmp_path):
    path = corpus[0][0]
    generate_lineidx(path, str(tmp_path / "ours.lineidx"))
    jax_generate_lineidx(path, str(tmp_path / "jax.lineidx"))
    assert (tmp_path / "ours.lineidx").read_bytes() == (tmp_path / "jax.lineidx").read_bytes()
    ours, theirs = TSVFile(path), JaxTSVFile(path)
    assert len(ours) == len(theirs) == 8
    assert [ours[i] for i in (7, 0, 3)] == [theirs[i] for i in (7, 0, 3)]
    ours.close()
    theirs.close()


def test_clip_dataset_equals_jax(corpus):
    ours, theirs = CLIPImgTxtPairTSVDataset(*corpus), JaxDataset(*corpus)
    assert len(ours) == len(theirs) == 12
    for i in range(12):
        (a, ca), (b, cb) = ours[i], theirs[i]
        assert a.dtype == np.uint8 and np.array_equal(a, b) and ca == cb, i
    assert [ours[i][1] for i in range(8)] == ["a photo number 0", "a dog on grass", "a red car", '{"other": 1}', "",
                                              "42", "two cats; one box", ""]
    got = list(ours.batches(5, image_size=32, seed=3, epochs=2))
    want = list(theirs.batches(5, image_size=32, seed=3, epochs=2))
    assert len(got) == len(want) == 4  # the last partial batch of each epoch is dropped
    for (gi, gc), (wi, wc) in zip(got, want):
        assert gi.shape == (5, 32, 32, 3) and np.array_equal(gi, wi) and gc == wc


def test_grid_region_boxes_equal_jax():
    for size, grid in ((224, 3), (64, 2), (100, 4)):
        np.testing.assert_array_equal(grid_region_boxes(size, grid), jax_grid_region_boxes(size, grid))
    assert grid_region_boxes(224, 3).shape == (19, 4)


def test_loss_functions_equal_jax():
    r = np.random.RandomState(0)
    logits = r.randn(7, 5).astype(np.float32) * 3
    soft = np.abs(r.randn(7, 5)).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    bag = (r.rand(7, 5) > 0.6).astype(np.float32)
    bag[0] = 0  # an empty bag: the clip at 1e-6
    for ours, theirs, t in ((soft_target_cross_entropy, jax_soft_target_cross_entropy, soft),
                            (mil_cross_entropy, jax_mil_cross_entropy, bag)):
        got = ours(torch.from_numpy(logits), torch.from_numpy(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs(jnp.asarray(logits), jnp.asarray(t))), rtol=RTOL)


# ---------------- the model and its step ----------------
def _inputs(seed=0):
    r = np.random.RandomState(seed)
    images = ((r.rand(BATCH, SIZE, SIZE, 3) * 255).astype(np.uint8).astype(np.float32) / 255.0 - MEAN) / STD
    boxes = np.broadcast_to(grid_region_boxes(SIZE, GRID), (BATCH, 9, 4))
    return images, np.ascontiguousarray(boxes), _tokenize(["a dog", "two red cars here", "a", "the cat sat on it"])


@pytest.fixture(scope="module")
def models():
    """The JAX model, its parameters (filled with numpy) and the port's
    model holding them; the logit scale starts at log(1 / 0.07)."""
    jax_cfg = _tiny_cfg()
    jax_model = jax_build_pretrain_fast_rcnn(jax_cfg)
    images, boxes, tokens = _inputs()
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), images[:1], boxes[:1], tokens[:1],
                                                   method=jax_model.pretrain_losses_with_text))
    scale = shapes["params"].pop("logit_scale")
    params = fill_params(shapes, seed=7)
    params["params"]["logit_scale"] = np.full(scale.shape, np.log(1 / 0.07), np.float32)
    return jax_cfg, jax_model, params


def _port_model(params):
    model = build_pretrain_fast_rcnn(_port_cfg(), device="cpu")
    model.load_state_dict(convert_jax_pretrain_params(params), strict=True)
    return model


def test_pretrain_losses_match_jax(models):
    _, jax_model, params = models
    images, boxes, tokens = _inputs(seed=1)
    want = jax.jit(lambda p, *a: jax_model.apply(p, *a, method=jax_model.pretrain_losses_with_text))(
        params, images, boxes, tokens)
    with torch.no_grad():
        got = _port_model(params).pretrain_losses_with_text(*map(torch.from_numpy, (images, boxes, tokens)))
    assert list(got) == ["img_txt_loss", "region_txt_mil_loss", "concept_distill_loss"] and set(want) == set(got)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, err_msg=k)


def _momentum(opt_state):
    traces = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
              if isinstance(s, optax.TraceState)]
    assert len(traces) == 1
    return traces[0].trace


def _frozen_names(model):
    return [n for n, _ in model.named_parameters()
            if n.startswith(("teacher_backbone.", "lang_encoder.", "backbone.conv", "backbone.layer1.", "concept_emb"))]


def test_pretrain_step_matches_jax(models):
    """One step: the losses, then every parameter within 1e-6 of JAX's and
    every momentum buffer within 1e-6 of its largest value (at least 1);
    the teacher, the text tower, the concept pool, the
    stem and layer1 bit-equal; the logit scale moves (it is trained and
    decays)."""
    jax_cfg, jax_model, params = models
    optimizer = jax_build_optimizer(jax_cfg, params)
    new_state, want = jax_make_pretrain_step(jax_model, optimizer)(
        TrainState.create(params, optimizer), *_inputs())
    model = _port_model(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = PretrainState(model, build_optimizer(model, solver_config_from_cfg(_port_cfg())))
    got = make_pretrain_step(state)(*map(torch.from_numpy, _inputs()))
    assert state.iteration == 1 and set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, err_msg=k)

    after = model.state_dict()
    for k, v in convert_jax_pretrain_params(jax.device_get(new_state.params)).items():
        np.testing.assert_allclose(after[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)
    want_momentum = convert_jax_pretrain_params(jax.device_get(_momentum(new_state.opt_state)))
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    sgd = state.optimizer.sgd.state_dict()["state"]
    assert len(sgd) == len(trainable)
    for i, name in enumerate(trainable):
        want_m = want_momentum[name].numpy()  # the gradient: up to ~10 through the distillation's 1/0.01
        np.testing.assert_allclose(sgd[i]["momentum_buffer"].numpy(), want_m, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(want_m).max()), err_msg=name)
    frozen = _frozen_names(model)
    assert len(frozen) > 40 and not set(frozen) & set(trainable)
    for name in frozen:
        assert torch.equal(after[name], before[name]), name
    assert "logit_scale" in trainable and not torch.equal(after["logit_scale"], before["logit_scale"])
    assert any(not torch.equal(after[n], before[n]) for n in trainable if n.startswith("backbone.layer3"))


def test_frozen_parameters_are_jax_mask(models):
    jax_cfg, _, params = models
    mask = trainable_mask(params, freeze_at=jax_cfg.MODEL.BACKBONE.FREEZE_AT)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    trainable = convert_jax_pretrain_params(as_arrays)
    model = _port_model(params)
    names = [n for n, _ in model.named_parameters()]
    assert all(parameter_is_frozen(n) == (trainable[n] == 0).all() for n in names)
    assert sum(not parameter_is_frozen(n) for n in names) > 20


def test_pretrain_loop_matches_jax(models, corpus):
    """Two logged steps over the corpus's first shard (batch 4 of 8 pairs,
    64x64, grid 2) with the same tokens: JAX's metrics to 1e-5."""
    jax_cfg, jax_model, params = models
    shard = ([corpus[0][0]], [corpus[1][0]])
    optimizer = jax_build_optimizer(jax_cfg, params)
    _, want = jax_pretrain_loop(jax_model, TrainState.create(params, optimizer), optimizer,
                                JaxDataset(*shard).batches(BATCH, image_size=SIZE, seed=0), _tokenize, max_iter=2,
                                image_size=SIZE, grid=GRID, log_period=1)
    model = _port_model(params)
    state = PretrainState(model, build_optimizer(model, solver_config_from_cfg(_port_cfg())))
    waits = []
    got = pretrain_loop(state, CLIPImgTxtPairTSVDataset(*shard).batches(BATCH, image_size=SIZE, seed=0), _tokenize,
                        max_iter=2, image_size=SIZE, grid=GRID, log_period=1,
                        on_step=lambda it, m, s: waits.append((it, s)))
    assert state.iteration == 2 and [it for it, _ in waits] == [0, 1] and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


# ---------------- the CLI ----------------
def _cli(corpus, out, *opts):
    return ["--config-file", "cddmsl_torch/configs/pretrain_tiny.yaml", "--image-tsv", corpus[0][0], "--text-tsv",
            corpus[1][0], "--device", "cpu", "OUTPUT_DIR", str(out), *opts]


def test_pretrain_net_writes_pretrain_final(corpus, tmp_path):
    state, metrics = pretrain_net.main(_cli(corpus, tmp_path))
    assert state.iteration == 2 and np.isfinite(metrics["total_loss"])
    path = tmp_path / "pretrain_final.pth"
    saved = DetectionCheckpointer.read(str(path))
    assert saved is not None and saved["iteration"] == 2
    cfg = get_cfg()
    cfg.merge_from_file("cddmsl_torch/configs/pretrain_tiny.yaml")
    fresh = pretrain_net.build_state(cfg, torch.device("cpu"))
    DetectionCheckpointer(str(tmp_path)).load(str(path), fresh)
    want = state.state_dict()
    assert all(torch.equal(v, want["model"][k]) for k, v in fresh.model.state_dict().items())
    assert fresh.optimizer.count == 2


@pytest.mark.parametrize("opts, key", [
    (("MODEL.WEIGHTS", "w.pth"), "MODEL.WEIGHTS"),
    (("MODEL.CLIP.CONCEPT_POOL_EMB", "c.pth"), "MODEL.CLIP.CONCEPT_POOL_EMB"),
    (("TPU.PIPELINE_AXIS", "pipe"), "TPU.PIPELINE_AXIS"),
    (("MODEL.CLIP.CROP_REGION_TYPE", "RPN"), "MODEL.CLIP.CROP_REGION_TYPE"),
])
def test_pretrain_net_refuses_what_jax_ignores(corpus, tmp_path, opts, key):
    with pytest.raises(NotImplementedError, match=key):
        pretrain_net.main(_cli(corpus, tmp_path, *opts))


def test_pretrain_net_needs_a_card_by_default(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CUDA-less refusal")
    argv = _cli(corpus, tmp_path)
    argv.remove("--device")
    argv.remove("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain_net.main(argv)


def test_train_net_refuses_the_pretraining_model():
    cfg = _port_cfg()
    with pytest.raises(NotImplementedError, match="MODEL.META_ARCHITECTURE"):
        check_supported(cfg, world=1)


def test_lang_checkpoint_loads_into_the_text_tower(tmp_path):
    """A 'lang' file (lang_encoder.* keys) into the pretraining model's
    text tower; the detector has none and refuses it."""
    src = build_pretrain_fast_rcnn(_port_cfg(), device="cpu")
    init_random_(src, torch.Generator().manual_seed(3))
    text = {k: v for k, v in src.state_dict().items() if k.startswith("lang_encoder.")}
    torch.save({"model": text}, tmp_path / "lang.pth")
    dst = build_pretrain_fast_rcnn(_port_cfg(), device="cpu")
    assert load_rcnn_weights(dst, str(tmp_path / "lang.pth")) == "lang"
    assert all(torch.equal(dst.state_dict()[k], v) for k, v in text.items())
    from cddmsl_torch.config import flagship_config
    from cddmsl_torch.models.build import build_model

    with pytest.raises(NotImplementedError, match="text tower"):
        load_rcnn_weights(build_model(flagship_config(tiny=True), device="cpu"), str(tmp_path / "lang.pth"))


# ---------------- extract_region_features ----------------
@pytest.fixture
def voc_builtins(monkeypatch, tmp_path):
    """The synthetic VOC fixture, registered by both packages' `register_all`
    into empty catalogs (restored after the test)."""
    from cddmsl_tpu.data import catalog as jax_catalog
    from cddmsl_tpu.data.datasets import builtin as jax_builtin
    from cddmsl_torch.data import catalog
    from cddmsl_torch.data.datasets import builtin
    from cddmsl_torch.data.datasets.synthetic import make_synthetic_voc

    root = tmp_path / "voc"
    make_synthetic_voc(str(root))
    for module, cat in ((builtin, catalog), (jax_builtin, jax_catalog)):
        monkeypatch.setattr(module, "_REGISTERED", False)
        for registry in (cat.DatasetCatalog, cat.MetadataCatalog):
            monkeypatch.setattr(registry, "_registry", {})
        module.register_all(str(root))
    return root


def test_extract_region_features_matches_the_jax_tool(voc_builtins, tmp_path, monkeypatch):
    """voc_tiny.yaml from a d2_rcnn file of a seeded model (both tools start
    from it; TPU.FAST_INIT keeps the JAX tool's own init cheap): the same
    images, for each the same valid proposals within 1e-3 px and their
    embeddings within rtol 1e-4, atol 1e-5, matched box to box (the RPN's
    ties may order them either way)."""

    from cddmsl_torch import extract_region_features
    from cddmsl_torch.config import add_ateacher_config, model_config_from_cfg
    from cddmsl_torch.models.build import build_model
    from test_torch_port_text import _run_jax_tool

    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file("cddmsl_torch/configs/voc_tiny.yaml")
    src = build_model(model_config_from_cfg(cfg), device="cpu")
    init_random_(src, torch.Generator().manual_seed(9))
    torch.save({"model": {k: v for k, v in src.state_dict().items()
                          if k.startswith(("backbone.", "proposal_generator.", "roi_heads."))}}, tmp_path / "w.pth")
    opts = ["MODEL.WEIGHTS", str(tmp_path / "w.pth"), "TPU.FAST_INIT", "True"]
    common = ["--config-file", "cddmsl_torch/configs/voc_tiny.yaml", "--dataset", "voc_2007_test"]
    _run_jax_tool(monkeypatch, "extract_region_features", common + ["--out", str(tmp_path / "jax")] + opts)
    seen = extract_region_features.main(common + ["--out", str(tmp_path / "ours"), "--device", "cpu"] + opts)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert seen == len(names) == 6 and sorted(os.listdir(tmp_path / "ours")) == names
    for name in names:
        got, want = np.load(tmp_path / "ours" / name), np.load(tmp_path / "jax" / name)
        assert got["boxes"].shape == want["boxes"].shape and got["features"].shape == (len(want["boxes"]), 128)
        unused = list(range(len(got["boxes"])))
        for box, feat in zip(want["boxes"], want["features"]):
            j = min(unused, key=lambda u: np.abs(got["boxes"][u] - box).max())
            unused.remove(j)
            np.testing.assert_allclose(got["boxes"][j], box, rtol=0, atol=1e-3, err_msg=name)
            np.testing.assert_allclose(got["features"][j], feat, rtol=1e-4, atol=1e-5, err_msg=name)
