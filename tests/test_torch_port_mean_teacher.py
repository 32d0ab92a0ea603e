"""The mean-teacher trainer (SEMISUPNET.Trainer = "ateacher") in the port
against cddmsl_tpu on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function and
its counterpart in the port, with the JAX weights carried across
(`convert_jax_mt_state`) and JAX's jax.random draws replayed: the
supervised branch takes those of k1 and the pseudo-labeled branch those of
k2, where k1, k2, k3 = split(step key, 3), as `mt_step` splits them.

- The strong augmentation, `divide_label_unlabel` and the two-crop loader's
  four batches (both streams, both orientations): bit for bit.
- `grad_reverse`, `FCDiscriminator` and the BCE on the same weights, with
  the gradients: rtol 1e-5, atol 1e-5 (each logit is a float32 sum of 2304
  products of order 1, taken in another order).
- `_pseudo_label` on the tiny flagship's teacher: the same valid mask and
  classes, boxes to 1e-3 px (the detections' tolerance of
  tests/test_torch_port_inference.py: float32 decodes of boxes ~100 px). The threshold is
  picked from the teacher's scores so that some boxes pass and no score
  lies within 1e-3 of it: a near tie would flip a box between packages.
- One step at each phase (before burn-up, at it, past it) against JAX's
  `mt_step`: losses rtol 1e-5, the student, the teacher and the
  discriminator to 1e-6, the teacher bit-equal to the student at the
  boundary and unchanged before it. The port feeds the discriminator the
  supervised passes' res4 maps, so these hold to tolerance, not bit for bit.
- `compute_val_loss` against the same JAX function (`supervised_losses`
  with the same key), read from the step before burn-up, whose supervised
  weight is 1.

The module compiles one JAX program, `mt_step` (its step count is traced),
serves the three phases from it and records the pseudo-labels it computes;
one JAX trainer and one port trainer serve every comparison.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from __graft_entry__ import _flagship_cfg, _synthetic_batch
from cddmsl_tpu.config import add_ateacher_config as jax_add_ateacher_config
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu import data as jax_data
from cddmsl_tpu.data import DatasetCatalog as JaxDatasetCatalog
from cddmsl_tpu.data import build as jax_build
from cddmsl_tpu.data.transforms import build_strong_augmentation_fn as jax_strong_aug
from cddmsl_tpu.engine import mean_teacher as jax_mt
from cddmsl_tpu.engine.train_loop import split_batch_stats
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.convert_jax import convert_jax_mt_state
from cddmsl_torch.config import add_ateacher_config, check_supported, get_cfg, model_config_from_cfg
from cddmsl_torch.data import DatasetCatalog
from cddmsl_torch.data.build import build_semisup_train_loader_two_crops, divide_label_unlabel
from cddmsl_torch.data.transforms import build_strong_augmentation_fn
from cddmsl_torch.engine.defaults import DefaultTrainer
from cddmsl_torch.engine.mean_teacher import FCDiscriminator, MeanTeacherTrainer, bce_with_logits, grad_reverse
from test_torch_port_backbone import fill_params, jax_param_shapes
from test_torch_port_data import _assert_batches_equal
from test_torch_port_engine import REPO, TINY_RECIPE, fixture_root  # noqa: F401 (a fixture)
from test_torch_port_train import _replay, _t, _torch_batch

torch.set_num_threads(1)

B, H, W, G = 2, 64, 96, 8
BURN_UP = 5
DIS_TOL = dict(rtol=1e-5, atol=1e-5)
PHASES = {"before_burn_up": BURN_UP - 1, "at_burn_up": BURN_UP, "past_burn_up": BURN_UP + 1}
MT_TINY = REPO / "cddmsl_torch" / "configs" / "mt_tiny.yaml"


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _sup_draws(key, b, n_anchors, n_proposals, n_gt):
    """The uniforms `supervised_losses(key)` draws: split(key) -> (k_rpn,
    k_roi); the RPN splits k_rpn per image, then uniform(k1), uniform(k2) of
    split(key); the RoI heads split k_roi per image, k1, k2 = split(key),
    the two of split(k1), then uniform(k2)."""
    k_rpn, k_roi = jax.random.split(key)
    out = {name: [] for name in ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg", "roi_gather")}
    for k in jax.random.split(k_rpn, b):
        k1, k2 = jax.random.split(k)
        out["rpn_pos"].append(jax.random.uniform(k1, (n_anchors,)))
        out["rpn_neg"].append(jax.random.uniform(k2, (n_anchors,)))
    for k in jax.random.split(k_roi, b):
        k1, k2 = jax.random.split(k)
        ka, kb = jax.random.split(k1)
        for name, kk in (("roi_pos", ka), ("roi_neg", kb), ("roi_gather", k2)):
            out[name].append(jax.random.uniform(kk, (n_proposals + n_gt,)))
    return {k: np.stack([np.asarray(a) for a in v]) for k, v in out.items()}


def _step_draws(step):
    """(supervised, pseudo-labeled) draws of the step at `step`, from its
    key PRNGKey(10 + step)."""
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(10 + step), 3)
    args = (B, (H // 16) * (W // 16) * 15, _flagship_cfg(tiny=True).MODEL.RPN.POST_NMS_TOPK_TRAIN, G)
    return _replay(_sup_draws(k1, *args)), _replay(_sup_draws(k2, *args))


def _pick_threshold(scores, valid, margin=1e-3):
    """The midpoint of the widest gap between the valid scores of the rows
    that become pseudo-labels (the first G of each image): some boxes pass
    and some do not, and every score lies at least `margin` from it."""
    s = np.sort(scores[:, :G][valid[:, :G]])
    gap, thr = max((s[i + 1] - s[i], (s[i] + s[i + 1]) / 2) for i in range(len(s) - 1))
    assert gap > 2 * margin and np.abs(scores[valid] - thr).min() > margin, s
    return float(thr)


# ---------------- the shared trainers and the JAX program ----------------
def _jax_trainer(cfg):
    """JAX's MeanTeacherTrainer, its parts assembled as its __init__
    assembles them (`_make_step` reads them), with the module's weights in
    its MTState: the student (seed 5), the teacher (seed 6) and the
    discriminator (seed 7). It skips the structure-only initialisation and
    the checkpointer that __init__ builds and the fixture would replace."""
    jtr = object.__new__(jax_mt.MeanTeacherTrainer)
    jtr.cfg, jtr.model = cfg, jax_build_model(cfg)
    shapes = jax_param_shapes(model_config_from_cfg(cfg))
    jtr.discriminator = jax_mt.FCDiscriminator(dtype=jnp.float32)
    dis_shapes = jax.eval_shape(jtr.discriminator.init, jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 256), jnp.float32))
    params, teacher, dis = fill_params(shapes, seed=5), fill_params(shapes, seed=6), fill_params(dis_shapes, seed=7)
    jtr.optimizer = jax_build_optimizer(cfg, split_batch_stats(params)[0])
    jtr.dis_optimizer = optax.sgd(jax_build_lr_schedule(cfg), momentum=cfg.SOLVER.MOMENTUM)
    jtr.mt_state = jax_mt.MTState(
        step=np.zeros((), np.int32), params=params, teacher_params=teacher, dis_params=dis,
        opt_state=jax.device_get(jtr.optimizer.init(split_batch_stats(params)[0])),
        dis_opt_state=jax.device_get(jtr.dis_optimizer.init(dis)))
    return jtr


@pytest.fixture(scope="module")
def mt(tmp_path_factory):
    cfg = _flagship_cfg(tiny=True)
    jax_add_ateacher_config(cfg)
    cfg.SEMISUPNET.Trainer = "ateacher"
    cfg.SEMISUPNET.BURN_UP_STEP = BURN_UP
    cfg.TPU.MAX_GT_BOXES = G
    cfg.TPU.MESH_SHAPE = [1]
    cfg.OUTPUT_DIR = str(tmp_path_factory.mktemp("mt"))
    jtr = _jax_trainer(cfg)
    host = jtr.mt_state
    weights = convert_jax_mt_state(host)
    jb = [_synthetic_batch(B, H, W, g=G, seed=s) for s in range(4)]  # label_s, label_w, unlabel_s, unlabel_w
    tb = [_torch_batch(b) for b in jb]

    ours = MeanTeacherTrainer(cfg, device="cpu")  # the port reads the JAX package's tree
    ours.teacher.load_state_dict(weights["teacher"])
    det = ours.teacher.inference(tb[3], do_postprocess=False)
    cfg.SEMISUPNET.BBOX_THRESHOLD = ours.bbox_threshold = _pick_threshold(_np(det.scores), _np(det.valid))

    # JAX's pseudo-labels, as its step computes them, handed out by a host
    # callback (the step runs the teacher at every phase)
    pseudo = []
    label = jtr._pseudo_label

    def recorded(teacher_params, weak_batch):
        out = label(teacher_params, weak_batch)
        jax.debug.callback(lambda *a: pseudo.append(a), *out)
        return out

    jtr._pseudo_label = recorded
    run = jax.jit(jtr._make_step().__wrapped__)
    state = jax.tree_util.tree_map(jnp.asarray, host)
    want = {}
    for phase, step in PHASES.items():
        want[phase] = jax.device_get(run(state.replace(step=jnp.asarray(step, jnp.int32)), *jb,
                                         jax.random.PRNGKey(10 + step)))
    assert len(pseudo) == len(PHASES)
    return dict(cfg=cfg, jax_trainer=jtr, host=host, weights=weights, tb=tb, ours=ours, want=want,
                pseudo=pseudo[0], teacher_scores=(_np(det.scores), _np(det.valid)),
                fresh=(copy.deepcopy(ours.optimizer.state_dict()), copy.deepcopy(ours.dis_optimizer.state_dict())))


def _port_state_at(mt, step):
    """The port trainer reset to the module's weights and fresh optimizer
    states, at iteration `step`."""
    ours, w = mt["ours"], mt["weights"]
    ours.model.load_state_dict(w["model"])
    ours.teacher.load_state_dict(w["teacher"])
    ours.discriminator.load_state_dict(w["discriminator"])
    ours.optimizer.load_state_dict(copy.deepcopy(mt["fresh"][0]))
    ours.dis_optimizer.load_state_dict(copy.deepcopy(mt["fresh"][1]))
    ours.state.iteration = step
    return ours


def _state_close(got, want, what):
    assert got.keys() == want.keys(), what
    for name, value in got.items():
        np.testing.assert_allclose(_np(value), _np(want[name]), rtol=0, atol=1e-6, err_msg=f"{what} {name}")


# ---------------- the loader ----------------
def test_strong_augmentation_equals_jax():
    """Every draw in JAX's order: the same uint8 image and the same state of
    the RandomState after it, over seeds that take each branch."""
    img = (np.random.RandomState(0).rand(40, 56, 3) * 255).astype(np.uint8)
    ours, ref = build_strong_augmentation_fn(), jax_strong_aug()
    for seed in range(12):
        r_ours, r_ref = np.random.RandomState(seed), np.random.RandomState(seed)
        got, want = ours(img, r_ours), ref(img, r_ref)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert r_ours.randint(1 << 30) == r_ref.randint(1 << 30)


@pytest.mark.parametrize("seed_file", [False, True])
def test_divide_label_unlabel_equals_jax(tmp_path, seed_file):
    dicts = [{"image_id": i} for i in range(11)]
    path = str(tmp_path / "seeds.json")
    if seed_file:
        with open(path, "w") as f:
            json.dump({"40.0": {"3": [9, 2, 5, 7, 0]}}, f)
    got = divide_label_unlabel(dicts, 40.0, 3, path)
    want = jax_build.divide_label_unlabel(dicts, 40.0, 3, path)
    assert got == want and len(got[0]) == 4
    if seed_file:
        assert [d["image_id"] for d in got[0]] == [2, 5, 7, 9]  # the first 4 of the file, in dataset order


@pytest.fixture(scope="module")
def two_orientations(tmp_path_factory):
    """Eight images, landscape and portrait, some with a translated twin,
    under one name in both catalogs (and a labeled and an unlabeled part)."""
    root = tmp_path_factory.mktemp("two_crop")
    r = np.random.RandomState(0)
    dicts = []
    for i in range(8):
        h, w = (100, 140) if i % 2 else (140, 100)
        img = (r.rand(h, w, 3) * 200).astype(np.uint8)
        boxes = []
        for _ in range(2):
            x1, y1 = int(r.rand() * w * 0.6), int(r.rand() * h * 0.6)
            x2, y2 = x1 + 10 + int(r.rand() * w * 0.3), y1 + 10 + int(r.rand() * h * 0.3)
            img[y1:y2, x1:x2] = 255
            boxes.append({"bbox": [x1, y1, x2, y2], "category_id": int(r.randint(20)), "difficult": 0})
        d = {"file_name": str(root / f"{i}.png"), "image_id": i, "height": h, "width": w, "annotations": boxes}
        Image.fromarray(img).save(d["file_name"])
        if i % 3 == 0:
            d["data_dt_file_name"] = str(root / f"{i}_dt.png")
            Image.fromarray(255 - img).save(d["data_dt_file_name"])
        dicts.append(d)
    names = {"port_mt_all": dicts, "port_mt_label": dicts[:4], "port_mt_unlabel": dicts[4:]}
    for catalog in (DatasetCatalog, JaxDatasetCatalog):
        for name, ds in names.items():
            catalog.register(name, lambda ds=ds: copy.deepcopy(ds))
    yield
    for catalog in (DatasetCatalog, JaxDatasetCatalog):
        for name in names:
            catalog.remove(name)


@pytest.mark.parametrize("cross_dataset", [False, True])
def test_two_crop_batches_equal_jax(two_orientations, cross_dataset):
    """Four steps of ((label_s, label_w), (unlabel_s, unlabel_w)), bit for
    bit; each stream yields both orientations."""
    ours, ref = get_cfg(), jax_get_cfg()
    add_ateacher_config(ours)
    jax_add_ateacher_config(ref)
    for cfg in (ours, ref):
        cfg.merge_from_file(str(TINY_RECIPE))
        cfg.INPUT.MIN_SIZE_TRAIN = (64, 80, 96)
        cfg.DATASETS.TRAIN = ("port_mt_all",)
        cfg.DATASETS.TRAIN_LABEL, cfg.DATASETS.TRAIN_UNLABEL = ("port_mt_label",), ("port_mt_unlabel",)
        cfg.DATASETS.CROSS_DATASET = cross_dataset
        cfg.DATALOADER.SUP_PERCENT = 50.0
        cfg.SOLVER.IMG_PER_BATCH_LABEL = cfg.SOLVER.IMG_PER_BATCH_UNLABEL = 2
    want = jax_build.build_semisup_train_loader_two_crops(ref, seed=3)
    shapes = {"label": set(), "unlabel": set()}
    with build_semisup_train_loader_two_crops(ours, seed=3) as got:
        for _ in range(4):
            g, w = next(got), next(want)
            for stream, (g_pair, w_pair) in zip(shapes, zip(g, w)):
                for gb, wb in zip(g_pair, w_pair):
                    _assert_batches_equal(gb, wb)
                shapes[stream].add(tuple(g_pair[0].image.shape[1:3]))
                assert not torch.equal(g_pair[0].image, g_pair[1].image)  # the strong view differs
                assert torch.equal(g_pair[0].gt_boxes, g_pair[1].gt_boxes)  # one geometric transform
    jax_build.stop_all_prefetchers()
    assert shapes == {"label": {(96, 160), (160, 96)}, "unlabel": {(96, 160), (160, 96)}}


# ---------------- the discriminator ----------------
def test_grad_reverse_and_discriminator_equal_jax(mt):
    """The logits, both BCE terms, the input's gradient (reversed) and the
    parameters' (not reversed) on the same weights."""
    host = mt["host"]
    x = np.random.RandomState(1).randn(2, 4, 6, 256).astype(np.float32)
    disc = jax_mt.FCDiscriminator()

    def loss(p, x):
        d = disc.apply(p, jax_mt.grad_reverse(x))
        return jax_mt._bce_with_logits(d, jnp.zeros_like(d)) + 2 * jax_mt._bce_with_logits(d, jnp.ones_like(d)), d

    (want_loss, want_d), (want_gp, want_gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        host.dis_params, jnp.asarray(x))
    ours = FCDiscriminator(256)
    ours.load_state_dict(mt["weights"]["discriminator"])

    def backward(reverse):
        tx = _t(x).requires_grad_(True)
        ours.zero_grad()
        with torch.enable_grad():
            d = ours(grad_reverse(tx) if reverse else tx)
            total = bce_with_logits(d, torch.zeros_like(d)) + 2 * bce_with_logits(d, torch.ones_like(d))
            total.backward()
        return d, total, tx.grad

    d, total, gx = backward(reverse=True)
    assert d.shape == (2, 4, 6, 1)
    np.testing.assert_allclose(_np(d), np.asarray(want_d), **DIS_TOL)
    np.testing.assert_allclose(total.item(), float(want_loss), **DIS_TOL)
    np.testing.assert_allclose(_np(gx), np.asarray(want_gx), **DIS_TOL)
    want_p = convert_jax_mt_state(host.replace(dis_params=want_gp))["discriminator"]
    for name, p in ours.named_parameters():
        assert p.grad.abs().max() > 0, name
        np.testing.assert_allclose(_np(p.grad), _np(want_p[name]), **DIS_TOL, err_msg=name)
    assert torch.equal(backward(reverse=False)[2], -gx)


# ---------------- the step ----------------
def test_pseudo_labels_equal_jax(mt):
    ours, tb = mt["ours"], mt["tb"]
    w_boxes, w_classes, w_valid = mt["pseudo"]
    scores, valid = mt["teacher_scores"]
    assert np.abs(scores[valid] - mt["cfg"].SEMISUPNET.BBOX_THRESHOLD).min() > 1e-3
    ours.teacher.load_state_dict(mt["weights"]["teacher"])
    boxes, classes, keep = ours._pseudo_label(ours.teacher, tb[3])
    assert boxes.shape == (B, G, 4) and classes.dtype == torch.int32 and keep.dtype == torch.bool
    np.testing.assert_array_equal(_np(keep), np.asarray(w_valid))
    assert 0 < int(keep.sum()) < keep.numel()
    np.testing.assert_array_equal(_np(classes)[_np(keep)], np.asarray(w_classes)[np.asarray(w_valid)])
    np.testing.assert_allclose(_np(boxes)[_np(keep)], np.asarray(w_boxes)[np.asarray(w_valid)], rtol=0, atol=1e-3)


@pytest.mark.parametrize("phase", list(PHASES))
def test_mt_step_equals_jax(mt, phase):
    step = PHASES[phase]
    new_state, want_metrics = mt["want"][phase]
    ours = _port_state_at(mt, step)
    before = {name: copy.deepcopy(m.state_dict()) for name, m in
              (("model", ours.model), ("teacher", ours.teacher), ("discriminator", ours.discriminator))}
    metrics = ours.mt_step(*mt["tb"], *_step_draws(step))
    assert ours.state.iteration == step + 1 and ours.optimizer.count == ours.dis_optimizer.count == 1
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-5, err_msg=k)
    want = convert_jax_mt_state(new_state)
    for name in ("model", "teacher", "discriminator"):
        _state_close(getattr(ours, name).state_dict(), want[name], name)
    teacher, student = ours.teacher.state_dict(), ours.model.state_dict()
    if phase == "before_burn_up":
        assert all(float(metrics[k]) == 0 for k in ("loss_cls_pseudo", "loss_rpn_cls_pseudo", "loss_D"))
        assert all(torch.equal(v, before["teacher"][k]) for k, v in teacher.items())
        assert all(torch.equal(v, before["discriminator"][k]) for k, v in ours.discriminator.state_dict().items())
    elif phase == "at_burn_up":
        assert all(torch.equal(v, student[k]) for k, v in teacher.items())
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(new_state.teacher_params),
                                                        jax.tree_util.tree_leaves(new_state.params)))
    else:
        assert all(float(metrics[k]) > 0 for k in ("loss_cls_pseudo", "loss_rpn_cls_pseudo", "loss_D"))
        assert any(not torch.equal(v, before["discriminator"][k]) for k, v in ours.discriminator.state_dict().items())
        moved = [k for k in teacher if not torch.equal(teacher[k], before["teacher"][k])]
        assert "backbone.layer3.0.conv1.weight" in moved
    assert any(not torch.equal(v, before["model"][k]) for k, v in student.items())


def test_compute_val_loss_equals_jax_and_leaves_the_student(mt):
    ours = _port_state_at(mt, 0)
    ours.model.zero_grad(set_to_none=True)
    _, want_metrics = mt["want"]["before_burn_up"]  # SUP_LOSS_WEIGHT 1: JAX's supervised_losses(k1)
    before = copy.deepcopy(ours.model.state_dict())
    draw, _ = _step_draws(PHASES["before_burn_up"])
    losses = ours.compute_val_loss(mt["tb"][0], draw)
    assert set(losses) == {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc"}
    for k, v in losses.items():
        np.testing.assert_allclose(v, float(want_metrics[k]), rtol=1e-5, err_msg=k)
    assert all(torch.equal(v, before[k]) for k, v in ours.model.state_dict().items())
    assert all(p.grad is None for p in ours.model.parameters())
    again = ours.compute_val_loss(mt["tb"][0])
    assert again == ours.compute_val_loss(mt["tb"][0])  # the default draws are seeded


# ---------------- the trainer ----------------
def _mt_tiny_cfg(out_dir, **overrides):
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(MT_TINY))
    cfg.merge_from_list([x for k, v in {
        "OUTPUT_DIR": str(out_dir), "DATASETS.TRAIN": ("port_engine_trainval_plain",),
        "DATASETS.TEST": ("port_engine_test",), "SOLVER.IMG_PER_BATCH_LABEL": 2, "SOLVER.IMG_PER_BATCH_UNLABEL": 2,
        "SEMISUPNET.BURN_UP_STEP": 1, **overrides}.items() for x in (k, repr(v))])
    return cfg


def test_a_mean_teacher_save_resumes_bit_for_bit(fixture_root, tmp_path):  # noqa: F811
    """4 steps straight equal 2 steps, a save, a new trainer resumed from it
    and 2 steps: the student, the teacher, the discriminator and both
    optimizers. A save restores only into its own kind of trainer."""
    cfg = _mt_tiny_cfg(tmp_path / "a")
    straight = MeanTeacherTrainer(cfg, device="cpu")
    straight.resume_or_load(resume=False)
    with straight.build_train_loader() as loader:
        batches = [next(loader) for _ in range(4)]
    for b in batches:
        straight.run_step(b)

    cut = _mt_tiny_cfg(tmp_path / "b")
    first = MeanTeacherTrainer(cut, device="cpu")
    first.resume_or_load(resume=False)
    for b in batches[:2]:
        first.run_step(b)
    first.checkpointer.save("model_0000001", first.state)
    resumed = MeanTeacherTrainer(cut, device="cpu")
    resumed.resume_or_load(resume=True)
    assert resumed.start_iter == 2
    for b in batches[2:]:
        resumed.run_step(b)

    want, got = straight.state.state_dict(), resumed.state.state_dict()
    assert want.keys() == got.keys() == {"model", "optimizer", "iteration", "teacher", "discriminator",
                                         "dis_optimizer"}
    assert got["iteration"] == 4 and got["optimizer"]["count"] == got["dis_optimizer"]["count"] == 4
    for name in ("model", "teacher", "discriminator"):
        for k, v in want[name].items():
            assert torch.equal(got[name][k], v), (name, k)
    for name in ("optimizer", "dis_optimizer"):
        w, g = want[name]["sgd"]["state"], got[name]["sgd"]["state"]
        assert w.keys() == g.keys() and len(w) > 0
        assert all(torch.equal(g[i]["momentum_buffer"], w[i]["momentum_buffer"]) for i in w), name

    plain = DefaultTrainer(cut, device="cpu")
    with pytest.raises(ValueError, match="mean-teacher"):
        plain.checkpointer.load(str(tmp_path / "b" / "model_0000001.pth"), plain.state)
    first.checkpointer.save("model_0000001", plain.state)
    with pytest.raises(ValueError, match="mean-teacher"):
        MeanTeacherTrainer(cut, device="cpu").resume_or_load(resume=True)


def test_train_net_runs_the_mean_teacher_with_jax_loss_names(mt, fixture_root, tmp_path):  # noqa: F811
    """`train_net.main` on mt_tiny.yaml (3 steps, burn-up 1, an evaluation
    of the student and the teacher at step 2): JAX's loss names, a final
    test of the teacher, and `--eval-only` refusing the mean-teacher save as
    orbax refuses it in JAX."""
    _, want_metrics = mt["want"]["past_burn_up"]
    out = tmp_path / "out"
    opts = ["OUTPUT_DIR", str(out), "DATASETS.TRAIN", "('port_engine_trainval_plain',)", "DATASETS.TEST",
            "('port_engine_test',)", "SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.IMG_PER_BATCH_UNLABEL", "2",
            "SOLVER.MAX_ITER", "3", "SEMISUPNET.BURN_UP_STEP", "1", "TEST.EVAL_PERIOD", "2"]
    parser = train_net.default_argument_parser()
    seen = []
    test = MeanTeacherTrainer.test

    def spy(self, cfg=None, model=None):
        seen.append("teacher" if model is self.teacher else "student")
        return test(self, cfg, model)

    MeanTeacherTrainer.test = spy
    try:
        results = train_net.main(parser.parse_args(["--device", "cpu", "--config-file", str(MT_TINY), *opts]))
    finally:
        MeanTeacherTrainer.test = test
    assert seen == ["student", "teacher", "teacher"]
    assert "AP50" in results["port_engine_test"]["bbox"]
    metrics = json.loads((out / "metrics.json").read_text().splitlines()[-1])
    assert set(want_metrics) <= set(metrics), sorted(metrics)
    assert all(np.isfinite(metrics[k]) for k in want_metrics)
    assert {"port_engine_test/bbox/AP50", "teacher/port_engine_test/bbox/AP50"} <= set(metrics)
    with pytest.raises(ValueError, match="mean-teacher"):
        train_net.main(parser.parse_args(["--device", "cpu", "--eval-only", "--config-file", str(MT_TINY), *opts,
                                          "MODEL.WEIGHTS", str(out / "model_final.pth")]))


@pytest.mark.parametrize("expected, passes", [((3, 0.67, 0.01), True), ((3, 0.6, 0.05), False),
                                              ((2, 0.67, 0.01), False), ((), True)])
def test_pseudo_label_verification_passes_and_fails_as_jax(mt, monkeypatch, expected, passes):
    """Both packages score the same pseudo-labels against the same batch
    (count and precision equal), then accept or refuse them alike."""
    boxes = np.array([[[10, 10, 40, 40], [50, 50, 80, 90], [0, 0, 5, 5], [1, 1, 2, 2]],
                      [[20, 20, 60, 60], [0, 0, 1, 1], [0, 0, 1, 1], [0, 0, 1, 1]]], np.float32)
    classes = np.array([[1, 2, 3, 0], [4, 0, 0, 0]], np.int32)
    valid = np.array([[True, True, False, False], [True, False, False, False]])
    gt = _synthetic_batch(2, 64, 96, g=4, seed=0)._replace(
        gt_boxes=jnp.asarray(np.array([[[12, 12, 40, 42], [50, 50, 80, 90], [0, 0, 1, 1], [0, 0, 1, 1]],
                                       [[20, 20, 60, 60], [0, 0, 1, 1], [0, 0, 1, 1], [0, 0, 1, 1]]], np.float32)),
        gt_classes=jnp.asarray(np.array([[1, 5, 0, 0], [4, 0, 0, 0]], np.int32)),
        gt_valid=jnp.asarray(np.array([[True, True, False, False], [True, False, False, False]])))
    jtr, ours, cfg = mt["jax_trainer"], mt["ours"], mt["cfg"]
    monkeypatch.setattr(cfg.SEMISUPNET, "EXPECTED_PSEUDO", list(expected))
    monkeypatch.setattr(jax_data, "build_semisup_train_loader_two_crops", lambda *a, **k: iter([((gt, gt), (gt, gt))]))
    monkeypatch.setattr(jtr, "_pseudo_label", lambda *a: (jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid)))

    class OneBatch:
        def __enter__(self):
            return iter([((None, None), (None, _torch_batch(gt)))])

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(ours, "build_train_loader", OneBatch)
    monkeypatch.setattr(ours, "_pseudo_label", lambda *a: (_t(boxes), _t(classes), _t(valid)))
    assert ours.pseudo_label_stats() == jtr.pseudo_label_stats() == (3, pytest.approx(2 / 3))
    outcomes = []
    for verify, error in ((jtr._verify_pseudo_labels, AssertionError), (ours._verify_pseudo_labels, RuntimeError)):
        try:
            verify()
            outcomes.append(True)
        except error as e:
            assert "Pseudo-label verification failed" in str(e)
            outcomes.append(False)
    assert outcomes == [passes, passes]


# ---------------- the configuration ----------------
@pytest.mark.parametrize("key, value", [
    ("SEMISUPNET.Trainer", "baseline"), ("SEMISUPNET.DIS_TYPE", "res5"),
    ("SEMISUPNET.PSEUDO_BBOX_SAMPLE", "nms"), ("SEMISUPNET.LOSS_WEIGHT_TYPE", "focal"),
    ("MODEL.RPN.LOSS", "FocalLoss"), ("MODEL.ROI_HEADS.LOSS", "FocalLoss"),
])
def test_unimplemented_mean_teacher_values_raise_naming_their_key(key, value):
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(MT_TINY))
    check_supported(cfg)
    cfg.merge_from_list([key, value])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        check_supported(cfg)


def test_the_accuracy_schedule_stays_refused_on_one_device():
    """mt_rcnn_training_acc_test.yaml shards its batch over 4 devices."""
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(REPO / "configs" / "quick_schedules" / "mt_rcnn_training_acc_test.yaml"))
    cfg.MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER = True  # the schedule's linear head is refused first
    assert list(cfg.TPU.MESH_SHAPE) == [4]
    with pytest.raises(NotImplementedError, match=r"TPU\.MESH_SHAPE"):
        check_supported(cfg)
