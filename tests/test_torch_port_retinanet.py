"""RetinaNet in the port against cddmsl_tpu on the CPU: the p3..p7 maps and
the head's outputs, the focal and box losses (smooth-L1 and GIoU) with the
EMA normalizer's update, the per-level candidates and the detections, two
train steps from the same tree through JAX's `make_train_step`, the
converters (`convert_jax_params`, the `d2_retinanet` dialect), world 2
under gloo against world 1, RETINANET.NORM GN refused beside JAX's crash
at init, and the configs the port accepts and refuses.

One JAX program: the losses, the candidates, the inference and the two
steps compiled together, at RESNETS.DEPTH 10 with a bottleneck of 8, an FPN
of 32 and a head of two convs of 16, 20 classes, on two 96x160 images (the
second zero-padded from 80x128). Tolerances, and why:
- maps and head outputs within 1e-5 of their largest magnitude;
- the losses and the normalizer within rtol 1e-5 (sums over every anchor
  in another order);
- the candidates and the detections: the same classes, order and validity,
  scores within 1e-5, boxes within 1e-3 px of the resized frame plus the
  float32 rounding of the decode (4e-6 of the coordinate: p7's anchors are
  up to 812 px wide and the decode's exp and products round at that size);
- a step's losses within rtol 1e-5 and its update within 1e-5 of the
  update's norm; world 2's within 1e-5 of world 1's.
"""

import socket
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cddmsl_tpu.checkpoint.convert_torch import load_rcnn_weights as jax_load_rcnn_weights
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.engine import TrainState, make_train_step
from cddmsl_tpu.engine.train_loop import split_batch_stats
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from cddmsl_tpu.ops.anchors import anchor_grid as jax_anchor_grid
from cddmsl_tpu.ops.anchors import generate_cell_anchors as jax_cell_anchors
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_tpu.solver.build import build_lr_schedule as jax_build_lr_schedule
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params, init_random_
from cddmsl_torch.checkpoint.convert_torch import detect_dialect, load_rcnn_weights
from cddmsl_torch.config import check_supported, get_cfg, model_family, solver_config_from_cfg
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.models.backbone.batch_norm import updating_running_state
from cddmsl_torch.models.build import build_detector, retinanet_fields
from cddmsl_torch.models.retinanet import OCTAVE_SIZES, RetinaNet
from cddmsl_torch.ops.anchors import generate_cell_anchors
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_backbone import fill_params
from test_torch_port_fpn import BATCH_A, D2_PIXELS, K, torch_batch
from test_torch_port_norms import update_apart

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MAP_RTOL, LOSS_RTOL, SCORE_ATOL, BOX_ATOL, BOX_RTOL, UPDATE_RTOL = 1e-5, 1e-5, 1e-5, 1e-3, 4e-6, 1e-5
TINY = dict(num_classes=K, depth=10, backbone_width=8, res2_out_channels=32, fpn_out_channels=32,
            head_conv_dims=(16, 16), score_thresh=0.6, topk_candidates=60, detections_per_image=40, **D2_PIXELS)
SOLVER = ["SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "0"]
CONFIGS = ["Base-RetinaNet.yaml", "COCO-Detection/retinanet_R_50_FPN_1x.yaml",
           "COCO-Detection/retinanet_R_50_FPN_3x.yaml", "COCO-Detection/retinanet_R_101_FPN_3x.yaml",
           "quick_schedules/retinanet_R_50_FPN_instant_test.yaml"]


def retina_variables(module, batch, seed):
    """JAX's variables (`fill_params` over eval_shape of `init_all`) with the
    normalizer at its start, 100."""
    shapes = jax.eval_shape(lambda r, b: module.init({"params": r}, b, r, method=module.init_all),
                            jax.random.PRNGKey(0), batch)
    return {"params": fill_params({"params": shapes["params"]}, seed=seed)["params"],
            "batch_stats": {"loss_normalizer": np.float32(100.0)}}


def jax_candidates(m, batch):
    """JAX's per-level candidates, as its `inference` takes them before the
    merge (retinanet.py: top-k, then the threshold, decode unclipped)."""
    levels = m._features(batch.image)
    logits_l, deltas_l = m.head(levels)
    b, out = batch.image.shape[0], []
    for logit_map, delta_map, stride, sizes in zip(logits_l, deltas_l, m.strides, m.anchor_sizes):
        h, w = logit_map.shape[1:3]
        anchors = jax_anchor_grid(h, w, stride, jax_cell_anchors(tuple(sizes), tuple(m.aspect_ratios)))
        logit = logit_map.reshape(b, -1, m.num_classes).astype(jnp.float32)
        delta = delta_map.reshape(b, -1, 4).astype(jnp.float32)
        k = min(m.topk_candidates, logit.shape[1] * m.num_classes)

        def per_image(lg, dl, anchors=anchors, k=k):
            top_p, top_i = jax.lax.top_k(jax.nn.sigmoid(lg).reshape(-1), k)
            a_idx = top_i // m.num_classes
            boxes = m.box2box.apply_deltas(dl[a_idx], anchors[a_idx])
            return boxes, jnp.where(top_p > m.score_thresh, top_p, 0.0), (top_i % m.num_classes).astype(jnp.int32)

        out.append(jax.vmap(per_image)(logit, delta))
    return levels, logits_l, deltas_l, out


@pytest.fixture(scope="module")
def retina_runs():
    """JAX's maps, head outputs, losses (both box losses) with the mutated
    normalizer, candidates, detections and two train steps, in one program;
    the port from the converted variables."""
    model, giou = JaxRetinaNet(**TINY), JaxRetinaNet(**TINY, box_reg_loss_type="giou")
    variables = retina_variables(model, BATCH_A, seed=7)
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c in (jcfg, cfg):
        c.merge_from_list(SOLVER)
    optimizer = jax_build_optimizer(jcfg, split_batch_stats(variables)[0])
    step = make_train_step(model, optimizer, enable_caption=False, lr_schedule=jax_build_lr_schedule(jcfg),
                           donate=False)
    rngs = [jax.random.PRNGKey(80 + i) for i in range(2)]

    def program(v, b):
        losses = {name: m.apply(v, b, rngs[0], method=m.losses, mutable=["batch_stats"])
                  for name, m in (("smooth_l1", model), ("giou", giou))}
        state, steps = TrainState.create(v, optimizer), []
        for r in rngs:
            state, metrics = step(state, b, r)
            steps.append((state.params, metrics))
        return (losses, model.apply(v, b, method=jax_candidates), model.apply(v, b, method=model.inference), steps)

    losses, (levels, logits, deltas, cands), det, steps = jax.jit(program)(variables, BATCH_A)
    ours = RetinaNet(**TINY)
    ours.load_state_dict(convert_jax_params(variables), strict=True)
    return dict(variables=variables, losses=losses, levels=levels, logits=logits, deltas=deltas, cands=cands,
                det=det, steps=steps, model=ours, cfg=cfg)


def test_maps_and_head_outputs_equal_jax(retina_runs):
    ours = retina_runs["model"]
    tb = torch_batch(BATCH_A)
    with torch.no_grad():
        levels = ours.features(tb.image)
        logits, deltas = ours.head(levels)
    assert [tuple(lv.shape[1:3]) for lv in levels] == [(12, 20), (6, 10), (3, 5), (2, 3), (1, 2)]
    for got, want in zip((levels, logits, deltas), (retina_runs["levels"], retina_runs["logits"],
                                                   retina_runs["deltas"])):
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=MAP_RTOL * np.abs(w).max())


@pytest.mark.parametrize("kind", ["smooth_l1", "giou"])
def test_losses_and_the_normalizer_equal_jax(retina_runs, kind):
    """Both box losses and the focal loss divided by the normalizer moved
    first (100 -> 0.9 * 100 + 0.1 * foreground anchors); outside the
    mutable apply the normalizer divides unmoved."""
    want, mutated = retina_runs["losses"][kind]
    ours = RetinaNet(**TINY, box_reg_loss_type=kind)
    ours.load_state_dict(convert_jax_params(retina_runs["variables"]), strict=True)
    tb = torch_batch(BATCH_A)
    with torch.no_grad():
        still = ours.losses(tb)
        assert float(ours.loss_normalizer) == 100.0
        with updating_running_state(ours):
            got = ours.losses(tb)
    moved = float(mutated["batch_stats"]["loss_normalizer"])
    assert moved < 100.0
    np.testing.assert_allclose(float(ours.loss_normalizer), moved, rtol=LOSS_RTOL)
    for k in ("loss_cls", "loss_box_reg"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(still[k].item(), got[k].item(), rtol=LOSS_RTOL)  # the same norm, not moved twice


def _assert_boxes_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL + BOX_RTOL * np.abs(want).max())


def test_per_level_candidates_equal_jax(retina_runs):
    """Top-k per level of the flattened anchor-major, class-fastest scores,
    zeroed at or under the threshold only after the top-k, decoded
    without clipping; at p3 the filled head saturates the sigmoid, so the
    top-k chooses among equal scores by index."""
    with torch.no_grad():
        got = retina_runs["model"].candidates(torch_batch(BATCH_A))
    assert len(got) == 5
    for (gb, gs, gc), (wb, ws, wc) in zip(got, retina_runs["cands"]):
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=SCORE_ATOL)
        _assert_boxes_close(gb.numpy(), np.asarray(wb))
    scores = torch.cat([g[1] for g in got], dim=1)
    assert (scores == 0).any() and (scores > 0).any()  # some under the threshold, some over
    assert (got[0][1] == 1.0).sum() > 60  # p3's saturated scores tie: the top-k keeps the lower indices, as JAX's


def test_detections_equal_jax(retina_runs):
    """The five levels' candidates through one class-aware NMS (K4's plain
    version here), rescaled to the originals and clipped."""
    with torch.no_grad():
        got = retina_runs["model"].inference(torch_batch(BATCH_A))
    want = retina_runs["det"]
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    assert v.sum() > 10
    np.testing.assert_array_equal(got.classes.numpy()[v], np.asarray(want.classes)[v])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=SCORE_ATOL)
    _assert_boxes_close(got.boxes.numpy()[v] / 2, np.asarray(want.boxes)[v] / 2)  # in the resized frame
    np.testing.assert_array_less(got.boxes.numpy()[0, :, 2], 320.001)  # clipped to the 192x320 original


def test_two_train_steps_equal_jax(retina_runs):
    """Two steps of JAX's `make_train_step` from the same variables, the
    port's `Trainer` from the converted ones: each step's losses, the
    state after it (the parameters and the normalizer, which moves twice)."""
    ours = RetinaNet(**TINY)
    ours.load_state_dict(convert_jax_params(retina_runs["variables"]), strict=True)
    trainer = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(retina_runs["cfg"])), enable_caption=False)
    tb = torch_batch(BATCH_A)
    for i, (params, want) in enumerate(retina_runs["steps"]):
        before = {k: v.clone() for k, v in ours.state_dict().items()}
        got = trainer.train_step(tb, draw=lambda *a: None)
        for k in ("loss_cls", "loss_box_reg"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, err_msg=f"step {i} {k}")
        want_state = convert_jax_params(params)
        assert update_apart(before, ours.state_dict(), want_state) < UPDATE_RTOL
        np.testing.assert_allclose(float(ours.loss_normalizer), float(want_state["loss_normalizer"]), rtol=LOSS_RTOL)
    assert float(ours.loss_normalizer) < 100.0


# ---------------- converters ----------------
def test_a_jax_tree_converts_onto_every_tensor(retina_runs):
    """Every parameter and the normalizer (JAX's `batch_stats`) have their
    tensor; the head's convs i are detectron2's cls_subnet / bbox_subnet
    entries 2i."""
    state = convert_jax_params(retina_runs["variables"])
    assert set(state) == set(RetinaNet(**TINY).state_dict())
    tree = retina_runs["variables"]["params"]
    np.testing.assert_array_equal(state["head.bbox_subnet.2.bias"].numpy(), tree["head"]["box_conv1"]["bias"])
    np.testing.assert_array_equal(state["backbone.top_block.p7.bias"].numpy(), tree["fpn"]["top_block_p7"]["bias"])
    assert float(state["loss_normalizer"]) == 100.0


def test_a_d2_retinanet_file_loads_as_jax_converts_it(retina_runs, tmp_path):
    """A detectron2 RetinaNet file with every tensor random (the port's
    names are its names): the port's load equals JAX's `load_rcnn_weights`
    read through its module; the normalizer is not in the file."""
    ours = RetinaNet(**TINY)
    ours.load_state_dict(convert_jax_params(retina_runs["variables"]), strict=True)
    g = torch.Generator().manual_seed(2)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in ours.state_dict().items() if k != "loss_normalizer"}
    path = tmp_path / "retinanet.pth"
    torch.save({"model": sd}, path)
    assert detect_dialect(sd) == "d2_retinanet"
    assert load_rcnn_weights(ours, str(path)) == "d2_retinanet"
    loaded = jax_load_rcnn_weights({"params": retina_runs["variables"]["params"]}, str(path))
    want = convert_jax_params({**retina_runs["variables"], "params": loaded["params"]})
    for k, v in ours.state_dict().items():
        assert torch.equal(v, want[k]), k
        if k != "loss_normalizer" and not k.endswith(("running_mean", "running_var", "norm.weight", "norm.bias")):
            assert torch.equal(v, sd[k]), k


def test_init_random_puts_the_prior_on_the_classifier():
    model = init_random_(RetinaNet(**TINY), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(model.head.cls_score.bias.detach().numpy(), -np.log(0.99 / 0.01), rtol=1e-6)
    assert model.head.bbox_pred.bias.abs().max() == 0


# ---------------- world 2 under gloo ----------------
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_step(rank, world, port, variables, out):
    from cddmsl_torch.parallel import comm

    torch.set_num_threads(1)
    comm.initialize("gloo", f"tcp://localhost:{port}", world, rank, device="cpu")
    try:
        model = RetinaNet(**TINY)
        model.load_state_dict(convert_jax_params(variables), strict=True)
        cfg = get_cfg()
        cfg.merge_from_list(SOLVER)
        trainer = Trainer(model, build_optimizer(model, solver_config_from_cfg(cfg)), enable_caption=False)
        tb = torch_batch(BATCH_A)
        lo, hi = comm.local_rows(tb.image.shape[0])
        metrics = trainer.train_step(type(tb)(*(None if f is None else f[lo:hi] for f in tb)), draw=lambda *a: None)
        means = {k: v.detach().clone() for k, v in metrics.items() if k.startswith("loss_")}
        comm.all_reduce_mean_(list(means.values()))
        if rank == 0:
            torch.save({"state": model.state_dict(), "losses": {k: v.item() for k, v in means.items()}}, out)
    finally:
        comm.destroy()


def test_world_2_under_gloo_equals_world_1(retina_runs, tmp_path):
    """Two CPU ranks, one image each: the foreground count is the global
    batch's, so the normalizer, the losses' rank mean and the update equal
    one process's step on both images."""
    out = tmp_path / "rank0.pt"
    variables = jax.tree_util.tree_map(np.asarray, retina_runs["variables"])
    mp.start_processes(_rank_step, args=(2, _free_port(), variables, str(out)), nprocs=2, join=True,
                       start_method="spawn")
    ours = RetinaNet(**TINY)
    ours.load_state_dict(convert_jax_params(retina_runs["variables"]), strict=True)
    trainer = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(retina_runs["cfg"])), enable_caption=False)
    before = {k: v.clone() for k, v in ours.state_dict().items()}
    want = trainer.train_step(torch_batch(BATCH_A), draw=lambda *a: None)
    world2 = torch.load(out)
    np.testing.assert_allclose(float(world2["state"]["loss_normalizer"]), float(ours.loss_normalizer), rtol=1e-7)
    for k in ("loss_cls", "loss_box_reg"):
        np.testing.assert_allclose(world2["losses"][k], want[k].item(), rtol=LOSS_RTOL, err_msg=k)
    assert update_apart(before, world2["state"], ours.state_dict()) < UPDATE_RTOL


# ---------------- RETINANET.NORM GN ----------------
def test_the_gn_head_is_refused_where_jax_fails_at_init():
    """JAX's head names one GroupNorm32 per level under one name: its init
    raises NameInUseError on the second level. The port refuses the key."""
    with pytest.raises(flax.errors.NameInUseError):
        jax.eval_shape(lambda r: JaxRetinaNet(**TINY, head_norm="GN").init(
            {"params": r}, BATCH_A, r, method=JaxRetinaNet.init_all), jax.random.PRNGKey(0))
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / CONFIGS[-1]))
    cfg.merge_from_list(["MODEL.RETINANET.NORM", "GN"])
    with pytest.raises(NotImplementedError, match=r"MODEL\.RETINANET\.NORM"):
        check_supported(cfg, world=1)


# ---------------- configs ----------------
def _both(path, *opts):
    ours, ref = get_cfg(), jax_get_cfg()
    for c in (ours, ref):
        c.merge_from_file(str(REPO / "configs" / path))
        c.merge_from_list(list(opts))
    return ours, ref


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: Path(p).stem)
def test_the_retinanet_configs_are_accepted_with_the_jax_builders_fields(path):
    """Accepted at world 1; every field of `retinanet_fields` is JAX's
    `build_retinanet`'s module's (the octave sizes of Base-RetinaNet.yaml
    are the module's default groups; one group broadcasts over the five
    levels); the model builds (on the meta device at full width)."""
    ours, ref = _both(path)
    check_supported(ours, world=1)
    assert model_family(ours) == "retinanet"
    want = jax_build_model(ref)
    assert type(want).__name__ == "RetinaNet"
    for name, value in retinanet_fields(ours).items():
        expect = getattr(want, name)
        if name == "dtype":
            assert str(value).split(".")[-1] == jnp.dtype(expect).name
        elif name == "anchor_sizes":
            assert value == tuple(tuple(g) for g in expect)
        else:
            assert value == (tuple(expect) if isinstance(expect, (list, tuple)) else expect), name
    if "instant" not in path:
        np.testing.assert_allclose(np.asarray(retinanet_fields(ours)["anchor_sizes"]), np.asarray(OCTAVE_SIZES),
                                   rtol=1e-7)
        cell = generate_cell_anchors(retinanet_fields(ours)["anchor_sizes"][0], (0.5, 1.0, 2.0))
        np.testing.assert_array_equal(cell, np.asarray(jax_cell_anchors(tuple(want.anchor_sizes[0]), (0.5, 1.0, 2.0))))
    with torch.device("meta"):
        model = build_detector(ours, device="meta")
    anchors = len(want.anchor_sizes[0]) * len(want.aspect_ratios)  # 9, or 15 from the instant schedule's one group of 5
    assert type(model).__name__ == "RetinaNet" and model.head.cls_score.out_channels == anchors * want.num_classes


@pytest.mark.parametrize("key, value", [
    ("MODEL.RETINANET.IN_FEATURES", ["p3", "p4", "p5", "p6"]), ("MODEL.RETINANET.NUM_CONVS", 2),
    ("MODEL.RETINANET.PRIOR_PROB", 0.02), ("MODEL.RETINANET.BBOX_REG_WEIGHTS", [10.0, 10.0, 5.0, 5.0]),
    ("MODEL.RETINANET.NORM", "SyncBN"), ("MODEL.RETINANET.BBOX_REG_LOSS_TYPE", "diou"),
    ("MODEL.RESNETS.NORM", "GN"), ("MODEL.RESNETS.STRIDE_IN_1X1", False), ("MODEL.RESNETS.NUM_GROUPS", 32),
    ("MODEL.RESNETS.WIDTH_PER_GROUP", 8), ("MODEL.RESNETS.RES5_DILATION", 2),
    ("MODEL.RESNETS.OUT_FEATURES", ["res2", "res3", "res4", "res5"]), ("MODEL.FPN.NORM", "GN"),
    ("MODEL.FPN.OUT_CHANNELS", 128), ("MODEL.FPN.IN_FEATURES", ["res2", "res3", "res4", "res5"]),
    ("MODEL.BACKBONE.NAME", "build_resnet_fpn_backbone"), ("TPU.BACKBONE_WIDTH", 16), ("MODEL.MASK_ON", True),
    ("MODEL.ANCHOR_GENERATOR.SIZES", [[32], [64]]),
])
def test_the_keys_retinanet_does_not_read_are_refused_naming_them(key, value):
    ours, _ = _both(CONFIGS[1])
    ours.merge_from_list([key, repr(value) if not isinstance(value, str) else value])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        check_supported(ours, world=1)
