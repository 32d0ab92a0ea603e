"""Keypoint R-CNN as whole detectors in the port against cddmsl_tpu on the
CPU, and the keypoint schedules through the port's `train_net`.

Two JAX programs, each compiled once for its module-scoped fixture:
- the FPN Keypoint R-CNN at RESNETS.DEPTH 10 (test_torch_port_fpn.py's
  narrow widths) with a keypoint head of 2 convs of 16 and 3 keypoints, on
  two 96x160 images (the second 80x128 inside the pad, their originals
  twice the size) with 3 keypoints per ground-truth box: visible ones
  inside the box (one on its far corner), an unlabelled one, and one
  labelled outside the box;
- the tiny CLIP C4 detector (`_flagship_cfg(tiny=True)`) with
  MODEL.KEYPOINT_ON, on two 64x96 images.
Each is held on its losses (`loss_keypoint` included) with JAX's draws
replayed, rtol 1e-4; on every parameter's gradient, within 1e-4 of its
tensor's largest gradient and never less than 1e-5 (as
test_torch_port_fpn.py holds them); and on its inference: the detections
as test_torch_port_fpn.py ranks them (scores 5e-5, boxes 1e-3 px) and each
detection's decoded keypoints, (x, y) within 1e-3 px and the score within
1e-5, after the rescale to the originals for the FPN (2e-3 px there, the
boxes' tolerance times the scale).

configs/quick_schedules/keypoint_rcnn_R_50_FPN_instant_test.yaml and
cascade_mask_rcnn_R_50_FPN_instant_test.yaml run through `train_net` and
`--eval-only`; a few steps of the keypoint schedule run in lockstep with
JAX's train step from JAX's initial tree. Marked `slow`, outside Tier-1:
the keypoint goldens (keypoint_rcnn_training_acc_test.yaml then
keypoint_rcnn_inference_acc_test.yaml) from JAX's initial tree and draws.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_goldens
from __graft_entry__ import _flagship_cfg, _synthetic_batch
from cddmsl_tpu.engine import TrainState, make_train_step
from cddmsl_tpu.models import DetBatch as JaxDetBatch
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.fpn_rcnn import FPNRCNN as JaxFPNRCNN
from cddmsl_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.config import add_ateacher_config, get_cfg, model_config_from_cfg, solver_config_from_cfg
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_train_loader
from cddmsl_torch.data.datasets.synthetic import register_synthetic_coco, register_synthetic_keypoints
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.evaluation import verify_results
from cddmsl_torch.models.build import build_detector, build_model
from cddmsl_torch.models.fpn_rcnn import FPNRCNN
from cddmsl_torch.models.rcnn import DetBatch
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_backbone import fill_params, jax_param_shapes
from test_torch_port_fpn import (
    BATCH_A, BATCH_B, D2_PIXELS, NARROW, assert_grads_match, assert_rows_match, close_detection, filled, torch_batch,
)
from test_torch_port_inference import BOX_ATOL
from torch_goldens import QUICK, jax_initial_tree, replaying_trainers, run_schedule, supervised_draw
from torch_goldens import _momentum, _update_apart, _worst_loss

torch.set_num_threads(1)

NUM_KP = 3
FPN_KP = {**NARROW, **D2_PIXELS, "keypoint_on": True, "num_keypoints": NUM_KP, "keypoint_conv_dims": (16, 16)}
NAMES = {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "loss_keypoint"}
KP_ATOL, KP_SCORE_ATOL = 1e-3, 1e-5


def box_keypoints(jb, k=NUM_KP, seed=0):
    """(B, G, k, 3) keypoints for the batch's ground-truth boxes: the first
    at the box's far corner (x2, y2), visible; the rest at random points
    inside, visible, but for one unlabelled (flag 0) and, where k > 3, one
    labelled outside the box."""
    r = np.random.RandomState(seed)
    boxes = np.asarray(jb.gt_boxes, np.float64)
    b, g = boxes.shape[:2]
    out = np.zeros((b, g, k, 3), np.float32)
    for i in range(b):
        for j in range(g):
            if not jb.gt_valid[i, j]:
                continue
            x1, y1, x2, y2 = boxes[i, j]
            out[i, j, 0] = (x2, y2, 2)
            for t in range(1, k):
                out[i, j, t] = (x1 + r.rand() * (x2 - x1), y1 + r.rand() * (y2 - y1), 2)
            out[i, j, 1 + (i + j) % (k - 1), 2] = 0
            if k > 3:
                out[i, j, k - 1] = (x2 + 3.0, y1, 2)
    return out


def assert_keypoints_match(got, want, atol, scale=1.0):
    """Per image, each valid detection's keypoints against JAX's detection
    of the same class and box (within BOX_ATOL px times `scale`): (x, y)
    within `atol` px, the score within KP_SCORE_ATOL."""
    assert got.keypoints is not None and got.keypoints.shape == np.asarray(want.keypoints).shape
    gk, wk = got.keypoints.numpy(), np.asarray(want.keypoints)
    matched = 0
    for i in range(gk.shape[0]):
        wb, wc = np.asarray(want.boxes[i]), np.asarray(want.classes[i])
        for d in np.nonzero(got.valid[i].numpy())[0]:
            same_box = np.abs(wb - got.boxes[i, d].numpy()).max(1) <= BOX_ATOL * scale
            close = np.nonzero((wc == int(got.classes[i, d])) & same_box & np.asarray(want.valid[i]))[0]
            assert len(close), (i, d)
            w = wk[i, close[0]]
            np.testing.assert_allclose(gk[i, d, :, :2], w[:, :2], rtol=0, atol=atol, err_msg=f"image {i} row {d}")
            np.testing.assert_allclose(gk[i, d, :, 2], w[:, 2], rtol=0, atol=KP_SCORE_ATOL)
            matched += 1
    assert matched > 0


# ---------------- the FPN program ----------------
@pytest.fixture(scope="module")
def fpn_kp_runs():
    """JAX's gradient of `supervised_losses` on batch A with its keypoints,
    and the inference of both batches (rescaled to the originals); the same
    in the port from the converted tree."""
    ba = BATCH_A._replace(gt_keypoints=jnp.asarray(box_keypoints(BATCH_A)))
    model, ours = JaxFPNRCNN(**FPN_KP), FPNRCNN(**FPN_KP)
    params = filled(model, ba, seed=23, port=ours)
    rng = jax.random.PRNGKey(11)

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
        tb = torch_batch(BATCH_A, gt_keypoints=torch.from_numpy(np.array(ba.gt_keypoints)))
        got_losses = ours.supervised_losses(tb, supervised_draw(rng))
        sum(got_losses.values()).backward()
    return dict(want=(out_a, out_b, losses, convert_jax_params(grads)), got=(*got, got_losses), model=ours)


def test_fpn_keypoint_rcnn_losses_and_gradients_equal_jax(fpn_kp_runs):
    """The five losses (`loss_keypoint` over the leading foreground rows
    where JAX pools all 32) and every parameter's gradient."""
    want_losses, want_grads = fpn_kp_runs["want"][2:]
    got_losses, model = fpn_kp_runs["got"][2], fpn_kp_runs["model"]
    assert set(got_losses) == set(want_losses) == NAMES
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].item(), float(v), rtol=1e-4, err_msg=k)
        assert float(v) > 0, k
    assert_grads_match(model, want_grads)


def test_fpn_keypoint_rcnn_detections_and_keypoints_equal_jax(fpn_kp_runs):
    """Both batches' detections and their 3 keypoints, rescaled to the
    originals (batch A's twice its size, batch B's its own)."""
    for want, got, scale in zip(fpn_kp_runs["want"][:2], fpn_kp_runs["got"][:2], (2.0, 1.0)):
        assert_rows_match(got, want, "detection", close_detection(scale))
        assert got.keypoints.shape[2:] == (NUM_KP, 3)
        assert_keypoints_match(got, want, KP_ATOL * scale, scale)


# ---------------- the C4 program ----------------
@pytest.fixture(scope="module")
def c4_kp_runs():
    cfg = _flagship_cfg(tiny=True)
    cfg.MODEL.KEYPOINT_ON = True
    cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = NUM_KP
    cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = [16, 16]
    model = jax_build_model(cfg)
    jb = _synthetic_batch(2, 64, 96, g=8, seed=2)
    jb = jb._replace(image_sizes=jnp.asarray([[64, 96], [56, 80]], jnp.int32))
    jb = jb._replace(gt_keypoints=jnp.asarray(box_keypoints(jb, seed=1)))
    config = model_config_from_cfg(cfg)
    params = fill_params(jax_param_shapes(config), seed=9)
    head = params["params"]["proposal_generator"]["head"]
    for name in ("objectness_logits", "anchor_deltas"):
        head[name]["kernel"] = head[name]["kernel"] / 4
    rng = jax.random.PRNGKey(3)

    def total(p, b, r):
        losses = model.apply(p, b, r, method=model.supervised_losses)
        return sum(losses.values()), losses

    (grads, losses), det = jax.jit(lambda p, b, r: (
        jax.grad(total, has_aux=True)(p, b, r), model.apply(p, b, False, method=model.inference)))(params, jb, rng)
    ours = build_model(config, device="cpu")
    state = convert_jax_params(params)
    ours.load_state_dict({k: v for k, v in state.items() if k in ours.state_dict()}, strict=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tb = DetBatch(t(jb.image), t(jb.image_sizes), t(jb.orig_sizes), t(jb.gt_boxes), t(jb.gt_classes), t(jb.gt_valid),
                  gt_keypoints=t(jb.gt_keypoints))
    with torch.no_grad():
        got_det = ours.inference(tb, do_postprocess=False)
    with torch.enable_grad():
        got_losses = ours.supervised_losses(tb, supervised_draw(rng))
        sum(got_losses.values()).backward()
    grads = convert_jax_params(grads)
    return dict(want=(det, losses, {k: v for k, v in grads.items() if k in ours.state_dict()}),
                got=(got_det, got_losses), model=ours)


def test_c4_keypoint_rcnn_losses_and_gradients_equal_jax(c4_kp_runs):
    """The tiny CLIP C4 detector: the keypoint head pools res4 again with
    2x2 samples; five losses and every parameter's gradient."""
    _, want_losses, want_grads = c4_kp_runs["want"]
    got_losses, model = c4_kp_runs["got"][1], c4_kp_runs["model"]
    assert set(got_losses) == set(want_losses) == NAMES
    for k, v in want_losses.items():
        np.testing.assert_allclose(got_losses[k].item(), float(v), rtol=1e-4, err_msg=k)
    assert model.roi_heads.keypoint_head.num_conv == 2
    assert_grads_match(model, want_grads)


def test_c4_keypoint_rcnn_detections_and_keypoints_equal_jax(c4_kp_runs):
    """The final boxes pooled again on res4: 56x56 heatmaps decoded."""
    want, got = c4_kp_runs["want"][0], c4_kp_runs["got"][0]
    assert_rows_match(got, want, "detection", close_detection(1))
    assert_keypoints_match(got, want, KP_ATOL)


# ---------------- the schedules ----------------
@pytest.fixture(scope="module")
def schedules_root(tmp_path_factory):
    """The keypoint fixture (synthetic_kp_*) and the COCO fixture
    (synthetic_coco_*, the cascade schedule's), removed afterwards."""
    root = tmp_path_factory.mktemp("keypoint_schedules")
    register_synthetic_keypoints(str(root / "fixture"))
    register_synthetic_coco(str(root / "fixture"))
    try:
        yield root
    finally:
        for name in ("synthetic_kp_train", "synthetic_kp_val", "synthetic_coco_train", "synthetic_coco_val"):
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)


@pytest.mark.parametrize("name, set_name, tasks, loss", [
    ("keypoint_rcnn_R_50_FPN_instant_test.yaml", "synthetic_kp_val", {"bbox", "keypoints"}, "loss_keypoint"),
    ("cascade_mask_rcnn_R_50_FPN_instant_test.yaml", "synthetic_coco_val", {"bbox", "segm"}, "loss_cls_stage2"),
], ids=["keypoint", "cascade"])
def test_the_instant_schedule_trains_and_evaluates(name, set_name, tasks, loss, schedules_root):
    """2 steps with the branch's loss in the metrics, model_final, the AP
    tables of the test set (keypoints by OKS); `--eval-only --resume` from
    the save gives the same AP dicts."""
    out = schedules_root / name
    results = run_schedule(name, out)
    again = run_schedule(name, out, eval_only=True)
    res = results[set_name]
    print(f"{name}: {res}")
    assert set(res) == tasks and all(np.isfinite(res[t]["AP"]) for t in tasks)
    np.testing.assert_equal(again, results)
    assert loss in (out / "metrics.json").read_text()


def _jax_batch(batch):
    return JaxDetBatch(*(None if f is None else jnp.asarray(f.numpy()) for f in batch[:7]),
                       gt_keypoints=jnp.asarray(batch.gt_keypoints.numpy()))


def test_keypoint_steps_in_lockstep_with_jax(schedules_root):
    """Three steps of keypoint_rcnn_training_acc_test.yaml (lr 0.01, norm
    clipping at 1.0; detectron2's pixel std, so that the filled tree sees
    inputs of unit scale) on the loader's first three batches: the port's
    `Trainer` from JAX's filled tree with JAX's draws replayed against JAX's
    `make_train_step` from the same tree; each step's losses rtol 1e-4 and
    the parameters after the third within 1e-5."""
    name = "keypoint_rcnn_training_acc_test.yaml"
    std = ["MODEL.PIXEL_STD", "[57.375, 57.12, 58.395]"]  # inputs of unit scale for the filled tree
    jcfg = torch_goldens.jax_cfg(name, *std)
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(QUICK / name))
    cfg.merge_from_list(std)
    with build_detection_train_loader(cfg, seed=0) as loader:
        batches = [next(loader) for _ in range(3)]
    assert batches[0].gt_keypoints.shape[2:] == (3, 3)
    model, ours = jax_build_model(jcfg), build_detector(cfg, device="cpu", training=True)
    params = filled(model, _jax_batch(batches[0]), seed=29, port=ours)
    optimizer = jax_build_optimizer(jcfg, params)
    state = TrainState.create(params, optimizer)
    step = make_train_step(model, optimizer, enable_caption=False, lr_schedule=jax_build_lr_schedule(jcfg),
                           donate=False)
    ours.load_state_dict(convert_jax_params(params), strict=True)
    trainer = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(cfg)), enable_caption=False)
    for i, batch in enumerate(batches):
        rng = jax.random.PRNGKey(40 + i)
        state, want = step(state, _jax_batch(batch), rng)
        got = trainer.train_step(batch, supervised_draw(rng))
        names = {k for k in want if k.startswith("loss_")}
        assert "loss_keypoint" in names and names <= set(got)
        for k in names:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=f"step {i} {k}")
    want_state = convert_jax_params(state.params)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_state[k].numpy(), rtol=0, atol=1e-5, err_msg=k)






@pytest.mark.slow
def test_the_keypoint_schedule_amplifies_a_float_difference(schedules_root):
    """Why the keypoint goldens depend on the float order (ROADMAP C): from
    JAX's initial tree, on the loader's batches, JAX's own train step from
    the tree with every leaf moved by one part in 1e7 parts from JAX's step
    by over 1e-3 (relative, in some loss) within three steps. The port's
    step from the unmoved tree parts from JAX's no faster: within 1e-4 at
    the first step (the forward's float order) and from the second on
    within 3 times what the moved tree's JAX step parts by."""
    name = "keypoint_rcnn_training_acc_test.yaml"
    jcfg = torch_goldens.jax_cfg(name)
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(QUICK / name))
    params, _ = jax_initial_tree(name)
    r = np.random.RandomState(0)
    bumped = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + 1e-7 * r.choice([-1, 1], np.shape(a)))).astype(np.float32), params)
    model = jax_build_model(jcfg)
    optimizer = jax_build_optimizer(jcfg, params)
    step = make_train_step(model, optimizer, enable_caption=False, lr_schedule=jax_build_lr_schedule(jcfg),
                           donate=False)
    states = [TrainState.create(params, optimizer), TrainState.create(bumped, optimizer)]
    ours = build_detector(cfg, device="cpu", training=True)
    ours.load_state_dict(convert_jax_params(params), strict=True)
    trainer = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(cfg)), enable_caption=False)
    key = jax.random.PRNGKey(12345)
    worst = []
    with build_detection_train_loader(cfg, seed=0) as loader:
        for it in range(3):
            batch = next(loader)
            rng = jax.random.fold_in(key, it)
            metrics = []
            for k in range(2):
                states[k], m = step(states[k], _jax_batch(batch), rng)
                metrics.append(m)
            got = trainer.train_step(batch, supervised_draw(rng))
            worst.append((_worst_loss(metrics[1], metrics[0])[0], _worst_loss(got, metrics[0])[0]))
            print(f"step {it + 1}: JAX against JAX from the moved tree {worst[-1][0]:.3g}, the port against JAX "
                  f"{worst[-1][1]:.3g}")
    assert worst[0][1] < 1e-4 and worst[-1][0] > 1e-3, worst
    assert all(port <= 3 * moved for moved, port in worst[1:]), worst


@contextlib.contextmanager
def _jax_keypoint_sets(root):
    """The keypoint fixture at `root`/kp as JAX's synthetic_kp_{train,val},
    removed from JAX's catalogs afterwards."""
    from cddmsl_tpu.data import DatasetCatalog as JaxDatasetCatalog
    from cddmsl_tpu.data import MetadataCatalog as JaxMetadataCatalog
    from cddmsl_tpu.data.datasets.synthetic import register_synthetic_coco as jax_register_synthetic_coco

    jax_register_synthetic_coco(str(root / "kp"), prefix="synthetic_kp", with_keypoints=True)
    try:
        yield
    finally:
        for set_name in ("synthetic_kp_train", "synthetic_kp_val"):
            JaxDatasetCatalog.remove(set_name)
            JaxMetadataCatalog._registry.pop(set_name)




@pytest.mark.slow
def test_every_keypoint_schedule_step_equals_jax_from_jax_state(schedules_root):
    """The training golden's 300 steps by JAX's train step from JAX's
    initial tree, on JAX's loader with JAX's trainer's draws (~20 minutes).
    The port's loader gives the same 300 batches, bit for bit (flips
    included). Before each step the port's `Trainer` takes JAX's state (the
    parameters, the momentum and the count) and takes the same step; so
    does JAX's step from that state with every parameter moved by one part
    in 1e7 (the control: JAX's own float noise). Per step, each against
    JAX's step: the largest relative difference of a loss, and the update
    (the parameters after less before) apart from JAX's, relative to its
    size. The port departs no further than the control: at most 3 times
    its largest loss difference and update difference over the 300 steps,
    and at no more steps past 1e-4 (losses) or 1e-3 (update) than twice the
    control's and 10. A fault would stand out: an LR off at the drop at
    step 240 moves the update by 90%, a flip with the wrong keypoints moves
    loss_keypoint by its whole size, and such a step has no counterpart in
    the control. So no step of the schedule parts from JAX's beyond its
    float order: the goldens' miss is that order compounding over 300
    steps."""
    from cddmsl_tpu.data.build import build_detection_train_loader as jax_build_detection_train_loader

    name = "keypoint_rcnn_training_acc_test.yaml"
    jcfg = torch_goldens.jax_cfg(name)
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(QUICK / name))
    params, _ = jax_initial_tree(name)
    model = jax_build_model(jcfg)
    optimizer = jax_build_optimizer(jcfg, params)
    state = TrainState.create(params, optimizer)
    step = make_train_step(model, optimizer, enable_caption=False, lr_schedule=jax_build_lr_schedule(jcfg),
                           donate=False)
    ours = build_detector(cfg, device="cpu", training=True)
    trainer = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(cfg)), enable_caption=False)
    trainable = [(n, p) for n, p in ours.named_parameters() if p.requires_grad]
    key = jax.random.PRNGKey(max(cfg.SEED, 0) + 12345)
    r = np.random.RandomState(0)
    rows = []
    with _jax_keypoint_sets(schedules_root / "fixture"), build_detection_train_loader(
            cfg, seed=max(cfg.SEED, 0)) as loader, torch_goldens.torch_threads(torch_goldens.THREADS):
        jax_loader = jax_build_detection_train_loader(jcfg, seed=max(cfg.SEED, 0))
        for it in range(cfg.SOLVER.MAX_ITER):
            batch, want_batch = next(loader), next(jax_loader)
            for got_field, want_field in zip(_jax_batch(batch), want_batch):
                assert (got_field is None) == (want_field is None), it
                if got_field is not None:
                    np.testing.assert_array_equal(np.asarray(got_field), np.asarray(want_field), err_msg=str(it))
            moved = state.replace(params=jax.tree_util.tree_map(
                lambda a: (np.asarray(a) * (1 + 1e-7 * r.choice([-1, 1], np.shape(a)))).astype(np.float32),
                jax.device_get(state.params)))
            before = convert_jax_params(jax.device_get(state.params))
            ours.load_state_dict(before, strict=True)
            momentum = _momentum(state)
            for n, p in trainable:
                trainer.optimizer.sgd.state[p]["momentum_buffer"] = momentum[n].clone()
            trainer.optimizer.count = int(state.step)
            rng = jax.random.fold_in(key, it)
            moved_after, control = step(moved, want_batch, rng)
            state, want = step(state, want_batch, rng)
            got = trainer.train_step(batch, supervised_draw(rng))
            after = convert_jax_params(jax.device_get(state.params))
            names = [n for n, _ in trainable]
            port = {n: p.detach() for n, p in trainable}
            rows.append(dict(
                step=it + 1, loss=_worst_loss(got, want), update=_update_apart(
                    {n: before[n] for n in names}, {n: after[n] for n in names}, {n: before[n] for n in names}, port),
                control_loss=_worst_loss(control, want), control_update=_update_apart(
                    {n: before[n] for n in names}, {n: after[n] for n in names},
                    {n: v for n, v in convert_jax_params(jax.device_get(moved.params)).items() if n in port},
                    {n: v for n, v in convert_jax_params(jax.device_get(moved_after.params)).items() if n in port})))
            print(f"step {it + 1}: the port's losses rtol {rows[-1]['loss'][0]:.3g} ({rows[-1]['loss'][1]}), its "
                  f"update {rows[-1]['update']:.3g} apart; the control's {rows[-1]['control_loss'][0]:.3g} "
                  f"({rows[-1]['control_loss'][1]}), {rows[-1]['control_update']:.3g}")

    def summary(loss, update):
        past = [r["step"] for r in rows if r[loss][0] > 1e-4 or r[update] > 1e-3]
        return max(r[loss][0] for r in rows), max(r[update] for r in rows), past

    port, control = summary("loss", "update"), summary("control_loss", "control_update")
    print(f"over {len(rows)} steps, the port: losses rtol at most {port[0]:.3g}, the update at most {port[1]:.3g} "
          f"apart, {len(port[2])} steps past 1e-4 or 1e-3 {port[2]}; the control: {control[0]:.3g}, {control[1]:.3g}, "
          f"{len(control[2])} steps {control[2]}")
    assert len(rows) == 300
    assert port[0] <= 3 * control[0] and port[1] <= 3 * control[1], (port, control)
    assert len(port[2]) <= 2 * len(control[2]) + 10, (port, control)


@pytest.mark.slow
@pytest.mark.parametrize("scale", [0.0, 1e-7], ids=["as_pinned", "moved"])
def test_jax_own_keypoint_goldens_from_its_tree_and_from_a_moved_tree(scale, schedules_root, tmp_path):
    """JAX's own `DefaultTrainer` on keypoint_rcnn_training_acc_test.yaml
    (~3.5 minutes each): from its initial tree it meets both goldens; from
    the tree with every leaf moved by one part in 1e7 (signs from
    RandomState(0)) it misses them, as the port's run from the unmoved tree
    does: the goldens pin one float order of JAX's run. JAX's final tree
    through the port's `test()` gives JAX's own results (1e-9): the port's
    inference and evaluation are not what misses."""
    from cddmsl_torch.engine.defaults import DefaultTrainer
    from cddmsl_tpu.engine.defaults import DefaultTrainer as JaxDefaultTrainer
    from cddmsl_tpu.evaluation import verify_results as jax_verify_results

    name = "keypoint_rcnn_training_acc_test.yaml"
    with _jax_keypoint_sets(schedules_root / "fixture"):
        cfg = torch_goldens.jax_cfg(name, "OUTPUT_DIR", str(tmp_path / "out"), "TEST.EXPECTED_RESULTS", "[]")
        trainer = JaxDefaultTrainer(cfg)
        trainer.resume_or_load(resume=False)
        r = np.random.RandomState(0)
        trainer.state = trainer.state.replace(params=jax.tree_util.tree_map(
            lambda a: (np.asarray(a) * (1 + scale * r.choice([-1, 1], np.shape(a)))).astype(np.asarray(a).dtype),
            jax.device_get(trainer.state.params)))
        results = trainer.train()["synthetic_kp_val"]
    print(f"JAX from the tree moved by {scale:g}: bbox {results['bbox']}, keypoints {results['keypoints']}")
    assert jax_verify_results(torch_goldens.jax_cfg(name), results) == (scale == 0.0), results
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(QUICK / name))
    cfg.merge_from_list(["OUTPUT_DIR", str(tmp_path / "port")])
    ours = DefaultTrainer(cfg, device="cpu")
    ours.model.load_state_dict(convert_jax_params(jax.device_get(trainer.state.params)), strict=True)
    port = ours.test()["synthetic_kp_val"]
    for task, metrics in results.items():
        np.testing.assert_allclose([port[task][k] for k in metrics], list(metrics.values()), rtol=1e-9, err_msg=task)


@pytest.mark.slow
def test_the_keypoint_goldens_from_jax_initial_tree_and_draws(schedules_root):
    """keypoint_rcnn_training_acc_test.yaml (300 steps of the FPN Keypoint
    R-CNN at depth 10 on the keypoint fixture) from JAX's initial tree with
    JAX's draws replayed, then keypoint_rcnn_inference_acc_test.yaml
    `--eval-only` from its model_final, each against the schedule's own
    TEST.EXPECTED_RESULTS (bbox AP50 16.832 and keypoints AP 13.465, 0.05).
    It misses (ROADMAP C): the schedule's first steps amplify a float
    difference as JAX's own step does (the test above)."""
    training, inference = "keypoint_rcnn_training_acc_test.yaml", "keypoint_rcnn_inference_acc_test.yaml"
    default, _ = replaying_trainers(*jax_initial_tree(training), draw_of_step=supervised_draw)
    out = schedules_root / "goldens"
    mp = pytest.MonkeyPatch()
    mp.setattr(train_net, "DefaultTrainer", default)
    try:
        results = run_schedule(training, out / training)["synthetic_kp_val"]
    finally:
        mp.undo()
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(QUICK / training))
    print(f"keypoint training golden at {torch_goldens.THREADS} threads: bbox {results['bbox']}, "
          f"keypoints {results['keypoints']}")
    assert verify_results(cfg, results), results
    weights = torch_goldens.quick_schedules_weights(
        "quick_schedules://keypoint_rcnn_training_acc_test.yaml/model_final", out)
    again = run_schedule(inference, out / inference, "MODEL.WEIGHTS", weights, eval_only=True)["synthetic_kp_val"]
    cfg_inf = get_cfg()
    add_ateacher_config(cfg_inf)
    cfg_inf.merge_from_file(str(QUICK / inference))
    print(f"keypoint inference golden: bbox {again['bbox']}, keypoints {again['keypoints']}")
    assert verify_results(cfg_inf, again), again


# ---------------- chip_smoke.py's phase 18 ----------------
def test_kernel_calls_are_what_a_keypoint_step_and_eval_batch_launch(monkeypatch):
    """Phase 18 checks K1, K3 and K4 at the calls that `KernelCalls` records
    (`recorded_kernel_calls` holds each against what the model got): an FPN
    Keypoint R-CNN step's box pool and keypoint pool per level, all with a
    gradient, the keypoint pool on the leading foreground rows (the quota
    int(32 * 0.25) of each image), and its RPN NMS; an eval batch's pools
    without a gradient, its RPN NMS and its detection NMS."""
    import chip_smoke
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    from cddmsl_torch.config import SolverConfig
    from test_torch_port_cascade import recorded_kernel_calls

    model = init_random_(FPNRCNN(**FPN_KP), torch.Generator().manual_seed(6))
    trainer = Trainer(model, build_optimizer(model, SolverConfig(warmup_iters=0)), enable_caption=False)
    tb = torch_batch(BATCH_A, gt_keypoints=torch.from_numpy(box_keypoints(BATCH_A)))
    draw = chip_smoke.site_draw("cpu")
    step = recorded_kernel_calls(monkeypatch, "step", lambda: trainer.train_step(tb, draw))
    assert len(step.pools) == 8 and step.k3 == [call for call, *_ in step.pools] and len(step.nms) == 1
    assert [size for *_, size, _ in step.pools] == [7] * 4 + [14] * 4
    assert all(batch_idx.shape[0] == 2 * 8 for _, _, batch_idx, *_ in step.pools[4:])
    test = recorded_kernel_calls(monkeypatch, "eval", lambda: model.inference(tb))
    assert len(test.pools) == 8 and test.k3 == [] and len(test.nms) == 2


def test_the_predictor_returns_no_keypoints_as_jax(schedules_root):
    """`DefaultPredictor` on the keypoint instant schedule's detector: boxes,
    scores and classes of the original image and no "keypoints", as JAX's
    predictor gives (cddmsl_tpu/engine/defaults.py `DefaultPredictor`)."""
    from cddmsl_torch.engine.defaults import DefaultPredictor

    cfg = get_cfg()
    cfg.merge_from_file(str(QUICK / "keypoint_rcnn_R_50_FPN_instant_test.yaml"))
    cfg.merge_from_list(["SEED", "3", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0"])
    predictor = DefaultPredictor(cfg, device="cpu")
    out = predictor((np.random.RandomState(4).rand(100, 140, 3) * 255).astype(np.uint8))
    assert set(out) == {"boxes", "scores", "classes"} and len(out["boxes"]) > 0
    assert predictor.model.roi_heads.keypoint_head is not None
