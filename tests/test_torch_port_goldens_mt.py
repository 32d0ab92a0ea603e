"""The JAX package's mean-teacher golden through the port's `train_net` on
the CPU: configs/quick_schedules/mt_rcnn_training_acc_test.yaml (the tiny
CLIP detector with the linear classifier, 4 labeled + 4 unlabeled images a
step over what JAX ran as a 4-device mesh, TPU.MESH_SHAPE [4] in one
process), from JAX's initial tree with JAX's draws replayed
(tests/torch_goldens.py).

In Tier-1: the schedule with its burn-up moved to 3 and 8 iterations (so
the teacher's pseudo-labels, the discriminator and the EMA run from step 4)
against JAX's own mean-teacher step on its 4-device mesh from the same tree
and draws: each step's losses within rtol 1e-4, and after the 8 steps the
student, the teacher and the discriminator within 1e-6 (the convolutions
sum in another order: 2.4e-7 apart here).

Marked `slow`, outside Tier-1: the 80-iteration schedule's goldens (AP50
4.149 +/- 0.1, EXPECTED_PSEUDO [23, 0.0435, 0.02]) through the port, which
FAILS (AP50 2.2024 at the goldens' 2 torch threads); JAX's own step from
its initial tree built under `jax.jit` (1 ulp from the eager tree in three
leaves) and JAX's own trainer at MESH_SHAPE [1] (the same global batch on
one device), which both miss the same golden; and the 80 steps in lockstep
with JAX's trainer at MESH_SHAPE [4], which finds the step at which the two
runs part and the decision that tips there: the golden holds only for the
float order of JAX's 4-device mesh from the eager tree (ROADMAP.md
section C).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cddmsl_tpu.data import DatasetCatalog as JaxDatasetCatalog
from cddmsl_tpu.data import build_semisup_train_loader_two_crops as jax_two_crop_loader
from cddmsl_tpu.data.datasets.synthetic import register_synthetic_quick as jax_register_synthetic_quick
from cddmsl_tpu.engine.defaults import _init_batch
from cddmsl_tpu.engine import mean_teacher as jax_mt
from cddmsl_tpu.engine.mean_teacher import MeanTeacherTrainer as JaxMeanTeacherTrainer
from cddmsl_tpu.engine.train_loop import split_batch_stats
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.parallel import replicate, shard_batch
from cddmsl_tpu.parallel.mesh import mesh_from_cfg
from cddmsl_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.convert_jax import _DISCRIMINATOR_RULES, _convert, convert_jax_params
from cddmsl_torch.config import add_ateacher_config, get_cfg
from cddmsl_torch.engine import mean_teacher
from cddmsl_torch.engine.defaults import default_argument_parser
from cddmsl_torch.evaluation import verify_results
from cddmsl_torch.models.sampling import subsample_labels
from cddmsl_torch.structures import boxes as box_ops
from torch_goldens import NAMES, QUICK, THREADS, jax_cfg, jax_initial_tree, replaying_trainers, run_schedule
from torch_goldens import schedules_fixture, supervised_draw, torch_threads

NAME = "mt_rcnn_training_acc_test.yaml"
STEPS = 8
JAX_PREFIX = "port_goldens_mt"
PARITY = ("SEMISUPNET.BURN_UP_STEP", "3", "SOLVER.MAX_ITER", str(STEPS), "TEST.EXPECTED_RESULTS", "[]",
          "SEMISUPNET.EXPECTED_PSEUDO", "[]")


def _recording(cls, runs):
    class Recording(cls):
        def __init__(self, cfg, device="cuda"):
            super().__init__(cfg, device)
            self.step_metrics = []
            runs.append(self)

        def run_step(self, batch):
            metrics = super().run_step(batch)
            self.step_metrics.append({k: float(v) for k, v in metrics.items()})
            return metrics

    return Recording


def _jax_step_only_trainer(cfg, params, dis):
    """JAX's MeanTeacherTrainer with the parts its `_make_step` reads, as its
    __init__ assembles them (mesh, model, optimizer, discriminator and its
    SGD) and its MTState on `params` and `dis` (zero momenta, step 0, as
    __init__ makes them); without the structure-only initialisation that
    __init__ traces and the caller would replace, nor the test machinery."""
    jtr = object.__new__(JaxMeanTeacherTrainer)
    jtr.cfg, jtr.model, jtr.mesh = cfg, jax_build_model(cfg), mesh_from_cfg(cfg)
    jtr.optimizer = jax_build_optimizer(cfg, split_batch_stats(params)[0])
    jtr.discriminator = jax_mt.FCDiscriminator(dtype=jnp.float32)
    jtr.dis_optimizer = optax.sgd(jax_build_lr_schedule(cfg), momentum=cfg.SOLVER.MOMENTUM)
    jtr.mt_state = jax_mt.MTState(step=jnp.zeros((), jnp.int32), params=params, teacher_params=params,
                                  dis_params=dis, opt_state=jtr.optimizer.init(split_batch_stats(params)[0]),
                                  dis_opt_state=jtr.dis_optimizer.init(dis))
    jtr.mt_step = jtr._make_step()
    return jtr


class _JaxRun:
    """JAX's mean-teacher trainer on the schedule's 4-device mesh, its state
    set to the tree, advanced one step of its own jitted step at a time;
    a context manager. `step_only` builds only what the step reads
    (`_jax_step_only_trainer`), for runs that use nothing else of it."""

    def __init__(self, params, dis, root, *opts, step_only=False):
        # names of its own: JAX's metadata catalog keeps a name's directory for
        # the process, and other tests register the schedules' names elsewhere
        jax_register_synthetic_quick(str(root / "jax_fixture"), prefix=JAX_PREFIX)
        cfg = jax_cfg(NAME, *opts, "TPU.FAST_INIT", "True", "OUTPUT_DIR", str(root / "jax"), "DATASETS.TRAIN",
                      f"('{JAX_PREFIX}_trainval_plain',)", "DATASETS.TEST", f"('{JAX_PREFIX}_test',)")
        self.trainer = _jax_step_only_trainer(cfg, params, dis) if step_only else JaxMeanTeacherTrainer(cfg)
        assert dict(self.trainer.mesh.shape) == {"data": 4}
        state = self.trainer.mt_state.replace(params=params, teacher_params=jax.tree_util.tree_map(np.copy, params),
                                              dis_params=dis)
        self.state = replicate(state, self.trainer.mesh)
        self.loader = jax_two_crop_loader(cfg, seed=0)
        self.rng = jax.random.PRNGKey(max(cfg.SEED, 0) + 999)
        self.iteration = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for name in NAMES:
            JaxDatasetCatalog.remove(name.replace("synthetic_voc", JAX_PREFIX))

    def step(self):
        """One step: its metrics as floats."""
        mesh = self.trainer.mesh
        (ls, lw), (us, uw) = next(self.loader)
        with jax.sharding.set_mesh(mesh):
            batches = [shard_batch(b, mesh) for b in (ls, lw, us, uw)]
            self.state, m = self.trainer.mt_step(self.state, *batches, jax.random.fold_in(self.rng, self.iteration))
        self.iteration += 1
        return {k: float(v) for k, v in jax.device_get(m).items()}

    def host_state(self):
        return jax.device_get(self.state)


def _jax_steps(params, dis, root):
    """`STEPS` of JAX's steps on the parity schedule: (metrics of each step,
    the final MTState)."""
    with _JaxRun(params, dis, root, *PARITY, step_only=True) as run:
        return [run.step() for _ in range(STEPS)], run.host_state()


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    root = tmp_path_factory.mktemp("mt_goldens")
    params, dis = jax_initial_tree(NAME, *PARITY)
    want_metrics, want = _jax_steps(params, dis, root)
    runs = []
    mp = pytest.MonkeyPatch()
    mp.setattr(mean_teacher, "MeanTeacherTrainer", _recording(replaying_trainers(params, dis)[1], runs))
    try:
        with schedules_fixture(root / "fixture"):
            results = run_schedule(NAME, root / "out", *PARITY)
    finally:
        mp.undo()
    return dict(trainer=runs[0], results=results, want_metrics=want_metrics, want=want, params=params)


def test_mt_schedule_steps_equal_jax_at_mesh_4(parity):
    trainer, want_metrics = parity["trainer"], parity["want_metrics"]
    assert trainer.state.iteration == STEPS and len(trainer.step_metrics) == STEPS
    for it, (got, want) in enumerate(zip(trainer.step_metrics, want_metrics)):
        assert got.keys() == want.keys(), it
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=f"step {it} {k}")
        past = it > 3
        assert (got["loss_cls_pseudo"] > 0) == past and (got["loss_D"] > 0) == past, it


def test_mt_schedule_state_equals_jax_after_8_steps(parity):
    trainer, want = parity["trainer"], parity["want"]
    pairs = [(trainer.model.state_dict(), convert_jax_params(want.params)),
             (trainer.teacher.state_dict(), convert_jax_params(want.teacher_params)),
             (trainer.discriminator.state_dict(), _convert(want.dis_params, _DISCRIMINATOR_RULES, "discriminator"))]
    for got, w in pairs:
        assert got.keys() == w.keys()
        for name, value in w.items():
            torch.testing.assert_close(got[name], value, rtol=0, atol=1e-6, msg=name)
    start = convert_jax_params(parity["params"])
    assert not torch.equal(trainer.model.roi_heads.box_predictor.cls_score.weight,
                           start["roi_heads.box_predictor.cls_score.weight"])  # the linear classifier trains


def test_mt_schedule_ends_in_the_teachers_test(parity):
    (name, results), = parity["results"].items()
    assert name == "synthetic_voc_test" and np.isfinite(results["bbox"]["AP50"])


@pytest.mark.slow
def test_mt_training_golden(tmp_path, monkeypatch):
    """The schedule as pinned: 80 iterations (~75 s), then the teacher's
    AP50 and the pseudo-label golden (`train_net` raises when either
    misses). It fails today (module docstring)."""
    params, dis = jax_initial_tree(NAME)
    monkeypatch.setattr(mean_teacher, "MeanTeacherTrainer", replaying_trainers(params, dis)[1])
    with schedules_fixture(tmp_path / "fixture"):
        results = run_schedule(NAME, tmp_path / "out")
    assert results["synthetic_voc_test"]["bbox"]["AP50"] == pytest.approx(4.149, abs=0.1)


@pytest.mark.slow
def test_jax_misses_the_mt_golden_on_one_device(tmp_path):
    """JAX's own trainer on the schedule at MESH_SHAPE [1]: the same global
    batch, the float order of one device. Its teacher's AP50 lies outside
    the golden's tolerance (~7 minutes on the CPU)."""
    jax_register_synthetic_quick(str(tmp_path / "fixture"), prefix=JAX_PREFIX)
    try:
        cfg = jax_cfg(NAME, "TPU.MESH_SHAPE", "[1]", "OUTPUT_DIR", str(tmp_path / "out"), "TEST.EXPECTED_RESULTS", "[]",
                      "SEMISUPNET.EXPECTED_PSEUDO", "[]", "DATASETS.TRAIN", f"('{JAX_PREFIX}_trainval_plain',)",
                      "DATASETS.TEST", f"('{JAX_PREFIX}_test',)")
        trainer = JaxMeanTeacherTrainer(cfg)
        trainer.resume_or_load(resume=False)
        ap50 = trainer.train()[f"{JAX_PREFIX}_test"]["bbox"]["AP50"]
        print(f"JAX at MESH_SHAPE [1]: AP50 {ap50:.4f}, pseudo-labels {trainer.pseudo_label_stats()}")
    finally:
        for name in NAMES:
            JaxDatasetCatalog.remove(name.replace("synthetic_voc", JAX_PREFIX))
    assert abs(ap50 - 4.149) > 0.1


@pytest.mark.slow
def test_jax_misses_the_mt_golden_from_its_jitted_init(tmp_path):
    """JAX's own mean-teacher step at MESH_SHAPE [4] for the schedule's 80
    steps from the initial tree that `jax.jit` of JAX's init gives: three
    leaves round 1 ulp from the eager tree that JAX's trainer starts from,
    and its teacher's AP50 lies outside the golden's tolerance (~6
    minutes). The eager tree, in `_JaxRun` as in JAX's trainer, gives the
    golden (`test_mt_schedule_parts_from_jax_at_a_float_order_tie`)."""
    opts = ("TEST.EXPECTED_RESULTS", "[]", "SEMISUPNET.EXPECTED_PSEUDO", "[]")
    eager, dis = jax_initial_tree(NAME, *opts)
    cfg = jax_cfg(NAME, *opts)
    model = jax_build_model(cfg)
    init = jax.jit(lambda r: model.init({"params": r}, _init_batch(cfg), r, method=model.init_all))
    jitted = jax.device_get(init(jax.random.PRNGKey(max(cfg.SEED, 0))))
    apart = {jax.tree_util.keystr(k): float(np.abs(np.asarray(v) - np.asarray(w)).max())
             for (k, v), w in zip(jax.tree_util.tree_flatten_with_path(eager)[0], jax.tree_util.tree_leaves(jitted))}
    apart = {k: v for k, v in apart.items() if v > 0}
    with _JaxRun(jitted, dis, tmp_path, *opts) as run:
        for _ in range(cfg.SOLVER.MAX_ITER):
            run.step()
        state = run.host_state()
        results = run.trainer.test(run.trainer.cfg, state.replace(params=state.teacher_params))
        run.trainer.mt_state = state
        pseudo = run.trainer.pseudo_label_stats()
    ap50 = results[f"{JAX_PREFIX}_test"]["bbox"]["AP50"]
    print(f"the jitted tree apart from the eager one: {apart}; JAX's teacher from it: AP50 {ap50:.4f}, "
          f"pseudo-labels {pseudo}")
    assert 0 < len(apart) <= 3 and max(apart.values()) < 1e-7
    assert abs(ap50 - 4.149) > 0.1


# ---------------- where the port's run parts from JAX's ----------------
SAME_BOX_PX = 0.5  # two box sets are the same set where no box moved further


@torch.no_grad()
def _decisions(model, batch, draw):
    """The discrete decisions of `model`'s supervised losses on `batch`, as
    the port makes them: the RPN's sampled positive anchors and the
    residuals of their L1 box loss (SMOOTH_L1_BETA 0: the gradient is the
    residual's sign), the training proposals, the RoI heads' samples and
    the residuals of their L1 box loss on the foreground rows."""
    rpn, rh = model.proposal_generator, model.roi_heads
    features = model.extract_res4(batch.image)
    anchors, logits, deltas = rpn._head(features)
    b, n = logits.shape
    matched, labels = rpn.matcher(box_ops.pairwise_iou(batch.gt_boxes, anchors.expand(b, -1, -1)), batch.gt_valid)
    pos, _ = subsample_labels(labels == 1, labels == 0, rpn.batch_size_per_image, rpn.positive_fraction,
                              draw("rpn_pos", (b, n)), draw("rpn_neg", (b, n)))
    gt = torch.gather(batch.gt_boxes, 1, matched[..., None].expand(-1, -1, 4))
    rpn_resid = (deltas - rpn.box2box.get_deltas(anchors.expand(b, -1, -1), gt))[pos]
    proposals = rpn._predict_proposals(anchors, logits, deltas, batch.image_sizes, True)
    boxes, classes, matched_gt, valid = rh.label_and_sample_proposals(
        proposals, batch.gt_boxes, batch.gt_classes, batch.gt_valid, draw)
    _, box_deltas = rh.box_predictor(rh._region_embed(features, boxes, model.backbone.res5_forward, model._box_pool))
    k, rows = rh.num_classes, boxes.shape[0] * boxes.shape[1]
    classes, valid = classes.reshape(rows), valid.reshape(rows)
    fg = valid & (classes < k)
    if box_deltas.shape[1] != 4:
        box_deltas = box_deltas.reshape(rows, k, 4)[torch.arange(rows), classes.clamp(max=k - 1)]
    roi_resid = (box_deltas - rh.box2box.get_deltas(boxes.reshape(rows, 4), matched_gt.reshape(rows, 4)))[fg]
    return dict(rpn_pos=pos, rpn_resid=rpn_resid, proposals=proposals, boxes=boxes, classes=classes, valid=valid,
                roi_resid=roi_resid)


@torch.no_grad()
def _pseudo_labels(trainer, teacher, unlabel_w):
    """The teacher's pseudo-labels on the weak view (`_pseudo_label`'s
    boxes, classes and kept rows) and the scores of its detections."""
    det = teacher.inference(unlabel_w, do_postprocess=False)
    g = trainer.cfg.TPU.MAX_GT_BOXES
    keep = det.valid & (det.scores > trainer.bbox_threshold)
    return det.boxes[:, :g], det.classes[:, :g], keep[:, :g], det.scores[:, :g][det.valid[:, :g]]


def _tipped(a, j):
    """The decisions of two states that differ, {name: what differs}: the
    sign flips of an L1 residual carry both residuals."""
    out = {}
    if not torch.equal(a["rpn_pos"], j["rpn_pos"]):
        out["rpn anchors"] = "other positives"
    elif (flip := torch.sign(a["rpn_resid"]) != torch.sign(j["rpn_resid"])).any():
        out["rpn L1 sign"] = list(zip(a["rpn_resid"][flip].tolist(), j["rpn_resid"][flip].tolist()))
    pa, pj = a["proposals"], j["proposals"]
    if not torch.equal(pa.valid, pj.valid) or float((pa.boxes - pj.boxes).abs().max()) > SAME_BOX_PX:
        out["proposals"] = float((pa.boxes - pj.boxes).abs().max())
    if not (torch.equal(a["classes"], j["classes"]) and torch.equal(a["valid"], j["valid"])) or \
            float((a["boxes"] - j["boxes"]).abs().max()) > SAME_BOX_PX:
        out["roi samples"] = float((a["boxes"] - j["boxes"]).abs().max())
    elif (flip := torch.sign(a["roi_resid"]) != torch.sign(j["roi_resid"])).any():
        out["roi L1 sign"] = list(zip(a["roi_resid"][flip].tolist(), j["roi_resid"][flip].tolist()))
    return out


@pytest.mark.slow
def test_mt_schedule_parts_from_jax_at_a_float_order_tie(tmp_path):
    """The 80-iteration schedule through the port's trainer in lockstep with
    JAX's trainer at MESH_SHAPE [4], from the same tree and draws (~6
    minutes on the CPU). Before each step, the decisions the step makes
    (`_decisions`, and past the burn-up the teacher's pseudo-labels) are
    taken on the port's state and on JAX's state, both by the port's code;
    after it, the largest difference of the student, the teacher and the
    discriminator. Prints the table. Until the first step at which a
    decision differs, every loss is within rtol 1e-4 and the student within
    1e-5 of JAX's (the float order of the convolutions); the first decision
    that differs is the sign of an L1 box residual that lies within 1e-4 of
    zero on both states, a tie that the float order breaks either way; from
    there the runs part. JAX's final teacher, loaded into the port, meets
    the schedule's goldens through the port's test and pseudo-label count:
    the port's evaluation is not what misses."""
    opts = ("TEST.EXPECTED_RESULTS", "[]", "SEMISUPNET.EXPECTED_PSEUDO", "[]")
    params, dis = jax_initial_tree(NAME, *opts)
    _, mt_cls = replaying_trainers(params, dis)
    rows = []
    with _JaxRun(params, dis, tmp_path, *opts) as run, schedules_fixture(tmp_path / "fixture"), \
            torch_threads(THREADS):
        args = default_argument_parser().parse_args(
            ["--device", "cpu", "--config-file", str(QUICK / NAME), "OUTPUT_DIR", str(tmp_path / "out"), *opts])
        trainer = mt_cls(train_net.setup(args), device="cpu")
        trainer.resume_or_load(resume=False)
        as_jax = copy.deepcopy(trainer.model), copy.deepcopy(trainer.teacher)
        burn_up, steps = trainer.cfg.SEMISUPNET.BURN_UP_STEP, trainer.cfg.SOLVER.MAX_ITER
        loader = trainer.build_train_loader()
        try:
            for it in range(steps):
                batch = trainer.batch_to_device(next(loader))
                (label_s, _), (_, unlabel_w) = batch
                want = run.host_state()
                as_jax[0].load_state_dict(convert_jax_params(want.params))
                as_jax[1].load_state_dict(convert_jax_params(want.teacher_params))
                k_sup = jax.random.split(jax.random.fold_in(trainer._jax_key, it), 3)[0]
                tipped = _tipped(_decisions(trainer.model, label_s, supervised_draw(k_sup)),
                                 _decisions(as_jax[0], label_s, supervised_draw(k_sup)))
                if it > burn_up:
                    (_, ca, ka, sa), (_, cj, kj, _) = (_pseudo_labels(trainer, t, unlabel_w)
                                                        for t in (trainer.teacher, as_jax[1]))
                    if not (torch.equal(ka, kj) and torch.equal(ca[ka], cj[kj])):
                        tipped["pseudo-labels"] = (int(ka.sum()), int(kj.sum()))
                want_metrics = run.step()
                got_metrics = {k: float(v) for k, v in trainer.run_step(batch).items()}
                want = run.host_state()
                diffs = {}
                for tag, got, w in (
                        ("student", trainer.model.state_dict(), convert_jax_params(want.params)),
                        ("teacher", trainer.teacher.state_dict(), convert_jax_params(want.teacher_params)),
                        ("discriminator", trainer.discriminator.state_dict(),
                         _convert(want.dis_params, _DISCRIMINATOR_RULES, "discriminator"))):
                    diffs[tag] = max((float((got[k] - v).abs().max()), k) for k, v in w.items())
                loss_rel = max(abs(got_metrics[k] - v) / max(abs(v), 1e-12) for k, v in want_metrics.items())
                rows.append(dict(it=it, tipped=tipped, loss_rel=loss_rel, **diffs))
                print(f"step {it}: losses rtol {loss_rel:.3g}; student {diffs['student'][0]:.3g} "
                      f"({diffs['student'][1]}), teacher {diffs['teacher'][0]:.3g}, discriminator "
                      f"{diffs['discriminator'][0]:.3g}; decisions that differ: {tipped or 'none'}")
        finally:
            loader.close()
        own = trainer.test(model=trainer.teacher)["synthetic_voc_test"], trainer.pseudo_label_stats()
        trainer.teacher.load_state_dict(convert_jax_params(run.host_state().teacher_params))
        on_jax = trainer.test(model=trainer.teacher)["synthetic_voc_test"], trainer.pseudo_label_stats()
    for label, (results, (count, precision)) in (("the port's teacher", own), ("JAX's teacher", on_jax)):
        print(f"{label} through the port's test: AP50 {results['bbox']['AP50']:.4f}, {count} pseudo-labels at "
              f"precision {precision:.4f}")
    beyond = next((r["it"] for r in rows if r["student"][0] > 1e-6), None)
    first = next(r for r in rows if r["tipped"])
    print(f"the student first differs from JAX's by more than 1e-6 after step {beyond}; the first decision that "
          f"differs is at step {first['it']}: {first['tipped']}")
    for r in rows[:first["it"]]:
        assert r["loss_rel"] <= 1e-4 and r["student"][0] <= 1e-5, r
    assert set(first["tipped"]) <= {"rpn L1 sign", "roi L1 sign"}, first
    assert all(abs(x) < 1e-4 for pairs in first["tipped"].values() for pair in pairs for x in pair), first
    assert rows[-1]["student"][0] > 1e-3  # the runs part
    # JAX's own final teacher meets both goldens through the port's test
    golden = get_cfg()
    add_ateacher_config(golden)
    golden.merge_from_file(str(QUICK / NAME))
    want_count, want_precision, tol = golden.SEMISUPNET.EXPECTED_PSEUDO
    assert verify_results(golden, on_jax[0]), on_jax[0]["bbox"]
    assert on_jax[1][0] == want_count and abs(on_jax[1][1] - want_precision) <= tol, on_jax[1]
