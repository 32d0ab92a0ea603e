"""The JAX package's R-CNN goldens through the port's `train_net` on the
CPU: configs/quick_schedules/rcnn_training_acc_test.yaml (100 iterations of
the tiny CLIP detector with the linear classifier, batch 8 over what JAX
ran as an 8-device mesh, then the final test checked against
TEST.EXPECTED_RESULTS: bbox AP50 7.211 +/- 0.1) and
rcnn_inference_acc_test.yaml (`--eval-only` from that run's model_final:
7.211 +/- 0.05). The training run starts from JAX's initial tree and
replays JAX's draws (tests/torch_goldens.py); the goldens and their
tolerances are the schedules' own, checked by the port's `verify_results`
(`train_net` raises or exits when they miss). Marked `slow`, outside
Tier-1: the training golden at other torch thread counts than the 2 that
the goldens run at. It holds at the host's 8 (with JAX's AP and AP75 as
well) and FAILS at 1 (AP50 6.6364): the thread count, and with it the
float order of the port's convolutions, is all that differs (ROADMAP.md
section C). `slow` as well: each of the 100 steps at 1 thread taken by the
port from JAX's state, beside JAX's own step from that state moved by 1e-7,
which shows that the 1-thread miss is the float order compounding, not a
fault.
"""

import jax
import numpy as np
import pytest
import torch

import torch_goldens
from cddmsl_torch import train_net
from cddmsl_torch.config import add_ateacher_config, get_cfg
from cddmsl_torch.evaluation import verify_results
from torch_goldens import QUICK, jax_initial_tree, quick_schedules_weights, replaying_trainers, run_schedule
from torch_goldens import schedules_fixture

TRAINING, INFERENCE = "rcnn_training_acc_test.yaml", "rcnn_inference_acc_test.yaml"


def _cfg(name):
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(QUICK / name))
    return cfg


@pytest.fixture(scope="module")
def out_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("rcnn_goldens")
    with schedules_fixture(root / "fixture"):
        yield root / "out"


@pytest.fixture(scope="module")
def training(out_root):
    default, _ = replaying_trainers(*jax_initial_tree(TRAINING))
    mp = pytest.MonkeyPatch()
    mp.setattr(train_net, "DefaultTrainer", default)
    try:
        return run_schedule(TRAINING, out_root / TRAINING)
    finally:
        mp.undo()


def test_rcnn_training_golden(training, out_root):
    cfg = _cfg(TRAINING)
    assert [list(r) for r in cfg.TEST.EXPECTED_RESULTS] == [["bbox", "AP50", 7.211, 0.1]]
    (name, results), = training.items()
    print(f"{torch_goldens.THREADS} torch threads: {results['bbox']}")
    assert name == "synthetic_voc_test"
    assert verify_results(cfg, results), results["bbox"]
    assert np.isfinite(results["bbox"]["AP"]) and (out_root / TRAINING / "model_final.pth").exists()


def test_rcnn_inference_golden_from_the_training_save(training, out_root):
    cfg = _cfg(INFERENCE)
    assert [list(r) for r in cfg.TEST.EXPECTED_RESULTS] == [["bbox", "AP50", 7.211, 0.05]]
    weights = quick_schedules_weights(cfg.MODEL.WEIGHTS, out_root)
    results = run_schedule(INFERENCE, out_root / INFERENCE, "MODEL.WEIGHTS", weights, eval_only=True)
    assert verify_results(cfg, results["synthetic_voc_test"])
    assert results["synthetic_voc_test"]["bbox"]["AP50"] == training["synthetic_voc_test"]["bbox"]["AP50"]


@pytest.mark.slow
@pytest.mark.parametrize("threads", [1, None], ids=["1_thread", "host_threads"])
def test_rcnn_training_golden_at_other_thread_counts(threads, tmp_path, monkeypatch):
    """The training golden at 1 torch thread and at the host's default
    count (~120 s each). It fails at 1 thread (module docstring)."""
    monkeypatch.setattr(torch_goldens, "THREADS", threads or torch.get_num_threads())
    monkeypatch.setattr(train_net, "DefaultTrainer", replaying_trainers(*jax_initial_tree(TRAINING))[0])
    with schedules_fixture(tmp_path / "fixture"):
        results = run_schedule(TRAINING, tmp_path / "out")["synthetic_voc_test"]
    print(f"{torch_goldens.THREADS} torch threads: {results['bbox']}")
    assert verify_results(_cfg(TRAINING), results)


def training_proposals_apart(jax_props, port_props):
    """An `explain` for `torch_goldens.schedule_lockstep`: JAX's training
    proposals (`jax_props(model, params, jax_batch, k_rpn)`; the proposals
    do not depend on the key) beside the port's (`port_props(ours, batch)`)
    from the same weights, per image: (the valid rows equal, the rows'
    boxes the same set within 1e-3 px, how many rows differ by place, the
    largest gap between the two frameworks' scores at those places)."""
    def explain(it, model, params, jb, rng, ours, batch):
        want = jax_props(model, params, jb, jax.random.split(rng, 3)[0])
        with torch.no_grad():
            got = port_props(ours, batch)
        out = []
        for i in range(got.boxes.shape[0]):
            gv, wv = got.valid[i].numpy(), np.asarray(want.valid[i])
            gb, wb = got.boxes[i].numpy()[gv], np.asarray(want.boxes[i])[wv]
            gs, ws = got.scores[i].numpy()[gv], np.asarray(want.scores[i])[wv]
            same_set = gb.shape == wb.shape and all(np.abs(wb - b).max(1).min() <= 1e-3 for b in gb)
            moved = np.abs(gb - wb).max(1) > 1e-3 if gb.shape == wb.shape else np.ones(len(gb), bool)
            gap = float(np.abs(gs[moved] - ws[moved]).max()) if moved.any() else 0.0
            out.append((bool((gv == wv).all()), same_set, int(moved.sum()), gap))
        return out

    return explain


def assert_departures_are_ties(rows, max_gap=1e-5):
    """Every step past the control's bounds (`schedule_lockstep`'s
    "explained") is a float tie: either of the training proposals' ranking
    (the same valid rows, and where the two frameworks' rows differ their
    scores lie within `max_gap`: near-equal candidates trading places, or
    crossing the top-k cut or an NMS decision), or one that JAX's own float
    noise tips as well (its step from the moved state departs there past
    1e-4 too). The other steps stay within 3 times the control's largest
    differences. Returns the tied steps."""
    ties = [row["step"] for row in rows if "explained" in row]
    for row in rows:
        if "explained" in row and row["control_loss"][0] <= 1e-4:
            images = row["explained"]
            assert all(valid for valid, _, _, _ in images), row
            assert any(n for _, _, n, _ in images) and max(gap for _, _, _, gap in images) <= max_gap, row
    rest = [row for row in rows if "explained" not in row]
    port, control = torch_goldens.lockstep_summary(rest)[0], torch_goldens.lockstep_summary(rows)[1]
    print(f"over {len(rows)} steps: {len(ties)} float ties {ties}; the other steps' losses rtol at most "
          f"{port[0]:.3g}, the update at most {port[1]:.3g} apart; the control: {control[0]:.3g}, {control[1]:.3g}")
    assert port[0] <= 3 * control[0] and port[1] <= 3 * control[1], (port, control)
    return ties


@pytest.mark.slow
def test_every_rcnn_schedule_step_at_1_thread_equals_jax_from_jax_state(tmp_path):
    """The training golden's 100 steps, each taken by the port at 1 torch
    thread (where the golden misses) from JAX's state beside JAX's own
    step from that state moved by 1e-7 (`torch_goldens.schedule_lockstep`:
    JAX's loader and draws on one device, the port's loader's batches equal
    to JAX's). A step where the port departs past 1e-4 (a loss) or 1e-3
    (the update) and past 10 times the control must be a float tie
    (`assert_departures_are_ties`): the port's training proposals are
    JAX's set, two of them trading places whose scores lie within 1e-5 (an
    ulp or a few of the RPN's logits); the sampler keys by place, so
    another negative is drawn: loss_cls moves, loss_box_reg does not. Every
    other step departs no further than 3 times the control. (Run once: step
    74 is such a tie, image 6's rows scored 1.43e-6 apart; the rest within
    the control.)"""
    from cddmsl_tpu.data import DatasetCatalog as JaxDatasetCatalog
    from cddmsl_tpu.data.datasets.synthetic import register_synthetic_quick as jax_register_synthetic_quick

    def jax_props(model, params, jb, k_rpn):
        def rpn(m, b):
            return m.proposal_generator(m.backbone(m._normalize(b.image))["res4"], b.image_sizes, training=True,
                                        gt_boxes=b.gt_boxes, gt_valid=b.gt_valid, rng=k_rpn)[0]

        return jax.jit(lambda p, b: model.apply(p, b, method=rpn))(params, jb)

    def port_props(ours, batch):
        rpn = ours.proposal_generator
        return rpn._predict_proposals(*rpn._head(ours._res4(ours._normalize(batch.image))), batch.image_sizes, True)

    prefix = "port_rcnn_lockstep"
    jax_register_synthetic_quick(str(tmp_path / "jax_fixture"), prefix=prefix)
    try:
        with schedules_fixture(tmp_path / "fixture"):
            rows = torch_goldens.schedule_lockstep(TRAINING, f"{prefix}_trainval", torch_goldens.step_draw, threads=1,
                                                   explain=training_proposals_apart(jax_props, port_props))
    finally:
        for suffix in ("trainval", "trainval_plain", "test"):
            JaxDatasetCatalog.remove(f"{prefix}_{suffix}")
    assert len(rows) == 100
    assert_departures_are_ties(rows)
