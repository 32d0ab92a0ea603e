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
section C).
"""

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
