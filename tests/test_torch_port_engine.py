"""The port's training loop against cddmsl_tpu on the CPU: gradient
accumulation, checkpoint resume, the trainer end to end and the CLI.

- ACCUM_STEPS=2: one step of `Trainer` on a 2x64x96 batch against
  `make_train_step(accum_steps=2)` with the same weights and JAX's draws
  replayed per microbatch (JAX splits its key into one per microbatch):
  parameters to 1e-6 (the module's one JAX compile).
- The loss-set switches (`kd_regularization`, `enable_caption`) return
  JAX's loss names (JAX traced with `eval_shape`, not compiled).
- Resume: 4 steps straight equal 2 steps, a checkpoint, a new trainer
  resumed from it, 2 steps, bit for bit.
- The tiny `DefaultTrainer` trains, saves, evaluates and resumes on the
  synthetic VOC fixture (the CPU counterpart of the slow
  tests/test_trainer_integration.py), and `python -m
  cddmsl_torch.train_net --device cpu` runs in a subprocess.

Every catalog name a test registers is removed again.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg, _synthetic_batch
from cddmsl_tpu.engine import TrainState, make_train_step
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_torch.checkpoint.checkpointer import DetectionCheckpointer
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.config import flagship_config, flagship_solver_config, get_cfg
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_train_loader
from cddmsl_torch.data.datasets.synthetic import register_synthetic_quick
from cddmsl_torch.engine.defaults import DefaultPredictor, DefaultTrainer
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.models.build import build_model
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_backbone import fill_params, jax_param_shapes
from test_torch_port_train import _jax_draws, _replay, _torch_batch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY_RECIPE = REPO / "cddmsl_torch" / "configs" / "voc_tiny.yaml"
B, H, W, G = 2, 64, 96, 8


# ---------------- the step's options ----------------
@pytest.fixture(scope="module")
def tiny_jax():
    cfg = _flagship_cfg(tiny=True)
    model = jax_build_model(cfg)
    jb = _synthetic_batch(B, H, W, g=G, seed=0)
    return cfg, model, jb, fill_params(jax_param_shapes(flagship_config(tiny=True)), seed=5)


def _port_trainer(params, **kwargs):
    solver = flagship_solver_config(tiny=True)
    model = build_model(flagship_config(tiny=True), device="cpu", training=True)
    model.load_state_dict(convert_jax_params(params), strict=True)
    return Trainer(model, build_optimizer(model, solver), caption_burnup_iters=solver.caption_burnup_iters, **kwargs)


def _replay_per_microbatch(draws):
    """One `Draw` for a step of len(draws) microbatches: the step asks each
    site once for the rows of the whole batch and hands microbatch k its
    rows, which replay JAX's microbatch k (each JAX microbatch draws with a
    key of its own)."""

    def draw(site, shape):
        rows = (shape[0] // len(draws),) + tuple(shape[1:])
        return torch.cat([d(site, rows) for d in draws])

    return draw


def test_accum_steps_2_equals_jax(tiny_jax):
    cfg, model, jb, params = tiny_jax
    burnup = cfg.SOLVER.CAPTION_BURNUP_ITERS
    optimizer = jax_build_optimizer(cfg, params)
    state = TrainState.create(params, optimizer).replace(step=jnp.asarray(burnup + 1, jnp.int32))
    step = make_train_step(model, optimizer, caption_burnup_iters=burnup, lr_schedule=jax_build_lr_schedule(cfg),
                           donate=False, accum_steps=2)
    rng = jax.random.PRNGKey(1)
    new_state, want_metrics = step(state, jb, rng)
    anchors = (H // 16) * (W // 16) * 15
    draws = [_replay(_jax_draws(r, 1, anchors, cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN, G)) for r in jax.random.split(rng, 2)]

    trainer = _port_trainer(params, iteration=burnup + 1, accum_steps=2)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    metrics = trainer.train_step(_torch_batch(jb), _replay_per_microbatch(draws))
    assert trainer.iteration == burnup + 2 and trainer.optimizer.count == 1
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-4, err_msg=k)
    want = convert_jax_params(new_state.params)
    state_after = trainer.model.state_dict()
    assert state_after.keys() == want.keys()
    moved = 0
    for name, value in state_after.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
        moved += not torch.equal(value, before[name])
    assert moved == sum(p.requires_grad for p in trainer.model.parameters())


@pytest.mark.parametrize("kd, caption", [(False, True), (True, False)])
def test_loss_switches_give_jax_loss_names(tiny_jax, kd, caption):
    """The names depend on the switches alone: JAX traces both sides of its
    burn-up `lax.cond`, and the port returns zeros before burn-up."""
    cfg, model, jb, params = tiny_jax
    want = jax.eval_shape(
        lambda p, b, r: model.apply(p, b, r, jnp.asarray(True), kd, caption, method=model.cddmsl_losses),
        params, jb, jax.random.PRNGKey(0),
    )
    ours = _port_trainer(params).model
    for caption_on in (False, True):
        g = torch.Generator().manual_seed(0)
        got = ours.cddmsl_losses(_torch_batch(jb), lambda site, shape: torch.rand(shape, generator=g), caption_on,
                                 kd, caption)
        assert set(got) == set(want), (caption_on, sorted(got), sorted(want))
        assert all(torch.isfinite(v) for v in got.values())


# ---------------- the trainer on the fixture ----------------
NAMES = ("port_engine_trainval", "port_engine_test")


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    register_synthetic_quick(str(root), prefix="port_engine")
    yield root
    for name in NAMES + ("port_engine_trainval_plain",):
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)


def _tiny_cfg(out_dir, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(str(TINY_RECIPE))
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.DATASETS.TRAIN, cfg.DATASETS.TEST = (NAMES[0],), (NAMES[1],)
    cfg.merge_from_list([x for k, v in overrides.items() for x in (k, repr(v))])
    return cfg


def test_resumed_run_equals_an_uninterrupted_one(fixture_root, tmp_path):
    cfg = _tiny_cfg(tmp_path / "a", **{"SOLVER.CAPTION_BURNUP_ITERS": 1})
    with build_detection_train_loader(cfg, seed=0) as loader:
        batches = [next(loader) for _ in range(4)]

    straight = DefaultTrainer(cfg, device="cpu")
    straight.resume_or_load(resume=False)
    for b in batches:
        straight.run_step(b)

    cut = _tiny_cfg(tmp_path / "b", **{"SOLVER.CAPTION_BURNUP_ITERS": 1})
    first = DefaultTrainer(cut, device="cpu")
    first.resume_or_load(resume=False)
    for b in batches[:2]:
        first.run_step(b)
    first.checkpointer.save("model_0000001", first.state)
    resumed = DefaultTrainer(cut, device="cpu")
    resumed.resume_or_load(resume=True)
    assert resumed.start_iter == 2 and resumed.optimizer.count == 2
    for b in batches[2:]:
        resumed.run_step(b)

    assert resumed.state.iteration == straight.state.iteration == 4
    want, got = straight.state.state_dict(), resumed.state.state_dict()
    for name, value in want["model"].items():
        assert torch.equal(got["model"][name], value), name
    want_sgd, got_sgd = want["optimizer"]["sgd"]["state"], got["optimizer"]["sgd"]["state"]
    assert want_sgd.keys() == got_sgd.keys() and len(want_sgd) > 0
    for i in want_sgd:
        assert torch.equal(got_sgd[i]["momentum_buffer"], want_sgd[i]["momentum_buffer"]), i


def test_default_trainer_trains_evaluates_and_resumes(fixture_root, tmp_path):
    cfg = _tiny_cfg(tmp_path / "out", **{"SOLVER.MAX_ITER": 3, "SOLVER.CAPTION_BURNUP_ITERS": 1,
                                         "SOLVER.CHECKPOINT_PERIOD": 0})
    trainer = DefaultTrainer(cfg, device="cpu")
    trainer.resume_or_load(resume=False)
    results = trainer.train()
    assert set(results) == {NAMES[1]} and "AP50" in results[NAMES[1]]["bbox"]
    assert trainer.checkpointer.get_checkpoint_file() == str(tmp_path / "out" / "model_final.pth")
    assert os.path.exists(tmp_path / "out" / "metrics.json")
    assert len(trainer.storage.histories()["data_time"]._values) == 3

    again = DefaultTrainer(cfg, device="cpu")
    again.resume_or_load(resume=True)
    assert again.start_iter == 3
    for (name, p), q in zip(trainer.model.named_parameters(), again.model.parameters()):
        assert torch.equal(p, q), name

    final = str(tmp_path / "out" / "model_final.pth")
    predictor = DefaultPredictor(_tiny_cfg(tmp_path / "out", **{"MODEL.WEIGHTS": final}), device="cpu")
    trained = again.model.state_dict()
    for name, value in predictor.model.state_dict().items():
        assert torch.equal(value, trained[name]), name
    assert not hasattr(predictor.model, "offline_backbone")  # the serving build
    dets = predictor(np.full((100, 140, 3), 90, np.uint8))
    assert dets["boxes"].shape[1:] == (4,) and len(dets["boxes"]) == len(dets["scores"]) == len(dets["classes"])
    assert (dets["boxes"][:, 2:] <= [140, 100]).all()


def test_a_non_finite_loss_stops_training(fixture_root, tmp_path, monkeypatch):
    cfg = _tiny_cfg(tmp_path / "nan", **{"SOLVER.MAX_ITER": 1})
    trainer = DefaultTrainer(cfg, device="cpu")
    run_step = trainer.run_step

    def poisoned(batch):
        metrics = run_step(batch)
        return {**metrics, "total_loss": torch.tensor(float("nan"))}

    monkeypatch.setattr(trainer, "run_step", poisoned)
    with pytest.raises(FloatingPointError, match="iteration=0"):
        trainer.train()
    assert not trainer.checkpointer.has_checkpoint()


class _Counter:
    def __init__(self):
        self.n = 0

    def state_dict(self):
        self.n += 1
        return {"n": torch.tensor(self.n)}


def test_checkpointer_keeps_max_to_keep_and_model_final(tmp_path):
    ckpt = DetectionCheckpointer(str(tmp_path), max_to_keep=2)
    state = _Counter()
    for i in range(4):
        ckpt.save(f"model_{i:07d}", state)
    ckpt.save("model_final", state)
    assert sorted(os.listdir(tmp_path)) == ["last_checkpoint", "model_0000002.pth", "model_0000003.pth",
                                           "model_final.pth"]
    assert ckpt.get_checkpoint_file() == str(tmp_path / "model_final.pth")
    with pytest.raises(FileNotFoundError):
        DetectionCheckpointer(str(tmp_path / "fresh")).resume_or_load(str(tmp_path / "missing.pth"), state, resume=True)


def test_train_net_cli_runs_on_the_cpu(fixture_root, tmp_path):
    # one torch thread in the CLI (launch reads OMP_NUM_THREADS): the suite's workers already share the cores
    env = dict(os.environ, DETECTRON2_DATASETS=str(fixture_root), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "cddmsl_torch.train_net", "--device", "cpu", "--config-file", str(TINY_RECIPE),
           "OUTPUT_DIR", str(tmp_path / "out")]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert (tmp_path / "out" / "model_final.pth").exists() and "AP50" in out.stderr
