"""Data parallelism of cddmsl_torch across processes, held against one
process stepping the whole global batch.

The port's one-process step is held against the JAX package's global-batch
programs by the other tests (`make_train_step`, `mt_step`), so here world 2
(two CPU ranks under gloo) is held against world 1 of the port, and no
process imports JAX for it. The world-2 cases run in one session of two
ranks (tests/torch_ddp_session.py, through `launch`), started with this
module and run while this process computes world 1. Both worlds run their
convolutions off oneDNN: oneDNN rounds an image's convolution by the batch
it is in (the ranks' batches are half the size), and the classifier's
temperature of 0.01 lifts that rounding to ~1e-5 in the momentum after 4
steps, where the arithmetic of the split itself stays within 1e-7.

- the loaders' split: the ranks' rows, concatenated, are the world-1 batch
  field by field, for the paired loader (with ACCUM_STEPS 2 too), the
  two-crop loader and the test loader (no subprocess);
- `train_net.main` at world 2 on voc_tiny.yaml with the caption branch from
  step 2 and KD on, then with MODEL.CONSISTENCY_BRANCH image_region:
  parameters, momentum and logged losses within 1e-6 of world 1, the same
  eval results and detections, the files written by rank 0 alone, and its
  save resumed at world 1;
- unequal quotas (`normalizer_case`);
- the gathered InfoNCE's gradient (`infonce_case`);
- the mean-teacher trainer: one burn-up step and two semi-supervised ones,
  and `compute_val_loss` of its save;
- TPU.MESH_SHAPE against the world, and `launch`'s arguments.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cddmsl_torch import train_net
from cddmsl_torch.config import add_ateacher_config, check_supported, get_cfg
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader, build_detection_train_loader
from cddmsl_torch.data.build import build_semisup_train_loader_two_crops
from cddmsl_torch.data.datasets.synthetic import make_synthetic_voc
from cddmsl_torch.engine.defaults import DefaultTrainer
from cddmsl_torch.engine.launch import launch
from torch_ddp_session import (
    MT_OPTS, MT_TINY, TRAIN_CASES, VOC_TINY, WORLD, detections, infonce_case, normalizer_case, register_fixture,
    train_net_argv, val_losses,
)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-6  # of a tensor's largest value where that is above 1


# ---------------- the loaders' split ----------------
@pytest.fixture(scope="module")
def two_orientations(tmp_path_factory):
    """Twelve images, landscape and portrait, some with a translated twin,
    under one name and as a labeled and an unlabeled part."""
    root = tmp_path_factory.mktemp("ddp_loader")
    r = np.random.RandomState(0)
    dicts = []
    for i in range(12):
        h, w = (100, 140) if i % 3 else (140, 100)
        img = (r.rand(h, w, 3) * 200).astype(np.uint8)
        x1, y1 = int(r.rand() * w * 0.5), int(r.rand() * h * 0.5)
        box = {"bbox": [x1, y1, x1 + 20, y1 + 20], "category_id": int(r.randint(20)), "difficult": 0}
        d = {"file_name": str(root / f"{i}.png"), "image_id": i, "height": h, "width": w, "annotations": [box]}
        Image.fromarray(img).save(d["file_name"])
        if i % 2 == 0:
            d["data_dt_file_name"] = str(root / f"{i}_dt.png")
            Image.fromarray(255 - img).save(d["data_dt_file_name"])
        dicts.append(d)
    names = {"ddp_all": dicts, "ddp_label": dicts[:6], "ddp_unlabel": dicts[6:]}
    for name, ds in names.items():
        DatasetCatalog.register(name, lambda ds=ds: copy.deepcopy(ds))
    yield
    for name in names:
        DatasetCatalog.remove(name)


def _loader_cfg(**solver):
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(VOC_TINY))
    cfg.INPUT.MIN_SIZE_TRAIN = (64, 80, 96)
    cfg.DATASETS.TRAIN = cfg.DATASETS.TEST = ("ddp_all",)
    cfg.DATASETS.TRAIN_LABEL, cfg.DATASETS.TRAIN_UNLABEL = ("ddp_label",), ("ddp_unlabel",)
    cfg.DATASETS.CROSS_DATASET = True
    cfg.SOLVER.IMG_PER_BATCH_LABEL = cfg.SOLVER.IMG_PER_BATCH_UNLABEL = 4
    for k, v in solver.items():
        cfg.SOLVER[k] = v
    return cfg


def _concat(blocks):
    """The ranks' DetBatches as one, in rank order."""
    return type(blocks[0])(*(None if parts[0] is None else torch.cat(parts) for parts in zip(*blocks)))


def _assert_batches_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("accum", [1, 2])
def test_the_paired_loaders_ranks_hold_the_world_1_batch(two_orientations, accum):
    """Six batches of 4 in both orientations: rank 0's rows then rank 1's
    are the world-1 batch; with ACCUM_STEPS 2 each rank holds its row of
    each microbatch of 2 (rows 0 and 2, 1 and 3)."""
    cfg = _loader_cfg(IMS_PER_BATCH=4, ACCUM_STEPS=accum)
    rows = [0, 1, 2, 3] if accum == 1 else [0, 2, 1, 3]  # the world-1 row of each rank-ordered row
    with build_detection_train_loader(cfg, seed=3) as whole:
        ranks = [build_detection_train_loader(cfg, seed=3, rank=r, world=WORLD) for r in range(WORLD)]
        shapes = set()
        for _ in range(6):
            want = next(whole)
            _assert_batches_equal(_concat([next(r) for r in ranks]),
                                  type(want)(*(None if f is None else f[rows] for f in want)))
            shapes.add(tuple(want.image.shape[1:3]))
        for r in ranks:
            r.close()
    assert shapes == {(96, 160), (160, 96)}


def test_the_two_crop_loaders_ranks_hold_the_world_1_batches(two_orientations):
    """Four steps of ((label_s, label_w), (unlabel_s, unlabel_w)): each of
    the four views, rank blocks concatenated, is the world-1 view (the
    strong augmentation of another rank's rows is drawn, not applied)."""
    cfg = _loader_cfg()
    with build_semisup_train_loader_two_crops(cfg, seed=3) as whole:
        ranks = [build_semisup_train_loader_two_crops(cfg, seed=3, rank=r, world=WORLD) for r in range(WORLD)]
        for _ in range(4):
            want = next(whole)
            got = [next(r) for r in ranks]
            for s in range(2):
                for v in range(2):
                    _assert_batches_equal(_concat([g[s][v] for g in got]), want[s][v])
        for r in ranks:
            r.close()


def test_the_test_loaders_ranks_split_each_batch(two_orientations):
    """Batches of 4, the last of each orientation padded by repeating its
    last image: the ranks' rows are the world-1 batch, with the same
    metadata on every rank."""
    cfg = _loader_cfg()
    whole, n = build_detection_test_loader(cfg, "ddp_all", 4)
    ranks = [build_detection_test_loader(cfg, "ddp_all", 4, rank=r, world=WORLD)[0] for r in range(WORLD)]
    count = 0
    with whole:
        for want, metas in whole:
            got = [next(r) for r in ranks]
            assert all(g[1] == metas for g in got)
            _assert_batches_equal(_concat([g[0] for g in got]), want)
            count += len(metas)
    assert count == n == 12
    for r in ranks:
        assert next(r, None) is None
        r.close()


# ---------------- the world-2 session against world 1 ----------------
@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_datasets")
    make_synthetic_voc(str(root))
    register_fixture(root)
    yield root
    for name in ("ddp_voc_trainval", "ddp_voc_trainval_plain", "ddp_voc_test"):
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)


@pytest.fixture(scope="module")
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def session(fixture_root, tmp_path_factory, no_onednn):
    """Starts the world-2 session, then runs world 1 here: -> (its
    OUT_DIR, its results, this process's results)."""
    out = tmp_path_factory.mktemp("ddp_world2")
    cores = len(os.sched_getaffinity(0))  # half for the two ranks, half for this process
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]),
               OMP_NUM_THREADS=str(max(1, cores // 4)))
    proc = subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_ddp_session.py"), str(out), str(fixture_root)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, cores // 2))
    try:
        world1 = _world_1(tmp_path_factory.mktemp("ddp_world1"))
        log, _ = proc.communicate(timeout=600)
    finally:
        torch.set_num_threads(threads)
        proc.kill()
    assert proc.returncode == 0, log[-4000:]
    return out, torch.load(out / "session.pt", weights_only=False), world1


def _world_1(out):
    parse = train_net.default_argument_parser().parse_args
    result = {}
    for case, opts in TRAIN_CASES.items():
        argv = train_net_argv(VOC_TINY, out / case, *opts)
        result[case] = {"results": train_net.main(parse(argv)), "detections": detections(argv)}
    grads, sampled = normalizer_case()
    result["normalizer"] = {"grads": grads, "sampled": sampled}
    result["infonce"] = infonce_case()
    argv = train_net_argv(MT_TINY, out / "mean_teacher", *MT_OPTS)
    result["mean_teacher"] = train_net.main(parse(argv))
    result["mt_val_losses"] = val_losses(argv)
    result["out"] = out
    return result


def _assert_close(got, want, what):
    """Within 1e-6, or 1e-6 of the tensor's largest value where that is
    above 1."""
    assert got.shape == want.shape, what
    err = float((got.double() - want.double()).abs().max()) if want.numel() else 0.0
    assert err <= TOL * max(1.0, float(want.abs().max()) if want.numel() else 0.0), (what, err)


def _assert_states_close(got, want, keys=("model",)):
    for key in keys:
        assert got[key].keys() == want[key].keys(), key
        for name, w in want[key].items():
            _assert_close(got[key][name], w, f"{key} {name}")


def _assert_momentum_close(got, want):
    assert got["count"] == want["count"]
    g, w = got["sgd"]["state"], want["sgd"]["state"]
    assert g.keys() == w.keys() and len(w) > 0
    for i in w:
        _assert_close(g[i]["momentum_buffer"], w[i]["momentum_buffer"], f"momentum {i}")


def _last_metrics(path):
    return json.loads(path.read_text().splitlines()[-1])


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_net_at_world_2_equals_world_1(session, case):
    """4 steps of 2 images (one per rank) through `train_net.main`, the
    caption branch from step 2, KD on (and the image_region branch): the
    save's parameters and momentum and the logged losses within 1e-6 of
    world 1, the same eval results, and the same detections on every test
    image through the sharded `inference_on_dataset` (boxes to 1e-3 px,
    scores to 1e-5, as the port's inference tests hold them)."""
    out, ranks, world1 = session
    got = torch.load(out / case / "model_final.pth", weights_only=True)
    want = torch.load(world1["out"] / case / "model_final.pth", weights_only=True)
    assert got["iteration"] == want["iteration"] == 4
    _assert_states_close(got, want)
    _assert_momentum_close(got["optimizer"], want["optimizer"])
    g, w = _last_metrics(out / case / "metrics.json"), _last_metrics(world1["out"] / case / "metrics.json")
    losses = [k for k in w if k.endswith("loss")]
    assert "kd_loss" in losses and (case != "image_region" or "image_region_cont_loss" in losses)
    for k in losses:
        assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), (k, g[k], w[k])
    assert ranks[case]["results"] == world1[case]["results"]
    gd, wd = ranks[case]["detections"], world1[case]["detections"]
    assert [d[0] for d in gd] == [d[0] for d in wd] and len(wd) == 6
    for (_, gb, gs, gc), (_, wb, ws, wc) in zip(gd, wd):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)


def test_only_rank_0_writes_and_a_world_2_save_resumes_at_world_1(session):
    """Rank 1 opens no file for writing in OUTPUT_DIR; rank 0 writes the
    config, the metrics, the saves and the marker; a world-1 trainer with
    --resume restores the world-2 save."""
    out, ranks, _ = session
    rank0, rank1 = ranks["caption_kd"]["writes"]
    assert rank1 == []
    assert {"config.yaml", "metrics.json", "last_checkpoint", "model_final.pth.tmp",
            "model_0000001.pth.tmp", "model_0000003.pth.tmp"} == set(rank0)
    args = train_net.default_argument_parser().parse_args(
        ["--resume", *train_net_argv(VOC_TINY, out / "caption_kd", *TRAIN_CASES["caption_kd"])])
    cfg = train_net.setup(args)
    trainer = DefaultTrainer(cfg, device="cpu")
    trainer.resume_or_load(resume=True)
    saved = torch.load(out / "caption_kd" / "model_final.pth", weights_only=True)
    assert trainer.start_iter == 4 and trainer.optimizer.count == 4
    assert all(torch.equal(v, saved["model"][k]) for k, v in trainer.model.state_dict().items())


def test_the_cli_evaluates_the_world_2_save_on_two_ranks(session, fixture_root):
    """`python -m cddmsl_torch.train_net --device cpu --num-gpus 2
    --eval-only` on the world-2 save: the AP of world 1's final test, one
    results table (rank 0 logs, rank 1 only warns)."""
    out, _, world1 = session
    env = dict(os.environ, DETECTRON2_DATASETS=str(fixture_root), PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "cddmsl_torch.train_net", "--device", "cpu", "--num-gpus", "2", "--eval-only",
           "--config-file", str(VOC_TINY), "OUTPUT_DIR", str(out / "cli"), "DATASETS.TEST", "('voc_2007_test',)",
           "MODEL.WEIGHTS", str(out / "caption_kd" / "model_final.pth")]
    run = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    log = run.stdout + run.stderr
    assert log.count("Results on voc_2007_test") == 1
    want = world1["caption_kd"]["results"]["ddp_voc_test"]["bbox"]
    ap = dict(zip(*(line.split(",") for line in log.split("[bbox]\n")[1].splitlines()[:2])))
    assert {k: float(v) for k, v in ap.items()} == {k: round(v, 4) for k, v in want.items()}


def test_a_sampler_short_of_its_quota_on_one_rank_keeps_the_global_loss(session):
    """Rank 0's images offer 7 RoIs where the quota is 32, rank 1's fill
    it: the per-rank sampled counts differ (14 and 64), and the gradient
    averaged over the ranks equals world 1's to 1e-6 because the Fast R-CNN
    losses divide by the global count (`comm.global_normalizer`). Each rank
    dividing by its own count, as a plain per-rank mean would, misses it
    (the second half: the same session with that normalizer)."""
    _, ranks, world1 = session
    got, want = ranks["normalizer"], world1["normalizer"]
    assert got["sampled"] == [14, 64] and want["sampled"] == 78
    assert got["grads"].keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        _assert_close(got["grads"][k], w, k)
    worst = max(float((got["local_grads"][k] - w).abs().max() / w.abs().max()) for k, w in want["grads"].items())
    assert worst > 0.1


def test_the_gathered_infonce_gives_the_global_batch_gradient(session):
    """Each rank computes the loss over both ranks' rows; its rows'
    gradient, as the mean over the ranks applies it, and the projection's
    averaged gradient equal one process's over all 8 rows (1e-6). The
    reference's GatherLayer, which keeps a rank's own slice of its own
    gradient, gives 1/world of it."""
    _, ranks, world1 = session
    got, want = ranks["infonce"], world1["infonce"]
    for r in got:
        _assert_close(r["loss"], want["loss"], "loss")
        _assert_close(r["W"], want["W"], "W")
    for view in ("a", "b"):
        _assert_close(torch.cat([r[view] for r in got]), want[view], view)
        _assert_close(torch.cat([r[f"{view}_ref"] for r in got]), want[view] / WORLD, f"{view} reference")
    assert float(want["a"].abs().max()) > 1e-2


def test_the_mean_teacher_at_world_2_equals_world_1(session):
    """mt_tiny.yaml (8 + 8 images a step, 4 + 4 per rank) for one burn-up
    step and two semi-supervised ones: student, teacher and discriminator,
    and both optimizers' momentum, within 1e-6; the teacher's test
    results equal; `compute_val_loss` of the save, a collective, gives
    every rank world 1's losses on the whole batch."""
    out, ranks, world1 = session
    got = torch.load(out / "mean_teacher" / "model_final.pth", weights_only=True)
    want = torch.load(world1["out"] / "mean_teacher" / "model_final.pth", weights_only=True)
    assert got["iteration"] == want["iteration"] == 3
    _assert_states_close(got, want, ("model", "teacher", "discriminator"))
    for key in ("optimizer", "dis_optimizer"):
        _assert_momentum_close(got[key], want[key])
    assert ranks["mean_teacher"] == world1["mean_teacher"]
    g, w = _last_metrics(out / "mean_teacher" / "metrics.json"), _last_metrics(world1["out"] / "mean_teacher" /
                                                                               "metrics.json")
    assert g["loss_D"] > 0 and abs(g["loss_cls_pseudo"] - w["loss_cls_pseudo"]) <= TOL
    want = world1["mt_val_losses"]
    assert len(ranks["mt_val_losses"]) == WORLD and want["loss_cls"] > 0
    for got in ranks["mt_val_losses"]:
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert abs(got[k] - v) <= TOL * max(1.0, abs(v)), (k, got[k], v)


# ---------------- the config and the launcher ----------------
def test_the_mesh_shape_is_the_world():
    """TPU.MESH_SHAPE [k] is a data axis of any k: a JAX mesh of k devices
    computes the global batch's step, as world N does. It runs wherever the
    world divides the global batch: [2] and [8] and [-1] at worlds 1 and 2
    on a batch of 2, and at no world of 3; mt_rcnn_training_acc_test.yaml
    ([4], 4 + 4 images) at worlds 1, 2 and 4 and not at world 3; a mesh of
    two axes nowhere (a check of the config, no run)."""
    cfg = get_cfg()
    cfg.merge_from_file(str(VOC_TINY))
    for mesh in ([2], [8], [-1]):
        cfg.TPU.MESH_SHAPE = mesh
        check_supported(cfg)
        check_supported(cfg, world=1)
        check_supported(cfg, world=2)
        with pytest.raises(NotImplementedError, match=r"TPU\.MESH_SHAPE.*SOLVER\.IMS_PER_BATCH = 2"):
            check_supported(cfg, world=3)
    cfg.TPU.MESH_SHAPE = [2, 2]
    with pytest.raises(NotImplementedError, match=r"TPU\.MESH_SHAPE"):
        check_supported(cfg, world=1)
    acc = get_cfg()
    add_ateacher_config(acc)
    acc.merge_from_file(str(REPO / "configs" / "quick_schedules" / "mt_rcnn_training_acc_test.yaml"))
    for world in (1, 2, 4):
        check_supported(acc, world=world)
    with pytest.raises(NotImplementedError, match=r"TPU\.MESH_SHAPE.*SOLVER\.IMG_PER_BATCH_LABEL = 4"):
        check_supported(acc, world=3)


def test_launch_runs_one_process_in_place_and_checks_its_arguments():
    assert launch(lambda x: x + 1, 1, args=(1,)) == 2
    for kwargs in (dict(num_gpus_per_machine=0), dict(num_machines=2, machine_rank=2),
                   dict(num_machines=2, machine_rank=0)):
        with pytest.raises(ValueError):
            launch(lambda: None, **{"num_gpus_per_machine": 1, **kwargs})
