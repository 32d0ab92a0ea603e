"""Shared pieces of the quick-schedule goldens run through the port
(tests/test_torch_port_goldens_*.py): JAX's initial tree and per-iteration
draws handed to the port's trainers, the synthetic fixture under the
schedules' dataset names, and `train_net.main` on a schedule.

The goldens (`TEST.EXPECTED_RESULTS`) were pinned by
tools/run_quick_schedules.py from JAX's `DefaultTrainer`: parameters
initialised at PRNGKey(SEED) and each iteration's sampler draws from
fold_in(PRNGKey(SEED + 12345), it) (the mean teacher: fold_in(PRNGKey(SEED
+ 999), it), split in three for its supervised and pseudo-labeled
branches). The port's `init_random_` and torch generators draw other
numbers, so a replayed trainer loads JAX's tree (its initializers run
eagerly, as JAX's trainer runs them: a jitted init rounds two positional
embeddings and a kernel 1 ulp apart, and the mean-teacher golden holds only
from the eager tree; flax's `lazy_init` runs them so without computing the
forward, the same tree bit for bit) and replays those uniforms into the
port's `Draw`, site by site.
JAX's train step is never compiled.
"""

import contextlib
import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cddmsl_tpu.config import add_ateacher_config as jax_add_ateacher_config
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.engine.defaults import _init_batch
from cddmsl_tpu.engine.mean_teacher import FCDiscriminator as JaxFCDiscriminator
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_torch import train_net
from cddmsl_torch.checkpoint.convert_jax import _DISCRIMINATOR_RULES, _convert, convert_jax_params
from cddmsl_torch.data import DatasetCatalog, MetadataCatalog
from cddmsl_torch.data.datasets.synthetic import register_synthetic_quick
from cddmsl_torch.engine import mean_teacher
from cddmsl_torch.engine.defaults import default_argument_parser

REPO = Path(__file__).resolve().parent.parent
QUICK = REPO / "configs" / "quick_schedules"
NAMES = ("synthetic_voc_trainval", "synthetic_voc_trainval_plain", "synthetic_voc_test")
THREADS = 2  # the goldens' torch threads: the float order, and at 1 thread the R-CNN golden, depend on them


def jax_cfg(name: str, *opts):
    cfg = jax_get_cfg()
    jax_add_ateacher_config(cfg)
    cfg.merge_from_file(str(QUICK / name))
    cfg.merge_from_list(list(opts))
    return cfg


def jax_initial_tree(name: str, *opts):
    """JAX `DefaultTrainer`'s parameters for the schedule, and the mean
    teacher's discriminator (PRNGKey(1)), as numpy trees; None for the
    discriminator of a model without a backbone width (PanopticFPN and the
    SemanticSegmentor, which no mean teacher trains)."""
    cfg = jax_cfg(name, *opts)
    model = jax_build_model(cfg)
    rng = jax.random.PRNGKey(max(cfg.SEED, 0))
    # flax's lazy init: the parameters' initializers run eagerly on the
    # concrete key, as in `init`, and the forward on the (abstract) batch
    # is only traced; the tree is the eager init's bit for bit
    batch = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), _init_batch(cfg))
    params = jax.device_get(model.lazy_init({"params": rng}, batch, rng, method=model.init_all))
    if not getattr(model, "backbone_width", 0):
        return params, None
    feat = np.zeros((1, 8, 8, model.backbone_width * 16), np.float32)
    dis = jax.device_get(JaxFCDiscriminator(dtype=jnp.float32).init(jax.random.PRNGKey(1), feat))
    return params, dis


@functools.partial(jax.jit, static_argnames=("site", "b", "n"))
def _site_uniforms(key, site, b, n):
    """uniform((n,)) under each of the B keys that JAX's step draws from at
    `site` below `key`; one program per (site, b, n), bit for bit the eager
    ops' values (the key tree and the uniforms are integer and bit
    operations)."""
    split_rows = jax.vmap(jax.random.split)
    if site in ("rpn_pos", "rpn_neg"):
        keys = split_rows(jax.random.split(key, b))[:, int(site == "rpn_neg")]
    elif site == "roi_gather":
        keys = split_rows(jax.random.split(key, b))[:, 1]
    elif site in ("roi_pos", "roi_neg"):
        keys = split_rows(split_rows(jax.random.split(key, b))[:, 0])[:, int(site == "roi_neg")]
    else:  # region
        keys = jax.random.split(key, b)
    return jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)


def jax_draw(k_rpn, k_roi, k_region=None):
    """The `Draw` of JAX's key tree below one step's keys: the RPN's
    split(k_rpn, B) then uniform(k1) / uniform(k2) of split(key); the RoI
    heads' split(k_roi, B), k1, k2 = split(key), the two of split(k1) and
    uniform(k2); the region boxes' split(k_region, B) (the same tree
    `test_torch_port_train._jax_draws` lays out)."""

    def draw(site, shape):
        b, n = shape
        if site in ("rpn_pos", "rpn_neg"):
            key = k_rpn
        elif site in ("roi_gather", "roi_pos", "roi_neg"):
            key = k_roi
        elif site == "region" and k_region is not None:
            key = k_region
        else:
            raise KeyError(f"JAX's step draws nothing at {site!r}")
        return torch.from_numpy(np.array(_site_uniforms(key, site, b, n)))

    return draw


def step_draw(rng):
    """`cddmsl_losses(rng)`'s draws: split(rng, 3) -> RPN, RoI, region."""
    return jax_draw(*jax.random.split(rng, 3))


def supervised_draw(rng):
    """`supervised_losses(rng)`'s draws: split(rng) -> RPN, RoI."""
    return jax_draw(*jax.random.split(rng))


def replaying_trainers(params, dis, draw_of_step=step_draw):
    """`DefaultTrainer` and `MeanTeacherTrainer` subclasses that start from
    JAX's tree and replay JAX's per-iteration draws: `draw_of_step(rng)`,
    `step_draw` for GeneralizedRCNN's `cddmsl_losses`, `supervised_draw` for
    the modules whose `cddmsl_losses` is their supervised losses (FPNRCNN,
    CascadeRCNN)."""

    def load(trainer):
        trainer.model.load_state_dict(convert_jax_params(params), strict=True)
        if hasattr(trainer, "discriminator"):
            trainer.discriminator.load_state_dict(_convert(dis, _DISCRIMINATOR_RULES, "discriminator"), strict=True)

    class Default(train_net.DefaultTrainer):
        def __init__(self, cfg, device="cuda"):
            super().__init__(cfg, device)
            load(self)
            self._jax_key = jax.random.PRNGKey(max(cfg.SEED, 0) + 12345)

        def run_step(self, batch):
            return self.state.train_step(batch, draw_of_step(jax.random.fold_in(self._jax_key, self.state.iteration)))

    class MeanTeacher(mean_teacher.MeanTeacherTrainer):
        def __init__(self, cfg, device="cuda"):
            super().__init__(cfg, device)
            load(self)
            self._jax_key = jax.random.PRNGKey(max(cfg.SEED, 0) + 999)

        def run_step(self, batch):
            (ls, lw), (us, uw) = batch
            k_sup, k_pseudo, _ = jax.random.split(jax.random.fold_in(self._jax_key, self.state.iteration), 3)
            return self.mt_step(ls, lw, us, uw, supervised_draw(k_sup), supervised_draw(k_pseudo))

    return Default, MeanTeacher


@contextlib.contextmanager
def schedules_fixture(root):
    """The synthetic VOC fixture under the schedules' dataset names, removed
    from the catalogs afterwards."""
    register_synthetic_quick(str(root))
    try:
        yield str(root)
    finally:
        for name in NAMES:
            DatasetCatalog.remove(name)
            MetadataCatalog.remove(name)


@contextlib.contextmanager
def torch_threads(n):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run_schedule(name: str, out_dir, *opts, eval_only: bool = False):
    """`python -m cddmsl_torch.train_net --device cpu --config-file
    configs/quick_schedules/<name> OUTPUT_DIR <out_dir> [opts]` in this
    process; returns its results."""
    argv = ["--device", "cpu", "--config-file", str(QUICK / name)] + (["--eval-only"] if eval_only else [])
    args = default_argument_parser().parse_args(argv + ["OUTPUT_DIR", str(out_dir), *opts])
    with torch_threads(THREADS):
        return train_net.main(args)


def quick_schedules_weights(weights: str, out_root) -> str:
    """The `quick_schedules://<schedule>/<save>` sentinel resolved as
    tools/run_quick_schedules.py resolves it, to a run's OUTPUT_DIR under
    `out_root`; the port's saves end in .pth."""
    prefix = "quick_schedules://"
    assert weights.startswith(prefix), weights
    path = os.path.join(str(out_root), weights[len(prefix):]) + ".pth"
    assert os.path.exists(path), f"{path} missing: run the producing schedule first"
    return path


def jax_own_schedule(name: str, out_dir, scale: float = 0.0, *opts):
    """JAX's own `DefaultTrainer.train()` on the schedule from its initial
    tree, every leaf moved by `scale` (times +-1, signs from
    RandomState(0)); TEST.EXPECTED_RESULTS not checked. Returns (its
    results, its final parameters as a numpy tree). The schedule's sets
    must be registered in JAX's catalogs."""
    from cddmsl_tpu.engine.defaults import DefaultTrainer as JaxDefaultTrainer

    cfg = jax_cfg(name, "OUTPUT_DIR", str(out_dir), "TEST.EXPECTED_RESULTS", "[]", *opts)
    trainer = JaxDefaultTrainer(cfg)
    trainer.resume_or_load(resume=False)
    r = np.random.RandomState(0)
    trainer.state = trainer.state.replace(params=jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1 + scale * r.choice([-1, 1], np.shape(a)))).astype(np.asarray(a).dtype),
        jax.device_get(trainer.state.params)))
    return trainer.train(), jax.device_get(trainer.state.params)


def _momentum(state):
    """The momentum of JAX's optimizer state (optax's trace) as the port's
    tensors by name."""
    import optax

    trace, = (t.trace for t in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda x: isinstance(
        x, optax.TraceState)) if isinstance(t, optax.TraceState))
    return convert_jax_params(jax.device_get(trace))


def _worst_loss(got, want):
    """(the largest relative difference of a loss, that loss); a loss of 0
    counts as 1e-6."""
    return max((abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-6), k)
               for k in want if k.startswith("loss_"))


def _update_apart(before, after, control_before, control_after):
    """How far an update (the parameters after a step less before) lies
    from JAX's, relative to the size of JAX's: the trees are {name:
    tensor}, the first two JAX's."""
    apart = sum(float(((control_after[n] - control_before[n]) - (after[n] - before[n])).pow(2).sum()) for n in after)
    return (apart / sum(float((after[n] - before[n]).pow(2).sum()) for n in after)) ** 0.5


def schedule_lockstep(name, jax_train_set, draw_of_step, threads=THREADS, explain=None):
    """The schedule's steps by JAX's train step from JAX's initial tree on
    JAX's loader with the trainer's draws, JAX's training set registered as
    `jax_train_set` (the port's loader reads the schedule's own, which the
    caller registers). Each batch of the port's loader must be JAX's bit
    for bit. Before each step the port's `Trainer` (at `threads` torch
    threads) takes JAX's state (the parameters, the momentum and the
    count) and takes the same step with `draw_of_step(rng)`; so does JAX's
    step from that state with every parameter moved by one part in 1e7 (the
    control: JAX's own float noise). Returns one row per step: the largest
    relative difference of a loss and the update apart from JAX's (the
    port's, and the control's), and where `explain(it, model, jax_params,
    jax_batch, rng, ours, batch)` is given and the port departs past 1e-4
    (a loss) or 1e-3 (the update) and past 10 times the control, what it
    says of that step ("explained")."""
    from cddmsl_tpu.data.build import build_detection_train_loader as jax_build_detection_train_loader
    from cddmsl_tpu.engine import TrainState, make_train_step
    from cddmsl_tpu.models import DetBatch as JaxDetBatch
    from cddmsl_tpu.solver import build_lr_schedule as jax_build_lr_schedule
    from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
    from cddmsl_torch.config import add_ateacher_config, get_cfg, solver_config_from_cfg
    from cddmsl_torch.data import build_detection_train_loader
    from cddmsl_torch.engine.train_loop import Trainer
    from cddmsl_torch.models.build import build_detector
    from cddmsl_torch.solver.build import build_optimizer

    jcfg = jax_cfg(name, "DATASETS.TRAIN", f"('{jax_train_set}',)")
    cfg = get_cfg()
    add_ateacher_config(cfg)
    cfg.merge_from_file(str(QUICK / name))
    params, _ = jax_initial_tree(name)
    model = jax_build_model(jcfg)
    optimizer = jax_build_optimizer(jcfg, params)
    state = TrainState.create(params, optimizer)
    burnup, caption = cfg.SOLVER.CAPTION_BURNUP_ITERS, cfg.TPU.ENABLE_CAPTION_CONSISTENCY
    step = make_train_step(model, optimizer, enable_caption=caption, caption_burnup_iters=burnup,
                           lr_schedule=jax_build_lr_schedule(jcfg), donate=False)
    ours = build_detector(cfg, device="cpu", training=True)
    trainer = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(cfg)), caption_burnup_iters=burnup,
                      enable_caption=caption)
    trainable = [(n, p) for n, p in ours.named_parameters() if p.requires_grad]
    names = [n for n, _ in trainable]
    key = jax.random.PRNGKey(max(cfg.SEED, 0) + 12345)
    r = np.random.RandomState(0)
    rows = []
    with build_detection_train_loader(cfg, seed=max(cfg.SEED, 0)) as loader, torch_threads(threads):
        jax_loader = jax_build_detection_train_loader(jcfg, seed=max(cfg.SEED, 0))
        for it in range(cfg.SOLVER.MAX_ITER):
            batch, want_batch = next(loader), next(jax_loader)
            for field in want_batch._fields:
                got_field, want_field = getattr(batch, field), getattr(want_batch, field)
                if got_field is not None or want_field is not None:
                    np.testing.assert_array_equal(got_field.numpy(), np.asarray(want_field), err_msg=f"{it} {field}")
            moved = state.replace(params=jax.tree_util.tree_map(
                lambda a: (np.asarray(a) * (1 + 1e-7 * r.choice([-1, 1], np.shape(a)))).astype(np.float32),
                jax.device_get(state.params)))
            before = convert_jax_params(jax.device_get(state.params))
            ours.load_state_dict(before, strict=True)
            momentum = _momentum(state)
            for n, p in trainable:
                trainer.optimizer.sgd.state[p]["momentum_buffer"] = momentum[n].clone()
            trainer.optimizer.count = int(state.step)
            trainer.iteration = it
            rng = jax.random.fold_in(key, it)
            jb = JaxDetBatch(**{f: None if getattr(batch, f) is None else jnp.asarray(getattr(batch, f).numpy())
                                for f in JaxDetBatch._fields})
            moved_after, control = step(moved, jb, rng)
            jax_params = state.params
            state, want = step(state, jb, rng)
            got = trainer.train_step(batch, draw_of_step(rng))
            after = convert_jax_params(jax.device_get(state.params))
            port = {n: p.detach() for n, p in trainable}
            jax_before, jax_after = {n: before[n] for n in names}, {n: after[n] for n in names}
            moved_before = convert_jax_params(jax.device_get(moved.params))
            moved_after = convert_jax_params(jax.device_get(moved_after.params))
            row = dict(step=it + 1, loss=_worst_loss(got, want),
                       update=_update_apart(jax_before, jax_after, jax_before, port),
                       control_loss=_worst_loss(control, want),
                       control_update=_update_apart(jax_before, jax_after, {n: moved_before[n] for n in names},
                                                    {n: moved_after[n] for n in names}))
            print(f"step {it + 1}: the port's losses rtol {row['loss'][0]:.3g} ({row['loss'][1]}), its update "
                  f"{row['update']:.3g} apart; the control's {row['control_loss'][0]:.3g} "
                  f"({row['control_loss'][1]}), {row['control_update']:.3g}")
            if explain is not None and (row["loss"][0] > max(1e-4, 10 * row["control_loss"][0])
                                        or row["update"] > max(1e-3, 10 * row["control_update"])):
                ours.load_state_dict(before, strict=True)
                row["explained"] = explain(it, model, jax_params, jb, rng, ours, batch)
                print(f"step {it + 1}: {row['explained']}")
            rows.append(row)
    return rows


def lockstep_summary(rows):
    """(the port's, the control's): the largest loss difference, the
    largest update difference and the steps past 1e-4 (losses) or 1e-3
    (update), over the rows."""
    def one(loss, update):
        past = [row["step"] for row in rows if row[loss][0] > 1e-4 or row[update] > 1e-3]
        return max(row[loss][0] for row in rows), max(row[update] for row in rows), past

    return one("loss", "update"), one("control_loss", "control_update")
