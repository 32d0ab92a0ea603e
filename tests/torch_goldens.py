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
numbers, so a replayed trainer loads JAX's tree (its init run eagerly, as
JAX's trainer runs it: a jitted init rounds two positional embeddings and
a kernel 1 ulp apart, and the mean-teacher golden holds only from the eager
tree) and replays those uniforms into the port's `Draw`, site by site.
JAX's train step is never compiled.
"""

import contextlib
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
    teacher's discriminator (PRNGKey(1)), as numpy trees."""
    cfg = jax_cfg(name, *opts)
    model = jax_build_model(cfg)
    rng = jax.random.PRNGKey(max(cfg.SEED, 0))
    params = jax.device_get(model.init({"params": rng}, _init_batch(cfg), rng, method=model.init_all))
    feat = np.zeros((1, 8, 8, model.backbone_width * 16), np.float32)
    dis = jax.device_get(JaxFCDiscriminator(dtype=jnp.float32).init(jax.random.PRNGKey(1), feat))
    return params, dis


def _uniforms(keys, n):
    return torch.from_numpy(np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)))


def jax_draw(k_rpn, k_roi, k_region=None):
    """The `Draw` of JAX's key tree below one step's keys: the RPN's
    split(k_rpn, B) then uniform(k1) / uniform(k2) of split(key); the RoI
    heads' split(k_roi, B), k1, k2 = split(key), the two of split(k1) and
    uniform(k2); the region boxes' split(k_region, B) (the same tree
    `test_torch_port_train._jax_draws` lays out)."""
    split_rows = jax.vmap(jax.random.split)

    def draw(site, shape):
        b, n = shape
        if site in ("rpn_pos", "rpn_neg"):
            keys = split_rows(jax.random.split(k_rpn, b))[:, int(site == "rpn_neg")]
        elif site == "roi_gather":
            keys = split_rows(jax.random.split(k_roi, b))[:, 1]
        elif site in ("roi_pos", "roi_neg"):
            keys = split_rows(split_rows(jax.random.split(k_roi, b))[:, 0])[:, int(site == "roi_neg")]
        elif site == "region" and k_region is not None:
            keys = jax.random.split(k_region, b)
        else:
            raise KeyError(f"JAX's step draws nothing at {site!r}")
        return _uniforms(keys, n)

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
