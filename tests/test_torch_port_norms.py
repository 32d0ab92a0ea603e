"""The trainable norms in the port against cddmsl_tpu on the CPU:
`SyncBatchNorm` in train and eval, its and `GroupNorm32`'s gradients,
PreciseBN's `update_bn_stats`,
`make_norm` against JAX's `_make_norm`, a GN and a SyncBN Mask R-CNN on the
FPN (tower, FPN, conv box head of NUM_CONV 2 and NUM_FC 1, mask head) one
step at a time against JAX's `make_train_step` with the running state,
the frozen set against JAX's `trainable_mask`, the running state through a
save and a resume, the GN and SyncBN detectron2 files through both
loaders, and world 2 under gloo against world 1.

The Mask R-CNN steps run one JAX program here (SyncBN's train step; GN's
is in test_torch_port_norms_gn.py), at RESNETS.DEPTH 10 with a bottleneck of 8 on two 96x160 images without
padding (`BATCH_FULL`): over a zero-padded region the norms' statistics
take in constant maps and a float32 step is ill-conditioned there, the
port's and JAX's alike (on batch A, whose second image is padded from
80x128, both float32 steps are about 5e-3 of the update's norm from the
float64 one). Tolerances, and why:
- `SyncBatchNorm`'s output within 1e-5 of its largest magnitude and its
  running statistics within 1e-6 (float32 means in another order);
  PreciseBN's estimate within 1e-6; SyncBN's and GN's train-mode output
  and their gradients (the input's, the scale's, the bias's, through the
  batch's or each group's statistics) within 1e-5 of each one's largest
  magnitude;
- a step's losses within rtol 1e-5 of JAX's; its update (the parameters
  and the running state after it) within 1.5e-3 of the update's norm of
  JAX's (measured 1.1e-4 for SyncBN and 5.7e-4 for GN; a SyncBN whose
  variance passes no gradient back lies 1.9e-2 away), and within 3e-4 of
  the update's norm of the same step in float64 (the port's model and
  trainer in float64 from the same state and draws; measured 2.3e-4 for
  GN, whose statistics are float32 sums over groups of up to 7680 values,
  and 2e-5 for SyncBN, whose parameters' update alone is 2e-4 off: the
  gradient through a batch statistic is a difference of such sums). JAX's
  float32 parameters' update is itself 5e-4 to 2e-3 of its norm away from
  the float64 step, farther than the port's, which the test asserts. JAX
  gives no float64 step to hold the port's to: under x64 its NMS does not
  trace (int32 and int64 indices in one `dynamic_slice`), and on
  precomputed proposals, where no NMS runs, its norms still take their
  statistics in float32, so its step lies 8.8e-5 of the update's norm
  from the port's float64 step, no nearer than the float32 pair;
- the frozen set, the loaders' tensors and the save exactly; world 2's
  update within 1e-5 of world 1's norm and its running statistics within
  1e-6 (world 2 averages the statistics of two half batches).
"""

import contextlib
import socket
from pathlib import Path

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
from cddmsl_tpu.models.backbone import resnet as jax_resnet
from cddmsl_tpu.models.backbone.batch_norm import GroupNorm32 as JaxGroupNorm32
from cddmsl_tpu.models.backbone.batch_norm import SyncBatchNorm as JaxSyncBatchNorm
from cddmsl_tpu.models.backbone.batch_norm import update_bn_stats as jax_update_bn_stats
from cddmsl_tpu.models.fpn_rcnn import FPNRCNN as JaxFPNRCNN
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_tpu.solver.build import build_lr_schedule as jax_build_lr_schedule
from cddmsl_tpu.solver.build import trainable_mask
from cddmsl_torch.checkpoint.checkpointer import DetectionCheckpointer
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.checkpoint.convert_torch import load_rcnn_weights
from cddmsl_torch.config import get_cfg, solver_config_from_cfg
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.models.backbone.batch_norm import (
    GroupNorm32, SyncBatchNorm, make_norm, running_state, update_bn_stats, updating_running_state,
)
from cddmsl_torch.models.backbone.clip_resnet import FrozenBatchNorm2d
from cddmsl_torch.models.fpn_rcnn import FPNRCNN
from cddmsl_torch.models.semantic_seg import GroupNorm32 as SemSegGroupNorm32
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_backbone import fill_params
from test_torch_port_fpn import BATCH_A, D2_PIXELS, NARROW, make_batch, torch_batch
from test_torch_port_mask_rcnn import diamond_canvases
from torch_goldens import supervised_draw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
OUT_ATOL, STAT_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
SOLVER = ["SOLVER.BASE_LR", "0.02", "SOLVER.WARMUP_ITERS", "0", "MODEL.BACKBONE.FREEZE_AT", "0"]
F64_RTOL, JAX_RTOL, WORLD_RTOL = 3e-4, 1.5e-3, 1e-5
BATCH_FULL = make_batch(2, 96, 160, [[96, 160], [96, 160]], [[192, 320], [96, 160]], seed=1)


def norm_model_kw(norm):
    """A narrow Mask R-CNN with `norm` through the tower, the FPN, a conv
    box head of 2 convs and 1 fc, and the mask head."""
    return dict(NARROW, **D2_PIXELS, mask_on=True, mask_num_conv=2, mask_conv_dim=16, backbone_norm=norm,
                fpn_norm=norm, box_num_conv=2, box_conv_dim=16, box_num_fc=1, box_conv_norm=norm,
                mask_conv_norm=norm)


def filled_variables(module, batch, seed):
    """JAX's variables of `module` (eval_shape of `init_all`: no compile),
    filled by `fill_params`; the RPN's outputs and the box regressor near
    their own inits' scale (test_torch_port_fpn.py `filled`)."""
    shapes = jax.eval_shape(lambda r, b: module.init({"params": r}, b, r, method=module.init_all),
                            jax.random.PRNGKey(0), batch)
    variables = fill_params(shapes, seed=seed)
    tree = variables["params"]
    for name in ("objectness_logits", "anchor_deltas"):
        tree["proposal_generator"]["head"][name]["kernel"] /= 4
    bbox = tree["roi_heads"]["box_predictor"]["bbox_pred"]
    bbox["kernel"] = bbox["kernel"] * (0.001 / bbox["kernel"].std())
    return variables


def update_apart(before, got, want, keys=None):
    """|got's update - want's| / |want's update| over the state's `keys`
    (all of it by default: the norm of every tensor's change from
    `before`), in float64."""
    keys = [k for k in (want if keys is None else keys) if want[k].is_floating_point()]
    d = lambda s, k: s[k].double() - before[k].double()  # noqa: E731
    num = sum(float(((d(got, k) - d(want, k)) ** 2).sum()) for k in keys)
    den = sum(float((d(want, k) ** 2).sum()) for k in keys)
    assert den > 0
    return (num / den) ** 0.5


# ---------------- the module ----------------
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_sync_batch_norm_equals_jax(train):
    """Train: the batch's statistics (biased variance) normalize and the
    running ones move by m = 0.9; eval: the running ones normalize and stay."""
    r = np.random.RandomState(0)
    x = (r.randn(3, 5, 7, 16) * 2 + 0.5).astype(np.float32)
    jm = JaxSyncBatchNorm(16)
    variables = {"params": {"weight": r.uniform(0.5, 1.5, 16).astype(np.float32),
                            "bias": r.uniform(-0.1, 0.1, 16).astype(np.float32)},
                 "batch_stats": {"running_mean": r.uniform(-0.1, 0.1, 16).astype(np.float32),
                                 "running_var": r.uniform(0.5, 1.5, 16).astype(np.float32)}}
    if train:
        want, mutated = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        want_stats = mutated["batch_stats"]
    else:
        want, want_stats = jm.apply(variables, jnp.asarray(x)), variables["batch_stats"]
    ours = SyncBatchNorm(16)
    ours.load_state_dict({k: torch.from_numpy(v) for d in variables.values() for k, v in d.items()})
    with updating_running_state(ours) if train else contextlib.nullcontext():
        got = ours(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert not ours.updating
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=OUT_ATOL * np.abs(want).max())
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(ours, k).numpy(), np.asarray(want_stats[k]), rtol=0, atol=STAT_ATOL)
    assert train != np.allclose(np.asarray(want_stats["running_var"]), variables["batch_stats"]["running_var"])


@pytest.mark.parametrize("norm", ["SyncBN", "GN"])
def test_a_norms_gradient_equals_jax(norm):
    """The train-mode output and the gradient of its sum against a random
    cotangent with respect to the input, the scale and the bias: SyncBN's
    through the batch's mean and variance, GN's through each group's."""
    r = np.random.RandomState(2)
    x = (r.randn(3, 5, 7, 64) * 2 + 0.5).astype(np.float32)
    cot = r.randn(*x.shape).astype(np.float32)
    params = {"weight": r.uniform(0.5, 1.5, 64).astype(np.float32),
              "bias": r.uniform(-0.1, 0.1, 64).astype(np.float32)}
    if norm == "SyncBN":
        jm, ours, mode = JaxSyncBatchNorm(64), SyncBatchNorm(64), updating_running_state
        stats = {"batch_stats": {"running_mean": np.zeros(64, np.float32), "running_var": np.ones(64, np.float32)}}
        apply = lambda p, a: jm.apply({"params": p, **stats}, a, mutable=["batch_stats"])[0]  # noqa: E731
    else:
        jm, ours, mode = JaxGroupNorm32(64), GroupNorm32(64), lambda _: contextlib.nullcontext()
        apply = lambda p, a: jm.apply({"params": p}, a)  # noqa: E731
    want = np.asarray(apply(params, jnp.asarray(x)))
    want_grads, want_dx = jax.grad(lambda p, a: jnp.sum(apply(p, a) * cot), argnums=(0, 1))(params, jnp.asarray(x))
    ours.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}, strict=False)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    with mode(ours):
        got = ours(xt).permute(0, 2, 3, 1)
    (got * torch.from_numpy(cot)).sum().backward()
    pairs = [("output", got.detach(), want), ("input", xt.grad.permute(0, 2, 3, 1), want_dx)]
    pairs += [(k, getattr(ours, k).grad, want_grads[k]) for k in ("weight", "bias")]
    for name, g, w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=OUT_ATOL * np.abs(w).max(), err_msg=name)


def test_precise_bn_is_the_mean_of_the_batches_statistics_as_jax():
    """`update_bn_stats` over three batches from one starting state: JAX's
    inverted-EMA mean, and the batches' own biased statistics averaged."""
    r = np.random.RandomState(1)
    batches = [(r.randn(2, 4, 4, 8) * (i + 1) + i).astype(np.float32) for i in range(3)]
    jm = JaxSyncBatchNorm(8)
    variables = {"params": {"weight": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)},
                 "batch_stats": {"running_mean": r.uniform(-0.1, 0.1, 8).astype(np.float32),
                                 "running_var": r.uniform(0.5, 1.5, 8).astype(np.float32)}}
    want = jax_update_bn_stats(lambda v, b: jm.apply(v, jnp.asarray(b), mutable=["batch_stats"]), variables, batches)
    ours = SyncBatchNorm(8)
    ours.load_state_dict({k: torch.from_numpy(v) for d in variables.values() for k, v in d.items()})
    got = update_bn_stats(ours, lambda b: ours(torch.from_numpy(b).permute(0, 3, 1, 2)), batches)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want["batch_stats"][k]), rtol=0, atol=STAT_ATOL)
        np.testing.assert_array_equal(getattr(ours, k).numpy(), variables["batch_stats"][k])  # left as it was
    own_mean = np.mean([b.mean(axis=(0, 1, 2)) for b in batches], axis=0)
    own_var = np.mean([b.var(axis=(0, 1, 2)) for b in batches], axis=0)
    np.testing.assert_allclose(got["running_mean"].numpy(), own_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["running_var"].numpy(), own_var, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm", ["FrozenBN", "BN", "", "GN", "SyncBN"])
def test_make_norm_builds_what_jax_builds(norm):
    """"BN" and "" are FrozenBN in JAX; GroupNorm32 has moved to
    models/backbone/batch_norm.py and the semantic head imports it there."""
    want = type(jax_resnet._make_norm(norm, 16, jnp.float32, "n")).__name__
    got = make_norm(norm, 16)
    assert {"FrozenBatchNorm": FrozenBatchNorm2d, "GroupNorm32": GroupNorm32,
            "SyncBatchNorm": SyncBatchNorm}[want] is type(got)
    assert SemSegGroupNorm32 is GroupNorm32


# ---------------- the Mask R-CNN with the norms, a step against JAX ----------------
def _cfgs():
    ours, ref = get_cfg(), jax_get_cfg()
    for c in (ours, ref):
        c.merge_from_list(SOLVER)
    return ours, ref


def norm_step_runs(norm):
    """Two steps of JAX's `make_train_step` on `BATCH_FULL` (with diamond
    canvases) from the filled variables, and of the port's `Trainer` from
    the converted ones with JAX's draws, in float32 and in float64; each
    step starts all three from JAX's state before it."""
    kw = norm_model_kw(norm)
    jb = BATCH_FULL._replace(gt_masks=jnp.asarray(diamond_canvases(BATCH_FULL)))
    model = JaxFPNRCNN(**kw)
    variables = filled_variables(model, jb, seed=5)
    cfg, jcfg = _cfgs()
    optimizer = jax_build_optimizer(jcfg, split_batch_stats(variables)[0])
    step = make_train_step(model, optimizer, enable_caption=False, lr_schedule=jax_build_lr_schedule(jcfg),
                           donate=False)
    state = TrainState.create(variables, optimizer)
    trainers = {}
    for dtype in (torch.float32, torch.float64):
        ours = FPNRCNN(**kw, dtype=dtype)
        ours.load_state_dict(convert_jax_params(variables), strict=True)
        ours.to(dtype)
        trainers[dtype] = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(cfg)), enable_caption=False)
    tb = torch_batch(jb, gt_masks=torch.from_numpy(np.array(jb.gt_masks)))
    rows = []
    for i in range(2):
        rng = jax.random.PRNGKey(60 + i)
        before = convert_jax_params(state.params)
        state, want = step(state, jb, rng)
        out = {}
        for dtype, trainer in trainers.items():
            trainer.model.load_state_dict(before)  # both from JAX's state before the step
            batch = tb._replace(image=tb.image.to(dtype), gt_boxes=tb.gt_boxes.to(dtype))
            out[dtype] = (trainer.train_step(batch, supervised_draw(rng)),
                          {k: v.clone() for k, v in trainer.model.state_dict().items()})
        rows.append((before, out[torch.float32][1], out[torch.float64][1], convert_jax_params(state.params), want,
                     out[torch.float32][0]))
    return dict(norm=norm, rows=rows, model=trainers[torch.float32].model, variables=variables)


# the GN model's program is in test_torch_port_norms_gn.py: one JAX program a file
@pytest.fixture(scope="module", params=["SyncBN"])
def norm_runs(request):
    return norm_step_runs(request.param)


def assert_norm_steps_equal_jax(norm_runs):
    """Both steps' five losses (loss_mask among them) and the state after
    each: every parameter and, for SyncBN, every running statistic."""
    for i, (before, got_state, f64_state, want_state, want, got) in enumerate(norm_runs["rows"]):
        names = {k for k in want if k.startswith("loss_")}
        assert names == {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "loss_mask"} and names <= set(got)
        for k in names:
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, err_msg=f"step {i} {k}")
        params = [k for k, _ in norm_runs["model"].named_parameters()]
        port = update_apart(before, got_state, f64_state)
        port_params, jax_params = (update_apart(before, s, f64_state, params) for s in (got_state, want_state))
        assert port < F64_RTOL and port_params < jax_params, (i, port, port_params, jax_params)
        assert update_apart(before, got_state, want_state) < JAX_RTOL
    stats = running_state(norm_runs["model"])
    if norm_runs["norm"] == "SyncBN":  # tower, FPN, box and mask heads all hold running statistics
        assert any(k.startswith("backbone.bottom_up.") for k in stats)
        assert any(".fpn_" in k for k in stats) and any("box_head" in k for k in stats)
        assert any("mask_head" in k for k in stats)
        first = norm_runs["rows"][0]
        assert all(not torch.equal(first[0][k], first[1][k].float()) for k in stats)  # every statistic moved
    else:
        assert not stats


def test_norm_mask_rcnn_steps_equal_jax(norm_runs):
    assert_norm_steps_equal_jax(norm_runs)


def test_eval_reads_the_running_state_and_moves_nothing(norm_runs):
    """Inference (and any forward outside the mutable apply) normalizes by
    the running statistics and leaves them; a train-mode forward moves them."""
    model = norm_runs["model"]
    tb = torch_batch(make_batch(1, 96, 160, [[96, 160]], [[96, 160]], seed=7))
    before = {k: v.clone() for k, v in running_state(model).items()}
    model.inference(tb)
    assert all(torch.equal(before[k], v) for k, v in running_state(model).items())


# ---------------- the frozen set ----------------
@pytest.mark.parametrize("norm, freeze_at", [("GN", 2), ("SyncBN", 2), ("GN", 0)])
def test_the_trainable_set_is_jax_trainable_mask(norm, freeze_at):
    """GN's and SyncBN's weight and bias train (JAX freezes a norm whose
    running statistics are parameters: FrozenBN's, which are buffers here);
    FREEZE_AT does not reach the plain tower; the scratch recipes' 0 either."""
    kw = norm_model_kw(norm)
    jb = BATCH_A._replace(gt_masks=jnp.asarray(diamond_canvases(BATCH_A)))
    shapes = jax.eval_shape(lambda r, b: JaxFPNRCNN(**kw).init({"params": r}, b, r, method=JaxFPNRCNN(**kw).init_all),
                            jax.random.PRNGKey(0), jb)
    diff = split_batch_stats(shapes)[0]
    mask = trainable_mask(diff, freeze_at=freeze_at, use_text_emb=False)
    as_arrays = jax.tree_util.tree_map(lambda m, s: np.full(s.shape, m, np.float32), mask, diff)
    want = {k for k, v in convert_jax_params(as_arrays).items() if v.numel() and bool(v.flatten()[0])}
    ours = FPNRCNN(**kw)
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.BACKBONE.FREEZE_AT", str(freeze_at)])
    build_optimizer(ours, solver_config_from_cfg(cfg))
    got = {n for n, p in ours.named_parameters() if p.requires_grad}
    assert got == want
    assert any(n.endswith("norm.weight") for n in got) and all(p.requires_grad for p in ours.parameters())


# ---------------- save and resume ----------------
def test_the_running_state_is_saved_and_restored(tmp_path):
    """A step moves the running statistics; the save holds them (buffers)
    and a fresh model restores them bit for bit, as the optimizer's state."""
    kw = norm_model_kw("SyncBN")
    ours = FPNRCNN(**kw)
    trainer = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(get_cfg())), enable_caption=False,
                      generator=torch.Generator().manual_seed(0))
    tb = torch_batch(BATCH_A, gt_masks=torch.from_numpy(diamond_canvases(BATCH_A)))
    start = {k: v.clone() for k, v in running_state(ours).items()}
    trainer.train_step(tb)
    ckpt = DetectionCheckpointer(str(tmp_path))
    ckpt.save("model_0000000", trainer)
    fresh = FPNRCNN(**kw)
    again = Trainer(fresh, build_optimizer(fresh, solver_config_from_cfg(get_cfg())), enable_caption=False)
    ckpt.resume_or_load("", again)
    assert again.iteration == 1
    for k, v in running_state(ours).items():
        assert not torch.equal(v, start[k]) and torch.equal(running_state(fresh)[k], v), k


# ---------------- the detectron2 files ----------------
def _like(tree, ref):
    """`tree` cut to the keys of `ref`: what flax's apply reads of a loaded
    tree (JAX's converter adds keys no module reads)."""
    return {k: _like(tree[k], v) if isinstance(v, dict) else tree[k] for k, v in ref.items()}


def _d2_names(state):
    """The port's state dict as detectron2 writes the same model (the
    port's names are detectron2's), fc1 in CHW order as JAX's loader reads it."""
    from cddmsl_torch.checkpoint.convert_torch import fc1_from_chw

    sd = {k: v.clone() for k, v in state.items()}
    fc1 = "roi_heads.box_head.fc1.weight"
    c, r = 16, 7  # the last box conv's width, the pool
    hwc = sd[fc1].reshape(sd[fc1].shape[0], r, r, c)
    sd[fc1] = hwc.permute(0, 3, 1, 2).reshape(sd[fc1].shape[0], -1)
    assert torch.equal(fc1_from_chw(sd[fc1], c, r), state[fc1])
    return sd


@pytest.mark.parametrize("norm", ["GN", "SyncBN"])
def test_a_norm_d2_fpn_file_loads_as_jax_loads_it(tmp_path, norm):
    """A detectron2 file of the model with every tensor random: the port's
    load equals JAX's `load_rcnn_weights` read through its modules. The
    tower's norms load whole but for SyncBN's running statistics; of a
    head's norm only the bias, and only where JAX names it as its module
    (GN's box and mask heads; the FPN's under either norm)."""
    kw = norm_model_kw(norm)
    jb = BATCH_A._replace(gt_masks=jnp.asarray(diamond_canvases(BATCH_A)))
    variables = filled_variables(JaxFPNRCNN(**kw), jb, seed=8)
    ours = FPNRCNN(**kw)
    ours.load_state_dict(convert_jax_params(variables), strict=True)
    g = torch.Generator().manual_seed(3)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in _d2_names(ours.state_dict()).items()}
    path = tmp_path / "d2.pth"
    torch.save({"model": sd}, path)
    assert load_rcnn_weights(ours, str(path)) == "d2_fpn"
    loaded = jax_load_rcnn_weights({"params": variables["params"]}, str(path))
    want = convert_jax_params({**variables, "params": _like(loaded["params"], variables["params"])})
    got = ours.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    norms = [k for k in got if ".norm." in k]
    taken = {k for k in norms if torch.equal(got[k], sd[k])}
    assert any("bottom_up" in k for k in taken) and any(k.endswith("fpn_lateral2.norm.bias") for k in taken)
    assert not any(k.endswith(("running_mean", "running_var")) for k in taken)
    assert not any(".fpn_" in k and k.endswith("norm.weight") for k in taken)
    assert any("box_head" in k for k in taken) == (norm == "GN")


# ---------------- world 2 under gloo ----------------
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_step(rank, world, port, out):
    from cddmsl_torch.parallel import comm

    torch.set_num_threads(1)
    comm.initialize("gloo", f"tcp://localhost:{port}", world, rank, device="cpu")
    try:
        torch.manual_seed(0)
        model = FPNRCNN(**norm_model_kw("SyncBN"))
        from cddmsl_torch.checkpoint.convert_jax import init_random_
        init_random_(model, torch.Generator().manual_seed(4))
        trainer = Trainer(model, build_optimizer(model, solver_config_from_cfg(_cfgs()[0])), enable_caption=False)
        tb = torch_batch(BATCH_A, gt_masks=torch.from_numpy(diamond_canvases(BATCH_A)))
        lo, hi = comm.local_rows(tb.image.shape[0])
        mine = type(tb)(*(None if f is None else f[lo:hi] for f in tb))
        draw = supervised_draw(jax.random.PRNGKey(70))
        losses = trainer.train_step(mine, draw)
        if rank == 0:
            torch.save({"state": model.state_dict(), "losses": {k: v.item() for k, v in losses.items()}}, out)
    finally:
        comm.destroy()


def test_world_2_under_gloo_equals_world_1(tmp_path):
    """Two CPU ranks, each stepping its image of batch A: SyncBN's
    statistics are the global batch's (the ranks' mean of mean and mean of
    squares), so the running statistics and the parameters after the step
    equal one process's on the whole batch, as do the losses' rank mean
    (rank 0's own losses are its share)."""
    out = tmp_path / "rank0.pt"
    mp.start_processes(_rank_step, args=(2, _free_port(), str(out)), nprocs=2, join=True, start_method="spawn")
    torch.manual_seed(0)
    model = FPNRCNN(**norm_model_kw("SyncBN"))
    from cddmsl_torch.checkpoint.convert_jax import init_random_
    init_random_(model, torch.Generator().manual_seed(4))
    trainer = Trainer(model, build_optimizer(model, solver_config_from_cfg(_cfgs()[0])), enable_caption=False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tb = torch_batch(BATCH_A, gt_masks=torch.from_numpy(diamond_canvases(BATCH_A)))
    trainer.train_step(tb, supervised_draw(jax.random.PRNGKey(70)))
    world2 = torch.load(out)["state"]
    assert update_apart(before, world2, model.state_dict()) < WORLD_RTOL
    for k in running_state(model):
        np.testing.assert_allclose(world2[k].numpy(), model.state_dict()[k].numpy(), rtol=0, atol=STAT_ATOL, err_msg=k)
