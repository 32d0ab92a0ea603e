"""The port's training path against cddmsl_tpu on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port, in float32. Random draws: the port's
samplers take their uniforms as arguments, and these tests hand them the
uniforms that jax.random gives the JAX function, rebuilt from the same key
tree (`_jax_draws`).

Tolerances, and why:
- matcher, samplers, label-and-sample: exactly equal masks, indices and
  labels (integer decisions on the same float32 IoUs and uniforms);
- RPN and Fast R-CNN losses, InfoNCE: rtol 1e-5 (float32 sums taken in
  another order);
- ClipCap mapper and projector: rtol 1e-4, atol 1e-5 (float32 matmuls of
  width 768 and LayerNorm statistics summed in another order);
- bicubic preprocess: atol 1e-5 on [0, 1] pixels, 1e-4 after the CLIP
  normalization divides by ~0.27 (float32 weight sums and matmuls);
- the whole tiny step, batch 2, past burn-up: the 7 losses within rtol 1e-4
  (the backbone's convolutions sum in another order and RoIAlign, res5 and
  the attention pool carry that through); every trainable gradient within
  1e-3 of that parameter's largest |gradient| (the relative differences of
  the forward grow through the backward); the parameters after one
  `make_train_step` step within atol 1e-6 (the update is lr = 0.002 times
  the clipped gradient, so a 1e-3 relative gradient difference moves a
  parameter by far less); frozen parameters bit-for-bit unchanged.

The JAX step is built and jitted once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _flagship_cfg, _synthetic_batch
from cddmsl_tpu.engine import TrainState, make_train_step
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.clipcap import Projector as JaxProjector
from cddmsl_tpu.models.clipcap import TransformerMapper as JaxTransformerMapper
from cddmsl_tpu.models.fast_rcnn import fast_rcnn_losses as jax_fast_rcnn_losses
from cddmsl_tpu.models.matcher import Matcher as JaxMatcher
from cddmsl_tpu.models.rcnn import GeneralizedRCNN as JaxGeneralizedRCNN
from cddmsl_tpu.models.rcnn import infonce_bidirectional as jax_infonce
from cddmsl_tpu.models.rpn import RPN as JaxRPN
from cddmsl_tpu.models.sampling import gather_selected as jax_gather_selected
from cddmsl_tpu.models.sampling import subsample_labels as jax_subsample_labels
from cddmsl_tpu.ops.box_regression import Box2BoxTransform as JaxBox2Box
from cddmsl_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_tpu.solver.build import trainable_mask
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params, init_random_
from cddmsl_torch.config import flagship_config, flagship_solver_config
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.entry import synthetic_batch, train_entry
from cddmsl_torch.models.build import build_model
from cddmsl_torch.models.clipcap import Projector, TransformerMapper
from cddmsl_torch.models.fast_rcnn import fast_rcnn_losses
from cddmsl_torch.models.matcher import Matcher
from cddmsl_torch.models.rcnn import DetBatch, infonce_bidirectional
from cddmsl_torch.models.rpn import RPN
from cddmsl_torch.models.sampling import gather_selected, subsample_labels
from cddmsl_torch.ops.box_regression import Box2BoxTransform
from cddmsl_torch.ops.resize import resize_bicubic
from cddmsl_torch.solver.build import Optimizer, build_lr_schedule, build_optimizer
from test_torch_port_backbone import fill_params, jax_param_shapes

torch.set_num_threads(1)

B, H, W, G = 2, 128, 160, 8
LOSS_NAMES = ("loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "cont_loss", "kd_loss", "cont_loss_region")


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_boxes(r, shape, w=160.0, h=128.0):
    x1, y1 = r.rand(*shape) * w * 0.7, r.rand(*shape) * h * 0.7
    bw, bh = 4 + r.rand(*shape) * w * 0.5, 4 + r.rand(*shape) * h * 0.5
    return np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)


def _replay(draws):
    """A `Draw` that hands out prepared arrays by site, checking the shape
    the model asks for."""

    def draw(site, shape):
        arr = draws[site]
        assert tuple(arr.shape) == tuple(shape), (site, arr.shape, shape)
        return _t(arr)

    return draw


def _jax_draws(rng, b, n_anchors, n_proposals, n_gt):
    """The uniforms that `cddmsl_losses(rng)` draws, from the same key tree:
    split(rng, 3) -> (k_sup, k_roi, k_region); RPN split(k_sup, B) then
    split(key) -> uniform(k1), uniform(k2); RoI heads split(k_roi, B), then
    k1, k2 = split(key), subsample_labels(k1) as above and uniform(k2);
    region boxes split(k_region, B) -> uniform(key)."""
    k_sup, k_roi, k_region = jax.random.split(rng, 3)
    out = {name: [] for name in ("rpn_pos", "rpn_neg", "roi_pos", "roi_neg", "roi_gather", "region")}
    n_roi = n_proposals + n_gt
    for key in jax.random.split(k_sup, b):
        k1, k2 = jax.random.split(key)
        out["rpn_pos"].append(jax.random.uniform(k1, (n_anchors,)))
        out["rpn_neg"].append(jax.random.uniform(k2, (n_anchors,)))
    for key in jax.random.split(k_roi, b):
        k1, k2 = jax.random.split(key)
        ka, kb = jax.random.split(k1)
        out["roi_pos"].append(jax.random.uniform(ka, (n_roi,)))
        out["roi_neg"].append(jax.random.uniform(kb, (n_roi,)))
        out["roi_gather"].append(jax.random.uniform(k2, (n_roi,)))
    for key in jax.random.split(k_region, b):
        out["region"].append(jax.random.uniform(key, (n_proposals,)))
    return {k: np.stack([np.asarray(a) for a in v]) for k, v in out.items()}


def _torch_batch(jb):
    return DetBatch(*(None if f is None else _t(f) for f in (
        jb.image, jb.image_sizes, jb.orig_sizes, jb.gt_boxes, jb.gt_classes, jb.gt_valid, jb.image_trgt)))


# ---------------- matcher and samplers ----------------
@pytest.mark.parametrize("low_quality", [True, False])
def test_matcher_equals_jax(low_quality):
    r = np.random.RandomState(0)
    iou = np.round(r.rand(3, 5, 200) * 8).astype(np.float32) / 8  # many ties
    valid = r.rand(3, 5) > 0.3
    valid[2] = False  # an image without ground truth
    thresholds, labels = ((0.3, 0.7), (0, -1, 1)) if low_quality else ((0.5,), (0, 1))
    ref = JaxMatcher(thresholds, labels, allow_low_quality_matches=low_quality)
    idx, lab = Matcher(thresholds, labels, allow_low_quality_matches=low_quality)(_t(iou), _t(valid))
    for i in range(3):
        want_idx, want_lab = ref(jnp.asarray(iou[i]), jnp.asarray(valid[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(lab[i].numpy(), np.asarray(want_lab))
    assert (lab[2] == 0).all()


@pytest.mark.parametrize("n_pos", [0, 3, 40])
def test_samplers_equal_jax(n_pos, monkeypatch):
    """subsample_labels and gather_selected with the JAX uniforms, including
    a quota larger than the group, an empty group and tied keys."""
    r = np.random.RandomState(n_pos)
    n = 300
    positive = np.zeros(n, bool)
    positive[r.choice(n, n_pos, replace=False)] = True
    negative = ~positive & (r.rand(n) > 0.5)
    key = jax.random.PRNGKey(n_pos)
    want_pos, want_neg = jax_subsample_labels(key, jnp.asarray(positive), jnp.asarray(negative), 64, 0.25)
    k1, k2 = jax.random.split(key)
    u_pos, u_neg = (np.asarray(jax.random.uniform(k, (n,))) for k in (k1, k2))
    pos, neg = subsample_labels(_t(positive), _t(negative), 64, 0.25, _t(u_pos), _t(u_neg))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(want_neg))

    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(100 + n_pos), (n,))).copy()
    u[:20] = u[20]  # ties: the stable order keeps the lower index
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    for capacity in (64, 400):
        want_idx, want_valid = jax_gather_selected(None, want_pos, want_neg, capacity)
        idx, valid = gather_selected(pos, neg, capacity, _t(u))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


# ---------------- losses ----------------
def test_rpn_losses_equal_jax():
    r = np.random.RandomState(1)
    rpn = RPN(in_channels=16, batch_size_per_image=64)
    anchors = torch.as_tensor(_random_boxes(r, (600,), 200, 200))
    logits = (r.randn(2, 600) * 3).astype(np.float32)
    deltas = (r.randn(2, 600, 4) * 0.3).astype(np.float32)
    gt = _random_boxes(r, (2, 5), 200, 200)
    gv = np.array([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0]], bool)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want = JaxRPN(in_channels=16, batch_size_per_image=64).apply(
        {"params": {}}, jnp.asarray(anchors.numpy()), jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(gt),
        jnp.asarray(gv), keys, method=JaxRPN._losses,
    )
    pairs = [jax.random.split(k) for k in keys]
    draws = {
        "rpn_pos": np.stack([np.asarray(jax.random.uniform(p[0], (600,))) for p in pairs]),
        "rpn_neg": np.stack([np.asarray(jax.random.uniform(p[1], (600,))) for p in pairs]),
    }
    got = rpn._losses(anchors, _t(logits), _t(deltas), _t(gt), _t(gv), _replay(draws))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5)
    assert got["loss_rpn_loc"].item() > 0


@pytest.mark.parametrize("focal", [(None, None), (0.5, 0.2)])
def test_fast_rcnn_losses_equal_jax(focal):
    r = np.random.RandomState(2)
    n, k = 96, 20
    scores = (r.randn(n, k + 1) * 4).astype(np.float32)
    deltas = (r.randn(n, k * 4) * 0.5).astype(np.float32)
    props = _random_boxes(r, (n,))
    gts = props + (r.randn(n, 4) * 3).astype(np.float32)
    classes = r.randint(0, k + 1, n).astype(np.int32)
    valid = r.rand(n) > 0.2
    args = (scores, deltas, props, gts, classes, valid)
    gamma, bg = focal
    want = jax_fast_rcnn_losses(*map(jnp.asarray, args), k, JaxBox2Box((10.0, 10.0, 5.0, 5.0)),
                                focal_gamma=gamma, bg_loss_weight=bg)
    got = fast_rcnn_losses(*map(_t, args), k, Box2BoxTransform((10.0, 10.0, 5.0, 5.0)),
                           focal_gamma=gamma, bg_loss_weight=bg)
    for name in ("loss_cls", "loss_box_reg"):
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-5)


def test_infonce_equals_jax():
    r = np.random.RandomState(3)
    a, b = r.randn(8, 256).astype(np.float32), r.randn(8, 256).astype(np.float32)
    b[:4] = a[:4] + 0.1 * b[:4]
    np.testing.assert_allclose(
        infonce_bidirectional(_t(a), _t(b)).item(), float(jax_infonce(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5
    )


# ---------------- ClipCap ----------------
def test_clipcap_mapper_and_projector_equal_jax():
    x = np.random.RandomState(4).randn(3, 128).astype(np.float32)
    mapper = JaxTransformerMapper(dim_clip=128, prefix_length=8, clip_length=8, num_layers=2)
    proj = JaxProjector(in_dim=768)
    mp = fill_params(jax.eval_shape(lambda: mapper.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=6)
    pp = fill_params(jax.eval_shape(lambda: proj.init(jax.random.PRNGKey(0), jnp.zeros((1, 768)))), seed=7)
    want_tokens = jax.jit(mapper.apply)(mp, jnp.asarray(x))
    want = jax.jit(proj.apply)(pp, want_tokens[:, -1])

    state = convert_jax_params({"v2l_mapper": mp["params"], "projector": pp["params"]})
    ours_mapper = TransformerMapper(dim_clip=128, prefix_length=8, clip_length=8, num_layers=2)
    ours_mapper.load_state_dict({k[len("v2l_mapper."):]: v for k, v in state.items() if k.startswith("v2l_mapper.")})
    ours_proj = Projector(in_dim=768)
    ours_proj.load_state_dict({k[len("projector."):]: v for k, v in state.items() if k.startswith("projector.")})
    with torch.no_grad():
        tokens = ours_mapper(_t(x))
        out = ours_proj(tokens[:, -1])
    assert tokens.shape == (3, 8, 768)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want_tokens), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


# ---------------- bicubic preprocess ----------------
@pytest.mark.parametrize("hw", [(128, 160), (800, 1344), (160, 128)])
def test_bicubic_preprocess_equals_jax(hw):
    """Upsampling (the tiny 128x160 canvas to 224x280), downsampling (the
    800x1344 bucket to 224x376) and a portrait canvas, through the resize
    alone and through `_v2l_preprocess` (crop and normalization)."""
    h, w = hw
    img = (np.random.RandomState(h).rand(1, h, w, 3) * 255).astype(np.float32)
    ref = JaxGeneralizedRCNN(backbone_layers=(1, 1, 1, 1), backbone_width=16, embed_dim=128)
    model = build_model(flagship_config(tiny=True), device="cpu")
    scale = 224 / min(h, w)
    size = (224, max(224, int(round(w * scale)))) if h <= w else (max(224, int(round(h * scale))), 224)
    want = jax.image.resize(jnp.asarray(img / 255.0), (1,) + size + (3,), method="bicubic", antialias=False)
    np.testing.assert_allclose(resize_bicubic(_t(img) / 255.0, size).numpy(), np.asarray(want), rtol=0, atol=1e-5)
    want = ref.apply({"params": {}}, jnp.asarray(img), method=JaxGeneralizedRCNN._v2l_preprocess)
    got = model._v2l_preprocess(_t(img))
    assert got.shape == (1, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# ---------------- configs ----------------
@pytest.mark.parametrize("tiny", [False, True])
def test_training_config_matches_the_jax_cfg(tiny):
    cfg = _flagship_cfg(tiny=tiny)
    ours, solver = flagship_config(tiny=tiny), flagship_solver_config(tiny=tiny)
    ref = jax_build_model(cfg)
    assert ours.rpn_pre_nms_topk_train == ref.rpn_pre_nms_topk[0]
    assert ours.rpn_post_nms_topk_train == ref.rpn_post_nms_topk[0]
    for field in (
        "rpn_batch_size_per_image", "rpn_positive_fraction", "rpn_loss_weight", "roi_batch_size_per_image",
        "roi_positive_fraction", "focal_gamma", "bg_loss_weight", "region_consistency_boxes", "v2l_image_size",
        "v2l_mapper_layers", "v2l_mapper_tokens",
    ):
        assert getattr(ours, field) == pytest.approx(getattr(ref, field)), field
    s = cfg.SOLVER
    assert (solver.base_lr, solver.momentum, solver.weight_decay, solver.gamma) == pytest.approx(
        (s.BASE_LR, s.MOMENTUM, s.WEIGHT_DECAY, s.GAMMA))
    assert tuple(solver.steps) == tuple(s.STEPS)
    assert (solver.warmup_factor, solver.warmup_iters) == (pytest.approx(s.WARMUP_FACTOR), s.WARMUP_ITERS)
    assert (s.WARMUP_METHOD, s.LR_SCHEDULER_NAME) == ("linear", "WarmupMultiStepLR")  # the flagship's schedule
    clip = s.CLIP_GRADIENTS
    assert (clip.ENABLED, clip.CLIP_TYPE, solver.clip_value) == (True, "value", clip.CLIP_VALUE)  # the flagship's clip
    assert (solver.clip_enabled, solver.clip_type) == (clip.ENABLED, clip.CLIP_TYPE)
    assert solver.caption_burnup_iters == s.CAPTION_BURNUP_ITERS and solver.freeze_at == cfg.MODEL.BACKBONE.FREEZE_AT
    schedule, want = build_lr_schedule(solver), jax_build_lr_schedule(cfg)
    for step in (0, 1, 500, 999, 1000, 10001, 29999, 30000, 39999):
        assert schedule(step) == float(want(step)), step


def test_optimizer_steps_like_optax():
    """Two steps of the port's optimizer against the optax chain of
    `build_optimizer` (clip by value, coupled weight decay, momentum, LR):
    the LR is read at the optimizer's own count from 0 (inside the warmup
    here), and gradients beyond the clip value are clamped."""
    r = np.random.RandomState(5)
    cfg = flagship_solver_config()
    p0 = {"a": r.randn(6, 5).astype(np.float32), "b": r.randn(7).astype(np.float32)}
    grads = [{k: (r.randn(*v.shape) * 4).astype(np.float32) for k, v in p0.items()} for _ in range(2)]
    assert max(np.abs(g[k]).max() for g in grads for k in g) > cfg.clip_value  # the clip bites
    schedule = jax_build_lr_schedule(_flagship_cfg())
    chain = optax.chain(optax.clip(cfg.clip_value), optax.add_decayed_weights(cfg.weight_decay),
                        optax.trace(decay=cfg.momentum), optax.scale_by_learning_rate(schedule))
    want = {k: jnp.asarray(v) for k, v in p0.items()}
    state = chain.init(want)
    params = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt = Optimizer(list(params.values()), cfg)
    for g in grads:
        updates, state = chain.update({k: jnp.asarray(v) for k, v in g.items()}, state, want)
        want = optax.apply_updates(want, updates)
        for k, p in params.items():
            p.grad = _t(g[k])
        opt.step()
    assert opt.count == 2
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=0, atol=1e-7)
        assert not np.array_equal(p.detach().numpy(), p0[k])


def test_only_the_training_build_holds_the_caption_modules():
    """Serving leaves out the offline backbone, the ClipCap mapper and the
    projectors; the training build adds exactly those (the image projector
    whatever MODEL.CONSISTENCY_BRANCH, as JAX's tree holds it)."""
    serve = build_model(flagship_config(tiny=True), device="cpu").state_dict()
    train = build_model(flagship_config(tiny=True), device="cpu", training=True).state_dict()
    assert serve.keys() <= train.keys()
    assert {k.split(".")[0] for k in train.keys() - serve.keys()} == {"offline_backbone", "v2l_mapper", "projector",
                                                                      "image_projector"}


def test_caption_branches_are_off_until_burn_up():
    """At iteration <= burn-up the caption losses are zeros and the
    projector, which no loss reaches, still decays (a zero gradient, as
    optax sees it)."""
    solver = flagship_solver_config(tiny=True)
    model = build_model(flagship_config(tiny=True), device="cpu", training=True)
    init_random_(model, torch.Generator().manual_seed(1))
    trainer = Trainer(model, build_optimizer(model, solver), caption_burnup_iters=solver.caption_burnup_iters,
                      iteration=solver.caption_burnup_iters, generator=torch.Generator().manual_seed(0))
    w = model.projector.fc1.weight.detach().clone()
    metrics = trainer.train_step(synthetic_batch(2, 64, 96, device="cpu"))
    assert all(metrics[k].item() == 0.0 for k in ("cont_loss", "kd_loss", "cont_loss_region"))
    assert metrics["loss_cls"].item() > 0
    lr = build_lr_schedule(solver)(0)
    torch.testing.assert_close(model.projector.fc1.weight.detach(), w - lr * solver.weight_decay * w, rtol=0, atol=1e-9)


def test_synthetic_batch_has_every_jax_field():
    want = _synthetic_batch(2, 24, 32, g=5, seed=4)
    got = synthetic_batch(2, 24, 32, g=5, seed=4, device="cpu")
    for name in ("image", "image_sizes", "orig_sizes", "gt_boxes", "gt_classes", "gt_valid", "image_trgt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
        assert getattr(got, name).dtype == _t(getattr(want, name)).dtype, name


def test_train_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CUDA-less refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_entry()


# ---------------- the whole tiny step ----------------
@pytest.fixture(scope="module")
def step_runs():
    cfg = _flagship_cfg(tiny=True)
    model = jax_build_model(cfg)
    jb = _synthetic_batch(B, H, W, g=G, seed=0)
    shapes = jax.eval_shape(
        lambda r, b: model.init({"params": r}, b, r, method=model.init_all), jax.random.PRNGKey(0), jb
    )
    params = fill_params(shapes, seed=5)
    rng = jax.random.PRNGKey(1)
    burnup = cfg.SOLVER.CAPTION_BURNUP_ITERS

    optimizer = jax_build_optimizer(cfg, params)
    state = TrainState.create(params, optimizer).replace(step=jnp.asarray(burnup + 1, jnp.int32))
    step_fn = make_train_step(
        model, optimizer, caption_burnup_iters=burnup, lr_schedule=jax_build_lr_schedule(cfg), donate=False
    )

    def losses_and_grads(p, b, r):
        def total(p):
            losses = model.apply(p, b, r, True, True, True, method=model.cddmsl_losses)
            return sum(losses.values()), losses

        return jax.grad(total, has_aux=True)(p)

    # one program for the gradients and the step, so the module compiles once
    (grads, losses), (new_state, metrics) = jax.jit(
        lambda p, s, b, r: (losses_and_grads(p, b, r), step_fn.__wrapped__(s, b, r))
    )(params, state, jb, rng)
    mask = trainable_mask(params)
    mask_arrays = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, m, np.float32), mask, params)

    a = (H // 16) * (W // 16) * 15
    draws = _jax_draws(rng, B, a, cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN, G)
    tb = _torch_batch(jb)
    solver = flagship_solver_config(tiny=True)

    def fresh():
        ours = build_model(flagship_config(tiny=True), device="cpu", training=True)
        ours.load_state_dict(convert_jax_params(params), strict=True)
        return ours, build_optimizer(ours, solver)

    ours, _ = fresh()
    got_losses = ours.cddmsl_losses(tb, _replay(draws), caption_on=True)
    with torch.enable_grad():
        torch.stack(list(got_losses.values())).sum().backward()
    got_grads = {n: p.grad for n, p in ours.named_parameters() if p.requires_grad}

    ours2, opt2 = fresh()
    before = {k: v.clone() for k, v in ours2.state_dict().items()}
    trainer = Trainer(ours2, opt2, caption_burnup_iters=solver.caption_burnup_iters, iteration=burnup + 1)
    got_metrics = trainer.train_step(tb, _replay(draws))
    return dict(
        shapes=shapes, want_losses=losses, want_grads=convert_jax_params(grads), want_metrics=metrics,
        want_params=convert_jax_params(new_state.params), trainable=convert_jax_params(mask_arrays),
        got_losses=got_losses, got_grads=got_grads, got_metrics=got_metrics, model=ours2, before=before,
        trainer=trainer,
    )


def test_step_losses_equal_jax(step_runs):
    want, got = step_runs["want_losses"], step_runs["got_losses"]
    assert tuple(got) == LOSS_NAMES and set(want) == set(LOSS_NAMES)
    for k in LOSS_NAMES:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=k)
    metrics = step_runs["got_metrics"]
    for k, v in step_runs["want_metrics"].items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=1e-4, err_msg=k)


def test_step_gradients_equal_jax(step_runs):
    want, got = step_runs["want_grads"], step_runs["got_grads"]
    assert len(got) > 20
    # the attention pool's key bias has a zero gradient in exact arithmetic
    # (the softmax ignores a shift shared by all keys): both frameworks give
    # rounding noise of the model's larger gradients there
    floor = 1e-6 * max(np.abs(want[name].numpy()).max() for name in got)
    for name, g in got.items():
        w = want[name].numpy()
        if name.startswith("image_projector."):  # no loss of this step reaches it: zero in JAX, none here
            assert g is None and not w.any(), name
            continue
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=max(1e-3 * scale, floor), err_msg=name)


def test_frozen_parameters_match_the_jax_mask(step_runs):
    trainable = step_runs["trainable"]
    for name, p in step_runs["model"].named_parameters():
        assert p.requires_grad == bool(trainable[name].all()), name
        assert bool(trainable[name].all()) == bool(trainable[name].any()), name


def test_parameters_after_one_step_equal_jax(step_runs):
    want, before = step_runs["want_params"], step_runs["before"]
    trainable = step_runs["trainable"]
    state = step_runs["model"].state_dict()
    assert state.keys() == want.keys()
    moved = 0
    for name, value in state.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
        if bool(trainable[name].any()):
            moved += not torch.equal(value, before[name])
        else:
            assert torch.equal(value, before[name]), f"frozen {name} changed"
    assert moved == sum(p.requires_grad for p in step_runs["model"].parameters())
    assert step_runs["trainer"].iteration == _flagship_cfg(tiny=True).SOLVER.CAPTION_BURNUP_ITERS + 2


def test_jax_param_shapes_equal_eval_shape(step_runs):
    """The shapes the other port tests fill, read off the port's training
    build, are those of `eval_shape` of JAX's `init_all`, leaf for leaf."""
    want, got = step_runs["shapes"], jax_param_shapes(flagship_config(tiny=True))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
