"""MODEL.CONSISTENCY_BRANCH in the port against cddmsl_tpu on the CPU: the
caption model (GPT-2 with its KV-cache decode, the ClipCap mapper, the three
caption losses), the four branch methods of GeneralizedRCNN, the
language-free branch in the step, the pseudo-label step and the trainer.

The same inputs, made with numpy from a seed, go through the JAX function and
its counterpart in the port, in float32, with the JAX weights carried across
(`convert_jax_caption_params`, `convert_jax_params`) and JAX's jax.random
draws replayed into the port's draw sites.

Tolerances, and why:
- GPT-2 and caption-model logits, the cached decode's logits, the three
  caption losses and their gradients with respect to the target prefix:
  atol 1e-5 plus rtol 1e-5 (float32 matmuls and LayerNorm statistics summed
  in another order);
- greedy tokens and `live`: exactly (argmax of those logits, first maximum);
- the branch methods on the tiny flagship: rtol 1e-4, atol 1e-5, as the
  backbone's own tests (the convolutions sum in another order);
- parameters after an "image_region" step and after a "region" pl step:
  atol 1e-6, as the step test of tests/test_torch_port_train.py;
- an HF state dict: the converted tensors bit for bit.

The module compiles one JAX program of steps (the "image_region" step
chained with the pl step) and one of the four branch methods.
"""

import contextlib
import copy
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from __graft_entry__ import _flagship_cfg, _synthetic_batch
from cddmsl_tpu.engine import TrainState, make_caption_pl_step as jax_make_caption_pl_step
from cddmsl_tpu.engine import make_train_step
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models import caption as jax_caption
from cddmsl_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from cddmsl_tpu.models.gpt2 import GPT2LMHead as JaxGPT2LMHead
from cddmsl_tpu.models.gpt2 import convert_hf_gpt2 as jax_convert_hf_gpt2
from cddmsl_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_torch import gen_captions
from cddmsl_torch.checkpoint.convert_jax import convert_jax_caption_params, convert_jax_params, init_random_
from cddmsl_torch.checkpoint.convert_torch import convert_hf_gpt2, load_gpt2
from cddmsl_torch.config import check_supported, flagship_config, flagship_solver_config, get_cfg
from cddmsl_torch.engine.defaults import DefaultTrainer
from cddmsl_torch.engine.train_loop import Trainer, make_caption_pl_step
from cddmsl_torch.models import caption
from cddmsl_torch.models.build import build_model
from cddmsl_torch.models.caption import ClipCaptionModel
from cddmsl_torch.models.gpt2 import GPT2Config
from cddmsl_torch.solver.build import build_optimizer
from test_consistency_branches import _CASES as JAX_BRANCH_LOSSES
from test_torch_port_backbone import fill_params, jax_param_shapes
from test_torch_port_engine import TINY_RECIPE, _tiny_cfg, fixture_root  # noqa: F401 (a fixture)
from test_torch_port_train import _jax_draws, _replay, _torch_batch

torch.set_num_threads(1)

GPT = dict(vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=2)  # tests/test_caption_pl.py's
PREFIX, EMBED, MAX_LEN = 4, 128, 6
B, H, W, G = 2, 64, 96, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), **(tol or TOL))


# ---------------- the caption model ----------------
@pytest.fixture(scope="module")
def captioner():
    jcap = jax_caption.ClipCaptionModel(prefix_length=PREFIX, clip_length=PREFIX, dim_clip=EMBED,
                                        gpt_config=JaxGPT2Config(**GPT))
    shapes = jax.eval_shape(lambda: jcap.init(jax.random.PRNGKey(0), jnp.zeros((1, 3), jnp.int32),
                                              jnp.zeros((1, EMBED))))
    params = jax.tree_util.tree_map(jnp.asarray, fill_params(shapes, seed=3))  # the decode indexes wte by tracers
    ours = ClipCaptionModel(prefix_length=PREFIX, clip_length=PREFIX, dim_clip=EMBED, gpt_config=GPT2Config(**GPT))
    ours.load_state_dict(convert_jax_caption_params(params), strict=True)
    r = np.random.RandomState(0)
    prefix = r.randn(6, EMBED).astype(np.float32)
    tokens = r.randint(0, GPT["vocab_size"], (6, MAX_LEN)).astype(np.int32)
    return jcap, params, ours.eval().requires_grad_(False), prefix, tokens


def _jax_logits(jcap, params, tokens, prefix):
    return np.asarray(jax.jit(jcap.apply)(params, jnp.asarray(tokens), jnp.asarray(prefix)))


def test_teacher_forced_logits_equal_jax(captioner):
    jcap, params, ours, prefix, tokens = captioner
    want = _jax_logits(jcap, params, tokens, prefix)
    got = ours(torch.from_numpy(tokens).long(), torch.from_numpy(prefix))
    assert got.shape == (6, PREFIX + MAX_LEN, GPT["vocab_size"])
    _close(got, want)
    # GPT-2 alone, on embeddings, beside the caption model's slice
    emb = np.random.RandomState(1).randn(2, 9, GPT["n_embd"]).astype(np.float32)
    want_gpt, _ = JaxGPT2LMHead(JaxGPT2Config(**GPT)).apply({"params": params["params"]["gpt"]}, jnp.asarray(emb))
    _close(ours.gpt(torch.from_numpy(emb))[0], want_gpt)
    _close(ours.token_logits(torch.from_numpy(tokens).long(), torch.from_numpy(prefix)), want[:, PREFIX - 1 : -1])


def test_cached_decode_equals_teacher_forcing(captioner):
    """prefill + decode_step over the preallocated cache give, step by
    step, JAX's teacher-forced logits of the same tokens."""
    jcap, params, ours, prefix, tokens = captioner
    want = _jax_logits(jcap, params, tokens, prefix)
    tok = torch.from_numpy(tokens).long()
    logits, caches = ours.prefill(ours.map_prefix(torch.from_numpy(prefix)), PREFIX + MAX_LEN)
    assert caches[0]["k"].shape == (6, PREFIX + MAX_LEN, GPT["n_head"], GPT["n_embd"] // GPT["n_head"])
    _close(logits, want[:, PREFIX - 1])
    for i in range(MAX_LEN - 1):
        logits, caches = ours.decode_step(tok[:, i], PREFIX + i, caches)
        _close(logits, want[:, PREFIX + i])


def test_greedy_generate_equals_jax_token_for_token(captioner):
    """With the "." stop token, and with a stop token these random weights
    emit mid-sequence in some rows, so that stopped rows are exercised."""
    jcap, params, ours, prefix, _ = captioner
    max_len = 12
    assert caption.STOP_TOKEN == jax_caption.STOP_TOKEN
    for stop in (caption.STOP_TOKEN, 56):
        want_tok, want_live = jax_caption.generate(jcap, params, jnp.asarray(prefix), max_len=max_len,
                                                   stop_token=stop)
        got_tok, got_live = caption.generate(ours, torch.from_numpy(prefix), max_len=max_len, stop_token=stop)
        np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
        np.testing.assert_array_equal(got_live.numpy(), np.asarray(want_live))
        assert (got_tok[~got_live] == stop).all()
    # some rows stopped and others did not
    assert (~got_live).any() and got_live[:, -1].any(), got_tok


def test_top_p_samples_lie_in_the_nucleus(captioner):
    logits = torch.from_numpy(np.random.RandomState(2).randn(5, GPT["vocab_size"]).astype(np.float32) * 3)
    gen = torch.Generator().manual_seed(0)
    for top_p in (0.3, 0.8, 0.95):
        probs = torch.softmax(logits, -1)
        for _ in range(50):
            tok = caption._sample(logits, top_p, gen)
            # the smallest set of the most probable tokens whose mass reaches top_p
            p_tok = probs.gather(1, tok[:, None])[:, 0]
            above = (probs * (probs > p_tok[:, None])).sum(1)
            assert (above < top_p + 1e-6).all(), (top_p, tok)
    ours, prefix = captioner[2], torch.from_numpy(captioner[3])
    a = caption.generate(ours, prefix, max_len=8, top_p=0.8, generator=torch.Generator().manual_seed(1))
    b = caption.generate(ours, prefix, max_len=8, top_p=0.8, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert ((a[0] >= 0) & (a[0] < GPT["vocab_size"])).all()


@pytest.mark.parametrize("which", ["caption_loss", "pseudo_label", "kl"])
def test_caption_losses_and_target_gradients_equal_jax(captioner, which):
    jcap, params, ours, prefix, tokens = captioner
    src, trgt = prefix[:3], prefix[3:]
    mask = (np.arange(MAX_LEN)[None] < np.array([[6], [2], [0]])).astype(np.float32)
    if which == "caption_loss":
        def jax_fn(pt):
            return jcap.apply(params, jnp.asarray(tokens[:3]), pt, jnp.asarray(mask), method=jcap.caption_loss)

        def port_fn(pt):
            return ours.caption_loss(torch.from_numpy(tokens[:3]).long(), pt, torch.from_numpy(mask))
    else:
        jf = jax_caption.pseudo_labeling_loss if which == "pseudo_label" else jax_caption.unsupervised_kl_loss
        pf = caption.pseudo_labeling_loss if which == "pseudo_label" else caption.unsupervised_kl_loss

        def jax_fn(pt):
            return jf(jcap, params, jnp.asarray(src), pt, max_len=MAX_LEN)

        def port_fn(pt):
            return pf(ours, torch.from_numpy(src), pt, max_len=MAX_LEN)

    want, want_grad = jax.jit(jax.value_and_grad(jax_fn))(jnp.asarray(trgt))
    pt = torch.from_numpy(trgt).requires_grad_(True)
    with torch.enable_grad():
        got = port_fn(pt)
        (grad,) = torch.autograd.grad(got, pt)
    assert float(want) > 0
    _close(got, want)
    _close(grad, want_grad)
    assert np.abs(np.asarray(want_grad)).max() > 0


@pytest.mark.parametrize("prefixed", [True, False])
def test_hf_gpt2_state_dict_through_both_converters(captioner, prefixed):
    """An HF GPT2LMHeadModel state dict (with HF's mask buffers and the tied
    lm_head) into JAX's `convert_hf_gpt2` and into the port's: the same
    tensors, and the same logits."""
    jcap, params, ours, _, _ = captioner
    r = np.random.RandomState(4)
    e, v = GPT["n_embd"], GPT["vocab_size"]
    sd = {"wte.weight": r.randn(v, e) * 0.1, "wpe.weight": r.randn(GPT["n_positions"], e) * 0.05,
          "ln_f.weight": r.uniform(0.5, 1.5, e), "ln_f.bias": r.randn(e) * 0.1}
    for i in range(GPT["n_layer"]):
        for name, shape in (("ln_1.weight", (e,)), ("ln_1.bias", (e,)), ("ln_2.weight", (e,)), ("ln_2.bias", (e,)),
                            ("attn.c_attn.weight", (e, 3 * e)), ("attn.c_attn.bias", (3 * e,)),
                            ("attn.c_proj.weight", (e, e)), ("attn.c_proj.bias", (e,)),
                            ("mlp.c_fc.weight", (e, 4 * e)), ("mlp.c_fc.bias", (4 * e,)),
                            ("mlp.c_proj.weight", (4 * e, e)), ("mlp.c_proj.bias", (e,))):
            sd[f"h.{i}.{name}"] = r.randn(*shape) * (0.2 if "weight" in name else 0.05)
        sd[f"h.{i}.attn.bias"] = np.tril(np.ones((GPT["n_positions"],) * 2))[None, None]
        sd[f"h.{i}.attn.masked_bias"] = np.asarray(-1e4)
    sd = {k: np.asarray(val, np.float32) for k, val in sd.items()}
    if prefixed:
        sd = {"transformer." + k: val for k, val in sd.items()}
        sd["lm_head.weight"] = sd["transformer.wte.weight"]
    torch_sd = {k: torch.from_numpy(val) for k, val in sd.items()}
    want = convert_jax_caption_params({"clip_project": params["params"]["clip_project"],
                                       "gpt": jax_convert_hf_gpt2(sd)["params"]})
    assert want.keys() == ours.state_dict().keys()
    got = ClipCaptionModel(prefix_length=PREFIX, clip_length=PREFIX, dim_clip=EMBED, gpt_config=GPT2Config(**GPT))
    got.load_state_dict(ours.state_dict())
    load_gpt2(got.gpt, torch_sd)
    state = got.state_dict()
    assert state.keys() == want.keys()
    for k, val in want.items():
        assert torch.equal(state[k], val), k
    assert set(convert_hf_gpt2(torch_sd)) == {k[len("gpt."):] for k in want if k.startswith("gpt.")}
    emb = np.random.RandomState(5).randn(2, 7, e).astype(np.float32)
    want_logits, _ = JaxGPT2LMHead(JaxGPT2Config(**GPT)).apply(jax_convert_hf_gpt2(sd), jnp.asarray(emb))
    _close(got.gpt(torch.from_numpy(emb))[0], want_logits)


# ---------------- the detector's branches and the steps ----------------
@pytest.fixture(scope="module")
def jax_loss_names(tiny_jax):
    """{kd: the names of JAX's `cddmsl_losses`} (traced, not compiled)."""
    _, model, jb, params = tiny_jax
    return {kd: set(jax.eval_shape(
        lambda p, b, r: model.apply(p, b, r, jnp.asarray(False), kd, True, method=model.cddmsl_losses),
        params, jb, jax.random.PRNGKey(0))) for kd in (False,)}


@pytest.fixture(scope="module")
def tiny_jax():
    cfg = _flagship_cfg(tiny=True)
    model = jax_build_model(cfg)
    jb = _synthetic_batch(B, H, W, g=G, seed=0)
    return cfg, model, jb, fill_params(jax_param_shapes(flagship_config(tiny=True)), seed=5)


def _port_model(params):
    ours = build_model(flagship_config(tiny=True), device="cpu", training=True)
    ours.load_state_dict(convert_jax_params(params), strict=True)
    return ours


def _region_draws(key, site, n=B, k=None):
    k = k or _flagship_cfg(tiny=True).MODEL.RPN.POST_NMS_TOPK_TRAIN
    return {site: np.stack([np.asarray(jax.random.uniform(kk, (k,))) for kk in jax.random.split(key, n)])}


def test_branch_methods_equal_jax(tiny_jax):
    cfg, model, jb, params = tiny_jax
    r1, r2 = jax.random.PRNGKey(7), jax.random.PRNGKey(8)

    def branches(p, b):
        return (model.apply(p, b, method=model.image_consistency),
                model.apply(p, b, r1, method=model.image_consistency_region),
                model.apply(p, b, method=model.caption_pl_prefixes),
                model.apply(p, b, r2, method=model.caption_pl_region_prefixes))

    img, img_region, pl, pl_region = jax.jit(branches)(params, jb)
    ours = _port_model(params)
    tb = _torch_batch(jb)
    tol = dict(rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        _close(ours.image_consistency(tb)["cont_loss"], img["cont_loss"], **tol)
        got = ours.image_consistency_region(tb, _replay(_region_draws(r1, "image_region")))
        _close(got["cont_loss"], img_region["cont_loss"], **tol)
        for g, w in zip(ours.caption_pl_prefixes(tb), pl):
            assert g.shape == w.shape == (B, EMBED)
            _close(g, w, **tol)
        for g, w in zip(ours.caption_pl_region_prefixes(tb, _replay(_region_draws(r2, "caption_pl_region"))),
                        pl_region):
            assert g.shape == w.shape == (B * cfg.TPU.REGION_CONSISTENCY_BOXES, EMBED)
            _close(g, w, **tol)
    assert set(img) == set(img_region) == {"cont_loss"}


def test_only_the_language_free_branches_build_the_image_projector():
    """Every training build holds the image projector, whatever the branch,
    as JAX's parameter tree does; only the language-free branches train it.
    The serving build leaves it out."""
    training = build_model(flagship_config(tiny=True), device="cpu", training=True)
    assert isinstance(training.image_projector, torch.nn.Module)
    assert not hasattr(build_model(flagship_config(tiny=True), device="cpu"), "image_projector")


@pytest.fixture(scope="module")
def step_runs(tiny_jax, captioner):
    """An "image_region" step at iteration 0 (before burn-up: the branch
    does not wait for it), then a "region" pl step, in JAX (one program)
    and in the port, from the same weights, with a warmup schedule so that
    the LR differs at the optimizer's counts 0 and 1."""
    cfg, model, jb, params = tiny_jax
    jcap, cap_params, cap, _, _ = captioner
    cfg = cfg.clone()
    cfg.SOLVER.WARMUP_ITERS, cfg.SOLVER.WARMUP_FACTOR = 1, 0.1
    optimizer = jax_build_optimizer(cfg, params)
    main = make_train_step(model, optimizer, caption_burnup_iters=cfg.SOLVER.CAPTION_BURNUP_ITERS,
                           lr_schedule=jax_build_lr_schedule(cfg), donate=False, consistency_branch="image_region",
                           consistency_weight=0.1)
    pl = jax_make_caption_pl_step(model, jcap, cap_params, optimizer, level="region", max_len=MAX_LEN,
                                  loss_weight=0.1)
    rng, rng_pl = jax.random.PRNGKey(1), jax.random.PRNGKey(2)

    def chain(s, b):
        s1, m1 = main.__wrapped__(s, b, rng)
        s2, m2 = pl.__wrapped__(s1, b, rng_pl)
        return s1.params, m1, s2.params, m2, s1.opt_state

    p1, m1, p2, m2, opt1 = jax.jit(chain)(TrainState.create(params, optimizer), jb)

    solver = dataclasses.replace(flagship_solver_config(tiny=True), warmup_iters=1, warmup_factor=0.1)
    ours = _port_model(params)
    opt = build_optimizer(ours, solver)
    before = {k: v.clone() for k, v in ours.state_dict().items()}
    trainer = Trainer(ours, opt, caption_burnup_iters=solver.caption_burnup_iters, consistency_branch="image_region",
                      consistency_weight=0.1)
    anchors = (H // 16) * (W // 16) * 15
    k = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN
    draws = {**_jax_draws(rng, B, anchors, k, G), **_region_draws(jax.random.fold_in(rng, 7), "image_region")}
    got_m1 = trainer.train_step(_torch_batch(jb), _replay(draws))
    got_p1 = {k: v.clone() for k, v in ours.state_dict().items()}
    region_save = copy.deepcopy(trainer.state_dict())
    got_m2 = make_caption_pl_step(ours, cap, opt, level="region", max_len=MAX_LEN, loss_weight=0.1)(
        _torch_batch(jb), _replay(_region_draws(rng_pl, "caption_pl_region")))
    return dict(want=(p1, m1, p2, m2), got=(got_p1, got_m1, ours.state_dict(), got_m2), before=before,
                trainer=trainer, schedule=opt.schedule, region_save=(region_save, p1, opt1), draws=draws, cfg=cfg)


def _params_close(got_state, want_params, before, trainable):
    """Every parameter and buffer within 1e-6 of JAX's, the frozen ones
    unchanged bit for bit; returns how many trainable ones moved."""
    want = convert_jax_params(want_params)
    assert got_state.keys() == want.keys()
    moved = 0
    for name, value in got_state.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
        if name in trainable:
            moved += not torch.equal(value, before[name])
        else:
            assert torch.equal(value, before[name]), f"frozen {name} changed"
    return moved


def test_image_region_step_equals_jax(step_runs):
    (p1, m1, _, _), (got_p1, got_m1, _, _) = step_runs["want"], step_runs["got"]
    assert set(got_m1) == set(m1) and "image_region_cont_loss" in got_m1
    for k, v in m1.items():
        np.testing.assert_allclose(got_m1[k].item(), float(v), rtol=1e-4, err_msg=k)
    assert float(m1["cont_loss"]) == 0 and float(m1["image_region_cont_loss"]) > 0  # before burn-up
    trainable = {n for n, p in step_runs["trainer"].model.named_parameters() if p.requires_grad}
    assert _params_close(got_p1, p1, step_runs["before"], trainable) > len(trainable) // 2


def test_pl_step_after_it_equals_jax_with_the_doubled_count(step_runs):
    (_, _, p2, m2), (got_p1, _, got_p2, got_m2) = step_runs["want"], step_runs["got"]
    trainer = step_runs["trainer"]
    assert set(got_m2) == set(m2) == {"token-pl-region_loss"}
    np.testing.assert_allclose(got_m2["token-pl-region_loss"].item(), float(m2["token-pl-region_loss"]), rtol=1e-5)
    trainable = {n for n, p in trainer.model.named_parameters() if p.requires_grad}
    _params_close(got_p2, p2, step_runs["before"], trainable)
    # the pl step is the optimizer's second update of the iteration: count 2
    # after iteration 0, its LR read at count 1 (10x that at count 0)
    assert trainer.iteration == 1 and trainer.optimizer.count == 2
    schedule = step_runs["schedule"]
    assert schedule(1) == pytest.approx(10 * schedule(0))
    assert any(not torch.equal(got_p2[k], got_p1[k]) for k in got_p2 if k.startswith("backbone.layer3"))


def _port_momentum(trainer, prefix):
    """{name: momentum buffer} of the trainer's parameters under `prefix`."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    state = trainer.optimizer.sgd.state
    return {names[id(p)]: state[p]["momentum_buffer"] for p in trainer.optimizer.params
            if names[id(p)].startswith(prefix)}


def _jax_momentum(opt_state):
    """The momentum tree (optax.trace's) of a JAX optimizer state."""
    is_trace = lambda x: isinstance(x, optax.TraceState)  # noqa: E731
    return next(x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=is_trace) if is_trace(x)).trace


def test_a_save_restores_under_any_branch_with_jax_projector_and_momentum(tiny_jax, step_runs):
    """The training build holds `image_projector` whatever the branch, as
    JAX's tree does, so a save of one branch restores under another. The
    "image_region" step of `step_runs` trains the projector; a "" step from
    the same weights and draws gives it a zero gradient, so it decays and
    takes the decay as its momentum. In JAX that part of the "" step is its
    optimizer (clip by value, decay, momentum: leaf by leaf) on the
    projector's zero gradient. Each save, restored under the other branch,
    holds JAX's projector and momentum (1e-6)."""
    _, _, jb, params = tiny_jax
    cfg = step_runs["cfg"]
    solver = dataclasses.replace(flagship_solver_config(tiny=True), warmup_iters=1, warmup_factor=0.1)
    ours = _port_model(params)
    plain = Trainer(ours, build_optimizer(ours, solver), caption_burnup_iters=solver.caption_burnup_iters)
    plain.train_step(_torch_batch(jb), _replay(step_runs["draws"]))

    sub = {"params": {"image_projector": params["params"]["image_projector"]}}
    optimizer = jax_build_optimizer(cfg, sub)
    zeros = jax.tree_util.tree_map(np.zeros_like, sub)
    updates, opt0 = jax.jit(optimizer.update)(zeros, optimizer.init(sub), sub)
    p0 = optax.apply_updates(sub, updates)

    region_save, p1, opt1 = step_runs["region_save"]
    for save, branch, want_params, want_opt in ((copy.deepcopy(plain.state_dict()), "image_region", p0, opt0),
                                                 (region_save, "", p1, opt1)):
        m = build_model(flagship_config(tiny=True), device="cpu", training=True)
        init_random_(m, torch.Generator().manual_seed(9))
        restored = Trainer(m, build_optimizer(m, solver), consistency_branch=branch)
        restored.load_state_dict(save)
        want = convert_jax_params(want_params)
        want_momentum = convert_jax_params(_jax_momentum(want_opt))
        got = {k: v for k, v in m.state_dict().items() if k.startswith("image_projector.")}
        got_momentum = _port_momentum(restored, "image_projector.")
        assert len(got) == len(got_momentum) == 4 and restored.optimizer.count == 1
        for name, value in {**got, **{f"momentum {k}": v for k, v in got_momentum.items()}}.items():
            key = name.removeprefix("momentum ")
            ref = want_momentum[key] if name.startswith("momentum") else want[key]
            np.testing.assert_allclose(_np(value), _np(ref), rtol=0, atol=1e-6, err_msg=f"{branch!r}: {name}")
    # the "" step's momentum is the decay alone; the "image_region" step's adds the projector's gradient
    w = params["params"]["image_projector"]["fc1"]["kernel"].T
    decay = _np(_port_momentum(plain, "image_projector.fc1.weight")["image_projector.fc1.weight"])
    np.testing.assert_allclose(decay, solver.weight_decay * w, rtol=1e-6, atol=0)
    trained = convert_jax_params(_jax_momentum(opt1))["image_projector.fc1.weight"]
    assert np.abs(_np(trained) - decay).max() > 1e-6


# ---------------- the trainer ----------------
def _jax_branch_of(config_name):
    from cddmsl_tpu.config import get_cfg as jax_get_cfg

    cfg = jax_get_cfg()
    cfg.merge_from_file(str(TINY_RECIPE.parent.parent.parent / "configs" / "quick_schedules" / config_name))
    return cfg.MODEL.CONSISTENCY_BRANCH


@pytest.mark.parametrize("branch", ["image", "image_region", "caption_pl_img", "caption_pl_region"])
def test_default_trainer_runs_each_branch_with_jax_loss_names(fixture_root, tmp_path, jax_loss_names,  # noqa: F811
                                                              branch):
    """2 steps of voc_tiny.yaml and the final test; the loss names are JAX's
    (its loss set, traced, and tests/test_consistency_branches.py's branch
    names); with a pl branch the optimizer counts two per iteration."""
    cfg = _tiny_cfg(tmp_path / "out", **{"SOLVER.MAX_ITER": 2, "SOLVER.CHECKPOINT_PERIOD": 0,
                                         "MODEL.CONSISTENCY_BRANCH": branch, "MODEL.CAPTION_PL_MAX_LEN": MAX_LEN,
                                         **{f"TPU.GPT2_{k}": v for k, v in (("VOCAB", 64), ("POSITIONS", 64),
                                                                           ("EMBD", 32), ("LAYERS", 2),
                                                                           ("HEADS", 2))}})
    main = jax_loss_names[cfg.MODEL.KD_REGULRAZIATION]  # the VOC recipe: KD off
    extra = {JAX_BRANCH_LOSSES[name] for name in JAX_BRANCH_LOSSES if _jax_branch_of(name) == branch}
    assert len(extra) == 1
    trainer = DefaultTrainer(cfg, device="cpu")
    trainer.resume_or_load(resume=False)
    p0 = trainer.model.backbone.layer3[0].conv1.weight.detach().clone()
    results = trainer.train()
    assert "AP50" in next(iter(results.values()))["bbox"]
    latest = {k: h.latest() for k, h in trainer.storage.histories().items()}
    assert set(main) | extra <= set(latest), sorted(latest)
    assert all(np.isfinite(latest[k]) for k in set(main) | extra)
    assert not torch.equal(p0, trainer.model.backbone.layer3[0].conv1.weight)
    pl = branch.startswith("caption_pl")
    assert trainer.optimizer.count == (4 if pl else 2) and trainer.state.iteration == 2
    assert (trainer.caption_model is not None) == pl
    if pl:
        assert not any(p.requires_grad for p in trainer.caption_model.parameters())
        # the checkpoint holds the detector alone
        assert not any(k.startswith(("gpt.", "clip_project.")) for k in trainer.state.state_dict()["model"])


def test_the_config_refuses_an_unknown_branch():
    for value in ("image_text", "caption_pl", "region"):
        cfg = get_cfg()
        cfg.MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER = True
        cfg.MODEL.CONSISTENCY_BRANCH = value
        with pytest.raises(NotImplementedError, match="MODEL.CONSISTENCY_BRANCH"):
            check_supported(cfg)
    cfg = get_cfg()
    cfg.MODEL.CLIP.USE_TEXT_EMB_CLASSIFIER = True
    cfg.MODEL.CAPTION_PL_LOSS = "l2"
    with pytest.raises(NotImplementedError, match="MODEL.CAPTION_PL_LOSS"):
        check_supported(cfg)
    with pytest.raises(ValueError, match="caption_pl_img"):
        Trainer(None, None, consistency_branch="caption_pl_img")


# ---------------- gen_captions ----------------
def test_gen_captions_image_preprocess_equals_the_jax_tool(tmp_path):
    """tools/gen_captions.py's steps: PIL bicubic to 224x224, /255, CLIP
    normalization."""
    path = tmp_path / "img.png"
    Image.fromarray((np.random.RandomState(0).rand(90, 130, 3) * 255).astype(np.uint8)).save(path)
    img = Image.open(path).convert("RGB").resize((224, 224), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    mean = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
    want = ((x - mean) / std)[None]
    np.testing.assert_array_equal(gen_captions.load_image(str(path)).numpy(), want)


@pytest.fixture
def tiny_gen_captions(monkeypatch):
    """gen_captions at the tests' width: the tiny backbone and caption model
    in place of RN50 and GPT-2."""
    monkeypatch.setattr(gen_captions, "RESNET_SPECS", {50: ((1, 1, 1, 1), 16)})
    monkeypatch.setattr(gen_captions, "EMBED_DIMS", {50: EMBED})
    monkeypatch.setattr(gen_captions, "ClipCaptionModel", lambda: ClipCaptionModel(
        prefix_length=PREFIX, clip_length=PREFIX, dim_clip=EMBED, gpt_config=GPT2Config(**GPT)))


def test_gen_captions_cli_prints_token_ids_on_the_cpu(tmp_path, tiny_gen_captions):
    path = tmp_path / "img.png"
    Image.fromarray((np.random.RandomState(1).rand(64, 80, 3) * 255).astype(np.uint8)).save(path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ids = gen_captions.main(["--image", str(path), "--max-len", "3", "--device", "cpu"])
    assert 1 <= len(ids) <= 3 and all(0 <= i < GPT["vocab_size"] for i in ids)
    assert out.getvalue().startswith("token ids")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gen_captions.main(["--image", str(path), "--max-len", "1"])


def test_gen_captions_ignores_gpt2_weights_without_clipcap_weights(tmp_path, tiny_gen_captions, caplog):
    """As tools/gen_captions.py: --gpt2-weights alone is not read (the file
    named does not exist) and the ids are those without it."""
    path = tmp_path / "img.png"
    Image.fromarray((np.random.RandomState(2).rand(64, 80, 3) * 255).astype(np.uint8)).save(path)
    argv = ["--image", str(path), "--max-len", "3", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        want = gen_captions.main(argv)
        with caplog.at_level("WARNING", logger=gen_captions.__name__):
            got = gen_captions.main(argv + ["--gpt2-weights", str(tmp_path / "absent.pt")])
    assert got == want
    assert "--gpt2-weights is read only with --clipcap-weights" in caplog.text
