"""Deformable convolution in the port against cddmsl_tpu on the CPU: the op
(`deform_conv2d`, `modulated_deform_conv2d`), the deformable `D2Bottleneck`
(DCN v1 and v2), one step of a narrow FPN Mask R-CNN with DCN v2 on
res3..res5 (Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml's tower) against
JAX's `make_train_step` (one JAX program), a detectron2 DCN file through
both loaders, and the deformable configs.

The same inputs, made with numpy from a seed, go through both packages in
float32. Tolerances, and why:
- the op's output and the gradients of the input, the offsets, the mask and
  the kernel within 1e-5 of each one's largest magnitude (the same
  bilinear terms summed in another order; the im2col product is one
  contraction in both), on cases with stride 1 and 2, dilation 2, points
  outside the image and in (-1, 0), and zero offsets, where every tap
  samples on an integer and the border taps' offset gradient is the
  clip's tie (0.5 in JAX; `torch.clamp` passes 1 and fails the test);
- the block's output and gradients likewise, through FrozenBN;
- the step's losses within rtol 1e-5 of JAX's and its update (the
  parameters after one SGD step) within 1.5e-3 of the update's norm of
  JAX's, test_torch_port_norms.py's bound (JAX_RTOL there), from JAX's
  tree carried across by `convert_jax_params` with offsets of about a
  pixel (the filled offset convs);
- the loaders' tensors exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.checkpoint.convert_torch import load_rcnn_weights as jax_load_rcnn_weights
from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.engine import TrainState, make_train_step
from cddmsl_tpu.engine.train_loop import split_batch_stats
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.backbone.resnet import D2Bottleneck as JaxD2Bottleneck
from cddmsl_tpu.models.fpn_rcnn import FPNRCNN as JaxFPNRCNN
from cddmsl_tpu.ops import deform_conv as jax_dc
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_tpu.solver.build import build_lr_schedule as jax_build_lr_schedule
from cddmsl_torch.checkpoint import convert_jax
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.checkpoint.convert_torch import fc1_from_chw, load_rcnn_weights
from cddmsl_torch.config import check_supported, get_cfg, solver_config_from_cfg
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.models.backbone.resnet import D2Bottleneck
from cddmsl_torch.models.build import build_detector, fpn_rcnn_fields
from cddmsl_torch.models.fpn_rcnn import FPNRCNN
from cddmsl_torch.ops import deform_conv as dc
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_backbone import fill_params, port_tree_shapes
from test_torch_port_fpn import D2_PIXELS, NARROW, torch_batch
from test_torch_port_mask_rcnn import diamond_canvases
from test_torch_port_norms import BATCH_FULL, JAX_RTOL, LOSS_RTOL, _cfgs, _like, update_apart
from torch_goldens import supervised_draw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5  # of each compared tensor's largest magnitude
DCONV = (False, True, True, True)


# ---------------- the op ----------------
def _op_case(stride, dilation, modulated, offsets, seed=0, n=2, h=7, w=9, c=5, cout=6):
    """Numpy inputs of one call: NHWC input, offsets ("random": ~N(0, 2) px;
    "outside": uniform in +-6 px, so some points leave the image and some
    fall in (-1, 0); "zero"), the mask in (0, 1) under v2, the HWIO kernel
    and a cotangent of the output."""
    r = np.random.RandomState(seed)
    ho = (h + 2 * dilation - 2 * dilation - 1) // stride + 1
    wo = (w + 2 * dilation - 2 * dilation - 1) // stride + 1
    shape = (n, ho, wo, 18)
    off = {"random": lambda: r.randn(*shape) * 2, "outside": lambda: r.uniform(-6, 6, shape),
           "zero": lambda: np.zeros(shape)}[offsets]().astype(np.float32)
    return dict(x=r.randn(n, h, w, c).astype(np.float32), off=off,
                mask=r.rand(n, ho, wo, 9).astype(np.float32) if modulated else None,
                kernel=r.randn(3, 3, c, cout).astype(np.float32), cot=r.randn(n, ho, wo, cout).astype(np.float32),
                kw=dict(stride=stride, padding=dilation, dilation=dilation))


def _jax_op(case):
    """JAX's output and the gradients of sum(out * cot) with respect to the
    input, the offsets, the kernel and the mask (v2: `modulated_deform_conv2d`)."""
    kw, cot = case["kw"], case["cot"]

    def total(x, off, kernel, mask):
        if mask is None:
            out = jax_dc.deform_conv2d(x, off, kernel, **kw)
        else:
            out = jax_dc.modulated_deform_conv2d(x, off, mask, kernel, **kw)
        return jnp.sum(out * cot), out

    argnums = (0, 1, 2) if case["mask"] is None else (0, 1, 2, 3)
    grads, out = jax.jit(jax.grad(total, argnums=argnums, has_aux=True))(case["x"], case["off"], case["kernel"],
                                                                          case["mask"])
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port_op(case, layout="NHWC"):
    """The port's output and gradients in JAX's layouts (the kernel HWIO)."""
    t = lambda a: None if a is None else torch.tensor(a, requires_grad=True)  # noqa: E731
    x, off, mask = t(case["x"]), t(case["off"]), t(case["mask"])
    kernel = torch.tensor(case["kernel"].transpose(3, 2, 0, 1).copy(), requires_grad=True)
    to = (lambda a: a.permute(0, 3, 1, 2)) if layout == "NCHW" else (lambda a: a)
    if mask is None:
        out = dc.deform_conv2d(to(x), to(off), kernel, layout=layout, **case["kw"])
    else:
        out = dc.modulated_deform_conv2d(to(x), to(off), to(mask), kernel, layout=layout, **case["kw"])
    out = out.permute(0, 2, 3, 1) if layout == "NCHW" else out
    (out * torch.from_numpy(case["cot"])).sum().backward()
    got = [out.detach().numpy(), x.grad.numpy(), off.grad.numpy(), kernel.grad.numpy().transpose(2, 3, 1, 0)]
    return got + ([] if mask is None else [mask.grad.numpy()])


def assert_op_equals_jax(case, layout="NHWC"):
    names = ("output", "d input", "d offsets", "d kernel", "d mask")
    for name, g, w in zip(names, _port_op(case, layout), _jax_op(case)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL * np.abs(w).max(), err_msg=name)


OP_CASES = {
    "v1-stride1": (1, 1, False, "random"),
    "v2-stride1": (1, 1, True, "random"),
    "v1-stride2": (2, 1, False, "random"),
    "v2-stride2": (2, 1, True, "random"),
    "v2-dilation2": (1, 2, True, "random"),
    "v1-outside": (1, 1, False, "outside"),
    "v2-outside-stride2": (2, 1, True, "outside"),
    "v1-zero": (1, 1, False, "zero"),
    "v2-zero-stride2": (2, 1, True, "zero"),
}


@pytest.mark.parametrize("name", list(OP_CASES))
def test_deform_conv2d_and_its_gradients_equal_jax(name):
    assert_op_equals_jax(_op_case(*OP_CASES[name]))


def test_the_outside_cases_reach_outside_and_into_the_first_pixel():
    """The "outside" offsets put points at or past -1 and H (dropped), and
    in (-1, 0) (taken at row or column 0, full weight)."""
    case = _op_case(*OP_CASES["v1-outside"])
    n, h, w = case["x"].shape[:3]
    ho, wo = case["off"].shape[1:3]
    base_y = np.arange(ho)[:, None, None] - 1 + np.repeat(np.arange(3), 3)[None, None]
    y = base_y[None] + case["off"][..., 0::2]
    assert (y <= -1).any() and (y >= h).any() and ((y > -1) & (y < 0)).any()


def test_nchw_is_the_same_function():
    assert_op_equals_jax(_op_case(*OP_CASES["v2-stride2"]), layout="NCHW")


def test_the_clip_tie_takes_half_the_gradient_and_clamp_does_not(monkeypatch):
    """At zero offsets the taps on row or column 0 sit on the clip's lower
    bound: JAX's `jnp.clip` passes half the gradient there, as the port's
    minimum/maximum with tensor bounds does. A port whose clip is
    `torch.clamp` (gradient 1 at the bound) fails the offsets' gradient."""
    case = _op_case(*OP_CASES["v1-zero"])
    got, want = _port_op(case)[2], _jax_op(case)[2]
    # dy of tap (0, 0): output row 0 samples it at y = -1 (dropped), row 1 at y = 0 (the tie)
    assert np.abs(want[:, 0, :, 0]).max() == 0 and np.abs(want[:, 1, :, 0]).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * np.abs(want).max())
    monkeypatch.setattr(dc, "_clip", lambda v, hi: torch.clamp(v, 0, hi))
    with pytest.raises(AssertionError, match="d offsets"):
        assert_op_equals_jax(case)
    ratio = _port_op(case)[2][:, 1, :, 0] / np.where(want[:, 1, :, 0] == 0, 1, want[:, 1, :, 0])
    assert np.allclose(ratio[want[:, 1, :, 0] != 0], 2.0)


def test_offsets_of_the_wrong_shape_raise():
    case = _op_case(*OP_CASES["v1-stride1"])
    with pytest.raises(ValueError, match="offsets"):
        dc.deform_conv2d(torch.from_numpy(case["x"]), torch.zeros(2, 3, 3, 18), torch.zeros(6, 5, 3, 3))


# ---------------- the block ----------------
def _block_params(module, x, seed):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return fill_params(shapes, seed=seed)


@pytest.mark.parametrize("modulated, stride_in_1x1", [(False, False), (True, True)], ids=["v1-stride-in-3x3", "v2"])
def test_the_deformable_block_equals_jax(modulated, stride_in_1x1):
    """detectron2's DeformBottleneckBlock at stride 2 (in the 3x3 for v1, as
    STRIDE_IN_1X1 false puts it, in the 1x1 for v2) with a filled offset
    conv (offsets of about a pixel): the output and the gradients of the
    input and of every parameter, the block carried across by
    `convert_jax_params`' tower rules."""
    r = np.random.RandomState(3)
    x = r.randn(2, 12, 14, 16).astype(np.float32)
    jm = JaxD2Bottleneck(8, 32, stride=2, stride_in_1x1=stride_in_1x1, deform=True, deform_modulated=modulated)
    params = _block_params(jm, x, seed=4)
    cot = r.randn(*jax.eval_shape(jm.apply, params, x).shape).astype(np.float32)
    want, (want_p, want_dx) = jax.jit(lambda p, a: (jm.apply(p, a), jax.grad(
        lambda p, a: jnp.sum(jm.apply(p, a) * cot), argnums=(0, 1))(p, a)))(params, x)
    tree = {"backbone": {"res3_0": params["params"]}}
    state = {k[len("backbone.res3.0."):]: v for k, v in
             convert_jax._convert(tree, convert_jax._d2_tower_rules("backbone"), "block").items()}
    ours = D2Bottleneck(16, 8, 32, stride=2, stride_in_1x1=stride_in_1x1, deform=True, deform_modulated=modulated)
    ours.load_state_dict(state, strict=True)
    off = ours.conv2_offset(ours.conv1(torch.from_numpy(x).permute(0, 3, 1, 2)).relu())
    assert 0.3 < off[:, :18].abs().mean() < 3  # about a pixel
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = ours(xt).permute(0, 2, 3, 1)
    (got * torch.from_numpy(cot)).sum().backward()
    grads = {k: v for k, v in convert_jax._convert({"backbone": {"res3_0": want_p["params"]}},
                                                   convert_jax._d2_tower_rules("backbone"), "grads").items()}
    pairs = [("output", got.detach(), want), ("input", xt.grad.permute(0, 2, 3, 1), want_dx)]
    pairs += [(n, p.grad, grads[f"backbone.res3.0.{n}"]) for n, p in ours.named_parameters()]
    assert {n for n, _ in ours.named_parameters()} >= {"conv2.weight", "conv2_offset.weight", "conv2_offset.bias"}
    for name, g, w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL * np.abs(w).max(), err_msg=name)


def test_a_grouped_deformable_block_fails_at_jax_init_and_is_refused():
    """JAX's deformable block asserts NUM_GROUPS == 1 at init; the port's
    block refuses to be built so, and `check_supported` names
    MODEL.RESNETS.NUM_GROUPS for the X-152 32x8d file."""
    x = np.zeros((1, 8, 8, 16), np.float32)
    with pytest.raises(AssertionError, match="NUM_GROUPS"):
        jax.eval_shape(JaxD2Bottleneck(16, 32, num_groups=2, deform=True).init, jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="groups"):
        D2Bottleneck(16, 16, 32, groups=2, deform=True)
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / "Misc" / "cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml"))
    with pytest.raises(NotImplementedError, match=r"MODEL\.RESNETS\.NUM_GROUPS"):
        check_supported(cfg, world=1)


# ---------------- the dconv Mask R-CNN, a step against JAX ----------------
def dconv_model_kw():
    """The narrow Mask R-CNN of test_torch_port_norms.py (FrozenBN) with DCN
    v2 on res3..res5, as the dconv_c3-c5 files build it."""
    return dict(NARROW, **D2_PIXELS, mask_on=True, mask_num_conv=2, mask_conv_dim=16, deform_on_per_stage=DCONV,
                deform_modulated=True)


@pytest.fixture(scope="module")
def dconv_step():
    """One step of JAX's `make_train_step` on BATCH_FULL (with diamond
    canvases) from the filled variables, and of the port's `Trainer` from
    the converted ones with JAX's draws."""
    kw = dconv_model_kw()
    jb = BATCH_FULL._replace(gt_masks=jnp.asarray(diamond_canvases(BATCH_FULL)))
    model, ours = JaxFPNRCNN(**kw), FPNRCNN(**kw)
    variables = fill_params(port_tree_shapes(ours), seed=5)  # eval_shape's tree, read off the port's model
    tree = variables["params"]
    for name in ("objectness_logits", "anchor_deltas"):
        tree["proposal_generator"]["head"][name]["kernel"] /= 4
    bbox = tree["roi_heads"]["box_predictor"]["bbox_pred"]
    bbox["kernel"] = bbox["kernel"] * (0.001 / bbox["kernel"].std())
    cfg, jcfg = _cfgs()
    optimizer = jax_build_optimizer(jcfg, split_batch_stats(variables)[0])
    step = make_train_step(model, optimizer, enable_caption=False, lr_schedule=jax_build_lr_schedule(jcfg),
                           donate=False)
    state = TrainState.create(variables, optimizer)
    rng = jax.random.PRNGKey(60)
    before = convert_jax_params(state.params)
    state, want = step(state, jb, rng)
    ours.load_state_dict(before, strict=True)
    trainer = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(cfg)), enable_caption=False)
    tb = torch_batch(jb, gt_masks=torch.from_numpy(np.array(jb.gt_masks)))
    got = trainer.train_step(tb, supervised_draw(rng))
    return dict(before=before, after=convert_jax_params(state.params), want=want, got=got, model=ours,
                variables=variables, ours_after={k: v.clone() for k, v in ours.state_dict().items()})


def test_the_dconv_mask_rcnn_step_equals_jax(dconv_step):
    """The five losses within rtol 1e-5 and the update within 1.5e-3 of the
    update's norm; every offset conv moved."""
    want, got = dconv_step["want"], dconv_step["got"]
    names = {k for k in want if k.startswith("loss_")}
    assert names == {"loss_cls", "loss_box_reg", "loss_rpn_cls", "loss_rpn_loc", "loss_mask"} and names <= set(got)
    for k in names:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    before, after = dconv_step["before"], dconv_step["ours_after"]
    assert update_apart(before, after, dconv_step["after"]) < JAX_RTOL
    offsets = [k for k in before if k.endswith("conv2_offset.weight")]
    assert len(offsets) == 3 and all(not torch.equal(before[k], after[k]) for k in offsets)
    assert all(before[k].shape[0] == 27 for k in offsets)  # v2: 18 offsets and 9 mask logits


# ---------------- the detectron2 DCN files ----------------
def _d2_names(state):
    """The port's state dict as detectron2 writes the same model (the
    port's names are detectron2's), fc1 in CHW order of the 7x7 pool of the
    FPN's 32 channels, as JAX's loader reads it."""
    sd = {k: v.clone() for k, v in state.items()}
    fc1, c, r = "roi_heads.box_head.fc1.weight", NARROW["fpn_out_channels"], 7
    sd[fc1] = sd[fc1].reshape(-1, r, r, c).permute(0, 3, 1, 2).reshape(sd[fc1].shape[0], -1)
    assert torch.equal(fc1_from_chw(sd[fc1], c, r), state[fc1])
    return sd


@pytest.mark.parametrize("file_res5", ["deformable", "plain"])
def test_a_d2_dcn_file_loads_as_jax_loads_it(tmp_path, dconv_step, file_res5):
    """A detectron2 file of the model with every tensor random: res{s}.{i}.
    conv2.weight beside conv2_offset.{weight,bias} in the deformable blocks.
    The port's load equals JAX's `load_rcnn_weights` read through its
    modules. With res5's offset convs left out of the file, JAX's loader
    writes res5's 3x3 where the deformable module does not read it: the
    port leaves that kernel as it was too."""
    ours = dconv_step["model"]
    ours.load_state_dict(dconv_step["before"])
    g = torch.Generator().manual_seed(3)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in _d2_names(ours.state_dict()).items()}
    if file_res5 == "plain":
        sd = {k: v for k, v in sd.items() if not (".res5." in k and "conv2_offset" in k)}
    path = tmp_path / "d2.pth"
    torch.save({"model": sd}, path)
    assert load_rcnn_weights(ours, str(path)) == "d2_fpn"
    variables = dconv_step["variables"]
    loaded = jax_load_rcnn_weights({"params": variables["params"]}, str(path))
    want = convert_jax_params({"params": _like(loaded["params"], variables["params"])})
    got = ours.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    res5 = "backbone.bottom_up.res5.0.conv2.weight"
    assert torch.equal(got[res5], sd[res5]) == (file_res5 == "deformable")
    assert torch.equal(got["backbone.bottom_up.res3.0.conv2_offset.bias"], sd["backbone.bottom_up.res3.0.conv2_offset.bias"])


# ---------------- the configs ----------------
@pytest.mark.parametrize("name", ["mask_rcnn_R_50_FPN_1x_dconv_c3-c5", "mask_rcnn_R_50_FPN_3x_dconv_c3-c5"])
def test_the_dconv_files_are_accepted_with_the_jax_builders_fields(name):
    """Both files build DCN v2 on res3..res5 (the 3x file inherits
    DEFORM_MODULATED true, although its comment says v1): every field the
    port's builder gives is JAX's module's."""
    ours, ref = get_cfg(), jax_get_cfg()
    for c in (ours, ref):
        c.merge_from_file(str(REPO / "configs" / "Misc" / f"{name}.yaml"))
    check_supported(ours, world=1)
    want = jax_build_model(ref)
    fields = fpn_rcnn_fields(ours)
    assert fields["deform_on_per_stage"] == DCONV and fields["deform_modulated"] is True
    for field, value in fields.items():
        expect = getattr(want, field)
        if field == "dtype":
            assert str(value).split(".")[-1] == jnp.dtype(expect).name
        elif field == "backbone_width":
            assert value == (expect or 64), field
        else:
            assert value == (tuple(expect) if isinstance(expect, (list, tuple)) else expect), field
    with torch.device("meta"):
        model = build_detector(ours, device="meta")
    blocks = [m for m in model.modules() if isinstance(m, D2Bottleneck)]
    assert sum(b.conv2_offset is not None for b in blocks) == 13 and len(blocks) == 16


@pytest.mark.parametrize("key, value, family", [
    ("MODEL.RESNETS.DEFORM_NUM_GROUPS", 2, "fpn"),
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True], "retinanet"),
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True], "clip_fpn"),
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True], "semantic"),
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True], "proposal_fpn"),
])
def test_the_deformable_keys_are_refused_where_jax_reads_none_naming_the_key(key, value, family):
    """DEFORM_NUM_GROUPS other than 1 (no JAX builder reads it), and the
    deformable stages where JAX's builder passes none: RetinaNet, the CLIP
    FPN tower, the semantic segmentor, the FPN ProposalNetwork (and the C4
    towers, test_torch_port_heads.py)."""
    path = {"fpn": "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml",
            "retinanet": "COCO-Detection/retinanet_R_50_FPN_1x.yaml",
            "clip_fpn": "LVISv1-InstanceSegmentation/mask_rcnn_CLIP_R_50_FPN_1x.yaml",
            "semantic": "Misc/semantic_R_50_FPN_1x.yaml",
            "proposal_fpn": "COCO-Detection/rpn_R_50_FPN_1x.yaml"}[family]
    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / "configs" / path))
    cfg.merge_from_list([key, repr(value)])
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        check_supported(cfg, world=1)
