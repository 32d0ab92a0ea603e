"""Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x's Panoptic FPN in the port
against cddmsl_tpu on the CPU (the companion of test_torch_port_dconv.py,
which holds the op and its tolerances): GN through the tower and the FPN,
DCN v1 on res3..res5 with the stride in the 3x3 (STRIDE_IN_1X1 false), and
the cascade heads with masks, one step against JAX's `make_train_step`
(one JAX program); the file's builder fields against JAX's.

The model is JAX's `PanopticFPN` at RESNETS.DEPTH 10 with a bottleneck of 64
(TPU.BACKBONE_WIDTH; the FPN stays at 256 and the semantic head at 128),
a mask head of 2 convs of 16 and the head's GN, on two unpadded 96x160
images (over a zero-padded region GN's statistics make a float32 step
ill-conditioned in both packages: test_torch_port_norms.py) with
stride-4 diamond canvases and labels in 8x8 blocks, JAX's draws replayed.
The losses within rtol 1e-5 and the update (the parameters after one SGD
step) within 1.5e-3 of the update's norm of JAX's (JAX_RTOL of
test_torch_port_norms.py), from JAX's tree carried across by
`convert_jax_params` with offsets of about a pixel.

The bottleneck is 64, not the other files' 8: at 8 this model's float32
step is ill-conditioned in JAX itself (`slow`:
`test_jax_own_step_is_continuous_at_the_tests_bottleneck` moves JAX's tree
by 1e-7 of each value and measures JAX's own update move, within 5e-4 of
its norm at 64 and beyond it at 8).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.config import get_cfg as jax_get_cfg
from cddmsl_tpu.engine import TrainState, make_train_step
from cddmsl_tpu.engine.train_loop import split_batch_stats
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_tpu.models.panoptic_fpn import PanopticFPN as JaxPanopticFPN
from cddmsl_tpu.solver import build_optimizer as jax_build_optimizer
from cddmsl_tpu.solver.build import build_lr_schedule as jax_build_lr_schedule
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.config import check_supported, get_cfg, model_family, solver_config_from_cfg
from cddmsl_torch.engine.train_loop import Trainer
from cddmsl_torch.models.backbone.batch_norm import GroupNorm32
from cddmsl_torch.models.backbone.resnet import D2Bottleneck
from cddmsl_torch.models.build import build_detector, panoptic_fpn_fields
from cddmsl_torch.models.cascade_rcnn import CascadeROIHeads
from cddmsl_torch.models.panoptic_fpn import PanopticFPN
from cddmsl_torch.solver.build import build_optimizer
from test_torch_port_dconv import DCONV
from test_torch_port_fpn import torch_batch
from test_torch_port_mask_rcnn import diamond_canvases
from test_torch_port_norms import BATCH_FULL, JAX_RTOL, LOSS_RTOL, _cfgs, update_apart
from test_torch_port_backbone import fill_params, port_tree_shapes
from test_torch_port_panoptic import PANOPTIC, block_labels
from torch_goldens import supervised_draw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FILE = REPO / "configs" / "Misc" / "panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml"
DCONV_PANOPTIC = dict(PANOPTIC, backbone_width=64, backbone_norm="GN", fpn_norm="GN", stride_in_1x1=False,
                      deform_on_per_stage=DCONV, deform_modulated=False, cascade=True)
FILL_SEED = 3
NAMES = {"loss_rpn_cls", "loss_rpn_loc", "loss_mask", "loss_sem_seg",
         *(f"loss_{k}_stage{i}" for k in ("cls", "box_reg") for i in range(3))}


def dconv_panoptic_params(port, seed):
    """JAX's tree (read off the port's model `port`, as `eval_shape` of JAX's
    `init_all` gives it) filled by `fill_params`, the RPN head's outputs
    near the 0.01 std of its own init and each cascade stage's classifier
    and box regressor at the 0.01 and 0.001 std of detectron2's (with
    He-normal fcs of 1024 on 7x7x256 pools the logits would saturate the
    softmax)."""
    variables = fill_params(port_tree_shapes(port), seed=seed)
    tree = variables["params"]
    for name in ("objectness_logits", "anchor_deltas"):
        tree["proposal_generator"]["head"][name]["kernel"] /= 4
    for i in range(3):
        for name, std in (("cls_score", 0.01), ("bbox_pred", 0.001)):
            node = tree["roi_heads"][f"stage{i}"][name]
            node["kernel"] = node["kernel"] * (std / node["kernel"].std())
    return variables


def _batch():
    return BATCH_FULL._replace(gt_masks=jnp.asarray(diamond_canvases(BATCH_FULL)),
                               sem_seg=jnp.asarray(block_labels(BATCH_FULL)))


@pytest.fixture(scope="module")
def panoptic_dconv_step():
    jb = _batch()
    model, ours = JaxPanopticFPN(**DCONV_PANOPTIC), PanopticFPN(**DCONV_PANOPTIC)
    variables = dconv_panoptic_params(ours, seed=FILL_SEED)
    cfg, jcfg = _cfgs()
    optimizer = jax_build_optimizer(jcfg, split_batch_stats(variables)[0])
    step = make_train_step(model, optimizer, enable_caption=False, lr_schedule=jax_build_lr_schedule(jcfg),
                           donate=False)
    state = TrainState.create(variables, optimizer)
    rng = jax.random.PRNGKey(61)
    before = convert_jax_params(state.params)
    state, want = step(state, jb, rng)
    ours.load_state_dict(before, strict=True)
    trainer = Trainer(ours, build_optimizer(ours, solver_config_from_cfg(cfg)), enable_caption=False)
    tb = torch_batch(jb, gt_masks=torch.from_numpy(np.array(jb.gt_masks)).to(torch.uint8),
                     sem_seg=torch.from_numpy(np.array(jb.sem_seg)))
    got = trainer.train_step(tb, supervised_draw(rng))
    return dict(before=before, after=convert_jax_params(state.params), want=want, got=got, model=ours,
                ours_after={k: v.clone() for k, v in ours.state_dict().items()})


def test_the_panoptic_dconv_gn_cascade_step_equals_jax(panoptic_dconv_step):
    """The nine losses (three stages', the mask's, the semantic head's)
    within rtol 1e-5 and the update within 1.5e-3 of the update's norm;
    every offset conv and every GN moved."""
    want, got = panoptic_dconv_step["want"], panoptic_dconv_step["got"]
    names = {k for k in want if k.startswith("loss_")}
    assert names == NAMES and names <= set(got)
    for k in names:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    before, after = panoptic_dconv_step["before"], panoptic_dconv_step["ours_after"]
    assert update_apart(before, after, panoptic_dconv_step["after"]) < JAX_RTOL
    offsets = [k for k in before if k.endswith("conv2_offset.weight")]
    assert len(offsets) == 3 and all(before[k].shape[0] == 18 for k in offsets)  # v1: offsets alone
    moved = [k for k in before if k.endswith(("conv2_offset.weight", "norm.weight")) and "bottom_up" in k]
    assert all(not torch.equal(before[k], after[k]) for k in moved)


def test_the_model_is_the_files_tower_and_heads(panoptic_dconv_step):
    """GN after every tower conv and the FPN's, the first block of res3..res5
    deforming at stride 2 (in the 3x3), and the cascade's three stages."""
    model = panoptic_dconv_step["model"]
    tower = model.backbone.bottom_up
    assert isinstance(tower.stem.conv1.norm, GroupNorm32) and isinstance(model.backbone.fpn_lateral2.norm, GroupNorm32)
    for name in ("res3", "res4", "res5"):
        block = getattr(tower, name)[0]
        assert block.conv2_offset.stride == (2, 2) and block.conv2.stride == (2, 2) and block.conv1.stride == (1, 1)
    assert tower.res2[0].conv2_offset is None
    assert isinstance(model.roi_heads, CascadeROIHeads) and len(model.roi_heads.box_head) == 3


def test_the_file_is_accepted_with_the_jax_builders_fields():
    """Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml: every field the
    port's builder gives is JAX's module's, and the full-width model builds
    (R-101: 30 deformable blocks of 33)."""
    ours, ref = get_cfg(), jax_get_cfg()
    for c in (ours, ref):
        c.merge_from_file(str(FILE))
    check_supported(ours, world=1)
    assert model_family(ours) == "panoptic"
    want = jax_build_model(ref)
    fields = panoptic_fpn_fields(ours)
    assert fields.pop("backbone_width") == (want.backbone_width or 64)
    assert fields.pop("dtype") == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[want.dtype]
    for name, value in fields.items():
        expect = getattr(want, name)
        assert value == (tuple(expect) if isinstance(expect, (list, tuple)) else expect), name
    assert fields["cascade"] and fields["backbone_norm"] == fields["fpn_norm"] == "GN"
    assert fields["deform_on_per_stage"] == DCONV and not fields["deform_modulated"]
    with torch.device("meta"):
        model = build_detector(ours, device="meta")
    blocks = [m for m in model.modules() if isinstance(m, D2Bottleneck)]
    assert len(blocks) == 33 and sum(b.conv2_offset is not None for b in blocks) == 30


@pytest.mark.parametrize("key, value", [
    ("MODEL.ROI_HEADS.NAME", "CascadeROIHeads"), ("MODEL.FPN.NORM", "GN"), ("MODEL.RESNETS.NORM", "GN"),
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True]),
])
def test_panoptic_fpn_takes_each_of_the_files_keys_with_the_jax_builders_fields(key, value):
    """Each key of the dconv-GN-cascade file alone on
    COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml (each refused
    before the deformable stages were ported): accepted, and every field
    the port's builder gives is JAX's module's."""
    ours, ref = get_cfg(), jax_get_cfg()
    for c in (ours, ref):
        c.merge_from_file(str(REPO / "configs" / "COCO-PanopticSegmentation" / "panoptic_fpn_R_50_1x.yaml"))
        c.merge_from_list([key, value if isinstance(value, str) else repr(value)])
    check_supported(ours, world=1)
    want = jax_build_model(ref)
    fields = panoptic_fpn_fields(ours)
    fields.pop("backbone_width"), fields.pop("dtype")
    for name, got in fields.items():
        expect = getattr(want, name)
        assert got == (tuple(expect) if isinstance(expect, (list, tuple)) else expect), name


@pytest.mark.slow
@pytest.mark.parametrize("width, continuous", [(64, True), (8, False)])
def test_jax_own_step_is_continuous_at_the_tests_bottleneck(width, continuous):
    """JAX's own step from its tree with every leaf moved by 1e-7 of its
    value (normal factors from RandomState(99)) against its step from the
    tree, at FILL_SEED: within 5e-4 of the update's norm at the bottleneck
    of 64 the test uses (8.7e-5 measured), beyond it at 8 (1.1e-3)."""
    kw = dict(DCONV_PANOPTIC, backbone_width=width)
    jb = _batch()
    model = JaxPanopticFPN(**kw)
    variables = dconv_panoptic_params(PanopticFPN(**kw), seed=FILL_SEED)
    optimizer = jax_build_optimizer(_cfgs()[1], split_batch_stats(variables)[0])
    step = make_train_step(model, optimizer, enable_caption=False, lr_schedule=jax_build_lr_schedule(_cfgs()[1]),
                           donate=False)
    r = np.random.RandomState(99)
    moved = jax.tree_util.tree_map(lambda a: (a * (1 + 1e-7 * r.randn(*a.shape))).astype(np.float32), variables)
    before = convert_jax_params(variables["params"])
    after = [convert_jax_params(step(TrainState.create(v, optimizer), jb, jax.random.PRNGKey(61))[0].params)
             for v in (variables, moved)]
    own = update_apart(before, after[1], after[0])
    assert (own < 5e-4) == continuous, own