"""The port's inference path as a whole against cddmsl_tpu on the CPU, plus
its import hygiene.

`_flagship_cfg(tiny=True)` (float32) with the same random parameters, filled
with numpy and carried across by convert_jax.py, on two images made with
numpy: RPN proposals have equal valid masks and boxes within 1e-3 px; final
detections have equal valid masks and classes, boxes within 1e-3 px and
scores within 1e-5. The JAX model is built and jitted once for the module.

Both outputs are ranked by score. The two frameworks sum the convolutions
in different orders, which moves a detection score by up to ~3e-6 here (the
cosine classifier divides by T = 0.01), so two results whose scores are
closer than that may come out in either order. Rows are therefore compared
in rank order, except inside a run of reference scores closer than
TIE_GAP, where they are matched as a set.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from __graft_entry__ import _flagship_cfg, _synthetic_batch
from cddmsl_tpu.models import DetBatch as JaxDetBatch
from cddmsl_tpu.models import build_model as jax_build_model
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.config import flagship_config
from cddmsl_torch.entry import entry, synthetic_batch
from cddmsl_torch.models.build import build_model
from cddmsl_torch.models.rcnn import DetBatch
from test_torch_port_backbone import fill_params, jax_param_shapes

torch.set_num_threads(1)

BOX_ATOL = 1e-3  # pixels
SCORE_ATOL = 1e-5
TIE_GAP = {"detection": 3e-5, "proposal": 1e-4}  # probabilities; objectness logits
REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cddmsl_tpu")


def _inputs():
    r = np.random.RandomState(11)
    image = (r.rand(2, 128, 160, 3) * 255).astype(np.float32)
    image_sizes = np.array([[128, 160], [112, 144]], np.int32)  # image 1 is padded
    orig_sizes = np.array([[256, 320], [224, 200]], np.int32)
    return image, image_sizes, orig_sizes


def inference_and_head_inputs(m, batch):
    """Inside a flax method: `m.inference(batch)` and the features and test
    proposals it hands its `roi_heads`, read off that call
    (`nn.intercept_methods`), so the tower and the RPN are traced once:
    (features, proposals, detections)."""
    seen = []

    def grab(next_fun, args, kwargs, context):
        if context.module.name == "roi_heads" and context.method_name == "__call__" and not seen:
            seen.append(args[:2])
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(grab):
        detections = m.inference(batch)
    return (*seen[0], detections)


@pytest.fixture(scope="module")
def both_runs():
    image, image_sizes, orig_sizes = _inputs()
    cfg = _flagship_cfg(tiny=True)
    model = jax_build_model(cfg)
    params = fill_params(jax_param_shapes(flagship_config(tiny=True)), seed=5)

    def run(m, b):
        return inference_and_head_inputs(m, b)[1:]

    zeros = jnp.zeros((2, 1, 4), jnp.float32)
    batch = JaxDetBatch(
        image=jnp.asarray(image), image_sizes=jnp.asarray(image_sizes), orig_sizes=jnp.asarray(orig_sizes),
        gt_boxes=zeros, gt_classes=jnp.zeros((2, 1), jnp.int32), gt_valid=jnp.zeros((2, 1), bool),
    )
    want_props, want_dets = jax.jit(lambda p, b: model.apply(p, b, method=run))(params, batch)

    ours = build_model(flagship_config(tiny=True), device="cpu")
    # the JAX tree also holds the training-only modules, which serving leaves out
    state = convert_jax_params(params)
    ours.load_state_dict({k: v for k, v in state.items() if k in ours.state_dict()}, strict=True)
    tb = DetBatch(torch.from_numpy(image), torch.from_numpy(image_sizes), torch.from_numpy(orig_sizes))
    got_props = ours.proposals(tb)[1]
    got_dets = ours.inference(tb)
    return (want_props, want_dets), (got_props, got_dets)


def _assert_ranked_rows_match(got_scores, got_rows, want_scores, want_rows, tie_gap, close):
    """Rows of one image in descending score order. Row k of `want` must be
    matched by row k of `got` (`close(g, w)`), or, inside a run of reference
    scores less than `tie_gap` apart, by an unused row of the same run."""
    n = len(want_scores)
    start = 0
    while start < n:
        end = start + 1
        while end < n and want_scores[end - 1] - want_scores[end] < tie_gap:
            end += 1
        unused = list(range(start, end))
        for k in range(start, end):
            match = next((u for u in unused if close(got_rows[u], want_rows[k])), None)
            assert match is not None, f"reference row {k} (score {want_scores[k]}) has no match in ranks {start}..{end - 1}"
            unused.remove(match)
        start = end


def test_rpn_proposals_match_jax(both_runs):
    (want, _), (got, _) = both_runs
    assert got.boxes.shape == (2, 32, 4) and got.valid.dtype == torch.bool
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 0
    for i in range(2):
        _assert_ranked_rows_match(
            got.scores[i].numpy(), got.boxes[i].numpy(), np.asarray(want.scores[i]), np.asarray(want.boxes[i]),
            TIE_GAP["proposal"], lambda g, w: np.abs(g - w).max() <= BOX_ATOL,
        )


def test_detections_match_jax(both_runs):
    (_, want), (_, got) = both_runs
    assert got.boxes.shape == (2, 100, 4) and got.classes.dtype == torch.int32
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 0
    for i in range(2):
        rows = lambda d: [
            (int(c), np.asarray(b), float(s)) for c, b, s in zip(np.asarray(d.classes[i]), np.asarray(d.boxes[i]), np.asarray(d.scores[i]))
        ]
        _assert_ranked_rows_match(
            got.scores[i].numpy(), rows(got), np.asarray(want.scores[i]), rows(want), TIE_GAP["detection"],
            lambda g, w: g[0] == w[0] and np.abs(g[1] - w[1]).max() <= BOX_ATOL and abs(g[2] - w[2]) <= SCORE_ATOL,
        )


@pytest.mark.parametrize("tiny", [False, True])
def test_config_matches_the_jax_build(tiny):
    """The port's copy of the flagship config gives the fields that
    cddmsl_tpu's build_model derives from `_flagship_cfg`."""
    ref = jax_build_model(_flagship_cfg(tiny=tiny))
    ours = flagship_config(tiny=tiny)
    assert tuple(ours.backbone_layers) == tuple(ref.backbone_layers)
    assert ours.rpn_pre_nms_topk_test == ref.rpn_pre_nms_topk[1]
    assert ours.rpn_post_nms_topk_test == ref.rpn_post_nms_topk[1]
    assert ours.compute_dtype == jnp.dtype(ref.dtype).name
    assert ours.pooler_sampling_ratio == 0 and ours.detections_per_image == 100
    for field in (
        "backbone_width", "embed_dim", "input_resolution", "anchor_sizes", "anchor_aspect_ratios",
        "rpn_nms_thresh", "num_classes", "pooler_resolution", "use_text_emb", "temperature",
        "score_thresh_test", "nms_thresh_test", "soft_nms_enabled", "pixel_mean", "pixel_std",
    ):
        assert getattr(ours, field) == pytest.approx(getattr(ref, field)), field


def test_synthetic_batch_has_the_jax_pixels():
    want = _synthetic_batch(2, 24, 32, seed=3, with_trgt=False)
    got = synthetic_batch(2, 24, 32, seed=3, device="cpu")
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
    np.testing.assert_array_equal(got.image_sizes.numpy(), np.asarray(want.image_sizes))


def test_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CUDA-less refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(flagship_config(tiny=True))


# ---------------- import hygiene ----------------
def _port_sources():
    return sorted((REPO / "cddmsl_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_nothing_of_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "cddmsl_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
