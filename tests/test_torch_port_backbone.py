"""cddmsl_torch's ModifiedResNet against cddmsl_tpu's on the CPU, in
float32, with the JAX parameters carried across by
cddmsl_torch/checkpoint/convert_jax.py: res4, res5_forward and
attnpool_forward agree to rtol 1e-4, atol 1e-5 (the two frameworks sum the
convolutions in different orders)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.models.backbone.clip_resnet import ModifiedResNet as JaxModifiedResNet
from cddmsl_torch.checkpoint import convert_jax
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.models.backbone.clip_resnet import ModifiedResNet
from cddmsl_torch.models.build import build_model

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LAYERS, WIDTH, EMBED = (1, 1, 1, 1), 16, 128


def fill_params(shapes, seed=0):
    """Signed random values for a JAX parameter tree given by its shapes:
    fan-in scaled kernels, FrozenBN with running_var in [0.5, 1.5],
    LayerNorm scales in [0.5, 1.5], a unit-normal mapper prefix."""
    r = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("running_var", "scale"):
            return r.uniform(0.5, 1.5, s.shape)
        if name == "prefix_const":
            return r.randn(*s.shape)
        if name == "weight" and len(s.shape) == 1:  # FrozenBN scale
            return r.uniform(0.5, 1.0, s.shape)
        if name in ("bias", "running_mean"):
            return r.uniform(-0.1, 0.1, s.shape)
        if name == "kernel":
            return r.randn(*s.shape) * (2.0 / np.prod(s.shape[:-1])) ** 0.5
        return r.randn(*s.shape) * s.shape[-1] ** -0.5  # embeddings

    return jax.tree_util.tree_map_with_path(lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _inverse_rules(rules=None):
    """(port key regex, JAX path builder, layout) for each of `rules` (by
    default `convert_jax_params`'s for the C4 detector): the template's
    back-references become named groups, the pattern's groups take their
    values back."""
    out = []
    for pattern, template, layout in rules or convert_jax._RULES:
        groups = re.findall(r"\(([^()]*)\)", pattern)
        regex, seen = "", set()
        for i, part in enumerate(re.split(r"\\(\d)", template)):
            if i % 2 == 0:
                regex += re.escape(part)
            else:
                regex += f"(?P=g{part})" if part in seen else f"(?P<g{part}>{groups[int(part) - 1]})"
                seen.add(part)
        pieces = re.split(r"\([^()]*\)", pattern)  # the literal text around the pattern's groups
        out.append((re.compile(regex), pieces, layout))
    return out


_INVERSE_LAYOUT = {"conv": lambda s: (s[2], s[3], s[1], s[0]), "dense": lambda s: (s[1], s[0]), "copy": tuple,
                   "deconv": lambda s: (s[2], s[3], s[0], s[1])}


def port_tree_shapes(module, use_text_emb=None, rules=None):
    """The JAX parameter tree (`ShapeDtypeStruct` leaves) that
    `convert_jax_params` maps onto `module`'s state dict, read off it
    through the inverse of the converter's rules for the module's family
    (the FPN family's for a model with an FPN, DC5's for FPNRCNN on res5,
    else the C4 detector's) without tracing the JAX model. With the
    same structure and shapes as `eval_shape` of JAX's `init_all`,
    `fill_params` fills it with the same values."""
    if rules is None:
        from cddmsl_torch.models.backbone.resnet import FPN

        backbone = getattr(module, "backbone", None)
        rules = (convert_jax._FPN_RULES if isinstance(backbone, FPN)
                 else convert_jax._DC5_RULES if getattr(module, "dc5", False) else convert_jax._RULES)
    use_text_emb = getattr(module, "use_text_emb", False) if use_text_emb is None else use_text_emb
    inverse, tree = _inverse_rules(rules), {}
    # the two classifiers share the torch name `cls_score.weight`
    other_head = "roi_heads/box_predictor/cls_score" + ("/kernel" if use_text_emb else "_weight")
    state = module.state_dict()
    # a deformable block's 3x3 is JAX's raw `conv2_kernel`, a plain one's conv2/kernel
    deform = {k[: -len(".conv2_offset.weight")] for k in state if k.endswith(".conv2_offset.weight")}
    for key, value in state.items():
        offline = key.startswith(convert_jax._OFFLINE + ".")
        name = "backbone" + key[len(convert_jax._OFFLINE):] if offline else key
        raw = key.endswith(".conv2.weight") and key[: -len(".conv2.weight")] in deform
        for regex, pieces, layout in inverse:
            m = regex.fullmatch(name)
            if m and (pieces[0] == other_head or raw != pieces[-1].endswith("conv2_kernel")):
                continue
            if m:
                groups = [m.group(f"g{i}") for i in range(1, len(pieces))]
                path = pieces[0] + "".join(g + p for g, p in zip(groups, pieces[1:]))
                break
        else:
            raise KeyError(key)
        if offline:
            path = convert_jax._OFFLINE + path[len("backbone"):]
        *nodes, leaf = path.split("/")
        node = tree
        for n in nodes:
            node = node.setdefault(n, {})
        node[leaf] = jax.ShapeDtypeStruct(_INVERSE_LAYOUT[layout](tuple(value.shape)), jnp.float32)
    return {"params": tree}


def jax_param_shapes(model_config):
    """The JAX GeneralizedRCNN parameter tree (`ShapeDtypeStruct` leaves)
    of the configuration `model_config` (a port `ModelConfig`), read off the
    port's training build through the inverse of `convert_jax_params`
    (`port_tree_shapes`). It equals `eval_shape` of the JAX model's
    `init_all` (tests/test_torch_port_train.py holds the two equal) without
    tracing the JAX model, so `fill_params` fills it with the same values."""
    return port_tree_shapes(build_model(model_config, device="cpu", training=True), model_config.use_text_emb,
                            convert_jax._RULES)


@pytest.fixture(scope="module")
def backbones():
    jax_model = JaxModifiedResNet(layers=LAYERS, output_dim=EMBED, heads=WIDTH * 32 // 64, width=WIDTH)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    crops = jnp.zeros((1, 14, 14, WIDTH * 16), jnp.float32)

    def init_all(m, x, crops):  # touch res4, layer4 and the attention pool
        return m(x), m.attnpool_forward(m.res5_forward(crops))

    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), x, crops, method=init_all))
    params = fill_params(shapes)
    state = convert_jax_params({"backbone": params["params"]})
    ours = ModifiedResNet(LAYERS, EMBED, WIDTH * 32 // 64, WIDTH).eval()
    ours.load_state_dict({k[len("backbone."):]: v for k, v in state.items()}, strict=True)
    return jax_model, params, ours


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_res4_matches_jax(backbones):
    jax_model, params, ours = backbones
    img = np.random.RandomState(1).randn(2, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda p, x: jax_model.apply(p, x)["res4"])(params, jnp.asarray(img))
    with torch.no_grad():
        got = ours(torch.from_numpy(img))["res4"]
    assert got.shape == (2, 4, 6, WIDTH * 16) and got.is_contiguous()
    _close(got, want)


def test_res5_and_attnpool_match_jax(backbones):
    jax_model, params, ours = backbones
    crops = np.abs(np.random.RandomState(2).randn(3, 14, 14, WIDTH * 16)).astype(np.float32)
    want_r5 = jax.jit(lambda p, x: jax_model.apply(p, x, method=jax_model.res5_forward))(params, jnp.asarray(crops))
    with torch.no_grad():
        r5 = ours.res5_forward(torch.from_numpy(crops))
    _close(r5, want_r5)
    want_emb = jax.jit(lambda p, x: jax_model.apply(p, x, method=jax_model.attnpool_forward))(params, want_r5)
    with torch.no_grad():
        emb = ours.attnpool_forward(torch.from_numpy(np.array(want_r5)))
    assert emb.shape == (3, EMBED)
    _close(emb, want_emb)


def test_global_embed_matches_jax(backbones):
    jax_model, params, ours = backbones
    img = np.random.RandomState(3).randn(2, 224, 224, 3).astype(np.float32)
    want = jax.jit(lambda p, x: jax_model.apply(p, x, method=jax_model.global_embed))(params, jnp.asarray(img))
    with torch.no_grad():
        got = ours.global_embed(torch.from_numpy(img))
    _close(got, want)


def test_attnpool_refuses_other_grids(backbones):
    """A grid other than 7x7 is no longer refused: the positional embedding
    is resized as JAX resizes it (bilinear, antialiased when it shrinks),
    down to 5x6 and up to 10x12."""
    jax_model, params, ours = backbones
    for seed, hw in enumerate(((5, 6), (10, 12))):
        feats = np.random.RandomState(seed).randn(2, *hw, WIDTH * 32).astype(np.float32)
        want = jax.jit(lambda p, x: jax_model.apply(p, x, method=jax_model.attnpool_forward))(params, jnp.asarray(feats))
        with torch.no_grad():
            got = ours.attnpool_forward(torch.from_numpy(feats))
        _close(got, want)


def test_converter_rejects_unknown_keys(backbones):
    _, params, _ = backbones
    extra = {"backbone": params["params"], "mystery_head": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="mystery_head"):
        convert_jax_params(extra)
    # the image projector maps whatever the branch (every training build holds it)
    projector = {"backbone": params["params"], "image_projector": {"fc1": {"kernel": np.zeros((2, 3), np.float32)}}}
    got = convert_jax_params(projector)
    assert got.keys() == convert_jax_params({"backbone": params["params"]}).keys() | {"image_projector.fc1.weight"}
    assert got["image_projector.fc1.weight"].shape == (3, 2)
    # the offline backbone is the backbone's tree under its own name
    both = convert_jax_params({"backbone": params["params"], "offline_backbone": params["params"]})
    ours = convert_jax_params({"backbone": params["params"]})
    assert both.keys() == ours.keys() | {"offline_" + k for k in ours}
    assert all(torch.equal(both["offline_" + k], v) for k, v in ours.items())
