"""cddmsl_torch's ModifiedResNet against cddmsl_tpu's on the CPU, in
float32, with the JAX parameters carried across by
cddmsl_torch/checkpoint/convert_jax.py: res4, res5_forward and
attnpool_forward agree to rtol 1e-4, atol 1e-5 (the two frameworks sum the
convolutions in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cddmsl_tpu.models.backbone.clip_resnet import ModifiedResNet as JaxModifiedResNet
from cddmsl_torch.checkpoint.convert_jax import convert_jax_params
from cddmsl_torch.models.backbone.clip_resnet import ModifiedResNet

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LAYERS, WIDTH, EMBED = (1, 1, 1, 1), 16, 128


def fill_params(shapes, seed=0):
    """Signed random values for a JAX parameter tree given by its shapes:
    fan-in scaled kernels, FrozenBN with running_var in [0.5, 1.5]."""
    r = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "running_var":
            return r.uniform(0.5, 1.5, s.shape)
        if name == "weight" and len(s.shape) == 1:  # FrozenBN scale
            return r.uniform(0.5, 1.0, s.shape)
        if name in ("bias", "running_mean"):
            return r.uniform(-0.1, 0.1, s.shape)
        if name == "kernel":
            return r.randn(*s.shape) * (2.0 / np.prod(s.shape[:-1])) ** 0.5
        return r.randn(*s.shape) * s.shape[-1] ** -0.5  # embeddings

    return jax.tree_util.tree_map_with_path(lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


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
    _, _, ours = backbones
    with pytest.raises(NotImplementedError):
        ours.attnpool_forward(torch.zeros(1, 5, 5, WIDTH * 32))


def test_converter_rejects_unknown_keys(backbones):
    _, params, _ = backbones
    extra = {"backbone": params["params"], "mystery_head": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="mystery_head"):
        convert_jax_params(extra)
    skipped = {"backbone": params["params"], "offline_backbone": params["params"], "v2l_mapper": {}}
    assert convert_jax_params(skipped).keys() == convert_jax_params({"backbone": params["params"]}).keys()
