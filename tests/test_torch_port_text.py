"""The port's CLIP language side against cddmsl_tpu on the CPU, in float32:
the BPE tokenizer and the prompt templates exactly, the text tower to 1e-5
(JAX parameters carried across by `convert_jax_text_params`, and a
torch-CLIP state dict loaded by `load_text_tower` against JAX's
`convert_clip_text`), and `extract_concept_features` against the JAX tool's
file to 1e-6, which the port's `load_text_emb_classifier` then loads."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cddmsl_tpu.checkpoint as jax_checkpoint
from cddmsl_tpu.checkpoint.convert_torch import convert_clip_text
from cddmsl_tpu.data import clip_tokenizer as jax_tok
from cddmsl_tpu.models.backbone.text_encoder import CLIPTextEncoder as JaxCLIPTextEncoder
from cddmsl_torch import extract_concept_features
from cddmsl_torch.checkpoint.convert_jax import convert_jax_text_params, init_random_
from cddmsl_torch.checkpoint.convert_torch import load_text_emb_classifier, load_text_tower
from cddmsl_torch.config import flagship_config
from cddmsl_torch.data import clip_tokenizer as tok
from cddmsl_torch.data.datasets.voc import CLASS_NAMES
from cddmsl_torch.models.backbone.text_encoder import CLIPTextEncoder
from cddmsl_torch.models.build import build_model
from test_torch_port_backbone import fill_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5
# the tests' tower (tests/test_pretrain.py `_tiny_cfg`)
EMBED, CONTEXT, VOCAB, WIDTH, HEADS, LAYERS = 64, 8, 101, 32, 4, 2


@pytest.fixture(scope="module")
def tokenizers():
    return tok.SimpleTokenizer(), jax_tok.SimpleTokenizer()


def test_vocabulary_is_the_jax_package_file():
    assert Path(tok.BPE_PATH).read_bytes() == (REPO / "cddmsl_tpu/data/bpe_simple_vocab_16e6.txt.gz").read_bytes()


@pytest.mark.parametrize("texts", [
    list(CLASS_NAMES),
    ["Ünïcödé café — naïve 東京 🚗 &amp; &lt;b&gt;", "  multiple   spaces\tand\nnewlines ", "it's 3 o'clock!!"],
    [" ".join(["a photo of a very long caption"] * 20)],
], ids=["voc", "unicode", "too_long"])
def test_tokenize_equals_jax(tokenizers, texts):
    ours, theirs = tokenizers
    got = tok.tokenize(texts, ours)
    np.testing.assert_array_equal(got, jax_tok.tokenize(texts, theirs))
    assert got.shape == (len(texts), 77) and got.dtype == np.int32
    if len(texts) == 1:  # truncated to 75 tokens between SOT and EOT
        assert got[0, -1] == ours.encoder["<|endoftext|>"] and (got[0] > 0).all()
    assert [ours.decode(ours.encode(t)) for t in texts] == [theirs.decode(theirs.encode(t)) for t in texts]


def test_pre_tokenize_equals_jax(tokenizers):
    ours, theirs = tokenizers
    names = list(CLASS_NAMES) + ["traffic_light", "hot+dog"]
    got = tok.pre_tokenize(names, ours)
    assert got.shape == (22, 80, 77) and tok.PROMPT_TEMPLATES == jax_tok.PROMPT_TEMPLATES
    np.testing.assert_array_equal(got, jax_tok.pre_tokenize(names, theirs))


def _tokens(seed=0, n=5):
    """Rows of SOT, words, EOT (the largest id), zeros; the last row holds
    the largest id twice, so pooling takes the first."""
    r = np.random.RandomState(seed)
    out = np.zeros((n, CONTEXT), np.int32)
    for i in range(n):
        k = r.randint(1, CONTEXT - 1)
        out[i, : k + 2] = [VOCAB - 2] + list(r.randint(1, VOCAB - 2, k)) + [VOCAB - 1]
    out[-1, 2] = VOCAB - 1
    return out


@pytest.fixture(scope="module")
def towers():
    jax_model = JaxCLIPTextEncoder(embed_dim=EMBED, context_length=CONTEXT, vocab_size=VOCAB, width=WIDTH,
                                   heads=HEADS, layers=LAYERS)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, CONTEXT), jnp.int32)))
    params = fill_params(shapes, seed=3)
    ours = CLIPTextEncoder(EMBED, CONTEXT, VOCAB, WIDTH, HEADS, LAYERS).eval()
    ours.load_state_dict(convert_jax_text_params(params), strict=True)
    return jax_model, params, ours


@pytest.mark.parametrize("only_eot", [True, False])
def test_text_encoder_matches_jax(towers, only_eot):
    jax_model, params, ours = towers
    text = _tokens()
    want = jax_model.apply(params, jnp.asarray(text), only_eot=only_eot)
    with torch.no_grad():
        got = ours(torch.from_numpy(text), only_eot=only_eot)
    assert got.dtype == torch.float32 and got.shape == ((5, EMBED) if only_eot else (5, CONTEXT, EMBED))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_text_encoder_bf16_runs_in_fp32_at_its_ends(towers):
    """In bfloat16 the blocks compute in bf16; the embedding out of the
    final LayerNorm and projection is float32 and near the fp32 tower's."""
    _, _, ours = towers
    bf16 = CLIPTextEncoder(EMBED, CONTEXT, VOCAB, WIDTH, HEADS, LAYERS, dtype=torch.bfloat16).eval()
    bf16.load_state_dict(ours.state_dict())
    text = torch.from_numpy(_tokens(seed=1))
    with torch.no_grad():
        got, want = bf16(text), ours(text)
    assert got.dtype == torch.float32
    assert (got - want).abs().max() < 0.05 * want.abs().max()


@pytest.mark.parametrize("prefix", ["", "lang_encoder."])
def test_torch_clip_state_dict_loads_as_in_jax(prefix):
    """A torch-CLIP-named text tower (bare or under lang_encoder., with keys
    no converter takes) into the port by `load_text_tower` and into JAX by
    `convert_clip_text`: the same embeddings."""
    src = CLIPTextEncoder(EMBED, CONTEXT, VOCAB, WIDTH, HEADS, LAYERS)
    init_random_(src, torch.Generator().manual_seed(4))
    sd = {prefix + k: v for k, v in src.state_dict().items()}
    sd[prefix + "transformer.resblocks.0.attn.bias_k"] = torch.zeros(3)
    sd["visual.conv1.weight"] = torch.zeros(2, 3, 3, 3)
    ours = CLIPTextEncoder(EMBED, CONTEXT, VOCAB, WIDTH, HEADS, LAYERS)
    assert load_text_tower(ours, sd, prefix, "test") == len(src.state_dict())
    tree = convert_clip_text({k: v.numpy() for k, v in sd.items()}, prefix)
    jax_model = JaxCLIPTextEncoder(embed_dim=EMBED, context_length=CONTEXT, vocab_size=VOCAB, width=WIDTH,
                                   heads=HEADS, layers=LAYERS)
    text = _tokens(seed=2)
    want = jax_model.apply({"params": tree}, jnp.asarray(text))
    with torch.no_grad():
        got = ours(torch.from_numpy(text))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


# ---------------- extract_concept_features ----------------
def _jax_tool(name):
    path = REPO / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    _jax_tool(name).main()


@pytest.fixture(scope="module")
def concept_files(tmp_path_factory):
    """A 2-layer RN50 text tower (the real vocabulary: the prompts are real
    BPE) under lang_encoder., and a config that asks for 2 layers in fp32."""
    root = tmp_path_factory.mktemp("concepts")
    (root / "cfg.yaml").write_text('MODEL:\n  TEXT_ENCODER:\n    LAYERS: 2\nTPU:\n  COMPUTE_DTYPE: "float32"\n')
    tower = CLIPTextEncoder(1024, 77, 49408, 512, 8, 2)
    init_random_(tower, torch.Generator().manual_seed(5))
    sd = {"lang_encoder." + k: v for k, v in tower.state_dict().items()}
    sd["backbone.conv1.weight"] = torch.zeros(2, 3, 3, 3)
    torch.save({"model": sd}, root / "text.pth")
    torch.save({"model": {"backbone.conv1.weight": torch.zeros(2, 3, 3, 3)}}, root / "textless.pth")
    return root


def test_extract_concept_features_matches_the_jax_tool(concept_files, monkeypatch):
    """The JAX tool closes its jitted encoder over the numpy arrays that
    `convert_clip_text` returns, and indexing the numpy token embedding with
    a traced array raises TracerArrayConversionError; the tool is run here
    with the converted tree as JAX arrays, the same values."""
    root = concept_files
    convert = jax_checkpoint.convert_clip_text
    monkeypatch.setattr(jax_checkpoint, "convert_clip_text",
                        lambda sd, prefix: jax.tree_util.tree_map(jnp.asarray, convert(sd, prefix)))
    common = ["--config-file", str(root / "cfg.yaml"), "--weights", str(root / "text.pth"),
              "--classes", "traffic_light", "person"]
    _run_jax_tool(monkeypatch, "extract_concept_features", common + ["--out", str(root / "jax.npy")])
    # the .pth form, which MODEL.CLIP.TEXT_EMB_PATH reads
    got = extract_concept_features.main(common + ["--out", str(root / "ours.pth"), "--device", "cpu"])
    want = np.load(root / "jax.npy")
    assert want.shape == (2, 1024) and got.dtype == np.float32
    np.testing.assert_array_equal(torch.load(root / "ours.pth").numpy(), got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    model = build_model(dataclasses.replace(flagship_config(tiny=True), num_classes=2, embed_dim=1024), device="cpu")
    load_text_emb_classifier(model, str(root / "ours.pth"))
    np.testing.assert_array_equal(model.roi_heads.box_predictor.cls_score.weight.detach().numpy(), got)


def test_extract_concept_features_refuses_a_textless_file(concept_files):
    root = concept_files
    with pytest.raises(ValueError, match="holds no CLIP text-tower tensor"):
        extract_concept_features.main(["--config-file", str(root / "cfg.yaml"), "--weights",
                                       str(root / "textless.pth"), "--classes", "cat", "--out",
                                       str(root / "x.npy"), "--device", "cpu"])


def test_extract_concept_features_needs_a_card_by_default(concept_files):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CUDA-less refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract_concept_features.main(["--classes", "cat", "--out", str(concept_files / "y.npy")])
