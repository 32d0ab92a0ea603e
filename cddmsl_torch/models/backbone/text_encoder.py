"""CLIP's text transformer (counterpart of
cddmsl_tpu/models/backbone/text_encoder.py: `quick_gelu`,
`MultiheadAttention`, `ResidualAttentionBlock`, `CLIPTextEncoder` and
`build_clip_text_encoder_module`).

A causal stack of pre-LN blocks with QuickGELU MLPs over token and
position embeddings, a final LayerNorm, and the EOT token's state (the
first position of the largest id: EOT has the highest) times
`text_projection`. Parameter names are the OpenAI-CLIP text tower's
(`token_embedding.weight`, `positional_embedding`,
`transformer.resblocks.{i}.attn.in_proj_weight`, `...mlp.c_fc.weight`,
`ln_final.weight`, `text_projection`), so a reference state dict loads by
its prefix alone (checkpoint/convert_torch.py `load_text_tower`).

Rounding follows the JAX module: parameters stay float32 and are cast to
the compute dtype at use; the LayerNorms run in float32 and their outputs
are cast back; attention scores are float32 products of the compute-dtype
q and k, divided by sqrt(head_dim), masked with -inf above the diagonal
and soft-maxed in float32, then cast to the compute dtype before the
product with v; the final projection is float32.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...config import EMBED_DIMS


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), CLIP's GELU."""
    return x * torch.sigmoid(1.702 * x)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (a packed (3C, C)
    `in_proj_weight` applied as x @ W.T, and `out_proj`) with the JAX
    module's arithmetic."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        n, l, c = x.shape
        qkv = x @ self.in_proj_weight.T.to(x.dtype) + self.in_proj_bias.to(x.dtype)
        hd = c // self.heads
        q, k, v = (t.reshape(n, l, self.heads, hd) for t in qkv.split(c, dim=-1))
        attn = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
        # a divisor on the device: PyTorch's CUDA division by a host scalar multiplies by its reciprocal
        attn = attn / torch.full((), math.sqrt(hd), dtype=torch.float32, device=x.device)
        if causal:
            mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
            attn = attn.masked_fill(~mask, float("-inf"))
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("nhqk,nkhd->nqhd", attn, v).reshape(n, l, c)
        return _linear(self.out_proj, out)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, width * 4)
        self.c_proj = nn.Linear(width * 4, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.c_proj, quick_gelu(_linear(self.c_fc, x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = MultiheadAttention(width, heads)
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = MLP(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(_layer_norm(self.ln_1, x).to(x.dtype), causal=causal)
        return x + self.mlp(_layer_norm(self.ln_2, x).to(x.dtype))


class Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads) for _ in range(layers)])


class CLIPTextEncoder(nn.Module):
    """The reference's CLIPLangEncoder: token ids (N, context_length) ->
    (N, embed_dim) at the EOT token, or (N, L, embed_dim) with
    `only_eot=False`."""

    def __init__(self, embed_dim: int = 1024, context_length: int = 77, vocab_size: int = 49408, width: int = 512,
                 heads: int = 8, layers: int = 12, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.context_length = context_length
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = Transformer(width, heads, layers)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def embed(self, text: torch.Tensor) -> torch.Tensor:
        return self.token_embedding.weight[text].to(self.dtype) + self.positional_embedding.to(self.dtype)[None]

    def finalize(self, x: torch.Tensor, text: torch.Tensor, only_eot: bool = True) -> torch.Tensor:
        x = _layer_norm(self.ln_final, x)
        if only_eot:
            x = x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]
        return x @ self.text_projection

    def forward(self, text: torch.Tensor, only_eot: bool = True) -> torch.Tensor:
        text = text.long()
        x = self.embed(text)
        for block in self.transformer.resblocks:
            x = block(x, causal=True)
        return self.finalize(x, text, only_eot)


def build_clip_text_encoder(cfg) -> CLIPTextEncoder:
    """The concept tool's tower, as `build_clip_text_encoder_module` reads
    the config: width, heads and embedding width from MODEL.RESNETS.DEPTH
    (MODEL.TEXT_ENCODER.WIDTH and HEADS are not read), context length,
    vocabulary and depth from MODEL.TEXT_ENCODER, the dtype from
    TPU.COMPUTE_DTYPE. Its weights are the modules' defaults: load them or
    fill them."""
    depth = cfg.MODEL.RESNETS.DEPTH
    if depth not in EMBED_DIMS:
        raise NotImplementedError(f"MODEL.RESNETS.DEPTH = {depth!r} has no CLIP text tower")
    t = cfg.MODEL.TEXT_ENCODER
    return CLIPTextEncoder(
        embed_dim=EMBED_DIMS[depth],
        context_length=t.CONTEXT_LENGTH,
        vocab_size=t.VOCAB_SIZE,
        width={50: 512, 101: 512, 200: 640}[depth],
        heads={50: 8, 101: 8, 200: 10}[depth],
        layers=t.LAYERS,
        dtype=torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32,
    )
