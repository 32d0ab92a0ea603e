"""GPT-2 with a preallocated KV cache (counterpart of
cddmsl_tpu/models/gpt2.py `GPT2Config`, `GPT2Block`, `GPT2LMHead` and
`init_cache`).

The modules carry the names of HF's `GPT2LMHeadModel` (`transformer.wte`,
`transformer.h.{i}.attn.c_attn`, `transformer.h.{i}.mlp.c_fc`,
`transformer.ln_f`, ...), and the projections are HF's Conv1D, whose weight is
(in, out), so an HF state dict loads through
`checkpoint.convert_torch.convert_hf_gpt2`. The output projection is tied to
`wte` (HF's `lm_head.weight` is the same tensor).

It runs in float32, as the JAX package builds it for the caption model.
Numerics follow the JAX package: attention logits divided by sqrt(head
dim) and masked with the float32 minimum (not -inf) before the softmax;
gelu_new written out; LayerNorm eps 1e-5; logits `x @ wte.T`. With a
cache, a call writes its keys and values at `cache_index` into the
preallocated (B, S, heads, head dim) tensors and its queries attend over
the whole cache, to the keys at positions up to their own.
"""

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

Cache = List[Dict[str, torch.Tensor]]


class GPT2Config(NamedTuple):
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12


class Conv1D(nn.Module):
    """HF's Conv1D: x @ weight + bias with weight (in, out)."""

    def __init__(self, nx: int, nf: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(nx, nf))
        self.bias = nn.Parameter(torch.zeros(nf))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight) + self.bias


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.n_head = cfg.n_head
        self.c_attn = Conv1D(cfg.n_embd, 3 * cfg.n_embd)
        self.c_proj = Conv1D(cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: int = 0) -> torch.Tensor:
        b, t, c = x.shape
        hd = c // self.n_head
        q, k, v = (y.reshape(b, t, self.n_head, hd) for y in self.c_attn(x).split(c, dim=-1))
        if cache is not None:
            cache["k"][:, cache_index : cache_index + t] = k
            cache["v"][:, cache_index : cache_index + t] = v
            k, v = cache["k"], cache["v"]
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        attn = torch.softmax(torch.where(mask, attn, torch.finfo(torch.float32).min), dim=-1)
        return self.c_proj(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, c))


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.c_fc = Conv1D(cfg.n_embd, 4 * cfg.n_embd)
        self.c_proj = Conv1D(4 * cfg.n_embd, cfg.n_embd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c_fc(x)
        h = 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h ** 3)))  # gelu_new
        return self.c_proj(h)


class GPT2Block(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then + mlp(ln_2(x))."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, eps=1e-5)
        self.attn = GPT2Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, eps=1e-5)
        self.mlp = GPT2MLP(cfg)

    def forward(self, x, mask, cache=None, cache_index: int = 0):
        x = x + self.attn(self.ln_1(x), mask, cache, cache_index)
        return x + self.mlp(self.ln_2(x))


class GPT2Model(nn.Module):
    """HF's `transformer`: the embeddings, the blocks and the final norm."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd)
        self.h = nn.ModuleList(GPT2Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=1e-5)


class GPT2LMHead(nn.Module):
    def __init__(self, cfg: GPT2Config = GPT2Config()):
        super().__init__()
        self.cfg = cfg
        self.transformer = GPT2Model(cfg)

    def hidden(self, input_embeds: torch.Tensor, position_offset: int = 0, caches: Optional[Cache] = None,
               cache_index: int = 0) -> torch.Tensor:
        """input_embeds (B, T, C) -> the final norm's output (B, T, C). With
        `caches` the T positions start at `cache_index` and the caches are
        written in place."""
        tr = self.transformer
        t = input_embeds.shape[1]
        dev = input_embeds.device
        positions = torch.arange(t, device=dev) + position_offset
        x = input_embeds + tr.wpe.weight[positions]
        if caches is None:
            causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))
        else:
            kpos = torch.arange(caches[0]["k"].shape[1], device=dev)[None, :]
            qpos = (torch.arange(t, device=dev) + cache_index)[:, None]
            causal = kpos <= qpos
        mask = causal[None, None]
        for i, block in enumerate(tr.h):
            x = block(x, mask, None if caches is None else caches[i], cache_index)
        return tr.ln_f(x)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(..., C) -> (..., vocab) logits, tied to wte."""
        return hidden @ self.transformer.wte.weight.T

    def forward(self, input_embeds, position_offset: int = 0, caches: Optional[Cache] = None,
                cache_index: int = 0) -> Tuple[torch.Tensor, Optional[Cache]]:
        """-> (logits (B, T, vocab), the caches)."""
        return self.logits(self.hidden(input_embeds, position_offset, caches, cache_index)), caches

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer.wte.weight[tokens]


def init_cache(cfg: GPT2Config, batch: int, length: int, dtype=torch.float32, device="cpu") -> Cache:
    """Zeroed keys and values, (batch, length, heads, head dim) per layer."""
    shape = (batch, length, cfg.n_head, cfg.n_embd // cfg.n_head)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layer)]
