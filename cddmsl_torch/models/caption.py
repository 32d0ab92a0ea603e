"""The ClipCap caption model and its decode (counterpart of
cddmsl_tpu/models/caption.py `ClipCaptionModel`, `generate`,
`pseudo_labeling_loss` and `unsupervised_kl_loss`).

A CLIP embedding is mapped by `clip_project` (a ClipCap `TransformerMapper`)
to `prefix_length` GPT-2 input embeddings; `gpt` is GPT-2. The model runs in
float32 whatever the detector computes in: prefixes are cast on the way in.
Its parameter names are the reference ClipCap checkpoint's (`clip_project.*`,
`gpt.transformer.*`).

`generate` decodes one token per step over a KV cache preallocated for
`prefix_length + max_len` positions: the prefix is written once (`prefill`),
then each step feeds the token it emitted (`decode_step`). Greedy by default,
or top-p sampling from the caller's `torch.Generator`. A row that has emitted
the stop token emits it again from then on and is not `live`.

The teacher-forced losses take their logits only at the positions that
predict the tokens; the full (B, prefix + T, vocab) logits are never formed.
They average over the live tokens; under a process group over the global
batch's (`comm.global_normalizer`: each rank's caption stops at its own
step), so that the ranks' mean is the global loss.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm
from .clipcap import TransformerMapper
from .gpt2 import Cache, GPT2Config, GPT2LMHead, init_cache

STOP_TOKEN = 13  # "." in the GPT-2 BPE vocabulary


class ClipCaptionModel(nn.Module):
    def __init__(self, prefix_length: int = 40, clip_length: int = 40, dim_clip: int = 1024,
                 gpt_config: GPT2Config = GPT2Config()):
        super().__init__()
        self.prefix_length = prefix_length
        self.gpt_config = gpt_config
        self.clip_project = TransformerMapper(
            dim_clip=dim_clip, dim_embedding=gpt_config.n_embd, prefix_length=prefix_length, clip_length=clip_length,
        )
        self.gpt = GPT2LMHead(gpt_config)

    def map_prefix(self, prefix: torch.Tensor) -> torch.Tensor:
        """(B, dim_clip) -> (B, prefix_length, n_embd) in float32."""
        return self.clip_project(prefix.float())

    def _hidden(self, tokens: torch.Tensor, prefix: torch.Tensor) -> torch.Tensor:
        inputs = torch.cat([self.map_prefix(prefix), self.gpt.embed_tokens(tokens)], dim=1)
        return self.gpt.hidden(inputs)

    def forward(self, tokens: torch.Tensor, prefix: torch.Tensor) -> torch.Tensor:
        """tokens (B, T), prefix (B, dim_clip) -> logits (B, prefix_length + T, vocab)."""
        return self.gpt.logits(self._hidden(tokens, prefix))

    def token_logits(self, tokens: torch.Tensor, prefix: torch.Tensor) -> torch.Tensor:
        """The logits that predict tokens[:, i], at positions prefix_length - 1 + i: (B, T, vocab)."""
        return self.gpt.logits(self._hidden(tokens, prefix)[:, self.prefix_length - 1 : -1])

    def caption_loss(self, tokens: torch.Tensor, prefix: torch.Tensor, token_mask: torch.Tensor) -> torch.Tensor:
        """Cross-entropy of the tokens given the prefix, averaged over
        `token_mask` (which the forward does not see)."""
        lp = F.log_softmax(self.token_logits(tokens, prefix), dim=-1)
        nll = -torch.gather(lp, -1, tokens[..., None])[..., 0]
        return torch.sum(nll * token_mask) / comm.global_normalizer(torch.sum(token_mask))

    def prefill(self, prefix_emb: torch.Tensor, total_len: int) -> Tuple[torch.Tensor, Cache]:
        """Writes the prefix into a fresh cache of `total_len` positions ->
        (the next token's logits (B, vocab), the cache)."""
        caches = init_cache(self.gpt_config, prefix_emb.shape[0], total_len, prefix_emb.dtype, prefix_emb.device)
        hidden = self.gpt.hidden(prefix_emb, 0, caches, 0)
        return self.gpt.logits(hidden[:, -1]), caches

    def decode_step(self, tokens: torch.Tensor, position: int, caches: Cache) -> Tuple[torch.Tensor, Cache]:
        """One cached step: tokens (B,) at `position` -> (next logits (B, vocab), caches)."""
        hidden = self.gpt.hidden(self.gpt.embed_tokens(tokens)[:, None], position, caches, position)
        return self.gpt.logits(hidden[:, -1]), caches


def _sample(logits: torch.Tensor, top_p: float, generator: Optional[torch.Generator]):
    if top_p <= 0.0:
        return torch.argmax(logits, dim=-1)  # the first maximum, as jnp.argmax
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff = torch.clamp(torch.sum(cum < top_p, dim=-1), max=logits.shape[-1] - 1)  # keep until cum > p (incl.)
    threshold = torch.gather(sorted_logits, -1, cutoff[:, None])
    masked = torch.where(logits >= threshold, logits, torch.full_like(logits, float("-inf")))
    return torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model: ClipCaptionModel, prefix: torch.Tensor, max_len: int = 67, top_p: float = 0.0,
             generator: Optional[torch.Generator] = None,
             stop_token: int = STOP_TOKEN) -> Tuple[torch.Tensor, torch.Tensor]:
    """prefix (B, dim_clip) -> (tokens (B, max_len) int64, live (B, max_len)
    bool): greedy (top_p 0) or top-p sampling from `generator`; the
    positions after the stop token are not live."""
    last_logits, caches = model.prefill(model.map_prefix(prefix), model.prefix_length + max_len)
    stopped = torch.zeros(prefix.shape[0], dtype=torch.bool, device=prefix.device)
    tokens, live = [], []
    for i in range(max_len):
        tok = _sample(last_logits, top_p, generator)
        emitted = torch.where(stopped, torch.full_like(tok, stop_token), tok)
        tokens.append(emitted)
        live.append(~stopped)
        stopped = stopped | (tok == stop_token)
        if i + 1 < max_len:  # the last token's logits are not read
            last_logits, caches = model.decode_step(emitted, model.prefix_length + i, caches)
    return torch.stack(tokens, dim=1), torch.stack(live, dim=1)


def pseudo_labeling_loss(model: ClipCaptionModel, prefix_src: torch.Tensor, prefix_trgt: torch.Tensor,
                         max_len: int = 40) -> torch.Tensor:
    """Greedy pseudo-captions of the source view (no gradient), then the
    target view taught to reproduce them."""
    tokens, valid = generate(model, prefix_src.detach(), max_len=max_len)
    return model.caption_loss(tokens, prefix_trgt, valid.float())


def unsupervised_kl_loss(model: ClipCaptionModel, prefix_src: torch.Tensor, prefix_trgt: torch.Tensor,
                         max_len: int = 40) -> torch.Tensor:
    """Per-step KL(source || target) of the two views' token distributions
    along the source view's greedy decode, averaged over its live steps."""
    tokens, valid = generate(model, prefix_src.detach(), max_len=max_len)
    with torch.no_grad():
        ls = model.token_logits(tokens, prefix_src.detach())
    lt = model.token_logits(tokens, prefix_trgt)
    kl = torch.sum(torch.softmax(ls, dim=-1) * (F.log_softmax(ls, dim=-1) - F.log_softmax(lt, dim=-1)), dim=-1)
    m = valid.float()
    return torch.sum(kl * m) / comm.global_normalizer(torch.sum(m))
