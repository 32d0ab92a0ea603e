"""CLIP's byte-level BPE tokenizer and its prompt templates (counterpart of
cddmsl_tpu/data/clip_tokenizer.py: `SimpleTokenizer`, `tokenize`,
`PROMPT_TEMPLATES`, `pre_tokenize`).

The vocabulary is the public OpenAI-CLIP merge list,
`bpe_simple_vocab_16e6.txt.gz` beside this module (49152 - 256 - 2 merges,
49408 tokens with <|startoftext|> and <|endoftext|>). A text is cleaned
(HTML entities, whitespace), lower-cased, split by CLIP's pattern and
byte-pair encoded; `tokenize` frames each one as SOT, up to
context_length - 2 tokens, EOT, zero-padded to context_length (77).
"""

import gzip
import html
import os
import re
from functools import lru_cache
from typing import List, Optional, Sequence, Union

import numpy as np

CONTEXT_LENGTH = 77
BPE_PATH = os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def bytes_to_unicode():
    """The reversible byte -> printable unicode character map of byte-level BPE."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path or BPE_PATH) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode("utf-8", errors="replace").replace("</w>", " ")


def tokenize(
    texts: Union[str, Sequence[str]], tokenizer: Optional[SimpleTokenizer] = None,
    context_length: int = CONTEXT_LENGTH,
) -> np.ndarray:
    """texts -> (N, context_length) int32: SOT, the first context_length - 2
    tokens, EOT, zeros."""
    if isinstance(texts, str):
        texts = [texts]
    tokenizer = tokenizer or SimpleTokenizer()
    sot = tokenizer.encoder["<|startoftext|>"]
    eot = tokenizer.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        toks = [sot] + tokenizer.encode(t)[: context_length - 2] + [eot]
        out[i, : len(toks)] = toks
    return out


# the 80 prompt templates of CLIP's ImageNet prompt engineering, in the
# reference's order (clip_prompt_utils.py)
PROMPT_TEMPLATES = [
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.", "the embroidered {}.",
    "a photo of a hard to see {}.", "a bright photo of a {}.", "a photo of a clean {}.",
    "a photo of a dirty {}.", "a dark photo of the {}.", "a drawing of a {}.",
    "a photo of my {}.", "the plastic {}.", "a photo of the cool {}.",
    "a close-up photo of a {}.", "a black and white photo of the {}.",
    "a painting of the {}.", "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.", "a cropped photo of a {}.",
    "a plastic {}.", "a photo of the dirty {}.", "a jpeg corrupted photo of a {}.",
    "a blurry photo of the {}.", "a photo of the {}.", "a good photo of the {}.",
    "a rendering of the {}.", "a {} in a video game.", "a photo of one {}.",
    "a doodle of a {}.", "a close-up photo of the {}.", "a photo of a {}.",
    "the origami {}.", "the {} in a video game.", "a sketch of a {}.",
    "a doodle of the {}.", "a origami {}.", "a low resolution photo of a {}.",
    "the toy {}.", "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.", "a photo of a nice {}.",
    "a photo of a weird {}.", "a blurry photo of a {}.", "a cartoon {}.",
    "art of a {}.", "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.", "a jpeg corrupted photo of the {}.",
    "a good photo of a {}.", "a plushie {}.", "a photo of the nice {}.",
    "a photo of the small {}.", "a photo of the weird {}.", "the cartoon {}.",
    "art of the {}.", "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.", "a dark photo of a {}.",
    "itap of a {}.", "graffiti of the {}.", "a toy {}.", "itap of my {}.",
    "a photo of a cool {}.", "a photo of a small {}.", "a tattoo of the {}.",
]


def pre_tokenize(class_names: Sequence[str], tokenizer: Optional[SimpleTokenizer] = None) -> np.ndarray:
    """Class names ("_" and "+" read as spaces) in every template ->
    (num_classes, num_templates, 77) int32."""
    tokenizer = tokenizer or SimpleTokenizer()
    out = []
    for name in class_names:
        prompts = [t.format(name.replace("_", " ").replace("+", " ")) for t in PROMPT_TEMPLATES]
        out.append(tokenize(prompts, tokenizer))
    return np.stack(out)
