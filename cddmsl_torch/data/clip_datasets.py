"""The image-text pair dataset over TSV shards, the RegionCLIP pretraining
corpus (counterpart of cddmsl_tpu/data/clip_datasets.py
`CLIPImgTxtPairTSVDataset`).

Row i of an image shard is `key<TAB>base64 JPEG`, row i of its text shard
`key<TAB>caption`; the shards pair one to one. A caption that parses as a
JSON dict gives its "captions" list's first entry, a JSON list its first
entry; any other text is the caption itself.
"""

import base64
import io
import json
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..structures.tsv_file import TSVFile


class CLIPImgTxtPairTSVDataset:
    def __init__(self, image_tsv_files: Sequence[str], text_tsv_files: Sequence[str]):
        if len(image_tsv_files) != len(text_tsv_files):
            raise ValueError(f"{len(image_tsv_files)} image shards but {len(text_tsv_files)} text shards")
        self.image_tsvs = [TSVFile(f) for f in image_tsv_files]
        self.text_tsvs = [TSVFile(f) for f in text_tsv_files]
        for path, it, tt in zip(image_tsv_files, self.image_tsvs, self.text_tsvs):
            if len(it) != len(tt):
                raise ValueError(f"{path}: {len(it)} image rows but {len(tt)} text rows")
        self._cum = np.cumsum([0] + [len(t) for t in self.image_tsvs])

    def __len__(self) -> int:
        return int(self._cum[-1])

    def _locate(self, idx: int) -> Tuple[int, int]:
        shard = int(np.searchsorted(self._cum, idx, side="right") - 1)
        return shard, idx - int(self._cum[shard])

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        """(HWC uint8 RGB image, caption)."""
        shard, row = self._locate(idx)
        img_row = self.image_tsvs[shard][row]
        cap = self.text_tsvs[shard][row][-1]
        img = np.asarray(Image.open(io.BytesIO(base64.b64decode(img_row[-1]))).convert("RGB"))
        try:
            parsed = json.loads(cap)
            if isinstance(parsed, dict):
                caps = parsed.get("captions", [cap])
                cap = caps[0] if caps else ""
            elif isinstance(parsed, list):
                cap = parsed[0] if parsed else ""
        except (json.JSONDecodeError, TypeError):  # not JSON, or a "captions" entry that cannot be indexed
            pass
        return img, str(cap)

    def batches(self, batch_size: int, image_size: int = 224, seed: int = 0,
                epochs: Optional[int] = None) -> Iterator[Tuple[np.ndarray, List[str]]]:
        """(images (B, S, S, 3) uint8, captions) without end, or for
        `epochs`: each epoch a new permutation of RandomState(seed), the last
        partial batch dropped, every image resized to S x S with PIL's
        bicubic filter (the aspect ratio is not kept)."""
        rng = np.random.RandomState(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self))
            for i in range(0, len(order) - batch_size + 1, batch_size):
                imgs, caps = [], []
                for j in order[i : i + batch_size]:
                    img, cap = self[int(j)]
                    imgs.append(np.asarray(Image.fromarray(img).resize((image_size, image_size), Image.BICUBIC)))
                    caps.append(cap)
                yield np.stack(imgs), caps
            epoch += 1
