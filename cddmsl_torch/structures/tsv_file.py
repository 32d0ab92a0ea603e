"""TSV files with a `.lineidx` of row offsets for random access
(counterpart of cddmsl_tpu/structures/tsv_file.py: `generate_lineidx`,
`TSVFile`), the storage of the RegionCLIP image-text pretraining corpus.
A missing `.lineidx` beside the file is written on first open."""

import os
from typing import List, Optional


def generate_lineidx(tsv_path: str, lineidx_path: str) -> None:
    """The byte offset of each line of `tsv_path`, one per line."""
    offsets = []
    with open(tsv_path, "rb") as f:
        pos = 0
        for line in f:
            offsets.append(pos)
            pos += len(line)
    with open(lineidx_path, "w") as f:
        f.write("\n".join(str(o) for o in offsets))


class TSVFile:
    def __init__(self, tsv_file: str, generate_lineidx_if_missing: bool = True):
        self.tsv_file = tsv_file
        self.lineidx_file = os.path.splitext(tsv_file)[0] + ".lineidx"
        if not os.path.exists(self.lineidx_file) and generate_lineidx_if_missing:
            generate_lineidx(tsv_file, self.lineidx_file)
        self._fp = None
        self._lineidx: Optional[List[int]] = None

    def _ensure(self) -> None:
        if self._lineidx is None:
            with open(self.lineidx_file) as f:
                self._lineidx = [int(line) for line in f if line.strip()]
        if self._fp is None:
            self._fp = open(self.tsv_file, "r")

    def num_rows(self) -> int:
        self._ensure()
        return len(self._lineidx)

    def __len__(self) -> int:
        return self.num_rows()

    def seek(self, idx: int) -> List[str]:
        """Row `idx`, split at tabs."""
        self._ensure()
        self._fp.seek(self._lineidx[idx])
        return self._fp.readline().rstrip("\n").split("\t")

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)

    def close(self) -> None:
        if self._fp:
            self._fp.close()
            self._fp = None
