"""Metric storage and writers (the port's copy of cddmsl_tpu/utils/events.py
without the TensorBoard writer).

Mirrors the reference event system (detectron2/utils/events.py):
`EventStorage` (per-iteration scalar store with median smoothing :274-486),
`JSONWriter` (:50) and `CommonMetricPrinter` (:181, ETA/lr/losses console
line)."""

import datetime
import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict

import numpy as np

logger = logging.getLogger(__name__)

_CURRENT_STORAGE = []


class HistoryBuffer:
    def __init__(self, window: int = 20):
        self._values = deque(maxlen=1000)
        self._window = window

    def update(self, value: float, iteration: int):
        self._values.append((iteration, value))

    def latest(self) -> float:
        return self._values[-1][1]

    def median(self, window: int = None) -> float:
        w = window or self._window
        vals = [v for _, v in list(self._values)[-w:]]
        return float(np.median(vals)) if vals else float("nan")


class EventStorage:
    def __init__(self, start_iter: int = 0):
        self._histories: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self._iter = start_iter
        self._smoothing_hints: Dict[str, bool] = {}

    @property
    def iter(self) -> int:
        return self._iter

    def step(self):
        self._iter += 1

    def put_scalar(self, name: str, value, smoothing_hint: bool = True):
        self._histories[name].update(float(value), self._iter)
        self._smoothing_hints[name] = smoothing_hint

    def histories(self) -> Dict[str, HistoryBuffer]:
        return self._histories

    def latest_with_smoothing(self) -> Dict[str, float]:
        out = {}
        for k, h in self._histories.items():
            out[k] = h.median() if self._smoothing_hints.get(k, True) else h.latest()
        return out

    def __enter__(self):
        _CURRENT_STORAGE.append(self)
        return self

    def __exit__(self, *args):
        if _CURRENT_STORAGE[-1] is not self:
            raise RuntimeError("EventStorage contexts closed out of order")
        _CURRENT_STORAGE.pop()


class EventWriter:
    def write(self, storage: EventStorage):
        raise NotImplementedError

    def close(self):
        pass


class JSONWriter(EventWriter):
    """Appends one JSON line per write to metrics.json (reference events.py:50)."""

    def __init__(self, json_file: str, window_size: int = 20):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")
        self._window = window_size

    def write(self, storage: EventStorage):
        entry = {"iteration": storage.iter}
        entry.update(storage.latest_with_smoothing())
        self._file.write(json.dumps(entry, sort_keys=True) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


class CommonMetricPrinter(EventWriter):
    """Console line with ETA / losses / lr (reference events.py:181)."""

    def __init__(self, max_iter: int):
        self._max_iter = max_iter
        self._last = None  # (iter, time)

    def write(self, storage: EventStorage):
        it = storage.iter
        eta = ""
        now = time.time()
        if self._last is not None and it > self._last[0]:
            per_iter = (now - self._last[1]) / (it - self._last[0])
            eta_sec = per_iter * (self._max_iter - it)
            eta = f"eta: {datetime.timedelta(seconds=int(eta_sec))}  "
        self._last = (it, now)
        losses = "  ".join(
            f"{k}: {h.median():.4g}"
            for k, h in storage.histories().items()
            if "loss" in k
        )
        lr = storage.histories().get("lr")
        lr_s = f"lr: {lr.latest():.5g}  " if lr else ""
        tm = storage.histories().get("time")
        tm_s = f"time: {tm.median():.4f}  " if tm else ""
        logger.info("%siter: %d  %s  %s%s", eta, it, losses, tm_s, lr_s)
