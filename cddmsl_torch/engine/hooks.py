"""Trainer hooks (the port's copy of the part of cddmsl_tpu/engine/hooks.py
that `DefaultTrainer.build_hooks` uses): `HookBase`, `IterationTimer`,
`PeriodicWriter`, `PeriodicCheckpointer` and `EvalHook`. The JAX package's
`LRScheduler` is a no-op and has no counterpart: the LR is a function of the
optimizer's count inside `Optimizer.step` (solver/build.py). A hook sees the
trainer as `self.trainer` and its `EventStorage` as `self.trainer.storage`."""

import logging
import time
from typing import Callable, List

logger = logging.getLogger(__name__)


class HookBase:
    trainer = None

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class IterationTimer(HookBase):
    """Average host wall time per iteration after `warmup_iter` iterations,
    logged at the end of training."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup = warmup_iter
        self._start = None
        self._step_start = None
        self._total = 0.0
        self._count = 0

    def before_train(self):
        self._start = time.perf_counter()

    def before_step(self):
        self._step_start = time.perf_counter()

    def after_step(self):
        self._count += 1
        if self._count > self._warmup:
            self._total += time.perf_counter() - self._step_start

    def after_train(self):
        n = max(self._count - self._warmup, 1)
        logger.info(
            "Total training time: %.1fs (%.4fs/it over %d iterations)",
            time.perf_counter() - self._start, self._total / n, n,
        )


class PeriodicWriter(HookBase):
    def __init__(self, writers: List, period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        storage = self.trainer.storage
        if (storage.iter + 1) % self._period == 0:
            for w in self._writers:
                w.write(storage)

    def after_train(self):
        for w in self._writers:
            w.write(self.trainer.storage)  # the tail
            w.close()


class PeriodicCheckpointer(HookBase):
    """Saves `model_{iter:07d}` every `period` iterations."""

    def __init__(self, checkpointer, period: int):
        self._ckptr = checkpointer
        self._period = period

    def after_step(self):
        it = self.trainer.storage.iter
        if self._period and (it + 1) % self._period == 0:
            self._ckptr.save(f"model_{it:07d}", self.trainer.state)


class EvalHook(HookBase):
    """Runs `eval_fn` every `period` iterations; `DefaultTrainer.train` runs
    the final evaluation itself."""

    def __init__(self, period: int, eval_fn: Callable):
        self._period = period
        self._fn = eval_fn

    def after_step(self):
        it = self.trainer.storage.iter
        if self._period and (it + 1) % self._period == 0:
            self._fn()
