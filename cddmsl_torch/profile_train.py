"""Where the time of the full-width training step goes, on one card.

    python -m cddmsl_torch.profile_train [--steps 3] [--top 25]

Builds `train_entry()` (the flagship at full width, bf16, 2x800x1344,
caption and KD on), runs three steps to warm up, then traces `--steps`
steps with `torch.profiler` (CPU and CUDA activity). Prints the card with
its power limit, ms per step on the host clock, the device's busy and idle
shares (the union of the kernels' intervals over the traced wall time), the
device time of each group of kernels (the port's K1/K3/K4, convolutions,
matrix products, the rest), the `--top` kernels by device time, and each of
the port's own kernels. Exits 1 without a card.
"""

import argparse
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

GROUPS = (
    ("K1 roi_align_fwd", ("roi_align_fwd_kernel",)),
    ("K3 roi_align_bwd", ("roi_align_bwd_kernel",)),
    ("K4 nms", ("nms",)),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "implicit_gemm", "wgrad", "dgrad", "fprop", "nchwToNhwc", "nhwcToNchw")),
    ("matrix product (cuBLAS)", ("gemm", "cutlass", "nvjet", "sm90_xmma")),
    ("sort / scan / index", ("sort", "radix", "scan", "index", "gather", "scatter", "cub")),
    ("reduction", ("reduce",)),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "elementwise and other"


def device_kernels(prof) -> list:
    """The device kernels of a `torch.profiler` trace, not the user
    annotations on the device timeline."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def busy_and_span_us(kernels) -> tuple:
    """(busy, span) in microseconds: the union of the kernels' intervals, and
    the time from the first kernel's start to the last one's end."""
    intervals = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in intervals:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    span_us = max(hi for _, hi in intervals) - intervals[0][0] if intervals else 0.0
    return busy_us, span_us


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from .entry import train_entry

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    model, optimizer, trainer, batch = train_entry("cuda")
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_us, span_us = busy_and_span_us(kernels)
    total = {}
    by_name = {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        total[_group(e.name)] = total.get(_group(e.name), 0.0) + dur
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
    steps = args.steps
    print(f"traced {steps} steps: {wall_ms / steps:.3f} ms/step host wall (profiler on), "
          f"{len(kernels) / steps:.0f} kernels/step, device busy {busy_us / 1e3 / steps:.3f} ms/step "
          f"= {busy_us / max(span_us, 1e-9):.4f} of the kernels' span, idle share {1 - busy_us / max(span_us, 1e-9):.4f}")
    kernel_sum = sum(total.values())
    print("groups_ms_per_step " + json.dumps(
        {g: round(t / 1e3 / steps, 4) for g, t in sorted(total.items(), key=lambda kv: -kv[1])}))
    print(f"kernel time sum {kernel_sum / 1e3 / steps:.3f} ms/step")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"  {t / 1e3 / steps:9.4f} ms  {_group(name):26s} {name[:110]}")
    print("the port's kernels, each:")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1]):
        if _group(name).startswith("K"):
            print(f"  {t / 1e3 / steps:9.4f} ms  {_group(name):26s} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
