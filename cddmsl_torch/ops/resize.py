"""Bicubic and bilinear resizes as `jax.image.resize` computes them: bicubic
with `antialias=False` for NHWC images, bilinear with the default
`antialias=True` for the attention pool's positional-embedding grid and
for the semantic head's NCHW maps (`resize_bilinear_nchw`).

Each resized axis is one (out, in) float32 weight matrix applied with a
matmul. The weights are those of jax/_src/image/scale.py
`compute_weight_mat`: the kernel (Keys cubic with a = -0.5, or the
triangle) at the sample positions (i + 0.5) / scale - 0.5, each column
renormalized to sum to 1 (so taps that fall outside the input are dropped,
not clamped), and zero where the sample lies wholly outside the input. With
antialiasing a downsizing axis widens the triangle by 1 / scale. An axis
whose size does not change is left as it is. `F.interpolate` is a different
function (bicubic a = -0.75, clamped borders, no antialiased triangle).

`jax.image.resize` runs inside a jitted program, and XLA fuses the sample
position's multiply-add and the kernel's polynomial, rounding each once. A
sample position near 1344 has an ulp of 1.2e-4, so one rounding more moves
a weight by ~1e-4; the position and the kernel are therefore computed in
float64 and rounded once to float32.
"""

from typing import Tuple

import numpy as np
import torch


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys kernel (a = -0.5) of float32 distances, rounded once."""
    x = x.double()
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out).float()


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """max(0, 1 - x) of float64 distances, rounded once."""
    return torch.clamp(1.0 - x, min=0.0).float()


def _weights(in_size: int, out_size: int, kernel, antialias: bool, device) -> torch.Tensor:
    """`compute_weight_mat` with zero translation: (out_size, in_size)."""
    inv_scale = float(np.float32(1.0 / (out_size / in_size)))
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    half = torch.arange(out_size, dtype=torch.float32, device=device) + 0.5
    sample_f = (half.double() * inv_scale - 0.5).float()
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    w = kernel(x.double() / kernel_scale)  # (in, out)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T.contiguous()


def bicubic_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out_size, in_size) float32 bicubic interpolation matrix."""
    return _weights(in_size, out_size, _keys_cubic, False, device)


def bilinear_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out_size, in_size) float32 antialiased bilinear matrix."""
    return _weights(in_size, out_size, _triangle, True, device)


def resize_bilinear_grid(grid: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """grid (H, W, C) -> (h, w, C), as `jax.image.resize(grid, (h, w, C),
    "bilinear")`; float32 weights applied in the grid's dtype."""
    h_in, w_in, _ = grid.shape
    h_out, w_out = size
    x = grid
    if h_out != h_in:
        x = torch.einsum("oh,hwc->owc", bilinear_weights(h_in, h_out, grid.device).to(x.dtype), x)
    if w_out != w_in:
        x = torch.einsum("ow,hwc->hoc", bilinear_weights(w_in, w_out, grid.device).to(x.dtype), x)
    return x


def _upsize_axis(x: torch.Tensor, w: torch.Tensor, dim: int) -> torch.Tensor:
    """x's axis `dim` through the (out, in) bilinear upsize matrix `w`, in
    float32, rounded once to x's dtype: each row's two taps (the matmul's
    nonzero terms) as two gathers and a weighted sum."""
    vals, idx = torch.topk(w, 2, dim=1)
    shape = [1] * x.dim()
    shape[dim] = w.shape[0]
    xf = x.float()
    y = xf.index_select(dim, idx[:, 0]) * vals[:, 0].reshape(shape) + xf.index_select(dim, idx[:, 1]) * vals[
        :, 1].reshape(shape)
    return y.to(x.dtype)


def resize_bilinear_nchw(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """x (B, C, H, W) -> (B, C, h, w) upsized (h >= H, w >= W), as
    `jax.image.resize(x_nhwc, (B, h, w, C), "bilinear")` (triangle weights,
    taps outside the input dropped and the rest renormalised: bilinear with
    clamped borders): W, then H, as JAX's einsum contracts them, each axis
    in float32 and rounded to x's dtype, as it rounds each of its two
    contractions."""
    h_in, w_in = x.shape[-2:]
    h_out, w_out = size
    if h_out < h_in or w_out < w_in:
        raise ValueError(f"resize_bilinear_nchw upsizes: {(h_in, w_in)} -> {(h_out, w_out)}")
    if w_out != w_in:
        x = _upsize_axis(x, bilinear_weights(w_in, w_out, x.device), x.dim() - 1)
    if h_out != h_in:
        x = _upsize_axis(x, bilinear_weights(h_in, h_out, x.device), x.dim() - 2)
    return x


def resize_bicubic(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """images (B, H, W, C) float32 -> (B, h, w, C) float32."""
    b, h_in, w_in, c = images.shape
    h_out, w_out = size
    x = images.float()
    if h_out != h_in:
        x = torch.einsum("oh,bhwc->bowc", bicubic_weights(h_in, h_out, images.device), x)
    if w_out != w_in:
        x = torch.einsum("ow,bhwc->bhoc", bicubic_weights(w_in, w_out, images.device), x)
    return x
