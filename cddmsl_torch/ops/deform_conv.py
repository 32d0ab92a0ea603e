"""Deformable convolution v1 and v2 in plain PyTorch (counterpart of
cddmsl_tpu/ops/deform_conv.py `_bilinear_sample`, `deform_conv2d` and
`modulated_deform_conv2d`, which are XLA there, not Pallas).

Each output position samples its K x K taps at the regular grid (position
x stride - padding + tap x dilation) moved by a learned offset, weighs the
taps by a learned mask under v2, and contracts the sampled columns with the
kernel (im2col: one (Ho*Wo, K*K*Cin) x (K*K*Cin, Cout) product an image).

Layout: activations NHWC by default (`layout="NCHW"` takes and returns
NCHW); offsets (N, Ho, Wo, 2*K*K) as (dy, dx) pairs per tap, the taps in
row-major (ky, kx) order, and the mask (N, Ho, Wo, K*K) (channels first
under NCHW): detectron2's channel order too. The kernel is torch's
(Cout, Cin, K, K). Every tensor stays on the device it is given; the base
grid is made there.

The sampling is JAX's, not detectron2's: a point counts only where
-1 < y < H and -1 < x < W, and is then clipped to [0, H-1] x [0, W-1]
before the bilinear step, so a point in (-1, 0) takes row 0 at full weight
(detectron2's kernel fades it toward zero). The clip is
`minimum(maximum(y, 0), H - 1)` with tensor bounds, whose gradient at a tie
is 0.5 as `jnp.clip`'s is (`torch.clamp` passes 1): at init the offsets
are zero and every tap samples on an integer, so the border taps' offset
gradient sits on that tie. The backward is autograd through these ops, as
JAX differentiates its XLA form. The four corners are gathered as rows of
Cin values from the flattened map and combined by one batched product
with their weights (the bilinear weight, the inside test and the mask
folded in). Where a gradient is taken the sampling is checkpointed: the
backward recomputes the gathers from the map and the sample points instead
of keeping the four gathered corners, so a call keeps the columns,
(N, Ho*Wo, K*K*Cin) in float32, and its inputs (a res4 block of R-101 at
batch 8 and an 800x1344 pad: 0.3 GB kept instead of 1.6 GB).
"""

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _clip(v: torch.Tensor, hi: int) -> torch.Tensor:
    """`jnp.clip(v, 0, hi)` with its gradient: 0.5 where v sits on a bound."""
    lo_t = torch.zeros((), dtype=v.dtype, device=v.device)
    hi_t = torch.full((), float(hi), dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(v, lo_t), hi_t)


def _bilinear_sample(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """img (N, H, W, C); y, x (N, P) sample points -> (N, P, C): each point
    bilinear between its four clipped neighbours, zero unless
    -1 < y < H and -1 < x < W, times `scale` (N, P) where given."""
    n, h, w, c = img.shape
    ok = ((y > -1.0) & (y < h) & (x > -1.0) & (x < w)).to(img.dtype)
    if scale is not None:
        ok = ok * scale
    y, x = _clip(y, h - 1), _clip(x, w - 1)
    y0, x0 = torch.floor(y).long(), torch.floor(x).long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    ly, lx = y - y0.to(y.dtype), x - x0.to(x.dtype)
    hy, hx = 1 - ly, 1 - lx
    weights = torch.stack((hy * hx, hy * lx, ly * hx, ly * lx), dim=-1) * ok[..., None]  # (N, P, 4)
    base = (torch.arange(n, device=img.device) * (h * w))[:, None, None]
    rows = torch.stack((y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1), dim=-1) + base  # (N, P, 4)
    corners = img.reshape(n * h * w, c).index_select(0, rows.reshape(-1)).reshape(-1, 4, c)
    return torch.bmm(weights.reshape(-1, 1, 4), corners).reshape(n, -1, c)


def deform_conv2d(
    x: torch.Tensor,  # (N, H, W, Cin)
    offsets: torch.Tensor,  # (N, Ho, Wo, 2*K*K)
    weight: torch.Tensor,  # (Cout, Cin, K, K)
    mask: Optional[torch.Tensor] = None,  # (N, Ho, Wo, K*K) for v2
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
    layout: str = "NHWC",
) -> torch.Tensor:
    """-> (N, Ho, Wo, Cout) (NCHW under `layout="NCHW"`), in the dtype of
    `x`, which the offsets, mask and kernel are cast to."""
    if layout not in ("NHWC", "NCHW"):
        raise ValueError(f"deform_conv2d layout {layout!r}: NHWC or NCHW")
    if layout == "NCHW":
        x, offsets = x.permute(0, 2, 3, 1), offsets.permute(0, 2, 3, 1)
        mask = None if mask is None else mask.permute(0, 2, 3, 1)
    n, h, w, cin = x.shape
    cout, k = weight.shape[0], weight.shape[-1]
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    if tuple(offsets.shape) != (n, ho, wo, 2 * k * k):
        raise ValueError(f"offsets {tuple(offsets.shape)}: want {(n, ho, wo, 2 * k * k)}")
    if mask is not None and tuple(mask.shape) != (n, ho, wo, k * k):
        raise ValueError(f"mask {tuple(mask.shape)}: want {(n, ho, wo, k * k)}")

    # base sampling grid: output position * stride - padding + tap * dilation
    dev, dt = x.device, x.dtype
    oy = torch.arange(ho, device=dev, dtype=dt) * stride - padding
    ox = torch.arange(wo, device=dev, dtype=dt) * stride - padding
    taps = torch.arange(k, device=dev, dtype=dt) * dilation
    base_y = (oy[:, None, None, None] + taps[None, None, :, None]).expand(ho, wo, k, k).reshape(ho, wo, k * k)
    base_x = (ox[None, :, None, None] + taps[None, None, None, :]).expand(ho, wo, k, k).reshape(ho, wo, k * k)
    off = offsets.to(dt).reshape(n, ho, wo, k * k, 2)
    sample_y = (base_y + off[..., 0]).reshape(n, -1)
    sample_x = (base_x + off[..., 1]).reshape(n, -1)
    scale = None if mask is None else mask.to(dt).reshape(n, -1)
    args = (x, sample_y, sample_x, scale)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in args):
        cols = checkpoint(_bilinear_sample, *args, use_reentrant=False)
    else:
        cols = _bilinear_sample(*args)
    cols = cols.reshape(n, ho * wo, k * k * cin)
    wmat = weight.to(dt).permute(2, 3, 1, 0).reshape(k * k * cin, cout)  # HWIO rows: tap-major, then Cin
    out = torch.matmul(cols, wmat).reshape(n, ho, wo, cout)
    return out.permute(0, 3, 1, 2) if layout == "NCHW" else out


def modulated_deform_conv2d(x, offsets, mask, weight, **kw):
    """DCN v2: `deform_conv2d` with `mask` (the caller applies the sigmoid,
    as detectron2's ModulatedDeformConv callers do)."""
    return deform_conv2d(x, offsets, weight, mask=mask, **kw)
