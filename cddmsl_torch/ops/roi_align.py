"""RoIAlign: the plain PyTorch versions and the wrapper of kernel K1.

Counterpart of cddmsl_tpu/ops/roi_align.py (`_interp_matrix`, `roi_align`,
`roi_align_gather`) and of the Pallas kernels in
cddmsl_tpu/ops/pallas/roi_align_pallas.py. Bilinear sampling is separable:

    out[r, p, q, c] = sum_h sum_w Wy[r, p, h] * Wx[r, q, w] * F[h, w, c]

where Wy/Wx fold the average over the S x S sample points of each bin.
`sampling_ratio=0` means S=2, never the adaptive count.

`roi_align_batched` is what the model calls. For a CUDA tensor it launches
the hand-written kernel (csrc/roi_align.cu); for a CPU tensor it runs the
plain version `roi_align_batched_plain`.
"""

import ctypes
from typing import Tuple

import torch

from ._build import CudaKernel

KERNEL = CudaKernel(
    "roi_align.cu",
    {
        "cddmsl_roi_align_fwd": (
            ctypes.c_void_p,  # features (B, H, W, C)
            ctypes.c_int,  # 0 = float32, 1 = bfloat16
            ctypes.c_void_p,  # batch index (R,) int32
            ctypes.c_void_p,  # boxes (R, 4) float32
            ctypes.c_void_p,  # out (R, PH, PW, C)
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H W C
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # R PH PW
            ctypes.c_float,  # spatial scale
            ctypes.c_int,  # samples per bin axis
            ctypes.c_int,  # aligned
            ctypes.c_void_p,  # stream
        )
    },
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _samples(sampling_ratio: int) -> int:
    return sampling_ratio if sampling_ratio > 0 else 2


def _interp_matrix(start: torch.Tensor, size: torch.Tensor, pooled: int, sampling: int, dim: int) -> torch.Tensor:
    """(R,) start, (R,) size -> (R, pooled, dim) averaged bilinear weights."""
    bin_size = size / pooled
    ph = torch.arange(pooled, dtype=start.dtype, device=start.device)
    s = (torch.arange(sampling, dtype=start.dtype, device=start.device) + 0.5) / sampling
    coords = start[:, None, None] + (ph[None, :, None] + s[None, None, :]) * bin_size[:, None, None]
    in_range = (coords > -1.0) & (coords < dim)
    cc = torch.clamp(coords, 0.0, dim - 1)
    grid = torch.arange(dim, dtype=start.dtype, device=start.device)
    w = torch.clamp(1.0 - torch.abs(cc[..., None] - grid), min=0.0)
    w = w * in_range[..., None].to(w.dtype)
    return w.mean(dim=2)


def _roi_frame(boxes: torch.Tensor, spatial_scale: float, aligned: bool):
    b = boxes.to(torch.float32) * spatial_scale - (0.5 if aligned else 0.0)
    x1, y1, x2, y2 = b.unbind(-1)
    if aligned:
        return x1, y1, x2 - x1, y2 - y1
    # legacy ROIAlign forces malformed ROIs to be 1px
    return x1, y1, torch.clamp(x2 - x1, min=1.0), torch.clamp(y2 - y1, min=1.0)


def roi_align(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: Tuple[int, int] = (14, 14),
    spatial_scale: float = 1.0 / 16,
    sampling_ratio: int = 0,
    aligned: bool = True,
    chunk_size: int = 128,
) -> torch.Tensor:
    """Plain separable-matmul RoIAlign over one map: features (H, W, C),
    boxes (R, 4) XYXY image coords -> (R, PH, PW, C) in the features' dtype."""
    H, W, C = features.shape
    PH, PW = output_size
    S = _samples(sampling_ratio)
    x1, y1, w_roi, h_roi = _roi_frame(boxes, spatial_scale, aligned)

    # contract the axis that leaves the smaller intermediate first
    x_first = H * PW < PH * W
    if x_first:
        f2d = features.permute(1, 0, 2).reshape(W, H * C)
    else:
        f2d = features.reshape(H, W * C)

    outs = []
    for lo in range(0, boxes.shape[0], chunk_size):
        sl = slice(lo, lo + chunk_size)
        r = x1[sl].shape[0]
        wy = _interp_matrix(y1[sl], h_roi[sl], PH, S, H)  # (r, PH, H)
        wx = _interp_matrix(x1[sl], w_roi[sl], PW, S, W)  # (r, PW, W)
        if x_first:
            mid = torch.matmul(wx.reshape(r * PW, W).to(features.dtype), f2d).reshape(r, PW, H, C)
            out = torch.einsum("rph,rqhc->rpqc", wy, mid.float())
        else:
            mid = torch.matmul(wy.reshape(r * PH, H).to(features.dtype), f2d).reshape(r, PH, W, C)
            out = torch.einsum("rqw,rpwc->rpqc", wx, mid.float())
        outs.append(out.to(features.dtype))
    if not outs:
        return features.new_zeros((0, PH, PW, C))
    return torch.cat(outs, dim=0)


def roi_align_gather(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: Tuple[int, int] = (14, 14),
    spatial_scale: float = 1.0 / 16,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """Gather-based oracle for `roi_align`: four bilinear taps per sample."""
    H, W, C = features.shape
    PH, PW = output_size
    S = _samples(sampling_ratio)
    x1, y1, w_roi, h_roi = _roi_frame(boxes, spatial_scale, aligned)
    dev = features.device
    sy = (torch.arange(S, device=dev, dtype=torch.float32) + 0.5) / S
    ys = y1[:, None, None] + (torch.arange(PH, device=dev)[None, :, None] + sy[None, None, :]) * (h_roi / PH)[:, None, None]
    xs = x1[:, None, None] + (torch.arange(PW, device=dev)[None, :, None] + sy[None, None, :]) * (w_roi / PW)[:, None, None]
    R = boxes.shape[0]
    yy = ys[:, :, None, :, None].expand(R, PH, PW, S, S)
    xx = xs[:, None, :, None, :].expand(R, PH, PW, S, S)
    ok = (yy > -1.0) & (yy < H) & (xx > -1.0) & (xx < W)
    y = torch.clamp(yy, 0.0, H - 1)
    x = torch.clamp(xx, 0.0, W - 1)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1i = torch.clamp(y0 + 1, max=H - 1)
    x1i = torch.clamp(x0 + 1, max=W - 1)
    ly, lx = (y - y0)[..., None], (x - x0)[..., None]
    f = features.float()
    v = (
        f[y0, x0] * (1 - ly) * (1 - lx)
        + f[y0, x1i] * (1 - ly) * lx
        + f[y1i, x0] * ly * (1 - lx)
        + f[y1i, x1i] * ly * lx
    )
    v = v * ok[..., None].to(v.dtype)  # (R, PH, PW, S, S, C)
    return v.mean(dim=(3, 4)).to(features.dtype)


def roi_align_batched_plain(
    features: torch.Tensor,
    batch_idx: torch.Tensor,
    boxes: torch.Tensor,
    output_size: Tuple[int, int] = (14, 14),
    spatial_scale: float = 1.0 / 16,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """Plain version of K1: features (B, H, W, C), batch_idx (R,), boxes
    (R, 4) -> (R, PH, PW, C); each ROI pools from the map of its image."""
    B, H, W, C = features.shape
    out = features.new_empty((boxes.shape[0],) + tuple(output_size) + (C,))
    for b in range(B):
        sel = torch.nonzero(batch_idx == b).squeeze(1)
        if sel.numel():
            out[sel] = roi_align(features[b], boxes[sel], output_size, spatial_scale, sampling_ratio, aligned)
    return out


def roi_align_batched(
    features: torch.Tensor,
    batch_idx: torch.Tensor,
    boxes: torch.Tensor,
    output_size: Tuple[int, int] = (14, 14),
    spatial_scale: float = 1.0 / 16,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> torch.Tensor:
    """RoIAlign of R boxes over a batched channels-last map.

    features (B, H, W, C) float32/bfloat16, batch_idx (R,) int32 image of
    each box, boxes (R, 4) float32 XYXY image coords -> (R, PH, PW, C) in
    the features' dtype. CUDA tensors go to kernel K1, CPU tensors to the
    plain version.
    """
    if features.device.type == "cpu":
        return roi_align_batched_plain(
            features, batch_idx, boxes, output_size, spatial_scale, sampling_ratio, aligned
        )
    if features.device.type != "cuda":
        raise ValueError(f"roi_align_batched: unsupported device {features.device}")
    B, H, W, C = features.shape
    R = boxes.shape[0]
    PH, PW = output_size
    if features.dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_align_batched: features must be float32 or bfloat16, got {features.dtype}")
    if not features.is_contiguous():
        raise ValueError("roi_align_batched: features must be a contiguous (B, H, W, C) tensor")
    if C % 2:
        raise ValueError(f"roi_align_batched: the kernel reads channel pairs; C={C} is odd")
    if boxes.dtype != torch.float32 or tuple(boxes.shape) != (R, 4) or not boxes.is_contiguous():
        raise ValueError("roi_align_batched: boxes must be a contiguous (R, 4) float32 tensor")
    if batch_idx.dtype != torch.int32 or tuple(batch_idx.shape) != (R,) or not batch_idx.is_contiguous():
        raise ValueError("roi_align_batched: batch_idx must be a contiguous (R,) int32 tensor")
    if boxes.device != features.device or batch_idx.device != features.device:
        raise ValueError("roi_align_batched: all inputs must be on the same device")
    out = torch.empty((R, PH, PW, C), dtype=features.dtype, device=features.device)
    if R == 0:
        return out
    with torch.cuda.device(features.device):
        KERNEL.launch(
            "cddmsl_roi_align_fwd",
            features.data_ptr(), _DTYPE_CODE[features.dtype], batch_idx.data_ptr(), boxes.data_ptr(),
            out.data_ptr(), B, H, W, C, R, PH, PW, float(spatial_scale), _samples(sampling_ratio),
            int(aligned), torch.cuda.current_stream(features.device).cuda_stream,
        )
    return out
