"""The RPN-only detectors (counterpart of cddmsl_tpu/models/
extra_meta_archs.py `ProposalNetwork`, `FPNProposalNetwork` and
`_proposals_as_detections`): the backbone and the RPN, trained on the RPN's
losses; their proposals are the detections, of class 0, scored by the
sigmoid of their objectness, in the resized frame (JAX's ProposalNetworks
do not rescale them).

`ProposalNetwork` is built from RESNETS.DEPTH and the pixel statistics
alone: the detectron2 ResNet to res4 and an RPN of the module's defaults
(stride 16, anchors 32..512, the pre- and post-NMS top-k 12000/6000 and
2000/1000), whatever MODEL.RPN says, as JAX's is. `FPNProposalNetwork` runs
the FPN RPN over p2..p6 with the configuration's anchor sizes and top-k."""

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from .backbone.resnet import FPN, D2ResNet
from .fast_rcnn import DetectionResult
from .fpn_rcnn import FPN_STRIDES
from .rcnn import DetBatch, normalize
from .rpn import RPN, FPNRPN, Proposals
from .sampling import Draw


def proposals_as_detections(proposals: Proposals) -> DetectionResult:
    """Proposals -> class-0 detections in objectness order, scored
    sigmoid(logit), 0 where not valid."""
    return DetectionResult(
        boxes=proposals.boxes,
        scores=torch.sigmoid(proposals.scores) * proposals.valid,
        classes=torch.zeros(proposals.scores.shape, dtype=torch.int32, device=proposals.scores.device),
        valid=proposals.valid,
    )


class _RPNOnly(nn.Module):
    use_text_emb = False  # no classifier: nothing for the optimizer to freeze there

    def _levels(self, images: torch.Tensor):
        raise NotImplementedError

    def losses(self, batch: DetBatch, draw: Draw) -> Dict[str, torch.Tensor]:
        """{"loss_rpn_cls", "loss_rpn_loc"}; draw sites "rpn_pos", "rpn_neg"
        (JAX hands this arch's key to the RPN whole)."""
        return self.proposal_generator(self._levels(batch.image), batch.image_sizes, training=True,
                                       gt_boxes=batch.gt_boxes, gt_valid=batch.gt_valid, draw=draw)[1]

    def cddmsl_losses(self, batch: DetBatch, draw: Draw, caption_on: bool = False, kd_regularization: bool = True,
                      enable_caption: bool = True) -> Dict[str, torch.Tensor]:
        return self.losses(batch, draw)

    @torch.no_grad()
    def inference(self, batch: DetBatch, do_postprocess: bool = True) -> DetectionResult:
        """The test proposals as detections; `do_postprocess` changes
        nothing (JAX's module has no postprocess)."""
        return proposals_as_detections(self.proposal_generator(self._levels(batch.image), batch.image_sizes)[0])


class ProposalNetwork(_RPNOnly):
    def __init__(self, depth: int = 50, pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
                 pixel_std: Sequence[float] = (1.0, 1.0, 1.0), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pixel_mean, self.pixel_std = tuple(pixel_mean), tuple(pixel_std)
        self.backbone = D2ResNet(depth, res5=False)
        self.proposal_generator = RPN(in_channels=1024, stride=16)

    def _levels(self, images: torch.Tensor) -> torch.Tensor:
        x = normalize(images, self.pixel_mean, self.pixel_std, self.dtype, unit_range=False)
        return self.backbone(x)["res4"]


class FPNProposalNetwork(_RPNOnly):
    def __init__(self, depth: int = 50, fpn_out_channels: int = 256,
                 anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
                 pre_nms_topk: Tuple[int, int] = (2000, 1000), post_nms_topk: Tuple[int, int] = (1000, 2000),
                 pixel_mean: Sequence[float] = (103.53, 116.28, 123.675), pixel_std: Sequence[float] = (1.0, 1.0, 1.0),
                 backbone_width: int = 64, res2_out_channels: int = 256, dtype: torch.dtype = torch.float32):
        """`backbone_width` is TPU.BACKBONE_WIDTH where set (the bottleneck
        width; res2's output stays `res2_out_channels`)."""
        super().__init__()
        self.dtype = dtype
        self.pixel_mean, self.pixel_std = tuple(pixel_mean), tuple(pixel_std)
        self.backbone = FPN(D2ResNet(depth, width_per_group=backbone_width, res2_out_channels=res2_out_channels),
                            fpn_out_channels)
        self.proposal_generator = FPNRPN(
            fpn_out_channels, strides=FPN_STRIDES, anchor_sizes=tuple(anchor_sizes),
            pre_nms_topk_train=pre_nms_topk[0], pre_nms_topk_test=pre_nms_topk[1],
            post_nms_topk_train=post_nms_topk[0], post_nms_topk_test=post_nms_topk[1],
        )

    def _levels(self, images: torch.Tensor):
        feats = self.backbone(normalize(images, self.pixel_mean, self.pixel_std, self.dtype, unit_range=False))
        return [feats[f"p{i}"] for i in range(2, 7)]
