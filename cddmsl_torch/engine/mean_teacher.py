"""The mean-teacher (Adaptive-Teacher) trainer, SEMISUPNET.Trainer =
"ateacher" (counterpart of cddmsl_tpu/engine/mean_teacher.py: `grad_reverse`,
`FCDiscriminator`, `MTState`, `_bce_with_logits` and `MeanTeacherTrainer`).

A step, at iteration `it` with burn-up B = SEMISUPNET.BURN_UP_STEP:
- the supervised losses of the student on the strong labeled view, times
  SUP_LOSS_WEIGHT;
- past burn-up (it > B): the EMA teacher detects on the weak unlabeled view
  (boxes in the padded frame); its first TPU.MAX_GT_BOXES detections scored
  above BBOX_THRESHOLD are the ground truth of the strong unlabeled view,
  whose `loss_cls` and `loss_rpn_cls` (no box regression) count times
  UNSUP_LOSS_WEIGHT as `loss_cls_pseudo` and `loss_rpn_cls_pseudo`; and a
  discriminator on the res4 maps of both strong views, through a gradient
  reversal, gives `loss_D` = DIS_LOSS_WEIGHT * (bce(source, 0) +
  bce(target, 1)). Before, the three are zeros;
- one backward: the student gets the losses' gradient with the
  discriminator's reversed, the discriminator its own; the student's
  optimizer and the discriminator's (SGD with momentum, no decay, no clip,
  the same LR schedule at its own count) step;
- the teacher: at it == B a copy of the student; past B, every
  TEACHER_UPDATE_ITER iterations, rate * teacher + (1 - rate) * student over
  every tensor of its state (all float32: frozen ones and FrozenBN
  statistics too), rate = EMA_KEEP_RATE and 1 - rate both in float32 as JAX
  rounds them; otherwise unchanged.

Two differences from the JAX step, neither of which changes a result: the
teacher detects only past burn-up (JAX runs it every step and drops the
result before), and the discriminator reads the res4 maps of the two
supervised passes where JAX runs the backbone on both views again (the same
values on the same parameters; the gradient is the same sum in another
order).

The draws: the supervised branch and the pseudo-labeled branch ask for the
same sites, so each has its own `Draw`; the trainer seeds two generators by
(SEED + 999, iteration, 0) and (SEED + 999, iteration, 1). A save holds the
student, its optimizer, the iteration, the teacher, the discriminator and
its optimizer; it restores only into this trainer, and a plain save only
into `DefaultTrainer`, as orbax refuses the other tree in JAX.

Under a process group each rank takes its rows of the four views (the
loader splits them alike), labels its own weak unlabeled rows with its
teacher, and draws its rows of both draws; the student's and the
discriminator's gradients are averaged over the ranks in their optimizers'
`step`, so the students stay identical, and so do the teachers, which the
EMA updates from them on every rank (JAX: one program over the mesh).
"""

import copy
import dataclasses
import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import model_config_from_cfg, solver_config_from_cfg
from ..data import to_device
from ..data.build import build_semisup_train_loader_two_crops
from ..models.rcnn import DetBatch, GeneralizedRCNN
from ..models.sampling import Draw, generator_draw, rank_draw
from ..parallel import comm
from ..solver.build import Optimizer
from .defaults import DefaultTrainer, _global_means, _iteration_seed
from .train_loop import Trainer, check_state_keys

logger = logging.getLogger(__name__)


class GradReverse(torch.autograd.Function):
    """Identity forward, negated gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def grad_reverse(x: torch.Tensor) -> torch.Tensor:
    return GradReverse.apply(x)


class FCDiscriminator(nn.Module):
    """Per-location domain classifier on res4 (DIS_TYPE "res4"): 3x3 convs
    of ndf and ndf / 2 channels with leaky ReLU (0.2), then a 3x3 conv to one
    logit, padding 1, in float32. NHWC in, (B, H, W, 1) logits out."""

    def __init__(self, in_channels: int, ndf: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, ndf, 3, padding=1)
        self.conv2 = nn.Conv2d(ndf, ndf // 2, 3, padding=1)
        self.classifier = nn.Conv2d(ndf // 2, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        x = F.leaky_relu(self.conv1(x), 0.2)
        x = F.leaky_relu(self.conv2(x), 0.2)
        return self.classifier(x).permute(0, 2, 3, 1)


@torch.no_grad()
def init_discriminator_(disc: FCDiscriminator, generator: torch.Generator) -> FCDiscriminator:
    """flax's Conv defaults: LeCun-normal kernels (a normal truncated at
    two standard deviations, rescaled to variance 1 / fan_in), zero biases."""
    for conv in (disc.conv1, disc.conv2, disc.classifier):
        std = conv.weight[0].numel() ** -0.5 / 0.87962566103423978
        w = torch.empty(conv.weight.shape)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        conv.weight.copy_(w)
        conv.bias.zero_()
    return disc


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits, the mean over every position, written
    as JAX writes it."""
    return torch.mean(torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits))))


class MTState:
    """The mean-teacher training state: the student with its optimizer, the
    teacher, the discriminator with its optimizer, and the iteration."""

    def __init__(self, model: GeneralizedRCNN, teacher: GeneralizedRCNN, discriminator: FCDiscriminator,
                 optimizer: Optimizer, dis_optimizer: Optimizer, iteration: int = 0):
        self.model = model
        self.teacher = teacher
        self.discriminator = discriminator
        self.optimizer = optimizer
        self.dis_optimizer = dis_optimizer
        self.iteration = iteration

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "iteration": self.iteration, "teacher": self.teacher.state_dict(),
                "discriminator": self.discriminator.state_dict(), "dis_optimizer": self.dis_optimizer.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        """Restores a mean-teacher save; any other save raises."""
        check_state_keys(state, self.state_dict().keys())
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.teacher.load_state_dict(state["teacher"], strict=True)
        self.discriminator.load_state_dict(state["discriminator"], strict=True)
        self.dis_optimizer.load_state_dict(state["dis_optimizer"])
        self.iteration = int(state["iteration"])


class MeanTeacherTrainer(DefaultTrainer):
    """`DefaultTrainer` with the mean-teacher state and step, the two-crop
    loader, student and teacher evaluation at TEST.EVAL_PERIOD, and the
    teacher's final test."""

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device=device)
        teacher = copy.deepcopy(self.model).requires_grad_(False)
        width = model_config_from_cfg(cfg).backbone_width * 16
        disc = init_discriminator_(FCDiscriminator(width), torch.Generator().manual_seed(1)).to(self.device)
        # optax.sgd(schedule, momentum): no weight decay, no clipping
        dis_solver = dataclasses.replace(solver_config_from_cfg(cfg), weight_decay=0.0, clip_enabled=False)
        dis_optimizer = Optimizer(list(disc.parameters()), dis_solver)
        self.state = MTState(self.model, teacher, disc, self.optimizer, dis_optimizer)
        self.teacher, self.discriminator, self.dis_optimizer = teacher, disc, dis_optimizer
        self.bbox_threshold = cfg.SEMISUPNET.BBOX_THRESHOLD
        self._draw_seed = max(cfg.SEED, 0) + 999
        self.generator_pseudo = torch.Generator(device=self.device)
        self._ema_pairs = None

    # ---- weights ----
    def resume_or_load(self, resume: bool = True) -> None:
        """With `resume` and a checkpoint, the newest mean-teacher save.
        Otherwise `DefaultTrainer.load_weights` into the student: a port
        save gives it its weights and iteration, while its optimizer and the
        discriminator's stay at their start, as JAX's MTState keeps them;
        then the teacher becomes a copy of the student."""
        if resume and self.checkpointer.has_checkpoint():
            self.checkpointer.load(self.checkpointer.get_checkpoint_file(), self.state)
        else:
            student = Trainer(self.model, Optimizer(self.optimizer.params, self.optimizer.cfg))
            self.load_weights(student)
            self.teacher.load_state_dict(self.model.state_dict())
            self.state.iteration = student.iteration
        self.start_iter = self.state.iteration

    # ---- the step ----
    @torch.no_grad()
    def _pseudo_label(self, teacher: GeneralizedRCNN, weak_batch: DetBatch):
        """The teacher's detections on the weak view, in its padded frame:
        the first TPU.MAX_GT_BOXES boxes and classes, valid where detected
        with a score above `bbox_threshold` (SEMISUPNET.BBOX_THRESHOLD)."""
        det = teacher.inference(weak_batch, do_postprocess=False)
        keep = det.valid & (det.scores > self.bbox_threshold)
        g = self.cfg.TPU.MAX_GT_BOXES
        return det.boxes[:, :g], det.classes[:, :g].to(torch.int32), keep[:, :g]

    def mt_step(self, label_s: DetBatch, label_w: DetBatch, unlabel_s: DetBatch, unlabel_w: DetBatch,
                draw_sup: Draw, draw_pseudo: Draw) -> Dict[str, torch.Tensor]:
        """One mean-teacher step on `self.state` (the module docstring);
        returns the losses and `total_loss`, on the device. `label_w` is
        read by no loss, as in JAX."""
        st, sc = self.state, self.cfg.SEMISUPNET
        it = st.iteration
        past_burnup = it > sc.BURN_UP_STEP
        st.optimizer.zero_grad()
        st.dis_optimizer.zero_grad()
        with torch.enable_grad():
            sup, f_src, _ = st.model.supervised(label_s, draw_sup)
            losses = {k: v * sc.SUP_LOSS_WEIGHT for k, v in sup.items()}
            if past_burnup:
                boxes, classes, valid = self._pseudo_label(st.teacher, unlabel_w)
                pseudo = unlabel_s._replace(gt_boxes=boxes, gt_classes=classes, gt_valid=valid)
                unsup, f_tgt, _ = st.model.supervised(pseudo, draw_pseudo)
                losses["loss_cls_pseudo"] = unsup["loss_cls"] * sc.UNSUP_LOSS_WEIGHT
                losses["loss_rpn_cls_pseudo"] = unsup["loss_rpn_cls"] * sc.UNSUP_LOSS_WEIGHT
                d_src = st.discriminator(grad_reverse(f_src))
                d_tgt = st.discriminator(grad_reverse(f_tgt))
                loss_d = bce_with_logits(d_src, torch.zeros_like(d_src))
                losses["loss_D"] = (loss_d + bce_with_logits(d_tgt, torch.ones_like(d_tgt))) * sc.DIS_LOSS_WEIGHT
            else:
                zero = torch.zeros((), dtype=torch.float32, device=f_src.device)
                losses.update(loss_cls_pseudo=zero, loss_rpn_cls_pseudo=zero, loss_D=zero)
            total = torch.stack(list(losses.values())).sum()
            total.backward()
        st.optimizer.step()
        st.dis_optimizer.step()
        self._update_teacher(it)
        st.iteration += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    @torch.no_grad()
    def _update_teacher(self, it: int) -> None:
        sc = self.cfg.SEMISUPNET
        if it == sc.BURN_UP_STEP:
            self.teacher.load_state_dict(self.model.state_dict())
        elif it > sc.BURN_UP_STEP and it % sc.TEACHER_UPDATE_ITER == 0:
            if self._ema_pairs is None:
                t, s = self.teacher.state_dict(), self.model.state_dict()
                self._ema_pairs = [t[k] for k in t], [s[k] for k in t]
            teacher, student = self._ema_pairs
            rate = np.float32(sc.EMA_KEEP_RATE)
            torch._foreach_mul_(teacher, float(rate))
            torch._foreach_add_(teacher, torch._foreach_mul(student, float(np.float32(1.0) - rate)))

    def run_step(self, batch) -> Dict[str, torch.Tensor]:
        """One mean-teacher step on ((label_s, label_w), (unlabel_s,
        unlabel_w)) on the device, with this iteration's two draws."""
        (ls, lw), (us, uw) = batch
        it = self.state.iteration
        self.generator.manual_seed(_iteration_seed(self._draw_seed, it, 0))
        self.generator_pseudo.manual_seed(_iteration_seed(self._draw_seed, it, 1))
        draw_sup = rank_draw(generator_draw(self.generator), ls.image.shape[0])
        return self.mt_step(ls, lw, us, uw, draw_sup,
                            rank_draw(generator_draw(self.generator_pseudo), us.image.shape[0]))

    @torch.no_grad()
    def compute_val_loss(self, batch: DetBatch, draw: Optional[Draw] = None) -> Dict[str, float]:
        """The student's supervised losses on a labeled batch, with no step
        (the samplers draw from a generator seeded 0 unless `draw` is given).
        Under a process group a collective: every rank passes its rows of
        the global batch and gets the global batch's losses."""
        if draw is None:
            draw = rank_draw(generator_draw(torch.Generator(device=self.device).manual_seed(0)), batch.image.shape[0])
        return _global_means(self.model.supervised_losses(batch, draw))

    # ---- the loop ----
    def build_train_loader(self):
        return build_semisup_train_loader_two_crops(self.cfg, seed=max(self.cfg.SEED, 0),
                                                    pin_memory=self.device.type == "cuda")

    def batch_to_device(self, batch):
        return tuple(tuple(to_device(b, self.device) for b in pair) for pair in batch)

    def _eval_into_storage(self, model=None, prefix: str = "") -> None:
        logger.info("=== student eval ===")
        super()._eval_into_storage()
        logger.info("=== teacher eval ===")
        super()._eval_into_storage(self.teacher, "teacher/")

    def final_test(self) -> Dict[str, dict]:
        """The teacher's test, checked against TEST.EXPECTED_RESULTS, then
        its pseudo-labels against SEMISUPNET.EXPECTED_PSEUDO."""
        results = self.test(model=self.teacher)
        self._verify_final(results)
        self._verify_pseudo_labels()
        return results

    def pseudo_label_stats(self) -> Tuple[int, float]:
        """(count, precision) of the teacher's pseudo-labels on the first
        weak unlabeled batch, scored against that batch's ground truth (IoU
        above 0.5 and the same class); under a process group over every
        rank's rows."""
        with self.build_train_loader() as loader:
            (_, _), (_, unlabel_w) = next(loader)
        boxes, classes, valid = (t.cpu().numpy() for t in self._pseudo_label(
            self.teacher, to_device(unlabel_w, self.device)))
        gtb, gtc, gtv = (t.numpy() for t in (unlabel_w.gt_boxes, unlabel_w.gt_classes, unlabel_w.gt_valid))
        n_pseudo = n_correct = 0
        for b in range(len(boxes)):
            pb, pc = boxes[b][valid[b]], classes[b][valid[b]]
            gb, gc = gtb[b][gtv[b]], gtc[b][gtv[b]]
            n_pseudo += len(pb)
            if not len(gb):
                continue
            for box, cls in zip(pb, pc):
                lt = np.maximum(box[:2], gb[:, :2])
                rb = np.minimum(box[2:], gb[:, 2:])
                wh = np.clip(rb - lt, 0, None)
                inter = wh[:, 0] * wh[:, 1]
                area = (box[2] - box[0]) * (box[3] - box[1]) + (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1]) - inter
                iou = inter / np.maximum(area, 1e-9)
                if np.any((iou > 0.5) & (gc == cls)):
                    n_correct += 1
        n_pseudo, n_correct = np.sum(comm.all_gather_objects((n_pseudo, n_correct)), axis=0).tolist()
        return n_pseudo, n_correct / max(n_pseudo, 1)

    def _verify_pseudo_labels(self) -> None:
        """SEMISUPNET.EXPECTED_PSEUDO = [count, precision, tolerance]: the
        count exactly, the precision within the tolerance."""
        expected = list(self.cfg.SEMISUPNET.EXPECTED_PSEUDO)
        if not expected:
            return
        want_count, want_prec, tol = expected
        count, prec = self.pseudo_label_stats()
        logger.info("Pseudo-label golden: count=%d (want %d), precision=%.4f (want %.4f+-%.2f)",
                    count, int(want_count), prec, want_prec, tol)
        if not (count == int(want_count) and abs(prec - want_prec) <= tol):
            raise RuntimeError(f"Pseudo-label verification failed: count={count} (want {int(want_count)}), "
                               f"precision={prec:.4f} (want {want_prec}+-{tol})")
