"""Entry point: the full-width flagship detector and an example batch
(counterpart of `__graft_entry__.entry`).

    model, batch = entry()          # on the card
    detections = model.inference(batch)
"""

import numpy as np
import torch

from .checkpoint.convert_jax import init_random_
from .config import flagship_config
from .device import resolve_device
from .models.build import build_model
from .models.rcnn import DetBatch, GeneralizedRCNN


def synthetic_batch(b: int, h: int, w: int, g: int = 8, seed: int = 0, device="cuda") -> DetBatch:
    """The images of `__graft_entry__._synthetic_batch(b, h, w, g, seed)`:
    the same numpy draws in the same order, so the pixels are equal."""
    device = resolve_device(device)
    r = np.random.RandomState(seed)
    for _ in range(b):  # the ground-truth draws that precede the image
        n = r.randint(1, min(g, 4) + 1)
        r.rand(n), r.rand(n), r.rand(n), r.rand(n)
    image = (r.rand(b, h, w, 3) * 255).astype(np.float32)
    sizes = torch.tensor([[h, w]] * b, dtype=torch.int32, device=device)
    return DetBatch(image=torch.from_numpy(image).to(device), image_sizes=sizes, orig_sizes=sizes.clone())


def entry(device="cuda", seed: int = 0):
    """(model, batch): the flagship CLIP-RN50 C4 detector at full width with
    seeded random weights, and one 640x800 image."""
    device = resolve_device(device)
    model: GeneralizedRCNN = build_model(flagship_config(), device="cpu")
    init_random_(model, torch.Generator().manual_seed(seed))
    return model.to(device), synthetic_batch(1, 640, 800, device=device)
