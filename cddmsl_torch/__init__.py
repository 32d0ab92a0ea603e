"""PyTorch/CUDA port of cddmsl_tpu's inference path, CDDMSL training step
and train-and-evaluate loops (`python -m cddmsl_torch.train_net`), and of
RegionCLIP's pretraining and language tools (`pretrain_net`,
`extract_concept_features`, `extract_region_features`), for an NVIDIA H100.

The JAX package `cddmsl_tpu` stays the reference; this package imports
nothing of it. Module paths mirror the JAX package's. Entry points run on
CUDA unless the caller passes device="cpu"; on the card, RoIAlign (forward
and backward) and NMS are the hand-written kernels under csrc/.
"""

from .config import ModelConfig, SolverConfig, flagship_config, flagship_solver_config
from .device import resolve_device
