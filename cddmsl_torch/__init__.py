"""PyTorch/CUDA port of cddmsl_tpu's inference path for an NVIDIA H100.

The JAX package `cddmsl_tpu` stays the reference; this package imports
nothing of it. Module paths mirror the JAX package's. Entry points run on
CUDA unless the caller passes device="cpu"; on the card, RoIAlign and NMS
are the hand-written kernels under csrc/.
"""

from .config import ModelConfig, flagship_config
from .device import resolve_device
