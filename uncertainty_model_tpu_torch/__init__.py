"""PyTorch/CUDA port of ``uncertainty_model_tpu`` for an NVIDIA H100.

The JAX package beside this one is the reference it is held against; this
package imports neither JAX nor anything of that package.  It holds the
bf16 serving forward of the 22.5M flagship model (``serving.py``) with the
fused decoder glue ``assemble_z`` as a hand-written ``sm_90a`` kernel
(``ops/decoder_fused.py``, ``csrc/assemble_z.cu``), and the f32
self-supervised training step (``train/trainer.py``, ``losses/``) with the
stereo warp ``warp_rows`` and its gradient as hand-written kernels
(``ops/warp_rows.py``, ``csrc/warp_rows.cu``).

Layout: public functions take and return NHWC tensors, as the JAX package
does; inside, tensors are logical NCHW in ``torch.channels_last`` memory, so
``x_nhwc.permute(0, 3, 1, 2)`` is a free view.
"""

from . import ops
from .config import FLAGSHIP_LOSS, FLAGSHIP_MODEL
from .device import resolve_device

__all__ = ["FLAGSHIP_LOSS", "FLAGSHIP_MODEL", "ops", "resolve_device"]
