"""Full randomly-connected model (reference model/model.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from .decoder import DepthDecoder
from .encoder import RandomEncoder
from .layers import init_parameters


class RandomlyConnectedModel(nn.Module):
    """The model.  ``forward`` takes an NCHW image batch and returns the
    4-scale disparity tuple, as the reference does; its ``state_dict`` keys
    are the reference's.  ``dtype`` is the modules' compute type
    (``torch.bfloat16``: mixed precision, the disparities in bf16); the
    parameters and BatchNorm statistics are f32 whatever it is."""

    def __init__(self, encoder: dict, decoder: dict,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.encoder = RandomEncoder(**encoder, dtype=dtype)
        self.decoder = DepthDecoder(**decoder, dtype=dtype)

    @classmethod
    def from_config(cls, encoder: dict, decoder: dict,
                    dtype: Optional[torch.dtype] = None, *, seed: int = 0,
                    device=None) -> "RandomlyConnectedModel":
        """Build from a config's ``model`` section with compute type
        ``dtype`` (the JAX package's ``from_config(dtype=...)``), initialise
        from ``seed`` (on the CPU, so every device gets the same weights)
        and move to ``device`` (CUDA unless asked otherwise) in
        channels-last memory."""
        model = cls(encoder, decoder, dtype)
        init_parameters(model, torch.Generator().manual_seed(seed))
        return model.to(resolve_device(device),
                        memory_format=torch.channels_last)

    def forward(self, image, disp_scale=1.0):
        encodings = self.encoder(image)
        return self.decoder(image, *encodings, disp_scale=disp_scale)
