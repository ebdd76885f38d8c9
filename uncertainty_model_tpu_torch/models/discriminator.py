"""Randomly-connected discriminator (the port of the JAX package's
``models/discriminator.py``; reference model/discriminator.py).

Four encoder stages eat a stereo image pyramid: stage i > 0 takes the
previous stage's output concatenated with pyramid level i.  A fifth stage
is the final conv, then a linear head and a sigmoid.  ``features()`` gives
the four stage maps, which the perceptual loss compares.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .encoder import resolve_encoder_graphs
from .layers import EncoderStage, init_parameters, sigmoid


class RandomDiscriminator(nn.Module):
    """Built from a config's ``discriminator`` section: ``layers`` (the
    four stages' dicts), ``final_conv``, ``linear_in_features`` and the
    graphs' ``load_graph``/``nodes``/``seed`` (stages count from 1, as the
    encoder's: the flagship's are ``graphs/nodes_5_seed_42/stage_{1..5}``).
    Its ``state_dict`` keys are the reference's (``layers.{i}``, ``conv``,
    ``linear``).

    ``dtype``: the modules' compute type, flax's semantics (``None``: f32).
    With ``torch.bfloat16`` the pyramid is cast to bf16, the head is flax's
    ``nn.Dense(dtype=bf16)`` (the product rounded to bf16, then the bias
    added in bf16) and the sigmoid rounds three times, as
    ``jax.nn.sigmoid``; the parameters stay f32."""

    def __init__(self, layers: Sequence[dict], final_conv: dict,
                 linear_in_features: int, load_graph: Optional[str] = None,
                 nodes: int = 5, seed: int = 42,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.graphs = resolve_encoder_graphs(
            len(layers) + 1, load_graph=load_graph, nodes=nodes, seed=seed)

        def stage(graph, cfg):
            return EncoderStage(graph, cfg["in_channels"], cfg["out_channels"],
                                cfg["kernel_size"], heads=cfg.get("heads", 8),
                                dtype=dtype)

        self.layers = nn.ModuleList(
            stage(g, cfg) for g, cfg in zip(self.graphs, layers))
        self.conv = stage(self.graphs[len(layers)], final_conv)
        self.linear = nn.Linear(linear_in_features, 1)

    @classmethod
    def from_config(cls, layers: Sequence[dict], final_conv: dict,
                    linear_in_features: int, load_graph: Optional[str] = None,
                    nodes: int = 5, seed: int = 42,
                    dtype: Optional[torch.dtype] = None, *, init_seed: int = 0,
                    device=None) -> "RandomDiscriminator":
        """Build from a config's ``discriminator`` section (its ``seed`` is
        the graphs'), initialise from ``init_seed`` on the CPU (the JAX
        package's initialisers, as ``RandomlyConnectedModel.from_config``)
        and move to ``device`` (CUDA unless asked otherwise) in
        channels-last memory."""
        disc = cls(layers, final_conv, linear_in_features, load_graph, nodes,
                   seed, dtype)
        init_parameters(disc, torch.Generator().manual_seed(init_seed))
        return disc.to(resolve_device(device),
                       memory_format=torch.channels_last)

    def features(self, pyramid: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The four stage maps (NCHW) of an NHWC pyramid, finest first."""
        feats, out = [], None
        for i, (level, stage) in enumerate(zip(pyramid, self.layers)):
            x = level.permute(0, 3, 1, 2)
            if self.dtype is not None:
                x = x.to(self.dtype)
            out = stage(x if i == 0 else torch.cat([out, x], dim=1))
            feats.append(out)
        return feats

    def forward(self, pyramid: Sequence[torch.Tensor]) -> torch.Tensor:
        """(B, 1) probabilities that each pyramid is real.  The head
        flattens in NCHW order, the reference's (the JAX package flattens
        NHWC and permutes its kernel's rows to match)."""
        out = self.conv(self.features(pyramid)[-1])
        out = out.reshape(out.shape[0], -1)
        if self.dtype is None:
            return sigmoid(self.linear(out))
        dt = self.dtype
        logits = (F.linear(out.to(dt), self.linear.weight.to(dt))
                  + self.linear.bias.to(dt))
        return sigmoid(logits)
