"""Randomly-connected encoder (reference model/encoder.py): five
EncoderStages, each halving H and W; returns all five feature maps."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .graph import resolve_stage_graph
from .layers import EncoderStage


class RandomEncoder(nn.Module):
    """Built from the config's ``encoder`` section (``layers`` per-stage
    dicts plus ``load_graph``/``nodes``/``seed``; stage graphs count from
    1, reference model/encoder.py:33-36).  ``dtype``: the stages' compute
    type, to which the input is cast (JAX encoder.py:77-78)."""

    def __init__(self, layers: Sequence[dict], load_graph: Optional[str] = None,
                 nodes: int = 5, seed: int = 42,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.graphs = tuple(
            resolve_stage_graph(i + 1, nodes=nodes, seed=seed,
                                load_graph=load_graph)
            for i in range(len(layers)))
        self.layers = nn.ModuleList(
            EncoderStage(graph, cfg["in_channels"], cfg["out_channels"],
                         cfg["kernel_size"], heads=cfg.get("heads", 8),
                         dtype=dtype)
            for graph, cfg in zip(self.graphs, layers))

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        encodings = []
        for stage in self.layers:
            x = stage(x)
            encodings.append(x)
        return tuple(encodings)
