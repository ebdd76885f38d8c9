"""Randomly-connected encoder (reference model/encoder.py): five
EncoderStages, each halving H and W; returns all five feature maps."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .graph import GraphSpec, resolve_stage_graph
from .layers import EncoderStage


def resolve_encoder_graphs(num_stages: int, load_graph: Optional[str] = None,
                           nodes: int = 5, seed: int = 42, p: float = 0.75,
                           k: int = 4, save_graph: Optional[str] = None,
                           first_stage: int = 1) -> tuple[GraphSpec, ...]:
    """The graphs of ``num_stages`` stages numbered from ``first_stage``
    (the reference numbers them from 1, model/encoder.py:33-36), by
    ``resolve_stage_graph``: fresh builds seed with ``stage * seed``."""
    return tuple(
        resolve_stage_graph(stage, nodes=nodes, p=p, k=k, seed=seed,
                            load_graph=load_graph, save_graph=save_graph)
        for stage in range(first_stage, first_stage + num_stages))


class RandomEncoder(nn.Module):
    """Built from the config's ``encoder`` section (``layers`` per-stage
    dicts plus ``load_graph``/``nodes``/``seed``/``save_graph``, resolved
    by ``resolve_encoder_graphs``; stage graphs count from 1, reference
    model/encoder.py:33-36).  ``dtype``: the stages' compute
    type, to which the input is cast (JAX encoder.py:77-78).
    ``s2d_stages``: the stages whose interiors run on the space-to-depth
    grid, where their kernel is 5 or more (JAX encoder.py:46-86)."""

    def __init__(self, layers: Sequence[dict], load_graph: Optional[str] = None,
                 nodes: int = 5, seed: int = 42,
                 save_graph: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None,
                 s2d_stages: Sequence[int] = ()):
        super().__init__()
        self.dtype = dtype
        self.graphs = resolve_encoder_graphs(
            len(layers), load_graph=load_graph, nodes=nodes, seed=seed,
            save_graph=save_graph)
        self.layers = nn.ModuleList(
            EncoderStage(graph, cfg["in_channels"], cfg["out_channels"],
                         cfg["kernel_size"], heads=cfg.get("heads", 8),
                         dtype=dtype,
                         s2d=i in s2d_stages and cfg["kernel_size"] >= 5)
            for i, (graph, cfg) in enumerate(zip(self.graphs, layers)))

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        encodings = []
        for stage in self.layers:
            x = stage(x)
            encodings.append(x)
        return tuple(encodings)
