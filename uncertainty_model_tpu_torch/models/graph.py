"""Randomly-connected graph core (the port's own copy of the JAX package's
``models/graph.py``; reference model/graph.py:11-54).

An undirected Watts-Strogatz graph becomes the DAG an encoder stage runs:
node ``i`` takes its inputs from its neighbours with a smaller index; it is
an *input* node when its index is below all neighbours and an *output* node
when above all of them.  The topology is resolved on the host when a model
is built.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional, Sequence

# relative ``load_graph`` paths (as in configs/*.yml) resolve against the
# working directory first, then against the repository root
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Node(NamedTuple):
    id: int
    node_type: str  # 'input' | 'intermediate' | 'output'
    inputs: tuple[int, ...]


class GraphSpec(NamedTuple):
    nodes: tuple[Node, ...]
    in_nodes: tuple[int, ...]
    out_nodes: tuple[int, ...]


def graph_spec_from_adjacency(adjacency: Sequence[Sequence[int]]) -> GraphSpec:
    """Build a :class:`GraphSpec` from ordered per-node neighbour lists.

    Neighbour ORDER is semantic: a multi-input node pairs its k-th
    lower-index neighbour with its k-th ``mean_weight`` gate (reference
    model/graph.py:36 keeps networkx's insertion order, e.g. node 3 of the
    reference's stage graphs takes the inputs ``[2, 1, 0]``).  Sorting
    would re-pair gates with inputs.
    """
    nodes, ins, outs = [], [], []
    for i, nbrs in enumerate(adjacency):
        nbrs = list(nbrs)
        node_type = "intermediate"
        if i < min(nbrs):
            ins.append(i)
            node_type = "input"
        elif i > max(nbrs):
            outs.append(i)
            node_type = "output"
        nodes.append(Node(i, node_type, tuple(n for n in nbrs if n < i)))
    return GraphSpec(tuple(nodes), tuple(ins), tuple(outs))


def graph_spec_from_edges(num_nodes: int,
                          edges: Sequence[tuple[int, int]]) -> GraphSpec:
    """From an undirected edge list, with networkx's insertion-order
    adjacency (edge (u, v) appends v to u's list and u to v's)."""
    adjacency: list[list[int]] = [[] for _ in range(num_nodes)]
    for u, v in edges:
        if v not in adjacency[u]:
            adjacency[u].append(v)
        if u not in adjacency[v]:
            adjacency[v].append(u)
    return graph_spec_from_adjacency(adjacency)


def load_graph_spec(path: str) -> GraphSpec:
    """Load a graph saved as JSON (``adjacency`` lists or an edge list)."""
    with open(path) as f:
        data = json.load(f)
    if "adjacency" in data:
        return graph_spec_from_adjacency(data["adjacency"])
    return graph_spec_from_edges(data["num_nodes"],
                                 [tuple(e) for e in data["edges"]])


def resolve_stage_graph(stage: int, nodes: int = 5, p: float = 0.75,
                        k: int = 4, seed: Optional[int] = None,
                        load_graph: Optional[str] = None) -> GraphSpec:
    """The graph of one encoder stage (stages count from 1).  ``load_graph``
    is a directory of ``stage_{i}.json`` files; without it the graph is
    built with networkx from ``seed = stage * seed`` (reference
    model/layers/encoder.py:237-254)."""
    if load_graph is not None:
        directory = load_graph
        if not os.path.isabs(directory) and not os.path.isdir(directory):
            directory = os.path.join(_REPO_ROOT, directory)
        path = os.path.join(directory, f"stage_{stage}.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no stage_{stage} graph under {load_graph}")
        return load_graph_spec(path)

    import networkx as nx

    g = nx.connected_watts_strogatz_graph(
        nodes, k, p, seed=(stage * seed) if seed is not None else None)
    return graph_spec_from_adjacency(
        [list(g.neighbors(i)) for i in range(g.number_of_nodes())])
