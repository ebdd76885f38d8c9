"""Randomly-connected graph core (the port's own copy of the JAX package's
``models/graph.py``; reference model/graph.py:11-54).

An undirected Watts-Strogatz graph becomes the DAG an encoder stage runs:
node ``i`` takes its inputs from its neighbours with a smaller index; it is
an *input* node when its index is below all neighbours and an *output* node
when above all of them.  The topology is resolved on the host when a model
is built.

Graphs are read from this package's JSON files or the reference's
``.gpickle`` files, or built with networkx; networkx is imported only
where a graph is built or unpickled.
"""

from __future__ import annotations

import json
import os
import pickle
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


def _adjacency(graph) -> list[list[int]]:
    return [list(graph.neighbors(i)) for i in range(graph.number_of_nodes())]


def graph_spec_from_nx(graph) -> GraphSpec:
    """From a networkx Graph, keeping its adjacency (insertion) order
    (reference model/graph.py:11-38)."""
    return graph_spec_from_adjacency(_adjacency(graph))


def _watts_strogatz(nodes: int, k: int, p: float, seed: Optional[int]):
    import networkx as nx

    return nx.connected_watts_strogatz_graph(nodes, k, p, seed=seed)


def build_graph_spec(nodes: int, k: int, p: float,
                     seed: Optional[int] = None) -> GraphSpec:
    """A connected Watts-Strogatz graph (reference model/graph.py:41-44)."""
    return graph_spec_from_nx(_watts_strogatz(nodes, k, p, seed))


def load_graph_spec(path: str) -> GraphSpec:
    """Load a graph saved as ``.json`` (``adjacency`` lists or an edge
    list) or as the reference's ``.gpickle`` (a pickled networkx Graph,
    which unpickling imports networkx for).  Both keep each node's
    neighbour order."""
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        if "adjacency" in data:
            return graph_spec_from_adjacency(data["adjacency"])
        return graph_spec_from_edges(data["num_nodes"],
                                     [tuple(e) for e in data["edges"]])
    with open(path, "rb") as f:
        return graph_spec_from_nx(pickle.load(f))


def save_graph_spec(adjacency: Sequence[Sequence[int]], path: str) -> None:
    """Save ordered per-node neighbour lists as JSON (``num_nodes``,
    ``adjacency``), the file ``load_graph_spec`` reads."""
    with open(path, "w") as f:
        json.dump({"num_nodes": len(adjacency),
                   "adjacency": [list(a) for a in adjacency]}, f)


def resolve_stage_graph(stage: int, nodes: int = 5, p: float = 0.75,
                        k: int = 4, seed: Optional[int] = None,
                        load_graph: Optional[str] = None,
                        save_graph: Optional[str] = None) -> GraphSpec:
    """The graph of one encoder stage (stages count from 1), by the policy
    of reference model/layers/encoder.py:237-254.  ``load_graph`` is a
    directory holding ``stage_{i}.json`` or ``stage_{i}.gpickle`` (the
    JSON first); without it the graph is built with networkx from
    ``seed = stage * seed`` and, where ``save_graph`` names a directory,
    written to ``<save_graph>/nodes_{nodes}_seed_{seed}/stage_{i}.json``."""
    if load_graph is not None:
        directory = load_graph
        if not os.path.isabs(directory) and not os.path.isdir(directory):
            directory = os.path.join(_REPO_ROOT, directory)
        for name in (f"stage_{stage}.json", f"stage_{stage}.gpickle"):
            path = os.path.join(directory, name)
            if os.path.exists(path):
                return load_graph_spec(path)
        raise FileNotFoundError(f"no stage_{stage} graph under {load_graph}")

    g = _watts_strogatz(nodes, k, p, (stage * seed) if seed is not None else None)
    if save_graph is not None:
        directory = os.path.join(save_graph, f"nodes_{nodes}_seed_{seed}")
        os.makedirs(directory, exist_ok=True)
        save_graph_spec(_adjacency(g),
                        os.path.join(directory, f"stage_{stage}.json"))
    return graph_spec_from_nx(g)
