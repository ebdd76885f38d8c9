"""The JAX package's last public names in the port, each against its JAX
counterpart on the CPU:

- the graph files: ``save_graph_spec`` and ``resolve_stage_graph(
  save_graph=...)`` write the JAX package's bytes; a reference ``.gpickle``
  (a networkx Graph pickled here) loads to the same ``GraphSpec``,
  neighbour order included; ``resolve_encoder_graphs`` from stage 0 and 1;
  a config whose ``encoder:`` section sets ``save_graph`` builds the same
  model in both packages (the same stage graphs; the shared tiny weights,
  JAX variables from a seed, through ``convert.from_jax_variables``,
  strict) and writes the same files;
- ``reconstruct_stereo`` / ``reconstruct_pyramid`` against the JAX
  functions (its gather path on the CPU) at f32 atol 1e-5;
- ``ssim`` / ``dssim`` at atol 1e-6;
- ``native_available()`` equal to whether ``decode_resize_batch`` succeeds;
- an audit, by AST and without importing JAX, that every public top-level
  name of the JAX package has a counterpart in the port, or stands on
  ``RENAMED`` or ``TPU_ONLY`` with its reason.
"""

import ast
import copy
import os
import pickle

import networkx as nx
import numpy as np
import pytest
import torch

import jax

from tiny_config import TINY_INPUT, TINY_MODEL
from torch_port_helpers import images, models as build_models, to_nchw

from uncertainty_model_tpu.losses import dssim as jax_dssim
from uncertainty_model_tpu.losses import ssim as jax_ssim
from uncertainty_model_tpu.models import RandomlyConnectedModel as JaxModel
from uncertainty_model_tpu.models import encoder as jax_encoder
from uncertainty_model_tpu.models import graph as jax_graph
from uncertainty_model_tpu.ops import reconstruct_pyramid as jax_pyramid
from uncertainty_model_tpu.ops.warp import reconstruct_stereo as jax_stereo

from uncertainty_model_tpu_torch import _build
from uncertainty_model_tpu_torch.convert import from_jax_variables
from uncertainty_model_tpu_torch.data import native
from uncertainty_model_tpu_torch.losses import dssim, ssim
from uncertainty_model_tpu_torch.models import (
    RandomlyConnectedModel, graph, resolve_encoder_graphs)
from uncertainty_model_tpu_torch.ops import reconstruct_pyramid
from uncertainty_model_tpu_torch.ops.warp import reconstruct_stereo
from uncertainty_model_tpu_torch.ops.warp_rows import (warp_rows_bwd,
                                                       warp_rows_fwd)
from uncertainty_model_tpu_torch.utils.viz import save_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PACKAGE = os.path.join(REPO, "uncertainty_model_tpu")
PORT_PACKAGE = os.path.join(REPO, "uncertainty_model_tpu_torch")

# public names of the JAX package that the port keeps under another name
RENAMED = {
    "conv2d": "a plain NHWC conv: F.conv2d on channels-last tensors "
              "(models/layers.py::conv2d applies a conv module)",
    "reflect_conv2d": "models/layers.py::reflect_conv",
    "TrainState": "the port's Trainer with train/checkpoint.py",
    "convert_model_state_dict": "the port keeps the reference's key names: "
                                "train/checkpoint.py::load_torch_checkpoint "
                                "reads a reference .pt directly",
    "convert_discriminator_state_dict": "as convert_model_state_dict",
    "torch_fanin_uniform": "models/layers.py::init_parameters",
}
# public names that exist only for the TPU or for JAX
TPU_ONLY = {
    "WARP_BACKEND": "chooses the Pallas or the XLA gather warp; the port's "
                    "wrapper dispatches on the tensor's device",
    "CONV_INPUT_BARRIER": "an XLA fusion barrier ahead of TPU convs",
    "ROWS_PER_PROGRAM": "the Pallas warp kernel's row block",
    "xavier_uniform": "a flax initialiser; the port initialises with "
                      "models/layers.py::init_parameters",
    "create_mesh": "jax.sharding meshes; the port runs DDP over processes "
                   "(parallel/mesh.py::init_distributed)",
    "batch_sharding": "as create_mesh; the loader shards the batch",
    "replicated": "as create_mesh",
    "shard_batch": "as batch_sharding",
    "replicate_tree": "as create_mesh; DDP broadcasts the parameters",
}

ADJACENCY = [[3, 4, 1], [0, 2, 3], [1, 3, 4], [2, 1, 0], [0, 2]]


def _files(root):
    out = {}
    for directory, _, names in os.walk(root):
        for name in names:
            path = os.path.join(directory, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_save_graph_spec_writes_the_jax_file(tmp_path):
    graph.save_graph_spec(ADJACENCY, str(tmp_path / "port.json"))
    jax_graph.save_graph_spec(ADJACENCY, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (
        tmp_path / "jax.json").read_bytes()
    assert (graph.load_graph_spec(str(tmp_path / "port.json"))
            == graph.graph_spec_from_adjacency(ADJACENCY))


def test_resolve_stage_graph_saves_as_jax(tmp_path):
    for stage in range(1, 6):
        got = graph.resolve_stage_graph(stage, seed=42,
                                        save_graph=str(tmp_path / "port"))
        want = jax_graph.resolve_stage_graph(stage, seed=42,
                                             save_graph=str(tmp_path / "jax"))
        assert tuple(got) == tuple(want)
    files = _files(tmp_path / "port")
    assert sorted(files) == [f"nodes_5_seed_42/stage_{i}.json"
                             for i in range(1, 6)]
    assert files == _files(tmp_path / "jax")


def test_gpickle_loads_as_jax(tmp_path):
    """A networkx Graph whose node 3 gets its neighbours in the order 2, 1,
    0 (not sorted) loads to the same spec in both packages, by path and
    through ``resolve_stage_graph(load_graph=...)``; a JSON file beside it
    comes first, as in the JAX package."""
    g = nx.Graph()
    g.add_edges_from([(3, 2), (3, 1), (3, 0), (0, 1), (1, 2), (2, 4), (4, 0),
                      (1, 4)])
    with open(tmp_path / "stage_2.gpickle", "wb") as f:
        pickle.dump(g, f)
    got = graph.load_graph_spec(str(tmp_path / "stage_2.gpickle"))
    assert tuple(got) == tuple(
        jax_graph.load_graph_spec(str(tmp_path / "stage_2.gpickle")))
    assert got.nodes[3].inputs == (2, 1, 0)
    assert tuple(graph.resolve_stage_graph(2, load_graph=str(tmp_path))) == (
        tuple(jax_graph.resolve_stage_graph(2, load_graph=str(tmp_path))))
    jax_graph.save_graph_spec(ADJACENCY, str(tmp_path / "stage_2.json"))
    got = graph.resolve_stage_graph(2, load_graph=str(tmp_path))
    assert got == graph.graph_spec_from_adjacency(ADJACENCY)
    assert tuple(got) == tuple(
        jax_graph.resolve_stage_graph(2, load_graph=str(tmp_path)))


@pytest.mark.parametrize("first_stage", [0, 1])
def test_resolve_encoder_graphs_as_jax(first_stage, tmp_path):
    kwargs = dict(nodes=5, seed=42, first_stage=first_stage)
    got = resolve_encoder_graphs(4, save_graph=str(tmp_path / "port"),
                                 **kwargs)
    want = jax_encoder.resolve_encoder_graphs(
        4, save_graph=str(tmp_path / "jax"), **kwargs)
    assert [tuple(g) for g in got] == [tuple(g) for g in want]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert (resolve_encoder_graphs(2, load_graph="graphs/nodes_5_seed_42")
            == resolve_encoder_graphs(2, seed=42))


def test_encoder_save_graph_config_builds_as_jax(tmp_path):
    """A ``model:`` section whose encoder sets ``save_graph``: the port
    builds it (its ``RandomEncoder`` took no such argument before) with the
    JAX model's stage graphs, takes the shared tiny weights (JAX variables,
    ``torch_port_helpers.models``) strictly, gives the outputs of the model
    built without ``save_graph`` bit for bit (that model is held against
    the JAX package's ``apply`` in ``test_torch_model.py``) and writes the
    JAX package's ``stage_{i}.json`` bytes."""
    def config(out):
        cfg = copy.deepcopy(TINY_MODEL)
        cfg["encoder"]["save_graph"] = str(tmp_path / out)
        return cfg

    _, variables, reference = build_models("tiny")
    jmodel = JaxModel.from_config(**config("jax"))
    model = RandomlyConnectedModel(**config("port"))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    assert model.encoder.graphs == jmodel.encoder.graphs
    files = _files(tmp_path / "port")
    assert sorted(files) == [f"nodes_5_seed_42/stage_{i}.json"
                             for i in range(1, 6)]
    assert files == _files(tmp_path / "jax")
    x = to_nchw(images(7))
    with torch.no_grad():
        got, want = model(x), reference(x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _stereo_pyramid(seed, scales=4):
    rng = np.random.default_rng(seed)
    h, w = TINY_INPUT
    disps = [rng.uniform(-0.1, 0.3, size=(2, h >> i, w >> i, 4))
             .astype(np.float32) for i in range(scales)]
    pyramid = [rng.uniform(size=(2, h >> i, w >> i, 6)).astype(np.float32)
               for i in range(scales)]
    return disps, pyramid


def test_reconstruct_pyramid_and_stereo_match_jax():
    """The tiny config's 4 scales against the JAX functions (atol 1e-5);
    ``reconstruct_stereo`` is the pyramid's one scale exactly; the CPU
    launches no kernel."""
    disps, pyramid = _stereo_pyramid(11)
    before = (warp_rows_fwd.launches, warp_rows_bwd.launches)
    got = reconstruct_pyramid([torch.from_numpy(d) for d in disps],
                              [torch.from_numpy(p) for p in pyramid])
    want = jax_pyramid([jax.numpy.asarray(d) for d in disps],
                       [jax.numpy.asarray(p) for p in pyramid])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    one = reconstruct_stereo(torch.from_numpy(disps[1]),
                             torch.from_numpy(pyramid[1]))
    assert torch.equal(one, got[1])
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jax_stereo(disps[1], pyramid[1])), rtol=0,
        atol=1e-5)
    assert (warp_rows_fwd.launches, warp_rows_bwd.launches) == before


def test_ssim_and_dssim_match_jax():
    rng = np.random.default_rng(12)
    x = rng.uniform(size=(2, 16, 32, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(scale=0.1, size=x.shape), 0, 1).astype(
        np.float32)
    got = ssim(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, 14, 30, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ssim(x, y)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        ssim(torch.from_numpy(x), torch.from_numpy(y), 0.1, 0.2).numpy(),
        np.asarray(jax_ssim(x, y, 0.1, 0.2)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        dssim(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jax_dssim(x, y)), rtol=0, atol=1e-6)


def _decodes(path):
    try:
        native.decode_resize_batch([path], 8, 16, num_threads=1)
    except RuntimeError:
        return False
    return True


def test_native_available_is_whether_the_decoder_runs(tmp_path, monkeypatch):
    """Here the library builds: both True.  With a build that fails, both
    False, and ``decode_resize_batch`` raises rather than decoding another
    way."""
    path = str(tmp_path / "a.png")
    save_image(np.random.default_rng(0).uniform(size=(12, 20, 3)), path)
    assert native.native_available() == _decodes(path) is True

    def no_compiler(name):
        raise RuntimeError("g++ not found: it builds the port's host "
                           "libraries")

    native._library.cache_clear()
    monkeypatch.setattr(_build, "load", no_compiler)
    try:
        assert native.native_available() == _decodes(path) is False
    finally:
        native._library.cache_clear()


def _public_names(root):
    """{module path relative to ``root``: its public top-level names}: the
    functions, classes and assigned names, and in a package's
    ``__init__.py`` what it imports."""
    out = {}
    for directory, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(directory, name)
            tree = ast.parse(open(path).read(), path)
            names = set()
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    names.add(node.name)
                elif isinstance(node, ast.Assign):
                    names.update(t.id for t in node.targets
                                 if isinstance(t, ast.Name))
                elif isinstance(node, ast.AnnAssign) and isinstance(
                        node.target, ast.Name):
                    names.add(node.target.id)
                elif (isinstance(node, ast.ImportFrom)
                      and name == "__init__.py"):
                    names.update(a.asname or a.name for a in node.names)
            out[os.path.relpath(path, root)] = {
                n for n in names if not n.startswith("_")}
    return out


def test_every_public_jax_name_has_a_port_counterpart():
    """Each public top-level name of a JAX module has its namesake in the
    port's module of the same path, or, where the port has no such module
    (``ops/pallas/*``, ``train/convert.py``), anywhere in the port; else it
    stands on ``RENAMED`` or ``TPU_ONLY``.  Neither list names what the
    port does have (a stale entry fails too)."""
    jax_names = _public_names(JAX_PACKAGE)
    port_names = _public_names(PORT_PACKAGE)
    anywhere = set().union(*port_names.values())
    listed = set(RENAMED) | set(TPU_ONLY)
    missing, used = [], set()
    for module, names in sorted(jax_names.items()):
        have = port_names.get(module, anywhere)
        for name in sorted(names - have):
            if name in listed:
                used.add(name)
            else:
                missing.append(f"{module}::{name}")
    assert not missing, missing
    assert used == listed, listed - used
    assert not set(RENAMED) & set(TPU_ONLY)
