"""The port's entry points (``uncertainty_model_tpu_torch/entry.py``)
against the JAX package's ``__graft_entry__.py``, on the CPU:

- ``load_flagship_config`` equals ``__graft_entry__._load_config``;
- ``entry``'s forward equals the JAX ``entry()``'s on the same weights
  (the JAX initialisation, through the port's converter).  The JAX entry
  builds the flagship, whose CPU compile at 256x512 takes ~62 s here, so
  the comparison runs on ``tests/tiny_config.py``'s model (the JAX side's
  ``_load_config`` replaced, the port's through ``entry(model_config=)``);
  the flagship is built by the port alone (its parameter count, the
  example arguments, one forward);
- ``dryrun_multichip(2, platform="cpu")`` (2 gloo processes, the flagship
  legs at 32x64): the tiny leg's three losses against the JAX ``Trainer``'s
  step on a 2-device CPU mesh from the same weights and numpy batch; both
  ranks' losses equal; every loss finite; rank 0's three lines;
- the port's copies of the JAX dryrun's configs equal the JAX ones (read
  from ``__graft_entry__.py``'s source), build models of the same
  parameter counts, and their saved graphs equal the networkx graphs the
  JAX configs build;
- without a card, ``entry()`` and ``dryrun_multichip(n)`` raise.
"""

import ast
import contextlib
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
from tiny_config import TINY_INPUT, TINY_MODEL
from torch_parallel_oracle import JAX_LOSS_RTOL, jax_step

from uncertainty_model_tpu.models import RandomDiscriminator as JaxDisc
from uncertainty_model_tpu.models import RandomlyConnectedModel as JaxModel
from uncertainty_model_tpu.parallel import create_mesh
from uncertainty_model_tpu.train import Trainer as JaxTrainer
from uncertainty_model_tpu.train.convert import (
    convert_discriminator_state_dict, convert_model_state_dict)

from uncertainty_model_tpu_torch import entry as port_entry
from uncertainty_model_tpu_torch.convert import from_jax_variables
from uncertainty_model_tpu_torch.models import (
    RandomDiscriminator, RandomlyConnectedModel)
from uncertainty_model_tpu_torch.models.graph import resolve_stage_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
FLAGSHIP_HW = (32, 64)    # the dryrun's flagship legs, cut for the CPU
FLAGSHIP_PARAMS = 22_493_949
# the eval forward against the JAX one in f32: test_torch_model's limits
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
TINY_FINAL_HW = (1, 2)    # the tiny discriminator's final map at 32x64


def _jax_dryrun_configs() -> dict:
    """The literal dicts ``model_cfg``, ``disc_cfg`` and ``loss_cfg`` that
    ``__graft_entry__.dryrun_multichip`` builds its tiny leg from."""
    path = os.path.join(REPO, "__graft_entry__.py")
    tree = ast.parse(open(path).read(), path)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_multichip")
    return {node.targets[0].id: ast.literal_eval(node.value)
            for node in ast.walk(fn) if isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id in ("model_cfg", "disc_cfg", "loss_cfg")}


def _without_graph(cfg: dict) -> dict:
    cfg = dict(cfg)
    del cfg["load_graph"]
    return cfg


def _port_dryrun_configs() -> dict:
    model = dict(port_entry.DRYRUN_MODEL,
                 encoder=_without_graph(port_entry.DRYRUN_MODEL["encoder"]))
    return {"model_cfg": model,
            "disc_cfg": _without_graph(port_entry.DRYRUN_DISC),
            "loss_cfg": port_entry.DRYRUN_LOSS}


@contextlib.contextmanager
def _captured_fd1(into: list):
    """This process's (and its children's) file descriptor 1 into a
    file, appended to ``into`` as text at the end."""
    with tempfile.TemporaryFile("w+") as f:
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)
        try:
            yield
        finally:
            os.dup2(saved, 1)
            os.close(saved)
            f.seek(0)
            into.append(f.read())


@pytest.fixture(scope="module")
def dryrun():
    """``dryrun_multichip(2, "cpu")``'s ranks' results and the lines
    printed, two threads a process."""
    printed = []
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    try:
        with _captured_fd1(printed):
            ranks = port_entry.dryrun_multichip(WORLD, "cpu",
                                                flagship_hw=FLAGSHIP_HW)
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return ranks, printed[0]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_flagship_config_equals_jax_load_config():
    assert port_entry.load_flagship_config() == __graft_entry__._load_config()


@pytest.mark.parametrize("name", ["model_cfg", "disc_cfg", "loss_cfg"])
def test_dryrun_configs_equal_jax(name):
    assert _port_dryrun_configs()[name] == _jax_dryrun_configs()[name]


@pytest.mark.parametrize("stage", [1, 2, 3, 4, 5])
def test_dryrun_graphs_equal_networkx(stage):
    """The saved graphs the port's dryrun configs load are the ones the
    JAX dryrun's configs (seed 42, no ``load_graph``) build."""
    assert (resolve_stage_graph(stage, nodes=5, seed=42,
                                load_graph=port_entry.FLAGSHIP_GRAPHS)
            == resolve_stage_graph(stage, nodes=5, seed=42))


def _jax_params(module, *args, **kw) -> int:
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kw))
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("which", ["model", "disc"])
def test_dryrun_configs_parameter_counts(which):
    jax_cfgs = _jax_dryrun_configs()
    h, w = port_entry.TINY_HW
    if which == "model":
        port = RandomlyConnectedModel.from_config(**port_entry.DRYRUN_MODEL,
                                                  device="cpu")
        want = _jax_params(JaxModel.from_config(**jax_cfgs["model_cfg"]),
                           jnp.zeros((1, h, w, 3)), disp_scale=1.0)
    else:
        port = RandomDiscriminator.from_config(**port_entry.DRYRUN_DISC,
                                               device="cpu")
        pyramid = [jnp.zeros((1, h >> i, w >> i, 6)) for i in range(4)]
        want = _jax_params(JaxDisc.from_config(**jax_cfgs["disc_cfg"]),
                           pyramid)
    assert sum(p.numel() for p in port.parameters()) == want > 1000


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def test_entry_matches_jax_entry(monkeypatch):
    """The JAX entry's jitted forward and the port's on the JAX entry's
    weights, the tiny model, f32, on a seeded image and on the example
    zeros."""
    monkeypatch.setattr(__graft_entry__, "_load_config",
                        lambda: {"model": TINY_MODEL})
    jax_forward, (variables, jax_zeros) = __graft_entry__.entry()
    forward, (model, zeros) = port_entry.entry(device="cpu",
                                               model_config=TINY_MODEL)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    assert zeros.dtype == torch.float32 and zeros.device.type == "cpu"
    assert tuple(zeros.shape) == jax_zeros.shape == (1, 256, 512, 3)
    x = np.random.default_rng(0).uniform(
        size=(2, *TINY_INPUT, 3)).astype(np.float32)
    for image, jax_image in ((torch.from_numpy(x), jnp.asarray(x)),
                             (zeros, jax_zeros)):
        want = np.asarray(jax_forward(variables, jax_image))
        got = forward(model, image)
        assert got.shape == want.shape == (*image.shape[:3], 4)
        np.testing.assert_allclose(got.numpy(), want, rtol=FWD_RTOL,
                                   atol=FWD_ATOL)


def test_entry_builds_the_flagship():
    forward, (model, zeros) = port_entry.entry(device="cpu")
    assert sum(p.numel() for p in model.parameters()) == FLAGSHIP_PARAMS
    assert not model.training
    out = forward(model, zeros)
    assert out.shape == (1, 256, 512, 4) and torch.isfinite(out).all()


def test_entry_default_device_is_cuda():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_entry.entry()


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,platform", [(1, None), (2, None), (2, "cuda")])
def test_dryrun_needs_the_cards(n, platform):
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.dryrun_multichip(n, platform)


def test_dryrun_main_needs_the_cards():
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.main(["--dryrun-multichip", "1"])


def test_dryrun_tiny_leg_matches_jax(dryrun):
    """The tiny leg's adversarial step over 2 gloo ranks against the JAX
    ``Trainer``'s on a 2-device CPU mesh from the port's initial weights
    (seed 0, through the JAX package's converters) and the JAX dryrun's
    numpy batch: the three losses within test_torch_train's one-step
    limit."""
    ranks, _ = dryrun
    cfgs = _jax_dryrun_configs()
    model = RandomlyConnectedModel.from_config(**port_entry.DRYRUN_MODEL,
                                               seed=0, device="cpu")
    disc = RandomDiscriminator.from_config(**port_entry.DRYRUN_DISC,
                                           init_seed=0, device="cpu")
    variables = convert_model_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        cfgs["model_cfg"]["decoder"]["layers"])
    disc_variables = convert_discriminator_state_dict(
        {k: v.numpy() for k, v in disc.state_dict().items()},
        final_feature_hw=TINY_FINAL_HW)
    mesh = create_mesh(devices=jax.devices()[:WORLD])
    jtrainer = JaxTrainer(JaxModel.from_config(**cfgs["model_cfg"]),
                          cfgs["loss_cfg"],
                          disc=JaxDisc.from_config(**cfgs["disc_cfg"]),
                          mesh=mesh)
    rng = np.random.default_rng(0)
    h, w = port_entry.TINY_HW
    batch = {side: rng.uniform(size=(WORLD * 2, h, w, 3)).astype(np.float32)
             for side in ("left", "right")}
    want, *_ = jax_step(jtrainer, variables, batch, 0, disc_variables)
    got = ranks[0]["tiny"]
    assert set(want) == {"disp_loss", "error_loss", "disc_loss"}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=JAX_LOSS_RTOL,
                                   err_msg=key)


def test_dryrun_ranks_agree_and_are_finite(dryrun):
    ranks, _ = dryrun
    assert [r["device"] for r in ranks] == ["cpu"] * WORLD
    for leg in ("tiny", "flagship", "flagship_train"):
        assert ranks[0][leg] == ranks[1][leg], leg
        losses = {k: v for k, v in ranks[0][leg].items() if k != "launches"}
        assert len(losses) >= 2 and all(np.isfinite(list(losses.values())))
        # the plain versions run on the CPU: no kernel launch
        assert ranks[0][leg]["launches"] == {"warp_rows_fwd": 0,
                                             "warp_rows_bwd": 0}


def test_dryrun_prints_the_jax_lines(dryrun):
    ranks, printed = dryrun
    lines = [ln for ln in printed.splitlines()
             if ln.startswith(f"dryrun_multichip({WORLD})")]
    tiny, flagship, train = (ranks[0][k] for k in ("tiny", "flagship",
                                                   "flagship_train"))
    assert lines == [
        f"dryrun_multichip({WORLD}) ok: disp={tiny['disp_loss']:.4f} "
        f"unc={tiny['error_loss']:.4f} disc={tiny['disc_loss']:.4f}",
        f"dryrun_multichip({WORLD}) flagship ok: "
        f"disp={flagship['disp_loss']:.4f} unc={flagship['error_loss']:.4f}",
        f"dryrun_multichip({WORLD}) flagship train-step ok: "
        f"disp={train['disp_loss']:.4f} unc={train['error_loss']:.4f}"]
