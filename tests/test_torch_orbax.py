"""A JAX (orbax) training checkpoint resumed in the port, on the tiny config
(``configs/tiny.yml``, 32x64, batch 2):

- the JAX ``Trainer`` takes 2 steps (non-zero Adam moments, count 2) and
  saves ``epoch_001`` and ``final`` with orbax; ``tools/orbax_to_torch.py``
  (in-process, through its ``main``) converts them; the port's
  ``load_checkpoint`` gives the weights, the moments (read back into the
  JAX layout by the JAX package's own converter), the step count and the
  epoch exactly;
- 2 more steps of the JAX ``Trainer`` resumed from the orbax directory
  against 2 steps of the port's ``Trainer`` resumed from the converted one
  (``test_torch_train``'s three-step limits), and the first resumed step's
  update per parameter, a check that fails on a fresh Adam, swapped
  moments and a step count off by one;
- a state with a discriminator: its weights and moments exactly, its head
  at the tiny 1x2 final map, and a wrong ``--image-size`` refused;
- the port's CLI resuming the converted directory for one epoch, and its
  refusal of an orbax directory naming the tool.
"""

import contextlib
import copy
import io
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tiny_config import TINY_DISCRIMINATOR, TINY_INPUT, TINY_LOSS, TINY_MODEL
from torch_port_helpers import discriminators, models as build_models

from uncertainty_model_tpu.parallel import create_mesh, shard_batch
from uncertainty_model_tpu.train import Trainer as JaxTrainer
from uncertainty_model_tpu.train import TrainState
from uncertainty_model_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from uncertainty_model_tpu.train.convert import (
    convert_discriminator_state_dict, convert_model_state_dict)

from uncertainty_model_tpu_torch.cli.main import build_parser, main as cli_main
from uncertainty_model_tpu_torch.convert import (
    discriminator_final_hw, from_jax_discriminator_variables,
    from_jax_train_state, from_jax_variables)
from uncertainty_model_tpu_torch.models import (
    RandomDiscriminator, RandomlyConnectedModel)
from uncertainty_model_tpu_torch.train import Trainer, load_checkpoint
from uncertainty_model_tpu_torch.train.trainer import adam
from uncertainty_model_tpu_torch.utils.schedules import adjust_disparity
from uncertainty_model_tpu_torch.utils.viz import save_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import orbax_to_torch  # noqa: E402

CONFIG = os.path.join(REPO, "configs", "tiny.yml")
IMAGE_SIZE = ["--image-size", str(TINY_INPUT[0]), str(TINY_INPUT[1])]
DISP_SCALE = adjust_disparity(1)
LR = 1e-4
DISC_FEATURE_HW = (1, 2)


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {side: rng.uniform(size=(b, *TINY_INPUT, 3)).astype(np.float32)
            for side in ("left", "right")}


def _copy(tree):
    """A host copy: the jitted step donates its state's buffers."""
    return jax.tree.map(np.array, tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _convert(orbax_dir, out_dir, *extra):
    with contextlib.redirect_stdout(io.StringIO()):
        return orbax_to_torch.main([orbax_dir, CONFIG, out_dir, *IMAGE_SIZE,
                                    *extra])


def _jax_step(jtrainer, state, mesh, seed, i):
    return jtrainer._train_step(state, shard_batch(_batch(seed), mesh),
                                jnp.float32(DISP_SCALE), jnp.float32(LR),
                                jnp.int32(i))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """2 JAX steps saved with orbax as ``epoch_001`` and ``final`` and
    converted by the tool; then from the restored orbax state the JAX
    ``Trainer``'s next 2 steps (their parameters after the first, their
    losses and the last state), compiled once for the module."""
    tmp = tmp_path_factory.mktemp("orbax")
    jmodel, variables, _ = build_models("tiny")
    mesh = create_mesh(jax.devices()[:1])
    jtrainer = JaxTrainer(jmodel, TINY_LOSS, mesh=mesh)
    state = jtrainer.load_state(_copy(variables))
    for i in range(2):
        state, _ = _jax_step(jtrainer, state, mesh, 10 + i, i)
    orbax_dir = str(tmp / "jax")
    with contextlib.redirect_stdout(io.StringIO()):
        epoch_dir = jax_save_checkpoint(orbax_dir, state, epoch_number=1)
        final_dir = jax_save_checkpoint(orbax_dir, state, is_final=True)
    port_dir = str(tmp / "port")
    out = {"orbax": epoch_dir, "orbax_final": final_dir,
           "port": _convert(epoch_dir, port_dir),
           "port_final": _convert(final_dir, port_dir),
           "restored": jax_load_checkpoint(epoch_dir)}
    restored = out["restored"]
    state = jtrainer.load_state(
        {"params": _copy(restored["params"]),
         "batch_stats": _copy(restored["batch_stats"]),
         "opt_state": _copy(restored["opt_state"])})
    out["jax_losses"] = []
    for i in range(2):
        state, metrics = _jax_step(jtrainer, state, mesh, 20 + i, i)
        out["jax_losses"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            out["jax_update"] = jax.tree.map(
                lambda a, b: np.asarray(a, np.float64) - np.asarray(b),
                jax.device_get(state.params), restored["params"])
    out["jax_state"] = jax.device_get(state)

    # the same first step from weights moved by 1e-7 relative (f32
    # rounding): how far each parameter's update moves with rounding alone
    rng = np.random.default_rng(0)
    nudged = jax.tree.map(lambda a: (np.asarray(a) * (
        1 + 1e-7 * rng.standard_normal(np.shape(a)))).astype(np.float32),
        restored["params"])
    state = jtrainer.load_state(
        {"params": _copy(nudged),
         "batch_stats": _copy(restored["batch_stats"]),
         "opt_state": _copy(restored["opt_state"])})
    state, _ = _jax_step(jtrainer, state, mesh, 20, 0)
    out["nudged_update"] = jax.tree.map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b),
        jax.device_get(state.params), nudged)
    return out


def _port_trainer(path, fault=None):
    """The port's ``Trainer`` resumed from the converted ``path``, with
    ``fault`` planted in its Adam state: "fresh" (the weights alone),
    "swapped" (the two moments exchanged) or "count+1"."""
    model = RandomlyConnectedModel.from_config(**TINY_MODEL, device="cpu")
    trainer = Trainer(model.train(), TINY_LOSS, device="cpu")
    state_dict, train_state = load_checkpoint(path)
    if fault == "fresh":
        train_state = None
    elif fault is not None:
        train_state = copy.deepcopy(train_state)
        for s in train_state["optimizer"]["state"].values():
            if fault == "swapped":
                s["exp_avg"], s["exp_avg_sq"] = s["exp_avg_sq"], s["exp_avg"]
            else:
                s["step"] += 1
    assert trainer.load_state(state_dict, train_state) == (
        0 if fault == "fresh" else 1)
    return trainer


def _port_tree(model, tensors=None):
    """The port model's ``state_dict`` (with ``tensors`` by parameter name
    in place of the parameters) in the JAX layout, through the JAX
    package's converter."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    sd.update({k: v.numpy() for k, v in (tensors or {}).items()})
    return convert_model_state_dict(sd, TINY_MODEL["decoder"]["layers"])


def _port_update(trainer, seed=20):
    """The parameters' update of one port step, in the JAX layout."""
    before = {k: p.detach().clone() for k, p in
              trainer.model.named_parameters()}
    trainer.train_step(_batch(seed), DISP_SCALE, LR, 0)
    return _port_tree(trainer.model, {
        k: (p.detach() - before[k]).double() for k, p in
        trainer.model.named_parameters()})["params"]


def _moments(train_state, module):
    """``{name: state}`` of the Adam state_dict, by parameter name."""
    names = [name for name, _ in module.named_parameters()]
    groups = train_state["param_groups"]
    assert len(groups) == 1 and groups[0]["params"] == list(range(len(names)))
    return {names[i]: s for i, s in train_state["state"].items()}


# ---------------------------------------------------------------------------
# the conversion
# ---------------------------------------------------------------------------


def test_tool_writes_the_sources_names(run):
    assert os.path.basename(run["port"]) == "epoch_001"
    assert os.path.basename(run["port_final"]) == "final"
    for path in (run["port"], run["port_final"]):
        assert sorted(os.listdir(path)) == ["model.pt", "train_state.pt"]


def test_weights_are_the_converted_variables_exactly(run):
    state_dict, _ = load_checkpoint(run["port"])
    want = from_jax_variables(run["restored"])
    assert state_dict.keys() == want.keys()
    for key in want:
        assert torch.equal(state_dict[key], want[key]), key


def test_moments_step_and_epoch_are_exact(run):
    """``exp_avg`` and ``exp_avg_sq`` of each parameter, by name, read back
    into the JAX layout by the JAX package's converter, equal optax's
    ``mu`` and ``nu`` exactly; ``step`` is the count, 2, a CPU f32 tensor;
    ``param_groups`` are a fresh trainer's; the epoch is 1, and None for
    ``final``."""
    restored = run["restored"]
    assert int(restored["opt_state"]["count"]) == 2
    model = RandomlyConnectedModel(**TINY_MODEL)
    for path, epoch in ((run["port"], 1), (run["port_final"], None)):
        state_dict, train_state = load_checkpoint(path)
        assert train_state["epoch"] == epoch
        optimizer = train_state["optimizer"]
        assert optimizer["param_groups"] == adam(model).state_dict()[
            "param_groups"]
        model.load_state_dict(state_dict)
        moments = _moments(optimizer, model)
        assert moments.keys() == dict(model.named_parameters()).keys()
        for s in moments.values():
            assert s["step"].dtype == torch.float32 and s["step"].item() == 2
        for key, tree in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            got = _flat(_port_tree(model, {k: s[key] for k, s in
                                           moments.items()})["params"])
            want = _flat(restored["opt_state"][tree])
            assert got.keys() == want.keys() and len(got) > 100
            for k in want:
                assert np.array_equal(got[k], want[k]), (key, k)
            assert any(np.abs(v).max() > 0 for v in want.values())


def test_count_zero_steps_as_a_fresh_optimizer(run):
    """A state of count 0 and zero moments (a JAX state saved before its
    first step) gives the first step of a fresh optimizer, bit for bit."""
    restored = dict(run["restored"])
    zeros = jax.tree.map(np.zeros_like, restored["params"])
    restored["opt_state"] = {"count": np.int32(0), "mu": zeros, "nu": zeros}
    state_dict, train_state = from_jax_train_state(restored, TINY_MODEL)
    updates = []
    for state in (train_state, None):
        model = RandomlyConnectedModel.from_config(**TINY_MODEL, device="cpu")
        trainer = Trainer(model.train(), TINY_LOSS, device="cpu")
        trainer.load_state(state_dict, state)
        trainer.train_step(_batch(30), DISP_SCALE, LR, 0)
        updates.append([p.detach().clone()
                        for p in trainer.model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*updates))


# ---------------------------------------------------------------------------
# the resumed run against the JAX trainer's
# ---------------------------------------------------------------------------


def test_two_resumed_steps_match_jax_trainer(run):
    """The port's ``Trainer`` resumed from the converted directory against
    the JAX ``Trainer`` resumed from the orbax one, 2 steps on the same
    batches (``test_torch_train.test_three_steps_match_jax_trainer``'s
    limits): losses within 2e-3 relative, parameters within max(2e-2
    |p|, 2e-3 sqrt(n)), BatchNorm running statistics within 3e-2 of their
    scale."""
    trainer = _port_trainer(run["port"])
    for i in range(2):
        got = trainer.train_step(_batch(20 + i), DISP_SCALE, LR, i)
        want = run["jax_losses"][i]
        for key in ("disp_loss", "error_loss"):
            w, g = want[key], got[key].item()
            assert abs(g - w) < 2e-3 * max(abs(w), 1.0), (i, key, g, w)
    tree, state = _port_tree(trainer.model), run["jax_state"]
    ours, ref = _flat(tree["params"]), _flat(state.params)
    assert ours.keys() == ref.keys()
    for key in ours:
        diff = np.linalg.norm(ours[key] - ref[key])
        assert diff < max(2e-2 * np.linalg.norm(ref[key]),
                          2e-3 * np.sqrt(ref[key].size)), (key, diff)
    ours, ref = _flat(tree["batch_stats"]), _flat(state.batch_stats)
    assert ours.keys() == ref.keys()
    for key in ours:
        scale = np.abs(ref[key]).max() + 1e-6
        assert np.abs(ours[key] - ref[key]).max() < 3e-2 * scale, key


# the first resumed step's update (p_after - p_before) per parameter, port
# against JAX: within UPDATE_REL of the JAX update's norm, or within
# UPDATE_NOISE times the distance the JAX update itself moves when the
# weights move by 1e-7 relative (the parameters whose gradient is 0 but for
# rounding, conv biases ahead of BatchNorm and attention key biases, take
# an Adam step of rounding).  Read on the tiny config: the 185 other
# parameters 2.2e-3 at most (the JAX update from nudged weights: 1.3e-3 at
# most), the 48 of rounding 2.42 times the nudged distance at most; a step
# count off by one moves every update by 9-16%
UPDATE_REL, UPDATE_NOISE = 1e-2, 8.0


def _update_misses(got, want, nudged):
    """The parameters whose update is off: ``(name, distance / limit)``."""
    got, want, nudged = _flat(got), _flat(want), _flat(nudged)
    assert got.keys() == want.keys() == nudged.keys()
    misses = []
    for key in want:
        limit = max(UPDATE_REL * np.linalg.norm(want[key]),
                    UPDATE_NOISE * np.linalg.norm(nudged[key] - want[key]))
        ratio = np.linalg.norm(got[key] - want[key]) / limit
        if not ratio < 1:
            misses.append((key, ratio))
    return misses


def test_first_resumed_update_matches_jax(run):
    assert _update_misses(_port_update(_port_trainer(run["port"])),
                          run["jax_update"], run["nudged_update"]) == []


@pytest.mark.parametrize("fault", ["fresh", "swapped", "count+1"])
def test_update_check_catches_a_planted_fault(run, fault):
    """The same check fails where the resumed Adam state is wrong."""
    misses = _update_misses(_port_update(_port_trainer(run["port"], fault)),
                            run["jax_update"], run["nudged_update"])
    assert len(misses) > 100


# ---------------------------------------------------------------------------
# a discriminator
# ---------------------------------------------------------------------------


def _random_adam(params, seed):
    rng = np.random.default_rng(seed)
    state = optax.scale_by_adam().init(params)
    return state._replace(
        count=jnp.int32(2),
        mu=jax.tree.map(lambda p: rng.normal(size=np.shape(p)).astype(
            np.float32), params),
        nu=jax.tree.map(lambda p: rng.uniform(size=np.shape(p)).astype(
            np.float32), params))


@pytest.fixture(scope="module")
def adversarial(run, tmp_path_factory):
    """An orbax checkpoint of the tiny model and discriminator, each with
    Adam moments drawn at random (exactness needs no step), epoch 3, and
    its conversion."""
    _, disc_variables = discriminators()
    restored = run["restored"]
    state = TrainState(
        params=restored["params"], batch_stats=restored["batch_stats"],
        opt_state=_random_adam(restored["params"], 1),
        disc_params=disc_variables["params"],
        disc_batch_stats=disc_variables["batch_stats"],
        disc_opt_state=_random_adam(disc_variables["params"], 2),
        disc_lag_params=disc_variables["params"])
    tmp = tmp_path_factory.mktemp("adversarial")
    with contextlib.redirect_stdout(io.StringIO()):
        orbax_dir = jax_save_checkpoint(str(tmp / "jax"), state,
                                        epoch_number=3)
    return {"orbax": orbax_dir, "port": _convert(orbax_dir, str(tmp / "port")),
            "restored": jax_load_checkpoint(orbax_dir), "tmp": tmp}


def test_discriminator_weights_and_moments_are_exact(adversarial):
    """The discriminator's weights equal ``from_jax_discriminator_variables``
    at the 1x2 final map of 32x64; its moments, read back into the JAX
    layout by the JAX package's converter at 1x2, equal ``mu`` and ``nu``
    exactly; the model's too; both steps 2, epoch 3.  The trainer resumes
    both optimizers and starts the clone as the discriminator."""
    assert discriminator_final_hw(TINY_DISCRIMINATOR, TINY_INPUT) == (
        DISC_FEATURE_HW)
    restored = adversarial["restored"]
    state_dict, train_state, disc_sd = load_checkpoint(adversarial["port"],
                                                       adversarial=True)
    assert train_state["epoch"] == 3
    disc_vars = {"params": restored["disc_params"],
                 "batch_stats": restored["disc_batch_stats"]}
    want = from_jax_discriminator_variables(disc_vars, DISC_FEATURE_HW)
    assert disc_sd.keys() == want.keys()
    assert all(torch.equal(disc_sd[k], want[k]) for k in want)

    disc = RandomDiscriminator(**TINY_DISCRIMINATOR)
    disc.load_state_dict(disc_sd)
    model = RandomlyConnectedModel(**TINY_MODEL)
    model.load_state_dict(state_dict)
    for module, key, tree in (
            (disc, "disc_optimizer", "disc_opt_state"),
            (model, "optimizer", "opt_state")):
        moments = _moments(train_state[key], module)
        assert all(s["step"].item() == 2 for s in moments.values())
        for name, field in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            sd = {k: v.detach().numpy()
                  for k, v in module.state_dict().items()}
            sd.update({k: s[name].numpy() for k, s in moments.items()})
            got = (convert_discriminator_state_dict(
                sd, final_feature_hw=DISC_FEATURE_HW) if module is disc
                else convert_model_state_dict(
                    sd, TINY_MODEL["decoder"]["layers"]))["params"]
            got, ref = _flat(got), _flat(restored[tree][field])
            assert got.keys() == ref.keys()
            assert all(np.array_equal(got[k], ref[k]) for k in ref), (key, name)

    trainer = Trainer(RandomlyConnectedModel.from_config(**TINY_MODEL,
                                                         device="cpu"),
                      TINY_LOSS, disc=RandomDiscriminator.from_config(
                          **TINY_DISCRIMINATOR, device="cpu"), device="cpu")
    assert trainer.load_state(state_dict, train_state, disc_sd) == 3
    assert all(torch.equal(a, b) for a, b in zip(
        trainer.disc_lag.parameters(), trainer.disc.parameters()))
    assert torch.equal(
        trainer.disc_optimizer.state_dict()["state"][0]["exp_avg"],
        train_state["disc_optimizer"]["state"][0]["exp_avg"])


def test_discriminator_head_rows_follow_the_final_map(adversarial):
    """The head's kernel rows go from NHWC to NCHW order at the 1x2 map,
    which moves them (rows kept in NHWC order would be a wrong head)."""
    restored = adversarial["restored"]
    _, _, disc_sd = load_checkpoint(adversarial["port"], adversarial=True)
    kernel = np.asarray(restored["disc_params"]["linear"]["kernel"])[:, 0]
    c = TINY_DISCRIMINATOR["final_conv"]["out_channels"]
    nchw = kernel.reshape(1, 2, c).transpose(2, 0, 1).ravel()
    weight = disc_sd["linear.weight"].numpy()[0]
    assert np.array_equal(weight, nchw)
    assert not np.array_equal(weight, kernel)


@pytest.mark.parametrize("size", [(64, 64), (32, 32)])
def test_a_wrong_image_size_is_refused(adversarial, size):
    with pytest.raises(ValueError, match="final map"):
        orbax_to_torch.main([adversarial["orbax"], CONFIG,
                             str(adversarial["tmp"] / f"wrong_{size[0]}"),
                             "--image-size", str(size[0]), str(size[1])])


# ---------------------------------------------------------------------------
# the port's CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_home(tmp_path_factory):
    """A $HOME/datasets/da-vinci tree of 8 train and 4 test pairs, 48x96."""
    home = tmp_path_factory.mktemp("home")
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("test", 4)):
        for side in ("image_0", "image_1"):
            d = home / "datasets" / "da-vinci" / split / side
            d.mkdir(parents=True)
            for i in range(n):
                save_image(rng.uniform(size=(48, 96, 3)), str(d / f"{i:03}.png"))
    return str(home)


def _cli_args(home, out, *extra):
    return build_parser().parse_args([
        CONFIG, "da-vinci", "--platform", "cpu", "--epochs", "2",
        "--batch-size", "8", "--training-size", "8", "--validation-size", "4",
        "--workers", "2", *IMAGE_SIZE, "--save-model-every", "1",
        "--evaluate-every", "1", "--save-model-to", os.path.join(out, "trained"),
        "--save-results-to", os.path.join(out, "results"), "--no-pbar",
        "--home", home, *extra])


def test_cli_resumes_the_converted_directory(run, data_home, tmp_path):
    """``--resume-from`` the converted ``epoch_001`` runs epoch 2 alone
    and writes ``epoch_002`` and ``final``."""
    args = _cli_args(data_home, str(tmp_path), "--resume-from", run["port"])
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli_main(args)
    printed = printed.getvalue()
    assert "Epoch #1:" not in printed and "Epoch #2:" in printed
    (folder,) = os.listdir(args.save_model_to)
    run_dir = os.path.join(args.save_model_to, folder)
    assert sorted(os.listdir(run_dir)) == ["epoch_002", "final"]
    state_dict, train_state = load_checkpoint(os.path.join(run_dir, "final"))
    assert all(torch.isfinite(v).all() for v in state_dict.values())
    steps = {s["step"].item() for s in
             train_state["optimizer"]["state"].values()}
    assert steps == {3.0}


@pytest.mark.parametrize("flag", ["--resume-from", "--finetune-from"])
def test_cli_refusal_names_the_tool(run, data_home, tmp_path, flag):
    args = _cli_args(data_home, str(tmp_path), flag, run["orbax"])
    with pytest.raises(ValueError, match="tools/orbax_to_torch.py") as info:
        cli_main(args)
    assert run["orbax"] in str(info.value)
    assert "--image-size 32 64" in str(info.value)
