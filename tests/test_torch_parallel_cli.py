"""Evaluation and the data-parallel CLI on 2 CPU processes (gloo):

- ``evaluate_model`` on 2 ranks equals one process's on the concatenated
  batches (SSIM, AUSE and AURG: the random curve's noise is drawn at the
  global batch's shape on every rank, each taking its own rows), and rank
  0's first-sample comparison grids are the same pixels;
- evaluation shards that give the ranks different batches raise on every
  rank within the timeout, before any batch;
- ``python -m uncertainty_model_tpu_torch.cli.parallel_main`` in 2
  processes (``--platform cpu``) on a tiny da Vinci tree, one epoch with an
  evaluation and a checkpoint: one run folder, ``results.json`` only
  there; its training losses and validation metrics equal the JAX
  package's data-parallel ``Trainer`` and ``evaluate_model`` (the
  conftest's 8-device CPU mesh) fed the same global batches, built from
  two JAX ``DataLoader``s with ``shard_index`` 0 and 1; its checkpoint
  reloads into a one-process port trainer exactly.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from torch_parallel_helpers import (
    evaluate_job, free_address, spawn, unequal_evaluate_job)
from torch_parallel_oracle import (
    LR, STATS_REL, flat, global_batch, port_state)
from torch_port_helpers import PORT_MODEL, models as build_models, port_model

from uncertainty_model_tpu import data as jdata
from uncertainty_model_tpu.models import RandomlyConnectedModel as JaxModel
from uncertainty_model_tpu.parallel import create_mesh, shard_batch
from uncertainty_model_tpu.train import Trainer as JaxTrainer
from uncertainty_model_tpu.train.convert import convert_model_state_dict
from uncertainty_model_tpu.train.evaluate import evaluate_model as jax_evaluate

from uncertainty_model_tpu_torch.data.native import decode_png
from uncertainty_model_tpu_torch.models import RandomlyConnectedModel
from uncertainty_model_tpu_torch.train import Trainer, evaluate_model
from uncertainty_model_tpu_torch.train.checkpoint import load_checkpoint
from uncertainty_model_tpu_torch.utils import schedules
from uncertainty_model_tpu_torch.utils.viz import save_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.7
# 2 ranks against one process: the SSIM sums and the curves' means summed
# over the ranks in another order (read: SSIM 1.2e-6 relative, the random
# images' SSIM being near 0.005; AUSE and AURG within 1e-6 absolute)
PORT_SSIM_RTOL = 5e-6
PORT_SPARS_ATOL = 1e-6
# the CLI against the JAX package, link by link: the first step's losses
# as test_torch_train's one-step limit (3e-5 relative); the checkpoint's
# parameters within 2 lr of the JAX step's (Adam's first step moves each
# by about lr, those whose gradient is 0 but for rounding either way) and
# its statistics within STATS_REL; the evaluation of the checkpoint's
# weights as test_torch_eval's (SSIM 5e-5 relative, AUSE 5e-6 absolute;
# AURG draws other noise in JAX and is only finite).  (The evaluation of
# each side's own weights differs by what the 2 lr moves: 2.1e-4 in SSIM.)
JAX_LOSS_RTOL = 3e-5
SSIM_RTOL = 5e-5
SPARS_ATOL = 5e-6
CLI_TIMEOUT_S = 240
WORLD = 2
INIT_SEED = 3


# ---------------------------------------------------------------------------
# evaluate_model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def evaluation(tmp_path_factory):
    _, variables, _ = build_models("fc")
    state = port_state(variables)
    batches = [global_batch(41, 4), global_batch(42, 4)]
    out = tmp_path_factory.mktemp("evaluation")
    ranks = spawn(evaluate_job, model_config=PORT_MODEL, model_state=state,
                  batches=batches, scale=SCALE, out=str(out / "ranks"))
    one = evaluate_model(port_model(PORT_MODEL, variables), batches,
                         save_evaluation_to=str(out / "one"), scale=SCALE,
                         no_pbar=True)
    return {"ranks": ranks, "one": one, "out": out}


def test_evaluation_equals_one_process(evaluation):
    """SSIM (per image over the global batch), AUSE and AURG (the global
    batch's curves; AURG's noise drawn at the global shape) on both ranks
    against one process on the concatenated batches."""
    (want_l, want_r), (want_ause, want_aurg) = evaluation["one"]
    for (left, right), (ause, aurg) in evaluation["ranks"]:
        np.testing.assert_allclose([left, right], [want_l, want_r],
                                   rtol=PORT_SSIM_RTOL)
        np.testing.assert_allclose([ause, aurg], [want_ause, want_aurg],
                                   rtol=0, atol=PORT_SPARS_ATOL)


def test_evaluation_grids_are_rank_zeros(evaluation):
    """Rank 0 writes the first sample's three grids, the same pixels as
    one process's (the first sample is rank 0's first row); rank 1
    writes nothing."""
    out = evaluation["out"]
    names = ["disparity.png", "prediction.png", "uncertainty.png"]
    assert sorted(os.listdir(out / "ranks" / "final")) == names
    for name in names:
        np.testing.assert_array_equal(
            decode_png(str(out / "ranks" / "final" / name)),
            decode_png(str(out / "one" / "final" / name)))


def test_unequal_evaluation_shards_raise_on_every_rank(tmp_path):
    _, variables, _ = build_models("fc")
    errors = spawn(unequal_evaluate_job, expect_errors=True, timeout=60,
                   model_config=PORT_MODEL, model_state=port_state(variables),
                   batch=global_batch(43, 4), scale=SCALE, out=str(tmp_path))
    for text in errors:
        assert text.startswith("ValueError: the evaluation shards' batch "
                               "sizes differ across the ranks ([[2, 2], "
                               "[2]]"), text
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# the parallel CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_home(tmp_path_factory):
    """A $HOME/datasets/da-vinci tree of 8 train and 4 test pairs, 48x96
    (tests/test_torch_cli.py's)."""
    home = tmp_path_factory.mktemp("home")
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("test", 4)):
        for side in ("image_0", "image_1"):
            d = home / "datasets" / "da-vinci" / split / side
            d.mkdir(parents=True)
            for i in range(n):
                save_image(rng.uniform(size=(48, 96, 3)),
                           str(d / f"{i:03}.png"))
    return str(home)


def cli_argv(home, out):
    return ["configs/tiny.yml", "da-vinci", "--platform", "cpu",
            "--epochs", "1", "--batch-size", "8",
            "--training-size", "8", "--validation-size", "4",
            "--workers", "2", "--image-size", "32", "64",
            "--save-model-every", "1", "--evaluate-every", "1",
            "--save-model-to", os.path.join(out, "trained"),
            "--save-results-to", os.path.join(out, "results"),
            "--no-pbar", "--home", home, "--init-seed", str(INIT_SEED)]


@pytest.fixture(scope="module")
def cli_run(data_home, tmp_path_factory):
    """The parallel CLI in 2 processes, as a user starts it; each joined
    with a timeout."""
    out = str(tmp_path_factory.mktemp("parallel_cli"))
    address = free_address()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "uncertainty_model_tpu_torch.cli.parallel_main",
         *cli_argv(data_home, out), "--coordinator-address", address,
         "--num-processes", str(WORLD), "--process-id", str(rank)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(WORLD)]
    printed = []
    try:
        for p in procs:
            printed.append(p.communicate(timeout=CLI_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, text in zip(procs, printed):
        assert p.returncode == 0, text
    return {"out": out, "printed": printed}


@pytest.fixture(scope="module")
def jax_run(data_home):
    """The JAX package's data-parallel step and evaluation on the
    conftest's 8-device mesh, from the port CLI's initial weights (the
    port's initialisation from ``--init-seed``, through the JAX package's
    converter), fed global batches made of two JAX ``DataLoader``s'
    (native backend, ``shard_index`` 0 and 1: rank 0's rows, then rank
    1's).  The training losses are the JAX package's multi-process numbers
    (trainer.py:353-357: the sum of the global batches' mean losses over
    the process's own images)."""
    with open(os.path.join(REPO, "configs", "tiny.yml")) as f:
        config = yaml.load(f, Loader=yaml.Loader)
    model = RandomlyConnectedModel.from_config(**config["model"],
                                               seed=INIT_SEED, device="cpu")
    variables = convert_model_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        config["model"]["decoder"]["layers"])
    jmodel = JaxModel.from_config(**config["model"])
    jtrainer = JaxTrainer(jmodel, config["loss"], mesh=create_mesh())
    state = jtrainer.load_state(variables)

    size, root = (32, 64), os.path.join(data_home, "datasets", "da-vinci")
    train = jdata.DaVinciDataset(root, "train",
                                 jdata.default_augment_transform(size), 8)
    test = jdata.DaVinciDataset(root, "test",
                                jdata.default_eval_transform(size), 4)
    per_process = 8 // WORLD

    def global_batches(dataset, **kw):
        loaders = [jdata.DataLoader(dataset, per_process, num_workers=2,
                                    backend="native", shard_index=r,
                                    num_shards=WORLD, **kw)
                   for r in range(WORLD)]
        for loader in loaders:
            loader.set_epoch(0)
        return [{k: np.concatenate([b[k] for b in group]) for k in group[0]}
                for group in zip(*loaders)]

    lr = schedules.learning_rate_for_epoch(0, 1e-4)
    disp_scale = schedules.adjust_disparity(0)
    running, images = {"disp_loss": 0.0, "error_loss": 0.0}, 0
    for i, batch in enumerate(global_batches(train, shuffle=True,
                                             seed=INIT_SEED, drop_last=True)):
        state, metrics = jtrainer._train_step(
            state, shard_batch(batch, jtrainer.mesh), jnp.float32(disp_scale),
            jnp.float32(lr), jnp.int32(i))
        for key in running:
            running[key] += float(metrics[key])
        images += per_process
    return {"disp": running["disp_loss"] / images,
            "unc": running["error_loss"] / images,
            "state": jax.device_get(state), "config": config,
            "evaluate": lambda variables: jax_evaluate(
                jmodel, types.SimpleNamespace(**variables),
                global_batches(test, shuffle=False, drop_last=False),
                scale=disp_scale, mesh=jtrainer.mesh, no_pbar=True)}


def test_cli_writes_one_run_folder(cli_run):
    """One run folder (rank 0's timestamp, broadcast): ``epoch_001`` and
    ``final`` checkpoints in it, the grids and ``results.json`` in the
    results folder and nowhere else."""
    out = cli_run["out"]
    (run,) = os.listdir(os.path.join(out, "trained"))
    assert os.listdir(os.path.join(out, "results")) == [run]
    assert sorted(os.listdir(os.path.join(out, "trained", run))) == [
        "epoch_001", "final"]
    results = os.path.join(out, "results", run)
    assert sorted(os.listdir(results)) == ["epoch_001", "results.json"]
    assert sorted(os.listdir(os.path.join(results, "epoch_001"))) == [
        "disparity.png", "prediction.png", "uncertainty.png"]
    found = [os.path.join(d, f) for d, _, fs in os.walk(out) for f in fs
             if f == "results.json"]
    assert found == [os.path.join(results, "results.json")]
    # rank 0 prints the epoch and the evaluation, rank 1 neither
    assert "Evaluation:" in cli_run["printed"][0]
    assert "Epoch #1:" in cli_run["printed"][0]
    assert "Evaluation:" not in cli_run["printed"][1]
    assert "Epoch #1:" not in cli_run["printed"][1]


def _results(cli_run):
    out = cli_run["out"]
    (run,) = os.listdir(os.path.join(out, "results"))
    with open(os.path.join(out, "results", run, "results.json")) as f:
        return json.load(f)


def _checkpoint(cli_run):
    out = cli_run["out"]
    (run,) = os.listdir(os.path.join(out, "trained"))
    return load_checkpoint(os.path.join(out, "trained", run, "epoch_001"))


def test_cli_equals_jax(cli_run, jax_run):
    """``results.json`` and the checkpoint against the JAX package's
    data-parallel run on the same global batches: the training losses; the
    parameters and statistics after the step; the validation metrics
    against the JAX ``evaluate_model`` of the checkpoint's weights."""
    results = _results(cli_run)
    assert results["arguments"]["seed"] == INIT_SEED
    training = results["losses"]["training"]
    np.testing.assert_allclose(training["disparity"], [jax_run["disp"]],
                               rtol=JAX_LOSS_RTOL)
    np.testing.assert_allclose(training["uncertainty"], [jax_run["unc"]],
                               rtol=JAX_LOSS_RTOL)
    assert training["discriminator"] is None

    state_dict, _ = _checkpoint(cli_run)
    variables = convert_model_state_dict(
        {k: v.numpy() for k, v in state_dict.items()},
        jax_run["config"]["model"]["decoder"]["layers"])
    ours, ref = flat(variables["params"]), flat(jax_run["state"].params)
    assert ours.keys() == ref.keys()
    for key in ref:
        diff = np.abs(ours[key] - ref[key]).max()
        assert diff <= max(STATS_REL * np.abs(ref[key]).max(), 2 * LR), key
    ours = flat(variables["batch_stats"])
    ref = flat(jax_run["state"].batch_stats)
    for key in ref:
        assert np.abs(ours[key] - ref[key]).max() <= STATS_REL * np.abs(
            ref[key]).max(), key

    (left, right), (ause, _) = jax_run["evaluate"](variables)
    validation = results["losses"]["validation"]
    np.testing.assert_allclose(
        [validation["ssim"]["left"][0], validation["ssim"]["right"][0]],
        [left, right], rtol=SSIM_RTOL)
    np.testing.assert_allclose(validation["sparsification"]["ause"], [ause],
                               rtol=0, atol=SPARS_ATOL)
    assert np.isfinite(validation["sparsification"]["aurg"]).all()


def test_cli_checkpoint_reloads_exactly(cli_run, jax_run):
    """``epoch_001`` loads into a one-process port trainer: its parameters,
    statistics and Adam state are the file's bit for bit, and it resumes
    at epoch 1."""
    state_dict, train_state = _checkpoint(cli_run)
    config = jax_run["config"]
    trainer = Trainer(RandomlyConnectedModel.from_config(
        **config["model"], device="cpu"), config["loss"], device="cpu")
    assert trainer.load_state(state_dict, train_state) == 1
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, state_dict[key]), key
    saved = train_state["optimizer"]["state"]
    for i, moments in trainer.optimizer.state_dict()["state"].items():
        for key, value in moments.items():
            assert torch.equal(value, saved[i][key]), (i, key)
