"""The port's training step against the JAX package's, on the tiny config
(``torch_port_helpers.PORT_MODEL``, 32x64, batch 2) from the same
converted weights and numpy-seeded stereo pairs: one step's losses and
gradients against a JAX ``loss_fn`` built as the JAX trainer builds it, and
three steps of ``Trainer.train_step`` against the JAX ``Trainer``'s jitted
step (losses, parameters, BatchNorm running statistics).  Also the
BatchNorm semantics, the schedules, the flagship loss config, and the
trainer's hygiene (no kernel on the CPU, CUDA by default)."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tiny_config import TINY_INPUT, TINY_LOSS
from torch_port_helpers import PORT_MODEL, models as build_models, port_model

from uncertainty_model_tpu.losses import TukraUncertaintyLoss as JaxLoss
from uncertainty_model_tpu.models.layers import TorchBatchNorm
from uncertainty_model_tpu.ops import reconstruct_pyramid_with_lr as jax_recon_lr
from uncertainty_model_tpu.ops import scale_pyramid as jax_scale_pyramid
from uncertainty_model_tpu.parallel import create_mesh, shard_batch
from uncertainty_model_tpu.train import Trainer as JaxTrainer
from uncertainty_model_tpu.train.convert import convert_model_state_dict
from uncertainty_model_tpu.utils import pyramid as jax_pyramid
from uncertainty_model_tpu.utils import schedules as jax_schedules

from uncertainty_model_tpu_torch.config import FLAGSHIP_LOSS
from uncertainty_model_tpu_torch.ops.warp_rows import (
    warp_rows_bwd, warp_rows_fwd)
from uncertainty_model_tpu_torch.train import Trainer
from uncertainty_model_tpu_torch.utils import pyramid, schedules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISP_SCALE = schedules.adjust_disparity(0)
# the CLI's default learning rate; with it a parameter whose gradient is
# only noise (a conv bias ahead of BatchNorm) moves at most 2 * 3 * 1e-4
# apart in 3 steps, inside the parameter limit's 2e-3 floor
LR = 1e-4
N_STEPS = 3


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {side: rng.uniform(size=(b, *TINY_INPUT, 3)).astype(np.float32)
            for side in ("left", "right")}


@pytest.fixture(scope="module")
def setup():
    """(JAX model, JAX variables) of the tiny config with real BatchNorm
    statistics; the port's model is built from the same variables."""
    jmodel, variables, _ = build_models("fc")
    return jmodel, variables


def _port_trainer(variables):
    model = port_model(PORT_MODEL, variables).train()
    return Trainer(model, TINY_LOSS, device="cpu")


def _as_jax_tree(model, grads=False):
    """The port model's parameters (or their gradients) and BatchNorm
    statistics as JAX variables, through the JAX package's converter."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    if grads:
        sd.update({k: p.grad.numpy() for k, p in model.named_parameters()})
    return convert_model_state_dict(sd, PORT_MODEL["decoder"]["layers"])


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_loss_and_grad(setup):
    """The JAX step's loss function (train/trainer.py:197-234, without the
    adversarial branch), jitted once for the module."""
    jmodel, _ = setup
    loss = JaxLoss(**TINY_LOSS)

    def loss_fn(params, batch_stats, left, right, disp_scale):
        pyramid = jax_scale_pyramid(jnp.concatenate([left, right], -1), 4)
        disparities, _ = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, left,
            disp_scale=disp_scale, train=True, mutable=["batch_stats"])
        disparities = [d.astype(jnp.float32) for d in disparities]
        recon, lr = jax_recon_lr(disparities, pyramid)
        d, e = loss(pyramid, disparities, recon, step=jnp.int32(0),
                    lr_pyramid=lr)
        return d + e, (d, e)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def test_one_step_losses_and_grads_match_jax(setup, jax_loss_and_grad):
    """Losses within rtol 3e-5; every parameter's gradient within
    max(5e-3 |g|, 5e-3) (tests/test_train_parity.py's limit: deep f32
    accumulation, and the BN-scale-invariant gate weights carry absolute
    noise in both frameworks).  lr 0 leaves the weights as they were."""
    _, variables = setup
    batch = _batch(1)
    (_, (want_d, want_e)), want_grads = jax_loss_and_grad(
        variables["params"], variables["batch_stats"],
        jnp.asarray(batch["left"]), jnp.asarray(batch["right"]),
        jnp.float32(DISP_SCALE))

    trainer = _port_trainer(variables)
    got = trainer.train_step(batch, DISP_SCALE, 0.0, 0)
    np.testing.assert_allclose(got["disp_loss"].item(), float(want_d),
                               rtol=3e-5)
    np.testing.assert_allclose(got["error_loss"].item(), float(want_e),
                               rtol=3e-5)

    ours = _flat(_as_jax_tree(trainer.model, grads=True)["params"])
    ref = _flat(want_grads)
    assert ours.keys() == ref.keys() and len(ours) > 100
    for key in ours:
        diff = np.linalg.norm(ours[key] - ref[key])
        scale = np.linalg.norm(ref[key])
        assert diff < max(5e-3 * scale, 5e-3), (key, diff, scale)


def test_three_steps_match_jax_trainer(setup):
    """Three steps of ``train_step`` against the JAX ``Trainer._train_step``
    on a one-device mesh after ``load_state`` of the same variables
    (tests/test_train_trajectory.py's limits): losses within 2e-3
    relative, parameters within max(2e-2 |p|, 2e-3 sqrt(n)), BatchNorm
    running statistics within 3e-2 of their scale."""
    jmodel, variables = setup
    mesh = create_mesh(jax.devices()[:1])
    jtrainer = JaxTrainer(jmodel, TINY_LOSS, mesh=mesh)
    # a copy: the jitted step donates the state's buffers
    state = jtrainer.load_state(jax.tree.map(np.array, variables))
    trainer = _port_trainer(variables)

    for i in range(N_STEPS):
        batch = _batch(10 + i)
        state, want = jtrainer._train_step(
            state, shard_batch(batch, mesh), jnp.float32(DISP_SCALE),
            jnp.float32(LR), jnp.int32(i))
        got = trainer.train_step(batch, DISP_SCALE, LR, i)
        for key in ("disp_loss", "error_loss"):
            w, g = float(want[key]), got[key].item()
            assert abs(g - w) < 2e-3 * max(abs(w), 1.0), (i, key, g, w)

    tree = _as_jax_tree(trainer.model)
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


@pytest.mark.parametrize("n_batch", [1, 4])
def test_batchnorm_train_mode_matches_torch_batchnorm(n_batch):
    """``nn.BatchNorm2d(momentum=0.1)`` in train mode is the JAX package's
    ``TorchBatchNorm`` (flax momentum 0.9): the batch normalised with the
    biased variance, the unbiased one accumulated (rtol 1e-5)."""
    rng = np.random.default_rng(n_batch)
    bn = torch.nn.BatchNorm2d(3, eps=1e-5, momentum=0.1).train()
    jbn = TorchBatchNorm(use_running_average=False)
    x0 = rng.normal(size=(n_batch, 2, 3, 3)).astype(np.float32)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x0))
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.0, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    variables = {"params": {"scale": jnp.asarray([0.5, 1.0, 2.0]),
                            "bias": jnp.asarray([0.1, -0.2, 0.3])},
                 "batch_stats": variables["batch_stats"]}
    for step in range(2):
        x = (rng.normal(size=(n_batch, 2, 3, 3)) * 2 + step).astype(np.float32)
        want, mutated = jbn.apply(variables, jnp.asarray(x),
                                  mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mutated["batch_stats"]}
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-5)


def test_schedules_match_jax():
    for epoch in range(60):
        assert (schedules.adjust_disparity(epoch)
                == jax_schedules.adjust_disparity(epoch))
        for finetune in (False, True):
            assert (schedules.learning_rate_for_epoch(epoch, 1e-4, finetune)
                    == jax_schedules.learning_rate_for_epoch(epoch, 1e-4,
                                                             finetune))
    # banker's rounding: round(2.5) == 2 keeps epoch 19 at 0.3 + 0.1
    assert schedules.adjust_disparity(9) == pytest.approx(0.1 + 0.2)


def test_pyramid_utils_match_jax():
    rng = np.random.default_rng(3)
    a = [rng.normal(size=(2, 8 >> i, 16 >> i, 6)).astype(np.float32)
         for i in range(3)]
    b = [rng.normal(size=(1, 8 >> i, 16 >> i, 6)).astype(np.float32)
         for i in range(3)]
    got = pyramid.concatenate_pyramids([torch.from_numpy(x) for x in a],
                                       [torch.from_numpy(x) for x in b])
    want = jax_pyramid.concatenate_pyramids(a, b)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    level = torch.from_numpy(a[0]).requires_grad_()
    (detached,) = pyramid.detach_pyramid([level * 2])
    assert not detached.requires_grad
    np.testing.assert_array_equal(detached.numpy(), 2 * a[0])


def test_flagship_loss_equals_yml():
    with open(os.path.join(REPO, "configs", "uncertainty.yml")) as f:
        assert FLAGSHIP_LOSS == yaml.safe_load(f)["loss"]


def test_train_one_epoch_averages_the_steps(setup):
    """Losses read every 2 batches sum to the per-image averages of the
    same steps run one by one (the reference's sum of batch means over
    the images)."""
    _, variables = setup
    batches = [_batch(20 + i) for i in range(3)]
    stepped = _port_trainer(variables)
    losses = [stepped.train_step(b, DISP_SCALE, LR, i)
              for i, b in enumerate(batches)]
    seen = []
    averages = _port_trainer(variables).train_one_epoch(
        batches, DISP_SCALE, LR, metrics_every=2, progress=seen.append)
    n = sum(len(b["left"]) for b in batches)
    assert averages["disp"] == pytest.approx(
        sum(m["disp_loss"].item() for m in losses) / n, rel=1e-6)
    assert averages["unc"] == pytest.approx(
        sum(m["error_loss"].item() for m in losses) / n, rel=1e-6)
    assert [s["batch"] for s in seen] == [1]


def test_train_model_runs_the_schedules(setup, capsys, tmp_path):
    """The schedules, and the JAX CLI's evaluation and checkpoint arguments
    (cli/main.py:219-231, with its defaults of one evaluation and one
    checkpoint every 10 epochs) accepted."""
    _, variables = setup
    trainer = _port_trainer(variables)
    losses, metrics = trainer.train_model([_batch(30)], 2, LR, no_pbar=True)
    assert len(losses) == 2 and metrics == []
    assert all(np.isfinite(d) and np.isfinite(u) for d, u, _ in losses)
    assert "disparity scale: 0.30" in capsys.readouterr().out
    losses, metrics = trainer.train_model(
        [_batch(30)], 10, LR, val_loader=[_batch(31)], evaluate_every=10,
        save_evaluation_to=str(tmp_path / "results"), save_every=10,
        save_model_to=str(tmp_path / "model"), no_pbar=True, start_epoch=9)
    assert len(losses) == 1 and len(metrics) == 1
    assert sorted(os.listdir(tmp_path / "model")) == ["epoch_010", "final"]
    assert sorted(os.listdir(tmp_path / "results")) == ["epoch_010"]


def test_cpu_step_launches_no_kernel(setup):
    _, variables = setup
    before = (warp_rows_fwd.launches, warp_rows_bwd.launches)
    _port_trainer(variables).train_step(_batch(40), DISP_SCALE, LR, 0)
    assert (warp_rows_fwd.launches, warp_rows_bwd.launches) == before


def test_default_device_is_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    _, variables = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(port_model(PORT_MODEL, variables), TINY_LOSS)
