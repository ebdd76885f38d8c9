"""The port's checkpoints: a resumed run equals an uninterrupted one bit for
bit, a finetune restores the weights with a fresh optimizer, the JAX
package reads the port's ``model.pt`` (and its eval forward on it equals
the port's), and reference ``.pt`` files load with DDP's ``module.``
prefix and with a discriminator beside the model.  On the tiny config
(``torch_port_helpers.PORT_MODEL``, 32x64, batch 2) from converted JAX
weights, on the CPU."""

import os

import numpy as np
import pytest
import torch

from tiny_config import TINY_INPUT, TINY_LOSS
from torch_port_helpers import (
    PORT_MODEL, jax_eval, models as build_models, port_model, to_nchw,
    to_nhwc_numpy)

from uncertainty_model_tpu.train.checkpoint import (
    load_torch_checkpoint as jax_load_torch_checkpoint)

from uncertainty_model_tpu_torch.train import (
    Trainer, load_checkpoint, load_torch_checkpoint, save_checkpoint)

LR = 1e-4


@pytest.fixture(scope="module")
def variables():
    return build_models("fc")[1]


def _trainer(variables):
    return Trainer(port_model(PORT_MODEL, variables).train(), TINY_LOSS,
                   device="cpu")


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {side: rng.uniform(size=(2, *TINY_INPUT, 3)).astype(np.float32)
            for side in ("left", "right")}


def _equal_states(a: Trainer, b: Trainer) -> bool:
    """Weights, BatchNorm statistics and Adam's moments and steps, all
    bit for bit."""
    if not all(torch.equal(x, y) for x, y in zip(
            a.model.state_dict().values(), b.model.state_dict().values())):
        return False
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    return sa["state"].keys() == sb["state"].keys() and all(
        torch.equal(sa["state"][k][n], sb["state"][k][n])
        for k in sa["state"] for n in ("step", "exp_avg", "exp_avg_sq"))


def test_resume_reproduces_an_uninterrupted_run(variables, tmp_path):
    """2 epochs straight (evaluating and saving every epoch) equal 1 epoch,
    ``load_checkpoint`` of ``epoch_001`` into a fresh trainer,
    ``load_state`` and the second epoch from the returned start epoch."""
    loader = [_batch(1), _batch(2)]
    straight = _trainer(variables)
    _, metrics = straight.train_model(
        loader, 2, LR, val_loader=[_batch(3)], evaluate_every=1,
        save_every=1, save_model_to=str(tmp_path), no_pbar=True)
    assert sorted(os.listdir(tmp_path)) == ["epoch_001", "epoch_002", "final"]
    assert len(metrics) == 2 and np.isfinite(np.ravel(metrics)).all()

    resumed = _trainer(variables)
    start = resumed.load_state(*load_checkpoint(tmp_path / "epoch_001"))
    assert start == 1
    resumed.train_model(loader, 2, LR, no_pbar=True, start_epoch=start)
    assert _equal_states(straight, resumed)

    final = _trainer(variables)
    assert final.load_state(*load_checkpoint(tmp_path / "final")) == 0
    assert _equal_states(straight, final)


def test_finetune_restores_weights_with_a_fresh_optimizer(variables, tmp_path):
    trained = _trainer(variables)
    trained.train_model([_batch(4)], 1, LR, save_model_to=str(tmp_path),
                        no_pbar=True)
    state_dict, _ = load_checkpoint(tmp_path / "final")
    tuned = _trainer(variables)
    tuned.train_step(_batch(5), 0.3, LR)   # some Adam state to discard
    assert tuned.load_state(state_dict) == 0
    assert tuned.optimizer.state_dict()["state"] == {}
    for x, y in zip(trained.model.state_dict().values(),
                    tuned.model.state_dict().values()):
        assert torch.equal(x, y)


def test_jax_package_reads_the_ports_model_pt(variables, tmp_path):
    """The JAX package's ``load_torch_checkpoint`` reads ``model.pt`` as it
    is, and the JAX eval forward on those variables equals the port's
    eval forward at 1e-5."""
    trainer = _trainer(variables)
    trainer.train_step(_batch(6), 0.3, LR)
    path = save_checkpoint(str(tmp_path), trainer.model, trainer.optimizer,
                           epoch_number=1)
    jvars, disc = jax_load_torch_checkpoint(os.path.join(path, "model.pt"),
                                            PORT_MODEL)
    assert disc is None
    jmodel = build_models("fc")[0]
    x = _batch(7)["left"]
    want = jax_eval(jmodel, jvars, x, 0.5)
    with torch.no_grad():
        got = trainer.model.eval()(to_nchw(x), disp_scale=0.5)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(to_nhwc_numpy(g), w, rtol=1e-5, atol=1e-5)


def test_reference_pt_with_ddp_prefix_loads(variables, tmp_path):
    """A reference ``.pt`` saved from a DDP-wrapped model (``module.``
    keys) loads, weights only."""
    source = _trainer(variables)
    source.train_step(_batch(8), 0.3, LR)
    sd = source.model.state_dict()
    torch.save({f"module.{k}": v for k, v in sd.items()},
               tmp_path / "ref.pt")
    state_dict, disc = load_torch_checkpoint(str(tmp_path / "ref.pt"))
    assert disc is None and state_dict.keys() == sd.keys()
    target = _trainer(variables)
    assert target.load_state(state_dict) == 0
    for k, v in target.model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_adversarial_reference_pt_returns_both_and_the_trainer_refuses(
        variables, tmp_path):
    """A ``{"model", "disc"}`` file returns both dicts (prefixes stripped);
    the trainer refuses a discriminator until the adversarial branch is
    ported."""
    sd = _trainer(variables).model.state_dict()
    disc = {"module.final.weight": torch.ones(2, 3)}
    torch.save({"model": sd, "disc": disc}, tmp_path / "adv.pt")
    state_dict, disc_sd = load_torch_checkpoint(str(tmp_path / "adv.pt"))
    assert state_dict.keys() == sd.keys()
    assert list(disc_sd) == ["final.weight"]
    with pytest.raises(NotImplementedError):
        _trainer(variables).load_state(state_dict, disc_state_dict=disc_sd)
