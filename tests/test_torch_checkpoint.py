"""The port's checkpoints: a resumed run equals an uninterrupted one bit for
bit, a finetune restores the weights with a fresh optimizer, the JAX
package reads the port's ``model.pt`` (and its eval forward on it equals
the port's), and reference ``.pt`` files load with DDP's ``module.``
prefix and with a discriminator beside the model; an adversarial
checkpoint resumes bit for bit and the JAX package reads it.  On the tiny config
(``torch_port_helpers.PORT_MODEL``, 32x64, batch 2) from converted JAX
weights, on the CPU."""

import os

import numpy as np
import pytest
import torch

import jax

from tiny_config import TINY_DISCRIMINATOR, TINY_INPUT, TINY_LOSS
from torch_port_helpers import (
    PORT_MODEL, discriminators, jax_eval, models as build_models, port_disc,
    port_model, to_nchw, to_nhwc_numpy)

from uncertainty_model_tpu.train.checkpoint import (
    load_torch_checkpoint as jax_load_torch_checkpoint)
from uncertainty_model_tpu.train.convert import (
    convert_discriminator_state_dict, convert_model_state_dict)

from uncertainty_model_tpu_torch.convert import (
    from_jax_discriminator_variables)
from uncertainty_model_tpu_torch.models import RandomDiscriminator
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


def test_adversarial_reference_pt_returns_both_and_loads_into_a_trainer(
        variables, tmp_path):
    """A ``{"model", "disc"}`` file returns both dicts (prefixes stripped)
    and loads into a trainer with a discriminator (its lagged clone a copy
    of the restored one); a trainer without one refuses the
    discriminator's weights, and one with a discriminator refuses to go
    without them."""
    source = _adversarial_trainer(variables)
    source.train_step(_batch(9), 0.3, LR)
    sd, disc = source.model.state_dict(), source.disc.state_dict()
    torch.save({"model": sd, "disc": {f"module.{k}": v
                                      for k, v in disc.items()}},
               tmp_path / "adv.pt")
    state_dict, disc_sd = load_torch_checkpoint(str(tmp_path / "adv.pt"))
    assert state_dict.keys() == sd.keys() and disc_sd.keys() == disc.keys()
    target = _adversarial_trainer(variables)
    assert target.load_state(state_dict, disc_state_dict=disc_sd) == 0
    for k, v in target.disc.state_dict().items():
        assert torch.equal(v, disc[k]), k
    for a, b in zip(target.disc_lag.parameters(), source.disc.parameters()):
        assert torch.equal(a, b)
    assert target.disc_optimizer.state_dict()["state"] == {}
    with pytest.raises(ValueError, match="trainer with a discriminator"):
        _trainer(variables).load_state(state_dict, disc_state_dict=disc_sd)
    with pytest.raises(ValueError, match="give its weights"):
        _adversarial_trainer(variables).load_state(state_dict)


def _adversarial_trainer(variables):
    return Trainer(port_model(PORT_MODEL, variables).train(), TINY_LOSS,
                   disc=port_disc(discriminators()[1]), device="cpu")


def test_adversarial_checkpoint_resumes_bit_for_bit(variables, tmp_path):
    """``model.pt`` holds ``{"model", "disc"}`` and ``train_state.pt`` both
    optimizers; a fresh trainer loaded from it holds the same weights,
    statistics and Adam state as the one saved, and, the clone having been
    refreshed at the saved step (step 0), the next step equals the
    uninterrupted run's bit for bit.  Loaded without ``adversarial`` the
    checkpoint gives the model alone."""
    straight = _adversarial_trainer(variables)
    straight.train_step(_batch(11), 0.3, LR, 0)
    path = save_checkpoint(str(tmp_path), straight.model, straight.optimizer,
                           epoch_number=1, disc=straight.disc,
                           disc_optimizer=straight.disc_optimizer)
    payload = torch.load(os.path.join(path, "model.pt"), weights_only=True)
    assert sorted(payload) == ["disc", "model"]
    resumed = _adversarial_trainer(variables)
    assert resumed.load_state(*load_checkpoint(path, adversarial=True)) == 1
    assert _equal_states(straight, resumed)
    got = resumed.train_step(_batch(12), 0.3, LR, 1)
    want = straight.train_step(_batch(12), 0.3, LR, 1)
    assert all(torch.equal(got[k], want[k]) for k in want)
    for module in ("model", "disc"):
        a = getattr(straight, module).state_dict()
        b = getattr(resumed, module).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), module
    sa = straight.disc_optimizer.state_dict()["state"]
    sb = resumed.disc_optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][n], sb[i][n]) for i in sa
               for n in ("step", "exp_avg", "exp_avg_sq"))

    state_dict, train_state = load_checkpoint(path)
    assert state_dict.keys() == payload["model"].keys()
    plain = save_checkpoint(str(tmp_path), straight.model, straight.optimizer,
                            is_final=True)
    with pytest.raises(ValueError, match="holds no discriminator"):
        load_checkpoint(plain, adversarial=True)


def test_jax_package_reads_the_ports_adversarial_model_pt(variables,
                                                          tmp_path):
    """The JAX package's ``load_torch_checkpoint(adversarial=True)`` reads
    an adversarial ``model.pt`` of the port back to the JAX variables the
    port's weights came from (``from_jax_discriminator_variables``), bit
    for bit.  The JAX reader assumes the flagship's 8x16 final map, so the
    tiny discriminator's head is sized for a 256x512 input here."""
    cfg = dict(TINY_DISCRIMINATOR, linear_in_features=16 * 8 * 16)
    built = RandomDiscriminator.from_config(**cfg, init_seed=4, device="cpu")
    want = convert_discriminator_state_dict(
        {k: v.numpy() for k, v in built.state_dict().items()},
        final_feature_hw=(8, 16))
    disc = RandomDiscriminator(**cfg)
    disc.load_state_dict(from_jax_discriminator_variables(want, (8, 16)))
    trainer = _trainer(variables)
    path = save_checkpoint(str(tmp_path), trainer.model, trainer.optimizer,
                           is_final=True, disc=disc,
                           disc_optimizer=torch.optim.Adam(disc.parameters()))
    jvars, jdisc = jax_load_torch_checkpoint(os.path.join(path, "model.pt"),
                                             PORT_MODEL, adversarial=True)
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jdisc)[0]}
    ref = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
           jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat.keys() == ref.keys() and len(flat) > 100
    for key in ref:
        np.testing.assert_array_equal(flat[key], ref[key], err_msg=key)
    model_sd = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    np.testing.assert_array_equal(
        jvars["params"]["encoder"]["stage_0"]["attention"]["keys"]["kernel"],
        convert_model_state_dict(model_sd, PORT_MODEL["decoder"]["layers"])
        ["params"]["encoder"]["stage_0"]["attention"]["keys"]["kernel"])
