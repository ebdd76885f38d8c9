"""Training-mode space-to-depth encoder stages (``RandomlyConnectedModel(
s2d_stages=(0, 1))``) against the port's direct model and the JAX
package's s2d model from the same weights, on tests/test_s2d_training.py's
config: the same parameters, the train-mode forward and BatchNorm
statistics within rtol 2e-4, the gradients within rtol 5e-3, atol 1e-5
(the JAX test's limits); a bf16 step; a data-parallel step on 2 gloo
ranks (BatchNorm synced over the s2d view); and the serving build of an
s2d-trained model."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tiny_config import TINY_LOSS
from torch_parallel_helpers import (
    build_trainer, ddp_step_job, numpy_state, spawn, step_result)
from torch_parallel_oracle import (
    DISP_SCALE, LR, check_against_one_process, check_ranks_agree,
    global_batch)
from torch_port_helpers import (
    S2D_TRAINING_MODEL as CFG, images, models as build_models, port_model,
    to_nchw, to_nhwc_numpy)

from uncertainty_model_tpu.models import RandomlyConnectedModel as JaxModel

from uncertainty_model_tpu_torch.convert import from_jax_variables
from uncertainty_model_tpu_torch.serving import (
    build_serving_params, make_serving_forward)
from uncertainty_model_tpu_torch.train import Trainer

S2D = (0, 1)
FWD = dict(rtol=2e-4, atol=1e-5)
STATS = dict(rtol=2e-4, atol=1e-6)
GRADS = dict(rtol=5e-3, atol=1e-5)


@pytest.fixture(scope="module")
def variables():
    return build_models("s2d_training")[1]


def _port(variables, s2d_stages=S2D, dtype=None):
    return port_model(CFG, variables, dtype, s2d_stages).train()


def _stats(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _loss(outs):
    return sum(o.float().abs().mean() for o in outs)


def test_same_parameters_as_the_direct_model(variables):
    direct, s2d = _port(variables, ()), _port(variables)
    assert [m.layers[0].s2d for m in s2d.encoder.layers] == [
        True, True, False, False, False]
    a, b = direct.state_dict(), s2d.state_dict()
    assert list(a) == list(b)
    for key in a:
        assert a[key].shape == b[key].shape
        assert torch.equal(a[key], b[key]), key


def test_kernel_below_5_stays_native(variables):
    model = port_model(CFG, variables, s2d_stages=(0, 1, 2))
    assert [m.layers[0].s2d for m in model.encoder.layers][:3] == [
        True, True, False]


@functools.lru_cache(maxsize=None)
def _jax_train(seed):
    """The JAX s2d model's train-mode outputs, BatchNorm statistics (in
    the port's names) and gradients of ``_loss`` (the port's names)."""
    variables = build_models("s2d_training")[1]
    jmodel = JaxModel.from_config(**CFG, s2d_stages=S2D)
    x = jnp.asarray(images(seed))

    def loss(params):
        out, mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            disp_scale=0.5, train=True, mutable=["batch_stats"])
        return sum(jnp.mean(jnp.abs(o)) for o in out), (out, mut)

    (_, (out, mut)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    stats = from_jax_variables({"params": variables["params"],
                                "batch_stats": mut["batch_stats"]})
    grads = from_jax_variables({"params": grads,
                                "batch_stats": variables["batch_stats"]})
    return ([np.asarray(o) for o in out],
            {k: v.numpy() for k, v in stats.items()
             if k.endswith(("running_mean", "running_var"))},
            {k: v.numpy() for k, v in grads.items()})


def _port_train(variables, s2d_stages, seed):
    model = _port(variables, s2d_stages)
    outs = model(to_nchw(images(seed)), disp_scale=0.5)
    _loss(outs).backward()
    return ([to_nhwc_numpy(o.detach()) for o in outs], _stats(model),
            {k: p.grad.numpy() for k, p in model.named_parameters()})


@pytest.mark.parametrize("reference", ["direct", "jax_s2d"])
def test_train_forward_statistics_and_gradients(variables, reference):
    got_out, got_stats, got_grads = _port_train(variables, S2D, 1)
    if reference == "direct":
        want_out, want_stats, want_grads = _port_train(variables, (), 1)
    else:
        want_out, want_stats, want_grads = _jax_train(1)
    assert len(got_out) == len(want_out) == 4
    for g, w in zip(got_out, want_out):
        np.testing.assert_allclose(g, w, **FWD)
    assert got_stats.keys() == want_stats.keys()
    for key in want_stats:
        np.testing.assert_allclose(got_stats[key], want_stats[key], **STATS,
                                   err_msg=key)
    for key, w in want_grads.items():
        if key in got_grads:
            np.testing.assert_allclose(got_grads[key], w, **GRADS,
                                       err_msg=key)
    assert set(got_grads) <= set(want_grads)


def test_bf16_train_forward_and_step(variables):
    """bf16: the train-mode forward at batch 8 against the JAX package's
    bf16 s2d model, within twice the JAX model's own distance from its f32
    forward (train-mode BatchNorm magnifies one-ulp differences of the
    convs as much as bf16's rounding: read 0.0156 against JAX's 0.0131);
    one ``Trainer`` step's losses within 1e-3 of the direct bf16 model's
    (relative), its state and gradients f32."""
    x = jnp.asarray(images(2, batch=8))
    want = {}
    for dtype in (jnp.bfloat16, None):
        jmodel = JaxModel.from_config(**CFG, dtype=dtype, s2d_stages=S2D)
        out, _ = jax.jit(lambda v, x: jmodel.apply(
            v, x, disp_scale=jnp.float32(0.5), train=True,
            mutable=["batch_stats"]))(variables, x)
        want[dtype] = [np.asarray(o.astype(jnp.float32)) for o in out]
    noise = max(np.abs(a - b).max()
                for a, b in zip(want[jnp.bfloat16], want[None]))
    model = _port(variables, dtype=torch.bfloat16)
    with torch.no_grad():
        got = model(to_nchw(np.asarray(x)), disp_scale=0.5)
    for g, w in zip(got, want[jnp.bfloat16]):
        assert g.dtype == torch.bfloat16
        assert np.abs(to_nhwc_numpy(g) - w).max() <= 2 * noise

    batch = global_batch(3)
    losses = {}
    for name, s2d in (("s2d", S2D), ("direct", ())):
        trainer = Trainer(_port(variables, s2d, torch.bfloat16), TINY_LOSS,
                          device="cpu")
        losses[name] = trainer.train_step(batch, DISP_SCALE, LR)
        if name == "s2d":
            assert all(t.dtype == torch.float32
                       for t in trainer.model.state_dict().values()
                       if t.is_floating_point())
            assert all(p.grad.dtype == torch.float32
                       for p in trainer.model.parameters())
    for key, w in losses["direct"].items():
        assert abs(losses["s2d"][key].item() - w.item()) <= 1e-3 * abs(
            w.item()), key


@pytest.fixture(scope="module")
def ddp_step(variables):
    """One f32 step of the s2d model on 2 gloo ranks (each rank's
    BatchNorm synced over the global batch) and in one process, and the
    direct model's step in one process, all from the same weights."""
    state = numpy_state(_port(variables, ()))
    batch = global_batch(4)
    build = dict(model_config=dict(CFG, s2d_stages=S2D), model_state=state,
                 loss_config=TINY_LOSS)
    ranks = spawn(ddp_step_job, batch=batch, disp_scale=DISP_SCALE, lr=LR,
                  step_idx=0, **build)
    one = step_result(build_trainer(**build), batch, DISP_SCALE, LR, 0)
    direct = step_result(build_trainer(**dict(build, model_config=CFG)),
                         batch, DISP_SCALE, LR, 0)
    return ranks, one, direct


def test_ddp_step_equals_one_process(ddp_step):
    ranks, one, _ = ddp_step
    check_ranks_agree(ranks, ("grads", "state"))
    for got in ranks:
        check_against_one_process(got, one)


def test_one_process_step_equals_the_direct_step(ddp_step):
    _, one, direct = ddp_step
    for key, w in direct["losses"].items():
        np.testing.assert_allclose(one["losses"][key], w, rtol=1e-5,
                                   err_msg=key)
    for key, w in direct["grads"].items():
        np.testing.assert_allclose(one["grads"][key], w, **GRADS,
                                   err_msg=key)
    for key, w in direct["state"].items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(one["state"][key], w, **STATS,
                                       err_msg=key)


def test_serving_of_an_s2d_trained_model(variables):
    """A model trained with s2d stages serves as the direct model does:
    the same folded parameters bit for bit and the same forward."""
    trainer = Trainer(_port(variables), TINY_LOSS, device="cpu")
    trainer.train_step(global_batch(5), DISP_SCALE, 1e-3)
    s2d = trainer.model.eval()
    direct = _port(variables, ()).eval()
    direct.load_state_dict(s2d.state_dict(), strict=True)
    for dtype in (torch.float32, torch.bfloat16):
        (_, _), want = build_serving_params(direct, dtype, "cpu")
        (_, _), got = build_serving_params(s2d, dtype, "cpu")
        flat_w, flat_g = _leaves(want), _leaves(got)
        assert len(flat_w) == len(flat_g) > 0
        assert all(torch.equal(a, b) for a, b in zip(flat_g, flat_w))
    x = torch.from_numpy(images(6, batch=1))
    assert torch.equal(
        make_serving_forward(s2d, torch.float32, device="cpu")(x),
        make_serving_forward(direct, torch.float32, device="cpu")(x))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    values = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in values for leaf in _leaves(v)]
