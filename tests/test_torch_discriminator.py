"""The port's discriminator (``models/discriminator.py``) against the JAX
package's ``RandomDiscriminator`` on ``TINY_DISCRIMINATOR`` (32x64, batch
2) from the same converted weights and numpy-seeded pyramids: the
converter's round trip (exact), the stage maps and the predictions in
train and eval mode (f32 within 1e-5), the running statistics a
train-mode forward leaves, the bf16 forward, the head's flatten order with
a planted weight, and the initialisation's seed."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tiny_config import TINY_DISCRIMINATOR
from torch_port_helpers import (
    DISC_FEATURE_HW, discriminators, port_disc, pyramid)

from uncertainty_model_tpu.models import RandomDiscriminator as JaxDisc
from uncertainty_model_tpu.train.convert import (
    convert_discriminator_state_dict)

from uncertainty_model_tpu_torch.config import FLAGSHIP_DISCRIMINATOR
from uncertainty_model_tpu_torch.convert import (
    from_jax_discriminator_variables)
from uncertainty_model_tpu_torch.models import RandomDiscriminator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    return discriminators()


def _jax_apply(jdisc, method=None, train=False, dtype=None, jit=True):
    """``(output, mutated)`` of the JAX discriminator (``dtype``: a bf16
    one), jitted unless asked: op by op, XLA rounds every bf16 operation,
    while a jitted bf16 forward keeps some intermediates in f32."""
    disc = jdisc if dtype is None else JaxDisc.from_config(
        **TINY_DISCRIMINATOR, dtype=dtype)

    def apply(variables, pyr):
        if not train:
            return disc.apply(variables, pyr, method=method), None
        return disc.apply(variables, pyr, train=True, method=method,
                          mutable=["batch_stats"])
    return jax.jit(apply) if jit else apply


def _torch_pyramid(pyr):
    return [torch.from_numpy(a) for a in pyr]


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_converter_round_trip_is_exact(setup):
    """JAX variables -> the port -> the JAX package's
    ``convert_discriminator_state_dict`` gives the same variables bit for
    bit, and the port's ``state_dict`` survives the other way round (the
    BatchNorm step counts, which JAX does not keep, come back 0)."""
    _, variables = setup
    sd = from_jax_discriminator_variables(variables, DISC_FEATURE_HW)
    back = convert_discriminator_state_dict(
        {k: v.numpy() for k, v in sd.items()},
        final_feature_hw=DISC_FEATURE_HW)
    want, got = _flat(variables), _flat(back)
    assert want.keys() == got.keys() and len(want) > 100
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    disc = RandomDiscriminator.from_config(**TINY_DISCRIMINATOR, init_seed=3,
                                           device="cpu")
    own = disc.state_dict()
    again = from_jax_discriminator_variables(convert_discriminator_state_dict(
        {k: v.numpy() for k, v in own.items()},
        final_feature_hw=DISC_FEATURE_HW), DISC_FEATURE_HW)
    assert again.keys() == own.keys()
    for key, value in own.items():
        if key.endswith("num_batches_tracked"):
            assert again[key].item() == 0
        else:
            assert torch.equal(again[key], value), key


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_features_and_forward_match_jax(setup, train):
    """The four stage maps and the predictions within 1e-5; in train mode
    also the running statistics one forward leaves (the JAX package's
    mutated ``batch_stats``)."""
    jdisc, variables = setup
    pyr = pyramid(11)
    disc = port_disc(variables).train(train)
    with torch.no_grad():
        feats = disc.features(_torch_pyramid(pyr))
    want_feats, _ = _jax_apply(jdisc, "features", train)(variables, pyr)
    assert len(feats) == len(want_feats) == 4
    for f, w in zip(feats, want_feats):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), **F32_TOL)

    disc = port_disc(variables).train(train)
    with torch.no_grad():
        out = disc(_torch_pyramid(pyr))
    want, mutated = _jax_apply(jdisc, train=train)(variables, pyr)
    assert out.shape == (2, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)
    if train:
        tree = convert_discriminator_state_dict(
            {k: v.numpy() for k, v in disc.state_dict().items()},
            final_feature_hw=DISC_FEATURE_HW)["batch_stats"]
        ours, ref = _flat(tree), _flat(mutated["batch_stats"])
        assert ours.keys() == ref.keys()
        for key in ours:
            np.testing.assert_allclose(ours[key], ref[key], **F32_TOL,
                                       err_msg=key)


def test_bf16_forward_matches_jax(setup):
    """``dtype=torch.bfloat16`` against the JAX package's
    ``dtype=jnp.bfloat16`` (its ``test_bf16_discriminator``) op by op,
    bf16 out.  Eval mode: the four stage maps and the predictions bit for
    bit (read: equal), which pins the rounding points (the pyramid's cast, the head's
    rounded product and bf16 bias, the three-rounding sigmoid).  Train
    mode: BatchNorm on the batch's statistics of the deep maps (n = 64 and
    16 at stages 2-3, 4 at the final conv) magnifies the one-ulp
    differences of the f32 statistics' sums as much as bf16's own
    rounding, so each stage map is held within twice JAX's own
    bf16-vs-f32 distance of that map (read: 0.24-1.05 of it) and the
    predictions within 2^-5 (read: 2^-6; JAX's bf16 against its f32
    predictions: up to 0.036 over three seeds)."""
    jdisc, variables = setup
    pyr = pyramid(12)
    for train in (False, True):
        disc = port_disc(variables, torch.bfloat16).train(train)
        with torch.no_grad():
            feats = disc.features(_torch_pyramid(pyr))
            out = disc(_torch_pyramid(pyr))
        want_feats, _ = _jax_apply(jdisc, "features", train, jnp.bfloat16,
                                   jit=False)(variables, pyr)
        want, _ = _jax_apply(jdisc, train=train, dtype=jnp.bfloat16,
                             jit=False)(variables, pyr)
        f32_feats, _ = _jax_apply(jdisc, "features", train)(variables, pyr)
        assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert all(f.dtype == torch.bfloat16 for f in feats)
        pairs = [(f.permute(0, 2, 3, 1).float().numpy(),
                  np.asarray(w, np.float32), np.asarray(r))
                 for f, w, r in zip(feats, want_feats, f32_feats)]
        got, want = out.float().numpy(), np.asarray(want, np.float32)
        if not train:
            for g, w, _ in pairs:
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(got, want)
            continue
        for i, (g, w, r) in enumerate(pairs):
            assert np.abs(g - w).max() <= 2 * np.abs(r - w).max(), i
        assert np.abs(got - want).max() <= 2.0 ** -5


def test_head_flattens_in_nchw_order(setup):
    """One weight planted at (c, h, w) of the head's input, every other
    weight and the bias 0: the port's logit is that weight times the final
    conv's map at (c, h, w), and the JAX package, given the weights by its
    converter, computes the same logit."""
    jdisc, variables = setup
    disc = port_disc(variables).eval()
    c, h, w = 5, 0, 1
    _, fh, fw = 16, *DISC_FEATURE_HW
    with torch.no_grad():
        disc.linear.weight.zero_()
        disc.linear.bias.zero_()
        disc.linear.weight[0, (c * fh + h) * fw + w] = 0.75
    pyr = pyramid(13)
    with torch.no_grad():
        final = disc.conv(disc.features(_torch_pyramid(pyr))[-1])
        logit = disc.linear(final.reshape(len(final), -1))[:, 0].double()
        out = disc(_torch_pyramid(pyr))
    planted_value = final[:, c, h, w].double()
    np.testing.assert_allclose(logit.numpy(), 0.75 * planted_value.numpy(),
                               rtol=1e-6)
    # every other entry of the map is at least 1% away from the planted
    # one, so a logit from another position could not pass the limits
    others = final.reshape(len(final), -1).double().clone()
    others[:, (c * fh + h) * fw + w] = np.inf
    gap = (others - planted_value[:, None]).abs().min(1).values
    assert (gap > 1e-2 * planted_value.abs()).all()

    planted = convert_discriminator_state_dict(
        {k: v.numpy() for k, v in disc.state_dict().items()},
        final_feature_hw=DISC_FEATURE_HW)
    want, _ = _jax_apply(jdisc)(planted, pyr)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **F32_TOL)
    want = np.asarray(want, np.float64)[:, 0]
    np.testing.assert_allclose(np.log(want / (1 - want)), logit.numpy(),
                               rtol=1e-3)


def test_from_config_is_set_by_its_seed_alone():
    """The same ``init_seed`` gives the same weights whatever the global
    generator's state (the head's bias included), another seed others."""
    torch.manual_seed(1)
    a = RandomDiscriminator.from_config(**TINY_DISCRIMINATOR, init_seed=7,
                                        device="cpu").state_dict()
    torch.manual_seed(2)
    torch.rand(5)
    b = RandomDiscriminator.from_config(**TINY_DISCRIMINATOR, init_seed=7,
                                        device="cpu").state_dict()
    c = RandomDiscriminator.from_config(**TINY_DISCRIMINATOR, init_seed=8,
                                        device="cpu").state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["linear.bias"], c["linear.bias"])
    bound = 1 / np.sqrt(TINY_DISCRIMINATOR["linear_in_features"])
    assert a["linear.bias"].abs().max() <= bound
    assert a["layers.0.layers.0.node_blocks.0.convolution.layers.0.weight"] \
        .is_contiguous(memory_format=torch.channels_last)


def test_flagship_discriminator_equals_yml_and_jax():
    """``FLAGSHIP_DISCRIMINATOR`` is ``configs/uncertainty.yml``'s section,
    and the port's module has the JAX package's 7,625,230 parameters
    (``jax.eval_shape`` of its init at 256x512), under the reference's
    keys."""
    with open(os.path.join(REPO, "configs", "uncertainty.yml")) as f:
        assert FLAGSHIP_DISCRIMINATOR == yaml.safe_load(f)["discriminator"]
    pyr = [jax.ShapeDtypeStruct((1, 256 >> i, 512 >> i, 6), jnp.float32)
           for i in range(4)]
    shapes = jax.eval_shape(JaxDisc.from_config(**FLAGSHIP_DISCRIMINATOR).init,
                            jax.random.PRNGKey(0), pyr)["params"]
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    disc = RandomDiscriminator(**FLAGSHIP_DISCRIMINATOR)
    assert n == sum(p.numel() for p in disc.parameters()) == 7_625_230
    assert disc.linear.weight.shape == (1, 256 * 8 * 16)
