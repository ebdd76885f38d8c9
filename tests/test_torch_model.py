"""The port's eval model and weight conversion against the JAX package:
the same weights (JAX variables with real BatchNorm statistics) and the same
numpy inputs through ``model.apply(train=False)`` and the port's modules."""

import numpy as np
import pytest
import torch

import jax

from torch_port_helpers import (
    CONFIGS, images, jax_eval, models as build_models, to_nchw, to_nhwc_numpy)

from uncertainty_model_tpu.train.convert import convert_model_state_dict

from uncertainty_model_tpu_torch.config import FLAGSHIP_MODEL
from uncertainty_model_tpu_torch.convert import from_jax_variables
from uncertainty_model_tpu_torch.models import RandomlyConnectedModel


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    return (CONFIGS[request.param], *build_models(request.param))


def test_from_jax_variables_round_trips(models):
    """JAX variables -> port state_dict -> the JAX package's own converter
    gives back the original tree exactly, and that tree has every variable
    of the JAX model, in its shape."""
    cfg, jmodel, variables, _ = models
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), images(0))
    assert (jax.tree.structure(shapes) == jax.tree.structure(variables))
    for a, b in zip(jax.tree.leaves(shapes), jax.tree.leaves(variables)):
        assert a.shape == b.shape
    sd = {k: v.numpy() for k, v in from_jax_variables(variables).items()}
    back = convert_model_state_dict(sd, cfg["decoder"]["layers"])
    want = jax.tree_util.tree_flatten_with_path(variables)
    got = jax.tree_util.tree_flatten_with_path(back)
    assert [p for p, _ in got[0]] == [p for p, _ in want[0]]
    for (path, a), (_, b) in zip(got[0], want[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_state_dict_keys_are_the_references(models):
    """Every key the port's model has comes from the converted tree (the
    fixture's load_state_dict is strict) and follows the reference names."""
    _, _, variables, model = models
    keys = set(model.state_dict())
    assert keys == set(from_jax_variables(variables))
    assert ("encoder.layers.0.layers.0.node_blocks.0.convolution.layers.0"
            ".weight") in keys
    assert "decoder.layers.4.squeeze_excite.1.excite.0.weight" in keys
    assert "decoder.layers.4.disp.layers.0.bias" in keys


def test_eval_model_matches_jax_apply(models):
    """All four disparity scales, f32."""
    _, jmodel, variables, model = models
    x = images(42)
    want = jax_eval(jmodel, variables, x, 0.7)
    with torch.no_grad():
        got = model(to_nchw(x), disp_scale=0.7)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_nhwc_numpy(g), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


def test_flagship_parameter_count():
    """The flagship config builds the reference's 22.5M-parameter model."""
    model = RandomlyConnectedModel(**FLAGSHIP_MODEL)
    n = sum(p.numel() for p in model.parameters())
    assert 22.4e6 < n < 22.6e6, n


def test_init_is_seeded():
    from tiny_config import TINY_MODEL
    a = RandomlyConnectedModel.from_config(**TINY_MODEL, seed=3, device="cpu")
    b = RandomlyConnectedModel.from_config(**TINY_MODEL, seed=3, device="cpu")
    c = RandomlyConnectedModel.from_config(**TINY_MODEL, seed=4, device="cpu")
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    w = "decoder.layers.0.iconv.layers.0.layers.0.weight"
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
