"""Shared set-up of the PyTorch port's tests: one tiny model (and one tiny
discriminator) with real BatchNorm statistics, in the port and in the JAX
package with the same weights.

The weights are drawn by the port from a seed, the gate weights from a
numpy seed, and the BatchNorm running statistics come from a few
train-mode forwards; the JAX package's own converter
(``train/convert.py::convert_model_state_dict``) turns them into JAX
variables, and the port's model under test is loaded back from those
variables (``convert.from_jax_variables``).  Inputs are made with numpy and
shared as numpy arrays.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tiny_config import TINY_DISCRIMINATOR, TINY_INPUT, TINY_MODEL

from uncertainty_model_tpu.models import RandomDiscriminator as JaxDisc
from uncertainty_model_tpu.models import RandomlyConnectedModel as JaxModel
from uncertainty_model_tpu.train.convert import (
    convert_discriminator_state_dict, convert_model_state_dict)
from uncertainty_model_tpu_torch.convert import (
    from_jax_discriminator_variables, from_jax_variables)
from uncertainty_model_tpu_torch.models import (
    RandomDiscriminator, RandomlyConnectedModel)

# the tiny config with the flagship's kernel sizes in the first two stages,
# and fused decoder stages whose upsample width is not 4 (with 4 channels
# and 4 phases, a transposed phase-major permutation equals the right one)
PORT_MODEL = {
    "encoder": {
        **TINY_MODEL["encoder"],
        "layers": [
            {"in_channels": 3, "out_channels": 8, "kernel_size": 7, "heads": 2},
            {"in_channels": 8, "out_channels": 8, "kernel_size": 5, "heads": 2},
            *TINY_MODEL["encoder"]["layers"][2:],
        ],
    },
    "decoder": {"layers": [
        *TINY_MODEL["decoder"]["layers"][:2],
        dict(TINY_MODEL["decoder"]["layers"][2], upsample_channels=8),
        dict(TINY_MODEL["decoder"]["layers"][3], upsample_channels=2),
        TINY_MODEL["decoder"]["layers"][4],
    ]},
}

# the decoder's SE layers as 1x1 convs with bias (fc=False)
CONV_SE_MODEL = {
    "encoder": TINY_MODEL["encoder"],
    "decoder": {"layers": [dict(d, fc=False)
                           for d in TINY_MODEL["decoder"]["layers"]]},
}

# tests/test_s2d_training.py's config: the tiny config with the flagship's
# kernel sizes (7, 5) in the first two stages, which training may run on
# the space-to-depth grid
S2D_TRAINING_MODEL = {"encoder": PORT_MODEL["encoder"],
                      "decoder": TINY_MODEL["decoder"]}

CONFIGS = {"fc": PORT_MODEL, "conv_se": CONV_SE_MODEL,
           "s2d_training": S2D_TRAINING_MODEL}

torch.set_num_threads(2)


def images(seed, batch=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(batch, *TINY_INPUT, 3)).astype(np.float32)


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def to_nhwc_numpy(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).float().numpy()


def port_model(cfg, variables, dtype=None, s2d_stages=()):
    """The port's eval model on the CPU, loaded from JAX variables, with
    compute type ``dtype`` (and the encoder's ``s2d_stages``)."""
    model = RandomlyConnectedModel(**cfg, dtype=dtype, s2d_stages=s2d_stages)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.to(memory_format=torch.channels_last).eval()


@functools.lru_cache(maxsize=None)
def models(name, seed=0, train_applies=3):
    """(JAX model, JAX variables, port eval model) of ``CONFIGS[name]``."""
    cfg = CONFIGS[name]
    trained = RandomlyConnectedModel.from_config(**cfg, seed=seed,
                                                 device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, p in trained.named_parameters():
            if key.endswith("mean_weight"):
                p.copy_(torch.from_numpy(
                    rng.normal(size=p.shape).astype(np.float32)))
        trained.train()
        for i in range(train_applies):
            trained(to_nchw(images(seed + i + 1)))
    sd = {k: v.numpy() for k, v in trained.state_dict().items()}
    variables = convert_model_state_dict(sd, cfg["decoder"]["layers"])
    return JaxModel.from_config(**cfg), variables, port_model(cfg, variables)


def jax_eval(jmodel, variables, x, disp_scale):
    """``model.apply(train=False)``, all four scales, as numpy."""
    fwd = jax.jit(lambda v, x: jmodel.apply(v, x, disp_scale=disp_scale))
    return [np.asarray(d) for d in fwd(variables, jnp.asarray(x))]


# the tiny discriminator's final conv output at 32x64: 5 stride-2 stages
DISC_FEATURE_HW = (TINY_INPUT[0] // 32, TINY_INPUT[1] // 32)


def pyramid(seed, batch=2, channels=6):
    """A numpy NHWC pyramid of the tiny input size, 4 scales."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(batch, TINY_INPUT[0] >> i, TINY_INPUT[1] >> i,
                              channels)).astype(np.float32)
            for i in range(4)]


def port_disc(variables, dtype=None):
    """The port's discriminator on the CPU in train mode, loaded from JAX
    variables, with compute type ``dtype``."""
    disc = RandomDiscriminator(**TINY_DISCRIMINATOR, dtype=dtype)
    disc.load_state_dict(from_jax_discriminator_variables(
        variables, DISC_FEATURE_HW), strict=True)
    return disc.to(memory_format=torch.channels_last).train()


@functools.lru_cache(maxsize=None)
def discriminators(seed=0, train_applies=2):
    """(JAX discriminator, its JAX variables) of ``TINY_DISCRIMINATOR``:
    the port's initialisation from ``seed``, gate weights from a numpy
    seed, BatchNorm statistics from a few train-mode forwards; the port's
    is ``port_disc(variables)``."""
    disc = RandomDiscriminator.from_config(**TINY_DISCRIMINATOR,
                                           init_seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        for key, p in disc.named_parameters():
            if key.endswith("mean_weight"):
                p.copy_(torch.from_numpy(
                    rng.normal(size=p.shape).astype(np.float32)))
        disc.train()
        for i in range(train_applies):
            disc([torch.from_numpy(a) for a in pyramid(seed + 200 + i)])
    sd = {k: v.numpy() for k, v in disc.state_dict().items()}
    variables = convert_discriminator_state_dict(
        sd, final_feature_hw=DISC_FEATURE_HW)
    return JaxDisc.from_config(**TINY_DISCRIMINATOR), variables


def jax_disc_apply(jdisc, variables, method=None):
    """The JAX discriminator in train mode as the JAX trainer applies it
    (``_apply_disc``), its BatchNorm updates dropped."""
    def apply(pyr):
        out, _ = jdisc.apply(variables, pyr, train=True,
                             mutable=["batch_stats"], method=method)
        return out
    return apply
