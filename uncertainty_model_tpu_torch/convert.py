"""JAX variables -> the port's ``state_dict``.

The inverses of the JAX package's ``train/convert.py``
``convert_model_state_dict`` and ``convert_discriminator_state_dict``: each
takes a ``{"params", "batch_stats"}`` tree (numpy or JAX arrays) and
returns the reference-keyed ``state_dict`` that
``RandomlyConnectedModel`` or ``RandomDiscriminator``
``.load_state_dict(strict=True)`` accepts.

Layouts: conv HWIO -> OIHW; Dense (in, out) -> (out, in); BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var.
``num_batches_tracked`` is written as 0: the JAX package keeps no count,
and BatchNorm with a momentum never reads it.

``from_jax_train_state`` converts a whole JAX training state (what the JAX
package's ``train/checkpoint.py::load_checkpoint`` restores from an orbax
directory) into what the port's ``train/checkpoint.py::load_checkpoint``
returns, so that ``Trainer.load_state`` resumes the run.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import RandomDiscriminator, RandomlyConnectedModel
from .train.trainer import adam

_ATTENTION = ("keys", "queries", "values", "reprojection")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _conv(sd, prefix, tree):
    sd[f"{prefix}.weight"] = _tensor(
        np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1)))
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _tensor(tree["bias"])


def _bn(sd, prefix, prm, st):
    sd[f"{prefix}.weight"] = _tensor(prm["scale"])
    sd[f"{prefix}.bias"] = _tensor(prm["bias"])
    sd[f"{prefix}.running_mean"] = _tensor(st["mean"])
    sd[f"{prefix}.running_var"] = _tensor(st["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _encoder_stage(sd, pre, sp, ss):
    """One ``EncoderStage`` under ``pre``: its graph's node blocks
    (``layers.0``) and attention (``layers.1``)."""
    for j in range(len(sp["graph"])):
        node_p = sp["graph"][f"node_{j}"]
        node_s = ss["graph"][f"node_{j}"]
        tp = f"{pre}.layers.0.node_blocks.{j}"
        if "mean_weight" in node_p:
            sd[f"{tp}.mean_weight"] = _tensor(node_p["mean_weight"])
        _conv(sd, f"{tp}.convolution.layers.0", node_p["conv_block"]["conv"])
        _bn(sd, f"{tp}.convolution.layers.1", node_p["conv_block"]["bn"],
            node_s["conv_block"]["bn"])
    for name in _ATTENTION:
        _conv(sd, f"{pre}.layers.1.{name}", sp["attention"][name])


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    for i in range(len(params["encoder"])):
        _encoder_stage(sd, f"encoder.layers.{i}",
                       params["encoder"][f"stage_{i}"],
                       stats["encoder"][f"stage_{i}"])

    for i in range(len(params["decoder"])):
        sp = params["decoder"][f"stage_{i}"]
        ss = stats["decoder"][f"stage_{i}"]
        pre = f"decoder.layers.{i}"
        for name, prefix in (("upsample_conv", f"{pre}.upsample.0"),
                             ("se_conv", f"{pre}.squeeze_excite.0"),
                             ("iconv", f"{pre}.iconv")):
            _conv(sd, f"{prefix}.layers.0.layers.0",
                  sp[name]["conv_layer"]["conv"])
            if "bn" in sp[name]:
                _bn(sd, f"{prefix}.layers.1", sp[name]["bn"], ss[name]["bn"])
        se, excite = sp["se"], f"{pre}.squeeze_excite.1.excite"
        if "fc1" in se:
            sd[f"{excite}.0.weight"] = _tensor(np.asarray(se["fc1"]["kernel"]).T)
            sd[f"{excite}.2.weight"] = _tensor(np.asarray(se["fc2"]["kernel"]).T)
        else:
            _conv(sd, f"{excite}.0", se["conv1"])
            _conv(sd, f"{excite}.2", se["conv2"])
        if "disp" in sp:
            _conv(sd, f"{pre}.disp.layers.0", sp["disp"]["conv"])
    return sd


def from_jax_discriminator_variables(variables, final_feature_hw
                                     ) -> dict[str, torch.Tensor]:
    """The discriminator's ``state_dict`` from its JAX variables.
    ``final_feature_hw``: the (H, W) of the final conv's output, which the
    head flattens ((8, 16) at 256x512).  The JAX head flattens NHWC, the
    port and the reference NCHW, so the kernel's rows go back to (C, H, W)
    order."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    n_layers = sum(k.startswith("stage_") for k in params)
    for i in range(n_layers):
        _encoder_stage(sd, f"layers.{i}", params[f"stage_{i}"],
                       stats[f"stage_{i}"])
    _encoder_stage(sd, "conv", params["final_conv"], stats["final_conv"])
    h, w = final_feature_hw
    kernel = np.asarray(params["linear"]["kernel"]).T  # (1, H*W*C), NHWC
    weight = kernel.reshape(kernel.shape[0], h, w, -1).transpose(0, 3, 1, 2)
    sd["linear.weight"] = _tensor(weight.reshape(kernel.shape[0], -1))
    sd["linear.bias"] = _tensor(params["linear"]["bias"])
    return sd


def discriminator_final_hw(disc_config, image_hw) -> tuple[int, int]:
    """The (H, W) of the final conv's output that the discriminator's head
    flattens, at input size ``image_hw``: each of its stages (``layers``
    and ``final_conv``) halves the map, SAME stride 2 ((8, 16) at
    256x512)."""
    h, w = image_hw
    for _ in range(len(disc_config["layers"]) + 1):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


def _adam_state_dict(module, to_state_dict, opt_state) -> dict:
    """The ``state_dict`` of ``module``'s Adam (the ``Trainer``'s) holding
    optax ``scale_by_adam``'s state ``{"count", "mu", "nu"}``.

    ``to_state_dict`` maps a tree shaped as the parameters to the port's
    keys.  The mapping only moves elements (transposes, the head's row
    order), so Adam's elementwise moments go through it as the parameters
    do.  The state is filled by parameter name: torch keys it by the
    parameter's position, which a zip over tree leaves would permute.
    ``count`` steps taken is torch's ``step``, a CPU f32 tensor; the
    moments take the parameter's memory format, as a run's own do."""
    optimizer = adam(module)
    mu, nu = to_state_dict(opt_state["mu"]), to_state_dict(opt_state["nu"])
    step = float(np.asarray(opt_state["count"]))
    for name, p in module.named_parameters():
        moments = {}
        for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
            if name not in tree or tree[name].shape != p.shape:
                raise ValueError(
                    f"{key} of {name}: "
                    + (f"shape {tuple(tree[name].shape)}, the parameter's "
                       f"{tuple(p.shape)}" if name in tree else "missing"))
            moments[key] = torch.empty_like(p).copy_(tree[name])
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32), **moments}
    return optimizer.state_dict()


def _loaded(module, state_dict):
    module.load_state_dict(state_dict, strict=True)
    return module.to(memory_format=torch.channels_last)


def from_jax_train_state(restored, model_config, disc_config=None,
                         image_hw=(256, 512)) -> tuple:
    """A JAX training state (the dict of numpy arrays that the JAX
    package's ``load_checkpoint`` restores: ``params``, ``batch_stats``,
    ``opt_state`` and, but in a ``final`` checkpoint, ``epoch``; with a
    discriminator ``disc_params``, ``disc_batch_stats``,
    ``disc_opt_state``) -> what the port's ``load_checkpoint`` returns for
    its own directory: ``(state_dict, train_state)``, and with
    ``disc_config`` ``(state_dict, train_state, disc_state_dict)``.

    ``train_state`` is ``{"optimizer": <the model's Adam state_dict>,
    "epoch": <int, or None for final>}`` (and ``"disc_optimizer"``), on a
    model built from ``model_config`` (a config's ``model`` section) with
    the ``Trainer``'s optimizer, so its ``param_groups`` are a fresh
    trainer's.  ``image_hw``: the training image size, which fixes the
    discriminator's final map (its head's rows go from NHWC to NCHW
    order); a size whose map does not match the head's kernel raises.
    The lagged clone is in neither package's checkpoints: the trainer
    starts it as a copy of the discriminator."""
    stats = restored["batch_stats"]
    state_dict = from_jax_variables(restored)
    model = _loaded(RandomlyConnectedModel(**model_config), state_dict)
    epoch = restored.get("epoch")
    train_state = {
        "optimizer": _adam_state_dict(
            model, lambda tree: from_jax_variables(
                {"params": tree, "batch_stats": stats}),
            restored["opt_state"]),
        "epoch": None if epoch is None else int(epoch)}
    if disc_config is None:
        return state_dict, train_state
    if "disc_params" not in restored:
        raise ValueError("the JAX state holds no discriminator")
    hw = discriminator_final_hw(disc_config, image_hw)
    rows = np.shape(restored["disc_params"]["linear"]["kernel"])[0]
    channels = disc_config["final_conv"]["out_channels"]
    if hw[0] * hw[1] * channels != rows:
        raise ValueError(
            f"image size {tuple(image_hw)} gives the discriminator a "
            f"{hw[0]}x{hw[1]}x{channels} final map, but its head's kernel "
            f"has {rows} rows: give the size it was trained at")
    disc_stats = restored["disc_batch_stats"]
    disc_state_dict = from_jax_discriminator_variables(
        {"params": restored["disc_params"], "batch_stats": disc_stats}, hw)
    disc = _loaded(RandomDiscriminator(**disc_config), disc_state_dict)
    train_state["disc_optimizer"] = _adam_state_dict(
        disc, lambda tree: from_jax_discriminator_variables(
            {"params": tree, "batch_stats": disc_stats}, hw),
        restored["disc_opt_state"])
    return state_dict, train_state, disc_state_dict
