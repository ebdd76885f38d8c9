"""JAX variables -> the port's ``state_dict``.

The inverses of the JAX package's ``train/convert.py``
``convert_model_state_dict`` and ``convert_discriminator_state_dict``: each
takes a ``{"params", "batch_stats"}`` tree (numpy or JAX arrays) and
returns the reference-keyed ``state_dict`` that
``RandomlyConnectedModel`` or ``RandomDiscriminator``
``.load_state_dict(strict=True)`` accepts.

Layouts: conv HWIO -> OIHW; Dense (in, out) -> (out, in); BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import numpy as np
import torch

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
