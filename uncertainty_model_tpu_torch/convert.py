"""JAX variables -> the port's ``state_dict``.

The inverse of the JAX package's ``train/convert.py::convert_model_state_dict``
for the model: it takes the ``{"params", "batch_stats"}`` tree (numpy or
JAX arrays) and returns the reference-keyed ``state_dict`` that
``RandomlyConnectedModel.load_state_dict(strict=True)`` accepts.

Layouts: conv HWIO -> OIHW; Dense (in, out) -> (out, in); BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import numpy as np
import torch

_ATTENTION = ("keys", "queries", "values", "reprojection")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def from_jax_variables(variables) -> dict[str, torch.Tensor]:
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def conv(prefix, tree):
        sd[f"{prefix}.weight"] = _tensor(
            np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1)))
        if "bias" in tree:
            sd[f"{prefix}.bias"] = _tensor(tree["bias"])

    def bn(prefix, prm, st):
        sd[f"{prefix}.weight"] = _tensor(prm["scale"])
        sd[f"{prefix}.bias"] = _tensor(prm["bias"])
        sd[f"{prefix}.running_mean"] = _tensor(st["mean"])
        sd[f"{prefix}.running_var"] = _tensor(st["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    for i in range(len(params["encoder"])):
        sp = params["encoder"][f"stage_{i}"]
        ss = stats["encoder"][f"stage_{i}"]
        pre = f"encoder.layers.{i}"
        for j in range(len(sp["graph"])):
            node_p = sp["graph"][f"node_{j}"]
            node_s = ss["graph"][f"node_{j}"]
            tp = f"{pre}.layers.0.node_blocks.{j}"
            if "mean_weight" in node_p:
                sd[f"{tp}.mean_weight"] = _tensor(node_p["mean_weight"])
            conv(f"{tp}.convolution.layers.0", node_p["conv_block"]["conv"])
            bn(f"{tp}.convolution.layers.1", node_p["conv_block"]["bn"],
               node_s["conv_block"]["bn"])
        for name in _ATTENTION:
            conv(f"{pre}.layers.1.{name}", sp["attention"][name])

    for i in range(len(params["decoder"])):
        sp = params["decoder"][f"stage_{i}"]
        ss = stats["decoder"][f"stage_{i}"]
        pre = f"decoder.layers.{i}"
        for name, prefix in (("upsample_conv", f"{pre}.upsample.0"),
                             ("se_conv", f"{pre}.squeeze_excite.0"),
                             ("iconv", f"{pre}.iconv")):
            conv(f"{prefix}.layers.0.layers.0", sp[name]["conv_layer"]["conv"])
            if "bn" in sp[name]:
                bn(f"{prefix}.layers.1", sp[name]["bn"], ss[name]["bn"])
        se, excite = sp["se"], f"{pre}.squeeze_excite.1.excite"
        if "fc1" in se:
            sd[f"{excite}.0.weight"] = _tensor(np.asarray(se["fc1"]["kernel"]).T)
            sd[f"{excite}.2.weight"] = _tensor(np.asarray(se["fc2"]["kernel"]).T)
        else:
            conv(f"{excite}.0", se["conv1"])
            conv(f"{excite}.2", se["conv2"])
        if "disp" in sp:
            conv(f"{pre}.disp.layers.0", sp["disp"]["conv"])
    return sd
