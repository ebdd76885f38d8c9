"""The flagship model written plainly from its equations, in float32.

A frozen, independent statement of the randomly-connected depth and
uncertainty network (Tukra & Giannarou; the reference PyTorch repository
``Probabilistic-Surgical-Vision/uncertainty-model``): five encoder stages,
each a DAG of conv-BatchNorm-ELU nodes over a Watts-Strogatz graph followed
by linear attention, and five decoder stages of pixel-shuffle upsampling,
squeeze-excited skips and sigmoid disparity heads.  Parameters are a flat
``{state_dict key: tensor}`` mapping with the reference repository's key
names.  Layout is NCHW; resizes are bilinear with ``align_corners=True``;
reflect padding is ``F.pad``'s.

It imports nothing but torch: no kernel, fold or plain version of the
program under test.  Every product goes through a ``Precision``
(``precision.py``), so the same code computes the controls.

BatchNorm runs on the running statistics (``train=False``: the evaluation
model, whose algebra the program's serving fold must reproduce) or on the
batch's statistics (``train=True``: the training step).  A multi-input
node takes ``sigmoid(mean_weight)`` gates with the reference's indexing:
input ``k >= 1`` takes gate ``k - 1``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from .precision import F32

BN_EPS = 1e-5


class Node(NamedTuple):
    id: int
    is_input: bool
    inputs: tuple[int, ...]


class Graph(NamedTuple):
    nodes: tuple[Node, ...]
    in_nodes: tuple[int, ...]
    out_nodes: tuple[int, ...]


def graph_from_adjacency(adjacency: Sequence[Sequence[int]]) -> Graph:
    """A stage's DAG from ordered neighbour lists: node ``i`` reads its
    lower-index neighbours in list order; it is an input node when all
    its neighbours are higher, an output node when all are lower."""
    nodes, ins, outs = [], [], []
    for i, nbrs in enumerate(adjacency):
        is_input = i < min(nbrs)
        if is_input:
            ins.append(i)
        elif i > max(nbrs):
            outs.append(i)
        nodes.append(Node(i, is_input, tuple(n for n in nbrs if n < i)))
    return Graph(tuple(nodes), tuple(ins), tuple(outs))


# -- the parameters, by key and shape ---------------------------------------


class Param(NamedTuple):
    key: str
    shape: tuple[int, ...]
    kind: str      # conv_w conv_b linear_w bn_w bn_b bn_mean bn_var gate count
    fan_in: int
    fan_out: int


def _conv(prefix, cin, cout, k, out):
    out.append(Param(f"{prefix}.weight", (cout, cin, k, k), "conv_w",
                     cin * k * k, cout * k * k))
    out.append(Param(f"{prefix}.bias", (cout,), "conv_b", cin * k * k, 0))


def _bn(prefix, c, out):
    for name, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                       ("running_mean", "bn_mean"), ("running_var", "bn_var")):
        out.append(Param(f"{prefix}.{name}", (c,), kind, c, c))
    out.append(Param(f"{prefix}.num_batches_tracked", (), "count", 0, 0))


def param_spec(model: dict, graphs: Sequence[Graph]) -> list[Param]:
    """Every tensor of the model's state, in a fixed order."""
    out: list[Param] = []
    for s, (cfg, graph) in enumerate(zip(model["encoder"]["layers"], graphs)):
        cin, c, k = cfg["in_channels"], cfg["out_channels"], cfg["kernel_size"]
        base = f"encoder.layers.{s}.layers"
        for node in graph.nodes:
            nb = f"{base}.0.node_blocks.{node.id}"
            if len(node.inputs) > 1:
                out.append(Param(f"{nb}.mean_weight", (len(node.inputs),),
                                 "gate", 0, 0))
            _conv(f"{nb}.convolution.layers.0", cin if node.is_input else c,
                  c, k, out)
            _bn(f"{nb}.convolution.layers.1", c, out)
        for name in ("keys", "queries", "values", "reprojection"):
            _conv(f"{base}.1.{name}", c, c, 1, out)
    for s, cfg in enumerate(model["decoder"]["layers"]):
        base = f"decoder.layers.{s}"
        up = cfg["upsample_channels"]
        skip_out = cfg["skip_out_channels"]
        _conv(f"{base}.upsample.0.layers.0.layers.0", cfg["in_channels"],
              up * 4, 3, out)
        _bn(f"{base}.upsample.0.layers.1", up * 4, out)
        _conv(f"{base}.squeeze_excite.0.layers.0.layers.0",
              cfg["feature_in_channels"] + cfg["skip_in_channels"], skip_out,
              1, out)
        _bn(f"{base}.squeeze_excite.0.layers.1", skip_out, out)
        reduced = skip_out // 16
        out.append(Param(f"{base}.squeeze_excite.1.excite.0.weight",
                         (reduced, skip_out), "linear_w", skip_out, reduced))
        out.append(Param(f"{base}.squeeze_excite.1.excite.2.weight",
                         (skip_out, reduced), "linear_w", reduced, skip_out))
        disp = cfg.get("disp_channels", 2)
        iconv_in = up + skip_out + (disp if cfg.get("concat_disp", True) else 0)
        _conv(f"{base}.iconv.layers.0.layers.0", iconv_in, cfg["out_channels"],
              3, out)
        _bn(f"{base}.iconv.layers.1", cfg["out_channels"], out)
        if cfg.get("calculate_disp", True):
            _conv(f"{base}.disp.layers.0", cfg["out_channels"], disp, 3, out)
    return out


# -- the forward -------------------------------------------------------------


def resize(x: torch.Tensor, size) -> torch.Tensor:
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


class _Net:
    def __init__(self, p: dict, prec, train: bool, stats=None):
        self.p, self.prec, self.train = p, prec or F32(), train
        self.stats = stats

    def bn(self, prefix, x):
        p = self.p
        if self.stats is not None:
            self.stats[prefix] = (x.mean((0, 2, 3)),
                                  x.var((0, 2, 3), unbiased=False))
        if self.train:
            return F.batch_norm(x, None, None, p[f"{prefix}.weight"],
                                p[f"{prefix}.bias"], True, 0.0, BN_EPS)
        return F.batch_norm(x, p[f"{prefix}.running_mean"],
                            p[f"{prefix}.running_var"], p[f"{prefix}.weight"],
                            p[f"{prefix}.bias"], False, 0.0, BN_EPS)

    def conv(self, prefix, x, stride=1, padding=0):
        return self.prec.conv(x, self.p[f"{prefix}.weight"],
                              self.p[f"{prefix}.bias"], stride, padding)

    def reflect_conv(self, prefix, x):
        return self.conv(prefix, F.pad(x, (1, 1, 1, 1), mode="reflect"))

    # encoder

    def node(self, prefix, node, k, inputs):
        if len(inputs) > 1:
            g = torch.sigmoid(self.p[f"{prefix}.mean_weight"])
            x = g[0] * inputs[0]
            for i, y in enumerate(inputs[1:]):
                if y.shape[2:] != x.shape[2:]:
                    dh, dw = x.shape[2] - y.shape[2], x.shape[3] - y.shape[3]
                    y = F.pad(y, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2),
                              mode="reflect")
                x = x + g[i] * y
        else:
            x = inputs[0]
        c = f"{prefix}.convolution.layers"
        x = self.conv(f"{c}.0", x, 2 if node.is_input else 1, (k - 1) // 2)
        return F.elu(self.bn(f"{c}.1", x))

    def attention(self, prefix, x, heads):
        b, c, h, w = x.shape

        def proj(name):
            y = self.conv(f"{prefix}.{name}", x)
            return y.permute(0, 2, 3, 1).reshape(b, h * w, heads, c // heads)

        keys = torch.softmax(proj("keys"), dim=1)
        queries = torch.softmax(proj("queries"), dim=-1)
        values = proj("values")
        context = self.prec.einsum("bnhk,bnhv->bhkv", keys, values)
        attended = self.prec.einsum("bhkv,bnhk->bnhv", context, queries)
        attended = attended.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.conv(f"{prefix}.reprojection", attended) + x

    def encoder_stage(self, s, cfg, graph, x):
        base = f"encoder.layers.{s}.layers"
        k = cfg["kernel_size"]
        results = {}
        for node in graph.nodes:
            inputs = [x] if node.is_input else [results[i] for i in node.inputs]
            results[node.id] = self.node(f"{base}.0.node_blocks.{node.id}",
                                         node, k, inputs)
        out = results[graph.out_nodes[0]]
        for i in graph.out_nodes[1:]:
            out = out + results[i]
        out = out / len(graph.out_nodes)
        return self.attention(f"{base}.1", out, cfg.get("heads", 8))

    # decoder

    def conv_bn_elu(self, prefix, x, reflect=True):
        conv = self.reflect_conv if reflect else self.conv
        return F.elu(self.bn(f"{prefix}.layers.1",
                             conv(f"{prefix}.layers.0.layers.0", x)))

    def decoder_stage(self, s, cfg, x, fm, skip, disp, disp_scale):
        base = f"decoder.layers.{s}"
        skip = resize(skip, (skip.shape[2] * 2, skip.shape[3] * 2))
        skip = self.conv_bn_elu(f"{base}.squeeze_excite.0",
                                torch.cat([fm, skip], 1), reflect=False)
        squeezed = skip.mean(dim=(2, 3))
        ex = f"{base}.squeeze_excite.1.excite"
        gate = torch.sigmoid(self.prec.linear(
            torch.relu(self.prec.linear(squeezed, self.p[f"{ex}.0.weight"])),
            self.p[f"{ex}.2.weight"]))
        skip = skip * gate[:, :, None, None]
        up = F.pixel_shuffle(self.conv_bn_elu(f"{base}.upsample.0", x), 2)
        parts = [up, skip]
        if cfg.get("concat_disp", True):
            parts.append(resize(disp, (disp.shape[2] * 2, disp.shape[3] * 2)))
        out = self.conv_bn_elu(f"{base}.iconv", torch.cat(parts, 1))
        new_disp = None
        if cfg.get("calculate_disp", True):
            new_disp = disp_scale * torch.sigmoid(
                self.reflect_conv(f"{base}.disp.layers.0", out))
        return out, skip, new_disp


def forward(params: dict, model: dict, graphs: Sequence[Graph],
            image: torch.Tensor, *, train: bool = False, prec=None,
            disp_scale: float = 1.0, stats=None) -> tuple[torch.Tensor, ...]:
    """The (full, 1/2, 1/4, 1/8)-resolution 4-channel maps ``[left disp,
    right disp, left uncertainty, right uncertainty]`` of an NCHW image
    batch, in float32.  ``stats``: a dict that receives each BatchNorm's
    (mean, biased variance) of the batch, by key prefix."""
    net = _Net(params, prec, train, stats)
    x = image.float()
    feats = []
    for s, (cfg, graph) in enumerate(zip(model["encoder"]["layers"], graphs)):
        x = net.encoder_stage(s, cfg, graph, x)
        feats.append(x)
    f1, f2, f3, f4, x4 = feats
    dec = model["decoder"]["layers"]
    out, skip, _ = net.decoder_stage(0, dec[0], x4, f4, x4, None, disp_scale)
    disps = []
    disp = None
    for s, fm in zip(range(1, 5), (f3, f2, f1, image.float())):
        out, skip, disp = net.decoder_stage(s, dec[s], out, fm, skip, disp,
                                            disp_scale)
        disps.append(disp)
    return tuple(reversed(disps))


# -- parameters from a seed --------------------------------------------------


def init_params(spec: Sequence[Param], seed: int, device,
                chunk: int = 1 << 24) -> dict:
    """Every tensor of ``spec`` drawn from ``seed`` on ``device``, in float32
    (``num_batches_tracked`` int64 0): one uniform draw for all of them,
    cut by key and shaped by kind.

    * conv kernels Xavier-uniform, U(+-sqrt(6 / (fan_in + fan_out)));
      conv biases and linear weights U(+-1 / sqrt(fan_in)), the network's
      own initialisers;
    * BatchNorm: weight U(0.75, 1.25), bias U(-0.1, 0.1), running mean
      U(-0.1, 0.1), running variance U(0.5, 2) (statistics a trained
      network would carry, so that folding them matters);
    * node gates' ``mean_weight`` U(-2, 2)."""
    numbers = [p for p in spec if p.kind != "count"]
    total = sum(math.prod(p.shape) for p in numbers)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, device=device, dtype=torch.float32)
    for start in range(0, total, chunk):   # a few large calls
        flat[start:start + chunk].uniform_(0.0, 1.0, generator=g)
    out, i = {}, 0
    for p in spec:
        if p.kind == "count":
            out[p.key] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = math.prod(p.shape)
        u = flat[i:i + n].view(p.shape)
        i += n
        if p.kind == "conv_w":
            lo, hi = _sym(math.sqrt(6.0 / (p.fan_in + p.fan_out)))
        elif p.kind in ("conv_b", "linear_w"):
            lo, hi = _sym(1.0 / math.sqrt(p.fan_in))
        else:
            lo, hi = {"bn_w": (0.75, 1.25), "bn_b": (-0.1, 0.1),
                      "bn_mean": (-0.1, 0.1), "bn_var": (0.5, 2.0),
                      "gate": (-2.0, 2.0)}[p.kind]
        out[p.key] = u * (hi - lo) + lo
    return out


@torch.no_grad()
def calibrate(params: dict, model: dict, graphs, images: torch.Tensor,
              seed: int) -> None:
    """Set every BatchNorm's running statistics, in place, to those of a
    train-mode forward over ``images`` (NCHW), each channel's mean moved
    by U(-0.1, 0.1) standard deviations and its variance scaled by
    U(0.8, 1.25), drawn from ``seed``: statistics of the kind a trained
    network carries, under which the evaluation model passes its input's
    signal on as training does."""
    stats: dict = {}
    forward(params, model, graphs, images, train=True, stats=stats)
    device = images.device
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) + 1) % (1 << 63))
    for prefix, (mean, var) in stats.items():
        u = torch.rand((2, mean.numel()), generator=g, device=device)
        params[f"{prefix}.running_mean"].copy_(
            mean + (0.2 * u[0] - 0.1) * var.sqrt())
        params[f"{prefix}.running_var"].copy_(var * (0.8 + 0.45 * u[1]))


def _sym(b):
    return -b, b
