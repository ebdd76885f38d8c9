"""Layer zoo of the eval model (the port of the JAX package's
``models/layers.py``).

Modules take logical NCHW tensors (``torch.channels_last`` memory in the
port); the NHWC ops of ``..ops`` see the free ``permute(0, 2, 3, 1)`` view.
Module and parameter names follow the reference PyTorch ``state_dict``
(documented by the JAX package's ``train/convert.py``), so reference
checkpoints load as they are.  Only eval-mode semantics are pinned against
the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import reflect_pad2d, resize_bilinear
from .graph import GraphSpec, Node

BN_EPS = 1e-5


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def reflect_conv(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Reflect(1)-padded 3x3 conv, with numpy's reflect rule (see
    ``ops/pad.py``: ``padding_mode="reflect"`` refuses 1-pixel maps)."""
    return F.conv2d(nchw(reflect_pad2d(nhwc(x), (1, 1, 1, 1))), weight, bias)


def softmax_f32(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax with the max subtracted and the sum taken in f32, returned
    in ``v``'s type."""
    return torch.softmax(v, dim, dtype=torch.float32).to(v.dtype)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers, drawn from ``generator``: Xavier-
    uniform conv kernels with U(+-1/sqrt(fan_in)) biases, U(+-1/sqrt(fan_in))
    linear weights (torch's defaults for the SE layers); BatchNorm and the
    gate weights keep their constructors' values."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    b = 1.0 / math.sqrt(fan_in)
                    m.bias.uniform_(-b, b, generator=generator)
        elif isinstance(m, nn.Linear):
            b = 1.0 / math.sqrt(m.in_features)
            with torch.no_grad():
                m.weight.uniform_(-b, b, generator=generator)


# ---------------------------------------------------------------------------
# Encoder blocks
# ---------------------------------------------------------------------------


class ConvBNELU(nn.Module):
    """Zero-pad conv -> BatchNorm -> ELU (reference model/layers/
    encoder.py:21-52, ``ConvELUBlock``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                      padding=(kernel_size - 1) // 2),
            nn.BatchNorm2d(out_channels, eps=BN_EPS, momentum=0.1),
            nn.ELU(),
        )

    def forward(self, x):
        return self.layers(x)


def _resize_reflect(x, target_h, target_w):
    """Reflect-pad spatial alignment (reference model/layers/
    encoder.py:92-113)."""
    dh = target_h - x.shape[2]
    dw = target_w - x.shape[3]
    return nchw(reflect_pad2d(
        nhwc(x), (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2)))


class NodeBlock(nn.Module):
    """Per-DAG-node conv block (reference model/layers/encoder.py:55-127).

    Input nodes downsample with a stride-2 conv; the others keep the
    resolution.  Multi-input nodes blend their inputs with sigmoid gates,
    with the reference's indexing quirk (encoder.py:117-123): input k >= 1
    takes gate k - 1, so ``mean_weight[0]`` gates both the first and the
    second input and the last weight is never used.
    """

    def __init__(self, node: Node, in_channels: int, out_channels: int,
                 kernel_size: int):
        super().__init__()
        self.n_inputs = len(node.inputs)
        if self.n_inputs > 1:
            self.mean_weight = nn.Parameter(torch.ones(self.n_inputs))
        is_input = node.node_type == "input"
        self.convolution = ConvBNELU(
            in_channels if is_input else out_channels, out_channels,
            kernel_size, stride=2 if is_input else 1)

    def forward(self, *inputs):
        if self.n_inputs > 1:
            gates = torch.sigmoid(self.mean_weight).to(inputs[0].dtype)
            out = gates[0] * inputs[0]
            for i, x in enumerate(inputs[1:]):
                if x.shape[2] != out.shape[2]:
                    x = _resize_reflect(x, out.shape[2], out.shape[3])
                out = out + gates[i] * x
        else:
            out = inputs[0]
        return self.convolution(out)


class GraphBlock(nn.Module):
    """Runs the DAG of NodeBlocks (reference model/layers/encoder.py:130-198)."""

    def __init__(self, graph: GraphSpec, in_channels: int, out_channels: int,
                 kernel_size: int):
        super().__init__()
        self.graph = graph
        self.node_blocks = nn.ModuleList(
            NodeBlock(node, in_channels, out_channels, kernel_size)
            for node in graph.nodes)

    def forward(self, x):
        results = {i: self.node_blocks[i](x) for i in self.graph.in_nodes}
        for node in self.graph.nodes:
            if node.id not in results:
                results[node.id] = self.node_blocks[node.id](
                    *[results[i] for i in node.inputs])
        out = None
        for i in self.graph.out_nodes:
            r = results[i]
            if out is None:
                out = r
                continue
            if r.shape[2] != out.shape[2]:
                r = _resize_reflect(r, out.shape[2], out.shape[3])
            out = out + r
        return out / len(self.graph.out_nodes)


class EfficientAttention(nn.Module):
    """Linear attention, O(N) in tokens (Shen et al., arXiv:1812.01243;
    reference model/layers/attention.py): per head, softmax over the keys'
    tokens and over the queries' channels, then a (ck x cv) context."""

    def __init__(self, in_channels: int, key_channels: int,
                 value_channels: int, head_count: int):
        super().__init__()
        self.head_count = head_count
        self.keys = nn.Conv2d(in_channels, key_channels, 1)
        self.queries = nn.Conv2d(in_channels, key_channels, 1)
        self.values = nn.Conv2d(in_channels, value_channels, 1)
        self.reprojection = nn.Conv2d(value_channels, in_channels, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        heads = self.head_count

        def proj(conv):
            return nhwc(conv(x)).reshape(b, h * w, heads, -1)

        keys = softmax_f32(proj(self.keys), 1)         # over tokens
        queries = softmax_f32(proj(self.queries), -1)  # over head channels
        values = proj(self.values)
        context = torch.einsum("bnhk,bnhv->bhkv", keys, values)
        attended = torch.einsum("bhkv,bnhk->bnhv", context, queries)
        attended = nchw(attended.reshape(b, h, w, -1))
        return self.reprojection(attended) + x


class EncoderStage(nn.Module):
    """GraphBlock + EfficientAttention (reference model/layers/
    encoder.py:201-262)."""

    def __init__(self, graph: GraphSpec, in_channels: int, out_channels: int,
                 kernel_size: int, heads: int = 8):
        super().__init__()
        self.layers = nn.Sequential(
            GraphBlock(graph, in_channels, out_channels, kernel_size),
            EfficientAttention(out_channels, out_channels, out_channels, heads),
        )

    def forward(self, x):
        return self.layers(x)


# ---------------------------------------------------------------------------
# Decoder blocks
# ---------------------------------------------------------------------------


class ConvLayer(nn.Module):
    """Reflect-pad(1) or unpadded conv -> optional sigmoid (reference
    model/layers/decoder.py:11-52)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: bool = True,
                 sigmoid: bool = False):
        super().__init__()
        self.padding = padding
        self.sigmoid = sigmoid
        self.layers = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, kernel_size))

    def forward(self, x):
        conv = self.layers[0]
        x = (reflect_conv(x, conv.weight, conv.bias) if self.padding
             else conv(x))
        return torch.sigmoid(x) if self.sigmoid else x


class DecoderConvELU(nn.Module):
    """ConvLayer -> optional BatchNorm -> ELU (reference
    model/layers/decoder.py:55-87)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: bool = True,
                 batch_norm: bool = False):
        super().__init__()
        layers = [ConvLayer(in_channels, out_channels, kernel_size, padding)]
        if batch_norm:
            layers.append(nn.BatchNorm2d(out_channels, eps=BN_EPS,
                                         momentum=0.1))
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return F.elu(self.layers(x))


class SELayer(nn.Module):
    """Squeeze-excitation (reference model/layers/decoder.py:90-136): two
    bias-free linear layers (``fc=True``) or two 1x1 convs with bias."""

    def __init__(self, channels: int, reduction: int = 16, fc: bool = True):
        super().__init__()
        reduced = channels // reduction
        self.fc = fc
        if fc:
            self.excite = nn.Sequential(
                nn.Linear(channels, reduced, bias=False), nn.ReLU(),
                nn.Linear(reduced, channels, bias=False), nn.Sigmoid())
        else:
            self.excite = nn.Sequential(
                nn.Conv2d(channels, reduced, 1), nn.ReLU(),
                nn.Conv2d(reduced, channels, 1), nn.Sigmoid())

    def forward(self, x):
        squeezed = x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype)
        if self.fc:
            s = self.excite(squeezed)
        else:
            s = self.excite(squeezed[:, :, None, None])[:, :, 0, 0]
        return x * s[:, :, None, None]


class DecoderStage(nn.Module):
    """One decoder stage: pixel-shuffle upsample, squeeze-excite skip
    fusion, iconv and optional sigmoid disparity head (reference
    model/layers/decoder.py:139-249).  Arguments are the config's keys."""

    def __init__(self, in_channels: int, feature_in_channels: int,
                 skip_in_channels: int, upsample_channels: int,
                 out_channels: int, skip_out_channels: int,
                 disp_channels: int = 2, batch_norm: bool = True,
                 fc: bool = True, scale: int = 2, concat_disp: bool = True,
                 calculate_disp: bool = True):
        super().__init__()
        self.feature_in_channels = feature_in_channels
        self.upsample_channels = upsample_channels
        self.skip_out_channels = skip_out_channels
        self.scale = scale
        self.concat_disp = concat_disp
        self.calculate_disp = calculate_disp
        r = scale
        self.upsample = nn.Sequential(
            DecoderConvELU(in_channels, upsample_channels * r * r,
                           batch_norm=batch_norm),
            nn.PixelShuffle(r))
        self.squeeze_excite = nn.Sequential(
            DecoderConvELU(feature_in_channels + skip_in_channels,
                           skip_out_channels, kernel_size=1, padding=False,
                           batch_norm=True),
            SELayer(skip_out_channels, fc=fc))
        iconv_in = (upsample_channels + skip_out_channels
                    + (disp_channels if concat_disp else 0))
        self.iconv = DecoderConvELU(iconv_in, out_channels,
                                    batch_norm=batch_norm)
        if calculate_disp:
            self.disp = ConvLayer(out_channels, disp_channels, sigmoid=True)

    def forward(self, x, feature_map, skip, disparity=None, disp_scale=1.0):
        r = self.scale
        h, w = skip.shape[2] * r, skip.shape[3] * r
        skip = nchw(resize_bilinear(nhwc(skip), (h, w)))
        skip = self.squeeze_excite(torch.cat([feature_map, skip], dim=1))
        parts = [self.upsample(x), skip]
        if self.concat_disp:
            dh, dw = disparity.shape[2] * r, disparity.shape[3] * r
            parts.append(nchw(resize_bilinear(nhwc(disparity), (dh, dw))))
        out = self.iconv(torch.cat(parts, dim=1))
        disp = disp_scale * self.disp(out) if self.calculate_disp else None
        return out, skip, disp


__all__ = [
    "ConvBNELU", "NodeBlock", "GraphBlock", "EfficientAttention",
    "EncoderStage", "ConvLayer", "DecoderConvELU", "SELayer", "DecoderStage",
    "init_parameters",
]
