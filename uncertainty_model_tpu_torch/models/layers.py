"""Layer zoo of the eval model (the port of the JAX package's
``models/layers.py``).

Modules take logical NCHW tensors (``torch.channels_last`` memory in the
port); the NHWC ops of ``..ops`` see the free ``permute(0, 2, 3, 1)`` view.
Module and parameter names follow the reference PyTorch ``state_dict``
(documented by the JAX package's ``train/convert.py``), so reference
checkpoints load as they are.

``dtype`` follows flax's: ``None`` computes in f32, ``torch.bfloat16`` is
mixed precision.  Parameters and BatchNorm statistics stay f32 either way;
each module casts its inputs, kernels and biases to ``dtype`` where the
JAX layer casts them, and rounds where it rounds: a conv's bias is added
after the conv's output is rounded (XLA's ``conv + bias``), BatchNorm
normalises with three bf16 roundings, the attention softmax and the SE
squeeze reduce in f32.  ``torch.autocast`` would round elsewhere.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import reflect_pad2d, resize_bilinear
from ..parallel.mesh import all_reduce_sum_autograd
from .graph import GraphSpec, Node

BN_EPS = 1e-5


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def reflect_conv(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None) -> torch.Tensor:
    """Reflect(1)-padded 3x3 conv, with numpy's reflect rule (see
    ``ops/pad.py``: ``padding_mode="reflect"`` refuses 1-pixel maps)."""
    return F.conv2d(nchw(reflect_pad2d(nhwc(x), (1, 1, 1, 1))), weight, bias)


def cast(t: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``t`` in ``dtype`` (``None``: as it is), as flax casts to a module's
    ``dtype``."""
    return t if dtype is None else t.to(dtype)


def biased_conv(conv_fn, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, dtype: torch.dtype | None
                ) -> torch.Tensor:
    """``conv_fn(x, weight, bias)``.  With a ``dtype``, the input, kernel
    and bias are cast to it and the bias is added after the conv's output
    is rounded, as the JAX layers compute ``conv(x, k) + b`` (a conv given
    the bias folds it into the f32 sum and rounds once)."""
    if dtype is None:
        return conv_fn(x, weight, bias)
    return (conv_fn(x.to(dtype), weight.to(dtype), None)
            + bias.to(dtype)[:, None, None])


def conv2d(conv: nn.Conv2d, x: torch.Tensor,
           dtype: torch.dtype | None) -> torch.Tensor:
    """``conv(x)`` in ``dtype``: flax ``nn.Conv(dtype=...)``; the module's
    own call in f32."""
    if dtype is None:
        return conv(x)
    def fn(x, w, b):
        return F.conv2d(x, w, b, conv.stride, conv.padding)
    return biased_conv(fn, x, conv.weight, conv.bias, dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``1 / (1 + exp(-x))``, each operation rounded in
    ``x``'s type; f32 as ``torch.sigmoid``, which rounds once."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def softmax_f32(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Softmax with the max subtracted and the sum taken in f32, returned
    in ``v``'s type."""
    return torch.softmax(v, dim, dtype=torch.float32).to(v.dtype)


def attention_softmax(v: torch.Tensor, dim: int) -> torch.Tensor:
    """The JAX package's ``EfficientAttention`` softmax (layers.py:320-326):
    f32 as ``torch.softmax``; otherwise ``exp(v - max)`` in ``v``'s type,
    the sum in f32 and ``e * (1 / sum)`` in ``v``'s type.  The JAX layer
    takes the max in f32 and casts it back: the max of ``v``'s values is
    one of them, so ``v.amax`` is the same number without the f32 copy."""
    if v.dtype == torch.float32:
        return torch.softmax(v, dim)
    m = v.amax(dim, keepdim=True)
    e = torch.exp(v - m)
    s = e.sum(dim, keepdim=True, dtype=torch.float32)
    return e * (1.0 / s).to(v.dtype)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers, drawn from ``generator``: Xavier-
    uniform conv kernels with U(+-1/sqrt(fan_in)) biases, U(+-1/sqrt(fan_in))
    linear weights and biases (torch's defaults for the SE layers, the
    JAX package's ``torch_fanin_uniform`` for the discriminator's head);
    BatchNorm and the gate weights keep their constructors' values."""
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
                if m.bias is not None:
                    m.bias.uniform_(-b, b, generator=generator)


# ---------------------------------------------------------------------------
# Encoder blocks
# ---------------------------------------------------------------------------


class TorchBatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (momentum 0.1: the JAX package's flax momentum
    0.9, with Bessel's factor on the accumulated variance) with the JAX
    package's ``TorchBatchNorm`` mixed precision (layers.py:83-109).

    ``dtype=None``: ``F.batch_norm`` in f32.  With a ``dtype``, the
    statistics come from ``x`` in f32 and the running statistics update in
    f32; the output is ``(x - mean) * inv + bias`` in ``dtype`` with
    ``inv = rsqrt(var + eps) * weight``, each operand cast to ``dtype``:
    three roundings where ``F.batch_norm`` rounds once.  The parameters,
    buffers and their names are ``nn.BatchNorm2d``'s, in f32.

    ``process_group`` (``parallel.sync_batchnorm`` sets it; None: this
    process's batch alone): in train mode the statistics cover the rows
    of every rank of the group, as the JAX package's do over the global
    batch (layers.py:93-109): the mean over all rows first, then the
    variance as the mean of ``(x - mean)^2``, Bessel's factor from the
    global count, the running statistics moved once and alike on every
    rank.  The sums are all-reduced with a backward that sums their
    gradients over the ranks, so each rank's input gradient holds the
    other ranks' terms.  The output is the explicit form above, in f32
    too (JAX's f32 rounding, not ``F.batch_norm``'s)."""

    def __init__(self, num_features: int, dtype: torch.dtype | None = None):
        super().__init__(num_features, eps=BN_EPS, momentum=0.1)
        self.dtype = dtype
        self.process_group = None

    def _batch_statistics(self, x):
        """(mean, biased variance, row count) of ``x`` in f32 over this
        process's batch, or over every rank's with a process group (the
        count then a tensor)."""
        dims = (0, 2, 3)
        xf = x.float()
        n = x.numel() // x.shape[1]
        group = self.process_group
        if group is None:
            mean = xf.mean(dims)
            return mean, (xf - mean[:, None, None]).square().mean(dims), n
        sums = all_reduce_sum_autograd(
            torch.cat([xf.sum(dims), xf.new_full((1,), n)]), group)
        n = sums[-1].detach()
        mean = sums[:-1] / n
        var = all_reduce_sum_autograd(
            (xf - mean[:, None, None]).square().sum(dims), group) / n
        return mean, var, n

    def forward(self, x):
        dt = self.dtype
        if dt is None and self.process_group is None:
            return super().forward(x)
        dt = dt or torch.float32
        if self.training:
            mean, var, n = self._batch_statistics(x)
            with torch.no_grad():
                m = self.momentum
                if isinstance(n, int):
                    bessel = n / (n - 1) if n > 1 else 1.0
                else:  # f32(n / (n - 1)) of the global count, as JAX's
                    n = n.double()
                    bessel = torch.where(n > 1, n / (n - 1), 1.0).float()
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var * bessel, alpha=m)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = (torch.rsqrt(var + self.eps) * self.weight).to(dt)
        return ((x.to(dt) - mean.to(dt)[:, None, None]) * inv[:, None, None]
                + self.bias.to(dt)[:, None, None])


class ConvBNELU(nn.Module):
    """Zero-pad conv -> BatchNorm -> ELU (reference model/layers/
    encoder.py:21-52, ``ConvELUBlock``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                      padding=(kernel_size - 1) // 2),
            TorchBatchNorm(out_channels, dtype),
            nn.ELU(),
        )

    def forward(self, x):
        conv, bn, elu = self.layers
        return elu(bn(conv2d(conv, x, self.dtype)))


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
                 kernel_size: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.n_inputs = len(node.inputs)
        if self.n_inputs > 1:
            self.mean_weight = nn.Parameter(torch.ones(self.n_inputs))
        is_input = node.node_type == "input"
        self.convolution = ConvBNELU(
            in_channels if is_input else out_channels, out_channels,
            kernel_size, stride=2 if is_input else 1, dtype=dtype)

    def forward(self, *inputs):
        if self.n_inputs > 1:
            # the sigmoid in f32, the gates in the inputs' type
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
                 kernel_size: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.graph = graph
        self.node_blocks = nn.ModuleList(
            NodeBlock(node, in_channels, out_channels, kernel_size, dtype)
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
                 value_channels: int, head_count: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.head_count = head_count
        self.dtype = dtype
        self.keys = nn.Conv2d(in_channels, key_channels, 1)
        self.queries = nn.Conv2d(in_channels, key_channels, 1)
        self.values = nn.Conv2d(in_channels, value_channels, 1)
        self.reprojection = nn.Conv2d(value_channels, in_channels, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        heads = self.head_count

        def proj(conv):
            return nhwc(conv2d(conv, x, self.dtype)).reshape(b, h * w, heads,
                                                             -1)

        keys = attention_softmax(proj(self.keys), 1)         # over tokens
        queries = attention_softmax(proj(self.queries), -1)  # head channels
        values = proj(self.values)
        context = torch.einsum("bnhk,bnhv->bhkv", keys, values)
        attended = torch.einsum("bhkv,bnhk->bnhv", context, queries)
        attended = nchw(attended.reshape(b, h, w, -1))
        return conv2d(self.reprojection, attended, self.dtype) + x


class EncoderStage(nn.Module):
    """GraphBlock + EfficientAttention (reference model/layers/
    encoder.py:201-262)."""

    def __init__(self, graph: GraphSpec, in_channels: int, out_channels: int,
                 kernel_size: int, heads: int = 8,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.layers = nn.Sequential(
            GraphBlock(graph, in_channels, out_channels, kernel_size, dtype),
            EfficientAttention(out_channels, out_channels, out_channels, heads,
                               dtype),
        )

    def forward(self, x):
        return self.layers(x)


# ---------------------------------------------------------------------------
# Decoder blocks
# ---------------------------------------------------------------------------


class ConvLayer(nn.Module):
    """Reflect-pad(1) or unpadded conv -> optional sigmoid (reference
    model/layers/decoder.py:11-52).

    An unpadded 1x1 conv takes a tuple of inputs, as the JAX layer does
    (layers.py:476-486): each input meets its slice of the kernel, and the
    partial convs and the bias are summed, so the concat is never built."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: bool = True,
                 sigmoid: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.padding = padding
        self.sigmoid = sigmoid
        self.dtype = dtype
        self.layers = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, kernel_size))

    def forward(self, x):
        conv, dt = self.layers[0], self.dtype
        if isinstance(x, tuple):
            w, i = cast(conv.weight, dt), 0
            out = None
            for p in x:
                c = p.shape[1]
                y = F.conv2d(cast(p, dt), w[:, i:i + c])
                out, i = (y if out is None else out + y), i + c
            x = out + cast(conv.bias, dt)[:, None, None]
        elif self.padding:
            x = biased_conv(reflect_conv, x, conv.weight, conv.bias, dt)
        else:
            x = conv2d(conv, x, dt)
        return sigmoid(x) if self.sigmoid else x


class DecoderConvELU(nn.Module):
    """ConvLayer -> optional BatchNorm -> ELU (reference
    model/layers/decoder.py:55-87)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: bool = True,
                 batch_norm: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        layers = [ConvLayer(in_channels, out_channels, kernel_size, padding,
                            dtype=dtype)]
        if batch_norm:
            layers.append(TorchBatchNorm(out_channels, dtype))
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return F.elu(self.layers(x))


class SELayer(nn.Module):
    """Squeeze-excitation (reference model/layers/decoder.py:90-136): two
    bias-free linear layers (``fc=True``) or two 1x1 convs with bias.  The
    mean is reduced in f32 and cast to the input's type."""

    def __init__(self, channels: int, reduction: int = 16, fc: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        reduced = channels // reduction
        self.fc = fc
        self.dtype = dtype
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
        first, relu, second, _ = self.excite
        if self.fc:
            def excite(m, s):
                return F.linear(cast(s, self.dtype),
                                cast(m.weight, self.dtype))
            s = squeezed
        else:
            def excite(m, s):
                return conv2d(m, s, self.dtype)
            s = squeezed[:, :, None, None]
        s = sigmoid(excite(second, relu(excite(first, s))))
        return x * s.reshape(s.shape[0], -1, 1, 1)


class DecoderStage(nn.Module):
    """One decoder stage: pixel-shuffle upsample, squeeze-excite skip
    fusion, iconv and optional sigmoid disparity head (reference
    model/layers/decoder.py:139-249).  Arguments are the config's keys."""

    def __init__(self, in_channels: int, feature_in_channels: int,
                 skip_in_channels: int, upsample_channels: int,
                 out_channels: int, skip_out_channels: int,
                 disp_channels: int = 2, batch_norm: bool = True,
                 fc: bool = True, scale: int = 2, concat_disp: bool = True,
                 calculate_disp: bool = True,
                 dtype: torch.dtype | None = None):
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
                           batch_norm=batch_norm, dtype=dtype),
            nn.PixelShuffle(r))
        self.squeeze_excite = nn.Sequential(
            DecoderConvELU(feature_in_channels + skip_in_channels,
                           skip_out_channels, kernel_size=1, padding=False,
                           batch_norm=True, dtype=dtype),
            SELayer(skip_out_channels, fc=fc, dtype=dtype))
        iconv_in = (upsample_channels + skip_out_channels
                    + (disp_channels if concat_disp else 0))
        self.iconv = DecoderConvELU(iconv_in, out_channels,
                                    batch_norm=batch_norm, dtype=dtype)
        if calculate_disp:
            self.disp = ConvLayer(out_channels, disp_channels, sigmoid=True,
                                  dtype=dtype)

    def forward(self, x, feature_map, skip, disparity=None, disp_scale=1.0):
        """``disp_scale``: a float, applied in f32 (the JAX step and
        evaluation pass it as ``jnp.float32``) before the disparity is cast
        back to ``x``'s type."""
        r = self.scale
        h, w = skip.shape[2] * r, skip.shape[3] * r
        skip = nchw(resize_bilinear(nhwc(skip), (h, w)))
        # a tuple: the 1x1 conv splits its kernel per input
        skip = self.squeeze_excite((feature_map, skip))
        parts = [self.upsample(x), skip]
        if self.concat_disp:
            dh, dw = disparity.shape[2] * r, disparity.shape[3] * r
            parts.append(nchw(resize_bilinear(nhwc(disparity), (dh, dw))))
        out = self.iconv(torch.cat(parts, dim=1))
        disp = None
        if self.calculate_disp:
            disp = (disp_scale * self.disp(out).float()).to(x.dtype)
        return out, skip, disp


__all__ = [
    "TorchBatchNorm", "ConvBNELU", "NodeBlock", "GraphBlock",
    "EfficientAttention", "EncoderStage", "ConvLayer", "DecoderConvELU",
    "SELayer", "DecoderStage", "init_parameters",
]
