"""Serving forward of the eval model (the port of the JAX package's
``serving.py``): space-to-depth encoder stages or none, fused decoder
stages (any suffix of the five), the ``gate_fold``, ``gate_z`` and
``squeeze_first`` decoder pipelines, and the JAX package's other build
options (``dec_fold``, ``elu_fold``, ``smax``, ``decoder_backend``).

The build rewrites a model into inference-only parameters with transforms
that are exact at eval time:

* BatchNorm folding into the preceding conv's weight and bias;
* NodeBlock gates precomputed (``sigmoid(mean_weight)``, with the
  reference's ``mean_weight[0]`` reuse);
* for the fused decoder stages: the upsample conv's output channels in
  phase-major order, the iconv's input channels in the ``[z | xup | disp]``
  order of ``assemble_z``'s concat tensor, the SE conv split into its
  feature-map and skip halves, the skip half zero-embedded to the previous
  fused stage's concat width (that concat tensor is the next stage's skip),
  and the feature-map half folded into ``assemble_z`` where the feature map
  has at most 8 channels (the input image at full resolution).

and for the space-to-depth (s2d) stages (``ops/s2d.py``): the input conv
rewritten to write s2d output directly (stride 4) or, after an s2d stage,
to read s2d input (stride 1); the interior kernels rewritten for the s2d
grid; the attention's 1x1 kernels made block-diagonal over the four
phases.

Decoder pipelines (``dec_pipeline``), as in the JAX package:

* ``gate_fold``: ``assemble_z`` writes the concat tensor ungated; the SE
  gates scale the iconv's input and the next stage's skip-conv input.
* ``gate_z``: ``assemble_z``, then ``gate_z`` scales the z block in place.
* ``squeeze_first``: ``se_squeeze`` gives the SE mean, then ``assemble``
  writes the concat tensor once, already gated.

``elu_fold`` is accepted and changes nothing: in the JAX package it hands
a fused stage's ``out`` on before the iconv's ELU so that the consuming
convs apply it, but every consumer here is a plain conv that takes the
ELU'd tensor, so the port computes the ELU once, in the stage, and the
result is the same tensor.

The forward runs each encoder stage in ``utils/scopes.py::scope(f"enc{i}")``
and each decoder stage in ``scope(f"dec{i}")``, the JAX package's
``jax.named_scope`` names; an s2d stage's ``depth_to_space`` runs outside
its scope, as there.  The whole call is the span recorder's ``serve``
(``utils/scopes.py::span``: no profiler range, so the stages' paths stay
``enc0``-``dec4``).

Softmaxes subtract their max and sum in f32 by default (``smax="window"``;
the JAX package's default, "nomax", drops the max: the two are equal in
exact arithmetic, and only this one cannot overflow).

The options are keyword arguments with the port's defaults; the port does
not read the JAX package's ``UMT_*`` environment variables.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .device import resolve_device
from .models.graph import GraphSpec
from .models.layers import SMAX, nchw, nhwc, reflect_conv, softmax
from .ops import resize_bilinear
from .ops.conv import gated_conv_elu, gated_sum
from .ops.decoder_fused import assemble, assemble_z, gate_z, se_squeeze
from .ops.s2d import (block_diag_1x1_kernel, depth_to_space, s2d_bias,
                      s2d_conv_kernel, s2d_in_stride2_conv_kernel,
                      s2d_out_stride2_conv_kernel, space_to_depth)
from .utils.scopes import scope, span

FUSED_STAGES = (2, 3, 4)
FOLD_MAX_CHANNELS = 8
PIPELINES = ("gate_fold", "gate_z", "squeeze_first")


class EncoderSpec(NamedTuple):
    graph: GraphSpec
    heads: int
    s2d: bool = False          # the stage runs on the s2d grid
    s2d_in: bool = False       # its input arrives in s2d form
    conv_backend: str = "pallas"   # s2d interiors: the kernel, or F.conv2d
    attn_native: bool = False  # s2d stage: depth_to_space before attention
    smax: str = "window"       # the attention softmaxes' formulation


# ---------------------------------------------------------------------------
# Build: model -> folded serving params
# ---------------------------------------------------------------------------


def _fold_bn(weight, bias, bn):
    """conv -> eval BatchNorm == conv with rescaled weight and bias."""
    inv = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return (weight.float() * inv[:, None, None, None],
            (bias.float() - bn.running_mean.float()) * inv + bn.bias.float())


def _conv_bn(block):
    """Folded (weight, bias) of a DecoderConvELU (BatchNorm optional)."""
    conv = block.layers[0].layers[0]
    if len(block.layers) > 1:
        return _fold_bn(conv.weight, conv.bias, block.layers[1])
    return conv.weight.float(), conv.bias.float()


def _node_gates(node_block):
    """Per-input gates of a NodeBlock: input k >= 1 takes gate k - 1 (the
    reference's quirk, see NodeBlock)."""
    g = torch.sigmoid(node_block.mean_weight.float())
    return g[[0] + list(range(node_block.n_inputs - 1))]


def _hwio(w):
    return w.permute(2, 3, 1, 0)


def _oihw(w):
    return w.permute(3, 2, 0, 1)


@torch.no_grad()
def build_serving_params(model, dtype=torch.bfloat16, device=None, *,
                         s2d_stages=(), s2d_conv_backend="pallas",
                         s2d_attention="s2d", fused_stages=FUSED_STAGES,
                         decoder_backend="fused", dec_pipeline="gate_fold",
                         dec_fold=True, elu_fold=False, smax="window"):
    """Fold ``model``'s weights into serving parameters of type ``dtype``
    on ``device`` (default: the model's).  Returns ``(specs, params)``:
    ``specs`` is static structure, ``params`` nested dicts of tensors.

    Encoder stages in ``s2d_stages`` with kernels of 5 or more run on the
    s2d grid (see the module docstring); their interior kernels are HWIO
    for ``gated_conv_elu`` under ``s2d_conv_backend="pallas"`` and OIHW
    for ``F.conv2d`` under ``"lax"``.  ``s2d_attention="native"`` runs such
    a stage's attention on the ``depth_to_space``'d map instead.  Every
    encoder spec carries ``smax``.

    Decoder stage i is fused where ``i in fused_stages`` and its scale is
    2 (JAX ``serving.py:301``); its spec says so (``fused``) and carries
    ``dec_pipeline``, the fold (``dec_fold`` and a feature map of at most
    8 channels).  ``elu_fold`` must be a bool and changes nothing (see the
    module docstring).  A set where an unfused stage follows a
    fused one raises ``ValueError``: the JAX package hands such a stage the
    fused stage's whole concat tensor as its skip (``serving.py:904-906``)
    and cannot trace it, so there is no reference to hold it against."""
    if s2d_conv_backend not in ("pallas", "lax"):
        raise ValueError(f"unknown s2d_conv_backend {s2d_conv_backend!r}")
    if s2d_attention not in ("s2d", "native"):
        raise ValueError(f"unknown s2d_attention {s2d_attention!r}")
    if decoder_backend != "fused":
        raise ValueError(f"unknown decoder_backend {decoder_backend!r} (the "
                         "fused glue is the only decoder backend)")
    if dec_pipeline not in PIPELINES:
        raise ValueError(f"dec_pipeline {dec_pipeline!r} is not one of "
                         f"{PIPELINES}")
    if smax not in SMAX:
        raise ValueError(f"smax {smax!r} is not one of {SMAX}")
    if not isinstance(elu_fold, bool):
        raise ValueError(f"elu_fold {elu_fold!r} is not a bool")
    if device is None:
        device = next(model.parameters()).device

    def put(t, channels_last=True):
        t = t.detach().to(device=device, dtype=dtype)
        return t.contiguous(memory_format=torch.channels_last) \
            if t.ndim == 4 and channels_last else t.contiguous()

    enc_specs, enc_params = [], []
    prev_s2d = False
    for i, stage in enumerate(model.encoder.layers):
        graph_block, attention = stage.layers
        kernel = graph_block.node_blocks[0].convolution.layers[0].kernel_size[0]
        use_s2d = i in s2d_stages and kernel >= 5
        # reading s2d input needs an even-pad input conv (k = 5, 9, ...)
        s2d_in = prev_s2d and ((kernel - 1) // 2) % 2 == 0
        nodes = {}
        for node, nb in zip(graph_block.graph.nodes, graph_block.node_blocks):
            conv, bn = nb.convolution.layers[0], nb.convolution.layers[1]
            w, b = _fold_bn(conv.weight, conv.bias, bn)
            is_input = node.node_type == "input"
            s2d_interior = use_s2d and not is_input
            hwio = s2d_interior and s2d_conv_backend == "pallas"
            if s2d_interior:
                w, b = s2d_conv_kernel(_hwio(w)), s2d_bias(b)
                w = w if hwio else _oihw(w)
            elif is_input and s2d_in:
                w = _oihw(s2d_in_stride2_conv_kernel(_hwio(w))[0])
            elif is_input and use_s2d:
                w = _oihw(s2d_out_stride2_conv_kernel(_hwio(w))[0])
                b = s2d_bias(b)
            entry = {"w": put(w, channels_last=not hwio), "b": put(b)}
            if nb.n_inputs > 1:
                entry["gates"] = put(_node_gates(nb))
            elif s2d_interior:
                entry["gates"] = put(torch.ones(1))
            nodes[node.id] = entry
        attn_native = use_s2d and s2d_attention == "native"
        attn = {}
        for name in ("keys", "queries", "values", "reprojection"):
            conv = getattr(attention, name)
            w, b = conv.weight[:, :, 0, 0], conv.bias
            if use_s2d and not attn_native:
                w = block_diag_1x1_kernel(w.t()[None, None])[0, 0].t()
                b = s2d_bias(b)
            attn[name] = (put(w), put(b))
        enc_specs.append(EncoderSpec(graph_block.graph, attention.head_count,
                                     use_s2d, s2d_in, s2d_conv_backend,
                                     attn_native, smax))
        enc_params.append({"nodes": nodes, "attention": attn})
        prev_s2d = use_s2d and not attn_native

    dec_specs, dec_params = [], []
    prev_fused_ccat = None
    for i, st in enumerate(model.decoder.layers):
        fused = i in fused_stages and st.scale == 2
        if dec_specs and dec_specs[-1]["fused"] and not fused:
            raise ValueError(
                f"fused_stages {tuple(fused_stages)}: decoder stage {i} is "
                f"not fused but follows the fused stage {i - 1}; the JAX "
                "package passes such a stage the fused stage's whole concat "
                "tensor as its skip (serving.py:904-906) and cannot trace "
                "it, so the port refuses it")
        cf, cu, cso = (st.feature_in_channels, st.upsample_channels,
                       st.skip_out_channels)
        se_w, se_b = _conv_bn(st.squeeze_excite[0])
        up_w, up_b = _conv_bn(st.upsample[0])
        ic_w, ic_b = _conv_bn(st.iconv)
        se_fm, se_skip = se_w[:, :cf], se_w[:, cf:]
        spec = {"fused": fused, "scale": st.scale, "cso": cso,
                "concat_disp": st.concat_disp,
                "calculate_disp": st.calculate_disp}
        prm = {"se_bias": put(se_b)}
        if fused:
            # xc channel (2i + j) * cu + c is pixel_shuffle channel c*4 + 2i+j
            perm = [c * 4 + p for p in range(4) for c in range(cu)]
            up_w, up_b = up_w[perm], up_b[perm]
            # iconv input [xup | z | disp] -> assemble_z's [z | xup | disp]
            ic_w = torch.cat([ic_w[:, cu:cu + cso], ic_w[:, :cu],
                              ic_w[:, cu + cso:]], dim=1)
            if prev_fused_ccat is not None:
                se_skip = torch.cat([se_skip, se_skip.new_zeros(
                    cso, prev_fused_ccat - se_skip.shape[1], 1, 1)], dim=1)
            spec["fold"] = dec_fold and cf <= FOLD_MAX_CHANNELS
            spec["pipeline"] = dec_pipeline
            prev_fused_ccat = ic_w.shape[1]
        if spec.get("fold"):
            prm["k_fm"] = put(se_fm[:, :, 0, 0].t())
        else:
            prm["se_fm"] = put(se_fm)
        prm["se_skip"] = put(se_skip)
        prm["upsample"] = (put(up_w), put(up_b))
        prm["iconv"] = (put(ic_w), put(ic_b))
        se_layer = st.squeeze_excite[1]
        c1, c2 = se_layer.excite[0], se_layer.excite[2]
        if se_layer.fc:
            prm["se"] = (put(c1.weight), None, put(c2.weight), None)
        else:
            prm["se"] = (put(c1.weight[:, :, 0, 0]), put(c1.bias),
                         put(c2.weight[:, :, 0, 0]), put(c2.bias))
        if st.calculate_disp:
            conv = st.disp.layers[0]
            prm["disp"] = (put(conv.weight), put(conv.bias))
        dec_specs.append(spec)
        dec_params.append(prm)
    return (tuple(enc_specs), tuple(dec_specs)), {"encoder": enc_params,
                                                   "decoder": dec_params}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _attend(keys, queries, values, heads, smax, keys_smax=None):
    """EfficientAttention on (B, N, C) token maps: keys softmaxed over the
    tokens (in ``keys_smax``'s formulation, default ``smax``), queries
    over each head's channels (in ``smax``'s), per-head context."""
    b, n, c = keys.shape

    def split(t):
        return t.reshape(b, n, heads, c // heads)

    keys = softmax(split(keys), 1, keys_smax or smax)
    queries = softmax(split(queries), -1, smax)
    context = torch.einsum("bnhk,bnhv->bhkv", keys, split(values))
    return torch.einsum("bhkv,bnhk->bnhv", context, queries).reshape(b, n, c)


def _attention(prm, heads, x, smax):
    """EfficientAttention on folded params; 1x1 convs as token matmuls."""
    b, c, h, w = x.shape
    tokens = nhwc(x).reshape(b, h * w, c)
    keys, queries, values = (F.linear(tokens, *prm[name])
                             for name in ("keys", "queries", "values"))
    attended = _attend(keys, queries, values, heads, smax)
    out = F.linear(attended, *prm["reprojection"])
    return nchw(out.reshape(b, h, w, c)) + x


def _attention_s2d(prm, heads, x, smax):
    """EfficientAttention computed on an s2d map (B, h, w, 4C) NHWC: the
    block-diagonal projections act on each phase alone, so the projected
    maps, split into their phases, are the native token maps in another
    order, and attention does not depend on the order of its tokens.  The
    keys' softmax subtracts its max whatever ``smax`` is, as the JAX
    package's ``_softmax_tokens_s2d`` does."""
    b, h, w, c4 = x.shape
    tokens = x.reshape(b, h * w, c4)
    keys, queries, values = (F.linear(tokens, *prm[name]).reshape(
        b, 4 * h * w, c4 // 4) for name in ("keys", "queries", "values"))
    attended = _attend(keys, queries, values, heads, smax, "window")
    return F.linear(attended.reshape(b, h * w, c4),
                    *prm["reprojection"]).reshape(b, h, w, c4) + x


def _check_equal_shapes(node, inputs):
    if any(t.shape != inputs[0].shape for t in inputs[1:]):
        raise ValueError(
            f"serving path: unequal node resolutions at node {node.id} "
            f"({[tuple(t.shape) for t in inputs]}); unreachable for stages "
            "built from stride-2 input nodes and stride-1 interiors — the "
            "eval model carries the reference's resize alignment for such "
            "stages")


def _out_mean(results, out_nodes):
    out = results[out_nodes[0]]
    for nid in out_nodes[1:]:
        out = out + results[nid]
    return out / len(out_nodes)


def _input_node(p, spec, x):
    """An input node's conv + ELU on the stage input ``x`` (NCHW): stride
    2, or stride 1 on an s2d input (``s2d_in``), or, for an s2d stage on a
    native input, stride 4 with the asymmetric pad (p, p-1) writing s2d
    output."""
    k = p["w"].shape[-1]
    if spec.s2d_in:
        y = F.conv2d(x, p["w"], p["b"], padding=(k - 1) // 2)
    elif spec.s2d:
        pad = (k - 3) // 2  # the original kernel's pad
        y = F.conv2d(F.pad(x, (pad, pad - 1, pad, pad - 1)), p["w"], p["b"],
                     stride=4)
    else:
        y = F.conv2d(x, p["w"], p["b"], stride=2, padding=(k - 1) // 2)
    return F.elu(y)


def _encoder_stage_s2d(prm, spec: EncoderSpec, x):
    """An s2d stage: ``x`` NCHW (s2d iff ``spec.s2d_in``); returns NCHW, s2d
    unless ``spec.attn_native``.  Node outputs are NHWC on the s2d grid,
    zero-padded once and shared by every consumer; interiors run
    ``gated_conv_elu`` (or the gated sum, ``F.conv2d`` and ELU under the
    "lax" backend)."""
    graph = spec.graph
    interior = next(n for n in graph.nodes if n.node_type != "input")
    w = prm["nodes"][interior.id]["w"]  # HWIO, or OIHW under "lax"
    p = ((w.shape[-1] if spec.conv_backend == "lax" else w.shape[0]) - 1) // 2
    raw, padded = {}, {}
    for nid in graph.in_nodes:
        y = nhwc(_input_node(prm["nodes"][nid], spec, x))
        raw[nid] = space_to_depth(y) if spec.s2d_in else y.contiguous()
        padded[nid] = F.pad(raw[nid], (0, 0, p, p, p, p))
    for node in graph.nodes:
        if node.id in raw:
            continue
        q = prm["nodes"][node.id]
        xs = [padded[j] for j in node.inputs]
        _check_equal_shapes(node, xs)
        if spec.conv_backend == "pallas":
            y = gated_conv_elu(xs, q["gates"], q["w"], q["b"])
        else:
            h = nchw(gated_sum(xs, q["gates"]))
            y = nhwc(F.elu(F.conv2d(h, q["w"], q["b"])))
        raw[node.id] = y
        if any(node.id in n.inputs for n in graph.nodes):
            padded[node.id] = F.pad(y, (0, 0, p, p, p, p))
    out = _out_mean(raw, graph.out_nodes)
    if spec.attn_native:
        return _attention(prm["attention"], spec.heads,
                          nchw(depth_to_space(out)), spec.smax)
    return nchw(_attention_s2d(prm["attention"], spec.heads, out, spec.smax))


def _encoder_stage(prm, spec: EncoderSpec, x):
    if spec.s2d:
        return _encoder_stage_s2d(prm, spec, x)
    graph = spec.graph
    results = {nid: _input_node(prm["nodes"][nid], spec, x)
               for nid in graph.in_nodes}
    for node in graph.nodes:
        if node.id in results:
            continue
        p = prm["nodes"][node.id]
        inputs = [results[j] for j in node.inputs]
        _check_equal_shapes(node, inputs)
        h = gated_sum(inputs, p["gates"]) if len(inputs) > 1 else inputs[0]
        pad = (p["w"].shape[-1] - 1) // 2
        results[node.id] = F.elu(F.conv2d(h, p["w"], p["b"], padding=pad))
    return _attention(prm["attention"], spec.heads,
                      _out_mean(results, graph.out_nodes), spec.smax)


def _se_gates(se, squeezed, dtype):
    """The SE MLP (fc and conv variants) on an f32 squeeze."""
    w1, b1, w2, b2 = se
    s = F.relu(F.linear(squeezed.to(dtype), w1, b1))
    return torch.sigmoid(F.linear(s, w2, b2))


def _upsample(x, r):
    return nchw(resize_bilinear(nhwc(x), (x.shape[2] * r, x.shape[3] * r)))


def _decoder_stage(prm, spec, x, fm, skip, disparity, disp_scale):
    """Unfused stage; the SE conv's skip half runs below the upsample
    (both are linear, so conv(up(skip)) == up(conv(skip)))."""
    r = spec["scale"]
    skip_feat = _upsample(F.conv2d(skip, prm["se_skip"]), r)
    se = F.conv2d(fm, prm["se_fm"]) + skip_feat + prm["se_bias"][:, None, None]
    se = F.elu(se)
    gates = _se_gates(prm["se"], se.mean(dim=(2, 3), dtype=torch.float32),
                      se.dtype)
    skip_out = se * gates[:, :, None, None]
    x_up = F.pixel_shuffle(F.elu(reflect_conv(x, *prm["upsample"])), r)
    parts = [x_up, skip_out]
    if spec["concat_disp"]:
        parts.append(_upsample(disparity, r))
    out = F.elu(reflect_conv(torch.cat(parts, dim=1), *prm["iconv"]))
    disp = None
    if spec["calculate_disp"]:
        disp = disp_scale * torch.sigmoid(reflect_conv(out, *prm["disp"]))
    return out, skip_out, disp


def _fused_stage(prm, spec, x, fm, skip, disparity, disp_scale):
    """Fused stage, in the pipeline ``spec["pipeline"]`` names.  ``skip``
    is a plain tensor or the previous fused stage's ``(cat, gate_scale)``
    (``gate_scale`` None where the gates are already in ``cat``); returns
    ``(out, (cat, gate_scale), disp)``, whose middle item is the next fused
    stage's skip."""
    if isinstance(skip, tuple):
        cat_prev, scale = skip
        skip = cat_prev if scale is None else cat_prev * scale[:, :, None, None]
    skip_feat_h = nhwc(F.conv2d(skip, prm["se_skip"])).contiguous()
    xc = nhwc(reflect_conv(x, *prm["upsample"])).contiguous()
    if spec["fold"]:
        se_in, k_fm = fm, prm["k_fm"]
    else:
        se_in, k_fm = F.conv2d(fm, prm["se_fm"]), None
    se_in = nhwc(se_in).contiguous()
    dh = nhwc(disparity).contiguous() if spec["concat_disp"] else None
    scale = None
    if spec["pipeline"] == "squeeze_first":
        mean = se_squeeze(se_in, skip_feat_h, prm["se_bias"], k_fm=k_fm)
        gates = _se_gates(prm["se"], mean, skip_feat_h.dtype)
        cat = assemble(se_in, skip_feat_h, gates, xc, dh, prm["se_bias"],
                       k_fm=k_fm)
    else:
        cat, mean = assemble_z(se_in, skip_feat_h, xc, dh, prm["se_bias"],
                               k_fm=k_fm)
        gates = _se_gates(prm["se"], mean, cat.dtype)
        if spec["pipeline"] == "gate_z":
            cat = gate_z(cat, gates, spec["cso"])
        else:
            scale = torch.cat([gates, gates.new_ones(
                gates.shape[0], cat.shape[-1] - spec["cso"])], dim=1)
    cat = nchw(cat)
    iconv_in = cat if scale is None else cat * scale[:, :, None, None]
    out = F.elu(reflect_conv(iconv_in, *prm["iconv"]))
    disp = None
    if spec["calculate_disp"]:
        disp = disp_scale * torch.sigmoid(reflect_conv(out, *prm["disp"]))
    return out, (cat, scale), disp


def make_serving_forward(model, dtype=torch.bfloat16, device=None, *,
                         s2d_stages=(), s2d_conv_backend="pallas",
                         s2d_attention="s2d", fused_stages=FUSED_STAGES,
                         decoder_backend="fused", dec_pipeline="gate_fold",
                         dec_fold=True, elu_fold=False, smax="window"):
    """Returns ``forward(x_nhwc, disp_scale=1.0)``: the full-resolution
    4-channel ``[l_disp, r_disp, l_unc, r_unc]`` map, (B, H, W, 4), of a
    (B, H, W, 3) image batch (the reference's eval output).

    Runs on CUDA unless ``device`` says otherwise; ``dtype`` is the type of
    the folded weights and activations.  The other arguments are the JAX
    package's build options, with its meanings (``build_serving_params``):
    ``s2d_stages``, ``s2d_conv_backend`` ("pallas": the ``gated_conv_elu``
    kernel; "lax": ``F.conv2d``), ``s2d_attention`` ("s2d" | "native"),
    ``fused_stages`` (any set the JAX package can run: no unfused stage
    after a fused one), ``decoder_backend`` ("fused"), ``dec_pipeline``
    ("gate_fold" | "gate_z" | "squeeze_first"), ``dec_fold``,
    ``elu_fold`` (a bool that changes nothing here) and ``smax``
    ("window" | "slice" | "nomax").  Unknown
    values raise ``ValueError``.  They are plain keyword arguments: the
    JAX package's ``UMT_*`` environment variables are not read.  The
    defaults are the benchmarked path, ``s2d_stages=()``, gate_fold and a
    max-subtracting softmax ("window"); the JAX package's own defaults are
    ``s2d_stages=(0, 1)`` and "nomax", which overflows at attention logits
    above ~88.
    """
    dev = resolve_device(device)
    (enc_specs, dec_specs), params = build_serving_params(
        model, dtype, dev, s2d_stages=tuple(s2d_stages),
        s2d_conv_backend=s2d_conv_backend, s2d_attention=s2d_attention,
        fused_stages=tuple(fused_stages), decoder_backend=decoder_backend,
        dec_pipeline=dec_pipeline, dec_fold=dec_fold, elu_fold=elu_fold,
        smax=smax)

    @torch.no_grad()
    def forward(x_nhwc, disp_scale=1.0):
        with span("serve"):
            return _forward(x_nhwc, disp_scale)

    def _forward(x_nhwc, disp_scale):
        x = nchw(x_nhwc.to(device=dev, dtype=dtype).contiguous())
        feats, h = [], x
        for i, (spec, prm) in enumerate(zip(enc_specs, params["encoder"])):
            with scope(f"enc{i}"):
                h = _encoder_stage(prm, spec, h)
            # the decoder takes native skips; an s2d stage hands its s2d
            # output on to a successor that reads s2d input, and the one
            # depth_to_space serves both the skip and any other successor
            emits_s2d = spec.s2d and not spec.attn_native
            native = nchw(depth_to_space(nhwc(h))) if emits_s2d else h
            feats.append(native)
            if not (i + 1 < len(enc_specs) and enc_specs[i + 1].s2d_in):
                h = native
        f1, f2, f3, f4, x4 = feats
        # the reference's hard-wired dataflow: the deepest map is its own skip
        fms = (f4, f3, f2, f1, x)
        out, skip, disp = x4, x4, None
        for i, (spec, prm, fm) in enumerate(zip(dec_specs, params["decoder"],
                                                fms)):
            stage = _fused_stage if spec["fused"] else _decoder_stage
            with scope(f"dec{i}"):
                out, skip, disp = stage(prm, spec, out, fm, skip, disp,
                                        disp_scale)
        return nhwc(disp).contiguous()

    return forward
