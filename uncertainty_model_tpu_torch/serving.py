"""Serving forward of the eval model (the port of the JAX package's
``serving.py`` on its benchmarked path: ``s2d_stages=()``, fused decoder
stages (2, 3, 4), the ``gate_fold`` pipeline).

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

``gate_fold``: the SE gates are not written into the concat tensor; they
scale the iconv's input and the next stage's skip-conv input instead.
Softmaxes subtract their max and sum in f32 (the JAX package's default
drops the max; the two are equal in exact arithmetic and this one cannot
overflow).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .device import resolve_device
from .models.graph import GraphSpec
from .models.layers import nchw, nhwc, reflect_conv, softmax_f32
from .ops import resize_bilinear
from .ops.decoder_fused import assemble_z

FUSED_STAGES = (2, 3, 4)
FOLD_MAX_CHANNELS = 8


class EncoderSpec(NamedTuple):
    graph: GraphSpec
    heads: int


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


@torch.no_grad()
def build_serving_params(model, dtype=torch.bfloat16, device=None):
    """Fold ``model``'s weights into serving parameters of type ``dtype``
    on ``device`` (default: the model's).  Returns ``(specs, params)``:
    ``specs`` is static structure, ``params`` nested dicts of tensors."""
    if device is None:
        device = next(model.parameters()).device

    def put(t):
        t = t.detach().to(device=device, dtype=dtype)
        return t.contiguous(memory_format=torch.channels_last) \
            if t.ndim == 4 else t.contiguous()

    enc_specs, enc_params = [], []
    for stage in model.encoder.layers:
        graph_block, attention = stage.layers
        nodes = {}
        for node, nb in zip(graph_block.graph.nodes, graph_block.node_blocks):
            conv, bn = nb.convolution.layers[0], nb.convolution.layers[1]
            w, b = _fold_bn(conv.weight, conv.bias, bn)
            entry = {"w": put(w), "b": put(b)}
            if nb.n_inputs > 1:
                entry["gates"] = put(_node_gates(nb))
            nodes[node.id] = entry
        attn = {name: (put(getattr(attention, name).weight[:, :, 0, 0]),
                       put(getattr(attention, name).bias))
                for name in ("keys", "queries", "values", "reprojection")}
        enc_specs.append(EncoderSpec(graph_block.graph, attention.head_count))
        enc_params.append({"nodes": nodes, "attention": attn})

    dec_specs, dec_params = [], []
    prev_fused_ccat = None
    for i, st in enumerate(model.decoder.layers):
        fused = i in FUSED_STAGES
        if fused and st.scale != 2:
            raise ValueError(f"decoder stage {i} has scale {st.scale}; the "
                             "fused stages need scale 2")
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
            spec["fold"] = cf <= FOLD_MAX_CHANNELS
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


def _attention(prm, heads, x):
    """EfficientAttention on folded params; 1x1 convs as token matmuls."""
    b, c, h, w = x.shape
    tokens = nhwc(x).reshape(b, h * w, c)

    def proj(name):
        return F.linear(tokens, *prm[name]).reshape(b, h * w, heads, -1)

    keys = softmax_f32(proj("keys"), 1)         # over tokens
    queries = softmax_f32(proj("queries"), -1)  # over head channels
    context = torch.einsum("bnhk,bnhv->bhkv", keys, proj("values"))
    attended = torch.einsum("bhkv,bnhk->bnhv", context, queries)
    out = F.linear(attended.reshape(b, h * w, c), *prm["reprojection"])
    return nchw(out.reshape(b, h, w, c)) + x


def _encoder_stage(prm, spec: EncoderSpec, x):
    graph = spec.graph
    results = {}
    for nid in graph.in_nodes:
        p = prm["nodes"][nid]
        pad = (p["w"].shape[-1] - 1) // 2
        results[nid] = F.elu(F.conv2d(x, p["w"], p["b"], stride=2, padding=pad))
    for node in graph.nodes:
        if node.id in results:
            continue
        p = prm["nodes"][node.id]
        inputs = [results[j] for j in node.inputs]
        if len(inputs) > 1:
            if any(t.shape != inputs[0].shape for t in inputs[1:]):
                raise ValueError(
                    f"serving path: unequal node resolutions at node {node.id} "
                    f"({[tuple(t.shape) for t in inputs]}); unreachable for "
                    "stages built from stride-2 input nodes and stride-1 "
                    "interiors — the eval model carries the reference's "
                    "resize alignment for such stages")
            g = p["gates"]
            h = g[0] * inputs[0]
            for gi, t in enumerate(inputs[1:], start=1):
                h = h + g[gi] * t
        else:
            h = inputs[0]
        pad = (p["w"].shape[-1] - 1) // 2
        results[node.id] = F.elu(F.conv2d(h, p["w"], p["b"], padding=pad))
    out = results[graph.out_nodes[0]]
    for nid in graph.out_nodes[1:]:
        out = out + results[nid]
    out = out / len(graph.out_nodes)
    return _attention(prm["attention"], spec.heads, out)


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
    """Fused stage (gate_fold).  ``skip`` is a plain tensor or the previous
    fused stage's ``(cat, gate_scale)``; returns ``(out, (cat, gate_scale),
    disp)``, whose middle item is the next fused stage's skip."""
    if isinstance(skip, tuple):
        cat_prev, scale = skip
        skip = cat_prev * scale[:, :, None, None]
    skip_feat_h = F.conv2d(skip, prm["se_skip"])
    xc = reflect_conv(x, *prm["upsample"])
    if spec["fold"]:
        se_in, k_fm = fm, prm["k_fm"]
    else:
        se_in, k_fm = F.conv2d(fm, prm["se_fm"]), None
    dh = nhwc(disparity).contiguous() if spec["concat_disp"] else None
    cat, mean = assemble_z(nhwc(se_in).contiguous(),
                           nhwc(skip_feat_h).contiguous(),
                           nhwc(xc).contiguous(), dh, prm["se_bias"],
                           k_fm=k_fm)
    gates = _se_gates(prm["se"], mean, cat.dtype)
    scale = torch.cat([gates, gates.new_ones(
        gates.shape[0], cat.shape[-1] - spec["cso"])], dim=1)
    cat = nchw(cat)
    out = F.elu(reflect_conv(cat * scale[:, :, None, None], *prm["iconv"]))
    disp = None
    if spec["calculate_disp"]:
        disp = disp_scale * torch.sigmoid(reflect_conv(out, *prm["disp"]))
    return out, (cat, scale), disp


def make_serving_forward(model, dtype=torch.bfloat16, device=None, *,
                         s2d_stages=(), fused_stages=FUSED_STAGES,
                         dec_pipeline="gate_fold", elu_fold=False):
    """Returns ``forward(x_nhwc, disp_scale=1.0)``: the full-resolution
    4-channel ``[l_disp, r_disp, l_unc, r_unc]`` map, (B, H, W, 4), of a
    (B, H, W, 3) image batch (the reference's eval output).

    Runs on CUDA unless ``device`` says otherwise; ``dtype`` is the type of
    the folded weights and activations.  The remaining arguments name the
    JAX package's build options; only the benchmarked path is ported, and
    any other value raises ``ValueError``.
    """
    if tuple(s2d_stages):
        raise ValueError("space-to-depth encoder stages are not ported")
    if tuple(fused_stages) != FUSED_STAGES:
        raise ValueError(f"fused_stages must be {FUSED_STAGES}")
    if dec_pipeline != "gate_fold":
        raise ValueError(f"dec_pipeline {dec_pipeline!r} is not ported")
    if elu_fold:
        raise ValueError("elu_fold is not ported")
    dev = resolve_device(device)
    (enc_specs, dec_specs), params = build_serving_params(model, dtype, dev)

    @torch.no_grad()
    def forward(x_nhwc, disp_scale=1.0):
        x = nchw(x_nhwc.to(device=dev, dtype=dtype).contiguous())
        feats, h = [], x
        for spec, prm in zip(enc_specs, params["encoder"]):
            h = _encoder_stage(prm, spec, h)
            feats.append(h)
        f1, f2, f3, f4, x4 = feats
        # the reference's hard-wired dataflow: the deepest map is its own skip
        fms = (f4, f3, f2, f1, x)
        out, skip, disp = x4, x4, None
        for spec, prm, fm in zip(dec_specs, params["decoder"], fms):
            stage = _fused_stage if spec["fused"] else _decoder_stage
            out, skip, disp = stage(prm, spec, out, fm, skip, disp,
                                    disp_scale)
        return nhwc(disp).contiguous()

    return forward
