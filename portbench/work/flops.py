"""The flagship's operations, counted from its configuration's shapes.

Convs, linear layers and the attention's two products, 2 operations a
multiply-add, at a given batch and input size: the model's own work,
whatever kernels or folds the program runs it with.  A decoder stage's
1x1 squeeze conv is counted as the least work that computes it: its
skip half at the skip's own resolution, before the 2x resize (a 1x1 conv
and a bilinear resize commute exactly), its feature half at the
output's.  Elementwise work, resizes and BatchNorm are left out (they are
bytes, not operations).  A training step is counted as three forwards
(forward plus a backward of twice its products).
"""

from __future__ import annotations


def _conv(b, h, w, cin, cout, k):
    return 2 * b * h * w * cin * cout * k * k


def forward_flops(model: dict, graphs, batch: int, image_hw) -> int:
    """Operations of one forward of ``model`` (a configuration's
    ``model`` section, with ``graphs`` the stages' DAGs) over ``batch``
    images of ``image_hw``."""
    h, w = image_hw
    total = 0
    for cfg, graph in zip(model["encoder"]["layers"], graphs):
        h, w = (h + 1) // 2, (w + 1) // 2
        cin, c, k = cfg["in_channels"], cfg["out_channels"], cfg["kernel_size"]
        for node in graph.nodes:
            total += _conv(batch, h, w, cin if node.is_input else c, c, k)
        heads = cfg.get("heads", 8)
        d = c // heads
        total += 4 * _conv(batch, h, w, c, c, 1)          # k, q, v, reprojection
        total += 2 * 2 * batch * h * w * heads * d * d    # context, attended
    for cfg in model["decoder"]["layers"]:
        up, skip = cfg["upsample_channels"], cfg["skip_out_channels"]
        total += _conv(batch, h, w, cfg["in_channels"], 4 * up, 3)
        total += _conv(batch, h, w, cfg["skip_in_channels"], skip, 1)
        h, w = 2 * h, 2 * w
        total += _conv(batch, h, w, cfg["feature_in_channels"], skip, 1)
        total += 2 * 2 * batch * skip * (skip // 16)      # the SE linears
        disp = cfg.get("disp_channels", 2)
        iconv_in = up + skip + (disp if cfg.get("concat_disp", True) else 0)
        total += _conv(batch, h, w, iconv_in, cfg["out_channels"], 3)
        if cfg.get("calculate_disp", True):
            total += _conv(batch, h, w, cfg["out_channels"], disp, 3)
    return total


def train_step_flops(model: dict, graphs, batch: int, image_hw) -> int:
    """Operations of one training step: three forwards' worth."""
    return 3 * forward_flops(model, graphs, batch, image_hw)
