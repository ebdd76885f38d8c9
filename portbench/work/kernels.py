"""The work of the hand-written kernels, from shapes: each input read once,
each output written once, whatever the kernel reads again.

``assemble_z`` (K1) builds a fused decoder stage's concat tensor: the
skip upsampled 2x, the pixel-shuffled upsample, the upsampled disparity
and, where folded, the feature map's half of the squeeze conv.
``warp_rows`` (K2) warps rows of a source by a disparity, forward and
backward; a training step launches it 5 times each way.
"""

from __future__ import annotations

FOLD_MAX_CHANNELS = 8


def assemble_z_work(b, h, w, cso, cu, cd, cf, itemsize):
    """(bytes, f32 operations) of one assemble_z call at output size
    (h, w): ``cso`` skip channels, ``cu`` upsample channels, ``cd``
    disparity channels (0: none), ``cf`` feature channels folded in (0:
    none), elements of ``itemsize`` bytes."""
    h2, w2 = h // 2, w // 2
    pix = b * h * w
    nbytes = itemsize * (pix * (cf or cso) + b * h2 * w2 * (cso + 4 * cu + cd)
                         + pix * (cso + cu + cd)) + 4 * b * cso
    # per z element: 3 lerps (9), 2 adds, the ELU (1), the fold (2 cf)
    ops = pix * (cso * (12 + 2 * cf) + cu + 9 * cd)
    return nbytes, ops


def assemble_z_stages(model: dict, serving: dict, image_hw):
    """(name, h, w, cso, cu, cd, cf) of each decoder stage the serving
    forward fuses (``serving["fused_stages"]``)."""
    height, width = image_hw
    layers = model["decoder"]["layers"]
    out = []
    for s in serving["fused_stages"]:
        cfg = layers[s]
        scale = 2 ** (len(layers) - 1 - s)
        fm = cfg["feature_in_channels"]
        cf = fm if serving.get("dec_fold", True) and fm <= FOLD_MAX_CHANNELS \
            else 0
        cd = cfg.get("disp_channels", 2) if cfg.get("concat_disp", True) else 0
        out.append((f"dec{s}", height // scale, width // scale,
                    cfg["skip_out_channels"], cfg["upsample_channels"], cd, cf))
    return out


def warp_rows_work(rows, w, c):
    """((bytes, ops) forward, (bytes, ops) backward) of one warp problem of
    ``rows`` rows of width ``w`` and ``c`` channels, in f32."""
    pix = rows * w
    fwd = (4 * pix * (2 * c + 1), pix * (3 * c + 4))
    bwd = (4 * pix * (3 * c + 2), pix * (7 * c + 4))
    return fwd, bwd


def warp_groups(batch, image_hw, scales=4):
    """A training step's warp launches, each way: ([(rows, W), ...], C).
    The reconstructions of every scale and view in one launch (C 4: the
    image and the opposite disparity), then the uncertainty's consistency
    warps, one launch a scale (2 views, C 1)."""
    h, w = image_hw
    problems = [(batch * (h >> i), w >> i) for i in range(scales)]
    return ([([p for p in problems for _ in range(2)], 4)]
            + [([p, p], 1) for p in problems])


def warp_step_work(batch, image_hw, scales=4):
    """(bytes, ops) of a step's warps, forward and backward together."""
    nbytes = ops = 0
    for problems, c in warp_groups(batch, image_hw, scales):
        for rows, w in problems:
            (fb, fo), (bb, bo) = warp_rows_work(rows, w, c)
            nbytes += fb + bb
            ops += fo + bo
    return nbytes, ops
