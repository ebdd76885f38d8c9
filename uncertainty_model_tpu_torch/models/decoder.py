"""Multi-scale disparity + uncertainty decoder (reference model/decoder.py).

Five DecoderStages with the reference's hard-wired dataflow
(model/decoder.py:49-57): the deepest feature map is its own skip, and
disparity first appears at stage 1 (1/8 resolution).  Each disparity map
has 4 channels [left_disp, right_disp, left_unc, right_unc].
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from .layers import DecoderStage


class DepthDecoder(nn.Module):
    def __init__(self, layers: Sequence[dict]):
        super().__init__()
        if len(layers) != 5:
            raise ValueError(f"the decoder has 5 stages, not {len(layers)}")
        self.layers = nn.ModuleList(DecoderStage(**cfg) for cfg in layers)

    def forward(self, left_image, *feature_maps, disp_scale=1.0):
        """Returns (full, 1/2, 1/4, 1/8)-resolution disparity maps."""
        f1, f2, f3, f4, x4 = feature_maps
        s = self.layers
        out5, skip5, _ = s[0](x4, f4, x4, disp_scale=disp_scale)
        out4, skip4, disp4 = s[1](out5, f3, skip5, disp_scale=disp_scale)
        out3, skip3, disp3 = s[2](out4, f2, skip4, disp4, disp_scale)
        out2, skip2, disp2 = s[3](out3, f1, skip3, disp3, disp_scale)
        _, _, disp1 = s[4](out2, left_image, skip2, disp2, disp_scale)
        return disp1, disp2, disp3, disp4
