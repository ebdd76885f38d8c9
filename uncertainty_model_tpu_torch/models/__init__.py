"""The eval model and the discriminator (nn.Modules with the reference's
state_dict keys), their stages and the stage graphs."""

from .decoder import DepthDecoder
from .discriminator import RandomDiscriminator
from .encoder import RandomEncoder, resolve_encoder_graphs
from .graph import (GraphSpec, Node, build_graph_spec, graph_spec_from_edges,
                    graph_spec_from_nx, load_graph_spec, resolve_stage_graph,
                    save_graph_spec)
from .layers import (ConvBNELU, ConvLayer, DecoderConvELU, DecoderStage,
                     EfficientAttention, EncoderStage, GraphBlock, NodeBlock,
                     SELayer)
from .model import RandomlyConnectedModel

__all__ = ["ConvBNELU", "ConvLayer", "DecoderConvELU", "DecoderStage",
           "DepthDecoder", "EfficientAttention", "EncoderStage", "GraphBlock",
           "GraphSpec", "Node", "NodeBlock", "RandomDiscriminator",
           "RandomEncoder", "RandomlyConnectedModel", "SELayer",
           "build_graph_spec", "graph_spec_from_edges", "graph_spec_from_nx",
           "load_graph_spec", "resolve_encoder_graphs", "resolve_stage_graph",
           "save_graph_spec"]
