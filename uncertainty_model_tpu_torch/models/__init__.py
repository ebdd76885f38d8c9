"""The eval model (nn.Modules with the reference's state_dict keys)."""

from .model import RandomlyConnectedModel

__all__ = ["RandomlyConnectedModel"]
