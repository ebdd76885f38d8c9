"""The eval model and the discriminator (nn.Modules with the reference's
state_dict keys)."""

from .discriminator import RandomDiscriminator
from .model import RandomlyConnectedModel

__all__ = ["RandomDiscriminator", "RandomlyConnectedModel"]
