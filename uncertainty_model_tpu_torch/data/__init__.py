"""Stereo datasets, their transforms, the PNG decoder and the threaded
loader."""

from .datasets import (
    CityScapesDataset,
    DaVinciDataset,
    SCAREDDataset,
    StereoPairDataset,
)
from .loader import DataLoader
from .transforms import (
    Compose,
    RandomAugment,
    RandomFlip,
    ResizeImage,
    ToArray,
    default_augment_transform,
    default_eval_transform,
)

__all__ = ["CityScapesDataset", "DaVinciDataset", "SCAREDDataset",
           "StereoPairDataset", "DataLoader", "Compose", "RandomAugment",
           "RandomFlip", "ResizeImage", "ToArray",
           "default_augment_transform", "default_eval_transform"]
