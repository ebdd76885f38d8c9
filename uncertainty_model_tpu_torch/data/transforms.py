"""Stereo-pair transforms (the port of the JAX package's
``data/transforms.py``; reference train/transforms.py).

Every transform takes and returns a ``{"left", "right"}`` dict of HWC
arrays: uint8 as decoded (``data/native.py::decode_png``), float32 in
[0, 1] after ``ResizeImage`` or ``ToArray``.  Randomness is drawn from an
explicit ``numpy.random.Generator`` in the JAX package's order (the flip's
``rng.random()``, then the augmentation's ``rng.random()``, gamma,
brightness and the 3 colour factors), so the same generator gives the same
flips and jitter.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .native import resize_rgb8


class Compose:
    def __init__(self, transforms: list) -> None:
        self.transforms = transforms

    def __call__(self, pair: dict,
                 rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng if rng is not None else np.random.default_rng()
        for t in self.transforms:
            pair = t(pair, rng)
        return pair


class ResizeImage:
    """PIL-bilinear resize of both views to (H, W) (reference
    transforms.py:15-29, torchvision's Resize on PIL images): uint8 in,
    float32 in [0, 1] out, by the triangle filter of ``data/native.py``,
    which keeps the float where PIL rounds to uint8 between its passes (the
    JAX package's native backend gives the same floats)."""

    def __init__(self, size: tuple[int, int] = (256, 512)) -> None:
        self.size = size

    def __call__(self, pair: dict, rng=None) -> dict:
        h, w = self.size
        return {"left": resize_rgb8(pair["left"], h, w),
                "right": resize_rgb8(pair["right"], h, w)}


class RandomFlip:
    """Same horizontal flip applied to both views, p=0.5
    (reference transforms.py:44-60)."""

    def __init__(self, p: float = 0.5) -> None:
        self.probability = p

    def __call__(self, pair: dict, rng: np.random.Generator) -> dict:
        if rng.random() < self.probability:
            pair = {"left": np.ascontiguousarray(pair["left"][:, ::-1]),
                    "right": np.ascontiguousarray(pair["right"][:, ::-1])}
        return pair


def _to_unit(image: np.ndarray) -> np.ndarray:
    if image.dtype == np.uint8:
        return np.asarray(image, np.float32) / 255.0
    if image.dtype == np.float32:  # resized: already in [0, 1]
        return image
    raise TypeError(f"expected a uint8 or float32 image, got {image.dtype}")


class ToArray:
    """uint8 -> HWC float32 in [0, 1] (the reference's ToTensor, minus the
    CHW transpose); a float32 view, which ``ResizeImage`` has already put
    in [0, 1], passes unchanged."""

    def __call__(self, pair: dict, rng=None) -> dict:
        return {"left": _to_unit(pair["left"]),
                "right": _to_unit(pair["right"])}


class RandomAugment:
    """Shared gamma/brightness/per-channel colour jitter + clamp
    (reference transforms.py:63-129)."""

    def __init__(self, p: float, gamma: tuple[float, float],
                 brightness: tuple[float, float],
                 colour: tuple[float, float]) -> None:
        self.probability = p
        self.gamma = gamma
        self.brightness = brightness
        self.colour = colour

    def _apply(self, x: np.ndarray, g: float, b: float,
               c: np.ndarray) -> np.ndarray:
        x = x**g
        x = x * b
        x = x * c[None, None, :]
        return np.clip(x, 0.0, 1.0).astype(np.float32)

    def __call__(self, pair: dict, rng: np.random.Generator) -> dict:
        if rng.random() < self.probability:
            g = rng.uniform(*self.gamma)
            b = rng.uniform(*self.brightness)
            c = rng.uniform(*self.colour, 3).astype(np.float32)
            pair = {"left": self._apply(pair["left"], g, b, c),
                    "right": self._apply(pair["right"], g, b, c)}
        return pair


def default_augment_transform(size=(256, 512)) -> Compose:
    """The reference's training transform stack (main.py:78-88)."""
    return Compose([
        ResizeImage(size),
        RandomFlip(0.5),
        ToArray(),
        RandomAugment(0.5, gamma=(0.8, 1.2), brightness=(0.5, 2.0),
                      colour=(0.8, 1.2)),
    ])


def default_eval_transform(size=(256, 512)) -> Compose:
    return Compose([ResizeImage(size), ToArray()])
