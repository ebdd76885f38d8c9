"""Stereo-pair datasets: Hamlyn da Vinci, SCARED, CityScapes (the port of
the JAX package's ``data/datasets.py``).

Directory layouts and pairing rules mirror the reference loaders
(loaders/davinci.py, loaders/scared.py, loaders/cityscapes.py): glob left and
right .png trees, drop unmatched IDs, optional ``limit``.

The reference has two pairing quirks (SURVEY.md #32): its missing-pair filter
compares full paths against basenames (so it never removes anything,
davinci.py:58-64) and ``limit`` slices the *unsorted* glob order
(davinci.py:66-67).  Default here is the fixed behaviour (filter by basename,
sort before slicing); ``parity_quirks=True`` reproduces the reference
exactly for comparison runs.  Items are decoded by ``data/native.py``.
"""

from __future__ import annotations

import glob
import os.path
import re
from typing import Callable, Optional

from .native import decode_png


class StereoPairDataset:
    """Base: pairs of left/right PNG paths + per-item transform."""

    def __init__(self, lefts: list[str], rights: list[str],
                 transform: Optional[Callable] = None) -> None:
        self.lefts = lefts
        self.rights = rights
        self.transform = transform

    @staticmethod
    def _pair(left_images: list[str], right_images: list[str],
              limit: Optional[int], parity_quirks: bool) -> tuple[list[str], list[str]]:
        left_names = set(map(os.path.basename, left_images))
        right_names = set(map(os.path.basename, right_images))
        missing = left_names.symmetric_difference(right_names)

        if missing:
            print(f"Missing {len(missing):,} images from the dataset.")
            if parity_quirks:
                # reference compares full paths against basenames -> no-op
                left_images = [i for i in left_images if i not in missing]
                right_images = [i for i in right_images if i not in missing]
            else:
                left_images = [i for i in left_images
                               if os.path.basename(i) not in missing]
                right_images = [i for i in right_images
                                if os.path.basename(i) not in missing]
            print(f"Dataset reduced to {len(left_images):,} images.")

        if parity_quirks:
            lefts = sorted(left_images[:limit])
            rights = sorted(right_images[:limit])
        else:
            lefts = sorted(left_images)[:limit]
            rights = sorted(right_images)[:limit]
        return lefts, rights

    def __len__(self) -> int:
        return len(self.lefts)

    def __getitem__(self, idx: int) -> dict:
        pair = {"left": decode_png(self.lefts[idx]),
                "right": decode_png(self.rights[idx])}
        if self.transform is not None:
            pair = self.transform(pair)
        return pair


class DaVinciDataset(StereoPairDataset):
    """Hamlyn da Vinci: ``{split}/image_0|image_1/*.png`` (loaders/davinci.py)."""

    LEFT_PATH = "image_0"
    RIGHT_PATH = "image_1"

    def __init__(self, root: str, split: str, transform=None,
                 limit: Optional[int] = None, parity_quirks: bool = False) -> None:
        if split not in ("train", "test"):
            raise ValueError('Split must be either "train" or "test".')
        lefts = glob.glob(os.path.join(root, split, self.LEFT_PATH, "*.png"))
        rights = glob.glob(os.path.join(root, split, self.RIGHT_PATH, "*.png"))
        lefts, rights = self._pair(lefts, rights, limit, parity_quirks)
        super().__init__(lefts, rights, transform)


class SCAREDDataset(StereoPairDataset):
    """SCARED: ``{split}/dataset_*/keyframe_*/left|right/*.png``
    (loaders/scared.py)."""

    def __init__(self, root: str, split: str, transform=None,
                 limit: Optional[int] = None, parity_quirks: bool = False) -> None:
        if split not in ("train", "test"):
            raise ValueError('Split must be either "train" or "test".')
        lefts = glob.glob(
            os.path.join(root, split, "dataset_*", "keyframe_*", "left", "*.png"))
        rights = glob.glob(
            os.path.join(root, split, "dataset_*", "keyframe_*", "right", "*.png"))
        lefts, rights = self._pair(lefts, rights, limit, parity_quirks)
        super().__init__(lefts, rights, transform)


class CityScapesDataset(StereoPairDataset):
    """CityScapes: ``leftImg8bit|rightImg8bit/{split}/**/*.png`` with regex ID
    pairing (loaders/cityscapes.py)."""

    FILENAME_REGEX = re.compile(r"([a-z]+_\d+_\d+)_(\w+)\.(\w+)")

    def __init__(self, root: str, split: str, transform=None,
                 limit: Optional[int] = None, parity_quirks: bool = False) -> None:
        if split not in ("train", "val", "test"):
            raise ValueError('Split must be either "train", "val" or "test".')
        lefts = glob.glob(os.path.join(root, "leftImg8bit", split, "**", "*.png"))
        rights = glob.glob(os.path.join(root, "rightImg8bit", split, "**", "*.png"))

        left_ids = set(self._image_ids(lefts))
        right_ids = set(self._image_ids(rights))
        missing = left_ids.symmetric_difference(right_ids)
        if missing:
            print(f"Missing {len(missing):,} images from the dataset.")
            if not parity_quirks:
                lefts = [p for p in lefts
                         if self._image_id(p) not in missing]
                rights = [p for p in rights
                          if self._image_id(p) not in missing]
            else:  # reference filters paths against IDs -> no-op
                lefts = [p for p in lefts if p not in missing]
                rights = [p for p in rights if p not in missing]
            print(f"Dataset reduced to {len(lefts):,} images.")

        if parity_quirks:
            lefts, rights = sorted(lefts[:limit]), sorted(rights[:limit])
        else:
            lefts, rights = sorted(lefts)[:limit], sorted(rights)[:limit]
        super().__init__(lefts, rights, transform)

    @classmethod
    def _image_id(cls, path: str) -> Optional[str]:
        m = cls.FILENAME_REGEX.match(os.path.basename(path))
        return m.group(1) if m else None

    @classmethod
    def _image_ids(cls, paths: list[str]) -> list[str]:
        ids = (cls._image_id(p) for p in paths)
        return [i for i in ids if i is not None]
