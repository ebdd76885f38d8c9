"""Progress bars where ``tqdm`` is installed, and printed lines where it is
not (the card machine has no ``tqdm``)."""

from __future__ import annotations


def progress_bar(iterable, description: str):
    """``tqdm.tqdm(iterable, description, unit="batch")``, or None when
    ``tqdm`` cannot be imported: the caller then prints its progress."""
    try:
        import tqdm
    except ImportError:
        return None
    return tqdm.tqdm(iterable, description, unit="batch")
