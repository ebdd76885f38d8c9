"""Model configurations: the flagship's as Python data, and a reader for
the YAML files under ``configs/`` that needs no YAML package.

``FLAGSHIP_MODEL`` is the ``model:`` section of ``configs/uncertainty.yml``:
the reference's production architecture, 22.5M parameters at 256x512
input; ``FLAGSHIP_DISCRIMINATOR`` its ``discriminator:`` section (7.6M
parameters) and ``FLAGSHIP_LOSS`` its ``loss:`` section.
tests/test_torch_serving.py, tests/test_torch_discriminator.py and
tests/test_torch_train.py pin them equal to the file.

``load_config`` reads the subset of YAML that ``configs/*.yml`` use, with
the values ``yaml.load(f, Loader=yaml.Loader)`` gives them
(tests/test_torch_cli.py pins it): comments, block mappings nested by
indentation, block sequences of flow mappings (``- {k: v, ...}``, which may
span lines), and plain scalars: ints, floats with a decimal point,
``true``/``false`` and bare words.  Anything else (anchors, aliases, tags,
block scalars, quoted strings, several documents, tabs, nulls, the other
YAML 1.1 booleans, scalars ``yaml.Loader`` would read as another type)
raises ``ValueError`` naming the line.
"""

from __future__ import annotations

import re

FLAGSHIP_MODEL = {
    "encoder": {
        "load_graph": "graphs/nodes_5_seed_42",
        "nodes": 5,
        "seed": 42,
        "layers": [
            {"in_channels": 3, "out_channels": 32, "kernel_size": 7, "heads": 8},
            {"in_channels": 32, "out_channels": 64, "kernel_size": 5, "heads": 8},
            {"in_channels": 64, "out_channels": 128, "kernel_size": 3, "heads": 8},
            {"in_channels": 128, "out_channels": 256, "kernel_size": 3, "heads": 8},
            {"in_channels": 256, "out_channels": 512, "kernel_size": 3, "heads": 8},
        ],
    },
    "decoder": {
        "layers": [
            {"in_channels": 512, "feature_in_channels": 256,
             "skip_in_channels": 512, "upsample_channels": 128,
             "out_channels": 256, "skip_out_channels": 512,
             "concat_disp": False, "calculate_disp": False},
            {"in_channels": 256, "feature_in_channels": 128,
             "skip_in_channels": 512, "upsample_channels": 64,
             "out_channels": 256, "skip_out_channels": 256,
             "concat_disp": False, "calculate_disp": True,
             "disp_channels": 4},
            {"in_channels": 256, "feature_in_channels": 64,
             "skip_in_channels": 256, "upsample_channels": 32,
             "out_channels": 128, "skip_out_channels": 128,
             "concat_disp": True, "calculate_disp": True,
             "disp_channels": 4},
            {"in_channels": 128, "feature_in_channels": 32,
             "skip_in_channels": 128, "upsample_channels": 16,
             "out_channels": 64, "skip_out_channels": 64,
             "concat_disp": True, "calculate_disp": True,
             "disp_channels": 4},
            {"in_channels": 64, "feature_in_channels": 3,
             "skip_in_channels": 64, "upsample_channels": 8,
             "out_channels": 32, "skip_out_channels": 32,
             "concat_disp": True, "calculate_disp": True,
             "disp_channels": 4},
        ],
    },
}

# the ``discriminator:`` section of configs/uncertainty.yml: stage i > 0
# eats the previous stage's output and pyramid level i (6 more channels)
FLAGSHIP_DISCRIMINATOR = {
    "load_graph": "graphs/nodes_5_seed_42",
    "nodes": 5,
    "seed": 42,
    "layers": [
        {"in_channels": 6, "out_channels": 32, "kernel_size": 7, "heads": 8},
        {"in_channels": 38, "out_channels": 64, "kernel_size": 5, "heads": 8},
        {"in_channels": 70, "out_channels": 128, "kernel_size": 3,
         "heads": 8},
        {"in_channels": 134, "out_channels": 256, "kernel_size": 3,
         "heads": 8},
    ],
    "final_conv": {"in_channels": 256, "out_channels": 256, "kernel_size": 3,
                   "heads": 8},
    "linear_in_features": 32768,
}

# the ``loss:`` section of configs/uncertainty.yml (TukraUncertaintyLoss's
# keys; the adversarial ones are read only by the adversarial branch)
FLAGSHIP_LOSS = {
    "wssim_weight": 1.0,
    "consistency_weight": 1.0,
    "smoothness_weight": 1.0,
    "adversarial_weight": 0.85,
    "perceptual_weight": 0.05,
    "predictive_error_weight": 1.0,
    "wssim_alpha": 0.85,
    "perceptual_start": 5,
    "adversarial_loss_type": "mse",
    "error_loss_config": {
        "loss_type": "l1",
        "smoothness_weight": 0,
        "consistency_weight": 0.5,
        "pooling": False,
    },
}

# the flagship's input size (H, W)
FLAGSHIP_INPUT = (256, 512)


_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
# yaml.Loader's float needs a decimal point and a signed exponent
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?")
_WORD = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
# plain words that yaml.Loader (YAML 1.1) reads as booleans or null
_RESERVED = {"yes", "Yes", "YES", "no", "No", "NO", "True", "TRUE", "False",
             "FALSE", "on", "On", "ON", "off", "Off", "OFF", "null", "Null",
             "NULL"}


class _Line:
    def __init__(self, number: int, indent: int, text: str) -> None:
        self.number, self.indent, self.text = number, indent, text

    def error(self, what: str) -> ValueError:
        return ValueError(f"line {self.number}: {what} is outside the YAML "
                          f"subset of configs/*.yml")


def _strip_comment(text: str) -> str:
    for i, ch in enumerate(text):
        if ch == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i]
    return text


def _logical_lines(source: str) -> list[_Line]:
    """Non-blank lines without comments; a flow mapping that spans lines
    is joined into the line that opens it."""
    lines: list[_Line] = []
    pending = None
    for number, raw in enumerate(source.splitlines(), start=1):
        if "\t" in raw:
            raise _Line(number, 0, raw).error("a tab")
        text = _strip_comment(raw).rstrip()
        if not text.strip():
            continue
        if pending is not None:
            pending.text += " " + text.strip()
        else:
            stripped = text.lstrip(" ")
            if stripped in ("---", "...") or stripped.startswith("--- "):
                raise _Line(number, 0, raw).error("a document marker")
            pending = _Line(number, len(text) - len(stripped), stripped)
        if pending.text.count("{") == pending.text.count("}"):
            lines.append(pending)
            pending = None
    if pending is not None:
        raise pending.error("an unclosed flow mapping")
    return lines


def _scalar(token: str, line: _Line):
    if token == "true":
        return True
    if token == "false":
        return False
    if _INT.fullmatch(token):
        return int(token)
    if _FLOAT.fullmatch(token):
        return float(token)
    if _WORD.fullmatch(token) and token not in _RESERVED:
        return token
    raise line.error(f"the scalar {token!r}")


def _split_top(body: str, line: _Line) -> list[str]:
    """``body`` split at the commas outside nested braces."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(body):
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth < 0:
                raise line.error("an unbalanced '}'")
        elif ch == "," and depth == 0:
            parts.append(body[start:i])
            start = i + 1
    parts.append(body[start:])
    return [p.strip() for p in parts]


def _key(token: str, line: _Line) -> str:
    if not _KEY.fullmatch(token):
        raise line.error(f"the key {token!r}")
    return token


def _put(mapping: dict, key: str, value, line: _Line) -> None:
    if key in mapping:
        raise ValueError(f"line {line.number}: duplicate key {key!r}")
    mapping[key] = value


def _inline(text: str, line: _Line):
    """A flow mapping or a plain scalar."""
    if not text.startswith("{"):
        if any(ch in text for ch in "{}[],&*!|>'\"%@`"):
            raise line.error(f"the value {text!r}")
        return _scalar(text, line)
    if not text.endswith("}"):
        raise line.error("text after a flow mapping")
    mapping: dict = {}
    body = text[1:-1].strip()
    if not body:
        return mapping
    for item in _split_top(body, line):
        key, sep, value = item.partition(": ")
        if not sep or not value.strip():
            raise line.error(f"the flow entry {item!r}")
        _put(mapping, _key(key.strip(), line), _inline(value.strip(), line),
             line)
    return mapping


def _block(lines: list[_Line], i: int, indent: int):
    """The block (mapping or sequence) whose lines start at ``lines[i]``
    with ``indent``; returns (value, index of the next line)."""
    if lines[i].text.startswith("- ") or lines[i].text == "-":
        items = []
        while (i < len(lines) and lines[i].indent == indent
               and lines[i].text.startswith("- ")):
            item = lines[i].text[2:].strip()
            if not item.startswith("{") and ": " in item:
                raise lines[i].error("a block mapping in a sequence")
            items.append(_inline(item, lines[i]))
            i += 1
        if i < len(lines) and lines[i].indent >= indent:
            raise lines[i].error("a line after a sequence")
        return items, i

    mapping: dict = {}
    while i < len(lines) and lines[i].indent == indent:
        line = lines[i]
        key, sep, rest = line.text.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise line.error(f"the line {line.text!r}")
        key, rest = _key(key, line), rest.strip()
        i += 1
        if rest:
            _put(mapping, key, _inline(rest, line), line)
            continue
        nested = i < len(lines) and (
            lines[i].indent > indent
            or (lines[i].indent == indent and lines[i].text.startswith("- ")))
        if not nested:
            raise line.error(f"the empty value of {key!r}")
        value, i = _block(lines, i, lines[i].indent)
        _put(mapping, key, value, line)
    if i < len(lines) and lines[i].indent > indent:
        raise lines[i].error("an unexpected indentation")
    return mapping, i


def load_config(path: str) -> dict:
    """The mapping in the YAML file ``path`` (a ``configs/*.yml``), read as
    ``yaml.load(f, Loader=yaml.Loader)`` reads it; raises ``ValueError``
    naming the line of anything outside the subset the module docstring
    lists."""
    with open(path) as f:
        lines = _logical_lines(f.read())
    if not lines:
        raise ValueError(f"{path}: no mapping")
    if lines[0].indent:
        raise lines[0].error("an indented first line")
    config, i = _block(lines, 0, 0)
    if i < len(lines):
        raise lines[i].error("a line outside the top-level mapping")
    if not isinstance(config, dict):
        raise lines[0].error("a top-level sequence")
    return config
