"""The port's forward timer (``utils/benchmark.py``) on the CPU
(``device="cpu"``), on the bf16 serving forward of the tiny model at
32x64: the samples, the number of passes, the chain of inputs (each pass's
input made from the one before it, as in the JAX module), and CUDA as the
default device, with no fallback to the CPU."""

import numpy as np
import pytest
import torch

from tiny_config import TINY_INPUT
from torch_port_helpers import PORT_MODEL

from uncertainty_model_tpu_torch.models import RandomlyConnectedModel
from uncertainty_model_tpu_torch.serving import make_serving_forward
from uncertainty_model_tpu_torch.utils import (
    measure_forward, measure_forward_samples)

K1, K2, REPS, BATCH = 1, 3, 2, 2


@pytest.fixture(scope="module")
def forward():
    model = RandomlyConnectedModel.from_config(**PORT_MODEL, seed=0,
                                               device="cpu").eval()
    return make_serving_forward(model, torch.bfloat16, device="cpu")


class Recorded:
    """``forward`` that records each pass's input and output; ``shift``
    is added to the output, so that the chain's 1e-6 perturbation shows
    in bf16 (it rounds away for outputs under ~4,000)."""

    def __init__(self, forward, shift=0.0):
        self.forward, self.shift = forward, shift
        self.inputs, self.outputs = [], []

    def __call__(self, x):
        out = self.forward(x) + self.shift
        self.inputs.append(x.clone())
        self.outputs.append(out.clone())
        return out


def _measure(fn, **kw):
    return measure_forward_samples(fn, BATCH, k1=K1, k2=K2, reps=REPS,
                                   image_hw=TINY_INPUT, device="cpu", **kw)


def test_samples_and_passes(forward):
    """``reps`` positive samples; ``(1 + reps) (k1 + k2)`` passes (a
    warm-up chain of each length, then each repetition's two), each on a
    bf16 (B, H, W, 3) input."""
    fn = Recorded(forward)
    samples = _measure(fn)
    assert len(samples) == REPS and all(s > 0 for s in samples)
    assert len(fn.inputs) == (1 + REPS) * (K1 + K2)
    assert all(x.dtype == torch.bfloat16 and x.shape == (BATCH, *TINY_INPUT, 3)
               for x in fn.inputs)
    assert measure_forward(forward, BATCH, k1=K1, k2=K2, reps=1,
                           image_hw=TINY_INPUT, device="cpu") > 0


def _chains(fn):
    """The recorded passes split into chains: k1, k2, then reps x (k1, k2)."""
    lengths = [K1, K2] * (1 + REPS)
    starts = np.cumsum([0] + lengths)
    return [list(range(a, a + n)) for a, n in zip(starts, lengths)]


def test_each_pass_takes_the_previous_output(forward):
    """Within a chain every pass sees a different input (checksums), each
    the previous input times ``1 + 1e-6 * out[..., :3]`` in bf16 exactly;
    every chain starts from 0.5."""
    fn = Recorded(forward, shift=2.0 ** 14)
    _measure(fn)
    for chain in _chains(fn):
        sums = [fn.inputs[i].double().sum().item() for i in chain]
        assert len(set(sums)) == len(chain)
        assert torch.equal(fn.inputs[chain[0]].float(),
                           torch.full((BATCH, *TINY_INPUT, 3), 0.5))
        for i, j in zip(chain, chain[1:]):
            x, out = fn.inputs[i], fn.outputs[i]
            assert torch.equal(fn.inputs[j],
                               x * (1.0 + 1e-6 * out[..., :3].to(x.dtype)))


def test_perturbation_leaves_the_input_of_the_real_forward(forward):
    """With the serving forward's own outputs (disparities and
    uncertainties, far below 4,000) the perturbation rounds away in bf16:
    every pass times the real input's work."""
    fn = Recorded(forward)
    _measure(fn)
    assert float(max(out.abs().max() for out in fn.outputs)) < 100
    assert all(torch.equal(x, fn.inputs[0]) for x in fn.inputs)


def test_cuda_is_the_default_device(forward, monkeypatch):
    """Without a card the default device raises before any pass: nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = Recorded(forward)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_forward_samples(fn, BATCH, image_hw=TINY_INPUT)
    assert fn.inputs == []
