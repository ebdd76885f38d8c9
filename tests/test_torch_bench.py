"""The port's bench (``uncertainty_model_tpu_torch/bench.py``) on the CPU:

- its forward (``bench_forward``) against the JAX package's
  ``make_serving_forward(model, variables, s2d_stages=())`` with no
  ``UMT_*`` variable set (``bench.py``'s forward), on the tiny model's
  weights, at batch 2: f32 within 1e-4 (rtol, as test_torch_serving's
  options), bf16 within 0.05 (max abs);
- the options it passes are each named, and they are the JAX package's
  defaults: the JAX forward built with them equals the one built with
  none, bit for bit;
- the printed last line parses to exactly ``metric``, ``value``, ``unit``
  and ``spread``; the value is the batch over the median sample and the
  spread ``(max - min) / median``, as ``bench.py`` computes them;
- its model is the flagship, and without a card it raises.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tiny_config import TINY_INPUT
from torch_port_helpers import images, models as build_models

import uncertainty_model_tpu.ops.pallas.decoder_fused as jdf
from uncertainty_model_tpu.serving import make_serving_forward as jax_serving

from uncertainty_model_tpu_torch import bench
from uncertainty_model_tpu_torch.utils import benchmark

BATCH = 2
F32_RTOL, F32_ATOL = 1e-4, 1e-5
BF16_VS_JAX = 0.05
FLAGSHIP_PARAMS = 22_493_949
JAX_DEFAULTS = {"s2d_stages": (), "fused_stages": (2, 3, 4),
                "dec_pipeline": "gate_fold", "dec_fold": True,
                "elu_fold": False, "smax": "nomax"}
UMT_VARIABLES = ("UMT_DEC_PIPELINE", "UMT_DEC_FOLD", "UMT_ELU_FOLD",
                 "UMT_SMAX")


@pytest.fixture(scope="module")
def models():
    return build_models("fc")


@pytest.fixture
def jax_defaults(monkeypatch):
    """The JAX package's build with no ``UMT_*`` variable set, its glue in
    Pallas interpret mode."""
    for name in UMT_VARIABLES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jdf, "_INTERPRET", True)


def _jax_bench_forward(jmodel, variables, x, dtype, **options):
    fwd, params = jax_serving(jmodel, variables, s2d_stages=(), dtype=dtype,
                              **options)
    out = jax.jit(fwd)(params, jnp.asarray(x))
    return np.asarray(out).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bench_forward_matches_jax_bench(models, jax_defaults, dtype):
    jmodel, variables, model = models
    x = images(70, batch=BATCH)
    want = _jax_bench_forward(jmodel, variables, x,
                              None if dtype == "float32" else jnp.bfloat16)
    got = bench.bench_forward(model, getattr(torch, dtype), device="cpu")(
        torch.from_numpy(x))
    assert got.shape == want.shape == (BATCH, *TINY_INPUT, 4)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= BF16_VS_JAX


def test_bench_options_are_the_jax_defaults(models, jax_defaults,
                                            monkeypatch):
    jmodel, variables, model = models
    seen = {}

    def recording(model, dtype, device, **options):
        seen.update(options)
        return "forward"

    monkeypatch.setattr(bench, "make_serving_forward", recording)
    assert bench.bench_forward(model, device="cpu") == "forward"
    assert seen == JAX_DEFAULTS
    x = images(71, batch=1)
    named = {k: v for k, v in JAX_DEFAULTS.items() if k != "s2d_stages"}
    np.testing.assert_array_equal(
        _jax_bench_forward(jmodel, variables, x, jnp.bfloat16, **named),
        _jax_bench_forward(jmodel, variables, x, jnp.bfloat16))


@pytest.fixture
def tiny_bench(models, monkeypatch):
    """The bench on the tiny model at 32x64, chains of 1 and 2 passes."""
    monkeypatch.setattr(bench, "bench_model", lambda device: models[2])
    monkeypatch.setattr(bench, "measure_forward_samples", functools.partial(
        benchmark.measure_forward_samples, image_hw=TINY_INPUT, k1=1, k2=2))


def test_bench_prints_one_json_line(tiny_bench, capsys):
    bench.main(["-v", "--device", "cpu", "--batch", str(BATCH)])
    lines = capsys.readouterr().out.splitlines()
    result = json.loads(lines[-1])
    assert set(result) == {"metric", "value", "unit", "spread"}
    assert result["metric"] == "inference_fps_per_chip"
    assert result["unit"] == "frames/sec"
    assert result["value"] > 0 and result["spread"] >= 0
    assert lines[:-1] and all(ln.startswith("[bench] ") for ln in lines[:-1])
    assert f"at batch {BATCH}" in lines[-2]


def test_bench_value_and_spread(models, monkeypatch):
    """fps = batch / the median of the 9 samples; spread = (max - min) /
    median; ``REPS`` samples asked for."""
    samples = [0.5, 0.1, 0.3, 0.2, 0.4, 0.25, 0.35, 0.15, 0.45]
    asked = {}

    def fake(forward, batch, *, reps, device):
        asked.update(batch=batch, reps=reps, device=device)
        return list(samples)

    monkeypatch.setattr(bench, "bench_model", lambda device: models[2])
    monkeypatch.setattr(bench, "measure_forward_samples", fake)
    result = bench.bench(device="cpu", batch=BATCH)
    assert asked == {"batch": BATCH, "reps": 9,
                     "device": torch.device("cpu")}
    assert result == {"metric": "inference_fps_per_chip",
                      "value": round(BATCH / 0.3, 1), "unit": "frames/sec",
                      "spread": round((0.5 - 0.1) / 0.3, 4)}


def test_bench_model_is_the_flagship():
    model = bench.bench_model("cpu")
    assert sum(p.numel() for p in model.parameters()) == FLAGSHIP_PARAMS
    assert not model.training
    assert bench.BATCH == 128


@pytest.mark.parametrize("argv", [[], ["--batch", "2"]])
def test_bench_default_device_is_cuda(argv):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(argv)
