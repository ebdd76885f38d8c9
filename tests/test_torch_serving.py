"""The port's serving forward against the JAX package's
``make_serving_forward(s2d_stages=())`` on the same weights and inputs, and
the port's hygiene: no JAX, CUDA by default, off-path options refused."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from torch_port_helpers import (
    images, models as build_models, to_nchw, to_nhwc_numpy)

from uncertainty_model_tpu.serving import make_serving_forward as jax_serving

from uncertainty_model_tpu_torch.config import FLAGSHIP_MODEL
from uncertainty_model_tpu_torch.ops.decoder_fused import assemble_z
from uncertainty_model_tpu_torch.serving import make_serving_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "uncertainty_model_tpu_torch")


@pytest.fixture(scope="module")
def models():
    return build_models("fc")


def _jax_forward(jmodel, variables, x, disp_scale, **kw):
    fwd, params = jax_serving(jmodel, variables, s2d_stages=(), **kw)
    out = jax.jit(lambda p, x: fwd(p, x, disp_scale))(params, jnp.asarray(x))
    return np.asarray(out).astype(np.float32)


@pytest.mark.parametrize("smax", ["nomax", "window"])
def test_f32_matches_jax_serving(models, smax):
    """Default (nomax) and max-subtracting (window) JAX softmaxes: the
    port's max-subtracting softmax equals both in f32."""
    jmodel, variables, model = models
    x = images(42)
    want = _jax_forward(jmodel, variables, x, 0.7, dtype=None, smax=smax)
    got = make_serving_forward(model, torch.float32, device="cpu")(
        torch.from_numpy(x), disp_scale=0.7)
    assert got.shape == want.shape == (2, 32, 64, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_f32_matches_eval_model(models):
    _, _, model = models
    x = images(43)
    with torch.no_grad():
        want = to_nhwc_numpy(model(to_nchw(x), disp_scale=0.7)[0])
    got = make_serving_forward(model, torch.float32, device="cpu")(
        torch.from_numpy(x), disp_scale=0.7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_conv_se_variant_matches_jax_serving():
    jmodel, variables, model = build_models("conv_se")
    x = images(44)
    want = _jax_forward(jmodel, variables, x, 1.0, dtype=None)
    got = make_serving_forward(model, torch.float32, device="cpu")(
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_bf16_close_to_jax_bf16(models):
    """bf16 rounds at other places in the two frameworks (the JAX package
    upsamples with an interpolation matmul in bf16); the sigmoid-bounded
    outputs stay within a few bf16 steps."""
    jmodel, variables, model = models
    x = images(45, batch=1)
    want = _jax_forward(jmodel, variables, x, 1.0, dtype=jnp.bfloat16)
    got = make_serving_forward(model, torch.bfloat16, device="cpu")(
        torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 0.05


def test_cpu_forward_launches_no_kernel(models):
    _, _, model = models
    before = assemble_z.launches
    make_serving_forward(model, torch.float32, device="cpu")(
        torch.from_numpy(images(46, batch=1)))
    assert assemble_z.launches == before


def test_default_device_is_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serving_forward(models[2])


@pytest.mark.parametrize("option", [
    {"s2d_stages": (0, 1)}, {"fused_stages": ()}, {"fused_stages": (1, 2, 3, 4)},
    {"dec_pipeline": "gate_z"}, {"dec_pipeline": "squeeze_first"},
    {"elu_fold": True},
])
def test_off_path_options_raise(models, option):
    with pytest.raises(ValueError):
        make_serving_forward(models[2], torch.float32, device="cpu", **option)


def test_flagship_config_equals_yml():
    with open(os.path.join(REPO, "configs", "uncertainty.yml")) as f:
        assert FLAGSHIP_MODEL == yaml.safe_load(f)["model"]


_FORBIDDEN = ("jax", "jaxlib", "flax", "yaml", "uncertainty_model_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 25
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in _FORBIDDEN, (path, name)


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'yaml', 'uncertainty_model_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import uncertainty_model_tpu_torch.serving\n"
            "import uncertainty_model_tpu_torch.convert\n"
            "import uncertainty_model_tpu_torch.models\n"
            "import uncertainty_model_tpu_torch.ops.warp\n"
            "import uncertainty_model_tpu_torch.losses\n"
            "import uncertainty_model_tpu_torch.utils\n"
            "import uncertainty_model_tpu_torch.train\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
