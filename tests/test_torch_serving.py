"""The port's serving forward against the JAX package's
``make_serving_forward`` with the same options, on the same weights and
inputs (the bench path ``s2d_stages=()``, the space-to-depth stages and
every decoder pipeline, and attention logits scaled up to where the JAX
package's max-free softmax overflows), and the port's hygiene: no JAX,
CUDA by default, unported options refused."""

import ast
import functools
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
    PORT_MODEL, images, models as build_models, port_model, to_nchw,
    to_nhwc_numpy)

from uncertainty_model_tpu.serving import make_serving_forward as jax_serving
from uncertainty_model_tpu.train.convert import convert_model_state_dict

from uncertainty_model_tpu_torch.config import FLAGSHIP_MODEL
from uncertainty_model_tpu_torch.ops import conv as tconv
from uncertainty_model_tpu_torch.ops import decoder_fused as tdf
from uncertainty_model_tpu_torch.serving import make_serving_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "uncertainty_model_tpu_torch")


@pytest.fixture(scope="module")
def models():
    return build_models("fc")


def _jax_forward(jmodel, variables, x, disp_scale, **kw):
    kw.setdefault("s2d_stages", ())
    fwd, params = jax_serving(jmodel, variables, **kw)
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


BF16_VS_JAX = 2 ** -7   # max abs, bf16 serving vs JAX bf16 serving


def test_bf16_close_to_jax_bf16(models):
    """bf16: both frameworks upsample with the same bf16 weights, but round
    at other places (the fused glue rounds z once, the JAX package after
    each step); the sigmoid-bounded outputs stay within two bf16 steps of
    values in [0.5, 1) (read: one step, 2^-8)."""
    jmodel, variables, model = models
    x = images(45, batch=1)
    want = _jax_forward(jmodel, variables, x, 1.0, dtype=jnp.bfloat16)
    got = make_serving_forward(model, torch.bfloat16, device="cpu")(
        torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= BF16_VS_JAX


# the JAX package's default encoder (s2d stages 0-1; the tiny config has
# the flagship's k=7 and k=5 there) with each conv backend and attention
# mode, and each decoder pipeline on the bench path and on the s2d path
S2D = {"s2d_stages": (0, 1)}
PARITY_OPTIONS = {
    "s2d_pallas_s2d_attention": dict(S2D),
    "s2d_pallas_native_attention": dict(S2D, s2d_attention="native"),
    "s2d_lax_s2d_attention": dict(S2D, s2d_conv_backend="lax"),
    "s2d_lax_native_attention": dict(S2D, s2d_conv_backend="lax",
                                     s2d_attention="native"),
    "s2d_stage0_only": {"s2d_stages": (0,)},
    "gate_z": {"dec_pipeline": "gate_z"},
    "squeeze_first": {"dec_pipeline": "squeeze_first"},
    "s2d_gate_z": dict(S2D, dec_pipeline="gate_z"),
    "s2d_squeeze_first": dict(S2D, dec_pipeline="squeeze_first"),
}


@pytest.mark.parametrize("name", sorted(PARITY_OPTIONS))
def test_f32_options_match_jax_serving(models, name):
    """The same options on both sides, f32, the JAX package's
    max-subtracting softmaxes (smax="window")."""
    jmodel, variables, model = models
    options = PARITY_OPTIONS[name]
    x = images(48)
    want = _jax_forward(jmodel, variables, x, 0.7, dtype=None, smax="window",
                        **options)
    got = make_serving_forward(model, torch.float32, device="cpu", **options)(
        torch.from_numpy(x), disp_scale=0.7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pipeline", ["gate_fold", "squeeze_first"])
def test_bf16_s2d_close_to_jax_bf16(models, pipeline):
    jmodel, variables, model = models
    x = images(49, batch=1)
    want = _jax_forward(jmodel, variables, x, 1.0, dtype=jnp.bfloat16,
                        dec_pipeline=pipeline, **S2D)
    got = make_serving_forward(model, torch.bfloat16, device="cpu",
                               dec_pipeline=pipeline, **S2D)(
        torch.from_numpy(x)).float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= BF16_VS_JAX


COUNTED = (tdf.assemble_z, tdf.gate_z, tdf.se_squeeze, tdf.assemble,
           tconv.gated_conv_elu)


@pytest.mark.parametrize("pipeline", ["gate_fold", "gate_z", "squeeze_first"])
def test_cpu_forward_launches_no_kernel(models, pipeline):
    _, _, model = models
    before = [fn.launches for fn in COUNTED]
    for options in ({}, S2D):
        make_serving_forward(model, torch.float32, device="cpu",
                             dec_pipeline=pipeline, **options)(
            torch.from_numpy(images(46, batch=1)))
    assert [fn.launches for fn in COUNTED] == before


def test_default_device_is_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serving_forward(models[2])


@pytest.mark.parametrize("option", [
    {"s2d_conv_backend": "cudnn"}, {"fused_stages": ()},
    {"fused_stages": (1, 2, 3, 4)}, {"dec_pipeline": "gate_fold_z"},
    {"s2d_attention": "phase"}, {"elu_fold": True},
])
def test_off_path_options_raise(models, option):
    with pytest.raises(ValueError):
        make_serving_forward(models[2], torch.float32, device="cpu", **option)


# ---------------------------------------------------------------------------
# attention logits scaled up


@functools.lru_cache(maxsize=None)
def _scaled_models(scale):
    """The tiny model with every encoder attention's key and query
    projections scaled by ``scale``, on both sides."""
    jmodel, _, model = build_models("fc")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for k in sd:
        if ".keys." in k or ".queries." in k:
            sd[k] *= scale
    variables = convert_model_state_dict(
        {k: v.numpy() for k, v in sd.items()}, PORT_MODEL["decoder"]["layers"])
    return jmodel, variables, port_model(PORT_MODEL, variables)


def _max_logit(model, x):
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append(out.abs().max().item()))
        for name, m in model.named_modules()
        if name.endswith((".keys", ".queries"))]
    with torch.no_grad():
        model(to_nchw(x))
    for h in hooks:
        h.remove()
    return max(seen)


# (scale, lowest and highest max |logit|): logits of O(30-90), and beyond
# 88, where exp overflows in f32
SCALES = {"logits_57": (40.0, 30.0, 88.0), "logits_99": (70.0, 88.7, 200.0)}


@pytest.mark.parametrize("case", sorted(SCALES))
@pytest.mark.parametrize("path", ["bench", "s2d"])
def test_large_attention_logits(path, case):
    """The port subtracts the max in every softmax, so its forward stays
    finite and equals the JAX package's max-subtracting formulation
    (smax="window") at logits where the JAX default (smax="nomax")
    overflows: f32 at rtol 1e-4, atol 1e-5; bf16 within 0.05."""
    scale, lo, hi = SCALES[case]
    jmodel, variables, model = _scaled_models(scale)
    options = S2D if path == "s2d" else {}
    x = images(50, batch=1)
    assert lo < _max_logit(model, x) < hi
    want = _jax_forward(jmodel, variables, x, 1.0, dtype=None, smax="window",
                        **options)
    got = make_serving_forward(model, torch.float32, device="cpu", **options)(
        torch.from_numpy(x)).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    want16 = _jax_forward(jmodel, variables, x, 1.0, dtype=jnp.bfloat16,
                          smax="window", **options)
    got16 = make_serving_forward(model, torch.bfloat16, device="cpu",
                                 **options)(torch.from_numpy(x)).float().numpy()
    assert np.isfinite(got16).all()
    assert np.abs(got16 - want16).max() < 0.05
    if lo > 88.7 and path == "bench":
        nomax = _jax_forward(jmodel, variables, x, 1.0, dtype=None,
                             smax="nomax")
        assert not np.isfinite(nomax).all()


def test_flagship_config_equals_yml():
    with open(os.path.join(REPO, "configs", "uncertainty.yml")) as f:
        assert FLAGSHIP_MODEL == yaml.safe_load(f)["model"]


_FORBIDDEN = ("jax", "jaxlib", "flax", "yaml", "orbax", "matplotlib", "PIL",
              "uncertainty_model_tpu")


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
            "for m in ('jax', 'flax', 'yaml', 'orbax', 'matplotlib', 'PIL',\n"
            "          'uncertainty_model_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import uncertainty_model_tpu_torch.serving\n"
            "import uncertainty_model_tpu_torch.convert\n"
            "import uncertainty_model_tpu_torch.models\n"
            "import uncertainty_model_tpu_torch.ops.warp\n"
            "import uncertainty_model_tpu_torch.ops.upsample\n"
            "import uncertainty_model_tpu_torch.losses\n"
            "import uncertainty_model_tpu_torch.utils.viz\n"
            "import uncertainty_model_tpu_torch.train\n"
            "import uncertainty_model_tpu_torch.train.evaluate\n"
            "import uncertainty_model_tpu_torch.train.metrics\n"
            "import uncertainty_model_tpu_torch.train.sparsification\n"
            "import uncertainty_model_tpu_torch.train.checkpoint\n"
            "import uncertainty_model_tpu_torch.data\n"
            "import uncertainty_model_tpu_torch.data.native\n"
            "import uncertainty_model_tpu_torch.cli.main\n"
            "import uncertainty_model_tpu_torch.cli.parallel_main\n"
            "import uncertainty_model_tpu_torch.parallel\n"
            "from uncertainty_model_tpu_torch.config import load_config\n"
            "assert load_config('configs/uncertainty.yml')['model']\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
