"""The serving forward's build options beyond the bench path against the
JAX package's ``make_serving_forward`` with the same options, on the same
weights and inputs: ``fused_stages`` (every set the JAX package can run,
across the three decoder pipelines), ``dec_fold=False``, ``elu_fold``,
the three ``smax`` formulations, on the native and the s2d encoder.  The
JAX package's decoder glue runs its Pallas kernels in interpret mode.
Sets where an unfused stage follows a fused one are refused by the port
and fail to trace in the JAX package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import images, models as build_models

import uncertainty_model_tpu.ops.pallas.decoder_fused as jdf
from uncertainty_model_tpu.serving import make_serving_forward as jax_serving

from uncertainty_model_tpu_torch.ops import kernels
from uncertainty_model_tpu_torch.ops.pad import padded_channels
from uncertainty_model_tpu_torch.serving import make_serving_forward

ALL = (0, 1, 2, 3, 4)
S2D = {"s2d_stages": (0, 1)}
FUSED_SETS = {"none": (), "4": (4,), "1-4": (1, 2, 3, 4), "0-4": ALL}
PIPELINES = ("gate_fold", "gate_z", "squeeze_first")

OPTIONS = {
    **{f"fused_{name}_{pipeline}": {"fused_stages": fs,
                                    "dec_pipeline": pipeline}
       for name, fs in FUSED_SETS.items() for pipeline in PIPELINES},
    "dec_fold_off": {"dec_fold": False},
    "elu_fold_gate_fold": {"elu_fold": True, "fused_stages": ALL},
    "elu_fold_gate_z": {"elu_fold": True, "dec_pipeline": "gate_z"},
    **{f"smax_{smax}": {"smax": smax} for smax in ("slice", "window", "nomax")},
    "s2d_fused_0-4": dict(S2D, fused_stages=ALL),
    "s2d_smax_nomax": dict(S2D, smax="nomax"),
    "s2d_elu_fold_dec_fold_off": dict(S2D, elu_fold=True, dec_fold=False),
}

# bf16: the port rounds z once where the JAX package rounds each step
# (tests/test_torch_serving.py), and the sigmoid-bounded outputs stay
# well within this
BF16_VS_JAX = 0.05
BF16_OPTIONS = ("fused_0-4_gate_fold", "fused_0-4_squeeze_first",
                "dec_fold_off", "elu_fold_gate_z", "smax_nomax",
                "s2d_fused_0-4")


@pytest.fixture(scope="module")
def models():
    return build_models("fc")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jdf, "_INTERPRET", True)


def _jax_forward(jmodel, variables, x, disp_scale, **kw):
    """The JAX package's forward, its own defaults pinned where the port's
    differ (``s2d_stages=()``, ``smax="window"``)."""
    kw = {"s2d_stages": (), "smax": "window", **kw}
    fwd, params = jax_serving(jmodel, variables, **kw)
    out = jax.jit(lambda p, x: fwd(p, x, disp_scale))(params, jnp.asarray(x))
    return np.asarray(out).astype(np.float32)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_f32_options_match_jax_serving(models, name, interpret):
    jmodel, variables, model = models
    options = OPTIONS[name]
    x = images(60)
    want = _jax_forward(jmodel, variables, x, 0.7, dtype=None, **options)
    got = make_serving_forward(model, torch.float32, device="cpu", **options)(
        torch.from_numpy(x), disp_scale=0.7)
    assert got.shape == want.shape == (2, 32, 64, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", BF16_OPTIONS)
def test_bf16_options_close_to_jax_bf16(models, name, interpret):
    jmodel, variables, model = models
    options = OPTIONS[name]
    x = images(61, batch=1)
    want = _jax_forward(jmodel, variables, x, 1.0, dtype=jnp.bfloat16,
                        **options)
    got = make_serving_forward(model, torch.bfloat16, device="cpu",
                               **options)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= BF16_VS_JAX


@pytest.mark.parametrize("name,fused", [
    ("0-4", (True,) * 5), ("1-4", (False, True, True, True, True)),
    ("none", (False,) * 5), ("4", (False,) * 4 + (True,))])
def test_specs_name_the_fused_stages(models, name, fused):
    """Each decoder spec says whether its stage runs the glue; the stages
    without a disparity to concat (dec0, dec1) pass none to it."""
    from uncertainty_model_tpu_torch.serving import build_serving_params

    (_, specs), params = build_serving_params(
        models[2], torch.float32, "cpu", fused_stages=FUSED_SETS[name])
    assert tuple(s["fused"] for s in specs) == fused
    assert [s["concat_disp"] for s in specs] == [False, False, True, True,
                                                 True]
    for i, (spec, prm) in enumerate(zip(specs, params["decoder"])):
        if spec["fused"]:
            # the tiny feature maps of dec2-dec4 have at most 8 channels
            assert spec["fold"] == (i >= 2)
            # the skip conv reads the previous fused stage's whole concat
            prev = specs[i - 1] if i else None
            if prev is not None and prev["fused"]:
                # the concat tensor is unpadded; the iconv that reads it
                # takes zero input channels up to reflect_pad's width
                iconv = models[2].decoder.layers[i - 1].iconv
                ccat = iconv.layers[0].layers[0].weight.shape[1]
                assert prm["se_skip"].shape[1] == ccat
                w = params["decoder"][i - 1]["iconv"][0]
                assert w.shape[1] == padded_channels(ccat)
                assert not w[:, ccat:].any()


def test_dec_fold_off_keeps_the_feature_map_conv(models):
    from uncertainty_model_tpu_torch.serving import build_serving_params

    (_, specs), params = build_serving_params(models[2], torch.float32, "cpu",
                                              dec_fold=False)
    for spec, prm in zip(specs[2:], params["decoder"][2:]):
        assert spec["fused"] and not spec["fold"]
        assert "se_fm" in prm and "k_fm" not in prm


@pytest.mark.parametrize("fused", [(0, 1, 3), (2, 4)])
def test_unfused_after_fused_is_refused(models, fused):
    """The port refuses a set where an unfused stage follows a fused one;
    the JAX package builds it but cannot trace it: it hands the unfused
    stage the fused stage's whole concat tensor as its skip
    (``serving.py:904-906``), whose channels the skip conv does not take."""
    jmodel, variables, model = models
    with pytest.raises(ValueError, match="serving.py:904-906"):
        make_serving_forward(model, torch.float32, device="cpu",
                             fused_stages=fused)
    with pytest.raises(ValueError, match="feature dimension"):
        _jax_forward(jmodel, variables, images(62, batch=1), 1.0, dtype=None,
                     fused_stages=fused)


COUNTED = tuple(k.fn for k in kernels.KERNELS)


def test_cpu_forward_of_every_fused_set_launches_no_kernel(models):
    before = [fn.launches for fn in COUNTED]
    for fused in FUSED_SETS.values():
        for pipeline in PIPELINES:
            make_serving_forward(models[2], torch.float32, device="cpu",
                                 fused_stages=fused, dec_pipeline=pipeline)(
                torch.from_numpy(images(63, batch=1)))
    assert [fn.launches for fn in COUNTED] == before


@pytest.mark.parametrize("fused", [FUSED_SETS["0-4"], FUSED_SETS["1-4"]])
def test_elu_fold_gives_the_same_tensor(models, fused):
    """``elu_fold`` only moves where the JAX package applies the iconv's
    ELU; the port's consumers are plain convs of the ELU'd tensor, so the
    option leaves its output bit for bit as it was.  A non-bool value is
    refused."""
    model = models[2]
    x = torch.from_numpy(images(64, batch=1))
    outs = [make_serving_forward(model, torch.float32, device="cpu",
                                 fused_stages=fused, elu_fold=elu_fold)(x)
            for elu_fold in (False, True)]
    assert torch.equal(*outs)
    with pytest.raises(ValueError, match="elu_fold"):
        make_serving_forward(model, torch.float32, device="cpu",
                             elu_fold="yes")
