"""The port's bf16 mixed precision (``dtype=torch.bfloat16``: f32
parameters, BatchNorm statistics, gradients and Adam state; bf16 module
compute) against the JAX package's ``dtype=jnp.bfloat16`` path, on the
tiny config (``torch_port_helpers.PORT_MODEL``) from the same converted
weights and numpy-seeded inputs.

- each bf16 module against its flax counterpart, forward and backward:
  BatchNorm in train and eval mode with the updated running statistics,
  ``ConvBNELU``, ``ConvLayer`` (reflect, unpadded, a tuple of inputs),
  ``EfficientAttention``, ``SELayer`` (linear and conv) and
  ``DecoderStage``, within a stated number of bf16 ulps;
- the model's bf16 forward in eval and train mode;
- one bf16 training step against the JAX step, link by link: the losses,
  the BatchNorm statistics, the train-mode disparities, dL/dD at equal
  disparities, the model backward of an equal cotangent per parameter
  and the whole step's gradient by its median;
- 5 bf16 steps within 5% of the port's f32 steps and of the JAX
  package's bf16 ``Trainer`` (``tests/test_mixed_precision.py``'s bound);
- parameters, statistics and Adam state f32 after the steps; serving of a
  bf16-compute model equal to serving of the f32 one; a bf16 run's
  checkpoint reloaded; no kernel launched on the CPU.

Where a limit is a number of ulps, an ulp is that of the larger magnitude
of the two values, in bf16 (8 bits of mantissa).  The modules are held
against flax run op by op, where every bf16 operation rounds as the JAX
layers write it; jitted on the CPU, XLA's fusions keep some intermediates
in f32 (the attention's output then differs from the op-by-op one by up
to 32 ulps on 7% of its elements), so the model and the step, jitted as
the JAX trainer runs them, are held by tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tiny_config import TINY_INPUT, TINY_LOSS
from torch_port_helpers import (
    CONFIGS, PORT_MODEL, images, models as build_models, port_model, to_nchw)

from uncertainty_model_tpu.losses import TukraUncertaintyLoss as JaxLoss
from uncertainty_model_tpu.models import RandomlyConnectedModel as JaxModel
from uncertainty_model_tpu.models import layers as jl
from uncertainty_model_tpu.ops import reconstruct_pyramid_with_lr as jax_recon_lr
from uncertainty_model_tpu.ops import scale_pyramid as jax_scale_pyramid
from uncertainty_model_tpu.parallel import create_mesh, shard_batch
from uncertainty_model_tpu.train import Trainer as JaxTrainer
from uncertainty_model_tpu.train.convert import convert_model_state_dict

from uncertainty_model_tpu_torch.models.layers import TorchBatchNorm
from uncertainty_model_tpu_torch.ops import (
    reconstruct_pyramid_with_lr, scale_pyramid)
from uncertainty_model_tpu_torch.ops.warp_rows import (
    warp_rows_bwd, warp_rows_fwd)
from uncertainty_model_tpu_torch.serving import make_serving_forward
from uncertainty_model_tpu_torch.train import Trainer
from uncertainty_model_tpu_torch.train.checkpoint import (
    load_checkpoint, save_checkpoint)

BF = jnp.bfloat16
DISP_SCALE = 0.3
LR = 1e-3       # tests/test_mixed_precision.py's trajectory
STEPS = 5
STEP_BATCH = 8

# The running statistics: f32 means and variances of equal bf16 values,
# summed in another order (read: at most 3.8e-6 of the largest).
STATS_REL = 1e-5
# Module gradients, port against the JAX package, ||diff|| / ||jax||.  The
# forwards agree bit for bit, the backwards do not: XLA on the CPU sums a
# bf16 broadcast's gradient (a bias's, a BatchNorm statistic's) in bf16,
# autograd in f32 and rounds once.
DX_REL = 2e-2       # the input's gradient (read: at most 9.8e-3)
PARAM_REL = 1e-1    # a parameter's gradient (read: at most 6.2e-2)
# A parameter whose gradient is 0 in exact arithmetic (its f32 gradient
# under 1e-3 of JAX's bf16 one: a conv bias ahead of train-mode
# BatchNorm, the attention keys' bias, whose softmax over the tokens
# ignores it) holds only bf16 rounding noise; the port's must be at most
# this share of the JAX package's (read: at most 0.23).
ZERO_GRAD_SHARE = 0.5


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def bf16_values(seed, shape, scale=1.0):
    """NHWC f32 numpy values that bf16 holds exactly."""
    a = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()


def port_in(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).bfloat16().contiguous(
        memory_format=torch.channels_last)


def jax_in(a):
    return jnp.asarray(a, BF)


def nhwc(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).float().numpy()


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def ulps(got, want):
    """(max distance in bf16 ulps, share of elements that differ)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    return float((np.abs(got - want) / ulp).max()), float((got != want).mean())


def rel(got, want):
    """||got - want|| / ||want||."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def assert_ulps(got, want, max_ulps, max_share, what=""):
    n, share = ulps(got, want)
    assert n <= max_ulps and share <= max_share, (what, n, share)


def bf16_port(name="fc"):
    _, variables, _ = build_models(name)
    return port_model(CONFIGS[name], variables, torch.bfloat16)


def subtree(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        tree = variables[col]
        for key in path:
            tree = tree.get(key, {}) if isinstance(tree, dict) else {}
        if tree:
            out[col] = tree
    return out


def jax_apply(module, variables, *args, train=False, **kw):
    """(output, updated batch_stats) of a flax module in train or eval
    mode."""
    if "batch_stats" in variables:
        out, mutated = module.apply(variables, *args, mutable=["batch_stats"],
                                    **({"train": train} | kw))
        return out, mutated["batch_stats"]
    return module.apply(variables, *args, **kw), None


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm(train):
    """``TorchBatchNorm(dtype=bf16)`` against flax ``TorchBatchNorm``: the
    output bit for bit (each bf16 operation rounds alike) but for 1 ulp on
    1% of the elements, the running statistics within 1e-6 relative, the
    gradients within ``DX_REL`` and ``PARAM_REL`` (read: dx 0 in eval
    mode, 2.5e-3 in train mode; scale 6.8e-3 and 1.0e-2, bias 1.6e-2)."""
    rng = np.random.default_rng(1)
    c = 6
    x = bf16_values(2, (4, 5, 7, c), 3.0) + 2.0
    prm = {"scale": rng.uniform(0.5, 2.0, c).astype(np.float32),
           "bias": rng.normal(size=c).astype(np.float32)}
    stats = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    jbn = jl.TorchBatchNorm(use_running_average=not train, dtype=BF)
    cot = bf16_values(3, x.shape)

    def jfwd(p, x):
        out, mut = jbn.apply({"params": p, "batch_stats": stats}, x,
                             mutable=["batch_stats"])
        return out, mut["batch_stats"]

    want, vjp, want_stats = jax.vjp(jfwd, prm, jax_in(x), has_aux=True)
    want_dp, want_dx = vjp(jax_in(cot))

    bn = TorchBatchNorm(c, torch.bfloat16).train(train)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(prm["scale"]))
        bn.bias.copy_(torch.from_numpy(prm["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = port_in(x).requires_grad_()
    got = bn(xt)
    got.backward(port_in(cot))
    assert got.dtype == torch.bfloat16 and bn.weight.dtype == torch.float32
    assert_ulps(nhwc(got), f32(want), 1, 0.01, "out")
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(want_stats[key]), rtol=1e-6)
    assert rel(nhwc(xt.grad), f32(want_dx)) <= DX_REL
    assert rel(bn.weight.grad.numpy(), f32(want_dp["scale"])) <= PARAM_REL
    assert rel(bn.bias.grad.numpy(), f32(want_dp["bias"])) <= PARAM_REL


def flat(tree):
    return {jax.tree_util.keystr(k): f32(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_tree(model, grads=False, name="fc"):
    """The port model's parameters (or their gradients, 0 where none) and
    BatchNorm statistics as JAX variables, by the JAX package's
    converter."""
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    if grads:
        sd.update({k: (p.grad if p.grad is not None
                       else torch.zeros_like(p)).numpy()
                   for k, p in model.named_parameters()})
    return convert_model_state_dict(sd, CONFIGS[name]["decoder"]["layers"])


def run_module(path, jmodule, port_module, arrays, train, extra=(),
               jax_extra=None, tuple_input=False, name="fc"):
    """Forward and backward of the flax ``jmodule`` on the tiny model's
    variables at ``path`` and of the same submodule of a bf16 port model
    (``port_module(model)``), on bf16 inputs ``arrays`` (NHWC) then
    ``extra`` (passed as they are), with one seeded bf16 cotangent per
    output (``jax_extra``: what the flax module takes for ``extra``;
    ``tuple_input``: the inputs as one tuple).  Returns {"jax": ...,
    "port": ...} of outputs, updated statistics, input gradients and
    parameter gradients (flat, JAX keys), all numpy f32, and {"f32": ...}
    of the f32 port module's parameter gradients."""
    jax_extra = extra if jax_extra is None else jax_extra

    def pack(xs):
        return (tuple(xs),) if tuple_input else tuple(xs)

    _, variables, _ = build_models(name)
    jv = subtree(variables, *path)
    model = bf16_port(name)
    module = port_module(model).train(train)

    def fwd(params, *xs):
        out, stats = jax_apply(jmodule, {**jv, "params": params}, *pack(xs),
                               *jax_extra, train=train)
        return out, stats

    outs, vjp, stats = jax.vjp(fwd, jv["params"],
                               *[jax_in(a) for a in arrays], has_aux=True)
    leaves = outs if isinstance(outs, tuple) else (outs,)
    cots = [bf16_values(100 + i, o.shape) for i, o in enumerate(leaves)]
    grads = vjp(tuple(jax_in(c) for c in cots) if isinstance(outs, tuple)
                else jax_in(cots[0]))
    want = {"out": [f32(o) for o in leaves],
            "stats": flat(stats) if stats is not None else {},
            "dx": [f32(g) for g in grads[1:]], "dparams": flat(grads[0])}

    xs = [port_in(a).requires_grad_() for a in arrays]
    got = module(*pack(xs), *extra)
    got = got if isinstance(got, tuple) else (got,)
    assert all(o.dtype == torch.bfloat16 for o in got)
    torch.autograd.backward(list(got), [port_in(c) for c in cots])
    sub = subtree(port_tree(model, grads=True, name=name), *path)
    stats_now = subtree(port_tree(model, name=name), *path).get(
        "batch_stats", {})
    have = {"out": [nhwc(o) for o in got],
            "stats": flat(stats_now) if want["stats"] else {},
            "dx": [nhwc(x.grad) for x in xs], "dparams": flat(sub["params"])}

    # the same in f32: which gradients are 0 in exact arithmetic
    model32 = port_model(CONFIGS[name], variables)
    module = port_module(model32).train(train)
    got = module(*pack(port_in(a).float() for a in arrays), *extra)
    got = got if isinstance(got, tuple) else (got,)
    torch.autograd.backward(list(got), [port_in(c).float() for c in cots])
    exact = {"dparams": flat(subtree(port_tree(model32, grads=True, name=name),
                                     *path)["params"])}
    return {"jax": want, "port": have, "f32": exact}


def check_module(result, max_ulps, max_share):
    """Each output within ``max_ulps`` on at most ``max_share`` of its
    elements, the running statistics within ``STATS_REL`` of each one's
    largest magnitude, the gradients within ``DX_REL``, ``PARAM_REL`` or
    ``ZERO_GRAD_SHARE``."""
    want, got = result["jax"], result["port"]
    for i, (g, w) in enumerate(zip(got["out"], want["out"])):
        assert_ulps(g, w, max_ulps, max_share, f"output {i}")
    assert got["stats"].keys() == want["stats"].keys()
    for key, w in want["stats"].items():
        err = np.abs(got["stats"][key] - w).max() / np.abs(w).max()
        assert err <= STATS_REL, (key, err)
    for i, (g, w) in enumerate(zip(got["dx"], want["dx"])):
        assert rel(g, w) <= DX_REL, (i, rel(g, w))
    assert got["dparams"].keys() == want["dparams"].keys()
    for key, w in want["dparams"].items():
        g, norm = got["dparams"][key], np.linalg.norm(w)
        if np.linalg.norm(result["f32"]["dparams"][key]) < 1e-3 * norm:
            assert np.linalg.norm(g) <= ZERO_GRAD_SHARE * norm, key
        else:
            assert rel(g, w) <= PARAM_REL, (key, rel(g, w))


# (flax module, path of its variables, the port submodule, input shapes
# (NHWC, bf16), max ulps and share of each output); train mode only
# where BatchNorm is
DEC = PORT_MODEL["decoder"]["layers"][2]
MODULES = {
    "conv_bn_elu_input": (
        lambda: jl.ConvBNELU(8, 7, 2, dtype=BF),
        ("encoder", "stage_0", "graph", "node_0", "conv_block"),
        lambda m: m.encoder.layers[0].layers[0].node_blocks[0].convolution,
        [(2, 32, 64, 3)], (0, 0)),
    "conv_bn_elu": (
        lambda: jl.ConvBNELU(16, 3, 1, dtype=BF),
        ("encoder", "stage_2", "graph", "node_1", "conv_block"),
        lambda m: m.encoder.layers[2].layers[0].node_blocks[1].convolution,
        [(2, 8, 16, 16)], (0, 0)),
    "attention": (
        lambda: jl.EfficientAttention(16, 16, 2, dtype=BF),
        ("encoder", "stage_2", "attention"),
        lambda m: m.encoder.layers[2].layers[1], [(2, 8, 16, 16)], (0, 0)),
    # one ulp where the convs' f32 sums round apart (read: 0.02%)
    "conv_layer_reflect": (
        lambda: jl.ConvLayer(16, dtype=BF),
        ("decoder", "stage_2", "iconv", "conv_layer"),
        lambda m: m.decoder.layers[2].iconv.layers[0], [(2, 8, 16, 28)],
        (1, 1e-3)),
    "conv_layer_unpadded": (
        lambda: jl.ConvLayer(16, padding=False, kernel_size=1, dtype=BF),
        ("decoder", "stage_2", "se_conv", "conv_layer"),
        lambda m: m.decoder.layers[2].squeeze_excite[0].layers[0],
        [(2, 8, 16, 24)], (1, 1e-3)),
    "conv_layer_sigmoid": (
        lambda: jl.ConvLayer(4, sigmoid=True, dtype=BF),
        ("decoder", "stage_2", "disp"),
        lambda m: m.decoder.layers[2].disp, [(2, 8, 16, 16)], (1, 1e-3)),
    "se_fc": (
        lambda: jl.SELayer(16, fc=True, dtype=BF), ("decoder", "stage_2", "se"),
        lambda m: m.decoder.layers[2].squeeze_excite[1], [(2, 8, 16, 16)],
        (0, 0)),
    "se_conv": (
        lambda: jl.SELayer(16, fc=False, dtype=BF),
        ("decoder", "stage_2", "se"),
        lambda m: m.decoder.layers[2].squeeze_excite[1], [(2, 8, 16, 16)],
        (0, 0)),
}
WITH_BN = ("conv_bn_elu_input", "conv_bn_elu")


@pytest.mark.parametrize("name,train", [
    (name, train) for name in MODULES
    for train in ((False, True) if name in WITH_BN else (False,))])
def test_module(name, train):
    """Forward and backward of one bf16 module against flax's (limits at
    ``MODULES`` and ``check_module``)."""
    jmodule, path, port_module, shapes, (max_ulps, share) = MODULES[name]
    arrays = [bf16_values(10 + i, s) for i, s in enumerate(shapes)]
    check_module(run_module(path, jmodule(), port_module, arrays, train,
                            name="conv_se" if name == "se_conv" else "fc"),
                 max_ulps, share)


def test_conv_layer_tuple_input():
    """The unpadded 1x1 conv on a tuple of inputs, as the decoder's SE conv
    takes its feature map and skip: each input meets its slice of the
    kernel, the partial convs rounded, summed and biased in bf16."""
    check_module(run_module(
        ("decoder", "stage_2", "se_conv", "conv_layer"),
        jl.ConvLayer(16, padding=False, kernel_size=1, dtype=BF),
        lambda m: m.decoder.layers[2].squeeze_excite[0].layers[0],
        [bf16_values(20, (2, 8, 16, 8)), bf16_values(21, (2, 8, 16, 16))],
        False, tuple_input=True), 1, 1e-3)


@pytest.mark.parametrize("train", [False, True])
def test_decoder_stage(train):
    """A decoder stage with every part (SE skip fusion, pixel-shuffle
    upsample, the resized disparity in the concat, the sigmoid head at a
    scale of 0.3 passed as f32, as the JAX step and evaluation pass it):
    out, skip and disparity bit for bit but for 2 ulps on 0.1% (read: 2
    ulps on 0.02% of out in train mode)."""
    arrays = [bf16_values(30, (2, 4, 8, DEC["in_channels"])),
              bf16_values(31, (2, 8, 16, DEC["feature_in_channels"])),
              bf16_values(32, (2, 4, 8, DEC["skip_in_channels"])),
              bf16_values(33, (2, 4, 8, DEC["disp_channels"]), 0.1)]
    check_module(run_module(
        ("decoder", "stage_2"), jl.DecoderStage(**DEC, dtype=BF),
        lambda m: m.decoder.layers[2], arrays, train, extra=(DISP_SCALE,),
        jax_extra=(jnp.float32(DISP_SCALE),)), 2, 1e-3)


# ---------------------------------------------------------------------------
# the model and one training step
# ---------------------------------------------------------------------------


def stereo_batch(seed, b=STEP_BATCH):
    rng = np.random.default_rng(seed)
    return {side: rng.uniform(size=(b, *TINY_INPUT, 3)).astype(np.float32)
            for side in ("left", "right")}


@pytest.fixture(scope="module")
def jax_step_chain():
    """The JAX package's bf16 step up to its gradients (train/trainer.py:
    197-238 without the adversarial branch), jitted once for the module,
    returning each link: the losses, the f32-cast train-mode disparities,
    dL/dD there, the model's backward of it (the step's gradients) and the
    updated BatchNorm statistics."""
    jmodel = JaxModel.from_config(**PORT_MODEL, dtype=BF)
    loss = JaxLoss(**TINY_LOSS)

    def chain(params, batch_stats, left, right):
        pyramid = jax_scale_pyramid(jnp.concatenate([left, right], -1), 4)

        def forward(p):
            disparities, mutated = jmodel.apply(
                {"params": p, "batch_stats": batch_stats}, left,
                disp_scale=jnp.float32(DISP_SCALE), train=True,
                mutable=["batch_stats"])
            return ([d.astype(jnp.float32) for d in disparities],
                    mutated["batch_stats"])

        disparities, vjp, stats = jax.vjp(forward, params, has_aux=True)

        def losses(ds):
            recon, lr = jax_recon_lr(ds, pyramid)
            d, e = loss(pyramid, ds, recon, step=jnp.int32(0), lr_pyramid=lr)
            return d + e, (d, e)

        (_, (d, e)), dl_dd = jax.value_and_grad(losses, has_aux=True)(
            disparities)
        (grads,) = vjp(dl_dd)
        return {"losses": (d, e), "disparities": disparities,
                "dl_dd": dl_dd, "grads": grads, "batch_stats": stats}

    return jax.jit(chain)



@pytest.fixture(scope="module")
def step(jax_step_chain):
    """One bf16 step of the tiny model at batch ``STEP_BATCH`` from the same
    variables and batch: the JAX chain, the port's ``Trainer.train_step``
    (lr 0), and the f32 port's (the exact gradients' stand-in)."""
    _, variables, _ = build_models("fc")
    batch = stereo_batch(40)
    want = jax.tree.map(np.asarray, jax_step_chain(
        variables["params"], variables["batch_stats"],
        jnp.asarray(batch["left"]), jnp.asarray(batch["right"])))
    runs = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        trainer = Trainer(port_model(PORT_MODEL, variables, dtype).train(),
                          TINY_LOSS, device="cpu")
        losses = trainer.train_step(batch, DISP_SCALE, 0.0)
        tree = port_tree(trainer.model, grads=True)
        runs[name] = {"trainer": trainer, "losses": losses,
                      "grads": flat(tree["params"]),
                      "batch_stats": flat(tree["batch_stats"])}
    return {"variables": variables, "batch": batch, "jax": want, **runs}


def model_backward(variables, batch, dtype, cotangents):
    """The port model's train-mode disparities (f32) and its parameters'
    gradients of the given cotangents."""
    model = port_model(PORT_MODEL, variables, dtype).train()
    ds = [d.permute(0, 2, 3, 1).float() for d in
          model(to_nchw(batch["left"]), disp_scale=DISP_SCALE)]
    torch.autograd.backward(ds, [torch.from_numpy(c.copy())
                                 for c in cotangents])
    return ([d.detach().numpy() for d in ds],
            flat(port_tree(model, grads=True)["params"]))


def median_rel(got, want):
    return float(np.median([rel(got[k], want[k]) for k in want]))


@pytest.mark.parametrize("train", [False, True])
def test_model_forward(step, train):
    """The tiny model's bf16 forward, all four scales in bf16.  Eval mode
    within 2^-8 (read: 2^-9, the disparity scale 0.7); train mode (the
    step's batch, statistics of the batch) within 2^-6 (read: 1.2e-2):
    BatchNorm on the batch's statistics of the 1x2 and 2x4 deep maps
    (n = 16 and 64) magnifies the bf16 convs' one-ulp differences as much
    as it magnifies bf16's own rounding (JAX's bf16 against the f32
    model: 1.0e-2)."""
    variables = step["variables"]
    if train:
        got, _ = model_backward(variables, step["batch"], torch.bfloat16,
                                [np.zeros_like(d)
                                 for d in step["jax"]["disparities"]])
        want, limit = step["jax"]["disparities"], 2.0 ** -6
    else:
        x = images(50)
        jmodel = JaxModel.from_config(**PORT_MODEL, dtype=BF)
        out = jax.jit(lambda v, x: jmodel.apply(
            v, x, disp_scale=jnp.float32(0.7)))(variables, jnp.asarray(x))
        assert all(d.dtype == BF for d in out)
        want, limit = [f32(d) for d in out], 2.0 ** -8
        model = port_model(PORT_MODEL, variables, torch.bfloat16)
        with torch.no_grad():
            got = model(to_nchw(x), disp_scale=0.7)
        assert all(d.dtype == torch.bfloat16 for d in got)
        got = [nhwc(d) for d in got]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= limit, np.abs(g - w).max()


def test_step_losses_and_statistics(step):
    """The losses within 1e-3 relative (read: 2.1e-4) and the BatchNorm
    running statistics within 2e-2 of each one's largest magnitude (read:
    4.9e-3): the train-mode forward's differences (test_model_forward)."""
    for key, want in zip(("disp_loss", "error_loss"), step["jax"]["losses"]):
        got = step["bf16"]["losses"][key]
        assert got.dtype == torch.float32
        assert abs(got.item() - float(want)) <= 1e-3 * abs(float(want)), key
    got, want = step["bf16"]["batch_stats"], flat(step["jax"]["batch_stats"])
    assert got.keys() == want.keys()
    for key in want:
        assert np.abs(got[key] - want[key]).max() <= 2e-2 * np.abs(
            want[key]).max(), key


def test_step_loss_gradient_at_equal_disparities(step):
    """dL/dD of the port's f32 losses at the JAX step's bf16 disparities
    against the JAX step's, within 1e-3 relative per scale (read: 3.4e-4
    at full resolution, 1.5e-6 at the others).  bf16 maps tie often
    (neighbours in the smoothness term, a view and the other warped in
    the consistency terms), and where |x| is at 0 the port's losses take
    ``jnp.abs``'s gradient: with ``torch.abs``'s the disparity loss's
    part read 3e-3 at every scale, now 1.5e-6.  What remains is one pixel
    whose uncertainty and warped disparity (a lerp between equal bf16
    values) differ by an f32 rounding, of the other sign in each warp."""
    jax_step = step["jax"]
    images = torch.from_numpy(np.concatenate(
        [step["batch"]["left"], step["batch"]["right"]], -1))
    pyramid = scale_pyramid(images, 4)
    ds = [torch.from_numpy(d.copy()).requires_grad_()
          for d in jax_step["disparities"]]
    recon, lr = reconstruct_pyramid_with_lr(ds, pyramid)
    disp_loss, error_loss = step["bf16"]["trainer"].loss(
        pyramid, ds, recon, lr_pyramid=lr)
    got = torch.autograd.grad(disp_loss + error_loss, ds)
    for g, w in zip(got, jax_step["dl_dd"]):
        assert rel(g.numpy(), w) <= 1e-3, rel(g.numpy(), w)


# The model backward per parameter, port against the JAX step.  bf16
# gradients are noisy (JAX's differs from the f32 one by 8.8% median), so
# each parameter's limit is max(BACKWARD_NOISE times JAX's own distance
# from the f32 gradient, BACKWARD_FLOOR), relative to JAX's gradient.
BACKWARD_NOISE, BACKWARD_FLOOR = 4.0, 0.25


def leaf_fault(got, want, exact, floor):
    """(whether the per-parameter check refuses the port's gradient ``got``
    of one parameter, its share of the limit), against the JAX step's
    ``want`` with the f32 gradient ``exact`` as the noise yardstick.
    Where the exact gradient is 0 (the f32 one under 1e-3 of the bf16
    ones, or under ``floor``: a conv bias ahead of train-mode BatchNorm,
    the attention keys' bias of the 1x2 stage, JAX's 0 and the port's
    1e-20), the gradient is bf16 rounding alone and the port's may be at
    most as large as JAX's (the share is then None)."""
    wn, gn = np.linalg.norm(want), np.linalg.norm(got)
    if np.linalg.norm(exact) < max(1e-3 * max(wn, gn), floor):
        return not gn <= max(wn, floor), None
    share = rel(got, want) / max(BACKWARD_NOISE * rel(want, exact),
                                 BACKWARD_FLOOR)
    return not share <= 1, share


def backward_faults(got, want, exact):
    """(the parameters that ``leaf_fault`` refuses, each checked
    parameter's share of its limit), with ``floor`` 1e-6 of the largest
    gradient of the JAX step."""
    floor = 1e-6 * max(np.linalg.norm(w) for w in want.values())
    faults, shares = [], {}
    for key, w in want.items():
        fault, share = leaf_fault(got[key], w, exact[key], floor)
        if fault:
            faults.append(key)
        if share is not None:
            shares[key] = share
    return faults, shares, floor


@pytest.fixture(scope="module")
def backward(step):
    """The port's bf16 and f32 model backward of the JAX step's dL/dD, and
    the JAX step's gradients: (got, want, exact), flat."""
    cot = step["jax"]["dl_dd"]
    _, got = model_backward(step["variables"], step["batch"], torch.bfloat16,
                            cot)
    _, exact = model_backward(step["variables"], step["batch"], None, cot)
    want = flat(step["jax"]["grads"])
    assert got.keys() == want.keys() == exact.keys() and len(want) > 200
    return got, want, exact


def test_step_model_backward(backward):
    """The bf16 model's backward of the JAX step's dL/dD, per parameter
    against the JAX step's gradient, within ``backward_faults``'s limits
    (read: the worst at 0.71 of its limit; where the exact gradient is 0,
    the port's noise at most 0.62 of JAX's), and the median within 1.5
    times JAX's distance from the f32 gradient (read: 0.108 against
    0.088)."""
    got, want, exact = backward
    faults, shares, _ = backward_faults(got, want, exact)
    assert not faults, [(k, shares.get(k)) for k in faults]
    assert median_rel(got, want) <= 1.5 * median_rel(want, exact)


def test_step_model_backward_catches_one_wrong_parameter(backward):
    """A fault planted in one parameter's gradient of the port's correct
    backward, each parameter in turn, fails ``backward_faults`` there: the
    gradient's sign flipped wherever the limit is under 2 (JAX's noise
    under 1/2), the gradient missing (0) wherever it is under 1.  The
    parameters whose JAX gradient is mostly noise are left out (read: 2 of
    183 out of the first, JAX's distance from the exact gradient 23 and
    410 times the exact gradient's norm; 7 out of the second), and those
    that are 0 in exact arithmetic out of both; the rest must be at least
    95% of the checked parameters (read: 98.9% and 96.2%)."""
    got, want, exact = backward
    _, shares, floor = backward_faults(got, want, exact)
    limits = {k: max(BACKWARD_NOISE * rel(want[k], exact[k]), BACKWARD_FLOOR)
              for k in shares}
    for name, fault, below in (("sign", lambda g: -g, 2.0),
                               ("missing", np.zeros_like, 1.0)):
        planted = [k for k in shares if limits[k] < below]
        assert len(planted) >= 0.95 * len(shares), (name, len(planted))
        for key in planted:
            refused, _ = leaf_fault(fault(got[key]), want[key], exact[key],
                                    floor)
            assert refused, (name, key)


def test_step_whole_gradient(step):
    """The port's whole bf16 step against the JAX step, by the median of
    the parameters' relative differences: within 1.5 times the JAX bf16
    step's own median distance from the f32 step (read: 0.266 against
    0.253).  Each link is held above; the whole differs by as much as
    bf16 differs from f32 because the disparities do (test_model_forward),
    and the warp's gradient jumps where a tap crosses a pixel."""
    want = flat(step["jax"]["grads"])
    got, exact = step["bf16"]["grads"], step["f32"]["grads"]
    assert got.keys() == want.keys()
    assert median_rel(got, want) <= 1.5 * median_rel(want, exact)



# ---------------------------------------------------------------------------
# five steps, the state, serving and checkpoints
# ---------------------------------------------------------------------------


def kernel_launches():
    from uncertainty_model_tpu_torch.ops import conv, decoder_fused, upsample
    return [f.launches for f in (
        warp_rows_fwd, warp_rows_bwd, conv.conv_elu, conv.gated_conv_elu,
        decoder_fused.assemble_z, decoder_fused.gate_z,
        decoder_fused.se_squeeze, decoder_fused.assemble,
        upsample.upsample2x2)]


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """``STEPS`` steps at lr 1e-3 on seeded batches (as
    tests/test_mixed_precision.py runs them) from the same variables: the
    port in bf16 (its checkpoint after step 3 written) and in f32, and the
    JAX package's bf16 ``Trainer``; the total loss of each step, and the
    kernel launch counters before and after the port's steps."""
    _, variables, _ = build_models("fc")
    batches = [stereo_batch(60 + i) for i in range(STEPS)]
    checkpoint = str(tmp_path_factory.mktemp("bf16_run"))
    out = {"batches": batches, "variables": variables}
    launches = kernel_launches()
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        trainer = Trainer(port_model(PORT_MODEL, variables, dtype).train(),
                          TINY_LOSS, device="cpu")
        losses = []
        for i, batch in enumerate(batches):
            m = trainer.train_step(batch, DISP_SCALE, LR, i)
            losses.append(m["disp_loss"].item() + m["error_loss"].item())
            if name == "bf16" and i == 2:
                out["checkpoint"] = save_checkpoint(
                    checkpoint, trainer.model, trainer.optimizer,
                    epoch_number=3)
        out[name] = {"trainer": trainer, "losses": np.asarray(losses)}
    out["launches"] = (launches, kernel_launches())

    mesh = create_mesh(jax.devices()[:1])
    jtrainer = JaxTrainer(JaxModel.from_config(**PORT_MODEL, dtype=BF),
                          TINY_LOSS, mesh=mesh)
    state = jtrainer.load_state(jax.tree.map(np.array, variables))
    losses = []
    for i, batch in enumerate(batches):
        state, m = jtrainer._train_step(
            state, shard_batch(batch, mesh), jnp.float32(DISP_SCALE),
            jnp.float32(LR), jnp.int32(i))
        losses.append(float(m["disp_loss"]) + float(m["error_loss"]))
    out["jax"] = {"losses": np.asarray(losses)}
    return out


@pytest.mark.parametrize("reference", ["f32", "jax"])
def test_bf16_tracks_trajectory(trajectories, reference):
    """The JAX package's bound (test_bf16_tracks_f32_trajectory): each of
    the 5 bf16 steps' total loss within 5% of the port's f32 step's (read:
    1.9e-3) and of the JAX package's bf16 step's (read: 1.8e-3)."""
    got = trajectories["bf16"]["losses"]
    want = trajectories[reference]["losses"]
    assert np.isfinite(got).all() and len(got) == STEPS
    assert (np.abs(got - want) / np.abs(want)).max() < 0.05, (got, want)


def test_state_stays_f32(trajectories):
    """After the bf16 steps the parameters, their gradients, the BatchNorm
    statistics and Adam's state are f32, and the model still computes in
    bf16."""
    trainer = trajectories["bf16"]["trainer"]
    model = trainer.model
    assert model.dtype == torch.bfloat16
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
    for name, b in model.named_buffers():
        if b.is_floating_point():
            assert b.dtype == torch.float32, name
    state = trainer.optimizer.state_dict()["state"]
    assert len(state) == len(list(model.parameters()))
    for moments in state.values():
        for key in ("exp_avg", "exp_avg_sq"):
            assert moments[key].dtype == torch.float32
    with torch.no_grad():
        out = model.eval()(to_nchw(images(70)), disp_scale=DISP_SCALE)
    assert all(d.dtype == torch.bfloat16 for d in out)


def test_cpu_steps_launch_no_kernel(trajectories):
    before, after = trajectories["launches"]
    assert before == after


def test_checkpoint_of_a_bf16_run(trajectories):
    """The step-3 checkpoint of the bf16 run holds f32 tensors; a fresh bf16
    trainer resumed from it runs steps 4 and 5 to the uninterrupted run's
    parameters and Adam state bit for bit; its weights load into an f32
    model, which serves as the bf16 model does."""
    state_dict, train_state = load_checkpoint(trajectories["checkpoint"])
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in state_dict.values())
    variables = trajectories["variables"]
    resumed = Trainer(port_model(PORT_MODEL, variables, torch.bfloat16)
                      .train(), TINY_LOSS, device="cpu")
    assert resumed.load_state(state_dict, train_state) == 3
    for i in (3, 4):
        resumed.train_step(trajectories["batches"][i], DISP_SCALE, LR, i)
    done = trajectories["bf16"]["trainer"]
    want, got = done.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(want[k], got[k]) for k in want)
    sa = done.optimizer.state_dict()["state"]
    sb = resumed.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa
               for k in ("step", "exp_avg", "exp_avg_sq"))

    f32_model = port_model(PORT_MODEL, variables)
    f32_model.load_state_dict(done.model.state_dict(), strict=True)
    x = torch.from_numpy(images(71))
    for dtype in (torch.bfloat16, torch.float32):
        a = make_serving_forward(done.model, dtype, device="cpu")(x, 0.5)
        b = make_serving_forward(f32_model, dtype, device="cpu")(x, 0.5)
        assert torch.equal(a, b)


def test_serving_ignores_the_compute_type():
    """``make_serving_forward`` folds the f32 parameters whatever the
    model's compute type: a bf16-compute model serves as the f32 one, in
    bf16 and in f32."""
    _, variables, model32 = build_models("fc")
    model16 = port_model(PORT_MODEL, variables, torch.bfloat16)
    x = torch.from_numpy(images(72))
    for dtype in (torch.bfloat16, torch.float32):
        a = make_serving_forward(model16, dtype, device="cpu")(x, 0.7)
        b = make_serving_forward(model32, dtype, device="cpu")(x, 0.7)
        assert a.dtype == dtype and torch.equal(a, b)
