"""The port's training CLI (``uncertainty_model_tpu_torch.cli.main``) on the
CPU: the JAX CLI's smoke recipe (``tests/test_cli.py``) on the tiny config
at 32x64 (argparse -> config -> datasets -> loaders -> trainer ->
evaluation -> checkpoints -> results.json), on a da Vinci tree written by
the port's PNG writer.

- the run writes one run folder with ``epoch_001``, ``epoch_002`` and
  ``final``, comparison PNGs and finite losses;
- ``results.json`` equals what the JAX package's ``_write_results`` writes
  for the same arguments and losses (same key tree and values);
- ``config.load_config`` equals ``yaml.load(..., Loader=yaml.Loader)`` on
  both configs and rejects what lies outside their subset, naming the line;
- ``--resume-from epoch_001`` ends with the uninterrupted run's ``final``
  weights and Adam state, bit for bit; ``--finetune-from`` loads a
  ``final`` directory or a reference-style ``.pt`` (``module.`` keys);
- ``--precision float32`` turns TF32 off;
- ``--precision bfloat16`` trains the bf16-compute model: finite
  ``results.json``, f32 checkpoints, and ``--resume-from epoch_001``
  equal to the uninterrupted run bit for bit;
- ``--adversarial`` trains against the tiny discriminator (the JAX
  package's parameter count printed), writes ``{"model", "disc"}``
  checkpoints with both optimizers and ``results.json`` with its loss
  list (as the JAX ``_write_results`` writes it), resumes bit for bit
  (one step an epoch: the clone was refreshed at the checkpoint's step),
  and finetunes from a directory or a reference ``{"model", "disc"}``
  ``.pt``, which without ``--adversarial`` gives the model alone;
- ``--adversarial --precision bfloat16``, ``--adversarial`` from a
  model-only ``.pt``, ``--data-backend pil``, a ``.pt`` for
  ``--resume-from``, a JAX (orbax) checkpoint and a missing CUDA device
  are refused.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch
import yaml

from uncertainty_model_tpu.cli import main as jax_cli
from uncertainty_model_tpu_torch.cli.main import build_parser, main
from uncertainty_model_tpu_torch.config import load_config
from uncertainty_model_tpu_torch.utils.viz import save_image

CONFIGS = ["configs/tiny.yml", "configs/uncertainty.yml"]


@pytest.fixture(scope="module")
def data_home(tmp_path_factory):
    """A $HOME/datasets/da-vinci tree of 8 train and 4 test pairs, 48x96."""
    home = tmp_path_factory.mktemp("home")
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("test", 4)):
        for side in ("image_0", "image_1"):
            d = home / "datasets" / "da-vinci" / split / side
            d.mkdir(parents=True)
            for i in range(n):
                save_image(rng.uniform(size=(48, 96, 3)), str(d / f"{i:03}.png"))
    return str(home)


def _argv(home, out, *extra):
    return ["configs/tiny.yml", "da-vinci", "--platform", "cpu",
            "--epochs", "2", "--batch-size", "8",
            "--training-size", "8", "--validation-size", "4",
            "--workers", "2", "--image-size", "32", "64",
            "--save-model-every", "1", "--evaluate-every", "1",
            "--save-model-to", os.path.join(out, "trained"),
            "--save-results-to", os.path.join(out, "results"),
            "--no-pbar", "--home", home, *extra]


def _run(argv):
    """(parsed arguments, printed output, run folder name) of one CLI run."""
    args = build_parser().parse_args(argv)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        main(args)
    runs = os.listdir(args.save_model_to)
    assert len(runs) == 1
    return args, printed.getvalue(), runs[0]


@pytest.fixture(scope="module")
def recipe(data_home, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("recipe"))
    argv = _argv(data_home, out)
    args, printed, run = _run(argv)
    return {"argv": argv, "args": args, "printed": printed,
            "model_dir": os.path.join(args.save_model_to, run),
            "results_dir": os.path.join(args.save_results_to, run)}


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_recipe_writes_checkpoints_and_results(recipe):
    assert sorted(os.listdir(recipe["model_dir"])) == [
        "epoch_001", "epoch_002", "final"]
    for name in ("epoch_001", "epoch_002", "final"):
        assert sorted(os.listdir(os.path.join(recipe["model_dir"], name))) == [
            "model.pt", "train_state.pt"]
    for epoch in ("epoch_001", "epoch_002"):
        for png in ("prediction.png", "disparity.png", "uncertainty.png"):
            path = os.path.join(recipe["results_dir"], epoch, png)
            with open(path, "rb") as f:
                assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with open(os.path.join(recipe["results_dir"], "results.json")) as f:
        results = json.load(f)
    training = results["losses"]["training"]
    assert len(training["disparity"]) == len(training["uncertainty"]) == 2
    assert np.isfinite(training["disparity"] + training["uncertainty"]).all()
    assert training["discriminator"] is None
    validation = results["losses"]["validation"]
    values = (validation["ssim"]["left"] + validation["ssim"]["right"]
              + validation["sparsification"]["ause"]
              + validation["sparsification"]["aurg"])
    assert len(values) == 8 and np.isfinite(values).all()
    assert "Platform: cpu" in recipe["printed"]
    assert "Training completed." in recipe["printed"]


def _key_tree(value):
    if isinstance(value, dict):
        return {k: _key_tree(v) for k, v in value.items()}
    return type(value).__name__


def test_results_schema_equals_jax(recipe, tmp_path):
    """The JAX ``_write_results`` given the same command line (parsed by
    the JAX parser), the config as ``yaml`` reads it, and the port's loss
    lists writes the same JSON."""
    with open(os.path.join(recipe["results_dir"], "results.json")) as f:
        got = json.load(f)
    training = got["losses"]["training"]
    validation = got["losses"]["validation"]
    losses = list(zip(training["disparity"], training["uncertainty"],
                      [None, None]))
    metrics = [((l, r), (a, g)) for l, r, a, g in zip(
        validation["ssim"]["left"], validation["ssim"]["right"],
        validation["sparsification"]["ause"],
        validation["sparsification"]["aurg"])]
    jax_args = jax_cli.build_parser().parse_args(recipe["argv"])
    with open("configs/tiny.yml") as f:
        config = yaml.load(f, Loader=yaml.Loader)
    with contextlib.redirect_stdout(io.StringIO()):
        jax_cli._write_results(str(tmp_path), jax_args, config, losses,
                               metrics)
    with open(tmp_path / "results.json") as f:
        want = json.load(f)
    assert _key_tree(got) == _key_tree(want)
    assert got == want


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_equals_yaml(path):
    with open(path) as f:
        want = yaml.load(f, Loader=yaml.Loader)
    got = load_config(path)
    assert got == want
    assert repr(got) == repr(want)  # the same types and key order


OUTSIDE = {
    "anchor": ("a: 1\nb: &x 2\n", 2),
    "alias": ("a: 1\nb: *x\n", 2),
    "tag": ("a: !!str 1\n", 1),
    "block scalar": ("a:\n  b: |\n    text\n", 2),
    "folded scalar": ("a: >\n  text\n", 1),
    "document marker": ("a: 1\n---\nb: 2\n", 2),
    "tab": ("a:\n\tb: 1\n", 2),
    "quoted string": ('a: "l1"\n', 1),
    "yes": ("a: yes\n", 1),
    "null": ("a: null\n", 1),
    "empty value": ("a: 1\nb:\n", 2),
    "exponent without a point": ("lr: 1e-4\n", 1),
    "octal": ("a: 017\n", 1),
    "flow sequence": ("a: [1, 2]\n", 1),
    "block mapping in a sequence": ("a:\n  - b: 1\n    c: 2\n", 2),
    "bad indentation": ("a:\n  b: 1\n    c: 2\n", 3),
    "unclosed flow mapping": ("a: 1\nb:\n  - {c: 1,\n     d: 2\n", 3),
    "duplicate key": ("a: 1\na: 2\n", 2),
}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_load_config_rejects_outside_the_subset(tmp_path, name):
    text, line = OUTSIDE[name]
    path = tmp_path / "bad.yml"
    path.write_text(text)
    with pytest.raises(ValueError, match=f"line {line}:"):
        load_config(str(path))


def test_resume_equals_uninterrupted(recipe, data_home, tmp_path):
    """``--resume-from epoch_001 --epochs 2`` runs epoch 2 alone and ends
    with the uninterrupted run's ``final``, bit for bit."""
    epoch_1 = os.path.join(recipe["model_dir"], "epoch_001")
    _, printed, run = _run(_argv(data_home, str(tmp_path), "--resume-from",
                                 epoch_1))
    assert "Epoch #1:" not in printed and "Epoch #2:" in printed
    assert sorted(os.listdir(tmp_path / "trained" / run)) == [
        "epoch_002", "final"]
    final = os.path.join(recipe["model_dir"], "final")
    resumed = tmp_path / "trained" / run / "final"
    want, got = _load(os.path.join(final, "model.pt")), _load(resumed / "model.pt")
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)
    want = _load(os.path.join(final, "train_state.pt"))["optimizer"]["state"]
    got = _load(resumed / "train_state.pt")["optimizer"]["state"]
    assert want.keys() == got.keys()
    assert all(torch.equal(want[i][k], got[i][k]) for i in want
               for k in ("step", "exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("source", ["final", "reference_pt"])
def test_finetune_loads_the_weights(recipe, data_home, tmp_path, source):
    """``--finetune-from`` a ``final`` directory or a reference-style
    ``.pt`` (DDP's ``module.`` keys): the reference's schedule (disparity
    scale 1.00), and at learning rate 0 the parameters stay the loaded
    ones."""
    final = os.path.join(recipe["model_dir"], "final")
    weights = _load(os.path.join(final, "model.pt"))
    path = final
    if source == "reference_pt":
        path = str(tmp_path / "reference.pt")
        torch.save({f"module.{k}": v for k, v in weights.items()}, path)
    args, printed, run = _run(_argv(
        data_home, str(tmp_path), "--finetune-from", path, "--epochs", "1",
        "--learning-rate", "0"))
    assert "disparity scale: 1.00" in printed
    tuned = _load(os.path.join(args.save_model_to, run, "final", "model.pt"))
    parameters = [k for k in weights if "running_" not in k
                  and "num_batches_tracked" not in k]
    assert parameters and all(torch.equal(tuned[k], weights[k])
                              for k in parameters)


def test_bf16_trains_checkpoints_and_resumes(data_home, tmp_path):
    """``--precision bfloat16``: two epochs with an evaluation and a
    checkpoint each, finite losses and metrics in ``results.json``,
    checkpoints of f32 parameters, statistics and Adam state; then
    ``--resume-from epoch_001`` ends with the uninterrupted run's
    ``final`` bit for bit."""
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        _check_bf16_run(data_home, tmp_path)
        assert not (torch.backends.cuda.matmul
                    .allow_bf16_reduced_precision_reduction)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            saved)


def _check_bf16_run(data_home, tmp_path):
    args, printed, run = _run(_argv(data_home, str(tmp_path / "full"),
                                    "--precision", "bfloat16"))
    assert "Training completed." in printed
    model_dir = os.path.join(args.save_model_to, run)
    assert sorted(os.listdir(model_dir)) == ["epoch_001", "epoch_002", "final"]
    with open(os.path.join(args.save_results_to, run, "results.json")) as f:
        results = json.load(f)
    assert results["arguments"]["precision"] == "bfloat16"
    losses = results["losses"]
    values = (losses["training"]["disparity"]
              + losses["training"]["uncertainty"]
              + losses["validation"]["ssim"]["left"]
              + losses["validation"]["ssim"]["right"]
              + losses["validation"]["sparsification"]["ause"]
              + losses["validation"]["sparsification"]["aurg"])
    assert len(values) == 12 and np.isfinite(values).all()
    final = os.path.join(model_dir, "final")
    weights = _load(os.path.join(final, "model.pt"))
    state = _load(os.path.join(final, "train_state.pt"))["optimizer"]["state"]
    assert all(v.dtype == torch.float32 for k, v in weights.items()
               if "num_batches_tracked" not in k)
    assert all(m[k].dtype == torch.float32 for m in state.values()
               for k in ("exp_avg", "exp_avg_sq"))

    _, printed, r_run = _run(_argv(
        data_home, str(tmp_path / "resumed"), "--precision", "bfloat16",
        "--resume-from", os.path.join(model_dir, "epoch_001")))
    assert "Epoch #1:" not in printed and "Epoch #2:" in printed
    resumed = tmp_path / "resumed" / "trained" / r_run / "final"
    got = _load(resumed / "model.pt")
    assert got.keys() == weights.keys()
    assert all(torch.equal(weights[k], got[k]) for k in weights)
    got = _load(resumed / "train_state.pt")["optimizer"]["state"]
    assert all(torch.equal(state[i][k], got[i][k]) for i in state
               for k in ("step", "exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("extra,error,message", [
    (["--adversarial", "--precision", "bfloat16"], NotImplementedError,
     "losses/total.py:97-101"),
    (["--data-backend", "pil"], ValueError, "no PIL path"),
])
def test_refused_options_raise(data_home, tmp_path, extra, error, message):
    args = build_parser().parse_args(_argv(data_home, str(tmp_path), *extra))
    with pytest.raises(error, match=message):
        with contextlib.redirect_stdout(io.StringIO()):
            main(args)


def test_checkpoints_the_port_cannot_read_are_refused(recipe, data_home,
                                                      tmp_path):
    final = os.path.join(recipe["model_dir"], "final")
    args = build_parser().parse_args(_argv(
        data_home, str(tmp_path), "--resume-from",
        os.path.join(final, "model.pt")))
    with pytest.raises(SystemExit, match="needs a checkpoint directory"):
        with contextlib.redirect_stdout(io.StringIO()):
            main(args)
    orbax = tmp_path / "jax_epoch_001"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    args = build_parser().parse_args(_argv(
        data_home, str(tmp_path), "--finetune-from", str(orbax)))
    with pytest.raises(ValueError, match="JAX \\(orbax\\) checkpoint"):
        with contextlib.redirect_stdout(io.StringIO()):
            main(args)


def test_default_platform_needs_cuda(data_home, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(data_home, str(tmp_path))
            if a not in ("--platform", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(build_parser().parse_args(argv))


def test_profile_dir_writes_a_trace(data_home, tmp_path):
    profile = tmp_path / "profile"
    _run(_argv(data_home, str(tmp_path), "--epochs", "1",
               "--evaluate-every", "10", "--profile-dir", str(profile)))
    traces = [f for f in os.listdir(profile) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(profile / traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_float32_turns_tf32_off(data_home, tmp_path):
    """``--precision float32`` (the default) means f32 convolutions and
    matmuls: the CLI turns off the TF32 that PyTorch's cuDNN uses unless
    told otherwise."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _run(_argv(data_home, str(tmp_path), "--epochs", "1",
                   "--evaluate-every", "10"))
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.fixture(scope="module")
def adversarial(data_home, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("adversarial"))
    argv = _argv(data_home, out, "--adversarial")
    args, printed, run = _run(argv)
    return {"argv": argv, "args": args, "printed": printed,
            "model_dir": os.path.join(args.save_model_to, run),
            "results_dir": os.path.join(args.save_results_to, run)}


def test_adversarial_trains_checkpoints_and_writes_results(adversarial,
                                                           tmp_path):
    """``--adversarial``: the JAX package's discriminator parameter count
    (``jax.eval_shape`` of its init on the tiny config), ``{"model",
    "disc"}`` checkpoints with both optimizers, and ``results.json`` with
    a finite discriminator loss each epoch, equal to what the JAX
    ``_write_results`` writes for the same losses."""
    import jax
    import jax.numpy as jnp

    from uncertainty_model_tpu.models import RandomDiscriminator as JaxDisc

    with open("configs/tiny.yml") as f:
        config = yaml.load(f, Loader=yaml.Loader)
    pyr = [jax.ShapeDtypeStruct((1, 32 >> i, 64 >> i, 6), jnp.float32)
           for i in range(4)]
    shapes = jax.eval_shape(JaxDisc.from_config(**config["discriminator"]).init,
                            jax.random.PRNGKey(0), pyr)["params"]
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert f"Discriminator has {n:,} learnable parameters." in (
        adversarial["printed"])

    for name in ("epoch_001", "epoch_002", "final"):
        path = os.path.join(adversarial["model_dir"], name)
        weights = _load(os.path.join(path, "model.pt"))
        assert sorted(weights) == ["disc", "model"]
        assert "linear.weight" in weights["disc"]
        state = _load(os.path.join(path, "train_state.pt"))
        assert sorted(state) == ["disc_optimizer", "epoch", "optimizer"]
    with open(os.path.join(adversarial["results_dir"], "results.json")) as f:
        got = json.load(f)
    training = got["losses"]["training"]
    assert len(training["discriminator"]) == 2
    assert np.isfinite(training["discriminator"]).all()
    validation = got["losses"]["validation"]
    metrics = [((l, r), (a, g)) for l, r, a, g in zip(
        validation["ssim"]["left"], validation["ssim"]["right"],
        validation["sparsification"]["ause"],
        validation["sparsification"]["aurg"])]
    jax_args = jax_cli.build_parser().parse_args(adversarial["argv"])
    with contextlib.redirect_stdout(io.StringIO()):
        jax_cli._write_results(
            str(tmp_path), jax_args, config,
            list(zip(training["disparity"], training["uncertainty"],
                     training["discriminator"])), metrics)
    with open(tmp_path / "results.json") as f:
        assert got == json.load(f)


def test_adversarial_resume_equals_uninterrupted(adversarial, data_home,
                                                 tmp_path):
    """``--adversarial --resume-from epoch_001``: epoch 2 alone, ending
    with the uninterrupted run's ``final`` (model, discriminator and both
    optimizers) bit for bit.  An epoch is one step here, so the clone the
    uninterrupted run takes into epoch 2 is the checkpoint's discriminator,
    which is what the resumed run starts its clone from."""
    epoch_1 = os.path.join(adversarial["model_dir"], "epoch_001")
    _, printed, run = _run(_argv(data_home, str(tmp_path), "--adversarial",
                                 "--resume-from", epoch_1))
    assert "Epoch #1:" not in printed and "Epoch #2:" in printed
    final = os.path.join(adversarial["model_dir"], "final")
    resumed = tmp_path / "trained" / run / "final"
    want = _load(os.path.join(final, "model.pt"))
    got = _load(resumed / "model.pt")
    for part in ("model", "disc"):
        assert want[part].keys() == got[part].keys()
        assert all(torch.equal(want[part][k], got[part][k])
                   for k in want[part]), part
    want = _load(os.path.join(final, "train_state.pt"))
    got = _load(resumed / "train_state.pt")
    for part in ("optimizer", "disc_optimizer"):
        w, g = want[part]["state"], got[part]["state"]
        assert w.keys() == g.keys() and all(
            torch.equal(w[i][k], g[i][k]) for i in w
            for k in ("step", "exp_avg", "exp_avg_sq")), part


@pytest.mark.parametrize("source", ["final", "reference_pt"])
def test_adversarial_finetune_loads_both(adversarial, data_home, tmp_path,
                                         source):
    """``--adversarial --finetune-from`` a ``final`` directory or a
    reference ``{"model", "disc"}`` ``.pt`` (``module.`` keys): at
    learning rate 0 the model's and the discriminator's parameters stay
    the loaded ones.  Without ``--adversarial`` the same source trains
    the model alone."""
    final = os.path.join(adversarial["model_dir"], "final")
    weights = _load(os.path.join(final, "model.pt"))
    path = final
    if source == "reference_pt":
        path = str(tmp_path / "reference.pt")
        torch.save({part: {f"module.{k}": v for k, v in sd.items()}
                    for part, sd in weights.items()}, path)
    for extra, out in ((["--adversarial"], "adv"), ([], "plain")):
        args, printed, run = _run(_argv(
            data_home, str(tmp_path / out), "--finetune-from", path,
            "--epochs", "1", "--learning-rate", "0", *extra))
        assert "disparity scale: 1.00" in printed
        tuned = _load(os.path.join(args.save_model_to, run, "final",
                                   "model.pt"))
        parts = ("model", "disc") if extra else ("model",)
        if not extra:
            assert "Discriminator" not in printed and "disc" not in tuned
            tuned = {"model": tuned}
        for part in parts:
            names = [k for k in weights[part] if "running_" not in k
                     and "num_batches_tracked" not in k]
            assert names and all(torch.equal(tuned[part][k],
                                              weights[part][k])
                                 for k in names), part


def test_adversarial_needs_a_discriminator_to_restore(recipe, data_home,
                                                      tmp_path):
    """``--adversarial`` from a model-only ``.pt`` or checkpoint directory
    fails, naming the file."""
    final = os.path.join(recipe["model_dir"], "final")
    for path in (os.path.join(final, "model.pt"), final):
        args = build_parser().parse_args(_argv(
            data_home, str(tmp_path), "--adversarial", "--finetune-from",
            path))
        with pytest.raises(ValueError, match="holds no discriminator"):
            with contextlib.redirect_stdout(io.StringIO()):
                main(args)
