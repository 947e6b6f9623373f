"""The training binary, ``nf_tpu_torch.train``, on the CPU against the JAX
package's ``nf_tpu.train``.

``build_model`` is held against JAX's for every 2D ``--model``: the JAX
model built from the same config, perturbed, carried across by its
exporter (the circular NSF and the residual flows by the helpers of
their test files, which write what the exporter lacks), loaded strictly
into the port's model; ``log_prob`` within 1e-4 (the residual flows
under the exact 2D log-det). ``main`` runs on the CPU only when asked
(``device="cpu"``); its flags, checkpoints and JSONL log, and the image
path, are checked as ``tests/test_train_features.py`` and
``tests/test_train_image.py`` check the JAX binary's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.flows as jflows
import nf_tpu_torch as nt
import nf_tpu_torch.flows as tflows
from nf_tpu import train as jtrain
from nf_tpu.compat_export import export_state_dict
from nf_tpu.utils.config import TrainConfig as JTrainConfig
from nf_tpu_torch import train
from nf_tpu_torch.utils.config import TrainConfig
from test_torch_autoregressive import circular_state_dict, perturb_jax
from test_torch_residual import model_state_dict, perturb

TOL = 1e-4
SMALL = ["--num_layers", "2", "--hidden", "16", "--num_bins", "4"]
TWO_D = ["--loss", "forward_kld", "--target", "two_moons", "--batch_size",
         "64", "--num_layers", "2", "--hidden", "16"]
IMAGE = ["--image_size", "8", "--levels", "1", "--num_layers", "1",
         "--hidden", "8", "--batch_size", "16", "--iters", "2",
         "--log_every", "1"]


def _pair(model, seed):
    """(JAX model, port model on the CPU) of ``--model model`` with the
    same perturbed weights."""
    argv = ["--model", model, "--target", "two_moons"] + SMALL
    jmodel = jtrain.build_model(JTrainConfig.from_args(argv),
                                jax.random.PRNGKey(seed))
    tmodel = train.build_model(TrainConfig.from_args(argv), device="cpu")
    if model == "residual":
        jmodel = perturb(jmodel, seed)
        sd = model_state_dict(jmodel)
        jmodel = jflows.set_exact_logdet(jmodel)
        tflows.set_exact_logdet(tmodel)
    else:
        jmodel = perturb_jax(jmodel, seed, scale=0.1)
        sd = (circular_state_dict(jmodel) if model == "circular_nsf"
              else export_state_dict(jmodel))
    return jmodel, nt.load_reference_state_dict(tmodel, sd)


@pytest.mark.parametrize("model", ["realnvp", "nsf", "circular_nsf", "maf",
                                   "residual"])
def test_build_model_matches_jax(model):
    jmodel, tmodel = _pair(model, seed=3)
    assert type(tmodel.p).__name__ == "TwoMoons"
    x = np.random.default_rng(4).uniform(-2.5, 2.5, (64, 2)).astype(
        np.float32)
    if model == "circular_nsf":
        x[:, 0] = np.random.default_rng(5).uniform(-np.pi, np.pi, 64)
    want = np.asarray(jmodel.log_prob(jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel.log_prob(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_bf16_residual_is_refused():
    with pytest.raises(SystemExit, match="--bf16"):
        train.build_model(TrainConfig.from_args(
            ["--model", "residual", "--bf16"]), device="cpu")


def test_config_json_is_jax_field_for_field():
    argv = ["--model", "nsf", "--loss", "forward_kld", "--accum_steps", "2",
            "--ema_decay", "0.9", "--no_class_cond", "--distributed",
            "--data", "x.npz", "--lr", "3e-4"]
    assert TrainConfig.from_args(argv).to_json() == \
        JTrainConfig.from_args(argv).to_json()


def test_main_takes_the_accum_ema_flags():
    """The flags of the JAX package's
    ``test_train_binary_accum_ema_flags``, on both loss paths."""
    state = train.main(["--model", "realnvp", "--loss", "forward_kld",
                        "--target", "two_moons", "--iters", "2",
                        "--num_layers", "2", "--hidden", "16",
                        "--batch_size", "64", "--accum_steps", "2",
                        "--ema_decay", "0.99", "--skip_nonfinite"],
                       device="cpu")
    assert state.ema is not None
    assert state.step == 2
    assert state.run_step.launches == {}  # eager on the CPU

    state = train.main(["--model", "realnvp", "--loss", "reverse_kld",
                        "--iters", "2", "--num_layers", "2",
                        "--hidden", "16", "--num_samples", "64",
                        "--accum_steps", "2", "--ema_decay", "0.99"],
                       device="cpu")
    assert state.ema is not None and state.step == 2


def test_main_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--iters", "1"])


def test_checkpoint_resume_and_log(tmp_path, capsys):
    argv = ["--model", "nsf"] + TWO_D + [
        "--num_bins", "4", "--log_every", "1", "--checkpoint_every", "2",
        "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_path",
        str(tmp_path / "log.jsonl")]
    first = train.main(argv + ["--iters", "4"], device="cpu")
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    capsys.readouterr()
    resumed = train.main(argv + ["--iters", "6"], device="cpu")
    assert "resumed from step 4" in capsys.readouterr().out
    assert resumed.step == 6
    assert any(not torch.equal(saved[k], v)
               for k, v in resumed.model.state_dict().items())
    with open(tmp_path / "log.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [0, 1, 2, 3, 4, 5]
    # the resumed run continues the generator: the same six steps in one
    # run land on the same weights
    whole = train.main(["--model", "nsf"] + TWO_D + [
        "--num_bins", "4", "--iters", "6"], device="cpu")
    for k, v in whole.model.state_dict().items():
        np.testing.assert_allclose(resumed.model.state_dict()[k].numpy(),
                                   v.numpy(), atol=1e-6, rtol=0)


def _bits(log_path):
    with open(log_path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("model", ["image_nsf", "glow"])
@pytest.mark.parametrize("source", ["procedural", "npz"])
def test_train_image(tmp_path, model, source):
    argv = ["--model", model] + IMAGE + ["--log_path",
                                         str(tmp_path / "log.jsonl")]
    if source == "npz":
        from nf_tpu_torch.data import procedural_image_classes

        x, y = procedural_image_classes(1, 64, size=8)
        np.savez(tmp_path / "x.npz", x=x, y=y)
        argv += ["--data", str(tmp_path / "x.npz")]
    state = train.main(argv, device="cpu")
    assert state.step == 2
    records = _bits(tmp_path / "log.jsonl")
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["bits_per_dim"]) and np.isfinite(r["loss"])
               for r in records)
