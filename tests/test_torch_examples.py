"""The twins of the example scripts (``examples_torch/``) on the CPU.

* Smoke: every twin's ``main()`` runs in-process with the JAX smoke
  test's argument list (``tests/test_examples_smoke.py``) plus ``--device
  cpu``, its output directory redirected; without ``--device cpu`` and
  without CUDA every twin raises. The multichip twin brings up its
  one-rank gloo group and takes it down again.
* Parity: for each twin that runs the spline kernels on the card (the
  coupled and autoregressive NSF, the conditional NSF, both circular NSFs,
  the image NSF and the serving twin's model), the JAX model is built as
  the JAX script's ``main()`` builds it at the smoke widths, its trainable
  arrays perturbed with numpy noise (N(0, 0.1²)), exported under the
  reference's names (``nf_tpu.compat_export.export_state_dict``; the
  circular models through ``test_torch_autoregressive.circular_state_dict``)
  and loaded into the twin's own ``build_model(args, "cpu")``.
  ``log_prob`` on seeded numpy points agrees at 1e-4 abs, the JAX
  package's float32 bar; the image NSF's log-densities (~1e3 nats) at
  1e-4 relative to max(|log p|, 1), its bar for image models
  (``tests/test_torch_image.py``).
* The slice as a whole: from the same weights, the twin's ``_utils.train``
  and ``examples/_utils.train`` each take three Adam steps of
  ``neural_spline_flow``'s forward-KLD loss on the same fixed numpy
  batches, indexed by the iteration; losses agree at 1e-4 abs and each
  parameter tensor at 1e-4 relative, ``||port - jax|| <= 1e-4 max(||jax||,
  1)`` (the JAX bar's ``max(., 1)`` on the tensor's L2 norm). Adam
  divides each gradient element by its own magnitude, so an element whose
  gradient is near Adam's eps (1e-8; a ReLU unit dead on most of the
  batch) moves by a fraction of the rate that float32 rounding decides:
  one weight of 4096 in a trunk lands 1.1e-4 apart after the first step,
  while its tensor's norm is ~6.
* Imports: a fresh interpreter imports every twin and finds no ``jax``,
  ``optax`` or ``nf_tpu`` module loaded, and no module of ``examples/``.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import nf_tpu.flows as jflows
import nf_tpu.models as jmodels
import nf_tpu_torch as nt
import test_examples_smoke as jax_smoke
from nf_tpu import core as jcore
from nf_tpu.compat_export import export_state_dict
from nf_tpu.distributions import ConditionalDiagGaussianTarget
from nf_tpu.distributions import DiagGaussian as JDiagGaussian
from nf_tpu.distributions import TwoMoons as JTwoMoons
from nf_tpu_torch.compat_export import export_state_dict as port_export
from test_torch_autoregressive import circular_state_dict, perturb_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES_DIR = os.path.join(ROOT, "examples")
TOL = 1e-4
SCALE = 0.1  # the numpy noise on the JAX models' trainable arrays

# the JAX smoke test's argument lists; migrate_from_reference has no twin
SMOKE = {k: v for k, v in jax_smoke.SMOKE.items()
         if k != "migrate_from_reference"}
TWINS = sorted({k.split()[0] for k in SMOKE})


def twin(name):
    return importlib.import_module(f"examples_torch.{name}")


def smoke_args(spec):
    return SMOKE[spec] + ["--device", "cpu"]


@pytest.fixture
def jax_examples(monkeypatch):
    """The JAX scripts' modules, imported as ``test_examples_smoke`` does
    (``examples/`` on ``sys.path``, for this test only)."""
    monkeypatch.syspath_prepend(EXAMPLES_DIR)
    return importlib.import_module


@pytest.mark.parametrize("spec", sorted(SMOKE))
def test_twin_smoke(spec, monkeypatch, tmp_path):
    name = spec.split()[0]
    mod = twin(name)
    from examples_torch import _utils

    monkeypatch.setattr(_utils, "OUT_DIR", str(tmp_path))
    out = mod.main(smoke_args(spec))
    hists = out.get("hist")
    hists = (hists.values() if isinstance(hists, dict)
             else [hists] if hists is not None else [])
    for h in hists:
        assert len(h.losses) and bool(torch.isfinite(h.losses).all())
    assert not (dist.is_available() and dist.is_initialized())


@pytest.mark.parametrize("name", TWINS)
def test_twin_refuses_the_cpu_unless_asked(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    spec = name if name in SMOKE else f"{name} --autoregressive"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin(name).main(SMOKE[spec])


# --- parity of the kernel-running models -----------------------------------

def _args(name, spec):
    """The twin's and the JAX script's parsed smoke flags."""
    return twin(name).parser().parse_args(smoke_args(spec))


def _points(n=300, seed=0, circ=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2)) * 1.5
    for i in circ:
        x[:, i] = rng.uniform(-np.pi, np.pi, n)
    return x.astype(np.float32)


def _jax_nsf(args):
    """``examples/neural_spline_flow.py``'s model."""
    key = jax.random.PRNGKey(args.seed)
    if not args.autoregressive:
        return jmodels.build_nsf(key, dim=2, K=4, hidden=64, num_bins=8,
                                 target=JTwoMoons())
    keys = jax.random.split(key, 8)
    flows = []
    for i in range(4):
        flows.append(jflows.AutoregressiveRationalQuadraticSpline.create(
            keys[2 * i], num_input_channels=2, num_blocks=2,
            num_hidden_channels=64, num_bins=8))
        flows.append(jflows.LULinearPermute.create(keys[2 * i + 1], 2))
    return jcore.NormalizingFlow.create(
        JDiagGaussian.create(2, trainable=False), flows, p=JTwoMoons())


def _jax_serving(args):
    """``examples/serving_inference.py``'s model."""
    key = jax.random.PRNGKey(args.seed)
    key, k_data, k_model = jax.random.split(key, 3)
    return jmodels.build_nsf(k_model, dim=2, K=4, hidden=64, num_bins=8)


def _jax_conditional(args):
    return jmodels.build_conditional_nsf(
        jax.random.PRNGKey(args.seed), target=ConditionalDiagGaussianTarget())


def _jax_circular(args):
    return jmodels.build_circular_nsf(jax.random.PRNGKey(args.seed), dim=2,
                                      ind_circ=(1,), K=6, hidden=64,
                                      num_bins=8)


def _pair_2d(name, spec, build_jax, export=export_state_dict):
    """(JAX model perturbed, the twin's model on the CPU with its
    weights)."""
    args = _args(name, spec)
    jmodel = perturb_jax(build_jax(args), 0, SCALE)
    sd = {k: np.asarray(v) for k, v in export(jmodel).items()}
    return jmodel, nt.load_reference_state_dict(
        twin(name).build_model(args, torch.device("cpu")), sd)


@jax.jit
def _jax_log_prob(jmodel, x, *context):
    return jmodel.log_prob(x, *context)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0)


def _rel_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


@pytest.mark.parametrize("spec,build_jax", [
    ("neural_spline_flow", _jax_nsf),
    ("neural_spline_flow --autoregressive", _jax_nsf),
    ("serving_inference", _jax_serving)])
def test_nsf_models_match_jax(spec, build_jax):
    jmodel, tmodel = _pair_2d(spec.split()[0], spec, build_jax)
    x = _points()
    with torch.no_grad():
        got = tmodel.log_prob(torch.from_numpy(x))
    _close(got, _jax_log_prob(jmodel, jnp.asarray(x)))


def test_conditional_model_matches_jax():
    jmodel, tmodel = _pair_2d("conditional_flow", "conditional_flow",
                              _jax_conditional)
    from examples_torch.conditional_flow import sample_context

    x = _points()
    ctx = sample_context(torch.Generator().manual_seed(0), len(x))
    with torch.no_grad():
        got = tmodel.log_prob(torch.from_numpy(x), context=ctx)
    _close(got, _jax_log_prob(jmodel, jnp.asarray(x),
                              jnp.asarray(ctx.numpy())))


def test_circular_models_match_jax(jax_examples):
    gvm = jax_examples("paper_example_nsf").GaussVonMises

    def paper(args):
        return jmodels.build_circular_nsf(
            jax.random.PRNGKey(args.seed), dim=2, ind_circ=(0,), K=args.K,
            hidden=args.hidden, num_bins=10, target=gvm())

    for name, build_jax, circ in (("circular_nsf", _jax_circular, (1,)),
                                  ("paper_example_nsf", paper, (0,))):
        jmodel, tmodel = _pair_2d(name, name, build_jax,
                                  circular_state_dict)
        x = _points(circ=circ)
        with torch.no_grad():
            got = tmodel.log_prob(torch.from_numpy(x))
        _close(got, _jax_log_prob(jmodel, jnp.asarray(x)))


def test_image_nsf_model_matches_jax():
    args = _args("image_nsf", "image_nsf")
    # examples/image_nsf.py: the model's key is the second of a split
    key, sub = jax.random.split(jax.random.PRNGKey(args.seed))
    jmodel = perturb_jax(jmodels.build_image_nsf(
        sub, input_shape=(3, 32, 32), L=args.L, K=args.K,
        hidden_channels=args.hidden, num_bins=args.num_bins), 0, SCALE)
    sd = {k: np.asarray(v) for k, v in export_state_dict(jmodel).items()}
    tmodel = nt.load_reference_state_dict(
        twin("image_nsf").build_model(args, torch.device("cpu")), sd)
    x = np.random.default_rng(0).uniform(0.05, 0.95, (4, 3, 32, 32)).astype(
        np.float32)
    with torch.no_grad():
        got = tmodel.log_prob(torch.from_numpy(x))
    _rel_close(got, _jax_log_prob(jmodel, jnp.asarray(x)))


# --- the slice as a whole: three Adam steps of the training loop -----------

def test_train_matches_the_jax_examples_loop(jax_examples):
    jutils = jax_examples("_utils")
    from examples_torch import _utils as tutils

    spec = "neural_spline_flow"
    jmodel, tmodel = _pair_2d(spec, spec, _jax_nsf)
    rng = np.random.default_rng(7)
    xs = (rng.standard_normal((3, 256, 2)) * 1.5).astype(np.float32)
    args = argparse.Namespace(iters=3, lr=3e-3, seed=0, log_every=0)

    def jloss(model, key, it):
        return model.forward_kld(jnp.asarray(xs)[it.astype(jnp.int32)])

    jmodel, jhist = jutils.train(jmodel, jloss, args)
    tmodel, thist = tutils.train(
        tmodel, tutils.ForwardKLD(lambda gen, it: torch.from_numpy(xs[it])),
        args)
    assert [i for i, _ in thist] == [i for i, _ in jhist] == [0, 1, 2]
    _close([v for _, v in thist], [v for _, v in jhist])
    _close(thist.losses, [v for _, v in jhist])
    want = {k: np.asarray(v) for k, v in export_state_dict(jmodel).items()}
    got = port_export(tmodel)
    assert set(got) == set(want)
    for k in want:
        g, w = (np.asarray(a, np.float64) for a in (got[k], want[k]))
        assert np.linalg.norm(g - w) <= TOL * max(np.linalg.norm(w), 1.0), k


# --- imports ----------------------------------------------------------------

_PROBE = r"""
import importlib, json, os, sys
names = json.loads(sys.argv[1])
for n in names:
    importlib.import_module("examples_torch." + n)
examples = os.path.join(os.getcwd(), "examples") + os.sep
bad = sorted(m for m, mod in list(sys.modules.items())
             if m in ("jax", "optax", "nf_tpu")
             or m.startswith(("jax.", "jaxlib", "optax.", "nf_tpu."))
             or (getattr(mod, "__file__", None) or "").startswith(examples))
print(json.dumps({"bad": bad}))
"""


def test_twins_import_no_jax_optax_or_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(TWINS)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["bad"] == []
