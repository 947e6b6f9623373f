"""``nf_tpu_torch.compat_export`` against the JAX package's exporter and
importer.

A port model, perturbed, goes through ``export_state_dict`` into the JAX
package's ``nf_tpu.compat.import_state_dict``; the JAX model's
``log_prob`` lies within 1e-4 of the port's (the families of
``tests/test_compat_export.py``). The exported keys, shapes and dtypes
equal the JAX exporter's on the same architecture, the port raises
where it raises, and export -> ``load_reference_state_dict`` is the
identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu
import nf_tpu.distributions as jdist
import nf_tpu.flows as jflows
import nf_tpu.models as jm
import nf_tpu_torch as nt
import nf_tpu_torch.distributions as tdist
import nf_tpu_torch.flows as tflows
from nf_tpu.compat import import_state_dict
from nf_tpu.compat_export import export_state_dict as jexport
from nf_tpu.nets import MLP as JMLP
from nf_tpu.nets import ResidualNet as JResidualNet
from nf_tpu_torch.compat_export import export_state_dict
from nf_tpu_torch.nets import MLP, ResidualNet
from nf_tpu_torch.nets.cnn import ConvNet2d

TOL = 1e-4
KEY = jax.random.PRNGKey(4)


def _perturb(model, seed, scale=0.15):
    """Every parameter plus N(0, scale²) numpy noise (builders start some
    layers at zero or the identity)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(
                scale * rng.standard_normal(tuple(p.shape))).to(p.dtype))
    return model


def _mlp_dropout_models():
    b = [1.0, 0.0]
    tmodel = nt.NormalizingFlow(tdist.DiagGaussian(2), [
        tflows.MaskedAffineFlow(torch.tensor(b),
                                t=MLP([2, 16, 16, 2], dropout=0.1),
                                s=MLP([2, 16, 16, 2], dropout=0.1))])
    jmodel = nf_tpu.NormalizingFlow.create(jdist.DiagGaussian.create(2), [
        jflows.MaskedAffineFlow.create(
            jnp.array(b), t=JMLP.create(KEY, [2, 16, 16, 2], dropout=0.1),
            s=JMLP.create(jax.random.fold_in(KEY, 1), [2, 16, 16, 2],
                          dropout=0.1))])
    return tmodel, jmodel


GLOW = dict(input_shape=(3, 8, 8), L=2, K=2, hidden_channels=8,
            num_classes=4, class_cond=True, logit_alpha=0.05)
# (port model, JAX model of the same architecture)
FAMILIES = {
    "realnvp": lambda: (nt.build_realnvp(dim=2, K=4, hidden=[16, 16],
                                         device="cpu"),
                        jm.build_realnvp(KEY, dim=2, K=4, hidden=[16, 16])),
    "realnvp_scan": lambda: (
        nt.build_realnvp(dim=2, K=4, hidden=[16, 16], scan=True,
                         device="cpu"),
        jm.build_realnvp(KEY, dim=2, K=4, hidden=[16, 16], scan=True)),
    "nsf": lambda: (nt.build_nsf(dim=2, K=2, hidden=16, num_bins=4,
                                 device="cpu"),
                    jm.build_nsf(KEY, dim=2, K=2, hidden=16, num_bins=4)),
    "maf": lambda: (nt.build_maf(dim=3, K=2, hidden=16, device="cpu"),
                    jm.build_maf(KEY, dim=3, K=2, hidden=16)),
    "glow": lambda: (nt.build_glow_multiscale(scan=True, device="cpu",
                                              **GLOW),
                     jm.build_glow_multiscale(KEY, scan=True, **GLOW)),
    "mlp_dropout": _mlp_dropout_models,
}
# families whose keys are compared but whose log_prob the tests above
# already hold against JAX through the same bridge
KEYS_ONLY = {
    "realnvp_mixed_precision": lambda: (
        nt.build_realnvp(dim=2, K=2, hidden=[8, 8], mixed_precision=True,
                         device="cpu"),
        jm.build_realnvp(KEY, dim=2, K=2, hidden=[8, 8],
                         mixed_precision=True)),
    "conditional_nsf": lambda: (
        nt.build_conditional_nsf(dim=2, K=2, hidden=8, device="cpu"),
        jm.build_conditional_nsf(KEY, dim=2, K=2, hidden=8)),
    "image_nsf": lambda: (
        nt.build_image_nsf(input_shape=(3, 8, 8), L=2, K=2,
                           hidden_channels=8, device="cpu"),
        jm.build_image_nsf(KEY, input_shape=(3, 8, 8), L=2, K=2,
                           hidden_channels=8)),
    "planar": lambda: (nt.build_planar_stack(dim=2, K=2, device="cpu"),
                       jm.build_planar_stack(KEY, dim=2, K=2)),
    "radial": lambda: (nt.build_radial_stack(dim=2, K=2, device="cpu"),
                       jm.build_radial_stack(KEY, dim=2, K=2)),
}


def _inputs(family):
    rng = np.random.default_rng(3)
    if family == "glow":
        return (rng.uniform(0.1, 0.9, (2, 3, 8, 8)).astype(np.float32),
                np.array([0, 2]))
    dim = 3 if family == "maf" else 2
    return (rng.standard_normal((32, dim)).astype(np.float32),)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_export_loads_into_jax_and_agrees(family):
    tmodel, jmodel = FAMILIES[family]()
    _perturb(tmodel, seed=5, scale=0.05 if family == "glow" else 0.15)
    jmodel = import_state_dict(jmodel, export_state_dict(tmodel))
    args = _inputs(family)
    with torch.no_grad():
        got = tmodel.log_prob(*[torch.from_numpy(a) for a in args]).numpy()
    want = np.asarray(jmodel.log_prob(*[jnp.asarray(a) for a in args]))
    # Glow's log-densities are ~1e2-1e3 nats: relative to max(|lp|, 1)
    scale = np.maximum(np.abs(want), 1.0) if family == "glow" else 1.0
    np.testing.assert_array_less(np.abs(got - want) / scale, TOL)


@pytest.mark.parametrize("family", sorted(FAMILIES) + sorted(KEYS_ONLY))
def test_exported_keys_are_the_jax_exporters(family):
    tmodel, jmodel = {**FAMILIES, **KEYS_ONLY}[family]()
    got = {k: (v.shape, v.dtype) for k, v in
           export_state_dict(tmodel).items()}
    want = {k: (np.shape(v), np.asarray(v).dtype)
            for k, v in jexport(jmodel).items()}
    assert got == want


def test_bookkeeping_values_are_the_jax_exporters():
    tmodel, jmodel = FAMILIES["glow"]()
    got, want = export_state_dict(tmodel), jexport(jmodel)
    for k in want:
        if k.endswith(("data_dep_init_done", "eye")):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    tmodel, jmodel = FAMILIES["maf"]()
    got, want = export_state_dict(tmodel), jexport(jmodel)
    for k in want:
        if k.endswith("degrees"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("family", ["realnvp_scan", "nsf", "maf", "glow"])
def test_export_then_load_is_the_identity(family):
    tmodel, _ = FAMILIES[family]()
    _perturb(tmodel, seed=6)
    sd = export_state_dict(tmodel)
    fresh, _ = FAMILIES[family]()
    nt.load_reference_state_dict(fresh, sd)
    for (name, a), b in zip(tmodel.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), name
    again = export_state_dict(fresh)
    assert set(again) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(again[k], sd[k])


def test_refuses_what_jax_refuses():
    cases = [
        (nt.build_circular_nsf(dim=2, K=2, hidden=8, device="cpu"),
         jm.build_circular_nsf(KEY, dim=2, K=2, hidden=8), "UniformGaussian"),
        (nt.build_residual(dim=2, K=2, hidden=8, device="cpu"),
         jm.build_residual(KEY, dim=2, K=2, hidden=8), "Residual"),
        (ResidualNet(2, 4, 8, use_batch_norm=True),
         JResidualNet.create(KEY, 2, 4, 8, use_batch_norm=True),
         "batch_norm"),
    ]
    for tmodel, jmodel, what in cases:
        with pytest.raises(NotImplementedError, match=what):
            jexport(jmodel)
        with pytest.raises(NotImplementedError, match=what):
            export_state_dict(tmodel)
    with pytest.raises(NotImplementedError, match="ActNorms"):
        export_state_dict(ConvNet2d([3, 8, 8, 6], (3, 1, 3), actnorm=True))
