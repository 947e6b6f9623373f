"""The port's autoregressive NSF (``nf_tpu_torch.build_circular_nsf`` and
its modules) against the JAX package, on the CPU.

Small sizes (K = 2 layers, hidden 16, 4 bins). The JAX model's trainable
arrays are moved off the identity init with numpy noise (N(0, 0.2²)), and
the result crosses to the port through the reference-named state dict of
:func:`circular_state_dict`: ``nf_tpu.compat_export.export_state_dict``
for each autoregressive layer, plus what that exporter lacks (the base
``q0.*``, the ``PeriodicWrap`` buffers and each MADE's periodic
preprocessing). Masks, the ``permute_mask`` order included, come across
in that dict. Inputs are drawn with numpy from a seed; sampling is
compared by feeding both frameworks the same base draws. Tolerance 1e-4
abs on outputs, log-dets and log-densities, the port's bar for a whole
model (``tests/test_torch_nsf.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.models as jmodels
import nf_tpu_torch as nt
from nf_tpu.compat_export import export_state_dict
from nf_tpu.distributions.base import UniformGaussian as JUniformGaussian
from nf_tpu.flows.periodic import PeriodicShift as JPeriodicShift
from nf_tpu.flows.periodic import PeriodicWrap as JPeriodicWrap
from nf_tpu.nets.made import MADE as JMADE
from nf_tpu.utils.module import combine, partition
from nf_tpu.utils.nn import PeriodicFeaturesElementwise as JPeriodic
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.nets.made import MADE
from nf_tpu_torch.ops import splines_kernel as tk
from nf_tpu_torch.utils.nn import PeriodicFeaturesElementwise

TOL = 1e-4
SMALL = dict(K=2, hidden=16, num_bins=4)
BATCH = 300
_PAIRS = {}


def perturb_jax(jmodel, seed, scale=0.2):
    """Every trainable array of ``jmodel`` plus N(0, scale²) numpy noise
    (buffers, the MADE masks among them, stay as they are)."""
    rng = np.random.default_rng(seed)
    params, static = partition(jmodel)
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(
            scale * rng.standard_normal(a.shape), a.dtype), params)
    return combine(params, static)


def circular_state_dict(jmodel):
    """The reference-named state dict of a JAX ``build_circular_nsf``
    model: ``export_state_dict`` for each autoregressive layer, plus the
    entries it has no exporter for."""
    n = len(jmodel.flows) - 1  # the last flow is the PeriodicWrap
    sd = {}
    for i, flow in enumerate(jmodel.flows[:n]):
        for k, v in export_state_dict(flow).items():
            sd[f"flows.{i}.{k}"] = np.asarray(v)
        pre = flow.mprqat.autoregressive_net.preprocessing
        p = f"flows.{i}.mprqat.autoregressive_net.preprocessing."
        for name in ("weights", "scale", "ind", "ind_", "inv_perm"):
            sd[p + name] = np.asarray(getattr(pre, name))
    wrap = jmodel.flows[n]
    sd[f"flows.{n}.ind"] = np.asarray(wrap.ind)
    sd[f"flows.{n}.bound"] = np.asarray(wrap.bound)
    for name in ("scale", "ind", "ind_", "inv_perm"):
        sd["q0." + name] = np.asarray(getattr(jmodel.q0, name))
    return sd


def circular_pair(seed=0, **kw):
    """(JAX model, port model on the CPU, state dict) with the same
    perturbed weights; built once per argument set."""
    key = (seed, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        args = dict(SMALL, **kw)
        jmodel = perturb_jax(jmodels.build_circular_nsf(
            jax.random.PRNGKey(seed), **args), seed)
        sd = circular_state_dict(jmodel)
        tmodel = nt.load_reference_state_dict(
            nt.build_circular_nsf(device="cpu", seed=seed, **args), sd)
        _PAIRS[key] = (jmodel, tmodel, sd)
    return _PAIRS[key]


def base_draws(n, seed, dim=2, ind=(0,), scale=None):
    """The ``UniformGaussian`` draws both frameworks are fed: uniform
    (width ``scale``) at ``ind``, N(0, scale²) elsewhere."""
    rng = np.random.default_rng(seed)
    scale = np.ones(dim) if scale is None else np.asarray(scale)
    z = rng.standard_normal((n, dim))
    z[:, list(ind)] = rng.uniform(-0.5, 0.5, (n, len(ind)))
    return (z * scale).astype(np.float32)


def _inputs(seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2)) * 1.2
    x[:, 0] = rng.uniform(-np.pi, np.pi, n)
    return x.astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _made_pair(seed, bin_major, permute, preprocessing):
    features, hidden, mult = 3, 16, 5
    kw = dict(features=features, hidden_features=hidden, num_blocks=2,
              output_multiplier=mult, permute_mask=permute)
    jpre = (JPeriodic.create(features, [1], 0.7) if preprocessing else None)
    jmade = perturb_jax(JMADE.create(
        jax.random.PRNGKey(seed), preprocessing=jpre,
        bin_major_head=bin_major, **kw), seed)
    tpre = (PeriodicFeaturesElementwise(features, [1], 0.7)
            if preprocessing else None)
    tmade = MADE(preprocessing=tpre, bin_major_head=bin_major, **kw)
    sd = {k: np.asarray(v) for k, v in export_state_dict(jmade).items()}
    if preprocessing:
        for name in ("weights", "scale", "ind", "ind_", "inv_perm"):
            sd["preprocessing." + name] = np.asarray(
                getattr(jmade.preprocessing, name))
    return jmade, nt.load_reference_state_dict(tmade, sd), sd


@pytest.mark.parametrize("bin_major,permute,preprocessing", [
    (False, False, False), (True, False, False), (True, True, True),
    (False, True, True)])
def test_made_matches_jax(bin_major, permute, preprocessing):
    jmade, tmade, _ = _made_pair(7, bin_major, permute, preprocessing)
    x = np.random.default_rng(1).standard_normal((BATCH, 3)).astype(
        np.float32)
    want = jmade(jnp.asarray(x))
    with torch.no_grad():
        got = tmade(torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("residual", [True, False])
def test_made_out_degrees_on_meta_match_jax(residual):
    """``out_degrees`` of both block kinds reads its construction-time copy,
    so it works once the model is on a device whose buffers cannot be read
    (``meta``), and equals the JAX MADE's block degrees."""
    kw = dict(features=3, hidden_features=16, num_blocks=2,
              output_multiplier=5, use_residual_blocks=residual)
    jmade = JMADE.create(jax.random.PRNGKey(0), **kw)
    tmade = MADE(**kw).to("meta")
    assert tmade.initial_layer.degrees.device.type == "meta"
    assert len(tmade.blocks) == len(jmade.blocks) == 2
    for tblk, jblk in zip(tmade.blocks, jmade.blocks):
        np.testing.assert_array_equal(tblk.out_degrees,
                                      np.asarray(jblk.degrees))


@pytest.mark.parametrize("loader", ["load_state_dict", "compat"])
def test_made_out_degrees_follow_a_loaded_state_dict(loader):
    """A random-mask MADE loaded with another MADE's state dict (by
    ``load_state_dict``, or by ``compat.load_reference_state_dict``, which
    writes the ``degrees`` buffers) reports that MADE's degrees from
    ``out_degrees``, not its own construction-time ones."""
    kw = dict(features=3, hidden_features=16, num_blocks=2,
              output_multiplier=5, use_residual_blocks=False,
              random_mask=True)
    src = MADE(generator=torch.Generator().manual_seed(1), **kw)
    dst = MADE(generator=torch.Generator().manual_seed(2), **kw)
    assert any((s.out_degrees != d.out_degrees).any()
               for s, d in zip(src.blocks, dst.blocks))
    if loader == "compat":
        nt.load_reference_state_dict(
            dst, {k: v.numpy() for k, v in src.state_dict().items()})
    else:
        dst.load_state_dict(src.state_dict())
    for s, d in zip(src.blocks, dst.blocks):
        np.testing.assert_array_equal(d.out_degrees, s.out_degrees)
        np.testing.assert_array_equal(d.out_degrees,
                                      d.linear.degrees.numpy())


def test_made_is_autoregressive_with_a_permuted_order():
    """The port's own MADE (input order drawn from a torch generator):
    feature d's output rows depend only on features of lower degree."""
    made = MADE(3, 16, num_blocks=2, output_multiplier=5, permute_mask=True,
                bin_major_head=True,
                generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for p in made.parameters():
            p.normal_(generator=torch.Generator().manual_seed(3))
    deg = made.final_layer.degrees[:3]  # bin-major: one tile per parameter
    assert sorted(deg.tolist()) == [1, 2, 3]
    x = torch.randn(4, 3, requires_grad=True)
    out = made(x).reshape(5, 3, 4)  # rows param-major
    for d in range(3):
        g, = torch.autograd.grad(out[:, d].sum(), x, retain_graph=True)
        for j in range(3):
            depends = bool(g[:, j].abs().sum() > 0)
            assert depends == bool(deg[j] < deg[d]), (d, j)


@pytest.mark.parametrize("tails,bin_major", [
    ("linear", True), ("circular", True), (["circular", "linear"], True),
    (["circular", "linear"], False), (None, False)])
def test_ar_spline_layer_matches_jax(tails, bin_major):
    """Forward (one MADE pass), inverse (D passes) and log-dets of
    ``MaskedPiecewiseRationalQuadraticAutoregressive``, bin-major and
    bin-minor feeds, and the ``tails=None`` branch on [0, 1]."""
    from nf_tpu.flows.neural_spline.autoregressive import (
        MaskedPiecewiseRationalQuadraticAutoregressive as JAR)

    tb = np.asarray([np.pi, 3.0], np.float32) if tails is not None else 1.0
    kw = dict(features=2, hidden_features=16, num_bins=4, tails=tails,
              tail_bound=tb, num_blocks=1, permute_mask=True,
              bin_major_head=bin_major)
    jl = perturb_jax(JAR.create(jax.random.PRNGKey(3), **kw), 3)
    sd = {"autoregressive_net." + k: np.asarray(v)
          for k, v in export_state_dict(jl.autoregressive_net).items()}
    pre = jl.autoregressive_net.preprocessing
    if pre is not None:
        for name in ("weights", "scale", "ind", "ind_", "inv_perm"):
            sd["autoregressive_net.preprocessing." + name] = np.asarray(
                getattr(pre, name))
    tl = nt.load_reference_state_dict(
        tflows.MaskedPiecewiseRationalQuadraticAutoregressive(**kw), sd)
    x = _inputs(4)
    if tails is None:
        x = np.random.default_rng(4).uniform(0.01, 0.99, (BATCH, 2)).astype(
            np.float32)
    for method in ("forward", "inverse"):
        yj, lj = getattr(jl, method)(jnp.asarray(x))
        with torch.no_grad():
            yt, lt = getattr(tl, method)(torch.from_numpy(x))
        _close(yt, yj)
        _close(lt, lj)


def test_uniform_gaussian_and_periodic_flows_match_jax():
    z = _inputs(5) * 1.7
    scale = np.asarray([2 * np.pi, 1.3], np.float32)
    jq = JUniformGaussian.create(2, [0], scale=jnp.asarray(scale))
    tq = tdist.UniformGaussian(2, [0], scale=scale)
    _close(tq.log_prob(torch.from_numpy(z)), jq.log_prob(jnp.asarray(z)))
    for jf, tf in ((JPeriodicWrap.create([0], bound=np.pi),
                    tflows.PeriodicWrap([0], bound=np.pi)),
                   (JPeriodicShift.create([0, 1], bound=2.0, shift=0.7),
                    tflows.PeriodicShift([0, 1], bound=2.0, shift=0.7))):
        for method in ("forward", "inverse"):
            yj, lj = getattr(jf, method)(jnp.asarray(z))
            yt, lt = getattr(tf, method)(torch.from_numpy(z))
            _close(yt, yj)
            _close(lt, lj)
    # sampling: shape, support and its own log-density
    s, lp = tq.forward(1000, generator=torch.Generator().manual_seed(0))
    assert s.shape == (1000, 2)
    assert float(s[:, 0].abs().max()) <= np.pi
    _close(lp, tq.log_prob(s))


@pytest.mark.parametrize("method", ["log_prob", "inverse_and_log_det",
                                    "forward_and_log_det"])
def test_circular_nsf_matches_jax(method):
    jmodel, tmodel, _ = circular_pair()
    x = _inputs(6)
    out_j = getattr(jmodel, method)(jnp.asarray(x))
    with torch.no_grad():
        out_t = getattr(tmodel, method)(torch.from_numpy(x))
    for a, b in zip(out_t if isinstance(out_t, tuple) else (out_t,),
                    out_j if isinstance(out_j, tuple) else (out_j,)):
        _close(a, b)


def test_circular_nsf_sample_matches_jax_on_the_same_base_draws():
    jmodel, tmodel, _ = circular_pair()
    z0 = base_draws(BATCH, 9, scale=[2 * np.pi, 1.0])
    zj, lj = jnp.asarray(z0), jmodel.q0.log_prob(jnp.asarray(z0))
    for flow in jmodel.flows:
        zj, ld = flow.forward(zj)
        lj = lj - ld
    with torch.no_grad():
        zt = torch.from_numpy(z0)
        lt = tmodel.q0.log_prob(zt)
        for flow in tmodel.flows:
            zt, ld = flow.forward(zt)
            lt = lt - ld
    _close(zt, zj)
    _close(lt, lj)
    # and the model's own sampler: finite, wrapped, its log_q its log_prob
    with torch.no_grad():
        z, log_q = tmodel.sample(BATCH, generator=torch.Generator()
                                 .manual_seed(1))
        lp = tmodel.log_prob(z)
    assert torch.isfinite(z).all() and float(z[:, 0].abs().max()) <= np.pi
    _close(lp, log_q)


def test_mask_rows_are_permuted_to_bin_major():
    _, tmodel, sd = circular_pair()
    p = "flows.0.mprqat.autoregressive_net.final_layer."
    made = tmodel.flows[0].mprqat.autoregressive_net
    d, mult = made.bin_major_head
    for name in ("weight", "bias", "mask"):
        ref = sd[p + name]  # feature-major rows d*mult + p
        got = getattr(made.final_layer, name).detach().numpy()
        for q in range(mult):
            for f in range(d):
                np.testing.assert_array_equal(got[q * d + f],
                                              ref[f * mult + q])


def test_round_trip_and_kernel_free_cpu_path():
    _, tmodel, _ = circular_pair()
    x = torch.from_numpy(_inputs(10))
    a = tk.rqs_fwd.launches
    with torch.no_grad():
        z, ld_inv = tmodel.inverse_and_log_det(x)
        x2, ld_fwd = tmodel.forward_and_log_det(z)
    assert tk.rqs_fwd.launches == a
    _close(x2, x, 1e-4)
    _close(ld_fwd, -ld_inv)


def test_build_circular_nsf_defaults():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nt.build_circular_nsf(K=1, hidden=8)
    m = nt.build_circular_nsf(K=1, hidden=8, device="cpu")
    layer = m.flows[0].mprqat
    assert layer.tails == ("circular", "linear")
    _close(layer.tail_bound_arr, np.float32([np.pi, 3.0]), 0)
    _close(m.q0.scale, np.float32([2 * np.pi, 1.0]), 0)
    assert layer.autoregressive_net.bin_major_head == (2, 31)
    x = torch.from_numpy(_inputs(11))
    with torch.no_grad():  # the identity init: log q is the base's
        _close(m.log_prob(x), m.q0.log_prob(x), 1e-5)
