"""The port's circular coupled NSF layer
(``CircularCoupledRationalQuadraticSpline``), ``PeriodicFeaturesCat`` and
``ResidualNet(preprocessing=)`` against the JAX package, on the CPU.

The JAX modules' trainable arrays get numpy noise N(0, 0.2²) (with the
identity init every spline is the identity) and cross to the port through
``nf_tpu.compat_export.export_state_dict`` plus what it has no exporter
for, the trunk's periodic ``preprocessing`` (:func:`layer_state_dict`).
Shapes are those of ``tests/test_bin_major_head.py:85-100,171-187``: dim 2
with ``ind_circ=[0]`` in both mask orientations (per-feature tail bounds
(pi, 3)), dim 2 all-circular, dim 3 with one circular feature; hidden 16,
2 blocks, 4 bins. Tolerance 1e-4 abs on outputs and log-dets; gradients
1e-4 after dividing by max(max |gradient|, 1).

On the CPU no coupling takes kernel B (its gate wants a CUDA tensor), so
the fused feed is also driven directly: kernel B's plain version with the
3K+1 head's effective rows against the unfused feed, both directions,
circular and linear transformed halves, values and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.flows as jflows
import nf_tpu_torch as nt
from nf_tpu.compat_export import export_state_dict
from nf_tpu.core import NormalizingFlow as JNormalizingFlow
from nf_tpu.distributions.base import UniformGaussian as JUniformGaussian
from nf_tpu.nets.resnet import ResidualNet as JResidualNet
from nf_tpu.utils.module import combine, partition
from nf_tpu.utils.nn import PeriodicFeaturesCat as JPeriodicCat
from nf_tpu.utils.nn import PeriodicFeaturesElementwise as JPeriodic
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.flows.neural_spline.feed import FusedFeed
from nf_tpu_torch.nets import ResidualNet
from nf_tpu_torch.utils import PeriodicFeaturesCat, PeriodicFeaturesElementwise

TOL = 1e-4
BATCH = 200
LAYER = dict(num_blocks=2, num_hidden_channels=16, num_bins=4)
CASES = {
    "dim2-angle-transformed": dict(num_input_channels=2, ind_circ=[0],
                                   tail_bound=(np.pi, 3.0),
                                   reverse_mask=True),
    "dim2-angle-identity": dict(num_input_channels=2, ind_circ=[0],
                                tail_bound=(np.pi, 3.0), reverse_mask=False),
    "dim2-all-circular": dict(num_input_channels=2, ind_circ=[0, 1],
                              tail_bound=np.pi),
    "dim3-one-circular": dict(num_input_channels=3, ind_circ=[0],
                              tail_bound=np.pi, reverse_mask=True),
}


def perturb(jmodule, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    params, static = partition(jmodule)
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(scale * rng.standard_normal(a.shape),
                                  a.dtype), params)
    return combine(params, static)


def _pre_state_dict(pre, prefix):
    return {prefix + n: np.asarray(getattr(pre, n))
            for n in ("weights", "scale", "ind", "ind_", "inv_perm")}


def layer_state_dict(jlayer, prefix=""):
    """A JAX circular coupling's reference-named state dict: the exporter's
    entries plus the trunk's periodic features."""
    sd = {prefix + k: np.asarray(v)
          for k, v in export_state_dict(jlayer).items()}
    pre = jlayer.prqct.transform_net.preprocessing
    if pre is not None:
        sd.update(_pre_state_dict(
            pre, prefix + "prqct.transform_net.preprocessing."))
    return sd


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(a):
    return np.asarray(a.detach() if torch.is_tensor(a) else a)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def _rel_close(got, want, tol=TOL):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else _np(got)
    assert float(np.max(np.abs(got - want))) \
        / max(float(np.max(np.abs(want))), 1.0) <= tol


def _inputs(dim, seed, batch=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, dim)) * 1.5
    x[:, 0] = rng.uniform(-np.pi, np.pi, batch)  # the angle
    return x.astype(np.float32)


def _layer_pair(case, seed=0):
    kw = {**LAYER, **CASES[case]}
    jlayer = perturb(jflows.CircularCoupledRationalQuadraticSpline.create(
        jax.random.PRNGKey(seed), **kw), seed)
    tlayer = nt.load_reference_state_dict(
        tflows.CircularCoupledRationalQuadraticSpline(**kw),
        layer_state_dict(jlayer))
    return jlayer, tlayer


def test_periodic_features_cat_matches_jax():
    x = np.random.default_rng(0).standard_normal((BATCH, 4)) \
        .astype(np.float32)
    j = JPeriodicCat.create(4, [1, 3], scale=[0.5, 2.0])
    t = PeriodicFeaturesCat(4, [1, 3], scale=[0.5, 2.0])
    _close(t(_t(x)), j(jnp.asarray(x)))
    assert t(_t(x)).shape == (BATCH, 6)


def test_residual_net_preprocessing_matches_jax_both_ways():
    """``forward`` and ``features_transposed`` both run the periodic
    features before the trunk (the fused head's trunk included)."""
    key = jax.random.PRNGKey(1)
    jpre = JPeriodic.create(3, [0, 2], scale=[1.0, 0.5])
    jnet = perturb(JResidualNet.create(key, 3, 8, 16, num_blocks=2,
                                       preprocessing=jpre,
                                       bin_major_head=(2, 4)), 1)
    tnet = ResidualNet(3, 8, 16, num_blocks=2, bin_major_head=(2, 4),
                       preprocessing=PeriodicFeaturesElementwise(
                           3, [0, 2], scale=[1.0, 0.5]))
    sd = {k: np.asarray(v) for k, v in export_state_dict(jnet).items()}
    sd.update(_pre_state_dict(jnet.preprocessing, "preprocessing."))
    nt.load_reference_state_dict(tnet, sd)
    x = _inputs(3, seed=2)
    _close(tnet(_t(x)), jnet(jnp.asarray(x)))
    _close(tnet.features_transposed(_t(x)),
           jnet.features_transposed(jnp.asarray(x)))
    # the trunk without its preprocessing would give another answer
    bare = tnet.features_transposed
    tnet.preprocessing = None
    assert np.max(np.abs(_np(bare(_t(x))) - np.asarray(
        jnet.features_transposed(jnp.asarray(x))))) > 1e-2


@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_jax(case):
    jlayer, tlayer = _layer_pair(case, seed=3)
    dim = CASES[case]["num_input_channels"]
    x = _inputs(dim, seed=4)
    for method in ("forward", "inverse"):
        yj, ldj = getattr(jlayer, method)(jnp.asarray(x))
        yt, ldt = getattr(tlayer, method)(_t(x))
        _close(yt, yj)
        _close(ldt, ldj)
    # a round trip, the angle's circle closed
    y, _ = tlayer.forward(_t(x))
    _close(tlayer.inverse(y)[0], x)


def test_layer_gradients_match_jax():
    jlayer, tlayer = _layer_pair("dim2-angle-transformed", seed=5)
    x = _inputs(2, seed=6)

    def jloss(p):
        y, ld = combine(p, static).forward(jnp.asarray(x))
        return jnp.sum(jnp.sin(y)) + jnp.sum(ld)

    params, static = partition(jlayer)
    jg = jax.grad(jloss)(params)
    y, ld = tlayer.forward(_t(x))
    (torch.sum(torch.sin(y)) + torch.sum(ld)).backward()
    want = layer_state_dict(combine(jg, static))
    for name, p in tlayer.named_parameters():
        _rel_close(p.grad, want[name])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("case", ["dim2-angle-transformed",
                                  "dim2-angle-identity"])
def test_fused_feed_of_the_3k1_head_matches_unfused(case, inverse):
    """Kernel B's path (its plain version on the CPU) with the per-feature
    3K+1 head: circular tails where the angle is transformed, linear where
    it is not; values and the head's gradients against the unfused feed."""
    from nf_tpu_torch.flows.neural_spline.feed import fused_head_eligible

    _, tlayer = _layer_pair(case, seed=7)
    prqct = tlayer.prqct
    net = prqct.transform_net
    assert fused_head_eligible(net, prqct.tails, prqct.tail_bound_arr,
                               prqct.num_bins)
    x = _t(_inputs(2, seed=8))
    id_split, t_split = prqct._split(x)
    outs = []
    for fused in (True, False):
        net.zero_grad()
        params = FusedFeed(net.features_transposed(id_split)) if fused \
            else net(id_split)
        y, ld = prqct._coupling_transform(t_split, params, inverse)
        (torch.sum(torch.sin(y)) + torch.sum(ld)).backward()
        outs.append((y, ld, net.final_layer.weight.grad.clone(),
                     net.initial_layer.weight.grad.clone()))
    for a, b in zip(*outs):
        _rel_close(a, _np(b), 1e-5)


def _model(case, K, seed):
    """K circular couplings (alternating masks), ``PeriodicWrap`` and a
    ``UniformGaussian`` base, in both frameworks, the same weights."""
    kw = {**LAYER, **CASES[case]}
    kw.pop("reverse_mask", None)
    dim, ind = kw["num_input_channels"], kw["ind_circ"]
    scale = np.ones(dim, np.float32)
    scale[ind] = 2 * np.pi
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    jmodel = perturb(JNormalizingFlow.create(
        JUniformGaussian.create(dim, ind=ind, scale=jnp.asarray(scale)),
        [jflows.CircularCoupledRationalQuadraticSpline.create(
            keys[i], reverse_mask=(i % 2 == 1), **kw) for i in range(K)]
        + [jflows.PeriodicWrap.create(ind, bound=np.pi)]), seed)
    tmodel = nt.NormalizingFlow(
        tdist.UniformGaussian(dim, ind=ind, scale=scale),
        [tflows.CircularCoupledRationalQuadraticSpline(
            reverse_mask=(i % 2 == 1), **kw) for i in range(K)]
        + [tflows.PeriodicWrap(ind, bound=np.pi)])
    sd = {}
    for i, layer in enumerate(jmodel.flows[:K]):
        sd.update(layer_state_dict(layer, f"flows.{i}."))
    sd[f"flows.{K}.ind"] = np.asarray(jmodel.flows[K].ind)
    sd[f"flows.{K}.bound"] = np.asarray(jmodel.flows[K].bound)
    for name in ("scale", "ind", "ind_", "inv_perm"):
        sd["q0." + name] = np.asarray(getattr(jmodel.q0, name))
    return jmodel, nt.load_reference_state_dict(tmodel, sd)


def test_circular_coupled_model_matches_jax():
    """The chip phase's model at a small size (K 2, dim 2, the angle
    feature 0): log_prob, and the push-forward of the same base draws."""
    jmodel, tmodel = _model("dim2-angle-transformed", K=2, seed=9)
    x = _inputs(2, seed=10)
    _close(tmodel.log_prob(_t(x)), jmodel.log_prob(jnp.asarray(x)))
    z0 = _inputs(2, seed=11)
    zj, ldj = jmodel.forward_and_log_det(jnp.asarray(z0))
    zt, ldt = tmodel.forward_and_log_det(_t(z0))
    _close(zt, zj)
    _close(ldt, ldj)
