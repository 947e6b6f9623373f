"""The port's image NSF (``nf_tpu_torch.build_image_nsf`` and its pieces:
``Logit``/``Shift``, the preprocessing, ``Squeeze``/``Split``/``Merge``,
``Invertible1x1Conv``, ``ConvResidualNet``, the 4D bin-major coupling,
``GlowBase``/``ClassCondDiagGaussian``, ``MultiscaleFlow``, bits/dim and
serving with ``class_cond`` and ``temperature``) against the JAX package,
on the CPU.

A small ``build_image_nsf`` (3 x 8 x 8, L 2, K 2, hidden 8, 4 bins) is
built in JAX, its export perturbed with numpy noise (N(0, 0.1²) on every
float array but the permutation ``P``, ``sign_S`` and ``eye`` of the LU
1x1 convolutions) with its ActNorms marked not yet set
(``data_dep_init_done`` 0), and loaded into both frameworks. Inputs come
from a numpy seed: pixels in (0.05, 0.95). Where the model draws, both
frameworks get numpy's draws (:func:`jax_fixed_bases` /
:func:`torch_fixed_bases`). Tolerance: 1e-4 on outputs, latents and
pixels abs; on log-densities and log-dets (~1e2-1e3 nats here) and on
gradients, 1e-4 after dividing by ``max(max |value|, 1)`` (the JAX
package's bar). On the CPU the port's spline runs its plain path, the
JAX package's its dense path, and on a small 4D shape the Pallas kernel
in interpret mode.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.models as jmodels
import nf_tpu_torch as nt
from nf_tpu.compat import import_state_dict
from nf_tpu.compat_export import export_state_dict
from nf_tpu.data import procedural_image_classes as jprocedural
from nf_tpu.distributions.base import ClassCondDiagGaussian as JClassCond
from nf_tpu.distributions.base import GlowBase as JGlowBase
from nf_tpu.flows import Invertible1x1Conv as JConv1x1
from nf_tpu.flows import Merge as JMerge
from nf_tpu.flows import Split as JSplit
from nf_tpu.flows import Squeeze as JSqueeze
from nf_tpu.nets import ConvResidualNet as JConvResNet
from nf_tpu.ops.splines_pallas import fused_unconstrained_rqs_kmajor
from nf_tpu.transforms import Logit as JLogit
from nf_tpu.transforms import Shift as JShift
from nf_tpu.utils import preprocessing as jpre
from nf_tpu.utils.eval import bits_per_dim as jbits_per_dim
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.compat import _reference_names
from nf_tpu_torch.distributions.base import _gaussian_sample
from nf_tpu_torch.nets import ConvResidualNet
from nf_tpu_torch.ops import splines as tsplines
from nf_tpu_torch.ops import splines_kernel as tk
from nf_tpu_torch.transforms import Logit, Shift
from nf_tpu_torch.utils import preprocessing as tpre
from nf_tpu_torch.utils.eval import bits_per_dim, bits_per_dim_dataset

TOL = 1e-4
SHAPE = (3, 8, 8)
SMALL = dict(input_shape=SHAPE, L=2, K=2, hidden_channels=8, num_bins=4)
BATCH = 12
_PAIRS = {}
_FIXED = ("P", "sign_S", "eye")


def perturbed(sd, seed, scale=0.1):
    """A reference-named state dict with N(0, scale²) added to every float
    array but the LU permutations, signs and identities, and every ActNorm
    marked not yet set."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        v = np.asarray(v)
        if k.endswith("data_dep_init_done"):
            v = np.zeros_like(v)
        elif v.dtype.kind == "f" and k.rsplit(".", 1)[-1] not in _FIXED:
            v = (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
        out[k] = v
    return out


def model_pair(jbuild, tbuild, kw, seed=0, scale=0.1):
    """(JAX model, port model on the CPU, state dict): the same perturbed
    weights; fresh port copies each call."""
    key = (jbuild.__name__, repr(sorted(kw.items())), seed)
    if key not in _PAIRS:
        jmodel = jbuild(jax.random.PRNGKey(seed), **kw)
        sd = perturbed(export_state_dict(jmodel), seed, scale)
        _PAIRS[key] = (import_state_dict(jmodel, sd),
                       nt.load_reference_state_dict(
                           tbuild(device="cpu", **kw), sd), sd)
    jmodel, tmodel, sd = _PAIRS[key]
    return jmodel, copy.deepcopy(tmodel), sd


def _pair(**extra):
    return model_pair(jmodels.build_image_nsf, nt.build_image_nsf,
                      dict(SMALL, **extra))


def pixels(n=BATCH, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.95, (n,) + shape).astype(np.float32)


def labels(n=BATCH, seed=0, num_classes=10):
    return np.random.default_rng(seed + 100).integers(
        0, num_classes, n).astype(np.int64)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0)


def rel_close(got, want, tol=TOL):
    """|got - want| <= tol * max(max |want|, 1): log-densities, log-dets
    and gradients."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def t(a):
    return torch.from_numpy(np.asarray(a))


def port_grads_close(tmodel, jgrads, static, tol=TOL):
    """Every parameter gradient of ``tmodel`` against the JAX gradients
    ``jgrads`` (a params tree), by reference name."""
    want = export_state_dict(combine(jgrads, static))
    names = _reference_names(tmodel, tmodel.state_dict())
    for name, p in tmodel.named_parameters():
        rel_close(p.grad.numpy(), want[names[name]], tol)


def jax_fixed_bases(jmodel, eps):
    """``jmodel`` whose level-i base draws ``eps[i]`` (numpy) in place of
    its own draw, at the base's temperature, given labels."""
    q0 = []
    for q, e in zip(jmodel.q0, eps):
        base = type(q)

        def forward(self, key, num_samples=1, y=None, _e=jnp.asarray(e),
                    _base=base):
            if _base is JGlowBase:
                loc, log_scale = self._params(y, num_samples)
                z = loc + jnp.exp(log_scale) * _e
                num_pix = int(np.prod(self.shape[1:]))
                dims = tuple(range(1, len(self.shape) + 1))
                log_p = (-0.5 * int(np.prod(self.shape)) * np.log(2 * np.pi)
                         - num_pix * jnp.sum(log_scale, axis=dims)
                         - 0.5 * jnp.sum(_e ** 2, axis=dims))
                return z, log_p
            loc, log_scale = self._params(y)
            z = loc + jnp.exp(log_scale) * _e
            log_p = -0.5 * int(np.prod(self.shape)) * np.log(2 * np.pi) \
                - jnp.sum(log_scale + 0.5 * _e ** 2,
                          axis=tuple(range(1, _e.ndim)))
            return z, log_p

        fixed = type("Fixed" + base.__name__, (base,), {"forward": forward})
        q0.append(fixed(**{f: getattr(q, f) for f in
                           q.__dataclass_fields__}))
    return jmodel.replace(q0=tuple(q0))


def torch_fixed_bases(tmodel, eps):
    """A copy of ``tmodel`` whose level-i base draws ``eps[i]``; the draw
    follows the base through ``with_temperature``."""
    m = copy.deepcopy(tmodel)

    def forward(self, num_samples=1, generator=None, y=None):
        loc, log_scale = self._params(y)
        e = self._eps
        if isinstance(self, tdist.GlowBase):
            return loc + torch.exp(log_scale) * e, self._log_p(log_scale,
                                                               e ** 2)
        return _gaussian_sample(loc, log_scale, e)

    for q, e in zip(m.q0, eps):
        q.__class__ = type("Fixed" + type(q).__name__, (type(q),),
                           {"forward": forward})
        q._eps = torch.from_numpy(e)
    return m


def level_eps(tmodel, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n,) + q.shape).astype(np.float32)
            for q in tmodel.q0]


# --- data and transforms -----------------------------------------------------

def test_procedural_image_classes_is_jax_bitwise():
    got = nt.data.procedural_image_classes(3, 17, num_classes=7, size=12)
    want = jprocedural(3, 17, num_classes=7, size=12)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_preprocessing_matches_jax():
    x = pixels()
    close(tpre.Scale()(t(x)), jpre.Scale()(jnp.asarray(x)), 0)
    logit, jlogit = tpre.Logit(0.05), jpre.Logit(0.05)
    close(logit(t(x)), jlogit(jnp.asarray(x)))
    close(logit.inverse(logit(t(x))), x)
    close(jlogit.inverse(jnp.asarray(np.asarray(logit(t(x))))), x)
    jit = tpre.Jitter()
    a = jit(t(x), generator=torch.Generator().manual_seed(1))
    b = jit(t(x), generator=torch.Generator().manual_seed(1))
    noise = (a - t(x)).numpy()
    assert torch.equal(a, b) and noise.min() >= 0
    assert noise.max() <= 1 / 256 + 1e-7 and noise.std() > 0


@pytest.mark.parametrize("method", ["forward", "inverse"])
def test_logit_and_shift_transforms_match_jax(method):
    x = pixels()
    inp = x if method == "inverse" else np.log(x / (1 - x))
    for tflow, jflow in ((Logit(0.05), JLogit(alpha=0.05)),
                         (Shift(-0.5), JShift(shift=-0.5))):
        zt, lt = getattr(tflow, method)(t(inp))
        zj, lj = getattr(jflow, method)(jnp.asarray(inp))
        close(zt, zj)
        rel_close(lt, lj)
        assert lt.shape == (BATCH,)


# --- reshape, mixing, the conditioner ----------------------------------------

@pytest.mark.parametrize("mode", ["channel", "channel_inv", "checkerboard",
                                  "checkerboard_inv"])
def test_split_and_merge_match_jax(mode):
    x = pixels(shape=(5, 4, 6))
    (a, b), ld = tflows.Split(mode).forward(t(x))
    (ja, jb), _ = JSplit(mode=mode).forward(jnp.asarray(x))
    close(a, ja, 0)
    close(b, jb, 0)
    assert torch.equal(ld, torch.zeros(BATCH))
    back, ld = tflows.Split(mode).inverse([a, b])
    close(back, x, 0)
    merged, _ = tflows.Merge(mode).forward([a, b])
    close(merged, JMerge(mode=mode).forward([ja, jb])[0], 0)
    assert torch.equal(tflows.Merge(mode).inverse(merged)[0][1], b)


def test_squeeze_matches_jax():
    x = pixels()
    z, ld = tflows.Squeeze().inverse(t(x))
    zj, _ = JSqueeze().inverse(jnp.asarray(x))
    close(z, zj, 0)
    assert z.shape == (BATCH, 12, 4, 4)
    assert torch.equal(ld, torch.zeros(BATCH))
    close(tflows.Squeeze().forward(z)[0], x, 0)


@pytest.mark.parametrize("use_lu", [True, False])
@pytest.mark.parametrize("method", ["forward", "inverse"])
def test_invertible_1x1_conv_matches_jax(use_lu, method):
    jflow = JConv1x1.create(jax.random.PRNGKey(2), 6, use_lu=use_lu)
    sd = perturbed(export_state_dict(jflow), 2)
    jflow = import_state_dict(jflow, sd)
    tflow = nt.load_reference_state_dict(
        tflows.Invertible1x1Conv(6, use_lu=use_lu), sd)
    x = pixels(shape=(6, 4, 4))
    zt, lt = getattr(tflow, method)(t(x))
    zj, lj = getattr(jflow, method)(jnp.asarray(x))
    close(zt.detach(), zj)
    rel_close(lt.detach(), lj)
    back, ld_back = getattr(tflow, "inverse" if method == "forward"
                            else "forward")(zt)
    close(back.detach(), x)
    rel_close((lt + ld_back).detach(), np.zeros(BATCH))


@pytest.mark.parametrize("context", [False, True])
def test_conv_residual_net_matches_jax(context):
    ctx_ch = 2 if context else None
    jnet = JConvResNet.create(jax.random.PRNGKey(3), 3, 5, 8,
                              context_channels=ctx_ch, num_blocks=2)
    sd = perturbed(export_state_dict(jnet), 3)
    jnet = import_state_dict(jnet, sd)
    tnet = nt.load_reference_state_dict(
        ConvResidualNet(3, 5, 8, context_channels=ctx_ch), sd)
    x = pixels(shape=(3, 6, 6))
    ctx = pixels(seed=4, shape=(2, 6, 6)) if context else None
    got = tnet(t(x), None if ctx is None else t(ctx))
    want = jnet(jnp.asarray(x), None if ctx is None else jnp.asarray(ctx))
    close(got.detach(), want)
    assert tnet.hidden_channels == 8


# --- the 4D spline feed and its kernel views ---------------------------------

def _image_planes(seed, b=3, c=2, h=4, w=5, K=4):
    """x (b, c, h, w) and bin-major planes made as the image coupling makes
    them: a (b, c*P, h, w) conditioner output viewed as (P, b, c, h, w)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c, h, w)) * 1.5).astype(np.float32)
    out = (rng.standard_normal((b, c * (3 * K - 1), h, w)) * 0.5).astype(
        np.float32)
    return x, out


@pytest.mark.parametrize("inverse", [False, True])
def test_image_feed_matches_the_pallas_kernel_in_interpret_mode(inverse):
    """The bin-major 4D spline of the port (plain on the CPU) against the
    JAX package's k-major Pallas kernel in interpret mode, the same padded
    (K+1) derivative planes on both sides."""
    K = 4
    x, out = _image_planes(5, K=K)
    b, c, h, w = x.shape
    p = t(out).reshape(b, c, -1, h, w).permute(2, 0, 1, 3, 4)
    uw, uh = p[:K] * 0.3, p[K:2 * K] * 0.3
    ud = tsplines.pad_derivatives(p[2 * K:], "linear", 1e-3, axis=0)
    got_y, got_ld = tsplines.unconstrained_rational_quadratic_spline_kmajor(
        t(x), uw, uh, p[2 * K:], inverse=inverse, tails="linear",
        tail_bound=3.0)
    want_y, want_ld = fused_unconstrained_rqs_kmajor(
        jnp.asarray(x), jnp.asarray(uw.numpy()), jnp.asarray(uh.numpy()),
        jnp.asarray(ud.numpy()), 3.0, inverse=inverse, interpret=True)
    close(got_y, want_y, 1e-5)
    close(got_ld, want_ld)


def test_param_views_collapse_the_permuted_planes_without_a_copy():
    """The permuted (P, B, C, H, W) view of a (B, C*P, H, W) conditioner
    output has strides (HW, C*P*HW, P*HW, W, 1): (B, C) and (H, W) merge,
    so the kernels' (P, B*C, H*W) views share its storage."""
    K = 4
    x, out = _image_planes(6, K=K)
    b, c, h, w = x.shape
    p = t(out).reshape(b, c, -1, h, w).permute(2, 0, 1, 3, 4)
    assert p.stride() == (h * w, c * p.shape[0] * h * w, p.shape[0] * h * w,
                          w, 1)
    planes = (p[:K], p[K:2 * K], p[2 * K:3 * K - 1])
    views = tk.param_views(t(x), *planes)
    for v, plane in zip(views, planes):
        assert v.shape == (plane.shape[0], b * c, h * w)
        assert v.data_ptr() == plane.data_ptr()
        assert v.stride() == (h * w, p.shape[0] * h * w, 1)
    # scaled by the softmax scale the planes keep that layout
    scaled = tk.param_views(t(x), *(q * 0.5 for q in planes))
    assert all(v.shape[1:] == (b * c, h * w) for v in scaled)
    x2, w3, h3, d3, tb = tk.kernel_views(
        t(x), *planes[:2], tsplines.pad_derivatives(planes[2], "linear",
                                                    1e-3, axis=0), 3.0)
    assert x2.shape == (b * c, h * w) and tb == 3.0
    assert tk.image_split(t(x), *planes) == 2


def test_image_views_fall_back_to_rows_of_images_or_raise():
    """Parameters shared over the batch (an image CDF's) collapse to
    (B, C*H*W); a per-channel tail bound, stride 0 inside both halves,
    cannot be viewed and raises rather than copy."""
    K = 4
    x, _ = _image_planes(7, K=K)
    shared = torch.zeros((K, 1) + x.shape[1:])
    assert tk.image_split(t(x), shared, shared, torch.zeros(
        (K + 1, 1) + x.shape[1:])) == 1
    views = tk.param_views(t(x), shared, shared, shared)
    assert views[0].shape == (K, 1, int(np.prod(x.shape[1:])))
    full = torch.zeros((K,) + x.shape).transpose(1, 2)  # (K, C, B, H, W)^T
    with pytest.raises(ValueError, match="without a copy"):
        tk.image_split(t(x), full, full, full)
    planes = torch.zeros((K,) + x.shape)
    with pytest.raises(ValueError, match="without a copy"):
        tk.image_split(t(x), planes, planes, planes,
                       torch.ones((1, x.shape[1], 1, 1)))


@pytest.mark.parametrize("inverse", [False, True])
def test_image_coupling_matches_jax(inverse):
    """One 4D RQ-spline coupling (the bin-major feed) of the small model."""
    jmodel, tmodel, _ = _pair()
    jc, tc = jmodel.flows[1][2], tmodel.flows[1][2]
    x = np.random.default_rng(8).standard_normal(
        (BATCH, 12, 4, 4)).astype(np.float32) * 1.5
    method = "inverse" if inverse else "forward"
    zt, lt = getattr(tc, method)(t(x))
    zj, lj = getattr(jc, method)(jnp.asarray(x))
    close(zt.detach(), zj)
    rel_close(lt.detach(), lj)
    assert not np.allclose(zt.detach().numpy(), x, atol=1e-3)


# --- bases ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["glow", "glow_cc", "class_cond"])
@pytest.mark.parametrize("temperature", [None, 0.6])
def test_image_bases_match_jax(kind, temperature):
    shape = (4, 2, 3)
    if kind == "class_cond":
        jq = JClassCond.create(shape, 5)
        tq = tdist.ClassCondDiagGaussian(shape, 5)
    else:
        n = 5 if kind == "glow_cc" else None
        jq = JGlowBase.create(shape, num_classes=n)
        tq = tdist.GlowBase(shape, num_classes=n)
    sd = perturbed(export_state_dict(jq), 9, 0.3)
    jq = import_state_dict(jq, sd)
    tq = nt.load_reference_state_dict(tq, sd)
    if temperature is not None:
        jq, tq = jq.with_temperature(temperature), \
            tq.with_temperature(temperature)
        assert tq.loc is not None
    z = pixels(shape=shape)
    y = labels(num_classes=5)
    got = tq.log_prob(t(z), t(y))
    want = jq.log_prob(jnp.asarray(z), jnp.asarray(y))
    rel_close(got.detach(), want)
    # one-hot labels give the same density
    rel_close(tq.log_prob(t(z), torch.nn.functional.one_hot(
        t(y), 5).float()).detach(), want)
    draws, log_p = tq.forward(BATCH, torch.Generator().manual_seed(0),
                              y=t(y) if kind != "glow" else None)
    assert draws.shape == (BATCH,) + shape
    rel_close(log_p.detach(), tq.log_prob(draws, t(y)).detach(), 1e-5)


def test_with_temperature_shares_the_tensors_and_refuses_others():
    q = tdist.GlowBase((4, 2, 2))
    warm = q.with_temperature(0.5)
    assert warm.temperature == 0.5 and q.temperature is None
    assert warm.loc is q.loc and warm.log_scale_logs is q.log_scale_logs
    with pytest.raises(NotImplementedError, match="temperature"):
        tdist.DiagGaussian(2).with_temperature(0.5)


# --- the whole model -------------------------------------------------------------

@pytest.mark.parametrize("class_cond", [False, True])
def test_image_nsf_matches_jax(class_cond):
    jmodel, tmodel, _ = _pair(class_cond=class_cond)
    x, y = pixels(), labels()
    ys = (y,) if class_cond else ()
    zt, ldt = tmodel.inverse_and_log_det(t(x))
    zj, ldj = jmodel.inverse_and_log_det(jnp.asarray(x))
    for a, b in zip(zt, zj):
        close(a.detach(), b)
    rel_close(ldt.detach(), ldj)
    xt, ldt_f = tmodel.forward_and_log_det([z.detach() for z in zt])
    xj, ldj_f = jmodel.forward_and_log_det(zj)
    close(xt.detach(), xj)
    close(xt.detach(), x)
    rel_close(ldt_f.detach(), ldj_f)
    got = tmodel.log_prob(t(x), *(t(v) for v in ys))
    want = jmodel.log_prob(jnp.asarray(x), *(jnp.asarray(v) for v in ys))
    rel_close(got.detach(), want)
    close(bits_per_dim(tmodel, t(x), *(t(v) for v in ys)).detach(),
          jbits_per_dim(jmodel, jnp.asarray(x),
                        *(jnp.asarray(v) for v in ys)))


def test_bits_per_dim_dataset_matches_jax():
    from nf_tpu.utils.eval import bits_per_dim_dataset as jdataset

    jmodel, tmodel, _ = _pair(class_cond=True)
    batches = [(pixels(seed=s), labels(seed=s)) for s in range(2)]
    got = bits_per_dim_dataset(tmodel, [(t(a), t(b)) for a, b in batches])
    want = jdataset(jmodel, [(jnp.asarray(a), jnp.asarray(b))
                             for a, b in batches])
    close(got, want)


def test_init_from_data_matches_jax():
    jmodel, tmodel, _ = _pair()
    x = pixels(seed=11, n=32)
    jinit = jax.jit(lambda m, v: m.init_from_data(v))(jmodel,
                                                     jnp.asarray(x))
    assert tmodel.init_from_data(t(x)) is tmodel
    want = export_state_dict(jinit)
    for name, v in tmodel.state_dict().items():
        if name.endswith(".s") or name.endswith(".t"):
            close(v, want[name])
    # every ActNorm was set: the density direction's output is whitened
    z, _ = tmodel.inverse_and_log_det(t(x))
    x2 = pixels(seed=12)
    rel_close(tmodel.log_prob(t(x2)).detach(), jinit.log_prob(
        jnp.asarray(x2)))
    for level in tmodel.flows:
        for flow in level:
            if isinstance(flow, tflows.ActNorm):
                assert float(flow.data_dep_init_done) == 1.0


@pytest.mark.parametrize("class_cond", [False, True])
@pytest.mark.parametrize("temperature", [None, 0.7])
def test_sample_matches_jax_on_the_same_base_draws(class_cond, temperature):
    jmodel, tmodel, _ = _pair(class_cond=class_cond)
    eps = level_eps(tmodel, BATCH, 13)
    y = labels(seed=13) if class_cond else None
    zt, lqt = torch_fixed_bases(tmodel, eps).sample(
        BATCH, y=None if y is None else t(y), temperature=temperature)
    zj, lqj = jax_fixed_bases(jmodel, eps).sample(
        jax.random.PRNGKey(0), BATCH,
        y=None if y is None else jnp.asarray(y), temperature=temperature)
    close(zt.detach(), zj)
    rel_close(lqt.detach(), lqj)
    # the density of the samples under the model at that temperature
    warm = tmodel.set_temperature(temperature) if temperature else tmodel
    jwarm = jmodel.set_temperature(temperature) if temperature else jmodel
    ys = () if y is None else (y,)
    rel_close(warm.log_prob(zt.detach(), *(t(v) for v in ys)).detach(),
              jwarm.log_prob(zj, *(jnp.asarray(v) for v in ys)))


def test_class_conditional_sample_draws_one_label_per_sample():
    """Without ``y`` a class-conditional model draws the labels first from
    the generator, one per sample, and gives them to every level: the
    same as drawing them and passing them."""
    _, tmodel, _ = _pair(class_cond=True)
    with torch.no_grad():
        z, log_q = tmodel.sample(BATCH, torch.Generator().manual_seed(4))
        gen = torch.Generator().manual_seed(4)
        y = torch.randint(0, 10, (BATCH,), generator=gen)
        z2, log_q2 = tmodel.sample(BATCH, gen, y=y)
    assert torch.equal(z, z2) and torch.equal(log_q, log_q2)


def test_forward_kld_gradients_match_jax():
    jmodel, tmodel, _ = _pair()
    x = pixels(seed=14)
    params, static = partition(jmodel)
    loss_j, grads = jax.jit(jax.value_and_grad(
        lambda p: combine(p, static).forward_kld(jnp.asarray(x))))(params)
    loss_t = tmodel.forward_kld(t(x))
    loss_t.backward()
    rel_close(float(loss_t), float(loss_j))
    port_grads_close(tmodel, grads, static)


def test_forward_kld_step_matches_jax():
    """One ``make_forward_kld_step`` with SGD against the JAX step with
    ``optax.sgd``."""
    import optax

    import nf_tpu.parallel as jpar

    lr = 1e-3
    jmodel, tmodel, _ = _pair(class_cond=True)
    x, y = pixels(seed=15), labels(seed=15)
    jopt = optax.sgd(lr)
    jstate, static = jpar.init_train_state(jmodel, jopt)
    jstep = jpar.make_forward_kld_step(
        static, jopt, loss_fn=lambda m, b: m.forward_kld(b[0], b[1]))
    jstate, loss_j = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
    topt = torch.optim.SGD(tmodel.parameters(), lr=lr)
    loss_t = nt.make_forward_kld_step(topt)(
        nt.init_train_state(tmodel, topt), (t(x), t(y)))
    rel_close(float(loss_t), float(loss_j))
    want = export_state_dict(jpar.model_of_state(jstate, static))
    for name, p in tmodel.named_parameters():
        close(p.detach(), want[name])


# --- serving, builders -------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 12])
def test_served_log_prob_with_labels_is_the_eager_model(n):
    _, tmodel, _ = _pair(class_cond=True)
    x, y = pixels(n=n, seed=16), labels(n=n, seed=16)
    fn = nt.compile_log_prob(tmodel, (n,) + SHAPE, class_cond=True)
    with torch.no_grad():
        want = tmodel.log_prob(t(x), t(y))
    assert torch.equal(fn(t(x), t(y).int()), want)
    ladder = nt.compile_log_prob_buckets(tmodel, 16, SHAPE,
                                         class_cond=True)
    got = ladder(t(x), t(y))
    b = next(b for b in ladder.buckets if b >= n)
    pad = [np.concatenate([a, np.repeat(a[-1:], b - n, 0)]) for a in (x, y)]
    with torch.no_grad():
        rel_close(got, tmodel.log_prob(t(pad[0]), t(pad[1]))[:n], 1e-6)
    with pytest.raises(ValueError, match="exclusive"):
        nt.compile_log_prob(tmodel, (n,) + SHAPE, context_shape=(n, 2),
                            class_cond=True)


def test_served_sampler_with_labels_and_temperature_is_the_eager_model():
    _, tmodel, _ = _pair(class_cond=True)
    y = t(labels(seed=17))
    fn = nt.compile_sampler(tmodel, BATCH, temperature=0.7, class_cond=True)
    z, log_q = fn(3, y)
    with torch.no_grad():
        ze, lqe = tmodel.sample(BATCH, torch.Generator().manual_seed(3),
                                y=y, temperature=0.7)
    assert torch.equal(z, ze) and torch.equal(log_q, lqe)
    own = nt.compile_sampler(tmodel, BATCH, temperature=0.7)
    z, log_q = own(5)
    with torch.no_grad():
        ze, lqe = tmodel.sample(BATCH, torch.Generator().manual_seed(5),
                                temperature=0.7)
    assert torch.equal(z, ze) and torch.equal(log_q, lqe)
    with pytest.raises(ValueError, match="exclusive"):
        nt.compile_sampler(tmodel, BATCH, context_shape=(BATCH, 2),
                           class_cond=True)
    with pytest.raises(ValueError, match="temperature"):
        nt.compile_sampler(tmodel, BATCH, temperature=0.7,
                           context_shape=(BATCH, 2))


def test_builder_defaults_and_device():
    m = nt.build_image_nsf(device="cpu")
    assert isinstance(m, nt.MultiscaleFlow) and m.num_levels == 2
    assert [len(level) for level in m.flows] == [13, 13]
    coupling = m.flows[1][2]
    assert coupling.transform_net.hidden_channels == 64
    assert coupling.softmax_scale == pytest.approx(1 / 8)
    assert [q.shape for q in m.q0] == [(24, 8, 8), (6, 16, 16)]
    assert isinstance(m.q0[0], tdist.GlowBase)
    assert isinstance(m.transform, Logit) and m.transform.alpha == 0.05
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            nt.build_image_nsf()
