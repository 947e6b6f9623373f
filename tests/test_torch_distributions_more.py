"""The port's remaining layers, distributions and utils against the JAX
package, on the CPU.

Weights are the JAX modules' after numpy noise (N(0, 0.2²) unless a test
says otherwise), carried across by ``export_state_dict``; inputs are numpy
draws from a seed. Densities and layer outputs are held at 1e-4 abs
(gradients after dividing by max(max |gradient|, 1)). Sampling cannot be
compared draw for draw (JAX keys and torch generators give different
numbers), so each sampler is held to its density by moments, mode or
cell frequencies, or acceptance. The bfloat16 builders are held at the
mixed-precision bar, 0.05 abs plus 0.05 relative.

Covered: ``Uniform``, ``AffineGaussian`` (plain and class-conditional,
with a temperature), ``GaussianMixture`` (trainable or not),
``GaussianPCA``; the targets ``CircularGaussianMixture``, ``RingMixture``,
``TwoIndependent``; the priors ``ImagePrior``, ``Sinusoidal``,
``Sinusoidal_gap``, ``Sinusoidal_split``, ``Smiley``; the
``InvertibleAffine`` flow (LU and not) and a RealNVP-shaped stack with
``BatchNorm`` and ``InvertibleAffine``; the utils (``tile``, the mask
builders, ``ClampExp``, ``ConstScaleLayer``, the re-exports); the
``examples/change_base_distribution.py`` model; and ``dtype=`` on
``build_realnvp``, ``build_image_nsf`` and ``build_glow_multiscale``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.distributions as jdist
import nf_tpu.flows as jflows
import nf_tpu.models as jmodels
import nf_tpu.utils as jutils
import nf_tpu_torch as nt
from nf_tpu.compat_export import export_state_dict
from nf_tpu.core import NormalizingFlow as JNormalizingFlow
from nf_tpu.nets.mlp import MLP as JMLP
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from nf_tpu_torch import utils as tutils
from nf_tpu_torch.nets import MLP
from test_torch_autoregressive import perturb_jax

TOL = 1e-4
MP_TOL = 0.05  # bfloat16: abs, plus as much relative
B = 300
N_SAMPLE = 20000


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0)


def _rel_close(got, want, tol=TOL):
    """Within ``tol`` of ``want`` relative to max(|want|, 1): the
    priors' log-densities reach 1e2-1e3, where float32 keeps ~1e-4."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * np.maximum(np.abs(want), 1))


def _grad_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _load(tmodule, jmodule):
    sd = {k: np.asarray(v) for k, v in export_state_dict(jmodule).items()}
    return nt.load_reference_state_dict(tmodule, sd)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# --- base distributions ------------------------------------------------------

def test_uniform_matches_jax_and_samples_the_box():
    shape, low, high = (3,), -1.5, 2.0
    z = _x(1, (B, 3), 1.5)
    _close(tdist.Uniform(shape, low, high).log_prob(_t(z)),
           jdist.Uniform.create(shape, low, high).log_prob(jnp.asarray(z)))
    s, log_p = tdist.Uniform(shape, low, high).forward(N_SAMPLE, _gen())
    assert s.shape == (N_SAMPLE, 3) and torch.all(s >= low) \
        and torch.all(s <= high)
    _close(log_p, np.full(N_SAMPLE, -3 * math.log(high - low)))
    # U(a, b): mean (a + b) / 2, std (b - a) / sqrt(12); 5 sigma of the mean
    se = (high - low) / math.sqrt(12 * N_SAMPLE)
    assert torch.all(torch.abs(s.mean(0) - (low + high) / 2) < 5 * se)


@pytest.mark.parametrize("num_classes", [None, 3])
def test_affine_gaussian_matches_jax(num_classes):
    shape = (4,)
    jd = perturb_jax(jdist.AffineGaussian.create(shape, shape,
                                                 num_classes=num_classes), 2)
    td = _load(tdist.AffineGaussian(shape, shape, num_classes=num_classes),
               jd)
    z = _x(3, (B, 4))
    y = np.random.default_rng(4).integers(0, 3, B)
    args_j = (jnp.asarray(y),) if num_classes else ()
    args_t = (torch.from_numpy(y),) if num_classes else ()
    for temp in (None, 0.7):
        jt = jd if temp is None else jd.with_temperature(temp)
        tt = td if temp is None else td.with_temperature(temp)
        _close(tt.log_prob(_t(z), *args_t).detach(),
               jt.log_prob(jnp.asarray(z), *args_j))
    # a draw's log density is its log_prob
    zs, log_p = td.forward(2000, _gen(), *args_t[:0])
    if num_classes:
        zs, log_p = td.forward(2000, _gen(), y=torch.from_numpy(y[:1]).
                               repeat(2000))
        want = td.log_prob(zs, torch.from_numpy(y[:1]).repeat(2000))
    else:
        want = td.log_prob(zs)
    _close(log_p.detach(), want.detach(), 1e-4)


@pytest.mark.parametrize("trainable", [True, False])
def test_gaussian_mixture_matches_jax(trainable):
    jd = jdist.GaussianMixture.create(
        3, 2, loc=[[-1.0, 0.0], [1.0, 0.5], [0.0, -1.5]],
        scale=[[0.5, 0.7], [0.4, 0.4], [1.0, 0.3]], weights=[0.2, 0.3, 0.5],
        trainable=trainable)
    jd = perturb_jax(jd, 5, scale=0.1)
    td = _load(tdist.GaussianMixture(3, 2, trainable=trainable), jd)
    assert (len(list(td.parameters())) == 3) == trainable
    z = _x(6, (B, 2), 1.5)

    def jlp(params, static):
        return jnp.sum(combine(params, static).log_prob(jnp.asarray(z)))

    _close(td.log_prob(_t(z)).detach(), jd.log_prob(jnp.asarray(z)))
    if trainable:
        params, static = partition(jd)
        grads = export_state_dict(combine(jax.grad(jlp)(params, static),
                                          static))
        torch.sum(td.log_prob(_t(z))).backward()
        for name, p in td.named_parameters():
            _grad_close(p.grad.numpy(), np.asarray(grads[name]))
    # the draws' modes follow the weights, and log_p is their density
    s, log_p = td.forward(N_SAMPLE, _gen())
    _close(log_p.detach(), td.log_prob(s).detach())
    weights = torch.softmax(td.weight_scores.detach(), 1)[0]
    locs = td.loc.detach()[0]
    nearest = torch.argmin(torch.cdist(s.detach(), locs), dim=1)
    freq = torch.bincount(nearest, minlength=3) / N_SAMPLE
    assert torch.max(torch.abs(freq - weights)) < 0.08


def test_gaussian_pca_matches_jax_and_samples_its_covariance():
    jd = perturb_jax(jdist.GaussianPCA.create(jax.random.PRNGKey(7), 3,
                                              latent_dim=2, sigma=0.3), 7,
                     scale=0.1)
    td = _load(tdist.GaussianPCA(3, latent_dim=2), jd)
    z = _x(8, (B, 3), 1.5)
    _close(td.log_prob(_t(z)).detach(), jd.log_prob(jnp.asarray(z)))
    s, log_p = td.forward(N_SAMPLE, _gen())
    _close(log_p.detach(), td.log_prob(s).detach(), 1e-3)
    sig = (td.W.T @ td.W + torch.exp(2 * td.log_sigma)
           * torch.eye(3)).detach()
    cov = torch.cov((s - td.loc).detach().T)
    assert torch.max(torch.abs(cov - sig)) < 0.06 * float(sig.abs().max())


# --- targets -------------------------------------------------------------------

def test_targets_match_jax():
    z = _x(9, (B, 2), 1.5)
    z4 = _x(10, (B, 4), 1.5)
    pairs = [(tdist.CircularGaussianMixture(), jdist.CircularGaussianMixture(),
              z),
             (tdist.CircularGaussianMixture(5),
              jdist.CircularGaussianMixture(n_modes=5), z),
             (tdist.RingMixture(), jdist.RingMixture(), z),
             (tdist.RingMixture(3), jdist.RingMixture(n_rings=3), z),
             (tdist.TwoIndependent(tdist.TwoMoons(), tdist.RingMixture()),
              jdist.TwoIndependent(target1=jdist.TwoMoons(),
                                   target2=jdist.RingMixture()), z4)]
    for td, jd, x in pairs:
        _close(td.log_prob(_t(x)), jd.log_prob(jnp.asarray(x)))


def test_target_samplers_follow_their_densities():
    # the circular mixture's modes sit at radius 2, equally often
    cgm = tdist.CircularGaussianMixture(8)
    s = cgm.sample(N_SAMPLE, _gen(1))
    assert abs(float(torch.linalg.norm(s, dim=1).mean()) - 2.0) < 0.02
    angle = torch.remainder(torch.atan2(s[:, 0], s[:, 1]) + math.pi / 8,
                            2 * math.pi)
    freq = torch.bincount((angle / (2 * math.pi / 8)).long(),
                          minlength=8) / N_SAMPLE
    assert torch.max(torch.abs(freq - 1 / 8)) < 0.015
    # the ring mixture's draws sit on rings of radius 1 and 2
    ring = tdist.RingMixture(2).sample(4000, _gen(2))
    r = torch.linalg.norm(ring, dim=1)
    assert float(torch.min(torch.minimum((r - 1).abs(), (r - 2).abs()))) \
        < 0.05
    assert float(torch.mean(torch.minimum((r - 1).abs(), (r - 2).abs()))) \
        < 0.15
    # two independent halves
    ti = tdist.TwoIndependent(tdist.RingMixture(1), tdist.RingMixture(2))
    s = ti.sample(2000, _gen(3))
    assert s.shape == (2000, 4)
    assert abs(float(torch.linalg.norm(s[:, :2], dim=1).mean()) - 2.0) < 0.1


# --- priors --------------------------------------------------------------------

def _image(seed=11, shape=(12, 16)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) ** 3).astype(np.float32)


def test_priors_match_jax():
    z = _x(12, (B, 2), 1.5)
    z3 = _x(13, (4, 5, 2), 1.5)  # coordinates on the last axis
    pairs = [(tdist.Sinusoidal(), jdist.Sinusoidal()),
             (tdist.Sinusoidal(0.2, 2.0), jdist.Sinusoidal(scale=0.2,
                                                           period=2.0)),
             (tdist.Sinusoidal_gap(), jdist.Sinusoidal_gap()),
             (tdist.Sinusoidal_split(), jdist.Sinusoidal_split()),
             (tdist.Smiley(), jdist.Smiley()),
             (tdist.Smiley(0.3), jdist.Smiley(scale=0.3))]
    for td, jd in pairs:
        for x in (z, z3):
            _rel_close(td.log_prob(_t(x)), jd.log_prob(jnp.asarray(x)))
    img = _image()
    jp = jdist.ImagePrior.create(img, x_range=(-2.0, 3.0), y_range=(-3, 1))
    tp = tdist.ImagePrior(img, x_range=(-2.0, 3.0), y_range=(-3, 1),
                          device="cpu")
    zi = np.concatenate([_x(14, (B, 2), 2.0), [[-2.0, -3.0], [3.0, 1.0],
                                               [9.0, -9.0]]]).astype(
        np.float32)
    _close(tp.log_prob(_t(zi)), jp.log_prob(jnp.asarray(zi)))


def test_image_prior_samples_follow_the_image():
    """Each pixel's share of the draws is its share of the image's
    intensity (correlation over the pixels), all draws lie in the range,
    and the loop stopped at exactly the count asked for."""
    img = _image()
    tp = tdist.ImagePrior(img, device="cpu")
    s = tp.sample(N_SAMPLE, _gen(4))
    assert s.shape == (N_SAMPLE, 2)
    assert torch.all(s >= -3) and torch.all(s <= 3)
    u = (s + 3) / 6
    rows, cols = tp.image.shape
    cell = ((u[:, 0] * (rows - 1)).long() * cols
            + (u[:, 1] * (cols - 1)).long())
    freq = torch.bincount(cell, minlength=rows * cols).double()
    want = tp.image.reshape(-1).double()
    # the last row and column of cells get no draws of their own (the
    # lookup truncates), as in the JAX package: compare the others
    inner = torch.zeros(rows, cols, dtype=torch.bool)
    inner[:-1, :-1] = True
    inner = inner.reshape(-1)
    r = np.corrcoef(freq[inner].numpy(), want[inner].numpy())[0, 1]
    assert r > 0.95


def test_smiley_samples_where_jax_raises():
    """The JAX package's ``Smiley.sample`` reads proposal attributes the
    prior lacks; the port samples by rejection on the targets' proposal.
    Its draws carry far more log-density than uniform proposals do."""
    with pytest.raises(AttributeError):
        jdist.Smiley().sample(jax.random.PRNGKey(0), 10)
    sm = tdist.Smiley()
    s = sm.sample(4000, _gen(5))
    u = torch.rand((4000, 2), generator=_gen(6)) * 6 - 3
    assert float(sm.log_prob(s).mean()) > float(sm.log_prob(u).mean()) + 5
    assert float(sm.log_prob(s).max()) <= 0.0


# --- flows ---------------------------------------------------------------------

@pytest.mark.parametrize("use_lu", [True, False])
def test_invertible_affine_matches_jax(use_lu):
    jl = perturb_jax(jflows.InvertibleAffine.create(
        jax.random.PRNGKey(15), 4, use_lu=use_lu), 15, scale=0.1)
    tl = _load(tflows.InvertibleAffine(4, use_lu=use_lu), jl)
    z = _x(16, (B, 4))
    for method in ("forward", "inverse"):
        yj, ldj = getattr(jl, method)(jnp.asarray(z))
        yt, ldt = getattr(tl, method)(_t(z))
        _close(yt.detach(), yj)
        _close(ldt.detach(), ldj)
    back, ld = tl.inverse(*tl.forward(_t(z))[:1])
    _close(back.detach(), z, 1e-4)


def test_realnvp_stack_with_batch_norm_and_invertible_affine_matches_jax():
    """A RealNVP-shaped stack (masked affine couplings on MLPs) with an
    ``InvertibleAffine`` and a ``BatchNorm`` after each; BatchNorm has only
    the forward direction, so the stack runs ``forward_and_log_det``
    (latent to data) and samples on fixed base draws."""
    keys = jax.random.split(jax.random.PRNGKey(17), 12)
    jflows_, tflows_ = [], []
    for i in range(3):
        b = np.array([1.0, 0.0]) if i % 2 == 0 else np.array([0.0, 1.0])
        js = JMLP.create(keys[4 * i], [2, 16, 2])
        jt = JMLP.create(keys[4 * i + 1], [2, 16, 2])
        jflows_ += [jflows.MaskedAffineFlow.create(jnp.asarray(b), t=jt,
                                                   s=js),
                    jflows.InvertibleAffine.create(keys[4 * i + 2], 2),
                    jflows.BatchNorm()]
        tflows_ += [tflows.MaskedAffineFlow(torch.from_numpy(b).float(),
                                            t=MLP([2, 16, 2]),
                                            s=MLP([2, 16, 2])),
                    tflows.InvertibleAffine(2), tflows.BatchNorm()]
    jm = perturb_jax(JNormalizingFlow.create(jdist.DiagGaussian.create(2),
                                             jflows_), 18, scale=0.1)
    tm = _load(nt.NormalizingFlow(tdist.DiagGaussian(2), tflows_), jm)
    z = _x(19, (B, 2))
    w = _x(20, (B, 2))  # a weighted sum: a batch norm's plain sum is 0

    def jfwd(params, static):
        x, ld = combine(params, static).forward_and_log_det(jnp.asarray(z))
        return jnp.sum(x * w) + jnp.sum(ld), (x, ld)

    params, static = partition(jm)
    (_, (xj, ldj)), grads = jax.value_and_grad(jfwd, has_aux=True)(params,
                                                                   static)
    xt, ldt = tm.forward_and_log_det(_t(z))
    ((xt * _t(w)).sum() + ldt.sum()).backward()
    _close(xt.detach(), xj)
    _close(ldt.detach(), ldj)
    want = export_state_dict(combine(grads, static))
    for name, p in tm.named_parameters():
        if p.grad is not None:
            _grad_close(p.grad.numpy(), np.asarray(want[name]))
    with pytest.raises(NotImplementedError):
        tm.log_prob(_t(z))


# --- utils ---------------------------------------------------------------------

def test_utils_match_jax():
    x = _x(20, (2, 3))
    _close(tutils.tile(_t(x), 3), jutils.tile(jnp.asarray(x), 3))
    for n in (4, 5):
        _close(tutils.create_mid_split_binary_mask(n),
               jutils.create_mid_split_binary_mask(n))
        mask = tutils.create_random_binary_mask(n, _gen(n))
        assert float(mask.sum()) == math.ceil(n / 2)
        assert set(mask.tolist()) <= {0.0, 1.0}
    _close(tutils.ClampExp(0.7)(_t(x)),
           jutils.ClampExp(lam=0.7)(jnp.asarray(x)))
    _close(tutils.ConstScaleLayer(2.5)(_t(x)),
           jutils.ConstScaleLayer(scale=2.5)(jnp.asarray(x)))
    img = np.random.default_rng(21).uniform(0.1, 0.9, (2, 3, 4, 4)) \
        .astype(np.float32)
    _close(tutils.Logit(0.05)(_t(img)), jutils.Logit(0.05)(jnp.asarray(img)))
    assert tutils.LogitPreprocessing is tutils.Logit
    assert tutils.bitsPerDim is tutils.bits_per_dim
    assert tutils.bitsPerDimDataset is tutils.bits_per_dim_dataset
    assert tutils.Jitter is not None and tutils.Scale is not None
    act = tutils.ActNorm((3,))
    assert torch.equal(act(_t(x)), _t(x))  # zero-init per-channel affine
    for name in ("ClampExp", "ConstScaleLayer", "Jitter", "Logit",
                 "LogitPreprocessing", "Scale", "ActNorm", "bitsPerDim",
                 "bitsPerDimDataset", "tile", "create_mid_split_binary_mask",
                 "create_random_binary_mask"):
        assert hasattr(jutils, name) and hasattr(tutils, name), name


def test_package_re_exports():
    from nf_tpu_torch import nets, ops

    for name in ("normalize_u", "normalize_v", "projmax", "vector_norm",
                 "asym_squash", "clamp_exp"):
        assert name in nets.__all__ and callable(getattr(nets, name))
    assert ops.searchsorted is not None
    assert (ops.DEFAULT_MIN_BIN_WIDTH, ops.DEFAULT_MIN_BIN_HEIGHT,
            ops.DEFAULT_MIN_DERIVATIVE) == (1e-3, 1e-3, 1e-3)
    for name in ("Coupling", "zero_log_det_like_z", "BatchNorm",
                 "InvertibleAffine"):
        assert name in tflows.__all__
    assert torch.equal(tflows.zero_log_det_like_z(torch.ones(5, 2)),
                       torch.zeros(5))


# --- the change-of-base example ------------------------------------------------

def test_change_base_distribution_model_matches_jax():
    """``examples/change_base_distribution.py``'s model at small width: a
    trainable two-mode ``GaussianMixture`` base, K 4 ``AffineCouplingBlock``s
    over MLPs [1, 16, 16, 2] and swap ``Permute``s; log_prob and the
    forward-KLD gradients on TwoMoons draws."""
    K = 4
    keys = jax.random.split(jax.random.PRNGKey(22), 2 * K)
    jfl, tfl = [], []
    for i in range(K):
        jfl += [jflows.AffineCouplingBlock.create(JMLP.create(
                    keys[i], [1, 16, 16, 2], init_zeros=True)),
                jflows.Permute.create(keys[K + i], 2, mode="swap")]
        tfl += [tflows.AffineCouplingBlock(MLP([1, 16, 16, 2],
                                               init_zeros=True)),
                tflows.Permute(2, mode="swap")]
    jq = jdist.GaussianMixture.create(2, 2, loc=[[-1.0, 0.0], [1.0, 0.0]])
    jm = perturb_jax(JNormalizingFlow.create(jq, jfl, p=jdist.TwoMoons()),
                     23, scale=0.1)
    tm = _load(nt.NormalizingFlow(tdist.GaussianMixture(2, 2), tfl,
                                  p=tdist.TwoMoons()), jm)
    x = tdist.TwoMoons().sample(512, _gen(7)).numpy()

    def jloss(params, static):
        return combine(params, static).forward_kld(jnp.asarray(x))

    params, static = partition(jm)
    loss_j, grads = jax.value_and_grad(jloss)(params, static)
    _close(tm.log_prob(_t(x)).detach(), jm.log_prob(jnp.asarray(x)))
    loss_t = tm.forward_kld(_t(x))
    loss_t.backward()
    _close(loss_t.detach(), loss_j)
    want = export_state_dict(combine(grads, static))
    for name, p in tm.named_parameters():
        _grad_close(p.grad.numpy(), np.asarray(want[name]))


# --- dtype= on the builders ------------------------------------------------------

def _cast_like(j32, j16):
    """``j16``'s structure with ``j32``'s values cast to its dtypes."""
    return jax.tree_util.tree_map(
        lambda a, b: a.astype(b.dtype) if hasattr(b, "dtype") else b,
        j32, j16)


def test_build_realnvp_dtype_matches_jax_bf16():
    kw = dict(dim=2, K=4, hidden=[16, 16])
    j32 = perturb_jax(jmodels.build_realnvp(jax.random.PRNGKey(24), **kw),
                      24, scale=0.1)
    j16 = _cast_like(j32, jmodels.build_realnvp(jax.random.PRNGKey(24),
                                                dtype=jnp.bfloat16, **kw))
    sd = {k: np.asarray(v) for k, v in export_state_dict(j32).items()}
    t16 = nt.load_reference_state_dict(
        nt.build_realnvp(device="cpu", dtype=torch.bfloat16, **kw), sd)
    assert all(p.dtype == torch.bfloat16 for p in t16.parameters())
    x = _x(25, (B, 2), 1.5)
    want = np.asarray(j16.log_prob(jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    got = t16.log_prob(_t(x).to(torch.bfloat16)).detach().float().numpy()
    np.testing.assert_allclose(got, want, atol=MP_TOL, rtol=MP_TOL)
    z, log_q = t16.sample(256, _gen(8))
    assert z.dtype == torch.bfloat16 and torch.isfinite(log_q.float()).all()


@pytest.mark.parametrize("builder", ["image_nsf", "glow"])
def test_image_builders_dtype(builder):
    """``dtype`` makes every layer's tensor bfloat16 and leaves the bases
    float32, as the JAX builders do. The JAX package cannot build its
    bfloat16 image models on the CPU (its QR and LU have no bfloat16
    kernel there: NotImplementedError), so the port's bfloat16
    ``log_prob`` is held against JAX's float32 model on the same weights,
    at the mixed-precision bar: the image NSF's log-density, Glow's per
    dimension. Glow computes in bfloat16 throughout (couplings, 1x1
    convolutions and ActNorms over 192 dimensions), and its total
    log-density carries that rounding summed over them, which a float32
    reference cannot hold to 0.05."""
    kw = dict(input_shape=(3, 8, 8), L=2, K=2, hidden_channels=8)
    name = "build_image_nsf" if builder == "image_nsf" \
        else "build_glow_multiscale"
    if builder == "glow":
        kw["class_cond"] = False
    with pytest.raises(NotImplementedError):
        getattr(jmodels, name)(jax.random.PRNGKey(26), dtype=jnp.bfloat16,
                               **kw)
    j32 = perturb_jax(getattr(jmodels, name)(jax.random.PRNGKey(26), **kw),
                      26, scale=0.02)
    t16 = getattr(nt, name)(device="cpu", dtype=torch.bfloat16, **kw)
    for key, v in t16.state_dict().items():
        if v.is_floating_point():
            want = torch.float32 if key.startswith("q0.") else torch.bfloat16
            assert v.dtype == want, key
    sd = {k: np.asarray(v) for k, v in export_state_dict(j32).items()}
    for k in [k for k in sd if k.endswith("data_dep_init_done")]:
        sd[k] = np.asarray(0.0, np.float32)
    t16 = nt.load_reference_state_dict(t16, sd)
    x = np.random.default_rng(27).uniform(0.05, 0.95, (4, 3, 8, 8)) \
        .astype(np.float32)
    per = 1 if builder == "image_nsf" else x[0].size
    want = np.asarray(j32.log_prob(jnp.asarray(x))) / per
    got = t16.log_prob(_t(x).to(torch.bfloat16)).detach().float().numpy() \
        / per
    np.testing.assert_allclose(got, want, atol=MP_TOL, rtol=MP_TOL)
