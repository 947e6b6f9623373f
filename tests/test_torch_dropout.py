"""Dropout in the port's conditioners against the JAX package, on the CPU,
on JAX's own masks.

The JAX package drops activations only when it is given a key:
``where(bernoulli(fold_in(key, i), keep, shape), x / keep, 0)`` per block
i (the MLP's one slot takes the key itself). The port draws its masks
through one helper, ``nf_tpu_torch.nets._dropout.draw_mask``; here it is
replaced by :class:`MaskFeed`, which hands out JAX's masks in the order the
port draws and counts the draws, so both frameworks drop the same
activations. Weights cross with ``export_state_dict`` after numpy noise.
Sizes are small (batch 64, hidden 16, 2 blocks), p = 0.3. Tolerance 1e-4
abs on values; gradients 1e-4 after dividing by max(max |gradient|, 1);
the bfloat16 trunk at the mixed-precision bar 0.05.

Covered: ``ResidualNet`` batch-major and transposed (with a context gate),
``ConvResidualNet``, MADE with residual and feed-forward blocks,
``MLP(dropout=)``, ``MixedPrecision``; the fused coupling (the JAX side's
Pallas head in interpret mode) under dropout, values and gradients; the
autoregressive inverse's one draw across its D passes; the sticking-the-
landing and DReG re-passes on the sampling pass's masks; and
``generator=None`` bitwise equal to p = 0.
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
from nf_tpu.distributions.base import DiagGaussian as JDiagGaussian
from nf_tpu.distributions.prior import TwoModes as JTwoModes
from nf_tpu.nets.made import MADE as JMADE
from nf_tpu.nets.mlp import MLP as JMLP
from nf_tpu.nets.precision import MixedPrecision as JMixedPrecision
from nf_tpu.nets.resnet import ConvResidualNet as JConvResidualNet
from nf_tpu.nets.resnet import ResidualNet as JResidualNet
from nf_tpu.ops import spline_head_fused as jshf
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.compat import _head_to_bin_major
from nf_tpu_torch.flows.neural_spline import coupling as tcoupling
from nf_tpu_torch.nets import (
    MADE,
    MLP,
    ConvResidualNet,
    MixedPrecision,
    ResidualNet,
)
from nf_tpu_torch.nets import _dropout
from test_torch_autoregressive import perturb_jax
from test_torch_conditional import jax_fixed, torch_fixed

TOL = 1e-4
BF16_TOL = 0.05
P = 0.3
KEEP = 1.0 - P
B, F, H, CTX = 64, 3, 16, 2


class MaskFeed:
    """Stands in for ``_dropout.draw_mask``: returns ``masks`` (numpy
    booleans) in order, checking each shape and ``keep``."""

    def __init__(self, masks):
        self.masks = [np.asarray(m) for m in masks]
        self.drawn = 0

    def __call__(self, generator, keep, shape, device):
        assert keep == pytest.approx(KEEP)
        mask = self.masks[self.drawn]
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        self.drawn += 1
        return torch.from_numpy(mask.copy()).to(device)


def feed(monkeypatch, masks):
    f = MaskFeed(masks)
    monkeypatch.setattr(_dropout, "draw_mask", f)
    return f


def jmask(key, i, shape):
    """JAX's mask of block ``i`` (``fold_in(key, i)``), or with ``i``
    None the key's own (the MLP's slot)."""
    k = key if i is None else jax.random.fold_in(key, i)
    return np.asarray(jax.random.bernoulli(k, KEEP, shape))


def _gen():
    return torch.Generator().manual_seed(0)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0)


def _grad_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _load(tmodule, jmodule):
    sd = {k: np.asarray(v) for k, v in export_state_dict(jmodule).items()}
    return nt.load_reference_state_dict(tmodule, sd)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _resnet_pair(seed, bin_major=False):
    head = (F, 4) if bin_major else None
    jnet = perturb_jax(JResidualNet.create(
        jax.random.PRNGKey(seed), F, 4 * F, H, context_features=CTX,
        dropout_probability=P, bin_major_head=head), seed)
    tnet = ResidualNet(F, 4 * F, H, context_features=CTX,
                       dropout_probability=P, bin_major_head=head)
    return jnet, _load(tnet, jnet)


@pytest.mark.parametrize("layout", ["batch_major", "transposed"])
def test_residual_net_dropout_matches_jax(monkeypatch, layout):
    jnet, tnet = _resnet_pair(1, bin_major=layout == "transposed")
    x, c = _x(2, (B, F)), _x(3, (B, CTX))
    key = jax.random.PRNGKey(4)
    shape = (B, H) if layout == "batch_major" else (H, B)
    f = feed(monkeypatch, [jmask(key, i, shape) for i in range(2)])
    if layout == "batch_major":
        want = jnet(jnp.asarray(x), jnp.asarray(c), key=key)
        got = tnet(_t(x), _t(c), generator=_gen())
    else:
        want = jnet.features_transposed(jnp.asarray(x), jnp.asarray(c),
                                        key=key)
        got = tnet.features_transposed(_t(x), _t(c), generator=_gen())
    assert f.drawn == 2
    _close(got.detach(), want)
    # the masks moved the output: dropout acted
    assert float(np.max(np.abs(np.asarray(want) - np.asarray(
        jnet(jnp.asarray(x), jnp.asarray(c)) if layout == "batch_major"
        else jnet.features_transposed(jnp.asarray(x), jnp.asarray(c)))))) \
        > 1e-3


def test_conv_residual_net_dropout_matches_jax(monkeypatch):
    jnet = perturb_jax(JConvResidualNet.create(
        jax.random.PRNGKey(5), 2, 4, 8, dropout_probability=P), 5)
    tnet = _load(ConvResidualNet(2, 4, 8, dropout_probability=P), jnet)
    x = _x(6, (4, 2, 6, 6))
    key = jax.random.PRNGKey(7)
    f = feed(monkeypatch, [jmask(key, i, (4, 8, 6, 6)) for i in range(2)])
    want = jnet(jnp.asarray(x), key=key)
    got = tnet(_t(x), generator=_gen())
    assert f.drawn == 2
    _close(got.detach(), want)


@pytest.mark.parametrize("residual", [True, False])
def test_made_dropout_matches_jax(monkeypatch, residual):
    kw = dict(features=F, hidden_features=H, num_blocks=2,
              output_multiplier=3, use_residual_blocks=residual,
              dropout_probability=P)
    jmade = perturb_jax(JMADE.create(jax.random.PRNGKey(8), **kw), 8)
    tmade = _load(MADE(**kw), jmade)
    x = _x(9, (B, F))
    key = jax.random.PRNGKey(10)
    f = feed(monkeypatch, [jmask(key, i, (B, H)) for i in range(2)])
    want = jmade(jnp.asarray(x), key=key)
    got = tmade(_t(x), generator=_gen())
    assert f.drawn == 2
    _close(got.detach(), want)


def test_mlp_dropout_matches_jax(monkeypatch):
    jmlp = perturb_jax(JMLP.create(jax.random.PRNGKey(11), [F, H, H, 2],
                                   leaky=0.1, dropout=P), 11)
    tmlp = _load(MLP([F, H, H, 2], leaky=0.1, dropout=P), jmlp)
    x = _x(12, (B, F))
    key = jax.random.PRNGKey(13)
    f = feed(monkeypatch, [jmask(key, None, (B, H))])
    want = jmlp(jnp.asarray(x), key=key)
    got = tmlp(_t(x), generator=_gen())
    assert f.drawn == 1
    _close(got.detach(), want)
    # without a key neither drops; the slot keeps the reference's index
    _close(tmlp(_t(x)).detach(), jmlp(jnp.asarray(x)))
    assert "net.5.weight" in tmlp.state_dict()


def test_mixed_precision_trunk_drops_the_float32_masks(monkeypatch):
    """JAX draws a bf16 trunk's masks from float32 uniforms (``keep`` is
    a Python float), so they are the float32 net's; the port's helper
    draws float32 uniforms whatever the trunk's dtype."""
    jnet, tnet = _resnet_pair(14)
    x, c = _x(15, (B, F)), _x(16, (B, CTX))
    key = jax.random.PRNGKey(17)
    masks = [jmask(key, i, (B, H)) for i in range(2)]
    f = feed(monkeypatch, masks)
    want = JMixedPrecision(net=jnet)(jnp.asarray(x), jnp.asarray(c), key=key)
    got = MixedPrecision(tnet)(_t(x), _t(c), generator=_gen())
    assert f.drawn == 2 and got.dtype == torch.float32
    _close(got.detach(), want, BF16_TOL)
    # the port's own draws: the same masks for the bf16 and f32 nets
    monkeypatch.undo()
    drawn = []
    real = _dropout.draw_mask

    def record(*args):
        mask = real(*args)
        drawn.append(mask)
        return mask

    monkeypatch.setattr(_dropout, "draw_mask", record)
    MixedPrecision(tnet)(_t(x), _t(c), generator=_gen())
    tnet(_t(x), _t(c), generator=_gen())
    assert len(drawn) == 4
    assert all(torch.equal(drawn[i], drawn[i + 2]) for i in range(2))


def test_generator_none_is_bitwise_p0(monkeypatch):
    """Without a generator every net is bitwise its p = 0 twin and draws
    nothing; with p = 0 a generator draws nothing either."""
    f = feed(monkeypatch, [])
    x, c = _t(_x(18, (B, F))), _t(_x(19, (B, CTX)))
    img = _t(_x(20, (4, 2, 6, 6)))
    for make, args in (
            (lambda p: ResidualNet(F, 8, H, context_features=CTX,
                                   dropout_probability=p), (x, c)),
            (lambda p: ConvResidualNet(2, 4, 8, dropout_probability=p),
             (img,)),
            (lambda p: MADE(F, H, output_multiplier=2,
                            dropout_probability=p), (x,)),
            (lambda p: MADE(F, H, output_multiplier=2,
                            use_residual_blocks=False,
                            dropout_probability=p), (x,)),
            (lambda p: MLP([F, H, 2], dropout=p), (x,))):
        torch.manual_seed(0)
        dropped = make(P)
        torch.manual_seed(0)
        plain = make(0.0)
        plain.load_state_dict(dropped.state_dict())
        assert torch.equal(dropped(*args), plain(*args))
        assert torch.equal(plain(*args, generator=_gen()), plain(*args))
    tnet = ResidualNet(F, 8, H, dropout_probability=P)
    assert torch.equal(tnet.features_transposed(x),
                       tnet.features_transposed(x, generator=None))
    assert f.drawn == 0


def _coupled_pair(seed, mixed=False):
    """A JAX CoupledRationalQuadraticSpline (dim 2, hidden 16, 4 bins,
    dropout P) perturbed, and the port's layer on its weights."""
    kw = dict(num_input_channels=2, num_blocks=2, num_hidden_channels=H,
              num_bins=4, tail_bound=3.0, dropout_probability=P)
    jl = perturb_jax(jflows.CoupledRationalQuadraticSpline.create(
        jax.random.PRNGKey(seed), **kw), seed)
    tl = _load(tflows.CoupledRationalQuadraticSpline(**kw), jl)
    return jl, tl


def _port_grads(tl, jgrads):
    """{reference name: (port gradient, JAX gradient in the port's row
    order)} for the layer's parameters."""
    want = {k: np.asarray(v) for k, v in export_state_dict(jgrads).items()}
    heads = {f"{n}.final_layer.": m.bin_major_head
             for n, m in tl.named_modules()
             if isinstance(m, ResidualNet) and m.bin_major_head is not None}
    out = {}
    for name, p in tl.named_parameters():
        w = want[name]
        head = heads.get(name[:name.rfind(".") + 1])
        if head is not None:
            w = _head_to_bin_major(w, head)
        out[name] = (p.grad.numpy(), w)
    return out


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_fused_coupling_under_dropout_matches_jax(monkeypatch, direction):
    """Kernel B's feed with a dropped-out trunk: the port's coupling takes
    the fused feed (its gate forced, so on the CPU kernel B's plain
    version runs behind ``features_transposed``), the JAX side its Pallas
    head in interpret mode; the masks are drawn in the transposed (H, B)
    shape on both sides. Values and every parameter's gradient."""
    jl, tl = _coupled_pair(21)
    x = _x(22, (B, 2)) * 1.5
    key = jax.random.PRNGKey(23)
    f = feed(monkeypatch, [jmask(key, i, (H, B)) for i in range(2)])
    monkeypatch.setattr(tcoupling, "fused_head_wanted", lambda d, n: True)

    def jloss(params, static):
        y, ld = getattr(combine(params, static), direction)(
            jnp.asarray(x), key=key)
        return jnp.sum(y) + jnp.sum(ld), (y, ld)

    jshf.set_fused_head_mode("on")
    try:
        params, static = partition(jl)
        (_, (yj, ldj)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            params, static)
    finally:
        jshf.set_fused_head_mode("auto")
    yt, ldt = getattr(tl, direction)(_t(x), generator=_gen())
    (yt.sum() + ldt.sum()).backward()
    assert f.drawn == 2
    _close(yt.detach(), yj)
    _close(ldt.detach(), ldj)
    for name, (got, want) in _port_grads(tl, combine(jgrads, static)) \
            .items():
        _grad_close(got, want)


def _made_layer_pair(seed, cls="spline"):
    if cls == "spline":
        kw = dict(features=F, hidden_features=H, num_bins=4, tails="linear",
                  tail_bound=3.0, dropout_probability=P)
        jl = perturb_jax(
            jflows.MaskedPiecewiseRationalQuadraticAutoregressive.create(
                jax.random.PRNGKey(seed), **kw), seed)
        tl = tflows.MaskedPiecewiseRationalQuadraticAutoregressive(**kw)
    else:
        kw = dict(features=F, hidden_features=H, dropout_probability=P)
        jl = perturb_jax(jflows.MaskedAffineAutoregressive.create(
            jax.random.PRNGKey(seed), **kw), seed, scale=0.05)
        tl = tflows.MaskedAffineAutoregressive(**kw)
    return jl, _load(tl, jl)


@pytest.mark.parametrize("cls", ["spline", "affine"])
def test_autoregressive_inverse_reuses_one_draw(monkeypatch, cls):
    """JAX's D-pass inverse hands the flow's one key to every pass; the
    port draws each block's mask once (2 draws for 3 passes) and matches
    JAX on those masks. Under one draw the inverse inverts the forward."""
    jl, tl = _made_layer_pair(24, cls)
    y = _x(25, (B, F))
    key = jax.random.PRNGKey(26)
    masks = [jmask(key, i, (B, H)) for i in range(2)]
    f = feed(monkeypatch, masks)
    xj, ldj = jl.inverse(jnp.asarray(y), key=key)
    xt, ldt = tl.inverse(_t(y), generator=_gen())
    assert f.drawn == 2
    _close(xt.detach(), xj)
    _close(ldt.detach(), ldj)
    # JAX's forward on the same key undoes its inverse; so does the
    # port's under one draw (shared_masks across the two calls)
    yj, _ = jl.forward(xj, key=key)
    _close(yj, y, 1e-3)
    f = feed(monkeypatch, masks)
    with _dropout.shared_masks():
        x_, ld_inv = tl.inverse(_t(y), generator=_gen())
        y_, ld_fwd = tl.forward(x_, generator=_gen())
    assert f.drawn == 2
    _close(y_.detach(), y, 1e-3)
    _close((ld_inv + ld_fwd).detach(), np.zeros(B), 1e-3)


def test_autoregressive_wrapper_passes_the_generator_on(monkeypatch):
    """The port's AR wrapper hands the generator to its MADE-spline layer
    (the JAX package's wrapper drops its key); on the same masks it is
    that layer, both directions."""
    layer = tflows.AutoregressiveRationalQuadraticSpline(
        F, 2, H, num_bins=4, dropout_probability=P, init_identity=False)
    y = _t(_x(27, (B, F)))
    key = jax.random.PRNGKey(28)
    masks = [jmask(key, i, (B, H)) for i in range(2)]
    for wrapped, bare in (("forward", "inverse"), ("inverse", "forward")):
        feed(monkeypatch, masks)
        got = getattr(layer, wrapped)(y, generator=_gen())
        f = feed(monkeypatch, masks)
        want = getattr(layer.mprqat, bare)(y, generator=_gen())
        assert f.drawn == 2
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1].reshape(-1))
        f = feed(monkeypatch, [])
        assert not torch.equal(getattr(layer, wrapped)(y)[0], got[0])


def _stl_pair(seed):
    """A JAX NormalizingFlow of a dropped-out coupling and a dropped-out
    MADE-spline layer (dim 2) on a DiagGaussian, perturbed, and the port's
    model on its weights."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    coupled = dict(num_input_channels=2, num_blocks=2,
                   num_hidden_channels=H, num_bins=4, tail_bound=3.0,
                   dropout_probability=P)
    made = dict(features=2, hidden_features=H, num_bins=4, tails="linear",
                tail_bound=3.0, dropout_probability=P)
    jm = perturb_jax(JNormalizingFlow.create(
        JDiagGaussian.create(2),
        [jflows.CoupledRationalQuadraticSpline.create(k1, **coupled),
         jflows.MaskedPiecewiseRationalQuadraticAutoregressive.create(
             k2, **made)]), seed)
    tm = nt.NormalizingFlow(
        tdist.DiagGaussian(2),
        [tflows.CoupledRationalQuadraticSpline(**coupled),
         tflows.MaskedPiecewiseRationalQuadraticAutoregressive(**made)])
    return jm, _load(tm, jm)


@pytest.mark.parametrize("estimator", ["stl", "dreg"])
def test_stl_and_dreg_repass_reuse_the_sampling_masks(monkeypatch,
                                                      estimator):
    """``reverse_kld(score_fn=False)`` and ``reverse_alpha_div(dreg=True)``
    re-run log q through the inverse chain; JAX feeds that re-pass the
    per-flow keys of the sampling pass (``nf_tpu/core.py:139,163``), so it
    drops the same activations. The port draws 4 masks (2 blocks per
    flow) in the sampling pass and none in the re-pass, and its loss and
    gradients match JAX's on JAX's masks and the same base draws."""
    jm, tm = _stl_pair(29)
    n = 128
    eps = np.random.default_rng(30).standard_normal((n, 2)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(31)
    keys = jax.random.split(key, 3)
    masks = [jmask(keys[1 + flow], i, (n, H)) for flow in range(2)
             for i in range(2)]
    jfix = jax_fixed(jm, eps, JTwoModes())
    tfix = torch_fixed(tm, eps, tdist.TwoModes())

    def jloss(params, static):
        m = combine(params, static)
        if estimator == "stl":
            return m.reverse_kld(key, n, score_fn=False)
        return m.reverse_alpha_div(key, n, alpha=0.5, dreg=True)

    params, static = partition(jfix)
    loss_j, jgrads = jax.value_and_grad(jloss)(params, static)
    f = feed(monkeypatch, masks)
    loss_t = (tfix.reverse_kld(n, score_fn=False, generator=_gen())
              if estimator == "stl" else
              tfix.reverse_alpha_div(n, alpha=0.5, dreg=True,
                                     generator=_gen()))
    loss_t.backward()
    assert f.drawn == 4
    _close(loss_t.detach(), loss_j)
    want = {k: np.asarray(v) for k, v in
            export_state_dict(combine(jgrads, static)).items()}
    for name, p in tfix.named_parameters():
        if p.grad is not None or np.any(want[name]):
            _grad_close(p.grad.numpy(), want[name])
    # outside the losses each call draws afresh (8 draws); replayed on the
    # sampling pass's masks (the inverse chain takes the MADE's first),
    # log_prob(sample) is log_q
    f = feed(monkeypatch, masks + masks[2:] + masks[:2])
    with torch.no_grad():
        z, log_q = tfix.sample(n, generator=_gen())
        log_p = tfix.log_prob(z, generator=_gen())
    assert f.drawn == 8
    _close(log_p, log_q, 1e-3)
