"""Batch norm in the port's conditioners and the ``BatchNorm`` flow against
the JAX package, on the CPU.

``use_batch_norm=True`` normalises with the batch's own statistics and a
learned affine (``nf_tpu/nets/resnet.py:26-57``, eps 1e-3, no running
statistics). The JAX exporter raises on such nets
(``nf_tpu/compat_export.py:114-115,147-148``), so :func:`bn_state_dict`
writes the reference-named dict itself: the net exported without its
norms, plus ``blocks.i.batch_norm_layers.j.weight`` / ``.bias`` (JAX's
``gamma`` / ``beta``). The JAX modules are perturbed with numpy noise
(N(0, 0.2²)), the norms' affine included. Sizes are small (batch 64,
hidden 16, 2 blocks). Tolerance 1e-4 abs on values; gradients 1e-4 after
dividing by max(max |gradient|, 1).

Covered: ``ResidualNet`` batch-major and transposed (``_bn_t``), with a
context gate and with dropout; ``ConvResidualNet``; a
``PiecewiseRationalQuadraticCoupling`` over a batch-norm trunk through
kernel B's fused feed (the JAX side's Pallas head in interpret mode) and
the unfused one, values and gradients; the bridge's handling of a
reference ``nn.BatchNorm1d``'s running statistics; the ``BatchNorm`` flow;
and ``use_batch_norm`` accepted and ignored by the MADE flows, as in the
JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.flows as jflows
import nf_tpu_torch as nt
from nf_tpu.compat_export import export_state_dict
from nf_tpu.nets.resnet import ConvResidualNet as JConvResidualNet
from nf_tpu.nets.resnet import ResidualNet as JResidualNet
from nf_tpu.ops import spline_head_fused as jshf
from nf_tpu.utils.masks import create_alternating_binary_mask
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.compat import _head_to_bin_major
from nf_tpu_torch.flows.neural_spline import coupling as tcoupling
from nf_tpu_torch.nets import ConvResidualNet, ResidualNet
from test_torch_autoregressive import perturb_jax
from test_torch_dropout import P, feed, jmask

TOL = 1e-4
B, F, H, CTX = 64, 3, 16, 2


def bn_state_dict(jnet, prefix=""):
    """The reference-named state dict of a JAX batch-norm ``ResidualNet``
    or ``ConvResidualNet`` (``prefix`` before every name)."""
    bare = jnet.replace(blocks=tuple(b.replace(batch_norms=None)
                                     for b in jnet.blocks))
    sd = {prefix + k: np.asarray(v)
          for k, v in export_state_dict(bare).items()}
    for i, block in enumerate(jnet.blocks):
        for j, bn in enumerate(block.batch_norms):
            p = f"{prefix}blocks.{i}.batch_norm_layers.{j}."
            sd[p + "weight"] = np.asarray(bn.gamma)
            sd[p + "bias"] = np.asarray(bn.beta)
    return sd


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0)


def _grad_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_grads(tmodule, jgrads_sd):
    """Every parameter's gradient against JAX's, by reference name (bin-
    major head rows permuted to the port's order)."""
    heads = {f"{n}.final_layer." if n else "final_layer.": m.bin_major_head
             for n, m in tmodule.named_modules()
             if isinstance(m, ResidualNet) and m.bin_major_head is not None}
    checked = 0
    for name, p in tmodule.named_parameters():
        want = jgrads_sd[name]
        head = heads.get(name[:name.rfind(".") + 1])
        if head is not None:
            want = _head_to_bin_major(want, head)
        if p.grad is None:  # a layer the pass does not run (the head of
            assert not np.any(want)  # features_transposed)
            continue
        _grad_close(p.grad.numpy(), want)
        checked += 1
    assert checked >= len(list(tmodule.parameters())) - 2


def _resnet_pair(seed, bin_major, context, dropout=0.0):
    head = (F, 4) if bin_major else None
    ctx = CTX if context else None
    jnet = perturb_jax(JResidualNet.create(
        jax.random.PRNGKey(seed), F, 4 * F, H, context_features=ctx,
        use_batch_norm=True, dropout_probability=dropout,
        bin_major_head=head), seed)
    tnet = ResidualNet(F, 4 * F, H, context_features=ctx,
                       use_batch_norm=True, dropout_probability=dropout,
                       bin_major_head=head)
    return jnet, nt.load_reference_state_dict(tnet, bn_state_dict(jnet))


@pytest.mark.parametrize("context", [False, True])
@pytest.mark.parametrize("layout", ["batch_major", "transposed"])
def test_residual_net_batch_norm_matches_jax(layout, context):
    jnet, tnet = _resnet_pair(1, layout == "transposed", context)
    x = _x(2, (B, F), 1.5)
    c = _x(3, (B, CTX)) if context else None
    w = _x(4, (H, B) if layout == "transposed" else (B, 4 * F))
    jc = None if c is None else jnp.asarray(c)
    tc = None if c is None else _t(c)

    def run_j(net):
        if layout == "transposed":
            return net.features_transposed(jnp.asarray(x), jc)
        return net(jnp.asarray(x), jc)

    def jloss(params, static):
        out = run_j(combine(params, static))
        return jnp.sum(out * w), out

    params, static = partition(jnet)
    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params,
                                                                static)
    got = (tnet.features_transposed(_t(x), tc) if layout == "transposed"
           else tnet(_t(x), tc))
    torch.sum(got * _t(w)).backward()
    _close(got.detach(), want)
    _check_grads(tnet, bn_state_dict(combine(jgrads, static)))
    # the norms act: the batch statistics change the output
    no_bn = jnet.replace(blocks=tuple(b.replace(batch_norms=None)
                                      for b in jnet.blocks))
    assert float(np.max(np.abs(np.asarray(run_j(no_bn)) - np.asarray(
        want)))) > 1e-2


def test_residual_net_batch_norm_and_dropout_match_jax(monkeypatch):
    """Both on the transposed trunk kernel B reads: the norms over the
    batch axis 1, the masks in the (H, B) shape."""
    jnet, tnet = _resnet_pair(5, True, True, dropout=P)
    x, c = _x(6, (B, F), 1.5), _x(7, (B, CTX))
    key = jax.random.PRNGKey(8)
    f = feed(monkeypatch, [jmask(key, i, (H, B)) for i in range(2)])
    want = jnet.features_transposed(jnp.asarray(x), jnp.asarray(c), key=key)
    got = tnet.features_transposed(_t(x), _t(c),
                                   generator=torch.Generator())
    assert f.drawn == 2
    _close(got.detach(), want)


def test_conv_residual_net_batch_norm_matches_jax():
    jnet = perturb_jax(JConvResidualNet.create(
        jax.random.PRNGKey(9), 2, 4, 8, context_channels=2,
        use_batch_norm=True), 9)
    tnet = nt.load_reference_state_dict(
        ConvResidualNet(2, 4, 8, context_channels=2, use_batch_norm=True),
        bn_state_dict(jnet))
    x, c = _x(10, (4, 2, 6, 6)), _x(11, (4, 2, 6, 6))
    w = _x(12, (4, 4, 6, 6))

    def jloss(params, static):
        out = combine(params, static)(jnp.asarray(x), jnp.asarray(c))
        return jnp.sum(out * w), out

    params, static = partition(jnet)
    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params,
                                                                static)
    got = tnet(_t(x), _t(c))
    torch.sum(got * _t(w)).backward()
    _close(got.detach(), want)
    _check_grads(tnet, bn_state_dict(combine(jgrads, static)))


def _coupling_pair(seed):
    """``build_nsf``'s coupling shape at small size (dim 4, hidden 16, 4
    bins, linear tails at 3) with a batch-norm ``ResidualNet`` carrying a
    bin-major head, built through ``PiecewiseRationalQuadraticCoupling``
    in both packages."""
    dim, bins = 4, 4
    mask = np.asarray(create_alternating_binary_mask(dim, even=True))
    head = (2, 3 * bins - 1)

    def jnet_fn(k, n_in, n_out):
        return JResidualNet.create(k, n_in, n_out, H, use_batch_norm=True,
                                   bin_major_head=head)

    def tnet_fn(n_in, n_out):
        return ResidualNet(n_in, n_out, H, use_batch_norm=True,
                           bin_major_head=head)

    kw = dict(num_bins=bins, tails="linear", tail_bound=3.0)
    jl = perturb_jax(jflows.PiecewiseRationalQuadraticCoupling.create(
        jax.random.PRNGKey(seed), mask, jnet_fn, **kw), seed)
    tl = tflows.PiecewiseRationalQuadraticCoupling(mask, tnet_fn, **kw)
    sd = bn_state_dict(jl.transform_net, "transform_net.")
    sd["identity_features"] = np.asarray(jl.identity_features, np.int64)
    sd["transform_features"] = np.asarray(jl.transform_features, np.int64)
    return jl, nt.load_reference_state_dict(tl, sd), dim


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("feed_kind", ["fused", "unfused"])
def test_batch_norm_coupling_matches_jax(monkeypatch, feed_kind, direction):
    """Kernel B's feed behind a batch-norm trunk: ``fused`` forces the
    port's gate (kernel B's plain version on the CPU, behind
    ``features_transposed``) and the JAX side's Pallas head in interpret
    mode; ``unfused`` is each side's default CPU path. Values and the
    gradients of every parameter, the norms' affine included."""
    jl, tl, dim = _coupling_pair(13)
    x = _x(14, (B, dim), 1.5)
    if feed_kind == "fused":
        monkeypatch.setattr(tcoupling, "fused_head_wanted",
                            lambda d, n: True)
        calls = []
        real = tl.transform_net.features_transposed
        monkeypatch.setattr(tl.transform_net, "features_transposed",
                            lambda *a, **k: calls.append(1) or real(*a, **k))

    def jloss(params, static):
        y, ld = getattr(combine(params, static), direction)(jnp.asarray(x))
        return jnp.sum(y) + jnp.sum(ld), (y, ld)

    jshf.set_fused_head_mode("on" if feed_kind == "fused" else "off")
    try:
        params, static = partition(jl)
        (_, (yj, ldj)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            params, static)
    finally:
        jshf.set_fused_head_mode("auto")
    yt, ldt = getattr(tl, direction)(_t(x))
    (yt.sum() + ldt.sum()).backward()
    if feed_kind == "fused":
        assert calls == [1]
    _close(yt.detach(), yj)
    _close(ldt.detach(), ldj)
    _check_grads(tl.transform_net, bn_state_dict(
        combine(jgrads, static).transform_net))


def test_bridge_takes_a_reference_batch_norm_with_running_stats():
    """A reference ``nn.BatchNorm1d`` carries running statistics, which
    batch-statistics normalisation never reads: the bridge takes them and
    loads the affine; a missing affine still raises."""
    jnet, _ = _resnet_pair(15, False, False)
    sd = bn_state_dict(jnet)
    for name in [k for k in sd if ".batch_norm_layers." in k
                 and k.endswith(".weight")]:
        p = name[:-len("weight")]
        sd[p + "running_mean"] = np.zeros(H, np.float32)
        sd[p + "running_var"] = np.ones(H, np.float32)
        sd[p + "num_batches_tracked"] = np.asarray(7)
    tnet = nt.load_reference_state_dict(
        ResidualNet(F, 4 * F, H, use_batch_norm=True), sd)
    assert torch.equal(tnet.blocks[1].batch_norm_layers[0].bias,
                       _t(sd["blocks.1.batch_norm_layers.0.bias"]))
    del sd["blocks.0.batch_norm_layers.1.weight"]
    with pytest.raises(KeyError, match="missing"):
        nt.load_reference_state_dict(
            ResidualNet(F, 4 * F, H, use_batch_norm=True), sd)


def test_batch_norm_flow_matches_jax():
    x = _x(16, (B, F), 2.0) + 0.5
    zj, ldj = jflows.BatchNorm().forward(jnp.asarray(x))
    zt, ldt = tflows.BatchNorm().forward(_t(x))
    _close(zt, zj)
    _close(ldt, ldj)
    assert ldt.shape == (B,)
    with pytest.raises(NotImplementedError):
        jflows.BatchNorm().inverse(jnp.asarray(x))
    with pytest.raises(NotImplementedError):
        tflows.BatchNorm().inverse(_t(x))


@pytest.mark.parametrize("cls", ["affine", "spline"])
def test_made_flows_accept_and_ignore_use_batch_norm(cls):
    """The JAX package's MADE blocks take ``use_batch_norm`` and build no
    norm (``nf_tpu/nets/made.py:116-125,151-180``); so does the port:
    the same parameters as without it, and JAX's values on JAX's
    weights."""
    if cls == "affine":
        jcls, tcls = (jflows.MaskedAffineAutoregressive,
                      tflows.MaskedAffineAutoregressive)
        kw = dict(features=F, hidden_features=H)
    else:
        jcls, tcls = (jflows.MaskedPiecewiseRationalQuadraticAutoregressive,
                      tflows.MaskedPiecewiseRationalQuadraticAutoregressive)
        kw = dict(features=F, hidden_features=H, num_bins=4,
                  tails="linear", tail_bound=3.0)
    jl = perturb_jax(jcls.create(jax.random.PRNGKey(17), use_batch_norm=True,
                                 **kw), 17, scale=0.05)
    tl = tcls(use_batch_norm=True, **kw)
    assert list(tl.state_dict()) == list(tcls(**kw).state_dict())
    sd = {k: np.asarray(v) for k, v in export_state_dict(jl).items()}
    tl = nt.load_reference_state_dict(tl, sd)
    x = _x(18, (B, F))
    for method in ("forward", "inverse"):
        yj, ldj = getattr(jl, method)(jnp.asarray(x))
        yt, ldt = getattr(tl, method)(_t(x))
        _close(yt.detach(), yj)
        _close(ldt.detach(), ldj)

