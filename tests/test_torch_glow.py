"""The port's Glow (``nf_tpu_torch.build_glow_multiscale`` and its pieces:
``ConvNet2d``, ``AffineCoupling``, ``AffineCouplingBlock``,
``CCAffineConst``, ``GlowBlock``, ``ClassCondFlow``, ``Scanned`` with
``remat``) against the JAX package, on the CPU.

A small class-conditional ``build_glow_multiscale`` (3 x 8 x 8, L 2, K 2,
hidden 8) is built in JAX, its export perturbed with numpy noise as in
``test_torch_image`` (the zero-initialised last convolutions make every
coupling the identity), ActNorms marked not yet set, and loaded into both
frameworks; inputs are pixels and labels from a numpy seed, and where the
model draws both frameworks get numpy's draws
(``test_torch_image.jax_fixed_bases`` / ``torch_fixed_bases``).
Tolerance: 1e-4 abs on outputs and pixels, 1e-4 after dividing by
``max(max |value|, 1)`` on log-densities, log-dets and gradients; bf16
against the float32 model within 0.05 abs + 0.05 relative (the JAX
package's bar). ``scan=True`` loads the same export and agrees with the
unrolled model bitwise; ``remat=True`` recomputes each block in the
backward and agrees with it to rounding (its log-dets sum per block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.models as jmodels
import nf_tpu_torch as nt
from nf_tpu.compat import import_state_dict
from nf_tpu.compat_export import export_state_dict
from nf_tpu.core import ClassCondFlow as JClassCondFlow
from nf_tpu.distributions.base import ClassCondDiagGaussian as JClassCond
from nf_tpu.flows import ActNorm as JActNorm
from nf_tpu.flows import AffineCouplingBlock as JCouplingBlock
from nf_tpu.flows import CCAffineConst as JCCAffine
from nf_tpu.flows import GlowBlock as JGlowBlock
from nf_tpu.flows import Invertible1x1Conv as JConv1x1
from nf_tpu.nets import ConvNet2d as JConvNet2d
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.nets import ConvNet2d
from test_torch_image import (
    BATCH,
    SHAPE,
    close,
    jax_fixed_bases,
    labels,
    level_eps,
    model_pair,
    perturbed,
    pixels,
    port_grads_close,
    rel_close,
    t,
    torch_fixed_bases,
)

SMALL = dict(input_shape=SHAPE, L=2, K=2, hidden_channels=8)
MIXED_TOL = 0.05


def _pair(**extra):
    return model_pair(jmodels.build_glow_multiscale,
                      nt.build_glow_multiscale, dict(SMALL, **extra))


def _loaded(jmod, tmod, seed):
    sd = perturbed(export_state_dict(jmod), seed)
    return import_state_dict(jmod, sd), nt.load_reference_state_dict(tmod,
                                                                     sd)


# --- the layers ----------------------------------------------------------------

@pytest.mark.parametrize("leaky", [0.0, 0.2])
def test_conv_net_2d_matches_jax(leaky):
    jnet, tnet = _loaded(
        JConvNet2d.create(jax.random.PRNGKey(1), (3, 8, 8, 4), (3, 1, 3),
                          leaky),
        ConvNet2d((3, 8, 8, 4), (3, 1, 3), leaky), 1)
    assert [n for n, _ in tnet.named_parameters()][::2] == [
        "net.0.weight", "net.2.weight", "net.4.weight"]
    x = pixels(shape=(3, 5, 5))
    close(tnet(t(x)).detach(), jnet(jnp.asarray(x)))


@pytest.mark.parametrize("scale,scale_map", [(True, "exp"),
                                             (True, "sigmoid"),
                                             (True, "sigmoid_inv"),
                                             (False, "exp")])
@pytest.mark.parametrize("split_mode", ["channel", "channel_inv",
                                        "checkerboard"])
@pytest.mark.parametrize("method", ["forward", "inverse"])
def test_affine_coupling_block_matches_jax(scale, scale_map, split_mode,
                                           method):
    c, n = 4, 2 if scale else 1
    cin = {"channel": 2, "channel_inv": 2, "checkerboard": 4}[split_mode]
    cout = {"channel": 2, "channel_inv": 2, "checkerboard": 4}[split_mode]
    channels = (cin, 8, 8, n * cout)
    jblock, tblock = _loaded(
        JCouplingBlock.create(
            JConvNet2d.create(jax.random.PRNGKey(2), channels, (3, 1, 3)),
            scale, scale_map, split_mode),
        tflows.AffineCouplingBlock(ConvNet2d(channels, (3, 1, 3)), scale,
                                   scale_map, split_mode), 2)
    x = pixels(shape=(c, 4, 6))
    zt, lt = getattr(tblock, method)(t(x))
    zj, lj = getattr(jblock, method)(jnp.asarray(x))
    close(zt.detach(), zj)
    rel_close(lt.detach(), lj)
    other = "inverse" if method == "forward" else "forward"
    back, ld = getattr(tblock, other)(zt)
    close(back.detach(), x)
    rel_close((lt + ld).detach(), np.zeros(BATCH))


@pytest.mark.parametrize("method", ["forward", "inverse"])
@pytest.mark.parametrize("one_hot", [False, True])
def test_cc_affine_const_matches_jax(method, one_hot):
    jflow, tflow = _loaded(JCCAffine.create((3, 4, 4), 5),
                           tflows.CCAffineConst((3, 4, 4), 5), 3)
    x, y = pixels(shape=(3, 4, 4)), labels(num_classes=5)
    yt = torch.nn.functional.one_hot(t(y), 5).float() if one_hot else t(y)
    zt, lt = getattr(tflow, method)(t(x), y=yt)
    zj, lj = getattr(jflow, method)(jnp.asarray(x), y=jnp.asarray(y))
    close(zt.detach(), zj)
    rel_close(lt.detach(), lj)


@pytest.mark.parametrize("split_mode", ["channel", "checkerboard"])
@pytest.mark.parametrize("method", ["forward", "inverse"])
def test_glow_block_matches_jax(split_mode, method):
    jblock, tblock = _loaded(
        JGlowBlock.create(jax.random.PRNGKey(4), 6, 8,
                          split_mode=split_mode),
        tflows.GlowBlock(6, 8, split_mode=split_mode), 4)
    names = [n for n, _ in tblock.named_parameters()]
    assert "flows.0.flows.1.param_map.net.4.weight" in names
    assert {"flows.1.L", "flows.1.U", "flows.1.log_S", "flows.2.s"} <= set(
        names)
    x = pixels(shape=(6, 4, 4))
    zt, lt = getattr(tblock, method)(t(x))
    zj, lj = getattr(jblock, method)(jnp.asarray(x))
    close(zt.detach(), zj)
    rel_close(lt.detach(), lj)


def test_class_cond_flow_matches_jax():
    shape = (4, 4, 4)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    jflows = [JConv1x1.create(keys[0], 4, use_lu=True),
              JActNorm.create((4, 1, 1)),
              JGlowBlock.create(keys[1], 4, 8)]
    jmodel, tmodel = _loaded(
        JClassCondFlow.create(JClassCond.create(shape, 5), jflows),
        nt.ClassCondFlow(tdist.ClassCondDiagGaussian(shape, 5), [
            tflows.Invertible1x1Conv(4, use_lu=True),
            tflows.ActNorm((4, 1, 1)), tflows.GlowBlock(4, 8)]), 5)
    x, y = pixels(shape=shape), labels(num_classes=5)
    rel_close(tmodel.log_prob(t(x), t(y)).detach(),
              jmodel.log_prob(jnp.asarray(x), jnp.asarray(y)))
    rel_close(float(tmodel.forward_kld(t(x), t(y))),
              float(jmodel.forward_kld(jnp.asarray(x), jnp.asarray(y))))
    jinit = jmodel.init_from_data(jnp.asarray(x))
    tmodel.init_from_data(t(x))
    rel_close(tmodel.log_prob(t(x), t(y)).detach(),
              jinit.log_prob(jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        z, log_q = tmodel.sample(BATCH, torch.Generator().manual_seed(0),
                                 y=t(y), temperature=0.5)
        warm = nt.ClassCondFlow(tmodel.q0.with_temperature(0.5),
                                list(tmodel.flows))
        rel_close(warm.log_prob(z, t(y)), log_q, 1e-5)


# --- the whole model ---------------------------------------------------------------

def test_glow_matches_jax():
    jmodel, tmodel, _ = _pair()
    x, y = pixels(), labels()
    zt, ldt = tmodel.inverse_and_log_det(t(x))
    zj, ldj = jmodel.inverse_and_log_det(jnp.asarray(x))
    for a, b in zip(zt, zj):
        close(a.detach(), b)
    rel_close(ldt.detach(), ldj)
    xt, ldf = tmodel.forward_and_log_det([z.detach() for z in zt])
    close(xt.detach(), x)
    rel_close((ldt + ldf).detach(), np.zeros(BATCH))
    rel_close(tmodel.log_prob(t(x), t(y)).detach(),
              jmodel.log_prob(jnp.asarray(x), jnp.asarray(y)))


def test_scan_loads_the_same_export_and_is_bitwise_the_unrolled_model():
    _, tmodel, sd = _pair()
    scanned = nt.load_reference_state_dict(
        nt.build_glow_multiscale(device="cpu", scan=True, **SMALL), sd)
    assert isinstance(scanned.flows[0][0], tflows.Scanned)
    x, y = t(pixels(seed=1)), t(labels(seed=1))
    with torch.no_grad():
        assert torch.equal(scanned.log_prob(x, y), tmodel.log_prob(x, y))
        a = tmodel.sample(BATCH, torch.Generator().manual_seed(2), y=y)
        b = scanned.sample(BATCH, torch.Generator().manual_seed(2), y=y)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_remat_recomputes_the_blocks_to_the_same_gradients():
    _, tmodel, sd = _pair()
    remat = nt.load_reference_state_dict(
        nt.build_glow_multiscale(device="cpu", scan=True, remat=True,
                                 **SMALL), sd)
    assert remat.flows[0][0].remat
    x, y = t(pixels(seed=3)), t(labels(seed=3))
    grads = []
    for m in (tmodel, remat):
        loss = m.forward_kld(x, y)
        loss.backward()
        grads.append((float(loss), [p.grad for p in m.parameters()]))
    rel_close(grads[1][0], grads[0][0], 1e-6)
    for a, b in zip(grads[1][1], grads[0][1]):
        rel_close(a.numpy(), b.numpy(), 1e-5)
    # without autograd it runs its layers without checkpoints
    with torch.no_grad():
        rel_close(remat.log_prob(x, y), tmodel.log_prob(x, y), 1e-6)


def test_glow_init_from_data_matches_jax():
    jmodel, tmodel, _ = _pair()
    x, y = pixels(seed=6, n=32), labels(seed=6, n=32)
    jinit = jax.jit(lambda m, a, b: m.init_from_data(a, b))(
        jmodel, jnp.asarray(x), jnp.asarray(y))
    tmodel.init_from_data(t(x), t(y))
    want = export_state_dict(jinit)
    for name, v in tmodel.state_dict().items():
        if name.endswith("flows.2.s") or name.endswith("flows.2.t"):
            close(v, want[name])
    x2, y2 = pixels(seed=7), labels(seed=7)
    rel_close(tmodel.log_prob(t(x2), t(y2)).detach(),
              jinit.log_prob(jnp.asarray(x2), jnp.asarray(y2)))


@pytest.mark.parametrize("temperature", [None, 0.7])
def test_glow_sample_with_labels_matches_jax(temperature):
    jmodel, tmodel, _ = _pair()
    eps = level_eps(tmodel, BATCH, 8)
    y = labels(seed=8)
    zt, lqt = torch_fixed_bases(tmodel, eps).sample(
        BATCH, y=t(y), temperature=temperature)
    zj, lqj = jax_fixed_bases(jmodel, eps).sample(
        jax.random.PRNGKey(0), BATCH, y=jnp.asarray(y),
        temperature=temperature)
    close(zt.detach(), zj)
    rel_close(lqt.detach(), lqj)


def test_glow_forward_kld_gradients_match_jax():
    jmodel, tmodel, _ = _pair()
    x, y = pixels(seed=9), labels(seed=9)
    params, static = partition(jmodel)
    loss_j, grads = jax.jit(jax.value_and_grad(
        lambda p: combine(p, static).forward_kld(
            jnp.asarray(x), jnp.asarray(y))))(params)
    loss_t = tmodel.forward_kld(t(x), t(y))
    loss_t.backward()
    rel_close(float(loss_t), float(loss_j))
    port_grads_close(tmodel, grads, static)


def test_mixed_precision_glow_is_within_the_bf16_bar():
    _, tmodel, sd = _pair()
    mixed = nt.load_reference_state_dict(
        nt.build_glow_multiscale(device="cpu", mixed_precision=True,
                                 **SMALL), sd)
    net = mixed.flows[0][0].flows[0].flows[1].param_map
    assert isinstance(net, nt.MixedPrecision)
    x, y = t(pixels(seed=10)), t(labels(seed=10))
    with torch.no_grad():
        got, want = mixed.log_prob(x, y), tmodel.log_prob(x, y)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=MIXED_TOL,
                               atol=MIXED_TOL)
    # the backward runs through the bf16 convolutions into f32 gradients
    mixed.forward_kld(x, y).backward()
    grad = net.net.net[0].weight.grad
    assert grad.dtype == torch.float32 and torch.isfinite(grad).all()


def test_builder_defaults_and_device():
    m = nt.build_glow_multiscale(device="cpu")
    assert isinstance(m, nt.MultiscaleFlow) and m.class_cond
    assert m.num_levels == 3 and [len(f) for f in m.flows] == [17] * 3
    block = m.flows[2][0]
    assert isinstance(block, tflows.GlowBlock)
    convs = [mod for mod in block.modules()
             if isinstance(mod, nt.nets.Conv2d)]
    assert [tuple(c.weight.shape) for c in convs] == [
        (256, 6, 3, 3), (256, 256, 1, 1), (12, 256, 3, 3)]
    assert not convs[-1].weight.any()
    assert [q.shape for q in m.q0] == [(48, 4, 4), (12, 8, 8), (6, 16, 16)]
    assert all(isinstance(q, tdist.ClassCondDiagGaussian) for q in m.q0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            nt.build_glow_multiscale()
