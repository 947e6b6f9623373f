"""The bfloat16 autoregressive and circular spline models on the CPU, and
kernels A, C and D in bfloat16 at their layouts, against the JAX
package's float32 kernels and models.

Kernels. The planes a MADE hands kernel A are bin-major ``(mult, D, B)``:
widths and heights ``planes[:K] * softmax_scale`` (a bfloat16 product in
both frameworks), the derivatives padded for the tails (linear: the
slope-1 logit in bfloat16 at both ends; per-feature [circular, linear]:
the first logit repeated, or the constant) with one tail bound per
feature, pi rounded to bfloat16 (3.140625) on the angle. The port's plain
versions of A, C and D (``rqs_plain``, ``rqs_bwd_plain``,
``rqs_vjp_plain``) widen the bfloat16 operands, compute in float32 and
round each result once, as the bfloat16 kernels do; the reference is the
JAX package's float32 Pallas kernel (``fused_unconstrained_rqs_kmajor(...,
interpret=True)`` and ``jax.vjp`` of it under both
``set_pallas_bwd_kernel`` modes) on the same values, its results rounded
to bfloat16: every element within one bfloat16 ulp, ``2^-7 |ref| +
1e-6`` (gradients ``+ 1e-4 max |ref|``), the bar of
``tests/test_torch_splines_bf16.py``. Two inputs per feature sit at
exactly +-tb (the ties).

Models, small: two layers each, hidden 16 or 32, B 4096.
  * the AR NSF of ``examples/neural_spline_flow.py --autoregressive``:
    [``AutoregressiveRationalQuadraticSpline`` (2 blocks, hidden 16, 8
    bins), ``LULinearPermute``] x 2 on a ``DiagGaussian``, the
    forward-KLD step;
  * the circular NSF, ``build_circular_nsf``'s stack (hidden 32, 10 bins,
    tail bounds (pi, 3)) from the public layers, the reverse-KLD step;
  * the circular coupled model, ``CircularCoupledRationalQuadraticSpline``
    (one block, hidden 32, 10 bins) in place of the autoregressive layer,
    the reverse-KLD step.
Each is built with ``dtype=torch.bfloat16``. The JAX float32 model's
weights are perturbed by N(0, 0.1²) (``PERTURB``) and rounded to bfloat16
values; the port loads the unrounded export
(``load_reference_state_dict`` rounds each weight once, to the same
values). The bar is the JAX package's
mixed-precision one, 0.05 abs + 0.05 relative, on log-densities, the
steps' losses and the sampler's round trip (angles modulo 2 pi); the
steps' gradients are held as a whole, relative L2 <= 0.3 (as
``tests/test_torch_image_bf16.py``'s). Both reverse-KLD steps take the
same base draws in both frameworks (a numpy seed, rounded to bfloat16).
The port runs on the CPU's plain path and through the kernels' ops
(``ops.cpu_through_ops``), where every spline reaches an op with bfloat16
operands only (an op raises on mixed dtypes).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu.flows as jflows
import nf_tpu.models as jmodels
import nf_tpu_torch as nt
from nf_tpu.compat_export import export_state_dict
from nf_tpu.core import NormalizingFlow as JNormalizingFlow
from nf_tpu.distributions.base import DiagGaussian as JDiagGaussian
from nf_tpu.distributions.base import UniformGaussian as JUniformGaussian
from nf_tpu.ops import splines_pallas as jpl
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows
from nf_tpu_torch import ops as tops
from nf_tpu_torch.ops import splines as tsp
from nf_tpu_torch.ops import splines_kernel as tk
from test_torch_autoregressive import circular_state_dict, perturb_jax
from test_torch_circular_coupled import layer_state_dict
from test_torch_reverse_kld import GaussVonMises, _jax_fixed

BF16 = torch.bfloat16
MP_TOL = 0.05  # abs, plus as much relative: the JAX package's bf16 bar
GRAD_TOL = 0.3  # relative L2 distance of the whole gradient vector
N = 700  # kernel operands: elements per feature
B = 4096  # model batch
# the models' weight noise: at N(0, 0.2²) the steeper splines put up to
# 1.5% of the rows' bfloat16 log-densities past the bar (1.29 times it at
# worst), while JAX's own per-operation bfloat16 model on the same rounded
# weights lies up to 8.8 times past it; at 0.1 the worst row takes 0.33 to
# 0.65 of the bar over two seeds
PERTURB = 0.1
PI16 = float(torch.tensor(np.pi).to(BF16))  # 3.140625


def _bf16_values(a):
    """``a`` rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(np.array(a, np.float32)).to(BF16).float() \
        .numpy()


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within_ulp(got, want, grad, what):
    """``got`` (bfloat16) within one bfloat16 ulp of ``want`` (float32)
    rounded to bfloat16, element by element."""
    ref = _bf16_values(_f32(want))
    bar = 2.0 ** -7 * np.abs(ref) + 1e-6
    if grad:
        bar = bar + 1e-4 * float(np.max(np.abs(ref)))
    err = np.abs(_f32(got).reshape(ref.shape) - ref)
    over = err > bar
    assert not over.any(), (f"{what}: {int(over.sum())} of {over.size} "
                            f"elements past one bfloat16 ulp, the worst "
                            f"{float(err.max()):.3g}")


# --- kernels A, C and D at the MADE's K-major planes ------------------------

# tails of the feed: (K, the feed's tails, per-feature bounds or None)
KMAJOR = {"linear": (8, "linear", None),
          "circular": (10, ["circular", "linear"], (PI16, 3.0))}


def _kmajor_operands(kind, seed):
    """x (2, N) and the K-major planes as ``kmajor_spline_feed`` forms
    them from a bfloat16 head output (mult, 2, N), with the tail bound
    (a float, or (2, 1) per feature) and cotangents, all bfloat16."""
    K, tails, bounds = KMAJOR[kind]
    mult = 3 * K - 1 if tails == "linear" else 3 * K + 1
    tb = 3.0 if bounds is None else torch.tensor(bounds, dtype=BF16)[:, None]
    tbv = np.broadcast_to(np.asarray(3.0 if bounds is None else bounds,
                                     np.float32).reshape(-1, 1), (2, N))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.1, 1.1, (2, N)) * tbv
    x[:, 0], x[:, 1] = tbv[:, 0], -tbv[:, 0]  # the ties at +-tb
    planes = torch.from_numpy(rng.normal(0, 1.0, (mult, 2, N)).astype(
        np.float32)).to(BF16)
    scale = 1.0 / np.sqrt(32)
    uw, uh = planes[:K] * scale, planes[K:2 * K] * scale
    ud = planes[2 * K:]
    if tails == "linear":
        ud = tsp.pad_derivatives(ud, "linear", 1e-3, axis=0)
    else:
        ud = tsp.pad_derivatives(ud, tails, 1e-3, axis=0)
    cty, ctl = (torch.from_numpy(rng.standard_normal((2, N)).astype(
        np.float32)).to(BF16) for _ in range(2))
    x16 = torch.from_numpy(x.astype(np.float32)).to(BF16)
    return x16, uw, uh, ud, tb, cty, ctl


def _jax_kernels(inverse, mode, x, uw, uh, ud, tb, cty, ctl):
    """JAX's float32 Pallas forward and its VJP under ``mode`` on the
    widened operands: ((y, ld), (gx, gw, gh, gd))."""
    a = [jnp.asarray(_f32(t)) for t in (x, uw, uh, ud)]
    tbj = jnp.asarray(_f32(tb) if isinstance(tb, torch.Tensor) else tb,
                      jnp.float32)

    def fn(*p):
        return jpl.fused_unconstrained_rqs_kmajor(*p, tbj, inverse=inverse,
                                                  interpret=True)

    def both(p, c):
        out, vjp = jax.vjp(fn, *p)
        return out, vjp(c)

    jpl.set_pallas_bwd_kernel(mode)
    try:
        return jax.jit(both)(tuple(a), (jnp.asarray(_f32(cty)),
                                        jnp.asarray(_f32(ctl))))
    finally:
        jpl.set_pallas_bwd_kernel("analytic")


# (tails, inverse, mode): the per-feature circular tails in both
# directions under "analytic" (A and C) and in the circular NSF's sampling
# direction under "autodiff" (D); linear tails in the AR NSF's step
# direction (the spline's forward). A, C and D at linear tails on (2, N)
# K-major planes in both directions and modes are
# tests/test_torch_splines_bf16.py's (each JAX trace here takes ~3 s)
KMAJOR_CASES = [("linear", False, "analytic"),
                ("circular", False, "analytic"),
                ("circular", True, "analytic"),
                ("circular", True, "autodiff")]


@pytest.mark.parametrize("kind,inverse,mode", KMAJOR_CASES)
def test_kmajor_twins_are_the_float32_kernels_rounded(kind, inverse, mode):
    """Kernel A's twin and kernel C's or D's (under the mode) in bfloat16
    on the MADE's K-major planes, at linear tails (K 8, bound 3) and
    per-feature [circular, linear] tails (K 10, bounds (3.140625, 3)):
    every element within one bfloat16 ulp of JAX's float32 Pallas
    kernels, and bfloat16 out."""
    ops16 = _kmajor_operands(kind, seed=80 + 4 * (kind == "circular")
                             + 2 * inverse + (mode == "autodiff"))
    x, uw, uh, ud, tb, cty, ctl = ops16
    (y_j, ld_j), grads_j = _jax_kernels(inverse, mode, *ops16)
    for name, g, w in zip(("y", "ld"), tk.rqs_plain(x, uw, uh, ud, tb,
                                                   inverse=inverse),
                          (y_j, ld_j)):
        assert g.dtype == BF16
        _within_ulp(g, w, False, name)
    twin = tk.rqs_bwd_plain if mode == "analytic" else tk.rqs_vjp_plain
    got = twin(x, uw, uh, ud, tb, cty, ctl, inverse=inverse)
    for name, g, w in zip(("gx", "gw", "gh", "gd"), got, grads_j):
        assert g.dtype == BF16
        _within_ulp(g, w, True, name)


def test_kmajor_feed_reaches_the_ops_in_bfloat16():
    """``kmajor_spline_feed`` on bfloat16 planes with a bfloat16 bound
    (the circular AR layer's) reaches kernel A's op with bfloat16
    operands and gives the plain path's values; a float32 bound raises
    there (no cast on the way to a kernel)."""
    from nf_tpu_torch.flows.neural_spline.feed import kmajor_spline_feed

    K, tails, bounds = KMAJOR["circular"]
    rng = np.random.default_rng(90)
    planes = torch.from_numpy(rng.normal(0, 1, (3 * K + 1, 2, 64)).astype(
        np.float32)).to(BF16)
    x = torch.from_numpy(rng.uniform(-3, 3, (64, 2)).astype(
        np.float32)).to(BF16)
    kw = dict(num_bins=K, tails=tuple(tails), tail_bound=1.0,
              softmax_scale=0.25, inverse=True, min_bin_width=1e-3,
              min_bin_height=1e-3, min_derivative=1e-3)
    tb16 = torch.tensor(bounds, dtype=BF16)
    plain = kmajor_spline_feed(x, planes, tail_bound_arr=tb16, **kw)
    with tops.cpu_through_ops():
        ops = kmajor_spline_feed(x, planes, tail_bound_arr=tb16, **kw)
        with pytest.raises(TypeError, match="one dtype"):
            kmajor_spline_feed(x, planes, tail_bound_arr=tb16.float(), **kw)
    for a, b in zip(ops, plain):
        assert a.dtype == BF16 and torch.equal(a, b)


# --- the three bfloat16 models ----------------------------------------------

HIDDEN_AR, HIDDEN_CIRC, BINS_CIRC = 16, 32, 10
TB_CIRC = np.asarray([np.pi, 3.0], np.float32)
SCALE_CIRC = np.asarray([2 * np.pi, 1.0], np.float32)


def _jax_ar(key):
    keys = jax.random.split(key, 4)
    flows = []
    for i in range(2):
        flows.append(jflows.AutoregressiveRationalQuadraticSpline.create(
            keys[2 * i], num_input_channels=2, num_blocks=2,
            num_hidden_channels=HIDDEN_AR, num_bins=8))
        flows.append(jflows.LULinearPermute.create(keys[2 * i + 1], 2))
    return JNormalizingFlow.create(JDiagGaussian.create(2, trainable=False),
                                   flows)


def _port_ar(dtype):
    flows = []
    for _ in range(2):
        flows += [tflows.AutoregressiveRationalQuadraticSpline(
            2, 2, HIDDEN_AR, num_bins=8, dtype=dtype),
            tflows.LULinearPermute(2, dtype=dtype)]
    return nt.NormalizingFlow(
        tdist.DiagGaussian(2, trainable=False, dtype=dtype), flows)


def _jax_circular(key):
    return jmodels.build_circular_nsf(key, K=2, hidden=HIDDEN_CIRC,
                                      num_bins=BINS_CIRC)


def _port_circular(dtype):
    flows = [tflows.CircularAutoregressiveRationalQuadraticSpline(
        2, 1, HIDDEN_CIRC, ind_circ=[0], num_bins=BINS_CIRC,
        tail_bound=TB_CIRC, permute_mask=True, dtype=dtype)
        for _ in range(2)]
    flows.append(tflows.PeriodicWrap([0], bound=np.pi, dtype=dtype))
    return nt.NormalizingFlow(
        tdist.UniformGaussian(2, [0], scale=SCALE_CIRC, dtype=dtype), flows)


def _jax_coupled(key):
    keys = jax.random.split(key, 2)
    flows = [jflows.CircularCoupledRationalQuadraticSpline.create(
        keys[i], num_input_channels=2, num_blocks=1,
        num_hidden_channels=HIDDEN_CIRC, ind_circ=[0], num_bins=BINS_CIRC,
        tail_bound=(np.pi, 3.0), reverse_mask=(i % 2 == 1))
        for i in range(2)]
    flows.append(jflows.PeriodicWrap.create([0], bound=np.pi))
    return JNormalizingFlow.create(
        JUniformGaussian.create(2, ind=[0], scale=jnp.asarray(SCALE_CIRC)),
        flows)


def _port_coupled(dtype):
    flows = [tflows.CircularCoupledRationalQuadraticSpline(
        2, 1, HIDDEN_CIRC, ind_circ=[0], num_bins=BINS_CIRC,
        tail_bound=(np.pi, 3.0), reverse_mask=(i % 2 == 1), dtype=dtype)
        for i in range(2)]
    flows.append(tflows.PeriodicWrap([0], bound=np.pi, dtype=dtype))
    return nt.NormalizingFlow(
        tdist.UniformGaussian(2, [0], scale=SCALE_CIRC, dtype=dtype), flows)


def _coupled_state_dict(jmodel):
    """The reference-named state dict of :func:`_jax_coupled`'s model."""
    sd = {}
    for i, layer in enumerate(jmodel.flows[:2]):
        sd.update(layer_state_dict(layer, f"flows.{i}."))
    sd["flows.2.ind"] = np.asarray(jmodel.flows[2].ind)
    sd["flows.2.bound"] = np.asarray(jmodel.flows[2].bound)
    for name in ("scale", "ind", "ind_", "inv_perm"):
        sd["q0." + name] = np.asarray(getattr(jmodel.q0, name))
    return sd


def _ar_state_dict(jmodel):
    return {k: np.asarray(v) for k, v in export_state_dict(jmodel).items()}


# name: (JAX builder, port builder, exporter, the step's loss, angle column)
MODELS = {
    "ar_nsf": (_jax_ar, _port_ar, _ar_state_dict, "forward_kld", None),
    "circular_nsf": (_jax_circular, _port_circular, circular_state_dict,
                     "reverse_kld", 0),
    "circular_coupled": (_jax_coupled, _port_coupled, _coupled_state_dict,
                         "reverse_kld", 0)}
_PAIRS = {}


def _round_jax(jmodel):
    """``jmodel`` with every trainable array rounded to bfloat16 values
    (nearest even), held in float32."""
    params, static = partition(jmodel)
    params = jax.jit(lambda p: jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), p))(params)
    return combine(params, static)


def _pair(name):
    """(JAX float32 model on bfloat16-rounded weights, the port's bfloat16
    model loaded from the unrounded export, the unrounded export, the
    rounded one)."""
    if name not in _PAIRS:
        jbuild, tbuild, export, _, _ = MODELS[name]
        j32 = perturb_jax(jbuild(jax.random.PRNGKey(21)), 21, scale=PERTURB)
        sd = export(j32)
        jr = _round_jax(j32)
        t16 = nt.load_reference_state_dict(tbuild(BF16), sd)
        _PAIRS[name] = (jr, t16, sd, export(jr))
    return _PAIRS[name]


def _data(name, seed, n=B):
    """Inputs from a numpy seed (an angle in column 0 of the circular
    models), as bfloat16 and as the float32 values of those numbers."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2)) * 1.2
    if MODELS[name][4] is not None:
        x[:, 0] = rng.uniform(-np.pi, np.pi, n)
    x16 = torch.from_numpy(x.astype(np.float32)).to(BF16)
    return x16, jnp.asarray(x16.float().numpy())


def _base_draws(seed):
    """``UniformGaussian`` draws of scale (2 pi, 1), rounded to
    bfloat16."""
    rng = np.random.default_rng(seed)
    z = np.stack([rng.uniform(-0.5, 0.5, B), rng.standard_normal(B)],
                 axis=1) * SCALE_CIRC
    return torch.from_numpy(z.astype(np.float32)).to(BF16)


def mp_close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=MP_TOL,
                               rtol=MP_TOL, err_msg=what)


def _angle_close(got, want, col):
    """``got`` against ``want`` at the bf16 bar, column ``col`` (the angle)
    taken modulo 2 pi."""
    d = _f32(got).astype(np.float64) - _f32(want).astype(np.float64)
    if col is not None:
        d[:, col] = np.remainder(d[:, col] + np.pi, 2 * np.pi) - np.pi
    bar = MP_TOL + MP_TOL * np.abs(_f32(want))
    assert (np.abs(d) <= bar).all(), float(np.abs(d).max())


_JAX = {}
_jax_log_prob = jax.jit(lambda m, v: m.log_prob(v))


def _jax_results(name):
    """JAX's float32 log_prob on :func:`_data` and its step's loss and
    gradients (the reverse-KLD steps on :func:`_base_draws`), once per
    model."""
    if name not in _JAX:
        jr, _, _, _ = _pair(name)
        _, xj = _data(name, 22)
        lp = _jax_log_prob(jr, xj)
        if MODELS[name][3] == "forward_kld":
            params, static = partition(jr)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: combine(p, static).forward_kld(xj)))(params)
        else:
            z0 = _base_draws(23).float().numpy()
            params, static = partition(_jax_fixed(jr, z0))
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: combine(p, static).reverse_kld(
                    jax.random.PRNGKey(0), B)))(params)
        _JAX[name] = (lp, float(loss), combine(grads, static))
    return _JAX[name]


def _port_step(name, tmodel):
    """The port's step loss on the model (its gradients in ``.grad``)."""
    if MODELS[name][3] == "forward_kld":
        x16, _ = _data(name, 22)
        return tmodel.forward_kld(x16)
    z0 = _base_draws(23)
    tmodel.p = GaussVonMises()
    tmodel.q0.sample = lambda num_samples=1, generator=None: z0
    return tmodel.reverse_kld(B)


@pytest.mark.parametrize("name", list(MODELS))
def test_load_rounds_each_float32_weight_once(name):
    """The unrounded float32 export loads into the bfloat16 layers as the
    JAX weights rounded to bfloat16 once (bitwise the rounded export's
    load); every float parameter and buffer is bfloat16 (MADE masks, tail
    bounds, the wrap's bound, the base's scale), the MADE degree buffers
    stay int64."""
    _, t16, _, sd_rounded = _pair(name)
    again = nt.load_reference_state_dict(MODELS[name][1](BF16), sd_rounded)
    for (k, v), w in zip(t16.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(v, w), k
        if "degrees" in k:
            assert v.dtype == torch.int64, k
    floats = {n: t.dtype for n, t in list(t16.named_parameters())
              + list(t16.named_buffers()) if t.is_floating_point()}
    assert set(floats.values()) == {BF16}, floats


@pytest.mark.parametrize("feed", ["plain", "through_ops"])
@pytest.mark.parametrize("name", list(MODELS))
def test_model_is_jax_float32_at_the_bf16_bar(name, feed):
    """``log_prob`` and the step's loss of the bfloat16 model against
    JAX's float32 model on the same rounded weights at the bf16 bar; the
    step's gradients as a whole (relative L2 <= 0.3), bfloat16 and
    finite; on the CPU's plain path and through the kernels' ops."""
    jr, t16, _, sd_rounded = _pair(name)
    lp_j, loss_j, gmodel = _jax_results(name)
    tmodel = copy.deepcopy(t16)
    x16, _ = _data(name, 22)
    with (tops.cpu_through_ops() if feed == "through_ops"
          else torch.enable_grad()):
        with torch.no_grad():
            lp = tmodel.log_prob(x16)
        loss = _port_step(name, tmodel)
        loss.backward()
    assert lp.dtype == loss.dtype == BF16 and lp.shape == (B,)
    mp_close(lp.float(), lp_j, "log_prob")
    mp_close(float(loss.detach()), loss_j, "loss")
    want = nt.load_reference_state_dict(
        MODELS[name][1](torch.float32),
        MODELS[name][2](gmodel)).state_dict()
    diff = total = 0.0
    for n, p in tmodel.named_parameters():
        assert p.grad.dtype == BF16 and bool(torch.isfinite(p.grad).all()), n
        diff += float(((p.grad.double() - want[n].double()) ** 2).sum())
        total += float((want[n].double() ** 2).sum())
    assert (diff / total) ** 0.5 <= GRAD_TOL


@pytest.mark.parametrize("name", list(MODELS))
def test_sample_round_trip_at_the_bf16_bar(name):
    """``sample`` of the bfloat16 model through the kernels' ops: bfloat16
    draws (the angle wrapped into [-3.140625, 3.140625)), their
    ``log_prob`` against ``log_q`` and JAX's float32 ``log_prob`` of the
    same draws against ``log_q``, at the bf16 bar; ``forward(inverse(z))``
    back at ``z``, the angle modulo 2 pi."""
    jr, t16, _, _ = _pair(name)
    col = MODELS[name][4]
    with torch.no_grad(), tops.cpu_through_ops():
        z, log_q = t16.sample(B, generator=torch.Generator().manual_seed(24))
        lp = t16.log_prob(z)
        back = t16.forward(t16.inverse(z))
    assert z.dtype == log_q.dtype == BF16 and z.shape == (B, 2)
    assert bool(torch.isfinite(log_q.float()).all())
    if col is not None:
        assert float(z[:, col].float().abs().max()) <= PI16
    mp_close(lp.float(), log_q.float(), "log_prob(sample)")
    lp_j = _jax_log_prob(jr, jnp.asarray(z.float().numpy()))
    mp_close(lp_j, log_q.float(), "JAX log_prob(sample)")
    _angle_close(back, z, col)


def test_reverse_step_keeps_the_bfloat16_loss():
    """The reverse-KLD step of a bfloat16 model computes its loss in
    bfloat16 with ``beta`` rounded to bfloat16, as the captured step's
    device beta (a bfloat16 scalar) and the JAX package's weakly typed
    beta hold it: the step's loss at ``beta_schedule`` 0.37 is bitwise
    the model's ``reverse_kld`` at beta 0.369140625 on the same draws."""
    _, t16, _, _ = _pair("circular_nsf")
    z0 = _base_draws(25)
    losses = []
    for how in ("step", "model"):
        m = copy.deepcopy(t16)
        m.p = GaussVonMises()
        m.q0.sample = lambda num_samples=1, generator=None: z0
        if how == "step":
            opt = torch.optim.SGD(m.parameters(), lr=0.0)
            losses.append(nt.make_reverse_kld_step(
                opt, B, beta_schedule=lambda s: 0.37)(
                    nt.init_train_state(m, opt), None))
        else:
            with torch.no_grad():
                losses.append(m.reverse_kld(B, beta=0.369140625))
    assert float(torch.tensor(0.37).to(BF16)) == 0.369140625
    assert losses[0].dtype == BF16 and torch.equal(losses[0], losses[1])
