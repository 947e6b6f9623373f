"""The bfloat16 image NSF (``build_image_nsf(dtype=torch.bfloat16)``) on the
CPU, against the JAX package's float32 model.

JAX's bfloat16 image models cannot be built on the CPU (its QR and LU have
no bfloat16 kernel there), so the reference is JAX's float32
``build_image_nsf`` (3 x 8 x 8, L 2, K 2, hidden 8, 8 bins), perturbed
with numpy noise and carried across by ``export_state_dict``, holding the
port model's weights after their rounding to bfloat16 (the bases stay
float32 in both), on the same bfloat16 pixels. What is left between the
two is the port's bfloat16 arithmetic: its convolutions, ActNorms and 1x1
convolutions in bfloat16, its splines in float32 between bfloat16 loads
and stores (``ops.splines_kernel``), its 1x1 convolutions' solves in
float32.

The bar is the mixed-precision one of the JAX package, 0.05 abs plus 0.05
relative, on log-densities, losses and the sampler's round trip. One
step's gradients are held as a whole, by the relative L2 distance of the
gradient vector to JAX's float32 one, at 0.3: this small untrained
model's gradients are so sensitive to rounding that no per-element bar
holds for a bfloat16 model of it. Moving its float32 weights to their
bfloat16 values alone moves single float32 gradients by up to ~70% of
their parameter's largest gradient, and the JAX package's own model with
its layers cast to bfloat16 lies 0.06-0.31 (relative L2) from its float32
gradients on four batches of 8 (NaN on a fifth), where the port lies
0.05-0.26 on all five (both measured on the CPU). The weights are perturbed by
N(0, 0.1²) for the density and the step (log-densities ~500 nats) and by
N(0, 0.05²) for the sampler, whose untrained T = 0.7 draws at 0.1 leave
float32 before the Logit (``chip_smoke.IMG_PERTURB``).
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
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch.compat import _reference_names
from test_torch_autoregressive import perturb_jax

BF16 = torch.bfloat16
MP_TOL = 0.05  # abs, plus as much relative: the JAX package's bf16 bar
GRAD_TOL = 0.3  # relative L2 distance of the whole gradient vector
SMALL = dict(input_shape=(3, 8, 8), L=2, K=2, hidden_channels=8)
_PAIRS = {}


def bf16_pair(scale):
    """(JAX float32 model holding the port model's bfloat16 weights, the
    port's bfloat16 model on the CPU), ActNorms marked not yet set."""
    if scale not in _PAIRS:
        j32 = perturb_jax(jmodels.build_image_nsf(jax.random.PRNGKey(26),
                                                  **SMALL), 26, scale=scale)
        sd = {k: np.asarray(v) for k, v in export_state_dict(j32).items()}
        for k in [k for k in sd if k.endswith("data_dep_init_done")]:
            sd[k] = np.asarray(0.0, np.float32)
        t16 = nt.load_reference_state_dict(
            nt.build_image_nsf(device="cpu", dtype=BF16, **SMALL), sd)
        names = _reference_names(t16, t16.state_dict())
        rounded = {names.get(k, k): v.float().numpy()
                   for k, v in t16.state_dict().items()
                   if v.is_floating_point()}
        _PAIRS[scale] = (import_state_dict(j32, {**sd, **rounded}), t16)
    return _PAIRS[scale]


def pixels(n, seed):
    """Pixels in (0.05, 0.95) from a numpy seed, as bfloat16 and as the
    float32 values of those bfloat16 numbers."""
    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        0.05, 0.95, (n,) + SMALL["input_shape"]).astype(np.float32)).to(BF16)
    return x, jnp.asarray(x.float().numpy())


def mp_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=MP_TOL, rtol=MP_TOL)


def test_log_prob_is_jax_float32_at_the_bf16_bar():
    jmodel, tmodel = bf16_pair(0.1)
    x16, xj = pixels(8, 27)
    with torch.no_grad():
        got = tmodel.log_prob(x16)
    mp_close(got.float(), jax.jit(lambda m, v: m.log_prob(v))(jmodel, xj))


def test_step_is_jax_float32_at_the_bf16_bar():
    """One Adam step (``make_forward_kld_step``, lr 1e-3, as
    ``examples/image_nsf.py``): the loss against JAX's at the bf16 bar,
    the gradients against JAX's as a whole; Adam's state takes the
    parameters' dtype, as optax's does, and the parameters move."""
    import copy

    jmodel, tmodel = bf16_pair(0.1)
    tmodel = copy.deepcopy(tmodel)
    x16, xj = pixels(8, 29)
    params, static = partition(jmodel)
    loss_j, grads = jax.jit(jax.value_and_grad(
        lambda p: combine(p, static).forward_kld(xj)))(params)
    want = export_state_dict(combine(grads, static))
    names = _reference_names(tmodel, tmodel.state_dict())
    before = [p.detach().clone() for p in tmodel.parameters()]
    opt = torch.optim.Adam(tmodel.parameters(), lr=1e-3)
    state = nt.init_train_state(tmodel, opt)
    captured = {}

    def grab(p, n):
        p.register_post_accumulate_grad_hook(
            lambda t: captured.__setitem__(n, t.grad.detach().clone()))

    for n, p in tmodel.named_parameters():
        grab(p, n)
    loss = nt.make_forward_kld_step(opt)(state, x16)
    mp_close(float(loss), float(loss_j))
    diff = total = 0.0
    for n, p in tmodel.named_parameters():
        g = captured[n]
        # the bases stay float32, their gradients too
        dtype = torch.float32 if n.startswith("q0.") else BF16
        assert g.dtype == dtype and bool(torch.isfinite(g).all()), n
        w = np.asarray(want[names[n]], np.float64)
        diff += float(np.sum((g.double().numpy() - w) ** 2))
        total += float(np.sum(w ** 2))
    assert (diff / total) ** 0.5 <= GRAD_TOL
    for p in tmodel.parameters():
        assert all(v.dtype == p.dtype for k, v in opt.state[p].items()
                   if k != "step")
    moved = [not torch.equal(a, b) for a, b in zip(before,
                                                   tmodel.parameters())]
    assert sum(moved) >= len(moved) - 2


@pytest.mark.parametrize("seed", [3, 4])
def test_sample_round_trip_at_the_bf16_bar(seed):
    """``sample`` at T = 0.7, the serving path's (its bases draw in
    float32, its layers take the draws in bfloat16), against the tempered
    model's ``log_prob`` of its own draws."""
    _, tmodel = bf16_pair(0.05)
    with torch.no_grad():
        z, log_q = tmodel.sample(16, generator=torch.Generator()
                                 .manual_seed(seed), temperature=0.7)
        lp = tmodel.set_temperature(0.7).log_prob(z)
    assert z.dtype == BF16 and z.shape == (16,) + SMALL["input_shape"]
    assert log_q.dtype == torch.float32
    assert bool(torch.isfinite(log_q).all())
    mp_close(lp.float(), log_q.float())


def test_conv1x1_inverse_is_jax_float32_rounded():
    """The LU 1x1 convolution's bfloat16 ``W^-1`` (its solves taken in
    float32) within one bfloat16 ulp of JAX's float32 inverse of the same
    weights, and its log-det within float32 rounding."""
    jmodel, tmodel = bf16_pair(0.1)
    for level in range(2):
        conv, jconv = tmodel.flows[level][1], jmodel.flows[level][1]
        with torch.no_grad():
            w_inv, log_det = conv._weight(inverse=True)
        assert w_inv.dtype == BF16 and log_det.dtype == torch.float32
        ref = np.asarray(jconv._assemble_w(inverse=True))
        ref16 = torch.from_numpy(ref).to(BF16).float().numpy()
        bar = 2.0 ** -7 * np.abs(ref16) + 1e-6
        assert np.all(np.abs(w_inv.float().numpy() - ref16) <= bar)
        np.testing.assert_allclose(
            float(log_det), -float(jnp.sum(jconv.log_S)), rtol=1e-6,
            atol=1e-6)
