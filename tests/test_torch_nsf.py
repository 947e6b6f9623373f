"""The port's coupled NSF (``nf_tpu_torch.build_nsf``) against the JAX
package's ``build_nsf``, weights moved across by the weight bridge.

The JAX model is built on the CPU, exported with
``nf_tpu.compat_export.export_state_dict``, every float array is perturbed
with numpy (with the identity init every spline is the identity and
nothing is tested), and the perturbed dict is imported back into JAX and
loaded into the port with ``load_reference_state_dict``. Both then see the
same numpy inputs; ``sample()`` draws are not compared, since JAX keys and
torch generators give different numbers. Tolerance at K = 2 layers: 1e-4
abs on outputs, log-dets and log-densities, the bar the port is held to
(ROADMAP.md); two couplings and two LU solves in float32 put the outputs
themselves about 1e-5 apart.
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
from nf_tpu.ops import spline_head_fused as jshf
from nf_tpu_torch.ops import spline_head_fused as tshf
from nf_tpu_torch.ops import splines_kernel as tk

Y_TOL, LD_TOL = 1e-4, 1e-4
SMALL = dict(K=2, hidden=16, num_bins=4)
BATCH = 300
_PAIRS = {}


def _perturbed_state_dict(jmodel, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in export_state_dict(jmodel).items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            v = (v + scale * rng.standard_normal(v.shape)).astype(v.dtype)
        out[k] = v
    return out


def _pair(dim):
    """(JAX model, port model, state dict) with the same perturbed
    weights; built once per dim."""
    if dim not in _PAIRS:
        jmodel = jmodels.build_nsf(jax.random.PRNGKey(dim), dim=dim, **SMALL)
        sd = _perturbed_state_dict(jmodel, seed=dim)
        jmodel = import_state_dict(jmodel, sd)
        tmodel = nt.load_reference_state_dict(
            nt.build_nsf(dim=dim, device="cpu", **SMALL), sd)
        _PAIRS[dim] = (jmodel, tmodel, sd)
    return _PAIRS[dim]


def _inputs(dim, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BATCH, dim)) * 1.5).astype(np.float32)


def _run(model, method, x):
    out = getattr(model, method)(x)
    return out if isinstance(out, tuple) else (None, out)


@pytest.mark.parametrize("method", ["inverse_and_log_det",
                                    "forward_and_log_det", "log_prob"])
@pytest.mark.parametrize("jax_dispatch", ["default", "fused_head_on"])
@pytest.mark.parametrize("dim", [2, 3])
def test_model_matches_jax(dim, jax_dispatch, method):
    """JAX's default CPU dispatch runs the dense splines; with
    ``set_fused_head_mode("on")`` the couplings run the fused head+spline
    Pallas kernel in interpret mode. The port on the CPU runs its plain
    path either way."""
    jmodel, tmodel, _ = _pair(dim)
    x = _inputs(dim)
    if jax_dispatch == "fused_head_on":
        jshf.set_fused_head_mode("on")
    try:
        zj, lj = _run(jmodel, method, jnp.asarray(x))
    finally:
        jshf.set_fused_head_mode("auto")
    with torch.no_grad():
        zt, lt = _run(tmodel, method, torch.from_numpy(x))
    if zj is not None:
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=Y_TOL,
                                   rtol=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LD_TOL,
                               rtol=0)


def test_perturbation_moves_the_model_off_the_identity():
    _, tmodel, _ = _pair(2)
    x = torch.from_numpy(_inputs(2))
    with torch.no_grad():
        z, ld = tmodel.inverse_and_log_det(x)
    assert float((z - x).abs().max()) > 0.1
    assert float(ld.abs().max()) > 0.1


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nt.build_nsf(**SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nt.resolve_device(None)
    assert nt.resolve_device("cpu").type == "cpu"


def test_load_rejects_missing_and_unused_keys():
    _, _, sd = _pair(2)
    model = nt.build_nsf(dim=2, device="cpu", **SMALL)
    short = dict(sd)
    short.pop("flows.0.prqct.transform_net.final_layer.bias")
    with pytest.raises(KeyError, match="missing"):
        nt.load_reference_state_dict(model, short)
    extra = dict(sd, **{"flows.9.linear.bias": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="unused"):
        nt.load_reference_state_dict(model, extra)
    bad = dict(sd, **{"q0.loc": np.zeros((1, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        nt.load_reference_state_dict(model, bad)


def test_head_rows_are_permuted_to_bin_major():
    _, tmodel, sd = _pair(3)
    name = "flows.0.prqct.transform_net.final_layer.weight"
    ref = sd[name]  # feature-major rows d*mult + p
    net = tmodel.flows[0].prqct.transform_net
    d, mult = net.bin_major_head
    got = net.final_layer.weight.detach().numpy()  # rows p*D + d
    for p in range(mult):
        for f in range(d):
            np.testing.assert_array_equal(got[p * d + f], ref[f * mult + p])


def test_sample_log_q_matches_log_prob_on_cpu():
    _, tmodel, _ = _pair(3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        z, log_q = tmodel.sample(BATCH, generator=gen)
        lp = tmodel.log_prob(z)
    assert z.shape == (BATCH, 3) and torch.isfinite(z).all()
    torch.testing.assert_close(lp, log_q, atol=LD_TOL, rtol=0)
    gen2 = torch.Generator().manual_seed(0)
    with torch.no_grad():
        z2, _ = tmodel.sample(BATCH, generator=gen2)
    torch.testing.assert_close(z2, z, atol=0, rtol=0)


def test_round_trip_on_cpu():
    _, tmodel, _ = _pair(2)
    x = torch.from_numpy(_inputs(2, seed=1))
    with torch.no_grad():
        z, ld_inv = tmodel.inverse_and_log_det(x)
        x2, ld_fwd = tmodel.forward_and_log_det(z)
    torch.testing.assert_close(x2, x, atol=1e-4, rtol=0)
    torch.testing.assert_close(ld_fwd, -ld_inv, atol=LD_TOL, rtol=0)


def test_forward_kld_keeps_autograd_on_cpu():
    jmodel, _, sd = _pair(2)
    tmodel = nt.load_reference_state_dict(
        nt.build_nsf(dim=2, device="cpu", **SMALL), sd)
    x = _inputs(2, seed=2)
    loss = tmodel.forward_kld(torch.from_numpy(x))
    np.testing.assert_allclose(float(loss.detach()),
                               float(jmodel.forward_kld(jnp.asarray(x))),
                               atol=LD_TOL, rtol=0)
    loss.backward()
    grads = [p.grad for p in tmodel.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_cpu_path_launches_no_kernel():
    _, tmodel, _ = _pair(2)
    a, b = tk.rqs_fwd.launches, tshf.fused_head_rqs.launches
    with torch.no_grad():
        tmodel.log_prob(torch.from_numpy(_inputs(2)))
    assert (tk.rqs_fwd.launches, tshf.fused_head_rqs.launches) == (a, b)


def test_image_inputs_wait_for_their_slice():
    """The image slice has arrived: a coupling splits 2D and 4D inputs
    (``test_torch_image`` holds the 4D path against JAX) and refuses any
    other rank, as the JAX package's does."""
    _, tmodel, _ = _pair(2)
    with pytest.raises(ValueError, match="2D or a 4D"):
        tmodel.flows[0].prqct.forward(torch.zeros(4, 2, 3))
    identity, transform = tmodel.flows[0].prqct._split(
        torch.zeros(4, 2, 3, 3))
    assert identity.shape == transform.shape == (4, 1, 3, 3)

