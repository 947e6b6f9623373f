"""The port's mixed precision (``nf_tpu_torch.nets.MixedPrecision`` and the
builders' ``mixed_precision=True``) against the JAX package, on the CPU.

The conditioners run in bfloat16 in both frameworks, which round in
different orders, so both are held to the JAX package's own bar for
mixed precision (``tests/test_mixed_precision.py``): ``log_prob`` within
0.05 abs of the other framework, within 0.05 abs plus 0.05 relative of
the float32 model (that test's ``atol`` and ``rtol``), round trips within
0.02 abs. Weights cross as in ``tests/test_torch_nsf.py`` and
``tests/test_torch_autoregressive.py``: the JAX model's arrays perturbed
with numpy noise (N(0, 0.2²)), moved by the reference-named state dict,
which has no level for the wrapper (``nf_tpu/compat_export.py:377``).
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
from nf_tpu.nets.precision import MixedPrecision as JMixedPrecision
from nf_tpu.nets.resnet import ResidualNet as JResidualNet
from nf_tpu_torch.nets import MixedPrecision, ResidualNet
from test_torch_autoregressive import circular_state_dict, perturb_jax
from test_torch_serving import _perturbed_state_dict

LP_TOL = 0.05  # log_prob, bf16 against bf16 or f32 (JAX's own bar)
# bf16 against f32 also relative, as ``tests/test_mixed_precision.py``
# holds it: on these perturbed weights the JAX package's own bf16 model
# lies up to 0.29 (3%) from its f32 model, the port's within 2e-5 of it
LP_RTOL = 0.05
RT_TOL = 0.02  # round trips in bf16
SMALL_NSF = dict(dim=2, K=2, hidden=16, num_bins=4)
SMALL_CIRC = dict(K=2, hidden=64, num_bins=4)
BATCH = 200
_MODELS = {}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _resnet_pair(head=None):
    jnet = JResidualNet.create(jax.random.PRNGKey(0), in_features=3,
                               out_features=6, hidden_features=32,
                               bin_major_head=head)
    sd = _perturbed_state_dict(jnet, seed=1)
    tnet = nt.load_reference_state_dict(
        ResidualNet(3, 6, 32, bin_major_head=head), sd)
    return import_state_dict(jnet, sd), tnet


def _x(n=16, dim=3, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, dim)).astype(np.float32)


def test_wrapper_casts_and_returns_float32():
    jnet, tnet = _resnet_pair()
    x = _x()
    mp = MixedPrecision(tnet)
    with torch.no_grad():
        y = mp(torch.from_numpy(x))
        y32 = tnet(torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert not torch.equal(y, y32)  # the net did run in bfloat16
    _close(y, y32, LP_TOL)
    _close(y, JMixedPrecision(net=jnet)(jnp.asarray(x)), LP_TOL)
    # a bfloat16 input comes back in bfloat16
    assert mp(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def test_params_stay_float32_and_get_float32_grads():
    model = nt.build_circular_nsf(device="cpu", mixed_precision=True,
                                  **SMALL_CIRC)
    params = list(model.parameters())
    assert params and all(p.dtype == torch.float32 for p in params)
    x = torch.from_numpy(np.stack([np.linspace(-2.5, 2.5, 16),
                                   np.linspace(-1.0, 1.0, 16)], 1)
                         .astype(np.float32))
    (-model.log_prob(x).mean()).backward()
    grads = [p.grad for p in params if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_attribute_reads_go_to_the_float32_net():
    _, tnet = _resnet_pair(head=(2, 3))
    mp = MixedPrecision(tnet)
    assert mp.final_layer is tnet.final_layer
    assert mp.hidden_features == 32 and mp.bin_major_head == (2, 3)
    assert mp.features_transposed.__self__ is tnet
    with torch.no_grad():
        h_t = mp.features_transposed(torch.from_numpy(_x()))
    assert h_t.dtype == torch.float32  # the fused head's trunk stays f32
    with pytest.raises(AttributeError):
        mp.nonexistent_attribute  # noqa: B018


def _circular(mixed):
    """(JAX model, port model, state dict) of a perturbed
    ``build_circular_nsf``; the float32 and mixed models share weights."""
    key = ("circular", mixed)
    if key not in _MODELS:
        jmodel = perturb_jax(jmodels.build_circular_nsf(
            jax.random.PRNGKey(3), mixed_precision=mixed, **SMALL_CIRC), 3)
        sd = circular_state_dict(jmodel)
        tmodel = nt.load_reference_state_dict(nt.build_circular_nsf(
            device="cpu", mixed_precision=mixed, **SMALL_CIRC), sd)
        _MODELS[key] = (jmodel, tmodel, sd)
    return _MODELS[key]


def _nsf(mixed):
    key = ("nsf", mixed)
    if key not in _MODELS:
        jmodel = jmodels.build_nsf(jax.random.PRNGKey(4),
                                   mixed_precision=mixed, **SMALL_NSF)
        sd = _perturbed_state_dict(jmodel, seed=4)
        tmodel = nt.load_reference_state_dict(
            nt.build_nsf(device="cpu", mixed_precision=mixed, **SMALL_NSF),
            sd)
        _MODELS[key] = (import_state_dict(jmodel, sd), tmodel, sd)
    return _MODELS[key]


def _circular_inputs(n=BATCH, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2)) * 1.2
    x[:, 0] = rng.uniform(-np.pi, np.pi, n)
    return x.astype(np.float32)


def _nsf_inputs(n=BATCH, seed=6):
    return (np.random.default_rng(seed).standard_normal((n, 2)) * 1.5
            ).astype(np.float32)


MODELS = {"circular": (_circular, _circular_inputs),
          "nsf": (_nsf, _nsf_inputs)}


@pytest.mark.parametrize("name", list(MODELS))
def test_mixed_log_prob_matches_jax_and_float32(name):
    build, inputs = MODELS[name]
    jmp, tmp, _ = build(True)
    _, t32, _ = build(False)
    x = inputs()
    with torch.no_grad():
        lp = tmp.log_prob(torch.from_numpy(x))
        lp32 = t32.log_prob(torch.from_numpy(x))
    assert lp.dtype == torch.float32
    assert not torch.equal(lp, lp32)  # the conditioners ran in bfloat16
    _close(lp, jmp.log_prob(jnp.asarray(x)), LP_TOL)
    np.testing.assert_allclose(lp.numpy(), lp32.numpy(), atol=LP_TOL,
                               rtol=LP_RTOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_mixed_round_trips(name):
    """Each flow's inverse(forward(x)) and the log-dets' sum, as the JAX
    package's ``check_forward_inverse`` at its mixed-precision bar."""
    build, inputs = MODELS[name]
    _, tmp, _ = build(True)
    x = torch.from_numpy(inputs(seed=7))
    with torch.no_grad():
        for flow in tmp.flows:
            y, ld = flow.forward(x)
            x_back, ld_back = flow.inverse(y)
            d = x_back - x
            if name == "circular":  # the circular coordinate mod 2 pi
                d[:, 0] = torch.remainder(d[:, 0] + np.pi, 2 * np.pi) - np.pi
            _close(d, np.zeros_like(d), RT_TOL)
            _close(ld + ld_back, np.zeros_like(ld), RT_TOL)
            x = y


@pytest.mark.parametrize("name", list(MODELS))
def test_wrapped_model_loads_a_reference_state_dict(name):
    """The reference names have no ``net.`` level; the loader maps them
    onto the wrapper's keys, bin-major head rows permuted as for a bare
    net, so both models hold the same weights."""
    build, _ = MODELS[name]
    _, tmp, sd = build(True)
    _, t32, _ = build(False)
    own = tmp.state_dict()
    assert any(".net." in k for k in own)
    assert not any(".net." in k for k in sd)
    flat32 = t32.state_dict()
    for k, v in own.items():
        assert torch.equal(v, flat32[k.replace(".net.", ".")]), k
    with pytest.raises(KeyError):
        nt.load_reference_state_dict(tmp, {k: v for k, v in sd.items()
                                           if "final_layer" not in k})
