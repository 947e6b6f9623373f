"""The port's MADE with a context (``nets.made.MADE``'s and
``MaskedResidualBlock``'s ``context_layer``) against the JAX package, on
the CPU.

A JAX MADE (3 features, context 2, hidden 16, two residual blocks,
output multiplier 4, feature-major or bin-major head) with its trainable
arrays moved by numpy noise N(0, 0.2²) crosses to the port through
``export_state_dict`` and ``load_reference_state_dict`` (masks
included). Tolerance 1e-4 abs on the outputs; gradients, the context's
included, 1e-4 after dividing by max(max |gradient|, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nf_tpu_torch as nt
from nf_tpu.compat_export import export_state_dict
from nf_tpu.nets.made import MADE as JMADE
from nf_tpu.nets.made import MaskedFeedforwardBlock as JFeedforward
from nf_tpu.utils.module import combine, partition
from nf_tpu_torch.nets.made import MADE, MaskedFeedforwardBlock

TOL = 1e-4
KW = dict(features=3, hidden_features=16, context_features=2, num_blocks=2,
          output_multiplier=4)


def _pair(bin_major_head, seed=0):
    jmade = JMADE.create(jax.random.PRNGKey(seed),
                         bin_major_head=bin_major_head, **KW)
    rng = np.random.default_rng(seed)
    params, static = partition(jmade)
    jmade = combine(jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(0.2 * rng.standard_normal(a.shape),
                                  a.dtype), params), static)
    sd = {k: np.asarray(v) for k, v in export_state_dict(jmade).items()}
    tmade = nt.load_reference_state_dict(
        MADE(bin_major_head=bin_major_head, **KW), sd)
    return jmade, tmade


@pytest.mark.parametrize("bin_major_head", [False, True])
def test_made_with_context_matches_jax(bin_major_head):
    jmade, tmade = _pair(bin_major_head)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 3)).astype(np.float32)
    c = rng.standard_normal((64, 2)).astype(np.float32)

    def jloss(xx, cc):
        out = jmade(xx, context=cc)
        return jnp.sum(jnp.sin(out)), out

    (_, want), (gx, gc) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(c))
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(c).requires_grad_(True)
    out = tmade(xt, context=ct)
    torch.sum(torch.sin(out)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    for got, ref in ((xt.grad, gx), (ct.grad, gc)):
        ref = np.asarray(ref)
        err = np.max(np.abs(got.numpy() - ref)) / max(np.max(np.abs(ref)),
                                                      1.0)
        assert err <= TOL
    # the context changes the output
    with torch.no_grad():
        moved = tmade(xt, context=ct + 1.0) - out
    assert float(moved.abs().max()) > 1e-3


def test_masked_feedforward_block_refuses_a_context():
    """As in the JAX package (``nf_tpu/nets/made.py:118-119``)."""
    degrees = np.arange(1, 4)
    with pytest.raises(NotImplementedError):
        JFeedforward.create(jax.random.PRNGKey(0), degrees, 3,
                            context_features=2)
    with pytest.raises(NotImplementedError):
        MaskedFeedforwardBlock(degrees, 3, context_features=2)
