"""Why the ``image`` and ``change_base_distribution`` twins keep their
host-fed draw: each recipe itself leaves float32 on some draw streams, in
JAX as in the port (CPU).

The ``image`` twin's recipe (``examples/image.py``: ``build_realnvp`` K
16, hidden [64, 64], Adam 1e-3, batches of 512 from an ``ImagePrior`` of
the procedural smiley) trains on the port with its batch drawn inside the
step (``_utils.target_draw``, the sync-free pool), seed SEED. After ITER
iterations every loss is finite and so is every weight, but the batch of
iteration ITER holds a point of the target (a pixel of low intensity,
accepted against its uniform) where the affine scales overflow, so
``log_prob`` there is -inf and the loss leaves float32. The JAX
package's ``build_realnvp`` loaded with the same weights gives -inf at
the same rows and agrees with the port at the others: the non-finite
loss is the recipe's, not the port's.

The ``change_base_distribution`` recipe (8 affine couplings over a
Gaussian mixture, Adam 3e-3) left float32 only on the card: at seed 0 its
in-step stream's loss is not finite at iteration 63 on an NVIDIA H100
80GB HBM3 at 700.00 W, and at no seed of 0-103 on the CPU.
``tests/recipe_overflow_seeds.py --twins cb --seeds 0 1 --save DIR`` on
the card wrote the weights before that iteration and its batch to
``data/recipe_overflow_change_base_seed0_it63.npz``; loaded on the CPU,
the port's model and JAX's give -inf at the same row (a target point of
log-density -8.5) and agree at the others.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import nf_tpu.distributions as jdist
import nf_tpu.flows as jflows
import nf_tpu_torch as nt
from examples_torch import _utils, change_base_distribution, image
from nf_tpu import core
from nf_tpu.compat import import_state_dict
from nf_tpu.models.builders import build_realnvp as j_build_realnvp
from nf_tpu.nets import MLP as JMLP
from nf_tpu_torch.compat_export import export_state_dict
from nf_tpu_torch.distributions import GaussianMixture, ImagePrior

SEED, ITER = 2, 92
TOL = 1e-4  # relative to max(|log p|, 1), the repo's bar for deep stacks
CHANGE_BASE = os.path.join(os.path.dirname(__file__), "data",
                           "recipe_overflow_change_base_seed0_it63.npz")
MODES = [[-1.0, 0.0], [1.0, 0.0]]


def _same_non_finite_rows(port, jax_lp):
    """The rows where the port's log-density is not finite are JAX's, at
    least one and a few at most, and the others agree within TOL."""
    bad = ~np.isfinite(port)
    assert 0 < bad.sum() < 4, port[bad]
    np.testing.assert_array_equal(~np.isfinite(jax_lp), bad)
    err = np.abs(jax_lp[~bad] - port[~bad]) / np.maximum(
        np.abs(jax_lp[~bad]), 1)
    assert err.max() <= TOL
    return bad


def test_image_recipe_leaves_float32_in_jax_too():
    dev = torch.device("cpu")
    args = image.parser().parse_args(
        ["--device", "cpu", "--iters", str(ITER), "--seed", str(SEED)])
    target = ImagePrior(image.procedural_image(), device=dev)
    model = nt.build_realnvp(dim=2, K=16, hidden=[64, 64], target=target,
                             device=dev, seed=SEED)
    draw = _utils.target_draw(target, args, dev)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small products: one thread is the fastest
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, hist = _utils.train(model, _utils.ForwardKLD(draw=draw),
                                   args)
    finally:
        torch.set_num_threads(threads)
    assert bool(torch.isfinite(hist.losses).all())
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())

    # the batch the step of iteration ITER draws
    x, full = draw(torch.Generator().manual_seed(
        _utils.keyed_seed(SEED, ITER)))
    assert bool(full)
    # legitimate draws: inside the box, on pixels the image lights
    assert bool((x.abs() < 3).all())
    assert bool((target.image[target._pixels(
        (x - target.shift) / target.scale)] > 0).all())
    with torch.no_grad():
        lp = model.log_prob(x).numpy()

    sd = {k: np.asarray(v) for k, v in export_state_dict(model).items()}
    jmodel = import_state_dict(
        j_build_realnvp(jax.random.PRNGKey(0), dim=2, K=16, hidden=[64, 64]),
        sd)
    _same_non_finite_rows(lp, np.asarray(jmodel.log_prob(
        jnp.asarray(x.numpy()))))


def _jax_change_base(K=8):
    """``examples/change_base_distribution.py``'s model, its GMM base."""
    keys = jax.random.split(jax.random.PRNGKey(0), 2 * K)
    flows = []
    for i in range(K):
        flows.append(jflows.AffineCouplingBlock.create(
            JMLP.create(keys[i], [1, 64, 64, 2], init_zeros=True)))
        flows.append(jflows.Permute.create(keys[K + i], 2, mode="swap"))
    q0 = jdist.GaussianMixture.create(n_modes=2, dim=2, loc=MODES)
    return core.NormalizingFlow.create(q0, flows, p=jdist.TwoMoons())


def test_change_base_recipe_leaves_float32_in_jax_too():
    state = dict(np.load(CHANGE_BASE))
    x = state.pop("batch")
    assert x.shape == (512, 2) and np.all(np.abs(x) < 3)  # the box
    model = nt.load_reference_state_dict(
        change_base_distribution.build(GaussianMixture(
            n_modes=2, dim=2, loc=MODES), 0),
        {k: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        lp = model.log_prob(torch.from_numpy(x)).numpy()
    jmodel = import_state_dict(_jax_change_base(), state)
    _same_non_finite_rows(lp, np.asarray(jmodel.log_prob(jnp.asarray(x))))
