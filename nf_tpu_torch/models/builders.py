"""Model builders (``nf_tpu/models/builders.py``), all ten of the JAX
package's: :func:`build_realnvp`, :func:`build_planar_stack`,
:func:`build_radial_stack`, :func:`build_nsf`, :func:`build_circular_nsf`,
:func:`build_conditional_nsf`, :func:`build_maf`, :func:`build_residual`,
and the image models :func:`build_image_nsf` and
:func:`build_glow_multiscale`.

Weights are drawn on the host from ``torch.Generator().manual_seed(seed)``
and moved to ``device`` (None: CUDA, raising if it is absent)."""

from __future__ import annotations

import numpy as np
import torch

from .. import core
from .. import distributions as dist
from .. import flows as nff
from .._device import resolve_device
from ..nets import MLP, ConvResidualNet, LipschitzMLP, MixedPrecision
from ..transforms import Logit
from ..utils.masks import create_alternating_binary_mask


def build_realnvp(dim=2, K=64, hidden=None, target=None,
                  trainable_base=False, scan=False, mixed_precision=False,
                  device=None, seed=0, dtype=torch.float32):
    """Real NVP: K pairs of a ``MaskedAffineFlow`` (alternating masks,
    ``s`` and ``t`` MLPs ``[dim, *hidden, dim]`` with zero-init last
    layers) and an ``ActNorm`` (``builders.py:24-57``; reference
    ``examples/real_nvp.ipynb`` cell 2). ``hidden`` defaults to
    ``[32 dim, 32 dim]`` and the target to ``TwoModes``. Every layer
    starts as the identity; ``init_from_samples`` sets the ActNorms.

    ``scan=True`` groups the K/2 units (even-mask coupling, ActNorm,
    odd-mask coupling, ActNorm) into one ``Scanned`` (K must be even); it
    computes what ``scan=False`` does, bitwise, and loads the same
    export. ``mixed_precision=True`` runs ``s`` and ``t`` in bfloat16
    (:class:`~nf_tpu_torch.nets.MixedPrecision`). ``dtype`` is every
    parameter's and buffer's, the base's included, as in the JAX
    package."""
    if scan and K % 2 != 0:
        raise ValueError("scan=True needs an even K")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    hidden = hidden or [dim * 32, dim * 32]
    layers = [dim] + list(hidden) + [dim]
    flows = []
    for i in range(K):
        b = create_alternating_binary_mask(dim, even=(i % 2 == 0),
                                           dtype=dtype)
        s = MLP(layers, init_zeros=True, generator=gen, dtype=dtype)
        t = MLP(layers, init_zeros=True, generator=gen, dtype=dtype)
        if mixed_precision:
            s, t = MixedPrecision(s), MixedPrecision(t)
        flows += [nff.MaskedAffineFlow(b, t=t, s=s),
                  nff.ActNorm(dim, dtype=dtype)]
    if scan:
        flows = [nff.Scanned([nff.Composite(flows[4 * i:4 * i + 4])
                              for i in range(K // 2)])]
    q0 = dist.DiagGaussian(dim, trainable=trainable_base, dtype=dtype)
    return core.NormalizingFlow(q0, flows, p=target or dist.TwoModes()) \
        .to(dev)


def build_planar_stack(dim=2, K=16, target=None, device=None, seed=0):
    """K ``Planar`` layers (tanh) over a trainable ``DiagGaussian``, for
    reverse-KLD training (``builders.py:60-65``; reference
    ``examples/planar.ipynb``). Sampling only: tanh has no inverse."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    flows = [nff.Planar((dim,), generator=gen) for _ in range(K)]
    q0 = dist.DiagGaussian(dim, trainable=True)
    return core.NormalizingFlow(q0, flows, p=target).to(dev)


def build_radial_stack(dim=2, K=16, target=None, device=None, seed=0):
    """K ``Radial`` layers over a trainable ``DiagGaussian``
    (``builders.py:68-73``): forward only, for reverse-KLD training."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    flows = [nff.Radial((dim,), generator=gen) for _ in range(K)]
    q0 = dist.DiagGaussian(dim, trainable=True)
    return core.NormalizingFlow(q0, flows, p=target).to(dev)


def build_nsf(dim=2, K=8, hidden=128, num_bins=8, num_blocks=2,
              tail_bound=3.0, permutation=True, target=None, device=None,
              seed=0, mixed_precision=False):
    """Coupled RQ-spline NSF with LULinearPermute mixing
    (``builders.py:76``; reference NSF recipes, e.g. ``comparison.ipynb``).

    The splines start as the identity, as in the JAX package.
    ``mixed_precision=True`` runs the conditioners in bfloat16
    (:class:`~nf_tpu_torch.nets.MixedPrecision`); where a coupling takes
    the fused head (kernel B) its trunk stays float32, as in the JAX
    package."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    flows = []
    for i in range(K):
        flows.append(nff.CoupledRationalQuadraticSpline(
            num_input_channels=dim, num_blocks=num_blocks,
            num_hidden_channels=hidden, num_bins=num_bins,
            tail_bound=tail_bound, reverse_mask=(i % 2 == 1),
            mixed_precision=mixed_precision, generator=gen))
        if permutation:
            flows.append(nff.LULinearPermute(dim, generator=gen))
    q0 = dist.DiagGaussian(dim, trainable=False)
    return core.NormalizingFlow(q0, flows, p=target).to(dev)


def build_circular_nsf(dim=2, ind_circ=(0,), K=12, hidden=512, num_bins=10,
                       tail_bound=None, target=None, scale=None, device=None,
                       seed=0, mixed_precision=False):
    """Circular autoregressive NSF on a cylinder, the reference paper's
    example (``builders.py:95``; reference ``examples/paper_example_nsf.
    ipynb`` cell 8): K autoregressive RQ-spline layers (MADE with one
    residual block, ``hidden`` units, a permuted input order), then
    ``PeriodicWrap``, over a ``UniformGaussian`` base that is uniform on
    the circular coordinates.

    ``tail_bound`` defaults to pi on the circular features and 3 on the
    others, one bound per feature; ``scale`` to 2*pi on the circular
    features and 1 on the others. Weights and mask orders are drawn on the
    host from ``torch.Generator().manual_seed(seed)`` and moved to
    ``device`` (None: CUDA, raising if it is absent); the splines start as
    the identity. ``mixed_precision=True`` runs the MADEs in bfloat16
    (:class:`~nf_tpu_torch.nets.MixedPrecision`)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ind_circ = list(ind_circ)
    if tail_bound is None:
        tail_bound = np.full(dim, 3.0, np.float32)
        tail_bound[ind_circ] = np.pi
    if scale is None:
        scale = np.ones(dim, np.float32)
        scale[ind_circ] = 2 * np.pi
    flows = [nff.CircularAutoregressiveRationalQuadraticSpline(
        num_input_channels=dim, num_blocks=1, num_hidden_channels=hidden,
        ind_circ=ind_circ, num_bins=num_bins, tail_bound=tail_bound,
        permute_mask=True, mixed_precision=mixed_precision, generator=gen)
        for _ in range(K)]
    flows.append(nff.PeriodicWrap(ind_circ, bound=np.pi))
    q0 = dist.UniformGaussian(dim, ind=ind_circ, scale=scale)
    return core.NormalizingFlow(q0, flows, p=target).to(dev)


def build_conditional_nsf(dim=2, context_size=4, K=4, hidden=64, num_bins=8,
                          num_blocks=2, target=None, device=None, seed=0,
                          mixed_precision=False):
    """Conditional coupled RQ-spline NSF q(x | c) (``builders.py:123-139``;
    reference ``examples/conditional_flow.ipynb``): K couplings whose
    ResidualNet conditioners take the context (concatenated to the
    trunk's input and gating every block), each followed by an
    ``LULinearPermute``, over a fixed ``DiagGaussian`` base. On CUDA a
    coupling at B*D >= 4096 takes kernels B (its conditional half) and A
    (its unconditional CDF), as ``build_nsf``'s do. The splines start as
    the identity."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    flows = []
    for i in range(K):
        flows.append(nff.CoupledRationalQuadraticSpline(
            num_input_channels=dim, num_blocks=num_blocks,
            num_hidden_channels=hidden, num_context_channels=context_size,
            num_bins=num_bins, reverse_mask=(i % 2 == 1),
            mixed_precision=mixed_precision, generator=gen))
        flows.append(nff.LULinearPermute(dim, generator=gen))
    q0 = dist.DiagGaussian(dim, trainable=False)
    return core.ConditionalNormalizingFlow(q0, flows, p=target).to(dev)


def build_maf(dim=2, K=8, hidden=64, num_blocks=2, target=None, device=None,
              seed=0, mixed_precision=False):
    """Masked autoregressive flow: K ``MaskedAffineAutoregressive`` layers
    (MADE with ``num_blocks`` residual blocks of ``hidden`` units, a
    bin-major head), each followed by a random ``Permute``, over a fixed
    ``DiagGaussian`` base (``builders.py:142-153``). No kernel runs: a
    MAF layer is products and elementwise glue."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    flows = []
    for _ in range(K):
        flows.append(nff.MaskedAffineAutoregressive(
            dim, hidden, num_blocks=num_blocks,
            mixed_precision=mixed_precision, generator=gen))
        flows.append(nff.Permute(dim, generator=gen))
    q0 = dist.DiagGaussian(dim, trainable=False)
    return core.NormalizingFlow(q0, flows, p=target).to(dev)


def build_residual(dim=2, K=16, hidden=128, n_hidden_layers=3,
                   lipschitz_const=0.9, reduce_memory=False, target=None,
                   actnorm=True, device=None, seed=0):
    """Residual flow (``builders.py:156-173``; reference
    ``examples/residual.ipynb`` cell 1): K ``Residual`` blocks over
    ``LipschitzMLP([dim, hidden x n_hidden_layers, dim])`` nets with
    Lipschitz constant ``lipschitz_const``, each followed by an
    ``ActNorm``, over a fixed ``DiagGaussian``. ``reduce_memory=False``
    (the default) takes the basic estimator; ``True`` the Neumann one,
    checkpointed. Its ``log_prob`` / ``forward_kld`` take a ``generator``
    (or :func:`~nf_tpu_torch.flows.set_exact_logdet` for the exact 2D
    log-det); train it with ``make_forward_kld_step(with_key=True,
    post_update=lambda m: update_lipschitz(m, n))``. No spline kernel
    runs: the flow is products, their vector-Jacobian products and
    elementwise glue; under a CUDA graph each fixed point's condition is
    kernel F (``ops.fixed_point``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    flows = []
    for _ in range(K):
        net = LipschitzMLP([dim] + [hidden] * n_hidden_layers + [dim],
                           lipschitz_const=lipschitz_const, generator=gen)
        flows.append(nff.Residual(net, reduce_memory=reduce_memory))
        if actnorm:
            flows.append(nff.ActNorm(dim))
    q0 = dist.DiagGaussian(dim, trainable=False)
    return core.NormalizingFlow(q0, flows, p=target).to(dev)


def _image_levels(input_shape, L):
    """Per level i: the channels its layers see and the shape of its
    base's latent (``builders.py:209-232``)."""
    C, H, W = input_shape
    out = []
    for i in range(L):
        ch = C * 2 ** (L + 1 - i)
        if i > 0:
            latent = (C * 2 ** (L - i), H // 2 ** (L - i), W // 2 ** (L - i))
        else:
            latent = (C * 2 ** (L + 1), H // 2 ** L, W // 2 ** L)
        out.append((ch, latent))
    return out


def _image_base(latent, class_cond, num_classes):
    if class_cond:
        return dist.ClassCondDiagGaussian(latent, num_classes)
    return dist.GlowBase(latent)


def build_image_nsf(input_shape=(3, 32, 32), L=2, K=4, hidden_channels=64,
                    num_bins=8, tail_bound=3.0, num_classes=10,
                    class_cond=False, num_blocks=2, logit_alpha=0.05,
                    mixed_precision=False, device=None, seed=0,
                    dtype=torch.float32):
    """Multiscale neural-spline flow on images (``builders.py:176-238``):
    per level, K x [ActNorm, LU 1x1 convolution, RQ-spline channel
    coupling (linear tails) with a ``ConvResidualNet`` conditioner], then
    a ``Squeeze``; a ``Merge`` joins each level's latent to the next,
    under a ``Logit(logit_alpha)`` data transform. The bases are
    ``GlowBase`` or, with ``class_cond``, ``ClassCondDiagGaussian``.

    On CUDA every coupling's spline runs kernel A, and its backward kernel
    C, on the bin-major image feed: the conditioner's output viewed as
    ``(B*C/2, H*W)`` planes. ``mixed_precision=True`` runs the
    conditioners in bfloat16."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    q0, flows, merges = [], [], []

    def net_fn(in_ch, out_ch):
        net = ConvResidualNet(in_ch, out_ch, hidden_channels,
                              num_blocks=num_blocks, generator=gen,
                              dtype=dtype)
        return MixedPrecision(net) if mixed_precision else net

    for i, (ch, latent) in enumerate(_image_levels(input_shape, L)):
        level = []
        for j in range(K):
            # a {-1, 1} channel mask: the channels at +1 are transformed
            mask = create_alternating_binary_mask(ch, even=(j % 2 == 0)) \
                * 2.0 - 1.0
            level += [nff.ActNorm((ch, 1, 1), dtype=dtype),
                      nff.Invertible1x1Conv(ch, use_lu=True, generator=gen,
                                            dtype=dtype),
                      nff.PiecewiseRationalQuadraticCoupling(
                          mask, net_fn, num_bins=num_bins, tails="linear",
                          tail_bound=tail_bound, dtype=dtype)]
        level.append(nff.Squeeze())
        flows.append(level)
        if i > 0:
            merges.append(nff.Merge())
        q0.append(_image_base(latent, class_cond, num_classes))
    return core.MultiscaleFlow(q0, flows, merges,
                               transform=Logit(alpha=logit_alpha),
                               class_cond=class_cond).to(dev)


def build_glow_multiscale(input_shape=(3, 32, 32), L=3, K=16,
                          hidden_channels=256, num_classes=10,
                          class_cond=True, split_mode="channel", scale=True,
                          use_lu=True, logit_alpha=0.05, scan=False,
                          remat=False, mixed_precision=False, device=None,
                          seed=0, dtype=torch.float32):
    """Multiscale Glow (``builders.py:241-278``; reference
    ``examples/glow.ipynb`` cell 2: L 3, K 16, hidden 256, a
    class-conditional base, a Logit transform): per level K
    ``GlowBlock``s, then a ``Squeeze``. No kernel of the port runs: Glow
    is convolutions, 1x1 mixing products and elementwise glue.

    ``scan=True`` groups each level's K blocks into one ``Scanned``; it
    computes what ``scan=False`` does, bitwise, and loads the same
    export. ``remat=True`` (with ``scan``) recomputes each block's
    activations in the backward (``torch.utils.checkpoint``).
    ``mixed_precision=True`` runs the conditioners in bfloat16. ``dtype``
    is the blocks' (the bases stay float32, as in the JAX package)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    q0, flows, merges = [], [], []
    for i, (ch, latent) in enumerate(_image_levels(input_shape, L)):
        blocks = [nff.GlowBlock(ch, hidden_channels, scale=scale,
                                split_mode=split_mode, use_lu=use_lu,
                                mixed_precision=mixed_precision,
                                generator=gen, dtype=dtype)
                  for _ in range(K)]
        level = [nff.Scanned(blocks, remat=remat)] if scan else blocks
        level.append(nff.Squeeze())
        flows.append(level)
        if i > 0:
            merges.append(nff.Merge())
        q0.append(_image_base(latent, class_cond, num_classes))
    return core.MultiscaleFlow(q0, flows, merges,
                               transform=Logit(alpha=logit_alpha),
                               class_cond=class_cond).to(dev)
