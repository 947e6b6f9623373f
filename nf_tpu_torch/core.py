"""Model containers (``nf_tpu/core.py``; reference ``normflows/core.py``):
a base distribution and a chain of flows, the conditional variant that
threads a context through both, the class-conditional flow whose labels
condition only the base, the multiscale image flow, and the VAE with a
flow-transformed posterior."""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .distributions.base import replace
from .flows.base import open_scanned
from .nets._dropout import shared_masks


class NormalizingFlow(nn.Module):
    """Base distribution ``q0`` + flow chain + optional target ``p``
    (reference ``core.py:9-213``). ``forward`` maps latent -> data.

    Every method runs the chain's layers in order with a ``Scanned``
    opened into its layers (:meth:`chain`), so a model built with
    ``scan=True`` computes exactly what the unrolled one does."""

    def __init__(self, q0, flows, p=None):
        super().__init__()
        self.q0 = q0
        self.flows = nn.ModuleList(flows)
        self.p = p

    def chain(self):
        """The layers latent -> data, each ``Scanned`` opened (but one
        with ``remat=True``, :func:`~nf_tpu_torch.flows.base.open_scanned`)."""
        return open_scanned(self.flows)

    # the base's draws and density; the conditional container passes the
    # context on (the JAX package's NormalizingFlow does not)
    def _base_forward(self, num_samples, generator, context):
        return self.q0.forward(num_samples, generator=generator)

    def _base_log_prob(self, z, context):
        return self.q0.log_prob(z)

    def forward(self, z, context=None, generator=None):
        """Latent z -> flow variable x (reference ``core.py:27``)."""
        for flow in self.chain():
            z, _ = flow.forward(z, context=context, generator=generator)
        return z

    def forward_and_log_det(self, z, context=None, generator=None):
        """(reference ``core.py:40``)"""
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for flow in self.chain():
            z, log_d = flow.forward(z, context=context, generator=generator)
            log_det = log_det + log_d
        return z, log_det

    def inverse(self, x, context=None, generator=None):
        """Flow variable x -> latent z (reference ``core.py:56``)."""
        for flow in reversed(self.chain()):
            x, _ = flow.inverse(x, context=context, generator=generator)
        return x

    def inverse_and_log_det(self, x, context=None, generator=None):
        """(reference ``core.py:70``)"""
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for flow in reversed(self.chain()):
            x, log_d = flow.inverse(x, context=context, generator=generator)
            log_det = log_det + log_d
        return x, log_det

    def log_prob(self, x, context=None, generator=None):
        """Per-sample log q(x) (reference ``core.py:182``). ``generator``
        feeds the layers that draw (a residual flow's stochastic
        log-det), as the JAX package's ``key``."""
        z, log_q = self.inverse_and_log_det(x, context=context,
                                            generator=generator)
        return log_q + self._base_log_prob(z, context)

    def forward_kld(self, x, context=None, generator=None):
        """MLE loss value -E[log q(x)] (reference ``core.py:87``). On CUDA
        its backward runs through the spline kernels' backward kernels (C
        and E)."""
        return -torch.mean(self.log_prob(x, context=context,
                                         generator=generator))

    def sample(self, num_samples=1, generator=None, context=None):
        """Draw samples with their log q (reference ``core.py:167``).
        ``generator`` lives on the model's device; the base draws from it
        first, then every layer that draws."""
        z, log_q = self._base_forward(num_samples, generator, context)
        for flow in self.chain():
            z, log_det = flow.forward(z, context=context, generator=generator)
            log_q = log_q - log_det
        return z, log_q

    def sample_with_mcmc_stats(self, num_samples=1, generator=None,
                               context=None):
        """:meth:`sample` and the accept rates of its MCMC layers
        (``nf_tpu/core.py:99-121``): ``(z, log_q, acceptance)``, where
        ``acceptance`` holds one device tensor per MCMC layer in chain
        order, each that layer's ``forward_with_stats`` rates (``(steps,)``
        for Metropolis-Hastings, ``(1,)`` for HMC). Nothing here reads the
        device."""
        z, log_q = self._base_forward(num_samples, generator, context)
        acceptance = []
        for flow in self.chain():
            if hasattr(flow, "forward_with_stats"):
                z, log_det, acc = flow.forward_with_stats(
                    z, context=context, generator=generator)
                acceptance.append(acc)
            else:
                z, log_det = flow.forward(z, context=context,
                                          generator=generator)
            log_q = log_q - log_det
        return z, log_q, tuple(acceptance)

    def _log_prob_detached(self, z, context, generator=None):
        """log q(z) with the parameters detached: only the path through
        ``z`` carries a gradient (the JAX package's
        ``stop_gradient_params``)."""
        detached = {name: t.detach() for name, t in
                    self.named_parameters(prefix="model")}
        return functional_call(_LogProb(self), detached,
                               (z, context, generator), strict=False)

    def _target_log_prob(self, z, context):
        return self.p.log_prob(z, context=context) if context is not None \
            else self.p.log_prob(z)

    def reverse_kld(self, num_samples=1, beta=1.0, score_fn=True,
                    generator=None, context=None):
        """Variational loss ``E_q[log q(x)] - beta * E_q[log p(x)]`` on
        ``num_samples`` draws from the model, with the target ``self.p``
        (reference ``core.py:104-131``; ``nf_tpu/core.py:123``).
        ``generator`` lives on the model's device.

        ``score_fn=False`` is sticking the landing (arXiv 1703.09194):
        log q is recomputed through the inverse chain with the parameters
        detached, so only the path through the samples carries their
        gradient. The re-pass drops the activations the sampling pass
        dropped and its MCMC layers reuse the sampling pass's draws
        (:func:`~nf_tpu_torch.nets._dropout.shared_masks`), as the JAX
        package feeds both passes the same per-flow keys."""
        with shared_masks() if not score_fn else contextlib.nullcontext():
            z, log_q = self.sample(num_samples, generator, context)
            if not score_fn:
                log_q = self._log_prob_detached(z, context, generator)
        log_p = self._target_log_prob(z, context)
        return torch.mean(log_q) - beta * torch.mean(log_p)

    def reverse_alpha_div(self, num_samples=1, alpha=1.0, dreg=False,
                          generator=None, context=None):
        """Alpha divergence of ``num_samples`` draws against ``self.p``,
        with the DReG estimator when ``dreg`` (``nf_tpu/core.py:147-176``;
        reference ``core.py:133-165``), whose re-pass reuses the sampling
        pass's dropout masks and MCMC draws, as under
        ``reverse_kld(score_fn=False)``."""
        with shared_masks() if dreg else contextlib.nullcontext():
            z, log_q = self.sample(num_samples, generator, context)
            log_p = self._target_log_prob(z, context)
            if not dreg:
                return float(np.sign(alpha - 1)) * torch.logsumexp(
                    alpha * (log_p - log_q), dim=0)
            w_const = torch.exp(log_p - log_q).detach()
            log_q = self._log_prob_detached(z, context, generator)
        w = torch.exp(log_p - log_q)
        w_alpha = w_const ** alpha
        w_alpha = w_alpha / torch.mean(w_alpha)
        weights = (1 - alpha) * w_alpha + alpha * w_alpha ** 2
        return -alpha * torch.mean(weights * torch.log(w))

    # --- data-dependent initialisation (nf_tpu/core.py:179-201) ----------

    def init_from_data(self, x, context=None, generator=None):
        """Initialise the ActNorm layers from a data batch along the
        density (inverse) direction, in place; returns the model. Run it
        outside any capture: the parameters keep their addresses, so a
        served function or captured step built before it reads the new
        values. ``generator`` feeds the layers that draw (the JAX
        package's ``key``, which it requires for residual flows)."""
        with torch.no_grad():
            z = x
            for flow in reversed(self.chain()):
                z, _ = flow.init_data_inverse(z, context=context,
                                              generator=generator)
        return self

    def init_from_samples(self, num_samples=64, generator=None,
                          context=None):
        """Initialise the ActNorm layers along the sampling (forward)
        direction from ``num_samples`` base draws, in place (used before
        reverse-KLD training); returns the model. The base draws take no
        context, as in the JAX package."""
        with torch.no_grad():
            z, _ = self.q0.forward(num_samples, generator=generator)
            for flow in self.chain():
                z, _ = flow.init_data_forward(z, context=context,
                                              generator=generator)
        return self


class ConditionalNormalizingFlow(NormalizingFlow):
    """Flow with the context threaded through the base and every layer
    (``nf_tpu/core.py:204-243``; reference ``core.py:216-366``)."""

    def _base_forward(self, num_samples, generator, context):
        return self.q0.forward(num_samples, generator=generator,
                               context=context)

    def _base_log_prob(self, z, context):
        return self.q0.log_prob(z, context=context)

    def _target_log_prob(self, z, context):
        return self.p.log_prob(z, context=context)


class ClassCondFlow(nn.Module):
    """Labels condition only the base distribution, Glow-style
    (``nf_tpu/core.py:245-288``; reference ``core.py:369-452``)."""

    def __init__(self, q0, flows):
        super().__init__()
        self.q0 = q0
        self.flows = nn.ModuleList(flows)

    def log_prob(self, x, y):
        log_q = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        z = x
        for flow in reversed(open_scanned(self.flows)):
            z, log_det = flow.inverse(z)
            log_q = log_q + log_det
        return log_q + self.q0.log_prob(z, y)

    def forward_kld(self, x, y):
        return -torch.mean(self.log_prob(x, y))

    def sample(self, num_samples=1, generator=None, y=None,
               temperature=None):
        """Samples and their log q; ``temperature`` tempers the base
        (``with_temperature``), a path the reference's ClassCondFlow
        lacks and the JAX package adds for serving."""
        q0 = (self.q0.with_temperature(temperature)
              if temperature is not None else self.q0)
        z, log_q = q0.forward(num_samples, generator, y=y)
        for flow in open_scanned(self.flows):
            z, log_det = flow.forward(z)
            log_q = log_q - log_det
        return z, log_q

    def init_from_data(self, x, y=None):
        """Set the ActNorm layers from a data batch along the density
        direction, in place; returns the model."""
        with torch.no_grad():
            z = x
            for flow in reversed(open_scanned(self.flows)):
                z, _ = flow.init_data_inverse(z)
        return self


class MultiscaleFlow(nn.Module):
    """The RealNVP/Glow multiscale architecture (``nf_tpu/core.py:
    291-433``; reference ``core.py:455-653``): ``q0[i]`` the base of level
    i, ``flows[i]`` its layers (latent -> data), ``merges[i - 1]`` joining
    level i's latent to what the levels below made, and an optional
    data ``transform`` last (``Logit``). With ``class_cond`` every base
    takes the labels ``y``. A ``Scanned`` in a level runs opened into its
    layers (but with ``remat=True``), as in :class:`NormalizingFlow`."""

    def __init__(self, q0, flows, merges, transform=None, class_cond=True):
        super().__init__()
        self.q0 = nn.ModuleList(q0)
        self.flows = nn.ModuleList([nn.ModuleList(f) for f in flows])
        self.merges = nn.ModuleList(merges)
        self.transform = transform
        self.class_cond = class_cond

    @property
    def num_levels(self):
        return len(self.q0)

    def _level(self, i):
        return open_scanned(self.flows[i])

    def _level_dtype(self, i, like):
        """The dtype of level i's layers (their first floating-point
        parameter), or ``like``'s where they have none."""
        for p in self.flows[i].parameters():
            if p.is_floating_point():
                return p.dtype
        return like.dtype

    def forward_kld(self, x, y=None):
        """(reference ``core.py:480``)"""
        return -torch.mean(self.log_prob(x, y))

    def forward_and_log_det(self, z):
        """Latents per level -> x (reference ``core.py:504``)."""
        log_det = torch.zeros(z[0].shape[0], dtype=z[0].dtype,
                              device=z[0].device)
        z_ = None
        for i in range(self.num_levels):
            if i == 0:
                z_ = z[0]
            else:
                z_, ld = self.merges[i - 1].forward([z_, z[i]])
                log_det = log_det + ld
            for flow in self._level(i):
                z_, ld = flow.forward(z_)
                log_det = log_det + ld
        if self.transform is not None:
            z_, ld = self.transform.forward(z_)
            log_det = log_det + ld
        return z_, log_det

    def inverse_and_log_det(self, x):
        """x -> latents per level (reference ``core.py:528``)."""
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        if self.transform is not None:
            x, ld = self.transform.inverse(x)
            log_det = log_det + ld
        z = [None] * self.num_levels
        for i in range(self.num_levels - 1, -1, -1):
            for flow in reversed(self._level(i)):
                x, ld = flow.inverse(x)
                log_det = log_det + ld
            if i == 0:
                z[i] = x
            else:
                [x, z[i]], ld = self.merges[i - 1].inverse(x)
                log_det = log_det + ld
        return z, log_det

    def sample(self, num_samples=1, generator=None, y=None,
               temperature=None):
        """Samples and their log q, every base at ``temperature`` when
        given (reference ``core.py:553-586``). A class-conditional model
        without ``y`` draws one label per sample from ``generator`` and
        gives it to every level, as the JAX package does (the reference
        draws one per level, mixing classes across scales). The bases draw
        in float32; each level's draws enter its layers in their dtype
        (bfloat16 layers: bfloat16 draws), and log q stays float32."""
        model = (self.set_temperature(temperature)
                 if temperature is not None else self)
        if model.class_cond and y is None:
            y = torch.randint(0, model.q0[0].num_classes, (num_samples,),
                              generator=generator,
                              device=model.q0[0].loc.device)
        z = log_q = None
        for i in range(model.num_levels):
            if model.class_cond:
                z_, log_q_ = model.q0[i].forward(num_samples, generator,
                                                 y=y)
            else:
                z_, log_q_ = model.q0[i].forward(num_samples, generator)
            z_ = z_.to(model._level_dtype(i, z_))
            if i == 0:
                z, log_q = z_, log_q_
            else:
                log_q = log_q + log_q_
                z, log_det = model.merges[i - 1].forward([z, z_])
                log_q = log_q - log_det
            for flow in model._level(i):
                z, log_det = flow.forward(z)
                log_q = log_q - log_det
        if model.transform is not None:
            z, log_det = model.transform.forward(z)
            log_q = log_q - log_det
        return z, log_q

    def log_prob(self, x, y=None):
        """(reference ``core.py:588``)"""
        log_q = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        z = x
        if self.transform is not None:
            z, log_det = self.transform.inverse(z)
            log_q = log_q + log_det
        for i in range(self.num_levels - 1, -1, -1):
            for flow in reversed(self._level(i)):
                z, log_det = flow.inverse(z)
                log_q = log_q + log_det
            if i > 0:
                [z, z_], log_det = self.merges[i - 1].inverse(z)
                log_q = log_q + log_det
            else:
                z_ = z
            if self.class_cond:
                log_q = log_q + self.q0[i].log_prob(z_, y)
            else:
                log_q = log_q + self.q0[i].log_prob(z_)
        return log_q

    def set_temperature(self, temperature):
        """A copy whose bases sample at ``temperature`` (reference
        ``core.py:634-647``), sharing every tensor with this model: a
        graph captured through it reads this model's weights."""
        new = replace(self, _modules=dict(self._modules))
        new.q0 = nn.ModuleList([q.with_temperature(temperature)
                                for q in self.q0])
        return new

    def reset_temperature(self):
        return self.set_temperature(None)

    def init_from_data(self, x, y=None):
        """Set every ActNorm from a data batch along the density
        direction, through the merges, in place; returns the model. The
        flags are read here only: the forward and inverse passes never
        wait for the device."""
        with torch.no_grad():
            z = x
            if self.transform is not None:
                z, _ = self.transform.inverse(z)
            for i in range(self.num_levels - 1, -1, -1):
                for flow in reversed(self._level(i)):
                    z, _ = flow.init_data_inverse(z)
                if i > 0:
                    [z, _], _ = self.merges[i - 1].inverse(z)
        return self


class _LogProb(nn.Module):
    """``model.log_prob`` as a module's ``forward``, so that
    ``torch.func.functional_call`` can run it with other parameters."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, context=None, generator=None):
        return self.model.log_prob(x, context=context, generator=generator)


class NormalizingFlowVAE(nn.Module):
    """VAE with a flow-transformed approximate posterior
    (``nf_tpu/core.py:436-467``; reference ``core.py:656-701``): the
    encoder ``q0`` draws z given x, the ``flows`` transform it, and the
    ``prior`` and the optional ``decoder`` score it."""

    def __init__(self, prior, q0, flows=None, decoder=None):
        super().__init__()
        self.prior = prior
        self.q0 = q0
        self.flows = nn.ModuleList(flows or ())
        self.decoder = decoder

    def forward(self, x, num_samples=1, generator=None):
        """``(z, log_q, log_p)`` shaped ``(batch, num_samples, ...)``
        (reference ``core.py:676-700``): the encoder draws first from
        ``generator``, then every flow layer that draws."""
        z, log_q = self.q0(x, num_samples=num_samples, generator=generator)
        # flatten the batch and sample axes
        z = z.reshape((-1,) + tuple(z.shape[2:]))
        log_q = log_q.reshape((-1,) + tuple(log_q.shape[2:]))
        for flow in open_scanned(self.flows):
            z, log_det = flow.forward(z, generator=generator)
            log_q = log_q - log_det
        log_p = self.prior.log_prob(z)
        if self.decoder is not None:
            log_p = log_p + self.decoder.log_prob(x, z)
        z = z.reshape((-1, num_samples) + tuple(z.shape[1:]))
        log_q = log_q.reshape((-1, num_samples) + tuple(log_q.shape[1:]))
        log_p = log_p.reshape((-1, num_samples) + tuple(log_p.shape[1:]))
        return z, log_q, log_p
