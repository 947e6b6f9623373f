"""Model containers (``nf_tpu/core.py:30-243``; reference
``normflows/core.py``): a base distribution and a chain of flows, and the
conditional variant that threads a context through both."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .flows.base import Scanned


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
        """The layers latent -> data, each ``Scanned`` opened."""
        out = []
        for flow in self.flows:
            out += flow.layers() if isinstance(flow, Scanned) else [flow]
        return out

    # the base's draws and density; the conditional container passes the
    # context on (the JAX package's NormalizingFlow does not)
    def _base_forward(self, num_samples, generator, context):
        return self.q0.forward(num_samples, generator=generator)

    def _base_log_prob(self, z, context):
        return self.q0.log_prob(z)

    def forward(self, z, context=None):
        """Latent z -> flow variable x (reference ``core.py:27``)."""
        for flow in self.chain():
            z, _ = flow.forward(z, context=context)
        return z

    def forward_and_log_det(self, z, context=None):
        """(reference ``core.py:40``)"""
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for flow in self.chain():
            z, log_d = flow.forward(z, context=context)
            log_det = log_det + log_d
        return z, log_det

    def inverse(self, x, context=None):
        """Flow variable x -> latent z (reference ``core.py:56``)."""
        for flow in reversed(self.chain()):
            x, _ = flow.inverse(x, context=context)
        return x

    def inverse_and_log_det(self, x, context=None):
        """(reference ``core.py:70``)"""
        log_det = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for flow in reversed(self.chain()):
            x, log_d = flow.inverse(x, context=context)
            log_det = log_det + log_d
        return x, log_det

    def log_prob(self, x, context=None):
        """Per-sample log q(x) (reference ``core.py:182``)."""
        z, log_q = self.inverse_and_log_det(x, context=context)
        return log_q + self._base_log_prob(z, context)

    def forward_kld(self, x, context=None):
        """MLE loss value -E[log q(x)] (reference ``core.py:87``). On CUDA
        its backward runs through the spline kernels' backward kernels (C
        and E)."""
        return -torch.mean(self.log_prob(x, context=context))

    def sample(self, num_samples=1, generator=None, context=None):
        """Draw samples with their log q (reference ``core.py:167``).
        ``generator`` lives on the model's device."""
        z, log_q = self._base_forward(num_samples, generator, context)
        for flow in self.chain():
            z, log_det = flow.forward(z, context=context)
            log_q = log_q - log_det
        return z, log_q

    def _log_prob_detached(self, z, context):
        """log q(z) with the parameters detached: only the path through
        ``z`` carries a gradient (the JAX package's
        ``stop_gradient_params``)."""
        detached = {name: t.detach() for name, t in
                    self.named_parameters(prefix="model")}
        return functional_call(_LogProb(self), detached, (z, context),
                               strict=False)

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
        gradient."""
        z, log_q = self.sample(num_samples, generator, context)
        if not score_fn:
            log_q = self._log_prob_detached(z, context)
        log_p = self._target_log_prob(z, context)
        return torch.mean(log_q) - beta * torch.mean(log_p)

    def reverse_alpha_div(self, num_samples=1, alpha=1.0, dreg=False,
                          generator=None, context=None):
        """Alpha divergence of ``num_samples`` draws against ``self.p``,
        with the DReG estimator when ``dreg`` (``nf_tpu/core.py:147-176``;
        reference ``core.py:133-165``)."""
        z, log_q = self.sample(num_samples, generator, context)
        log_p = self._target_log_prob(z, context)
        if not dreg:
            return float(np.sign(alpha - 1)) * torch.logsumexp(
                alpha * (log_p - log_q), dim=0)
        w_const = torch.exp(log_p - log_q).detach()
        log_q = self._log_prob_detached(z, context)
        w = torch.exp(log_p - log_q)
        w_alpha = w_const ** alpha
        w_alpha = w_alpha / torch.mean(w_alpha)
        weights = (1 - alpha) * w_alpha + alpha * w_alpha ** 2
        return -alpha * torch.mean(weights * torch.log(w))

    # --- data-dependent initialisation (nf_tpu/core.py:179-201) ----------

    def init_from_data(self, x, context=None):
        """Initialise the ActNorm layers from a data batch along the
        density (inverse) direction, in place; returns the model. Run it
        outside any capture: the parameters keep their addresses, so a
        served function or captured step built before it reads the new
        values."""
        with torch.no_grad():
            z = x
            for flow in reversed(self.chain()):
                z, _ = flow.init_data_inverse(z, context=context)
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
                z, _ = flow.init_data_forward(z, context=context)
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


class _LogProb(nn.Module):
    """``model.log_prob`` as a module's ``forward``, so that
    ``torch.func.functional_call`` can run it with other parameters."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, context=None):
        return self.model.log_prob(x, context=context)
