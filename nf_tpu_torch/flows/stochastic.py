"""Stochastic normalizing-flow layers: MCMC transitions as flow layers
(``nf_tpu/flows/stochastic.py``; reference ``normflows/flows/
stochastic.py``, arXiv 2002.06707).

The layers break the bijection contract: ``inverse`` is ``forward``, and
both draw. Every chain of the batch advances in lockstep, the accept
decisions dense ``torch.where`` selects, as in the JAX package.

Each layer splits its work in two. ``draw(z, generator)`` takes all its
random numbers from the generator, in the order the JAX package splits
its key (HMC: the momentum, then the accept uniforms; MH: per step the
proposal's noise, then the accept uniform); ``step`` then moves ``z``
deterministically. ``forward`` draws through
:func:`~nf_tpu_torch.nets._dropout.shared_draw`, so inside
``shared_masks()`` a layer called twice at one shape reuses its draws:
``reverse_kld(score_fn=False)`` and ``reverse_alpha_div(dreg=True)``
re-run the chain's inverse, and JAX feeds that re-pass the same per-flow
keys, so the same momenta, proposals and uniforms.

A layer holds its ``target`` without registering it: the target is its
owner's (a model's target, or a bridge over the model's base), which
moves it and keeps its state; the layer's own state is the reference's
names only (``log_step_size`` and ``log_mass``, ``proposal.scale``).

HMC differentiates the target. Under ``torch.no_grad`` or
``torch.inference_mode`` (``init_from_samples``, the served functions)
autograd is switched on for that gradient alone and the result detached;
under autograd the gradient is built with ``create_graph=True``, so a
loss's gradient flows through ``grad log p`` into the layers before and
into ``log_step_size`` and ``log_mass``, as JAX differentiates through its
leapfrog scan.
"""

from __future__ import annotations

import contextlib

import torch

from ..nets._dropout import shared_draw
from .base import Flow


@contextlib.contextmanager
def _recording():
    """Autograd on and inference mode off, for the target's gradient in a
    served call."""
    with torch.inference_mode(False), torch.enable_grad():
        yield


class MetropolisHastings(Flow):
    """``steps`` Metropolis-Hastings iterations targeting ``target`` with
    ``proposal`` (reference ``stochastic.py:6-49``); the log-det adds
    ``log p(z) - log p(z')`` over the accepted moves."""

    def __init__(self, target, proposal, steps=1):
        super().__init__()
        self.__dict__["target"] = target
        self.proposal = proposal
        self.steps = int(steps)

    def draw(self, z, generator=None):
        """Per step, the proposal's noise and the accept uniforms
        ``(B,)``: ``[(noise, w), ...]``."""
        out = []
        for _ in range(self.steps):
            noise = self.proposal.draw(z, generator)
            w = torch.rand(z.shape[0], generator=generator, dtype=z.dtype,
                           device=z.device)
            out.append((noise, w))
        return out

    def step(self, z, draws):
        """``(z', log_det, acceptance)`` on ``draws``; ``acceptance`` is
        each step's mean accept rate over the batch, shape ``(steps,)``."""
        log_p = self.target.log_prob(z)
        log_det = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        rates = []
        for noise, w in draws:
            z_, log_p_diff = self.proposal.propose_with(z, noise)
            log_p_ = self.target.log_prob(z_)
            w_accept = torch.clamp(torch.exp(log_p_ - log_p + log_p_diff),
                                   max=1.0)
            accept = w <= w_accept
            z = torch.where(accept[:, None], z_, z)
            log_det = torch.where(accept, log_det + log_p - log_p_, log_det)
            log_p = torch.where(accept, log_p_, log_p)
            rates.append(torch.mean(accept.to(z.dtype)))
        return z, log_det, torch.stack(rates)

    def forward_with_stats(self, z, context=None, generator=None):
        """:meth:`forward` and the per-step mean acceptance, ``(steps,)``
        (``nf_tpu/flows/stochastic.py:35``)."""
        draws = shared_draw(self, z.shape, lambda: self.draw(z, generator))
        return self.step(z, draws)

    def forward(self, z, context=None, generator=None):
        z, log_det, _ = self.forward_with_stats(z, context, generator)
        return z, log_det

    def inverse(self, z, context=None, generator=None):
        # the forward pass (reference ``stochastic.py:47-49``)
        return self.forward(z, context, generator)


class HamiltonianMonteCarlo(Flow):
    """HMC with ``steps`` leapfrog steps and one Metropolis correction,
    trainable ``log_step_size`` and ``log_mass`` (reference
    ``stochastic.py:52-109``). Both broadcast against ``z``'s feature axis
    as in the JAX package: a scalar or one value per feature. With
    ``max_abs_grad`` the target's gradient is clipped to that bound."""

    def __init__(self, target, steps, log_step_size, log_mass,
                 max_abs_grad=None):
        super().__init__()
        self.__dict__["target"] = target
        self.steps = int(steps)
        self.log_step_size = torch.nn.Parameter(
            torch.as_tensor(log_step_size, dtype=torch.float32).clone())
        self.log_mass = torch.nn.Parameter(
            torch.as_tensor(log_mass, dtype=torch.float32).clone())
        self.max_abs_grad = max_abs_grad

    def grad_log_p(self, z, create_graph=False):
        """``grad log p(z)`` per sample: the gradient of the batch sum of
        ``log p``. It equals JAX's per-sample ``vmap(grad(...))`` because
        a target's log-density of one sample does not depend on the
        others (every target of the package; a target with a cross-sample
        term would need a per-sample gradient). With ``create_graph`` the
        gradient is part of the autograd graph; otherwise it is computed
        with autograd switched on and returned detached."""
        with _recording():
            z_in = z if create_graph and z.requires_grad else \
                z.detach().clone().requires_grad_(True)
            log_p = self.target.log_prob(z_in)
            grad, = torch.autograd.grad(torch.sum(log_p), z_in,
                                        create_graph=create_graph)
        if not create_graph:
            grad = grad.detach()
        if self.max_abs_grad:
            grad = torch.clamp(grad, -self.max_abs_grad, self.max_abs_grad)
        return grad

    def draw(self, z, generator=None):
        """The unit-normal momentum (``z``'s shape) and the accept
        uniforms ``(B,)``, in that order (JAX: ``k_mom, k_acc =
        split(key)``)."""
        p = torch.randn(z.shape, generator=generator, dtype=z.dtype,
                        device=z.device)
        u = torch.rand(z.shape[0], generator=generator, dtype=z.dtype,
                       device=z.device)
        return p, u

    def trajectory(self, z, p_unit):
        """The leapfrog trajectory's end ``z_new`` from ``z`` with the
        unit-normal momentum ``p_unit``, and the Metropolis acceptance
        probability of the move, ``(B,)``."""
        create_graph = torch.is_grad_enabled()
        mass = torch.exp(self.log_mass)
        p = p_unit * torch.exp(0.5 * self.log_mass)
        step_size = torch.exp(self.log_step_size)
        z_new, p_new = z, p
        for _ in range(self.steps):
            p_half = p_new - (step_size / 2.0) * -self.grad_log_p(
                z_new, create_graph)
            z_new = z_new + step_size * (p_half / mass)
            p_new = p_half - (step_size / 2.0) * -self.grad_log_p(
                z_new, create_graph)
        probabilities = torch.exp(
            self.target.log_prob(z_new) - self.target.log_prob(z)
            - 0.5 * torch.sum(p_new ** 2 / mass, dim=1)
            + 0.5 * torch.sum(p ** 2 / mass, dim=1))
        return z_new, probabilities

    def step(self, z, draws):
        """``(z', log_det, acceptance)`` on ``draws`` (the momentum before
        its mass scaling, the uniforms); ``acceptance`` the mean accept
        rate of the one correction, shape ``(1,)``."""
        p_unit, u = draws
        z_new, probabilities = self.trajectory(z, p_unit)
        mask = u < probabilities
        z_out = torch.where(mask[:, None], z_new, z)
        log_det = self.target.log_prob(z) - self.target.log_prob(z_out)
        return z_out, log_det, torch.mean(mask.to(z.dtype))[None]

    def forward_with_stats(self, z, context=None, generator=None):
        """:meth:`forward` and the correction's mean acceptance, ``(1,)``
        (``nf_tpu/flows/stochastic.py:98``)."""
        draws = shared_draw(self, z.shape, lambda: self.draw(z, generator))
        return self.step(z, draws)

    def forward(self, z, context=None, generator=None):
        z, log_det, _ = self.forward_with_stats(z, context, generator)
        return z, log_det

    def inverse(self, z, context=None, generator=None):
        return self.forward(z, context, generator)
