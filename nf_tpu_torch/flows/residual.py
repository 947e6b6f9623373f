"""Residual flows: invertible residual blocks ``y = x + g(x)`` with
power-series log-det estimators (``nf_tpu/flows/residual.py``; reference
``normflows/flows/residual.py``, from the residual-flows codebase).

* **Random source.** The JAX block splits its ``key`` into a probe key and
  a series-length key. Here :meth:`iResBlock.draw` takes both from the
  caller's ``torch.Generator`` (the probe by ``torch.randn``, then the
  series lengths), and the estimators are functions of that explicit
  probe and those coefficients (:meth:`iResBlock.hutchinson`), so a test
  can feed both frameworks the same ones. The draw goes through
  ``nets._dropout.shared_draw``: inside ``shared_masks()`` (the
  sticking-the-landing and DReG re-pass) a block reuses the sampling
  pass's probe and series length, as the JAX block gets the same per-flow
  key in both passes (``nf_tpu/core.py:130-140``).
* **Series lengths.** Geometric lengths (support from 1, as
  ``jax.random.geometric``) by inversion of a uniform draw on the device,
  ``floor(log1p(-u) / log1p(-p)) + 1``, the formula JAX samples with:
  ``Tensor.geometric_`` takes ``p`` as a host float, and ``p`` is a
  parameter on the device, so reading it would wait for the device on
  every draw and cannot be captured. Poisson lengths (support from 0) by
  ``torch.poisson`` on the device rate. The series runs to the static cap
  ``n_power_series_max`` with its coefficients masked beyond the sampled
  length; nothing reads the length on the host, so a captured step has a
  fixed length.
* **Basic estimator** (``neumann_grad=False``, ``build_residual``'s
  default): every one of the cap's vector-Jacobian products is
  differentiable (``torch.autograd.grad(create_graph=True)``), so a
  training step back-propagates through all of them (a double backward
  through the net).
* **Neumann estimator** (``neumann_grad=True``): the products accumulate
  detached and one differentiable product carries the gradient;
  ``grad_in_forward`` (``reduce_memory``) runs it under a non-reentrant
  ``torch.utils.checkpoint``, the port's ``jax.checkpoint``.
* **Exact log-dets** (``exact_trace``, and ``brute_force`` for 2D
  inputs): the Jacobian by one vector-Jacobian product per feature
  (``torch.autograd.grad`` over the whole batch, D of them; with
  ``create_graph`` when a step differentiates the log-det). Under a CUDA
  graph this gives what it gives eagerly; ``torch.func.jvp`` (two JVPs)
  did not: a captured ``log_prob`` through it came out 3.6e-3 from the
  eager one on the H100 (PERF.md, section 6).
* **Fixed-point inverse** ``x = y - g(x)`` (:class:`_FixedPointInverse`)
  with the implicit-function-theorem VJP: the backward solves
  ``v <- u - J_g^T v`` by the same iteration, then ``theta_bar =
  -(dg/dtheta)^T v``.

**The fixed-point loop.** JAX's rule (``while_loop``'s ``cond``,
:func:`fixed_point_go`): starting from ``x = y - g(y)``, iterate while
*any* element of the batch moves by ``(x - x_prev)^2 / tol >= 1`` (``tol =
atol + |y| rtol``, 1e-5 and 1e-5; 1e-6 and 1e-6 for the backward) and the
count is at most 1000. Eagerly the port iterates a masked body, a
converged state staying frozen, and the host reads the test every
``FIXED_POINT_CHECK_EVERY`` steps (one host sync each): it stops at JAX's
count, exactly JAX's result. Under a CUDA graph the loop is a device-side
loop (``_graphs.while_loop``): a WHILE conditional node whose body is one
step of JAX's body, ``x_prev, x <- x, body(x)``, followed by kernel F
(``ops.fixed_point``), which evaluates the same test on the device, writes
the count and sets the node's condition. A replay stops where JAX stops,
at any count, and is bitwise the eager call. Each block writes its last
counts into device buffers and sets its ``fixed_point_unconverged`` flag
(sticky) where a solve stopped at the cap of 1000 still moving, where JAX
stops silently; :func:`fixed_point_stats` reads them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nets._dropout import shared_draw
from .base import Flow

# JAX's cap on the loop's count (``residual.py:50``: ``i <= 1000``)
FIXED_POINT_MAX_ITER = 1000
# eager: masked steps between two host reads of the convergence test
FIXED_POINT_CHECK_EVERY = 4


@contextlib.contextmanager
def _recording():
    """Autograd on and inference mode off: the estimators differentiate
    the net even in a served call (``torch.no_grad`` or
    ``torch.inference_mode``), and return detached results there."""
    with torch.inference_mode(False), torch.enable_grad():
        yield


def _leaf(x, graph):
    """``x`` itself where the outer graph records through it, else a leaf
    copy that requires grad (a copy: an inference tensor cannot enter
    autograd)."""
    if graph and x.requires_grad:
        return x
    return x.detach().clone().requires_grad_(True)


def _batch_dot(a, b):
    return torch.sum(a.reshape(a.shape[0], -1) * b.reshape(b.shape[0], -1),
                     dim=1)


def _moving(x, x_prev, tol):
    """Whether any element still moves by ``(x - x_prev)^2 / tol >= 1``
    (a device bool; a NaN compares false, as in JAX)."""
    return torch.any((x - x_prev) ** 2 / tol >= 1)


def fixed_point_go(x, x_prev, tol, count):
    """JAX's ``cond`` of the fixed-point ``while_loop`` (``residual.py:
    47-50``, ``:86-89``): whether any element moves by ``(x - x_prev)^2 /
    tol >= 1`` and ``count`` is at most 1000, as a device bool, with no
    host read. A NaN element counts as settled; an empty batch stops at
    once. Kernel F's plain version (``ops.fixed_point``)."""
    return _moving(x, x_prev, tol) & (count <= FIXED_POINT_MAX_ITER)


def _iterate(body, x, x_prev, tol, count):
    """JAX's Banach loop (``residual.py:42-58``) from ``(x, x_prev)``:
    ``x_prev, x <- x, body(x)`` while :func:`fixed_point_go`. Writes the
    number of passes into ``count`` (a block's int32 buffer) and returns
    ``(x, unconverged)``, the latter a device bool: stopped at the cap
    still moving. Under a capture the loop is a WHILE node
    (:func:`_iterate_captured`); it takes ``x`` as its own and writes it
    in place."""
    if x.is_cuda and torch.cuda.is_current_stream_capturing():
        return _iterate_captured(body, x, x_prev, tol, count)
    if x.is_cuda:
        # a capture cannot load the library: the warm-up loads it
        from ..ops import fixed_point

        fixed_point.library()
    c = torch.zeros((), dtype=torch.int32, device=x.device)
    go = fixed_point_go(x, x_prev, tol, c)
    # ``go`` turns false by the count's cap at the latest, so the loop ends
    while bool(go):
        for _ in range(FIXED_POINT_CHECK_EVERY):
            x_new = body(x)
            x_prev = torch.where(go, x, x_prev)
            x = torch.where(go, x_new, x)
            c = c + go.to(c.dtype)
            go = fixed_point_go(x, x_prev, tol, c)
    count.copy_(c)
    return x, _moving(x, x_prev, tol)


def _iterate_captured(body, x, x_prev, tol, count):
    """:func:`_iterate` inside a CUDA-graph capture: a WHILE node whose
    body is one step of JAX's body, then kernel F, which writes ``count``
    and sets the node's condition; kernel F also tests before the node,
    as JAX tests before its first pass. No masking: the loop stops where
    JAX's stops."""
    from .. import _graphs
    from ..ops.fixed_point import fixed_point_cond

    x = x.contiguous()
    x_prev = x_prev.clone(memory_format=torch.contiguous_format)
    tol = tol.contiguous()
    state = torch.zeros(3, dtype=torch.int32, device=x.device)

    def go(handle, after_pass):
        fixed_point_cond(x, x_prev, tol, count, state, after_pass, handle)

    def step():
        t = body(x)
        x_prev.copy_(x)
        x.copy_(t)

    _graphs.while_loop(go, step)
    return x, _moving(x, x_prev, tol)


class _FixedPointInverse(torch.autograd.Function):
    """``x = y - g(x)`` with the implicit VJP (``residual.py:61-102``):
    ``(I + J_g) dx = dy - dtheta dg/dtheta``, so the cotangent ``u`` of x
    gives ``v = (I + J_g)^{-T} u`` by ``v <- u - J_g^T v`` (a contraction,
    Lip(g) < 1), ``y_bar = v`` and ``theta_bar = -(dg/dtheta)^T v``.
    ``params``: the net's parameters, whose gradients it returns."""

    @staticmethod
    def forward(ctx, block, y, *params):
        tol = 1e-5 + torch.abs(y) * 1e-5
        x, unconverged = _iterate(lambda x: y - block.nnet(x),
                                  y - block.nnet(y), y, tol,
                                  block.fixed_point_iterations)
        block.fixed_point_unconverged.logical_or_(unconverged)
        ctx.block = block
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, u):
        (x,) = ctx.saved_tensors
        block = ctx.block
        params = [p for p in block.nnet.parameters()]
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(True)
            g = block.nnet(x_)

        def vjp_x(v):
            return torch.autograd.grad(g, x_, v, retain_graph=True)[0]

        def vjp_in_pass(v):
            # a loop body under capture records its own g from a leaf of
            # its own: autograd runs each backward op on the stream of its
            # forward op (and accumulates into a leaf on the stream the
            # leaf was first used on), so a g or a leaf from outside the
            # body would tie the body's stream to the parent graph's
            with torch.enable_grad():
                xb = x.detach().requires_grad_(True)
                gb = block.nnet(xb)
            return torch.autograd.grad(gb, xb, v)[0]

        capturing = u.is_cuda and torch.cuda.is_current_stream_capturing()
        vjp_pass = vjp_in_pass if capturing else vjp_x
        tol = 1e-6 + torch.abs(u) * 1e-6
        v, unconverged = _iterate(lambda v: u - vjp_pass(v), u - vjp_x(u),
                                  u, tol, block.vjp_iterations)
        block.fixed_point_unconverged.logical_or_(unconverged)
        want = [p for p, need in zip(params, ctx.needs_input_grad[2:])
                if need]
        grads = iter(torch.autograd.grad(g, want, v, allow_unused=True)
                     if want else ())
        out = []
        for need in ctx.needs_input_grad[2:]:
            gr = next(grads) if need else None
            out.append(None if gr is None else -gr)
        return (None, v, *out)


def geometric_1mcdf(p, k, offset):
    """P(n >= k) for the geometric law on {1, 2, ...}
    (reference ``residual.py:398-404``)."""
    kk = k - offset
    val = (1 - p) ** torch.clamp_min(kk - 1, 0)
    return torch.where(k <= offset, torch.ones_like(val), val)


def poisson_1mcdf(lamb, k, offset, max_k):
    """P(n >= k) for the Poisson law (reference ``residual.py:411-421``)."""
    i = torch.arange(max_k + 1, dtype=torch.float32, device=k.device)
    terms = torch.exp(i * torch.log(lamb) - torch.lgamma(i + 1.0))
    cumsum = torch.cumsum(terms, dim=0)  # sum_{i=0..j} lamb^i / i!
    kk = k - offset
    idx = torch.clamp(kk - 1, 0, max_k).long()
    val = 1.0 - torch.exp(-lamb) * cumsum[idx]
    return torch.where(k <= offset, torch.ones_like(val), val)


class iResBlock(nn.Module):
    """Invertible residual block ``y = x + g(x)`` with a stochastic
    log-det (``nf_tpu/flows/residual.py:125-312``; reference
    ``residual.py:78-437``). ``geom_p`` (the logit of the geometric law's
    ``p``) and ``lamb`` carry the reference's names; both are used
    detached, as in the JAX package."""

    def __init__(self, nnet, geom_p=0.5, lamb=2.0, n_power_series=None,
                 exact_trace=False, brute_force=False, n_samples=1,
                 n_exact_terms=2, n_dist="geometric", neumann_grad=True,
                 grad_in_forward=False, n_power_series_max=24,
                 dtype=torch.float32):
        super().__init__()
        if n_dist not in ("geometric", "poisson"):
            raise NotImplementedError(n_dist)
        if n_power_series is not None:
            # a fixed truncation past the cap would compute fewer terms
            n_power_series_max = max(n_power_series_max, n_power_series)
        self.nnet = nnet
        self.geom_p = nn.Parameter(torch.tensor(
            np.log(geom_p) - np.log(1 - geom_p), dtype=dtype))
        self.lamb = nn.Parameter(torch.tensor(lamb, dtype=dtype))
        self.n_samples = n_samples
        self.n_power_series = n_power_series
        self.n_power_series_max = n_power_series_max
        self.exact_trace = exact_trace
        self.brute_force = brute_force
        self.n_exact_terms = n_exact_terms
        self.n_dist = n_dist
        self.neumann_grad = neumann_grad
        self.grad_in_forward = grad_in_forward
        # the fixed-point solves' last counts (written on the device) and
        # a sticky flag set when one stopped at the cap still moving (the
        # module's notes)
        for name, dt in (("fixed_point_iterations", torch.int32),
                         ("vjp_iterations", torch.int32),
                         ("fixed_point_unconverged", torch.bool)):
            self.register_buffer(name, torch.zeros((), dtype=dt),
                                 persistent=False)

    # --- y = x + g(x) and its inverse ------------------------------------

    def forward(self, x, logpx=None, generator=None):
        if logpx is None:
            return x + self.nnet(x)
        g, logdetgrad = self._logdetgrad(x, generator)
        return x + g, logpx - logdetgrad

    def inverse(self, y, logpy=None, generator=None):
        params = tuple(self.nnet.parameters())
        x = _FixedPointInverse.apply(self, y, *params)
        if logpy is None:
            return x
        return x, logpy + self._logdetgrad(x, generator)[1]

    # --- the log-det estimators --------------------------------------------

    def draw(self, x, generator):
        """The Hutchinson probe (``x``'s shape) and the series
        coefficients (``n_power_series_max``,), drawn from ``generator``
        in that order (``residual.py:213-217``)."""
        vareps = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                             device=x.device)
        return vareps, self._sample_coeffs(generator, x.device)

    def _sample_coeffs(self, generator, device):
        """Russian-roulette coefficients up to the cap
        (``residual.py:185-211``)."""
        cap = self.n_power_series_max
        ks = torch.arange(1, cap + 1, dtype=torch.float32, device=device)
        if self.n_power_series is not None:
            return (ks <= self.n_power_series).to(torch.float32)
        offset = self.n_exact_terms
        if self.n_dist == "geometric":
            p = torch.sigmoid(self.geom_p.detach()).to(torch.float32)
            u = torch.rand((self.n_samples,), generator=generator,
                           device=device)
            n = torch.floor(torch.log1p(-u) / torch.log1p(-p)) + 1.0
            rcdf = geometric_1mcdf(p, ks, offset)
        else:
            lam = self.lamb.detach().to(torch.float32)
            n = torch.poisson(lam.expand(self.n_samples),
                              generator=generator)
            rcdf = poisson_1mcdf(lam, ks, offset, cap)
        n = torch.clamp_max(n, cap - offset)
        n_max = torch.max(n) + offset
        frac = torch.mean((n[None, :] >= ks[:, None] - offset)
                          .to(torch.float32), dim=1)
        return torch.where(ks <= n_max, frac / rcdf, torch.zeros_like(frac))

    def hutchinson(self, x, vareps, coeffs):
        """``(g(x), log-det estimate)`` of the power series with the probe
        ``vareps`` and the coefficients ``coeffs``, by the Neumann or the
        basic estimator; under ``grad_in_forward`` checkpointed."""
        if self.grad_in_forward and torch.is_grad_enabled():
            return checkpoint(self._series, x, vareps, coeffs,
                              use_reentrant=False, preserve_rng_state=False)
        return self._series(x, vareps, coeffs)

    def _series(self, x, vareps, coeffs):
        graph = torch.is_grad_enabled()
        with _recording():
            x_in = _leaf(x, graph)
            g = self.nnet(x_in)

            def vjp(v, create_graph):
                return torch.autograd.grad(g, x_in, v, retain_graph=True,
                                           create_graph=create_graph)[0]

            cap = self.n_power_series_max
            w = vareps
            if self.neumann_grad:
                # the Neumann-series gradient (reference residual.py:368-379)
                neumann = vareps
                for k in range(1, cap + 1):
                    w = vjp(w, False)
                    sign = 1.0 if k % 2 == 0 else -1.0
                    neumann = neumann + sign * coeffs[k - 1] * w
                logdet = _batch_dot(vjp(neumann.detach(), graph), vareps)
            else:
                # the basic estimator (reference residual.py:355-365)
                logdet = torch.zeros(x.shape[0], dtype=x.dtype,
                                     device=x.device)
                for k in range(1, cap + 1):
                    w = vjp(w, graph)
                    logdet = logdet + ((-1.0) ** (k + 1) / k) \
                        * coeffs[k - 1] * _batch_dot(w, vareps)
        if not graph:
            return g.detach(), logdet.detach()
        return g, logdet

    def _jacobian(self, x):
        """``(g(x), J)`` with ``J[b, i, j] = dg_i / dx_j`` over the
        flattened features: one vector-Jacobian product per output
        feature, each over the whole batch, differentiable when autograd
        records (the exact log-det's gradient)."""
        graph = torch.is_grad_enabled()
        b, d = x.shape[0], x[0].numel()
        with _recording():
            x_in = _leaf(x, graph)
            g = self.nnet(x_in)
            flat = g.reshape(b, d)
            rows = []
            for i in range(d):
                e = torch.zeros_like(flat)
                e[:, i] = 1.0
                rows.append(torch.autograd.grad(
                    flat, x_in, e, retain_graph=True,
                    create_graph=graph)[0].reshape(b, d))
        jac = torch.stack(rows, dim=1)
        if not graph:
            return g.detach(), jac.detach()
        return g, jac

    def _exact_trace_series(self, x):
        """The power series with exact Jacobian traces
        (reference ``residual.py:229-242``)."""
        n_terms = self.n_power_series or (self.n_exact_terms + 4)
        g, jac = self._jacobian(x)
        logdet = torch.diagonal(jac, dim1=-2, dim2=-1).sum(-1)
        jac_k = jac
        for k in range(2, n_terms + 1):
            jac_k = torch.einsum("bij,bjk->bik", jac, jac_k)
            logdet = logdet + (-1.0) ** (k + 1) / k * torch.diagonal(
                jac_k, dim1=-2, dim2=-1).sum(-1)
        return g, logdet

    def _brute_force_2d(self, x):
        """The exact 2D log-det (reference ``residual.py:148-161``)."""
        g, jac = self._jacobian(x)
        dets = (jac[:, 0, 0] + 1) * (jac[:, 1, 1] + 1) \
            - jac[:, 0, 1] * jac[:, 1, 0]
        return g, torch.log(torch.abs(dets))

    def _logdetgrad(self, x, generator):
        if self.brute_force and x.ndim == 2 and x.shape[1] == 2:
            return self._brute_force_2d(x)
        if self.exact_trace:
            return self._exact_trace_series(x)
        if generator is None:
            raise ValueError(
                "iResBlock's stochastic log-det estimator needs a random "
                "source: pass generator= through log_prob / forward_kld (a "
                "fixed probe every step would bias training). For a "
                "deterministic 2D evaluation use "
                "flows.set_exact_logdet(model).")
        return self.hutchinson(x, *shared_draw(
            self, x.shape, lambda: self.draw(x, generator)))


class Residual(Flow):
    """Flow over an :class:`iResBlock` (``nf_tpu/flows/residual.py:
    315-349``; reference ``residual.py:12-75``). ``reverse=True`` (the
    default) puts ``x + g(x)`` on the inverse pass, so the density
    direction is the cheap one and sampling solves the fixed point."""

    def __init__(self, net, reverse=True, reduce_memory=True, geom_p=0.5,
                 lamb=2.0, n_power_series=None, exact_trace=False,
                 brute_force=False, n_samples=1, n_exact_terms=2,
                 n_dist="geometric", n_power_series_max=24):
        super().__init__()
        self.iresblock = iResBlock(
            net, geom_p=geom_p, lamb=lamb, n_power_series=n_power_series,
            exact_trace=exact_trace, brute_force=brute_force,
            n_samples=n_samples, n_exact_terms=n_exact_terms, n_dist=n_dist,
            neumann_grad=reduce_memory, grad_in_forward=reduce_memory,
            n_power_series_max=n_power_series_max)
        self.reverse = reverse

    def forward(self, z, context=None, generator=None):
        run = self.iresblock.inverse if self.reverse \
            else self.iresblock.forward
        z, log_det = run(z, 0.0, generator=generator)
        return z, -log_det.reshape(-1)

    def inverse(self, z, context=None, generator=None):
        run = self.iresblock.forward if self.reverse \
            else self.iresblock.inverse
        z, log_det = run(z, 0.0, generator=generator)
        return z, -log_det.reshape(-1)


def set_exact_logdet(model, exact=True):
    """Switch every iResBlock of ``model`` to the exact 2D log-det
    (``brute_force``), in place, and return ``model``; ``exact=False``
    switches back. The reference's eval mode computes the exact
    determinant for 2D inputs (``residual.py:148-161``); the JAX package
    returns a switched copy. Only 2-feature flows take it."""
    from ..utils.optim import map_modules

    def switch(block):
        block.brute_force = exact
        return block

    return map_modules(model, iResBlock, switch)


def fixed_point_stats(model):
    """``[(iterations, implicit-VJP iterations, unconverged)]`` of every
    iResBlock of ``model``, in module order: the last fixed-point solves'
    counts (a captured solve's as its last replay wrote them) and the
    sticky flag (the module's notes). Reads the device."""
    blocks = [m for m in model.modules() if isinstance(m, iResBlock)]
    if not blocks:
        return []
    vals = torch.stack([torch.stack([b.fixed_point_iterations,
                                     b.vjp_iterations,
                                     b.fixed_point_unconverged.to(
                                         torch.int32)])
                        for b in blocks]).cpu().tolist()
    return [(it, vjp, bool(flag)) for it, vjp, flag in vals]
