"""Inverted dropout, the one helper every conditioner calls
(``nf_tpu/nets/resnet.py:95-98``, ``made.py:129-132,186-189``,
``mlp.py:123-126``).

The JAX package drops activations only when its caller passes a key:
``where(bernoulli(key, keep, x.shape), x / keep, 0)``, the key folded in
per block (``fold_in(key, i)``). The port draws the mask from the
caller's ``torch.Generator`` instead, in the layout it is given: ``(B,
H)`` on the batch-major trunk, ``(H, B)`` on the transposed one (JAX
draws in the transposed shape too, ``resnet.py:106-110``), ``(B, C, H,
W)`` in a convolutional block. ``generator=None`` returns ``x`` itself,
as JAX does without a key; every served ``log_prob`` passes none.

The uniform draw behind a mask is float32 whatever ``x``'s dtype: JAX's
``bernoulli`` draws in the dtype of ``keep``, a Python float, so a
bfloat16 trunk (``MixedPrecision``) sees the same masks as a float32 one.

A JAX key is a value: every call with one key draws the same mask. A
generator advances at each draw, so where the JAX package hands one key to
several calls, the port opens :func:`shared_masks`: inside it each
(module, shape) draws once, and every later call of that module at that
shape reuses the mask. The autoregressive inverse opens it around its D
passes (JAX reuses the flow's key in each of them,
``nf_tpu/flows/autoregressive.py:40-45``), and the sticking-the-landing
and DReG losses around the sampling pass and the re-pass through the
inverse chain (JAX feeds both the same per-flow keys,
``nf_tpu/core.py:139,163``). The masks are tensors made inside the call,
so the reuse holds under a CUDA graph capture too.

The MCMC layers (``flows.stochastic``) draw their momenta, proposals and
accept uniforms through :func:`shared_draw`, under the same rule: an MCMC
layer's inverse is its forward, so JAX's re-pass with the flow's key
draws the same numbers again, and inside :func:`shared_masks` the port's
re-pass reuses the sampling pass's draws.
"""

from __future__ import annotations

import contextlib

import torch

_SCOPES: list = []


def draw_mask(generator, keep, shape, device):
    """A boolean mask of ``shape``, True with probability ``keep``, drawn
    from ``generator`` (float32 uniforms, compared as JAX's
    ``bernoulli`` compares them)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return u < keep


@contextlib.contextmanager
def shared_masks():
    """Within this context each module draws one mask per shape and
    reuses it; nested, it joins the outer context (one draw per module
    across both)."""
    if _SCOPES:
        yield _SCOPES[-1]
        return
    _SCOPES.append({})
    try:
        yield _SCOPES[-1]
    finally:
        _SCOPES.pop()


def shared_draw(owner, shape, draw):
    """``draw()``, once per ``(owner, shape)`` inside :func:`shared_masks`
    (each later call returns the first draw), every time outside it."""
    if not _SCOPES:
        return draw()
    draws = _SCOPES[-1]
    key = (id(owner), tuple(shape))
    if key not in draws:
        draws[key] = draw()
    return draws[key]


def dropout(x, probability, generator, owner):
    """``x`` with inverted dropout at ``probability``, the mask drawn from
    ``generator``; ``x`` itself when ``generator`` is None or the
    probability is 0. ``owner`` (the calling module) keys the mask inside
    :func:`shared_masks`."""
    if generator is None or not probability:
        return x
    keep = 1.0 - probability
    mask = shared_draw(owner, x.shape, lambda: draw_mask(
        generator, keep, tuple(x.shape), x.device))
    return torch.where(mask, x / keep, 0.0)
