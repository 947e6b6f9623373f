"""Maximum-likelihood training step (``nf_tpu/parallel/train.py``), on one
device.

:func:`make_forward_kld_step` builds ``step(state, batch) -> loss``: the
forward KLD of the batch, its gradients, one ``torch.optim`` update, and
optionally gradient accumulation over microbatches, an EMA of the
parameters and a guard that discards a non-finite update. PyTorch updates
in place, so the step mutates ``state`` and returns only the loss, a
device tensor; nothing in it waits for the device.

Not ported yet: meshes, state shardings, donation, ``shard_batch`` and
``make_reverse_kld_step`` (the ``parallel/`` item, on
``torch.distributed``); keyed losses, ``post_update`` and carried buffers
(the residual-flow slice). ``post_update`` and ``with_key`` raise.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

_NO_EMA = ("state has no EMA params: build it with init_train_state(..., "
           "with_ema=True) and a step factory with ema_decay set")


@dataclasses.dataclass
class TrainState:
    """The model, its ``torch.optim`` optimizer, the count of steps taken
    and, with ``with_ema``, an EMA copy of the model (``train.py:35``).
    The step counter is a host integer: it advances on every step, a
    discarded one included, without reading the device."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: Optional[nn.Module] = None


def init_train_state(model, optimizer, with_ema=False):
    """Wrap ``model`` and ``optimizer`` in a :class:`TrainState`;
    ``with_ema=True`` adds a frozen copy of the model for the EMA that a
    step factory built with ``ema_decay`` updates (``train.py:63``)."""
    ema = copy.deepcopy(model).requires_grad_(False) if with_ema else None
    return TrainState(model=model, optimizer=optimizer, ema=ema)


def model_of_state(state: TrainState):
    """The live model of ``state`` (``train.py:82``)."""
    return state.model


def ema_model(state: TrainState):
    """The model with the EMA parameters, for evaluation and serving
    (``train.py:89``)."""
    if state.ema is None:
        raise ValueError(_NO_EMA)
    return state.ema


def _ema_update(ema, params, decay):
    """``e <- e + (1 - decay) * (p - e)`` in place, tensor by tensor."""
    with torch.no_grad():
        for e, p in zip(ema, params):
            e.copy_(e + (1.0 - decay) * (p - e))


def _all_finite(loss, grads):
    """Device bool: the loss and every gradient are finite."""
    ok = torch.isfinite(loss)
    for g in grads:
        if g is not None:
            ok = ok & torch.all(torch.isfinite(g))
    return ok


def _guard_nonfinite(ok, pairs):
    """``new <- where(ok, new, old)`` in place for each ``(new, old)``: the
    decision stays on the device, so the step never waits for it
    (``train.py:112``)."""
    with torch.no_grad():
        for new, old in pairs:
            if new.device != ok.device:
                raise ValueError(
                    f"skip_nonfinite decides on {ok.device}, but the "
                    f"optimizer keeps state on {new.device}; build it with "
                    f"its state on the parameters' device (for Adam: "
                    f"capturable=True)")
            new.copy_(torch.where(ok, new, old))


def _state_tensors(optimizer, params):
    """``{(index of param, key): tensor}`` of the optimizer's state."""
    out = {}
    for i, p in enumerate(params):
        for k, v in optimizer.state.get(p, {}).items():
            if torch.is_tensor(v):
                out[(i, k)] = v
    return out


def _check_guardable(optimizer):
    """Adam and its kin keep their step count on the host unless built
    with ``capturable=True`` (or ``fused=True``); such a count cannot be
    rolled back from a device-side decision."""
    for group in optimizer.param_groups:
        if ("capturable" in group
                and not (group["capturable"] or group.get("fused"))
                and any(p.is_cuda for p in group["params"])):
            raise ValueError(
                "skip_nonfinite decides on the device, and this optimizer "
                "keeps its step count on the host: build it with "
                "capturable=True")


def reshape_for_accum(batch, accum_steps: int):
    """``(B, ...) -> (accum_steps, B // accum_steps, ...)`` for every tensor
    of ``batch`` (a tensor or a tuple/list of them), for gradient
    accumulation (``train.py:136``)."""
    def r(x):
        b = x.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps "
                             f"{accum_steps}")
        return x.reshape((accum_steps, b // accum_steps) + tuple(x.shape[1:]))

    if isinstance(batch, (tuple, list)):
        return type(batch)(r(x) for x in batch)
    return r(batch)


def _microbatch(batch, i):
    if isinstance(batch, (tuple, list)):
        return type(batch)(x[i] for x in batch)
    return batch[i]


def _default_loss(model, batch):
    if isinstance(batch, (tuple, list)):
        return model.forward_kld(*batch)
    return model.forward_kld(batch)


def make_forward_kld_step(optimizer, loss_fn: Optional[Callable] = None,
                          accum_steps: int = 1,
                          ema_decay: Optional[float] = None,
                          skip_nonfinite: bool = False, post_update=None,
                          with_key: bool = False):
    """Build ``step(state, batch) -> loss`` (``train.py:176``).

    ``loss_fn(model, batch) -> scalar`` defaults to
    ``model.forward_kld(x)``, with ``batch`` a tensor ``x`` or a tuple
    ``(x, context)``. ``state.optimizer`` must be ``optimizer``.

    ``accum_steps > 1``: the batch arrives as ``(accum_steps, micro, ...)``
    (:func:`reshape_for_accum`); the loss and gradients are averaged over
    the microbatches before one update, which for the batch-mean forward
    KLD equals the full-batch step at less activation memory.

    ``ema_decay``: after each update, ``state.ema``'s parameters move to
    ``e + (1 - ema_decay) * (p - e)`` (needs ``with_ema=True``).

    ``skip_nonfinite=True``: when the loss or any gradient is not finite,
    the update of the parameters, the optimizer state and the EMA is
    discarded and only the step counter advances. The pre-step values are
    kept aside and restored with ``torch.where`` on the device, so the
    step never synchronises with the host. State that the optimizer
    creates on its first step is rolled back to zeros, the state Adam and
    momentum SGD start from. An optimizer with host-side state (Adam
    without ``capturable=True`` on CUDA) is refused. The non-finite loss is
    still returned.
    """
    if post_update is not None:
        raise NotImplementedError(
            "post_update (e.g. update_lipschitz) arrives with the "
            "residual-flow slice of the port")
    if with_key:
        raise NotImplementedError(
            "keyed losses (stochastic log-det estimators) arrive with the "
            "residual-flow slice of the port")
    if loss_fn is None:
        loss_fn = _default_loss

    def step(state: TrainState, batch):
        if state.optimizer is not optimizer:
            raise ValueError("state.optimizer is not the optimizer this "
                             "step was built with")
        if ema_decay is not None and state.ema is None:
            raise ValueError("ema_decay set but the state has no EMA slot: "
                             "build it with init_train_state(..., "
                             "with_ema=True)")
        model = state.model
        params = [p for g in optimizer.param_groups for p in g["params"]]
        if skip_nonfinite:
            _check_guardable(optimizer)
        optimizer.zero_grad(set_to_none=True)
        if accum_steps > 1:
            loss = None
            for i in range(accum_steps):
                part = loss_fn(model, _microbatch(batch, i))
                part.backward()
                part = part.detach()
                loss = part if loss is None else loss + part
            inv = 1.0 / accum_steps
            loss = loss * inv
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(inv)
        else:
            loss = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()

        ema = list(state.ema.parameters()) if ema_decay is not None else []
        if skip_nonfinite:
            ok = _all_finite(loss, [p.grad for p in params])
            with torch.no_grad():
                old_params = [p.detach().clone() for p in params + ema]
                old_state = {k: v.clone() for k, v in
                             _state_tensors(optimizer, params).items()}
        optimizer.step()
        if ema_decay is not None:
            _ema_update(ema, list(model.parameters()), ema_decay)
        if skip_nonfinite:
            pairs = list(zip(params + ema, old_params))
            for k, v in _state_tensors(optimizer, params).items():
                old = old_state.get(k)
                pairs.append((v, old if old is not None
                              else torch.zeros_like(v)))
            _guard_nonfinite(ok, pairs)
        state.step += 1
        return loss

    return step
