"""Training steps on one device (``nf_tpu/parallel/train.py``).

:func:`make_forward_kld_step` builds ``step(state, batch) -> loss``, the
maximum-likelihood step: the forward KLD of the batch, its gradients, one
``torch.optim`` update. :func:`make_reverse_kld_step` builds
``step(state, generator) -> loss``, the variational step: the reverse KLD
of samples the model draws from ``generator`` against its target. Both
take gradient accumulation over microbatches, an EMA of the parameters
and a guard that discards a non-finite update. PyTorch updates in place,
so a step mutates ``state`` and returns only the loss, a device tensor;
nothing in it waits for the device.

On CUDA a step is one CUDA graph per batch shape, as the JAX package's
steps are one ``jax.jit`` executable each (``train.py:283-296,416-419``):
the first two calls at a shape are eager steps on a side stream (they build the kernels and create the optimizer's state), the
next one captures the whole step (forward, backward through the spline
kernels, ``optimizer.step()``, the EMA, the non-finite guard, the
accumulation loop) and replays it once, and every later call copies its
batch into the graph's input and replays. A captured step needs:

* an optimizer whose state lives on the device: Adam and its kin built
  with ``capturable=True`` (others are refused);
* the optimizer's hyperparameters as they were at the capture: ``lr``
  and the rest of each ``param_group`` are baked into the graph, and a
  change raises (a tensor ``lr`` the graph reads may change in place);
* the optimizer's state tensors of the capture: the graph updates them
  at their addresses, so replacing them (``optimizer.load_state_dict``)
  raises; to resume from a checkpoint, load it before the first call or
  build a new step;
* the backward kernel mode (``set_pallas_bwd_kernel``) of the capture; a
  change raises;
* for the reverse step, the generator of its first call, registered with
  the graph (another one raises); ``beta_schedule(state.step)`` is
  written into a device scalar before each replay;
* for a keyed forward step (``with_key=True``), nothing: the step draws
  from a CUDA generator of its own, registered with the graph and
  reseeded with the call's integer seed before each replay, so a seed
  gives the draws of the eager step with that seed.

``post_update(model)`` (``update_lipschitz`` for residual flows) runs
after the optimizer's update, inside the step and so inside the graph, as
the JAX package runs it inside the jitted step; it changes the model in
place (a residual flow's power-iteration buffers, written at their
addresses).

A capture that fails raises; nothing runs eagerly in its place. On the
CPU the steps are eager. ``step.eager`` is the uncaptured step, and
``step.launches`` the kernel launches of one replay, counted at the last
capture.

With a ``mesh`` (:mod:`~nf_tpu_torch.parallel.mesh`) a step is sharded
over the ranks of the ``torch.distributed`` process group, each rank one
process on one device: the forward step takes the rank's shard of the
batch (:func:`shard_batch`), the reverse step draws the rank's share of
the samples from a stream of its own. The loss and the gradients are
averaged over the ``data`` ranks (the axis's subgroup on a mesh of more
axes) in one all-reduce of the flattened gradients before the optimizer,
``post_update``, the EMA and the non-finite guard, as JAX's ``pmean``
precedes them, so every rank takes the same update and the replicas stay
bitwise identical. On CUDA (NCCL) the collectives are inside the step's
graph. Layers that normalise by batch statistics (``BatchNorm``, the
batch-norm conditioners) take them over the global batch: the step's
forward passes run inside ``nets._batch_stats.global_batch``, where each
layer all-reduces its sums differentiably. The forward step's
``state_shardings`` (``tp.py``) hold the split parameters and their
optimizer state in blocks (:class:`_Layout`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from .._graphs import WARMUP_CALLS, capture, warm_up
from ..nets import _batch_stats
from ..ops.splines_kernel import get_pallas_bwd_kernel
from .mesh import _GOLDEN, RankStreams, data_sharding

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


def init_train_state(model, optimizer, with_ema=False, carry_buffers=False):
    """Wrap ``model`` and ``optimizer`` in a :class:`TrainState`;
    ``with_ema=True`` adds a frozen copy of the model for the EMA that a
    step factory built with ``ema_decay`` updates (``train.py:63``).

    ``carry_buffers`` is taken for parity and changes nothing: the JAX
    package threads the buffers through its state so that a
    ``post_update`` keeps its changes; the port's buffers live in the
    model, which a step changes in place."""
    del carry_buffers
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


def shard_batch(mesh, batch, accum: bool = False):
    """This rank's shard of a global batch (a tensor or array, or a tuple
    or list of them), on the mesh's device: its slice of dim 0, or under
    ``accum`` of dim 1, the micro dim of ``(accum_steps, micro, ...)``
    (:func:`reshape_for_accum`), over the ``data`` axis
    (``train.py:163``). Every rank passes the same global batch."""
    dim = 1 if accum else 0

    def local(x):
        x = torch.as_tensor(x)
        return data_sharding(mesh, x.ndim, dim=dim).local(x)

    if isinstance(batch, (tuple, list)):
        return type(batch)(local(x) for x in batch)
    return local(batch)


class _Reducer:
    """The average over the ``axis`` ranks of a step's loss and gradients:
    one all-reduce per dtype of the flattened tensors over the axis's
    subgroup (NCCL's average on CUDA, gloo's sum and a scale on the CPU).
    :meth:`forward` opens the global batch of the batch-statistics layers
    (``nets/_batch_stats.py``) around a forward pass."""

    def __init__(self, mesh, axis="data"):
        self.group = mesh.group(axis)
        self.size = mesh.shape[axis]

    def forward(self):
        return _batch_stats.global_batch(self.group, self.size)

    def __call__(self, loss, grads):
        nccl = dist.get_backend() == "nccl"
        if nccl != loss.is_cuda:
            raise ValueError(
                f"a sharded step on {loss.device} needs the "
                f"{'NCCL' if loss.is_cuda else 'gloo'} backend; the process "
                f"group runs {dist.get_backend()}")
        groups = {}
        for t in [loss] + grads:
            groups.setdefault(t.dtype, []).append(t)
        for tensors in groups.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            if nccl:
                dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=self.group)
            else:
                dist.all_reduce(flat, group=self.group)
                flat.mul_(1.0 / self.size)
            parts = torch.split(flat, [t.numel() for t in tensors])
            with torch.no_grad():
                torch._foreach_copy_(
                    tensors, [p.view_as(t) for t, p in zip(tensors, parts)])
        return loss


class _Layout:
    """The ZeRO-3 / FSDP layout of a forward step's parameters
    (``state_shardings``, :func:`~nf_tpu_torch.parallel.tp.
    param_shardings`). Each rank holds its block of every split parameter
    as the optimizer's parameter, so the optimizer's state is held in
    blocks too; the model keeps the whole tensors, which the kernels and
    every reader of ``state.model`` see. Per step: each block is taken
    from the whole parameter (a local copy, so a change to the model
    between steps is kept), the whole gradients come from the forward and
    backward and their average over ``data``, each rank keeps its block of
    them and updates only its blocks, and an all-gather over the split's
    axis writes the updated blocks back into the whole parameters before
    ``post_update``, the EMA and the non-finite guard. The update is
    elementwise, so the result is the replicated step's."""

    def __init__(self, mesh, shardings):
        self.mesh = mesh
        self.shardings = dict(shardings)
        self.model = None
        self.split = []  # (whole parameter, block parameter, dim, axis)
        self.groups = {}

    def attach(self, model, optimizer):
        """On the first step: the block parameters, put in the
        optimizer's place of the whole ones (state the optimizer holds
        for a whole one moves to its block)."""
        if self.model is model:
            return
        if self.model is not None:
            raise ValueError("this step's layout belongs to another model")
        named = dict(model.named_parameters())
        unknown = sorted(set(self.shardings) - set(named))
        if unknown:
            raise ValueError(f"state_shardings names no parameter of the "
                             f"model: {unknown[:5]}")
        swap = {}
        for name, sh in self.shardings.items():
            if sh.mesh is not self.mesh:
                raise ValueError(f"{name}: state_shardings' mesh is not "
                                 f"the step's")
            axes = [(d, a) for d, a in enumerate(sh.spec) if a is not None]
            if not axes:
                continue
            if len(axes) > 1:
                raise NotImplementedError(
                    f"{name}: a spec splitting {len(axes)} dims; a layout "
                    f"splits one dim over one axis")
            whole = named[name]
            block = torch.nn.Parameter(sh.block(whole.detach()).clone(),
                                       requires_grad=whole.requires_grad)
            dim, axis = axes[0]
            if self.mesh.shape[axis] == 1:
                continue  # one block: the whole parameter
            self.split.append((whole, block, dim, axis))
            swap[whole] = block
            self.groups.setdefault(axis, self.mesh.group(axis))
        for group in optimizer.param_groups:
            group["params"] = [swap.get(p, p) for p in group["params"]]
        for whole, block in swap.items():
            state = optimizer.state.pop(whole, None)
            if state:
                optimizer.state[block] = {
                    k: (self._block_of(v, whole, block)
                        if torch.is_tensor(v) else v)
                    for k, v in state.items()}
        self.model = model

    def _block_of(self, v, whole, block):
        if v.shape != whole.shape:
            return v
        for w, b, dim, axis in self.split:
            if b is block:
                n = b.shape[dim]
                return v.narrow(dim, self.mesh.axis_index(axis) * n,
                                n).clone()
        return v

    @property
    def wholes(self):
        return [w for w, _, _, _ in self.split]

    def take_blocks(self):
        """Each block from its whole parameter; the whole ones' gradients
        cleared (the optimizer's ``zero_grad`` sees only the blocks)."""
        with torch.no_grad():
            for whole, block, dim, axis in self.split:
                n = block.shape[dim]
                block.copy_(whole.narrow(dim, self.mesh.axis_index(axis) * n,
                                         n))
                whole.grad = None

    def take_grads(self):
        """Each block's gradient: its block of the averaged whole one."""
        for whole, block, dim, axis in self.split:
            if whole.grad is None:
                block.grad = None
                continue
            n = block.shape[dim]
            block.grad = whole.grad.narrow(
                dim, self.mesh.axis_index(axis) * n, n).clone()

    def gather(self):
        """The updated blocks into the whole parameters: one all-gather
        per (axis, dtype) of the flattened blocks over the axis's
        subgroup."""
        by = {}
        for entry in self.split:
            by.setdefault((entry[3], entry[1].dtype), []).append(entry)
        for (axis, _), entries in by.items():
            flat = torch.cat([b.detach().reshape(-1)
                              for _, b, _, _ in entries])
            parts = [torch.empty_like(flat)
                     for _ in range(self.mesh.shape[axis])]
            dist.all_gather(parts, flat, group=self.groups[axis])
            with torch.no_grad():
                for r, part in enumerate(parts):
                    blocks = torch.split(part, [b.numel()
                                                for _, b, _, _ in entries])
                    for (whole, b, dim, _), v in zip(entries, blocks):
                        n = b.shape[dim]
                        whole.narrow(dim, r * n, n).copy_(v.view_as(b))


def _microbatch(batch, i):
    if isinstance(batch, (tuple, list)):
        return type(batch)(x[i] for x in batch)
    return batch[i]


def _default_loss(model, batch):
    if isinstance(batch, (tuple, list)):
        return model.forward_kld(*batch)
    return model.forward_kld(batch)


def _default_keyed_loss(model, batch, generator):
    if isinstance(batch, (tuple, list)):
        return model.forward_kld(*batch, generator=generator)
    return model.forward_kld(batch, generator=generator)


class _StepGenerators:
    """A keyed step's own generator per device, reseeded per call; rank r
    of a mesh seeds it with ``seed + r * 0x9E3779B97F4A7C15`` (mod 2^64),
    so the ranks draw apart (JAX's one key covers the global batch)."""

    def __init__(self, rank=0):
        self.rank = rank
        self.by_device = {}

    def get(self, device):
        device = torch.device(device)
        if device not in self.by_device:
            self.by_device[device] = torch.Generator(device=device)
        return self.by_device[device]

    def seeded(self, state, seed):
        if isinstance(seed, bool) or not isinstance(seed, int):
            raise TypeError(f"a keyed step takes an integer seed, got "
                            f"{type(seed).__name__}")
        gen = self.get(next(state.model.parameters()).device)
        gen.manual_seed((seed + self.rank * _GOLDEN) % 2 ** 64)
        return gen


def _step_body(state, optimizer, loss_of, accum_steps, ema_decay,
               skip_nonfinite, post_update=None, reduce=None, layout=None):
    """The update both steps share: ``loss_of(model, i)`` is microbatch
    i's loss; their gradients are averaged over ``accum_steps`` (and by
    ``reduce``, a :class:`_Reducer`, over the ranks, whose forward passes
    see the global batch's statistics) before one optimizer update, then
    ``post_update``, the EMA and the non-finite guard (which also restores
    the float buffers ``post_update`` may have changed). ``layout``, a
    :class:`_Layout`, holds the split parameters in blocks."""
    if state.optimizer is not optimizer:
        raise ValueError("state.optimizer is not the optimizer this step "
                         "was built with")
    if ema_decay is not None and state.ema is None:
        raise ValueError("ema_decay set but the state has no EMA slot: "
                         "build it with init_train_state(..., "
                         "with_ema=True)")
    model = state.model
    if layout is not None:
        layout.attach(model, optimizer)
        layout.take_blocks()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    # the gradients the average and the guard read: the whole parameters'
    # under a layout (the same on every rank of a block's line)
    graded = list(model.parameters()) if layout is not None else params
    if skip_nonfinite:
        _check_guardable(optimizer)
    optimizer.zero_grad(set_to_none=True)
    forward = reduce.forward if reduce is not None else contextlib.nullcontext
    if accum_steps > 1:
        loss = None
        for i in range(accum_steps):
            with forward():
                part = loss_of(model, i)
            part.backward()
            part = part.detach()
            loss = part if loss is None else loss + part
        inv = 1.0 / accum_steps
        loss = loss * inv
        with torch.no_grad():
            for p in graded:
                if p.grad is not None:
                    p.grad.mul_(inv)
    else:
        with forward():
            loss = loss_of(model, 0)
        loss.backward()
        loss = loss.detach()
    if reduce is not None:
        loss = reduce(loss, [p.grad for p in graded if p.grad is not None])
    if layout is not None:
        layout.take_grads()

    ema = list(state.ema.parameters()) if ema_decay is not None else []
    buffers = ([b for b in model.buffers() if b.is_floating_point()]
               if post_update is not None else [])
    wholes = layout.wholes if layout is not None else []
    if skip_nonfinite:
        ok = _all_finite(loss, [p.grad for p in graded])
        with torch.no_grad():
            old_params = [p.detach().clone()
                          for p in params + ema + buffers + wholes]
            old_state = {k: v.clone() for k, v in
                         _state_tensors(optimizer, params).items()}
    optimizer.step()
    if layout is not None:
        layout.gather()
    if post_update is not None:
        out = post_update(model)
        if out is not None and out is not model:
            raise ValueError("post_update must change the model in place "
                             "(it returned another object)")
    if ema_decay is not None:
        _ema_update(ema, list(model.parameters()), ema_decay)
    if skip_nonfinite:
        pairs = list(zip(params + ema + buffers + wholes, old_params))
        for k, v in _state_tensors(optimizer, params).items():
            old = old_state.get(k)
            pairs.append((v, old if old is not None
                          else torch.zeros_like(v)))
        _guard_nonfinite(ok, pairs)
    state.step += 1
    return loss


def make_forward_kld_step(optimizer, loss_fn: Optional[Callable] = None,
                          accum_steps: int = 1,
                          ema_decay: Optional[float] = None,
                          skip_nonfinite: bool = False, post_update=None,
                          with_key: bool = False, mesh=None,
                          donate: bool = False, state_shardings=None):
    """Build ``step(state, batch) -> loss`` (``train.py:176``).

    ``loss_fn(model, batch) -> scalar`` defaults to
    ``model.forward_kld(x)``, with ``batch`` a tensor ``x`` or a tuple
    ``(x, context)``. ``state.optimizer`` must be ``optimizer``.

    ``with_key=True`` (models with stochastic log-dets: residual flows):
    the step is ``step(state, batch, seed)`` with an integer ``seed``, and
    the loss ``loss_fn(model, batch, generator)`` /
    ``model.forward_kld(x, generator=generator)``, ``generator`` the
    step's own on the model's device, seeded with ``seed`` at the start of
    the step (the JAX package's ``key``; its microbatches fold the key in,
    here they draw from the generator in turn).

    ``post_update(model)``: runs after the optimizer's update, in place
    (e.g. ``lambda m: update_lipschitz(m, 50)``).

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

    ``mesh``: the data-parallel step (``train.py:176``). Each rank passes
    its shard of the global batch (:func:`shard_batch`; under
    ``accum_steps`` the micro dim is sharded), and the loss and the
    gradients are averaged over the ranks before the update (the module's
    notes). A keyed step seeds each rank's generator apart. ``donate`` is
    accepted: the step updates the state in place, which is what JAX's
    donation permits. ``state_shardings``, ``{parameter name:
    NamedSharding}`` on ``mesh`` (:func:`~nf_tpu_torch.parallel.tp.
    param_shardings`): the tensor-parallel and FSDP layouts, each split
    parameter and its optimizer state held in blocks (:class:`_Layout`;
    the first step puts the blocks in the optimizer's ``param_groups``),
    with the result of the replicated step.

    On CUDA the step runs as one CUDA graph per batch shape after two
    eager calls at that shape (the module's notes say what a captured
    step needs).
    """
    del donate
    if loss_fn is None:
        loss_fn = _default_loss if not with_key else _default_keyed_loss
    reduce = _reducer(mesh)
    layout = None
    if state_shardings is not None:
        if mesh is None:
            raise ValueError("state_shardings lay the state out on a mesh: "
                             "pass mesh=")
        layout = _Layout(mesh, state_shardings)
        for axis in {a for sh in state_shardings.values()
                     for a in sh.spec if a is not None}:
            mesh.group(axis)  # every rank creates the subgroups now

    def body(state: TrainState, batch, generator=None):
        def loss_of(model, i):
            mb = _microbatch(batch, i) if accum_steps > 1 else batch
            return (loss_fn(model, mb, generator) if with_key
                    else loss_fn(model, mb))

        return _step_body(state, optimizer, loss_of, accum_steps, ema_decay,
                          skip_nonfinite, post_update, reduce, layout)

    if not with_key:
        return _ForwardStep(optimizer, body)
    generators = _StepGenerators(
        mesh.axis_index("data") if mesh is not None else 0)

    def eager(state: TrainState, batch, seed):
        return body(state, batch, generators.seeded(state, seed))

    return _ForwardStep(optimizer, eager, keyed_body=body,
                        generators=generators)


def make_reverse_kld_step(optimizer, num_samples: int, beta_schedule=None,
                          score_fn: bool = True, accum_steps: int = 1,
                          ema_decay: Optional[float] = None,
                          skip_nonfinite: bool = False, mesh=None,
                          donate: bool = False, post_update=None,
                          axis: str = "data"):
    """Build ``step(state, generator) -> loss`` (``train.py:308``): the
    model draws ``num_samples`` samples from ``generator`` (a
    ``torch.Generator`` on the model's device) and the loss is
    ``model.reverse_kld`` against its target ``model.p``, at ``beta =
    beta_schedule(state.step)`` (default 1), with ``score_fn`` as there.
    ``state.optimizer`` must be ``optimizer``.

    ``accum_steps > 1``: ``accum_steps`` sequential draws of
    ``num_samples / accum_steps`` samples each from the same generator,
    their losses and gradients averaged before one update: the same count
    of samples per step at less activation memory. ``ema_decay`` and
    ``skip_nonfinite`` as in :func:`make_forward_kld_step`.

    ``post_update(model)`` as in :func:`make_forward_kld_step`.

    ``mesh``: the sample-parallel step. Each rank draws ``num_samples /
    (ranks x accum_steps)`` samples per microdraw from a stream of its own
    derived from ``generator`` (:class:`~nf_tpu_torch.parallel.mesh.
    RankStreams`: reproducible for a fixed world size, no two ranks
    alike; ``generator`` advances as if it had drawn them), and the loss
    and the gradients are averaged over ``axis`` before the update.
    ``donate`` is accepted (the step updates the state in place).

    On CUDA the step runs as one CUDA graph after two eager calls; every
    call must pass the generator of the first (the graph draws from it,
    or on a mesh from the rank's generator, registered at the capture).
    """
    del donate
    n_dev = mesh.shape[axis] if mesh is not None else 1
    if num_samples % (n_dev * accum_steps) != 0:
        raise ValueError(f"num_samples {num_samples} must divide over "
                         f"{n_dev} devices x {accum_steps} accum steps")
    micro = num_samples // (n_dev * accum_steps)
    if beta_schedule is None:
        def beta_schedule(step):
            return 1.0
    reduce = _reducer(mesh, axis)
    streams = RankStreams(mesh.axis_index(axis)) if reduce is not None \
        else None

    def body(state: TrainState, generator, beta=None):
        if beta is None:
            beta = _beta_value(beta_schedule(state.step), state.model)
        return _step_body(
            state, optimizer,
            lambda model, i: model.reverse_kld(
                micro, beta=beta, score_fn=score_fn, generator=generator),
            accum_steps, ema_decay, skip_nonfinite, post_update, reduce)

    if streams is None:
        return _ReverseStep(optimizer, body, beta_schedule)

    def eager(state: TrainState, generator, beta=None):
        own = streams.enter(generator)
        try:
            return body(state, own, beta)
        finally:
            streams.leave(generator)

    return _ReverseStep(optimizer, eager, beta_schedule, body=body,
                        streams=streams)


def _beta_value(beta, model):
    """``beta`` (a Python number) rounded to the dtype of ``model``'s
    parameters, as the captured step holds it: a device scalar of that
    dtype (a float32 one would promote a bfloat16 model's loss to
    float32, a cast in its graph), and as the JAX package's weakly typed
    ``beta`` takes its loss's dtype. A float32 model's beta is the float32
    value its loss computes with either way."""
    dtype = next(model.parameters()).dtype
    return float(torch.tensor(beta, dtype=dtype))


def _reducer(mesh, axis="data"):
    """The step's average over the ranks, or None without a process
    group (a mesh of one has nothing to reduce)."""
    if mesh is None or not mesh.collective_over(axis):
        return None
    return _Reducer(mesh, axis)


# --- captured steps -----------------------------------------------------------

def _check_capturable(optimizer):
    """A captured ``optimizer.step()`` must keep the optimizer's state on
    the device: Adam and its kin only with ``capturable=True``."""
    for group in optimizer.param_groups:
        if "capturable" in group and not group["capturable"]:
            raise ValueError(
                f"a captured step keeps the optimizer's state on the "
                f"device, and this {type(optimizer).__name__} keeps its "
                f"step count on the host: build it with capturable=True")


def _hyperparameters(optimizer):
    """Every param_group's settings and parameters, as a captured step
    bakes them in."""
    return [({k: v for k, v in g.items() if k != "params"},
             [id(p) for p in g["params"]]) for g in optimizer.param_groups]


def _optimizer_state(optimizer):
    """``[(id of param, key, tensor)]``: every tensor of the optimizer's
    state, which a captured ``optimizer.step()`` updates at its address."""
    return [(id(p), k, v) for g in optimizer.param_groups
            for p in g["params"]
            for k, v in optimizer.state.get(p, {}).items()
            if torch.is_tensor(v)]


def _same_state(a, b):
    return len(a) == len(b) and all(
        pa == pb and ka == kb and va is vb
        for (pa, ka, va), (pb, kb, vb) in zip(a, b))


def _same(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return a is b
    return type(a) is type(b) and a == b


def _same_hyperparameters(a, b):
    return len(a) == len(b) and all(
        ids_a == ids_b and set(ga) == set(gb)
        and all(_same(ga[k], gb[k]) for k in ga)
        for (ga, ids_a), (gb, ids_b) in zip(a, b))


class _Graph:
    """One captured step: the graph, its static inputs and loss, and what
    it was captured with."""

    def __init__(self, state, generator=None):
        self.model, self.ema = state.model, state.ema
        self.generator = generator
        self.calls = 0  # eager warm-up steps taken
        self.graph = None
        self.inputs = []
        self.batch = None
        self.loss = None
        self.launches = {}
        self.mode = None
        self.hyper = None
        self.opt_state = None  # the state tensors the graph updates
        self.beta = None


class _GraphedStep:
    """A training step that runs on CUDA as one CUDA graph per batch shape
    (the module's notes); on the CPU, and as ``eager``, the uncaptured
    step."""

    def __init__(self, optimizer, eager):
        self.optimizer = optimizer
        self.eager = eager
        self.graphs = {}
        self._last = None

    @property
    def launches(self):
        """``{kernel: launches}`` of one replay of the last captured
        graph, counted at its capture (empty before a capture)."""
        return dict(self._last.launches) if self._last is not None else {}

    # per step kind: the graph's key, a new graph, its inputs and body
    def _key(self, args):
        raise NotImplementedError()

    def _new(self, state, args):
        return _Graph(state)

    def _load(self, entry, state, args, first):
        raise NotImplementedError()

    def _captured(self, entry, state):
        raise NotImplementedError()

    def _before_replay(self, entry, state, args):
        pass

    def _after_replay(self, entry, state, args):
        pass

    def __call__(self, state, *args):
        device = next(state.model.parameters()).device
        if device.type != "cuda":
            return self.eager(state, *args)
        key = self._key(args)
        entry = self.graphs.get(key)
        if entry is None:
            _check_capturable(self.optimizer)
            entry = self.graphs[key] = self._new(state, args)
        self._check(entry, state, args)
        if entry.graph is None and entry.calls < WARMUP_CALLS:
            entry.calls += 1
            return warm_up(lambda: self.eager(state, *args), device, 1)
        if entry.graph is None:
            entry.mode = get_pallas_bwd_kernel()
            entry.hyper = _hyperparameters(self.optimizer)
            self._load(entry, state, args, first=True)
            entry.graph, entry.loss, entry.launches = capture(
                lambda: self._captured(entry, state), device,
                generators=(entry.generator,)
                if entry.generator is not None else ())
            entry.opt_state = _optimizer_state(self.optimizer)
            self._last = entry
        else:
            if get_pallas_bwd_kernel() != entry.mode:
                raise RuntimeError(
                    f"the step was captured with the {entry.mode!r} "
                    f"backward kernel and the mode is now "
                    f"{get_pallas_bwd_kernel()!r}: build a new step for it")
            if not _same_hyperparameters(_hyperparameters(self.optimizer),
                                         entry.hyper):
                raise RuntimeError(
                    "the optimizer's param_groups changed since the step "
                    "was captured (their values are baked into the graph); "
                    "build a new step, or give the optimizer a tensor lr "
                    "and change it in place")
            if not _same_state(_optimizer_state(self.optimizer),
                               entry.opt_state):
                raise RuntimeError(
                    "the optimizer's state tensors were replaced since the "
                    "step was captured (load_state_dict makes new ones, "
                    "and the graph updates the old ones at their "
                    "addresses); build a new step")
            self._load(entry, state, args, first=False)
            state.step += 1
        self._before_replay(entry, state, args)
        entry.graph.replay()
        self._after_replay(entry, state, args)
        return entry.loss.clone()

    def _check(self, entry, state, args):
        if state.model is not entry.model or state.ema is not entry.ema:
            raise ValueError("this step was captured for another state's "
                             "model; build a new step for this state")


def _batch_tensors(batch):
    parts = batch if isinstance(batch, (tuple, list)) else (batch,)
    if not all(isinstance(t, torch.Tensor) for t in parts):
        raise TypeError("a captured step takes a tensor batch or a tuple "
                        "of tensors")
    return parts


class _ForwardStep(_GraphedStep):
    """``step(state, batch)``: a graph per batch shape, whose input the
    batch is copied into; keyed, ``step(state, batch, seed)``, the graph
    registered with the step's generator, reseeded before each replay."""

    def __init__(self, optimizer, eager, keyed_body=None, generators=None):
        super().__init__(optimizer, eager)
        self.keyed_body = keyed_body
        self.generators = generators

    def _key(self, args):
        return tuple((tuple(t.shape), t.dtype, t.device)
                     for t in _batch_tensors(args[0]))

    def _new(self, state, args):
        if self.generators is None:
            return _Graph(state)
        return _Graph(state, generator=self.generators.get(
            next(state.model.parameters()).device))

    def _before_replay(self, entry, state, args):
        if self.generators is not None:
            self.generators.seeded(state, args[1])

    def _load(self, entry, state, args, first):
        parts = _batch_tensors(args[0])
        if first:
            entry.inputs = [t.clone() for t in parts]
            batch = args[0]
            entry.batch = (type(batch)(entry.inputs)
                           if isinstance(batch, (tuple, list))
                           else entry.inputs[0])
        else:
            for dst, src in zip(entry.inputs, parts):
                dst.copy_(src)

    def _captured(self, entry, state):
        if self.keyed_body is not None:
            return self.keyed_body(state, entry.batch, entry.generator)
        return self.eager(state, entry.batch)


class _ReverseStep(_GraphedStep):
    """``step(state, generator)``: one graph, registered with the
    generator of the first call (on a mesh, with the rank's generator
    that ``streams`` derives from it before each replay); ``beta`` a
    device scalar written before each replay. ``body(state, generator,
    beta)`` is the step drawing from ``generator`` itself (the captured
    work)."""

    def __init__(self, optimizer, eager, beta_schedule, body=None,
                 streams=None):
        super().__init__(optimizer, eager)
        self.beta_schedule = beta_schedule
        self.body = body if body is not None else eager
        self.streams = streams

    def _key(self, args):
        return ()

    def _new(self, state, args):
        entry = _Graph(state, generator=args[0] if self.streams is None
                       else self.streams.own(args[0].device))
        entry.caller = args[0]
        return entry

    def _check(self, entry, state, args):
        super()._check(entry, state, args)
        if args[0] is not entry.caller:
            raise ValueError("this step draws from the generator of its "
                             "first call, registered with its graph; pass "
                             "that generator, or build a new step")

    def _load(self, entry, state, args, first):
        if first:
            p = next(state.model.parameters())
            entry.beta = torch.empty((), dtype=p.dtype, device=p.device)
        entry.beta.fill_(self.beta_schedule(state.step))

    def _before_replay(self, entry, state, args):
        if self.streams is not None:
            self.streams.enter(args[0])

    def _after_replay(self, entry, state, args):
        if self.streams is not None:
            self.streams.leave(args[0])

    def _captured(self, entry, state):
        return self.body(state, entry.generator, beta=entry.beta)
