"""Serving: ``log_prob`` and ``sample`` at a fixed batch shape, each one
CUDA graph (``nf_tpu/serving.py:40-265``).

In the JAX package each served function is an XLA executable compiled
once for a fixed batch shape, its parameters resident on the device. Here
it is a ``torch.cuda.CUDAGraph`` captured once for a fixed batch shape:
after two eager warm-up calls on a side stream (which build and load the
kernels), one call is captured with static input and output tensors. A
call copies its inputs into the static inputs, replays, and returns
copies of the static outputs, so a result the caller holds is never
overwritten by a later call, as JAX returns fresh arrays. The whole call
is one launch of the graph: no Python runs per layer and nothing waits
for the device.

* :func:`compile_log_prob` -- ``fn(x) -> log_prob`` at a fixed batch
  shape, ``fn(x, context)`` with ``context_shape``, ``fn(x, y)`` with
  ``class_cond`` (integer labels, one per row);
* :func:`compile_sampler` -- ``fn(seed) -> (z, log_q)`` at a fixed
  ``num_samples``, ``fn(seed, context)`` with ``context_shape``,
  ``fn(seed, y)`` with ``class_cond``: the graph draws from a CUDA
  generator of its own, reseeded with ``seed`` before each replay, so a
  seed gives, bitwise, the draws of ``model.sample(num_samples,
  generator=torch.Generator("cuda").manual_seed(seed), ...)`` (a
  class-conditional model sampled without ``class_cond`` draws its labels
  from that generator too); ``temperature`` is baked into the graph, as
  the JAX package bakes it into its executable;
* :func:`compile_log_prob_buckets` -- a power-of-two ladder of
  ``log_prob`` graphs (:class:`BucketedFn`): a request of ``n`` rows (and
  its context or labels) is padded with its last row to the smallest
  bucket that holds it, and exactly ``n`` results come back.

A context or a label vector is an input like ``x``: copied into the
graph's static input before each replay, never baked into the graph.

Each handle (:class:`CompiledFn`) is bound to the weights it was compiled
or rebound with (:meth:`CompiledFn.with_model`): the graphs read a copy of
the model made at compile time, and a handle copies its own weights into
that copy before it replays when another handle replayed since. Training
the original model in place (or setting its ActNorms with
``init_from_data``) changes no handle; ``with_model`` rebinds one to the
new weights without a recapture.

The CPU, which the caller asks for by putting the model there, runs the
eager function on the bound weights (the tests' path). On CUDA a capture
that fails raises; nothing runs eagerly in its place.

Deployment artifacts (``serving.py:267-369``): :func:`export_log_prob`
and :func:`export_sampler` take the arguments of the compile functions
and return ``bytes``, a ``torch.export`` program saved with
``torch.export.save``: the model traced once, every kernel launch one node
of a ``torch.library`` op (``nf_tpu_torch.ops``), the weights embedded
(``freeze_params=True``) or taken as a leading flat list in the order of
:func:`_tensors` (``freeze_params=False``). :func:`load_exported` reloads
one as an :class:`ExportedFn` without the model's code: no builder runs
and no model class is unpickled, only the op library is needed, which
importing this module registers. On CUDA an :class:`ExportedFn` captures
the reloaded program as one CUDA graph per input shape at first use; on
the CPU it runs eagerly. An exported sampler draws from the default
generator of its device, seeded with the call's seed in a forked RNG
state, so a seed gives the draws of the compiled sampler. ``platforms``
names the devices an artifact may run on (``"cuda"``, ``"cpu"``): one
exported on the card runs on the CPU after
``torch.export.passes.move_to_device_pass`` (each op's CPU implementation
is its kernel's plain version), but one exported on the CPU is refused
for the card: its trace came from the CPU, not from the card's path.

:meth:`CompiledFn.cost_analysis` counts one eager call of the bound model:
matrix products and convolutions by
``torch.utils.flop_counter.FlopCounterMode``, each kernel's op by the
formulas of ``ops/cost.py`` (those of ``chip_smoke.py``'s bounds), bytes
as each operation's inputs plus outputs. :meth:`CompiledFn.memory_analysis`
gives the argument, output and graph-pool sizes.

``typed_key`` raises ``NotImplementedError``: it selects a JAX key
flavour, and the port takes an integer seed.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import itertools
import json
from typing import Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from . import ops
from ._device import resolve_device
from ._graphs import WARMUP_CALLS, capture, warm_up
from .ops import cost, spline_head_fused, splines_kernel  # noqa: F401 (ops)

_NO_TYPED_KEY = ("typed_key selects a JAX key flavour; the port's sampler "
                 "takes an integer seed")


def _tensors(model):
    """``{name: tensor}``: every parameter and buffer of ``model``, what a
    graph of it reads."""
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return out


def _structure(model):
    """What a rebinding must keep: the module types in order, and each
    tensor's name, shape, dtype and device."""
    return ([type(m) for m in model.modules()],
            [(n, tuple(t.shape), t.dtype, t.device)
             for n, t in _tensors(model).items()])


class _Weights:
    """The model the executables of one compile read: a copy of the model
    it was compiled from (the graphs captured its tensors' addresses), and
    the weights of the handle that ran last (``holder``)."""

    def __init__(self, model):
        self.model = copy.deepcopy(model)
        self.tensors = _tensors(self.model)
        self.structure = _structure(model)
        devices = {t.device for t in self.tensors.values()}
        if len(devices) != 1:
            raise ValueError(f"the model's tensors lie on {devices}; a "
                             f"compiled function runs on one device")
        self.device = devices.pop()
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no compiled functions on {self.device}")
        self.holder = None

    def bind(self, model):
        """A copy of ``model``'s weights for a new handle; raises
        ``ValueError`` unless ``model`` has this model's structure."""
        mods, tensors = _structure(model)
        if mods != self.structure[0]:
            raise ValueError("with_model: the model's modules differ from "
                             "those the function was compiled for")
        if tensors != self.structure[1]:
            diff = next(((a, b) for a, b in itertools.zip_longest(
                tensors, self.structure[1]) if a != b))
            raise ValueError(f"with_model: tensor {diff[0]} where the "
                             f"function was compiled for {diff[1]}")
        with torch.no_grad():
            return {n: t.detach().clone() for n, t in _tensors(model).items()}

    def load(self, params):
        """Make ``params`` the weights the graphs read (a copy on the
        device, only when another handle ran since)."""
        if self.holder is not params:
            with torch.no_grad():
                for n, t in self.tensors.items():
                    t.copy_(params[n])
            self.holder = params


def _fill(dst, src, exact):
    """``dst <- src``; with ``exact=False`` ``src`` may have fewer rows,
    and its last row fills the rest (``jnp.pad(mode="edge")``)."""
    if not isinstance(src, torch.Tensor):
        raise TypeError(f"expected a tensor, got {type(src).__name__}")
    labels = not (src.is_floating_point() or dst.is_floating_point())
    if src.dtype != dst.dtype and not labels:
        raise TypeError(f"compiled for {dst.dtype} inputs, got {src.dtype}")
    n = src.shape[0] if src.ndim else 0
    if (src.shape[1:] != dst.shape[1:] or not 0 < n <= dst.shape[0]
            or (exact and n != dst.shape[0])):
        raise ValueError(f"compiled for inputs of shape {tuple(dst.shape)}"
                         f", got {tuple(src.shape)}")
    dst[:n].copy_(src)
    if n < dst.shape[0]:
        dst[n:].copy_(src[-1:].expand_as(dst[n:]))
    return dst


def _take(out, rows, fresh):
    """The first ``rows`` rows of each output tensor (all of them for
    None), copied where ``fresh`` (a graph's static outputs)."""
    if isinstance(out, tuple):
        return tuple(_take(o, rows, fresh) for o in out)
    out = out if rows is None else out[:rows]
    return out.clone() if fresh else out


class _Executable:
    """``fn(model, *inputs)`` at fixed input shapes on the model of
    ``weights``: on CUDA one captured graph, on the CPU the eager call.
    ``specs``: ``(shape, dtype)`` of each input (labels: an integer
    dtype, and any integer labels are taken). ``seeded``: the first
    argument is an integer seed for the executable's own generator, and
    ``fn(model, generator, *inputs)`` draws from it."""

    def __init__(self, weights, fn, specs=(), seeded=False, pool=None):
        self.weights = weights
        self.fn = fn
        self.seeded = seeded
        dev = weights.device
        self.generator = torch.Generator(device=dev) if seeded else None
        self.inputs = [torch.zeros(s, dtype=dt, device=dev)
                       for s, dt in specs]
        self.graph = None
        self.launches = {}
        self.pool_bytes = None
        if dev.type == "cuda":
            with torch.no_grad():
                warm_up(self._run, dev, WARMUP_CALLS)
                # the capture empties the allocator's cache first; what it
                # holds after is the graph's pool
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                before = torch.cuda.memory_reserved(dev)
                self.graph, self.outputs, self.launches = capture(
                    self._run, dev, pool,
                    (self.generator,) if seeded else ())
                self.pool_bytes = torch.cuda.memory_reserved(dev) - before

    def _run(self):
        gen = (self.generator,) if self.seeded else ()
        return self.fn(self.weights.model, *gen, *self.inputs)

    def __call__(self, params, *args, exact=True):
        """Run on the weights ``params``. ``args``: the seed if seeded,
        then one tensor per input (``exact=False``: every input with as
        many rows as the first or fewer, padded with its last row, and as
        many rows returned)."""
        inputs = args
        if self.seeded:
            seed, *inputs = args
            if isinstance(seed, bool) or not isinstance(seed, int):
                raise TypeError(f"the sampler takes an integer seed, got "
                                f"{type(seed).__name__}")
        if len(inputs) != len(self.inputs):
            raise TypeError(f"expected {len(self.inputs)} inputs, got "
                            f"{len(inputs)}")
        rows = None if exact else inputs[0].shape[0]
        if rows is not None and any(t.shape[0] != rows for t in inputs):
            raise ValueError(f"every input needs the rows of the first "
                             f"({rows}), got "
                             f"{[tuple(t.shape) for t in inputs]}")
        self.weights.load(params)
        if self.seeded:
            self.generator.manual_seed(seed)
        with torch.no_grad():
            for dst, src in zip(self.inputs, inputs):
                _fill(dst, src, exact)
        if self.graph is None:
            with torch.no_grad():
                return _take(self._run(), rows, fresh=False)
        self.graph.replay()
        return _take(self.outputs, rows, fresh=True)


class CompiledFn:
    """A compiled function and the weights it is bound to
    (``serving.py:40``): ``fn(*args)``. ``launches`` is ``{kernel:
    launches}`` of one replay, counted at its capture (zeros on the
    CPU)."""

    def __init__(self, compiled, params):
        self._compiled = compiled
        self._params = params

    def __call__(self, *args):
        return self._compiled(self._params, *args)

    @property
    def launches(self):
        return dict(self._compiled.launches)

    def with_model(self, model) -> "CompiledFn":
        """A new handle bound to ``model``'s weights, with no recapture;
        this handle goes on answering with its own. Raises ``ValueError``
        if ``model``'s structure (modules, tensor names, shapes, dtypes,
        devices) differs."""
        return CompiledFn(self._compiled,
                          self._compiled.weights.bind(model))

    def cost_analysis(self):
        """``{"flops": ..., "bytes accessed": ...}`` (XLA's key names) of
        one call, counted over one eager call of the bound model on its
        inputs (the module's notes). On the CPU the spline wrappers take
        the kernels' ops for the count (``ops.cpu_through_ops``), so the
        count is the card's."""
        exe = self._compiled
        exe.weights.load(self._params)
        gen = (torch.Generator(device=exe.weights.device).manual_seed(0),) \
            if exe.seeded else ()
        flops, nbytes = _count(lambda: exe.fn(exe.weights.model, *gen,
                                              *exe.inputs))
        return {"flops": float(flops), "bytes accessed": float(nbytes)}

    def flops(self) -> Optional[float]:
        return self.cost_analysis()["flops"]

    def memory_analysis(self):
        """:class:`MemoryStats` of the executable: the static inputs and
        the weights its graph reads (JAX passes the parameters as
        arguments), its outputs, and on CUDA the memory its graph's pool
        took at the capture (``temp_size_in_bytes``; None on the CPU, where
        nothing is captured)."""
        exe = self._compiled
        args = sum(_nbytes(t) for t in exe.inputs) + sum(
            _nbytes(t) for t in exe.weights.tensors.values())
        if exe.graph is not None:
            outputs = exe.outputs
        else:
            exe.weights.load(self._params)
            gen = (torch.Generator().manual_seed(0),) if exe.seeded else ()
            with torch.no_grad():
                outputs = exe.fn(exe.weights.model, *gen, *exe.inputs)
        outs = outputs if isinstance(outputs, tuple) else (outputs,)
        return MemoryStats(argument_size_in_bytes=args,
                           output_size_in_bytes=sum(_nbytes(t)
                                                    for t in outs),
                           temp_size_in_bytes=exe.pool_bytes)


@dataclasses.dataclass(frozen=True)
class MemoryStats:
    """The fields of JAX's ``CompiledMemoryStats`` that have a meaning
    for a captured graph; ``generated_code_size_in_bytes`` has none."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: Optional[int]
    generated_code_size_in_bytes: Optional[int] = None


def _nbytes(t):
    return t.numel() * t.element_size()


class _ByteCounter(TorchDispatchMode):
    """Bytes of every operation dispatched: a kernel's op by its formula
    (``ops.cost``), any other by its tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(func, "is_view", False):
            return out  # a view moves no bytes
        name = func.name().split("::")
        if name[0] == "nf_tpu_torch":
            self.bytes += cost.COSTS[name[1].split(".")[0]](*args)[1]
        else:
            flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
            self.bytes += sum(cost.stored_bytes(t) for t in flat
                              if isinstance(t, torch.Tensor))
        return out


_FORMULAS = []


def _register_formulas():
    """The kernels' operation counts as ``FlopCounterMode`` formulas,
    registered once."""
    if _FORMULAS:
        return
    from torch.utils.flop_counter import register_flop_formula

    for name, fn in cost.COSTS.items():
        def formula(*args, out_val=None, _fn=fn, **kw):
            return _fn(*args)[0]
        register_flop_formula(getattr(torch.ops.nf_tpu_torch, name),
                              get_raw=True)(formula)
    _FORMULAS.append(True)


def _count(run):
    """``(flops, bytes)`` of ``run()`` under no_grad, the CPU path through
    the kernels' ops."""
    from torch.utils.flop_counter import FlopCounterMode

    _register_formulas()
    counter = _ByteCounter()
    with torch.no_grad(), ops.cpu_through_ops(), \
            FlopCounterMode(display=False) as flops, counter:
        run()
    return flops.get_total_flops(), counter.bytes


def _bound(executable, model):
    """The first handle of ``executable``: bound to ``model``'s weights,
    which the executable's copy already holds."""
    params = executable.weights.bind(model)
    executable.weights.holder = params
    return CompiledFn(executable, params)


def _labels(n):
    """The spec of a label vector for ``n`` rows."""
    return ((n,), torch.int64)


def _exclusive(class_cond, context_shape):
    if class_cond and context_shape is not None:
        raise ValueError("class_cond and context_shape are exclusive: "
                         "labels condition the base, a context threads "
                         "through the layers")


def compile_sampler(model, num_samples: int,
                    temperature: Optional[float] = None,
                    context_shape: Optional[Tuple[int, ...]] = None,
                    class_cond: bool = False, dtype=torch.float32,
                    typed_key: bool = False) -> CompiledFn:
    """Compile ``model.sample(num_samples)``: ``fn(seed) -> (z, log_q)``
    (``serving.py:133``), with ``context_shape`` (the whole context's
    shape, ``dtype``) ``fn(seed, context)``, with ``class_cond`` ``fn(seed,
    y)``, ``y`` ``num_samples`` integer labels. ``seed`` (an integer)
    reseeds the graph's own generator before each call, so a seed gives
    the draws of an eager ``model.sample`` with a generator freshly seeded
    with it. ``temperature`` (the image and class-conditional containers
    take it) is baked into the graph. ``temperature`` or ``class_cond``
    with ``context_shape`` raises ``ValueError``, as in the JAX package:
    the conditional containers sample at temperature 1 and take no
    labels."""
    fn, specs = _sampler_fn(num_samples, temperature, context_shape,
                            class_cond, dtype, typed_key)
    exe = _Executable(_Weights(model), fn, specs, seeded=True)
    return _bound(exe, model)


def _sampler_fn(num_samples, temperature, context_shape, class_cond, dtype,
                typed_key):
    """``(fn(model, generator, *inputs), input specs)`` of a sampler,
    shared by :func:`compile_sampler` and :func:`export_sampler`."""
    _exclusive(class_cond, context_shape)
    if temperature is not None and context_shape is not None:
        raise ValueError(
            "temperature is not supported together with context_shape: "
            "conditional containers sample at temperature 1")
    if typed_key:
        raise NotImplementedError(_NO_TYPED_KEY)
    kw = {} if temperature is None else dict(temperature=temperature)
    if class_cond:
        def fn(m, gen, y):
            return m.sample(num_samples, gen, y=y, **kw)
        return fn, [_labels(num_samples)]

    def fn(m, gen, *context):
        return m.sample(num_samples, gen, *context, **kw)
    return fn, _context_specs(context_shape, dtype)


def _log_prob(model, x, *context):
    return model.log_prob(x, *context)


def _context_specs(context_shape, dtype):
    """The static inputs a context adds: none, or its own."""
    return [] if context_shape is None else [(tuple(context_shape), dtype)]


def compile_log_prob(model, batch_shape: Tuple[int, ...],
                     context_shape: Optional[Tuple[int, ...]] = None,
                     class_cond: bool = False,
                     dtype=torch.float32) -> CompiledFn:
    """Compile ``model.log_prob`` at a fixed batch shape: ``fn(x) ->
    log_prob`` (``serving.py:184``), with ``context_shape`` (the whole
    context's shape) ``fn(x, context)``, with ``class_cond`` ``fn(x, y)``
    (integer labels, one per row); ``x`` must have ``batch_shape``, the
    context ``context_shape``, both ``dtype``."""
    exe = _Executable(_Weights(model), _log_prob,
                      _log_prob_specs(batch_shape, context_shape, class_cond,
                                      dtype))
    return _bound(exe, model)


def _log_prob_specs(batch_shape, context_shape, class_cond, dtype):
    """The inputs of ``log_prob`` at a batch shape: ``x``, then the labels
    or the context."""
    _exclusive(class_cond, context_shape)
    return [(tuple(batch_shape), dtype)] + (
        [_labels(batch_shape[0])] if class_cond
        else _context_specs(context_shape, dtype))


class BucketedFn:
    """Ragged requests over a ladder of fixed-batch compiled functions
    (``serving.py:197``): a request of ``n`` rows, ``fn(x, *extras)``, is
    padded with its last row to the smallest bucket ``>= n``, each extra
    array (a context) likewise, and exactly ``n`` results come back; a
    request above the largest bucket raises. The padding is written
    straight into the bucket's static inputs."""

    def __init__(self, fns, buckets):
        self._fns = dict(zip(buckets, fns))
        self._buckets = sorted(buckets)

    @property
    def buckets(self):
        return tuple(self._buckets)

    @property
    def launches(self):
        """``{bucket: {kernel: launches of one replay}}``."""
        return {b: self._fns[b].launches for b in self._buckets}

    def _bucket_for(self, n):
        for b in self._buckets:
            if n <= b:
                return b
        raise ValueError(f"request batch {n} exceeds the largest bucket "
                         f"{self._buckets[-1]}")

    def __call__(self, x, *extras):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            raise TypeError("expected a batch of rows")
        if x.shape[0] == 0:
            raise ValueError("an empty request has no row to pad with")
        fn = self._fns[self._bucket_for(x.shape[0])]
        return fn._compiled(fn._params, x, *extras, exact=False)

    def with_model(self, model):
        """Every bucket rebound to ``model``'s weights at once (the buckets
        share one copy of them), with no recapture."""
        first = self._fns[self._buckets[0]]
        params = first._compiled.weights.bind(model)
        return BucketedFn([CompiledFn(self._fns[b]._compiled, params)
                           for b in self._buckets], self._buckets)


def compile_log_prob_buckets(model, max_batch: int,
                             feature_shape: Tuple[int, ...],
                             buckets: Optional[Tuple[int, ...]] = None,
                             context_shape: Optional[Tuple[int, ...]] = None,
                             class_cond: bool = False,
                             dtype=torch.float32) -> BucketedFn:
    """Compile a power-of-two ladder of ``log_prob`` functions up to
    ``max_batch`` (or the given ``buckets``) and serve any request size by
    pad-to-bucket (``serving.py:240``). ``feature_shape`` is the shape of
    one row of ``x``, ``context_shape`` that of one row of the context a
    conditional model takes; ``class_cond`` adds a label per row. On CUDA
    every bucket's graph reads
    one copy of the weights and draws its scratch memory from one pool,
    captured largest first so that the smaller ones reuse its memory; the
    results a call returns are copies, so no later call overwrites them."""
    _exclusive(class_cond, context_shape)
    if buckets is None:
        b, buckets = 1, []
        while b < max_batch:
            buckets.append(b)
            b *= 2
        buckets = tuple(sorted(set(buckets + [max_batch])))
    weights = _Weights(model)
    pool = (torch.cuda.graph_pool_handle()
            if weights.device.type == "cuda" else None)
    rows = [(tuple(feature_shape), dtype)] + (
        [((), torch.int64)] if class_cond
        else _context_specs(context_shape, dtype))
    exes = {b: _Executable(weights, _log_prob,
                           [((b,) + r, dt) for r, dt in rows], pool=pool)
            for b in sorted(buckets, reverse=True)}
    params = weights.bind(model)
    weights.holder = params
    return BucketedFn([CompiledFn(exes[b], params) for b in buckets],
                      buckets)


# --- artifacts: torch.export programs ---------------------------------------

_META = "nf_tpu_torch.json"
PLATFORMS = ("cuda", "cpu")


class _DefaultDraws(TorchFunctionMode):
    """Drops ``generator`` from every call that passes ``generator``: an
    exported program takes no generator, so the traced draws come from
    the default one, in the order the eager calls draw from ``generator``
    (the base first, then each layer that draws)."""

    def __init__(self, generator):
        super().__init__()
        self.generator = generator

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = {k: v for k, v in (kwargs or {}).items()
                  if v is not self.generator}
        args = tuple(None if a is self.generator else a for a in args)
        return func(*args, **kwargs)


class _Run(torch.nn.Module):
    """``fn(model, [generator,] *inputs)`` as a module's ``forward``, the
    draws of a seeded ``fn`` from the default generator
    (:class:`_DefaultDraws`)."""

    def __init__(self, model, fn, seeded):
        super().__init__()
        self.model = model
        self.fn = fn
        self.generator = (torch.Generator(device=_device_of(model))
                          if seeded else None)

    def forward(self, *args):
        if self.generator is None:
            return self.fn(self.model, *args)
        with _DefaultDraws(self.generator):
            return self.fn(self.model, self.generator, *args)


class _Flat(torch.nn.Module):
    """A :class:`_Run` whose model's tensors come in as a leading list
    (:func:`_tensors`' order) through ``functional_call``; the run is not
    a submodule, so the program embeds none of them."""

    def __init__(self, run):
        super().__init__()
        self.__dict__["run"] = run
        self.names = [f"model.{n}" for n in _tensors(run.model)]

    def forward(self, weights, *args):
        return torch.func.functional_call(
            self.run, dict(zip(self.names, weights)), args, strict=True)


def _device_of(model):
    return next(iter(_tensors(model).values())).device


def _indexed(device):
    """A CUDA device with its index (the current one where it has none)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _platforms(platforms, device):
    """The platforms an artifact exported on ``device`` runs on."""
    if platforms is None:
        return (device.type,)
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError(f"unknown platforms {bad}: the port runs on "
                         f"{PLATFORMS}")
    if "cuda" in platforms and device.type != "cuda":
        raise ValueError(
            "an artifact for the card is exported from a model on the card: "
            "a trace on the CPU holds the CPU's path, not the card's")
    if device.type not in platforms:
        raise ValueError(f"platforms {platforms} leave out the device the "
                         f"model lies on ({device.type})")
    return platforms


def _export(model, fn, specs, seeded, freeze_params, platforms, kind):
    """Trace ``fn(model, [generator,] *inputs)`` at the input ``specs``
    (``(shape, dtype)``) and save it with its metadata -> bytes."""
    device = _device_of(model)
    if device.type not in PLATFORMS:
        raise ValueError(f"no artifacts for a model on {device}")
    platforms = _platforms(platforms, device)
    inputs = tuple(torch.zeros(shape, dtype=dt, device=device)
                   for shape, dt in specs)
    traced = _Run(model, fn, seeded)
    if not freeze_params:
        traced = _Flat(traced)
        inputs = ([t.detach() for t in _tensors(model).values()],) + inputs
    with torch.no_grad():
        program = torch.export.export(traced, inputs, strict=False)
    meta = {"kind": kind, "device": str(_indexed(device)),
            "platforms": platforms,
            "inputs": [[list(t.shape), str(t.dtype)] for t in
                       torch.utils._pytree.tree_leaves(inputs)]}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def export_sampler(model, num_samples: int,
                   temperature: Optional[float] = None,
                   context_shape: Optional[Tuple[int, ...]] = None,
                   class_cond: bool = False, dtype=torch.float32,
                   typed_key: bool = False, freeze_params: bool = True,
                   platforms: Optional[Tuple[str, ...]] = None) -> bytes:
    """Export ``model.sample(num_samples)`` (``serving.py:309``): the
    arguments of :func:`compile_sampler`; the artifact's call is
    ``fn(seed[, context | y])`` (``fn(seed, weights, ...)`` with
    ``freeze_params=False``, the flat list of :func:`_tensors`' values) ->
    ``(z, log_q)``, a seed giving, bitwise, the draws of ``model.sample``
    from a generator freshly seeded with it. The trace draws from the
    default generator (:class:`_DefaultDraws`), so every draw of the
    model, its layers' too, comes through ``generator``."""
    fn, specs = _sampler_fn(num_samples, temperature, context_shape,
                            class_cond, dtype, typed_key)
    return _export(model, fn, specs, True, freeze_params, platforms,
                   "sampler")


def export_log_prob(model, batch_shape: Tuple[int, ...],
                    context_shape: Optional[Tuple[int, ...]] = None,
                    class_cond: bool = False, dtype=torch.float32,
                    freeze_params: bool = True,
                    platforms: Optional[Tuple[str, ...]] = None) -> bytes:
    """Export ``model.log_prob`` at a fixed batch shape
    (``serving.py:323``): the arguments of :func:`compile_log_prob`; the
    artifact's call is ``fn(x[, context | y])``, or ``fn(weights, x,
    ...)`` with ``freeze_params=False``."""
    return _export(model, _log_prob,
                   _log_prob_specs(batch_shape, context_shape, class_cond,
                                   dtype),
                   False, freeze_params, platforms, "log_prob")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one input (JAX's ``in_avals``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


class ExportedFn:
    """A reloaded artifact (``serving.py:335``), callable as the function
    it was exported from: ``fn([seed,] [weights,] *inputs)``.

    On CUDA the first call at an input shape captures the program as one
    CUDA graph (two eager warm-up calls on a side stream, then the
    capture, as the compiled functions do); a call copies its inputs into
    the graph's static inputs, replays and returns copies of the outputs.
    On the CPU the program runs eagerly. ``launches`` is ``{kernel:
    launches}`` of one replay of the last graph captured."""

    def __init__(self, program, meta, device):
        self._program = program
        # the program as a module: its call is the eager run
        self.module = program.module()
        self._meta = meta
        self.device = device
        self._graphs = {}
        self.launches = {}

    @property
    def platforms(self) -> Tuple[str, ...]:
        return tuple(self._meta["platforms"])

    @property
    def in_avals(self):
        """:class:`TensorSpec` of each tensor input, the weights first
        where they are inputs (the seed is not a tensor)."""
        return [TensorSpec(tuple(shape), getattr(torch, dt.split(".")[-1]))
                for shape, dt in self._meta["inputs"]]

    def kernel_nodes(self):
        """``{kernel: op nodes}`` of the program's graph: one node per
        launch of that kernel in a call."""
        out = {}
        for node in self._program.graph.nodes:
            if node.op != "call_function":
                continue
            name = getattr(node.target, "name", lambda: "")().split("::")
            if name[0] == "nf_tpu_torch":
                kernel = ops.KERNEL_OPS[name[1].split(".")[0]]
                out[kernel] = out.get(kernel, 0) + 1
        return out

    def __call__(self, *args):
        seeded = self._meta["kind"] == "sampler"
        if seeded:
            if not args:
                raise TypeError("an exported sampler takes an integer seed")
            seed, *args = args
            if isinstance(seed, bool) or not isinstance(seed, int):
                raise TypeError(f"the sampler takes an integer seed, got "
                                f"{type(seed).__name__}")
        flat = torch.utils._pytree.tree_leaves(args)
        if len(flat) != len(self._meta["inputs"]):
            raise TypeError(f"expected {len(self._meta['inputs'])} tensors "
                            f"(weights first where they are inputs), got "
                            f"{len(flat)}")
        for t, spec in zip(flat, self.in_avals):
            if (not isinstance(t, torch.Tensor)
                    or (tuple(t.shape), t.dtype) != (spec.shape, spec.dtype)):
                raise ValueError(f"exported for inputs {self.in_avals}, got "
                                 f"{[_spec(a) for a in flat]}")
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices), torch.no_grad():
            if seeded:
                self._seed(seed)
            if self.device.type != "cuda":
                return self.module(*args)
            return self._replay(args, flat, seed if seeded else None)

    def _seed(self, seed):
        """Seed the default generator of the device, as a fresh generator
        seeded with ``seed`` starts (offset 0)."""
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                torch.cuda.manual_seed(seed)
        else:
            torch.default_generator.manual_seed(seed)

    def _replay(self, args, flat, seed):
        key = tuple((tuple(t.shape), t.dtype) for t in flat)
        entry = self._graphs.get(key)
        if entry is None:
            static = [t.to(self.device, copy=True) for t in flat]
            spec = torch.utils._pytree.tree_structure(args)

            def run():
                return self.module(
                    *torch.utils._pytree.tree_unflatten(static, spec))

            warm_up(run, self.device, WARMUP_CALLS)
            graph, out, launches = capture(run, self.device)
            entry = self._graphs[key] = (graph, static, out)
            self.launches = launches
        graph, static, out = entry
        for dst, src in zip(static, flat):
            dst.copy_(src)
        if seed is not None:  # the warm-up and the capture drew
            self._seed(seed)
        graph.replay()
        return _take(out, None, fresh=True)


def _spec(t):
    return (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) \
        else type(t).__name__


def load_exported(data, device=None) -> ExportedFn:
    """Reload an artifact of :func:`export_sampler` /
    :func:`export_log_prob` (``bytes`` or a file path;
    ``serving.py:361``) on ``device``: None for the device it was
    exported on; another one must be among its ``platforms``, and the
    program is moved there (``move_to_device_pass``)."""
    if not isinstance(data, (bytes, bytearray)):
        with open(data, "rb") as f:
            data = f.read()
    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(bytes(data)), extra_files=extra)
    meta = json.loads(extra[_META])
    device = _indexed(resolve_device(meta["device"] if device is None
                                     else device))
    if device.type not in meta["platforms"]:
        raise ValueError(f"the artifact was exported for platforms "
                         f"{tuple(meta['platforms'])}, not {device.type}: "
                         f"export it with platforms=(..., "
                         f"{device.type!r})")
    if str(device) != meta["device"]:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return ExportedFn(program, meta, device)
