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

Not ported yet, each raising ``NotImplementedError``: ``typed_key`` (a
JAX key flavour; the port takes an integer seed), XLA's
``cost_analysis``, ``flops`` and ``memory_analysis``, and the StableHLO
artifacts ``export_sampler``, ``export_log_prob`` and ``load_exported``
(ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import copy
import itertools
from typing import Optional, Tuple

import torch

from ._graphs import WARMUP_CALLS, capture, warm_up

_NO_TYPED_KEY = ("typed_key selects a JAX key flavour; the port's sampler "
                 "takes an integer seed")
_NO_XLA = ("cost_analysis, flops and memory_analysis are XLA's; the "
           "port's graphs have no counterpart yet (ROADMAP queue 1 item 9)")
_NO_EXPORT = ("export_sampler, export_log_prob and load_exported "
              "(StableHLO artifacts) arrive with ROADMAP queue 1 item 9")


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
        if dev.type == "cuda":
            with torch.no_grad():
                warm_up(self._run, dev, WARMUP_CALLS)
                self.graph, self.outputs, self.launches = capture(
                    self._run, dev, pool,
                    (self.generator,) if seeded else ())

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
        raise NotImplementedError(_NO_XLA)

    def flops(self):
        raise NotImplementedError(_NO_XLA)

    def memory_analysis(self):
        raise NotImplementedError(_NO_XLA)


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
        specs = [_labels(num_samples)]
    else:
        def fn(m, gen, *context):
            return m.sample(num_samples, gen, *context, **kw)
        specs = _context_specs(context_shape, dtype)
    exe = _Executable(_Weights(model), fn, specs, seeded=True)
    return _bound(exe, model)


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
    _exclusive(class_cond, context_shape)
    extra = ([_labels(batch_shape[0])] if class_cond
             else _context_specs(context_shape, dtype))
    exe = _Executable(_Weights(model), _log_prob,
                      [(tuple(batch_shape), dtype)] + extra)
    return _bound(exe, model)


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


def export_sampler(*args, **kwargs):
    raise NotImplementedError(_NO_EXPORT)


def export_log_prob(*args, **kwargs):
    raise NotImplementedError(_NO_EXPORT)


def load_exported(*args, **kwargs):
    raise NotImplementedError(_NO_EXPORT)
