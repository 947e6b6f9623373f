"""CUDA-graph capture, shared by ``serving`` and the captured training
steps (``parallel.train``), and the device-side loop a capture may hold.

PyTorch's recipe: eager warm-up calls on a side stream (they build and
load the kernels and create what is made lazily: cuBLAS workspaces, the
optimizer's state), then one call captured into a ``torch.cuda.CUDAGraph``
whose replays run the same launches on the same addresses. Nothing here
catches a failure: a capture that fails raises.

:func:`while_loop` is the port's ``jax.lax.while_loop`` inside a capture:
a WHILE conditional node, whose body graph runs while a condition that
kernel F sets on the device holds (``ops.fixed_point``). XLA lowers a
``while_loop`` on a GPU to the same kind of device-side loop.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from .ops import launch_counts

# eager calls on the side stream before a capture: the serving functions'
# warm-up calls, and the first steps of a captured training step at each
# batch shape
WARMUP_CALLS = 2


_SIDE_STREAMS: dict = {}


def _side_stream(device):
    """One side stream per device for every warm-up: the caching allocator
    keeps freed blocks, and cuBLAS a workspace, per stream, so a new
    stream per warm-up would hold memory of its own for good."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


def warm_up(run, device, calls):
    """``calls`` eager calls of ``run()`` on a side stream, the current
    stream waiting for them; returns the last call's result."""
    current = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(current)
    out = None
    with torch.cuda.stream(side):
        for _ in range(calls):
            out = run()
    current.wait_stream(side)
    return out


# the caching allocator's pool of the loop bodies captured within the
# current ``capture``, by device index (None: none made yet)
_BODY_POOLS: dict = {}
# cudaStreamCaptureModeThreadLocal, ``capture``'s mode, which the bodies'
# captures take too
_THREAD_LOCAL = 1


def capture(run, device, pool=None, generators=()):
    """Capture one call of ``run()`` -> ``(graph, its result, launches)``.
    The result's tensors are the graph's static outputs, rewritten by each
    replay; ``launches`` is ``{kernel: launches recorded in the capture}``
    (:func:`nf_tpu_torch.ops.launch_counts`), what each replay launches.
    ``generators`` are CUDA generators the captured work draws from: each
    is registered with the graph, and a replay draws from its seed and
    offset as they stand then (and advances the offset as eager calls
    would). ``pool`` is a memory pool shared with other graphs.

    The capture mode is ``thread_local``: only this thread's calls that
    are unsafe during a capture fail it. Under ``global`` (PyTorch's
    default) a ``cudaMalloc`` or ``cudaHostAlloc`` in another thread, such
    as ``data.prefetch_to_device``'s worker pinning and copying the next
    batch, invalidates a capture running here.

    A :func:`while_loop` in ``run`` captures its body into a pool of its
    own, released with the graph."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    before = launch_counts()
    _BODY_POOLS[index] = None
    try:
        with torch.cuda.device(device), torch.cuda.graph(
                graph, pool=pool, capture_error_mode="thread_local"):
            out = run()
    finally:
        body_pool = _BODY_POOLS.pop(index)
        if body_pool is not None:
            weakref.finalize(graph, torch._C._cuda_releasePool, index,
                             body_pool)
    after = launch_counts()
    return graph, out, {k: after[k] - before[k] for k in after}


def _body_pool(index):
    """The pool of the loop bodies of the current ``capture`` on this
    device, made at its first loop. A body's tensors die within the body,
    and one graph's bodies run one at a time, so they share it."""
    if index not in _BODY_POOLS:
        raise RuntimeError("while_loop runs inside _graphs.capture, which "
                           "releases its bodies' pool with the graph")
    if _BODY_POOLS[index] is None:
        _BODY_POOLS[index] = torch.cuda.graph_pool_handle()
    return _BODY_POOLS[index]


def while_loop(go, body):
    """``jax.lax.while_loop`` inside :func:`capture` (the current stream
    capturing): a WHILE conditional node of the graph being captured.
    ``go(handle, after_pass)`` launches kernel F, which sets the node's
    condition ``handle``: once now, on the capturing stream, with
    ``after_pass`` False (JAX tests before the first pass), then at the end
    of every pass with ``after_pass`` True. ``body()`` is one pass. Each
    replay runs the body while the condition holds, with no host read.

    The body is captured on the device's side stream (the warm-up's, whose
    cuBLAS workspace the warm-up made) into the node's body graph, in the
    capture's ``thread_local`` mode, and allocates from a pool of the
    loop bodies (:func:`_body_pool`), never from the stream's ordinary
    blocks. A body may hold only kernels, copies and memsets: an op that
    records an event or a host callback fails the capture. If the runtime
    or the driver cannot build a conditional node, this raises with the
    CUDA error's name; nothing falls back."""
    from .ops import fixed_point

    stream = torch.cuda.current_stream()
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("while_loop runs inside a CUDA graph capture "
                           "only; eagerly the caller's loop reads the "
                           "condition on the host")
    index = stream.device.index
    lib = fixed_point.library()
    handle = ctypes.c_ulonglong()
    fixed_point.check(lib.while_handle_create(stream.cuda_stream,
                                              ctypes.byref(handle)),
                      "cudaGraphConditionalHandleCreate")
    go(handle.value, False)
    side = _side_stream(stream.device)
    fixed_point.check(lib.while_node_begin(stream.cuda_stream, handle.value,
                                           side.cuda_stream, _THREAD_LOCAL),
                      "adding a WHILE conditional node")
    pool = _body_pool(index)
    try:
        with torch.cuda.stream(side):
            torch._C._cuda_beginAllocateCurrentStreamToPool(index, pool)
            try:
                body()
                go(handle.value, True)
            finally:
                torch._C._cuda_endAllocateToPool(index, pool)
    except BaseException:
        lib.while_node_end(side.cuda_stream)  # the body's error goes on
        raise
    fixed_point.check(lib.while_node_end(side.cuda_stream),
                      "capturing the WHILE node's body")

