"""CUDA-graph capture, shared by ``serving`` and the captured training
steps (``parallel.train``).

PyTorch's recipe: eager warm-up calls on a side stream (they build and
load the kernels and create what is made lazily: cuBLAS workspaces, the
optimizer's state), then one call captured into a ``torch.cuda.CUDAGraph``
whose replays run the same launches on the same addresses. Nothing here
catches a failure: a capture that fails raises.
"""

from __future__ import annotations

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
    batch, invalidates a capture running here."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = launch_counts()
    with torch.cuda.device(device), torch.cuda.graph(
            graph, pool=pool, capture_error_mode="thread_local"):
        out = run()
    after = launch_counts()
    return graph, out, {k: after[k] - before[k] for k in after}

