"""Tracing and profiling (``nf_tpu/utils/profiling.py``; absent in the
reference).

* :class:`Named`: a flow wrapper whose passes are named ranges in a
  ``torch.profiler`` trace (``record_function``) and, on CUDA, NVTX
  ranges (``<name>`` forward, ``<name>_inv`` inverse).
* :func:`trace`: a ``torch.profiler`` run written as a Chrome trace.
* :func:`throughput`: items per second of a chained function, timed on
  the device with CUDA events.
* :func:`enable_compilation_cache`: where the kernels' builds are kept,
  the port's counterpart of JAX's persistent compilation cache.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..flows.base import Flow
from ..ops import _build


@contextlib.contextmanager
def _range(name, cuda):
    with torch.profiler.record_function(name):
        if cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.nvtx.range_pop()


class Named(Flow):
    """``flow`` with its passes in named profiler ranges; it computes
    exactly what ``flow`` does."""

    def __init__(self, flow, name="flow"):
        super().__init__()
        self.flow = flow
        self.name = name

    def forward(self, z, context=None, generator=None):
        with _range(self.name, z.is_cuda):
            return self.flow.forward(z, context=context, generator=generator)

    def inverse(self, z, context=None, generator=None):
        with _range(f"{self.name}_inv", z.is_cuda):
            return self.flow.inverse(z, context=context, generator=generator)

    def init_data_forward(self, z, context=None, generator=None):
        return self.flow.init_data_forward(z, context=context,
                                           generator=generator)

    def init_data_inverse(self, z, context=None, generator=None):
        return self.flow.init_data_inverse(z, context=context,
                                           generator=generator)


@contextlib.contextmanager
def trace(log_dir):
    """Profile the body (host, and the card where CUDA is available) and
    write ``<log_dir>/trace.json``, a Chrome trace; yields the profiler,
    whose ``key_averages()`` sum the time by operation and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                record_shapes=False) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def throughput(fn, x, iters=20, items_per_call=1):
    """Items per second of ``fn(x) -> y``, ``y`` of ``x``'s shape and
    dtype: ``iters`` calls chained through their outputs after one
    warm-up call. On CUDA the time is the device's, between two CUDA
    events around the chain (the calls only enqueue work); on the CPU it
    is the host clock's."""
    with torch.no_grad():
        out = fn(x)  # warm-up: builds and loads the kernels
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn(out)
            stop.record()
            stop.synchronize()
            seconds = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(out)
            seconds = time.perf_counter() - t0
    return items_per_call * iters / seconds


def enable_compilation_cache(path):
    """Build the port's kernels into ``path`` and load them from there
    (``nf_tpu_torch/_build/`` by default). Each library's file name
    carries a hash of its sources and flags, so a directory that outlives
    the process is a persistent cache: a later process with the same
    sources loads the libraries without running ``nvcc``. Call it before
    the first kernel is loaded."""
    _build.set_build_dir(path)
