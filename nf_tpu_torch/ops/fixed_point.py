"""Kernel F: the condition of the residual flows' fixed-point loop
(``csrc/fixed_point_cond.cu``), and the library's graph calls that build
the loop as a WHILE conditional node (``_graphs.while_loop``).

The JAX package's fixed points are ``jax.lax.while_loop``s
(``nf_tpu/flows/residual.py:42-58``, ``:71-97``) and have no Pallas
kernel; under a CUDA graph the port runs them as a device-side loop whose
condition this kernel computes and sets. Its plain version is
``flows.residual.fixed_point_go`` (JAX's ``cond``), which the eager loop
and the CPU run.

* :func:`fixed_point_cond` -- one test of the loop: ``count`` (one int32)
  set to 0 (``bump=False``, the test before the first pass) or
  incremented, then ``state[2] = go`` (``state``: three int32, zero before
  the first launch; the kernel leaves the first two at zero), and the
  node's condition ``handle`` set to ``go`` where one is given. A CUDA
  tensor goes through the op ``torch.ops.nf_tpu_torch.fixed_point_cond``,
  whose CUDA implementation launches kernel F and whose CPU one is
  :func:`fixed_point_cond_plain`;
* ``fixed_point_cond.launches``, the launches, counted on the host: a
  CUDA graph counts its two launches per loop once, at its capture,
  though a replay runs the body's once per pass;
* :func:`library`, the loaded library with its entry points typed, and
  :func:`check`, which raises on a CUDA error code with the error's name.
"""

from __future__ import annotations

import ctypes

import torch

# the storage types kernel F takes, by the suffix of their entry point
KERNEL_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}
# JAX's cap on the loop's count (``nf_tpu/flows/residual.py:50``)
MAX_COUNT = 1000

_TYPED = []


def library():
    """The ``ctypes`` handle of ``csrc/fixed_point_cond.cu``'s library
    (built at first use), its entry points typed."""
    from . import _build

    lib = _build.load("fixed_point_cond")
    if not _TYPED:
        ptr, i64, i32, u64 = (ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_ulonglong)
        for suffix in KERNEL_DTYPES.values():
            fn = getattr(lib, "fixed_point_cond_launch" + suffix)
            fn.argtypes = [ptr] * 3 + [i64, ptr, ptr, i32, i32, u64, i32,
                                       ptr]
            fn.restype = i32
        lib.while_handle_create.argtypes = [ptr, ctypes.POINTER(u64)]
        lib.while_node_begin.argtypes = [ptr, u64, ptr, i32]
        lib.while_node_end.argtypes = [ptr]
        for fn in (lib.while_handle_create, lib.while_node_begin,
                   lib.while_node_end):
            fn.restype = i32
        lib.cuda_error_name.argtypes = [i32]
        lib.cuda_error_name.restype = ctypes.c_char_p
        _TYPED.append(True)
    return lib


def check(err, what):
    """Raise unless the CUDA error code ``err`` is 0 (cudaSuccess)."""
    if err != 0:
        name = library().cuda_error_name(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")


def _check_operands(x, x_prev, tol, count, state):
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"kernel F (fixed_point_cond) takes float32 or "
                        f"bfloat16, got {x.dtype}")
    for t in (x_prev, tol):
        if t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"kernel F takes x, x_prev and tol of one "
                             f"dtype and shape: {x.dtype} {tuple(x.shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if count.dtype != torch.int32 or count.numel() != 1:
        raise ValueError("kernel F's count is one int32")
    if state.dtype != torch.int32 or state.numel() != 3:
        raise ValueError("kernel F's state is three int32")
    for t in (x, x_prev, tol, count, state):
        if t.device != x.device:
            raise ValueError("kernel F's operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("kernel F takes contiguous tensors")


def _launch(x, x_prev, tol, count, state, bump, handle):
    lib = library()
    fn = getattr(lib, "fixed_point_cond_launch" + KERNEL_DTYPES[x.dtype])
    err = fn(x.data_ptr(), x_prev.data_ptr(), tol.data_ptr(), x.numel(),
             count.data_ptr(), state.data_ptr(), int(bool(bump)), MAX_COUNT,
             0 if handle is None else int(handle), int(handle is not None),
             torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "fixed_point_cond kernel launch")
    fixed_point_cond.launches += 1


def fixed_point_cond_plain(x, x_prev, tol, count, state, bump):
    """Kernel F's plain version: the count, then ``state[2]`` =
    ``flows.residual.fixed_point_go`` (no condition handle on the CPU)."""
    from ..flows.residual import fixed_point_go

    if bump:
        count.add_(1)
    else:
        count.zero_()
    state[2] = fixed_point_go(x, x_prev, tol, count.reshape(()))


@torch.library.custom_op(
    "nf_tpu_torch::fixed_point_cond", mutates_args=("count", "state"),
    schema="(Tensor x, Tensor x_prev, Tensor tol, Tensor(a!) count, "
           "Tensor(b!) state, bool bump, int? handle) -> ()")
def _fixed_point_cond_op(x, x_prev, tol, count, state, bump, handle):
    fixed_point_cond_plain(x, x_prev, tol, count, state, bump)


@_fixed_point_cond_op.register_kernel("cuda")
def _(x, x_prev, tol, count, state, bump, handle):
    _launch(x, x_prev, tol, count, state, bump, handle)


@_fixed_point_cond_op.register_fake
def _(x, x_prev, tol, count, state, bump, handle):
    return None


def fixed_point_cond(x, x_prev, tol, count, state, bump, handle=None):
    """Kernel F on CUDA tensors (its plain version on CPU tensors): set
    ``count`` to 0, or add one when ``bump``, then write ``go`` into
    ``state[2]`` and, when ``handle`` is given (a WHILE node's condition,
    CUDA only), set the node's condition to it."""
    _check_operands(x, x_prev, tol, count, state)
    if handle is not None and not x.is_cuda:
        raise ValueError("a WHILE node's condition is set on the card only")
    torch.ops.nf_tpu_torch.fixed_point_cond(x, x_prev, tol, count, state,
                                            bool(bump), handle)


fixed_point_cond.launches = 0
