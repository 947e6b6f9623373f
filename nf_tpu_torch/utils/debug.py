"""Debug-mode numerical guards (``nf_tpu/utils/debug.py``).

The layers keep their own guards (NaN-masking of conditioner outputs,
clamps); these are for debug runs:

* :func:`checked` wraps a function so that a call returns ``(value,
  error)``, the error naming the first non-finite tensor of the output
  (the JAX package compiles ``checkify``'s float checks into the
  function; here the outputs are checked after it ran);
* :func:`debug_nans` switches on autograd's anomaly detection, which
  raises at the backward operation that made a NaN, with the forward
  traceback that created it (the JAX package's ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import functools

import torch


def _tensors(out, path="output"):
    """``(path, tensor)`` of every floating tensor in ``out`` (tensors,
    tuples, lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() or out.is_complex():
            yield path, out
    elif isinstance(out, (tuple, list)):
        for i, o in enumerate(out):
            yield from _tensors(o, f"{path}[{i}]")
    elif isinstance(out, dict):
        for k, o in out.items():
            yield from _tensors(o, f"{path}[{k!r}]")


class CheckError:
    """The outcome of a :func:`checked` call: the device flags of each
    output tensor's finiteness, read only by :meth:`get` and
    :meth:`throw`."""

    def __init__(self, name, flags):
        self.name = name
        self._flags = flags

    def get(self):
        """The message of the first non-finite output, or None (reads the
        device)."""
        for path, finite in self._flags:
            if not bool(finite):
                return f"{self.name}: non-finite values in {path}"
        return None

    def throw(self):
        """Raise ``FloatingPointError`` naming the first non-finite
        output, if there is one."""
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)


def checked(fn):
    """Wrap ``fn`` so that a call returns ``(value, error)``: ``error.
    throw()`` raises if any floating tensor of the value holds a NaN or an
    infinity, and names the first one. The check is a device reduction per
    tensor; only ``throw`` and ``get`` wait for it.

    >>> loss_fn = checked(lambda m, x: m.forward_kld(x))
    >>> value, err = loss_fn(model, batch)
    >>> err.throw()
    """
    name = getattr(fn, "__name__", "function")

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        flags = [(path, torch.all(torch.isfinite(t.detach())))
                 for path, t in _tensors(out)]
        return out, CheckError(name, flags)

    return wrapper


@contextlib.contextmanager
def debug_nans(enable=True):
    """Within the context autograd's anomaly detection is ``enable``; the
    previous setting comes back on exit."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)
