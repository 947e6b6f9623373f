import contextlib

from .splines import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    rational_quadratic_spline,
    searchsorted,
    unconstrained_rational_quadratic_spline,
    unconstrained_rational_quadratic_spline_kmajor,
)
from .fixed_point import fixed_point_cond
from .splines_kernel import (
    fused_unconstrained_rqs,
    fused_unconstrained_rqs_kmajor,
    set_pallas_bwd_kernel,
)


def _spline_wrappers():
    """``{kernel: wrapper}`` for the five spline kernels, by the name of
    their source in ``csrc/``: kernel A ``rqs_fwd``, B ``head_rqs_fwd``, C
    ``rqs_bwd``, D ``rqs_bwd_autodiff``, E ``head_rqs_bwd``. Each wrapper
    adds one to its ``launches`` where it launches its kernel (C's
    shared-parameter path and E, two launches each, count one)."""
    from .spline_head_fused import fused_head_rqs, fused_head_rqs_bwd
    from .splines_kernel import rqs_bwd, rqs_bwd_autodiff, rqs_fwd

    return {"rqs_fwd": rqs_fwd, "head_rqs_fwd": fused_head_rqs,
            "rqs_bwd": rqs_bwd, "head_rqs_bwd": fused_head_rqs_bwd,
            "rqs_bwd_autodiff": rqs_bwd_autodiff}


def _counted_wrappers():
    """The five spline kernels' wrappers and kernel F's,
    ``fixed_point_cond`` (the residual fixed point's loop condition)."""
    from .fixed_point import fixed_point_cond

    return dict(_spline_wrappers(), fixed_point_cond=fixed_point_cond)


# the ops of the six kernels (``torch.ops.nf_tpu_torch.<name>``), by the
# kernel each launches: A rqs_fwd, B head_rqs_fwd, C rqs_bwd and its
# shared-parameter path rqs_bwd_shared, D rqs_bwd_autodiff, E head_rqs_bwd,
# F fixed_point_cond
KERNEL_OPS = {"rqs_fwd": "rqs_fwd", "head_rqs_fwd": "head_rqs_fwd",
              "rqs_bwd": "rqs_bwd", "rqs_bwd_shared": "rqs_bwd",
              "rqs_bwd_autodiff": "rqs_bwd_autodiff",
              "head_rqs_bwd": "head_rqs_bwd",
              "fixed_point_cond": "fixed_point_cond"}


@contextlib.contextmanager
def cpu_through_ops():
    """Within this context the spline wrappers take the kernels' ops on
    CPU tensors too (where a kernel would take the operands: float32, K
    in ``SUPPORTED_BINS``), whose CPU implementations are the plain
    versions: the values are those of the plain path, and a trace (an
    export, a cost count) sees one op per kernel launch, as on the card.
    Outside it the CPU path calls the plain versions with ordinary
    autograd."""
    from .splines_kernel import _CPU_THROUGH_OPS

    before = _CPU_THROUGH_OPS[0]
    _CPU_THROUGH_OPS[0] = True
    try:
        yield
    finally:
        _CPU_THROUGH_OPS[0] = before


def launch_counts():
    """``{kernel: launches recorded so far}`` for the six CUDA kernels.
    The counts are kept on the host: a CUDA graph records a launch once,
    at its capture, and its replays add nothing; a captured function
    carries the counts of its capture instead (``launches``)."""
    return {k: fn.launches for k, fn in _counted_wrappers().items()}


def bf16_launch_counts():
    """``{kernel: launches of its bfloat16 instantiation so far}`` for the
    five spline kernels, kept as :func:`launch_counts` keeps its counts,
    which include these; and ``rqs_bwd_shared``, those of kernel C's
    bfloat16 launches that took its shared-parameter path (counted in
    ``rqs_bwd``'s too)."""
    from .splines_kernel import rqs_bwd

    out = {k: fn.bf16_launches for k, fn in _spline_wrappers().items()}
    out["rqs_bwd_shared"] = rqs_bwd.shared_bf16_launches
    return out


def reset_launch_counts():
    """Set every kernel's launch count to 0 (kernels B's and E's counts
    at circular tails, and the bfloat16 counts, too)."""
    for fn in _counted_wrappers().values():
        fn.launches = 0
        for extra in ("circular_launches", "bf16_launches",
                      "shared_bf16_launches"):
            if hasattr(fn, extra):
                setattr(fn, extra, 0)


__all__ = [
    "KERNEL_OPS",
    "DEFAULT_MIN_BIN_HEIGHT",
    "DEFAULT_MIN_BIN_WIDTH",
    "DEFAULT_MIN_DERIVATIVE",
    "bf16_launch_counts",
    "cpu_through_ops",
    "fixed_point_cond",
    "fused_unconstrained_rqs",
    "fused_unconstrained_rqs_kmajor",
    "launch_counts",
    "reset_launch_counts",
    "rational_quadratic_spline",
    "searchsorted",
    "set_pallas_bwd_kernel",
    "unconstrained_rational_quadratic_spline",
    "unconstrained_rational_quadratic_spline_kmajor",
]
