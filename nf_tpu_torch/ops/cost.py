"""Operations and bytes of each kernel's op, from its arguments.

One count serves both the roofline bounds that ``chip_smoke.py`` prints
beside each kernel's time and the cost analysis of a compiled function
(``serving.CompiledFn.cost_analysis``). Each function takes the op's own
arguments (the kernel views of ``splines_kernel``'s notes on the ops) and
returns ``(operations, bytes)``: the arithmetic the kernel does on these
inputs (``splines_kernel.rqs_ops_per_element`` and its kin), and the bytes
it must move, each input read once (a stride-0 broadcast once per stored
element) and each output written once.
"""

from __future__ import annotations

import math

from . import splines_kernel as tk


def stored_bytes(t):
    """Bytes of the distinct elements a view reads: a dim of stride 0
    counts once. None (a float tail bound) reads none."""
    if t is None:
        return 0
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _spline_in(x, w, h, d, tb):
    return stored_bytes(x) + sum(stored_bytes(t) for t in (w, h, d, tb))


def rqs_fwd(x, w, h, d, tb, tb_scalar, inverse, *minima):
    """Kernel A: x and the parameters in, y and ld out. Where every row
    shares the parameters, their softmaxes, knots and softplus are work
    per column (``rqs_shared_ops``), else per element."""
    K, n = w.shape[0], x.numel()
    planes = tk._expand(x, (w, h, d))
    if tk._shares_rows(x, planes, tk._tail(tb, tb_scalar)):
        ops = tk.rqs_shared_ops(K, inverse, x.shape[-1], n)
    else:
        ops = tk.rqs_ops_per_element(K, inverse) * n
    return ops, _spline_in(x, w, h, d, tb) + 2 * x.numel() * x.element_size()


def _per_element_bwd(x, w, h, d, tb, cty, ctl, ops_per_element, inverse):
    K, n = w.shape[0], x.numel()
    nbytes = (_spline_in(x, w, h, d, tb) + stored_bytes(cty)
              + stored_bytes(ctl) + (1 + 3 * K + 1) * n * x.element_size())
    return ops_per_element(K, inverse) * n, nbytes


def rqs_bwd(x, w, h, d, tb, tb_scalar, cty, ctl, inverse, *minima):
    """Kernel C per element: the operands and cotangents in, gx and 3K+1
    parameter planes out."""
    return _per_element_bwd(x, w, h, d, tb, cty, ctl,
                            tk.rqs_bwd_ops_per_element, inverse)


def rqs_bwd_autodiff(x, w, h, d, tb, tb_scalar, cty, ctl, inverse, *minima):
    """Kernel D: kernel C's bytes, the adjoint's operations."""
    return _per_element_bwd(x, w, h, d, tb, cty, ctl,
                            tk.rqs_vjp_ops_per_element, inverse)


def rqs_bwd_shared(x, w, h, d, tb, tb_scalar, cty, ctl, inverse, *minima):
    """Kernel C's shared-parameter path: the operands and cotangents in,
    gx and the parameter sums (one per stored parameter) out, in the
    operands' dtype; its float32 per-block partials are scratch, not
    counted."""
    K, n = w.shape[0], x.numel()
    params = sum(stored_bytes(t) for t in (w, h, d))
    nbytes = (_spline_in(x, w, h, d, tb) + stored_bytes(cty)
              + stored_bytes(ctl) + n * x.element_size() + params)
    return tk.rqs_bwd_shared_ops(K, inverse, x.shape[-1], n), nbytes


def head_rqs_fwd(x_t, h_t, w, b, tb, num_bins, circular, inverse, *minima):
    """Kernel B: the head product (2 m H per column) and the spline per
    element; x_t, h_t, W_eff, b and tb in, y and ld out."""
    (D, B), (m, H) = x_t.shape, w.shape
    ops = 2 * m * H * B + tk.rqs_ops_per_element(num_bins, inverse) * D * B
    nbytes = (sum(stored_bytes(t) for t in (x_t, h_t, w, b, tb))
              + 2 * D * B * x_t.element_size())
    return ops, nbytes


def head_rqs_bwd(x_t, h_t, w, b, tb, num_bins, circular, cty, ctl, inverse,
                 *minima):
    """Kernel E: the recompute, gh and gW products (2 m H each per column),
    gb, the spline backward per element; the operands and cotangents in,
    gx and gh (in x_t's dtype), gW and gb (in the head's) out. Its float32
    gW/gb partials are scratch that no caller reads, and are not counted."""
    (D, B), (m, H) = x_t.shape, w.shape
    ops = (3 * 2 * m * H * B + m * B
           + tk.rqs_bwd_ops_per_element(num_bins, inverse) * D * B)
    nbytes = (sum(stored_bytes(t) for t in (x_t, h_t, w, b, tb, cty, ctl))
              + (D * B + H * B) * x_t.element_size()
              + (m * H + m) * w.element_size())
    return ops, nbytes


def fixed_point_cond(x, x_prev, tol, count, state, bump, handle):
    """Kernel F: a subtraction, a square and a division per element; the
    three planes in, the count read and written, the state's three slots
    written."""
    return 3 * x.numel(), 3 * stored_bytes(x) + 2 * 4 + 3 * 4


# op name -> its count
COSTS = {"rqs_fwd": rqs_fwd, "rqs_bwd": rqs_bwd,
         "rqs_bwd_autodiff": rqs_bwd_autodiff,
         "rqs_bwd_shared": rqs_bwd_shared, "head_rqs_fwd": head_rqs_fwd,
         "head_rqs_bwd": head_rqs_bwd, "fixed_point_cond": fixed_point_cond}
