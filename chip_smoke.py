#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``nf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root, on a machine with one CUDA GPU and the CUDA
toolkit. Phases, one line each:

1. device: name, compute capability (9.x required), power limit;
2. build: ``nvcc`` builds every kernel from ``nf_tpu_torch/csrc``, one
   process per source, all started together;
3. parity: each kernel against its plain PyTorch version on the same CUDA
   inputs (kernels A and B: 1e-5 abs on outputs, 1e-4 abs on log-dets;
   backward kernels C, D and E: 1e-4 abs on per-element gradients, 1e-4
   relative to the largest magnitude on gradients summed over the batch;
   kernel D also against kernel C, and at x = ±tb against half of C's
   x-gradient), then its time, the plain version's time and its roofline
   bound at the shapes the serving path (A, B) or a training step (C, E:
   ``build_nsf``'s; D: the circular NSF's) gives it; A and C also at the
   circular NSF's shapes, E also at D = 4 and at hidden 512; and, where
   kernel E's gx differs from its plain version's by more than 1e-4, E
   against the plain version summed in the kernel's order and both against
   the plain version in float64 (which of the two moved);
4. gate: one coupling's transform half through kernel B and through the
   unfused feed, at B*D from 1024 to 65536 (where the fused-head gate
   belongs);
5. serving: ``build_nsf`` at the repo's default width (dim 2, 8 layers,
   hidden 128, 8 bins, 2 blocks) with seeded random weights answers
   ``log_prob`` and ``sample`` at B = 65536, checked against the same
   model on the CPU, against its own ``log_q``, and by a round trip; the
   launch counts show kernels A and B ran on that path, and C, D and E
   not;
6. profile: one ``log_prob`` and one ``sample`` call under
   ``torch.profiler``: device busy and idle share, device time by kernel;
7. training: the same model trained with ``make_forward_kld_step`` and
   Adam on TwoMoons: one step's loss and gradients against the CPU at
   B = 8192 (kernels B and E) and B = 2048 (A and C only), launches per
   step, 100 steps at B = 65536 whose loss falls, the ``skip_nonfinite``
   and ``accum_steps`` checks, ms per step and one step under the
   profiler;
8. circular serving: ``build_circular_nsf`` at its defaults (the
   normflows paper example: dim 2, K 12, MADE hidden 512, 10 bins) with
   seeded random weights, ``log_prob`` and ``sample`` at B = 65536 against
   the CPU, against ``log_q`` and by a round trip (the circular
   coordinate modulo 2 pi); kernel A alone, 12 launches per ``log_prob``
   and 24 per ``sample``; ms per call and a profile of each;
9. circular training: the same model trained by ``make_reverse_kld_step``
   on the Gauss-von Mises target with Adam(lr=5e-4) at B = 16384, once
   with kernel C and once with kernel D as the backward: one step card
   against CPU at B = 4096 on the same base draws, launches per step (A
   24, C or D 24), 50 steps (ms per step, the loss), no host sync in a
   step, and a profiled step.

It then prints one JSON line on the kernels, the card's name and power
limit as ``nvidia-smi`` reports them, and, last, ``{"ok": true, "device":
...}``. A failed phase raises and the script exits non-zero; without CUDA
it exits 1 before printing any result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
BATCH = 65536
PARITY_BATCHES = (65536, 65536 + 77)  # the second one is ragged
HIDDEN, K_BINS = 128, 8
Y_TOL, LD_TOL = 1e-5, 1e-4  # kernel vs plain, abs
G_TOL = 1e-4  # backward kernel vs plain, per-element gradients, abs
SUM_TOL = 1e-4  # gradients summed over the batch, relative to the largest
MODEL_TOL = 1e-3  # whole model: card vs CPU, log_prob(sample) vs log_q
ROUND_TRIP_TOL = 1e-3
TRAIN_TOL = 1e-3  # one step's gradients, card vs CPU, relative
TRAIN_STEPS = 100
LOSS_MARGIN = 0.1  # nats the last 10 losses' mean must lie below the first
TIMING_REPS = 30
CIRC_BATCH = 65536  # circular NSF serving
CIRC_TRAIN_BATCH = 16384  # 2^14, the paper example's reverse-KLD batch
CIRC_CHECK_BATCH = 4096  # one step, card against CPU
CIRC_CPU_BATCH = 16384  # log_prob, card against CPU
CIRC_STEPS = 50
TIE_TOL = 1e-5  # kernel D at x = ±tb: half of kernel C's x-gradient

# Published peaks (NVIDIA data sheets): memory bytes/s and float32
# CUDA-core flop/s. The SXM part's are the default.
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12)}
SXM_PEAKS = (3.35e12, 67e12)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return SXM_PEAKS


def device_ms(fn, flush, reps=TIMING_REPS):
    """Median device time of one call, in ms. Before each call the L2 is
    flushed (a 64 MB write) and the stream is held by a spin kernel while
    the host enqueues, so the CUDA events bracket device work only (``fn``
    must not synchronise the host)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, reps=10):
    """Median wall time of one synchronised call, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile_call(fn):
    """One call of ``fn`` under ``torch.profiler``: wall ms, device-busy ms
    (the union of kernel intervals), and device ms and count per kernel
    name, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False))
    busy_us, cur_end = 0.0, None
    by_name = {}
    for start, end, name in spans:
        if cur_end is None or start > cur_end:
            busy_us += end - start
            cur_end = end
        elif end > cur_end:
            busy_us += end - cur_end
            cur_end = end
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return wall_ms, busy_us / 1e3, top


def max_err(a, b):
    return float((a - b).abs().max())


def rel_err(a, b):
    """max |a - b| over max(max |b|, 1), the JAX package's gradient bar."""
    return max_err(a, b) / max(float(b.abs().max()), 1.0)


def phase_device():
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    if cap[0] != 9:
        raise RuntimeError(f"needs a Hopper card (compute capability 9.x), "
                           f"got {cap} on {name}")
    print(f"phase device: {name}, capability {cap[0]}.{cap[1]}, "
          f"nvidia-smi '{smi}', torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, count {torch.cuda.device_count()}",
          flush=True)
    return name


def phase_build():
    from nf_tpu_torch.ops import _build
    from nf_tpu_torch.ops.splines_kernel import SUPPORTED_BINS

    # kernel E as one library per bin count, so its instantiations build
    # in parallel
    names = (["rqs_fwd", "head_rqs_fwd", "rqs_bwd"]
             + [f"head_rqs_bwd@{k}" for k in SUPPORTED_BINS]
             + ["rqs_bwd_autodiff"])
    t0 = time.perf_counter()
    _build.build(names)
    secs = time.perf_counter() - t0
    notes = []
    for n in names:
        log = _build.BUILD_LOGS.get(n, "")
        regs = [int(w.split()[0]) for line in log.splitlines()
                for w in [line.split("Used ")[-1]]
                if "Used " in line and "registers" in line]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        notes.append(f"{n}: max {max(regs) if regs else '?'} registers, "
                     f"{len(spills)} instantiations spilling")
    print(f"phase build: {len(names)} libraries in {secs:.1f} s "
          f"(sm_90a; {'; '.join(notes)})", flush=True)


def _normal(rng, shape, scale, dev):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev)


def parity_kernel_a(dev):
    """Both entries of kernel A: the unconditional CDF's broadcast
    parameters (stride 0 over the batch) and full k-major planes with a
    per-feature tail bound, both directions."""
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED)
    worst_y = worst_ld = 0.0
    cases = 0
    for batch in PARITY_BATCHES:
        for d in (1, 4):
            x = _normal(rng, (batch, d), 2.0, dev)
            uw, uh = (_normal(rng, (1, d, K_BINS), 0.5, dev)
                      for _ in range(2))
            ud = _normal(rng, (1, d, K_BINS + 1), 0.5, dev)
            planes = _normal(rng, (3 * K_BINS + 1, d, batch), 0.5, dev)
            tb = torch.linspace(1.5, 3.0, d, device=dev)[:, None]
            for inverse in (False, True):
                y, ld = tk.fused_unconstrained_rqs(x, uw, uh, ud, 3.0,
                                                   inverse=inverse)
                views = [t.expand(batch, d, t.shape[-1]).movedim(-1, 0)
                         for t in (uw, uh, ud)]
                yp, lp = tk.rqs_plain(x, *views, 3.0, inverse=inverse)
                w, h, dd = (planes[:K_BINS], planes[K_BINS:2 * K_BINS],
                            planes[2 * K_BINS:])
                xt = x.T
                y2, l2 = tk.rqs_fwd(xt, w, h, dd, tb, inverse=inverse)
                y2p, l2p = tk.rqs_plain(xt, w, h, dd, tb, inverse=inverse)
                torch.cuda.synchronize()
                worst_y = max(worst_y, max_err(y, yp), max_err(y2, y2p))
                worst_ld = max(worst_ld, max_err(ld, lp), max_err(l2, l2p))
                cases += 2
    return worst_y, worst_ld, cases


def parity_kernel_b(dev):
    from nf_tpu_torch.ops import spline_head_fused as shf

    rng = np.random.default_rng(SEED + 1)
    worst_y = worst_ld = 0.0
    cases = 0
    for batch in PARITY_BATCHES:
        for d in (1, 4):
            x_t = _normal(rng, (d, batch), 2.0, dev)
            h_t = _normal(rng, (HIDDEN, batch), 1.0, dev)
            tb = torch.linspace(1.5, 3.0, d, device=dev)
            for tails in ("linear", "circular"):
                m = (3 * K_BINS - (1 if tails == "linear" else 0)) * d
                w = _normal(rng, (m, HIDDEN), 0.3 / np.sqrt(HIDDEN), dev)
                b = _normal(rng, (m,), 0.1, dev)
                for inverse in (False, True):
                    kw = dict(num_bins=K_BINS, tails=tails, inverse=inverse)
                    y, ld = shf.fused_head_rqs(x_t, h_t, w, b,
                                               tail_bound=tb, **kw)
                    yp, lp = shf.head_rqs_plain(x_t, h_t, w, b, tb, **kw)
                    torch.cuda.synchronize()
                    worst_y = max(worst_y, max_err(y, yp))
                    worst_ld = max(worst_ld, max_err(ld, lp))
                    cases += 1
    return worst_y, worst_ld, cases


def parity_kernel_c(dev):
    """Kernel C on the layouts of kernel A's parity, with cotangents
    ~ N(0, 1): per-element gradients against ``rqs_bwd_plain``, and the
    CDF's parameter gradients that autograd sums over the batch through
    ``fused_unconstrained_rqs`` against the plain planes' sums."""
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED + 6)
    worst = worst_sum = 0.0
    cases = 0
    for batch in PARITY_BATCHES:
        for d in (1, 4):
            x = _normal(rng, (batch, d), 2.0, dev)
            cty, ctl = (_normal(rng, (batch, d), 1.0, dev) for _ in range(2))
            small = [_normal(rng, (1, d, n), 0.5, dev)
                     for n in (K_BINS, K_BINS, K_BINS + 1)]
            views = [t.expand(batch, d, t.shape[-1]).movedim(-1, 0)
                     for t in small]
            planes = _normal(rng, (3 * K_BINS + 1, d, batch), 0.5, dev)
            w, h, dd = (planes[:K_BINS], planes[K_BINS:2 * K_BINS],
                        planes[2 * K_BINS:])
            tb = torch.linspace(1.5, 3.0, d, device=dev)[:, None]
            for inverse in (False, True):
                got = tk.rqs_bwd(x, *views, 3.0, cty, ctl, inverse=inverse)
                want = tk.rqs_bwd_plain(x, *views, 3.0, cty, ctl,
                                        inverse=inverse)
                got2 = tk.rqs_bwd(x.T, w, h, dd, tb, cty.T, ctl.T,
                                  inverse=inverse)
                want2 = tk.rqs_bwd_plain(x.T, w, h, dd, tb, cty.T, ctl.T,
                                         inverse=inverse)
                leaves = [t.clone().requires_grad_() for t in small]
                y, ld = tk.fused_unconstrained_rqs(x, *leaves, 3.0,
                                                   inverse=inverse)
                torch.autograd.backward((y, ld), (cty, ctl))
                torch.cuda.synchronize()
                worst = max(worst, *(max_err(a, b) for a, b in
                                     zip(got + got2, want + want2)))
                worst_sum = max(worst_sum, *(
                    rel_err(leaf.grad, p.sum(1).T[None])
                    for leaf, p in zip(leaves, want[1:])))
                cases += 2
    return worst, worst_sum, cases


def parity_kernel_e(dev):
    """Kernel E against ``head_rqs_bwd_plain``: gx and gh per element, gW
    and gb (sums over the batch) relative to their largest magnitude."""
    from nf_tpu_torch.ops import spline_head_fused as shf

    rng = np.random.default_rng(SEED + 7)
    worst = worst_sum = 0.0
    cases = 0
    for batch in PARITY_BATCHES:
        for d in (1, 4):
            x_t = _normal(rng, (d, batch), 2.0, dev)
            h_t = _normal(rng, (HIDDEN, batch), 1.0, dev)
            cty, ctl = (_normal(rng, (d, batch), 1.0, dev) for _ in range(2))
            tb = torch.linspace(1.5, 3.0, d, device=dev)
            for tails in ("linear", "circular"):
                m = (3 * K_BINS - (1 if tails == "linear" else 0)) * d
                w = _normal(rng, (m, HIDDEN), 0.3 / np.sqrt(HIDDEN), dev)
                b = _normal(rng, (m,), 0.1, dev)
                for inverse in (False, True):
                    kw = dict(num_bins=K_BINS, tails=tails, inverse=inverse)
                    gx, gh, gw, gb = shf.fused_head_rqs_bwd(
                        x_t, h_t, w, b, tb, cty, ctl, **kw)
                    px, ph, pw, pb = shf.head_rqs_bwd_plain(
                        x_t, h_t, w, b, tb, cty, ctl, **kw)
                    torch.cuda.synchronize()
                    worst = max(worst, max_err(gx, px), max_err(gh, ph))
                    worst_sum = max(worst_sum, rel_err(gw, pw),
                                    rel_err(gb, pb))
                    cases += 1
    return worst, worst_sum, cases


# kernel E's cases where gx against head_rqs_bwd_plain came out above
# G_TOL on the card, drawn as tests/test_torch_cuda.py draws them:
# (K, D, H, B, strided)
E_YARDSTICK_CASES = ([(4, 1, HIDDEN, BATCH, True)]
                     + [(k, 1, 512, 257, False) for k in (4, 8, 10)])


def yardstick_kernel_e(dev):
    """Where kernel E's gx differs from ``head_rqs_bwd_plain``'s, which of
    the two moved: both against the plain version summed in the kernel's
    order (``head_rqs_bwd_plain_in_kernel_order``, which the kernel must
    match within G_TOL and SUM_TOL) and against the plain version in
    float64. One printed line."""
    from nf_tpu_torch.ops import spline_head_fused as shf

    worst = dict(plain=0.0, order=0.0, order_sum=0.0, k64=0.0, p64=0.0)
    cases = over = 0
    for K, d, hidden, batch, strided in E_YARDSTICK_CASES:
        for tails in ("linear", "circular"):
            for inverse in (False, True):
                rng = np.random.default_rng(30 + K)
                x_t, cty = (_normal(rng, (batch, d), s, dev).T if strided
                            else _normal(rng, (d, batch), s, dev)
                            for s in (2.0, 1.0))
                h_t = _normal(rng, (hidden, batch), 1.0, dev)
                m = (2 * K + (K - 1 if tails == "linear" else K)) * d
                w = _normal(rng, (m, hidden), 0.3 / np.sqrt(hidden), dev)
                b = _normal(rng, (m,), 0.1, dev)
                ctl = _normal(rng, (d, batch), 1.0, dev)
                tb = torch.tensor([1.5, 2.0, 2.5, 3.0][:d], device=dev)
                ops = (x_t, h_t, w, b, tb, cty, ctl)
                kw = dict(num_bins=K, tails=tails, inverse=inverse)
                got = shf.fused_head_rqs_bwd(*ops, **kw)
                plain = shf.head_rqs_bwd_plain(*ops, **kw)
                order = shf.head_rqs_bwd_plain_in_kernel_order(*ops, **kw)
                p64 = shf.head_rqs_bwd_plain(*(t.double() for t in ops),
                                             **kw)
                torch.cuda.synchronize()
                over += max_err(got[0], plain[0]) > G_TOL
                worst["plain"] = max(worst["plain"], max_err(got[0], plain[0]))
                worst["order"] = max(worst["order"], max_err(got[0], order[0]),
                                     max_err(got[1], order[1]))
                worst["order_sum"] = max(worst["order_sum"],
                                         rel_err(got[2], order[2]),
                                         rel_err(got[3], order[3]))
                worst["k64"] = max(worst["k64"],
                                   max_err(got[0].double(), p64[0]))
                worst["p64"] = max(worst["p64"],
                                   max_err(plain[0].double(), p64[0]))
                cases += 1
    if not (worst["order"] <= G_TOL and worst["order_sum"] <= SUM_TOL):
        raise RuntimeError(f"head_rqs_bwd disagrees with its plain version "
                           f"summed in its order: {worst['order']:.3g} "
                           f"per element (limit {G_TOL}), "
                           f"{worst['order_sum']:.3g} on batch sums (limit "
                           f"{SUM_TOL})")
    print(f"phase yardstick head_rqs_bwd: {cases} cases (K, D, H, B: "
          f"{E_YARDSTICK_CASES}, both tails and directions), largest gx "
          f"difference: kernel vs plain {worst['plain']:.3g} ({over} cases "
          f"over {G_TOL}); kernel vs plain "
          f"summed in the kernel's order {worst['order']:.3g} (gx and gh; gW "
          f"and gb {worst['order_sum']:.3g} relative); against the plain "
          f"version in float64: kernel {worst['k64']:.3g}, plain "
          f"{worst['p64']:.3g}", flush=True)


# the tail kinds of the circular NSF's feed: the derivative logits before
# padding have K + extra planes; mixed is its own (circular, linear)
D_TAILS = {"linear": ("linear", -1), "circular": ("circular", 0),
           "mixed": (["circular", "linear"], 1)}


def _path_operands(rng, K, tails, dev, batch=CIRC_TRAIN_BATCH):
    """The circular NSF's spline operands: x (2, B), full k-major parameter
    planes with the tail padding of ``tails``, tail bound (2, 1) (pi and
    3, read with stride 0), cotangents (2, B); the first columns of x sit
    exactly at ±tb."""
    from nf_tpu_torch.ops import splines

    tails_arg, extra = D_TAILS[tails]
    x = _normal(rng, (2, batch), 2.0, dev)
    tb = torch.tensor([[np.pi], [3.0]], device=dev)
    x[:, :2] = torch.cat([tb, -tb], dim=1)
    w, h = (_normal(rng, (K, 2, batch), 0.5, dev) for _ in range(2))
    d = splines.pad_derivatives(_normal(rng, (K + extra, 2, batch), 0.5,
                                        dev), tails_arg, 1e-3, axis=0)
    cty, ctl = (_normal(rng, (2, batch), 1.0, dev) for _ in range(2))
    return x, w, h, d, tb, cty, ctl


def parity_kernel_d(dev):
    """Kernel D against ``rqs_vjp_plain`` on two layouts, both directions,
    K 4/8/10: the circular NSF's (full planes, per-feature tail bound,
    linear/circular/mixed tails) and the CDF's of kernel C's parity
    (stride-0 parameters, whose batch sums autograd forms through
    ``fused_unconstrained_rqs`` under the autodiff mode). On the first
    layout also D against kernel C: within G_TOL of the largest magnitude
    away from x = ±tb, and half of C's x-gradient at it (JAX's tie)."""
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED + 11)
    worst = worst_sum = worst_dc = worst_tie = 0.0
    cases = 0
    for K in tk.SUPPORTED_BINS:
        for inverse in (False, True):
            for tails in D_TAILS:
                ops = _path_operands(rng, K, tails, dev)
                got = tk.rqs_bwd_autodiff(*ops, inverse=inverse)
                want = tk.rqs_vjp_plain(*ops, inverse=inverse)
                c = tk.rqs_bwd(*ops, inverse=inverse)
                torch.cuda.synchronize()
                worst = max(worst, *(max_err(a, b)
                                     for a, b in zip(got, want)))
                worst_dc = max(worst_dc, *(rel_err(a[..., 2:], b[..., 2:])
                                           for a, b in zip(got, c)))
                worst_tie = max(worst_tie, max_err(got[0][:, :2],
                                                   0.5 * c[0][:, :2]))
                cases += 1
            batch = PARITY_BATCHES[1]
            x = _normal(rng, (batch, 1), 2.0, dev)
            cty, ctl = (_normal(rng, (batch, 1), 1.0, dev) for _ in range(2))
            small = [_normal(rng, (1, 1, n), 0.5, dev) for n in (K, K, K + 1)]
            views = [t.expand(batch, 1, t.shape[-1]).movedim(-1, 0)
                     for t in small]
            got = tk.rqs_bwd_autodiff(x, *views, 3.0, cty, ctl,
                                      inverse=inverse)
            want = tk.rqs_vjp_plain(x, *views, 3.0, cty, ctl,
                                    inverse=inverse)
            leaves = [t.clone().requires_grad_() for t in small]
            tk.set_pallas_bwd_kernel("autodiff")
            try:
                y, ld = tk.fused_unconstrained_rqs(x, *leaves, 3.0,
                                                   inverse=inverse)
            finally:
                tk.set_pallas_bwd_kernel("analytic")
            torch.autograd.backward((y, ld), (cty, ctl))
            torch.cuda.synchronize()
            worst = max(worst, *(max_err(a, b) for a, b in zip(got, want)))
            worst_sum = max(worst_sum, *(
                rel_err(leaf.grad, p.sum(1).T[None])
                for leaf, p in zip(leaves, want[1:])))
            cases += 1
    if not (worst_dc <= G_TOL and worst_tie <= TIE_TOL):
        raise RuntimeError(f"kernel D against kernel C: {worst_dc:.3g} "
                           f"relative away from ties (limit {G_TOL}), "
                           f"{worst_tie:.3g} from half of C's gx at ±tb "
                           f"(limit {TIE_TOL})")
    print(f"phase parity rqs_bwd_autodiff vs rqs_bwd: {worst_dc:.3g} of "
          f"the largest magnitude away from x = ±tb (limit {G_TOL}); gx "
          f"at ±tb within {worst_tie:.3g} of half of C's (limit "
          f"{TIE_TOL})", flush=True)
    return worst, worst_sum, cases


def _spline_bytes(x, planes, n_out):
    """Bytes a spline kernel must move: x and the stored elements of its
    parameter planes (a stride-0 broadcast is read once) in, ``n_out``
    planes of x's size out."""
    stored = sum(t.untyped_storage().nbytes() for t in planes)
    return 4 * x.numel() * (1 + n_out) + stored


def timing_kernel_d(dev, flush, peaks):
    """At the reverse-KLD step's shapes: the backward of one autoregressive
    layer's spline, x (2, 16384), full (K, 2, B) planes with K = 10 and
    mixed tails, tail bound (2, 1), cotangents (2, B)."""
    from nf_tpu_torch.ops import splines_kernel as tk

    ops = _path_operands(np.random.default_rng(SEED + 12), 10, "mixed", dev)
    x, w, h, d, tb, cty, ctl = ops
    out = {}
    for inverse in (False, True):
        ms = device_ms(lambda: tk.rqs_bwd_autodiff(*ops, inverse=inverse),
                       flush)
        plain = device_ms(lambda: tk.rqs_vjp_plain(*ops, inverse=inverse),
                          flush)
        # x, cty, ctl, the planes and tb read; gx and 3K+1 planes written
        nbytes = (_spline_bytes(x, (w, h, d, tb), 3 * 10 + 2)
                  + 4 * 2 * x.numel())
        ops_n = tk.rqs_vjp_ops_per_element(10, inverse) * x.numel()
        out[inverse] = (ms, plain) + bound(nbytes, ops_n, peaks)
    return out


def timing_path_a_c(dev, flush, peaks):
    """Kernels A and C at the circular NSF's shapes (those of
    :func:`timing_kernel_d`): one printed line, both directions."""
    from nf_tpu_torch.ops import splines_kernel as tk

    x, w, h, d, tb, cty, ctl = _path_operands(
        np.random.default_rng(SEED + 13), 10, "mixed", dev)
    rows = []
    for inverse in (False, True):
        a_ms = device_ms(lambda: tk.rqs_fwd(x, w, h, d, tb,
                                            inverse=inverse), flush)
        a_plain = device_ms(lambda: tk.rqs_plain(x, w, h, d, tb,
                                                 inverse=inverse), flush)
        a_bound = bound(_spline_bytes(x, (w, h, d, tb), 2),
                        tk.rqs_ops_per_element(10, inverse) * x.numel(),
                        peaks)
        c_ms = device_ms(lambda: tk.rqs_bwd(x, w, h, d, tb, cty, ctl,
                                            inverse=inverse), flush)
        c_plain = device_ms(lambda: tk.rqs_bwd_plain(
            x, w, h, d, tb, cty, ctl, inverse=inverse), flush)
        c_bound = bound(_spline_bytes(x, (w, h, d, tb), 3 * 10 + 2)
                        + 4 * 2 * x.numel(),
                        tk.rqs_bwd_ops_per_element(10, inverse) * x.numel(),
                        peaks)
        rows.append(f"{'inverse' if inverse else 'forward'}: A kernel_ms "
                    f"{a_ms:.4f} plain_ms {a_plain:.4f} bound_ms "
                    f"{a_bound[0]:.5f} ({a_bound[1]}); C kernel_ms "
                    f"{c_ms:.4f} plain_ms {c_plain:.4f} bound_ms "
                    f"{c_bound[0]:.5f} ({c_bound[1]})")
    print(f"phase timing circular path shapes (x (2, {CIRC_TRAIN_BATCH}), "
          f"K = 10 full planes, mixed tails, tb (2, 1)): "
          + "; ".join(rows), flush=True)


def timing_kernel_a(dev, flush, peaks):
    """At the serving path's shapes: the CDF of a dim-2 coupling, x (B, 1),
    (1, 1, K) parameters broadcast, scalar tail bound 3."""
    from nf_tpu_torch.ops import splines, splines_kernel as tk

    rng = np.random.default_rng(SEED + 2)
    x = _normal(rng, (BATCH, 1), 1.5, dev)
    uw, uh = (_normal(rng, (1, 1, K_BINS), 0.5, dev) for _ in range(2))
    ud = splines.pad_derivatives(_normal(rng, (1, 1, K_BINS - 1), 0.5, dev),
                                 "linear", 1e-3, axis=-1)
    views = [t.expand(BATCH, 1, t.shape[-1]).movedim(-1, 0)
             for t in (uw, uh, ud)]
    out = {}
    for inverse in (False, True):
        ms = device_ms(lambda: tk.fused_unconstrained_rqs(
            x, uw, uh, ud, 3.0, inverse=inverse), flush)
        plain = device_ms(lambda: tk.rqs_plain(
            x, *views, 3.0, inverse=inverse), flush)
        nbytes = 4 * (3 * BATCH + uw.numel() + uh.numel() + ud.numel())
        ops = tk.rqs_ops_per_element(K_BINS, inverse) * BATCH
        out[inverse] = (ms, plain) + bound(nbytes, ops, peaks)
    return out


def timing_kernel_b(dev, flush, peaks):
    """At the serving path's shapes: the transform half of a dim-2
    coupling, x_t (1, B) (a transposed view), h_t (128, B), linear tails."""
    from nf_tpu_torch.ops import spline_head_fused as shf
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED + 3)
    d = 1
    x_t = _normal(rng, (BATCH, d), 1.5, dev).T
    h_t = _normal(rng, (HIDDEN, BATCH), 1.0, dev)
    m = (3 * K_BINS - 1) * d
    w = _normal(rng, (m, HIDDEN), 0.3 / np.sqrt(HIDDEN), dev)
    b = _normal(rng, (m,), 0.1, dev)
    tb = torch.full((d,), 3.0, device=dev)
    out = {}
    for inverse in (False, True):
        kw = dict(num_bins=K_BINS, tails="linear", inverse=inverse)
        ms = device_ms(lambda: shf.fused_head_rqs(
            x_t, h_t, w, b, tail_bound=3.0, **kw), flush)
        plain = device_ms(lambda: shf.head_rqs_plain(
            x_t, h_t, w, b, tb, **kw), flush)
        nbytes = 4 * (d * BATCH + HIDDEN * BATCH + m * HIDDEN + m + d
                      + 2 * d * BATCH)
        ops = (2 * m * HIDDEN * BATCH
               + tk.rqs_ops_per_element(K_BINS, inverse) * d * BATCH)
        out[inverse] = (ms, plain) + bound(nbytes, ops, peaks)
    return out


def timing_kernel_c(dev, flush, peaks):
    """At the training step's shapes: the backward of a dim-2 coupling's
    CDF, x (B, 1), (1, 1, K) parameters broadcast, tail bound 3,
    cotangents (B, 1)."""
    from nf_tpu_torch.ops import splines, splines_kernel as tk

    rng = np.random.default_rng(SEED + 8)
    x = _normal(rng, (BATCH, 1), 1.5, dev)
    cty, ctl = (_normal(rng, (BATCH, 1), 1.0, dev) for _ in range(2))
    uw, uh = (_normal(rng, (1, 1, K_BINS), 0.5, dev) for _ in range(2))
    ud = splines.pad_derivatives(_normal(rng, (1, 1, K_BINS - 1), 0.5, dev),
                                 "linear", 1e-3, axis=-1)
    views = [t.expand(BATCH, 1, t.shape[-1]).movedim(-1, 0)
             for t in (uw, uh, ud)]
    out = {}
    for inverse in (False, True):
        ms = device_ms(lambda: tk.rqs_bwd(x, *views, 3.0, cty, ctl,
                                          inverse=inverse), flush)
        plain = device_ms(lambda: tk.rqs_bwd_plain(x, *views, 3.0, cty, ctl,
                                                   inverse=inverse), flush)
        # x, cty, ctl and the parameters read; gx and 3K+1 planes written
        nbytes = 4 * (3 * BATCH + uw.numel() + uh.numel() + ud.numel()
                      + (3 * K_BINS + 2) * BATCH)
        ops = tk.rqs_bwd_ops_per_element(K_BINS, inverse) * BATCH
        out[inverse] = (ms, plain) + bound(nbytes, ops, peaks)
    return out


def timing_kernel_e(dev, flush, peaks, d=1, hidden=HIDDEN):
    """At the training step's shapes: the backward of a dim-2 coupling's
    transform half, x_t (1, B) (a transposed view), h_t (128, B), linear
    tails, cotangents (1, B). ``d`` and ``hidden`` give another coupling's
    (dim 2d, or another trunk width)."""
    from nf_tpu_torch.ops import spline_head_fused as shf
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED + 9)
    x_t = _normal(rng, (BATCH, d), 1.5, dev).T
    h_t = _normal(rng, (hidden, BATCH), 1.0, dev)
    cty, ctl = (_normal(rng, (d, BATCH), 1.0, dev) for _ in range(2))
    m = (3 * K_BINS - 1) * d
    w = _normal(rng, (m, hidden), 0.3 / np.sqrt(hidden), dev)
    b = _normal(rng, (m,), 0.1, dev)
    tb = torch.full((d,), 3.0, device=dev)
    out = {}
    for inverse in (False, True):
        kw = dict(num_bins=K_BINS, tails="linear", inverse=inverse)
        ms = device_ms(lambda: shf.fused_head_rqs_bwd(
            x_t, h_t, w, b, tb, cty, ctl, **kw), flush)
        plain = device_ms(lambda: shf.head_rqs_bwd_plain(
            x_t, h_t, w, b, tb, cty, ctl, **kw), flush)
        # read: x_t, cty, ctl, h_t, W_eff, b, tb; written: gx, gh, gW, gb
        nbytes = 4 * (3 * d * BATCH + hidden * BATCH + m * hidden + m + d
                      + d * BATCH + hidden * BATCH + m * hidden + m)
        # the recompute, gh and gW products (2*m*H each per column), gb,
        # and the spline backward per element
        ops = (3 * 2 * m * hidden * BATCH + m * BATCH
               + tk.rqs_bwd_ops_per_element(K_BINS, inverse) * d * BATCH)
        out[inverse] = (ms, plain) + bound(nbytes, ops, peaks)
    return out


# kernel E's other layouts: a dim-8 build_nsf coupling (D = 4; gh, then gW,
# on all warps) and a trunk of width 512 (W_eff staged in 4 tiles)
E_OTHER_SHAPES = ((4, HIDDEN), (1, 512))


def timing_kernel_e_other(dev, flush, peaks):
    """Kernel E at :data:`E_OTHER_SHAPES`, B = 65536, K = 8, linear tails:
    one printed line, both spline directions; returns the times."""
    out = {}
    for d, hidden in E_OTHER_SHAPES:
        out[d, hidden] = timing_kernel_e(dev, flush, peaks, d, hidden)
    print("phase timing head_rqs_bwd other shapes (B = 65536, K = 8, "
          "linear): " + "; ".join(
              f"D = {d}, H = {h}: " + ", ".join(
                  f"{'inverse' if inv else 'forward'} kernel_ms {t[0]:.4f} "
                  f"plain_ms {t[1]:.4f} bound_ms {t[2]:.5f} ({t[3]})"
                  for inv, t in ts.items())
              for (d, h), ts in out.items()), flush=True)
    return out


def bound(nbytes, ops, peaks):
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = ops / peaks[1] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_gate(model, dev, flush):
    """Device time of one coupling's transform half, both ways, at a few
    B*D: kernel B (transposed trunk + fused head) against the unfused feed
    (trunk with its head product in torch.matmul, then kernel A). Places
    the fused-head gate (``feed.FUSED_HEAD_MIN_ELEMENTS``)."""
    from nf_tpu_torch.flows.neural_spline.feed import FusedFeed

    prqct = model.flows[0].prqct
    net = prqct.transform_net
    rng = np.random.default_rng(SEED + 5)
    rows = []
    with torch.inference_mode():
        for batch in (1024, 4096, 16384, 65536):
            x = _normal(rng, (batch, 2), 1.5, dev)
            id_split, t_split = prqct._split(x)
            fused = device_ms(lambda: prqct._coupling_transform(
                t_split, FusedFeed(net.features_transposed(id_split)),
                False), flush)
            unfused = device_ms(lambda: prqct._coupling_transform(
                t_split, net(id_split), False), flush)
            rows.append(f"B*D={batch}: fused {fused:.4f} ms, unfused "
                        f"{unfused:.4f} ms")
    print("phase gate (one coupling's transform half, device ms): "
          + "; ".join(rows), flush=True)


def _counters():
    from nf_tpu_torch.ops import spline_head_fused as shf
    from nf_tpu_torch.ops import splines_kernel as tk

    return {"rqs_fwd": tk.rqs_fwd, "head_rqs_fwd": shf.fused_head_rqs,
            "rqs_bwd": tk.rqs_bwd, "head_rqs_bwd": shf.fused_head_rqs_bwd,
            "rqs_bwd_autodiff": tk.rqs_bwd_autodiff}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def perturb(model, seed):
    """Move every weight off the identity init: linear weights by
    N(0, (0.5/sqrt(fan_in))²), every other float array by N(0, 0.5²)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 0.5 / np.sqrt(p.shape[1]) if (
                p.ndim == 2 and name.endswith("weight")) else 0.5
            noise = rng.standard_normal(tuple(p.shape)) * scale
            p.add_(torch.from_numpy(noise.astype(np.float32)).to(p.device))


def phase_serving(dev, flush):
    import nf_tpu_torch as nt
    from nf_tpu_torch.ops import spline_head_fused as shf
    from nf_tpu_torch.ops import splines_kernel as tk

    layers = 8
    model = nt.build_nsf(dim=2, K=layers, hidden=HIDDEN, num_bins=K_BINS,
                         num_blocks=2, tail_bound=3.0)  # device None: cuda
    perturb(model, SEED)
    phase_gate(model, dev, flush)
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(SEED + 4)
    x = torch.from_numpy((rng.standard_normal((BATCH, 2)) * 1.5)
                         .astype(np.float32))
    x_dev = x.to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    counts = {}

    def counted(label, fn):
        a, b = tk.rqs_fwd.launches, shf.fused_head_rqs.launches
        out = fn()
        counts[label] = (tk.rqs_fwd.launches - a,
                         shf.fused_head_rqs.launches - b)
        return out

    reset_counts()
    with torch.inference_mode():
        lp = counted("log_prob", lambda: model.log_prob(x_dev))
        z, log_q = counted("sample", lambda: model.sample(BATCH,
                                                          generator=gen))
        x_s = counted("forward", lambda: model.forward(z))
        z_back = counted("inverse", lambda: model.inverse(x_s))
        lp_s = counted("log_prob(sample)", lambda: model.log_prob(z))
        torch.cuda.synchronize()
    launches = read_counts()

    for label, (a, b) in counts.items():
        if (a, b) != (layers, layers):
            raise RuntimeError(f"{label}: {a} launches of kernel A and {b} "
                               f"of kernel B, expected {layers} each")
    if launches["rqs_bwd"] or launches["head_rqs_bwd"]:
        raise RuntimeError(f"serving launched a backward kernel: {launches}")
    with torch.inference_mode():
        lp_cpu = cpu_model.log_prob(x)
    errs = {
        "log_prob cuda vs cpu": max_err(lp.cpu(), lp_cpu),
        "log_prob(sample) vs log_q": max_err(lp_s, log_q),
        "inverse(forward(z)) vs z": max_err(z_back, z),
    }
    for t in (lp, z, log_q, x_s):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite values on the serving path")
    if z.shape != (BATCH, 2) or lp.shape != (BATCH,):
        raise RuntimeError(f"shapes: sample {tuple(z.shape)}, log_prob "
                           f"{tuple(lp.shape)}")
    limits = {"log_prob cuda vs cpu": MODEL_TOL,
              "log_prob(sample) vs log_q": MODEL_TOL,
              "inverse(forward(z)) vs z": ROUND_TRIP_TOL}
    for k, v in errs.items():
        if not v <= limits[k]:
            raise RuntimeError(f"{k}: max abs err {v:.3g} > {limits[k]}")
    if max_err(x_s, z) < 0.1:
        raise RuntimeError("the perturbed model is still the identity")

    with torch.inference_mode():
        lp_ms = host_ms(lambda: model.log_prob(x_dev))
        sample_ms = host_ms(lambda: model.sample(BATCH, generator=gen))
    print(f"phase serving: build_nsf(dim=2, K={layers}, hidden={HIDDEN}, "
          f"bins={K_BINS}, blocks=2) B={BATCH}; launches per pass "
          f"{counts}; errors "
          + ", ".join(f"{k} {v:.3g} (limit {limits[k]})"
                      for k, v in errs.items())
          + f"; log_prob {lp_ms:.3f} ms/call "
          f"({BATCH / lp_ms * 1e3:.4g} samples/s), sample "
          f"{sample_ms:.3f} ms/call ({BATCH / sample_ms * 1e3:.4g} "
          f"samples/s)", flush=True)
    with torch.inference_mode():
        for label, fn in (("log_prob", lambda: model.log_prob(x_dev)),
                          ("sample", lambda: model.sample(
                              BATCH, generator=gen))):
            wall, busy, top = profile_call(fn)
            if not top:
                raise RuntimeError("the profiler saw no device time")
            print(f"phase profile {label}: wall {wall:.3f} ms, device busy "
                  f"{busy:.3f} ms ({busy / wall:.1%}), idle "
                  f"{1 - busy / wall:.1%}; top kernels (device ms, count): "
                  + "; ".join(f"{n[:60]} {ms:.3f} x{c}"
                              for n, (ms, c) in top[:8]), flush=True)
    return launches


def _step_result(model, batch):
    """One Adam step of ``make_forward_kld_step`` on a copy of ``model``:
    (loss, {name: gradient}, launches by kernel)."""
    import nf_tpu_torch as nt

    m = copy.deepcopy(model)
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    step = nt.make_forward_kld_step(opt)
    reset_counts()
    loss = step(nt.init_train_state(m, opt), batch)
    launches = read_counts()
    return float(loss), {n: p.grad for n, p in m.named_parameters()}, \
        launches


def phase_training(dev):
    """``build_nsf`` at full width trained with ``make_forward_kld_step``
    and Adam(lr=1e-3) on TwoMoons. Returns the launches of the 100-step
    run (the training path's counts)."""
    import nf_tpu_torch as nt

    layers = 8
    model = nt.build_nsf(dim=2, K=layers, hidden=HIDDEN, num_bins=K_BINS,
                         num_blocks=2, tail_bound=3.0)
    perturb(model, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    target = nt.TwoMoons()
    pool = target.sample(TRAIN_STEPS * BATCH, generator=gen)

    # 1. one step's loss and gradients, card against CPU; 2. launches
    cpu_model = copy.deepcopy(model).to("cpu")
    grad_errs, per_step = {}, {}
    expect = {8192: (layers, layers, layers, layers, 0),
              2048: (2 * layers, 0, 2 * layers, 0, 0)}
    for batch in (8192, 2048):
        x = pool[:batch]
        loss, grads, launches = _step_result(model, x)
        loss_cpu, grads_cpu, _ = _step_result(cpu_model, x.cpu())
        torch.cuda.synchronize()
        worst = max(rel_err(grads[n].cpu(), grads_cpu[n]) for n in grads)
        grad_errs[batch] = (abs(loss - loss_cpu), worst)
        if not (abs(loss - loss_cpu) <= MODEL_TOL and worst <= TRAIN_TOL):
            raise RuntimeError(
                f"B={batch}: card vs CPU loss {loss} vs {loss_cpu}, "
                f"gradients {worst:.3g} relative (limit {TRAIN_TOL})")
        per_step[batch] = launches
    _, _, per_step[BATCH] = _step_result(model, pool[:BATCH])
    expect[BATCH] = (layers,) * 4 + (0,)
    for batch, want in expect.items():
        got = tuple(per_step[batch].values())
        if got != want:
            raise RuntimeError(f"B={batch}: launches per step (A, B, C, E, D) "
                               f"{got}, expected {want}")

    # 4. guards: skip_nonfinite rolls a NaN batch back bitwise; accum
    gm = copy.deepcopy(model)
    opt = torch.optim.Adam(gm.parameters(), lr=1e-3, capturable=True)
    gstate = nt.init_train_state(gm, opt, with_ema=True)
    guarded = nt.make_forward_kld_step(opt, ema_decay=0.99,
                                       skip_nonfinite=True)
    x = pool[:8192]
    guarded(gstate, x)
    before = [t.clone() for t in _train_tensors(gstate)]
    bad = x.clone()
    bad[0, 0] = float("nan")
    out = []
    syncs = host_syncs(lambda: out.append(guarded(gstate, bad)))
    bad_loss = out[0]
    after = _train_tensors(gstate)
    if (np.isfinite(float(bad_loss)) or gstate.step != 2
            or len(after) != len(before)
            or not all(torch.equal(a, b) for a, b in zip(after, before))):
        raise RuntimeError("skip_nonfinite did not leave parameters, Adam "
                           "state and EMA unchanged on a NaN batch")
    full, accum = copy.deepcopy(model), copy.deepcopy(model)
    for m, xb, k in ((full, x, 1), (accum, nt.reshape_for_accum(x, 2), 2)):
        opt = torch.optim.SGD(m.parameters(), lr=0.0)
        nt.make_forward_kld_step(opt, accum_steps=k)(
            nt.init_train_state(m, opt), xb)
    accum_err = max(rel_err(a.grad, b.grad) for a, b in
                    zip(accum.parameters(), full.parameters()))
    if not accum_err <= TRAIN_TOL:
        raise RuntimeError(f"accum_steps=2 gradients differ from the full "
                           f"batch's by {accum_err:.3g} (limit {TRAIN_TOL})")

    # 3. and 5.: it trains; ms per step
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    state = nt.init_train_state(model, opt)
    step = nt.make_forward_kld_step(opt)
    losses, times = [], []
    torch.cuda.synchronize()
    reset_counts()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(state, pool[i * BATCH:(i + 1) * BATCH]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[0]), float(losses[-10:].mean())
    if not np.isfinite(losses).all() or not last <= first - LOSS_MARGIN:
        raise RuntimeError(f"training: losses {losses[:3]} ... "
                           f"{losses[-3:]}, want all finite and the last "
                           f"10's mean {LOSS_MARGIN} below the first")
    ms = float(np.median(times))
    print(f"phase training: build_nsf(dim=2, K={layers}, hidden={HIDDEN}, "
          f"bins={K_BINS}, blocks=2), Adam(lr=1e-3), TwoMoons; card vs CPU "
          f"one step: " + "; ".join(
              f"B={b} loss diff {e[0]:.3g} (limit {MODEL_TOL}), gradients "
              f"{e[1]:.3g} relative (limit {TRAIN_TOL})"
              for b, e in grad_errs.items())
          + f"; launches per step (A, B, C, E, D): "
          + ", ".join(f"B={b} {tuple(c.values())}"
                      for b, c in per_step.items())
          + f"; skip_nonfinite: NaN batch rolled back bitwise ({len(after)} "
          f"tensors), step counter {gstate.step}, host syncs in that step "
          f"{len(syncs)}{' (' + syncs[0][:120] + ')' if syncs else ''}; "
          f"accum_steps=2 "
          f"gradients {accum_err:.3g} relative (limit {TRAIN_TOL}); "
          f"{TRAIN_STEPS} steps at B={BATCH}: loss {first:.4f} -> "
          f"{last:.4f} (mean of last 10; margin {LOSS_MARGIN}), all finite; "
          f"{ms:.3f} ms/step median ({BATCH / ms * 1e3:.4g} samples/s), "
          f"min {min(times):.3f} max {max(times):.3f}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    batch = pool[:BATCH]
    syncs = host_syncs(lambda: step(state, batch))
    wall, busy, top = profile_call(lambda: step(state, batch))
    if not top:
        raise RuntimeError("the profiler saw no device time")
    print(f"phase profile train_step: host syncs in one step {len(syncs)}"
          f"{' (' + syncs[0][:120] + ')' if syncs else ''}; wall "
          f"{wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}; "
          f"top kernels (device ms, count): "
          + "; ".join(f"{n[:60]} {t:.3f} x{c}" for n, (t, c) in top[:10]),
          flush=True)
    return launches


class GaussVonMises:
    """The unnormalized Gauss-von Mises density on the cylinder (phi, z)
    that the paper example fits (``examples/paper_example_nsf.py:22-36``):
    a von Mises in phi (concentration 2) coupled to a Gaussian in z with
    mean 0.8 sin(phi)."""

    def log_prob(self, x):
        phi, z = x[..., 0], x[..., 1]
        return 2.0 * torch.cos(phi) - 0.5 * (z - 0.8 * torch.sin(phi)) ** 2


def _counted(counts, label, fn):
    """Run ``fn`` with every count at 0 before it; keep the counts after."""
    reset_counts()
    out = fn()
    counts[label] = read_counts()
    return out


def _expect(counts, want, what):
    """Fail unless each pass launched exactly the kernels of ``want``
    ({label: {kernel: count}}; every other kernel 0 times)."""
    for label, kernels in want.items():
        got = counts[label]
        expected = {k: kernels.get(k, 0) for k in got}
        if got != expected:
            raise RuntimeError(f"{what} {label}: launches {got}, expected "
                               f"{expected}")


def phase_circular_serving(dev):
    """``build_circular_nsf`` at its defaults (the paper example: dim 2,
    ind_circ (0,), K 12, MADE hidden 512, 10 bins) with seeded random
    weights moved off the identity: ``log_prob`` and ``sample`` at
    B = 65536. Returns the launches of the ``log_prob`` and ``sample``
    passes together."""
    import nf_tpu_torch as nt

    layers = 12
    model = nt.build_circular_nsf(seed=SEED)  # device None: cuda
    perturb(model, SEED + 20)
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(SEED + 21)
    x = np.stack([rng.uniform(-np.pi, np.pi, CIRC_BATCH),
                  rng.standard_normal(CIRC_BATCH) * 1.5], axis=1)
    x = torch.from_numpy(x.astype(np.float32))
    x_dev = x.to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)

    counts = {}
    with torch.inference_mode():
        lp = _counted(counts, "log_prob", lambda: model.log_prob(x_dev))
        z, log_q = _counted(counts, "sample", lambda: model.sample(
            CIRC_BATCH, generator=gen))
        lp_s = model.log_prob(z)
        z_back = model.inverse(x_dev)
        x_back = model.forward(z_back)
        torch.cuda.synchronize()
    _expect(counts, {"log_prob": {"rqs_fwd": layers},
                     "sample": {"rqs_fwd": 2 * layers}}, "circular serving")
    with torch.inference_mode():
        lp_cpu = cpu_model.log_prob(x[:CIRC_CPU_BATCH])
    d = x_back.cpu() - x
    d[:, 0] = torch.remainder(d[:, 0] + np.pi, 2 * np.pi) - np.pi
    errs = {
        f"log_prob cuda vs cpu (first {CIRC_CPU_BATCH})": max_err(
            lp[:CIRC_CPU_BATCH].cpu(), lp_cpu),
        "log_prob(sample) vs log_q": max_err(lp_s, log_q),
        "forward(inverse(x)) vs x (phi mod 2 pi)": float(d.abs().max()),
    }
    for t in (lp, z, log_q, lp_s, x_back):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite values on the circular serving "
                               "path")
    if z.shape != (CIRC_BATCH, 2) or lp.shape != (CIRC_BATCH,):
        raise RuntimeError(f"shapes: sample {tuple(z.shape)}, log_prob "
                           f"{tuple(lp.shape)}")
    if float(z[:, 0].abs().max()) > np.pi:
        raise RuntimeError("samples' circular coordinate left [-pi, pi]")
    for k, v in errs.items():
        if not v <= MODEL_TOL:
            raise RuntimeError(f"circular serving: {k} max abs err {v:.3g} "
                               f"> {MODEL_TOL}")
    if max_err(lp, model.q0.log_prob(x_dev)) < 0.1:
        raise RuntimeError("the perturbed circular model is still the "
                           "identity")
    with torch.inference_mode():
        lp_ms = host_ms(lambda: model.log_prob(x_dev))
        sample_ms = host_ms(lambda: model.sample(CIRC_BATCH, generator=gen))
    print(f"phase circular serving: build_circular_nsf(dim=2, ind_circ=(0,),"
          f" K={layers}, hidden=512, bins=10) B={CIRC_BATCH}; launches per "
          f"pass {counts}; errors "
          + ", ".join(f"{k} {v:.3g} (limit {MODEL_TOL})"
                      for k, v in errs.items())
          + f"; log_prob {lp_ms:.3f} ms/call ({CIRC_BATCH / lp_ms * 1e3:.4g} "
          f"samples/s), sample {sample_ms:.3f} ms/call "
          f"({CIRC_BATCH / sample_ms * 1e3:.4g} samples/s)", flush=True)
    with torch.inference_mode():
        for label, fn in (("log_prob", lambda: model.log_prob(x_dev)),
                          ("sample", lambda: model.sample(
                              CIRC_BATCH, generator=gen))):
            print_profile(f"circular {label}", fn)
    return {k: counts["log_prob"][k] + counts["sample"][k]
            for k in counts["log_prob"]}


def print_profile(label, fn):
    wall, busy, top = profile_call(fn)
    if not top:
        raise RuntimeError("the profiler saw no device time")
    print(f"phase profile {label}: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}; "
          f"top kernels (device ms, count): "
          + "; ".join(f"{n[:60]} {t:.3f} x{c}" for n, (t, c) in top[:10]),
          flush=True)


def _circular_step_result(model, z0, mode):
    """One SGD step of ``make_reverse_kld_step`` on a copy of ``model``
    whose base returns ``z0``: (loss, {name: gradient}, launches)."""
    import nf_tpu_torch as nt
    from nf_tpu_torch.ops import splines_kernel as tk

    m = copy.deepcopy(model)
    m.q0.sample = lambda n, generator=None: z0
    opt = torch.optim.SGD(m.parameters(), lr=0.0)
    step = nt.make_reverse_kld_step(opt, num_samples=z0.shape[0])
    counts = {}
    tk.set_pallas_bwd_kernel(mode)
    try:
        loss = _counted(counts, "step", lambda: step(
            nt.init_train_state(m, opt), None))
    finally:
        tk.set_pallas_bwd_kernel("analytic")
    return float(loss), {n: p.grad for n, p in m.named_parameters()}, \
        counts["step"]


def phase_circular_training(dev):
    """The paper example's training: ``build_circular_nsf`` at its
    defaults, the Gauss-von Mises target, ``make_reverse_kld_step`` with
    Adam(lr=5e-4) at B = 16384, under each backward mode (kernel C, then
    kernel D). Returns {mode: launches of its 50-step run}."""
    import nf_tpu_torch as nt
    from nf_tpu_torch.ops import splines_kernel as tk

    layers = 12
    base = nt.build_circular_nsf(seed=SEED, target=GaussVonMises())
    perturb(base, SEED + 30)
    cpu_base = copy.deepcopy(base).to("cpu")
    rng = np.random.default_rng(SEED + 31)
    z0 = np.stack([rng.uniform(-np.pi, np.pi, CIRC_CHECK_BATCH),
                   rng.standard_normal(CIRC_CHECK_BATCH)], axis=1)
    z0 = torch.from_numpy(z0.astype(np.float32))
    bwd = {"analytic": "rqs_bwd", "autodiff": "rqs_bwd_autodiff"}
    out = {}
    for mode, kernel in bwd.items():
        loss, grads, per_step = _circular_step_result(base, z0.to(dev), mode)
        loss_cpu, grads_cpu, _ = _circular_step_result(cpu_base, z0, mode)
        torch.cuda.synchronize()
        grad_err = max(rel_err(grads[n].cpu(), grads_cpu[n]) for n in grads)
        loss_err = abs(loss - loss_cpu)
        if not (loss_err <= MODEL_TOL and grad_err <= TRAIN_TOL):
            raise RuntimeError(
                f"circular reverse KLD ({mode}), B={CIRC_CHECK_BATCH}: card "
                f"vs CPU loss {loss} vs {loss_cpu}, gradients "
                f"{grad_err:.3g} relative (limit {TRAIN_TOL})")
        _expect({"step": per_step},
                {"step": {"rqs_fwd": 2 * layers, kernel: 2 * layers}},
                f"circular reverse-KLD ({mode})")

        model = copy.deepcopy(base)
        opt = torch.optim.Adam(model.parameters(), lr=5e-4)
        state = nt.init_train_state(model, opt)
        step = nt.make_reverse_kld_step(opt, num_samples=CIRC_TRAIN_BATCH)
        gen = torch.Generator(device=dev).manual_seed(SEED + 32)
        losses, times = [], []
        tk.set_pallas_bwd_kernel(mode)
        try:
            torch.cuda.synchronize()
            reset_counts()
            for _ in range(CIRC_STEPS):
                t0 = time.perf_counter()
                losses.append(step(state, gen))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[mode] = read_counts()
            syncs = host_syncs(lambda: step(state, gen))
            label = f"circular train_step ({mode})"
            print_profile(label, lambda: step(state, gen))
        finally:
            tk.set_pallas_bwd_kernel("analytic")
        losses = torch.stack(losses).cpu().numpy()
        if not np.isfinite(losses).all():
            raise RuntimeError(f"circular training ({mode}): non-finite "
                               f"losses {losses}")
        if syncs:
            raise RuntimeError(f"circular training ({mode}): {len(syncs)} "
                               f"host syncs in one step: {syncs[0][:200]}")
        ms = float(np.median(times))
        print(f"phase circular training ({mode}, backward {kernel}): "
              f"build_circular_nsf defaults, GaussVonMises, Adam(lr=5e-4); "
              f"card vs CPU one step at B={CIRC_CHECK_BATCH}: loss diff "
              f"{loss_err:.3g} (limit {MODEL_TOL}), gradients "
              f"{grad_err:.3g} relative (limit {TRAIN_TOL}); launches per "
              f"step {per_step}; {CIRC_STEPS} steps at B={CIRC_TRAIN_BATCH}: "
              f"loss {float(losses[0]):.4f} -> "
              f"{float(losses[-10:].mean()):.4f} (mean of last 10), all "
              f"finite; {ms:.3f} ms/step median "
              f"({CIRC_TRAIN_BATCH / ms * 1e3:.4g} samples/s), min "
              f"{min(times):.3f} max {max(times):.3f}; host syncs in one "
              f"step {len(syncs)}", flush=True)
    return out


def host_syncs(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: the
    messages of the operations that synchronised the host with the card."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the first call also warns that the mode is a prototype: not a sync
    return [str(w.message) for w in caught
            if "synchroniz" in str(w.message).lower()
            and "prototype" not in str(w.message)]


def _train_tensors(state):
    """Every tensor a step may change: parameters, optimizer state, EMA."""
    out = [p.detach() for p in state.model.parameters()]
    for st in state.optimizer.state.values():
        out += [v for v in st.values() if torch.is_tensor(v)]
    if state.ema is not None:
        out += list(state.ema.parameters())
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import nf_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda")
    name = phase_device()
    phase_build()
    peaks = peaks_for(name)
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device=dev)

    results = {}
    # label, parity, timing, tolerances, source, replaces, the spline
    # direction of its main path (the JSON line's times)
    for label, parity, timing, tols, source, replaces, path_inverse in (
            ("rqs_fwd", parity_kernel_a, timing_kernel_a, (Y_TOL, LD_TOL),
             "nf_tpu_torch/csrc/rqs_fwd.cu",
             "nf_tpu/ops/splines_pallas.py:209", False),
            ("head_rqs_fwd", parity_kernel_b, timing_kernel_b,
             (Y_TOL, LD_TOL), "nf_tpu_torch/csrc/head_rqs_fwd.cu",
             "nf_tpu/ops/spline_head_fused.py:105", False),
            ("rqs_bwd", parity_kernel_c, timing_kernel_c, (G_TOL, SUM_TOL),
             "nf_tpu_torch/csrc/rqs_bwd.cu",
             "nf_tpu/ops/splines_pallas.py:399", False),
            ("head_rqs_bwd", parity_kernel_e, timing_kernel_e,
             (G_TOL, SUM_TOL), "nf_tpu_torch/csrc/head_rqs_bwd.cu",
             "nf_tpu/ops/spline_head_fused.py:129", False),
            ("rqs_bwd_autodiff", parity_kernel_d, timing_kernel_d,
             (G_TOL, SUM_TOL), "nf_tpu_torch/csrc/rqs_bwd_autodiff.cu",
             "nf_tpu/ops/splines_pallas.py:220", True)):
        e1, e2, cases = parity(dev)
        backward = label != "rqs_fwd" and label != "head_rqs_fwd"
        what = (("per-element gradients abs", "batch sums relative")
                if backward else ("y abs", "ld abs"))
        if not (e1 <= tols[0] and e2 <= tols[1]):
            raise RuntimeError(f"{label} disagrees with its plain version: "
                               f"{what[0]} {e1:.3g} (limit {tols[0]}), "
                               f"{what[1]} {e2:.3g} (limit {tols[1]})")
        t = timing(dev, flush, peaks)
        results[label] = dict(err=e1 if backward else max(e1, e2),
                              t=t[path_inverse], source=source,
                              replaces=replaces)
        (fms, fplain, fbound, fby), (ims, iplain, ibound, iby) = \
            t[False], t[True]
        print(f"phase parity {label}: {cases} cases, max err {what[0]} "
              f"{e1:.3g}, {what[1]} {e2:.3g}; spline forward: kernel_ms "
              f"{fms:.4f} plain_ms {fplain:.4f} bound_ms {fbound:.5f} "
              f"({fby}); spline inverse: kernel_ms {ims:.4f} plain_ms "
              f"{iplain:.4f} bound_ms {ibound:.5f} ({iby}); bound = max(bytes "
              f"/ {peaks[0]:.3g} B/s, operations / {peaks[1]:.3g} flop/s)",
              flush=True)
    timing_kernel_e_other(dev, flush, peaks)
    yardstick_kernel_e(dev)
    timing_path_a_c(dev, flush, peaks)

    # each main path, with the kernels it must launch
    paths = {"build_nsf serving": (phase_serving(dev, flush),
                                   ("rqs_fwd", "head_rqs_fwd")),
             "build_nsf training": (phase_training(dev),
                                    ("rqs_fwd", "head_rqs_fwd", "rqs_bwd",
                                     "head_rqs_bwd"))}
    paths["circular serving"] = (phase_circular_serving(dev), ("rqs_fwd",))
    circular = phase_circular_training(dev)
    paths["circular training (analytic)"] = (circular["analytic"],
                                             ("rqs_fwd", "rqs_bwd"))
    paths["circular training (autodiff)"] = (circular["autodiff"],
                                             ("rqs_fwd", "rqs_bwd_autodiff"))
    print("launches: " + "; ".join(f"{k} {v[0]}" for k, v in paths.items()),
          flush=True)
    for path, (counts, needed) in paths.items():
        for label in needed:
            if counts[label] == 0:
                raise RuntimeError(f"{label} never ran on the {path} path")
    kernels = []
    for label, r in results.items():
        ms, plain, bound_ms, bound_by = r["t"]
        kernels.append({
            "name": label, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"],
            "launches": sum(c[label] for c, _ in paths.values()),
            "max_abs_err": r["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
