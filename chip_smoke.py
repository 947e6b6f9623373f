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
   backward kernels C and E: 1e-4 abs on per-element gradients, 1e-4
   relative to the largest magnitude on gradients summed over the batch),
   then its time, the plain version's time and its roofline bound at the
   shapes the serving path (A, B) or the training step (C, E) gives it;
4. gate: one coupling's transform half through kernel B and through the
   unfused feed, at B*D from 1024 to 65536 (where the fused-head gate
   belongs);
5. serving: ``build_nsf`` at the repo's default width (dim 2, 8 layers,
   hidden 128, 8 bins, 2 blocks) with seeded random weights answers
   ``log_prob`` and ``sample`` at B = 65536, checked against the same
   model on the CPU, against its own ``log_q``, and by a round trip; the
   launch counts show kernels A and B ran on that path, and C and E not;
6. profile: one ``log_prob`` and one ``sample`` call under
   ``torch.profiler``: device busy and idle share, device time by kernel;
7. training: the same model trained with ``make_forward_kld_step`` and
   Adam on TwoMoons: one step's loss and gradients against the CPU at
   B = 8192 (kernels B and E) and B = 2048 (A and C only), launches per
   step, 100 steps at B = 65536 whose loss falls, the ``skip_nonfinite``
   and ``accum_steps`` checks, ms per step and one step under the
   profiler.

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

    names = ["rqs_fwd", "head_rqs_fwd", "rqs_bwd", "head_rqs_bwd"]
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
    print(f"phase build: {len(names)} kernels in {secs:.1f} s "
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


def timing_kernel_e(dev, flush, peaks):
    """At the training step's shapes: the backward of a dim-2 coupling's
    transform half, x_t (1, B) (a transposed view), h_t (128, B), linear
    tails, cotangents (1, B)."""
    from nf_tpu_torch.ops import spline_head_fused as shf
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED + 9)
    d = 1
    x_t = _normal(rng, (BATCH, d), 1.5, dev).T
    h_t = _normal(rng, (HIDDEN, BATCH), 1.0, dev)
    cty, ctl = (_normal(rng, (d, BATCH), 1.0, dev) for _ in range(2))
    m = (3 * K_BINS - 1) * d
    w = _normal(rng, (m, HIDDEN), 0.3 / np.sqrt(HIDDEN), dev)
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
        nbytes = 4 * (3 * d * BATCH + HIDDEN * BATCH + m * HIDDEN + m + d
                      + d * BATCH + HIDDEN * BATCH + m * HIDDEN + m)
        # the recompute, gh and gW products (2*m*H each per column), gb,
        # and the spline backward per element
        ops = (3 * 2 * m * HIDDEN * BATCH + m * BATCH
               + tk.rqs_bwd_ops_per_element(K_BINS, inverse) * d * BATCH)
        out[inverse] = (ms, plain) + bound(nbytes, ops, peaks)
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
            "rqs_bwd": tk.rqs_bwd, "head_rqs_bwd": shf.fused_head_rqs_bwd}


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
    expect = {8192: (layers, layers, layers, layers),
              2048: (2 * layers, 0, 2 * layers, 0)}
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
    expect[BATCH] = (layers,) * 4
    for batch, want in expect.items():
        got = tuple(per_step[batch].values())
        if got != want:
            raise RuntimeError(f"B={batch}: launches per step (A, B, C, E) "
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
          + f"; launches per step (A, B, C, E): "
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
    for label, parity, timing, tols, source, replaces in (
            ("rqs_fwd", parity_kernel_a, timing_kernel_a, (Y_TOL, LD_TOL),
             "nf_tpu_torch/csrc/rqs_fwd.cu",
             "nf_tpu/ops/splines_pallas.py:209"),
            ("head_rqs_fwd", parity_kernel_b, timing_kernel_b,
             (Y_TOL, LD_TOL), "nf_tpu_torch/csrc/head_rqs_fwd.cu",
             "nf_tpu/ops/spline_head_fused.py:105"),
            ("rqs_bwd", parity_kernel_c, timing_kernel_c, (G_TOL, SUM_TOL),
             "nf_tpu_torch/csrc/rqs_bwd.cu",
             "nf_tpu/ops/splines_pallas.py:399"),
            ("head_rqs_bwd", parity_kernel_e, timing_kernel_e,
             (G_TOL, SUM_TOL), "nf_tpu_torch/csrc/head_rqs_bwd.cu",
             "nf_tpu/ops/spline_head_fused.py:129")):
        e1, e2, cases = parity(dev)
        backward = label.endswith("bwd")
        what = (("per-element gradients abs", "batch sums relative")
                if backward else ("y abs", "ld abs"))
        if not (e1 <= tols[0] and e2 <= tols[1]):
            raise RuntimeError(f"{label} disagrees with its plain version: "
                               f"{what[0]} {e1:.3g} (limit {tols[0]}), "
                               f"{what[1]} {e2:.3g} (limit {tols[1]})")
        t = timing(dev, flush, peaks)
        results[label] = dict(err=e1 if backward else max(e1, e2), t=t,
                              source=source, replaces=replaces)
        (fms, fplain, fbound, fby), (ims, iplain, ibound, iby) = \
            t[False], t[True]
        print(f"phase parity {label}: {cases} cases, max err {what[0]} "
              f"{e1:.3g}, {what[1]} {e2:.3g}; spline forward: kernel_ms "
              f"{fms:.4f} plain_ms {fplain:.4f} bound_ms {fbound:.5f} "
              f"({fby}); spline inverse: kernel_ms {ims:.4f} plain_ms "
              f"{iplain:.4f} bound_ms {ibound:.5f} ({iby}); bound = max(bytes "
              f"/ {peaks[0]:.3g} B/s, operations / {peaks[1]:.3g} flop/s)",
              flush=True)

    serving = phase_serving(dev, flush)
    training = phase_training(dev)
    print(f"launches: serving {serving}; training ({TRAIN_STEPS} steps) "
          f"{training}", flush=True)
    kernels = []
    for label, r in results.items():
        n = serving[label] + training[label]
        ms, plain, bound_ms, bound_by = r["t"][False]
        kernels.append({
            "name": label, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": n,
            "max_abs_err": r["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        if training[label] == 0 or (serving[label] == 0
                                    and not label.endswith("bwd")):
            raise RuntimeError(f"{label} never ran on its path")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
