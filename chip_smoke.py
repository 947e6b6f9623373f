#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``nf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root, on a machine with one CUDA GPU and the CUDA
toolkit. Phases, one line each:

1. device: name, compute capability (9.x required), power limit;
2. build: ``nvcc`` builds every kernel from ``nf_tpu_torch/csrc``, one
   process per source, all started together;
3. parity: each kernel against its plain PyTorch version on the same CUDA
   inputs (tolerance 1e-5 abs on outputs, 1e-4 abs on log-dets), then its
   time, the plain version's time and its roofline bound at the shapes the
   serving path gives it;
4. gate: one coupling's transform half through kernel B and through the
   unfused feed, at B*D from 1024 to 65536 (where the fused-head gate
   belongs);
5. serving: ``build_nsf`` at the repo's default width (dim 2, 8 layers,
   hidden 128, 8 bins, 2 blocks) with seeded random weights answers
   ``log_prob`` and ``sample`` at B = 65536, checked against the same
   model on the CPU, against its own ``log_q``, and by a round trip; the
   launch counts show both kernels ran on that path;
6. profile: one ``log_prob`` and one ``sample`` call under
   ``torch.profiler``: device busy and idle share, device time by kernel.

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
MODEL_TOL = 1e-3  # whole model: card vs CPU, log_prob(sample) vs log_q
ROUND_TRIP_TOL = 1e-3
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
                   if str(e.device_type).endswith("CUDA"))
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

    names = ["rqs_fwd", "head_rqs_fwd"]
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

    tk.rqs_fwd.launches = shf.fused_head_rqs.launches = 0
    with torch.inference_mode():
        lp = counted("log_prob", lambda: model.log_prob(x_dev))
        z, log_q = counted("sample", lambda: model.sample(BATCH,
                                                          generator=gen))
        x_s = counted("forward", lambda: model.forward(z))
        z_back = counted("inverse", lambda: model.inverse(x_s))
        lp_s = counted("log_prob(sample)", lambda: model.log_prob(z))
        torch.cuda.synchronize()
    launches = (tk.rqs_fwd.launches, shf.fused_head_rqs.launches)

    for label, (a, b) in counts.items():
        if (a, b) != (layers, layers):
            raise RuntimeError(f"{label}: {a} launches of kernel A and {b} "
                               f"of kernel B, expected {layers} each")
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
    for label, parity, timing, source, replaces in (
            ("rqs_fwd", parity_kernel_a, timing_kernel_a,
             "nf_tpu_torch/csrc/rqs_fwd.cu",
             "nf_tpu/ops/splines_pallas.py:209"),
            ("head_rqs_fwd", parity_kernel_b, timing_kernel_b,
             "nf_tpu_torch/csrc/head_rqs_fwd.cu",
             "nf_tpu/ops/spline_head_fused.py:105")):
        wy, wl, cases = parity(dev)
        if not (wy <= Y_TOL and wl <= LD_TOL):
            raise RuntimeError(f"{label} disagrees with its plain version: "
                               f"y {wy:.3g} (limit {Y_TOL}), ld {wl:.3g} "
                               f"(limit {LD_TOL})")
        t = timing(dev, flush, peaks)
        results[label] = dict(err=max(wy, wl), t=t, source=source,
                              replaces=replaces)
        (fms, fplain, fbound, fby), (ims, iplain, ibound, iby) = \
            t[False], t[True]
        print(f"phase parity {label}: {cases} cases, max abs err y {wy:.3g} "
              f"ld {wl:.3g}; spline forward: kernel_ms {fms:.4f} plain_ms "
              f"{fplain:.4f} bound_ms {fbound:.5f} ({fby}); spline inverse: "
              f"kernel_ms {ims:.4f} plain_ms {iplain:.4f} bound_ms "
              f"{ibound:.5f} ({iby}); peaks {peaks[0]:.3g} B/s "
              f"{peaks[1]:.3g} flop/s", flush=True)

    launches = phase_serving(dev, flush)
    kernels = []
    for (label, r), n in zip(results.items(), launches):
        ms, plain, bound_ms, bound_by = r["t"][False]
        kernels.append({
            "name": label, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": n,
            "max_abs_err": r["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        if n == 0:
            raise RuntimeError(f"{label} never ran on the serving path")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
