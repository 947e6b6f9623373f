#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``nf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root, on a machine with one CUDA GPU and the CUDA
toolkit. Phases, one line each:

1. device: name, compute capability (9.x required), power limit;
2. build: ``nvcc`` builds every kernel from ``nf_tpu_torch/csrc``, one
   process per source, all started together; registers and spills per
   instantiation, failing if a bfloat16 instantiation of B or E spills
   or holds no tensor-core instruction, or if any per-element
   instantiation of A, C or D spills (by K, direction and offset width:
   24 each, and D's ring another 24);
3. parity: each kernel against its plain PyTorch version on the same CUDA
   inputs (kernels A and B: 1e-5 abs on outputs, 1e-4 abs on log-dets;
   backward kernels C, D and E: 1e-4 abs on per-element gradients, 1e-4
   relative to the largest magnitude on gradients summed over the batch;
   kernel D also against kernel C, and at x = ±tb against half of C's
   x-gradient), then its time, the plain version's time and its roofline
   bound at the shapes the serving path (A, B) or a training step (C, E:
   ``build_nsf``'s; D: the circular NSF's) gives it; A also at a dim-8
   CDF, at B = 2048 and at the circular NSF's serving shape, A and C at
   its training shapes, B and E also at D = 4 and at hidden 512; where
   kernel E's gx differs from its plain version's by more than 1e-4, E
   against the plain version summed in the kernel's order and both against
   the plain version in float64 (which of the two moved); and the launch
   floor, the time of an empty launch measured the same way. Kernel C at
   the CDF runs its shared-parameter path (row sums held against the
   float64 sums of the plain planes, two calls bitwise equal); its
   per-element path there has a line of its own, and so has the CDF's
   backward as autograd runs it (device ms, the kernels it launches by the
   profiler, at most two); kernel F (the residual fixed point's loop
   condition) against ``fixed_point_go`` and JAX's decision on edge
   planes (the exact threshold, NaN, +-inf, counts 1000 and 1001, an empty
   batch) at 8 and 131072 elements in float32 and bfloat16 and on planes
   one element at the threshold, and its time at (65536, 2); at the end
   of the run, the per-element A, C and D times at their design bars'
   shapes (PER_ELEMENT_BARS: the image views, the K-major planes, the
   circular NSF's (2, 16384); f32 and bf16 in turns) against each bar,
   met or not, beside the bound and the launch floor;
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
   profiler (device busy ms and kernel launches per step);
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
   step, and a profiled step;
10. graphs: the same two models served and trained as CUDA graphs
    (``nf_tpu_torch.serving``; the steps ``make_forward_kld_step`` and
    ``make_reverse_kld_step`` capture on CUDA, their ``.eager`` do not):
    ``compile_log_prob`` and ``compile_sampler`` of each model at
    B = 65536 (graph against eager: log_prob within 1e-6 abs, the
    sampler bitwise for the same seed), ``compile_log_prob_buckets`` at
    ragged sizes (1, 1000, 40000; the ladder's memory against one
    graph's), the ``build_nsf`` forward-KLD step at B = 65536 and the
    circular reverse-KLD step at B = 16384 under C and under D, each
    with Adam(capturable=True), five captured steps against five eager
    ones (loss and parameters within 1e-5 abs); for each path wall ms per
    call or step (median of 10 synchronised calls, eager and graph in
    turns), one profiled replay (device busy, idle share, the port
    kernels it launched by name, which must be the path's) and its host
    syncs (must be 0); the captured step's programmatic edges (kernel
    C's shared-parameter sum, one per CDF); ``build_nsf`` with every
    ``LULinear`` cached; the fused-head gate with both ways captured;
11. mixed: the circular NSF with ``mixed_precision=True`` (bf16 MADEs)
    under graphs against the same weights in f32 (log_prob within 0.05
    abs plus 0.05 relative, the JAX package's bar; round trips within
    0.02), ms per call and per reverse-KLD step against f32 in turns;
    ``build_nsf(mixed_precision=True)`` at B = 65536, whose log_prob is
    the f32 model's bitwise (its couplings take the fused head with the
    f32 trunk);
12. conditional: kernels B and E at H = 64 (``build_conditional_nsf``'s
    trunk, half a W_eff tile) against their plain versions at B = 65536
    and a ragged B, with their times and bounds; ``build_conditional_nsf``
    at its defaults (dim 2, context 4, K 4, hidden 64, 8 bins), perturbed,
    on contexts drawn as ``examples/conditional_flow.py`` draws them:
    ``log_prob`` and ``sample`` at B = 65536 against the CPU, against
    ``log_q`` and by a round trip, A and B once per coupling per pass;
    the forward-KLD step on ``ConditionalDiagGaussianTarget`` samples with
    Adam(3e-3): one step card against CPU at B = 8192 (A, B, C, E) and
    2048 (A and C), launches per step, 50 eager steps at B = 65536 whose
    loss falls; then ``compile_log_prob`` and ``compile_sampler`` with a
    context, the bucket ladder with a context and the captured step on
    ``(x, context)``, each against eager, timed in turns and profiled;
13. realnvp: ``build_realnvp`` at its defaults (K 64, MLPs [2, 64, 64,
    2]) with TwoModes, set by ``init_from_samples(512)``: serving at
    B = 65536 against the CPU, ``scan=True`` against ``scan=False``
    bitwise, the annealed reverse-KLD step of ``examples/real_nvp.py`` at
    B = 16384 with Adam(1e-4, the reference notebook's rate at K = 64)
    eager against graph, and ``bench.py``'s recipe (K 16,
    hidden [128, 128], B = 65536, forward + inverse + log-det round trip)
    as one graph, in samples/s; no port kernel launched;
14. maf: ``build_maf`` at its defaults (K 8, MADE hidden 64): serving at
    B = 65536 against the CPU and the forward-KLD step on TwoMoons eager
    against graph; no port kernel launched;
15. image_nsf: kernels A and C on the image coupling's 4D views (the
    conditioner's (P, B, C, H, W) planes collapsed to (P, B*C, H*W)
    without a copy) at both levels' shapes, B = 256 and 64, against their
    plain versions, with their times and bounds; the image models' largest
    convolutions as the port runs them (float32, deterministic) against
    TF32 forwards and cuDNN's default backward; ``build_image_nsf`` at its
    defaults (3 x 32 x 32, L 2, K 4, hidden 64, 8 bins), perturbed, its
    ActNorms set by ``init_from_data`` on ``procedural_image_classes(0,
    256)`` through Scale and Jitter: ``log_prob`` and bits/dim at
    B = 256 against the CPU on 16 images (1e-4 relative to |log p|,
    bits/dim 1e-4), ``sample(256, temperature=0.7)`` against the tempered
    model's ``log_prob``, a round trip through the latents, A 8 times per
    pass; the forward-KLD step at B = 64 (Adam 1e-3) card against CPU on
    16 images, A and C 8 times per step; then ``compile_log_prob``,
    ``compile_sampler`` (tempered) and the captured step against eager,
    timed in turns and profiled (A in every replay, C in the step's);
16. glow: ``build_glow_multiscale`` at its defaults (L 3, K 16, hidden
    256, class-conditional), perturbed and set by ``init_from_data``:
    the same gates at B = 128 with labels (``class_cond``: the graphs
    take ``y``; the sampler at T = 0.7), the step on ``(x, y)``; no port
    kernel launched;
17. circular_coupled: ``build_circular_nsf``'s arguments with the
    ``CircularCoupledRationalQuadraticSpline`` in place of the
    autoregressive layer (dim 2, ind_circ [0], K 12, one block of hidden
    512, 10 bins, tail bounds (pi, 3), masks alternating, ``PeriodicWrap``,
    a ``UniformGaussian`` base of scale (2 pi, 1)), perturbed: kernels B
    and E alone at an angle-transforming layer's real operands (circular
    tails, H 512, K 10, D 1, B = 65536) against their plain versions,
    their times, bounds, registers and spills; ``log_prob`` and
    ``sample`` at B = 65536 against the CPU (1e-3, or twice the CPU's own
    float32 error against float64), against ``log_q`` and by a round trip
    (the angle modulo 2 pi), A and B 12 per pass, 6 of the B launches at
    circular tails; the reverse-KLD step on the Gauss-von Mises target
    (Adam 5e-4, B = 16384): one step card against CPU at B = 4096, A, B,
    C, E 12 per step (B and E 6 each at circular tails); serving and the
    step as graphs against eager, in turns and profiled;
18. residual: ``build_residual`` at its defaults (K 16, LipschitzMLP
    [2, 128, 128, 128, 2], L 0.9, ActNorm), perturbed, power iterations
    advanced 200 steps, ActNorms set by ``init_from_data`` on two moons,
    served under the exact 2D log-det (``set_exact_logdet``): ``log_prob``
    and ``sample`` at B = 65536 against the CPU (4096 rows, the sample as
    the push-forward of the same base draws), against ``log_q`` and by a
    round trip, the fixed point's iterations per layer and the eager
    loop's host syncs; both as graphs (each fixed point a WHILE node with
    kernel F; a sampler replay bitwise eager with the same counts per
    layer and no flag; its time beside the parent's masked count's); the
    forward-KLD step with
    ``with_key`` and ``post_update=update_lipschitz(m, 50)`` (Adam 3e-4,
    weight decay 1e-5, B = 512 on two moons): one step card against CPU
    on injected probes, five captured steps against five eager (loss,
    parameters, u and v within 1e-5); one eager reverse-KLD step on
    TwoModes, card against CPU at B = 1024, its gradient through the
    implicit VJP, then five captured reverse-KLD steps (both solves WHILE
    nodes) against five eager (1e-5, the same counts per layer);
    ``build_residual`` at ``lipschitz_const=0.99`` with closed-form
    weights (K cut to 4), whose eager fixed points take over 32 passes,
    served as a graph bitwise eager with the same counts, timed in turns
    and profiled; an iResBlock over a LipschitzCNN on (8, 4, 8, 8)
    inputs, its exact-trace ``log_prob`` card against CPU; kernel F in the
    captured samplers and the captured reverse step only;
19. planar_radial: ``build_planar_stack`` and ``build_radial_stack`` at
    their defaults (dim 2, K 16) with TwoModes, perturbed: ``sample`` at
    B = 65536 against the CPU's push-forward of the same base draws and
    as a graph (bitwise eager), the annealed reverse-KLD step of
    ``examples/comparison_plan_rad_aff.py`` (Adam 5e-3 / 3e-3, B = 512)
    eager against graph; no port kernel launched;
20. dropout_batch_norm: ``build_nsf``'s arguments with dropout 0.1 in
    every coupling trunk (``CoupledRationalQuadraticSpline(...,
    dropout_probability=0.1)``): the keyed forward-KLD step (Adam 1e-3):
    one step card against CPU at B = 16384 on the card's masks replayed
    on the CPU, five captured steps against five eager at B = 65536, the
    captured step in turns against the unkeyed one, served ``log_prob``
    bitwise the p = 0 model's (A, B, C, E 8 per step); ``build_circular_
    nsf`` at its defaults with MADE dropout 0.1: the reverse-KLD step with
    ``score_fn`` True and False (the re-pass on the sampling pass's
    masks) card against CPU at B = 4096 and as graphs at 16384 (A and C
    24 or 36 per step), one AR layer's round trip under one draw; a
    ``build_nsf``-shaped model with batch-norm trunks: kernels B and E at
    its operands against their plain versions, ``log_prob`` and the step
    card against CPU at 65536;
21. layers_distributions: ``examples/change_base_distribution.py``'s
    model (a trainable two-mode ``GaussianMixture`` base, K 8
    ``AffineCouplingBlock``s over MLPs [1, 64, 64, 2], swap ``Permute``s):
    its forward-KLD step (Adam 3e-3, B = 512) eager against graph, served
    at 65536 as graphs; every new base, target and prior's ``log_prob``
    card against CPU at 65536 and its sampler on the card (the draws' mean
    log-density against the CPU's draws'); a RealNVP-shaped stack with
    ``BatchNorm`` and ``InvertibleAffine`` card against CPU; no port
    kernel launched; a bfloat16 ``build_image_nsf``'s ``log_prob`` of 16
    images, kernel A's bfloat16 instantiation 8 times;
22. snf, snf_nsf, mh: ``examples/stochastic_nf.py``'s stochastic
    normalizing flow (K 4 ``MaskedAffineFlow`` + ``ActNorm`` blocks, MLPs
    [2, 64, 64, 2], an HMC layer of 5 leapfrog steps of 0.2 after every
    second block, TwoModes): ``init_from_samples(512)``, its annealed
    reverse-KLD step (B = 1024) card against CPU on the card's draws
    replayed (the base's draws, the momenta and uniforms; an accept
    decision within 1e-5 of its threshold is taken from the card and
    counted), eager against graph, ``sample_with_mcmc_stats`` at 8192,
    the sampler as a graph at 65536; no port kernel. The same recipe over
    ``build_nsf``'s layer pairs (hidden 128, 8 bins): its reverse-KLD step
    at B = 4096, kernels B and E in the couplings (A and C on their
    identity halves' CDF) around the HMC layers' second-order gradient,
    card against CPU, eager against graph and timed against
    ``build_nsf``'s own step; its sampler at 65536 (A and B), held
    against the CPU at 1e-3 or twice the CPU's own float32 error against
    float64. A Metropolis-Hastings chain (65536 chains, 200 steps) whose
    moments match a numpy quadrature of TwoModes;
23. hais: ``examples/hais_sampling.py`` (4096 samples, 31 HMC layers)
    card against CPU on the card's draws, as a graph bitwise eager, its
    ``log Z`` against the quadrature, the ESS; no port kernel;
24. vae: ``examples/vae.py``'s flow VAE on procedural digits, one step
    card against CPU on the encoder's draws, 200 keyed negative-ELBO
    steps graph and eager in turns, the IWAE-16 bound; no port kernel;
25. infrastructure: ``prefetch_to_device`` feeding ``build_nsf``'s
    captured step, a ``CheckpointManager`` round trip of a captured step,
    ``Named`` ranges in a ``utils.trace`` profile, ``utils.throughput`` of
    a served sampler;
26. binary and parallel: the training binary ``nf_tpu_torch.train.main``
    in this process: (a) ``--model nsf --loss forward_kld`` on two moons
    at ``build_nsf``'s width, B = 65536, 200 steps with checkpoints and a
    JSONL log (the loss falls; A, B, C, E in every replay), ms per step
    in turns with the bare captured step, the binary's draw alone and its
    host syncs (at most 2), the idle share of a profiled step, its loop
    with a checkpoint every 5 steps, synchronous against asynchronous
    saves in turns, then re-entered on its directory (the
    restored state bitwise the saved one, 100 more steps as a graph); (b)
    the annealed reverse-KLD binary on TwoModes at 16384 samples (the
    reverse KLD at beta 1 falls); (c) the image NSF binary at
    ``build_image_nsf``'s defaults (L 2, K 4, hidden 64), B = 64, on
    procedural images (in turns with the bare captured step) and on an
    ``.npz`` (bits/dim finite and falling; A and C), and Glow (no port
    kernel); (d)
    ``python -m nf_tpu_torch.train --distributed`` in subprocesses over
    NCCL at world size 1, against the same run without it (1e-6), and
    with ``--accum_steps 2``; then on a world-size-1 NCCL process group:
    (e) the data-parallel forward step (B = 65536) and the
    sample-parallel reverse step (16384) captured against eager, the
    NCCL kernel in a profiled replay, each against the mesh-less captured
    step in turns; (f) ``make_sharded_sampler`` over phase 23's HAIS
    against the unsharded HAIS; (g) ``compat_export`` of (a)'s model into
    a CPU ``build_nsf`` (``log_prob`` within 1e-3);
27. export: serving's deployment surface and the tensor-parallel
    layouts at ``build_nsf``'s full width (B = 65536): (1) kernels A, B,
    C (its shared path) and E called through ``torch.ops.nf_tpu_torch``
    at the main shapes, beside PERF.md's kernel_ms; (2)
    ``export_log_prob`` and ``export_sampler`` with ``freeze_params``
    True and False, and the circular NSF's ``log_prob``, reloaded in a
    fresh interpreter whose builders raise: within 1e-5 of
    ``compile_log_prob`` (a refreshed weight list against a model
    holding it), the samplers bitwise ``compile_sampler``, the artifacts'
    A and B op nodes as many as a compiled replay launches; (3) the
    exported calls eager and as the reloaded function's CUDA graph in
    turns with the compiled ones; (4) the card's ``log_prob`` artifact
    moved to the CPU (1e-3); (5) ``cost_analysis`` and
    ``memory_analysis`` of ``build_nsf``'s and the circular NSF's
    ``log_prob`` and sampler, with the FLOP/s of each graph; (6) on a
    world-size-1 NCCL group, the forward step with ``state_shardings`` on
    a (data 1, model 1) mesh and the batch-norm ``build_nsf``'s sharded
    step, each bitwise its twin after five captured steps;
28. image_nsf_bf16 (run right after phase 16, beside the float32 image
    NSF): ``build_image_nsf(dtype=torch.bfloat16)`` at its defaults,
    perturbed, its ActNorms set in bfloat16: kernels A, C and D in
    bfloat16 on the image views at both levels (B = 256 and 64) and at
    K = 10, each element within one bfloat16 ulp of its plain version
    (``2^-7 |plain| + 1e-6``, gradients ``+ 1e-4 max |plain|``), each one
    device launch with no cast around it (one captured call is one graph
    node), timed in turns with float32; ``log_prob``, bits/dim and ``sample(256, temperature=0.7)`` card
    against CPU on 16 images and by the round trip at the bfloat16 bar
    (0.05 abs + 0.05 relative); the forward-KLD step at B = 64 (Adam
    1e-3) under "analytic" (A, C) and "autodiff" (A, D), card against CPU
    (the loss at the bar, the gradients within 0.3 relative L2); then
    ``compile_log_prob`` and ``compile_sampler`` (bitwise eager) and the
    captured steps against eager, every port launch a bfloat16 one, and
    each timed in turns with the float32 model's graph;
29. coupled_nsf_bf16 (run right after phase 28): kernels B and E and C's
    shared path in bfloat16 at ``build_nsf``'s coupling (H 128, K 8), the
    circular coupled model's (H 512, K 10, circular tails) and at
    B = 4099 (B and E: the tensor-core kernels), each element within one
    bfloat16 ulp of its plain version on the kernels' own head sums
    (``head_params_bf16``; the sums within 2^-20 of float64's over
    sum |w h|), a captured call holding only its bfloat16 kernels, timed
    in turns with float32; then
    ``build_nsf(permutation=False)``'s stack in bfloat16 from the public
    layers (8 ``CoupledRationalQuadraticSpline``, a ``DiagGaussian``):
    ``log_prob`` and ``sample`` at B = 65536 card against CPU and by the
    round trip at the bfloat16 bar, the forward-KLD step on TwoMoons
    under "analytic" (A, B, C's shared path, E) and "autodiff" (D on the
    CDF), card against CPU; the graphs bitwise eager, their kernel nodes
    read by name (only bfloat16 port kernels, no cast), and each timed in
    turns with the same layers in float32;
30. examples (run last): every twin of ``examples_torch/`` (the example
    scripts on the port) through its ``main()`` in this process, at its
    default widths and batch with its iterations capped at 100, its output
    files in a temporary directory: each twin's wall seconds, iterations
    per second and launches, losses finite (affine on smiley, which leaves
    float32 in the JAX example too, only its first 5) and, where the
    objective is fixed (no annealed beta), the last 10 below the first 10
    by LOSS_MARGIN (the residual recipe, at Adam 3e-4, by half of it);
    ``neural_spline_flow.py`` once at its full recipe (2000 iterations at
    batch 512, A and C, its batch drawn inside the captured step), the
    mean of its last 100 losses within NSF_RECIPE_BAR
    (``tests/recipe_bar_nsf.py``: the JAX example on the CPU over seeds
    0-2), its ms per iteration beside the target's eager draw alone;
    ``serving_inference.py``'s served ``log_prob`` and ``sample`` at
    B = 4096 through kernel B; the kernel-free twins launch no port kernel;
31. target draw (run before phase 30): the targets' rejection draw
    (``distributions/target.py``) on TwoMoons at 512 and 65536 and on an
    ``ImagePrior`` (a ``procedural_image_classes`` image) and Smiley at
    512: the eager loop's host syncs per draw (median of 50, at most 2)
    and wall ms; the sync-free draw captured in a CUDA
    graph with its generator registered (0 host syncs per replay, two
    replays differ, a replay bitwise the eager sync-free draw from the
    same generator state, a pool of N flags ``full`` false) and its
    replay ms; the eager draw under deterministic algorithms bitwise the
    default's; card against CPU at 65536: means, covariances and quadrant
    shares within 4 sigma of their sampling error, the acceptance rate
    within 4 sigma of the CPU's; no port kernel;
32. spline_family_bf16 (run right after phase 29): the bfloat16
    autoregressive and circular spline models from the public layers:
    ``examples/neural_spline_flow.py --autoregressive``'s AR NSF (4 x
    [``AutoregressiveRationalQuadraticSpline`` (2 blocks, hidden 64, 8
    bins), ``LULinearPermute``] on a ``DiagGaussian``), the circular NSF
    (``build_circular_nsf``'s stack) and phase 17's circular coupled
    model, each with ``dtype=torch.bfloat16``, perturbed: kernels A, C and
    D in bfloat16 on the MADE's K-major planes at linear and per-feature
    circular tails, B, E and C's shared path at the coupled model's
    circular operands, each element within one bfloat16 ulp of its plain
    version (B and E on the kernels' own head sums) and timed in turns
    with float32; each model's ``log_prob``
    and ``sample`` at B = 65536 card against CPU (4096 rows), by the
    round trip and ``forward(inverse(x))`` (the angle modulo 2 pi) at the
    bfloat16 bar; the AR NSF's forward-KLD step under "analytic" and
    "autodiff" and the circular models' reverse-KLD step on the
    Gauss-von Mises target, card against CPU at B = 4096; then
    ``compile_log_prob``, ``compile_sampler`` and the captured steps
    (B = 65536; the reverse steps 16384) bitwise eager, every port launch
    bfloat16, a captured call read by kernel name (no cast but the AR
    NSF's LU solves in float32), each timed in turns with the same layers
    in float32, the circular NSF also with ``mixed_precision=True``.

``python3 chip_smoke.py --dispatch-turns PARENT`` times the eager
``build_nsf`` ``log_prob`` and step of the checkout ``PARENT`` against
this one's in turns (the cost of the ops' dispatcher) and stops.

It then prints the whole run's wall time, one JSON line on the kernels
(their launches summed over every path above), the card's name and power
limit as ``nvidia-smi`` reports them, and, last, ``{"ok": true, "device":
...}``. A failed phase raises and the script exits non-zero; without CUDA
it exits 1 before printing any result.
"""

from __future__ import annotations

import copy
import functools
import json
import re
import shutil
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
CIRC_CPU_BATCH = 4096  # log_prob, card against CPU
CIRC_STEPS = 50
TIE_TOL = 1e-5  # kernel D at x = ±tb: half of kernel C's x-gradient

# Published peaks (NVIDIA data sheets, dense): memory bytes/s, float32
# CUDA-core flop/s and bfloat16 tensor-core flop/s. The SXM part's are the
# default.
PEAKS = {"PCIe": (2.0e12, 51e12, 756e12), "NVL": (3.9e12, 60e12, 835e12)}
SXM_PEAKS = (3.35e12, 67e12, 989e12)


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
             + ["rqs_bwd_autodiff", "fixed_point_cond", "head_params_bf16"])
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
    head_libs = [n for n in names if n.startswith("head_")]
    heads = ptxas_kernels("\n".join(_build.BUILD_LOGS.get(n, "")
                                    for n in head_libs))
    mma = {}
    for n in head_libs:
        mma.update(sass_mma_counts(_build._lib_path(n)))
    rows, spilling, without = [], [], []
    for kernel in ("head_rqs_fwd_bf16_kernel bf16",
                   "head_rqs_bwd_bf16_kernel bf16"):
        for k, flags, regs, spill in heads.get(kernel, []):
            base = kernel.split()[0]
            n_mma = sum(v for sym, v in mma.items() if base in sym
                        and f"ILi{k}E" in sym and template_flags(sym) == flags)
            rows.append(f"{base.replace('_kernel', '')} K{k} {flags}: "
                        f"{regs} registers, {spill} bytes spilled, "
                        f"{n_mma} HMMA/HGMMA")
            if spill:
                spilling.append((base, k, flags, spill))
            if not n_mma:
                without.append((base, k, flags))
    # a library built by an earlier run in this checkout left no ptxas log
    logged = all(n in _build.BUILD_LOGS for n in head_libs)
    # B: circular x inverse per K; E: the same at 4 and 8 warps a block
    if logged and len(rows) != 12 * len(SUPPORTED_BINS):
        raise RuntimeError(f"phase build: {len(rows)} bfloat16 head kernel "
                           f"instantiations in the ptxas log, expected "
                           f"{12 * len(SUPPORTED_BINS)}")
    if not logged:
        rows.append("built by an earlier run: no ptxas log, HMMA/HGMMA in "
                    "the bfloat16 kernels " + str(sum(
                        v for sym, v in mma.items() if "bf16_kernel" in sym)))
        without = [] if "bf16_kernel" in " ".join(
            sym for sym, v in mma.items() if v) else ["all"]
    from nf_tpu_torch.ops import spline_head_fused as shf

    smem = {f"E H {h} K {k}": shf.kernel_e_bf16_plan(m, 1, h)
            for h, k, m in ((HIDDEN, K_BINS, 3 * K_BINS - 1),
                            (512, 10, 30))}
    print("phase build bfloat16 head kernels (tensor cores; K, flags "
          "circular/inverse[/warps a block]): " + "; ".join(rows) + "; dynamic shared "
          f"bytes B {shf.kernel_b_bf16_shared_bytes(3 * K_BINS - 1, HIDDEN)}"
          f" at H {HIDDEN} K {K_BINS}, "
          f"{shf.kernel_b_bf16_shared_bytes(30, 512)} at H 512 K 10; "
          + ", ".join(f"{k} {v[2]} ({v[0]} warps, W_eff tile {v[1]} "
                      f"columns)" for k, v in smem.items()), flush=True)
    if spilling or without:
        raise RuntimeError(f"bfloat16 B and E kernels that spill "
                           f"{spilling} or hold no tensor-core instruction "
                           f"{without}")
    spilled = []
    for n in ("rqs_fwd", "rqs_bwd", "rqs_bwd_autodiff"):
        by_kernel = ptxas_kernels(_build.BUILD_LOGS.get(n, ""))
        print(f"phase build {n} by kernel (K, direction[/offset bits]: "
              f"registers, bytes spilled): "
              + "; ".join(
                  f"{kernel} " + ", ".join(
                      f"K{k}{'i' if flags[:1] == '1' else 'f'}{flags[1:]} "
                      f"{regs}" + (f" +{spill}" if spill else "")
                      for k, flags, regs, spill in rows)
                  for kernel, rows in by_kernel.items()), flush=True)
        # per element: 2 dtypes x 3 K x 2 directions x 2 offset widths of
        # the one-tile kernel, and in D's library as many of its ring
        per_element = {kernel: rows for kernel, rows in by_kernel.items()
                       if kernel.startswith(("rqs_fwd_kernel",
                                             "rqs_bwd_kernel",
                                             "rqs_bwd_ring_kernel"))}
        spilled += [(kernel, k, flags, spill)
                    for kernel, rows in per_element.items()
                    for k, flags, _, spill in rows if spill]
        found = sum(len(rows) for rows in per_element.values())
        want = 48 if n == "rqs_bwd_autodiff" else 24
        if n in _build.BUILD_LOGS and found != want:
            raise RuntimeError(f"phase build: {found} per-element "
                               f"instantiations of {n} in the ptxas log, "
                               f"expected {want}")
    # the one-thread-per-element kernels these replace spilled nothing at
    # any instantiation; the shared paths' kernels are unchanged (C's first
    # launch spills 16 bytes at K 4) and only printed
    if spilled:
        raise RuntimeError(f"per-element kernels A, C or D spill: {spilled}")


def template_flags(symbol):
    """A kernel's template bools in order, as "0"/"1", an int after them
    as "w<n>" (the bfloat16 kernel E's warps per block), and an offset
    type after them as "/32" or "/64" (the per-element A, C and D:
    unsigned or unsigned long long, after the direction), from its
    mangled name."""
    flags = "".join(re.findall(r"Lb([01])E", symbol))
    warps = re.search(r"Lb[01]ELi(\d+)EE", symbol)
    offsets = re.search(r"Lb[01]E([jy])E", symbol)
    return (flags + (f"w{warps.group(1)}" if warps else "")
            + ({"j": "/32", "y": "/64"}[offsets.group(1)] if offsets
               else ""))


def ptxas_kernels(log):
    """``nvcc -Xptxas -v`` output -> {kernel: [(K, flags, registers,
    spill-store bytes)]}, by the kernel's name (with " bf16" for a
    bfloat16 instantiation) and its template arguments in the mangled
    symbol: K (0 where it has none) and ``flags``, its bools in order
    (A, C, D: inverse; B: circular, inverse; E: circular, inverse, one
    feature)."""
    import re

    out, entry, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            name = re.search(r"\d+((?:head_)?rqs_\w+?|reduce_partials)I",
                             entry)
            k = re.search(r"Li(\d+)E", entry)
            label = name.group(1) if name else entry
            if "bfloat16" in entry:  # the bfloat16 instantiations
                label += " bf16"
            out.setdefault(label, []).append(
                (int(k.group(1)) if k else 0, template_flags(entry),
                 int(m.group(1)), spill))
            entry = None
    return {n: sorted(rows) for n, rows in out.items()}


def sass_mma_counts(path):
    """{mangled kernel name: count of HMMA and HGMMA instructions} in the
    SASS of the shared library at ``path`` (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


def _normal(rng, shape, scale, dev):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev)


def parity_kernel_a(dev):
    """Both entries of kernel A, both directions: the unconditional CDF's
    broadcast parameters (stride 0 over the batch) with a float and with a
    per-feature tail bound, at D = 1 and 4 (the shared-parameter path) and
    at one column past its limit (the per-element path); and full k-major
    planes with a per-feature tail bound (the per-element path)."""
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED)
    worst_y = worst_ld = 0.0
    cases = 0

    def check(got, want):
        nonlocal worst_y, worst_ld, cases
        torch.cuda.synchronize()
        worst_y = max(worst_y, max_err(got[0], want[0]))
        worst_ld = max(worst_ld, max_err(got[1], want[1]))
        cases += 1

    for batch in PARITY_BATCHES:
        for d in (1, 4, tk.SHARED_PARAM_MAX_COLS + 1):
            x = _normal(rng, (batch, d), 2.0, dev)
            uw, uh = (_normal(rng, (1, d, K_BINS), 0.5, dev)
                      for _ in range(2))
            ud = _normal(rng, (1, d, K_BINS + 1), 0.5, dev)
            views = [t.expand(batch, d, t.shape[-1]).movedim(-1, 0)
                     for t in (uw, uh, ud)]
            tb_cols = torch.linspace(1.5, 3.0, d, device=dev)[None]
            for inverse in (False, True):
                for tb, tb_plain in ((3.0, 3.0),
                                     (tb_cols, tb_cols.expand(batch, d))):
                    check(tk.fused_unconstrained_rqs(x, uw, uh, ud, tb,
                                                     inverse=inverse),
                          tk.rqs_plain(x, *views, tb_plain, inverse=inverse))
                if d > 4:
                    continue
                planes = _normal(rng, (3 * K_BINS + 1, d, batch), 0.5, dev)
                w, h, dd = (planes[:K_BINS], planes[K_BINS:2 * K_BINS],
                            planes[2 * K_BINS:])
                tb = tb_cols.T
                check(tk.rqs_fwd(x.T, w, h, dd, tb, inverse=inverse),
                      tk.rqs_plain(x.T, w, h, dd, tb, inverse=inverse))
    return worst_y, worst_ld, cases


def parity_kernel_b(dev):
    """Kernel B against ``head_rqs_plain`` (the returned errors), and
    against the plain version that sums the head product in B's order,
    which kernel E's recompute repeats (printed; it must agree within the
    same bars, and has so far agreed to the bit)."""
    from nf_tpu_torch.ops import spline_head_fused as shf

    rng = np.random.default_rng(SEED + 1)
    worst_y = worst_ld = order = 0.0
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
                    yo, lo = shf.head_rqs_plain_in_kernel_order(
                        x_t, h_t, w, b, tb, **kw)
                    torch.cuda.synchronize()
                    worst_y = max(worst_y, max_err(y, yp))
                    worst_ld = max(worst_ld, max_err(ld, lp))
                    order = max(order, max_err(y, yo), max_err(ld, lo))
                    cases += 1
    if not order <= Y_TOL:
        raise RuntimeError(f"head_rqs_fwd disagrees with its plain version "
                           f"summed in its order by {order:.3g} (limit "
                           f"{Y_TOL})")
    print(f"phase parity head_rqs_fwd vs plain summed in its order: "
          f"{cases} cases, largest difference of y and ld {order:.3g}",
          flush=True)
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
    e_gx, e_sum, n = parity_kernel_c_shared(dev)
    return max(worst, e_gx), max(worst_sum, e_sum), cases + n


def parity_kernel_c_shared(dev):
    """Kernel C's shared-parameter path (the CDF's backward) at the
    CDF's layout, (K, 1, D) parameters, a float and a per-column tail bound,
    K 4/8/10, D 1/4/64, both directions, B = 65613 (ragged), the first two
    rows at ±tb: gx against ``rqs_bwd_plain``'s (G_TOL), the row sums
    against the float64 sums of its planes per column and against
    ``rqs_bwd_shared_plain`` (SUM_TOL of the largest magnitude); a second
    call must give the same bits. One printed line; returns the worst gx
    and sum errors and the count of cases."""
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED + 16)
    batch = PARITY_BATCHES[1]
    worst = dict(gx=0.0, sums=0.0, shared_plain=0.0)
    cases = 0
    for K in tk.SUPPORTED_BINS:
        for d in (1, 4, tk.SHARED_PARAM_MAX_COLS):
            x = _normal(rng, (batch, d), 2.0, dev)
            cty, ctl = (_normal(rng, (batch, d), 1.0, dev) for _ in range(2))
            small = [_normal(rng, (n, 1, d), 0.5, dev) for n in (K, K, K + 1)]
            views = [t.expand(t.shape[0], batch, d) for t in small]
            for tb in (3.0, torch.linspace(1.5, 3.0, d, device=dev)[None]):
                x[:2] = (torch.tensor([[1.0], [-1.0]], device=dev) * tb)
                tb_plain = tb.expand(batch, d) if torch.is_tensor(tb) else tb
                for inverse in (False, True):
                    got = tk.rqs_bwd_shared(x, *small, tb, cty, ctl,
                                            inverse=inverse)
                    again = tk.rqs_bwd_shared(x, *small, tb, cty, ctl,
                                              inverse=inverse)
                    want = tk.rqs_bwd_plain(x, *views, tb_plain, cty, ctl,
                                            inverse=inverse)
                    shared = tk.rqs_bwd_shared_plain(x, *small, tb, cty, ctl,
                                                     inverse=inverse)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise RuntimeError("rqs_bwd's shared-parameter path "
                                           "gave other bits on a second call")
                    worst["gx"] = max(worst["gx"], max_err(got[0], want[0]))
                    for g, p, q in zip(got[1:], want[1:], shared[1:]):
                        sums = p.double().sum(1, keepdim=True)
                        worst["sums"] = max(worst["sums"],
                                            rel_err(g.double(), sums))
                        worst["shared_plain"] = max(worst["shared_plain"],
                                                    rel_err(g, q))
                    cases += 1
    if not worst["shared_plain"] <= SUM_TOL:
        raise RuntimeError(f"rqs_bwd's shared-parameter path disagrees with "
                           f"rqs_bwd_shared_plain by "
                           f"{worst['shared_plain']:.3g} relative (limit "
                           f"{SUM_TOL})")
    print(f"phase parity rqs_bwd shared-parameter path: {cases} cases "
          f"(K 4/8/10, D 1/4/{tk.SHARED_PARAM_MAX_COLS}, B {batch}, two tail "
          f"bounds, both directions); gx vs rqs_bwd_plain {worst['gx']:.3g} "
          f"abs (limit {G_TOL}); row sums vs the float64 sums of its planes "
          f"{worst['sums']:.3g}, vs rqs_bwd_shared_plain "
          f"{worst['shared_plain']:.3g} relative (limit {SUM_TOL}); two calls "
          f"bitwise equal", flush=True)
    return worst["gx"], max(worst["sums"], worst["shared_plain"]), cases


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
    return x.element_size() * x.numel() * (1 + n_out) + stored


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
        PER_ELEMENT_MS[("D", "f32", "(2, 16384) K 10", inverse)] = (
            ms, out[inverse][2])
    return out


def timing_path_a_c(dev, flush, peaks):
    """Kernels A and C at the circular NSF's shapes (those of
    :func:`timing_kernel_d`), float32 and bfloat16 in turns (f32, bf16,
    bf16, f32), each dtype's bound beside: one printed line, both
    directions, the times recorded in :data:`PER_ELEMENT_MS`."""
    from nf_tpu_torch.ops import splines_kernel as tk

    ops32 = _path_operands(np.random.default_rng(SEED + 13), 10, "mixed",
                           dev)
    ops16 = [t.to(torch.bfloat16) for t in ops32]
    rows = []
    for inverse in (False, True):
        for kernel in ("A", "C"):
            def call(ops, kernel=kernel):
                x, w, h, d, tb, cty, ctl = ops
                if kernel == "A":
                    return lambda: tk.rqs_fwd(x, w, h, d, tb,
                                              inverse=inverse)
                return lambda: tk.rqs_bwd(x, w, h, d, tb, cty, ctl,
                                          inverse=inverse)
            x, w, h, d, tb, cty, ctl = ops32
            plain = device_ms(
                (lambda: tk.rqs_plain(x, w, h, d, tb, inverse=inverse))
                if kernel == "A" else (lambda: tk.rqs_bwd_plain(
                    x, w, h, d, tb, cty, ctl, inverse=inverse)), flush)
            t32, t16 = _in_turns_ms(call(ops32), call(ops16), flush)
            n_out = 2 if kernel == "A" else 3 * 10 + 2
            ops_n = (tk.rqs_ops_per_element if kernel == "A"
                     else tk.rqs_bwd_ops_per_element)(10, inverse)
            bounds = {}
            for name, ops, dtype in (("f32", ops32, torch.float32),
                                     ("bf16", ops16, torch.bfloat16)):
                x = ops[0]
                cot = 0 if kernel == "A" else 2 * x.numel() * x.element_size()
                bounds[name] = bound(_spline_bytes(x, ops[1:5], n_out) + cot,
                                     ops_n * x.numel(), peaks, dtype)
            for name, t in (("f32", t32), ("bf16", t16)):
                PER_ELEMENT_MS[(kernel, name, "(2, 16384) K 10", inverse)] = (
                    (t[0] + t[1]) / 2, bounds[name][0])
            rows.append(f"{'inverse' if inverse else 'forward'} {kernel}: "
                        f"f32 kernel_ms {t32[0]:.4f} / {t32[1]:.4f}, bf16 "
                        f"{t16[0]:.4f} / {t16[1]:.4f} (in turns f32, bf16, "
                        f"bf16, f32), f32 plain_ms {plain:.4f}, bound_ms f32 "
                        f"{bounds['f32'][0]:.5f} ({bounds['f32'][1]}), bf16 "
                        f"{bounds['bf16'][0]:.5f} ({bounds['bf16'][1]})")
    print(f"phase timing circular path shapes (x (2, {CIRC_TRAIN_BATCH}), "
          f"K = 10 full planes, mixed tails, tb (2, 1)): "
          + "; ".join(rows), flush=True)


def timing_kernel_a(dev, flush, peaks, d=1, batch=BATCH):
    """At the serving path's shapes: the CDF of a dim-2 coupling, x (B, 1),
    (1, 1, K) parameters broadcast, scalar tail bound 3. ``d`` and
    ``batch`` give another CDF's (dim 2d, or another batch)."""
    from nf_tpu_torch.ops import splines, splines_kernel as tk

    rng = np.random.default_rng(SEED + 2)
    x = _normal(rng, (batch, d), 1.5, dev)
    uw, uh = (_normal(rng, (1, d, K_BINS), 0.5, dev) for _ in range(2))
    ud = splines.pad_derivatives(_normal(rng, (1, d, K_BINS - 1), 0.5, dev),
                                 "linear", 1e-3, axis=-1)
    views = [t.expand(batch, d, t.shape[-1]).movedim(-1, 0)
             for t in (uw, uh, ud)]
    out = {}
    for inverse in (False, True):
        ms = device_ms(lambda: tk.fused_unconstrained_rqs(
            x, uw, uh, ud, 3.0, inverse=inverse), flush)
        plain = device_ms(lambda: tk.rqs_plain(
            x, *views, 3.0, inverse=inverse), flush)
        nbytes = 4 * (3 * x.numel() + uw.numel() + uh.numel() + ud.numel())
        # the parameters are shared down each column: their softmaxes,
        # knots and softplus are work per column, not per element
        ops = tk.rqs_shared_ops(K_BINS, inverse, d, x.numel())
        out[inverse] = (ms, plain) + bound(nbytes, ops, peaks)
    return out


def timing_kernel_a_circular(dev, flush, peaks, batch=CIRC_BATCH):
    """Kernel A alone at the circular NSF's serving shapes: x (2, B), full
    K = 10 planes, mixed tails, tail bound (2, 1)."""
    from nf_tpu_torch.ops import splines_kernel as tk

    x, w, h, d, tb, _, _ = _path_operands(np.random.default_rng(SEED + 14),
                                          10, "mixed", dev, batch)
    out = {}
    for inverse in (False, True):
        ms = device_ms(lambda: tk.rqs_fwd(x, w, h, d, tb, inverse=inverse),
                       flush)
        plain = device_ms(lambda: tk.rqs_plain(x, w, h, d, tb,
                                               inverse=inverse), flush)
        out[inverse] = (ms, plain) + bound(
            _spline_bytes(x, (w, h, d, tb), 2),
            tk.rqs_ops_per_element(10, inverse) * x.numel(), peaks)
    return out


def _timing_row(label, t):
    return f"{label}: " + ", ".join(
        f"{'inverse' if inv else 'forward'} kernel_ms {v[0]:.4f} plain_ms "
        f"{v[1]:.4f} bound_ms {v[2]:.5f} ({v[3]})" for inv, v in t.items())


def timing_kernel_a_other(dev, flush, peaks):
    """Kernel A at the CDF of a dim-8 coupling (x (65536, 4)), at the CDF
    of a training step below the fused-head gate (x (2048, 1)) and at the
    circular NSF's serving shape (x (2, 65536)): one printed line."""
    out = {"CDF x (65536, 4)": timing_kernel_a(dev, flush, peaks, d=4),
           "CDF x (2048, 1)": timing_kernel_a(dev, flush, peaks,
                                              batch=2048),
           f"circular x (2, {CIRC_BATCH})": timing_kernel_a_circular(
               dev, flush, peaks)}
    print("phase timing rqs_fwd other shapes (K = 8 linear CDFs with "
          "(1, D, K) parameters and tail bound 3; K = 10 circular full "
          "planes, mixed tails, tb (2, 1)): "
          + "; ".join(_timing_row(k, v) for k, v in out.items()),
          flush=True)
    return out


def launch_floor(flush):
    """``device_ms`` of an empty launch (``torch.cuda._sleep(0)``), timed as
    every kernel is: the part of a small kernel's time that no design of
    it can remove."""
    ms = device_ms(lambda: torch.cuda._sleep(0), flush)
    print(f"phase launch floor: device_ms of an empty launch "
          f"(torch.cuda._sleep(0)) {ms:.4f}", flush=True)
    PER_ELEMENT_MS["floor"] = ms
    return ms


# kernel times at the shapes of the per-element bars, recorded by the
# timing functions as they run: {(kernel, dtype, shape, inverse): (mean ms
# of the two turns, bound ms)}, and the launch floor under "floor"
PER_ELEMENT_MS = {}
# The per-element path's design bars (csrc/rqs_per_element.cuh): (kernel,
# dtype, shape, inverse, the previous design's kernel_ms, rule). The
# previous design, one thread per element with 64-bit indexing, was timed
# at these shapes on an H100 80GB HBM3 at 700 W (PERF.md section 6);
# "half": the bar is the launch floor plus the bound plus half of what
# that design spent above the two, the floor measured in this run;
# "0.95x": 0.95 times that design's time, at the small grids.
PER_ELEMENT_BARS = (
    ("A", "f32", "image (1536, 256)", False, 0.0276, "half"),
    ("A", "bf16", "image (1536, 256)", False, 0.0215, "half"),
    ("A", "bf16", "K-major (2, 65536) K 8", False, 0.0116, "half"),
    ("A", "bf16", "K-major (2, 65536) K 10", True, 0.0123, "half"),
    ("C", "bf16", "K-major (2, 65536) K 8", False, 0.0154, "half"),
    ("C", "bf16", "image (384, 256)", True, 0.0125, "half"),
    ("A", "f32", "(2, 16384) K 10", False, 0.0096, "0.95x"),
    ("C", "f32", "(2, 16384) K 10", False, 0.0106, "0.95x"),
    ("C", "bf16", "K-major (2, 16384) K 10", True, 0.0094, "0.95x"),
)


def per_element_bars():
    """One printed line: each bar of :data:`PER_ELEMENT_BARS` against the
    time this run recorded at its shape, met or not (a report: nothing
    fails on it), and every other recorded per-element time beside its
    bound."""
    floor = PER_ELEMENT_MS.get("floor")
    rows, barred = [], set()
    for kernel, dt, shape, inverse, before, rule in PER_ELEMENT_BARS:
        key = (kernel, dt, shape, inverse)
        barred.add(key)
        if key not in PER_ELEMENT_MS or floor is None:
            rows.append(f"{kernel} {dt} {shape} not timed")
            continue
        ms, bound_ms = PER_ELEMENT_MS[key]
        bar = (floor + bound_ms + 0.5 * (before - floor - bound_ms)
               if rule == "half" else 0.95 * before)
        rows.append(f"{kernel} {dt} {shape} {'inv' if inverse else 'fwd'} "
                    f"kernel_ms {ms:.4f} (before {before}, bound "
                    f"{bound_ms:.5f}) bar {bar:.4f} ({rule}) "
                    f"{'met' if ms <= bar else 'not met'}")
    others = [f"{k[0]} {k[1]} {k[2]} {'inv' if k[3] else 'fwd'} "
              f"{v[0]:.4f} (bound {v[1]:.5f})"
              for k, v in PER_ELEMENT_MS.items()
              if k != "floor" and k not in barred]
    print(f"phase per-element bars (floor {floor}): " + "; ".join(rows)
          + "; other per-element times: " + "; ".join(others), flush=True)


def timing_kernel_b(dev, flush, peaks, d=1, hidden=HIDDEN):
    """At the serving path's shapes: the transform half of a dim-2
    coupling, x_t (1, B) (a transposed view), h_t (128, B), linear tails.
    ``d`` and ``hidden`` give another coupling's (dim 2d, or another trunk
    width)."""
    from nf_tpu_torch.ops import spline_head_fused as shf
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED + 3)
    x_t = _normal(rng, (BATCH, d), 1.5, dev).T
    h_t = _normal(rng, (hidden, BATCH), 1.0, dev)
    m = (3 * K_BINS - 1) * d
    w = _normal(rng, (m, hidden), 0.3 / np.sqrt(hidden), dev)
    b = _normal(rng, (m,), 0.1, dev)
    tb = torch.full((d,), 3.0, device=dev)
    out = {}
    for inverse in (False, True):
        kw = dict(num_bins=K_BINS, tails="linear", inverse=inverse)
        ms = device_ms(lambda: shf.fused_head_rqs(
            x_t, h_t, w, b, tail_bound=3.0, **kw), flush)
        plain = device_ms(lambda: shf.head_rqs_plain(
            x_t, h_t, w, b, tb, **kw), flush)
        nbytes = 4 * (d * BATCH + hidden * BATCH + m * hidden + m + d
                      + 2 * d * BATCH)
        ops = (2 * m * hidden * BATCH
               + tk.rqs_ops_per_element(K_BINS, inverse) * d * BATCH)
        out[inverse] = (ms, plain) + bound(nbytes, ops, peaks)
    return out


def timing_kernel_b_other(dev, flush, peaks):
    """Kernel B at the other shapes of :data:`E_OTHER_SHAPES` (D = 4 and
    hidden 512), B = 65536, K = 8, linear tails: one printed line."""
    out = {(d, h): timing_kernel_b(dev, flush, peaks, d, h)
           for d, h in E_OTHER_SHAPES}
    print("phase timing head_rqs_fwd other shapes (B = 65536, K = 8, "
          "linear): " + "; ".join(_timing_row(f"D = {d}, H = {h}", t)
                                  for (d, h), t in out.items()), flush=True)
    return out


def _cdf_operands(rng, dev, batch=BATCH, d=1):
    """The backward operands of a coupling's CDF: x (B, D), (1, D, K)
    widths and heights, (1, D, K-1) derivatives (linear tails, before the
    padding), cotangents (B, D); the tail bound is 3."""
    x = _normal(rng, (batch, d), 1.5, dev)
    cty, ctl = (_normal(rng, (batch, d), 1.0, dev) for _ in range(2))
    uw, uh = (_normal(rng, (1, d, K_BINS), 0.5, dev) for _ in range(2))
    ud = _normal(rng, (1, d, K_BINS - 1), 0.5, dev)
    return x, uw, uh, ud, cty, ctl


def timing_kernel_c(dev, flush, peaks, shared=True):
    """At the training step's shapes: the backward of a dim-2 coupling's
    CDF, x (B, 1), (1, 1, K) parameters broadcast, tail bound 3,
    cotangents (B, 1). ``shared``: kernel C's shared-parameter path (the
    one the step runs: gx and the row sums), else its per-element path
    (gx and 3K+1 planes)."""
    from nf_tpu_torch.ops import splines, splines_kernel as tk

    rng = np.random.default_rng(SEED + 8)
    x, uw, uh, ud, cty, ctl = _cdf_operands(rng, dev)
    ud = splines.pad_derivatives(ud, "linear", 1e-3, axis=-1)
    small = [t.movedim(-1, 0) for t in (uw, uh, ud)]
    views = [t.expand(t.shape[0], BATCH, 1) for t in small]
    params = 4 * (uw.numel() + uh.numel() + ud.numel())
    out = {}
    for inverse in (False, True):
        if shared:
            ms = device_ms(lambda: tk.rqs_bwd_shared(
                x, *small, 3.0, cty, ctl, inverse=inverse), flush)
            plain = device_ms(lambda: tk.rqs_bwd_shared_plain(
                x, *small, 3.0, cty, ctl, inverse=inverse), flush)
            # x, cty, ctl and the parameters read; gx and the sums written
            nbytes = 4 * 4 * BATCH + 2 * params
            ops = tk.rqs_bwd_shared_ops(K_BINS, inverse, 1, BATCH)
        else:
            ms = device_ms(lambda: tk.rqs_bwd(x, *views, 3.0, cty, ctl,
                                              inverse=inverse), flush)
            plain = device_ms(lambda: tk.rqs_bwd_plain(
                x, *views, 3.0, cty, ctl, inverse=inverse), flush)
            # x, cty, ctl and the parameters read; gx and 3K+1 planes
            nbytes = 4 * (3 + 3 * K_BINS + 2) * BATCH + params
            ops = tk.rqs_bwd_ops_per_element(K_BINS, inverse) * BATCH
        out[inverse] = (ms, plain) + bound(nbytes, ops, peaks)
    return out


def cdf_backward(dev, inverse, batch=BATCH):
    """A function that runs the backward of a coupling's CDF as autograd
    runs it in a training step: ``unconstrained_rational_quadratic_spline``
    at x (B, 1), K = 8, linear tails, tail bound 3, then
    ``torch.autograd.grad`` of (y, ld) into x and the three parameter
    leaves."""
    from nf_tpu_torch.ops import splines

    x, uw, uh, ud, cty, ctl = _cdf_operands(np.random.default_rng(SEED + 15),
                                            dev, batch)
    leaves = [t.requires_grad_() for t in (x, uw, uh, ud)]
    y, ld = splines.unconstrained_rational_quadratic_spline(
        *leaves, inverse=inverse, tails="linear", tail_bound=3.0)
    return lambda: torch.autograd.grad((y, ld), leaves, (cty, ctl),
                                       retain_graph=True)


def device_kernels(fn):
    """The kernels (and memsets and copies) one call of ``fn`` runs on the
    card, from ``torch.profiler``: [(name, device us)]."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start)
            for e in prof.events() if str(e.device_type).endswith("CUDA")]


def _kernel_list(kernels):
    return ", ".join(f"{n[:48]} {us:.2f} us" for n, us in kernels)


def timing_cdf_backward(dev, flush, peaks):
    """The CDF's backward as autograd runs it (:func:`cdf_backward`), both
    directions: device ms, the kernels it launches and its bound (x, cty
    and ctl read, gx written: 16 bytes per element, and the parameters and
    their gradients). Fails if it launches more than two kernels. One
    printed line."""
    from nf_tpu_torch.ops import splines_kernel as tk

    rows = []
    for inverse in (False, True):
        fn = cdf_backward(dev, inverse)
        ms = device_ms(fn, flush)
        names = device_kernels(fn)
        bound_ms, by = bound(
            16 * BATCH + 8 * (3 * K_BINS - 1),
            tk.rqs_bwd_shared_ops(K_BINS, inverse, 1, BATCH), peaks)
        if len(names) > 2:
            raise RuntimeError(f"the CDF's backward launched {len(names)} "
                               f"kernels: {names}")
        rows.append(f"{'inverse' if inverse else 'forward'} device_ms "
                    f"{ms:.4f}, {len(names)} kernels ({_kernel_list(names)}"
                    f" by the profiler), bound_ms {bound_ms:.5f} ({by})")
    print(f"phase timing cdf backward (torch.autograd.grad of a CDF's "
          f"(y, ld) into x and its parameters; x ({BATCH}, 1), K = "
          f"{K_BINS}, linear tails, tb 3): " + "; ".join(rows), flush=True)


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
    out = {(d, h): timing_kernel_e(dev, flush, peaks, d, h)
           for d, h in E_OTHER_SHAPES}
    print("phase timing head_rqs_bwd other shapes (B = 65536, K = 8, "
          "linear): " + "; ".join(_timing_row(f"D = {d}, H = {h}", t)
                                  for (d, h), t in out.items()), flush=True)
    return out


def bound(nbytes, ops, peaks, dtype=torch.float32):
    """The least time in ms: bytes over the memory rate, operations over
    the card's peak for the operands' type (bfloat16 at the tensor cores'
    rate, whatever units the kernel multiplies on), the larger of the
    two, and which one it is."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = ops / peaks[2 if dtype == torch.bfloat16 else 1] * 1e3
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


# the five spline kernels' counters, in the order A, B, C, E, D
SPLINE_KERNELS = ("rqs_fwd", "head_rqs_fwd", "rqs_bwd", "head_rqs_bwd",
                  "rqs_bwd_autodiff")


def reset_counts():
    from nf_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def read_counts():
    """Every kernel's launches counted since the last reset (a CUDA graph
    counts its launches once, at its capture; a replay adds nothing)."""
    from nf_tpu_torch.ops import launch_counts

    return launch_counts()


def perturb(model, seed, size=0.5):
    """Move every weight off the identity init: linear weights by
    N(0, (size/sqrt(fan_in))²), every other float array by N(0, size²)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = size / np.sqrt(p.shape[1]) if (
                p.ndim == 2 and name.endswith("weight")) else size
            noise = np.asarray(rng.standard_normal(tuple(p.shape)) * scale)
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
    step = nt.make_forward_kld_step(opt).eager
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
        got = tuple(per_step[batch][k] for k in SPLINE_KERNELS)
        if got != want:
            raise RuntimeError(f"B={batch}: launches per step (A, B, C, E, D) "
                               f"{got}, expected {want}")

    # 4. guards: skip_nonfinite rolls a NaN batch back bitwise; accum
    gm = copy.deepcopy(model)
    opt = torch.optim.Adam(gm.parameters(), lr=1e-3, capturable=True)
    gstate = nt.init_train_state(gm, opt, with_ema=True)
    guarded = nt.make_forward_kld_step(opt, ema_decay=0.99,
                                       skip_nonfinite=True).eager
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
        nt.make_forward_kld_step(opt, accum_steps=k).eager(
            nt.init_train_state(m, opt), xb)
    accum_err = max(rel_err(a.grad, b.grad) for a, b in
                    zip(accum.parameters(), full.parameters()))
    if not accum_err <= TRAIN_TOL:
        raise RuntimeError(f"accum_steps=2 gradients differ from the full "
                           f"batch's by {accum_err:.3g} (limit {TRAIN_TOL})")

    # 3. and 5.: it trains; ms per step
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    state = nt.init_train_state(model, opt)
    step = nt.make_forward_kld_step(opt).eager
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
          + ", ".join(f"B={b} {tuple(c[k] for k in SPLINE_KERNELS)}"
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
          f"kernel launches per step {sum(c for _, (_, c) in top)}; "
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
        lp_64 = copy.deepcopy(cpu_model).double().log_prob(
            x[:CIRC_CPU_BATCH].double())
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
    step = nt.make_reverse_kld_step(opt, num_samples=z0.shape[0]).eager
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
        step = nt.make_reverse_kld_step(
            opt, num_samples=CIRC_TRAIN_BATCH).eager
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


# --- CUDA graphs (nf_tpu_torch.serving, the captured steps) and bf16 --------

GRAPH_TOL = 1e-6  # graph against eager, serving: abs
STEP_TOL = 1e-5  # graph against eager, loss and parameters after the steps
GRAPH_STEPS = 5
RAGGED = (1, 1000, 40000)
MIXED_LP_TOL = 0.05  # bf16 against f32 log_prob: abs, plus as much relative
MIXED_RT_TOL = 0.02  # bf16 round trips, abs
# the port kernels a graph may launch, by the names the profiler reports
# (C's shared path is two launches, rqs_bwd_shared_blocks and _sum; E's is
# head_rqs_bwd_kernel and reduce_partials)
PATH_KERNELS = {"build_nsf serving": ("rqs_fwd", "head_rqs_fwd"),
                "build_nsf step": ("rqs_fwd", "head_rqs_fwd", "rqs_bwd",
                                   "head_rqs_bwd"),
                "circular serving": ("rqs_fwd",),
                "circular step (analytic)": ("rqs_fwd", "rqs_bwd"),
                "circular step (autodiff)": ("rqs_fwd", "rqs_bwd_autodiff"),
                "conditional serving": ("rqs_fwd", "head_rqs_fwd"),
                "conditional step": ("rqs_fwd", "head_rqs_fwd", "rqs_bwd",
                                     "head_rqs_bwd"),
                "realnvp serving": (), "realnvp step": (),
                "maf serving": (), "maf step": (),
                "image_nsf serving": ("rqs_fwd",),
                "image_nsf step": ("rqs_fwd", "rqs_bwd"),
                "image_nsf step (autodiff)": ("rqs_fwd", "rqs_bwd_autodiff"),
                "bf16 coupled serving": ("rqs_fwd", "head_rqs_fwd"),
                "bf16 coupled step": ("rqs_fwd", "head_rqs_fwd", "rqs_bwd",
                                      "head_rqs_bwd"),
                "bf16 coupled step (autodiff)": ("rqs_fwd", "head_rqs_fwd",
                                                 "rqs_bwd_autodiff",
                                                 "head_rqs_bwd"),
                "bf16 ar_nsf serving": ("rqs_fwd",),
                "bf16 ar_nsf step": ("rqs_fwd", "rqs_bwd"),
                "bf16 ar_nsf step (autodiff)": ("rqs_fwd",
                                                "rqs_bwd_autodiff"),
                "bf16 circular_nsf serving": ("rqs_fwd",),
                "bf16 circular_nsf step": ("rqs_fwd", "rqs_bwd"),
                "bf16 circular_coupled serving": ("rqs_fwd",
                                                  "head_rqs_fwd"),
                "bf16 circular_coupled step": ("rqs_fwd", "head_rqs_fwd",
                                               "rqs_bwd", "head_rqs_bwd"),
                "glow serving": (), "glow step": (),
                "circular_coupled serving": ("rqs_fwd", "head_rqs_fwd"),
                "circular_coupled step": ("rqs_fwd", "head_rqs_fwd",
                                          "rqs_bwd", "head_rqs_bwd"),
                "residual serving": (), "residual step": (),
                "residual sampler": ("fixed_point_cond",),
                "residual reverse step": ("fixed_point_cond",),
                "planar serving": (), "planar step": (),
                "radial serving": (), "radial step": (),
                "change_base serving": (), "change_base step": (),
                "snf serving": (), "snf step": (),
                "snf_nsf serving": ("rqs_fwd", "head_rqs_fwd"),
                "snf_nsf step": ("rqs_fwd", "head_rqs_fwd", "rqs_bwd",
                                 "head_rqs_bwd"),
                "nsf reverse step": ("rqs_fwd", "head_rqs_fwd", "rqs_bwd",
                                     "head_rqs_bwd"),
                "hais serving": (), "vae step": (),
                "sharded forward step": ("rqs_fwd", "head_rqs_fwd",
                                         "rqs_bwd", "head_rqs_bwd"),
                "sharded reverse step": ("rqs_fwd", "head_rqs_fwd",
                                         "rqs_bwd", "head_rqs_bwd")}


def kernel_of(name):
    """The port kernel a profiled device function belongs to, or None."""
    if "head_rqs_fwd" in name:
        return "head_rqs_fwd"
    if "head_rqs_bwd" in name or "reduce_partials" in name:
        return "head_rqs_bwd"
    if "AutodiffMath" in name:
        return "rqs_bwd_autodiff"
    if "rqs_bwd" in name:
        return "rqs_bwd"
    if "rqs_fwd" in name:
        return "rqs_fwd"
    if "fixed_point_cond" in name:
        return "fixed_point_cond"
    return None


def replay_report(fn, path, tries=3):
    """One profiled call of ``fn`` (a replay): wall and busy ms, the idle
    share, the device launches of each port kernel by the profiler, all
    device launches, host syncs of another call. Fails unless the call
    launched every kernel of ``PATH_KERNELS[path]``, no other port kernel,
    and synchronised nothing. A replay runs the launches of its capture
    every time, so a profile that misses them is the profiler's: once
    (PR 9) it recorded no port kernel of a replay whose capture counted
    them, and the profile is taken again, up to ``tries`` times; the
    report says how many it took."""
    syncs = host_syncs(fn)
    for attempt in range(1, tries + 1):
        wall, busy, top = profile_call(fn)
        ours = {}
        for name, (_, count) in top:
            k = kernel_of(name)
            if k is not None:
                ours[k] = ours.get(k, 0) + count
        if set(ours) == set(PATH_KERNELS[path]):
            break
    else:
        raise RuntimeError(f"{path}: {tries} profiled replays launched port "
                           f"kernels {ours}, expected "
                           f"{PATH_KERNELS[path]}; the last saw "
                           f"{len(top)} kernels: "
                           + "; ".join(n[:48] for n, _ in top[:8]))
    if syncs:
        raise RuntimeError(f"{path}: {len(syncs)} host syncs in a replay: "
                           f"{syncs[0][:200]}")
    return dict(wall=wall, busy=busy, idle=1 - busy / wall, kernels=ours,
                launches=sum(c for _, (_, c) in top), syncs=len(syncs),
                top=top, profiles=attempt)


def _report_text(r):
    again = (f" (profiled {r['profiles']} times: the earlier profiles "
             f"missed the port kernels)" if r["profiles"] > 1 else "")
    return (f"profiled replay{again}: wall {r['wall']:.3f} ms, device busy "
            f"{r['busy']:.3f} ms, idle {r['idle']:.1%}, {r['launches']} "
            f"device launches, port kernels by the profiler {r['kernels']}, "
            f"host syncs {r['syncs']}; top: "
            + "; ".join(f"{n[:44]} {t:.3f} x{c}"
                        for n, (t, c) in r["top"][:5]))


def in_turns(eager, graph, reps=10):
    """Wall ms (median of ``reps`` synchronised calls) of ``eager`` and
    ``graph`` in turns: eager, graph, graph, eager."""
    e1 = host_ms(eager, reps)
    g1 = host_ms(graph, reps)
    g2 = host_ms(graph, reps)
    e2 = host_ms(eager, reps)
    return (e1, e2), (g1, g2)


def _turns_text(t, what="call", reps=10):
    (e1, e2), (g1, g2) = t
    return (f"wall ms per {what} (median of {reps}, in turns eager, graph, "
            f"graph, eager): eager {e1:.3f} / {e2:.3f}, graph {g1:.3f} / "
            f"{g2:.3f}")


def _circular_model(mixed=False):
    """``build_circular_nsf`` at its defaults, perturbed as in the
    circular serving phase; ``mixed`` the same weights with bf16 MADEs."""
    import nf_tpu_torch as nt

    model = nt.build_circular_nsf(seed=SEED)
    perturb(model, SEED + 20)
    if not mixed:
        return model
    f32 = model.state_dict()
    mp = nt.build_circular_nsf(seed=SEED, mixed_precision=True)
    mp.load_state_dict({k: f32[k.replace(".net.", ".")]
                        for k in mp.state_dict()})
    return mp


def _nsf_model(mixed=False):
    import nf_tpu_torch as nt

    model = nt.build_nsf(dim=2, K=8, hidden=HIDDEN, num_bins=K_BINS,
                         num_blocks=2, tail_bound=3.0,
                         mixed_precision=mixed)
    perturb(model, SEED)
    return model


def _expect_launches(got, want, what):
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise RuntimeError(f"{what}: the capture counted {got}, expected "
                           f"{full}")


def serving_graphs(label, model, x, batch, per_pass, path, context=None,
                   dtype=torch.float32, sample_path=None):
    """``compile_log_prob`` and ``compile_sampler`` of ``model`` at
    ``batch`` against eager calls: log_prob within GRAPH_TOL, the sampler
    bitwise; times in turns; a profiled replay of each. ``per_pass``: the
    launches the log_prob capture must count (the sampler's: twice A for
    the circular NSF, as its eager pass). ``context``: a conditional
    model's, an input of both graphs. ``dtype``: the log_prob graph's
    input's. ``sample_path``: the sampler's ``PATH_KERNELS`` entry where
    it launches other port kernels than ``log_prob`` (None: ``path``)."""
    import nf_tpu_torch as nt

    ctx = () if context is None else (context,)
    ctx_kw = {} if context is None else dict(context=context)
    ctx_shape = None if context is None else tuple(context.shape)
    out = {}
    lp_fn = nt.compile_log_prob(model, (batch, 2), context_shape=ctx_shape,
                                dtype=dtype)
    _expect_launches(lp_fn.launches, per_pass, f"{label} log_prob graph")

    def eager_lp():
        with torch.inference_mode():
            return model.log_prob(x, **ctx_kw)

    lp_err = max_err(lp_fn(x, *ctx).float(), eager_lp().float())
    if not lp_err <= GRAPH_TOL:
        raise RuntimeError(f"{label} log_prob: graph vs eager {lp_err:.3g} "
                           f"> {GRAPH_TOL}")
    out["log_prob"] = dict(err=lp_err, turns=in_turns(
        eager_lp, lambda: lp_fn(x, *ctx)),
        report=replay_report(lambda: lp_fn(x, *ctx), path),
        launches=lp_fn.launches, fn=lp_fn)
    sampler = nt.compile_sampler(model, batch, context_shape=ctx_shape)
    for seed in (SEED, SEED + 1):
        z, log_q = sampler(seed, *ctx)
        with torch.inference_mode():
            ze, lqe = model.sample(batch, generator=torch.Generator(
                "cuda").manual_seed(seed), **ctx_kw)
        if not (torch.equal(z, ze) and torch.equal(log_q, lqe)):
            raise RuntimeError(f"{label} sample: the graph's draws for seed "
                               f"{seed} differ from eager "
                               f"({max_err(z, ze):.3g})")
    gen = torch.Generator("cuda").manual_seed(SEED)

    def eager_sample():
        with torch.inference_mode():
            return model.sample(batch, generator=gen, **ctx_kw)

    out["sample"] = dict(err=0.0, turns=in_turns(
        eager_sample, lambda: sampler(SEED, *ctx)),
        report=replay_report(lambda: sampler(SEED, *ctx),
                             sample_path or path),
        launches=sampler.launches, fn=sampler)
    for what, r in out.items():
        err = "bitwise" if what == "sample" else f"{r['err']:.3g}"
        print(f"phase graphs {label} {what} (B = {batch}): graph vs eager "
              f"{err}; "
              f"capture counted {r['launches']}; "
              + _turns_text(r["turns"]) + "; " + _report_text(r["report"]),
              flush=True)
    return out


def _memory_of(build):
    """(result, peak bytes allocated while ``build`` ran, bytes reserved
    after it), both above what was in use before."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    out = build()
    torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated() - alloc0,
            torch.cuda.memory_reserved() - res0)


def bucket_graphs(label, model, batch, context=None):
    """``compile_log_prob_buckets`` up to ``batch`` at the ragged sizes:
    each against eager on the same padded bucket (GRAPH_TOL) and on the
    request (MODEL_TOL); wall ms per request, graph and eager; the
    ladder's memory against one graph's. ``context``: ``batch`` rows of a
    conditional model's context, padded as ``x`` is."""
    import nf_tpu_torch as nt

    row = None if context is None else tuple(context.shape[1:])
    ladder, peak, reserved = _memory_of(
        lambda: nt.compile_log_prob_buckets(model, batch, (2,),
                                            context_shape=row))
    one, peak1, reserved1 = _memory_of(
        lambda: nt.compile_log_prob(
            model, (batch, 2),
            context_shape=None if row is None else (batch,) + row))
    del one
    rng = np.random.default_rng(SEED + 40)
    rows = []
    for n in RAGGED:
        x = _normal(rng, (n, 2), 1.5, "cuda")
        ctx = () if context is None else (context[:n],)
        b = next(b for b in ladder.buckets if b >= n)
        padded = [torch.cat([t, t[-1:].expand(b - n, *t.shape[1:])])
                  for t in (x,) + ctx]
        with torch.inference_mode():
            want = model.log_prob(*padded)[:n]
            plain = model.log_prob(x, *ctx)
        got = ladder(x, *ctx)
        err, err_req = max_err(got, want), max_err(got, plain)
        if got.shape != (n,) or not (err <= GRAPH_TOL
                                     and err_req <= MODEL_TOL):
            raise RuntimeError(f"{label} buckets n={n}: shape "
                               f"{tuple(got.shape)}, vs eager on bucket "
                               f"{b} {err:.3g}, on the request {err_req:.3g}")

        def eager():
            with torch.inference_mode():
                return model.log_prob(x, *ctx)

        t = in_turns(eager, lambda: ladder(x, *ctx))
        rows.append(f"n={n} (bucket {b}): vs eager {err:.3g}, vs eager "
                    f"on the request {err_req:.3g}; " + _turns_text(t))
    print(f"phase graphs {label} buckets ({len(ladder.buckets)} buckets "
          f"up to {batch}): " + "; ".join(rows)
          + f"; memory: ladder peak {peak / 2**20:.1f} MiB allocated while "
          f"capturing, {reserved / 2**20:.1f} MiB reserved after; one "
          f"graph at {batch}: peak {peak1 / 2**20:.1f} MiB, "
          f"{reserved1 / 2**20:.1f} MiB reserved", flush=True)
    return ladder


def step_graphs(label, base, make_step, args_of, path, opt_kw, mode=None,
                check=None, reps=10):
    """A captured step against the eager step on twin copies of ``base``:
    GRAPH_STEPS steps each on the same inputs (``args_of(i, which)``), the
    loss every step and the parameters and float buffers (a residual
    flow's power-iteration vectors) after within STEP_TOL, and
    ``check(graphed model, eager model)`` where given (it raises or
    returns a note); then wall ms per step in turns (``reps`` steps a
    turn) and a profiled replay."""
    from nf_tpu_torch.ops import splines_kernel as tk
    import nf_tpu_torch as nt

    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [torch.optim.Adam(m.parameters(), capturable=True, **opt_kw)
            for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    graphed = make_step(opts[0])
    eager = make_step(opts[1]).eager
    if mode is not None:
        tk.set_pallas_bwd_kernel(mode)
    try:
        loss_err, finite = 0.0, True
        for i in range(GRAPH_STEPS):
            lg = graphed(states[0], *args_of(i, 0))
            le = eager(states[1], *args_of(i, 1))
            loss_err = max(loss_err, max_err(lg, le))
            finite = finite and bool(torch.isfinite(lg) & torch.isfinite(le))
        param_err = max(max_err(p.detach(), q.detach()) for p, q in
                        zip(models[0].parameters(), models[1].parameters()))
        param_err = max([param_err] + [
            max_err(p, q) for p, q in zip(models[0].buffers(),
                                          models[1].buffers())
            if p.is_floating_point()])
        if not (finite and loss_err <= STEP_TOL and param_err <= STEP_TOL):
            raise RuntimeError(f"{label}: graph vs eager over "
                               f"{GRAPH_STEPS} steps: loss {loss_err:.3g} "
                               f"(all finite: {finite}), "
                               f"parameters {param_err:.3g} (limit "
                               f"{STEP_TOL})")
        note = "" if check is None else "; " + check(*models)
        i = [GRAPH_STEPS]

        def run(step, state, which):
            def call():
                i[0] += 1
                return step(state, *args_of(i[0], which))
            return call

        t = in_turns(run(eager, states[1], 1), run(graphed, states[0], 0),
                     reps)
        report = replay_report(run(graphed, states[0], 0), path)
    finally:
        tk.set_pallas_bwd_kernel("analytic")
    print(f"phase graphs {label}: graph vs eager after {GRAPH_STEPS} "
          f"steps: loss {loss_err:.3g}, parameters {param_err:.3g} (limit "
          f"{STEP_TOL}){note}; capture counted {graphed.launches}; "
          + _turns_text(t, "step", reps) + "; " + _report_text(report),
          flush=True)
    return dict(turns=t, report=report, launches=graphed.launches,
                err=(loss_err, param_err))


def gate_graphs(model, dev, flush):
    """The fused-head gate under graphs: one coupling's transform half,
    fused (kernel B) and unfused (``torch.matmul`` head, kernel A), each
    captured as a graph at each B*D; device ms of a replay."""
    from nf_tpu_torch._graphs import capture, warm_up
    from nf_tpu_torch.flows.neural_spline.feed import FusedFeed

    prqct = model.flows[0].prqct
    net = prqct.transform_net
    rng = np.random.default_rng(SEED + 5)
    rows = []
    for batch in (1024, 2048, 4096, 8192, 16384, 65536):
        x = _normal(rng, (batch, 2), 1.5, dev)
        id_split, t_split = prqct._split(x)
        times = {}
        for way, run in (
                ("fused", lambda: prqct._coupling_transform(
                    t_split, FusedFeed(net.features_transposed(id_split)),
                    False)),
                ("unfused", lambda: prqct._coupling_transform(
                    t_split, net(id_split), False))):
            with torch.no_grad():
                warm_up(run, dev, 2)
                graph, _, _ = capture(run, dev)
            times[way] = device_ms(graph.replay, flush)
        rows.append(f"B*D={batch}: fused {times['fused']:.4f} ms, unfused "
                    f"{times['unfused']:.4f} ms")
    print("phase graphs gate (one coupling's transform half as a graph, "
          "device ms of a replay): " + "; ".join(rows), flush=True)


def dependency_types(graph):
    """``{"default": n, "programmatic": m}``: the edges of ``graph`` (a
    ``torch.cuda.CUDAGraph`` built with ``keep_graph=True``) by the type
    of their dependency, read with the driver's ``cuGraphGetEdges_v2``. A
    programmatic edge is what stream capture makes of a launch with
    ``cudaLaunchAttributeProgrammaticStreamSerialization`` (kernel C's
    shared-parameter sum, ``csrc/rqs_bwd.cu``)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetEdges_v2(raw, None, None, None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetEdges_v2 failed: CUresult {err}")
    nodes = (ctypes.c_void_p * n.value)
    # CUgraphEdgeData: from_port, to_port, type, reserved[5]
    data = (ctypes.c_uint8 * (8 * n.value))()
    err = cu.cuGraphGetEdges_v2(raw, nodes(), nodes(), data, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetEdges_v2 failed: CUresult {err}")
    kinds = [data[8 * i + 2] for i in range(n.value)]
    return {"default": kinds.count(0), "programmatic": kinds.count(1)}


def graph_kernel_names(graph):
    """The kernels of ``graph`` (a ``torch.cuda.CUDAGraph`` built with
    ``keep_graph=True``), in node order, by their mangled names, read with
    libcuda (``cuGraphKernelNodeGetParams_v2``, then ``cuFuncGetName`` or
    ``cuKernelGetName``); a node of another type appears as
    ``"<type N>"``. A bfloat16 instantiation of a port kernel carries
    ``__nv_bfloat16`` in its name, and PyTorch's casts
    ``direct_copy_kernel``."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if not err:
        err = cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        if err:
            break
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        err = cu.cuGraphNodeGetType(node, ctypes.byref(kind))
        if err or kind.value != 0:
            names.append(f"<type {kind.value}>")
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func, grid and block dims and shared
        # bytes (7 uint), kernelParams, extra, kern, ctx
        params = (ctypes.c_uint64 * 9)()
        err = cu.cuGraphKernelNodeGetParams_v2(node, params)
        name = ctypes.c_char_p()
        if not err:
            func, kern = params[0], params[7]
            err = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func))
                   if func else cu.cuKernelGetName(ctypes.byref(name),
                                                   ctypes.c_void_p(kern)))
        names.append(name.value.decode() if not err and name.value else "?")
    if err:
        raise RuntimeError(f"reading the graph's kernel nodes failed: "
                           f"CUresult {err}")
    return names


def captured_kernel_names(fn, warm=1):
    """:func:`graph_kernel_names` of one call of ``fn`` captured into a
    kept graph after ``warm`` eager calls on a side stream."""
    from nf_tpu_torch._graphs import warm_up

    warm_up(fn, torch.device("cuda"), warm)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph_kernel_names(graph)


def programmatic_edges(model, batch):
    """Capture one eager forward-KLD step of ``model`` after two warm-up
    steps, with the graph kept: its edges by type (kernel C's
    shared-parameter sum is a programmatic dependent launch, one per
    coupling's CDF)."""
    from nf_tpu_torch._graphs import warm_up
    import nf_tpu_torch as nt

    m = copy.deepcopy(model)
    opt = torch.optim.Adam(m.parameters(), lr=1e-3, capturable=True)
    state = nt.init_train_state(m, opt)
    eager = nt.make_forward_kld_step(opt).eager
    warm_up(lambda: eager(state, batch), batch.device, 2)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.device(batch.device), torch.cuda.graph(graph):
        eager(state, batch)
    return dependency_types(graph)


def _captured_counts(served):
    """The launches of one replay of each graph of ``serving_graphs``
    (its log_prob and its sampler), summed by kernel."""
    lp, smp = served["log_prob"]["launches"], served["sample"]["launches"]
    return {k: lp[k] + smp[k] for k in lp}


def phase_graphs(dev, flush):
    """Serving and the training steps as CUDA graphs at full width against
    eager. Returns {path: launches of one replay of each of its graphs},
    counted at their captures (the profiled replays show what the device
    ran)."""
    import nf_tpu_torch as nt

    paths = {}
    # build_nsf serving, the LU cache, the ragged ladder, the gate
    model = _nsf_model()
    x = _normal(np.random.default_rng(SEED + 4), (BATCH, 2), 1.5, dev)
    paths["build_nsf serving"] = _captured_counts(serving_graphs(
        "build_nsf", model, x, BATCH, {"rqs_fwd": 8, "head_rqs_fwd": 8},
        "build_nsf serving"))
    cached = copy.deepcopy(model)
    for flow in cached.flows:
        if hasattr(flow, "linear"):
            flow.linear = flow.linear.with_cache()
    fn, fc = (nt.compile_log_prob(m, (BATCH, 2)) for m in (model, cached))
    cache_err = max_err(fc(x), fn(x))
    (u1, u2), (c1, c2) = in_turns(lambda: fn(x), lambda: fc(x))
    print(f"phase graphs build_nsf LU cache (with_cache on every "
          f"LULinear): log_prob vs uncached {cache_err:.3g}; graph wall "
          f"ms per call (in turns) uncached {u1:.3f} / {u2:.3f}, cached "
          f"{c1:.3f} / {c2:.3f}; device ms uncached "
          f"{device_ms(lambda: fn(x), flush):.4f}, cached "
          f"{device_ms(lambda: fc(x), flush):.4f}", flush=True)
    if not cache_err <= MODEL_TOL:
        raise RuntimeError(f"LU cache: log_prob moved by {cache_err:.3g}")
    del fn, fc
    bucket_graphs("build_nsf", model, BATCH)
    gate_graphs(model, dev, flush)

    # build_nsf forward-KLD step, Adam(capturable=True)
    target = nt.TwoMoons()
    pool = target.sample(40 * BATCH, generator=torch.Generator(
        device=dev).manual_seed(SEED + 10))

    def batch_of(i, which):
        return (pool[(i % 40) * BATCH:(i % 40 + 1) * BATCH],)

    step = step_graphs("build_nsf forward-KLD step", model,
                       nt.make_forward_kld_step, batch_of,
                       "build_nsf step", dict(lr=1e-3))
    _expect_launches(step["launches"], {"rqs_fwd": 8, "head_rqs_fwd": 8,
                                        "rqs_bwd": 8, "head_rqs_bwd": 8},
                     "build_nsf step graph")
    paths["build_nsf step"] = step["launches"]
    edges = programmatic_edges(model, pool[:BATCH])
    if edges["programmatic"] != 8:
        raise RuntimeError(f"kernel C's programmatic launches: the captured "
                           f"step's edges {edges}, expected 8 programmatic")
    print(f"phase graphs kernel C programmatic launch under capture: the "
          f"step graph's edges {edges} (one programmatic edge per CDF "
          f"backward, 8 expected)", flush=True)

    # circular NSF serving and its reverse-KLD step under C and D
    circ = _circular_model()
    rng = np.random.default_rng(SEED + 21)
    xc = np.stack([rng.uniform(-np.pi, np.pi, CIRC_BATCH),
                   rng.standard_normal(CIRC_BATCH) * 1.5], axis=1)
    xc = torch.from_numpy(xc.astype(np.float32)).to(dev)
    paths["circular serving"] = _captured_counts(serving_graphs(
        "circular", circ, xc, CIRC_BATCH, {"rqs_fwd": 12},
        "circular serving"))
    bucket_graphs("circular", circ, CIRC_BATCH)
    circ.p = GaussVonMises()
    for mode, kernel in (("analytic", "rqs_bwd"),
                         ("autodiff", "rqs_bwd_autodiff")):
        gens = [torch.Generator(device=dev).manual_seed(SEED + 32)
                for _ in range(2)]
        step = step_graphs(
            f"circular reverse-KLD step ({mode}, B = {CIRC_TRAIN_BATCH})",
            circ, lambda opt: nt.make_reverse_kld_step(
                opt, num_samples=CIRC_TRAIN_BATCH),
            lambda i, which: (gens[which],),
            f"circular step ({mode})", dict(lr=5e-4), mode)
        _expect_launches(step["launches"], {"rqs_fwd": 24, kernel: 24},
                         f"circular step graph ({mode})")
        paths[f"circular step ({mode})"] = step["launches"]
    return paths


def phase_mixed(dev, flush):
    """``mixed_precision=True``: the circular NSF under graphs against the
    same weights in f32 (log_prob within MIXED_LP_TOL abs plus as much
    relative, the JAX package's bar; round trips within MIXED_RT_TOL), ms
    per call and per reverse-KLD step against the f32 graphs in turns;
    ``build_nsf`` at B = 65536, whose couplings take the fused head with
    the f32 trunk: log_prob bitwise the f32 model's."""
    import nf_tpu_torch as nt

    f32, mp = _circular_model(), _circular_model(mixed=True)
    rng = np.random.default_rng(SEED + 21)
    xc = np.stack([rng.uniform(-np.pi, np.pi, CIRC_BATCH),
                   rng.standard_normal(CIRC_BATCH) * 1.5], axis=1)
    xc = torch.from_numpy(xc.astype(np.float32)).to(dev)
    lp32_fn = nt.compile_log_prob(f32, (CIRC_BATCH, 2))
    lp_fn = nt.compile_log_prob(mp, (CIRC_BATCH, 2))
    lp32, lp = lp32_fn(xc), lp_fn(xc)
    with torch.inference_mode():
        eager_err = max_err(lp, mp.log_prob(xc))
        x_back = mp.forward(mp.inverse(xc))
    d = x_back - xc
    d[:, 0] = torch.remainder(d[:, 0] + np.pi, 2 * np.pi) - np.pi
    rt = float(d.abs().max())
    diff = (lp - lp32).abs()
    lp_abs = float(diff.max())
    beyond = float((diff > MIXED_LP_TOL).float().mean())
    within = bool((diff <= MIXED_LP_TOL + MIXED_LP_TOL * lp32.abs()).all())
    if not (within and rt <= MIXED_RT_TOL and eager_err <= GRAPH_TOL):
        raise RuntimeError(f"mixed precision circular: log_prob vs f32 max "
                           f"{lp_abs:.3g} (within abs+rel "
                           f"{MIXED_LP_TOL}: {within}), round trip "
                           f"{rt:.3g} (limit {MIXED_RT_TOL}), graph vs "
                           f"eager {eager_err:.3g}")
    s32, smp = (nt.compile_sampler(m, CIRC_BATCH) for m in (f32, mp))
    t_lp = in_turns(lambda: lp32_fn(xc), lambda: lp_fn(xc))
    t_s = in_turns(lambda: s32(SEED), lambda: smp(SEED))
    dev_lp = (device_ms(lambda: lp32_fn(xc), flush),
              device_ms(lambda: lp_fn(xc), flush))
    report = replay_report(lambda: lp_fn(xc), "circular serving")
    mp.p = f32.p = GaussVonMises()
    gens = [torch.Generator(device=dev).manual_seed(SEED + 33)
            for _ in range(2)]
    steps = []
    for m, g in ((f32, gens[0]), (mp, gens[1])):
        opt = torch.optim.Adam(m.parameters(), lr=5e-4, capturable=True)
        st = nt.init_train_state(m, opt)
        step = nt.make_reverse_kld_step(opt, num_samples=CIRC_TRAIN_BATCH)
        steps.append(lambda step=step, st=st, g=g: step(st, g))
        for _ in range(3):  # two eager warm-up steps, then the capture
            steps[-1]()
    t_step = in_turns(*steps)
    step_report = replay_report(steps[1], "circular step (analytic)")
    (a1, a2), (b1, b2) = t_lp
    (c1, c2), (d1, d2) = t_s
    (e1, e2), (f1, f2) = t_step
    print(f"phase mixed circular (bf16 MADEs, graphs, B = {CIRC_BATCH}): "
          f"log_prob vs f32 max abs {lp_abs:.3g}, {beyond:.2%} of rows "
          f"beyond {MIXED_LP_TOL} abs, all within {MIXED_LP_TOL} abs + "
          f"{MIXED_LP_TOL} relative; round trip {rt:.3g} (limit "
          f"{MIXED_RT_TOL}); graph vs eager {eager_err:.3g}; wall ms (in "
          f"turns f32, bf16, bf16, f32): log_prob f32 {a1:.3f} / {a2:.3f}, "
          f"bf16 {b1:.3f} / {b2:.3f}; sample f32 {c1:.3f} / {c2:.3f}, bf16 "
          f"{d1:.3f} / {d2:.3f}; reverse-KLD step (B = {CIRC_TRAIN_BATCH}) "
          f"f32 {e1:.3f} / {e2:.3f}, bf16 {f1:.3f} / {f2:.3f}; device ms "
          f"log_prob f32 {dev_lp[0]:.4f}, bf16 {dev_lp[1]:.4f}; bf16 "
          f"log_prob " + _report_text(report) + "; bf16 step "
          + _report_text(step_report), flush=True)

    n32, nmp = _nsf_model(), _nsf_model(mixed=True)
    x = _normal(np.random.default_rng(SEED + 4), (BATCH, 2), 1.5, dev)
    fn32, fnmp = (nt.compile_log_prob(m, (BATCH, 2)) for m in (n32, nmp))
    same = torch.equal(fnmp(x), fn32(x))
    with torch.inference_mode():
        same_eager = torch.equal(nmp.log_prob(x), n32.log_prob(x))
    if not (same and same_eager):
        raise RuntimeError("build_nsf(mixed_precision=True) at B = 65536: "
                           "log_prob differs from the f32 model's; its "
                           "couplings should take the fused head with the "
                           "f32 trunk")
    (g1, g2), (h1, h2) = in_turns(lambda: fn32(x), lambda: fnmp(x))
    print(f"phase mixed build_nsf (mixed_precision=True, B = {BATCH}): "
          f"log_prob bitwise the f32 model's, eager and graph (the fused "
          f"head keeps the f32 trunk); graph wall ms f32 {g1:.3f} / "
          f"{g2:.3f}, mixed {h1:.3f} / {h2:.3f}", flush=True)


# --- the conditional NSF, RealNVP and MAF (phases 12-14) --------------------

COND_HIDDEN, COND_LAYERS = 64, 4  # build_conditional_nsf's defaults
COND_STEPS = 50
COND_LR = 3e-3  # examples/conditional_flow.py
CPU_ROWS = BATCH  # rows of a full-size batch held against the CPU
RNVP_TRAIN_BATCH = 16384
RNVP_ANNEAL = 1000  # examples/real_nvp.py: half of its 2000 iterations
# the reference notebook's rate at K = 64 (examples/real_nvp.py takes 1e-3
# at K = 16); at 1e-3 Adam's first step, which moves every weight of the
# perturbed K = 64 model by ~1e-3, sends the samples to 1e11 by layer 112
RNVP_LR = 1e-4
BENCH_K, BENCH_HIDDEN = 16, 128  # bench.py's recipe


def cond_contexts(gen, n):
    """Contexts as ``examples/conditional_flow.py:24-28`` draws them: a
    mean U(-1, 1)² and a std 0.5 + U(0, 1)², on ``gen``'s device."""
    u = torch.rand((n, 4), generator=gen, device=gen.device)
    return torch.cat([2.0 * u[:, :2] - 1.0, 0.5 + u[:, 2:]], dim=1)


def parity_b_e_hidden(dev, hidden=COND_HIDDEN):
    """Kernels B and E at a conditional coupling's shapes: D = 1, H =
    ``hidden`` (half of the first 128-column W_eff tile at 64), K = 8,
    linear tails, tail bound 3, x_t and cty as transposed (B, 1) views, at
    B = 65536 and a ragged B, both spline directions. B against
    ``head_rqs_plain`` (y, ld abs), E against ``head_rqs_bwd_plain`` (gx,
    gh abs; gW, gb relative to their largest magnitude). Returns
    {"y", "ld", "grad", "sums"}: the largest errors, and the case count."""
    from nf_tpu_torch.ops import spline_head_fused as shf

    rng = np.random.default_rng(SEED + 51)
    worst = dict(y=0.0, ld=0.0, grad=0.0, sums=0.0)
    cases = 0
    m = 3 * K_BINS - 1
    for batch in PARITY_BATCHES:
        x_t = _normal(rng, (batch, 1), 2.0, dev).T
        cty = _normal(rng, (batch, 1), 1.0, dev).T
        ctl = _normal(rng, (1, batch), 1.0, dev)
        h_t = _normal(rng, (hidden, batch), 1.0, dev)
        w = _normal(rng, (m, hidden), 0.3 / np.sqrt(hidden), dev)
        b = _normal(rng, (m,), 0.1, dev)
        tb = torch.full((1,), 3.0, device=dev)
        for inverse in (False, True):
            kw = dict(num_bins=K_BINS, tails="linear", inverse=inverse)
            y, ld = shf.fused_head_rqs(x_t, h_t, w, b, tail_bound=tb, **kw)
            yp, lp = shf.head_rqs_plain(x_t, h_t, w, b, tb, **kw)
            gx, gh, gw, gb = shf.fused_head_rqs_bwd(x_t, h_t, w, b, tb, cty,
                                                    ctl, **kw)
            px, ph, pw, pb = shf.head_rqs_bwd_plain(x_t, h_t, w, b, tb, cty,
                                                    ctl, **kw)
            torch.cuda.synchronize()
            worst["y"] = max(worst["y"], max_err(y, yp))
            worst["ld"] = max(worst["ld"], max_err(ld, lp))
            worst["grad"] = max(worst["grad"], max_err(gx, px),
                                max_err(gh, ph))
            worst["sums"] = max(worst["sums"], rel_err(gw, pw),
                                rel_err(gb, pb))
            cases += 1
    return worst, cases


def _batch_cpu(batch):
    return tuple(t.cpu() for t in batch)


def phase_conditional(dev, flush, peaks):
    """``build_conditional_nsf`` at its defaults (dim 2, context 4, K 4,
    hidden 64, 8 bins, 2 blocks), perturbed, on contexts drawn as the
    example draws them: kernels B and E at H = 64, serving and the
    forward-KLD step eagerly (card against CPU, launches per pass and per
    step, 50 steps whose loss falls), then under graphs. Returns {path:
    launches}."""
    import nf_tpu_torch as nt

    worst, cases = parity_b_e_hidden(dev)
    limits = dict(y=Y_TOL, ld=LD_TOL, grad=G_TOL, sums=SUM_TOL)
    if not all(worst[k] <= limits[k] for k in limits):
        raise RuntimeError(f"kernels B and E at H = {COND_HIDDEN} disagree "
                           f"with their plain versions: {worst} (limits "
                           f"{limits})")
    t_b = timing_kernel_b(dev, flush, peaks, 1, COND_HIDDEN)
    t_e = timing_kernel_e(dev, flush, peaks, 1, COND_HIDDEN)
    print(f"phase conditional kernels at H = {COND_HIDDEN} (D = 1, K = "
          f"{K_BINS}, linear, B = {PARITY_BATCHES}): {cases} cases, B vs "
          f"head_rqs_plain y {worst['y']:.3g} (limit {Y_TOL}), ld "
          f"{worst['ld']:.3g} (limit {LD_TOL}); E vs head_rqs_bwd_plain "
          f"gx, gh {worst['grad']:.3g} (limit {G_TOL}), gW, gb "
          f"{worst['sums']:.3g} relative (limit {SUM_TOL}); timing at B = "
          f"{BATCH}: " + _timing_row("head_rqs_fwd", t_b) + "; "
          + _timing_row("head_rqs_bwd", t_e), flush=True)

    layers = COND_LAYERS
    model = nt.build_conditional_nsf(
        seed=SEED, target=nt.ConditionalDiagGaussianTarget())
    perturb(model, SEED + 50)
    cpu_model = copy.deepcopy(model).to("cpu")
    gen = torch.Generator(device=dev).manual_seed(SEED + 52)
    ctx = cond_contexts(gen, BATCH)
    x = model.p.sample(BATCH, generator=gen, context=ctx)
    counts = {}
    with torch.inference_mode():
        lp = _counted(counts, "log_prob", lambda: model.log_prob(
            x, context=ctx))
        z, log_q = _counted(counts, "sample", lambda: model.sample(
            BATCH, generator=gen, context=ctx))
        lp_s = model.log_prob(z, context=ctx)
        z_back = model.inverse(model.forward(z, context=ctx), context=ctx)
        torch.cuda.synchronize()
        identity = model.q0.log_prob(x)
    per_pass = {"rqs_fwd": layers, "head_rqs_fwd": layers}
    _expect(counts, {"log_prob": per_pass, "sample": per_pass},
            "conditional serving")
    with torch.inference_mode():
        lp_cpu = cpu_model.log_prob(x[:CPU_ROWS].cpu(),
                                    context=ctx[:CPU_ROWS].cpu())
    errs = {f"log_prob cuda vs cpu (first {CPU_ROWS})": max_err(
                lp[:CPU_ROWS].cpu(), lp_cpu),
            "log_prob(sample) vs log_q": max_err(lp_s, log_q),
            "inverse(forward(z)) vs z": max_err(z_back, z)}
    for t in (lp, z, log_q, lp_s):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite values on the conditional "
                               "serving path")
    if z.shape != (BATCH, 2) or lp.shape != (BATCH,):
        raise RuntimeError(f"shapes: sample {tuple(z.shape)}, log_prob "
                           f"{tuple(lp.shape)}")
    for k, v in errs.items():
        if not v <= MODEL_TOL:
            raise RuntimeError(f"conditional serving: {k} {v:.3g} > "
                               f"{MODEL_TOL}")
    if max_err(lp, identity) < 0.1:
        raise RuntimeError("the perturbed conditional model is still the "
                           "identity")
    with torch.inference_mode():
        lp_ms = host_ms(lambda: model.log_prob(x, context=ctx))
        sample_ms = host_ms(lambda: model.sample(BATCH, generator=gen,
                                                 context=ctx))
    print(f"phase conditional serving: build_conditional_nsf defaults "
          f"(dim 2, context 4, K={layers}, hidden={COND_HIDDEN}, "
          f"bins={K_BINS}) B={BATCH}; launches per pass {counts}; errors "
          + ", ".join(f"{k} {v:.3g} (limit {MODEL_TOL})"
                      for k, v in errs.items())
          + f"; eager log_prob {lp_ms:.3f} ms/call, sample {sample_ms:.3f} "
          f"ms/call", flush=True)
    serving = {k: counts["log_prob"][k] + counts["sample"][k]
               for k in counts["log_prob"]}

    # the forward-KLD step: one step card against CPU, launches per step
    grad_errs, per_step = {}, {}
    expect = {8192: dict(rqs_fwd=layers, head_rqs_fwd=layers,
                         rqs_bwd=layers, head_rqs_bwd=layers),
              2048: dict(rqs_fwd=2 * layers, rqs_bwd=2 * layers)}
    for batch in (8192, 2048):
        c = cond_contexts(gen, batch)
        xb = (model.p.sample(batch, generator=gen, context=c), c)
        loss, grads, launches = _step_result(model, xb)
        loss_cpu, grads_cpu, _ = _step_result(cpu_model, _batch_cpu(xb))
        worst_g = max(rel_err(grads[n].cpu(), grads_cpu[n]) for n in grads)
        grad_errs[batch] = (abs(loss - loss_cpu), worst_g)
        if not (abs(loss - loss_cpu) <= MODEL_TOL and worst_g <= TRAIN_TOL):
            raise RuntimeError(
                f"conditional step B={batch}: card vs CPU loss {loss} vs "
                f"{loss_cpu}, gradients {worst_g:.3g} relative (limit "
                f"{TRAIN_TOL})")
        per_step[batch] = launches
    _expect(per_step, expect, "conditional forward-KLD step")

    # 50 eager steps at B = 65536 whose loss falls
    cs = cond_contexts(gen, COND_STEPS * BATCH)
    xs = model.p.sample(COND_STEPS * BATCH, generator=gen, context=cs)
    batches = [(xs[i * BATCH:(i + 1) * BATCH], cs[i * BATCH:(i + 1) * BATCH])
               for i in range(COND_STEPS)]
    trained = copy.deepcopy(model)
    opt = torch.optim.Adam(trained.parameters(), lr=COND_LR, capturable=True)
    state = nt.init_train_state(trained, opt)
    step = nt.make_forward_kld_step(opt).eager
    losses, times = [], []
    torch.cuda.synchronize()
    reset_counts()
    for b in batches:
        t0 = time.perf_counter()
        losses.append(step(state, b))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    training = read_counts()
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[0]), float(losses[-10:].mean())
    if not np.isfinite(losses).all() or not last <= first - LOSS_MARGIN:
        raise RuntimeError(f"conditional training: losses {losses[:3]} ... "
                           f"{losses[-3:]}, want all finite and the last "
                           f"10's mean {LOSS_MARGIN} below the first")
    _expect({"run": training}, {"run": {
        k: COND_STEPS * v for k, v in expect[8192].items()}},
        "conditional training")
    ms = float(np.median(times))
    print(f"phase conditional training: Adam(lr={COND_LR}, capturable), "
          f"ConditionalDiagGaussianTarget; card vs CPU one step: "
          + "; ".join(f"B={b} loss diff {e[0]:.3g} (limit {MODEL_TOL}), "
                      f"gradients {e[1]:.3g} relative (limit {TRAIN_TOL})"
                      for b, e in grad_errs.items())
          + f"; launches per step {per_step}; {COND_STEPS} eager steps at "
          f"B={BATCH}: loss {first:.4f} -> {last:.4f} (mean of last 10), "
          f"all finite, {ms:.3f} ms/step median", flush=True)

    # under graphs
    out = {"conditional serving": (serving, PATH_KERNELS[
        "conditional serving"]),
        "conditional training": (training, PATH_KERNELS["conditional step"])}
    served = serving_graphs("conditional", model, x, BATCH, per_pass,
                            "conditional serving", context=ctx)
    out["graphs: conditional serving"] = (_captured_counts(served),
                                          PATH_KERNELS["conditional serving"])
    bucket_graphs("conditional", model, BATCH, context=ctx)
    captured = step_graphs(
        "conditional forward-KLD step (x, context)", model,
        nt.make_forward_kld_step, lambda i, which: (batches[i % COND_STEPS],),
        "conditional step", dict(lr=COND_LR))
    _expect_launches(captured["launches"], expect[8192],
                     "conditional step graph")
    out["graphs: conditional step"] = (captured["launches"],
                                       PATH_KERNELS["conditional step"])
    return out


def _kernel_free_checks(label, model, x, cpu_rows=CPU_ROWS, gen=None):
    """A model that runs no port kernel, at B = len(x): ``log_prob`` and
    ``sample`` eagerly, card against CPU on the first ``cpu_rows`` rows,
    ``log_prob(sample)`` against ``log_q``, a round trip, no port kernel
    launched; returns the eager ms per call."""
    counts = {}
    batch = x.shape[0]
    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.inference_mode():
        lp = _counted(counts, "log_prob", lambda: model.log_prob(x))
        z, log_q = _counted(counts, "sample", lambda: model.sample(
            batch, generator=gen))
        lp_s = model.log_prob(z)
        x_back = model.forward(model.inverse(x))
        lp_cpu = cpu_model.log_prob(x[:cpu_rows].cpu())
        lq_cpu = cpu_model.log_prob(z[:cpu_rows].cpu())
    _expect(counts, {"log_prob": {}, "sample": {}}, f"{label} serving")
    errs = {f"log_prob cuda vs cpu (first {cpu_rows})": max_err(
                lp[:cpu_rows].cpu(), lp_cpu),
            f"log_q of samples vs cpu log_prob (first {cpu_rows})": max_err(
                log_q[:cpu_rows].cpu(), lq_cpu),
            "log_prob(sample) vs log_q": max_err(lp_s, log_q),
            "forward(inverse(x)) vs x": max_err(x_back, x)}
    for t in (lp, z, log_q, lp_s, x_back):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite values on the {label} path")
    for k, v in errs.items():
        if not v <= MODEL_TOL:
            raise RuntimeError(f"{label}: {k} {v:.3g} > {MODEL_TOL}")
    with torch.inference_mode():
        lp_ms = host_ms(lambda: model.log_prob(x))
        sample_ms = host_ms(lambda: model.sample(batch, generator=gen))
    print(f"phase {label} serving (B = {batch}): launches per pass "
          f"{counts}; errors " + ", ".join(
              f"{k} {v:.3g} (limit {MODEL_TOL})" for k, v in errs.items())
          + f"; eager log_prob {lp_ms:.3f} ms/call, sample {sample_ms:.3f} "
          f"ms/call", flush=True)
    return {k: counts["log_prob"][k] + counts["sample"][k]
            for k in counts["log_prob"]}


def phase_realnvp(dev, flush):
    """``build_realnvp`` at its defaults (dim 2, K 64, MLPs [2, 64, 64,
    2]) with the TwoModes target, perturbed and then set by
    ``init_from_samples(512)``: serving against the CPU, ``scan=True``
    against ``scan=False`` bitwise, the annealed reverse-KLD step of
    ``examples/real_nvp.py`` eager against graph, and ``bench.py``'s
    round trip (K 16, hidden [128, 128], B = 65536) as one graph. No port
    kernel runs. Returns {path: launches}."""
    import nf_tpu_torch as nt
    from nf_tpu_torch._graphs import capture, warm_up

    def built(scan=False, **kw):
        m = nt.build_realnvp(seed=SEED, target=nt.TwoModes(), scan=scan,
                             **kw)
        perturb(m, SEED + 60, size=0.1)
        return m.init_from_samples(512, generator=torch.Generator(
            device=dev).manual_seed(SEED + 61))

    model = built()
    x = _normal(np.random.default_rng(SEED + 62), (BATCH, 2), 1.5, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 63)
    serving = _kernel_free_checks("realnvp", model, x, gen=gen)
    scanned = nt.load_reference_state_dict(
        nt.build_realnvp(target=nt.TwoModes(), scan=True),
        {k: v.cpu().numpy() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        same = torch.equal(model.log_prob(x), scanned.log_prob(x))
        a = model.sample(BATCH, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        b = scanned.sample(BATCH, generator=torch.Generator(
            device=dev).manual_seed(SEED))
    if not (same and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        raise RuntimeError("realnvp: scan=True differs from scan=False")
    print("phase realnvp scan: scan=True loaded from the unrolled model's "
          "reference-named state dict; log_prob and sample bitwise equal "
          "to scan=False", flush=True)

    out = {"realnvp serving": (serving, ())}
    served = serving_graphs("realnvp", model, x, BATCH, {},
                            "realnvp serving")
    out["graphs: realnvp serving"] = (_captured_counts(served), ())
    gens = [torch.Generator(device=dev).manual_seed(SEED + 64)
            for _ in range(2)]
    step = step_graphs(
        f"realnvp annealed reverse-KLD step (B = {RNVP_TRAIN_BATCH})", model,
        lambda opt: nt.make_reverse_kld_step(
            opt, num_samples=RNVP_TRAIN_BATCH,
            beta_schedule=lambda t: min(1.0, 0.01 + t / RNVP_ANNEAL)),
        lambda i, which: (gens[which],), "realnvp step", dict(lr=RNVP_LR))
    _expect_launches(step["launches"], {}, "realnvp step graph")
    out["graphs: realnvp step"] = (step["launches"], ())

    bench = built(K=BENCH_K, hidden=[BENCH_HIDDEN, BENCH_HIDDEN])
    xb = _normal(np.random.default_rng(SEED + 65), (BATCH, 2), 1.0, dev)

    def roundtrip():
        z, ld_f = bench.forward_and_log_det(xb)
        x2, ld_i = bench.inverse_and_log_det(z)
        return x2, ld_f + ld_i

    with torch.no_grad():
        warm_up(roundtrip, dev, 2)
        graph, (x2, ld), launches = capture(roundtrip, dev)
        graph.replay()
        torch.cuda.synchronize()
        rt, ld_sum = max_err(x2, xb), float(ld.abs().max())

    def eager():
        with torch.no_grad():
            return roundtrip()

    _expect_launches(launches, {}, "bench round trip graph")
    if not (rt <= ROUND_TRIP_TOL and ld_sum <= ROUND_TRIP_TOL):
        raise RuntimeError(f"bench round trip: x {rt:.3g}, log-dets "
                           f"{ld_sum:.3g} (limit {ROUND_TRIP_TOL})")
    t = in_turns(eager, graph.replay)
    dev_ms = device_ms(graph.replay, flush)
    g = min(t[1])
    print(f"phase realnvp bench recipe (build_realnvp K={BENCH_K}, hidden "
          f"[{BENCH_HIDDEN}, {BENCH_HIDDEN}], B = {BATCH}, forward + "
          f"inverse + log-det round trip): x back {rt:.3g}, |ld_f + ld_i| "
          f"{ld_sum:.3g}; " + _turns_text(t, "round trip")
          + f"; graph {BATCH / g * 1e3:.4g} samples/s (best graph median), "
          f"device {dev_ms:.4f} ms per replay", flush=True)
    return out


def phase_maf(dev, flush):
    """``build_maf`` at its defaults (dim 2, K 8, MADE hidden 64, 2
    blocks), perturbed: serving against the CPU, and the forward-KLD step
    on TwoMoons at B = 65536 eager against graph. No port kernel runs.
    Returns {path: launches}."""
    import nf_tpu_torch as nt

    model = nt.build_maf(seed=SEED)
    perturb(model, SEED + 70, size=0.1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    pool = nt.TwoMoons().sample(20 * BATCH, generator=gen)
    x = pool[:BATCH]
    out = {"maf serving": (_kernel_free_checks("maf", model, x, gen=gen),
                           ())}
    served = serving_graphs("maf", model, x, BATCH, {}, "maf serving")
    out["graphs: maf serving"] = (_captured_counts(served), ())
    step = step_graphs(
        "maf forward-KLD step (TwoMoons)", model, nt.make_forward_kld_step,
        lambda i, which: (pool[(i % 20) * BATCH:(i % 20 + 1) * BATCH],),
        "maf step", dict(lr=1e-3))
    _expect_launches(step["launches"], {}, "maf step graph")
    out["graphs: maf step"] = (step["launches"], ())
    return out


# --- the image stack (phases 15 and 16) ---------------------------------

IMG_BATCH = 256  # serving: log_prob, bits/dim and sample
IMG_STEP_BATCH = 64  # the forward-KLD step (examples/image_nsf.py)
IMG_CPU_ROWS = 16  # images held against the CPU
IMG_LR = 1e-3  # examples/image_nsf.py, examples/glow.py
IMG_TEMPERATURE = 0.7
GLOW_BATCH = 128
# the perturbation of the image models' weights (``perturb``'s size): the
# untrained models' sampling direction amplifies (a Glow coupling divides
# by sigmoid(s + 2), 16 times per level), and at 0.1 their T = 0.7
# samples leave float32 (image NSF, |z| ~ 300 before the Logit) or turn
# NaN (Glow); at these sizes the samples stay within |z| < 8 and
# log_prob still moves by hundreds of nats from the unperturbed model's
IMG_PERTURB = 0.02
GLOW_PERTURB = 0.01
# image log-densities are ~1e3-1e4 nats: a whole model's log_prob is held
# relative to max(|log p|, 1), the JAX package's bar; pixels and bits/dim
# abs
IMG_REL_TOL = 1e-4
BPD_TOL = 1e-4
# the image NSF's couplings at its defaults: (transformed channels, side)
# per level, and their count
IMG_LEVELS = ((6, 16), (12, 8))
IMG_COUPLINGS = 8


def image_batch(n, seed, dev):
    """``procedural_image_classes(seed, n)`` as the image recipes feed it
    (``examples/image_nsf.py``): pixels / 255, ``Scale`` (255/256), then
    ``Jitter`` (U(0, 1/256) from a generator seeded with ``seed``); with
    its labels (int64), both on ``dev``."""
    from nf_tpu_torch.data import procedural_image_classes
    from nf_tpu_torch.utils.preprocessing import Jitter, Scale

    imgs, y = procedural_image_classes(seed, n)
    x = torch.from_numpy(imgs).to(dev, torch.float32) / 255.0
    x = Jitter()(Scale()(x), generator=torch.Generator(
        device=dev).manual_seed(seed))
    return x, torch.from_numpy(y).long().to(dev)


def rel_model_err(a, b):
    """max |a - b| over max(max |b|, 1): a whole image model's bar."""
    return max_err(a, b) / max(float(b.abs().max()), 1.0)


def _image_operands(rng, batch, ct, side, dev, scale=0.5, K=K_BINS):
    """Kernel A's and C's operands at one image coupling's shapes, made as
    the bin-major feed makes them: x (B, C, H, W) ~ N(0, 1.5²) (some past
    the tail bound 3); a conditioner output (B, C*P, H, W) ~ N(0,
    ``scale``²) viewed as (P, B, C, H, W) planes, widths and heights
    multiplied by the softmax scale 1/sqrt(64), the derivatives padded for
    linear tails (K + 1 contiguous planes); cotangents (B, C, H, W) ~
    N(0, 1). At ``scale`` 0.5 (the repo's parity draws, ROADMAP §3) the
    gradients are O(1) and held abs; at 1 some reach O(1e3). ``K`` bins
    (8, the image NSF's, unless given)."""
    from nf_tpu_torch.ops import splines

    x = _normal(rng, (batch, ct, side, side), 1.5, dev)
    out = _normal(rng, (batch, ct * (3 * K - 1), side, side), scale, dev)
    p = out.reshape(batch, ct, -1, side, side).permute(2, 0, 1, 3, 4)
    soft = 1.0 / np.sqrt(64)
    w, h = p[:K] * soft, p[K:2 * K] * soft
    d = splines.pad_derivatives(p[2 * K:], "linear", 1e-3, axis=0)
    cty, ctl = (_normal(rng, x.shape, 1.0, dev) for _ in range(2))
    return x, w, h, d, cty, ctl


def elementwise_rel_err(a, b):
    """max over elements of |a - b| / max(|b|, 1)."""
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def parity_image_kernels(dev, flush, peaks):
    """Kernels A and C on the image coupling's 4D views at both levels'
    shapes, at B = 256 (serving) and 64 (the step), both spline
    directions, with conditioner outputs at N(0, 0.5²) and N(0, 1): A
    against ``rqs_plain`` (y, ld abs), C against ``rqs_bwd_plain``
    (every gradient abs at 0.5; at 1, where gradients reach O(1e3) and
    two float32 roundings of them differ by more than 1e-4, per element
    relative to max(|g|, 1)); the views are the planes' own storage (same
    addresses, no copy). Then kernel_ms, plain_ms and bound_ms, A at
    B = 256 and C at B = 64, at N(0, 1)."""
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED + 80)
    worst = dict(y=0.0, ld=0.0, grad=0.0, grad_rel=0.0)
    cases = 0
    rows = {}
    for batch in (IMG_BATCH, IMG_STEP_BATCH):
        for ct, side in IMG_LEVELS:
            for scale in (0.5, 1.0):
                x, w, h, d, cty, ctl = _image_operands(rng, batch, ct, side,
                                                       dev, scale)
                views = tk.param_views(x, w, h, d)
                rows_cols = (batch * ct, side * side)
                if not all(v.shape[1:] == rows_cols
                           and v.data_ptr() == t.data_ptr()
                           for v, t in zip(views, (w, h, d))):
                    raise RuntimeError(
                        f"image planes at {tuple(x.shape)}: param_views "
                        f"gave {[tuple(v.shape) for v in views]}, not "
                        f"views of the planes")
                for inverse in (False, True):
                    y, ld = tk.rqs_fwd(x, w, h, d, 3.0, inverse=inverse)
                    yp, lp = tk.rqs_plain(x, w, h, d, 3.0, inverse=inverse)
                    got = tk.rqs_bwd(x, w, h, d, 3.0, cty, ctl,
                                     inverse=inverse)
                    want = tk.rqs_bwd_plain(x, w, h, d, 3.0, cty, ctl,
                                            inverse=inverse)
                    torch.cuda.synchronize()
                    worst["y"] = max(worst["y"], max_err(y, yp))
                    worst["ld"] = max(worst["ld"], max_err(ld, lp))
                    key = "grad" if scale == 0.5 else "grad_rel"
                    err = max_err if scale == 0.5 else elementwise_rel_err
                    worst[key] = max(worst[key], *(
                        err(a, b) for a, b in zip(got, want)))
                    cases += 1
            label = (f"{'A' if batch == IMG_BATCH else 'C'} x "
                     f"({batch}, {ct}, {side}, {side}) = "
                     f"({batch * ct}, {side * side})")
            t = {}
            for inverse in (False, True):
                if batch == IMG_BATCH:
                    ms = device_ms(lambda: tk.rqs_fwd(
                        x, w, h, d, 3.0, inverse=inverse), flush)
                    plain = device_ms(lambda: tk.rqs_plain(
                        x, w, h, d, 3.0, inverse=inverse), flush)
                    b = bound(_spline_bytes(x, (w, h, d), 2),
                              tk.rqs_ops_per_element(K_BINS, inverse)
                              * x.numel(), peaks)
                else:
                    ms = device_ms(lambda: tk.rqs_bwd(
                        x, w, h, d, 3.0, cty, ctl, inverse=inverse), flush)
                    plain = device_ms(lambda: tk.rqs_bwd_plain(
                        x, w, h, d, 3.0, cty, ctl, inverse=inverse), flush)
                    b = bound(_spline_bytes(x, (w, h, d), 3 * K_BINS + 2)
                              + 4 * 2 * x.numel(),
                              tk.rqs_bwd_ops_per_element(K_BINS, inverse)
                              * x.numel(), peaks)
                t[inverse] = (ms, plain) + b
            rows[label] = t
    limits = dict(y=Y_TOL, ld=LD_TOL, grad=G_TOL, grad_rel=G_TOL)
    if not all(worst[k] <= limits[k] for k in limits):
        raise RuntimeError(f"kernels A and C on the image views disagree "
                           f"with their plain versions: {worst} (limits "
                           f"{limits})")
    print(f"phase image kernels (K = {K_BINS}, linear, tail bound 3, the "
          f"(P, B, C, H, W) planes collapsed to (P, B*C, H*W) views, same "
          f"addresses): {cases} cases, A vs rqs_plain y {worst['y']:.3g} "
          f"(limit {Y_TOL}), ld {worst['ld']:.3g} (limit {LD_TOL}); C vs "
          f"rqs_bwd_plain {worst['grad']:.3g} abs at N(0, 0.5²) logits, "
          f"{worst['grad_rel']:.3g} per element relative to max(|g|, 1) "
          f"at N(0, 1) (limit {G_TOL}); "
          + "; ".join(_timing_row(k, v) for k, v in rows.items()),
          flush=True)


def conv_times(dev, flush):
    """Device ms of the image models' largest convolutions as the port
    runs them (``conv2d``: float32, deterministic algorithms) against
    PyTorch's defaults: the forward in TF32 (``allow_tf32`` True), with
    each one's largest difference from float64; and the backward (input,
    weight and bias gradients) in float32 by cuDNN's deterministic
    algorithms against its default choice. Layers: the image NSF's 3x3
    64 -> 64 at level 1 (B = 256, 16 x 16) and Glow's 3x3 6 -> 256, 1x1
    256 -> 256 and 3x3 256 -> 12 at its largest level (B = 128,
    16 x 16)."""
    import contextlib

    import torch.nn.functional as F

    from nf_tpu_torch.nets.cnn import conv2d

    rng = np.random.default_rng(SEED + 81)
    layers = (("image NSF 3x3 64->64", (IMG_BATCH, 64, 16, 16), 64, 3),
              ("Glow 3x3 6->256", (GLOW_BATCH, 6, 16, 16), 256, 3),
              ("Glow 1x1 256->256", (GLOW_BATCH, 256, 16, 16), 256, 1),
              ("Glow 3x3 256->12", (GLOW_BATCH, 256, 16, 16), 12, 3))

    @contextlib.contextmanager
    def cudnn(tf32, deterministic):
        c = torch.backends.cudnn
        before = c.allow_tf32, c.deterministic
        c.allow_tf32, c.deterministic = tf32, deterministic
        try:
            yield
        finally:
            c.allow_tf32, c.deterministic = before

    def tf32(x, w, b):
        with cudnn(True, False):
            return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    def backward(x, w, g, deterministic):
        with cudnn(False, deterministic):
            p = w.shape[-1] // 2
            return torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]], [1, 1], [p, p], [1, 1], False,
                [0, 0], 1, [True, True, True])

    rows = []
    for label, shape, out_ch, k in layers:
        x = _normal(rng, shape, 1.0, dev)
        fan_in = shape[1] * k * k
        w = _normal(rng, (out_ch, shape[1], k, k), 1 / np.sqrt(fan_in), dev)
        b = _normal(rng, (out_ch,), 0.1, dev)
        g = _normal(rng, (shape[0], out_ch) + shape[2:], 1.0, dev)
        with torch.no_grad():
            f32 = conv2d(x, w, b)
            want = F.conv2d(x.double(), w.double(), b.double(),
                            padding=k // 2)
            diff = (max_err(tf32(x, w, b).double(), want),
                    max_err(f32.double(), want))
            ms = device_ms(lambda: conv2d(x, w, b), flush)
            ms_tf32 = device_ms(lambda: tf32(x, w, b), flush)
            bwd = [device_ms(lambda: backward(x, w, g, det), flush)
                   for det in (True, False)]
        rows.append(f"{label} x {shape}: forward float32 {ms:.4f} ms, "
                    f"TF32 {ms_tf32:.4f} ms (vs float64: TF32 "
                    f"{diff[0]:.3g}, float32 {diff[1]:.3g}); backward "
                    f"float32 deterministic {bwd[0]:.4f} ms, cuDNN's "
                    f"default {bwd[1]:.4f} ms")
    print("phase image convs (device ms after the flush): "
          + "; ".join(rows), flush=True)


def image_graphs(label, model, x, y, per_pass, path, bitwise=False):
    """``compile_log_prob`` and ``compile_sampler`` of an image model at
    ``len(x)`` (with labels ``y`` when the model is class-conditional)
    against eager calls: log_prob within GRAPH_TOL relative to max(|log
    p|, 1) and bits/dim from it within BPD_TOL, the tempered sampler (and
    its labels) bitwise; times in turns; a profiled replay of each. With
    ``bitwise`` the log_prob graph must equal eager bitwise too. Inputs
    are compiled in ``x``'s dtype. Returns {"log_prob": ..., "sample":
    ...}."""
    import nf_tpu_torch as nt
    from types import SimpleNamespace

    from nf_tpu_torch.utils.eval import bits_per_dim

    cc = y is not None
    ys = (y,) if cc else ()
    batch = x.shape[0]
    out = {}
    lp_fn = nt.compile_log_prob(model, tuple(x.shape), class_cond=cc,
                                dtype=x.dtype)
    _expect_launches(lp_fn.launches, per_pass, f"{label} log_prob graph")

    def eager_lp():
        with torch.inference_mode():
            return model.log_prob(x, *ys)

    lp_graph, lp_eager = lp_fn(x, *ys), eager_lp()
    if bitwise and not torch.equal(lp_graph, lp_eager):
        raise RuntimeError(f"{label} log_prob: the graph is not eager "
                           f"bitwise ({max_err(lp_graph, lp_eager):.3g})")
    lp_err = rel_model_err(lp_graph, lp_eager)
    with torch.inference_mode():
        bpd = bits_per_dim(model, x, y)
    bpd_graph = bits_per_dim(SimpleNamespace(log_prob=lp_fn), x, y)
    bpd_err = max_err(bpd_graph, bpd)
    if not (lp_err <= GRAPH_TOL and bpd_err <= BPD_TOL):
        raise RuntimeError(f"{label} log_prob: graph vs eager {lp_err:.3g} "
                           f"relative (limit {GRAPH_TOL}), bits/dim "
                           f"{bpd_err:.3g} (limit {BPD_TOL})")
    out["log_prob"] = dict(
        err=f"{lp_err:.3g} relative, bits/dim {bpd_err:.3g} (mean "
            f"{float(bpd.mean()):.4f})",
        turns=in_turns(eager_lp, lambda: lp_fn(x, *ys)),
        report=replay_report(lambda: lp_fn(x, *ys), path),
        launches=lp_fn.launches)
    sampler = nt.compile_sampler(model, batch, temperature=IMG_TEMPERATURE,
                                 class_cond=cc)
    for seed in (SEED, SEED + 1):
        z, log_q = sampler(seed, *ys)
        with torch.inference_mode():
            ze, lqe = model.sample(batch, generator=torch.Generator(
                "cuda").manual_seed(seed), y=y, temperature=IMG_TEMPERATURE)
        if not (torch.equal(z, ze) and torch.equal(log_q, lqe)):
            raise RuntimeError(f"{label} sample: the graph's draws for seed "
                               f"{seed} differ from eager "
                               f"({max_err(z, ze):.3g})")
    gen = torch.Generator("cuda").manual_seed(SEED)

    def eager_sample():
        with torch.inference_mode():
            return model.sample(batch, generator=gen, y=y,
                                temperature=IMG_TEMPERATURE)

    out["sample"] = dict(err="bitwise", turns=in_turns(
        eager_sample, lambda: sampler(SEED, *ys)),
        report=replay_report(lambda: sampler(SEED, *ys), path),
        launches=sampler.launches)
    for what, r in out.items():
        print(f"phase graphs {label} {what} (B = {batch}"
              + (f", T = {IMG_TEMPERATURE}" if what == "sample" else "")
              + f"): graph vs eager {r['err']}; capture counted "
              f"{r['launches']}; " + _turns_text(r["turns"]) + "; "
              + _report_text(r["report"]), flush=True)
    return out


def image_checks(label, model, x, y, per_pass):
    """An image model at B = len(x), eagerly: ``log_prob`` and bits/dim,
    card against CPU on IMG_CPU_ROWS images (IMG_REL_TOL relative,
    BPD_TOL abs), the tempered ``sample`` against the tempered model's
    ``log_prob`` (IMG_REL_TOL relative), a round trip through the
    latents (pixels and log-dets), finite values of the right shapes, the
    kernels each pass launched (``per_pass``); the model must not be the
    identity. Returns the eager passes' launches and ms per call."""
    from nf_tpu_torch.utils.eval import bits_per_dim

    batch = x.shape[0]
    ys = (y,) if y is not None else ()
    cpu_model = copy.deepcopy(model).to("cpu")
    rows = IMG_CPU_ROWS
    counts = {}
    gen = torch.Generator(device=x.device).manual_seed(SEED + 83)
    with torch.inference_mode():
        lp = _counted(counts, "log_prob", lambda: model.log_prob(x, *ys))
        bpd = bits_per_dim(model, x, y)
        z, log_q = _counted(counts, "sample", lambda: model.sample(
            batch, generator=gen, y=y, temperature=IMG_TEMPERATURE))
        lp_s = model.set_temperature(IMG_TEMPERATURE).log_prob(z, *ys)
        latents, ld_inv = model.inverse_and_log_det(x)
        x_back, ld_fwd = model.forward_and_log_det(latents)
        cpu_ys = tuple(t[:rows].cpu() for t in ys)
        lp_cpu = cpu_model.log_prob(x[:rows].cpu(), *cpu_ys)
        bpd_cpu = bits_per_dim(cpu_model, x[:rows].cpu(),
                               cpu_ys[0] if cpu_ys else None)
    _expect(counts, {"log_prob": per_pass, "sample": per_pass},
            f"{label} serving")
    errs = {f"log_prob cuda vs cpu (first {rows}, relative)": (
                rel_model_err(lp[:rows].cpu(), lp_cpu), IMG_REL_TOL),
            f"bits/dim cuda vs cpu (first {rows})": (
                max_err(bpd[:rows].cpu(), bpd_cpu), BPD_TOL),
            f"log_prob(sample) vs log_q at T = {IMG_TEMPERATURE} "
            f"(relative)": (rel_model_err(lp_s, log_q), IMG_REL_TOL),
            "forward(inverse(x)) vs x": (max_err(x_back, x),
                                         ROUND_TRIP_TOL),
            "ld_inverse + ld_forward (relative)": (
                max_err(ld_inv + ld_fwd, torch.zeros_like(ld_inv))
                / max(float(ld_inv.abs().max()), 1.0), IMG_REL_TOL)}
    for t in (lp, bpd, z, log_q, lp_s, x_back):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite values on the {label} path")
    if z.shape != x.shape or lp.shape != (batch,):
        raise RuntimeError(f"{label} shapes: sample {tuple(z.shape)}, "
                           f"log_prob {tuple(lp.shape)}")
    for k, (v, lim) in errs.items():
        if not v <= lim:
            raise RuntimeError(f"{label}: {k} {v:.3g} > {lim}")
    with torch.inference_mode():
        lp_ms = host_ms(lambda: model.log_prob(x, *ys))
        sample_ms = host_ms(lambda: model.sample(
            batch, generator=gen, y=y, temperature=IMG_TEMPERATURE))
    print(f"phase {label} serving (B = {batch}): launches per pass "
          f"{counts}; bits/dim mean {float(bpd.mean()):.4f}; errors "
          + ", ".join(f"{k} {v:.3g} (limit {lim})"
                      for k, (v, lim) in errs.items())
          + f"; eager log_prob {lp_ms:.3f} ms/call, sample {sample_ms:.3f} "
          f"ms/call", flush=True)
    return {k: counts["log_prob"][k] + counts["sample"][k]
            for k in counts["log_prob"]}


def image_step_check(label, model, batch, want):
    """One Adam step of ``make_forward_kld_step``, card against CPU on the
    first IMG_CPU_ROWS rows of ``batch`` (a tensor or ``(x, y)``): loss
    within IMG_REL_TOL relative; gradients, each relative to its largest
    magnitude, within TRAIN_TOL or within twice the CPU's own float32
    error (its gradients against the same step in float64 on the CPU),
    whichever is larger: the deep image models, their ActNorms set from
    smooth procedural images, amplify rounding in the backward, so at
    Glow's defaults float32 gradients lie ~2e-2 from float64 on either
    device. The card step at the full batch launches ``want``. Returns
    its launches."""
    def head(b, n):
        return tuple(t[:n] for t in b) if isinstance(b, tuple) else b[:n]

    def cpu(b, dtype=torch.float32):
        def one(t):
            return t.cpu().to(dtype) if t.is_floating_point() else t.cpu()
        return tuple(one(t) for t in b) if isinstance(b, tuple) else one(b)

    _, _, launches = _step_result(model, batch)
    _expect({"step": launches}, {"step": want}, f"{label} step")
    small = head(batch, IMG_CPU_ROWS)
    loss, grads, _ = _step_result(model, small)
    loss_cpu, grads_cpu, _ = _step_result(copy.deepcopy(model).to("cpu"),
                                          cpu(small))
    _, grads64, _ = _step_result(
        copy.deepcopy(model).to("cpu", torch.float64),
        cpu(small, torch.float64))
    loss_err = abs(loss - loss_cpu) / max(abs(loss_cpu), 1.0)
    grad_err = max(rel_err(grads[n].cpu(), grads_cpu[n]) for n in grads)
    f32_err = max(rel_err(grads_cpu[n].double(), grads64[n])
                  for n in grads)
    limit = max(TRAIN_TOL, 2 * f32_err)
    if not (loss_err <= IMG_REL_TOL and grad_err <= limit):
        raise RuntimeError(f"{label} step, card vs CPU: loss {loss} vs "
                           f"{loss_cpu} ({loss_err:.3g} relative), "
                           f"gradients {grad_err:.3g} relative (limit "
                           f"{limit:.3g}: the CPU's float32 is {f32_err:.3g}"
                           f" from float64)")
    print(f"phase {label} step: card vs CPU on {IMG_CPU_ROWS} rows: loss "
          f"{loss:.4f} ({loss_err:.3g} relative, limit {IMG_REL_TOL}), "
          f"gradients {grad_err:.3g} relative (limit {limit:.3g}: "
          f"TRAIN_TOL {TRAIN_TOL}, or twice the CPU float32 step's "
          f"{f32_err:.3g} from float64); launches per step at the full "
          f"batch {launches}", flush=True)
    return launches


def phase_image_nsf(dev, flush, peaks):
    """``build_image_nsf`` at its defaults (3 x 32 x 32, L 2, K 4, hidden
    64, 8 bins, linear tails, tail bound 3), seed 0, perturbed, its
    ActNorms set by ``init_from_data`` on ``procedural_image_classes(0,
    256)`` through Scale and Jitter: kernels A and C on the 4D views,
    the convolutions in float32 and TF32, serving at B = 256 and the
    forward-KLD step at B = 64 (Adam 1e-3), eagerly (card against CPU,
    launches per pass and step) and as CUDA graphs. Returns {path:
    (launches, kernels it must launch)}."""
    import nf_tpu_torch as nt

    t0 = time.perf_counter()
    parity_image_kernels(dev, flush, peaks)
    conv_times(dev, flush)
    model = nt.build_image_nsf(seed=SEED)
    perturb(model, SEED + 84, size=IMG_PERTURB)
    x, _ = image_batch(IMG_BATCH, SEED, dev)
    model.init_from_data(x)
    per_pass = {"rqs_fwd": IMG_COUPLINGS}
    serving = image_checks("image_nsf", model, x, None, per_pass)
    xs = [image_batch(IMG_STEP_BATCH, SEED + 1 + i, dev)[0]
          for i in range(GRAPH_STEPS + 30)]
    per_step = {"rqs_fwd": IMG_COUPLINGS, "rqs_bwd": IMG_COUPLINGS}
    training = image_step_check("image_nsf", model, xs[0], per_step)
    out = {"image_nsf serving": (serving, PATH_KERNELS["image_nsf serving"]),
           "image_nsf training": (training,
                                  PATH_KERNELS["image_nsf step"])}
    served = image_graphs("image_nsf", model, x, None, per_pass,
                          "image_nsf serving")
    out["graphs: image_nsf serving"] = (_captured_counts(served),
                                        PATH_KERNELS["image_nsf serving"])
    step = step_graphs(
        f"image_nsf forward-KLD step (B = {IMG_STEP_BATCH})", model,
        nt.make_forward_kld_step, lambda i, which: (xs[i % len(xs)],),
        "image_nsf step", dict(lr=IMG_LR))
    _expect_launches(step["launches"], per_step, "image_nsf step graph")
    out["graphs: image_nsf step"] = (step["launches"],
                                     PATH_KERNELS["image_nsf step"])
    print(f"phase image_nsf: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_glow(dev, flush):
    """``build_glow_multiscale`` at its defaults (3 x 32 x 32, L 3, K 16,
    hidden 256, class-conditional), seed 0, perturbed, its ActNorms set
    by ``init_from_data`` on 256 procedural images with their labels:
    serving at B = 128 (labels, the sampler at T = 0.7) and the
    forward-KLD step on ``(x, y)`` at B = 128 (Adam 1e-3), eagerly and
    as CUDA graphs; no port kernel may launch. Returns {path: (launches,
    ())}."""
    import nf_tpu_torch as nt

    t0 = time.perf_counter()
    model = nt.build_glow_multiscale(seed=SEED)
    perturb(model, SEED + 90, size=GLOW_PERTURB)
    model.init_from_data(*image_batch(IMG_BATCH, SEED + 91, dev))
    x, y = image_batch(GLOW_BATCH, SEED + 92, dev)
    serving = image_checks("glow", model, x, y, {})
    batches = [image_batch(GLOW_BATCH, SEED + 93 + i, dev)
               for i in range(GRAPH_STEPS + 30)]
    training = image_step_check("glow", model, batches[0], {})
    out = {"glow serving": (serving, ()), "glow training": (training, ())}
    served = image_graphs("glow", model, x, y, {}, "glow serving")
    out["graphs: glow serving"] = (_captured_counts(served), ())
    step = step_graphs(
        f"glow forward-KLD step on (x, y) (B = {GLOW_BATCH})", model,
        nt.make_forward_kld_step, lambda i, which: (batches[i % len(
            batches)],), "glow step", dict(lr=IMG_LR))
    _expect_launches(step["launches"], {}, "glow step graph")
    out["graphs: glow step"] = (step["launches"], ())
    print(f"phase glow: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --- the last builders and the circular coupling (phases 17-19) ----------

CC_LAYERS, CC_HIDDEN, CC_BINS = 12, 512, 10  # build_circular_nsf's
CC_TAIL_BOUND = (np.pi, 3.0)
CC_CHECK_BATCH = 4096  # one step, card against CPU
CC_PERTURB = 0.3
RES_BATCH = 512  # examples/residual.py
RES_REVERSE_BATCH = 1024
RES_CPU_ROWS = 4096  # rows of a pass held against the CPU
RES_LR, RES_WD = 3e-4, 1e-5
RES_POWER_ITERS = 50  # update_lipschitz(m, 50) after every step
PR_LR = {"planar": 5e-3, "radial": 3e-3}  # the examples' rates
PR_BATCH = 512
PR_ANNEAL = 750  # examples/comparison_plan_rad_aff.py: half its iterations


def circular_coupled_model(target=None):
    """``build_circular_nsf``'s arguments with the circular coupling in
    place of the autoregressive layer (the JAX package has no builder for
    it): dim 2, ind_circ [0], K 12, one block of hidden 512, 10 bins, tail
    bounds (pi, 3), masks alternating by layer, ``PeriodicWrap``, a
    ``UniformGaussian`` base with scale (2 pi, 1); weights from the seed,
    perturbed by :data:`CC_PERTURB` (at 0.5, float32 itself leaves
    ``log_prob(sample)`` up to 7.4e-3 from ``log_q`` on the CPU's plain
    path, against 5.9e-7 in float64; at 0.3, 1.4e-4, the model 6 nats
    from its base)."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows

    gen = torch.Generator().manual_seed(SEED)
    flows = [tflows.CircularCoupledRationalQuadraticSpline(
        num_input_channels=2, num_blocks=1, num_hidden_channels=CC_HIDDEN,
        ind_circ=[0], num_bins=CC_BINS, tail_bound=CC_TAIL_BOUND,
        reverse_mask=(i % 2 == 1), generator=gen)
        for i in range(CC_LAYERS)]
    flows.append(tflows.PeriodicWrap([0], bound=np.pi))
    model = nt.NormalizingFlow(
        tdist.UniformGaussian(2, ind=[0], scale=[2 * np.pi, 1.0]), flows,
        p=target).to("cuda")
    perturb(model, SEED + 170, size=CC_PERTURB)
    return model


def _circular_counts():
    """Kernels B's and E's launches at circular tails since the last
    reset."""
    from nf_tpu_torch.ops import spline_head_fused as shf

    return (shf.fused_head_rqs.circular_launches,
            shf.fused_head_rqs_bwd.circular_launches)


def _angle_err(a, b):
    """Largest difference, the angle (column 0) taken modulo 2 pi."""
    d = (a - b).detach().cpu()
    d[:, 0] = torch.remainder(d[:, 0] + np.pi, 2 * np.pi) - np.pi
    return float(d.abs().max())


def cc_kernel_operands(model, dev, batch=BATCH, dtype=torch.float32):
    """Kernels B's and E's operands at an angle-transforming layer of the
    circular coupled model: its transformed feature x_t (1, B) (a
    transposed view), its trunk's h_t (512, B) with the periodic features,
    the 3K+1 head's effective rows (3K = 30 circular), the tail bound pi;
    cotangents N(0, 1); all in ``dtype`` (the model's)."""
    from nf_tpu_torch.flows.neural_spline.feed import _effective_rows
    from nf_tpu_torch.ops import spline_head_fused as shf

    layer = next(f for f in model.flows[:CC_LAYERS]
                 if f.prqct.tails == ("circular",))
    prqct = layer.prqct
    net = prqct.transform_net
    rng = np.random.default_rng(SEED + 171)
    x = torch.stack([torch.from_numpy(rng.uniform(-np.pi, np.pi, batch)),
                     torch.from_numpy(rng.standard_normal(batch) * 1.5)],
                    dim=1).to(dev, dtype)
    with torch.no_grad():
        id_split, t_split = prqct._split(x)
        h_t = net.features_transposed(id_split).contiguous()
        w, b = _effective_rows(net.final_layer.weight, net.final_layer.bias,
                               CC_BINS, 1, "circular")
        w, b = shf.effective_head(w, b, num_bins=CC_BINS, feats=1,
                                  tails="circular",
                                  softmax_scale=prqct.softmax_scale)
    tb = prqct.tail_bound_arr.contiguous()
    cty = _normal(rng, (batch, 1), 1.0, dev).to(dtype).T
    ctl = _normal(rng, (1, batch), 1.0, dev).to(dtype)
    return (t_split.T, h_t, w.contiguous(), b.contiguous(), tb, cty, ctl)


def cc_kernels(dev, flush, peaks, model):
    """Kernels B and E alone at the circular coupling's real operands
    (circular tails, H 512, K 10, D 1, B 65536), both spline directions:
    parity against their plain versions (B: y 1e-5, ld 1e-4; E: 1e-4 per
    element and on the batch sums relative, or, where gx is off
    ``head_rqs_bwd_plain`` (cuBLAS's order), against the plain version
    summed in the kernel's order), their times and bounds; and their
    registers and spills at K = 10 from the build."""
    from nf_tpu_torch.ops import _build
    from nf_tpu_torch.ops import spline_head_fused as shf
    from nf_tpu_torch.ops import splines_kernel as tk

    x_t, h_t, w, b, tb, cty, ctl = cc_kernel_operands(model, dev)
    m, hidden = w.shape
    b_t, e_t = {}, {}
    worst = dict(y=0.0, ld=0.0, grad=0.0, sums=0.0, order=0.0)
    for inverse in (False, True):
        kw = dict(num_bins=CC_BINS, tails="circular", inverse=inverse)
        y, ld = shf.fused_head_rqs(x_t, h_t, w, b, tail_bound=tb, **kw)
        yp, lp = shf.head_rqs_plain(x_t, h_t, w, b, tb, **kw)
        got = shf.fused_head_rqs_bwd(x_t, h_t, w, b, tb, cty, ctl, **kw)
        plain = shf.head_rqs_bwd_plain(x_t, h_t, w, b, tb, cty, ctl, **kw)
        torch.cuda.synchronize()
        worst["y"] = max(worst["y"], max_err(y, yp))
        worst["ld"] = max(worst["ld"], max_err(ld, lp))
        grad = max(max_err(got[0], plain[0]), max_err(got[1], plain[1]))
        sums = max(rel_err(got[2], plain[2]), rel_err(got[3], plain[3]))
        if grad > G_TOL:
            order = shf.head_rqs_bwd_plain_in_kernel_order(
                x_t, h_t, w, b, tb, cty, ctl, **kw)
            worst["order"] = max(worst["order"],
                                 max_err(got[0], order[0]),
                                 max_err(got[1], order[1]))
            sums = max(sums, rel_err(got[2], order[2]),
                       rel_err(got[3], order[3]))
        else:
            worst["grad"] = max(worst["grad"], grad)
        worst["sums"] = max(worst["sums"], sums)
        b_ms = device_ms(lambda: shf.fused_head_rqs(
            x_t, h_t, w, b, tail_bound=tb, **kw), flush)
        b_plain = device_ms(lambda: shf.head_rqs_plain(
            x_t, h_t, w, b, tb, **kw), flush)
        e_ms = device_ms(lambda: shf.fused_head_rqs_bwd(
            x_t, h_t, w, b, tb, cty, ctl, **kw), flush)
        e_plain = device_ms(lambda: shf.head_rqs_bwd_plain(
            x_t, h_t, w, b, tb, cty, ctl, **kw), flush)
        n = x_t.shape[1]
        b_bytes = 4 * (n + hidden * n + m * hidden + m + 1 + 2 * n)
        b_ops = (2 * m * hidden * n
                 + tk.rqs_ops_per_element(CC_BINS, inverse) * n)
        e_bytes = 4 * (3 * n + hidden * n + m * hidden + m + 1
                       + n + hidden * n + m * hidden + m)
        e_ops = (3 * 2 * m * hidden * n + m * n
                 + tk.rqs_bwd_ops_per_element(CC_BINS, inverse) * n)
        b_t[inverse] = (b_ms, b_plain) + bound(b_bytes, b_ops, peaks)
        e_t[inverse] = (e_ms, e_plain) + bound(e_bytes, e_ops, peaks)
    if not (worst["y"] <= Y_TOL and worst["ld"] <= LD_TOL
            and worst["grad"] <= G_TOL and worst["order"] <= G_TOL
            and worst["sums"] <= SUM_TOL):
        raise RuntimeError(f"circular coupled kernels disagree with their "
                           f"plain versions: {worst}")
    import re

    regs = {}  # the largest over the tail and layout instantiations
    for lib in ("head_rqs_fwd", f"head_rqs_bwd@{CC_BINS}"):
        for kernel, krows in ptxas_kernels(
                _build.BUILD_LOGS.get(lib, "")).items():
            short = re.search(
                r"(head_rqs_(?:fwd|bwd)_kernel|reduce_partials)", kernel)
            for k, flags, r, spill in krows:
                if k in (CC_BINS, 0):
                    key = (f"{short.group(1) if short else kernel} K{k}"
                           f"{'i' if flags[:1] == '1' else 'f'}")
                    old = regs.get(key, (0, 0))
                    regs[key] = (max(old[0], r), max(old[1], spill))
    print(f"phase circular_coupled kernels (B = {BATCH}, D = 1, H = "
          f"{hidden}, K = {CC_BINS}, circular tails, the model's weights): "
          f"B y {worst['y']:.3g} (limit {Y_TOL}), ld {worst['ld']:.3g} "
          f"(limit {LD_TOL}); E gx/gh {worst['grad']:.3g} against the "
          f"plain version, {worst['order']:.3g} against it summed in the "
          f"kernel's order where gx was over {G_TOL}, gW/gb "
          f"{worst['sums']:.3g} relative (limits {G_TOL}, {SUM_TOL}); "
          + _timing_row("; B", b_t) + _timing_row("; E", e_t)
          + "; registers (spill-store bytes) at K = 10: "
          + (", ".join(f"{k} {r} ({s})" for k, (r, s) in regs.items())
             or "not in the build log"), flush=True)
    return {"head_rqs_fwd": b_t, "head_rqs_bwd": e_t, "worst": worst}


def cc_step_check(model, dev):
    """One SGD step of the reverse-KLD step, card against CPU, on the same
    base draws (B = 4096): (loss error, gradient error, launches,
    circular launches of B and E)."""
    rng = np.random.default_rng(SEED + 172)
    z0 = np.stack([rng.uniform(-np.pi, np.pi, CC_CHECK_BATCH),
                   rng.standard_normal(CC_CHECK_BATCH)], axis=1)
    z0 = torch.from_numpy(z0.astype(np.float32))
    loss, grads, per_step = _circular_step_result(model, z0.to(dev),
                                                  "analytic")
    circ = _circular_counts()
    cpu = copy.deepcopy(model).to("cpu")
    loss_cpu, grads_cpu, _ = _circular_step_result(cpu, z0, "analytic")
    torch.cuda.synchronize()
    grad_err = max(rel_err(grads[n].cpu(), grads_cpu[n]) for n in grads)
    return abs(loss - loss_cpu), grad_err, per_step, circ


def phase_circular_coupled(dev, flush, peaks):
    """Phase 17: the circular coupled NSF (:func:`circular_coupled_model`)
    served at B = 65536 and trained by the reverse-KLD step on the
    Gauss-von Mises target (Adam 5e-4, B = 16384), eagerly and as graphs;
    kernels B and E at its real operands. Returns {path: launches}."""
    import nf_tpu_torch as nt

    t0 = time.perf_counter()
    model = circular_coupled_model()
    kernels = cc_kernels(dev, flush, peaks, model)
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(SEED + 173)
    x = np.stack([rng.uniform(-np.pi, np.pi, BATCH),
                  rng.standard_normal(BATCH) * 1.5], axis=1)
    x = torch.from_numpy(x.astype(np.float32))
    x_dev = x.to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 174)
    counts, circ = {}, {}
    with torch.inference_mode():
        lp = _counted(counts, "log_prob", lambda: model.log_prob(x_dev))
        circ["log_prob"] = _circular_counts()
        z, log_q = _counted(counts, "sample", lambda: model.sample(
            BATCH, generator=gen))
        circ["sample"] = _circular_counts()
        lp_s = model.log_prob(z)
        x_back = model.forward(model.inverse(x_dev))
        lp_cpu = cpu_model.log_prob(x[:CIRC_CPU_BATCH])
        lp_64 = copy.deepcopy(cpu_model).double().log_prob(
            x[:CIRC_CPU_BATCH].double())
    want = {"rqs_fwd": CC_LAYERS, "head_rqs_fwd": CC_LAYERS}
    _expect(counts, {"log_prob": want, "sample": want},
            "circular_coupled serving")
    for what, (b_circ, _) in circ.items():
        if b_circ != CC_LAYERS // 2:
            raise RuntimeError(f"circular_coupled {what}: {b_circ} launches "
                               f"of kernel B at circular tails, expected "
                               f"{CC_LAYERS // 2} (the layers transforming "
                               f"the angle)")
    # the card against the CPU is held to 1e-3, or to twice the CPU's own
    # float32 error against float64 where that is larger (twelve 512-wide
    # trunks: the two devices sum their products in other orders)
    err64 = float((lp_cpu.double() - lp_64).abs().max())
    cpu_tol = max(MODEL_TOL, 2 * err64)
    errs = {f"log_prob cuda vs cpu (first {CIRC_CPU_BATCH})": max_err(
                lp[:CIRC_CPU_BATCH].cpu(), lp_cpu),
            "log_prob(sample) vs log_q": max_err(lp_s, log_q),
            "forward(inverse(x)) vs x (angle mod 2 pi)": _angle_err(
                x_back, x_dev)}
    limits = dict.fromkeys(errs, MODEL_TOL)
    limits[next(iter(errs))] = cpu_tol
    for t in (lp, z, log_q, lp_s, x_back):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite values on the circular_coupled "
                               "serving path")
    for k, v in errs.items():
        if not v <= limits[k]:
            raise RuntimeError(f"circular_coupled: {k} {v:.3g} > "
                               f"{limits[k]:.3g}")
    if max_err(lp, model.q0.log_prob(x_dev)) < 0.1:
        raise RuntimeError("the perturbed circular coupled model is still "
                           "the identity")
    print(f"phase circular_coupled serving (B = {BATCH}, dim 2, ind_circ "
          f"[0], K {CC_LAYERS}, hidden {CC_HIDDEN}, {CC_BINS} bins, tail "
          f"bounds (pi, 3)): launches per pass {counts}; kernel B at "
          f"circular tails per pass {({k: v[0] for k, v in circ.items()})}; "
          f"errors " + ", ".join(f"{k} {v:.3g} (limit {limits[k]:.3g})"
                                 for k, v in errs.items())
          + f"; the CPU's float32 against float64 {err64:.3g}, |log p| up "
          f"to {float(lp_64.abs().max()):.4g}", flush=True)
    out = {"circular_coupled serving": (
        {k: counts["log_prob"][k] + counts["sample"][k]
         for k in counts["log_prob"]}, ("rqs_fwd", "head_rqs_fwd"))}

    target_model = circular_coupled_model(target=GaussVonMises())
    loss_err, grad_err, per_step, circ_step = cc_step_check(target_model,
                                                            dev)
    if not (loss_err <= MODEL_TOL and grad_err <= TRAIN_TOL):
        raise RuntimeError(f"circular_coupled reverse KLD: card vs CPU loss "
                           f"{loss_err:.3g}, gradients {grad_err:.3g}")
    step_want = {"rqs_fwd": CC_LAYERS, "head_rqs_fwd": CC_LAYERS,
                 "rqs_bwd": CC_LAYERS, "head_rqs_bwd": CC_LAYERS}
    _expect({"step": per_step}, {"step": step_want},
            "circular_coupled reverse-KLD step")
    if circ_step != (CC_LAYERS // 2, CC_LAYERS // 2):
        raise RuntimeError(f"circular_coupled step: B and E at circular "
                           f"tails {circ_step}, expected "
                           f"{CC_LAYERS // 2} each")
    print(f"phase circular_coupled training check (B = {CC_CHECK_BATCH}, "
          f"GaussVonMises): card vs CPU loss {loss_err:.3g} (limit "
          f"{MODEL_TOL}), gradients {grad_err:.3g} relative (limit "
          f"{TRAIN_TOL}); launches per step {per_step}; B and E at "
          f"circular tails per step {circ_step}", flush=True)
    out["circular_coupled training"] = (per_step, tuple(step_want))

    served = serving_graphs("circular_coupled", model, x_dev, BATCH,
                            want, "circular_coupled serving")
    out["graphs: circular_coupled serving"] = (
        _captured_counts(served), PATH_KERNELS["circular_coupled serving"])
    gens = [torch.Generator(device=dev).manual_seed(SEED + 175)
            for _ in range(2)]
    step = step_graphs(
        f"circular_coupled reverse-KLD step (B = {CIRC_TRAIN_BATCH})",
        target_model, lambda opt: nt.make_reverse_kld_step(
            opt, num_samples=CIRC_TRAIN_BATCH),
        lambda i, which: (gens[which],), "circular_coupled step",
        dict(lr=5e-4))
    _expect_launches(step["launches"], step_want,
                     "circular_coupled step graph")
    out["graphs: circular_coupled step"] = (
        step["launches"], PATH_KERNELS["circular_coupled step"])
    print(f"phase timing phase 17 (circular_coupled): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out, kernels


# --- kernel F: the residual fixed point's loop condition --------------------

F_ELEMENTS = 2 * BATCH  # the residual sampler's x: (65536, 2)
F_EDGE_CASES = ("threshold", "below", "nan", "nan_and_moving", "inf",
                "neg_inf", "inf_tol", "cap", "past_cap", "empty")
# JAX's decision on each edge plane (its ``cond``: a NaN compares false)
F_EXPECTED_GO = {"threshold": True, "below": False, "nan": False,
                 "nan_and_moving": True, "inf": True, "neg_inf": True,
                 "inf_tol": False, "cap": True, "past_cap": False,
                 "empty": False}
F_THRESHOLD_TRIALS = 32  # random planes with one element at d^2 / tol == 1


def edge_planes(case, n=8, rng=None):
    """``(x, x_prev, tol, count)`` of one edge case of the fixed-point
    loop's test, float32 numpy planes of ``n`` elements, every element
    settled but those the case names, at indices drawn from ``rng`` (None:
    fixed ones): ``threshold`` (one element at exactly ``d^2 / tol ==
    1``), ``below`` (the same with ``tol`` one ulp up), ``nan`` (NaN
    elements, settled in JAX), ``nan_and_moving``, ``inf`` and ``neg_inf``
    (an infinite step), ``inf_tol`` (every element moving by 1 against an
    infinite tolerance), ``cap`` and ``past_cap`` (a moving element at
    counts 1000 and 1001), ``empty`` (no element). Counts 7 elsewhere."""
    idx = (rng.choice(n, 2, replace=False) if rng is not None
           else np.array([3, 6]))
    x = np.zeros(n, np.float32)
    x_prev = np.zeros(n, np.float32)
    tol = np.full(n, 1e-5, np.float32)
    count = 7
    if case in ("threshold", "below"):
        x[idx[0]], tol[idx[0]] = 0.5, 0.25
        if case == "below":
            tol[idx[0]] = np.nextafter(np.float32(0.25), np.float32(1))
    elif case == "nan":
        x[idx] = np.nan
    elif case == "nan_and_moving":
        x[idx[0]], x[idx[1]] = np.nan, 1.0
    elif case in ("inf", "neg_inf"):
        x[idx[0]] = np.inf if case == "inf" else -np.inf
    elif case == "inf_tol":
        x[:] = 1.0
        tol[:] = np.inf
    elif case in ("cap", "past_cap"):
        x[idx[0]] = 1.0
        count = 1000 if case == "cap" else 1001
    elif case == "empty":
        x, x_prev, tol = (a[:0] for a in (x, x_prev, tol))
    return x, x_prev, tol, count


def _f_against_plain(planes, count, dev, dtype=torch.float32):
    """Kernel F and its plain version on the same planes: F's test before
    a first pass (count set to 0) and after one (``count - 1`` bumped),
    each against ``fixed_point_go``. Returns the number of disagreements
    (go, count or the state's reset slots) and F's go after the pass."""
    from nf_tpu_torch.flows.residual import fixed_point_go
    from nf_tpu_torch.ops.fixed_point import fixed_point_cond

    x, xp, tol = (torch.from_numpy(a).to(dev, dtype) for a in planes)
    c = torch.zeros((), dtype=torch.int32, device=dev)
    state = torch.zeros(3, dtype=torch.int32, device=dev)
    bad = 0
    for after_pass, start in ((False, 0), (True, count)):
        c.fill_(start - 1 if after_pass else 12345)
        fixed_point_cond(x, xp, tol, c, state, after_pass)
        want = fixed_point_go(x, xp, tol, torch.full_like(c, start))
        got = state.tolist()
        bad += (int(c) != start) + (bool(got[2]) != bool(want)) \
            + (got[:2] != [0, 0])
    return bad, bool(got[2])


def f_edge_cases(dev, dtype, n, rng):
    """Kernel F against its plain version on every edge plane of ``n``
    elements (the special ones at places drawn from ``rng``); in float32
    also against JAX's decision (``F_EXPECTED_GO``: bfloat16 has no "one
    float32 ulp up"). Returns the disagreements."""
    bad = 0
    for case in F_EDGE_CASES:
        *planes, count = edge_planes(case, n, rng)
        b, go = _f_against_plain(planes, count, dev, dtype)
        bad += b + (dtype == torch.float32 and go != F_EXPECTED_GO[case])
    return bad


def f_threshold_trials(dev, rng):
    """``F_THRESHOLD_TRIALS`` planes of the residual sampler's size with
    one element at exactly ``d^2 / tol == 1`` (go) and the same with
    ``tol`` one ulp up (stop), d log-normal: kernel F against its plain
    version and the expected decision. Returns the disagreements."""
    bad = 0
    for _ in range(F_THRESHOLD_TRIALS):
        x = np.zeros(F_ELEMENTS, np.float32)
        tol = np.full(F_ELEMENTS, 1e-5, np.float32)
        i = int(rng.integers(F_ELEMENTS))
        d = np.float32(np.exp(rng.normal(0.0, 3.0)))
        x[i] = d
        tol[i] = d * d  # float32: fl(d^2) / fl(d^2) == 1
        for up in (False, True):
            if up:
                tol[i] = np.nextafter(tol[i], np.float32(np.inf))
            b, go = _f_against_plain((x, np.zeros_like(x), tol), 5, dev)
            bad += b + (go == up)
    return bad


def parity_kernel_f(dev):
    """Kernel F against ``fixed_point_go`` (its plain version, JAX's
    ``cond``): the edge planes at 8 elements and at the residual
    sampler's 131072, in float32 and bfloat16 (:func:`f_edge_cases`),
    and the threshold trials (:func:`f_threshold_trials`). Returns
    (disagreements, cases)."""
    rng = np.random.default_rng(SEED + 1800)
    bad = sum(f_edge_cases(dev, dtype, n, rng)
              for dtype in (torch.float32, torch.bfloat16)
              for n in (8, F_ELEMENTS))
    bad += f_threshold_trials(dev, rng)
    torch.cuda.synchronize()
    return bad, 4 * len(F_EDGE_CASES) + 2 * F_THRESHOLD_TRIALS


def timing_kernel_f(dev, flush, peaks):
    """Kernel F after a pass at the residual sampler's planes (x, x_prev,
    tol (65536, 2) float32, every element settled, so it reads all three
    planes) against its plain version (``fixed_point_go`` and the count's
    increment); the bound is ``ops.cost.fixed_point_cond``'s."""
    from nf_tpu_torch.flows.residual import fixed_point_go
    from nf_tpu_torch.ops import cost
    from nf_tpu_torch.ops.fixed_point import fixed_point_cond

    rng = np.random.default_rng(SEED + 1801)
    x = _normal(rng, (BATCH, 2), 1.0, dev)
    xp = x + 1e-4
    tol = 1e-5 + x.abs() * 1e-5
    c = torch.zeros((), dtype=torch.int32, device=dev)
    state = torch.zeros(3, dtype=torch.int32, device=dev)

    def plain():
        c.add_(1)
        return fixed_point_go(x, xp, tol, c)

    ms = device_ms(lambda: fixed_point_cond(x, xp, tol, c, state, True),
                   flush)
    plain_ms = device_ms(plain, flush)
    ops, nbytes = cost.fixed_point_cond(x, xp, tol, c, state, True, None)
    return (ms, plain_ms) + bound(nbytes, ops, peaks)


def phase_kernel_f(dev, flush, peaks):
    """Kernel F's parity and time (the ``results`` row of the JSON
    line)."""
    bad, cases = parity_kernel_f(dev)
    if bad:
        raise RuntimeError(f"fixed_point_cond disagrees with its plain "
                           f"version or JAX's decision in {bad} places "
                           f"over {cases} cases")
    t = timing_kernel_f(dev, flush, peaks)
    ms, plain, bound_ms, by = t
    print(f"phase parity fixed_point_cond: {cases} cases (the edge planes "
          f"at 8 and {F_ELEMENTS} elements in float32 and bfloat16, "
          f"{F_THRESHOLD_TRIALS} planes at the exact threshold and one ulp "
          f"past it), every go and count equal to the plain version's and "
          f"JAX's; x (65536, 2): kernel_ms {ms:.4f} plain_ms {plain:.4f} "
          f"bound_ms {bound_ms:.5f} ({by}); the parity launches count no "
          f"path", flush=True)
    return dict(err=0.0, t=t, source="nf_tpu_torch/csrc/fixed_point_cond.cu",
                replaces="nf_tpu/flows/residual.py:47")


# --- phase 18: residual flows --------------------------------------------------

RES_STIFF_LIP = 0.99  # build_residual(lipschitz_const=0.99)
RES_STIFF_K = 4  # its depth, cut from build_residual's 16 for time
RES_STIFF_NOISE = 1e-3  # on its closed-form weights
RES_OLD_FIXED_COUNT = 32  # the masked count the parent's graphs ran
RES_STIFF_TURNS = 3  # calls per turn of its timed sampler
# steps per turn of the residual steps' timing (their eager steps take
# 1-2 s each: the script's time limit)
RES_STEP_TURNS = 3


def stiff_layers(dims, lip, noise_seed, noise):
    """``[(weight, bias)]`` of the dense layers of a ``LipschitzMLP(dims)``
    near its Lipschitz bound: ``lip`` times an identity block (the first
    ``dims[0]`` channels carried through), each hidden bias putting those
    channels at the steepest point of Swish (``x sigmoid(softplus(0.5) x)
    / 1.1``, slope 1.0 at ``x* = 2.4 / softplus(0.5)``) for inputs at
    ``x*``, plus N(0, noise²) numpy noise on everything. Near ``x*`` each
    pass of the fixed point shrinks the error by about ``lip`` to the
    number of layers; random weights contract far faster."""
    rng = np.random.default_rng(noise_seed)
    beta = np.log1p(np.exp(0.5))
    x_star = 2.4 / beta
    h_star = x_star / (1.0 + np.exp(-beta * x_star)) / 1.1
    d = dims[0]
    out = []
    for i, (n_in, n_out) in enumerate(zip(dims[:-1], dims[1:])):
        w = np.zeros((n_out, n_in), np.float32)
        k = min(n_in, n_out)
        w[:k, :k] = lip * np.eye(k)
        b = np.zeros(n_out, np.float32)
        if i < len(dims) - 2:
            b[:d] = x_star - lip * h_star
        w += noise * rng.standard_normal(w.shape).astype(np.float32)
        b += noise * rng.standard_normal(b.shape).astype(np.float32)
        out.append((w, b))
    return out


def stiff_residual_model(dev):
    """``build_residual`` at its widths with ``lipschitz_const=0.99`` and
    ``RES_STIFF_K`` blocks, each net's dense layers set by
    :func:`stiff_layers` (so its fixed points need far more than 32
    passes), power iterations advanced 200 steps, the exact 2D log-det
    on, ActNorms set on 4096 two-moons points."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import InducedNormLinear
    from nf_tpu_torch.utils import update_lipschitz

    model = nt.build_residual(K=RES_STIFF_K, lipschitz_const=RES_STIFF_LIP,
                              seed=SEED, device=dev)
    dims = [2, 128, 128, 128, 2]
    with torch.no_grad():
        for i, block in enumerate(_blocks(model)):
            dense = [m for m in block.nnet.net
                     if isinstance(m, InducedNormLinear)]
            for m, (w, b) in zip(dense, stiff_layers(
                    dims, RES_STIFF_LIP, SEED + 1900 + i, RES_STIFF_NOISE)):
                m.weight.copy_(torch.from_numpy(w))
                m.bias.copy_(torch.from_numpy(b))
    update_lipschitz(model, 200)
    tflows.set_exact_logdet(model)
    return model.init_from_data(moons(4096, SEED + 1901, dev))


def moons(n, seed, dev):
    """Two-moons data (``examples/residual.py``'s ``make_moons``, noise
    0.1) drawn on the card from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.rand(n, generator=gen, device=dev) * np.pi
    upper = torch.rand(n, generator=gen, device=dev) < 0.5
    x = torch.where(upper, torch.cos(t), 1.0 - torch.cos(t))
    y = torch.where(upper, torch.sin(t), 0.5 - torch.sin(t))
    noise = torch.randn((n, 2), generator=gen, device=dev)
    return torch.stack([x, y], dim=1) + 0.1 * noise


def residual_model(dev):
    """``build_residual`` at its defaults, perturbed (linear weights by
    N(0, (0.5/sqrt(fan_in))²), the rest by N(0, 0.1²)), its power
    iterations advanced 200 steps on the new weights (so the Lipschitz
    bound holds), the exact 2D log-det on, and its ActNorms set by
    ``init_from_data`` on 4096 two-moons points."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.utils import update_lipschitz

    model = nt.build_residual(seed=SEED)
    rng = np.random.default_rng(SEED + 180)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = (0.5 / np.sqrt(p.shape[1])
                     if p.ndim == 2 and name.endswith("weight") else 0.1)
            noise = np.asarray(rng.standard_normal(tuple(p.shape)) * scale)
            p.add_(torch.from_numpy(noise.astype(np.float32)).to(dev))
    update_lipschitz(model, 200)
    tflows.set_exact_logdet(model)
    return model.init_from_data(moons(4096, SEED + 181, dev))


def _blocks(model):
    from nf_tpu_torch import flows as tflows

    return [m for m in model.modules() if isinstance(m, tflows.iResBlock)]


def _draw_probes(model, batch, seed):
    """A probe and series coefficients per block of ``model`` (on the
    CPU), drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn((batch, 2), generator=gen),
             m._sample_coeffs(gen, "cpu")) for m in _blocks(model)]


def _set_probes(model, fixed, dev):
    """Each block of ``model`` draws ``fixed``'s probe and coefficients."""
    for m, (v, c) in zip(_blocks(model), fixed):
        vd, cd = v.to(dev), c.to(dev)
        m.draw = lambda x, g, vd=vd, cd=cd: (vd, cd)


def residual_step_check(model, dev):
    """One forward-KLD step (with_key, post_update) of a stochastic copy
    of ``model``, card against CPU on injected probes (B = 512): (loss
    error, gradient error, u/v error after the step)."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.utils import update_lipschitz

    x = moons(RES_BATCH, SEED + 182, dev)
    results = []
    fixed = _draw_probes(copy.deepcopy(model).to("cpu"), RES_BATCH,
                         SEED + 183)
    for device in ("cpu", dev):
        m = copy.deepcopy(model).to(device)
        tflows.set_exact_logdet(m, False)
        _set_probes(m, fixed, device)
        opt = torch.optim.Adam(m.parameters(), lr=RES_LR,
                               weight_decay=RES_WD)
        step = nt.make_forward_kld_step(
            opt, with_key=True,
            post_update=lambda mm: update_lipschitz(mm, RES_POWER_ITERS))
        loss = step.eager(nt.init_train_state(m, opt), x.to(device), 0)
        results.append((float(loss), {n: p.grad for n, p in
                                      m.named_parameters()
                                      if p.grad is not None},
                        {n: b for n, b in m.state_dict().items()
                         if n.endswith((".u", ".v"))}))
    (l2, g2, b2), (l1, g1, b1) = results
    grad_err = max(rel_err(g1[n].cpu(), g2[n]) for n in g1)
    uv_err = max(max_err(b1[n].cpu(), b2[n]) for n in b1)
    return abs(l1 - l2), grad_err, uv_err


def residual_reverse_check(model, dev):
    """One eager reverse-KLD step on TwoModes under the exact log-det, card
    against CPU on the same base draws (B = 1024): its gradient passes
    through the fixed point's implicit VJP. (loss error, gradient error,
    fixed-point and VJP iterations per layer on the card)."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import flows as tflows

    z0 = _normal(np.random.default_rng(SEED + 184), (RES_REVERSE_BATCH, 2),
                 1.0, "cpu")
    out = []
    for device in (dev, "cpu"):
        m = copy.deepcopy(model).to(device)
        m.p = nt.TwoModes()
        zd = z0.to(device)
        m.q0.forward = lambda n, generator=None, zd=zd, m=m: (
            zd, m.q0.log_prob(zd))
        opt = torch.optim.SGD(m.parameters(), lr=0.0)
        step = nt.make_reverse_kld_step(opt, RES_REVERSE_BATCH).eager
        loss = step(nt.init_train_state(m, opt), None)
        out.append((float(loss), {n: p.grad for n, p in
                                  m.named_parameters()
                                  if p.grad is not None},
                    tflows.fixed_point_stats(m)))
    (l1, g1, st), (l2, g2, _) = out
    grad_err = max(rel_err(g1[n].cpu(), g2[n]) for n in g1)
    return abs(l1 - l2), grad_err, st


def sampler_loop_check(label, model, sampler, batch, seed):
    """One replay of the captured sampler ``sampler`` at ``seed`` against
    eager ``model.sample`` from the same seed: ``z`` and ``log_q``
    bitwise, the same fixed-point count per layer (the graph's written by
    kernel F), no unconverged flag. Returns the per-layer counts."""
    from nf_tpu_torch import flows as tflows

    z, log_q = sampler(seed)
    graph = [(s[0], s[2]) for s in tflows.fixed_point_stats(
        sampler._compiled.weights.model)]
    with torch.inference_mode():
        ze, lqe = model.sample(batch, generator=torch.Generator(
            "cuda").manual_seed(seed))
    eager = [(s[0], s[2]) for s in tflows.fixed_point_stats(model)]
    if not (torch.equal(z, ze) and torch.equal(log_q, lqe)):
        raise RuntimeError(f"{label}: the sampler graph's draws differ from "
                           f"eager ({max_err(z, ze):.3g}, log_q "
                           f"{max_err(log_q, lqe):.3g})")
    if graph != eager or any(flag for _, flag in eager):
        raise RuntimeError(f"{label}: fixed-point counts and flags per "
                           f"layer, graph {graph}, eager {eager}")
    return [c for c, _ in eager]


def stiff_residual_sampler(dev):
    """The ``lipschitz_const=0.99`` model of :func:`stiff_residual_model`
    served at B = 65536: eager per-layer counts (their maximum must pass
    the parent's fixed count of 32), the sampler graph bitwise eager with
    the same counts, both timed in turns, and a profiled replay (kernel
    F's device launches against the layers plus the passes)."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import flows as tflows

    model = stiff_residual_model(dev)
    seed = SEED + 1902
    with torch.inference_mode():
        model.sample(BATCH, generator=torch.Generator(dev).manual_seed(seed))
    counts = [s[0] for s in tflows.fixed_point_stats(model)]
    print(f"phase residual stiff model (build_residual, lipschitz_const "
          f"{RES_STIFF_LIP}, K {RES_STIFF_K}, closed-form weights, B = "
          f"{BATCH}): eager fixed-point passes per layer {counts}, max "
          f"{max(counts)} (the parent's graph ran {RES_OLD_FIXED_COUNT})",
          flush=True)
    if not max(counts) > RES_OLD_FIXED_COUNT:
        raise RuntimeError(f"the stiff residual model's eager fixed points "
                           f"took {counts} passes, none above "
                           f"{RES_OLD_FIXED_COUNT}")
    sampler = nt.compile_sampler(model, BATCH)
    _expect_launches(sampler.launches,
                     {"fixed_point_cond": 2 * RES_STIFF_K},
                     "stiff residual sampler graph")
    got = sampler_loop_check("stiff residual sampler", model, sampler,
                             BATCH, seed)
    if got != counts:
        raise RuntimeError(f"stiff residual sampler: counts {got} at the "
                           f"seed of the first eager draw's {counts}")
    gen = torch.Generator(dev).manual_seed(seed)

    def eager():
        with torch.inference_mode():
            return model.sample(BATCH, generator=gen)

    turns = in_turns(eager, lambda: sampler(seed), reps=RES_STIFF_TURNS)
    report = replay_report(lambda: sampler(seed), "residual sampler")
    f_seen = report["kernels"].get("fixed_point_cond", 0)
    print(f"phase residual stiff sampler graph: bitwise eager, passes per "
          f"layer {got} equal, no flag; capture counted "
          f"{sampler.launches}; " + _turns_text(turns, reps=RES_STIFF_TURNS)
          + "; kernel F's "
          f"device launches by the profiler {f_seen} (layers + passes = "
          f"{RES_STIFF_K + sum(got)}); " + _report_text(report),
          flush=True)
    return sampler.launches


def phase_residual(dev, flush):
    """Phase 18: ``build_residual`` at its defaults (K 16, LipschitzMLP
    [2, 128, 128, 128, 2], L 0.9, ActNorm): serving under the exact 2D
    log-det eagerly and as graphs (the fixed point of ``sample`` a WHILE
    node with kernel F, bitwise eager with the same counts), the
    forward-KLD step with ``with_key`` and
    ``post_update=update_lipschitz(50)`` (Adam 3e-4, weight decay 1e-5,
    B = 512 on two moons) card against CPU and eager against graph, one
    eager reverse-KLD step through the implicit VJP card against CPU, the
    reverse-KLD step captured against eager (both solves WHILE nodes), the
    ``lipschitz_const=0.99`` model whose fixed points take over 32 passes
    (:func:`stiff_residual_sampler`), and a LipschitzCNN block. Kernel F
    runs in the captured samplers and the captured reverse step only.
    Returns {path: launches}."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.flows import residual as res
    from nf_tpu_torch.utils import update_lipschitz

    t0 = time.perf_counter()
    model = residual_model(dev)
    cpu_model = copy.deepcopy(model).to("cpu")
    x = _normal(np.random.default_rng(SEED + 185), (BATCH, 2), 1.0, dev) \
        + torch.tensor([0.5, 0.25], device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 186)
    counts = {}
    with torch.no_grad():
        lp = _counted(counts, "log_prob", lambda: model.log_prob(x))
        sample_syncs = host_syncs(lambda: model.sample(BATCH, generator=gen))
        z, log_q = _counted(counts, "sample", lambda: model.sample(
            BATCH, generator=gen))
        iters = [s[0] for s in tflows.fixed_point_stats(model)]
        lp_s = model.log_prob(z)
        x_back = model.forward(model.inverse(x))
        rows = slice(0, RES_CPU_ROWS)
        lp_cpu = cpu_model.log_prob(x[rows].cpu())
        z0 = _normal(np.random.default_rng(SEED + 187), (RES_CPU_ROWS, 2),
                     1.0, dev)
        zs, lds = model.forward_and_log_det(z0)
        zs_cpu, lds_cpu = cpu_model.forward_and_log_det(z0.cpu())
    _expect(counts, {"log_prob": {}, "sample": {}}, "residual serving")
    errs = {f"log_prob cuda vs cpu (first {RES_CPU_ROWS})": max_err(
                lp[rows].cpu(), lp_cpu),
            f"sample push-forward cuda vs cpu ({RES_CPU_ROWS} base draws)":
                max(max_err(zs.cpu(), zs_cpu), max_err(lds.cpu(), lds_cpu)),
            "log_prob(sample) vs log_q": max_err(lp_s, log_q),
            "forward(inverse(x)) vs x": max_err(x_back, x)}
    for t in (lp, z, log_q, lp_s, x_back):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite values on the residual serving "
                               "path")
    for k, v in errs.items():
        if not v <= MODEL_TOL:
            raise RuntimeError(f"residual: {k} {v:.3g} > {MODEL_TOL}")
    with torch.no_grad():
        lp_ms = host_ms(lambda: model.log_prob(x))
        sample_ms = host_ms(lambda: model.sample(BATCH, generator=gen))
    print(f"phase residual serving (build_residual defaults, exact 2D "
          f"log-det, B = {BATCH}): launches per pass {counts}; errors "
          + ", ".join(f"{k} {v:.3g} (limit {MODEL_TOL})"
                      for k, v in errs.items())
          + f"; eager log_prob {lp_ms:.3f} ms/call, sample {sample_ms:.3f} "
          f"ms/call; fixed-point iterations per layer (eager, JAX's rule) "
          f"{iters}, max {max(iters)}; host syncs in one eager sample "
          f"{len(sample_syncs)} (the convergence test read every "
          f"{res.FIXED_POINT_CHECK_EVERY} steps)", flush=True)
    out = {"residual serving": (
        {k: counts["log_prob"][k] + counts["sample"][k]
         for k in counts["log_prob"]}, ())}
    served = serving_graphs("residual", model, x, BATCH, {},
                            "residual serving",
                            sample_path="residual sampler")
    sampler = served["sample"]["fn"]
    _expect_launches(sampler.launches, {"fixed_point_cond": 2 * len(iters)},
                     "residual sampler graph")
    got = sampler_loop_check("residual sampler", model, sampler, BATCH,
                             SEED + 7)
    t_graph = min(served["sample"]["turns"][1])
    report = served["sample"]["report"]
    print(f"phase residual fixed point: a WHILE node per solve, kernel F "
          f"its condition; the replay at seed {SEED + 7} bitwise eager with "
          f"the same passes per layer {got} and no flag; graph sample "
          f"{t_graph:.3f} ms against eager {sample_ms:.3f} ms (a graph of "
          f"32 masked steps per layer took 345.99 / 346.13 ms and 46251 "
          f"launches on an H100 80GB HBM3 at 700 W); this replay "
          f"{report['launches']} device launches, kernel F "
          f"{report['kernels'].get('fixed_point_cond', 0)} of them "
          f"(layers + passes = {len(got) + sum(got)}), device busy "
          f"{report['busy']:.3f} of {report['wall']:.3f} ms (idle "
          f"{report['idle']:.1%}); {nvidia_smi_line()}", flush=True)
    out["graphs: residual serving"] = (_captured_counts(served),
                                       ("fixed_point_cond",))

    loss_err, grad_err, uv_err = residual_step_check(model, dev)
    if not (loss_err <= MODEL_TOL and grad_err <= TRAIN_TOL
            and uv_err <= MODEL_TOL):
        raise RuntimeError(f"residual forward-KLD step: card vs CPU loss "
                           f"{loss_err:.3g}, gradients {grad_err:.3g}, u/v "
                           f"{uv_err:.3g}")
    print(f"phase residual training check (forward KLD, with_key, "
          f"post_update=update_lipschitz({RES_POWER_ITERS}), B = "
          f"{RES_BATCH}, injected probes): card vs CPU loss {loss_err:.3g} "
          f"(limit {MODEL_TOL}), gradients {grad_err:.3g} relative (limit "
          f"{TRAIN_TOL}), u/v after the step {uv_err:.3g}", flush=True)
    train_model = copy.deepcopy(model)
    tflows.set_exact_logdet(train_model, False)
    pool = moons(20 * RES_BATCH, SEED + 188, dev)
    step = step_graphs(
        f"residual forward-KLD step (with_key, post_update, B = "
        f"{RES_BATCH})", train_model,
        lambda opt: nt.make_forward_kld_step(
            opt, with_key=True,
            post_update=lambda m: update_lipschitz(m, RES_POWER_ITERS)),
        lambda i, which: (pool[(i % 20) * RES_BATCH:
                               (i % 20 + 1) * RES_BATCH], 1000 + i),
        "residual step", dict(lr=RES_LR, weight_decay=RES_WD),
        reps=RES_STEP_TURNS)
    _expect_launches(step["launches"], {}, "residual step graph")
    out["graphs: residual step"] = (step["launches"], ())

    loss_err, grad_err, st = residual_reverse_check(model, dev)
    if not (loss_err <= MODEL_TOL and grad_err <= TRAIN_TOL):
        raise RuntimeError(f"residual reverse KLD: card vs CPU loss "
                           f"{loss_err:.3g}, gradients {grad_err:.3g}")
    if any(s[2] for s in st):
        raise RuntimeError(f"residual reverse KLD: a fixed point stopped "
                           f"unconverged: {st}")
    print(f"phase residual reverse-KLD check (TwoModes, exact log-det, B = "
          f"{RES_REVERSE_BATCH}, eager): card vs CPU loss {loss_err:.3g}, "
          f"gradients through the implicit VJP {grad_err:.3g} relative "
          f"(limits {MODEL_TOL}, {TRAIN_TOL}); fixed-point / VJP "
          f"iterations per layer {[(s[0], s[1]) for s in st]}", flush=True)
    rev = copy.deepcopy(model)
    rev.p = nt.TwoModes()
    gens = [torch.Generator(device=dev).manual_seed(SEED + 1903)
            for _ in range(2)]

    def same_counts(graphed, eager):
        a, b = (tflows.fixed_point_stats(m) for m in (graphed, eager))
        if a != b or any(s[2] for s in a):
            raise RuntimeError(f"residual reverse-KLD step: fixed-point / "
                               f"VJP counts and flags, graph {a}, eager {b}")
        return (f"fixed-point / VJP passes per layer equal "
                f"{[(s[0], s[1]) for s in a]}, no flag")

    step = step_graphs(
        f"residual reverse-KLD step (TwoModes, exact log-det, "
        f"post_update, B = {RES_REVERSE_BATCH})", rev,
        lambda opt: nt.make_reverse_kld_step(
            opt, RES_REVERSE_BATCH,
            post_update=lambda m: update_lipschitz(m, RES_POWER_ITERS)),
        lambda i, which: (gens[which],), "residual reverse step",
        dict(lr=RES_LR, weight_decay=RES_WD), check=same_counts,
        reps=RES_STEP_TURNS)
    # a WHILE node per solve, two launches of F each: the sampling pass's
    # fixed points and their implicit VJPs
    _expect_launches(step["launches"], {"fixed_point_cond": 4 * len(iters)},
                     "residual reverse step graph")
    out["graphs: residual reverse step"] = (step["launches"],
                                            ("fixed_point_cond",))
    out["graphs: residual stiff sampler"] = (stiff_residual_sampler(dev),
                                             ("fixed_point_cond",))

    gen_cpu = torch.Generator().manual_seed(SEED + 189)
    cnn = nt.NormalizingFlow(
        nt.distributions.DiagGaussian((4, 8, 8)),
        [tflows.Residual(nt.nets.LipschitzCNN(
            [4, 8, 4], kernel_size=[3, 3], spatial_dims=(8, 8),
            lipschitz_const=0.9, generator=gen_cpu), exact_trace=True)])
    perturb(cnn, SEED + 190, size=0.2)
    update_lipschitz(cnn, 200)
    xi = torch.randn((8, 4, 8, 8), generator=gen_cpu)
    with torch.no_grad():
        lp_cpu = cnn.log_prob(xi)
        lp_dev = cnn.to(dev).log_prob(xi.to(dev))
    cnn_err = max_err(lp_dev.cpu(), lp_cpu)
    if not (cnn_err <= MODEL_TOL * max(1.0, float(lp_cpu.abs().max()))
            and bool(torch.isfinite(lp_dev).all())):
        raise RuntimeError(f"LipschitzCNN block: card vs CPU {cnn_err:.3g}")
    print(f"phase residual LipschitzCNN block (iResBlock, exact_trace, x "
          f"(8, 4, 8, 8), 256 vector-Jacobian products): log_prob card vs CPU "
          f"{cnn_err:.3g} (|log p| up to {float(lp_cpu.abs().max()):.4g})",
          flush=True)
    print(f"phase timing phase 18 (residual): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_planar_radial(dev, flush):
    """Phase 19: ``build_planar_stack`` and ``build_radial_stack`` at their
    defaults (dim 2, K 16) with TwoModes: ``sample`` at B = 65536 against
    the CPU's push-forward of the same base draws and as a graph (bitwise
    against eager), and the annealed reverse-KLD step (Adam 5e-3 / 3e-3,
    B = 512) eager against graph. No port kernel runs. Returns {path:
    launches}."""
    import nf_tpu_torch as nt

    t0 = time.perf_counter()
    out = {}
    builders = {"planar": nt.build_planar_stack,
                "radial": nt.build_radial_stack}
    for label, build in builders.items():
        model = build(seed=SEED, target=nt.TwoModes())
        perturb(model, SEED + 195, size=0.1)
        cpu_model = copy.deepcopy(model).to("cpu")
        counts = {}
        gen = torch.Generator(device=dev).manual_seed(SEED + 196)
        with torch.inference_mode():
            z, log_q = _counted(counts, "sample", lambda: model.sample(
                BATCH, generator=gen))
            gen.manual_seed(SEED + 196)
            z0, lq0 = model.q0.forward(BATCH, generator=gen)
            zc, ldc = cpu_model.forward_and_log_det(z0.cpu())
        _expect(counts, {"sample": {}}, f"{label} serving")
        err = max(max_err(z.cpu(), zc), max_err(log_q.cpu(),
                                                 lq0.cpu() - ldc))
        if not (err <= MODEL_TOL and bool(torch.isfinite(z).all())):
            raise RuntimeError(f"{label}: sample card vs CPU {err:.3g}")
        sampler = nt.compile_sampler(model, BATCH)
        zg, lqg = sampler(SEED)
        with torch.inference_mode():
            ze, lqe = model.sample(BATCH, generator=torch.Generator(
                "cuda").manual_seed(SEED))
        if not (torch.equal(zg, ze) and torch.equal(lqg, lqe)):
            raise RuntimeError(f"{label} sampler graph differs from eager")

        def eager_sample():
            with torch.inference_mode():
                return model.sample(BATCH, generator=gen)

        turns = in_turns(eager_sample, lambda: sampler(SEED))
        report = replay_report(lambda: sampler(SEED), f"{label} serving")
        print(f"phase {label} serving ({label} stack defaults, K 16, B = "
              f"{BATCH}): launches {counts}; sample card vs CPU "
              f"push-forward {err:.3g} (limit {MODEL_TOL}); sampler graph "
              f"bitwise eager; " + _turns_text(turns) + "; "
              + _report_text(report), flush=True)
        out[f"{label} serving"] = (counts["sample"], ())
        out[f"graphs: {label} serving"] = (sampler.launches, ())
        gens = [torch.Generator(device=dev).manual_seed(SEED + 197)
                for _ in range(2)]
        step = step_graphs(
            f"{label} annealed reverse-KLD step (B = {PR_BATCH})", model,
            lambda opt: nt.make_reverse_kld_step(
                opt, num_samples=PR_BATCH,
                beta_schedule=lambda t: min(1.0, 0.05 + t / PR_ANNEAL)),
            lambda i, which: (gens[which],), f"{label} step",
            dict(lr=PR_LR[label]))
        _expect_launches(step["launches"], {}, f"{label} step graph")
        out[f"graphs: {label} step"] = (step["launches"], ())
    print(f"phase timing phase 19 (planar_radial): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --- phases 20-21: dropout and batch norm on the kernel paths; the last
# layers and distributions ----------------------------------------------------

DROP_P = 0.1  # dropout_probability of phase 20's trunks
DROP_CHECK_BATCH = 16384  # one keyed step, card against CPU (>= the gate)
CHANGE_BASE_BATCH = 512  # examples/change_base_distribution.py
CHANGE_BASE_LR = 3e-3


def dropout_nsf_model(dev, p=DROP_P):
    """``build_nsf``'s arguments (dim 2, K 8, hidden 128, 8 bins, 2
    blocks, tail bound 3, ``LULinearPermute``) with
    ``CoupledRationalQuadraticSpline(..., dropout_probability=p)``: the
    builder's layers drawn in its order from its seed, so the weights are
    ``_nsf_model()``'s, perturbed the same way."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows

    gen = torch.Generator().manual_seed(SEED)
    flows = []
    for i in range(8):
        flows += [tflows.CoupledRationalQuadraticSpline(
                      num_input_channels=2, num_blocks=2,
                      num_hidden_channels=HIDDEN, num_bins=K_BINS,
                      tail_bound=3.0, dropout_probability=p,
                      reverse_mask=i % 2 == 1, generator=gen),
                  tflows.LULinearPermute(2, generator=gen)]
    model = nt.NormalizingFlow(tdist.DiagGaussian(2, trainable=False),
                               flows).to(dev)
    perturb(model, SEED)
    return model


def set_dropout(model, p):
    """``dropout_probability`` of every block of ``model`` set to ``p``:
    the weights stay as they are (the probability draws nothing at
    construction)."""
    for m in model.modules():
        if hasattr(m, "dropout_probability"):
            m.dropout_probability = p
    return model


def record_masks(fn):
    """Run ``fn`` and keep every dropout mask it draws (through the port's
    one helper): ``(its result, the masks on the CPU)``."""
    from nf_tpu_torch.nets import _dropout

    real, masks = _dropout.draw_mask, []

    def record(*args):
        mask = real(*args)
        masks.append(mask)
        return mask

    _dropout.draw_mask = record
    try:
        out = fn()
    finally:
        _dropout.draw_mask = real
    return out, [m.cpu() for m in masks]


def replay_masks(masks, fn):
    """Run ``fn`` with the dropout helper handing out ``masks`` in order
    instead of drawing: the card's masks replayed on the CPU. A mask the
    card drew on the transposed trunk (H, B) is replayed transposed where
    the CPU's unfused trunk asks for (B, H). Fails unless every mask was
    taken, each at its shape."""
    from nf_tpu_torch.nets import _dropout

    real, it = _dropout.draw_mask, iter(masks)
    taken = [0]

    def replay(generator, keep, shape, device):
        mask = next(it)
        if tuple(mask.shape) != tuple(shape):
            mask = mask.T
        if tuple(mask.shape) != tuple(shape):
            raise RuntimeError(f"replayed mask {tuple(mask.shape)} for a "
                               f"draw of {tuple(shape)}")
        taken[0] += 1
        return mask.to(device)

    _dropout.draw_mask = replay
    try:
        out = fn()
    finally:
        _dropout.draw_mask = real
    if taken[0] != len(masks):
        raise RuntimeError(f"{taken[0]} of {len(masks)} recorded masks "
                           f"replayed")
    return out


def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}


def keyed_step_check(model, dev, batch):
    """One keyed forward-KLD step (Adam 1e-3) of ``model``: on the card
    with the masks its generator draws, recorded; on the CPU on those
    masks. (loss error, gradient error relative, launches, masks)."""
    import nf_tpu_torch as nt

    x = nt.TwoMoons().sample(batch, generator=torch.Generator(
        device=dev).manual_seed(SEED + 200))
    out = []
    for device in (dev, "cpu"):
        m = copy.deepcopy(model).to(device)
        opt = torch.optim.Adam(m.parameters(), lr=1e-3)
        step = nt.make_forward_kld_step(opt, with_key=True).eager
        run = lambda: step(nt.init_train_state(m, opt), x.to(device),  # noqa
                           SEED + 201)
        if device == dev:
            counts = {}
            loss, masks = record_masks(lambda: _counted(counts, "step", run))
        else:
            loss = replay_masks(masks, run)
        out.append((float(loss), _grads(m)))
    (l1, g1), (l2, g2) = out
    grad_err = max(rel_err(g1[n].cpu(), g2[n]) for n in g1)
    return abs(l1 - l2), grad_err, counts["step"], masks


def circular_dropout_check(model, dev, score_fn):
    """One reverse-KLD step (SGD at lr 0) of the MADE-dropout circular NSF
    on the same base draws (B = 4096): on the card with its generator's
    masks, recorded; on the CPU on those masks. (loss error, gradient
    error relative, launches, masks drawn)."""
    import nf_tpu_torch as nt

    rng = np.random.default_rng(SEED + 210)
    z0 = np.stack([rng.uniform(-np.pi, np.pi, CIRC_CHECK_BATCH),
                   rng.standard_normal(CIRC_CHECK_BATCH)], axis=1)
    z0 = torch.from_numpy(z0.astype(np.float32))
    out = []
    for device in (dev, "cpu"):
        m = copy.deepcopy(model).to(device)
        zd = z0.to(device)
        m.q0.sample = lambda n, generator=None, zd=zd: zd
        opt = torch.optim.SGD(m.parameters(), lr=0.0)
        step = nt.make_reverse_kld_step(opt, num_samples=CIRC_CHECK_BATCH,
                                        score_fn=score_fn).eager
        gen = torch.Generator(device=device).manual_seed(SEED + 211)
        run = lambda: step(nt.init_train_state(m, opt), gen)  # noqa: E731
        if device == dev:
            counts = {}
            loss, masks = record_masks(lambda: _counted(counts, "step", run))
        else:
            loss = replay_masks(masks, run)
        out.append((float(loss), _grads(m)))
    (l1, g1), (l2, g2) = out
    grad_err = max(rel_err(g1[n].cpu(), g2[n]) for n in g1)
    return abs(l1 - l2), grad_err, counts["step"], len(masks)


def batch_norm_nsf_model(dev):
    """A ``build_nsf``-shaped model whose couplings' ``ResidualNet``s have
    ``use_batch_norm=True``, built through
    ``PiecewiseRationalQuadraticCoupling`` (as the JAX package allows):
    dim 2, K 8 couplings (hidden 128, 2 blocks, 8 bins, linear tails at 3,
    a bin-major head, the unconditional CDF on the identity half) each
    reversed as ``CoupledRationalQuadraticSpline`` does, and
    ``LULinearPermute``; perturbed as ``_nsf_model``, the norms' affine
    included."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import ResidualNet
    from nf_tpu_torch.utils import create_alternating_binary_mask

    gen = torch.Generator().manual_seed(SEED + 220)
    head = (1, 3 * K_BINS - 1)

    def net_fn(n_in, n_out):
        return ResidualNet(n_in, n_out, HIDDEN, num_blocks=2,
                           use_batch_norm=True, bin_major_head=head,
                           generator=gen)

    flows = []
    for i in range(8):
        mask = create_alternating_binary_mask(2, even=i % 2 == 1)
        flows += [tflows.Reverse(tflows.PiecewiseRationalQuadraticCoupling(
                      mask, net_fn, num_bins=K_BINS, tails="linear",
                      tail_bound=3.0, apply_unconditional_transform=True)),
                  tflows.LULinearPermute(2, generator=gen)]
    model = nt.NormalizingFlow(tdist.DiagGaussian(2, trainable=False),
                               flows).to(dev)
    perturb(model, SEED + 221)
    return model


def bn_kernel_check(model, dev):
    """Kernels B and E at a batch-norm trunk's operands (the first
    coupling, B = 65536): h_t from ``features_transposed`` (normalised over
    the batch on axis 1), both spline directions, against their plain
    versions. (B's y and ld errors, E's per-element and batch-sum
    errors)."""
    from nf_tpu_torch.ops import spline_head_fused as shf

    prqct = model.flows[0].flow
    net = prqct.transform_net
    rng = np.random.default_rng(SEED + 222)
    x = _normal(rng, (BATCH, 2), 1.5, dev)
    with torch.no_grad():
        id_split, t_split = prqct._split(x)
        h_t = net.features_transposed(id_split).contiguous()
        w, b = shf.effective_head(net.final_layer.weight,
                                  net.final_layer.bias, num_bins=K_BINS,
                                  feats=1, tails="linear",
                                  softmax_scale=prqct.softmax_scale)
    x_t = t_split.T.contiguous()
    tb = torch.full((1,), 3.0, device=dev)
    cty = _normal(rng, (1, BATCH), 1.0, dev)
    ctl = _normal(rng, (1, BATCH), 1.0, dev)
    worst = dict(y=0.0, ld=0.0, grad=0.0, sums=0.0)
    for inverse in (False, True):
        kw = dict(num_bins=K_BINS, tails="linear", inverse=inverse)
        y, ld = shf.fused_head_rqs(x_t, h_t, w, b, tail_bound=tb, **kw)
        yp, lp = shf.head_rqs_plain(x_t, h_t, w, b, tb, **kw)
        got = shf.fused_head_rqs_bwd(x_t, h_t, w, b, tb, cty, ctl, **kw)
        plain = shf.head_rqs_bwd_plain(x_t, h_t, w, b, tb, cty, ctl, **kw)
        grad = max(max_err(got[0], plain[0]), max_err(got[1], plain[1]))
        if grad > G_TOL:  # cuBLAS's order: hold E to its own order
            plain = shf.head_rqs_bwd_plain_in_kernel_order(
                x_t, h_t, w, b, tb, cty, ctl, **kw)
            grad = max(max_err(got[0], plain[0]), max_err(got[1], plain[1]))
        worst["y"] = max(worst["y"], max_err(y, yp))
        worst["ld"] = max(worst["ld"], max_err(ld, lp))
        worst["grad"] = max(worst["grad"], grad)
        worst["sums"] = max(worst["sums"], rel_err(got[2], plain[2]),
                            rel_err(got[3], plain[3]))
    if not (worst["y"] <= Y_TOL and worst["ld"] <= LD_TOL
            and worst["grad"] <= G_TOL and worst["sums"] <= SUM_TOL):
        raise RuntimeError(f"kernels B and E behind a batch-norm trunk "
                           f"disagree with their plain versions: {worst}")
    return worst


def phase_dropout_batch_norm(dev, flush):
    """Phase 20: dropout and batch norm on the kernels' paths, at full
    width. (a) ``build_nsf``'s arguments with dropout 0.1 in every trunk:
    its keyed forward-KLD step (Adam 1e-3, B = 65536) eagerly and as a
    graph, its masks from the step's registered generator (kernels B
    forward, E backward), one step card against CPU on injected masks,
    served ``log_prob`` bitwise the p = 0 model's, the graph step timed in
    turns against the unkeyed one. (b) ``build_circular_nsf`` at its
    defaults with MADE dropout 0.1: the reverse-KLD step at 2^14 with
    ``score_fn`` True and False, eagerly and as graphs (A, C), card against
    CPU on injected masks, one AR layer's round trip under one draw. (c) a
    ``build_nsf``-shaped model with batch-norm trunks: B and E at its
    operands against their plain versions, ``log_prob`` (B) and the step's
    gradients (E) card against CPU at 65536. Returns {path: launches}."""
    import nf_tpu_torch as nt
    from nf_tpu_torch.nets._dropout import shared_masks

    t0 = time.perf_counter()
    out = {}
    # (a) the dropout NSF's keyed step
    model = dropout_nsf_model(dev)
    loss_err, grad_err, per_step, masks = keyed_step_check(
        model, dev, DROP_CHECK_BATCH)
    step_want = {"rqs_fwd": 8, "head_rqs_fwd": 8, "rqs_bwd": 8,
                 "head_rqs_bwd": 8}
    _expect({"step": per_step}, {"step": step_want},
            "dropout build_nsf keyed step")
    if not (loss_err <= MODEL_TOL and grad_err <= TRAIN_TOL):
        raise RuntimeError(f"dropout build_nsf keyed step: card vs CPU on "
                           f"injected masks loss {loss_err:.3g}, gradients "
                           f"{grad_err:.3g} relative")
    shapes = sorted({tuple(m.shape) for m in masks})
    print(f"phase dropout build_nsf keyed step check (B = "
          f"{DROP_CHECK_BATCH}, p = {DROP_P}): card vs CPU on the card's "
          f"{len(masks)} injected masks (shapes {shapes}) loss {loss_err:.3g} (limit {MODEL_TOL}), gradients "
          f"{grad_err:.3g} relative (limit {TRAIN_TOL}); launches per step "
          f"{per_step}", flush=True)
    out["dropout build_nsf keyed step"] = (per_step, tuple(step_want))
    plain = _nsf_model()
    x = _normal(np.random.default_rng(SEED + 202), (BATCH, 2), 1.5, dev)
    lp_drop, lp_plain = (nt.compile_log_prob(m, (BATCH, 2))
                         for m in (model, plain))
    if not torch.equal(lp_drop(x), lp_plain(x)):
        raise RuntimeError("served log_prob of the dropout model differs "
                           "from the same weights at p = 0")
    out["dropout build_nsf served log_prob"] = (
        lp_drop.launches, ("rqs_fwd", "head_rqs_fwd"))
    del lp_drop, lp_plain
    pool = nt.TwoMoons().sample(10 * BATCH, generator=torch.Generator(
        device=dev).manual_seed(SEED + 203))

    def batch_of(i, which):
        return (pool[(i % 10) * BATCH:(i % 10 + 1) * BATCH], SEED + 300 + i)

    keyed = step_graphs(
        f"dropout build_nsf keyed forward-KLD step (p = {DROP_P}, B = "
        f"{BATCH})", model,
        lambda opt: nt.make_forward_kld_step(opt, with_key=True), batch_of,
        "build_nsf step", dict(lr=1e-3))
    _expect_launches(keyed["launches"], step_want,
                     "dropout build_nsf keyed step graph")
    out["graphs: dropout build_nsf keyed step"] = (
        keyed["launches"], PATH_KERNELS["build_nsf step"])
    # the keyed graph step against the unkeyed one, in turns
    steps = []
    for make, m in ((lambda o: nt.make_forward_kld_step(o), plain),
                    (lambda o: nt.make_forward_kld_step(o, with_key=True),
                     model)):
        mm = copy.deepcopy(m)
        opt = torch.optim.Adam(mm.parameters(), lr=1e-3, capturable=True)
        steps.append((make(opt), nt.init_train_state(mm, opt)))
    (unkeyed, s_u), (keyed_step, s_k) = steps
    xb = pool[:BATCH]
    for _ in range(3):  # two eager warm-up steps and the capture
        unkeyed(s_u, xb)
        keyed_step(s_k, xb, SEED + 7)
    (u1, u2), (k1, k2) = in_turns(lambda: unkeyed(s_u, xb),
                                  lambda: keyed_step(s_k, xb, SEED + 7))
    b_prof = keyed["report"]["kernels"]
    print(f"phase dropout build_nsf step graphs in turns (unkeyed, keyed, "
          f"keyed, unkeyed; wall ms per step, median of 10): unkeyed "
          f"{u1:.3f} / {u2:.3f}, keyed dropout {k1:.3f} / {k2:.3f}; kernels "
          f"B and E per step by the counters {keyed['launches']['head_rqs_fwd']}"
          f" / {keyed['launches']['head_rqs_bwd']}, by the profiler "
          f"{b_prof.get('head_rqs_fwd', 0)} / {b_prof.get('head_rqs_bwd', 0)}"
          f"; served log_prob bitwise the p = 0 model's", flush=True)
    del steps, unkeyed, keyed_step, s_u, s_k

    # (b) the circular NSF with MADE dropout
    circ = set_dropout(_circular_model(), DROP_P)
    circ.p = GaussVonMises()
    for score_fn in (True, False):
        per = 24 if score_fn else 36  # the re-pass: one more A and C a layer
        want = {"rqs_fwd": per, "rqs_bwd": per}
        loss_err, grad_err, per_step, n_masks = circular_dropout_check(
            circ, dev, score_fn)
        _expect({"step": per_step}, {"step": want},
                f"circular dropout step (score_fn={score_fn})")
        if not (loss_err <= MODEL_TOL and grad_err <= TRAIN_TOL):
            raise RuntimeError(f"circular dropout step (score_fn="
                               f"{score_fn}): card vs CPU loss "
                               f"{loss_err:.3g}, gradients {grad_err:.3g}")
        if n_masks != 12:
            raise RuntimeError(f"circular dropout step: {n_masks} masks "
                               f"drawn, expected 12 (one per MADE block, "
                               f"the re-pass reusing them)")
        print(f"phase dropout circular step check (score_fn={score_fn}, B "
              f"= {CIRC_CHECK_BATCH}, p = {DROP_P}): {n_masks} masks drawn "
              f"(the D passes and the re-pass reuse them), card vs CPU on "
              f"them loss {loss_err:.3g} (limit {MODEL_TOL}), gradients "
              f"{grad_err:.3g} relative (limit {TRAIN_TOL}); launches per "
              f"step {per_step}", flush=True)
        out[f"circular dropout step (score_fn={score_fn})"] = (
            per_step, ("rqs_fwd", "rqs_bwd"))
        gens = [torch.Generator(device=dev).manual_seed(SEED + 230)
                for _ in range(2)]
        step = step_graphs(
            f"circular dropout reverse-KLD step (score_fn={score_fn}, "
            f"B = {CIRC_TRAIN_BATCH})", circ,
            lambda opt, sf=score_fn: nt.make_reverse_kld_step(
                opt, num_samples=CIRC_TRAIN_BATCH, score_fn=sf),
            lambda i, which: (gens[which],), "circular step (analytic)",
            dict(lr=5e-4))
        _expect_launches(step["launches"], want,
                         f"circular dropout step graph (score_fn="
                         f"{score_fn})")
        out[f"graphs: circular dropout step (score_fn={score_fn})"] = (
            step["launches"], PATH_KERNELS["circular step (analytic)"])
    layer = circ.flows[0]
    rng = np.random.default_rng(SEED + 231)
    xc = np.stack([rng.uniform(-np.pi, np.pi, CIRC_BATCH),
                   rng.standard_normal(CIRC_BATCH) * 1.5], axis=1)
    xc = torch.from_numpy(xc.astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 232)
    counts = {}
    with torch.no_grad(), shared_masks():
        y, ld = _counted(counts, "forward", lambda: layer.forward(
            xc, generator=gen))
        back, ld_back = layer.inverse(y, generator=gen)
    rt = max(max_err(back, xc), max_err(ld + ld_back, torch.zeros_like(ld)))
    if not rt <= ROUND_TRIP_TOL:
        raise RuntimeError(f"circular AR layer under one mask draw: "
                           f"inverse(forward(x)) off by {rt:.3g}")
    print(f"phase dropout circular AR layer round trip (B = {CIRC_BATCH}, "
          f"one draw): {rt:.3g} (limit {ROUND_TRIP_TOL}); launches of its "
          f"forward (D = 2 passes) {counts['forward']}", flush=True)
    out["circular dropout AR round trip"] = (counts["forward"],
                                             ("rqs_fwd",))
    del circ

    # (c) batch-norm trunks
    bn = batch_norm_nsf_model(dev)
    worst = bn_kernel_check(bn, dev)
    cpu = copy.deepcopy(bn).to("cpu")
    x = _normal(np.random.default_rng(SEED + 223), (BATCH, 2), 1.5, dev)
    counts = {}
    with torch.no_grad():
        lp = _counted(counts, "log_prob", lambda: bn.log_prob(x))
        lp_cpu = cpu.log_prob(x.cpu())
    lp_err = max_err(lp.cpu(), lp_cpu)

    def bn_step(m, xx):
        loss = m.forward_kld(xx)
        loss.backward()
        return loss

    loss = _counted(counts, "step", lambda: bn_step(bn, x))
    loss_cpu = bn_step(cpu, x.cpu())
    grads, grads_cpu = _grads(bn), _grads(cpu)
    grad_err = max(rel_err(grads[n].cpu(), grads_cpu[n]) for n in grads)
    _expect(counts, {"log_prob": {"rqs_fwd": 8, "head_rqs_fwd": 8},
                     "step": step_want}, "batch-norm build_nsf")
    loss_err = abs(float(loss.detach()) - float(loss_cpu.detach()))
    if not (lp_err <= MODEL_TOL and loss_err <= MODEL_TOL
            and grad_err <= TRAIN_TOL):
        raise RuntimeError(f"batch-norm build_nsf card vs CPU: log_prob "
                           f"{lp_err:.3g}, loss {loss_err:.3g}, gradients "
                           f"{grad_err:.3g}")
    print(f"phase batch-norm build_nsf (B = {BATCH}, use_batch_norm=True "
          f"trunks): kernels B and E at its operands vs plain {worst}; card "
          f"vs CPU log_prob {lp_err:.3g} (limit {MODEL_TOL}), step loss "
          f"{loss_err:.3g}, gradients {grad_err:.3g} relative (limit "
          f"{TRAIN_TOL}); launches {counts}", flush=True)
    out["batch-norm build_nsf log_prob"] = (
        counts["log_prob"], ("rqs_fwd", "head_rqs_fwd"))
    out["batch-norm build_nsf step"] = (counts["step"], tuple(step_want))
    print(f"phase timing phase 20 (dropout, batch norm): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def change_base_model(dev):
    """``examples/change_base_distribution.py``'s model: a trainable
    ``GaussianMixture`` base of 2 modes at (-1, 0) and (1, 0), K 8
    ``AffineCouplingBlock``s over ``MLP [1, 64, 64, 2]`` (zero-init last
    layers) each followed by a swap ``Permute``, target ``TwoMoons``;
    perturbed off the identity (linear weights by N(0, (0.2/sqrt(fan_in))²),
    the rest by N(0, 0.05²): at 0.5 and 0.1 the exp-scaled couplings sent
    some of 65536 draws out of float32)."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import MLP

    gen = torch.Generator().manual_seed(SEED + 240)
    flows = []
    for _ in range(8):
        flows += [tflows.AffineCouplingBlock(MLP([1, 64, 64, 2],
                                                 init_zeros=True,
                                                 generator=gen)),
                  tflows.Permute(2, mode="swap")]
    q0 = tdist.GaussianMixture(2, 2, loc=[[-1.0, 0.0], [1.0, 0.0]])
    model = nt.NormalizingFlow(q0, flows, p=nt.TwoMoons()).to(dev)
    rng = np.random.default_rng(SEED + 241)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = (0.2 / np.sqrt(p.shape[1])
                     if p.ndim == 2 and name.endswith("weight") else 0.05)
            noise = np.asarray(rng.standard_normal(tuple(p.shape)) * scale,
                               dtype=np.float32)
            p.add_(torch.from_numpy(noise).to(dev))
    return model


def _distributions(dev):
    """Each new base, target and prior: (label, on the card, on the CPU,
    its log_prob's extra argument or None, whether it samples)."""
    from nf_tpu_torch import distributions as tdist

    rng = np.random.default_rng(SEED + 250)
    image = (rng.random((64, 48)) ** 3).astype(np.float32)
    y = torch.from_numpy(rng.integers(0, 10, BATCH))
    gm = tdist.GaussianMixture(3, 2, loc=[[-1.0, 0.0], [1.0, 0.5],
                                          [0.0, -1.5]],
                               weights=[0.2, 0.3, 0.5],
                               generator=torch.Generator().manual_seed(1))
    made = [("Uniform", tdist.Uniform(2, -2.0, 2.0), None),
            ("AffineGaussian", tdist.AffineGaussian(2, 2), None),
            ("AffineGaussian(num_classes=10)",
             tdist.AffineGaussian(2, 2, num_classes=10), y),
            ("GaussianMixture", gm, None),
            ("GaussianPCA", tdist.GaussianPCA(
                2, generator=torch.Generator().manual_seed(2), sigma=0.3),
             None),
            ("CircularGaussianMixture", tdist.CircularGaussianMixture(),
             None),
            ("RingMixture", tdist.RingMixture(), None),
            ("TwoIndependent", tdist.TwoIndependent(
                tdist.TwoMoons(), tdist.RingMixture()), None),
            ("Sinusoidal", tdist.Sinusoidal(), None),
            ("Sinusoidal_gap", tdist.Sinusoidal_gap(), None),
            ("Sinusoidal_split", tdist.Sinusoidal_split(), None),
            ("Smiley", tdist.Smiley(), None)]
    out = []
    for label, d, arg in made:
        with torch.no_grad():  # off the identity: the affine bases' s, t
            for p in d.parameters():
                p.add_(torch.from_numpy(np.asarray(
                    rng.standard_normal(tuple(p.shape)) * 0.2,
                    dtype=np.float32)))
        out.append((label, copy.deepcopy(d).to(dev), d, arg))
    out.append(("ImagePrior", tdist.ImagePrior(image, device=dev),
                tdist.ImagePrior(image, device="cpu"), None))
    return out


def _sample(d, n, gen, arg):
    """``n`` draws of ``d`` from ``gen`` (a base's with labels ``arg``),
    or None where ``d`` has no sampler (the sinusoidal priors)."""
    from nf_tpu_torch.distributions import BaseDistribution

    if isinstance(d, BaseDistribution):
        kw = {} if arg is None else dict(y=arg[:n].to(gen.device))
        return d.forward(n, generator=gen, **kw)[0]
    if hasattr(d, "sample"):
        return d.sample(n, generator=gen)
    return None


def phase_layers_distributions(dev, flush):
    """Phase 21: the change-of-base example's model (a trainable
    ``GaussianMixture`` base) trained by its forward-KLD step (Adam 3e-3,
    B = 512) eagerly and as a graph, and served at 65536 as graphs; every
    new distribution, target and prior card against CPU at 65536 and
    sampled on the card; a RealNVP-shaped stack with ``BatchNorm`` and
    ``InvertibleAffine`` card against CPU; and a bfloat16
    ``build_image_nsf``'s ``log_prob`` through kernel A's bfloat16
    instantiation. Returns {path: launches}."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import MLP

    t0 = time.perf_counter()
    out = {}
    model = change_base_model(dev)
    target = nt.TwoMoons()
    pool = target.sample(40 * CHANGE_BASE_BATCH, generator=torch.Generator(
        device=dev).manual_seed(SEED + 242))

    def batch_of(i, which):
        i %= 40
        return (pool[i * CHANGE_BASE_BATCH:(i + 1) * CHANGE_BASE_BATCH],)

    step = step_graphs(
        f"change-of-base model forward-KLD step (B = {CHANGE_BASE_BATCH})",
        model, nt.make_forward_kld_step, batch_of, "change_base step",
        dict(lr=CHANGE_BASE_LR))
    out["graphs: change_base step"] = (step["launches"], ())
    x = _normal(np.random.default_rng(SEED + 243), (BATCH, 2), 1.5, dev)
    served = serving_graphs("change_base", model, x, BATCH, {},
                            "change_base serving")
    out["graphs: change_base serving"] = (_captured_counts(served), ())
    cpu = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        lp_err = max_err(model.log_prob(x).cpu(), cpu.log_prob(x.cpu()))
        z, log_q = model.sample(BATCH, generator=torch.Generator(
            device=dev).manual_seed(SEED + 244))
        lq_err = max_err(model.log_prob(z), log_q)
    if not (lp_err <= MODEL_TOL and lq_err <= MODEL_TOL):
        raise RuntimeError(f"change_base: log_prob card vs CPU {lp_err:.3g}, "
                           f"log_prob(sample) vs log_q {lq_err:.3g}")
    print(f"phase change_base model: log_prob card vs CPU at {BATCH} "
          f"{lp_err:.3g}, log_prob(sample) vs log_q {lq_err:.3g} (limit "
          f"{MODEL_TOL})", flush=True)

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 251)
    cgen = torch.Generator().manual_seed(SEED + 252)
    z = _normal(np.random.default_rng(SEED + 253), (BATCH, 2), 1.5, "cpu")
    z4 = _normal(np.random.default_rng(SEED + 254), (BATCH, 4), 1.5, "cpu")
    for label, d, d_cpu, arg in _distributions(dev):
        zz = z4 if label == "TwoIndependent" else z
        args = () if arg is None else (arg,)
        with torch.no_grad():
            lp = d.log_prob(zz.to(dev), *(a.to(dev) for a in args))
            lp_cpu = d_cpu.log_prob(zz, *args)
        finite = torch.isfinite(lp_cpu)
        if not torch.equal(torch.isfinite(lp).cpu(), finite):
            raise RuntimeError(f"{label}: the card's log_prob is finite "
                               f"elsewhere than the CPU's")
        # relative to max(|log p|, 1): the priors reach 1e2-1e3 nats
        err = float(((lp.cpu() - lp_cpu).abs()[finite]
                     / lp_cpu.abs()[finite].clamp_min(1.0)).max())
        with torch.no_grad():
            s = _sample(d, BATCH, gen, args[0] if args else None)
            s_cpu = _sample(d_cpu, BATCH, cgen, args[0] if args else None)
        note = "no sampler"
        if s is not None:
            if s.shape != s_cpu.shape or not bool(torch.isfinite(s).all()):
                raise RuntimeError(f"{label}: card draws {tuple(s.shape)}, "
                                   f"finite {bool(torch.isfinite(s).all())}")
            # the draws' mean log-density on the card and on the CPU (other
            # random numbers) agree within 6 standard errors
            sa = args[0][:BATCH].to(dev) if args else None
            with torch.no_grad():
                a = d.log_prob(s, *(() if sa is None else (sa,))).double()
                b = d_cpu.log_prob(s_cpu, *args).double()
            a, b = a[torch.isfinite(a)].cpu(), b[torch.isfinite(b)]
            se = float(torch.sqrt(a.var() / a.numel() + b.var() / b.numel()))
            gap = abs(float(a.mean()) - float(b.mean()))
            if not gap <= 6 * se + 1e-6:
                raise RuntimeError(f"{label}: the card's draws' mean log p "
                                   f"{float(a.mean()):.4f}, the CPU's "
                                   f"{float(b.mean()):.4f} ({gap / se:.1f} "
                                   f"standard errors)")
            note = (f"sampled {tuple(s.shape)}, mean log p "
                    f"{float(a.mean()):.4f} vs the CPU's draws "
                    f"{float(b.mean()):.4f}")
        if not err <= 1e-4:
            raise RuntimeError(f"{label}: log_prob card vs CPU {err:.3g}")
        rows.append(f"{label} log_prob {err:.3g}, {note}")
    print(f"phase distributions (B = {BATCH}; log_prob card vs CPU "
          f"relative to max(|log p|, 1), limit 1e-4): " + "; ".join(rows),
          flush=True)

    # a RealNVP-shaped stack with BatchNorm and InvertibleAffine
    gen = torch.Generator().manual_seed(SEED + 260)
    flows = []
    for i in range(8):
        b = torch.tensor([1.0, 0.0] if i % 2 == 0 else [0.0, 1.0])
        flows += [tflows.MaskedAffineFlow(
                      b, t=MLP([2, 64, 64, 2], generator=gen),
                      s=MLP([2, 64, 64, 2], generator=gen)),
                  tflows.InvertibleAffine(2, generator=gen),
                  tflows.BatchNorm()]
    stack = nt.NormalizingFlow(tdist.DiagGaussian(2), flows).to(dev)
    perturb(stack, SEED + 261, size=0.2)
    cpu = copy.deepcopy(stack).to("cpu")
    zb = _normal(np.random.default_rng(SEED + 262), (BATCH, 2), 1.0, dev)
    w = _normal(np.random.default_rng(SEED + 263), (BATCH, 2), 1.0, dev)
    counts = {}

    def fwd(m, zz, ww):
        xx, ld = m.forward_and_log_det(zz)
        loss = (xx * ww).mean() + ld.mean()
        loss.backward()
        return xx, ld

    xg, ldg = _counted(counts, "forward", lambda: fwd(stack, zb, w))
    xc, ldc = fwd(cpu, zb.cpu(), w.cpu())
    errs = (max_err(xg.detach().cpu(), xc.detach()),
            max_err(ldg.detach().cpu(), ldc.detach()))
    grads, grads_cpu = _grads(stack), _grads(cpu)
    grad_err = max(rel_err(grads[n].cpu(), grads_cpu[n]) for n in grads)
    if not (max(errs) <= MODEL_TOL and grad_err <= TRAIN_TOL):
        raise RuntimeError(f"BatchNorm/InvertibleAffine stack card vs CPU: "
                           f"x, log-det {errs}, gradients {grad_err:.3g}")
    print(f"phase BatchNorm + InvertibleAffine stack (K 8, B = {BATCH}): "
          f"card vs CPU x {errs[0]:.3g}, log-det {errs[1]:.3g} (limit "
          f"{MODEL_TOL}), gradients {grad_err:.3g} relative (limit "
          f"{TRAIN_TOL}); launches {counts['forward']}", flush=True)
    out["BatchNorm stack"] = (counts["forward"], ())

    # a bfloat16 build_image_nsf runs kernel A's bfloat16 instantiation
    # (phase 28 drives it at full width)
    img = nt.build_image_nsf(dtype=torch.bfloat16, seed=SEED)
    xi = image_batch(16, SEED + 270, dev)[0].to(torch.bfloat16)
    counts = {}
    with torch.inference_mode():
        lp = _counted(counts, "log_prob", lambda: img.log_prob(xi))
    bf16 = _bf16_counts()
    if not (bool(torch.isfinite(lp).all())
            and counts["log_prob"]["rqs_fwd"] == IMG_COUPLINGS
            and bf16["rqs_fwd"] == IMG_COUPLINGS):
        raise RuntimeError(f"bfloat16 build_image_nsf log_prob: launches "
                           f"{counts}, bfloat16 {bf16}, finite "
                           f"{bool(torch.isfinite(lp).all())}")
    print(f"phase bf16 build_image_nsf: log_prob of 16 images ran, "
          f"{bf16['rqs_fwd']} bfloat16 launches of kernel A, mean "
          f"{float(lp.mean()):.4g}", flush=True)
    out["bf16 image_nsf log_prob"] = (
        _with_bf16(counts["log_prob"], bf16), ("rqs_fwd", "rqs_fwd_bf16"))
    print(f"phase timing phase 21 (layers, distributions): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --- phases 22-25: stochastic normalizing flows, HAIS, the flow VAE and the
# infrastructure -----------------------------------------------------------

SNF_K = 4  # examples/stochastic_nf.py: K 4 blocks, HMC after every second
SNF_HIDDEN = 64
SNF_LEAPFROG = 5
SNF_STEP = 0.2
SNF_ITERS = 1500  # the example's iterations: beta reaches 1 at 750
SNF_LR = 2e-3
SNF_BATCH = 1024
SNF_INIT = 512
SNF_STATS = 8192
SNF_NSF_BATCH = 4096  # B*D = 8192 >= the fused-head gate: kernels B and E
SNF_PERTURB = 0.1
# the spline layers' perturbation: the serving phase's 0.5 spreads the
# samples far off the target's ring, where the HMC layers' log-dets are
# tens of nats
SNF_NSF_PERTURB = 0.2
TIE = 1e-5  # |u - p| below which an accept decision may flip on rounding
MH_CHAINS = 65536
MH_STEPS = 200  # tests/test_stochastic_hais.py:79's chain
MH_SCALE = 0.5
# 4 x the largest deviation of the CPU's plain path from the quadrature
# over 5 seeds (tests/test_torch_hais.py measures it), rounded up
MH_MOMENT_TOL = 0.07
HAIS_SAMPLES = 4096  # examples/hais_sampling.py
HAIS_STEPS = 32
HAIS_LEAPFROG = 5
HAIS_STEP = 0.12
# max(4 x the standard deviation of the CPU's estimates over 5 seeds, 0.05)
# (tests/test_torch_hais.py)
HAIS_LOGZ_TOL = 0.05
VAE_N = 4096  # examples/vae.py: procedural 28 x 28 digits, latent 16
VAE_LATENT = 16
VAE_BATCH = 128
VAE_STEPS = 200
VAE_LR = 1e-3
VAE_IWAE_ROWS = 512
VAE_IWAE_SAMPLES = 16
PREFETCH_STEPS = 20
CKPT_STEPS = (3, 2)  # steps before the checkpoint, steps after it


def two_modes_quadrature():
    """``log Z`` of the TwoModes density and its moments ``E[x], E[y],
    E[x^2], E[y^2]``, by a Riemann sum on a 2801 x 2801 grid over [-7,
    7]^2 in float64 (numpy; the density's formula as
    ``TwoModes.log_prob``)."""
    g = np.linspace(-7.0, 7.0, 2801)
    x, y = np.meshgrid(g, g, indexing="ij")
    a, r = np.abs(x), np.hypot(x, y)
    log_p = (-0.5 * ((r - 2.0) / 0.4) ** 2 - 0.5 * ((a - 2.0) / 0.6) ** 2
             + np.log1p(np.exp(-2.0 * a * 2.0 / 0.36)))
    w = np.exp(log_p) * (g[1] - g[0]) ** 2
    z = w.sum()
    return float(np.log(z)), np.array([(w * x).sum(), (w * y).sum(),
                                       (w * x * x).sum(),
                                       (w * y * y).sum()]) / z


def moments(z):
    """``E[x], E[y], E[x^2], E[y^2]`` of samples ``z`` (N, 2), in float64."""
    z = z.detach().double().cpu()
    return np.array([float(z[:, 0].mean()), float(z[:, 1].mean()),
                     float((z[:, 0] ** 2).mean()),
                     float((z[:, 1] ** 2).mean())])


def log_z_estimate(log_w):
    return float(torch.logsumexp(log_w.double(), 0) - np.log(log_w.shape[0]))


def mh_chain(dev, seed):
    """The Metropolis-Hastings chain of phase 22c: ``MH_CHAINS`` chains on
    TwoModes started at (+-3, +-3), a quarter in each quadrant, with a
    ``DiagGaussianProposal`` of scale 0.5; ``(z, log_det, acceptance)``."""
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows

    mh = tflows.MetropolisHastings(
        tdist.TwoModes(), tdist.DiagGaussianProposal((2,), MH_SCALE),
        steps=MH_STEPS).to(dev)
    z0 = torch.tensor([[3.0, 3.0], [-3.0, 3.0], [3.0, -3.0], [-3.0, -3.0]],
                      device=dev).repeat(MH_CHAINS // 4, 1)
    return mh.forward_with_stats(z0, generator=torch.Generator(
        device=dev).manual_seed(seed))


def hais_model(dev):
    """``examples/hais_sampling.py``'s HAIS: TwoModes from a
    ``DiagGaussian(2)`` prior, 32 annealing steps (31 HMC layers), 5
    leapfrog steps of 0.12, unit mass."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import distributions as tdist

    return nt.sampling.HAIS.create(
        np.linspace(1.0, 0.0, HAIS_STEPS + 1),
        tdist.DiagGaussian(2, trainable=False), tdist.TwoModes(),
        num_leapfrog=HAIS_LEAPFROG, step_size=[HAIS_STEP] * 2,
        log_mass=[0.0] * 2, device=dev)


def snf_model(dev, kind):
    """``examples/stochastic_nf.py``'s SNF (``kind`` "affine": K 4 blocks
    of ``MaskedAffineFlow`` over MLPs [2, 64, 64, 2] and ``ActNorm``) or
    the same recipe over ``build_nsf``'s layer pairs (``kind`` "nsf":
    ``CoupledRationalQuadraticSpline`` with a ResidualNet trunk of hidden
    128, 8 bins, 2 blocks, then ``LULinearPermute``), with an HMC layer (5
    leapfrog steps of 0.2, log-mass 0) after every second block targeting
    ``LinearInterpolation(TwoModes, base, (i + 1) / K)``, and TwoModes as
    the model's target. The deterministic layers are perturbed off the
    identity (the affine nets by 0.1, the spline layers by 0.2); the HMC
    layers keep the example's values."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import MLP
    from nf_tpu_torch.utils.masks import create_alternating_binary_mask

    gen = torch.Generator().manual_seed(SEED + 300)
    base = tdist.DiagGaussian(2, trainable=False)
    target = tdist.TwoModes()
    if kind == "nsf":
        nsf = nt.build_nsf(dim=2, K=SNF_K, hidden=HIDDEN, num_bins=K_BINS,
                           num_blocks=2, tail_bound=3.0, device="cpu",
                           seed=SEED)
        perturb(nsf, SEED + 301, size=SNF_NSF_PERTURB)
    flows = []
    for i in range(SNF_K):
        if kind == "nsf":
            flows += list(nsf.flows[2 * i:2 * i + 2])
        else:
            widths = [2, SNF_HIDDEN, SNF_HIDDEN, 2]
            coupling = tflows.MaskedAffineFlow(
                create_alternating_binary_mask(2, even=(i % 2 == 0)),
                t=MLP(widths, init_zeros=True, generator=gen),
                s=MLP(widths, init_zeros=True, generator=gen))
            perturb(coupling, SEED + 302 + i, size=SNF_PERTURB)
            flows += [coupling, tflows.ActNorm(2)]
        if (i + 1) % 2 == 0:
            flows.append(tflows.HamiltonianMonteCarlo(
                tdist.LinearInterpolation(target, base,
                                          alpha=(i + 1) / SNF_K),
                SNF_LEAPFROG, np.log(np.full(2, SNF_STEP)), np.zeros(2)))
    return nt.NormalizingFlow(base, flows, p=target).to(dev)


def _hmc_layers(model):
    from nf_tpu_torch.flows import HamiltonianMonteCarlo

    return [m for m in model.modules()
            if isinstance(m, HamiltonianMonteCarlo)]


def record_draws(base, layers, fn):
    """Run ``fn`` (eagerly) with ``base`` keeping what its ``forward``
    returned and each HMC layer of ``layers`` its draws (momentum,
    uniforms) and its acceptance probabilities, per call, on the CPU:
    ``(result, record)``."""
    rec = {"base": [], "draws": [[] for _ in layers],
           "prob": [[] for _ in layers]}
    real_base = base.forward

    def base_forward(*args, **kw):
        z, log_p = real_base(*args, **kw)
        rec["base"].append((z.detach().cpu(), log_p.detach().cpu()))
        return z, log_p

    base.forward = base_forward
    for i, layer in enumerate(layers):
        layer.draw = _recorded(layer.draw, rec["draws"][i], cpu=True)
        layer.trajectory = _recorded(layer.trajectory, rec["prob"][i],
                                     pick=1)
    try:
        out = fn()
    finally:
        _unpatch(base, layers)
    return out, rec


def _recorded(fn, into, cpu=False, pick=None):
    def call(*args, **kw):
        out = fn(*args, **kw)
        kept = out if pick is None else out[pick]
        into.append(tuple(t.detach().cpu() for t in kept) if cpu
                    else kept.detach().cpu())
        return out
    return call


def _unpatch(base, layers):
    del base.forward
    for layer in layers:
        for name in ("draw", "trajectory"):
            if name in layer.__dict__:
                delattr(layer, name)


def replay_draws(rec, build, device, dtype=torch.float32):
    """Run a fresh call of ``build() -> (base, HMC layers, fn)`` on
    ``device`` with ``base`` and the layers handed the card's draws of
    ``rec`` (as ``dtype``). An accept decision ``u < p`` may come out
    otherwise here than on the card where ``u`` lies within ``TIE`` of
    ``p``; such a chain is run again (a fresh ``build()``) with the card's
    decision (its uniform set to -inf or +inf), until every decision is
    the card's. Fails if a decision differs anywhere else. ``(fn's result, the count of chains
    decided by the card at a tie)``."""
    forced = {}
    for _ in range(6):
        base, layers, fn = build()
        probs = [[] for _ in layers]
        base_it = iter(rec["base"])
        base.forward = lambda *a, **k: tuple(
            t.to(device, dtype) for t in next(base_it))
        for i, layer in enumerate(layers):
            layer.draw = _replayer(rec["draws"][i], forced, i, device, dtype)
            layer.trajectory = _recorded(layer.trajectory, probs[i], pick=1)
        try:
            out = fn()
        finally:
            _unpatch(base, layers)
        new = 0
        for i in range(len(layers)):
            for c, ((_, u), p_card, p_here) in enumerate(zip(
                    rec["draws"][i], rec["prob"][i], probs[i])):
                differ = (u < p_card) != (u < p_here)
                done = forced.get((i, c))
                if done is not None:
                    differ &= ~done[0]
                if not bool(differ.any()):
                    continue
                p_here = p_here.float()
                tie = ((u - p_here).abs() < TIE) | ((u - p_card).abs() < TIE)
                if bool((differ & ~tie).any()):
                    j = int(torch.nonzero(differ & ~tie)[0])
                    raise RuntimeError(
                        f"HMC layer {i} call {c}: chain {j} decided "
                        f"otherwise than on the card away from a tie (u "
                        f"{float(u[j]):.7g}, p card {float(p_card[j]):.7g}"
                        f", here {float(p_here[j]):.7g})")
                mask = differ if done is None else done[0] | differ
                forced[i, c] = (mask, u < p_card)
                new += int(differ.sum())
        if not new:
            return out, sum(int(m.sum()) for m, _ in forced.values())
    raise RuntimeError("the accept decisions did not settle in 6 replays")


def _replayer(calls, forced, i, device, dtype):
    it = iter(enumerate(calls))

    def draw(z, generator=None):
        c, (p_unit, u) = next(it)
        f = forced.get((i, c))
        if f is not None:
            mask, accept = f
            u = torch.where(mask, torch.where(accept, -np.inf, np.inf), u)
        return p_unit.to(device, dtype), u.to(device, dtype)
    return draw


def snf_step_check(model, dev, batch, beta):
    """One eager annealed reverse-KLD step (Adam, ``SNF_LR``) of ``model``
    at ``batch``: on the card, recording its draws, and on the CPU on
    them. ``(loss error, gradient error relative, launches, ties)``."""
    import nf_tpu_torch as nt

    def build(device):
        m = copy.deepcopy(model).to(device)
        opt = torch.optim.Adam(m.parameters(), lr=SNF_LR)
        step = nt.make_reverse_kld_step(opt, num_samples=batch,
                                        beta_schedule=lambda t: beta).eager
        gen = torch.Generator(device=device).manual_seed(SEED + 310)
        return m.q0, _hmc_layers(m), lambda: (
            step(nt.init_train_state(m, opt), gen), _grads(m))

    counts = {}
    base, layers, run = build(dev)
    (l1, g1), rec = record_draws(base, layers, lambda: _counted(
        counts, "step", run))
    (l2, g2), ties = replay_draws(rec, lambda: build("cpu"), "cpu")
    grad_err = max(rel_err(g1[n].cpu(), g2[n]) for n in g1)
    return abs(float(l1) - float(l2)), grad_err, counts["step"], ties


def sample_check(label, model, dev, batch, stats=False):
    """``sample`` (or ``sample_with_mcmc_stats``) of ``model`` at ``batch``
    on the card, then on the CPU on the card's draws, in float32 and in
    float64: ``(result, its launches, max error of z and log_q card vs
    CPU, the limit, ties)``. The limit is 1e-3, or twice the CPU's own
    float32 error against float64 where that is larger (the leapfrog
    amplifies every layer's rounding, as the circular coupling's phase
    holds its float32 models). Fails on non-finite values."""
    counts = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 311)

    def run(m, g):
        def call():
            with torch.inference_mode():
                return (m.sample_with_mcmc_stats(batch, generator=g) if stats
                        else m.sample(batch, generator=g))
        return call

    def on_cpu(dtype):
        m = copy.deepcopy(model).to("cpu", dtype)
        return lambda: (m.q0, _hmc_layers(m), run(m, None))

    got, rec = record_draws(model.q0, _hmc_layers(model), lambda: _counted(
        counts, "sample", run(model, gen)))
    want, ties = replay_draws(rec, on_cpu(torch.float32), "cpu")
    exact, _ = replay_draws(rec, on_cpu(torch.float64), "cpu",
                            torch.float64)
    err = max(max_err(got[0].cpu(), want[0]), max_err(got[1].cpu(), want[1]))
    own = max(max_err(want[0].double(), exact[0]),
              max_err(want[1].double(), exact[1]))
    limit = max(MODEL_TOL, 2 * own)
    if not (bool(torch.isfinite(got[0]).all())
            and bool(torch.isfinite(got[1]).all())):
        raise RuntimeError(f"{label}: non-finite samples or log q")
    if not err <= limit:
        raise RuntimeError(f"{label}: card vs CPU on the card's draws "
                           f"{err:.3g} > {limit:.3g} (the CPU's float32 "
                           f"against float64 {own:.3g})")
    return got, counts["sample"], err, limit, ties


def _acceptance_text(acc):
    return "[" + ", ".join(f"{float(a.mean()):.4f}" for a in acc) + "]"


def phase_snf(dev, flush):
    """Phase 22a: ``examples/stochastic_nf.py``'s SNF (K 4 affine blocks,
    HMC after every second) on TwoModes: ``init_from_samples(512)``, one
    annealed reverse-KLD step card against CPU on the card's draws (B =
    1024), the step eager against graph in turns (five steps within 1e-5,
    timed, profiled), ``sample_with_mcmc_stats`` at 8192 against the CPU
    (its acceptance rates), the sampler served as a graph at 65536 (bitwise
    eager). No port kernel runs. Returns ``({path: launches}, model)``."""
    import nf_tpu_torch as nt

    t0 = time.perf_counter()
    model = snf_model(dev, "affine")
    counts = {}
    _counted(counts, "init", lambda: model.init_from_samples(
        SNF_INIT, generator=torch.Generator(device=dev).manual_seed(
            SEED + 312)))
    loss_err, grad_err, per_step, ties = snf_step_check(
        model, dev, SNF_BATCH, beta=0.05)
    if not (loss_err <= TRAIN_TOL and grad_err <= TRAIN_TOL):
        raise RuntimeError(f"snf step card vs CPU: loss {loss_err:.3g}, "
                           f"gradients {grad_err:.3g} (limit {TRAIN_TOL})")
    (z, log_q, acc), per_stats, stats_err, stats_limit, stats_ties = \
        sample_check("snf sample_with_mcmc_stats", model, dev, SNF_STATS,
                     stats=True)
    _expect({"init": counts["init"], "step": per_step,
             "sample_with_mcmc_stats": per_stats},
            {"init": {}, "step": {}, "sample_with_mcmc_stats": {}},
            "snf")
    print(f"phase snf (examples/stochastic_nf.py: K {SNF_K} MaskedAffineFlow"
          f" + ActNorm blocks, MLPs [2, {SNF_HIDDEN}, {SNF_HIDDEN}, 2], HMC "
          f"({SNF_LEAPFROG} leapfrog steps of {SNF_STEP}) after every second"
          f", TwoModes): init_from_samples({SNF_INIT}); reverse-KLD step (B "
          f"= {SNF_BATCH}, beta 0.05) card vs CPU on the card's draws: loss "
          f"{loss_err:.3g}, gradients {grad_err:.3g} relative (limit "
          f"{TRAIN_TOL}; {ties} accept decisions at a tie taken from the "
          f"card); sample_with_mcmc_stats (B = {SNF_STATS}) card vs CPU "
          f"{stats_err:.3g} (limit {stats_limit:.3g}; ties {stats_ties}), HMC "
          f"acceptance per layer {_acceptance_text(acc)}, mean |z| "
          f"{float(z.norm(dim=1).mean()):.4f}; no port kernel launched",
          flush=True)
    out = {"snf init": (counts["init"], ()), "snf step": (per_step, ()),
           "snf sample_with_mcmc_stats": (per_stats, ())}
    gens = [torch.Generator(device=dev).manual_seed(SEED + 313)
            for _ in range(2)]
    step = step_graphs(
        f"snf annealed reverse-KLD step (B = {SNF_BATCH})", model,
        lambda opt: nt.make_reverse_kld_step(
            opt, num_samples=SNF_BATCH,
            beta_schedule=lambda t: min(1.0, 0.05 + t / (SNF_ITERS // 2))),
        lambda i, which: (gens[which],), "snf step", dict(lr=SNF_LR))
    _expect_launches(step["launches"], {}, "snf step graph")
    out["graphs: snf step"] = (step["launches"], ())
    out["graphs: snf serving"] = (_sampler_graph("snf", model, BATCH), ())
    print(f"phase timing phase 22a (snf): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out, model


def _sampler_graph(label, model, batch):
    """``compile_sampler(model, batch)`` against eager sampling, bitwise
    for two seeds; times in turns and a profiled replay. Returns the
    capture's launches."""
    import nf_tpu_torch as nt

    sampler = nt.compile_sampler(model, batch)
    for seed in (SEED, SEED + 1):
        z, log_q = sampler(seed)
        with torch.inference_mode():
            ze, lqe = model.sample(batch, generator=torch.Generator(
                "cuda").manual_seed(seed))
        if not (torch.equal(z, ze) and torch.equal(log_q, lqe)):
            raise RuntimeError(f"{label} sampler: the graph's draws for seed"
                               f" {seed} differ from eager "
                               f"({max_err(z, ze):.3g})")
    gen = torch.Generator("cuda").manual_seed(SEED)

    def eager():
        with torch.inference_mode():
            return model.sample(batch, generator=gen)

    turns = in_turns(eager, lambda: sampler(SEED))
    report = replay_report(lambda: sampler(SEED), f"{label} serving")
    print(f"phase graphs {label} sampler (B = {batch}): graph bitwise eager "
          f"for two seeds; capture counted {sampler.launches}; "
          + _turns_text(turns) + "; " + _report_text(report), flush=True)
    return sampler.launches


def phase_snf_nsf(dev, flush):
    """Phase 22b: the SNF recipe over ``build_nsf``'s layer pairs (hidden
    128, 8 bins, 2 blocks, ``LULinearPermute``; HMC after every second
    pair): the reverse-KLD step at B = 4096 (kernel B forward and kernel
    E backward in the couplings, A and C on their identity halves' CDF,
    behind and in front of the HMC layers' second-order gradient) card against CPU on the card's draws, eager against graph
    in turns, timed in turns against ``build_nsf``'s own step (the same
    layers without the HMC layers); the sampler at 65536 card against CPU
    and as a graph. Returns {path: launches}."""
    import nf_tpu_torch as nt

    t0 = time.perf_counter()
    model = snf_model(dev, "nsf")
    loss_err, grad_err, per_step, ties = snf_step_check(
        model, dev, SNF_NSF_BATCH, beta=1.0)
    if not (loss_err <= TRAIN_TOL and grad_err <= TRAIN_TOL):
        raise RuntimeError(f"snf_nsf step card vs CPU: loss {loss_err:.3g}, "
                           f"gradients {grad_err:.3g} (limit {TRAIN_TOL})")
    (z, log_q), per_sample, sample_err, sample_limit, sample_ties = \
        sample_check("snf_nsf sample", model, dev, BATCH)
    for what, c in (("step", per_step), ("sample", per_sample)):
        _expect({what: c}, {what: {k: SNF_K for k in PATH_KERNELS[
            f"snf_nsf {'step' if what == 'step' else 'serving'}"]}},
            "snf_nsf")
    print(f"phase snf_nsf (build_nsf's layers, K {SNF_K}, hidden {HIDDEN}, "
          f"{K_BINS} bins, HMC after every second pair): reverse-KLD step "
          f"(B = {SNF_NSF_BATCH}) card vs CPU on the card's draws: loss "
          f"{loss_err:.3g}, gradients {grad_err:.3g} relative (limit "
          f"{TRAIN_TOL}; ties {ties}), launches {per_step}; sample (B = "
          f"{BATCH}) card vs CPU {sample_err:.3g} (limit {sample_limit:.3g}, "
          f"1e-3 or twice the CPU's float32 error against float64; ties "
          f"{sample_ties}), launches {per_sample}", flush=True)
    out = {"snf_nsf step": (per_step, PATH_KERNELS["snf_nsf step"]),
           "snf_nsf sample": (per_sample, PATH_KERNELS["snf_nsf serving"])}
    gens = [torch.Generator(device=dev).manual_seed(SEED + 320)
            for _ in range(2)]

    def make(opt):
        return nt.make_reverse_kld_step(opt, num_samples=SNF_NSF_BATCH)

    step = step_graphs(f"snf_nsf reverse-KLD step (B = {SNF_NSF_BATCH})",
                       model, make, lambda i, which: (gens[which],),
                       "snf_nsf step", dict(lr=SNF_LR))
    _expect_launches(step["launches"], {
        k: SNF_K for k in PATH_KERNELS["snf_nsf step"]},
        "snf_nsf step graph")
    out["graphs: snf_nsf step"] = (step["launches"],
                                   PATH_KERNELS["snf_nsf step"])
    # build_nsf's own step: the same layers, no HMC layer
    plain = nt.NormalizingFlow(
        copy.deepcopy(model.q0),
        [copy.deepcopy(f) for f in model.flows if not _hmc_layers(f)],
        p=nt.TwoModes())
    states, steps = [], []
    for m in (model, plain):
        m = copy.deepcopy(m)
        opt = torch.optim.Adam(m.parameters(), lr=SNF_LR, capturable=True)
        states.append(nt.init_train_state(m, opt))
        steps.append(make(opt))
    gen2 = [torch.Generator(device=dev).manual_seed(SEED + 321)
            for _ in range(2)]
    for _ in range(3):  # two warm-up steps, then the capture
        for st, s, g in zip(states, steps, gen2):
            s(st, g)
    ms = {}
    for label, k in (("snf", 0), ("build_nsf", 1), ("build_nsf", 1),
                     ("snf", 0)):
        ms.setdefault(label, []).append(host_ms(
            lambda: steps[k](states[k], gen2[k])))
    eager_ms = {label: host_ms(lambda: steps[k].eager(states[k], gen2[k]))
                for label, k in (("snf", 0), ("build_nsf", 1))}
    plain_report = replay_report(lambda: steps[1](states[1], gen2[1]),
                                 "nsf reverse step")
    print(f"phase snf_nsf cost of the HMC layers (reverse-KLD step, B = "
          f"{SNF_NSF_BATCH}, graphs in turns snf, build_nsf, build_nsf, snf;"
          f" wall ms per step, median of 10): snf {ms['snf'][0]:.3f} / "
          f"{ms['snf'][1]:.3f}, build_nsf {ms['build_nsf'][0]:.3f} / "
          f"{ms['build_nsf'][1]:.3f}; eager snf {eager_ms['snf']:.3f}, "
          f"build_nsf {eager_ms['build_nsf']:.3f}; build_nsf's graph: "
          + _report_text(plain_report), flush=True)
    out["graphs: nsf reverse step"] = (steps[1].launches,
                                       PATH_KERNELS["nsf reverse step"])
    out["graphs: snf_nsf serving"] = (_sampler_graph("snf_nsf", model, BATCH),
                                      PATH_KERNELS["snf_nsf serving"])
    print(f"phase timing phase 22b (snf_nsf): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_mh(dev):
    """Phase 22c: ``MH_CHAINS`` Metropolis-Hastings chains on TwoModes
    (``DiagGaussianProposal`` 0.5, 200 steps, from (+-3, +-3)): the first
    two moments against the quadrature within ``MH_MOMENT_TOL``, the
    acceptance per step; no port kernel. Returns {path: launches}."""
    t0 = time.perf_counter()
    counts = {}
    with torch.inference_mode():
        z, log_det, acc = _counted(counts, "chain", lambda: mh_chain(
            dev, SEED + 330))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _expect(counts, {"chain": {}}, "mh chain")
    _, want = two_modes_quadrature()
    got = moments(z)
    dev_max = float(np.max(np.abs(got - want)))
    if not (dev_max <= MH_MOMENT_TOL and bool(torch.isfinite(log_det).all())):
        raise RuntimeError(f"mh chain: moments {got} against the quadrature's"
                           f" {want}: {dev_max:.3g} > {MH_MOMENT_TOL}")
    print(f"phase mh ({MH_CHAINS} chains, DiagGaussianProposal {MH_SCALE}, "
          f"{MH_STEPS} steps, TwoModes): E[x], E[y], E[x^2], E[y^2] = "
          + ", ".join(f"{v:.4f}" for v in got) + " (quadrature "
          + ", ".join(f"{v:.4f}" for v in want) + f"), largest deviation "
          f"{dev_max:.4g} (limit {MH_MOMENT_TOL}); acceptance first step "
          f"{float(acc[0]):.4f}, last {float(acc[-1]):.4f}; {ms:.1f} ms "
          f"wall, eager, the first call", flush=True)
    return {"mh chain": (counts["chain"], ())}


def phase_hais(dev, flush):
    """Phase 23: ``examples/hais_sampling.py``'s HAIS (4096 samples, 31 HMC
    layers) eagerly and as a ``compile_sampler`` graph, in turns:
    log-weights card against CPU on the card's draws, graph bitwise eager,
    the ESS and the ``log Z`` estimate (against the quadrature within
    ``HAIS_LOGZ_TOL``), the acceptance along the schedule. No port
    kernel. Returns {path: launches}."""
    import nf_tpu_torch as nt

    t0 = time.perf_counter()
    hais = hais_model(dev)
    cpu = copy.deepcopy(hais).to("cpu")
    gen = torch.Generator(device=dev).manual_seed(SEED + 340)
    counts = {}

    def run(h, g):
        def call():
            with torch.inference_mode():
                return h.sample_with_stats(HAIS_SAMPLES, generator=g)
        return call

    (z, log_w, acc), rec = record_draws(
        hais.prior, list(hais.layers), lambda: _counted(
            counts, "sample", run(hais, gen)))
    (zc, lwc, accc), ties = replay_draws(rec, lambda: (
        cpu.prior, list(cpu.layers), run(cpu, None)), "cpu")
    err = max(max_err(z.cpu(), zc), max_err(log_w.cpu(), lwc))
    if not err <= MODEL_TOL:
        raise RuntimeError(f"hais: card vs CPU on the card's draws "
                           f"{err:.3g} > {MODEL_TOL}")
    if not torch.equal(acc.cpu(), accc):
        raise RuntimeError("hais: acceptance card vs CPU differs")
    _expect(counts, {"sample": {}}, "hais")
    log_z, _ = two_modes_quadrature()
    est = log_z_estimate(log_w)
    ess = float(nt.utils.effective_sample_size(log_w))
    if not abs(est - log_z) <= HAIS_LOGZ_TOL:
        raise RuntimeError(f"hais: log Z {est:.5f} against the quadrature's "
                           f"{log_z:.5f} (limit {HAIS_LOGZ_TOL})")
    sampler = nt.compile_sampler(hais, HAIS_SAMPLES)
    zg, lwg = sampler(SEED + 341)
    with torch.inference_mode():
        ze, lwe = hais.sample(HAIS_SAMPLES, generator=torch.Generator(
            "cuda").manual_seed(SEED + 341))
    if not (torch.equal(zg, ze) and torch.equal(lwg, lwe)):
        raise RuntimeError("hais: the sampler graph differs from eager")

    def eager():
        with torch.inference_mode():
            return hais.sample(HAIS_SAMPLES, generator=gen)

    turns = in_turns(eager, lambda: sampler(SEED))
    report = replay_report(lambda: sampler(SEED), "hais serving")
    print(f"phase hais (examples/hais_sampling.py: {HAIS_SAMPLES} samples, "
          f"{HAIS_STEPS} annealing steps, {HAIS_LEAPFROG} leapfrog steps of "
          f"{HAIS_STEP}, TwoModes from DiagGaussian(2)): log-weights and "
          f"samples card vs CPU on the card's draws {err:.3g} (limit "
          f"{MODEL_TOL}; ties {ties}); ESS {ess:.1f} / {HAIS_SAMPLES}; log Z "
          f"{est:.5f}, quadrature {log_z:.5f} (limit {HAIS_LOGZ_TOL}); "
          f"acceptance along the schedule min {float(acc.min()):.4f}, mean "
          f"{float(acc.mean()):.4f}, max {float(acc.max()):.4f}; sampler "
          f"graph bitwise eager; capture counted {sampler.launches}; "
          + _turns_text(turns) + "; " + _report_text(report), flush=True)
    print(f"phase timing phase 23 (hais): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"hais sample": (counts["sample"], ()),
            "graphs: hais serving": (sampler.launches, ())}


def procedural_digits(seed, n=VAE_N, side=28):
    """``examples/vae.py``'s zero-download digits in numpy: a Gaussian bump
    at a class-dependent position and uniform noise, (n, side * side)
    float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 10, n)
    yy, xx = np.mgrid[0:side, 0:side] / side
    cx = 0.25 + 0.5 * (cls % 3)[:, None, None] / 2.0
    cy = 0.25 + 0.5 * (cls // 3)[:, None, None] / 3.0
    img = np.exp(-(((xx[None] - cx) ** 2 + (yy[None] - cy) ** 2) / 0.02))
    img = np.clip(img + 0.05 * rng.random(img.shape), 0, 1)
    return img.reshape(n, -1).astype(np.float32)


def vae_model(dev):
    """``examples/vae.py``'s model: an ``NNDiagGaussian`` encoder on an MLP
    [784, 256, 256, 32], 4 ``MaskedAffineFlow`` posterior layers on MLPs
    [16, 128, 16] (zero-init, alternating half masks), an
    ``NNBernoulliDecoder`` on an MLP [16, 256, 256, 784] and a fixed
    ``DiagGaussian(16)`` prior."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import distributions as tdist
    from nf_tpu_torch import flows as tflows
    from nf_tpu_torch.nets import MLP

    gen = torch.Generator().manual_seed(SEED + 350)
    L = VAE_LATENT
    flows = []
    for i in range(4):
        b = torch.tensor([1.0] * (L // 2) + [0.0] * (L - L // 2))
        b = b if i % 2 == 0 else 1.0 - b
        flows.append(tflows.MaskedAffineFlow(
            b, t=MLP([L, 128, L], init_zeros=True, generator=gen),
            s=MLP([L, 128, L], init_zeros=True, generator=gen)))
    return nt.NormalizingFlowVAE(
        tdist.DiagGaussian(L, trainable=False),
        tdist.NNDiagGaussian(MLP([784, 256, 256, 2 * L], generator=gen)),
        flows=flows,
        decoder=tdist.NNBernoulliDecoder(MLP([L, 256, 256, 784],
                                             generator=gen))).to(dev)


def negative_elbo(model, x, generator):
    """``examples/vae.py``'s loss: ``mean(log q - log p)`` of one
    posterior sample per row."""
    _, log_q, log_p = model(x, num_samples=1, generator=generator)
    return torch.mean(log_q - log_p)


def phase_vae(dev, flush):
    """Phase 24: ``examples/vae.py``'s flow VAE on its procedural digits:
    one keyed negative-ELBO step card against CPU on the card's encoder
    draws, then 200 steps of ``make_forward_kld_step(..., with_key=True)``
    (Adam 1e-3, batch 128) as a graph and eagerly, in turns, on the same
    batches and seeds (the first five within 1e-5 of each other, the loss
    falling on both), timed and profiled; then the IWAE-16 bound on 512
    rows. No port kernel. Returns {path: launches}."""
    import nf_tpu_torch as nt

    t0 = time.perf_counter()
    x_all = torch.from_numpy(procedural_digits(SEED + 351)).to(dev)
    idx = torch.from_numpy(np.random.default_rng(SEED + 352).integers(
        0, VAE_N, (VAE_STEPS + 40, VAE_BATCH))).to(dev)
    base = vae_model(dev)
    # one step card against CPU on the card's encoder draws
    out = []
    for device in (dev, "cpu"):
        m = copy.deepcopy(base).to(device)
        opt = torch.optim.Adam(m.parameters(), lr=VAE_LR)
        step = nt.make_forward_kld_step(opt, loss_fn=negative_elbo,
                                        with_key=True).eager
        run = lambda: step(nt.init_train_state(m, opt),  # noqa: E731
                           x_all[idx[0]].to(device), SEED + 353)
        if device == dev:
            counts = {}
            eps = []
            m.q0.draw = _recorded(m.q0.draw, eps)
            loss = _counted(counts, "step", run)
        else:
            it = iter(eps)
            m.q0.draw = lambda shape, generator, like: next(it).to(
                like.device)
            loss = run()
        del m.q0.draw
        out.append((float(loss), _grads(m)))
    (l1, g1), (l2, g2) = out
    grad_err = max(rel_err(g1[n].cpu(), g2[n]) for n in g1)
    if not (abs(l1 - l2) <= TRAIN_TOL * max(abs(l2), 1.0)
            and grad_err <= TRAIN_TOL):
        raise RuntimeError(f"vae step card vs CPU: loss {abs(l1 - l2):.3g}, "
                           f"gradients {grad_err:.3g} (limit {TRAIN_TOL})")
    _expect(counts, {"step": {}}, "vae step")
    # 200 steps, graph and eager in turns
    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [torch.optim.Adam(m.parameters(), lr=VAE_LR, capturable=True)
            for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    graphed = nt.make_forward_kld_step(opts[0], loss_fn=negative_elbo,
                                       with_key=True)
    eager = nt.make_forward_kld_step(opts[1], loss_fn=negative_elbo,
                                     with_key=True).eager
    losses = [[], []]
    wall = [0.0, 0.0]
    for i in range(VAE_STEPS):
        x = x_all[idx[i]]
        for k, (fn, st) in enumerate(((graphed, states[0]),
                                      (eager, states[1]))):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses[k].append(fn(st, x, SEED + 400 + i))
            torch.cuda.synchronize()
            wall[k] += time.perf_counter() - t1
    lg, le = (torch.stack(v).cpu() for v in losses)
    early = max_err(lg[:GRAPH_STEPS], le[:GRAPH_STEPS])
    if not early <= STEP_TOL:
        raise RuntimeError(f"vae: graph vs eager over the first "
                           f"{GRAPH_STEPS} steps {early:.3g} > {STEP_TOL}")
    for k, lv in (("graph", lg), ("eager", le)):
        if not (bool(torch.isfinite(lv).all())
                and float(lv[-10:].mean()) < float(lv[:10].mean())
                - LOSS_MARGIN):
            raise RuntimeError(f"vae: the {k} negative ELBO did not fall: "
                               f"first 10 {float(lv[:10].mean()):.3f}, last "
                               f"10 {float(lv[-10:].mean()):.3f}")
    j = [VAE_STEPS]

    def call(fn, st):
        def run():
            j[0] += 1
            return fn(st, x_all[idx[j[0] % (VAE_STEPS + 40)]], SEED + j[0])
        return run

    turns = in_turns(call(eager, states[1]), call(graphed, states[0]))
    report = replay_report(call(graphed, states[0]), "vae step")
    _expect_launches(graphed.launches, {}, "vae step graph")
    with torch.inference_mode():
        _, log_q, log_p = models[0](
            x_all[:VAE_IWAE_ROWS], num_samples=VAE_IWAE_SAMPLES,
            generator=torch.Generator(device=dev).manual_seed(SEED + 354))
        iwae = float(torch.mean(torch.logsumexp(log_p - log_q, dim=1)
                                - np.log(VAE_IWAE_SAMPLES)))
    print(f"phase vae (examples/vae.py: {VAE_N} procedural 784-pixel digits, "
          f"latent {VAE_LATENT}, NNDiagGaussian on MLP [784, 256, 256, 32], "
          f"4 MaskedAffineFlow on MLP [16, 128, 16], NNBernoulliDecoder on "
          f"MLP [16, 256, 256, 784], Adam {VAE_LR}, batch {VAE_BATCH}): one "
          f"step card vs CPU on the card's draws: loss {abs(l1 - l2):.3g}, "
          f"gradients {grad_err:.3g} (limit {TRAIN_TOL}); {VAE_STEPS} steps "
          f"graph and eager in turns: the first {GRAPH_STEPS} within "
          f"{early:.3g} (limit {STEP_TOL}), -ELBO graph {float(lg[0]):.3f} -> "
          f"{float(lg[-10:].mean()):.3f} (last 10), eager {float(le[0]):.3f} "
          f"-> {float(le[-10:].mean()):.3f}; wall s over the {VAE_STEPS} "
          f"steps, synchronised: graph {wall[0]:.3f}, eager {wall[1]:.3f}; "
          f"IWAE-{VAE_IWAE_SAMPLES} bound on {VAE_IWAE_ROWS} rows (graph-"
          f"trained) {iwae:.3f}; capture counted {graphed.launches}; "
          + _turns_text(turns, "step") + "; " + _report_text(report),
          flush=True)
    print(f"phase timing phase 24 (vae): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"vae step": (counts["step"], ()),
            "graphs: vae step": (graphed.launches, ())}


def phase_infrastructure(dev, flush, snf):
    """Phase 25: (a) ``prefetch_to_device`` feeding ``build_nsf``'s captured
    forward-KLD step from an ``ArrayDataset`` (B = 65536): every batch
    equal to a synchronous copy's, the losses equal to a twin fed by
    synchronous copies, the host syncs per step; (b) a
    ``CheckpointManager`` save and restore of the SNF's captured reverse
    step (model, Adam, generator), the replays after the restore bitwise
    those of the uninterrupted run; (c) ``Named`` ranges in a
    ``utils.trace`` profile, the wrapped model bitwise the plain one; (d)
    ``utils.throughput`` of the served ``build_nsf`` sampler. Returns
    {path: launches}."""
    import os
    import tempfile

    import nf_tpu_torch as nt
    from nf_tpu_torch.utils import Named

    t0 = time.perf_counter()
    # (a) the prefetched build_nsf step
    data = nt.TwoMoons().sample(PREFETCH_STEPS * BATCH, generator=torch
                                .Generator().manual_seed(SEED + 360))
    data = data.numpy()
    base = _nsf_model()
    models = [copy.deepcopy(base) for _ in range(2)]
    opts = [torch.optim.Adam(m.parameters(), lr=1e-3, capturable=True)
            for m in models]
    states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
    steps = [nt.make_forward_kld_step(o) for o in opts]
    fed, direct, same = [], [], True
    batches = []

    def prefetched():
        for b in nt.data.prefetch_to_device(
                nt.data.ArrayDataset(data, batch_size=BATCH, seed=SEED),
                size=2):
            fed.append(steps[0](states[0], b))
            batches.append(b)

    msgs = host_syncs(prefetched)
    for b in nt.data.ArrayDataset(data, batch_size=BATCH, seed=SEED):
        x = torch.as_tensor(b).to(dev)
        same = same and torch.equal(x, batches[len(direct)])
        direct.append(steps[1](states[1], x))
    loss_err = max_err(torch.stack(fed), torch.stack(direct))
    if not (same and len(fed) == PREFETCH_STEPS and loss_err <= STEP_TOL):
        raise RuntimeError(f"prefetch: batches equal {same}, {len(fed)} "
                           f"steps, losses against the synchronous copies "
                           f"{loss_err:.3g}")
    print(f"phase infrastructure prefetch_to_device (ArrayDataset of "
          f"{PREFETCH_STEPS} batches of {BATCH} TwoMoons rows, size 2) into "
          f"build_nsf's captured forward-KLD step: every batch equal to a "
          f"synchronous copy, losses against the synchronously fed twin's "
          f"{loss_err:.3g} (limit {STEP_TOL}); host syncs over the "
          f"{PREFETCH_STEPS} steps {len(msgs)}"
          + (f" (first: {msgs[0][:120]})" if msgs else "")
          + f"; capture counted {steps[0].launches}", flush=True)
    out = {"graphs: prefetch build_nsf step": (
        steps[0].launches, PATH_KERNELS["build_nsf step"])}
    # (b) a checkpoint of a captured step, restored
    model = copy.deepcopy(snf)
    opt = torch.optim.Adam(model.parameters(), lr=SNF_LR, capturable=True)
    state = nt.init_train_state(model, opt)
    step = nt.make_reverse_kld_step(opt, num_samples=SNF_BATCH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 361)
    with tempfile.TemporaryDirectory() as d:
        manager = nt.utils.CheckpointManager(d, max_to_keep=2)
        for _ in range(CKPT_STEPS[0]):
            step(state, gen)
        manager.save(state.step, state, generator=gen)
        after = [step(state, gen) for _ in range(CKPT_STEPS[1])]
        params = [p.detach().clone() for p in model.parameters()]
        restored, at = manager.restore(state, generator=gen)
        again = [step(state, gen) for _ in range(CKPT_STEPS[1])]
        kept = manager.all_steps()
    bitwise = (all(torch.equal(a, b) for a, b in zip(after, again))
               and all(torch.equal(p, q.detach()) for p, q in
                       zip(params, model.parameters())))
    if not (bitwise and at == CKPT_STEPS[0] and restored is state):
        raise RuntimeError(f"checkpoint: restored step {at}, the replays "
                           f"after the restore bitwise the uninterrupted "
                           f"run's: {bitwise}")
    print(f"phase infrastructure checkpoint: the SNF's captured reverse-KLD "
          f"step saved at step {at} (model, Adam, generator), {CKPT_STEPS[1]}"
          f" replays, restored in place, {CKPT_STEPS[1]} replays again: "
          f"losses and parameters bitwise equal; steps kept {kept}",
          flush=True)
    # (c) Named ranges in a trace
    named = copy.deepcopy(snf)
    for i, f in enumerate(named.flows):
        named.flows[i] = Named(f, f"snf_layer_{i}")
    with tempfile.TemporaryDirectory() as d:
        with nt.utils.trace(d) as prof:
            with torch.inference_mode():
                zn, lqn = named.sample(BATCH, generator=torch.Generator(
                    device=dev).manual_seed(SEED + 362))
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()}
        trace_bytes = os.path.getsize(os.path.join(d, "trace.json"))
    with torch.inference_mode():
        zp, lqp = snf.sample(BATCH, generator=torch.Generator(
            device=dev).manual_seed(SEED + 362))
    ranges = sorted(n for n in names if n.startswith("snf_layer_"))
    if not (len(ranges) == len(snf.flows) and torch.equal(zn, zp)
            and torch.equal(lqn, lqp)):
        raise RuntimeError(f"Named: ranges {ranges} in the trace, samples "
                           f"bitwise the plain model's: "
                           f"{torch.equal(zn, zp)}")
    print(f"phase infrastructure Named: {len(ranges)} named ranges in the "
          f"torch.profiler trace ({trace_bytes} bytes of Chrome trace), the "
          f"wrapped SNF's samples bitwise the plain one's", flush=True)
    # (d) throughput of the served build_nsf sampler
    sampler = nt.compile_sampler(base, BATCH)
    z0 = torch.zeros(BATCH, 2, device=dev)
    rate = nt.utils.throughput(lambda z: sampler(SEED)[0], z0, iters=20,
                               items_per_call=BATCH)
    print(f"phase infrastructure throughput: build_nsf's served sampler (B "
          f"= {BATCH}) {rate:.4g} samples/s over 20 replays timed with CUDA "
          f"events; capture counted {sampler.launches}", flush=True)
    out["graphs: throughput build_nsf serving"] = (
        sampler.launches, PATH_KERNELS["snf_nsf serving"])
    print(f"phase timing phase 25 (infrastructure): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


# --- phase 26: the training binary and the parallel layer ------------------

BIN_ITERS = 200  # path a: build_nsf's forward-KLD binary, then resumed
BIN_CKPT_EVERY = 100
BIN_ASYNC_ITERS = 60  # path a's loop, timed with saves every BIN_ASYNC_EVERY
BIN_ASYNC_EVERY = 5
BIN_RESUME_ITERS = 300
BIN_REV_SAMPLES = 16384  # path b: B*D = 32768, past the fused-head gate
BIN_REV_ITERS = 100
BIN_IMG_BATCH = 64  # path c: the image NSF (examples/image_nsf.py's batch)
BIN_IMG_ITERS = 30
BIN_GLOW_ITERS = 10
BIN_DIST_ITERS = 20  # path d: --distributed at world size 1
DIST_TOL = 1e-6  # --distributed against the same run without it
SUBPROCESS_TIMEOUT = 300


def _binary_argv(**flags):
    """``--flag value`` pairs of ``flags`` (None: a bare switch)."""
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}"] + ([] if v is None else [str(v)])
    return argv


def _nsf_argv(iters, **more):
    """Path a's argv: ``build_nsf`` at its full width on two moons."""
    return _binary_argv(model="nsf", loss="forward_kld", target="two_moons",
                        num_layers=8, hidden=HIDDEN, num_bins=K_BINS,
                        batch_size=BATCH, iters=iters, log_every=50,
                        **more)


def run_binary(argv):
    """``nf_tpu_torch.train.main(argv)`` in this process, on the card:
    ``(state, launches counted from 0 over the run, its printed text)``."""
    import contextlib
    import io

    from nf_tpu_torch import train

    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        state = train.main(argv)
    return state, read_counts(), out.getvalue()


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _falls(values, what):
    if not (np.all(np.isfinite(values))
            and values[-1] < values[0] - LOSS_MARGIN):
        raise RuntimeError(f"{what}: {values} (finite and falling by "
                           f"{LOSS_MARGIN} expected)")


def _need(counts, kernels, what):
    missing = [k for k in kernels if not counts.get(k)]
    others = [k for k, n in counts.items() if n and k not in kernels]
    if missing or others:
        raise RuntimeError(f"{what}: launches {counts}, expected "
                           f"{kernels} and no other port kernel")


def _state_tensors(state):
    return [t.detach().clone() for t in _train_tensors(state)]


def binary_forward(dev, d):
    """Path a: the forward-KLD binary at ``build_nsf``'s full width, its
    timing against the bare captured step in turns, a profiled step,
    then the resume."""
    import nf_tpu_torch as nt

    argv = _nsf_argv(BIN_ITERS, checkpoint_every=BIN_CKPT_EVERY,
                     checkpoint_dir=f"{d}/ckpt", log_path=f"{d}/log.jsonl")
    state, counts, _ = run_binary(argv)
    _need(counts, ("rqs_fwd", "head_rqs_fwd", "rqs_bwd", "head_rqs_bwd"),
          "binary forward KLD")
    _need(state.run_step.launches, ("rqs_fwd", "head_rqs_fwd", "rqs_bwd",
                                    "head_rqs_bwd"),
          "binary forward KLD, one replay (counted at the capture)")
    logged = _log(f"{d}/log.jsonl")
    losses = [r["loss"] for r in logged]
    _falls(losses, "binary forward KLD losses")
    saved = _state_tensors(state)
    if state.step != BIN_ITERS:
        raise RuntimeError(f"binary: {state.step} steps")
    # the binary's step (the target's draw, the shard, the replay) in turns
    # with the bare captured step on a drawn batch
    gen = torch.Generator(device=dev).manual_seed(SEED + 400)
    x = nt.TwoMoons().sample(BATCH, generator=gen)
    step = state.run_step.step
    turns = in_turns(lambda: state.run_step(state, 0),
                     lambda: step(state, x))
    # the binary's own draw
    draw = host_ms(state.run_step.draw)
    draw_syncs = len(host_syncs(state.run_step.draw))
    wall, busy, top = profile_call(lambda: state.run_step(state, 0))
    report = replay_report(lambda: step(state, x), "build_nsf step")
    (b1, b2), (g1, g2) = turns
    print(f"phase binary (a) python -m nf_tpu_torch.train {' '.join(argv)}: "
          f"losses at steps " + ", ".join(f"{r['step']} {r['loss']:.4f}"
                                          for r in logged)
          + f"; launches over the run {counts}; one replay (capture) "
          f"{state.run_step.launches}; wall ms per step (median of 10, in "
          f"turns binary, bare, bare, binary): the binary's step (the "
          f"target's draw included) {b1:.3f} / {b2:.3f}, the bare captured "
          f"step on a drawn batch {g1:.3f} / {g2:.3f}; the target's draw "
          f"alone {draw:.3f} ms ({draw_syncs} host syncs); one profiled "
          f"binary step: wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"{1 - busy / wall:.1%}; the bare step's " + _report_text(report),
          flush=True)
    del step
    if draw_syncs > DRAW_SYNC_LIMIT:
        raise RuntimeError(f"binary: its draw made {draw_syncs} host syncs")
    return state, saved, counts, dict(turns=turns, draw=draw,
                                      idle=1 - busy / wall, report=report)


def binary_checkpoint_turns(dev, d, state):
    """Path a's loop (``train._loop``, the binary's step on its state)
    with a checkpoint every ``BIN_ASYNC_EVERY`` steps, its saves forced
    synchronous against the binary's asynchronous ones, in turns (sync,
    async, async, sync), each run ``BIN_ASYNC_ITERS`` steps into a fresh
    directory and waited for; the files of the last run of each kind are
    the same size."""
    import contextlib
    import io
    import os
    import types

    from nf_tpu_torch import train
    from nf_tpu_torch.utils import CheckpointManager

    class SyncSaves(CheckpointManager):
        def save(self, step, state, generator=None, wait=True):
            super().save(step, state, generator=generator, wait=True)

    cfg = types.SimpleNamespace(log_path=None, iters=BIN_ASYNC_ITERS,
                                log_every=10 ** 9,
                                checkpoint_every=BIN_ASYNC_EVERY)
    gen = torch.Generator(device=dev).manual_seed(SEED + 401)
    ms, sizes = {}, {}
    for n, kind in enumerate(("sync", "async", "async", "sync")):
        path = f"{d}/turns_{n}"
        ckpt = (SyncSaves if kind == "sync" else CheckpointManager)(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train._loop(cfg, state, state.run_step, ckpt, 0,
                        lambda *a: None, generator=gen)
        torch.cuda.synchronize()
        ms.setdefault(kind, []).append(
            (time.perf_counter() - t0) * 1e3 / BIN_ASYNC_ITERS)
        sizes[kind] = sorted(
            os.path.getsize(os.path.join(path, f"step_{s}", "state.pt"))
            for s in ckpt.all_steps())
    if sizes["sync"] != sizes["async"]:
        raise RuntimeError(f"binary checkpoints: synchronous files "
                           f"{sizes['sync']} bytes, asynchronous "
                           f"{sizes['async']}")
    (s1, s2), (a1, a2) = ms["sync"], ms["async"]
    print(f"phase binary (a) checkpoints every {BIN_ASYNC_EVERY} steps, "
          f"{BIN_ASYNC_ITERS} steps per run, wall ms per step in turns "
          f"(sync, async, async, sync): synchronous saves {s1:.3f} / "
          f"{s2:.3f}, asynchronous (the binary's) {a1:.3f} / {a2:.3f}; "
          f"{len(sizes['async'])} files kept of {sizes['async'][-1]} bytes; "
          f"{nvidia_smi_line()}", flush=True)


def binary_resume(dev, d, saved):
    """Path a resumed: ``main`` re-entered on the same directory, first
    with ``--iters`` at the checkpoint (it restores and stops: the
    restored tensors against the saved ones), then to
    ``BIN_RESUME_ITERS``."""
    common = dict(checkpoint_every=BIN_CKPT_EVERY, checkpoint_dir=f"{d}/ckpt",
                  log_path=f"{d}/log.jsonl")
    state, _, text = run_binary(_nsf_argv(BIN_ITERS, **common))
    restored = _state_tensors(state)
    same = len(restored) == len(saved) and all(
        torch.equal(a, b) for a, b in zip(restored, saved))
    if not (same and f"resumed from step {BIN_ITERS}" in text):
        raise RuntimeError(f"resume: printed 'resumed from step "
                           f"{BIN_ITERS}': {'resumed' in text}; restored "
                           f"parameters and Adam state bitwise the saved "
                           f"ones: {same}")
    del state
    state, counts, text = run_binary(_nsf_argv(BIN_RESUME_ITERS,
                                               **common))
    kernels = ("rqs_fwd", "head_rqs_fwd", "rqs_bwd", "head_rqs_bwd")
    _need(counts, kernels, "binary resumed")
    graphs = [g for g in state.run_step.step.graphs.values()
              if g.graph is not None]
    losses = [r["loss"] for r in _log(f"{d}/log.jsonl")
              if r["step"] >= BIN_ITERS]
    if not (f"resumed from step {BIN_ITERS}" in text and graphs
            and state.step == BIN_RESUME_ITERS
            and np.all(np.isfinite(losses))):
        raise RuntimeError(f"resume to {BIN_RESUME_ITERS}: "
                           f"{state.step} steps, graphs {len(graphs)}, "
                           f"losses {losses}")
    print(f"phase binary (a) resumed: 'resumed from step {BIN_ITERS}', "
          f"the restored parameters and Adam state bitwise the saved "
          f"ones ({len(saved)} tensors); {BIN_RESUME_ITERS - BIN_ITERS} "
          f"more steps as a graph (one replay {state.run_step.launches}), "
          f"losses " + ", ".join(f"{v:.4f}" for v in losses), flush=True)
    return counts


def binary_reverse(dev, d):
    """Path b: the annealed reverse-KLD binary; the reverse KLD at beta 1
    of the trained model against the initial one on the same draws."""
    from nf_tpu_torch import train
    from nf_tpu_torch.utils.config import TrainConfig

    argv = _binary_argv(model="nsf", loss="reverse_kld", target="two_modes",
                        num_layers=8, hidden=HIDDEN, num_bins=K_BINS,
                        num_samples=BIN_REV_SAMPLES, beta_anneal_iters=100,
                        iters=BIN_REV_ITERS, log_every=25,
                        log_path=f"{d}/reverse.jsonl")
    state, counts, _ = run_binary(argv)
    kernels = ("rqs_fwd", "head_rqs_fwd", "rqs_bwd", "head_rqs_bwd")
    _need(counts, kernels, "binary reverse KLD")
    _need(state.run_step.launches, kernels, "binary reverse KLD, one replay")
    initial = train.build_model(TrainConfig.from_args(argv), dev)
    initial.init_from_samples(1024, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    kl = []
    for m in (initial, state.model):
        with torch.no_grad():
            kl.append(float(m.reverse_kld(
                BIN_REV_SAMPLES, beta=1.0, generator=torch.Generator(
                    device=dev).manual_seed(SEED + 401))))
    _falls(kl, "binary reverse KLD at beta 1, initial then trained")
    logged = [(r["step"], r["loss"]) for r in _log(f"{d}/reverse.jsonl")]
    # the binary's step is the captured step itself (it draws inside)
    ms = host_ms(lambda: state.run_step(state, 0))
    report = replay_report(lambda: state.run_step(state, 0),
                           "nsf reverse step")
    print(f"phase binary (b) python -m nf_tpu_torch.train {' '.join(argv)}: "
          f"reverse KLD at beta 1 on {BIN_REV_SAMPLES} draws, initial "
          f"{kl[0]:.4f}, trained {kl[1]:.4f}; logged (annealed) losses "
          f"{logged}; launches over the run {counts}; one replay "
          f"{state.run_step.launches}; wall ms per step (median of 10) "
          f"{ms:.3f}; " + _report_text(report), flush=True)
    return counts


def binary_images(dev, d):
    """Path c: the image NSF binary on procedural images and on an .npz,
    then Glow."""
    from nf_tpu_torch.data import procedural_image_classes

    x, y = procedural_image_classes(SEED + 1, 512)
    np.savez(f"{d}/x.npz", x=x, y=y)
    out = {}
    for source, extra in (("procedural", {}),
                          ("npz", {"data": f"{d}/x.npz"})):
        log = f"{d}/image_{source}.jsonl"
        # --num_layers 4 --hidden 64: build_image_nsf's defaults (the
        # binary's own are 8 and 128)
        argv = _binary_argv(model="image_nsf", num_layers=4, hidden=64,
                            batch_size=BIN_IMG_BATCH, iters=BIN_IMG_ITERS,
                            log_every=10, log_path=log, **extra)
        t0 = time.perf_counter()
        state, counts, _ = run_binary(argv)
        seconds = time.perf_counter() - t0
        _need(counts, ("rqs_fwd", "rqs_bwd"), f"binary image NSF ({source})")
        bpd = [r["bits_per_dim"] for r in _log(log)]
        if not (np.all(np.isfinite(bpd)) and bpd[-1] < bpd[0]):
            raise RuntimeError(f"binary image NSF ({source}): bits/dim "
                               f"{bpd}")
        timing = ""
        if source == "procedural":
            # the binary's step (the host batch: numpy gather, copy,
            # Scale and Jitter) in turns with the bare captured step
            # the binary's shapes and dtypes (int32 labels): its graph
            batch = (torch.rand((BIN_IMG_BATCH, 3, 32, 32), device=dev),
                     torch.randint(0, 10, (BIN_IMG_BATCH,), device=dev,
                                   dtype=torch.int32))
            step = state.run_step.step
            (b1, b2), (g1, g2) = in_turns(
                lambda: state.run_step(state, 0),
                lambda: step(state, batch))
            wall, busy, _ = profile_call(lambda: state.run_step(state, 0))
            timing = (f"; wall ms per step (median of 10, in turns binary, "
                      f"bare, bare, binary): the binary's step {b1:.3f} / "
                      f"{b2:.3f}, the bare captured step {g1:.3f} / "
                      f"{g2:.3f}; one profiled binary step: wall "
                      f"{wall:.3f} ms, device busy {busy:.3f} ms, idle "
                      f"{1 - busy / wall:.1%}")
            del step
        print(f"phase binary (c) python -m nf_tpu_torch.train "
              f"{' '.join(argv)}: bits/dim at steps "
              + ", ".join(f"{r['step']} {r['bits_per_dim']:.4f}"
                          for r in _log(log))
              + f"; launches over the run {counts}; one replay "
              f"{state.run_step.launches}; {seconds:.1f} s" + timing,
              flush=True)
        out[f"binary image_nsf ({source})"] = (counts, ("rqs_fwd",
                                                        "rqs_bwd"))
        del state
    argv = _binary_argv(model="glow", levels=2, num_layers=4,
                        batch_size=BIN_IMG_BATCH, iters=BIN_GLOW_ITERS,
                        log_every=5, log_path=f"{d}/glow.jsonl")
    state, counts, _ = run_binary(argv)
    records = _log(f"{d}/glow.jsonl")
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["bits_per_dim"])
               for r in records):
        raise RuntimeError(f"binary glow: {records}")
    print(f"phase binary (c) python -m nf_tpu_torch.train {' '.join(argv)}: "
          f"bits/dim " + ", ".join(f"{r['bits_per_dim']:.4f}"
                                   for r in records)
          + f"; launches over the run {counts} (no port kernel)", flush=True)
    out["binary glow"] = (counts, ())
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def binary_distributed(dev, d):
    """Path d: ``python -m nf_tpu_torch.train --distributed`` in
    subprocesses at world size 1 over NCCL (path a's argv at
    ``BIN_DIST_ITERS``, and with ``--accum_steps 2``), against the same
    argv in this process without ``--distributed``."""
    import os

    procs = {}
    for name, extra in (("plain", {}), ("accum", {"accum_steps": 2})):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), RANK="0", WORLD_SIZE="1",
                   LOCAL_RANK="0")
        env.pop("PYTHONPATH", None)
        argv = _nsf_argv(BIN_DIST_ITERS, distributed=None,
                         checkpoint_dir=f"{d}/dist_{name}", **extra)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "nf_tpu_torch.train"] + argv,
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    state, counts, _ = run_binary(_nsf_argv(BIN_DIST_ITERS))
    texts = {}
    try:
        for name, proc in procs.items():
            texts[name], _ = proc.communicate(timeout=SUBPROCESS_TIMEOUT)
            if proc.returncode != 0:
                raise RuntimeError(f"--distributed ({name}) exited "
                                   f"{proc.returncode}:\n"
                                   f"{texts[name][-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def final(name):
        payload = torch.load(f"{d}/dist_{name}/step_{BIN_DIST_ITERS}/"
                             "state.pt", map_location="cpu",
                             weights_only=True)
        return payload["model"]

    mine = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    dist_err = max(max_err(final("plain")[k], v) for k, v in mine.items())
    accum_err = max(max_err(final("accum")[k], v) for k, v in mine.items())
    accum_finite = all(bool(torch.all(torch.isfinite(v)))
                       for v in final("accum").values())
    if not (dist_err <= DIST_TOL and accum_finite
            and "mesh: {'data': 1}" in texts["plain"]):
        raise RuntimeError(f"--distributed at world size 1: parameters "
                           f"{dist_err:.3g} from the run without it "
                           f"(limit {DIST_TOL}); --accum_steps 2 finite "
                           f"{accum_finite}")
    print(f"phase binary (d) python -m nf_tpu_torch.train --distributed "
          f"(NCCL, MASTER_ADDR 127.0.0.1, RANK 0, WORLD_SIZE 1, "
          f"LOCAL_RANK 0), path a's argv at --iters {BIN_DIST_ITERS}: final "
          f"parameters {dist_err:.3g} from the same argv without "
          f"--distributed in this process (limit {DIST_TOL}); with "
          f"--accum_steps 2: ran, {accum_err:.3g} from it (accumulation "
          f"sums the halves' gradients in another order)", flush=True)
    return counts


def sharded_steps(dev, mesh):
    """Path e: the data-parallel forward step (B = 65536) and the
    sample-parallel reverse step (16384) on the world-size-1 NCCL mesh,
    captured against eager (``step_graphs``), the NCCL kernel in a
    profiled replay, and each against the mesh-less captured step in
    turns."""
    import nf_tpu_torch as nt

    base = _nsf_model()
    base.p = nt.TwoModes()
    pool = nt.TwoMoons().sample(8 * BATCH, generator=torch.Generator(
        device=dev).manual_seed(SEED + 402))

    def batch_of(i, which):
        return (pool[(i % 8) * BATCH:(i % 8 + 1) * BATCH],)

    gens = {}

    def gen_of(i, which):
        if which not in gens:
            gens[which] = torch.Generator(device=dev).manual_seed(SEED + 403)
        return (gens[which],)

    out = {}
    for label, path, make, args_of in (
            ("forward", "sharded forward step",
             lambda opt, m: nt.make_forward_kld_step(opt, mesh=m), batch_of),
            ("reverse", "sharded reverse step",
             lambda opt, m: nt.make_reverse_kld_step(
                 opt, num_samples=BIN_REV_SAMPLES, mesh=m), gen_of)):
        gens.clear()
        r = step_graphs(f"sharded {label} step (NCCL, world size 1)", base,
                        lambda opt: make(opt, mesh), args_of, path,
                        dict(lr=1e-4))
        # NCCL's kernels; at world size 1 its average is its one-rank
        # reduce kernel (NCCL's onerank.cu), whose symbol has no "nccl"
        nccl = [n for n, _ in r["report"]["top"]
                if "nccl" in n.lower() or "onerank" in n.lower()]
        # the collective's cost: the mesh-less captured step in turns
        models = [copy.deepcopy(base) for _ in range(2)]
        opts = [torch.optim.Adam(m.parameters(), lr=1e-4, capturable=True)
                for m in models]
        states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
        steps = [make(opts[0], None), make(opts[1], mesh)]
        gens.clear()
        calls = [lambda k=k: steps[k](states[k], *args_of(0, k))
                 for k in range(2)]
        for _ in range(3):  # two eager warm-up steps, then the capture
            for c in calls:
                c()
        (m1, m2), (s1, s2) = in_turns(calls[0], calls[1])
        extra = sorted({n for n, _ in r["report"]["top"]}
                       - {n for n, _ in profile_call(calls[0])[2]})
        print(f"phase parallel (e) sharded {label} step: NCCL kernels in "
              f"the profiled replay {[n[:120] for n in nccl] or 'none'}; "
              f"kernels the sharded replay runs and the mesh-less one does "
              f"not: " + "; ".join(n[:120] for n in extra)
              + f"; captured wall ms per step in turns (mesh-less, sharded, "
              f"sharded, mesh-less): mesh-less {m1:.3f} / {m2:.3f}, sharded "
              f"{s1:.3f} / {s2:.3f}", flush=True)
        if not nccl:
            raise RuntimeError(f"sharded {label} step: no NCCL kernel in "
                               f"a profiled replay")
        out[f"graphs: {path}"] = (r["launches"], PATH_KERNELS[path])
        del models, opts, states, steps, calls
    return out


def sharded_sampler(dev, mesh):
    """Path f: ``make_sharded_sampler`` over phase 23's HAIS at world size
    1 against the unsharded HAIS on the same stream, and
    ``log_normalizer`` over the mesh against the local one."""
    from nf_tpu_torch.parallel import log_normalizer, make_sharded_sampler

    hais = hais_model(dev)
    sample = make_sharded_sampler(mesh, HAIS_SAMPLES, with_stats=True)
    with torch.inference_mode():
        z, log_w, acc = sample(hais, torch.Generator(
            device=dev).manual_seed(SEED + 404))
        zu, log_wu, accu = hais.sample_with_stats(
            HAIS_SAMPLES, generator=torch.Generator(
                device=dev).manual_seed(SEED + 404))
    same = (torch.equal(z, zu) and torch.equal(log_w, log_wu)
            and torch.equal(acc, accu))
    lz, lzu = float(log_normalizer(log_w, mesh)), float(log_normalizer(
        log_wu))
    if not (same and abs(lz - lzu) <= DIST_TOL):
        raise RuntimeError(f"sharded sampler: bitwise the unsharded HAIS "
                           f"{same}; log Z {lz} against {lzu}")
    print(f"phase parallel (f) make_sharded_sampler(mesh, {HAIS_SAMPLES}, "
          f"with_stats=True) over phase 23's HAIS at world size 1: samples, "
          f"log-weights and accept rates (mean {float(acc.mean()):.4f}) "
          f"bitwise the unsharded HAIS's on the same stream; log Z over the "
          f"mesh {lz:.6f}, local {lzu:.6f}", flush=True)


def export_check(dev, state):
    """Path g: path a's card-trained model through ``export_state_dict``
    into a fresh CPU ``build_nsf``: ``log_prob`` on 4096 points within
    MODEL_TOL of the card model."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import train
    from nf_tpu_torch.compat_export import export_state_dict
    from nf_tpu_torch.utils.config import TrainConfig

    sd = export_state_dict(state.model)
    cpu = nt.load_reference_state_dict(train.build_model(
        TrainConfig.from_args(_nsf_argv(BIN_ITERS)), "cpu"), sd)
    x = nt.TwoMoons().sample(4096, generator=torch.Generator(
        device=dev).manual_seed(SEED + 405))
    with torch.no_grad():
        err = max_err(state.model.log_prob(x).cpu(), cpu.log_prob(x.cpu()))
    if not err <= MODEL_TOL:
        raise RuntimeError(f"compat_export: log_prob {err:.3g} from the "
                           f"card model")
    print(f"phase binary (g) compat_export: path a's trained model "
          f"exported ({len(sd)} reference-named arrays), loaded into a "
          f"fresh CPU build_nsf: log_prob on 4096 points {err:.3g} from "
          f"the card model (limit {MODEL_TOL})", flush=True)


def phase_training_binary(dev):
    """Phase 26: the training binary in this process (a: forward KLD at
    ``build_nsf``'s width, timed and resumed; b: reverse KLD; c: the
    image NSF on procedural images and an .npz, and Glow), d: in
    subprocesses under ``--distributed`` (NCCL, world size 1), then on a
    world-size-1 NCCL process group in this process, e: the sharded steps
    as graphs, f: the sharded sampler; g: ``compat_export`` of a's
    model. Returns {path: (launches, the kernels it must launch)}."""
    import tempfile

    import torch.distributed as dist
    from nf_tpu_torch.parallel import initialize_distributed, make_mesh

    t0 = time.perf_counter()
    paths = {}
    a_kernels = ("rqs_fwd", "head_rqs_fwd", "rqs_bwd", "head_rqs_bwd")
    with tempfile.TemporaryDirectory() as d:
        state, saved, counts, _ = binary_forward(dev, d)
        paths["binary forward KLD"] = (counts, a_kernels)
        export_check(dev, state)
        binary_checkpoint_turns(dev, d, state)
        del state
        paths["binary forward KLD resumed"] = (binary_resume(dev, d, saved),
                                               a_kernels)
        paths["binary reverse KLD"] = (binary_reverse(dev, d), a_kernels)
        paths.update(binary_images(dev, d))
        paths["binary forward KLD (in-process twin of --distributed)"] = (
            binary_distributed(dev, d), a_kernels)
    initialize_distributed(coordinator_address=f"127.0.0.1:{_free_port()}",
                           num_processes=1, process_id=0)
    try:
        mesh = make_mesh()
        paths.update(sharded_steps(dev, mesh))
        sharded_sampler(dev, mesh)
    finally:
        dist.destroy_process_group()
    print(f"phase timing phase 26 (training binary, parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return paths


EXPORT_TOL = 1e-5  # a reloaded artifact against the compiled function
MOVED_TOL = 1e-3  # a card artifact moved to the CPU against the card
SHARD_STEPS = 5
# PERF.md section 6's kernel_ms (forward / inverse) at the main paths'
# shapes as recorded before the kernels became ops, the yardstick of
# phase 27's times through the ops
PERF_KERNEL_MS = {"rqs_fwd": (0.0071, 0.0071),
                  "head_rqs_fwd": (0.0292, 0.0282),
                  "rqs_bwd": (0.0134, 0.0133),
                  "head_rqs_bwd": (0.0627, 0.0636)}
# the reload: a fresh interpreter with every builder and the flow
# container's constructor made to raise loads each artifact and calls it
RELOAD = r"""
import sys, torch
import nf_tpu_torch.serving as s
import nf_tpu_torch.models.builders as b
import nf_tpu_torch.core as c
def no(*a, **k):
    raise AssertionError("model code ran in the reloading process")
for n in dir(b):
    if n.startswith("build_"):
        setattr(b, n, no)
c.NormalizingFlow.__init__ = no
d = sys.argv[1]
inp = torch.load(d + "/inputs.pt")
out = {}
for name, args in (("lp", (inp["x"],)), ("lp_flat", (inp["w0"], inp["x"])),
                   ("lp_fresh", (inp["w1"], inp["x"])),
                   ("sp", (inp["seed"],)), ("sp_flat", (inp["seed"],
                                                        inp["w0"])),
                   ("circ", (inp["xc"],))):
    fn = s.load_exported(d + "/" + name.replace("_fresh", "_flat") + ".pt2")
    fn(*args)
    out[name] = (fn(*args), fn.kernel_nodes(), fn.launches,
                 [str(p) for p in fn.platforms])
torch.save(out, d + "/outputs.pt")
"""


def op_timings(dev, flush, peaks):
    """(1) kernels A (the CDF), B (the transform half), C (the CDF's
    shared-parameter backward) and E at the main paths' shapes, called
    through ``torch.ops.nf_tpu_torch`` directly, beside PERF.md's
    kernel_ms."""
    from nf_tpu_torch.ops import cost, splines
    from nf_tpu_torch.ops import splines_kernel as tk

    ops = torch.ops.nf_tpu_torch
    minima = (1e-3, 1e-3, 1e-3)
    rng = np.random.default_rng(SEED + 600)
    x, uw, uh, ud, cty, ctl = _cdf_operands(rng, dev)
    ud = splines.pad_derivatives(ud, "linear", 1e-3, axis=-1)
    cdf = tk.op_operands(x, *(t.movedim(-1, 0) for t in (uw, uh, ud)), 3.0)
    x_t = _normal(rng, (BATCH, 1), 1.5, dev).T
    h_t = _normal(rng, (HIDDEN, BATCH), 1.0, dev)
    m = 3 * K_BINS - 1
    w = _normal(rng, (m, HIDDEN), 0.3 / np.sqrt(HIDDEN), dev)
    b = _normal(rng, (m,), 0.1, dev)
    tb = torch.full((1,), 3.0, device=dev)
    hct = [_normal(rng, (1, BATCH), 1.0, dev) for _ in range(2)]
    rows = []
    for label, fn, args in (
            ("rqs_fwd", ops.rqs_fwd, lambda inv: (*cdf, inv, *minima)),
            ("head_rqs_fwd", ops.head_rqs_fwd,
             lambda inv: (x_t, h_t, w, b, tb, K_BINS, False, inv, *minima)),
            ("rqs_bwd", ops.rqs_bwd_shared,
             lambda inv: (*cdf, cty, ctl, inv, *minima)),
            ("head_rqs_bwd", ops.head_rqs_bwd,
             lambda inv: (x_t, h_t, w, b, tb, K_BINS, False, *hct, inv,
                          *minima))):
        times = []
        for inverse in (False, True):
            ms = device_ms(lambda: fn(*args(inverse)), flush)
            name = "rqs_bwd_shared" if label == "rqs_bwd" else label
            nbytes_ops = cost.COSTS[name](*args(inverse))
            times.append((ms, bound(nbytes_ops[1], nbytes_ops[0], peaks)))
        perf = PERF_KERNEL_MS[label]
        worst = max(abs(t / p - 1) for (t, _), p in zip(times, perf))
        rows.append(f"{label} kernel_ms {times[0][0]:.4f} / "
                    f"{times[1][0]:.4f} (PERF.md {perf[0]} / {perf[1]}, "
                    f"{'within' if worst <= 0.05 else 'NOT within'} 5%: "
                    f"{100 * worst:.1f}%; bound_ms {times[0][1][0]:.5f} "
                    f"({times[0][1][1]}))")
    print("phase export (1) kernels through torch.ops.nf_tpu_torch at the "
          "main shapes (forward / inverse; A at the CDF x (65536, 1), B "
          "and E at x_t (1, 65536), H 128, C's shared path): "
          + "; ".join(rows), flush=True)


def _nonzero(counts):
    """The kernels of ``counts`` that launched."""
    return {k: v for k, v in counts.items() if v}


def export_reload(dev, d, model, circ, x, xc):
    """(2) the artifacts of ``build_nsf`` (``log_prob`` frozen and with
    the weights as inputs, the sampler both ways) and of the circular
    NSF's ``log_prob``, reloaded in a fresh interpreter that calls no
    builder, against the compiled functions; returns the blobs."""
    import nf_tpu_torch as nt
    from nf_tpu_torch import serving

    t0 = time.perf_counter()
    blobs = {"lp": serving.export_log_prob(model, (BATCH, 2),
                                           platforms=("cuda", "cpu")),
             "lp_flat": serving.export_log_prob(model, (BATCH, 2),
                                                freeze_params=False),
             "sp": serving.export_sampler(model, BATCH),
             "sp_flat": serving.export_sampler(model, BATCH,
                                               freeze_params=False),
             "circ": serving.export_log_prob(circ, (CIRC_BATCH, 2))}
    t_export = time.perf_counter() - t0
    fresh = copy.deepcopy(model)
    perturb(fresh, SEED + 601, size=0.05)
    seed = SEED + 602
    for name, blob in blobs.items():
        with open(f"{d}/{name}.pt2", "wb") as f:
            f.write(blob)
    weights = [[t.detach() for t in serving._tensors(m).values()]
               for m in (model, fresh)]
    torch.save({"x": x, "xc": xc, "w0": weights[0], "w1": weights[1],
                "seed": seed}, f"{d}/inputs.pt")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", RELOAD, d],
                         capture_output=True, text=True,
                         timeout=SUBPROCESS_TIMEOUT)
    t_reload = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"the reloading process failed:\n"
                           f"{run.stderr[-4000:]}")
    out = torch.load(f"{d}/outputs.pt")
    lp = nt.compile_log_prob(model, (BATCH, 2))
    sp = nt.compile_sampler(model, BATCH)
    cl = nt.compile_log_prob(circ, (CIRC_BATCH, 2))
    want = {"lp": lp(x), "lp_flat": lp(x),
            "lp_fresh": nt.compile_log_prob(fresh, (BATCH, 2))(x),
            "circ": cl(xc)}
    errs = {k: max_err(out[k][0], v) for k, v in want.items()}
    bad = {k: e for k, e in errs.items() if not e <= EXPORT_TOL}
    z, log_q = sp(seed)
    bitwise = {k: torch.equal(out[k][0][0], z)
               and torch.equal(out[k][0][1], log_q) for k in ("sp",
                                                             "sp_flat")}
    nodes = {k: out[k][1] for k in out}
    need = {"lp": _nonzero(lp.launches),
            "lp_flat": _nonzero(lp.launches),
            "sp": _nonzero(sp.launches),
            "sp_flat": _nonzero(sp.launches),
            "circ": _nonzero(cl.launches)}
    wrong = {k: (nodes[k], need[k]) for k in need if nodes[k] != need[k]}
    replays = {k: _nonzero(out[k][2]) for k in out}
    if bad or not all(bitwise.values()) or wrong or any(
            replays[k] != need[k] for k in need):
        raise RuntimeError(f"export: reloaded against compiled {errs} "
                           f"(limit {EXPORT_TOL}), samplers bitwise "
                           f"{bitwise}, op nodes against replay launches "
                           f"{wrong}, reloaded replays {replays}")
    print(f"phase export (2) artifacts ({', '.join(f'{k} {len(v) / 1e6:.2f} MB' for k, v in blobs.items())}; "
          f"exported in {t_export:.1f} s) reloaded in a fresh interpreter "
          f"whose builders and NormalizingFlow constructor raise "
          f"({t_reload:.1f} s, each captured as one CUDA graph): log_prob "
          f"against compile_log_prob {errs['lp']:.3g}, with the weights as "
          f"inputs {errs['lp_flat']:.3g}, refreshed weights against a model "
          f"holding them {errs['lp_fresh']:.3g}, circular NSF "
          f"{errs['circ']:.3g} (limit {EXPORT_TOL}); samplers bitwise "
          f"compile_sampler at seed {seed} (frozen, weights as inputs); op "
          f"nodes = replay launches: build_nsf log_prob {nodes['lp']}, "
          f"sampler {nodes['sp']}, circular {nodes['circ']}; platforms "
          f"{out['lp'][3]}", flush=True)
    return blobs, (lp, sp, cl)


def export_timings(dev, blobs, compiled, model, x):
    """(3) the exported ``log_prob`` and sampler, eagerly (the program's
    module) and as the reloaded function's graph, in turns with the
    compiled functions; (4) the card's ``log_prob`` artifact moved to the
    CPU. Returns {path: launches}."""
    from nf_tpu_torch import serving

    lp, sp, _ = compiled
    fns = {k: serving.load_exported(blobs[k]) for k in ("lp", "sp")}
    fns["lp"](x)
    fns["sp"](SEED)
    rows = []
    for label, fn, graph, compiled_fn, eager in (
            ("log_prob", fns["lp"], lambda: fns["lp"](x), lambda: lp(x),
             lambda: fns["lp"].module(x)),
            ("sample", fns["sp"], lambda: fns["sp"](SEED),
             lambda: sp(SEED), lambda: fns["sp"].module())):
        with torch.no_grad():
            (e1, e2), (g1, g2) = in_turns(eager, graph)
        (c1, c2), (h1, h2) = in_turns(compiled_fn, graph)
        rows.append(f"{label}: exported eager {e1:.3f} / {e2:.3f}, exported "
                    f"graph {g1:.3f} / {g2:.3f}; in turns with the compiled "
                    f"graph: compiled {c1:.3f} / {c2:.3f}, exported graph "
                    f"{h1:.3f} / {h2:.3f}")
    print("phase export (3) wall ms per call at B = 65536 (median of 10, in "
          "turns): " + "; ".join(rows), flush=True)
    with torch.no_grad():
        eager_ms = host_ms(lambda: model.log_prob(x))
    print(f"phase export (3) eager build_nsf log_prob through the ops (the "
          f"model's own call): {eager_ms:.3f} ms", flush=True)
    cpu = serving.load_exported(blobs["lp"], device="cpu")
    t0 = time.perf_counter()
    moved = cpu(x.cpu())
    secs = time.perf_counter() - t0
    err = max_err(moved, fns["lp"](x).cpu())
    if not err <= MOVED_TOL:
        raise RuntimeError(f"the card's artifact moved to the CPU: "
                           f"log_prob {err:.3g} from the card")
    print(f"phase export (4) the card's log_prob artifact moved to the CPU "
          f"(platforms {cpu.platforms}; each op's CPU implementation, the "
          f"plain versions): {err:.3g} from the card (limit {MOVED_TOL}), "
          f"{secs:.1f} s on the host", flush=True)
    return {"exported build_nsf log_prob": fns["lp"].launches,
            "exported build_nsf sampler": fns["sp"].launches}


def cost_and_memory(dev, model, circ, compiled, x, xc):
    """(5) ``cost_analysis`` and ``memory_analysis`` of ``build_nsf``'s
    and the circular NSF's ``log_prob`` and sampler, and the FLOP/s each
    graph achieves over its wall time."""
    import nf_tpu_torch as nt

    lp, sp, cl = compiled
    cs = nt.compile_sampler(circ, CIRC_BATCH)
    rows = []
    for label, fn, call in (("build_nsf log_prob", lp, lambda: lp(x)),
                            ("build_nsf sample", sp, lambda: sp(SEED)),
                            ("circular log_prob", cl, lambda: cl(xc)),
                            ("circular sample", cs, lambda: cs(SEED))):
        cost = fn.cost_analysis()
        mem = fn.memory_analysis()
        ms = host_ms(call)
        rows.append(f"{label}: flops {cost['flops']:.4g}, bytes accessed "
                    f"{cost['bytes accessed']:.4g}, graph {ms:.3f} ms -> "
                    f"{cost['flops'] / ms / 1e9:.2f} TFLOP/s; memory: "
                    f"arguments {mem.argument_size_in_bytes}, outputs "
                    f"{mem.output_size_in_bytes}, graph pool "
                    f"{mem.temp_size_in_bytes} bytes")
    print("phase export (5) cost_analysis / memory_analysis (B = 65536): "
          + "; ".join(rows), flush=True)


def sharded_layouts(dev):
    """(6) on a world-size-1 NCCL group: the forward step with
    ``state_shardings`` from ``param_shardings`` on a (data 1, model 1)
    mesh against the mesh step without it, and the batch-norm
    ``build_nsf``'s sharded step against the mesh-less one, five
    captured steps each, parameters bitwise."""
    import torch.distributed as dist

    import nf_tpu_torch as nt
    from nf_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        param_shardings,
        shard_batch,
    )

    pool = nt.TwoMoons().sample(SHARD_STEPS * BATCH, generator=torch.Generator(
        device=dev).manual_seed(SEED + 603))
    initialize_distributed(coordinator_address=f"127.0.0.1:{_free_port()}",
                           num_processes=1, process_id=0)
    try:
        rows = []
        mesh2 = make_mesh(("data", "model"), shape=(1, 1))
        mesh = make_mesh()
        for label, build, m_a, m_b, sharded in (
                ("state_shardings", _nsf_model, mesh2, mesh2, True),
                ("batch-norm build_nsf", lambda: batch_norm_nsf_model(dev),
                 None, mesh, False)):
            base = build()
            models = [copy.deepcopy(base) for _ in range(2)]
            opts = [torch.optim.Adam(m.parameters(), lr=1e-4,
                                     capturable=True) for m in models]
            states = [nt.init_train_state(m, o) for m, o in zip(models, opts)]
            steps = [nt.make_forward_kld_step(opts[0], mesh=m_a),
                     nt.make_forward_kld_step(
                         opts[1], mesh=m_b,
                         state_shardings=param_shardings(states[1], m_b)
                         if sharded else None)]
            losses = [[], []]
            for i in range(SHARD_STEPS):
                batch = pool[i * BATCH:(i + 1) * BATCH]
                for k, m in enumerate((m_a, m_b)):
                    xb = shard_batch(m, batch) if m is not None else batch
                    losses[k].append(steps[k](states[k], xb))
            same = all(torch.equal(p, q) for p, q in zip(
                models[0].parameters(), models[1].parameters()))
            same_loss = all(torch.equal(a, b) for a, b in zip(*losses))
            if not (same and same_loss):
                raise RuntimeError(f"{label}: the sharded step is not bitwise "
                                   f"its twin after {SHARD_STEPS} steps")
            rows.append(f"{label}: {SHARD_STEPS} captured steps bitwise "
                        f"(losses and parameters), launches per replay "
                        f"{_nonzero(steps[1].launches)}")
        print("phase export (6) sharded layouts on a world-size-1 NCCL "
              "group (B = 65536, Adam 1e-4): " + "; ".join(rows), flush=True)
    finally:
        dist.destroy_process_group()
    return {"sharded forward step with state_shardings": steps[1].launches}


def phase_export(dev, flush, peaks):
    """Phase 27: serving's deployment surface and the tensor-parallel
    layouts (the module's notes). Returns {path: (launches, the kernels
    it must launch)}."""
    import tempfile

    t0 = time.perf_counter()
    op_timings(dev, flush, peaks)
    model = _nsf_model()
    circ = _circular_model()
    x = _normal(np.random.default_rng(SEED + 604), (BATCH, 2), 1.5, dev)
    xc = _normal(np.random.default_rng(SEED + 605), (CIRC_BATCH, 2), 1.5,
                 dev)
    with tempfile.TemporaryDirectory() as d:
        blobs, compiled = export_reload(dev, d, model, circ, x, xc)
    served = export_timings(dev, blobs, compiled, model, x)
    cost_and_memory(dev, model, circ, compiled, x, xc)
    sharded = sharded_layouts(dev)
    need = ("rqs_fwd", "head_rqs_fwd")
    paths = {k: (v, need) for k, v in served.items()}
    paths.update({k: (v, need + ("rqs_bwd", "head_rqs_bwd"))
                  for k, v in sharded.items()})
    print(f"phase timing phase 27 (export, cost, layouts): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# --- phase 28: the bfloat16 image NSF -------------------------------------

# the bfloat16 bar, the JAX package's mixed-precision one: abs, plus as much
# relative
BF16_TOL = 0.05
# one step's gradients, card against CPU, as a whole (relative L2 of the
# gradient vector): no per-element bar holds for a bfloat16 image model
# (tests/test_torch_image_bf16.py measures why on the CPU)
BF16_GRAD_TOL = 0.3
# the bfloat16 kernels' rows of the kernels line: name, the float32
# kernel they instantiate, source, the TPU kernel it replaces
BF16_KERNELS = (
    ("rqs_fwd_bf16", "rqs_fwd", "nf_tpu_torch/csrc/rqs_fwd.cu",
     "nf_tpu/ops/splines_pallas.py:209"),
    ("rqs_bwd_bf16", "rqs_bwd", "nf_tpu_torch/csrc/rqs_bwd.cu",
     "nf_tpu/ops/splines_pallas.py:399"),
    ("rqs_bwd_autodiff_bf16", "rqs_bwd_autodiff",
     "nf_tpu_torch/csrc/rqs_bwd_autodiff.cu",
     "nf_tpu/ops/splines_pallas.py:220"))
# phase 29's: kernels B and E and C's shared-parameter path in bfloat16
BF16_HEAD_KERNELS = (
    ("head_rqs_fwd_bf16", "head_rqs_fwd", "nf_tpu_torch/csrc/head_rqs_fwd.cu",
     "nf_tpu/ops/spline_head_fused.py:105"),
    ("head_rqs_bwd_bf16", "head_rqs_bwd", "nf_tpu_torch/csrc/head_rqs_bwd.cu",
     "nf_tpu/ops/spline_head_fused.py:129"),
    ("rqs_bwd_shared_bf16", "rqs_bwd_shared", "nf_tpu_torch/csrc/rqs_bwd.cu",
     "nf_tpu/ops/splines_pallas.py:399"))


def bf16_ulp_ratio(got, want, grad):
    """max over elements of |got - want| over one bfloat16 ulp of
    ``want``, ``2^-7 |want| + 1e-6`` (gradients: ``+ 1e-4 max |want|``, for
    those that cancel to near 0): at most 1 passes."""
    g, w = got.float(), want.float()
    bar = 2.0 ** -7 * w.abs() + 1e-6
    if grad:
        bar = bar + 1e-4 * float(w.abs().max())
    return float(((g - w).abs() / bar).max())


def bf16_bar_ratio(got, want):
    """max over elements of |got - want| over the bfloat16 bar,
    ``BF16_TOL (1 + |want|)``: at most 1 passes."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (BF16_TOL * (1 + w.abs()))).max())


def _bf16_calls(ops, inverse, tb=3.0):
    """The three bfloat16 kernels and their plain versions on ``ops`` (x,
    w, h, d, cty, ctl) with tail bound ``tb``: {name: (kernel call, plain
    call, gradients?)}."""
    from nf_tpu_torch.ops import splines_kernel as tk

    x, w, h, d, cty, ctl = ops
    return {"rqs_fwd": (lambda: tk.rqs_fwd(x, w, h, d, tb, inverse=inverse),
                        lambda: tk.rqs_plain(x, w, h, d, tb,
                                             inverse=inverse), False),
            "rqs_bwd": (lambda: tk.rqs_bwd(x, w, h, d, tb, cty, ctl,
                                           inverse=inverse),
                        lambda: tk.rqs_bwd_plain(x, w, h, d, tb, cty, ctl,
                                                 inverse=inverse), True),
            "rqs_bwd_autodiff": (
                lambda: tk.rqs_bwd_autodiff(x, w, h, d, tb, cty, ctl,
                                            inverse=inverse),
                lambda: tk.rqs_vjp_plain(x, w, h, d, tb, cty, ctl,
                                         inverse=inverse), True)}


def _one_bf16_node(calls, what):
    """Fail unless one captured call of each kernel of ``calls``
    (:func:`_bf16_calls`) is one graph node, that kernel's bfloat16
    instantiation, while its bfloat16 count rises by its warm-up and its
    capture (no cast kernel around it)."""
    for name, (kernel, _, _) in calls.items():
        before = _bf16_counts()[name]
        nodes = captured_kernel_names(kernel)
        counted = _bf16_counts()[name] - before
        if (len(nodes) != 1 or kernel_of(nodes[0]) != name
                or "__nv_bfloat16" not in nodes[0] or counted != 2):
            raise RuntimeError(f"{name} on {what}: a captured call holds "
                               f"graph nodes {nodes}, its warm-up and "
                               f"capture counted {counted} bfloat16 "
                               f"launches; one bfloat16 kernel and nothing "
                               f"else expected")


def parity_image_kernels_bf16(dev):
    """Kernels A, C and D in bfloat16 on the image coupling's views at
    both levels' shapes, B = 256 and 64, and at K = 10 on (64, 12, 8, 8),
    both directions, logits at N(0, 0.5²) and N(0, 1): each element within
    one bfloat16 ulp of its plain version (``bf16_ulp_ratio`` <= 1), the
    views the planes' own storage; and one call of each kernel, captured,
    is one graph node, a kernel, while its bfloat16 count rises (no cast
    kernel around it). Returns {kernel: max abs difference from its plain
    version}."""
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED + 280)
    worst = {k: 0.0 for k in ("rqs_fwd", "rqs_bwd", "rqs_bwd_autodiff")}
    abs_err = dict(worst)
    cases = 0
    shapes = [(b, ct, side, K_BINS) for b in (IMG_BATCH, IMG_STEP_BATCH)
              for ct, side in IMG_LEVELS] + [(IMG_STEP_BATCH, 12, 8, 10)]
    for batch, ct, side, K in shapes:
        for scale in (0.5, 1.0):
            ops = [t.to(torch.bfloat16) for t in _image_operands(
                rng, batch, ct, side, dev, scale, K)]
            x, w, h, d = ops[:4]
            views = tk.param_views(x, w, h, d)
            if not all(v.data_ptr() == t.data_ptr()
                       and v.shape[1:] == (batch * ct, side * side)
                       for v, t in zip(views, (w, h, d))):
                raise RuntimeError(f"bf16 image planes at {tuple(x.shape)}"
                                   f": param_views are not their views")
            for inverse in (False, True):
                for name, (kernel, plain, grad) in _bf16_calls(
                        ops, inverse).items():
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    if any(t.dtype != torch.bfloat16 for t in got):
                        raise RuntimeError(f"{name} on bfloat16 operands "
                                           f"gave {[t.dtype for t in got]}")
                    worst[name] = max(worst[name], *(
                        bf16_ulp_ratio(a, b, grad)
                        for a, b in zip(got, want)))
                    abs_err[name] = max(abs_err[name], *(
                        max_err(a.float(), b.float())
                        for a, b in zip(got, want)))
                cases += 1
    _one_bf16_node(_bf16_calls(ops, True), "bfloat16 views")
    if not all(v <= 1.0 for v in worst.values()):
        raise RuntimeError(f"bf16 kernels against their plain versions: "
                           f"worst |kernel - plain| / one bf16 ulp {worst}"
                           f" (limit 1)")
    print(f"phase bf16 image kernels ({cases} cases: B = {IMG_BATCH} and "
          f"{IMG_STEP_BATCH} at both levels, K = 8, and K = 10 at "
          f"({IMG_STEP_BATCH}, 12, 8, 8); both directions; logits at "
          f"N(0, 0.5²) and N(0, 1)): worst |kernel - plain| in bf16 ulps "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + " (limit 1); max abs "
          + ", ".join(f"{k} {v:.3g}" for k, v in abs_err.items())
          + "; one captured call of each is one graph node, a kernel, its "
          "bfloat16 instantiation (no cast around it)", flush=True)
    return abs_err


def _in_turns_ms(k32, k16, flush, reps=TIMING_REPS):
    """Device ms (median of ``reps``) of a float32 and a bfloat16 call in
    turns (f32, bf16, bf16, f32): ((f32 a, f32 b), (bf16 a, bf16 b))."""
    t32a = device_ms(k32, flush, reps)
    t16a = device_ms(k16, flush, reps)
    t16b = device_ms(k16, flush, reps)
    t32b = device_ms(k32, flush, reps)
    return (t32a, t32b), (t16a, t16b)


def _turns_row(label, t32, t16, plain, b16, b32):
    return (f"{label}: bf16 kernel_ms {t16[0]:.4f} / {t16[1]:.4f}, f32 "
            f"{t32[0]:.4f} / {t32[1]:.4f} (in turns f32, bf16, bf16, f32); "
            f"bf16 plain_ms {plain:.4f}; bound_ms bf16 {b16[0]:.5f} "
            f"({b16[1]}), f32 {b32[0]:.5f} ({b32[1]})")


def timing_image_kernels_bf16(dev, flush, peaks):
    """Kernels A (at B = 256, C and D at B = 64; level 1, (B*6, 256)
    views) in bfloat16 and in float32 in turns (f32, bf16, bf16, f32),
    with the bfloat16 plain version's time and each dtype's bound (bytes
    at its element size: x, the planes and, for C and D, the cotangents
    read, the outputs written). Both directions for A, the inverse (the
    log_prob's and the step's) for C and D. Returns {kernel: {inverse:
    (bf16 ms, plain ms, bound ms, bound by)}} and prints the float32 times
    beside."""
    from nf_tpu_torch.ops import splines_kernel as tk

    rng = np.random.default_rng(SEED + 281)
    ct, side = IMG_LEVELS[0]
    out, rows = {}, []
    for name, batch, directions in (("rqs_fwd", IMG_BATCH, (False, True)),
                                    ("rqs_bwd", IMG_STEP_BATCH, (True,)),
                                    ("rqs_bwd_autodiff", IMG_STEP_BATCH,
                                     (True,))):
        ops32 = _image_operands(rng, batch, ct, side, dev, 1.0)
        ops16 = [t.to(torch.bfloat16) for t in ops32]
        out[name] = {}
        for inverse in directions:
            k32 = _bf16_calls(ops32, inverse)[name][0]
            k16, plain16, _ = _bf16_calls(ops16, inverse)[name]
            t32, t16 = _in_turns_ms(k32, k16, flush)
            plain = device_ms(plain16, flush)
            n_out = 2 if name == "rqs_fwd" else 3 * K_BINS + 2
            x, w, h, d = ops16[:4]
            ops_n = {"rqs_fwd": tk.rqs_ops_per_element,
                     "rqs_bwd": tk.rqs_bwd_ops_per_element,
                     "rqs_bwd_autodiff": tk.rqs_vjp_ops_per_element}[name](
                K_BINS, inverse) * x.numel()
            cot = 0 if name == "rqs_fwd" else 2 * x.numel()
            b16 = bound(_spline_bytes(x, (w, h, d), n_out)
                        + cot * x.element_size(), ops_n, peaks,
                        torch.bfloat16)
            b32 = bound(_spline_bytes(ops32[0], ops32[1:4], n_out)
                        + cot * 4, ops_n, peaks)
            out[name][inverse] = ((t16[0] + t16[1]) / 2, plain) + b16
            shape = f"image ({batch * ct}, {side * side})"
            kernel = {"rqs_fwd": "A", "rqs_bwd": "C",
                      "rqs_bwd_autodiff": "D"}[name]
            for dt, t, b in (("f32", t32, b32), ("bf16", t16, b16)):
                PER_ELEMENT_MS[(kernel, dt, shape, inverse)] = (
                    (t[0] + t[1]) / 2, b[0])
            rows.append(_turns_row(
                f"{name} {'inverse' if inverse else 'forward'} x ({batch}, "
                f"{ct}, {side}, {side})", t32, t16, plain, b16, b32))
    print("phase timing bf16 image kernels (device ms after the flush): "
          + "; ".join(rows), flush=True)
    return out


def _bf16_counts():
    from nf_tpu_torch.ops import bf16_launch_counts

    return bf16_launch_counts()


def _with_bf16(counts, bf16):
    """A path's counts with the bfloat16 instantiations' under
    ``<kernel>_bf16``: kernel C's per-element path under ``rqs_bwd_bf16``
    and its shared-parameter path under ``rqs_bwd_shared_bf16``."""
    out = dict(counts, **{f"{k}_bf16": v for k, v in bf16.items()})
    out["rqs_bwd_bf16"] = bf16.get("rqs_bwd", 0) - bf16.get("rqs_bwd_shared",
                                                           0)
    return out


def _all_bf16(counts, bf16, what):
    """Fail unless every launch of a port kernel counted in ``counts`` was
    of its bfloat16 instantiation."""
    for k, v in bf16.items():
        if k in counts and counts[k] != v:
            raise RuntimeError(f"{what}: {counts[k]} launches of {k}, "
                               f"{v} of them bfloat16")


def _grad_l2(got, want):
    """Relative L2 distance of the gradient vector ``got`` ({name:
    gradient}) to ``want``."""
    diff = sum(float(((got[n].double().cpu() - want[n].double().cpu()) ** 2)
                     .sum()) for n in want)
    total = sum(float((want[n].double().cpu() ** 2).sum()) for n in want)
    return (diff / total) ** 0.5


def bf16_image_checks(model, x):
    """The bfloat16 image NSF at B = len(x), eagerly: ``log_prob`` and
    bits/dim card against CPU on IMG_CPU_ROWS images, the tempered
    ``sample`` against the tempered model's ``log_prob``, each at the
    bfloat16 bar; finite values of the right shapes and dtypes; A's
    bfloat16 kernel once per coupling per pass. Returns the passes'
    counts with their bfloat16 ones."""
    from nf_tpu_torch.utils.eval import bits_per_dim

    batch, rows = x.shape[0], IMG_CPU_ROWS
    cpu = copy.deepcopy(model).to("cpu")
    gen = torch.Generator(device=x.device).manual_seed(SEED + 283)
    counts, bf16 = {}, {}

    def counted(label, fn):  # every count is 0 before fn (_counted)
        out = _counted(counts, label, fn)
        bf16[label] = _bf16_counts()
        _all_bf16(counts[label], bf16[label], f"bf16 image_nsf {label}")
        return out

    with torch.inference_mode():
        lp = counted("log_prob", lambda: model.log_prob(x))
        bpd = bits_per_dim(model, x)
        z, log_q = counted("sample", lambda: model.sample(
            batch, generator=gen, temperature=IMG_TEMPERATURE))
        lp_s = model.set_temperature(IMG_TEMPERATURE).log_prob(z)
        lp_cpu = cpu.log_prob(x[:rows].cpu())
        bpd_cpu = bits_per_dim(cpu, x[:rows].cpu())
    per_pass = {"rqs_fwd": IMG_COUPLINGS}
    _expect(counts, {"log_prob": per_pass, "sample": per_pass},
            "bf16 image_nsf serving")
    for t in (lp, bpd, z, log_q, lp_s):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite values on the bf16 image_nsf path")
    if z.dtype != torch.bfloat16 or z.shape != x.shape \
            or lp.shape != (batch,):
        raise RuntimeError(f"bf16 image_nsf: sample {z.dtype} "
                           f"{tuple(z.shape)}, log_prob {tuple(lp.shape)}")
    errs = {f"log_prob cuda vs cpu (first {rows})": bf16_bar_ratio(
                lp[:rows].cpu(), lp_cpu),
            f"bits/dim cuda vs cpu (first {rows})": bf16_bar_ratio(
                bpd[:rows].cpu(), bpd_cpu),
            f"log_prob(sample) vs log_q at T = {IMG_TEMPERATURE}":
                bf16_bar_ratio(lp_s, log_q)}
    if not all(v <= 1.0 for v in errs.values()):
        raise RuntimeError(f"bf16 image_nsf at the bf16 bar ({BF16_TOL} abs "
                           f"+ {BF16_TOL} relative): {errs} (limit 1)")
    print(f"phase bf16 image_nsf serving (B = {batch}): launches per pass "
          f"{counts}, of them bfloat16 {bf16}; bits/dim mean "
          f"{float(bpd.mean()):.4f}; errors over the bf16 bar "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (limit 1; max |log_prob cuda - cpu| "
          f"{max_err(lp[:rows].cpu(), lp_cpu):.4g} at |log p| up to "
          f"{float(lp_cpu.abs().max()):.4g})", flush=True)
    return {k: counts["log_prob"][k] + counts["sample"][k]
            for k in counts["log_prob"]}, {
        k: bf16["log_prob"][k] + bf16["sample"][k] for k in bf16["log_prob"]}


def bf16_step_check(model, batch, mode, label="image_nsf", per_step=None,
                    rows=IMG_CPU_ROWS, cpu=None):
    """One Adam step (lr 1e-3) of ``make_forward_kld_step`` on the
    bfloat16 model under backward ``mode``: at the full batch its launches
    (``per_step``, by default the image NSF's A and C, or D, 8 each), all
    bfloat16; on ``rows`` rows, card against CPU, the loss at the bf16 bar
    and the gradients within BF16_GRAD_TOL (relative L2 of the whole
    vector). ``cpu``: the CPU's (loss, gradients) on these rows from an
    earlier call (the CPU's autograd does not depend on ``mode``). Returns
    (counts, bfloat16 counts, the card's gradients on the rows, the CPU's
    (loss, gradients))."""
    from nf_tpu_torch.ops import splines_kernel as tk

    backward = "rqs_bwd" if mode == "analytic" else "rqs_bwd_autodiff"
    if per_step is None:
        per_step = {"rqs_fwd": IMG_COUPLINGS, backward: IMG_COUPLINGS}
    tk.set_pallas_bwd_kernel(mode)
    try:
        # _step_result sets every count to 0 before the step
        _, _, launches = _step_result(model, batch)
        bf16 = _bf16_counts()
        loss, grads, _ = _step_result(model, batch[:rows])
    finally:
        tk.set_pallas_bwd_kernel("analytic")
    _expect({"step": launches}, {"step": per_step},
            f"bf16 {label} step ({mode})")
    _all_bf16(launches, bf16, f"bf16 {label} step ({mode})")
    if cpu is None:
        cpu = _step_result(copy.deepcopy(model).to("cpu"),
                           batch[:rows].cpu())[:2]
    loss_cpu, grads_cpu = cpu
    loss_err = bf16_bar_ratio(torch.tensor(loss), torch.tensor(loss_cpu))
    grad_err = _grad_l2(grads, grads_cpu)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    if not (finite and loss_err <= 1.0 and grad_err <= BF16_GRAD_TOL):
        raise RuntimeError(f"bf16 {label} step ({mode}), card vs CPU: "
                           f"loss {loss} vs {loss_cpu} ({loss_err:.3g} of "
                           f"the bar), gradients {grad_err:.3g} relative L2 "
                           f"(limit {BF16_GRAD_TOL}), finite {finite}")
    print(f"phase bf16 {label} step ({mode}): card vs CPU on "
          f"{rows} rows: loss {loss:.4f} vs {loss_cpu:.4f} "
          f"({loss_err:.3g} of the bf16 bar), gradients {grad_err:.3g} "
          f"relative L2 (limit {BF16_GRAD_TOL}); launches per step at "
          f"B = {len(batch)} {launches}, of them bfloat16 {bf16}",
          flush=True)
    return launches, bf16, grads, cpu


def _launching_bf16(compile_fn, what):
    """Run ``compile_fn()`` (a graph's capture against eager calls) with
    every count at 0 before it, and fail unless every port kernel launch
    it made (warm-up calls, capture, eager calls) was bfloat16; returns
    its result."""
    reset_counts()
    out = compile_fn()
    _all_bf16(read_counts(), _bf16_counts(), what)
    return out


def _replay_kernels_bf16(report, what):
    """Fail unless every port kernel in a profiled replay is a bfloat16
    instantiation; returns the count of the replay's copy kernels."""
    for name, _ in report["top"]:
        if kernel_of(name) is not None and "bfloat16" not in name:
            raise RuntimeError(f"{what}: a replay launched {name[:80]}, a "
                               f"port kernel that is not bfloat16")
    return sum(c for n, (_, c) in report["top"] if "copy" in n.lower())


def bf16_turns(label, f32_fn, bf16_fn, model="image_nsf"):
    """``in_turns`` of the float32 and the bfloat16 call: f32, bf16, bf16,
    f32."""
    (a, d), (b, c) = in_turns(f32_fn, bf16_fn)
    print(f"phase timing bf16 vs f32 {model} {label}: wall ms per call "
          f"(median of 10, in turns f32, bf16, bf16, f32): f32 {a:.3f} / "
          f"{d:.3f}, bf16 {b:.3f} / {c:.3f}", flush=True)


def phase_image_nsf_bf16(dev, flush, peaks):
    """Phase 28: ``build_image_nsf(dtype=torch.bfloat16)`` at its defaults
    (3 x 32 x 32, L 2, K 4, hidden 64, 8 bins, linear tails, tail bound 3),
    seed 0, perturbed by IMG_PERTURB, its ActNorms set in bfloat16 by
    ``init_from_data`` on ``procedural_image_classes(0, 256)``: kernels A,
    C and D in bfloat16 against their plain versions and timed in turns
    with float32; serving at B = 256 and the forward-KLD step at B = 64
    (Adam 1e-3), under "analytic" (A, C) and "autodiff" (A, D), eagerly
    card against CPU; then ``compile_log_prob``, ``compile_sampler``
    (T = 0.7) and the captured step as graphs against eager (log_prob and
    sampler bitwise), each launching only bfloat16 port kernels, and
    timed in turns with the float32 model's graphs. Returns ({path:
    (counts with their ``<kernel>_bf16``, kernels it must launch)},
    {kernel: (max abs err, {inverse: timing})})."""
    import nf_tpu_torch as nt

    t0 = time.perf_counter()
    abs_err = parity_image_kernels_bf16(dev)
    times = timing_image_kernels_bf16(dev, flush, peaks)
    x, _ = image_batch(IMG_BATCH, SEED, dev)
    x16 = x.to(torch.bfloat16)
    model = nt.build_image_nsf(seed=SEED, dtype=torch.bfloat16)
    perturb(model, SEED + 84, size=IMG_PERTURB)
    model.init_from_data(x16)
    dtypes = {str(p.dtype) for n, p in model.named_parameters()
              if not n.startswith("q0.")}
    if dtypes != {"torch.bfloat16"}:
        raise RuntimeError(f"bf16 image_nsf layers hold {dtypes}")
    paths = {}
    need16 = ("rqs_fwd", "rqs_fwd_bf16")
    counts, bf16 = bf16_image_checks(model, x16)
    paths["bf16 image_nsf serving"] = (_with_bf16(counts, bf16), need16)
    xs = [image_batch(IMG_STEP_BATCH, SEED + 1 + i, dev)[0].to(torch.bfloat16)
          for i in range(GRAPH_STEPS + 30)]
    for mode, need in (("analytic", ("rqs_bwd", "rqs_bwd_bf16")),
                       ("autodiff", ("rqs_bwd_autodiff",
                                     "rqs_bwd_autodiff_bf16"))):
        counts, bf16, _, _ = bf16_step_check(model, xs[0], mode)
        paths[f"bf16 image_nsf step ({mode})"] = (_with_bf16(counts, bf16),
                                                  need16 + need)
    # graphs, against eager and in turns with the float32 model's
    served = _launching_bf16(lambda: image_graphs(
        "bf16 image_nsf", model, x16, None, {"rqs_fwd": IMG_COUPLINGS},
        "image_nsf serving", bitwise=True), "bf16 image_nsf serving graphs")
    copies = {k: _replay_kernels_bf16(v["report"], f"bf16 {k} graph")
              for k, v in served.items()}
    counts = _captured_counts(served)
    paths["graphs: bf16 image_nsf serving"] = (
        _with_bf16(counts, {"rqs_fwd": counts.get("rqs_fwd", 0),
                            "rqs_bwd": 0, "rqs_bwd_autodiff": 0}), need16)
    for mode, path in (("analytic", "image_nsf step"),
                       ("autodiff", "image_nsf step (autodiff)")):
        st = _launching_bf16(lambda: step_graphs(
            f"bf16 image_nsf forward-KLD step ({mode}, B = "
            f"{IMG_STEP_BATCH})", model, nt.make_forward_kld_step,
            lambda i, which: (xs[i % len(xs)],), path, dict(lr=IMG_LR),
            mode=mode), f"bf16 image_nsf step graph ({mode})")
        copies[f"step ({mode})"] = _replay_kernels_bf16(
            st["report"], f"bf16 step graph ({mode})")
        bwd = "rqs_bwd" if mode == "analytic" else "rqs_bwd_autodiff"
        _expect_launches(st["launches"], {"rqs_fwd": IMG_COUPLINGS,
                                          bwd: IMG_COUPLINGS},
                         f"bf16 image_nsf step graph ({mode})")
        l16 = {k: st["launches"].get(k, 0)
               for k in ("rqs_fwd", "rqs_bwd", "rqs_bwd_autodiff")}
        paths[f"graphs: bf16 image_nsf step ({mode})"] = (
            _with_bf16(st["launches"], l16), need16 + (bwd, bwd + "_bf16"))
    print(f"phase bf16 image_nsf graphs: copy kernels per profiled replay "
          f"{copies}", flush=True)
    # the float32 model of phase 15 in turns
    m32 = nt.build_image_nsf(seed=SEED)
    perturb(m32, SEED + 84, size=IMG_PERTURB)
    m32.init_from_data(x)
    lp32 = nt.compile_log_prob(m32, tuple(x.shape))
    lp16 = nt.compile_log_prob(model, tuple(x16.shape), dtype=torch.bfloat16)
    bf16_turns(f"compile_log_prob (B = {IMG_BATCH})", lambda: lp32(x),
               lambda: lp16(x16))
    s32 = nt.compile_sampler(m32, IMG_BATCH, temperature=IMG_TEMPERATURE)
    s16 = nt.compile_sampler(model, IMG_BATCH, temperature=IMG_TEMPERATURE)
    bf16_turns(f"compile_sampler (B = {IMG_BATCH}, T = {IMG_TEMPERATURE})",
               lambda: s32(SEED), lambda: s16(SEED))
    xs32 = [t.float() for t in xs[:4]]
    step_fns = []
    for m, batches in ((m32, xs32), (model, xs[:4])):
        mm = copy.deepcopy(m)
        opt = torch.optim.Adam(mm.parameters(), lr=IMG_LR, capturable=True)
        state = nt.init_train_state(mm, opt)
        step = nt.make_forward_kld_step(opt)
        i = [0]

        def call(step=step, state=state, batches=batches, i=i):
            i[0] += 1
            return step(state, batches[i[0] % len(batches)])
        step_fns.append(call)
    bf16_turns(f"captured forward-KLD step (B = {IMG_STEP_BATCH})",
               *step_fns)
    print(f"phase timing phase 28 (bf16 image_nsf): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = {name: (abs_err[base], times[base])
            for name, base, _, _ in BF16_KERNELS}
    return paths, rows


# phase 29: the bfloat16 coupled NSF, build_nsf(permutation=False)'s stack
# in bfloat16 from the public layers
BF16_NSF_COUPLINGS = 8
# its weights' perturbation: at 0.5 (build_nsf's phases) the splines are so
# steep that rounding each coupling's output to bfloat16 moves log_prob by
# ~1 nat and the sampler's round trip by ~6 (float32: 2e-3); at 0.1 the
# bfloat16 model stays within the bar of its float32 twin (max 0.15 nats,
# round trip 0.19, on the CPU at B = 4096)
BF16_NSF_PERTURB = 0.1
BF16_NSF_CPU_ROWS = 4096  # rows held against the CPU (B*D >= the gate)
BF16_NSF_LR = 1e-3  # phase_training's Adam rate
# (D, H, K, tails, B): build_nsf's coupling, the circular coupled model's
# (H 512, K 10, circular tails), and both at B = 4099, whose h_t rows start
# off 16 bytes
BF16_HEAD_CASES = ((1, HIDDEN, K_BINS, "linear", BATCH),
                   (1, 512, 10, "circular", BATCH),
                   (1, HIDDEN, K_BINS, "linear", 4099),
                   (1, 512, 10, "circular", 4099))


def _head_operands(rng, dev, d, hidden, K, tails, batch, dtype):
    """Kernel B's and E's operands at a coupling's shapes: x_t (D, B) (a
    transposed view), h_t (H, B), W_eff and bias, tb (D,), cotangents."""
    m = (3 * K - (1 if tails == "linear" else 0)) * d
    x_t = _normal(rng, (batch, d), 1.5, dev).to(dtype).T
    h_t = _normal(rng, (hidden, batch), 1.0, dev).to(dtype)
    w = _normal(rng, (m, hidden), 0.3 / np.sqrt(hidden), dev).to(dtype)
    b = _normal(rng, (m,), 0.1, dev).to(dtype)
    tb = torch.full((d,), 3.0, device=dev, dtype=dtype)
    cty, ctl = (_normal(rng, (d, batch), 1.0, dev).to(dtype)
                for _ in range(2))
    return x_t, h_t, w, b, tb, cty, ctl


def _shared_operands(rng, dev, batch, dtype):
    """Kernel C's shared path at a coupling's CDF: x (B, 1), (K, 1, 1)
    parameters (the padded derivatives K+1), cotangents (B, 1)."""
    from nf_tpu_torch.ops import splines

    x, uw, uh, ud, cty, ctl = _cdf_operands(rng, dev, batch)
    ud = splines.pad_derivatives(ud, "linear", 1e-3, axis=-1)
    small = [t.movedim(-1, 0).to(dtype) for t in (uw, uh, ud)]
    return [x.to(dtype)] + small + [cty.to(dtype), ctl.to(dtype)]


def _bf16_head_calls(ops_h, ops_c, inverse, tails="linear", sums=None,
                     shared_tb=3.0):
    """{kernel: (kernel call, plain call on the kernel's own head sums,
    plain call)} for B, E and C's shared path on ``ops_h`` (B and E take
    its tail bound) and ``ops_c`` (with ``shared_tb``). ``sums``: the
    bfloat16 kernels' head product alone (``head_params_bf16``), on which
    ``head_rqs_plain_on_sums`` / ``head_rqs_bwd_plain_on_sums`` run; C's
    shared path has no head, and its yardstick is its plain version."""
    from nf_tpu_torch.ops import spline_head_fused as shf
    from nf_tpu_torch.ops import splines_kernel as tk

    x_t, h_t, w, b, tb, cty, ctl = ops_h
    K = (w.shape[0] // x_t.shape[0] + (1 if tails == "linear" else 0)) // 3
    kw = dict(num_bins=K, tails=tails, inverse=inverse)
    x, uw, uh, ud, cy, cl = ops_c
    shared = (lambda: tk.rqs_bwd_shared(x, uw, uh, ud, shared_tb, cy, cl,
                                        inverse=inverse))
    shared_plain = (lambda: tk.rqs_bwd_shared_plain(
        x, uw, uh, ud, shared_tb, cy, cl, inverse=inverse))
    return {
        "head_rqs_fwd": (
            lambda: shf.fused_head_rqs(x_t, h_t, w, b, tail_bound=tb, **kw),
            lambda: shf.head_rqs_plain_on_sums(x_t, sums, b, tb, **kw),
            lambda: shf.head_rqs_plain(x_t, h_t, w, b, tb, **kw)),
        "head_rqs_bwd": (
            lambda: shf.fused_head_rqs_bwd(x_t, h_t, w, b, tb, cty, ctl,
                                           **kw),
            lambda: shf.head_rqs_bwd_plain_on_sums(x_t, h_t, w, b, tb, cty,
                                                   ctl, sums, **kw),
            lambda: shf.head_rqs_bwd_plain(x_t, h_t, w, b, tb, cty, ctl,
                                           **kw)),
        "rqs_bwd_shared": (shared, shared_plain, shared_plain)}


# the bfloat16 kernels' head sums against float64's, over sum_j |w_j h_j|
# (tests/test_torch_cuda.py MMA_SUMS_TOL)
MMA_SUMS_TOL = 2.0 ** -20


def mma_sums(ops_h):
    """The bfloat16 kernels' own head sums on ``ops_h`` and their error
    against float64's over ``sum_j |w_j h_j|`` (and ``torch.matmul``'s
    float32 sums' error, beside): (sums, kernel error, matmul error)."""
    from nf_tpu_torch.ops import spline_head_fused as shf

    x_t, h_t, w = ops_h[:3]
    sums = shf.head_params_bf16(h_t, w, feats=x_t.shape[0])
    exact = w.double() @ h_t.double()
    scale = (w.double().abs() @ h_t.double().abs()).clamp_min(1e-30)
    err = float(((sums.double() - exact).abs() / scale).max())
    mm = float(((w.float() @ h_t.float()).double() - exact).abs().div(
        scale).max())
    return sums, err, mm


def _head_parity_bf16(ops_h, ops_c, tails, worst, matmul, abs_err,
                      shared_tb=3.0, sums_err=None):
    """B, E and C's shared path in bfloat16 on ``ops_h`` and ``ops_c``,
    both directions, against their plain versions: the worst ratios to one
    bfloat16 ulp on the kernels' own head sums into ``worst``, against the
    plain versions' ``torch.matmul`` sums into ``matmul``, the largest abs
    difference into ``abs_err`` (each {kernel: value}, raised to the new
    maxima); the sums' error against float64's into ``sums_err`` ({"mma",
    "matmul": value})."""
    sums, err, mm = mma_sums(ops_h)
    if sums_err is not None:
        sums_err["mma"] = max(sums_err.get("mma", 0.0), err)
        sums_err["matmul"] = max(sums_err.get("matmul", 0.0), mm)
    for inverse in (False, True):
        for name, (kernel, on_sums, plain) in _bf16_head_calls(
                ops_h, ops_c, inverse, tails, sums, shared_tb).items():
            grad = name != "head_rqs_fwd"
            got, want, want_mm = kernel(), on_sums(), plain()
            torch.cuda.synchronize()
            if any(t.dtype != torch.bfloat16 for t in got):
                raise RuntimeError(f"{name} on bfloat16 operands gave "
                                   f"{[t.dtype for t in got]}")
            worst[name] = max(worst[name], *(
                bf16_ulp_ratio(a, c, grad) for a, c in zip(got, want)))
            matmul[name] = max(matmul[name], *(
                bf16_ulp_ratio(a, c, grad) for a, c in zip(got, want_mm)))
            abs_err[name] = max(abs_err[name], *(
                max_err(a.float(), c.float()) for a, c in zip(got, want)))


def _head_nodes_bf16(ops_h, ops_c, tails, shared_tb=3.0):
    """One call of B, E and C's shared path on ``ops_h`` and ``ops_c``,
    each captured into a kept graph: fails unless the graph holds that
    kernel's bfloat16 launches (E and C's shared path: two) and no cast;
    returns {kernel: graph nodes}."""
    nodes = {}
    want_nodes = {"head_rqs_fwd": {"head_rqs_fwd": 1},
                  "head_rqs_bwd": {"head_rqs_bwd": 2},
                  "rqs_bwd_shared": {"rqs_bwd": 2}}
    for name, (kernel, _, _) in _bf16_head_calls(
            ops_h, ops_c, False, tails, shared_tb=shared_tb).items():
        names = captured_kernel_names(kernel)
        ours = {}
        for n in names:
            k = kernel_of(n)
            if k is not None:
                ours[k] = ours.get(k, 0) + ("__nv_bfloat16" in n)
        nodes[name] = len(names)
        if ours != want_nodes[name] or any("direct_copy_kernel" in n
                                           for n in names):
            raise RuntimeError(f"{name} on bfloat16 operands: a captured "
                               f"call's kernels {names}; expected its "
                               f"bfloat16 instantiation "
                               f"{want_nodes[name]} and no cast")
    return nodes


def parity_head_kernels_bf16(dev):
    """Kernels B and E and C's shared path in bfloat16 at
    :data:`BF16_HEAD_CASES` (C at the CDF's x (B, 1)), both directions:
    each element of every output within one bfloat16 ulp of its plain
    version run on the kernels' own head sums (``bf16_ulp_ratio`` <= 1;
    the ratio against the plain versions' ``torch.matmul`` sums is printed
    beside), the sums within MMA_SUMS_TOL of float64's, bfloat16 out; and
    one call of each, captured into a kept graph, holds that kernel's
    bfloat16 instantiation (E and C: both their launches) and no cast.
    Returns {kernel: max abs difference from its plain version}."""
    rng = np.random.default_rng(SEED + 290)
    bf = torch.bfloat16
    worst = {k: 0.0 for k in ("head_rqs_fwd", "head_rqs_bwd",
                              "rqs_bwd_shared")}
    matmul, abs_err, sums_err = dict(worst), dict(worst), {}
    cases = 0
    for d, hidden, K, tails, batch in BF16_HEAD_CASES:
        ops_h = _head_operands(rng, dev, d, hidden, K, tails, batch, bf)
        ops_c = _shared_operands(rng, dev, batch, bf)
        _head_parity_bf16(ops_h, ops_c, tails, worst, matmul, abs_err,
                          sums_err=sums_err)
        cases += 1
    nodes = _head_nodes_bf16(ops_h, ops_c, tails)
    if not (all(v <= 1.0 for v in worst.values())
            and sums_err["mma"] <= MMA_SUMS_TOL):
        raise RuntimeError(f"bf16 B, E, C shared against their plain "
                           f"versions on the kernels' head sums: worst "
                           f"|kernel - plain| / one bf16 ulp {worst} (limit "
                           f"1); the sums' error {sums_err['mma']:.3g} "
                           f"(limit {MMA_SUMS_TOL:.3g})")
    print(f"phase bf16 head kernels ({cases} cases: (D, H, K, tails, B) in "
          f"{BF16_HEAD_CASES}, C's shared path at x (B, 1); both "
          f"directions): worst |kernel - plain on the kernels' head sums| in "
          f"bf16 ulps " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + " (limit 1); against the plain versions' torch.matmul sums "
          + ", ".join(f"{k} {v:.3g}" for k, v in matmul.items())
          + f"; the tensor-core head sums' error against float64 over "
          f"sum |w h| 2^{np.log2(sums_err['mma']):.2f} (limit 2^-20; "
          f"torch.matmul's 2^{np.log2(sums_err['matmul']):.2f}); max abs "
          + ", ".join(f"{k} {v:.3g}" for k, v in abs_err.items())
          + f"; a captured call of each holds its bfloat16 kernels and "
          f"nothing of the port else, no cast (graph nodes {nodes})",
          flush=True)
    return abs_err


def timing_head_kernels_bf16(dev, flush, peaks):
    """Kernels B and E at build_nsf's coupling (D 1, H 128, K 8, linear, B
    65536) and C's shared path at its CDF (x (65536, 1)), both directions,
    in bfloat16 and in float32 in turns (f32, bf16, bf16, f32), with the
    bfloat16 plain version's time and each dtype's bound (``ops.cost``:
    the operands read and the outputs written at their element size; E's
    float32 partials and C's workspace are scratch). Returns {kernel:
    {inverse: (bf16 ms, plain ms, bound ms, bound by)}} and prints the
    float32 times beside."""
    from nf_tpu_torch.ops import cost

    out, rows = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(SEED + 291)
        ops_h = _head_operands(rng, dev, 1, HIDDEN, K_BINS, "linear", BATCH,
                               dtype)
        ops_c = _shared_operands(rng, dev, BATCH, dtype)
        out[dtype] = (ops_h, ops_c)
    minima = (1e-3, 1e-3, 1e-3)

    def cost_of(name, ops_h, ops_c, inverse):
        x_t, h_t, w, b, tb, cty, ctl = ops_h
        if name == "head_rqs_fwd":
            return cost.head_rqs_fwd(x_t, h_t, w, b, tb, K_BINS, False,
                                     inverse, *minima)
        if name == "head_rqs_bwd":
            return cost.head_rqs_bwd(x_t, h_t, w, b, tb, K_BINS, False, cty,
                                     ctl, inverse, *minima)
        x, uw, uh, ud, cy, cl = ops_c
        return cost.rqs_bwd_shared(x, uw, uh, ud, None, 3.0, cy, cl, inverse,
                                   *minima)

    times = {}
    for name in ("head_rqs_fwd", "head_rqs_bwd", "rqs_bwd_shared"):
        times[name] = {}
        for inverse in (False, True):
            k32 = _bf16_head_calls(*out[torch.float32], inverse)[name][0]
            k16, _, plain16 = _bf16_head_calls(*out[torch.bfloat16],
                                               inverse)[name]
            t32, t16 = _in_turns_ms(k32, k16, flush)
            plain = device_ms(plain16, flush)
            ops16, bytes16 = cost_of(name, *out[torch.bfloat16], inverse)
            ops32, bytes32 = cost_of(name, *out[torch.float32], inverse)
            b16 = bound(bytes16, ops16, peaks, torch.bfloat16)
            b32 = bound(bytes32, ops32, peaks)
            times[name][inverse] = ((t16[0] + t16[1]) / 2, plain) + b16
            rows.append(_turns_row(
                f"{name} {'inverse' if inverse else 'forward'}", t32, t16,
                plain, b16, b32) + f" ({bytes16} and {bytes32} bytes)")
    print(f"phase timing bf16 head kernels (device ms after the flush; B "
          f"and E at D 1, H {HIDDEN}, K {K_BINS}, linear, B {BATCH}; C's "
          f"shared path at x ({BATCH}, 1)): " + "; ".join(rows), flush=True)
    return times


def bf16_nsf_model(dtype=torch.bfloat16):
    """``build_nsf(permutation=False)``'s stack from the public layers:
    BF16_NSF_COUPLINGS ``CoupledRationalQuadraticSpline`` (H 128, 2 blocks,
    8 bins, linear tails, bound 3, masks alternating) on a
    ``DiagGaussian(2, trainable=False)``, all in ``dtype``, weights drawn
    from ``torch.Generator().manual_seed(SEED)`` and perturbed by
    BF16_NSF_PERTURB, on the card. Its float32 twin holds the same values:
    load the bfloat16 model's state into ``bf16_nsf_model(torch.float32)``.
    """
    import nf_tpu_torch as nt

    gen = torch.Generator().manual_seed(SEED)
    layers = [nt.flows.CoupledRationalQuadraticSpline(
        num_input_channels=2, num_blocks=2, num_hidden_channels=HIDDEN,
        num_bins=K_BINS, tails="linear", tail_bound=3.0,
        reverse_mask=(i % 2 == 1), generator=gen, dtype=dtype)
        for i in range(BF16_NSF_COUPLINGS)]
    model = nt.NormalizingFlow(
        nt.distributions.DiagGaussian(2, trainable=False, dtype=dtype),
        layers).to("cuda")
    perturb(model, SEED + 292, size=BF16_NSF_PERTURB)
    return model


def bf16_nsf_checks(model, x):
    """The bfloat16 coupled NSF at B = len(x), eagerly: ``log_prob`` card
    against CPU (its plain path, the unfused bfloat16 head) on
    BF16_NSF_CPU_ROWS rows and ``sample``'s round trip, each at the bf16
    bar; finite values of the right shapes and dtypes; per pass B and A
    once per coupling, all bfloat16. Returns the passes' counts with their
    bfloat16 ones."""
    batch, rows = x.shape[0], BF16_NSF_CPU_ROWS
    cpu = copy.deepcopy(model).to("cpu")
    gen = torch.Generator(device=x.device).manual_seed(SEED + 293)
    counts, bf16 = {}, {}

    def counted(label, fn):  # every count is 0 before fn (_counted)
        out = _counted(counts, label, fn)
        bf16[label] = _bf16_counts()
        _all_bf16(counts[label], bf16[label], f"bf16 coupled {label}")
        return out

    with torch.inference_mode():
        lp = counted("log_prob", lambda: model.log_prob(x))
        z, log_q = counted("sample", lambda: model.sample(batch,
                                                          generator=gen))
        lp_z = model.log_prob(z)
        lp_cpu = cpu.log_prob(x[:rows].cpu())
    per_pass = {"rqs_fwd": BF16_NSF_COUPLINGS,
                "head_rqs_fwd": BF16_NSF_COUPLINGS}
    _expect(counts, {"log_prob": per_pass, "sample": per_pass},
            "bf16 coupled serving")
    for t in (lp, z, log_q, lp_z):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite values on the bf16 coupled path")
    if not (z.dtype == lp.dtype == torch.bfloat16 and z.shape == x.shape
            and lp.shape == (batch,)):
        raise RuntimeError(f"bf16 coupled: sample {z.dtype} "
                           f"{tuple(z.shape)}, log_prob {lp.dtype} "
                           f"{tuple(lp.shape)}")
    errs = {f"log_prob cuda vs cpu (first {rows})": bf16_bar_ratio(
                lp[:rows].cpu(), lp_cpu),
            "log_prob(sample) vs log_q": bf16_bar_ratio(lp_z, log_q)}
    if not all(v <= 1.0 for v in errs.values()):
        raise RuntimeError(f"bf16 coupled NSF at the bf16 bar ({BF16_TOL} "
                           f"abs + {BF16_TOL} relative): {errs} (limit 1)")
    print(f"phase bf16 coupled serving (B = {batch}): launches per pass "
          f"{counts}, of them bfloat16 {bf16}; errors over the bf16 bar "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (limit 1; max |log_prob cuda - cpu| "
          f"{max_err(lp[:rows].cpu().float(), lp_cpu.float()):.4g} at "
          f"|log p| up to {float(lp_cpu.float().abs().max()):.4g})",
          flush=True)
    return ({k: counts["log_prob"][k] + counts["sample"][k]
             for k in counts["log_prob"]},
            {k: bf16["log_prob"][k] + bf16["sample"][k]
             for k in bf16["log_prob"]})


_SAME_DTYPE_COPIES = []


def same_dtype_copies():
    """The names of the kernels PyTorch's copies within one dtype
    (bfloat16 to bfloat16, float32 to float32) run on this card, read from
    captured calls: a strided read (``.T.contiguous()``) and a strided
    write (``torch.diag``'s ``diagonal().copy_``). Any other copy kernel
    (``*copy_kernel*`` in its name) in a graph changes a dtype: a cast.
    PyTorch names a cast's kernel after its copy too
    (``direct_copy_kernel_cuda``), through another instance."""
    if not _SAME_DTYPE_COPIES:
        names = set()
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.ones(64, 64, device="cuda", dtype=dtype)
            v = torch.ones(64, device="cuda", dtype=dtype)
            for fn in (lambda: t.T.contiguous(), lambda: torch.diag(v)):
                names.update(n for n in captured_kernel_names(fn)
                             if "copy_kernel" in n)
        _SAME_DTYPE_COPIES.append(names)
    return _SAME_DTYPE_COPIES[0]


def _casts(names):
    """The copy kernels among ``names`` that change a dtype."""
    same = same_dtype_copies()
    return [n for n in names if "copy_kernel" in n and n not in same]


def _graph_kernels_bf16(fn, warm, want, what, casts=0):
    """Capture one call of ``fn`` into a kept graph and read its kernel
    nodes: every port kernel among them a bfloat16 instantiation, their
    count by kernel ``want``, and ``casts`` casts (:func:`_casts`; none
    but where a layer computes in float32 on purpose). Returns (port
    kernels by kernel, nodes, copies within one dtype)."""
    names = captured_kernel_names(fn, warm)
    ours = {}
    for n in names:
        k = kernel_of(n)
        if k is not None:
            if "__nv_bfloat16" not in n:
                raise RuntimeError(f"{what}: the graph holds {n[:90]}, a "
                                   f"port kernel that is not bfloat16")
            ours[k] = ours.get(k, 0) + 1
    found = _casts(names)
    if ours != want or len(found) != casts:
        raise RuntimeError(f"{what}: the graph's port kernels {ours} "
                           f"(expected {want}), {len(found)} casts "
                           f"(expected {casts}) {found[:3]}")
    copies = sum("copy_kernel" in n for n in names) - len(found)
    return ours, len(names), copies


def phase_coupled_nsf_bf16(dev, flush, peaks):
    """Phase 29: ``build_nsf(permutation=False)``'s stack in bfloat16
    (:func:`bf16_nsf_model`): kernels B and E and C's shared path in
    bfloat16 against their plain versions and timed in turns with
    float32; serving (``log_prob``, ``sample``) at B = 65536 and the
    forward-KLD step at B = 65536 on TwoMoons (Adam 1e-3; the batch drawn
    in float32 and cast once), under "analytic" (A, B, C's shared path,
    E) and "autodiff" (D on the CDF), eagerly card against CPU; then
    ``compile_log_prob``, ``compile_sampler`` and the captured step as
    graphs against eager (bitwise), each launching only bfloat16 port
    kernels and no cast (the captured calls' kernel nodes read by name),
    and timed in turns with the float32 twin's graphs. Returns ({path:
    (counts with their ``<kernel>_bf16``, kernels it must launch)},
    {kernel: (max abs err, {inverse: timing})})."""
    import nf_tpu_torch as nt

    t0 = time.perf_counter()
    abs_err = parity_head_kernels_bf16(dev)
    times = timing_head_kernels_bf16(dev, flush, peaks)
    t_kernels = time.perf_counter() - t0
    model = bf16_nsf_model()
    dtypes = {str(p.dtype) for p in model.parameters()} | {
        str(b.dtype) for b in model.buffers() if b.is_floating_point()}
    if dtypes != {"torch.bfloat16"}:
        raise RuntimeError(f"bf16 coupled NSF holds {dtypes}")
    m32 = bf16_nsf_model(torch.float32)
    m32.load_state_dict(model.state_dict())
    target = nt.TwoMoons()
    gen = torch.Generator(device=dev).manual_seed(SEED + 294)
    x32 = target.sample(BATCH, generator=gen)
    x16 = x32.to(torch.bfloat16)
    paths = {}
    couplings = BF16_NSF_COUPLINGS
    need = ("rqs_fwd", "rqs_fwd_bf16", "head_rqs_fwd", "head_rqs_fwd_bf16")
    counts, bf16 = bf16_nsf_checks(model, x16)
    paths["bf16 coupled serving"] = (_with_bf16(counts, bf16), need)
    xs = [target.sample(BATCH, generator=gen).to(torch.bfloat16)
          for _ in range(GRAPH_STEPS + 30)]
    cpu = None
    for mode, more in (("analytic", ("rqs_bwd", "rqs_bwd_shared_bf16")),
                       ("autodiff", ("rqs_bwd_autodiff",
                                     "rqs_bwd_autodiff_bf16"))):
        bwd = "rqs_bwd" if mode == "analytic" else "rqs_bwd_autodiff"
        per_step = {"rqs_fwd": couplings, "head_rqs_fwd": couplings,
                    bwd: couplings, "head_rqs_bwd": couplings}
        counts, bf16, _, cpu = bf16_step_check(
            model, xs[0], mode, label="coupled", per_step=per_step,
            rows=BF16_NSF_CPU_ROWS, cpu=cpu)
        paths[f"bf16 coupled step ({mode})"] = (
            _with_bf16(counts, bf16),
            need + ("head_rqs_bwd", "head_rqs_bwd_bf16") + more)
    # graphs against eager, their kernels by name
    per_pass = {"rqs_fwd": couplings, "head_rqs_fwd": couplings}
    served = _launching_bf16(lambda: serving_graphs(
        "bf16 coupled", model, x16, BATCH, per_pass, "bf16 coupled serving",
        dtype=torch.bfloat16), "bf16 coupled serving graphs")
    lp_fn, sampler = served["log_prob"]["fn"], served["sample"]["fn"]
    if served["log_prob"]["err"] != 0.0:
        raise RuntimeError(f"bf16 coupled log_prob: graph vs eager "
                           f"{served['log_prob']['err']:.3g}, not bitwise")
    counts = _captured_counts(served)
    paths["graphs: bf16 coupled serving"] = (
        _with_bf16(counts, {k: counts.get(k, 0) for k in
                            ("rqs_fwd", "head_rqs_fwd")}), need)

    def eager_lp():
        with torch.inference_mode():
            return model.log_prob(x16)

    nodes = {"log_prob": _graph_kernels_bf16(
        eager_lp, 1, {"rqs_fwd": couplings, "head_rqs_fwd": couplings},
        "bf16 coupled log_prob graph")}
    for mode, path in (("analytic", "bf16 coupled step"),
                       ("autodiff", "bf16 coupled step (autodiff)")):
        st = _launching_bf16(lambda: step_graphs(
            f"bf16 coupled forward-KLD step ({mode}, B = {BATCH})", model,
            nt.make_forward_kld_step, lambda i, which: (xs[i % len(xs)],),
            path, dict(lr=BF16_NSF_LR), mode=mode),
            f"bf16 coupled step graph ({mode})")
        if st["err"] != (0.0, 0.0):
            raise RuntimeError(f"bf16 coupled step graph ({mode}): graph vs "
                               f"eager {st['err']}, not bitwise")
        bwd = "rqs_bwd" if mode == "analytic" else "rqs_bwd_autodiff"
        per_step = {"rqs_fwd": couplings, "head_rqs_fwd": couplings,
                    bwd: couplings, "head_rqs_bwd": couplings}
        _expect_launches(st["launches"], per_step,
                         f"bf16 coupled step graph ({mode})")
        # the counts of _launching_bf16's window (warm-ups, capture, eager
        # steps): every bf16 launch of C in it, the capture's among them,
        # took the shared path, so the capture's C launches are shared ones
        win = _bf16_counts()
        if win["rqs_bwd_shared"] != win["rqs_bwd"]:
            raise RuntimeError(f"bf16 coupled step graph ({mode}): "
                               f"{win['rqs_bwd_shared']} of C's "
                               f"{win['rqs_bwd']} bf16 launches took its "
                               f"shared path")
        l16 = {k: st["launches"].get(k, 0) for k in
               ("rqs_fwd", "head_rqs_fwd", "rqs_bwd", "rqs_bwd_autodiff",
                "head_rqs_bwd")}
        l16["rqs_bwd_shared"] = l16["rqs_bwd"]
        paths[f"graphs: bf16 coupled step ({mode})"] = (
            _with_bf16(st["launches"], l16),
            need + ("head_rqs_bwd", "head_rqs_bwd_bf16", bwd)
            + (("rqs_bwd_shared_bf16",) if mode == "analytic"
               else ("rqs_bwd_autodiff_bf16",)))
        # C's shared path and E are two launches each
        m_ = copy.deepcopy(model)
        opt = torch.optim.Adam(m_.parameters(), lr=BF16_NSF_LR,
                               capturable=True)
        state = nt.init_train_state(m_, opt)
        eager_step = nt.make_forward_kld_step(opt).eager
        from nf_tpu_torch.ops import splines_kernel as tk

        tk.set_pallas_bwd_kernel(mode)
        try:
            nodes[f"step ({mode})"] = _graph_kernels_bf16(
                lambda: eager_step(state, xs[0]), 2,
                {"rqs_fwd": couplings, "head_rqs_fwd": couplings,
                 bwd: couplings * (2 if mode == "analytic" else 1),
                 "head_rqs_bwd": 2 * couplings},
                f"bf16 coupled step graph ({mode})")
        finally:
            tk.set_pallas_bwd_kernel("analytic")
    print(f"phase bf16 coupled graphs: port kernels of a captured call by "
          f"name, all bfloat16, no cast (kernels, graph nodes, copies "
          f"within one dtype): {nodes}", flush=True)
    # the float32 twin's graphs in turns
    lp32 = nt.compile_log_prob(m32, (BATCH, 2))
    bf16_turns(f"compile_log_prob (B = {BATCH})", lambda: lp32(x32),
               lambda: lp_fn(x16), "coupled")
    s32 = nt.compile_sampler(m32, BATCH)
    bf16_turns(f"compile_sampler (B = {BATCH})", lambda: s32(SEED),
               lambda: sampler(SEED), "coupled")
    step_fns = []
    for m, batches in ((m32, [t.float() for t in xs[:4]]), (model, xs[:4])):
        mm = copy.deepcopy(m)
        opt = torch.optim.Adam(mm.parameters(), lr=BF16_NSF_LR,
                               capturable=True)
        state = nt.init_train_state(mm, opt)
        step = nt.make_forward_kld_step(opt)
        i = [0]

        def call(step=step, state=state, batches=batches, i=i):
            i[0] += 1
            return step(state, batches[i[0] % len(batches)])
        step_fns.append(call)
    bf16_turns(f"captured forward-KLD step (B = {BATCH})", *step_fns,
               "coupled")
    print(f"phase timing phase 29 (bf16 coupled NSF): "
          f"{time.perf_counter() - t0:.1f} s, the kernels' parity and "
          f"timing {t_kernels:.1f} s of it", flush=True)
    rows = {name: (abs_err[base], times[base])
            for name, base, _, _ in BF16_HEAD_KERNELS}
    return paths, rows


# phase 32: the bfloat16 autoregressive and circular spline models, from
# the public layers: the AR NSF of examples/neural_spline_flow.py
# --autoregressive, the circular NSF (build_circular_nsf's stack) and the
# circular coupled model (phase 17's)
SF_AR_LAYERS, SF_AR_HIDDEN = 4, 64  # examples/neural_spline_flow.py
SF_AR_LR = 3e-3  # its Adam rate
SF_CIRC_LR = 5e-4  # examples/paper_example_nsf.py's, phase 9's
# the weights' perturbation (perturb's size) of each bfloat16 model: the
# largest that keeps it within the bfloat16 bar of its float32 twin by a
# margin (the CPU at B = 65536, two seeds: at 0.1 the circular coupled
# model's sampler round trip reached 1.23 times the bar, the AR NSF's
# 0.83, the circular NSF's 0.55)
SF_PERTURB = {"ar_nsf": 0.05, "circular_nsf": 0.1, "circular_coupled": 0.05}
SF_CPU_ROWS = 4096  # rows of a pass held against the CPU
# phase 32's kernel times are medians of 10: each timed call waits ~25 ms
# behind device_ms's spin kernel, and at 30 eight rows of A, C and D in
# turns took 31.7 s on the card
SF_TIMING_REPS = 10
SF_CHECK_BATCH = 4096  # each step, card against CPU
# the layouts kernels A, C and D meet on this phase's models: the
# autoregressive layers' K-major (K, 2, B) planes (the MADE's head) at
# linear tails (the AR NSF: K 8, bound 3) and at per-feature (circular,
# linear) tails (the circular NSF: K 10, bounds (pi, 3))
SF_KMAJOR = (("ar_nsf", K_BINS, "linear"), ("circular_nsf", CC_BINS, "mixed"))


def sf_kmajor_operands(rng, dev, K, tails, batch, dtype):
    """Kernels A's, C's and D's operands as an autoregressive layer's feed
    hands them over (``feed.kmajor_spline_feed``), :func:`_path_operands`
    in ``dtype`` with x (2, B) the transposed view of (B, 2) inputs; the
    tail bound 3 for "linear" tails (the AR NSF's), the per-feature (2, 1)
    bounds (pi, 3) for "mixed" ones (the circular NSF's). Returns (x, w,
    h, d, cty, ctl) and the bound."""
    x, w, h, d, tb, cty, ctl = _path_operands(rng, K, tails, dev, batch)
    x = x.T.contiguous().T
    ops = tuple(t.to(dtype) for t in (x, w, h, d, cty, ctl))
    return ops, 3.0 if tails == "linear" else tb.to(dtype)


def parity_kmajor_bf16(dev):
    """Kernels A, C and D in bfloat16 at :data:`SF_KMAJOR`'s layouts, at
    B = 65536 and 4099, both directions: each element within one bfloat16
    ulp of its plain version, bfloat16 out; one captured call of each is
    one graph node, its bfloat16 instantiation."""
    rng = np.random.default_rng(SEED + 320)
    worst = {k: 0.0 for k in ("rqs_fwd", "rqs_bwd", "rqs_bwd_autodiff")}
    abs_err = dict(worst)
    cases = 0
    for _, K, tails in SF_KMAJOR:
        for batch in (BATCH, 4099):
            ops, tb = sf_kmajor_operands(rng, dev, K, tails, batch,
                                         torch.bfloat16)
            for inverse in (False, True):
                for name, (kernel, plain, grad) in _bf16_calls(
                        ops, inverse, tb).items():
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    if any(t.dtype != torch.bfloat16 for t in got):
                        raise RuntimeError(f"{name} on bfloat16 K-major "
                                           f"planes gave "
                                           f"{[t.dtype for t in got]}")
                    worst[name] = max(worst[name], *(
                        bf16_ulp_ratio(a, b, grad)
                        for a, b in zip(got, want)))
                    abs_err[name] = max(abs_err[name], *(
                        max_err(a.float(), b.float())
                        for a, b in zip(got, want)))
                cases += 1
        _one_bf16_node(_bf16_calls(ops, True, tb),
                       f"bfloat16 K-major planes ({tails} tails)")
    if not all(v <= 1.0 for v in worst.values()):
        raise RuntimeError(f"bf16 A, C, D on K-major planes against their "
                           f"plain versions: worst |kernel - plain| / one "
                           f"bf16 ulp {worst} (limit 1)")
    print(f"phase spline_family_bf16 kernels A, C, D ({cases} cases: x (2, "
          f"B) a transposed view, K-major planes at "
          + ", ".join(f"{label}'s K {K} {tails} tails"
                      for label, K, tails in SF_KMAJOR)
          + f", B = {BATCH} and 4099, both directions, ties at +-tb): "
          f"worst |kernel - plain| in bf16 ulps "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + " (limit 1); max abs "
          + ", ".join(f"{k} {v:.3g}" for k, v in abs_err.items())
          + "; one captured call of each is one graph node, its bfloat16 "
          "instantiation", flush=True)


# the timed rows of kernels A, C and D at those layouts, each in the
# direction its model's path runs most: (model, kernel, B, inverse): the
# AR NSF's log_prob and step (the spline's forward, B = 65536), the
# circular NSF's sampler and step (its inverse; the step at B = 16384)
SF_KMAJOR_TIMED = (("ar_nsf", "rqs_fwd", BATCH, False),
                   ("ar_nsf", "rqs_bwd", BATCH, False),
                   ("ar_nsf", "rqs_bwd_autodiff", BATCH, False),
                   ("circular_nsf", "rqs_fwd", BATCH, True),
                   ("circular_nsf", "rqs_bwd", CIRC_TRAIN_BATCH, True))


def timing_kmajor_bf16(dev, flush, peaks):
    """Kernels A, C and D at :data:`SF_KMAJOR_TIMED`'s rows, in bfloat16
    and float32 in turns, with the bfloat16 plain version's time and each
    dtype's bound: one printed line."""
    from nf_tpu_torch.ops import splines_kernel as tk

    layouts = {label: (K, tails) for label, K, tails in SF_KMAJOR}
    rows = []
    for label, name, batch, inverse in SF_KMAJOR_TIMED:
        K, tails = layouts[label]
        ops = {dtype: sf_kmajor_operands(np.random.default_rng(SEED + 321),
                                         dev, K, tails, batch, dtype)
               for dtype in (torch.float32, torch.bfloat16)}
        (o32, tb32), (o16, tb16) = ops[torch.float32], ops[torch.bfloat16]
        k32 = _bf16_calls(o32, inverse, tb32)[name][0]
        k16, plain16, _ = _bf16_calls(o16, inverse, tb16)[name]
        t32, t16 = _in_turns_ms(k32, k16, flush, SF_TIMING_REPS)
        plain = device_ms(plain16, flush, SF_TIMING_REPS)
        n_out = 2 if name == "rqs_fwd" else 3 * K + 2
        ops_n = {"rqs_fwd": tk.rqs_ops_per_element,
                 "rqs_bwd": tk.rqs_bwd_ops_per_element,
                 "rqs_bwd_autodiff": tk.rqs_vjp_ops_per_element}[name](
            K, inverse)
        bounds = []
        for dtype in (torch.bfloat16, torch.float32):
            (x, w, h, d, _, _), tb = ops[dtype]
            cot = 0 if name == "rqs_fwd" else 2 * x.numel()
            planes = (w, h, d) + ((tb,) if isinstance(tb, torch.Tensor)
                                  else ())
            bounds.append(bound(_spline_bytes(x, planes, n_out)
                                + cot * x.element_size(),
                                ops_n * x.numel(), peaks, dtype))
        kernel = {"rqs_fwd": "A", "rqs_bwd": "C",
                  "rqs_bwd_autodiff": "D"}[name]
        for dt, t, b in (("bf16", t16, bounds[0]), ("f32", t32, bounds[1])):
            PER_ELEMENT_MS[(kernel, dt, f"K-major (2, {batch}) K {K}",
                            inverse)] = ((t[0] + t[1]) / 2, b[0])
        rows.append(_turns_row(
            f"{label} {name} {'inverse' if inverse else 'forward'} x (2, "
            f"{batch}) K {K}", t32, t16, plain, *bounds))
    print(f"phase timing spline_family_bf16 kernels A, C, D (device ms after "
          f"the flush, median of {SF_TIMING_REPS}): " + "; ".join(rows),
          flush=True)


def sf_ar_model(dtype=torch.bfloat16):
    """``examples/neural_spline_flow.py --autoregressive``'s model from the
    public layers: SF_AR_LAYERS x [``AutoregressiveRationalQuadraticSpline``
    (2 blocks, hidden 64, 8 bins, linear tails, bound 3),
    ``LULinearPermute``] on a ``DiagGaussian(2, trainable=False)``, all in
    ``dtype``, weights from ``torch.Generator().manual_seed(SEED)``,
    perturbed, on the card."""
    import nf_tpu_torch as nt

    gen = torch.Generator().manual_seed(SEED)
    flows = []
    for _ in range(SF_AR_LAYERS):
        flows += [nt.flows.AutoregressiveRationalQuadraticSpline(
            2, 2, SF_AR_HIDDEN, num_bins=K_BINS, tail_bound=3.0,
            generator=gen, dtype=dtype),
            nt.flows.LULinearPermute(2, generator=gen, dtype=dtype)]
    model = nt.NormalizingFlow(
        nt.distributions.DiagGaussian(2, trainable=False, dtype=dtype),
        flows).to("cuda")
    perturb(model, SEED + 322, size=SF_PERTURB["ar_nsf"])
    return model


def _circular_tail(nt, dtype):
    """``PeriodicWrap`` and the ``UniformGaussian`` base of the circular
    models, in ``dtype``."""
    return (nt.flows.PeriodicWrap([0], bound=np.pi, dtype=dtype),
            nt.distributions.UniformGaussian(2, [0], scale=[2 * np.pi, 1.0],
                                             dtype=dtype))


def sf_circular_model(dtype=torch.bfloat16):
    """``build_circular_nsf``'s stack from the public layers, in
    ``dtype``: 12 ``CircularAutoregressiveRationalQuadraticSpline`` (dim 2,
    ind_circ [0], one block of hidden 512, 10 bins, tail bounds (pi, 3),
    ``permute_mask``), ``PeriodicWrap``, a ``UniformGaussian`` base of
    scale (2 pi, 1): the builder's weights and masks at seed SEED,
    perturbed, the Gauss-von Mises target, on the card."""
    import nf_tpu_torch as nt

    gen = torch.Generator().manual_seed(SEED)
    flows = [nt.flows.CircularAutoregressiveRationalQuadraticSpline(
        2, 1, CC_HIDDEN, ind_circ=[0], num_bins=CC_BINS,
        tail_bound=np.asarray(CC_TAIL_BOUND, np.float32), permute_mask=True,
        generator=gen, dtype=dtype) for _ in range(CC_LAYERS)]
    wrap, base = _circular_tail(nt, dtype)
    model = nt.NormalizingFlow(base, flows + [wrap],
                               p=GaussVonMises()).to("cuda")
    perturb(model, SEED + 323, size=SF_PERTURB["circular_nsf"])
    return model


def sf_coupled_model(dtype=torch.bfloat16):
    """Phase 17's circular coupled model (:func:`circular_coupled_model`)
    in ``dtype``, perturbed, the Gauss-von Mises target, on the card."""
    import nf_tpu_torch as nt

    gen = torch.Generator().manual_seed(SEED)
    flows = [nt.flows.CircularCoupledRationalQuadraticSpline(
        num_input_channels=2, num_blocks=1, num_hidden_channels=CC_HIDDEN,
        ind_circ=[0], num_bins=CC_BINS, tail_bound=CC_TAIL_BOUND,
        reverse_mask=(i % 2 == 1), generator=gen, dtype=dtype)
        for i in range(CC_LAYERS)]
    wrap, base = _circular_tail(nt, dtype)
    model = nt.NormalizingFlow(base, flows + [wrap],
                               p=GaussVonMises()).to("cuda")
    perturb(model, SEED + 324, size=SF_PERTURB["circular_coupled"])
    return model


# model: (builder, launches per log_prob, per sample, per step (at
# B*D >= the fused-head gate), the step's kind, the angle's column)
SF_MODELS = {
    "ar_nsf": (sf_ar_model, {"rqs_fwd": SF_AR_LAYERS},
               {"rqs_fwd": 2 * SF_AR_LAYERS},
               {"rqs_fwd": SF_AR_LAYERS, "rqs_bwd": SF_AR_LAYERS},
               "forward", None),
    "circular_nsf": (sf_circular_model, {"rqs_fwd": CC_LAYERS},
                     {"rqs_fwd": 2 * CC_LAYERS},
                     {"rqs_fwd": 2 * CC_LAYERS, "rqs_bwd": 2 * CC_LAYERS},
                     "reverse", 0),
    "circular_coupled": (sf_coupled_model,
                         {"rqs_fwd": CC_LAYERS, "head_rqs_fwd": CC_LAYERS},
                         {"rqs_fwd": CC_LAYERS, "head_rqs_fwd": CC_LAYERS},
                         {"rqs_fwd": CC_LAYERS, "head_rqs_fwd": CC_LAYERS,
                          "rqs_bwd": CC_LAYERS, "head_rqs_bwd": CC_LAYERS},
                         "reverse", 0)}


def sf_inputs(name, n, seed, dev):
    """``n`` bfloat16 inputs of ``name``'s model: two moons (the AR NSF's
    target, drawn in float32 and cast once), or (angle uniform on [-pi,
    pi), N(0, 1.5²))."""
    import nf_tpu_torch as nt

    gen = torch.Generator(device=dev).manual_seed(seed)
    if SF_MODELS[name][5] is None:
        return nt.TwoMoons().sample(n, generator=gen).to(torch.bfloat16)
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-np.pi, np.pi, n),
                  rng.standard_normal(n) * 1.5], axis=1)
    return torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16)


def sf_serving_checks(name, model, x):
    """A bfloat16 model at B = len(x), eagerly: ``log_prob`` card against
    CPU on SF_CPU_ROWS rows, ``log_prob(sample)`` against ``log_q`` and
    ``forward(inverse(x))`` against x (the angle modulo 2 pi), each at the
    bfloat16 bar; finite bfloat16 values of the right shapes, the angle in
    [-pi, pi]; the launches per pass (:data:`SF_MODELS`), all bfloat16,
    B at circular tails on half the coupled model's layers. Returns the
    passes' counts with their bfloat16 ones, and the errors over the
    bar."""
    _, per_lp, per_sample, _, _, col = SF_MODELS[name]
    batch, rows = x.shape[0], SF_CPU_ROWS
    cpu = copy.deepcopy(model).to("cpu")
    gen = torch.Generator(device=x.device).manual_seed(SEED + 325)
    counts, bf16, circ = {}, {}, {}

    def counted(label, fn):  # every count is 0 before fn (_counted)
        out = _counted(counts, label, fn)
        bf16[label] = _bf16_counts()
        circ[label] = _circular_counts()[0]
        _all_bf16(counts[label], bf16[label], f"bf16 {name} {label}")
        return out

    with torch.inference_mode():
        lp = counted("log_prob", lambda: model.log_prob(x))
        z, log_q = counted("sample", lambda: model.sample(batch,
                                                          generator=gen))
        lp_z = model.log_prob(z)
        back = model.forward(model.inverse(x))
        lp_cpu = cpu.log_prob(x[:rows].cpu())
    _expect(counts, {"log_prob": per_lp, "sample": per_sample},
            f"bf16 {name} serving")
    if name == "circular_coupled" and set(circ.values()) != {CC_LAYERS // 2}:
        raise RuntimeError(f"bf16 circular_coupled: kernel B at circular "
                           f"tails {circ}, expected {CC_LAYERS // 2} a pass")
    for t in (lp, z, log_q, lp_z, back):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"non-finite values on the bf16 {name} path")
    if not (z.dtype == lp.dtype == log_q.dtype == torch.bfloat16
            and z.shape == x.shape and lp.shape == (batch,)):
        raise RuntimeError(f"bf16 {name}: sample {z.dtype} "
                           f"{tuple(z.shape)}, log_prob {lp.dtype} "
                           f"{tuple(lp.shape)}")
    d = back.double() - x.double()
    if col is not None:
        if float(z[:, col].abs().max()) > np.pi:
            raise RuntimeError(f"bf16 {name}: the sample's angle left "
                               f"[-pi, pi]")
        d[:, col] = torch.remainder(d[:, col] + np.pi, 2 * np.pi) - np.pi
    errs = {f"log_prob cuda vs cpu (first {rows})": bf16_bar_ratio(
                lp[:rows].cpu(), lp_cpu),
            "log_prob(sample) vs log_q": bf16_bar_ratio(lp_z, log_q),
            "forward(inverse(x)) vs x" + (" (angle mod 2 pi)" if col
                                          is not None else ""):
                float((d.abs() / (BF16_TOL * (1 + x.double().abs())))
                      .max())}
    if not all(v <= 1.0 for v in errs.values()):
        raise RuntimeError(f"bf16 {name} at the bf16 bar ({BF16_TOL} abs "
                           f"+ {BF16_TOL} relative): {errs} (limit 1)")
    print(f"phase spline_family_bf16 {name} serving (B = {batch}): "
          f"launches per pass {counts}, of them bfloat16 {bf16}"
          + (f", B at circular tails {circ}" if name == "circular_coupled"
             else "") + "; errors over the bf16 bar "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (limit 1; max |log_prob cuda - cpu| "
          f"{max_err(lp[:rows].cpu().float(), lp_cpu.float()):.4g} at "
          f"|log p| up to {float(lp_cpu.float().abs().max()):.4g})",
          flush=True)
    return ({k: counts["log_prob"][k] + counts["sample"][k]
             for k in counts["log_prob"]},
            {k: bf16["log_prob"][k] + bf16["sample"][k]
             for k in bf16["log_prob"]})


def sf_reverse_check(name, model, dev):
    """One SGD step (lr 0) of the reverse-KLD step of a bfloat16 circular
    model on the same base draws (B = SF_CHECK_BATCH, rounded to
    bfloat16), card against CPU: the loss at the bf16 bar, the gradients
    within BF16_GRAD_TOL relative L2; the launches per step
    (:data:`SF_MODELS`), all bfloat16. Returns (counts, bfloat16
    counts)."""
    per_step = SF_MODELS[name][3]
    rng = np.random.default_rng(SEED + 326)
    z0 = np.stack([rng.uniform(-np.pi, np.pi, SF_CHECK_BATCH),
                   rng.standard_normal(SF_CHECK_BATCH)], axis=1)
    z0 = torch.from_numpy(z0.astype(np.float32)).to(torch.bfloat16)
    loss, grads, launches = _circular_step_result(model, z0.to(dev),
                                                  "analytic")
    bf16 = _bf16_counts()
    _expect({"step": launches}, {"step": per_step},
            f"bf16 {name} reverse-KLD step")
    _all_bf16(launches, bf16, f"bf16 {name} reverse-KLD step")
    cpu = copy.deepcopy(model).to("cpu")
    loss_cpu, grads_cpu, _ = _circular_step_result(cpu, z0, "analytic")
    loss_err = bf16_bar_ratio(torch.tensor(loss), torch.tensor(loss_cpu))
    grad_err = _grad_l2(grads, grads_cpu)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    if not (finite and loss_err <= 1.0 and grad_err <= BF16_GRAD_TOL):
        raise RuntimeError(f"bf16 {name} reverse-KLD step, card vs CPU: "
                           f"loss {loss} vs {loss_cpu} ({loss_err:.3g} of "
                           f"the bar), gradients {grad_err:.3g} relative L2 "
                           f"(limit {BF16_GRAD_TOL}), finite {finite}")
    print(f"phase spline_family_bf16 {name} reverse-KLD step: card vs CPU "
          f"on {SF_CHECK_BATCH} base draws: loss {loss:.4f} vs "
          f"{loss_cpu:.4f} ({loss_err:.3g} of the bf16 bar), gradients "
          f"{grad_err:.3g} relative L2 (limit {BF16_GRAD_TOL}); launches "
          f"per step {launches}, of them bfloat16 {bf16}", flush=True)
    return launches, bf16


def sf_head_kernels(dev, flush, peaks, model, m32):
    """Kernels B and E at the bfloat16 circular coupled model's operands
    (an angle-transforming layer: circular tails, H 512, K 10, D 1,
    B = 65536) and C's shared path at its identity half's CDF where that
    half is the angle (circular tails, tail bound pi as a bfloat16
    tensor), both directions: each element within one bfloat16 ulp of its
    plain version on the kernels' own head sums (the sums within
    MMA_SUMS_TOL of float64's), one captured call holding only its
    bfloat16 kernels; then each in the inverse direction (the
    sampler's and the step's) in turns with the float32 twin's operands,
    with the bfloat16 plain version's time and the bounds: one printed
    line."""
    from nf_tpu_torch.ops import cost, splines

    ops, ops_c, tbs = {}, {}, {}
    for dtype, m in ((torch.bfloat16, model), (torch.float32, m32)):
        ops[dtype] = cc_kernel_operands(m, dev, BATCH, dtype)
        cdf = next(f.prqct.unconditional_transform
                   for f in m.flows[:CC_LAYERS]
                   if f.prqct.unconditional_transform.tails == ("circular",))
        rng = np.random.default_rng(SEED + 327)
        x = torch.from_numpy(rng.uniform(-np.pi, np.pi, (BATCH, 1)).astype(
            np.float32)).to(dev, dtype)
        with torch.no_grad():
            planes = [t[None].detach().movedim(-1, 0) for t in (
                cdf.unnormalized_widths, cdf.unnormalized_heights,
                splines.pad_derivatives(cdf.unnormalized_derivatives,
                                        list(cdf.tails), cdf.min_derivative,
                                        axis=-1))]
        cty, ctl = (_normal(rng, (BATCH, 1), 1.0, dev).to(dtype)
                    for _ in range(2))
        ops_c[dtype] = [x] + planes + [cty, ctl]
        tbs[dtype] = cdf.tail_bound_arr.reshape(())
    worst = {k: 0.0 for k in ("head_rqs_fwd", "head_rqs_bwd",
                              "rqs_bwd_shared")}
    matmul, abs_err, sums_err = dict(worst), dict(worst), {}
    bf = torch.bfloat16
    _head_parity_bf16(ops[bf], ops_c[bf], "circular", worst, matmul,
                      abs_err, tbs[bf], sums_err)
    nodes = _head_nodes_bf16(ops[bf], ops_c[bf], "circular", tbs[bf])
    if not (all(v <= 1.0 for v in worst.values())
            and sums_err["mma"] <= MMA_SUMS_TOL):
        raise RuntimeError(f"bf16 B, E, C shared at the circular coupled "
                           f"model's operands: worst |kernel - plain on the "
                           f"kernels' head sums| / one bf16 ulp {worst} "
                           f"(limit 1); the sums' error "
                           f"{sums_err['mma']:.3g} (limit "
                           f"{MMA_SUMS_TOL:.3g})")
    minima = (1e-3, 1e-3, 1e-3)
    rows = []
    for name in worst:  # the inverse: the sampler's and the step's
        calls = {dtype: _bf16_head_calls(
            ops[dtype], ops_c[dtype], True, "circular",
            shared_tb=tbs[dtype])[name] for dtype in (bf, torch.float32)}
        t32, t16 = _in_turns_ms(calls[torch.float32][0], calls[bf][0],
                                flush, SF_TIMING_REPS)
        plain = device_ms(calls[bf][2], flush, SF_TIMING_REPS)
        bounds = []
        for dtype in (bf, torch.float32):
            x_t, h_t, w, b, tb, cty, ctl = ops[dtype]
            if name == "head_rqs_fwd":
                n_ops, nbytes = cost.head_rqs_fwd(
                    x_t, h_t, w, b, tb, CC_BINS, True, True, *minima)
            elif name == "head_rqs_bwd":
                n_ops, nbytes = cost.head_rqs_bwd(
                    x_t, h_t, w, b, tb, CC_BINS, True, cty, ctl, True,
                    *minima)
            else:
                x, uw, uh, ud, cy, cl = ops_c[dtype]
                n_ops, nbytes = cost.rqs_bwd_shared(
                    x, uw, uh, ud, tbs[dtype].expand(x.shape), 0.0, cy, cl,
                    True, *minima)
            bounds.append(bound(nbytes, n_ops, peaks, dtype))
        rows.append(_turns_row(f"{name} inverse", t32, t16, plain, *bounds))
    print(f"phase spline_family_bf16 kernels B, E, C shared (the bf16 "
          f"circular coupled model's operands: B and E at H {CC_HIDDEN}, K "
          f"{CC_BINS}, circular tails, B = {BATCH}; C's shared path at its "
          f"angle CDF, x ({BATCH}, 1), tail bound pi in bf16; both "
          f"directions): worst |kernel - plain on the kernels' head sums| "
          f"in bf16 ulps " + ", ".join(f"{k} {v:.3g}"
                                       for k, v in worst.items())
          + " (limit 1); against the plain versions' torch.matmul sums "
          + ", ".join(f"{k} {v:.3g}" for k, v in matmul.items())
          + f"; head sums' error over sum |w h| "
          f"2^{np.log2(sums_err['mma']):.2f} (torch.matmul's "
          f"2^{np.log2(sums_err['matmul']):.2f}); max abs "
          + ", ".join(f"{k} {v:.3g}" for k, v in abs_err.items())
          + f"; captured calls hold only their bfloat16 kernels (graph "
          f"nodes {nodes}); device ms after the flush, median of "
          f"{SF_TIMING_REPS}: " + "; ".join(rows), flush=True)


def _sf_step_fn(name, model, lr, batches=None, gen=None):
    """A captured step of ``name``'s kind on a copy of ``model`` (Adam
    ``lr``, capturable): the forward-KLD step cycling through ``batches``,
    or the reverse-KLD step at CIRC_TRAIN_BATCH drawing from ``gen``.
    Returns a call taking no arguments."""
    import nf_tpu_torch as nt

    m = copy.deepcopy(model)
    opt = torch.optim.Adam(m.parameters(), lr=lr, capturable=True)
    state = nt.init_train_state(m, opt)
    if SF_MODELS[name][4] == "forward":
        step = nt.make_forward_kld_step(opt)
        i = [0]

        def call():
            i[0] += 1
            return step(state, batches[i[0] % len(batches)])
        return call
    step = nt.make_reverse_kld_step(opt, num_samples=CIRC_TRAIN_BATCH)
    return lambda: step(state, gen)


def sf_graphs(name, model, m32, x, dev):
    """``name``'s bfloat16 model as CUDA graphs: ``compile_log_prob`` and
    ``compile_sampler`` at B = 65536 against eager (bitwise), the captured
    step against the eager one (bitwise after five steps; the AR NSF under
    "analytic" and "autodiff"), every port launch bfloat16; a captured
    call of ``log_prob``, ``sample`` and the step read by kernel name:
    only bfloat16 port kernels and no cast (the AR NSF's sampler: the
    casts of its LU layers' float32 solves, as many as one
    ``LULinearPermute``'s sampling pass holds times the layers); then each
    graph in turns
    with the float32 twin's, and the circular NSF's also with
    ``mixed_precision=True`` on the same weights. Returns {path: (counts
    with their ``<kernel>_bf16``, kernels it must launch)}."""
    import nf_tpu_torch as nt
    from nf_tpu_torch.ops import splines_kernel as tk

    _, per_lp, per_sample, per_step, kind, _ = SF_MODELS[name]
    paths = {}
    label = f"bf16 {name}"
    ours = ("rqs_fwd", "head_rqs_fwd", "rqs_bwd", "rqs_bwd_autodiff",
            "head_rqs_bwd")
    served = _launching_bf16(lambda: serving_graphs(
        label, model, x, BATCH, per_lp, f"{label} serving",
        dtype=torch.bfloat16), f"{label} serving graphs")
    lp_fn, sampler = served["log_prob"]["fn"], served["sample"]["fn"]
    if served["log_prob"]["err"] != 0.0:
        raise RuntimeError(f"{label} log_prob: graph vs eager "
                           f"{served['log_prob']['err']:.3g}, not bitwise")
    _expect_launches(sampler.launches, per_sample, f"{label} sampler graph")
    counts = _captured_counts(served)
    paths[f"graphs: {label} serving"] = (
        _with_bf16(counts, {k: counts.get(k, 0) for k in ours}),
        PATH_KERNELS[f"{label} serving"]
        + tuple(k + "_bf16" for k in PATH_KERNELS[f"{label} serving"]))

    def eager_lp():
        with torch.inference_mode():
            return model.log_prob(x)

    def eager_sample():
        with torch.inference_mode():
            return model.sample(BATCH)

    casts = 0
    if name == "ar_nsf":
        # the LU layers' float32 solves, on the layout they meet in the
        # sampler (an autoregressive layer's output)
        with torch.inference_mode():
            z, _ = model.q0.forward(BATCH)
            z, _ = model.flows[0].forward(z)
        mix = model.flows[1]

        def mix_forward():
            with torch.inference_mode():
                return mix.forward(z)
        casts = SF_AR_LAYERS * len(_casts(captured_kernel_names(
            mix_forward)))
    nodes = {"log_prob": _graph_kernels_bf16(
        eager_lp, 1, per_lp, f"{label} log_prob graph"),
        "sample": _graph_kernels_bf16(eager_sample, 1, per_sample,
                                      f"{label} sample graph", casts)}
    modes = ("analytic", "autodiff") if kind == "forward" else ("analytic",)
    lr = SF_AR_LR if kind == "forward" else SF_CIRC_LR
    xs = ([sf_inputs(name, BATCH, SEED + 330 + i, dev)
           for i in range(GRAPH_STEPS + 30)] if kind == "forward" else None)
    gens = [torch.Generator(device=dev).manual_seed(SEED + 331)
            for _ in range(2)]
    for mode in modes:
        bwd = "rqs_bwd" if mode == "analytic" else "rqs_bwd_autodiff"
        want = {k: v for k, v in per_step.items() if k != "rqs_bwd"}
        want[bwd] = per_step["rqs_bwd"]
        path = f"{label} step" + (" (autodiff)" if mode == "autodiff"
                                  else "")
        if kind == "forward":
            st = _launching_bf16(lambda: step_graphs(
                f"{label} forward-KLD step ({mode}, B = {BATCH})", model,
                nt.make_forward_kld_step,
                lambda i, which: (xs[i % len(xs)],), path, dict(lr=lr),
                mode=mode), f"{label} step graph ({mode})")
        else:
            st = _launching_bf16(lambda: step_graphs(
                f"{label} reverse-KLD step ({mode}, B = "
                f"{CIRC_TRAIN_BATCH})", model,
                lambda opt: nt.make_reverse_kld_step(
                    opt, num_samples=CIRC_TRAIN_BATCH),
                lambda i, which: (gens[which],), path, dict(lr=lr),
                mode=mode), f"{label} step graph ({mode})")
        if st["err"] != (0.0, 0.0):
            raise RuntimeError(f"{label} step graph ({mode}): graph vs "
                               f"eager {st['err']}, not bitwise")
        _expect_launches(st["launches"], want, f"{label} step graph "
                                               f"({mode})")
        # every bf16 launch of C in the window took the shared path on the
        # coupled model (its CDFs), none on the autoregressive models
        win = _bf16_counts()
        shared = win["rqs_bwd"] if name == "circular_coupled" else 0
        if win["rqs_bwd_shared"] != shared:
            raise RuntimeError(f"{label} step graph ({mode}): "
                               f"{win['rqs_bwd_shared']} of C's "
                               f"{win['rqs_bwd']} bf16 launches took its "
                               f"shared path, expected {shared}")
        l16 = {k: st["launches"].get(k, 0) for k in ours}
        l16["rqs_bwd_shared"] = l16["rqs_bwd"] if shared else 0
        need = PATH_KERNELS[path] + tuple(
            k + "_bf16" for k in PATH_KERNELS[path] if k != "rqs_bwd")
        need += (("rqs_bwd_shared_bf16",) if shared
                 else ("rqs_bwd_bf16",)) if mode == "analytic" else ()
        paths[f"graphs: {path}"] = (_with_bf16(st["launches"], l16), need)
        # the step's body captured once, its kernel nodes by name (E and
        # C's shared path are two launches each); the reverse step's with
        # the device beta its own graph reads, on the default generator
        m_ = copy.deepcopy(model)
        opt = torch.optim.Adam(m_.parameters(), lr=lr, capturable=True)
        state = nt.init_train_state(m_, opt)
        if kind == "forward":
            eager = nt.make_forward_kld_step(opt).eager
            args = (xs[0],)
        else:
            step = nt.make_reverse_kld_step(opt,
                                            num_samples=CIRC_TRAIN_BATCH)
            gen = torch.Generator(device=dev).manual_seed(SEED + 333)
            for _ in range(3):  # two eager calls, then the capture
                step(state, gen)
            eager = functools.partial(step.eager, beta=step._last.beta)
            args = (None,)
        node_want = dict(want)
        if "head_rqs_bwd" in node_want:
            node_want["head_rqs_bwd"] *= 2
            node_want["rqs_bwd"] *= 2
        tk.set_pallas_bwd_kernel(mode)
        try:
            nodes[f"step ({mode})"] = _graph_kernels_bf16(
                lambda: eager(state, *args), 2, node_want,
                f"{label} step graph ({mode})")
        finally:
            tk.set_pallas_bwd_kernel("analytic")
    print(f"phase spline_family_bf16 {name} graphs: port kernels of a "
          f"captured call by name, all bfloat16 (kernels, graph nodes, "
          f"copies within one dtype): {nodes}; casts: none but the "
          f"sampler's {casts} (the LU layers' float32 solves)", flush=True)
    # the float32 twin's graphs in turns (and mixed precision's)
    x32 = x.float()
    lp32 = nt.compile_log_prob(m32, (BATCH, 2))
    bf16_turns(f"compile_log_prob (B = {BATCH})", lambda: lp32(x32),
               lambda: lp_fn(x), name)
    s32 = nt.compile_sampler(m32, BATCH)
    bf16_turns(f"compile_sampler (B = {BATCH})", lambda: s32(SEED),
               lambda: sampler(SEED), name)
    if kind == "forward":
        fns = [_sf_step_fn(name, m, lr, batches=[t.to(m_dtype)
                                                 for t in xs[:4]])
               for m, m_dtype in ((m32, torch.float32),
                                  (model, torch.bfloat16))]
    else:
        fns = [_sf_step_fn(name, m, lr, gen=torch.Generator(
            device=dev).manual_seed(SEED + 332)) for m in (m32, model)]
    for f in fns:  # two eager warm-up steps, then the capture
        for _ in range(3):
            f()
    bf16_turns(f"captured {kind} KLD step (B = "
               f"{BATCH if kind == 'forward' else CIRC_TRAIN_BATCH})", *fns,
               name)
    if name == "circular_nsf":
        mixed = nt.build_circular_nsf(K=CC_LAYERS, hidden=CC_HIDDEN,
                                      num_bins=CC_BINS, seed=SEED,
                                      mixed_precision=True, device=dev)
        sd = m32.state_dict()
        mixed.load_state_dict({k: sd[k.replace(".net.", ".")]
                               for k in mixed.state_dict()})
        mixed.p = GaussVonMises()
        lpm = nt.compile_log_prob(mixed, (BATCH, 2))
        sm = nt.compile_sampler(mixed, BATCH)
        stm = _sf_step_fn(name, mixed, lr, gen=torch.Generator(
            device=dev).manual_seed(SEED + 332))
        for _ in range(3):
            stm()
        rows = []
        for what, a, b in (("compile_log_prob", lambda: lpm(x32),
                            lambda: lp_fn(x)),
                           ("compile_sampler", lambda: sm(SEED),
                            lambda: sampler(SEED)),
                           ("captured reverse KLD step", stm, fns[1])):
            (m1, m2), (b1, b2) = in_turns(a, b)
            rows.append(f"{what}: mixed {m1:.3f} / {m2:.3f}, bf16 "
                        f"{b1:.3f} / {b2:.3f}")
        print(f"phase timing bf16 vs mixed_precision=True circular_nsf "
              f"(graphs, wall ms per call, median of 10, in turns mixed, "
              f"bf16, bf16, mixed): " + "; ".join(rows), flush=True)
    return paths


def phase_spline_family_bf16(dev, flush, peaks):
    """Phase 32: the bfloat16 autoregressive and circular spline models
    (:data:`SF_MODELS`) on the card: kernels A, C and D in bfloat16 at
    the MADE's K-major planes (linear and per-feature circular tails),
    B, E and C's shared path at the circular coupled model's circular
    operands, each against its plain version and timed in turns with
    float32; each model's ``log_prob`` and ``sample`` at B = 65536, card
    against CPU and by the round trip at the bf16 bar; each step at
    B = 4096 card against CPU (the AR NSF's forward-KLD step under
    "analytic" and "autodiff", the circular models' reverse-KLD step);
    then the graphs (:func:`sf_graphs`). Returns {path: (counts with
    their ``<kernel>_bf16``, kernels it must launch)}."""
    t0 = time.perf_counter()
    parity_kmajor_bf16(dev)
    t_parity = time.perf_counter() - t0
    timing_kmajor_bf16(dev, flush, peaks)
    t_kernels = time.perf_counter() - t0
    paths = {}
    for name, (build, per_lp, _, per_step, kind, _) in SF_MODELS.items():
        t1 = time.perf_counter()
        model = build()
        dtypes = {str(t.dtype) for t in list(model.parameters())
                  + list(model.buffers()) if t.is_floating_point()}
        if dtypes != {"torch.bfloat16"}:
            raise RuntimeError(f"bf16 {name} holds {dtypes}")
        m32 = build(torch.float32)
        m32.load_state_dict(model.state_dict())
        if name == "circular_coupled":
            sf_head_kernels(dev, flush, peaks, model, m32)
        x = sf_inputs(name, BATCH, SEED + 328, dev)
        need = tuple(per_lp) + tuple(k + "_bf16" for k in per_lp)
        counts, bf16 = sf_serving_checks(name, model, x)
        paths[f"bf16 {name} serving"] = (_with_bf16(counts, bf16), need)
        if kind == "forward":
            cpu = None
            for mode in ("analytic", "autodiff"):
                bwd = "rqs_bwd" if mode == "analytic" else "rqs_bwd_autodiff"
                want = {"rqs_fwd": per_step["rqs_fwd"],
                        bwd: per_step["rqs_bwd"]}
                counts, bf16, _, cpu = bf16_step_check(
                    model, x, mode, label=name, per_step=want,
                    rows=SF_CHECK_BATCH, cpu=cpu)
                paths[f"bf16 {name} step ({mode})"] = (
                    _with_bf16(counts, bf16),
                    need + (bwd, bwd + "_bf16"))
        else:
            counts, bf16 = sf_reverse_check(name, model, dev)
            more = tuple(k for k in per_step if k not in per_lp)
            c_bf16 = ("rqs_bwd_shared_bf16" if name == "circular_coupled"
                      else "rqs_bwd_bf16")
            paths[f"bf16 {name} step"] = (
                _with_bf16(counts, bf16),
                need + more + tuple(k + "_bf16" for k in more
                                    if k != "rqs_bwd") + (c_bf16,))
        t2 = time.perf_counter()
        paths.update(sf_graphs(name, model, m32, x, dev))
        print(f"phase timing phase 32 {name}: "
              f"{time.perf_counter() - t1:.1f} s, the graphs "
              f"{time.perf_counter() - t2:.1f} s of it", flush=True)
        del model, m32
    print(f"phase timing phase 32 (spline_family_bf16): "
          f"{time.perf_counter() - t0:.1f} s, kernels A, C, D "
          f"{t_kernels:.1f} s of it (parity {t_parity:.1f} s)", flush=True)
    return paths


EXAMPLE_ITERS = 100  # phase 30: a twin's iterations, at most (its default)
# phase 30's bar on the full recipe of examples_torch/neural_spline_flow.py
# (2000 iterations, batch 512): the mean of its last 100 iterations'
# losses lies in the JAX example's mean over seeds 0-2 on the CPU, plus or
# minus three times the larger seed-to-seed spread of the JAX example and
# the twin on the CPU (tests/recipe_bar_nsf.py)
NSF_RECIPE_BAR = (1.558778, 1.609962)
# each twin of examples_torch/ (its flags beyond --device and --iters),
# the port kernels it must launch, and whether its loss must fall (an
# annealed reverse KLD's objective changes with beta, so its loss is only
# held finite); the first, NSF_RECIPE, runs its full recipe
NSF_RECIPE = "neural_spline_flow"
EXAMPLE_TWINS = (
    (NSF_RECIPE, [], ("rqs_fwd", "rqs_bwd"), True),
    ("neural_spline_flow --autoregressive", ["--autoregressive"],
     ("rqs_fwd", "rqs_bwd"), True),
    ("conditional_flow", [], ("rqs_fwd", "head_rqs_fwd", "rqs_bwd"), True),
    ("circular_nsf", [], ("rqs_fwd", "rqs_bwd"), True),
    ("paper_example_nsf", [], ("rqs_fwd", "rqs_bwd"), True),
    ("serving_inference", [], ("rqs_fwd", "rqs_bwd"), True),
    ("multichip_training", [], ("rqs_fwd", "rqs_bwd"), True),
    ("image_nsf", [], ("rqs_fwd", "rqs_bwd"), True),
    ("real_nvp", [], (), False),
    ("planar", [], (), True),
    ("comparison_plan_rad_aff", [], (), False),
    ("augmented_flow", [], (), False),
    ("change_base_distribution", [], (), True),
    ("residual", [], (), True),
    ("stochastic_nf", [], (), False),
    ("hais_sampling", [], (), False),
    ("vae", [], (), True),
    ("image", [], (), True),
    ("glow", [], (), True),
)
# multichip_training's histories that train one objective (its reverse
# KLD is annealed; its pipeline takes 8 steps)
MULTICHIP_FALLS = ("forward_kld",)
# runs whose loss leaves float32 in the JAX example too
# (examples/comparison_plan_rad_aff.py, affine on smiley: non-finite by
# iteration 50 at its defaults and by iteration 10 at 100 iterations, on
# the CPU); only their first DIVERGED_FINITE losses are held finite
DIVERGES_IN_JAX = {("comparison_plan_rad_aff", "affine on smiley")}
DIVERGED_FINITE = 5
# the residual recipe's rate is 3e-4: 100 of its 3000 iterations moved the
# loss 0.094 nats on the CPU, so its fall is held to half of LOSS_MARGIN
EXAMPLE_MARGINS = {"residual": LOSS_MARGIN / 2}


def _histories(out):
    """``{label: History}`` of a twin's result."""
    hist = out.get("hist")
    if hist is None:
        return {}
    return dict(hist) if isinstance(hist, dict) else {"": hist}


def _check_losses(name, hists, falls):
    """Every loss finite; where ``falls``, the mean of the last 10 below
    the first 10's by LOSS_MARGIN. Returns ``{label: (first 10, last
    10)}``."""
    means = {}
    for label, h in hists.items():
        v = h.losses.cpu().numpy()
        what = f"{name} {label}".strip()
        if (name, label) in DIVERGES_IN_JAX:
            bad = np.flatnonzero(~np.isfinite(v))
            if not (len(v) and np.all(np.isfinite(v[:DIVERGED_FINITE]))):
                raise RuntimeError(f"examples {what}: a loss of the first "
                                   f"{DIVERGED_FINITE} is not finite: {v}")
            print(f"phase examples {what}: first non-finite loss at "
                  f"iteration {bad[0] if len(bad) else 'none'} (the JAX "
                  f"example's run leaves float32 on the CPU)", flush=True)
            continue
        if not (len(v) and np.all(np.isfinite(v))):
            raise RuntimeError(f"examples {what}: a loss is not finite: {v}")
        means[label] = (float(v[:10].mean()), float(v[-10:].mean()))
        want = falls and (name != "multichip_training"
                          or label in MULTICHIP_FALLS)
        margin = EXAMPLE_MARGINS.get(name, LOSS_MARGIN)
        if want and not means[label][1] < means[label][0] - margin:
            raise RuntimeError(
                f"examples {what}: loss {means[label][0]:.4f} (first 10) -> "
                f"{means[label][1]:.4f} (last 10), falling by {margin} "
                f"expected")
    return means


def recipe_draw_ms(dev, batch=512, reps=200):
    """Wall ms of one eager draw of the full recipe's batch from TwoMoons
    (the rejection loop, one host read per round; the recipe itself draws
    inside its captured step), synchronised, mean of ``reps``."""
    import nf_tpu_torch as nt

    target = nt.TwoMoons()
    gen = torch.Generator(device=dev).manual_seed(SEED + 700)
    target.sample(batch, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        target.sample(batch, generator=gen)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def run_twin(name, argv):
    """One twin's ``main(argv)`` on the card with the counters at 0 before
    it: (its result, the launches it counted, wall seconds, its last
    output lines)."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"examples_torch.{name}")
    text = io.StringIO()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        out = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, read_counts(), wall, text.getvalue().strip().splitlines()


def phase_examples(dev):
    """Phase 30: every twin of ``examples_torch/`` (the example scripts on
    ``nf_tpu_torch``) through its ``main()`` in this process on the card,
    at its default widths and batch, its iterations capped at
    EXAMPLE_ITERS but for ``neural_spline_flow.py``'s full recipe (2000),
    its output files in a temporary directory: losses finite, falling
    where the objective is fixed; the launches each run counted; the full
    recipe's mean of its last 100 losses held to NSF_RECIPE_BAR;
    ``serving_inference.py``'s served ``log_prob`` and ``sample``
    (B = 4096) through kernel B. Returns {path: (launches, the kernels it
    must launch)}."""
    import importlib
    import tempfile

    from examples_torch import _utils

    t_phase = time.perf_counter()
    paths = {}
    rows = []
    saved = _utils.OUT_DIR
    with tempfile.TemporaryDirectory() as d:
        _utils.OUT_DIR = d
        try:
            for spec, extra, needed, falls in EXAMPLE_TWINS:
                name = spec.split()[0]
                mod = importlib.import_module(f"examples_torch.{name}")
                argv = ["--device", "cuda"] + extra
                default = mod.parser().get_default("iters")
                if default is not None and spec != NSF_RECIPE:
                    argv += ["--iters", str(min(default, EXAMPLE_ITERS))]
                out, counts, wall, lines = run_twin(name, argv)
                hists = _histories(out)
                means = _check_losses(name, hists, falls)
                label = f"{spec} (full recipe)" if spec == NSF_RECIPE else spec
                paths[f"examples: {label}"] = (counts, needed)
                iters = sum(len(h.losses) for h in hists.values())
                loop_s = sum(h.seconds for h in hists.values())
                rows.append((label, wall, iters, loop_s, means, counts,
                             lines))
                if spec == NSF_RECIPE:
                    recipe = recipe_check(dev, hists[""])
                if name == "serving_inference":
                    served_check(out)
                if name == "hais_sampling" and not (
                        np.isfinite(out["log_z"]) and out["ess"] > 0):
                    raise RuntimeError(f"examples hais_sampling: log Z "
                                       f"{out['log_z']}, ESS {out['ess']}")
        finally:
            _utils.OUT_DIR = saved
    for label, wall, iters, loop_s, means, counts, lines in rows:
        rate = f"{iters / loop_s:.1f} it/s" if iters and loop_s else "—"
        loss = "; ".join(f"{k or 'loss'} {a:+.4f} -> {b:+.4f}"
                         for k, (a, b) in means.items())
        print(f"phase examples {label}: {wall:.1f} s wall, {iters} "
              f"iterations in {loop_s:.2f} s ({rate}); first 10 -> last 10: "
              f"{loss or '—'}; launches {_nonzero(counts)}; output: "
              + " | ".join(lines[-3:]), flush=True)
    print(recipe, flush=True)
    print(f"phase timing phase 30 (examples): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


def recipe_check(dev, hist):
    """The full recipe's final loss (the mean of its last 100 iterations'
    losses) within NSF_RECIPE_BAR; returns the line that states it, its
    ms per iteration and the target's draw alone (printed last, so the
    tail of the output holds it)."""
    final = hist.final_loss(100)
    lo, hi = NSF_RECIPE_BAR
    if not lo <= final <= hi:
        raise RuntimeError(
            f"examples {NSF_RECIPE}: the full recipe's final loss (mean of "
            f"the last 100 of {len(hist.losses)}) {final:.4f} is outside "
            f"the bar [{lo:.4f}, {hi:.4f}]")
    return (f"phase examples {NSF_RECIPE} full recipe (build_nsf dim 2, K 4, "
            f"hidden 64, 8 bins; {len(hist.losses)} iterations at batch "
            f"512, Adam 3e-3): final loss (mean of the last 100 iterations) "
            f"{final:.6f}, bar [{lo:.6f}, {hi:.6f}] (tests/recipe_bar_nsf.py "
            f"on the CPU); {1e3 * hist.seconds / len(hist.losses):.3f} ms "
            f"per iteration, the target's draw alone "
            f"{recipe_draw_ms(dev):.3f} ms")


def served_check(out):
    """``serving_inference``'s served ``log_prob`` and ``sample``: each
    replay launches kernel B (their captures are in the twin's counts)."""
    served = out["served"]
    for call in ("log_prob", "sample"):
        if not served[call].get("head_rqs_fwd"):
            raise RuntimeError(f"examples serving_inference: the served "
                               f"{call} launched no kernel B: "
                               f"{served[call]}")
    print(f"phase examples serving_inference: served launches per replay "
          f"log_prob {_nonzero(served['log_prob'])}, sample "
          f"{_nonzero(served['sample'])}, the reloaded artifact "
          f"{_nonzero(served['exported log_prob'])}; sample vs log_prob "
          f"{out['sample_log_prob_err']:.3g}, artifact vs compiled "
          f"{out['artifact_err']:.3g}, {out['samples_per_s']:.0f} "
          f"samples/s", flush=True)


# --- phase 31: the targets' rejection draw ----------------------------------

DRAW_REPS = 50  # eager draws of each target: host syncs and wall ms
DRAW_SYNC_LIMIT = 2  # the median host syncs of an eager draw, at most
DRAW_BATCHES = (512, BATCH)  # the NSF recipe's batch, the binary's
DRAW_SIGMAS = 4.0  # card against CPU: moments and shares, in sampling sigmas
DRAW_SEEDS = (SEED + 3100, SEED + 3200)  # two replays' generator seeds


def draw_targets(dev):
    """Phase 31's targets on ``dev``: TwoMoons, an ``ImagePrior`` on the
    first channel of ``procedural_image_classes(0, 1)``'s image, Smiley."""
    from nf_tpu_torch.data import procedural_image_classes
    from nf_tpu_torch.distributions import ImagePrior, Smiley, TwoMoons

    image = procedural_image_classes(SEED, 1)[0][0, 0].astype(np.float32)
    return {"TwoMoons": TwoMoons(), "ImagePrior": ImagePrior(
        image / 255, device=dev), "Smiley": Smiley()}


def law_gap(a, b):
    """The largest gap between two draws' means, covariances and quadrant
    shares (about their pooled mean), in sigmas of its sampling error."""
    a, b = (np.asarray(t.detach().cpu(), np.float64) for t in (a, b))
    gaps = []
    for x, y in ((a, b), (a - a.mean(0), b - b.mean(0))):
        if x is not a:  # the centred products: the covariances
            x = (x[:, :, None] * x[:, None, :]).reshape(len(x), -1)
            y = (y[:, :, None] * y[:, None, :]).reshape(len(y), -1)
        sigma = np.sqrt(x.var(0) / len(x) + y.var(0) / len(y))
        gaps.append(np.abs(x.mean(0) - y.mean(0)) / sigma)
    centre = np.concatenate([a, b]).mean(0)
    sa, sb = (np.bincount((x[:, 0] > centre[0]) * 2 + (x[:, 1] > centre[1]),
                          minlength=4) / len(x) for x in (a, b))
    p = (sa + sb) / 2
    gaps.append(np.abs(sa - sb) / np.sqrt(p * (1 - p) * (1 / len(a)
                                                         + 1 / len(b))))
    return float(max(np.max(g) for g in gaps))


def rate_gap(card, cpu):
    """The gap between two acceptance counts' rates, in sigmas."""
    p1, p2 = (r.accepted / r.proposed for r in (card, cpu))
    p = (card.accepted + cpu.accepted) / (card.proposed + cpu.proposed)
    return abs(p1 - p2) / np.sqrt(p * (1 - p) * (1 / card.proposed
                                                 + 1 / cpu.proposed))


def measured_draw(target, n, gen):
    """An eager draw of ``n`` from ``target`` and the
    ``AcceptanceRate`` that its rounds counted."""
    from nf_tpu_torch.distributions.target import (
        AcceptanceRate,
        rejection_loop,
    )

    rate = AcceptanceRate()
    x = rejection_loop(target._acceptance(), n, target.n_dims, gen,
                       torch.float32, target._device(gen, None), rate=rate)
    return x, rate


def eager_draw_check(label, target, n, gen):
    """DRAW_REPS eager draws of ``n`` from ``target``: host syncs per draw
    (the median at most DRAW_SYNC_LIMIT), then the wall ms of one
    synchronised draw (median of DRAW_REPS) and the pool that one eager
    draw sizes."""
    syncs = [len(host_syncs(lambda: target.sample(n, gen)))
             for _ in range(DRAW_REPS)]
    median = float(np.median(syncs))
    if median > DRAW_SYNC_LIMIT:
        raise RuntimeError(f"target draw {label} ({n}): host syncs per "
                           f"eager draw {syncs}, median {median} > "
                           f"{DRAW_SYNC_LIMIT}")
    ms = host_ms(lambda: target.sample(n, gen), reps=DRAW_REPS)
    return dict(syncs=syncs, median=median, ms=ms,
                pool=target.pool_size(n, gen))


def captured_draw_check(label, target, n, pool, dev):
    """The sync-free draw of ``n`` captured in a CUDA graph with its
    generator registered: a replay makes no host sync, two replays differ,
    a replay is bitwise the eager sync-free draw from the same generator
    state (which makes no host sync either), and a graph whose pool is
    ``n`` (short at these targets' rates) flags ``full`` false. Returns
    the replay's wall ms, its batch and the numbers."""
    from nf_tpu_torch._graphs import capture, warm_up

    gen, short_gen = (torch.Generator(device=dev) for _ in range(2))

    def draw(pool=pool, g=gen):
        return target.sample_pool(n, pool, g)

    warm_up(draw, dev, 1)
    graph, (x, full), _ = capture(draw, dev, generators=(gen,))
    gen.manual_seed(DRAW_SEEDS[0])
    graph.replay()
    first, first_full = x.clone(), bool(full)
    gen.manual_seed(DRAW_SEEDS[1])
    replay_syncs = host_syncs(graph.replay)
    differ = not torch.equal(first, x)
    gen.manual_seed(DRAW_SEEDS[0])
    eager = []
    eager_syncs = host_syncs(lambda: eager.append(draw()))
    bitwise = torch.equal(eager[0][0], first) and bool(eager[0][1])
    warm_up(lambda: draw(n, short_gen), dev, 1)
    short, (_, short_full), _ = capture(lambda: draw(n, short_gen), dev,
                                        generators=(short_gen,))
    short.replay()
    ms = host_ms(graph.replay, reps=DRAW_REPS)
    ok = (first_full and not replay_syncs and differ and bitwise
          and not eager_syncs and not bool(short_full))
    if not ok:
        raise RuntimeError(
            f"target draw {label} ({n}), captured: full {first_full}, "
            f"host syncs of a replay {replay_syncs}, two replays differ "
            f"{differ}, bitwise the eager sync-free draw {bitwise}, its "
            f"host syncs {eager_syncs}, a pool of {n} flags full "
            f"{bool(short_full)} (false expected)")
    return dict(pool=pool, ms=ms, x=first)


def deterministic_check(target, n, pool, dev):
    """The eager draw under ``torch.use_deterministic_algorithms(True)``
    (``index_put_`` with repeated indices into the drop row) against the
    default: 'bitwise', or what it raised."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(DRAW_SEEDS[0])
    want = target.sample(n, gen, round_size=pool)
    gen.manual_seed(DRAW_SEEDS[0])
    torch.use_deterministic_algorithms(True)
    try:
        got = target.sample(n, gen, round_size=pool)
    except RuntimeError as e:
        return f"raises ({str(e).splitlines()[0][:120]})"
    finally:
        torch.use_deterministic_algorithms(False)
    if not torch.equal(got, want):
        raise RuntimeError("target draw: the eager draw under deterministic "
                           "algorithms differs from the default's")
    return "bitwise the default's"


def phase_target_draw(dev):
    """Phase 31: the targets' rejection draw (``distributions/target.py``)
    on the card: TwoMoons at 512 and 65536, ``ImagePrior`` and Smiley at
    512; the eager loop's host syncs per draw and wall ms, the captured
    sync-free draw's checks and replay ms, the eager draw under
    deterministic algorithms, and the law card against CPU at 65536
    (means, covariances, quadrant shares, the acceptance rate; the
    captured TwoMoons draw too). No port kernel runs. Returns
    {path: (launches, ())}."""
    t_phase = time.perf_counter()
    reset_counts()
    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 3000)
    law = []
    targets = draw_targets(dev)
    cpu_targets = draw_targets("cpu")
    for label, target in targets.items():
        for n in DRAW_BATCHES if label == "TwoMoons" else DRAW_BATCHES[:1]:
            eager = eager_draw_check(label, target, n, gen)
            graph = captured_draw_check(label, target, n, eager["pool"], dev)
            rows.append((label, n, eager, graph))
        x_cpu, cpu_rate = measured_draw(
            cpu_targets[label], BATCH,
            torch.Generator().manual_seed(SEED + 3300))
        x_card, card_rate = measured_draw(target, BATCH, gen)
        law.append((label, law_gap(x_card, x_cpu),
                    rate_gap(card_rate, cpu_rate),
                    card_rate.accepted / card_rate.proposed,
                    cpu_rate.accepted / cpu_rate.proposed))
        if label == "TwoMoons":
            law.append(("TwoMoons captured", law_gap(graph["x"], x_cpu),
                        0.0, float("nan"), float("nan")))
            determinism = deterministic_check(target, BATCH, graph["pool"],
                                              dev)
    bad = [(k, g, r) for k, g, r, _, _ in law
           if not (g <= DRAW_SIGMAS and r <= DRAW_SIGMAS)]
    if bad:
        raise RuntimeError(f"target draw: card against CPU beyond "
                           f"{DRAW_SIGMAS} sigma (label, law, rate): {bad}")
    counts = read_counts()
    text = "; ".join(
        f"{label} {n}: eager {e['ms']:.3f} ms, host syncs per draw median "
        f"{e['median']:g} (min {min(e['syncs'])}, max {max(e['syncs'])}); "
        f"captured replay {g['ms']:.3f} ms (pool {g['pool']})"
        for label, n, e, g in rows)
    print(f"phase target draw (wall ms per synchronised draw, median of "
          f"{DRAW_REPS}): {text}; captured: 0 host syncs per replay, "
          f"replays differ, bitwise the eager sync-free draw, a short pool "
          f"flags full false; under deterministic algorithms "
          f"{determinism}; card against CPU at {BATCH} (max sigma of means, "
          f"covariances, quadrant shares; acceptance rate card / CPU): "
          + ", ".join(f"{k} {g:.2f} sigma" + (
              f", rate {p1:.5f} / {p2:.5f} ({r:.2f} sigma)"
              if np.isfinite(p1) else "") for k, g, r, p1, p2 in law)
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"target draw": (counts, ())}


def dispatch_turns(parent):
    """``python3 chip_smoke.py --dispatch-turns PARENT``: the eager
    ``build_nsf`` ``log_prob`` and forward-KLD step at B = 65536 of the
    package in the checkout ``PARENT`` (one from before the kernels became
    ``torch.library`` ops, whose kernels sat behind
    ``torch.autograd.Function``s) and of this one, on the same weights and
    batch, wall ms in turns (parent, this, this, parent). Prints no
    result line."""
    import importlib.util
    import os

    import nf_tpu_torch as nt

    pkg = os.path.join(os.path.abspath(parent), "nf_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "nf_tpu_torch_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    old = importlib.util.module_from_spec(spec)
    sys.modules["nf_tpu_torch_parent"] = old
    spec.loader.exec_module(old)
    phase_device()
    dev = torch.device("cuda")
    new_model = _nsf_model()
    old_model = old.build_nsf(dim=2, K=8, hidden=HIDDEN, num_bins=K_BINS,
                              num_blocks=2, tail_bound=3.0)
    old_model.load_state_dict(new_model.state_dict())
    x = nt.TwoMoons().sample(BATCH, generator=torch.Generator(
        device=dev).manual_seed(SEED + 610))
    with torch.no_grad():
        err = max_err(old_model.log_prob(x), new_model.log_prob(x))
    rows = [f"log_prob of the two packages {err:.3g} apart"]
    calls = {}
    for name, pkg_, model in (("parent", old, old_model),
                              ("ops", nt, new_model)):
        opt = torch.optim.Adam(model.parameters(), lr=1e-4, capturable=True)
        state = pkg_.init_train_state(model, opt)
        step = pkg_.make_forward_kld_step(opt).eager

        def lp(model=model):
            with torch.no_grad():
                model.log_prob(x)
        calls[name] = (lp, lambda step=step, state=state: step(state, x))
    for i, what in enumerate(("log_prob", "forward-KLD step")):
        turns = [in_turns(calls["parent"][i], calls["ops"][i], reps=30)
                 for _ in range(2)]
        rows.append(f"eager {what}: parent " + " / ".join(
            f"{t:.3f}" for (p, _) in turns for t in p) + ", through the ops "
            + " / ".join(f"{t:.3f}" for (_, n) in turns for t in n) + " ms")
    print("dispatch turns (build_nsf, B = 65536, wall ms, median of 30, "
          "twice in turns parent, ops, ops, parent): " + "; ".join(rows),
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import nf_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
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
    print("phase timing rqs_bwd per-element path at the CDF: "
          + _timing_row(f"x ({BATCH}, 1), (K, {BATCH}, 1) stride-0 views",
                        timing_kernel_c(dev, flush, peaks, shared=False)),
          flush=True)
    timing_cdf_backward(dev, flush, peaks)
    timing_kernel_a_other(dev, flush, peaks)
    timing_kernel_b_other(dev, flush, peaks)
    timing_kernel_e_other(dev, flush, peaks)
    yardstick_kernel_e(dev)
    timing_path_a_c(dev, flush, peaks)
    launch_floor(flush)
    # kernel F, the residual fixed point's loop condition (phase 18's path)
    results["fixed_point_cond"] = phase_kernel_f(dev, flush, peaks)

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
    # a graph path's counts are its captures': what one replay launches
    graph_paths = phase_graphs(dev, flush)
    for path, counts in graph_paths.items():
        paths[f"graphs: {path}"] = (counts, PATH_KERNELS[path])
    phase_mixed(dev, flush)
    t_new = time.perf_counter()
    paths.update(phase_conditional(dev, flush, peaks))
    paths.update(phase_realnvp(dev, flush))
    paths.update(phase_maf(dev, flush))
    print(f"phase timing phases 12-14 (conditional, realnvp, maf): "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    t_new = time.perf_counter()
    paths.update(phase_image_nsf(dev, flush, peaks))
    paths.update(phase_glow(dev, flush))
    print(f"phase timing phases 15-16 (image_nsf, glow): "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)
    # phase 28, the bfloat16 image NSF, beside the float32 one
    bf16_paths, bf16_rows = phase_image_nsf_bf16(dev, flush, peaks)
    paths.update(bf16_paths)
    for name, _, source, replaces in BF16_KERNELS:
        err, t = bf16_rows[name]
        # the inverse direction: the log_prob's and the step's
        results[name] = dict(err=err, t=t[True], source=source,
                             replaces=replaces)
    # phase 29, the bfloat16 coupled NSF, beside its float32 twin
    bf16_paths, bf16_rows = phase_coupled_nsf_bf16(dev, flush, peaks)
    paths.update(bf16_paths)
    for name, _, source, replaces in BF16_HEAD_KERNELS:
        err, t = bf16_rows[name]
        # the forward direction: the log_prob's and the step's
        results[name] = dict(err=err, t=t[False], source=source,
                             replaces=replaces)
    # phase 32, the bfloat16 autoregressive and circular spline models
    paths.update(phase_spline_family_bf16(dev, flush, peaks))
    cc_paths, _ = phase_circular_coupled(dev, flush, peaks)
    paths.update(cc_paths)
    paths.update(phase_residual(dev, flush))
    paths.update(phase_planar_radial(dev, flush))
    paths.update(phase_dropout_batch_norm(dev, flush))
    paths.update(phase_layers_distributions(dev, flush))
    t_new = time.perf_counter()
    snf_paths, snf = phase_snf(dev, flush)
    paths.update(snf_paths)
    paths.update(phase_snf_nsf(dev, flush))
    paths.update(phase_mh(dev))
    paths.update(phase_hais(dev, flush))
    paths.update(phase_vae(dev, flush))
    paths.update(phase_infrastructure(dev, flush, snf))
    print(f"phase timing phases 22-25 (snf, snf_nsf, mh, hais, vae, "
          f"infrastructure): {time.perf_counter() - t_new:.1f} s", flush=True)
    paths.update(phase_training_binary(dev))
    paths.update(phase_export(dev, flush, peaks))
    paths.update(phase_target_draw(dev))
    paths.update(phase_examples(dev))
    per_element_bars()
    print("launches: " + "; ".join(f"{k} {v[0]}" for k, v in paths.items()),
          flush=True)
    for path, (counts, needed) in paths.items():
        for label in needed:
            if counts[label] == 0:
                raise RuntimeError(f"{label} never ran on the {path} path")
        if not needed and any(counts.values()):
            raise RuntimeError(f"the {path} path launched port kernels: "
                               f"{counts}")
    kernels = []
    for label, r in results.items():
        ms, plain, bound_ms, bound_by = r["t"]
        kernels.append({
            "name": label, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"],
            "launches": sum(c.get(label, 0) for c, _ in paths.values()),
            "max_abs_err": r["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    print(f"phase total: {time.perf_counter() - t_start:.1f} s wall, the "
          f"build included", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dispatch-turns"] and len(sys.argv) == 3:
        sys.exit(dispatch_turns(sys.argv[2]))
    sys.exit(main())
