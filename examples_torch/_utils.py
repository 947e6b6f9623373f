"""Shared helpers of the twins (``examples/_utils.py``).

Every twin is a small CLI with its JAX script's flags and defaults plus
``--device``: the card unless ``--device cpu`` is given, and without CUDA
it raises (``nf_tpu_torch.resolve_device``). Figures and CSVs go to
``examples_torch/out/``.

:func:`train` is the JAX helper's loop on the port's steps
(``nf_tpu_torch.parallel.make_forward_kld_step`` /
``make_reverse_kld_step``), each one CUDA graph on the card. A
forward-KLD objective whose batch is a draw from a distribution
(``ForwardKLD(draw=...)``) draws it inside the captured step from the
step's own generator, reseeded every iteration, as the JAX helper's
jitted step draws from its per-iteration key (a rejection sampler's
sync-free form, whose pool was fixed before the capture). A host-fed
objective's ``batch(generator, it)`` runs before the step, which takes
the batch as its input. The loss is read to the host only at the log
points (10 per run).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from nf_tpu_torch import (
    init_train_state,
    make_forward_kld_step,
    make_reverse_kld_step,
    resolve_device,
)

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")

# the generator streams a twin draws from, apart from the model's weights
# (which the builders draw from ``seed`` on the host)
TRAIN_STREAM = 0x7EA1
DATA_STREAM = 1
EVAL_STREAM = 2


def out_path(name):
    os.makedirs(OUT_DIR, exist_ok=True)
    return os.path.join(OUT_DIR, name)


def add_device(p):
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain PyTorch versions)")
    return p


def base_parser(description, iters, lr=1e-3, num_samples=512):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--iters", type=int, default=iters)
    p.add_argument("--lr", type=float, default=lr)
    p.add_argument("--num-samples", type=int, default=num_samples)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--plot", action="store_true", help="save pngs to out/")
    p.add_argument("--log-every", type=int, default=0,
                   help="0 = auto (10 prints per run)")
    return add_device(p)


def device_of(args):
    """The run's device: CUDA unless ``--device`` names another; raises
    without CUDA."""
    return resolve_device(args.device)


def generator(device, seed, stream):
    """A generator on ``device`` for one stream of a run seeded with
    ``seed`` (the streams of one seed are unrelated)."""
    state = np.random.SeedSequence([seed, stream]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def log_every(args):
    return args.log_every or max(1, args.iters // 10)


@dataclasses.dataclass(frozen=True)
class ForwardKLD:
    """The maximum-likelihood objective of :func:`train`, its batch a
    tensor, or a tuple such as ``(x, context)`` or ``(x, y)``, and its
    loss ``loss_fn(model, batch)`` (None: ``model.forward_kld(*batch)``).

    ``draw(generator) -> (batch, full)``: the batch is drawn inside the
    captured step from the step's own generator, reseeded from ``(seed,
    it)`` every iteration; ``full`` is a device bool, false when a
    rejection sampler's fixed pool fell short (None: the draw cannot), and
    :func:`train` raises at its next read if any draw fell short.
    ``batch(generator, it)``: the batch is drawn or fed on the host's
    side, before the step. ``keyed`` (with ``batch``): the loss draws too
    (a residual flow's stochastic log-det), as ``loss_fn(model, batch,
    generator)`` from the step's own generator, reseeded for every
    iteration."""

    batch: Optional[Callable] = None
    loss_fn: Optional[Callable] = None
    keyed: bool = False
    draw: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class ReverseKLD:
    """The variational objective of :func:`train`:
    ``model.reverse_kld(num_samples, beta=beta(it))`` against the model's
    target, the samples drawn inside the step (``beta`` None: 1)."""

    num_samples: int
    beta: Optional[Callable] = None


class History(list):
    """``(iteration, loss)`` at the log points, as the JAX helper returns.
    ``losses`` holds every iteration's loss on the device, read only when
    asked; ``seconds`` is the loop's wall time (the device synchronised
    at its end)."""

    def __init__(self, iters, device):
        super().__init__()
        self.losses = torch.full((iters,), float("nan"), device=device)
        self.seconds = 0.0

    def record(self, it, loss):
        self.losses[it] = loss

    def final_loss(self, last=100):
        """The mean of the last ``last`` iterations' losses."""
        return float(torch.mean(self.losses[-last:]))


def target_draw(target, args, device):
    """The in-step draw of ``args.num_samples`` points from a target
    sampled by rejection, for ``ForwardKLD(draw=...)``: its sync-free
    form, the pool fixed by an eager draw from the seed's data stream."""
    return target.sampler(args.num_samples,
                          generator(device, args.seed, DATA_STREAM))


def keyed_seed(seed, it):
    """Iteration ``it``'s integer seed for a keyed step."""
    return int(np.random.SeedSequence([seed, it]).generate_state(1)[0])


def optimizer(model, lr, weight_decay=0.0):
    """Adam, or AdamW with ``weight_decay`` (optax's ``adam`` /
    ``adamw``); on CUDA its state lives on the card (``capturable``), as a
    captured step needs. ``lr`` may be a device tensor that a schedule
    fills in place."""
    dev = next(model.parameters()).device
    kw = dict(lr=lr, capturable=dev.type == "cuda")
    if weight_decay:
        return torch.optim.AdamW(model.parameters(),
                                 weight_decay=weight_decay, **kw)
    return torch.optim.Adam(model.parameters(), **kw)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(model, loss, args, weight_decay=0.0, post_update=None,
          lr_schedule=None):
    """The training loop of ``examples/_utils.py``: ``args.iters`` steps of
    ``loss`` (a :class:`ForwardKLD` or :class:`ReverseKLD`) with Adam at
    ``args.lr`` (AdamW with ``weight_decay``), a progress line at the log
    points. ``post_update(model)`` runs inside the step after the update,
    in place (a residual flow's power iteration). ``lr_schedule(it)`` is
    the rate of iteration ``it``, written into the optimizer's tensor rate
    before each step. The model trains in place; returns ``(model,
    History)``."""
    dev = next(model.parameters()).device
    lr = args.lr
    if lr_schedule is not None:
        lr = torch.tensor(float(lr_schedule(0)), device=dev)
    opt = optimizer(model, lr, weight_decay)
    state = init_train_state(model, opt)
    gen = generator(dev, args.seed, TRAIN_STREAM)
    short = None
    if isinstance(loss, ReverseKLD):
        step = make_reverse_kld_step(opt, loss.num_samples,
                                     beta_schedule=loss.beta,
                                     post_update=post_update)

        def run(it):
            return step(state, gen)
    elif loss.draw is not None:
        step, short = _drawing_step(loss, opt, post_update, dev)
        inputs = torch.empty(0, device=dev)  # the step draws its own

        def run(it):
            return step(state, inputs, keyed_seed(args.seed, it))
    else:
        step = make_forward_kld_step(opt, loss_fn=loss.loss_fn,
                                     with_key=loss.keyed,
                                     post_update=post_update)

        def run(it):
            batch = loss.batch(gen, it)
            if loss.keyed:
                return step(state, batch, keyed_seed(args.seed, it))
            return step(state, batch)

    every = log_every(args)
    hist = History(args.iters, dev)
    t0 = time.time()
    for it in range(args.iters):
        if lr_schedule is not None:
            lr.fill_(float(lr_schedule(it)))
        value = run(it)
        hist.record(it, value)
        if it % every == 0 or it == args.iters - 1:
            value = float(value)
            _check_draws(short, it)
            hist.append((it, value))
            print(f"iter {it:6d}  loss {value:+.4f}", flush=True)
    sync(dev)
    _check_draws(short, args.iters - 1)
    hist.seconds = time.time() - t0
    print(f"{args.iters} iters in {hist.seconds:.1f}s on {dev.type}")
    return model, hist


def _drawing_step(loss, opt, post_update, device):
    """The forward-KLD step of a ``ForwardKLD(draw=...)`` objective: a
    keyed step whose loss draws its batch from the step's generator, and
    the device count of the draws that fell short, which the step adds
    to."""
    short = torch.zeros((), dtype=torch.int64, device=device)

    def drawn_loss(model, _, generator):
        batch, full = loss.draw(generator)
        if full is not None:
            short.add_(torch.logical_not(full))
        if loss.loss_fn is not None:
            return loss.loss_fn(model, batch)
        if isinstance(batch, (tuple, list)):
            return model.forward_kld(*batch)
        return model.forward_kld(batch)

    return make_forward_kld_step(opt, loss_fn=drawn_loss, with_key=True,
                                 post_update=post_update), short


def _check_draws(short, it):
    """Raise if a draw of the first ``it + 1`` iterations fell short (one
    host read)."""
    if short is not None and int(short):
        raise RuntimeError(
            f"{int(short)} of the first {it + 1} iterations' draws fell "
            f"short of their batch: the sampler's pool was sized from a "
            f"rate that overstated the acceptance")


def cosine_decay(lr, steps):
    """optax's ``cosine_decay_schedule(lr, steps)``: ``lr * (1 +
    cos(pi * min(it, steps) / steps)) / 2``."""
    def schedule(it):
        return lr * 0.5 * (1.0 + np.cos(np.pi * min(it, steps) / steps))
    return schedule


def plot_density(log_prob_fn, path, device, extent=(-3, 3, -3, 3), grid=200,
                 title=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs = np.linspace(extent[0], extent[1], grid)
    ys = np.linspace(extent[2], extent[3], grid)
    xx, yy = np.meshgrid(xs, ys)
    zz = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], 1),
                         dtype=torch.float32, device=device)
    with torch.no_grad():
        lp = log_prob_fn(zz).cpu().numpy().reshape(grid, grid)
    prob = np.exp(lp)
    prob[~np.isfinite(prob)] = 0.0
    plt.figure(figsize=(6, 6))
    plt.pcolormesh(xx, yy, prob, shading="auto")
    plt.gca().set_aspect("equal", "box")
    if title:
        plt.title(title)
    plt.savefig(path, dpi=120, bbox_inches="tight")
    plt.close()
    print("wrote", path)


def plot_hist2d(samples, path, extent=(-3, 3, -3, 3), bins=64, title=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s = samples.detach().cpu().numpy()
    plt.figure(figsize=(6, 6))
    plt.hist2d(s[:, 0], s[:, 1], bins=bins,
               range=[[extent[0], extent[1]], [extent[2], extent[3]]])
    plt.gca().set_aspect("equal", "box")
    if title:
        plt.title(title)
    plt.savefig(path, dpi=120, bbox_inches="tight")
    plt.close()
    print("wrote", path)
