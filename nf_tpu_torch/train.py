"""Training binary: ``python -m nf_tpu_torch.train --model nsf --target
two_moons`` (``nf_tpu/train.py``).

Ties the infrastructure together: the flag/config system
(:class:`~nf_tpu_torch.utils.config.TrainConfig`, the JAX package's
flags), the steps (one CUDA graph each on the card), sharded over the
ranks of a ``torch.distributed`` process group under ``--distributed``,
checkpoints and resumption, JSONL metric logging. The 2D models train on
a target's samples (``--loss forward_kld``) or against its density
(``reverse_kld``); ``--model glow|image_nsf`` trains the image stack on
procedural images or an ``.npz`` (``--data``).

It runs on CUDA: :func:`main` and :func:`train_image` take
``device=None`` for ``cuda`` (raising if it is absent) and
``device="cpu"`` for the plain PyTorch path. Under ``--distributed`` the
process joins the group from the environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): NCCL on
``cuda:{LOCAL_RANK}``, gloo on the CPU. Every rank draws the same global
batch from the same seed and trains on its slice; rank 0 prints, logs
and writes the checkpoints.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch
import torch.distributed as dist

from . import models
from ._device import resolve_device
from .distributions import (
    CircularGaussianMixture,
    RingMixture,
    TwoModes,
    TwoMoons,
)
from .parallel import (
    init_train_state,
    make_forward_kld_step,
    make_mesh,
    make_reverse_kld_step,
    shard_batch,
)
from .parallel.mesh import world
from .parallel.train import ema_model, reshape_for_accum
from .utils import CheckpointManager, MetricLogger
from .utils.config import TrainConfig

TARGETS = {
    "two_modes": TwoModes,
    "two_moons": TwoMoons,
    "circular_gmm": CircularGaussianMixture,
    "rings": RingMixture,
}


def build_model(cfg: TrainConfig, device=None):
    """The 2D model of ``cfg`` with its target, weights from ``cfg.seed``
    on ``device`` (None: CUDA)."""
    target = TARGETS[cfg.target]()
    mp = cfg.bf16  # bf16 conditioner compute, f32 params + flow math
    if mp and cfg.model == "residual":
        raise SystemExit(
            "--bf16 does not cover --model residual: spectral-norm power "
            "iteration needs f32 to certify the Lipschitz bound")
    kw = dict(dim=cfg.dim, K=cfg.num_layers, target=target, device=device,
              seed=cfg.seed)
    if cfg.model == "realnvp":
        return models.build_realnvp(hidden=[cfg.hidden, cfg.hidden],
                                    mixed_precision=mp, **kw)
    if cfg.model == "nsf":
        return models.build_nsf(hidden=cfg.hidden, num_bins=cfg.num_bins,
                                mixed_precision=mp, **kw)
    if cfg.model == "circular_nsf":
        return models.build_circular_nsf(hidden=cfg.hidden,
                                         num_bins=cfg.num_bins,
                                         mixed_precision=mp, **kw)
    if cfg.model == "maf":
        return models.build_maf(hidden=cfg.hidden, mixed_precision=mp, **kw)
    if cfg.model == "residual":
        return models.build_residual(hidden=cfg.hidden, **kw)
    raise ValueError(f"unknown model {cfg.model!r}")


def _optimizer(cfg, model, device):
    """Adam, or AdamW with ``--weight_decay``; on CUDA its state lives on
    the card (``capturable``), as a captured step needs."""
    kw = dict(lr=cfg.lr, capturable=device.type == "cuda")
    if cfg.weight_decay:
        return torch.optim.AdamW(model.parameters(),
                                 weight_decay=cfg.weight_decay, **kw)
    return torch.optim.Adam(model.parameters(), **kw)


def _mesh(device):
    """The 1-D ``data`` mesh over the process group's ranks, or the one
    device."""
    grouped = dist.is_available() and dist.is_initialized()
    mesh = make_mesh(("data",), devices=None if grouped else [device])
    if mesh.device.type != device.type:
        raise ValueError(f"the process group drives {mesh.device}, the run "
                         f"asks for {device}")
    return mesh


def _restore(cfg, state, generator=None):
    """The checkpoint manager (None without ``--checkpoint_dir``) and the
    step to start from, the latest checkpoint restored into ``state`` (and
    ``generator``) in place, before the step's first call."""
    if not cfg.checkpoint_dir:
        return None, 0
    ckpt = CheckpointManager(cfg.checkpoint_dir)
    restored, step = ckpt.restore(state, generator=generator)
    if restored is None:
        return ckpt, 0
    if world()[0] == 0:
        print(f"resumed from step {step}", flush=True)
    return ckpt, int(step)


class _Run:
    """The binary's step: ``run(state, *args) -> loss``, ``launches`` the
    kernel launches of one replay of its captured step; ``draw()`` the
    forward-KLD step's draw of its global batch (None: the step draws
    nothing on the host's side)."""

    def __init__(self, fn, step, draw=None):
        self.fn = fn
        self.step = step
        self.draw = draw

    def __call__(self, state, *args):
        return self.fn(state, *args)

    @property
    def launches(self):
        return self.step.launches


def _loop(cfg, state, run, ckpt, start_step, log, generator=None):
    """Steps ``start_step .. cfg.iters - 1``: a log line every
    ``log_every`` steps and at the last, a checkpoint every
    ``checkpoint_every`` steps, written while the next steps run, and one
    at the end, waited for (rank 0 writes them)."""
    is_main = world()[0] == 0
    logger = MetricLogger(cfg.log_path) if cfg.log_path and is_main \
        else None
    t0 = time.time()
    try:
        for it in range(start_step, cfg.iters):
            loss = run(state, it)
            if it % cfg.log_every == 0 or it == cfg.iters - 1:
                loss_f = float(loss)
                rate = (it - start_step + 1) / (time.time() - t0)
                log(it, loss_f, rate, logger)
            if (ckpt is not None and is_main
                    and (it + 1) % cfg.checkpoint_every == 0):
                # the write overlaps the next steps (nf_tpu/train.py:209)
                ckpt.save(it + 1, state, generator=generator, wait=False)
        if ckpt is not None and is_main:
            ckpt.save(cfg.iters, state, generator=generator)
            ckpt.wait_until_finished()
    finally:
        if logger is not None:
            logger.close()
    if is_main:
        print(f"done: {cfg.iters - start_step} steps in "
              f"{time.time() - t0:.1f}s", flush=True)
    return state


def train_image(cfg: TrainConfig, device=None):
    """The image path of the binary: Glow or the image NSF on an ``.npz``
    or procedural images, dequantised (``Scale``, ``Jitter``), with
    bits/dim on a held-out tenth, with and without the EMA
    (``nf_tpu/train.py:73``). Returns the final ``TrainState``."""
    from .data import load_npz_images, procedural_image_classes
    from .utils.eval import bits_per_dim
    from .utils.preprocessing import Jitter, Scale

    dev = resolve_device(device)
    mesh = _mesh(dev)
    dev = mesh.device
    is_main = world()[0] == 0
    if is_main:
        print(f"mesh: {mesh.shape} on {dev} ({world()[1]} process(es))")

    if cfg.data:
        # raw uint8 -> /255 here; Scale(255/256) and Jitter follow in
        # host_batch and eval (load_npz_images' own /256 would apply the
        # Scale twice)
        loaded = load_npz_images(cfg.data, to_unit_interval=False)
        x_all, y_all = loaded if isinstance(loaded, tuple) \
            else (loaded, np.zeros(len(loaded), np.int32))
        x_all = np.asarray(x_all)
        if x_all.dtype == np.uint8:
            x_all = x_all.astype(np.float32) / 255.0
    else:
        x_u8, y_all = procedural_image_classes(cfg.seed, 2048,
                                               size=cfg.image_size)
        x_all = x_u8.astype(np.float32) / 255.0
    n, input_shape = len(x_all), x_all.shape[1:]
    # a seeded shuffle before the split: npz files are often sorted by
    # class, which would make the held-out tail one class
    perm = np.random.default_rng(cfg.seed + 3).permutation(n)
    x_all, y_all = x_all[perm], np.asarray(y_all)[perm]
    n_train = max(int(n * 0.9), 1)
    x_train, y_train = x_all[:n_train], y_all[:n_train]
    x_test, y_test = x_all[n_train:], y_all[n_train:]
    if is_main:
        print(f"data: {n_train} train / {len(x_test)} test, "
              f"shape {input_shape}")

    scale, jitter = Scale(), Jitter()
    noise = torch.Generator(device=dev)

    def host_batch(rng):
        idx = rng.integers(0, n_train, size=cfg.batch_size)
        x = scale(torch.as_tensor(x_train[idx]).to(dev))
        x = jitter(x, noise.manual_seed(int(rng.integers(1 << 31))))
        return x, torch.as_tensor(y_train[idx]).to(dev)

    kw = dict(input_shape=tuple(input_shape), L=cfg.levels,
              K=cfg.num_layers, hidden_channels=cfg.hidden,
              class_cond=cfg.class_cond, mixed_precision=cfg.bf16,
              device=dev, seed=cfg.seed)
    if cfg.model == "glow":
        model = models.build_glow_multiscale(scan=cfg.scan, **kw)
    else:
        model = models.build_image_nsf(num_bins=cfg.num_bins, **kw)

    x0, y0 = host_batch(np.random.default_rng(cfg.seed + 1))
    model.init_from_data(x0, y0 if cfg.class_cond else None)

    use_ema = cfg.ema_decay > 0
    state = init_train_state(model, _optimizer(cfg, model, dev),
                             with_ema=use_ema)
    ckpt, start_step = _restore(cfg, state)
    # re-key the host data and jitter stream on the resume step, so a
    # resumed run draws fresh batches instead of replaying those trained
    # on (the 2D path continues its generator)
    rng = np.random.default_rng([cfg.seed + 1, start_step])

    step_fn = make_forward_kld_step(
        state.optimizer, mesh=mesh, accum_steps=cfg.accum_steps,
        ema_decay=cfg.ema_decay if use_ema else None,
        skip_nonfinite=cfg.skip_nonfinite)

    def eval_bpd(m):
        if not len(x_test):
            return float("nan")
        xt = scale(torch.as_tensor(x_test).to(dev))
        xt = jitter(xt, noise.manual_seed(cfg.seed + 2))
        with torch.no_grad():
            b = bits_per_dim(m, xt, torch.as_tensor(y_test).to(dev)
                             if cfg.class_cond else None)
        return float(torch.nanmean(b))

    def step(state, it):
        batch = host_batch(rng)
        batch = batch if cfg.class_cond else batch[0]
        # every rank drew the same global batch; it keeps its shard
        return step_fn(state, _shard_host_batch(mesh, batch, cfg))

    def log(it, loss_f, rate, logger):
        bpd = eval_bpd(state.model)
        extra, ema_txt = {}, ""
        if use_ema:
            extra["bits_per_dim_ema"] = eval_bpd(ema_model(state))
            ema_txt = f"  ema bits/dim {extra['bits_per_dim_ema']:.4f}"
        if world()[0] == 0:
            print(f"step {it:7d}  loss {loss_f:+.1f}  bits/dim {bpd:.4f}"
                  f"{ema_txt}  {rate:.1f} it/s", flush=True)
            if logger is not None:
                logger.log(it, loss=loss_f, bits_per_dim=bpd, it_per_s=rate,
                           **extra)

    state.run_step = _Run(step, step_fn)
    return _loop(cfg, state, state.run_step, ckpt, start_step, log)


def _init_distributed(cfg: TrainConfig, device):
    """Join the process group under ``--distributed`` (NCCL on CUDA, gloo
    on the CPU; from the environment). Returns True on the printing
    rank."""
    if cfg.distributed:
        from .parallel.multihost import initialize_distributed

        initialize_distributed(platform="cpu" if device.type == "cpu"
                               else None)
    return world()[0] == 0


def _shard_host_batch(mesh, batch, cfg):
    """This rank's shard of a global batch that every rank drew alike,
    microbatched under ``--accum_steps`` (the micro dim sharded)."""
    accum = cfg.accum_steps > 1
    if accum:
        batch = reshape_for_accum(batch, cfg.accum_steps)
    return shard_batch(mesh, batch, accum=accum)


def _keyed_seed(seed, it):
    """Step ``it``'s integer seed for a keyed step, the same on every rank
    and in a resumed run."""
    return int(np.random.SeedSequence([seed, it]).generate_state(1)[0])


def main(argv=None, device=None):
    """Parse ``argv`` (None: ``sys.argv``), train and return the final
    ``TrainState``; its ``run_step`` is the binary's step (``launches``:
    the kernels one replay of its captured step launches). ``device``
    None is ``cuda``."""
    cfg = TrainConfig.from_args(argv)
    dev = resolve_device(device)
    is_main = _init_distributed(cfg, dev)
    if is_main:
        print(cfg.to_json())
    if cfg.model in ("glow", "image_nsf"):
        return train_image(cfg, dev)
    mesh = _mesh(dev)
    dev = mesh.device
    if is_main:
        print(f"mesh: {mesh.shape} on {dev} ({world()[1]} process(es))")

    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    model = build_model(cfg, dev)
    if cfg.loss == "reverse_kld":
        model.init_from_samples(min(cfg.num_samples, 1024), generator=gen)
        draw = None
    else:
        # ActNorm's data-dependent init from a target batch (the density
        # direction)
        x0 = model.p.sample(min(cfg.batch_size, 1024), generator=gen)
        model.init_from_data(x0, generator=gen)
        draw = functools.partial(model.p.sample, cfg.batch_size,
                                 generator=gen)

    is_residual = cfg.model == "residual"
    use_ema = cfg.ema_decay > 0
    state = init_train_state(model, _optimizer(cfg, model, dev),
                             carry_buffers=is_residual, with_ema=use_ema)
    # the generator's state is part of the checkpoint: a resumed run
    # continues the stream the interrupted one drew from
    ckpt, start_step = _restore(cfg, state, generator=gen)

    post = None
    if is_residual:
        from .utils.optim import update_lipschitz

        def post(m):
            return update_lipschitz(m, 50)

    common = dict(post_update=post, accum_steps=cfg.accum_steps,
                  ema_decay=cfg.ema_decay if use_ema else None,
                  skip_nonfinite=cfg.skip_nonfinite, mesh=mesh)
    if cfg.loss == "reverse_kld":
        anneal = cfg.beta_anneal_iters

        def beta(s):
            return min(1.0, 0.01 + s / anneal) if anneal else 1.0

        step_fn = make_reverse_kld_step(
            state.optimizer, num_samples=cfg.num_samples,
            beta_schedule=beta, **common)

        def run(state, it):
            return step_fn(state, gen)
    else:
        step_fn = make_forward_kld_step(state.optimizer,
                                        with_key=is_residual, **common)

        def run(state, it):
            # every rank draws the same global batch from the same
            # generator and keeps its shard
            x = _shard_host_batch(mesh, draw(), cfg)
            if is_residual:
                return step_fn(state, x, _keyed_seed(cfg.seed, it))
            return step_fn(state, x)

    def log(it, loss_f, rate, logger):
        if is_main:
            print(f"step {it:7d}  loss {loss_f:+.4f}  {rate:.1f} it/s",
                  flush=True)
            if logger is not None:
                logger.log(it, loss=loss_f, it_per_s=rate)

    state.run_step = _Run(run, step_fn, draw)
    return _loop(cfg, state, state.run_step, ckpt, start_step, log,
                 generator=gen)


if __name__ == "__main__":
    main()
