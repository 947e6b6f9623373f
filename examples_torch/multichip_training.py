"""Multi-device sharded training demo: data-parallel forward KLD and
sample-parallel reverse KLD over the ranks of a ``torch.distributed``
process group (one device each), sharded HAIS chains and a prefetched
sharded image pipeline, on ``nf_tpu_torch``.

Run as one process, the script brings up a one-rank group itself (NCCL on
the card, gloo with ``--device cpu``) and takes it down at the end:
    python examples_torch/multichip_training.py

PyTorch has no virtual device mesh: for N ranks, launch N processes with
the group's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``), for example
    torchrun --nproc_per_node 4 examples_torch/multichip_training.py \\
        --virtual-devices 4
``--virtual-devices N`` with N > 1 only checks that N ranks were launched.
"""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import argparse
import copy
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

import nf_tpu_torch as nt
from nf_tpu_torch.data import ArrayDataset, prefetch_to_device
from nf_tpu_torch.distributions import DiagGaussian
from nf_tpu_torch.parallel import (
    data_sharding,
    initialize_distributed,
    log_normalizer,
    make_sharded_sampler,
)
from nf_tpu_torch.parallel.mesh import world
from nf_tpu_torch.sampling import HAIS

from examples_torch._utils import (
    DATA_STREAM,
    EVAL_STREAM,
    TRAIN_STREAM,
    History,
    add_device,
    device_of,
    generator,
    optimizer,
    sync,
)


def parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--virtual-devices", type=int, default=0,
                   help="N ranks: N > 1 needs N launched processes "
                        "(WORLD_SIZE=N); torch has no virtual mesh")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--num-samples", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    return add_device(p)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_group(args, device):
    """Join the process group: from the environment when a launcher
    started the ranks, else a one-rank group on a free local port. Returns
    whether this call created it (and so must destroy it)."""
    launched = int(os.environ.get("WORLD_SIZE", "0"))
    if args.virtual_devices > 1 and launched != args.virtual_devices:
        raise SystemExit(
            f"--virtual-devices {args.virtual_devices}: torch has no virtual "
            f"device mesh; launch {args.virtual_devices} ranks, e.g. "
            f"torchrun --nproc_per_node {args.virtual_devices} "
            f"examples_torch/multichip_training.py --virtual-devices "
            f"{args.virtual_devices} (this process sees WORLD_SIZE="
            f"{launched or 'unset'})")
    if dist.is_initialized():
        return False
    platform = "cpu" if device.type == "cpu" else None
    if launched:
        initialize_distributed(platform=platform)
    else:
        initialize_distributed(coordinator_address=f"127.0.0.1:{_free_port()}",
                               num_processes=1, process_id=0,
                               platform=platform)
    return True


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    created = join_group(args, dev)
    try:
        return run(args)
    finally:
        if created:
            dist.destroy_process_group()


def run(args):
    rank, n = world()
    mesh = nt.make_mesh(("data",))
    dev = mesh.device

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    say(f"{n} devices: {dev.type}")
    model = nt.build_realnvp(dim=2, K=16, hidden=[64, 64],
                             target=nt.TwoModes(), device=dev,
                             seed=args.seed)
    # the data-parallel run below starts from the same weights
    initial = copy.deepcopy(model)

    # sample-parallel VI: each rank draws its own slice of the MC batch
    state = nt.init_train_state(model, optimizer(model, 1e-3))
    anneal = max(1, args.iters // 2)
    vi_step = nt.make_reverse_kld_step(
        state.optimizer, num_samples=args.num_samples,
        beta_schedule=lambda step: min(1.0, 0.01 + step / anneal), mesh=mesh)
    gen = generator(dev, args.seed, TRAIN_STREAM)
    vi = History(args.iters, dev)
    t0 = time.time()
    for it in range(args.iters):
        loss = vi_step(state, gen)
        vi.record(it, loss)
        if it % max(1, args.iters // 5) == 0:
            say(f"[reverse_kld] iter {it:5d} loss {float(loss):+.4f}")
    sync(dev)
    dt = vi.seconds = time.time() - t0
    say(f"sample-parallel VI: {args.iters} steps in {dt:.1f}s, "
        f"{args.iters * args.num_samples / dt:.0f} samples/s")

    # sharded sampling: HAIS chains split over the mesh
    hais = HAIS.create(np.linspace(1.0, 0.0, 17),
                       DiagGaussian(2, trainable=False), model.p,
                       num_leapfrog=5, step_size=[0.1, 0.1],
                       log_mass=[0.0, 0.0], device=dev)
    sampler = make_sharded_sampler(mesh, num_samples=args.num_samples)
    with torch.no_grad():
        z, log_w = sampler(hais, generator(dev, args.seed, EVAL_STREAM))
    log_z = float(log_normalizer(log_w, mesh))
    say(f"[hais] {args.num_samples} chains over {n} devices, "
        f"log Z = {log_z:+.3f}")

    # data-parallel MLE on rejection-sampled TwoMoons data: every rank
    # draws the same global batch and keeps its shard
    data_dist, data_gen = nt.TwoMoons(), generator(dev, args.seed,
                                                   DATA_STREAM)
    state2 = nt.init_train_state(initial, optimizer(initial, 1e-3))
    mle_step = nt.make_forward_kld_step(state2.optimizer, mesh=mesh)
    mle = History(args.iters // 2, dev)
    t0 = time.time()
    for it in range(args.iters // 2):
        x = nt.shard_batch(mesh, data_dist.sample(args.num_samples,
                                                  generator=data_gen))
        loss = mle_step(state2, x)
        mle.record(it, loss)
        if it % max(1, args.iters // 10) == 0:
            say(f"[forward_kld] iter {it:5d} loss {float(loss):+.4f}")
    sync(dev)
    mle.seconds = time.time() - t0

    # host data pipeline -> mesh: batches land pre-sharded over the data
    # axis via the background prefetch thread (nf_tpu_torch.data)
    rng = np.random.default_rng(args.seed)
    n_img = 8 * max(1, n)
    x_all = rng.random((n_img * 4, 3, 8, 8), np.float32) * 0.98 + 0.01
    ds = ArrayDataset(x_all, batch_size=n_img, shuffle=True)
    img_model = nt.build_image_nsf(input_shape=(3, 8, 8), L=1, K=2,
                                   hidden_channels=16, device=dev, seed=1)
    img_model.init_from_data(torch.as_tensor(next(iter(ds))).to(dev))
    state3 = nt.init_train_state(img_model, optimizer(img_model, 1e-3))
    img_step = nt.make_forward_kld_step(state3.optimizer, mesh=mesh)
    img = History(2 * len(ds), dev)
    steps = 0
    t0 = time.time()
    for batch in prefetch_to_device(ds.epochs(2), size=2,
                                    sharding=data_sharding(mesh, 4)):
        loss = img_step(state3, batch)
        img.record(steps, loss)
        steps += 1
    sync(dev)
    img.seconds = time.time() - t0
    say(f"[pipeline] {steps} prefetched sharded image batches, "
        f"last loss {float(loss):.1f}")
    say("done")
    return {"hist": {"reverse_kld": vi, "forward_kld": mle,
                     "pipeline": img}}


if __name__ == "__main__":
    main()
