"""Normalizing-flow VAE: flow-transformed approximate posterior over a
binarized image dataset (reference ``examples/vae.py`` /
``examples/vae.ipynb``: MNIST, NNDiagGaussian encoder, Planar/RealNVP
posterior flows, Bernoulli decoder, IWAE-style bound), on
``nf_tpu_torch``: the step is keyed (the encoder's draws come from the
step's own generator, reseeded every iteration).

Data: pass ``--data path.npz`` with array ``x`` (N, 784) in [0,1]; without
it a procedural multi-blob dataset is used (zero-download environment).
"""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import math
import time

import numpy as np
import torch

import nf_tpu_torch as nt
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.distributions import (
    DiagGaussian,
    NNBernoulliDecoder,
    NNDiagGaussian,
)
from nf_tpu_torch.nets import MLP

from examples_torch._utils import (
    DATA_STREAM,
    EVAL_STREAM,
    History,
    base_parser,
    device_of,
    generator,
    keyed_seed,
    log_every,
    optimizer,
    sync,
)


def procedural_digits(gen, n=4096, side=28):
    """Blob 'digits': a Gaussian bump at a class-dependent position and
    uniform noise, ``(n, side * side)`` in [0, 1] on the generator's
    device."""
    dev = gen.device
    cls = torch.randint(0, 10, (n,), generator=gen, device=dev)
    grid = torch.arange(side, device=dev, dtype=torch.float32) / side
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    cx = (0.25 + 0.5 * (cls % 3) / 2.0)[:, None, None]
    cy = (0.25 + 0.5 * (cls // 3) / 3.0)[:, None, None]
    img = torch.exp(-(((xx[None] - cx) ** 2 + (yy[None] - cy) ** 2) / 0.02))
    noise = torch.rand(img.shape, generator=gen, device=dev)
    return torch.clamp(img + 0.05 * noise, 0, 1).reshape(n, -1)


def parser():
    p = base_parser(__doc__, iters=1000, lr=1e-3, num_samples=1)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--latent", type=int, default=16)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--flows", type=int, default=4,
                   help="number of posterior RealNVP layers (0 = plain VAE)")
    return p


def build_model(d_in, latent, n_flows, seed):
    gen = torch.Generator().manual_seed(seed)
    L = latent
    q0 = NNDiagGaussian(MLP([d_in, 256, 256, 2 * L], generator=gen))
    decoder = NNBernoulliDecoder(MLP([L, 256, 256, d_in], generator=gen))
    flows = []
    for i in range(n_flows):
        b = torch.tensor([1.0] * (L // 2) + [0.0] * (L - L // 2))
        b = b if i % 2 == 0 else 1.0 - b
        s = MLP([L, 128, L], init_zeros=True, generator=gen)
        t = MLP([L, 128, L], init_zeros=True, generator=gen)
        flows.append(tflows.MaskedAffineFlow(b, t=t, s=s))
    return nt.NormalizingFlowVAE(DiagGaussian(L, trainable=False), q0,
                                 flows=flows, decoder=decoder)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    gen = generator(dev, args.seed, DATA_STREAM)
    if args.data:
        x_all = torch.as_tensor(np.load(args.data)["x"],
                                dtype=torch.float32).to(dev)
    else:
        x_all = procedural_digits(gen)
    n, d_in = x_all.shape
    model = build_model(d_in, args.latent, args.flows, args.seed).to(dev)

    def negative_elbo(model, x, generator):
        _, log_q, log_p = model(x, num_samples=args.num_samples,
                                generator=generator)
        return torch.mean(log_q - log_p)

    state = nt.init_train_state(model, optimizer(model, args.lr))
    step = nt.make_forward_kld_step(state.optimizer, loss_fn=negative_elbo,
                                    with_key=True)
    every = log_every(args)
    hist = History(args.iters, dev)
    t0 = time.time()
    for it in range(args.iters):
        idx = torch.randint(0, n, (args.batch,), generator=gen, device=dev)
        loss = step(state, x_all[idx], keyed_seed(args.seed, it))
        hist.record(it, loss)
        if it % every == 0 or it == args.iters - 1:
            print(f"iter {it:6d}  -ELBO {float(loss):.4f}", flush=True)
    sync(dev)
    hist.seconds = time.time() - t0

    # IWAE-style bound with more posterior samples
    with torch.no_grad():
        _, log_q, log_p = model(x_all[:512], num_samples=16,
                                generator=generator(dev, args.seed,
                                                    EVAL_STREAM))
    iwae = float(torch.mean(torch.logsumexp(log_p - log_q, dim=1)
                            - math.log(16)))
    print("IWAE-16 bound:", iwae)
    return {"hist": hist}


if __name__ == "__main__":
    main()
