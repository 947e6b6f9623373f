"""Stochastic normalizing flow: deterministic coupling layers interleaved
with Hamiltonian Monte Carlo layers targeting annealed interpolations
between base and target (Wu et al. 2020; reference layers
``normflows/flows/stochastic.py`` — the reference ships no SNF example),
on ``nf_tpu_torch``.

The MCMC layers contribute log-ratio weights to log_q, so reverse-KLD
training and sampling work through the standard NormalizingFlow API, every
layer drawing from the step's generator.
"""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import numpy as np
import torch

import nf_tpu_torch as nt
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.distributions import DiagGaussian, LinearInterpolation
from nf_tpu_torch.nets import MLP
from nf_tpu_torch.utils.masks import create_alternating_binary_mask

from examples_torch._utils import (
    EVAL_STREAM,
    ReverseKLD,
    base_parser,
    device_of,
    generator,
    out_path,
    plot_hist2d,
    train,
)


def build_snf(seed, dim=2, K=4, hidden=64, mcmc_every=2, hmc_leapfrog=5,
              target=None):
    base = DiagGaussian(dim, trainable=False)
    gen = torch.Generator().manual_seed(seed)
    flows = []
    for i in range(K):
        b = create_alternating_binary_mask(dim, even=(i % 2 == 0))
        s = MLP([dim, hidden, hidden, dim], init_zeros=True, generator=gen)
        t = MLP([dim, hidden, hidden, dim], init_zeros=True, generator=gen)
        flows.append(tflows.MaskedAffineFlow(b, t=t, s=s))
        flows.append(tflows.ActNorm(dim))
        if (i + 1) % mcmc_every == 0:
            # anneal toward the target as depth increases
            alpha = (i + 1) / K
            intermediate = LinearInterpolation(target, base, alpha=alpha)
            flows.append(tflows.HamiltonianMonteCarlo(
                intermediate, hmc_leapfrog, np.log(np.full(dim, 0.2)),
                np.zeros(dim)))
    return nt.NormalizingFlow(base, flows, p=target)


def parser():
    return base_parser(__doc__, iters=1500, lr=2e-3, num_samples=1024)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    model = build_snf(args.seed, target=nt.TwoModes()).to(dev)
    gen = generator(dev, args.seed, EVAL_STREAM)
    model.init_from_samples(512, generator=gen)
    anneal = max(1, args.iters // 2)

    def beta(it):
        return min(1.0, 0.05 + it / anneal)

    model, hist = train(model, ReverseKLD(args.num_samples, beta), args)

    with torch.no_grad():
        z, log_q, acceptance = model.sample_with_mcmc_stats(8192,
                                                            generator=gen)
    r = torch.linalg.norm(z, dim=-1)
    print("sample mean |z| (TwoModes ring radius ~2):", float(torch.mean(r)))
    # per-HMC-layer acceptance: each entry is the layer's MH-correction
    # acceptance rate over the 8192 chains
    rates = [float(a.mean()) for a in acceptance]
    print("HMC layer acceptance rates:",
          ", ".join(f"{r_:.3f}" for r_ in rates))
    with open(out_path("snf_acceptance.csv"), "w") as f:
        f.write("mcmc_layer,acceptance\n")
        f.writelines(f"{i},{a:.6f}\n" for i, a in enumerate(rates))
    if args.plot:
        plot_hist2d(z, out_path("snf_samples.png"),
                    title="SNF samples (coupling + HMC layers)")
    return {"hist": hist}


if __name__ == "__main__":
    main()
