"""Hamiltonian annealed importance sampling from a 2D target, with the
effective sample size of the importance weights as the quality metric
(reference ``normflows/sampling/hais.py`` — the reference ships no
notebook for HAIS; this script is its driver), on ``nf_tpu_torch``."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import argparse
import math

import numpy as np
import torch

import nf_tpu_torch as nt
from nf_tpu_torch.distributions import DiagGaussian
from nf_tpu_torch.sampling import HAIS
from nf_tpu_torch.utils import effective_sample_size

from examples_torch._utils import (
    EVAL_STREAM,
    add_device,
    device_of,
    generator,
    out_path,
    plot_hist2d,
)


def parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num-samples", type=int, default=4096)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--leapfrog", type=int, default=5)
    p.add_argument("--step-size", type=float, default=0.12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--plot", action="store_true")
    return add_device(p)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    betas = np.linspace(1.0, 0.0, args.steps + 1)
    hais = HAIS.create(betas, DiagGaussian(2, trainable=False), nt.TwoModes(),
                       num_leapfrog=args.leapfrog,
                       step_size=[args.step_size] * 2, log_mass=[0.0] * 2,
                       device=dev)

    with torch.no_grad():
        samples, log_w, acceptance = hais.sample_with_stats(
            args.num_samples, generator=generator(dev, args.seed,
                                                  EVAL_STREAM))
    ess = float(effective_sample_size(log_w))
    w = torch.exp(log_w - torch.max(log_w))
    w = w / torch.sum(w)
    mean = torch.sum(w[:, None] * samples, dim=0)
    print(f"ESS: {ess:.1f} / {args.num_samples} "
          f"({100 * ess / args.num_samples:.1f}%)")
    print("weighted mean:", mean.cpu().numpy())
    log_z = float(torch.logsumexp(log_w, dim=0) - math.log(args.num_samples))
    print("log Z estimate:", log_z)
    acceptance = acceptance.cpu().numpy()
    print(f"HMC acceptance over the {len(acceptance)} annealing layers: "
          f"mean {acceptance.mean():.3f}, "
          f"min {acceptance.min():.3f} (layer {int(acceptance.argmin())}), "
          f"max {acceptance.max():.3f}")
    # acceptance curve along the annealing schedule
    with open(out_path("hais_acceptance.csv"), "w") as f:
        f.write("layer,acceptance\n")
        f.writelines(f"{i},{a:.6f}\n" for i, a in enumerate(acceptance))
    if args.plot:
        plot_hist2d(samples, out_path("hais_samples.png"),
                    title="HAIS samples (unweighted)")
    return {"log_z": log_z, "ess": ess}


if __name__ == "__main__":
    main()
