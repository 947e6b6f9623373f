"""The reference paper's flagship example: circular autoregressive neural
spline flow fitting a Gauss-von Mises density on a cylinder, trained by
reverse KLD with 2^12-sample batches (reference
``examples/paper_example_nsf.ipynb`` cells 8-11 and ``paper/paper.md:98-106``),
on ``nf_tpu_torch``: on the card the splines run kernel A and their
backward kernel C.

The target lives on (phi, z) with phi circular: p(phi, z) proportional to a
von Mises in phi coupled to a Gaussian in z.
"""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import math

import torch
from torch import nn

import nf_tpu_torch as nt

from examples_torch._utils import (
    EVAL_STREAM,
    ReverseKLD,
    base_parser,
    cosine_decay,
    device_of,
    generator,
    out_path,
    plot_density,
    train,
)


class GaussVonMises(nn.Module):
    """Unnormalized Gauss-von Mises cylinder density (the in-notebook target
    of reference ``paper_example_nsf.ipynb`` cell 8)."""

    def __init__(self, loc_phi=0.0, conc=2.0, loc_z=0.0, scale_z=1.0,
                 corr=0.8):
        super().__init__()
        self.loc_phi = loc_phi
        self.conc = conc
        self.loc_z = loc_z
        self.scale_z = scale_z
        self.corr = corr

    def log_prob(self, x, context=None):
        phi, z = x[..., 0], x[..., 1]
        mu_z = self.loc_z + self.corr * torch.sin(phi - self.loc_phi)
        return (self.conc * torch.cos(phi - self.loc_phi)
                - 0.5 * ((z - mu_z) / self.scale_z) ** 2)


def parser():
    p = base_parser(__doc__, iters=2000, lr=5e-4, num_samples=2 ** 12)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--K", type=int, default=6)
    return p


def build_model(args, device):
    """``build_circular_nsf(dim=2, ind_circ=(0,), K=args.K,
    hidden=args.hidden, num_bins=10)`` on the Gauss-von Mises target."""
    return nt.build_circular_nsf(dim=2, ind_circ=(0,), K=args.K,
                                 hidden=args.hidden, num_bins=10,
                                 target=GaussVonMises(), device=device,
                                 seed=args.seed)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    model = build_model(args, dev)
    target = model.p

    model, hist = train(model, ReverseKLD(args.num_samples), args,
                        lr_schedule=cosine_decay(args.lr, args.iters))

    with torch.no_grad():
        z, _ = model.sample(8192, generator=generator(dev, args.seed,
                                                      EVAL_STREAM))
    print("phi in [-pi, pi]:",
          bool(torch.all(torch.abs(z[:, 0]) <= math.pi + 1e-4)))
    print("sample moments: mean", z.mean(0).cpu().numpy(),
          "std", z.std(0, correction=0).cpu().numpy())
    if args.plot:
        plot_density(model.log_prob, out_path("nsf_cylinder_model.png"), dev,
                     extent=(-math.pi, math.pi, -3, 3),
                     title="Circular NSF on cylinder")
        plot_density(target.log_prob, out_path("nsf_cylinder_target.png"),
                     dev, extent=(-math.pi, math.pi, -3, 3),
                     title="Gauss-von Mises target")
    return {"hist": hist}


if __name__ == "__main__":
    main()
