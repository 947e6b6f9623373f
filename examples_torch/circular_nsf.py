"""Mixed circular/unbounded neural spline flow trained by forward KLD on
samples from a mixed target (reference ``examples/circular_nsf.ipynb``),
on ``nf_tpu_torch``: on the card the autoregressive splines run kernel A
and their backward kernel C."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import math

import torch

import nf_tpu_torch as nt

from examples_torch._utils import (
    EVAL_STREAM,
    ForwardKLD,
    base_parser,
    device_of,
    generator,
    out_path,
    plot_hist2d,
    train,
)


def sample_target(gen, n):
    """The reference notebook's mixed target: bimodal Gaussian in dim 0,
    skewed circular density in dim 1 (``circular_nsf.ipynb`` cell 4),
    drawn on the generator's device."""
    dev = gen.device
    s = torch.randn((n, 2), generator=gen, device=dev)
    c = torch.rand((n, 2), generator=gen, device=dev) > 0.6
    s = torch.where(c, 0.3 * s - 0.5, s + 1.3)
    u = torch.rand((n, 1), generator=gen, device=dev)
    s_ = torch.arccos(2 * u - 1)
    flip = torch.rand((n, 1), generator=gen, device=dev) > 0.3
    s_ = torch.where(flip, -s_, s_)
    phi = torch.remainder(s_ + 1, 2 * math.pi) - math.pi
    return torch.cat([s[:, :1], phi], dim=1)


def parser():
    return base_parser(__doc__, iters=2000, lr=3e-3, num_samples=1024)


def build_model(args, device):
    """``build_circular_nsf(dim=2, ind_circ=(1,), K=6, hidden=64,
    num_bins=8)``."""
    return nt.build_circular_nsf(dim=2, ind_circ=(1,), K=6, hidden=64,
                                 num_bins=8, device=device, seed=args.seed)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    model = build_model(args, dev)

    def draw(gen):
        return sample_target(gen, args.num_samples), None

    model, hist = train(model, ForwardKLD(draw=draw), args)
    gen = generator(dev, args.seed, EVAL_STREAM)
    with torch.no_grad():
        z, _ = model.sample(8192, generator=gen)
    print("circular coord bounded:",
          bool(torch.all(torch.abs(z[:, 1]) <= math.pi + 1e-4)))
    if args.plot:
        plot_hist2d(z, out_path("circular_nsf_model.png"),
                    extent=(-3, 3, -math.pi, math.pi), title="model samples")
        plot_hist2d(sample_target(gen, 8192),
                    out_path("circular_nsf_target.png"),
                    extent=(-3, 3, -math.pi, math.pi), title="target samples")
    return {"hist": hist}


if __name__ == "__main__":
    main()
