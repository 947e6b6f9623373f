"""Residual flow (iResBlocks with Lipschitz-constrained MLPs) fitting the
two-moons dataset by forward KLD, with spectral-norm power iteration after
every step (reference ``examples/residual.ipynb``: K=16 blocks, [2,128,128,2]
Lipschitz MLP, L=0.9, Adam 3e-4 + wd 1e-5, ``update_lipschitz(50)`` per
step, 20k iters — pass ``--iters 20000`` for the full recipe), on
``nf_tpu_torch``: the step is keyed (the log-det's probes and series
length drawn from the step's own generator, reseeded every iteration)."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import math

import torch

import nf_tpu_torch as nt
from nf_tpu_torch.flows import set_exact_logdet
from nf_tpu_torch.utils.optim import update_lipschitz

from examples_torch._utils import (
    EVAL_STREAM,
    ForwardKLD,
    base_parser,
    device_of,
    generator,
    out_path,
    plot_density,
    train,
)


def make_moons(gen, n, noise=0.1):
    """sklearn.datasets.make_moons semantics (outer circle + inner
    half-circle shifted by (1, 0.5)), drawn on the generator's device."""
    dev = gen.device
    t = torch.rand(n, generator=gen, device=dev) * math.pi
    upper = torch.rand(n, generator=gen, device=dev) < 0.5
    x = torch.where(upper, torch.cos(t), 1.0 - torch.cos(t))
    y = torch.where(upper, torch.sin(t), 0.5 - torch.sin(t))
    return (torch.stack([x, y], dim=1)
            + noise * torch.randn((n, 2), generator=gen, device=dev))


def parser():
    p = base_parser(__doc__, iters=3000, lr=3e-4, num_samples=512)
    p.add_argument("--K", type=int, default=16)
    p.add_argument("--hidden", type=int, default=128)
    return p


def forward_kld(model, x, generator):
    return model.forward_kld(x, generator=generator)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    model = nt.build_residual(K=args.K, hidden=args.hidden,
                              n_hidden_layers=2, device=dev, seed=args.seed)
    gen = generator(dev, args.seed, EVAL_STREAM)
    model.init_from_data(make_moons(gen, 512), generator=gen)

    def batch(g, it):
        return make_moons(g, args.num_samples)

    model, hist = train(model, ForwardKLD(batch, forward_kld, keyed=True),
                        args, weight_decay=1e-5,
                        post_update=lambda m: update_lipschitz(m, 50))

    # eval with the exact 2D Jacobian log-det (the reference's eval-mode
    # behavior) instead of the noisy stochastic estimator
    eval_model = set_exact_logdet(model)
    x = make_moons(gen, 2048)
    with torch.no_grad():
        kld = float(eval_model.forward_kld(x, generator=gen))
    print("final forward KLD (exact log-det):", kld)
    if args.plot:
        plot_density(lambda z: eval_model.log_prob(z),
                     out_path("residual_model.png"), dev,
                     extent=(-1.5, 2.5, -1.5, 2.0),
                     title="Residual flow fit of two moons")
    return {"hist": hist}


if __name__ == "__main__":
    main()
