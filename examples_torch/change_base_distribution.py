"""Changing the base distribution: fit TwoMoons with (a) a standard
Gaussian base and (b) a trainable Gaussian-mixture base, which resolves the
topology mismatch (reference ``examples/change_base_distribution.ipynb``),
on ``nf_tpu_torch``."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import torch

import nf_tpu_torch as nt
from nf_tpu_torch import flows as tflows
from nf_tpu_torch.distributions import DiagGaussian, GaussianMixture
from nf_tpu_torch.nets import MLP

from examples_torch._utils import (
    ForwardKLD,
    base_parser,
    device_of,
    out_path,
    plot_density,
    train,
)


def build(q0, seed, K=8):
    """K x [``AffineCouplingBlock`` over ``MLP [1, 64, 64, 2]`` (zero-init
    last layer), swap ``Permute``] over ``q0``, target TwoMoons."""
    gen = torch.Generator().manual_seed(seed)
    flows = []
    for _ in range(K):
        param_map = MLP([1, 64, 64, 2], init_zeros=True, generator=gen)
        flows.append(tflows.AffineCouplingBlock(param_map))
        flows.append(tflows.Permute(2, mode="swap"))
    return nt.NormalizingFlow(q0, flows, p=nt.TwoMoons())


def parser():
    p = base_parser(__doc__, iters=2000, lr=3e-3, num_samples=512)
    p.add_argument("--base", choices=["gauss", "gmm"], default="gmm")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    if args.base == "gmm":
        q0 = GaussianMixture(n_modes=2, dim=2, loc=[[-1.0, 0.0], [1.0, 0.0]])
    else:
        q0 = DiagGaussian(2, trainable=True)
    model = build(q0, args.seed).to(dev)

    def batch(gen, it):
        return model.p.sample(args.num_samples, generator=gen)

    model, hist = train(model, ForwardKLD(batch), args)
    if args.plot:
        plot_density(model.log_prob,
                     out_path(f"base_{args.base}_model.png"), dev,
                     title=f"TwoMoons fit, base={args.base}")
    return {"hist": hist}


if __name__ == "__main__":
    main()
