"""Neural spline flows (coupled and autoregressive RQS) fitting TwoMoons
by forward KLD on target samples (reference
``examples/neural_spline_flow.ipynb``), on ``nf_tpu_torch``: on the card
the splines run kernel A and their backward kernel C."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import torch

import nf_tpu_torch as nt
from nf_tpu_torch import distributions as tdist
from nf_tpu_torch import flows as tflows

from examples_torch._utils import (
    ForwardKLD,
    base_parser,
    device_of,
    out_path,
    plot_density,
    target_draw,
    train,
)


def parser():
    p = base_parser(__doc__, iters=2000, lr=3e-3, num_samples=512)
    p.add_argument("--autoregressive", action="store_true")
    return p


def build_model(args, device):
    """The JAX script's model: ``build_nsf(dim=2, K=4, hidden=64,
    num_bins=8)``, or 4 x [autoregressive RQ spline (MADE of 2 blocks of
    64), ``LULinearPermute``] over a fixed ``DiagGaussian``; TwoMoons as
    the target, weights from ``args.seed``."""
    target = nt.TwoMoons()
    if not args.autoregressive:
        return nt.build_nsf(dim=2, K=4, hidden=64, num_bins=8, target=target,
                            device=device, seed=args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    flows = []
    for _ in range(4):
        flows.append(tflows.AutoregressiveRationalQuadraticSpline(
            num_input_channels=2, num_blocks=2, num_hidden_channels=64,
            num_bins=8, generator=gen))
        flows.append(tflows.LULinearPermute(2, generator=gen))
    return nt.NormalizingFlow(tdist.DiagGaussian(2, trainable=False), flows,
                              p=target).to(device)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    model = build_model(args, dev)

    draw = target_draw(model.p, args, dev)
    model, hist = train(model, ForwardKLD(draw=draw), args)
    if args.plot:
        kind = "ar" if args.autoregressive else "coupled"
        plot_density(model.log_prob, out_path(f"nsf_{kind}_model.png"), dev,
                     title=f"NSF ({kind}) fit of TwoMoons")
    return {"hist": hist}


if __name__ == "__main__":
    main()
