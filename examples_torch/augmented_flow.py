"""Augmented normalizing flow: Real NVP over (x, a) with a TwoIndependent
target (data density times standard-normal auxiliary), trained by annealed
reverse KLD (reference ``examples/augmented_flow.ipynb``: latent 4 = 2 data
+ 2 augmented dims), on ``nf_tpu_torch``."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import torch

import nf_tpu_torch as nt
from nf_tpu_torch.distributions import DiagGaussian, TwoIndependent

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


def parser():
    return base_parser(__doc__, iters=2000, lr=1e-3, num_samples=1024)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    anneal = max(1, args.iters // 2)
    target = TwoIndependent(target1=nt.TwoMoons(),
                            target2=DiagGaussian(2, trainable=False))
    model = nt.build_realnvp(dim=4, K=16, hidden=[64, 64], target=target,
                             device=dev, seed=args.seed)
    gen = generator(dev, args.seed, EVAL_STREAM)
    model.init_from_samples(512, generator=gen)

    def beta(it):
        return min(1.0, 0.01 + it / anneal)

    model, hist = train(model, ReverseKLD(args.num_samples, beta), args)

    with torch.no_grad():
        z, _ = model.sample(8192, generator=gen)
    print("data-coord std:", z[:, :2].std(0, correction=0).cpu().numpy(),
          " aux-coord std:", z[:, 2:].std(0, correction=0).cpu().numpy())
    if args.plot:
        plot_hist2d(z[:, :2], out_path("augmented_data_coords.png"),
                    title="data coordinates")
        plot_hist2d(z[:, 2:], out_path("augmented_aux_coords.png"),
                    title="augmented coordinates")
    return {"hist": hist}


if __name__ == "__main__":
    main()
