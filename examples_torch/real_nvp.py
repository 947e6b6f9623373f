"""Real NVP fitting the bimodal TwoModes target by annealed reverse KLD
(reference ``examples/real_nvp.ipynb``: K=64 MaskedAffineFlow+ActNorm,
Adam 1e-4, beta annealed over the first half of training), on
``nf_tpu_torch``."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import torch

import nf_tpu_torch as nt

from examples_torch._utils import (
    EVAL_STREAM,
    ReverseKLD,
    base_parser,
    device_of,
    generator,
    out_path,
    plot_density,
    plot_hist2d,
    train,
)


def parser():
    return base_parser(__doc__, iters=2000, lr=1e-3, num_samples=1024)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    anneal = max(1, args.iters // 2)
    model = nt.build_realnvp(dim=2, K=16, hidden=[64, 64],
                             target=nt.TwoModes(), device=dev, seed=args.seed)
    gen = generator(dev, args.seed, EVAL_STREAM)
    model.init_from_samples(512, generator=gen)

    def beta(it):
        return min(1.0, 0.01 + it / anneal)

    model, hist = train(model, ReverseKLD(args.num_samples, beta), args)

    with torch.no_grad():
        z, log_q = model.sample(4096, generator=gen)
    print("sample mean |z|:", float(torch.mean(torch.linalg.norm(z, dim=-1))))
    if args.plot:
        plot_density(model.log_prob, out_path("real_nvp_model.png"), dev,
                     title="Real NVP fit")
        plot_density(model.p.log_prob, out_path("real_nvp_target.png"), dev,
                     title="TwoModes target")
        plot_hist2d(z, out_path("real_nvp_samples.png"))
    return {"hist": hist}


if __name__ == "__main__":
    main()
