"""Planar flow stack fitting a 2D target by reverse KLD
(reference ``examples/planar.ipynb``), on ``nf_tpu_torch``."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import nf_tpu_torch as nt

from examples_torch._utils import (
    ReverseKLD,
    base_parser,
    device_of,
    out_path,
    plot_density,
    train,
)


def parser():
    return base_parser(__doc__, iters=3000, lr=5e-3, num_samples=512)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    model = nt.build_planar_stack(dim=2, K=16, target=nt.TwoModes(),
                                  device=dev, seed=args.seed)
    model, hist = train(model, ReverseKLD(args.num_samples), args)
    if args.plot:
        plot_density(model.log_prob, out_path("planar_model.png"), dev,
                     title="Planar flow fit")
    return {"hist": hist}


if __name__ == "__main__":
    main()
