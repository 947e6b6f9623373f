"""Comparison study: planar vs radial vs affine-coupling flows on the
reference's 2D VI targets (reference
``examples/comparison_plan_rad_aff.ipynb``), on ``nf_tpu_torch``."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import nf_tpu_torch as nt
from nf_tpu_torch.distributions import RingMixture, Sinusoidal, Smiley

from examples_torch._utils import (
    ReverseKLD,
    base_parser,
    device_of,
    out_path,
    plot_density,
    train,
)

TARGETS = {
    "two_modes": lambda: nt.TwoModes(),
    "sinusoidal": lambda: Sinusoidal(scale=2.0, period=4.0),
    "smiley": lambda: Smiley(scale=2.0),
    "ring_mixture": lambda: RingMixture(),
}

BUILDERS = {
    "planar": lambda target, **kw: nt.build_planar_stack(
        dim=2, K=16, target=target, **kw),
    "radial": lambda target, **kw: nt.build_radial_stack(
        dim=2, K=16, target=target, **kw),
    "affine": lambda target, **kw: nt.build_realnvp(
        dim=2, K=8, hidden=[32, 32], target=target, **kw),
}


def parser():
    p = base_parser(__doc__, iters=1500, lr=3e-3, num_samples=512)
    p.add_argument("--targets", nargs="*", default=["two_modes", "smiley"])
    p.add_argument("--flows", nargs="*", default=list(BUILDERS))
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    anneal = max(1, args.iters // 2)

    def beta(it):
        return min(1.0, 0.05 + it / anneal)

    results, hists = {}, {}
    for tname in args.targets:
        for fname in args.flows:
            model = BUILDERS[fname](TARGETS[tname](), device=dev,
                                    seed=args.seed)
            print(f"=== {fname} on {tname} ===")
            model, hist = train(model, ReverseKLD(args.num_samples, beta),
                                args)
            results[(fname, tname)] = hist[-1][1]
            hists[f"{fname} on {tname}"] = hist
            if args.plot:
                plot_density(model.log_prob,
                             out_path(f"cmp_{fname}_{tname}.png"), dev,
                             title=f"{fname} on {tname}")

    print("\nfinal reverse-KLD losses (lower is better):")
    for (fname, tname), v in sorted(results.items()):
        print(f"  {fname:8s} {tname:12s} {v:+.4f}")
    return {"hist": hists}


if __name__ == "__main__":
    main()
