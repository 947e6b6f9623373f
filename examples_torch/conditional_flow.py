"""Conditional normalizing flow q(x|c) fitting a conditional Gaussian
target whose mean and scale are the context (reference
``examples/conditional_flow.ipynb``: context size 4, conditional coupled
NSF / MAF), on ``nf_tpu_torch``: on the card the couplings run kernels A
and C at the training batch, and B at B*D >= 4096."""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import torch

import nf_tpu_torch as nt

from examples_torch._utils import (
    EVAL_STREAM,
    ForwardKLD,
    base_parser,
    device_of,
    generator,
    train,
)


def parser():
    return base_parser(__doc__, iters=2000, lr=3e-3, num_samples=512)


def build_model(args, device):
    """``build_conditional_nsf`` at its defaults (dim 2, context 4, K 4,
    hidden 64, 8 bins) on ``ConditionalDiagGaussianTarget``."""
    return nt.build_conditional_nsf(target=nt.ConditionalDiagGaussianTarget(),
                                    device=device, seed=args.seed)


def sample_context(gen, n):
    """Means uniform on [-1, 1), scales on [0.5, 1.5): ``(n, 4)``."""
    mu = 2.0 * torch.rand((n, 2), generator=gen, device=gen.device) - 1.0
    sigma = 0.5 + torch.rand((n, 2), generator=gen, device=gen.device)
    return torch.cat([mu, sigma], dim=-1)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    model = build_model(args, dev)
    target = model.p

    def draw(gen):
        context = sample_context(gen, args.num_samples)
        x = target.sample(args.num_samples, generator=gen, context=context)
        return (x, context), None

    model, hist = train(model, ForwardKLD(draw=draw), args)

    # check: conditional samples should track the requested moments
    ctx = torch.tensor([[0.3, 0.9, 0.6, 0.6]], device=dev).repeat(4096, 1)
    with torch.no_grad():
        z, _ = model.sample(4096, generator=generator(dev, args.seed,
                                                      EVAL_STREAM),
                            context=ctx)
    print("requested mean [0.3, 0.9]  got", z.mean(0).cpu().numpy())
    print("requested std  [0.6, 0.6]  got",
          z.std(0, correction=0).cpu().numpy())
    return {"hist": hist}


if __name__ == "__main__":
    main()
