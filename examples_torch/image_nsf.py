"""Multi-scale neural-spline flow on images (4D RQS channel couplings with
ConvResidualNet conditioners) — assembled from pieces the reference ships
individually (``neural_spline/coupling.py:56-61``, ``nets/resnet.py:107``),
on ``nf_tpu_torch``: on the card every coupling's spline runs kernel A on
the bin-major image feed, and its backward kernel C.

Data: ``--data path.npz`` with ``x`` (N,3,32,32) uint8, else procedural.
"""

if __package__ in (None, ""):
    import _bootstrap  # noqa: F401  (as a script: the repo root on sys.path)

import numpy as np
import torch

import nf_tpu_torch as nt
from nf_tpu_torch.data import procedural_image_classes
from nf_tpu_torch.utils.eval import bits_per_dim
from nf_tpu_torch.utils.preprocessing import Jitter, Scale

from examples_torch._utils import (
    EVAL_STREAM,
    ForwardKLD,
    base_parser,
    device_of,
    generator,
    train,
)


def parser():
    p = base_parser(__doc__, iters=300, lr=1e-3, num_samples=64)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--L", type=int, default=2)
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--num-bins", type=int, default=8)
    p.add_argument("--batch", type=int, default=64)
    return p


def build_model(args, device, input_shape=(3, 32, 32)):
    """``build_image_nsf(input_shape, L, K, hidden_channels, num_bins)`` of
    the flags."""
    return nt.build_image_nsf(input_shape=tuple(input_shape), L=args.L,
                              K=args.K, hidden_channels=args.hidden,
                              num_bins=args.num_bins, device=device,
                              seed=args.seed)


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    if args.data:
        x_all = torch.as_tensor(np.load(args.data)["x"]).to(dev)
    else:
        x_u8, _ = procedural_image_classes(args.seed, 2048)
        x_all = torch.as_tensor(x_u8).to(dev)
    n = x_all.shape[0]
    scale, jitter = Scale(), Jitter()
    model = build_model(args, dev, x_all.shape[1:])

    def get_batch(gen, it=None):
        idx = torch.randint(0, n, (args.batch,), generator=gen, device=dev)
        return jitter(scale(x_all[idx].float() / 255.0), gen)

    gen = generator(dev, args.seed, EVAL_STREAM)
    model.init_from_data(get_batch(gen))

    model, hist = train(model, ForwardKLD(get_batch), args, weight_decay=1e-5)

    with torch.no_grad():
        bpd = bits_per_dim(model, get_batch(gen))
        s, _ = model.sample(16, generator=gen, temperature=0.7)
    print("bits/dim:", float(torch.nanmean(bpd)))
    print("sample shape:", tuple(s.shape), "finite:",
          bool(torch.isfinite(s).all()))
    return {"hist": hist}


if __name__ == "__main__":
    main()
