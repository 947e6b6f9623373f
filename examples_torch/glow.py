"""Multi-scale class-conditional Glow (reference ``examples/glow.ipynb``:
L=3, K=16, hidden 256, CIFAR-10, Adamax 1e-3, bits/dim eval), on
``nf_tpu_torch``.

Data: pass ``--data path.npz`` with arrays ``x`` (N,3,32,32) uint8 and
``y`` (N,) int; without it a procedural class-structured dataset is used so
the recipe runs in a zero-download environment.
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
    out_path,
    train,
)


def parser():
    p = base_parser(__doc__, iters=300, lr=1e-3, num_samples=128)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--L", type=int, default=2)
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--scan", action="store_true",
                   help="group the K GlowBlocks per level into one Scanned")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    dev = device_of(args)
    if args.data:
        d = np.load(args.data)
        x_all, y_all = torch.as_tensor(d["x"]), torch.as_tensor(d["y"])
    else:
        x_u8, y_np = procedural_image_classes(args.seed, 2048)
        x_all, y_all = torch.as_tensor(x_u8), torch.as_tensor(y_np)
    x_all, y_all = x_all.to(dev), y_all.to(dev)
    n = x_all.shape[0]
    scale, jitter = Scale(), Jitter()
    model = nt.build_glow_multiscale(
        input_shape=tuple(x_all.shape[1:]), L=args.L, K=args.K,
        hidden_channels=args.hidden, num_classes=10, class_cond=True,
        scan=args.scan, device=dev, seed=args.seed)

    def get_batch(gen, it=None):
        idx = torch.randint(0, n, (args.batch,), generator=gen, device=dev)
        x = jitter(scale(x_all[idx].float() / 255.0), gen)
        return x, y_all[idx]

    gen = generator(dev, args.seed, EVAL_STREAM)
    model.init_from_data(*get_batch(gen))

    model, hist = train(model, ForwardKLD(get_batch), args, weight_decay=1e-5)

    # bits/dim on a held-out batch (reference utils/eval.py:5-34)
    with torch.no_grad():
        bpd = bits_per_dim(model, *get_batch(gen))
        samples, _ = model.sample(16, generator=gen, temperature=0.7)
    print("bits/dim:", float(torch.nanmean(bpd)))
    print("sample shape:", tuple(samples.shape),
          "finite:", bool(torch.isfinite(samples).all()))
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        s = torch.clamp(samples, 0, 1).permute(0, 2, 3, 1).cpu().numpy()
        fig, axes = plt.subplots(4, 4, figsize=(8, 8))
        for ax, im in zip(axes.ravel(), s):
            ax.imshow(im)
            ax.axis("off")
        fig.savefig(out_path("glow_samples.png"), dpi=120,
                    bbox_inches="tight")
        print("wrote", out_path("glow_samples.png"))
    return {"hist": hist}


if __name__ == "__main__":
    main()
